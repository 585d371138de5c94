"""Build and bind the CUDA kernels of ``nsol_tpu_torch/csrc``.

At first use, ``nvcc`` compiles each of the package's own ``csrc/*.cu``
into an object, one process per source, all started together, and links
them into one shared library with a plain C interface (no PyTorch
headers, so the build takes seconds), under
``<checkout>/build/nsol_tpu_torch/`` keyed by a hash of the sources and
flags; ``ctypes`` loads it. A failed build raises with nvcc's stderr;
nothing falls back to another path.

Nothing here runs at import time: the CPU tests import every module on a
host without ``nvcc``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["load", "stream_ptr", "tensor_ptr", "check", "new_counts",
           "build_info"]

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "nsol_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_SIGNATURES = {
    "nsol_max_blocks": [],
    "nsol_normal_apply": [_P] * 8 + [_I] * 3 + [_F, _I, _I] + [_F] * 3
    + [_I] * 3 + [_P, _P],
    "nsol_normal_apply_prepadded": [_P] * 5 + [_I] * 3 + [_F] * 4
    + [_I] * 6 + [_P, _P],
    "nsol_blur_apply_prepadded": [_P] * 6 + [_I] * 3 + [_F] * 4 + [_I] * 6
    + [_P, _P],
    "nsol_weighted_apply_prepadded": [_P] * 6 + [_I] * 3 + [_F] * 4
    + [_I] * 7 + [_P, _P],
    "nsol_cg_step": [_P] * 8 + [_I, _P] + [_I] * 3 + [_F, _I, _I] + [_F] * 3
    + [_I] * 3 + [_P, _P],
    "nsol_cg_update": [_P] * 6 + [_LL, _I, _I, _P, _P],
    "nsol_cg_sweep": [_P] * 10 + [_I, _P] + [_I] * 3 + [_F, _I] + [_F] * 3
    + [_I] * 3 + [_P, _P],
    "nsol_admm_tail": [_P, _P, _P, _P, _P, _F, _F, _F, _F, _F, _I,
                       _I, _I, _I, _P, _P],
    "nsol_admm_record": [_P] * 7 + [_I, _P] + [_I] * 3 + [_I, _F]
    + [_F] * 3 + [_I] * 3 + [_P, _P],
    "nsol_admm_solve": [_P] * 15 + [_P, _I, _I, _I, _P, _I, _I, _I]
    + [_F] * 8 + [_I] * 4 + [_P] * 3 + [_I, _F] + [_I] * 3 + [_P, _P],
    "nsol_pd_grid": [_I, _I],
    "nsol_pd_dual": [_P, _P, _P, _I, _I, _I, _F] + [_I] * 6 + [_F] * 3
    + [_P, _P],
    "nsol_pd_primal": [_P] * 5 + [_I] * 9 + [_F] * 3 + [_P, _P],
    "nsol_pd_record": [_P] * 5 + [_I] * 4 + [_F] + [_I] * 6 + [_F] * 3
    + [_P, _P],
    "nsol_pd_solve": [_P] * 9 + [_I, _F, _I, _I, _F, _I] + [_I] * 6
    + [_F] * 3 + [_P, _P],
    "nsol_blur_apply": [_P] * 10 + [_I] * 3 + [_F, _I] + [_F] * 3
    + [_I] * 3 + [_P, _P],
    "nsol_irls_head": [_P] * 7 + [_I] * 4 + [_F] + [_I] * 3 + [_P, _P],
    "nsol_weighted_apply": [_P] * 10 + [_I, _P] + [_I] * 3 + [_F, _I, _I]
    + [_F] * 3 + [_I] * 3 + [_P, _P],
    "nsol_irls_step": [_P, _P, _LL, _P, _P],
    "nsol_irls_sweep": [_P] * 14 + [_I] * 3 + [_F, _I, _I] + [_F] * 3
    + [_I, _F, _I] + [_I] * 3 + [_P, _P],
    "nsol_robust_admm_solve": [_P] * 14 + [_I] * 3 + [_F] * 7 + [_I, _F]
    + [_I] * 4 + [_P] * 3 + [_F] + [_I] * 3 + [_P] * 3,
    "nsol_robust_admm_solve_zy": [_P] * 14 + [_I] * 3 + [_F] * 7
    + [_I, _F] + [_I] * 4 + [_P] * 3 + [_F] + [_I] * 3 + [_P] * 4,
    "nsol_tik_clip": [_P, _P, _LL, _P, _P],
    "nsol_tiled_blocks": [_I] * 3,
    "nsol_tiled_smem": [_I] * 6,
    "nsol_normal_apply_zy": [_P] * 4 + [_I] + [_P] * 3 + [_I] * 3
    + [_F, _I] + [_F] * 3 + [_I] * 3 + [_P, _P],
    "nsol_cg_step_zy": [_P] * 6 + [_I, _P] + [_I] * 3 + [_F] * 4 + [_I] * 3
    + [_P, _P],
    "nsol_blur_apply_zy": [_P] * 11 + [_I] * 3 + [_F, _I, _F] + [_F] * 3
    + [_I] * 3 + [_P, _P],
    "nsol_weighted_apply_zy": [_P] * 8 + [_I, _P] + [_I] * 3 + [_F, _I]
    + [_F] * 3 + [_I] * 3 + [_P, _P],
    "nsol_cg_direction": [_P] * 4 + [_LL, _I, _P, _P],
    "nsol_blocked_admm_solve": [_P] * 13 + [_I] * 3 + [_P] + [_I] * 3
    + [_F] * 8 + [_I] * 4 + [_I] * 3 + [_P] * 3,
    "nsol_tikhonov_solve": [_P] * 15 + [_P] + [_I] * 3 + [_P] + [_I] * 3
    + [_F] * 3 + [_I, _I, _P, _P] + [_I] * 4 + [_I] * 3 + [_P] * 4,
}

#: what the last build did: library path, seconds, nvcc's ptxas report
build_info = {}


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (put it on PATH)")


@functools.lru_cache(maxsize=None)
def load():
    """Build (once per source hash) and load the kernel library."""
    srcs = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    lib_path = os.path.join(BUILD_DIR, "libnsol_%s.so"
                            % digest.hexdigest()[:16])
    t0 = time.perf_counter()
    log = ""
    if not os.path.isfile(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tag = "%s.%d" % (lib_path, os.getpid())
        nvcc = _nvcc()
        units = [s for s in srcs if s.endswith(".cu")]
        objs = ["%s.%s.o" % (tag, os.path.basename(u)[:-3]) for u in units]
        procs = [(subprocess.Popen([nvcc] + NVCC_FLAGS + ["-c", u, "-o", o],
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True), u)
                 for u, o in zip(units, objs)]
        logs = []
        for proc, u in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                for other, _ in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError("nvcc failed (%d) on %s:\n%s"
                                   % (proc.returncode, u, err))
            logs.append(err)
        tmp = tag + ".tmp"
        cmd = [nvcc, "-shared", "-o", tmp] + objs
        proc = subprocess.run(cmd, capture_output=True, text=True)
        for o in objs:
            os.remove(o)
        if proc.returncode != 0:
            raise RuntimeError("nvcc link failed (%d): %s\n%s" % (
                proc.returncode, " ".join(cmd), proc.stderr))
        os.replace(tmp, lib_path)
        log = "".join(logs)
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info.update(path=lib_path, seconds=time.perf_counter() - t0,
                      ptxas=log)
    return lib


def new_counts(n):
    """``n`` per-unit launch counts for a C function to add to, indexed by
    its source's unit enum (``admm.cu``: normal_apply, cg_step, cg_update,
    admm_tail, admm_record, cg_sweep, normal_apply_prepadded; ``pd.cu``:
    pd_dual, pd_primal, pd_record; ``robust.cu``: blur_apply, irls_head,
    weighted_apply, irls_step, cg_update, blur_apply_prepadded,
    weighted_apply_prepadded; ``tikhonov.cu``: tik_clip; ``tiled.cu``: normal_apply_zy,
    cg_step_zy, blur_apply_zy, weighted_apply_zy, cg_direction)."""
    return (ctypes.c_longlong * n)()


def tensor_ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream_ptr(device):
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(err, name):
    if err != 0:
        raise RuntimeError("%s: CUDA error %d at launch" % (name, err))
