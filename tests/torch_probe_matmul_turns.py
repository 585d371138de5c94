"""K3 of ``csrc/probes.cu`` (``probe_block_matmul`` at "HIGHEST" and
"DEFAULT") against the K3 of an earlier tree, in turns on one card.

Each tree's ``nsol_tpu_torch/csrc/probes.cu`` is compiled alone by
``nvcc`` (the port's flags, ``-Xptxas -v``) into a library of its own, both
at once, and bound with ``ctypes``. The script then

* prints ptxas's registers and spills of each tree's K3 kernels;
* holds this tree's K3 on ``chip_smoke.py``'s ``PROBE_MATMUL_SHAPES``
  (the x and y side, with and without ``trans``) to what phase 49 holds
  it to (``probe_matmul_reference``): "HIGHEST" within 1e-5 · max |ref|
  of the float64 product, "DEFAULT" within 1e-6 · max |ref| of the plain
  version, or past 384 products a sum of the float64 sum of the
  bf16-rounded inputs (the plain version's reading printed beside it);
* compares the two trees' outputs bit for bit on every shape and form;
* times the forms the probes run at 256³ (``chip_smoke.py``'s
  ``PROBE_MATMUL_FORMS``), m = 0.999999·I as theirs, in turns (earlier,
  this, this, earlier): device ms by ``torch.profiler`` and a call's ms by
  CUDA events over :data:`REPS` back-to-back calls. ``chip_smoke.py`` phase
  49 times the library calls beside them.

Run on a machine with a CUDA card from the repository root, with an earlier
tree unpacked inside the checkout (``build/`` is ignored by git)::

    mkdir -p build/earlier && git archive <commit> | tar -x -C build/earlier
    python3 tests/torch_probe_matmul_turns.py --earlier build/earlier

Without ``--earlier`` it checks and times this tree alone. It prints the
card's name and power limit, a line a check and a turn, and last one JSON
object of the numbers; it exits 1 where a check misses its tolerance. It
imports torch and numpy, the port's build flags and plain version of K3,
and ``chip_smoke.py``'s timers.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from nsol_tpu_torch.ops.cuda import build  # noqa: E402
from nsol_tpu_torch.parallel import shard_probe as SP  # noqa: E402
from nsol_tpu_torch.parallel.shard_probe import (  # noqa: E402
    PRECISIONS, SIDES, probe_block_matmul_plain)

FORMS = (("x", False), ("x", True), ("y", False), ("y", True))
K3_KERNELS = ("probe_gemm_f32_kernel", "probe_gemm_bf16_kernel",
              "probe_sgemm_kernel", "probe_mma_stream_kernel")
#: back-to-back calls a call's time is the mean of
REPS = 200


def start_build(tree, out_dir, tag):
    """Start nvcc on ``tree``'s probes.cu; returns (process, library)."""
    src = os.path.join(tree, "nsol_tpu_torch", "csrc", "probes.cu")
    lib = os.path.join(out_dir, "libprobes_%s.so" % tag)
    proc = subprocess.Popen(
        [build._nvcc()] + build.NVCC_FLAGS + ["-shared", "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, lib


def finish_build(proc, lib, tag):
    """The bound ``nsol_probe_block_matmul`` and its K3 ptxas lines."""
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on the %s tree:\n%s" % (tag, err))
    fn = ctypes.CDLL(lib).nsol_probe_block_matmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    report, entry = [], None
    for ln in err.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            entry = next((k for k in K3_KERNELS if k in name), None)
            if entry:
                report.append(name)
        elif entry and ("registers" in ln or "spill" in ln):
            report.append("  " + ln.split(":", 1)[-1].strip())
    return fn, report


def call(fn, x, m, side, trans, precision, out=None):
    out = torch.empty_like(x) if out is None else out
    counts = (ctypes.c_longlong * 4)()
    err = fn(x.data_ptr(), m.data_ptr(), out.data_ptr(), *x.shape,
             SIDES.index(side), int(trans), PRECISIONS.index(precision),
             torch.cuda.current_stream().cuda_stream, counts)
    if err != 0 or counts[2] + counts[3] != 1:
        raise RuntimeError("K3 %s %s trans %s: error %d, counts %s"
                           % (side, precision, trans, err, list(counts)))
    return out


def _inputs(shape, side, rng, device):
    x = torch.as_tensor(rng.rand(*shape).astype(np.float32), device=device)
    k = shape[2] if side == "x" else shape[1]
    m = torch.as_tensor(rng.rand(k, k).astype(np.float32) - 0.5,
                        device=device)
    return x, m


def checks(fn, rng, device):
    """This tree's K3 against its reference on every shape and form: the
    worst max |Δ| / max |ref| a precision and the cases past their
    tolerance."""
    def rel(got, ref):
        return float((got.double() - ref.double()).abs().max()
                     / ref.double().abs().max())

    worst, failed = {p: 0.0 for p in PRECISIONS}, []
    for shape in CS.PROBE_MATMUL_SHAPES:
        for side, trans in FORMS:
            x, m = _inputs(shape, side, rng, device)
            for prec in PRECISIONS:
                got = call(fn, x, m, side, trans, prec)
                r = rel(got, CS.probe_matmul_reference(SP, x, m, side, prec,
                                                       trans))
                tol = CS.PROBE_MATMUL_TOL[prec]
                k = shape[2] if side == "x" else shape[1]
                beside = ""
                if prec == "DEFAULT" and k > CS.PROBE_PLAIN_MAX_K:
                    beside = " against the float64 sum; %.3g against the " \
                        "plain version" % rel(got, probe_block_matmul_plain(
                            x, m, side, prec, trans))
                print("check %-16s %s side trans %-5s %s: max |d| / max |ref| "
                      "%.3g (tolerance %g)%s" % (shape, side, trans, prec, r,
                                                 tol, beside))
                if not r <= tol:
                    failed.append("%s %s side trans %s %s" % (shape, side,
                                                              trans, prec))
                worst[prec] = max(worst[prec], r)
    return worst, failed


def bits(fn, earlier, rng, device):
    """``{precision: every shape and form bit for bit}`` of the two trees."""
    same = {p: True for p in PRECISIONS}
    for shape in CS.PROBE_MATMUL_SHAPES:
        for side, trans in FORMS:
            x, m = _inputs(shape, side, rng, device)
            for prec in PRECISIONS:
                a = call(fn, x, m, side, trans, prec)
                b = call(earlier, x, m, side, trans, prec)
                eq = torch.equal(a, b)
                same[prec] &= eq
                if not eq:
                    print("bits %-16s %s side trans %-5s %s: differ at %d of "
                          "%d, max |d| %.3g" % (
                              shape, side, trans, prec,
                              int((a != b).sum()), a.numel(),
                              float((a - b).abs().max())))
    return same


def turns(fn, earlier, device, rng):
    """The probes' forms at 256³ in turns: device ms and ms a call."""
    rows = []
    x = torch.as_tensor(rng.rand(*CS.SCALE_SHAPE).astype(np.float32),
                        device=device)
    m = torch.eye(CS.SCALE_SHAPE[2], device=device) * 0.999999
    out = torch.empty_like(x)

    def text(t):
        return "%s/%.4f" % (CS.ms_text(t["device_ms"]), t["call_ms"])

    for prec in PRECISIONS:
        for side, trans in CS.PROBE_MATMUL_FORMS:
            row = {"precision": prec, "side": side, "trans": trans,
                   "this": [], "earlier": []}
            order = ("earlier", "this", "this", "earlier") if earlier \
                else ("this", "this")
            for who in order:
                def k(f=fn if who == "this" else earlier):
                    return call(f, x, m, side, trans, prec, out)

                row[who].append({
                    "device_ms": CS.device_ms_of(k, 20, keys=("probe_",)),
                    "call_ms": CS.cuda_ms(k, REPS)})
            print("turns 256^3 %s %s side trans %s, device/call ms: this %s; "
                  "earlier %s" % (
                      prec, side, trans,
                      " ".join(text(t) for t in row["this"]),
                      " ".join(text(t) for t in row["earlier"]) or
                      "not run"))
            rows.append(row)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--earlier", help="an earlier tree's root")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device")
    device = torch.device("cuda", 0)
    card = CS.smi()
    print("card: %s" % card)
    torch.set_float32_matmul_precision("highest")  # TF32 off
    with tempfile.TemporaryDirectory() as tmp:
        builds = {"this": start_build(ROOT, tmp, "this")}
        if args.earlier:
            builds["earlier"] = start_build(args.earlier, tmp, "earlier")
        fns = {}
        for tag, (proc, lib) in builds.items():
            fns[tag], report = finish_build(proc, lib, tag)
            print("ptxas %s tree:\n%s" % (tag, "\n".join(report)))
        fn, earlier = fns["this"], fns.get("earlier")
        rng = np.random.RandomState(24)
        worst, failed = checks(fn, rng, device)
        same = bits(fn, earlier, rng, device) if earlier else None
        if same is not None:
            print("bits against the earlier tree: %s" % same)
        rows = turns(fn, earlier, device, rng)
    print(json.dumps({"card": card, "worst_rel": worst, "failed": failed,
                      "same_bits": same, "turns": rows}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
