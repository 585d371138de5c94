"""The shard probes' kernels of ``csrc/probes.cu`` — K1 ``probe_scale``, K2
``probe_window_scale`` and K3 ``probe_block_matmul`` at "HIGHEST" and
"DEFAULT" — against those of an earlier tree, in turns on one card.

Each tree's ``nsol_tpu_torch/csrc/probes.cu`` is compiled alone by
``nvcc`` (the port's flags, ``-Xptxas -v``) into a library of its own, both
at once, and bound with ``ctypes``. The script then

* prints ptxas's registers and spills of each tree's probe kernels;
* holds this tree's K1 and K2 bit for bit to their plain versions on
  ``chip_smoke.py``'s ``PROBE_STREAM_SHAPES`` (K1 at zb 32, 8 and 4, K2 the
  same at halo 0 and 6 with one slot and two, the factor 2, 1.0000001 or
  1.0000001 in device memory), and K3 on ``PROBE_MATMUL_SHAPES`` (the x
  and y side, with and without ``trans``) to what phase 49 holds it to
  (``probe_matmul_reference``): "HIGHEST" within 1e-5 · max |ref| of the
  float64 product, "DEFAULT" within 1e-6 · max |ref| of the plain version,
  or past 384 products a sum of the float64 sum of the bf16-rounded inputs
  (the plain version's reading printed beside it);
* compares the two trees' outputs bit for bit on every shape and form;
* times, in turns (library, earlier, this, this, earlier, library), device
  ms by ``torch.profiler`` and a call's ms by CUDA events over
  :data:`REPS` back-to-back calls: K2 at 256³ (halo 6 with two slots and
  one, halo 0 with one), K1 at 256³ (zb 32 and 8) and at (32, 64, 64) zb
  8, each beside ``torch.mul`` of the same function; K3's forms at 256³
  (``chip_smoke.py``'s ``PROBE_MATMUL_FORMS``, m = 0.999999·I as the
  probes'), "HIGHEST" beside ``torch.matmul`` in float32 with TF32 off.

Run on a machine with a CUDA card from the repository root, with an earlier
tree unpacked inside the checkout (``build/`` is ignored by git)::

    mkdir -p build/earlier && git archive <commit> | tar -x -C build/earlier
    python3 tests/torch_probe_turns.py --earlier build/earlier

Without ``--earlier`` it checks and times this tree alone. It prints the
card's name and power limit, a line a check and a turn, and last one JSON object of the
numbers; it exits 1 where a check misses. It imports torch and numpy, the
port's build flags and plain versions, and ``chip_smoke.py``'s timers.
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
#: the probe kernels of this tree and of earlier ones
KERNELS = ("probe_scale_kernel", "probe_window_kernel", "probe_gemm_f32_kernel",
           "probe_gemm_bf16_kernel", "probe_sgemm_kernel",
           "probe_mma_stream_kernel")
#: back-to-back calls a call's time is the mean of
REPS = 200
#: the timed stream forms: (label, kernel, shape, zb, halo, slots)
STREAM_TURNS = (
    ("K2 halo 6, two slots", "window", CS.SCALE_SHAPE, SP.ZB, SP.R, 2),
    ("K2 halo 6, one slot", "window", CS.SCALE_SHAPE, SP.ZB, SP.R, 1),
    ("K2 halo 0, one slot", "window", CS.SCALE_SHAPE, SP.ZB, 0, 1),
    ("K1 zb 32", "scale", CS.SCALE_SHAPE, 32, 0, 0),
    ("K1 zb 8", "scale", CS.SCALE_SHAPE, 8, 0, 0),
    ("K1 zb 8 (32, 64, 64)", "scale", SP.SMALL, 8, 0, 0))


def start_build(tree, out_dir, tag):
    """Start nvcc on ``tree``'s probes.cu; returns (process, library)."""
    src = os.path.join(tree, "nsol_tpu_torch", "csrc", "probes.cu")
    lib = os.path.join(out_dir, "libprobes_%s.so" % tag)
    proc = subprocess.Popen(
        [build._nvcc()] + build.NVCC_FLAGS + ["-shared", "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, lib


def finish_build(proc, lib, tag):
    """``{C function: bound function}`` of the three probes and the ptxas
    lines of their kernels."""
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on the %s tree:\n%s" % (tag, err))
    so = ctypes.CDLL(lib)
    fns = {}
    for name in ("nsol_probe_scale", "nsol_probe_window_scale",
                 "nsol_probe_block_matmul"):
        fn = getattr(so, name)
        fn.argtypes = build._SIGNATURES[name]
        fn.restype = ctypes.c_int
        fns[name] = fn
    report, entry = [], None
    for ln in err.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            entry = next((k for k in KERNELS if k in name), None)
            if entry:
                report.append(name)
        elif entry and ("registers" in ln or "spill" in ln):
            report.append("  " + ln.split(":", 1)[-1].strip())
    return fns, report


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _factor(s):
    if torch.is_tensor(s):
        return 0.0, ctypes.c_void_p(s.data_ptr())
    return float(s), None


def scale(fns, x, s, zb, out=None):
    """K1 of the library ``fns``: ``s·x`` over z-blocks of ``zb``."""
    out = torch.empty_like(x) if out is None else out
    counts = (ctypes.c_longlong * 4)()
    f, f_dev = _factor(s)
    err = fns["nsol_probe_scale"](x.data_ptr(), out.data_ptr(), f, f_dev,
                                  *x.shape, zb, _stream(), counts)
    if err != 0 or counts[0] != 1:
        raise RuntimeError("K1 %s zb %d: error %d, counts %s"
                           % (tuple(x.shape), zb, err, list(counts)))
    return out


def window(fns, ext, s, zb, halo, slots, out=None):
    """K2 of the library ``fns``: ``s·ext[halo : Z + halo]``."""
    z = ext.shape[0] - 2 * halo
    out = ext.new_empty((z,) + tuple(ext.shape[1:])) if out is None else out
    counts = (ctypes.c_longlong * 4)()
    f, f_dev = _factor(s)
    err = fns["nsol_probe_window_scale"](
        ext.data_ptr(), out.data_ptr(), f, f_dev, z, *ext.shape[1:], zb,
        halo, slots, _stream(), counts)
    if err != 0 or counts[1] != 1:
        raise RuntimeError("K2 %s zb %d halo %d slots %d: error %d, counts "
                           "%s" % (tuple(ext.shape), zb, halo, slots, err,
                                   list(counts)))
    return out


def matmul(fns, x, m, side, trans, precision, out=None):
    """K3 of the library ``fns``."""
    out = torch.empty_like(x) if out is None else out
    counts = (ctypes.c_longlong * 4)()
    err = fns["nsol_probe_block_matmul"](
        x.data_ptr(), m.data_ptr(), out.data_ptr(), *x.shape,
        SIDES.index(side), int(trans), PRECISIONS.index(precision),
        _stream(), counts)
    if err != 0 or counts[2] + counts[3] != 1:
        raise RuntimeError("K3 %s %s trans %s: error %d, counts %s"
                           % (side, precision, trans, err, list(counts)))
    return out


def _rand(rng, shape, device):
    return torch.as_tensor(rng.rand(*shape).astype(np.float32),
                           device=device)


def stream_cases(rng, device):
    """Every K1 and K2 case the checks take: ``(label, kind, input, s, zb,
    halo, slots)``."""
    s_dev = torch.full((1, 1), SP.SCALE, dtype=torch.float32, device=device)
    for shape in CS.PROBE_STREAM_SHAPES:
        x = _rand(rng, shape, device)
        exts = {h: _rand(rng, (shape[0] + 2 * h,) + shape[1:], device)
                for h in (0, SP.R)}
        for zb in CS.PROBE_STREAM_ZB:
            for s in (2.0, SP.SCALE, s_dev):
                sv = "device" if torch.is_tensor(s) else s
                yield ("K1 %s zb %d s %s" % (shape, zb, sv), "scale", x, s,
                       zb, 0, 0)
                for halo, ext in exts.items():
                    for slots in (1, 2):
                        yield ("K2 %s zb %d halo %d slots %d s %s"
                               % (shape, zb, halo, slots, sv), "window", ext,
                               s, zb, halo, slots)


def run_stream(fns, kind, v, s, zb, halo, slots, out=None):
    if kind == "scale":
        return scale(fns, v, s, zb, out)
    return window(fns, v, s, zb, halo, slots, out)


def stream_plain(kind, v, s, halo):
    if kind == "scale":
        return SP.probe_scale_plain(v, s)
    return SP.probe_window_scale_plain(v, s, halo)


def stream_checks(fns, earlier, rng, device):
    """K1 and K2 against their plain versions (and the earlier tree's
    bits): the cases that miss and the cases the trees differ on."""
    failed, differ, n = [], [], 0
    for label, kind, v, s, zb, halo, slots in stream_cases(rng, device):
        got = run_stream(fns, kind, v, s, zb, halo, slots)
        if not torch.equal(got, stream_plain(kind, v, s, halo)):
            failed.append(label)
            print("check %s: off its plain version" % label)
        if earlier is not None and not torch.equal(
                got, run_stream(earlier, kind, v, s, zb, halo, slots)):
            differ.append(label)
            print("bits %s: differ from the earlier tree" % label)
        n += 1
    print("checks K1, K2: %d cases bit for bit against the plain versions, "
          "%d off; against the earlier tree %s" % (
              n, len(failed), "not run" if earlier is None
              else "%d differ" % len(differ)))
    return failed, differ, n


def _inputs(shape, side, rng, device):
    x = _rand(rng, shape, device)
    k = shape[2] if side == "x" else shape[1]
    m = torch.as_tensor(rng.rand(k, k).astype(np.float32) - 0.5,
                        device=device)
    return x, m


def matmul_checks(fns, rng, device):
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
                got = matmul(fns, x, m, side, trans, prec)
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


def matmul_bits(fns, earlier, rng, device):
    """``{precision: every shape and form bit for bit}`` of the two trees."""
    same = {p: True for p in PRECISIONS}
    for shape in CS.PROBE_MATMUL_SHAPES:
        for side, trans in FORMS:
            x, m = _inputs(shape, side, rng, device)
            for prec in PRECISIONS:
                a = matmul(fns, x, m, side, trans, prec)
                b = matmul(earlier, x, m, side, trans, prec)
                eq = torch.equal(a, b)
                same[prec] &= eq
                if not eq:
                    print("bits %-16s %s side trans %-5s %s: differ at %d of "
                          "%d, max |d| %.3g" % (
                              shape, side, trans, prec,
                              int((a != b).sum()), a.numel(),
                              float((a - b).abs().max())))
    return same


def in_turns(calls, keys=("probe_",)):
    """``{who: [{"device_ms", "call_ms"}, ...]}`` of ``calls`` (``{who:
    fn}``, "library" among them or not) in turns: library, earlier, this,
    this, earlier, library."""
    order = [w for w in ("library", "earlier", "this") if w in calls]
    out = {w: [] for w in order}
    for who in order + order[::-1]:
        fn = calls[who]
        out[who].append({
            "device_ms": CS.device_ms_of(
                fn, 20, keys=None if who == "library" else keys),
            "call_ms": CS.cuda_ms(fn, REPS)})
    return out


def _text(turns):
    return "; ".join("%s %s" % (who, " ".join(
        "%s/%.4f" % (CS.ms_text(t["device_ms"]), t["call_ms"]) for t in ts))
        for who, ts in turns.items())


def stream_turns(fns, earlier, rng, device):
    """K1 and K2's timed forms in turns with the earlier tree's and
    ``torch.mul``."""
    rows = []
    for label, kind, shape, zb, halo, slots in STREAM_TURNS:
        s = 2.0 if kind == "scale" else SP.SCALE
        v = _rand(rng, (shape[0] + 2 * halo,) + shape[1:], device)
        out = torch.empty(shape, device=device)
        centre = v.narrow(0, halo, shape[0])
        calls = {"library": lambda c=centre, s=s: torch.mul(c, s)}
        for who, lib in (("earlier", earlier), ("this", fns)):
            if lib is not None:
                calls[who] = (lambda lib=lib, v=v, s=s, zb=zb, halo=halo,
                              slots=slots, kind=kind: run_stream(
                                  lib, kind, v, s, zb, halo, slots, out))
        turns = in_turns(calls)
        print("turns %s %s, device/call ms: %s" % (label, shape,
                                                   _text(turns)))
        rows.append({"form": label, "shape": shape, "turns": turns})
    return rows


def matmul_turns(fns, earlier, rng, device):
    """K3's forms at 256³ in turns; "HIGHEST" beside ``torch.matmul`` f32
    with TF32 off."""
    rows = []
    x = _rand(rng, CS.SCALE_SHAPE, device)
    m = torch.eye(CS.SCALE_SHAPE[2], device=device) * 0.999999
    out = torch.empty_like(x)
    for prec in PRECISIONS:
        for side, trans in CS.PROBE_MATMUL_FORMS:
            mm = m.T if trans else m
            calls = {}
            if prec == "HIGHEST":
                calls["library"] = (
                    lambda mm=mm, side=side: torch.matmul(x, mm)
                    if side == "x" else torch.matmul(mm.T, x))
            for who, lib in (("earlier", earlier), ("this", fns)):
                if lib is not None:
                    calls[who] = (lambda lib=lib, side=side, trans=trans,
                                  prec=prec: matmul(lib, x, m, side, trans,
                                                    prec, out))
            turns = in_turns(calls)
            print("turns 256^3 %s %s side trans %s, device/call ms: %s"
                  % (prec, side, trans, _text(turns)))
            rows.append({"precision": prec, "side": side, "trans": trans,
                         "turns": turns})
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
    result = {"card": card}
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        builds = {"this": start_build(ROOT, tmp, "this")}
        if args.earlier:
            builds["earlier"] = start_build(args.earlier, tmp, "earlier")
        libs = {}
        for tag, (proc, lib) in builds.items():
            libs[tag], report = finish_build(proc, lib, tag)
            print("ptxas %s tree:\n%s" % (tag, "\n".join(report)))
        fns, earlier = libs["this"], libs.get("earlier")
        rng = np.random.RandomState(25)
        off, differ, n = stream_checks(fns, earlier, rng, device)
        failed += off
        result.update(stream_cases=n, stream_differ=differ,
                      stream_turns=stream_turns(fns, earlier, rng, device))
        worst, off = matmul_checks(fns, rng, device)
        failed += off
        same = matmul_bits(fns, earlier, rng, device) if earlier else None
        if same is not None:
            print("K3 bits against the earlier tree: %s" % same)
        result.update(worst_rel=worst, same_bits=same,
                      matmul_turns=matmul_turns(fns, earlier, rng, device))
    result["failed"] = failed
    print(json.dumps(result))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
