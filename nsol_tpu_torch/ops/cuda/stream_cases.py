"""Edge cases of the stream kernels (``csrc/stream.cuh``) on the card.

``cg_direction`` (each storage), ``tik_clip`` and ``irls_step`` against
their plain versions at ragged lengths around the kernels' 4- and 8-voxel
chunks, on views whose storage offset breaks 16-byte alignment (the scalar
path) and in place; the clips on inputs with NaN, ±inf and ±0. One set of
cases for the ``cuda`` tests (``tests/test_torch_elementwise.py``) and
``chip_smoke.py``, which run them on the card::

    from nsol_tpu_torch.ops.cuda import stream_cases
    calls = stream_cases.check("cg_direction[bf16]", (1031,), "cuda")

A miss raises ``AssertionError``.
"""

import numpy as np
import torch

from nsol_tpu_torch.ops.cuda import blocked as B
from nsol_tpu_torch.ops.cuda import robust as R
from nsol_tpu_torch.ops.cuda import tikhonov as TK
from nsol_tpu_torch.ops.cuda import tiled as T

__all__ = ["SHAPES", "OFFSETS", "SPECIAL", "DIRECTION_FORMS", "A", "BETA",
           "KERNEL_TOL", "offset_view", "with_specials", "bf16_ulp", "scalars",
           "check"]

#: ragged lengths around the 4- and 8-voxel chunks, an odd 3-D volume, and
#: a length of thousands of blocks with a ragged tail (2^21 + 1031)
SHAPES = ((1,), (7,), (8,), (9,), (1031,), (5, 7, 9), (2 ** 21 + 1031,))
#: storage offsets in elements of the (first, second, third) tensor:
#: aligned, 16-byte aligned with an offset (float32 only: 8 bytes for
#: bfloat16), and misaligned mixes
OFFSETS = ((0, 0, 0), (4, 4, 4), (1, 0, 0), (0, 3, 0), (0, 0, 5), (7, 7, 7),
           (2, 6, 1))
#: NaN, ±inf, ±0 and ordinary values of both signs
SPECIAL = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -2.5, 1e-30,
                    -1e-30, 3.0e38, -3.0e38], np.float32)
#: cg_direction's instances by their (r, p, q) storage: q None for the
#: plain form (the "apply" CG's exact and compact_dirs storage), bf16 for
#: the deferred form (state_dtype=bfloat16)
DIRECTION_FORMS = {"cg_direction": (torch.float32, torch.float32, None),
                   "cg_direction[bf16]": (torch.float32, torch.bfloat16,
                                          None),
                   "cg_direction[state]": (torch.bfloat16, torch.bfloat16,
                                           torch.bfloat16)}
#: a = scal[A] and β = scal[BETA], exact in float32 as the solve's are
A, BETA = float(np.float32(0.31)), float(np.float32(0.83))
#: a float32 output's band: max |Δ| ≤ KERNEL_TOL · max |ref|
KERNEL_TOL = 1e-5


def offset_view(values, dtype, offset, device):
    """The numpy ``values`` in a contiguous view ``offset`` elements into a
    larger buffer on ``device``."""
    buf = torch.zeros(values.size + 8, dtype=dtype, device=device)
    view = buf[offset:offset + values.size].view(values.shape)
    view.copy_(torch.as_tensor(values, device=device))
    return view


def with_specials(x):
    """``x`` with every third element taken from SPECIAL, in place."""
    flat = x.reshape(-1)
    flat[::3] = SPECIAL[np.arange(flat[::3].size) % SPECIAL.size]
    return x


def bf16_ulp(v):
    """One bfloat16 ulp at |v| (2^(e − 8) for |v| in [2^(e−1), 2^e)), 0 at
    0."""
    _, e = torch.frexp(v)
    return torch.where(v != 0, torch.ldexp(torch.ones_like(v), e - 8),
                       torch.zeros_like(v))


def scalars(device):
    """The CG scalars with a = A and β = BETA."""
    s = B.new_scalars(device)
    s[B.A], s[B.BETA] = A, BETA
    return s


def _held(got, ref, what, exact):
    """NaN where ``ref`` has NaN; elsewhere equal (``exact``), within one
    bf16 ulp (a bf16 output), or within KERNEL_TOL · max |ref|."""
    nan = torch.isnan(ref.float())
    assert torch.equal(torch.isnan(got.float()), nan), \
        "%s: NaN where plain has none, or none where it has" % what
    g, f = got.float()[~nan], ref.float()[~nan]
    if g.numel() == 0:
        return
    if exact:
        ok = torch.equal(g, f)
    elif got.dtype == torch.bfloat16:
        ok = bool(((g - f).abs() <= bf16_ulp(f)).all())
    else:
        ok = float((g - f).abs().max()) <= KERNEL_TOL * float(f.abs().max())
    assert ok, "%s: beyond its band of plain (max |d| %.3g)" % (
        what, float((g - f).abs().max()))


def _case(unit, shape, device, rng):
    """(run(offsets) -> outputs, plain outputs, exact, wrapper, launches a
    run)."""
    def rand():
        return (rng.rand(*shape) - 0.5).astype(np.float32) * 4.0

    if unit in DIRECTION_FORMS:
        dts = DIRECTION_FORMS[unit]
        r, p, q = rand(), rand(), rand()
        scal = scalars(device)

        def tensors(off):
            return [None if dt is None else offset_view(v, dt, o, device)
                    for v, dt, o in zip((r, p, q), dts, off)]

        rp, pp, qp = tensors((0, 0, 0))
        T.cg_direction_plain(pp, rp, scal, qp)

        def run(off):
            rk, pk, qk = tensors(off)
            T.cg_direction(pk, rk, scal, qk)
            return [pk, rk]
        return run, [pp, rp], False, T.cg_direction, 1
    if unit == "tik_clip":
        x = with_specials(rand())
        ref = torch.empty(shape, device=device)
        TK.tik_clip_plain(ref, torch.as_tensor(x, device=device))

        def run(off):
            xk = offset_view(x, torch.float32, off[0], device)
            out = offset_view(np.zeros_like(x), torch.float32, off[1], device)
            TK.tik_clip(out, xk)   # out of place
            TK.tik_clip(xk, xk)    # in place
            return [out, xk]
        return run, [ref, ref], True, TK.tik_clip, 2
    assert unit == "irls_step", unit
    x = with_specials(rand())
    xk = np.roll(x, 5)
    ref = torch.tensor(x, device=device)
    R.irls_step_plain(ref, torch.tensor(xk, device=device))

    def run(off):
        xt = offset_view(x, torch.float32, off[0], device)
        R.irls_step(xt, offset_view(xk, torch.float32, off[1], device))
        return [xt]
    return run, [ref], True, R.irls_step, 1


def check(unit, shape, device, seed=16):
    """``unit`` (a key of DIRECTION_FORMS, ``"tik_clip"`` or
    ``"irls_step"``) against its plain version at ``shape`` on every
    offset pattern of OFFSETS: a float32 direction within KERNEL_TOL ·
    max |ref|, a bf16 one within one bf16 ulp, a clip equal (NaN where the
    plain version has NaN); every offset gives the aligned call's bits,
    and every kernel call counts one launch. Returns the number of kernel
    calls checked."""
    run, refs, exact, wrapper, per_run = _case(
        unit, shape, device, np.random.RandomState(seed))
    first, checked = None, 0
    for off in OFFSETS:
        before = wrapper.launches
        got = run(off)
        torch.cuda.synchronize(device)
        assert wrapper.launches == before + per_run, \
            "%s: %d launches counted, expected %d" % (
                unit, wrapper.launches - before, per_run)
        what = "%s %s offsets %s" % (unit, shape, off)
        for g, f in zip(got, refs):
            _held(g, f, what, exact)
        got = [g.view(torch.int16 if g.dtype == torch.bfloat16
                      else torch.int32).cpu() for g in got]
        first = first or got
        assert all(torch.equal(g, f) for g, f in zip(got, first)), \
            "%s: other bits than the aligned call" % what
        checked += per_run
    return checked
