"""The shard probes, plain and on a ``"space"`` mesh (counterpart of
``benchmarks/shard_pallas_diag.py`` and ``shard_pallas_diag2.py`` to
``shard_pallas_diag7.py``).

On the TPU those seven scripts took apart one cost: a Pallas kernel run
inside a 1-device ``shard_map`` against the same kernel under plain ``jit``
(the finding behind the reference's routing rule,
``nsol_tpu/parallel/mesh.py:189-204``). Here each probe kernel is a
hand-written CUDA kernel of ``csrc/probes.cu``, and every variant runs two
ways:

* **plain**: a call on a tensor (the probes' plain ``jit``);
* **on the mesh**: as a rank of :mod:`nsol_tpu_torch.parallel` runs it, on
  its slab of the volume, a halo'd form taking its wrap halo from
  :func:`~nsol_tpu_torch.parallel.halo.exchange_halo_wrap` (at world size 1
  a local copy and a ``torch.cat``) and its window from row ``rank·Zl`` (the
  probes' 1-device ``shard_map``). A form with no halo runs the same
  launches on the slab, which at world size 1 is the whole volume.

The kernels. Each wrapper checks device, dtype, shape and contiguity,
launches its kernel on a CUDA tensor and adds one to its count where it
does (:func:`launch_counts`); on a CPU tensor it runs its plain version
``*_plain``, which the tests and ``chip_smoke.py`` hold it to.

* :func:`probe_scale` — ``s·x`` over z-blocks of ``zb`` planes, ``s`` a
  number or a float32 on the device (``diag.py:68``, ``diag2.py:45``,
  ``diag3.py:48``, ``diag4.py:89``);
* :func:`probe_window_scale` — each z-block's window of ``zb + 2·halo``
  planes of a prepadded volume copied into shared memory in a ring of one or
  two slots, its centre written scaled (``diag4.py:46``, ``diag5.py:68``,
  ``diag6.py:48``);
* :func:`probe_block_matmul` — a product of every (Y, X) plane with a
  matrix, on the x side (``P·m``) or the y side (``mᵀ·P``; ``trans`` for
  ``P·mᵀ`` and ``m·P``), at ``"HIGHEST"`` (float32 sums) or ``"DEFAULT"``
  (the TPU matrix unit's: bfloat16 inputs, float32 sums) (``diag6.py:48``,
  ``diag7.py:46``).

The variants (:data:`VARIANTS`) keep the probes' names and depths: the
``jit`` calls of ``diag.py`` and ``diag2.py`` (d1-d4, e1-e5) are timed a
call over a chain of 40, the ``lax.scan`` loops of ``diag3.py`` to
``diag7.py`` a step over chains of 5 × 100 or 4 × 50 steps; each call feeds
the last one's output in (:func:`chain`, ``diag.py:38-45``). d1, d4, e5,
diag3's ``apply1`` and g3 run the port's own normal operators
(:func:`~nsol_tpu_torch.ops.cuda.blocked.make_blocked_normal_operator` and
its prepadded form); g1 (the halo alone) and i3 (the XLA ``einsum``) are
plain torch ops, controls as in the probes.

    python -m nsol_tpu_torch.parallel.shard_probe                 # the card
    python -m nsol_tpu_torch.parallel.shard_probe --device cpu    # plain CPU

prints one line a variant: its plain ms and its ms on a ``"space"`` mesh of
a process group of world size 1 (NCCL on the card, gloo on the CPU), which
it makes and destroys. It runs on the card unless ``--device cpu`` is given,
and raises where torch sees no GPU.
"""

import argparse
import contextlib
import socket
import sys
import time

import numpy as np
import torch

from nsol_tpu_torch.ops.cuda import blocked as B
from nsol_tpu_torch.ops.cuda import build
from nsol_tpu_torch.parallel.halo import exchange_halo_wrap

__all__ = ["probe_scale", "probe_window_scale", "probe_block_matmul",
           "probe_scale_plain", "probe_window_scale_plain",
           "probe_block_matmul_plain", "launch_counts", "reset_counts",
           "wrap_halo", "apply_variant", "chain", "VARIANTS", "run_probes",
           "table", "main"]

#: the probes' volume, z-block, halo and factors
SHAPE = (256, 256, 256)
SMALL = (32, 64, 64)  # diag2.py's second shape
ZB = 32
R = 6
SCALE = 1.0000001
RHO = 0.5
COV = np.diag([1.0] * 3)
SIDES = ("x", "y")
PRECISIONS = ("HIGHEST", "DEFAULT")
#: ``csrc/probes.cu``'s count slots, and the names of its kernels in them
COUNTS = 4
KERNELS = ("probe_scale", "probe_window_scale", "probe_block_matmul",
           "probe_block_matmul[default]")


# ---------------------------------------------------------- plain forms --

@B.counted
def probe_scale_plain(x, s):
    """``s·x``."""
    return x * s


@B.counted
def probe_window_scale_plain(x_ext, s, halo=R):
    """``s·x_ext[halo : Z + halo]`` of a ``(Z + 2·halo, Y, X)`` volume."""
    return x_ext.narrow(0, halo, x_ext.shape[0] - 2 * halo) * s


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


@B.counted
def probe_block_matmul_plain(x, m, side="x", precision="HIGHEST",
                             trans=False):
    """Every plane ``P`` of ``x`` times ``m``: ``P·m`` (``side="x"``,
    ``P·mᵀ`` with ``trans``) or ``mᵀ·P`` (``side="y"``, ``m·P`` with
    ``trans``) by ``torch.matmul`` in ``x``'s dtype (on the card with TF32
    as the caller set it: ``chip_smoke.py`` turns it off); ``"DEFAULT"``
    rounds ``x`` and ``m`` to bfloat16 first, as the TPU's matrix unit
    does."""
    if precision == "DEFAULT":
        x, m = _bf16(x), _bf16(m)
    mm = m.T if trans else m
    return torch.matmul(x, mm) if side == "x" else torch.matmul(mm.T, x)


# -------------------------------------------------------------- kernels --

def _check_columns(name, v):
    """A contiguous float32 CUDA volume of 16-byte plane columns."""
    if v.dim() != 3:
        raise ValueError("%s: a 3-D volume, got shape %s"
                         % (name, tuple(v.shape)))
    B.check_tensors(name, v.shape, v)
    if (v.shape[1] * v.shape[2]) % 4 or v.data_ptr() % 16:
        raise ValueError("%s: the kernel moves 16-byte columns; a plane of "
                         "%d × %d at offset %d is not"
                         % (name, v.shape[1], v.shape[2], v.data_ptr() % 16))


def _factor(name, s, device):
    """``(s, None)`` for a number, ``(0, pointer)`` for a float32 on the
    device."""
    if torch.is_tensor(s):
        if s.device != device or s.dtype != torch.float32 or s.numel() != 1:
            raise ValueError("%s: a device factor is one float32 on %s"
                             % (name, device))
        return 0.0, build.tensor_ptr(s)
    return float(s), None


def probe_scale(x, s, zb=ZB):
    """``s·x`` of a ``(Z, Y, X)`` volume over z-blocks of ``zb`` planes
    (``csrc/probes.cu``); ``s`` a number or a float32 on ``x``'s device."""
    if x.device.type == "cpu":
        return probe_scale_plain(x, s)
    name = "probe_scale"
    _check_columns(name, x)
    if zb < 1:
        raise ValueError("%s: zb %d" % (name, zb))
    f, f_dev = _factor(name, s, x.device)
    out = torch.empty_like(x)
    counts = build.new_counts(COUNTS)
    err = build.load().nsol_probe_scale(
        build.tensor_ptr(x), build.tensor_ptr(out), f, f_dev, *x.shape,
        int(zb), build.stream_ptr(x.device), counts)
    build.check(err, name)
    probe_scale.launches += counts[0]
    return out


def probe_window_scale(x_ext, s, zb=ZB, halo=R, slots=1):
    """``s·x_ext[halo : Z + halo]`` of a ``(Z + 2·halo, Y, X)`` volume (at
    ``halo`` 0 an unpadded one): each z-block's window of ``zb + 2·halo``
    planes copied into shared memory through a ring of ``slots`` (1 or 2),
    then its centre stored (``csrc/probes.cu``)."""
    z = x_ext.shape[0] - 2 * int(halo) if x_ext.dim() == 3 else 0
    if halo < 0 or z < 1 or zb < 1 or slots not in (1, 2):
        raise ValueError("probe_window_scale: %s planes, halo %s, zb %s, "
                         "slots %s" % (tuple(x_ext.shape)[:1], halo, zb,
                                       slots))
    if x_ext.device.type == "cpu":
        return probe_window_scale_plain(x_ext, s, halo)
    name = "probe_window_scale"
    _check_columns(name, x_ext)
    f, f_dev = _factor(name, s, x_ext.device)
    out = torch.empty((z,) + tuple(x_ext.shape[1:]), device=x_ext.device)
    counts = build.new_counts(COUNTS)
    err = build.load().nsol_probe_window_scale(
        build.tensor_ptr(x_ext), build.tensor_ptr(out), f, f_dev, z,
        *x_ext.shape[1:], int(zb), int(halo), int(slots),
        build.stream_ptr(x_ext.device), counts)
    build.check(err, name)
    probe_window_scale.launches += counts[1]
    return out


def probe_block_matmul(x, m, side="x", precision="HIGHEST", trans=False):
    """Every (Y, X) plane ``P`` of ``x`` times the matrix ``m``: ``P·m`` on
    the x side (``m`` (X, X); ``P·mᵀ`` with ``trans``), ``mᵀ·P`` on the y
    side (``m`` (Y, Y); ``m·P`` with ``trans``). ``"HIGHEST"``: float32
    sums (counted on ``.launches``); ``"DEFAULT"``: ``x`` and ``m`` rounded
    to bfloat16, float32 sums (``.default_launches``)
    (``csrc/probes.cu``)."""
    if side not in SIDES or precision not in PRECISIONS:
        raise ValueError("probe_block_matmul: side %r of %s, precision %r "
                         "of %s" % (side, SIDES, precision, PRECISIONS))
    if x.dim() != 3:
        raise ValueError("probe_block_matmul: a 3-D volume, got shape %s"
                         % (tuple(x.shape),))
    k = x.shape[2] if side == "x" else x.shape[1]
    if tuple(m.shape) != (k, k):
        raise ValueError("probe_block_matmul: the %s side takes a (%d, %d) "
                         "matrix, got %s" % (side, k, k, tuple(m.shape)))
    if x.device.type == "cpu":
        return probe_block_matmul_plain(x, m, side, precision, trans)
    name = "probe_block_matmul"
    B.check_tensors(name, x.shape, x)
    B.check_tensors(name, m.shape, m, device=x.device)
    out = torch.empty_like(x)
    counts = build.new_counts(COUNTS)
    err = build.load().nsol_probe_block_matmul(
        build.tensor_ptr(x), build.tensor_ptr(m), build.tensor_ptr(out),
        *x.shape, SIDES.index(side), int(bool(trans)),
        PRECISIONS.index(precision), build.stream_ptr(x.device), counts)
    build.check(err, name)
    probe_block_matmul.launches += counts[2]
    probe_block_matmul.default_launches += counts[3]
    return out


def reset_counts():
    """Set every probe kernel's launch count to 0."""
    probe_scale.launches = probe_window_scale.launches = 0
    probe_block_matmul.launches = probe_block_matmul.default_launches = 0


def launch_counts():
    """``{kernel: launches}`` of :data:`KERNELS`, and of the two normal
    units d1, d4, e5, ``apply1`` and g3 reuse (their wrappers' counts: the
    window unit's, and the whole-volume unit's chain and march)."""
    return {"probe_scale": probe_scale.launches,
            "probe_window_scale": probe_window_scale.launches,
            "probe_block_matmul": probe_block_matmul.launches,
            "probe_block_matmul[default]":
                probe_block_matmul.default_launches,
            "normal_apply_prepadded": B.normal_apply_prepadded.launches,
            "normal_apply": B.normal_apply.launches
            + B.normal_apply.march_launches}


reset_counts()


# ------------------------------------------------------------- variants --

def wrap_halo(c, r, mesh=None):
    """``c`` with ``r`` wrap planes on each side along z: plain, the
    probes' ``jnp.concatenate([c[-r:], c, c[:r]])``; on ``mesh``, the ring
    exchange of :func:`~nsol_tpu_torch.parallel.halo.exchange_halo_wrap`."""
    if mesh is None:
        return torch.cat([c[-r:], c, c[:r]])
    return exchange_halo_wrap(c, mesh, r, r)


class _Ops(object):
    """What the variants close over, built once for a rank's slab of
    ``local`` shape in a volume of ``z_total`` planes on ``device``: the
    port's normal operators at σ = 1 (the probes' ``cov``), ``diag6.py``'s
    four matrices on each side (identities), ``diag7.py``'s ``m``
    (0.999999·I) and ``diag4.py``'s factor as a float32 on the device."""

    def __init__(self, local, z_total, device):
        self.pre = B.make_blocked_normal_operator_prepadded(
            local, COV, z_total=z_total)
        self.ap = B.make_blocked_normal_operator(local, COV)
        y, x = local[1:]
        f32 = dict(dtype=torch.float32, device=device)
        self.mats = [(torch.eye(y, **f32), torch.eye(x, **f32))
                     for _ in range(4)]
        self.m_i = torch.eye(x, **f32) * 0.999999
        self.s = torch.full((1, 1), SCALE, dtype=torch.float32, device=device)


def _row0(c, mesh):
    return 0 if mesh is None else mesh.rank * c.shape[0]


def _pre(c, o, mesh, r=None):
    if r is not None and r != o.pre.halo:
        raise ValueError("the prepadded operator's halo is %d, the probe's "
                         "%d" % (o.pre.halo, r))
    return o.pre(wrap_halo(c, o.pre.halo, mesh), RHO, _row0(c, mesh))


def _diag6(c, o, mesh, slots, matmuls):
    """``diag6.py::make_variant``'s step: the halo'd window scaled, then
    per matrix pair ``P ← m·P`` and ``P ← P·mᵀ`` at HIGHEST."""
    u = probe_window_scale(wrap_halo(c, R, mesh), SCALE, ZB, R, slots)
    if matmuls:
        for my, mx in o.mats:
            u = probe_block_matmul(u, my, "y", "HIGHEST", trans=True)
            u = probe_block_matmul(u, mx, "x", "HIGHEST", trans=True)
    return u


class Variant(object):
    """One probe variant: its ``name`` and ``script`` (the probe's), what
    it runs, its step ``step(c, ops, mesh)``, the probe kernels' launches
    a step (``kernels``), the port's units it runs instead (``units``, by
    their :func:`launch_counts` names), whether it runs at :data:`SMALL`
    (``small``), and its chain: ``n`` timed calls of ``inner`` steps
    each."""

    def __init__(self, name, script, what, step, kernels=None, units=(),
                 small=False, n=4, inner=50):
        self.name, self.script, self.what, self.step = name, script, what, step
        self.kernels, self.units = dict(kernels or {}), units
        self.small, self.n, self.inner = small, n, inner


_K1, _K2 = {"probe_scale": 1}, {"probe_window_scale": 1}
_K3 = {"probe_window_scale": 1, "probe_block_matmul": 8}
_WINDOW, _WHOLE = ("normal_apply_prepadded",), ("normal_apply",)
#: the variants, under the probes' names (``diag2.py``'s fifth, its
#: unnamed "small wrap-DMA", as e5; ``diag3.py``'s two loops by its step
#: functions' names; ``diag4.py``'s f2 and f3, which differ only in the
#: TPU memory space, ANY or HBM, that CUDA has no counterpart of, as one)
VARIANTS = (
    Variant("d1", "diag.py:58", "normal window, wrap halo (no ppermute)",
            lambda c, o, m: _pre(c, o, m), units=_WINDOW, n=40, inner=1),
    Variant("d2/d3", "diag.py:68", "K1 2·x, zb 32",
            lambda c, o, m: probe_scale(c, 2.0, 32), _K1, n=40, inner=1),
    Variant("d4", "diag.py:87", "normal operator (whole slab)",
            lambda c, o, m: o.ap(c, RHO), units=_WHOLE, n=40, inner=1),
    Variant("e1/e2", "diag2.py:45", "K1 2·x, zb 8",
            lambda c, o, m: probe_scale(c, 2.0, 8), _K1, n=40, inner=1),
    Variant("e3/e4", "diag2.py:45", "K1 2·x, zb 8, (32, 64, 64)",
            lambda c, o, m: probe_scale(c, 2.0, 8), _K1, small=True, n=40,
            inner=1),
    Variant("e5", "diag2.py:75", "normal operator, (32, 64, 64)",
            lambda c, o, m: o.ap(c, RHO), units=_WHOLE, small=True, n=40,
            inner=1),
    Variant("diag3 k", "diag3.py:48", "K1 1.0000001·x, zb 32",
            lambda c, o, m: probe_scale(c, SCALE, ZB), _K1, n=5, inner=100),
    Variant("diag3 apply1", "diag3.py:74", "wrap halo + normal window",
            lambda c, o, m: _pre(c, o, m), units=_WINDOW, n=5, inner=100),
    Variant("f1", "diag4.py:89", "K1 (the BlockSpec control)",
            lambda c, o, m: probe_scale(c, SCALE, ZB), _K1),
    Variant("f2/f3", "diag4.py:46", "K2 halo 0, one slot (ANY or HBM)",
            lambda c, o, m: probe_window_scale(c, SCALE, ZB, 0, 1), _K2),
    Variant("f4", "diag4.py:46", "K2 halo 0, factor in device memory",
            lambda c, o, m: probe_window_scale(c, o.s, ZB, 0, 1), _K2),
    Variant("g1", "diag5.py:50", "wrap halo alone, centre · s (torch ops)",
            lambda c, o, m: wrap_halo(c, R, m).narrow(0, R, c.shape[0])
            * SCALE),
    Variant("g2", "diag5.py:68", "wrap halo + K2 halo 6, one slot",
            lambda c, o, m: probe_window_scale(wrap_halo(c, R, m), SCALE, ZB,
                                               R, 1), _K2),
    Variant("g3", "diag5.py:106", "wrap halo + normal window",
            lambda c, o, m: _pre(c, o, m, R), units=_WINDOW),
    Variant("h1", "diag6.py:48", "K2 one slot + 8 K3 HIGHEST",
            lambda c, o, m: _diag6(c, o, m, 1, True), _K3),
    Variant("h2", "diag6.py:48", "K2 two slots",
            lambda c, o, m: _diag6(c, o, m, 2, False), _K2),
    Variant("h3", "diag6.py:48", "K2 two slots + 8 K3 HIGHEST",
            lambda c, o, m: _diag6(c, o, m, 2, True), _K3),
    Variant("i1", "diag7.py:46", "K3 x side HIGHEST",
            lambda c, o, m: probe_block_matmul(c, o.m_i, "x", "HIGHEST"),
            {"probe_block_matmul": 1}),
    Variant("i2", "diag7.py:46", "K3 x side DEFAULT",
            lambda c, o, m: probe_block_matmul(c, o.m_i, "x", "DEFAULT"),
            {"probe_block_matmul[default]": 1}),
    Variant("i3", "diag7.py:87", "torch.matmul f32 (the XLA einsum)",
            lambda c, o, m: torch.matmul(c, o.m_i)),
)


def apply_variant(name, c, mesh=None, steps=1):
    """``steps`` steps of the variant ``name`` of :data:`VARIANTS` on ``c``
    (plain, or this rank's slab on ``mesh``: a volume of ``mesh.size``
    slabs), its operators built for ``c``."""
    v = next((v for v in VARIANTS if v.name == name), None)
    if v is None:
        raise ValueError("unknown variant %r" % (name,))
    world = 1 if mesh is None else mesh.size
    o = _Ops(tuple(c.shape), c.shape[0] * world, c.device)
    for _ in range(steps):
        c = v.step(c, o, mesh)
    return c


def chain(f, v, n):
    """ms a call of ``f`` over ``n`` calls, each fed the last one's output
    (the probes' ``chain``, ``diag.py:38-45``), after one call from ``v``
    that warms it: by CUDA events on the card, by the host clock on the
    CPU."""
    f(v)
    if v.device.type != "cuda":
        t0 = time.perf_counter()
        x = v
        for _ in range(n):
            x = f(x)
        return (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize(v.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    x = v
    for _ in range(n):
        x = f(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


@contextlib.contextmanager
def _no_tf32():
    """float32 products in float32 inside the block (K3's HIGHEST control
    and i3), as they were after it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def run_probes(mesh=None, device="cuda", shape=SHAPE, small=SMALL,
               depth=None):
    """Run every variant of :data:`VARIANTS` plain and, with ``mesh`` (a
    ``"space"`` mesh on ``device``), on the mesh on this rank's rows of the
    same volume (uniform in [0, 1) from seed 0, ``shape``, or ``small`` for
    the variants of ``diag2.py``'s second shape). ``depth``: ``(n, inner)``
    for every variant in place of its own.
    Returns one row a variant: ``name``, ``script``, ``what``, ``per``
    ("call" or "step"), ``shape``, ``n``, ``inner``, ``ms`` (plain) and
    ``mesh_ms`` (None without a mesh) a call or step, ``launches`` of
    :func:`launch_counts`' kernels each way (``{"plain": {...}, "mesh":
    {...}}``: on the CPU none), ``expect``, the probe kernels' launches
    each way on the card, and ``units``, the port's units it runs
    instead."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("run_probes(device=%r): torch sees no CUDA "
                               "device" % str(device))
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    if mesh is not None and mesh.device != device:
        raise ValueError("run_probes: the mesh's device %s is not %s"
                         % (mesh.device, device))
    rng = np.random.RandomState(0)
    volumes = {}
    for full in sorted({tuple(small if v.small else shape)
                        for v in VARIANTS}):
        volumes[full] = torch.as_tensor(
            rng.rand(*full).astype(np.float32), device=device)
    ops, rows = {}, []
    with _no_tf32():
        for v in VARIANTS:
            vol = volumes[tuple(small if v.small else shape)]
            n, inner = depth or (v.n, v.inner)
            row = {"name": v.name, "script": v.script, "what": v.what,
                   "per": "call" if inner == 1 else "step",
                   "shape": tuple(vol.shape), "n": n, "inner": inner,
                   "mesh_ms": None, "launches": {}, "units": v.units,
                   "expect": {k: c * (n + 1) * inner
                              for k, c in v.kernels.items()}}
            for side, m in (("plain", None), ("mesh", mesh)):
                if side == "mesh" and m is None:
                    continue
                local = vol
                if m is not None:
                    zl = vol.shape[0] // m.size
                    if zl * m.size != vol.shape[0]:
                        raise ValueError("run_probes: %d planes over %d ranks"
                                         % (vol.shape[0], m.size))
                    local = vol[m.rank * zl:(m.rank + 1) * zl].contiguous()
                key = (tuple(local.shape), vol.shape[0])
                if key not in ops:
                    ops[key] = _Ops(key[0], key[1], device)
                o = ops[key]

                def call(u, v=v, o=o, m=m, inner=inner):
                    for _ in range(inner):
                        u = v.step(u, o, m)
                    return u

                before = launch_counts()
                ms = chain(call, local, n) / inner
                after = launch_counts()
                row["ms" if m is None else "mesh_ms"] = ms
                row["launches"][side] = {k: after[k] - before[k]
                                         for k in after}
            rows.append(row)
    return rows


def table(rows):
    """The rows of :func:`run_probes` as text, a line each."""
    out = []
    for r in rows:
        mesh = "not run" if r["mesh_ms"] is None else "%.4f" % r["mesh_ms"]
        out.append("%-13s %-13s %-42s plain %.4f ms, mesh %s ms a %s "
                   "(%d × %d)" % (r["name"], r["script"], r["what"], r["ms"],
                                  mesh, r["per"], r["n"], r["inner"]))
    return out


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def main(argv=None):
    """Print the probes' table, plain and on a world-1 ``"space"`` mesh."""
    from nsol_tpu_torch.parallel import distributed as dist
    from nsol_tpu_torch.parallel.mesh import make_space_mesh

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu (plain versions)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("shard_probe: torch sees no CUDA device; pass "
                           "--device cpu for the plain versions")
    if device.type == "cuda":
        print("device: %s" % torch.cuda.get_device_name(device))
    dist.initialize(coordinator_address="localhost:%d" % _free_port(),
                    num_processes=1, process_id=0, device=device.type)
    try:
        rows = run_probes(mesh=make_space_mesh(device=device), device=device)
    finally:
        torch.distributed.destroy_process_group()
    print("\n".join(table(rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
