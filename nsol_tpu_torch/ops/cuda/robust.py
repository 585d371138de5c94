"""Robust (IRLS) deconvolution kernels: counterparts of
``nsol_tpu/ops/pallas/robust.py`` and of the robust branch of
``nsol_tpu/ops/pallas/fused.py::make_fused_admm_solver``.

Four kernel units (CUDA C++ in ``csrc/robust.cu``), each with its plain
PyTorch version beside it and a launch counter on its wrapper:

* :func:`blur_apply` — ``A y``, with ``u`` ``+ ρ·BᵀB u``; replaces
  ``robust.py::make_blocked_blur_operator`` (:161). With ``scal`` it is
  the gradient that opens an IRLS sweep: ``g = A y + ρ·BᵀB x`` for
  ``y = wts·r``, the active set ``free`` (0 where ``x ≤ 0`` and ``g > 0``,
  else 1, a float field), ``rk = −free·g``, ``γ = ‖rk‖²`` and ``β = 0``.
* :func:`irls_head` — ``r = A x − b``, ``wts = ρ'_C(r²)``, ``y = wts·r``:
  the weights one sweep freezes (``fused.py:587-588``,
  ``robust.py:508-509``).

Where :func:`~.tiled.vol_route` takes the shape and the blur taps, the
C entries run both as whole-volume instances of ``csrc/march.cuh``'s
single-stencil march (``csrc/blur_march.cu``, counted on
``blur_apply.march_launches`` / ``irls_head.march_launches``), with no
scratch volume; else as three passes. The two give the same bits.

* :func:`weighted_apply` — ``p' = r + β·p``, ``pf = free·p'``,
  ``q = free·(Aᵀ(wts·A pf) + ρ·BᵀB pf) + (p' − pf)``, ``pq = Σ p'·q``,
  ``a = γ/pq`` (guarded); replaces
  ``robust.py::make_blocked_weighted_normal_operator`` (:264) and the
  in-kernel ``apply_W`` of ``fused.py`` (:593-597). Where
  :func:`~.tiled.vol_route` takes the shape and the blur taps (a volume
  past 2^20 voxels deep enough for the march's z halo, whose taps fit a
  block) the C entry runs it as the whole-volume instance of
  ``csrc/march.cuh``'s weighted march (``csrc/weighted_march.cu``,
  counted on ``weighted_apply.march_launches``), with no scratch volume;
  else as six passes. The two give the same ``p'`` and ``q`` bit for
  bit.
* :func:`irls_step` — ``x = max(x + xk, 0)`` (``fused.py:622``), a NaN
  kept as ``jnp.maximum`` keeps it.

and the two per-shard units of the sharded path
(:mod:`nsol_tpu_torch.parallel`), the ``prepadded=True`` forms of the two
TPU kernels, on a z-window whose halo planes the ring exchange has
attached, the Laplacian's global boundary rows placed by
``row0``/``z_total``:

* :func:`blur_apply_prepadded` — ``A y`` (+ ``ρ·DᵀD u``), halo
  ``max(r_a, 1)`` (``robust.py:161``, :184, :240-257): the IRLS residual
  and gradient. Where a block's shared memory holds the blur taps it
  runs as a window instance of the single-stencil march
  (``csrc/blur_march.cu``, :func:`~.blocked.window_route`, counted on
  ``blur_apply_prepadded.march_launches``), with no scratch volume; else
  the three per-axis passes.
* :func:`weighted_apply_prepadded` — ``Aᵀ(w ⊙ A v) + ρ·DᵀD v``, halo
  ``max(2·r_a, 1)`` (``robust.py:264``, :286-401): the inner CG's apply.
  On bfloat16 windows it is the reference's prepadded ``io_dtype`` form
  (``nsol_tpu/parallel/blocked_halo.py:115-119``): ``v`` and ``w`` read as
  bfloat16, float32 arithmetic, the result rounded to bfloat16. Where a
  block's shared memory holds the blur taps it runs as a window instance
  of ``csrc/tiled.cu``'s weighted march (:func:`~.blocked.window_route`),
  with no scratch volume; else the three per-axis passes.

``BᵀB`` is the Laplacian ``DᵀD`` (``reg="TK1"``, the ADMM x-update's and
TK1's) or the identity (``reg="TK0"``), as in :mod:`.blocked`; the
Tikhonov solve of :mod:`.tikhonov` runs these units with ``ρ := α``.
The masked CG between applies is ``blocked.cg_update``. The TPU kernel
splits into a VMEM-resident whole solve (``fused.py``) and a streaming one
(``robust.py::blocked_robust_admm_solve``) only because of VMEM; here both
entry points run one launch sequence that ``nsol_robust_admm_solve``
enqueues in C. Bytes bound every unit; see the note at the top of
``csrc/robust.cu``. At 512-wide planes (``robust.py:432-491``)
:func:`blocked_robust_admm_solve` runs the same sequence with the
one-pass tiled units of :mod:`.tiled` swapped in
(``nsol_robust_admm_solve_zy``); :func:`make_blocked_blur_operator_2d` and
:func:`make_blocked_weighted_normal_operator_2d` are the reference's 2-D
entry points over them.

Where :func:`~.tiled.irls_persistent_fits` takes the shape (storage exact or
dirs, at most 2^20 voxels where none of ``irls_head``, ``blur_apply`` and
``weighted_apply`` marches: the Lena and 64³ solves), the whole solve runs
instead as one persistent cooperative launch, ``csrc/irls_persistent.cu``:
each unit of every sweep a phase between grid barriers, the units' pass
bodies those of ``csrc/robust_units.cuh``, the same bits
(:func:`irls_persistent`'s count); the robust Tikhonov batch of
:mod:`.tikhonov` takes it too.

The compact storage of the reference (:data:`ROBUST_STORAGE`): the fused
solve's ``compact_dirs`` stores the masked CG's direction in bfloat16
("dirs"); ``blocked_robust_admm_solve(compact_dirs=True)`` and the
weighted operators' ``io_dtype=bfloat16`` also read the weights as
bfloat16 in the apply and round its output to bfloat16 ("io"). One C
template per unit over the modes; the head, the gradient and the step
stay float32 in every mode.

A 2-D image runs on CUDA as a ``(1, Y, X)`` volume with z taps ``[1]`` and
``1/h_z² = 0``: every z term is an exact ``+0``, so the kernels compute the
2-D operators (the CPU tests show the plain versions agree bit for bit).
Each wrapper runs the plain version only for CPU tensors; on a CUDA tensor
it launches the kernel (float32, contiguous, 2-D or 3-D) or raises.
"""

import numpy as np
import torch

from nsol_tpu_torch.ops import conv as C
from nsol_tpu_torch.ops import grad as G
from nsol_tpu_torch.ops import losses
from nsol_tpu_torch.ops.cuda import blocked as B
from nsol_tpu_torch.ops.cuda import build
from nsol_tpu_torch.ops.cuda import record as Rec
from nsol_tpu_torch.ops.prox import vectorial_soft_threshold
from nsol_tpu_torch.solvers.cg import guarded_ratio

__all__ = ["LOSS_IDS", "blur_apply", "blur_apply_plain", "irls_head",
           "irls_head_plain", "weighted_apply", "weighted_apply_plain",
           "irls_step", "irls_step_plain", "blur_apply_prepadded",
           "blur_apply_prepadded_plain", "weighted_apply_prepadded",
           "weighted_apply_prepadded_plain", "blur_halo", "weighted_halo",
           "irls_persistent", "persistent_shape",
           "persistent_barriers", "PERSISTENT_SLOT", "make_robust_solver",
           "make_blocked_blur_operator",
           "make_blocked_weighted_normal_operator",
           "make_blocked_blur_operator_2d",
           "make_blocked_weighted_normal_operator_2d",
           "blocked_robust_admm_solve"]

#: data losses by the index ``csrc/robust.cu`` takes (its ``Loss`` enum)
LOSS_IDS = Rec.LOSS_IDS

#: storage modes of the masked CG, in the order of ``csrc/stencil.cuh``'s
#: RobustStorage enum: ``"exact"``; ``"dirs"`` (the fused solves'
#: ``compact_dirs``, ``fused.py:329-377``): the direction ``p'`` rounded to
#: bfloat16 where it is formed and stored so; ``"io"``
#: (``blocked_robust_admm_solve(compact_dirs=True)``, the weighted
#: operator's ``io_dtype=bfloat16``, ``robust.py:469-548``): ``p'`` so, the
#: weights read as bfloat16 and the apply's core
#: ``Aᵀ(w·A pf) + ρ·BᵀB pf`` rounded to bfloat16 before
#: ``q = free·core + (p' − pf)`` is formed. ``r``, ``q``, ``x`` and every
#: sum stay float32.
ROBUST_STORAGE = ("exact", "dirs", "io")


def direction_dtype(storage):
    """The direction's storage dtype of a :data:`ROBUST_STORAGE` mode
    (None: the working dtype)."""
    if storage not in ROBUST_STORAGE:
        raise ValueError("robust storage must be one of %s, got %r"
                         % (ROBUST_STORAGE, storage))
    return None if storage == "exact" else B.BF16


# ------------------------------------------------------------ plain forms --

@B.counted
def blur_apply_plain(y, taps, inv_h2, u=None, rho=0.0, scal=None,
                     reg="TK1"):
    """Plain version of :func:`blur_apply`."""
    g = B._blur_plain(y, taps)
    if u is not None:
        g = g + rho * B.reg_normal_plain(u, inv_h2, reg)
    if scal is None:
        return g
    free = (~((u <= 0.0) & (g > 0.0))).to(g.dtype)
    rk = -free * g
    scal[B.GAMMA] = torch.sum(rk * rk)
    scal[B.BETA] = 0.0
    return free, rk


@B.counted
def irls_head_plain(x, b, taps, loss, scale):
    """Plain version of :func:`irls_head`. ``scale`` enters as a tensor of
    the working dtype, so ``r²/C²`` is a division in that dtype, as in
    the kernel and the reference."""
    r = B._blur_plain(x, taps) - b
    c = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    wts = losses.gradient_loss(loss)(r * r, f_scale=c)
    return wts, wts * r


@B.counted
def weighted_apply_plain(r, p, free, wts, scal, taps, inv_h2, rho,
                         first=False, reg="TK1", storage="exact"):
    """Plain version of :func:`weighted_apply`."""
    io = B.BF16 if storage == "io" else None  # the "io" apply's roundings
    p_new = B._store(r.clone() if first
                     else r + scal[B.BETA].to(r.dtype) * p.to(r.dtype),
                     direction_dtype(storage))
    pw = p_new.to(r.dtype)
    pf = pw if free is None else free * pw
    core = B._blur_plain(B._round(wts, io) * B._blur_plain(pf, taps), taps) \
        + rho * B.reg_normal_plain(pf, inv_h2, reg)
    core = B._round(core, io)
    q = core if free is None else free * core + (pw - pf)
    pq = torch.sum(pw * q).to(scal.dtype)
    scal[B.PQ] = pq
    scal[B.A] = guarded_ratio(scal[B.GAMMA], pq)
    return p_new, q


@B.counted
def irls_step_plain(x, xk):
    """Plain version of :func:`irls_step` (updates ``x`` in place)."""
    x.copy_(torch.clamp(x + xk, min=0.0))


def blur_halo(taps):
    """The z halo of the window blur: the blur taps' half-width, at least
    1 (the Laplacian's z neighbours)."""
    return max(taps.lengths[0] // 2, 1)


def weighted_halo(taps):
    """The z halo of the window weighted apply: twice the blur taps'
    half-width (the normal operator's), at least 1."""
    return max(2 * (taps.lengths[0] // 2), 1)


@B.counted
def blur_apply_prepadded_plain(y_ext, taps, inv_h2, row0, z_total,
                               u_ext=None, rho=0.0):
    """Plain version of :func:`blur_apply_prepadded`."""
    h = blur_halo(taps)
    B.prepadded_window("blur_apply_prepadded", y_ext, h, row0, z_total, u_ext)
    g = B.slab_blur_plain(y_ext, taps, h)
    if u_ext is None:
        return g
    return g + rho * B.window_laplacian_plain(u_ext, h, inv_h2, row0,
                                              z_total)


@B.counted
def weighted_apply_prepadded_plain(v_ext, w_ext, taps, inv_h2, rho, row0,
                                   z_total):
    """Plain version of :func:`weighted_apply_prepadded`."""
    r, ra = weighted_halo(taps), taps.lengths[0] // 2
    B.prepadded_window("weighted_apply_prepadded", v_ext, r, row0, z_total,
                       w_ext)
    io = v_ext.dtype == B.BF16
    if io:  # the "io" instance: float32 arithmetic on the bf16 windows
        v_ext, w_ext = v_ext.float(), w_ext.float()
    s = B.slab_blur_plain(v_ext, taps, r - ra)  # A v on Zl + 2 r_a rows
    s = s * w_ext[r - ra:r - ra + s.shape[0]]
    out = B.slab_blur_plain(s, taps, ra) + rho * B.window_laplacian_plain(
        v_ext, r, inv_h2, row0, z_total)
    return out.to(B.BF16) if io else out


# ---------------------------------------------------------------- kernels --

def blur_apply(y, taps, inv_h2, u=None, rho=0.0, scal=None, reg="TK1"):
    """``A y`` (``taps``: the blur :class:`~blocked.Taps`); with ``u``,
    ``A y + ρ·BᵀB u``. With ``scal`` (``u`` is then the IRLS iterate
    ``x``): the gradient form, returning ``(free, rk)`` with
    ``free = 0`` where ``x ≤ 0`` and ``g > 0`` (else 1) and
    ``rk = −free·g``, and setting ``scal[GAMMA] = ‖rk‖²``,
    ``scal[BETA] = 0``. On the card the C entry runs
    :func:`~.tiled.vol_route`'s route: the march (``csrc/blur_march.cu``,
    counted on ``blur_apply.march_launches``) or the three passes (on
    ``blur_apply.launches``); the two give the same bits."""
    if y.device.type == "cpu":
        return blur_apply_plain(y, taps, inv_h2, u, rho, scal, reg)
    return _blur_apply(y, taps, inv_h2, u, rho, scal, reg)


def _blur_apply(y, taps, inv_h2, u, rho, scal, reg, route=None):
    """:func:`blur_apply` on the card by ``route``: ``None`` takes
    :func:`~.tiled.vol_route`'s, ``"chain"`` the three passes (the bit
    reference the march is held to) and ``"march"`` the march whatever the
    rule says of the shape."""
    name = "blur_apply"
    dims = B.volume_dims(name, y)
    B.check_tensors(name, y.shape, y, *([u] if u is not None else []))
    B._check_consts(name, y.device, taps, scal)
    if scal is not None and u is None:
        raise ValueError("%s: the gradient form needs u = x" % name)
    lib = build.load()
    T = B._tiled()
    tv = taps.as_volume()
    route = route or T.vol_route(name, tv.lengths, dims)
    t1 = t2 = out = free = rk = partials = None
    if route == "chain":
        t1, t2 = torch.empty_like(y), torch.empty_like(y)
    if scal is None:
        out = torch.empty_like(y)
    else:
        free, rk = torch.empty_like(y), torch.empty_like(y)
        partials = T.tiled_partials(y.device, dims)
    counts = build.new_counts(B.COUNTS)
    err = lib.nsol_blur_apply(
        build.tensor_ptr(y), build.tensor_ptr(u), build.tensor_ptr(out),
        build.tensor_ptr(free), build.tensor_ptr(rk), build.tensor_ptr(t1),
        build.tensor_ptr(t2), build.tensor_ptr(partials),
        build.tensor_ptr(scal), build.tensor_ptr(tv.buf), *tv.lengths,
        float(rho), B.reg_id(reg), T.ROUTES.index(route),
        *B.spacing3(inv_h2), *dims, build.stream_ptr(y.device), counts)
    build.check(err, name)
    blur_apply.launches += counts[0]
    B.count_marches(counts, blur_apply)
    return out if scal is None else (free, rk)


def irls_head(x, b, taps, loss, scale):
    """IRLS weights of one sweep: ``r = A x − b``, returns
    ``(wts, y)`` with ``wts = ρ'_C(r²)`` for the named ``loss`` at
    ``C = scale`` and ``y = wts·r``. On the card the C entry runs
    :func:`~.tiled.vol_route`'s route: the march (``csrc/blur_march.cu``'s
    head form, counted on ``irls_head.march_launches``) or the three
    passes (on ``irls_head.launches``); the two give the same bits."""
    if loss not in LOSS_IDS:
        raise ValueError("unknown data loss %r" % (loss,))
    if x.device.type == "cpu":
        return irls_head_plain(x, b, taps, loss, scale)
    return _irls_head(x, b, taps, loss, scale)


def _irls_head(x, b, taps, loss, scale, route=None):
    """:func:`irls_head` on the card by ``route``, as :func:`_blur_apply`
    takes it."""
    name = "irls_head"
    dims = B.volume_dims(name, x)
    B.check_tensors(name, x.shape, x, b)
    B._check_consts(name, x.device, taps)
    lib = build.load()
    T = B._tiled()
    tv = taps.as_volume()
    route = route or T.vol_route(name, tv.lengths, dims)
    wts, y = torch.empty_like(x), torch.empty_like(x)
    t1 = t2 = None
    if route == "chain":
        t1, t2 = torch.empty_like(x), torch.empty_like(x)
    counts = build.new_counts(B.COUNTS)
    err = lib.nsol_irls_head(
        build.tensor_ptr(x), build.tensor_ptr(b), build.tensor_ptr(wts),
        build.tensor_ptr(y), build.tensor_ptr(t1), build.tensor_ptr(t2),
        build.tensor_ptr(tv.buf), *tv.lengths, LOSS_IDS.index(loss),
        float(scale), T.ROUTES.index(route), *dims,
        build.stream_ptr(x.device), counts)
    build.check(err, name)
    irls_head.launches += counts[1]
    B.count_marches(counts, irls_head)
    return wts, y


def check_directions(name, r, p, first, storage):
    """The direction ``p`` a masked-CG unit takes under ``storage``
    (:data:`ROBUST_STORAGE`): stored as the mode says, unless ``first``.
    Returns the dtype of the ``p'`` it writes."""
    dt = direction_dtype(storage) or torch.float32
    if not first:
        B.check_tensors(name, r.shape, p, device=r.device, dtype=dt)
    return dt


def weighted_apply(r, p, free, wts, scal, taps, inv_h2, rho, first=False,
                   reg="TK1", storage="exact"):
    """Masked CG direction and weighted SPD apply: ``p' = r + β·p``
    (``p' = r`` when ``first``), ``pf = free·p'``,
    ``q = free·(Aᵀ(wts·A pf) + ρ·BᵀB pf) + (p' − pf)`` (``free=None``: every
    voxel free, ``q = Aᵀ(wts·A p') + ρ·BᵀB p'``), then
    ``scal[PQ] = Σ p'·q`` and ``scal[A] = γ/pq`` (0 unless pq > 0).
    Returns ``(p', q)``. ``storage`` (:data:`ROBUST_STORAGE`): ``"dirs"``
    stores ``p'`` (and takes ``p``) as bfloat16, ``"io"`` also reads the
    weights as bfloat16 and rounds the core to bfloat16; ``q`` is
    float32 in every mode. On the card the C entry runs
    :func:`~.tiled.vol_route`'s route: the march (counted on
    ``weighted_apply.march_launches``) or the six passes (on
    ``weighted_apply.launches``)."""
    if r.device.type == "cpu":
        return weighted_apply_plain(r, p, free, wts, scal, taps, inv_h2, rho,
                                    first, reg, storage)
    return _weighted_apply(r, p, free, wts, scal, taps, inv_h2, rho, first,
                           reg, storage)


def _weighted_apply(r, p, free, wts, scal, taps, inv_h2, rho, first, reg,
                    storage, route=None):
    """:func:`weighted_apply` on the card by ``route``: ``None`` takes
    :func:`~.tiled.vol_route`'s, ``"chain"`` the six passes (the bit
    reference the march is held to) and ``"march"`` the march whatever the
    rule says of the shape (an error where its shared memory does not hold
    the taps)."""
    name = "weighted_apply"
    dims = B.volume_dims(name, r)
    B.check_tensors(name, r.shape, r, wts,
                    *([] if free is None else [free]))
    p_dtype = check_directions(name, r, p, first, storage)
    B._check_consts(name, r.device, taps, scal)
    lib = build.load()
    T = B._tiled()
    p_new = torch.empty(r.shape, dtype=p_dtype, device=r.device)
    q = torch.empty_like(r)
    tv = taps.as_volume()
    route = route or T.vol_route("weighted_apply", tv.lengths, dims)
    t1 = t2 = None
    if route == "chain":
        t1, t2 = torch.empty_like(r), torch.empty_like(r)
    counts = build.new_counts(B.COUNTS)
    err = lib.nsol_weighted_apply(
        build.tensor_ptr(r), None if first else build.tensor_ptr(p),
        build.tensor_ptr(p_new), build.tensor_ptr(q), build.tensor_ptr(free),
        build.tensor_ptr(wts), build.tensor_ptr(t1), build.tensor_ptr(t2),
        build.tensor_ptr(T.tiled_partials(r.device, dims)),
        build.tensor_ptr(scal), int(bool(first)), build.tensor_ptr(tv.buf),
        *tv.lengths, float(rho), B.reg_id(reg),
        ROBUST_STORAGE.index(storage), T.ROUTES.index(route),
        *B.spacing3(inv_h2), *dims, build.stream_ptr(r.device), counts)
    build.check(err, name)
    weighted_apply.launches += counts[2]
    B.count_marches(counts, weighted_apply)
    return p_new, q


def irls_step(x, xk):
    """In place: ``x = max(x + xk, 0)``; a NaN stays NaN."""
    if x.device.type == "cpu":
        return irls_step_plain(x, xk)
    name = "irls_step"
    B.check_tensors(name, x.shape, x, xk)
    lib = build.load()
    counts = build.new_counts(B.COUNTS)
    err = lib.nsol_irls_step(build.tensor_ptr(x), build.tensor_ptr(xk),
                             x.numel(), build.stream_ptr(x.device), counts)
    build.check(err, name)
    irls_step.launches += counts[3]


def blur_apply_prepadded(y_ext, taps, inv_h2, row0, z_total, u_ext=None,
                         rho=0.0):
    """``A y`` on a z-window of a sharded volume, with ``u_ext``
    ``A y + ρ·DᵀD u`` (``robust.py::make_blocked_blur_operator``,
    ``prepadded=True``): ``y_ext``, ``u_ext`` hold the ``Zl`` local planes
    and ``h = max(r_a, 1)`` halo planes on each side (``r_a`` the blur
    ``taps``' z half-width); the result is ``(Zl, Y, X)``, the Laplacian's
    zero-boundary rows only at global rows 0 and ``z_total − 1`` (``row0``
    the window's first global row). On the card it takes
    :func:`~.blocked.window_route`'s route for the blur taps: the window
    march of ``csrc/blur_march.cu`` (counted on
    ``blur_apply_prepadded.march_launches``) or the three passes (on
    ``blur_apply_prepadded.launches``); the two give the same bits."""
    return _blur_apply_prepadded(y_ext, taps, inv_h2, row0, z_total, u_ext,
                                 rho, B.window_route(taps, nin=2)
                                 == "chain")


def _blur_apply_prepadded(y_ext, taps, inv_h2, row0, z_total, u_ext, rho,
                          chain):
    """:func:`blur_apply_prepadded` on the card by the window march or,
    with ``chain``, by the three-pass chain whatever the taps (the bit
    reference the march is held to)."""
    name = "blur_apply_prepadded"
    h = blur_halo(taps)
    dims = B.prepadded_window(name, y_ext, h, row0, z_total, u_ext)
    if y_ext.device.type == "cpu":
        return blur_apply_prepadded_plain(y_ext, taps, inv_h2, row0, z_total,
                                          u_ext, rho)
    B.check_tensors(name, y_ext.shape, y_ext,
                    *([u_ext] if u_ext is not None else []))
    B._check_consts(name, y_ext.device, taps)
    lib = build.load()
    out = torch.empty(dims, device=y_ext.device)
    t1 = t2 = None
    if chain:
        t1, t2 = torch.empty_like(y_ext), torch.empty_like(y_ext)
    counts = build.new_counts(B.COUNTS)
    err = lib.nsol_blur_apply_prepadded(
        build.tensor_ptr(y_ext), build.tensor_ptr(u_ext),
        build.tensor_ptr(out), build.tensor_ptr(t1), build.tensor_ptr(t2),
        build.tensor_ptr(taps.buf), *taps.lengths, float(rho),
        *B.spacing3(inv_h2), h, int(row0), int(z_total), *dims,
        build.stream_ptr(y_ext.device), counts)
    build.check(err, name)
    blur_apply_prepadded.launches += counts[5]
    B.count_marches(counts, blur_apply_prepadded)
    return out


def weighted_apply_prepadded(v_ext, w_ext, taps, inv_h2, rho, row0,
                             z_total):
    """``Aᵀ(w ⊙ A v) + ρ·DᵀD v`` on a z-window of a sharded volume
    (``robust.py::make_blocked_weighted_normal_operator``,
    ``prepadded=True``): ``v_ext``, ``w_ext`` hold the ``Zl`` local planes
    and ``r = max(2·r_a, 1)`` halo planes on each side; ``A v`` is formed
    on the ``Zl + 2·r_a`` rows the second blur needs, ``w`` read there
    (offset ``r − r_a``), and ``Aᵀ`` and the Laplacian give the ``Zl``
    centre rows, its zero-boundary rows only at global rows 0 and
    ``z_total − 1``. Windows of bfloat16 (both) run the "io" instance:
    float32 arithmetic, the result in bfloat16. On the card it takes
    :func:`~.blocked.window_route`'s route for the weighted taps; the two
    give the same bits."""
    return _weighted_apply_prepadded(v_ext, w_ext, taps, inv_h2, rho, row0,
                                     z_total, B.window_route(taps, True)
                                     == "chain")


def _weighted_apply_prepadded(v_ext, w_ext, taps, inv_h2, rho, row0, z_total,
                              chain):
    """:func:`weighted_apply_prepadded` on the card by the weighted march
    of ``csrc/tiled.cu`` or, with ``chain``, by the three-pass chain
    whatever the taps (the bit reference the march is held to)."""
    name = "weighted_apply_prepadded"
    r = weighted_halo(taps)
    dims = B.prepadded_window(name, v_ext, r, row0, z_total, w_ext)
    if v_ext.device.type == "cpu":
        return weighted_apply_prepadded_plain(v_ext, w_ext, taps, inv_h2, rho,
                                              row0, z_total)
    io = v_ext.dtype == B.BF16
    B.check_tensors(name, v_ext.shape, v_ext, w_ext,
                    dtype=B.BF16 if io else torch.float32)
    B._check_consts(name, v_ext.device, taps)
    lib = build.load()
    out = torch.empty(dims, dtype=v_ext.dtype, device=v_ext.device)
    t1 = t2 = None
    if chain:
        t1 = torch.empty(v_ext.shape, device=v_ext.device)
        t2 = torch.empty_like(t1)
    counts = build.new_counts(B.COUNTS)
    err = lib.nsol_weighted_apply_prepadded(
        build.tensor_ptr(v_ext), build.tensor_ptr(w_ext),
        build.tensor_ptr(out), build.tensor_ptr(t1), build.tensor_ptr(t2),
        build.tensor_ptr(taps.buf), *taps.lengths, float(rho),
        *B.spacing3(inv_h2), r, int(row0), int(z_total), *dims, int(io),
        build.stream_ptr(v_ext.device), counts)
    build.check(err, name)
    weighted_apply_prepadded.launches += counts[6]
    return out


for _f in (blur_apply, irls_head, weighted_apply, irls_step,
           blur_apply_prepadded, weighted_apply_prepadded):
    _f.launches = 0
for _f in (blur_apply, irls_head, weighted_apply, blur_apply_prepadded):
    _f.march_launches = 0

#: the units of the solve, in the order of ``csrc/robust.cu``'s counts
UNITS = (blur_apply, irls_head, weighted_apply, irls_step, B.cg_update)
PLAIN = (blur_apply_plain, irls_head_plain, weighted_apply_plain,
         irls_step_plain, B.cg_update_plain)


def _head_zy(unit):
    """``unit`` (``blur_apply_zy`` or its plain version) as the sweep's
    ``irls_head``: its head form."""
    def head(x, b, taps, loss, scale):
        return unit(x, taps, (), head=(b, loss, scale))

    return head


def _sweep_units(tiled):
    """``(units, plain versions)`` of the sweep: :data:`UNITS` and
    :data:`PLAIN`, or with ``tiled`` the one-pass ``blur_apply_zy`` (its
    gradient and head forms) and ``weighted_apply_zy`` in place of
    ``blur_apply``, ``irls_head`` and ``weighted_apply``."""
    if not tiled:
        return UNITS, PLAIN
    T = B._tiled()
    return ((T.blur_apply_zy, _head_zy(T.blur_apply_zy), T.weighted_apply_zy,
             irls_step, B.cg_update),
            (T.blur_apply_zy_plain, _head_zy(T.blur_apply_zy_plain),
             T.weighted_apply_zy_plain, irls_step_plain, B.cg_update_plain))


# ------------------------------------------------- the one-launch sweep --

#: ``csrc/robust.cu``'s count slot of ``csrc/irls_persistent.cu``'s one
#: launch (``kIrlsPersistent``)
PERSISTENT_SLOT = 11


def irls_persistent(entry, args):
    """Call the C entry ``entry`` of ``csrc/irls_persistent.cu``
    (``nsol_robust_admm_solve_persistent``, the robust ADMM solve;
    ``nsol_irls_batch_persistent``, the robust Tikhonov batch) with
    ``args`` and its launch counts; its launches
    :func:`~.fused.launch_counts` reports as ``"irls_persistent"``."""
    counts = build.new_counts(B.COUNTS)
    err = getattr(build.load(), entry)(*args, counts)
    build.check(err, "irls_persistent")
    irls_persistent.launches += counts[PERSISTENT_SLOT]


irls_persistent.launches = 0


def persistent_shape(dims, blur, nconf=1, storage="exact", reg="TK1"):
    """``(blocks an SM, grid, the launch sequence's blocks a volume, threads
    a block, configurations side by side)`` of the one-launch IRLS solve
    (``nconf`` 1) or batch of ``nconf`` configurations of ``dims`` at the
    ``blur`` taps' lengths on the current card: side by side as many as
    ``csrc/persistent.cuh``'s ``kSideBySideBytes`` holds (their x and 9
    volumes of scratch each), at least 1 and at most one a block, in turns
    of equal size (``batch_width`` there)."""
    out = (build.ctypes.c_int * 5)()
    build.check(build.load().nsol_robust_persistent_shape(
        ROBUST_STORAGE.index(storage), B.reg_id(reg), *blur, int(nconf),
        *dims, out), "irls_persistent")
    return tuple(out)


def persistent_barriers(iterations, iter_max, cg_iters, record=False,
                        turns=1):
    """Grid barriers one persistent IRLS solve takes, in each of its
    ``turns`` of configurations side by side (a Tikhonov batch: one outer
    iteration): three a blur chain (each record row; each sweep's
    ``irls_head`` and gradient; each CG iteration's two weighted chains)
    and one after each ``cg_update``, the last with ``irls_step`` on its
    voxels (after ``irls_step`` alone where ``cg_iters`` is 0). Every block
    forms the one-block reduces itself, with no barrier after them; the
    last ``cg_update``'s reduce is not formed."""
    cg = int(cg_iters)
    sweep = 6 + (7 * cg if cg else 1)
    rows = int(iterations) + 1 if record else 0
    return int(turns) * (3 * rows + int(iterations) * int(iter_max) * sweep)


# ----------------------------------------------------------------- solver --

def _robust_steps(units, st, b, x0, alpha, rho, iterations, iter_max,
                  cg_iters, loss, scale, chain=True, record=None,
                  storage="exact"):
    """The solve as a sequence of unit calls — the sequence
    ``nsol_robust_admm_solve`` enqueues in C — plus, with ``chain``, the
    outer TV prox/dual updates of ``v`` and ``w``, which nothing that
    reaches ``x`` reads (the robust x-update ignores ``v − w``). With
    ``record = (record unit, C)`` also the records of ``x0`` and of every
    outer iterate; returns ``(x, reg, data)``. ``storage``: the masked
    CG's :data:`ROBUST_STORAGE` mode."""
    blur, head, wapply, step, update = units
    scal = B.new_scalars(b.device)
    x = x0.clone()
    nd = x.dim()
    grad = lambda u: torch.stack([  # noqa: E731
        G.forward_difference(u, nd - 1 - i) * st.inv_h[i] for i in range(nd)])
    if chain:
        tau = alpha / rho
        w = torch.zeros((nd,) + tuple(x.shape), dtype=x.dtype,
                        device=x.device)
    reg = data = None
    if record is not None:
        rec, rec_scale = record
        reg, data = Rec.new_records(iterations + 1, b.device)
        rec(x, b, st.blur, st.inv_h, loss, rec_scale, reg, data, 0)
    for it in range(iterations):
        for _ in range(iter_max):
            wts, y = head(x, b, st.blur, loss, scale)
            free, rk = blur(y, st.blur, st.inv_h2, x, rho, scal=scal)
            xk = torch.zeros_like(x)
            p = None
            for k in range(cg_iters):
                p, q = wapply(rk, p, free, wts, scal, st.blur, st.inv_h2,
                              rho, first=(k == 0), storage=storage)
                update(xk, rk, p, q, scal)
            step(x, xk)
        if record is not None:
            rec(x, b, st.blur, st.inv_h, loss, rec_scale, reg, data, it + 1)
        if chain:
            t = grad(x) + w
            v = vectorial_soft_threshold(t, tau)
            w = t - v
    return x, reg, data


def _robust_solve_cuda(st, b, x0, rho, iterations, iter_max, cg_iters, loss,
                       scale, record_dls=None, tiled=False, storage="exact",
                       route=None):
    """The solve on the card by ``route``: ``None`` takes
    :func:`~.tiled.irls_persistent_fits`'s (never with ``tiled``),
    ``"sequence"`` ``nsol_robust_admm_solve``'s launch sequence (the bit
    reference)."""
    name = "robust ADMM solve"
    if route not in (None, "sequence"):
        raise ValueError("route must be None or 'sequence', got %r"
                         % (route,))
    dims = B.volume_dims(name, b)
    B.check_tensors(name, b.shape, b, x0)
    tv = st.blur.as_volume()
    T = B._tiled()
    persistent = route is None and not tiled and T.irls_persistent_fits(
        dims, tv.lengths, storage)
    lib = build.load()
    x = x0.clone()
    p_dtype = direction_dtype(storage) or torch.float32
    vols = [torch.empty(b.shape, dtype=dt, device=b.device)  # wts free rk
            for dt in (torch.float32,) * 3 + (p_dtype,) * 2  # p0 p1
            + (torch.float32,) * 4]  # q xk t1 t2
    reg = data = parts = None
    if record_dls is not None:
        reg, data = Rec.new_records(iterations + 1, b.device)
        parts = Rec.rec_partials(b.device)
    # the march units' partials (weighted_apply's march on either route);
    # the persistent solve's two sets
    partials = torch.empty(2 * lib.nsol_max_blocks(), dtype=torch.float64,
                           device=b.device) if persistent \
        else T.tiled_partials(b.device, dims)
    head = [build.tensor_ptr(b), build.tensor_ptr(x)] \
        + [build.tensor_ptr(t) for t in vols] + [build.tensor_ptr(partials)]
    tail = [
        build.tensor_ptr(tv.buf), *tv.lengths, float(rho),
        *B.spacing3(st.inv_h), *B.spacing3(st.inv_h2), LOSS_IDS.index(loss),
        float(scale), int(iterations), int(iter_max), int(cg_iters),
        ROBUST_STORAGE.index(storage),
        build.tensor_ptr(reg), build.tensor_ptr(data), build.tensor_ptr(parts),
        float(1.0 if record_dls is None else record_dls), *dims,
        build.stream_ptr(b.device)]
    if persistent:
        irls_persistent("nsol_robust_admm_solve_persistent", head + tail)
        return x, reg, data
    args = head + [build.tensor_ptr(B.new_scalars(b.device))] + tail
    counts, rec_counts = build.new_counts(B.COUNTS), build.new_counts(5)
    tiled_counts = build.new_counts(5)
    if tiled:
        err = lib.nsol_robust_admm_solve_zy(*args, counts, rec_counts,
                                            tiled_counts)
    else:
        err = lib.nsol_robust_admm_solve(*args, counts, rec_counts)
    build.check(err, name)
    for f, n in zip(UNITS, counts):
        f.launches += n
    B.count_marches(counts, weighted_apply, blur_apply, irls_head)
    for f, n in zip(T.UNITS, tiled_counts):
        f.launches += n
    Rec.admm_record.launches += rec_counts[4]
    return x, reg, data


def make_robust_solver(shape, cov, alpha_cut=3, spacing=None, iterations=10,
                       iter_max=10, irls_cg_iters=8, data_loss="huber",
                       record=False):
    """Build ``solve(b, x0, alpha, rho, data_loss_scale=1.0) -> x``: robust
    ADMM TV-deconvolution, ``admm_solve(minimizer="irls")`` with bounds
    ``(0, ∞)`` sweep for sweep, with the TPU kernels' guards and without
    their entry clip of ``x0``.

    Each of the ``iterations`` outer steps runs ``iter_max`` MM sweeps:
    freeze ``wts = ρ'_C(r²)`` and the active set, ``irls_cg_iters``
    masked-CG iterations from zero, then ``x = max(x + xk, 0)``. ``alpha``
    reaches only the TV prox/dual chain, which no output reads: the
    reference's robust x-update ignores ``v − w``, so ``x`` does not depend
    on ``alpha`` (kept on purpose).

    ``record=True``: ``solve(..., record_dls=1.0)`` returns ``(x, reg,
    data)`` with the float64 ``(iterations+1,)`` L-curve records of
    :func:`~nsol_tpu_torch.ops.cuda.record.admm_record` (row 0 = ``x0``),
    the Data loss at the runtime scale ``record_dls``.

    Device and dtype follow ``b``: on CUDA the solve runs the kernels of
    ``csrc/robust.cu`` (float32, 2-D or 3-D) without the chain, as one
    cooperative launch of ``csrc/irls_persistent.cu`` where
    :func:`~.tiled.irls_persistent_fits` takes the shape (``solve.route``); on
    the CPU the plain versions with it. ``solve.plain`` runs the plain
    versions on any device; ``solve.plain(..., chain=False)`` leaves the
    chain out; on the card ``solve.sequence`` runs the launch sequence
    whatever the rule says.
    """
    return _make_solver(shape, cov, alpha_cut, spacing, iterations,
                        iter_max, irls_cg_iters, data_loss, record)


def _make_solver(shape, cov, alpha_cut, spacing, iterations, iter_max,
                 irls_cg_iters, data_loss, record, tiled=False,
                 storage="exact"):
    """:func:`make_robust_solver`; ``tiled`` (3-D only) runs the same
    sequence with the one-pass tiled units (:func:`_sweep_units`,
    ``nsol_robust_admm_solve_zy`` on CUDA); ``storage`` is the masked
    CG's :data:`ROBUST_STORAGE` mode (the fused solve's ``compact_dirs``:
    ``"dirs"``; ``blocked_robust_admm_solve``'s: ``"io"``)."""
    direction_dtype(storage)
    if data_loss not in LOSS_IDS or data_loss == "linear":
        raise ValueError("robust data loss must be one of %s, got %r"
                         % (", ".join(LOSS_IDS[1:]), data_loss))
    shape = tuple(shape)
    if len(shape) not in (2, 3):
        raise ValueError("robust ADMM solver supports 2-D/3-D volumes")
    if tiled and len(shape) != 3:
        raise ValueError("the tiled robust solve is 3-D only")
    units, plain_units = _sweep_units(tiled)
    factors = C.blur_factors(cov, alpha_cut, spacing)
    cache = {}

    def stencils(t):
        return B.stencils_for(cache, shape, factors, spacing, t)

    def rec_of(unit, record_dls):
        return (unit, record_dls) if record else None

    def result(out):
        return out if record else out[0]

    def solve(b, x0, alpha, rho, data_loss_scale=1.0, record_dls=1.0):
        st = stencils(b)
        if b.device.type == "cpu":
            return result(_robust_steps(
                units, st, b, x0, alpha, rho, iterations, iter_max,
                irls_cg_iters, data_loss, data_loss_scale,
                record=rec_of(Rec.admm_record, record_dls), storage=storage))
        return result(_robust_solve_cuda(
            st, b, x0, rho, iterations, iter_max, irls_cg_iters, data_loss,
            data_loss_scale, record_dls if record else None, tiled, storage))

    def plain(b, x0, alpha, rho, data_loss_scale=1.0, chain=True,
              record_dls=1.0):
        return result(_robust_steps(
            plain_units, stencils(b), b, x0, alpha, rho, iterations, iter_max,
            irls_cg_iters, data_loss, data_loss_scale, chain,
            rec_of(Rec.admm_record_plain, record_dls), storage))

    def sequence(b, x0, alpha, rho, data_loss_scale=1.0, record_dls=1.0):
        return result(_robust_solve_cuda(
            stencils(b), b, x0, rho, iterations, iter_max, irls_cg_iters,
            data_loss, data_loss_scale, record_dls if record else None, tiled,
            storage, "sequence"))

    solve.plain = plain
    solve.sequence = sequence
    solve.storage = storage
    # the route a solve on the card takes
    T = B._tiled()
    solve.route = "persistent" if not tiled and T.irls_persistent_fits(
        (1,) * (3 - len(shape)) + shape, T.taps_lengths(factors)[0],
        storage) else "sequence"
    return solve


# ------------------------------------------- reference-shaped entry points --

def _weighted_io(unit, io_dtype, stencils):
    """``apply(v, w, rho)`` of the weighted normal operator through the
    masked-CG ``unit`` (``free=None``, ``first``: ``p' = v``). With
    ``io_dtype`` bfloat16 (storage ``"io"``) ``v`` and ``w`` are taken as
    bfloat16 (the reference's ``jnp.asarray(v, io)``), held in float32,
    and the result is returned in bfloat16."""
    io = "exact" if io_dtype is None else "io"

    def apply(v, w, rho):
        if io == "io":
            v, w = (t.to(B.BF16).float() for t in (v, w))
        st = stencils(v)
        _, q = unit(v, None, None, w, B.new_scalars(v.device), st.blur,
                    st.inv_h2, rho, first=True, storage=io)
        return q.to(B.BF16) if io == "io" else q

    return apply


def _blocked_stencils(shape, cov, alpha_cut, spacing):
    if len(shape) != 3:
        raise ValueError("blocked robust kernels are 3-D only")
    factors = C.blur_factors(cov, alpha_cut, spacing)
    cache = {}
    return lambda t: B.stencils_for(cache, shape, factors, spacing, t)


def _window(shape, cov, alpha_cut, spacing, halo_of, z_total):
    """``(halo, stencils of the window, z_total)`` of a prepadded unit on
    the local ``shape``: ``halo_of`` (:func:`blur_halo` or
    :func:`weighted_halo`) maps the blur taps to the halo; ``z_total``
    defaults to the local extent."""
    if len(shape) != 3:
        raise ValueError("blocked robust kernels are 3-D only")
    factors = C.blur_factors(cov, alpha_cut, spacing)
    halo = halo_of(B.Taps(factors, "cpu", torch.float32))
    ext = (shape[0] + 2 * halo,) + tuple(shape[1:])
    cache = {}
    return (halo,
            lambda t: B.stencils_for(cache, ext, factors, spacing, t),
            shape[0] if z_total is None else int(z_total))


def make_blocked_blur_operator(shape, cov, alpha_cut=3, spacing=None,
                               with_lap=False, prepadded=False, z_total=None,
                               vma=None, **tpu_options):
    """Build ``apply(y) -> A y``, or with ``with_lap=True``
    ``apply(y, u, rho) -> A y + rho·DᵀD u`` — the IRLS gradient
    ``Aᵀ(w·r) + ρ·DᵀD x`` for ``y = w·r``, ``u = x`` (``A = Aᵀ``)
    (``nsol_tpu/ops/pallas/robust.py:161``). Device and dtype follow
    ``y``; ``interpret=True`` runs the plain version.

    ``prepadded=True``: the per-shard form of the sharded path, through
    :func:`blur_apply_prepadded` — ``apply(y_ext)``, or with ``with_lap``
    ``apply(y_ext, u_ext, rho, row0)``, on ``(Zl + 2·apply.halo, Y, X)``
    windows of a volume of ``z_total`` rows (default ``Zl``), ``shape``
    the local ``(Zl, Y, X)`` and ``apply.halo = max(r_a, 1)``; ``vma``
    (JAX's varying-axes type) is accepted and ignored."""
    interpret, _ = B.check_options(tpu_options)
    if prepadded:
        unit = blur_apply_prepadded_plain if interpret \
            else blur_apply_prepadded
        halo, stencils, z_total = _window(
            tuple(shape), cov, alpha_cut, spacing,
            blur_halo, z_total)

        def apply_lap_ext(y_ext, u_ext, rho, row0):
            st = stencils(y_ext)
            return unit(y_ext, st.blur, st.inv_h2, row0, z_total, u_ext, rho)

        def apply_ext(y_ext):
            st = stencils(y_ext)
            return unit(y_ext, st.blur, st.inv_h2, 0, z_total)

        apply = apply_lap_ext if with_lap else apply_ext
        apply.halo, apply.block = halo, shape[0]
        return apply
    unit = blur_apply_plain if interpret else blur_apply
    stencils = _blocked_stencils(shape, cov, alpha_cut, spacing)

    def apply_lap(y, u, rho):
        st = stencils(y)
        return unit(y, st.blur, st.inv_h2, u, rho)

    def apply(y):
        st = stencils(y)
        return unit(y, st.blur, st.inv_h2)

    return apply_lap if with_lap else apply


def make_blocked_weighted_normal_operator(shape, cov, alpha_cut=3,
                                          spacing=None, prepadded=False,
                                          z_total=None, vma=None,
                                          **tpu_options):
    """Build ``apply(v, w, rho) -> Aᵀ(w ⊙ (A v)) + rho·DᵀD v``, the SPD
    apply of every IRLS inner-CG iteration
    (``nsol_tpu/ops/pallas/robust.py:264``). Device and dtype follow
    ``v``; ``interpret=True`` runs the plain version.
    ``io_dtype=bfloat16`` (``robust.py:292-300``): ``v`` and ``w`` are
    taken as bfloat16, the sums run in float32, and the result is rounded
    to and returned in bfloat16 (the unit's ``"io"`` storage).

    ``prepadded=True``: the per-shard form of the sharded path, through
    :func:`weighted_apply_prepadded` — ``apply(v_ext, w_ext, rho, row0)``
    on ``(Zl + 2·apply.halo, Y, X)`` windows of a volume of ``z_total``
    rows (default ``Zl``), ``shape`` the local ``(Zl, Y, X)`` and
    ``apply.halo = max(2·r_a, 1)``; ``vma`` is accepted and ignored. With
    ``io_dtype=bfloat16`` the windows are taken as bfloat16 and the result
    is returned in bfloat16, as without ``prepadded``."""
    interpret, opt = B.check_options(tpu_options, ported=("io_dtype",))
    if prepadded:
        unit = weighted_apply_prepadded_plain if interpret \
            else weighted_apply_prepadded
        halo, stencils, z_total = _window(
            tuple(shape), cov, alpha_cut, spacing,
            weighted_halo, z_total)
        io = opt.get("io_dtype")

        def apply_ext(v_ext, w_ext, rho, row0):
            st = stencils(v_ext)
            if io is not None:
                v_ext, w_ext = v_ext.to(io), w_ext.to(io)
            return unit(v_ext, w_ext, st.blur, st.inv_h2, rho, row0, z_total)

        apply_ext.halo, apply_ext.block = halo, shape[0]
        return apply_ext
    unit = weighted_apply_plain if interpret else weighted_apply
    return _weighted_io(unit, opt.get("io_dtype"),
                        _blocked_stencils(shape, cov, alpha_cut, spacing))


def make_blocked_blur_operator_2d(shape, cov, alpha_cut=3, spacing=None,
                                  z_block=None, y_block=None, with_lap=False,
                                  **tpu_options):
    """Build ``apply(y) -> A y``, or with ``with_lap=True``
    ``apply(y, u, rho) -> A y + rho·DᵀD u``, through the one-pass tiled
    kernel ``blur_apply_zy`` (``nsol_tpu/ops/pallas/robust.py:734``).
    ``z_block``/``y_block`` are checked as the JAX package checks them and
    do not shape the CUDA tiles; a blur too wide for the kernel's shared
    memory raises ``ValueError``. Device and dtype follow ``y``;
    ``interpret=True`` runs the plain version."""
    interpret, _ = B.check_options(tpu_options)
    shape = tuple(shape)
    factors, halo, halo_y = B.zy_halos(shape, cov, alpha_cut, spacing)
    # the blur band is half the normal band
    B.resolve_zy_blocks(shape, max(halo // 2, 1), halo_y // 2, z_block,
                        y_block, "blur operator")
    T = B._tiled()
    T.require_fit("blur_apply_zy", [len(f) for f in factors],
                  nin=1 + with_lap, lap=with_lap)
    unit = T.blur_apply_zy_plain if interpret else T.blur_apply_zy
    cache = {}

    def apply_lap(y, u, rho):
        st = B.stencils_for(cache, shape, factors, spacing, y)
        return unit(y, st.blur, st.inv_h2, u, rho)

    def apply(y):
        st = B.stencils_for(cache, shape, factors, spacing, y)
        return unit(y, st.blur, st.inv_h2)

    return apply_lap if with_lap else apply


def make_blocked_weighted_normal_operator_2d(shape, cov, alpha_cut=3,
                                             spacing=None, z_block=None,
                                             y_block=None, **tpu_options):
    """Build ``apply(v, w, rho) -> Aᵀ(w ⊙ (A v)) + rho·DᵀD v`` through the
    one-pass tiled kernel ``weighted_apply_zy``
    (``nsol_tpu/ops/pallas/robust.py:564``); ``z_block``/``y_block`` only
    validate, and a blur too wide for the kernel's shared memory raises
    ``ValueError``. Device and dtype follow ``v``; ``interpret=True`` runs
    the plain version. ``io_dtype=bfloat16`` (``robust.py:584-593``):
    ``v``, ``w`` taken and the result returned in bfloat16, as
    :func:`make_blocked_weighted_normal_operator` takes them."""
    interpret, opt = B.check_options(tpu_options, ported=("io_dtype",))
    shape = tuple(shape)
    factors, halo, halo_y = B.zy_halos(shape, cov, alpha_cut, spacing)
    B.resolve_zy_blocks(shape, halo, halo_y, z_block, y_block,
                        "weighted normal operator")
    T = B._tiled()
    T.require_fit("weighted_apply_zy", [len(f) for f in factors],
                  weighted=True)
    unit = T.weighted_apply_zy_plain if interpret else T.weighted_apply_zy
    cache = {}
    return _weighted_io(
        unit, opt.get("io_dtype"),
        lambda v: B.stencils_for(cache, shape, factors, spacing, v))


def blocked_robust_admm_solve(shape, cov, alpha_cut=3, spacing=None,
                              iterations=10, iter_max=10, irls_cg_iters=8,
                              data_loss="huber", **tpu_options):
    """Build ``solve(b, x0, alpha, rho, data_loss_scale=1.0) -> x``: robust
    ADMM TV-deconvolution of a 3-D volume
    (``nsol_tpu/ops/pallas/robust.py:406``), the solve of
    :func:`make_robust_solver`. Where the JAX package takes its (z, y)-
    blocked kernels (``Y ≥ 512``, :432-491: :func:`~.blocked.
    pick_zy_blocks` finds a layout for the weighted apply) and the blur
    fits the tiled kernels' shared memory
    (:func:`~.tiled.route_fits`), the sweep runs the one-pass tiled units
    of :mod:`.tiled`; elsewhere the per-axis units. ``solve.tiled`` says
    which. ``interpret=True`` runs the plain versions.

    ``compact_dirs=True`` (:469-548): the inner CG's direction is stored
    in bfloat16 and the weighted apply reads a bfloat16 copy of the
    weights and rounds its output to bfloat16 (the :data:`ROBUST_STORAGE`
    mode ``"io"``, ``solve.storage``); the residual, the gradient (with
    the float32 weights), ``r``, ``x`` and every sum stay float32."""
    interpret, opt = B.check_options(tpu_options, ported=("compact_dirs",))
    compact = opt.get("compact_dirs", False)
    if compact not in (False, True):
        raise ValueError("the robust solve's compact_dirs is True or False, "
                         "got %r" % (compact,))
    shape = tuple(shape)
    if len(shape) != 3:
        raise ValueError("blocked robust kernels are 3-D only")
    tiled = B.takes_zy_route(shape, cov, alpha_cut, spacing, route="robust")
    solve = _make_solver(shape, cov, alpha_cut, spacing, iterations,
                         iter_max, irls_cg_iters, data_loss, False, tiled,
                         "io" if compact else "exact")
    storage = solve.storage
    if interpret:
        solve = B.plain_only(solve)
    solve.tiled, solve.storage = tiled, storage
    return solve
