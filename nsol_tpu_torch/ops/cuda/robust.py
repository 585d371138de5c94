"""Robust (IRLS) deconvolution kernels: counterparts of
``nsol_tpu/ops/pallas/robust.py`` and of the robust branch of
``nsol_tpu/ops/pallas/fused.py::make_fused_admm_solver``.

Four kernel units (CUDA C++ in ``csrc/robust.cu``), each with its plain
PyTorch version beside it and a launch counter on its wrapper:

* :func:`blur_apply` — ``A y``, with ``u`` ``+ ρ·DᵀD u``; replaces
  ``robust.py::make_blocked_blur_operator`` (:161). With ``scal`` it is
  the gradient that opens an IRLS sweep: ``g = A y + ρ·DᵀD x`` for
  ``y = wts·r``, the active set ``free`` (0 where ``x ≤ 0`` and ``g > 0``,
  else 1, a float field), ``rk = −free·g``, ``γ = ‖rk‖²`` and ``β = 0``.
* :func:`irls_head` — ``r = A x − b``, ``wts = ρ'_C(r²)``, ``y = wts·r``:
  the weights one sweep freezes (``fused.py:587-588``,
  ``robust.py:508-509``).
* :func:`weighted_apply` — ``p' = r + β·p``, ``pf = free·p'``,
  ``q = free·(Aᵀ(wts·A pf) + ρ·DᵀD pf) + (p' − pf)``, ``pq = Σ p'·q``,
  ``a = γ/pq`` (guarded); replaces
  ``robust.py::make_blocked_weighted_normal_operator`` (:264) and the
  in-kernel ``apply_W`` of ``fused.py`` (:593-597).
* :func:`irls_step` — ``x = max(x + xk, 0)`` (``fused.py:622``).

The masked CG between applies is ``blocked.cg_update``. The TPU kernel
splits into a VMEM-resident whole solve (``fused.py``) and a streaming one
(``robust.py::blocked_robust_admm_solve``) only because of VMEM; here both
entry points run one launch sequence that ``nsol_robust_admm_solve``
enqueues in C. Bytes bound every unit; see the note at the top of
``csrc/robust.cu``.

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
from nsol_tpu_torch.ops.prox import vectorial_soft_threshold
from nsol_tpu_torch.solvers.cg import guarded_ratio

__all__ = ["LOSS_IDS", "blur_apply", "blur_apply_plain", "irls_head",
           "irls_head_plain", "weighted_apply", "weighted_apply_plain",
           "irls_step", "irls_step_plain", "make_robust_solver",
           "make_blocked_blur_operator",
           "make_blocked_weighted_normal_operator",
           "blocked_robust_admm_solve"]

#: data losses by the index ``csrc/robust.cu`` takes (its ``Loss`` enum)
LOSS_IDS = tuple(losses.LOSSES)


# ------------------------------------------------------------ plain forms --

def blur_apply_plain(y, taps, inv_h2, u=None, rho=0.0, scal=None):
    """Plain version of :func:`blur_apply`."""
    blur_apply_plain.calls += 1
    g = B._blur_plain(y, taps)
    if u is not None:
        g = g + rho * B._laplacian(u, inv_h2)
    if scal is None:
        return g
    free = (~((u <= 0.0) & (g > 0.0))).to(g.dtype)
    rk = -free * g
    scal[B.GAMMA] = torch.sum(rk * rk)
    scal[B.BETA] = 0.0
    return free, rk


def irls_head_plain(x, b, taps, loss, scale):
    """Plain version of :func:`irls_head`. ``scale`` enters as a tensor of
    the working dtype, so ``r²/C²`` is a division in that dtype, as in
    the kernel and the reference."""
    irls_head_plain.calls += 1
    r = B._blur_plain(x, taps) - b
    c = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    wts = losses.gradient_loss(loss)(r * r, f_scale=c)
    return wts, wts * r


def weighted_apply_plain(r, p, free, wts, scal, taps, inv_h2, rho,
                         first=False):
    """Plain version of :func:`weighted_apply`."""
    weighted_apply_plain.calls += 1
    p_new = r.clone() if first else r + scal[B.BETA].to(r.dtype) * p
    pf = p_new if free is None else free * p_new
    core = B._blur_plain(wts * B._blur_plain(pf, taps), taps) \
        + rho * B._laplacian(pf, inv_h2)
    q = core if free is None else free * core + (p_new - pf)
    pq = torch.sum(p_new * q).to(scal.dtype)
    scal[B.PQ] = pq
    scal[B.A] = guarded_ratio(scal[B.GAMMA], pq)
    return p_new, q


def irls_step_plain(x, xk):
    """Plain version of :func:`irls_step` (updates ``x`` in place)."""
    irls_step_plain.calls += 1
    x.copy_(torch.clamp(x + xk, min=0.0))


for _f in (blur_apply_plain, irls_head_plain, weighted_apply_plain,
           irls_step_plain):
    _f.calls = 0


# ---------------------------------------------------------------- kernels --

def _dims(name, v):
    """``(Z, Y, X)`` of a 3-D volume, ``(1, Y, X)`` of a 2-D image."""
    if v.dim() not in (2, 3):
        raise ValueError("%s: the CUDA kernel takes a 2-D image or a 3-D "
                         "volume, got shape %s" % (name, tuple(v.shape)))
    return (1,) * (3 - v.dim()) + tuple(v.shape)


def _inv_h2_3(inv_h2):
    """``1/h²`` in (x, y, z) order, ``1/h_z² = 0`` for a 2-D image."""
    return tuple(float(h) for h in inv_h2) + (0.0,) * (3 - len(inv_h2))


def _partials(device):
    return torch.empty(build.load().nsol_max_blocks(), dtype=torch.float64,
                       device=device)


def blur_apply(y, taps, inv_h2, u=None, rho=0.0, scal=None):
    """``A y`` (``taps``: the blur :class:`~blocked.Taps`); with ``u``,
    ``A y + ρ·DᵀD u``. With ``scal`` (``u`` is then the IRLS iterate
    ``x``): the gradient form, returning ``(free, rk)`` with
    ``free = 0`` where ``x ≤ 0`` and ``g > 0`` (else 1) and
    ``rk = −free·g``, and setting ``scal[GAMMA] = ‖rk‖²``,
    ``scal[BETA] = 0``."""
    if y.device.type == "cpu":
        return blur_apply_plain(y, taps, inv_h2, u, rho, scal)
    name = "blur_apply"
    dims = _dims(name, y)
    B.check_tensors(name, y.shape, y, *([u] if u is not None else []))
    B._check_consts(name, y.device, taps, scal)
    if scal is not None and u is None:
        raise ValueError("%s: the gradient form needs u = x" % name)
    lib = build.load()
    t1, t2 = torch.empty_like(y), torch.empty_like(y)
    out = free = rk = partials = None
    if scal is None:
        out = torch.empty_like(y)
    else:
        free, rk = torch.empty_like(y), torch.empty_like(y)
        partials = _partials(y.device)
    tv = taps.as_volume()
    counts = build.new_counts(5)
    err = lib.nsol_blur_apply(
        build.tensor_ptr(y), build.tensor_ptr(u), build.tensor_ptr(out),
        build.tensor_ptr(free), build.tensor_ptr(rk), build.tensor_ptr(t1),
        build.tensor_ptr(t2), build.tensor_ptr(partials),
        build.tensor_ptr(scal), build.tensor_ptr(tv.buf), *tv.lengths,
        float(rho), *_inv_h2_3(inv_h2), *dims, build.stream_ptr(y.device),
        counts)
    build.check(err, name)
    blur_apply.launches += counts[0]
    return out if scal is None else (free, rk)


def irls_head(x, b, taps, loss, scale):
    """IRLS weights of one sweep: ``r = A x − b``, returns
    ``(wts, y)`` with ``wts = ρ'_C(r²)`` for the named ``loss`` at
    ``C = scale`` and ``y = wts·r``."""
    if loss not in LOSS_IDS:
        raise ValueError("unknown data loss %r" % (loss,))
    if x.device.type == "cpu":
        return irls_head_plain(x, b, taps, loss, scale)
    name = "irls_head"
    dims = _dims(name, x)
    B.check_tensors(name, x.shape, x, b)
    B._check_consts(name, x.device, taps)
    lib = build.load()
    wts, y, t1, t2 = (torch.empty_like(x) for _ in range(4))
    tv = taps.as_volume()
    counts = build.new_counts(5)
    err = lib.nsol_irls_head(
        build.tensor_ptr(x), build.tensor_ptr(b), build.tensor_ptr(wts),
        build.tensor_ptr(y), build.tensor_ptr(t1), build.tensor_ptr(t2),
        build.tensor_ptr(tv.buf), *tv.lengths, LOSS_IDS.index(loss),
        float(scale), *dims, build.stream_ptr(x.device), counts)
    build.check(err, name)
    irls_head.launches += counts[1]
    return wts, y


def weighted_apply(r, p, free, wts, scal, taps, inv_h2, rho, first=False):
    """Masked CG direction and weighted SPD apply: ``p' = r + β·p``
    (``p' = r`` when ``first``), ``pf = free·p'``,
    ``q = free·(Aᵀ(wts·A pf) + ρ·DᵀD pf) + (p' − pf)`` (``free=None``: every
    voxel free, ``q = Aᵀ(wts·A p') + ρ·DᵀD p'``), then
    ``scal[PQ] = Σ p'·q`` and ``scal[A] = γ/pq`` (0 unless pq > 0).
    Returns ``(p', q)``."""
    if r.device.type == "cpu":
        return weighted_apply_plain(r, p, free, wts, scal, taps, inv_h2, rho,
                                    first)
    name = "weighted_apply"
    dims = _dims(name, r)
    B.check_tensors(name, r.shape, r, wts, *([] if first else [p]),
                    *([] if free is None else [free]))
    B._check_consts(name, r.device, taps, scal)
    lib = build.load()
    p_new, q, t1, t2 = (torch.empty_like(r) for _ in range(4))
    tv = taps.as_volume()
    counts = build.new_counts(5)
    err = lib.nsol_weighted_apply(
        build.tensor_ptr(r), None if first else build.tensor_ptr(p),
        build.tensor_ptr(p_new), build.tensor_ptr(q), build.tensor_ptr(free),
        build.tensor_ptr(wts), build.tensor_ptr(t1), build.tensor_ptr(t2),
        build.tensor_ptr(_partials(r.device)), build.tensor_ptr(scal),
        int(bool(first)), build.tensor_ptr(tv.buf), *tv.lengths, float(rho),
        *_inv_h2_3(inv_h2), *dims, build.stream_ptr(r.device), counts)
    build.check(err, name)
    weighted_apply.launches += counts[2]
    return p_new, q


def irls_step(x, xk):
    """In place: ``x = max(x + xk, 0)``."""
    if x.device.type == "cpu":
        return irls_step_plain(x, xk)
    name = "irls_step"
    B.check_tensors(name, x.shape, x, xk)
    lib = build.load()
    counts = build.new_counts(5)
    err = lib.nsol_irls_step(build.tensor_ptr(x), build.tensor_ptr(xk),
                             x.numel(), build.stream_ptr(x.device), counts)
    build.check(err, name)
    irls_step.launches += counts[3]


for _f in (blur_apply, irls_head, weighted_apply, irls_step):
    _f.launches = 0

#: the units of the solve, in the order of ``csrc/robust.cu``'s counts
UNITS = (blur_apply, irls_head, weighted_apply, irls_step, B.cg_update)
PLAIN = (blur_apply_plain, irls_head_plain, weighted_apply_plain,
         irls_step_plain, B.cg_update_plain)


# ----------------------------------------------------------------- solver --

def _robust_steps(units, st, b, x0, alpha, rho, iterations, iter_max,
                  cg_iters, loss, scale, chain=True):
    """The solve as a sequence of unit calls — the sequence
    ``nsol_robust_admm_solve`` enqueues in C — plus, with ``chain``, the
    outer TV prox/dual updates of ``v`` and ``w``, which nothing that
    reaches ``x`` reads (the robust x-update ignores ``v − w``)."""
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
    for _ in range(iterations):
        for _ in range(iter_max):
            wts, y = head(x, b, st.blur, loss, scale)
            free, rk = blur(y, st.blur, st.inv_h2, x, rho, scal=scal)
            xk = torch.zeros_like(x)
            p = None
            for k in range(cg_iters):
                p, q = wapply(rk, p, free, wts, scal, st.blur, st.inv_h2,
                              rho, first=(k == 0))
                update(xk, rk, p, q, scal)
            step(x, xk)
        if chain:
            t = grad(x) + w
            v = vectorial_soft_threshold(t, tau)
            w = t - v
    return x


def _robust_solve_cuda(st, b, x0, rho, iterations, iter_max, cg_iters, loss,
                       scale):
    name = "robust ADMM solve"
    dims = _dims(name, b)
    B.check_tensors(name, b.shape, b, x0)
    lib = build.load()
    x = x0.clone()
    vols = [torch.empty_like(b) for _ in range(9)]  # wts free rk p0 p1 q xk t1 t2
    scal = B.new_scalars(b.device)
    tv = st.blur.as_volume()
    counts = build.new_counts(5)
    err = lib.nsol_robust_admm_solve(
        build.tensor_ptr(b), build.tensor_ptr(x),
        *[build.tensor_ptr(t) for t in vols],
        build.tensor_ptr(_partials(b.device)), build.tensor_ptr(scal),
        build.tensor_ptr(tv.buf), *tv.lengths, float(rho),
        *_inv_h2_3(st.inv_h2), LOSS_IDS.index(loss), float(scale),
        int(iterations), int(iter_max), int(cg_iters), *dims,
        build.stream_ptr(b.device), counts)
    build.check(err, name)
    for f, n in zip(UNITS, counts):
        f.launches += n
    return x


def make_robust_solver(shape, cov, alpha_cut=3, spacing=None, iterations=10,
                       iter_max=10, irls_cg_iters=8, data_loss="huber"):
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

    Device and dtype follow ``b``: on CUDA the solve runs the kernels of
    ``csrc/robust.cu`` (float32, 2-D or 3-D) without the chain; on the CPU
    the plain versions with it. ``solve.plain`` runs the plain versions on
    any device; ``solve.plain(..., chain=False)`` leaves the chain out.
    """
    if data_loss not in LOSS_IDS or data_loss == "linear":
        raise ValueError("robust data loss must be one of %s, got %r"
                         % (", ".join(LOSS_IDS[1:]), data_loss))
    shape = tuple(shape)
    if len(shape) not in (2, 3):
        raise ValueError("robust ADMM solver supports 2-D/3-D volumes")
    factors = C.blur_factors(cov, alpha_cut, spacing)
    cache = {}

    def stencils(t):
        return B.stencils_for(cache, shape, factors, spacing, t)

    def solve(b, x0, alpha, rho, data_loss_scale=1.0):
        st = stencils(b)
        if b.device.type == "cpu":
            return _robust_steps(UNITS, st, b, x0, alpha, rho, iterations,
                                 iter_max, irls_cg_iters, data_loss,
                                 data_loss_scale)
        return _robust_solve_cuda(st, b, x0, rho, iterations, iter_max,
                                  irls_cg_iters, data_loss, data_loss_scale)

    def plain(b, x0, alpha, rho, data_loss_scale=1.0, chain=True):
        return _robust_steps(PLAIN, stencils(b), b, x0, alpha, rho,
                             iterations, iter_max, irls_cg_iters, data_loss,
                             data_loss_scale, chain)

    solve.plain = plain
    return solve


# ------------------------------------------- reference-shaped entry points --

_TPU_ONLY = ("precision", "compact_dirs", "io_dtype", "block")


def _check_options(tpu_options, prepadded=False):
    for key in tpu_options:
        if key not in _TPU_ONLY:
            raise TypeError("unexpected argument %r" % key)
        raise ValueError("%s shapes the TPU kernel's blocks or precision and "
                         "has no counterpart in the port (exact f32 only)"
                         % key)
    if prepadded:
        raise NotImplementedError("prepadded=True (the sharded per-shard "
                                  "form) is not ported yet (ROADMAP Queue 1 "
                                  "item 12)")


def _blocked_stencils(shape, cov, alpha_cut, spacing):
    if len(shape) != 3:
        raise ValueError("blocked robust kernels are 3-D only")
    factors = C.blur_factors(cov, alpha_cut, spacing)
    cache = {}
    return lambda t: B.stencils_for(cache, shape, factors, spacing, t)


def make_blocked_blur_operator(shape, cov, alpha_cut=3, spacing=None,
                               with_lap=False, prepadded=False,
                               **tpu_options):
    """Build ``apply(y) -> A y``, or with ``with_lap=True``
    ``apply(y, u, rho) -> A y + rho·DᵀD u`` — the IRLS gradient
    ``Aᵀ(w·r) + ρ·DᵀD x`` for ``y = w·r``, ``u = x`` (``A = Aᵀ``)
    (``nsol_tpu/ops/pallas/robust.py:161``). Device and dtype follow
    ``y``."""
    _check_options(tpu_options, prepadded)
    stencils = _blocked_stencils(shape, cov, alpha_cut, spacing)

    def apply_lap(y, u, rho):
        st = stencils(y)
        return blur_apply(y, st.blur, st.inv_h2, u, rho)

    def apply(y):
        st = stencils(y)
        return blur_apply(y, st.blur, st.inv_h2)

    return apply_lap if with_lap else apply


def make_blocked_weighted_normal_operator(shape, cov, alpha_cut=3,
                                          spacing=None, prepadded=False,
                                          **tpu_options):
    """Build ``apply(v, w, rho) -> Aᵀ(w ⊙ (A v)) + rho·DᵀD v``, the SPD
    apply of every IRLS inner-CG iteration
    (``nsol_tpu/ops/pallas/robust.py:264``). Device and dtype follow
    ``v``."""
    _check_options(tpu_options, prepadded)
    stencils = _blocked_stencils(shape, cov, alpha_cut, spacing)

    def apply(v, w, rho):
        st = stencils(v)
        _, q = weighted_apply(v, None, None, w, B.new_scalars(v.device),
                              st.blur, st.inv_h2, rho, first=True)
        return q

    return apply


def blocked_robust_admm_solve(shape, cov, alpha_cut=3, spacing=None,
                              iterations=10, iter_max=10, irls_cg_iters=8,
                              data_loss="huber", **tpu_options):
    """Build ``solve(b, x0, alpha, rho, data_loss_scale=1.0) -> x``: robust
    ADMM TV-deconvolution of a 3-D volume
    (``nsol_tpu/ops/pallas/robust.py:406``), the solve of
    :func:`make_robust_solver`."""
    _check_options(tpu_options)
    if len(shape) != 3:
        raise ValueError("blocked robust kernels are 3-D only")
    return make_robust_solver(shape, cov, alpha_cut, spacing, iterations,
                              iter_max, irls_cg_iters, data_loss)
