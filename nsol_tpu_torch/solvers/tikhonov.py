"""Tikhonov-regularized (robust) least squares: the quadratic engine
(counterpart of ``nsol_tpu/solvers/tikhonov.py``, the ``"cg"``, ``"lsmr"``
and ``"irls"`` branches and ``prox_linear_least_squares``).

``minimizer="cg"`` runs CG directly on the normal equations
``(AᵀA + α BᵀB) x = Aᵀb + α Bᵀ b_reg``. ``minimizer="lsmr"`` runs CGLS on
the augmented system ``[A; √α·B] x = [b; √α·b_reg]`` for exactly
``iter_max`` iterations, then clips to the bounds (tikhonov.py:154-167;
the reference's lsmr with atol = btol = 0 is fixed-trip too).
``minimizer="irls"`` minimizes the robust cost ``½Σρ_C((Ax−b)²) +
α·½‖Bx‖²`` by reweighted least squares in projected-Newton form
(tikhonov.py:193-252), ``b_reg`` ignored as the reference's robust path
ignores it. The reference's other engines ("lsq_linear", "least_squares",
L-BFGS) raise ``NotImplementedError`` (ROADMAP Queue 1: remaining inner
engines and extras).
"""

import numpy as np
import torch

from nsol_tpu_torch.defaults import ROADMAP_ENGINES, not_ported
from nsol_tpu_torch.ops import losses
from nsol_tpu_torch.solvers.cg import cg, cgls

__all__ = ["tikhonov_solve", "prox_linear_least_squares",
           "resolve_minimizer"]


def resolve_minimizer(minimizer, data_loss="linear", cov=None,
                      alpha_cut=3, spacing=None, separable=None):
    """Resolve ``minimizer="auto"`` as the reference does: linear loss with a
    separable blur → ``"cg"``, robust + separable → ``"irls"``, otherwise
    the reference's ``"lsmr"`` / ``"L-BFGS-B"``. Explicit names pass
    through untouched."""
    if minimizer != "auto":
        return minimizer
    if separable is None:
        separable = False
        if cov is not None:
            from nsol_tpu_torch.ops.conv import separable_factors
            from nsol_tpu_torch.ops.kernels import gaussian_kernel

            kernel64 = gaussian_kernel(cov, alpha_cut=alpha_cut,
                                       spacing=spacing, dtype=np.float64)
            separable = separable_factors(kernel64) is not None
    if data_loss == "linear":
        return "cg" if separable else "lsmr"
    return "irls" if separable else "L-BFGS-B"


def _clip_bounds(x, bounds):
    if bounds is None:
        return x
    return torch.clamp(x, min=bounds[0], max=bounds[1])


def tikhonov_solve(A, A_adj, B, B_adj, b, b_reg, x0, alpha,
                   data_loss="linear", data_loss_scale=1.0, minimizer="cg",
                   iter_max=10, bounds=(0.0, np.inf), normal_A=None,
                   normal_B=None, At_b=None, irls_cg_iters=8, normal_M=None,
                   normal_W=None, grad_W=None, reduce=None):
    """Return the minimizer estimate of ``½Σρ((Ax−b)²) + α/2 ‖Bx−b_reg‖²``.

    ``normal_A``/``normal_B`` are fused normal operators (default: adjoint ∘
    forward); ``normal_M(v, alpha)`` replaces the whole SPD apply of
    ``"cg"``; ``At_b`` a precomputed ``Aᵀb``. ``x0`` is clipped to
    ``bounds`` on entry and the result on exit (tikhonov.py:130,152).

    ``minimizer="irls"``: ``iter_max`` MM sweeps, each freezing the weights
    ``w = ρ'_C(r²)`` (``C = data_loss_scale``) and the active box
    constraints, then ``irls_cg_iters`` CG iterations from zero on the
    free variables of ``(AᵀWA + αBᵀB) v = −∇cost`` and the projection of
    ``x + v`` onto the box. ``normal_W(vf, wts, alpha)`` replaces the
    weighted apply ``Aᵀ(wts·A vf) + α·BᵀB vf``, ``grad_W(x, wts_r, alpha)``
    the gradient ``Aᵀ(wts_r) + α·BᵀB x``.

    ``reduce`` sums the CG dots over the ranks of a sharded volume (the
    reference's ``axis_name``, ``nsol_tpu/solvers/tikhonov.py:151,248``).
    """
    if minimizer in ("lsmr", "lsq_linear", "cg") and data_loss != "linear":
        raise ValueError("%s minimizer cannot be used with non-linear data "
                         "loss" % minimizer)
    if minimizer not in ("cg", "lsmr", "irls"):
        raise not_ported("minimizer=%r" % (minimizer,), ROADMAP_ENGINES)
    x0 = _clip_bounds(x0, bounds)
    alpha_t = torch.as_tensor(alpha, dtype=x0.dtype, device=x0.device)
    nB = normal_B if normal_B is not None else (lambda v: B_adj(B(v)))
    if minimizer == "irls":
        return _irls(A, A_adj, nB, b, x0, alpha_t, data_loss,
                     data_loss_scale, iter_max, bounds, irls_cg_iters,
                     normal_W, grad_W, reduce)
    b_reg = torch.broadcast_to(
        torch.as_tensor(b_reg, dtype=x0.dtype, device=x0.device),
        B(x0).shape)
    if minimizer == "lsmr":
        # augmented CGLS; α = 0 leaves plain CGLS on A (the reg rows vanish)
        sqrt_alpha = torch.sqrt(alpha_t)

        def apply_aug(x):
            return A(x), sqrt_alpha * B(x)

        def apply_aug_adj(y):
            return A_adj(y[0]) + sqrt_alpha * B_adj(y[1])

        x = cgls(apply_aug, apply_aug_adj, (b, sqrt_alpha * b_reg), x0,
                 iters=iter_max, reduce=reduce)
        return _clip_bounds(x, bounds)
    if normal_M is not None:
        def apply_M(v):
            return normal_M(v, alpha_t)
    else:
        nA = normal_A if normal_A is not None else (lambda v: A_adj(A(v)))

        def apply_M(v):
            return nA(v) + alpha_t * nB(v)

    rhs = (At_b if At_b is not None else A_adj(b)) + alpha_t * B_adj(b_reg)
    x = cg(apply_M, rhs, x0, iters=iter_max, reduce=reduce)
    return _clip_bounds(x, bounds)


def _irls(A, A_adj, nB, b, x, alpha_t, data_loss, data_loss_scale, sweeps,
          bounds, cg_iters, normal_W, grad_W, reduce=None):
    """The ``"irls"`` engine (tikhonov.py:193-252) from the clipped ``x``."""
    grad_rho = losses.gradient_loss(data_loss)
    for _ in range(sweeps):
        r = A(x) - b
        wts = grad_rho(r * r, f_scale=data_loss_scale)
        # ∇cost = Aᵀ(ρ'(r²)·r) + α BᵀBx: the majorizer's gradient at x
        if grad_W is not None:
            g = grad_W(x, wts * r, alpha_t)
        else:
            g = A_adj(wts * r) + alpha_t * nB(x)
        if bounds is None:
            free = torch.ones_like(x)
        else:
            active = ((x <= bounds[0]) & (g > 0)) | ((x >= bounds[1])
                                                      & (g < 0))
            free = (~active).to(x.dtype)

        def apply_M(v, free=free, wts=wts):
            vf = free * v
            if normal_W is not None:
                core = normal_W(vf, wts, alpha_t)
            else:
                core = A_adj(wts * A(vf)) + alpha_t * nB(vf)
            return free * core + (v - vf)

        v = cg(apply_M, -free * g, torch.zeros_like(x), iters=cg_iters,
               reduce=reduce)
        x = _clip_bounds(x + v, bounds)
    return x


def prox_linear_least_squares(x, tau, A, A_adj, b, x0, iter_max=10,
                              data_loss="linear", data_loss_scale=1.0,
                              minimizer="lsmr", bounds=(0.0, np.inf),
                              normal_A=None, reduce=None, **hooks):
    """Approximate prox of ``f(x) = ½‖Ax−b‖²`` at step ``tau``: the inner
    Tikhonov solve with ``B = I``, ``b_reg = x`` and ``α = 1/τ`` from
    ``x0`` (``nsol_tpu/solvers/tikhonov.py:293-306``; reference:
    nsol/proximal_operators.py:43-78). ``hooks`` are the TK0 kernel hooks
    of :func:`tikhonov_solve` (``normal_M``, ``normal_W``, ``grad_W``)."""
    def ident(z):
        return z

    return tikhonov_solve(
        A, A_adj, ident, ident, b, b_reg=x, x0=x0, alpha=1.0 / tau,
        data_loss=data_loss, data_loss_scale=data_loss_scale,
        minimizer=minimizer, iter_max=iter_max, bounds=bounds,
        normal_A=normal_A, normal_B=ident, reduce=reduce, **hooks)
