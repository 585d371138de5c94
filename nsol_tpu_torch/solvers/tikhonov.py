"""Tikhonov-regularized (robust) least squares: the quadratic engine
(counterpart of ``nsol_tpu/solvers/tikhonov.py``, the ``"cg"`` and
``"irls"`` branches).

``minimizer="cg"`` runs CG directly on the normal equations
``(AᵀA + α BᵀB) x = Aᵀb + α Bᵀ b_reg``. ``minimizer="irls"`` minimizes the
robust cost ``½Σρ_C((Ax−b)²) + α·½‖Bx‖²`` by reweighted least squares in
projected-Newton form (tikhonov.py:193-252), ``b_reg`` ignored as the
reference's robust path ignores it. The reference's other engines
("lsmr", "lsq_linear", "least_squares", L-BFGS) raise
``NotImplementedError`` until their slice lands (ROADMAP Queue 1 item 6).
"""

import numpy as np
import torch

from nsol_tpu_torch.ops import losses
from nsol_tpu_torch.solvers.cg import cg

__all__ = ["tikhonov_solve", "resolve_minimizer"]


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
    if minimizer not in ("cg", "irls"):
        raise NotImplementedError(
            "minimizer=%r is not ported yet (ROADMAP Queue 1 item 6)"
            % minimizer)
    x0 = _clip_bounds(x0, bounds)
    alpha_t = torch.as_tensor(alpha, dtype=x0.dtype, device=x0.device)
    nB = normal_B if normal_B is not None else (lambda v: B_adj(B(v)))
    if minimizer == "irls":
        return _irls(A, A_adj, nB, b, x0, alpha_t, data_loss,
                     data_loss_scale, iter_max, bounds, irls_cg_iters,
                     normal_W, grad_W, reduce)
    if normal_M is not None:
        def apply_M(v):
            return normal_M(v, alpha_t)
    else:
        nA = normal_A if normal_A is not None else (lambda v: A_adj(A(v)))

        def apply_M(v):
            return nA(v) + alpha_t * nB(v)

    b_reg = torch.broadcast_to(
        torch.as_tensor(b_reg, dtype=x0.dtype, device=x0.device),
        B(x0).shape)
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
