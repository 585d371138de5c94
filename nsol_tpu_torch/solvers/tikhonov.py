"""Tikhonov-regularized (robust) least squares: the quadratic engine
(counterpart of ``nsol_tpu/solvers/tikhonov.py``: every engine of
``tikhonov_solve`` and ``prox_linear_least_squares``).

``minimizer="cg"`` runs CG directly on the normal equations
``(AᵀA + α BᵀB) x = Aᵀb + α Bᵀ b_reg``. ``minimizer="lsmr"`` runs CGLS on
the augmented system ``[A; √α·B] x = [b; √α·b_reg]`` for exactly
``iter_max`` iterations, then clips to the bounds (tikhonov.py:154-167;
the reference's lsmr with atol = btol = 0 is fixed-trip too).
``minimizer="irls"`` minimizes the robust cost ``½Σρ_C((Ax−b)²) +
α·½‖Bx‖²`` by reweighted least squares in projected-Newton form
(tikhonov.py:193-252), ``b_reg`` ignored as the reference's robust path
ignores it. ``minimizer="lsq_linear"`` runs projected FISTA on the normal
equations with a step of 1/L, L from 20 power iterations (:169-193).
``minimizer="least_squares"`` applies the robust loss to the whole
augmented residual ``[Ax − b; √α(Bx − b_reg)]`` and minimizes it by the box
L-BFGS (:260-276); any other name (``"L-BFGS-B"``) minimizes ``½Σρ_C((Ax −
b)²) + α·½‖Bx‖²`` by it, ``b_reg`` ignored as there (:278-290).
"""

import numpy as np
import torch

from nsol_tpu_torch.ops import losses
from nsol_tpu_torch.solvers.cg import cg, cgls, tree_vdot
from nsol_tpu_torch.solvers.lbfgs import lbfgs_box, summed

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


def _power_iteration_L(apply_M, x, iters=20, reduce=None):
    """Largest-eigenvalue estimate of the SPD normal operator from the
    ones vector (``nsol_tpu/solvers/tikhonov.py:100-115``)."""
    v = torch.ones_like(x)
    v = v / torch.sqrt(tree_vdot(v, v, reduce))
    lam = torch.ones((), dtype=x.dtype, device=x.device)
    for _ in range(iters):
        w = apply_M(v)
        lam = tree_vdot(v, w, reduce)
        nw = torch.sqrt(tree_vdot(w, w, reduce))
        v = w / torch.where(nw > 0, nw, torch.ones_like(nw))
    return torch.abs(lam)


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

    ``minimizer="lsq_linear"``: ``iter_max`` projected FISTA steps, no clip
    after the last. ``"least_squares"`` and any other name: ``iter_max``
    box L-BFGS iterations on the costs of the module docstring.

    ``reduce`` sums the dots (and the L-BFGS cost) over the ranks of a
    sharded volume (the reference's ``axis_name``,
    ``nsol_tpu/solvers/tikhonov.py:151,248,258``).
    """
    if minimizer in ("lsmr", "lsq_linear", "cg") and data_loss != "linear":
        raise ValueError("%s minimizer cannot be used with non-linear data "
                         "loss" % minimizer)
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
    if minimizer == "lsq_linear":
        return _fista(A, A_adj, B, B_adj, b, b_reg, x0, alpha_t, iter_max,
                      bounds, reduce)
    if minimizer != "cg":
        return _lbfgs(A, B, b, b_reg, x0, alpha_t, data_loss,
                      data_loss_scale, minimizer, iter_max, bounds, reduce)
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


def _fista(A, A_adj, B, B_adj, b, b_reg, x0, alpha_t, iters, bounds,
           reduce):
    """The ``"lsq_linear"`` engine (tikhonov.py:169-193): projected FISTA on
    ``M x = rhs``, ``M = AᵀA + α BᵀB``, ``rhs = Aᵀb + α Bᵀ b_reg``."""
    def apply_M(v):
        return A_adj(A(v)) + alpha_t * B_adj(B(v))

    rhs = A_adj(b) + alpha_t * B_adj(b_reg)
    L = _power_iteration_L(apply_M, x0, reduce=reduce)
    step = 1.0 / torch.where(L > 0, L, torch.ones_like(L))
    x, y, t = x0, x0, torch.ones_like(L)
    for _ in range(iters):
        x_new = _clip_bounds(y - step * (apply_M(y) - rhs), bounds)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        y = x_new + ((t - 1.0) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return x


def _lbfgs(A, B, b, b_reg, x0, alpha_t, data_loss, data_loss_scale,
           minimizer, iters, bounds, reduce):
    """The box L-BFGS engines (tikhonov.py:254-290): ``"least_squares"``
    on the whole augmented residual, any other name on the analytic cost
    with the b_reg-ignoring regulariser. The cost is summed over the ranks
    by ``reduce``."""
    sqrt_alpha = torch.sqrt(alpha_t)
    if minimizer == "least_squares":
        def cost(x):
            c = losses.cost_from_residual(A(x) - b, data_loss,
                                          data_loss_scale)
            r_reg = sqrt_alpha * (B(x) - b_reg)
            c = c + losses.cost_from_residual(r_reg.reshape(-1), data_loss,
                                              data_loss_scale)
            return summed(c, reduce)
    else:
        def cost(x):
            c = losses.cost_from_residual(A(x) - b, data_loss,
                                          data_loss_scale)
            Bx = B(x)
            return summed(c + alpha_t * 0.5 * torch.sum(Bx * Bx), reduce)

    lo = -np.inf if bounds is None else bounds[0]
    hi = np.inf if bounds is None else bounds[1]
    return lbfgs_box(cost, x0, lower=lo, upper=hi, iters=iters,
                     reduce=reduce)


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
