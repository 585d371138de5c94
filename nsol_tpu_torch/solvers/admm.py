"""ADMM for TV-regularized (robust) deconvolution (counterpart of
``nsol_tpu/solvers/admm.py``: ``minimizer="cg"`` or ``"lsmr"`` for the
linear loss, ``"irls"`` for the robust ones).

Solves ``min_x ½Σρ((Ax−b)²) + α TV(Bx − b_reg)``
(reference: nsol/admm_linear_solver.py). Per iteration (:202-218):

1. x-update: inner Tikhonov solve with ``alpha=ρ, b_reg = v − w + b_reg``
2. v-update: vectorial soft-thresholding of ``Bx + w − b_reg`` at
   ``τ = α/ρ``
3. dual update ``w = Bx + w − b_reg − v``

The reference's ``lax.scan`` becomes a Python loop; every scalar stays on
the device. With a robust loss the x-update ignores ``v − w`` (the
reference's b_reg-ignoring quirk, kept), so ``x`` does not depend on
``alpha``: only the v/w chain does.
"""

import numpy as np
import torch

from nsol_tpu_torch.ops.prox import vectorial_soft_threshold
from nsol_tpu_torch.solvers.tikhonov import tikhonov_solve

__all__ = ["admm_solve"]


def admm_solve(A, A_adj, B, B_adj, b, b_reg, x0, alpha, rho,
               iterations=10, iter_max=10, data_loss="linear",
               data_loss_scale=1.0, minimizer="cg",
               inner_bounds=(0.0, np.inf), record_fn=None,
               record_trajectory=False, normal_A=None, normal_B=None,
               irls_cg_iters=8, normal_M=None, normal_W=None, grad_W=None,
               reduce=None):
    """Run ``iterations`` ADMM steps from ``x0``.

    Returns ``(x, records)``; ``records`` is None unless ``record_fn`` is
    given or ``record_trajectory`` set, then ``{"measures": record_fn
    stacked over [x0, x1, ...]}`` with each leaf stacked along a new
    leading axis (the reference's layout) and/or ``{"x": [x0, x1, ...]}``
    stacked. ``reduce`` sums the inner solves' dots over the ranks of a
    sharded volume (the reference's ``axis_name``).
    """
    dtype, device = x0.dtype, x0.device
    alpha = torch.as_tensor(alpha, dtype=dtype, device=device)
    rho = torch.as_tensor(rho, dtype=dtype, device=device)
    Bx0 = B(x0)
    b_reg = torch.broadcast_to(
        torch.as_tensor(b_reg, dtype=dtype, device=device), Bx0.shape)

    v = Bx0 - b_reg
    w = torch.zeros_like(v)
    # Aᵀb is loop-invariant for the normal-equation inner solver
    At_b = A_adj(b) if minimizer == "cg" else None

    x = x0
    measures = [record_fn(x0)] if record_fn is not None else None
    trajectory = [x0] if record_trajectory else None
    for _ in range(iterations):
        x = tikhonov_solve(
            A, A_adj, B, B_adj, b, b_reg=v - w + b_reg, x0=x, alpha=rho,
            data_loss=data_loss, data_loss_scale=data_loss_scale,
            minimizer=minimizer, iter_max=iter_max, bounds=inner_bounds,
            normal_A=normal_A, normal_B=normal_B, At_b=At_b,
            irls_cg_iters=irls_cg_iters, normal_M=normal_M,
            normal_W=normal_W, grad_W=grad_W, reduce=reduce)
        t = B(x) + w - b_reg
        v = vectorial_soft_threshold(t, alpha / rho)
        w = t - v
        if measures is not None:
            measures.append(record_fn(x))
        if trajectory is not None:
            trajectory.append(x)

    if measures is None and trajectory is None:
        return x, None
    records = {}
    if trajectory is not None:
        records["x"] = torch.stack(trajectory)
    if measures is None:
        return x, records
    if isinstance(measures[0], dict):
        records["measures"] = {
            k: torch.stack([torch.as_tensor(m[k]) for m in measures])
            for k in measures[0]}
    else:
        records["measures"] = torch.stack([torch.as_tensor(m)
                                           for m in measures])
    return x, records
