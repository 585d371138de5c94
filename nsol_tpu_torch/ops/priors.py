"""Regularizer (prior) cost evaluation (counterpart of
``nsol_tpu/ops/priors.py``; reference: nsol/prior_measures.py:18-52).

The differential operator ``D`` returns the stacked ``(d, *shape)``
gradient field of :func:`nsol_tpu_torch.ops.grad.gradient`.
"""

import torch

from nsol_tpu_torch.ops import losses

__all__ = [
    "zeroth_order_tikhonov", "first_order_tikhonov",
    "total_variation", "huber", "HUBER_PRIOR_GAMMA",
]

#: Default Huber smoothing for the regularizer — differs from the data-loss
#: default 1.345 (reference: nsol/prior_measures.py:43 vs
#: nsol/loss_functions.py:149).
HUBER_PRIOR_GAMMA = 0.05


def zeroth_order_tikhonov(x):
    """TK0: ``½‖x‖²``."""
    return 0.5 * torch.sum(x * x)


def first_order_tikhonov(x, D):
    """TK1: ``½‖Dx‖²``."""
    Dx = D(x)
    return 0.5 * torch.sum(Dx * Dx)


def total_variation(x, D):
    """Isotropic TV: ``Σ √(Σ_k (Dx)_k²)``."""
    Dx = D(x)
    return torch.sum(torch.sqrt(torch.sum(Dx * Dx, dim=0)))


def huber(x, D, gamma=HUBER_PRIOR_GAMMA):
    """Huber of the gradient magnitude, ``½ Σ ρ_huber(‖Dx‖²)``."""
    Dx = D(x)
    mag2 = torch.sum(Dx * Dx, dim=0)
    return 0.5 * torch.sum(losses.huber(mag2, gamma=gamma))
