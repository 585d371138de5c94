"""Robust data-loss functions ρ(f²) and derivatives ρ'(f²) (counterpart of
``nsol_tpu/ops/losses.py``).

scipy-compatible ``f_scale`` semantics ``ρ_C(f²) = C² ρ(f²/C²)`` and
``ρ'_C(f²) = ρ'(f²/C²)`` (reference: nsol/loss_functions.py:82-248). All
functions are elementwise on tensors. ``LOSSES`` / ``GRADIENT_LOSSES``
mirror ``LossFunctions.get_loss`` / ``get_gradient_loss``
(nsol/loss_functions.py:251-266).
"""

import torch

__all__ = [
    "linear", "gradient_linear", "soft_l1", "gradient_soft_l1",
    "huber", "gradient_huber", "cauchy", "gradient_cauchy",
    "arctan", "gradient_arctan", "LOSSES", "GRADIENT_LOSSES",
    "loss", "gradient_loss", "cost_from_residual",
    "gradient_cost_from_residual", "HUBER_GAMMA",
]

#: Default Huber transition parameter (reference: nsol/loss_functions.py:149).
HUBER_GAMMA = 1.345


def linear(f2, f_scale=1.0):
    """ρ(f²) = f² (reference: nsol/loss_functions.py:82-84)."""
    return f2


def gradient_linear(f2, f_scale=1.0):
    """ρ'(f²) = 1 (reference: nsol/loss_functions.py:94-96)."""
    return torch.ones_like(f2)


def soft_l1(f2, f_scale=1.0):
    """ρ(f²) = 2(√(1+f²) − 1) (reference: nsol/loss_functions.py:110-114)."""
    fs2 = f_scale * f_scale
    return 2.0 * (torch.sqrt(1.0 + f2 / fs2) - 1.0) * fs2


def gradient_soft_l1(f2, f_scale=1.0):
    """ρ'(f²) = 1/√(1+f²) (reference: nsol/loss_functions.py:129-133)."""
    fs2 = f_scale * f_scale
    return 1.0 / torch.sqrt(1.0 + f2 / fs2)


def huber(f2, gamma=HUBER_GAMMA, f_scale=1.0):
    """Huber of the squared residual (reference: nsol/loss_functions.py:148-156)."""
    gamma2 = gamma * gamma
    fs2 = f_scale * f_scale
    f2s = f2 / fs2
    return torch.where(f2s < gamma2, f2s,
                       2.0 * gamma * torch.sqrt(f2s) - gamma2) * fs2


def gradient_huber(f2, gamma=HUBER_GAMMA, f_scale=1.0):
    """ρ' of Huber (reference: nsol/loss_functions.py:170-176)."""
    gamma2 = gamma * gamma
    fs2 = f_scale * f_scale
    f2s = f2 / fs2
    inside = f2s < gamma2
    # guard the 1/sqrt against f2 == 0 inside the unused branch
    safe = torch.where(inside, torch.ones_like(f2s), f2s)
    return torch.where(inside, torch.ones_like(f2s), gamma / torch.sqrt(safe))


def cauchy(f2, f_scale=1.0):
    """ρ(f²) = ln(1+f²) (reference: nsol/loss_functions.py:190-194)."""
    fs2 = f_scale * f_scale
    return torch.log1p(f2 / fs2) * fs2


def gradient_cauchy(f2, f_scale=1.0):
    """ρ'(f²) = 1/(1+f²) (reference: nsol/loss_functions.py:208-212)."""
    fs2 = f_scale * f_scale
    return 1.0 / (1.0 + f2 / fs2)


def arctan(f2, f_scale=1.0):
    """ρ(f²) = arctan(f²) (reference: nsol/loss_functions.py:226-230)."""
    fs2 = f_scale * f_scale
    return torch.arctan(f2 / fs2) * fs2


def gradient_arctan(f2, f_scale=1.0):
    """ρ'(f²) = 1/(1+f⁴) (reference: nsol/loss_functions.py:244-248)."""
    fs2 = f_scale * f_scale
    return 1.0 / (1.0 + (f2 / fs2) ** 2)


LOSSES = {
    "linear": linear,
    "soft_l1": soft_l1,
    "huber": huber,
    "cauchy": cauchy,
    "arctan": arctan,
}

GRADIENT_LOSSES = {
    "linear": gradient_linear,
    "soft_l1": gradient_soft_l1,
    "huber": gradient_huber,
    "cauchy": gradient_cauchy,
    "arctan": gradient_arctan,
}


def loss(name):
    return LOSSES[name]


def gradient_loss(name):
    return GRADIENT_LOSSES[name]


def cost_from_residual(f, loss_name="linear", f_scale=1.0):
    """``0.5 · Σ ρ(f²)`` (reference: nsol/loss_functions.py:43-46)."""
    return 0.5 * torch.sum(LOSSES[loss_name](f * f, f_scale=f_scale))


def gradient_cost_from_residual(f, loss_name="linear", f_scale=1.0):
    """Per-residual weight ``ρ'(f²)·f`` of the cost gradient; the caller
    applies the adjoint operator (reference: nsol/loss_functions.py:66-72)."""
    return GRADIENT_LOSSES[loss_name](f * f, f_scale=f_scale) * f
