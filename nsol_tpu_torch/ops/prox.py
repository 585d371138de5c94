"""Proximal operators (counterpart of ``nsol_tpu/ops/prox.py``).

Conventions (reference: nsol/proximal_operators.py):

* ``prox_ell1_denoising``: shifted soft-threshold (:95-98)
* ``prox_ell2_denoising``: ``(x + τ·x0)/(1+τ)`` (:117-120)
* ``prox_tv_conj``: *componentwise* projection ``x / max(1, |x|)`` — NOT the
  per-pixel gradient-vector norm; a deliberate reference quirk kept here
  (:138-140)
* ``prox_huber_conj``: scale by ``1/(1+σγ)`` then the same projection,
  γ = 0.05 (:156-159)
* the grouped soft-threshold of the ADMM v-update
  (nsol/admm_linear_solver.py:239-253)
"""

import torch

__all__ = [
    "soft_threshold", "prox_ell1_denoising", "prox_ell2_denoising",
    "prox_tv_conj", "prox_huber_conj", "vectorial_soft_threshold",
    "HUBER_CONJ_GAMMA",
]

#: Default Huber regularizer smoothing (reference: nsol/proximal_operators.py:157).
HUBER_CONJ_GAMMA = 0.05


def soft_threshold(t, ell):
    """``max(|t|−ℓ, 0)·sign(t)`` (reference: nsol/admm_linear_solver.py:308-309)."""
    return torch.clamp_min(torch.abs(t) - ell, 0.0) * torch.sign(t)


def prox_ell1_denoising(x, tau, x0, x_scale=1.0):
    """Prox of ``g(x)=‖x−x0‖₁``: shifted soft-threshold."""
    x0 = x0 / x_scale
    return x0 + soft_threshold(x - x0, tau)


def prox_ell2_denoising(x, tau, x0, x_scale=1.0):
    """Prox of ``g(x)=½‖x−x0‖₂²``: ``(x + τ·x0)/(1+τ)``."""
    x0 = x0 / x_scale
    return (x + tau * x0) / (1.0 + tau)


def prox_tv_conj(x, sigma):
    """Projection onto the (componentwise) unit ball: ``x / max(1,|x|)``."""
    return x / torch.clamp_min(torch.abs(x), 1.0)


def prox_huber_conj(x, sigma, gamma=HUBER_CONJ_GAMMA):
    """Huber-conjugate prox: shrink by ``1/(1+σγ)`` then project."""
    y = x / (1.0 + sigma * gamma)
    return y / torch.clamp_min(torch.abs(y), 1.0)


def vectorial_soft_threshold(t, tau):
    """Grouped soft-thresholding of a stacked gradient field ``(d, *shape)``.

    Shrinks the per-pixel magnitude ``‖t‖ = √(Σ_k t_k²)`` by ``τ`` and
    rescales components; zero where ``‖t‖ ≤ τ``.
    """
    norm = torch.sqrt(torch.sum(t * t, dim=0))
    keep = norm > tau
    scale = torch.where(keep,
                        torch.clamp(norm - tau, min=0.0)
                        / torch.where(keep, norm, torch.ones_like(norm)),
                        torch.zeros_like(norm))
    return t * scale.unsqueeze(0)
