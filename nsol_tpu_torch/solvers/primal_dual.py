"""Chambolle–Pock first-order primal-dual solver (counterpart of
``nsol_tpu/solvers/primal_dual.py``).

Solves ``min_x f(x) + α g(Bx)`` given ``prox_f``, ``prox_{g*}``, the linear
operator pair ``B/Bᵀ`` and its squared norm ``L2``
(reference: nsol/primal_dual_solver.py). Step-size schedules:

* ``ALG2``       — accelerated: ``τ0=1/√L2, σ0=1/(L2·τ0), γ=0.35λ``;
  per-iteration ``θ=1/√(1+2γτ), τ←τθ, σ←σ/θ`` (reference :278-306)
* ``ALG2_AHMOD`` — Arrow–Hurwicz: ``τ0=0.02, σ0=4/(L2·τ0)``, same τ/σ update
  but over-relaxation θ forced to 0 (reference :374-403)
* ``ALG3``       — constant steps from ``μ=2√(λδ/L2)``, Huber δ=0.05,
  ``θ=1/(1+μ), σ=μ/(2δ), τ=μ/(2λ)`` (reference :321-358)

with ``λ = 1/α`` and the primal prox always invoked with step ``τ·λ``.
The schedules depend on α and L2 only, so they are computed once on the host
(:func:`step_schedules`, step by step in the solve's dtype) and the
``lax.scan`` of the reference becomes a loop over them.
"""

import numpy as np
import torch

__all__ = ["primal_dual_solve", "step_schedules", "ALG_TYPES",
           "ALG3_HUBER_DELTA"]

ALG_TYPES = ("ALG2", "ALG2_AHMOD", "ALG3")

#: Huber smoothing δ used by ALG3 (reference: nsol/primal_dual_solver.py:321).
ALG3_HUBER_DELTA = 0.05

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def step_schedules(alpha, L2, iterations, alg_type="ALG2", dtype=np.float32):
    """Per-iteration ``(σ_t, τ_t, τ_t·λ, θ_t)`` as numpy arrays of shape
    ``(iterations,)`` in ``dtype``, each step rounded to ``dtype`` as the
    reference's scan computes it: σ/τ are the values that *enter*
    iteration t, θ_t is the over-relaxation applied at iteration t."""
    if alg_type not in ALG_TYPES:
        raise ValueError("alg_type must be one of %s" % (ALG_TYPES,))
    f = np.dtype(dtype).type
    alpha, L2, one, two = f(alpha), f(L2), f(1.0), f(2.0)
    lmbda = one / alpha
    if alg_type == "ALG3":
        delta = f(ALG3_HUBER_DELTA)
        mu = two * np.sqrt(lmbda * delta / L2)
        sigma = np.full(iterations, mu / (two * delta), dtype)
        tau = np.full(iterations, mu / (two * lmbda), dtype)
        theta = np.full(iterations, one / (one + mu), dtype)
        return sigma, tau, tau * lmbda, theta
    if alg_type == "ALG2":
        tau_t = one / np.sqrt(L2)
        sigma_t = one / (L2 * tau_t)
    else:  # ALG2_AHMOD
        tau_t = f(0.02)
        sigma_t = f(4.0) / (L2 * tau_t)
    gamma = f(0.35) * lmbda
    sigma, tau, theta = (np.empty(iterations, dtype) for _ in range(3))
    for t in range(iterations):
        th = one / np.sqrt(one + two * gamma * tau_t)
        sigma[t], tau[t] = sigma_t, tau_t
        theta[t] = th if alg_type == "ALG2" else f(0.0)
        tau_t, sigma_t = tau_t * th, sigma_t / th
    return sigma, tau, tau * lmbda, theta


def _stack(rows):
    """Stack a list of equally structured records (dicts, tuples or
    tensors) along a new leading axis."""
    first = rows[0]
    if isinstance(first, dict):
        return {k: _stack([r[k] for r in rows]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack(list(c)) for c in zip(*rows))
    return torch.stack([torch.as_tensor(r) for r in rows])


def primal_dual_solve(prox_f, prox_g_conj, B, B_adj, x0, alpha, L2,
                      iterations, alg_type="ALG2", record_fn=None,
                      record_trajectory=False):
    """Run ``iterations`` primal-dual steps from ``x0``.

    ``prox_f(x, tau)``, ``prox_g_conj(p, sigma)``; ``B``/``B_adj`` a linear
    operator pair; ``alpha``/``L2`` scalars; ``record_fn(x)`` an optional
    function of per-iteration scalars (a dict, tuple or tensor);
    ``record_trajectory`` also stacks every iterate.

    Returns ``(x, records)``: records is None, or a dict with
    ``"measures"`` and/or ``"x"`` of ``(iterations+1, ...)`` entries, row 0
    the x0 state (the reference observer's add_x-at-init).
    """
    if x0.dtype not in _NP_DTYPES:
        raise TypeError("x0 must be float32 or float64, got %s" % x0.dtype)
    sigma, tau, ft, theta = step_schedules(
        float(alpha), float(L2), iterations, alg_type, _NP_DTYPES[x0.dtype])
    x, x_mean = x0, x0
    p = torch.zeros_like(B(x0))
    measures = [record_fn(x0)] if record_fn is not None else None
    xs = [x0] if record_trajectory else None
    for t in range(iterations):
        s = float(sigma[t])
        p = prox_g_conj(p + s * B(x_mean), s)
        x_new = prox_f(x - float(tau[t]) * B_adj(p), float(ft[t]))
        x_mean = x_new + float(theta[t]) * (x_new - x)
        x = x_new
        if measures is not None:
            measures.append(record_fn(x))
        if xs is not None:
            xs.append(x)
    records = None
    if measures is not None or xs is not None:
        records = {}
        if measures is not None:
            records["measures"] = _stack(measures)
        if xs is not None:
            records["x"] = torch.stack(xs)
    return x, records
