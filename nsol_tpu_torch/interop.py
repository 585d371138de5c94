"""Constants and state carried between the JAX package and the port.

The deconvolution path has no weights. Its parameters are

* the operator constants: the per-array-axis blur factors
  (``separable_factors(gaussian_kernel(...))``) and the spacing in spatial
  (x, y[, z]) order;
* the ADMM state: ``x``, plus ``v`` and ``w`` in the stacked ``(d, *shape)``
  gradient layout, x component first (``nsol_tpu/ops/grad.py``).

The robust (IRLS) deconvolution path adds the loss name (one of
``nsol_tpu_torch.ops.losses.LOSSES``, its index the ``Loss`` enum of
``csrc/robust.cu``) and the runtime scale ``data_loss_scale`` (``C`` of
``ρ_C(r²) = C²ρ(r²/C²)``, passed unscaled by the CLI). Its state is ``x``
alone: the weights ``ρ'_C(r²)`` and the active set ``free`` (a float
``{0, 1}`` field) are frozen for one IRLS sweep and rebuilt from ``x`` at
the next, and ``v``/``w`` feed nothing that reaches ``x``.

The primal-dual denoising path has no weights either. Its parameters are the
step schedules ``(σ_t, τ_t, τ_t·λ, θ_t)`` of ``_pd_schedules`` and its state
is ``(x, x̄, p)``, the dual ``p`` stacked ``(d, *shape)`` (or
``(B, d, *shape)`` for a batch over α), x component first. Under the
reference's ``compact=True`` the state is bfloat16; numpy has no such dtype,
so it arrives as uint16 bit patterns (JAX's bfloat16 arrays are viewed so)
or as the float32 upcasts that bfloat16 holds exactly.

These helpers turn the numpy arrays the JAX package produces into the
port's tensors on an explicit device, checking layout and dtype, and back.
"""

import numpy as np
import torch

from nsol_tpu_torch.ops.grad import _spacing_array

__all__ = ["to_torch", "to_numpy", "blur_factors", "spacing",
           "admm_state", "admm_state_numpy", "pd_schedules",
           "pd_schedules_numpy", "pd_state", "pd_state_numpy",
           "bf16_from_numpy", "bf16_to_bits"]

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64}


def to_torch(a, device, dtype=None):
    """numpy array → contiguous tensor on ``device`` (float32/float64 only;
    ``dtype`` casts explicitly)."""
    a = np.asarray(a)
    if a.dtype not in _DTYPES:
        raise TypeError("expected a float32/float64 array, got %s" % a.dtype)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t if dtype is None else t.to(dtype)


def to_numpy(t):
    """Tensor (any device) → numpy array."""
    return t.detach().cpu().numpy()


def blur_factors(factors, ndim, device, dtype=torch.float64):
    """Per-array-axis 1-D blur factors → tensors. Each factor must be 1-D,
    odd-length and sum to 1, one per array axis."""
    factors = [np.asarray(f) for f in factors]
    if len(factors) != ndim:
        raise ValueError("expected %d factors (one per array axis), got %d"
                         % (ndim, len(factors)))
    for f in factors:
        if f.ndim != 1 or f.size % 2 != 1:
            raise ValueError("each factor must be 1-D with odd length, "
                             "got shape %s" % (f.shape,))
        if abs(float(f.sum()) - 1.0) > 1e-6:
            raise ValueError("each factor must sum to 1, got %r" % f.sum())
    return [to_torch(f, device, dtype) for f in factors]


def spacing(s, ndim):
    """Spacing in spatial (x, y[, z]) order → float64 numpy array of
    ``ndim`` positive entries (a scalar broadcasts, None gives ones)."""
    s = _spacing_array(s, ndim)
    if np.any(s <= 0):
        raise ValueError("spacing must be %d positive entries, got %s"
                         % (ndim, s))
    return s


def admm_state(x, v, w, device):
    """ADMM state ``(x, v, w)`` → tensors; ``v``/``w`` must be stacked
    ``(x.ndim, *x.shape)`` and every array must share one dtype."""
    x, v, w = (np.asarray(a) for a in (x, v, w))
    want = (x.ndim,) + x.shape
    if v.shape != want or w.shape != want:
        raise ValueError("v and w must have the stacked layout %s, got %s "
                         "and %s" % (want, v.shape, w.shape))
    if not x.dtype == v.dtype == w.dtype:
        raise TypeError("x, v, w dtypes differ: %s %s %s"
                        % (x.dtype, v.dtype, w.dtype))
    return tuple(to_torch(a, device) for a in (x, v, w))


def admm_state_numpy(x, v, w):
    """Tensors ``(x, v, w)`` → numpy arrays (the inverse of
    :func:`admm_state`)."""
    return tuple(to_numpy(t) for t in (x, v, w))


def pd_schedules(sigma, tau, ft, theta, device, dtype=torch.float32):
    """Step schedules ``(σ, τ, τ·λ, θ)``, numpy arrays of one shape
    ``(iterations,)`` or ``(B, iterations)``, → one contiguous ``(4, B,
    iterations)`` tensor (``B = 1`` for 1-D input), the layout the PD
    kernel units index."""
    arrays = [np.asarray(a) for a in (sigma, tau, ft, theta)]
    shape = arrays[0].shape
    if any(a.shape != shape for a in arrays) or len(shape) not in (1, 2):
        raise ValueError("schedules must share one (iterations,) or (B, "
                         "iterations) shape, got %s"
                         % [a.shape for a in arrays])
    stacked = np.stack([np.atleast_2d(a) for a in arrays])
    return torch.as_tensor(stacked, dtype=dtype, device=device).contiguous()


def pd_schedules_numpy(sched):
    """``(4, B, iterations)`` tensor → ``(σ, τ, τ·λ, θ)`` numpy arrays of
    shape ``(B, iterations)`` (the inverse of :func:`pd_schedules`)."""
    if sched.dim() != 3 or sched.shape[0] != 4:
        raise ValueError("expected a (4, B, iterations) tensor, got %s"
                         % (tuple(sched.shape),))
    return tuple(to_numpy(sched[k]) for k in range(4))


def bf16_from_numpy(a, device):
    """A bfloat16 array → a bfloat16 tensor on ``device``: uint16 bit
    patterns (or an array of a 2-byte ``bfloat16`` dtype, such as JAX's,
    viewed as them), or float32 values that bfloat16 holds exactly; any
    other array raises."""
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.name in ("uint16", "bfloat16"):
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    if a.dtype != np.float32:
        raise TypeError("a bfloat16 state arrives as uint16 bit patterns or "
                        "float32 upcasts, got %s" % a.dtype)
    t = torch.from_numpy(np.ascontiguousarray(a))
    b = t.to(torch.bfloat16)
    if not torch.equal(b.float(), t):
        raise ValueError("float32 values that bfloat16 does not hold exactly")
    return b.to(device)


def bf16_to_bits(t):
    """A bfloat16 tensor → its uint16 bit patterns (numpy)."""
    return t.detach().cpu().view(torch.int16).numpy().view(np.uint16)


def pd_state(x, x_mean, p, device, dtype=None):
    """PD state ``(x, x̄, p)`` → tensors. ``x``/``x̄`` share one shape,
    ``p`` is stacked ``(x.ndim, *x.shape)``, or for a batch ``x`` of
    ``(B, *shape)`` it is ``(B, len(shape), *shape)``; one dtype.
    ``dtype=torch.bfloat16``: the compact state, each array as
    :func:`bf16_from_numpy` takes it."""
    x, x_mean, p = (np.asarray(a) for a in (x, x_mean, p))
    single = (x.ndim,) + x.shape
    batched = (x.shape[0], x.ndim - 1) + x.shape[1:] if x.ndim else ()
    if x_mean.shape != x.shape or p.shape not in (single, batched):
        raise ValueError("PD state: x %s, x_mean %s, p %s; p must be %s or, "
                         "batched, %s" % (x.shape, x_mean.shape, p.shape,
                                          single, batched))
    if not x.dtype == x_mean.dtype == p.dtype:
        raise TypeError("x, x_mean, p dtypes differ: %s %s %s"
                        % (x.dtype, x_mean.dtype, p.dtype))
    if dtype == torch.bfloat16:
        return tuple(bf16_from_numpy(a, device) for a in (x, x_mean, p))
    return tuple(to_torch(a, device) for a in (x, x_mean, p))


def pd_state_numpy(x, x_mean, p, bits=False):
    """Tensors ``(x, x̄, p)`` → numpy arrays (the inverse of
    :func:`pd_state`); a bfloat16 state as float32 upcasts, or with
    ``bits`` as uint16 bit patterns."""
    if bits:
        return tuple(bf16_to_bits(t) for t in (x, x_mean, p))
    return tuple(to_numpy(t.float() if t.dtype == torch.bfloat16 else t)
                 for t in (x, x_mean, p))
