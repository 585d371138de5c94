"""Convolution operators: Gaussian blur A/Aᵀ and its normal operator AᵀA
(counterpart of ``nsol_tpu/ops/conv.py``).

Semantics are pinned to ``scipy.ndimage.convolve``:

``y[i] = Σ_j k[j] · x[i + c − j]`` per axis with origin ``c = L // 2``,

indices wrapped (``mode="wrap"``, the blur) or read as zero
(``mode="constant"``). Three forms compute the wrap blur:

* separable (diagonal covariance): per-axis roll-accumulate;
* FFT (any covariance, a static shape): ``irfftn(rfftn(x) · k̂, s=shape)``
  with the kernel's spectrum made once on the host in float64 and held on
  ``x``'s device in ``x``'s real dtype;
* direct (any covariance, any shape): one ``conv{1,2,3}d`` of the padded
  volume with the flipped kernel, TF32 off (:func:`convolve`).

The reference's ``"matmul"`` form is a TPU MXU schedule of the separable
operator; here it gives the separable operator.
"""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from nsol_tpu_torch.ops.kernels import gaussian_kernel

__all__ = ["separable_factors", "convolve_axis", "separable_convolve_fn",
           "convolve", "embed_kernel_fft", "fft_convolve_fn",
           "make_blur_operators", "make_normal_blur_operator",
           "blur_factors"]

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def separable_factors(kernel, tol=1e-12):
    """Decompose a rank-1 (separable) stencil into per-axis 1-D factors.

    Returns a list of 1-D arrays each normalized to sum 1, or ``None`` if
    the kernel is not separable to ``tol`` (e.g. full covariance).
    """
    kernel = np.asarray(kernel)
    if kernel.ndim == 1:
        return [kernel / kernel.sum()]
    center = tuple(s // 2 for s in kernel.shape)
    factors = []
    for ax in range(kernel.ndim):
        idx = list(center)
        idx[ax] = slice(None)
        f = kernel[tuple(idx)].astype(np.float64)
        factors.append(f / f.sum())
    approx = factors[0]
    for f in factors[1:]:
        approx = np.multiply.outer(approx, f)
    approx *= kernel.sum()
    if np.max(np.abs(approx - kernel)) > tol * max(1.0, np.abs(kernel).max()):
        return None
    return [f.astype(kernel.dtype) for f in factors]


def blur_factors(cov, alpha_cut=3, spacing=None):
    """float64 per-array-axis factors of the Gaussian blur, which the
    separable operators and the CUDA kernels take; raises ``ValueError``
    for a non-separable (full) covariance, as the reference's kernel
    builders do (``nsol_tpu/ops/pallas/fused.py:435``)."""
    factors = separable_factors(gaussian_kernel(
        cov, alpha_cut=alpha_cut, spacing=spacing, dtype=np.float64))
    if factors is None:
        raise ValueError("the separable operators and the kernels take a "
                         "separable (diagonal-covariance) blur; use "
                         "method='fft' or 'direct'")
    return factors


def convolve_axis(x, taps, axis):
    """Wrap convolution of ``x`` with 1-D ``taps`` along one axis:
    ``Σ_j taps[j] · roll(x, j − c)`` with ``c = len(taps) // 2``."""
    c = len(taps) // 2
    acc = taps[0] * torch.roll(x, -c, dims=axis)
    for j in range(1, len(taps)):
        acc = acc + taps[j] * torch.roll(x, j - c, dims=axis)
    return acc


def separable_convolve_fn(factors):
    """Circular (wrap) convolution by per-array-axis 1-D factors via
    roll-accumulate (``nsol_tpu/ops/conv.py:150``). ``factors`` are numpy
    arrays or tensors; numpy taps enter as Python floats."""
    taps = [f if isinstance(f, torch.Tensor) else np.asarray(f).tolist()
            for f in factors]

    def apply(x):
        for ax, f in enumerate(taps):
            x = convolve_axis(x, f, ax)
        return x

    return apply


def _pad_axis(x, axis, lo, hi, mode):
    """``x`` padded by ``lo``/``hi`` entries along ``axis``: wrapped (any
    width, as ``jnp.pad(mode="wrap")``) or zeros."""
    if lo == 0 and hi == 0:
        return x
    if mode == "wrap":
        n = x.shape[axis]
        idx = torch.arange(-lo, n + hi, device=x.device) % n
        return x.index_select(axis, idx)
    shape = list(x.shape)
    parts = []
    for width in (lo, hi):
        shape[axis] = width
        parts.append(x.new_zeros(shape))
    return torch.cat([parts[0], x, parts[1]], dim=axis)


@contextlib.contextmanager
def _no_tf32():
    """cuDNN convolutions in full float32 inside the block. PyTorch lets a
    float32 convolution run in TF32 by default (a 10-bit mantissa on the
    card); the reference's float32 convolution does not."""
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = saved


def convolve(x, kernel, mode="wrap", prepadded_axes=()):
    """ndimage-semantics N-D convolution of ``x`` (1-D to 3-D) with the
    stencil ``kernel`` (``nsol_tpu/ops/conv.py:40-70``).

    ``mode``: "wrap" (circular, the blur) or "constant" (zero padding).
    ``prepadded_axes``: axes the caller already padded by the kernel's
    ``(L − 1 − c, c)`` (the sharded path's halo); they shrink by ``L − 1``.
    The convolution runs as one cross-correlation of the padded volume
    with the flipped kernel, in ``x``'s dtype with TF32 off."""
    kernel = torch.as_tensor(np.asarray(kernel), dtype=x.dtype,
                             device=x.device)
    if kernel.ndim != x.ndim:
        raise ValueError("kernel ndim %d != input ndim %d"
                         % (kernel.ndim, x.ndim))
    if x.ndim not in _CONV:
        raise ValueError("convolve takes 1-D to 3-D volumes, got %d-D"
                         % x.ndim)
    if mode not in ("wrap", "constant"):
        raise ValueError("mode must be 'wrap' or 'constant', got %r"
                         % (mode,))
    xp = x
    for ax, L in enumerate(kernel.shape):
        if ax not in prepadded_axes:
            c = L // 2
            xp = _pad_axis(xp, ax, L - 1 - c, c, mode)
    kflip = torch.flip(kernel, dims=tuple(range(kernel.ndim)))
    with _no_tf32():
        return _CONV[x.ndim](xp[None, None], kflip[None, None])[0, 0]


def embed_kernel_fft(kernel, shape):
    """Embed a small stencil into a ``shape``-sized circular impulse
    response ``h`` with ``x ⊛ h = ndimage.convolve(x, kernel, mode="wrap")``:
    ``h[t] = k[t + c]`` with indices mod N per axis and origin
    ``c = L // 2``. Host-side numpy (set-up only)."""
    kernel = np.asarray(kernel)
    h = np.zeros(shape, dtype=kernel.dtype)
    h[tuple(slice(0, L) for L in kernel.shape)] = kernel
    shifts = tuple(-(L // 2) for L in kernel.shape)
    return np.roll(h, shifts, axis=tuple(range(kernel.ndim)))


def _spectrum_fn(spectrum, shape):
    """``x ↦ irfftn(rfftn(x) · spectrum, s=shape)`` in ``x``'s dtype. The
    spectrum (a float64 or complex128 numpy array) is held on ``x``'s
    device in ``x``'s real (or complex) dtype, made once per device and
    dtype; ``s=shape`` keeps an odd last axis whole."""
    shape = tuple(int(n) for n in shape)
    held = {}

    def apply(x):
        key = (x.device, x.dtype)
        if key not in held:
            dtype = x.dtype
            if np.iscomplexobj(spectrum):
                dtype = (torch.complex128 if x.dtype == torch.float64
                         else torch.complex64)
            held[key] = torch.as_tensor(spectrum, dtype=dtype,
                                        device=x.device)
        dims = tuple(range(x.ndim))
        return torch.fft.irfftn(torch.fft.rfftn(x, dim=dims) * held[key],
                                s=shape, dim=dims).to(x.dtype)

    return apply


def fft_convolve_fn(kernel, shape, dtype=None):
    """Circular convolution with ``kernel`` on ``shape``-sized volumes by
    rFFT (``nsol_tpu/ops/conv.py:94-117``). The spectrum is made in float64
    on the host; for the symmetric Gaussian stencils it is real, and its
    imaginary part is dropped below ``1e-12 · max(1, max |Re|)``, so
    ``A = Aᵀ`` exactly. ``dtype`` is the reference's spectrum dtype; the
    arithmetic follows the volume's."""
    khat = np.fft.rfftn(embed_kernel_fft(np.asarray(kernel, np.float64),
                                         shape))
    if np.abs(khat.imag).max() < 1e-12 * max(1.0, np.abs(khat.real).max()):
        khat = khat.real
    return _spectrum_fn(khat, shape)


def make_normal_blur_operator(cov, alpha_cut=3, spacing=None, shape=None,
                              dtype=np.float64):
    """``AᵀA`` of the wrap Gaussian blur as ONE convolution: with a
    separable kernel the self-correlated factors ``np.convolve(f,
    f[::-1])`` whatever ``shape`` (the reference's matmul form computes
    the same operator), else an FFT with the squared spectrum ``|k̂|²``,
    which needs ``shape`` (``nsol_tpu/ops/conv.py:176-211``)."""
    kernel64 = gaussian_kernel(cov, alpha_cut=alpha_cut, spacing=spacing,
                               dtype=np.float64)
    factors = separable_factors(kernel64)
    if factors is not None:
        auto = [np.convolve(f, f[::-1]) for f in factors]
        return separable_convolve_fn(auto)
    if shape is None:
        raise ValueError("non-separable covariance requires a static shape")
    khat = np.fft.rfftn(embed_kernel_fft(kernel64, shape))
    return _spectrum_fn((khat * np.conj(khat)).real, shape)


def make_blur_operators(cov, alpha_cut=3, spacing=None, shape=None,
                        method="auto", dtype=np.float64):
    """Gaussian blurring operator pair ``(A, A_adj)``; ``A_adj = A``
    because the stencil is symmetric (nsol/linear_operators.py:63).

    ``method`` (``nsol_tpu/ops/conv.py:214-274``): "separable" (diagonal
    covariance), "fft" (needs ``shape``), "direct" (:func:`convolve`),
    "matmul" (the reference's MXU form of the separable operator: here the
    separable operator), or "auto": separable where the covariance is
    diagonal, else fft with ``shape``, else direct. ``dtype`` is the
    stencil's, as in the reference; the arithmetic follows the volume's.
    """
    kernel64 = gaussian_kernel(cov, alpha_cut=alpha_cut, spacing=spacing,
                               dtype=np.float64)
    factors = separable_factors(kernel64)
    if method == "auto":
        if factors is not None:
            method = "separable"
        else:
            method = "fft" if shape is not None else "direct"
    if method in ("separable", "matmul"):
        if factors is None:
            raise ValueError("kernel is not separable (non-diagonal "
                             "covariance); use method='fft' or 'direct'")
        A = separable_convolve_fn([f.astype(dtype) for f in factors])
        return A, A
    if method == "fft":
        if shape is None:
            raise ValueError("method='fft' requires a static shape")
        A = fft_convolve_fn(kernel64, shape, dtype=dtype)
        return A, A
    if method != "direct":
        raise ValueError("method %r not known" % (method,))
    kernel = gaussian_kernel(cov, alpha_cut=alpha_cut, spacing=spacing,
                             dtype=dtype)

    def A(x):
        return convolve(x, kernel, mode="wrap")

    return A, A
