"""Convolution operators: Gaussian blur A/Aᵀ and its normal operator AᵀA.

Counterpart of ``nsol_tpu/ops/conv.py``, separable branch. Semantics are
pinned to ``scipy.ndimage.convolve(mode="wrap")``:

``y[i] = Σ_j k[j] · x[(i + c − j) mod n]`` per axis with origin ``c = L // 2``.

Only the separable (diagonal-covariance) form is ported. The FFT and direct
branches, and the TPU matmul form, raise ``NotImplementedError`` (ROADMAP
Queue 1: non-separable blur).
"""

import numpy as np
import torch

from nsol_tpu_torch.defaults import ROADMAP_NON_SEPARABLE
from nsol_tpu_torch.ops.kernels import gaussian_kernel

__all__ = ["separable_factors", "convolve_axis", "separable_convolve_fn",
           "make_blur_operators", "make_normal_blur_operator",
           "blur_factors"]

_NOT_PORTED = ("only the separable (diagonal-covariance) blur is ported; "
               "see ROADMAP %s" % ROADMAP_NON_SEPARABLE)


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
    """float64 per-array-axis factors of the Gaussian blur; raises
    ``NotImplementedError`` for a non-separable (full) covariance."""
    factors = separable_factors(gaussian_kernel(
        cov, alpha_cut=alpha_cut, spacing=spacing, dtype=np.float64))
    if factors is None:
        raise NotImplementedError(_NOT_PORTED)
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


def make_normal_blur_operator(cov, alpha_cut=3, spacing=None):
    """``AᵀA`` of the wrap Gaussian blur as ONE separable convolution with
    the self-correlated factors ``np.convolve(f, f[::-1])``."""
    factors = blur_factors(cov, alpha_cut, spacing)
    auto = [np.convolve(f, f[::-1]) for f in factors]
    return separable_convolve_fn(auto)


def make_blur_operators(cov, alpha_cut=3, spacing=None, method="auto",
                        dtype=np.float64):
    """Gaussian blurring operator pair ``(A, A_adj)``; ``A_adj = A`` because
    the stencil is symmetric (nsol/linear_operators.py:63).

    ``method``: "separable", or "auto" (separable when the covariance is
    diagonal). "fft", "direct" and "matmul" are not ported.
    """
    if method not in ("auto", "separable"):
        raise NotImplementedError("method=%r: %s" % (method, _NOT_PORTED))
    factors = [f.astype(dtype) for f in blur_factors(cov, alpha_cut,
                                                     spacing)]
    A = separable_convolve_fn(factors)
    return A, A
