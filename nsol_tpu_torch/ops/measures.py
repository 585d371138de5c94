"""Similarity / dissimilarity measures (counterpart of
``nsol_tpu/ops/measures.py``; reference: nsol/similarity_measures.py:25-290).

Every measure is a function of two tensors of one shape (``x`` and the
reference ``x_ref``) returning a 0-dim tensor on their device, so that the
study engine and the observer can evaluate them on the iterates where they
lie.

SSIM follows the JAX package's own form (the reference defers to
``skimage.measure.compare_ssim``, which is absent here): a uniform window
of 7 per axis over the valid region, sample covariance normalization
(ddof = 1), K1 = 0.01, K2 = 0.03, ``data_range`` by default the reference
image's value range. The window mean is a separable box sum, so no
convolution library (and no TF32 on the card) is involved.

The histograms of the entropy measures bin as ``jnp.histogram`` /
``jnp.histogram2d`` do: a value is in bin ``k`` when ``edge[k] ≤ v <
edge[k+1]``, the maximum in the last bin. The ``bins + 1`` edges from
``min`` to ``max`` are the values the JAX package's ``linspace`` gives on
its CPU backend, ``fma(k, max·r, min·(1 − k·r))`` with ``r = 1/bins``
rounded (XLA's rewrite of ``min·(1 − k/bins) + max·k/bins``), formed on
the host exactly: an integer-valued image (PNG data) has many values on
an edge, and an edge one ulp off moves all of them to the next bin.
"""

from fractions import Fraction

import numpy as np
import torch

__all__ = [
    "sum_of_absolute_differences", "mean_absolute_error",
    "sum_of_squared_differences", "mean_squared_error",
    "root_mean_square_error", "peak_signal_to_noise_ratio",
    "normalized_cross_correlation", "structural_similarity",
    "shannon_entropy", "joint_entropy", "mutual_information",
    "normalized_mutual_information", "dice_score",
    "SIMILARITY_MEASURES", "UNDEF", "get_measure",
]


def sum_of_absolute_differences(x, x_ref):
    """Σ|x − x_ref| (reference: nsol/similarity_measures.py:25-29)."""
    return torch.sum(torch.abs(x - x_ref))


def mean_absolute_error(x, x_ref):
    return sum_of_absolute_differences(x, x_ref) / x.numel()


def sum_of_squared_differences(x, x_ref):
    return torch.sum(torch.square(x - x_ref))


def mean_squared_error(x, x_ref):
    return sum_of_squared_differences(x, x_ref) / x.numel()


def root_mean_square_error(x, x_ref):
    return torch.sqrt(mean_squared_error(x, x_ref))


def peak_signal_to_noise_ratio(x, x_ref):
    """``10·log10(max(x_ref)² / MSE)`` (reference: :98-101; +∞ for
    ``x == x_ref``)."""
    return 10.0 * torch.log10(torch.max(x_ref) ** 2
                              / mean_squared_error(x, x_ref))


def normalized_cross_correlation(x, x_ref):
    """NCC with ddof = 1 std normalization (reference: :112-120)."""
    xc = x - torch.mean(x)
    rc = x_ref - torch.mean(x_ref)
    n = x.numel()
    std_x = torch.sqrt(torch.sum(xc * xc) / (n - 1))
    std_r = torch.sqrt(torch.sum(rc * rc) / (n - 1))
    return torch.sum(xc * rc) / (n * std_x * std_r)


def _uniform_filter(x, win):
    """Mean over a ``win``-wide window on every axis, valid region only."""
    for axis in range(x.dim()):
        x = x.unfold(axis, win, 1).sum(-1) / win
    return x


def structural_similarity(x, x_ref, data_range=None, win_size=7, K1=0.01,
                          K2=0.03):
    """Mean SSIM over a uniform ``win_size`` window (Wang et al. 2004),
    the JAX package's form of the reference's skimage call
    (nsol/similarity_measures.py:134-136)."""
    if min(x.shape) < win_size:  # no valid window: the mean of nothing
        return torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    if data_range is None:
        data_range = torch.max(x_ref) - torch.min(x_ref)
    NP = win_size ** x.dim()
    cov_norm = NP / (NP - 1.0)
    ux = _uniform_filter(x, win_size)
    uy = _uniform_filter(x_ref, win_size)
    uxx = _uniform_filter(x * x, win_size)
    uyy = _uniform_filter(x_ref * x_ref, win_size)
    uxy = _uniform_filter(x * x_ref, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    num = (2.0 * ux * uy + C1) * (2.0 * vxy + C2)
    den = (ux * ux + uy * uy + C1) * (vx + vy + C2)
    return torch.mean(num / den)


def _edges(lo, hi, bins, dtype):
    """The ``bins + 1`` histogram edges from ``lo`` to ``hi`` (numpy
    scalars of ``dtype``) as the JAX package forms them (module note)."""
    if lo == hi:
        lo, hi = lo - dtype(0.5), hi + dtype(0.5)
    r = dtype(1.0) / dtype(bins)
    hr = hi * r
    out = []
    for k in range(bins):
        kk = dtype(k)
        head = lo * (dtype(1.0) - kk * r)
        out.append(dtype(float(Fraction(int(k)) * Fraction(float(hr))
                               + Fraction(float(head)))))
    return np.array(out + [hi], dtype=dtype)


def _bin_index(v, bins):
    """Bin (0 .. bins−1) of every value of the flat ``v``, as
    ``jnp.histogram`` bins it."""
    dtype = torch.empty(0, dtype=v.dtype).numpy().dtype.type
    edges = torch.as_tensor(
        _edges(dtype(torch.min(v).item()), dtype(torch.max(v).item()), bins,
               dtype), device=v.device)
    idx = torch.searchsorted(edges, v, right=True)
    idx = torch.where(v == edges[-1], torch.full_like(idx, bins), idx)
    return idx - 1


def _entropy_from_counts(counts, dtype):
    prob = counts.to(dtype) / torch.sum(counts)
    p = torch.where(prob > 0, prob, torch.ones_like(prob))
    return -torch.sum(torch.where(prob > 0, prob * torch.log(p),
                                  torch.zeros_like(prob)))


def shannon_entropy(x, bins=100):
    """H(X) from a ``bins``-bin histogram (reference: :153-164)."""
    counts = torch.bincount(_bin_index(x.reshape(-1), bins), minlength=bins)
    return _entropy_from_counts(counts, x.dtype)


def joint_entropy(x, x_ref, bins=100):
    """H(X, Y) from a 2-D histogram (reference: :181-191)."""
    ij = _bin_index(x.reshape(-1), bins) * bins \
        + _bin_index(x_ref.reshape(-1), bins)
    counts = torch.bincount(ij, minlength=bins * bins)
    return _entropy_from_counts(counts, x.dtype)


def mutual_information(x, x_ref, bins=100):
    """MI = H(X) + H(Y) − H(X, Y) (reference: :212-217)."""
    return (shannon_entropy(x, bins) + shannon_entropy(x_ref, bins)
            - joint_entropy(x, x_ref, bins))


def normalized_mutual_information(x, x_ref, bins=100):
    """NMI = (H(X) + H(Y)) / H(X, Y) (reference: :234-239)."""
    return ((shannon_entropy(x, bins) + shannon_entropy(x_ref, bins))
            / joint_entropy(x, x_ref, bins))


def dice_score(x, x_ref):
    """Dice coefficient of two masks, in float32 as the JAX package
    computes it (reference: :254-264)."""
    x = x.to(torch.float32)
    x_ref = x_ref.to(torch.float32)
    return 2.0 * torch.sum(x * x_ref) / (torch.sum(x) + torch.sum(x_ref))


#: the reference's ``SimilarityMeasures.similarity_measures``
#: (nsol/similarity_measures.py:267-277)
SIMILARITY_MEASURES = {
    "SSD": sum_of_squared_differences,
    "MAE": mean_absolute_error,
    "MSE": mean_squared_error,
    "RMSE": root_mean_square_error,
    "PSNR": peak_signal_to_noise_ratio,
    "SSIM": structural_similarity,
    "NCC": normalized_cross_correlation,
    "MI": mutual_information,
    "NMI": normalized_mutual_information,
}

#: NaN for every measure of an undefined state
#: (reference: nsol/similarity_measures.py:280-290)
UNDEF = {k: np.nan for k in SIMILARITY_MEASURES}


def get_measure(name):
    return SIMILARITY_MEASURES[name]
