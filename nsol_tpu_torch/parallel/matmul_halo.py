"""Halo'd per-axis sharded operators (counterpart of
``nsol_tpu/parallel/matmul_halo.py``).

The reference computes these as band and circulant matrix products, a form
chosen for the TPU's matrix unit. The port keeps the public names and the
float result, not the form: on a block sharded along axis 0 each is a ring
or plane halo exchange along the sharded axis and per-axis convolutions
(``nsol_tpu_torch.ops.conv.convolve_axis``) on the complete local axes.
``band_matrix`` is not ported. These are the operators of
``sharded_tv_admm_solve(use_blocked=False)``, and its ``Aᵀb``.
"""

import numpy as np
import torch

from nsol_tpu_torch.ops import grad as G
from nsol_tpu_torch.ops.conv import blur_factors
from nsol_tpu_torch.parallel.halo import (
    _mesh_or_single, exchange_plane_down, exchange_plane_up,
    separable_halo_apply)

__all__ = ["make_sharded_matmul_blur_operators",
           "make_sharded_matmul_normal_blur_operator",
           "make_sharded_matmul_gradient_normal"]


def _require_shape(local_shape):
    if local_shape is None:
        raise ValueError("sharded matmul path requires a static local shape")


def make_sharded_matmul_blur_operators(cov, alpha_cut=3, spacing=None,
                                       local_shape=None, mesh=None,
                                       dtype=np.float32):
    """Gaussian blur pair ``(A, A)`` of a block sharded along axis 0 (a
    diagonal covariance; the stencil is symmetric)."""
    _require_shape(local_shape)
    A = separable_halo_apply(blur_factors(cov, alpha_cut, spacing),
                             _mesh_or_single(mesh))
    return A, A


def make_sharded_matmul_normal_blur_operator(cov, alpha_cut=3, spacing=None,
                                             local_shape=None, mesh=None,
                                             dtype=np.float32):
    """``AᵀA`` of a block sharded along axis 0: one separable pass with the
    self-correlated factors ``np.convolve(f, f[::-1])``."""
    _require_shape(local_shape)
    auto = [np.convolve(f, f[::-1])
            for f in blur_factors(cov, alpha_cut, spacing)]
    return separable_halo_apply(auto, _mesh_or_single(mesh))


def make_sharded_matmul_gradient_normal(local_shape, spacing=None, mesh=None,
                                        dtype=np.float32):
    """``DᵀD`` of a block sharded along axis 0, equal on the assembled
    volume to :func:`nsol_tpu_torch.ops.grad.gradient_normal`: the local
    axes as there; the sharded axis as the interior stencil
    ``(2x[k] − x[k−1] − x[k+1])/h²`` on the 1-plane halo'd block, whose
    zeros at the global ends give the last global row ``2x[n−1] − x[n−2]``,
    and the first global row corrected to ``x[0] − x[1]`` on rank 0
    (``matmul_halo.py:133-172``)."""
    ndim = len(local_shape)
    s = G._spacing_array(spacing, ndim)
    inv_h2 = [1.0 / float(s[ndim - 1 - ax]) ** 2 for ax in range(ndim)]
    mesh = _mesh_or_single(mesh)

    def apply(x):
        prev = exchange_plane_down(x, mesh)
        nxt = exchange_plane_up(x, mesh)
        t = 2.0 * x - torch.cat([prev, x[:-1]], dim=0) \
            - torch.cat([x[1:], nxt], dim=0)
        if mesh.rank == 0:
            t = torch.cat([t[:1] - x[:1], t[1:]], dim=0)
        out = t * inv_h2[0]
        for ax in range(1, ndim):
            out = out + G.second_difference(x, ax) * inv_h2[ax]
        return out

    return apply
