"""Sharding composed with the per-shard CUDA units (counterpart of
``nsol_tpu/parallel/blocked_halo.py``).

Each rank runs the prepadded window units of K9b — ``normal_apply_prepadded``
(``csrc/tiled.cu``'s one-pass march over the window where its taps fit,
else ``csrc/admm.cu``'s three passes) and ``csrc/robust.cu``'s
``blur_apply_prepadded`` / ``weighted_apply_prepadded`` — on its own
z-slab, its wrap halos brought by the ring exchange
(:func:`nsol_tpu_torch.parallel.halo.exchange_halo_wrap`) and its global
row offset ``row0 = rank·Zl`` (the reference's ``axis_index·Zl``) placing
the Laplacian's zero-boundary rows. The CG dots are all-reduced by the
solver (``Mesh.reduce``). On a CPU tensor the units run their plain
versions.
"""

import numpy as np

from nsol_tpu_torch.ops.cuda import blocked as B
from nsol_tpu_torch.ops.cuda import robust as R
from nsol_tpu_torch.parallel.halo import _mesh_or_single, exchange_halo_wrap

__all__ = ["make_sharded_blocked_normal_operator",
           "make_sharded_blocked_robust_operators"]


def make_sharded_blocked_normal_operator(local_shape, cov, alpha_cut=3,
                                         spacing=None, mesh=None,
                                         dtype=np.float32, precision=None,
                                         block=None, interpret=False):
    """``apply(v, rho) -> (AᵀA + ρ·DᵀD) v`` for z-sharded volumes, each
    rank's apply one :func:`~nsol_tpu_torch.ops.cuda.blocked.
    normal_apply_prepadded` over its halo'd slab. ``local_shape`` is the
    rank's ``(Z/n, Y, X)``; ``apply`` plugs into the ``normal_M`` hook of
    ``tikhonov_solve`` / ``admm_solve``. ``dtype``, ``precision``,
    ``block`` and ``interpret`` as in
    :func:`~nsol_tpu_torch.ops.cuda.blocked.
    make_blocked_normal_operator_prepadded`."""
    mesh = _mesh_or_single(mesh)
    zl = int(local_shape[0])
    ap = B.make_blocked_normal_operator_prepadded(
        tuple(local_shape), cov, alpha_cut, spacing, z_total=zl * mesh.size,
        block=block, dtype=dtype,
        precision="HIGHEST" if precision is None else precision,
        interpret=interpret)
    r = ap.halo

    def apply(v, rho):
        return ap(exchange_halo_wrap(v, mesh, r, r), rho, mesh.rank * zl)

    apply.halo = r
    apply.block = ap.block
    return apply


def make_sharded_blocked_robust_operators(local_shape, cov, alpha_cut=3,
                                          spacing=None, mesh=None,
                                          dtype=np.float32, precision=None,
                                          interpret=False, io_dtype=None):
    """Sharded forms of the robust window units: ``(blur, grad_W,
    normal_W)`` with ``blur(x) -> A x`` (the residual of each sweep),
    ``grad_W(x, wr, alpha) -> Aᵀ(wr) + α·DᵀD x`` (the IRLS gradient) and
    ``normal_W(vf, wts, alpha) -> Aᵀ(wts·A vf) + α·DᵀD vf`` (the inner CG's
    apply) — the ``A``/``grad_W``/``normal_W`` hooks of
    ``admm_solve(minimizer="irls")``. ``io_dtype=bfloat16`` (the compact
    io of ``nsol_tpu/parallel/blocked_halo.py:115-119``): ``normal_W``
    takes its halo'd windows as bfloat16 and returns bfloat16 (float32
    sums, ``weighted_apply_prepadded``'s "io" instance); the residual and
    gradient units stay float32, as there."""
    mesh = _mesh_or_single(mesh)
    local_shape = tuple(local_shape)
    zl = int(local_shape[0])
    kw = dict(alpha_cut=alpha_cut, spacing=spacing, dtype=dtype,
              precision="HIGHEST" if precision is None else precision,
              interpret=interpret, prepadded=True, z_total=zl * mesh.size)
    blur_p = R.make_blocked_blur_operator(local_shape, cov, **kw)
    blur_lap_p = R.make_blocked_blur_operator(local_shape, cov,
                                              with_lap=True, **kw)
    wnormal_p = R.make_blocked_weighted_normal_operator(
        local_shape, cov, io_dtype=io_dtype, **kw)
    row0 = mesh.rank * zl

    def _ext(v, r):
        return exchange_halo_wrap(v, mesh, r, r)

    def blur(x):
        return blur_p(_ext(x, blur_p.halo))

    def grad_W(x, wr, alpha):
        rb = blur_lap_p.halo
        return blur_lap_p(_ext(wr, rb), _ext(x, rb), alpha, row0)

    def normal_W(vf, wts, alpha):
        rw = wnormal_p.halo
        return wnormal_p(_ext(vf, rw), _ext(wts, rw), alpha, row0)

    return blur, grad_W, normal_W
