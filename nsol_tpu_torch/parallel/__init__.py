"""Distribution layer over ``torch.distributed`` (counterpart of
``nsol_tpu/parallel/``), one process per GPU: the ``"space"`` mesh with its
halo-exchange stencils (separable or a full covariance's direct blur;
differentiable) and all-reduced solvers (``cg``, ``irls``, ``lsmr``, the box
L-BFGS), and the ``"batch"`` mesh of the solver classes'
``run_sweep(mesh=...)``. ``band_matrix`` (a TPU matrix form) is not
ported."""

from nsol_tpu_torch.parallel.halo import (
    exchange_plane_up, exchange_plane_down, exchange_halo_wrap,
    make_sharded_gradient_operators, make_sharded_blur_operators,
)
from nsol_tpu_torch.parallel.matmul_halo import (
    make_sharded_matmul_blur_operators,
    make_sharded_matmul_normal_blur_operator,
    make_sharded_matmul_gradient_normal,
)
from nsol_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, make_space_mesh, sharded_tv_admm_solve,
    sharded_tv_denoise_solve,
)
from nsol_tpu_torch.parallel import distributed

__all__ = [
    "distributed", "Mesh",
    "exchange_plane_up", "exchange_plane_down", "exchange_halo_wrap",
    "make_sharded_gradient_operators", "make_sharded_blur_operators",
    "make_sharded_matmul_blur_operators",
    "make_sharded_matmul_normal_blur_operator",
    "make_sharded_matmul_gradient_normal",
    "make_mesh", "make_space_mesh", "sharded_tv_admm_solve",
    "sharded_tv_denoise_solve",
]
