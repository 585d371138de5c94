"""Storage precision and route of the TV-L2 deconvolution, resolved once:
the reference CLI's choice (``nsol_tpu/cli/run_deconvolution.py:140-220``)
in one place.

On an accelerator the reference runs its ADMM TV-L2 solves in compact
storage by default: the fused solve with ``precision="high3",
compact_dirs=True`` where the fused kernel fits (:func:`fused_fits`), and
past that, for 3-D volumes, ``blocked_admm_solve`` with
``compact_dirs=True`` — or ``state_dtype=bfloat16`` under
``NSOL_TPU_COMPACT=1``. ``NSOL_TPU_EXACT=1`` is the way back to all-f32.
Its CPU path is exact f32 throughout.

The environment switches are on for the string ``"1"`` only: ``"0"``, an
empty string or any other value leaves them off. The reference tests them
for truthiness (``NSOL_TPU_EXACT=0`` switches it on there, its fault R2,
``solvers/wrappers.py:764``, ``cli/run_denoising.py:103``); the port does
not copy that.
"""

import os

import numpy as np

from nsol_tpu_torch.ops.cuda import blocked as B
from nsol_tpu_torch.ops.cuda import fused as F

__all__ = ["STATE_VOLUMES", "VMEM_BUDGET_BYTES", "fused_fits", "pick_route",
           "storage_options", "tvl2_linear_solver"]

#: the fused TPU solve's working set, in volumes, and the budget it must
#: fit (``nsol_tpu/ops/pallas/fused.py:56-63``, ``fused_admm_fits_vmem``)
STATE_VOLUMES = 16
VMEM_BUDGET_BYTES = 64 * 1024 * 1024


def _on(env, key):
    return env.get(key) == "1"


def fused_fits(shape, itemsize=4):
    """The reference's ``fused_admm_fits_vmem``: 16 float32 volumes of
    ``shape`` within 64 MiB (at most 1,048,576 voxels)."""
    return STATE_VOLUMES * int(np.prod(shape)) * itemsize \
        <= VMEM_BUDGET_BYTES


def pick_route(shape, cov, alpha_cut=3, spacing=None):
    """``(route, mode)`` of the linear TV-L2 solve as the reference picks
    it: ``("fused", None)`` where :func:`fused_fits`; for a 3-D volume
    past it ``("blocked", "apply")`` where
    :func:`~nsol_tpu_torch.ops.cuda.blocked.takes_zy_route` holds (the
    512-wide planes), else ``("blocked", "step")``; a 2-D image past it
    ``("fused", None)`` as well, in exact f32 (:func:`storage_options`:
    the reference's XLA path there is f32)."""
    shape = tuple(shape)
    if fused_fits(shape) or len(shape) != 3:
        return "fused", None
    if B.takes_zy_route(shape, cov, alpha_cut, spacing):
        return "blocked", "apply"
    return "blocked", "step"


def storage_options(route, shape, device, env=os.environ):
    """The storage keyword arguments of the reference CLI's choice for
    the linear TV-L2 ``route`` (:func:`pick_route`) on ``device``:
    ``"fused"`` → ``{"precision": "high3", "compact_dirs": True}``;
    ``"blocked"`` → ``{"compact_dirs": True}``, or
    ``{"state_dtype": torch.bfloat16}`` with ``NSOL_TPU_COMPACT == "1"``
    (which, as in the reference, wins over ``NSOL_TPU_EXACT`` there).
    ``{}`` — the exact f32 solve — with ``NSOL_TPU_EXACT == "1"``, on the
    CPU, and for a 2-D ``"fused"`` shape past :func:`fused_fits`."""
    import torch

    if str(device).split(":")[0] != "cuda":
        return {}
    if route == "blocked":
        if _on(env, "NSOL_TPU_COMPACT"):
            return {"state_dtype": torch.bfloat16}
        return {} if _on(env, "NSOL_TPU_EXACT") else {"compact_dirs": True}
    if _on(env, "NSOL_TPU_EXACT") or not fused_fits(shape):
        return {}
    return {"precision": "high3", "compact_dirs": True}


def tvl2_linear_solver(shape, cov, spacing, device, iterations, iter_max,
                       env=os.environ):
    """``(build, kwargs)`` of the linear ADMM TV-L2 solve of ``shape``: the
    factory of :func:`pick_route`'s route
    (:func:`~nsol_tpu_torch.ops.cuda.fused.make_fused_admm_solver` or
    :func:`~nsol_tpu_torch.ops.cuda.blocked.blocked_admm_solve`) and its
    keyword arguments, storage from :func:`storage_options`.
    ``build(**kwargs)`` returns ``solve(b, x0, alpha, rho)``."""
    route, mode = pick_route(shape, cov, spacing=spacing)
    kwargs = dict(shape=tuple(shape), cov=cov, spacing=spacing,
                  iterations=iterations, iter_max=iter_max,
                  **storage_options(route, shape, device, env))
    if route == "blocked":
        return B.blocked_admm_solve, dict(kwargs, mode=mode)
    return F.make_fused_admm_solver, kwargs
