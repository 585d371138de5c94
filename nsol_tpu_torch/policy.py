"""Storage precision and route of the TV deconvolution and of the study
sweeps, resolved once: the reference's choice
(``nsol_tpu/cli/run_deconvolution.py:140-220``,
``nsol_tpu/solvers/wrappers.py:284-292,548-558``) in one place.

On an accelerator the reference runs its ADMM TV solves in compact
storage by default. Linear loss: the fused solve with ``precision="high3",
compact_dirs=True`` where the fused kernel fits (:func:`fused_fits`), and
past that, for 3-D volumes, ``blocked_admm_solve`` with
``compact_dirs=True`` — or ``state_dtype=bfloat16`` under
``NSOL_TPU_COMPACT=1``. Robust loss: the fused robust solve with
``precision="high3", compact_dirs=True`` where it fits, and past that, for
3-D volumes, ``blocked_robust_admm_solve(compact_dirs=True)``
(``NSOL_TPU_COMPACT`` has no meaning there). The batched study sweeps
(Tikhonov and ADMM, whose fused kernels it runs where they fit) build
with ``precision="high3", compact_dirs=True``. ``NSOL_TPU_EXACT=1`` is the
way back to all-f32. Its CPU path is exact f32 throughout, and so is its
generic path for a 2-D image past :func:`fused_fits`.

The primal-dual denoising solve is exact f32 by default everywhere. Its
bf16 state (``compact=True``) is opt-in, as in the reference: under
``NSOL_TPU_COMPACT=1``, on cuda, where the reference would take its fused
PD kernel (:func:`fused_pd_fits`) and no observer records the iterates
(:func:`pd_options`).

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
from nsol_tpu_torch.ops.cuda import robust as R

__all__ = ["STATE_VOLUMES", "PD_STATE_VOLUMES", "VMEM_BUDGET_BYTES",
           "fused_fits", "fused_pd_fits", "pick_route", "storage_options",
           "sweep_options", "pd_options", "tvl2_solver"]

#: the fused TPU solve's working set, in volumes, and the budget it must
#: fit (``nsol_tpu/ops/pallas/fused.py:56-63``, ``fused_admm_fits_vmem``)
STATE_VOLUMES = 16
VMEM_BUDGET_BYTES = 64 * 1024 * 1024
#: the fused TPU primal-dual solve's working set, in volumes
#: (``fused.py:909``, ``_PD_STATE_VOLUMES``)
PD_STATE_VOLUMES = 12

#: the compact storage of the fused solves (linear, robust, Tikhonov)
_FUSED_COMPACT = {"precision": "high3", "compact_dirs": True}


def _on(env, key):
    return env.get(key) == "1"


def _cuda(device):
    return str(device).split(":")[0] == "cuda"


def fused_fits(shape, itemsize=4):
    """The reference's ``fused_admm_fits_vmem``: 16 float32 volumes of
    ``shape`` within 64 MiB (at most 1,048,576 voxels)."""
    return STATE_VOLUMES * int(np.prod(shape)) * itemsize \
        <= VMEM_BUDGET_BYTES


def fused_pd_fits(shape, itemsize=4):
    """The reference's ``fused_pd_fits_vmem`` (``fused.py:912-915``): 12
    float32 volumes of ``shape`` within 64 MiB (at most 1,398,101
    voxels: 1024² fits, 256³ does not)."""
    return PD_STATE_VOLUMES * int(np.prod(shape)) * itemsize \
        <= VMEM_BUDGET_BYTES


def pick_route(shape, cov, alpha_cut=3, spacing=None, data_loss="linear"):
    """``(route, mode)`` of the TV solve as the reference picks it:
    ``("fused", None)`` where :func:`fused_fits`, and for a 2-D image past
    it too (in exact f32, :func:`storage_options`: the reference's XLA
    path there is f32). For a 3-D volume past it, with the linear loss
    ``("blocked", "apply")`` where
    :func:`~nsol_tpu_torch.ops.cuda.blocked.takes_zy_route` holds (the
    512-wide planes), else ``("blocked", "step")``; with a robust loss
    ``("blocked", None)``: ``blocked_robust_admm_solve``, which picks its
    per-axis or tiled units itself."""
    shape = tuple(shape)
    if fused_fits(shape) or len(shape) != 3:
        return "fused", None
    if data_loss != "linear":
        return "blocked", None
    if B.takes_zy_route(shape, cov, alpha_cut, spacing):
        return "blocked", "apply"
    return "blocked", "step"


def storage_options(route, shape, device, env=os.environ,
                    data_loss="linear"):
    """The storage keyword arguments of the reference CLI's choice for the
    TV ``route`` (:func:`pick_route`) on ``device``: ``"fused"`` →
    ``{"precision": "high3", "compact_dirs": True}``; ``"blocked"`` →
    ``{"compact_dirs": True}``, or for the linear loss
    ``{"state_dtype": torch.bfloat16}`` with ``NSOL_TPU_COMPACT == "1"``
    (which, as in the reference, wins over ``NSOL_TPU_EXACT`` there).
    ``{}`` — the exact f32 solve — with ``NSOL_TPU_EXACT == "1"``, on the
    CPU, and for a 2-D ``"fused"`` shape past :func:`fused_fits`."""
    import torch

    if not _cuda(device):
        return {}
    if route == "blocked":
        if data_loss == "linear" and _on(env, "NSOL_TPU_COMPACT"):
            return {"state_dtype": torch.bfloat16}
        return {} if _on(env, "NSOL_TPU_EXACT") else {"compact_dirs": True}
    if _on(env, "NSOL_TPU_EXACT") or not fused_fits(shape):
        return {}
    return dict(_FUSED_COMPACT)


def sweep_options(shape, device, env=os.environ):
    """The storage keyword arguments of a batched study sweep's fused
    solve (the reference's ``fast_kw``, ``wrappers.py:284-292,548-558``):
    ``{"precision": "high3", "compact_dirs": True}`` on cuda; ``{}`` on
    the CPU, with ``NSOL_TPU_EXACT == "1"``, and past :func:`fused_fits`,
    where the reference's sweep leaves its fused kernels for its f32 path."""
    if not _cuda(device) or _on(env, "NSOL_TPU_EXACT") \
            or not fused_fits(shape):
        return {}
    return dict(_FUSED_COMPACT)


def pd_options(shape, device, env=os.environ, observer=False):
    """The storage keyword arguments of the fused primal-dual denoising
    solve of ``shape`` on ``device``: ``{"compact": True}`` (x, x̄ and p
    stored in bfloat16) only on cuda with ``NSOL_TPU_COMPACT == "1"``
    where the reference takes its fused PD kernel (:func:`fused_pd_fits`)
    and no ``observer`` records the iterates (``cli/run_denoising.py:86-
    103``, ``solvers/wrappers.py:727-773``); ``{}`` — exact f32 — in every
    other case. It is never a default: the iterate itself carries the
    rounding (the study's L-curve reads its records)."""
    if (_cuda(device) and _on(env, "NSOL_TPU_COMPACT")
            and fused_pd_fits(shape) and not observer):
        return {"compact": True}
    return {}


def tvl2_solver(shape, cov, spacing, device, iterations, iter_max,
                data_loss="linear", irls_cg_iters=8, env=os.environ):
    """``(build, kwargs)`` of the ADMM TV deconvolution of ``shape``: the
    factory of :func:`pick_route`'s route
    (:func:`~nsol_tpu_torch.ops.cuda.fused.make_fused_admm_solver`,
    :func:`~nsol_tpu_torch.ops.cuda.blocked.blocked_admm_solve` or, with a
    robust ``data_loss``,
    :func:`~nsol_tpu_torch.ops.cuda.robust.blocked_robust_admm_solve`) and
    its keyword arguments, storage from :func:`storage_options`.
    ``build(**kwargs)`` returns ``solve(b, x0, alpha, rho)`` (a robust
    solve also takes ``data_loss_scale=``)."""
    route, mode = pick_route(shape, cov, spacing=spacing, data_loss=data_loss)
    kwargs = dict(shape=tuple(shape), cov=cov, spacing=spacing,
                  iterations=iterations, iter_max=iter_max,
                  **storage_options(route, shape, device, env, data_loss))
    if data_loss != "linear":
        kwargs.update(data_loss=data_loss, irls_cg_iters=irls_cg_iters)
        build = R.blocked_robust_admm_solve if route == "blocked" \
            else F.make_fused_admm_solver
        return build, kwargs
    if route == "blocked":
        return B.blocked_admm_solve, dict(kwargs, mode=mode)
    return F.make_fused_admm_solver, kwargs
