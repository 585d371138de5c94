"""Concrete solver classes: Tikhonov, ADMM and primal-dual (counterpart of
``nsol_tpu/solvers/wrappers.py``).

Reference-parity class surface over the functional cores. The operators
``A``, ``B`` (and the optional fused normal operators) are callables on
tensors of the solver's ``device``; ``B`` for TV is the stacked
``(d, *shape)`` gradient. ``run()`` solves one configuration through
:func:`~nsol_tpu_torch.solvers.tikhonov.tikhonov_solve` or
:func:`~nsol_tpu_torch.solvers.admm.admm_solve`; on CUDA, when the
separable-blur hint holds, the CUDA kernel units plug into them through
the ``normal_M``/``normal_W``/``grad_W`` hooks.

``run_sweep`` solves a grid of configurations, the study engine's fast
path. Inside the fused kernels' scope (the separable-blur hint, ``b_reg =
0``, bounds ``(0, ∞)``, the resolved minimizer ``cg`` for the linear loss
and ``irls`` for a robust one, and for ADMM measures ⊆ {Reg, Data}) it runs
the whole solves of :mod:`nsol_tpu_torch.ops.cuda.tikhonov` and
:mod:`nsol_tpu_torch.ops.cuda.fused`: on CUDA their kernels (a failure to
build or launch raises), on the CPU their plain versions. Outside it,
the generic cores, one configuration after the other. The fused solves
build with :func:`nsol_tpu_torch.policy.sweep_options`, the reference's
batched-sweep storage: compact CG directions on CUDA where the fused
kernel fits, exact f32 on the CPU or with ``NSOL_TPU_EXACT=1``.

:class:`PrimalDualSolver` runs one configuration through
:func:`~nsol_tpu_torch.solvers.primal_dual.primal_dual_solve` with its
prox closures. Its ``run_sweep`` takes the fused denoising solve of
:func:`~nsol_tpu_torch.ops.cuda.fused.make_fused_pd_denoise_solver` (the
kernels of ``csrc/pd.cu`` on CUDA, their plain versions on the CPU) by
explicit criteria — one of the four denoising types named by the
``reconstruction_type`` hint, the kernel-scale ``observation`` given, a
2-D/3-D image, measures ⊆ {Reg, Data} —, with its storage from
:func:`nsol_tpu_torch.policy.pd_options` (bf16 state only under
``NSOL_TPU_COMPACT=1`` where the reference's fused kernel would run), and
the generic solve outside them. Unlike the reference (``wrappers.py:
764,787-791``, faults R1 and R2) it reads the environment through the
policy and never falls back from a failed kernel.

The reference holds the whole grid's results on the device at once
(``nsol_tpu/study/engine.py:219``, reference fault R4). Here a sweep holds
at most :data:`SWEEP_BUDGET_BYTES` of results on the device and copies each
chunk to the host before it solves the next.
"""

import numpy as np
import torch

from nsol_tpu_torch import policy
from nsol_tpu_torch.defaults import ROADMAP_BATCH_MESH, not_ported
from nsol_tpu_torch.ops import conv as C
from nsol_tpu_torch.ops import grad as G
from nsol_tpu_torch.ops.cuda import blocked as _B
from nsol_tpu_torch.ops.cuda import fused as _fused
from nsol_tpu_torch.ops.cuda import robust as _R
from nsol_tpu_torch.ops.cuda import tikhonov as _T
from nsol_tpu_torch.ops.priors import HUBER_PRIOR_GAMMA
from nsol_tpu_torch.solvers import admm as _admm
from nsol_tpu_torch.solvers import primal_dual as _pd
from nsol_tpu_torch.solvers import tikhonov as _tik
from nsol_tpu_torch.solvers.base import LinearSolver, Solver, _numpy

__all__ = ["TikhonovLinearSolver", "ADMMLinearSolver", "PrimalDualSolver",
           "SWEEP_BUDGET_BYTES", "kernel_hooks"]

#: the most bytes of a sweep's results (the solutions ``x``) held on the
#: device at once; larger grids run in chunks copied to the host one by one
SWEEP_BUDGET_BYTES = 1 << 30


def _make_record_fn(measures, x_scale):
    """``x -> {name: scalar}`` evaluating observer measures on the
    rescaled iterate (observers see ``get_x()`` units,
    nsol/solver.py:117-118)."""
    if not measures:
        return None

    def record(x):
        xs = x * x_scale
        return {name: fn(xs) for name, fn in measures.items()}

    return record


def _chunks(n, shape, itemsize):
    """Index ranges of at most ``SWEEP_BUDGET_BYTES`` of results each."""
    per = max(1, SWEEP_BUDGET_BYTES // max(1, int(np.prod(shape)) * itemsize))
    return [range(i, min(n, i + per)) for i in range(0, n, per)]


def _not_sharded(mesh):
    if mesh is not None:
        raise not_ported("run_sweep(mesh=...)", ROADMAP_BATCH_MESH)


def _stack_records(rows):
    """A list of per-configuration ``{name: (k values)}`` → ``{name:
    (n, k) numpy}``, stacked on the device and copied once per name."""
    if not rows:
        return None
    return {k: _numpy(torch.stack([torch.stack([torch.as_tensor(v)
                                                for v in r[k]])
                                   for r in rows]))
            for k in rows[0]}


def kernel_hooks(st, reg):
    """The ``normal_M``/``normal_W``/``grad_W`` hooks of ``tikhonov_solve``
    through the CUDA units for the stencils ``st`` (a
    :class:`~nsol_tpu_torch.ops.cuda.blocked.Stencils`) and the
    regulariser ``reg`` ("TK1" or "TK0"):
    :func:`~nsol_tpu_torch.ops.cuda.blocked.normal_apply`,
    :func:`~nsol_tpu_torch.ops.cuda.robust.weighted_apply`,
    :func:`~nsol_tpu_torch.ops.cuda.robust.blur_apply`."""
    def normal_M(v, a):
        return _B.normal_apply(v, st.normal, st.inv_h2, float(a), reg=reg)

    def normal_W(vf, wts, a):
        return _R.weighted_apply(vf, None, None, wts,
                                 _B.new_scalars(vf.device), st.blur,
                                 st.inv_h2, float(a), first=True,
                                 reg=reg)[1]

    def grad_W(x, wr, a):
        return _R.blur_apply(wr, st.blur, st.inv_h2, x, float(a), reg=reg)

    return {"normal_M": normal_M, "normal_W": normal_W, "grad_W": grad_W}


class _HintedSolver(LinearSolver):
    """The separable-blur hint shared by both classes: the fused normal
    operators built from it, and on CUDA the kernel-unit hooks."""

    def _init_hints(self, normal_A, normal_B, irls_cg_iters, blur_cov,
                    spacing):
        self._normal_A = normal_A
        self._normal_B = normal_B
        self._irls_cg_iters = int(irls_cg_iters)
        #: optional problem hints: set ``blur_cov`` (+ ``spacing``) only
        #: when ``A`` is exactly the Gaussian blur of that covariance
        self._blur_cov = blur_cov
        self._spacing = spacing
        self._stencils = None
        self._solve_cache = {}

    def set_irls_cg_iters(self, irls_cg_iters):
        self._irls_cg_iters = int(irls_cg_iters)

    def get_irls_cg_iters(self):
        return self._irls_cg_iters

    def _reg(self):
        """The regulariser ``BᵀB`` the kernels compute: "TK1" (the
        Laplacian, also TV's) or "TK0" (the identity); None outside the
        kernels' scope."""
        raise NotImplementedError

    def _ensure_normal_ops(self, minimizer):
        """The fused normal operators from the blur hint when the resolved
        minimizer uses them and the caller supplied none."""
        if minimizer not in ("cg", "irls") or self._blur_cov is None:
            return
        if self._normal_A is None:
            try:
                self._normal_A = C.make_normal_blur_operator(
                    self._blur_cov, alpha_cut=3, spacing=self._spacing,
                    shape=np.shape(self._x0))
            except ValueError:
                return
        if self._normal_B is None and self._reg() == "TK1":
            spacing = self._spacing
            self._normal_B = lambda x: G.gradient_normal(x, spacing)
        if self._normal_B is None and self._reg() == "TK0":
            self._normal_B = lambda x: x

    def _kernel_stencils(self):
        """The kernels' operator constants from the hint, or None outside
        their scope (no hint, a non-separable one, 1-D data, no
        regulariser the kernels know)."""
        if (self._blur_cov is None or self._reg() is None
                or np.ndim(self._x0) not in (2, 3)):
            return None
        if self._stencils is None:
            try:
                factors = C.blur_factors(self._blur_cov, 3, self._spacing)
            except ValueError:  # a non-separable hint
                return None
            self._stencils = _B.Stencils(factors, self._spacing,
                                         self._device, self._dtype)
        return self._stencils

    def _hooks(self):
        """On CUDA within the hint's scope, the kernel hooks of the inner
        solves (:func:`kernel_hooks`); else none."""
        st = self._kernel_stencils() if self._device.type == "cuda" else None
        return {} if st is None else kernel_hooks(st, self._reg())

    def _in_kernel_scope(self):
        """The fused solves' scope (``wrappers.py:271-279, :522-529``)
        apart from the measures."""
        robust = self._data_loss != "linear"
        return (self._kernel_stencils() is not None
                and np.all(self._b_reg == 0)
                and self._resolved_minimizer()
                == ("irls" if robust else "cg"))

    def _cached(self, key, build):
        if key not in self._solve_cache:
            self._solve_cache[key] = build()
        return self._solve_cache[key]


class TikhonovLinearSolver(_HintedSolver):
    """``min_x ½‖ρ((Ax−b)²)‖ + α/2‖Bx−b_reg‖²``
    (reference: nsol/tikhonov_linear_solver.py:25-280)."""

    def __init__(self, A, A_adj, b, B, B_adj, x0, alpha=0.01, b_reg=0,
                 data_loss="linear", data_loss_scale=1, minimizer="lsmr",
                 iter_max=10, x_scale=1, verbose=0, bounds=(0, np.inf),
                 normal_A=None, normal_B=None, irls_cg_iters=8,
                 blur_cov=None, spacing=None, reg_kind=None, device="cuda"):
        LinearSolver.__init__(
            self, A=A, A_adj=A_adj, b=b, x0=x0, alpha=alpha,
            x_scale=x_scale, data_loss=data_loss,
            data_loss_scale=data_loss_scale, minimizer=minimizer,
            iter_max=iter_max, verbose=verbose, device=device)
        self._B = B
        self._B_adj = B_adj
        self._b_reg = np.asarray(b_reg, dtype=self._np_dtype) / self._x_scale
        self._bounds = bounds
        #: ``reg_kind`` ("TK0": B = I, "TK1": B = the stacked gradient) is
        #: a hint like ``blur_cov``: set it only when B is that operator
        self._reg_kind = reg_kind
        self._init_hints(normal_A, normal_B, irls_cg_iters, blur_cov,
                         spacing)

    def get_B(self):
        return self._B

    def get_B_adj(self):
        return self._B_adj

    def get_b_reg(self):
        return np.array(self._b_reg) * self._x_scale

    def _reg(self):
        return self._reg_kind if self._reg_kind in ("TK0", "TK1") else None

    def _solve(self, alpha, data_loss_scale, minimizer):
        return _tik.tikhonov_solve(
            self._A, self._A_adj, self._B, self._B_adj,
            self._tensor(self._b), self._tensor(self._b_reg),
            self._tensor(self._x0), alpha, data_loss=self._data_loss,
            data_loss_scale=data_loss_scale, minimizer=minimizer,
            iter_max=self._iter_max, bounds=self._bounds,
            normal_A=self._normal_A, normal_B=self._normal_B,
            irls_cg_iters=self._irls_cg_iters, **self._hooks())

    def _run(self):
        if self._observer is not None:
            self._observer.add_x(self.get_x())
        minimizer = self._resolved_minimizer()
        self._ensure_normal_ops(minimizer)
        x = self._solve(self._alpha, self._data_loss_scale, minimizer)
        self._x = _numpy(x)
        if self._observer is not None:
            self._observer.add_x(self.get_x())

    def _cost_regularization(self, x):
        """``½‖Bx‖²``: b_reg deliberately ignored (reference quirk at
        nsol/tikhonov_linear_solver.py:276-280)."""
        Bx = self._B(x)
        return 0.5 * torch.sum(Bx * Bx)

    def _fused_sweep(self, alphas, dls, record_fn):
        """TK0L2/TK1L2 in the kernels' scope: whole Tikhonov solves of
        :func:`~nsol_tpu_torch.ops.cuda.tikhonov.make_fused_tikhonov_solver`
        over the α × data_loss_scale batch, one memory-budgeted chunk at a
        time. The study's two-row records (x0 and the solution) are the
        measures on the returned iterates. Storage from
        :func:`~nsol_tpu_torch.policy.sweep_options`. Returns None outside
        the scope."""
        if (not self._in_kernel_scope()
                or tuple(self._bounds or ()) != (0, np.inf)):
            return None
        shape = np.shape(self._x0)
        storage = policy.sweep_options(shape, self._device)
        solve = self._cached(
            ("tik", self._reg_kind, self._data_loss, self._iter_max,
             self._irls_cg_iters, tuple(sorted(storage.items()))),
            lambda: _T.make_fused_tikhonov_solver(
                shape, self._blur_cov, spacing=self._spacing,
                reg=self._reg_kind, iter_max=self._iter_max,
                data_loss=self._data_loss,
                irls_cg_iters=self._irls_cg_iters, **storage))
        b, x0 = self._tensor(self._b), self._tensor(self._x0)
        first = None if record_fn is None else record_fn(x0)
        x_all = np.empty((len(alphas),) + shape, self._np_dtype)
        rows = []
        for part in _chunks(len(alphas), shape, self._np_dtype.itemsize):
            xs = solve(b, x0, [float(alphas[i]) for i in part],
                       [float(dls[i]) for i in part])
            if record_fn is not None:
                for x in xs:
                    last = record_fn(x)
                    rows.append({k: (first[k], last[k]) for k in first})
            x_all[part.start:part.stop] = _numpy(xs)
            del xs
        return x_all * self._x_scale, _stack_records(rows)

    def run_sweep(self, param_values, measures=None, mesh=None):
        """Parameter sweep, the study engine's fast path.

        ``param_values``: dict of per-configuration value arrays (the
        cartesian product already expanded), keys ⊆ {"alpha",
        "data_loss_scale"}. Returns ``(x_all, records)`` with ``x_all``
        unscaled (numpy) and ``records`` a dict name -> ``(n_configs, 2)``
        array (the measures at x0 and at the solution, the reference
        observer's two ``add_x`` calls). ``mesh`` (a sharded batch) is not
        ported and raises.
        """
        _not_sharded(mesh)
        record_fn = _make_record_fn(measures, self._x_scale)
        n = len(next(iter(param_values.values())))
        alphas = param_values.get("alpha", np.full(n, self._alpha))
        dls = param_values.get("data_loss_scale",
                               np.full(n, self._data_loss_scale))
        if set(param_values) <= {"alpha", "data_loss_scale"}:
            fast = self._fused_sweep(alphas, dls, record_fn)
            if fast is not None:
                return fast

        minimizer = self._resolved_minimizer()
        self._ensure_normal_ops(minimizer)
        x0 = self._tensor(self._x0)
        first = None if record_fn is None else record_fn(x0)
        x_all = np.empty((n,) + np.shape(self._x0), self._np_dtype)
        rows = []
        for i in range(n):
            x = self._solve(float(alphas[i]), float(dls[i]), minimizer)
            if record_fn is not None:
                last = record_fn(x)
                rows.append({k: (first[k], last[k]) for k in first})
            x_all[i] = _numpy(x)
        return x_all * self._x_scale, _stack_records(rows)


class ADMMLinearSolver(_HintedSolver):
    """TV-regularized (robust) least squares via ADMM
    (reference: nsol/admm_linear_solver.py:28-312)."""

    def __init__(self, A, A_adj, b, B, B_adj, x0, dimension=None, b_reg=0,
                 alpha=0.01, iter_max=10, minimizer="lsmr",
                 data_loss="linear", data_loss_scale=1, rho=0.5,
                 iterations=10, x_scale=1, verbose=0,
                 normal_A=None, normal_B=None, irls_cg_iters=8,
                 blur_cov=None, spacing=None, device="cuda"):
        LinearSolver.__init__(
            self, A=A, A_adj=A_adj, b=b, x0=x0, alpha=alpha,
            x_scale=x_scale, data_loss=data_loss,
            data_loss_scale=data_loss_scale, minimizer=minimizer,
            iter_max=iter_max, verbose=verbose, device=device)
        self._B = B
        self._B_adj = B_adj
        self._b_reg = np.asarray(b_reg, dtype=self._np_dtype) / self._x_scale
        self._dimension = dimension  # API parity; shapes carry d
        self._rho = float(rho)
        self._iterations = int(iterations)
        #: with ``blur_cov`` set, ``B`` must be the stacked gradient
        self._init_hints(normal_A, normal_B, irls_cg_iters, blur_cov,
                         spacing)

    def set_rho(self, rho):
        self._rho = float(rho)

    def get_rho(self):
        return self._rho

    def get_dimension(self):
        return self._dimension

    def set_iterations(self, iterations):
        self._iterations = int(iterations)

    def get_iterations(self):
        return self._iterations

    def _reg(self):
        return "TK1"  # the x-update's ρ·DᵀD

    def _solve(self, alpha, rho, data_loss_scale, minimizer, record_fn,
               record_trajectory=False):
        return _admm.admm_solve(
            self._A, self._A_adj, self._B, self._B_adj,
            self._tensor(self._b), self._tensor(self._b_reg),
            self._tensor(self._x0), alpha, rho,
            iterations=self._iterations, iter_max=self._iter_max,
            data_loss=self._data_loss, data_loss_scale=data_loss_scale,
            minimizer=minimizer, record_fn=record_fn,
            record_trajectory=record_trajectory, normal_A=self._normal_A,
            normal_B=self._normal_B, irls_cg_iters=self._irls_cg_iters,
            **self._hooks())

    def _run(self):
        record_fn = _make_record_fn(self._observer_measures(), self._x_scale)
        minimizer = self._resolved_minimizer()
        self._ensure_normal_ops(minimizer)
        x, records = self._solve(self._alpha, self._rho,
                                 self._data_loss_scale, minimizer, record_fn,
                                 self._record_trajectory)
        self._x = _numpy(x)
        self._push_records(records)

    def _cost_regularization(self, x):
        """TV of ``Bx`` (reference: nsol/admm_linear_solver.py:311-312)."""
        Bx = self._B(x)
        return torch.sum(torch.sqrt(torch.sum(Bx * Bx, dim=0)))

    def _fused_sweep(self, alphas, rhos, dls, measures):
        """TV-L2 in the kernels' scope: the whole ADMM solves of
        :func:`~nsol_tpu_torch.ops.cuda.fused.make_fused_admm_solver`, one
        configuration after the other, with the study's Reg/Data measures
        recorded inside the solve (``Reg = TV(∇x)·s``, ``Data =
        ½Σρ_C(r²)·s²`` at the record scale ``C/s``). Storage from
        :func:`~nsol_tpu_torch.policy.sweep_options`. Returns None outside
        the scope."""
        if (not self._in_kernel_scope()
                or (measures and not set(measures) <= {"Reg", "Data"})):
            return None
        record = bool(measures)
        s = self._x_scale
        shape = np.shape(self._x0)
        storage = policy.sweep_options(shape, self._device)
        solve = self._cached(
            ("admm", self._data_loss, self._iterations, self._iter_max,
             self._irls_cg_iters, record, tuple(sorted(storage.items()))),
            lambda: _fused.make_fused_admm_solver(
                shape, self._blur_cov, spacing=self._spacing,
                iterations=self._iterations, iter_max=self._iter_max,
                data_loss=self._data_loss,
                irls_cg_iters=self._irls_cg_iters, record=record,
                **storage))
        # the Data record keeps the static interface-constructed loss scale
        # even when data_loss_scale is swept (reference semantics: the
        # measures dict is built once and never sees the setters,
        # wrappers.py:535-539)
        rec_c = float(np.asarray(self._data_loss_scale / s,
                                 dtype=self._np_dtype))
        b, x0 = self._tensor(self._b), self._tensor(self._x0)
        x_all = np.empty((len(alphas),) + shape, self._np_dtype)
        recs = {name: np.empty((len(alphas), self._iterations + 1))
                for name in (measures or ())}
        scale_of = {"Reg": s, "Data": s * s}
        for i in range(len(alphas)):
            out = solve(b, x0, float(alphas[i]), float(rhos[i]),
                        data_loss_scale=float(dls[i]), record_dls=rec_c)
            x = out[0] if record else out
            for name in recs:
                recs[name][i] = _numpy(out[1][name]) * scale_of[name]
            x_all[i] = _numpy(x)
        return x_all * s, (recs if record else None)

    def run_sweep(self, param_values, measures=None, mesh=None):
        """``alpha × rho (× data_loss_scale)`` sweep (the reference loops it
        serially with reflective setters, nsol/solver_parameter_study.py:
        170-221). Returns ``(x_all, records)``, records name ->
        ``(n_configs, iterations+1)``. ``mesh`` raises (not ported)."""
        _not_sharded(mesh)
        record_fn = _make_record_fn(measures, self._x_scale)
        n = len(next(iter(param_values.values())))
        alphas = param_values.get("alpha", np.full(n, self._alpha))
        rhos = param_values.get("rho", np.full(n, self._rho))
        dls = param_values.get("data_loss_scale",
                               np.full(n, self._data_loss_scale))
        if set(param_values) <= {"alpha", "rho", "data_loss_scale"}:
            fast = self._fused_sweep(alphas, rhos, dls, measures)
            if fast is not None:
                return fast

        minimizer = self._resolved_minimizer()
        self._ensure_normal_ops(minimizer)
        x_all = np.empty((n,) + np.shape(self._x0), self._np_dtype)
        rows = []
        for i in range(n):
            x, records = self._solve(float(alphas[i]), float(rhos[i]),
                                     float(dls[i]), minimizer, record_fn)
            if records is not None:
                rows.append({k: _numpy(v)
                             for k, v in records["measures"].items()})
            x_all[i] = _numpy(x)
        rec_np = {k: np.stack([r[k] for r in rows]) for k in rows[0]} \
            if rows else None
        return x_all * self._x_scale, rec_np


class PrimalDualSolver(Solver):
    """Chambolle–Pock primal-dual solver
    (reference: nsol/primal_dual_solver.py:26-403).

    ``prox_f(x, tau)``, ``prox_g_conj(p, sigma)`` and ``B``/``B_conj`` act
    on tensors of the solver's ``device``. The hints ``reconstruction_type``
    (TVL1/TVL2/HuberL1/HuberL2, with ``B`` the unit-spacing gradient) and
    ``observation`` (the kernel-scale observation ``b / x_scale``) let
    ``run_sweep`` take the fused denoising solve; the closures stay
    authoritative for everything else."""

    def __init__(self, prox_f, prox_g_conj, B, B_conj, L2, x0, alpha=0.01,
                 iterations=10, x_scale=1., verbose=0, alg_type="ALG2",
                 reconstruction_type=None, observation=None, device="cuda"):
        Solver.__init__(self, x0=x0, x_scale=x_scale, verbose=verbose,
                        device=device)
        self._prox_f = prox_f
        self._prox_g_conj = prox_g_conj
        self._B = B
        self._B_conj = B_conj
        self._L2 = float(L2)
        self._alpha = float(alpha)
        self._iterations = int(iterations)
        self._alg_type = alg_type
        self._reconstruction_type = reconstruction_type
        self._observation = None if observation is None \
            else _numpy(observation)
        self._solve_cache = {}

    def set_alpha(self, alpha):
        self._alpha = float(alpha)

    def get_alpha(self):
        return self._alpha

    def set_L2(self, L2):
        self._L2 = float(L2)

    def get_L2(self):
        return self._L2

    def set_alg_type(self, alg_type):
        self._alg_type = alg_type

    def get_alg_type(self):
        return self._alg_type

    def set_iterations(self, iterations):
        self._iterations = int(iterations)

    def get_iterations(self):
        return self._iterations

    def print_statistics(self, fmt="%.3e"):
        pass

    def _solve(self, alpha, record_fn=None, record_trajectory=False):
        return _pd.primal_dual_solve(
            self._prox_f, self._prox_g_conj, self._B, self._B_conj,
            self._tensor(self._x0), alpha, self._L2,
            iterations=self._iterations, alg_type=self._alg_type,
            record_fn=record_fn, record_trajectory=record_trajectory)

    def _run(self):
        record_fn = _make_record_fn(self._observer_measures(), self._x_scale)
        x, records = self._solve(self._alpha, record_fn,
                                 self._record_trajectory)
        self._x = _numpy(x)
        self._push_records(records)

    def _in_fused_scope(self, measures):
        """Whether ``run_sweep`` takes the fused denoising solve: one of
        its four types, the observation given, a 2-D/3-D image, and
        measures ⊆ {Reg, Data} (the ones it records inside the solve)."""
        return (self._reconstruction_type in _fused.PD_TYPES
                and self._observation is not None
                and np.ndim(self._x0) in (2, 3)
                and set(measures or ()) <= {"Reg", "Data"})

    def _fused_sweep(self, alphas, measures):
        """The sweep through the fused denoising solve, one memory-budgeted
        chunk of α at a time, with the study's Reg/Data records kept inside
        the solve and scaled to the rescaled iterate as the reference does
        (``wrappers.py:745-801``): the Huber record at ``γ/s``, Reg ×s (TV)
        or ×s² (Huber), Data ×s (L1) or ×s² (L2)."""
        record = bool(measures)
        rtype, s = self._reconstruction_type, self._x_scale
        shape = np.shape(self._x0)
        storage = policy.pd_options(shape, self._device)
        key = ("pd", rtype, self._alg_type, self._iterations, record,
               tuple(sorted(storage.items())))
        if key not in self._solve_cache:
            self._solve_cache[key] = _fused.make_fused_pd_denoise_solver(
                shape, rtype, alg_type=self._alg_type,
                iterations=self._iterations, record=record, **storage)
        solve = self._solve_cache[key]
        b, x0 = self._tensor(self._observation), self._tensor(self._x0)
        extra = {"record_gamma": float(self._np_dtype.type(
            HUBER_PRIOR_GAMMA / s))} if record else {}
        scale_of = {"Reg": s * s if rtype.startswith("Huber") else s,
                    "Data": s if rtype.endswith("L1") else s * s}
        x_all = np.empty((len(alphas),) + shape, self._np_dtype)
        recs = {name: np.empty((len(alphas), self._iterations + 1))
                for name in (measures or ())}
        for part in _chunks(len(alphas), shape, self._np_dtype.itemsize):
            out = solve(b, x0, [float(alphas[i]) for i in part], self._L2,
                        **extra)
            xs = out[0] if record else out
            for name in recs:
                recs[name][part.start:part.stop] = \
                    _numpy(out[1][name]) * scale_of[name]
            x_all[part.start:part.stop] = _numpy(xs)
            del out, xs
        return x_all * s, (recs if record else None)

    def run_sweep(self, param_values, measures=None, mesh=None):
        """α sweep, the study engine's fast path: ``param_values`` ``{"alpha":
        values}``; returns ``(x_all, records)``, ``x_all`` unscaled (numpy),
        ``records`` name -> ``(n_configs, iterations+1)``. Inside the fused
        solve's scope (:meth:`_in_fused_scope`) the whole batch runs through
        it; otherwise each α is one generic solve. ``mesh`` (a sharded
        batch) is not ported and raises."""
        _not_sharded(mesh)
        n = len(next(iter(param_values.values())))
        alphas = param_values.get("alpha", np.full(n, self._alpha))
        if set(param_values) <= {"alpha"} and self._in_fused_scope(measures):
            return self._fused_sweep(alphas, measures)
        record_fn = _make_record_fn(measures, self._x_scale)
        x_all = np.empty((n,) + np.shape(self._x0), self._np_dtype)
        rows = []
        for i in range(n):
            x, records = self._solve(float(alphas[i]), record_fn)
            if records is not None:
                rows.append({k: _numpy(v)
                             for k, v in records["measures"].items()})
            x_all[i] = _numpy(x)
        rec_np = {k: np.stack([r[k] for r in rows]) for k in rows[0]} \
            if rows else None
        return x_all * self._x_scale, rec_np
