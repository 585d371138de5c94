"""Problem-setup façade: reconstruction type → configured solver, measures
and parameter study (counterpart of ``nsol_tpu/interface.py``; reference:
nsol/deconvolution_solver_parameter_study_interface.py:101-552).

* TK0L2/TK1L2 → :class:`TikhonovLinearSolver` with ``B = I`` / ``B = D``
  (:217-253);
* TVL2 → :class:`PrimalDualSolver` with ``prox_f`` the inner Tikhonov
  solve :func:`~nsol_tpu_torch.solvers.tikhonov.prox_linear_least_squares`
  (``tv_solver="PD"``), or :class:`ADMMLinearSolver` (``"ADMM"``)
  (:255-301);
* HuberL2 → :class:`PrimalDualSolver` with ``prox_huber_conj``
  (:303-325); its prox drops ``data_loss`` and the minimizer, so it is
  always the linear CGLS (the reference's quirk, kept);

plus the measures: the similarity measures of ``ops/measures.py`` against
``x_ref`` (on the voxels of ``x_ref_mask`` when given) and the Reg/Data
cost measures that feed the L-curve (:327-361).

The prox's inner solve warm-starts from the current PD iterate, as the
JAX package's does (the reference's lsmr cold-starts). On CUDA with the
separable-blur hint its inner ``"cg"`` runs the TK0 instance of
``normal_apply`` (``normal_M``) and its ``"irls"`` the TK0
``weighted_apply``/``blur_apply`` (``normal_W``/``grad_W``), as the
Tikhonov class's inner solves do.

The arrays are numpy, as the reference's; the operators ``A``, ``D`` (and
the optional fused normal operators) are callables on tensors of
``device`` (``"cuda"`` by default; it raises where torch sees no CUDA
device). Each measure takes a tensor (inside a sweep) or a numpy array
(the observer's trajectory) and returns a 0-dim tensor.
"""

import numpy as np
import torch

from nsol_tpu_torch.defaults import default_dtype
from nsol_tpu_torch.observer import Observer
from nsol_tpu_torch.ops import conv as C
from nsol_tpu_torch.ops import losses as lf
from nsol_tpu_torch.ops import priors
from nsol_tpu_torch.ops import prox as prox_ops
from nsol_tpu_torch.ops.cuda import blocked as _B
from nsol_tpu_torch.ops.measures import SIMILARITY_MEASURES
from nsol_tpu_torch.solvers import tikhonov as _tik
from nsol_tpu_torch.solvers.base import resolve_device
from nsol_tpu_torch.solvers.wrappers import (
    ADMMLinearSolver, PrimalDualSolver, TikhonovLinearSolver, kernel_hooks,
)
from nsol_tpu_torch.study.engine import (
    ADMMLinearSolverParameterStudy, PrimalDualSolverParameterStudy,
    TikhonovLinearSolverParameterStudy,
)

__all__ = ["DeconvolutionSolverStudyInterface",
           "DeconvolutionParameterStudyInterface"]


class DeconvolutionSolverStudyInterface(object):

    def __init__(self, A, A_adj, D, D_adj, b, x0, alpha, x_scale,
                 iter_max, iterations, minimizer, measures,
                 reconstruction_type, dimension, L2=8, rho=0.5,
                 x_ref=None, x_ref_mask=None, data_loss="linear",
                 data_loss_scale=1, tv_solver="PD", verbose=0, append=0,
                 normal_A=None, normal_B=None, irls_cg_iters=8,
                 blur_cov=None, spacing=None, device="cuda"):
        self._device = resolve_device(device)
        self._A = A
        self._A_adj = A_adj
        # the separable-blur hint (covariance + voxel spacing): lets the
        # solvers' run_sweep route whole grids through the fused kernels
        self._blur_cov = blur_cov
        self._spacing = spacing
        self._normal_A = normal_A
        self._normal_B = normal_B
        self._D = D
        self._D_adj = D_adj
        self._b = b
        self._x0 = x0
        self._alpha = alpha
        self._data_loss = data_loss
        self._data_loss_scale = data_loss_scale
        self._x_scale = x_scale
        self._iter_max = iter_max
        self._iterations = iterations
        self._minimizer = minimizer
        self._measures = measures
        self._reconstruction_type = reconstruction_type
        self._x_ref = x_ref
        self._x_ref_mask = x_ref_mask
        self._dimension = dimension
        self._tv_solver = tv_solver
        self._L2 = L2
        self._rho = rho
        self._verbose = verbose
        self._append = append
        self._irls_cg_iters = irls_cg_iters
        self._tensors = {}

        self._solver = None
        self._measures_dic = None

        self._set_up_solver_map = {
            "TK0L2": self._set_up_solver_TK0L2,
            "TK1L2": self._set_up_solver_TK1L2,
            "TVL2": self._set_up_solver_TVL2,
            "HuberL2": self._set_up_solver_HuberL2,
        }
        self._append_costs_map = {
            "TK0L2": self._append_reg_and_data_costs_TK0L2,
            "TK1L2": self._append_reg_and_data_costs_TK1L2,
            "TVL2": self._append_reg_and_data_costs_TVL2,
            "HuberL2": self._append_reg_and_data_costs_HuberL2,
        }
        if reconstruction_type not in self._set_up_solver_map:
            raise ValueError("reconstruction type '%s' not known; allowed: %s"
                             % (reconstruction_type,
                                sorted(self._set_up_solver_map)))

    def set_up_solver(self):
        self._solver = self._set_up_solver_map[self._reconstruction_type]()

    def set_up_measures(self):
        measures_dic = {}
        if self._x_ref is not None:
            x_ref = np.asarray(self._x_ref)
            if x_ref.shape != np.asarray(self._x0).shape:
                raise ValueError("Initial value x0 and reference x_ref "
                                 "arrays must be of same shape")
            if self._x_ref_mask is not None:
                mask = np.asarray(self._x_ref_mask) > 0
                if x_ref.shape != mask.shape:
                    raise ValueError("Reference x_ref and mask arrays must "
                                     "be of same shape")
                indices = np.where(mask)
            else:
                indices = np.where(x_ref != np.inf)
            ref_vals = x_ref[indices]

            def similarity(x, m):
                x = self._as_tensor(x)
                idx = self._like("idx", x, lambda: tuple(
                    torch.as_tensor(ix, device=x.device) for ix in indices))
                ref = self._like("x_ref", x, lambda: torch.as_tensor(
                    ref_vals, dtype=x.dtype, device=x.device))
                return SIMILARITY_MEASURES[m](x[idx], ref)

            measures_dic = {m: (lambda x, m=m: similarity(x, m))
                            for m in self._measures}
        self._append_costs_map[self._reconstruction_type](measures_dic)
        self._measures_dic = measures_dic

    def get_solver(self):
        if self._solver is None:
            raise RuntimeError("Run 'set_up_solver' first")
        return self._solver

    def get_measures(self):
        if self._measures_dic is None:
            raise RuntimeError("Run 'set_up_measures' first")
        return self._measures_dic

    # -- solver factories --------------------------------------------------

    def _common(self):
        return dict(A=self._A, A_adj=self._A_adj, b=self._b,
                    alpha=self._alpha, x0=self._x0, x_scale=self._x_scale,
                    data_loss=self._data_loss,
                    data_loss_scale=self._data_loss_scale,
                    iter_max=self._iter_max, minimizer=self._minimizer,
                    verbose=self._verbose, normal_A=self._normal_A,
                    irls_cg_iters=self._irls_cg_iters,
                    blur_cov=self._blur_cov, spacing=self._spacing,
                    device=self._device)

    def _set_up_solver_TK0L2(self):
        def ident(x):
            return x

        return TikhonovLinearSolver(B=ident, B_adj=ident, normal_B=ident,
                                    reg_kind="TK0", **self._common())

    def _set_up_solver_TK1L2(self):
        return TikhonovLinearSolver(B=self._D, B_adj=self._D_adj,
                                    normal_B=self._normal_B, reg_kind="TK1",
                                    **self._common())

    def _prox_hooks(self):
        """On CUDA with a separable blur hint and a 2-D/3-D image, the TK0
        kernel hooks of the prox's inner solve; else none."""
        if (self._device.type != "cuda" or self._blur_cov is None
                or np.ndim(self._x0) not in (2, 3)):
            return {}
        try:
            factors = C.blur_factors(self._blur_cov, 3, self._spacing)
        except ValueError:  # a non-separable hint
            return {}
        st = _B.Stencils(factors, self._spacing, self._device,
                         default_dtype())
        return kernel_hooks(st, "TK0")

    def _make_prox_lls(self, data_loss="linear", minimizer="lsmr",
                       normal_A=None, hooks=None):
        """The prox of ``f(x) = ½‖Ax−b‖²`` in scaled variables: the inner
        Tikhonov solve from the current iterate
        (reference: nsol/proximal_operators.py:43-78). Its IRLS runs the
        default 8 CG iterations whatever ``irls_cg_iters`` is, as the JAX
        package's prox does."""
        b_scaled = np.asarray(self._b, dtype=np.float64) / self._x_scale
        A, A_adj, iter_max = self._A, self._A_adj, self._iter_max
        data_loss_scale, hooks = self._data_loss_scale, hooks or {}

        def prox_f(x, tau):
            b = self._like("b_scaled", x, lambda: torch.as_tensor(
                b_scaled, dtype=x.dtype, device=x.device))
            return _tik.prox_linear_least_squares(
                x, tau, A, A_adj, b, x0=x, iter_max=iter_max,
                data_loss=data_loss, data_loss_scale=data_loss_scale,
                minimizer=minimizer, normal_A=normal_A, **hooks)

        return prox_f

    def _primal_dual(self, prox_f, prox_g_conj):
        return PrimalDualSolver(
            prox_f=prox_f, prox_g_conj=prox_g_conj, B=self._D,
            B_conj=self._D_adj, L2=self._L2, alpha=self._alpha, x0=self._x0,
            iterations=self._iterations, x_scale=self._x_scale,
            verbose=self._verbose, device=self._device)

    def _set_up_solver_TVL2(self):
        if self._tv_solver == "ADMM":
            return ADMMLinearSolver(
                B=self._D, B_adj=self._D_adj, rho=self._rho,
                iterations=self._iterations, dimension=self._dimension,
                normal_B=self._normal_B, **self._common())
        if self._tv_solver == "PD":
            # the prox closure has no reflective surface: "auto" resolves
            # here against the blur hint
            minimizer = _tik.resolve_minimizer(
                self._minimizer, data_loss=self._data_loss,
                cov=self._blur_cov, spacing=self._spacing)
            return self._primal_dual(
                self._make_prox_lls(self._data_loss, minimizer,
                                    self._normal_A, self._prox_hooks()),
                prox_ops.prox_tv_conj)
        raise ValueError("tv_solver must be 'PD' or 'ADMM'")

    def _set_up_solver_HuberL2(self):
        # the reference's HuberL2 prox passes no data_loss and no minimizer
        # (…interface.py:303-311): the linear CGLS, kept
        return self._primal_dual(self._make_prox_lls(),
                                 prox_ops.prox_huber_conj)

    # -- Reg/Data cost measures (feed the L-curve) -------------------------

    def _as_tensor(self, x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.as_tensor(np.asarray(x), dtype=default_dtype(),
                               device=self._device)

    def _like(self, name, x, make):
        """``make()``, a constant on ``x``'s device and dtype, made once
        per device and dtype."""
        key = (name, x.device, x.dtype)
        if key not in self._tensors:
            self._tensors[key] = make()
        return self._tensors[key]

    def _data_cost(self, x):
        x = self._as_tensor(x)
        b = self._like("b", x, lambda: torch.as_tensor(
            np.asarray(self._b), dtype=x.dtype, device=x.device))
        return lf.cost_from_residual(self._A(x) - b, self._data_loss,
                                     self._data_loss_scale)

    def _append_reg_and_data_costs_TK0L2(self, measures_dic):
        measures_dic["Reg"] = lambda x: priors.zeroth_order_tikhonov(
            self._as_tensor(x))
        measures_dic["Data"] = self._data_cost

    def _append_reg_and_data_costs_TK1L2(self, measures_dic):
        measures_dic["Reg"] = lambda x: priors.first_order_tikhonov(
            self._as_tensor(x), self._D)
        measures_dic["Data"] = self._data_cost

    def _append_reg_and_data_costs_TVL2(self, measures_dic):
        measures_dic["Reg"] = lambda x: priors.total_variation(
            self._as_tensor(x), self._D)
        measures_dic["Data"] = self._data_cost

    def _append_reg_and_data_costs_HuberL2(self, measures_dic):
        measures_dic["Reg"] = lambda x: priors.huber(self._as_tensor(x),
                                                     self._D)
        measures_dic["Data"] = self._data_cost


class DeconvolutionParameterStudyInterface(DeconvolutionSolverStudyInterface):
    """Study factory on top of the solver factory
    (reference: …interface.py:484-552)."""

    def __init__(self, A, A_adj, D, D_adj, b, x0, alpha, x_scale, iter_max,
                 iterations, minimizer, measures, dimension,
                 reconstruction_type, dir_output, parameters, name,
                 reconstruction_info, L2=8, rho=0.5, x_ref=None,
                 x_ref_mask=None, data_loss="linear", data_loss_scale=1,
                 tv_solver="PD", verbose=0, append=False, use_vmap=True,
                 normal_A=None, normal_B=None, irls_cg_iters=8,
                 blur_cov=None, spacing=None, device="cuda"):
        DeconvolutionSolverStudyInterface.__init__(
            self, A=A, A_adj=A_adj, D=D, D_adj=D_adj, b=b, x0=x0,
            alpha=alpha, data_loss=data_loss,
            data_loss_scale=data_loss_scale, x_scale=x_scale,
            iter_max=iter_max, iterations=iterations, minimizer=minimizer,
            measures=measures, reconstruction_type=reconstruction_type,
            L2=L2, rho=rho, x_ref=x_ref, x_ref_mask=x_ref_mask,
            dimension=dimension, tv_solver=tv_solver, verbose=verbose,
            append=append, normal_A=normal_A, normal_B=normal_B,
            irls_cg_iters=irls_cg_iters, blur_cov=blur_cov,
            spacing=spacing, device=device)
        self._name = name
        self._parameters = parameters
        self._reconstruction_info = reconstruction_info
        self._dir_output = dir_output
        self._use_vmap = use_vmap
        self._parameter_study = None

    def set_up_parameter_study(self):
        self.set_up_solver()
        self.set_up_measures()
        observer = Observer()
        observer.set_measures(self._measures_dic)

        common = dict(dir_output=self._dir_output,
                      parameters=self._parameters, name=self._name,
                      reconstruction_info=self._reconstruction_info,
                      append=self._append, use_vmap=self._use_vmap)
        rtype = self._reconstruction_type
        if rtype in ("TK0L2", "TK1L2"):
            self._parameter_study = TikhonovLinearSolverParameterStudy(
                self._solver, observer, **common)
        elif rtype == "TVL2" and self._tv_solver == "ADMM":
            self._parameter_study = ADMMLinearSolverParameterStudy(
                self._solver, observer, **common)
        else:
            self._parameter_study = PrimalDualSolverParameterStudy(
                self._solver, observer, **common)

    def get_parameter_study(self):
        if self._parameter_study is None:
            raise RuntimeError("Run 'set_up_parameter_study' first")
        return self._parameter_study
