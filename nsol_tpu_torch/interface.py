"""Problem-setup façade: reconstruction type → configured solver, measures
and parameter study (counterpart of ``nsol_tpu/interface.py``; reference:
nsol/deconvolution_solver_parameter_study_interface.py:101-552).

* TK0L2/TK1L2 → :class:`TikhonovLinearSolver` with ``B = I`` / ``B = D``
  (:217-253);
* TVL2 with ``tv_solver="ADMM"`` → :class:`ADMMLinearSolver` (:255-301);

plus the Reg/Data cost measures that feed the L-curve (:327-361). TVL2
with ``tv_solver="PD"`` and HuberL2 need the primal-dual solver class and
``prox_linear_least_squares`` (CGLS), and ``x_ref`` the similarity
measures: they raise ``NotImplementedError`` until their slices land
(ROADMAP Queue 1 items 6 and 11).

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
from nsol_tpu_torch.ops import losses as lf
from nsol_tpu_torch.ops import priors
from nsol_tpu_torch.solvers.base import resolve_device
from nsol_tpu_torch.solvers.wrappers import (
    ADMMLinearSolver, TikhonovLinearSolver,
)
from nsol_tpu_torch.study.engine import (
    ADMMLinearSolverParameterStudy, TikhonovLinearSolverParameterStudy,
)

__all__ = ["DeconvolutionSolverStudyInterface",
           "DeconvolutionParameterStudyInterface"]


def _not_ported(what, item):
    return NotImplementedError("%s is not ported to nsol_tpu_torch yet "
                               "(ROADMAP Queue 1 item %d)" % (what, item))


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
        self._b_tensors = {}

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
        }
        if reconstruction_type not in self._set_up_solver_map:
            raise ValueError("reconstruction type '%s' not known; allowed: %s"
                             % (reconstruction_type,
                                sorted(self._set_up_solver_map)))

    def set_up_solver(self):
        self._solver = self._set_up_solver_map[self._reconstruction_type]()

    def set_up_measures(self):
        if self._x_ref is not None:
            raise _not_ported("x_ref (the similarity measures of "
                              "ops/measures.py)", 11)
        measures_dic = {}
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

    def _set_up_solver_TVL2(self):
        if self._tv_solver == "ADMM":
            return ADMMLinearSolver(
                B=self._D, B_adj=self._D_adj, rho=self._rho,
                iterations=self._iterations, dimension=self._dimension,
                normal_B=self._normal_B, **self._common())
        if self._tv_solver == "PD":
            raise _not_ported("TVL2 with tv_solver='PD' (the primal-dual "
                              "solver class and prox_linear_least_squares)",
                              6)
        raise ValueError("tv_solver must be 'PD' or 'ADMM'")

    def _set_up_solver_HuberL2(self):
        raise _not_ported("HuberL2 deconvolution (the primal-dual solver "
                          "class and prox_linear_least_squares)", 6)

    # -- Reg/Data cost measures (feed the L-curve) -------------------------

    def _as_tensor(self, x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.as_tensor(np.asarray(x), dtype=default_dtype(),
                               device=self._device)

    def _b_like(self, x):
        key = (x.device, x.dtype)
        if key not in self._b_tensors:
            self._b_tensors[key] = torch.as_tensor(
                np.asarray(self._b), dtype=x.dtype, device=x.device)
        return self._b_tensors[key]

    def _data_cost(self, x):
        x = self._as_tensor(x)
        return lf.cost_from_residual(self._A(x) - self._b_like(x),
                                     self._data_loss, self._data_loss_scale)

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
        if self._reconstruction_type in ("TK0L2", "TK1L2"):
            self._parameter_study = TikhonovLinearSolverParameterStudy(
                self._solver, observer, **common)
        else:
            self._parameter_study = ADMMLinearSolverParameterStudy(
                self._solver, observer, **common)

    def get_parameter_study(self):
        if self._parameter_study is None:
            raise RuntimeError("Run 'set_up_parameter_study' first")
        return self._parameter_study
