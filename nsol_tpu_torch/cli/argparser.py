"""Declarative CLI argument collection (counterpart of
``nsol_tpu/cli/argparser.py``): the options of the deconvolution routes
(ADMM/TVL2 with linear and robust losses, TK0L2/TK1L2), of the
deconvolution study, of the denoising CLI and of the corruption tool, plus
``--device``. Flag
names, defaults and help conventions follow the reference so one command
line reads the same in both packages.
"""

import argparse

from nsol_tpu_torch import timer as ph
from nsol_tpu_torch.__about__ import __version__
from nsol_tpu_torch.defaults import (ALLOWED_INPUT_EXTENSIONS,
                                     ALLOWED_NOISE_TYPES)

__all__ = ["InputArgparser", "LOSSES", "SIMILARITY_MEASURES"]

#: data-loss names of the reference (``nsol_tpu.ops.losses.LOSSES`` keys)
LOSSES = ("linear", "soft_l1", "huber", "cauchy", "arctan")
#: similarity-measure names (``nsol_tpu.ops.measures.SIMILARITY_MEASURES``)
SIMILARITY_MEASURES = ("SSD", "MAE", "MSE", "RMSE", "PSNR", "SSIM", "NCC",
                       "MI", "NMI")

INPUT_FILE_TYPES = "(" + ", ".join(ALLOWED_INPUT_EXTENSIONS) + ")"
NOISE_TYPES = "(" + ", ".join(ALLOWED_NOISE_TYPES) + ", or none)"


class InputArgparser(object):

    def __init__(self, description=None, prog=None,
                 epilog="nsol_tpu_torch version: %s" % __version__):
        kwargs = {}
        if description is not None:
            kwargs["description"] = description
        if prog is not None:
            kwargs["prog"] = prog
        if epilog is not None:
            kwargs["epilog"] = epilog
        self._parser = argparse.ArgumentParser(**kwargs)
        self._parser.add_argument(
            "--version", action="version", version="%s" % __version__,
            help="Print the nsol_tpu_torch version and exit")

    def get_parser(self):
        return self._parser

    def parse_args(self, args=None):
        return self._parser.parse_args(args)

    def print_arguments(self, args, title="Input Parameters:"):
        ph.print_title(title)
        for name, value in sorted(vars(args).items()):
            ph.print_info("%s: %s" % (name, value))

    def _add(self, option_string, **kwargs):
        default = kwargs.get("default")
        required = kwargs.get("required", False)
        if default is not None and not required and "help" in kwargs:
            kwargs["help"] += " [default: %s]" % str(default)
        self._parser.add_argument(option_string, **kwargs)

    # -- file arguments ----------------------------------------------------

    def add_observation(self, required=True):
        self._add("--observation", type=str, required=required,
                  help="Input image to denoise or deconvolve; any of %s."
                       % INPUT_FILE_TYPES)

    def add_filename(self, required=True):
        self._add("--filename", type=str, required=required,
                  help="Input image file %s." % INPUT_FILE_TYPES)

    def add_result(self, required=True, default=None):
        self._add("--result", type=str, required=required, default=default,
                  help="Where to write the reconstruction; format chosen "
                       "by extension %s." % INPUT_FILE_TYPES)

    def add_reference(self, required=False):
        self._add("--reference", type=str, required=required,
                  help="Ground-truth image %s; when supplied, each "
                       "similarity measure is evaluated against it."
                       % INPUT_FILE_TYPES)

    def add_dir_output(self, default=None, required=False):
        self._add("--dir-output", type=str, default=default,
                  required=required,
                  help="Directory to write results into.")

    def add_dir_output_figures(self, default=None):
        self._add("--dir-output-figures", type=str, default=default,
                  help="Save generated plots into this directory instead "
                       "of only displaying them.")

    # -- problem configuration ---------------------------------------------

    def add_reconstruction_type(self, default="TVL1"):
        self._add("--reconstruction-type", type=str, default=default,
                  help="Which data-fidelity/regularizer pairing to solve: "
                       "TVL1, TVL2, HuberL1, HuberL2 for denoising; TK0L2, "
                       "TK1L2, TVL2, HuberL2 for deconvolution.")

    def add_measures(self, default=None):
        self._add("--measures", type=str, nargs="+", default=default,
                  help="Similarity measures to track against the reference "
                       "image, from: %s." % ", ".join(SIMILARITY_MEASURES))

    def add_alpha(self, default=0.03):
        self._add("--alpha", type=float, nargs="+", default=default,
                  help="Regularization weight(s); one solve is run per "
                       "value given.")

    def add_alpha_range(self, default=None, required=False):
        self._add("--alpha-range", type=float, nargs="+", default=default,
                  required=required,
                  help="Sweep grid for alpha as three numbers START STOP "
                       "COUNT, expanded with np.linspace.")

    def add_data_loss(self, default="linear"):
        self._add("--data-loss", type=str, default=default,
                  help="Robust loss rho applied to squared residuals of "
                       "the data term; one of %s." % ", ".join(LOSSES))

    def add_data_losses(self, default=None, required=False):
        self._add("--data-losses", nargs="+", default=default,
                  required=required,
                  help="Robust losses to sweep over in a study; each from "
                       "%s." % ", ".join(LOSSES))

    def add_data_loss_scale(self, default=1):
        self._add("--data-loss-scale", type=float, default=default,
                  help="Scale C of the robust loss (scipy f_scale "
                       "convention, rho_C(r2) = C^2 rho(r2/C^2)): residuals "
                       "below ~C count quadratically, larger ones are "
                       "downweighted as outliers.")

    def add_data_loss_scale_range(self, default=None, required=False):
        self._add("--data-loss-scale-range", type=float, nargs="+",
                  default=default, required=required,
                  help="Sweep grid for the loss scale as START STOP COUNT "
                       "(np.linspace).")

    def add_blur(self, default=0):
        self._add("--blur", type=float, nargs="+", default=default,
                  help="Gaussian blur stddev in voxels: one number for an "
                       "isotropic PSF, or one per axis for an "
                       "axis-aligned anisotropic PSF.")

    def add_noise(self, default=None):
        self._add("--noise", type=str, default=default,
                  help="Kind of synthetic corruption to add %s."
                       % NOISE_TYPES)

    def add_noise_level(self, default=None):
        self._add("--noise-level", type=float, default=default,
                  help="Noise amplitude, relative to the data maximum.")

    # -- solver configuration ----------------------------------------------

    def add_solver(self, default="PD"):
        self._add("--solver", type=str, default=default,
                  help="Outer splitting algorithm: 'ADMM' or 'PD' "
                       "(Chambolle-Pock primal-dual).")

    def add_minimizer(self, default="lsmr"):
        self._add("--minimizer", type=str, default=default,
                  help="Engine for the inner quadratic problem: 'auto' "
                       "(cg for a linear loss, irls for a robust one, with "
                       "a separable blur; else lsmr / L-BFGS-B), 'lsmr' "
                       "(CGLS), 'cg' (CG on the normal equations), 'irls' "
                       "(reweighted CG), 'lsq_linear' (projected FISTA), "
                       "'least_squares', or a quasi-Newton name like "
                       "'L-BFGS-B' (the box L-BFGS; handles non-linear "
                       "data losses).")

    def add_rho(self, default=0.5):
        self._add("--rho", type=float, default=default,
                  help="ADMM penalty weight on the augmented-Lagrangian "
                       "splitting term.")

    def add_iterations(self, default=10):
        self._add("--iterations", type=int, default=default,
                  help="Outer iteration count of the ADMM / primal-dual "
                       "loop.")

    def add_iter_max(self, default=10):
        self._add("--iter-max", type=int, default=default,
                  help="Iteration budget of each inner quadratic solve.")

    def add_irls_cg_iters(self, default=8):
        self._add("--irls-cg-iters", type=int, default=default,
                  help="CG iterations inside each IRLS reweighting step "
                       "(only used when --minimizer irls).")

    def add_study_name(self, default=None, required=False):
        self._add("--study-name", type=str, default=default,
                  required=required,
                  help="Identifier for the parameter study's output files "
                       "(no whitespace).")

    def add_verbose(self, default=1):
        self._add("--verbose", type=int, default=default,
                  help="1 = chatty progress output, 0 = quiet.")

    def add_trace(self, default=None):
        self._add("--trace", type=str, default=default,
                  help="Directory for a profiler device trace of the "
                       "reconstruction.")

    def add_device(self, default="cuda"):
        self._add("--device", type=str, default=default,
                  choices=("cuda", "cpu"),
                  help="Where to solve: 'cuda' runs the CUDA kernels "
                       "(float32), 'cpu' their plain PyTorch versions.")
