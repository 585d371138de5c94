"""Run TV-L2 deconvolution by ADMM (counterpart of
``nsol_tpu/cli/run_deconvolution.py``, the ADMM/TVL2 route: the linear loss
with the ``cg`` inner engine, a robust loss with ``irls``).

Gaussian blur from ``--blur`` (cov = diag(σ²)), voxel spacing from the nii
header when present, and the whole solve through
:func:`nsol_tpu_torch.ops.cuda.fused.make_fused_admm_solver` on ``b/x_scale``
in float32 with ``x_scale = max(b)``, rescaled on output — as the
reference's fused route does (run_deconvolution.py:79,137,242).
``--data-loss-scale`` reaches a robust solve unscaled, as there (:139).
``--device cuda`` runs the CUDA kernels, ``--device cpu`` their plain
versions. Every other route of the reference (PD, TK0L2/TK1L2/HuberL2,
other inner engines, reference measures) raises ``NotImplementedError``
until its slice is ported.
"""

import numpy as np
import torch

from nsol_tpu_torch import timer as ph
from nsol_tpu_torch.cli.argparser import LOSSES, InputArgparser
from nsol_tpu_torch.io import DataReader, DataWriter
from nsol_tpu_torch.ops.cuda.fused import make_fused_admm_solver
from nsol_tpu_torch.solvers.tikhonov import resolve_minimizer


def _not_ported(what):
    return NotImplementedError(
        "%s is not ported to nsol_tpu_torch yet (ROADMAP.md Queue 1)" % what)


def main(argv=None):
    input_parser = InputArgparser(
        description="Run TVL2 (robust) deconvolution by ADMM on a GPU")
    input_parser.add_observation(required=True)
    input_parser.add_result(required=False)
    input_parser.add_reference(required=False)
    input_parser.add_blur(default=1)
    input_parser.add_reconstruction_type(default="TVL2")
    input_parser.add_measures(default=["PSNR", "RMSE", "SSIM", "NCC", "NMI"])
    input_parser.add_iterations(default=50)
    input_parser.add_solver(default="PD")
    input_parser.add_rho(default=0.5)
    input_parser.add_alpha(default=[0.01])
    input_parser.add_data_loss(default="linear")
    input_parser.add_data_loss_scale(default=1.0)
    input_parser.add_minimizer(default="auto")
    input_parser.add_iter_max(default=10)
    input_parser.add_irls_cg_iters(default=8)
    input_parser.add_verbose(default=0)
    input_parser.add_device(default="cuda")
    args = input_parser.parse_args(argv)
    input_parser.print_arguments(args)

    if args.solver != "ADMM":
        raise _not_ported("--solver %s" % args.solver)
    if args.reconstruction_type != "TVL2":
        raise _not_ported("--reconstruction-type %s"
                          % args.reconstruction_type)
    if args.data_loss not in LOSSES:
        raise ValueError("--data-loss must be one of %s" % ", ".join(LOSSES))
    if args.reference is not None:
        raise _not_ported("--reference (per-iteration measures)")

    alphas = np.atleast_1d(args.alpha)
    if len(alphas) > 1 and args.result is not None:
        print("WARNING: Multiple alphas overwrite result")
    elif len(alphas) == 1 and args.result is None:
        raise IOError("'--result' must be specified")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")

    # ------------------------------ Read data ------------------------------
    data_reader = DataReader(args.observation)
    data_reader.read_data()
    observed_nda = data_reader.get_data()
    dimension = observed_nda.ndim

    sigma = np.atleast_1d(args.blur).astype(np.float64)
    if sigma.size == 1:
        cov = np.diag(np.ones(dimension)) * sigma ** 2
    elif sigma.size == dimension:
        cov = np.diag(sigma ** 2)
    else:
        raise IOError("Blur information must be either 1- or d-dimensional")

    if data_reader.get_image_nifti() is None:
        spacing = np.ones(dimension)
    else:
        spacing = np.array(data_reader.get_image_nifti().get_spacing())

    minimizer = resolve_minimizer(args.minimizer, data_loss=args.data_loss,
                                  cov=cov, spacing=spacing)
    if minimizer != ("cg" if args.data_loss == "linear" else "irls"):
        raise _not_ported("--minimizer %s with --data-loss %s"
                          % (minimizer, args.data_loss))

    # ---------------------------- Set up solver ----------------------------
    x_scale = np.max(observed_nda)
    solve = make_fused_admm_solver(
        observed_nda.shape, cov, spacing=spacing,
        iterations=args.iterations, iter_max=args.iter_max,
        data_loss=args.data_loss, irls_cg_iters=args.irls_cg_iters)
    b = torch.as_tensor(observed_nda / x_scale, dtype=torch.float32,
                        device=args.device)

    # -------------------------- Run reconstruction -------------------------
    for i, alpha in enumerate(alphas):
        ph.print_subtitle("Iteration %d/%d" % (i + 1, len(alphas)))
        tm = ph.start_timing()
        x = solve(b, b, float(alpha), args.rho,
                  data_loss_scale=args.data_loss_scale)
        recon = x.cpu().numpy().astype(np.float64) * x_scale
        print("\nComputational time %s: %s"
              % (args.reconstruction_type, ph.stop_timing(tm)))
        if args.result is not None:
            DataWriter(recon, args.result,
                       data_reader.get_image_nifti()).write_data()
    return 0


if __name__ == "__main__":
    main()
