"""Run a deconvolution (counterpart of ``nsol_tpu/cli/run_deconvolution.py``):
the ADMM/TVL2 route (the linear loss with the ``cg`` inner engine, a
robust loss with ``irls``) and the TK0L2/TK1L2 route.

Gaussian blur from ``--blur`` (cov = diag(σ²)), voxel spacing from the nii
header when present. TVL2 by ADMM runs the whole solve through
:func:`nsol_tpu_torch.ops.cuda.fused.make_fused_admm_solver` on ``b/x_scale``
in float32 with ``x_scale = max(b)``, rescaled on output, as the
reference's fused route does (run_deconvolution.py:79,137,242), 2-D images
and 3-D volumes alike; ``--data-loss-scale`` reaches a robust solve
unscaled, as there (:139). TK0L2/TK1L2 run the interface's
:class:`~nsol_tpu_torch.solvers.wrappers.TikhonovLinearSolver` per α
(:253-290), with the blur hint, so that on CUDA the kernel units serve its
inner solves. ``--device cuda`` runs the CUDA kernels, ``--device cpu``
their plain versions. Every other route of the reference (PD, HuberL2,
other inner engines, reference measures) raises ``NotImplementedError``
until its slice is ported.
"""

import numpy as np
import torch

from nsol_tpu_torch import timer as ph
from nsol_tpu_torch.cli.argparser import LOSSES, InputArgparser
from nsol_tpu_torch.interface import DeconvolutionSolverStudyInterface
from nsol_tpu_torch.io import DataReader, DataWriter
from nsol_tpu_torch.observer import Observer
from nsol_tpu_torch.ops import conv as C
from nsol_tpu_torch.ops import grad as G
from nsol_tpu_torch.ops.cuda.fused import make_fused_admm_solver
from nsol_tpu_torch.solvers.tikhonov import resolve_minimizer

#: the reconstruction types this CLI runs
_TYPES = ("TVL2", "TK0L2", "TK1L2")


def _not_ported(what):
    return NotImplementedError(
        "%s is not ported to nsol_tpu_torch yet (ROADMAP.md Queue 1)" % what)


def main(argv=None):
    input_parser = InputArgparser(
        description="Run TVL2 (robust) deconvolution by ADMM, or TK0L2/"
                    "TK1L2 deconvolution, on a GPU")
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

    tikhonov = args.reconstruction_type in ("TK0L2", "TK1L2")
    if args.reconstruction_type not in _TYPES:
        raise _not_ported("--reconstruction-type %s"
                          % args.reconstruction_type)
    if not tikhonov and args.solver != "ADMM":
        raise _not_ported("--solver %s" % args.solver)
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

    x_scale = np.max(observed_nda)
    if tikhonov:
        return _run_tikhonov(args, data_reader, observed_nda, cov, spacing,
                             minimizer, x_scale, alphas)

    # ---------------------------- Set up solver ----------------------------
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


def _run_tikhonov(args, data_reader, observed_nda, cov, spacing, minimizer,
                  x_scale, alphas):
    """TK0L2/TK1L2 through the interface's solver, one run per α
    (nsol_tpu/cli/run_deconvolution.py:253-290)."""
    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, spacing=spacing)
    grad_op, grad_adj = G.make_gradient_operators(spacing)
    normal_A = C.make_normal_blur_operator(cov, alpha_cut=3, spacing=spacing) \
        if minimizer == "cg" else None

    def normal_B(x):
        return G.gradient_normal(x, spacing)

    solver_interface = DeconvolutionSolverStudyInterface(
        A=A, A_adj=A_adj, D=grad_op, D_adj=grad_adj, b=observed_nda,
        x0=np.array(observed_nda), alpha=alphas[0], x_scale=x_scale,
        data_loss=args.data_loss, data_loss_scale=args.data_loss_scale,
        iter_max=args.iter_max, iterations=args.iterations,
        minimizer=minimizer, measures=args.measures,
        dimension=observed_nda.ndim,
        reconstruction_type=args.reconstruction_type, rho=args.rho,
        tv_solver=args.solver, verbose=args.verbose, normal_A=normal_A,
        normal_B=normal_B, irls_cg_iters=args.irls_cg_iters, blur_cov=cov,
        spacing=spacing, device=args.device)
    solver_interface.set_up_solver()
    solver_interface.set_up_measures()
    solver = solver_interface.get_solver()
    measures_dic = solver_interface.get_measures()

    # -------------------------- Run reconstruction -------------------------
    for i, alpha in enumerate(alphas):
        ph.print_subtitle("Iteration %d/%d" % (i + 1, len(alphas)))
        solver.set_alpha(alpha)
        observer = Observer()
        observer.set_measures(measures_dic)
        solver.set_observer(observer)
        solver.run()
        print("\nComputational time %s: %s"
              % (args.reconstruction_type, solver.get_computational_time()))
        if args.result is not None:
            DataWriter(solver.get_x(), args.result,
                       data_reader.get_image_nifti()).write_data()
    return 0


if __name__ == "__main__":
    main()
