"""Run a deconvolution (counterpart of ``nsol_tpu/cli/run_deconvolution.py``;
reference: nsol/application/run_deconvolution.py:28-248): TK0L2, TK1L2,
TVL2 (by primal-dual, the default ``--solver PD``, or by ADMM) and HuberL2.

Gaussian blur from ``--blur`` (cov = diag(σ²)), voxel spacing from the nii
header when present. ``--minimizer auto`` resolves as the reference's does
(:83-91): a linear loss with the separable blur runs the inner ``"cg"``, a
robust one ``"irls"``.

TVL2 by ADMM with those engines and no ``--reference`` runs the whole solve
on ``b/x_scale`` in float32 with ``x_scale = max(b)``, rescaled on output,
as the reference's accelerator route does (run_deconvolution.py:79,137,
242). Both losses take their solver factory and storage from
:func:`nsol_tpu_torch.policy.tvl2_solver`, the reference CLI's choice
(:140-220): the fused solve
(:func:`~nsol_tpu_torch.ops.cuda.fused.make_fused_admm_solver`, linear or
robust) where 16 volumes fit 64 MiB (64³, 2-D images up to 1024²), and a
2-D image past that too; for a 3-D volume past it the linear loss takes
:func:`~nsol_tpu_torch.ops.cuda.blocked.blocked_admm_solve` ("step" at
128³/256³, "apply" at 512-wide planes) and a robust one
:func:`~nsol_tpu_torch.ops.cuda.robust.blocked_robust_admm_solve` (its
tiled units at 512-wide planes whose blur fits them, else the per-axis
ones). On ``--device cuda`` they run in compact storage
(``precision="high3", compact_dirs=True`` fused, ``compact_dirs=True``
blocked, the linear ``state_dtype=bfloat16`` with ``NSOL_TPU_COMPACT=1``),
exact f32 with ``NSOL_TPU_EXACT=1``, on ``--device cpu`` and for a 2-D
image past the fused solve's fit. ``--data-loss-scale`` reaches a robust
solve unscaled, as there (:139).

Every other route runs the interface's solver
(:class:`~nsol_tpu_torch.interface.DeconvolutionSolverStudyInterface`),
one run per α (:253-290), with the blur hint: TK0L2/TK1L2, TVL2 by PD
(each PD step's prox an inner Tikhonov solve: ``"cg"``, ``"irls"`` for a
robust ``--data-loss``, or ``"lsmr"``), HuberL2 (the linear CGLS prox, the
reference's quirk), and any route with ``--reference``, whose observer
records the similarity measures. On CUDA the inner solves' applies run
the kernel units through the hooks. ``--minimizer lsq_linear``,
``least_squares`` and ``L-BFGS-B`` (or any quasi-Newton name) run the
interface's solver too, their engines on the blur of ``--blur`` (on
cuda in float32). ``--device cuda`` runs the CUDA kernels, ``--device
cpu`` their plain versions. ``--trace DIR`` records the loop over α of
either route with ``torch.profiler`` (:func:`nsol_tpu_torch.profiling.
trace`) into a Chrome-trace JSON file in DIR; the traced solve is the
untraced one, bit for bit. ``--dir-output-figures`` with ``--verbose``
receives the JAX CLI's figures (:func:`_save_figures`: the 2-D comparison,
and on the interface's route each measure against the iteration);
without ``--verbose`` it writes nothing, as in the reference (:292-294).
"""

import contextlib
import os

import numpy as np
import torch

from nsol_tpu_torch import policy, profiling
from nsol_tpu_torch import timer as ph
from nsol_tpu_torch.cli.argparser import LOSSES, InputArgparser
from nsol_tpu_torch.interface import DeconvolutionSolverStudyInterface
from nsol_tpu_torch.io import DataReader, DataWriter
from nsol_tpu_torch.observer import Observer
from nsol_tpu_torch.ops import conv as C
from nsol_tpu_torch.ops import grad as G
from nsol_tpu_torch.solvers.tikhonov import resolve_minimizer

#: the reconstruction types this CLI runs
_TYPES = ("TK0L2", "TK1L2", "TVL2", "HuberL2")


def main(argv=None):
    input_parser = InputArgparser(
        description="Run TK0L2/TK1L2/TVL2/HuberL2 deconvolution on a GPU")
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
    input_parser.add_dir_output_figures(default=None)
    input_parser.add_verbose(default=0)
    input_parser.add_trace(default=None)
    input_parser.add_device(default="cuda")
    args = input_parser.parse_args(argv)
    input_parser.print_arguments(args)

    if args.reconstruction_type not in _TYPES:
        raise ValueError("reconstruction type '%s' not known; allowed: %s"
                         % (args.reconstruction_type, ", ".join(_TYPES)))
    if args.solver not in ("PD", "ADMM"):
        raise ValueError("tv_solver must be 'PD' or 'ADMM'")
    if args.data_loss not in LOSSES:
        raise ValueError("--data-loss must be one of %s" % ", ".join(LOSSES))

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
    x_ref = None
    if args.reference is not None:
        ref_reader = DataReader(args.reference)
        ref_reader.read_data()
        x_ref = ref_reader.get_data()

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

    x_scale = np.max(observed_nda)
    fused = (args.reconstruction_type == "TVL2" and args.solver == "ADMM"
             and x_ref is None and minimizer == (
                 "cg" if args.data_loss == "linear" else "irls"))
    if not fused:
        return _run_interface(args, data_reader, observed_nda, x_ref, cov,
                              spacing, minimizer, x_scale, alphas)

    # ---------------------------- Set up solver ----------------------------
    build, kwargs = policy.tvl2_solver(
        observed_nda.shape, cov, spacing, args.device, args.iterations,
        args.iter_max, args.data_loss, args.irls_cg_iters)
    built = build(**kwargs)
    if args.data_loss == "linear":
        def solve(b, x0, alpha, rho, data_loss_scale=1.0):
            return built(b, x0, alpha, rho)
    else:
        solve = built
    b = torch.as_tensor(observed_nda / x_scale, dtype=torch.float32,
                        device=args.device)

    # -------------------------- Run reconstruction -------------------------
    recons = []
    with _tracer(args):
        for i, alpha in enumerate(alphas):
            ph.print_subtitle("Iteration %d/%d" % (i + 1, len(alphas)))
            tm = ph.start_timing()
            x = solve(b, b, float(alpha), args.rho,
                      data_loss_scale=args.data_loss_scale)
            recon = x.cpu().numpy().astype(np.float64) * x_scale
            recons.append(recon)
            print("\nComputational time %s: %s"
                  % (args.reconstruction_type, ph.stop_timing(tm)))
            if args.result is not None:
                DataWriter(recon, args.result,
                           data_reader.get_image_nifti()).write_data()
    if args.verbose and args.dir_output_figures is not None:
        _save_figures(args, observed_nda, recons, alphas, [], {})
    return 0


def _tracer(args):
    """``--trace DIR``: the loop over α under ``torch.profiler``."""
    return (profiling.trace(args.trace) if args.trace
            else contextlib.nullcontext())


def _run_interface(args, data_reader, observed_nda, x_ref, cov, spacing,
                   minimizer, x_scale, alphas):
    """Every route but the whole ADMM solve: the interface's solver, one
    run per α (nsol_tpu/cli/run_deconvolution.py:253-290)."""
    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, spacing=spacing,
                                     shape=observed_nda.shape)
    grad_op, grad_adj = G.make_gradient_operators(spacing)
    normal_A = C.make_normal_blur_operator(
        cov, alpha_cut=3, spacing=spacing, shape=observed_nda.shape) \
        if minimizer == "cg" else None
    normal_B = None
    if minimizer in ("cg", "irls"):
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
        x_ref=x_ref, tv_solver=args.solver, verbose=args.verbose,
        normal_A=normal_A,
        normal_B=normal_B, irls_cg_iters=args.irls_cg_iters, blur_cov=cov,
        spacing=spacing, device=args.device)
    solver_interface.set_up_solver()
    solver_interface.set_up_measures()
    solver = solver_interface.get_solver()
    measures_dic = solver_interface.get_measures()

    # -------------------------- Run reconstruction -------------------------
    recons, observers = [], []
    with _tracer(args):
        for i, alpha in enumerate(alphas):
            ph.print_subtitle("Iteration %d/%d" % (i + 1, len(alphas)))
            solver.set_alpha(alpha)
            observer = Observer()
            observer.set_measures(measures_dic)
            solver.set_observer(observer)
            observers.append(observer)
            solver.run()
            recons.append(solver.get_x())
            print("\nComputational time %s: %s"
                  % (args.reconstruction_type,
                     solver.get_computational_time()))
            if args.result is not None:
                DataWriter(recons[-1], args.result,
                           data_reader.get_image_nifti()).write_data()
    if args.verbose and args.dir_output_figures is not None:
        _save_figures(args, observed_nda, recons, alphas, observers,
                      measures_dic)
    return 0


def _save_figures(args, observed, recons, alphas, observers, measures_dic):
    """The JAX CLI's figures (``nsol_tpu/cli/run_deconvolution.py:
    299-330``) in ``--dir-output-figures``: a 2-D input beside each α's
    reconstruction, and each measure of ``measures_dic`` against the
    iteration."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(args.dir_output_figures, exist_ok=True)
    if observed.ndim == 2:
        n = 1 + len(recons)
        fig, axes = plt.subplots(1, n, figsize=(4 * n, 4))
        axes = np.atleast_1d(axes)
        axes[0].imshow(observed, cmap="jet")
        axes[0].set_title("observed")
        for i, (r, a) in enumerate(zip(recons, alphas)):
            axes[i + 1].imshow(r, cmap="jet")
            axes[i + 1].set_title(r"$\alpha=%g$" % a)
        fig.savefig(os.path.join(
            args.dir_output_figures,
            args.reconstruction_type + "_comparison.pdf"))
        plt.close(fig)

    for m in measures_dic:
        fig, ax = plt.subplots()
        for obs, a in zip(observers, alphas):
            res = obs.get_measures_results()[m]
            ax.plot(range(len(res)), res, label=r"$\alpha=%g$" % a)
        ax.set_xlabel("iteration")
        ax.set_title("%s: %s" % (args.reconstruction_type, m))
        ax.legend()
        fig.savefig(os.path.join(
            args.dir_output_figures,
            args.reconstruction_type + "_" + m + ".pdf"))
        plt.close(fig)


if __name__ == "__main__":
    main()
