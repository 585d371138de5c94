"""Run TVL1/TVL2/HuberL1/HuberL2 denoising (counterpart of
``nsol_tpu/cli/run_denoising.py``; reference:
nsol/application/run_denoising.py:33-250).

The observation is read with :class:`~nsol_tpu_torch.io.DataReader` (PNG
without Pillow) and scaled by ``x_scale = max(b)``; the reference's
``L2 = 8``, even for 3-D volumes, is kept. Routes, as the JAX CLI's
(:64-170):

* ``--solver PD`` on a 2-D/3-D image without ``--reference``: every α is
  one whole solve through
  :func:`nsol_tpu_torch.ops.cuda.fused.make_fused_pd_denoise_solver`
  (ALG2) on ``b/x_scale`` with ``x0 = b/x_scale``, rescaled on output. The
  JAX CLI takes its fused kernel only where it fits VMEM and runs its XLA
  loop past that (256³, say); the two agree to f32 noise, and the port
  takes the fused solve at every size (ROADMAP Queue 3, differences kept
  on purpose). Its storage is :func:`nsol_tpu_torch.policy.pd_options`'s:
  the bf16 state under ``NSOL_TPU_COMPACT=1`` on cuda where the
  reference's fused kernel would run, exact f32 otherwise.
* ``--solver PD`` with ``--reference`` or on 1-D input: the generic
  :class:`~nsol_tpu_torch.solvers.wrappers.PrimalDualSolver` with the
  denoising proxes, and with ``--reference`` an observer of the
  similarity measures (``--measures``) against the reference image.
* ``--solver ADMM`` (TVL2 only): :class:`~nsol_tpu_torch.solvers.wrappers.
  ADMMLinearSolver` with ``A = I``.

``--device cuda`` runs the CUDA kernels and the tensors on the card,
``--device cpu`` the plain versions. ``--trace DIR`` records the loop over
α with ``torch.profiler`` (:func:`nsol_tpu_torch.profiling.trace`) into a
Chrome-trace JSON file in DIR; the traced solve is the untraced one, bit
for bit. With ``--verbose``, ``--dir-output-figures`` receives the JAX
CLI's figures (:func:`_save_figures`: the 2-D comparison, the measures
against the iteration with ``--reference``), and a 3-D result opens in
ITK-Snap or napari where one is installed
(:func:`nsol_tpu_torch.viewer.try_interactive_3d`).
"""

import contextlib

import numpy as np
import torch

from nsol_tpu_torch import policy, profiling
from nsol_tpu_torch import timer as ph
from nsol_tpu_torch.cli import run_deconvolution
from nsol_tpu_torch.cli.argparser import InputArgparser
from nsol_tpu_torch.io import DataReader, DataWriter
from nsol_tpu_torch.observer import Observer
from nsol_tpu_torch.ops import grad as G
from nsol_tpu_torch.ops import measures as sim
from nsol_tpu_torch.ops import prox as prox_ops
from nsol_tpu_torch.ops.cuda.fused import (PD_TYPES,
                                           make_fused_pd_denoise_solver)
from nsol_tpu_torch.solvers.wrappers import (ADMMLinearSolver,
                                             PrimalDualSolver)

#: reference quirk: L2 = 8 even in 3-D (nsol/application/run_denoising.py:147)
L2 = 8.0


def denoising_proxes(rtype, b):
    """``(prox_f, prox_g_conj)`` of the denoising type ``rtype`` with the
    data ``b`` (a tensor in scaled units): the shifted soft-threshold (L1
    types) or the closed-form ℓ2 prox, and the TV or Huber conjugate."""
    if rtype in ("TVL1", "HuberL1"):
        def prox_f(x, tau):
            return prox_ops.prox_ell1_denoising(x, tau, b)
    elif rtype in ("TVL2", "HuberL2"):
        def prox_f(x, tau):
            return prox_ops.prox_ell2_denoising(x, tau, b)
    else:
        raise ValueError("Denoising type '%s' not known" % rtype)
    prox_g_conj = (prox_ops.prox_tv_conj if rtype.startswith("TV")
                   else prox_ops.prox_huber_conj)
    return prox_f, prox_g_conj


def main(argv=None):
    input_parser = InputArgparser(
        description="Run TVL1/TVL2/HuberL1/HuberL2 denoising on a GPU")
    input_parser.add_observation(required=True)
    input_parser.add_result(required=False)
    input_parser.add_reference(required=False)
    input_parser.add_reconstruction_type(default="TVL2")
    input_parser.add_measures(default=["PSNR", "RMSE", "SSIM", "NCC", "NMI"])
    input_parser.add_iterations(default=50)
    input_parser.add_solver(default="PD")
    input_parser.add_rho(default=0.1)
    input_parser.add_alpha(default=[0.03])
    input_parser.add_dir_output_figures(default=None)
    input_parser.add_verbose(default=0)
    input_parser.add_trace(default=None)
    input_parser.add_device(default="cuda")
    args = input_parser.parse_args(argv)
    input_parser.print_arguments(args)

    if args.solver not in ("PD", "ADMM"):
        raise ValueError("Solver '%s' not known" % args.solver)
    rtype = args.reconstruction_type
    if rtype not in PD_TYPES:
        raise ValueError("Denoising type '%s' not known" % rtype)
    if args.solver == "ADMM" and rtype != "TVL2":
        raise ValueError("ADMM denoising supports TVL2 only")

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
    x_ref = None
    if args.reference is not None:
        ref_reader = DataReader(args.reference)
        ref_reader.read_data()
        x_ref = ref_reader.get_data()
    x_scale = np.max(observed_nda)

    def write(recon):
        if args.result is not None:
            DataWriter(recon, args.result,
                       data_reader.get_image_nifti()).write_data()

    tracer = (profiling.trace(args.trace) if args.trace
              else contextlib.nullcontext())
    recons, observers = [], []
    with tracer:
        if args.solver == "PD" and x_ref is None \
                and observed_nda.ndim in (2, 3):
            _fused_route(args, observed_nda, x_scale, alphas, write, recons,
                         observers)
        else:
            _generic_route(args, observed_nda, x_ref, x_scale, alphas, write,
                           recons, observers)

    # --------------------------- Visualization -----------------------------
    if args.verbose and args.dir_output_figures is not None:
        _save_figures(args, observed_nda, recons, alphas, observers)
    if args.verbose and observed_nda.ndim == 3:
        # the reference opens a 3-D result in ITK-Snap
        # (run_denoising.py:197-248): here where a viewer is installed
        from nsol_tpu_torch.viewer import try_interactive_3d

        spacing = None
        if data_reader.get_image_nifti() is not None:
            spacing = np.array(data_reader.get_image_nifti().get_spacing())
        try_interactive_3d([observed_nda] + recons,
                           ["observed"] + ["alpha=%g" % a for a in alphas],
                           spacing=spacing)
    return 0


def _fused_route(args, observed_nda, x_scale, alphas, write, recons,
                 observers):
    """Every α one whole fused solve (ALG2) on ``b/x_scale``."""
    solve = make_fused_pd_denoise_solver(
        observed_nda.shape, args.reconstruction_type, alg_type="ALG2",
        iterations=args.iterations,
        **policy.pd_options(observed_nda.shape, args.device))
    b = torch.as_tensor(observed_nda / x_scale, dtype=torch.float32,
                        device=args.device)
    for alpha in alphas:
        tm = ph.start_timing()
        x = solve(b, b, float(alpha), L2)
        recon = x.cpu().numpy().astype(np.float64) * x_scale
        if args.verbose:
            ph.print_info("Required computational time: %s"
                          % ph.stop_timing(tm))
        write(recon)
        recons.append(recon)
        observers.append(None)


def _generic_route(args, observed_nda, x_ref, x_scale, alphas, write, recons,
                   observers):
    """The solver classes, one run per α, with an observer of the
    similarity measures against ``x_ref`` where it is given."""
    rtype = args.reconstruction_type
    dtype = torch.get_default_dtype()
    b = torch.as_tensor(observed_nda / x_scale, dtype=dtype,
                        device=args.device)
    grad_op, grad_adj = G.make_gradient_operators()
    measures_dic = None
    if x_ref is not None and args.measures:
        ref = torch.as_tensor(x_ref, dtype=dtype, device=args.device)
        measures_dic = {
            m: (lambda x, m=m: sim.SIMILARITY_MEASURES[m](
                torch.as_tensor(x, dtype=dtype, device=ref.device), ref))
            for m in args.measures}
    for alpha in alphas:
        if args.solver == "PD":
            prox_f, prox_g_conj = denoising_proxes(rtype, b)
            solver = PrimalDualSolver(
                prox_f=prox_f, prox_g_conj=prox_g_conj, B=grad_op,
                B_conj=grad_adj, L2=L2, x0=np.array(observed_nda),
                alpha=alpha, iterations=args.iterations, x_scale=x_scale,
                verbose=args.verbose, device=args.device)
        else:
            def ident(z):
                return z

            solver = ADMMLinearSolver(
                A=ident, A_adj=ident, b=np.array(observed_nda), B=grad_op,
                B_adj=grad_adj, x0=np.array(observed_nda),
                dimension=observed_nda.ndim, alpha=alpha, rho=args.rho,
                iterations=args.iterations, x_scale=x_scale,
                verbose=args.verbose, device=args.device)
        observer = None
        if measures_dic is not None:
            observer = Observer()
            observer.set_measures(measures_dic)
            solver.set_observer(observer)
        solver.run()
        if args.verbose:
            ph.print_info("Required computational time: %s"
                          % solver.get_computational_time())
        write(solver.get_x())
        recons.append(solver.get_x())
        observers.append(observer)


def _save_figures(args, observed, recons, alphas, observers):
    """The JAX CLI's figures (``nsol_tpu/cli/run_denoising.py:199-231``),
    those of the deconvolution CLI: a 2-D input beside each α's
    reconstruction, and with ``--reference`` each measure against the
    iteration."""
    measures = args.measures if observers[0] is not None else ()
    run_deconvolution._save_figures(args, observed, recons, alphas,
                                    observers, measures)


if __name__ == "__main__":
    main()
