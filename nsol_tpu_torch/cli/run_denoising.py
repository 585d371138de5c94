"""Run TVL1/TVL2/HuberL1/HuberL2 denoising by primal-dual (counterpart of
``nsol_tpu/cli/run_denoising.py``, the fused PD route).

The observation is read with :class:`~nsol_tpu_torch.io.DataReader` (PNG
without Pillow), scaled by ``x_scale = max(b)``, and every α is one whole
solve through
:func:`nsol_tpu_torch.ops.cuda.fused.make_fused_pd_denoise_solver` (ALG2)
on ``b/x_scale`` with ``x0 = b/x_scale``, rescaled on output, as the
reference's fused route does (run_denoising.py:86-136). The reference's
``L2 = 8``, even for 3-D volumes, is kept. ``--device cuda`` runs the CUDA
kernels, ``--device cpu`` their plain versions. Routes of the reference that
are not ported yet raise ``NotImplementedError`` naming their ROADMAP item.
"""

import os

import numpy as np
import torch

from nsol_tpu_torch import timer as ph
from nsol_tpu_torch.cli.argparser import InputArgparser
from nsol_tpu_torch.io import DataReader, DataWriter
from nsol_tpu_torch.ops.cuda.fused import (PD_TYPES,
                                           make_fused_pd_denoise_solver)

#: reference quirk: L2 = 8 even in 3-D (nsol/application/run_denoising.py:147)
L2 = 8.0


def _not_ported(what, item):
    return NotImplementedError(
        "%s is not ported to nsol_tpu_torch yet (ROADMAP.md %s)"
        % (what, item))


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

    if args.solver == "ADMM":
        raise _not_ported("--solver ADMM (identity-A ADMM denoising)",
                          "Queue 1 item 7")
    if args.solver != "PD":
        raise ValueError("Solver '%s' not known" % args.solver)
    if args.reference is not None:
        raise _not_ported("--reference (observer and similarity measures)",
                          "Queue 1 items 7 and 11")
    if args.trace is not None:
        raise _not_ported("--trace (profiling.py)", "Queue 1 item 11")
    if args.dir_output_figures is not None and args.verbose:
        raise _not_ported("--dir-output-figures with --verbose",
                          "Queue 1 item 11")
    if os.environ.get("NSOL_TPU_COMPACT") == "1":
        raise _not_ported("NSOL_TPU_COMPACT=1 (bf16 PD state)",
                          "Queue 2 K10")
    if args.reconstruction_type not in PD_TYPES:
        raise ValueError("Denoising type '%s' not known"
                         % args.reconstruction_type)

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
    if observed_nda.ndim not in (2, 3):
        raise _not_ported("%d-D input (the fused PD solve is 2-D/3-D)"
                          % observed_nda.ndim, "Queue 1 item 7")

    # ---------------------------- Set up solver ----------------------------
    x_scale = np.max(observed_nda)
    solve = make_fused_pd_denoise_solver(
        observed_nda.shape, args.reconstruction_type, alg_type="ALG2",
        iterations=args.iterations)
    b = torch.as_tensor(observed_nda / x_scale, dtype=torch.float32,
                        device=args.device)

    # -------------------------- Run reconstruction -------------------------
    for alpha in alphas:
        tm = ph.start_timing()
        x = solve(b, b, float(alpha), L2)
        recon = x.cpu().numpy().astype(np.float64) * x_scale
        if args.verbose:
            ph.print_info("Required computational time: %s"
                          % ph.stop_timing(tm))
        if args.result is not None:
            DataWriter(recon, args.result,
                       data_reader.get_image_nifti()).write_data()
    return 0


if __name__ == "__main__":
    main()
