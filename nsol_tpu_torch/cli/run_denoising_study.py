"""Run a denoising parameter study: a sweep over α (counterpart of
``nsol_tpu/cli/run_denoising_study.py``; reference:
nsol/application/run_denoising_study.py:36-205). Console script
``nsol_torch_run_denoising_study``.

A :class:`~nsol_tpu_torch.solvers.wrappers.PrimalDualSolver` with the
denoising proxes of ``--reconstruction-type`` (L2 = 8, the observation as
``x0``, ``x_scale = max(b)``) runs through
:class:`~nsol_tpu_torch.study.PrimalDualSolverParameterStudy`; its
``reconstruction_type``/``observation`` hints let ``run_sweep`` take the
fused denoising solve with the Reg/Data records inside it, on
``--device cuda`` (the default) the kernels of ``csrc/pd.cu`` — in bf16
state under ``NSOL_TPU_COMPACT=1`` where
:func:`nsol_tpu_torch.policy.pd_options` allows it —, on ``--device cpu``
their plain versions. ``--reference`` adds the similarity measures, which
the generic solve records. The study files have the JAX package's schema.

The reference's quirk is kept: ``Data`` is SSD (L2 types) or SAD (L1
types) of the rescaled iterate against the unscaled observation, without
the ½ of the deconvolution interface's data cost (:94-99).
"""

import numpy as np
import torch

from nsol_tpu_torch.cli.argparser import InputArgparser
from nsol_tpu_torch.cli.run_denoising import L2, denoising_proxes
from nsol_tpu_torch.io import DataReader
from nsol_tpu_torch.observer import Observer
from nsol_tpu_torch.ops import grad as G
from nsol_tpu_torch.ops import measures as sim
from nsol_tpu_torch.ops import priors
from nsol_tpu_torch.solvers.wrappers import PrimalDualSolver
from nsol_tpu_torch.study import PrimalDualSolverParameterStudy


def main(argv=None):
    input_parser = InputArgparser(description="Run denoising algorithm study")
    input_parser.add_observation(required=True)
    input_parser.add_reference(required=False)
    input_parser.add_dir_output(required=True)
    input_parser.add_study_name()
    input_parser.add_reconstruction_type(default="TVL2")
    input_parser.add_measures(default=["PSNR", "RMSE", "SSIM", "NCC", "NMI"])
    input_parser.add_iterations(default=200)
    input_parser.add_rho(default=0.1)
    input_parser.add_verbose(default=0)
    input_parser.add_alpha_range(default=[0.01, 1.5, 10])
    input_parser.add_data_losses(default=None)
    input_parser.add_data_loss_scale_range(default=None)
    input_parser.add_device(default="cuda")
    args = input_parser.parse_args(argv)
    input_parser.print_arguments(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")

    data_reader = DataReader(args.observation)
    data_reader.read_data()
    observed_nda = data_reader.get_data()
    dtype = torch.get_default_dtype()

    def tensor(a):  # measures see tensors in a sweep, numpy arrays after
        return torch.as_tensor(a, dtype=dtype, device=args.device)

    x_ref = None
    if args.reference is not None:
        ref_reader = DataReader(args.reference)
        ref_reader.read_data()
        x_ref = tensor(ref_reader.get_data())

    # ---------------------------- Set up solver ----------------------------
    x_scale = np.max(observed_nda)
    b_scaled = observed_nda / x_scale
    b_full = tensor(observed_nda)
    grad_op, grad_adj = G.make_gradient_operators()
    rtype = args.reconstruction_type
    prox_f, prox_g_conj = denoising_proxes(rtype, tensor(b_scaled))
    solver = PrimalDualSolver(
        prox_f=prox_f, prox_g_conj=prox_g_conj, B=grad_op, B_conj=grad_adj,
        L2=L2, x0=np.array(observed_nda), iterations=args.iterations,
        x_scale=x_scale, verbose=args.verbose, reconstruction_type=rtype,
        observation=b_scaled, device=args.device)

    # --------------------------- Measures dict -----------------------------
    measures_dic = {}
    if x_ref is not None and args.measures:
        measures_dic = {
            m: (lambda x, m=m: sim.SIMILARITY_MEASURES[m](tensor(x), x_ref))
            for m in args.measures}
    if rtype.startswith("TV"):
        measures_dic["Reg"] = lambda x: priors.total_variation(tensor(x),
                                                               grad_op)
    else:
        measures_dic["Reg"] = lambda x: priors.huber(tensor(x), grad_op)
    if rtype.endswith("L1"):
        measures_dic["Data"] = lambda x: sim.sum_of_absolute_differences(
            tensor(x), b_full)
    else:
        measures_dic["Data"] = lambda x: sim.sum_of_squared_differences(
            tensor(x), b_full)
    observer = Observer()
    observer.set_measures(measures_dic)
    solver.set_observer(observer)

    # ---------------------------- Parameters -------------------------------
    parameters = {"alpha": np.linspace(
        args.alpha_range[0], args.alpha_range[1], int(args.alpha_range[2]))}
    if args.data_losses is not None:
        parameters["data_loss"] = args.data_losses
    if args.data_loss_scale_range is not None:
        parameters["data_loss_scale"] = np.linspace(
            args.data_loss_scale_range[0], args.data_loss_scale_range[1],
            int(args.data_loss_scale_range[2]))

    name = args.study_name if args.study_name is not None else rtype
    parameter_study = PrimalDualSolverParameterStudy(
        solver, observer, dir_output=args.dir_output,
        parameters=parameters, name=name,
        reconstruction_info=data_reader.get_reconstruction_info())
    parameter_study.run()

    print("\nComputational time for Denoising Parameter Study %s: %s"
          % (name, parameter_study.get_computational_time()))
    return 0


if __name__ == "__main__":
    main()
