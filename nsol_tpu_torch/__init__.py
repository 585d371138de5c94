"""nsol_tpu_torch — the PyTorch/CUDA port of ``nsol_tpu``.

A second package beside the JAX reference ``nsol_tpu``. Module paths and
function names mirror the reference so each counterpart is easy to find;
inside, the code is plain PyTorch on tensors whose device follows the
inputs (or an explicit ``device=`` argument). The hot paths of TV-L2 and
robust deconvolution by ADMM, of TV/Huber denoising by primal-dual and of
TK0/TK1 Tikhonov deconvolution, the deconvolution parameter studies
over them (the solver classes, ``study``, ``interface`` and the CLIs),
and the sharded TV / robust deconvolution and TV denoising of
:mod:`nsol_tpu_torch.parallel` (one process per GPU over
``torch.distributed``, each rank's slab through the prepadded window
kernels) run on an NVIDIA H100 through CUDA C++ kernels written for
``sm_90a`` (``csrc/``, bound in :mod:`nsol_tpu_torch.ops.cuda`). The
non-separable blur (FFT and direct forms), the ``lsq_linear``,
``least_squares`` and box L-BFGS engines, ``Optimize``, PCA, ``Noise``,
the corruption CLI and the generation of the stand-in inputs run in plain
PyTorch on the same card, as the reference leaves them outside its
kernels. Parameter sweeps split over the ranks of a ``"batch"`` mesh
(``run_sweep(mesh=...)``); :mod:`nsol_tpu_torch.profiling` traces a solve
with ``torch.profiler``; the figures (the CLIs' ``--dir-output-figures``,
``nsol_torch_show_parameter_study``, ``PCA.show``) import matplotlib only
where they draw, and :mod:`nsol_tpu_torch.viewer` opens 3-D results in
ITK-Snap or napari where one is installed.

The package imports torch, numpy and scipy only — never ``jax`` or
``nsol_tpu`` — and has no global platform switch.
"""

from nsol_tpu_torch.__about__ import __version__  # noqa: F401
