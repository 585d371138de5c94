"""nsol_tpu_torch — the PyTorch/CUDA port of ``nsol_tpu``.

A second package beside the JAX reference ``nsol_tpu``. Module paths and
function names mirror the reference so each counterpart is easy to find;
inside, the code is plain PyTorch on tensors whose device follows the
inputs (or an explicit ``device=`` argument). The hot paths of 3-D TV-L2
deconvolution by ADMM and of TV/Huber denoising by primal-dual run on an
NVIDIA H100 through CUDA C++ kernels written for ``sm_90a`` (``csrc/``,
bound in :mod:`nsol_tpu_torch.ops.cuda`).

The package imports torch, numpy and scipy only — never ``jax`` or
``nsol_tpu`` — and has no global platform switch.
"""

from nsol_tpu_torch.__about__ import __version__  # noqa: F401
