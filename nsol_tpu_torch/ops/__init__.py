"""Operators: stencil construction (kernels), blur (conv), finite
differences (grad), proxes, losses, priors, and the CUDA kernels of the
deconvolution and denoising paths (``ops.cuda``)."""
