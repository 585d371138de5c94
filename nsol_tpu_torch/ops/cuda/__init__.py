"""CUDA kernels of the deconvolution and denoising paths (sources in
``csrc/``), each with its plain PyTorch version and launch counter:
``blocked`` (normal apply, CG step and update) and ``fused`` (ADMM tail and
the whole ADMM solve; the primal-dual units and the whole denoising
solve)."""
