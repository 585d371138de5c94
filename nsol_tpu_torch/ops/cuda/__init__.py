"""CUDA kernels of the deconvolution and denoising paths (sources in
``csrc/``), each with its plain PyTorch version and launch counter:
``blocked`` (normal apply, CG step and update), ``fused`` (ADMM tail and
the whole ADMM solve; the primal-dual units and the whole denoising
solve), ``robust`` (the IRLS units and solve), ``record`` (the ADMM
study's in-solve L-curve records) and ``tikhonov`` (the entry/exit clip and
the whole TK0/TK1 solve over a batch of configurations)."""
