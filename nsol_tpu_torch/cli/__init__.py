"""CLI applications of the port: ``run_deconvolution`` and
``run_denoising`` (console scripts ``nsol_torch_run_deconvolution`` and
``nsol_torch_run_denoising``)."""
