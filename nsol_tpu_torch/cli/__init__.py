"""CLI applications of the port: ``run_deconvolution``,
``run_deconvolution_study``, ``run_denoising``, ``run_denoising_study``,
``corrupt_data`` and ``show_parameter_study`` (console scripts
``nsol_torch_<name>``)."""
