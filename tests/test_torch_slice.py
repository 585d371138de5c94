"""The port's deconvolution slice end to end on the CPU: library solve
against the JAX package, the CLI against the library, and the import
boundary (the port runs where jax and PIL are absent)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.ndimage as ndi

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nsol_tpu.ops import conv as JC  # noqa: E402
from nsol_tpu.ops import grad as JG  # noqa: E402
from nsol_tpu.ops import kernels as JK  # noqa: E402
from nsol_tpu.ops.losses import LOSSES  # noqa: E402
from nsol_tpu.ops.measures import SIMILARITY_MEASURES  # noqa: E402
from nsol_tpu.ops.pallas.fused import make_fused_admm_solver as jax_fused  # noqa: E402
from nsol_tpu.solvers.admm import admm_solve as jax_admm  # noqa: E402
from nsol_tpu_torch import interop  # noqa: E402
from nsol_tpu_torch.cli import argparser as targ  # noqa: E402
from nsol_tpu_torch.cli import run_deconvolution as tcli  # noqa: E402
from nsol_tpu_torch.io import read_nifti, write_nifti  # noqa: E402
from nsol_tpu_torch.ops.cuda.fused import make_fused_admm_solver  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _blurred(rng, shape, cov, spacing):
    kern = JK.gaussian_kernel(cov, alpha_cut=3, spacing=spacing)
    x_true = (rng.rand(*shape) > 0.6).astype(np.float64)
    return ndi.convolve(x_true, kern, mode="wrap").astype(np.float32)


def test_slice_16cubed_matches_jax_fused_kernel_and_admm(rng):
    """The port's fused solver (plain versions on the CPU) against the JAX
    fused kernel (interpret mode) and the JAX admm_solve, with anisotropic
    blur and spacing: atol 2e-5 / rtol 1e-5 (tests/test_pallas.py:57)."""
    shape = (16, 16, 16)
    cov = np.diag([0.8, 1.0, 1.3]) ** 2
    spacing = interop.spacing([1.25, 0.8, 2.0], 3)
    b = _blurred(rng, shape, cov, spacing)
    want_fused = np.asarray(jax_fused(
        shape, cov, spacing=spacing, iterations=5, iter_max=6,
        dtype=jnp.float32, interpret=True)(b, b, 0.01, 0.5))
    A, _ = JC.make_blur_operators(cov, spacing=spacing, method="separable",
                                  dtype=np.float32)
    nA = JC.make_normal_blur_operator(cov, spacing=spacing, dtype=np.float32)
    Bg, Bg_adj = JG.make_gradient_operators(spacing)
    want_admm, _ = jax.jit(lambda bb: jax_admm(
        A, A, Bg, Bg_adj, bb, jnp.zeros((3,) + shape, jnp.float32), bb,
        jnp.float32(0.01), jnp.float32(0.5), iterations=5, iter_max=6,
        minimizer="cg", normal_A=nA,
        normal_B=lambda u: JG.gradient_normal(u, spacing)))(jnp.asarray(b))
    solve = make_fused_admm_solver(shape, cov, spacing=spacing,
                                   iterations=5, iter_max=6)
    bt = interop.to_torch(b, "cpu")
    got = interop.to_numpy(solve(bt, bt, 0.01, 0.5))
    np.testing.assert_allclose(got, want_fused, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(want_admm), atol=2e-5,
                               rtol=1e-5)
    assert got.min() >= 0.0


def test_cli_cpu_matches_library(tmp_path, rng):
    """CLI --device cpu on a 16³ .nii.gz == the library solve on
    b/x_scale, rescaled (run_deconvolution.py:79,137,242)."""
    spacing = np.array([1.0, 1.25, 0.8])
    b = 200.0 * _blurred(rng, (16, 16, 16), np.eye(3) * 1.2 ** 2, spacing)
    obs, out = str(tmp_path / "b.nii.gz"), str(tmp_path / "x.nii.gz")
    write_nifti(b, obs, spacing=spacing)
    rc = tcli.main(["--observation", obs, "--result", out, "--solver",
                    "ADMM", "--reconstruction-type", "TVL2", "--alpha",
                    "0.02", "--blur", "1.2", "--iterations", "4",
                    "--iter-max", "5", "--device", "cpu"])
    assert rc == 0
    recon = read_nifti(out).data
    b_read = read_nifti(obs).data.astype(np.float64)
    scale = b_read.max()
    solve = make_fused_admm_solver(b.shape, np.eye(3) * 1.2 ** 2,
                                   spacing=spacing, iterations=4, iter_max=5)
    bs = interop.to_torch((b_read / scale).astype(np.float32), "cpu")
    want = interop.to_numpy(solve(bs, bs, 0.02, 0.5)).astype(
        np.float64) * scale
    assert recon.shape == b.shape and np.all(np.isfinite(recon))
    np.testing.assert_allclose(recon, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(read_nifti(out).spacing, spacing)


@pytest.mark.parametrize("argv", [
    ["--solver", "PD", "--minimizer", "lsq_linear"],
    ["--reconstruction-type", "TK1L2", "--minimizer", "least_squares"],
    ["--solver", "ADMM", "--data-loss", "huber", "--minimizer",
     "L-BFGS-B"]])
def test_cli_unported_routes_raise(tmp_path, monkeypatch, argv):
    """The inner engines these routes once refused are ported: each runs
    through the interface as in the JAX CLI, and (in float64) gives the
    JAX CLI's result to 1e-8 of its maximum."""
    import sys

    from nsol_tpu.cli import run_deconvolution as jcli
    from nsol_tpu_torch.io import read_nifti

    obs = str(tmp_path / "b.nii.gz")
    write_nifti(np.random.RandomState(4).rand(8, 7, 6) * 50.0, obs)
    flags = ["--observation", obs, "--iterations", "3", "--iter-max",
             "4"] + argv
    got_p, want_p = str(tmp_path / "x.nii.gz"), str(tmp_path / "j.nii.gz")
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        assert tcli.main(flags + ["--result", got_p, "--device",
                                  "cpu"]) == 0
    finally:
        torch.set_default_dtype(default)
    monkeypatch.setattr(sys, "argv", ["nsol_run_deconvolution"] + flags
                        + ["--result", want_p])
    jcli.main()
    got, want = read_nifti(got_p).data, read_nifti(want_p).data
    assert np.all(np.isfinite(got)) and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-8 * np.abs(want).max())


def test_port_imports_neither_jax_nor_pil():
    code = ("import sys, json, nsol_tpu_torch, nsol_tpu_torch.cli."
            "run_deconvolution, nsol_tpu_torch.cli.run_denoising, "
            "nsol_tpu_torch.cli.run_deconvolution_study, "
            "nsol_tpu_torch.io.png, nsol_tpu_torch.solvers.primal_dual, "
            "nsol_tpu_torch.interop, nsol_tpu_torch.data, "
            "nsol_tpu_torch.natsort, nsol_tpu_torch.observer, "
            "nsol_tpu_torch.solvers.base, nsol_tpu_torch.solvers.wrappers, "
            "nsol_tpu_torch.ops.cuda.tikhonov, nsol_tpu_torch.ops.cuda."
            "record, nsol_tpu_torch.ops.cuda.tiled, nsol_tpu_torch.study, nsol_tpu_torch.study.engine, "
            "nsol_tpu_torch.study.reader, nsol_tpu_torch.study.paths, "
            "nsol_tpu_torch.interface, nsol_tpu_torch.policy, "
            "nsol_tpu_torch.parallel, nsol_tpu_torch.parallel.distributed, "
            "nsol_tpu_torch.parallel.halo, "
            "nsol_tpu_torch.parallel.matmul_halo, "
            "nsol_tpu_torch.parallel.blocked_halo, "
            "nsol_tpu_torch.parallel.mesh, nsol_tpu_torch.noise, "
            "nsol_tpu_torch.optimize, nsol_tpu_torch.pca, "
            "nsol_tpu_torch.solvers.lbfgs, nsol_tpu_torch.ops.conv, "
            "nsol_tpu_torch.cli.corrupt_data;"
            "nsol_tpu_torch.data.generate_standalone_data("
            "nsol_tpu_torch.data.data_dir());"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')"
            "[0] in ('jax', 'jaxlib', 'nsol_tpu', 'PIL'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_argparser_name_lists_match_reference():
    assert tuple(targ.LOSSES) == tuple(LOSSES)
    assert tuple(targ.SIMILARITY_MEASURES) == tuple(SIMILARITY_MEASURES)
