"""Corruption and data generation of ``nsol_tpu_torch`` against the JAX
package on the CPU: ``Noise`` bit for bit for all four types, the
corruption CLI (``nsol_torch_corrupt_data --device cpu``) against the JAX
CLI on a small NIfTI (1e-5 · max) and a PNG (within one grey level), its
argparser helpers, and ``generate_standalone_data`` reproducing all nine
frozen content hashes without Pillow, again on a second run."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nsol_tpu_torch import data  # noqa: E402
from nsol_tpu_torch.cli import argparser as targ  # noqa: E402
from nsol_tpu_torch.cli import corrupt_data as tcli  # noqa: E402
from nsol_tpu_torch.io import read_nifti, read_png, write_nifti  # noqa: E402
from nsol_tpu_torch.io import write_png  # noqa: E402
from nsol_tpu_torch.noise import Noise  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOISES = ("gaussian", "poisson", "uniform", "salt_and_pepper")


def _jax(module):
    pytest.importorskip("jax.numpy")
    return pytest.importorskip("nsol_tpu." + module)


def _add(noise, kind):
    if kind == "gaussian":
        noise.add_gaussian_noise(noise_level=0.07, sigma=1)
    elif kind == "poisson":
        noise.add_poisson_noise(noise_level=0.07, lmbda=1)
    elif kind == "uniform":
        noise.add_uniform_noise(noise_level=0.07)
    else:
        noise.add_salt_and_pepper_noise(salt_vs_pepper=0.4, amount=0.2)
    return noise.get_noisy_data()


@pytest.mark.parametrize("kind", NOISES)
def test_noise_matches_reference_bit_for_bit(kind):
    JN = _jax("noise")
    x = np.random.RandomState(3).rand(7, 9, 5) * 40.0
    got = _add(Noise(x, seed=11), kind)
    want = _add(JN.Noise(x, seed=11), kind)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # a tensor enters as its host copy, and the input is not written
    again = _add(Noise(torch.as_tensor(x), seed=11), kind)
    assert np.array_equal(again, want)
    np.testing.assert_array_equal(x, np.random.RandomState(3).rand(
        7, 9, 5) * 40.0)


def _run_jax_cli(argv, monkeypatch):
    jcli = _jax("cli.corrupt_data")
    monkeypatch.setattr(sys, "argv", ["nsol_corrupt_data"] + argv)
    jcli.main()


@pytest.mark.parametrize("noise", ["gaussian", "salt_and_pepper", "none"])
@pytest.mark.parametrize("blur", [["1"], ["0.8", "1.2", "0.6"], ["0"]])
def test_corrupt_cli_nifti_matches_jax_cli(tmp_path, monkeypatch, noise,
                                           blur):
    """A 12 × 10 × 9 NIfTI with spacing: the port's CLI (float32 FFT blur)
    against the JAX CLI (float64) at 1e-5 · max, the header kept."""
    src = str(tmp_path / "x.nii.gz")
    write_nifti(np.random.RandomState(5).rand(12, 10, 9) * 100.0, src,
                spacing=(1.25, 0.8, 1.0))
    got_p, want_p = str(tmp_path / "t.nii.gz"), str(tmp_path / "j.nii.gz")
    flags = ["--noise", noise, "--blur"] + blur
    assert tcli.main(["--filename", src, "--result", got_p, "--device",
                      "cpu"] + flags) == 0
    _run_jax_cli(["--filename", src, "--result", want_p] + flags,
                 monkeypatch)
    got, want = read_nifti(got_p), read_nifti(want_p)
    assert got.data.shape == want.data.shape
    np.testing.assert_allclose(got.data, want.data, rtol=0,
                               atol=1e-5 * np.abs(want.data).max())
    np.testing.assert_allclose(got.spacing, want.spacing)


@pytest.mark.parametrize("noise", ["gaussian", "uniform"])
def test_corrupt_cli_png_matches_jax_cli(tmp_path, monkeypatch, noise):
    """A 32 × 32 crop of the Lena stand-in: every pixel within one grey
    level of the JAX CLI's (modulo 256: the writer wraps a negative value,
    as the reference's does)."""
    src = str(tmp_path / "x.png")
    write_png(read_png(data.path("2D_Lena_256.png"))[100:132, 80:112], src)
    got_p, want_p = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    flags = ["--noise", noise, "--noise-level", "0.1"]
    assert tcli.main(["--filename", src, "--result", got_p, "--device",
                      "cpu"] + flags) == 0
    _run_jax_cli(["--filename", src, "--result", want_p] + flags,
                 monkeypatch)
    d = np.abs(read_png(got_p).astype(int) - read_png(want_p).astype(int))
    assert np.minimum(d, 256 - d).max() <= 1


def test_corrupt_cli_refusals(tmp_path):
    src = str(tmp_path / "x.nii.gz")
    write_nifti(np.ones((8, 8, 8)), src)
    out = str(tmp_path / "y.nii.gz")
    with pytest.raises(IOError, match="1- or d-dimensional"):
        tcli.main(["--filename", src, "--result", out, "--blur", "1", "2",
                   "--device", "cpu"])
    with pytest.raises(IOError, match="not known"):
        tcli.main(["--filename", src, "--result", out, "--noise", "pink",
                   "--device", "cpu"])


def test_argparser_noise_helpers_match_reference():
    """``add_filename``, ``add_noise`` and ``add_noise_level`` take the
    reference's flags and defaults."""
    jarg = _jax("cli.argparser")
    parsers = []
    for mod in (targ, jarg):
        p = mod.InputArgparser()
        p.add_filename(required=True)
        p.add_noise(default="gaussian")
        p.add_noise_level(default=0.05)
        parsers.append(p)
    for argv in (["--filename", "a.png"],
                 ["--filename", "b.nii.gz", "--noise", "poisson",
                  "--noise-level", "0.2"]):
        got, want = (vars(p.parse_args(argv)) for p in parsers)
        assert got == want
    assert targ.NOISE_TYPES == jarg.NOISE_TYPES


def test_generate_standalone_data_reproduces_frozen_hashes(tmp_path):
    """All nine stand-ins from numpy, scipy and the port's own writers,
    verified against the reference's frozen content hashes; a second run
    keeps them; a changed file fails the check."""
    jdata = _jax("data")
    assert data.CONTENT_SHA256 == jdata._CONTENT_SHA256
    out = str(tmp_path / "gen")
    assert data.generate_standalone_data(out) == out
    names = sorted(os.listdir(out))
    assert names == sorted(data.CONTENT_SHA256)
    stamps = {n: os.stat(os.path.join(out, n)).st_mtime_ns for n in names}
    os.remove(os.path.join(out, "2D_House_256.png"))
    data.generate_standalone_data(out)
    data.verify_standalone_data(out)
    for n in names:
        if n != "2D_House_256.png":
            assert os.stat(os.path.join(out, n)).st_mtime_ns == stamps[n]
    for n in ("2D_Lena_256_noise.png", "3D_SheppLoganPhantom_64.nii.gz"):
        assert data._content_hash(os.path.join(out, n)) == \
            jdata._content_hash(os.path.join(REPO, ".generated_data", n))
    write_png(np.zeros((4, 4), np.uint8), os.path.join(out, "2D_Man_1024.png"))
    with pytest.raises(RuntimeError, match="2D_Man_1024.png"):
        data.verify_standalone_data(out)


def test_generation_imports_nothing_before_its_check(tmp_path):
    """R5: on a complete directory ``generate_standalone_data`` returns
    before it imports the writers or scipy, and the module never imports
    Pillow; ``data_dir`` resolves the tracked stand-ins as a no-op."""
    code = ("import sys, nsol_tpu_torch.data as d; "
            "d.generate_standalone_data(d.data_dir()); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('PIL', 'scipy') or m.startswith('nsol_tpu_torch.io')))")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("NSOL_TPU_DATA_DIR", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
