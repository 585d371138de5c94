"""The port's figures, viewer and tracing against the JAX package's.

Every figure either package saves is recorded instead of written
(``matplotlib.figure.Figure.savefig`` patched): its file name, each line's
x and y data, each image's array and each collection's points (scatter
offsets, quiver origins and vectors, 3-D segments, contour vertices). The
two packages' records are held to each other:

* ``cli/show_parameter_study.py`` (L-curve, measures with the synthesized
  Cost, the 2-D gallery, the 3-D orthogonal slices with spacing and the
  mask contour) on studies the port's study CLI wrote: the same file names
  and every series to 1e-12, both sides reading the same files;
* the CLIs' ``_save_figures`` under ``--verbose --dir-output-figures`` on
  small PNG crops: the same file names, the data within the tolerances the
  CLI tests hold the port to the JAX CLIs (1e-9 on the generic routes in
  float64, 1e-5 on the port's float32 fused route);
* ``PrincipalComponentAnalysis.show``: the same scatter and quiver data.

``viewer.try_interactive_3d`` is held to ``tests/test_cli.py:445`` and its
NIfTI files to the JAX package's; ``profiling`` to ``tests/test_cli.py:475,
494`` and to the untraced CLI runs, bit for bit.
"""

import json
import os
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("matplotlib")

from nsol_tpu_torch import data, profiling  # noqa: E402
from nsol_tpu_torch.io import (read_nifti, read_png, write_nifti,  # noqa: E402
                               write_png)

#: the CLI tests' tolerance against the JAX CLIs in float64
#: (tests/test_torch_pd_surface.py::TOL), and on the port's float32 fused
#: denoising route (tests/test_torch_pd.py::test_denoising_cli_cpu_matches_
#: jax_solve)
TOL, FUSED_TOL = 1e-9, 1e-5
#: both show CLIs read the same files
SERIES_TOL = 1e-12


def _jax(module):
    """A module of the JAX package (skips where jax is absent)."""
    return pytest.importorskip("nsol_tpu." + module)


@pytest.fixture
def f64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _arrays(*items):
    return tuple(np.asarray(np.ma.getdata(a), dtype=np.float64)
                 for a in items)


def _contents(fig):
    """What a figure shows, as ``(kind, arrays...)`` tuples."""
    out = []
    for ax in fig.axes:
        out += [("line",) + _arrays(ln.get_xdata(), ln.get_ydata())
                for ln in ax.get_lines()]
        out += [("image",) + _arrays(im.get_array())
                for im in ax.get_images()]
        for c in ax.collections:
            if hasattr(c, "U"):
                out.append(("quiver",) + _arrays(c.X, c.Y, c.U, c.V))
            elif hasattr(c, "_segments3d"):
                out.append(("segments",) + _arrays(c._segments3d))
            elif hasattr(c, "_offsets3d"):
                out.append(("points3d",) + _arrays(c._offsets3d))
            else:
                out.append(("collection",) + _arrays(
                    c.get_offsets(), *[p.vertices for p in c.get_paths()]))
    return out


@pytest.fixture
def figures(monkeypatch):
    """``{file name: contents}`` of every figure saved while it is used."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib.figure import Figure

    saved = {}

    def savefig(self, fname, *args, **kwargs):
        saved[os.path.basename(str(fname))] = _contents(self)

    monkeypatch.setattr(Figure, "savefig", savefig)
    return saved


def _same_figures(got, want, tol):
    assert sorted(got) == sorted(want) and want
    for name in want:
        assert [i[0] for i in got[name]] == [i[0] for i in want[name]], name
        for g_item, w_item in zip(got[name], want[name]):
            for g, w in zip(g_item[1:], w_item[1:]):
                assert g.shape == w.shape, (name, g_item[0])
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=tol * max(1.0, np.abs(w).max()),
                    err_msg="%s: %s" % (name, g_item[0]))


def _jax_main(module, argv, monkeypatch):
    """Run a CLI of the JAX package in this process."""
    cli = _jax("cli." + module)
    monkeypatch.setenv("NSOL_TPU_COMPILE_CACHE", "")
    monkeypatch.setattr(sys, "argv", [module] + argv)
    cli.main()


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """Crops of the blurred noisy, the noisy and the clean Lena (PNG)."""
    d = tmp_path_factory.mktemp("pngs")
    out = {}
    for key, name in (("blur", "2D_Lena_256_blur_noise.png"),
                      ("noise", "2D_Lena_256_noise.png"),
                      ("clean", "2D_Lena_256.png")):
        out[key] = str(d / (key + ".png"))
        write_png(read_png(data.path(name))[100:124, 90:122], out[key])
    return out


# ------------------------------------------------------- the show CLI --

def _volume_study(tmp_path):
    """A 3-D denoising study of the port's study CLI on an anisotropic
    NIfTI, and a mask over the same grid."""
    from nsol_tpu_torch.cli import run_denoising_study

    rs = np.random.RandomState(17)
    vol = np.zeros((6, 8, 10))
    vol[1:5, 2:6, 3:8] = 100.0
    spacing = np.array([1.0, 1.25, 0.8])
    obs, mask = str(tmp_path / "b.nii.gz"), str(tmp_path / "mask.nii.gz")
    write_nifti((vol + 10 * rs.rand(*vol.shape)).astype(np.float32), obs,
                spacing=spacing)
    write_nifti((vol > 0).astype(np.float32), mask, spacing=spacing)
    out = str(tmp_path / "study")
    assert run_denoising_study.main([
        "--observation", obs, "--dir-output", out, "--iterations", "4",
        "--alpha-range", "0.01", "0.05", "2", "--study-name", "vol",
        "--device", "cpu"]) == 0
    return out, "vol", ["--reference-mask", mask]


def _image_study(tmp_path, pngs):
    """A 2-D denoising study of the port's study CLI with the similarity
    measures (α alone varies: the synthesized Cost)."""
    from nsol_tpu_torch.cli import run_denoising_study

    out = str(tmp_path / "study")
    assert run_denoising_study.main([
        "--observation", pngs["noise"], "--reference", pngs["clean"],
        "--dir-output", out, "--iterations", "4", "--measures", "RMSE",
        "PSNR", "--alpha-range", "0.01", "0.05", "3", "--study-name", "img",
        "--device", "cpu"]) == 0
    return out, "img", ["--reference", pngs["clean"]]


@pytest.mark.parametrize("kind", ["image", "volume"])
def test_show_parameter_study_matches_jax(f64, tmp_path, monkeypatch,
                                          figures, pngs, kind):
    """Both show CLIs on a study the port wrote: the same figures — the
    L-curve, every measure with the Cost, the 2-D gallery with the
    reference, or each volume's three orthogonal slices with the mask's
    contour — with every series equal to 1e-12."""
    from nsol_tpu_torch.cli import show_parameter_study

    out, name, extra = (_image_study(tmp_path, pngs) if kind == "image"
                        else _volume_study(tmp_path))
    argv = ["--dir-input", out, "--study-name", name,
            "--dir-output-figures", str(tmp_path / "figs")] + extra
    assert show_parameter_study.main(argv) == 0
    got = dict(figures)
    figures.clear()
    _jax_main("show_parameter_study", argv, monkeypatch)
    _same_figures(got, figures, SERIES_TOL)
    assert "%s_L-curve.pdf" % name in got and "%s_Cost.pdf" % name in got
    if kind == "volume":
        recon = [v for k, v in got.items() if "_recon_" in k][0]
        assert [i[0] for i in recon] == ["image", "collection"] * 3


# ------------------------------------------------ the CLIs' --verbose --

#: (CLI, arguments, tolerance): the generic denoising and the interface's
#: Tikhonov route with --reference (the measures' figures), and the port's
#: fused denoising route against the JAX CLI's generic one on the CPU
CLI_FIGURES = {
    "denoising": ("run_denoising", [
        "--observation", "noise", "--reference", "clean", "--measures",
        "RMSE", "PSNR", "--alpha", "0.03", "0.1", "--iterations", "5"], TOL),
    "denoising_fused": ("run_denoising", [
        "--observation", "noise", "--alpha", "0.03", "0.1", "--iterations",
        "5"], FUSED_TOL),
    "deconvolution": ("run_deconvolution", [
        "--observation", "blur", "--reference", "clean", "--measures",
        "RMSE", "--reconstruction-type", "TK1L2", "--alpha", "0.01", "0.05",
        "--iter-max", "3"], TOL),
}


@pytest.mark.parametrize("case", sorted(CLI_FIGURES))
def test_cli_figures_match_jax(f64, tmp_path, monkeypatch, figures, pngs,
                               case):
    """``--verbose 1 --dir-output-figures`` of both packages' CLIs: the same
    files (the comparison and, with --reference, each measure against the
    iteration), the data within the CLI tests' tolerances."""
    import importlib

    module, argv, tol = CLI_FIGURES[case]
    argv = [pngs.get(a, a) for a in argv] + [
        "--verbose", "1", "--dir-output-figures", str(tmp_path / "figs")]
    cli = importlib.import_module("nsol_tpu_torch.cli." + module)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = dict(figures)
    figures.clear()
    _jax_main(module, argv, monkeypatch)
    _same_figures(got, figures, tol)
    assert ("TVL2_RMSE.pdf" in got) == (case == "denoising")


@pytest.mark.parametrize("dim", [2, 3])
def test_pca_show_matches_jax(f64, figures, tmp_path, dim):
    """``PrincipalComponentAnalysis.show`` draws the JAX package's scatter
    and arrows from the same eigenpairs (eigenvectors agree up to sign,
    ``tests/test_torch_engines.py``; each is turned to JAX's sign here)."""
    from nsol_tpu_torch.pca import PrincipalComponentAnalysis

    pts = np.random.RandomState(19).randn(40, dim) @ np.diag(
        [3.0, 1.0, 0.5][:dim])
    ref = _jax("pca").PrincipalComponentAnalysis(pts)
    ref.run()
    pca = PrincipalComponentAnalysis(pts, device="cpu")
    pca.run()
    signs = np.sign(np.sum(pca.get_eigvec() * ref.get_eigvec(), axis=0))
    pca._eigvec = pca.get_eigvec() * signs
    pca.show(path=str(tmp_path / "pca.png"), step=2)
    got = dict(figures)
    figures.clear()
    ref.show(path=str(tmp_path / "pca.png"), step=2)
    _same_figures(got, figures, 1e-10)
    assert [i[0] for i in got["pca.png"]] == (
        ["points3d"] + ["segments"] * 3 if dim == 3
        else ["collection"] + ["quiver"] * 2)


# -------------------------------------------------------------- viewer --

def _fake_itksnap(tmp_path, name):
    """An ``itksnap`` that writes its arguments to ``name``.txt."""
    fake = tmp_path / ("bin_" + name)
    fake.mkdir()
    exe = fake / "itksnap"
    exe.write_text("#!/bin/sh\necho \"$@\" > %s\n"
                   % (tmp_path / (name + ".txt")))
    exe.chmod(0o755)
    return str(fake)


def test_viewer_matches_jax(tmp_path, monkeypatch):
    """tests/test_cli.py:445 on the port: no viewer → False; a fake
    ``itksnap`` on PATH gets ``-g``/``-o``/``-s`` and NIfTI files whose
    arrays and spacing equal the ones the JAX package writes."""
    from nsol_tpu_torch.viewer import try_interactive_3d

    jax_view = _jax("viewer").try_interactive_3d
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    vols = [np.random.RandomState(0).rand(4, 5, 6).astype(np.float32)]
    assert try_interactive_3d(vols, ["a"]) is False  # headless fallback
    seg = (vols[0] > 0.5).astype(np.float32)
    path = os.environ.get("PATH", "")
    args = {}
    for name, view in (("port", try_interactive_3d), ("jax", jax_view)):
        monkeypatch.setenv("PATH", _fake_itksnap(tmp_path, name)
                           + os.pathsep + path)
        assert view(vols + [vols[0] * 2], ["a", "b=2"],
                    spacing=np.array([1.0, 1.5, 2.0]), segmentation=seg,
                    block=True)
        args[name] = (tmp_path / (name + ".txt")).read_text().split()
    got, want = args["port"], args["jax"]
    assert [a for a in got if a.startswith("-")] == ["-g", "-o", "-s"]
    assert [a for a in got if a.startswith("-")] == \
        [a for a in want if a.startswith("-")]
    for g, w in zip(got, want):
        if g.startswith("-"):
            continue
        assert os.path.basename(g) == os.path.basename(w)
        assert g.endswith(".nii.gz") and os.path.isfile(g)
        gi, wi = read_nifti(g), read_nifti(w)
        np.testing.assert_array_equal(gi.data, wi.data)
        np.testing.assert_array_equal(gi.get_spacing(), wi.get_spacing())


# ------------------------------------------------------------- tracing --

@pytest.mark.parametrize("module", ["run_denoising", "run_deconvolution"])
def test_trace_writes_json_and_keeps_the_bits(tmp_path, pngs, module):
    """tests/test_cli.py:475 on the port: ``--trace DIR`` writes a trace
    that parses, and the traced run's result is the untraced one's, bit for
    bit (the fused routes' plain versions on the CPU)."""
    import importlib

    import scipy.io

    cli = importlib.import_module("nsol_tpu_torch.cli." + module)
    argv = ["--observation", pngs["noise" if module == "run_denoising"
                                  else "blur"],
            "--iterations", "3", "--device", "cpu"]
    if module == "run_deconvolution":
        argv += ["--solver", "ADMM", "--iter-max", "3"]
    results = []
    for trace in (None, str(tmp_path / "trace")):
        results.append(str(tmp_path / ("x%d.mat" % len(results))))
        assert cli.main(argv + ["--result", results[-1]]
                        + (["--trace", trace] if trace else [])) == 0
    x0, x1 = (scipy.io.loadmat(r)["nda"] for r in results)
    assert x0.dtype == x1.dtype and np.array_equal(x0, x1)
    files = os.listdir(str(tmp_path / "trace"))
    assert len(files) == 1 and files[0].endswith(".json")
    with open(str(tmp_path / "trace" / files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


def test_trace_prints_its_path_and_annotate_runs_outside_a_trace(
        tmp_path, capsys):
    """tests/test_cli.py:494: ``annotate`` is usable outside a trace; inside
    one it names a region of the trace. ``create_perfetto_link=True`` prints
    the trace's path (no link is served: that needs a network)."""
    with profiling.annotate("solve"):
        assert 1 + 1 == 2
    with profiling.trace(str(tmp_path), create_perfetto_link=True):
        with profiling.annotate("nsol_region"):
            torch.ones(3).sum()
    path = capsys.readouterr().out.split()[3]
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert "nsol_region" in names
