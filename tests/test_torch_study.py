"""The port's class, study and CLI surface against the JAX package.

The same numpy inputs, made from a seed, go through both packages in
float64 on the CPU: ``TikhonovLinearSolver`` and ``ADMMLinearSolver``
(``run``, ``run_sweep`` inside the fused kernels' scope — the plain
versions of their unit sequences here — and outside it) to 1e-9, with
``x_scale ≠ 1`` and the records' rescaling; the study engine's serial,
batched and hybrid routes, append/resume and the header check (the checks
of tests/test_study.py); each package's reader on the other's study; the
interface; and the CLIs on the Lena PNG and the 64³ NIfTI phantom with
``--device cpu`` against the JAX package's CLIs, at tests/test_cli.py's
tolerances.
"""

import os
import sys

import numpy as np
import pytest
import scipy.ndimage as ndi

torch = pytest.importorskip("torch")

from nsol_tpu_torch import data  # noqa: E402
from nsol_tpu_torch.cli import run_deconvolution as tcli  # noqa: E402
from nsol_tpu_torch.cli import run_deconvolution_study as tstudy_cli  # noqa: E402
from nsol_tpu_torch.interface import (  # noqa: E402
    DeconvolutionParameterStudyInterface)
from nsol_tpu_torch.observer import Observer  # noqa: E402
from nsol_tpu_torch.ops import conv as TC  # noqa: E402
from nsol_tpu_torch.ops import grad as TG  # noqa: E402
from nsol_tpu_torch.ops import losses as TL  # noqa: E402
from nsol_tpu_torch.ops import priors as TP  # noqa: E402
from nsol_tpu_torch.ops.cuda import fused as F  # noqa: E402
from nsol_tpu_torch.ops.kernels import gaussian_kernel  # noqa: E402
from nsol_tpu_torch.solvers import wrappers as TW  # noqa: E402
from nsol_tpu_torch.study import (  # noqa: E402
    ADMMLinearSolverParameterStudy as TAStudy,
    ReaderParameterStudy as TReader,
    TikhonovLinearSolverParameterStudy as TTStudy)

TOL = 1e-9
COV = np.diag([1.0, 0.8]) ** 2
SPACING = np.array([1.25, 0.8])
DATA_DIR = data.data_dir()


def _jax(module):
    """A module of the JAX package (skips where jax is absent)."""
    return pytest.importorskip("nsol_tpu." + module)


@pytest.fixture
def f64():
    """The port's library dtype set to float64 for one test."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _observed(shape=(12, 14), seed=0, cov=COV, spacing=SPACING):
    """A positive blurred image with a non-unit maximum (x_scale ≠ 1)."""
    rng = np.random.RandomState(seed)
    kern = gaussian_kernel(cov, alpha_cut=3, spacing=spacing)
    return ndi.convolve((rng.rand(*shape) > 0.55) * 180.0, kern,
                        mode="wrap") + 3.0 + rng.rand(*shape)


class _Problem(object):
    """The operators and measures of one deconvolution in both packages."""

    def __init__(self, b, cov=COV, spacing=SPACING):
        JC, JG = _jax("ops.conv"), _jax("ops.grad")
        JL, JP = _jax("ops.losses"), _jax("ops.priors")
        jnp = pytest.importorskip("jax.numpy")
        self.b, self.cov, self.spacing = b, cov, spacing
        self.A, _ = TC.make_blur_operators(cov, spacing=spacing)
        self.D, self.Dt = TG.make_gradient_operators(spacing)
        self.JA, _ = JC.make_blur_operators(cov, spacing=spacing,
                                            method="separable")
        self.JD, self.JDt = JG.make_gradient_operators(spacing)
        self.jnp, self.JL, self.JP = jnp, JL, JP

    def ops(self, pkg, reg):
        """(A, B, B_adj) of ``pkg`` ("port" or "jax") for ``reg``."""
        ident = lambda x: x  # noqa: E731
        if pkg == "port":
            return self.A, *((ident, ident) if reg == "TK0" else
                             (self.D, self.Dt))
        return self.JA, *((ident, ident) if reg == "TK0" else
                          (self.JD, self.JDt))

    def measures(self, pkg, reg, loss="linear", scale=1.0):
        """The study interface's Reg/Data measures."""
        if pkg == "port":
            bt = torch.as_tensor(self.b)
            A, P, Lo, D = self.A, TP, TL, self.D
            data_fn = lambda x: Lo.cost_from_residual(  # noqa: E731
                A(x) - bt.to(x.dtype), loss, scale)
        else:
            bj = self.jnp.asarray(self.b)
            A, P, Lo, D = self.JA, self.JP, self.JL, self.JD
            data_fn = lambda x: Lo.cost_from_residual(  # noqa: E731
                A(x) - bj, loss, scale)
        reg_fn = {"TK0": lambda x: P.zeroth_order_tikhonov(x),
                  "TK1": lambda x: P.first_order_tikhonov(x, D),
                  "TV": lambda x: P.total_variation(x, D)}[reg]
        if pkg == "jax":
            return {"Reg": reg_fn, "Data": data_fn}
        # the observer evaluates numpy iterates, a sweep tensors
        return {k: (lambda x, f=f: f(torch.as_tensor(x)))
                for k, f in (("Reg", reg_fn), ("Data", data_fn))}


def _tikhonov(pkg, p, reg, loss, hint, **kw):
    W = TW if pkg == "port" else _jax("solvers.wrappers")
    A, B, Bt = p.ops(pkg, reg)
    opts = dict(alpha=0.05, data_loss=loss, data_loss_scale=0.7,
                iter_max=6, x_scale=float(p.b.max()), irls_cg_iters=5)
    if hint:
        opts.update(minimizer="auto", blur_cov=p.cov, spacing=p.spacing,
                    reg_kind=reg)
    else:
        opts.update(minimizer="cg" if loss == "linear" else "irls")
    opts.update(kw)
    if pkg == "port":
        opts["device"] = "cpu"
    return W.TikhonovLinearSolver(A, A, p.b, B, Bt, np.array(p.b), **opts)


def _admm(pkg, p, loss, hint, **kw):
    W = TW if pkg == "port" else _jax("solvers.wrappers")
    A, B, Bt = p.ops(pkg, "TK1")
    opts = dict(alpha=0.05, data_loss=loss, data_loss_scale=0.7, rho=0.5,
                iterations=3, iter_max=4, x_scale=float(p.b.max()),
                irls_cg_iters=4)
    if hint:
        opts.update(minimizer="auto", blur_cov=p.cov, spacing=p.spacing)
    else:
        opts.update(minimizer="cg" if loss == "linear" else "irls")
    opts.update(kw)
    if pkg == "port":
        opts["device"] = "cpu"
    return W.ADMMLinearSolver(A, A, p.b, B, Bt, np.array(p.b), **opts)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


# ------------------------------------------------------- solver classes --

@pytest.mark.parametrize("loss", ["linear", "huber"])
@pytest.mark.parametrize("reg", ["TK0", "TK1"])
@pytest.mark.parametrize("scope", ["kernel", "generic"])
def test_tikhonov_run_sweep_matches_jax(f64, scope, reg, loss):
    """run_sweep over α × data_loss_scale with the two-row (x0, solution)
    records, x_scale ≠ 1: inside the kernels' scope (blur and TK hints)
    the fused solve's unit sequence, outside it the generic core, both
    against the JAX package's sweep to 1e-9."""
    p = _Problem(_observed())
    grid = {"alpha": np.array([0.01, 0.2, 1.0]),
            "data_loss_scale": np.array([0.3, 1.0, 2.0])}
    xj, rj = _tikhonov("jax", p, reg, loss, True).run_sweep(
        grid, measures=p.measures("jax", reg, loss, 0.7))
    F.reset_counts()
    xp, rp = _tikhonov("port", p, reg, loss, scope == "kernel").run_sweep(
        grid, measures=p.measures("port", reg, loss, 0.7))
    _close(xp, xj)
    for m in ("Reg", "Data"):
        assert rp[m].shape == (3, 2)
        _close(rp[m], rj[m])
    fused = F.plain_counts(["tik_clip"])["tik_clip_plain"]
    assert (fused > 0) == (scope == "kernel")


def test_tikhonov_run_sweep_3d_matches_jax(f64):
    """The same on a 3-D volume with anisotropic spacing (TK1, linear)."""
    cov3, sp3 = np.diag([1.0, 0.8, 1.2]) ** 2, np.array([1.25, 0.8, 2.0])
    p = _Problem(_observed((6, 8, 10), 2, cov3, sp3), cov3, sp3)
    grid = {"alpha": np.array([0.02, 0.5])}
    xj, rj = _tikhonov("jax", p, "TK1", "linear", True).run_sweep(
        grid, measures=p.measures("jax", "TK1"))
    xp, rp = _tikhonov("port", p, "TK1", "linear", True).run_sweep(
        grid, measures=p.measures("port", "TK1"))
    _close(xp, xj)
    _close(rp["Reg"], rj["Reg"])


@pytest.mark.parametrize("loss", ["linear", "huber"])
@pytest.mark.parametrize("scope", ["kernel", "generic"])
def test_admm_run_sweep_matches_jax(f64, scope, loss):
    """run_sweep over α × ρ (× data_loss_scale for huber) with the
    per-iteration Reg/Data records, x_scale ≠ 1: inside the kernels' scope
    the records come from the solve (Reg ×s, Data ×s² at the static scale
    C/s, wrappers.py:535-539, :592-594), outside it from the measures;
    both against the JAX package to 1e-9."""
    p = _Problem(_observed(seed=1))
    grid = {"alpha": np.array([0.01, 0.01, 0.2, 0.2]),
            "rho": np.array([0.5, 1.1, 0.5, 1.1])}
    if loss != "linear":
        grid["data_loss_scale"] = np.array([0.3, 0.7, 1.0, 2.0])
    xj, rj = _admm("jax", p, loss, True).run_sweep(
        grid, measures=p.measures("jax", "TV", loss, 0.7))
    F.reset_counts()
    xp, rp = _admm("port", p, loss, scope == "kernel").run_sweep(
        grid, measures=p.measures("port", "TV", loss, 0.7))
    _close(xp, xj)
    for m in ("Reg", "Data"):
        assert rp[m].shape == (4, 4)
        _close(rp[m], rj[m])
    records = F.plain_counts(["admm_record"])["admm_record_plain"]
    assert (records > 0) == (scope == "kernel")


def test_tikhonov_run_matches_jax(f64):
    """run(): the observer gets x0 and the solution (the reference's two
    add_x calls), and the costs agree; set_x0 and x_scale round-trip."""
    p = _Problem(_observed(seed=3))
    out = {}
    for pkg in ("jax", "port"):
        s = _tikhonov(pkg, p, "TK1", "huber", True, alpha=0.1)
        obs = Observer() if pkg == "port" else _jax("observer").Observer()
        obs.set_measures(p.measures(pkg, "TK1", "huber", 0.7))
        s.set_observer(obs)
        s.run()
        out[pkg] = (s.get_x(), obs.compute_measures(), s.get_total_cost(),
                    s.get_cost_data_term(), s.get_cost_regularization_term(),
                    s.get_ell2_cost_data_term())
    _close(out["port"][0], out["jax"][0])
    for m in ("Reg", "Data"):
        assert len(out["port"][1][m]) == 2
        _close(out["port"][1][m], out["jax"][1][m])
    _close(out["port"][2:], out["jax"][2:])


def test_admm_run_matches_jax(f64):
    """run(): per-iteration measures from the solve and, with
    record_trajectory, every iterate in the observer; costs agree."""
    p = _Problem(_observed(seed=4))
    out = {}
    for pkg in ("jax", "port"):
        s = _admm(pkg, p, "linear", True)
        obs = Observer() if pkg == "port" else _jax("observer").Observer()
        obs.set_measures(p.measures(pkg, "TV"))
        s.set_observer(obs)
        s.set_record_trajectory(True)
        s.run()
        out[pkg] = (s.get_x(), obs.get_measures_results(), obs.get_x_list(),
                    s.get_total_cost())
    _close(out["port"][0], out["jax"][0])
    for m in ("Reg", "Data"):
        _close(out["port"][1][m], out["jax"][1][m])
    assert len(out["port"][2]) == 4
    _close(np.stack(out["port"][2]), np.stack(out["jax"][2]))
    _close(out["port"][3], out["jax"][3])


def test_setters_getters_and_x_scale(f64):
    """The reflective set_/get_ surface the study engine drives, the
    reference's x_scale quirk, and x_scale invariance of the solution."""
    p = _Problem(_observed(seed=5))
    s = _admm("port", p, "linear", True)
    for key, value in (("alpha", 0.3), ("rho", 0.9), ("iterations", 2),
                       ("iter_max", 3), ("data_loss", "cauchy"),
                       ("data_loss_scale", 0.4), ("irls_cg_iters", 2),
                       ("minimizer", "irls"), ("verbose", 0)):
        getattr(s, "set_" + key)(value)
        assert getattr(s, "get_" + key)() == value
    with pytest.raises(ValueError):
        s.set_data_loss("l1")
    assert s.get_dimension() is None and s.get_device().type == "cpu"
    # set_x_scale does not rescale the stored x0 (nsol/solver.py:52-53)
    x0 = s.get_x0()
    s.set_x_scale(2 * s.get_x_scale())
    _close(s.get_x0(), 2 * x0)
    # the solution scales with x_scale when b and x0 do
    xs = [_tikhonov("port", _Problem(k * p.b), "TK1", "linear", True,
                    x_scale=k * float(p.b.max())) for k in (1.0, 3.0)]
    for s in xs:
        s.run()
    _close(xs[1].get_x(), 3.0 * xs[0].get_x(), 1e-12)


def test_unported_options_and_device_raise(f64):
    """``run_sweep(mesh=)`` is ported: a mesh that is no ``Mesh`` raises
    ``TypeError``, a ``"space"`` one ``ValueError``; without a card,
    ``device="cuda"`` raises."""
    from nsol_tpu_torch.parallel.mesh import Mesh

    p = _Problem(_observed())
    s = _tikhonov("port", p, "TK1", "linear", True)
    with pytest.raises(TypeError, match="Mesh"):
        s.run_sweep({"alpha": np.array([0.1])}, mesh=object())
    with pytest.raises(ValueError, match="'batch' mesh"):
        s.run_sweep({"alpha": np.array([0.1])}, mesh=Mesh.single("cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TW.TikhonovLinearSolver(p.A, p.A, p.b, p.D, p.Dt, p.b)


def test_sweep_runs_in_memory_budgeted_chunks(f64, monkeypatch):
    """A grid whose results exceed SWEEP_BUDGET_BYTES runs chunk by chunk
    with the same results (reference fault R4 designed around)."""
    p = _Problem(_observed(seed=6))
    grid = {"alpha": np.linspace(0.01, 0.5, 5)}
    whole = _tikhonov("port", p, "TK0", "linear", True).run_sweep(
        grid, measures=p.measures("port", "TK0"))
    one_image = p.b.size * 8
    monkeypatch.setattr(TW, "SWEEP_BUDGET_BYTES", 2 * one_image)
    assert [len(c) for c in TW._chunks(5, p.b.shape, 8)] == [2, 2, 1]
    chunked = _tikhonov("port", p, "TK0", "linear", True).run_sweep(
        grid, measures=p.measures("port", "TK0"))
    assert np.array_equal(whole[0], chunked[0])
    for m in ("Reg", "Data"):
        assert np.array_equal(whole[1][m], chunked[1][m])


# -------------------------------------------------------------- the engine --

def _study(pkg, p, kind, params, out, use_vmap=True, append=False,
           name="study", **kw):
    """A Tikhonov (TK1) or ADMM study of ``pkg`` on the problem ``p``."""
    if pkg == "port":
        obs, TS, AS = Observer(), TTStudy, TAStudy
    else:
        E = _jax("study.engine")
        obs = _jax("observer").Observer()
        TS, AS = (E.TikhonovLinearSolverParameterStudy,
                  E.ADMMLinearSolverParameterStudy)
    if kind == "tik":
        solver = _tikhonov(pkg, p, "TK1", "linear", True, **kw)
        obs.set_measures(p.measures(pkg, "TK1"))
        cls = TS
    else:
        solver = _admm(pkg, p, "linear", True, **kw)
        obs.set_measures(p.measures(pkg, "TV"))
        cls = AS
    study = cls(solver, obs, dir_output=out, name=name, parameters=params,
                reconstruction_info={"shape": np.array(p.b.shape)},
                append=append, use_vmap=use_vmap)
    study.run()
    return study


def _compare_studies(out_a, out_b, name="study", tol=TOL, reader=TReader):
    ra, rb = reader(directory=out_a, name=name), TReader(directory=out_b,
                                                         name=name)
    ra.read_study()
    rb.read_study()
    assert sorted(ra.get_measures()) == sorted(rb.get_measures())
    assert ra.get_parameters_to_line() == rb.get_parameters_to_line()
    for m in ra.get_measures():
        _close(ra.get_results(m), rb.get_results(m), tol)
    xa, xb = ra.get_reconstructions(), rb.get_reconstructions()
    assert sorted(xa.files) == sorted(xb.files)
    for k in xa.files:
        if xa[k].dtype == np.float16:
            atol = 2 * float(np.spacing(np.float16(np.abs(xa[k]).max())))
            np.testing.assert_allclose(xb[k].astype(np.float32),
                                       xa[k].astype(np.float32), atol=atol)


@pytest.mark.parametrize("route", ["serial", "batched", "hybrid"])
def test_study_routes_match_jax(f64, tmp_path, route):
    """The serial (reflective setters), batched (one run_sweep) and hybrid
    (one run_sweep per data_loss) routes write the JAX package's files,
    equal to 1e-9."""
    p = _Problem(_observed(seed=7))
    params = {"alpha": [0.01, 0.1, 0.4]}
    if route == "hybrid":
        params["data_loss"] = ["linear", "huber"]
    use_vmap = route != "serial"
    for pkg in ("jax", "port"):
        _study(pkg, p, "tik", dict(params), str(tmp_path / pkg),
               use_vmap=use_vmap)
    _compare_studies(str(tmp_path / "jax"), str(tmp_path / "port"))
    with open(str(tmp_path / "port" / "study_parameters.txt")) as f:
        head = f.readline()
    assert head.startswith("## study, ") and "x_scale=" in head


def test_admm_study_alpha_rho_grid_matches_jax(f64, tmp_path):
    p = _Problem(_observed(seed=8))
    params = {"alpha": [0.01, 0.05], "rho": [0.5, 1.0]}
    for pkg in ("jax", "port"):
        _study(pkg, p, "admm", dict(params), str(tmp_path / pkg))
    _compare_studies(str(tmp_path / "jax"), str(tmp_path / "port"))
    rows = TReader(directory=str(tmp_path / "port"), name="study")
    rows.read_study()
    assert rows.get_results("Data").shape == (4, 4)  # x0 + 3 iterations


@pytest.mark.parametrize("use_vmap", [False, True])
def test_append_resume_runs_only_missing(f64, tmp_path, use_vmap):
    """tests/test_study.py:97, :397, :453: an appended study with the full
    grid runs only the missing combinations; a complete study runs
    nothing and leaves its files as they were."""
    p = _Problem(_observed(seed=9))
    out = str(tmp_path / "app")
    # the generic route, so that every solve passes through _solve
    kw = {"blur_cov": None, "minimizer": "cg"}
    _study("port", p, "tik", {"alpha": [0.1, 0.3]}, out, use_vmap=use_vmap,
           **kw)
    calls = []
    orig = TW.TikhonovLinearSolver._solve

    def counting(self, alpha, *args):
        calls.append(alpha)
        return orig(self, alpha, *args)

    TW.TikhonovLinearSolver._solve = counting
    try:
        _study("port", p, "tik", {"alpha": [0.1, 0.3, 0.5, 0.9]}, out,
               use_vmap=use_vmap, append=True, **kw)
        assert sorted(calls) == [0.5, 0.9]
        reader = TReader(directory=out, name="study")
        reader.read_study()
        assert reader.get_results("Data").shape[0] == 4
        np.testing.assert_allclose(reader.get_parameters()["alpha"],
                                   [0.1, 0.3, 0.5, 0.9])
        assert set(reader.get_reconstructions().files) >= {"0", "1", "2",
                                                           "3"}
        before = open(os.path.join(out, "study_parameters.txt")).read()
        del calls[:]
        _study("port", p, "tik", {"alpha": [0.1, 0.3, 0.5, 0.9]}, out,
               use_vmap=use_vmap, append=True, **kw)
        assert calls == []
        assert open(os.path.join(out, "study_parameters.txt")).read() \
            == before
    finally:
        TW.TikhonovLinearSolver._solve = orig


def test_append_mismatched_header_raises(f64, tmp_path):
    """tests/test_study.py:120: a changed static setting refuses the
    append."""
    p = _Problem(_observed(seed=10))
    out = str(tmp_path / "mm")
    _study("port", p, "admm", {"alpha": [0.1, 0.3]}, out)
    with pytest.raises(RuntimeError, match="cannot be appended"):
        _study("port", p, "admm", {"alpha": [0.5]}, out, append=True,
               iterations=5)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_reader_reads_the_other_packages_study(f64, tmp_path, writer):
    """Queue 1 item 9: a study written by one package is read by the other
    package's reader — parameters, measures, labels, reconstructions."""
    JR = _jax("study.reader").ReaderParameterStudy
    p = _Problem(_observed(seed=11))
    out = str(tmp_path / writer)
    _study(writer, p, "admm", {"alpha": [0.01, 0.05], "rho": [0.5, 1.0]},
           out, name="cross")
    other = JR if writer == "port" else TReader
    same = TReader if writer == "port" else JR
    ra, rb = same(directory=out, name="cross"), other(directory=out,
                                                      name="cross")
    ra.read_study()
    rb.read_study()
    assert ra.get_parameters() == rb.get_parameters()
    assert ra.get_parameter_keys() == rb.get_parameter_keys() == ["alpha",
                                                                  "rho"]
    assert ra.get_line_to_parameter_labels() == \
        rb.get_line_to_parameter_labels()
    assert list(rb.get_lines_to_parameters(
        {"alpha": [0.01, 0.05], "rho": 1.0})) == [1, 3]
    for m in ("Reg", "Data"):
        assert np.array_equal(ra.get_results(m), rb.get_results(m))
    xa, xb = ra.get_reconstructions(), rb.get_reconstructions()
    assert all(np.array_equal(xa[k], xb[k]) for k in xa.files)
    assert xb["3"].dtype == np.float16 and xb["3"].shape == p.b.shape
    assert len(rb.get_computational_times()) == 4


# ----------------------------------------------------------- the interface --

def _interface(p, rtype, tmp_path, **kw):
    opts = dict(A=p.A, A_adj=p.A, D=p.D, D_adj=p.Dt, b=p.b,
                x0=np.array(p.b), alpha=0.05, x_scale=float(p.b.max()),
                iter_max=4, iterations=3, minimizer="auto", measures=[],
                dimension=2, reconstruction_type=rtype,
                dir_output=str(tmp_path), parameters={"alpha": [0.1, 0.2]},
                name=rtype, reconstruction_info={}, blur_cov=p.cov,
                spacing=p.spacing, device="cpu")
    opts.update(kw)
    return DeconvolutionParameterStudyInterface(**opts)


def _interfaces_match(tmp_path, rtype, **kw):
    """The port's and the JAX package's study interfaces on one problem:
    the same solver class, Reg/Data (and similarity) measures to 1e-12,
    and the same study files to 1e-9."""
    JI = _jax("interface")
    p = _Problem(_observed(seed=12))
    port = _interface(p, rtype, tmp_path / "port", **kw)
    port.set_up_parameter_study()
    opts = dict(A=p.JA, A_adj=p.JA, D=p.JD, D_adj=p.JDt, b=p.b,
                x0=np.array(p.b), alpha=0.05, x_scale=float(p.b.max()),
                iter_max=4, iterations=3, minimizer="auto", measures=[],
                dimension=2, reconstruction_type=rtype,
                dir_output=str(tmp_path / "jax"),
                parameters={"alpha": [0.1, 0.2]}, name=rtype,
                reconstruction_info={}, blur_cov=p.cov, spacing=p.spacing)
    opts.update(kw)
    jax_i = JI.DeconvolutionParameterStudyInterface(**opts)
    jax_i.set_up_parameter_study()
    assert type(port.get_solver()).__name__ == \
        type(jax_i.get_solver()).__name__
    assert type(port.get_parameter_study()).__name__ == \
        type(jax_i.get_parameter_study()).__name__
    x = np.random.RandomState(0).rand(12, 14) * 100
    assert sorted(port.get_measures()) == sorted(jax_i.get_measures())
    for m in port.get_measures():
        _close(float(port.get_measures()[m](x)),
               float(jax_i.get_measures()[m](x)), 1e-12)
    port.get_parameter_study().run()
    jax_i.get_parameter_study().run()
    _compare_studies(str(tmp_path / "jax"), str(tmp_path / "port"),
                     name=rtype)


@pytest.mark.parametrize("rtype,kw", [
    ("TVL2", {"tv_solver": "PD"}), ("HuberL2", {}),
    ("TK1L2", {"x_ref": np.ones((12, 14))})])
def test_interface_unported_routes_raise(f64, tmp_path, rtype, kw):
    """The routes this case once held as unported run (TVL2 by PD and
    HuberL2, the primal-dual study; ``x_ref``, the similarity measures),
    as the JAX package's interface runs them."""
    if "x_ref" in kw:
        kw = dict(kw, x_ref=np.random.RandomState(3).rand(12, 14) * 100,
                  measures=["RMSE", "PSNR", "NCC"])
    _interfaces_match(tmp_path, rtype, **kw)


@pytest.mark.parametrize("rtype", ["TK0L2", "TK1L2", "TVL2"])
def test_interface_study_matches_jax_interface(f64, tmp_path, rtype):
    """The interface's solver, Reg/Data measures and study for each ported
    type run the same study as the JAX package's interface."""
    kw = {"tv_solver": "ADMM"} if rtype == "TVL2" else {}
    _interfaces_match(tmp_path, rtype, **kw)


# -------------------------------------------------------------- the CLIs --

def _jax_cli(module, argv, monkeypatch):
    """Run a CLI of the JAX package in this process (float64 here)."""
    cli = _jax("cli." + module)
    monkeypatch.setenv("NSOL_TPU_COMPILE_CACHE", "")
    monkeypatch.setattr(sys, "argv", [module] + argv)
    cli.main()


LENA = os.path.join(DATA_DIR, "2D_Lena_256_blur_noise.png")
PHANTOM = os.path.join(DATA_DIR, "3D_SheppLoganPhantom_64.nii.gz")


@pytest.mark.parametrize("case", ["TK1L2", "TVL2-ADMM"])
def test_study_cli_matches_jax_cli(tmp_path, monkeypatch, case):
    """nsol_torch_run_deconvolution_study --device cpu on the Lena PNG
    against nsol_run_deconvolution_study (tests/test_cli.py:341-401: the
    measure files at rtol 2e-3, atol 2e-3·max; the float16
    reconstructions within two ulps)."""
    rtype = case.split("-")[0]
    argv = ["--observation", LENA, "--reconstruction-type", rtype,
            "--alpha-range", "0.01", "0.05", "2", "--iter-max", "4"]
    if case == "TVL2-ADMM":
        argv += ["--solver", "ADMM", "--iterations", "4"]
    _jax_cli("run_deconvolution_study", argv + ["--dir-output",
                                                str(tmp_path / "jax")],
             monkeypatch)
    assert tstudy_cli.main(argv + ["--dir-output", str(tmp_path / "port"),
                                   "--device", "cpu"]) == 0
    for m in ("Reg", "Data"):
        a = np.loadtxt(str(tmp_path / "jax" / ("%s_measure_%s.txt"
                                               % (rtype, m))))
        b = np.loadtxt(str(tmp_path / "port" / ("%s_measure_%s.txt"
                                                % (rtype, m))))
        np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-3 * abs(a).max(),
                                   err_msg=m)
    _compare_studies(str(tmp_path / "jax"), str(tmp_path / "port"),
                     name=rtype, tol=2e-3)


def test_study_cli_nifti_geometry_and_cross_read(tmp_path):
    """tests/test_cli.py:191-228: a 3-D NIfTI study keeps shape, origin,
    spacing and direction in its npz, and the JAX package's reader reads
    it."""
    from nsol_tpu_torch.io import read_nifti

    JR = _jax("study.reader").ReaderParameterStudy
    out = str(tmp_path / "study3d")
    assert tstudy_cli.main(["--observation", PHANTOM,
                            "--reconstruction-type", "TK1L2",
                            "--iter-max", "3", "--alpha-range", "0.01",
                            "0.05", "2", "--study-name", "meta3d",
                            "--dir-output", out, "--device", "cpu"]) == 0
    npz = np.load(os.path.join(out, "meta3d_reconstructions.npz"))
    assert set(npz.files) >= {"shape", "origin", "spacing", "direction"}
    assert tuple(npz["shape"]) == (64, 64, 64)
    img = read_nifti(PHANTOM)
    np.testing.assert_allclose(npz["spacing"], img.get_spacing())
    np.testing.assert_allclose(npz["origin"], img.get_origin())
    np.testing.assert_allclose(npz["direction"], img.get_direction())
    reader = JR(directory=out, name="meta3d")
    reader.read_study()
    assert reader.get_results("Reg").shape == (2, 2)
    assert reader.get_reconstructions()["1"].shape == (64, 64, 64)


def test_study_cli_unported_default_solver_raises(tmp_path):
    """The CLI keeps the reference's --solver PD default, whose TVL2 route
    (primal-dual with the inner Tikhonov prox) is ported: it writes the
    primal-dual study's files (tests/test_torch_pd_surface.py holds them to
    the JAX CLI's)."""
    assert tstudy_cli.main(["--observation", LENA, "--dir-output",
                            str(tmp_path), "--iterations", "2",
                            "--alpha-range", "0.01", "0.05", "2",
                            "--device", "cpu"]) == 0
    reader = TReader(directory=str(tmp_path), name="TVL2")
    reader.read_study()
    assert reader.get_results("Data").shape == (2, 3)
    assert "L2=8" in reader.get_file_header()


@pytest.mark.parametrize("rtype", ["TK0L2", "TK1L2"])
def test_run_deconvolution_tikhonov_matches_jax_cli(tmp_path, monkeypatch,
                                                    rtype):
    """run_deconvolution's TK0L2/TK1L2 route through the interface's solver
    (--device cpu) writes the JAX CLI's image (uint8 PNG, within 1)."""
    from nsol_tpu_torch.io import read_png

    argv = ["--observation", LENA, "--reconstruction-type", rtype,
            "--iter-max", "6", "--alpha", "0.05"]
    _jax_cli("run_deconvolution", argv + ["--result",
                                          str(tmp_path / "jax.png")],
             monkeypatch)
    assert tcli.main(argv + ["--result", str(tmp_path / "port.png"),
                             "--device", "cpu"]) == 0
    a = read_png(str(tmp_path / "jax.png")).astype(np.int16)
    b = read_png(str(tmp_path / "port.png")).astype(np.int16)
    assert a.shape == b.shape == (256, 256)
    assert np.max(np.abs(a - b)) <= 1


# ---------------------------------------------- the chip smoke's anchors --

def _anchor_modules():
    import importlib.util

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mods = []
    for name in ("chip_smoke", "tests/torch_anchors"):
        spec = importlib.util.spec_from_file_location(
            os.path.basename(name), os.path.join(repo, name + ".py"))
        mods.append(importlib.util.module_from_spec(spec))
        spec.loader.exec_module(mods[-1])
    return mods


def test_chip_smoke_tikhonov_anchors_are_the_jax_values():
    """chip_smoke.py phase 17's sweeps are tests/torch_anchors.py's, and
    its anchors the JAX package's float64 Tikhonov objectives."""
    _jax("solvers.tikhonov")
    cs, ta = _anchor_modules()
    assert np.array_equal(cs.TK_ALPHAS, ta.TK_ALPHAS)
    assert (cs.TK_ITER_MAX, cs.HUBER_SCALE, cs.HUBER_SWEEPS, cs.HUBER_CG) \
        == (ta.TK_ITER_MAX, ta.HUBER_SCALE, ta.HUBER_SWEEPS, ta.HUBER_CG)
    assert set(ta.HUBER_AT) <= set(range(0, 64, cs.HUBER_STEP))
    want = ta.tikhonov_anchors()
    assert set(want) == set(cs.TK_ANCHORS)
    for key, value in want.items():
        assert abs(cs.TK_ANCHORS[key] - value) <= 1e-9 * value, key


@pytest.mark.slow
def test_chip_smoke_tv_anchors_are_the_jax_values():
    """Phase 18's anchors: the JAX package's float64 ADMM records."""
    _jax("solvers.admm")
    cs, ta = _anchor_modules()
    assert np.array_equal(cs.TV_ALPHAS, ta.TV_ALPHAS)
    assert cs.TV_RHOS == ta.TV_RHOS
    for (_, name, i, rho), value in ta.tv_anchors().items():
        assert abs(cs.TV_ANCHORS[(i, rho)][name] - value) <= 1e-9 * value
