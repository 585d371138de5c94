"""The port's primal-dual surface against the JAX package.

The same numpy inputs, made from a seed, go through both packages:

* ``cgls`` and the Tikhonov engine's ``"lsmr"`` branch, and
  ``prox_linear_least_squares`` (cg, lsmr, irls), in float64 at 1e-9;
* ``PrimalDualSolver``: the PD cases of ``tests/test_solvers.py``
  (:362-604) and ``tests/test_solver_coverage.py`` (:20-56, 113-131) —
  iterates, x_scale invariance, the schedules, the Huber conjugate, the
  observer's records, 1-D and 3-D, the HuberL2 interface and the masked
  ``x_ref`` measures — in float64 at 1e-9 (1e-12 for the measures);
* ``PrimalDualSolverParameterStudy``: the PD cases of
  ``tests/test_study.py`` (files, the reader both ways, batched = serial,
  append/resume, the mismatched header, the ``alg_type`` string sweep,
  hybrid) against the JAX package's study files in float64 at 1e-9;
* ``run_sweep``'s fused route against the JAX package's ``_fused_sweep``
  with ``NSOL_TPU_FUSED_INTERPRET=1`` (float32, records too, at the
  tolerances of ``tests/test_pallas.py``);
* the bf16 PD state (K10b.4): the plain version against
  ``make_fused_pd_denoise_solver(compact=True, interpret=True)`` — one
  step from the same state within one bf16 ulp, the solves within the
  bands of ``tests/test_pallas.py:176-215`` (they agree bit for bit
  here), 2-D and 3-D, TVL2 and HuberL1 — and its interop form;
* ``policy.pd_options``;
* the CLIs: ``run_deconvolution`` at its default ``--solver PD`` (TVL2,
  HuberL2), ``run_denoising_study``, ``run_denoising --solver ADMM`` and
  ``--reference``, against the JAX package's CLIs in float64;
* every ``NotImplementedError`` of the port's routes still to port names a
  ROADMAP.md item by a title that ROADMAP.md has.

The ``cuda``-marked cases hold the bf16 units and the compact solve to
their plain versions on the card and skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_pd_surface.py
"""

import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nsol_tpu_torch import data, interop, policy  # noqa: E402
from nsol_tpu_torch.io import read_png, write_png  # noqa: E402
from nsol_tpu_torch.observer import Observer  # noqa: E402
from nsol_tpu_torch.ops import conv as TC  # noqa: E402
from nsol_tpu_torch.ops import grad as TG  # noqa: E402
from nsol_tpu_torch.ops import prox as TP  # noqa: E402
from nsol_tpu_torch.ops.cuda import fused as F  # noqa: E402
from nsol_tpu_torch.solvers import cg as TCG  # noqa: E402
from nsol_tpu_torch.solvers import tikhonov as TT  # noqa: E402
from nsol_tpu_torch.solvers import wrappers as TW  # noqa: E402
from nsol_tpu_torch.study import (  # noqa: E402
    PrimalDualSolverParameterStudy, ReaderParameterStudy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9
BF16 = torch.bfloat16


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


def _np(t):
    return interop.to_numpy(t) if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


# ------------------------------------------------------- cgls and lsmr --

def test_cgls_matches_reference_on_an_augmented_pair(f64):
    """The augmented pair ``(M x, √α x)``: tuples through the tree dot,
    and the freeze after convergence (a square system solved exactly in
    its dimension), at 1e-9."""
    JCG = _jax("solvers.cg")
    jnp = pytest.importorskip("jax.numpy")
    rng = np.random.RandomState(1)
    M = rng.rand(14, 9)
    b, x0, sa = rng.rand(14), rng.rand(9), 0.6
    Mt = torch.as_tensor(M)
    Mj = jnp.asarray(M)
    for iters in (5, 40):  # 40 > 9: past convergence, frozen
        got = TCG.cgls(lambda x: (Mt @ x, sa * x),
                       lambda y: Mt.T @ y[0] + sa * y[1],
                       (torch.as_tensor(b), torch.zeros(9)),
                       torch.as_tensor(x0), iters)
        want = JCG.cgls(lambda x: (Mj @ x, sa * x),
                        lambda y: Mj.T @ y[0] + sa * y[1],
                        (jnp.asarray(b), jnp.zeros(9)), jnp.asarray(x0),
                        iters)
        _close(got, want)
    # a plain tensor system, and the dots summed by a reduce hook
    got = TCG.cgls(lambda x: Mt @ x, lambda y: Mt.T @ y,
                   torch.as_tensor(b), torch.as_tensor(x0), 6,
                   reduce=lambda s: s)
    _close(got, JCG.cgls(lambda x: Mj @ x, lambda y: Mj.T @ y,
                         jnp.asarray(b), jnp.asarray(x0), 6))


@pytest.mark.parametrize("alpha,reg", [(0.3, "grad"), (0.0, "grad"),
                                       (0.7, "ident")])
def test_tikhonov_lsmr_matches_reference(f64, alpha, reg):
    """The "lsmr" branch: CGLS on ``[A; √α·B] x = [b; √α·b_reg]``, then the
    clip (``nsol_tpu/solvers/tikhonov.py:154-167``)."""
    JC, JG, JT = (_jax(m) for m in ("ops.conv", "ops.grad",
                                    "solvers.tikhonov"))
    jnp = pytest.importorskip("jax.numpy")
    cov, spacing = np.diag([0.8, 1.3]) ** 2, np.array([1.25, 0.8])
    rng = np.random.RandomState(2)
    b = rng.rand(13, 11) - 0.2
    A, _ = TC.make_blur_operators(cov, spacing=spacing)
    JA, _ = JC.make_blur_operators(cov, spacing=spacing, method="separable")
    if reg == "grad":
        B, Bt = TG.make_gradient_operators(spacing)
        JB, JBt = JG.make_gradient_operators(spacing)
        b_reg = rng.rand(2, 13, 11)
    else:
        B = Bt = JB = JBt = (lambda x: x)
        b_reg = rng.rand(13, 11)
    got = TT.tikhonov_solve(A, A, B, Bt, torch.as_tensor(b),
                            torch.as_tensor(b_reg), torch.as_tensor(b),
                            alpha, minimizer="lsmr", iter_max=7)
    want = JT.tikhonov_solve(JA, JA, JB, JBt, jnp.asarray(b),
                             jnp.asarray(b_reg), jnp.asarray(b), alpha,
                             minimizer="lsmr", iter_max=7)
    _close(got, want)


@pytest.mark.parametrize("minimizer,loss", [("cg", "linear"),
                                            ("lsmr", "linear"),
                                            ("irls", "huber")])
def test_prox_linear_least_squares_matches_reference(f64, minimizer, loss):
    JC, JT = _jax("ops.conv"), _jax("solvers.tikhonov")
    jnp = pytest.importorskip("jax.numpy")
    cov = np.diag([1.0, 0.8]) ** 2
    rng = np.random.RandomState(3)
    b, x = rng.rand(12, 10), rng.rand(12, 10)
    A, _ = TC.make_blur_operators(cov)
    JA, _ = JC.make_blur_operators(cov, method="separable")
    kw = dict(iter_max=5, data_loss=loss, data_loss_scale=0.4,
              minimizer=minimizer)
    got = TT.prox_linear_least_squares(
        torch.as_tensor(x), 0.35, A, A, torch.as_tensor(b),
        torch.as_tensor(x), normal_A=TC.make_normal_blur_operator(cov), **kw)
    want = JT.prox_linear_least_squares(
        jnp.asarray(x), 0.35, JA, JA, jnp.asarray(b), jnp.asarray(x),
        normal_A=JC.make_normal_blur_operator(cov, shape=(12, 10)), **kw)
    _close(got, want)


# ------------------------------------------------------ PrimalDualSolver --

def _pd(pkg, b, alpha=0.5, iterations=10, x_scale=1.0, alg_type="ALG2",
        variant="TVL2", **kw):
    """A PrimalDualSolver of ``pkg`` ("port"/"jax") denoising ``b`` with the
    proxes of ``variant`` on ``b / x_scale``."""
    if pkg == "port":
        P, Gr, W = TP, TG, TW
        bs = torch.as_tensor(b / x_scale)
        kw["device"] = "cpu"
    else:
        P, Gr, W = _jax("ops.prox"), _jax("ops.grad"), _jax(
            "solvers.wrappers")
        bs = pytest.importorskip("jax.numpy").asarray(b / x_scale)
    D, Dt = Gr.make_gradient_operators()
    ell1 = variant.endswith("L1")

    def prox_f(x, tau):
        return (P.prox_ell1_denoising if ell1 else P.prox_ell2_denoising)(
            x, tau, bs)

    conj = P.prox_tv_conj if variant.startswith("TV") else P.prox_huber_conj
    return W.PrimalDualSolver(prox_f=prox_f, prox_g_conj=conj, B=D,
                              B_conj=Dt, L2=8.0, x0=np.array(b), alpha=alpha,
                              iterations=iterations, x_scale=x_scale,
                              alg_type=alg_type, **kw)


def _measures(pkg, b):
    """The study tests' Data/Reg measures of ``pkg`` against ``b``."""
    if pkg == "port":
        bt = torch.as_tensor(b)

        def data_fn(x):
            x = torch.as_tensor(x)
            return 0.5 * torch.sum((x - bt) ** 2)

        def reg_fn(x):
            g = TG.gradient(torch.as_tensor(x))
            return torch.sum(torch.sqrt(torch.sum(g ** 2, 0)))

        return {"Data": data_fn, "Reg": reg_fn}
    jnp = pytest.importorskip("jax.numpy")
    JG = _jax("ops.grad")
    bj = jnp.asarray(b)
    return {"Data": lambda x: 0.5 * jnp.sum((x - bj) ** 2),
            "Reg": lambda x: jnp.sum(jnp.sqrt(jnp.sum(JG.gradient(x) ** 2,
                                                      axis=0)))}


@pytest.mark.parametrize("alg_type,variant,x_scale", [
    ("ALG2", "TVL2", 1.0), ("ALG2_AHMOD", "TVL2", 1.0), ("ALG3", "TVL2", 7.0),
    ("ALG2", "HuberL2", 1.0), ("ALG2", "TVL1", 3.0), ("ALG3", "HuberL1",
                                                     1.0)])
def test_pd_solver_iterates_match_reference(f64, alg_type, variant, x_scale):
    """tests/test_solvers.py:362-406, 573-604: the iterate after 15
    steps, each schedule and conjugate, scaled or not."""
    b = np.random.RandomState(4).rand(16, 18) * 4.0 * x_scale
    sols = [_pd(pkg, b, 0.5, 15, x_scale, alg_type, variant)
            for pkg in ("port", "jax")]
    for s in sols:
        s.run()
    _close(sols[0].get_x(), sols[1].get_x())
    assert sols[0].get_computational_time() is not None


def test_pd_x_scale_invariance(f64):
    """tests/test_solvers.py:383: prescaled data with x_scale 1 equals raw
    data with x_scale = max, to 7 decimals (port only: the reference's
    one solver test)."""
    b = np.random.RandomState(5).rand(18, 16) * 255.0
    s = b.max()
    s1, s2 = _pd("port", b / s, 0.7, 15), _pd("port", b, 0.7, 15, s)
    s1.run()
    s2.run()
    np.testing.assert_array_almost_equal(s1.get_x(), s2.get_x() / s,
                                         decimal=7)


def test_pd_observer_records_match_reference(f64):
    """tests/test_solvers.py:410: the observer's records, row 0 the x0
    state; the setters and getters of the class surface."""
    b = np.random.RandomState(6).rand(12, 12)
    res = {}
    for pkg in ("port", "jax"):
        solver = _pd(pkg, b, 0.5, 5)
        obs = Observer() if pkg == "port" else _jax("observer").Observer()
        obs.set_measures(_measures(pkg, b))
        solver.set_observer(obs)
        solver.run()
        res[pkg] = obs.get_measures_results()
        assert obs.get_computational_time() is not None
    for k in ("Data", "Reg"):
        assert res["port"][k].shape == (6,)
        _close(res["port"][k], res["jax"][k])
    assert res["port"]["Data"][0] == 0.0
    s = _pd("port", b)
    for name, value in (("alpha", 0.3), ("L2", 12.0), ("alg_type", "ALG3"),
                        ("iterations", 4)):
        getattr(s, "set_" + name)(value)
        assert getattr(s, "get_" + name)() == value


@pytest.mark.parametrize("shape,alpha,iterations", [((100,), 1.0, 50),
                                                    ((12, 14, 16), 0.5, 40)])
def test_pd_denoising_1d_and_3d_match_reference(f64, shape, alpha,
                                                iterations):
    """tests/test_solver_coverage.py:20-56 (L2 = 8 even in 3-D): the
    reference's spike signal and box volume."""
    rng = np.random.RandomState(7)
    clean = np.zeros(shape)
    if len(shape) == 1:
        clean[30:60] = 10.0
        b = clean + rng.randn(*shape)
    else:
        clean[3:9, 4:10, 5:11] = 5.0
        b = clean + 1.5 * rng.randn(*shape)
    sols = [_pd(pkg, b, alpha, iterations, b.max())
            for pkg in ("port", "jax")]
    for s in sols:
        s.run()
    _close(sols[0].get_x(), sols[1].get_x())
    x = sols[0].get_x()
    assert np.mean((x - clean) ** 2) < np.mean((b - clean) ** 2)


def test_interface_huberl2_and_masked_x_ref_match_reference(f64):
    """tests/test_solver_coverage.py:113-152: the HuberL2 interface runs
    (its prox the linear CGLS) and the masked similarity measures, against
    the JAX interface."""
    JI, JC, JG = (_jax(m) for m in ("interface", "ops.conv", "ops.grad"))
    from nsol_tpu_torch.interface import DeconvolutionSolverStudyInterface

    rng = np.random.RandomState(8)
    b = rng.rand(20, 20) * 10
    x_ref, mask = rng.rand(20, 20) * 10, np.zeros((20, 20))
    mask[4:12, 4:16] = 1
    cov = np.diag([0.8, 0.8])
    out = {}
    for pkg, I, C, G in (("port", None, TC, TG), ("jax", JI, JC, JG)):
        kw = dict(A=None, A_adj=None, D=None, D_adj=None, b=b,
                  x0=np.array(b), alpha=0.05, x_scale=b.max(), iter_max=5,
                  iterations=10, minimizer="lsmr", measures=["RMSE", "NCC"],
                  reconstruction_type="HuberL2", dimension=2, x_ref=x_ref,
                  x_ref_mask=mask)
        kw["A"], _ = (C.make_blur_operators(cov) if pkg == "port" else
                      C.make_blur_operators(cov, method="separable"))
        kw["A_adj"] = kw["A"]
        kw["D"], kw["D_adj"] = G.make_gradient_operators()
        if pkg == "port":
            iface = DeconvolutionSolverStudyInterface(device="cpu", **kw)
        else:
            iface = I.DeconvolutionSolverStudyInterface(**kw)
        iface.set_up_solver()
        iface.set_up_measures()
        iface.get_solver().run()
        m = iface.get_measures()
        out[pkg] = (iface.get_solver().get_x(),
                    {k: float(f(b)) for k, f in m.items()})
    _close(out["port"][0], out["jax"][0])
    assert sorted(out["port"][1]) == ["Data", "NCC", "RMSE", "Reg"]
    for k, v in out["jax"][1].items():
        _close(out["port"][1][k], v, 1e-12)
    want = np.sqrt(np.mean((b[mask > 0] - x_ref[mask > 0]) ** 2))
    np.testing.assert_almost_equal(out["port"][1]["RMSE"], want, decimal=10)


# ------------------------------------------------------------- the study --

def _study(pkg, out, b, params, use_vmap, name="study", append=False,
           iterations=5, solver=None):
    """A PD study of ``pkg`` over ``params`` on ``b`` into ``out``."""
    solver = solver or _pd(pkg, b, 0.1, iterations)
    obs = Observer() if pkg == "port" else _jax("observer").Observer()
    obs.set_measures(_measures(pkg, b))
    S = PrimalDualSolverParameterStudy if pkg == "port" \
        else _jax("study").PrimalDualSolverParameterStudy
    study = S(solver=solver, observer=obs, dir_output=str(out), name=name,
              parameters=params, reconstruction_info={
                  "shape": np.array(b.shape)}, append=append,
              use_vmap=use_vmap)
    study.run()
    return solver


def _read(out, name="study", pkg="port"):
    R = ReaderParameterStudy if pkg == "port" \
        else _jax("study").ReaderParameterStudy
    reader = R(directory=str(out), name=name)
    reader.read_study()
    return reader


def _same_files(out_a, out_b, name="study", tol=TOL):
    """Two studies' files hold the same rows: parameters, every measure
    to ``tol``, the float16 reconstructions to two ulps."""
    ra, rb = _read(out_a, name), _read(out_b, name)
    assert ra.get_parameters_to_line() == rb.get_parameters_to_line()
    assert sorted(ra.get_measures()) == sorted(rb.get_measures())
    for m in ra.get_measures():
        _close(ra.get_results(m), rb.get_results(m), tol)
    xa, xb = ra.get_reconstructions(), rb.get_reconstructions()
    assert sorted(xa.files) == sorted(xb.files)
    for k in xa.files:
        if xa[k].dtype == np.float16:
            atol = 2 * float(np.spacing(np.float16(np.abs(xa[k]).max())))
            np.testing.assert_allclose(xb[k].astype(np.float32),
                                       xa[k].astype(np.float32), atol=atol)


B_STUDY = np.random.RandomState(7).rand(12, 14) * 10


@pytest.mark.parametrize("route", ["serial", "batched", "alg_type",
                                   "hybrid"])
def test_pd_study_matches_reference_files(f64, tmp_path, route):
    """tests/test_study.py:55-96, 256-338: the files of the serial and
    batched sweeps, the ``alg_type`` string sweep (serial) and the hybrid
    one (batched α within each alg_type) equal the JAX package's, and each
    package's reader reads the other's."""
    params = {"alpha": [0.1, 0.3, 0.6]}
    if route in ("alg_type", "hybrid"):
        params["alg_type"] = ["ALG2", "ALG3"]
    use_vmap = route in ("batched", "hybrid")
    for pkg in ("port", "jax"):
        _study(pkg, tmp_path / pkg, B_STUDY, dict(params), use_vmap)
    _same_files(tmp_path / "jax", tmp_path / "port")
    for pkg, other in (("port", "jax"), ("jax", "port")):
        reader = _read(tmp_path / other, pkg=pkg)
        assert sorted(reader.get_measures()) == ["Data", "Reg"]
        assert reader.get_results("Data").shape == (
            len(params["alpha"]) * len(params.get("alg_type", [0])), 6)
        recon = reader.get_reconstructions()
        assert recon["0"].dtype == np.float16 and recon["0"].shape == (12, 14)
        np.testing.assert_array_equal(recon["shape"], (12, 14))
        assert reader.get_line_to_parameter_labels()[0].startswith("alpha=")
    header = _read(tmp_path / "port").get_file_header()
    assert "iterations=5" in header and "L2=8.0" in header \
        and "x_scale=1.0" in header
    if route == "alg_type":
        lines = _read(tmp_path / "port").get_lines_to_parameters(
            {"alpha": [0.1, 0.3, 0.6], "alg_type": "ALG3"})
        assert list(lines) == [1, 3, 5]


def test_pd_study_batched_equals_serial(f64, tmp_path):
    for mode, use_vmap in (("serial", False), ("batched", True)):
        _study("port", tmp_path / mode, B_STUDY, {"alpha": [0.1, 0.3, 0.6]},
               use_vmap)
    rs, rv = _read(tmp_path / "serial"), _read(tmp_path / "batched")
    for m in ("Data", "Reg"):
        np.testing.assert_allclose(rs.get_results(m), rv.get_results(m),
                                   rtol=1e-10)
    np.testing.assert_array_equal(rs.get_reconstructions()["2"],
                                  rv.get_reconstructions()["2"])


@pytest.mark.parametrize("use_vmap", [False, True])
def test_pd_study_append_and_resume(f64, tmp_path, use_vmap):
    """tests/test_study.py:97-131, 397-472: appending runs only the missing
    α (a complete study runs nothing and leaves its files as they were),
    as the JAX package's does; a changed configuration refuses to append."""
    for pkg in ("port", "jax"):
        out = tmp_path / pkg
        _study(pkg, out, B_STUDY, {"alpha": [0.1, 0.3]}, use_vmap)
        solver = _pd(pkg, B_STUDY, 0.1, 5)
        calls = {"n": 0}
        run, sweep = solver.run, solver.run_sweep

        def counting_run():
            calls["n"] += 1
            return run()

        def counting_sweep(values, **kw):
            calls["n"] += len(values["alpha"])
            return sweep(values, **kw)

        solver.run, solver.run_sweep = counting_run, counting_sweep
        _study(pkg, out, B_STUDY, {"alpha": [0.1, 0.3, 0.5, 0.9]}, use_vmap,
               append=True, solver=solver)
        assert calls["n"] == 2
        before = open(os.path.join(str(out), "study_parameters.txt")).read()
        calls["n"] = 0
        _study(pkg, out, B_STUDY, {"alpha": [0.1, 0.3, 0.5, 0.9]}, use_vmap,
               append=True, solver=solver)
        assert calls["n"] == 0
        assert open(os.path.join(str(out), "study_parameters.txt")).read() \
            == before
    _same_files(tmp_path / "jax", tmp_path / "port")
    reader = _read(tmp_path / "port")
    np.testing.assert_allclose(
        sorted(float(a) for a in reader.get_parameters()["alpha"]),
        [0.1, 0.3, 0.5, 0.9])
    assert set(reader.get_reconstructions()) >= {"0", "1", "2", "3"}
    with pytest.raises(RuntimeError, match="cannot be appended"):
        _study("port", tmp_path / "port", B_STUDY, {"alpha": [0.7]},
               use_vmap, append=True, iterations=7)


def test_pd_study_rejects_other_solvers(tmp_path):
    with pytest.raises(TypeError, match="PrimalDualSolver"):
        PrimalDualSolverParameterStudy(object(), Observer(), str(tmp_path))
    study = PrimalDualSolverParameterStudy(_pd("port", B_STUDY), Observer(),
                                           str(tmp_path))
    assert sorted(study.get_parameters()) == ["alg_type", "alpha"]


# ---------------------------------------------- run_sweep's fused route --

@pytest.mark.parametrize("rtype", ["TVL2", "HuberL1"])
def test_run_sweep_fused_route_matches_jax_fused_sweep(tmp_path, monkeypatch,
                                                       rtype):
    """``run_sweep`` inside the fused solve's scope against the JAX
    package's ``_fused_sweep`` in interpret mode (float32, records scaled
    to the rescaled iterate, the Huber record at γ/s): x at atol 2e-6 /
    rtol 1e-5 of the scale, records at rtol 2e-5 (tests/test_pallas.py)."""
    monkeypatch.setenv("NSOL_TPU_FUSED_INTERPRET", "1")
    jnp = pytest.importorskip("jax.numpy")
    JP, JPr, JG, JW = (_jax(m) for m in ("ops.prox", "ops.priors",
                                         "ops.grad", "solvers.wrappers"))
    rng = np.random.RandomState(9)
    b = (rng.rand(20, 24) * 200.0).astype(np.float32)
    s = float(b.max())
    alphas = np.array([0.05, 0.3, 1.1])
    ell1 = rtype.endswith("L1")
    out = {}
    for pkg in ("port", "jax"):
        solver = _pd(pkg, b, iterations=7, x_scale=s, variant=rtype,
                     reconstruction_type=rtype, observation=b / s)
        if pkg == "port":
            bt = torch.as_tensor(b, dtype=torch.float32)
            D = TG.gradient
            P = __import__("nsol_tpu_torch.ops.priors", fromlist=["x"])
            M = __import__("nsol_tpu_torch.ops.measures", fromlist=["x"])
            arr = torch.as_tensor
        else:
            bt = jnp.asarray(b)
            D, P = JG.gradient, JPr
            M = _jax("ops.measures")
            arr = jnp.asarray
        reg = (lambda x, P=P, D=D, arr=arr: P.total_variation(arr(x), D)) \
            if rtype.startswith("TV") else \
            (lambda x, P=P, D=D, arr=arr: P.huber(arr(x), D))
        dat = (lambda x, M=M, bt=bt, arr=arr:
               (M.sum_of_absolute_differences if ell1
                else M.sum_of_squared_differences)(arr(x), bt))
        measures = {"Reg": reg, "Data": dat}
        F.reset_counts()
        out[pkg] = solver.run_sweep({"alpha": alphas}, measures=measures)
        if pkg == "port":
            assert F.plain_counts(F.PD_UNITS)["pd_dual_plain"] == 7
    x_p, r_p = out["port"]
    x_j, r_j = out["jax"]
    np.testing.assert_allclose(x_p, np.asarray(x_j), atol=2e-6 * s,
                               rtol=1e-5)
    for k in ("Reg", "Data"):
        assert r_p[k].shape == (3, 8)
        np.testing.assert_allclose(r_p[k], np.asarray(r_j[k]), rtol=2e-5,
                                   atol=1e-6 * float(np.abs(r_j[k]).max()))
    # outside the scope (a measure the solve does not record, or no
    # observation): the generic solve, one α after the other
    solver = _pd("port", b, iterations=7, x_scale=s, variant=rtype,
                 reconstruction_type=rtype)
    assert not solver._in_fused_scope(None)
    F.reset_counts()
    x_g, _ = solver.run_sweep({"alpha": alphas})
    assert F.plain_counts(F.PD_UNITS)["pd_dual_plain"] == 0
    np.testing.assert_allclose(x_g, x_p, atol=2e-5 * s, rtol=1e-5)
    hinted = _pd("port", b, iterations=7, x_scale=s, variant=rtype,
                 reconstruction_type=rtype, observation=b / s)
    assert hinted._in_fused_scope({"Reg": None, "Data": None})
    assert not hinted._in_fused_scope({"Reg": None, "RMSE": None})
    with pytest.raises(NotImplementedError, match='"batch" mesh axis'):
        hinted.run_sweep({"alpha": alphas}, mesh=object())


# ------------------------------------------------ the bf16 state (K10b.4) --

def _pallas_pd(shape, rtype, iterations, **kw):
    return _jax("ops.pallas.fused").make_fused_pd_denoise_solver(
        shape, rtype, iterations=iterations, interpret=True, **kw)


def _ulp(v):
    """One bf16 ulp at each |v|."""
    _, e = np.frexp(np.abs(v))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("shape,rtype", [((24, 16), "TVL2"),
                                         ((24, 16), "HuberL1"),
                                         ((6, 8, 10), "TVL2"),
                                         ((6, 8, 10), "HuberL1")])
def test_compact_pd_step_and_solve_match_pallas(shape, rtype):
    """The plain compact solve against the Pallas kernel's
    ``compact=True`` in interpret mode: one step (and two) from the same
    bf16 state — x0 given as bf16 bit patterns, carried by
    ``interop.bf16_from_numpy`` — within one bf16 ulp, records at rtol
    2e-5; the 25-step solve at the bands of tests/test_pallas.py:176-215
    (voxel 2e-2, objective 5e-3 for L2 and 2e-2 for L1 types)."""
    rng = np.random.RandomState(10)
    b = rng.rand(*shape).astype(np.float32)
    x0 = torch.as_tensor(rng.rand(*shape).astype(np.float32)).to(BF16)
    bits = interop.bf16_to_bits(x0)
    x0_port = interop.bf16_from_numpy(bits, "cpu").float()
    x0_jax = interop.to_numpy(x0.float())
    assert torch.equal(x0_port, x0.float())
    for iterations in (1, 2):
        want, r_want = _pallas_pd(shape, rtype, iterations, record=True,
                                  compact=True)(b, x0_jax, 0.3, 8.0)
        got, r_got = F.make_fused_pd_denoise_solver(
            shape, rtype, iterations=iterations, record=True,
            compact=True)(torch.as_tensor(b), x0_port, 0.3, 8.0)
        got, want = _np(got), np.asarray(want)
        assert np.all(np.abs(got - want) <= _ulp(want))
        assert np.array_equal(got, _np(torch.as_tensor(got).to(BF16)
                                       .float()))
        for k in ("Reg", "Data"):
            np.testing.assert_allclose(_np(r_got[k]), np.asarray(r_want[k]),
                                       rtol=2e-5)
    alpha = 0.3
    solves = {}
    for mode in ("exact", "compact"):
        solves[mode] = F.make_fused_pd_denoise_solver(
            shape, rtype, iterations=25, record=True,
            compact=mode == "compact")(torch.as_tensor(b),
                                       torch.as_tensor(b), alpha, 8.0)
    x_c, r_c = solves["compact"]
    x_p, r_p = _pallas_pd(shape, rtype, 25, record=True, compact=True)(
        b, b, alpha, 8.0)
    x_p = np.asarray(x_p)
    assert np.max(np.abs(_np(x_c) - x_p)) / np.max(np.abs(x_p)) < 2e-2
    x_e, r_e = solves["exact"]
    vox = float((x_c - x_e).abs().max() / x_e.abs().max())
    obj = {m: float(r["Data"][-1]) + alpha * float(r["Reg"][-1])
           for m, r in (("exact", r_e), ("compact", r_c),
                        ("pallas", {k: np.asarray(v) for k, v in
                                    r_p.items()}))}
    band = 2e-2 if rtype.endswith("L1") else 5e-3
    assert vox < 2e-2
    assert abs(obj["compact"] - obj["exact"]) / abs(obj["exact"]) < band
    assert abs(obj["compact"] - obj["pallas"]) / abs(obj["pallas"]) < band


def test_compact_pd_units_round_where_the_reference_does():
    """The bf16 instances of the units on a stored state: the dual is
    rounded before the primal step reads it, x_new before x̄ is formed,
    and a float32 state runs the exact instances."""
    rng = np.random.RandomState(11)
    shape, nb = (9, 7), 2
    rows = [F._pd_schedules(a, 8.0, 3, "ALG2") for a in (0.2, 0.9)]
    sched = interop.pd_schedules(*(np.stack(c) for c in zip(*rows)), "cpu")
    x = torch.as_tensor(rng.rand(nb, *shape).astype(np.float32)).to(BF16)
    xm = torch.as_tensor(rng.rand(nb, *shape).astype(np.float32)).to(BF16)
    p = torch.as_tensor(rng.rand(nb, 2, *shape).astype(np.float32)
                        - 0.5).to(BF16)
    b = torch.as_tensor(rng.rand(*shape).astype(np.float32))
    inv_h = (1.0, 1.0)
    p32 = p.float()
    F.pd_dual(xm, p, sched, 1, inv_h)
    F.pd_dual(xm.float(), p32, sched, 1, inv_h)
    assert p.dtype == BF16 and torch.equal(p, p32.to(BF16))
    x32, m32 = x.float(), xm.float()
    F.pd_primal(x, xm, p, b, sched, 1, inv_h)
    F.pd_primal(x32, m32, p.float(), b, sched, 1, inv_h)
    assert torch.equal(x, x32.to(BF16))
    # x̄ comes from the rounded x_new and the stored (bf16) old x
    assert torch.equal(xm.float(), xm.float().to(BF16).float())
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        F._state_dtype("pd_dual", x, p32)


def test_pd_state_round_trips_in_bf16():
    """The compact state arrives as uint16 bit patterns (JAX's bfloat16
    arrays viewed so) or float32 upcasts and goes back either way."""
    rng = np.random.RandomState(12)
    x, xm, p = (torch.as_tensor(rng.rand(*s).astype(np.float32)).to(BF16)
                for s in ((3, 5, 6), (3, 5, 6), (3, 2, 5, 6)))
    bits = interop.pd_state_numpy(x, xm, p, bits=True)
    assert all(a.dtype == np.uint16 for a in bits)
    for form in (bits, interop.pd_state_numpy(x, xm, p)):
        back = interop.pd_state(*form, "cpu", dtype=BF16)
        assert all(t.dtype == BF16 for t in back)
        assert all(torch.equal(a, c) for a, c in zip(back, (x, xm, p)))
    jnp = pytest.importorskip("jax.numpy")
    jax_bf16 = np.asarray(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    assert torch.equal(interop.bf16_from_numpy(jax_bf16, "cpu"), x)
    with pytest.raises(ValueError, match="does not hold exactly"):
        interop.bf16_from_numpy(np.full(3, 1.0 + 2 ** -12, np.float32),
                                "cpu")
    with pytest.raises(TypeError):
        interop.bf16_from_numpy(np.ones(3), "cpu")


# ---------------------------------------------------------------- policy --

def test_pd_options_is_the_reference_criterion():
    """bf16 state only on cuda, under NSOL_TPU_COMPACT == "1", where 12
    float32 volumes fit 64 MiB (1024² yes, 256³ no) and no observer
    records the iterates."""
    on = {"NSOL_TPU_COMPACT": "1"}
    assert policy.pd_options((1024, 1024), "cuda", on) == {"compact": True}
    assert policy.pd_options((64, 64, 64), "cuda:0", on) == {"compact": True}
    for shape, device, env, observer in (
            ((256, 256, 256), "cuda", on, False),
            ((1024, 1024), "cpu", on, False),
            ((1024, 1024), "cuda", {"NSOL_TPU_COMPACT": "0"}, False),
            ((1024, 1024), "cuda", {"NSOL_TPU_COMPACT": "true"}, False),
            ((1024, 1024), "cuda", {}, False),
            ((1024, 1024), "cuda", on, True)):
        assert policy.pd_options(shape, device, env, observer) == {}
    assert policy.fused_pd_fits((1398101,))
    assert not policy.fused_pd_fits((1398102,))
    assert policy.fused_pd_fits((1024, 1024))
    assert not policy.fused_pd_fits((256, 256, 256))


# ------------------------------------------------------------------- CLIs --

def _jax_cli(module, argv, monkeypatch):
    """Run a CLI of the JAX package in this process (float64 here)."""
    cli = _jax("cli." + module)
    monkeypatch.setenv("NSOL_TPU_COMPILE_CACHE", "")
    monkeypatch.setattr(sys, "argv", [module] + argv)
    cli.main()


def _mat(path):
    import scipy.io

    return scipy.io.loadmat(path)["nda"]


@pytest.fixture(scope="module")
def small_pngs(tmp_path_factory):
    """Crops of the blurred noisy, the noisy and the clean Lena (PNG)."""
    d = tmp_path_factory.mktemp("pngs")
    out = {}
    for key, name in (("blur", "2D_Lena_256_blur_noise.png"),
                      ("noise", "2D_Lena_256_noise.png"),
                      ("clean", "2D_Lena_256.png")):
        out[key] = str(d / (key + ".png"))
        write_png(read_png(data.path(name))[100:124, 90:122], out[key])
    return out


@pytest.mark.parametrize("rtype", ["TVL2", "HuberL2"])
def test_run_deconvolution_default_pd_matches_jax_cli(f64, tmp_path,
                                                      monkeypatch, small_pngs,
                                                      rtype):
    """nsol_torch_run_deconvolution at its default --solver PD (auto →
    the inner cg for TVL2; HuberL2's linear CGLS) against the JAX CLI, in
    float64 at 1e-9 of the image's scale."""
    from nsol_tpu_torch.cli import run_deconvolution

    argv = ["--observation", small_pngs["blur"], "--reconstruction-type",
            rtype, "--iterations", "6", "--iter-max", "4"]
    _jax_cli("run_deconvolution", argv + ["--result",
                                          str(tmp_path / "jax.mat")],
             monkeypatch)
    assert run_deconvolution.main(argv + ["--result",
                                          str(tmp_path / "port.mat"),
                                          "--device", "cpu"]) == 0
    _close(_mat(str(tmp_path / "port.mat")), _mat(str(tmp_path / "jax.mat")))


@pytest.mark.parametrize("extra", [[], ["--reconstruction-type", "TK1L2"]])
def test_run_deconvolution_figures_dir_without_verbose_matches_jax_cli(
        f64, tmp_path, monkeypatch, small_pngs, extra):
    """--dir-output-figures without --verbose is a no-op in the reference
    (nsol_tpu/cli/run_deconvolution.py:292-294): the port takes the flag,
    writes the JAX CLI's result and creates no figures directory."""
    from nsol_tpu_torch.cli import run_deconvolution

    figs = tmp_path / "figs"
    argv = ["--observation", small_pngs["blur"], "--iterations", "4",
            "--iter-max", "3", "--dir-output-figures", str(figs)] + extra
    _jax_cli("run_deconvolution", argv + ["--result",
                                          str(tmp_path / "jax.mat")],
             monkeypatch)
    assert run_deconvolution.main(argv + ["--result",
                                          str(tmp_path / "port.mat"),
                                          "--device", "cpu"]) == 0
    _close(_mat(str(tmp_path / "port.mat")), _mat(str(tmp_path / "jax.mat")))
    assert not figs.exists()


def test_run_deconvolution_reference_and_robust_pd_match_jax_cli(
        f64, tmp_path, monkeypatch, small_pngs):
    """--reference (the observer's similarity measures) and a robust
    --data-loss with PD (the prox's IRLS engine) against the JAX CLI."""
    from nsol_tpu_torch.cli import run_deconvolution

    argv = ["--observation", small_pngs["blur"], "--iterations", "4",
            "--iter-max", "3", "--data-loss", "huber", "--reference",
            small_pngs["clean"], "--measures", "RMSE", "PSNR"]
    _jax_cli("run_deconvolution", argv + ["--result",
                                          str(tmp_path / "jax.mat")],
             monkeypatch)
    assert run_deconvolution.main(argv + ["--result",
                                          str(tmp_path / "port.mat"),
                                          "--device", "cpu"]) == 0
    _close(_mat(str(tmp_path / "port.mat")), _mat(str(tmp_path / "jax.mat")))


@pytest.mark.parametrize("reference", [False, True])
def test_run_denoising_study_matches_jax_cli(f64, tmp_path, monkeypatch,
                                             small_pngs, reference):
    """nsol_torch_run_denoising_study against nsol_run_denoising_study: the
    Data measure of the unscaled observation (no ½), Reg, and with
    --reference RMSE/PSNR; the port's fused route (no reference) and the
    JAX package's generic one on the CPU write the same files."""
    from nsol_tpu_torch.cli import run_denoising_study

    argv = ["--observation", small_pngs["noise"], "--iterations", "6",
            "--alpha-range", "0.01", "0.5", "3", "--study-name", "den"]
    if reference:
        argv += ["--reference", small_pngs["clean"], "--measures", "RMSE",
                 "PSNR"]
    _jax_cli("run_denoising_study", argv + ["--dir-output",
                                            str(tmp_path / "jax")],
             monkeypatch)
    F.reset_counts()
    assert run_denoising_study.main(argv + ["--dir-output",
                                            str(tmp_path / "port"),
                                            "--device", "cpu"]) == 0
    fused = F.plain_counts(F.PD_UNITS)["pd_record_plain"]
    assert fused == (0 if reference else 7)
    _same_files(tmp_path / "jax", tmp_path / "port", name="den")
    jax_reader = _read(tmp_path / "port", name="den", pkg="jax")
    assert jax_reader.get_results("Data").shape == (3, 7)


@pytest.mark.parametrize("argv", [["--solver", "ADMM", "--iterations", "4"],
                                  ["--reference", "CLEAN", "--alpha", "0.1",
                                   "--measures", "PSNR", "SSIM",
                                   "--iterations", "5"]])
def test_run_denoising_generic_routes_match_jax_cli(f64, tmp_path,
                                                    monkeypatch, small_pngs,
                                                    argv):
    """run_denoising's --solver ADMM (A = I, lsmr) and --reference (the
    generic PrimalDualSolver with an observer) against the JAX CLI."""
    from nsol_tpu_torch.cli import run_denoising

    argv = [small_pngs["clean"] if a == "CLEAN" else a for a in argv]
    argv += ["--observation", small_pngs["noise"]]
    _jax_cli("run_denoising", argv + ["--result", str(tmp_path / "jax.mat")],
             monkeypatch)
    assert run_denoising.main(argv + ["--result", str(tmp_path / "port.mat"),
                                      "--device", "cpu"]) == 0
    _close(_mat(str(tmp_path / "port.mat")), _mat(str(tmp_path / "jax.mat")))


# --------------------------------------------- the ROADMAP items named --

def _roadmap_titles():
    """Every heading and numbered item title of ROADMAP.md, lower case,
    without backticks."""
    titles = set()
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        for line in f:
            m = re.match(r"#+\s+(.*)", line) or \
                re.match(r"\s*\d+\.\s+\*\*(.+?)\*\*", line)
            if m:
                titles.add(m.group(1).replace("`", "").strip().rstrip(".")
                           .lower())
    return titles


def test_unported_messages_name_roadmap_items_by_title(tmp_path):
    """Each route that still raises names its ROADMAP.md item as "ROADMAP
    Queue N: <title>", a title ROADMAP.md has (numbers shift when the
    queue is re-anchored; titles do not)."""
    from nsol_tpu_torch import parallel as P
    from nsol_tpu_torch import pca as TP
    from nsol_tpu_torch.cli import run_deconvolution, run_denoising
    from nsol_tpu_torch.io import write_nifti

    obs = str(tmp_path / "b.nii.gz")
    write_nifti(np.random.RandomState(13).rand(4, 4, 4).astype(np.float32),
                obs)
    routes = [
        lambda: run_denoising.main(["--observation", obs, "--result",
                                    str(tmp_path / "x.nii.gz"), "--trace",
                                    str(tmp_path / "t"), "--device", "cpu"]),
        lambda: run_denoising.main(["--observation", obs, "--result",
                                    str(tmp_path / "x.nii.gz"),
                                    "--dir-output-figures",
                                    str(tmp_path / "f"), "--verbose", "1",
                                    "--device", "cpu"]),
        lambda: run_deconvolution.main(["--observation", obs, "--result",
                                        str(tmp_path / "x.nii.gz"), "--trace",
                                        str(tmp_path / "t"), "--device",
                                        "cpu"]),
        lambda: run_deconvolution.main(["--observation", obs, "--result",
                                        str(tmp_path / "x.nii.gz"),
                                        "--dir-output-figures",
                                        str(tmp_path / "f"), "--verbose", "1",
                                        "--device", "cpu"]),
        lambda: TP.PrincipalComponentAnalysis(
            np.random.RandomState(13).rand(10, 3), device="cpu").show(),
        lambda: P.make_mesh((1, 1), ("batch", "space"), device="cpu"),
        lambda: _pd("port", B_STUDY).run_sweep({"alpha": [0.1]},
                                               mesh=object()),
    ]
    titles = _roadmap_titles()
    for route in routes:
        with pytest.raises(NotImplementedError) as info:
            route()
        m = re.search(r"ROADMAP Queue (\d): (.+?)\)?$", str(info.value))
        assert m, str(info.value)
        assert m.group(2).lower() in titles, (m.group(2), str(info.value))
    # no message of the port names an item by its number
    pkg = os.path.join(REPO, "nsol_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                assert not re.search(r"Queue \d items? \d", text), name


# ------------------------------------------------------------ on the card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 53), (12, 45, 33)])
@pytest.mark.parametrize("rtype,alg", [("TVL2", "ALG2"), ("HuberL1", "ALG3"),
                                       ("HuberL2", "ALG2_AHMOD")])
def test_cuda_bf16_pd_units_match_plain_on_card(cuda_device, shape, rtype,
                                                alg):
    """The bf16 instances of pd_dual/pd_primal/pd_record on the card
    against their plain versions: the state within one bf16 ulp, the
    records within 1e-5."""
    rng = np.random.RandomState(14)
    nd = len(shape)
    ell1, huber = rtype.endswith("L1"), rtype.startswith("Huber")
    inv_h = tuple(float(np.float32(1.0 / h)) for h in (1.25, 0.8, 2.0)[:nd])
    rows = [F._pd_schedules(a, 8.0, 4, alg) for a in (0.05, 0.3, 1.2)]
    sched = interop.pd_schedules(*(np.stack(c) for c in zip(*rows)),
                                 cuda_device)

    def rand(*s, lo=0.0):
        return torch.as_tensor(rng.rand(*s).astype(np.float32) + lo,
                               device=cuda_device)

    x, xm = rand(3, *shape).to(BF16), rand(3, *shape).to(BF16)
    p, b = rand(3, nd, *shape, lo=-0.5).to(BF16), rand(*shape)
    pk, pp = p.clone(), p.clone()
    F.pd_dual(xm, pk, sched, 2, inv_h, huber)
    F.pd_dual_plain(xm, pp, sched, 2, inv_h, huber)
    xk, mk, xp, mp = x.clone(), xm.clone(), x.clone(), xm.clone()
    F.pd_primal(xk, mk, p, b, sched, 1, inv_h, ell1)
    F.pd_primal_plain(xp, mp, p, b, sched, 1, inv_h, ell1)
    recs = [torch.zeros(3, 5, dtype=torch.float64, device=cuda_device)
            for _ in range(4)]
    F.pd_record(x, b, recs[0], recs[1], 3, inv_h, ell1, huber, 0.1)
    F.pd_record_plain(x, b, recs[2], recs[3], 3, inv_h, ell1, huber, 0.1)
    torch.cuda.synchronize()
    for got, ref in ((pk, pp), (xk, xp), (mk, mp)):
        g, r = _np(got.float()), _np(ref.float())
        assert np.all(np.abs(g - r) <= _ulp(r) + 1e-30)
    for got, ref in ((recs[0], recs[2]), (recs[1], recs[3])):
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(40, 33), (12, 16, 16)])
def test_cuda_compact_pd_solve_matches_plain_on_card(cuda_device, shape):
    b = torch.as_tensor(np.random.RandomState(15).rand(*shape)
                        .astype(np.float32), device=cuda_device)
    solve = F.make_fused_pd_denoise_solver(shape, "HuberL1", iterations=20,
                                           record=True, compact=True)
    F.reset_counts()
    x_k, r_k = solve(b, b, [0.1, 0.7], 8.0)
    assert all(n > 0 for n in F.launch_counts(F.PD_UNITS).values())
    assert set(F.plain_counts().values()) == {0}
    x_p, r_p = solve.plain(b, b, [0.1, 0.7], 8.0)
    assert torch.equal(x_k, x_k.to(BF16).float())
    assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= 2e-2
    for k in ("Reg", "Data"):
        assert float((r_k[k] - r_p[k]).abs().max()
                     / r_p[k].abs().max()) <= 2e-2


@pytest.mark.cuda
def test_cuda_io_window_apply_matches_plain_on_card(cuda_device):
    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import robust as R

    rng = np.random.RandomState(16)
    st = B.Stencils.from_cov(np.diag([1.0, 0.8, 1.2]) ** 2, 3, None,
                             cuda_device)
    h = R.weighted_halo(st.blur)
    ext = (10 + 2 * h, 37, 29)
    v = torch.as_tensor(rng.rand(*ext).astype(np.float32),
                        device=cuda_device).to(BF16)
    w = torch.as_tensor(rng.rand(*ext).astype(np.float32) + 0.1,
                        device=cuda_device).to(BF16)
    for row0 in (0, 10, 20):
        args = (v, w, st.blur, st.inv_h2, 0.5, row0, 30)
        got = R.weighted_apply_prepadded(*args)
        ref = R.weighted_apply_prepadded_plain(*args)
        torch.cuda.synchronize()
        assert got.dtype == ref.dtype == BF16
        g, r = _np(got.float()), _np(ref.float())
        assert np.all(np.abs(g - r) <= _ulp(r) + 1e-5 * np.abs(r).max())


# ---------------------------------------------- the chip smoke's anchors --

def _anchor_modules():
    import importlib.util

    mods = []
    for name in ("chip_smoke", "tests/torch_anchors"):
        spec = importlib.util.spec_from_file_location(
            os.path.basename(name), os.path.join(REPO, name + ".py"))
        mods.append(importlib.util.module_from_spec(spec))
        spec.loader.exec_module(mods[-1])
    return mods


def test_chip_smoke_pd_deconvolution_cases_are_the_anchor_script_s():
    """chip_smoke.py phase 35 runs the CLI at the defaults
    tests/torch_anchors.py anchors (PD, 50 iterations, α 0.01, 10 inner
    iterations) on its cases, and the objective they compare is the
    script's."""
    cs, ta = _anchor_modules()
    assert sorted(cs.PD_DECONV_ANCHORS) == sorted(
        (name, rtype) for name, rtype in ta.PD_CASES)
    assert (cs.ITERATIONS, cs.ALPHA, cs.ITER_MAX) == (
        ta.PD_ITERATIONS, ta.PD_ALPHA, ta.PD_ITER_MAX)


@pytest.mark.slow
def test_chip_smoke_pd_deconvolution_anchors_are_the_jax_values():
    """Phase 35's anchors: the JAX package's float64 PD deconvolutions."""
    _jax("interface")
    cs, ta = _anchor_modules()
    for (_, name, rtype), value in ta.pd_anchors().items():
        assert abs(cs.PD_DECONV_ANCHORS[(name, rtype)] - value) \
            <= 1e-9 * value
