"""The port's primal-dual denoising slice against the JAX package.

Proxes, losses, priors and the generic ``primal_dual_solve`` are held to
``nsol_tpu`` in float64; the fused solve's plain path (what the wrappers
run on CPU tensors) to the Pallas kernel in interpret mode, at the
tolerances of tests/test_pallas.py; the CLI to the JAX solve. The
``cuda``-marked cases hold the three CUDA kernel units to their plain
versions on the card and skip without one. The GPU host has no jax, so the
JAX package is imported only inside the tests that compare with it:

    python -m pytest --noconftest -m cuda tests/test_torch_pd.py
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nsol_tpu_torch import interop  # noqa: E402
from nsol_tpu_torch.io import read_nifti, write_nifti, write_png  # noqa: E402
from nsol_tpu_torch.ops import grad as G  # noqa: E402
from nsol_tpu_torch.ops import losses as L  # noqa: E402
from nsol_tpu_torch.ops import priors as PR  # noqa: E402
from nsol_tpu_torch.ops import prox as P  # noqa: E402
from nsol_tpu_torch.ops.cuda import fused as F  # noqa: E402
from nsol_tpu_torch.solvers.primal_dual import (  # noqa: E402
    ALG_TYPES, primal_dual_solve)

PAIRS = (("TVL2", "ALG2"), ("TVL1", "ALG2"), ("HuberL2", "ALG3"),
         ("HuberL1", "ALG2_AHMOD"), ("TVL2", "ALG3"), ("HuberL2", "ALG2"))
SHAPES = {2: (24, 16), 3: (6, 8, 10)}


def _jax(module):
    """A module of the JAX package (skips where jax is absent)."""
    return pytest.importorskip("nsol_tpu." + module)


def _t(a, device="cpu", dtype=None):
    return interop.to_torch(np.asarray(a), device, dtype)


def _np(t):
    return interop.to_numpy(t)


# ------------------------------------------------ proxes, losses, priors --

@pytest.mark.parametrize("ndim", [2, 3])
def test_denoising_proxes_match_reference_f64(ndim):
    JP = _jax("ops.prox")
    rng = np.random.RandomState(ndim)
    x = 3.0 * rng.randn(*SHAPES[ndim])
    x0 = rng.rand(*SHAPES[ndim])
    xt, x0t = _t(x), _t(x0)
    pairs = [
        (P.soft_threshold(xt, 0.7), JP.soft_threshold(x, 0.7)),
        (P.prox_ell1_denoising(xt, 0.4, x0t), JP.prox_ell1_denoising(x, 0.4,
                                                                     x0)),
        (P.prox_ell1_denoising(xt, 0.4, x0t, 2.5),
         JP.prox_ell1_denoising(x, 0.4, x0, 2.5)),
        (P.prox_ell2_denoising(xt, 0.4, x0t, 2.5),
         JP.prox_ell2_denoising(x, 0.4, x0, 2.5)),
        (P.prox_tv_conj(xt, 0.3), JP.prox_tv_conj(x, 0.3)),
        (P.prox_huber_conj(xt, 0.3), JP.prox_huber_conj(x, 0.3)),
        (P.prox_huber_conj(xt, 0.3, 0.2), JP.prox_huber_conj(x, 0.3, 0.2)),
        (P.vectorial_soft_threshold(_t(x[None].repeat(ndim, 0)), 1.1),
         JP.vectorial_soft_threshold(x[None].repeat(ndim, 0), 1.1)),
    ]
    for k, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-12,
                                   atol=1e-12, err_msg="case %d" % k)
    assert P.HUBER_CONJ_GAMMA == JP.HUBER_CONJ_GAMMA
    # the componentwise TV-conj projection: every entry within [-1, 1]
    assert float(P.prox_tv_conj(xt, 0.3).abs().max()) <= 1.0


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("name", ["linear", "soft_l1", "huber", "cauchy",
                                  "arctan"])
def test_losses_match_reference_f64(name, ndim):
    JL = _jax("ops.losses")
    rng = np.random.RandomState(ndim)
    f = 2.0 * rng.randn(*SHAPES[ndim])
    f2 = f * f
    for f_scale in (1.0, 0.7):
        for got, want in (
                (L.loss(name)(_t(f2), f_scale=f_scale),
                 JL.loss(name)(f2, f_scale=f_scale)),
                (L.gradient_loss(name)(_t(f2), f_scale=f_scale),
                 JL.gradient_loss(name)(f2, f_scale=f_scale)),
                (L.cost_from_residual(_t(f), name, f_scale),
                 JL.cost_from_residual(f, name, f_scale)),
                (L.gradient_cost_from_residual(_t(f), name, f_scale),
                 JL.gradient_cost_from_residual(f, name, f_scale))):
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       rtol=1e-12, atol=1e-12)
    assert tuple(L.LOSSES) == tuple(JL.LOSSES)
    assert L.HUBER_GAMMA == JL.HUBER_GAMMA


@pytest.mark.parametrize("ndim", [2, 3])
def test_priors_match_reference_f64(ndim):
    JG, JPR = _jax("ops.grad"), _jax("ops.priors")
    rng = np.random.RandomState(10 + ndim)
    x = rng.rand(*SHAPES[ndim])
    spacing = [1.25, 0.8, 2.0][:ndim]
    D = lambda u: G.gradient(u, spacing)  # noqa: E731
    JD = lambda u: JG.gradient(u, spacing)  # noqa: E731
    xt = _t(x)
    for got, want in (
            (PR.zeroth_order_tikhonov(xt), JPR.zeroth_order_tikhonov(x)),
            (PR.first_order_tikhonov(xt, D), JPR.first_order_tikhonov(x, JD)),
            (PR.total_variation(xt, D), JPR.total_variation(x, JD)),
            (PR.huber(xt, D), JPR.huber(x, JD)),
            (PR.huber(xt, D, gamma=0.3), JPR.huber(x, JD, gamma=0.3))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
    assert PR.HUBER_PRIOR_GAMMA == JPR.HUBER_PRIOR_GAMMA


# ---------------------------------------------------- primal_dual_solve --

def _proxes(rtype, b, prox):
    """The CLI's prox wiring (run_denoising.py:71-78) for either package."""
    if rtype.endswith("L1"):
        prox_f = lambda x, tau: prox.prox_ell1_denoising(x, tau, b)  # noqa
    else:
        prox_f = lambda x, tau: prox.prox_ell2_denoising(x, tau, b)  # noqa
    prox_g = prox.prox_tv_conj if rtype.startswith("TV") \
        else prox.prox_huber_conj
    return prox_f, prox_g


def _jax_pd(rtype, alg, b, alpha, L2, iterations, record_fn=None,
            record_trajectory=False, spacing=None):
    """The JAX package's primal_dual_solve with the CLI's prox wiring, in
    the dtype of ``b``."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    JG, JP = _jax("ops.grad"), _jax("ops.prox")
    JPD = _jax("solvers.primal_dual")
    bj = jnp.asarray(b)
    prox_f, prox_g = _proxes(rtype, bj, JP)
    g, ga = JG.make_gradient_operators(spacing)
    rec = None if record_fn is None else (lambda x: record_fn(x, bj))
    return jax.jit(partial(
        JPD.primal_dual_solve, prox_f, prox_g, g, ga, iterations=iterations,
        alg_type=alg, record_fn=rec, record_trajectory=record_trajectory))(
            bj, jnp.asarray(alpha, bj.dtype), jnp.asarray(L2, bj.dtype))


def _port_pd(rtype, alg, b, alpha, L2, iterations, record_fn=None,
             record_trajectory=False):
    bt = _t(b)
    prox_f, prox_g = _proxes(rtype, bt, P)
    g, ga = G.make_gradient_operators()
    rec = None if record_fn is None else (lambda x: record_fn(x, bt))
    return primal_dual_solve(prox_f, prox_g, g, ga, bt, alpha, L2,
                             iterations, alg_type=alg, record_fn=rec,
                             record_trajectory=record_trajectory)


@pytest.mark.parametrize("alg", ALG_TYPES)
@pytest.mark.parametrize("rtype", F.PD_TYPES)
def test_primal_dual_solve_matches_reference_f64(rtype, alg):
    """4 types × 3 schedules at (24, 16), 12 iterations, float64: 1e-10."""
    b = np.random.RandomState(3).rand(24, 16)
    want, _ = _jax_pd(rtype, alg, b, 0.3, 8.0, 12)
    got, recs = _port_pd(rtype, alg, b, 0.3, 8.0, 12)
    assert recs is None and got.dtype == torch.float64
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-10,
                               atol=1e-10)


def test_primal_dual_records_and_trajectory_match_reference_f64():
    b = np.random.RandomState(4).rand(24, 16)

    def record(lib, x, bb):
        return {"Data": lib.sum((x - bb) ** 2), "max": lib.max(x)}

    import jax.numpy as jnp

    want_x, want = _jax_pd("HuberL2", "ALG3", b, 0.5, 8.0, 7,
                           lambda x, bb: record(jnp, x, bb), True)
    got_x, got = _port_pd("HuberL2", "ALG3", b, 0.5, 8.0, 7,
                          lambda x, bb: record(torch, x, bb), True)
    assert got["x"].shape == (8, 24, 16)
    np.testing.assert_allclose(_np(got["x"]), np.asarray(want["x"]),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(_np(got["x"][0]), b)
    for k in ("Data", "max"):
        assert got["measures"][k].shape == (8,)
        np.testing.assert_allclose(_np(got["measures"][k]),
                                   np.asarray(want["measures"][k]),
                                   rtol=1e-10, err_msg=k)
    np.testing.assert_allclose(_np(got_x), np.asarray(want_x), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("alg", ALG_TYPES)
def test_pd_schedules_match_reference_f32(alg):
    import jax.numpy as jnp

    JF = _jax("ops.pallas.fused")
    for alpha in (0.03, 1.2):
        want = JF._pd_schedules(alpha, 8.0, 20, alg, jnp.float32)
        got = F._pd_schedules(alpha, 8.0, 20, alg, np.float32)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6)


# ------------------------------------------- fused solve vs the Pallas kernel

def _pallas_pd(shape, rtype, alg="ALG2", iterations=12, **kw):
    return _jax("ops.pallas.fused").make_fused_pd_denoise_solver(
        shape, rtype, alg_type=alg, iterations=iterations, interpret=True,
        **kw)


def _counts_plain_only():
    counts = F.plain_counts(F.PD_UNITS)
    assert set(F.launch_counts(F.PD_UNITS).values()) == {0}
    return counts


@pytest.mark.parametrize("rtype,alg", PAIRS)
def test_fused_pd_plain_matches_pallas(rtype, alg):
    """tests/test_pallas.py:125 — atol 2e-6 / rtol 1e-5."""
    shape = (24, 16)
    b = np.random.RandomState(5).rand(*shape).astype(np.float32)
    want = np.asarray(_pallas_pd(shape, rtype, alg)(b, b, 0.3, 8.0))
    F.reset_counts()
    solve = F.make_fused_pd_denoise_solver(shape, rtype, alg_type=alg,
                                           iterations=12)
    got = solve(_t(b), _t(b), 0.3, 8.0)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, atol=2e-6, rtol=1e-5)
    assert _counts_plain_only() == {"pd_dual_plain": 12,
                                    "pd_primal_plain": 12,
                                    "pd_record_plain": 0}


def _nan_b(shape):
    """b with a NaN strip (a NaN background's edge, as NIfTI volumes have)
    at the start of its leading axis."""
    b = np.random.RandomState(8).rand(*shape).astype(np.float32)
    b[:2] = np.nan
    return b


def _same_nan_close(got, want, atol, rtol):
    """NaN exactly where ``want`` has NaN (some, not all), the finite
    entries within ``atol``/``rtol``."""
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    assert 0 < nan.sum() < nan.size
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], want[~nan], atol=atol, rtol=rtol)


@pytest.mark.parametrize("rtype,alg", [("TVL1", "ALG2"), ("HuberL1", "ALG2"),
                                       ("TVL1", "ALG3"), ("TVL2", "ALG2")])
def test_fused_pd_plain_keeps_nan_as_reference(rtype, alg):
    """A NaN strip in b spreads through p and the divergence, one stencil
    reach an iteration, as in the JAX package's primal_dual_solve, whose
    l1 prox (jnp.maximum, jnp.sign, as fused.py:1151) keeps a NaN; the
    finite voxels agree in float32. (The Pallas kernel forms its
    differences by matmuls, which spread a NaN over the whole axis in one
    iteration: not compared.)"""
    shape = (24, 16)
    b = _nan_b(shape)
    want, _ = _jax_pd(rtype, alg, b, 0.5, 8.0, 6)
    got = F.make_fused_pd_denoise_solver(shape, rtype, alg_type=alg,
                                         iterations=6)(_t(b), _t(b), 0.5,
                                                       8.0)
    _same_nan_close(_np(got), np.asarray(want), atol=1e-6, rtol=1e-5)


def test_fused_pd_plain_matches_pallas_3d():
    """tests/test_pallas.py:147 — (12, 16, 16), 8 iterations."""
    shape = (12, 16, 16)
    b = np.random.RandomState(6).rand(*shape).astype(np.float32)
    want = np.asarray(_pallas_pd(shape, "TVL2", iterations=8)(b, b, 0.5,
                                                                8.0))
    got = F.make_fused_pd_denoise_solver(shape, "TVL2", iterations=8)(
        _t(b), _t(b), 0.5, 8.0)
    np.testing.assert_allclose(_np(got), want, atol=2e-6, rtol=1e-5)


def test_fused_pd_two_alphas_through_one_solve():
    """tests/test_pallas.py:161 — α is a runtime scalar."""
    shape = (16, 16)
    b = np.random.RandomState(7).rand(*shape).astype(np.float32)
    pallas = _pallas_pd(shape, "TVL2", iterations=10)
    solve = F.make_fused_pd_denoise_solver(shape, "TVL2", iterations=10)
    for alpha in (0.1, 0.9):
        np.testing.assert_allclose(
            _np(solve(_t(b), _t(b), alpha, 8.0)),
            np.asarray(pallas(b, b, alpha, 8.0)), atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("rtype,record_gamma", [("TVL2", None),
                                                ("HuberL1", 0.3)])
def test_fused_pd_records_match_pallas(rtype, record_gamma):
    """tests/test_pallas.py:438 — Reg/Data rows rtol 2e-5, row 0 the x0
    state; the Huber case with a non-default runtime record γ."""
    shape = (24, 16)
    b = np.random.RandomState(8).rand(*shape).astype(np.float32)
    kw = {} if record_gamma is None else {"record_gamma": record_gamma}
    x_want, r_want = _pallas_pd(shape, rtype, iterations=7, record=True)(
        b, b, 0.4, 8.0, **kw)
    F.reset_counts()
    solve = F.make_fused_pd_denoise_solver(shape, rtype, iterations=7,
                                           record=True)
    x, recs = solve(_t(b), _t(b), 0.4, 8.0, **kw)
    np.testing.assert_allclose(_np(x), np.asarray(x_want), atol=2e-6,
                               rtol=1e-5)
    for k in ("Reg", "Data"):
        assert recs[k].shape == (8,) and recs[k].dtype == torch.float32
        np.testing.assert_allclose(_np(recs[k]), np.asarray(r_want[k]),
                                   rtol=2e-5, err_msg=k)
    assert float(recs["Data"][0]) == 0.0  # x0 = b
    assert _counts_plain_only()["pd_record_plain"] == 8


def test_fused_pd_batch_matches_pallas_vmap():
    """tests/test_pallas.py:476 — a batch of 3 alphas is jax.vmap over α."""
    import jax
    import jax.numpy as jnp

    shape = (16, 16)
    b = np.random.RandomState(9).rand(*shape).astype(np.float32)
    pallas = _pallas_pd(shape, "TVL2", iterations=6, record=True)
    alphas = np.asarray([0.1, 0.5, 1.2], np.float32)
    xs_want, r_want = jax.vmap(lambda a: pallas(b, b, a, jnp.float32(8.0)))(
        jnp.asarray(alphas))
    solve = F.make_fused_pd_denoise_solver(shape, "TVL2", iterations=6,
                                           record=True)
    for alpha_arg in (alphas, torch.as_tensor(alphas), list(alphas)):
        xs, recs = solve(_t(b), _t(b), alpha_arg, 8.0)
        assert xs.shape == (3,) + shape and recs["Reg"].shape == (3, 7)
        np.testing.assert_allclose(_np(xs), np.asarray(xs_want), atol=2e-6,
                                   rtol=1e-5)
        for k in ("Reg", "Data"):
            np.testing.assert_allclose(_np(recs[k]), np.asarray(r_want[k]),
                                       rtol=2e-5, err_msg=k)
    x1 = solve(_t(b), _t(b), float(alphas[1]), 8.0)[0]
    np.testing.assert_array_equal(_np(xs[1]), _np(x1))


def test_fused_pd_anisotropic_spacing_matches_pallas():
    shape, spacing = (10, 12, 14), [1.25, 0.8, 2.0]
    b = np.random.RandomState(10).rand(*shape).astype(np.float32)
    x_want, r_want = _pallas_pd(shape, "HuberL2", "ALG3", iterations=8,
                                spacing=spacing, record=True)(b, b, 0.2,
                                                              12.0)
    solve = F.make_fused_pd_denoise_solver(shape, "HuberL2", "ALG3",
                                           iterations=8, spacing=spacing,
                                           record=True)
    x, recs = solve(_t(b), _t(b), 0.2, 12.0)
    np.testing.assert_allclose(_np(x), np.asarray(x_want), atol=2e-6,
                               rtol=1e-5)
    for k in ("Reg", "Data"):
        np.testing.assert_allclose(_np(recs[k]), np.asarray(r_want[k]),
                                   rtol=2e-5, err_msg=k)


def test_fused_pd_solver_rejects_bad_and_unported_options():
    for args in (((8, 8), "TK1L2"), ((8,), "TVL2"),
                 ((8, 8), "TVL2", "ALG4")):
        with pytest.raises(ValueError):
            F.make_fused_pd_denoise_solver(*args)
    # the bf16 state (K10b.4) is ported: it builds and rounds the state
    b = torch.rand(8, 8)
    x = F.make_fused_pd_denoise_solver((8, 8), "TVL2", iterations=2,
                                       compact=True)(b, b, 0.1, 8.0)
    assert x.dtype == torch.float32 and torch.equal(x, x.to(torch.bfloat16)
                                                    .float())
    with pytest.raises(ValueError):
        F.make_fused_pd_denoise_solver((8, 8), "TVL2", compact="yes")
    with pytest.raises(TypeError):
        F.make_fused_pd_denoise_solver((8, 8), "TVL2", io_dtype="bfloat16")
    # interpret=True (the reference's neutral argument) runs the plain
    b = torch.rand(8, 8, dtype=torch.float64)
    s = F.make_fused_pd_denoise_solver((8, 8), "TVL2", iterations=2,
                                       interpret=True)
    assert torch.equal(s(b, b, 0.1, 8.0), s.plain(b, b, 0.1, 8.0))
    solve = F.make_fused_pd_denoise_solver((8, 8), "TVL2", iterations=2)
    with pytest.raises(ValueError):
        solve(torch.zeros(8, 9), torch.zeros(8, 9), 0.1, 8.0)
    with pytest.raises(ValueError):
        solve(torch.zeros(8, 8), torch.zeros(8, 8), np.ones((2, 2)), 8.0)


# ------------------------------------------------------------- interop --

def test_jax_schedules_through_interop_reproduce_the_jax_iterate():
    """JAX's ``_pd_schedules`` arrays, carried by ``interop.pd_schedules``
    into the port's plain steps, give the Pallas kernel's iterate."""
    import jax.numpy as jnp

    JF = _jax("ops.pallas.fused")
    shape = (24, 16)
    b = np.random.RandomState(11).rand(*shape).astype(np.float32)
    want = np.asarray(_pallas_pd(shape, "HuberL1", "ALG2")(b, b, 0.25, 8.0))
    sched = interop.pd_schedules(
        *(np.asarray(a) for a in JF._pd_schedules(0.25, 8.0, 12, "ALG2",
                                                   jnp.float32)), "cpu")
    assert sched.shape == (4, 1, 12) and sched.dtype == torch.float32
    back = interop.pd_schedules_numpy(sched)
    np.testing.assert_array_equal(back[0][0], np.asarray(JF._pd_schedules(
        0.25, 8.0, 12, "ALG2", jnp.float32)[0]))
    solve = F.make_fused_pd_denoise_solver(shape, "HuberL1", iterations=12)
    got = solve.plain_steps(_t(b), _t(b), sched)
    assert got.shape == (1,) + shape
    np.testing.assert_allclose(_np(got[0]), want, atol=2e-6, rtol=1e-5)
    with pytest.raises(ValueError):
        interop.pd_schedules(np.ones(3), np.ones(3), np.ones(4), np.ones(3),
                             "cpu")


@pytest.mark.parametrize("batch", [None, 3])
def test_pd_state_round_trips(batch):
    rng = np.random.RandomState(12)
    shape = (5, 6, 7)
    lead = () if batch is None else (batch,)
    x = rng.rand(*lead, *shape).astype(np.float32)
    xm = rng.rand(*lead, *shape).astype(np.float32)
    p = rng.rand(*lead, 3, *shape).astype(np.float32)
    tensors = interop.pd_state(x, xm, p, "cpu")
    assert tensors[2].shape == p.shape
    for a, b in zip((x, xm, p), interop.pd_state_numpy(*tensors)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        interop.pd_state(x, xm, p[..., :-1], "cpu")
    with pytest.raises(TypeError):
        interop.pd_state(x, xm, p.astype(np.float64), "cpu")


# ------------------------------------------------------------------ CLI --

def _cli(tmp_path, obs, result, *extra):
    from nsol_tpu_torch.cli import run_denoising

    return run_denoising.main(["--observation", obs, "--result", result,
                               "--iterations", "12", "--device", "cpu"]
                              + list(extra))


@pytest.mark.parametrize("kind", ["png", "nii"])
def test_denoising_cli_cpu_matches_jax_solve(tmp_path, kind):
    """``--device cpu`` equals the JAX primal_dual_solve on b/x_scale with
    x0 = b/x_scale, L2 = 8, rescaled (run_denoising.py:65-108)."""
    rng = np.random.RandomState(13)
    if kind == "png":
        obs = str(tmp_path / "b.png")
        write_png(rng.randint(0, 256, (20, 24)).astype(np.uint8), obs)
        rtype, extra = "TVL1", ["--alpha", "0.05"]
    else:
        obs = str(tmp_path / "b.nii.gz")
        write_nifti((200.0 * rng.rand(12, 16, 16)).astype(np.float32), obs,
                    spacing=np.array([1.0, 1.25, 0.8]))
        rtype, extra = "HuberL2", []
    out = str(tmp_path / "x.mat")
    assert _cli(tmp_path, obs, out, "--reconstruction-type", rtype,
                *extra) == 0
    import scipy.io

    recon = scipy.io.loadmat(out)["nda"]
    from nsol_tpu_torch.io import DataReader

    reader = DataReader(obs)
    reader.read_data()
    b = reader.get_data()
    scale = b.max()
    alpha = 0.05 if kind == "png" else 0.03
    want, _ = _jax_pd(rtype, "ALG2", b / scale, alpha, 8.0, 12)
    assert recon.shape == b.shape and np.all(np.isfinite(recon))
    np.testing.assert_allclose(recon, np.asarray(want) * scale, rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("argv,env", [
    (["--solver", "ADMM"], None), (["--reference", "REF"], None),
    (["--trace", "TRACE"], None), ([], "1"), (["1d"], None),
    (["--dir-output-figures", "FIGS", "--verbose", "1"], None)])
def test_denoising_cli_unported_routes_raise(tmp_path, monkeypatch, argv,
                                             env):
    """The routes once still to port run: ``--solver ADMM``,
    ``--reference`` and 1-D input (the generic solvers),
    ``NSOL_TPU_COMPACT=1``, which on the CPU runs the exact solve as the
    reference's CPU route does, ``--trace`` (the traced fused solve is the
    exact solve) and ``--dir-output-figures --verbose`` (a 3-D input: no
    figure, and no viewer here)."""
    obs = str(tmp_path / "b.nii.gz")
    vol = np.random.RandomState(15).rand(4, 4, 4).astype(np.float32)
    write_nifti(vol, obs)
    if argv == ["1d"]:
        obs, argv = str(tmp_path / "b1.nii.gz"), []
        write_nifti(vol.reshape(-1), obs)
    names = {"REF": "ref.nii.gz", "TRACE": "trace", "FIGS": "figs"}
    argv = [str(tmp_path / names[a]) if a in names else a for a in argv]
    if argv and argv[0] == "--reference":
        write_nifti(vol, argv[1], spacing=np.ones(3))
    if env is not None:
        monkeypatch.setenv("NSOL_TPU_COMPACT", env)
    out = str(tmp_path / "x.nii.gz")
    assert _cli(tmp_path, obs, out, *argv) == 0
    if argv and argv[0] in ("--trace", "--dir-output-figures"):
        assert os.path.isdir(argv[1])
    got = read_nifti(out).data
    b = read_nifti(obs).data.astype(np.float64)
    if argv[:2] == ["--solver", "ADMM"] or b.ndim == 1:
        assert got.shape == b.shape and np.all(np.isfinite(got))
        return
    # the fused solve (NSOL_TPU_COMPACT=1 on the CPU) and the generic one
    # (--reference) are the exact solve
    want, _ = _jax_pd("TVL2", "ALG2", b / b.max(), 0.03, 8.0, 12)
    np.testing.assert_allclose(got, np.asarray(want) * b.max(), rtol=1e-5,
                               atol=1e-5 * b.max())


def test_denoising_cli_ignores_compact_values_other_than_1(tmp_path,
                                                           monkeypatch):
    """ROADMAP R2: only NSOL_TPU_COMPACT == "1" selects the bf16 path."""
    obs, out = str(tmp_path / "b.nii.gz"), str(tmp_path / "x.nii.gz")
    write_nifti(np.random.RandomState(14).rand(4, 5, 6).astype(np.float32),
                obs)
    monkeypatch.setenv("NSOL_TPU_COMPACT", "0")
    assert _cli(tmp_path, obs, out) == 0
    assert read_nifti(out).data.shape == (4, 5, 6)


# ------------------------------------------------------------ on the card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _unit_pairs(device, shape, rtype, alg):
    """Every PD unit and its plain version on identical random inputs, a
    batch of 3 alphas, anisotropic spacing: (kernel, plain) pairs."""
    rng = np.random.RandomState(0)
    nd = len(shape)
    ell1, huber = rtype.endswith("L1"), rtype.startswith("Huber")
    inv_h = tuple(float(np.float32(1.0 / h)) for h in [1.25, 0.8, 2.0][:nd])
    rows = [F._pd_schedules(a, 8.0, 4, alg) for a in (0.05, 0.3, 1.2)]
    sched = interop.pd_schedules(*(np.stack(c) for c in zip(*rows)), device)
    f32 = lambda a: _t(a.astype(np.float32), device)  # noqa: E731
    x, xm = f32(rng.rand(3, *shape)), f32(rng.rand(3, *shape))
    p, b = f32(rng.rand(3, nd, *shape) - 0.5), f32(rng.rand(*shape))
    pairs = []
    pk, pp = p.clone(), p.clone()
    F.pd_dual(xm, pk, sched, 2, inv_h, huber)
    F.pd_dual_plain(xm, pp, sched, 2, inv_h, huber)
    pairs.append((pk, pp))
    xk, mk, xp, mp = x.clone(), xm.clone(), x.clone(), xm.clone()
    F.pd_primal(xk, mk, p, b, sched, 1, inv_h, ell1)
    F.pd_primal_plain(xp, mp, p, b, sched, 1, inv_h, ell1)
    pairs += [(xk, xp), (mk, mp)]
    recs = [torch.zeros(3, 5, dtype=torch.float64, device=device)
            for _ in range(4)]
    F.pd_record(x, b, recs[0], recs[1], 3, inv_h, ell1, huber, 0.1)
    F.pd_record_plain(x, b, recs[2], recs[3], 3, inv_h, ell1, huber, 0.1)
    pairs += [(recs[0], recs[2]), (recs[1], recs[3])]
    return pairs


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 53), (37, 45, 53), (5, 40, 33)])
@pytest.mark.parametrize("rtype,alg", PAIRS)
def test_cuda_pd_units_match_plain_on_card(cuda_device, shape, rtype, alg):
    """Kernel vs plain on the card, f32: max |Δ| ≤ 1e-5 · max |ref|."""
    pairs = _unit_pairs(cuda_device, shape, rtype, alg)
    torch.cuda.synchronize()
    for k, (got, ref) in enumerate(pairs):
        err = float((got - ref).abs().max() / ref.abs().max())
        assert err <= 1e-5, "output %d: %.3g" % (k, err)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(40, 33), (12, 16, 16)])
def test_cuda_pd_solve_matches_plain_on_card(cuda_device, shape):
    b = _t(np.random.RandomState(1).rand(*shape).astype(np.float32),
           cuda_device)
    solve = F.make_fused_pd_denoise_solver(shape, "HuberL1", iterations=20,
                                           record=True)
    F.reset_counts()
    x_k, r_k = solve(b, b, [0.1, 0.7], 8.0)
    # the batch's state fits the one-launch rule (csrc/pd_persistent.cu)
    assert solve.route(2) == "persistent" and F.launch_counts(
        F.PD_UNITS) == {"pd_dual": 0, "pd_primal": 0, "pd_record": 0,
                        "pd_persistent": 1}
    assert set(F.plain_counts().values()) == {0}
    x_p, r_p = solve.plain(b, b, [0.1, 0.7], 8.0)
    assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= 1e-5
    for k in ("Reg", "Data"):  # row 0 of Data is 0 (x0 = b)
        assert float((r_k[k] - r_p[k]).abs().max()
                     / r_p[k].abs().max()) <= 1e-5


def _chip_smoke():
    """``chip_smoke.py``, whose phase 7 holds the NaN case."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(40, 33), (12, 16, 16)])
@pytest.mark.parametrize("rtype", F.PD_TYPES)
def test_cuda_pd_solve_keeps_nan_on_card(cuda_device, shape, rtype):
    """A NaN strip in b: the kernels' solve has NaN where its plain version
    has NaN, in x and in the records, and agrees elsewhere within 1e-5 ·
    max |ref| (chip_smoke.py::pd_nan_case). An l1 prox that zeroes a NaN
    step keeps the NaN in its strip where the reference spreads it."""
    assert _chip_smoke().pd_nan_case(F, shape, rtype, cuda_device) > 0
