"""The port's compact-storage linear TV-L2 slice (K10) against the JAX
package.

The storage-typed units (``io_dtype``, ``r_dtype``, ``q_dtype``), the
blocked solve under ``compact_dirs`` (True and ``"qf32"``) and
``state_dtype=bfloat16``, and the fused solve under ``compact_dirs`` with
``precision="high3"`` — their plain versions on the CPU, which round to
bfloat16 at the kernels' points — against the Pallas kernels in
interpret mode, at the tolerances of tests/test_pallas.py (:1090-1124,
:1199-1224, :1312-1351, :1419-1455); ``policy.storage_options`` and the
CLI's route; the solver factories' JAX-package arguments (one check for
all). The ``cuda``-marked cases hold the bfloat16 kernels against their
plain versions on the card and skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_compact.py
"""

import functools

import numpy as np
import pytest
import scipy.ndimage as ndi

torch = pytest.importorskip("torch")

from nsol_tpu_torch import interop, policy  # noqa: E402
from nsol_tpu_torch.ops.kernels import gaussian_kernel  # noqa: E402
from nsol_tpu_torch.ops.cuda import blocked as B  # noqa: E402
from nsol_tpu_torch.ops.cuda import fused as F  # noqa: E402
from nsol_tpu_torch.ops.cuda import robust as R  # noqa: E402
from nsol_tpu_torch.ops.cuda import tikhonov as T  # noqa: E402

ISO = np.diag([1.0, 1.0, 1.0])
SHAPE = (32, 16, 16)
BF16 = torch.bfloat16


def _jax(module):
    """A module of the JAX package (skips where jax is absent)."""
    return pytest.importorskip("nsol_tpu." + module)


def _jnp():
    return pytest.importorskip("jax.numpy")


def _t(a, device="cpu"):
    return interop.to_torch(np.asarray(a, np.float32), device)


def _np(t):
    return t.float().cpu().numpy().astype(np.float64)


def _jf(a):
    """A JAX array (bfloat16 or not) as float64 numpy."""
    return np.asarray(a.astype(_jnp().float32), np.float64)


def _blurred(seed, shape, cov=ISO, spacing=None):
    rng = np.random.RandomState(seed)
    kern = gaussian_kernel(cov, alpha_cut=3, spacing=spacing)
    x_true = (rng.rand(*shape) > 0.6).astype(np.float64)
    return ndi.convolve(x_true, kern, mode="wrap").astype(np.float32)


def _objective(x, b, alpha=0.01):
    """½‖Ax − b‖² + α·TV(x) in float64, unit spacing, σ = 1."""
    x = np.asarray(x, np.float64)
    r = ndi.convolve(x, gaussian_kernel(np.eye(x.ndim), alpha_cut=3),
                     mode="wrap") - b
    g = [np.diff(x, axis=ax, append=0.0 * x.take([0], axis=ax))
         for ax in range(x.ndim)]
    return 0.5 * np.sum(r * r) + alpha * np.sum(np.sqrt(sum(c * c for c in g)))


def _within_ulp(got, want):
    """bfloat16 values within one bf16 ulp of the reference's."""
    np.testing.assert_allclose(_np(got), want, rtol=2 ** -7, atol=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


# ------------------------------------------------------------ the units --

def test_normal_operators_bf16_io_match_pallas():
    """``make_blocked_normal_operator(io_dtype=bfloat16)`` (1-D) and
    ``make_blocked_normal_operator_2d`` (the tiled unit's plain version)
    against the Pallas kernels: one bf16 ulp."""
    jnp = _jnp()
    JB = _jax("ops.pallas.blocked")
    rng = np.random.RandomState(1)
    v = rng.rand(*SHAPE).astype(np.float32)
    want = _jf(JB.make_blocked_normal_operator(
        SHAPE, ISO, block=8, interpret=True, io_dtype=jnp.bfloat16)(v, 0.7))
    got = B.make_blocked_normal_operator(SHAPE, ISO, io_dtype="bfloat16")(
        _t(v), 0.7)
    assert got.dtype == BF16
    _within_ulp(got, want)
    wide = (16, 512, 16)
    v2 = rng.rand(*wide).astype(np.float32)
    want2 = _jf(JB.make_blocked_normal_operator_2d(
        wide, ISO, z_block=8, y_block=128, interpret=True,
        io_dtype=jnp.bfloat16)(v2, 0.7))
    got2 = B.make_blocked_normal_operator_2d(
        wide, ISO, z_block=8, io_dtype=torch.bfloat16)(_t(v2), 0.7)
    _within_ulp(got2, want2)


@pytest.mark.parametrize("split,storage", [
    (dict(io_dtype="bfloat16"), "state"),
    (dict(io_dtype="bfloat16", r_dtype="float32"), "dirs"),
    (dict(io_dtype="bfloat16", r_dtype="float32", q_dtype="float32"),
     "qf32")])
def test_cg_step_storage_matches_pallas(split, storage):
    """``make_blocked_cg_step`` with the reference's storage splits: p'
    and q within one bf16 ulp (or 2e-5 in float32), pq rtol 1e-5 — taken
    from the rounded p' and the float q."""
    jnp = _jnp()
    rng = np.random.RandomState(2)
    r, p = (rng.rand(*SHAPE).astype(np.float32) - 0.3 for _ in range(2))
    jsplit = {k: getattr(jnp, v) for k, v in split.items()}
    want = _jax("ops.pallas.blocked").make_blocked_cg_step(
        SHAPE, ISO, block=8, interpret=True, **jsplit)(r, p, 0.83, 1.9)
    got = B.make_blocked_cg_step(SHAPE, ISO, **split)(_t(r), _t(p), 0.83,
                                                      1.9)
    dts = tuple(torch.float32 if d is None else d
                for d in B.STORAGE[storage])
    assert (got[0].dtype, got[1].dtype) == dts[1:]
    _within_ulp(got[0], _jf(want[0]))
    if got[1].dtype == BF16:
        _within_ulp(got[1], _jf(want[1]))
    else:
        np.testing.assert_allclose(_np(got[1]), _jf(want[1]), atol=2e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)


def test_storage_units_round_at_the_reference_points():
    """The plain units: "step"'s pq from the float q, "apply"'s from the
    rounded q; under bf16 state the outer residual reads x in bf16 and
    stores r in bf16 (γ from the unrounded r); the deferred direction
    takes the unrounded r'."""
    from nsol_tpu_torch.ops.cuda import tiled as Z

    rng = np.random.RandomState(3)
    st = B.Stencils.from_cov(ISO, 3)
    x, rhs, r = (_t(rng.rand(*SHAPE)) for _ in range(3))
    scal = B.new_scalars("cpu")
    res = B.normal_apply(x, st.normal, st.inv_h2, 0.5, rhs=rhs, scal=scal,
                         io_dtype=BF16)
    xb = x.to(BF16).float()
    q = B._apply_plain(xb, st.normal, st.inv_h2, 0.5)
    want = rhs - q.to(BF16).float()
    assert res.dtype == BF16 and torch.equal(res, want.to(BF16))
    assert float(scal[B.GAMMA]) == pytest.approx(float(torch.sum(want ** 2)),
                                                 rel=1e-6)
    p = x.to(BF16)
    sc = B.new_scalars("cpu")
    sc[B.GAMMA] = 1.0
    qz = Z.normal_apply_zy(p, st.normal, st.inv_h2, 0.5, scal=sc,
                           io_dtype=BF16)
    assert float(sc[B.PQ]) == pytest.approx(
        float(torch.sum(p.float() * qz.float())), rel=1e-6)
    _, q32 = B.cg_step(r, None, sc, st.normal, st.inv_h2, 0.5, first=True,
                       storage="dirs")
    pw = r.to(BF16).float()
    assert float(sc[B.PQ]) == pytest.approx(float(torch.sum(
        pw * B._apply_plain(pw, st.normal, st.inv_h2, 0.5))), rel=1e-6)
    # deferred direction: p = bf16(r' + β p) with r' = r − a q unrounded
    rb, pb, qb = (t.to(BF16) for t in (r, x, rhs))
    sc[B.A], sc[B.BETA] = 0.3, 0.7
    r2, p2 = rb.clone(), pb.clone()
    Z.cg_direction(p2, r2, sc, q=qb)
    rn = rb.float() - 0.3 * qb.float()
    assert torch.equal(r2, rn.to(BF16))
    assert torch.equal(p2, (rn + 0.7 * pb.float()).to(BF16))


# ------------------------------------------------------- blocked solves --

def _jax_blocked(shape, iterations, iter_max, b, spacing=None, **kw):
    s = _jax("ops.pallas.blocked").blocked_admm_solve(
        shape, ISO, spacing=spacing, iterations=iterations,
        iter_max=iter_max, interpret=True, **kw)
    return np.asarray(s(b, b, 0.01, 0.5), np.float64)


def _port_blocked(shape, iterations, iter_max, b, spacing=None, **kw):
    s = B.blocked_admm_solve(shape, ISO, spacing=spacing,
                             iterations=iterations, iter_max=iter_max, **kw)
    return _np(s(_t(b), _t(b), 0.01, 0.5))


@pytest.mark.parametrize("mode,cd", [("step", True), ("apply", True),
                                     ("step", "qf32")])
def test_blocked_compact_dirs_matches_pallas(mode, cd):
    """``compact_dirs`` at (32, 16, 16), 6 × 8: the voxel within
    5e-4 · max |x| of the JAX solve with the same option, and, in the
    port's own runs, the compact-directions deviation from f32 below a
    tenth of the full-compact one (tests/test_pallas.py:1312-1351)."""
    b = _blurred(4, SHAPE)
    want = _jax_blocked(SHAPE, 6, 8, b, mode=mode, block=8, compact_dirs=cd)
    got = _port_blocked(SHAPE, 6, 8, b, mode=mode, compact_dirs=cd)
    sc = np.abs(want).max()
    assert np.abs(got - want).max() <= 5e-4 * sc
    if cd is True:
        x32 = _port_blocked(SHAPE, 6, 8, b, mode=mode)
        full = _port_blocked(SHAPE, 6, 8, b, mode=mode,
                             state_dtype=torch.bfloat16)
        dev_dirs = np.abs(got - x32).max() / np.abs(x32).max()
        dev_full = np.abs(full - x32).max() / np.abs(x32).max()
        assert dev_dirs < 5e-4 and dev_dirs < 0.1 * dev_full


def test_blocked_compact_dirs_nonunit_spacing_matches_pallas():
    """Spacing (0.7, 0.9, 1.1), "step", 4 × 6: within 2e-3 · max |x| of the
    JAX compact_dirs solve (tests/test_pallas.py:1419-1455)."""
    spacing = np.array([0.7, 0.9, 1.1])
    b = _blurred(5, SHAPE, spacing=spacing)
    want = _jax_blocked(SHAPE, 4, 6, b, spacing=spacing, mode="step",
                        compact_dirs=True)
    got = _port_blocked(SHAPE, 4, 6, b, spacing=spacing, mode="step",
                        compact_dirs=True)
    assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()


@pytest.mark.parametrize("mode", ["step", "apply"])
def test_blocked_state_dtype_matches_pallas(mode):
    """``state_dtype=bfloat16`` at (32, 16, 16), 6 × 6: the objective
    within 1e-3 of the JAX solve's (tests/test_pallas.py:1090-1124)."""
    b = _blurred(6, SHAPE)
    want = _jax_blocked(SHAPE, 6, 6, b, mode=mode,
                        state_dtype=_jnp().bfloat16)
    got = _port_blocked(SHAPE, 6, 6, b, mode=mode, state_dtype="bfloat16")
    o, ow = _objective(got, b), _objective(want, b)
    assert abs(o - ow) <= 1e-3 * ow


def test_blocked_storage_guards():
    """The reference's guards, one for one (blocked.py:1341-1407)."""
    with pytest.raises(ValueError, match="mutually exclusive"):
        B.blocked_admm_solve(SHAPE, ISO, compact_dirs=True,
                             state_dtype=BF16)
    with pytest.raises(ValueError, match="step2d"):
        B.blocked_admm_solve((16, 512, 16), ISO, mode="step2d",
                             state_dtype=BF16)
    for mode in ("auto", "step", "apply"):
        s = B.blocked_admm_solve(SHAPE, ISO, mode=mode, compact_dirs=True)
        assert s.storage == "dirs" and s.mode in ("step", "apply")
    assert B.blocked_admm_solve(SHAPE, ISO, mode="apply",
                                compact_dirs="qf32").storage == "dirs"
    assert B.blocked_admm_solve(SHAPE, ISO, mode="step",
                                state_dtype="float32").storage == "exact"
    with pytest.raises(ValueError, match="bfloat16"):
        B.blocked_admm_solve(SHAPE, ISO, state_dtype="float16")
    with pytest.raises(ValueError, match="compact_dirs must be"):
        B.blocked_admm_solve(SHAPE, ISO, compact_dirs="f16")


# --------------------------------------------------------- fused solves --

@pytest.mark.parametrize("shape,iterations,iter_max", [
    ((16, 16, 16), 10, 8), ((64, 64), 6, 8)])
def test_fused_compact_dirs_matches_pallas(shape, iterations, iter_max):
    """``make_fused_admm_solver(compact_dirs=True, precision="high3")``:
    the voxel within 5e-4 · max |x| of the Pallas kernel's
    (tests/test_pallas.py:1199-1224), and with ``record=True`` the rows
    within 1e-4 relative."""
    cov = np.eye(len(shape))
    b = _blurred(7, shape, cov)
    JF = _jax("ops.pallas.fused")
    want, wrec = JF.make_fused_admm_solver(
        shape, cov, iterations=iterations, iter_max=iter_max,
        precision="high3", compact_dirs=True, record=True,
        interpret=True)(b, b, 0.01, 0.5)
    solve = F.make_fused_admm_solver(
        shape, cov, iterations=iterations, iter_max=iter_max,
        precision="high3", compact_dirs=True, record=True)
    F.reset_counts()
    got, grec = solve(_t(b), _t(b), 0.01, 0.5)
    assert F.plain_counts(("cg_step",))["cg_step_plain"] \
        == iterations * iter_max
    want = np.asarray(want, np.float64)
    assert np.abs(_np(got) - want).max() <= 5e-4 * np.abs(want).max()
    for k in ("Reg", "Data"):
        np.testing.assert_allclose(_np(grec[k]), np.asarray(wrec[k]),
                                   rtol=1e-4)


# ------------------------------------------------------- the arguments --

def test_factories_take_the_reference_positional_order():
    """F2: ``make_fused_admm_solver`` and ``blocked_admm_solve`` take the
    reference's positional order (the seventh is ``dtype``) and its
    neutral arguments; anything else raises."""
    jnp = _jnp()
    lax = pytest.importorskip("jax.lax")
    b = _t(_blurred(8, (8, 8, 8)))
    ref = F.make_fused_admm_solver((8, 8, 8), ISO, 3, None, 2, 3)(
        b, b, 0.01, 0.5)
    for prec in (None, "HIGHEST", lax.Precision.HIGHEST, "high3"):
        s = F.make_fused_admm_solver((8, 8, 8), ISO, 3, None, 2, 3,
                                     jnp.float32, prec, "linear", 8, False,
                                     True, False, False, True, None)
        assert torch.equal(s(b, b, 0.01, 0.5), ref)  # interpret: the plain
    s = B.blocked_admm_solve((8, 8, 8), ISO, 3, None, 2, 3, np.float32,
                             "HIGHEST", None, True, "step", None, False,
                             "auto")
    assert torch.equal(s(b, b, 0.01, 0.5), ref)
    for kw in (dict(dtype=np.float64), dict(precision="DEFAULT"),
               dict(precision=lax.Precision.HIGH), dict(pipelined_cg=True),
               dict(blur_reorder=False), dict(diff_matmul=True),
               dict(compact_dirs=True),  # compact_dirs needs high3
               dict(compact_dirs="qf32", precision="high3")):  # bool only
        with pytest.raises(ValueError):
            F.make_fused_admm_solver((8, 8, 8), ISO, **kw)
    for kw in (dict(block=8), dict(blur_reorder="default1"),
               dict(precision="high2"), dict(dtype=jnp.bfloat16)):
        with pytest.raises(ValueError):
            B.blocked_admm_solve((8, 8, 8), ISO, **kw)
    with pytest.raises(TypeError):
        F.make_fused_admm_solver((8, 8, 8), ISO, io_dtype=BF16)
    with pytest.raises(TypeError):
        B.make_blocked_cg_step((8, 8, 8), ISO, n_bufs=2)


def test_unported_storage_modes_name_k10b():
    """F1: every factory's storage options go through one check; those
    still to port — the PD solve's ``compact`` (K10b.4) and the per-shard
    weighted window's ``io_dtype`` (K10b.6) — raise naming K10b, the
    robust and Tikhonov ones (K10b.1-3, 5) build, and nothing says a
    storage mode has no counterpart."""
    wide = (16, 512, 16)
    for build in (
            lambda: F.make_fused_pd_denoise_solver((8, 8), "TVL2",
                                                   compact=True),
            lambda: R.make_blocked_weighted_normal_operator(
                (8, 8, 8), ISO, prepadded=True, io_dtype=BF16)):
        with pytest.raises(NotImplementedError, match="K10b"):
            build()
    F.make_fused_admm_solver((8, 8), np.eye(2), data_loss="huber",
                             precision="high3", compact_dirs=True)
    assert R.blocked_robust_admm_solve(wide, ISO,
                                       compact_dirs=True).storage == "io"
    R.make_blocked_weighted_normal_operator(wide, ISO, io_dtype=BF16)
    R.make_blocked_weighted_normal_operator_2d(wide, ISO, io_dtype=BF16)
    assert T.make_fused_tikhonov_solver((8, 8), np.eye(2), compact_dirs=True,
                                        precision="high3").compact
    # their neutral arguments pass, and the off values of the modes
    T.make_fused_tikhonov_solver((8, 8), np.eye(2), precision="high3",
                                 compact_dirs=False, dtype="float32")
    R.blocked_robust_admm_solve(wide, ISO, compact_dirs=False,
                                precision="HIGHEST")
    F.make_fused_pd_denoise_solver((8, 8), "TVL2", compact=False,
                                   interpret=True)
    import inspect

    for mod in (B, F, R, T):
        assert "has no counterpart" not in inspect.getsource(mod)


# ----------------------------------------------------------- the policy --

@pytest.mark.parametrize("shape,route", [
    ((64, 64, 64), ("fused", None)), ((128, 128, 128), ("blocked", "step")),
    ((256, 256, 256), ("blocked", "step")),
    ((64, 512, 512), ("blocked", "apply")), ((1024, 1024), ("fused", None)),
    ((256, 256), ("fused", None)), ((2048, 2048), ("fused", None))])
def test_policy_picks_the_reference_route(shape, route):
    """The route by the reference's criteria: the fused solve where its
    16 volumes fit 64 MiB (``fused_admm_fits_vmem``), else blocked "apply"
    at 512-wide planes and "step" elsewhere in 3-D."""
    cov = np.eye(len(shape))
    assert policy.pick_route(shape, cov) == route
    assert policy.fused_fits(shape) == (
        16 * 4 * int(np.prod(shape)) <= 64 * 2 ** 20)
    if len(shape) == 3 and shape[2] <= 64:
        assert _jax("ops.pallas.fused").fused_admm_fits_vmem(shape) \
            == policy.fused_fits(shape)


def test_policy_storage_options_follow_the_reference_cli():
    """``storage_options``: the CLI's compact default on CUDA per route;
    the switches are on for "1" only ("0" and "" change nothing); the CPU,
    NSOL_TPU_EXACT=1 and a 2-D shape past the fused limit give the exact
    solve."""
    so = policy.storage_options
    cube, big2d = (64, 64, 64), (2048, 2048)
    fused = {"precision": "high3", "compact_dirs": True}
    for env in ({}, {"NSOL_TPU_EXACT": "0"}, {"NSOL_TPU_EXACT": ""},
                {"NSOL_TPU_COMPACT": "0"}, {"NSOL_TPU_COMPACT": "true"}):
        assert so("fused", cube, "cuda", env) == fused
        assert so("blocked", (128,) * 3, "cuda:0", env) == \
            {"compact_dirs": True}
    assert so("blocked", (128,) * 3, "cuda", {"NSOL_TPU_COMPACT": "1"}) \
        == {"state_dtype": BF16}
    assert so("fused", cube, "cuda", {"NSOL_TPU_COMPACT": "1"}) == fused
    for env in ({"NSOL_TPU_EXACT": "1"},):
        assert so("fused", cube, "cuda", env) == {}
        assert so("blocked", (128,) * 3, "cuda", env) == {}
    assert so("fused", big2d, "cuda", {}) == {}
    for route in ("fused", "blocked"):
        assert so(route, cube, "cpu", {}) == {}
        assert so(route, cube, torch.device("cpu"), {}) == {}


@pytest.mark.parametrize("shape", [(16, 16, 16), (24, 20)])
def test_policy_cuda_choice_runs_the_compact_solve(shape):
    """The CUDA route's factory and options, run on CPU tensors, equal the
    compact library solve (the same factory with the options written
    out)."""
    cov = np.eye(len(shape))
    b = _t(_blurred(9, shape, cov))
    build, kw = policy.tvl2_solver(shape, cov, None, "cuda", 3, 4, env={})
    assert build is F.make_fused_admm_solver
    assert kw["compact_dirs"] is True and kw["precision"] == "high3"
    got = build(**kw)(b, b, 0.01, 0.5)
    want = F.make_fused_admm_solver(shape, cov, iterations=3, iter_max=4,
                                    precision="high3",
                                    compact_dirs=True)(b, b, 0.01, 0.5)
    assert torch.equal(got, want)
    exact = F.make_fused_admm_solver(shape, cov, iterations=3,
                                     iter_max=4)(b, b, 0.01, 0.5)
    assert not torch.equal(got, exact)
    b3 = (128, 128, 128)
    build, kw = policy.tvl2_solver(b3, ISO, None, "cuda", 2, 2,
                                   env={"NSOL_TPU_COMPACT": "1"})
    s = build(**kw)
    assert build is B.blocked_admm_solve
    assert (s.mode, s.storage) == ("step", "state")


def test_policy_cuda_choice_runs_the_blocked_compact_solve():
    """Past the fused solve's limit with 512-wide planes the CUDA choice is
    blocked "apply" with ``compact_dirs``; run on CPU tensors it equals
    that library solve."""
    shape = (16, 512, 130)
    build, kw = policy.tvl2_solver(shape, ISO, None, "cuda", 2, 2, env={})
    solve = build(**kw)
    assert build is B.blocked_admm_solve
    assert (solve.mode, solve.storage) == ("apply", "dirs")
    b = _t(_blurred(12, shape))
    want = B.blocked_admm_solve(shape, ISO, iterations=2, iter_max=2,
                                compact_dirs=True)(b, b, 0.01, 0.5)
    assert torch.equal(solve(b, b, 0.01, 0.5), want)


def test_cli_cpu_stays_exact(tmp_path, monkeypatch):
    """``run_deconvolution --device cpu`` on a 16³ NIfTI runs the exact
    solve, whatever the environment switches say, and equals the
    library's."""
    from nsol_tpu_torch.cli import run_deconvolution
    from nsol_tpu_torch.io import read_nifti, write_nifti

    monkeypatch.setenv("NSOL_TPU_COMPACT", "1")
    monkeypatch.setenv("NSOL_TPU_EXACT", "0")
    shape = (16, 16, 16)
    obs, out = str(tmp_path / "b.nii.gz"), str(tmp_path / "x.nii.gz")
    write_nifti(200.0 * _blurred(10, shape), obs, spacing=np.ones(3))
    rc = run_deconvolution.main([
        "--observation", obs, "--result", out, "--solver", "ADMM",
        "--reconstruction-type", "TVL2", "--iterations", "3",
        "--iter-max", "4", "--device", "cpu"])
    assert rc == 0
    b = read_nifti(obs).data.astype(np.float64)
    bs = _t(b / b.max())
    lib = F.make_fused_admm_solver(shape, ISO, iterations=3, iter_max=4)(
        bs, bs, 0.01, 0.5)
    np.testing.assert_allclose(read_nifti(out).data,
                               _np(lib) * b.max(), rtol=1e-6,
                               atol=1e-6 * b.max())


# ---------------------------------------------------------- on the card --

def _chip_smoke():
    """``chip_smoke.py``, whose phase 23 builds the unit/plain pairs."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 16, 16), (13, 45, 37), (1, 40, 33)])
def test_cuda_storage_units_match_plain_on_card(cuda_device, shape):
    """Every storage-typed unit against its plain version: float32 outputs
    within 1e-5 · max |ref|, bfloat16 ones within one bf16 ulp, the dots
    1e-5."""
    cs = _chip_smoke()
    st = B.Stencils.from_cov(np.diag([1.3, 0.8, 1.1]) ** 2, 3,
                             (1.0, 1.5, 0.8), cuda_device)
    pairs = cs.compact_unit_pairs(B, st, shape, cuda_device,
                                  np.random.RandomState(4))
    assert cs.compact_pairs_err(pairs) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(mode="step", compact_dirs=True),
                                dict(mode="step", compact_dirs="qf32"),
                                dict(mode="step", state_dtype=BF16),
                                dict(mode="apply", compact_dirs=True),
                                dict(mode="apply", state_dtype=BF16)])
def test_cuda_compact_solves_match_plain_on_card(cuda_device, kw):
    """Each blocked compact solve against its plain version: at 3 × 5 the
    objective and each voxel within the storage's bands, and at 1 × 2 its
    RMS gap within a fifth of the plain solve's gap to the exact one
    (``chip_smoke.compact_gaps_ok``)."""
    cs = _chip_smoke()
    b = _t(_blurred(11, (24, 40, 36)), cuda_device)
    solve = B.blocked_admm_solve(b.shape, ISO, iterations=3, iter_max=5,
                                 **kw)
    F.reset_counts()
    solve(b, b, 0.01, 0.5)
    assert set(F.plain_counts().values()) == {0}
    gaps = cs.compact_plain_gaps(
        functools.partial(B.blocked_admm_solve, b.shape, ISO, iter_max=5),
        kw, b, lambda x: _objective(_np(x), _np(b)), outer=3)
    assert cs.compact_gaps_ok(gaps, kw), gaps
