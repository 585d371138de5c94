"""The port's robust and Tikhonov compact storage (K10b.1-3, 5) against the
JAX package, and the robust route and sweep storage of ``policy.py``.

The fused robust solve and the fused Tikhonov solve under
``compact_dirs=True, precision="high3"`` (bfloat16 CG directions), the
blocked robust solve under ``compact_dirs=True`` and the weighted normal
operators under ``io_dtype=bfloat16`` (bfloat16 directions, weights read
as bfloat16, the apply's output rounded to bfloat16) — their plain
versions on the CPU, which round where the reference rounds — against the
Pallas kernels in interpret mode, at the tolerances of tests/test_pallas.py
(:1200, :1354, :1382, :1458); the rounding points themselves; the robust
route and the storage ``policy.py`` names for it and for the study sweeps,
and the CLI and the sweeps that take them. All in float32 (the storage
modes round from float32), inputs from a numpy seed. The ``cuda``-marked
cases hold the kernels against their plain versions on the card and skip
without one:

    python -m pytest --noconftest -m cuda tests/test_torch_compact_robust.py
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
ANISO = np.diag([1.3, 0.8, 1.1]) ** 2
SHAPE = (32, 16, 16)
BF16 = torch.bfloat16
COMPACT = {"precision": "high3", "compact_dirs": True}


def _jax(module):
    """A module of the JAX package (skips where jax is absent)."""
    return pytest.importorskip("nsol_tpu." + module)


def _jnp():
    return pytest.importorskip("jax.numpy")


def _t(a, device="cpu"):
    return interop.to_torch(np.asarray(a, np.float32), device)


def _np(t):
    return t.float().cpu().numpy().astype(np.float64)


def _problem(seed, shape, cov, noise=0.05):
    """``A·(rand > 0.6)`` (wrap blur) plus Gaussian noise, float32."""
    rng = np.random.RandomState(seed)
    kern = gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(len(shape)))
    x_true = (rng.rand(*shape) > 0.6).astype(np.float64)
    b = ndi.convolve(x_true, kern, mode="wrap")
    return (b + noise * rng.randn(*shape)).astype(np.float32)


def _max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16_ulp(v):
    """One bf16 ulp at |v| (2^(e − 8) for |v| in [2^(e−1), 2^e))."""
    _, e = np.frexp(np.asarray(v, np.float64))
    return np.ldexp(1.0, e - 8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


# ------------------------------------------------ (a)-(d): against JAX --

def test_fused_robust_compact_dirs_matches_pallas():
    """(a) The fused robust solve with ``compact_dirs=True`` at
    tests/test_pallas.py:1354's shape and depth (64², huber, 4 × 3 × 4):
    within 1e-4 · max |x| of the Pallas kernel's compact solve; the
    rounding shows (it differs from the exact solve)."""
    shape, cov = (64, 64), np.eye(2)
    b = _problem(1, shape, cov)
    kw = dict(iterations=4, iter_max=3, data_loss="huber", irls_cg_iters=4)
    want = np.asarray(_jax("ops.pallas.fused").make_fused_admm_solver(
        shape, cov, interpret=True, **kw, **COMPACT)(
            b, b, 0.01, 0.5, data_loss_scale=1.0), np.float64)
    got = _np(F.make_fused_admm_solver(shape, cov, **kw, **COMPACT)(
        _t(b), _t(b), 0.01, 0.5))
    exact = _np(F.make_fused_admm_solver(shape, cov, **kw)(
        _t(b), _t(b), 0.01, 0.5))
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert not np.array_equal(got, exact)


def test_blocked_robust_compact_dirs_matches_pallas():
    """(b) ``blocked_robust_admm_solve(compact_dirs=True)`` at
    tests/test_pallas.py:1458's anisotropic (32, 16, 16), 3 × 3 × 4:
    within 5e-4 · max |x| of the JAX compact solve."""
    b = _problem(2, SHAPE, ANISO, noise=0.0)
    kw = dict(iterations=3, iter_max=3, irls_cg_iters=4, data_loss="huber",
              compact_dirs=True)
    want = np.asarray(_jax("ops.pallas.robust").blocked_robust_admm_solve(
        SHAPE, ANISO, interpret=True, **kw)(b, b, 0.01, 0.5), np.float64)
    solve = R.blocked_robust_admm_solve(SHAPE, ANISO, **kw)
    assert (solve.tiled, solve.storage) == (False, "io")
    got = _np(solve(_t(b), _t(b), 0.01, 0.5))
    assert np.abs(got - want).max() <= 5e-4 * np.abs(want).max()


@pytest.mark.parametrize("form,cov", [("1d", ISO), ("2d", ISO),
                                      ("2d", np.diag([0.8, 1.2, 0.9]) ** 2)])
def test_weighted_normal_operators_bf16_io_match_pallas(form, cov):
    """(c) The weighted normal operators with ``io_dtype=bfloat16`` at
    (32, 16, 16) with small explicit blocks (tests/test_pallas.py:1382):
    bfloat16 out, within one bf16 ulp of the JAX output plus
    1e-5 · max |out|."""
    jnp = _jnp()
    JR = _jax("ops.pallas.robust")
    rng = np.random.RandomState(3)
    v = rng.rand(*SHAPE).astype(np.float32)
    w = (rng.rand(*SHAPE) * 0.9 + 0.1).astype(np.float32)
    if form == "1d":
        ap = JR.make_blocked_weighted_normal_operator(
            SHAPE, cov, block=8, interpret=True, io_dtype=jnp.bfloat16)
        port = R.make_blocked_weighted_normal_operator(SHAPE, cov,
                                                       io_dtype=BF16)
    else:
        ap = JR.make_blocked_weighted_normal_operator_2d(
            SHAPE, cov, z_block=8, y_block=8, interpret=True,
            io_dtype=jnp.bfloat16)
        port = R.make_blocked_weighted_normal_operator_2d(
            SHAPE, cov, z_block=8, y_block=8, io_dtype="bfloat16")
    want = np.asarray(ap(v, w, 0.7).astype(jnp.float32), np.float64)
    got = port(_t(v), _t(w), 0.7)
    assert got.dtype == BF16
    band = _bf16_ulp(want) + 1e-5 * np.abs(want).max()
    assert np.all(np.abs(_np(got) - want) <= band)


@pytest.mark.parametrize("reg", ["TK0", "TK1"])
@pytest.mark.parametrize("loss", ["linear", "huber"])
def test_fused_tikhonov_compact_dirs_matches_pallas(reg, loss):
    """(d) ``make_fused_tikhonov_solver(compact_dirs=True,
    precision="high3")``, TK0/TK1 × linear/huber, at the configuration of
    the JAX package's Tikhonov kernel test (tests/test_pallas.py:829: 16³,
    6 CG or 6 sweeps × 5 CG, α 0.05, C 2): within 5e-4 · max |x| of the
    Pallas kernel's compact solve (the band of tests/test_pallas.py:1200).
    The batch of α is the kernel's."""
    shape = (16, 16, 16)
    b = _problem(4, shape, ISO, noise=0.0)
    kw = dict(reg=reg, iter_max=6, data_loss=loss, irls_cg_iters=5)
    want = np.asarray(_jax("ops.pallas.fused").make_fused_tikhonov_solver(
        shape, ISO, interpret=True, **kw, **COMPACT)(
            b, b, 0.05, data_loss_scale=2.0), np.float64)
    solve = T.make_fused_tikhonov_solver(shape, ISO, **kw, **COMPACT)
    got = _np(solve(_t(b), _t(b), [0.05, 0.05], 2.0))
    for k in range(2):
        assert np.abs(got[k] - want).max() <= 5e-4 * np.abs(want).max()


# ----------------------------------------------- (e): rounding points --

@pytest.mark.parametrize("storage", ["dirs", "io"])
def test_weighted_apply_rounds_at_the_reference_points(storage):
    """(e) The plain masked apply: p' = bf16(r + β·p), the product and the
    sum each rounded as the reference forms them, stored so; pq from the
    rounded p'; "dirs" applies the float32 weights and keeps q float32;
    "io" applies bf16(weights) and rounds the core before
    q = free·core + (p' − pf), so q holds bfloat16 values."""
    rng = np.random.RandomState(5)
    st = B.Stencils.from_cov(ANISO, 3, (1.0, 1.5, 0.8))
    r, p, wts = (_t(rng.rand(*SHAPE) - 0.5) for _ in range(3))
    wts = wts.abs() + 0.1
    free = _t(rng.rand(*SHAPE) > 0.3)
    scal = B.new_scalars("cpu")
    scal[B.GAMMA], scal[B.BETA] = 3.0, 0.83
    pb = p.to(BF16)
    p_new, q = R.weighted_apply(r, pb, free, wts, scal, st.blur, st.inv_h2,
                                0.5, storage=storage)
    d = r + torch.tensor(0.83, dtype=torch.float32) * pb.float()
    assert p_new.dtype == BF16 and torch.equal(p_new, d.to(BF16))
    pw = p_new.float()
    w = wts.to(BF16).float() if storage == "io" else wts
    core = B._blur_plain(w * B._blur_plain(free * pw, st.blur), st.blur) \
        + 0.5 * B.reg_normal_plain(free * pw, st.inv_h2)
    if storage == "io":
        core = core.to(BF16).float()
    want = free * core + (pw - free * pw)
    assert q.dtype == torch.float32 and torch.equal(q, want)
    assert torch.equal(q.to(BF16).float(), q) == (storage == "io")
    assert float(scal[B.PQ]) == pytest.approx(float(torch.sum(pw * q)),
                                              rel=1e-6)
    # the first trip rounds r itself
    p0, _ = R.weighted_apply(r, None, free, wts, scal, st.blur, st.inv_h2,
                             0.5, first=True, storage=storage)
    assert torch.equal(p0, r.to(BF16))


@pytest.mark.parametrize("build,storage", [
    (functools.partial(F.make_fused_admm_solver, (12, 10, 9), ISO,
                       data_loss="huber", **COMPACT), "dirs"),
    (functools.partial(R.blocked_robust_admm_solve, (12, 10, 9), ISO,
                       data_loss="huber", compact_dirs=True), "io")])
def test_compact_robust_solves_round_only_the_inner_cg(build, storage):
    """(e) Each compact robust solve rounds only the inner CG: the IRLS
    head (r = A x − b, the weights), the gradient with the float32 weights
    and the step see float32; each apply takes the storage mode and the
    update a bfloat16 direction and a float32 q. And the storage changes
    the result (it differs from the exact solve)."""
    seen = {}
    units = list(R.PLAIN)

    def spy(k, fn):
        def unit(*args, **kwargs):
            seen.setdefault(k, set()).update(
                (a.dtype for a in args if isinstance(a, torch.Tensor)))
            if k == "apply":
                seen.setdefault("mode", set()).add(kwargs.get("storage"))
            return fn(*args, **kwargs)
        return unit

    spied = tuple(spy(k, f) for k, f in zip(
        ("grad", "head", "apply", "step", "update"), units))
    b = _t(_problem(6, (12, 10, 9), ISO))
    solve = build(iterations=2, iter_max=2, irls_cg_iters=3)
    st = B.Stencils.from_cov(ISO, 3)
    x, _, _ = R._robust_steps(spied, st, b, b, 0.01, 0.5, 2, 2, 3, "huber",
                              1.0, storage=storage)
    assert seen["head"] == seen["grad"] == seen["step"] == {torch.float32}
    assert seen["mode"] == {storage}
    assert seen["update"] == {torch.float32, BF16, torch.float64}
    assert torch.equal(x, solve(b, b, 0.01, 0.5))
    exact = build(iterations=2, iter_max=2, irls_cg_iters=3,
                  **{"compact_dirs": False})
    assert not torch.equal(x, exact(b, b, 0.01, 0.5))


def test_tikhonov_compact_rounds_the_directions():
    """(e) The Tikhonov compact solve's linear CG runs ``cg_step`` in the
    storage mode "qf32" (p' bf16, q float32) and its IRLS sweep the masked
    apply in "dirs"; its result differs from the exact one."""
    b = _t(_problem(7, (16, 14), np.eye(2)))
    for loss, unit in (("linear", B.cg_step_plain),
                       ("huber", R.weighted_apply_plain)):
        solve = T.make_fused_tikhonov_solver((16, 14), np.eye(2),
                                             iter_max=3, data_loss=loss,
                                             irls_cg_iters=3, **COMPACT)
        exact = T.make_fused_tikhonov_solver((16, 14), np.eye(2),
                                             iter_max=3, data_loss=loss,
                                             irls_cg_iters=3)
        calls = unit.calls
        got = solve(b, b, 0.1)
        assert unit.calls > calls
        assert not torch.equal(got, exact(b, b, 0.1))
    steps = []
    orig = B.cg_step_plain

    def spy(*args, **kwargs):
        steps.append((args[1] is None or args[1].dtype, kwargs["storage"]))
        return orig(*args, **kwargs)

    units = (T.tik_clip_plain, (B.normal_apply_plain, spy,
                                B.cg_update_plain), R.PLAIN)
    st = B.Stencils.from_cov(np.eye(2), 3, None)
    T._tik_steps(units, st, b, b, [0.1], [1.0], "TK1", "linear", 3, 3,
                 compact=True)
    assert steps == [(True, "qf32"), (BF16, "qf32"), (BF16, "qf32")]


# -------------------------------------------------------- (f): guards --

def test_compact_dirs_needs_high3_and_a_bool():
    """(f) As in the reference (fused.py:480-481, :783), the fused
    solves' ``compact_dirs`` needs ``precision="high3"``; the robust
    solves take it True or False only."""
    for build in (
            lambda **kw: F.make_fused_admm_solver((8, 8), np.eye(2),
                                                  data_loss="huber", **kw),
            lambda **kw: T.make_fused_tikhonov_solver((8, 8), np.eye(2),
                                                      **kw)):
        with pytest.raises(ValueError, match="high3"):
            build(compact_dirs=True)
        with pytest.raises(ValueError, match="True or False"):
            build(compact_dirs="qf32", precision="high3")
        build(compact_dirs=True, precision="high3")
    with pytest.raises(ValueError, match="True or False"):
        R.blocked_robust_admm_solve((8, 8, 8), ISO, compact_dirs="qf32")


# ----------------------------------------------------- route and policy --

@pytest.mark.parametrize("shape,route", [
    ((64, 64, 64), ("fused", None)), ((128, 128, 128), ("blocked", None)),
    ((256, 256, 256), ("blocked", None)), ((64, 512, 512), ("blocked", None)),
    ((1024, 1024), ("fused", None)), ((2048, 2048), ("fused", None))])
def test_policy_robust_route_matches_the_reference_cli(shape, route):
    """The robust route of nsol_tpu/cli/run_deconvolution.py:141-190: the
    fused solve where ``fused_admm_fits_vmem`` holds, the blocked robust
    solve for every 3-D volume past it (128³ and 256³ too, which the port
    took fused before), and a 2-D image past it on the fused route in
    exact f32."""
    cov = np.eye(len(shape))
    assert policy.pick_route(shape, cov, data_loss="huber") == route
    if len(shape) == 3 and shape[2] <= 64:
        assert _jax("ops.pallas.fused").fused_admm_fits_vmem(shape) \
            == (route[0] == "fused")
    build, kw = policy.tvl2_solver(shape, cov, None, "cuda", 2, 2, "huber",
                                   3, env={})
    assert build is (F.make_fused_admm_solver if route[0] == "fused"
                     else R.blocked_robust_admm_solve)
    assert (kw["data_loss"], kw["irls_cg_iters"]) == ("huber", 3)


def test_policy_robust_and_sweep_storage():
    """On cuda the robust route's storage is the reference CLI's
    (``high3`` + ``compact_dirs`` fused, ``compact_dirs`` blocked) and the
    sweeps' its ``fast_kw``; ``{}`` on the CPU, with NSOL_TPU_EXACT == "1"
    (not "0", R2), for a 2-D image past the fused limit, and for a sweep
    past it; NSOL_TPU_COMPACT means nothing on the robust route."""
    so = functools.partial(policy.storage_options, data_loss="huber")
    cube, big, big2d = (64, 64, 64), (128, 128, 128), (2048, 2048)
    for env in ({}, {"NSOL_TPU_EXACT": "0"}, {"NSOL_TPU_COMPACT": "1"},
                {"NSOL_TPU_EXACT": "true"}):
        assert so("fused", cube, "cuda", env) == COMPACT
        assert so("blocked", big, "cuda:0", env) == {"compact_dirs": True}
        assert policy.sweep_options((256, 256), "cuda", env) == COMPACT
    exact = {"NSOL_TPU_EXACT": "1"}
    for route, shape in (("fused", cube), ("blocked", big)):
        assert so(route, shape, "cuda", exact) == {}
        assert so(route, shape, "cpu", {}) == {}
    assert so("fused", big2d, "cuda", {}) == {}
    assert policy.sweep_options((256, 256), "cuda", exact) == {}
    assert policy.sweep_options((256, 256), torch.device("cpu"), {}) == {}
    assert policy.sweep_options((256,) * 3, "cuda", {}) == {}


@pytest.mark.parametrize("shape", [(16, 14, 12), (24, 20)])
def test_policy_robust_choice_runs_the_compact_solve(shape):
    """The cuda choice's factory and options, run on CPU tensors, equal
    the compact library solve bit for bit."""
    cov = np.eye(len(shape))
    b = _t(_problem(8, shape, cov))
    build, kw = policy.tvl2_solver(shape, cov, None, "cuda", 2, 2, "huber",
                                   3, env={})
    want = F.make_fused_admm_solver(shape, cov, iterations=2, iter_max=2,
                                    data_loss="huber", irls_cg_iters=3,
                                    **COMPACT)(b, b, 0.01, 0.5)
    assert torch.equal(build(**kw)(b, b, 0.01, 0.5, data_loss_scale=1.0),
                       want)
    build, kw = policy.tvl2_solver((128, 128, 128), np.eye(3), None, "cuda",
                                   2, 2, "huber", 3, env={})
    assert build(**kw).storage == "io"


def test_cli_huber_cpu_stays_exact(tmp_path, monkeypatch):
    """``run_deconvolution --data-loss huber --device cpu`` on a 16³ NIfTI
    runs the exact fused robust solve, whatever the environment switches
    say, and equals the library's."""
    from nsol_tpu_torch.cli import run_deconvolution
    from nsol_tpu_torch.io import read_nifti, write_nifti

    monkeypatch.setenv("NSOL_TPU_EXACT", "0")
    shape = (16, 16, 16)
    obs, out = str(tmp_path / "b.nii.gz"), str(tmp_path / "x.nii.gz")
    write_nifti(200.0 * _problem(9, shape, ISO), obs, spacing=np.ones(3))
    assert run_deconvolution.main([
        "--observation", obs, "--result", out, "--solver", "ADMM",
        "--reconstruction-type", "TVL2", "--data-loss", "huber",
        "--iterations", "2", "--iter-max", "2", "--irls-cg-iters", "3",
        "--device", "cpu"]) == 0
    b = read_nifti(obs).data.astype(np.float64)
    bs = _t(b / b.max())
    lib = F.make_fused_admm_solver(shape, ISO, iterations=2, iter_max=2,
                                   data_loss="huber", irls_cg_iters=3)(
        bs, bs, 0.01, 0.5)
    np.testing.assert_allclose(read_nifti(out).data, _np(lib) * b.max(),
                               rtol=1e-6, atol=1e-6 * b.max())


def _sweep_solver(kind, img):
    from nsol_tpu_torch.ops import conv as C
    from nsol_tpu_torch.ops import grad as G
    from nsol_tpu_torch.solvers.wrappers import (ADMMLinearSolver,
                                                 TikhonovLinearSolver)

    A, _ = C.make_blur_operators(np.eye(2), alpha_cut=3)
    D, Dt = G.make_gradient_operators(None)
    common = dict(x_scale=float(img.max()), minimizer="auto", iter_max=2,
                  irls_cg_iters=3, blur_cov=np.eye(2), spacing=np.ones(2),
                  data_loss="huber", device="cpu")
    if kind == "tik":
        return TikhonovLinearSolver(A, A, img, D, Dt, img, reg_kind="TK1",
                                    **common)
    return ADMMLinearSolver(A, A, img, D, Dt, img, iterations=2, **common)


@pytest.mark.parametrize("kind", ["tik", "admm"])
def test_sweeps_build_with_the_sweep_policy(kind, monkeypatch):
    """``run_sweep`` builds its fused solves with ``policy.sweep_options``
    (the reference's ``fast_kw``), which is part of the solver cache's key:
    under the cuda choice the sweep equals the compact library solves, and
    the same solver back on the CPU choice the exact ones."""
    img = 100.0 * _problem(10, (20, 18), np.eye(2)).astype(np.float64)
    solver = _sweep_solver(kind, img)
    b = _t(np.asarray(img, np.float32) / float(img.max()))  # as it scales b
    alphas = np.array([0.02, 0.2])
    kw = dict(iter_max=2, data_loss="huber", irls_cg_iters=3)
    if kind == "tik":
        lib = functools.partial(T.make_fused_tikhonov_solver, (20, 18),
                                np.eye(2), reg="TK1", **kw)
        run = lambda s: s(b, b, list(alphas), 1.0)  # noqa: E731
    else:
        lib = functools.partial(F.make_fused_admm_solver, (20, 18), np.eye(2),
                                iterations=2, **kw)
        run = lambda s: torch.stack([s(b, b, a, 0.5)  # noqa: E731
                                     for a in alphas])
    params = {"alpha": alphas} if kind == "tik" else \
        {"alpha": alphas, "rho": np.full(2, 0.5)}
    for options in (COMPACT, {}):
        monkeypatch.setattr(policy, "sweep_options",
                            lambda shape, device, o=options: dict(o))
        x_all, _ = solver.run_sweep(params)
        want = _np(run(lib(**options))) * img.max()
        np.testing.assert_allclose(x_all, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
        if options:
            compact = x_all
    assert not np.array_equal(compact, x_all)


def test_study_cli_reaches_the_sweep_policy(tmp_path, monkeypatch):
    """``run_deconvolution_study`` reaches the sweeps' storage through
    ``run_sweep``: the policy is asked for the image's shape and device,
    and its answer changes the study's records."""
    from nsol_tpu_torch.cli import run_deconvolution_study as study_cli
    from nsol_tpu_torch.io import write_png

    img = np.round(200.0 * _problem(11, (24, 20), np.eye(2), noise=0.0))
    obs = str(tmp_path / "b.png")
    write_png(np.clip(img, 0, 255).astype(np.uint8), obs)
    asked, recs = [], {}
    for options in (COMPACT, {}):
        def sweep_options(shape, device, o=options):
            asked.append((tuple(shape), str(device)))
            return dict(o)

        monkeypatch.setattr(policy, "sweep_options", sweep_options)
        out = tmp_path / ("study%d" % len(recs))
        assert study_cli.main(["--observation", obs,
                               "--reconstruction-type", "TK1L2",
                               "--iter-max", "3", "--alpha-range", "0.01",
                               "0.05", "2", "--study-name", "s",
                               "--dir-output", str(out),
                               "--device", "cpu"]) == 0
        recs[bool(options)] = np.loadtxt(str(out / "s_measure_Reg.txt"))
    assert set(asked) == {((24, 20), "cpu")}
    assert not np.array_equal(recs[True], recs[False])


# ---------------------------------------------------------- on the card --

def _chip_smoke():
    """``chip_smoke.py``, whose phase 29 builds the unit/plain pairs."""
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
def test_cuda_robust_storage_units_match_plain_on_card(cuda_device, shape):
    """Every storage-typed robust unit against its plain version: float32
    outputs and the dots within 1e-5 · max |ref|, bfloat16 ones within one
    bf16 ulp."""
    cs = _chip_smoke()
    st = B.Stencils.from_cov(ANISO, 3, (1.0, 1.5, 0.8), cuda_device)
    pairs = cs.robust_compact_pairs(st, shape, cuda_device,
                                    np.random.RandomState(12))
    assert cs.compact_pairs_err(pairs) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,storage", [((24, 40, 36), "dirs"),
                                           ((48, 40), "dirs"),
                                           ((24, 40, 36), "io"),
                                           ((16, 512, 40), "io")])
def test_cuda_compact_robust_solves_match_plain_on_card(cuda_device, shape,
                                                        storage):
    """Each compact robust solve (fused "dirs", blocked "io" per-axis and
    tiled) against its plain version within its storage's bands
    (``chip_smoke.compact_gaps_ok``)."""
    cs = _chip_smoke()
    cov = np.eye(len(shape))
    b = _t(_problem(13, shape, cov), cuda_device)
    if storage == "dirs":
        factory = functools.partial(F.make_fused_admm_solver, shape, cov,
                                    iter_max=2, data_loss="huber",
                                    irls_cg_iters=4)
        kw = COMPACT
    else:
        factory = functools.partial(R.blocked_robust_admm_solve, shape, cov,
                                    iter_max=2, irls_cg_iters=4)
        kw = {"compact_dirs": True}
        assert factory(**kw).tiled == (shape[1] == 512)
    F.reset_counts()
    factory(iterations=2, **kw)(b, b, 0.01, 0.5)
    assert set(F.plain_counts().values()) == {0}
    A64 = functools.partial(ndi.convolve, weights=gaussian_kernel(
        cov, alpha_cut=3), mode="wrap")

    def objective(x):
        xn, bn = _np(x), _np(b)
        r = A64(xn) - bn
        hub = np.where(r * r <= 1, r * r, 2 * np.sqrt(np.abs(r * r)) - 1)
        g = [np.diff(xn, axis=ax, append=0.0 * xn.take([0], axis=ax))
             for ax in range(xn.ndim)]
        return 0.5 * hub.sum() + 0.01 * np.sqrt(sum(c * c for c in g)).sum()

    gaps = cs.compact_plain_gaps(factory, kw, b, objective, 2,
                                 cs.ROBUST_SHORT)
    assert cs.compact_gaps_ok(gaps, kw, storage), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("reg", ["TK0", "TK1"])
@pytest.mark.parametrize("loss", ["linear", "huber"])
def test_cuda_tikhonov_compact_matches_plain_on_card(cuda_device, reg, loss):
    """The Tikhonov compact solve (one C call over a batch of α) against
    its plain unit sequence: each voxel within 1e-3 · max |x|."""
    b = _t(_problem(14, (37, 53), np.eye(2)), cuda_device)
    solve = T.make_fused_tikhonov_solver((37, 53), np.eye(2), reg=reg,
                                         iter_max=4, data_loss=loss,
                                         irls_cg_iters=3, **COMPACT)
    F.reset_counts()
    xk = solve(b, b, [0.02, 0.3], 0.7)
    assert set(F.plain_counts().values()) == {0}
    xp = solve.plain(b, b, [0.02, 0.3], 0.7)
    assert float((xk - xp).abs().max() / xp.abs().max()) <= 1e-3
