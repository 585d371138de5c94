"""The port's fused CG sweep (K8) against the JAX package.

The plain version of ``cg_sweep`` (the sweep kernel's arithmetic on the
CPU) against ``make_blocked_cg_sweep`` in interpret mode, and
``blocked_admm_solve(mode="sweep")`` in float32 and in bfloat16 state
against the JAX sweep, the XLA solve and the float32 "step", at the
tolerances of tests/test_pallas.py (:544-556, :421-435, :1166-1196); the
rules that route the sweep to its march (``csrc/sweep_march.cu``) and size
its block and z tile, through their Python mirrors. The ``cuda``-marked
cases hold the kernel against its plain version and the march against
the three-pass chain on the card, and skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_sweep.py
"""

import functools

import numpy as np
import pytest
import scipy.ndimage as ndi

torch = pytest.importorskip("torch")

from nsol_tpu_torch import interop  # noqa: E402
from nsol_tpu_torch.ops.kernels import gaussian_kernel  # noqa: E402
from nsol_tpu_torch.ops.cuda import blocked as B  # noqa: E402
from nsol_tpu_torch.ops.cuda import fused as F  # noqa: E402
from nsol_tpu_torch.ops.cuda import tiled as T  # noqa: E402

ISO = np.diag([1.0, 1.0, 1.0])
CUBE = (16, 16, 16)


def _jax(module):
    """A module of the JAX package (skips where jax is absent)."""
    return pytest.importorskip("nsol_tpu." + module)


def _t(a, device="cpu", dtype=torch.float32):
    return interop.to_torch(np.asarray(a, np.float32), device).to(dtype)


def _np(t):
    return t.float().cpu().numpy().astype(np.float64)


def _blurred(seed, shape, cov=ISO, spacing=None):
    rng = np.random.RandomState(seed)
    kern = gaussian_kernel(cov, alpha_cut=3, spacing=spacing)
    x_true = (rng.rand(*shape) > 0.6).astype(np.float64)
    return ndi.convolve(x_true, kern, mode="wrap").astype(np.float32)


def _objective(x, b, cov=ISO, alpha=0.01):
    """½‖Ax − b‖² + α·TV(x) in float64 (the reference's objective)."""
    x = np.asarray(x, np.float64)
    kern = gaussian_kernel(cov, alpha_cut=3)
    r = ndi.convolve(x, kern, mode="wrap") - b
    g = [np.diff(x, axis=ax, append=0.0 * x.take([0], axis=ax))
         for ax in range(x.ndim)]
    return 0.5 * np.sum(r * r) + alpha * np.sum(np.sqrt(sum(c * c for c in g)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


# ------------------------------------------------------------ the unit --

@pytest.mark.parametrize("a,beta,rho", [(0.0, 0.0, 0.5), (0.37, 0.83, 1.9)])
def test_sweep_plain_matches_pallas(a, beta, rho):
    """``make_blocked_cg_sweep``: the plain ``cg_sweep`` against the Pallas
    kernel in interpret mode at 16³ — iterates atol 1e-6, q atol 2e-5 /
    rtol 1e-5, the four dots rtol 1e-4 (tests/test_pallas.py:544-556)."""
    rng = np.random.RandomState(5)
    x, r, p, q = (rng.rand(*CUBE).astype(np.float32) for _ in range(4))
    want = _jax("ops.pallas.blocked").make_blocked_cg_sweep(
        CUBE, ISO, block=8, interpret=True)(x, r, p, q, a, beta, rho)
    F.reset_counts()
    got = B.make_blocked_cg_sweep(CUBE, ISO)(
        _t(x), _t(r), _t(p), _t(q), a, beta, rho)
    assert F.plain_counts(F.SWEEP_UNITS) == {"cg_sweep_plain": 1}
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float64)
        if k in (0, 1, 3):  # x', r', p'
            np.testing.assert_allclose(_np(g), w, atol=1e-6)
        elif k == 2:  # q'
            np.testing.assert_allclose(_np(g), w, atol=2e-5, rtol=1e-5)
        else:  # g, pq, rq, qq
            np.testing.assert_allclose(float(g), float(w), rtol=1e-4)


@pytest.mark.parametrize("io", [None, "bfloat16"])
def test_sweep_builder_leaves_q_and_returns_q_new(io):
    """``make_blocked_cg_sweep`` returns q' in a tensor of its own and
    leaves the q it was given as it was (the kernels write q' into a
    second volume); q' against the Pallas kernel in interpret mode at the
    tolerances of test_sweep_plain_matches_pallas and
    test_sweep_plain_bf16_matches_pallas, on their kind of draw."""
    rng = np.random.RandomState(12)  # test_sweep_plain_*'s draw
    x, r, p, q = (rng.rand(*CUBE).astype(np.float32) for _ in range(4))
    kw = {} if io is None else {"io_dtype": io}
    want = _jax("ops.pallas.blocked").make_blocked_cg_sweep(
        CUBE, ISO, block=8, interpret=True, **kw)(x, r, p, q, 0.37, 0.83, 1.9)
    qt = _t(q)
    kept = qt.clone()
    got = B.make_blocked_cg_sweep(
        CUBE, ISO, **({} if io is None else {"io_dtype": torch.bfloat16}))(
            _t(x), _t(r), _t(p), qt, 0.37, 0.83, 1.9)
    assert torch.equal(qt, kept)
    assert got[2].data_ptr() != qt.data_ptr()
    w = np.asarray(np.asarray(want[2]).astype(np.float32), np.float64)
    if io is None:
        np.testing.assert_allclose(_np(got[2]), w, atol=2e-5, rtol=1e-5)
    else:
        assert got[2].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got[2]), w, rtol=2 ** -7, atol=1e-6)


def test_sweep_plain_bf16_matches_pallas():
    """``io_dtype=bfloat16``: r', p', q' stored in bfloat16 by the same
    rounding (to nearest even) at the same points; the dots in float32 from
    the unrounded r', q' and the rounded p'. Stored vectors within one
    bf16 ulp, dots rtol 1e-4."""
    rng = np.random.RandomState(6)
    x, r, p, q = (rng.rand(*CUBE).astype(np.float32) for _ in range(4))
    import jax.numpy as jnp

    want = _jax("ops.pallas.blocked").make_blocked_cg_sweep(
        CUBE, ISO, block=8, interpret=True, io_dtype=jnp.bfloat16)(
            x, r, p, q, 0.37, 0.83, 1.9)
    got = B.make_blocked_cg_sweep(CUBE, ISO, io_dtype=torch.bfloat16)(
        _t(x), _t(r), _t(p), _t(q), 0.37, 0.83, 1.9)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), atol=1e-6)
    for k in (1, 2, 3):
        assert got[k].dtype == torch.bfloat16
        w = np.asarray(want[k].astype(jnp.float32), np.float64)
        np.testing.assert_allclose(_np(got[k]), w, rtol=2 ** -7, atol=1e-6)
    for k in range(4, 8):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4)


# ------------------------------------------------------------ the solve --

def test_blocked_sweep_solve_matches_pallas_and_xla():
    """``blocked_admm_solve(mode="sweep")`` at 16³, 4 × 5: the iterate
    within atol 2e-3 / rtol 1e-3 of the JAX sweep and of the XLA solve,
    the objective within rtol 1e-4 (tests/test_pallas.py:421-435)."""
    b = _blurred(7, CUBE)
    JB = _jax("ops.pallas.blocked")
    want_sw = np.asarray(JB.blocked_admm_solve(
        CUBE, ISO, iterations=4, iter_max=5, block=8, interpret=True,
        mode="sweep")(b, b, 0.01, 0.5))
    want_xla = np.asarray(_jax("ops.pallas.fused").make_fused_admm_solver(
        CUBE, ISO, iterations=4, iter_max=5, interpret=True)(b, b, 0.01, 0.5))
    F.reset_counts()
    solve = B.blocked_admm_solve(CUBE, ISO, iterations=4, iter_max=5,
                                 mode="sweep")
    assert (solve.mode, solve.storage) == ("sweep", "exact")
    got = _np(solve(_t(b), _t(b), 0.01, 0.5))
    calls = F.plain_counts(F.ADMM_UNITS + F.SWEEP_UNITS)
    assert calls["cg_sweep_plain"] == 4 * 5
    assert calls["cg_update_plain"] == 4  # the owed x += a·p' alone
    assert calls["cg_step_plain"] == 0
    for want in (want_sw, want_xla):
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(_objective(got, b), _objective(want, b),
                                   rtol=1e-4)


def test_blocked_sweep_bf16_state_matches_pallas_and_step():
    """``mode="sweep", state_dtype=bfloat16`` at (32, 16, 16), 6 × 6: the
    objective within 1e-3 of the JAX bf16 sweep and of the f32 "step"
    (tests/test_pallas.py:1166-1196)."""
    import jax.numpy as jnp

    shape = (32, 16, 16)
    b = _blurred(8, shape)
    want = np.asarray(_jax("ops.pallas.blocked").blocked_admm_solve(
        shape, ISO, iterations=6, iter_max=6, interpret=True, mode="sweep",
        state_dtype=jnp.bfloat16)(b, b, 0.01, 0.5))
    solve = B.blocked_admm_solve(shape, ISO, iterations=6, iter_max=6,
                                 mode="sweep", state_dtype=torch.bfloat16)
    assert solve.storage == "state"
    got = _np(solve(_t(b), _t(b), 0.01, 0.5))
    step = _np(B.blocked_admm_solve(shape, ISO, iterations=6, iter_max=6,
                                    mode="step")(_t(b), _t(b), 0.01, 0.5))
    o = _objective(got, b)
    for ref in (want, step):
        assert abs(o - _objective(ref, b)) <= 1e-3 * _objective(ref, b)


#: (g, pq, rq, qq): finite; NaN dots beside a finite g (a NaN in p); a NaN
#: g; γ' below 0; an infinite qq
SWEEP_DOTS = {"finite": (2.0, 0.5, 0.3, 0.4),
              "nan_dots": (2.0, np.nan, np.nan, np.nan),
              "nan_g": (np.nan, 0.5, 0.3, 0.4),
              "negative": (1.0, 1.0, 1.0, 0.0),
              "inf_qq": (1.0, 1.0, 0.0, np.inf)}


@pytest.mark.parametrize("case", list(SWEEP_DOTS))
def test_sweep_scalars_follow_the_reference(case):
    """The plain recurrence against blocked.py:1505-1509 in jnp: NaN where
    jnp.maximum and the guards give NaN (β under NaN dots), equal values
    elsewhere."""
    jnp = pytest.importorskip("jax.numpy")
    g, pq, rq, qq = (jnp.asarray(v) for v in SWEEP_DOTS[case])
    a = jnp.where(pq > 0, g / jnp.where(pq > 0, pq, 1.0), 0.0)
    g_new = jnp.maximum(g - 2.0 * a * rq + a * a * qq, 0.0)
    beta = jnp.where(g > 0, g_new / jnp.where(g > 0, g, 1.0), 0.0)
    scal = B.new_scalars("cpu")
    B._sweep_scalars(scal, *(torch.tensor(v, dtype=torch.float64)
                             for v in SWEEP_DOTS[case]))
    for k, want in ((B.A, a), (B.BETA, beta), (B.GAMMA, g)):
        np.testing.assert_allclose(float(scal[k]), float(want), rtol=1e-6)


def test_sweep_guards_follow_the_reference():
    """compact_dirs excludes the sweep; mode="auto" never picks it; an
    iteration with a = β = 0 on zero p, q equals the first-trip form."""
    for cd in (True, "qf32"):
        with pytest.raises(ValueError, match="sweep"):
            B.blocked_admm_solve(CUBE, ISO, mode="sweep", compact_dirs=cd)
    assert B.blocked_admm_solve(CUBE, ISO).mode == "step"
    st = B.Stencils.from_cov(ISO, 3)
    rng = np.random.RandomState(9)
    x, r = _t(rng.rand(*CUBE)), _t(rng.rand(*CUBE))
    outs = []
    for first in (True, False):
        scal, xs, q = B.new_scalars("cpu"), x.clone(), torch.zeros_like(x)
        outs.append((xs,) + B.cg_sweep(xs, r, torch.zeros_like(x), q, scal,
                                       st.normal, st.inv_h2, 0.5,
                                       first=first) + (q, scal))
    for u, v in zip(*outs):
        assert torch.equal(u, v)


# ------------------------------------------------------------- the route --

#: volumes and the sweep's route at σ = 1 (13 normal taps, 12 halo steps):
#: ``cg_step``'s rule — past 2^20 voxels, at most 2.5 steps a plane a block
#: writes (Z ≥ 8), no 2-D view
SWEEP_ROUTES = [((64, 64, 64), "chain"), ((96, 96, 96), "chain"),
                ((128, 128, 128), "march"), ((256, 256, 256), "march"),
                ((512, 512, 512), "march"), ((136, 240, 200), "march"),
                ((1, 256, 256), "chain"), ((1, 2048, 2048), "chain"),
                ((4, 500, 600), "chain"), ((7, 448, 448), "chain"),
                ((8, 384, 384), "march"), ((16, 512, 512), "march")]


@pytest.mark.parametrize("dims,route", SWEEP_ROUTES)
def test_sweep_route_takes_cg_steps_rule(dims, route):
    """``vol_route("cg_sweep")`` at the normal taps of σ = 1: the march
    past the fused solves' fit on a volume deep enough for its z halo,
    the three passes elsewhere — where ``cg_step``'s rule puts its
    march."""
    assert T.vol_route("cg_sweep", (13, 13, 13), dims) == route
    assert T.vol_route("cg_step", (13, 13, 13), dims) == route
    assert T.VOL_MIN_VOXELS["cg_sweep"] == T.MARCH_MIN_VOXELS
    assert T.VOL_STEPS["cg_sweep"] == T.VOL_STEPS["cg_step"]


def test_sweep_block_holds_three_windows_and_the_r_ring():
    """The sweep's block at the 13 normal taps: three double-buffered
    windows (r, q, p) with bfloat16 margins, the x-blurred rows, the raw
    ring and the r' ring (one tile plane a step of the raw ring): 98928
    bytes in the runtime-length instance the route measures, 72304 in the
    compile-time one (no z ring in shared memory), so three blocks share
    an SM's 228 KB and four do not. The march holds up to 33 normal taps
    (σ 2.6); from 35 (σ 2.7-3.3) the sweep keeps its chain where
    ``cg_step``, two windows, still marches."""
    full = T.smem_bytes((13, 13, 13), nin=3, two_byte=True, res=True)
    ring_z, ring_r = 4 * 13 * T.TILE_Y * T.TILE_X, 4 * 8 * T.TILE_Y * T.TILE_X
    assert full == 98928
    assert full - T.smem_bytes((13, 13, 13), nin=3, two_byte=True) == ring_r
    fixed = full - ring_z
    assert fixed == 72304 and 3 * fixed <= 228 * 1024 < 4 * fixed
    assert T.SWEEP_RESIDENT == 3
    for k, route in ((33, "march"), (35, "chain")):
        assert T.vol_route("cg_sweep", (k,) * 3, (256,) * 3) == route
        assert T.march_fits("cg_sweep", (k,) * 3) == (route == "march")
    assert T.vol_route("cg_step", (41,) * 3, (256,) * 3) == "march"


@pytest.mark.parametrize("dims,tz", [((256, 256, 256), 32),
                                     ((512, 512, 512), 64),
                                     ((136, 240, 200), 64),
                                     ((128, 128, 128), 16)])
def test_sweep_tile_counts_three_blocks_an_sm(dims, tz):
    """The sweep's z tile on an H100 (132 SMs) at three blocks an SM: of
    the candidate tiles, the least (waves of the grid) × (steps a block),
    ties keeping the longer — 32 planes at 256³ (1024 blocks, 3 waves of
    396) where cg_step's four blocks an SM take 64."""
    got = T.tile_z(dims, 13, False, 132, T.SWEEP_RESIDENT)
    assert got == tz
    cols = -(-dims[2] // T.TILE_X) * -(-dims[1] // T.TILE_Y)
    cost = {t: -(-(cols * -(-dims[0] // t)) // (132 * 3))
            * (min(t, dims[0]) + 12) for t in (128, 64, 32, 16, 8)}
    assert cost[got] == min(cost.values())
    assert got == max(t for t in cost if cost[t] == cost[got])
    assert T.tile_z((256,) * 3, 13, False, 132) == 64


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 16, 16), (13, 45, 37)])
def test_cuda_sweep_matches_plain_on_card(cuda_device, shape, dtype):
    """The sweep kernel against its plain version: float32 outputs within
    1e-5 · max |ref|, bfloat16 ones within one bf16 ulp, the dots 1e-5."""
    cs = _chip_smoke()
    st = B.Stencils.from_cov(np.diag([1.3, 0.8, 1.1]) ** 2, 3,
                             (1.0, 1.5, 0.8), cuda_device)
    pairs = cs.sweep_unit_pairs(B, st, shape, cuda_device,
                                np.random.RandomState(3), dtype)
    assert cs.compact_pairs_err(pairs) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("state", [None, torch.bfloat16])
def test_cuda_sweep_solve_matches_plain_on_card(cuda_device, state):
    b = _t(_blurred(10, (24, 40, 36)), cuda_device)
    solve = B.blocked_admm_solve(b.shape, ISO, iterations=3, iter_max=5,
                                 mode="sweep", state_dtype=state)
    F.reset_counts()
    x_k = solve(b, b, 0.01, 0.5)
    launches = F.launch_counts(F.ADMM_UNITS + F.SWEEP_UNITS)
    assert launches["cg_sweep"] == 15 and launches["cg_update"] == 3
    assert launches["cg_step"] == 0
    assert set(F.plain_counts().values()) == {0}
    x_p = solve.plain(b, b, 0.01, 0.5)
    if state is None:
        assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= 1e-4
        return
    # bf16 state: the compact bands (chip_smoke.compact_gaps_ok)
    cs = _chip_smoke()
    kw = dict(mode="sweep", state_dtype=state)
    gaps = cs.compact_plain_gaps(
        functools.partial(B.blocked_admm_solve, b.shape, ISO, iter_max=5),
        kw, b, lambda x: _objective(_np(x), _np(b)), outer=3)
    assert cs.compact_gaps_ok(gaps, kw), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(13, 530, 37), (9, 36, 76), (1, 40, 33),
                                   (136, 240, 200)])
def test_cuda_sweep_march_equals_its_chain_bit_for_bit(cuda_device, shape):
    """Every sweep form (float32 and bf16 state × first trip or not) on
    the march equals the three-pass chain bit for bit (x', r', p', q'),
    the dots, a and β within 1e-12 (chip_smoke.py::sweep_march_bits), and
    a NaN in p lands on the same entries on both routes."""
    cs = _chip_smoke()
    st = B.Stencils.from_cov(ISO, 3, None, cuda_device)
    assert cs.sweep_march_bits(B, st, shape, cuda_device, 45) == 4
    for dtype in (torch.float32, torch.bfloat16):
        cs.sweep_nan_routes(B, st, shape, cuda_device, dtype)


@pytest.mark.cuda
def test_cuda_sweep_refuses_q_over_q_and_a_march_too_wide(cuda_device):
    """The C entry refuses q' over q on the chain and on the march, and a
    march forced past its shared memory raises (no fallback)."""
    st = B.Stencils.from_cov(ISO, 3, None, cuda_device)
    assert _chip_smoke().sweep_refusals(B, st, cuda_device) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_sweep_keeps_nan_on_card(cuda_device, dtype):
    """A NaN in p: the kernel's recurrence gives β = NaN, as its plain
    version and jnp.maximum do (fmax would clip the NaN γ' to 0), and NaN
    at the same entries of every output (chip_smoke.py::sweep_nan_case)."""
    st = B.Stencils.from_cov(ISO, 3, None, cuda_device)
    _chip_smoke().sweep_nan_case(B, st, (13, 45, 37), cuda_device, dtype)
