"""The port's 512-wide-plane scale path against the JAX package.

The one-pass tiled units of ``csrc/tiled.cu`` (their plain versions on the
CPU) against the (z, y)-blocked Pallas kernels in interpret mode, and
``blocked_admm_solve`` / ``blocked_robust_admm_solve`` against the JAX
ones, at the tolerances of tests/test_pallas.py (:918, :943, :996, :1035,
:1382, :1531). The ``cuda``-marked cases hold the kernels against their
plain versions on the card and skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_scale.py
"""

import itertools

import numpy as np
import pytest
import scipy.ndimage as ndi

torch = pytest.importorskip("torch")

from nsol_tpu_torch import interop  # noqa: E402
from nsol_tpu_torch.ops.conv import blur_factors  # noqa: E402
from nsol_tpu_torch.ops.kernels import gaussian_kernel  # noqa: E402
from nsol_tpu_torch.ops.cuda import blocked as B  # noqa: E402
from nsol_tpu_torch.ops.cuda import fused as F  # noqa: E402
from nsol_tpu_torch.ops.cuda import robust as R  # noqa: E402
from nsol_tpu_torch.ops.cuda import tiled as T  # noqa: E402

ISO = np.diag([1.0, 1.0, 1.0])
ANISO = np.diag([1.3, 0.8, 1.1]) ** 2
WIDE = (16, 512, 16)


def _jax(module):
    """A module of the JAX package (skips where jax is absent)."""
    return pytest.importorskip("nsol_tpu." + module)


def _t(a, device="cpu"):
    return interop.to_torch(np.asarray(a, np.float32), device)


def _np(t):
    return interop.to_numpy(t)


def _blurred(seed, shape, cov=ISO, noise=0.0):
    """A blurred random binary volume (wrap blur), plus Gaussian noise."""
    rng = np.random.RandomState(seed)
    kern = gaussian_kernel(cov, alpha_cut=3)
    b = ndi.convolve((rng.rand(*shape) > 0.6).astype(np.float64), kern,
                     mode="wrap")
    return (b + noise * rng.randn(*shape)).astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


# ---------------------------------------------------------------- routing --

@pytest.mark.parametrize("shape,want", [
    ((16, 512, 16), (8, 128)), ((64, 512, 512), (32, 128)),
    ((32, 1024, 64), (16, 128)), ((16, 256, 16), (None, None)),
    ((16, 640, 16), (8, 128)), ((16, 520, 16), (None, None)),
    ((20, 512, 16), (None, None)), ((512, 512), (None, None))])
def test_pick_zy_blocks_matches_jax_criterion(shape, want):
    """The JAX package's pick for f32 (VMEM budget aside: these shapes
    fit it) and the port's agree on the family; the port's route follows."""
    got = B.pick_zy_blocks(shape, 6, 6)
    assert got == want
    if len(shape) == 3 and shape[2] <= 64:
        JB = _jax("ops.pallas.blocked")
        assert JB.pick_zy_blocks(shape, 6, halo_y=6) == want
    assert B.takes_zy_route(shape, ISO) == (want[0] is not None)


# ------------------------------------------------------------ the units --

@pytest.mark.parametrize("shape,spacing", [((16, 32, 16), None),
                                           ((24, 16, 16), (1.0, 1.5, 0.8))])
def test_normal_apply_zy_plain_matches_pallas(shape, spacing):
    """tests/test_pallas.py:918 — z/y blocks 8, atol 2e-5 / rtol 1e-5."""
    v = np.random.RandomState(0).rand(*shape).astype(np.float32)
    want = _jax("ops.pallas.blocked").make_blocked_normal_operator_2d(
        shape, ISO, spacing=spacing, z_block=8, y_block=8,
        interpret=True)(v, 1.3)
    got = B.make_blocked_normal_operator_2d(shape, ISO, spacing=spacing,
                                            z_block=8, y_block=8)(_t(v), 1.3)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


def test_normal_apply_zy_plain_anisotropic_y():
    """tests/test_pallas.py:943 — σ_y > σ_z, y block 16."""
    shape, cov = (16, 32, 16), np.diag([0.64, 4.0, 0.64])
    v = np.random.RandomState(1).rand(*shape).astype(np.float32)
    want = _jax("ops.pallas.blocked").make_blocked_normal_operator_2d(
        shape, cov, z_block=8, y_block=16, interpret=True)(v, 0.7)
    got = B.make_blocked_normal_operator_2d(shape, cov, z_block=8,
                                            y_block=16)(_t(v), 0.7)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


def test_normal_apply_zy_forms_match_the_per_axis_unit():
    """The residual and dot forms, and q itself, equal ``normal_apply``'s
    plain version bit for bit (the same operations), with the scalars."""
    rng = np.random.RandomState(2)
    st = B.Stencils.from_cov(ANISO, 3, (1.25, 0.8, 2.0))
    v, rhs = _t(rng.rand(9, 13, 11)), _t(rng.rand(9, 13, 11))
    assert torch.equal(T.normal_apply_zy(v, st.normal, st.inv_h2, 0.5),
                       B.normal_apply_plain(v, st.normal, st.inv_h2, 0.5))
    s1, s2 = B.new_scalars("cpu"), B.new_scalars("cpu")
    assert torch.equal(
        T.normal_apply_zy(v, st.normal, st.inv_h2, 0.5, rhs=rhs, scal=s1),
        B.normal_apply_plain(v, st.normal, st.inv_h2, 0.5, rhs=rhs, scal=s2))
    assert torch.equal(s1, s2)
    s1[B.GAMMA] = 3.0
    q = T.normal_apply_zy(v, st.normal, st.inv_h2, 0.5, scal=s1)
    pq = float(torch.sum(v * q))
    assert float(s1[B.PQ]) == pytest.approx(pq, rel=1e-6)
    assert float(s1[B.A]) == pytest.approx(3.0 / pq, rel=1e-6)


@pytest.mark.parametrize("beta,rho", [(0.0, 0.5), (0.83, 1.9)])
def test_cg_step_zy_plain_matches_pallas(beta, rho):
    """tests/test_pallas.py:1035 — (16, 512, 16), blocks (8, 128): p' atol
    1e-6; q atol 2e-5 / rtol 1e-5; pq rtol 1e-4."""
    rng = np.random.RandomState(3)
    r = rng.rand(*WIDE).astype(np.float32)
    p = rng.rand(*WIDE).astype(np.float32)
    pn_j, q_j, pq_j = _jax("ops.pallas.blocked").make_blocked_cg_step_2d(
        WIDE, ISO, z_block=8, y_block=128, interpret=True)(r, p, beta, rho)
    pn_t, q_t, pq_t = B.make_blocked_cg_step_2d(
        WIDE, ISO, z_block=8, y_block=128)(_t(r), _t(p), beta, rho)
    np.testing.assert_allclose(_np(pn_t), np.asarray(pn_j), atol=1e-6)
    np.testing.assert_allclose(_np(q_t), np.asarray(q_j), atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(pq_t), float(pq_j), rtol=1e-4)


@pytest.mark.parametrize("cov", [ISO, ANISO], ids=["iso", "aniso"])
def test_weighted_apply_zy_plain_matches_pallas(cov):
    """tests/test_pallas.py:1382 — (32, 16, 16), blocks 8, atol 2e-6."""
    rng = np.random.RandomState(4)
    shape = (32, 16, 16)
    v = rng.rand(*shape).astype(np.float32)
    w = (rng.rand(*shape) * 0.9 + 0.1).astype(np.float32)
    want = _jax("ops.pallas.robust").make_blocked_weighted_normal_operator_2d(
        shape, cov, z_block=8, y_block=8, interpret=True)(v, w, 0.7)
    got = R.make_blocked_weighted_normal_operator_2d(
        shape, cov, z_block=8, y_block=8)(_t(v), _t(w), 0.7)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("cov", [ISO, ANISO], ids=["iso", "aniso"])
@pytest.mark.parametrize("with_lap", [False, True])
def test_blur_apply_zy_plain_matches_pallas(cov, with_lap):
    """tests/test_pallas.py:1531 — (32, 16, 16), blocks 8, atol 2e-6; the
    ``with_lap`` form on a second input at ρ 0.6."""
    rng = np.random.RandomState(5)
    shape = (32, 16, 16)
    y, u = (rng.rand(*shape).astype(np.float32) for _ in range(2))
    kw = dict(z_block=8, y_block=8, with_lap=with_lap)
    jax_op = _jax("ops.pallas.robust").make_blocked_blur_operator_2d(
        shape, cov, interpret=True, **kw)
    op = R.make_blocked_blur_operator_2d(shape, cov, **kw)
    if with_lap:
        want, got = jax_op(y, u, 0.6), op(_t(y), _t(u), 0.6)
    else:
        want, got = jax_op(y), op(_t(y))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-6)


def test_blur_and_weighted_zy_forms_match_the_per_axis_units():
    """The gradient and head forms of ``blur_apply_zy`` and the masked
    ``weighted_apply_zy`` equal the plain ``blur_apply``, ``irls_head`` and
    ``weighted_apply`` bit for bit, scalars included."""
    rng = np.random.RandomState(6)
    shape = (7, 12, 9)
    st = B.Stencils.from_cov(ANISO, 3, (1.25, 0.8, 2.0))
    x, y, r, p = (_t(rng.rand(*shape) - 0.4) for _ in range(4))
    b, wts = _t(rng.rand(*shape)), _t(rng.rand(*shape) + 0.1)
    free = (_t(rng.rand(*shape)) > 0.3).float()
    s1, s2 = B.new_scalars("cpu"), B.new_scalars("cpu")
    got = T.blur_apply_zy(y, st.blur, st.inv_h2, x, 0.5, scal=s1)
    ref = R.blur_apply_plain(y, st.blur, st.inv_h2, x, 0.5, scal=s2)
    assert all(torch.equal(g, q) for g, q in zip(got, ref))
    assert torch.equal(s1, s2)
    for loss in ("huber", "cauchy"):
        got = T.blur_apply_zy(x, st.blur, st.inv_h2, head=(b, loss, 0.3))
        ref = R.irls_head_plain(x, b, st.blur, loss, 0.3)
        assert all(torch.equal(g, q) for g, q in zip(got, ref))
    for first in (True, False):
        s1 = torch.tensor([3.0, 0.0, 0.0, 0.83], dtype=torch.float64)
        s2 = s1.clone()
        got = T.weighted_apply_zy(r, p, free, wts, s1, st.blur, st.inv_h2,
                                  0.5, first=first)
        ref = R.weighted_apply_plain(r, p, free, wts, s2, st.blur, st.inv_h2,
                                     0.5, first=first)
        assert all(torch.equal(g, q) for g, q in zip(got, ref))
        assert torch.equal(s1, s2)
    pk, pp = p.clone(), p.clone()
    T.cg_direction(pk, r, s1)
    pp = r + s1[B.BETA].float() * pp
    assert torch.equal(pk, pp)


def test_explicit_blocks_are_validated_as_in_jax():
    with pytest.raises(ValueError, match="z axis"):
        B.make_blocked_normal_operator_2d((20, 32, 16), ISO, z_block=8,
                                          y_block=8)
    with pytest.raises(ValueError, match="multiple of 8"):
        B.make_blocked_normal_operator_2d((16, 48, 16), ISO, z_block=8,
                                          y_block=12)
    with pytest.raises(ValueError, match="no 2-D block layout"):
        B.make_blocked_cg_step_2d((16, 256, 16), ISO)
    with pytest.raises(ValueError, match="no 2-D block layout"):
        R.make_blocked_weighted_normal_operator_2d((16, 256, 16), ISO)


# ------------------------------------------------------------ the solves --

@pytest.mark.parametrize("mode", ["apply", "step2d", "auto"])
def test_blocked_admm_solve_plain_matches_pallas(mode):
    """tests/test_pallas.py:996 and :1035 — (16, 512, 16), 2 outer × 4 CG,
    against the JAX ``blocked_admm_solve`` of the same mode in interpret
    mode: atol 5e-5 / rtol 1e-4. On the CPU the solve runs the plain
    versions of the tiled units in the C solve's sequence."""
    b = _blurred(7, WIDE)
    want = _jax("ops.pallas.blocked").blocked_admm_solve(
        WIDE, ISO, iterations=2, iter_max=4, interpret=True,
        mode=mode)(b, b, 0.01, 0.5)
    F.reset_counts()
    solve = B.blocked_admm_solve(WIDE, ISO, iterations=2, iter_max=4,
                                 mode=mode)
    got = solve(_t(b), _t(b), 0.01, 0.5)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=5e-5,
                               rtol=1e-4)
    calls = F.plain_counts(F.TILED_UNITS + ("normal_apply", "cg_step"))
    assert calls["blur_apply_zy_plain"] == 1  # Aᵀb
    assert calls["normal_apply_plain"] == calls["cg_step_plain"] == 0
    if solve.mode == "apply":
        assert calls["normal_apply_zy_plain"] == 2 + 2 * 4
        assert calls["cg_direction_plain"] == 2 * 3
        assert calls["cg_step_zy_plain"] == 0
    else:
        assert calls["normal_apply_zy_plain"] == 2
        assert calls["cg_step_zy_plain"] == 2 * 4
    assert set(F.launch_counts().values()) == {0}
    assert torch.equal(solve.plain(_t(b), _t(b), 0.01, 0.5), got)


def test_blocked_admm_solve_modes_and_routes():
    """``"auto"`` takes ``"apply"`` at 512-wide planes and the 1-D
    ``"step"`` (the fused solve's sequence) below them; ``"step"`` equals
    the fused solve; ``"step2d"`` needs the (z, y) layout."""
    assert B.blocked_admm_solve(WIDE, ISO).mode == "apply"
    small = (12, 16, 10)
    solve = B.blocked_admm_solve(small, ISO, iterations=2, iter_max=3)
    assert solve.mode == "step"
    b = _t(_blurred(8, small))
    fused = F.make_fused_admm_solver(small, ISO, iterations=2, iter_max=3)
    assert torch.equal(solve(b, b, 0.01, 0.5), fused(b, b, 0.01, 0.5))
    with pytest.raises(ValueError, match="step2d"):
        B.blocked_admm_solve(small, ISO, mode="step2d")
    # "apply" runs anywhere: the same solve as "step" to rounding
    x = B.blocked_admm_solve(small, ISO, iterations=2, iter_max=3,
                             mode="apply")(b, b, 0.01, 0.5)
    np.testing.assert_allclose(_np(x), _np(fused(b, b, 0.01, 0.5)),
                               atol=2e-6)


def test_blocked_entry_points_raise_on_unported_modes():
    """The sweep formulation (K8), the linear compact storage options
    (K10), the sharded per-shard form (K9b) and the robust compact storage
    (K10b.2) are ported; the MXU schedule forms are taken at their
    defaults only."""
    assert B.blocked_admm_solve(WIDE, ISO, mode="sweep").mode == "sweep"
    for opt, storage in (({"compact_dirs": True}, "dirs"),
                         ({"state_dtype": "bfloat16"}, "state")):
        assert B.blocked_admm_solve(WIDE, ISO, **opt).storage == storage
    B.make_blocked_normal_operator_2d(WIDE, ISO, z_block=8,
                                      io_dtype="bfloat16")
    for opt in ({"precision": "high2"}, {"block": 8},
                {"blur_reorder": "high2"}):
        with pytest.raises(ValueError, match="default|exact f32"):
            B.blocked_admm_solve(WIDE, ISO, **opt)
    for opt in ({"precision": "high3"}, {"interpret": True},
                {"blur_reorder": "auto"}):
        B.blocked_admm_solve(WIDE, ISO, **opt)
    with pytest.raises(TypeError):
        B.blocked_admm_solve(WIDE, ISO, io_dtype="bfloat16")
    with pytest.raises(ValueError, match="mode must be"):
        B.blocked_admm_solve(WIDE, ISO, mode="fast")
    with pytest.raises(ValueError, match="3-D"):
        B.blocked_admm_solve((512, 512), np.eye(2))
    # the robust compact storage is ported (K10b.2): the tiled route keeps
    # it
    rob = R.blocked_robust_admm_solve(WIDE, ISO, compact_dirs=True)
    assert (rob.tiled, rob.storage) == (True, "io")
    # prepadded=True (K9b) at a 512-wide plane: the window's blur on the
    # whole volume's wrap prepad equals the wrap blur
    blur = R.make_blocked_blur_operator(WIDE, ISO, prepadded=True)
    y = _t(np.random.RandomState(3).rand(*WIDE))
    ext = y[np.arange(-blur.halo, WIDE[0] + blur.halo) % WIDE[0]]
    np.testing.assert_allclose(_np(blur(ext)),
                               _np(R.make_blocked_blur_operator(WIDE, ISO)(y)),
                               atol=1e-12)


def test_blocked_robust_solve_plain_matches_pallas():
    """``blocked_robust_admm_solve`` at a 512-wide shape: the tiled units'
    plain versions against the JAX solve over its (z, y)-blocked kernels
    in interpret mode, huber, 2 × 2 sweeps × 3 CG; atol 5e-6 (the 1-D
    case's band, tests/test_torch_robust.py)."""
    b = _blurred(9, WIDE, noise=0.3)
    want = _jax("ops.pallas.robust").blocked_robust_admm_solve(
        WIDE, ISO, iterations=2, iter_max=2, irls_cg_iters=3,
        data_loss="huber", interpret=True)(b, b, 0.01, 0.5, 1.0)
    F.reset_counts()
    solve = R.blocked_robust_admm_solve(WIDE, ISO, iterations=2, iter_max=2,
                                        irls_cg_iters=3, data_loss="huber")
    assert solve.tiled
    got = solve(_t(b), _t(b), 0.01, 0.5, 1.0)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=5e-6)
    calls = F.plain_counts()
    assert calls["blur_apply_zy_plain"] == 2 * 2 * 2
    assert calls["weighted_apply_zy_plain"] == 2 * 2 * 3
    assert calls["blur_apply_plain"] == calls["irls_head_plain"] == 0
    assert calls["weighted_apply_plain"] == 0
    assert set(F.launch_counts().values()) == {0}


def test_tiled_robust_solve_equals_the_per_axis_solve():
    """Below 512 the robust route keeps the per-axis units; forced tiled,
    the plain solve is the same to rounding (bit-identical units)."""
    shape = (10, 12, 8)
    assert not R.blocked_robust_admm_solve(shape, ISO).tiled
    b = _t(_blurred(10, shape, noise=0.2))
    kw = dict(iterations=2, iter_max=2, irls_cg_iters=3, data_loss="cauchy")
    x1 = R.make_robust_solver(shape, ISO, **kw)(b, b, 0.01, 0.5, 0.7)
    x2 = R._make_solver(shape, ISO, 3, None, kw["iterations"],
                        kw["iter_max"], kw["irls_cg_iters"], kw["data_loss"],
                        False, tiled=True)(b, b, 0.01, 0.5, 0.7)
    assert torch.equal(x1, x2)


#: (σ, shape, the linear auto mode, whether the robust sweep is tiled, the
#: explicit modes that raise): the blur widens past what the tiled units'
#: shared memory holds — the weighted apply first (blur half-width 7), then
#: the CG step's two windows, then the normal apply (the march holds blur
#: half-width 12, σ = 4, and not 14)
WIDE_BLURS = [
    (2.0, (32, 512, 16), "apply", True, ()),
    (2.5, (32, 512, 16), "apply", False, ()),
    (3.5, (64, 512, 16), "apply", False, ("step2d",)),
    (4.0, (64, 512, 16), "apply", False, ("step2d",)),
    (4.5, (64, 512, 16), "step", False, ("apply", "step2d")),
]


@pytest.mark.parametrize("sigma,shape,mode,tiled,refused", WIDE_BLURS)
def test_wide_blurs_route_to_the_per_axis_units(sigma, shape, mode, tiled,
                                                refused):
    """Every shape here takes the JAX package's (z, y)-blocked kernels;
    the port decides before any launch whether its tiled units hold the
    blur's stencils, and takes the per-axis units where they do not, as
    that package takes its 1-D kernels where its 2-D ones do not fit
    (nsol_tpu/ops/pallas/robust.py:435-491)."""
    cov = np.diag([sigma ** 2] * 3)
    halo = len(B.zy_halos(shape, cov)[0][0]) - 1
    assert B.pick_zy_blocks(shape, halo)[0] is not None
    assert B.blocked_admm_solve(shape, cov).mode == mode
    assert B.takes_zy_route(shape, cov) == (mode == "apply")
    assert R.blocked_robust_admm_solve(shape, cov).tiled == tiled
    assert B.takes_zy_route(shape, cov, route="robust") == tiled
    for m in refused:
        with pytest.raises(ValueError, match="shared memory"):
            B.blocked_admm_solve(shape, cov, mode=m)
    if not tiled:
        with pytest.raises(ValueError, match="shared memory"):
            R.make_blocked_weighted_normal_operator_2d(shape, cov)
    if mode == "step":
        with pytest.raises(ValueError, match="shared memory"):
            B.make_blocked_normal_operator_2d(shape, cov, z_block=None,
                                              y_block=None)


def test_smem_bytes_bounds_the_tiled_units():
    """The shared-memory sizes of ``csrc/tiled.cu`` at σ = 1 (7 blur, 13
    normal taps a side) and at the edge of the weighted apply: blur
    half-width 7 fits, 8 does not."""
    assert T.smem_bytes((13, 13, 13)) == 61040
    assert T.smem_bytes((13, 13, 13), nin=2) == 71792
    assert T.smem_bytes((7, 7, 7), nin=1, lap=False) < T.smem_bytes(
        (7, 7, 7), nin=2)
    assert T.smem_bytes((7, 7, 7), weighted=True) == 92736
    assert T.smem_bytes((13, 13, 13), weighted=True) <= T.MAX_SMEM
    assert T.smem_bytes((15, 13, 13), weighted=True) <= T.MAX_SMEM
    assert T.smem_bytes((15, 15, 15), weighted=True) <= T.MAX_SMEM
    assert T.smem_bytes((17, 17, 17), weighted=True) > T.MAX_SMEM
    with pytest.raises(ValueError, match="past the 232448"):
        T.require_fit("weighted_apply_zy", (17, 17, 17), weighted=True)


def _smem_before(lengths, nin, lap):
    """A single-stencil unit's shared memory a block in ``csrc/tiled.cu``
    before its march was redesigned (two float windows per input, the
    convolved window, an xy ring of 2h + 1 planes): the sizes by which the
    solves routed to the tiled units then."""
    kz, ky, kx = lengths
    hz, hy, hx = (max(k // 2, 1) for k in lengths)
    wy, wx = T.TILE_Y + 2 * hy, T.TILE_X + 2 * hx
    words = (kz + ky + kx + wy + wx + (2 * nin + 1) * wy * wx
             + wy * T.TILE_X + (2 * hz + 1) * T.TILE_Y * T.TILE_X
             + (hz + 2) * (T.TILE_Y + 2) * (T.TILE_X + 2) * lap)
    return 4 * words


@pytest.mark.parametrize("nin, lap", [(1, True), (2, True), (1, False)])
def test_march_routes_every_length_it_routed_before(nin, lap):
    """The redesigned march (16-byte window rows, no convolved window, the
    z ring in registers or, for other lengths, in shared memory) holds
    every stencil that the tiled units held before, in every form the
    routes launch; and route_fits still sends σ up to 4 to the tiled
    units."""
    for lengths in itertools.product(range(1, 100, 2), repeat=3):
        if _smem_before(lengths, nin, lap) <= T.MAX_SMEM:
            assert T.smem_bytes(lengths, nin, lap) <= T.MAX_SMEM, lengths
    for sigma in (0.5, 1.0, 2.0, 3.0, 4.0):
        factors = blur_factors(np.diag([sigma ** 2] * 3), 3, None)
        assert T.route_fits(factors, "apply"), sigma


def _weighted_smem_before(lengths):
    """``weighted_apply_zy``'s shared memory a block in ``csrc/tiled.cu``
    before its march was redesigned (two shared-memory marches of one
    output a thread: the r, p and free windows twice over and the pf
    window at halo 2h, the weights window twice, the x-blurred rows, the
    two xy rings and the pf ring): the sizes by which the solves routed to
    the tiled weighted unit then."""
    kz, ky, kx = lengths
    hz, hy, hx = (max(k // 2, 1) for k in lengths)
    wy, wx = T.TILE_Y + 4 * hy, T.TILE_X + 4 * hx
    ey, ex = T.TILE_Y + 2 * hy, T.TILE_X + 2 * hx
    words = (kz + ky + kx + wy + wx + 7 * wy * wx + 2 * ey * ex + wy * ex
             + (2 * hz + 1) * (ey * ex + T.TILE_Y * T.TILE_X)
             + (2 * hz + 2) * (T.TILE_Y + 2) * (T.TILE_X + 2))
    return 4 * words


def test_weighted_march_routes_every_length_it_routed_before():
    """The redesigned weighted march (its runtime-length instance: plain
    window margins, one buffer of input windows, the weights read from
    device memory) holds every stencil the older kernel held, so every
    blur that took the tiled robust route still takes it; the widest
    isotropic blur it holds grows from σ = 2 (13 taps) to σ = 2.3 (15)."""
    for lengths in itertools.product(range(1, 100, 2), repeat=3):
        if _weighted_smem_before(lengths) <= T.MAX_SMEM:
            assert T.smem_bytes(lengths, weighted=True) <= T.MAX_SMEM, lengths
    for sigma, fits in ((1.0, True), (2.0, True), (2.3, True), (2.4, False)):
        factors = blur_factors(np.diag([sigma ** 2] * 3), 3, None)
        assert T.route_fits(factors, "robust") == fits, sigma


@pytest.mark.parametrize("loss", ["linear", "huber"])
def test_cli_sends_wide_volumes_to_the_blocked_route(tmp_path, loss):
    """``run_deconvolution`` on a NIfTI with 512-wide planes and ``--device
    cpu`` takes the blocked route (the tiled units' plain versions ran)
    and equals the library's blocked solve on ``b / max(b)``. Both losses
    route as the reference does (``nsol_tpu_torch.policy``): a
    (16, 512, 130) volume, past the fused solve's 16 volumes in 64 MiB
    (a smaller one takes the fused solve)."""
    from nsol_tpu_torch.cli import run_deconvolution
    from nsol_tpu_torch.io import read_nifti, write_nifti

    shape = (16, 512, 130)
    obs, out = str(tmp_path / "b.nii.gz"), str(tmp_path / "x.nii.gz")
    write_nifti(200.0 * _blurred(11, shape), obs, spacing=np.ones(3))
    F.reset_counts()
    rc = run_deconvolution.main([
        "--observation", obs, "--result", out, "--solver", "ADMM",
        "--reconstruction-type", "TVL2", "--data-loss", loss,
        "--iterations", "2", "--iter-max", "2", "--irls-cg-iters", "3",
        "--device", "cpu"])
    assert rc == 0
    calls = F.plain_counts()
    assert calls["blur_apply_zy_plain"] > 0
    unit = "normal_apply_zy_plain" if loss == "linear" \
        else "weighted_apply_zy_plain"
    assert calls[unit] > 0
    assert calls["normal_apply_plain"] == calls["weighted_apply_plain"] == 0
    b = read_nifti(obs).data.astype(np.float64)
    bs = _t(b / b.max())
    if loss == "linear":
        lib = B.blocked_admm_solve(shape, ISO, iterations=2, iter_max=2)(
            bs, bs, 0.01, 0.5)
    else:
        lib = R.blocked_robust_admm_solve(
            shape, ISO, iterations=2, iter_max=2, irls_cg_iters=3,
            data_loss=loss)(bs, bs, 0.01, 0.5, 1.0)
    recon = read_nifti(out).data
    np.testing.assert_allclose(recon, _np(lib).astype(np.float64) * b.max(),
                               rtol=1e-6, atol=1e-6 * b.max())


# ------------------------------------------------------------ on the card --

#: shapes that hit every tile edge (Y not a multiple of the 16-row tile,
#: odd X, Z just above the z halo and one z chunk plus a ragged one)
EDGE_SHAPES = [(13, 530, 37), (7, 45, 33), (70, 40, 65), (9, 36, 88),
               (9, 36, 76)]
EDGE_COVS = [(ISO, None), (np.diag([0.64, 4.0, 0.64]), None),
             (ANISO, (1.0, 1.5, 0.8))]


def _chip_smoke():
    """``chip_smoke.py``, whose phase 20 builds the unit/plain pairs."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _assert_pairs_agree(pairs):
    """Kernel vs plain, f32, every form of every unit:
    max |Δ| ≤ 1e-5 · max |ref|."""
    torch.cuda.synchronize()
    for unit, outs in pairs.items():
        for k, (got, ref) in enumerate(outs):
            err = float((got - ref).abs().max()
                        / ref.abs().max().clamp_min(1e-30))
            assert err <= 1e-5, "%s output %d: %.3g" % (unit, k, err)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES)
@pytest.mark.parametrize("case", range(len(EDGE_COVS)))
def test_cuda_tiled_units_match_plain_on_card(cuda_device, shape, case):
    cov, spacing = EDGE_COVS[case]
    st = B.Stencils.from_cov(cov, 3, spacing, cuda_device)
    _assert_pairs_agree(_chip_smoke().tiled_unit_pairs(
        T, B, st, shape, cuda_device, np.random.RandomState(12)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES)
@pytest.mark.parametrize("case", range(len(EDGE_COVS)))
def test_cuda_march_equals_three_pass_bit_for_bit(cuda_device, shape, case):
    """Every form of the march units (normal_apply_zy plain / dot /
    residual in float32 and bfloat16 io, cg_step_zy, blur_apply_zy's four
    forms) equals its three-pass unit bit for bit on tile-edge shapes, at
    σ = 1 (compile-time taps) and at the other lengths."""
    cov, spacing = EDGE_COVS[case]
    st = B.Stencils.from_cov(cov, 3, spacing, cuda_device)
    cs = _chip_smoke()
    cs.require_bits(cs.tiled_three_pass_pairs(T, R, B, st, shape,
                                              cuda_device, 30 + case),
                    "march %s %s" % (case, shape))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES)
@pytest.mark.parametrize("case", range(len(EDGE_COVS)))
def test_cuda_weighted_march_equals_three_pass_bit_for_bit(cuda_device, shape,
                                                           case):
    """weighted_apply_zy (p', q) equals the three-pass weighted_apply bit
    for bit in every storage mode (exact, "dirs", "io"), masked or not, on
    the first trip and after, on tile-edge shapes: σ = 1 takes the
    compile-time instance, the other blurs the runtime-length one."""
    cov, spacing = EDGE_COVS[case]
    st = B.Stencils.from_cov(cov, 3, spacing, cuda_device)
    _chip_smoke().weighted_three_pass_bits(T, R, st, shape, cuda_device,
                                           40 + case)


@pytest.mark.cuda
def test_cuda_smem_sizes_and_the_widest_blur_that_fits(cuda_device):
    """``nsol_tiled_smem`` and :func:`tiled.smem_bytes` agree; at σ = 2.3
    (the widest isotropic blur the weighted apply holds) the units match
    their plain versions, and at σ = 2.4 its wrapper raises before any
    launch."""
    sigma, rel = _chip_smoke().tiled_fit_checks(T, B, cuda_device)
    assert sigma == 2.3 and rel <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["apply", "step2d"])
def test_cuda_blocked_solve_matches_plain_on_card(cuda_device, mode):
    b = _t(_blurred(13, (16, 512, 48)), cuda_device)
    solve = B.blocked_admm_solve(b.shape, ISO, iterations=3, iter_max=5,
                                 mode=mode)
    F.reset_counts()
    x_k = solve(b, b, 0.01, 0.5)
    launches = F.launch_counts(F.TILED_UNITS + ("normal_apply", "cg_step"))
    assert launches["normal_apply"] == launches["cg_step"] == 0
    assert launches["normal_apply_zy"] > 0 and launches["blur_apply_zy"] == 1
    assert set(F.plain_counts().values()) == {0}
    x_p = solve.plain(b, b, 0.01, 0.5)
    assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_blocked_robust_solve_matches_plain_on_card(cuda_device):
    b = _t(_blurred(14, (16, 512, 48), noise=0.2), cuda_device)
    solve = R.blocked_robust_admm_solve(b.shape, ISO, iterations=2,
                                        iter_max=2, irls_cg_iters=4)
    F.reset_counts()
    x_k = solve(b, b, 0.01, 0.5)
    launches = F.launch_counts()
    assert launches["blur_apply_zy"] == 8 and launches["weighted_apply_zy"] == 16
    assert launches["blur_apply"] == launches["weighted_apply"] == 0
    x_p = solve.plain(b, b, 0.01, 0.5)
    assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= 1e-4
