"""The whole-volume ``cg_step`` and ``weighted_apply`` on the marches of
``csrc/march.cuh``, against the JAX package.

The rules the C code fixes before any launch, through their Python
mirrors in ``ops/cuda/tiled.py``: the z tile a march block takes
(``tile_z``) and the route between the march and the three-pass chain
(``vol_route``); the plain versions of the two units in every storage
mode and both regularisers the march now serves, against the blocked
Pallas kernels in interpret mode at the tolerances of
tests/test_pallas.py (:1090-1124, :1382); the routing wrappers' CPU path.
The ``cuda``-marked cases hold every march form bit for bit to its
three-pass chain and the C rules to their mirrors on the card, and skip
without one:

    python -m pytest --noconftest -m cuda tests/test_torch_volume.py
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nsol_tpu_torch import interop  # noqa: E402
from nsol_tpu_torch.ops.conv import blur_factors  # noqa: E402
from nsol_tpu_torch.ops.cuda import blocked as B  # noqa: E402
from nsol_tpu_torch.ops.cuda import fused as F  # noqa: E402
from nsol_tpu_torch.ops.cuda import robust as R  # noqa: E402
from nsol_tpu_torch.ops.cuda import tiled as T  # noqa: E402

ISO = np.diag([1.0, 1.0, 1.0])
SHAPE = (32, 16, 16)
BF16 = torch.bfloat16
#: the H100's SMs, at which the rule's tiles below are stated
SMS = 132
#: the tile-edge shapes and blurs of tests/test_torch_scale.py, the 256³
#: volume, one past the fused fit whose Y and X are no tile multiples, and
#: the 2-D view
EDGE_SHAPES = [(13, 530, 37), (7, 45, 33), (70, 40, 65), (9, 36, 88),
               (9, 36, 76)]
EDGE_COVS = [(ISO, None), (np.diag([0.64, 4.0, 0.64]), None),
             (np.diag([1.3, 0.8, 1.1]) ** 2, (1.0, 1.5, 0.8))]


def _jax(module):
    """A module of the JAX package (skips where jax is absent)."""
    return pytest.importorskip("nsol_tpu." + module)


def _jnp():
    return pytest.importorskip("jax.numpy")


def _t(a, dtype=torch.float32):
    return interop.to_torch(np.asarray(a, np.float32), "cpu").to(dtype)


def _np(t):
    return t.float().cpu().numpy().astype(np.float64)


def _jf(a):
    """A JAX array (bfloat16 or not) as float64 numpy."""
    return np.asarray(a.astype(_jnp().float32), np.float64)


def _within_ulp(got, want):
    """bfloat16 values within one bf16 ulp of the reference's."""
    np.testing.assert_allclose(_np(got), want, rtol=2 ** -7, atol=1e-6)


def _close(got, want):
    """A float32 output within tests/test_pallas.py's band, or a bfloat16
    one within one bf16 ulp."""
    if got.dtype == BF16:
        _within_ulp(got, want)
    else:
        np.testing.assert_allclose(_np(got), want, atol=2e-5, rtol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


# ---------------------------------------------------------------- z tile --

def _blocks(dims, tz):
    Z, Y, X = dims
    return -(-X // T.TILE_X) * -(-Y // T.TILE_Y) * -(-Z // tz)


@pytest.mark.parametrize("dims,kz,weighted,tz", [
    ((256, 256, 256), 13, False, 64), ((256, 256, 256), 7, True, 128),
    ((136, 240, 200), 13, False, 32), ((136, 240, 200), 7, True, 32),
    ((512, 512, 512), 13, False, 128), ((512, 512, 512), 7, True, 256),
    ((64, 512, 512), 13, False, 128), ((64, 512, 512), 7, True, 256),
    ((1, 256, 256), 1, False, 128), ((1, 256, 256), 1, True, 256)])
def test_tile_z_fills_the_card(dims, kz, weighted, tz):
    """The z tile at the main shapes (an H100's 132 SMs): 256³ fills one
    wave of the card (512 of 528 single-stencil slots, 256 of 264
    weighted ones), the ragged volume fills one wave single-stencil and
    two weighted, and the 512-wide-plane shapes keep the marches' longest
    tiles (128 and 256 planes: whole waves already)."""
    assert T.tile_z(dims, kz, weighted, SMS) == tz
    slots = SMS * T.RESIDENT[weighted]
    n = _blocks(dims, tz)
    if dims[0] > 1 and dims[1] < 512:
        waves = -(-n // slots)
        assert n > 0.75 * waves * slots, (n, slots)
    if dims == (512, 512, 512):
        assert tz == (2 if weighted else 1) * T.TILE_Z


@pytest.mark.parametrize("seed", range(4))
def test_tile_z_takes_the_least_waves_times_steps(seed):
    """On random volumes, SM counts and tap lengths, the tile the rule
    takes costs least in (waves of the grid) × (steps a block) of the
    candidate tiles, ties keeping the longer one — the rule of
    ``csrc/march.cuh``'s ``march_tile_z``, which the C code takes."""
    rng = np.random.RandomState(seed)
    for _ in range(50):
        dims = tuple(int(v) for v in rng.randint(1, 600, 3))
        kz, weighted = int(rng.choice([1, 3, 7, 13, 25])), bool(seed % 2)
        sms = int(rng.choice([66, 114, 132]))
        h = max(kz // 2, 1)
        top, extra = (256, 4 * h + 1) if weighted else (128, 2 * h)
        slots = sms * (2 if weighted else 4)
        cands = [top >> k for k in range(6) if top >> k >= T.MIN_TILE_Z]
        cost = {t: -(-_blocks(dims, t) // slots) * (min(t, dims[0]) + extra)
                for t in cands}
        got = T.tile_z(dims, kz, weighted, sms)
        assert cost[got] == min(cost.values())
        assert got == max(t for t in cands if cost[t] == cost[got])


# ----------------------------------------------------------------- route --

#: volumes past the fused fit, deep enough for the widest blurs the
#: marches hold: the march's side of the shape rule
BIG_SHAPES = ((256, 256, 256), (136, 240, 200), (128, 128, 128),
              (32, 256, 256))


def test_vol_route_takes_every_blur_route_fits_took():
    """On a volume past the fused fit and deep enough (at most 2.5 steps a
    plane at σ 3.3: 41 normal taps, 40 halo steps), every isotropic blur that
    ``route_fits`` sent to the tiled units ("step2d", "apply"; "robust")
    takes the whole-volume march (``cg_step`` at the normal taps,
    ``weighted_apply`` at the blur taps): σ up to 3.3 and 2.3. The next
    wider blurs take the chain."""
    for sigma in np.arange(0.5, 4.01, 0.1):
        factors = blur_factors(np.diag([sigma ** 2] * 3), 3, None)
        blur = tuple(len(f) for f in factors)
        normal = tuple(2 * k - 1 for k in blur)
        for dims in BIG_SHAPES:
            assert (T.vol_route("cg_step", normal, dims) == "march") \
                == T.route_fits(factors, "step2d"), sigma
            assert (T.vol_route("weighted_apply", blur, dims) == "march") \
                == T.route_fits(factors, "robust"), sigma
    big = BIG_SHAPES[0]
    assert T.vol_route("cg_step", (41, 41, 41), big) == "march"
    assert T.vol_route("cg_step", (45, 45, 45), big) == "chain"
    assert T.vol_route("weighted_apply", (15, 15, 15), big) == "march"
    assert T.vol_route("weighted_apply", (17, 17, 17), big) == "chain"


@pytest.mark.parametrize("dims", [(64, 64, 64), (16, 256, 256),
                                  (1, 256, 256), (1, 2048, 2048),
                                  (2, 512, 1024), (2, 512, 1025),
                                  (4, 500, 600)])
def test_vol_route_keeps_the_chain_where_it_was_faster(dims):
    """The shape side of the rule, fixed from device times in turns on the
    H100 (``chip_smoke.py`` phase 37): the chain at or under 2^20 voxels
    (the fused solves' volumes: 64³, Lena 256², where the chain took half
    the march's time), on every 2-D view and on stacks of 2 and 4 planes
    past it (the march 1.1-3.5× the chain's time there: 12 or 13 halo
    steps beside each block's 2-4 planes), whatever the taps."""
    for unit, taps in (("cg_step", (13, 13, 13)),
                       ("weighted_apply", (7, 7, 7))):
        assert T.vol_route(unit, taps, dims) == "chain"
        assert T.march_fits(unit, taps)


@pytest.mark.parametrize("dims,routes", [
    ((8, 384, 384), ("march", "chain")), ((8, 1024, 1024), ("march", "chain")),
    ((9, 384, 384), ("march", "march")), ((12, 320, 320), ("march", "march")),
    ((16, 256, 320), ("march", "march")), ((32, 256, 256), ("march", "march"))])
def test_vol_route_depth_follows_the_measured_boundary(dims, routes):
    """The depth side of the rule at σ = 1 (13 normal taps, 12 halo steps;
    7 blur taps, 13 weighted halo steps): a block takes at most 2.5 steps
    a plane it writes, so ``cg_step`` marches from 8 planes (1.1-1.2× the
    chain's speed at 8 × 384², phase 37) and ``weighted_apply`` from 9
    (the chain 1.2× faster at 8 × 384², the march 1.15× at 12 × 320²);
    8 × 1024², where the weighted march was 1.2× faster, keeps the chain
    (the rule counts depth, not plane size)."""
    for unit, taps, want in (("cg_step", (13, 13, 13), routes[0]),
                             ("weighted_apply", (7, 7, 7), routes[1])):
        assert T.vol_route(unit, taps, dims) == want
    assert T.halo_steps(13, False) == 12 and T.halo_steps(7, True) == 13


@pytest.mark.parametrize("dims,routes", [
    ((64, 64, 64), ("chain", "chain", "chain")),
    ((80, 80, 80), ("chain", "chain", "chain")),
    ((88, 88, 88), ("march", "march", "march")),
    ((96, 96, 96), ("march", "march", "march")),
    ((1, 256, 256), ("chain", "chain", "chain")),
    ((1, 2048, 2048), ("chain", "chain", "chain")),
    ((2, 512, 1025), ("chain", "chain", "march")),
    ((4, 500, 600), ("march", "march", "march")),
    ((4, 256, 512), ("chain", "chain", "chain")),
    ((8, 384, 384), ("march", "march", "march"))])
def test_vol_route_of_the_lighter_units_follows_their_times(dims, routes):
    """The route of ``normal_apply`` (13 normal taps), ``blur_apply`` and
    ``irls_head`` (7 blur taps), fixed from device times in turns on the
    H100 (``chip_smoke.py`` phase 37): their marches beat their chains
    from 88³ (the chain won at 80³ and below), so they march past 2^19
    voxels (80³ = 512000 under it; 4 × 256 × 512 exactly on it); on thin
    stacks ``normal_apply`` marches from 4 planes (4 steps a plane written,
    1.1× the chain's speed at 4 × 500 × 600, 0.7× at 2 planes),
    ``blur_apply`` from 4 (2.5 steps: its gradient form lost at 2
    planes) and ``irls_head`` from 2 (4 steps: 1.07× at 2 × 512 × 1025);
    no 2-D view."""
    for unit, taps, want in zip(("normal_apply", "blur_apply", "irls_head"),
                                ((13, 13, 13), (7, 7, 7), (7, 7, 7)), routes):
        assert T.vol_route(unit, taps, dims) == want, unit
    assert T.VOL_MIN_VOXELS["normal_apply"] == 1 << 19 < 88 ** 3


#: the march form whose block each whole-volume unit's route measures:
#: its largest (``cg_step``'s bfloat16 margins, ``blur_apply``'s with u,
#: ``cg_sweep``'s three windows with bfloat16 margins and its r' ring)
UNIT_FORMS = {"cg_step": dict(nin=2, two_byte=True),
              "weighted_apply": dict(weighted=True),
              "normal_apply": dict(nin=1),
              "blur_apply": dict(nin=2),
              "irls_head": dict(nin=1, lap=False),
              "cg_sweep": dict(nin=3, two_byte=True, res=True)}


@pytest.mark.parametrize("unit", T.VOL_UNITS)
def test_vol_route_is_the_march_wherever_a_block_holds_the_taps(unit):
    """The route is the march exactly where a block's shared memory (227
    KB) holds the taps in the march's runtime-length instance of the
    unit's largest form — ``cg_step``'s with bfloat16 window margins,
    which every storage mode fits, ``blur_apply``'s with ``u``, which its
    plain form fits — and the three-pass chain past it; other stencil
    lengths than route_fits' (up to 79 a side) included."""
    for lengths in itertools.product(range(1, 80, 4), repeat=3):
        need = T.smem_bytes(lengths, **UNIT_FORMS[unit])
        want = "march" if need <= T.MAX_SMEM else "chain"
        assert T.vol_route(unit, lengths, (256, 128, 128)) == want, lengths
        assert T.march_fits(unit, lengths) == (want == "march")
    if unit == "blur_apply":
        assert need >= T.smem_bytes(lengths, nin=1, lap=False)
    with pytest.raises(ValueError, match="unit must be"):
        T.vol_route("cg_update", (13, 13, 13), SHAPE)


def test_bf16_margins_grow_the_march_block():
    """A bfloat16 window among two rounds its x margin to 8 values (16
    bytes of bfloat16): the same size as the float margin at the 13 normal
    taps, larger where the x halo is 1-4 past a multiple of 8."""
    assert T.smem_bytes((13, 13, 13), nin=2, two_byte=True) \
        == T.smem_bytes((13, 13, 13), nin=2) == 71792
    assert T.smem_bytes((13, 13, 19), nin=2, two_byte=True) \
        > T.smem_bytes((13, 13, 19), nin=2)
    assert T.smem_bytes((13, 13, 19), nin=1) \
        == T.smem_bytes((13, 13, 19), nin=1, two_byte=True)


# ------------------------------------------------- plain vs Pallas kernels --

#: ``make_blocked_cg_step``'s storage splits by mode (None: its default)
CG_SPLITS = {"exact": {}, "qf32": dict(io_dtype="bfloat16", r_dtype="float32",
                                       q_dtype="float32"),
             "dirs": dict(io_dtype="bfloat16", r_dtype="float32"),
             "state": dict(io_dtype="bfloat16")}


@pytest.mark.parametrize("reg", B.REGS)
@pytest.mark.parametrize("storage", tuple(B.STORAGE))
def test_cg_step_forms_match_pallas(storage, reg):
    """The plain ``cg_step`` in each storage mode and regulariser the march
    serves, after the first trip, against the Pallas kernels in interpret
    mode: TK1 ``make_blocked_cg_step`` with the reference's split; TK0 its
    p' with ``make_blocked_normal_operator`` at ρ = 0 plus ρ·p' (the
    Tikhonov kernel's ``reg_apply``, fused.py:776-783). p', q within one
    bf16 ulp or 2e-5; pq rtol 1e-5."""
    jnp = _jnp()
    JB = _jax("ops.pallas.blocked")
    rng = np.random.RandomState(13)
    r, p = (rng.rand(*SHAPE).astype(np.float32) - 0.3 for _ in range(2))
    beta, rho = 0.83, 1.9
    split = {k: getattr(jnp, v) for k, v in CG_SPLITS[storage].items()}
    if reg == "TK1":
        want = JB.make_blocked_cg_step(SHAPE, ISO, block=8, interpret=True,
                                       **split)(r, p, beta, rho)
        want = [_jf(w) for w in want]
    else:
        io = split.get("io_dtype", jnp.float32)
        r_io = split.get("r_dtype", io)
        pn = (jnp.asarray(r).astype(r_io).astype(jnp.float32) + beta
              * jnp.asarray(p).astype(io).astype(jnp.float32)).astype(io)
        pf = pn.astype(jnp.float32)
        q = JB.make_blocked_normal_operator(SHAPE, ISO, block=8,
                                            interpret=True)(pf, 0.0) + rho * pf
        want = [_jf(pn), _jf(q.astype(split.get("q_dtype", io))),
                float(jnp.sum(pf * q))]
    (rd, pd, qd), _ = B.storage_ids(storage)
    st = B.Stencils.from_cov(ISO, 3, None, "cpu")
    scal = B.new_scalars("cpu")
    scal[B.GAMMA], scal[B.BETA] = 3.0, beta
    got = B.cg_step(_t(r, rd), _t(p, pd), scal, st.normal, st.inv_h2, rho,
                    reg=reg, storage=storage)
    assert (got[0].dtype, got[1].dtype) == (pd, qd)
    _close(got[0], want[0])
    _close(got[1], want[1])
    np.testing.assert_allclose(float(scal[B.PQ]), float(want[2]), rtol=1e-5)
    np.testing.assert_allclose(float(scal[B.A]), 3.0 / float(want[2]),
                               rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["free", "masked"])
@pytest.mark.parametrize("reg", B.REGS)
@pytest.mark.parametrize("storage", R.ROBUST_STORAGE)
def test_weighted_apply_forms_match_pallas(storage, reg, masked):
    """The plain ``weighted_apply`` in each storage mode, regulariser and
    mask the march serves, after the first trip, against
    ``make_blocked_weighted_normal_operator`` in interpret mode on
    pf = free·p' (its "io" instance, ``io_dtype=bfloat16``, for TK1 "io";
    TK0 at ρ = 0 plus ρ·pf, rounded as the "io" core is), q = free·core +
    (p' − pf): within one bf16 ulp of the core (2e-5 in float32), pq rtol
    1e-5."""
    jnp = _jnp()
    JR = _jax("ops.pallas.robust")
    rng = np.random.RandomState(14)
    r, p = (rng.rand(*SHAPE).astype(np.float32) - 0.5 for _ in range(2))
    wts = rng.rand(*SHAPE).astype(np.float32) + 0.1
    free = (rng.rand(*SHAPE) > 0.3).astype(np.float32) if masked \
        else np.ones(SHAPE, np.float32)
    beta, rho = 0.83, 0.7
    io = storage == "io"
    pd = R.direction_dtype(storage) or torch.float32
    pn = (torch.as_tensor(r) + beta * torch.as_tensor(p).to(pd).float()) \
        .to(pd).float().numpy()
    pf = free * pn
    if reg == "TK1":
        op = JR.make_blocked_weighted_normal_operator(
            SHAPE, ISO, block=8, interpret=True,
            io_dtype=jnp.bfloat16 if io else None)
        core = _jf(op(pf, wts, rho))
    else:
        op = JR.make_blocked_weighted_normal_operator(SHAPE, ISO, block=8,
                                                      interpret=True)
        w = np.asarray(jnp.asarray(wts).astype(jnp.bfloat16).astype(
            jnp.float32)) if io else wts
        core32 = op(pf, w, 0.0) + rho * jnp.asarray(pf)
        core = _jf(core32.astype(jnp.bfloat16) if io else core32)
    want_q = free * core + (pn - pf)
    st = B.Stencils.from_cov(ISO, 3, None, "cpu")
    scal = B.new_scalars("cpu")
    scal[B.GAMMA], scal[B.BETA] = 3.0, beta
    got_p, got_q = R.weighted_apply(
        _t(r), _t(p, pd), _t(free) if masked else None, _t(wts), scal,
        st.blur, st.inv_h2, rho, reg=reg, storage=storage)
    assert got_p.dtype == pd and got_q.dtype == torch.float32
    np.testing.assert_array_equal(_np(got_p), pn)
    tol = 2 ** -7 if io else 1e-5
    np.testing.assert_allclose(_np(got_q), want_q, rtol=tol,
                               atol=2e-5 if not io else 1e-6)
    np.testing.assert_allclose(float(scal[B.PQ]),
                               float(np.sum(pn.astype(np.float64) * want_q)),
                               rtol=1e-5)


@pytest.mark.parametrize("reg", B.REGS)
@pytest.mark.parametrize("form", ["plain", "residual"])
@pytest.mark.parametrize("io", [None, "bfloat16"], ids=["f32", "bf16"])
def test_normal_apply_forms_match_pallas(io, form, reg):
    """The plain ``normal_apply`` in each form the march serves — float32
    and bfloat16 io, plain and the CG residual, TK1 and TK0 — against
    ``make_blocked_normal_operator`` in interpret mode (its ``io_dtype``
    for TK1; TK0 its ρ = 0 apply plus ρ·v on v read at the io precision,
    the Tikhonov kernel's ``reg_apply``): q, and the residual
    r = rhs − q(rounded to io) with γ = ‖r‖² from the unrounded r, within
    one bf16 ulp or 2e-5; γ rtol 1e-5."""
    jnp = _jnp()
    JB = _jax("ops.pallas.blocked")
    rng = np.random.RandomState(16)
    v, rhs = (rng.rand(*SHAPE).astype(np.float32) - 0.3 for _ in range(2))
    rho = 0.7
    jio = jnp.float32 if io is None else getattr(jnp, io)
    tio = None if io is None else BF16
    if reg == "TK1":
        q = JB.make_blocked_normal_operator(
            SHAPE, ISO, block=8, interpret=True, io_dtype=jio)(v, rho)
    else:
        vr = jnp.asarray(v).astype(jio).astype(jnp.float32)
        q = (JB.make_blocked_normal_operator(SHAPE, ISO, block=8,
                                             interpret=True)(vr, 0.0)
             + rho * vr).astype(jio)
    st = B.Stencils.from_cov(ISO, 3, None, "cpu")
    scal = B.new_scalars("cpu")
    if form == "plain":
        got = B.normal_apply(_t(v, tio or torch.float32), st.normal,
                             st.inv_h2, rho, reg=reg, io_dtype=tio)
        assert got.dtype == (tio or torch.float32)
        _close(got, _jf(q))
        return
    r32 = jnp.asarray(rhs) - q.astype(jnp.float32)
    got = B.normal_apply(_t(v), st.normal, st.inv_h2, rho, rhs=_t(rhs),
                         scal=scal, reg=reg, io_dtype=tio)
    assert got.dtype == (tio or torch.float32)
    _close(got, _jf(r32.astype(jio)))
    np.testing.assert_allclose(float(scal[B.GAMMA]),
                               float(jnp.sum(r32 * r32)), rtol=1e-5)
    assert float(scal[B.BETA]) == 0.0


def _residual_sides(r_jax, r_port, x, b):
    """Which side's ``r = A x − b`` left the float64 one (the blur by
    ``scipy.ndimage`` in float64), as text for a failed comparison of the
    IRLS head: the largest deviation of each and the voxels past 1e-6 (an
    intermittent miss of 12-13 weights, F6 in ROADMAP.md, moved r by
    ~1e-4 there; summation order moves it by ~1e-7)."""
    import scipy.ndimage as ndi

    u = np.asarray(x, np.float64)
    for ax, f in enumerate(blur_factors(ISO, 3, None)):
        u = ndi.convolve1d(u, np.asarray(f, np.float64), axis=ax,
                           mode="wrap")
    r64 = u - np.asarray(b, np.float64)
    dev = {k: np.abs(np.asarray(v, np.float64) - r64) for k, v in (
        ("JAX", np.asarray(r_jax)), ("port", _np(r_port)))}
    return "; ".join("%s r: max |r - r64| %.3g, %d voxels past 1e-6" % (
        k, float(d.max()), int((d > 1e-6).sum())) for k, d in dev.items())


#: the blur operator's forms (``robust.py:161``'s plain and ``with_lap``
#: applies, the IRLS gradient and head formed in XLA as
#: ``robust.py:507-531`` forms them, the ``prepadded=True`` window with and
#: without u) and the regularisers the reference has for each
BLUR_CASES = [("plain", "TK1"), ("u", "TK1"), ("u", "TK0"),
              ("gradient", "TK1"), ("gradient", "TK0"),
              ("head_huber", "TK1"), ("head_cauchy", "TK1"),
              ("window", "TK1"), ("window_u", "TK1")]


@pytest.mark.parametrize("form,reg", BLUR_CASES)
def test_blur_operator_forms_match_pallas(form, reg):
    """The plain ``blur_apply`` (A y; with u; the IRLS gradient:
    free = !(x ≤ 0 ∧ g > 0), rk = −free·g, γ = ‖rk‖²), ``irls_head``
    (r = A x − b, wts = ρ'_C(r²), y = wts·r) and ``blur_apply_prepadded``
    (a window of 16 planes of a 32-plane volume at row0 8, with and
    without u) against ``make_blocked_blur_operator`` in interpret mode
    (TK0: its plain apply plus ρ·u), the gradient and head formed in XLA
    as ``robust.py:507-531`` forms them: within 2e-6, the active set
    exactly, γ rtol 1e-5."""
    jnp = _jnp()
    JR = _jax("ops.pallas.robust")
    lf = _jax("ops.losses")
    rng = np.random.RandomState(17)
    y, x, b = (rng.rand(*SHAPE).astype(np.float32) - 0.3 for _ in range(3))
    rho, scale = 0.7, 0.4
    st = B.Stencils.from_cov(ISO, 3, None, "cpu")
    if form.startswith("window"):
        zl, row0, z_total = 16, 8, SHAPE[0]
        local = (zl,) + SHAPE[1:]
        ref = JR.make_blocked_blur_operator(
            local, ISO, interpret=True, prepadded=True, z_total=z_total,
            with_lap=form == "window_u")
        h = ref.halo
        assert h == R.blur_halo(st.blur)
        idx = np.arange(row0 - h, row0 + zl + h) % SHAPE[0]
        ye, ue = y[idx], x[idx]
        if form == "window":
            want, got = ref(ye), R.blur_apply_prepadded(
                _t(ye), st.blur, st.inv_h2, row0, z_total)
        else:
            want, got = ref(ye, ue, rho, row0), R.blur_apply_prepadded(
                _t(ye), st.blur, st.inv_h2, row0, z_total, _t(ue), rho)
        np.testing.assert_allclose(_np(got), _jf(want), atol=2e-6)
        return
    plain = JR.make_blocked_blur_operator(SHAPE, ISO, block=8, interpret=True)
    if form.startswith("head"):
        loss = form.split("_")[1]
        r = plain(x) - jnp.asarray(b)
        wts = lf.gradient_loss(loss)(r * r, f_scale=jnp.float32(scale))
        got = R.irls_head(_t(x), _t(b), st.blur, loss, scale)
        which = _residual_sides(r, B._blur_plain(_t(x), st.blur) - _t(b), x, b)
        np.testing.assert_allclose(_np(got[0]), _jf(wts), atol=2e-6,
                                   err_msg=which)
        np.testing.assert_allclose(_np(got[1]), _jf(wts * r), atol=2e-6,
                                   err_msg=which)
        return
    if form == "plain":
        np.testing.assert_allclose(_np(R.blur_apply(_t(y), st.blur,
                                                    st.inv_h2)),
                                   _jf(plain(y)), atol=2e-6)
        return
    if reg == "TK1":
        g = JR.make_blocked_blur_operator(SHAPE, ISO, block=8, interpret=True,
                                          with_lap=True)(y, x, rho)
    else:
        g = plain(y) + rho * jnp.asarray(x)
    if form == "u":
        got = R.blur_apply(_t(y), st.blur, st.inv_h2, _t(x), rho, reg=reg)
        np.testing.assert_allclose(_np(got), _jf(g), atol=2e-6)
        return
    free = jnp.where(jnp.logical_and(jnp.asarray(x) <= 0.0, g > 0.0), 0.0,
                     1.0)
    rk = -free * g
    scal = B.new_scalars("cpu")
    got = R.blur_apply(_t(y), st.blur, st.inv_h2, _t(x), rho, scal=scal,
                       reg=reg)
    np.testing.assert_array_equal(_np(got[0]), _jf(free))
    np.testing.assert_allclose(_np(got[1]), _jf(rk), atol=2e-6)
    np.testing.assert_allclose(float(scal[B.GAMMA]),
                               float(jnp.sum(rk * rk)), rtol=1e-5)


# ------------------------------------------------------ the wrappers' CPU --

def test_launch_counts_report_the_march_forms():
    """The marches' launches (the whole-volume ``cg_step``,
    ``weighted_apply``, ``normal_apply``, ``blur_apply``, ``irls_head``,
    ``cg_sweep`` and the blur's window) are counted on the wrappers' ``march_launches``,
    apart from the chains' ``launches``, and ``launch_counts`` reports them
    under :data:`MARCH_UNITS`' names (by default too); ``reset_counts``
    sets them to 0. On CPU tensors the wrappers run their plain versions
    and count no launch."""
    st = B.Stencils.from_cov(ISO, 3, None, "cpu")
    rng = np.random.RandomState(15)
    r, p, w = (_t(rng.rand(*SHAPE)) for _ in range(3))
    wrappers = {"cg_step_march": B.cg_step,
                "weighted_apply_march": R.weighted_apply,
                "normal_apply_march": B.normal_apply,
                "blur_apply_march": R.blur_apply,
                "irls_head_march": R.irls_head,
                "blur_apply_prepadded_march": R.blur_apply_prepadded,
                "cg_sweep_march": B.cg_sweep}
    assert set(F.MARCH_UNITS) == set(wrappers)
    for k, name in enumerate(wrappers):
        wrappers[name].march_launches = 3 + k
    assert F.launch_counts(F.MARCH_UNITS) == {
        name: 3 + k for k, name in enumerate(wrappers)}
    assert set(F.MARCH_UNITS) <= set(F.launch_counts())
    F.reset_counts()
    B.cg_step(r, p.to(BF16), B.new_scalars("cpu"), st.normal, st.inv_h2,
              0.5, reg="TK0", storage="dirs")
    R.weighted_apply(r, p, None, w, B.new_scalars("cpu"), st.blur,
                     st.inv_h2, 0.5, first=True, storage="io")
    B.normal_apply(r, st.normal, st.inv_h2, 0.5, rhs=p,
                   scal=B.new_scalars("cpu"), reg="TK0")
    R.blur_apply(r, st.blur, st.inv_h2, p, 0.5, scal=B.new_scalars("cpu"))
    R.irls_head(r, p, st.blur, "huber", 1.0)
    h = R.blur_halo(st.blur)
    R.blur_apply_prepadded(r, st.blur, st.inv_h2, 0, SHAPE[0], u_ext=w,
                           rho=0.5)
    B.cg_sweep(w.clone(), r, p, w.clone(), B.new_scalars("cpu"), st.normal,
               st.inv_h2, 0.5)
    units = ("cg_step", "weighted_apply", "normal_apply", "blur_apply",
             "irls_head", "blur_apply_prepadded", "cg_sweep")
    assert set(F.launch_counts(F.MARCH_UNITS + units).values()) == {0}
    assert F.plain_counts(units) == {u + "_plain": 1 for u in units}
    assert SHAPE[0] > 2 * h


# ------------------------------------------------------------------ cuda --

def _chip_smoke():
    """``chip_smoke.py``, whose phase 36 holds the marches to the chains."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


#: the forms of each routed unit that ``chip_smoke.py::vol_march_bits``
#: holds to its chain: ``cg_step`` 4 storages × TK1/TK0 × first trip or
#: not, ``weighted_apply`` 3 storages × masked or not × TK1/TK0 × first or
#: not, ``normal_apply`` plain and residual × f32/bf16 × TK1/TK0 and Aᵀb,
#: ``blur_apply`` plain, with u and its gradient × TK1/TK0, ``irls_head``
#: every loss, ``cg_sweep`` f32/bf16 state × first trip or not
MARCH_FORMS = {"cg_step": 16, "weighted_apply": 24, "normal_apply": 9,
               "blur_apply": 5, "irls_head": len(R.LOSS_IDS), "cg_sweep": 4}
#: the units bit-checked on the card: the routed whole-volume ones and the
#: blur's window (3-D only)
BIT_CASES = [(unit, shape) for unit in T.VOL_UNITS + ("blur_apply_prepadded",)
             for shape in EDGE_SHAPES + [(256, 256)]
             if unit != "blur_apply_prepadded" or len(shape) == 3]


@pytest.mark.cuda
@pytest.mark.parametrize("unit,shape", BIT_CASES)
@pytest.mark.parametrize("case", range(len(EDGE_COVS)))
def test_cuda_vol_marches_equal_their_chains_bit_for_bit(cuda_device, unit,
                                                         shape, case):
    """Every form of the whole-volume marches (:data:`MARCH_FORMS`) equals
    its three-pass chain bit for bit (every output, signed zeros included)
    on the tile-edge shapes and the 2-D view, at σ = 1 (compile-time taps)
    and at the other blurs; the blur window, with and without u, at three
    ``row0``."""
    cov, spacing = EDGE_COVS[case]
    nd = len(shape)
    st = B.Stencils.from_cov(cov[:nd, :nd], 3,
                             None if spacing is None else spacing[:nd],
                             cuda_device)
    cs = _chip_smoke()
    if unit == "blur_apply_prepadded":
        pairs = cs.blur_window_bits(R, st, shape, cuda_device, 50 + case)
        assert len(cs.require_bits(pairs, unit).split(", ")) == 6
        return
    assert cs.vol_march_bits(B, R, st, shape, cuda_device, 50 + case,
                             units=(unit,)) == MARCH_FORMS[unit]


@pytest.mark.cuda
@pytest.mark.parametrize("unit", T.VOL_UNITS)
def test_cuda_rules_match_their_mirrors(cuda_device, unit):
    """``nsol_march_tile_z``, ``nsol_vol_route`` (of each unit) and the
    bf16-margin ``nsol_tiled_smem`` equal ``tile_z``, ``vol_route`` and
    ``smem_bytes`` at this card's SMs."""
    assert "SMs" in _chip_smoke().vol_rule_checks(T, cuda_device, (unit,))


@pytest.mark.cuda
def test_cuda_solves_route_by_the_rule(cuda_device):
    """A σ = 1 solve past the fused fit runs its ``cg_step`` on the
    march, one under it and a blur past the march's shared memory on the
    chain, and each matches its plain version."""
    cs = _chip_smoke()
    chain = cs.chain_route_runs(F, cuda_device)
    assert all(v[0] > 0 and v[1] == 0 for v in chain.values())
    for shape, route in (((24, 224, 200), (0, 6)), ((32, 40, 48), (6, 0))):
        b = torch.rand(shape, device=cuda_device)
        solve = F.make_fused_admm_solver(shape, ISO, iterations=2, iter_max=3)
        # the launch sequence's units (the fused route takes the persistent
        # launch at 32 x 40 x 48)
        F.reset_counts()
        x = solve.sequence(b, b, 0.01, 0.5)
        assert cs.route_launches(F)["cg_step"] == route, shape
        assert float((x - solve.plain(b, b, 0.01, 0.5)).abs().max()
                     / x.abs().max()) <= 1e-3
