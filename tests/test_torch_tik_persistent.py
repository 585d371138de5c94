"""The fused Tikhonov batch as one persistent cooperative launch
(``csrc/tikhonov_persistent.cu``): its route, its constants, its barriers
and its batch on the CPU.

On the CPU the batch runs its plain versions, as before: the route only
decides what a batch on the card launches. :func:`T.tikhonov_persistent_route`
is held here to the Tikhonov path's shapes (Lena 256², 64³, 80³, 96³,
100³, 256³, 1024², 2048², 2-32-plane stacks), to its refusals (the robust
losses, the bf16 ``"dirs"`` and ``"state"`` storage) and to the constants
of its C rule (``nsol_tikhonov_persistent_route``), read from the source;
the plain batch, its α and C varying, is held to the JAX package's
Pallas kernel in interpret mode. The ``cuda``-marked cases hold the one
launch bit for bit to ``nsol_tikhonov_solve``'s launch sequence on the
card, and its width (the C rule ``batch_width``) to the widths measured
there; they skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_tik_persistent.py
"""

import os
import re

import numpy as np
import pytest
import scipy.ndimage as ndi

torch = pytest.importorskip("torch")

from nsol_tpu_torch import interop  # noqa: E402
from nsol_tpu_torch.ops.cuda import blocked as B  # noqa: E402
from nsol_tpu_torch.ops.cuda import fused as F  # noqa: E402
from nsol_tpu_torch.ops.cuda import tikhonov as T  # noqa: E402
from nsol_tpu_torch.ops.kernels import gaussian_kernel  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "nsol_tpu_torch", "csrc")
#: the Tikhonov path's shapes (a 2-D image as its (1, Y, X) view) and what
#: the rule says of them at σ = 1: the persistent batch where no unit of
#: the launch sequence marches (at most 2^19 voxels, or a stack too thin
#: for any march)
ROUTE_CASES = [((256, 256), True), ((64, 64, 64), True),
               ((80, 80, 80), True), ((96, 96, 96), False),
               ((100, 100, 100), False), ((256, 256, 256), False),
               ((1024, 1024), False), ((2048, 2048), False),
               ((2, 256, 512), True), ((2, 512, 1025), False),
               ((4, 500, 600), False), ((32, 128, 128), True)]
#: (α, C) of the CPU batches: α and C varying within the batch (C is no
#: term of the linear loss)
ALPHAS, SCALES = [0.02, 0.3, 0.05], [1.0, 0.4, 2.5]
COMPACT = {"precision": "high3", "compact_dirs": True}


def _dims(shape):
    return (1,) * (3 - len(shape)) + tuple(shape)


def _lengths(shape, taps=7):
    return F.taps_lengths([np.ones(taps)] * len(shape))


def _problem(shape, seed, noise=0.05):
    """A blurred random binary image with noise, float32."""
    rng = np.random.RandomState(seed)
    kern = gaussian_kernel(np.eye(len(shape)), alpha_cut=3,
                           spacing=np.ones(len(shape)))
    b = ndi.convolve((rng.rand(*shape) > 0.6).astype(np.float64), kern,
                     mode="wrap") + noise * rng.randn(*shape)
    return b.astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


# ------------------------------------------------------------ the route --

@pytest.mark.parametrize("storage", ["exact", "qf32"])
@pytest.mark.parametrize("shape,takes", ROUTE_CASES)
def test_route_on_the_tikhonov_shapes(shape, takes, storage):
    assert T.tikhonov_persistent_route(_dims(shape), *_lengths(shape),
                                       storage=storage) is takes


@pytest.mark.parametrize("kw", [dict(data_loss="huber"),
                                dict(data_loss="soft_l1"),
                                dict(data_loss="cauchy"),
                                dict(data_loss="arctan"),
                                dict(storage="dirs"), dict(storage="state")])
def test_route_refuses_robust_losses_and_bf16_state(kw):
    """Every storage but exact and qf32 stays on the launch sequence. A
    robust loss takes ``csrc/irls_persistent.cu``'s one-launch batch where
    its rule takes the shape (Lena) and the launch sequence
    (``nsol_irls_sweep``) past it (256³, whose units march)."""
    robust = "data_loss" in kw
    assert T.tikhonov_persistent_route((1, 256, 256), *_lengths((256, 256)),
                                       **kw) is robust
    assert not T.tikhonov_persistent_route((256,) * 3, *_lengths((256,) * 3),
                                           **kw)


def test_route_table_matches_the_c_rule():
    """The Python mirror's constants are the C source's: the count slot;
    the C rule is the linear loss and the ADMM solve's rule without the
    sweep, whose voxel cap and storage the mirror shares."""
    src = open(os.path.join(CSRC, "tikhonov_persistent.cu")).read()
    slot = re.search(r"kTikPersistent = (\d+);", src)
    assert slot and int(slot.group(1)) == T.PERSISTENT_SLOT < T.COUNTS
    rule = src[src.index("int nsol_tikhonov_persistent_route("):]
    rule = rule[:rule.index("\n}\n")]
    assert "loss == kLinear" in rule
    assert "nsol_admm_persistent_route(storage, 0," in rule
    shared = open(os.path.join(CSRC, "persistent.cuh")).read()
    cap = re.search(r"kPersistentMaxVoxels = 1LL << (\d+);", shared)
    assert cap and 1 << int(cap.group(1)) == F.PERSISTENT_MAX_VOXELS
    assert [B.storage_ids(s)[1] for s in F.PERSISTENT_STORAGE] == [0, 1]
    assert "tik_persistent" in F.PERSISTENT_UNITS


def test_solver_reports_its_route():
    """``solve.route``: what a batch on the card takes."""
    assert T.make_fused_tikhonov_solver((256, 256), np.eye(2)).route \
        == "persistent"
    assert T.make_fused_tikhonov_solver(
        (64,) * 3, np.eye(3), reg="TK0", **COMPACT).route == "persistent"
    assert T.make_fused_tikhonov_solver((256,) * 3, np.eye(3)).route \
        == "sequence"
    assert T.make_fused_tikhonov_solver((256, 256), np.eye(2),
                                        data_loss="huber").route \
        == "persistent"


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("loss", ["huber", "soft_l1", "cauchy", "arctan"])
def test_robust_solver_reports_the_sequence(loss, compact):
    """A robust batch, exact or with bf16 directions, takes the launch
    sequence past the robust rule (256³), as the linear batch does there,
    and the one launch of ``csrc/irls_persistent.cu`` where the rule
    takes the shape (Lena)."""
    kw = COMPACT if compact else {}
    assert T.make_fused_tikhonov_solver((256,) * 3, np.eye(3),
                                        **kw).route == "sequence"
    assert T.make_fused_tikhonov_solver((256,) * 3, np.eye(3),
                                        data_loss=loss, **kw).route \
        == "sequence"
    assert T.make_fused_tikhonov_solver((256, 256), np.eye(2),
                                        data_loss=loss, **kw).route \
        == "persistent"


def test_barriers_per_batch():
    """Three for Aᵀb; a turn of configurations side by side three for the
    residual and four a CG iteration but the last, whose ``cg_update``
    takes no barrier after it."""
    assert T.persistent_barriers(64, 10, 64) == 3 + (3 + 39)
    assert T.persistent_barriers(64, 10, 16) == 3 + 4 * 42
    assert T.persistent_barriers(8, 10, 4) == 3 + 2 * 42
    assert T.persistent_barriers(19, 10, 10) == 3 + 2 * 42
    assert T.persistent_barriers(64, 10, 1) == 3 + 64 * 42
    assert T.persistent_barriers(5, 0, 5) == 6


# --------------------------------------------------------- on the CPU --

def test_cpu_batch_counts_no_persistent_launch():
    """On the CPU the batch runs the plain versions of the launch
    sequence's units and launches nothing, whatever its route."""
    shape = (9, 10, 11)
    b = torch.as_tensor(_problem(shape, 3))
    solve = T.make_fused_tikhonov_solver(shape, np.eye(3), iter_max=3)
    assert solve.route == "persistent"
    F.reset_counts()
    x = solve(b, b, ALPHAS, SCALES)
    assert x.shape == (3,) + shape and bool(torch.isfinite(x).all())
    assert F.launch_counts()["tik_persistent"] == 0
    assert set(F.launch_counts().values()) == {0}
    assert F.plain_counts(("cg_step",))["cg_step_plain"] == 9


@pytest.mark.parametrize("route", ["graph", "persistent"])
def test_unknown_route_refuses_before_any_build(route):
    """Only the rule's route (``None``) and ``"sequence"`` exist: no caller
    forces the one launch. Any other route raises before it builds or
    launches anything (so here, on the CPU, too)."""
    shape = (6, 7, 8)
    st = B.Stencils.from_cov(np.eye(3))
    b = torch.as_tensor(_problem(shape, 4))
    with pytest.raises(ValueError, match="route"):
        T._tik_solve_cuda(st, b, b, ALPHAS, SCALES, "TK1", "linear", 2, 3,
                          route=route)
    solve = T.make_fused_tikhonov_solver(shape, np.eye(3))
    assert not hasattr(solve, "persistent")


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("reg", ["TK0", "TK1"])
def test_plain_batch_matches_pallas(reg, compact):
    """The batch (plain versions on the CPU), α and C varying, against
    the JAX package's make_fused_tikhonov_solver in interpret mode, one
    configuration at a time: exact at tests/test_torch_tikhonov.py's
    tolerance (atol 5e-5, rtol 1e-4, tests/test_pallas.py:829) on small
    noisy problems; compact within 5e-4 · max |x| at the configuration
    whose band that is (tests/test_torch_compact_robust.py's 16³ noiseless
    problem, 6 CG; the band of tests/test_pallas.py:1200)."""
    JF = pytest.importorskip("nsol_tpu.ops.pallas.fused")
    if compact:
        shape, b = (16, 16, 16), _problem((16, 16, 16), 4, noise=0.0)
    else:
        shape = (16, 16) if reg == "TK1" else (6, 8, 10)
        b = _problem(shape, 5)
    kw = dict(reg=reg, iter_max=6, **(COMPACT if compact else {}))
    jsolve = JF.make_fused_tikhonov_solver(shape, np.eye(len(shape)),
                                           interpret=True, **kw)
    solve = T.make_fused_tikhonov_solver(shape, np.eye(len(shape)), **kw)
    got = interop.to_numpy(solve(interop.to_torch(b, "cpu"),
                                 interop.to_torch(b, "cpu"),
                                 ALPHAS, SCALES))
    for k, (a, c) in enumerate(zip(ALPHAS, SCALES)):
        want = np.asarray(jsolve(b, b, a, data_loss_scale=c))
        if compact:
            assert np.abs(got[k] - want).max() <= 5e-4 * np.abs(want).max()
        else:
            np.testing.assert_allclose(got[k], want, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("reg", ["TK0", "TK1"])
def test_plain_compact_batch_on_a_noisy_problem(reg):
    """The compact batch (bf16 CG directions) on the noisy problems of
    the exact cases above, against the JAX package's compact solve: over
    the batch, no farther from it than the compaction moves the JAX
    package's own solve from its exact one. On these problems a one-ulp
    change of ``b`` moves the JAX compact solve as far as the two
    frameworks' compact solves lie apart (``python
    tests/torch_compact_gaps.py``), which a fixed fraction of max |x| does
    not allow for."""
    JF = pytest.importorskip("nsol_tpu.ops.pallas.fused")
    shape = (16, 16) if reg == "TK1" else (6, 8, 10)
    b = _problem(shape, 5)
    kw = dict(reg=reg, iter_max=6)
    jexact = JF.make_fused_tikhonov_solver(shape, np.eye(len(shape)),
                                           interpret=True, **kw)
    jsolve = JF.make_fused_tikhonov_solver(shape, np.eye(len(shape)),
                                           interpret=True, **COMPACT, **kw)
    solve = T.make_fused_tikhonov_solver(shape, np.eye(len(shape)),
                                         **COMPACT, **kw)
    got = interop.to_numpy(solve(interop.to_torch(b, "cpu"),
                                 interop.to_torch(b, "cpu"),
                                 ALPHAS, SCALES))
    gap = band = 0.0
    for k, (a, c) in enumerate(zip(ALPHAS, SCALES)):
        want = np.asarray(jsolve(b, b, a, data_loss_scale=c))
        exact = np.asarray(jexact(b, b, a, data_loss_scale=c))
        gap = max(gap, float(np.abs(got[k] - want).max()))
        band = max(band, float(np.abs(want - exact).max()))
    assert np.isfinite(got).all() and 0.0 < gap <= band


# ------------------------------------------------------------ the card --

@pytest.mark.cuda
@pytest.mark.parametrize("nconf", [1, 3])
@pytest.mark.parametrize("reg", ["TK0", "TK1"])
@pytest.mark.parametrize("compact", [False, True])
def test_one_launch_equals_the_sequence(cuda_device, compact, reg, nconf):
    """Every configuration's x bit for bit against
    ``nsol_tikhonov_solve``'s launch sequence, α and C varying, one launch
    a batch, no unit of the sequence and no plain call; twice the same
    bits."""
    shape = (24, 20, 28) if reg == "TK1" else (40, 36)
    b = torch.as_tensor(_problem(shape, 6), device=cuda_device)
    solve = T.make_fused_tikhonov_solver(shape, np.eye(len(shape)), reg=reg,
                                         iter_max=5,
                                         **(COMPACT if compact else {}))
    alphas, scales = ALPHAS[:nconf], SCALES[:nconf]
    assert solve.route == "persistent"
    want = solve.sequence(b, b, alphas, scales)
    F.reset_counts()
    got = [solve(b, b, alphas, scales) for _ in range(2)]
    torch.cuda.synchronize()
    counts = {k: v for k, v in F.launch_counts().items() if v}
    assert counts == {"tik_persistent": 2}
    assert set(F.plain_counts().values()) == {0}
    for g in got:
        assert torch.equal(g, want)


@pytest.mark.cuda
def test_route_takes_the_persistent_batch(cuda_device):
    """A batch the rule takes makes exactly one launch."""
    shape = (32, 32, 32)
    b = torch.as_tensor(_problem(shape, 7), device=cuda_device)
    solve = T.make_fused_tikhonov_solver(shape, np.eye(3), iter_max=4)
    F.reset_counts()
    solve(b, b, ALPHAS, SCALES)
    torch.cuda.synchronize()
    assert {k: v for k, v in F.launch_counts().items() if v} == {
        "tik_persistent": 1}


@pytest.mark.cuda
def test_robust_batch_launches_the_sequence(cuda_device):
    """A robust batch on a shape the rule takes makes no ``tik_persistent``
    launch but one of ``csrc/irls_persistent.cu``, and no clip; its launch
    sequence (``solve.sequence``) one entry clip a configuration (a robust
    solve has no exit clip), the same bits."""
    shape = (32, 32, 32)
    b = torch.as_tensor(_problem(shape, 8), device=cuda_device)
    solve = T.make_fused_tikhonov_solver(shape, np.eye(3), iter_max=2,
                                         data_loss="huber", irls_cg_iters=3)
    assert solve.route == "persistent"
    F.reset_counts()
    want = solve.sequence(b, b, ALPHAS, SCALES)
    torch.cuda.synchronize()
    counts = F.launch_counts()
    assert counts["tik_persistent"] == counts["irls_persistent"] == 0
    assert counts["tik_clip"] == len(ALPHAS)
    F.reset_counts()
    got = solve(b, b, ALPHAS, SCALES)
    torch.cuda.synchronize()
    assert {k: v for k, v in F.launch_counts().items() if v} == {
        "irls_persistent": 1}
    assert torch.equal(got, want)


#: ((Z, Y, X), configurations, storage) → configurations side by side on
#: an H100 (132 SMs): as many as the C rule's 32 MiB hold (Lena exact
#: 1.75 MiB a configuration: 18, then turns of equal size), at least 1, at
#: most one a block (chip_smoke.py phase 46 reads the first five on the card)
WIDTH_CASES = [(((1, 256, 256), 64, "exact"), 16),
               (((1, 256, 256), 64, "qf32"), 16),
               (((1, 256, 256), 1, "exact"), 1),
               (((1, 256, 256), 130, "exact"), 17),
               (((1, 256, 256), 19, "exact"), 10),
               (((64, 64, 64), 8, "exact"), 4),
               (((80, 80, 80), 8, "exact"), 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,width", WIDTH_CASES)
def test_side_by_side_width_on_the_card(cuda_device, case, width):
    dims, nconf, storage = case
    lens = _lengths(dims if dims[0] > 1 else dims[1:])
    assert T.persistent_shape(dims, *lens, nconf, storage)[4] == width
