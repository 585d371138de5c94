"""The fused ADMM solve as one persistent cooperative launch
(``csrc/admm_persistent.cu``): its route, its constants and its solve
on the CPU.

On the CPU the solve runs its plain versions, as before: the route only
decides what a solve on the card launches. :func:`F.persistent_route` is
held here to the shapes of the fused route (64³, Lena 256², 1024², 2048²,
thin stacks), to its refusals (the sweep, the bf16 ``"state"`` and
``"dirs"`` storage, a robust loss) and to the constants of its C rule
(``nsol_admm_persistent_route``), read from the source. The ``cuda``-marked
cases hold the one launch bit for bit to ``nsol_admm_solve``'s launch
sequence on the card, per storage and with and without records; they skip
without one:

    python -m pytest --noconftest -m cuda tests/test_torch_persistent.py
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nsol_tpu_torch.ops.cuda import blocked as B  # noqa: E402
from nsol_tpu_torch.ops.cuda import fused as F  # noqa: E402

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "nsol_tpu_torch", "csrc", "admm_persistent.cu")
#: the fused route's shapes (a 2-D image as its (1, Y, X) view) and what
#: the rule says of them at σ = 1: the persistent solve where no unit of
#: the launch sequence marches (at most 2^19 voxels, or a stack too thin
#: for any march)
ROUTE_CASES = [((64, 64, 64), True), ((80, 80, 80), True),
               ((88, 88, 88), False), ((96, 96, 96), False),
               ((100, 100, 100), False), ((256, 256), True),
               ((512, 512), True), ((1024, 1024), False),
               ((2048, 2048), False), ((2, 256, 512), True),
               ((2, 512, 1025), False), ((4, 500, 600), False),
               ((8, 384, 384), False), ((32, 128, 128), True)]


def _dims(shape):
    return (1,) * (3 - len(shape)) + tuple(shape)


def _lengths(shape, sigma_taps=7):
    return F.taps_lengths([np.ones(sigma_taps)] * len(shape))


def _blurred(seed, shape):
    import scipy.ndimage as ndi

    rng = np.random.RandomState(seed)
    x = (rng.rand(*shape) > 0.6).astype(np.float64)
    return ndi.gaussian_filter(x, 1.0, mode="wrap").astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


# ------------------------------------------------------------ the route --

@pytest.mark.parametrize("storage", F.PERSISTENT_STORAGE)
@pytest.mark.parametrize("shape,takes", ROUTE_CASES)
def test_route_on_the_fused_shapes(shape, takes, storage):
    assert F.persistent_route(_dims(shape), *_lengths(shape),
                              storage=storage) is takes


@pytest.mark.parametrize("kw", [dict(sweep=True), dict(storage="state"),
                                dict(storage="dirs"),
                                dict(data_loss="huber")])
def test_route_refuses_sweep_state_dirs_and_robust(kw):
    """The sweep, the bf16 state and the blocked solve's ``"dirs"`` storage
    stay on the launch sequence. The robust branch takes the robust rule
    (``csrc/irls_persistent.cu``): the one launch at 64³, the launch
    sequence past the rule (100³, whose irls_head and blur_apply
    march)."""
    robust = "data_loss" in kw
    assert F.persistent_route((64, 64, 64), *_lengths((64,) * 3),
                              **kw) is robust
    assert not F.persistent_route((100,) * 3, *_lengths((100,) * 3), **kw)


def test_route_follows_the_marches_of_wider_blurs():
    """Past 2^19 voxels the residual's ``normal_apply`` marches: the route
    refuses; a wide blur whose taps no march holds leaves 80³ to it."""
    wide = F.taps_lengths([np.ones(9)] * 3)
    assert F.persistent_route((80, 80, 80), *wide)
    assert not F.persistent_route((100, 100, 100), *wide)


def test_route_caps_the_voxels_where_no_march_binds():
    """A blur too wide for any march leaves the voxel cap, the fused
    route's scope (2^20 voxels), to decide: 64 × 128 × 128 takes the
    persistent solve, a column more does not."""
    wide = F.taps_lengths([np.ones(61)] * 3)
    assert F.persistent_route((64, 128, 128), *wide)
    assert not F.persistent_route((64, 128, 129), *wide)
    assert 64 * 128 * 128 == F.PERSISTENT_MAX_VOXELS


def test_route_table_matches_the_c_rule():
    """The Python mirror's constants are the C rule's: the voxel cap, the
    storage modes, the launch count's slot; and the C rule refuses the
    same three marches (``nsol_vol_route`` of Aᵀb's and the residual's
    ``normal_apply`` and of ``cg_step``)."""
    src = open(SOURCE).read()
    shared = open(os.path.join(os.path.dirname(SOURCE),
                               "persistent.cuh")).read()
    cap = re.search(r"kPersistentMaxVoxels = 1LL << (\d+);", shared)
    assert cap and 1 << int(cap.group(1)) == F.PERSISTENT_MAX_VOXELS
    slot = re.search(r"kAdmmPersistent = (\d+);", src)
    assert slot and int(slot.group(1)) == B.PERSISTENT_SLOT < B.COUNTS
    rule = src[src.index("int nsol_admm_persistent_route("):]
    rule = rule[:rule.index("\n}\n")]
    assert "kStoreExact" in rule and "kStoreQf32" in rule
    assert rule.count("nsol_vol_route(kVolNormalApply") == 2
    assert rule.count("nsol_vol_route(kVolCgStep") == 1
    assert [B.storage_ids(s)[1] for s in F.PERSISTENT_STORAGE] == [0, 1]


def test_solver_reports_its_route():
    """``solve.route``: what a solve on the card takes."""
    iso3, iso2 = np.eye(3), np.eye(2)
    assert F.make_fused_admm_solver((64,) * 3, iso3).route == "persistent"
    assert F.make_fused_admm_solver(
        (256, 256), iso2, precision="high3",
        compact_dirs=True).route == "persistent"
    assert F.make_fused_admm_solver((1024, 1024), iso2).route == "sequence"
    assert F.linear_admm_solver((64,) * 3, iso3, storage="state").route \
        == "sequence"
    assert F.linear_admm_solver((64,) * 3, iso3, sweep=True).route \
        == "sequence"


def test_barriers_per_solve():
    """Three a blur chain (Aᵀb, each residual and cg_step, each record
    row), one after each cg_update and each tail; none after a reduce,
    which every block forms itself."""
    assert F.persistent_barriers(50, 10) == 3 + 50 * (3 + 1 + 10 * 4)
    assert F.persistent_barriers(50, 10, record=True) == 6 + 50 * (
        3 + 1 + 3 + 10 * 4)


# --------------------------------------------------------- on the CPU --

def test_cpu_solve_counts_no_persistent_launch():
    """On the CPU the solve runs the plain versions of the launch
    sequence's units and launches nothing, whatever its route."""
    shape = (9, 10, 11)
    b = torch.as_tensor(_blurred(3, shape))
    solve = F.make_fused_admm_solver(shape, np.eye(3), iterations=2,
                                     iter_max=3)
    assert solve.route == "persistent"
    F.reset_counts()
    x = solve(b, b, 0.01, 0.5)
    assert bool(torch.isfinite(x).all())
    assert F.launch_counts()["admm_persistent"] == 0
    assert set(F.launch_counts().values()) == {0}
    assert F.plain_counts(("cg_step",))["cg_step_plain"] == 6


@pytest.mark.parametrize("kw", [dict(storage="state"), dict(storage="dirs"),
                                dict(sweep=True)])
def test_forced_persistent_route_refuses_before_any_build(kw):
    """The persistent route of a solve it does not run raises before it
    builds or launches anything (so here, on the CPU, too)."""
    shape = (6, 7, 8)
    st = B.Stencils.from_cov(np.eye(3))
    b = torch.as_tensor(_blurred(4, shape))
    with pytest.raises(ValueError, match="persistent"):
        F._solve_cuda(st, b, b, 0.01, 0.5, 2, 3, route="persistent", **kw)
    with pytest.raises(ValueError, match="route"):
        F._solve_cuda(st, b, b, 0.01, 0.5, 2, 3, route="graph")


# ------------------------------------------------------------ the card --

CARD_CASES = [((24, 20, 28), "exact", False), ((24, 20, 28), "qf32", True),
              ((40, 36), "exact", True), ((40, 36), "qf32", False),
              ((64, 80, 96), "exact", True)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,storage,record", CARD_CASES)
def test_one_launch_equals_the_sequence(cuda_device, shape, storage, record):
    """x and the records bit for bit against ``nsol_admm_solve``'s launch
    sequence (64 × 80 × 96: threads with two voxels each), one launch a
    solve, no unit of the sequence and no plain call; twice the same
    bits."""
    b = torch.as_tensor(_blurred(6, shape), device=cuda_device)
    solve = F.linear_admm_solver(shape, np.eye(len(shape)), iterations=4,
                                 iter_max=5, storage=storage, record=record)
    want = solve.sequence(b, b, 0.01, 0.5)
    F.reset_counts()
    got = [solve.persistent(b, b, 0.01, 0.5) for _ in range(2)]
    torch.cuda.synchronize()
    counts = {k: v for k, v in F.launch_counts().items() if v}
    assert counts == {"admm_persistent": 2}
    assert set(F.plain_counts().values()) == {0}
    for g in got:
        if record:
            assert torch.equal(g[0], want[0])
            for k in ("Reg", "Data"):
                assert torch.equal(g[1][k], want[1][k])
        else:
            assert torch.equal(g, want)


@pytest.mark.cuda
def test_route_takes_the_persistent_solve(cuda_device):
    """A solve the rule takes makes exactly one launch."""
    shape = (32, 32, 32)
    b = torch.as_tensor(_blurred(7, shape), device=cuda_device)
    solve = F.make_fused_admm_solver(shape, np.eye(3), iterations=3,
                                     iter_max=4)
    F.reset_counts()
    solve(b, b, 0.01, 0.5)
    torch.cuda.synchronize()
    assert {k: v for k, v in F.launch_counts().items() if v} == {
        "admm_persistent": 1}
