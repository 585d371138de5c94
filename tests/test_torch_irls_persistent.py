"""The robust IRLS sweep as one persistent cooperative launch
(``csrc/irls_persistent.cu``), for the fused robust ADMM solve and the
robust Tikhonov batch: its route, its constants, its barriers and its
solves on the CPU.

On the CPU the robust solves run their plain versions, as before: the
route only decides what a solve on the card launches.
:func:`Z.irls_persistent_fits` is held here to the robust shapes (Lena
256², 64³, 80³, a ragged volume, 2-plane and 32-plane stacks, and past
the rule 88³-256³, 1024², 2048²), to its refusals (the blocked solve's
``"io"`` storage, the tiled solve, the sweep) and to the constants of its
C rule (``nsol_robust_persistent_route``), read from the source. The
``cuda``-marked cases hold the one launch bit for bit (NaN-equal) to the
launch sequence on the card, per loss, storage and records, and its width
(the C rule ``batch_width`` over the robust slot's volumes) to the widths
measured there; they skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_irls_persistent.py
"""

import os
import re

import numpy as np
import pytest
import scipy.ndimage as ndi

torch = pytest.importorskip("torch")

from nsol_tpu_torch.ops.cuda import blocked as B  # noqa: E402
from nsol_tpu_torch.ops.cuda import fused as F  # noqa: E402
from nsol_tpu_torch.ops.cuda import robust as R  # noqa: E402
from nsol_tpu_torch.ops.cuda import tikhonov as T  # noqa: E402
from nsol_tpu_torch.ops.cuda import tiled as Z  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "nsol_tpu_torch", "csrc")
LOSSES = ("huber", "soft_l1", "cauchy", "arctan")
#: the robust shapes (a 2-D image as its (1, Y, X) view) and what the rule
#: says of them at σ = 1: the persistent sweep where none of irls_head,
#: blur_apply and weighted_apply marches (at most 2^19 voxels, or a stack
#: too thin for the marches)
ROUTE_CASES = [((256, 256), True), ((64, 64, 64), True),
               ((80, 80, 80), True), ((88, 88, 88), False),
               ((100, 100, 100), False), ((256, 256, 256), False),
               ((512, 512), True), ((1024, 1024), False),
               ((2048, 2048), False), ((2, 256, 512), True),
               ((2, 512, 1025), False), ((4, 500, 600), False),
               ((37, 45, 53), True), ((32, 128, 128), True)]
#: (α, C) of the CPU batches, both varying
ALPHAS, SCALES = [0.02, 0.3], [1.0, 0.4]
COMPACT = {"precision": "high3", "compact_dirs": True}


def _dims(shape):
    return (1,) * (3 - len(shape)) + tuple(shape)


def _blur(shape, taps=7):
    return F.taps_lengths([np.ones(taps)] * len(shape))[0]


def _problem(shape, seed):
    """A blurred random binary image with noise and a few outliers,
    float32."""
    rng = np.random.RandomState(seed)
    b = ndi.gaussian_filter((rng.rand(*shape) > 0.6).astype(np.float64), 1.0,
                            mode="wrap") + 0.05 * rng.randn(*shape)
    b[tuple(rng.randint(0, n, 3) for n in shape)] += 2.0
    return b.astype(np.float32)


def _rule_source():
    src = open(os.path.join(CSRC, "irls_persistent.cu")).read()
    rule = src[src.index("int nsol_robust_persistent_route("):]
    return src, rule[:rule.index("\n}\n")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


# ------------------------------------------------------------ the route --

@pytest.mark.parametrize("storage", Z.IRLS_PERSISTENT_STORAGE)
@pytest.mark.parametrize("shape,takes", ROUTE_CASES)
def test_route_on_the_robust_shapes(shape, takes, storage):
    assert Z.irls_persistent_fits(_dims(shape), _blur(shape),
                                  storage) is takes


def test_route_table_matches_the_c_rule():
    """The Python mirror's constants are the C source's: the voxel cap,
    the storage modes, the launch count's slot; the C rule refuses the
    marches of the same three units (``nsol_vol_route`` of irls_head,
    blur_apply and weighted_apply), and the Tikhonov batch's rule hands it
    the compact storage as the sweep's ``"dirs"``."""
    src, rule = _rule_source()
    shared = open(os.path.join(CSRC, "persistent.cuh")).read()
    cap = re.search(r"kPersistentMaxVoxels = 1LL << (\d+);", shared)
    assert cap and 1 << int(cap.group(1)) == Z.PERSISTENT_MAX_VOXELS
    assert "> kPersistentMaxVoxels) return 0;" in rule
    slot = re.search(r"kIrlsPersistent = (\d+);", src)
    assert slot and int(slot.group(1)) == R.PERSISTENT_SLOT < B.COUNTS
    assert "kRobustExact" in rule and "kRobustDirs" in rule
    for unit in ("kVolIrlsHead", "kVolBlurApply", "kVolWeightedApply"):
        assert rule.count("nsol_vol_route(%s" % unit) == 1
    assert [R.ROBUST_STORAGE.index(s) for s in Z.IRLS_PERSISTENT_STORAGE] \
        == [0, 1]
    tik = open(os.path.join(CSRC, "tikhonov_persistent.cu")).read()
    tik = tik[tik.index("int nsol_tikhonov_persistent_route("):]
    assert "storage == kStoreQf32 ? kRobustDirs : kRobustExact" \
        in tik[:tik.index("\n}\n")]
    assert "irls_persistent" in F.PERSISTENT_UNITS


def test_route_caps_the_voxels_where_no_march_binds():
    """A blur too wide for any robust march leaves the voxel cap (2^20)
    to decide: 64 × 128 × 128 takes the persistent sweep, a column more
    does not."""
    wide = _blur((1, 1, 1), 81)
    assert Z.irls_persistent_fits((64, 128, 128), wide, "exact")
    assert not Z.irls_persistent_fits((64, 128, 129), wide, "exact")
    assert 64 * 128 * 128 == Z.PERSISTENT_MAX_VOXELS


@pytest.mark.parametrize("which", ["io", "tiled", "blocked io", "sweep"])
def test_route_refuses_io_tiled_and_sweep(which):
    """The blocked solve's ``"io"`` storage, the tiled ``_zy`` solve and
    the linear sweep's flag stay on the launch sequence at a shape the
    rule takes (64³)."""
    shape = (64,) * 3
    if which == "io":
        assert not Z.irls_persistent_fits(shape, _blur(shape), "io")
    elif which == "tiled":
        solve = R._make_solver(shape, np.eye(3), 3, None, 2, 2, 3, "huber",
                               False, tiled=True)
        assert solve.route == "sequence"
    elif which == "blocked io":
        solve = R.blocked_robust_admm_solve(shape, np.eye(3),
                                            compact_dirs=True)
        assert solve.storage == "io" and solve.route == "sequence"
    else:
        assert not F.persistent_route(shape, *F.taps_lengths(
            [np.ones(7)] * 3), sweep=True, data_loss="huber")


@pytest.mark.parametrize("loss", LOSSES)
def test_admm_route_mirrors_the_robust_rule(loss):
    """``fused.persistent_route`` of a robust loss is the robust rule, in
    the robust storage (exact, dirs)."""
    for shape in ((256, 256), (64,) * 3, (100,) * 3):
        lens = F.taps_lengths([np.ones(7)] * len(shape))
        for storage in ("exact", "dirs"):
            assert F.persistent_route(_dims(shape), *lens, storage,
                                      data_loss=loss) \
                == Z.irls_persistent_fits(_dims(shape), lens[0], storage)


def test_tikhonov_route_takes_robust_losses_by_the_robust_rule():
    """``tikhonov_persistent_route`` of a robust loss: the robust rule, the
    compact batch ("qf32") as the sweep's "dirs"; no robust batch in the
    linear solve's "dirs" or "state" storage."""
    for shape in ((256, 256), (64,) * 3, (96,) * 3):
        lens = F.taps_lengths([np.ones(7)] * len(shape))
        for storage, robust in (("exact", "exact"), ("qf32", "dirs")):
            assert T.tikhonov_persistent_route(
                _dims(shape), *lens, storage, "huber") \
                == Z.irls_persistent_fits(_dims(shape), lens[0], robust)
        for storage in ("dirs", "state"):
            assert not T.tikhonov_persistent_route(_dims(shape), *lens,
                                                   storage, "cauchy")


def test_solvers_report_their_route():
    """``solve.route`` of the ADMM and Tikhonov robust solvers: the
    persistent sweep on Lena and 64³, exact or compact, the launch
    sequence past the rule."""
    eye2, eye3 = np.eye(2), np.eye(3)
    assert F.make_fused_admm_solver((256, 256), eye2,
                                    data_loss="huber").route == "persistent"
    assert F.make_fused_admm_solver((64,) * 3, eye3, data_loss="cauchy",
                                    **COMPACT).route == "persistent"
    assert F.make_fused_admm_solver((100,) * 3, eye3,
                                    data_loss="huber").route == "sequence"
    assert R.make_robust_solver((64,) * 3, eye3).route == "persistent"
    assert T.make_fused_tikhonov_solver((256, 256), eye2, reg="TK0",
                                        data_loss="huber",
                                        **COMPACT).route == "persistent"
    assert T.make_fused_tikhonov_solver((256,) * 3, eye3,
                                        data_loss="huber").route \
        == "sequence"


def test_barriers_per_solve():
    """Three a blur chain (each record row; each sweep's irls_head and
    gradient; each CG iteration's two weighted chains), one after each
    cg_update, the last with irls_step on its voxels (irls_step alone
    without CG); a batch's turns each take the same."""
    assert R.persistent_barriers(10, 3, 6) == 10 * 3 * (6 + 7 * 6)
    assert R.persistent_barriers(10, 3, 6, record=True) == 3 * 11 + 1440
    assert R.persistent_barriers(1, 5, 8) == 5 * (6 + 56)
    assert R.persistent_barriers(1, 5, 8, turns=11) == 11 * 310
    assert R.persistent_barriers(1, 2, 0) == 2 * 7
    assert R.persistent_barriers(0, 3, 6, record=True) == 3


# --------------------------------------------------------- on the CPU --

def test_cpu_solves_count_no_persistent_launch():
    """On the CPU the robust solve and the robust batch run the plain
    versions of the launch sequence's units and launch nothing, whatever
    their route."""
    shape = (9, 10, 11)
    b = torch.as_tensor(_problem(shape, 3))
    admm = F.make_fused_admm_solver(shape, np.eye(3), iterations=1,
                                    iter_max=2, data_loss="huber",
                                    irls_cg_iters=2)
    tik = T.make_fused_tikhonov_solver(shape, np.eye(3), iter_max=2,
                                       data_loss="huber", irls_cg_iters=2)
    assert admm.route == tik.route == "persistent"
    F.reset_counts()
    x = admm(b, b, 0.01, 0.5)
    xs = tik(b, b, ALPHAS, SCALES)
    assert bool(torch.isfinite(x).all()) and xs.shape == (2,) + shape
    assert set(F.launch_counts().values()) == {0}
    assert F.plain_counts(("weighted_apply",))["weighted_apply_plain"] \
        == 2 * 2 + 2 * 2 * 2


@pytest.mark.parametrize("route", ["graph", "persistent"])
def test_unknown_route_refuses_before_any_build(route):
    """Only the rule's route (``None``) and ``"sequence"`` exist: no caller
    forces the one launch. Any other route raises before it builds or
    launches anything (so here, on the CPU, too)."""
    shape = (6, 7, 8)
    st = B.Stencils.from_cov(np.eye(3))
    b = torch.as_tensor(_problem(shape, 4))
    with pytest.raises(ValueError, match="route"):
        R._robust_solve_cuda(st, b, b, 0.5, 2, 2, 3, "huber", 1.0,
                             route=route)
    with pytest.raises(ValueError, match="route"):
        T._tik_solve_cuda(st, b, b, ALPHAS, SCALES, "TK1", "huber", 2, 3,
                          route=route)
    assert not hasattr(R.make_robust_solver(shape, np.eye(3)), "persistent")


# ------------------------------------------------------------ the card --

#: shapes of the card's cases: a volume of threads with two voxels of a
#: pass and an image
CARD_SHAPES = ((24, 20, 28), (40, 36))


def _nan_equal(a, b):
    """NaN at the same entries, the same bits elsewhere (signed zeros
    too)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a.masked_fill(nan, 0.0).view(torch.int32),
        b.masked_fill(nan, 0.0).view(torch.int32))


def _launches_once(solve, args, kwargs, n=2):
    """``n`` calls of ``solve``: their outputs, each one
    ``irls_persistent`` launch and nothing else."""
    F.reset_counts()
    got = [solve(*args, **kwargs) for _ in range(n)]
    torch.cuda.synchronize()
    assert {k: v for k, v in F.launch_counts().items() if v} == {
        "irls_persistent": n}
    assert set(F.plain_counts().values()) == {0}
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("loss", LOSSES)
def test_one_launch_equals_the_sequence(cuda_device, loss, compact, record):
    """x and the records bit for bit against ``nsol_robust_admm_solve``'s
    launch sequence, one launch a solve, no unit of the sequence and no
    plain call; twice the same bits."""
    shape = CARD_SHAPES[record]
    b = torch.as_tensor(_problem(shape, 6), device=cuda_device)
    solve = F.make_fused_admm_solver(shape, np.eye(len(shape)), iterations=3,
                                     iter_max=2, data_loss=loss,
                                     irls_cg_iters=4, record=record,
                                     **(COMPACT if compact else {}))
    assert solve.route == "persistent"
    kw = dict(data_loss_scale=0.6, record_dls=0.8)
    want = solve.sequence(b, b, 0.01, 0.5, **kw)
    for g in _launches_once(solve, (b, b, 0.01, 0.5), kw):
        if record:
            assert _nan_equal(g[0], want[0])
            for k in ("Reg", "Data"):
                assert _nan_equal(g[1][k], want[1][k])
        else:
            assert _nan_equal(g, want)


@pytest.mark.cuda
@pytest.mark.parametrize("nconf", [1, 3, 40])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("reg", ["TK0", "TK1"])
def test_batch_equals_the_sequence(cuda_device, reg, compact, nconf):
    """Every configuration's x bit for bit against ``nsol_tikhonov_solve``'s
    robust launch sequence, α and C varying, one launch a batch (40: more
    than one turn of configurations side by side)."""
    shape = CARD_SHAPES[reg == "TK0"]
    b = torch.as_tensor(_problem(shape, 7), device=cuda_device)
    solve = T.make_fused_tikhonov_solver(shape, np.eye(len(shape)), reg=reg,
                                         iter_max=3, data_loss="cauchy",
                                         irls_cg_iters=4,
                                         **(COMPACT if compact else {}))
    assert solve.route == "persistent"
    alphas = list(np.linspace(0.01, 0.5, nconf))
    scales = list(np.linspace(0.3, 2.0, nconf))
    want = solve.sequence(b, b, alphas, scales)
    for g in _launches_once(solve, (b, b, alphas, scales), {}):
        assert _nan_equal(g, want)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["b", "x0"])
@pytest.mark.parametrize("kind", ["admm", "tikhonov"])
def test_nan_inputs_equal_the_sequence(cuda_device, kind, where):
    """A NaN in b or in x0: NaN where the launch sequence has it, its bits
    elsewhere."""
    shape = (40, 36)
    b = torch.as_tensor(_problem(shape, 8), device=cuda_device)
    x0 = b.clone()
    (b if where == "b" else x0)[5, 7] = float("nan")
    if kind == "admm":
        solve = F.make_fused_admm_solver(shape, np.eye(2), iterations=2,
                                         iter_max=2, data_loss="huber",
                                         irls_cg_iters=3)
        args = (b, x0, 0.01, 0.5)
    else:
        solve = T.make_fused_tikhonov_solver(shape, np.eye(2), iter_max=2,
                                             data_loss="huber",
                                             irls_cg_iters=3)
        args = (b, x0, ALPHAS, SCALES)
    want = solve.sequence(*args)
    assert bool(torch.isnan(want).any())
    for g in _launches_once(solve, args, {}):
        assert _nan_equal(g, want)


#: ((Z, Y, X), configurations, storage, regulariser) → configurations side
#: by side on an H100 (132 SMs): as many as the C rule's 32 MiB hold over
#: the robust slot's ten volumes (Lena exact 2.5 MiB a configuration: 12,
#: dirs 2.25 MiB: 14; 64³ exact 10 MiB: 3), in turns of equal size
#: (chip_smoke.py phase 47 reads them on the card)
WIDTH_CASES = [(((1, 256, 256), 1, "exact", "TK1"), 1),
               (((1, 256, 256), 8, "exact", "TK1"), 8),
               (((1, 256, 256), 130, "exact", "TK1"), 12),
               (((1, 256, 256), 130, "dirs", "TK1"), 13),
               (((64, 64, 64), 8, "exact", "TK0"), 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,width", WIDTH_CASES)
def test_side_by_side_width_on_the_card(cuda_device, case, width):
    dims, nconf, storage, reg = case
    blur = _blur(dims if dims[0] > 1 else dims[1:])
    assert R.persistent_shape(dims, blur, nconf, storage, reg)[4] == width
