"""The fused primal-dual denoise as one persistent cooperative launch
(``csrc/pd_persistent.cu``): its route, its barriers, ``solve.route`` and
``solve.sequence``, and its solve on the CPU.

On the CPU the solve runs its plain versions, as before: the route only
decides what a solve on the card launches. Its rule lives in C alone
(``nsol_pd_persistent_route``): here the rule's text and constants are
read from the source and held to the table of the denoising path's
batches (Lena 256² × 1, × 8 and × 64, the 64³ phantom, 256³, Man 1024²
× 1 and × 64), and ``solve.route`` to what the library answers (a stub of
it); the plain solve is held to the JAX package's Pallas kernel in
interpret mode. The ``cuda``-marked cases hold the one launch bit for bit
(NaN-equal) to ``nsol_pd_solve``'s launch sequence on the card, and the C
rule to the same table; they skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_pd_persistent.py
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nsol_tpu_torch import interop  # noqa: E402
from nsol_tpu_torch.ops.cuda import build  # noqa: E402
from nsol_tpu_torch.ops.cuda import fused as F  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "nsol_tpu_torch", "csrc")
#: the denoising path's batches and what the rule says of them, exact and
#: compact: (label, shape, B, compact, takes the one launch)
ROUTE_TABLE = [
    ("Lena x 1", (256, 256), 1, False, True),
    ("Lena x 1 compact", (256, 256), 1, True, True),
    ("Lena x 8", (256, 256), 8, False, True),
    ("Lena x 8 compact", (256, 256), 8, True, True),
    ("Lena x 64", (256, 256), 64, False, False),
    ("Lena x 64 compact", (256, 256), 64, True, False),
    ("64^3", (64, 64, 64), 1, False, True),
    ("64^3 compact", (64, 64, 64), 1, True, True),
    ("256^3", (256, 256, 256), 1, False, False),
    ("256^3 compact", (256, 256, 256), 1, True, False),
    ("Man x 1", (1024, 1024), 1, False, True),
    ("Man x 1 compact", (1024, 1024), 1, True, True),
    ("Man x 64", (1024, 1024), 64, False, False),
    ("Man x 64 compact", (1024, 1024), 64, True, False),
]
#: (shape, α) of the CPU solves against the Pallas kernel
SHAPES = {2: (24, 16), 3: (6, 8, 10)}


def _t(a, device="cpu"):
    return interop.to_torch(np.asarray(a), device)


def _np(t):
    return interop.to_numpy(t)


def _dims(shape, nb):
    return (nb,) + (1,) * (3 - len(shape)) + tuple(shape)


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _c_body(src, signature):
    body = src[src.index(signature):]
    return body[:body.index("\n}\n")]


def _rule_constants():
    """``(voxel cap, state bytes)`` of the C rule, read from
    ``csrc/persistent.cuh``."""
    shared = _source("persistent.cuh")
    cap = re.search(r"kPersistentMaxVoxels = 1LL << (\d+);", shared)
    room = re.search(r"kSideBySideBytes = (\d+)LL << (\d+);", shared)
    assert cap and room
    return 1 << int(cap.group(1)), int(room.group(1)) << int(room.group(2))


def _rule(shape, nb, compact):
    """The C rule as its source states it: at most the voxel cap an image,
    and x, x̄, the ndim dual volumes at the state's width over the batch,
    and b, within the L2 room."""
    cap, room = _rule_constants()
    n = int(np.prod(shape))
    state = n * (nb * (2 + len(shape)) * (2 if compact else 4) + 4)
    return n <= cap and state <= room


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


class _StubLib:
    """The kernel library's rule and nothing else, answering ``answer``
    and keeping the arguments it was asked with."""

    def __init__(self, answer):
        self.answer, self.asked = answer, []

    def nsol_pd_persistent_route(self, *args):
        self.asked.append(args)
        return self.answer


# ------------------------------------------------------------ the route --

def test_rule_lives_in_c_with_the_state_it_states():
    """The C rule's body: the voxel cap shared by the persistent rules and
    the batch's state (x, x̄, ndim dual volumes at 2 or 4 bytes, and b)
    within kSideBySideBytes; the count slot continues pd.cu's units."""
    src = _source("pd_persistent.cu")
    rule = _c_body(src, "int nsol_pd_persistent_route(")
    assert "n * ((long long)B * (2 + ndim) * (compact ? 2 : 4) + 4)" in rule
    assert "n <= kPersistentMaxVoxels && state <= kSideBySideBytes" in rule
    slot = re.search(r"kPdPersistent = (\d+);", src)
    assert slot and int(slot.group(1)) == F.PD_PERSISTENT_SLOT
    assert "kPdPersistent = 3" in _source("pd.cu")
    assert F.PD_COUNTS == F.PD_PERSISTENT_SLOT + 1
    assert _rule_constants() == (F.PERSISTENT_MAX_VOXELS, 32 << 20)
    assert not hasattr(F, "pd_persistent_fits")  # no copy in Python


@pytest.mark.parametrize("label,shape,nb,compact,takes", ROUTE_TABLE,
                         ids=[r[0] for r in ROUTE_TABLE])
def test_route_table_of_the_denoising_batches(label, shape, nb, compact,
                                              takes):
    assert _rule(shape, nb, compact) is takes, label


@pytest.mark.parametrize("shape,compact", [((256, 256), False),
                                           ((256, 256), True),
                                           ((64, 64, 64), False),
                                           ((5, 40, 33), True)])
@pytest.mark.parametrize("answer", [0, 1])
def test_solver_route_reads_the_c_rule(monkeypatch, shape, compact, answer):
    """``solve.route(nb)`` asks the library's rule with (ndim, compact, B,
    Z, Y, X), a 2-D image with Z = 1, and reports its answer."""
    stub = _StubLib(answer)
    monkeypatch.setattr(build, "load", lambda: stub)
    solve = F.make_fused_pd_denoise_solver(shape, "TVL2", compact=compact)
    want = "persistent" if answer else "sequence"
    assert solve.route() == want and solve.route(8) == want
    nd = len(shape)
    assert stub.asked == [(nd, int(compact)) + _dims(shape, 1),
                          (nd, int(compact)) + _dims(shape, 8)]


@pytest.mark.parametrize("route", ["persistent", "graph", "plain"])
def test_unknown_route_refuses_before_any_build(monkeypatch, route):
    """Only ``None`` (the rule) and ``"sequence"`` exist; anything else is
    refused before the library is built or asked."""
    def no_build():
        raise AssertionError("built before the route was checked")

    monkeypatch.setattr(build, "load", no_build)
    shape = (8, 8)
    b = torch.rand(shape)
    sched = torch.zeros((4, 1, 3))
    with pytest.raises(ValueError, match="route must be None or 'sequence'"):
        F._pd_solve_cuda(b, b, sched, (1.0, 1.0), False, False, 0.1, False,
                         0.1, route=route)
    solve = F.make_fused_pd_denoise_solver(shape, "TVL2")
    assert callable(solve.sequence) and not hasattr(solve, "persistent")


@pytest.mark.parametrize("iterations,record,want", [
    (50, False, 99), (50, True, 101), (1, False, 1), (1, True, 3),
    (0, False, 0), (0, True, 1), (7, True, 15)])
def test_barriers_a_solve(iterations, record, want):
    """Two a step but the last primal step's, and with records that one
    and one after the last row: the records add one barrier in all."""
    assert F.pd_persistent_barriers(iterations, record) == want


def test_counts_name_the_launch():
    """``pd_persistent`` among the PD units and the one-launch solves;
    ``plain_counts`` of the PD units names the units' plain versions."""
    assert F.PD_UNITS[-1] == "pd_persistent"
    assert "pd_persistent" in F.PERSISTENT_UNITS
    F.reset_counts()
    assert F.launch_counts(F.PD_UNITS) == dict.fromkeys(F.PD_UNITS, 0)
    assert set(F.plain_counts(F.PD_UNITS)) == {
        "pd_dual_plain", "pd_primal_plain", "pd_record_plain"}
    sigs = build._SIGNATURES
    assert len(sigs["nsol_pd_solve_persistent"]) == len(sigs["nsol_pd_solve"])
    assert len(sigs["nsol_pd_persistent_route"]) == 6


# ------------------------------------------------ the CPU solve vs Pallas --

def _pallas_pd(shape, rtype, alg, iterations, **kw):
    pallas = pytest.importorskip("nsol_tpu.ops.pallas.fused")
    return pallas.make_fused_pd_denoise_solver(
        shape, rtype, alg_type=alg, iterations=iterations, interpret=True,
        **kw)


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("rtype,alg", [("TVL1", "ALG2"), ("TVL2", "ALG3"),
                                       ("HuberL1", "ALG2_AHMOD"),
                                       ("HuberL2", "ALG2")])
def test_cpu_solve_launches_nothing_and_matches_pallas(nd, rtype, alg):
    """tests/test_torch_pd.py's bands (atol 2e-6 / rtol 1e-5, the records
    rtol 2e-5); a CPU solve runs the plain units and launches nothing, on
    either route."""
    shape = SHAPES[nd]
    b = np.random.RandomState(22 + nd).rand(*shape).astype(np.float32)
    x_want, r_want = _pallas_pd(shape, rtype, alg, 6, record=True)(
        b, b, 0.3, 8.0)
    solve = F.make_fused_pd_denoise_solver(shape, rtype, alg_type=alg,
                                           iterations=6, record=True)
    for run in (solve, solve.sequence):
        F.reset_counts()
        x, recs = run(_t(b), _t(b), 0.3, 8.0)
        assert F.launch_counts(F.PD_UNITS) == dict.fromkeys(F.PD_UNITS, 0)
        assert F.plain_counts(F.PD_UNITS) == {
            "pd_dual_plain": 6, "pd_primal_plain": 6, "pd_record_plain": 7}
        np.testing.assert_allclose(_np(x), np.asarray(x_want), atol=2e-6,
                                   rtol=1e-5)
        for k in ("Reg", "Data"):
            np.testing.assert_allclose(_np(recs[k]), np.asarray(r_want[k]),
                                       rtol=2e-5, err_msg=k)


def test_cpu_batch_of_three_matches_pallas_vmap():
    """B = 3 α through one CPU solve, against ``jax.vmap`` of the Pallas
    kernel over α (tests/test_torch_pd.py's bands)."""
    import jax
    import jax.numpy as jnp

    shape = SHAPES[2]
    b = np.random.RandomState(31).rand(*shape).astype(np.float32)
    alphas = np.asarray([0.05, 0.3, 1.2], np.float32)
    pallas = _pallas_pd(shape, "HuberL2", "ALG3", 5, record=True)
    xs_want, r_want = jax.vmap(lambda a: pallas(b, b, a, jnp.float32(8.0)))(
        jnp.asarray(alphas))
    F.reset_counts()
    xs, recs = F.make_fused_pd_denoise_solver(
        shape, "HuberL2", alg_type="ALG3", iterations=5, record=True)(
            _t(b), _t(b), alphas, 8.0)
    assert F.launch_counts(F.PD_UNITS)["pd_persistent"] == 0
    np.testing.assert_allclose(_np(xs), np.asarray(xs_want), atol=2e-6,
                               rtol=1e-5)
    for k in ("Reg", "Data"):
        np.testing.assert_allclose(_np(recs[k]), np.asarray(r_want[k]),
                                   rtol=2e-5, err_msg=k)


# ------------------------------------------------------------- the card --

def _card_b(shape, device, seed=48, nan=False):
    b = torch.as_tensor(np.random.RandomState(seed).rand(*shape)
                        .astype(np.float32), device=device)
    if nan:
        b[:2] = float("nan")
    return b


def _nan_bits_equal(a, b):
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    a, b = a.masked_fill(nan, 0.0), b.masked_fill(nan, 0.0)
    view = torch.int64 if a.dtype == torch.float64 else torch.int32
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def _one_launch_equals_sequence(solve, args, record):
    torch.cuda.synchronize()
    F.reset_counts()
    got = solve(*args)
    torch.cuda.synchronize()
    counts = F.launch_counts(F.PD_UNITS)
    assert counts == {"pd_dual": 0, "pd_primal": 0, "pd_record": 0,
                      "pd_persistent": 1}, counts
    want = solve.sequence(*args)
    if not record:
        assert _nan_bits_equal(got, want)
        return
    assert _nan_bits_equal(got[0], want[0])
    for k in ("Reg", "Data"):
        assert _nan_bits_equal(got[1][k], want[1][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("alg", ["ALG2", "ALG2_AHMOD", "ALG3"])
@pytest.mark.parametrize("rtype", F.PD_TYPES)
def test_cuda_one_launch_is_the_sequence(cuda_device, rtype, alg, compact,
                                         record):
    """Lena's width on a 2-D image, B = 3, 12 iterations: bit for bit."""
    b = _card_b((64, 96), cuda_device)
    solve = F.make_fused_pd_denoise_solver(
        (64, 96), rtype, alg, 12, spacing=(1.25, 0.8), record=record,
        compact=compact)
    assert solve.route(3) == "persistent"
    _one_launch_equals_sequence(solve, (b, b, [0.05, 0.3, 1.2], 8.0),
                                record)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 3, 40])
@pytest.mark.parametrize("shape", [(37, 53), (12, 16, 16), (5, 40, 33)])
def test_cuda_batches_and_shapes(cuda_device, shape, nb):
    b = _card_b(shape, cuda_device, seed=nb)
    solve = F.make_fused_pd_denoise_solver(shape, "HuberL1", "ALG2", 10,
                                           record=True)
    alphas = list(np.linspace(0.05, 1.5, nb)) if nb > 1 else 0.3
    _one_launch_equals_sequence(solve, (b, b, alphas, 8.0), True)


@pytest.mark.cuda
@pytest.mark.parametrize("iterations", [0, 1, 2])
@pytest.mark.parametrize("record", [False, True])
def test_cuda_few_iterations(cuda_device, iterations, record):
    """No iteration (x, x̄ and p as the sequence's copies and memset leave
    them, row 0 of the records) and the first steps, which read x0 in
    place of those copies."""
    b = _card_b((12, 16, 16), cuda_device)
    solve = F.make_fused_pd_denoise_solver((12, 16, 16), "HuberL2", "ALG3",
                                           iterations, record=record)
    _one_launch_equals_sequence(solve, (b, b * 0.5, [0.1, 0.9], 8.0),
                                record)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["b", "x0"])
@pytest.mark.parametrize("rtype", F.PD_TYPES)
def test_cuda_nan_lands_where_the_sequence_puts_it(cuda_device, rtype,
                                                   where):
    shape = (40, 33)
    b = _card_b(shape, cuda_device)
    nan = _card_b(shape, cuda_device, nan=True)
    args = (nan, b) if where == "b" else (b, nan)
    solve = F.make_fused_pd_denoise_solver(shape, rtype, iterations=6,
                                           record=True)
    _one_launch_equals_sequence(solve, args + ([0.1, 0.5], 8.0), True)


@pytest.mark.cuda
@pytest.mark.parametrize("label,shape,nb,compact,takes", ROUTE_TABLE,
                         ids=[r[0] for r in ROUTE_TABLE])
def test_cuda_c_rule_answers_the_table(cuda_device, label, shape, nb,
                                       compact, takes):
    solve = F.make_fused_pd_denoise_solver(shape, "TVL2", compact=compact)
    assert solve.route(nb) == ("persistent" if takes else "sequence"), label
