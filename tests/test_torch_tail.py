"""The ADMM prox/dual tail (``admm_tail``) and the PD records
(``pd_record``) against the JAX package.

On the CPU the wrappers run their plain PyTorch versions: ``admm_tail_plain``
is held against the fused solve's outer step as the JAX package's XLA path
runs it (``admm_solve``'s shrink and dual update, the next CG right-hand
side of ``tikhonov_solve``; tests/test_pallas.py:20 holds the fused Pallas
kernel to that path), at tests/test_pallas.py's tolerances, on inputs with
negative voxels, −0 and one NaN; ``pd_record_plain`` on a 3-D bfloat16
state against the Pallas kernel's ``compact=True`` records in interpret
mode. The ``cuda``-marked cases hold the one-pass ``admm_tail`` kernel
(with and without ``v``) and the ``pd_record`` march against their plain
versions on the card; they skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_tail.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nsol_tpu_torch import interop  # noqa: E402
from nsol_tpu_torch.ops.cuda import fused as F  # noqa: E402
from nsol_tpu_torch.ops.cuda import record as Rec  # noqa: E402

TAU, RHO = float(np.float32(0.01) / np.float32(0.5)), 0.5
#: a ragged volume and an image, each with anisotropic spacing
TAIL_CASES = [((7, 9, 11), (1.25, 0.8, 2.0)), ((19, 23), (0.8, 1.25))]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _tail_inputs(shape, seed):
    """x with negative voxels, three −0 and one NaN; w, Aᵀb; float32."""
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(np.float32) - 0.3
    flat = x.reshape(-1)
    flat[: flat.size // 4] = 0.25  # flat: |t| ≤ τ there
    flat[[5, 17, flat.size // 2]] = -0.0
    flat[flat.size - 4] = np.nan
    w = ((rng.rand(len(shape), *shape) - 0.5) * 0.1).astype(np.float32)
    atb = rng.rand(*shape).astype(np.float32)
    return x, w, atb


def _jax_tail(x, w, atb, spacing, init):
    """The fused solve's outer step on the JAX package's XLA path: x
    clipped, ``t = ∇x + w``, v the grouped shrink at τ, ``w = t − v``
    (solvers/admm.py:72-74; init: ``v = ∇x``, ``w = 0``, no clip,
    :53-57) and ``rhs = Aᵀb + ρ ∇ᵀ(v − w)`` (the normal equations'
    right-hand side with ``b_reg = v − w``)."""
    jnp = pytest.importorskip("jax.numpy")
    G = pytest.importorskip("nsol_tpu.ops.grad")
    P = pytest.importorskip("nsol_tpu.ops.prox")
    xj = jnp.asarray(x)
    if init:
        v = G.gradient(xj, spacing)
        w = jnp.zeros_like(v)
    else:
        xj = jnp.maximum(xj, 0.0)
        t = G.gradient(xj, spacing) + jnp.asarray(w)
        v = P.vectorial_soft_threshold(t, TAU)
        w = t - v
    rhs = jnp.asarray(atb) + RHO * G.gradient_adjoint(v - w, spacing)
    return [np.asarray(a) for a in (xj, v, w, rhs)]


@pytest.mark.parametrize("init", [True, False])
@pytest.mark.parametrize("shape,spacing", TAIL_CASES)
def test_admm_tail_plain_matches_jax_outer_step(shape, spacing, init):
    """atol 2e-5 / rtol 1e-5 (tests/test_pallas.py:20); the NaN where the
    JAX path has it."""
    x, w, atb = _tail_inputs(shape, 3)
    want = _jax_tail(x, w, atb, np.asarray(spacing), init)
    xt, wt = torch.as_tensor(x.copy()), torch.as_tensor(w.copy())
    vt = torch.zeros_like(wt)
    inv_h = tuple(float(np.float32(1.0 / s)) for s in spacing)
    rhs = F.admm_tail_plain(xt, vt, wt, torch.as_tensor(atb), inv_h, TAU, RHO,
                            init=init)
    for k, (got, ref) in enumerate(zip((xt, vt, wt, rhs), want)):
        got = interop.to_numpy(got)
        assert np.array_equal(np.isnan(got), np.isnan(ref)), "output %d" % k
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5,
                                   err_msg="output %d" % k)
    assert np.isnan(want[3]).any() and not np.isnan(want[3]).all()


def test_pd_record_plain_bf16_3d_matches_pallas_compact():
    """``pd_record_plain`` on a 3-D bfloat16 state, ℓ1 data and Huber Reg
    (HuberL1) at a runtime record γ: row 0 of the Pallas ``compact=True``
    kernel's records (the measures of the rounded x0), rtol 2e-5
    (tests/test_pallas.py:438)."""
    shape, gamma = (5, 7, 9), 0.15
    rng = np.random.RandomState(12)
    b = rng.rand(*shape).astype(np.float32)
    x0 = torch.as_tensor(rng.rand(*shape).astype(np.float32) - 0.2).to(
        torch.bfloat16)
    JF = pytest.importorskip("nsol_tpu.ops.pallas.fused")
    _, want = JF.make_fused_pd_denoise_solver(
        shape, "HuberL1", iterations=1, interpret=True, record=True,
        compact=True)(b, interop.to_numpy(x0.float()), 0.3, 8.0,
                      record_gamma=gamma)
    reg = torch.zeros((1, 2), dtype=torch.float64)
    data = torch.zeros_like(reg)
    F.pd_record_plain(x0[None], torch.as_tensor(b), reg, data, 0,
                      (1.0, 1.0, 1.0), ell1=True, huber=True, gamma=gamma)
    np.testing.assert_allclose(float(reg[0, 0]), float(want["Reg"][0]),
                               rtol=2e-5)
    np.testing.assert_allclose(float(data[0, 0]), float(want["Data"][0]),
                               rtol=2e-5)


def test_unrecorded_fused_robust_solve_computes_no_records():
    """The fused robust solve measures nothing without ``record`` (as the
    TPU kernel): ``admm_record`` runs 0 times, and x is the recorded
    solve's, bit for bit."""
    shape, cov = (6, 8, 10), np.diag([0.8, 1.0, 1.2]) ** 2
    b = torch.as_tensor(np.random.RandomState(4).rand(*shape)
                        .astype(np.float32))
    kw = dict(iterations=2, iter_max=2, irls_cg_iters=3, data_loss="huber")
    F.reset_counts()
    x = F.make_fused_admm_solver(shape, cov, **kw)(b, b, 0.01, 0.5)
    assert F.plain_counts(["admm_record"]) == {"admm_record_plain": 0}
    assert isinstance(x, torch.Tensor)
    x_rec, recs = F.make_fused_admm_solver(shape, cov, record=True, **kw)(
        b, b, 0.01, 0.5)
    assert Rec.admm_record_plain.calls == kw["iterations"] + 1
    assert torch.equal(x, x_rec) and recs["Reg"].shape == (3,)


# ------------------------------------------------------------ on the card --

def _max_rel_nan(got, ref):
    """max |Δ| / max |ref| over the finite voxels; NaN where ref has it."""
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    g, r = torch.nan_to_num(got), torch.nan_to_num(ref)
    return float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("init", [True, False])
@pytest.mark.parametrize("shape,spacing", TAIL_CASES + [
    ((64, 64, 64), (1.0, 1.0, 1.0)), ((1, 40, 36), (1.0, 1.0, 1.0)),
    ((3, 70, 130), (1.25, 0.8, 2.0)),
    # more rows than a grid's y extent (65535): two launches
    ((65600, 5), (1.0, 1.25))])
def test_cuda_admm_tail_matches_plain(cuda_device, shape, spacing, init):
    """The one-pass kernel, with v (the wrapper) against the plain version:
    max |Δ| ≤ 1e-5 · max |ref| (FMA contraction), NaN where it has it;
    without v (as the solves run it, w' into another tensor), bit for bit
    the wrapper's."""
    x, w, atb = (torch.as_tensor(a) for a in _tail_inputs(shape, 5))
    inv_h = tuple(float(np.float32(1.0 / s)) for s in spacing)
    xp, vp, wp = x.clone(), torch.zeros_like(w), w.clone()
    rp = F.admm_tail_plain(xp, vp, wp, atb, inv_h, TAU, RHO, init=init)
    dev = [t.to(cuda_device) for t in (x, w, atb)]
    xk, wk, ak = (t.clone() for t in dev)
    vk = torch.zeros_like(wk)
    rk = F.admm_tail(xk, vk, wk, ak, inv_h, TAU, RHO, init=init)
    for got, ref in ((xk, xp), (vk, vp), (wk, wp), (rk, rp)):
        assert _max_rel_nan(got.cpu(), ref) <= 1e-5
    # the solves' form (no v) gives the wrapper's bits
    xn, wn, an = (t.clone() for t in dev)
    wo = wn if init else torch.empty_like(wn)
    rn = F._admm_tail(xn, None, wn, wo, an, inv_h, TAU, RHO, init=init)
    for a, b in ((xk, xn), (wk, wo), (rk, rn)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,nb", [((37, 53), 3), ((64, 1024), 4),
                                      ((6, 45, 53), 2), ((5, 19, 24), 3)])
def test_cuda_pd_record_matches_plain(cuda_device, shape, nb, dtype):
    """The record march against its plain version, each of TV/Huber ×
    ℓ1/ℓ2: max |Δ| ≤ 1e-7 · max |ref| (chip_smoke.py's PD_RECORD_TOL: the
    per-voxel f32 terms are the plain version's and only the float64
    sums differ in their order, while a voxel dropped or counted twice
    moves a record by its share of the sum), and a second call repeats
    them bit for bit."""
    rng = np.random.RandomState(6)
    b = torch.as_tensor(rng.rand(*shape).astype(np.float32))
    x = torch.as_tensor(rng.rand(nb, *shape).astype(np.float32)).to(
        getattr(torch, dtype))
    inv_h = (0.8, 1.25, 0.5)[:len(shape)]
    for ell1 in (False, True):
        for huber in (False, True):
            reg = torch.zeros((nb, 3), dtype=torch.float64)
            data = torch.zeros_like(reg)
            F.pd_record_plain(x, b, reg, data, 1, inv_h, ell1, huber, 0.1)
            rk = torch.zeros_like(reg, device=cuda_device)
            dk = torch.zeros_like(rk)
            for t in (1, 2):
                F.pd_record(x.to(cuda_device), b.to(cuda_device), rk, dk, t,
                            inv_h, ell1, huber, 0.1)
            rk, dk = rk.cpu(), dk.cpu()
            assert torch.equal(rk[:, 1], rk[:, 2])
            assert torch.equal(dk[:, 1], dk[:, 2])
            for got, ref in ((rk[:, 1], reg[:, 1]), (dk[:, 1], data[:, 1])):
                assert float((got - ref).abs().max()
                             / ref.abs().max()) <= 1e-7
