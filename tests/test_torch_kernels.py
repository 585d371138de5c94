"""The port's kernel units against the Pallas kernels they replace.

On the CPU the wrappers run their plain PyTorch versions; those are held
against the Pallas kernels in interpret mode, at the tolerances of
tests/test_pallas.py. The ``cuda``-marked cases build the CUDA kernels and
hold them against the plain versions on the card; they skip on a host
without one. The GPU host has no jax, so the JAX package is imported only
inside the tests that compare with it, and the ``cuda`` cases need no
fixture of tests/conftest.py (which imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import scipy.ndimage as ndi

torch = pytest.importorskip("torch")

from nsol_tpu_torch import interop  # noqa: E402
from nsol_tpu_torch.ops.cuda import blocked as B  # noqa: E402
from nsol_tpu_torch.ops.cuda import fused as F  # noqa: E402

ANISO = (np.diag([0.8, 1.0, 1.3]) ** 2, np.array([1.25, 0.8, 2.0]))


def _pallas(module):
    """A module of the JAX package (skips where jax is absent)."""
    return pytest.importorskip("nsol_tpu.ops." + module)


def _t(a, device="cpu"):
    return interop.to_torch(np.asarray(a, np.float32), device)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def test_normal_apply_plain_matches_pallas(rng):
    """tests/test_pallas.py:219 — atol 2e-6 / rtol 1e-5."""
    shape, cov = (16, 16, 16), np.diag([1.0, 1.0, 1.0])
    v = rng.rand(*shape).astype(np.float32)
    JB = _pallas("pallas.blocked")
    want = np.asarray(JB.make_blocked_normal_operator(
        shape, cov, block=8, interpret=True)(v, 0.37))
    got = B.make_blocked_normal_operator(shape, cov)(_t(v), 0.37)
    np.testing.assert_allclose(interop.to_numpy(got), want, atol=2e-6,
                               rtol=1e-5)


def test_normal_apply_plain_rho_and_spacing_match_pallas(rng):
    """tests/test_pallas.py:241 — rho runtime, spacing in both the blur and
    the Laplacian; atol 2e-5 / rtol 1e-5."""
    shape = (24, 16, 16)
    cov, spacing = np.diag([1.5, 0.8, 0.8]), np.array([1.25, 0.8, 2.0])
    v = rng.rand(*shape).astype(np.float32)
    pallas = _pallas("pallas.blocked").make_blocked_normal_operator(
        shape, cov, spacing=spacing,
        block=8, interpret=True)
    port = B.make_blocked_normal_operator(shape, cov, spacing=spacing)
    for rho in (0.0, 1.7):
        np.testing.assert_allclose(
            interop.to_numpy(port(_t(v), rho)), np.asarray(pallas(v, rho)),
            atol=2e-5, rtol=1e-5, err_msg="rho=%g" % rho)


def test_cg_step_plain_matches_pallas(rng):
    """tests/test_pallas.py:350 — p' to 1e-6, q 2e-5/1e-5, pq rtol 1e-4."""
    shape, cov = (16, 16, 16), np.diag([1.0, 1.0, 1.0])
    r = rng.rand(*shape).astype(np.float32)
    p = rng.rand(*shape).astype(np.float32)
    pallas = _pallas("pallas.blocked").make_blocked_cg_step(
        shape, cov, block=8, interpret=True)
    port = B.make_blocked_cg_step(shape, cov)
    for beta, rho in ((0.0, 0.5), (0.83, 1.9)):
        pn_j, q_j, pq_j = pallas(r, p, beta, rho)
        pn_t, q_t, pq_t = port(_t(r), _t(p), beta, rho)
        np.testing.assert_allclose(interop.to_numpy(pn_t), np.asarray(pn_j),
                                   atol=1e-6)
        np.testing.assert_allclose(interop.to_numpy(q_t), np.asarray(q_j),
                                   atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(float(pq_t), float(pq_j), rtol=1e-4)


def test_cg_update_plain_is_the_reference_recurrence(rng):
    """x += a p, r -= a q, γ' = ‖r‖², β = γ'/γ with the zero guards of
    fused.py:365-374 (γ = 0 gives β = 0)."""
    x, r, p, q = (_t(rng.rand(6, 7, 5)) for _ in range(4))
    x0, r0 = x.clone(), r.clone()
    for gamma in (2.0, 0.0):
        scal = B.new_scalars("cpu")
        scal[B.GAMMA], scal[B.A] = gamma, 0.3
        x, r = x0.clone(), r0.clone()
        B.cg_update(x, r, p, q, scal)
        np.testing.assert_allclose(interop.to_numpy(x),
                                   interop.to_numpy(x0 + 0.3 * p), atol=1e-6)
        rn = r0 - 0.3 * q
        np.testing.assert_allclose(interop.to_numpy(r), interop.to_numpy(rn),
                                   atol=1e-6)
        g = float(torch.sum(rn * rn))
        assert float(scal[B.GAMMA]) == pytest.approx(g, rel=1e-5)
        assert float(scal[B.BETA]) == pytest.approx(
            g / gamma if gamma else 0.0, rel=1e-5)


def test_fused_admm_plain_matches_pallas_16cubed(rng):
    """tests/test_pallas.py:20 — the whole solve, 5 × 6, atol 2e-5 /
    rtol 1e-5, against the fused Pallas kernel in interpret mode."""
    shape, cov = (16, 16, 16), np.diag([1.0, 1.0, 1.0])
    kern = _pallas("kernels").gaussian_kernel(cov, alpha_cut=3,
                                              spacing=np.ones(3))
    x_true = (rng.rand(*shape) > 0.6).astype(np.float32)
    b = ndi.convolve(x_true, kern, mode="wrap").astype(np.float32)
    want = np.asarray(_pallas("pallas.fused").make_fused_admm_solver(
        shape, cov, iterations=5, iter_max=6, dtype=np.float32,
        interpret=True)(b, b, 0.01, 0.5))
    F.reset_counts()
    solve = F.make_fused_admm_solver(shape, cov, iterations=5, iter_max=6)
    got = solve(_t(b), _t(b), 0.01, 0.5)
    np.testing.assert_allclose(interop.to_numpy(got), want, atol=2e-5,
                               rtol=1e-5)
    # on CPU tensors the units ran their plain versions, in the solve's
    # sequence: Aᵀb + one residual per outer iteration, 5 × 6 CG trips
    assert F.plain_counts(F.ADMM_UNITS) == {"normal_apply_plain": 6,
                                            "cg_step_plain": 30,
                                            "cg_update_plain": 30,
                                            "admm_tail_plain": 6}
    assert set(F.launch_counts().values()) == {0}


def test_fused_admm_solver_rejects_tpu_only_and_unported_options():
    cov = np.eye(3)
    # the MXU schedules off their defaults, and compact_dirs without high3
    for opt in ({"precision": "DEFAULT"}, {"compact_dirs": True},
                {"pipelined_cg": True}):
        with pytest.raises(ValueError):
            F.make_fused_admm_solver((8, 8, 8), cov, **opt)
    with pytest.raises(TypeError):
        F.make_fused_admm_solver((8, 8, 8), cov, io_dtype="bfloat16")
    # the neutral arguments and the ported storage mode are accepted
    for opt in ({"precision": "high3"}, {"interpret": True},
                {"precision": "high3", "compact_dirs": True}):
        F.make_fused_admm_solver((8, 8, 8), cov, **opt)
    # the robust branch's compact_dirs is ported (K10b.1), with high3 only
    F.make_fused_admm_solver((8, 8, 8), cov, data_loss="huber",
                             precision="high3", compact_dirs=True)
    with pytest.raises(ValueError, match="high3"):
        F.make_fused_admm_solver((8, 8, 8), cov, data_loss="huber",
                                 compact_dirs=True)
    # record=True is ported: (x, records) with one row per iterate and x0
    b = torch.rand(8, 8, 8, dtype=torch.float64)
    x, recs = F.make_fused_admm_solver((8, 8, 8), cov, iterations=3,
                                       record=True)(b, b, 0.01, 0.5)
    assert x.shape == b.shape and set(recs) == {"Reg", "Data"}
    assert recs["Reg"].shape == recs["Data"].shape == (4,)
    solve = F.make_fused_admm_solver((8, 8, 8), cov)
    with pytest.raises(ValueError):
        solve(torch.zeros(8, 8, 9), torch.zeros(8, 8, 9), 0.01, 0.5)


# ------------------------------------------------------------ on the card --

def _random_units(device, shape, cov, spacing):
    """Every kernel unit and its plain version on identical inputs; the
    list of (kernel output, plain output) pairs."""
    rng = np.random.RandomState(0)
    st = B.Stencils.from_cov(cov, 3, spacing, device)
    v, rhs, r, x, q = (_t(rng.rand(*shape), device) for _ in range(5))
    p = _t(rng.rand(*shape) - 0.5, device)
    pairs = [(B.normal_apply(v, st.normal, st.inv_h2, 0.5),
              B.normal_apply_plain(v, st.normal, st.inv_h2, 0.5))]
    sk = torch.tensor([3.0, 0.0, 0.0, 0.83], dtype=torch.float64,
                      device=device)
    sp = sk.clone()
    pairs += list(zip(B.cg_step(r, p, sk, st.normal, st.inv_h2, 0.5),
                      B.cg_step_plain(r, p, sp, st.normal, st.inv_h2, 0.5)))
    pairs.append((sk, sp))
    xk, rk, xp, rp = x.clone(), r.clone(), x.clone(), r.clone()
    B.cg_update(xk, rk, p, q, sk)
    B.cg_update_plain(xp, rp, p, q, sp)
    pairs += [(xk, xp), (rk, rp), (sk, sp)]
    w = _t(rng.rand(3, *shape) - 0.5, device)
    xk, vk, wk = x - 0.3, torch.zeros_like(w), w.clone()
    xp, vp, wp = x - 0.3, torch.zeros_like(w), w.clone()
    pairs.append((F.admm_tail(xk, vk, wk, rhs, st.inv_h, 0.02, 0.5),
                  F.admm_tail_plain(xp, vp, wp, rhs, st.inv_h, 0.02, 0.5)))
    pairs += [(xk, xp), (vk, vp), (wk, wp)]
    return pairs


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64, 64), (37, 45, 53), (5, 40, 33)])
def test_cuda_kernels_match_plain_on_card(cuda_device, shape):
    """Kernel vs plain on the card, f32: max |Δ| ≤ 1e-5 · max |ref|."""
    pairs = _random_units(cuda_device, shape, *ANISO)
    torch.cuda.synchronize()
    for k, (got, ref) in enumerate(pairs):
        err = float((got - ref).abs().max() / ref.abs().max())
        assert err <= 1e-5, "output %d: %.3g" % (k, err)


@pytest.mark.cuda
def test_cuda_fused_solve_matches_plain_on_card(cuda_device):
    shape, cov = (32, 32, 32), np.diag([1.0, 1.0, 1.0])
    b = _t(np.random.RandomState(1).rand(*shape), cuda_device)
    solve = F.make_fused_admm_solver(shape, cov, iterations=5, iter_max=6)
    # the launch sequence's units, then the default route: one launch of
    # csrc/admm_persistent.cu, the same bits
    F.reset_counts()
    x_k = solve.sequence(b, b, 0.01, 0.5)
    assert all(n > 0 for n in F.launch_counts(F.ADMM_UNITS).values())
    assert set(F.plain_counts().values()) == {0}
    F.reset_counts()
    assert torch.equal(solve(b, b, 0.01, 0.5), x_k)
    assert {k: n for k, n in F.launch_counts().items() if n} == {
        "admm_persistent": 1}
    x_p = solve.plain(b, b, 0.01, 0.5)
    assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= 1e-4
