"""Parity of the port's solver cores (cg, tikhonov ``minimizer="cg"``,
admm) with nsol_tpu in float64: the same numpy inputs through both
packages, to 1e-9 after the whole iteration."""

from functools import partial

import numpy as np
import pytest
import scipy.ndimage as ndi

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nsol_tpu.ops import conv as JC  # noqa: E402
from nsol_tpu.ops import grad as JG  # noqa: E402
from nsol_tpu.ops import kernels as JK  # noqa: E402
from nsol_tpu.solvers import admm as JA  # noqa: E402
from nsol_tpu.solvers import cg as JCG  # noqa: E402
from nsol_tpu.solvers import tikhonov as JT  # noqa: E402
from nsol_tpu_torch import interop  # noqa: E402
from nsol_tpu_torch.ops import conv as TC  # noqa: E402
from nsol_tpu_torch.ops import grad as TG  # noqa: E402
from nsol_tpu_torch.solvers import admm as TA  # noqa: E402
from nsol_tpu_torch.solvers import cg as TCG  # noqa: E402
from nsol_tpu_torch.solvers import tikhonov as TT  # noqa: E402

TOL = 1e-9


def _problem(rng, shape=(16, 16, 16), cov=np.diag([1.0, 1.0, 1.0]),
             spacing=None):
    kern = JK.gaussian_kernel(cov, alpha_cut=3, spacing=spacing)
    x_true = (rng.rand(*shape) > 0.6).astype(np.float64)
    return ndi.convolve(x_true, kern, mode="wrap")


def test_cg_matches_reference(rng):
    M = rng.rand(12, 12)
    M = M @ M.T + 12 * np.eye(12)
    b = rng.rand(12)
    x0 = rng.rand(12)
    Mt = interop.to_torch(M, "cpu")
    got = TCG.cg(lambda v: Mt @ v, interop.to_torch(b, "cpu"),
                 interop.to_torch(x0, "cpu"), iters=7)
    Mj = jnp.asarray(M)
    want = JCG.cg(lambda v: Mj @ v, jnp.asarray(b), jnp.asarray(x0), 7)
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(want),
                               rtol=0, atol=TOL)
    assert float(TCG.tree_vdot([Mt, Mt], [Mt, Mt])) == pytest.approx(
        2 * float(np.sum(M * M)))


def test_tikhonov_cg_matches_reference(rng):
    cov, spacing = np.diag([0.8, 1.3]) ** 2, np.array([1.25, 0.8])
    b = _problem(rng, (21, 17), cov, spacing)
    A, _ = TC.make_blur_operators(cov, spacing=spacing)
    B, B_adj = TG.make_gradient_operators(spacing)
    JA_, _ = JC.make_blur_operators(cov, spacing=spacing, method="separable")
    JB, JB_adj = JG.make_gradient_operators(spacing)
    b_reg = rng.rand(2, 21, 17)
    bt = interop.to_torch(b, "cpu")
    got = TT.tikhonov_solve(A, A, B, B_adj, bt, interop.to_torch(b_reg,
                                                                 "cpu"),
                            bt, 0.3, minimizer="cg", iter_max=8)
    want = JT.tikhonov_solve(JA_, JA_, JB, JB_adj, jnp.asarray(b),
                             jnp.asarray(b_reg), jnp.asarray(b), 0.3,
                             minimizer="cg", iter_max=8)
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(want),
                               rtol=0, atol=TOL)
    # "lsmr" (the augmented CGLS) and "lsq_linear" (projected FISTA) are
    # ported
    got = TT.tikhonov_solve(A, A, B, B_adj, bt, 0.0, bt, 0.3,
                            minimizer="lsmr", iter_max=8)
    want = JT.tikhonov_solve(JA_, JA_, JB, JB_adj, jnp.asarray(b), 0.0,
                             jnp.asarray(b), 0.3, minimizer="lsmr",
                             iter_max=8)
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(want),
                               rtol=0, atol=TOL)
    got = TT.tikhonov_solve(A, A, B, B_adj, bt, 0.0, bt, 0.3,
                            minimizer="lsq_linear", iter_max=8)
    want = JT.tikhonov_solve(JA_, JA_, JB, JB_adj, jnp.asarray(b), 0.0,
                             jnp.asarray(b), 0.3, minimizer="lsq_linear",
                             iter_max=8)
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(want),
                               rtol=0, atol=TOL)


def test_admm_solve_matches_reference_16cubed(rng):
    """admm_solve at 16³ for 5 × 6 iterations with the separable operators
    and the fused normal operators, recording the TV of every iterate."""
    cov = np.diag([1.0, 1.0, 1.0])
    b = _problem(rng)
    A, _ = TC.make_blur_operators(cov)
    nA = TC.make_normal_blur_operator(cov)
    B, B_adj = TG.make_gradient_operators()
    JA_, _ = JC.make_blur_operators(cov, method="separable")
    JnA = JC.make_normal_blur_operator(cov)
    JB, JB_adj = JG.make_gradient_operators()
    bt = interop.to_torch(b, "cpu")
    tv_t = lambda x: torch.sum(torch.sqrt(torch.sum(B(x) ** 2, 0)))  # noqa: E731
    tv_j = lambda x: jnp.sum(jnp.sqrt(jnp.sum(JB(x) ** 2, 0)))  # noqa: E731
    x_t, rec_t = TA.admm_solve(
        A, A, B, B_adj, bt, 0.0, bt, 0.01, 0.5, iterations=5, iter_max=6,
        minimizer="cg", normal_A=nA, normal_B=TG.gradient_normal,
        record_fn=tv_t)
    x_j, rec_j = jax.jit(partial(
        JA.admm_solve, JA_, JA_, JB, JB_adj, iterations=5, iter_max=6,
        minimizer="cg", normal_A=JnA, normal_B=JG.gradient_normal,
        record_fn=tv_j))(jnp.asarray(b), jnp.zeros((3, 16, 16, 16)),
                         jnp.asarray(b), 0.01, 0.5)
    np.testing.assert_allclose(interop.to_numpy(x_t), np.asarray(x_j),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(interop.to_numpy(rec_t["measures"]),
                               np.asarray(rec_j["measures"]), rtol=1e-12)
    # normal_M hook == separate normal operators
    x_m, _ = TA.admm_solve(
        A, A, B, B_adj, bt, 0.0, bt, 0.01, 0.5, iterations=5, iter_max=6,
        normal_M=lambda v, a: nA(v) + a * TG.gradient_normal(v))
    np.testing.assert_allclose(interop.to_numpy(x_m), interop.to_numpy(x_t),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("loss,separable", [
    ("linear", True), ("linear", False), ("huber", True), ("huber", False)])
def test_resolve_minimizer_matches_reference(loss, separable):
    cov = np.eye(3) if separable else np.array(
        [[1.0, 0.3, 0.0], [0.3, 1.0, 0.0], [0.0, 0.0, 1.0]])
    assert TT.resolve_minimizer("auto", data_loss=loss, cov=cov) == \
        JT.resolve_minimizer("auto", data_loss=loss, cov=cov)
