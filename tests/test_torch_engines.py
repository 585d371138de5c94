"""The non-separable blur, the remaining Tikhonov engines, ``Optimize`` and
the PCA classes of ``nsol_tpu_torch`` against the JAX package, in float64
on the CPU.

* the FFT, direct (wrap, constant, ``prepadded_axes``) and FFT-normal
  blurs, 2-D and 3-D, odd and even shapes, diagonal and full covariance,
  at 1e-12, and ``make_blur_operators``' dispatch for every method;
* ``lbfgs_box``'s iterates after 5 and 30 steps at 1e-8 relative, and the
  gradients of each loss at r = 0 and at its kinks against ``jax.grad``;
* ``tikhonov_solve`` for ``lsq_linear``, ``least_squares`` and
  ``L-BFGS-B`` at 1e-8, and the scipy oracles of ``tests/test_solvers.py``
  (:607, :642) on the port;
* each ``Optimize`` method (``tests/test_optimize.py``'s cases on the
  port) and against the JAX package's;
* PCA and both RPCAs: L and S at 1e-8, eigenvalues at 1e-12.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import scipy.optimize

torch = pytest.importorskip("torch")

from nsol_tpu_torch.ops import conv as TC  # noqa: E402
from nsol_tpu_torch.ops import grad as TG  # noqa: E402
from nsol_tpu_torch.ops import kernels as TK  # noqa: E402
from nsol_tpu_torch.ops import losses as TL  # noqa: E402
from nsol_tpu_torch.optimize import Optimize  # noqa: E402
from nsol_tpu_torch import pca as TP  # noqa: E402
from nsol_tpu_torch.solvers import lbfgs as TLB  # noqa: E402
from nsol_tpu_torch.solvers import tikhonov as TT  # noqa: E402

TOL = 1e-12
FULL3 = np.array([[1.0, 0.4, 0.0], [0.4, 1.0, 0.2], [0.0, 0.2, 1.0]])
FULL2 = np.array([[1.0, 0.4], [0.4, 1.0]])
#: (covariance, shape): odd and even shapes, diagonal and full, 2-D, 3-D
BLUR_CASES = {
    "full3-odd": (0.6 * FULL3, (9, 11, 7)),
    "full3-even": (0.6 * FULL3, (10, 8, 12)),
    "full2-odd": (FULL2, (13, 11)),
    "full2-even": (FULL2, (12, 16)),
    "diag3": (np.diag([0.8, 1.2, 0.6]) ** 2, (10, 9, 8)),
    "diag2": (np.diag([1.0, 0.7]) ** 2, (11, 12)),
}


def _jnp():
    return pytest.importorskip("jax.numpy")


def _jax(module):
    return pytest.importorskip("nsol_tpu." + module)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _np(t):
    return t.detach().cpu().numpy()


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)))
                 / np.max(np.abs(np.asarray(want))))


# ----------------------------------------------------------- the blurs --

@pytest.mark.parametrize("case", sorted(BLUR_CASES))
@pytest.mark.parametrize("method", ["fft", "direct", "auto"])
def test_blur_forms_match_reference(case, method):
    jnp, JC = _jnp(), _jax("ops.conv")
    cov, shape = BLUR_CASES[case]
    x = np.random.RandomState(7).rand(*shape)
    A, At = TC.make_blur_operators(cov, shape=shape, method=method)
    JA, _ = JC.make_blur_operators(cov, shape=shape, method=method)
    assert A is At
    got = _np(A(_t(x)))
    assert got.dtype == np.float64 and got.shape == shape
    np.testing.assert_allclose(got, np.asarray(JA(jnp.asarray(x))), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("case", sorted(BLUR_CASES))
def test_normal_blur_operator_matches_reference(case):
    """The FFT normal operator with the squared spectrum (a full
    covariance) or the self-correlated factors (a diagonal one)."""
    jnp, JC = _jnp(), _jax("ops.conv")
    cov, shape = BLUR_CASES[case]
    x = np.random.RandomState(8).rand(*shape)
    got = _np(TC.make_normal_blur_operator(cov, shape=shape)(_t(x)))
    want = np.asarray(JC.make_normal_blur_operator(cov, shape=shape)(
        jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    A, _ = TC.make_blur_operators(cov, shape=shape)
    np.testing.assert_allclose(got, _np(A(A(_t(x)))), rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", ["wrap", "constant"])
@pytest.mark.parametrize("prepadded", [(), (0,)])
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_convolve_matches_reference(mode, prepadded, nd):
    """``convolve`` with a random stencil of even and odd lengths, a pad
    wider than an axis among them."""
    jnp, JC = _jnp(), _jax("ops.conv")
    rs = np.random.RandomState(9 + nd)
    x = rs.rand(*(11, 4, 7)[:nd])
    k = rs.rand(*(4, 6, 3)[:nd])
    got = _np(TC.convolve(_t(x), k, mode=mode, prepadded_axes=prepadded))
    want = np.asarray(JC.convolve(jnp.asarray(x), k, mode=mode,
                                  prepadded_axes=prepadded))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_blur_adjointness_full_covariance():
    """<Ax, y> = <x, Aᵀy> to 1e-10 for the FFT and direct forms."""
    rs = np.random.RandomState(10)
    shape = (12, 9, 10)
    x, y = _t(rs.rand(*shape)), _t(rs.rand(*shape))
    for method in ("fft", "direct"):
        A, At = TC.make_blur_operators(0.6 * FULL3, shape=shape,
                                       method=method)
        lhs, rhs = float(torch.sum(A(x) * y)), float(torch.sum(x * At(y)))
        assert abs(lhs - rhs) <= 1e-10 * abs(lhs), method


def test_make_blur_operators_dispatch():
    """auto → separable → fft (with a shape) → direct; "matmul" is the
    separable operator; the refusals are the reference's ValueErrors."""
    jnp, JC = _jnp(), _jax("ops.conv")
    x = np.random.RandomState(11).rand(12, 13)
    diag = np.diag([1.0, 0.8])
    sep = _np(TC.make_blur_operators(diag, method="separable")[0](_t(x)))
    for method in ("auto", "matmul"):
        got = _np(TC.make_blur_operators(diag, shape=x.shape,
                                         method=method)[0](_t(x)))
        np.testing.assert_array_equal(got, sep)
    direct = _np(TC.make_blur_operators(FULL2, method="direct")[0](_t(x)))
    np.testing.assert_array_equal(
        _np(TC.make_blur_operators(FULL2)[0](_t(x))), direct)
    fft = _np(TC.make_blur_operators(FULL2, shape=x.shape)[0](_t(x)))
    np.testing.assert_allclose(fft, direct, rtol=0, atol=TOL)
    for kw in (dict(method="separable"), dict(method="matmul"),
               dict(method="fft"), dict(method="nonsense", shape=x.shape)):
        with pytest.raises(ValueError):
            TC.make_blur_operators(FULL2, **kw)
    with pytest.raises(ValueError):
        JC.make_blur_operators(FULL2, method="separable")
    with pytest.raises(ValueError, match="static shape"):
        TC.make_normal_blur_operator(FULL2)
    with pytest.raises(ValueError, match="separable"):
        TC.blur_factors(FULL2)
    assert jnp is not None


def test_fft_blur_keeps_float32_and_odd_axes():
    """A float32 volume stays float32 (the spectrum is held in its real
    dtype), and an odd last axis comes back whole."""
    x = torch.rand(9, 10, 7, dtype=torch.float32)
    A, _ = TC.make_blur_operators(0.6 * FULL3, shape=x.shape)
    y = A(x)
    assert y.dtype == torch.float32 and y.shape == x.shape
    ref = A(x.double())
    assert float((y.double() - ref).abs().max()) <= 1e-6


# ------------------------------------------------------------- L-BFGS --

def _lbfgs_problem(rs):
    M = rs.rand(40, 25)
    b = M @ (rs.rand(25) - 0.3) + 0.1 * rs.randn(40)
    return M, b


@pytest.mark.parametrize("iters", [5, 30])
@pytest.mark.parametrize("loss", ["soft_l1", "cauchy", "linear"])
def test_lbfgs_box_iterates_match_reference(iters, loss):
    jnp = _jnp()
    JLB, JLF = _jax("solvers.lbfgs"), _jax("ops.losses")
    M, b = _lbfgs_problem(np.random.RandomState(12))
    Mt, bt = _t(M), _t(b)
    Mj, bj = jnp.asarray(M), jnp.asarray(b)

    def cost_t(x):
        return TL.cost_from_residual(Mt @ x - bt, loss, 0.5) \
            + 0.05 * torch.sum(x * x)

    def cost_j(x):
        return JLF.cost_from_residual(Mj @ x - bj, loss, 0.5) \
            + 0.05 * jnp.sum(x * x)

    x0 = np.random.RandomState(13).rand(25) - 0.5
    got = _np(TLB.lbfgs_box(cost_t, _t(x0), lower=0.0, iters=iters))
    want = np.asarray(JLB.lbfgs_box(cost_j, jnp.asarray(x0), lower=0.0,
                                    iters=iters))
    assert got.min() >= 0.0
    assert _rel(got, want) <= 1e-8


def test_lbfgs_box_counts_host_reads_and_keeps_the_old_point():
    """One host read a line-search trial; a point where no step decreases
    the cost (the minimum itself) is kept."""
    c = _t(np.arange(6.0))
    before = TLB.HOST_READS[0]
    x = TLB.lbfgs_box(lambda v: torch.sum((v - c) ** 2), c.clone(),
                      iters=3, max_backtracks=4)
    np.testing.assert_array_equal(_np(x), _np(c))
    # at the minimum g = 0, d = 0: every trial fails Armijo's strict test
    # at once, one read an iteration
    assert TLB.HOST_READS[0] - before == 3


@pytest.mark.parametrize("loss", sorted(TL.LOSSES))
def test_loss_gradients_at_zero_and_kinks_match_jax_grad(loss):
    """autograd of ``cost_from_residual`` against ``jax.grad`` at r = 0,
    at ±γC (huber's kink) and elsewhere, NaN where JAX gives NaN (huber's
    unused branch at r = 0: 0 · ∞)."""
    jnp = _jnp()
    import jax

    JLF = _jax("ops.losses")
    C = 0.5
    r = np.array([0.0, 1.345 * C, -1.345 * C, 0.3, -2.0, 1e-3])
    want = np.asarray(jax.grad(lambda v: JLF.cost_from_residual(
        v, loss, C))(jnp.asarray(r)))
    leaf = _t(r).requires_grad_(True)
    (got,) = torch.autograd.grad(TL.cost_from_residual(leaf, loss, C), leaf)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=TOL)
    assert np.array_equal(np.isnan(_np(got)), np.isnan(want))


# ------------------------------------------------------- tikhonov_solve --

def _tik_problem(nd=3):
    rs = np.random.RandomState(14)
    shape = (10, 9, 8) if nd == 3 else (14, 13)
    cov = 0.6 * FULL3 if nd == 3 else FULL2
    kern = TK.gaussian_kernel(cov, alpha_cut=3)
    b = ndi.convolve(rs.rand(*shape) - 0.2, kern, mode="wrap") \
        + 0.05 * rs.randn(*shape)
    return cov, shape, b


@pytest.mark.parametrize("minimizer,loss,iters", [
    ("lsq_linear", "linear", 30), ("least_squares", "soft_l1", 8),
    ("least_squares", "cauchy", 8), ("L-BFGS-B", "huber", 8),
    ("L-BFGS-B", "cauchy", 8), ("L-BFGS-B", "linear", 8)])
@pytest.mark.parametrize("nd", [2, 3])
def test_tikhonov_engines_match_reference(minimizer, loss, iters, nd):
    """The engine on the FFT blur of a full covariance, TK1, from x0 = b,
    bounds (0, ∞), against the JAX package's at 1e-8 relative."""
    jnp = _jnp()
    JC, JG, JT = _jax("ops.conv"), _jax("ops.grad"), _jax(
        "solvers.tikhonov")
    cov, shape, b = _tik_problem(nd)
    A, _ = TC.make_blur_operators(cov, shape=shape)
    JA, _ = JC.make_blur_operators(cov, shape=shape)
    got = _np(TT.tikhonov_solve(A, A, TG.gradient, TG.gradient_adjoint,
                                _t(b), 0.0, _t(b), 0.05, data_loss=loss,
                                minimizer=minimizer, iter_max=iters))
    want = np.asarray(JT.tikhonov_solve(
        JA, JA, JG.gradient, JG.gradient_adjoint, jnp.asarray(b), 0.0,
        jnp.asarray(b), 0.05, data_loss=loss, minimizer=minimizer,
        iter_max=iters))
    assert np.all(np.isfinite(got)) and got.min() >= 0.0
    assert _rel(got, want) <= 1e-8


def test_tikhonov_engines_refuse_as_reference():
    ident = lambda z: z  # noqa: E731
    with pytest.raises(ValueError, match="lsq_linear minimizer"):
        TT.tikhonov_solve(ident, ident, ident, ident, torch.ones(3), 0.0,
                          torch.ones(3), 0.1, data_loss="huber",
                          minimizer="lsq_linear")


def _oracle_system(shape, rng, bias, noise):
    cov = np.eye(2)
    kern = TK.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(2))
    b = ndi.convolve(rng.rand(*shape) - bias, kern, mode="wrap") \
        + noise * rng.randn(*shape)
    n = b.size

    def A_flat(v):
        return ndi.convolve(v.reshape(shape), kern, mode="wrap").reshape(-1)

    rows = np.stack([A_flat(e) for e in np.eye(n)], axis=1)
    return cov, b, rows


def test_lsq_linear_matches_scipy_oracle():
    """``tests/test_solvers.py:607`` on the port: projected FISTA against
    scipy.optimize.lsq_linear on the bounded augmented system, the bound
    active."""
    rng = np.random.RandomState(0)
    shape, alpha = (12, 14), 0.05
    cov, b, rows = _oracle_system(shape, rng, 0.4, 0.0)
    n = b.size
    aug = np.vstack([rows, np.sqrt(alpha) * np.eye(n)])
    rhs = np.concatenate([b.reshape(-1), np.zeros(n)])
    res = scipy.optimize.lsq_linear(aug, rhs, bounds=(0, np.inf))
    A, At = TC.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                   method="fft")
    ident = lambda z: z  # noqa: E731
    x = _np(TT.tikhonov_solve(A, At, ident, ident, _t(b), 0.0,
                              torch.zeros(shape, dtype=torch.float64),
                              alpha, minimizer="lsq_linear", iter_max=400))

    def objective(v):
        return 0.5 * np.sum((aug @ v.reshape(-1) - rhs) ** 2)

    assert x.min() >= 0.0
    assert objective(x) <= objective(res.x) * 1.005


@pytest.mark.parametrize("loss,tol", [("soft_l1", 1.0 + 1e-6),
                                      ("cauchy", 1.0 + 1e-5)])
def test_least_squares_matches_scipy_oracle(loss, tol):
    """``tests/test_solvers.py:642`` on the port: the robust loss over the
    whole augmented residual against scipy's TRF."""
    rng = np.random.RandomState(1)
    shape, alpha, scale = (10, 12), 0.05, 0.5
    cov, b, rows = _oracle_system(shape, rng, 0.0, 0.3)
    n = b.size
    aug = np.vstack([rows, np.sqrt(alpha) * np.eye(n)])
    rhs = np.concatenate([b.reshape(-1), np.zeros(n)])
    x0 = np.clip(b.reshape(-1), 0, None)
    res = scipy.optimize.least_squares(
        lambda v: aug @ v - rhs, x0, method="trf", loss=loss,
        f_scale=scale, bounds=(0, np.inf))
    A, At = TC.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                   method="fft")
    ident = lambda z: z  # noqa: E731
    x = _np(TT.tikhonov_solve(A, At, ident, ident, _t(b), 0.0,
                              _t(x0.reshape(shape)), alpha, data_loss=loss,
                              data_loss_scale=scale,
                              minimizer="least_squares", iter_max=300))

    def objective(v):
        r = torch.as_tensor(aug @ v.reshape(-1) - rhs)
        return 0.5 * float(torch.sum(TL.LOSSES[loss](r * r, f_scale=scale)))

    assert x.min() >= 0.0
    assert objective(x) <= objective(res.x) * tol


# ------------------------------------------------------------- Optimize --

def _dense(M):
    Mt = _t(M)
    return (lambda v: Mt @ v), (lambda y: Mt.T @ y)


def test_optimize_lsmr_and_cg_solve():
    """``tests/test_optimize.py``'s lsmr and cg cases on the port."""
    rng = np.random.RandomState(0)
    M = rng.rand(30, 20)
    x_true = rng.rand(20)
    A, At = _dense(M)
    x = _np(Optimize.lsmr(A, At, _t(M @ x_true), iter_max=200))
    np.testing.assert_allclose(x, x_true, atol=1e-7)
    Q = rng.rand(15, 15)
    Q = Q.T @ Q + 5 * np.eye(15)
    x_true = rng.rand(15)
    Qt = _t(Q)
    x = _np(Optimize.cg(lambda v: Qt @ v, _t(Q @ x_true), iter_max=100))
    np.testing.assert_allclose(x, x_true, atol=1e-8)


def test_optimize_nnls_projects_and_matches_scipy():
    """``tests/test_optimize.py``'s two nnls cases on the port."""
    rng = np.random.RandomState(1)
    M = rng.rand(25, 10)
    A, At = _dense(M)
    assert _np(Optimize.nnls(A, At, _t(rng.rand(25)), iter_max=100)).min() \
        >= 0
    M = rng.rand(30, 12)
    b = M @ (rng.rand(12) - 0.6) + 0.05 * rng.randn(30)
    _, r_scipy = scipy.optimize.nnls(M, b)
    A, At = _dense(M)
    x = _np(Optimize.nnls(A, At, _t(b), iter_max=40, cg_iters=12))
    assert x.min() >= 0 and np.linalg.norm(M @ x - b) <= r_scipy * 1.001


def test_optimize_minimize_and_least_squares():
    """``tests/test_optimize.py``'s minimize and least_squares cases on the
    port."""
    rng = np.random.RandomState(2)
    c = _t(rng.rand(12))
    x = Optimize.minimize(lambda v: torch.sum((v - c) ** 2),
                          torch.zeros(12, dtype=torch.float64), iter_max=100)
    np.testing.assert_allclose(_np(x), _np(c), atol=1e-5)
    M = rng.rand(20, 8)
    b = M @ np.abs(rng.rand(8))
    A, _ = _dense(M)
    x = Optimize.least_squares(lambda v: A(v) - _t(b),
                               torch.zeros(8, dtype=torch.float64),
                               bounds=(0, np.inf), iter_max=200)
    np.testing.assert_allclose(M @ _np(x), b, atol=1e-4)


@pytest.mark.parametrize("method", ["lsmr", "cg", "nnls", "least_squares",
                                    "minimize"])
def test_optimize_matches_reference(method):
    jnp = _jnp()
    JO = _jax("optimize").Optimize
    rng = np.random.RandomState(3)
    M = rng.randn(30, 20)
    b = M @ (rng.rand(20) - 0.3) + 0.05 * rng.randn(30)
    Q = M.T @ M + 5 * np.eye(20)
    Mt, bt, Qt = _t(M), _t(b), _t(Q)
    Mj, bj, Qj = jnp.asarray(M), jnp.asarray(b), jnp.asarray(Q)
    z = np.zeros(20)
    if method == "lsmr":
        got = Optimize.lsmr(lambda v: Mt @ v, lambda y: Mt.T @ y, bt,
                            iter_max=15)
        want = JO.lsmr(lambda v: Mj @ v, lambda y: Mj.T @ y, bj, iter_max=15)
    elif method == "cg":
        got = Optimize.cg(lambda v: Qt @ v, Mt.T @ bt, iter_max=15)
        want = JO.cg(lambda v: Qj @ v, Mj.T @ bj, iter_max=15)
    elif method == "nnls":
        got = Optimize.nnls(lambda v: Mt @ v, lambda y: Mt.T @ y, bt,
                            iter_max=10, cg_iters=6)
        want = JO.nnls(lambda v: Mj @ v, lambda y: Mj.T @ y, bj,
                       iter_max=10, cg_iters=6)
    elif method == "least_squares":
        got = Optimize.least_squares(lambda v: Mt @ v - bt, _t(z),
                                     bounds=(0, np.inf), iter_max=15)
        want = JO.least_squares(lambda v: Mj @ v - bj, jnp.asarray(z),
                                bounds=(0, np.inf), iter_max=15)
    else:
        got = Optimize.minimize(lambda v: torch.sum((Mt @ v - bt) ** 2),
                                _t(z), iter_max=15)
        want = JO.minimize(lambda v: jnp.sum((Mj @ v - bj) ** 2),
                           jnp.asarray(z), iter_max=15)
    assert _rel(_np(got), np.asarray(want)) <= 1e-8


# ------------------------------------------------------------------ PCA --

def _low_rank_plus_sparse(seed=7, m=40, n=30, rank=3, density=0.05):
    r = np.random.RandomState(seed)
    L = r.randn(m, rank) @ r.randn(rank, n)
    S = np.zeros((m, n))
    mask = r.rand(m, n) < density
    S[mask] = r.randn(mask.sum()) * 10
    return L, S


@pytest.mark.parametrize("dim", [2, 3])
def test_pca_matches_reference(dim):
    JPCA = _jax("pca")
    rng = np.random.RandomState(20 + dim)
    pts = rng.randn(500, dim) * np.array([5.0, 2.0, 0.5][:dim]) + 1.5
    pca = TP.PrincipalComponentAnalysis(pts, device="cpu")
    pca.run()
    ref = JPCA.PrincipalComponentAnalysis(pts)
    ref.run()
    np.testing.assert_allclose(pca.get_eigval(), ref.get_eigval(), rtol=0,
                               atol=TOL * np.max(ref.get_eigval()))
    np.testing.assert_allclose(pca.get_mean(), ref.get_mean(), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(pca.get_cov(), ref.get_cov(), rtol=0,
                               atol=TOL * np.max(np.abs(ref.get_cov())))
    # eigenvectors agree up to sign; the frame is right-handed
    for i in range(dim):
        assert abs(abs(np.dot(pca.get_eigvec()[:, i],
                              ref.get_eigvec()[:, i])) - 1) <= 1e-10
    if dim == 3:
        v = pca.get_eigvec()
        np.testing.assert_allclose(np.cross(v[:, 0], v[:, 1]), v[:, 2],
                                   atol=1e-12)
    with pytest.raises(IOError):
        TP.PrincipalComponentAnalysis(rng.rand(10, 5), device="cpu")


def test_alm_rpca_matches_reference():
    JPCA = _jax("pca")
    L_true, S_true = _low_rank_plus_sparse()
    D = L_true + S_true
    L, S = TP.AlmRobustPrincipalComponentAnalysis(D, device="cpu").fit(
        max_iter=1000)
    JL, JS = JPCA.AlmRobustPrincipalComponentAnalysis(D).fit(max_iter=1000)
    assert np.linalg.norm(L - L_true) / np.linalg.norm(L_true) < 0.1
    np.testing.assert_allclose(L, JL, rtol=0, atol=1e-8 * np.abs(JL).max())
    np.testing.assert_allclose(S, JS, rtol=0, atol=1e-8 * np.abs(JS).max())


def test_admm_rpca_matches_reference():
    JPCA = _jax("pca")
    L_true, S_true = _low_rank_plus_sparse()
    A = L_true + S_true
    h = TP.AdmmRobustPrincipalComponentAnalysis(A, device="cpu").run()
    ref = JPCA.AdmmRobustPrincipalComponentAnalysis(A).run()
    assert h["admm_iter"] == ref["admm_iter"]
    for k in ("X1_admm", "X2_admm", "X3_admm"):
        np.testing.assert_allclose(h[k], ref[k], rtol=0,
                                   atol=1e-8 * np.abs(ref[k]).max())
    for k in ("objval", "r_norm", "s_norm", "eps_pri", "eps_dual"):
        np.testing.assert_allclose(h[k], ref[k], rtol=1e-8, atol=0)
