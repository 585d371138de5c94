"""Parity of the port's operator layer (nsol_tpu_torch.ops) with nsol_tpu.

Inputs are made with numpy from a seed and handed to both packages, the
port's through ``nsol_tpu_torch.interop``. float64 throughout (JAX x64 as
tests/conftest.py sets it); tolerances are the bars of tests/test_ops.py:
1e-12 for operator values, 1e-10 for adjointness.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from nsol_tpu.ops import conv as JC  # noqa: E402
from nsol_tpu.ops import grad as JG  # noqa: E402
from nsol_tpu.ops import kernels as JK  # noqa: E402
from nsol_tpu.ops import prox as JP  # noqa: E402
from nsol_tpu_torch import interop  # noqa: E402
from nsol_tpu_torch.ops import conv as TC  # noqa: E402
from nsol_tpu_torch.ops import grad as TG  # noqa: E402
from nsol_tpu_torch.ops import kernels as TK  # noqa: E402
from nsol_tpu_torch.ops import prox as TP  # noqa: E402

CASES = {
    2: ((19, 23), np.diag([0.8, 1.3]) ** 2, np.array([1.25, 0.8])),
    3: ((9, 12, 11), np.diag([0.8, 1.0, 1.3]) ** 2,
        np.array([1.25, 0.8, 2.0])),
}


def _t(a):
    return interop.to_torch(a, "cpu")


def _np(t):
    return interop.to_numpy(t)


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_gaussian_kernel_is_identical(ndim):
    cov = np.diag([1.3, 2.1, 0.8][:ndim]) ** 2
    spacing = np.array([1.5, 2.0, 0.7][:ndim])
    cov_arg = cov if ndim > 1 else cov[0, 0]
    np.testing.assert_array_equal(
        TK.gaussian_kernel(cov_arg, alpha_cut=3, spacing=spacing),
        JK.gaussian_kernel(cov_arg, alpha_cut=3, spacing=spacing))


@pytest.mark.parametrize("ndim", [2, 3])
def test_separable_wrap_conv_matches_reference_and_ndimage(ndim, rng):
    shape, cov, spacing = CASES[ndim]
    kern = JK.gaussian_kernel(cov, alpha_cut=3, spacing=spacing)
    factors = JC.separable_factors(kern)
    x = rng.rand(*shape)
    got = _np(TC.separable_convolve_fn(
        interop.blur_factors(factors, ndim, "cpu"))(_t(x)))
    want = np.asarray(JC.separable_convolve_fn(factors)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, ndi.convolve(x, kern, mode="wrap"),
                               rtol=0, atol=1e-12)
    A, A_adj = TC.make_blur_operators(cov, alpha_cut=3, spacing=spacing)
    np.testing.assert_allclose(_np(A(_t(x))), got, rtol=0, atol=1e-12)


@pytest.mark.parametrize("ndim", [2, 3])
def test_normal_blur_taps_equal_two_blurs(ndim, rng):
    shape, cov, spacing = CASES[ndim]
    A, A_adj = TC.make_blur_operators(cov, alpha_cut=3, spacing=spacing)
    nA = TC.make_normal_blur_operator(cov, alpha_cut=3, spacing=spacing)
    v = _t(rng.rand(*shape))
    np.testing.assert_allclose(_np(nA(v)), _np(A_adj(A(v))), rtol=0,
                               atol=1e-12)
    # the reference's separable branch (shape=None keeps the roll path)
    jnA = JC.make_normal_blur_operator(cov, alpha_cut=3, spacing=spacing)
    np.testing.assert_allclose(_np(nA(v)),
                               np.asarray(jnA(jnp.asarray(_np(v)))),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("ndim", [2, 3])
def test_gradient_family_matches_reference_and_is_adjoint(ndim, rng):
    shape, _, spacing = CASES[ndim]
    s = interop.spacing(spacing, ndim)
    x = rng.rand(*shape)
    y = rng.rand(ndim, *shape)
    g = TG.gradient(_t(x), s)
    np.testing.assert_allclose(_np(g), np.asarray(JG.gradient(x, s)),
                               rtol=0, atol=1e-12)
    gy = TG.gradient_adjoint(_t(y), s)
    np.testing.assert_allclose(_np(gy),
                               np.asarray(JG.gradient_adjoint(y, s)),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(TG.gradient_normal(_t(x), s)),
                               np.asarray(JG.gradient_normal(x, s)),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(TG.gradient_normal(_t(x), s)),
                               _np(TG.gradient_adjoint(g, s)),
                               rtol=0, atol=1e-12)
    np.testing.assert_almost_equal(float(torch.sum(g * _t(y))),
                                   float(torch.sum(_t(x) * gy)), decimal=10)
    for ax in range(ndim):
        np.testing.assert_allclose(
            _np(TG.forward_difference(_t(x), ax)),
            np.asarray(JG.forward_difference(jnp.asarray(x), ax)),
            rtol=0, atol=1e-12)


@pytest.mark.parametrize("ndim", [2, 3])
def test_vectorial_soft_threshold_matches_reference(ndim, rng):
    shape = CASES[ndim][0]
    t = rng.randn(ndim, *shape)
    for tau in (0.0, 0.7, 2.5):
        np.testing.assert_allclose(
            _np(TP.vectorial_soft_threshold(_t(t), tau)),
            np.asarray(JP.vectorial_soft_threshold(jnp.asarray(t), tau)),
            rtol=0, atol=1e-12)


def test_unported_blur_forms_raise():
    """The forms that raised before the non-separable blur was ported now
    run: a full covariance takes the direct form without a shape, and
    ``method="fft"`` gives the separable operator's values; the separable
    factors of a full covariance still do not exist."""
    cov = np.array([[1.0, 0.4], [0.4, 1.0]])
    x = np.random.RandomState(2).rand(12, 11)
    A, _ = TC.make_blur_operators(cov)
    np.testing.assert_allclose(
        _np(A(_t(x))), np.asarray(JC.make_blur_operators(
            cov, method="direct")[0](jnp.asarray(x))), rtol=0, atol=1e-12)
    fft, _ = TC.make_blur_operators(np.eye(2), shape=x.shape, method="fft")
    sep, _ = TC.make_blur_operators(np.eye(2))
    np.testing.assert_allclose(_np(fft(_t(x))), _np(sep(_t(x))), rtol=0,
                               atol=1e-12)
    assert TC.separable_factors(JK.gaussian_kernel(cov)) is None
    with pytest.raises(ValueError):
        TC.blur_factors(cov)


def test_interop_checks_layout_and_dtype(rng):
    x = rng.rand(4, 5, 6)
    v, w = rng.rand(3, 4, 5, 6), rng.rand(3, 4, 5, 6)
    tx, tv, tw = interop.admm_state(x, v, w, "cpu")
    assert tv.shape == (3, 4, 5, 6) and tx.dtype == torch.float64
    for a, b in zip(interop.admm_state_numpy(tx, tv, tw), (x, v, w)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        interop.admm_state(x, v[:2], w, "cpu")
    with pytest.raises(TypeError):
        interop.admm_state(x, v.astype(np.float32), w, "cpu")
    with pytest.raises(TypeError):
        interop.to_torch(np.arange(3), "cpu")
    with pytest.raises(ValueError):
        interop.blur_factors([np.ones(3) / 3] * 2, 3, "cpu")
    with pytest.raises(ValueError):
        interop.spacing([1.0, -2.0, 1.0], 3)
