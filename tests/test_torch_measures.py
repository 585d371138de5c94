"""The port's similarity measures (``nsol_tpu_torch/ops/measures.py``)
against the JAX package's (``nsol_tpu/ops/measures.py``).

Every case of ``tests/test_measures.py`` runs on the same numpy inputs
through both packages in float64 and is held to 1e-12 (relative, or
absolute beside 0): the reference identities (PSNR(x, x) = ∞, NCC
identities and invariances, Dice), SAD/MAE/SSD/MSE/RMSE, SSIM, entropy,
MI and NMI, whose histograms must put every value of an integer-valued
image in the JAX package's bin. Plus the registry, ``UNDEF`` and SSIM on
an image smaller than its window.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from nsol_tpu.ops import measures as J  # noqa: E402
from nsol_tpu_torch.io import read_png  # noqa: E402
from nsol_tpu_torch import data  # noqa: E402
from nsol_tpu_torch.ops import measures as T  # noqa: E402

TOL = 1e-12


def _lena():
    return read_png(data.path("2D_Lena_256_noise.png")).astype(np.float64)


def _both(name, *arrays, **kw):
    """(port, JAX) values of measure function ``name`` on ``arrays``."""
    port = float(getattr(T, name)(*(torch.as_tensor(a) for a in arrays),
                                  **kw))
    ref = float(getattr(J, name)(*(jnp.asarray(a) for a in arrays), **kw))
    return port, ref


def _close(port, ref):
    if np.isinf(ref) or np.isnan(ref):
        assert port == ref or (np.isnan(port) and np.isnan(ref))
    else:
        assert abs(port - ref) <= TOL * max(1.0, abs(ref)), (port, ref)


def test_psnr_of_identical_images_is_infinite():
    x = _lena()
    port, ref = _both("peak_signal_to_noise_ratio", x, x)
    assert np.isinf(port) and port == ref


def test_ncc_identities():
    x = _lena()
    n = x.size
    for args, want in (((x, x), (n - 1) / n), ((x, -x), -(n - 1) / n),
                       ((x, 3.0 * x + 17.0), (n - 1) / n)):
        port, ref = _both("normalized_cross_correlation", *args)
        _close(port, ref)
        np.testing.assert_almost_equal(port, want, decimal=10)


@pytest.mark.parametrize("name", [
    "sum_of_absolute_differences", "mean_absolute_error",
    "sum_of_squared_differences", "mean_squared_error",
    "root_mean_square_error", "peak_signal_to_noise_ratio",
    "normalized_cross_correlation"])
def test_difference_measures_match_reference(name):
    rng = np.random.RandomState(42)
    x, y = rng.rand(30, 32), rng.rand(30, 32)
    _close(*_both(name, x, y))
    _close(*_both(name, x[:5, :6, None] * 7.0, y[:5, :6, None]))


def test_dice_score_matches_reference():
    a = np.zeros((20, 20), dtype=bool)
    b = np.zeros((20, 20), dtype=bool)
    a[5:15, 5:15] = True
    b[10:20, 5:15] = True
    for u, v in ((a, b), (a, a)):
        port, ref = _both("dice_score", u, v)
        assert port == ref
    np.testing.assert_almost_equal(_both("dice_score", a, b)[0], 0.5)


@pytest.mark.parametrize("name", ["shannon_entropy", "joint_entropy",
                                  "mutual_information",
                                  "normalized_mutual_information"])
def test_entropy_measures_match_reference(name):
    """On the integer-valued Lena image (values on bin edges) and on a
    noisy copy, both ways round: the histograms bin every value as
    ``jnp.histogram`` / ``jnp.histogram2d`` do."""
    x = _lena()[::4, ::4]
    y = x + np.random.RandomState(42).randn(*x.shape)
    if name == "shannon_entropy":
        cases = ((x,), (y,), (np.round(y),), (np.full((4, 4), 2.0),))
    else:
        cases = ((x, y), (y, x), (x, x), (x, np.round(y)))
    for args in cases:
        _close(*_both(name, *args))


def test_mutual_information_properties():
    x = _lena()[::4, ::4]
    y = x + np.random.RandomState(42).randn(*x.shape)
    mi_xy, _ = _both("mutual_information", x, y)
    mi_yx, _ = _both("mutual_information", y, x)
    mi_xx, _ = _both("mutual_information", x, x)
    np.testing.assert_almost_equal(mi_xy, mi_yx, decimal=8)
    assert mi_xx > mi_xy > 0
    assert _both("normalized_mutual_information", x, x)[0] > 1.5


def test_ssim_identity_and_degradation():
    x = _lena()[::2, ::2]
    noisy = x + 25.0 * np.random.RandomState(42).randn(*x.shape)
    port, ref = _both("structural_similarity", x, x)
    _close(port, ref)
    np.testing.assert_almost_equal(port, 1.0, decimal=8)
    port, ref = _both("structural_similarity", noisy, x)
    _close(port, ref)
    assert 0.0 < port < 0.9
    # 3-D, an explicit data range, and the 1-D gather of a masked interface
    vol = np.random.RandomState(1).rand(9, 10, 8)
    _close(*_both("structural_similarity", vol, vol * 0.9 + 0.05,
                  data_range=2.0))
    _close(*_both("structural_similarity", x.ravel()[:500],
                  noisy.ravel()[:500]))


def test_ssim_of_an_image_smaller_than_its_window_is_nan():
    x = np.random.RandomState(2).rand(4, 4, 4)
    port, ref = _both("structural_similarity", x, 2 * x)
    assert np.isnan(port) and np.isnan(ref)


def test_registry_matches_reference():
    assert list(T.SIMILARITY_MEASURES) == list(J.SIMILARITY_MEASURES)
    assert set(T.UNDEF) == set(J.UNDEF)
    assert all(np.isnan(v) for v in T.UNDEF.values())
    rng = np.random.RandomState(5)
    x, y = rng.rand(16, 18) * 9, rng.rand(16, 18) * 9
    for name in T.SIMILARITY_MEASURES:
        assert T.get_measure(name) is T.SIMILARITY_MEASURES[name]
        port = float(T.get_measure(name)(torch.as_tensor(x),
                                         torch.as_tensor(y)))
        _close(port, float(J.get_measure(name)(jnp.asarray(x),
                                               jnp.asarray(y))))


def test_measures_in_float32_stay_on_the_tensors_device_and_dtype():
    x = torch.rand(12, 12)
    for name, fn in T.SIMILARITY_MEASURES.items():
        v = fn(x, x * 0.5 + 0.1)
        assert v.dim() == 0 and v.dtype == torch.float32, name
