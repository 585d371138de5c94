"""The port's elementwise units against the JAX package's own expressions.

``cg_direction`` (the "apply" CG's ``p = r + β·p``, with its deferred
bfloat16-state form) and ``tik_clip`` (the Tikhonov box projection) run on
``csrc/stream.cuh``'s 16-byte vector streams; ``irls_step`` (``x = max(x +
xk, 0)``) shares their NaN-keeping clip. On the CPU the wrappers run their
plain versions, which are held here to the expressions the JAX package
writes (``nsol_tpu/ops/pallas/blocked.py:1535-1541``; ``jnp.maximum`` at
``fused.py:622, 812, 853, 877``) at ragged lengths and with NaN, ±inf and
±0. The ``cuda``-marked cases hold the kernels to their plain versions on
the card at the same lengths, on views whose storage offset breaks 16-byte
alignment and in place (``ops/cuda/stream_cases.py``, which
``chip_smoke.py`` runs too); they skip on a host without a card:

    python -m pytest --noconftest -m cuda tests/test_torch_elementwise.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nsol_tpu_torch.ops.cuda import robust as R  # noqa: E402
from nsol_tpu_torch.ops.cuda import stream_cases as SC  # noqa: E402
from nsol_tpu_torch.ops.cuda import tikhonov as TK  # noqa: E402
from nsol_tpu_torch.ops.cuda import tiled as T  # noqa: E402

SHAPES = SC.SHAPES
#: the three instances of cg_direction by storage: the "apply" CG's exact
#: and compact_dirs storage (q None, the plain form) and state_dtype=
#: bfloat16 (the deferred form)
FORMS = {"exact": "cg_direction", "bf16_p": "cg_direction[bf16]",
         "state": "cg_direction[state]"}
#: (r, p, q) dtypes of each
STORAGES = {k: SC.DIRECTION_FORMS[f] for k, f in FORMS.items()}
A, BETA, SPECIAL = SC.A, SC.BETA, SC.SPECIAL


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _inputs(shape, storage, seed):
    """r, p, q as numpy float32, each exact in its storage dtype."""
    rng = np.random.RandomState(seed)
    r_dt, p_dt, q_dt = STORAGES[storage]
    out = []
    for dt in (r_dt, p_dt, q_dt):
        v = (rng.rand(*shape) - 0.5).astype(np.float32) * 4.0
        if dt is torch.bfloat16:
            v = torch.from_numpy(v).to(dt).float().numpy()
        out.append(None if dt is None and len(out) == 2 else v)
    return out


def _assert_close(got, want, dtype):
    """Within one ulp of the output's storage: float32's for a float32
    output (the kernel rounds r + β·p once, by an FMA, where XLA and the
    plain version round the product and the sum apart), bfloat16's for a
    bfloat16 one (a float32 ulp apart before the rounding can straddle a
    bfloat16 tie)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype is torch.bfloat16:
        ulp = SC.bf16_ulp(torch.tensor(want)).numpy()
        assert np.all(np.abs(got - want) <= ulp), \
            float(np.max(np.abs(got - want)))
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("storage", list(STORAGES))
def test_cg_direction_plain_matches_jax(shape, storage):
    """cg_direction_plain in each storage against blocked.py:1535-1541's
    ``r32 + beta * p32`` / ``to_rio(r32)``, ``to_io(r32 + beta * p32)`` in
    jnp on the same inputs."""
    jnp = pytest.importorskip("jax.numpy")
    r_dt, p_dt, q_dt = STORAGES[storage]
    r, p, q = _inputs(shape, storage, seed=len(shape) * 100 + shape[0])
    a32, beta32 = jnp.float32(A), jnp.float32(BETA)
    jbf = jnp.bfloat16
    p32 = jnp.asarray(p)
    r32 = jnp.asarray(r)
    if q is not None:  # the deferred form: cg_update left r alone
        r32 = r32 - a32 * jnp.asarray(q)
    want_p = r32 + beta32 * p32
    want_r = r32
    if p_dt is torch.bfloat16:
        want_p = want_p.astype(jbf).astype(jnp.float32)
    if r_dt is torch.bfloat16:
        want_r = want_r.astype(jbf).astype(jnp.float32)

    rt = torch.tensor(r).to(r_dt)
    pt = torch.tensor(p).to(p_dt)
    qt = None if q is None else torch.from_numpy(q).to(q_dt)
    T.cg_direction_plain(pt, rt, SC.scalars("cpu"), qt)
    assert pt.dtype == p_dt and rt.dtype == r_dt
    _assert_close(pt.float().numpy(), want_p, p_dt)
    _assert_close(rt.float().numpy(), want_r if q is not None else r, r_dt)


@pytest.mark.parametrize("in_place", [True, False], ids=["in_place", "out"])
def test_tik_clip_plain_keeps_nan_as_jnp_maximum(in_place):
    """tik_clip_plain against jnp.maximum(x, 0.0) (fused.py:812, 877): NaN
    where it has NaN, equal values elsewhere (±inf, ±0 included)."""
    jnp = pytest.importorskip("jax.numpy")
    want = np.asarray(jnp.maximum(jnp.asarray(SPECIAL), 0.0))
    x = torch.from_numpy(SPECIAL.copy())
    out = x if in_place else torch.empty_like(x)
    TK.tik_clip_plain(out, x)
    np.testing.assert_array_equal(out.numpy(), want)
    assert np.isnan(out.numpy()[0])


@pytest.mark.parametrize("xk", ["finite", "special"])
def test_irls_step_plain_keeps_nan_as_jnp_maximum(xk):
    """irls_step_plain (in place, its only form) against
    jnp.maximum(x + xk, 0.0) (fused.py:622): NaN where it has NaN (inf − inf
    included), equal values elsewhere."""
    jnp = pytest.importorskip("jax.numpy")
    x = SPECIAL.copy()
    d = np.full_like(x, 0.25) if xk == "finite" else SPECIAL[::-1].copy()
    want = np.asarray(jnp.maximum(jnp.asarray(x) + jnp.asarray(d), 0.0))
    xt = torch.from_numpy(x)
    R.irls_step_plain(xt, torch.from_numpy(d))
    np.testing.assert_array_equal(xt.numpy(), want)
    assert np.isnan(xt.numpy()).sum() == np.isnan(want).sum() >= 1


@pytest.mark.parametrize("unit", ["cg_direction", "tik_clip", "irls_step"])
def test_wrappers_take_the_plain_version_for_cpu_tensors(unit):
    """On CPU tensors each wrapper runs its plain version, which counts the
    call; the kernel's launch count does not move."""
    x = torch.from_numpy(SPECIAL[5:].copy())
    y = x.clone()
    wrapper, plain, call = {
        "cg_direction": (T.cg_direction, T.cg_direction_plain,
                         lambda: T.cg_direction(x, y, SC.scalars("cpu"))),
        "tik_clip": (TK.tik_clip, TK.tik_clip_plain,
                     lambda: TK.tik_clip(x, y)),
        "irls_step": (R.irls_step, R.irls_step_plain,
                      lambda: R.irls_step(x, y))}[unit]
    launches, calls = wrapper.launches, plain.calls
    call()
    assert plain.calls == calls + 1 and wrapper.launches == launches


# ------------------------------------------------------------ on the card --

@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("storage", list(STORAGES))
def test_cuda_cg_direction_matches_plain_on_card(cuda_device, shape,
                                                 storage):
    """The kernel against its plain version: float32 outputs within 1e-5 ·
    max |ref|, bfloat16 ones within one bfloat16 ulp; every offset pattern
    (vector or scalar path) gives the aligned call's bits."""
    assert SC.check(FORMS[storage], shape, cuda_device) == len(SC.OFFSETS)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_cuda_tik_clip_matches_plain_on_card(cuda_device, shape):
    """The kernel against its plain version, in place and out of place, at
    every offset pattern: equal values, NaN where the plain version has
    NaN (F4)."""
    assert SC.check("tik_clip", shape, cuda_device) == 2 * len(SC.OFFSETS)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_cuda_irls_step_keeps_nan_on_card(cuda_device, shape):
    """irls_step's kernel against its plain version with NaN, ±inf and ±0
    at every offset pattern: equal values, NaN where the plain version has
    NaN (F4)."""
    assert SC.check("irls_step", shape, cuda_device) == len(SC.OFFSETS)
