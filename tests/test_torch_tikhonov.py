"""The port's Tikhonov solve and ADMM records against the JAX package.

The same numpy inputs, made from a seed, go through both packages: the
plain versions of the whole Tikhonov solve (TK0/TK1 × linear/huber) and
of the ADMM solve with ``record=True`` against the Pallas kernels in
interpret mode, at the tolerances of tests/test_pallas.py (:829 for K6,
:760 for the records); the record unit in float64 against the reference's
losses; the linear ADMM units on a 2-D image against their (1, Y, X)
volume view, bit for bit. The ``cuda``-marked cases hold the kernels
against their plain versions on the card and skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_tikhonov.py
"""

import numpy as np
import pytest
import scipy.ndimage as ndi

torch = pytest.importorskip("torch")

from nsol_tpu_torch import interop  # noqa: E402
from nsol_tpu_torch.ops import losses as TL  # noqa: E402
from nsol_tpu_torch.ops.kernels import gaussian_kernel  # noqa: E402
from nsol_tpu_torch.ops.cuda import blocked as B  # noqa: E402
from nsol_tpu_torch.ops.cuda import fused as F  # noqa: E402
from nsol_tpu_torch.ops.cuda import record as Rec  # noqa: E402
from nsol_tpu_torch.ops.cuda import robust as R  # noqa: E402
from nsol_tpu_torch.ops.cuda import tikhonov as T  # noqa: E402

SHAPES = [(16, 16), (8, 12, 10)]
LOSSES = ("linear", "soft_l1", "huber", "cauchy", "arctan")


def _jax(module):
    """A module of the JAX package (skips where jax is absent)."""
    return pytest.importorskip("nsol_tpu." + module)


def _t(a, device="cpu", dtype=None):
    return interop.to_torch(np.asarray(a), device, dtype)


def _problem(shape, seed=0):
    """A blurred random binary image with noise, float32, and its
    covariance."""
    rng = np.random.RandomState(seed)
    cov = np.eye(len(shape))
    kern = gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(len(shape)))
    b = ndi.convolve((rng.rand(*shape) > 0.6).astype(np.float64), kern,
                     mode="wrap") + 0.05 * rng.randn(*shape)
    return b.astype(np.float32), cov


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


# ------------------------------------------------ K6 vs the Pallas kernel --

@pytest.mark.parametrize("loss", ["linear", "huber"])
@pytest.mark.parametrize("reg", ["TK0", "TK1"])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_tikhonov_plain_matches_pallas(shape, reg, loss):
    """tests/test_pallas.py:829: the whole Tikhonov solve (plain versions
    on the CPU) against make_fused_tikhonov_solver in interpret mode, CG or
    IRLS, clip on entry and exit; atol 5e-5, rtol 1e-4."""
    JF = _jax("ops.pallas.fused")
    b, cov = _problem(shape)
    want = JF.make_fused_tikhonov_solver(
        shape, cov, reg=reg, iter_max=6, data_loss=loss, irls_cg_iters=5,
        interpret=True)(b, b, 0.05, data_loss_scale=2.0)
    F.reset_counts()
    solve = T.make_fused_tikhonov_solver(shape, cov, reg=reg, iter_max=6,
                                         data_loss=loss, irls_cg_iters=5)
    got = solve(_t(b), _t(b), 0.05, 2.0)
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(want),
                               atol=5e-5, rtol=1e-4)
    # the plain versions ran the C function's sequence: the entry clip,
    # then CG from the residual and the exit clip, or 6 IRLS sweeps
    want_calls = {"tik_clip_plain": 2 if loss == "linear" else 1}
    if loss == "linear":
        want_calls.update(normal_apply_plain=2, cg_step_plain=6,
                          cg_update_plain=6)
    else:
        want_calls.update(irls_head_plain=6, blur_apply_plain=6,
                          weighted_apply_plain=30, irls_step_plain=6,
                          cg_update_plain=30)
    calls = {k: v for k, v in F.plain_counts().items() if v}
    assert calls == want_calls
    assert set(F.launch_counts().values()) == {0}


def test_fused_tikhonov_batch_equals_one_solve_at_a_time():
    """A batch of (α, C) configurations is the configurations one by one:
    each solve starts from a fresh CG state, so nothing leaks from one
    configuration into the next."""
    b, cov = _problem((12, 14), seed=3)
    alphas, scales = [0.02, 0.5, 0.1], [1.0, 0.3, 2.0]
    for loss in ("linear", "huber"):
        solve = T.make_fused_tikhonov_solver(b.shape, cov, reg="TK1",
                                             iter_max=4, data_loss=loss,
                                             irls_cg_iters=3)
        batch = solve(_t(b), _t(b), alphas, scales)
        assert batch.shape == (3,) + b.shape
        for k, (a, c) in enumerate(zip(alphas, scales)):
            assert torch.equal(batch[k], solve(_t(b), _t(b), a, c))


def test_fused_tikhonov_rejects_tpu_only_options():
    cov = np.eye(2)
    # compact storage of the Tikhonov kernel is ported (K10b.3) and, as in
    # the reference, needs precision="high3"
    with pytest.raises(ValueError, match="high3"):
        T.make_fused_tikhonov_solver((8, 8), cov, compact_dirs=True)
    assert T.make_fused_tikhonov_solver((8, 8), cov, compact_dirs=True,
                                        precision="high3").compact
    with pytest.raises(ValueError, match="exact f32"):
        T.make_fused_tikhonov_solver((8, 8), cov, precision="DEFAULT")
    with pytest.raises(TypeError):
        T.make_fused_tikhonov_solver((8, 8), cov, io_dtype="bfloat16")
    # the neutral arguments are accepted; interpret=True runs the plain
    b = torch.rand(8, 8, dtype=torch.float64)
    s = T.make_fused_tikhonov_solver((8, 8), cov, iter_max=3,
                                     precision="high3", interpret=True)
    assert torch.equal(s(b, b, 0.1), s.plain(b, b, 0.1))
    with pytest.raises(ValueError):
        T.make_fused_tikhonov_solver((8, 8), cov, reg="TV")
    with pytest.raises(ValueError):
        T.make_fused_tikhonov_solver((8,), np.eye(1))


# ----------------------------------------- K3/K5 records vs the Pallas kernel --

@pytest.mark.parametrize("loss", ["linear", "huber"])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_admm_records_plain_match_pallas(shape, loss):
    """tests/test_pallas.py:760: the ADMM solve with record=True (plain
    versions on the CPU) against make_fused_admm_solver(record=True) in
    interpret mode: x at atol 2e-3, rtol 1e-3; the (iterations+1,) Reg
    and Data rows at rtol 2e-3, atol 2e-3·max, the Data loss at the
    runtime scale record_dls."""
    JF = _jax("ops.pallas.fused")
    b, cov = _problem(shape, seed=1)
    want_x, want = JF.make_fused_admm_solver(
        shape, cov, iterations=3, iter_max=4, data_loss=loss,
        irls_cg_iters=5, record=True, interpret=True)(
            b, b, 0.02, 0.5, data_loss_scale=0.7, record_dls=0.3)
    F.reset_counts()
    got_x, got = F.make_fused_admm_solver(
        shape, cov, iterations=3, iter_max=4, data_loss=loss,
        irls_cg_iters=5, record=True)(_t(b), _t(b), 0.02, 0.5,
                                      data_loss_scale=0.7, record_dls=0.3)
    np.testing.assert_allclose(interop.to_numpy(got_x), np.asarray(want_x),
                               atol=2e-3, rtol=1e-3)
    for m in ("Reg", "Data"):
        ref = np.asarray(want[m])
        assert got[m].shape == ref.shape == (4,)
        assert got[m].dtype == torch.float32
        np.testing.assert_allclose(interop.to_numpy(got[m]), ref, rtol=2e-3,
                                   atol=2e-3 * np.abs(ref).max(), err_msg=m)
    assert F.plain_counts(["admm_record"]) == {"admm_record_plain": 4}


@pytest.mark.parametrize("loss", LOSSES)
def test_admm_record_plain_matches_reference_measures(loss):
    """The record unit in float64: Reg = Σ√(Σ_i (D_i x/h_i)²) with the
    zero-boundary forward difference and Data = ½Σρ_C((Ax − b)²) with the
    loss's value, against the JAX package's gradient and losses, to
    1e-12; rows other than t stay as they were."""
    JG, JL = _jax("ops.grad"), _jax("ops.losses")
    jnp = pytest.importorskip("jax.numpy")
    rng = np.random.RandomState(5)
    shape, spacing = (7, 9, 11), np.array([1.25, 0.8, 2.0])
    cov = np.diag([1.3, 0.8, 1.1]) ** 2
    x, b = rng.rand(*shape) - 0.3, rng.rand(*shape)
    st = B.Stencils.from_cov(cov, 3, spacing, "cpu", torch.float64)
    reg, data = Rec.new_records(3, "cpu")
    reg.fill_(-1.0)
    data.fill_(-1.0)
    Rec.admm_record_plain(_t(x), _t(b), st.blur, st.inv_h, loss, 0.4, reg,
                          data, 1)
    kern = gaussian_kernel(cov, alpha_cut=3, spacing=spacing)
    r = ndi.convolve(x, kern, mode="wrap") - b
    g = np.asarray(JG.gradient(jnp.asarray(x), spacing))
    want_reg = np.sum(np.sqrt(np.sum(g * g, axis=0)))
    want_data = 0.5 * np.sum(np.asarray(JL.LOSSES[loss](
        jnp.asarray(r * r), f_scale=0.4)))
    np.testing.assert_allclose(float(reg[1]), want_reg, rtol=1e-12)
    np.testing.assert_allclose(float(data[1]), want_data, rtol=1e-12)
    assert float(reg[0]) == float(data[2]) == -1.0
    with pytest.raises(ValueError):
        Rec.admm_record(_t(x), _t(b), st.blur, st.inv_h, "l1", 1.0, reg,
                        data, 0)


# ---------------------------------------------- 2-D as a (1, Y, X) volume --

def test_linear_units_on_2d_image_equal_volume_view():
    """A 2-D image runs the linear ADMM units on CUDA as a (1, Y, X)
    volume with z taps [1], 1/h_z = 1/h_z² = 0. On the plain versions that
    view gives bit for bit the 2-D result: normal_apply (TK0 and TK1,
    plain and residual form), cg_step, cg_update, admm_tail (both forms),
    admm_record and tik_clip."""
    cov, spacing = np.diag([0.9, 1.2]) ** 2, np.array([1.25, 0.8])
    st = B.Stencils.from_cov(cov, 3, spacing, "cpu")
    vol = B.Stencils.from_cov(cov, 3, spacing, "cpu")
    vol.blur, vol.normal = st.blur.as_volume(), st.normal.as_volume()
    vol.inv_h, vol.inv_h2 = st.inv_h + (0.0,), st.inv_h2 + (0.0,)
    rng = np.random.RandomState(11)
    shape = (19, 23)
    ins = {k: rng.rand(*shape).astype(np.float32) - lo
           for k, lo in (("v", 0.0), ("rhs", 0.0), ("r", 0.0), ("p", 0.5),
                         ("x", 0.3), ("q", 0.5), ("b", 0.0))}
    vw = {k: rng.rand(2, *shape).astype(np.float32) - 0.5 for k in "vw"}

    def run(s, view):
        def t(a):  # a fresh copy: the units update some inputs in place
            return _t(np.array(a[None] if view else a))

        def tw(a):  # a (2, Y, X) field; its view has a zero z component
            a = np.concatenate([a, np.zeros((1,) + shape, a.dtype)]) \
                if view else a
            return _t(np.array(a[:, None] if view else a))

        out = []
        for reg in ("TK0", "TK1"):
            out.append(B.normal_apply_plain(t(ins["v"]), s.normal, s.inv_h2,
                                            0.5, reg=reg))
            sc = B.new_scalars("cpu")
            out.append(B.normal_apply_plain(t(ins["v"]), s.normal, s.inv_h2,
                                            0.5, rhs=t(ins["rhs"]),
                                            scal=sc, reg=reg))
            out.append(sc.clone())
            for first in (True, False):
                sc = torch.tensor([2.0, 0.0, 0.0, 0.7], dtype=torch.float64)
                out.extend(B.cg_step_plain(t(ins["r"]), t(ins["p"]), sc,
                                           s.normal, s.inv_h2, 0.5,
                                           first=first, reg=reg))
                out.append(sc.clone())
        sc = torch.tensor([2.0, 0.0, 0.3, 0.0], dtype=torch.float64)
        x, r = t(ins["x"]), t(ins["r"])
        B.cg_update_plain(x, r, t(ins["p"]), t(ins["q"]), sc)
        out.extend([x, r, sc])
        for init in (True, False):
            x, v, w = t(ins["x"]), tw(vw["v"]), tw(vw["w"])
            rhs = F.admm_tail_plain(x, v, w, t(ins["rhs"]), s.inv_h, 0.02,
                                    0.5, init=init)
            out.extend([x, v[:2], w[:2], rhs])
        reg_, data = Rec.new_records(1, "cpu")
        Rec.admm_record_plain(t(ins["x"]), t(ins["b"]), s.blur, s.inv_h,
                              "huber", 0.5, reg_, data, 0)
        c = torch.empty_like(t(ins["x"]))
        T.tik_clip_plain(c, t(ins["x"]))
        return out + [reg_, data, c]

    flat, view = run(st, False), run(vol, True)
    for k, (a, v) in enumerate(zip(flat, view)):
        assert torch.equal(a, v.reshape(a.shape)), "output %d" % k


def test_volume_dims_and_spacing_of_a_2d_image():
    """The kernels take a 2-D image as (1, Y, X) with 1/h_z = 0, and
    nothing but 2-D or 3-D."""
    assert B.volume_dims("t", torch.zeros(5, 7)) == (1, 5, 7)
    assert B.volume_dims("t", torch.zeros(3, 5, 7)) == (3, 5, 7)
    assert B.spacing3((0.5, 2.0)) == (0.5, 2.0, 0.0)
    with pytest.raises(ValueError):
        B.volume_dims("t", torch.zeros(4))
    taps = B.Stencils.from_cov(np.eye(2), 3, None, "cpu").blur
    assert taps.as_volume().lengths[0] == 1


# ------------------------------------------------------------ on the card --

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64, 64), (37, 45, 53), (256, 256),
                                   (37, 53)])
def test_cuda_slice_units_match_plain_on_card(cuda_device, shape):
    """The TK0/TK1 applies, admm_record and tik_clip on the card against
    their plain versions: max |Δ| ≤ 1e-5 · max |ref|."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    nd = len(shape)
    st = B.Stencils.from_cov(np.diag([1.3, 0.8, 1.1][:nd]) ** 2, 3,
                             np.array([1.25, 0.8, 2.0][:nd]), cuda_device)
    res = cs.slice_unit_cases(st, shape, cuda_device,
                              np.random.RandomState(0))
    torch.cuda.synchronize()
    for k, (rel, _) in res.items():
        assert rel <= 1e-5, (k, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["linear", "huber"])
def test_cuda_whole_solves_match_plain_on_card(cuda_device, loss):
    """nsol_tikhonov_solve (TK0/TK1, a batch of α) and the ADMM solve with
    records on the card against their plain unit sequences."""
    b, cov = _problem((37, 53), seed=2)
    bt = _t(b, cuda_device)
    for reg in ("TK0", "TK1"):
        s = T.make_fused_tikhonov_solver(b.shape, cov, reg=reg, iter_max=6,
                                         data_loss=loss, irls_cg_iters=4)
        xk, xp = s(bt, bt, [0.02, 0.5], 0.3), s.plain(bt, bt, [0.02, 0.5],
                                                     0.3)
        assert float((xk - xp).abs().max() / xp.abs().max()) <= 1e-3
    s = F.make_fused_admm_solver(b.shape, cov, iterations=4, iter_max=5,
                                 data_loss=loss, irls_cg_iters=4,
                                 record=True)
    (xk, rk), (xp, rp) = (s(bt, bt, 0.05, 0.5, 0.3, 0.7),
                          s.plain(bt, bt, 0.05, 0.5, 0.3, record_dls=0.7))
    assert float((xk - xp).abs().max() / xp.abs().max()) <= 1e-3
    for m in ("Reg", "Data"):
        assert float((rk[m] - rp[m]).abs().max() / rp[m].abs().max()) <= 1e-3


def test_record_losses_are_the_reference_losses():
    """The kernels index the losses by ``Rec.LOSS_IDS``, the order of the
    ``Loss`` enum of csrc/losses.cuh and of the port's LOSSES."""
    assert Rec.LOSS_IDS == tuple(TL.LOSSES) == LOSSES
    assert R.LOSS_IDS is Rec.LOSS_IDS
