"""The port's robust (IRLS) deconvolution slice against the JAX package.

The same numpy inputs, made from a seed, go through both packages: the
solver cores in float64 (``tikhonov_solve(minimizer="irls")``, robust
``admm_solve``) to 1e-9; the plain versions of the kernel units of
``csrc/robust.cu`` and the whole solve in float32 against the Pallas
kernels in interpret mode, at the tolerances of tests/test_pallas.py
(:309, :1227, :1261, :1458). The ``cuda``-marked cases hold the kernels
against their plain versions on the card and skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_robust.py
"""

import numpy as np
import pytest
import scipy.ndimage as ndi

torch = pytest.importorskip("torch")

from nsol_tpu_torch import interop  # noqa: E402
from nsol_tpu_torch.ops import conv as TC  # noqa: E402
from nsol_tpu_torch.ops import grad as TG  # noqa: E402
from nsol_tpu_torch.ops.kernels import gaussian_kernel  # noqa: E402
from nsol_tpu_torch.ops.cuda import blocked as B  # noqa: E402
from nsol_tpu_torch.ops.cuda import fused as F  # noqa: E402
from nsol_tpu_torch.ops.cuda import robust as R  # noqa: E402
from nsol_tpu_torch.solvers import admm as TA  # noqa: E402
from nsol_tpu_torch.solvers import tikhonov as TT  # noqa: E402

TOL = 1e-9
ROBUST = ("huber", "soft_l1", "cauchy", "arctan")
ISO3 = (np.diag([1.0, 1.0, 1.0]), None)
ANISO3 = (np.diag([1.3, 0.8, 1.1]) ** 2, np.array([1.25, 0.8, 2.0]))


def _jax(module):
    """A module of the JAX package (skips where jax is absent)."""
    return pytest.importorskip("nsol_tpu." + module)


def _t(a, device="cpu", dtype=None):
    return interop.to_torch(np.asarray(a), device, dtype)


def _blurred(seed, shape, cov, spacing=None, noise=0.0):
    """A blurred random binary volume (wrap blur), plus Gaussian noise."""
    rng = np.random.RandomState(seed)
    kern = gaussian_kernel(cov, alpha_cut=3, spacing=spacing)
    b = ndi.convolve((rng.rand(*shape) > 0.6).astype(np.float64), kern,
                     mode="wrap")
    return b + noise * rng.randn(*shape)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


# --------------------------------------------------- solver cores, float64 --

def _operators(cov, spacing):
    """(port A, port grad, port grad_adj, JAX A, JAX grad, JAX grad_adj)."""
    JC, JG = _jax("ops.conv"), _jax("ops.grad")
    A, _ = TC.make_blur_operators(cov, spacing=spacing)
    Bg, Bg_adj = TG.make_gradient_operators(spacing)
    JA, _ = JC.make_blur_operators(cov, spacing=spacing, method="separable")
    JB, JB_adj = JG.make_gradient_operators(spacing)
    return A, Bg, Bg_adj, JA, JB, JB_adj


@pytest.mark.parametrize("form", ["bounds", "no_bounds", "hooks"])
def test_tikhonov_irls_matches_reference(form):
    """``minimizer="irls"`` in f64: MM sweeps, active set, masked CG and
    projection, to 1e-9 — with the box (0, ∞), without bounds, and with the
    ``normal_W``/``grad_W`` hooks."""
    jnp = pytest.importorskip("jax.numpy")
    JT, JG = _jax("solvers.tikhonov"), _jax("ops.grad")
    cov, spacing = np.diag([0.8, 1.3]) ** 2, np.array([1.25, 0.8])
    b = _blurred(1, (21, 17), cov, spacing, noise=0.1)
    A, Bg, Bg_adj, JA, JB, JB_adj = _operators(cov, spacing)
    bounds = None if form == "no_bounds" else (0.0, np.inf)
    hooks_t, hooks_j = {}, {}
    if form == "hooks":
        hooks_t = dict(
            normal_W=lambda v, w, a: A(w * A(v)) + a * TG.gradient_normal(
                v, spacing),
            grad_W=lambda x, wr, a: A(wr) + a * TG.gradient_normal(
                x, spacing))
        hooks_j = dict(
            normal_W=lambda v, w, a: JA(w * JA(v)) + a * JG.gradient_normal(
                v, spacing),
            grad_W=lambda x, wr, a: JA(wr) + a * JG.gradient_normal(
                x, spacing))
    kw = dict(data_loss="huber", data_loss_scale=0.7, minimizer="irls",
              iter_max=4, bounds=bounds, irls_cg_iters=6)
    bt = _t(b)
    got = TT.tikhonov_solve(A, A, Bg, Bg_adj, bt, 0.0, bt, 0.3, **kw,
                            **hooks_t)
    want = JT.tikhonov_solve(JA, JA, JB, JB_adj, jnp.asarray(b), 0.0,
                             jnp.asarray(b), 0.3, **kw, **hooks_j)
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(want),
                               rtol=0, atol=TOL)
    if bounds is not None:
        assert interop.to_numpy(got).min() >= 0.0
    with pytest.raises(ValueError):
        TT.tikhonov_solve(A, A, Bg, Bg_adj, bt, 0.0, bt, 0.3,
                          data_loss="huber", minimizer="cg")


@pytest.mark.parametrize("loss", ROBUST)
def test_admm_robust_matches_reference(loss):
    """Robust ``admm_solve(minimizer="irls")`` in f64 for each loss, with
    the fused Laplacian as ``normal_B`` and a non-unit loss scale: 1e-9."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    JAd, JG = _jax("solvers.admm"), _jax("ops.grad")
    cov = np.diag([1.0, 0.8, 0.9]) ** 2
    b = _blurred(2, (12, 10, 8), cov, noise=0.2)
    A, Bg, Bg_adj, JA, JB, JB_adj = _operators(cov, None)
    kw = dict(iterations=3, iter_max=3, data_loss=loss, data_loss_scale=0.6,
              minimizer="irls", irls_cg_iters=5)
    bt = _t(b)
    got, _ = TA.admm_solve(A, A, Bg, Bg_adj, bt, 0.0, bt, 0.02, 0.5,
                           normal_B=TG.gradient_normal, **kw)
    want, _ = jax.jit(lambda bb: JAd.admm_solve(
        JA, JA, JB, JB_adj, bb, jnp.zeros((3,) + b.shape), bb, 0.02, 0.5,
        normal_B=JG.gradient_normal, **kw))(jnp.asarray(b))
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(want),
                               rtol=0, atol=TOL)


def test_robust_x_does_not_depend_on_alpha():
    """The robust x-update ignores ``v − w`` (the reference's b_reg-ignoring
    quirk, kept): ``admm_solve`` and the fused solve return bit-identical
    ``x`` for α = 0.001, 0.01 and 1.0."""
    cov = np.diag([1.0, 1.0])
    b = _blurred(3, (24, 16), cov, noise=0.1)
    A, _ = TC.make_blur_operators(cov)
    Bg, Bg_adj = TG.make_gradient_operators()
    bt = _t(b)
    xs = [TA.admm_solve(A, A, Bg, Bg_adj, bt, 0.0, bt, a, 0.5, iterations=3,
                        iter_max=3, data_loss="huber", minimizer="irls",
                        irls_cg_iters=5)[0] for a in (0.001, 0.01, 1.0)]
    assert all(torch.equal(x, xs[0]) for x in xs[1:])
    solve = F.make_fused_admm_solver(b.shape, cov, iterations=3, iter_max=3,
                                     data_loss="huber", irls_cg_iters=5)
    b32 = _t(b, dtype=torch.float32)
    xs = [solve(b32, b32, a, 0.5) for a in (0.001, 0.01, 1.0)]
    assert all(torch.equal(x, xs[0]) for x in xs[1:])


# ------------------------------------------ kernel units, plain, float32 --

@pytest.mark.parametrize("case", ["iso", "aniso"])
def test_robust_operators_plain_match_pallas(case):
    """tests/test_pallas.py:1227 (and the anisotropic covariance and
    spacing of :1458): the plain ``blur_apply`` with and without the
    Laplacian and ``weighted_apply`` against the Pallas
    ``make_blocked_blur_operator``/``make_blocked_weighted_normal_operator``
    in interpret mode on (32, 16, 16), atol 2e-6 (2e-5 with spacing, as
    :241)."""
    JR = _jax("ops.pallas.robust")
    cov, spacing = ISO3 if case == "iso" else ANISO3
    atol = 2e-6 if spacing is None else 2e-5
    shape = (32, 16, 16)
    rng = np.random.RandomState(4)
    v = rng.rand(*shape).astype(np.float32)
    w = (rng.rand(*shape) * 0.9 + 0.1).astype(np.float32)
    kw = dict(spacing=spacing, interpret=True)
    ops = [(R.make_blocked_blur_operator(shape, cov, spacing=spacing),
            JR.make_blocked_blur_operator(shape, cov, **kw), (v,)),
           (R.make_blocked_blur_operator(shape, cov, spacing=spacing,
                                         with_lap=True),
            JR.make_blocked_blur_operator(shape, cov, with_lap=True, **kw),
            (v, w, 0.7)),
           (R.make_blocked_weighted_normal_operator(shape, cov,
                                                    spacing=spacing),
            JR.make_blocked_weighted_normal_operator(shape, cov, **kw),
            (v, w, 0.7))]
    for k, (port, pallas, args) in enumerate(ops):
        got = port(*[_t(a) if isinstance(a, np.ndarray) else a
                     for a in args])
        np.testing.assert_allclose(interop.to_numpy(got),
                                   np.asarray(pallas(*args)), atol=atol,
                                   err_msg="operator %d" % k)


def _unit_inputs(shape, seed=5):
    rng = np.random.RandomState(seed)
    return {
        "x": rng.rand(*shape).astype(np.float32) - 0.3,
        "b": rng.rand(*shape).astype(np.float32),
        "y": rng.rand(*shape).astype(np.float32) - 0.5,
        "r": rng.rand(*shape).astype(np.float32) - 0.5,
        "p": rng.rand(*shape).astype(np.float32) - 0.5,
        "wts": (rng.rand(*shape) * 0.9 + 0.1).astype(np.float32),
        "free": (rng.rand(*shape) > 0.3).astype(np.float32)}


def _run_units(plain, inputs, st, device, loss="cauchy", scale=0.7):
    """Every robust unit (plain versions when ``plain``, else the
    dispatching wrappers) on the same inputs: the list of outputs, CG
    scalars included."""
    t = {k: _t(a, device) for k, a in inputs.items()}
    blur = R.blur_apply_plain if plain else R.blur_apply
    head = R.irls_head_plain if plain else R.irls_head
    wapply = R.weighted_apply_plain if plain else R.weighted_apply
    step = R.irls_step_plain if plain else R.irls_step
    outs = [blur(t["y"], st.blur, st.inv_h2),
            blur(t["y"], st.blur, st.inv_h2, t["x"], 0.7)]
    scal = B.new_scalars(device)
    outs += list(blur(t["y"], st.blur, st.inv_h2, t["x"], 0.5, scal=scal))
    outs.append(scal.clone())
    outs += list(head(t["x"], t["b"], st.blur, loss, scale))
    for first in (True, False):
        scal = torch.tensor([3.0, 0.0, 0.0, 0.83], dtype=torch.float64,
                            device=device)
        outs += list(wapply(t["r"], t["p"], t["free"], t["wts"], scal,
                            st.blur, st.inv_h2, 0.5, first=first))
        outs.append(scal.clone())
    x = t["x"].clone()
    step(x, t["p"])
    outs.append(x)
    return outs


def test_units_on_2d_image_equal_volume_view():
    """A 2-D image runs on CUDA as a (1, Y, X) volume with z taps [1] and
    1/h_z² = 0. On the plain versions that view gives bit for bit the 2-D
    operators' result, so the kernels compute the 2-D problem."""
    cov, spacing = np.diag([0.9, 1.2]) ** 2, np.array([1.25, 0.8])
    st = B.Stencils.from_cov(cov, 3, spacing, "cpu")
    vol = B.Stencils.from_cov(cov, 3, spacing, "cpu")
    vol.blur = st.blur.as_volume()
    vol.inv_h2 = st.inv_h2 + (0.0,)
    inputs = _unit_inputs((19, 23))
    flat = _run_units(True, inputs, st, "cpu")
    view = _run_units(True, {k: a[None] for k, a in inputs.items()}, vol,
                      "cpu")
    for k, (a, v) in enumerate(zip(flat, view)):
        assert torch.equal(a, v.reshape(a.shape)), "output %d" % k
    assert vol.blur.lengths[0] == 1 and vol.blur.as_volume() is vol.blur


@pytest.mark.parametrize("loss,scale", [("huber", 1.0), ("soft_l1", 0.3)])
def test_fused_robust_plain_matches_pallas(loss, scale):
    """tests/test_pallas.py:309: the port's robust fused solve (plain
    versions on the CPU) on (24, 16) against the fused Pallas kernel in
    interpret mode, 3 × 3 sweeps × 5 CG, atol 2e-5 / rtol 1e-5."""
    jnp = pytest.importorskip("jax.numpy")
    JF = _jax("ops.pallas.fused")
    shape, cov = (24, 16), np.diag([0.8, 0.8]) ** 2
    b = _blurred(6, shape, cov).astype(np.float32)
    want = JF.make_fused_admm_solver(
        shape, cov, iterations=3, iter_max=3, data_loss=loss,
        irls_cg_iters=5, dtype=jnp.float32, interpret=True)(
            b, b, 0.02, 0.5, data_loss_scale=scale)
    F.reset_counts()
    solve = F.make_fused_admm_solver(shape, cov, iterations=3, iter_max=3,
                                     data_loss=loss, irls_cg_iters=5)
    got = solve(_t(b), _t(b), 0.02, 0.5, data_loss_scale=scale)
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(want),
                               atol=2e-5, rtol=1e-5)
    # the plain versions ran in the solve's sequence: per sweep one head,
    # one gradient, one step and 5 CG trips
    assert F.plain_counts(F.ROBUST_UNITS) == {
        "blur_apply_plain": 9, "irls_head_plain": 9,
        "weighted_apply_plain": 45, "cg_update_plain": 45,
        "irls_step_plain": 9}
    assert set(F.launch_counts().values()) == {0}


@pytest.mark.parametrize("loss,case", [("huber", "iso"), ("cauchy", "iso"),
                                       ("huber", "aniso")])
def test_blocked_robust_plain_matches_pallas(loss, case):
    """tests/test_pallas.py:1261 and :1458: ``blocked_robust_admm_solve`` on
    (32, 16, 16), 4 × 3 sweeps × 5 CG, against the Pallas one in interpret
    mode: atol 5e-6. The entry clip is left out on both sides, so x0 = b
    with negative voxels runs the same path."""
    JR = _jax("ops.pallas.robust")
    shape = (32, 16, 16)
    cov = ISO3[0] if case == "iso" else ANISO3[0]
    b = _blurred(7, shape, cov, noise=0.3).astype(np.float32)
    assert b.min() < 0.0
    want = JR.blocked_robust_admm_solve(
        shape, cov, iterations=4, iter_max=3, irls_cg_iters=5,
        data_loss=loss, interpret=True)(b, b, 0.01, 0.5, 1.0)
    solve = R.blocked_robust_admm_solve(shape, cov, iterations=4, iter_max=3,
                                        irls_cg_iters=5, data_loss=loss)
    got = solve(_t(b), _t(b), 0.01, 0.5, 1.0)
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(want),
                               atol=5e-6)


@pytest.mark.parametrize("shape", [(24, 16), (12, 10, 8)])
def test_plain_solve_without_tv_chain_is_bit_identical(shape):
    """The C solve leaves out the outer TV prox/dual chain, since no output
    reads it: the plain solve with and without it returns the same ``x``
    bit for bit."""
    cov = np.diag([1.0] * len(shape))
    b = _t(_blurred(8, shape, cov, noise=0.1), dtype=torch.float32)
    solve = R.make_robust_solver(shape, cov, iterations=3, iter_max=2,
                                 irls_cg_iters=4, data_loss="arctan")
    assert torch.equal(solve.plain(b, b, 0.05, 0.5, 0.8),
                       solve.plain(b, b, 0.05, 0.5, 0.8, chain=False))


def test_robust_entry_points_reject_tpu_only_and_unported_options():
    cov = np.eye(3)
    # the MXU/VMEM schedule forms are taken at their defaults only (and a
    # precision whose result is the exact f32 one); a storage option the
    # JAX package's builder does not take is an unexpected argument
    for opt, err, msg in (({"precision": "DEFAULT"}, ValueError, "exact f32"),
                          ({"block": 8}, ValueError, "default"),
                          ({"compact_dirs": True}, TypeError, "unexpected")):
        with pytest.raises(err, match=msg):
            R.make_blocked_weighted_normal_operator((8, 8, 8), cov, **opt)
        with pytest.raises(err, match=msg):
            R.make_blocked_blur_operator((8, 8, 8), cov, **opt)
    with pytest.raises(TypeError, match="unexpected"):
        R.make_blocked_blur_operator((8, 8, 8), cov, io_dtype="bfloat16")
    # the compact storage of the robust kernels is ported (K10b.2), the
    # per-shard window form's io_dtype too (K10b.6)
    assert R.blocked_robust_admm_solve((8, 8, 8), cov,
                                       compact_dirs=True).storage == "io"
    R.make_blocked_weighted_normal_operator((8, 8, 8), cov,
                                            io_dtype="bfloat16")
    window = R.make_blocked_weighted_normal_operator(
        (8, 8, 8), cov, prepadded=True, io_dtype="bfloat16")
    v = torch.rand((8 + 2 * window.halo, 8, 8))
    assert window(v, v, 0.5, 0).dtype == torch.bfloat16
    with pytest.raises(TypeError):
        R.blocked_robust_admm_solve((8, 8, 8), cov, n_bufs=2)
    # the neutral arguments pass; interpret=True runs the plain versions
    b3 = torch.rand(8, 8, 8, dtype=torch.float64)
    s = R.blocked_robust_admm_solve((8, 8, 8), cov, iterations=1,
                                    iter_max=1, irls_cg_iters=2,
                                    interpret=True, precision="high3")
    assert torch.equal(s(b3, b3, 0.01, 0.5), s.plain(b3, b3, 0.01, 0.5))
    # prepadded=True (the sharded per-shard form, K9b) on the whole
    # volume's wrap prepad at row0 = 0 equals the wrap form
    w3 = b3 + 0.5
    for wrap, pre, args in (
            (R.make_blocked_blur_operator((8, 8, 8), cov, with_lap=True),
             R.make_blocked_blur_operator((8, 8, 8), cov, with_lap=True,
                                          prepadded=True), (b3, w3)),
            (R.make_blocked_weighted_normal_operator((8, 8, 8), cov),
             R.make_blocked_weighted_normal_operator(
                 (8, 8, 8), cov, prepadded=True, interpret=True),
             (b3, w3))):
        ext = [a[np.arange(-pre.halo, 8 + pre.halo) % 8] for a in args]
        np.testing.assert_allclose(pre(*ext, 0.7, 0).numpy(),
                                   wrap(*args, 0.7).numpy(), atol=1e-12)
    with pytest.raises(ValueError):
        R.blocked_robust_admm_solve((8, 8), np.eye(2))
    with pytest.raises(ValueError):
        R.make_robust_solver((8, 8), np.eye(2), data_loss="linear")
    # record=True is ported for the robust branch too
    b = torch.rand(8, 8, dtype=torch.float64)
    x, recs = F.make_fused_admm_solver((8, 8), np.eye(2), iterations=2,
                                       iter_max=2, data_loss="huber",
                                       record=True)(b, b, 0.01, 0.5)
    assert x.shape == b.shape and recs["Data"].shape == (3,)
    with pytest.raises(ValueError):
        R.irls_head(torch.zeros(4, 4), torch.zeros(4, 4),
                    B.Stencils.from_cov(np.eye(2)).blur, "l2", 1.0)


# ------------------------------------------------------------------- CLI --

def _cli(tmp_path, obs, out, extra):
    from nsol_tpu_torch.cli import run_deconvolution

    return run_deconvolution.main(
        ["--observation", obs, "--result", out, "--solver", "ADMM",
         "--reconstruction-type", "TVL2", "--data-loss", "huber",
         "--alpha", "0.02", "--blur", "1.1", "--iterations", "3",
         "--iter-max", "2", "--device", "cpu"] + extra)


@pytest.mark.parametrize("kind", ["png", "nii"])
def test_cli_robust_route_matches_library(tmp_path, kind):
    """``run_deconvolution --data-loss huber --device cpu`` on a small PNG
    and a small NIfTI == the library solve on ``b/x_scale`` (float32) ×
    ``x_scale``, with ``--data-loss-scale`` passed unscaled and
    ``--irls-cg-iters`` reaching the solver."""
    from nsol_tpu_torch.io import read_nifti, read_png, write_nifti, \
        write_png
    import scipy.io

    rng = np.random.RandomState(9)
    if kind == "png":
        obs, out = str(tmp_path / "b.png"), str(tmp_path / "x.mat")
        write_png(rng.randint(0, 256, (20, 24)).astype(np.uint8), obs)
        b = read_png(obs).astype(np.float64)
        spacing = np.ones(2)
    else:
        obs, out = str(tmp_path / "b.nii.gz"), str(tmp_path / "x.nii.gz")
        spacing = np.array([1.0, 1.25, 0.8])
        write_nifti((200.0 * _blurred(9, (10, 12, 8), np.eye(3) * 1.1 ** 2,
                                      spacing, noise=0.1))
                    .astype(np.float32), obs, spacing=spacing)
        b = read_nifti(obs).data.astype(np.float64)

    def read(path):
        if kind == "png":
            return scipy.io.loadmat(path)["nda"]
        return read_nifti(path).data

    def library(scale, cg_iters):
        solve = F.make_fused_admm_solver(
            b.shape, np.eye(b.ndim) * 1.1 ** 2, spacing=spacing,
            iterations=3, iter_max=2, data_loss="huber",
            irls_cg_iters=cg_iters)
        bs = _t(b / b.max(), dtype=torch.float32)
        return interop.to_numpy(solve(bs, bs, 0.02, 0.5, scale)).astype(
            np.float64) * b.max()

    assert _cli(tmp_path, obs, out, ["--data-loss-scale", "0.05",
                                     "--irls-cg-iters", "3"]) == 0
    recon = read(out)
    want = library(0.05, 3)
    assert recon.shape == b.shape and np.all(np.isfinite(recon))
    np.testing.assert_allclose(recon, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the two flags change the result, so they did reach the solver
    for other in (library(1.0, 3), library(0.05, 8)):
        assert np.abs(other - want).max() > 1e-4 * np.abs(want).max()


# ------------------------------------------------------------ on the card --

@pytest.mark.cuda
@pytest.mark.parametrize("shape,case", [((64, 64, 64), "iso"),
                                        ((37, 45, 53), "aniso"),
                                        ((5, 40, 33), "aniso"),
                                        ((256, 256), "iso"),
                                        ((37, 53), "aniso")])
def test_cuda_robust_units_match_plain_on_card(cuda_device, shape, case):
    """Kernel vs plain on the card, f32: max |Δ| ≤ 1e-5 · max |ref| for
    every output of every unit, CG scalars included."""
    nd = len(shape)
    cov, spacing = ISO3 if case == "iso" else ANISO3
    cov, spacing = cov[:nd, :nd], None if spacing is None else spacing[:nd]
    st = B.Stencils.from_cov(cov, 3, spacing, cuda_device)
    inputs = _unit_inputs(shape)
    for loss in ROBUST:
        got = _run_units(False, inputs, st, cuda_device, loss)
        ref = _run_units(True, inputs, st, cuda_device, loss)
        torch.cuda.synchronize()
        for k, (g, r) in enumerate(zip(got, ref)):
            err = float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))
            assert err <= 1e-5, "%s output %d: %.3g" % (loss, k, err)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 32, 32), (64, 48)])
def test_cuda_robust_solve_matches_plain_on_card(cuda_device, shape):
    cov = np.diag([1.0] * len(shape))
    b = _t(_blurred(10, shape, cov, noise=0.1), cuda_device, torch.float32)
    for solve in (F.make_fused_admm_solver(shape, cov, iterations=4,
                                           iter_max=3, data_loss="huber",
                                           irls_cg_iters=5),
                  R.make_robust_solver(shape, cov, iterations=4, iter_max=3,
                                       irls_cg_iters=5, data_loss="cauchy")):
        F.reset_counts()
        x_k = solve(b, b, 0.01, 0.5)
        assert all(n > 0 for n in F.launch_counts(F.ROBUST_UNITS).values())
        assert set(F.plain_counts().values()) == {0}
        x_p = solve.plain(b, b, 0.01, 0.5)
        assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= 1e-4
