"""The float64 anchors of ``chip_smoke.py`` phases 17-18 and 35, and the gap
of the port's float32 plain path to them on the CPU.

    python tests/torch_anchors.py

The anchors are the JAX package's own float64 solves (x64 on the CPU) of
the Lena 256² deconvolution studies that ``chip_smoke.py`` runs on the
GPU: the Tikhonov objective ``½Σρ_C((Ax−b)²) + α·½‖Bx‖²`` of
``tikhonov_solve`` at three α of the 64-α TK1L2/TK0L2 sweeps and of the
8-α huber sweep, and the final Reg/Data records of ``admm_solve`` at two
configurations of the TV-L2 ADMM study; and the objectives of the
primal-dual deconvolutions that ``nsol_torch_run_deconvolution`` runs at its
default flags (PD, 50 iterations, α 0.01, ``--blur 1``, ``--minimizer
auto``) on the Lena PNG (TVL2, HuberL2) and on the σ = 1 blurred 64³
phantom (TVL2), through the JAX package's interface as its CLI builds it
on the CPU; and the objective of the JAX package's fused PD kernel with
its bf16 state (``compact=True``, interpret mode, float32) on Man 1024² at
the sweep's α[40], phase 33's anchor of the compact sweep, beside the
exact kernel's there (the deviation the bf16 state itself makes). Beside
each, the relative gap of
``nsol_tpu_torch``'s float32 plain path on the CPU: ``chip_smoke.py`` sets
its bands from these gaps. Not a test: ``tests/test_torch_study.py``
checks that the constants in ``chip_smoke.py`` are these values.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: the sweeps of phase 17 (chip_smoke.py): α grid, CG iterations, and the
#: huber sweep's α indices, C, MM sweeps and CG iterations per sweep
TK_ALPHAS = np.linspace(0.005, 0.5, 64, dtype=np.float32)
TK_ANCHOR_AT = (0, 31, 63)
TK_ITER_MAX = 10
HUBER_AT = (0, 32, 56)
HUBER_SCALE, HUBER_SWEEPS, HUBER_CG = 1.0, 5, 8
#: the TV-L2 ADMM study of phase 18: 8 α × 2 ρ, 50 outer × 10 CG, and the
#: two configurations whose records are anchored
TV_ALPHAS = np.linspace(0.001, 0.05, 8, dtype=np.float32)
TV_RHOS = (0.1, 0.5)
TV_ITERATIONS, TV_ITER_MAX = 50, 10
TV_ANCHOR_AT = ((1, 0.1), (6, 0.5))
#: the PD deconvolutions of phase 35: the CLI's defaults
PD_ALPHA, PD_ITERATIONS, PD_ITER_MAX = 0.01, 50, 10
PD_CASES = (("lena", "TVL2"), ("lena", "HuberL2"), ("phantom", "TVL2"))
#: phase 33's compact anchor: the Man 1024² sweep's α grid and the index
MAN_ALPHAS = np.linspace(0.01, 1.5, 64, dtype=np.float32)
MAN_COMPACT_AT = 40


def lena():
    """The blurred noisy Lena 256² over its maximum (float64), the
    study's ``b / x_scale``, and ``x_scale``."""
    from nsol_tpu_torch import data
    from nsol_tpu_torch.io import read_png

    img = read_png(data.path("2D_Lena_256_blur_noise.png")).astype(np.float64)
    return img / img.max(), float(img.max())


def tikhonov_objective(x, b, A, B, alpha, loss="linear", scale=1.0,
                       xp=np):
    """``½Σρ_C((Ax−b)²) + α·½‖Bx‖²`` with the array module ``xp``."""
    r = A(x) - b
    f2 = r * r
    if loss == "huber":
        t = f2 / scale ** 2
        g2 = 1.345 ** 2
        f2 = xp.where(t < g2, t, 2 * 1.345 * xp.sqrt(t) - g2) * scale ** 2
    Bx = B(x)
    return float(0.5 * xp.sum(f2) + alpha * 0.5 * xp.sum(Bx * Bx))


def _jax():
    """The JAX package's modules, on the CPU in float64."""
    os.environ.pop("JAX_PLATFORMS", None)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from nsol_tpu.ops import conv, grad
    from nsol_tpu.solvers import admm, tikhonov

    b, _ = lena()
    A, _ = conv.make_blur_operators(np.eye(2), alpha_cut=3)
    D, Dt = grad.make_gradient_operators(None)
    return jnp, jnp.asarray(b), A, D, Dt, admm, tikhonov


def tikhonov_anchors():
    """{(reg, loss, α index): float64 objective} from the JAX package."""
    import jax

    jnp, bj, A, D, Dt, _, T = _jax()
    ident = lambda x: x  # noqa: E731
    out = {}
    for reg, loss, B, Bt, at in (("TK1", "linear", D, Dt, TK_ANCHOR_AT),
                                 ("TK0", "linear", ident, ident,
                                  TK_ANCHOR_AT),
                                 ("TK1", "huber", D, Dt, HUBER_AT)):
        robust = loss == "huber"
        solve = jax.jit(lambda b, a, B=B, Bt=Bt, robust=robust:
                        T.tikhonov_solve(
                            A, A, B, Bt, b, 0.0, b, a,
                            data_loss="huber" if robust else "linear",
                            data_loss_scale=HUBER_SCALE,
                            minimizer="irls" if robust else "cg",
                            iter_max=HUBER_SWEEPS if robust
                            else TK_ITER_MAX, irls_cg_iters=HUBER_CG))
        for i in at:
            a = float(TK_ALPHAS[i])
            out[(reg, loss, i)] = tikhonov_objective(
                solve(bj, jnp.float64(a)), bj, A, B, a, loss, HUBER_SCALE,
                xp=jnp)
    return out


def tv_anchors():
    """{("TV", Reg|Data, α index, ρ): the float64 final record} of the JAX
    package's admm_solve."""
    jnp, bj, A, D, Dt, M, _ = _jax()

    def record(x):
        g = D(x)
        r = A(x) - bj
        return {"Reg": jnp.sum(jnp.sqrt(jnp.sum(g * g, axis=0))),
                "Data": 0.5 * jnp.sum(r * r)}

    out = {}
    for i, rho in TV_ANCHOR_AT:
        _, recs = M.admm_solve(A, A, D, Dt, bj, 0.0, bj,
                               float(TV_ALPHAS[i]), rho,
                               iterations=TV_ITERATIONS,
                               iter_max=TV_ITER_MAX, minimizer="cg",
                               record_fn=record)
        for k in ("Reg", "Data"):
            out[("TV", k, i, rho)] = float(recs["measures"][k][-1])
    return out


def pd_observation(name):
    """The raw observation of PD case ``name``: the blurred noisy Lena PNG,
    or the 64³ phantom blurred by the σ = 1 wrap Gaussian (float32, as the
    NIfTI file chip_smoke.py writes holds it)."""
    import scipy.ndimage as ndi

    from nsol_tpu_torch import data
    from nsol_tpu_torch.io import read_nifti, read_png
    from nsol_tpu_torch.ops.kernels import gaussian_kernel

    if name == "lena":
        return read_png(data.path("2D_Lena_256_blur_noise.png")).astype(
            np.float64)
    vol = read_nifti(data.path("3D_SheppLoganPhantom_64.nii.gz")).data
    kern = gaussian_kernel(np.eye(3), alpha_cut=3, spacing=np.ones(3))
    return ndi.convolve(vol.astype(np.float64), kern, mode="wrap").astype(
        np.float32).astype(np.float64)


def pd_objective(x, b, A, D, alpha, rtype, xp=np):
    """``½‖Ax − b‖² + α·TV(x)`` (TVL2) or ``+ α·½Σhuber(|∇x|², 0.05)``
    (HuberL2), in the scaled units ``x/x_scale``, ``b/x_scale``."""
    r = A(x) - b
    g = D(x)
    g2 = xp.sum(g * g, axis=0) if xp is np else xp.sum(g * g, 0)
    if rtype == "TVL2":
        reg = xp.sum(xp.sqrt(g2))
    else:
        gam = 0.05
        reg = 0.5 * xp.sum(xp.where(g2 < gam * gam, g2,
                                    2 * gam * xp.sqrt(g2) - gam * gam))
    return float(0.5 * xp.sum(r * r) + alpha * reg)


def pd_anchors():
    """{("PD", case, type): float64 objective} of the JAX package's PD
    deconvolution, its interface wired as its CLI wires it."""
    jnp = _jax()[0]
    from nsol_tpu.interface import DeconvolutionSolverStudyInterface
    from nsol_tpu.ops import conv, grad
    from nsol_tpu.solvers.tikhonov import resolve_minimizer

    out = {}
    for name, rtype in PD_CASES:
        b = pd_observation(name)
        nd = b.ndim
        cov, spacing = np.eye(nd), np.ones(nd)
        A, At = conv.make_blur_operators(cov, alpha_cut=3, spacing=spacing,
                                         shape=b.shape, method="auto")
        D, Dt = grad.make_gradient_operators(spacing)
        minimizer = resolve_minimizer("auto", data_loss="linear", cov=cov,
                                      spacing=spacing)
        iface = DeconvolutionSolverStudyInterface(
            A=A, A_adj=At, D=D, D_adj=Dt, b=b, x0=np.array(b),
            alpha=PD_ALPHA, x_scale=float(b.max()), iter_max=PD_ITER_MAX,
            iterations=PD_ITERATIONS, minimizer=minimizer, measures=[],
            reconstruction_type=rtype, dimension=nd, rho=0.5,
            tv_solver="PD",
            normal_A=conv.make_normal_blur_operator(
                cov, alpha_cut=3, spacing=spacing, shape=b.shape),
            normal_B=lambda x: grad.gradient_normal(x, spacing),
            blur_cov=cov, spacing=spacing)
        iface.set_up_solver()
        solver = iface.get_solver()
        solver.run()
        s = float(b.max())
        x = jnp.asarray(solver.get_x() / s)
        out[("PD", name, rtype)] = pd_objective(
            x, jnp.asarray(b / s), A, D, PD_ALPHA, rtype, xp=jnp)
    return out


def man_compact_anchors():
    """{("PD-compact", "man", i): objective, ("PD-exact", "man", i): ...}
    of the JAX package's fused PD kernel on Man 1024² (TVL2, ALG2, 50
    iterations, L2 8, float32, interpret mode) at α[i], with and without
    its bf16 state: Data + α·Reg of its last records."""
    os.environ.pop("JAX_PLATFORMS", None)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from nsol_tpu.ops.pallas.fused import make_fused_pd_denoise_solver

    from nsol_tpu_torch import data
    from nsol_tpu_torch.io import read_png

    man = read_png(data.path("2D_Man_1024.png")).astype(np.float64)
    b = (man / man.max()).astype(np.float32)
    i = MAN_COMPACT_AT
    a = float(MAN_ALPHAS[i])
    out = {}
    for key, compact in (("PD-exact", False), ("PD-compact", True)):
        _, r = make_fused_pd_denoise_solver(
            b.shape, "TVL2", iterations=PD_ITERATIONS, record=True,
            compact=compact, interpret=True)(b, b, a, 8.0)
        out[(key, "man", i)] = float(r["Data"][-1]) + a * float(
            r["Reg"][-1])
    return out


def port_gaps(anchors):
    """{key: relative gap} of the port's float32 plain path on the CPU."""
    import torch

    from nsol_tpu_torch.ops import conv, grad
    from nsol_tpu_torch.ops.cuda import fused, tikhonov

    b64, _ = lena()
    b = torch.as_tensor(b64, dtype=torch.float32)
    cov = np.eye(2)
    A, _ = conv.make_blur_operators(cov, alpha_cut=3)
    B = {"TK1": grad.gradient, "TK0": lambda x: x}
    gaps = {}
    for key, want in anchors.items():
        if key[0] in ("TV", "PD", "engine") or key[0].startswith("PD-"):
            continue
        reg, loss, i = key
        a = float(TK_ALPHAS[i])
        solve = tikhonov.make_fused_tikhonov_solver(
            b.shape, cov, reg=reg,
            iter_max=TK_ITER_MAX if loss == "linear" else HUBER_SWEEPS,
            data_loss=loss, irls_cg_iters=HUBER_CG)
        x = solve.plain(b, b, a, HUBER_SCALE).double()
        got = tikhonov_objective(x, b.double(), A, B[reg], a, loss,
                                 HUBER_SCALE, xp=torch)
        gaps[key] = abs(got - want) / abs(want)
    for i, rho in TV_ANCHOR_AT:
        solve = fused.make_fused_admm_solver(
            b.shape, cov, iterations=TV_ITERATIONS, iter_max=TV_ITER_MAX,
            record=True)
        _, recs = solve.plain(b, b, float(TV_ALPHAS[i]), rho)
        for k in ("Reg", "Data"):
            want = anchors[("TV", k, i, rho)]
            gaps[("TV", k, i, rho)] = abs(float(recs[k][-1]) - want) / want
    for key in (k for k in anchors if k[0] == "PD"):
        gaps[key] = abs(port_pd_objective(*key[1:]) - anchors[key]) \
            / anchors[key]
    for key in (k for k in anchors if k[0] == "engine"):
        gaps[key] = port_engine_gap(key[1], anchors[key])
    for key in (k for k in anchors if k[0].startswith("PD-")):
        gaps[key] = abs(port_man_objective(key[0] == "PD-compact")
                        - anchors[key]) / anchors[key]
    return gaps


def port_man_objective(compact):
    """The port's float32 plain fused PD solve at phase 33's α[40]."""
    import torch

    from nsol_tpu_torch import data
    from nsol_tpu_torch.io import read_png
    from nsol_tpu_torch.ops.cuda import fused

    man = read_png(data.path("2D_Man_1024.png")).astype(np.float64)
    b = torch.as_tensor((man / man.max()).astype(np.float32))
    a = float(MAN_ALPHAS[MAN_COMPACT_AT])
    _, r = fused.make_fused_pd_denoise_solver(
        b.shape, "TVL2", "ALG2", PD_ITERATIONS, record=True,
        compact=compact)(b, b, a, 8.0)
    return float(r["Data"][-1]) + a * float(r["Reg"][-1])


def port_pd_objective(name, rtype):
    """The objective of the port's float32 PD deconvolution on the CPU,
    through its CLI at the default flags."""
    import tempfile

    import torch

    from nsol_tpu_torch.cli import run_deconvolution
    from nsol_tpu_torch.io import DataReader, write_nifti
    from nsol_tpu_torch.ops import conv, grad

    b = pd_observation(name)
    with tempfile.TemporaryDirectory() as tmp:
        if name == "lena":
            from nsol_tpu_torch import data

            obs = data.path("2D_Lena_256_blur_noise.png")
        else:
            obs = os.path.join(tmp, "b.nii")
            write_nifti(b.astype(np.float32), obs, spacing=np.ones(3))
        out = os.path.join(tmp, "x.mat")
        run_deconvolution.main(["--observation", obs, "--result", out,
                                "--reconstruction-type", rtype,
                                "--device", "cpu"])
        reader = DataReader(out)
        reader.read_data()
        x = reader.get_data()
    s = float(b.max())
    A, _ = conv.make_blur_operators(np.eye(b.ndim), alpha_cut=3)
    return pd_objective(torch.as_tensor(x / s), torch.as_tensor(b / s), A,
                        grad.gradient, PD_ALPHA, rtype, xp=torch)


def _chip_smoke():
    import chip_smoke

    return chip_smoke


def engine_anchors(names=None):
    """{("engine", name): float64 objective} of the JAX package's
    ``tikhonov_solve`` on phase 42's problems (``chip_smoke.ENGINE_CASES``,
    ``engine_problem``), its blur the FFT form of the full covariance."""
    import jax

    jnp = _jax()[0]
    from nsol_tpu.ops import conv, grad
    from nsol_tpu.solvers.tikhonov import tikhonov_solve

    cs = _chip_smoke()
    D, Dt = grad.make_gradient_operators(None)
    out = {}
    for name, (image, minimizer, loss, alpha, iters) in \
            cs.ENGINE_CASES.items():
        if names is not None and name not in names:
            continue
        b, _, cov = cs.engine_problem(image)
        A, _ = conv.make_blur_operators(cov, alpha_cut=3, shape=b.shape)
        bj = jnp.asarray(b)
        x = jax.jit(lambda b, A=A, m=minimizer, loss=loss, a=alpha, n=iters:
                    tikhonov_solve(A, A, D, Dt, b, 0.0, b, a, data_loss=loss,
                                   minimizer=m, iter_max=n))(bj)
        out[("engine", name)] = cs.engine_objective(
            x, bj, A, D, alpha, loss, minimizer, jnp)
    return out


def port_engine_gap(name, anchor):
    """The relative gap of the port's float32 solve of phase 42's case
    ``name`` on the CPU to its anchor."""
    import torch

    from nsol_tpu_torch.ops import conv, grad
    from nsol_tpu_torch.solvers.tikhonov import tikhonov_solve

    cs = _chip_smoke()
    image, minimizer, loss, alpha, iters = cs.ENGINE_CASES[name]
    b64, _, cov = cs.engine_problem(image)
    A, _ = conv.make_blur_operators(cov, shape=b64.shape)
    b = torch.as_tensor(b64, dtype=torch.float32)
    x = tikhonov_solve(A, A, grad.gradient, grad.gradient_adjoint, b, 0.0,
                       b, alpha, data_loss=loss, minimizer=minimizer,
                       iter_max=iters)
    got = cs.engine_objective(x.double(), torch.as_tensor(b64), A,
                              grad.gradient, alpha, loss, minimizer, torch)
    return abs(got - anchor) / abs(anchor)


if __name__ == "__main__":
    if sys.argv[1:] == ["engines"]:
        anchors = engine_anchors()
        for key, want in anchors.items():
            print("%-40s %.9f   float32 plain gap %.2e"
                  % (key, want, port_engine_gap(key[1], want)))
        sys.exit(0)
    anchors = dict(tikhonov_anchors(), **tv_anchors(), **pd_anchors(),
                   **man_compact_anchors(), **engine_anchors())
    gaps = port_gaps(anchors)
    for key in anchors:
        print("%-28s %.9f   float32 plain gap %.2e"
              % (key, anchors[key], gaps[key]))
