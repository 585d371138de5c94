"""The float64 anchors of ``chip_smoke.py`` phases 17-18, and the gap of the
port's float32 plain path to them on the CPU.

    python tests/torch_anchors.py

The anchors are the JAX package's own float64 solves (x64 on the CPU) of
the Lena 256² deconvolution studies that ``chip_smoke.py`` runs on the
GPU: the Tikhonov objective ``½Σρ_C((Ax−b)²) + α·½‖Bx‖²`` of
``tikhonov_solve`` at three α of the 64-α TK1L2/TK0L2 sweeps and of the
8-α huber sweep, and the final Reg/Data records of ``admm_solve`` at two
configurations of the TV-L2 ADMM study. Beside each, the relative gap of
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
        if key[0] == "TV":
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
    return gaps


if __name__ == "__main__":
    anchors = dict(tikhonov_anchors(), **tv_anchors())
    gaps = port_gaps(anchors)
    for key in anchors:
        print("%-28s %.9f   float32 plain gap %.2e"
              % (key, anchors[key], gaps[key]))
