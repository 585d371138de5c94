"""One rank of the gloo runs of ``tests/test_torch_parallel.py``.

    python tests/torch_parallel_worker.py PORT RANK WORLD OUTDIR

Joins a ``torch.distributed`` group of WORLD processes at
``tcp://localhost:PORT`` (gloo, on the CPU), runs every case of that world
size through ``nsol_tpu_torch.parallel`` on this rank's rows, and writes
them to ``OUTDIR/rank_RANK.npz`` for the test to assemble. It imports
torch, numpy, scipy and the port only — never jax — and the test imports
its input makers, so both sides see the same numpy inputs.
"""

import os
import sys

import numpy as np
import scipy.ndimage as ndi

#: the JAX package's sharding-test shapes and stencils
#: (tests/test_sharding.py:44-170, 177-300, 376-416)
OP_SHAPES = {2: (16, 24), 3: (16, 12, 10)}
OP_SPACING = (1.5, 0.8, 1.1)
HOP_SHAPE, HOP = (16, 6, 5), 6
BNORMAL_SHAPE, BNORMAL_RHO = (16, 16, 16), 0.7
SOLVE_SHAPE = (16, 12, 10)
ALPHA, RHO = 0.01, 0.5
PD_VARIANTS = ("TVL1", "TVL2", "HuberL1", "HuberL2")
PD_ALPHA, PD_ITERS = 0.4, 10


def op_cov(nd):
    return np.diag([1.5, 1.0, 0.8][:nd]) ** 2


def solve_cov():
    return np.diag([0.8] * 3) ** 2


def _blur(x, cov):
    from nsol_tpu_torch.ops.kernels import gaussian_kernel

    kern = gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(cov.shape[0]))
    return ndi.convolve(x, kern, mode="wrap")


def op_inputs(nd):
    """``(x, g)``: a random block and a random gradient field."""
    rs = np.random.RandomState(10 + nd)
    shape = OP_SHAPES[nd]
    return rs.rand(*shape), rs.rand(nd, *shape)


def hop_input():
    return np.random.RandomState(20).rand(*HOP_SHAPE)


def bnormal_input():
    return np.random.RandomState(21).rand(*BNORMAL_SHAPE)


def solve_inputs():
    """The solves' observations: ``linear64`` (float64, 5 × 5 and the
    world-2 solves), ``huber64`` (float64, 3 × 4, C = 0.5),
    ``linear32`` (float32, 4 × 4, the blocked case), ``huber32`` (float32
    with outliers, 3 × 3), ``pd64`` (the denoising input)."""
    rs = np.random.RandomState(30)
    cov = solve_cov()
    lin64 = _blur(rs.rand(*SOLVE_SHAPE), cov)
    hub64 = _blur(rs.rand(*SOLVE_SHAPE), cov)
    lin32 = _blur(rs.rand(*SOLVE_SHAPE), cov).astype(np.float32)
    hub32 = _blur(rs.rand(*SOLVE_SHAPE), cov).astype(np.float32)
    hub32 += (0.2 * (rs.rand(*SOLVE_SHAPE) < 0.02)).astype(np.float32)
    return {"linear64": lin64, "huber64": hub64, "linear32": lin32,
            "huber32": hub32, "pd64": rs.rand(*SOLVE_SHAPE)}


#: solve cases: (observation, keyword arguments of sharded_tv_admm_solve)
SOLVES = {
    "cg_halo": ("linear64", dict(iterations=5, iter_max=5,
                                 use_blocked=False)),
    "cg_blocked": ("linear32", dict(iterations=4, iter_max=4,
                                    use_blocked=True)),
    "huber_halo": ("huber64", dict(iterations=3, iter_max=4,
                                   data_loss="huber", data_loss_scale=0.5,
                                   use_blocked=False)),
    "huber_blocked": ("huber32", dict(iterations=3, iter_max=3,
                                      data_loss="huber", use_blocked=True)),
}
#: world-2 solves, each held to the unsharded admm_solve in float64
SOLVES_W2 = {
    "w2_cg_halo": ("linear64", dict(iterations=5, iter_max=5,
                                    use_blocked=False)),
    "w2_cg_blocked": ("linear64", dict(iterations=5, iter_max=5,
                                       use_blocked=True)),
    "w2_huber_blocked": ("huber64", dict(iterations=3, iter_max=4,
                                         data_loss="huber",
                                         data_loss_scale=0.5,
                                         use_blocked=True)),
}

#: world-2 cases of the non-separable blur and the remaining engines: a
#: full covariance (σ 0.8 on each axis, correlated) or the separable
#: solve_cov; minimizer None resolves to "lsmr" (linear) or "L-BFGS-B"
#: (robust) with the full one, and "irls" over it warns and runs
FULL_COV = 0.64 * np.array([[1.0, 0.4, 0.1], [0.4, 1.0, 0.2],
                            [0.1, 0.2, 1.0]])
ENGINE_SOLVES = {
    "w2_lsmr_full": ("linear64", "full", dict(iterations=3, iter_max=4)),
    "w2_lbfgs_full": ("huber64", "full", dict(
        iterations=2, iter_max=4, data_loss="huber", data_loss_scale=0.5)),
    "w2_irls_full": ("huber64", "full", dict(
        iterations=2, iter_max=2, data_loss="huber", minimizer="irls")),
    "w2_lsmr_sep": ("linear64", "sep", dict(iterations=3, iter_max=4,
                                            minimizer="lsmr")),
    "w2_lbfgs_sep": ("huber64", "sep", dict(
        iterations=2, iter_max=4, data_loss="cauchy",
        minimizer="L-BFGS-B")),
}


def engine_cov(which):
    return FULL_COV if which == "full" else solve_cov()


#: the io window apply of world 2 (K10b.6): normal_W(vf, wts, alpha) of
#: make_sharded_blocked_robust_operators(io_dtype=bfloat16)
WIO_ALPHA = 0.7


def wio_inputs():
    """``(vf, wts)`` of the io window apply, float32."""
    rs = np.random.RandomState(31)
    return (rs.rand(*SOLVE_SHAPE).astype(np.float32),
            (rs.rand(*SOLVE_SHAPE) + 0.1).astype(np.float32))


def _rows(a, mesh, axis=0):
    from nsol_tpu_torch.parallel import distributed as dist

    lo, hi = dist.process_local_slice(a.shape[axis:], mesh)
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(lo, hi)
    return a[tuple(idx)]


def _np(t):
    return t.detach().cpu().numpy()


def operator_cases(mesh):
    """The halo exchanges and sharded operators on this rank's rows."""
    import torch

    from nsol_tpu_torch import parallel as P
    from nsol_tpu_torch.parallel import blocked_halo
    from nsol_tpu_torch.solvers.cg import tree_vdot

    out = {}
    for nd in (2, 3):
        x, g = op_inputs(nd)
        xl = torch.as_tensor(_rows(x, mesh))
        gl = torch.as_tensor(_rows(g, mesh, axis=1))
        sp = OP_SPACING[:nd]
        local = xl.shape
        grad, grad_adj = P.make_sharded_gradient_operators(sp, mesh)
        out["grad_%d" % nd] = _np(grad(xl))
        out["gradadj_%d" % nd] = _np(grad_adj(gl))
        cov, ones = op_cov(nd), np.ones(nd)
        A, _ = P.make_sharded_blur_operators(cov, 3, ones, mesh)
        out["blur_%d" % nd] = _np(A(xl))
        mA, _ = P.make_sharded_matmul_blur_operators(
            cov, 3, ones, local_shape=local, mesh=mesh)
        out["mblur_%d" % nd] = _np(mA(xl))
        out["mnormal_%d" % nd] = _np(P.make_sharded_matmul_normal_blur_operator(
            cov, 3, ones, local_shape=local, mesh=mesh)(xl))
        out["mlap_%d" % nd] = _np(P.make_sharded_matmul_gradient_normal(
            local, sp, mesh=mesh)(xl))
        if nd == 3:
            out["adj_lhs"] = _np(tree_vdot(grad(xl), gl, mesh.reduce))
            out["adj_rhs"] = _np(tree_vdot(xl, grad_adj(gl), mesh.reduce))
    out["hop"] = _np(P.exchange_halo_wrap(
        torch.as_tensor(_rows(hop_input(), mesh)), mesh, HOP, HOP))
    v = torch.as_tensor(_rows(bnormal_input(), mesh))
    ap = blocked_halo.make_sharded_blocked_normal_operator(
        tuple(v.shape), np.eye(3), mesh=mesh)
    out["bnormal"] = _np(ap(v, BNORMAL_RHO))
    out["bnormal_halo"] = np.asarray(ap.halo)
    return out


def solve_cases(mesh, cases):
    """The sharded solves of ``cases`` on this rank's rows
    (``process_local=True``)."""
    from nsol_tpu_torch import parallel as P

    obs = solve_inputs()
    out = {}
    for name, (key, kw) in cases.items():
        bl = _rows(obs[key], mesh)
        out[name] = _np(P.sharded_tv_admm_solve(
            mesh, solve_cov(), bl, bl.copy(), ALPHA, RHO,
            process_local=True, **kw))
    return out


def denoise_cases(mesh):
    from nsol_tpu_torch import parallel as P

    bl = _rows(solve_inputs()["pd64"], mesh)
    return {"pd_" + v: _np(P.sharded_tv_denoise_solve(
        mesh, bl, PD_ALPHA, iterations=PD_ITERS, variant=v,
        process_local=True)) for v in PD_VARIANTS}


def engine_cases(mesh):
    """The sharded direct blur of the full covariance and the
    ``ENGINE_SOLVES`` on this rank's rows."""
    import warnings

    import torch

    from nsol_tpu_torch import parallel as P

    obs = solve_inputs()
    A, _ = P.make_sharded_blur_operators(FULL_COV, mesh=mesh)
    out = {"w2_blur_full": _np(A(torch.as_tensor(_rows(obs["pd64"],
                                                       mesh))))}
    for name, (key, which, kw) in ENGINE_SOLVES.items():
        bl = _rows(obs[key], mesh)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out[name] = _np(P.sharded_tv_admm_solve(
                mesh, engine_cov(which), bl, bl.copy(), ALPHA, RHO,
                process_local=True, **kw))
    return out


def window_io_cases(mesh):
    """The sharded weighted apply with ``io_dtype=bfloat16`` on this rank's
    rows (its bfloat16 result as float32)."""
    import torch

    from nsol_tpu_torch.parallel import blocked_halo

    vf, wts = (torch.as_tensor(_rows(a, mesh)) for a in wio_inputs())
    _, _, normal_W = blocked_halo.make_sharded_blocked_robust_operators(
        tuple(vf.shape), solve_cov(), mesh=mesh, io_dtype=torch.bfloat16)
    out = normal_W(vf, wts, WIO_ALPHA)
    assert out.dtype == torch.bfloat16
    return {"w2_wnormal_io": _np(out.float())}


def refusals(mesh):
    """Flags (1 = raised ``ValueError``) of what a multi-rank mesh must
    refuse: a full volume with ``process_local=False``, and a mesh of
    another size than the group."""
    from nsol_tpu_torch import parallel as P

    b = solve_inputs()["linear64"]
    flags = {}
    for name, call in (
            ("full_volume", lambda: P.sharded_tv_admm_solve(
                mesh, solve_cov(), b, b.copy(), ALPHA, RHO, iterations=1,
                iter_max=1)),
            ("mesh_size", lambda: P.make_space_mesh(mesh.size + 1,
                                                    device="cpu"))):
        try:
            call()
            flags[name] = np.asarray(0)
        except ValueError:
            flags[name] = np.asarray(1)
    return flags


def main(argv):
    port, rank, world, outdir = argv[1], int(argv[2]), int(argv[3]), argv[4]
    import torch

    torch.set_num_threads(1)
    from nsol_tpu_torch import parallel as P
    from nsol_tpu_torch.parallel import distributed as dist

    dist.initialize(coordinator_address="localhost:" + port,
                    num_processes=world, process_id=rank, device="cpu")
    mesh = P.make_space_mesh(world, device="cpu")
    if world == 4:
        res = operator_cases(mesh)
        res.update(solve_cases(mesh, SOLVES))
        res.update(denoise_cases(mesh))
    else:
        res = solve_cases(mesh, SOLVES_W2)
        res.update(window_io_cases(mesh))
        res.update(engine_cases(mesh))
        res.update(refusals(mesh))
    np.savez(os.path.join(outdir, "rank_%d.npz" % rank), **res)
    torch.distributed.destroy_process_group()
    print("WORKER_OK", rank)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main(sys.argv)
