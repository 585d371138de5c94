"""One rank of the gloo runs of ``tests/test_torch_parallel.py``.

    python tests/torch_parallel_worker.py PORT RANK WORLD OUTDIR

Joins a ``torch.distributed`` group of WORLD processes at
``tcp://localhost:PORT`` (gloo, on the CPU), runs every case of that world
size through ``nsol_tpu_torch.parallel`` on this rank's rows, and writes
them to ``OUTDIR/rank_RANK.npz`` for the test to assemble; the batch-mesh
cases write every rank's whole result there, and their studies under
OUTDIR. It imports
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


#: the batch-mesh cases: the PD study of tests/test_study.py:217-253 (a
#: 12 × 14 image, 5 α: at world 4 the padding path) and, at world 2, the
#: Tikhonov (TK1, α × data_loss_scale) and TV-L2 ADMM (α × ρ) sweeps inside
#: the fused solves' scope, 3 configurations each (padded to 4)
BATCH_ALPHAS = (0.1, 0.2, 0.4, 0.6, 0.8)
BATCH_COV = np.diag([1.0, 0.8]) ** 2
BATCH_SWEEPS = {
    "tik": {"alpha": np.array([0.02, 0.05, 0.1]),
            "data_loss_scale": np.array([1.0, 0.7, 1.0])},
    "admm": {"alpha": np.array([0.02, 0.05, 0.1]),
             "rho": np.array([0.5, 0.5, 1.0])},
}


def batch_image():
    return np.random.RandomState(11).rand(12, 14) * 10


def batch_pd_study(mesh, directory):
    """The PD study of ``tests/test_study.py:217-253`` through the port's
    ``PrimalDualSolverParameterStudy`` on ``mesh`` (None: no mesh), written
    to ``directory`` (float64 on the CPU)."""
    import torch

    from nsol_tpu_torch.observer import Observer
    from nsol_tpu_torch.ops import grad as G
    from nsol_tpu_torch.ops import prox
    from nsol_tpu_torch.solvers.wrappers import PrimalDualSolver
    from nsol_tpu_torch.study import PrimalDualSolverParameterStudy

    b = batch_image()
    bt = torch.as_tensor(b)
    grad, grad_adj = G.make_gradient_operators()
    solver = PrimalDualSolver(
        lambda x, tau: prox.prox_ell2_denoising(x, tau, bt),
        prox.prox_tv_conj, grad, grad_adj, L2=8.0, x0=b.copy(), alpha=0.1,
        iterations=5, device="cpu")
    obs = Observer()
    obs.set_measures({
        "Data": lambda x: 0.5 * torch.sum((torch.as_tensor(x) - bt) ** 2),
        "Reg": lambda x: torch.sum(torch.sqrt(torch.sum(
            grad(torch.as_tensor(x)) ** 2, dim=0)))})
    PrimalDualSolverParameterStudy(
        solver=solver, observer=obs, dir_output=directory, name="study",
        parameters={"alpha": list(BATCH_ALPHAS)}, use_vmap=True,
        mesh=mesh).run()


def batch_sweep_solver(kind):
    """The port's TK1 Tikhonov (``kind="tik"``) or TV-L2 ADMM solver of a
    blurred batch image, with the blur hint (float64 on the CPU)."""
    from nsol_tpu_torch.ops import conv as C
    from nsol_tpu_torch.ops import grad as G
    from nsol_tpu_torch.solvers import wrappers as W

    b = _blur(batch_image(), BATCH_COV) + 1.0
    A, _ = C.make_blur_operators(BATCH_COV)
    D, Dt = G.make_gradient_operators()
    opts = dict(alpha=0.05, minimizer="auto", iter_max=4,
                x_scale=float(b.max()), blur_cov=BATCH_COV,
                spacing=np.ones(2), device="cpu")
    if kind == "tik":
        return W.TikhonovLinearSolver(A, A, b, D, Dt, b.copy(),
                                      reg_kind="TK1", **opts)
    return W.ADMMLinearSolver(A, A, b, D, Dt, b.copy(), iterations=3,
                              **opts)


def batch_measures(kind):
    """The Reg/Data measures of :func:`batch_sweep_solver`'s sweeps."""
    import torch

    from nsol_tpu_torch.ops import conv as C
    from nsol_tpu_torch.ops import grad as G

    b = torch.as_tensor(_blur(batch_image(), BATCH_COV) + 1.0)
    A, _ = C.make_blur_operators(BATCH_COV)
    D, _ = G.make_gradient_operators()
    reg = (lambda x: 0.5 * torch.sum(D(x) ** 2)) if kind == "tik" else \
        (lambda x: torch.sum(torch.sqrt(torch.sum(D(x) ** 2, dim=0))))
    return {"Reg": reg, "Data": lambda x: 0.5 * torch.sum((A(x) - b) ** 2)}


def batch_cases(world, rank, outdir):
    """The batch-mesh cases of ``world``: every rank's whole result (the
    test assembles them rank after rank), and what each rank read."""
    import torch

    from nsol_tpu_torch import parallel as P
    from nsol_tpu_torch.parallel import distributed as dist
    from nsol_tpu_torch.study import ReaderParameterStudy

    mesh = P.make_mesh((world,), ("batch",), device="cpu")
    out = {"batch_slice": np.asarray(dist.process_local_slice(
        (2 * world, 3), mesh, axis_name="batch")),
        "batch_block": _np(dist.global_array_from_process_local(
            mesh, np.full((2, 3), float(rank)), axis_name="batch"))}
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        if world == 4:
            shared = os.path.join(outdir, "batch_study")
            batch_pd_study(mesh, shared)
            # after the study's barrier every rank reads rank 0's files
            reader = ReaderParameterStudy(directory=shared, name="study")
            reader.read_study()
            for m in ("Data", "Reg"):
                out["batch_read_" + m] = reader.get_results(m)
            # a study of its own a rank: only rank 0's directory is written
            batch_pd_study(mesh, os.path.join(outdir, "batch_rank%d" % rank))
        else:
            for kind, grid in BATCH_SWEEPS.items():
                x, recs = batch_sweep_solver(kind).run_sweep(
                    grid, measures=batch_measures(kind), mesh=mesh)
                out["batch_%s_x" % kind] = x
                for m, v in recs.items():
                    out["batch_%s_%s" % (kind, m)] = v
    finally:
        torch.set_default_dtype(old)
    return out


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


#: the shard probes' halo'd window variants on the world-2 spawn: their
#: volume (float32; 16 planes, 8 a rank, under the halo of 6)
PROBE_SHAPE = (16, 16, 128)
PROBE_VARIANTS = ("g2", "h3")


def probe_input():
    return np.random.RandomState(40).rand(*PROBE_SHAPE).astype(np.float32)


def probe_cases(mesh):
    """The shard probes' halo'd window variants (K2 fed by
    ``exchange_halo_wrap``; h3 with its eight products) on this rank's
    rows."""
    import torch

    from nsol_tpu_torch.parallel import shard_probe as SP

    c = torch.as_tensor(_rows(probe_input(), mesh))
    return {"w2_probe_" + name: _np(SP.apply_variant(name, c, mesh))
            for name in PROBE_VARIANTS}


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
                                                    device="cpu")),
            ("batch_mesh_size", lambda: P.make_mesh(
                (mesh.size + 1,), ("batch",), device="cpu"))):
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
        res.update(probe_cases(mesh))
        res.update(engine_cases(mesh))
        res.update(refusals(mesh))
    res.update(batch_cases(world, rank, outdir))
    np.savez(os.path.join(outdir, "rank_%d.npz" % rank), **res)
    torch.distributed.destroy_process_group()
    print("WORKER_OK", rank)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main(sys.argv)
