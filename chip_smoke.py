#!/usr/bin/env python3
"""Smoke run of nsol_tpu_torch on one NVIDIA GPU (an H100 for sm_90a).

    python3 chip_smoke.py

Builds the CUDA kernels from ``nsol_tpu_torch/csrc``, holds each kernel
against its plain PyTorch version on the card, and drives the port's
paths through the library and the CLIs, checking each converged objective
against its float64 anchor and timing kernels and solves with CUDA events:

* phases 1-6, deconvolution: 3-D TV-L2 of the 64³ Shepp–Logan stand-in by
  ADMM (50 outer × 10 CG iterations, α 0.01, ρ 0.5, σ = 1 wrap blur), the
  scale solve at 256³, and ``run_deconvolution``;
* phases 7-11, primal-dual denoising: the PD units against their plain
  versions (all 4 types × 3 schedules, 2-D and 3-D), Lena 256² TVL2
  (α 0.03, 50 iterations, L2 8) and all 12 pairs, the L-curve sweep over
  64 alphas of Man 1024² with in-kernel records, the noisy 64³ phantom and
  a 256³ solve, and ``run_denoising`` on a PNG and a NIfTI volume;
* phases 12-15, robust (huber) TV deconvolution by ADMM + IRLS: the robust
  units against their plain versions (4 losses at two scales, 2-D and
  3-D, anisotropic), the blurred noisy Lena 256² (10 outer × 3 sweeps × 6
  CG, α 0.01, ρ 0.5), the 256³ volume with salt-and-pepper outliers
  (10 × 5 × 8), and ``run_deconvolution --data-loss huber`` on the PNG;
* phases 16-19, the deconvolution parameter studies: the TK0/TK1 instances
  of the applies, ``admm_record`` (5 losses), ``tik_clip`` and the linear
  ADMM units on 2-D images against their plain versions, and the whole C
  solves; the Lena 256² TK1L2/TK0L2 sweeps over 64 α (CG 10) and the TK1L2
  huber sweep through ``TikhonovLinearSolver.run_sweep``, against float64
  anchors; the TV-L2 ADMM study with records (8 α × 2 ρ, 50 × 10) through
  ``ADMMLinearSolver.run_sweep`` and ``run_deconvolution`` on the PNG; a
  256³ TK1L2 sweep over 8 α; ``nsol_torch_run_deconvolution_study`` on
  the 64³ NIfTI phantom (TK1L2) and on Lena (TVL2 by ADMM).

Each path's launch counts are set to 0 just before it runs and read just
after. Any failed phase raises, so the script exits non-zero and prints
no result line. It imports neither jax nor nsol_tpu, and needs the
checkout's ``nsol_tpu_torch`` beside it. ``--only GROUP,...`` runs some
phase groups (for development; it prints no result line).

The last lines are a JSON record of the kernels, the card's name and
power limit, and the result line ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ALPHA, RHO, ITERATIONS, ITER_MAX, SIGMA = 0.01, 0.5, 50, 10, 1.0
#: converged objective of the same solve on the generated 64³ stand-in,
#: by the float64 CPU reference-equivalent implementation (bench.py:29)
OBJECTIVE_ANCHOR = 219948.08
ANCHOR_BAND = 0.002
#: kernel vs plain on the card: max |Δ| ≤ KERNEL_TOL · max |ref| (f32 with
#: another summation order and FMA contraction)
KERNEL_TOL = 1e-5
#: whole-solve kernel vs plain on the card: 500 CG iterations amplify the
#: per-op rounding differences, so the gate is on the objective and on the
#: voxels, at looser bands
SOLVE_OBJ_TOL, SOLVE_VOX_TOL = 1e-4, 1e-3
#: 256³ objective of the same synthetic solve in the JAX package's suite
#: (benchmarks/suite.py), printed for information only
SCALE_OBJECTIVE_JAX = 20868.3

#: primal-dual denoising: the CLI's L2 (8, even in 3-D), α, and the
#: float64 objectives of the same solves (JAX package, x64 on the CPU,
#: ``primal_dual_solve`` with the CLI's prox wiring; ``pd_objective``)
PD_L2, PD_ALPHA = 8.0, 0.03
PD_TYPES = ("TVL1", "TVL2", "HuberL1", "HuberL2")
PD_ALGS = ("ALG2", "ALG2_AHMOD", "ALG3")
LENA_ANCHOR = 309.139137
#: Man 1024² sweep, α = np.linspace(0.01, 1.5, 64, dtype=float32)[i]
MAN_ANCHORS = {0: 61.172580, 40: 4176.069305, 63: 6432.609120}
#: 64³ phantom + N(0, 0.05·max) noise (RandomState(0)), then /max
PHANTOM_ANCHORS = {("TVL2", "ALG2"): 933.133503,
                   ("TVL1", "ALG2"): 1141.800845,
                   ("HuberL2", "ALG3"): 893.701885}
PD_ANCHOR_BAND = 1e-5
PD_OBJ_TOL = 1e-6
PD_SPACING = (1.25, 0.8, 2.0)
PD_UNIT_ALPHAS = (0.05, 0.3, 1.2)

#: robust deconvolution: the losses, Lena 256² blurred + noisy (/max),
#: huber, σ = 1, α 0.01, ρ 0.5, 10 outer × 3 sweeps × 6 CG, C = 1 (the JAX
#: package's benchmark config 2, benchmarks/suite.py:135-234) and its
#: objective ½Σhuber(r²) + α·TV(x) by the JAX package in float64 on the
#: CPU (``admm_solve(minimizer="irls")``, the same parameters) on the
#: tracked stand-in image
ROBUST_LOSSES = ("huber", "soft_l1", "cauchy", "arctan")
ROBUST_ITERS = {"lena": (10, 3, 6), "scale": (10, 5, 8)}
LENA_ROBUST_ANCHOR = 101.442567054
ROBUST_ANCHOR_BAND = 1e-4
#: 256³ robust solve of the JAX package's suite (benchmarks/suite.py:
#: 900-970; BASELINE.md:441, equal across its XLA and kernel legs)
SCALE_SHAPE = (256, 256, 256)
SCALE_ROBUST_ANCHOR = 45022.5


class PhaseFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise PhaseFailure(msg)


def smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def objective_host(x, b_np, kern, alpha):
    """½‖A x − b‖² + α·TV(x) on the host in float64 (bench.py:156-163)."""
    import scipy.ndimage as ndi

    xv = np.asarray(x, dtype=np.float64)
    r = ndi.convolve(xv, kern, mode="wrap") - b_np
    gx = np.stack([np.diff(np.concatenate(
        [xv, np.zeros_like(np.take(xv, [0], axis=ax))], axis=ax), axis=ax)
        for ax in (2, 1, 0)])
    return float(0.5 * np.sum(r ** 2)
                 + alpha * np.sum(np.sqrt(np.sum(gx ** 2, axis=0))))


def objective_device(x, b, A, alpha):
    """The same objective on the card in float64 (for 256³, where the host
    convolution would take minutes)."""
    import torch

    from nsol_tpu_torch.ops import grad as G

    x64, b64 = x.double(), b.double()
    r = A(x64) - b64
    g = G.gradient(x64)
    return float(0.5 * torch.sum(r * r)
                 + alpha * torch.sum(torch.sqrt(torch.sum(g * g, dim=0))))


def max_rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


#: the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s
#: and float32 operations/s outside the tensor cores
HBM_BYTES_S, F32_OPS_S = 3.35e12, 67e12


def bound(nbytes, ops):
    """``(bound_ms, bound_by)``: the least time the card could take to move
    ``nbytes`` through HBM and do ``ops`` float32 operations."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / F32_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def unit_bound(name, n, taps=(0, 0, 0), nd=3, batch=1):
    """Bound of one call of the kernel unit ``name`` on ``n`` voxels (a
    batch of ``batch`` images for the PD units): each input volume read
    once, each output volume written once, 4 bytes a voxel; operations
    from the taps (``taps``: per-axis stencil lengths of its blur chain;
    2 per tap, ~15 for the Laplacian, ~10 for an elementwise update).
    Returns ``(bound_ms, bound_by)``."""
    chain = 2 * sum(taps)
    vols, ops = {
        "normal_apply": (2, chain + 15),        # v in, q out
        "cg_step": (4, chain + 17),             # r p in, p' q out
        "cg_update": (6, 8),                    # x r p q in, x r out
        "admm_tail": (5 + 8 if nd == 3 else 4 + 6, 40),
        "admm_record": (2, chain + 20),         # x b in, two scalars out
        "tik_clip": (2, 1),                     # in, out
        "blur_apply": (4, chain + 20),          # y x in, free rk out
        "irls_head": (4, chain + 10),           # x b in, wts y out
        "weighted_apply": (6, 2 * chain + 25),  # r p free wts in, p' q out
        "irls_step": (3, 2),                    # x xk in, x out
        "pd_dual": ((1 + 2 * nd) * batch, 12 * nd),
        "pd_primal": ((2 + nd + 2) * batch + 1, 10 + 3 * nd),
        "pd_record": (batch + 1, 10 + 3 * nd),
    }[name]
    return bound(4.0 * n * vols, float(n) * ops * batch)


_LAP = [time.perf_counter()]


def lap(label):
    """Print the seconds since the last ``lap`` (or the start)."""
    now = time.perf_counter()
    print("%s: %.1f s" % (label, now - _LAP[0]))
    _LAP[0] = now


# ------------------------------------------------------------- phase 3 --

def kernel_cases(B, F, st, shape, device, rng):
    """Run every kernel and its plain version on the same inputs; return
    {name: (max |Δ| / max |ref| over all outputs, CG scalars included,
    max |Δ| over the volume outputs)}."""
    import torch

    def rand(*shp, lo=0.0):
        return torch.as_tensor(rng.rand(*shp).astype(np.float32) + lo,
                               device=device)

    out = {}

    def record(name, pairs):
        rels = [max_rel(g, r) for g, r in pairs]
        abss = [float((g - r).abs().max()) for g, r in pairs
                if g.dim() >= 3]
        prev = out.get(name, (0.0, 0.0))
        out[name] = (max(prev[0], max(rels)), max(prev[1], max(abss)))

    v, rhs = rand(*shape), rand(*shape)
    record("normal_apply", [(B.normal_apply(v, st.normal, st.inv_h2, RHO),
                             B.normal_apply_plain(v, st.normal, st.inv_h2,
                                                  RHO))])
    record("normal_apply", [(B.normal_apply(v, st.blur, st.inv_h2, 0.0),
                             B.normal_apply_plain(v, st.blur, st.inv_h2,
                                                  0.0))])
    sk, sp = B.new_scalars(device), B.new_scalars(device)
    rk = B.normal_apply(v, st.normal, st.inv_h2, RHO, rhs=rhs, scal=sk)
    rp = B.normal_apply_plain(v, st.normal, st.inv_h2, RHO, rhs=rhs,
                              scal=sp)
    record("normal_apply", [(rk, rp), (sk[:1], sp[:1])])

    r, p = rand(*shape), rand(*shape, lo=-0.5)
    for first in (True, False):
        init = torch.tensor([float(torch.sum(r * r)), 0.0, 0.0, 0.83],
                            dtype=torch.float64, device=device)
        sk, sp = init.clone(), init.clone()
        pk, qk = B.cg_step(r, p, sk, st.normal, st.inv_h2, RHO, first=first)
        pp, qp = B.cg_step_plain(r, p, sp, st.normal, st.inv_h2, RHO,
                                 first=first)
        record("cg_step", [(pk, pp), (qk, qp), (sk[1:3], sp[1:3])])

    x, q = rand(*shape), rand(*shape, lo=-0.5)
    sk = torch.tensor([float(torch.sum(r * r)), 0.0, 0.31, 0.0],
                      dtype=torch.float64, device=device)
    sp = sk.clone()
    xk, rk, xp, rp = x.clone(), r.clone(), x.clone(), r.clone()
    B.cg_update(xk, rk, p, q, sk)
    B.cg_update_plain(xp, rp, p, q, sp)
    record("cg_update", [(xk, xp), (rk, rp), (sk[[0, 3]], sp[[0, 3]])])

    xs = rand(*shape, lo=-0.3)
    vk, wk = rand(3, *shape, lo=-0.5), rand(3, *shape, lo=-0.5)
    tau = float(np.float32(ALPHA) / np.float32(RHO))
    for init in (True, False):
        xk, vk2, wk2 = xs.clone(), vk.clone(), wk.clone()
        xp, vp2, wp2 = xs.clone(), vk.clone(), wk.clone()
        hk = F.admm_tail(xk, vk2, wk2, rhs, st.inv_h, tau, RHO, init=init)
        hp = F.admm_tail_plain(xp, vp2, wp2, rhs, st.inv_h, tau, RHO,
                               init=init)
        record("admm_tail", [(xk, xp), (vk2, vp2), (wk2, wp2), (hk, hp)])
    return out


def kernel_times(B, F, st, shape, device, rng, reps):
    """(kernel ms, plain ms) per call of each kernel at ``shape``."""
    import torch

    def rand(*shp):
        return torch.as_tensor(rng.rand(*shp).astype(np.float32),
                               device=device)

    v, r, p, q, x = (rand(*shape) for _ in range(5))
    vv, ww = rand(3, *shape), rand(3, *shape)
    tau = float(np.float32(ALPHA) / np.float32(RHO))
    s = torch.tensor([1.0, 1.0, 1e-3, 0.5], dtype=torch.float64,
                     device=device)
    calls = {
        "normal_apply": (
            lambda: B.normal_apply(v, st.normal, st.inv_h2, RHO),
            lambda: B.normal_apply_plain(v, st.normal, st.inv_h2, RHO)),
        "cg_step": (
            lambda: B.cg_step(r, p, s, st.normal, st.inv_h2, RHO),
            lambda: B.cg_step_plain(r, p, s, st.normal, st.inv_h2, RHO)),
        "cg_update": (
            lambda: B.cg_update(x, r, p, q, s),
            lambda: B.cg_update_plain(x, r, p, q, s)),
        "admm_tail": (
            lambda: F.admm_tail(x, vv, ww, v, st.inv_h, tau, RHO),
            lambda: F.admm_tail_plain(x, vv, ww, v, st.inv_h, tau, RHO)),
    }
    return {k: (cuda_ms(kf, reps), cuda_ms(pf, reps))
            for k, (kf, pf) in calls.items()}


# ----------------------------------------------------- phases 7-11 (PD) --

def pd_objective(x, b, alpha, ell1):
    """``Σ|x−b|`` (L1 types) or ``Σ(x−b)²`` plus ``α·Σ‖∇x‖₂`` in float64
    on the tensors' device: isotropic TV with zero-padded forward
    differences and unit spacing (the study's ``Data + α·Reg`` for TV
    types, benchmarks/suite.py:532)."""
    import torch

    from nsol_tpu_torch.ops import grad as G

    x64, b64 = x.double(), b.double()
    d = x64 - b64
    data = torch.sum(d.abs()) if ell1 else torch.sum(d * d)
    g = G.gradient(x64)
    return float(data + alpha * torch.sum(torch.sqrt(torch.sum(g * g, 0))))


def pd_unit_cases(F, interop, shape, device, rng, rtype, alg):
    """Every PD unit and its plain version on the same random inputs (a
    batch of 3 alphas, anisotropic spacing); {unit: (max |Δ| / max |ref|,
    max |Δ|)} over x, x̄, p and the records."""
    import torch

    nd = len(shape)
    ell1, huber = rtype.endswith("L1"), rtype.startswith("Huber")
    inv_h = tuple(float(np.float32(1.0 / h)) for h in PD_SPACING[:nd])
    rows = [F._pd_schedules(a, PD_L2, 4, alg) for a in PD_UNIT_ALPHAS]
    sched = interop.pd_schedules(*(np.stack(c) for c in zip(*rows)), device)
    nb = len(PD_UNIT_ALPHAS)

    def rand(*shp, lo=0.0):
        return torch.as_tensor(rng.rand(*shp).astype(np.float32) + lo,
                               device=device)

    x, xm, b = rand(nb, *shape), rand(nb, *shape), rand(*shape)
    p = rand(nb, nd, *shape, lo=-0.5)
    out = {}

    def record(name, pairs):
        rel = max(max_rel(g, r) for g, r in pairs)
        ab = max(float((g - r).abs().max()) for g, r in pairs)
        out[name] = (rel, ab)

    pk, pp = p.clone(), p.clone()
    F.pd_dual(xm, pk, sched, 2, inv_h, huber)
    F.pd_dual_plain(xm, pp, sched, 2, inv_h, huber)
    record("pd_dual", [(pk, pp)])
    xk, mk, xp, mp = x.clone(), xm.clone(), x.clone(), xm.clone()
    F.pd_primal(xk, mk, p, b, sched, 1, inv_h, ell1)
    F.pd_primal_plain(xp, mp, p, b, sched, 1, inv_h, ell1)
    record("pd_primal", [(xk, xp), (mk, mp)])
    rk = [torch.zeros(nb, 5, dtype=torch.float64, device=device)
          for _ in range(4)]
    F.pd_record(x, b, rk[0], rk[1], 3, inv_h, ell1, huber, 0.1)
    F.pd_record_plain(x, b, rk[2], rk[3], 3, inv_h, ell1, huber, 0.1)
    record("pd_record", [(rk[0], rk[2]), (rk[1], rk[3])])
    return out


def pd_unit_times(F, interop, shape, nb, device, reps):
    """(kernel ms, plain ms) per call of each PD unit on a batch of ``nb``
    images of ``shape`` (TVL2 ALG2)."""
    import torch

    rng = np.random.RandomState(2)
    nd = len(shape)
    inv_h = (1.0,) * nd
    alphas = np.linspace(0.01, 1.5, nb, dtype=np.float32)
    rows = [F._pd_schedules(a, PD_L2, ITERATIONS, "ALG2") for a in alphas]
    sched = interop.pd_schedules(*(np.stack(c) for c in zip(*rows)), device)

    def rand(*shp):
        return torch.as_tensor(rng.rand(*shp).astype(np.float32),
                               device=device)

    x, xm, b, p = rand(nb, *shape), rand(nb, *shape), rand(*shape), \
        rand(nb, nd, *shape)
    reg = torch.zeros(nb, ITERATIONS + 1, dtype=torch.float64, device=device)
    data = torch.zeros_like(reg)
    calls = {
        "pd_dual": (lambda: F.pd_dual(xm, p, sched, 1, inv_h),
                    lambda: F.pd_dual_plain(xm, p, sched, 1, inv_h)),
        "pd_primal": (
            lambda: F.pd_primal(x, xm, p, b, sched, 1, inv_h),
            lambda: F.pd_primal_plain(x, xm, p, b, sched, 1, inv_h)),
        "pd_record": (
            lambda: F.pd_record(x, b, reg, data, 1, inv_h),
            lambda: F.pd_record_plain(x, b, reg, data, 1, inv_h)),
    }
    return {k: (cuda_ms(kf, reps), cuda_ms(pf, max(2, reps // 4)))
            for k, (kf, pf) in calls.items()}


def pd_check_pair(solve, b, alpha, rtype, where, obj_tol=None, vox_tol=None):
    """Kernel vs plain on the card for one solve: (objective, objective
    rel, voxel rel), gated at ``obj_tol`` and ``vox_tol``."""
    obj_tol = PD_OBJ_TOL if obj_tol is None else obj_tol
    vox_tol = KERNEL_TOL if vox_tol is None else vox_tol
    x_k = solve(b, b, alpha, PD_L2)
    x_p = solve.plain(b, b, alpha, PD_L2)
    ell1 = rtype.endswith("L1")
    obj_k = pd_objective(x_k, b, alpha, ell1)
    obj_p = pd_objective(x_p, b, alpha, ell1)
    rel = abs(obj_k - obj_p) / abs(obj_p)
    vox = float((x_k - x_p).abs().max() / x_k.abs().max())
    require(bool(x_k.isfinite().all()) and x_k.shape == b.shape,
            "%s: %s result not finite or misshapen" % (where, rtype))
    require(rel <= obj_tol and vox <= vox_tol,
            "%s: %s kernel vs plain objective rel %.3g voxel %.3g"
            % (where, rtype, rel, vox))
    return obj_k, rel, vox


def run_pd_phases(device, card):
    """Phases 7-11: the primal-dual denoising slice. Returns the launch
    counts of the sweep's path, each unit's max |Δ| against its plain
    version at 1024² and its (kernel ms, plain ms) per call at the sweep's
    shape."""
    import torch

    from nsol_tpu_torch import data, interop
    from nsol_tpu_torch.cli import run_denoising
    from nsol_tpu_torch.io import DataReader, read_nifti, read_png, \
        write_nifti
    from nsol_tpu_torch.ops.cuda import fused as F

    def tensor(a):
        return interop.to_torch(np.asarray(a, np.float32), device)

    # phase 7: PD units vs plain on the card
    rng = np.random.RandomState(7)
    err = {k: 0.0 for k in F.PD_UNITS}
    for shape in ((37, 53), (1024, 1024), (37, 45, 53), (5, 40, 33)):
        worst = {k: 0.0 for k in F.PD_UNITS}
        for rtype in PD_TYPES:
            for alg in PD_ALGS:
                res = pd_unit_cases(F, interop, shape, device, rng, rtype,
                                    alg)
                torch.cuda.synchronize()
                for k, (rel, ab) in res.items():
                    require(rel <= KERNEL_TOL, "phase 7: %s %s %s %s rel "
                            "%.3g > %g" % (k, rtype, alg, shape, rel,
                                           KERNEL_TOL))
                    worst[k] = max(worst[k], rel)
                    if shape == (1024, 1024):
                        err[k] = max(err[k], ab)
        print("phase 7 PD units %s (12 type x schedule pairs, B=3, "
              "anisotropic): %s" % ("x".join(map(str, shape)), ", ".join(
                  "%s %.2e" % kv for kv in worst.items())))

    # phase 8: denoising main path, 2-D (Lena 256², TVL2 ALG2)
    lena = read_png(data.path("2D_Lena_256_noise.png")).astype(np.float64)
    b = tensor(lena / lena.max())
    solve = F.make_fused_pd_denoise_solver(b.shape, "TVL2", "ALG2",
                                           ITERATIONS)
    solve(b, b, PD_ALPHA, PD_L2)  # warm-up (schedules, allocator)
    torch.cuda.synchronize()
    F.reset_counts()
    x_k = solve(b, b, PD_ALPHA, PD_L2)
    torch.cuda.synchronize()
    launches, plain_calls = F.launch_counts(F.PD_UNITS), F.plain_counts()
    require(launches["pd_dual"] > 0 and launches["pd_primal"] > 0,
            "phase 8: a kernel was not launched: %s" % launches)
    require(all(n == 0 for n in plain_calls.values()),
            "phase 8: a plain version ran: %s" % plain_calls)
    obj = pd_objective(x_k, b, PD_ALPHA, False)
    dev = abs(obj - LENA_ANCHOR) / LENA_ANCHOR
    require(dev <= PD_ANCHOR_BAND, "phase 8: objective %.6f deviates %.3g "
            "from %.6f" % (obj, dev, LENA_ANCHOR))
    _, rel, vox = pd_check_pair(solve, b, PD_ALPHA, "TVL2", "phase 8")
    ms_k = cuda_ms(lambda: solve(b, b, PD_ALPHA, PD_L2), reps=20, warmup=2)
    ms_p = cuda_ms(lambda: solve.plain(b, b, PD_ALPHA, PD_L2), reps=10)
    print("phase 8 main path Lena 256^2 TVL2/ALG2: objective %.6f (anchor "
          "%.6f, rel dev %.2e); kernel vs plain objective rel %.2e, voxel "
          "%.2e; launches %s; plain calls %s; kernel %.4f ms/solve, plain "
          "%.4f ms/solve [%s]" % (obj, LENA_ANCHOR, dev, rel, vox, launches,
                                  sum(plain_calls.values()), ms_k, ms_p,
                                  card))
    # α 0.5 as well: at α 0.03 the L1 types' threshold τ/α exceeds
    # τ|div p| ≤ 2·ndim·τ, so x stays at b and the ℓ1 prox is idle
    for alpha in (PD_ALPHA, 0.5):
        pairs = []
        for rtype in PD_TYPES:
            for alg in PD_ALGS:
                s = F.make_fused_pd_denoise_solver(b.shape, rtype, alg,
                                                   ITERATIONS)
                o, rel, vox = pd_check_pair(s, b, alpha, rtype, "phase 8")
                pairs.append("%s/%s %.4f %.1e %.1e"
                             % (rtype, alg, o, rel, vox))
        print("phase 8 Lena 256^2 all pairs at alpha %g (objective, kernel "
              "vs plain objective rel, voxel): %s"
              % (alpha, "; ".join(pairs)))

    # phase 9: L-curve sweep at full width, Man 1024² x 64 alphas
    man = read_png(data.path("2D_Man_1024.png")).astype(np.float64)
    bm = tensor(man / man.max())
    alphas = np.linspace(0.01, 1.5, 64, dtype=np.float32)
    sweep = F.make_fused_pd_denoise_solver(bm.shape, "TVL2", "ALG2",
                                           ITERATIONS, record=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    F.reset_counts()
    xs, recs = sweep(bm, bm, alphas, PD_L2)
    torch.cuda.synchronize()
    launches, plain_calls = F.launch_counts(F.PD_UNITS), F.plain_counts()
    peak_k = torch.cuda.max_memory_allocated() - base
    require(all(n > 0 for n in launches.values()),
            "phase 9: a kernel was not launched: %s" % launches)
    require(all(n == 0 for n in plain_calls.values()),
            "phase 9: a plain version ran: %s" % plain_calls)
    require(xs.shape == (64,) + bm.shape and bool(xs.isfinite().all())
            and recs["Reg"].shape == (64, ITERATIONS + 1),
            "phase 9: results not finite or misshapen")
    rec_obj = {}
    for i, anchor in MAN_ANCHORS.items():
        a = float(alphas[i])
        rec_obj[i] = float(recs["Data"][i, -1]) + a * float(recs["Reg"][i,
                                                                       -1])
        host = pd_objective(xs[i], bm, a, False)
        dev = abs(rec_obj[i] - anchor) / anchor
        require(dev <= PD_ANCHOR_BAND, "phase 9: alpha[%d] records give "
                "%.6f, anchor %.6f (rel %.3g)" % (i, rec_obj[i], anchor, dev))
        require(abs(host - rec_obj[i]) / abs(host) <= PD_ANCHOR_BAND,
                "phase 9: alpha[%d] records %.6f vs float64 from x %.6f"
                % (i, rec_obj[i], host))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    xs_p, recs_p = sweep.plain(bm, bm, alphas, PD_L2)
    torch.cuda.synchronize()
    peak_p = torch.cuda.max_memory_allocated() - base
    vox = float((xs - xs_p).abs().max() / xs_p.abs().max())
    rrel = max(max_rel(recs[k], recs_p[k]) for k in ("Reg", "Data"))
    require(vox <= KERNEL_TOL and rrel <= KERNEL_TOL,
            "phase 9: kernel vs plain voxel %.3g records %.3g" % (vox, rrel))
    del xs_p, recs_p
    sweep_launches = launches
    ms_k = cuda_ms(lambda: sweep(bm, bm, alphas, PD_L2), reps=5)
    ms_p = cuda_ms(lambda: sweep.plain(bm, bm, alphas, PD_L2), reps=3)
    print("phase 9 sweep Man 1024^2 x 64 alphas TVL2/ALG2 records: "
          "objectives %s (anchors %s); kernel vs plain voxel %.2e, records "
          "%.2e; launches %s; kernel %.3f s/sweep = %.1f solves/s = %.0f "
          "it/s, peak %.1f MiB; plain %.3f s/sweep = %.1f solves/s, peak "
          "%.1f MiB [%s]" % (
              {i: round(v, 6) for i, v in rec_obj.items()}, MAN_ANCHORS,
              vox, rrel, launches, ms_k / 1e3, 64e3 / ms_k,
              64e3 * ITERATIONS / ms_k, peak_k / 2 ** 20, ms_p / 1e3,
              64e3 / ms_p, peak_p / 2 ** 20, card))
    times = pd_unit_times(F, interop, bm.shape, 64, device, reps=20)
    times_lena = pd_unit_times(F, interop, b.shape, 1, device, reps=50)
    print("phase 9 per-call (kernel ms, plain ms) at 64 x 1024^2: %s; at "
          "1 x 256^2: %s" % tuple(", ".join(
              "%s %.4f/%.4f" % (k, a, p) for k, (a, p) in t.items())
              for t in (times, times_lena)))
    del xs, recs, sweep

    # phase 10: 3-D
    phantom = read_nifti(data.path("3D_SheppLoganPhantom_64.nii.gz")) \
        .data.astype(np.float64)
    noisy = phantom + np.random.RandomState(0).normal(
        0, 0.05 * phantom.max(), phantom.shape)
    b3 = tensor(noisy / noisy.max())
    res3 = []
    for (rtype, alg), anchor in PHANTOM_ANCHORS.items():
        s3 = F.make_fused_pd_denoise_solver(b3.shape, rtype, alg,
                                            ITERATIONS)
        o, rel, vox = pd_check_pair(s3, b3, PD_ALPHA, rtype, "phase 10a",
                                    obj_tol=1e-5)
        dev = abs(o - anchor) / anchor
        require(dev <= PD_ANCHOR_BAND, "phase 10a: %s/%s objective %.6f, "
                "anchor %.6f (rel %.3g)" % (rtype, alg, o, anchor, dev))
        res3.append("%s/%s %.6f (anchor %.6f, dev %.1e; vs plain %.1e, "
                    "%.1e)" % (rtype, alg, o, anchor, dev, rel, vox))
    print("phase 10a phantom 64^3: %s" % "; ".join(res3))
    big = np.repeat(np.repeat(np.repeat(phantom, 4, 0), 4, 1), 4, 2)
    big = big + np.random.RandomState(1).normal(0, 0.05 * phantom.max(),
                                                big.shape)
    bb = tensor(big / big.max())
    del big
    s256 = F.make_fused_pd_denoise_solver(bb.shape, "TVL2", "ALG2",
                                          ITERATIONS)
    o, rel, vox = pd_check_pair(s256, bb, PD_ALPHA, "TVL2", "phase 10b",
                                obj_tol=1e-5, vox_tol=1e-4)
    ms_k = cuda_ms(lambda: s256(bb, bb, PD_ALPHA, PD_L2), reps=5)
    ms_p = cuda_ms(lambda: s256.plain(bb, bb, PD_ALPHA, PD_L2), reps=2)
    print("phase 10b 256^3 TVL2/ALG2: objective %.4f; kernel vs plain "
          "objective rel %.2e, voxel %.2e; kernel %.3f ms/solve, plain %.3f "
          "ms/solve [%s]" % (o, rel, vox, ms_k, ms_p, card))
    del bb, s256

    # phase 11: the denoising CLI
    with tempfile.TemporaryDirectory() as tmp:
        nii = os.path.join(tmp, "noisy.nii.gz")
        write_nifti(noisy.astype(np.float32), nii, spacing=np.ones(3))
        for obs, ext in ((data.path("2D_Lena_256_noise.png"), "mat"),
                         (nii, "nii.gz")):
            out = os.path.join(tmp, "x." + ext)
            rc = run_denoising.main(["--observation", obs, "--result", out])
            require(rc == 0, "phase 11: CLI returned %r" % rc)
            reader = DataReader(out)
            reader.read_data()
            recon = reader.get_data()
            obs_reader = DataReader(obs)
            obs_reader.read_data()
            bo = obs_reader.get_data()
            scale = np.max(bo)
            bt = tensor(bo / scale)
            lib = interop.to_numpy(F.make_fused_pd_denoise_solver(
                bo.shape, "TVL2", "ALG2", ITERATIONS)(
                    bt, bt, PD_ALPHA, PD_L2)).astype(np.float64) * scale
            cli_dev = float(np.max(np.abs(recon - lib)) / np.max(np.abs(lib)))
            require(recon.shape == bo.shape and np.all(np.isfinite(recon)),
                    "phase 11: CLI result not finite or misshapen")
            require(cli_dev <= KERNEL_TOL,
                    "phase 11: CLI vs library %.3g" % cli_dev)
            print("phase 11 CLI %s: shape %s finite, max|cli - library|/max "
                  "%.3e" % (os.path.basename(obs), recon.shape, cli_dev))
    return {"launches": sweep_launches, "err": err, "times": times}


# ------------------------------------------------ phases 12-15 (robust) --

def robust_objective(x, b, A64, alpha):
    """½Σhuber(r²) + α·TV(x), r = A x − b, in float64 on the tensors'
    device (benchmarks/suite.py:163, :935)."""
    import torch

    from nsol_tpu_torch.ops import grad as G
    from nsol_tpu_torch.ops import losses

    x64 = x.double()
    r = A64(x64) - b.double()
    g = G.gradient(x64)
    return float(0.5 * torch.sum(losses.huber(r * r))
                 + alpha * torch.sum(torch.sqrt(torch.sum(g * g, 0))))


def robust_unit_cases(R, B, st, shape, device, rng):
    """Every robust unit and its plain version on the same random inputs:
    {unit: (max |Δ| / max |ref|, max |Δ|)} over all outputs, CG scalars
    included; ``irls_head`` for the four losses at C = 1 and 0.3,
    ``weighted_apply`` with a random active set, first trip and not."""
    import torch

    def rand(lo=0.0, scale=1.0):
        return torch.as_tensor((rng.rand(*shape) * scale + lo)
                               .astype(np.float32), device=device)

    x, b, y, r, p = rand(-0.3), rand(), rand(-0.5), rand(-0.5), rand(-0.5)
    wts, free = rand(0.1, 0.9), (rand() > 0.3).float()
    out = {}

    def record(name, pairs):
        rel = max(max_rel(g, q) for g, q in pairs)
        ab = max(float((g - q).abs().max()) for g, q in pairs)
        prev = out.get(name, (0.0, 0.0))
        out[name] = (max(prev[0], rel), max(prev[1], ab))

    record("blur_apply", [(R.blur_apply(y, st.blur, st.inv_h2),
                           R.blur_apply_plain(y, st.blur, st.inv_h2))])
    record("blur_apply", [(R.blur_apply(y, st.blur, st.inv_h2, x, RHO),
                           R.blur_apply_plain(y, st.blur, st.inv_h2, x,
                                              RHO))])
    sk, sp = B.new_scalars(device), B.new_scalars(device)
    gk = R.blur_apply(y, st.blur, st.inv_h2, x, RHO, scal=sk)
    gp = R.blur_apply_plain(y, st.blur, st.inv_h2, x, RHO, scal=sp)
    record("blur_apply", list(zip(gk, gp)) + [(sk[:1], sp[:1])])
    for loss in ROBUST_LOSSES:
        for scale in (1.0, 0.3):
            record("irls_head", list(zip(
                R.irls_head(x, b, st.blur, loss, scale),
                R.irls_head_plain(x, b, st.blur, loss, scale))))
    for first in (True, False):
        init = torch.tensor([3.0, 0.0, 0.0, 0.83], dtype=torch.float64,
                            device=device)
        sk, sp = init.clone(), init.clone()
        got = R.weighted_apply(r, p, free, wts, sk, st.blur, st.inv_h2, RHO,
                               first=first)
        ref = R.weighted_apply_plain(r, p, free, wts, sp, st.blur, st.inv_h2,
                                     RHO, first=first)
        record("weighted_apply", list(zip(got, ref)) + [(sk[1:3], sp[1:3])])
    xk, xp = x.clone(), x.clone()
    R.irls_step(xk, p)
    R.irls_step_plain(xp, p)
    record("irls_step", [(xk, xp)])
    return out


def robust_unit_times(R, B, st, shape, device, reps):
    """(kernel ms, plain ms) per call of each robust unit at ``shape``
    (huber, C = 1), and each unit's max |Δ| against its plain version."""
    import torch

    rng = np.random.RandomState(3)

    def rand(lo=0.0):
        return torch.as_tensor(rng.rand(*shape).astype(np.float32) + lo,
                               device=device)

    x, b, y, r, p, wts = rand(-0.3), rand(), rand(-0.5), rand(-0.5), \
        rand(-0.5), rand(0.1)
    free = (rand() > 0.3).float()
    s = torch.tensor([1.0, 1.0, 1e-3, 0.5], dtype=torch.float64,
                     device=device)
    xs = x.clone()
    calls = {
        "blur_apply": (
            lambda: R.blur_apply(y, st.blur, st.inv_h2, x, RHO, scal=s),
            lambda: R.blur_apply_plain(y, st.blur, st.inv_h2, x, RHO,
                                       scal=s)),
        "irls_head": (
            lambda: R.irls_head(x, b, st.blur, "huber", 1.0),
            lambda: R.irls_head_plain(x, b, st.blur, "huber", 1.0)),
        "weighted_apply": (
            lambda: R.weighted_apply(r, p, free, wts, s, st.blur, st.inv_h2,
                                     RHO),
            lambda: R.weighted_apply_plain(r, p, free, wts, s, st.blur,
                                           st.inv_h2, RHO)),
        "irls_step": (lambda: R.irls_step(xs, p),
                      lambda: R.irls_step_plain(xs, p)),
    }
    times, err = {}, {}
    for k, (kf, pf) in calls.items():
        if k == "irls_step":
            got, ref = x.clone(), x.clone()
            R.irls_step(got, p)
            R.irls_step_plain(ref, p)
            pairs = [(got, ref)]
        else:
            pairs = list(zip(kf(), pf()))
        err[k] = max(float((g - q).abs().max()) for g, q in pairs)
        times[k] = (cuda_ms(kf, reps), cuda_ms(pf, max(2, reps // 4)))
    return times, err


def run_robust_phases(device, card):
    """Phases 12-15: robust TV deconvolution by ADMM + IRLS. Returns the
    launch counts of the 256³ solve, and each unit's max |Δ| against its
    plain version and (kernel ms, plain ms) per call at 256³."""
    import torch

    from nsol_tpu_torch import data, interop
    from nsol_tpu_torch.cli import run_deconvolution
    from nsol_tpu_torch.io import DataReader, read_png
    from nsol_tpu_torch.ops import conv as C
    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import fused as F
    from nsol_tpu_torch.ops.cuda import robust as R

    # phase 12: robust units vs plain on the card
    rng = np.random.RandomState(12)
    aniso = (np.diag([1.3, 0.8, 1.1]) ** 2, np.array(PD_SPACING))
    for label, shape in (("iso", (64, 64, 64)), ("aniso", (37, 45, 53)),
                         ("aniso", (5, 40, 33)), ("iso", (256, 256)),
                         ("aniso", (37, 53))):
        nd = len(shape)
        cov, sp = (np.diag([SIGMA ** 2] * nd), None) if label == "iso" \
            else (aniso[0][:nd, :nd], aniso[1][:nd])
        st = B.Stencils.from_cov(cov, 3, sp, device)
        res = robust_unit_cases(R, B, st, shape, device, rng)
        torch.cuda.synchronize()
        for k, (rel, _) in res.items():
            require(rel <= KERNEL_TOL, "phase 12: %s %s %s rel %.3g > %g"
                    % (k, label, shape, rel, KERNEL_TOL))
        print("phase 12 robust units %s %s taps %s: %s" % (
            label, "x".join(map(str, shape)), st.blur.lengths, ", ".join(
                "%s %.2e" % (k, v[0]) for k, v in res.items())))

    # phase 13: robust main path, 2-D (Lena 256² blurred + noisy, huber)
    its, sweeps, cgi = ROBUST_ITERS["lena"]
    lena = read_png(data.path("2D_Lena_256_blur_noise.png")) \
        .astype(np.float64)
    b = interop.to_torch((lena / lena.max()).astype(np.float32), device)
    cov2 = np.diag([SIGMA ** 2] * 2)
    A2, _ = C.make_blur_operators(cov2, alpha_cut=3, dtype=np.float64)
    solve = F.make_fused_admm_solver(b.shape, cov2, iterations=its,
                                     iter_max=sweeps, data_loss="huber",
                                     irls_cg_iters=cgi)
    solve(b, b, ALPHA, RHO)  # warm-up (stencils, allocator)
    torch.cuda.synchronize()
    F.reset_counts()
    x_k = solve(b, b, ALPHA, RHO)
    torch.cuda.synchronize()
    launches, plain_calls = F.launch_counts(F.ROBUST_UNITS), F.plain_counts()
    require(all(n > 0 for n in launches.values()),
            "phase 13: a kernel was not launched: %s" % launches)
    require(all(n == 0 for n in plain_calls.values()),
            "phase 13: a plain version ran: %s" % plain_calls)
    require(bool(x_k.isfinite().all()) and x_k.shape == b.shape,
            "phase 13: result not finite or misshapen")
    obj = robust_objective(x_k, b, A2, ALPHA)
    dev = abs(obj - LENA_ROBUST_ANCHOR) / LENA_ROBUST_ANCHOR
    require(dev <= ROBUST_ANCHOR_BAND, "phase 13: objective %.6f deviates "
            "%.3g from %.6f" % (obj, dev, LENA_ROBUST_ANCHOR))
    x_p = solve.plain(b, b, ALPHA, RHO)
    obj_p = robust_objective(x_p, b, A2, ALPHA)
    rel = abs(obj - obj_p) / abs(obj_p)
    vox = float((x_k - x_p).abs().max() / x_k.abs().max())
    require(rel <= SOLVE_OBJ_TOL and vox <= SOLVE_VOX_TOL,
            "phase 13: kernel vs plain objective rel %.3g voxel %.3g"
            % (rel, vox))
    same = torch.equal(solve(b, b, 1.0, RHO), x_k)
    require(same, "phase 13: x at alpha 1.0 differs from x at alpha %g"
            % ALPHA)
    ms_k = cuda_ms(lambda: solve(b, b, ALPHA, RHO), reps=20, warmup=2)
    ms_p = cuda_ms(lambda: solve.plain(b, b, ALPHA, RHO), reps=3)
    print("phase 13 main path Lena 256^2 huber %dx%dx%d: objective %.6f "
          "(anchor %.6f, rel dev %.2e); kernel vs plain objective rel %.2e, "
          "voxel %.2e; x at alpha 1.0 identical: %s; launches %s; plain "
          "calls %s; kernel %.4f ms/solve, plain %.4f ms/solve [%s]"
          % (its, sweeps, cgi, obj, LENA_ROBUST_ANCHOR, dev, rel, vox, same,
             launches, sum(plain_calls.values()), ms_k, ms_p, card))
    del x_p

    # phase 14: the 256³ robust suite solve (salt-and-pepper outliers)
    its, sweeps, cgi = ROBUST_ITERS["scale"]
    big = SCALE_SHAPE
    iso = np.diag([SIGMA ** 2] * 3)
    rs = np.random.RandomState(0)
    xt = interop.to_torch((rs.rand(*big) > 0.7).astype(np.float32), device)
    A, _ = C.make_blur_operators(iso, alpha_cut=3, dtype=np.float32)
    bb = A(xt).contiguous()
    del xt
    noise = (rs.rand(*big) < 0.01).astype(np.float32) \
        * rs.randn(*big).astype(np.float32)
    bb += 0.5 * interop.to_torch(noise, device)
    del noise
    A64, _ = C.make_blur_operators(iso, alpha_cut=3, dtype=np.float64)
    rsolve = R.blocked_robust_admm_solve(big, iso, iterations=its,
                                         iter_max=sweeps, irls_cg_iters=cgi,
                                         data_loss="huber")
    torch.cuda.synchronize()
    F.reset_counts()
    xb_k = rsolve(bb, bb, ALPHA, RHO)
    torch.cuda.synchronize()
    scale_launches = F.launch_counts(F.ROBUST_UNITS)
    plain_calls = F.plain_counts()
    require(all(n > 0 for n in scale_launches.values()),
            "phase 14: a kernel was not launched: %s" % scale_launches)
    require(all(n == 0 for n in plain_calls.values()),
            "phase 14: a plain version ran: %s" % plain_calls)
    require(bool(xb_k.isfinite().all()), "phase 14: result not finite")
    ob_k = robust_objective(xb_k, bb, A64, ALPHA)
    dev = abs(ob_k - SCALE_ROBUST_ANCHOR) / SCALE_ROBUST_ANCHOR
    require(dev <= ANCHOR_BAND, "phase 14: objective %.2f deviates %.4f%% "
            "from %.1f" % (ob_k, 100 * dev, SCALE_ROBUST_ANCHOR))
    held = {}
    ms_p = cuda_ms(lambda: held.update(x=rsolve.plain(bb, bb, ALPHA, RHO)),
                   reps=1, warmup=0)
    xb_p = held.pop("x")
    ob_p = robust_objective(xb_p, bb, A64, ALPHA)
    ob_rel = abs(ob_k - ob_p) / abs(ob_p)
    vox_b = float((xb_k - xb_p).abs().max() / xb_k.abs().max())
    require(ob_rel <= SOLVE_OBJ_TOL and vox_b <= SOLVE_VOX_TOL,
            "phase 14: kernel vs plain objective rel %.3g voxel %.3g"
            % (ob_rel, vox_b))
    del xb_p
    # tikhonov_solve clips x0 on entry (tikhonov.py:130), the TPU kernels
    # and this solve do not; b has negative voxels here
    ob_c = robust_objective(rsolve(bb, torch.clamp(bb, min=0.0), ALPHA, RHO),
                            bb, A64, ALPHA)
    ms_k = cuda_ms(lambda: rsolve(bb, bb, ALPHA, RHO), reps=3)
    times, err = robust_unit_times(R, B, B.Stencils.from_cov(iso, 3, None,
                                                             device),
                                   big, device, reps=10)
    print("phase 14 scale 256^3 huber %dx%dx%d: objective %.2f (anchor %.1f, "
          "dev %.4f%%; with x0 clipped on entry %.2f, rel %.2e); kernel vs "
          "plain objective rel %.2e, voxel %.2e; launches %s; plain calls "
          "%s; kernel %.3f s/solve, plain %.3f s/solve; per-call (kernel ms, "
          "plain ms): %s [%s]"
          % (its, sweeps, cgi, ob_k, SCALE_ROBUST_ANCHOR, 100 * dev, ob_c,
             abs(ob_c - ob_k) / ob_k, ob_rel, vox_b, scale_launches,
             sum(plain_calls.values()), ms_k / 1e3, ms_p / 1e3, ", ".join(
                 "%s %.3f/%.3f" % (k, a, q) for k, (a, q) in times.items()),
             card))
    del bb, xb_k, rsolve

    # phase 15: the robust CLI route on the PNG
    its, sweeps, cgi = ROBUST_ITERS["lena"]
    obs = data.path("2D_Lena_256_blur_noise.png")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "x.mat")
        F.reset_counts()
        rc = run_deconvolution.main([
            "--observation", obs, "--result", out, "--solver", "ADMM",
            "--reconstruction-type", "TVL2", "--data-loss", "huber",
            "--alpha", str(ALPHA), "--blur", str(SIGMA), "--iterations",
            str(its), "--iter-max", str(sweeps), "--irls-cg-iters",
            str(cgi), "--device", "cuda"])
        require(rc == 0, "phase 15: CLI returned %r" % rc)
        cli_launches = F.launch_counts(F.ROBUST_UNITS)
        require(all(n > 0 for n in cli_launches.values()),
                "phase 15: a kernel was not launched: %s" % cli_launches)
        require(all(n == 0 for n in F.plain_counts().values()),
                "phase 15: a plain version ran: %s" % F.plain_counts())
        reader = DataReader(out)
        reader.read_data()
        recon = reader.get_data()
    lib = interop.to_numpy(x_k).astype(np.float64) * lena.max()
    cli_dev = float(np.max(np.abs(recon - lib)) / np.max(np.abs(lib)))
    require(recon.shape == lena.shape and np.all(np.isfinite(recon)),
            "phase 15: CLI result not finite or misshapen")
    require(cli_dev <= KERNEL_TOL, "phase 15: CLI vs library %.3g" % cli_dev)
    print("phase 15 CLI --data-loss huber %s: shape %s finite, max|cli - "
          "library|/max %.3e; launches %s, plain calls 0"
          % (os.path.basename(obs), recon.shape, cli_dev, cli_launches))
    return {"launches": scale_launches, "err": err, "times": times}


# ------------------------------------------------- phase 16 (slice units) --

TK_REGS = ("TK0", "TK1")
RECORD_LOSSES = ("linear",) + ROBUST_LOSSES


def slice_unit_cases(st, shape, device, rng):
    """The units the Tikhonov/study slice adds or extends, each against its
    plain version on the same random inputs: the TK0 and TK1 instances of
    the linear apply, CG step, gradient-form blur and weighted apply; on a
    2-D image the linear ADMM units run as a (1, Y, X) volume;
    ``admm_record`` for 5 losses at C = 1 and 0.3; ``tik_clip``. Returns
    {unit: (max |Δ| / max |ref|, max |Δ|)} over all outputs, CG scalars and
    records included."""
    import torch

    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import fused as F
    from nsol_tpu_torch.ops.cuda import record as Rec
    from nsol_tpu_torch.ops.cuda import robust as R
    from nsol_tpu_torch.ops.cuda import tikhonov as T

    nd = len(shape)

    def rand(lo=0.0, scale=1.0, lead=()):
        return torch.as_tensor((rng.rand(*(lead + shape)) * scale + lo)
                               .astype(np.float32), device=device)

    out = {}

    def record(name, pairs):
        rel = max(max_rel(g, q) for g, q in pairs)
        ab = max(float((g - q).abs().max()) for g, q in pairs)
        prev = out.get(name, (0.0, 0.0))
        out[name] = (max(prev[0], rel), max(prev[1], ab))

    v, rhs, r, p = rand(), rand(), rand(), rand(-0.5)
    x, b, y = rand(-0.3), rand(), rand(-0.5)
    wts, free = rand(0.1, 0.9), (rand() > 0.3).float()
    gamma = float(torch.sum(r * r))
    for reg in TK_REGS:
        def key(unit):
            return "%s %s" % (unit, reg)

        record(key("normal_apply"), [(
            B.normal_apply(v, st.normal, st.inv_h2, RHO, reg=reg),
            B.normal_apply_plain(v, st.normal, st.inv_h2, RHO, reg=reg))])
        sk, sp = B.new_scalars(device), B.new_scalars(device)
        record(key("normal_apply"), [
            (B.normal_apply(v, st.normal, st.inv_h2, RHO, rhs=rhs, scal=sk,
                            reg=reg),
             B.normal_apply_plain(v, st.normal, st.inv_h2, RHO, rhs=rhs,
                                  scal=sp, reg=reg)), (sk[:1], sp[:1])])
        for first in (True, False):
            init = torch.tensor([gamma, 0.0, 0.0, 0.83], dtype=torch.float64,
                                device=device)
            sk, sp = init.clone(), init.clone()
            got = B.cg_step(r, p, sk, st.normal, st.inv_h2, RHO, first=first,
                            reg=reg)
            ref = B.cg_step_plain(r, p, sp, st.normal, st.inv_h2, RHO,
                                  first=first, reg=reg)
            record(key("cg_step"), list(zip(got, ref)) + [(sk[1:3],
                                                            sp[1:3])])
        sk, sp = B.new_scalars(device), B.new_scalars(device)
        got = R.blur_apply(y, st.blur, st.inv_h2, x, RHO, scal=sk, reg=reg)
        ref = R.blur_apply_plain(y, st.blur, st.inv_h2, x, RHO, scal=sp,
                                 reg=reg)
        record(key("blur_apply"), list(zip(got, ref)) + [(sk[:1], sp[:1])])
        for first in (True, False):
            init = torch.tensor([3.0, 0.0, 0.0, 0.83], dtype=torch.float64,
                                device=device)
            sk, sp = init.clone(), init.clone()
            got = R.weighted_apply(r, p, free, wts, sk, st.blur, st.inv_h2,
                                   RHO, first=first, reg=reg)
            ref = R.weighted_apply_plain(r, p, free, wts, sp, st.blur,
                                         st.inv_h2, RHO, first=first, reg=reg)
            record(key("weighted_apply"), list(zip(got, ref))
                   + [(sk[1:3], sp[1:3])])
    if nd == 2:
        sk = torch.tensor([gamma, 0.0, 0.31, 0.0], dtype=torch.float64,
                          device=device)
        sp = sk.clone()
        xk, rk, xp, rp = x.clone(), r.clone(), x.clone(), r.clone()
        B.cg_update(xk, rk, p, v, sk)
        B.cg_update_plain(xp, rp, p, v, sp)
        record("cg_update", [(xk, xp), (rk, rp), (sk[[0, 3]], sp[[0, 3]])])
        vv, ww = rand(-0.5, lead=(2,)), rand(-0.5, lead=(2,))
        tau = float(np.float32(ALPHA) / np.float32(RHO))
        for init in (True, False):
            xk, vk, wk = x.clone(), vv.clone(), ww.clone()
            xp, vp, wp = x.clone(), vv.clone(), ww.clone()
            hk = F.admm_tail(xk, vk, wk, rhs, st.inv_h, tau, RHO, init=init)
            hp = F.admm_tail_plain(xp, vp, wp, rhs, st.inv_h, tau, RHO,
                                   init=init)
            record("admm_tail", [(xk, xp), (vk, vp), (wk, wp), (hk, hp)])
    for loss in RECORD_LOSSES:
        for scale in (1.0, 0.3):
            rk, rp = Rec.new_records(3, device), Rec.new_records(3, device)
            Rec.admm_record(x, b, st.blur, st.inv_h, loss, scale, *rk, 1)
            Rec.admm_record_plain(x, b, st.blur, st.inv_h, loss, scale, *rp, 1)
            record("admm_record", [(rk[0][1:2], rp[0][1:2]),
                                   (rk[1][1:2], rp[1][1:2])])
    ck, cp = torch.empty_like(x), torch.empty_like(x)
    T.tik_clip(ck, x)
    T.tik_clip_plain(cp, x)
    record("tik_clip", [(ck, cp)])
    return out


def slice_unit_times(st, shape, device, reps):
    """(kernel ms, plain ms, library ms or None) per call of the slice's
    new units at ``shape``: ``admm_record`` (huber, C = 1) and
    ``tik_clip``, whose library counterpart is one ``torch.clamp``."""
    import torch

    from nsol_tpu_torch.ops.cuda import record as Rec
    from nsol_tpu_torch.ops.cuda import tikhonov as T

    rng = np.random.RandomState(16)
    x = torch.as_tensor(rng.rand(*shape).astype(np.float32) - 0.3,
                        device=device)
    b = torch.as_tensor(rng.rand(*shape).astype(np.float32), device=device)
    o = torch.empty_like(x)
    rk = Rec.new_records(2, device)
    return {
        "admm_record": (
            cuda_ms(lambda: Rec.admm_record(x, b, st.blur, st.inv_h, "huber",
                                            1.0, *rk, 1), reps),
            cuda_ms(lambda: Rec.admm_record_plain(x, b, st.blur, st.inv_h,
                                                  "huber", 1.0, *rk, 1),
                    max(2, reps // 4)), None),
        "tik_clip": (cuda_ms(lambda: T.tik_clip(o, x), reps),
                     cuda_ms(lambda: T.tik_clip_plain(o, x), reps),
                     cuda_ms(lambda: torch.clamp(x, min=0.0, out=o), reps)),
    }


def run_unit_phase(device, card):
    """Phase 16: the slice's units against their plain versions on the
    card, 2-D and 3-D, isotropic and anisotropic, odd sizes; the new units'
    times at the Lena shape. Returns {unit: max |Δ| at 256²} and the
    times."""
    import torch

    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import fused as F
    from nsol_tpu_torch.ops.cuda import tikhonov as T

    rng = np.random.RandomState(16)
    aniso = (np.diag([1.3, 0.8, 1.1]) ** 2, np.array(PD_SPACING))
    err = {}
    for label, shape in (("iso", (64, 64, 64)), ("aniso", (37, 45, 53)),
                         ("aniso", (5, 40, 33)), ("iso", (256, 256)),
                         ("aniso", (37, 53))):
        nd = len(shape)
        cov, sp = (np.diag([SIGMA ** 2] * nd), None) if label == "iso" \
            else (aniso[0][:nd, :nd], aniso[1][:nd])
        st = B.Stencils.from_cov(cov, 3, sp, device)
        res = slice_unit_cases(st, shape, device, rng)
        torch.cuda.synchronize()
        for k, (rel, ab) in res.items():
            require(rel <= KERNEL_TOL, "phase 16: %s %s %s rel %.3g > %g"
                    % (k, label, shape, rel, KERNEL_TOL))
            if shape == (256, 256):
                unit = k.split()[0]
                err[unit] = max(err.get(unit, 0.0), ab)
        print("phase 16 slice units %s %s taps %s: %s" % (
            label, "x".join(map(str, shape)), st.blur.lengths, ", ".join(
                "%s %.2e" % (k, v[0]) for k, v in res.items())))
    # the whole C solves of the slice against their plain unit sequences
    for label, shape in (("aniso", (37, 53)), ("aniso", (13, 22, 17))):
        nd = len(shape)
        cov, sp = aniso[0][:nd, :nd], aniso[1][:nd]
        b = torch.as_tensor(rng.rand(*shape).astype(np.float32),
                            device=device)
        res = []
        for reg in TK_REGS:
            for loss, alphas in (("linear", [0.02, 0.3, 1.5]),
                                 ("huber", [0.05, 0.7])):
                s = T.make_fused_tikhonov_solver(shape, cov, spacing=sp,
                                                 reg=reg, iter_max=6,
                                                 data_loss=loss,
                                                 irls_cg_iters=4)
                xk = s(b, b, alphas, 0.3)
                xp = s.plain(b, b, alphas, 0.3)
                rel = max_rel(xk, xp)
                require(rel <= SOLVE_VOX_TOL and bool(xk.isfinite().all()),
                        "phase 16: Tikhonov %s %s %s voxel rel %.3g"
                        % (reg, loss, shape, rel))
                res.append("%s/%s %.1e" % (reg, loss, rel))
        for loss in ("linear", "huber"):
            s = F.make_fused_admm_solver(shape, cov, spacing=sp, iterations=4,
                                         iter_max=5, data_loss=loss,
                                         irls_cg_iters=4, record=True)
            xk, rk = s(b, b, 0.05, 0.5, data_loss_scale=0.3, record_dls=0.7)
            xp, rp = s.plain(b, b, 0.05, 0.5, data_loss_scale=0.3,
                             record_dls=0.7)
            rel = max(max_rel(xk, xp), max_rel(rk["Reg"], rp["Reg"]),
                      max_rel(rk["Data"], rp["Data"]))
            require(rel <= SOLVE_VOX_TOL and rk["Reg"].shape == (5,),
                    "phase 16: ADMM record %s %s rel %.3g" % (loss, shape,
                                                              rel))
            res.append("ADMM records/%s %.1e" % (loss, rel))
        torch.cuda.synchronize()
        print("phase 16 whole solves vs plain %s %s (voxel and record rel): "
              "%s" % (label, "x".join(map(str, shape)), ", ".join(res)))
    st = B.Stencils.from_cov(np.diag([SIGMA ** 2] * 2), 3, None, device)
    times = slice_unit_times(st, (256, 256), device, reps=200)
    print("phase 16 per-call 256^2 (kernel ms, plain ms, library ms): %s [%s]"
          % (", ".join("%s %.4f/%.4f/%s" % (k, a, p, "none" if lib is None
                                             else "%.4f" % lib)
                       for k, (a, p, lib) in times.items()), card))
    return {"err": err, "times": times, "taps": st.blur.lengths}


# ------------------------------------------- phases 17-19 (the studies) --

#: phase 17, Lena 256² Tikhonov studies (the sweeps of tests/
#: torch_anchors.py): 64 α for TK1L2/TK0L2 with CG 10 (the JAX package's
#: suite cell lena256_tk1l2_64alpha_sweep_cg10), every 8th α for the TK1L2
#: huber sweep at C = 1 with 5 MM sweeps × 8 CG
TK_ALPHAS = np.linspace(0.005, 0.5, 64, dtype=np.float32)
TK_ITER_MAX = 10
HUBER_STEP, HUBER_SCALE, HUBER_SWEEPS, HUBER_CG = 8, 1.0, 5, 8
#: float64 objectives ½Σρ_C((Ax−b)²) + α·½‖Bx‖² of the JAX package's
#: tikhonov_solve (x64, CPU) on b = Lena/max, by α index
#: (tests/torch_anchors.py)
TK_ANCHORS = {("TK1", "linear", 0): 57.549177504,
              ("TK1", "linear", 31): 102.146681715,
              ("TK1", "linear", 63): 124.397256727,
              ("TK0", "linear", 0): 107.390698910,
              ("TK0", "linear", 31): 2272.173225778,
              ("TK0", "linear", 63): 3754.396396111,
              ("TK1", "huber", 0): 57.079130938,
              ("TK1", "huber", 32): 102.944577543,
              ("TK1", "huber", 56): 119.974404438}
#: phase 18, the TV-L2 ADMM study: 8 α × 2 ρ, 50 outer × 10 CG, records
TV_ALPHAS = np.linspace(0.001, 0.05, 8, dtype=np.float32)
TV_RHOS = (0.1, 0.5)
#: final Reg (TV) and Data (½Σr²) records of the JAX package's float64
#: admm_solve (x64, CPU) on b = Lena/max at (α index, ρ)
TV_ANCHORS = {(1, 0.1): {"Reg": 1805.859811781, "Data": 71.857621770},
              (6, 0.5): {"Reg": 1053.845302701, "Data": 83.068492237}}
#: the port's float32 plain path lands within 1.1e-7 of every anchor above
#: on the CPU (tests/torch_anchors.py); the card's kernels sum in another
#: order, so the band is ~90 times that gap
STUDY_ANCHOR_BAND = 1e-5
#: f32 sums of ~65536 terms (the measures on the card) against the same
#: measures in float64
RECORD_TOL = 1e-5


def host_device_ms(fn):
    """Host enqueue ms (until ``fn`` returns), wall ms (until the device is
    done) and device ms by CUDA events, of one call."""
    import torch

    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    fn()
    t1 = time.perf_counter()
    ev1.record()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t0) * 1e3, ev0.elapsed_time(ev1)


def device_busy_ms(fn):
    """Device time of one call of ``fn`` and its number of device
    operations (kernels and memsets), from a ``torch.profiler`` trace;
    ``(None, 0)`` where the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total, ops = 0.0, 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            total += t
            ops += e.count
    return (total / 1e3, ops) if total > 0 else (None, 0)


def sweep_timing(fn, label, card):
    """Print and return host enqueue, wall and device-busy ms of one call
    and its device operations."""
    fn()  # warm-up
    runs = [host_device_ms(fn) for _ in range(3)]
    host = sorted(r[0] for r in runs)[1]
    wall = sorted(r[1] for r in runs)[1]
    busy, ops = device_busy_ms(fn)
    share = "not measured" if busy is None else "%.1f %%" % (100 * busy / wall)
    print("%s: host enqueue %.3f ms, wall %.3f ms (medians of 3), device "
          "busy %s ms = %s, %d device operations (%.2f us of host enqueue "
          "each) [%s]" % (label, host, wall, "not measured" if busy is None
                          else "%.3f" % busy, share, ops,
                          1e3 * host / max(ops, 1), card))
    return {"host_ms": host, "wall_ms": wall, "busy_ms": busy, "ops": ops}


def lena_problem():
    """Lena 256² blurred + noisy, its maximum (the study's x_scale), and the
    σ = 1 blur and gradient operators."""
    from nsol_tpu_torch import data
    from nsol_tpu_torch.io import read_png
    from nsol_tpu_torch.ops import conv as C
    from nsol_tpu_torch.ops import grad as G

    img = read_png(data.path("2D_Lena_256_blur_noise.png")).astype(np.float64)
    A, _ = C.make_blur_operators(np.eye(2), alpha_cut=3)
    D, Dt = G.make_gradient_operators(None)
    return img, float(img.max()), A, D, Dt


def tk_objective(x, b, A, B, alpha, loss):
    """The Tikhonov objective of ``tests/torch_anchors.py`` in float64 on
    the tensors' device."""
    import torch

    from nsol_tpu_torch.ops import losses

    x64, b64 = x.double(), b.double()
    r = A(x64) - b64
    f2 = losses.LOSSES[loss](r * r, f_scale=HUBER_SCALE)
    Bx = B(x64)
    return float(0.5 * torch.sum(f2) + alpha * 0.5 * torch.sum(Bx * Bx))


def run_tikhonov_phase(device, card):
    """Phase 17: the Lena 256² Tikhonov studies through
    ``TikhonovLinearSolver.run_sweep`` on the card. Returns the launch
    counts of the TK1L2 64-α sweep and its timing."""
    import torch

    from nsol_tpu_torch.ops import losses
    from nsol_tpu_torch.ops.cuda import fused as F
    from nsol_tpu_torch.ops.cuda import tikhonov as T
    from nsol_tpu_torch.solvers.wrappers import TikhonovLinearSolver

    img, xs, A, D, Dt = lena_problem()
    b = torch.as_tensor(img / xs, dtype=torch.float32, device=device)
    cov = np.eye(2)

    def ident(x):
        return x

    regs = {"TK1": (D, Dt), "TK0": (ident, ident)}
    bt = torch.as_tensor(img, dtype=torch.float64, device=device)
    out = {}
    for reg, loss in (("TK1", "linear"), ("TK0", "linear"),
                      ("TK1", "huber")):
        B, Bt = regs[reg]
        robust = loss != "linear"
        alphas = TK_ALPHAS[::HUBER_STEP] if robust else TK_ALPHAS
        iter_max = HUBER_SWEEPS if robust else TK_ITER_MAX
        solver = TikhonovLinearSolver(
            A, A, img, B, Bt, img, x_scale=xs, data_loss=loss,
            data_loss_scale=HUBER_SCALE, minimizer="auto", iter_max=iter_max,
            irls_cg_iters=HUBER_CG, blur_cov=cov, spacing=np.ones(2),
            reg_kind=reg, device=device)
        measures = {
            "Reg": lambda x, B=B: 0.5 * torch.sum(B(x) * B(x)),
            "Data": lambda x, loss=loss: losses.cost_from_residual(
                A(x) - bt.to(x.dtype), loss, HUBER_SCALE)}
        params = {"alpha": alphas.astype(np.float64)}
        torch.cuda.synchronize()
        F.reset_counts()
        x_all, recs = solver.run_sweep(params, measures=measures)
        torch.cuda.synchronize()
        launches = F.launch_counts(
            ("tik_clip",) + (("blur_apply", "irls_head", "weighted_apply",
                              "irls_step", "cg_update") if robust else
                             ("normal_apply", "cg_step", "cg_update")))
        plain_calls = F.plain_counts()
        require(all(n > 0 for n in launches.values()),
                "phase 17: %s/%s a kernel was not launched: %s"
                % (reg, loss, launches))
        require(all(n == 0 for n in plain_calls.values()),
                "phase 17: %s/%s a plain version ran: %s"
                % (reg, loss, plain_calls))
        require(x_all.shape == (len(alphas), 256, 256)
                and np.all(np.isfinite(x_all))
                and recs["Reg"].shape == (len(alphas), 2),
                "phase 17: %s/%s results not finite or misshapen"
                % (reg, loss))
        xk = torch.as_tensor(x_all / xs, device=device)
        # the anchors
        devs = {}
        for (r_, l_, i), anchor in TK_ANCHORS.items():
            if (r_, l_) != (reg, loss):
                continue
            j = i // HUBER_STEP if robust else i
            obj = tk_objective(xk[j], b, A, B, float(TK_ALPHAS[i]), loss)
            devs[i] = abs(obj - anchor) / anchor
            require(devs[i] <= STUDY_ANCHOR_BAND, "phase 17: %s/%s alpha[%d] "
                    "objective %.9f deviates %.3g from %.9f"
                    % (reg, loss, i, obj, devs[i], anchor))
        # the two-row records against the same measures in float64
        rec_dev = 0.0
        for j in range(len(alphas)):
            for row, x in ((0, bt), (1, xk[j].double() * xs)):
                for name, fn in measures.items():
                    ref = float(fn(x))
                    rec_dev = max(rec_dev, abs(recs[name][j, row] - ref)
                                  / abs(ref))
        require(rec_dev <= RECORD_TOL, "phase 17: %s/%s records deviate "
                "%.3g from float64" % (reg, loss, rec_dev))
        # kernel vs plain on the card
        solve = T.make_fused_tikhonov_solver(
            b.shape, cov, reg=reg, iter_max=iter_max, data_loss=loss,
            irls_cg_iters=HUBER_CG)
        a_list = [float(a) for a in alphas]
        xp = solve.plain(b, b, a_list, HUBER_SCALE)
        obj_rel = vox = 0.0
        for j in (0, len(alphas) // 2, len(alphas) - 1):
            ok = tk_objective(xk[j], b, A, B, a_list[j], loss)
            op = tk_objective(xp[j], b, A, B, a_list[j], loss)
            obj_rel = max(obj_rel, abs(ok - op) / abs(op))
        vox = float((xk.float() - xp).abs().max() / xk.abs().max())
        require(obj_rel <= SOLVE_OBJ_TOL and vox <= SOLVE_VOX_TOL,
                "phase 17: %s/%s kernel vs plain objective rel %.3g voxel "
                "%.3g" % (reg, loss, obj_rel, vox))
        del xp
        ms_k = cuda_ms(lambda: solve(b, b, a_list, HUBER_SCALE), reps=5)
        ms_p = cuda_ms(lambda: solve.plain(b, b, a_list, HUBER_SCALE),
                       reps=1)
        t_sweep = sweep_timing(
            lambda: solver.run_sweep(params, measures=measures),
            "phase 17 %s/%s run_sweep (%d alphas, records)"
            % (reg, loss, len(alphas)), card)
        t_kernel = sweep_timing(lambda: solve(b, b, a_list, HUBER_SCALE),
                                "phase 17 %s/%s fused solve batch alone"
                                % (reg, loss), card)
        print("phase 17 %s/%s Lena 256^2 x %d alphas (CG %d%s): anchor devs "
              "%s (band %g); records vs float64 %.2e; kernel vs plain "
              "objective rel %.2e, voxel %.2e; launches %s (%.1f per solve); "
              "plain calls 0; kernel %.3f ms/sweep, plain %.3f ms/sweep "
              "[%s]" % (reg, loss, len(alphas), iter_max, "" if not robust
                        else " x %d" % HUBER_CG,
                        {i: "%.2e" % d for i, d in devs.items()},
                        STUDY_ANCHOR_BAND, rec_dev, obj_rel, vox, launches,
                        sum(launches.values()) / len(alphas), ms_k, ms_p,
                        card))
        out[(reg, loss)] = {"launches": launches, "sweep": t_sweep,
                            "kernel": t_kernel, "ms": ms_k, "plain_ms": ms_p}
    return out


def run_admm_study_phase(device, card):
    """Phase 18: the TV-L2 ADMM study with records on Lena 256² through
    ``ADMMLinearSolver.run_sweep``, and ``run_deconvolution`` (linear TV-L2
    by ADMM) on the PNG. Returns the sweep's launch counts."""
    import torch

    from nsol_tpu_torch import data, interop
    from nsol_tpu_torch.cli import run_deconvolution
    from nsol_tpu_torch.io import DataReader
    from nsol_tpu_torch.ops import losses
    from nsol_tpu_torch.ops.cuda import fused as F
    from nsol_tpu_torch.solvers.wrappers import ADMMLinearSolver

    img, xs, A, D, Dt = lena_problem()
    b = torch.as_tensor(img / xs, dtype=torch.float32, device=device)
    bt = torch.as_tensor(img, dtype=torch.float64, device=device)
    cov = np.eye(2)
    solver = ADMMLinearSolver(
        A, A, img, D, Dt, img, x_scale=xs, minimizer="auto",
        iterations=ITERATIONS, iter_max=ITER_MAX, blur_cov=cov,
        spacing=np.ones(2), device=device)
    measures = {
        "Reg": lambda x: torch.sum(torch.sqrt(torch.sum(D(x) ** 2, 0))),
        "Data": lambda x: losses.cost_from_residual(A(x) - bt.to(x.dtype))}
    grid = [(a, r) for a in TV_ALPHAS.astype(np.float64) for r in TV_RHOS]
    params = {"alpha": np.array([g[0] for g in grid]),
              "rho": np.array([g[1] for g in grid])}
    torch.cuda.synchronize()
    F.reset_counts()
    x_all, recs = solver.run_sweep(params, measures=measures)
    torch.cuda.synchronize()
    names = F.ADMM_UNITS + F.RECORD_UNITS
    launches, plain_calls = F.launch_counts(names), F.plain_counts()
    require(all(n > 0 for n in launches.values()),
            "phase 18: a kernel was not launched: %s" % launches)
    require(all(n == 0 for n in plain_calls.values()),
            "phase 18: a plain version ran: %s" % plain_calls)
    require(x_all.shape == (16, 256, 256) and np.all(np.isfinite(x_all))
            and recs["Reg"].shape == (16, ITERATIONS + 1),
            "phase 18: results not finite or misshapen")
    devs = {}
    for (i, rho), anchor in TV_ANCHORS.items():
        j = grid.index((float(TV_ALPHAS[i]), rho))
        for name, scale in (("Reg", xs), ("Data", xs * xs)):
            got = recs[name][j, -1] / scale
            devs[(i, rho, name)] = abs(got - anchor[name]) / anchor[name]
            require(devs[(i, rho, name)] <= STUDY_ANCHOR_BAND,
                    "phase 18: (alpha[%d], rho %g) %s record %.9f deviates "
                    "%.3g from %.9f" % (i, rho, name, got,
                                        devs[(i, rho, name)], anchor[name]))
    # the in-solve records against the measures of the returned x
    rec_dev = 0.0
    for j in range(len(grid)):
        x = torch.as_tensor(x_all[j], dtype=torch.float64, device=device)
        for name, fn in measures.items():
            ref = float(fn(x))
            rec_dev = max(rec_dev, abs(recs[name][j, -1] - ref) / abs(ref))
    require(rec_dev <= RECORD_TOL, "phase 18: last records deviate %.3g from "
            "the measures of x" % rec_dev)
    # kernel vs plain on the card at two configurations
    solve = F.make_fused_admm_solver(b.shape, cov, iterations=ITERATIONS,
                                     iter_max=ITER_MAX, record=True)
    obj_rel = vox = rrel = 0.0
    for (i, rho) in TV_ANCHORS:
        a = float(TV_ALPHAS[i])
        xk, rk = solve(b, b, a, rho, record_dls=1.0 / xs)
        xp, rp = solve.plain(b, b, a, rho, record_dls=1.0 / xs)
        ok = float(rk["Data"][-1]) + a * float(rk["Reg"][-1])
        op = float(rp["Data"][-1]) + a * float(rp["Reg"][-1])
        obj_rel = max(obj_rel, abs(ok - op) / abs(op))
        vox = max(vox, float((xk - xp).abs().max() / xk.abs().max()))
        rrel = max(rrel, max_rel(rk["Reg"], rp["Reg"]),
                   max_rel(rk["Data"], rp["Data"]))
    require(obj_rel <= SOLVE_OBJ_TOL and vox <= SOLVE_VOX_TOL
            and rrel <= SOLVE_VOX_TOL, "phase 18: kernel vs plain objective "
            "rel %.3g voxel %.3g records %.3g" % (obj_rel, vox, rrel))
    a0, r0 = float(TV_ALPHAS[1]), 0.1
    # run(): the generic admm_solve with the CUDA units in its hooks
    solver.set_alpha(a0)
    solver.set_rho(r0)
    F.reset_counts()
    solver.run()
    run_launches = F.launch_counts(("normal_apply",))
    require(run_launches["normal_apply"] > 0
            and all(n == 0 for n in F.plain_counts().values()),
            "phase 18: run() launches %s, plain calls %s"
            % (run_launches, F.plain_counts()))
    xj = x_all[grid.index((a0, r0))]
    run_dev = float(np.abs(solver.get_x() - xj).max() / np.abs(xj).max())
    require(run_dev <= SOLVE_VOX_TOL, "phase 18: run() vs run_sweep voxel "
            "%.3g" % run_dev)
    print("phase 18 ADMMLinearSolver.run() on the card (generic core, CUDA "
          "units in the hooks): voxel vs run_sweep %.2e; launches %s"
          % (run_dev, run_launches))
    ms_k = cuda_ms(lambda: solve(b, b, a0, r0, record_dls=1.0 / xs), reps=5)
    ms_p = cuda_ms(lambda: solve.plain(b, b, a0, r0, record_dls=1.0 / xs),
                   reps=1)
    t_sweep = sweep_timing(lambda: solver.run_sweep(params,
                                                    measures=measures),
                           "phase 18 TVL2 ADMM run_sweep (16 configurations,"
                           " records)", card)
    print("phase 18 TVL2 ADMM study Lena 256^2, 8 alphas x 2 rhos, %d x %d, "
          "records: anchor devs %s (band %g); last records vs measures of x "
          "%.2e; kernel vs plain objective rel %.2e, voxel %.2e, records "
          "%.2e; launches %s (%.0f per solve); plain calls 0; kernel %.3f "
          "ms/solve, plain %.3f ms/solve [%s]"
          % (ITERATIONS, ITER_MAX, {k: "%.2e" % v for k, v in devs.items()},
             STUDY_ANCHOR_BAND, rec_dev, obj_rel, vox, rrel, launches,
             sum(launches.values()) / len(grid), ms_k, ms_p, card))

    # run_deconvolution, linear TV-L2 by ADMM on the 2-D PNG
    obs = data.path("2D_Lena_256_blur_noise.png")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "x.mat")
        F.reset_counts()
        rc = run_deconvolution.main([
            "--observation", obs, "--result", out, "--solver", "ADMM",
            "--reconstruction-type", "TVL2", "--alpha", str(ALPHA),
            "--blur", str(SIGMA), "--iterations", str(ITERATIONS),
            "--iter-max", str(ITER_MAX), "--device", "cuda"])
        require(rc == 0, "phase 18: CLI returned %r" % rc)
        cli_launches = F.launch_counts(F.ADMM_UNITS)
        require(all(n > 0 for n in cli_launches.values())
                and all(n == 0 for n in F.plain_counts().values()),
                "phase 18: CLI launches %s, plain calls %s"
                % (cli_launches, F.plain_counts()))
        reader = DataReader(out)
        reader.read_data()
        recon = reader.get_data()
    lib = F.make_fused_admm_solver(b.shape, cov, iterations=ITERATIONS,
                                   iter_max=ITER_MAX)(b, b, ALPHA, RHO)
    lib = interop.to_numpy(lib).astype(np.float64) * xs
    cli_dev = float(np.max(np.abs(recon - lib)) / np.max(np.abs(lib)))
    require(recon.shape == img.shape and np.all(np.isfinite(recon))
            and cli_dev <= KERNEL_TOL, "phase 18: CLI vs library %.3g"
            % cli_dev)
    print("phase 18 CLI run_deconvolution TVL2 linear %s: shape %s finite, "
          "max|cli - library|/max %.3e; launches %s, plain calls 0"
          % (os.path.basename(obs), recon.shape, cli_dev, cli_launches))
    return {"launches": launches, "sweep": t_sweep, "ms": ms_k,
            "plain_ms": ms_p}


def run_scale_cli_phase(device, card):
    """Phase 19: a 256³ TK1L2 sweep, and ``nsol_torch_run_deconvolution_
    study`` on the 64³ phantom (TK1L2) and on Lena (TVL2 by ADMM)."""
    import torch

    from nsol_tpu_torch import data, interop
    from nsol_tpu_torch.cli import run_deconvolution_study as study_cli
    from nsol_tpu_torch.io import DataReader
    from nsol_tpu_torch.ops import conv as C
    from nsol_tpu_torch.ops import grad as G
    from nsol_tpu_torch.ops.cuda import fused as F
    from nsol_tpu_torch.ops.cuda import tikhonov as T
    from nsol_tpu_torch.solvers.wrappers import TikhonovLinearSolver
    from nsol_tpu_torch.study import ReaderParameterStudy

    # 256³ TK1L2 sweep over 8 α, CG 10: bytes-bound
    big = SCALE_SHAPE
    iso = np.diag([SIGMA ** 2] * 3)
    A, _ = C.make_blur_operators(iso, alpha_cut=3, dtype=np.float32)
    D, Dt = G.make_gradient_operators(None)
    xt = interop.to_torch((np.random.RandomState(0).rand(*big) > 0.7)
                          .astype(np.float32), device)
    bb = A(xt).contiguous()
    del xt
    b_np = interop.to_numpy(bb)
    alphas = TK_ALPHAS[::8].astype(np.float64)
    solver = TikhonovLinearSolver(A, A, b_np, D, Dt, b_np, minimizer="auto",
                                  iter_max=TK_ITER_MAX, blur_cov=iso,
                                  spacing=np.ones(3), reg_kind="TK1",
                                  device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    F.reset_counts()
    x_all, _ = solver.run_sweep({"alpha": alphas})
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    launches = F.launch_counts(("normal_apply", "cg_step", "cg_update",
                                "tik_clip"))
    require(all(n > 0 for n in launches.values())
            and all(n == 0 for n in F.plain_counts().values()),
            "phase 19: 256^3 launches %s, plain calls %s"
            % (launches, F.plain_counts()))
    require(x_all.shape == (8,) + big and np.all(np.isfinite(x_all)),
            "phase 19: 256^3 results not finite or misshapen")
    solve = T.make_fused_tikhonov_solver(big, iso, reg="TK1",
                                         iter_max=TK_ITER_MAX)
    A64, _ = C.make_blur_operators(iso, alpha_cut=3, dtype=np.float64)
    j = 7
    xk = torch.as_tensor(x_all[j], device=device)
    xp = solve.plain(bb, bb, float(alphas[j]))
    ok = tk_objective(xk, bb, A64, D, float(alphas[j]), "linear")
    op = tk_objective(xp, bb, A64, D, float(alphas[j]), "linear")
    vox = float((xk - xp).abs().max() / xk.abs().max())
    require(abs(ok - op) / abs(op) <= SOLVE_OBJ_TOL and vox <= SOLVE_VOX_TOL,
            "phase 19: 256^3 kernel vs plain objective rel %.3g voxel %.3g"
            % (abs(ok - op) / abs(op), vox))
    del xk, xp
    a_list = [float(a) for a in alphas]
    ms_k = cuda_ms(lambda: solve(bb, bb, a_list), reps=3)
    ms_p = cuda_ms(lambda: solve.plain(bb, bb, a_list[:1]), reps=1,
                   warmup=0) * len(a_list)
    print("phase 19 256^3 TK1L2 x 8 alphas CG %d: kernel vs plain objective "
          "rel %.2e, voxel %.2e; launches %s; plain calls 0; kernel %.1f "
          "ms/sweep (%.1f ms/solve), plain %.1f ms/sweep (8 x one solve); "
          "%.1f MiB on the card above the inputs [%s]"
          % (TK_ITER_MAX, abs(ok - op) / abs(op), vox, launches, ms_k,
             ms_k / 8, ms_p, peak, card))
    del bb, solver, solve, x_all
    torch.cuda.empty_cache()

    # run_deconvolution's TK1L2 route (the class's run(), CUDA units in the
    # hooks) on the Lena PNG against the library's kernel sweep
    from nsol_tpu_torch.cli import run_deconvolution

    img, xs, A2, D2, Dt2 = lena_problem()
    for loss, iters in (("linear", TK_ITER_MAX), ("huber", HUBER_SWEEPS)):
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "x.mat")
            F.reset_counts()
            rc = run_deconvolution.main([
                "--observation", data.path("2D_Lena_256_blur_noise.png"),
                "--result", out, "--reconstruction-type", "TK1L2",
                "--data-loss", loss, "--alpha", "0.05", "--iter-max",
                str(iters), "--irls-cg-iters", str(HUBER_CG), "--device",
                "cuda"])
            units = ("normal_apply",) if loss == "linear" else (
                "blur_apply", "weighted_apply")
            cli_launches = F.launch_counts(units)
            require(rc == 0 and all(n > 0 for n in cli_launches.values())
                    and all(n == 0 for n in F.plain_counts().values()),
                    "phase 19: TK1L2 %s CLI rc %r launches %s, plain calls "
                    "%s" % (loss, rc, cli_launches, F.plain_counts()))
            reader = DataReader(out)
            reader.read_data()
            recon = reader.get_data()
        lib = TikhonovLinearSolver(
            A2, A2, img, D2, Dt2, img, x_scale=xs, data_loss=loss,
            minimizer="auto", iter_max=iters, irls_cg_iters=HUBER_CG,
            blur_cov=np.eye(2), spacing=np.ones(2), reg_kind="TK1",
            device=device).run_sweep({"alpha": np.array([0.05])})[0][0]
        dev = float(np.abs(recon - lib).max() / np.abs(lib).max())
        require(recon.shape == img.shape and dev <= SOLVE_VOX_TOL,
                "phase 19: TK1L2 %s CLI vs library sweep %.3g" % (loss, dev))
        print("phase 19 CLI run_deconvolution TK1L2 %s (run(), CUDA units in "
              "the hooks): max|cli - library sweep|/max %.2e; launches %s, "
              "plain calls 0" % (loss, dev, cli_launches))

    # the study CLI: the 64³ NIfTI (TK1L2) and Lena (TVL2 by ADMM)
    runs = (("3D_SheppLoganPhantom_64.nii.gz", "TK1L2", "phantom",
             ["--iter-max", "10"]),
            ("2D_Lena_256_blur_noise.png", "TVL2", "lena",
             ["--solver", "ADMM", "--iterations", "20", "--iter-max",
              "10"]))
    with tempfile.TemporaryDirectory() as tmp:
        for fname, rtype, name, extra in runs:
            obs = data.path(fname)
            out = os.path.join(tmp, name)
            F.reset_counts()
            rc = study_cli.main(["--observation", obs, "--reconstruction-type",
                                 rtype, "--alpha-range", "0.005", "0.05", "4",
                                 "--study-name", name, "--dir-output", out,
                                 "--device", "cuda"] + extra)
            require(rc == 0, "phase 19: study CLI %s returned %r" % (name, rc))
            units = ("normal_apply", "cg_step", "cg_update") + (
                ("tik_clip",) if rtype == "TK1L2"
                else ("admm_tail", "admm_record"))
            cli_launches = F.launch_counts(units)
            require(all(n > 0 for n in cli_launches.values())
                    and all(n == 0 for n in F.plain_counts().values()),
                    "phase 19: study CLI %s launches %s, plain calls %s"
                    % (name, cli_launches, F.plain_counts()))
            files = sorted(os.listdir(out))
            want = ["%s_%s.%s" % (name, k, e) for k, e in (
                ("computational_time", "txt"), ("measure_Data", "txt"),
                ("measure_Reg", "txt"), ("parameters", "txt"),
                ("reconstructions", "npz"))]
            require(files == want, "phase 19: %s files %s" % (name, files))
            reader = ReaderParameterStudy(directory=out, name=name)
            reader.read_study()
            npz = reader.get_reconstructions()
            require(reader.get_parameter_keys() == ["alpha"]
                    and len(reader.get_parameters()["alpha"]) == 4
                    and all(npz[str(i)].dtype == np.float16
                            for i in range(4)),
                    "phase 19: %s read back wrong" % name)
            if fname.endswith(".nii.gz"):
                require(set(npz.files) >= {"shape", "origin", "spacing",
                                           "direction"}
                        and tuple(npz["shape"]) == (64, 64, 64),
                        "phase 19: %s npz lacks the NIfTI geometry" % name)
            # the CLI's records against the library's on the same problem
            obs_reader = DataReader(obs)
            obs_reader.read_data()
            nda = obs_reader.get_data()
            recs_lib = library_study_records(nda, rtype, extra, device)
            dev = max(max_rel(torch.as_tensor(reader.get_results(m)),
                              torch.as_tensor(recs_lib[m]))
                      for m in ("Reg", "Data"))
            require(dev <= RECORD_TOL, "phase 19: %s CLI records deviate "
                    "%.3g from the library's" % (name, dev))
            print("phase 19 study CLI %s %s: exit 0, files %s, read back by "
                  "the port's reader (%d configurations%s), records vs "
                  "library %.2e, launches %s, plain calls 0"
                  % (fname, rtype, files, len(reader.get_parameters()
                                                  ["alpha"]),
                     ", NIfTI geometry in the npz" if fname.endswith("gz")
                     else "", dev, cli_launches))
    return {"launches": launches, "peak_mib": peak, "ms": ms_k}


def library_study_records(nda, rtype, extra, device):
    """The Reg/Data records of the study CLI's grid run through the library
    classes on the same problem (blur σ = 1, unit spacing)."""
    import torch

    from nsol_tpu_torch.ops import conv as C
    from nsol_tpu_torch.ops import grad as G
    from nsol_tpu_torch.ops import losses
    from nsol_tpu_torch.ops import priors
    from nsol_tpu_torch.solvers.wrappers import (ADMMLinearSolver,
                                                 TikhonovLinearSolver)

    nd = nda.ndim
    cov = np.eye(nd) * SIGMA ** 2
    A, _ = C.make_blur_operators(cov, alpha_cut=3, spacing=np.ones(nd))
    D, Dt = G.make_gradient_operators(np.ones(nd))
    bt = torch.as_tensor(nda, dtype=torch.float32, device=device)
    xs = float(np.max(nda))
    opts = dict(zip(extra[::2], extra[1::2]))
    common = dict(x_scale=xs, minimizer="auto",
                  iter_max=int(opts["--iter-max"]), blur_cov=cov,
                  spacing=np.ones(nd), device=device)
    data_cost = lambda x: losses.cost_from_residual(A(x) - bt)  # noqa: E731
    if rtype == "TK1L2":
        solver = TikhonovLinearSolver(A, A, nda, D, Dt, nda, reg_kind="TK1",
                                      **common)
        reg = lambda x: priors.first_order_tikhonov(x, D)  # noqa: E731
    else:
        solver = ADMMLinearSolver(A, A, nda, D, Dt, nda, rho=0.1,
                                  iterations=int(opts["--iterations"]),
                                  **common)
        reg = lambda x: priors.total_variation(x, D)  # noqa: E731
    _, recs = solver.run_sweep({"alpha": np.linspace(0.005, 0.05, 4)},
                               measures={"Reg": reg, "Data": data_cost})
    return recs


# ------------------------------------------------------------------ main --

def run_admm_phases(device, card):
    """Phases 3-6: the linear ADMM deconvolution path. Returns the launch
    counts of the 64³ solve, each unit's max |Δ| against its plain version
    at 64³ and its (kernel ms, plain ms) per call there."""
    import scipy.ndimage as ndi
    import torch

    from nsol_tpu_torch import data, interop
    from nsol_tpu_torch.cli import run_deconvolution as cli
    from nsol_tpu_torch.io import read_nifti, write_nifti
    from nsol_tpu_torch.ops import conv as C
    from nsol_tpu_torch.ops import kernels as K
    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import fused as F


    # phase 3: kernel vs plain on the card
    rng = np.random.RandomState(0)
    aniso = np.diag([0.8, 1.0, 1.3]) ** 2
    aniso_sp = np.array([1.25, 0.8, 2.0])
    iso = np.diag([SIGMA ** 2] * 3)
    cases = [("main", iso, None, (64, 64, 64)),
             ("aniso", aniso, aniso_sp, (64, 64, 64)),
             ("aniso", aniso, aniso_sp, (37, 45, 53)),
             ("aniso", aniso, aniso_sp, (5, 40, 33))]
    main_err = {}
    for label, cov, sp, shape in cases:
        st = B.Stencils.from_cov(cov, 3, sp, device)
        res = kernel_cases(B, F, st, shape, device, rng)
        torch.cuda.synchronize()
        for name, (rel, ab) in res.items():
            require(rel <= KERNEL_TOL, "phase 3: %s %s %s rel %.3g > %g"
                    % (name, label, shape, rel, KERNEL_TOL))
            if label == "main":
                main_err[name] = ab
        print("phase 3 kernels %s %s taps %s: %s" % (
            label, "x".join(map(str, shape)), st.normal.lengths,
            ", ".join("%s %.2e" % (k, v[0]) for k, v in res.items())))

    # phase 4: main path, 64³
    img = read_nifti(data.path("3D_SheppLoganPhantom_64.nii.gz"))
    x_true = img.data.astype(np.float64)
    shape = x_true.shape
    kern = K.gaussian_kernel(iso, alpha_cut=3, spacing=np.ones(3))
    b_np = ndi.convolve(x_true, kern, mode="wrap")
    b = interop.to_torch(b_np.astype(np.float32), device)
    solve = F.make_fused_admm_solver(shape, iso, iterations=ITERATIONS,
                                     iter_max=ITER_MAX)
    solve(b, b, ALPHA, RHO)  # warm-up (stencils, allocator)
    torch.cuda.synchronize()
    F.reset_counts()
    x_k = solve(b, b, ALPHA, RHO)
    torch.cuda.synchronize()
    launches = F.launch_counts(F.ADMM_UNITS)
    plain_calls = F.plain_counts()
    require(all(n > 0 for n in launches.values()),
            "phase 4: a kernel was not launched: %s" % launches)
    require(all(n == 0 for n in plain_calls.values()),
            "phase 4: a plain version ran: %s" % plain_calls)
    x_p = solve.plain(b, b, ALPHA, RHO)
    obj_k = objective_host(interop.to_numpy(x_k), b_np, kern, ALPHA)
    obj_p = objective_host(interop.to_numpy(x_p), b_np, kern, ALPHA)
    dev = abs(obj_k - OBJECTIVE_ANCHOR) / OBJECTIVE_ANCHOR
    obj_rel = abs(obj_k - obj_p) / abs(obj_p)
    vox = float((x_k - x_p).abs().max() / x_k.abs().max())
    require(bool(torch.isfinite(x_k).all()) and x_k.shape == b.shape,
            "phase 4: result not finite or misshapen")
    require(dev <= ANCHOR_BAND, "phase 4: objective %.2f deviates %.4f%% "
            "from %.2f" % (obj_k, 100 * dev, OBJECTIVE_ANCHOR))
    require(obj_rel <= SOLVE_OBJ_TOL and vox <= SOLVE_VOX_TOL,
            "phase 4: kernel vs plain objective rel %.3g voxel rel %.3g"
            % (obj_rel, vox))
    ms_k = cuda_ms(lambda: solve(b, b, ALPHA, RHO), reps=10)
    ms_p = cuda_ms(lambda: solve.plain(b, b, ALPHA, RHO), reps=5)
    print("phase 4 main path 64^3: objective %.2f (anchor %.2f, dev "
          "%.4f%%); kernel vs plain objective rel %.3e, voxel max|d|/max|x| "
          "%.3e; launches %s; plain calls %s; kernel %.3f ms/solve = %.1f "
          "it/s, plain %.3f ms/solve = %.1f it/s [%s]"
          % (obj_k, OBJECTIVE_ANCHOR, 100 * dev, obj_rel, vox, launches,
             plain_calls, ms_k, ITERATIONS / ms_k * 1e3, ms_p,
             ITERATIONS / ms_p * 1e3, card))

    times64 = kernel_times(B, F, B.Stencils.from_cov(iso, 3, None, device),
                           shape, device, rng, reps=50)
    print("phase 4 per-call 64^3 (kernel ms, plain ms): %s" % ", ".join(
        "%s %.4f/%.4f" % (k, a, p) for k, (a, p) in times64.items()))

    # phase 5: scale, 256³
    big = (256, 256, 256)
    xt = np.random.RandomState(0).rand(*big) > 0.7
    A, _ = C.make_blur_operators(iso, alpha_cut=3, dtype=np.float32)
    xt_t = interop.to_torch(xt.astype(np.float32), device)
    bb = A(xt_t).contiguous()
    del xt_t
    solve_big = F.make_fused_admm_solver(big, iso, iterations=ITERATIONS,
                                         iter_max=ITER_MAX)
    xb_k = solve_big(bb, bb, ALPHA, RHO)
    xb_p = solve_big.plain(bb, bb, ALPHA, RHO)
    torch.cuda.synchronize()
    A64, _ = C.make_blur_operators(iso, alpha_cut=3, dtype=np.float64)
    ob_k = objective_device(xb_k, bb, A64, ALPHA)
    ob_p = objective_device(xb_p, bb, A64, ALPHA)
    ob_rel = abs(ob_k - ob_p) / abs(ob_p)
    vox_b = float((xb_k - xb_p).abs().max() / xb_k.abs().max())
    require(bool(torch.isfinite(xb_k).all()), "phase 5: result not finite")
    require(ob_rel <= SOLVE_OBJ_TOL and vox_b <= SOLVE_VOX_TOL,
            "phase 5: kernel vs plain objective rel %.3g voxel rel %.3g"
            % (ob_rel, vox_b))
    del xb_p
    msb_k = cuda_ms(lambda: solve_big(bb, bb, ALPHA, RHO), reps=5)
    msb_p = cuda_ms(lambda: solve_big.plain(bb, bb, ALPHA, RHO), reps=5,
                    warmup=0)
    times256 = kernel_times(B, F, B.Stencils.from_cov(iso, 3, None, device),
                            big, device, rng, reps=10)
    print("phase 5 scale 256^3: objective %.1f (JAX package, information "
          "only: %.1f); kernel vs plain objective rel %.3e, voxel %.3e; "
          "kernel %.1f ms/solve = %.2f it/s, plain %.1f ms/solve = %.2f "
          "it/s; per-call (kernel ms, plain ms): %s [%s]"
          % (ob_k, SCALE_OBJECTIVE_JAX, ob_rel, vox_b, msb_k,
             ITERATIONS / msb_k * 1e3, msb_p, ITERATIONS / msb_p * 1e3,
             ", ".join("%s %.3f/%.3f" % (k, a, p)
                       for k, (a, p) in times256.items()), card))
    del bb, xb_k, solve_big

    # phase 6: CLI
    with tempfile.TemporaryDirectory() as tmp:
        obs = os.path.join(tmp, "b.nii.gz")
        out = os.path.join(tmp, "x.nii.gz")
        write_nifti(b_np.astype(np.float32), obs, spacing=np.ones(3))
        rc = cli.main(["--observation", obs, "--solver", "ADMM",
                       "--reconstruction-type", "TVL2", "--alpha",
                       str(ALPHA), "--blur", str(SIGMA), "--result", out])
        require(rc == 0, "phase 6: CLI returned %r" % rc)
        recon = read_nifti(out).data.astype(np.float64)
        b_read = read_nifti(obs).data.astype(np.float64)
    scale = np.max(b_read)
    bs = interop.to_torch((b_read / scale).astype(np.float32), device)
    lib_x = interop.to_numpy(solve(bs, bs, ALPHA, RHO)).astype(
        np.float64) * scale
    cli_dev = float(np.max(np.abs(recon - lib_x)) / np.max(np.abs(lib_x)))
    require(recon.shape == shape and np.all(np.isfinite(recon)),
            "phase 6: CLI result not finite or misshapen")
    require(cli_dev <= KERNEL_TOL, "phase 6: CLI vs library %.3g" % cli_dev)
    print("phase 6 CLI: shape %s finite, max|cli - library|/max %.3e"
          % (recon.shape, cli_dev))

    return {"launches": launches, "err": main_err, "times": times64}


#: the phase groups, in the order they run; ``--only`` picks some of them
GROUPS = ("admm", "pd", "robust", "units", "tikhonov", "study", "cli")
#: kernel units per group: (source, {unit: TPU kernel it replaces})
SOURCES = {
    "admm": ("nsol_tpu_torch/csrc/admm.cu", {
        "normal_apply": "nsol_tpu/ops/pallas/blocked.py:402",
        "cg_step": "nsol_tpu/ops/pallas/blocked.py:988",
        "cg_update": "nsol_tpu/ops/pallas/fused.py:382",
        "admm_tail": "nsol_tpu/ops/pallas/fused.py:382"}),
    "pd": ("nsol_tpu_torch/csrc/pd.cu", {
        "pd_dual": "nsol_tpu/ops/pallas/fused.py:957",
        "pd_primal": "nsol_tpu/ops/pallas/fused.py:957",
        "pd_record": "nsol_tpu/ops/pallas/fused.py:957"}),
    "robust": ("nsol_tpu_torch/csrc/robust.cu", {
        "blur_apply": "nsol_tpu/ops/pallas/robust.py:161",
        "irls_head": "nsol_tpu/ops/pallas/fused.py:382",
        "weighted_apply": "nsol_tpu/ops/pallas/robust.py:264",
        "irls_step": "nsol_tpu/ops/pallas/fused.py:382"}),
    "record": ("nsol_tpu_torch/csrc/admm.cu", {
        "admm_record": "nsol_tpu/ops/pallas/fused.py:382"}),
    "tikhonov": ("nsol_tpu_torch/csrc/tikhonov.cu", {
        "tik_clip": "nsol_tpu/ops/pallas/fused.py:716"}),
}


def kernel_entries(group, launches, err, times, n, taps, nd=3, batch=1):
    """The ``kernels`` records of one group's units: launches on its main
    path, max |Δ| against the plain version, kernel / plain / library ms
    per call at ``n`` voxels (× ``batch`` images), and the bound there."""
    source, replaces = SOURCES[group]
    out = []
    for name, tpu in replaces.items():
        t = times[name]
        b_ms, b_by = unit_bound(name, n, taps, nd, batch)
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": tpu, "launches": int(launches[name]),
                    "max_abs_err": err[name], "ms": t[0], "plain_ms": t[1],
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": t[2] if len(t) > 2 else None})
    return out


def main(argv=None):
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default=",".join(GROUPS),
                        help="comma-separated phase groups of %s to run "
                        "(for development; only the full run prints the "
                        "result line)" % (GROUPS,))
    args = parser.parse_args(argv)
    groups = args.only.split(",")
    unknown = set(groups) - set(GROUPS)
    if unknown:
        parser.error("unknown groups %s" % sorted(unknown))

    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = smi()
    kind = torch.cuda.get_device_name(0)
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print("phase 1 device: %s | nvidia-smi: %s | torch %s cuda %s | %s"
          % (kind, card, torch.__version__, torch.version.cuda, nvcc[-1]))

    # phase 2: build
    t0 = time.perf_counter()
    build.load()
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in build.build_info["ptxas"].splitlines()
            if "registers" in ln]
    print("phase 2 build: %.2f s (%s); ptxas: %s"
          % (build_s, os.path.basename(build.build_info["path"]),
             "; ".join(regs) or "cached"))
    lap("phases 1-2")

    iso3 = B.Stencils.from_cov(np.diag([SIGMA ** 2] * 3), 3, None, "cpu")
    iso2 = B.Stencils.from_cov(np.diag([SIGMA ** 2] * 2), 3, None, "cpu")
    kernels = []
    if "admm" in groups:
        admm = run_admm_phases(device, card)
        lap("phases 3-6")
        kernels += kernel_entries("admm", admm["launches"], admm["err"],
                                  admm["times"], 64 ** 3, iso3.normal.lengths)
    if "pd" in groups:
        pd = run_pd_phases(device, card)
        lap("phases 7-11")
        kernels += kernel_entries("pd", pd["launches"], pd["err"],
                                  pd["times"], 1024 ** 2, (), nd=2, batch=64)
    if "robust" in groups:
        robust = run_robust_phases(device, card)
        lap("phases 12-15")
        kernels += kernel_entries("robust", robust["launches"],
                                  robust["err"], robust["times"],
                                  256 ** 3, iso3.blur.lengths)
    if "units" in groups:
        units = run_unit_phase(device, card)
        lap("phase 16")
    if "tikhonov" in groups:
        tik = run_tikhonov_phase(device, card)
        lap("phase 17")
    if "study" in groups:
        study = run_admm_study_phase(device, card)
        lap("phase 18")
    if "cli" in groups:
        run_scale_cli_phase(device, card)
        lap("phase 19")
    if {"units", "tikhonov", "study"} <= set(groups):
        # the slice's units: launches on the studies' main paths, errors
        # and times at the Lena shape (phase 16)
        kernels += kernel_entries("record", study["launches"], units["err"],
                                  units["times"], 256 ** 2,
                                  iso2.blur.lengths, nd=2)
        kernels += kernel_entries("tikhonov",
                                  tik[("TK1", "linear")]["launches"],
                                  units["err"], units["times"], 256 ** 2, (),
                                  nd=2)
    print(json.dumps({"kernels": kernels}))
    if groups != list(GROUPS):
        print("partial run (%s): no result line" % ",".join(groups))
        return 0
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
