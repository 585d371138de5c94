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
  the 64³ NIfTI phantom (TK1L2) and on Lena (TVL2 by ADMM);
* phases 20-22, the 512³ scale path through the one-pass tiled units of
  ``csrc/tiled.cu``: the units against their plain versions on tile-edge
  shapes and their 512³ times beside the three-pass units;
  ``blocked_admm_solve`` 50 × 10 in its "apply" and "step2d" modes within
  0.2 % of 165421.8 and against the fused solve; the robust huber
  5 × 5 × 8 solve against the per-axis one; ``run_deconvolution`` on a
  (64, 512, 512) NIfTI through the tiled route;
* phases 23-25, compact storage and the CG sweep (group ``compact``): the
  storage-typed units (bfloat16 ``r``/``p``/``q``) and ``cg_sweep``
  against their plain versions on tile-edge shapes (bf16 outputs within
  one bf16 ulp, float32 ones and the dots within 1e-5) and their times at
  each main path's shape beside the float32 units; the 64³ fused compact
  solve within 0.2 % of 219948.08; at 256³ "step" under ``compact_dirs``
  and bf16 state and "sweep" in float32 and bf16 against the exact
  objective; 512³ "apply" under both within 0.2 % of 165421.8; and
  ``run_deconvolution``'s default, ``NSOL_TPU_EXACT=1`` and
  ``NSOL_TPU_COMPACT=1`` on a 64³ and a (64, 512, 512) NIfTI against the
  library solves ``nsol_tpu_torch.policy`` names.

* phases 26-28, the sharded path (group ``sharded``,
  ``nsol_tpu_torch.parallel``): the three prepadded window units of
  ``csrc/admm.cu`` / ``csrc/robust.cu`` against their plain versions on
  the tile-edge shapes, 4 slabs of one 256³ volume assembled against the
  whole-volume units (the global boundary rows), their 512³ times beside
  the whole-volume units; on a real NCCL process group of world size 1,
  ``sharded_tv_admm_solve`` at 512³ (linear 50 × 10 within 0.2 % of
  165421.8 and 1e-4 of ``blocked_admm_solve``; huber 5 × 5 × 8 within 1e-4
  of ``blocked_robust_admm_solve``) and ``sharded_tv_denoise_solve`` on the
  256³ PD volume; the process-local contract, bit for bit. One card holds
  one rank (NCCL refuses two ranks on one GPU): the multi-rank runs are the
  gloo tests on the CPU.

* phases 29-31, the robust and Tikhonov compact storage (group
  ``compact_robust``): the storage-typed weighted applies (the fused
  solves' bf16 directions, the blocked solve's bf16 io, TK1 and TK0, the
  tiled one) and the TK0 ``cg_step`` against their plain versions on the
  tile-edge shapes and at each main path's shape, timed beside their
  float32 instances; the compact robust solves — Lena 256² (within 1e-4
  of 101.442567) and the 64³ phantom fused, the 256³ suite volume blocked
  (within 0.2 % of 45022.5), 512³ tiled (within 1e-3 of the exact
  solve) — against the exact solves and their plain versions;
  ``run_deconvolution --data-loss huber`` on the Lena PNG and a 256³ NIfTI
  against the library solve ``nsol_tpu_torch.policy`` names, bit for bit,
  at its default and under ``NSOL_TPU_EXACT=1``; and the Lena TK1L2/TK0L2
  and TK0L2 huber sweeps and the TV-L2 ADMM huber study through
  ``run_sweep``, against the compact library solves.

* phases 32-35, the primal-dual surface (group ``pd_surface``): the PD
  units on a bfloat16 state (K10b.4, all 4 types × 3 schedules, 2-D and
  3-D tile-edge shapes and 1024²) and the window apply's bfloat16 io
  (K10b.6, the tile-edge slabs, 4 slabs of 256³ against the whole-volume
  ``weighted_apply[io]``) against their plain versions, timed beside their
  float32 instances; the Man 1024² × 64 α L-curve study through
  ``PrimalDualSolverParameterStudy`` and ``nsol_torch_run_denoising_study``,
  exact (within 1e-5 of phase 9's anchors and the library solve) and under
  ``NSOL_TPU_COMPACT=1`` (within the compact bands of the exact study);
  ``run_denoising`` under ``NSOL_TPU_COMPACT=1`` on Lena (the compact
  library solve, bit for bit) and 256³ (exact: past the fused kernel's fit),
  ``--solver ADMM`` and ``--reference``; ``nsol_torch_run_deconvolution``
  at its default ``--solver PD`` on the Lena PNG (TVL2, HuberL2) and a 64³
  NIfTI, within 1e-4 of float64 anchors, and the PD study CLI; and the
  512³ huber 5 × 5 × 8 solve with the io window apply on a NCCL group of
  world size 1, within 1e-3 of ``blocked_robust_admm_solve(compact_dirs=
  True)``.

The CLI runs of phases 6, 15, 18 and 22 hold ``run_deconvolution``'s
default on the card — the reference's compact storage — to the compact
library solve. The sweeps that phases 17-19 hold to float64 anchors or
to the exact generic solve run under ``NSOL_TPU_EXACT=1``, as before;
phase 31 runs them at their default.

Each path's launch counts are set to 0 just before it runs and read just
after. Any failed phase raises, so the script exits non-zero and prints
no result line. It imports neither jax nor nsol_tpu, and needs the
checkout's ``nsol_tpu_torch`` beside it. ``--only GROUP,...`` runs some
phase groups (for development; it prints no result line).

The last lines are a JSON record of the kernels, the card's name and
power limit, and the result line ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from functools import partial

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


@contextlib.contextmanager
def environ(**env):
    """``os.environ`` with ``env`` set inside the block, as it was after
    it (the policy reads ``NSOL_TPU_EXACT`` / ``NSOL_TPU_COMPACT`` there)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def exact_storage():
    """The block runs the exact float32 solves (``NSOL_TPU_EXACT=1``):
    the earlier phases hold the study sweeps, which build in compact
    storage by default on the card, to their float64 anchors as before."""
    return environ(NSOL_TPU_EXACT="1")


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


def unit_bound(name, n, taps=(0, 0, 0), nd=3, batch=1, ext=1.0, reads=None):
    """Bound of one call of the kernel unit ``name`` on ``n`` voxels (a
    batch of ``batch`` images for the PD units): each input volume read
    once, each output volume written once, 4 bytes a voxel; operations
    from the taps (``taps``: per-axis stencil lengths of its blur chain;
    2 per tap, ~15 for the Laplacian, ~10 for an elementwise update). A
    window unit's blur chain runs over ``ext`` times its ``n`` output
    voxels (the halo planes), and it reads ``reads`` volumes of ``n``
    voxels from its inputs (:func:`window_reads`; default ``ext``).
    Returns ``(bound_ms, bound_by)``."""
    chain = 2 * sum(taps)
    reads = ext if reads is None else reads
    vols, ops = {
        "normal_apply_prepadded": (reads + 1, chain * ext + 15),  # v_ext; q
        "blur_apply_prepadded": (reads + 1, chain * ext + 20),  # y u; out
        "weighted_apply_prepadded": (reads + 1, 2 * chain * ext + 25),
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
        "normal_apply_zy": (2, chain + 17),     # v in, q out (+ Σ v·q)
        "cg_step_zy": (4, chain + 17),          # r p in, p' q out
        "blur_apply_zy": (4, chain + 20),       # y x in, free rk out
        "weighted_apply_zy": (6, 2 * chain + 25),  # r p free wts; p' q
        "cg_direction": (3, 2),                 # p r in, p out
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

    from nsol_tpu_torch import data, interop, policy
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
    bb, iso, A64 = scale_problem(device, True, big)
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
    # the CLI's default on the card: the solve policy.py names (the fused
    # robust solve in compact storage)
    build, kw = policy.tvl2_solver(lena.shape, cov2, np.ones(2), "cuda", its,
                                   sweeps, "huber", cgi)
    lib = build(**kw)(b, b, ALPHA, RHO)
    lib = interop.to_numpy(lib).astype(np.float64) * lena.max()
    cli_dev = float(np.max(np.abs(recon - lib)) / np.max(np.abs(lib)))
    require(recon.shape == lena.shape and np.all(np.isfinite(recon)),
            "phase 15: CLI result not finite or misshapen")
    require(cli_dev <= KERNEL_TOL, "phase 15: CLI vs library %.3g" % cli_dev)
    print("phase 15 CLI --data-loss huber %s: shape %s finite, max|cli - "
          "library (%s)|/max %.3e; launches %s, plain calls 0"
          % (os.path.basename(obs), recon.shape,
             "compact" if kw.get("compact_dirs") else "exact", cli_dev,
             cli_launches))
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


def device_breakdown(fn, groups):
    """``(wall ms, device ms, {group: device ms})`` of one call of ``fn``
    from a ``torch.profiler`` trace: each device kernel's time goes to the
    first group of ``groups`` (``(name, substrings)`` pairs) one of whose
    substrings its name holds, else to ``"other"``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by = {name: 0.0 for name, _ in groups}
    by["other"] = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t <= 0 or e.key.startswith("aten::"):
            continue
        group = next((name for name, keys in groups
                      if any(k in e.key for k in keys)), "other")
        by[group] += t / 1e3
    return wall, sum(by.values()), by


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
    with exact_storage():
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
    with exact_storage():
        t_sweep = sweep_timing(lambda: solver.run_sweep(params,
                                                        measures=measures),
                               "phase 18 TVL2 ADMM run_sweep (16 "
                               "configurations, records)", card)
    # the solve's bound: its units' bounds (bytes) at their launch counts
    solve_bound = sum(n / len(grid) * unit_bound(k, 256 ** 2, (13, 13),
                                                 nd=2)[0]
                      for k, n in launches.items())
    print("phase 18 TVL2 ADMM study Lena 256^2, 8 alphas x 2 rhos, %d x %d, "
          "records: anchor devs %s (band %g); last records vs measures of x "
          "%.2e; kernel vs plain objective rel %.2e, voxel %.2e, records "
          "%.2e; launches %s (%.0f per solve); plain calls 0; kernel %.3f "
          "ms/solve, plain %.3f ms/solve, bound %.4f ms/solve [%s]"
          % (ITERATIONS, ITER_MAX, {k: "%.2e" % v for k, v in devs.items()},
             STUDY_ANCHOR_BAND, rec_dev, obj_rel, vox, rrel, launches,
             sum(launches.values()) / len(grid), ms_k, ms_p, solve_bound,
             card))

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
    # the CLI's default on the card: the reference's compact fused solve
    lib = F.make_fused_admm_solver(b.shape, cov, iterations=ITERATIONS,
                                   iter_max=ITER_MAX, precision="high3",
                                   compact_dirs=True)(b, b, ALPHA, RHO)
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
        with exact_storage():  # run() is the exact generic solve
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


# ------------------------------------------- phases 20-22 (scale, 512³) --

#: the 512³ scale configuration: BASELINE config 5's volume
#: (benchmarks/suite.py:973-1029, ``RandomState(0).rand(512³) > 0.7``
#: blurred by σ = 1 wrap, 50 × 10, α 0.01, ρ 0.5) and its converged
#: objective in the JAX package (BASELINE.md:272,494); the robust probe of
#: benchmarks/rob512_probe.py (huber, 5 outer × 5 sweeps × 8 CG, outliers
#: ``0.5·(rand < 0.01)·randn`` drawn after the volume)
BIG = (512, 512, 512)
BIG_ANCHOR = 165421.8
BIG_ROBUST_ITERS = (5, 5, 8)
BIG_N = int(np.prod(BIG))
#: the tiled units' tile-edge cases: (label, cov, spacing, shape)
EDGE_CASES = (
    ("edge", np.diag([1.0] * 3), None, (13, 530, 37)),
    ("spacing", np.diag([1.0] * 3), (1.0, 1.5, 0.8), (70, 45, 33)),
    ("sigma_y>sigma_z", np.diag([0.64, 4.0, 0.64]), None, (16, 40, 37)),
    ("aniso", np.diag([1.3, 0.8, 1.1]) ** 2, (1.0, 1.5, 0.8), (13, 530, 37)))
#: per-axis stencil lengths of each tiled unit's chain at σ = 1 (the
#: normal taps, or the blur taps twice over for the weighted apply)
TILED_TAPS = {"normal_apply_zy": (13, 13, 13), "cg_step_zy": (13, 13, 13),
              "blur_apply_zy": (7, 7, 7), "weighted_apply_zy": (7, 7, 7),
              "cg_direction": (0, 0, 0)}
#: the three-pass unit beside each tiled one (``csrc/stencil.cuh``)
THREE_PASS = {"normal_apply_zy": "normal_apply", "cg_step_zy": "cg_step",
              "blur_apply_zy": "blur_apply",
              "weighted_apply_zy": "weighted_apply",
              "cg_direction": None}


def cuda_median_ms(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` calls, each between
    its own CUDA events, after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def timed_once(fn):
    """``(fn(), ms)`` of one call by CUDA events."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def tiled_calls(T, R, B, st, shape, device, rng):
    """Each tiled unit's kernel, plain version, three-pass unit and
    library call (one PyTorch call of the same function, or None) as
    closures on the same random inputs at ``shape``: the forms of the main
    paths (the dot form of ``normal_apply_zy``, the masked
    ``weighted_apply_zy``, the gradient form of ``blur_apply_zy``). The
    first dict holds (kernel, plain) closures that return fresh outputs
    where the timed ones update in place."""
    import torch

    def rand(lo=0.0):
        return torch.as_tensor(rng.rand(*shape).astype(np.float32) + lo,
                               device=device)

    v, r, p, x = rand(), rand(-0.5), rand(-0.5), rand(-0.3)
    wts, free = rand(0.1), (rand() > 0.3).float()

    def scal():
        return torch.tensor([3.0, 0.0, 0.0, 0.83], dtype=torch.float64,
                            device=device)

    n, bl, h2 = st.normal, st.blur, st.inv_h2
    s = [scal() for _ in range(3)]
    pd, lib_out = p.clone(), torch.empty_like(p)
    beta = float(s[0][B.BETA])

    def direction(unit, k):
        def run():
            q = p.clone()
            unit(q, r, s[k])
            return q
        return run

    checks = {"cg_direction": (direction(T.cg_direction, 0),
                               direction(T.cg_direction_plain, 1))}
    return checks, {
        "normal_apply_zy": (
            lambda: T.normal_apply_zy(v, n, h2, RHO, scal=s[0]),
            lambda: T.normal_apply_zy_plain(v, n, h2, RHO, scal=s[1]),
            lambda: B.normal_apply(v, n, h2, RHO), None),
        "cg_step_zy": (
            lambda: T.cg_step_zy(r, p, s[0], n, h2, RHO),
            lambda: T.cg_step_zy_plain(r, p, s[1], n, h2, RHO),
            lambda: B.cg_step(r, p, s[2], n, h2, RHO), None),
        "blur_apply_zy": (
            lambda: T.blur_apply_zy(r, bl, h2, x, RHO, scal=s[0]),
            lambda: T.blur_apply_zy_plain(r, bl, h2, x, RHO, scal=s[1]),
            lambda: R.blur_apply(r, bl, h2, x, RHO, scal=s[2]), None),
        "weighted_apply_zy": (
            lambda: T.weighted_apply_zy(r, p, free, wts, s[0], bl, h2, RHO),
            lambda: T.weighted_apply_zy_plain(r, p, free, wts, s[1], bl, h2,
                                              RHO),
            lambda: R.weighted_apply(r, p, free, wts, s[2], bl, h2, RHO),
            None),
        "cg_direction": (
            lambda: T.cg_direction(pd, r, s[0]),
            lambda: T.cg_direction_plain(pd, r, s[1]), None,
            lambda: torch.add(r, pd, alpha=beta, out=lib_out)),
    }


def tiled_unit_pairs(T, B, st, shape, device, rng):
    """Every tiled unit (every form) and its plain version on the same
    inputs: ``{unit: [(kernel output, plain output), ...]}``, the CG
    scalars among the outputs."""
    import torch

    def rand(lo=0.0):
        return torch.as_tensor(rng.rand(*shape).astype(np.float32) + lo,
                               device=device)

    v, rhs, r, p, x, b = rand(), rand(), rand(-0.5), rand(-0.5), \
        rand(-0.3), rand()
    wts, free = rand(0.1), (rand() > 0.3).float()
    n, bl, h2 = st.normal, st.blur, st.inv_h2

    def scal():
        return torch.tensor([3.0, 0.0, 0.0, 0.83], dtype=torch.float64,
                            device=device)

    out = {k: [] for k in THREE_PASS}
    out["normal_apply_zy"].append((T.normal_apply_zy(v, n, h2, RHO),
                                   T.normal_apply_zy_plain(v, n, h2, RHO)))
    for kw in ({"rhs": rhs}, {}):
        s1, s2 = scal(), scal()
        out["normal_apply_zy"] += [
            (T.normal_apply_zy(v, n, h2, RHO, scal=s1, **kw),
             T.normal_apply_zy_plain(v, n, h2, RHO, scal=s2, **kw)),
            (s1, s2)]
    for first in (True, False):
        s1, s2 = scal(), scal()
        out["cg_step_zy"] += list(zip(
            T.cg_step_zy(r, p, s1, n, h2, RHO, first),
            T.cg_step_zy_plain(r, p, s2, n, h2, RHO, first))) \
            + [(s1[1:3], s2[1:3])]
        for f in (free, None):
            s1, s2 = scal(), scal()
            out["weighted_apply_zy"] += list(zip(
                T.weighted_apply_zy(r, p, f, wts, s1, bl, h2, RHO, first),
                T.weighted_apply_zy_plain(r, p, f, wts, s2, bl, h2, RHO,
                                          first))) + [(s1[1:3], s2[1:3])]
    out["blur_apply_zy"] += [
        (T.blur_apply_zy(v, bl, h2), T.blur_apply_zy_plain(v, bl, h2)),
        (T.blur_apply_zy(v, bl, h2, x, RHO),
         T.blur_apply_zy_plain(v, bl, h2, x, RHO))]
    s1, s2 = scal(), scal()
    out["blur_apply_zy"] += list(zip(
        T.blur_apply_zy(v, bl, h2, x, RHO, scal=s1),
        T.blur_apply_zy_plain(v, bl, h2, x, RHO, scal=s2))) \
        + [(s1[:1], s2[:1])]
    for loss in ROBUST_LOSSES:
        out["blur_apply_zy"] += list(zip(
            T.blur_apply_zy(x, bl, h2, head=(b, loss, 0.3)),
            T.blur_apply_zy_plain(x, bl, h2, head=(b, loss, 0.3))))
    pk, pp = p.clone(), p.clone()
    T.cg_direction(pk, r, s1)
    T.cg_direction_plain(pp, r, s1)
    out["cg_direction"].append((pk, pp))
    return out


def tiled_fit_checks(T, B, device):
    """The tiled units' shared memory: its size in C (``nsol_tiled_smem``)
    and in Python (``tiled.smem_bytes``, by which the solves route before
    any launch) agree; at σ = 2, the widest isotropic blur the weighted
    apply holds, every unit matches its plain version; at σ = 2.1 the
    weighted apply's wrapper raises before any launch. Returns the largest
    max |Δ| / max |ref| at σ = 2."""
    import torch

    from nsol_tpu_torch.ops.cuda import build

    lib = build.load()
    for k in range(1, 60, 2):
        for lengths in ((k, k, k), (1, k, 3), (k, 5, 1)):
            for form in ((1, 1, 0), (2, 1, 0), (1, 0, 0), (1, 1, 1)):
                c = lib.nsol_tiled_smem(*lengths, *form)
                py = T.smem_bytes(lengths, form[0], *map(bool, form[1:]))
                require(c == py, "phase 20: shared memory of %s %s: C %d, "
                        "Python %d" % (lengths, form, c, py))
    st = B.Stencils.from_cov(np.diag([4.0] * 3), 3, None, device)
    res = tiled_unit_pairs(T, B, st, (40, 64, 40), device,
                           np.random.RandomState(15))
    torch.cuda.synchronize()
    rel = max(max_rel(g, q) for v in res.values() for g, q in v)
    require(rel <= KERNEL_TOL, "phase 20: units at sigma 2 rel %.3g" % rel)
    wide = B.Stencils.from_cov(np.diag([2.1 ** 2] * 3), 3, None, device)
    r = torch.ones((40, 64, 40), device=device)
    before = T.weighted_apply_zy.launches
    try:
        T.weighted_apply_zy(r, None, None, r, B.new_scalars(device),
                            wide.blur, wide.inv_h2, RHO, first=True)
        refused = False
    except ValueError:
        refused = True
    require(refused and T.weighted_apply_zy.launches == before,
            "phase 20: weighted_apply_zy took a blur past its shared memory")
    return rel


def scale_problem(device, robust, shape=BIG):
    """The 512³ input on the card (or one of ``shape``): ``A·(rand >
    0.7)``, plus the salt-and-pepper outliers ``0.5·(rand < 0.01)·randn``
    of the robust problems (the 256³ suite volume, the 512³ probe); the
    σ = 1 blur and its float64 form for the objective."""
    import torch

    from nsol_tpu_torch.ops import conv as C

    iso = np.diag([SIGMA ** 2] * 3)
    A, _ = C.make_blur_operators(iso, alpha_cut=3, dtype=np.float32)
    A64, _ = C.make_blur_operators(iso, alpha_cut=3, dtype=np.float64)
    rs = np.random.RandomState(0)
    xt = torch.as_tensor(rs.rand(*shape) > 0.7, device=device).float()
    b = A(xt).contiguous()
    del xt
    if robust:
        noise = (rs.rand(*shape) < 0.01).astype(np.float32) \
            * rs.randn(*shape).astype(np.float32)
        b += 0.5 * torch.as_tensor(noise, device=device)
        del noise
    return b, iso, A64


def run_scale_phases(device, card):
    """Phases 20-22: the 512³ scale path through the one-pass tiled units.
    Returns each tiled unit's launches on its 512³ path, its max |Δ|
    against its plain version at 512³ and (kernel, plain) ms there."""
    import torch

    from nsol_tpu_torch.cli import run_deconvolution
    from nsol_tpu_torch.io import read_nifti, write_nifti
    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import fused as F
    from nsol_tpu_torch.ops.cuda import robust as R
    from nsol_tpu_torch.ops.cuda import tiled as T

    # phase 20: the units against their plain versions on tile-edge shapes
    rng = np.random.RandomState(20)
    for label, cov, sp, shape in EDGE_CASES:
        st = B.Stencils.from_cov(cov, 3, sp, device)
        res = tiled_unit_pairs(T, B, st, shape, device, rng)
        torch.cuda.synchronize()
        rels = {k: max(max_rel(g, q) for g, q in v) for k, v in res.items()}
        for k, rel in rels.items():
            require(rel <= KERNEL_TOL, "phase 20: %s %s %s rel %.3g > %g"
                    % (k, label, shape, rel, KERNEL_TOL))
        print("phase 20 tiled units %s %s normal taps %s: %s" % (
            label, "x".join(map(str, shape)), st.normal.lengths,
            ", ".join("%s %.2e" % kv for kv in rels.items())))
    del res
    fit_rel = tiled_fit_checks(T, B, device)
    print("phase 20 shared memory: C and Python sizes agree; units at "
          "sigma 2 (blur %s taps) vs plain %.2e; sigma 2.1 refused before "
          "launch" % (B.Stencils.from_cov(np.diag([4.0] * 3)).blur.lengths,
                      fit_rel))
    # ... and at 512³: times beside the plain version and the three-pass unit
    st = B.Stencils.from_cov(np.diag([SIGMA ** 2] * 3), 3, None, device)
    checks, calls = tiled_calls(T, R, B, st, BIG, device,
                                np.random.RandomState(21))
    times, err = {}, {}
    for k, (kf, pf, tf, lf) in calls.items():
        ck, cp = checks.get(k, (kf, pf))
        got, ref = ck(), cp()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err[k] = max(float((g - q).abs().max()) for g, q in zip(got, ref))
        require(max(max_rel(g, q) for g, q in zip(got, ref)) <= KERNEL_TOL,
                "phase 20: %s at 512^3 deviates" % k)
        del got, ref
        times[k] = tuple(None if f is None else cuda_median_ms(f, reps)
                         for f, reps in ((kf, 5), (pf, 2), (tf, 5), (lf, 5)))
    del calls, checks
    torch.cuda.empty_cache()
    print("phase 20 512^3 per call (tiled / plain / three-pass / library ms, "
          "bound ms): %s [%s]" % (", ".join(
              "%s %.3f/%.1f/%s/%s, %.3f" % (
                  k, t[0], t[1], *("-" if u is None else "%.3f" % u
                                   for u in t[2:]),
                  unit_bound(k, int(np.prod(BIG)), TILED_TAPS[k])[0])
              for k, t in times.items()), card))
    # ... at 256³, where the route keeps the three-pass units
    mid = (256, 256, 256)
    _, calls = tiled_calls(T, R, B, st, mid, device,
                           np.random.RandomState(22))
    mid_times = {k: (cuda_median_ms(c[0], 10), cuda_median_ms(c[2], 10))
                 for k, c in calls.items() if c[2] is not None}
    del calls
    torch.cuda.empty_cache()
    print("phase 20 256^3 per call (tiled / three-pass ms, bound ms): %s [%s]"
          % (", ".join("%s %.4f/%.4f, %.4f" % (
              k, t[0], t[1], unit_bound(k, int(np.prod(mid)),
                                        TILED_TAPS[k])[0])
              for k, t in mid_times.items()), card))
    lap("phase 20")

    # phase 21: linear 512³, "apply" and "step2d" against the anchor, the
    # fused solve, and the plain versions at 2 outer iterations
    b, iso, A64 = scale_problem(device, robust=False)
    three_pass = ("normal_apply", "cg_step")
    runs, launches, xs = {}, {}, {}
    for mode in ("auto", "step2d"):
        solve = B.blocked_admm_solve(BIG, iso, iterations=ITERATIONS,
                                     iter_max=ITER_MAX, mode=mode)
        require(mode != "auto" or solve.mode == "apply",
                "phase 21: auto picked %r at 512^3" % solve.mode)
        torch.cuda.synchronize()
        F.reset_counts()
        x, ms = timed_once(lambda: solve(b, b, ALPHA, RHO))
        counts = F.launch_counts(F.TILED_UNITS + three_pass
                                 + ("cg_update", "admm_tail"))
        require(all(counts[k] == 0 for k in three_pass)
                and counts["normal_apply_zy"] > 0
                and all(n == 0 for n in F.plain_counts().values()),
                "phase 21: %s launches %s, plain calls %s"
                % (solve.mode, counts, F.plain_counts()))
        require(bool(torch.isfinite(x).all()), "phase 21: not finite")
        obj = objective_device(x, b, A64, ALPHA)
        dev = abs(obj - BIG_ANCHOR) / BIG_ANCHOR
        require(dev <= ANCHOR_BAND, "phase 21: %s objective %.2f deviates "
                "%.4f%% from %.1f" % (solve.mode, obj, 100 * dev, BIG_ANCHOR))
        runs[solve.mode], launches[solve.mode], xs[solve.mode] = \
            (obj, ms), counts, x
    fused = F.make_fused_admm_solver(BIG, iso, iterations=ITERATIONS,
                                     iter_max=ITER_MAX)
    x_f, ms_f = timed_once(lambda: fused(b, b, ALPHA, RHO))
    obj_f = objective_device(x_f, b, A64, ALPHA)
    rels = [abs(runs[m][0] - obj_f) / obj_f for m in runs] \
        + [abs(runs["apply"][0] - runs["step2d"][0]) / obj_f]
    vox = max(float((xs[m] - x_f).abs().max() / x_f.abs().max())
              for m in xs)
    require(max(rels) <= SOLVE_OBJ_TOL, "phase 21: objectives apply %.3f "
            "step2d %.3f fused %.3f disagree" % (runs["apply"][0],
                                                 runs["step2d"][0], obj_f))
    del xs, x_f, x
    _, ms_a2 = timed_once(lambda: B.blocked_admm_solve(
        BIG, iso, iterations=ITERATIONS, iter_max=ITER_MAX)(b, b, ALPHA, RHO))
    gates = {}
    for mode in ("apply", "step2d"):
        short = B.blocked_admm_solve(BIG, iso, iterations=2,
                                     iter_max=ITER_MAX, mode=mode)
        xk = short(b, b, ALPHA, RHO)
        xp = short.plain(b, b, ALPHA, RHO)
        ok, op = objective_device(xk, b, A64, ALPHA), \
            objective_device(xp, b, A64, ALPHA)
        gates[mode] = (abs(ok - op) / abs(op),
                       float((xk - xp).abs().max() / xk.abs().max()))
        require(gates[mode][0] <= SOLVE_OBJ_TOL
                and gates[mode][1] <= SOLVE_VOX_TOL,
                "phase 21: %s kernel vs plain at 2 x %d: objective rel %.3g "
                "voxel %.3g" % ((mode, ITER_MAX) + gates[mode]))
        del xk, xp
    print("phase 21 linear 512^3 %dx%d: objective apply %.2f, step2d %.2f, "
          "fused %.2f (anchor %.1f, band %.1f%%); apply %.1f/%.1f ms "
          "a solve (two calls), step2d %.1f ms, fused %.1f ms; objectives "
          "agree to %.2e, voxels to %.2e of the fused solve; kernel vs plain "
          "at 2 outer (objective, voxel): %s; launches apply %s, step2d %s "
          "[%s]" % (ITERATIONS, ITER_MAX, runs["apply"][0],
                    runs["step2d"][0], obj_f, BIG_ANCHOR, 100 * ANCHOR_BAND,
                    runs["apply"][1], ms_a2, runs["step2d"][1], ms_f,
                    max(rels), vox, gates, launches["apply"],
                    launches["step2d"], card))
    del b
    torch.cuda.empty_cache()
    lap("phase 21")

    # phase 22: robust 512³ against the per-axis solve; the plain
    # versions at 1 × 1; the CLI on a (64, 512, 512) NIfTI
    its, sweeps, cgi = BIG_ROBUST_ITERS
    b, iso, A64 = scale_problem(device, robust=True)
    rsolve = R.blocked_robust_admm_solve(BIG, iso, iterations=its,
                                         iter_max=sweeps, irls_cg_iters=cgi)
    require(rsolve.tiled, "phase 22: the 512^3 robust solve is not tiled")
    F.reset_counts()
    x_t, ms_t = timed_once(lambda: rsolve(b, b, ALPHA, RHO))
    rob_launches = F.launch_counts()
    require(rob_launches["blur_apply_zy"] == 2 * its * sweeps
            and rob_launches["weighted_apply_zy"] == its * sweeps * cgi
            and all(rob_launches[k] == 0 for k in
                    ("blur_apply", "irls_head", "weighted_apply"))
            and all(n == 0 for n in F.plain_counts().values()),
            "phase 22: launches %s, plain calls %s"
            % (rob_launches, F.plain_counts()))
    per_axis = R.make_robust_solver(BIG, iso, iterations=its,
                                    iter_max=sweeps, irls_cg_iters=cgi)
    x_r, ms_r = timed_once(lambda: per_axis(b, b, ALPHA, RHO))
    ob_t = robust_objective(x_t, b, A64, ALPHA)
    ob_r = robust_objective(x_r, b, A64, ALPHA)
    rob_rel = abs(ob_t - ob_r) / abs(ob_r)
    rob_vox = float((x_t - x_r).abs().max() / x_r.abs().max())
    require(bool(torch.isfinite(x_t).all()) and rob_rel <= SOLVE_OBJ_TOL,
            "phase 22: tiled %.4f vs per-axis %.4f" % (ob_t, ob_r))
    del x_t, x_r
    one = R.blocked_robust_admm_solve(BIG, iso, iterations=1, iter_max=1,
                                      irls_cg_iters=cgi)
    xk, xp = one(b, b, ALPHA, RHO), one.plain(b, b, ALPHA, RHO)
    ok, op = robust_objective(xk, b, A64, ALPHA), \
        robust_objective(xp, b, A64, ALPHA)
    one_gate = (abs(ok - op) / abs(op),
                float((xk - xp).abs().max() / xk.abs().max()))
    require(one_gate[0] <= SOLVE_OBJ_TOL and one_gate[1] <= SOLVE_VOX_TOL,
            "phase 22: kernel vs plain at 1 x 1: objective rel %.3g voxel "
            "%.3g" % one_gate)
    del xk, xp
    sub = b[:64].contiguous()
    del b
    torch.cuda.empty_cache()
    cli_dev = {}
    with tempfile.TemporaryDirectory() as tmp:
        obs = os.path.join(tmp, "b.nii")
        write_nifti(interop_numpy(sub), obs, spacing=np.ones(3))
        b_read = read_nifti(obs).data.astype(np.float64)
        scale = float(np.max(b_read))
        bs = torch.as_tensor((b_read / scale).astype(np.float32),
                             device=device)
        for loss in ("linear", "huber"):
            out = os.path.join(tmp, "x_%s.nii" % loss)
            F.reset_counts()
            rc = run_deconvolution.main([
                "--observation", obs, "--result", out, "--solver", "ADMM",
                "--reconstruction-type", "TVL2", "--data-loss", loss,
                "--alpha", str(ALPHA), "--blur", str(SIGMA), "--iterations",
                str(its), "--iter-max", str(sweeps if loss != "linear"
                                            else ITER_MAX),
                "--irls-cg-iters", str(cgi), "--device", "cuda"])
            unit = "normal_apply_zy" if loss == "linear" \
                else "weighted_apply_zy"
            counts = F.launch_counts()
            require(rc == 0 and counts[unit] > 0
                    and counts["normal_apply"] == 0
                    and counts["weighted_apply"] == 0
                    and all(n == 0 for n in F.plain_counts().values()),
                    "phase 22: CLI %s rc %r launches %s" % (loss, rc, counts))
            recon = read_nifti(out).data.astype(np.float64)
            if loss == "linear":  # the CLI's default: compact directions
                lib = B.blocked_admm_solve(sub.shape, iso, iterations=its,
                                           iter_max=ITER_MAX,
                                           compact_dirs=True)(bs, bs, ALPHA,
                                                              RHO)
            else:  # the blocked robust solve in compact storage
                lib = R.blocked_robust_admm_solve(
                    sub.shape, iso, iterations=its, iter_max=sweeps,
                    irls_cg_iters=cgi, compact_dirs=True)(bs, bs, ALPHA, RHO)
            lib = interop_numpy(lib).astype(np.float64) * scale
            cli_dev[loss] = float(np.max(np.abs(recon - lib))
                                  / np.max(np.abs(lib)))
            require(recon.shape == sub.shape and np.all(np.isfinite(recon))
                    and cli_dev[loss] <= KERNEL_TOL,
                    "phase 22: CLI %s vs library %.3g" % (loss,
                                                          cli_dev[loss]))
    print("phase 22 robust 512^3 huber %dx%dx%d: objective tiled %.4f vs "
          "per-axis %.4f, rel %.2e, voxel %.2e; tiled %.1f ms a "
          "solve, per-axis %.1f ms; kernel vs plain at 1 x 1 (objective, "
          "voxel) %.2e, %.2e; launches %s; CLI on a (64, 512, 512) NIfTI, "
          "linear and huber, through the tiled units: max|cli - library|/"
          "max %s [%s]" % (its, sweeps, cgi, ob_t, ob_r, rob_rel, rob_vox,
                           ms_t, ms_r, one_gate[0], one_gate[1],
                           {k: n for k, n in rob_launches.items() if n},
                           cli_dev, card))
    lap("phase 22")
    path_launches = {
        "normal_apply_zy": launches["apply"]["normal_apply_zy"],
        "cg_direction": launches["apply"]["cg_direction"],
        "cg_step_zy": launches["step2d"]["cg_step_zy"],
        "blur_apply_zy": rob_launches["blur_apply_zy"],
        "weighted_apply_zy": rob_launches["weighted_apply_zy"]}
    return {"launches": path_launches, "err": err,
            "times": {k: (t[0], t[1], t[3]) for k, t in times.items()}}


def interop_numpy(t):
    from nsol_tpu_torch import interop

    return interop.to_numpy(t)


# ------------------------------------------------------ phases 23-25 --

#: bf16 storage vs plain on the card: a bf16 output is within one bf16 ulp
#: of |ref| element by element — the two sum the stencils in other orders,
#: so a value near a rounding midpoint may round the other way —, on top of
#: the float32 band KERNEL_TOL · max |ref| (a sum that cancels carries its
#: float32 difference into the rounded value), and a residual rhs − q also
#: one ulp of its rounded q; f32 outputs and the dots at KERNEL_TOL
BF16_ULPS = 1.0
#: 256³ compact solves against the exact one: the float32 sweep at 1e-4
#: (tests/test_pallas.py:421-435), the bf16 storage modes at 1e-3 (:1090)
SWEEP_F32_TOL, COMPACT_OBJ_TOL = 1e-4, 1e-3
#: a compact solve against its plain version (phase 24, the cuda tests):
#: at 2 outer × ITER_MAX the objective within COMPACT_PLAIN_OBJ_TOL[storage]
#: (rel) and each voxel within COMPACT_PLAIN_VOX_TOL[storage] · max |x|.
#: The bf16 CG is chaotic voxel by voxel — a rounding that flips moves a
#: voxel by a bf16 ulp, and the flips cascade —, so after 20 CG iterations
#: the voxel gap is of the order of the storage's own rounding and cannot
#: tell the storage apart; with r in bf16 too ("state") the chaos reaches
#: the objective of a small volume (on an H100: up to 3.4e-6 at
#: 24 × 40 × 36, 3 × 5, in the cuda tests; ≤ 4e-8 at 256³ and 512³ in
#: phase 24). At 1 outer × 2 CG the RMS gap ‖x_k − x_p‖ tells the storage
#: apart: it is at most COMPACT_PLAIN_SHARE of the plain solve's RMS gap to
#: the exact one (phase 24 on an H100: 0.03-0.06 with bf16 directions,
#: 0.002 with bf16 state; a kernel that kept float32 storage gives 1).
#: The robust solves (phase 30): the fused ones' bf16 directions take the
#: "dirs" bands; the blocked solve's "io" storage (bf16 directions, the
#: weights read as bf16 by the apply, whose output is rounded to bf16)
#: takes its own, set before its first run on the card between the two:
#: the objective within 1e-5, each voxel within 1e-2 · max |x|, and the
#: same RMS share, at 1 outer × 1 sweep × 2 CG (ROBUST_SHORT).
COMPACT_PLAIN_SHARE = 0.2
COMPACT_PLAIN_OBJ_TOL = {"dirs": 1e-6, "state": 1e-5, "io": 1e-5}
COMPACT_PLAIN_VOX_TOL = {"dirs": 1e-3, "state": 2e-2, "io": 1e-2}
#: the storage options of a solve factory (the rest name its route)
STORAGE_KEYS = ("precision", "compact_dirs", "state_dtype")
#: storage-typed units of the compact group: the entry's name in the
#: kernels line → (wrapper, TPU kernel it replaces, source, main path,
#: bytes a voxel it must move, taps of its chain); the main path names
#: the phase 24 run whose launches it reports and the shape it is timed at
COMPACT_UNITS = {
    "cg_step[qf32]": ("cg_step", "nsol_tpu/ops/pallas/fused.py:382",
                      "nsol_tpu_torch/csrc/admm.cu", "fused64", 4 + 2 + 2 + 4,
                      13),
    "cg_step[dirs]": ("cg_step", "nsol_tpu/ops/pallas/blocked.py:988",
                      "nsol_tpu_torch/csrc/admm.cu", "step_dirs",
                      4 + 2 + 2 + 2, 13),
    "cg_step[state]": ("cg_step", "nsol_tpu/ops/pallas/blocked.py:988",
                       "nsol_tpu_torch/csrc/admm.cu", "step_state", 2 * 4, 13),
    "normal_apply[bf16]": ("normal_apply",
                           "nsol_tpu/ops/pallas/blocked.py:402",
                           "nsol_tpu_torch/csrc/admm.cu", "step_state",
                           4 + 4 + 2, 13),
    "cg_update[dirs]": ("cg_update", "nsol_tpu/ops/pallas/fused.py:382",
                        "nsol_tpu_torch/csrc/stencil.cuh", "step_dirs",
                        8 + 8 + 2 + 2, 0),
    "cg_sweep": ("cg_sweep", "nsol_tpu/ops/pallas/blocked.py:1139",
                 "nsol_tpu_torch/csrc/admm.cu", "sweep_f32", 32, 13),
    "cg_sweep[bf16]": ("cg_sweep", "nsol_tpu/ops/pallas/blocked.py:1139",
                       "nsol_tpu_torch/csrc/admm.cu", "sweep_bf16", 20, 13),
    "normal_apply_zy[bf16]": ("normal_apply_zy",
                              "nsol_tpu/ops/pallas/blocked.py:754",
                              "nsol_tpu_torch/csrc/tiled.cu", "apply_dirs",
                              2 + 2, 13),
    # the "apply" CG's p = r + β·p, left to XLA by the JAX package
    "cg_direction[bf16]": ("cg_direction", None,
                           "nsol_tpu_torch/csrc/tiled.cu", "apply_dirs",
                           4 + 2 + 2, 0),
}
#: the shape each main path of phase 24 runs at
COMPACT_SHAPES = {"fused64": (64, 64, 64), "step_dirs": SCALE_SHAPE,
                  "step_state": SCALE_SHAPE, "sweep_f32": SCALE_SHAPE,
                  "sweep_bf16": SCALE_SHAPE, "apply_dirs": BIG}


def bf16_ulp(v):
    """One bf16 ulp at |v| (2^(e − 8) for |v| in [2^(e−1), 2^e)), 0 at 0."""
    import torch

    _, e = torch.frexp(v)
    return torch.where(v != 0, torch.ldexp(torch.ones_like(v), e - 8),
                       torch.zeros_like(v))


def bf16_ulp_err(got, ref, scale=None):
    """max over elements of |got − ref| over its band: BF16_ULPS ulps of
    ref, plus KERNEL_TOL · max |ref|, plus one ulp of ``scale`` (the
    rounded operand of a residual) where given; at most 1 to pass."""
    g, r = got.float(), ref.float()
    band = BF16_ULPS * bf16_ulp(r) + KERNEL_TOL * float(r.abs().max())
    if scale is not None:
        band = band + bf16_ulp(scale.float())
    return float(((g - r).abs() / band.clamp_min(1e-38)).max())


def compact_pairs_err(pairs):
    """Hold (kernel, plain[, scale]) pairs to their bands — a bf16 output
    within its :func:`bf16_ulp_err` band of its plain version element by
    element, a float32 one (and every CG scalar) within KERNEL_TOL ·
    max |ref| — raising on a miss; returns the worst float32 relative
    error."""
    import torch

    torch.cuda.synchronize()
    worst = 0.0
    for name, outs in pairs.items():
        for k, (got, ref, *scale) in enumerate(outs):
            require(got.dtype == ref.dtype, "%s output %d: dtype %s vs plain "
                    "%s" % (name, k, got.dtype, ref.dtype))
            if got.dtype == torch.bfloat16:
                ulps = bf16_ulp_err(got, ref, *scale)
                require(ulps <= 1.0, "%s output %d: %.2f of its band (max "
                        "|d| %.3g)" % (name, k, ulps, float(
                            (got.float() - ref.float()).abs().max())))
            else:
                rel = max_rel(got.double(), ref.double())
                require(rel <= KERNEL_TOL, "%s output %d: rel %.3g"
                        % (name, k, rel))
                worst = max(worst, rel)
    return worst


def compact_plain_gaps(factory, kw, b, objective, outer=2, short=None):
    """``(objective rel, voxel rel, RMS share)`` of the solve
    ``factory(iterations=outer, **kw)`` on ``b`` against its plain
    version; the share, of the short solve ``factory(**short, **kw)``'s
    (``short`` by default 1 outer × 2 CG) RMS gap to its plain version
    over the plain solve's RMS gap to the exact one (None without a
    storage mode). See COMPACT_PLAIN_SHARE."""
    short = short or dict(iterations=1, iter_max=2)
    s = factory(iterations=outer, **kw)
    xk, xp = s(b, b, ALPHA, RHO), s.plain(b, b, ALPHA, RHO)
    ok, op = objective(xk), objective(xp)
    gaps = [abs(ok - op) / abs(op),
            float((xk - xp).abs().max() / xp.abs().max()), None]
    del xk, xp
    if any(kw.get(k) not in (None, False) for k in STORAGE_KEYS[1:]):
        one = factory(**short, **kw)
        exact = factory(**short, **{
            k: v for k, v in kw.items() if k not in STORAGE_KEYS})
        xk, xp = one(b, b, ALPHA, RHO), one.plain(b, b, ALPHA, RHO)
        xe = exact(b, b, ALPHA, RHO)
        gaps[2] = float((xk - xp).double().norm()
                        / (xp - xe).double().norm().clamp_min(1e-300))
    return tuple(gaps)


def compact_gaps_ok(gaps, kw, storage=None):
    """Whether :func:`compact_plain_gaps` of the solve options ``kw``
    pass: the COMPACT_PLAIN bands of ``storage`` (by default the one
    ``kw`` names: "dirs", or "state" with a ``state_dtype``) under a
    storage mode, the float32 solve bands (SOLVE_*) without one."""
    obj, vox, share = gaps
    if share is None:
        return obj <= SOLVE_OBJ_TOL and vox <= SOLVE_VOX_TOL
    storage = storage or ("dirs" if kw.get("state_dtype") is None
                          else "state")
    return (obj <= COMPACT_PLAIN_OBJ_TOL[storage]
            and vox <= COMPACT_PLAIN_VOX_TOL[storage]
            and share <= COMPACT_PLAIN_SHARE)


def _scal(device, gamma=3.0, a=0.31, beta=0.83):
    import torch

    return torch.tensor([gamma, 0.0, a, beta, 0.0, 0.0], dtype=torch.float64,
                        device=device)


def compact_unit_pairs(B, st, shape, device, rng):
    """Every storage-typed unit (each storage mode, each form) and its plain
    version on the same inputs: ``{unit: [(kernel out, plain out), ...]}``,
    the CG scalars among the outputs."""
    import torch

    from nsol_tpu_torch.ops.cuda import tiled as T

    bf = torch.bfloat16

    def rand(lo=0.0):
        return torch.as_tensor(rng.rand(*shape).astype(np.float32) + lo,
                               device=device)

    v, rhs, r, p, x, q = rand(), rand(), rand(-0.5), rand(-0.5), rand(-0.3), \
        rand(-0.5)
    n, h2 = st.normal, st.inv_h2
    out = {k: [] for k in ("normal_apply", "cg_step", "cg_update",
                           "normal_apply_zy", "cg_direction")}
    vb = v.to(bf)
    out["normal_apply"].append((B.normal_apply(vb, n, h2, RHO, io_dtype=bf),
                                B.normal_apply_plain(vb, n, h2, RHO,
                                                     io_dtype=bf)))
    s1, s2 = _scal(device), _scal(device)
    rk = B.normal_apply(x, n, h2, RHO, rhs=rhs, scal=s1, io_dtype=bf)
    rp = B.normal_apply_plain(x, n, h2, RHO, rhs=rhs, scal=s2, io_dtype=bf)
    out["normal_apply"] += [(rk, rp, rhs - rp.float()), (s1[:1], s2[:1])]
    for storage in ("qf32", "dirs", "state"):
        (R, P, Q), _ = B.storage_ids(storage)
        rs, ps = r.to(R), p.to(P)
        for first in (True, False):
            s1, s2 = _scal(device), _scal(device)
            out["cg_step"] += list(zip(
                B.cg_step(rs, ps, s1, n, h2, RHO, first, storage=storage),
                B.cg_step_plain(rs, ps, s2, n, h2, RHO, first,
                                storage=storage))) + [(s1[1:3], s2[1:3])]
        for store_r in (True, False):
            s1, s2 = _scal(device), _scal(device)
            xk, xp, rk, rp = x.clone(), x.clone(), rs.clone(), rs.clone()
            B.cg_update(xk, rk, ps, q.to(Q), s1, store_r)
            B.cg_update_plain(xp, rp, ps, q.to(Q), s2, store_r)
            out["cg_update"] += [(xk, xp), (rk, rp), (s1[[0, 3]], s2[[0, 3]])]
    s1, s2 = _scal(device), _scal(device)
    xk, xp = x.clone(), x.clone()
    B.cg_update(xk, None, p.to(bf), None, s1)
    B.cg_update_plain(xp, None, p.to(bf), None, s2)
    out["cg_update"].append((xk, xp))
    out["normal_apply_zy"].append((T.normal_apply_zy(vb, n, h2, RHO,
                                                     io_dtype=bf),
                                   T.normal_apply_zy_plain(vb, n, h2, RHO,
                                                           io_dtype=bf)))
    s1, s2 = _scal(device), _scal(device)
    out["normal_apply_zy"] += [
        (T.normal_apply_zy(vb, n, h2, RHO, scal=s1, io_dtype=bf),
         T.normal_apply_zy_plain(vb, n, h2, RHO, scal=s2, io_dtype=bf)),
        (s1[1:3], s2[1:3])]
    for io, pd in ((None, torch.float32), (None, bf), (bf, bf)):
        s1, s2 = _scal(device), _scal(device)
        got = T.normal_apply_zy(x, n, h2, RHO, rhs=rhs, scal=s1, io_dtype=io,
                                p_dtype=pd)
        ref = T.normal_apply_zy_plain(x, n, h2, RHO, rhs=rhs, scal=s2,
                                      io_dtype=io, p_dtype=pd)
        q = rhs - ref[0].float()  # the rounded q of the residual
        out["normal_apply_zy"] += [(g, r, q) for g, r in zip(got, ref)] \
            + [(s1[:1], s2[:1])]
    s1 = _scal(device)
    for rs, qs in ((r, None), (r.to(bf), q.to(bf))):
        pk, pp, rk, rp = (t.clone() for t in (p.to(bf), p.to(bf), rs, rs))
        T.cg_direction(pk, rk, s1, q=qs)
        T.cg_direction_plain(pp, rp, s1, q=qs)
        out["cg_direction"] += [(pk, pp), (rk, rp)]
    return out


def sweep_unit_pairs(B, st, shape, device, rng, dtype):
    """The sweep (first trip and a later one, storage ``dtype``) and its
    plain version on the same inputs: ``{"cg_sweep": [(kernel, plain),
    ...]}`` — x, r', p', q' and the scalars."""
    def rand(lo=0.0):
        import torch

        return torch.as_tensor(rng.rand(*shape).astype(np.float32) + lo,
                               device=device)

    x, r, p, q = rand(-0.3), rand(-0.5), rand(-0.5), rand(-0.5)
    out = []
    for first in (True, False):
        s1, s2 = _scal(device), _scal(device)
        xk, xp = x.clone(), x.clone()
        qk, qp = q.to(dtype).clone(), q.to(dtype).clone()
        got = B.cg_sweep(xk, r.to(dtype), p.to(dtype), qk, s1, st.normal,
                         st.inv_h2, RHO, first)
        ref = B.cg_sweep_plain(xp, r.to(dtype), p.to(dtype), qp, s2,
                               st.normal, st.inv_h2, RHO, first)
        out += [(xk, xp), (qk, qp)] + list(zip(got, ref)) + [(s1, s2)]
    return {"cg_sweep": out}


def compact_call(B, T, st, shape, device, name):
    """``(kernel, plain, library, float32 twin, pair)`` closures of the
    compact entry ``name`` at ``shape``, each the form its main path runs,
    on random inputs of its own. Kernel and plain each update their own
    copies of the state they write, so that their first calls start alike
    and return every output (in-place ones and the CG scalars included);
    ``pair(got, ref)`` matches those into :func:`compact_pairs_err` pairs.
    Later calls drift, as a solve's do. Library: a PyTorch call of the
    same function (or None); twin: the unit in float32 storage (or None).
    """
    import torch

    bf = torch.bfloat16
    rng = np.random.RandomState(24)

    def rand(lo=0.0):
        return torch.as_tensor(rng.rand(*shape).astype(np.float32) + lo,
                               device=device)

    x, r, p, q, rhs = rand(-0.3), rand(-0.5), rand(-0.5), rand(-0.5), rand()
    n, h2 = st.normal, st.inv_h2
    rb, pb, qb = r.to(bf), p.to(bf), q.to(bf)
    s0 = _scal(device)
    s = [s0.clone() for _ in range(3)]  # kernel, plain, twin

    def own(t):  # one copy each for kernel, plain and twin
        return [t.clone() for _ in range(3)]

    if name.startswith("cg_step"):
        storage = name[len("cg_step["):-1]
        rs = rb if storage == "state" else r
        units = (B.cg_step, B.cg_step_plain)

        def call(k):
            return [*units[k](rs, pb, s[k], n, h2, RHO, storage=storage),
                    s[k][1:3]]

        twin = lambda: B.cg_step(r, p, s[2], n, h2, RHO)  # noqa: E731
    elif name == "normal_apply[bf16]":
        units = (B.normal_apply, B.normal_apply_plain)

        def call(k):
            return [units[k](x, n, h2, RHO, rhs=rhs, scal=s[k], io_dtype=bf),
                    s[k][:1]]

        twin = lambda: B.normal_apply(x, n, h2, RHO, rhs=rhs,  # noqa: E731
                                      scal=s[2])
    elif name == "cg_update[dirs]":
        units = (B.cg_update, B.cg_update_plain)
        xs, rs = own(x), own(r)

        def call(k):
            units[k](xs[k], rs[k], pb, qb, s[k])
            return [xs[k], rs[k], s[k][[0, 3]]]

        twin = lambda: B.cg_update(xs[2], rs[2], p, q, s[2])  # noqa: E731
    elif name.startswith("cg_sweep"):
        # x and q in place, the scalars by its recurrence: each call starts
        # from the same scalars
        units = (B.cg_sweep, B.cg_sweep_plain)
        f32 = name == "cg_sweep"
        xs = own(x)
        qs = own(q) if f32 else own(qb)[:2] + [q.clone()]

        def sweep(k, unit, rr, pp):
            s[k].copy_(s0)
            return [*unit(xs[k], rr, pp, qs[k], s[k], n, h2, RHO), xs[k],
                    qs[k], s[k]]

        def call(k):
            return sweep(k, units[k], *((r, p) if f32 else (rb, pb)))

        twin = None if f32 else (lambda: sweep(2, B.cg_sweep, r, p))
    elif name == "normal_apply_zy[bf16]":
        units = (T.normal_apply_zy, T.normal_apply_zy_plain)

        def call(k):
            return [units[k](pb, n, h2, RHO, scal=s[k], io_dtype=bf),
                    s[k][1:3]]

        twin = lambda: T.normal_apply_zy(p, n, h2, RHO,  # noqa: E731
                                         scal=s[2])
    elif name == "cg_direction[bf16]":
        units = (T.cg_direction, T.cg_direction_plain)
        ps, p32 = own(pb), p.clone()

        def call(k):
            units[k](ps[k], r, s[k])
            return [ps[k]]

        twin = lambda: T.cg_direction(p32, r, s[2])  # noqa: E731
    else:
        raise KeyError(name)
    library = None
    if name == "cg_direction[bf16]":
        lib_out, beta = torch.empty_like(pb), float(s0[B.BETA])
        library = lambda: torch.add(r, pb, alpha=beta,  # noqa: E731
                                    out=lib_out)

    def pair(got, ref):
        out = [(g, f) for g, f in zip(got, ref)]
        if name == "normal_apply[bf16]":  # the residual: one ulp of its q
            out[0] += (rhs - ref[0].float(),)
        return out

    return lambda: call(0), lambda: call(1), library, twin, pair


def compact_problem(device, shape):
    """``A·(rand > 0.7)`` at ``shape`` on the card (σ = 1 wrap blur), the
    same draw as phases 5 and 21; and the float64 blur for the objective."""
    import torch

    from nsol_tpu_torch.ops import conv as C

    iso = np.diag([SIGMA ** 2] * 3)
    A, _ = C.make_blur_operators(iso, alpha_cut=3, dtype=np.float32)
    A64, _ = C.make_blur_operators(iso, alpha_cut=3, dtype=np.float64)
    xt = torch.as_tensor(np.random.RandomState(0).rand(*shape) > 0.7,
                         device=device).float()
    b = A(xt).contiguous()
    del xt
    return b, iso, A64


def run_compact_phases(device, card):
    """Phases 23-25: compact storage (K10, linear) and the sweep (K8).
    Returns the ``kernels`` records of the storage-typed units."""
    import scipy.ndimage as ndi
    import torch

    from nsol_tpu_torch import data, interop, policy
    from nsol_tpu_torch.cli import run_deconvolution
    from nsol_tpu_torch.io import read_nifti, write_nifti
    from nsol_tpu_torch.ops import kernels as K
    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import fused as F
    from nsol_tpu_torch.ops.cuda import tiled as T

    bf = torch.bfloat16
    # phase 23: the units against their plain versions on tile-edge shapes
    rng = np.random.RandomState(23)
    for label, cov, sp, shape in EDGE_CASES + (
            ("image", np.diag([1.0] * 3), None, (1, 40, 33)),):
        st = B.Stencils.from_cov(cov, 3, sp, device)
        worst = compact_pairs_err(compact_unit_pairs(B, st, shape, device,
                                                     rng))
        for dt in (torch.float32, bf):
            worst = max(worst, compact_pairs_err(sweep_unit_pairs(
                B, st, shape, device, rng, dt)))
        print("phase 23 storage units and sweep %s %s: f32 outputs and dots "
              "within %.2e of plain, bf16 ones within %g ulp"
              % (label, "x".join(map(str, shape)), worst, BF16_ULPS))
    # ... and at each main path's shape, in the form it runs there: held to
    # the same bands, and timed beside the plain version
    iso = np.diag([SIGMA ** 2] * 3)
    st = B.Stencils.from_cov(iso, 3, None, device)
    times, err = {}, {}
    for k, u in COMPACT_UNITS.items():
        shape = COMPACT_SHAPES[u[3]]
        kf, pf, lf, tf, pair = compact_call(B, T, st, shape, device, k)
        pairs = pair(kf(), pf())
        compact_pairs_err({k: pairs})
        err[k] = max(float((g.float() - f.float()).abs().max())
                     for g, f, *_ in pairs if tuple(g.shape) == shape)
        del pairs
        reps = 3 if shape == BIG else 10
        times[k] = (cuda_median_ms(kf, reps), cuda_median_ms(pf, 2),
                    None if lf is None else cuda_median_ms(lf, reps),
                    None if tf is None else cuda_median_ms(tf, reps))
        del kf, pf, lf, tf, pair
        torch.cuda.empty_cache()
    print("phase 23 at each main path's shape: every output within its band "
          "of plain (max |d| %s)" % {k: "%.3g" % v for k, v in err.items()})
    print("phase 23 per call at each main path's shape (kernel / plain / "
          "library / float32-storage ms; bound ms): %s [%s]" % (", ".join(
              "%s %s %.4f/%.3f/%s/%s, %.4f" % (
                  k, "x".join(map(str, COMPACT_SHAPES[u[3]])), times[k][0],
                  times[k][1], *("-" if t is None else "%.4f" % t
                                 for t in times[k][2:]),
                  compact_bound(k, COMPACT_SHAPES[u[3]])[0])
              for k, u in COMPACT_UNITS.items()), card))
    lap("phase 23")

    # phase 24: whole solves
    launches, runs = {}, {}

    def run(key, solve, b, objective):
        if b.numel() <= 64 ** 3:  # host-bound: warm the allocator first
            solve(b, b, ALPHA, RHO)
        torch.cuda.synchronize()
        F.reset_counts()
        x, ms = timed_once(lambda: solve(b, b, ALPHA, RHO))
        launches[key] = {k: v for k, v in F.launch_counts().items() if v}
        require(all(v == 0 for v in F.plain_counts().values()),
                "phase 24: %s ran a plain version: %s"
                % (key, F.plain_counts()))
        require(bool(torch.isfinite(x).all()) and x.shape == b.shape,
                "phase 24: %s not finite or misshapen" % key)
        runs[key] = (objective(x), ms)
        return x

    def held_to_plain(key, factory, kw, b, objective):
        plain_gates[key] = gaps = compact_plain_gaps(factory, kw, b,
                                                     objective)
        require(compact_gaps_ok(gaps, kw),
                "phase 24: %s kernel vs plain: at 2 x %d objective rel %.3g,"
                " voxel %.3g; at 1 x 2 RMS share of the gap to exact %s"
                % (key, ITER_MAX, gaps[0], gaps[1], gaps[2]))

    plain_gates = {}
    # 64³: the fused solve, compact against the anchor and the exact one
    img = read_nifti(data.path("3D_SheppLoganPhantom_64.nii.gz"))
    kern = K.gaussian_kernel(iso, alpha_cut=3, spacing=np.ones(3))
    b_np = ndi.convolve(img.data.astype(np.float64), kern, mode="wrap")
    b64 = interop.to_torch(b_np.astype(np.float32), device)

    def obj64(x):
        return objective_host(interop.to_numpy(x), b_np, kern, ALPHA)

    for key, kw in (("fused64", dict(precision="high3", compact_dirs=True)),
                    ("fused64_exact", {})):
        run(key, F.make_fused_admm_solver((64,) * 3, iso,
                                          iterations=ITERATIONS,
                                          iter_max=ITER_MAX, **kw), b64, obj64)
    dev64 = abs(runs["fused64"][0] - OBJECTIVE_ANCHOR) / OBJECTIVE_ANCHOR
    require(dev64 <= ANCHOR_BAND, "phase 24: 64^3 compact objective %.2f "
            "deviates %.4f%% from %.2f" % (runs["fused64"][0], 100 * dev64,
                                           OBJECTIVE_ANCHOR))
    require(launches["fused64"].get("cg_step") == ITERATIONS * ITER_MAX,
            "phase 24: 64^3 compact launches %s" % launches["fused64"])
    held_to_plain("fused64", partial(F.make_fused_admm_solver, (64,) * 3,
                                     iso, iter_max=ITER_MAX),
                  dict(precision="high3", compact_dirs=True), b64, obj64)
    # 256³: "step" compact and bf16 state, "sweep" f32 and bf16 state
    b, iso, A64 = compact_problem(device, SCALE_SHAPE)

    def obj256(x):
        return objective_device(x, b, A64, ALPHA)

    modes = {"step_exact": dict(mode="step"),
             "step_dirs": dict(mode="step", compact_dirs=True),
             "step_state": dict(mode="step", state_dtype=bf),
             "sweep_f32": dict(mode="sweep"),
             "sweep_bf16": dict(mode="sweep", state_dtype=bf)}
    for key, kw in modes.items():
        run(key, B.blocked_admm_solve(SCALE_SHAPE, iso, iterations=ITERATIONS,
                                      iter_max=ITER_MAX, **kw), b, obj256)
    ref = runs["step_exact"][0]
    gates = {}
    for key in ("step_dirs", "step_state", "sweep_f32", "sweep_bf16"):
        tol = SWEEP_F32_TOL if key == "sweep_f32" else COMPACT_OBJ_TOL
        gates[key] = abs(runs[key][0] - ref) / ref
        require(gates[key] <= tol, "phase 24: 256^3 %s objective %.3f vs "
                "exact %.3f (rel %.3g > %g)" % (key, runs[key][0], ref,
                                                gates[key], tol))
    for key in ("sweep_f32", "sweep_bf16"):
        lc = launches[key]
        require(lc.get("cg_sweep") == ITERATIONS * ITER_MAX
                and lc.get("cg_update") == ITERATIONS
                and "cg_step" not in lc,
                "phase 24: %s launches %s" % (key, lc))
    for key in ("step_dirs", "step_state", "sweep_f32", "sweep_bf16"):
        held_to_plain(key, partial(B.blocked_admm_solve, SCALE_SHAPE, iso,
                                   iter_max=ITER_MAX), modes[key], b, obj256)
    del b
    torch.cuda.empty_cache()
    # 512³: "apply" compact and bf16 state against the anchor
    b, iso, A64 = compact_problem(device, BIG)

    def obj512(x):
        return objective_device(x, b, A64, ALPHA)

    for key, kw in (("apply_dirs", dict(compact_dirs=True)),
                    ("apply_state", dict(state_dtype=bf)),
                    ("apply_exact", {})):
        solve = B.blocked_admm_solve(BIG, iso, iterations=ITERATIONS,
                                     iter_max=ITER_MAX, **kw)
        require(solve.mode == "apply", "phase 24: 512^3 took %r" % solve.mode)
        run(key, solve, b, obj512)
        if key != "apply_exact":
            d = abs(runs[key][0] - BIG_ANCHOR) / BIG_ANCHOR
            require(d <= ANCHOR_BAND, "phase 24: 512^3 %s objective %.2f "
                    "deviates %.4f%% from %.1f" % (key, runs[key][0],
                                                   100 * d, BIG_ANCHOR))
            held_to_plain(key, partial(B.blocked_admm_solve, BIG, iso,
                                       iter_max=ITER_MAX), kw, b, obj512)
    del b
    torch.cuda.empty_cache()
    print("phase 24 solves 50x10 (objective, ms a solve): %s; 256^3 rel to "
          "exact %s; kernel vs plain (objective/voxel at 2 outer, RMS share "
          "of the gap to exact at 1 x 2) %s; launches %s [%s]" % (
              {k: (round(v[0], 3), round(v[1], 2)) for k, v in runs.items()},
              {k: "%.2e" % v for k, v in gates.items()},
              {k: "/".join("-" if g is None else "%.2e" % g for g in v)
               for k, v in plain_gates.items()},
              launches, card))
    lap("phase 24")

    # phase 25: run_deconvolution's default on a 64³ and a (64, 512, 512)
    # NIfTI is the compact library solve; NSOL_TPU_EXACT=1 the exact one,
    # NSOL_TPU_COMPACT=1 the bf16-state one (blocked route)
    sub_b, _, _ = compact_problem(device, (64, 512, 512))
    cli_its = 5
    envs = ({}, {"NSOL_TPU_EXACT": "1"}, {"NSOL_TPU_COMPACT": "1"})
    cli_dev = {}
    with tempfile.TemporaryDirectory() as tmp:
        for vol, its in ((b_np.astype(np.float32), ITERATIONS),
                         (interop.to_numpy(sub_b), cli_its)):
            obs = os.path.join(tmp, "b.nii")
            write_nifti(vol, obs, spacing=np.ones(3))
            b_read = read_nifti(obs).data.astype(np.float64)
            scale = float(np.max(b_read))
            bs = torch.as_tensor((b_read / scale).astype(np.float32),
                                 device=device)
            for env in envs:
                out = os.path.join(tmp, "x.nii")
                with environ(**env):
                    build, kw = policy.tvl2_solver(
                        vol.shape, iso, np.ones(3), "cuda", its, ITER_MAX)
                    rc = run_deconvolution.main([
                        "--observation", obs, "--result", out, "--solver",
                        "ADMM", "--reconstruction-type", "TVL2", "--alpha",
                        str(ALPHA), "--blur", str(SIGMA), "--iterations",
                        str(its), "--iter-max", str(ITER_MAX), "--device",
                        "cuda"])
                want = {(): {"precision": "high3", "compact_dirs": True}
                        if vol.shape == (64,) * 3 else {"compact_dirs": True},
                        ("NSOL_TPU_EXACT",): {},
                        ("NSOL_TPU_COMPACT",): {"state_dtype": bf}
                        if vol.shape != (64,) * 3
                        else {"precision": "high3", "compact_dirs": True}
                        }[tuple(env)]
                got_kw = {k: v for k, v in kw.items()
                          if k in ("precision", "compact_dirs",
                                   "state_dtype")}
                require(rc == 0 and got_kw == want, "phase 25: %s %s: rc %r, "
                        "options %s" % (vol.shape, env, rc, got_kw))
                lib = interop.to_numpy(build(**kw)(bs, bs, ALPHA, RHO))
                recon = read_nifti(out).data.astype(np.float64)
                lib = lib.astype(np.float64) * scale
                key = "%s %s" % ("x".join(map(str, vol.shape)),
                                 ",".join(env) or "default")
                cli_dev[key] = float(np.max(np.abs(recon - lib))
                                     / np.max(np.abs(lib)))
                require(np.all(np.isfinite(recon))
                        and cli_dev[key] <= KERNEL_TOL,
                        "phase 25: CLI %s vs library %.3g"
                        % (key, cli_dev[key]))
    del sub_b
    torch.cuda.empty_cache()
    print("phase 25 CLI run_deconvolution TVL2 linear: max|cli - library|/"
          "max %s (default compact, NSOL_TPU_EXACT=1 exact, "
          "NSOL_TPU_COMPACT=1 bf16 state on the blocked route)"
          % {k: "%.2e" % v for k, v in cli_dev.items()})
    lap("phase 25")

    out = []
    for name, (unit, tpu, source, path, bpv, taps) in COMPACT_UNITS.items():
        b_ms, b_by = compact_bound(name, COMPACT_SHAPES[path])
        t = times[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": tpu,
                    "launches": int(launches[path].get(unit, 0)),
                    "max_abs_err": err[name], "ms": t[0], "plain_ms": t[1],
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": t[2]})
        require(out[-1]["launches"] > 0, "phase 24: %s launched no time on "
                "its main path (%s)" % (name, path))
    return out


def compact_bound(name, shape):
    """``(bound_ms, bound_by)`` of one call of the compact entry ``name``
    (of COMPACT_UNITS or ROBUST_COMPACT_UNITS) at ``shape``: its bytes a
    voxel (each input read once, each output written once, at its storage
    width) and ~2 operations a tap plus ~20 for the Laplacian and the
    update."""
    _, _, _, _, bpv, taps = {**COMPACT_UNITS, **ROBUST_COMPACT_UNITS}[name]
    n = int(np.prod(shape))
    return bound(float(n) * bpv, float(n) * (2 * 3 * taps + 20))


# ------------------------------------------------------- phases 26-28 --

#: the 256³ volume cut into 4 slabs (row0 = 64 k) for the global rows
SLAB_SHAPE, SLABS = (256, 256, 256), 4
#: (label, unit, with the blur's Laplacian term): every form in which the
#: sharded solves call the window units
WINDOW_FORMS = (("normal_apply_prepadded", "normal_apply_prepadded", True),
                ("blur_apply_prepadded", "blur_apply_prepadded", True),
                ("blur_apply_prepadded (A y)", "blur_apply_prepadded", False),
                ("weighted_apply_prepadded", "weighted_apply_prepadded",
                 True))


def window_halo(B, R, name, st):
    """The z halo of the window unit ``name`` with stencils ``st``."""
    return {"normal_apply_prepadded": lambda: B.prepadded_halo(st.normal),
            "blur_apply_prepadded": lambda: R.blur_halo(st.blur),
            "weighted_apply_prepadded": lambda: R.weighted_halo(st.blur)}[
                name]()


def window_reads(B, R, name, st, zl, lap=True):
    """The volumes of ``zl`` planes that the window unit ``name`` reads
    from its inputs: all of ``v_ext`` / ``y_ext``; the blur's ``u_ext``
    only on the Laplacian's centre ±1 planes (none without ``lap``); the
    weighted apply's ``w_ext`` only on the ``zl + 2·r_a`` rows of its
    first blur."""
    reads = (zl + 2.0 * window_halo(B, R, name, st)) / zl
    if name == "blur_apply_prepadded" and lap:
        reads += (zl + 2.0) / zl
    if name == "weighted_apply_prepadded":
        reads += (zl + 2.0 * (st.blur.lengths[0] // 2)) / zl
    return reads


def wrap_slab(v, row0, zl, h):
    """Planes ``row0 − h .. row0 + zl + h − 1`` of ``v``, wrapped."""
    import torch

    idx = torch.arange(row0 - h, row0 + zl + h, device=v.device) % v.shape[0]
    return v.index_select(0, idx).contiguous()


def window_calls(B, R, st, name, v_ext, w_ext, row0, z_total, lap=True):
    """(kernel, plain) closures of the window unit ``name`` on ``v_ext``
    (and ``w_ext``), in a form of its main path: the blur's with its
    Laplacian term (the IRLS gradient), or without it for ``lap=False``
    (the residual ``A x``)."""
    h2 = st.inv_h2
    if name == "normal_apply_prepadded":
        args = (v_ext, st.normal, h2, RHO, row0, z_total)
        return (lambda: B.normal_apply_prepadded(*args),
                lambda: B.normal_apply_prepadded_plain(*args))
    if name == "blur_apply_prepadded":
        args = (v_ext, st.blur, h2, row0, z_total) + (
            (w_ext, RHO) if lap else ())
        return (lambda: R.blur_apply_prepadded(*args),
                lambda: R.blur_apply_prepadded_plain(*args))
    args = (v_ext, w_ext, st.blur, h2, RHO, row0, z_total)
    return (lambda: R.weighted_apply_prepadded(*args),
            lambda: R.weighted_apply_prepadded_plain(*args))


def whole_call(B, R, st, name, v, w):
    """The whole-volume (wrap) unit beside window unit ``name``."""
    if name == "normal_apply_prepadded":
        return lambda: B.normal_apply(v, st.normal, st.inv_h2, RHO)
    if name == "blur_apply_prepadded":
        return lambda: R.blur_apply(v, st.blur, st.inv_h2, w, RHO)
    return lambda: R.weighted_apply(v, None, None, w, B.new_scalars(v.device),
                                    st.blur, st.inv_h2, RHO, first=True)[1]


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_sharded_phases(device, card):
    """Phases 26-28: the sharded path (``nsol_tpu_torch.parallel``) on a
    process group of world size 1. Returns each window unit's launches on
    its 512³ solve, its max |Δ| against its plain version at 512³ over the
    forms the solves call, (kernel ms, plain ms) per call there, its taps,
    its halo'd/output plane ratio and the volumes it reads there."""
    import torch

    from nsol_tpu_torch import data
    from nsol_tpu_torch.io import read_nifti
    from nsol_tpu_torch.ops import grad as G
    from nsol_tpu_torch.ops import prox
    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import fused as F
    from nsol_tpu_torch.ops.cuda import robust as R
    from nsol_tpu_torch.parallel import distributed as dist
    from nsol_tpu_torch.parallel import (make_space_mesh,
                                         sharded_tv_admm_solve,
                                         sharded_tv_denoise_solve)
    from nsol_tpu_torch.solvers.primal_dual import primal_dual_solve

    def rand(shape, rng, lo=0.0):
        return torch.as_tensor(rng.rand(*shape).astype(np.float32) + lo,
                               device=device)

    # phase 26: the window units against their plain versions on the
    # tile-edge shapes as local slabs (row0 on the first, a middle and the
    # last of 3), ...
    rng = np.random.RandomState(26)
    for label, cov, sp, shape in EDGE_CASES + (
            ("image", np.diag([1.0] * 3), None, (1, 40, 33)),):
        st = B.Stencils.from_cov(cov, 3, sp, device)
        rels = {}
        for form, name, with_lap in WINDOW_FORMS:
            h = window_halo(B, R, name, st)
            ext = (shape[0] + 2 * h,) + shape[1:]
            v, w = rand(ext, rng), rand(ext, rng, 0.1)
            for row0 in (0, shape[0], 2 * shape[0]):
                kf, pf = window_calls(B, R, st, name, v, w, row0,
                                      3 * shape[0], with_lap)
                got, ref = kf(), pf()
                torch.cuda.synchronize()
                rels[form] = max(rels.get(form, 0.0), max_rel(got, ref))
        for k, rel in rels.items():
            require(rel <= KERNEL_TOL, "phase 26: %s %s %s rel %.3g > %g"
                    % (k, label, shape, rel, KERNEL_TOL))
        print("phase 26 window units %s %s: %s" % (
            label, "x".join(map(str, shape)),
            ", ".join("%s %.2e" % kv for kv in rels.items())))
    # ... 4 slabs of one 256³ volume assembled against the whole-volume
    # units (the global boundary rows land on the first and last slab) ...
    iso = np.diag([SIGMA ** 2] * 3)
    st = B.Stencils.from_cov(iso, 3, None, device)
    v, w = rand(SLAB_SHAPE, rng), rand(SLAB_SHAPE, rng, 0.1)
    zl = SLAB_SHAPE[0] // SLABS
    slab_rel = {}
    for name in F.SHARDED_UNITS:
        h = window_halo(B, R, name, st)
        outs = []
        for k in range(SLABS):
            kf, _ = window_calls(B, R, st, name, wrap_slab(v, k * zl, zl, h),
                                 wrap_slab(w, k * zl, zl, h), k * zl,
                                 SLAB_SHAPE[0])
            outs.append(kf())
        whole = whole_call(B, R, st, name, v, w)()
        torch.cuda.synchronize()
        slab_rel[name] = max_rel(torch.cat(outs), whole)
        require(slab_rel[name] <= KERNEL_TOL, "phase 26: %s, %d slabs of "
                "256^3 vs the whole volume rel %.3g" % (name, SLABS,
                                                        slab_rel[name]))
    # the blur without its Laplacian term: the residual's form
    h = window_halo(B, R, "blur_apply_prepadded", st)
    outs = [R.blur_apply_prepadded(wrap_slab(v, k * zl, zl, h), st.blur,
                                   st.inv_h2, k * zl, SLAB_SHAPE[0])
            for k in range(SLABS)]
    slab_rel["blur_apply_prepadded (A y)"] = max_rel(
        torch.cat(outs), R.blur_apply(v, st.blur, st.inv_h2))
    require(slab_rel["blur_apply_prepadded (A y)"] <= KERNEL_TOL,
            "phase 26: the window blur's slabs vs the whole volume")
    del v, w, outs, whole
    print("phase 26 %d slabs of 256^3 (row0 = 64 k) vs the whole-volume "
          "units: %s" % (SLABS, ", ".join("%s %.2e" % kv
                                           for kv in slab_rel.items())))
    # ... and per call at 512³ (one rank: Zl = 512) beside the whole-volume
    # units, in every form the solves call
    times, err, ext_ratio, reads, form_ms = {}, {}, {}, {}, {}
    for label, name, with_lap in WINDOW_FORMS:
        h = window_halo(B, R, name, st)
        ext = (BIG[0] + 2 * h,) + BIG[1:]
        v, w = rand(ext, rng), rand(ext, rng, 0.1)
        kf, pf = window_calls(B, R, st, name, v, w, 0, BIG[0], with_lap)
        got, ref = kf(), pf()
        require(max_rel(got, ref) <= KERNEL_TOL,
                "phase 26: %s at 512^3 deviates" % label)
        err[name] = max(err.get(name, 0.0), float((got - ref).abs().max()))
        del got, ref
        form_ms[label] = (cuda_median_ms(kf, 5), window_reads(
            B, R, name, st, BIG[0], with_lap))
        if with_lap:  # the kernels line carries each unit's main form
            vc = v[h:h + BIG[0]].contiguous()
            wc = w[h:h + BIG[0]].contiguous()
            ext_ratio[name], reads[name] = ext[0] / BIG[0], form_ms[label][1]
            times[name] = (form_ms[label][0], cuda_median_ms(pf, 2), None,
                           cuda_median_ms(whole_call(B, R, st, name, vc, wc),
                                          5))
            del vc, wc
        del v, w, kf, pf
        torch.cuda.empty_cache()
    taps = {"normal_apply_prepadded": st.normal.lengths,
            "blur_apply_prepadded": st.blur.lengths,
            "weighted_apply_prepadded": st.blur.lengths}
    print("phase 26 512^3 per call (window / plain / whole-volume unit ms, "
          "bound ms): %s; the blur without its Laplacian term (A y) %.3f "
          "ms, bound %.4f ms [%s]" % (", ".join(
              "%s %.3f/%.1f/%.3f, %.4f" % (
                  k, t[0], t[1], t[3],
                  unit_bound(k, int(np.prod(BIG)), taps[k],
                             ext=ext_ratio[k], reads=reads[k])[0])
              for k, t in times.items()),
              form_ms["blur_apply_prepadded (A y)"][0],
              unit_bound("blur_apply_prepadded", int(np.prod(BIG)),
                         taps["blur_apply_prepadded"],
                         ext=ext_ratio["blur_apply_prepadded"],
                         reads=form_ms["blur_apply_prepadded (A y)"][1])[0],
              card))
    lap("phase 26")

    # phase 27: the solves on a real NCCL group of world size 1
    dist.initialize(coordinator_address="localhost:%d" % free_port(),
                    num_processes=1, process_id=0)
    try:
        mesh = make_space_mesh()
        require(mesh.group is not None and mesh.size == 1
                and mesh.device == device and
                torch.distributed.get_backend() == "nccl",
                "phase 27: mesh %r, backend %s" % (
                    mesh, torch.distributed.get_backend()))
        b, iso, A64 = scale_problem(device, robust=False)
        F.reset_counts()
        x_s, ms_s = timed_once(lambda: sharded_tv_admm_solve(
            mesh, iso, b, b, ALPHA, RHO, iterations=ITERATIONS,
            iter_max=ITER_MAX))
        lin = F.launch_counts(F.SHARDED_UNITS)
        plain = F.plain_counts()
        require(lin["normal_apply_prepadded"] == ITERATIONS * (ITER_MAX + 1)
                and all(n == 0 for n in plain.values()),
                "phase 27: launches %s, plain calls %s" % (lin, plain))
        require(bool(torch.isfinite(x_s).all()) and x_s.shape == b.shape,
                "phase 27: sharded result not finite or misshapen")
        obj_s = objective_device(x_s, b, A64, ALPHA)
        dev = abs(obj_s - BIG_ANCHOR) / BIG_ANCHOR
        require(dev <= ANCHOR_BAND, "phase 27: sharded objective %.2f "
                "deviates %.4f%% from %.1f" % (obj_s, 100 * dev, BIG_ANCHOR))
        del x_s
        x_b, ms_b = timed_once(lambda: B.blocked_admm_solve(
            BIG, iso, iterations=ITERATIONS, iter_max=ITER_MAX)(
                b, b, ALPHA, RHO))
        obj_b = objective_device(x_b, b, A64, ALPHA)
        lin_rel = abs(obj_s - obj_b) / abs(obj_b)
        require(lin_rel <= SOLVE_OBJ_TOL, "phase 27: sharded %.4f vs "
                "blocked_admm_solve %.4f" % (obj_s, obj_b))
        del x_b
        # where the sharded solve's time goes, over 5 outer iterations
        wall, busy, by = device_breakdown(
            lambda: sharded_tv_admm_solve(mesh, iso, b, b, ALPHA, RHO,
                                          iterations=5, iter_max=ITER_MAX),
            (("window unit passes", ("conv_x_pass", "conv_y_kernel",
                                     "conv_z_pass")),
             ("nccl", ("nccl",)), ("halo cat", ("CatArray",)),
             ("dots", ("reduce_kernel",))))
        require(busy > 0, "phase 27: the profiler trace holds no device time")
        print("phase 27 linear 512^3 5x%d sharded, torch.profiler: wall "
              "%.1f ms, device %.1f ms (busy %.1f %%); %s [%s]" % (
                  ITER_MAX, wall, busy, 100 * busy / wall, ", ".join(
                      "%s %.1f ms (%.1f %%)" % (k, v, 100 * v / busy)
                      for k, v in by.items()), card))
        del b
        torch.cuda.empty_cache()
        print("phase 27 linear 512^3 %dx%d on NCCL world 1: objective "
              "sharded %.3f, blocked_admm_solve %.3f (rel %.2e; anchor %.1f, "
              "dev %.4f%%); sharded %.1f ms a solve, blocked %.1f ms; "
              "launches %s [%s]" % (ITERATIONS, ITER_MAX, obj_s, obj_b,
                                    lin_rel, BIG_ANCHOR, 100 * dev, ms_s,
                                    ms_b, lin, card))
        its, sweeps, cgi = BIG_ROBUST_ITERS
        b, iso, A64 = scale_problem(device, robust=True)
        # x0 = max(b, 0): the sharded solve clips x0 on entry as the
        # reference's tikhonov_solve does, the C solve does not (ROADMAP
        # Queue 3, "Entry clip"); the outliers make b negative in places
        x0 = torch.clamp(b, min=0.0)
        F.reset_counts()
        x_s, ms_rs = timed_once(lambda: sharded_tv_admm_solve(
            mesh, iso, b, x0, ALPHA, RHO, iterations=its, iter_max=sweeps,
            data_loss="huber"))
        rob = F.launch_counts(F.SHARDED_UNITS)
        plain = F.plain_counts()
        require(rob["blur_apply_prepadded"] == 2 * its * sweeps
                and rob["weighted_apply_prepadded"] == its * sweeps
                * (cgi + 1) and all(n == 0 for n in plain.values()),
                "phase 27: robust launches %s, plain calls %s"
                % (rob, plain))
        ob_s = robust_objective(x_s, b, A64, ALPHA)
        del x_s
        x_t, ms_rt = timed_once(lambda: R.blocked_robust_admm_solve(
            BIG, iso, iterations=its, iter_max=sweeps, irls_cg_iters=cgi)(
                b, x0, ALPHA, RHO))
        ob_t = robust_objective(x_t, b, A64, ALPHA)
        rob_rel = abs(ob_s - ob_t) / abs(ob_t)
        require(rob_rel <= SOLVE_OBJ_TOL, "phase 27: sharded huber %.4f vs "
                "blocked_robust_admm_solve %.4f" % (ob_s, ob_t))
        del x_t, b, x0
        torch.cuda.empty_cache()
        print("phase 27 robust 512^3 huber %dx%dx%d: objective sharded "
              "%.4f, blocked_robust_admm_solve %.4f (rel %.2e); sharded "
              "%.1f ms a solve, blocked %.1f ms; launches %s [%s]"
              % (its, sweeps, cgi, ob_s, ob_t, rob_rel, ms_rs, ms_rt, rob,
                 card))
        # the sharded denoising solve on phase 10b's 256³ volume against
        # the whole-volume primal-dual solve and the fused CUDA solve
        phantom = read_nifti(data.path("3D_SheppLoganPhantom_64.nii.gz")) \
            .data.astype(np.float64)
        big = np.repeat(np.repeat(np.repeat(phantom, 4, 0), 4, 1), 4, 2)
        big = big + np.random.RandomState(1).normal(
            0, 0.05 * phantom.max(), big.shape)
        bb = torch.as_tensor((big / big.max()).astype(np.float32),
                             device=device)
        del big
        x_d, ms_d = timed_once(lambda: sharded_tv_denoise_solve(
            mesh, bb, PD_ALPHA, iterations=ITERATIONS, L2=PD_L2))
        x_w, _ = primal_dual_solve(
            lambda x, tau: prox.prox_ell2_denoising(x, tau, bb),
            prox.prox_tv_conj, G.gradient, G.gradient_adjoint, bb, PD_ALPHA,
            PD_L2, iterations=ITERATIONS)
        x_f = F.make_fused_pd_denoise_solver(bb.shape, "TVL2", "ALG2",
                                             ITERATIONS)(bb, bb, PD_ALPHA,
                                                         PD_L2)
        o_d, o_w, o_f = (pd_objective(x, bb, PD_ALPHA, False)
                         for x in (x_d, x_w, x_f))
        pd_rel = (abs(o_d - o_w) / abs(o_w), abs(o_d - o_f) / abs(o_f))
        require(bool(torch.isfinite(x_d).all()) and pd_rel[0] <= PD_OBJ_TOL
                and pd_rel[1] <= 1e-5, "phase 27: sharded denoise %.6f vs "
                "whole-volume %.6f, fused %.6f" % (o_d, o_w, o_f))
        del x_d, x_w, x_f, bb
        print("phase 27 denoise 256^3 TVL2/ALG2 %d: objective sharded %.4f, "
              "whole-volume primal_dual_solve %.4f (rel %.2e), fused %.4f "
              "(rel %.2e); sharded %.1f ms [%s]" % (
                  ITERATIONS, o_d, o_w, pd_rel[0], o_f, pd_rel[1], ms_d,
                  card))
        lap("phase 27")

        # phase 28: the process-local contract at world 1
        shape = (128, 128, 128)
        rs = np.random.RandomState(28)
        from nsol_tpu_torch.ops import conv as C

        A32, _ = C.make_blur_operators(iso, alpha_cut=3, dtype=np.float32)
        b_np = A32(torch.as_tensor(rs.rand(*shape) > 0.7).float()).numpy()
        lo, hi = dist.process_local_slice(shape, mesh)
        require((lo, hi) == (0, shape[0]), "phase 28: rows %d..%d" % (lo, hi))
        kw = dict(iterations=10, iter_max=ITER_MAX)
        x_pl = dist.process_local_data(sharded_tv_admm_solve(
            mesh, iso, b_np[lo:hi], b_np[lo:hi].copy(), ALPHA, RHO,
            process_local=True, **kw))
        x_full = sharded_tv_admm_solve(mesh, iso, b_np, b_np.copy(), ALPHA,
                                       RHO, **kw).cpu().numpy()
        require(x_pl.dtype == np.float32 and np.array_equal(x_pl, x_full),
                "phase 28: process-local rows differ from the full-volume "
                "solve (max |d| %.3g)" % float(np.max(np.abs(x_pl - x_full))))
        print("phase 28 process-local contract at world 1, 128^3 10x10: "
              "rows %d..%d, process_local=True equals the full-volume solve "
              "bit for bit" % (lo, hi))
        lap("phase 28")
    finally:
        torch.distributed.destroy_process_group()
    return {"launches": dict(lin, **{k: rob[k] for k in
                                     ("blur_apply_prepadded",
                                      "weighted_apply_prepadded")}),
            "err": err,
            "times": {k: (t[0], t[1], t[2]) for k, t in times.items()},
            "taps": taps, "ext": ext_ratio, "reads": reads}


# ------------------------------------------------------------------ main --

# -------------------------------------------------- phases 29-31 --

#: the storage-typed robust and Tikhonov units (K10b): the entry's name in
#: the kernels line → (wrapper, TPU kernel it replaces, source, main path,
#: bytes a voxel it must move, taps of its chain); the main path names the
#: phase 30/31 run whose launches it reports and the shape it is timed at.
#: The weighted applies read r, a bf16 p, free and the f32 weights (the
#: "io" form rounds them as it reads them) and write a bf16 p' and q: 20
#: bytes, two blur chains of 7 taps an axis at σ = 1. Their TK1 instances
#: are the ADMM's (the same Laplacian); TK0 has its own.
ROBUST_COMPACT_UNITS = {
    "weighted_apply[dirs]": ("weighted_apply",
                             "nsol_tpu/ops/pallas/fused.py:382",
                             "nsol_tpu_torch/csrc/robust.cu", "lena_dirs",
                             4 + 2 + 4 + 4 + 2 + 4, 14),
    "weighted_apply[dirs,TK0]": ("weighted_apply",
                                 "nsol_tpu/ops/pallas/fused.py:716",
                                 "nsol_tpu_torch/csrc/robust.cu",
                                 "tk0_huber", 20, 14),
    "cg_step[qf32,TK0]": ("cg_step", "nsol_tpu/ops/pallas/fused.py:716",
                          "nsol_tpu_torch/csrc/admm.cu", "tk0_linear",
                          4 + 2 + 2 + 4, 13),
    "weighted_apply[io]": ("weighted_apply",
                           "nsol_tpu/ops/pallas/robust.py:264",
                           "nsol_tpu_torch/csrc/robust.cu", "scale_io", 20,
                           14),
    "weighted_apply_zy[io]": ("weighted_apply_zy",
                              "nsol_tpu/ops/pallas/robust.py:564",
                              "nsol_tpu_torch/csrc/tiled.cu", "big_io", 20,
                              14),
}
#: the shape each main path of phases 30-31 runs at
ROBUST_COMPACT_SHAPES = {"lena_dirs": (256, 256), "tk0_huber": (256, 256),
                         "tk0_linear": (256, 256), "scale_io": SCALE_SHAPE,
                         "big_io": BIG}
#: the fused solves' compact storage (the reference CLI's and sweeps')
FUSED_COMPACT = {"precision": "high3", "compact_dirs": True}
#: the short robust solve of the RMS share (compact_plain_gaps)
ROBUST_SHORT = dict(iterations=1, iter_max=1, irls_cg_iters=2)
#: α of the TK0 units (ρ := α in the Tikhonov solve)
TIK_ALPHA = 0.05


def robust_pairs(got, ref, storage):
    """(kernel, plain) pairs of a weighted apply's ``(p', q, scalars)``;
    under "io" q holds bfloat16 values (the rounded core, or p' where
    frozen) and is held to the bf16 band."""
    import torch

    pairs = list(zip(got, ref))
    if storage == "io":
        pairs[1] = tuple(t.to(torch.bfloat16) for t in pairs[1])
    return pairs


def robust_compact_pairs(st, shape, device, rng):
    """Every storage-typed robust unit and its plain version on the same
    inputs — ``weighted_apply`` in the "dirs" and "io" modes (TK1 and TK0),
    ``weighted_apply_zy`` in both, masked and not, first trip and not;
    ``cg_step`` in "qf32" with TK0; the masked CG's ``cg_update`` on a
    bfloat16 direction —: ``{unit: [(kernel out, plain out), ...]}``."""
    import torch

    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import robust as R
    from nsol_tpu_torch.ops.cuda import tiled as T

    bf = torch.bfloat16

    def rand(lo=0.0):
        return torch.as_tensor(rng.rand(*shape).astype(np.float32) + lo,
                               device=device)

    r, p, wts, x, q = rand(-0.5), rand(-0.5), rand(0.1), rand(-0.3), \
        rand(-0.5)
    free, pb = (rand() > 0.3).float(), p.to(bf)
    out = {}
    forms = ((R.weighted_apply, R.weighted_apply_plain, "TK1"),
             (R.weighted_apply, R.weighted_apply_plain, "TK0"),
             (T.weighted_apply_zy, T.weighted_apply_zy_plain, None))
    for unit, plain, reg in forms:
        extra = {} if reg is None else {"reg": reg}
        rho = TIK_ALPHA if reg == "TK0" else RHO
        for storage in ("dirs", "io"):
            key = "%s[%s%s]" % (unit.__name__, storage,
                                ",TK0" if reg == "TK0" else "")
            for first in (True, False):
                for f in (free, None):
                    s1, s2 = _scal(device), _scal(device)
                    got = unit(r, pb, f, wts, s1, st.blur, st.inv_h2, rho,
                               first=first, storage=storage, **extra)
                    ref = plain(r, pb, f, wts, s2, st.blur, st.inv_h2, rho,
                                first=first, storage=storage, **extra)
                    out.setdefault(key, []).extend(
                        robust_pairs(got, ref, storage)
                        + [(s1[1:3], s2[1:3])])
    for first in (True, False):
        s1, s2 = _scal(device), _scal(device)
        out.setdefault("cg_step[qf32,TK0]", []).extend(list(zip(
            B.cg_step(r, pb, s1, st.normal, st.inv_h2, TIK_ALPHA, first,
                      reg="TK0", storage="qf32"),
            B.cg_step_plain(r, pb, s2, st.normal, st.inv_h2, TIK_ALPHA,
                            first, reg="TK0", storage="qf32")))
            + [(s1[1:3], s2[1:3])])
    s1, s2 = _scal(device), _scal(device)
    xk, xp, rk, rp = x.clone(), x.clone(), r.clone(), r.clone()
    B.cg_update(xk, rk, pb, q, s1)
    B.cg_update_plain(xp, rp, pb, q, s2)
    out["cg_update[qf32]"] = [(xk, xp), (rk, rp), (s1[[0, 3]], s2[[0, 3]])]
    return out


def robust_compact_call(st, shape, device, name):
    """``(kernel, plain, float32 twin, pair)`` closures of the entry
    ``name`` of ROBUST_COMPACT_UNITS at ``shape``, in the form its main
    path runs (masked, a later trip), on random inputs of its own; each
    returns its outputs and CG scalars from scalars of its own (the calls
    leave their inputs alone, so repeated calls give the same outputs).
    ``pair(got, ref)`` matches kernel and plain outputs into
    :func:`compact_pairs_err` pairs."""
    import torch

    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import robust as R
    from nsol_tpu_torch.ops.cuda import tiled as T

    rng = np.random.RandomState(29)

    def rand(lo=0.0):
        return torch.as_tensor(rng.rand(*shape).astype(np.float32) + lo,
                               device=device)

    r, p, wts = rand(-0.5), rand(-0.5), rand(0.1)
    free, pb = (rand() > 0.3).float(), p.to(torch.bfloat16)
    s = [_scal(device) for _ in range(3)]
    unit, mode = name[:-1].split("[")
    storage, reg = (mode.split(",") + ["TK1"])[:2]
    rho = TIK_ALPHA if reg == "TK0" else RHO
    if unit == "cg_step":
        units = (B.cg_step, B.cg_step_plain)

        def call(k, u, sto, pp):
            return [*u(r, pp, s[k], st.normal, st.inv_h2, rho, reg=reg,
                       storage=sto), s[k][1:3]]
    else:
        units = (R.weighted_apply, R.weighted_apply_plain) \
            if unit == "weighted_apply" \
            else (T.weighted_apply_zy, T.weighted_apply_zy_plain)
        extra = {"reg": reg} if unit == "weighted_apply" else {}

        def call(k, u, sto, pp):
            return [*u(r, pp, free, wts, s[k], st.blur, st.inv_h2, rho,
                       storage=sto, **extra), s[k][1:3]]

    return (lambda: call(0, units[0], storage, pb),
            lambda: call(1, units[1], storage, pb),
            lambda: call(2, units[0], "exact", p),
            lambda got, ref: robust_pairs(got, ref, storage))


def run_compact_robust_phases(device, card):
    """Phases 29-31: the robust and Tikhonov compact storage (K10b.1-3,
    5). Returns the ``kernels`` records of their storage-typed units."""
    import scipy.ndimage as ndi
    import torch

    from nsol_tpu_torch import data, interop, policy
    from nsol_tpu_torch.cli import run_deconvolution
    from nsol_tpu_torch.io import DataReader, read_nifti, write_nifti
    from nsol_tpu_torch.ops import conv as C
    from nsol_tpu_torch.ops import kernels as K
    from nsol_tpu_torch.ops import losses
    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import fused as F
    from nsol_tpu_torch.ops.cuda import robust as R
    from nsol_tpu_torch.ops.cuda import tikhonov as Tk
    from nsol_tpu_torch.solvers.wrappers import (ADMMLinearSolver,
                                                 TikhonovLinearSolver)

    # phase 29: the units against their plain versions on tile-edge shapes
    rng = np.random.RandomState(29)
    for label, cov, sp, shape in EDGE_CASES + (
            ("image", np.diag([1.0] * 3), None, (1, 40, 33)),):
        st = B.Stencils.from_cov(cov, 3, sp, device)
        worst = compact_pairs_err(robust_compact_pairs(st, shape, device,
                                                       rng))
        print("phase 29 robust storage units %s %s: f32 outputs and dots "
              "within %.2e of plain, bf16 ones within %g ulp"
              % (label, "x".join(map(str, shape)), worst, BF16_ULPS))
    # ... and at each main path's shape, timed beside the float32 instance
    times, err = {}, {}
    for name, u in ROBUST_COMPACT_UNITS.items():
        shape = ROBUST_COMPACT_SHAPES[u[3]]
        st = B.Stencils.from_cov(np.diag([SIGMA ** 2] * len(shape)), 3, None,
                                 device)
        kf, pf, tf, pair = robust_compact_call(st, shape, device, name)
        pairs = pair(kf(), pf())
        compact_pairs_err({name: pairs})
        err[name] = max(float((g.float() - f.float()).abs().max())
                        for g, f in pairs if tuple(g.shape) == shape)
        del pairs
        reps = 3 if shape == BIG else 10
        times[name] = (cuda_median_ms(kf, reps), cuda_median_ms(pf, 2),
                       cuda_median_ms(tf, reps))
        del kf, pf, tf, pair
        torch.cuda.empty_cache()
    print("phase 29 at each main path's shape: every output within its band "
          "of plain (max |d| %s)" % {k: "%.3g" % v for k, v in err.items()})
    print("phase 29 per call at each main path's shape (kernel / plain / "
          "float32-storage ms; bound ms): %s [%s]" % (", ".join(
              "%s %s %.4f/%.3f/%.4f, %.4f" % (
                  k, "x".join(map(str, ROBUST_COMPACT_SHAPES[u[3]])),
                  *times[k], compact_bound(k, ROBUST_COMPACT_SHAPES[u[3]])[0])
              for k, u in ROBUST_COMPACT_UNITS.items()), card))
    lap("phase 29")

    # phase 30: the compact robust solves against the exact ones, the
    # anchors and their plain versions
    launches, runs, plain_gates = {}, {}, {}

    def run(key, solve, b, objective):
        if b.numel() <= 64 ** 3:  # host-bound: warm the allocator first
            solve(b, b, ALPHA, RHO)
        torch.cuda.synchronize()
        F.reset_counts()
        x, ms = timed_once(lambda: solve(b, b, ALPHA, RHO))
        launches[key] = {k: v for k, v in F.launch_counts().items() if v}
        require(all(v == 0 for v in F.plain_counts().values()),
                "phase 30: %s ran a plain version: %s"
                % (key, F.plain_counts()))
        require(bool(torch.isfinite(x).all()) and x.shape == b.shape,
                "phase 30: %s not finite or misshapen" % key)
        runs[key] = (objective(x), ms)

    def held_to_plain(key, factory, kw, b, objective, storage, outer=2):
        plain_gates[key] = gaps = compact_plain_gaps(
            factory, kw, b, objective, outer, ROBUST_SHORT)
        require(compact_gaps_ok(gaps, kw, storage),
                "phase 30: %s kernel vs plain: at %d outer objective rel "
                "%.3g, voxel %.3g; RMS share of the gap to exact %s"
                % (key, outer, gaps[0], gaps[1], gaps[2]))

    def compared(key, exact_key, tol, what):
        rel = abs(runs[key][0] - runs[exact_key][0]) / runs[exact_key][0]
        require(rel <= tol, "phase 30: %s objective %.6f vs exact %.6f (rel "
                "%.3g > %g)" % (what, runs[key][0], runs[exact_key][0], rel,
                                tol))
        return rel

    # Lena 256² huber 10 × 3 × 6, the fused solve
    its, sweeps, cgi = ROBUST_ITERS["lena"]
    img, xs, _, _, _ = lena_problem()
    b = interop.to_torch((img / xs).astype(np.float32), device)
    cov2 = np.diag([SIGMA ** 2] * 2)
    A2, _ = C.make_blur_operators(cov2, alpha_cut=3, dtype=np.float64)

    def obj2(x):
        return robust_objective(x, b, A2, ALPHA)

    lena_f = partial(F.make_fused_admm_solver, b.shape, cov2, iter_max=sweeps,
                     data_loss="huber", irls_cg_iters=cgi)
    for key, kw in (("lena_dirs", FUSED_COMPACT), ("lena_exact", {})):
        run(key, lena_f(iterations=its, **kw), b, obj2)
    dev_lena = abs(runs["lena_dirs"][0] - LENA_ROBUST_ANCHOR) \
        / LENA_ROBUST_ANCHOR
    require(dev_lena <= ROBUST_ANCHOR_BAND, "phase 30: Lena compact objective"
            " %.6f deviates %.3g from %.6f" % (runs["lena_dirs"][0], dev_lena,
                                               LENA_ROBUST_ANCHOR))
    require(launches["lena_dirs"].get("weighted_apply") == its * sweeps * cgi,
            "phase 30: Lena compact launches %s" % launches["lena_dirs"])
    held_to_plain("lena_dirs", lena_f, FUSED_COMPACT, b, obj2, "dirs")
    # the 64³ phantom, σ = 1 wrap blur, the fused solve at Lena's depth
    iso = np.diag([SIGMA ** 2] * 3)
    vol = read_nifti(data.path("3D_SheppLoganPhantom_64.nii.gz"))
    kern = K.gaussian_kernel(iso, alpha_cut=3, spacing=np.ones(3))
    b64 = interop.to_torch(ndi.convolve(vol.data.astype(np.float64), kern,
                                        mode="wrap").astype(np.float32),
                           device)
    A64, _ = C.make_blur_operators(iso, alpha_cut=3, dtype=np.float64)

    def obj64(x):
        return robust_objective(x, b64, A64, ALPHA)

    cube_f = partial(F.make_fused_admm_solver, (64,) * 3, iso,
                     iter_max=sweeps, data_loss="huber", irls_cg_iters=cgi)
    for key, kw in (("cube_dirs", FUSED_COMPACT), ("cube_exact", {})):
        run(key, cube_f(iterations=its, **kw), b64, obj64)
    rel_cube = compared("cube_dirs", "cube_exact", SOLVE_OBJ_TOL, "64^3")
    held_to_plain("cube_dirs", cube_f, FUSED_COMPACT, b64, obj64, "dirs")
    del b64
    # the 256³ suite volume with outliers, 10 × 5 × 8, per-axis blocked
    its, sweeps, cgi = ROBUST_ITERS["scale"]
    bb, iso, A64 = scale_problem(device, True, SCALE_SHAPE)

    def obj256(x):
        return robust_objective(x, bb, A64, ALPHA)

    scale_f = partial(R.blocked_robust_admm_solve, SCALE_SHAPE, iso,
                      iter_max=sweeps, irls_cg_iters=cgi)
    for key, kw in (("scale_io", {"compact_dirs": True}), ("scale_exact", {})):
        solve = scale_f(iterations=its, **kw)
        require(not solve.tiled, "phase 30: 256^3 took the tiled units")
        run(key, solve, bb, obj256)
    dev_scale = abs(runs["scale_io"][0] - SCALE_ROBUST_ANCHOR) \
        / SCALE_ROBUST_ANCHOR
    require(dev_scale <= ANCHOR_BAND, "phase 30: 256^3 compact objective %.2f"
            " deviates %.4f%% from %.1f" % (runs["scale_io"][0],
                                            100 * dev_scale,
                                            SCALE_ROBUST_ANCHOR))
    require(launches["scale_io"].get("weighted_apply") == its * sweeps * cgi,
            "phase 30: 256^3 compact launches %s" % launches["scale_io"])
    rel_scale = compared("scale_io", "scale_exact", COMPACT_OBJ_TOL, "256^3")
    held_to_plain("scale_io", scale_f, {"compact_dirs": True}, bb, obj256,
                  "io")
    del bb
    torch.cuda.empty_cache()
    # 512³ huber 5 × 5 × 8, the tiled units
    its, sweeps, cgi = BIG_ROBUST_ITERS
    bb, iso, A64 = scale_problem(device, True)

    def obj512(x):
        return robust_objective(x, bb, A64, ALPHA)

    big_f = partial(R.blocked_robust_admm_solve, BIG, iso, iter_max=sweeps,
                    irls_cg_iters=cgi)
    for key, kw in (("big_io", {"compact_dirs": True}), ("big_exact", {})):
        solve = big_f(iterations=its, **kw)
        require(solve.tiled, "phase 30: 512^3 took the per-axis units")
        run(key, solve, bb, obj512)
    require(launches["big_io"].get("weighted_apply_zy") == its * sweeps * cgi
            and "weighted_apply" not in launches["big_io"],
            "phase 30: 512^3 compact launches %s" % launches["big_io"])
    rel_big = compared("big_io", "big_exact", COMPACT_OBJ_TOL, "512^3")
    held_to_plain("big_io", big_f, {"compact_dirs": True}, bb, obj512, "io",
                  outer=1)
    del bb
    torch.cuda.empty_cache()
    print("phase 30 robust compact solves (objective, ms a solve): %s; Lena "
          "dev from %.6f %.2e, 256^3 dev from %.1f %.4f%%; rel to exact: "
          "64^3 %.2e, 256^3 %.2e, 512^3 %.2e; kernel vs plain (objective/"
          "voxel at 2 outer, 1 at 512^3; RMS share of the gap to exact at "
          "1 x 1 x 2) %s; launches %s [%s]" % (
              {k: (round(v[0], 6), round(v[1], 2)) for k, v in runs.items()},
              LENA_ROBUST_ANCHOR, dev_lena, SCALE_ROBUST_ANCHOR,
              100 * dev_scale, rel_cube, rel_scale, rel_big,
              {k: "/".join("-" if g is None else "%.2e" % g for g in v)
               for k, v in plain_gates.items()},
              {k: v for k, v in launches.items() if not k.endswith("exact")},
              card))
    lap("phase 30")

    # phase 31: run_deconvolution --data-loss huber at its defaults on the
    # card is the policy's library solve, bit for bit (compact), and with
    # NSOL_TPU_EXACT=1 the exact one
    cli = {}
    with tempfile.TemporaryDirectory() as tmp:
        vol_path = os.path.join(tmp, "b.nii")
        b256, _, _ = scale_problem(device, True, SCALE_SHAPE)
        write_nifti(interop_numpy(b256), vol_path, spacing=np.ones(3))
        del b256
        for obs, (its, sweeps, cgi) in (
                (data.path("2D_Lena_256_blur_noise.png"),
                 ROBUST_ITERS["lena"]),
                (vol_path, ROBUST_ITERS["scale"])):
            reader = DataReader(obs)
            reader.read_data()
            nda = reader.get_data()
            x_scale = np.max(nda)
            bs = torch.as_tensor(nda / x_scale, dtype=torch.float32,
                                 device=device)
            nd = nda.ndim
            cov = np.diag([SIGMA ** 2] * nd)
            unit = "weighted_apply"
            recons = {}
            for env in ({}, {"NSOL_TPU_EXACT": "1"}):
                out = os.path.join(tmp, "x.mat")
                with environ(**env):
                    build, kw = policy.tvl2_solver(
                        nda.shape, cov, np.ones(nd), "cuda", its, sweeps,
                        "huber", cgi)
                    F.reset_counts()
                    rc = run_deconvolution.main([
                        "--observation", obs, "--result", out, "--solver",
                        "ADMM", "--reconstruction-type", "TVL2",
                        "--data-loss", "huber", "--alpha", str(ALPHA),
                        "--blur", str(SIGMA), "--iterations", str(its),
                        "--iter-max", str(sweeps), "--irls-cg-iters",
                        str(cgi), "--device", "cuda"])
                    counts = F.launch_counts()
                key = "%s %s" % ("x".join(map(str, nda.shape)),
                                 ",".join(env) or "default")
                storage = {k: v for k, v in kw.items()
                           if k in ("precision", "compact_dirs")}
                want = {} if env else (FUSED_COMPACT if nd == 2
                                       else {"compact_dirs": True})
                require(rc == 0 and storage == want and counts[unit] > 0
                        and all(n == 0 for n in F.plain_counts().values()),
                        "phase 31: CLI %s: rc %r, options %s, launches %s"
                        % (key, rc, storage, counts))
                reader = DataReader(out)
                reader.read_data()
                recon = reader.get_data()
                lib = interop.to_numpy(build(**kw)(bs, bs, ALPHA, RHO))
                lib = lib.astype(np.float64) * x_scale
                require(np.array_equal(recon, lib), "phase 31: CLI %s is not "
                        "the library solve (max |d| %.3g)"
                        % (key, float(np.max(np.abs(recon - lib)))))
                recons[key] = recon
                cli[key] = "%s, %d %s" % (build.__name__, counts[unit], unit)
            a, e = recons.values()
            cli["%s compact vs exact" % "x".join(map(str, nda.shape))] = \
                "%.2e" % float(np.max(np.abs(a - e)) / np.max(np.abs(e)))
    print("phase 31 CLI run_deconvolution --data-loss huber equals the "
          "policy's library solve bit for bit: %s" % cli)

    # ... and the study sweeps: the Lena TK1L2/TK0L2 (64 α) and TK0L2
    # huber (8 α) sweeps and the TV-L2 ADMM huber study (4 α × 2 ρ) run the
    # compact library solves
    img, xs, A, D, Dt = lena_problem()
    b = torch.as_tensor(img / xs, dtype=torch.float32, device=device)
    bt = torch.as_tensor(img, dtype=torch.float64, device=device)
    cov = np.eye(2)
    regs = {"TK1": (D, Dt), "TK0": (lambda x: x, lambda x: x)}
    sweep_launches, sweep_dev, sweep_ms = {}, {}, {}
    for reg, loss in (("TK1", "linear"), ("TK0", "linear"), ("TK0", "huber")):
        B_, Bt_ = regs[reg]
        robust = loss != "linear"
        alphas = TK_ALPHAS[::HUBER_STEP] if robust else TK_ALPHAS
        iter_max = HUBER_SWEEPS if robust else TK_ITER_MAX
        solver = TikhonovLinearSolver(
            A, A, img, B_, Bt_, img, x_scale=xs, data_loss=loss,
            data_loss_scale=HUBER_SCALE, minimizer="auto", iter_max=iter_max,
            irls_cg_iters=HUBER_CG, blur_cov=cov, spacing=np.ones(2),
            reg_kind=reg, device=device)
        measures = {
            "Reg": lambda x, B_=B_: 0.5 * torch.sum(B_(x) * B_(x)),
            "Data": lambda x, loss=loss: losses.cost_from_residual(
                A(x) - bt.to(x.dtype), loss, HUBER_SCALE)}
        key = "%sL2 %s" % (reg, loss)
        torch.cuda.synchronize()
        F.reset_counts()
        x_all, recs = solver.run_sweep({"alpha": alphas.astype(np.float64)},
                                       measures=measures)
        torch.cuda.synchronize()
        sweep_launches[key] = {k: v for k, v in F.launch_counts().items()
                               if v}
        require(all(n == 0 for n in F.plain_counts().values()),
                "phase 31: %s sweep ran a plain version" % key)
        a_list = [float(a) for a in alphas]
        kw = dict(reg=reg, iter_max=iter_max, data_loss=loss,
                  irls_cg_iters=HUBER_CG)
        solves = [partial(Tk.make_fused_tikhonov_solver(b.shape, cov, **kw,
                                                        **opt),
                          b, b, a_list, HUBER_SCALE)
                  for opt in (FUSED_COMPACT, {})]
        lib, exact = (f() for f in solves)
        sweep_ms[key] = [cuda_median_ms(f, 5) for f in solves]
        xk = torch.as_tensor(x_all / xs, dtype=torch.float32, device=device)
        dev = max_rel(xk, lib)
        rec_dev = 0.0
        for j in range(len(alphas)):
            for row, x in ((0, bt), (1, lib[j].double() * xs)):
                for name, fn in measures.items():
                    ref = float(fn(x))
                    rec_dev = max(rec_dev, abs(recs[name][j, row] - ref)
                                  / abs(ref))
        gap = max_rel(lib, exact)
        require(dev <= KERNEL_TOL and rec_dev <= RECORD_TOL and gap > 0,
                "phase 31: %s sweep vs the compact library solves %.3g, "
                "records %.3g, compact vs exact %.3g" % (key, dev, rec_dev,
                                                         gap))
        sweep_dev[key] = "x %.2e, records %.2e, compact vs exact %.2e" % (
            dev, rec_dev, gap)
        del lib, exact, xk, solves
    its, sweeps, cgi = ROBUST_ITERS["lena"]
    solver = ADMMLinearSolver(
        A, A, img, D, Dt, img, x_scale=xs, data_loss="huber",
        data_loss_scale=HUBER_SCALE, minimizer="auto", iterations=its,
        iter_max=sweeps, irls_cg_iters=cgi, blur_cov=cov, spacing=np.ones(2),
        device=device)
    measures = {
        "Reg": lambda x: torch.sum(torch.sqrt(torch.sum(D(x) ** 2, 0))),
        "Data": lambda x: losses.cost_from_residual(
            A(x) - bt.to(x.dtype), "huber", HUBER_SCALE)}
    grid = [(float(a), r) for a in TV_ALPHAS[::2] for r in TV_RHOS]
    torch.cuda.synchronize()
    F.reset_counts()
    x_all, recs = solver.run_sweep(
        {"alpha": np.array([g[0] for g in grid]),
         "rho": np.array([g[1] for g in grid])}, measures=measures)
    torch.cuda.synchronize()
    key = "TVL2 ADMM huber"
    sweep_launches[key] = {k: v for k, v in F.launch_counts().items() if v}
    require(all(n == 0 for n in F.plain_counts().values()),
            "phase 31: the ADMM huber study ran a plain version")
    lib, exact = (F.make_fused_admm_solver(b.shape, cov, iterations=its,
                                           iter_max=sweeps, data_loss="huber",
                                           irls_cg_iters=cgi, **opt)
                  for opt in (FUSED_COMPACT, {}))
    sweep_ms[key] = [cuda_median_ms(lambda s=s: s(b, b, ALPHA, RHO), 5)
                     for s in (lib, exact)]
    dev = rec_dev = 0.0
    for j, (a, rho) in enumerate(grid):
        xl = lib(b, b, a, rho, data_loss_scale=HUBER_SCALE)
        dev = max(dev, max_rel(torch.as_tensor(x_all[j] / xs,
                                               dtype=torch.float32,
                                               device=device), xl))
        for name, fn in measures.items():
            ref = float(fn(xl.double() * xs))
            rec_dev = max(rec_dev, abs(recs[name][j, -1] - ref) / abs(ref))
    require(dev <= KERNEL_TOL and rec_dev <= RECORD_TOL,
            "phase 31: %s vs the compact library solves %.3g, records %.3g"
            % (key, dev, rec_dev))
    sweep_dev[key] = "x %.2e, records %.2e" % (dev, rec_dev)
    print("phase 31 study sweeps in compact storage on the card, against "
          "the compact library solves: %s; launches %s; the fused solves "
          "(a Tikhonov batch, one ADMM configuration), compact / exact ms: "
          "%s [%s]" % (sweep_dev, sweep_launches,
                       {k: "%.3f/%.3f" % tuple(v) for k, v in
                        sweep_ms.items()}, card))
    lap("phase 31")

    path_launches = {
        "lena_dirs": launches["lena_dirs"], "scale_io": launches["scale_io"],
        "big_io": launches["big_io"],
        "tk0_linear": sweep_launches["TK0L2 linear"],
        "tk0_huber": sweep_launches["TK0L2 huber"]}
    out = []
    for name, (unit, tpu, source, path, _, _) in ROBUST_COMPACT_UNITS.items():
        b_ms, b_by = compact_bound(name, ROBUST_COMPACT_SHAPES[path])
        t = times[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": tpu,
                    "launches": int(path_launches[path].get(unit, 0)),
                    "max_abs_err": err[name], "ms": t[0], "plain_ms": t[1],
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        require(out[-1]["launches"] > 0, "phase 30/31: %s launched no time "
                "on its main path (%s)" % (name, path))
    return out


# -------------------------------------------------- phases 32-35 --

#: a compact PD solve against its reference: the bands of
#: tests/test_pallas.py:176-215 (voxel ≤ 2e-2 of max |x|; objective 5e-3
#: for the L2 types, 2e-2 for the L1 ones): the compact kernel against its
#: plain version, and the compact sweep at α[40] against the JAX package's
#: compact kernel, whose objective there (interpret mode, float32,
#: tests/torch_anchors.py ``man_compact_anchors``) is MAN_COMPACT_ANCHOR
PD_COMPACT_VOX = 2e-2
PD_COMPACT_OBJ = {"L2": 5e-3, "L1": 2e-2}
MAN_COMPACT_AT, MAN_COMPACT_ANCHOR = 40, 4550.981880361593
#: the bf16 state against the exact sweep on Man: a coarse bound. The
#: reference's own compact kernel is 9.0 % off the exact one at α[40]
#: (tests/torch_anchors.py); its 1.7 % account (benchmarks/
#: pd_compact_probe.py) measured warm-started chained sweeps
PD_COMPACT_VS_EXACT = 0.15
#: ``nsol_torch_run_deconvolution`` at its defaults (PD, 50 iterations,
#: α 0.01, --blur 1, --minimizer auto): the float64 objectives of the JAX
#: package's interface on the CPU (tests/torch_anchors.py ``pd_anchors``),
#: ½‖Ax − b‖² + α·TV (TVL2) or + α·½Σhuber(|∇x|², 0.05) (HuberL2) in
#: the scaled units
PD_DECONV_ANCHORS = {("lena", "TVL2"): 90.2655241580762,
                     ("lena", "HuberL2"): 70.51569722027165,
                     ("phantom", "TVL2"): 147.27126621475304}
PD_DECONV_BAND = 1e-4
#: the K10b.6 solve against the compact blocked robust solve (phase 30's
#: 512³ compact gate)
WINDOW_IO_TOL = 1e-3
#: the storage-typed units of the primal-dual surface: the entry's name in
#: the kernels line → (wrapper, TPU kernel it replaces, source)
PD_SURFACE_UNITS = {
    "pd_dual[bf16]": ("pd_dual", "nsol_tpu/ops/pallas/fused.py:957",
                      "nsol_tpu_torch/csrc/pd.cu"),
    "pd_primal[bf16]": ("pd_primal", "nsol_tpu/ops/pallas/fused.py:957",
                        "nsol_tpu_torch/csrc/pd.cu"),
    "pd_record[bf16]": ("pd_record", "nsol_tpu/ops/pallas/fused.py:957",
                        "nsol_tpu_torch/csrc/pd.cu"),
    "weighted_apply_prepadded[io]": (
        "weighted_apply_prepadded", "nsol_tpu/ops/pallas/robust.py:264",
        "nsol_tpu_torch/csrc/robust.cu"),
}


def pd_state_tensors(rng, nb, shape, device, dtype):
    """Random PD state ``(x, x̄, p)`` of a batch of ``nb`` images, stored as
    ``dtype``, and one float32 image ``b``."""
    import torch

    def rand(*shp, lo=0.0):
        return torch.as_tensor(rng.rand(*shp).astype(np.float32) + lo,
                               device=device)

    x, xm = rand(nb, *shape).to(dtype), rand(nb, *shape).to(dtype)
    p = rand(nb, len(shape), *shape, lo=-0.5).to(dtype)
    return x, xm, p, rand(*shape)


def pd_bf16_unit_pairs(F, interop, shape, device, rng, rtype, alg):
    """The three PD units on a bfloat16 state and their plain versions on
    the same inputs (3 alphas, anisotropic spacing): {unit: [(kernel out,
    plain out), ...]}."""
    import torch

    nd = len(shape)
    ell1, huber = rtype.endswith("L1"), rtype.startswith("Huber")
    inv_h = tuple(float(np.float32(1.0 / h)) for h in PD_SPACING[:nd])
    rows = [F._pd_schedules(a, PD_L2, 4, alg) for a in PD_UNIT_ALPHAS]
    sched = interop.pd_schedules(*(np.stack(c) for c in zip(*rows)), device)
    nb = len(PD_UNIT_ALPHAS)
    x, xm, p, b = pd_state_tensors(rng, nb, shape, device, torch.bfloat16)
    out = {}
    pk, pp = p.clone(), p.clone()
    F.pd_dual(xm, pk, sched, 2, inv_h, huber)
    F.pd_dual_plain(xm, pp, sched, 2, inv_h, huber)
    out["pd_dual[bf16]"] = [(pk, pp)]
    xk, mk, xp, mp = x.clone(), xm.clone(), x.clone(), xm.clone()
    F.pd_primal(xk, mk, p, b, sched, 1, inv_h, ell1)
    F.pd_primal_plain(xp, mp, p, b, sched, 1, inv_h, ell1)
    out["pd_primal[bf16]"] = [(xk, xp), (mk, mp)]
    rk = [torch.zeros(nb, 5, dtype=torch.float64, device=device)
          for _ in range(4)]
    F.pd_record(x, b, rk[0], rk[1], 3, inv_h, ell1, huber, 0.1)
    F.pd_record_plain(x, b, rk[2], rk[3], 3, inv_h, ell1, huber, 0.1)
    out["pd_record[bf16]"] = [(rk[0], rk[2]), (rk[1], rk[3])]
    return out


def pd_state_times(F, interop, shape, nb, device, reps):
    """{unit: (bf16 kernel ms, bf16 plain ms, float32 kernel ms)} per call
    of each PD unit on a batch of ``nb`` images of ``shape`` (TVL2 ALG2),
    the two storages timed in turns in one run."""
    import torch

    rng = np.random.RandomState(32)
    nd = len(shape)
    inv_h = (1.0,) * nd
    alphas = np.linspace(0.01, 1.5, nb, dtype=np.float32)
    rows = [F._pd_schedules(a, PD_L2, ITERATIONS, "ALG2") for a in alphas]
    sched = interop.pd_schedules(*(np.stack(c) for c in zip(*rows)), device)
    reg = torch.zeros(nb, ITERATIONS + 1, dtype=torch.float64, device=device)
    data = torch.zeros_like(reg)
    states = {k: pd_state_tensors(rng, nb, shape, device, dt) for k, dt in
              (("bf16", torch.bfloat16), ("f32", torch.float32))}

    def calls(k, plain=False):
        x, xm, p, b = states[k]
        dual = F.pd_dual_plain if plain else F.pd_dual
        primal = F.pd_primal_plain if plain else F.pd_primal
        rec = F.pd_record_plain if plain else F.pd_record
        return {"pd_dual": lambda: dual(xm, p, sched, 1, inv_h),
                "pd_primal": lambda: primal(x, xm, p, b, sched, 1, inv_h),
                "pd_record": lambda: rec(x, b, reg, data, 1, inv_h)}

    out = {}
    for unit in ("pd_dual", "pd_primal", "pd_record"):
        bf, f32 = calls("bf16")[unit], calls("f32")[unit]
        ms = [cuda_median_ms(f, reps) for f in (f32, bf, bf, f32)]
        out[unit + "[bf16]"] = (0.5 * (ms[1] + ms[2]),
                                cuda_median_ms(calls("bf16", True)[unit], 2),
                                0.5 * (ms[0] + ms[3]))
    return out


def pd_surface_bound(name, n, nd=3, batch=1, taps=(7, 7, 7), reads=1.0,
                     ext=1.0):
    """``(bound_ms, bound_by)`` of one call of a PD_SURFACE_UNITS entry on
    ``n`` voxels (× ``batch`` images): 2 bytes a voxel of the bfloat16
    state, 4 of the float32 ``b`` (read once for the batch); the io window
    apply reads ``reads`` bf16 volumes of ``n`` voxels and writes one
    (:func:`unit_bound`'s operation counts)."""
    if name == "weighted_apply_prepadded[io]":
        return bound(2.0 * n * (reads + 1),
                     float(n) * (2 * 2 * sum(taps) * ext + 25))
    bpv = {"pd_dual[bf16]": (2 + 4 * nd) * batch,
           "pd_primal[bf16]": (2 * nd + 6) * batch + 4,
           "pd_record[bf16]": 2 * batch + 4}[name]
    ops = {"pd_dual[bf16]": 12 * nd, "pd_primal[bf16]": 10 + 3 * nd,
           "pd_record[bf16]": 10 + 3 * nd}[name]
    return bound(float(n) * bpv, float(n) * ops * batch)


def run_pd_surface_phases(device, card):
    """Phases 32-35: the primal-dual surface — the PD solve's bf16 state
    (K10b.4) and the window apply's bf16 io (K10b.6) against their plain
    versions, the Man 1024² × 64 α study exact and compact, run_denoising's
    routes, the PD deconvolution CLIs at their defaults and the K10b.6
    512³ solve. Returns the ``kernels`` records of the four instances."""
    import scipy.ndimage as ndi
    import torch

    from nsol_tpu_torch import data, interop
    from nsol_tpu_torch.cli import (run_deconvolution,
                                    run_deconvolution_study, run_denoising,
                                    run_denoising_study)
    from nsol_tpu_torch.cli.run_denoising import denoising_proxes
    from nsol_tpu_torch.io import DataReader, read_nifti, read_png, \
        write_nifti
    from nsol_tpu_torch.observer import Observer
    from nsol_tpu_torch.ops import conv as C
    from nsol_tpu_torch.ops import grad as G
    from nsol_tpu_torch.ops import kernels as K
    from nsol_tpu_torch.ops import measures as sim
    from nsol_tpu_torch.ops import priors
    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import fused as F
    from nsol_tpu_torch.ops.cuda import robust as R
    from nsol_tpu_torch.parallel import blocked_halo, halo, matmul_halo
    from nsol_tpu_torch.parallel import distributed as dist
    from nsol_tpu_torch.parallel import make_space_mesh
    from nsol_tpu_torch.solvers.admm import admm_solve
    from nsol_tpu_torch.solvers.wrappers import PrimalDualSolver
    from nsol_tpu_torch.study import (PrimalDualSolverParameterStudy,
                                      ReaderParameterStudy)

    bf = torch.bfloat16
    err, times = {}, {}

    # phase 32: the bf16-state PD units against their plain versions, all
    # 4 types x 3 schedules, 2-D and 3-D tile-edge shapes and 1024² ...
    rng = np.random.RandomState(32)
    for shape in ((37, 53), (1024, 1024), (37, 45, 53), (5, 40, 33)):
        for rtype in PD_TYPES:
            for alg in PD_ALGS:
                pairs = pd_bf16_unit_pairs(F, interop, shape, device, rng,
                                           rtype, alg)
                compact_pairs_err(pairs)
                if shape == (1024, 1024):
                    for k, outs in pairs.items():
                        err[k] = max([err.get(k, 0.0)] + [
                            float((g.double() - r.double()).abs().max())
                            for g, r in outs])
        print("phase 32 PD units on a bf16 state %s (12 type x schedule "
              "pairs, B=3, anisotropic): bf16 outputs within %g ulp of "
              "plain, records within %g" % ("x".join(map(str, shape)),
                                            BF16_ULPS, KERNEL_TOL))
    # ... the io window apply on the tile-edge shapes as slabs (row0 on the
    # first, a middle and the last of 3) ...
    for label, cov, sp, shape in EDGE_CASES + (
            ("image", np.diag([1.0] * 3), None, (1, 40, 33)),):
        st = B.Stencils.from_cov(cov, 3, sp, device)
        h = R.weighted_halo(st.blur)
        ext = (shape[0] + 2 * h,) + shape[1:]
        v = torch.as_tensor(rng.rand(*ext).astype(np.float32),
                            device=device).to(bf)
        w = torch.as_tensor(rng.rand(*ext).astype(np.float32) + 0.1,
                            device=device).to(bf)
        pairs = []
        for row0 in (0, shape[0], 2 * shape[0]):
            args = (v, w, st.blur, st.inv_h2, RHO, row0, 3 * shape[0])
            pairs.append((R.weighted_apply_prepadded(*args),
                          R.weighted_apply_prepadded_plain(*args)))
        compact_pairs_err({"weighted_apply_prepadded[io] " + label: pairs})
    # ... 4 slabs of one 256³ volume against the whole-volume io apply
    st = B.Stencils.from_cov(np.diag([SIGMA ** 2] * 3), 3, None, device)
    h = R.weighted_halo(st.blur)
    v = torch.as_tensor(rng.rand(*SLAB_SHAPE).astype(np.float32),
                        device=device).to(bf)
    w = torch.as_tensor(rng.rand(*SLAB_SHAPE).astype(np.float32) + 0.1,
                        device=device).to(bf)
    zl = SLAB_SHAPE[0] // SLABS
    slabs = torch.cat([R.weighted_apply_prepadded(
        wrap_slab(v, k * zl, zl, h), wrap_slab(w, k * zl, zl, h), st.blur,
        st.inv_h2, RHO, k * zl, SLAB_SHAPE[0]) for k in range(SLABS)])
    whole = R.weighted_apply(v.float(), None, None, w.float(),
                             B.new_scalars(device), st.blur, st.inv_h2, RHO,
                             first=True, storage="io")[1].to(bf)
    torch.cuda.synchronize()
    slab_ulps = bf16_ulp_err(slabs, whole)
    require(slab_ulps <= 1.0, "phase 32: %d io slabs of 256^3 vs the "
            "whole-volume weighted_apply[io]: %.2f of the band"
            % (SLABS, slab_ulps))
    del v, w, slabs, whole
    print("phase 32 io window apply: the tile-edge slabs within %g ulp of "
          "plain; %d slabs of 256^3 assembled vs weighted_apply[io] %.2f of "
          "the band" % (BF16_ULPS, SLABS, slab_ulps))
    # each instance timed beside its float32 instance: the PD units at the
    # sweep's 64 x 1024², the window apply at 512³ (one rank)
    times.update(pd_state_times(F, interop, (1024, 1024), 64, device,
                                reps=20))
    ext = (BIG[0] + 2 * h,) + BIG[1:]
    v32 = torch.as_tensor(rng.rand(*ext).astype(np.float32), device=device)
    w32 = v32 * 0.9 + 0.1
    vb, wb = v32.to(bf), w32.to(bf)
    win = {k: (lambda a=a: R.weighted_apply_prepadded(
        *a, st.blur, st.inv_h2, RHO, 0, BIG[0]))
        for k, a in (("io", (vb, wb)), ("f32", (v32, w32)))}
    got = win["io"]()
    ref = R.weighted_apply_prepadded_plain(vb, wb, st.blur, st.inv_h2, RHO,
                                           0, BIG[0])
    compact_pairs_err({"weighted_apply_prepadded[io] 512^3": [(got, ref)]})
    err["weighted_apply_prepadded[io]"] = float(
        (got.float() - ref.float()).abs().max())
    del got, ref
    ms = [cuda_median_ms(win[k], 5) for k in ("f32", "io", "io", "f32")]
    times["weighted_apply_prepadded[io]"] = (
        0.5 * (ms[1] + ms[2]),
        cuda_median_ms(lambda: R.weighted_apply_prepadded_plain(
            vb, wb, st.blur, st.inv_h2, RHO, 0, BIG[0]), 2),
        0.5 * (ms[0] + ms[3]))
    win_reads = window_reads(B, R, "weighted_apply_prepadded", st, BIG[0])
    win_ext = ext[0] / BIG[0]
    del v32, w32, vb, wb, win
    torch.cuda.empty_cache()
    print("phase 32 per call (bf16 kernel / bf16 plain / float32 kernel ms, "
          "bound ms): %s [%s]" % (", ".join(
              "%s %.4f/%.3f/%.4f, %.4f" % (
                  k, *t, pd_surface_bound(
                      k, BIG_N if k.startswith("weighted") else 1024 ** 2,
                      nd=2, batch=64, reads=win_reads, ext=win_ext)[0])
              for k, t in times.items()), card))
    lap("phase 32")

    # phase 33: the Man 1024² x 64 α L-curve study (BASELINE config 4)
    # through PrimalDualSolverParameterStudy and the study CLI, exact and
    # under NSOL_TPU_COMPACT=1
    man_path = data.path("2D_Man_1024.png")
    man = read_png(man_path).astype(np.float64)
    s = float(man.max())
    alphas = np.linspace(0.01, 1.5, 64, dtype=np.float32)
    D, Dt = G.make_gradient_operators()
    b_full = torch.as_tensor(man, dtype=torch.float32, device=device)
    bm = interop.to_torch((man / s).astype(np.float32), device)

    def tensor(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    measures = {"Reg": lambda x: priors.total_variation(tensor(x), D),
                "Data": lambda x: sim.sum_of_squared_differences(tensor(x),
                                                                 b_full)}

    def man_solver():
        prox_f, prox_g = denoising_proxes("TVL2", bm)
        solver = PrimalDualSolver(
            prox_f, prox_g, D, Dt, L2=PD_L2, x0=man, iterations=ITERATIONS,
            x_scale=s, reconstruction_type="TVL2", observation=man / s,
            device=device)
        observer = Observer()
        observer.set_measures(measures)
        solver.set_observer(observer)
        return solver, observer

    def read_records(directory, name):
        reader = ReaderParameterStudy(directory=directory, name=name)
        reader.read_study()
        return {k: reader.get_results(k) for k in ("Reg", "Data")}

    def objectives(recs):
        """Data + α·Reg of each α's last iterate, in the scaled units."""
        return recs["Data"][:, -1] / s ** 2 + alphas * recs["Reg"][:, -1] / s

    study_recs, sweep_x, sweep_s, lib_ms, launches = {}, {}, {}, {}, {}
    cli_dev = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode, env in (("exact", {}), ("compact", {"NSOL_TPU_COMPACT": "1"})):
            with environ(**env):
                solver, observer = man_solver()
                study = PrimalDualSolverParameterStudy(
                    solver, observer, dir_output=os.path.join(tmp, mode),
                    name="man", parameters={"alpha": alphas})
                torch.cuda.synchronize()
                F.reset_counts()
                study.run()
                torch.cuda.synchronize()
                launches[mode] = F.launch_counts(F.PD_UNITS)
                require(all(n > 0 for n in launches[mode].values())
                        and all(n == 0 for n in F.plain_counts().values()),
                        "phase 33: %s study launches %s, plain calls %s"
                        % (mode, launches[mode], F.plain_counts()))
                study_recs[mode] = read_records(os.path.join(tmp, mode),
                                                "man")
                # the study's sweep again, for its x and its time
                t0 = time.perf_counter()
                x_all, recs = solver.run_sweep(
                    {"alpha": alphas.astype(np.float64)}, measures=measures)
                sweep_s[mode] = time.perf_counter() - t0
                sweep_x[mode] = x_all / s
                rel = max(max_rel(torch.as_tensor(recs[k]),
                                  torch.as_tensor(study_recs[mode][k]))
                          for k in recs)
                require(rel <= RECORD_TOL, "phase 33: %s run_sweep records vs "
                        "the study's files %.3g" % (mode, rel))
                # the library solve the sweep runs, and its device time
                lib = F.make_fused_pd_denoise_solver(
                    bm.shape, "TVL2", "ALG2", ITERATIONS, record=True,
                    compact=mode == "compact")
                _, lrec = lib(bm, bm, alphas, PD_L2)
                for k, scale in (("Reg", s), ("Data", s * s)):
                    rel = max_rel(torch.as_tensor(study_recs[mode][k]),
                                  lrec[k].double().cpu() * scale)
                    require(rel <= KERNEL_TOL, "phase 33: %s study %s vs "
                            "the library solve %.3g" % (mode, k, rel))
                lib_ms[mode] = cuda_ms(lambda: lib(bm, bm, alphas, PD_L2),
                                       reps=3)
                del lib, lrec, x_all, recs
                # the study CLI on the PNG: the same records
                out = os.path.join(tmp, "cli_" + mode)
                F.reset_counts()
                rc = run_denoising_study.main([
                    "--observation", man_path, "--dir-output", out,
                    "--study-name", "man", "--iterations", str(ITERATIONS),
                    "--alpha-range", "0.01", "1.5", "64"])
                cli = F.launch_counts(F.PD_UNITS)
                require(rc == 0 and all(n > 0 for n in cli.values())
                        and all(n == 0 for n in F.plain_counts().values()),
                        "phase 33: %s study CLI rc %r, launches %s"
                        % (mode, rc, cli))
                cli_recs = read_records(out, "man")
                cli_dev[mode] = max(max_rel(
                    torch.as_tensor(cli_recs[k]),
                    torch.as_tensor(study_recs[mode][k])) for k in cli_recs)
                require(cli_dev[mode] <= RECORD_TOL, "phase 33: %s study CLI "
                        "records vs the library study %.3g"
                        % (mode, cli_dev[mode]))
    obj = {m: objectives(r) for m, r in study_recs.items()}
    anchor_dev = {i: abs(obj["exact"][i] - a) / a
                  for i, a in MAN_ANCHORS.items()}
    require(max(anchor_dev.values()) <= PD_ANCHOR_BAND, "phase 33: exact "
            "study objectives %s vs anchors %s" % (
                {i: obj["exact"][i] for i in MAN_ANCHORS}, MAN_ANCHORS))
    # the compact kernel against its plain version (bf16 flips propagate:
    # the compact bands) and, at α[40], against the JAX package's kernel
    lib = F.make_fused_pd_denoise_solver(bm.shape, "TVL2", "ALG2",
                                         ITERATIONS, record=True,
                                         compact=True)
    x_pl, r_pl = lib.plain(bm, bm, alphas, PD_L2)
    r_pl = {k: r_pl[k].double().cpu().numpy() * sc
            for k, sc in (("Reg", s), ("Data", s * s))}
    plain_obj = np.abs(objectives(r_pl) - obj["compact"]) \
        / np.abs(obj["compact"])
    plain_vox = float(np.max(np.abs(interop.to_numpy(x_pl)
                                    - sweep_x["compact"]))
                      / np.max(np.abs(sweep_x["compact"])))
    del lib, x_pl
    anchor_c = abs(obj["compact"][MAN_COMPACT_AT] - MAN_COMPACT_ANCHOR) \
        / MAN_COMPACT_ANCHOR
    require(plain_vox <= PD_COMPACT_VOX
            and plain_obj.max() <= PD_COMPACT_OBJ["L2"]
            and anchor_c <= PD_COMPACT_OBJ["L2"], "phase 33: the compact "
            "sweep vs its plain version voxel %.3g, objective %.3g; at "
            "alpha[%d] %.4f vs the JAX package's compact kernel %.4f"
            % (plain_vox, plain_obj.max(), MAN_COMPACT_AT,
               obj["compact"][MAN_COMPACT_AT], MAN_COMPACT_ANCHOR))
    obj_dev = np.abs(obj["compact"] - obj["exact"]) / np.abs(obj["exact"])
    worst = int(np.argmax(obj_dev))
    vox = float(np.max(np.abs(sweep_x["compact"] - sweep_x["exact"]))
                / np.max(np.abs(sweep_x["exact"])))
    require(vox <= PD_COMPACT_VOX and obj_dev[worst] <= PD_COMPACT_VS_EXACT,
            "phase 33: compact vs exact voxel %.3g, objective %.3g at "
            "alpha %.4f" % (vox, obj_dev[worst], alphas[worst]))
    del sweep_x
    print("phase 33 Man 1024^2 x 64 alphas TVL2/ALG2 %d, Reg/Data records: "
          "exact study objectives at %s dev from the anchors %s; compact "
          "sweep vs its plain version objective %.2e, voxel %.2e, at "
          "alpha[%d] %.4f vs the JAX package's compact kernel %.4f (rel "
          "%.2e); compact vs exact: largest objective deviation %.3e at "
          "alpha %.4f (%.3e at alpha[%d]), voxel %.3e; study CLI records vs "
          "the library study %s; run_sweep %.3f s exact, %.3f s compact "
          "(copies to the host included); the fused sweep on the card "
          "%.1f ms exact, %.1f ms compact; launches exact %s, compact %s "
          "[%s]" % (
              ITERATIONS, sorted(MAN_ANCHORS),
              {i: "%.1e" % d for i, d in anchor_dev.items()},
              plain_obj.max(), plain_vox, MAN_COMPACT_AT,
              obj["compact"][MAN_COMPACT_AT], MAN_COMPACT_ANCHOR, anchor_c,
              obj_dev[worst], alphas[worst], obj_dev[MAN_COMPACT_AT],
              MAN_COMPACT_AT, vox,
              {k: "%.1e" % v for k, v in cli_dev.items()},
              sweep_s["exact"], sweep_s["compact"], lib_ms["exact"],
              lib_ms["compact"], launches["exact"], launches["compact"],
              card))
    lap("phase 33")

    # phase 34: run_denoising's routes on the card
    lena_path = data.path("2D_Lena_256_noise.png")
    res34 = {}
    with tempfile.TemporaryDirectory() as tmp:
        def cli_recon(obs, *extra, env=None):
            out = os.path.join(tmp, "x.mat")
            with environ(**(env or {})):
                F.reset_counts()
                rc = run_denoising.main(["--observation", obs, "--result",
                                         out, *extra])
                counts = F.launch_counts(F.PD_UNITS)
            reader = DataReader(out)
            reader.read_data()
            recon = reader.get_data()
            require(rc == 0 and np.all(np.isfinite(recon)),
                    "phase 34: run_denoising %s rc %r" % (extra, rc))
            return recon, counts

        def library(obs, compact):
            reader = DataReader(obs)
            reader.read_data()
            nda = reader.get_data()
            xs = np.max(nda)
            bt = torch.as_tensor(nda / xs, dtype=torch.float32, device=device)
            x = F.make_fused_pd_denoise_solver(
                nda.shape, "TVL2", "ALG2", ITERATIONS, compact=compact)(
                    bt, bt, PD_ALPHA, PD_L2)
            return interop.to_numpy(x).astype(np.float64) * xs, nda

        recon, counts = cli_recon(lena_path, env={"NSOL_TPU_COMPACT": "1"})
        lib, nda = library(lena_path, True)
        exact, _ = library(lena_path, False)
        require(np.array_equal(recon, lib) and not np.array_equal(recon,
                                                                  exact)
                and counts["pd_dual"] > 0, "phase 34: Lena under "
                "NSOL_TPU_COMPACT=1 is not the compact library solve")
        res34["Lena 256^2 NSOL_TPU_COMPACT=1"] = "compact library solve bit " \
            "for bit (vs exact %.1e)" % float(np.max(np.abs(recon - exact))
                                              / np.max(np.abs(exact)))
        # the 256³ volume of phase 10b: past the fused kernel's fit the
        # compact switch leaves the solve exact (the policy on the card)
        phantom = read_nifti(data.path("3D_SheppLoganPhantom_64.nii.gz")) \
            .data.astype(np.float64)
        big = np.repeat(np.repeat(np.repeat(phantom, 4, 0), 4, 1), 4, 2)
        big = big + np.random.RandomState(1).normal(0, 0.05 * phantom.max(),
                                                    big.shape)
        nii = os.path.join(tmp, "big.nii")
        write_nifti(big.astype(np.float32), nii, spacing=np.ones(3))
        del big
        recon, counts = cli_recon(nii, env={"NSOL_TPU_COMPACT": "1"})
        lib, _ = library(nii, False)
        require(np.array_equal(recon, lib) and counts["pd_dual"] > 0,
                "phase 34: 256^3 under NSOL_TPU_COMPACT=1 is not the exact "
                "library solve")
        res34["256^3 NSOL_TPU_COMPACT=1"] = "exact library solve bit for bit"
        del recon, lib
        # --solver ADMM and --reference (the generic PD solve) on Lena
        ref_path = data.path("2D_Lena_256.png")
        ref = read_png(ref_path).astype(np.float64)
        recon, _ = cli_recon(lena_path, "--solver", "ADMM")
        psnr = {k: float(sim.peak_signal_to_noise_ratio(
            torch.as_tensor(v), torch.as_tensor(ref)))
            for k, v in (("observed", nda), ("ADMM", recon))}
        recon, counts = cli_recon(lena_path, "--reference", ref_path,
                                  "--measures", "PSNR")
        exact, _ = library(lena_path, False)
        gen = float(np.max(np.abs(recon - exact)) / np.max(np.abs(exact)))
        require(gen <= KERNEL_TOL and psnr["ADMM"] > psnr["observed"]
                and sum(counts.values()) == 0, "phase 34: --reference "
                "generic vs fused %.3g, PSNR %s, launches %s"
                % (gen, psnr, counts))
        res34["--solver ADMM"] = "PSNR %.2f dB (observation %.2f dB)" % (
            psnr["ADMM"], psnr["observed"])
        res34["--reference PSNR"] = "generic primal_dual_solve vs the fused " \
            "solve %.1e" % gen
    print("phase 34 run_denoising on the card: %s [%s]" % (res34, card))
    lap("phase 34")

    # phase 35: the deconvolution CLIs at their default --solver PD, and
    # the K10b.6 solve
    res35, ms35 = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        vol = read_nifti(data.path("3D_SheppLoganPhantom_64.nii.gz")).data
        kern = K.gaussian_kernel(np.eye(3), alpha_cut=3, spacing=np.ones(3))
        cube = ndi.convolve(vol.astype(np.float64), kern, mode="wrap").astype(
            np.float32)
        cube_path = os.path.join(tmp, "cube.nii")
        write_nifti(cube, cube_path, spacing=np.ones(3))
        obs_of = {"lena": data.path("2D_Lena_256_blur_noise.png"),
                  "phantom": cube_path}
        for (name, rtype), anchor in PD_DECONV_ANCHORS.items():
            out = os.path.join(tmp, "x.mat")
            F.reset_counts()
            t0 = time.perf_counter()
            rc = run_deconvolution.main([
                "--observation", obs_of[name], "--result", out,
                "--reconstruction-type", rtype])
            ms35[(name, rtype)] = 1e3 * (time.perf_counter() - t0)
            counts = {k: v for k, v in F.launch_counts().items() if v}
            reader = DataReader(out)
            reader.read_data()
            x = reader.get_data()
            reader = DataReader(obs_of[name])
            reader.read_data()
            b = reader.get_data()
            xs = float(np.max(b))
            A64, _ = C.make_blur_operators(np.eye(b.ndim), alpha_cut=3,
                                           dtype=np.float64)
            xt = torch.as_tensor(x / xs, device=device)
            bt = torch.as_tensor(b / xs, dtype=torch.float64, device=device)
            g = G.gradient(xt)
            g2 = torch.sum(g * g, 0)
            if rtype == "TVL2":
                reg = torch.sum(torch.sqrt(g2))
            else:
                reg = 0.5 * torch.sum(torch.where(
                    g2 < 0.05 ** 2, g2, 0.1 * torch.sqrt(g2) - 0.05 ** 2))
            r = A64(xt) - bt
            o = float(0.5 * torch.sum(r * r) + ALPHA * reg)
            dev = abs(o - anchor) / anchor
            # TVL2's prox runs the TK0 normal_apply (inner cg); HuberL2's
            # the linear CGLS on the blur operators, which no kernel covers
            want_units = rtype != "TVL2" or counts.get("normal_apply", 0) \
                == ITERATIONS * (ITER_MAX + 1)
            require(rc == 0 and dev <= PD_DECONV_BAND and want_units
                    and all(n == 0 for n in F.plain_counts().values()),
                    "phase 35: run_deconvolution %s %s rc %r objective %.6f "
                    "vs anchor %.6f (rel %.3g); launches %s"
                    % (name, rtype, rc, o, anchor, dev, counts))
            res35["%s %s" % (name, rtype)] = "%.6f (anchor %.6f, rel %.1e), " \
                "%s" % (o, anchor, dev, counts or "no kernel")
        out = os.path.join(tmp, "study")
        rc = run_deconvolution_study.main([
            "--observation", obs_of["lena"], "--dir-output", out,
            "--study-name", "lena_pd", "--alpha-range", "0.001", "0.05",
            "4"])
        reader = ReaderParameterStudy(directory=out, name="lena_pd")
        reader.read_study()
        recs = reader.get_results("Data")
        require(rc == 0 and recs.shape == (4, ITERATIONS + 1)
                and np.all(np.isfinite(recs)), "phase 35: the PD study CLI "
                "rc %r, records %s" % (rc, recs.shape))
        res35["study CLI Lena PD 4 alphas"] = "Data records %s, finite" % (
            recs.shape,)
    print("phase 35 nsol_torch_run_deconvolution at its defaults (PD, %d "
          "iterations, auto): objectives %s; ms a solve (CLI, records "
          "included) %s [%s]" % (ITERATIONS, res35, {
              "%s %s" % k: round(v, 1) for k, v in ms35.items()}, card))
    # K10b.6 on a path: 512³ huber 5 x 5 x 8 through admm_solve("irls")
    # with the io window apply, on a NCCL group of world size 1
    its, sweeps, cgi = BIG_ROBUST_ITERS
    dist.initialize(coordinator_address="localhost:%d" % free_port(),
                    num_processes=1, process_id=0)
    try:
        mesh = make_space_mesh()
        b, iso, A64 = scale_problem(device, robust=True)
        x0 = torch.clamp(b, min=0.0)
        local = tuple(b.shape)
        blur_s, grad_W, normal_W = \
            blocked_halo.make_sharded_blocked_robust_operators(
                local, iso, mesh=mesh, io_dtype=bf)
        normal_B = matmul_halo.make_sharded_matmul_gradient_normal(
            local, None, mesh=mesh)
        Bg, Bg_adj = halo.make_sharded_gradient_operators(None, mesh)
        torch.cuda.synchronize()
        F.reset_counts()
        (x_io, _), ms_io = timed_once(lambda: admm_solve(
            blur_s, blur_s, Bg, Bg_adj, b, 0.0, x0, ALPHA, RHO,
            iterations=its, iter_max=sweeps, data_loss="huber",
            minimizer="irls", normal_B=normal_B, normal_W=normal_W,
            grad_W=grad_W, irls_cg_iters=cgi, reduce=mesh.reduce))
        io_launches = {k: v for k, v in F.launch_counts().items() if v}
        require(io_launches.get("weighted_apply_prepadded")
                == its * sweeps * (cgi + 1)
                and all(n == 0 for n in F.plain_counts().values()),
                "phase 35: K10b.6 launches %s" % io_launches)
        ob_io = robust_objective(x_io, b, A64, ALPHA)
        del x_io
        x_c, ms_c = timed_once(lambda: R.blocked_robust_admm_solve(
            BIG, iso, iterations=its, iter_max=sweeps, irls_cg_iters=cgi,
            compact_dirs=True)(b, x0, ALPHA, RHO))
        ob_c = robust_objective(x_c, b, A64, ALPHA)
        io_rel = abs(ob_io - ob_c) / abs(ob_c)
        require(io_rel <= WINDOW_IO_TOL, "phase 35: K10b.6 objective %.4f vs "
                "the compact blocked robust solve %.4f (rel %.3g)"
                % (ob_io, ob_c, io_rel))
        del x_c, b, x0
        torch.cuda.empty_cache()
    finally:
        torch.distributed.destroy_process_group()
    print("phase 35 K10b.6 512^3 huber %dx%dx%d, admm_solve(irls) with "
          "make_sharded_blocked_robust_operators(io_dtype=bfloat16) on NCCL "
          "world 1: objective %.4f, blocked_robust_admm_solve(compact_dirs="
          "True) %.4f (rel %.2e, band %g); %.1f ms a solve, blocked %.1f ms; "
          "launches %s [%s]" % (its, sweeps, cgi, ob_io, ob_c, io_rel,
                                WINDOW_IO_TOL, ms_io, ms_c, io_launches,
                                card))
    lap("phase 35")

    path_launches = dict(launches["compact"], **io_launches)
    out = []
    for name, (unit, tpu, source) in PD_SURFACE_UNITS.items():
        window = name.startswith("weighted")
        b_ms, b_by = pd_surface_bound(
            name, BIG_N if window else 1024 ** 2, nd=2, batch=64,
            reads=win_reads, ext=win_ext)
        t = times[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": tpu,
                    "launches": int(path_launches.get(unit, 0)),
                    "max_abs_err": err[name], "ms": t[0], "plain_ms": t[1],
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        require(out[-1]["launches"] > 0, "phases 33-35: %s launched no time "
                "on its main path" % name)
    return out


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
    # the CLI's default on the card: the reference's compact fused solve
    compact = F.make_fused_admm_solver(shape, iso, iterations=ITERATIONS,
                                       iter_max=ITER_MAX, precision="high3",
                                       compact_dirs=True)
    lib_x = interop.to_numpy(compact(bs, bs, ALPHA, RHO)).astype(
        np.float64) * scale
    cli_dev = float(np.max(np.abs(recon - lib_x)) / np.max(np.abs(lib_x)))
    require(recon.shape == shape and np.all(np.isfinite(recon)),
            "phase 6: CLI result not finite or misshapen")
    require(cli_dev <= KERNEL_TOL, "phase 6: CLI vs library %.3g" % cli_dev)
    print("phase 6 CLI: shape %s finite, max|cli - library|/max %.3e"
          % (recon.shape, cli_dev))

    return {"launches": launches, "err": main_err, "times": times64}


#: the phase groups, in the order they run; ``--only`` picks some of them
GROUPS = ("admm", "pd", "robust", "units", "tikhonov", "study", "cli",
          "scale", "compact", "sharded", "compact_robust", "pd_surface")
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
    "scale": ("nsol_tpu_torch/csrc/tiled.cu", {
        "normal_apply_zy": "nsol_tpu/ops/pallas/blocked.py:754",
        "cg_step_zy": "nsol_tpu/ops/pallas/blocked.py:878",
        "blur_apply_zy": "nsol_tpu/ops/pallas/robust.py:734",
        "weighted_apply_zy": "nsol_tpu/ops/pallas/robust.py:564",
        # the "apply" CG's p = r + β·p, which the JAX package leaves to XLA
        # (blocked.py:1537-1540): no TPU kernel
        "cg_direction": None}),
    "sharded": ("nsol_tpu_torch/csrc/admm.cu", {
        "normal_apply_prepadded": "nsol_tpu/ops/pallas/blocked.py:478"}),
    "sharded_robust": ("nsol_tpu_torch/csrc/robust.cu", {
        "blur_apply_prepadded": "nsol_tpu/ops/pallas/robust.py:161",
        "weighted_apply_prepadded": "nsol_tpu/ops/pallas/robust.py:264"}),
}


def kernel_entries(group, launches, err, times, n, taps, nd=3, batch=1,
                   ext=None, reads=None):
    """The ``kernels`` records of one group's units: launches on its main
    path, max |Δ| against the plain version, kernel / plain / library ms
    per call at ``n`` voxels (× ``batch`` images), and the bound there
    (``taps``: the chain's stencil lengths, or a dict of them by unit;
    ``ext``: a window unit's halo'd/output plane ratio, ``reads``: the
    volumes it reads, by unit; see :func:`unit_bound`)."""
    source, replaces = SOURCES[group]
    out = []
    for name, tpu in replaces.items():
        t = times[name]
        b_ms, b_by = unit_bound(name, n, taps[name] if isinstance(taps, dict)
                                else taps, nd, batch,
                                (ext or {}).get(name, 1.0),
                                (reads or {}).get(name))
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
        with exact_storage():  # the sweeps' float64 anchors, as before
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
    if "scale" in groups:
        scale = run_scale_phases(device, card)
        kernels += kernel_entries("scale", scale["launches"], scale["err"],
                                  scale["times"], int(np.prod(BIG)),
                                  TILED_TAPS)
    if "compact" in groups:
        kernels += run_compact_phases(device, card)
    if "sharded" in groups:
        sh = run_sharded_phases(device, card)
        lap("phases 26-28")
        for group in ("sharded", "sharded_robust"):
            kernels += kernel_entries(group, sh["launches"], sh["err"],
                                      sh["times"], int(np.prod(BIG)),
                                      sh["taps"], ext=sh["ext"],
                                      reads=sh["reads"])
    if "compact_robust" in groups:
        kernels += run_compact_robust_phases(device, card)
    if "pd_surface" in groups:
        kernels += run_pd_surface_phases(device, card)
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
