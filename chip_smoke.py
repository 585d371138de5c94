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
  solves; ``tik_clip`` and ``irls_step`` at ragged lengths, on misaligned
  views, in place and on NaN/±inf/−0 inputs (F4), and ``tik_clip``'s
  device time beside ``torch.clamp``'s (``torch.profiler``, in turns) at
  256² and 256³ with its ms a wrapper call; the Lena 256² TK1L2/TK0L2
  sweeps over 64 α (CG 10) and the TK1L2
  huber sweep through ``TikhonovLinearSolver.run_sweep``, against float64
  anchors; the TV-L2 ADMM study with records (8 α × 2 ρ, 50 × 10) through
  ``ADMMLinearSolver.run_sweep`` and ``run_deconvolution`` on the PNG; a
  256³ TK1L2 sweep over 8 α; ``nsol_torch_run_deconvolution_study`` on
  the 64³ NIfTI phantom (TK1L2) and on Lena (TVL2 by ADMM);
* phases 20-22, the 512³ scale path through the one-pass tiled units of
  ``csrc/tiled.cu``: the units against their plain versions on tile-edge
  shapes, every form of the march units (``normal_apply_zy`` in float32
  and bfloat16 io, ``cg_step_zy``, ``blur_apply_zy``) bit for bit against
  its three-pass unit there and at 512³, the march's ptxas report, and
  the units' 512³ device and wrapper-call times beside the three-pass
  units; ``cg_direction``
  (``csrc/stream.cuh``) at ragged lengths, misaligned and in place, and its
  512³ device time beside ``torch.add``'s, in turns;
  ``blocked_admm_solve`` 50 × 10 in its "apply" and "step2d" modes within
  0.2 % of 165421.8 and against the fused solve; the robust huber
  5 × 5 × 8 solve against the per-axis one; ``run_deconvolution`` on a
  (64, 512, 512) NIfTI through the tiled route;
* phases 23-25, compact storage and the CG sweep (group ``compact``): the
  storage-typed units (bfloat16 ``r``/``p``/``q``) and ``cg_sweep``
  against their plain versions on tile-edge shapes (bf16 outputs within
  one bf16 ulp, float32 ones and the dots within 1e-5) and their times at
  each main path's shape beside the float32 units, ``cg_direction``'s
  bf16 and deferred bf16-state instances also at ragged lengths, misaligned
  and by device time; the 64³ fused compact
  solve within 0.2 % of 219948.08; at 256³ "step" under ``compact_dirs``
  and bf16 state and "sweep" in float32 and bf16 against the exact
  objective; 512³ "apply" under both within 0.2 % of 165421.8, the exact
  one equal to its recorded 165421.769; and
  ``run_deconvolution``'s default, ``NSOL_TPU_EXACT=1`` and
  ``NSOL_TPU_COMPACT=1`` on a 64³ and a (64, 512, 512) NIfTI against the
  library solves ``nsol_tpu_torch.policy`` names.

* phases 26-28, the sharded path (group ``sharded``,
  ``nsol_tpu_torch.parallel``): the three prepadded window units
  (``normal_apply_prepadded`` as ``csrc/tiled.cu``'s march over its
  window, the robust ones of ``csrc/robust.cu``) against their plain
  versions on the tile-edge shapes, the tiled window bit for bit against
  its three-pass chain at three ``row0``, 4 slabs of one 256³ volume
  assembled against the whole-volume units (the global boundary rows),
  their 512³ times beside the whole-volume units (the normal window's
  device time in turns with ``normal_apply_zy``); on a real NCCL process
  group of world size 1,
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

* phases 36-38, the whole-volume ``cg_step`` and ``weighted_apply`` on the
  marches of ``csrc/march.cuh`` (groups ``volume``, ``volume_solves``):
  the z-tile and route rules in C against their Python mirrors; every
  form (``cg_step`` 4 storages × TK1/TK0 × first trip or not,
  ``weighted_apply`` 3 storages × masked or not × TK1/TK0 × first trip or
  not) bit for bit against its three-pass chain on the tile-edge shapes,
  at 256³ and on a 136 × 240 × 200 volume (two seeds each) and on the 2-D
  view; the chain side of the route (blurs past the marches' shared
  memory); the device times of the forms, chain against march in turns,
  at 256³, on the ragged volume and at the shapes the route is measured
  at (64³, 96³, 128³, Lena 256², 2048², thin stacks of 2-32 planes past
  2^20 voxels), and of the 512³ march units;
  and the solves that run them (256³ "step" exact / compact / bf16 state,
  256³ robust exact / compact, the 256³ TK1L2 × 8 α sweep, the 512³
  "step2d" solve, the 64³ north star, the Lena TV-L2, huber and TK1L2 ×
  64 α solves) by CUDA events,
  with their objectives and routes. Run with this script on an earlier
  package (``--only volume,volume_solves``) it times that package's
  route and skips the checks it lacks.

* phase 39, ``admm_tail`` and ``pd_record`` (group ``tail``): every
  ``admm_tail`` form (init and not, v written or not) on 64³, 256³ and a
  136 × 240 × 200 volume (two seeds),
  a ragged and an anisotropic volume, Lena 256², a ragged image, the
  (1, Y, X) view and 512³, with negative voxels, −0 and one NaN, against
  its plain version and the forms with and without v against each other
  bit for bit (with
  ``--tail-bits PATH``, every output against the digests a run of
  another package wrote there); ``pd_record`` in float32 and bfloat16,
  2-D and 3-D, TV/Huber × ℓ1/ℓ2 against its plain version, repeating bit
  for bit; their ptxas report and device times beside their bounds
  (``admm_tail`` at 64³, Lena, 256³, the ragged volume and 512³;
  ``pd_record`` at 64 × 1024², the 64³ phantom and 256³); and the solves
  that run them by CUDA events with their objectives (the 64³ north
  star, Lena TV-L2, 256³ "step" exact / compact / bf16 state and 512³
  "apply" / "step2d" to their recorded digits, the Man 1024² × 64 α
  sweep exact and compact, the PD deconvolution CLI on the 64³ NIfTI).
  Run with this script on an earlier package (``--only tail``) it times
  that package's units and skips the forms it lacks.

* phase 40, ``cg_sweep`` on its march (group ``sweep``): the sweep's
  route and z tile in C against their Python mirrors; every sweep form
  (float32 and bf16 state × first trip or not) on the march bit for bit
  against the three-pass chain (x', r', p', q'; the four dots, a and β
  within 1e-12) on the tile-edge shapes, 256³, a 136 × 240 × 200 volume
  (two seeds) and 512³; a NaN in p on both routes; the C entry's
  refusals (q' over q, a march past its shared memory); the ptxas report
  of its instances; the march against its plain version at 256³; device
  times chain against march in turns at 256³ and 512³ (both storages) and
  at the route's boundary shapes (64³, 96³, 128³, 256², 2048², thin
  stacks); and the solves that run it by CUDA events (256³ "sweep" float32
  and bf16 against "step" exact, 512³ "sweep" against "apply" and the
  512³ anchor, a 64³ "sweep" on the chain), with their launches.

* phases 41-43, the non-separable blur, the remaining Tikhonov engines,
  corruption and generation (group ``engines``; no kernel of its own): the
  FFT blur against the separable form (diagonal covariance, 64³, 256³,
  512³) and against the direct form (a full covariance, 64³ and 256³,
  the direct form with TF32 left at PyTorch's default), adjointness in
  float64, the FFT normal operator against ``A_adj(A x)``, and the forms'
  device times beside the separable march's ``blur_apply``; the
  ``lsq_linear``, ``least_squares`` and ``L-BFGS-B`` solves of
  ``tikhonov_solve`` on a full covariance (256³, the 64³ phantom, Lena)
  against float64 anchors of the JAX package, with their wall ms, L-BFGS
  host reads and peak memory, and ``Optimize`` and the PCA classes against
  their CPU results; ``nsol_torch_corrupt_data`` (Lena and the 64³
  NIfTI, gaussian and salt-and-pepper) against the library's blur and
  ``Noise`` bit for bit, ``generate_standalone_data`` without Pillow, and
  ``nsol_torch_run_deconvolution --minimizer lsq_linear`` / ``L-BFGS-B
  --data-loss huber`` on the corrupted Lena against their library solves;
  ``sharded_tv_admm_solve`` with the full covariance on a NCCL group of
  world size 1, ``"lsmr"`` and ``"L-BFGS-B"`` (huber), against the
  unsharded solves.

* phase 44, the batch mesh and ``--trace`` (group ``batch``; no kernel of
  its own): on a NCCL group of world size 1, the Man 1024² × 64 α PD TVL2
  sweep and the Lena TK1L2 × 64 α sweep with records through
  ``run_sweep(mesh=make_mesh((1,), ("batch",)))`` and the Lena TV-L2 ADMM
  study through ``ADMMLinearSolverParameterStudy(mesh=...)``, each against
  its run with no mesh in turns: x and records bit for bit, the same
  launch counts, the wall ms of each turn; ``nsol_torch_run_denoising``
  (Lena, PD TVL2) and ``nsol_torch_run_deconvolution`` (the 64³ phantom,
  ADMM TVL2) without ``--trace`` in this process and twice with it, each
  traced run a process of its own: the same bits and launches, a
  Chrome-trace JSON that names the hand-written kernels the run launched,
  its size and the wall ms each way.

* phase 45, the fused ADMM solve as one persistent cooperative launch
  (group ``persistent``, ``csrc/admm_persistent.cu``): its ptxas registers
  and spills, no constant-cache load in its SASS (``cuobjdump``), its
  launch shape and grid barriers; the 64³ stand-in and Lena (exact and
  qf32, with and without records) and the rule's edge shapes (80³, a
  ragged volume, a 2-plane stack) bit for bit against ``nsol_admm_solve``'s
  launch sequence, each solve three times, one launch a solve; the 64³
  objective within 0.2 % of 219948.08 and equal in its printed digits to
  the sequence's; the Lena ADMM study's rows equal on both routes; Lena
  against the plain version at phases 4-5's bands; the shapes the rule
  refuses (100³, 1024²) on the launch sequence; times in turns (sequence,
  persistent, persistent, sequence) by CUDA events of the 64³ and Lena
  solves, the Lena ADMM study, the 64³ ``nsol_torch_run_deconvolution`` and
  the route's boundary shapes (64³-100³, 256²-2048², stacks of 2-32
  planes); a CUDA graph replay of the launch sequence as a yardstick, the
  device busy share, the barriers alone, and a traced solve's phases.

* phase 46, the fused Tikhonov batch, linear, as one persistent
  cooperative launch (group ``tik_persistent``,
  ``csrc/tikhonov_persistent.cu``): its ptxas registers and spills, no
  constant-cache load in its SASS, its launch shape (the configurations
  side by side, against the widths its C rule gives) and grid barriers;
  the batch against its plain version within ``SOLVE_VOX_TOL``; the Lena
  TK1L2/TK0L2 × 64 α sweeps (exact and qf32), 64³ × 8, the rule's edge
  shapes (80³, a ragged volume, a 2-plane stack), a batch of 1 and one of
  130 bit for bit against ``nsol_tikhonov_solve``'s launch sequence, each
  three times, one launch a batch; the Lena sweeps' objectives at phase
  17's float64 anchors; 256³ on the sequence (one ``tik_clip`` a
  configuration on entry, one more on exit, no persistent launch) and the
  robust loss on phase 47's launch; times in
  turns (sequence, persistent, persistent, sequence) by CUDA events of the
  Lena and 64³ batches, ``TikhonovLinearSolver.run_sweep`` on Lena and
  ``nsol_torch_run_deconvolution_study`` on the 64³ phantom (TK1L2), both
  equal on the two routes; a CUDA graph replay of the sequence, the device
  busy share and the device time by the kernel's global-timer stamps.

* phase 47, the robust IRLS sweep as one persistent cooperative launch
  (group ``irls_persistent``, ``csrc/irls_persistent.cu``) for the fused
  robust ADMM solve and the robust Tikhonov batch: its ptxas registers
  and spills, no constant-cache load in its SASS, its launch shape (the
  configurations side by side against the C rule's widths) and grid
  barriers (the formula against the kernel's stamps); Lena 10 × 3 × 6 in
  the four losses, exact and dirs, with and without records, the 64³
  phantom, the rule's edge shapes (80³, a ragged volume, a 2-plane
  stack), the Lena TK1L2/TK0L2 huber × 8 batches exact and compact, a
  batch mixing α and C, a batch of 1, one longer than a turn, and a NaN
  in b and in x0 bit for bit (NaN-equal) against the launch sequence,
  each three times, one launch a solve or batch; Lena within 1e-4 of
  101.442567; the Lena TK1L2 huber sweep at phase 17's float64 anchors;
  each main path against its plain version; ``run_sweep``'s huber
  sweeps, the Lena ADMM huber study and ``run_deconvolution --data-loss
  huber`` equal on both routes, the CLI to its library solve; 256³, 100³,
  the ``"io"`` storage and a 256³ batch on the sequence; the rule in C
  against its mirror; times in turns by CUDA events; a CUDA graph replay
  of each sequence, the device busy share, the device time by the
  stamps, the bound; and a persistent call's parts by host clock (the
  rule, the shape, the allocations, the copies, the launch), for this
  kernel's two entries and phase 46's linear batch.

* phase 48, the fused primal-dual denoise as one persistent cooperative
  launch (group ``pd_persistent``, ``csrc/pd_persistent.cu``): its ptxas
  registers and spills, no constant-cache load in its SASS, its launch
  shapes and grid barriers (the formula against the kernel's stamps);
  the C rule's routes at the denoising path's batches; Lena, a ragged
  image, the 64³ phantom and two ragged volumes (anisotropic where
  named) in 4 types × 3 schedules × exact/compact × records, B 1 and 3,
  and NaN strips in b and in x0, bit for bit (NaN-equal) against
  ``nsol_pd_solve``'s launch sequence, one launch a call (the main paths
  three times); Lena × 64 on the sequence; times in turns by CUDA events
  on both sides of the rule (forced past it); on Lena a CUDA graph
  replay of the sequence, the device busy share, the device time by the
  stamps, the bound and a persistent call's parts by host clock.

* phase 49, the shard probes (group ``probes``, ``csrc/probes.cu``,
  ``nsol_tpu_torch/parallel/shard_probe.py``): the counterparts of the 8
  Pallas kernels of ``benchmarks/shard_pallas_diag*.py`` — ``probe_scale``
  (K1, zb 32, 8 and 4) and ``probe_window_scale`` (K2, halo 0 and 6, one
  slot or two, the factor an immediate or in device memory) bit for bit
  against their plain versions on a ragged last z-block, fewer planes than
  a z-block, a window sharing planes with more than one neighbour and a
  plane of more tiles than one wave, ``probe_block_matmul`` (K3, both
  sides, with and without
  ``trans``) within 1e-5 of the float64 product at "HIGHEST" and within
  1e-6 of its plain version on bf16-rounded inputs at "DEFAULT", on the
  probes' shapes, ragged and unaligned ones and an x-side matrix past
  "DEFAULT"'s resident budget; the wrappers' refusals; every variant d1-i3
  at 256³ plain and on a NCCL group of world size 1, with its launches;
  each kernel's time at 256³ (K2 beside its windows' own bytes; K3: the
  x, x-``trans`` and y-``trans`` forms, device and a wrapper call) beside
  its plain version, its library call (``torch.mul``; ``torch.matmul`` in
  float32 with TF32 off for
  "HIGHEST", and for "DEFAULT" at float32 matmul precision "medium" where
  it holds to the plain version, else none) and its bound.

Since the persistent PD solve, Lena's and the 64³ phantom's denoising
solves (phases 8, 10a, 11, 34, 44) take one ``pd_persistent`` launch;
phase 9's Man 1024² × 64 α sweep stays on the launch sequence (50, 50,
51 launches, the ``kernels`` line's counts of its units), as do phase
10b's 256³ solve and phase 33's study.

Since the persistent IRLS sweep, the phases that hold the robust
sequence's units against their plain versions or count their launches —
phase 13's main path, phase 15's CLI, phase 16's whole robust solve,
phase 17's huber sweep, phase 30's fused solves, phase 31's CLI and phase
36's chain side — run that sequence forced (``robust_sequence()``, or
``solve.sequence``); phases 13 and 17 also run the default route (one
``irls_persistent`` launch, the same bits), and phase 46's robust batch
expects that launch. The ``kernels`` line takes ``admm_record``'s
launches from phase 18's 100³ robust solve with records and
``tik_clip``'s from phase 19's 256³ sweep: default routes past the
persistent rules, where those units still launch.

Since the persistent Tikhonov batch, the phases that hold the Tikhonov
sequence's units against their plain versions or count their launches —
phase 16's whole solves, phase 17's linear sweeps, phase 19's TK1L2 study
CLI and phase 31's sweeps — run that sequence forced
(``sequence_route``); phase 17 also runs each linear sweep on its
default route (one ``tik_persistent`` launch, the same bits), phase 44
expects one ``tik_persistent`` launch a Lena TK1L2 turn, and
``tik_clip``'s kernels-line launches come from the huber sweep.

Since the persistent solve, the 64³ and Lena fused solves (phases 4, 18,
19, 24, 39, 44) launch ``admm_persistent`` once a solve and none of the
launch sequence's units: phase 5's 256³ solve reports those units'
launches, a robust configuration with records ``admm_record``'s (phase
18), and a 96³ compact solve, past the persistent rule, ``cg_step[qf32]``'s
(phase 24); phase 36 holds the linear chain side on the solve's launch
sequence.

The CLI runs of phases 6, 15, 18 and 22 hold ``run_deconvolution``'s
default on the card — the reference's compact storage — to the compact
library solve. The sweeps that phases 17-19 hold to float64 anchors or
to the exact generic solve run under ``NSOL_TPU_EXACT=1``, as before;
phase 31 runs them at their default.

Phase 44's traced CLI runs are each their process's first trace:
torch.profiler, with CUPTI kept alive between the traces of one process,
loses the earliest kernel records of a trace, the more the longer ago
that process's first trace was (F7 in ROADMAP.md). The profiler's other
readings (device busy, device ms) print "not measured" where a trace
kept no record; phase 45's ``device_ms`` is the kernel's own global-timer
stamps.

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
import re
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
#: the PD launch sequence's units (``nsol_pd_solve``); ``fused.PD_UNITS``
#: adds the one-launch solve ``pd_persistent``
PD_SEQUENCE_UNITS = ("pd_dual", "pd_primal", "pd_record")
#: a PD solve whose batch the one-launch rule takes: one launch of
#: ``csrc/pd_persistent.cu`` and none of the sequence's units
PD_ONE_LAUNCH = {"pd_dual": 0, "pd_primal": 0, "pd_record": 0,
                 "pd_persistent": 1}
#: the Man 1024² × 64 α sweep (50 iterations, records): past the rule, the
#: launch sequence
PD_MAN_SEQUENCE = {"pd_dual": 50, "pd_primal": 50, "pd_record": 51,
                   "pd_persistent": 0}

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
#: phase 18's robust solve with records past the persistent rule (its
#: units march at σ = 1), where ``admm_record`` still launches
RECORD_SHAPE = (100, 100, 100)


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
#: and float32 operations/s outside the tensor cores; bf16 operations/s of
#: the tensor cores (dense)
HBM_BYTES_S, F32_OPS_S = 3.35e12, 67e12
BF16_OPS_S = 989e12


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
        "probe_scale": (2, 1),                  # x in, out
        "probe_window_scale": (reads + 1, 1),   # the centre in, out
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

def pd_on_sequence(counts):
    """Whether PD launch counts are the launch sequence's: each of its
    units launched, no one-launch solve."""
    return counts["pd_persistent"] == 0 and all(
        counts[k] > 0 for k in PD_SEQUENCE_UNITS)


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


def pd_nan_case(F, shape, rtype, device):
    """The PD solve (6 iterations, α 0.1 and 0.5, records) on b with a NaN
    strip over the first two entries of its leading axis (a NaN
    background's edge), kernels against plain: NaN at the same voxels of x
    (some, not all) and of the records, the finite x within KERNEL_TOL ·
    max |ref|. The NaN spreads through p and the divergence; the l1 prox
    keeps it (fused.py:1151's jnp.maximum and jnp.sign). Fails the phase
    on a miss; returns the NaN voxels of x."""
    import torch

    b = torch.as_tensor(np.random.RandomState(8).rand(*shape)
                        .astype(np.float32), device=device)
    b[:2] = float("nan")
    solve = F.make_fused_pd_denoise_solver(shape, rtype, iterations=6,
                                           record=True)
    x_k, r_k = solve(b, b, [0.1, 0.5], PD_L2)
    x_p, r_p = solve.plain(b, b, [0.1, 0.5], PD_L2)
    what = "PD %s %s with a NaN strip in b" % (rtype, shape)
    same_nan([(x_k, x_p), (r_k["Reg"], r_p["Reg"]),
              (r_k["Data"], r_p["Data"])], what)
    nan = torch.isnan(x_p)
    count = int(nan.sum())
    require(0 < count < nan.numel(), "%s: %d NaN voxels" % (what, count))
    rel = max_rel(x_k[~nan], x_p[~nan])
    require(rel <= KERNEL_TOL, "%s: finite voxels rel %.3g" % (what, rel))
    return count


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
    err = {k: 0.0 for k in PD_SEQUENCE_UNITS}
    for shape in ((37, 53), (1024, 1024), (37, 45, 53), (5, 40, 33)):
        worst = {k: 0.0 for k in PD_SEQUENCE_UNITS}
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
    nans = {"%s %s" % (rtype, "x".join(map(str, shape))):
            pd_nan_case(F, shape, rtype, device)
            for shape in ((40, 33), (12, 16, 16)) for rtype in PD_TYPES}
    print("phase 7 PD solve with a NaN strip in b, kernels vs plain: NaN at "
          "the same voxels and records (NaN voxels %s), finite voxels within "
          "%g" % (nans, KERNEL_TOL))

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
    # the solve's one launch (csrc/pd_persistent.cu), none of the sequence's
    require(launches == PD_ONE_LAUNCH,
            "phase 8: not one pd_persistent launch: %s" % launches)
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
    # past the one-launch rule: the launch sequence, whose units' counts
    # the kernels line takes
    require(launches == PD_MAN_SEQUENCE,
            "phase 9: the sweep's launches %s, not the sequence's %s"
            % (launches, PD_MAN_SEQUENCE))
    launches = {k: launches[k] for k in PD_SEQUENCE_UNITS}
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
    # the launch sequence's units (phase 47 holds the persistent launch,
    # the default route, to it)
    with robust_sequence():
        solve(b, b, ALPHA, RHO)  # warm-up (stencils, allocator)
        torch.cuda.synchronize()
        F.reset_counts()
        x_k = solve(b, b, ALPHA, RHO)
        torch.cuda.synchronize()
        launches = F.launch_counts(F.ROBUST_UNITS)
        plain_calls = F.plain_counts()
        ms_seq = cuda_ms(lambda: solve(b, b, ALPHA, RHO), reps=20, warmup=2)
    require(all(n > 0 for n in launches.values()),
            "phase 13: a kernel was not launched: %s" % launches)
    require(all(n == 0 for n in plain_calls.values()),
            "phase 13: a plain version ran: %s" % plain_calls)
    # its default route: one persistent launch, the same bits
    F.reset_counts()
    x_d = solve(b, b, ALPHA, RHO)
    torch.cuda.synchronize()
    default = used_counts(F)
    require(default == ({"irls_persistent": 1}, {}) and bits_equal(x_d, x_k),
            "phase 13: the default route launches %s, the same bits %s"
            % (default, bits_equal(x_d, x_k)))
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
          "voxel %.2e; x at alpha 1.0 identical: %s; launches %s on the "
          "forced launch sequence, %s on the default route (the same bits); "
          "plain calls %s; kernel %.4f ms/solve (the sequence %.4f), plain "
          "%.4f ms/solve [%s]"
          % (its, sweeps, cgi, obj, LENA_ROBUST_ANCHOR, dev, rel, vox, same,
             launches, default[0], sum(plain_calls.values()), ms_k, ms_seq,
             ms_p, card))
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
    scale_launches = F.launch_counts(F.ROBUST_UNITS + F.MARCH_UNITS)
    plain_calls = F.plain_counts()
    require(all(n > 0 for n in unit_counts(F, F.ROBUST_UNITS).values())
            and route_launches(F)["weighted_apply"] == (
                0, its * sweeps * cgi),
            "phase 14: a kernel was not launched, or weighted_apply not on "
            "the march: %s" % scale_launches)
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
        # on the forced launch sequence, its units counted (phase 47 runs
        # this CLI on both routes)
        with robust_sequence():
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
    """(kernel ms, plain ms, library ms or None) per call of
    ``admm_record`` (huber, C = 1) at ``shape`` (``tik_clip``'s are
    :func:`clip_stream_times`)."""
    import torch

    from nsol_tpu_torch.ops.cuda import record as Rec

    rng = np.random.RandomState(16)
    x = torch.as_tensor(rng.rand(*shape).astype(np.float32) - 0.3,
                        device=device)
    b = torch.as_tensor(rng.rand(*shape).astype(np.float32), device=device)
    rk = Rec.new_records(2, device)
    return {
        "admm_record": (
            cuda_ms(lambda: Rec.admm_record(x, b, st.blur, st.inv_h, "huber",
                                            1.0, *rk, 1), reps),
            cuda_ms(lambda: Rec.admm_record_plain(x, b, st.blur, st.inv_h,
                                                  "huber", 1.0, *rk, 1),
                    max(2, reps // 4)), None),
    }


def clip_stream_times(device):
    """tik_clip's kernel beside ``torch.clamp``'s at 256² (the Lena sweeps)
    and 256³ (the 256³ TK1L2 sweep): device ms in turns
    (:func:`device_turns`), ms a call by CUDA events in the same turns (a
    loop of wrapper or ``torch.clamp`` calls: the host's enqueue included),
    the plain version's ms a call, and the bound. ``{shape: {"device",
    "call", "plain", "bound"}}``."""
    import torch

    from nsol_tpu_torch.ops.cuda import tikhonov as TK

    rng = np.random.RandomState(16)
    out = {}
    for shape, reps in (((256, 256), 400), ((256, 256, 256), 100)):
        x = torch.as_tensor(rng.rand(*shape).astype(np.float32) - 0.3,
                            device=device)
        o = torch.empty_like(x)

        def kern():
            TK.tik_clip(o, x)

        def lib():
            torch.clamp(x, min=0.0, out=o)

        calls = {"library": [], "kernel": []}
        for key, fn in (("library", lib), ("kernel", kern), ("kernel", kern),
                        ("library", lib)):
            calls[key].append(cuda_ms(fn, reps))
        out[shape] = {"device": device_turns(kern, lib, reps), "call": calls,
                      "plain": cuda_ms(lambda: TK.tik_clip_plain(o, x), reps),
                      "bound": unit_bound("tik_clip", x.numel())[0]}
        del x, o
    return out


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
                # the sequence's units (phase 46 holds the persistent
                # batch to it)
                xk = s.sequence(b, b, alphas, 0.3)
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
            # the robust solve's launch sequence (phase 47 holds the
            # persistent launch to it)
            run = s if loss == "linear" else s.sequence
            xk, rk = run(b, b, 0.05, 0.5, data_loss_scale=0.3,
                         record_dls=0.7)
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
    print("phase 16 admm_record per call 256^2 (kernel ms, plain ms, library "
          "ms): %s [%s]"
          % (", ".join("%s %.4f/%.4f/%s" % (k, a, p, "none" if lib is None
                                             else "%.4f" % lib)
                       for k, (a, p, lib) in times.items()), card))
    # the clips' stream kernels at ragged lengths, misaligned, NaN (F4)
    checked = stream_edge_checks(("tik_clip", "irls_step"), device)
    print("phase 16 tik_clip and irls_step vs plain %s, in place, NaN/inf/-0 "
          "inputs: %d kernel calls equal (NaN where plain has NaN)"
          % (stream_cases_text(), checked))
    clip = clip_stream_times(device)
    for shape, t in clip.items():
        print("phase 16 tik_clip %s (bound %.4f ms): device ms (torch."
              "profiler, turns torch.clamp, kernel, kernel, torch.clamp) "
              "kernel %s, torch.clamp %s (kernel records a call %s); ms a "
              "call by CUDA events, host enqueue included, wrapper %s, "
              "torch.clamp %s, plain %.4f [%s]" % (
                  "x".join(map(str, shape)), t["bound"],
                  span(t["device"]["kernel"]), span(t["device"]["library"]),
                  t["device"]["kernels"], span(t["call"]["kernel"]),
                  span(t["call"]["library"]), t["plain"], card))
    lena = clip[(256, 256)]
    times["tik_clip"] = (
        mean_ms(lena["call"]["kernel"]), lena["plain"],
        mean_ms(lena["call"]["library"]), mean_ms(lena["device"]["kernel"]),
        mean_ms(lena["device"]["library"]))
    return {"err": err, "times": times, "taps": st.blur.lengths,
            "clip": clip}


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


def device_ms(fn, reps, warmup=3, keys=None):
    """Device ms per call of ``fn`` and the kernel records per call: from a
    ``torch.profiler`` trace of ``reps`` calls after ``warmup`` untraced
    ones, the median duration of each kernel's records times the kernels
    of its name a call (its records over ``reps``, rounded, at least 1);
    the host's enqueue does not count. The trace may lose records of a long
    run (seen on the H100's host: 12-19 of 20 at 512³), so a median over
    the records kept, not a sum over ``reps``. ``keys``: only the kernels
    whose names hold one of them (a unit's own, not its wrapper's copies).
    ``(None, 0)`` where the trace holds no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    runs = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith(
                ("aten::", "Activity Buffer", "Memcpy", "Memset")) and (
                    keys is None or any(k in e.name for k in keys)):
            runs.setdefault(e.name, []).append(e.time_range.elapsed_us())
    if not runs:
        return None, 0
    total = sum(float(np.median(d)) * max(1, round(len(d) / reps))
                for d in runs.values())
    return total / 1e3, sum(len(d) for d in runs.values()) / reps


def device_ms_of(fn, reps, tries=3, keys=None):
    """:func:`device_ms`'s ms a call, traced again (up to ``tries`` traces)
    where a trace kept no kernel record; None where none did."""
    for _ in range(tries):
        ms = device_ms(fn, reps, keys=keys)[0]
        if ms is not None:
            return ms
    return None


def ms_text(t):
    """``t`` ms as text, or 'not measured'."""
    return "not measured" if t is None else "%.4f" % t


def device_turns(kernel, library, reps):
    """Device ms per call (:func:`device_ms`) of ``kernel`` and of
    ``library`` (or None), taken in turns in one run — library, kernel,
    kernel, library: ``{"kernel": [ms, ms], "library": [ms, ms] or None,
    "kernels": kernel records a call of each turn}``."""
    out = {"kernel": [], "library": None if library is None else [],
           "kernels": {}}
    for key, fn in (("library", library), ("kernel", kernel),
                    ("kernel", kernel), ("library", library)):
        if fn is not None:
            ms, per_call = device_ms(fn, reps)
            out[key].append(ms)
            out["kernels"].setdefault(key, []).append(per_call)
    return out


def turn_gaps(turns, bound_ms):
    """Kernel against library, turn by turn, from :func:`device_turns`
    (turns library, kernel, kernel, library: kernel turn 1 beside library
    turn 1, 2 beside 2), and each time's effective HBM rate (the bytes of
    ``bound_ms`` at the card's rate, over the time), as text."""
    k, lib = turns["kernel"], turns["library"]
    if lib is None:
        return "no library call"
    if None in k + lib:
        return "not measured"

    def rate(t):
        return HBM_BYTES_S * bound_ms / t / 1e12

    return "; ".join(
        "turn %d kernel %.5f (%.3f TB/s) vs library %.5f (%.3f TB/s): "
        "%+.2f %%" % (i + 1, a, rate(a), b, rate(b), 100 * (a - b) / b)
        for i, (a, b) in enumerate(zip(k, lib)))


def stream_ptxas():
    """The ptxas report of the stream kernels (``csrc/stream.cuh``), one
    entry an instance: ``{name and mangled template arguments:
    (registers, resident warps an SM of 64)}``, the warps from the
    registers (65536 an SM, allocated 256 a warp; 128-thread blocks, at
    most 32 blocks an SM). Empty where the library came from the cache."""
    from nsol_tpu_torch.ops.cuda import build

    out, entry = {}, None
    for ln in build.build_info.get("ptxas", "").splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "registers" in ln and entry and (
                "direction_kernel" in entry or "clip_kernel" in entry):
            regs = int(ln.split("Used")[1].split()[0])
            per_warp = -(-regs * 32 // 256) * 256
            blocks = min(32, 64 // 4, 65536 // (per_warp * 4))
            kind = "direction_kernel" if "direction_kernel" in entry \
                else "clip_kernel"
            out[kind + entry.split(kind, 1)[1].split("Ev")[0]] = (regs,
                                                                 4 * blocks)
            entry = None
    return out


def mean_ms(ts):
    """The mean of measured turns (None: not measured)."""
    ts = [t for t in ts or () if t is not None]
    return float(np.mean(ts)) if ts else None


def span(ts):
    """'lo-hi' ms of measured turns, or 'not measured'."""
    ts = [t for t in ts or () if t is not None]
    return "%.5f-%.5f" % (min(ts), max(ts)) if ts else "not measured"


def stream_edge_checks(units, device):
    """Each unit of ``units`` (a key of ``stream_cases.DIRECTION_FORMS``,
    ``tik_clip``, ``irls_step``) against its plain version on the card at
    every length of ``stream_cases.SHAPES``
    (:func:`nsol_tpu_torch.ops.cuda.stream_cases.check`: every offset
    pattern, in place, the clips on NaN, ±inf and ±0). Fails the phase on
    a miss; returns the number of kernel calls checked."""
    from nsol_tpu_torch.ops.cuda import stream_cases as SC

    checked = 0
    for shape in SC.SHAPES:
        for unit in units:
            try:
                checked += SC.check(unit, shape, device)
            except AssertionError as e:
                require(False, str(e))
    return checked


def stream_cases_text():
    """The lengths and offsets of :func:`stream_edge_checks`, as text."""
    from nsol_tpu_torch.ops.cuda import stream_cases as SC

    return "at lengths %s, offsets %s" % (
        [int(np.prod(s)) for s in SC.SHAPES], SC.OFFSETS)


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
    ``TikhonovLinearSolver.run_sweep`` on the card: each sweep's launch
    sequence (forced onto it) against its anchors, and its default route
    (one persistent launch) to the same bits.
    Returns each sweep's sequence launches and timing."""
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
        # the launch sequence's units: each sweep on the forced sequence
        # (phases 46-47 hold the persistent batches to it)
        torch.cuda.synchronize()
        F.reset_counts()
        with robust_sequence() if robust else sequence_route(
                T, TIK_RULE):
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
        # its default route: the persistent batch, one launch, the same
        # bits
        F.reset_counts()
        x_def, recs_def = solver.run_sweep(params, measures=measures)
        torch.cuda.synchronize()
        default = used_counts(F)
        require(np_bits(x_def, x_all) and all(np_bits(recs_def[k], recs[k])
                                              for k in recs)
                and default == ({"irls_persistent" if robust
                                 else "tik_persistent": 1}, {}),
                "phase 17: %s/%s default route launches %s, bits equal %s"
                % (reg, loss, default, np_bits(x_def, x_all)))
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
              "objective rel %.2e, voxel %.2e; launches %s (%.1f per solve; "
              "the linear sweeps on the forced sequence), on the default "
              "route %s with the same bits; "
              "plain calls 0; kernel %.3f ms/sweep, plain %.3f ms/sweep "
              "[%s]" % (reg, loss, len(alphas), iter_max, "" if not robust
                        else " x %d" % HUBER_CG,
                        {i: "%.2e" % d for i, d in devs.items()},
                        STUDY_ANCHOR_BAND, rec_dev, obj_rel, vox, launches,
                        sum(launches.values()) / len(alphas), default[0],
                        ms_k, ms_p, card))
        out[(reg, loss)] = {"launches": launches, "sweep": t_sweep,
                            "kernel": t_kernel, "ms": ms_k, "plain_ms": ms_p}
    return out


def run_admm_study_phase(device, card):
    """Phase 18: the TV-L2 ADMM study with records on Lena 256² through
    ``ADMMLinearSolver.run_sweep``, and ``run_deconvolution`` (linear TV-L2
    by ADMM) on the PNG. Returns the sweep's launch counts (one persistent
    launch a configuration; ``admm_record``'s from a 100³ robust solve with
    records past the persistent rule, on its default route)."""
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
    # one persistent launch a configuration (csrc/admm_persistent.cu,
    # records included), none of the launch sequence's units
    names = F.PERSISTENT_UNITS + F.ADMM_UNITS + F.RECORD_UNITS
    launches, plain_calls = F.launch_counts(names), F.plain_counts()
    require(launches["admm_persistent"] == len(grid)
            and all(n == 0 for k, n in launches.items()
                    if k != "admm_persistent"),
            "phase 18: not one persistent launch a configuration: %s"
            % launches)
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
    # the solve's bound: its units' bounds (bytes) at the launch counts of
    # the same solve as the launch sequence
    F.reset_counts()
    solve.sequence(b, b, a0, r0, record_dls=1.0 / xs)
    torch.cuda.synchronize()
    solve_bound = sum(unit_bound(k, 256 ** 2, (13, 13), nd=2)[0] * n
                      for k, n in F.launch_counts(F.ADMM_UNITS
                                                  + F.RECORD_UNITS).items())
    # admm_record's main path: the records of a robust (huber) solve past
    # the persistent rule (100³, its units marching), which the launch
    # sequence of csrc/robust.cu writes on the default route; every Lena
    # configuration's records, linear or robust, its persistent launch
    # writes itself
    its, sweeps, cgi = ROBUST_ITERS["lena"]
    vol = torch.as_tensor(np.random.RandomState(18).rand(
        *RECORD_SHAPE).astype(np.float32), device=device)
    rsolve = F.make_fused_admm_solver(RECORD_SHAPE, np.eye(3),
                                      iterations=its, iter_max=sweeps,
                                      data_loss="huber", irls_cg_iters=cgi,
                                      record=True)
    F.reset_counts()
    _, recs = rsolve(vol, vol, a0, r0, record_dls=1.0)
    torch.cuda.synchronize()
    rec_launches = used_counts(F)
    launches.update(F.launch_counts(F.RECORD_UNITS))
    require(rsolve.route == "sequence" and launches["admm_record"] == its + 1
            and "irls_persistent" not in rec_launches[0]
            and not rec_launches[1]
            and all(r.shape == (its + 1,) and bool(torch.isfinite(r).all())
                    for r in recs.values()),
            "phase 18: the 100^3 robust records take %s, launches %s"
            % (rsolve.route, rec_launches))
    del vol
    print("phase 18 TVL2 ADMM study Lena 256^2, 8 alphas x 2 rhos, %d x %d, "
          "records: anchor devs %s (band %g); last records vs measures of x "
          "%.2e; kernel vs plain objective rel %.2e, voxel %.2e, records "
          "%.2e; launches %s (admm_record: a 100^3 robust solve's records "
          "on its default route, the sequence); plain calls 0; kernel %.3f "
          "ms/solve, plain %.3f ms/solve, bound %.4f ms/solve [%s]"
          % (ITERATIONS, ITER_MAX, {k: "%.2e" % v for k, v in devs.items()},
             STUDY_ANCHOR_BAND, rec_dev, obj_rel, vox, rrel, launches,
             ms_k, ms_p, solve_bound, card))

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
        cli_launches = F.launch_counts(F.PERSISTENT_UNITS + F.ADMM_UNITS)
        require(cli_launches["admm_persistent"] == 1
                and all(n == 0 for k, n in cli_launches.items()
                        if k != "admm_persistent")
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
    study`` on the 64³ phantom (TK1L2) and on Lena (TVL2 by ADMM). Returns
    the sweep's launches (past the persistent rule: the launch sequence,
    ``tik_clip`` on entry and exit of each configuration)."""
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
    launches = unit_counts(F, ("normal_apply", "cg_step", "cg_update",
                               "tik_clip"))
    launches["cg_step (chain, march)"] = route_launches(F)["cg_step"]
    require(all(n > 0 for k, n in launches.items() if k in F.ADMM_UNITS
                + ("tik_clip",))
            and launches["cg_step (chain, march)"][0] == 0
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
            # TK1L2 on the forced launch sequence, its units counted (phase
            # 46 runs this CLI on both routes)
            with sequence_route(T, TIK_RULE) if rtype == "TK1L2" \
                    else contextlib.nullcontext():
                rc = study_cli.main([
                    "--observation", obs, "--reconstruction-type", rtype,
                    "--alpha-range", "0.005", "0.05", "4", "--study-name",
                    name, "--dir-output", out, "--device", "cuda"] + extra)
            require(rc == 0, "phase 19: study CLI %s returned %r" % (name, rc))
            # TK1L2: the Tikhonov sequence's units; TVL2 by ADMM: one
            # persistent launch a configuration and none of them
            units = ("normal_apply", "cg_step", "cg_update") + (
                ("tik_clip",) if rtype == "TK1L2"
                else ("admm_tail", "admm_record", "admm_persistent"))
            cli_launches = F.launch_counts(units)
            launched = {k: n > 0 for k, n in cli_launches.items()}
            want = {k: rtype == "TK1L2" or k == "admm_persistent"
                    for k in units}
            require(launched == want and (rtype == "TK1L2" or cli_launches[
                "admm_persistent"] == 4)
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
#: the seeds of phase 20's 512³ bit checks of the march
BIG_BIT_SEEDS = (204, 304, 404)
#: the 512³ "apply" objectives recorded in PERF.md (earlier chip runs); the
#: exact one is held to its printed digits (the kernels' arithmetic is
#: fixed), the compact ones are printed beside theirs
APPLY_OBJECTIVES = {"apply_exact": 165421.769, "apply_dirs": 165421.769,
                    "apply_state": 165520.905}
#: the tiled units' tile-edge cases: (label, cov, spacing, shape); the
#: last two copy their windows in 16-byte groups (X a multiple of 8) or
#: only their float ones (X a multiple of 4)
EDGE_CASES = (
    ("edge", np.diag([1.0] * 3), None, (13, 530, 37)),
    ("spacing", np.diag([1.0] * 3), (1.0, 1.5, 0.8), (70, 45, 33)),
    ("sigma_y>sigma_z", np.diag([0.64, 4.0, 0.64]), None, (16, 40, 37)),
    ("aniso", np.diag([1.3, 0.8, 1.1]) ** 2, (1.0, 1.5, 0.8), (13, 530, 37)),
    ("x%8", np.diag([1.0] * 3), None, (9, 36, 88)),
    ("x%4", np.diag([1.0] * 3), None, (9, 36, 76)))
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
    normal, step, blur, _, weighted = three_pass_units(B, R)
    return checks, {
        "normal_apply_zy": (
            lambda: T.normal_apply_zy(v, n, h2, RHO, scal=s[0]),
            lambda: T.normal_apply_zy_plain(v, n, h2, RHO, scal=s[1]),
            lambda: normal(v, n, h2, RHO), None),
        "cg_step_zy": (
            lambda: T.cg_step_zy(r, p, s[0], n, h2, RHO),
            lambda: T.cg_step_zy_plain(r, p, s[1], n, h2, RHO),
            lambda: step(r, p, s[2], n, h2, RHO), None),
        "blur_apply_zy": (
            lambda: T.blur_apply_zy(r, bl, h2, x, RHO, scal=s[0]),
            lambda: T.blur_apply_zy_plain(r, bl, h2, x, RHO, scal=s[1]),
            lambda: blur(r, bl, h2, x, RHO, scal=s[2]), None),
        "weighted_apply_zy": (
            lambda: T.weighted_apply_zy(r, p, free, wts, s[0], bl, h2, RHO),
            lambda: T.weighted_apply_zy_plain(r, p, free, wts, s[1], bl, h2,
                                              RHO),
            lambda: weighted(r, p, free, wts, s[2], bl, h2, RHO),
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


#: isotropic blurs about the widest the weighted march holds (13, 15, 15
#: and 17 taps a side)
FIT_SIGMAS = (2.0, 2.1, 2.3, 2.4)


def widest_weighted_blur(T, B):
    """``(σ, σ')``: the widest blur of :data:`FIT_SIGMAS` whose taps the
    weighted march's shared memory holds (``tiled.smem_bytes``, the
    routing rule), and the next one, which it does not."""
    fits = [T.smem_bytes(B.Stencils.from_cov(np.diag([s ** 2] * 3)).blur
                         .lengths, weighted=True) <= T.MAX_SMEM
            for s in FIT_SIGMAS]
    k = fits.index(False)
    require(k > 0 and not any(fits[k:]), "phase 20: the weighted march "
            "holds blurs %s" % dict(zip(FIT_SIGMAS, fits)))
    return FIT_SIGMAS[k - 1], FIT_SIGMAS[k]


def tiled_fit_checks(T, B, device):
    """The tiled units' shared memory: its size in C (``nsol_tiled_smem``)
    and in Python (``tiled.smem_bytes``, by which the solves route before
    any launch) agree; at the widest isotropic blur the weighted apply
    holds (:func:`widest_weighted_blur`) every unit matches its plain
    version; at the next one the weighted apply's wrapper raises before any
    launch. Returns that σ and the largest max |Δ| / max |ref| there."""
    import torch

    from nsol_tpu_torch.ops.cuda import build

    lib = build.load()
    for k in range(1, 60, 2):
        for lengths in ((k, k, k), (1, k, 3), (k, 5, 1)):
            for form in ((1, 1, 0), (2, 1, 0), (1, 0, 0), (1, 1, 1)):
                c = lib.nsol_tiled_smem(*lengths, *form, 0)
                py = T.smem_bytes(lengths, form[0], *map(bool, form[1:]))
                require(c == py, "phase 20: shared memory of %s %s: C %d, "
                        "Python %d" % (lengths, form, c, py))
    sigma, past = widest_weighted_blur(T, B)
    st = B.Stencils.from_cov(np.diag([sigma ** 2] * 3), 3, None, device)
    res = tiled_unit_pairs(T, B, st, (40, 64, 40), device,
                           np.random.RandomState(15))
    torch.cuda.synchronize()
    rel = max(max_rel(g, q) for v in res.values() for g, q in v)
    require(rel <= KERNEL_TOL, "phase 20: units at sigma %g rel %.3g"
            % (sigma, rel))
    wide = B.Stencils.from_cov(np.diag([past ** 2] * 3), 3, None, device)
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
    return sigma, rel


def three_pass_units(B, R):
    """The whole-volume units on their three-pass chains whatever the
    route takes (a package without the route: its units, the chains):
    ``(normal_apply, cg_step, blur_apply, irls_head, weighted_apply)`` with
    the wrappers' arguments."""
    if not hasattr(B, "_normal_apply"):
        return (B.normal_apply, B.cg_step, R.blur_apply, R.irls_head,
                R.weighted_apply)

    def normal(v, t, h2, rho, rhs=None, scal=None, io_dtype=None):
        return B._normal_apply(v, t, h2, rho, rhs, scal, "TK1", io_dtype,
                               "chain")

    def step(r, p, scal, t, h2, rho, first=False):
        return B._cg_step(r, p, scal, t, h2, rho, first, "TK1", "exact",
                          "chain")

    def blur(y, t, h2, u=None, rho=0.0, scal=None):
        return R._blur_apply(y, t, h2, u, rho, scal, "TK1", "chain")

    def head(x, b, t, loss, scale):
        return R._irls_head(x, b, t, loss, scale, "chain")

    def weighted(r, p, free, wts, scal, t, h2, rho):
        return R._weighted_apply(r, p, free, wts, scal, t, h2, rho, False,
                                 "TK1", "exact", "chain")

    return normal, step, blur, head, weighted


def tiled_three_pass_pairs(T, R, B, st, shape, device, seed):
    """Each form of the march units on the same random inputs as its
    three-pass unit (``csrc/stencil.cuh``'s per-axis passes):
    ``{form: (tiled outputs, three-pass outputs)}`` — ``normal_apply_zy``
    plain, dot and residual in float32 and bfloat16 io, ``cg_step_zy`` on
    the first trip and after (p', q), ``blur_apply_zy``'s ``A y``, with
    ``u``, its gradient (free, rk) and its head (wts, y) forms. The CG
    scalars are left out: their sums run in another order."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    v, r, p, x, rhs, b = (torch.rand(shape, generator=g, device=device)
                          - 0.3 for _ in range(6))
    vb, bf = v.to(torch.bfloat16), torch.bfloat16
    n, bl, h2 = st.normal, st.blur, st.inv_h2

    def s():
        return torch.tensor([3.0, 0.0, 0.0, 0.83], dtype=torch.float64,
                            device=device)

    def cat(t):
        return torch.cat([u.float() for u in t])

    normal, step, blur, head, _ = three_pass_units(B, R)
    return {
        "normal": (T.normal_apply_zy(v, n, h2, RHO),
                   normal(v, n, h2, RHO)),
        "normal dot": (T.normal_apply_zy(v, n, h2, RHO, scal=s()),
                       normal(v, n, h2, RHO)),
        "normal residual": (
            T.normal_apply_zy(v, n, h2, RHO, rhs=rhs, scal=s()),
            normal(v, n, h2, RHO, rhs=rhs, scal=s())),
        "normal[bf16]": (T.normal_apply_zy(vb, n, h2, RHO, io_dtype=bf),
                         normal(vb, n, h2, RHO, io_dtype=bf)),
        "normal[bf16] dot": (
            T.normal_apply_zy(vb, n, h2, RHO, scal=s(), io_dtype=bf),
            normal(vb, n, h2, RHO, io_dtype=bf)),
        "normal[bf16] residual": (
            T.normal_apply_zy(v, n, h2, RHO, rhs=rhs, scal=s(), io_dtype=bf),
            normal(v, n, h2, RHO, rhs=rhs, scal=s(), io_dtype=bf)),
        "cg_step": (cat(T.cg_step_zy(r, p, s(), n, h2, RHO)),
                    cat(step(r, p, s(), n, h2, RHO))),
        "cg_step first": (cat(T.cg_step_zy(r, p, s(), n, h2, RHO, True)),
                          cat(step(r, p, s(), n, h2, RHO, True))),
        "blur A y": (T.blur_apply_zy(v, bl, h2), blur(v, bl, h2)),
        "blur with u": (T.blur_apply_zy(v, bl, h2, x, RHO),
                        blur(v, bl, h2, x, RHO)),
        "blur gradient": (cat(T.blur_apply_zy(v, bl, h2, x, RHO, scal=s())),
                          cat(blur(v, bl, h2, x, RHO, scal=s()))),
        "blur head": (cat(T.blur_apply_zy(x, bl, h2, head=(b, "huber", 0.3))),
                      cat(head(x, b, bl, "huber", 0.3))),
    }


def window_route_pairs(B, st, shape, device, seed):
    """``normal_apply_prepadded``'s tiled march against its three-pass
    chain on one window of ``shape[0]`` planes per ``row0`` (the first, a
    middle and the last of a volume of 3 · ``shape[0]`` rows):
    ``{"row0 k": (tiled, chain)}``."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    h = B.prepadded_halo(st.normal)
    ext = torch.rand((shape[0] + 2 * h,) + tuple(shape[1:]), generator=g,
                     device=device)
    out = {}
    for row0 in (0, shape[0], 2 * shape[0]):
        args = (ext, st.normal, st.inv_h2, RHO, row0, 3 * shape[0])
        out["row0 %d" % row0] = (
            B._normal_apply_prepadded(*args, chain=False),
            B._normal_apply_prepadded(*args, chain=True))
    return out


def require_bits(pairs, what):
    """Fail the phase unless every pair of ``pairs`` holds the same bits;
    return the forms checked, as text."""
    import torch

    torch.cuda.synchronize()

    def same(a, b):  # the stored bits: a -0 differs from a +0
        if a.dtype != b.dtype:
            a, b = a.float(), b.float()
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        return torch.equal(a.view(ints[a.element_size()]),
                           b.view(ints[b.element_size()]))

    differ = {k: float((a.float() - b.float()).abs().max())
              for k, (a, b) in pairs.items() if not same(a, b)}
    require(not differ, "%s: not bit for bit: %s" % (what, differ))
    return ", ".join(pairs)


def _cg_scalars(device):
    import torch

    return torch.tensor([3.0, 0.0, 0.0, 0.83], dtype=torch.float64,
                        device=device)


def weighted_inputs(shape, device, seed):
    """``(r, p, wts, free)`` of the weighted applies on the card, from a
    seeded generator: r, p in [-0.5, 0.5), wts in [0.1, 1.1), free a
    {0, 1} field."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    r, p = (torch.rand(shape, generator=g, device=device) - 0.5
            for _ in range(2))
    wts = torch.rand(shape, generator=g, device=device) + 0.1
    free = (torch.rand(shape, generator=g, device=device) > 0.3).float()
    return r, p, wts, free


def weighted_three_pass_bits(T, R, st, shape, device, seed):
    """``weighted_apply_zy`` against the three-pass ``weighted_apply`` on
    the same random inputs, in every storage mode, masked or not, on the
    first trip and after: fails unless p' and q hold the same bits in
    each, and returns the forms checked, as text. The CG scalars are left
    out: their sums run in another order. One form at a time, so that
    512³ fits beside the inputs."""
    import torch

    r, p, wts, free = weighted_inputs(shape, device, seed)
    forms = []
    for storage in R.ROBUST_STORAGE:
        ps = p.to(R.direction_dtype(storage) or torch.float32)
        for f in (free, None):
            for first in (False, True):
                form = "%s%s%s" % (storage, "" if f is None else " masked",
                                   " first" if first else "")
                kw = dict(first=first, storage=storage)
                got = T.weighted_apply_zy(r, ps, f, wts, _cg_scalars(device),
                                          st.blur, st.inv_h2, RHO, **kw)
                ref = R.weighted_apply(r, ps, f, wts, _cg_scalars(device),
                                       st.blur, st.inv_h2, RHO, **kw)
                require_bits({form + " p'": (got[0], ref[0]),
                              form + " q": (got[1], ref[1])},
                             "weighted march %s seed %d" % (
                                 "x".join(map(str, shape)), seed))
                forms.append(form)
                del got, ref
    return ", ".join(forms)


def weighted_turns(T, st, shape, device, seed, reps=5):
    """Device ms (:func:`device_ms_of`) of ``weighted_apply_zy``'s float32
    and "io" instances in the main paths' form (masked, after the first
    trip), in turns f32, io, io, f32: ``{"exact": [ms, ms], "io": [ms,
    ms]}``."""
    import torch

    r, p, wts, free = weighted_inputs(shape, device, seed)
    pb = p.to(torch.bfloat16)
    calls = {
        "exact": lambda: T.weighted_apply_zy(r, p, free, wts,
                                             _cg_scalars(device), st.blur,
                                             st.inv_h2, RHO),
        "io": lambda: T.weighted_apply_zy(r, pb, free, wts,
                                          _cg_scalars(device), st.blur,
                                          st.inv_h2, RHO, storage="io")}
    out = {"exact": [], "io": []}
    for k in ("exact", "io", "io", "exact"):
        out[k].append(device_ms_of(calls[k], reps))
    return out


def weighted_window(R):
    """``R._weighted_apply_prepadded`` (its ``chain`` argument picks the
    route), or None for a package whose window unit has one route, the
    three-pass chain, and so no such helper."""
    return getattr(R, "_weighted_apply_prepadded", None)


def weighted_window_pairs(R, st, shape, device, seed):
    """``weighted_apply_prepadded``'s tiled march against its three-pass
    chain on one window of ``shape[0]`` planes per ``row0`` (the first, a
    middle and the last of a volume of 3 · ``shape[0]`` rows), in float32
    and in bfloat16 io: ``{"f32 row0 k": (tiled, chain), ...}`` (empty
    where :func:`weighted_window` is None)."""
    import torch

    helper = weighted_window(R)
    if helper is None:
        return {}
    g = torch.Generator(device=device).manual_seed(seed)
    h = R.weighted_halo(st.blur)
    ext = (shape[0] + 2 * h,) + tuple(shape[1:])
    v = torch.rand(ext, generator=g, device=device)
    w = torch.rand(ext, generator=g, device=device) + 0.1
    out = {}
    for label, dtype in (("f32", torch.float32), ("io", torch.bfloat16)):
        vd, wd = v.to(dtype), w.to(dtype)
        for row0 in (0, shape[0], 2 * shape[0]):
            args = (vd, wd, st.blur, st.inv_h2, RHO, row0, 3 * shape[0])
            out["%s row0 %d" % (label, row0)] = (helper(*args, chain=False),
                                                 helper(*args, chain=True))
    return out


def kernel_ptxas(kernel, threads):
    """The ptxas report of ``csrc/tiled.cu``'s ``kernel``, one entry an
    instance: ``{its template arguments: (registers, spill bytes, resident
    warps an SM by its registers)}`` for blocks of ``threads`` (65536
    registers an SM, allocated 256 a warp; at most 64 warps an SM). Empty
    where the library came from the cache."""
    from nsol_tpu_torch.ops.cuda import build

    warps = threads // 32
    out, entry, spills = {}, None, 0
    for ln in build.build_info.get("ptxas", "").splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
            entry = entry if kernel in entry else None
        elif entry and "spill stores" in ln:  # reported before "Used"
            spills = int(ln.split("bytes spill stores")[0].split()[-1])
        elif entry and "registers" in ln:
            regs = int(ln.split("Used")[1].split()[0])
            per_warp = -(-regs * 32 // 256) * 256
            blocks = min(64 // warps, 65536 // (per_warp * warps))
            out[entry.split(kernel, 1)[1].split("Ev")[0]] = (
                regs, spills, warps * blocks)
            entry = None
    return out


def march_ptxas():
    """:func:`kernel_ptxas` of the single-stencil march
    (``stencil_zy_kernel``, 128-thread blocks)."""
    return kernel_ptxas("stencil_zy_kernel", 128)


#: threads a block of the weighted march (``csrc/tiled.cu``'s
#: kWeightedThreads)
WEIGHTED_THREADS = 256


def weighted_ptxas():
    """:func:`kernel_ptxas` of the weighted march (``weighted_zy_kernel``,
    :data:`WEIGHTED_THREADS`-thread blocks)."""
    return kernel_ptxas("weighted_zy_kernel", WEIGHTED_THREADS)


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
    checked = stream_edge_checks(("cg_direction",), device)
    print("phase 20 cg_direction vs plain %s, in place: %d kernel calls "
          "within their band, the same bits at every offset"
          % (stream_cases_text(), checked))
    fit_sigma, fit_rel = tiled_fit_checks(T, B, device)
    print("phase 20 shared memory: C and Python sizes agree; units at "
          "sigma %g (blur %s taps, the widest the weighted march holds) vs "
          "plain %.2e; sigma %g refused before launch" % (
              fit_sigma, B.Stencils.from_cov(
                  np.diag([fit_sigma ** 2] * 3)).blur.lengths, fit_rel,
              widest_weighted_blur(T, B)[1]))
    # ... each march unit, every form, bit for bit against its three-pass
    # unit: the tile-edge shapes (the runtime-length instance where the
    # taps differ from 13 / 7 a side) and 512³ (a multi-wave grid) on
    # BIG_BIT_SEEDS
    for i, (label, cov, sp, shape) in enumerate(EDGE_CASES + (
            ("512^3", np.diag([SIGMA ** 2] * 3), None, BIG),)):
        st = B.Stencils.from_cov(cov, 3, sp, device)
        for seed in BIG_BIT_SEEDS if shape == BIG else (200 + i,):
            forms = require_bits(tiled_three_pass_pairs(T, R, B, st, shape,
                                                        device, seed),
                                 "phase 20 %s seed %d" % (label, seed))
            torch.cuda.empty_cache()
    print("phase 20 march units equal their three-pass units bit for bit "
          "on %s, 512^3 (seeds %s): %s" % (
              ", ".join(c[0] for c in EDGE_CASES),
              ", ".join(map(str, BIG_BIT_SEEDS)), forms))
    print("phase 20 march ptxas (template arguments: registers, spill "
          "bytes, resident warps an SM of 64 by registers): %s"
          % (march_ptxas() or "cached"))
    # ... the weighted march, every storage mode and form, bit for bit
    # against the three-pass weighted_apply on the same cases
    for i, (label, cov, sp, shape) in enumerate(EDGE_CASES + (
            ("512^3", np.diag([SIGMA ** 2] * 3), None, BIG),)):
        st = B.Stencils.from_cov(cov, 3, sp, device)
        for seed in BIG_BIT_SEEDS if shape == BIG else (210 + i,):
            forms = weighted_three_pass_bits(T, R, st, shape, device, seed)
            torch.cuda.empty_cache()
    print("phase 20 weighted march equals the three-pass weighted_apply bit "
          "for bit (p', q) on %s, 512^3 (seeds %s): %s" % (
              ", ".join(c[0] for c in EDGE_CASES),
              ", ".join(map(str, BIG_BIT_SEEDS)), forms))
    print("phase 20 weighted march ptxas (template arguments: registers, "
          "spill bytes, resident warps an SM of 64 by registers, %d-thread "
          "blocks): %s" % (WEIGHTED_THREADS, weighted_ptxas() or "cached"))
    st = B.Stencils.from_cov(np.diag([SIGMA ** 2] * 3), 3, None, device)
    w_turns = weighted_turns(T, st, BIG, device, 23)
    torch.cuda.empty_cache()
    print("phase 20 weighted_apply_zy 512^3 device ms (torch.profiler "
          "medians, masked, turns f32, io, io, f32): f32 %s, io %s; bound "
          "f32 %.4f, io %.4f [%s]" % (
              "/".join(map(ms_text, w_turns["exact"])),
              "/".join(map(ms_text, w_turns["io"])),
              unit_bound("weighted_apply_zy", BIG_N, TILED_TAPS[
                  "weighted_apply_zy"])[0],
              compact_bound("weighted_apply_zy[io]", BIG)[0], card))
    # ... and at 512³: times beside the plain version and the three-pass unit
    st = B.Stencils.from_cov(np.diag([SIGMA ** 2] * 3), 3, None, device)
    checks, calls = tiled_calls(T, R, B, st, BIG, device,
                                np.random.RandomState(21))
    times, err, dev_t = {}, {}, {}
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
        if k == "cg_direction":  # device times beside torch.add's
            dev_t[k] = device_turns(kf, lf, 50)
        else:  # the march's device time beside the three-pass unit's
            dev_t[k] = {"kernel": [device_ms_of(kf, 10)],
                        "library": [device_ms_of(tf, 5)]}
    del calls, checks
    torch.cuda.empty_cache()
    print("phase 20 512^3 a wrapper call by CUDA events (tiled / plain / "
          "three-pass / library ms, bound ms): %s [%s]" % (", ".join(
              "%s %.3f/%.1f/%s/%s, %.3f" % (
                  k, t[0], t[1], *("-" if u is None else "%.3f" % u
                                   for u in t[2:]),
                  unit_bound(k, int(np.prod(BIG)), TILED_TAPS[k])[0])
              for k, t in times.items()), card))
    print("phase 20 512^3 device ms (torch.profiler medians; tiled / "
          "three-pass, bound ms): %s [%s]" % (", ".join(
              "%s %s/%s, %.4f" % (
                  k, ms_text(d["kernel"][0]), ms_text(d["library"][0]),
                  unit_bound(k, BIG_N, TILED_TAPS[k])[0])
              for k, d in dev_t.items() if k != "cg_direction"), card))
    dt_ = dev_t["cg_direction"]
    b_ms = unit_bound("cg_direction", BIG_N)[0]
    print("phase 20 cg_direction 512^3 (bound %.4f ms): device ms (torch."
          "profiler, turns torch.add, kernel, kernel, torch.add) kernel %s, "
          "torch.add %s (kernel records a call %s); %s [%s]"
          % (b_ms, span(dt_["kernel"]), span(dt_["library"]),
             dt_["kernels"], turn_gaps(dt_, b_ms), card))
    print("phase 20 stream kernels' ptxas (registers, resident warps an SM "
          "of 64): %s" % (stream_ptxas() or "cached"))
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
        require(solve.mode != "apply" or "%.3f" % obj == "%.3f"
                % APPLY_OBJECTIVES["apply_exact"], "phase 21: the exact "
                "\"apply\" objective %.6f is not the recorded %.3f" % (
                    obj, APPLY_OBJECTIVES["apply_exact"]))
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
    print("phase 21 linear 512^3 %dx%d: objective apply %.3f, step2d %.3f, "
          "fused %.3f (anchor %.1f, band %.1f%%); apply %.1f/%.1f ms "
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
            "times": {k: (t[0], t[1], t[3], mean_ms(dev_t[k]["kernel"]),
                          mean_ms(dev_t[k]["library"])
                          if k == "cg_direction" else None)
                      for k, t in times.items()}}


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
                      "nsol_tpu_torch/csrc/admm.cu", "fused96", 4 + 2 + 2 + 4,
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
    # the "apply" CG's p = r + β·p, left to XLA by the JAX package; under
    # bf16 state its deferred form r' = r − a·q, p = r' + β·p
    "cg_direction[bf16]": ("cg_direction", None,
                           "nsol_tpu_torch/csrc/stream.cuh", "apply_dirs",
                           4 + 2 + 2, 0),
    "cg_direction[state]": ("cg_direction", None,
                            "nsol_tpu_torch/csrc/stream.cuh", "apply_state",
                            2 + 2 + 2 + 2 + 2, 0),
}
#: the shape each main path of phase 24 runs at (96³: a fused compact
#: solve past the persistent route, on the launch sequence)
COMPACT_SHAPES = {"fused96": (96, 96, 96), "step_dirs": SCALE_SHAPE,
                  "step_state": SCALE_SHAPE, "sweep_f32": SCALE_SHAPE,
                  "sweep_bf16": SCALE_SHAPE, "apply_dirs": BIG,
                  "apply_state": BIG}


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


def same_nan(pairs, what):
    """Each (kernel, plain) pair has NaN at the same entries."""
    import torch

    for k, (g, f) in enumerate(pairs):
        require(torch.equal(torch.isnan(g.float()), torch.isnan(f.float())),
                "%s: output %d has NaN where plain has none, or none where "
                "it has" % (what, k))


def sweep_nan_case(B, st, shape, device, dtype):
    """The sweep (a later trip, storage ``dtype``) with one NaN in p: q'
    and the dots pq, rq, qq turn NaN while g stays finite, so the
    recurrence's γ' = max(g − 2a·rq + a²·qq, 0) is NaN and β too, as under
    jnp.maximum (blocked.py:1507) and in the plain version. Kernel against
    plain: NaN at the same entries of x, q', r', p' and the scalars, and
    β NaN. Fails the phase on a miss."""
    import torch

    rng = np.random.RandomState(23)
    x, r, p, q = (torch.as_tensor(rng.rand(*shape).astype(np.float32) - 0.5,
                                  device=device) for _ in range(4))
    p.view(-1)[p.numel() // 2] = float("nan")
    outs = []
    for fn in (B.cg_sweep, B.cg_sweep_plain):
        scal, xs, qs = _scal(device), x.clone(), q.to(dtype).clone()
        rp = fn(xs, r.to(dtype), p.to(dtype), qs, scal, st.normal,
                st.inv_h2, RHO)
        outs.append([xs, qs, *rp, scal])
    what = "cg_sweep %s with a NaN in p" % str(dtype).split(".")[-1]
    same_nan(list(zip(*outs)), what)
    require(bool(torch.isnan(outs[0][-1][B.BETA])), "%s: beta is not NaN"
            % what)


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
    elif name == "cg_direction[state]":
        # the deferred form: r' = r − a·q in place, p = r' + β·p
        units = (T.cg_direction, T.cg_direction_plain)
        ps, rs = own(pb), own(rb)

        def call(k):
            units[k](ps[k], rs[k], s[k], q=qb)
            return [ps[k], rs[k]]

        twin = None
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
    for dt in (torch.float32, bf):
        sweep_nan_case(B, st, (13, 45, 37), device, dt)
    print("phase 23 cg_sweep (f32, bf16) with a NaN in p: NaN at the same "
          "entries as plain, beta NaN as under jnp.maximum")
    checked = stream_edge_checks(("cg_direction[bf16]", "cg_direction[state]"),
                                 device)
    print("phase 23 cg_direction[bf16], [state] vs plain %s, in place: %d "
          "kernel calls within one bf16 ulp, the same bits at every offset"
          % (stream_cases_text(), checked))
    # ... and at each main path's shape, in the form it runs there: held to
    # the same bands, and timed beside the plain version
    iso = np.diag([SIGMA ** 2] * 3)
    st = B.Stencils.from_cov(iso, 3, None, device)
    times, err, dev_t = {}, {}, {}
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
        if u[0] == "cg_direction":  # device times beside torch.add's
            dev_t[k] = device_turns(kf, lf, 50)
        if k == "normal_apply_zy[bf16]":  # in turns with its f32 instance
            zy_turns = [device_ms_of(f, 10) for f in (tf, kf, kf, tf)]
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
    print("phase 23 normal_apply_zy 512^3 dot form, device ms (torch."
          "profiler medians, turns f32, bf16, bf16, f32): %s; bf16 bound "
          "%.4f ms, f32 bound %.4f ms [%s]" % (
              "/".join(map(ms_text, zy_turns)),
              compact_bound("normal_apply_zy[bf16]", BIG)[0],
              unit_bound("normal_apply_zy", BIG_N, TILED_TAPS[
                  "normal_apply_zy"])[0], card))
    for k, d in dev_t.items():
        b_ms = compact_bound(k, BIG)[0]
        print("phase 23 %s 512^3 (bound %.4f ms): device ms (torch.profiler, "
              "turns torch.add, kernel, kernel, torch.add) kernel %s, "
              "torch.add %s (kernel records a call %s); %s [%s]" % (
                  k, b_ms, span(d["kernel"]),
                  span(d["library"]) if d["library"] is not None else "none",
                  d["kernels"], turn_gaps(d, b_ms), card))
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
    # 64³: one persistent launch (csrc/admm_persistent.cu); 96³, past its
    # rule (the residual's normal_apply marches there): the launch
    # sequence, whose cg_step[qf32] runs on the chain
    require(launches["fused64"] == {"admm_persistent": 1},
            "phase 24: 64^3 compact launches %s" % launches["fused64"])
    held_to_plain("fused64", partial(F.make_fused_admm_solver, (64,) * 3,
                                     iso, iter_max=ITER_MAX),
                  dict(precision="high3", compact_dirs=True), b64, obj64)
    b96, _, A96 = compact_problem(device, COMPACT_SHAPES["fused96"])
    run("fused96", F.make_fused_admm_solver(
        COMPACT_SHAPES["fused96"], iso, iterations=ITERATIONS,
        iter_max=ITER_MAX, precision="high3", compact_dirs=True), b96,
        lambda x: objective_device(x, b96, A96, ALPHA))
    require(launches["fused96"].get("cg_step") == ITERATIONS * ITER_MAX
            and "admm_persistent" not in launches["fused96"],
            "phase 24: 96^3 compact launches %s" % launches["fused96"])
    del b96
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
        lc = launches[key]  # the sweeps on its chain or its march
        require(lc.get("cg_sweep", 0) + lc.get("cg_sweep_march", 0)
                == ITERATIONS * ITER_MAX
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
    print("phase 24 512^3 \"apply\" objectives (this run / PERF.md): %s"
          % ", ".join("%s %.3f / %.3f" % (k, runs[k][0], v)
                      for k, v in APPLY_OBJECTIVES.items()))
    require("%.3f" % runs["apply_exact"][0]
            == "%.3f" % APPLY_OBJECTIVES["apply_exact"],
            "phase 24: the exact 512^3 objective %.6f is not the recorded "
            "%.3f" % (runs["apply_exact"][0], APPLY_OBJECTIVES["apply_exact"]))
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
        routed(out[-1], launches[path])
        if name in dev_t:
            d = dev_t[name]
            out[-1].update(device_ms=mean_ms(d["kernel"]),
                           library_device_ms=mean_ms(d["library"]))
        if name == "normal_apply_zy[bf16]":
            out[-1].update(device_ms=mean_ms(zy_turns[1:3]),
                           library_device_ms=None)
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
    from nsol_tpu_torch.ops.cuda import tiled as T
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
    for i, (label, cov, sp, shape) in enumerate(EDGE_CASES + (
            ("image", np.diag([1.0] * 3), None, (1, 40, 33)),)):
        st = B.Stencils.from_cov(cov, 3, sp, device)
        # normal_apply_prepadded's and weighted_apply_prepadded's tiled
        # marches equal their three-pass chains
        require_bits(window_route_pairs(B, st, shape, device, 260 + i),
                     "phase 26 normal_apply_prepadded %s" % label)
        w_forms = require_bits(weighted_window_pairs(R, st, shape, device,
                                                     270 + i),
                               "phase 26 weighted_apply_prepadded %s" % label)
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
        print("phase 26 window units %s %s: %s; normal_apply_prepadded "
              "tiled = three-pass chain bit for bit at row0 0, %d, %d; "
              "weighted_apply_prepadded tiled = chain bit for bit: %s" % (
                  label, "x".join(map(str, shape)),
                  ", ".join("%s %.2e" % kv for kv in rels.items()),
                  shape[0], 2 * shape[0], w_forms or "no tiled route"))
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
        if name == "normal_apply_prepadded":
            # device ms of the tiled window in turns with the whole-volume
            # march (its plain form), and of the three-pass chain
            def zy():
                return T.normal_apply_zy(vc, st.normal, st.inv_h2, RHO)

            def chain():
                return B._normal_apply_prepadded(v, st.normal, st.inv_h2,
                                                 RHO, 0, BIG[0], chain=True)

            require(B.window_route(st.normal) == "tiled", "phase 26: the "
                    "sigma = 1 window does not take the tiled march")
            win_dev = [device_ms_of(f, 10) for f in (zy, kf, kf, zy, chain)]
        if name == "weighted_apply_prepadded":
            # device ms of the window, f32 and io, in turns with the
            # whole-volume weighted march in the window's form (no mask,
            # first trip), and of the three-pass chains
            helper = weighted_window(R)
            vb, wb = v.to(torch.bfloat16), w.to(torch.bfloat16)

            def wzy():
                return T.weighted_apply_zy(vc, None, None, wc,
                                           _cg_scalars(device), st.blur,
                                           st.inv_h2, RHO, first=True)

            def wio():
                return R.weighted_apply_prepadded(vb, wb, st.blur, st.inv_h2,
                                                  RHO, 0, BIG[0])

            def wchain(a, b):
                if helper is None:  # the window unit is the chain
                    return lambda: R.weighted_apply_prepadded(
                        a, b, st.blur, st.inv_h2, RHO, 0, BIG[0])
                return lambda: helper(a, b, st.blur, st.inv_h2, RHO, 0,
                                      BIG[0], chain=True)

            require(helper is None or B.window_route(st.blur, True)
                    == "tiled", "phase 26: the sigma = 1 weighted window "
                    "does not take the tiled march")
            wwin_dev = [device_ms_of(f, 5) for f in (
                wzy, kf, wio, wio, kf, wzy, wchain(v, w), wchain(vb, wb))]
            del vb, wb
        if with_lap:
            del vc, wc
        del v, w, kf, pf
        torch.cuda.empty_cache()
    taps = {"normal_apply_prepadded": st.normal.lengths,
            "blur_apply_prepadded": st.blur.lengths,
            "weighted_apply_prepadded": st.blur.lengths}
    print("phase 26 normal_apply_prepadded 512^3 (%d planes in), device ms "
          "(torch.profiler medians, turns whole-volume normal_apply_zy, "
          "window, window, normal_apply_zy): %s; the three-pass chain %s "
          "[%s]" % (BIG[0] + 2 * B.prepadded_halo(st.normal),
                    "/".join(map(ms_text, win_dev[:4])), ms_text(win_dev[4]),
                    card))
    w_ratio = (BIG[0] + 2.0 * R.weighted_halo(st.blur)) / BIG[0]
    w_reads = window_reads(B, R, "weighted_apply_prepadded", st, BIG[0])
    print("phase 26 weighted_apply_prepadded 512^3 (%d planes in), device ms "
          "(torch.profiler medians, turns whole-volume weighted_apply_zy in "
          "the window's form, window f32, window io, io, f32, "
          "weighted_apply_zy): %s; the three-pass chains f32 %s, io %s; "
          "bound f32 %.4f, io %.4f [%s]" % (
              BIG[0] + 2 * R.weighted_halo(st.blur),
              "/".join(map(ms_text, wwin_dev[:6])), ms_text(wwin_dev[6]),
              ms_text(wwin_dev[7]),
              unit_bound("weighted_apply_prepadded", BIG_N, st.blur.lengths,
                         ext=w_ratio, reads=w_reads)[0],
              unit_bound("weighted_apply_prepadded", BIG_N, st.blur.lengths,
                         ext=w_ratio, reads=w_reads)[0] / 2, card))
    print("phase 26 512^3 a wrapper call by CUDA events (window / plain / "
          "whole-volume per-axis unit ms, bound ms): %s; the blur without "
          "its Laplacian term (A y) %.3f "
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
                                     "conv_z_pass", "stencil_zy_kernel")),
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
        rob = dict(F.launch_counts(F.SHARDED_UNITS + F.MARCH_UNITS),
                   **unit_counts(F, F.SHARDED_UNITS))
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
                                      "weighted_apply_prepadded",
                                      "blur_apply_prepadded_march")
                                     if k in rob}),
            "err": err,
            "times": {k: (t[0], t[1], t[2]) + (
                (mean_ms(win_dev[1:3]), None)
                if k == "normal_apply_prepadded" else
                (mean_ms([wwin_dev[1], wwin_dev[4]]), None)
                if k == "weighted_apply_prepadded" else ())
                for k, t in times.items()},
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
    # the fused solves on their launch sequence, its units counted (phase
    # 47 holds the persistent launch to it)
    with robust_sequence():
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
    with robust_sequence():
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
    require(launches["scale_io"].get("weighted_apply_march")
            == its * sweeps * cgi
            and "weighted_apply" not in launches["scale_io"],
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
                    # on the launch sequence, its units counted
                    with robust_sequence():
                        rc = run_deconvolution.main([
                            "--observation", obs, "--result", out,
                            "--solver", "ADMM", "--reconstruction-type",
                            "TVL2", "--data-loss", "huber", "--alpha",
                            str(ALPHA), "--blur", str(SIGMA), "--iterations",
                            str(its), "--iter-max", str(sweeps),
                            "--irls-cg-iters", str(cgi), "--device", "cuda"])
                    counts = unit_counts(F)
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
        a_list = [float(a) for a in alphas]
        kw = dict(reg=reg, iter_max=iter_max, data_loss=loss,
                  irls_cg_iters=HUBER_CG)
        solves = [partial(Tk.make_fused_tikhonov_solver(b.shape, cov, **kw,
                                                        **opt),
                          b, b, a_list, HUBER_SCALE)
                  for opt in (FUSED_COMPACT, {})]
        # the launch sequence's storage-typed units (the linear sweeps
        # forced onto it; phase 46 holds the persistent batch to it)
        with sequence_route(Tk, TIK_RULE):
            torch.cuda.synchronize()
            F.reset_counts()
            x_all, recs = solver.run_sweep(
                {"alpha": alphas.astype(np.float64)}, measures=measures)
            torch.cuda.synchronize()
            sweep_launches[key] = {k: v for k, v in F.launch_counts().items()
                                   if v}
            require(all(n == 0 for n in F.plain_counts().values()),
                    "phase 31: %s sweep ran a plain version" % key)
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
        routed(out[-1], path_launches[path])
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
        "nsol_tpu_torch/csrc/tiled.cu"),
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
                require(pd_on_sequence(launches[mode])
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
                require(rc == 0 and pd_on_sequence(cli)
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
                and counts == PD_ONE_LAUNCH, "phase 34: Lena under "
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


# ------------------------------------------------------- phases 36-38 --

#: a volume past the fused fit whose Y and X are no tile multiples
RAGGED_SHAPE = (136, 240, 200)
#: the seeds of phase 36's bit checks at 256³ and on the ragged volume
VOL_SEEDS = (606, 707)
#: the whole-volume units that run on a march or on their three-pass chain
#: (``tiled.vol_route``): their march form's count, the march's source
#: and the chain's
MARCH_FORMS = {
    "cg_step": ("cg_step_march", "nsol_tpu_torch/csrc/step_march.cu",
                "nsol_tpu_torch/csrc/admm.cu"),
    "cg_sweep": ("cg_sweep_march", "nsol_tpu_torch/csrc/sweep_march.cu",
                 "nsol_tpu_torch/csrc/admm.cu"),
    "weighted_apply": ("weighted_apply_march",
                       "nsol_tpu_torch/csrc/weighted_march.cu",
                       "nsol_tpu_torch/csrc/robust.cu"),
    "normal_apply": ("normal_apply_march",
                     "nsol_tpu_torch/csrc/normal_march.cu",
                     "nsol_tpu_torch/csrc/admm.cu"),
    "blur_apply": ("blur_apply_march", "nsol_tpu_torch/csrc/blur_march.cu",
                   "nsol_tpu_torch/csrc/robust.cu"),
    "irls_head": ("irls_head_march", "nsol_tpu_torch/csrc/blur_march.cu",
                  "nsol_tpu_torch/csrc/robust.cu"),
    "blur_apply_prepadded": ("blur_apply_prepadded_march",
                             "nsol_tpu_torch/csrc/blur_march.cu",
                             "nsol_tpu_torch/csrc/robust.cu")}
#: the private entry of each whole-volume unit that takes a forced route
#: (absent in a package where the unit has no march)
ROUTED = {"cg_step": ("B", "_cg_step"), "weighted_apply": ("R",
                                                          "_weighted_apply"),
          "normal_apply": ("B", "_normal_apply"),
          "blur_apply": ("R", "_blur_apply"), "irls_head": ("R", "_irls_head"),
          "cg_sweep": ("B", "_cg_sweep")}


def has_march(B, R, unit):
    """Whether the package of ``B`` (blocked) and ``R`` (robust) routes the
    whole-volume ``unit`` between a march and its chain."""
    mod, name = ROUTED[unit]
    return hasattr({"B": B, "R": R}[mod], name)
#: the units whose march forms phase 36 holds to their chains (the
#: sweep's: phase 40)
VOL_BIT_UNITS = ("cg_step", "weighted_apply", "normal_apply", "blur_apply",
                 "irls_head")
#: blurs past each march's shared memory (σ 3.5: cg_step's normal taps 45;
#: σ 2.5: weighted_apply's blur taps 17), whose solves take the chains
CHAIN_SIGMAS = {"cg_step": 3.5, "weighted_apply": 2.5}
#: the forms phase 37 times: label → (unit, storage, regulariser); the
#: weighted applies masked, every form after the first trip, as the CG
#: runs them
VOL_FORMS = {
    "cg_step[exact]": ("cg_step", "exact", "TK1"),
    "cg_step[qf32]": ("cg_step", "qf32", "TK1"),
    "cg_step[dirs]": ("cg_step", "dirs", "TK1"),
    "cg_step[state]": ("cg_step", "state", "TK1"),
    "cg_step[exact,TK0]": ("cg_step", "exact", "TK0"),
    "weighted_apply[exact]": ("weighted_apply", "exact", "TK1"),
    "weighted_apply[dirs]": ("weighted_apply", "dirs", "TK1"),
    "weighted_apply[io]": ("weighted_apply", "io", "TK1"),
    "normal_apply[residual]": ("normal_apply", "residual", "TK1"),
    "normal_apply[residual,bf16]": ("normal_apply", "residual_bf16", "TK1"),
    "normal_apply[residual,TK0]": ("normal_apply", "residual", "TK0"),
    "normal_apply[plain]": ("normal_apply", "plain", "TK1"),
    "normal_apply[plain,bf16]": ("normal_apply", "plain_bf16", "TK1"),
    "normal_apply[A^T b]": ("normal_apply", "atb", "TK1"),
    "blur_apply[gradient]": ("blur_apply", "gradient", "TK1"),
    "blur_apply[gradient,TK0]": ("blur_apply", "gradient", "TK0"),
    "blur_apply[u]": ("blur_apply", "u", "TK1"),
    "blur_apply[plain]": ("blur_apply", "plain", "TK1"),
    "irls_head[huber]": ("irls_head", "huber", "TK1")}
#: thin stacks past 2^20 voxels (few planes, 256-1024 wide), on which
#: phase 37 times the chain against the march for the route's depth side
THIN_SHAPES = ((2, 512, 1025), (4, 500, 600), (8, 384, 384),
               (12, 320, 320), (16, 256, 320), (24, 256, 256),
               (32, 256, 256), (8, 1024, 1024), (16, 512, 512))
#: the forms of the host-bound shapes phase 37 routes by (64³, Lena 256²)
ROUTE_FORMS = ("cg_step[exact]", "cg_step[qf32]", "cg_step[exact,TK0]",
               "weighted_apply[exact]", "weighted_apply[dirs]",
               "normal_apply[residual]", "normal_apply[residual,bf16]",
               "blur_apply[gradient]", "blur_apply[plain]",
               "irls_head[huber]")
#: bytes a voxel each storage mode moves (inputs read once, outputs
#: written once): cg_step r, p in, p', q out; weighted_apply r, p, free,
#: wts in, p', q out
VOL_BYTES = {("cg_step", "exact"): 16, ("cg_step", "qf32"): 12,
             ("cg_step", "dirs"): 10, ("cg_step", "state"): 8,
             ("weighted_apply", "exact"): 24, ("weighted_apply", "dirs"): 20,
             ("weighted_apply", "io"): 20,
             # x, rhs in, r out (a bf16 r: 2); v in, q out
             ("normal_apply", "residual"): 12,
             ("normal_apply", "residual_bf16"): 10,
             ("normal_apply", "plain"): 8, ("normal_apply", "plain_bf16"): 4,
             ("normal_apply", "atb"): 8,
             # y, x in, free, rk out; y, u in, g out; y in, g out
             ("blur_apply", "gradient"): 16, ("blur_apply", "u"): 12,
             ("blur_apply", "plain"): 8,
             # x, b in, wts, y out
             ("irls_head", "huber"): 16}
#: taps an axis of each unit's chain(s) at σ = 1, and whether it runs the
#: Laplacian: the normal taps, one blur chain, two (weighted)
VOL_TAPS = {"cg_step": 13, "normal_apply": 13, "blur_apply": 7,
            "irls_head": 7, "weighted_apply": 14}


def unit_counts(F, names=None):
    """``F.launch_counts(names)``, a unit of :data:`MARCH_FORMS` counting
    the launches of its chain and of its march (0 in a package without
    one)."""
    c = F.launch_counts()
    return {k: c[k] + c.get(MARCH_FORMS[k][0], 0) if k in MARCH_FORMS
            else c[k] for k in (names or c)}


def route_launches(F):
    """``{unit: (chain launches, march launches)}`` of the units of
    :data:`MARCH_FORMS` since the last reset of the counts."""
    c = F.launch_counts()
    return {k: (c[k], c.get(m, 0)) for k, (m, _, _) in MARCH_FORMS.items()}


def routed(entry, launches):
    """A ``kernels`` record of a unit of :data:`MARCH_FORMS` (its name
    before ``[``) set to the route its main path took (``launches``: that
    run's counts): the march's source and launches where its march
    launched there, else the chain's."""
    base = entry["name"].split("[")[0]
    if base in MARCH_FORMS:
        march, m_src, c_src = MARCH_FORMS[base]
        if launches.get(march, 0):
            entry.update(source=m_src, launches=int(launches[march]))
        else:
            entry.update(source=c_src, launches=int(launches.get(base, 0)))
    return entry


def vol_bound(unit, storage, shape):
    """``(bound_ms, bound_by)`` of one whole-volume ``unit`` call in
    ``storage`` (a form, for normal_apply, blur_apply and irls_head) at
    ``shape``: :data:`VOL_BYTES` a voxel, and ~2 operations a tap of its
    chains (:data:`VOL_TAPS`, σ = 1) plus ~20 for the Laplacian and the
    rest."""
    n = float(np.prod(shape))
    taps = 2 * 3 * VOL_TAPS[unit]
    if (unit, storage) == ("normal_apply", "atb"):
        taps = 2 * 3 * VOL_TAPS["blur_apply"]
    return bound(n * VOL_BYTES[(unit, storage)], n * (taps + 20))


def vol_march_bits(B, R, st, shape, device, seed, units=None):
    """The whole-volume march forms against their three-pass chains on the
    same random inputs: ``cg_step`` in every storage mode × TK1/TK0 ×
    first trip or not, ``weighted_apply`` in every storage mode × masked
    or not × TK1/TK0 × first trip or not, and, in a package with their
    marches, ``normal_apply`` plain and residual in float32 and bfloat16
    × TK1/TK0 and its ``Aᵀb`` form (the blur taps at ρ = 0, on an input
    with a slab of −0), ``blur_apply`` plain, with ``u`` and its gradient
    (× TK1/TK0) and ``irls_head`` for every loss; where ``units`` names
    ``cg_sweep``, its forms (:func:`sweep_march_bits`). Fails unless every
    output holds the same bits in each (signed zeros included), and pq or
    γ agrees within 1e-9 (its sum runs in another order); returns the
    number of forms checked (of ``units`` alone where given)."""
    import torch

    from nsol_tpu_torch.ops.cuda import record as Rec

    r, p, wts, free = weighted_inputs(shape, device, seed)
    what = "volume march %s seed %d" % ("x".join(map(str, shape)), seed)
    count = [0]

    def check(form, call, slot=B.PQ):
        if units is not None and form.split("[")[0] not in units:
            return
        sm, sc = _cg_scalars(device), _cg_scalars(device)
        got, ref = call(sm, "march"), call(sc, "chain")
        if not isinstance(got, tuple):
            got, ref = (got,), (ref,)
        require_bits({"%s [%d]" % (form, k): pair
                      for k, pair in enumerate(zip(got, ref))}, what)
        if slot is not None:
            pm, pc = float(sm[slot]), float(sc[slot])
            require(abs(pm - pc) <= 1e-9 * abs(pc), "%s %s: scalar %d "
                    "%.17g, chain's %.17g" % (what, form, slot, pm, pc))
        count[0] += 1

    for storage in B.STORAGE:
        (rd, pd, _), _ = B.storage_ids(storage)
        rs, ps = r.to(rd), p.to(pd)
        for reg in B.REGS:
            for first in (False, True):
                check("cg_step[%s,%s]%s" % (storage, reg,
                                            " first" if first else ""),
                      lambda s, route: B._cg_step(
                          rs, ps, s, st.normal, st.inv_h2, RHO, first, reg,
                          storage, route))
    for storage in R.ROBUST_STORAGE:
        ps = p.to(R.direction_dtype(storage) or torch.float32)
        for f in (free, None):
            for reg in B.REGS:
                for first in (False, True):
                    check("weighted_apply[%s,%s]%s%s" % (
                        storage, reg, "" if f is None else " masked",
                        " first" if first else ""),
                        lambda s, route: R._weighted_apply(
                            r, ps, f, wts, s, st.blur, st.inv_h2, RHO, first,
                            reg, storage, route))
    if not has_march(B, R, "normal_apply"):
        return count[0]
    h2 = st.inv_h2
    for io in (None, torch.bfloat16):
        v = r if io is None else r.to(io)
        for reg in B.REGS:
            tag = "%s,%s" % ("bf16" if io else "f32", reg)
            check("normal_apply[%s]" % tag, lambda s, route: B._normal_apply(
                v, st.normal, h2, RHO, None, None, reg, io, route), None)
            check("normal_apply[residual,%s]" % tag,
                  lambda s, route: B._normal_apply(
                      r, st.normal, h2, RHO, p, s, reg, io, route), B.GAMMA)
    bz = r.clone()
    bz[:max(1, bz.shape[0] // 3)] = -0.0
    check("normal_apply[A^T b]", lambda s, route: B._normal_apply(
        bz, st.blur, h2, 0.0, None, None, "TK1", None, route), None)
    check("blur_apply[plain]", lambda s, route: R._blur_apply(
        p, st.blur, h2, None, 0.0, None, "TK1", route), None)
    for reg in B.REGS:
        check("blur_apply[u,%s]" % reg, lambda s, route: R._blur_apply(
            p, st.blur, h2, r, RHO, None, reg, route), None)
        check("blur_apply[gradient,%s]" % reg, lambda s, route: R._blur_apply(
            p, st.blur, h2, r, RHO, s, reg, route), B.GAMMA)
    for loss in Rec.LOSS_IDS:
        check("irls_head[%s]" % loss, lambda s, route: R._irls_head(
            r, p, st.blur, loss, 0.7, route), None)
    if units is not None and "cg_sweep" in units:
        count[0] += sweep_march_bits(B, st, shape, device, seed)
    return count[0]


def blur_window_bits(R, st, shape, device, seed):
    """``blur_apply_prepadded``'s window march against its three-pass
    chain, with and without ``u``, on one window of ``shape[0]`` planes
    per ``row0`` (the first, a middle and the last of a volume of 3 ·
    ``shape[0]`` rows): ``{form: (march, chain)}``, empty in a package
    without the window march."""
    import torch

    if not hasattr(R, "_blur_apply_prepadded"):
        return {}
    g = torch.Generator(device=device).manual_seed(seed)
    h = R.blur_halo(st.blur)
    ext = (shape[0] + 2 * h,) + tuple(shape[1:])
    y_ext, u_ext = (torch.rand(ext, generator=g, device=device) - 0.5
                    for _ in range(2))
    out = {}
    for row0 in (0, shape[0], 2 * shape[0]):
        for u in (None, u_ext):
            args = (y_ext, st.blur, st.inv_h2, row0, 3 * shape[0], u, RHO)
            out["row0 %d%s" % (row0, "" if u is None else " with u")] = (
                R._blur_apply_prepadded(*args, chain=False),
                R._blur_apply_prepadded(*args, chain=True))
    return out


def vol_rule_checks(T, device, units=None):
    """``csrc/march.cuh``'s rules in C against their mirrors in
    ``tiled.py``, on this card: the z tile (``nsol_march_tile_z`` vs
    ``tile_z`` at its SMs) of both marches over volumes from one plane to
    512³ and z taps 1 to 41; the whole-volume route (``nsol_vol_route`` vs
    ``vol_route``) of both units on those volumes, the thin stacks and the
    2^20-voxel edge at the taps each side of the marches' fit, and at 256³
    over stencil lengths 1 to 79; the shared
    memory of the single-stencil march with bfloat16 margins
    (``nsol_tiled_smem``). ``units``: the routes of those units alone
    (default: every unit of ``tiled.VOL_UNITS``). Returns the SMs and the
    tiles of the main shapes, as text."""
    import torch

    from nsol_tpu_torch.ops.cuda import build

    lib = build.load()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shapes = {"2-D 256^2": (1, 256, 256), "2-D 1024^2": (1, 1024, 1024),
              "64^3": (64,) * 3, "128^3": (128,) * 3, "256^3": SCALE_SHAPE,
              "ragged": RAGGED_SHAPE, "64x512^2": (64, 512, 512),
              "512^3": BIG}
    dims = list(shapes.values()) + [c[3] for c in EDGE_CASES] + [
        (512, 1024, 96), (1000, 17, 40), (3, 7, 5)]
    sweep = hasattr(T, "SWEEP_RESIDENT")
    for d in dims:
        for kz in (1, 3, 7, 13, 25, 41):
            for w in (0, 1, 2) if sweep else (0, 1):  # 2: the sweep's
                c = lib.nsol_march_tile_z(*d, kz, w)
                py = T.tile_z(d, kz, w == 1, sms, *(
                    (T.SWEEP_RESIDENT,) if w == 2 else ()))
                require(c == py, "phase 36: z tile %s kz %d march %d: C "
                        "%d, Python %d" % (d, kz, w, c, py))
    for d in dims + list(THIN_SHAPES) + [
            (1 << 20, 1, 1), (1, 1025, 1024), (2, 512, 512), (2, 512, 513),
            (1 << 19, 1, 1), (80, 80, 80), (88, 88, 88), (4, 256, 512),
            (4, 256, 513), (3, 512, 512)]:
        for lengths in ((13, 13, 13), (7, 7, 7), (41, 41, 41), (45, 45, 45),
                        (15, 15, 15), (17, 17, 17)):
            for u, name in enumerate(T.VOL_UNITS):
                if units is not None and name not in units:
                    continue
                c = lib.nsol_vol_route(u, *lengths, *d)
                py = T.vol_route(name, lengths, d) == "march"
                require(bool(c) == py, "phase 36: route of %s at %s on %s: C "
                        "%d, Python %s" % (name, lengths, d, c, py))
    for kz in range(1, 80, 6):
        for ky in range(1, 80, 6):
            for kx in range(1, 80, 6):
                lengths = (kz, ky, kx)
                for u, name in enumerate(T.VOL_UNITS):
                    if units is not None and name not in units:
                        continue
                    c = lib.nsol_vol_route(u, *lengths, *SCALE_SHAPE)
                    py = T.vol_route(name, lengths, SCALE_SHAPE) == "march"
                    require(bool(c) == py, "phase 36: route of %s at %s: C "
                            "%d, Python %s" % (name, lengths, c, py))
                c = lib.nsol_tiled_smem(*lengths, 2, 1, 0, 1)
                py = T.smem_bytes(lengths, 2, True, two_byte=True)
                require(c == py, "phase 36: bf16-margin shared memory %s: C "
                        "%d, Python %d" % (lengths, c, py))
    return "%d SMs; z tiles (single-stencil at 13 taps / weighted at 7%s): " \
        "%s" % (sms, " / the sweep's at 13" if sweep else "", ", ".join(
            "%s %s" % (k, "/".join(str(t) for t in (
                T.tile_z(d, 13, False, sms), T.tile_z(d, 7, True, sms))
                + ((T.tile_z(d, 13, False, sms, T.SWEEP_RESIDENT),)
                   if sweep else ())))
            for k, d in shapes.items()))


def chain_route_runs(F, device):
    """The chain side of the route: a 64³ linear solve (3 × 5, its launch
    sequence) at σ 3.5 and a robust huber one (2 × 2 × 4) at σ 2.5, each
    past its march's shared memory, against its plain version. Returns
    ``{unit: (chain launches, march launches, max |Δ| / max |plain|)}``."""
    import torch

    shape = (64,) * 3
    b = torch.as_tensor(np.random.RandomState(36).rand(*shape)
                        .astype(np.float32), device=device)
    out = {}
    for unit, sigma in CHAIN_SIGMAS.items():
        cov = np.diag([sigma ** 2] * 3)
        kw = dict(iterations=3, iter_max=5) if unit == "cg_step" else dict(
            iterations=2, iter_max=2, data_loss="huber", irls_cg_iters=4)
        solve = F.make_fused_admm_solver(shape, cov, **kw)
        # the solve's units run in its launch sequence (the fused route
        # takes the persistent launch at 64³)
        run = solve.sequence
        torch.cuda.synchronize()
        F.reset_counts()
        x = run(b, b, ALPHA, RHO)
        torch.cuda.synchronize()
        chain, march = route_launches(F)[unit]
        rel = max_rel(x, solve.plain(b, b, ALPHA, RHO))
        out[unit] = (chain, march, rel)
        require(chain > 0 and march == 0 and rel <= SOLVE_VOX_TOL,
                "phase 36: %s at sigma %g: chain %d, march %d launches, "
                "kernel vs plain %.3g" % (unit, sigma, chain, march, rel))
    return out


def vol_calls(B, R, st, shape, device, forms, route=None):
    """Call closures of ``forms`` (of :data:`VOL_FORMS`) on one set of
    random inputs at ``shape``: through the wrapper (``route`` None: the
    route the package takes) or, in a package with the unit's march, by
    ``route`` ``"chain"`` or ``"march"``."""
    import torch

    r, p, wts, free = weighted_inputs(shape, device, 37)
    s = _cg_scalars(device)
    h2 = st.inv_h2
    calls = {}
    for label in forms:
        unit, storage, reg = VOL_FORMS[label]
        if route is not None and not has_march(B, R, unit):
            continue
        if unit == "cg_step":
            (rd, pd, _), _ = B.storage_ids(storage)
            args = (r.to(rd), p.to(pd), s, st.normal, h2, RHO, False, reg,
                    storage)
        elif unit == "weighted_apply":
            ps = p.to(R.direction_dtype(storage) or torch.float32)
            args = (r, ps, free, wts, s, st.blur, h2, RHO, False, reg,
                    storage)
        elif unit == "normal_apply":
            io = torch.bfloat16 if storage.endswith("bf16") else None
            args = {"residual": (r, st.normal, h2, RHO, p, s, reg, io),
                    "atb": (r, st.blur, h2, 0.0, None, None, reg, None)}.get(
                storage.split("_")[0],
                (r if io is None else r.to(io), st.normal, h2, RHO, None,
                 None, reg, io))
        elif unit == "blur_apply":
            args = {"gradient": (p, st.blur, h2, r, RHO, s, reg),
                    "u": (p, st.blur, h2, r, RHO, None, reg),
                    "plain": (p, st.blur, h2, None, 0.0, None, reg)}[storage]
        else:
            args = (r, p, st.blur, storage, 1.0)
        mod, private = ROUTED[unit]
        mod = {"B": B, "R": R}[mod]
        fn = getattr(mod, unit) if route is None else partial(
            getattr(mod, private), route=route)
        calls[label] = partial(fn, *args)
    return calls


def vol_turns(B, R, st, shape, device, forms, reps=10):
    """Device ms a call (:func:`device_ms_of`) of ``forms`` at ``shape``:
    for a unit the package routes, the chain and the march in turns chain,
    march, march, chain (``{form: {"chain": [ms, ms], "march": [ms,
    ms]}}``); else the package's own route twice (``{"rule": [...]}``)."""
    out = {f: {} for f in forms}
    calls = {}
    for f in forms:
        routed = has_march(B, R, VOL_FORMS[f][0])
        for k in ("chain", "march", "march", "chain") if routed \
                else (None, None):
            if k not in calls:
                calls[k] = vol_calls(B, R, st, shape, device, forms, k)
            out[f].setdefault(k or "rule", []).append(
                device_ms_of(calls[k][f], reps))
    return out


def turns_text(turns, shape, share=False):
    """:func:`vol_turns`' times as text, each form beside its bound (and
    the march's share of it)."""
    parts = []
    for f, t in turns.items():
        unit, storage, _ = VOL_FORMS[f]
        b_ms = vol_bound(unit, storage, shape)[0]
        text = "; ".join("%s %s" % (k, "/".join(map(ms_text, v)))
                         for k, v in t.items())
        best = [x for x in t.get("march", t.get("rule", [])) if x]
        if share and best:
            text += " (bound %.4f, %.1f %% of it)" % (
                b_ms, 100 * b_ms / min(best))
        else:
            text += " (bound %.4f)" % b_ms
        parts.append("%s %s" % (f, text))
    return ", ".join(parts)


def vol_ptxas():
    """ptxas registers, spills and warps an SM of the whole-volume march
    instances, grouped by epilogue (the single-stencil march's: cg_step's,
    normal_apply's, blur_apply's, its gradient's and irls_head's) and the
    weighted march's: ``{epilogue: {(regs, spills, warps): instances}}``."""
    def group(d):
        out = {}
        for v in d.values():
            out[v] = out.get(v, 0) + 1
        return out

    out = {}
    march = march_ptxas()
    for epi in ("StepZyEpi", "NormalZyEpi", "BlurZyEpi", "GradZyEpi",
                "HeadZyEpi", "SweepZyEpi"):
        out[epi] = group({k: v for k, v in march.items() if epi in k})
    out["weighted"] = group(weighted_ptxas())
    return out


#: the kernels records of the whole-volume march forms no other record
#: reports (the robust group's ``weighted_apply`` is the exact weighted
#: one, phase 14): name → (unit, TPU kernel it replaces, phase 38's run
#: that reports its launches, the form its main path runs)
VOL_ENTRIES = {
    "cg_step[march]": ("cg_step", "nsol_tpu/ops/pallas/blocked.py:988",
                       "step_exact", "exact"),
    "normal_apply[march]": ("normal_apply",
                            "nsol_tpu/ops/pallas/blocked.py:402",
                            "step_exact", "residual"),
    "blur_apply[march]": ("blur_apply", "nsol_tpu/ops/pallas/robust.py:161",
                          "robust_exact", "gradient"),
    "irls_head[march]": ("irls_head", "nsol_tpu/ops/pallas/robust.py:161",
                         "robust_exact", "huber"),
    "blur_apply_prepadded[march]": ("blur_apply_prepadded",
                                    "nsol_tpu/ops/pallas/robust.py:161",
                                    "sharded_huber", "gradient")}


def vol_entry_times(B, R, device):
    """``{name: (max |Δ| against the plain version, ms a wrapper call, ms
    of the plain version)}`` of :data:`VOL_ENTRIES` in their main paths'
    forms, by CUDA events: the whole-volume units at 256³ (``cg_step``
    after the first trip, ``normal_apply``'s residual, ``blur_apply``'s
    gradient, ``irls_head`` huber), the blur window with ``u`` at 512³
    (518 planes)."""
    import torch

    st = B.Stencils.from_cov(np.diag([SIGMA ** 2] * 3), 3, None, device)
    r, p, _, _ = weighted_inputs(SCALE_SHAPE, device, 38)
    s = [_cg_scalars(device) for _ in range(2)]
    h2 = st.inv_h2
    calls = {
        "cg_step[march]": (B.cg_step, B.cg_step_plain,
                           lambda k: (r, p, s[k], st.normal, h2, RHO)),
        "normal_apply[march]": (B.normal_apply, B.normal_apply_plain,
                                lambda k: (r, st.normal, h2, RHO, p, s[k])),
        "blur_apply[march]": (R.blur_apply, R.blur_apply_plain,
                              lambda k: (p, st.blur, h2, r, RHO, s[k])),
        "irls_head[march]": (R.irls_head, R.irls_head_plain,
                             lambda k: (r, p, st.blur, "huber", 1.0))}
    out = {}

    def held(name, unit, plain, args):
        def call(k, fn):
            got = fn(*args(k))
            return got if isinstance(got, tuple) else (got,)

        got, ref = call(0, unit), call(1, plain)
        err = max(float((g.float() - f.float()).abs().max())
                  for g, f in zip(got, ref))
        require(max(max_rel(g.float(), f.float())
                    for g, f in zip(got, ref)) <= KERNEL_TOL,
                "phase 36: %s vs plain %.3g" % (name, err))
        out[name] = (err, cuda_median_ms(lambda: call(0, unit), 10),
                     cuda_median_ms(lambda: call(1, plain), 2))

    for name, (unit, plain, args) in calls.items():
        if name in VOL_ENTRIES and (name == "cg_step[march]" or has_march(
                B, R, VOL_ENTRIES[name][0])):
            held(name, unit, plain, args)
    del r, p
    torch.cuda.empty_cache()
    if hasattr(R, "_blur_apply_prepadded"):
        h = R.blur_halo(st.blur)
        g = torch.Generator(device=device).manual_seed(39)
        y_ext, u_ext = (torch.rand((BIG[0] + 2 * h,) + BIG[1:], generator=g,
                                   device=device) - 0.5 for _ in range(2))
        held("blur_apply_prepadded[march]", R.blur_apply_prepadded,
             R.blur_apply_prepadded_plain,
             lambda k: (y_ext, st.blur, h2, BIG[0], 3 * BIG[0], u_ext, RHO))
        del y_ext, u_ext
        torch.cuda.empty_cache()
    return out


def entry_bound(B, R, unit, form):
    """``(bound_ms, bound_by)`` of one call of a :data:`VOL_ENTRIES` unit
    in its main path's form: :func:`vol_bound` at 256³, or the blur window
    with ``u`` at 512³ (y_ext read once over its 518 planes, u_ext on the
    Laplacian's Zl + 2 planes, out written once)."""
    if unit != "blur_apply_prepadded":
        return vol_bound(unit, form, SCALE_SHAPE)
    st = B.Stencils.from_cov(np.diag([SIGMA ** 2] * 3), 3, None, "cpu")
    reads = window_reads(B, R, unit, st, BIG[0])
    return bound(BIG_N * 4 * (reads + 1), BIG_N * (2 * 3 * 7 + 20))


def volume_entries(B, R, vol, rows):
    """The ``kernels`` records of :data:`VOL_ENTRIES` from phase 36's
    times and phase 38's launches (its runs on the march)."""
    out = []
    for name, (unit, tpu, run, form) in VOL_ENTRIES.items():
        if name not in vol["entries"]:
            continue
        err, ms, plain_ms = vol["entries"][name]
        b_ms, b_by = entry_bound(B, R, unit, form)
        out.append(routed({
            "name": name, "route": "cuda", "source": MARCH_FORMS[unit][2],
            "replaces": tpu, "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}, {MARCH_FORMS[unit][0]: rows[run][2].get(
                unit, (0, 0))[1]}))
        require(out[-1]["launches"] > 0, "phase 38: %s launched no time on "
                "its main path (%s)" % (name, run))
    return out


def run_volume_phases(device, card):
    """Phases 36-37: the whole-volume units on the marches of
    ``csrc/march.cuh`` (``cg_step``, ``weighted_apply``, ``normal_apply``,
    ``blur_apply``, ``irls_head``) and the blur's window. Phase 36 (a
    package with them): the z-tile and route rules in C against their
    Python mirrors, every form bit for bit against its three-pass chain on
    the tile-edge shapes, at 256³ and on the ragged volume (two seeds each)
    and on the 2-D view, the blur window with and without ``u`` on the
    tile-edge shapes and the 512³ window, the chain side of the route
    (wide blurs), the ptxas report. Phase 37 (any package): device times
    of the forms at 256³ and on the ragged volume, of the 512³ march units
    and the blur window, and, at the shapes the route is measured at, the
    chain against the march, in turns. Returns the chain side's launches
    and errors and the 256³ times."""
    import torch

    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import fused as F
    from nsol_tpu_torch.ops.cuda import robust as R
    from nsol_tpu_torch.ops.cuda import tiled as T

    iso = np.diag([SIGMA ** 2] * 3)
    out = {"chain": None}
    if hasattr(B, "_cg_step"):
        # phase 36: the rules, the bits, the chain side
        print("phase 36 rules: C and Python agree on the z tile, the route "
              "of %s and the bf16-margin shared memory; %s" % (
                  "/".join(T.VOL_UNITS), vol_rule_checks(T, device)))
        cases = [(label, cov, sp, shape, (36,))
                 for label, cov, sp, shape in EDGE_CASES] + [
            ("256^3", iso, None, SCALE_SHAPE, VOL_SEEDS),
            ("ragged", iso, None, RAGGED_SHAPE, VOL_SEEDS),
            ("2-D view", np.eye(2), None, (256, 256), (36,))]
        for label, cov, sp, shape, seeds in cases:
            st = B.Stencils.from_cov(cov, 3, sp, device)
            forms = sum(vol_march_bits(B, R, st, shape, device, seed,
                                       VOL_BIT_UNITS) for seed in seeds)
            windows = ""
            if len(shape) == 3 and shape != SCALE_SHAPE:
                windows = "; blur window %s" % require_bits(
                    blur_window_bits(R, st, shape, device, seeds[0]),
                    "blur window %s" % label)
            torch.cuda.empty_cache()
            print("phase 36 %s %s (normal taps %s, blur taps %s): %d forms "
                  "of the marches bit for bit equal to their chains (every "
                  "output; pq, gamma within 1e-9), seeds %s%s" % (
                      label, "x".join(map(str, shape)), st.normal.lengths,
                      st.blur.lengths, forms, seeds, windows))
        st = B.Stencils.from_cov(iso, 3, None, device)
        wide = B.Stencils.from_cov(np.diag([2.0 ** 2] * 3), 3, None, device)
        for label, stw in (("sigma 1", st), ("sigma 2", wide)):
            bits = blur_window_bits(R, stw, BIG, device, 36)
            if bits:
                print("phase 36 blur window 512^3 (%d planes, %s, blur taps "
                      "%s) bit for bit equal to its chain: %s" % (
                          BIG[0] + 2 * R.blur_halo(stw.blur), label,
                          stw.blur.lengths, require_bits(
                              bits, "blur window 512^3 %s" % label)))
            del bits
            torch.cuda.empty_cache()
        out["chain"] = chain_route_runs(F, device)
        print("phase 36 the chain side: %s" % ", ".join(
            "%s at sigma %g: %d chain launches, 0 march, kernel vs plain "
            "%.2e" % (k, CHAIN_SIGMAS[k], v[0], v[2])
            for k, v in out["chain"].items()))
        print("phase 36 ptxas of the march instances by epilogue ({(registers,"
              " spill bytes, warps an SM): instances}): %s" % (
                  "; ".join("%s %s" % (k, v or "cached")
                            for k, v in vol_ptxas().items())))
        out["entries"] = vol_entry_times(B, R, device)
        lap("phase 36")

    # phase 37: device times (torch.profiler medians)
    st = B.Stencils.from_cov(iso, 3, None, device)
    out["turns"] = {}
    for label, shape in (("256^3", SCALE_SHAPE), ("ragged", RAGGED_SHAPE)):
        turns = vol_turns(B, R, st, shape, device, tuple(VOL_FORMS))
        out["turns"][label] = turns
        torch.cuda.empty_cache()
        print("phase 37 %s device ms a call (torch.profiler medians): %s "
              "[%s]" % (label, turns_text(turns, shape, share=True), card))
    calls = tiled_calls(T, R, B, st, BIG, device, np.random.RandomState(37))[1]
    big = {k: [device_ms_of(calls[k][0], 5) for _ in range(2)]
           for k in ("normal_apply_zy", "cg_step_zy", "blur_apply_zy",
                     "weighted_apply_zy")}
    del calls
    torch.cuda.empty_cache()
    print("phase 37 512^3 march units, device ms a call (two traces): %s "
          "[%s]" % (", ".join("%s %s" % (k, "/".join(map(ms_text, v)))
                              for k, v in big.items()), card))
    out["window"] = window_turns(B, R, st, device)
    print("phase 37 the 512^3 windows (518 planes), device ms a call "
          "(torch.profiler medians, in turns): %s [%s]" % (
              window_text(out["window"]), card))
    st2 = B.Stencils.from_cov(np.eye(2), 3, None, device)
    for label, shape, stl, reps in (
            ("64^3", (64,) * 3, st, 20), ("72^3", (72,) * 3, st, 20),
            ("80^3", (80,) * 3, st, 20), ("88^3", (88,) * 3, st, 20),
            ("96^3", (96,) * 3, st, 20),
            ("128^3", (128,) * 3, st, 20), ("Lena 256^2", (256, 256), st2, 20),
            ("2-D 2048^2", (2048, 2048), st2, 20)) + tuple(
                ("x".join(map(str, d)), d, st, 10) for d in THIN_SHAPES):
        turns = vol_turns(B, R, stl, shape, device, ROUTE_FORMS, reps=reps)
        dims = (1,) * (3 - len(shape)) + shape
        rule = "/".join("%s %s" % (u, T.vol_route(u, t, dims)) for u, t in (
            ("cg_step", (13, 13, 13)), ("weighted_apply", (7, 7, 7)),
            ("normal_apply", (13, 13, 13)), ("blur_apply", (7, 7, 7)),
            ("irls_head", (7, 7, 7))) if u in getattr(T, "VOL_UNITS", ()))
        print("phase 37 %s (the rule's routes: %s) device ms a call: %s [%s]"
              % (label, rule or "chain", turns_text(turns, shape), card))
        torch.cuda.empty_cache()
    lap("phase 37")
    return out


def window_turns(B, R, st, device, reps=5):
    """Device ms a call (:func:`device_ms_of`) of the 512³ windows (518
    planes): ``blur_apply_prepadded`` with and without ``u`` by the
    package's route (in a package with the window march, the march and
    the chain in turns chain, march, march, chain) and
    ``normal_apply_prepadded`` by its route."""
    import torch

    g = torch.Generator(device=device).manual_seed(37)
    hb, hn = R.blur_halo(st.blur), B.prepadded_halo(st.normal)
    yb, ub = (torch.rand((BIG[0] + 2 * hb,) + BIG[1:], generator=g,
                         device=device) for _ in range(2))
    vn = torch.rand((BIG[0] + 2 * hn,) + BIG[1:], generator=g, device=device)
    row0, zt = BIG[0], 3 * BIG[0]
    out = {}
    for form, u in (("with u", ub), ("without u", None)):
        args = (yb, st.blur, st.inv_h2, row0, zt, u, RHO)
        if hasattr(R, "_blur_apply_prepadded"):
            for k in ("chain", "march", "march", "chain"):
                fn = partial(R._blur_apply_prepadded, *args,
                             chain=k == "chain")
                out.setdefault("blur_apply_prepadded " + form, {}).setdefault(
                    k, []).append(device_ms_of(fn, reps))
        else:
            fn = partial(R.blur_apply_prepadded, *args)
            out["blur_apply_prepadded " + form] = {
                "rule": [device_ms_of(fn, reps) for _ in range(2)]}
    fn = partial(B.normal_apply_prepadded, vn, st.normal, st.inv_h2, RHO,
                 row0, zt)
    out["normal_apply_prepadded"] = {
        "rule": [device_ms_of(fn, reps) for _ in range(2)]}
    del yb, ub, vn
    torch.cuda.empty_cache()
    return out


def window_text(turns):
    """:func:`window_turns`' times as text, each beside its bound."""
    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import robust as R

    st = B.Stencils.from_cov(np.diag([SIGMA ** 2] * 3), 3, None, "cpu")
    parts = []
    for form, t in turns.items():
        name = form.split()[0]
        reads = window_reads(B, R, name, st, BIG[0],
                             lap=not form.endswith("without u"))
        taps = 13 if name == "normal_apply_prepadded" else 7
        b_ms = bound(BIG_N * 4 * (reads + 1), BIG_N * (6 * taps + 20))[0]
        parts.append("%s %s (bound %.4f)" % (form, "; ".join(
            "%s %s" % (k, "/".join(map(ms_text, v))) for k, v in t.items()),
            b_ms))
    return ", ".join(parts)


def run_volume_solves(device, card):
    """Phase 38: the solves that run the routed whole-volume units and the
    blur window, by CUDA events (the median of a few calls after a
    warm-up) — the 256³ "step" solve exact, under ``compact_dirs`` (the
    CLI's default) and bf16 state, the 256³ robust huber 10 × 5 × 8 exact
    and compact, the 256³ TK1L2 × 8 α sweep, the 512³ "step2d" solve, the
    sharded 512³ linear 50 × 10 and huber 5 × 5 × 8 solves on a NCCL group
    of world size 1 (each within 1e-4 of the unsharded solve), the 64³
    north star and the Lena 256² TV-L2, huber and TK1L2 × 64 α solves —
    with their objectives and the route their units took. In a package
    with the marches the 256³ and sharded solves must have taken them, the
    64³ and Lena solves none."""
    import scipy.ndimage as ndi
    import torch

    from nsol_tpu_torch import data, interop
    from nsol_tpu_torch.io import read_nifti, read_png
    from nsol_tpu_torch.ops import conv as C
    from nsol_tpu_torch.ops import kernels as K
    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import fused as F
    from nsol_tpu_torch.ops.cuda import robust as R
    from nsol_tpu_torch.ops.cuda import tikhonov as TK

    march = hasattr(B, "_cg_step")
    # the marches of normal_apply, blur_apply, irls_head and the blur
    # window
    marches = hasattr(B, "_normal_apply")
    rows = {}

    def run(key, fn, reps, objective=None):
        torch.cuda.synchronize()
        F.reset_counts()
        x = fn()  # the launches; then cuda_median_ms warms up and times
        torch.cuda.synchronize()
        routes = {k: v for k, v in route_launches(F).items() if any(v)}
        ms = cuda_median_ms(fn, reps)
        obj = None if objective is None else objective(x)
        rows[key] = (ms, obj, routes)
        require(bool(torch.isfinite(x).all()), "phase 38: %s not finite"
                % key)
        return routes

    iso = np.diag([SIGMA ** 2] * 3)
    # 256³: "step" (exact, the CLI's compact_dirs, bf16 state)
    b, iso, A64 = compact_problem(device, SCALE_SHAPE)
    for key, kw in (("step_exact", {}), ("step_dirs", dict(compact_dirs=True)),
                    ("step_state", dict(state_dtype=torch.bfloat16))):
        solve = B.blocked_admm_solve(SCALE_SHAPE, iso, iterations=ITERATIONS,
                                     iter_max=ITER_MAX, **kw)
        require(solve.mode == "step", "phase 38: 256^3 took %r" % solve.mode)
        routes = run(key, partial(solve, b, b, ALPHA, RHO), 3,
                     lambda x: objective_device(x, b, A64, ALPHA))
        require(not march or routes.get("cg_step") == (
            0, ITERATIONS * ITER_MAX), "phase 38: %s routes %s" % (key, routes))
        require(not marches or routes.get("normal_apply") == (
            0, ITERATIONS + 1), "phase 38: %s routes %s" % (key, routes))
    # the 256³ TK1L2 sweep over 8 α, CG 10
    alphas = TK_ALPHAS[::8].astype(np.float64)
    tk = TK.make_fused_tikhonov_solver(SCALE_SHAPE, iso, reg="TK1",
                                       iter_max=TK_ITER_MAX)
    routes = run("tk1_256_x8", partial(tk, b, b, alphas), 2)
    require(not march or routes.get("cg_step", (1, 0))[0] == 0,
            "phase 38: 256^3 TK1L2 routes %s" % routes)
    require(not marches or routes.get("normal_apply") == (0, 1 + len(alphas)),
            "phase 38: 256^3 TK1L2 routes %s" % routes)
    del b
    torch.cuda.empty_cache()
    # 256³ robust huber 10 × 5 × 8 (salt-and-pepper outliers)
    its, sweeps, cgi = ROBUST_ITERS["scale"]
    bb, iso, A64 = scale_problem(device, True, SCALE_SHAPE)
    for key, kw in (("robust_exact", {}), ("robust_io",
                                           dict(compact_dirs=True))):
        rsolve = R.blocked_robust_admm_solve(
            SCALE_SHAPE, iso, iterations=its, iter_max=sweeps,
            irls_cg_iters=cgi, data_loss="huber", **kw)
        routes = run(key, partial(rsolve, bb, bb, ALPHA, RHO), 2,
                     lambda x: robust_objective(x, bb, A64, ALPHA))
        require(not march or routes.get("weighted_apply") == (
            0, its * sweeps * cgi), "phase 38: %s routes %s" % (key, routes))
        require(not marches or routes.get("blur_apply") == routes.get(
            "irls_head") == (0, its * sweeps), "phase 38: %s routes %s"
            % (key, routes))
    del bb
    torch.cuda.empty_cache()
    # 512³ "step2d" 50 × 10: cg_step_zy (the march's float TV instance)
    # 500 times a solve
    b, iso, A64 = scale_problem(device, robust=False)
    solve = B.blocked_admm_solve(BIG, iso, iterations=ITERATIONS,
                                 iter_max=ITER_MAX, mode="step2d")
    run("step2d_512", partial(solve, b, b, ALPHA, RHO), 2,
        lambda x: objective_device(x, b, A64, ALPHA))
    del b, solve
    torch.cuda.empty_cache()
    sharded_solves(device, run, rows)
    # the 64³ north star (Shepp-Logan stand-in, 50 × 10)
    img = read_nifti(data.path("3D_SheppLoganPhantom_64.nii.gz"))
    kern = K.gaussian_kernel(iso, alpha_cut=3, spacing=np.ones(3))
    b_np = ndi.convolve(img.data.astype(np.float64), kern, mode="wrap")
    b64 = interop.to_torch(b_np.astype(np.float32), device)
    solve = F.make_fused_admm_solver((64,) * 3, iso, iterations=ITERATIONS,
                                     iter_max=ITER_MAX)
    run("north_star_64", partial(solve, b64, b64, ALPHA, RHO), 10,
        lambda x: objective_host(interop.to_numpy(x), b_np, kern, ALPHA))
    # Lena 256²: TV-L2 ADMM 50 × 10, huber 10 × 3 × 6, TK1L2 × 64 α
    lena = read_png(data.path("2D_Lena_256_blur_noise.png")).astype(
        np.float64)
    bl = interop.to_torch((lena / lena.max()).astype(np.float32), device)
    cov2 = np.eye(2)
    A2, _ = C.make_blur_operators(cov2, alpha_cut=3, dtype=np.float64)
    lsolve = F.make_fused_admm_solver(bl.shape, cov2, iterations=ITERATIONS,
                                      iter_max=ITER_MAX)
    run("lena_tvl2", partial(lsolve, bl, bl, ALPHA, RHO), 10,
        lambda x: objective_device(x, bl, A2, ALPHA))
    its, sweeps, cgi = ROBUST_ITERS["lena"]
    hsolve = F.make_fused_admm_solver(bl.shape, cov2, iterations=its,
                                      iter_max=sweeps, data_loss="huber",
                                      irls_cg_iters=cgi)
    run("lena_huber", partial(hsolve, bl, bl, ALPHA, RHO), 10,
        lambda x: robust_objective(x, bl, A2, ALPHA))
    tkl = TK.make_fused_tikhonov_solver(bl.shape, cov2, reg="TK1",
                                        iter_max=TK_ITER_MAX)
    run("lena_tk1_x64", partial(tkl, bl, bl, TK_ALPHAS.astype(np.float64)),
        5)
    for key in ("north_star_64", "lena_tvl2", "lena_huber", "lena_tk1_x64"):
        require(all(v[1] == 0 for v in rows[key][2].values()),
                "phase 38: %s took a march: %s" % (key, rows[key][2]))
    print("phase 38 solves (ms a solve by CUDA events, median; objective; "
          "launches (chain, march) of the routed units): %s [%s]"
          % ("; ".join("%s %.3f ms, %s, %s" % (
              k, v[0], "-" if v[1] is None else "%.6f" % v[1], v[2])
              for k, v in rows.items()), card))
    lap("phase 38")
    return rows


def sharded_solves(device, run, rows):
    """Phase 38's sharded 512³ solves on a NCCL group of world size 1
    (``sharded_tv_admm_solve``: linear 50 × 10; huber 5 × 5 × 8 from x0 =
    max(b, 0)), each timed by ``run`` and held within 1e-4 of the
    unsharded solve (``blocked_admm_solve``, ``blocked_robust_admm_solve``);
    in a package with the blur window march the huber solve must take it
    (2 × 5 × 5 launches)."""
    import torch

    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import robust as R
    from nsol_tpu_torch.parallel import distributed as dist
    from nsol_tpu_torch.parallel import make_space_mesh, sharded_tv_admm_solve

    dist.initialize(coordinator_address="localhost:%d" % free_port(),
                    num_processes=1, process_id=0)
    try:
        mesh = make_space_mesh()
        b, iso, A64 = scale_problem(device, robust=False)
        run("sharded_linear_512", partial(
            sharded_tv_admm_solve, mesh, iso, b, b, ALPHA, RHO,
            iterations=ITERATIONS, iter_max=ITER_MAX), 2,
            lambda x: objective_device(x, b, A64, ALPHA))
        ref = objective_device(B.blocked_admm_solve(
            BIG, iso, iterations=ITERATIONS, iter_max=ITER_MAX)(
                b, b, ALPHA, RHO), b, A64, ALPHA)
        obj = rows["sharded_linear_512"][1]
        require(abs(obj - ref) <= SOLVE_OBJ_TOL * abs(ref), "phase 38: "
                "sharded linear %.4f vs blocked_admm_solve %.4f" % (obj, ref))
        del b
        torch.cuda.empty_cache()
        its, sweeps, cgi = BIG_ROBUST_ITERS
        b, iso, A64 = scale_problem(device, robust=True)
        x0 = torch.clamp(b, min=0.0)
        routes = run("sharded_huber", partial(
            sharded_tv_admm_solve, mesh, iso, b, x0, ALPHA, RHO,
            iterations=its, iter_max=sweeps, data_loss="huber"), 2,
            lambda x: robust_objective(x, b, A64, ALPHA))
        ref = robust_objective(R.blocked_robust_admm_solve(
            BIG, iso, iterations=its, iter_max=sweeps, irls_cg_iters=cgi)(
                b, x0, ALPHA, RHO), b, A64, ALPHA)
        obj = rows["sharded_huber"][1]
        require(abs(obj - ref) <= SOLVE_OBJ_TOL * abs(ref), "phase 38: "
                "sharded huber %.4f vs blocked_robust_admm_solve %.4f"
                % (obj, ref))
        require(not hasattr(R, "_blur_apply_prepadded")
                or routes.get("blur_apply_prepadded") == (
                    0, 2 * its * sweeps), "phase 38: sharded huber routes %s"
                % routes)
        del b, x0
        torch.cuda.empty_cache()
    finally:
        torch.distributed.destroy_process_group()


# -------------------------------------------------------------- phase 39 --

#: the admm_tail forms: label → (init, v written); the solves run the
#: forms without v, the wrapper the forms with it
TAIL_FORMS = {"init": (True, True), "step": (False, True),
              "init, no v": (True, False), "step, no v": (False, False)}
#: phase 39's admm_tail checks: (label, shape, 1/h, seeds)
TAIL_CASES = (("64^3", (64, 64, 64), (1.0, 1.0, 1.0), (39,)),
              ("aniso 37x45x53", (37, 45, 53), (0.8, 1.25, 0.5), (39,)),
              ("odd 17x19x23", (17, 19, 23), (1.0, 1.0, 1.0), (39,)),
              ("256^3", SCALE_SHAPE, (1.0, 1.0, 1.0), (39, 40)),
              ("ragged", RAGGED_SHAPE, (1.0, 1.0, 1.0), (39, 40)),
              ("Lena 256^2", (256, 256), (1.0, 1.0), (39,)),
              ("2-D 37x53", (37, 53), (0.8, 1.25), (39,)),
              ("view 1x256x256", (1, 256, 256), (1.0, 1.0, 0.0), (39,)),
              ("512^3", BIG, (1.0, 1.0, 1.0), (39,)))
#: the shapes phase 39 times admm_tail at
TAIL_TIME_SHAPES = (("64^3", (64, 64, 64)), ("96^3", (96, 96, 96)),
                    ("128^3", (128, 128, 128)), ("Lena 256^2", (256, 256)),
                    ("1024^2", (1024, 1024)), ("2048^2", (2048, 2048)),
                    ("256^3", SCALE_SHAPE), ("ragged", RAGGED_SHAPE),
                    ("512^3", BIG))
#: the torch.profiler traces phase 39 takes of each form it times
TAIL_TRACES = 3
#: the device kernels of admm_tail: the one-pass kernel, or the two-pass
#: unit of an earlier package
TAIL_KERNELS = ("admm_tail_kernel", "admm_shrink_kernel", "admm_rhs_kernel")
#: pd_record's forms: (ℓ1 data, Huber Reg)
RECORD_FORMS = {"TV l2": (False, False), "TV l1": (True, False),
                "Huber l2": (False, True), "Huber l1": (True, True)}
#: pd_record's records against their plain version: the per-voxel f32
#: terms are the plain version's, only the float64 sums' order differs
#: (6.03e-09 at most on an H100 80GB HBM3 at 700 W); a voxel dropped or
#: counted twice moves a record by its share of the sum, ~1e-6 of it on
#: the largest of these shapes
PD_RECORD_TOL = 1e-7
#: pd_record's checks (shape, batch) and timed shapes (label, shape, batch)
RECORD_CASES = (((37, 53), 3), ((1024, 1024), 3), ((37, 45, 53), 3),
                ((17, 19, 23), 2), ((64, 64, 64), 1))
RECORD_TIME_SHAPES = (("64 x 1024^2", (1024, 1024), 64),
                      ("64^3 phantom", (64, 64, 64), 1),
                      ("256^3", SCALE_SHAPE, 1))
RECORD_KERNELS = ("pd_record_kernel", "pd_record_reduce_kernel")
#: the solves' objectives to their recorded printed digits (phase 38;
#: 512³ "apply" equals "step2d" and the fused solve, phase 21)
TAIL_SOLVE_DIGITS = {"step_exact": 20868.340472, "step_dirs": 20868.340455,
                     "step_state": 20880.719600, "apply_512": 165421.768822,
                     "step2d_512": 165421.768822}


def tail_volumes(form, ncomp):
    """Volumes one ``admm_tail`` call of ``form`` moves: x, w (ncomp) and
    Aᵀb read (w not with init), x (not with init), w' (ncomp), rhs and v
    (ncomp, where written) written."""
    init, with_v = TAIL_FORMS[form]
    reads = 2 + (0 if init else ncomp)
    writes = (0 if init else 1) + ncomp + 1 + (ncomp if with_v else 0)
    return reads + writes


def tail_inputs(shape, seed, device):
    """x with negative voxels, a flat third (|t| ≤ τ there), three −0 and
    one NaN; w (small, so that both sides of the shrink occur) and Aᵀb."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand(shape, generator=g, device=device) - 0.3
    flat = x.view(-1)
    n = flat.numel()
    flat[:n // 3] = 0.25
    flat[[n // 3 + 3, n // 3 + 7, n // 2]] = -0.0
    flat[n - 5] = float("nan")
    w = (torch.rand((len(shape),) + tuple(shape), generator=g,
                    device=device) - 0.5) * 0.04
    atb = torch.rand(shape, generator=g, device=device)
    return x, w, atb


def tail_digest(t):
    """sha256 of a tensor's bytes, the first 16 hex digits."""
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def bits_equal(a, b):
    import torch

    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def tail_checks(F, device, digests):
    """``admm_tail`` on :data:`TAIL_CASES`, init and not: the wrapper (v
    written) against the plain version within KERNEL_TOL with its NaN;
    in a package with the one-pass kernel, its form without v (w' into
    another tensor, as the C solves run it) bit for bit equal to the
    wrapper's x, w and rhs. ``digests``: ``{case: {output: sha256}}`` of
    another package's run to hold every output to bit for bit (None:
    none), else filled. Returns (cases, max rel error)."""
    import torch

    tau = float(np.float32(ALPHA) / np.float32(RHO))
    out, err = {}, 0.0
    for label, shape, inv_h, seeds in TAIL_CASES:
        for seed in seeds:
            for init in (True, False):
                key = "%s seed %d %s" % (label, seed, "init" if init
                                         else "step")
                x, w, atb = tail_inputs(shape, seed, device)
                xk, wk, vk = x.clone(), w.clone(), torch.zeros_like(w)
                rk = F.admm_tail(xk, vk, wk, atb, inv_h, tau, RHO, init=init)
                got = {"x": xk, "v": vk, "w": wk, "rhs": rk}
                out[key] = {k: tail_digest(t) for k, t in got.items()}
                if digests is not None:
                    bad = [k for k in got if out[key][k] != digests[key][k]]
                    require(not bad, "phase 39: admm_tail %s differs from the "
                            "other package's in %s" % (key, bad))
                if hasattr(F, "_admm_tail"):
                    # without v, as the solves run it
                    xn, wn = x.clone(), w.clone()
                    wo = wn if init else torch.empty_like(wn)
                    rn = F._admm_tail(xn, None, wn, wo, atb, inv_h, tau, RHO,
                                      init=init)
                    for k, a, b in (("x", xn, xk), ("w'", wo, wk),
                                    ("rhs", rn, rk)):
                        require(bits_equal(a, b), "phase 39: admm_tail %s "
                                "without v: %s differs from the wrapper's"
                                % (key, k))
                    del xn, wn, wo, rn
                xp, wp, vp = x.clone(), w.clone(), torch.zeros_like(w)
                rp = F.admm_tail_plain(xp, vp, wp, atb, inv_h, tau, RHO,
                                       init=init)
                for k, a, b in (("x", xk, xp), ("v", vk, vp), ("w", wk, wp),
                                ("rhs", rk, rp)):
                    require(bool(torch.equal(torch.isnan(a), torch.isnan(b))),
                            "phase 39: admm_tail %s: %s NaN pattern differs "
                            "from the plain version's" % (key, k))
                    e = max_rel(torch.nan_to_num(a), torch.nan_to_num(b))
                    require(e <= KERNEL_TOL, "phase 39: admm_tail %s: %s vs "
                            "plain %.3g" % (key, k, e))
                    err = max(err, e)
                del x, w, atb, xk, wk, vk, rk, xp, wp, vp, rp, got
                torch.cuda.empty_cache()
    return out, err


def tail_times(F, device):
    """Device ms a call of each :data:`TAIL_FORMS` form the package has at
    :data:`TAIL_TIME_SHAPES`, :data:`TAIL_TRACES` traces each, beside its
    bound:
    ``{shape label: {form: ([ms, ms], bound ms)}}``. The kernel's own
    time: the forms with v through ``_admm_tail`` (not the wrapper, which
    also copies w' back into w); an earlier package's two-pass unit
    through its wrapper, which wrote w in place."""
    import torch

    tau = float(np.float32(ALPHA) / np.float32(RHO))
    out = {}
    for label, shape in TAIL_TIME_SHAPES:
        nd = len(shape)
        g = torch.Generator(device=device).manual_seed(39)
        x = torch.rand(shape, generator=g, device=device)
        w = (torch.rand((nd,) + tuple(shape), generator=g, device=device)
             - 0.5) * 0.04
        atb = torch.rand(shape, generator=g, device=device)
        v, wo = torch.empty_like(w), torch.empty_like(w)
        inv_h = (1.0,) * nd
        n = float(np.prod(shape))
        row = {}
        for form, (init, with_v) in TAIL_FORMS.items():
            if hasattr(F, "_admm_tail"):
                fn = partial(F._admm_tail, x, v if with_v else None, w, wo,
                             atb, inv_h, tau, RHO, init=init)
            elif with_v:
                fn = partial(F.admm_tail, x, v, w, atb, inv_h, tau, RHO,
                             init=init)
            else:
                continue
            ms = [device_ms_of(fn, 10, keys=TAIL_KERNELS)
                  for _ in range(TAIL_TRACES)]
            row[form] = (ms, bound(4 * n * tail_volumes(form, nd), 60 * n)[0])
        out[label] = row
        del x, w, atb, v, wo
        torch.cuda.empty_cache()
    return out


def record_checks(F, device):
    """``pd_record`` on :data:`RECORD_CASES`, float32 and bfloat16 state,
    every :data:`RECORD_FORMS` form, against its plain version within
    :data:`PD_RECORD_TOL`; a second call repeats the sums bit for bit.
    Returns the max rel error."""
    import torch

    err = 0.0
    for shape, nb in RECORD_CASES:
        nd = len(shape)
        g = torch.Generator(device=device).manual_seed(39)
        b = torch.rand(shape, generator=g, device=device)
        inv_h = (0.8, 1.25, 0.5)[:nd]
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.rand((nb,) + shape, generator=g, device=device).to(dtype)
            for form, (ell1, huber) in RECORD_FORMS.items():
                rec = [torch.zeros((nb, 3), dtype=torch.float64,
                                   device=device) for _ in range(4)]
                for t in (1, 2):
                    F.pd_record(x, b, rec[0], rec[1], t, inv_h, ell1, huber,
                                0.1)
                F.pd_record_plain(x, b, rec[2], rec[3], 1, inv_h, ell1, huber,
                                  0.1)
                where = "%s %s %s" % ("x".join(map(str, shape)), dtype, form)
                require(bool(torch.equal(rec[0][:, 1], rec[0][:, 2])
                             and torch.equal(rec[1][:, 1], rec[1][:, 2])),
                        "phase 39: pd_record %s does not repeat" % where)
                e = max(max_rel(rec[0][:, 1], rec[2][:, 1]),
                        max_rel(rec[1][:, 1], rec[3][:, 1]))
                require(e <= PD_RECORD_TOL, "phase 39: pd_record %s vs plain "
                        "%.3g" % (where, e))
                err = max(err, e)
            del x
        del b
    torch.cuda.empty_cache()
    return err


def record_times(F, device):
    """Device ms a call of ``pd_record`` (its march and the second stage)
    in each form, float32 and bfloat16 state, at
    :data:`RECORD_TIME_SHAPES`, :data:`TAIL_TRACES` traces each, beside its
    bound (x and
    b read once): ``{(shape label, dtype): {form: ([ms, ms], bound)}}``."""
    import torch

    out = {}
    for label, shape, nb in RECORD_TIME_SHAPES:
        nd = len(shape)
        g = torch.Generator(device=device).manual_seed(39)
        b = torch.rand(shape, generator=g, device=device)
        n = float(np.prod(shape))
        for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
            x = torch.rand((nb,) + shape, generator=g, device=device).to(dtype)
            reg = torch.zeros((nb, 2), dtype=torch.float64, device=device)
            data = torch.zeros_like(reg)
            row = {}
            for form, (ell1, huber) in RECORD_FORMS.items():
                fn = partial(F.pd_record, x, b, reg, data, 1,
                             (1.0,) * nd, ell1, huber)
                row[form] = ([device_ms_of(fn, 10, keys=RECORD_KERNELS)
                              for _ in range(TAIL_TRACES)],
                             bound(n * (nb * size + 4), n * nb * 25)[0])
            out[(label, "f32" if size == 4 else "bf16")] = row
            del x
        del b
        torch.cuda.empty_cache()
    return out


def traces_ms(ms):
    """The median of a form's traces that kept records (None where none
    did): a trace that lost records of a long run reads low (on an H100
    80GB HBM3 after many phases in one process, 0.07 against 0.13 ms),
    and the median of three sets one such trace aside."""
    got = [t for t in ms if t is not None]
    return float(np.median(got)) if got else None


def times_text(rows):
    """``{key: {form: ([ms, ...], bound)}}`` as text, each form's times
    beside its bound and the share of it (of their median)."""
    def one(ms, b):
        med = traces_ms(ms)
        share = " (%.1f %%)" % (100 * b / med) if med else ""
        return "%s, bound %.5f%s" % ("/".join(map(ms_text, ms)), b, share)

    return "; ".join("%s: %s" % (key, ", ".join(
        "%s %s" % (form, one(*v)) for form, v in row.items()))
        for key, row in rows.items())


def tail_solves(device, card):
    """The solves that run ``admm_tail`` and ``pd_record``, by CUDA events
    (median after a warm-up; the first call counts the launches), with
    their objectives and their launches of
    the two units: the 64³ north star (0.2 % of the anchor), Lena TV-L2,
    256³ "step" exact / compact / bf16 state and 512³ "apply" and
    "step2d" (each equal to its recorded digits,
    :data:`TAIL_SOLVE_DIGITS`), the Man 1024² × 64 α PD sweep exact (the
    anchors of phase 9 within 1e-5) and compact (its plain version within
    1e-5), and the PD deconvolution CLI on the 64³ NIfTI (1e-4 of its
    anchor)."""
    import scipy.ndimage as ndi
    import torch

    from nsol_tpu_torch import data, interop
    from nsol_tpu_torch.cli import run_deconvolution
    from nsol_tpu_torch.io import DataReader, read_nifti, read_png, write_nifti
    from nsol_tpu_torch.ops import conv as C
    from nsol_tpu_torch.ops import grad as G
    from nsol_tpu_torch.ops import kernels as K
    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import fused as F

    rows = {}

    def run(key, fn, reps, objective=None, units=("admm_tail",)):
        torch.cuda.synchronize()
        F.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        launches = {k: v for k, v in F.launch_counts(units).items()}
        require(all(v > 0 for v in launches.values()), "phase 39: %s "
                "launched no %s" % (key, launches))
        ms = cuda_median_ms(fn, reps)
        rows[key] = (ms, None if objective is None else objective(out),
                     launches)
        return out

    def digits(key):
        obj = rows[key][1]
        require(round(obj, 6) == TAIL_SOLVE_DIGITS[key], "phase 39: %s "
                "objective %.6f, recorded %.6f" % (
                    key, obj, TAIL_SOLVE_DIGITS[key]))

    iso = np.diag([SIGMA ** 2] * 3)
    # the 64³ north star and Lena TV-L2 (50 × 10)
    img = read_nifti(data.path("3D_SheppLoganPhantom_64.nii.gz"))
    kern = K.gaussian_kernel(iso, alpha_cut=3, spacing=np.ones(3))
    b_np = ndi.convolve(img.data.astype(np.float64), kern, mode="wrap")
    b64 = interop.to_torch(b_np.astype(np.float32), device)
    solve = F.make_fused_admm_solver((64,) * 3, iso, iterations=ITERATIONS,
                                     iter_max=ITER_MAX)
    # the 64³ and Lena TV-L2 solves: admm_tail inside their one persistent
    # launch (csrc/admm_persistent.cu)
    run("north_star_64", partial(solve, b64, b64, ALPHA, RHO), 10,
        lambda x: objective_host(interop.to_numpy(x), b_np, kern, ALPHA),
        units=("admm_persistent",))
    obj = rows["north_star_64"][1]
    require(abs(obj - OBJECTIVE_ANCHOR) <= ANCHOR_BAND * OBJECTIVE_ANCHOR,
            "phase 39: 64^3 objective %.4f, anchor %.2f" % (
                obj, OBJECTIVE_ANCHOR))
    lena = read_png(data.path("2D_Lena_256_blur_noise.png")).astype(
        np.float64)
    bl = interop.to_torch((lena / lena.max()).astype(np.float32), device)
    A2, _ = C.make_blur_operators(np.eye(2), alpha_cut=3, dtype=np.float64)
    lsolve = F.make_fused_admm_solver(bl.shape, np.eye(2),
                                      iterations=ITERATIONS,
                                      iter_max=ITER_MAX)
    run("lena_tvl2", partial(lsolve, bl, bl, ALPHA, RHO), 10,
        lambda x: objective_device(x, bl, A2, ALPHA),
        units=("admm_persistent",))
    # 256³ "step": exact, compact (the CLI's default), bf16 state
    b, iso, A64 = compact_problem(device, SCALE_SHAPE)
    for key, kw in (("step_exact", {}), ("step_dirs", dict(compact_dirs=True)),
                    ("step_state", dict(state_dtype=torch.bfloat16))):
        solve = B.blocked_admm_solve(SCALE_SHAPE, iso, iterations=ITERATIONS,
                                     iter_max=ITER_MAX, **kw)
        run(key, partial(solve, b, b, ALPHA, RHO), 3,
            lambda x: objective_device(x, b, A64, ALPHA))
        digits(key)
    del b
    torch.cuda.empty_cache()
    # 512³ "apply" (exact) and "step2d"
    b, iso, A64 = scale_problem(device, robust=False)
    for key, mode in (("apply_512", "apply"), ("step2d_512", "step2d")):
        solve = B.blocked_admm_solve(BIG, iso, iterations=ITERATIONS,
                                     iter_max=ITER_MAX, mode=mode)
        run(key, partial(solve, b, b, ALPHA, RHO), 2,
            lambda x: objective_device(x, b, A64, ALPHA))
        digits(key)
    del b, solve
    torch.cuda.empty_cache()
    # the Man 1024² × 64 α L-curve sweep (TVL2, 50, records): exact and
    # under the compact state
    man = read_png(data.path("2D_Man_1024.png")).astype(np.float64)
    bm = interop.to_torch((man / man.max()).astype(np.float32), device)
    alphas = np.linspace(0.01, 1.5, 64, dtype=np.float32)

    def rec_obj(out):
        xs, recs = out
        return {i: float(recs["Data"][i, -1]) + float(alphas[i])
                * float(recs["Reg"][i, -1]) for i in MAN_ANCHORS}

    for key, compact in (("man_sweep", False), ("man_sweep_compact", True)):
        sweep = F.make_fused_pd_denoise_solver(bm.shape, "TVL2", "ALG2",
                                               ITERATIONS, record=True,
                                               compact=compact)
        run(key, partial(sweep, bm, bm, alphas, PD_L2), 5, rec_obj,
            units=("pd_record",))
        got = rows[key][1]
        ref = MAN_ANCHORS if not compact else rec_obj(
            sweep.plain(bm, bm, alphas, PD_L2))
        for i, want in ref.items():
            require(abs(got[i] - want) <= PD_ANCHOR_BAND * abs(want),
                    "phase 39: %s alpha[%d] %.6f vs %.6f" % (key, i, got[i],
                                                             want))
        del sweep
    # the PD deconvolution CLI on the 64³ NIfTI (its default --solver PD)
    with tempfile.TemporaryDirectory() as tmp:
        cube = ndi.convolve(img.data.astype(np.float64), kern,
                            mode="wrap").astype(np.float32)
        path = os.path.join(tmp, "cube.nii")
        write_nifti(cube, path, spacing=np.ones(3))

        def cli():
            rc = run_deconvolution.main([
                "--observation", path, "--result",
                os.path.join(tmp, "x.mat"), "--reconstruction-type", "TVL2"])
            require(rc in (0, None), "phase 39: the PD CLI exited %s" % rc)
            reader = DataReader(os.path.join(tmp, "x.mat"))
            reader.read_data()
            return reader.get_data()

        x, ms = timed_once(cli)
        x, ms2 = timed_once(cli)
        xs = float(np.max(cube))
        A64, _ = C.make_blur_operators(np.eye(3), alpha_cut=3,
                                       dtype=np.float64)
        xt = torch.as_tensor(x / xs, device=device)
        bt = torch.as_tensor(cube / xs, dtype=torch.float64, device=device)
        g = G.gradient(xt)
        r = A64(xt) - bt
        obj = float(0.5 * torch.sum(r * r) + ALPHA * torch.sum(
            torch.sqrt(torch.sum(g * g, 0))))
        anchor = PD_DECONV_ANCHORS[("phantom", "TVL2")]
        require(abs(obj - anchor) <= PD_DECONV_BAND * abs(anchor),
                "phase 39: PD CLI 64^3 objective %.6f, anchor %.6f"
                % (obj, anchor))
        rows["pd_cli_64"] = (min(ms, ms2), obj, {})
    print("phase 39 solves (ms a solve by CUDA events, median; objective; "
          "launches): %s [%s]" % ("; ".join(
              "%s %.3f ms, %s, %s" % (k, v[0], v[1] if isinstance(v[1], dict)
                                      else "%.6f" % v[1], v[2])
              for k, v in rows.items()), card))
    return rows


def run_tail_phase(device, card, bits_path=None):
    """Phase 39: ``admm_tail`` and ``pd_record``. Their checks
    (:func:`tail_checks`, :func:`record_checks`; with ``bits_path``, every
    ``admm_tail`` output held bit for bit to the digests another package's
    run wrote there, or written there where the file is absent), the
    ptxas report of their instances, their device times beside their
    bounds, and the solves that run them. Returns the kernels' device ms
    at the main paths' shapes (64³, 64 × 1024² float32 TVL2), the median
    of their traces."""
    from nsol_tpu_torch.ops.cuda import fused as F

    digests = None
    if bits_path and os.path.isfile(bits_path):
        with open(bits_path) as f:
            digests = json.load(f)
    cases, err = tail_checks(F, device, digests)
    if bits_path and digests is None:
        with open(bits_path, "w") as f:
            json.dump(cases, f)
    print("phase 39 admm_tail: %d cases (init and not, with v and without) "
          "vs plain max rel %.2e, NaN where it has it; %s" % (
              len(cases), err, "bit for bit the digests of %s" % bits_path
              if digests is not None else "digests written to %s" % bits_path
              if bits_path else "no digests"))
    print("phase 39 pd_record: float32 and bfloat16, 2-D and 3-D, TV/Huber "
          "x l1/l2 vs plain max rel %.2e, repeats bit for bit"
          % record_checks(F, device))
    print("phase 39 ptxas ({template arguments: (registers, spill bytes, "
          "warps an SM)}): %s" % "; ".join(
              "%s %s" % (k, v or "cached") for k, v in tail_ptxas().items()))
    lap("phase 39 checks")
    tt = tail_times(F, device)
    print("phase 39 admm_tail device ms a call (torch.profiler medians, %d "
          "traces): %s [%s]" % (TAIL_TRACES, times_text(tt), card))
    rt = record_times(F, device)
    print("phase 39 pd_record device ms a call: %s [%s]"
          % (times_text(rt), card))
    lap("phase 39 times")
    tail_solves(device, card)
    lap("phase 39 solves")
    return {"admm_tail": traces_ms(tt["64^3"]["step"][0]),
            "pd_record": traces_ms(rt[("64 x 1024^2", "f32")]["TV l2"][0])}


def tail_ptxas():
    """:func:`kernel_ptxas` of the one-pass ``admm_tail`` (64 threads) and
    of the ``pd_record`` march (256)."""
    return {k: kernel_ptxas(k, t) for k, t in (
        ("admm_tail_kernel", 64), ("pd_record_kernel", 256))}


# -------------------------------------------------------------- phase 40 --

#: the sweep's forms: label → (storage, first trip)
SWEEP_FORMS = {"f32": ("float32", False), "f32 first": ("float32", True),
               "bf16": ("bfloat16", False), "bf16 first": ("bfloat16", True)}
#: the march's dots against the chain's: the same float products summed
#: in float64 in another order
SWEEP_DOT_TOL = 1e-12
#: phase 40's bit checks beside the tile-edge shapes: (label, shape, seeds)
SWEEP_BIT_SHAPES = (("256^3", SCALE_SHAPE, (40,)),
                    ("ragged", RAGGED_SHAPE, VOL_SEEDS),
                    ("512^3", BIG, (40,)))
#: the shapes phase 40 times chain against march at for the route (σ = 1):
#: under 2^20 voxels, 2-D views and thin stacks past it
SWEEP_ROUTE_SHAPES = (("64^3", (64,) * 3), ("96^3", (96,) * 3),
                      ("128^3", (128,) * 3), ("Lena 256^2", (1, 256, 256)),
                      ("2-D 2048^2", (1, 2048, 2048))) + tuple(
                          ("x".join(map(str, d)), d) for d in THIN_SHAPES)
#: torch.profiler traces of each turn at the main shapes (PERF.md: one of
#: three may lose records of a long run)
SWEEP_TRACES = 3
#: the sweep's device kernels: the march and the reduce, or the chain's
SWEEP_KERNELS = ("stencil_zy_kernel", "sweep_x_kernel", "conv_y_kernel",
                 "sweep_z_kernel", "sweep_reduce_kernel")
#: the kernels records phase 40 adds: name → (storage, phase 40's solve
#: that reports its launches)
SWEEP_ENTRIES = {"cg_sweep[march]": ("float32", "sweep_f32"),
                 "cg_sweep[march,bf16]": ("bfloat16", "sweep_bf16")}


def sweep_inputs(shape, device, seed):
    """``(x, r, p, q)`` of the sweep on the card, in [-0.5, 0.5), from a
    seeded generator."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.rand(shape, generator=g, device=device) - 0.5
                 for _ in range(4))


def sweep_routes(B, st, x, r, p, q, dtype, first):
    """``{route: (x', r', p', q', scal)}`` of one sweep (storage ``dtype``)
    on the march and on the chain, on the same inputs, each from its own
    copy of x and of the scalars (γ 3, a 0.31, β 0.83)."""
    out = {}
    for route in ("march", "chain"):
        s, xs = _scal(x.device), x.clone()
        rn, pn, qn = B._cg_sweep(xs, r.to(dtype), p.to(dtype), q.to(dtype),
                                 s, st.normal, st.inv_h2, RHO, first,
                                 route=route)
        out[route] = (xs, rn, pn, qn, s)
    return out


def sweep_march_bits(B, st, shape, device, seed):
    """Every :data:`SWEEP_FORMS` form of ``cg_sweep`` on its march against
    its three-pass chain on the same random inputs: x', r', p' and q' bit
    for bit (signed zeros included), the four dots and the recurrence's
    a, β within :data:`SWEEP_DOT_TOL`. Returns the forms checked (0 in a
    package without the sweep's march)."""
    import torch

    if not hasattr(B, "_cg_sweep"):
        return 0
    x, r, p, q = sweep_inputs(shape, device, seed)
    what = "sweep march %s seed %d" % ("x".join(map(str, shape)), seed)
    for label, (dt, first) in SWEEP_FORMS.items():
        out = sweep_routes(B, st, x, r, p, q, getattr(torch, dt), first)
        require_bits({"%s %s" % (label, k): (a, b) for k, a, b in zip(
            ("x'", "r'", "p'", "q'"), out["march"], out["chain"])}, what)
        sm, sc = out["march"][4], out["chain"][4]
        for k in (B.GAMMA, B.PQ, B.RQ, B.QQ, B.A, B.BETA):
            m, c = float(sm[k]), float(sc[k])
            require(abs(m - c) <= SWEEP_DOT_TOL * abs(c), "%s %s: scalar %d "
                    "%.17g, chain's %.17g" % (what, label, k, m, c))
        del out
    del x, r, p, q
    torch.cuda.empty_cache()
    return len(SWEEP_FORMS)


def sweep_nan_routes(B, st, shape, device, dtype):
    """A later sweep with one NaN in p on the march and on the chain: NaN
    at the same entries of x', r', p', q' and the scalars, the same bits
    elsewhere, and β NaN (as under jnp.maximum)."""
    import torch

    x, r, p, q = sweep_inputs(shape, device, 41)
    p.view(-1)[p.numel() // 2] = float("nan")
    out = sweep_routes(B, st, x, r, p, q, dtype, False)
    what = "cg_sweep march %s with a NaN in p" % str(dtype).split(".")[-1]
    same_nan(list(zip(out["march"], out["chain"])), what)
    require_bits({"%d" % k: (torch.nan_to_num(a), torch.nan_to_num(b))
                  for k, (a, b) in enumerate(zip(out["march"][:4],
                                                 out["chain"][:4]))}, what)
    require(bool(torch.isnan(out["march"][4][B.BETA])), "%s: beta is not "
            "NaN" % what)


def sweep_refusals(B, st, device):
    """The sweep's C entry refuses q' over q (cudaErrorInvalidValue) on
    either route, and a march forced on taps past its block's shared
    memory (σ 3.5) raises: nothing falls back to the chain or the plain
    version. Returns the refusals seen."""
    import torch

    from nsol_tpu_torch.ops.cuda import build

    lib = build.load()
    x, r, p, q = sweep_inputs((16, 40, 37), device, 42)
    s = _scal(device)
    tv = st.normal.as_volume()
    t1, t2 = torch.empty_like(x), torch.empty_like(x)
    parts = torch.empty(4 * max(lib.nsol_tiled_blocks(16, 40, 37),
                                lib.nsol_max_blocks()), dtype=torch.float64,
                        device=device)
    seen = 0
    for route in (1, 2):  # chain, march
        counts = build.new_counts(B.COUNTS)
        err = lib.nsol_cg_sweep(
            *(build.tensor_ptr(t) for t in (x, r, p, q, q, r.clone(),
                                            p.clone(), t1, t2, parts, s)),
            0, build.tensor_ptr(tv.buf), *tv.lengths, float(RHO), 0, route,
            *B.spacing3(st.inv_h2), 16, 40, 37, build.stream_ptr(device),
            counts)
        require(err != 0, "phase 40: q_new == q accepted on route %d" % route)
        seen += 1
    wide = B.Stencils.from_cov(np.diag([3.5 ** 2] * 3), 3, None, device)
    try:
        B._cg_sweep(x, r, p, q, s, wide.normal, wide.inv_h2, RHO, False,
                    route="march")
    except RuntimeError:
        seen += 1
    else:
        require(False, "phase 40: a march past its shared memory ran")
    torch.cuda.synchronize()
    return seen


def sweep_turns(B, st, shape, device, dtype, reps=10, traces=SWEEP_TRACES):
    """Device ms a call of a later sweep (storage ``dtype``) at ``shape``,
    chain and march in turns chain, march, march, chain, each the median
    of ``traces`` ``torch.profiler`` traces (:func:`traces_ms`), and beside
    it the median ms of ``reps`` calls by CUDA events (a trace of a long
    run may keep no record): ``{route: [ms, ms], "events": {route: [ms,
    ms]}}``. The kernels' own time (``_cg_sweep``: no copy of q' back into
    q)."""
    import torch

    x, r, p, q = sweep_inputs(shape, device, 43)
    rs, ps, qs = r.to(dtype), p.to(dtype), q.to(dtype)
    del r, p, q
    out = {"chain": [], "march": [], "events": {"chain": [], "march": []}}
    for route in ("chain", "march", "march", "chain"):
        s = _scal(device)
        fn = partial(B._cg_sweep, x, rs, ps, qs, s, st.normal, st.inv_h2,
                     RHO, False, route=route)
        out[route].append(traces_ms([device_ms_of(fn, reps,
                                                  keys=SWEEP_KERNELS)
                                     for _ in range(traces)]))
        out["events"][route].append(cuda_median_ms(fn, reps))
    del x, rs, ps, qs
    torch.cuda.empty_cache()
    return out


def sweep_bound(shape, dtype):
    """``(bound_ms, bound_by)`` of one later sweep at ``shape``: r, q, p, x
    read and x', r', p', q' written once (32 bytes a voxel in float, 20 in
    bfloat16), ~2 operations a tap of the 13-tap chain and ~30 for the
    Laplacian, the updates and the four dots."""
    import torch

    n = float(np.prod(shape))
    bpv = 32 if dtype == torch.float32 else 20
    return bound(n * bpv, n * (2 * 3 * 13 + 30))


def sweep_turns_text(turns, shape, dtype):
    b_ms = sweep_bound(shape, dtype)[0]
    best = [t for t in turns["march"] if t]
    share = " (march %.1f %% of it)" % (100 * b_ms / min(best)) if best \
        else ""
    ev = turns["events"]
    return "chain %s, march %s, bound %.4f%s; by CUDA events chain %s, " \
        "march %s" % ("/".join(map(ms_text, turns["chain"])),
                      "/".join(map(ms_text, turns["march"])), b_ms, share,
                      "/".join(map(ms_text, ev["chain"])),
                      "/".join(map(ms_text, ev["march"])))


def sweep_solves(device, card):
    """The solves that run the sweep, by CUDA events (median after a
    warm-up; the first call counts the launches and warms up), with their
    objectives:
    256³ "sweep" float32 and bf16 state against "step" exact (phase 24's
    gates), 512³ "sweep" against "apply" exact (0.2 % of the 512³ anchor)
    and a 64³ "sweep" against the 64³ "step" (within SWEEP_F32_TOL; its
    500 sweeps take the chain). Returns ``{key: (ms, objective,
    launches)}``."""
    import torch

    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import fused as F

    rows = {}

    def run(key, solve, b, objective, reps):
        fn = partial(solve, b, b, ALPHA, RHO)
        torch.cuda.synchronize()
        F.reset_counts()
        x = fn()  # also the warm-up (stencils, allocator)
        torch.cuda.synchronize()
        launches = {k: v for k, v in F.launch_counts().items() if v}
        require(bool(torch.isfinite(x).all()) and x.shape == b.shape,
                "phase 40: %s not finite or misshapen" % key)
        obj = objective(x)
        del x
        rows[key] = (cuda_median_ms(fn, reps), obj, launches)

    def sweeps(key, where):
        lc = rows[key][2]
        other = "cg_sweep" if where == "cg_sweep_march" else "cg_sweep_march"
        require(lc.get(where) == ITERATIONS * ITER_MAX and other not in lc
                and lc.get("cg_update") == ITERATIONS and "cg_step" not in lc,
                "phase 40: %s launches %s" % (key, lc))

    for shape, reps in (((64,) * 3, 5), (SCALE_SHAPE, 3), (BIG, 2)):
        b, iso, A64 = compact_problem(device, shape)
        label = "64" if shape[0] == 64 else str(shape[0])
        modes = {"sweep_f32": dict(mode="sweep")}
        if shape == SCALE_SHAPE:
            modes.update(sweep_bf16=dict(mode="sweep",
                                         state_dtype=torch.bfloat16))
        modes.update({"apply_exact": dict(mode="apply")} if shape == BIG
                     else {"step_exact": dict(mode="step")})
        for key, kw in modes.items():
            solve = B.blocked_admm_solve(shape, iso, iterations=ITERATIONS,
                                         iter_max=ITER_MAX, **kw)
            require(solve.mode == kw["mode"], "phase 40: %s took %r"
                    % (key, solve.mode))
            run("%s_%s" % (key, label), solve, b,
                lambda x: objective_device(x, b, A64, ALPHA), reps)
            del solve
            torch.cuda.empty_cache()
        del b
        torch.cuda.empty_cache()
    sweeps("sweep_f32_64", "cg_sweep")
    for key in ("sweep_f32_256", "sweep_bf16_256", "sweep_f32_512"):
        sweeps(key, "cg_sweep_march")
    for key, ref, tol in (("sweep_f32_64", "step_exact_64", SWEEP_F32_TOL),
                          ("sweep_f32_256", "step_exact_256", SWEEP_F32_TOL),
                          ("sweep_bf16_256", "step_exact_256",
                           COMPACT_OBJ_TOL)):
        want = rows[ref][1]
        rel = abs(rows[key][1] - want) / want
        require(rel <= tol, "phase 40: %s objective %.3f vs %s %.3f (rel "
                "%.3g > %g)" % (key, rows[key][1], ref, want, rel, tol))
    for key in ("sweep_f32_512", "apply_exact_512"):
        obj = rows[key][1]
        require(abs(obj - BIG_ANCHOR) <= ANCHOR_BAND * BIG_ANCHOR, "phase "
                "40: %s objective %.2f, anchor %.1f" % (key, obj, BIG_ANCHOR))
    print("phase 40 solves 50x10 (ms a solve by CUDA events, median; "
          "objective; launches): %s [%s]" % ("; ".join(
              "%s %.3f ms, %.6f, %s" % (k, v[0], v[1], v[2])
              for k, v in rows.items()), card))
    print("phase 40 \"sweep\" against the default routes (ms a solve): 256^3 "
          "sweep f32 %.3f / bf16 %.3f vs step exact %.3f; 512^3 sweep %.3f vs "
          "apply %.3f [%s]" % (
              rows["sweep_f32_256"][0], rows["sweep_bf16_256"][0],
              rows["step_exact_256"][0], rows["sweep_f32_512"][0],
              rows["apply_exact_512"][0], card))
    return rows


def run_sweep_phase(device, card):
    """Phase 40: ``cg_sweep`` on its march (``csrc/sweep_march.cu``). Its
    rule in C against its Python mirror; every form (float32 and bf16
    state × first trip or not) bit for bit against the three-pass chain on
    the tile-edge shapes, 256³, the 136 × 240 × 200 volume (two seeds) and
    512³, the dots within :data:`SWEEP_DOT_TOL`; a NaN in p; the refusals;
    the ptxas report; device times chain against march in turns at 256³
    and 512³ (both storages) and at the route's boundary shapes; the
    march against the plain version at 256³; and the solves that run it.
    Returns the ``kernels`` records of the march."""
    import torch

    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import tiled as T

    bf = torch.bfloat16
    print("phase 40 rules: C and Python agree on the sweep's route and z "
          "tile; %s" % vol_rule_checks(T, device, ("cg_sweep",)))
    forms = 0
    for label, cov, sp, shape in EDGE_CASES + (
            ("image", np.eye(3), None, (1, 40, 33)),):
        st = B.Stencils.from_cov(cov, 3, sp, device)
        forms += sweep_march_bits(B, st, shape, device, 40)
    iso = np.diag([SIGMA ** 2] * 3)
    st = B.Stencils.from_cov(iso, 3, None, device)
    for label, shape, seeds in SWEEP_BIT_SHAPES:
        for seed in seeds:
            forms += sweep_march_bits(B, st, shape, device, seed)
    print("phase 40 %d sweep forms (f32 / bf16 state x first trip or not) on "
          "the tile-edge shapes, the (1, 40, 33) view, %s: x', r', p', q' "
          "bit for bit equal to the chain's, the dots, a and beta within %g"
          % (forms, ", ".join("%s seeds %s" % (k, v)
                              for k, _, v in SWEEP_BIT_SHAPES), SWEEP_DOT_TOL))
    for dt in (torch.float32, bf):
        sweep_nan_routes(B, st, RAGGED_SHAPE, device, dt)
    print("phase 40 a NaN in p (f32, bf16, ragged volume): the march's NaN "
          "at the chain's entries, beta NaN; %d refusals (q' over q on each "
          "route, a march past its shared memory)" % sweep_refusals(
              B, st, device))
    print("phase 40 ptxas of the sweep's march instances ({template "
          "arguments: (registers, spill bytes, warps an SM)}): %s" % (
              {k: v for k, v in march_ptxas().items() if "SweepZyEpi" in k}
              or "cached"))
    lap("phase 40 checks")
    # the march against the plain version at 256³, in the main path's form
    err, ms, plain_ms = {}, {}, {}
    for name, (dt, _) in SWEEP_ENTRIES.items():
        dtype = getattr(torch, dt)
        x, r, p, q = sweep_inputs(SCALE_SHAPE, device, 44)
        rs, ps, qs = r.to(dtype), p.to(dtype), q.to(dtype)
        s1, s2, xk, xp = _scal(device), _scal(device), x.clone(), x.clone()
        got = B._cg_sweep(xk, rs, ps, qs, s1, st.normal, st.inv_h2, RHO,
                          False, route="march")
        qp = qs.clone()
        ref = B.cg_sweep_plain(xp, rs, ps, qp, s2, st.normal, st.inv_h2, RHO)
        pairs = list(zip((xk,) + got + (s1,), (xp,) + ref + (qp, s2)))
        compact_pairs_err({name: pairs})
        err[name] = max(float((g.float() - f.float()).abs().max())
                        for g, f in pairs[:4])
        del got, ref, pairs, qp
        ms[name] = cuda_median_ms(partial(
            B._cg_sweep, xk, rs, ps, qs, s1, st.normal, st.inv_h2, RHO,
            False, route="march"), 10)
        plain_ms[name] = cuda_median_ms(partial(
            B.cg_sweep_plain, xp, rs, ps, qs.clone(), s2, st.normal,
            st.inv_h2, RHO), 2)
        del x, r, p, q, rs, ps, qs, xk, xp
        torch.cuda.empty_cache()
    print("phase 40 march vs plain at 256^3: max |d| %s; ms a call by CUDA "
          "events (march / plain): %s [%s]" % (
              {k: "%.3g" % v for k, v in err.items()},
              {k: "%.4f / %.3f" % (ms[k], plain_ms[k]) for k in ms}, card))
    dev = {}
    for label, shape in (("256^3", SCALE_SHAPE), ("512^3", BIG)):
        for dtype in (torch.float32, bf):
            turns = sweep_turns(B, st, shape, device, dtype,
                                reps=10 if shape == SCALE_SHAPE else 5)
            dev[(label, dtype)] = turns
            print("phase 40 %s %s device ms a call (torch.profiler, the "
                  "median of %d traces a turn; turns chain, march, march, "
                  "chain): %s [%s]" % (
                      label, str(dtype).split(".")[-1], SWEEP_TRACES,
                      sweep_turns_text(turns, shape, dtype), card))
    for label, shape in SWEEP_ROUTE_SHAPES:
        stl = st if shape[0] > 1 else B.Stencils.from_cov(
            np.eye(2), 3, None, device)
        view = shape if shape[0] > 1 else shape[1:]
        turns = sweep_turns(B, stl, view, device, torch.float32, reps=20,
                            traces=1)
        print("phase 40 route %s (rule: %s) f32 device ms a call: %s [%s]"
              % (label, T.vol_route("cg_sweep", stl.normal.as_volume()
                                    .lengths, shape),
                 sweep_turns_text(turns, view, torch.float32), card))
    lap("phase 40 times")
    rows = sweep_solves(device, card)
    lap("phase 40 solves")
    out = []
    for name, (dt, run) in SWEEP_ENTRIES.items():
        dtype = getattr(torch, dt)
        b_ms, b_by = sweep_bound(SCALE_SHAPE, dtype)
        out.append({"name": name, "route": "cuda",
                    "source": "nsol_tpu_torch/csrc/sweep_march.cu",
                    "replaces": "nsol_tpu/ops/pallas/blocked.py:1139",
                    "launches": int(rows[run + "_256"][2].get(
                        "cg_sweep_march", 0)),
                    "max_abs_err": err[name], "ms": ms[name],
                    "plain_ms": plain_ms[name], "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None,
                    "device_ms": traces_ms(dev[("256^3", dtype)]["march"])})
        require(out[-1]["launches"] > 0, "phase 40: %s launched no time on "
                "its main path (%s)" % (name, run))
    return out


def run_admm_phases(device, card):
    """Phases 3-6: the linear ADMM deconvolution path. Returns the launch
    counts of the 256³ solve (the launch sequence's units; the 64³ solve is
    one persistent launch), each unit's max |Δ| against its plain version
    at 64³ and its (kernel ms, plain ms) per call there, and the 64³
    persistent solve's launches, max |Δ| and ms against its plain
    version."""
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
    # the fused route's one cooperative launch (csrc/admm_persistent.cu),
    # none of the launch sequence's units
    launches = F.launch_counts(F.PERSISTENT_UNITS + F.ADMM_UNITS
                               + F.MARCH_UNITS)
    plain_calls = F.plain_counts()
    require(launches["admm_persistent"] == 1
            and all(n == 0 for k, n in launches.items()
                    if k != "admm_persistent"),
            "phase 4: not the one persistent launch: %s" % launches)
    require(all(n == 0 for n in plain_calls.values()),
            "phase 4: a plain version ran: %s" % plain_calls)
    # the plain solve, timed once (its ms informs; it is no yardstick)
    x_p, ms_p = timed_once(lambda: solve.plain(b, b, ALPHA, RHO))
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
    F.reset_counts()
    xb_k = solve_big(bb, bb, ALPHA, RHO)
    torch.cuda.synchronize()
    big_routes = route_launches(F)["cg_step"]
    require(big_routes == (0, ITERATIONS * ITER_MAX), "phase 5: cg_step "
            "launches (chain, march) %s, not all on the march" % (big_routes,))
    # the launch sequence's units on their main path at scale (the 64³
    # solve takes the persistent launch)
    unit_launches = F.launch_counts(F.ADMM_UNITS + F.MARCH_UNITS)
    require(all(n > 0 for n in unit_counts(F, F.ADMM_UNITS).values())
            and F.launch_counts()["admm_persistent"] == 0,
            "phase 5: a kernel was not launched: %s" % unit_launches)
    xb_p, msb_p = timed_once(lambda: solve_big.plain(bb, bb, ALPHA, RHO))
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
    times256 = kernel_times(B, F, B.Stencils.from_cov(iso, 3, None, device),
                            big, device, rng, reps=10)
    print("phase 5 scale 256^3: objective %.1f (JAX package, information "
          "only: %.1f); kernel vs plain objective rel %.3e, voxel %.3e; "
          "launches %s; cg_step launches (chain, march) %s; "
          "kernel %.1f ms/solve = %.2f it/s, plain %.1f ms/solve = %.2f "
          "it/s; per-call (kernel ms, plain ms): %s [%s]"
          % (ob_k, SCALE_OBJECTIVE_JAX, ob_rel, vox_b, unit_launches,
             big_routes, msb_k,
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

    return {"launches": unit_launches, "err": main_err, "times": times64,
            "persistent": {"launches": launches["admm_persistent"],
                           "err": float((x_k - x_p).abs().max()),
                           "ms": ms_k, "plain_ms": ms_p}}


# -------------------------------------------------------- phases 41-43 --

#: the full covariances of phases 41-43 (σ 1 on each axis, correlated)
FULL_COV3 = np.array([[1.0, 0.4, 0.0], [0.4, 1.0, 0.2], [0.0, 0.2, 1.0]])
FULL_COV2 = np.array([[1.0, 0.4], [0.4, 1.0]])
#: phase 41's band of a float32 blur form against another (× max |ref|)
BLUR_FORM_TOL = 1e-5
#: phase 42's solves: name → (image, minimizer, data loss, α, iterations);
#: each is the TK1 Tikhonov problem ``tikhonov_solve`` minimizes, from
#: x0 = b, bounds (0, ∞), on ``engine_problem(image)``
ENGINE_CASES = {
    "lsq_linear 256^3": ("256^3", "lsq_linear", "linear", 0.01, 20),
    "least_squares soft_l1 Lena": ("lena", "least_squares", "soft_l1",
                                   0.01, 20),
    "L-BFGS-B huber 64^3": ("64^3", "L-BFGS-B", "huber", 0.01, 20),
    "L-BFGS-B cauchy 64^3": ("64^3", "L-BFGS-B", "cauchy", 0.01, 20),
    "L-BFGS-B huber Lena": ("lena", "L-BFGS-B", "huber", 0.01, 20),
    "L-BFGS-B cauchy Lena": ("lena", "L-BFGS-B", "cauchy", 0.01, 20),
}
#: their float64 objectives by the JAX package on the CPU
#: (tests/torch_anchors.py ``engine_anchors``)
ENGINE_ANCHORS = {
    "lsq_linear 256^3": 20569.61652822998,
    "least_squares soft_l1 Lena": 58.085129100359225,
    "L-BFGS-B huber 64^3": 230.0060161284044,
    "L-BFGS-B cauchy 64^3": 229.71650179121067,
    "L-BFGS-B huber Lena": 58.1458801403605,
    "L-BFGS-B cauchy Lena": 58.02719067585912,
}
#: the bands of the card's float32 solves against them: FISTA is a fixed
#: linear recurrence (1e-4); the L-BFGS line search may take another
#: branch in float32 (1e-3)
ENGINE_BANDS = {"lsq_linear": 1e-4, "least_squares": 1e-3,
                "L-BFGS-B": 1e-3}


def engine_problem(image):
    """``(b, x_true, cov)`` of phase 42's image (float64 numpy): the 64³
    phantom stand-in, it repeated 4× along each axis (256³), or the Lena
    256² stand-in, over 255, blurred by the full covariance (wrap, by the
    host's FFT) with Gaussian noise at 0.05·max (``Noise(seed=1)``)."""
    from nsol_tpu_torch import data
    from nsol_tpu_torch.io import read_nifti, read_png
    from nsol_tpu_torch.noise import Noise
    from nsol_tpu_torch.ops import conv as C
    from nsol_tpu_torch.ops import kernels as K

    if image == "lena":
        x = read_png(data.path("2D_Lena_256.png")).astype(np.float64) / 255
        cov = FULL_COV2
    else:
        x = read_nifti(data.path("3D_SheppLoganPhantom_64.nii.gz")).data
        x = np.asarray(x, np.float64) / 255
        if image == "256^3":
            for ax in range(3):
                x = np.repeat(x, 4, axis=ax)
        cov = FULL_COV3
    kern = K.gaussian_kernel(cov, alpha_cut=3, dtype=np.float64)
    khat = np.fft.rfftn(C.embed_kernel_fft(kern, x.shape))
    axes = tuple(range(x.ndim))
    b = np.fft.irfftn(np.fft.rfftn(x, axes=axes) * khat.real, s=x.shape,
                      axes=axes)
    noise = Noise(b, seed=1)
    noise.add_gaussian_noise(noise_level=0.05)
    return noise.get_noisy_data(), x, cov


def engine_objective(x, b, A, D, alpha, loss, minimizer, xp):
    """The cost ``minimizer`` minimizes (``xp``: torch, or jax.numpy for
    the anchors): ``½Σρ((Ax−b)²) + α/2‖Dx‖²``, the regulariser inside the
    loss for least_squares."""
    def cost(r):
        f2 = r * r
        if loss == "linear":
            rho = f2
        elif loss == "soft_l1":
            rho = 2.0 * (xp.sqrt(1.0 + f2) - 1.0)
        elif loss == "huber":
            g = 1.345
            rho = xp.where(f2 < g * g, f2, 2.0 * g * xp.sqrt(f2) - g * g)
        else:
            rho = xp.log1p(f2)
        return 0.5 * xp.sum(rho)

    Dx = D(x)
    if minimizer == "least_squares":
        return float(cost(A(x) - b) + cost(np.sqrt(alpha) * Dx))
    return float(cost(A(x) - b) + 0.5 * alpha * xp.sum(Dx * Dx))


def blur_form_checks(device, res):
    """Phase 41's checks and times; fills ``res``."""
    import torch
    import torch.nn.functional as Fn

    from nsol_tpu_torch.ops import conv as C
    from nsol_tpu_torch.ops import kernels as K
    from nsol_tpu_torch.ops.cuda import blocked as B
    from nsol_tpu_torch.ops.cuda import robust as R

    g = torch.Generator(device=device).manual_seed(41)

    def rand(shape, dtype=torch.float32):
        return torch.rand(shape, generator=g, device=device, dtype=dtype)

    iso = np.eye(3)
    for n in (64, 256, 512):
        shape = (n,) * 3
        x = rand(shape)
        fft, _ = C.make_blur_operators(iso, shape=shape, method="fft")
        sep, _ = C.make_blur_operators(iso, method="separable")
        ref = sep(x)
        err = max_rel(fft(x), ref)
        require(err <= BLUR_FORM_TOL, "phase 41: fft vs separable %d^3 %.3g"
                % (n, err))
        res["fft vs separable %d^3" % n] = err
        del x, ref
    torch.cuda.empty_cache()
    kern = K.gaussian_kernel(FULL_COV3, alpha_cut=3, dtype=np.float32)
    for n in (64, 256):
        shape = (n,) * 3
        x = rand(shape)
        fft, _ = C.make_blur_operators(FULL_COV3, shape=shape)
        direct, _ = C.make_blur_operators(FULL_COV3, method="direct")
        # trap: PyTorch runs a float32 cuDNN convolution in TF32 unless
        # told not to; convolve turns it off itself, so the check runs
        # with the process-wide switch back at PyTorch's default (True)
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            got = direct(x)
            require(torch.backends.cudnn.allow_tf32,
                    "phase 41: convolve left TF32 switched off")
            xp = Fn.pad(x[None, None], (3,) * 6, mode="circular")
            kf = torch.as_tensor(kern[::-1, ::-1, ::-1].copy(),
                                 device=device)[None, None]
            tf32 = Fn.conv3d(xp, kf)[0, 0]
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        ref = fft(x)
        err = max_rel(got, ref)
        require(err <= BLUR_FORM_TOL, "phase 41: direct (TF32 at its "
                "default) vs fft %d^3 %.3g" % (n, err))
        res["direct vs fft %d^3 (TF32 default on)" % n] = err
        res["a TF32 conv3d vs fft %d^3 (what convolve avoids)" % n] = \
            max_rel(tf32, ref)
        nA = C.make_normal_blur_operator(FULL_COV3, shape=shape)
        err = max_rel(nA(x), fft(fft(x)))
        require(err <= BLUR_FORM_TOL, "phase 41: fft normal vs A(A x) "
                "%d^3 %.3g" % (n, err))
        res["fft normal vs A_adj(A x) %d^3" % n] = err
        del x, got, ref, xp, tf32
    torch.cuda.empty_cache()
    shape = (64,) * 3
    x, y = rand(shape, torch.float64), rand(shape, torch.float64)
    for method in ("fft", "direct"):
        A, At = C.make_blur_operators(FULL_COV3, shape=shape, method=method)
        lhs, rhs = float(torch.sum(A(x) * y)), float(torch.sum(x * At(y)))
        err = abs(lhs - rhs) / abs(lhs)
        require(err <= 1e-10, "phase 41: %s adjointness %.3g"
                % (method, err))
        res["<Ax,y> vs <x,A^T y> %s float64" % method] = err

    times = {}
    for n in (256, 512):
        shape = (n,) * 3
        x = rand(shape)
        for method in ("fft", "direct"):
            A, _ = C.make_blur_operators(FULL_COV3, shape=shape,
                                         method=method)
            dev, _ = device_ms(lambda: A(x), 5, warmup=2)
            times["%s %d^3" % (method, n)] = (
                dev, cuda_ms(lambda: A(x), 5, warmup=1),
                bound(8.0 * x.numel(), x.numel() * (
                    2.0 * kern.size if method == "direct"
                    else 5.0 * np.log2(x.numel())))[0])
        del x
        torch.cuda.empty_cache()
    st = B.Stencils.from_cov(iso, 3, None, device, torch.float32)
    y = rand((256,) * 3)
    times["separable march blur_apply 256^3 (iso)"] = (
        device_ms(lambda: R.blur_apply(y, st.blur, st.inv_h2), 5)[0],
        cuda_ms(lambda: R.blur_apply(y, st.blur, st.inv_h2), 5),
        unit_bound("blur_apply", y.numel(), st.blur.lengths)[0])
    sep, _ = C.make_blur_operators(iso, method="separable")
    times["separable torch rolls 256^3 (iso)"] = (
        device_ms(lambda: sep(y), 5)[0], cuda_ms(lambda: sep(y), 5),
        bound(8.0 * y.numel(), 0.0)[0])
    return times


def engine_solves(device, res, reads):
    """Phase 42's solves against their anchors; fills ``res`` and
    ``reads`` (L-BFGS host reads a solve)."""
    import torch

    from nsol_tpu_torch.ops import conv as C
    from nsol_tpu_torch.ops import grad as G
    from nsol_tpu_torch.solvers import lbfgs
    from nsol_tpu_torch.solvers.tikhonov import tikhonov_solve

    made = None
    for name, (image, minimizer, loss, alpha, iters) in ENGINE_CASES.items():
        if made != image:
            b_np, _, cov = engine_problem(image)
            made = image
        A, _ = C.make_blur_operators(cov, shape=b_np.shape)
        b = torch.as_tensor(b_np, dtype=torch.float32, device=device)
        reads0 = lbfgs.HOST_READS[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        x = tikhonov_solve(A, A, G.gradient, G.gradient_adjoint, b, 0.0, b,
                           alpha, data_loss=loss, minimizer=minimizer,
                           iter_max=iters)
        t1.record()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        b64 = torch.as_tensor(b_np, device=device)
        obj = engine_objective(x.double(), b64, A, G.gradient, alpha, loss,
                               minimizer, torch)
        anchor = ENGINE_ANCHORS[name]
        dev = abs(obj - anchor) / abs(anchor)
        band = ENGINE_BANDS[minimizer]
        require(bool(torch.isfinite(x).all()) and dev <= band,
                "phase 42: %s objective %.9g vs anchor %.9g (rel %.3g, band "
                "%.0e)" % (name, obj, anchor, dev, band))
        reads[name] = lbfgs.HOST_READS[0] - reads0
        res[name] = "%.9g (anchor %.9g, rel %.2e, band %.0e), %.1f ms, %d " \
            "host reads, peak %.0f MiB" % (obj, anchor, dev, band,
                                           t0.elapsed_time(t1),
                                           reads[name], peak)
        del x, b, b64
    torch.cuda.empty_cache()


def engine_extras(device, res):
    """Phase 42's ``Optimize`` methods and PCA classes on the card against
    their CPU results (float64)."""
    import torch

    from nsol_tpu_torch.optimize import Optimize
    from nsol_tpu_torch.pca import (AdmmRobustPrincipalComponentAnalysis,
                                    AlmRobustPrincipalComponentAnalysis,
                                    PrincipalComponentAnalysis)

    rs = np.random.RandomState(42)
    M = rs.rand(30, 20)
    b = M @ rs.rand(20) + 0.05 * rs.randn(30)
    Q = M.T @ M + 5 * np.eye(20)

    def run(where):
        t = partial(torch.as_tensor, device=where)
        Mt, bt, Qt = t(M), t(b), t(Q)
        A, At = (lambda v: Mt @ v), (lambda y: Mt.T @ y)
        return {
            "lsmr": Optimize.lsmr(A, At, bt, iter_max=50),
            "cg": Optimize.cg(lambda v: Qt @ v, At(bt), iter_max=50),
            "nnls": Optimize.nnls(A, At, bt, iter_max=30, cg_iters=12),
            "least_squares": Optimize.least_squares(
                lambda v: A(v) - bt, torch.zeros(20, dtype=torch.float64,
                                                 device=where),
                bounds=(0, np.inf), iter_max=40),
            "minimize": Optimize.minimize(
                lambda v: torch.sum((v - bt[:20]) ** 2),
                torch.zeros(20, dtype=torch.float64, device=where),
                iter_max=40)}

    on_card, on_cpu = run(device), run("cpu")
    for k in on_card:
        err = max_rel(on_card[k].cpu(), on_cpu[k])
        require(err <= 1e-8, "phase 42: Optimize.%s card vs CPU %.3g"
                % (k, err))
        res["Optimize.%s card vs CPU" % k] = err

    pts = rs.randn(2000, 3) * np.array([5.0, 2.0, 0.5])
    low = rs.randn(40, 3) @ rs.randn(3, 30)
    D = low + 10 * rs.randn(40, 30) * (rs.rand(40, 30) < 0.05)
    pcas = {}
    for where in (device, "cpu"):
        pca = PrincipalComponentAnalysis(pts, device=where)
        pca.run()
        L, S = AlmRobustPrincipalComponentAnalysis(D, device=where).fit()
        h = AdmmRobustPrincipalComponentAnalysis(D, device=where).run()
        pcas[str(where)] = (pca.get_eigval(), L, S, h)
    card, cpu = pcas[str(device)], pcas["cpu"]
    for label, got, want, tol in (
            ("PCA eigenvalues", card[0], cpu[0], 1e-12),
            ("ALM RPCA L", card[1], cpu[1], 1e-8),
            ("ALM RPCA S", card[2], cpu[2], 1e-8),
            ("ADMM RPCA X3", card[3]["X3_admm"], cpu[3]["X3_admm"], 1e-8),
            ("ADMM RPCA X2", card[3]["X2_admm"], cpu[3]["X2_admm"], 1e-8)):
        # the ADMM split's X2 may be all zeros: relative to max(|·|, 1)
        err = float(np.max(np.abs(got - want))
                    / max(np.max(np.abs(want)), 1.0))
        require(err <= tol, "phase 42: %s card vs CPU %.3g" % (label, err))
        res["%s card vs CPU" % label] = err
    require(card[3]["admm_iter"] == cpu[3]["admm_iter"],
            "phase 42: ADMM RPCA iterations %d vs %d"
            % (card[3]["admm_iter"], cpu[3]["admm_iter"]))


def corrupt_and_generate(device, res, tmp):
    """Phase 43's ``nsol_torch_corrupt_data`` runs against the library's
    blur + ``Noise`` on the card, bit for bit, and
    ``generate_standalone_data`` into a temporary directory."""
    from nsol_tpu_torch import data
    from nsol_tpu_torch.cli import corrupt_data
    from nsol_tpu_torch.io import DataReader

    out = {}
    for name in ("2D_Lena_256.png", "3D_SheppLoganPhantom_64.nii.gz"):
        src = data.path(name)
        reader = DataReader(src)
        reader.read_data()
        for noise in ("gaussian", "salt_and_pepper"):
            dst = os.path.join(tmp, "%s_%s.%s" % (
                name.split(".")[0], noise, name.split(".", 1)[1]))
            rc = corrupt_data.main(["--filename", src, "--result", dst,
                                    "--noise", noise])
            want = corrupt_data.corrupt(reader.get_data(), [1], noise, 0.05,
                                        device)
            got = DataReader(dst)
            got.read_data()
            got = got.get_data()
            if dst.endswith(".png"):
                want = np.round(want).astype(np.uint8)
            same = (rc == 0 and got.shape == want.shape
                    and np.array_equal(got.astype(want.dtype), want))
            require(same, "phase 43: nsol_torch_corrupt_data %s %s differs "
                    "from the library's blur + Noise" % (name, noise))
            res["corrupt_data %s %s" % (name, noise)] = \
                "bit for bit the library's"
            out[(name, noise)] = dst
    gen = os.path.join(tmp, "generated")
    t0 = time.perf_counter()
    data.generate_standalone_data(gen)
    data.verify_standalone_data(gen)
    res["generate_standalone_data"] = "9 files, frozen hashes, %.1f s" % (
        time.perf_counter() - t0)
    return out


def corrupted_cli_solves(device, res, obs, tmp):
    """Phase 43's ``nsol_torch_run_deconvolution`` runs on the corrupted
    Lena against the library's solve of the same problem."""
    from nsol_tpu_torch.cli import run_deconvolution
    from nsol_tpu_torch.interface import DeconvolutionSolverStudyInterface
    from nsol_tpu_torch.io import DataReader
    from nsol_tpu_torch.ops import conv as C
    from nsol_tpu_torch.ops import grad as G

    reader = DataReader(obs)
    reader.read_data()
    b = reader.get_data()
    cov, spacing = np.eye(2), np.ones(2)
    for flags in (["--minimizer", "lsq_linear"],
                  ["--minimizer", "L-BFGS-B", "--data-loss", "huber"]):
        dst = os.path.join(tmp, "x.nii.gz")
        t0 = time.perf_counter()
        rc = run_deconvolution.main(["--observation", obs, "--result", dst,
                                     "--iterations", "10"] + flags)
        ms = 1e3 * (time.perf_counter() - t0)
        got = DataReader(dst)
        got.read_data()
        minimizer = flags[1]
        loss = flags[3] if len(flags) > 2 else "linear"
        A, At = C.make_blur_operators(cov, spacing=spacing, shape=b.shape)
        D, Dt = G.make_gradient_operators(spacing)
        iface = DeconvolutionSolverStudyInterface(
            A=A, A_adj=At, D=D, D_adj=Dt, b=b, x0=np.array(b), alpha=0.01,
            x_scale=np.max(b), data_loss=loss, data_loss_scale=1.0,
            iter_max=10, iterations=10, minimizer=minimizer, measures=[],
            dimension=2, reconstruction_type="TVL2", rho=0.5, x_ref=None,
            tv_solver="PD", verbose=0, normal_A=None, normal_B=None,
            irls_cg_iters=8, blur_cov=cov, spacing=spacing, device=device)
        iface.set_up_solver()
        solver = iface.get_solver()
        solver.run()
        want = solver.get_x()
        require(rc == 0 and np.array_equal(got.get_data(), want),
                "phase 43: run_deconvolution %s differs from its library "
                "solve (max %.3g)" % (" ".join(flags), float(np.max(np.abs(
                    got.get_data() - want)))))
        res["run_deconvolution %s" % " ".join(flags)] = \
            "bit for bit the library's, %.0f ms (CLI)" % ms


def sharded_engine_solves(device, res):
    """Phase 43's sharded routes on a NCCL group of world size 1 against
    the unsharded port solves of the same problem."""
    import torch

    from nsol_tpu_torch.ops import conv as C
    from nsol_tpu_torch.ops import grad as G
    from nsol_tpu_torch.parallel import distributed as dist
    from nsol_tpu_torch.parallel import make_space_mesh, sharded_tv_admm_solve
    from nsol_tpu_torch.solvers.admm import admm_solve

    b_np, _, cov = engine_problem("64^3")
    b = torch.as_tensor(b_np, dtype=torch.float32, device=device)
    dist.initialize(coordinator_address="localhost:%d" % free_port(),
                    num_processes=1, process_id=0)
    try:
        mesh = make_space_mesh()
        for loss, minimizer, its, inner in (("linear", "lsmr", 5, 5),
                                            ("huber", "L-BFGS-B", 3, 4)):
            t0 = time.perf_counter()
            x = sharded_tv_admm_solve(mesh, cov, b, b, ALPHA, RHO,
                                      iterations=its, iter_max=inner,
                                      data_loss=loss)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            # the unsharded solves over the same (direct) blur and the FFT
            # one: objectives within 1e-4, and for lsmr (a fixed linear
            # recurrence) the voxels too; the float32 L-BFGS path is not
            # reproducible run to run on the card (its line search may
            # take another branch), so its voxels are reported
            A64, _ = C.make_blur_operators(cov, shape=b.shape)
            objective = (objective_device if loss == "linear"
                         else robust_objective)
            obj = objective(x, b, A64, ALPHA)
            gaps = []
            for method in ("direct", "fft"):
                A, _ = C.make_blur_operators(cov, shape=b.shape,
                                             method=method)
                want, _ = admm_solve(A, A, G.gradient, G.gradient_adjoint, b,
                                     0.0, b, ALPHA, RHO, iterations=its,
                                     iter_max=inner, data_loss=loss,
                                     minimizer=minimizer)
                gaps += [max_rel(x, want),
                         abs(obj - objective(want, b, A64, ALPHA)) / obj]
            ok = gaps[1] <= 1e-4 and gaps[3] <= 1e-4 and (
                minimizer != "lsmr" or max(gaps[0], gaps[2]) <= 1e-4)
            require(ok, "phase 43: sharded "
                    "%s %s vs the unsharded solves (direct voxels, objective;"
                    " fft voxels, objective) %s" % (loss, minimizer, gaps))
            res["sharded %s %s world 1" % (loss, minimizer)] = \
                "objective %.6f; vs unsharded direct: voxels %.2e, " \
                "objective %.2e; vs fft: voxels %.2e, objective %.2e; " \
                "%.0f ms" % tuple([obj] + gaps + [ms])
    finally:
        torch.distributed.destroy_process_group()


def run_engine_phases(device, card):
    """Phases 41-43: the non-separable blur forms, the remaining Tikhonov
    engines, ``Optimize`` and PCA, corruption and generation, and the
    sharded non-separable routes, on the card."""
    res41, res42, res43, reads = {}, {}, {}, {}
    times = blur_form_checks(device, res41)
    print("phase 41 blur forms (float32; full covariance %s): %s; device "
          "ms (profiler, CUDA events, bound) %s [%s]"
          % (FULL_COV3.tolist(), res41, times, card))
    lap("phase 41")
    engine_solves(device, res42, reads)
    engine_extras(device, res42)
    print("phase 42 engines (float32 on the card vs float64 anchors of the "
          "JAX package on the CPU): %s [%s]" % (res42, card))
    lap("phase 42")
    with tempfile.TemporaryDirectory() as tmp:
        out = corrupt_and_generate(device, res43, tmp)
        corrupted_cli_solves(device, res43, out[("2D_Lena_256.png",
                                                 "gaussian")], tmp)
    sharded_engine_solves(device, res43)
    print("phase 43 corruption, generation, sharded routes: %s [%s]"
          % (res43, card))
    lap("phase 43")
    return {"times": times, "reads": reads}


# ------------------------------------------------------------- phase 44 --

#: the kernel of each unit a traced CLI run must name (the units the
#: untraced run launched)
TRACE_KERNELS = {"pd_persistent": "pd_persistent_kernel",
                 "admm_persistent": "admm_persistent_kernel"}


def np_bits(a, b):
    """Whether two numpy arrays hold the same bits (dtype, shape, bytes)."""
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def used_counts(F):
    """The launch counts of every unit that launched, and the plain calls."""
    return ({k: v for k, v in F.launch_counts().items() if v},
            {k: v for k, v in F.plain_counts().items() if v})


def batch_sweep_cases(device, tmp):
    """Phase 44's three sweeps, each a ``run(mesh)`` returning ``{name:
    numpy array}`` of everything it computed: the Man 1024² × 64 α PD TVL2
    sweep with records, the Lena TK1L2 × 64 α sweep with records (phase
    17), and the Lena TV-L2 ADMM study, 8 α × 2 ρ (phase 18), through
    ``ADMMLinearSolverParameterStudy`` into ``tmp`` (its files read
    back)."""
    import torch

    from nsol_tpu_torch import data
    from nsol_tpu_torch.cli.run_denoising import denoising_proxes
    from nsol_tpu_torch.io import read_png
    from nsol_tpu_torch.observer import Observer
    from nsol_tpu_torch.ops import grad as G
    from nsol_tpu_torch.ops import losses, priors
    from nsol_tpu_torch.ops import measures as sim
    from nsol_tpu_torch.solvers.wrappers import (ADMMLinearSolver,
                                                 PrimalDualSolver,
                                                 TikhonovLinearSolver)
    from nsol_tpu_torch.study import (ADMMLinearSolverParameterStudy,
                                      ReaderParameterStudy)

    def tensor(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    man = read_png(data.path("2D_Man_1024.png")).astype(np.float64)
    s = float(man.max())
    D, Dt = G.make_gradient_operators()
    bm = tensor(man / s)
    prox_f, prox_g = denoising_proxes("TVL2", bm)
    pd = PrimalDualSolver(prox_f, prox_g, D, Dt, L2=PD_L2, x0=man,
                          iterations=ITERATIONS, x_scale=s,
                          reconstruction_type="TVL2", observation=man / s,
                          device=device)
    b_man = tensor(man)
    pd_measures = {
        "Reg": lambda x: priors.total_variation(tensor(x), D),
        "Data": lambda x: sim.sum_of_squared_differences(tensor(x), b_man)}
    pd_grid = {"alpha": np.linspace(0.01, 1.5, 64, dtype=np.float32)
               .astype(np.float64)}

    img, xs, A, D2, Dt2 = lena_problem()
    bt = torch.as_tensor(img, dtype=torch.float64, device=device)
    tik = TikhonovLinearSolver(
        A, A, img, D2, Dt2, img, x_scale=xs, minimizer="auto",
        iter_max=TK_ITER_MAX, blur_cov=np.eye(2), spacing=np.ones(2),
        reg_kind="TK1", device=device)
    tik_measures = {
        "Reg": lambda x: 0.5 * torch.sum(D2(x) * D2(x)),
        "Data": lambda x: losses.cost_from_residual(A(x) - bt.to(x.dtype))}
    tik_grid = {"alpha": TK_ALPHAS.astype(np.float64)}

    admm = ADMMLinearSolver(
        A, A, img, D2, Dt2, img, x_scale=xs, minimizer="auto",
        iterations=ITERATIONS, iter_max=ITER_MAX, blur_cov=np.eye(2),
        spacing=np.ones(2), device=device)
    admm_measures = {
        "Reg": lambda x: torch.sum(torch.sqrt(torch.sum(D2(x) ** 2, 0))),
        "Data": lambda x: losses.cost_from_residual(A(x) - bt.to(x.dtype))}

    def sweep(solver, grid, measures):
        def run(mesh):
            x, recs = solver.run_sweep(grid, measures=measures, mesh=mesh)
            return dict({"x": x}, **{k: v for k, v in recs.items()})
        return run

    def study(mesh):
        observer = Observer()
        observer.set_measures(admm_measures)
        ADMMLinearSolverParameterStudy(
            admm, observer, dir_output=tmp, name="tv",
            parameters={"alpha": TV_ALPHAS.astype(np.float64),
                        "rho": list(TV_RHOS)}, mesh=mesh).run()
        reader = ReaderParameterStudy(directory=tmp, name="tv")
        reader.read_study()
        out = {k: reader.get_results(k) for k in ("Reg", "Data")}
        out.update(reader.get_reconstructions().items())
        return out

    return {"Man 1024^2 x 64 alpha PD TVL2 records": sweep(
                pd, pd_grid, pd_measures),
            "Lena TK1L2 x 64 alpha records": sweep(tik, tik_grid,
                                                   tik_measures),
            "Lena TV-L2 ADMM study 8 alpha x 2 rho": study}


def batch_mesh_runs(device, card):
    """Phase 44, the batch mesh: each of :func:`batch_sweep_cases` with no
    mesh and through ``make_mesh((1,), ("batch",))`` on a NCCL group of
    world size 1, in turns (none, batch, batch, none) after a warm-up: the
    same bits, the same launch counts, and the wall ms of each turn by
    CUDA events."""
    import torch

    from nsol_tpu_torch.ops.cuda import fused as F
    from nsol_tpu_torch.parallel import distributed as dist
    from nsol_tpu_torch.parallel import make_mesh

    dist.initialize(coordinator_address="localhost:%d" % free_port(),
                    num_processes=1, process_id=0)
    rows = {}
    try:
        mesh = make_mesh((1,), ("batch",))
        require(mesh.shape == {"batch": 1} and mesh.group is not None,
                "phase 44: %r" % mesh)
        with tempfile.TemporaryDirectory() as tmp:
            for name, run in batch_sweep_cases(device, tmp).items():
                want = run(None)  # warm-up; the bits every turn must give
                ms, counts = {"none": [], "batch": []}, []
                for turn in ("none", "batch", "batch", "none"):
                    torch.cuda.synchronize()
                    F.reset_counts()
                    got, t = timed_once(lambda: run(
                        mesh if turn == "batch" else None))
                    ms[turn].append(t)
                    counts.append(used_counts(F))
                    bad = [k for k in want if not np_bits(got[k], want[k])]
                    require(sorted(got) == sorted(want) and not bad,
                            "phase 44: %s, %s turn: not the bits of the "
                            "no-mesh run in %s" % (name, turn, bad))
                launches, plain = counts[0]
                require(all(c == counts[0] for c in counts) and launches
                        and not plain and ("TK1L2" not in name or launches
                                           == {"tik_persistent": 1}),
                        "phase 44: %s launches a turn (none, batch, batch, "
                        "none) %s" % (name, counts))
                rows[name] = {"launches": launches, "ms": ms}
        print("phase 44 batch mesh at NCCL world 1 (make_mesh((1,), "
              "('batch',))) vs no mesh: x and records bit for bit, launch "
              "counts equal, plain calls 0: %s; wall ms by CUDA events, turns "
              "none, batch, batch, none: %s [%s]"
              % ({k: v["launches"] for k, v in rows.items()},
                 {k: "none %s, batch %s" % (
                     "/".join("%.1f" % t for t in v["ms"]["none"]),
                     "/".join("%.1f" % t for t in v["ms"]["batch"]))
                  for k, v in rows.items()}, card))
    finally:
        torch.distributed.destroy_process_group()
    return rows


#: phase 44's traced run of a CLI, in a process of its own (``python3 -c``
#: from the repository's root, the CLI's module and its argv as arguments):
#: the exit code, the launch counts and plain calls, and the wall ms of
#: ``main``, as JSON on the last line
TRACED_CLI = """
import json, sys, time
from importlib import import_module
from nsol_tpu_torch.ops.cuda import fused as F
cli = import_module("nsol_tpu_torch.cli." + sys.argv[1])
F.reset_counts()
t0 = time.perf_counter()
rc = cli.main(json.loads(sys.argv[2]))
ms = 1e3 * (time.perf_counter() - t0)
print(json.dumps([rc, {k: v for k, v in F.launch_counts().items() if v},
                  {k: v for k, v in F.plain_counts().items() if v}, ms]))
"""


def trace_cli_runs(device, card):
    """Phase 44, ``--trace``: ``nsol_torch_run_denoising`` (Lena, PD TVL2)
    and ``nsol_torch_run_deconvolution`` (the 64³ phantom, ADMM TVL2) on
    the card, in this process after a warm-up without ``--trace``, then
    twice with it, each traced run a process of its own as a user runs a
    CLI (:data:`TRACED_CLI`): the same result bits and launch counts, a
    trace that parses and names the kernel of every unit of
    :data:`TRACE_KERNELS` the run launched, in each traced run (no count
    is required), its size, and the wall ms of each run's ``main``.

    Each traced run is its process's first trace: torch.profiler, with
    CUPTI kept alive between the traces of one process, keeps fewer kernel
    records the longer ago that process's first trace was (F7 in
    ROADMAP.md, ``tests/torch_profiler_probe.py``)."""
    import scipy.io
    import scipy.ndimage as ndi

    from nsol_tpu_torch import data
    from nsol_tpu_torch.cli import run_deconvolution, run_denoising
    from nsol_tpu_torch.io import read_nifti, write_nifti
    from nsol_tpu_torch.ops import kernels as K
    from nsol_tpu_torch.ops.cuda import fused as F

    root = os.path.dirname(os.path.abspath(__file__))
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        phantom = read_nifti(data.path("3D_SheppLoganPhantom_64.nii.gz"))
        kern = K.gaussian_kernel(np.diag([SIGMA ** 2] * 3), alpha_cut=3,
                                 spacing=np.ones(3))
        obs3 = os.path.join(tmp, "b.nii.gz")
        write_nifti(ndi.convolve(phantom.data.astype(np.float64), kern,
                                 mode="wrap").astype(np.float32), obs3,
                    spacing=np.ones(3))
        cases = {
            "run_denoising Lena PD TVL2": (
                run_denoising, ["--observation",
                                data.path("2D_Lena_256_noise.png")],
                "mat", ("pd_persistent",)),
            "run_deconvolution 64^3 ADMM TVL2": (
                run_deconvolution, ["--observation", obs3, "--solver", "ADMM",
                                    "--reconstruction-type", "TVL2",
                                    "--alpha", str(ALPHA), "--blur",
                                    str(SIGMA)],
                "nii.gz", ("admm_persistent",))}
        for name, (cli, argv, ext, units) in cases.items():
            def result(label):
                out = os.path.join(tmp, "%s.%s" % (label, ext))
                return out, lambda: (scipy.io.loadmat(out)["nda"]
                                     if ext == "mat" else read_nifti(out).data)

            def run(label):
                out, read = result(label)
                F.reset_counts()
                t0 = time.perf_counter()
                rc = cli.main(argv + ["--result", out])
                ms = 1e3 * (time.perf_counter() - t0)
                require(rc == 0, "phase 44: %s %s rc %r" % (name, label, rc))
                return read(), used_counts(F), ms

            def traced(turn):
                trace_dir = os.path.join(tmp, "trace_%s_%d" % (ext, len(ms1)))
                out, read = result(turn.replace(" ", "_"))
                proc = subprocess.run(
                    [sys.executable, "-c", TRACED_CLI,
                     cli.__name__.rsplit(".", 1)[1], json.dumps(
                         argv + ["--result", out, "--trace", trace_dir])],
                    cwd=root, capture_output=True, text=True, timeout=300)
                require(proc.returncode == 0, "phase 44: %s %s: the process "
                        "exited %d: %s" % (name, turn, proc.returncode,
                                           proc.stderr[-2000:]))
                rc, launches, plain, ms = json.loads(
                    proc.stdout.strip().splitlines()[-1])
                require(rc == 0, "phase 44: %s %s rc %r" % (name, turn, rc))
                ms1.append(ms)
                x1, c1 = read(), (launches, plain)
                require(np_bits(x0, x1) and c0 == c1 and not c0[1],
                        "phase 44: %s %s vs untraced: bits %s, launches %s"
                        % (name, turn, np_bits(x0, x1), (c0, c1)))
                files = os.listdir(trace_dir)
                require(len(files) == 1, "phase 44: %s trace files %s"
                        % (name, files))
                path = os.path.join(trace_dir, files[0])
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
                kernels = {}
                for e in events:
                    if e.get("cat") == "kernel":
                        kernels[e["name"]] = kernels.get(e["name"], 0) + 1
                named = {u: sum(n for k, n in kernels.items()
                                if TRACE_KERNELS[u] in k) for u in units}
                return path, kernels, named

            run("warm")
            x0, c0, ms0 = run("plain")
            ms1 = []
            for turn in ("traced", "traced again"):
                path, kernels, named = traced(turn)
                require(all(c0[0].get(u, 0) > 0 for u in units)
                        and all(named.values()), "phase 44: %s %s: launches "
                        "%s, kernel records in the trace %s, of its kernels "
                        "%s" % (name, turn, c0[0], named, kernels))
            rows[name] = {"launches": c0[0], "trace_records": named,
                          "trace_kernel_records": sum(kernels.values()),
                          "trace_bytes": os.path.getsize(path),
                          "ms": [ms0] + ms1}
    print("phase 44 --trace on the card: results and launch counts bit for "
          "bit equal to the untraced runs; %s [%s]"
          % ("; ".join("%s: launches %s, trace names %s (%d kernel "
                       "records), %d bytes, wall ms of main untraced (warm) "
                       "%.1f, traced (a fresh process: the card's context "
                       "and CUPTI start inside) %.1f, %.1f" % (
                           k, v["launches"], v["trace_records"],
                           v["trace_kernel_records"], v["trace_bytes"],
                           *v["ms"]) for k, v in rows.items()), card))
    return rows


def run_batch_phase(device, card):
    """Phase 44: the batch mesh at NCCL world 1 and ``--trace`` on the
    card."""
    rows = batch_mesh_runs(device, card)
    lap("phase 44 batch mesh")
    rows.update(trace_cli_runs(device, card))
    lap("phase 44 trace")
    return rows


# -------------------------------------------------------------- phase 45 --

#: phase 45's bit cases: label → (problem, storage, records, outer × CG):
#: the 64³ stand-in and Lena (the main paths, 50 × 10), then shapes the
#: rule takes at its edges (80³: threads with two voxels of a pass; a
#: ragged volume; a 2-plane stack)
PERSISTENT_BIT_CASES = {
    "64^3 exact": ("phantom", "exact", False, (ITERATIONS, ITER_MAX)),
    "64^3 qf32": ("phantom", "qf32", False, (ITERATIONS, ITER_MAX)),
    "64^3 exact records": ("phantom", "exact", True, (ITERATIONS, ITER_MAX)),
    "Lena exact": ("lena", "exact", False, (ITERATIONS, ITER_MAX)),
    "Lena qf32": ("lena", "qf32", False, (ITERATIONS, ITER_MAX)),
    "Lena exact records": ("lena", "exact", True, (ITERATIONS, ITER_MAX)),
    "Lena qf32 records": ("lena", "qf32", True, (ITERATIONS, ITER_MAX)),
    "80^3 exact records": ((80, 80, 80), "exact", True, (10, 10)),
    "37x45x53 qf32": ((37, 45, 53), "qf32", False, (10, 10)),
    "2x256x512 exact records": ((2, 256, 512), "exact", True, (10, 10))}
#: the solves repeated bit for bit on the persistent route
PERSISTENT_REPEATS = 3
#: the route's boundary, timed in turns at 10 × 10 (the persistent solve
#: forced where the rule refuses it): cubes, images, stacks of 2-32 planes
PERSISTENT_ROUTE_SHAPES = ((64, 64, 64), (80, 80, 80), (96, 96, 96),
                           (100, 100, 100), (256, 256), (512, 512),
                           (1024, 1024), (2048, 2048), (2, 512, 1025),
                           (4, 256, 256), (8, 256, 256), (16, 256, 256),
                           (32, 128, 128))
PERSISTENT_KERNEL = "admm_persistent_kernel"


def persistent_ptxas(kernel=PERSISTENT_KERNEL, mark="StoreT"):
    """ptxas's registers and spills of each instance of the persistent
    kernel ``kernel``, named from its template argument ``mark`` on (from
    this run's build; "cached" where the library was not built)."""
    from nsol_tpu_torch.ops.cuda import build

    lines = build.build_info.get("ptxas", "").splitlines()
    out = []
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and kernel in ln:
            info = [l.split(":", 1)[-1].strip() for l in lines[i + 1:i + 4]
                    if "spill" in l or "Used" in l]
            name = ln.split("'")[1]
            out.append("%s: %s" % (name[name.index(mark):][:60],
                                   "; ".join(info)))
    return out or ["cached"]


def persistent_sass(kernel=PERSISTENT_KERNEL, mark="StoreT"):
    """``{instance: (global loads, constant-cache global loads)}`` of each
    instance of the persistent kernel ``kernel`` (named from its template
    argument ``mark`` on) in the built library's SASS (``cuobjdump
    -sass``): every load of a volume the kernel writes must take the
    coherent path, so none may be an ``LDG...CONSTANT`` (or ``.NC``)."""
    import re

    from nsol_tpu_torch.ops.cuda import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    # the kernels by name where this run built the library (seconds, not
    # the whole library's half a minute)
    names = [ln.split("'")[1] for ln in build.build_info.get(
        "ptxas", "").splitlines() if "Compiling entry function" in ln
        and kernel in ln]
    sass = subprocess.run(
        [tool, "-sass"] + (["-fun", ",".join(names)] if names else [])
        + [build.build_info["path"]], capture_output=True, text=True,
        check=True).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass):
        name = fn.split("\n", 1)[0]
        if kernel not in name:
            continue
        loads = [l for l in fn.splitlines() if "LDG" in l]
        const = [l for l in loads if "CONSTANT" in l or ".NC" in l]
        out[name[name.index(mark):][:60]] = (len(loads), len(const))
    return out


@contextlib.contextmanager
def sequence_route(module, rule="persistent_route"):
    """Inside the block the solves whose route ``module.<rule>`` decides
    take their launch sequence (the persistent rule answers no), as before
    the persistent solves: ``F`` the fused ADMM solve's
    (``nsol_admm_solve``), ``T, TIK_RULE`` the Tikhonov batch's
    (``nsol_tikhonov_solve``). The phases that hold a sequence's
    units to their plain versions, or count their launches, run in it;
    phases 45-46 hold the persistent solves to it bit for bit."""
    saved = getattr(module, rule)
    setattr(module, rule, lambda *args, **kwargs: False)
    try:
        yield
    finally:
        setattr(module, rule, saved)


def persistent_bound(counts, n, normal, blur, outputs=1):
    """A one-launch solve's bound: the bytes it must move (b and x0 read,
    ``outputs`` volumes x written) and its float32 operations, those of the
    launch sequence's units at the counts that sequence makes
    (:func:`unit_bound`'s operations a voxel; ``Aᵀb``'s ``normal_apply``,
    ``admm_record`` and the robust units at the blur taps), over the card's
    peak rates; and the sum of the units' own bounds at those counts (each
    unit's volumes through HBM: no floor where the state sits in the 50 MB
    L2)."""
    chain_n, chain_b = 2 * sum(normal), 2 * sum(blur)
    ops = {"normal_apply": chain_n + 15, "cg_step": chain_n + 17,
           "cg_update": 8, "admm_tail": 40, "admm_record": chain_b + 20,
           "tik_clip": 1, "irls_head": chain_b + 10,
           "blur_apply": chain_b + 20, "weighted_apply": 2 * chain_b + 25,
           "irls_step": 2}
    # Aᵀb's normal_apply runs at the blur taps
    total = sum(ops[k] * c for k, c in counts.items() if c) \
        - (chain_n - chain_b if counts.get("normal_apply") else 0)
    on_blur = ("admm_record", "irls_head", "blur_apply", "weighted_apply")
    units = sum(unit_bound(k, n, blur if k in on_blur else normal)[0]
                * c for k, c in counts.items() if c)
    return bound(4.0 * n * (2 + outputs), float(n) * total), units


def turns_ms(seq, pers, reps):
    """Median ms of ``seq`` and ``pers`` by CUDA events, in turns
    (sequence, persistent, persistent, sequence)."""
    return [cuda_median_ms(f, reps) for f in (seq, pers, pers, seq)]


def turns_line(t):
    return "%.3f / %.3f / %.3f / %.3f" % tuple(t)


def persistent_problems(device):
    """The 64³ stand-in (b, and its objective on the host) and Lena 256²
    (b, and the float64 blur of its objective)."""
    import scipy.ndimage as ndi
    import torch

    from nsol_tpu_torch import data, interop
    from nsol_tpu_torch.io import read_nifti, read_png
    from nsol_tpu_torch.ops import conv as C
    from nsol_tpu_torch.ops import kernels as K

    iso = np.diag([SIGMA ** 2] * 3)
    img = read_nifti(data.path("3D_SheppLoganPhantom_64.nii.gz"))
    kern = K.gaussian_kernel(iso, alpha_cut=3, spacing=np.ones(3))
    b_np = ndi.convolve(img.data.astype(np.float64), kern, mode="wrap")
    b64 = interop.to_torch(b_np.astype(np.float32), device)
    lena = read_png(data.path("2D_Lena_256_blur_noise.png")).astype(
        np.float64)
    bl = torch.as_tensor((lena / lena.max()).astype(np.float32),
                         device=device)
    A2, _ = C.make_blur_operators(np.eye(2), alpha_cut=3, dtype=np.float64)
    return {"phantom": (b64, lambda x: objective_host(
                interop.to_numpy(x), b_np, kern, ALPHA)),
            "lena": (bl, lambda x: objective_device(x, bl, A2, ALPHA))}


def persistent_bits(F, device, problems):
    """Every case of :data:`PERSISTENT_BIT_CASES`: the library solve (the
    rule takes it) :data:`PERSISTENT_REPEATS` times, each x and record row
    ``torch.equal`` to the launch sequence's, one persistent launch a
    solve, nothing else launched and no plain call. Returns ``{case:
    (launches, max |x|)}`` and the 64³ objectives (sequence, persistent)."""
    import torch

    out, objectives = {}, {}
    for label, (src, storage, record, (its, cgs)) in \
            PERSISTENT_BIT_CASES.items():
        if isinstance(src, str):
            b = problems[src][0]
        else:
            b = torch.as_tensor(np.random.RandomState(45).rand(*src).astype(
                np.float32), device=device)
        kw = dict(precision="high3", compact_dirs=True) \
            if storage == "qf32" else {}
        solve = F.make_fused_admm_solver(
            tuple(b.shape), np.eye(b.dim()), iterations=its, iter_max=cgs,
            record=record, **kw)
        require(solve.route == "persistent", "phase 45: the rule refuses %s"
                % label)
        want = solve.sequence(b, b, ALPHA, RHO)
        torch.cuda.synchronize()
        F.reset_counts()
        got = [solve(b, b, ALPHA, RHO) for _ in range(PERSISTENT_REPEATS)]
        torch.cuda.synchronize()
        counts = used_counts(F)
        require(counts == ({"admm_persistent": PERSISTENT_REPEATS}, {}),
                "phase 45: %s launches %s" % (label, counts))
        for g in got:
            same = torch.equal(g[0], want[0]) and all(
                torch.equal(g[1][k], want[1][k]) for k in ("Reg", "Data")) \
                if record else torch.equal(g, want)
            require(same, "phase 45: %s: the persistent solve is not the "
                    "launch sequence's bits" % label)
        x = got[0][0] if record else got[0]
        require(bool(torch.isfinite(x).all()), "phase 45: %s not finite"
                % label)
        out[label] = float(x.abs().max())
        if label == "64^3 exact":
            objective = problems["phantom"][1]
            objectives = {"sequence": objective(want),
                          "persistent": objective(got[0])}
    return out, objectives


def persistent_refusals(F, device):
    """Shapes the rule leaves to the launch sequence make no persistent
    launch there; a forced persistent solve of a storage it does not run
    raises before it launches."""
    import torch

    out = {}
    for shape in ((100, 100, 100), (1024, 1024)):
        b = torch.as_tensor(np.random.RandomState(46).rand(*shape).astype(
            np.float32), device=device)
        solve = F.make_fused_admm_solver(shape, np.eye(len(shape)),
                                         iterations=2, iter_max=3)
        F.reset_counts()
        solve(b, b, ALPHA, RHO)
        torch.cuda.synchronize()
        counts = used_counts(F)[0]
        require(solve.route == "sequence" and "admm_persistent" not in counts
                and counts.get("cg_step", 0) + counts.get(
                    "cg_step_march", 0) == 6,
                "phase 45: %s took %s, launches %s" % (shape, solve.route,
                                                       counts))
        out["x".join(map(str, shape))] = counts
    st = F.B.Stencils.from_cov(np.eye(3), 3, None, device)
    b = torch.ones((8, 8, 8), device=device)
    for kw in (dict(storage="state"), dict(sweep=True)):
        try:
            F._solve_cuda(st, b, b, ALPHA, RHO, 2, 3, route="persistent",
                          **kw)
        except ValueError:
            continue
        raise PhaseFailure("phase 45: a persistent %s solve ran" % kw)
    return out


def persistent_study(device, F):
    """The Lena TV-L2 ADMM study of phase 18 (8 α × 2 ρ, 50 × 10, records)
    through ``ADMMLinearSolver.run_sweep``: a closure returning its x and
    records."""
    import torch

    from nsol_tpu_torch.ops import losses
    from nsol_tpu_torch.solvers.wrappers import ADMMLinearSolver

    img, xs, A, D, Dt = lena_problem()
    bt = torch.as_tensor(img, dtype=torch.float64, device=device)
    solver = ADMMLinearSolver(
        A, A, img, D, Dt, img, x_scale=xs, minimizer="auto",
        iterations=ITERATIONS, iter_max=ITER_MAX, blur_cov=np.eye(2),
        spacing=np.ones(2), device=device)
    measures = {
        "Reg": lambda x: torch.sum(torch.sqrt(torch.sum(D(x) ** 2, 0))),
        "Data": lambda x: losses.cost_from_residual(A(x) - bt.to(x.dtype))}
    grid = [(a, r) for a in TV_ALPHAS.astype(np.float64) for r in TV_RHOS]
    params = {"alpha": np.array([g[0] for g in grid]),
              "rho": np.array([g[1] for g in grid])}

    def run():
        with exact_storage():
            x, recs = solver.run_sweep(params, measures=measures)
        return dict(recs, x=x)
    return run


def persistent_cli(device, tmp):
    """``nsol_torch_run_deconvolution`` on the 64³ stand-in NIfTI (ADMM
    TVL2, its default compact storage): a closure returning the result."""
    import scipy.ndimage as ndi

    from nsol_tpu_torch import data
    from nsol_tpu_torch.cli import run_deconvolution
    from nsol_tpu_torch.io import read_nifti, write_nifti
    from nsol_tpu_torch.ops import kernels as K

    img = read_nifti(data.path("3D_SheppLoganPhantom_64.nii.gz"))
    kern = K.gaussian_kernel(np.diag([SIGMA ** 2] * 3), alpha_cut=3,
                             spacing=np.ones(3))
    obs = os.path.join(tmp, "b.nii.gz")
    write_nifti(ndi.convolve(img.data.astype(np.float64), kern,
                             mode="wrap").astype(np.float32), obs,
                spacing=np.ones(3))
    out = os.path.join(tmp, "x.nii.gz")

    def run():
        rc = run_deconvolution.main([
            "--observation", obs, "--result", out, "--solver", "ADMM",
            "--reconstruction-type", "TVL2", "--alpha", str(ALPHA), "--blur",
            str(SIGMA), "--device", "cuda"])
        require(rc == 0, "phase 45: the CLI exited %r" % rc)
        return read_nifti(out).data
    return run


def graph_of(fn):
    """A ``torch.cuda.CUDAGraph`` of ``fn()``'s launches (captured after a
    warm-up on a side stream) and the output its replays write."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def run_persistent_phase(device, card):
    """Phase 45: the fused ADMM solve as one persistent cooperative launch
    (``csrc/admm_persistent.cu``). Its build (ptxas registers and spills,
    no constant-cache load in its SASS), its launch shape and barriers;
    every case of :data:`PERSISTENT_BIT_CASES` bit for bit against
    ``nsol_admm_solve``'s launch sequence, repeated; the 64³ objective
    within 0.2 % of the anchor and equal in its printed digits to the
    sequence's; the Lena ADMM study's rows equal on both routes; the
    persistent solve against its plain version (phases 4-5's bands); the
    rule's refusals; times in turns (sequence, persistent, persistent,
    sequence) by CUDA events of the main paths, the study, the 64³ CLI and
    the route's boundary shapes, a CUDA graph replay of the launch sequence
    as a yardstick, the device busy share, the barriers alone and a
    traced solve's phases. Returns the ``kernels``
    record of ``admm_solve[persistent]``."""
    import torch

    from nsol_tpu_torch.ops.cuda import fused as F

    iso3 = F.B.Stencils.from_cov(np.eye(3), 3, None, "cpu")
    normal, blur = iso3.normal.lengths, iso3.blur.lengths
    regs = persistent_ptxas()
    # every instance at 64 registers (1024 threads an SM), as before its
    # machinery moved to csrc/persistent.cuh
    require(regs == ["cached"] or all("Used 64 registers" in r for r in regs),
            "phase 45: the persistent kernel's registers %s" % regs)
    sass = persistent_sass()
    require(sass and all(c == 0 for _, c in sass.values()),
            "phase 45: constant-cache loads in the persistent kernel %s"
            % sass)
    shapes = {k: F.persistent_shape(d, *F.taps_lengths([np.ones(7)] * nd))
              for k, d, nd in (("64^3", (64, 64, 64), 3),
                               ("Lena", (1, 256, 256), 2))}
    barriers = F.persistent_barriers(ITERATIONS, ITER_MAX)
    barrier_ms = {k: F.persistent_barrier_ms(barriers, v[1], v[3], device)
                  for k, v in shapes.items()}
    # one of the sequence's blocks a block, as many as 4 an SM hold
    barrier_ms["528 x 256"] = F.persistent_barrier_ms(barriers, 528, 256,
                                                      device)
    print("phase 45 build: ptxas %s; SASS (global loads, constant-cache "
          "loads) %s; launch shape (blocks an SM, grid, the sequence's "
          "blocks, threads a block) %s; %d grid barriers a 50 x 10 solve "
          "(%d with records), "
          "%d barriers alone at its grid %s ms [%s]"
          % (regs, sass, shapes, barriers,
             F.persistent_barriers(ITERATIONS, ITER_MAX, record=True),
             barriers, {k: "%.3f" % v for k, v in barrier_ms.items()}, card))

    problems = persistent_problems(device)
    maxes, objs = persistent_bits(F, device, problems)
    dev = abs(objs["persistent"] - OBJECTIVE_ANCHOR) / OBJECTIVE_ANCHOR
    require(dev <= ANCHOR_BAND and "%.6f" % objs["persistent"]
            == "%.6f" % objs["sequence"], "phase 45: 64^3 objective %.6f "
            "(sequence %.6f, anchor %.2f)" % (objs["persistent"],
                                              objs["sequence"],
                                              OBJECTIVE_ANCHOR))
    refused = persistent_refusals(F, device)
    # the rule in C (nsol_admm_persistent_route) against its Python mirror
    lib = F.build.load()
    rule_cases = 0
    for shape in PERSISTENT_ROUTE_SHAPES + ((64, 128, 128), (64, 128, 129)):
        dims = (1,) * (3 - len(shape)) + tuple(shape)
        for taps in (7, 61):
            lens = F.taps_lengths([np.ones(taps)] * len(shape))
            for storage in ("exact", "qf32", "dirs", "state"):
                for sweep in (False, True):
                    c = lib.nsol_admm_persistent_route(
                        F.B.storage_ids(storage)[1], int(sweep), *lens[0],
                        *lens[1], *dims)
                    py = F.persistent_route(dims, *lens, storage, sweep)
                    require(bool(c) == py, "phase 45: the rule of %s taps "
                            "%d %s sweep %s: C %d, Python %s"
                            % (shape, taps, storage, sweep, c, py))
                    rule_cases += 1
    print("phase 45 bits: %d cases x %d solves torch.equal to the launch "
          "sequence (x and records), one launch a solve, no plain call: %s; "
          "64^3 objective %.6f (sequence %.6f; anchor %.2f, dev %.4f%%); "
          "the rule's refusals (launches) %s, a forced persistent 'state' "
          "or sweep solve raises; the rule in C equal to its Python mirror "
          "in %d cases [%s]"
          % (len(maxes), PERSISTENT_REPEATS, sorted(maxes),
             objs["persistent"], objs["sequence"], OBJECTIVE_ANCHOR,
             100 * dev, refused, rule_cases, card))
    lap("phase 45 bits")

    # against the plain version, at phases 4-5's bands
    plain_gap = {}
    for key in ("Lena exact", "Lena qf32"):
        b, objective = problems["lena"]
        kw = dict(precision="high3", compact_dirs=True) \
            if key.endswith("qf32") else {}
        solve = F.make_fused_admm_solver(tuple(b.shape), np.eye(2),
                                         iterations=ITERATIONS,
                                         iter_max=ITER_MAX, **kw)
        xk, xp = solve(b, b, ALPHA, RHO), solve.plain(b, b, ALPHA, RHO)
        ok, op = objective(xk), objective(xp)
        plain_gap[key] = (abs(ok - op) / abs(op),
                          float((xk - xp).abs().max() / xk.abs().max()))
        require(plain_gap[key][0] <= SOLVE_OBJ_TOL
                and plain_gap[key][1] <= SOLVE_VOX_TOL,
                "phase 45: %s vs plain objective rel %.3g voxel %.3g"
                % (key, *plain_gap[key]))

    # the Lena ADMM study on both routes: the same rows
    study = persistent_study(device, F)
    with sequence_route(F):
        F.reset_counts()
        want = study()
        seq_counts = used_counts(F)[0]
    F.reset_counts()
    got = study()
    pers_counts = used_counts(F)[0]
    bad = [k for k in want if not np_bits(got[k], want[k])]
    require(not bad and pers_counts == {"admm_persistent": 16}
            and "admm_persistent" not in seq_counts,
            "phase 45: the Lena ADMM study differs in %s; launches %s / %s"
            % (bad, seq_counts, pers_counts))
    print("phase 45 the Lena ADMM study (16 configurations, records) on "
          "both routes: x and rows bit for bit; launches sequence %s, "
          "persistent %s; persistent vs plain (objective rel, voxel) %s"
          % (seq_counts, pers_counts,
             {k: "%.2e/%.2e" % v for k, v in plain_gap.items()}))

    # times in turns, by CUDA events
    rows = {}
    for key in ("64^3 exact", "64^3 qf32", "Lena exact", "Lena qf32",
                "Lena exact records"):
        src, storage, record, _ = PERSISTENT_BIT_CASES[key]
        b = problems[src][0]
        kw = dict(precision="high3", compact_dirs=True) \
            if storage == "qf32" else {}
        solve = F.make_fused_admm_solver(tuple(b.shape), np.eye(b.dim()),
                                         iterations=ITERATIONS,
                                         iter_max=ITER_MAX, record=record,
                                         **kw)
        rows[key] = turns_ms(partial(solve.sequence, b, b, ALPHA, RHO),
                             partial(solve, b, b, ALPHA, RHO), 5)
    study_ms = []
    with tempfile.TemporaryDirectory() as tmp:
        cli = persistent_cli(device, tmp)
        cli_ms, x_cli = [], {}
        for turn in ("sequence", "persistent", "persistent", "sequence"):
            route = sequence_route(F) if turn == "sequence" \
                else contextlib.nullcontext()
            with route:
                study_ms.append(timed_once(study)[1])
                x_cli[turn], ms = timed_once(cli)
                cli_ms.append(ms)
        require(np_bits(x_cli["sequence"], x_cli["persistent"]),
                "phase 45: the 64^3 CLI's result differs on the two routes")
    for key, t in (("Lena ADMM study", study_ms), ("64^3 CLI", cli_ms)):
        rows[key] = t
    print("phase 45 ms by CUDA events, turns sequence / persistent / "
          "persistent / sequence (a solve: median of 5; the study and the "
          "CLI: one run each): %s [%s]" % ("; ".join(
              "%s %s" % (k, turns_line(v)) for k, v in rows.items()), card))

    # the boundary of the rule, 10 × 10, the persistent solve forced
    bounds = {}
    for shape in PERSISTENT_ROUTE_SHAPES:
        b = torch.as_tensor(np.random.RandomState(47).rand(*shape).astype(
            np.float32), device=device)
        solve = F.make_fused_admm_solver(shape, np.eye(len(shape)),
                                         iterations=10, iter_max=10)
        t = turns_ms(partial(solve.sequence, b, b, ALPHA, RHO),
                     partial(solve.persistent, b, b, ALPHA, RHO), 3)
        bounds["x".join(map(str, shape))] = (solve.route, t)
        del b, solve
        torch.cuda.empty_cache()
    print("phase 45 the route's boundary, 10 x 10, ms by CUDA events (turns "
          "sequence / persistent / persistent / sequence; the persistent "
          "solve forced where the rule refuses it): %s [%s]" % ("; ".join(
              "%s (%s) %s" % (k, r, turns_line(t))
              for k, (r, t) in bounds.items()), card))
    lap("phase 45 times")

    # yardsticks: a CUDA graph replay of the launch sequence; the device
    # busy share; a traced solve's phases
    yard = {}
    for key in ("64^3 exact", "Lena exact"):
        src = PERSISTENT_BIT_CASES[key][0]
        b = problems[src][0]
        solve = F.make_fused_admm_solver(tuple(b.shape), np.eye(b.dim()),
                                         iterations=ITERATIONS,
                                         iter_max=ITER_MAX)
        graph, x_graph = graph_of(partial(solve.sequence, b, b, ALPHA, RHO))
        graph.replay()
        torch.cuda.synchronize()
        require(torch.equal(x_graph, solve(b, b, ALPHA, RHO)),
                "phase 45: %s graph replay differs from the persistent "
                "solve" % key)
        pers = partial(solve, b, b, ALPHA, RHO)
        graph_t = [cuda_median_ms(f, 5) for f in (graph.replay, pers, pers,
                                                  graph.replay)]
        busy = {}
        for route, fn in (("sequence", partial(solve.sequence, b, b, ALPHA,
                                               RHO)), ("persistent", pers)):
            wall = cuda_median_ms(fn, 3)
            busy[route] = (device_busy_ms(fn)[0], wall)
        phases = F.persistent_phases(pers, device)
        del graph
        yard[key] = (graph_t, busy, phases)
        print("phase 45 %s: CUDA graph replay of the launch sequence vs the "
              "persistent solve, ms (turns graph / persistent / persistent / "
              "graph) %s; device busy (torch.profiler device ms / wall ms) "
              "%s; the sequence's blocks a block (teams) %d; a traced "
              "solve's phases (count x mean us): %s [%s]"
              % (key, turns_line(graph_t), {
                  k: "%s/%.3f" % (ms_text(d), w) for k, (d, w)
                  in busy.items()},
                 shapes["64^3" if key.startswith("64") else "Lena"][3]
                 // 256, "; ".join(
                     "%s %d x %.2f" % (k, n, us / n)
                     for k, (n, us) in phases.items()), card))

    # the kernels line: the 64³ main path's launch, its device time
    b, objective = problems["phantom"]
    solve = F.make_fused_admm_solver((64,) * 3, np.eye(3),
                                     iterations=ITERATIONS, iter_max=ITER_MAX)
    solve(b, b, ALPHA, RHO)
    torch.cuda.synchronize()
    F.reset_counts()
    x = solve(b, b, ALPHA, RHO)
    torch.cuda.synchronize()
    launches = F.launch_counts(F.PERSISTENT_UNITS)["admm_persistent"]
    F.reset_counts()
    solve.sequence(b, b, ALPHA, RHO)
    torch.cuda.synchronize()
    counts = F.launch_counts(F.ADMM_UNITS + F.RECORD_UNITS)
    (b_ms, b_by), units_ms = persistent_bound(counts, 64 ** 3, normal, blur)
    x_p, plain_ms = timed_once(partial(solve.plain, b, b, ALPHA, RHO))
    err = float((x - x_p).abs().max())
    dev_ms = device_ms_of(partial(solve, b, b, ALPHA, RHO), 3,
                          keys=(PERSISTENT_KERNEL,))
    # the device time by the card's global timer, block 0's first stamp to
    # its last (a traced solve's phases): it needs no profiler record
    stamps_ms = sum(us for _, us in yard["64^3 exact"][2].values()) / 1e3
    entry = {"name": "admm_solve[persistent]", "route": "cuda",
             "source": "nsol_tpu_torch/csrc/admm_persistent.cu",
             "replaces": "nsol_tpu/ops/pallas/fused.py:382",
             "launches": int(launches), "max_abs_err": err,
             "ms": float(np.median(rows["64^3 exact"][1:3])),
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": None, "device_ms": stamps_ms,
             "profiler_device_ms": dev_ms,
             "sequence_ms": float(np.median(rows["64^3 exact"][::3])),
             "graph_replay_ms": float(np.median(
                 yard["64^3 exact"][0][::3]))}
    require(launches == 1, "phase 45: the 64^3 main path made %d persistent "
            "launches" % launches)
    print("phase 45 admm_solve[persistent] 64^3: launches %d, max|d| vs "
          "plain %.3e, device ms by torch.profiler %s, by the global "
          "timer's stamps %.4f, "
          "bound %.4f ms (%s: b, x0 in and x out, and the sequence's %s "
          "operations), its units' bounds summed %.4f ms (through HBM; the "
          "state sits in L2) [%s]"
          % (launches, err, ms_text(dev_ms), stamps_ms, b_ms, b_by, counts,
             units_ms, card))
    lap("phase 45")
    return [entry]


# -------------------------------------------------------------- phase 46 --

#: phase 46's bit cases: label → (problem, regulariser, storage,
#: configurations): the Lena sweeps (phase 17's 64 α, CG 10) and the 64³
#: TK1L2 × 8 (the main paths), then shapes the rule takes at its edges
#: (80³: threads with two voxels of a pass; a ragged volume; a 2-plane
#: stack), a batch of 1, and one longer than the configurations a launch
#: runs side by side (turns of them)
TIK_BIT_CASES = {
    "Lena TK1 exact x 64": ("lena", "TK1", "exact", 64),
    "Lena TK1 qf32 x 64": ("lena", "TK1", "qf32", 64),
    "Lena TK0 exact x 64": ("lena", "TK0", "exact", 64),
    "Lena TK0 qf32 x 64": ("lena", "TK0", "qf32", 64),
    "64^3 TK1 exact x 8": ("phantom", "TK1", "exact", 8),
    "80^3 TK1 exact x 3": ((80, 80, 80), "TK1", "exact", 3),
    "37x45x53 TK0 qf32 x 5": ((37, 45, 53), "TK0", "qf32", 5),
    "2x256x512 TK1 exact x 4": ((2, 256, 512), "TK1", "exact", 4),
    "Lena TK1 qf32 x 1": ("lena", "TK1", "qf32", 1),
    "Lena TK0 exact x 130": ("lena", "TK0", "exact", 130)}
TIK_KERNEL = "tikhonov_persistent_kernel"
#: launch shapes phase 46 reads: (label, dims, configurations, storage) and
#: the configurations side by side the C rule (``batch_width``) gives: as
#: many as 32 MiB hold (Lena exact 1.75 MiB a configuration: 18, then turns
#: of equal size), at least 1, at most one a block (of 128-132 here)
TIK_WIDTHS = ((("Lena x 64", (1, 256, 256), 64, "exact"), 16),
              (("Lena x 64 qf32", (1, 256, 256), 64, "qf32"), 16),
              (("Lena x 1", (1, 256, 256), 1, "exact"), 1),
              (("Lena x 130", (1, 256, 256), 130, "exact"), 17),
              (("64^3 x 8", (64, 64, 64), 8, "exact"), 4))
#: the Tikhonov batch's route rule, which :func:`sequence_route` forces off
TIK_RULE = "tikhonov_persistent_route"
#: the robust solves' route rule (the IRLS sweep's, in ``tiled``), which
#: :func:`robust_sequence` forces off for the ADMM solve and the Tikhonov
#: batch alike
ROBUST_RULE = "irls_persistent_fits"


def robust_sequence():
    """:func:`sequence_route` of :data:`ROBUST_RULE`: inside the block the
    robust losses of the fused ADMM solve and of the Tikhonov batch take
    their launch sequence (``nsol_robust_admm_solve``,
    ``nsol_tikhonov_solve``)."""
    from nsol_tpu_torch.ops.cuda import tiled

    return sequence_route(tiled, ROBUST_RULE)


def tik_grid(n):
    """``n`` α (phase 17's 64 where ``n`` is 64) and ``n`` data-loss scales
    C, both varying across the batch (C is no term of the linear loss)."""
    alphas = TK_ALPHAS if n == len(TK_ALPHAS) else np.linspace(
        0.005, 0.5, n, dtype=np.float32)
    return ([float(a) for a in alphas],
            [float(c) for c in np.linspace(0.3, 2.0, n)])


def tik_solver(T, b, reg="TK1", storage="exact", **kw):
    """The fused Tikhonov batch of ``b``'s shape (σ = 1, CG 10)."""
    opt = dict(precision="high3", compact_dirs=True) \
        if storage == "qf32" else {}
    return T.make_fused_tikhonov_solver(tuple(b.shape), np.eye(b.dim()),
                                        reg=reg, iter_max=kw.pop(
                                            "iter_max", TK_ITER_MAX),
                                        **opt, **kw)


def tik_bits(T, F, device, problems):
    """Every case of :data:`TIK_BIT_CASES`: the library batch (the rule
    takes it) :data:`PERSISTENT_REPEATS` times, each x ``torch.equal`` to
    the launch sequence's, one ``tik_persistent`` launch a batch, nothing
    else launched and no plain call. Returns ``{case: max |x|}`` and the
    Lena exact 64-α batches by regulariser."""
    import torch

    out, lena = {}, {}
    for label, (src, reg, storage, nconf) in TIK_BIT_CASES.items():
        if isinstance(src, str):
            b = problems[src][0]
        else:
            b = torch.as_tensor(np.random.RandomState(46).rand(*src).astype(
                np.float32), device=device)
        solve = tik_solver(T, b, reg, storage)
        require(solve.route == "persistent", "phase 46: the rule refuses %s"
                % label)
        alphas, scales = tik_grid(nconf)
        want = solve.sequence(b, b, alphas, scales)
        torch.cuda.synchronize()
        F.reset_counts()
        got = [solve(b, b, alphas, scales) for _ in range(PERSISTENT_REPEATS)]
        torch.cuda.synchronize()
        counts = used_counts(F)
        require(counts == ({"tik_persistent": PERSISTENT_REPEATS}, {}),
                "phase 46: %s launches %s" % (label, counts))
        for g in got:
            require(torch.equal(g, want), "phase 46: %s: the persistent "
                    "batch is not the launch sequence's bits (max |d| %.3g)"
                    % (label, float((g - want).abs().max())))
        require(got[0].shape == (nconf,) + tuple(b.shape)
                and bool(torch.isfinite(got[0]).all()),
                "phase 46: %s not finite or misshapen" % label)
        out[label] = float(got[0].abs().max())
        if src == "lena" and storage == "exact" and nconf == 64:
            lena[reg] = got[0]
    return out, lena


def tik_anchor_devs(lena, b):
    """The Lena exact sweeps' objectives against phase 17's float64
    anchors, at its band: ``{(reg, α index): relative deviation}``."""
    _, _, A, D, _ = lena_problem()
    devs = {}
    for (reg, loss, i), anchor in TK_ANCHORS.items():
        if loss != "linear":
            continue
        obj = tk_objective(lena[reg][i], b, A, D if reg == "TK1"
                           else (lambda x: x), float(TK_ALPHAS[i]), loss)
        devs[(reg, i)] = abs(obj - anchor) / anchor
        require(devs[(reg, i)] <= STUDY_ANCHOR_BAND, "phase 46: %s alpha[%d] "
                "objective %.9f deviates %.3g from %.9f"
                % (reg, i, obj, devs[(reg, i)], anchor))
    return devs


def tik_refusals(T, F, device, problems):
    """256³ × 8 α runs on the launch sequence: no persistent launch, and
    ``tik_clip`` once a configuration on entry and again on exit; the
    robust loss (Lena TK1 huber × 8) takes no ``tik_persistent`` launch but
    ``csrc/irls_persistent.cu``'s one (phase 47). Returns their
    launches."""
    import torch

    out = {}
    b = problems["lena"][0]
    huber = tik_solver(T, b, iter_max=HUBER_SWEEPS, data_loss="huber",
                       irls_cg_iters=HUBER_CG)
    big = torch.as_tensor(np.random.RandomState(46).rand(
        *SCALE_SHAPE).astype(np.float32), device=device)
    for label, solve, x, want in (
            ("Lena huber x 8", huber, b, {"irls_persistent": 1}),
            ("256^3 x 8", tik_solver(T, big), big, {"tik_clip": 16})):
        alphas, scales = tik_grid(8)
        F.reset_counts()
        solve(x, x, alphas, scales)
        torch.cuda.synchronize()
        counts = used_counts(F)[0]
        require(solve.route == ("persistent" if "irls_persistent" in want
                                else "sequence")
                and "tik_persistent" not in counts
                and all(counts.get(k) == n for k, n in want.items()),
                "phase 46: %s took %s, launches %s" % (label, solve.route,
                                                       counts))
        out[label] = counts
    del big
    torch.cuda.empty_cache()
    return out


def tik_study(device):
    """Phase 17's Lena TK1L2 × 64 α sweep with records through
    ``TikhonovLinearSolver.run_sweep`` (exact storage): a closure returning
    its x and records."""
    import torch

    from nsol_tpu_torch.ops import losses
    from nsol_tpu_torch.solvers.wrappers import TikhonovLinearSolver

    img, xs, A, D, Dt = lena_problem()
    bt = torch.as_tensor(img, dtype=torch.float64, device=device)
    solver = TikhonovLinearSolver(
        A, A, img, D, Dt, img, x_scale=xs, minimizer="auto",
        iter_max=TK_ITER_MAX, blur_cov=np.eye(2), spacing=np.ones(2),
        reg_kind="TK1", device=device)
    measures = {
        "Reg": lambda x: 0.5 * torch.sum(D(x) * D(x)),
        "Data": lambda x: losses.cost_from_residual(A(x) - bt.to(x.dtype))}
    params = {"alpha": TK_ALPHAS.astype(np.float64)}

    def run():
        with exact_storage():
            x, recs = solver.run_sweep(params, measures=measures)
        return dict(recs, x=x)
    return run


def tik_study_cli(tmp):
    """``nsol_torch_run_deconvolution_study`` on the 64³ NIfTI phantom
    (TK1L2, 8 α, CG 10; its default compact storage): a closure returning
    its reconstructions."""
    from nsol_tpu_torch import data
    from nsol_tpu_torch.cli import run_deconvolution_study as study_cli
    from nsol_tpu_torch.study import ReaderParameterStudy

    def run():
        out = tempfile.mkdtemp(dir=tmp)
        rc = study_cli.main([
            "--observation", data.path("3D_SheppLoganPhantom_64.nii.gz"),
            "--reconstruction-type", "TK1L2", "--alpha-range", "0.005",
            "0.05", "8", "--study-name", "phantom", "--dir-output", out,
            "--device", "cuda", "--iter-max", str(TK_ITER_MAX)])
        require(rc == 0, "phase 46: the study CLI exited %r" % rc)
        reader = ReaderParameterStudy(directory=out, name="phantom")
        reader.read_study()
        return dict(reader.get_reconstructions().items())
    return run


def run_tik_persistent_phase(device, card):
    """Phase 46: the fused Tikhonov batch as one persistent cooperative
    launch (``csrc/tikhonov_persistent.cu``). Its build (ptxas registers
    and spills, no constant-cache load in its SASS), its launch shape and
    barriers; every case of :data:`TIK_BIT_CASES` bit for bit against
    ``nsol_tikhonov_solve``'s launch sequence, repeated, one launch a
    batch; the Lena sweeps' objectives at phase 17's float64 anchors; the
    rule's refusals (256³; the robust loss takes phase 47's launch); times
    in turns (sequence, persistent, persistent, sequence) by CUDA events of
    the Lena TK1L2 and TK0L2 × 64 and 64³ TK1L2 × 8 batches,
    ``TikhonovLinearSolver.run_sweep`` on Lena and the 64³ study CLI; a
    CUDA graph replay of the launch sequence as a yardstick, the device
    busy share, and the device time by the kernel's global-timer stamps.
    Returns the ``kernels`` record of ``tik_solve[persistent]``."""
    import torch

    from nsol_tpu_torch.ops.cuda import fused as F
    from nsol_tpu_torch.ops.cuda import tikhonov as T

    regs = persistent_ptxas(TIK_KERNEL)
    sass = persistent_sass(TIK_KERNEL)
    require(sass and all(c == 0 for _, c in sass.values()),
            "phase 46: constant-cache loads in the persistent kernel %s"
            % sass)
    lens = {2: F.taps_lengths([np.ones(7)] * 2),
            3: F.taps_lengths([np.ones(7)] * 3)}
    shapes, barriers = {}, {}
    for (k, d, nconf, storage), width in TIK_WIDTHS:
        shapes[k] = T.persistent_shape(d, *lens[2 if d[0] == 1 else 3],
                                       nconf, storage)
        require(shapes[k][4] == width, "phase 46: %s runs %d side by side, "
                "not %d" % (k, shapes[k][4], width))
        barriers[k] = T.persistent_barriers(nconf, TK_ITER_MAX, shapes[k][4])
    print("phase 46 build: ptxas %s; SASS (global loads, constant-cache "
          "loads) %s; launch shape (blocks an SM, grid, the sequence's "
          "blocks a volume, threads a block, configurations side by side) "
          "%s, the widths %s as expected; grid barriers a CG-10 batch %s "
          "(serial: %d a configuration) [%s]"
          % (regs, sass, shapes, [w for _, w in TIK_WIDTHS], barriers,
             T.persistent_barriers(1, TK_ITER_MAX, 1) - 3, card))

    problems = persistent_problems(device)
    maxes, lena = tik_bits(T, F, device, problems)
    devs = tik_anchor_devs(lena, problems["lena"][0])
    refused = tik_refusals(T, F, device, problems)
    # the rule in C (nsol_tikhonov_persistent_route) against its mirror
    lib = F.build.load()
    rule_cases = 0
    for shape in PERSISTENT_ROUTE_SHAPES + ((256, 256, 256),):
        dims = (1,) * (3 - len(shape)) + tuple(shape)
        for taps in (7, 61):
            ln = F.taps_lengths([np.ones(taps)] * len(shape))
            for storage in ("exact", "qf32", "dirs", "state"):
                for loss in ("linear", "huber"):
                    c = lib.nsol_tikhonov_persistent_route(
                        T.Rec.LOSS_IDS.index(loss),
                        F.B.storage_ids(storage)[1], *ln[0], *ln[1], *dims)
                    py = T.tikhonov_persistent_route(dims, *ln, storage, loss)
                    require(bool(c) == py, "phase 46: the rule of %s taps "
                            "%d %s %s: C %d, Python %s"
                            % (shape, taps, storage, loss, c, py))
                    rule_cases += 1
    print("phase 46 bits: %d cases x %d batches torch.equal to the launch "
          "sequence, one launch a batch, no plain call: %s; the Lena sweeps' "
          "objectives vs the float64 anchors %s (band %g); the refusals "
          "(launches) %s; the rule in C equal to its Python mirror in %d cases [%s]"
          % (len(maxes), PERSISTENT_REPEATS, sorted(maxes),
             {"%s[%d]" % k: "%.2e" % v for k, v in devs.items()},
             STUDY_ANCHOR_BAND, refused, rule_cases, card))
    lap("phase 46 bits")

    # times in turns, by CUDA events
    rows = {}
    for key, (src, reg, storage, n) in (
            ("Lena TK1L2 x 64", ("lena", "TK1", "exact", 64)),
            ("Lena TK1L2 x 64 qf32", ("lena", "TK1", "qf32", 64)),
            ("Lena TK0L2 x 64", ("lena", "TK0", "exact", 64)),
            ("64^3 TK1L2 x 8", ("phantom", "TK1", "exact", 8))):
        b = problems[src][0]
        solve = tik_solver(T, b, reg, storage)
        alphas, _ = tik_grid(n)
        rows[key] = turns_ms(partial(solve.sequence, b, b, alphas),
                             partial(solve, b, b, alphas), 5)
    study = tik_study(device)
    study_ms, got = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        cli = tik_study_cli(tmp)
        cli_ms = []
        for turn in ("sequence", "persistent", "persistent", "sequence"):
            route = sequence_route(T, TIK_RULE) if turn == "sequence" \
                else contextlib.nullcontext()
            with route:
                F.reset_counts()
                got[turn], ms = timed_once(study)
                study_ms.append(ms)
                launched = used_counts(F)[0]
                require(("tik_persistent" in launched) == (
                    turn == "persistent"), "phase 46: the Lena run_sweep, %s "
                    "turn, launches %s" % (turn, launched))
                got[turn + " cli"], ms = timed_once(cli)
                cli_ms.append(ms)
    bad = [k for k in got["sequence"] if not np_bits(
        got["sequence"][k], got["persistent"][k])]
    bad += [k for k in got["sequence cli"] if not np_bits(
        got["sequence cli"][k], got["persistent cli"][k])]
    require(not bad, "phase 46: run_sweep and the study CLI differ on the "
            "two routes in %s" % bad)
    rows["Lena run_sweep"] = study_ms
    rows["64^3 study CLI"] = cli_ms
    print("phase 46 ms by CUDA events, turns sequence / persistent / "
          "persistent / sequence (a batch: median of 5; run_sweep and the "
          "CLI: one run each, their results equal on the two routes): %s "
          "[%s]" % ("; ".join("%s %s" % (k, turns_line(v))
                              for k, v in rows.items()), card))
    lap("phase 46 times")

    # the main path: Lena TK1L2 × 64; a CUDA graph replay of its launch
    # sequence; the device busy share; the device time by the stamps
    b = problems["lena"][0]
    solve = tik_solver(T, b)
    alphas, _ = tik_grid(64)
    pers = partial(solve, b, b, alphas)
    graph, x_graph = graph_of(partial(solve.sequence, b, b, alphas))
    graph.replay()
    torch.cuda.synchronize()
    require(torch.equal(x_graph, pers()), "phase 46: the graph replay differs "
            "from the persistent batch")
    graph_t = [cuda_median_ms(f, 5) for f in (graph.replay, pers, pers,
                                              graph.replay)]
    del graph
    busy = {}
    for route, fn in (("sequence", partial(solve.sequence, b, b, alphas)),
                      ("persistent", pers)):
        busy[route] = (device_busy_ms(fn)[0], cuda_median_ms(fn, 3))
    phases = F.persistent_phases(pers, device)
    stamps_ms = sum(us for _, us in phases.values()) / 1e3
    torch.cuda.synchronize()
    F.reset_counts()
    x = pers()
    torch.cuda.synchronize()
    launches = F.launch_counts(F.PERSISTENT_UNITS)["tik_persistent"]
    require(launches == 1, "phase 46: the Lena main path made %d persistent "
            "launches" % launches)
    F.reset_counts()
    solve.sequence(b, b, alphas)
    torch.cuda.synchronize()
    counts = F.launch_counts(("normal_apply", "cg_step", "cg_update",
                              "tik_clip"))
    n = 256 ** 2
    (b_ms, b_by), units_ms = persistent_bound(counts, n, lens[2][1],
                                              lens[2][0], outputs=64)
    x_p, plain_ms = timed_once(partial(solve.plain, b, b, alphas))
    err = float((x - x_p).abs().max())
    require(max_rel(x, x_p) <= SOLVE_VOX_TOL and bool(x.isfinite().all()),
            "phase 46: the persistent batch vs plain voxel rel %.3g"
            % max_rel(x, x_p))
    print("phase 46 tik_solve[persistent] Lena TK1L2 x 64: launches %d, "
          "max|d| vs plain %.3e (rel %.2e, limit %g); CUDA graph replay of the launch sequence vs "
          "the persistent batch, ms (turns graph / persistent / persistent / "
          "graph) %s; device busy (torch.profiler device ms / wall ms) %s; "
          "device ms by the global timer's stamps %.4f; a traced batch's "
          "phases (count x mean us): %s; bound %.4f ms (%s: b, x0 in and 64 "
          "x out, and the sequence's %s operations), its units' bounds "
          "summed %.4f ms [%s]"
          % (launches, err, max_rel(x, x_p), SOLVE_VOX_TOL,
             turns_line(graph_t), {
              k: "%s/%.3f" % (ms_text(d), w) for k, (d, w) in busy.items()},
             stamps_ms, "; ".join("%s %d x %.2f" % (k, c, us / c)
                                  for k, (c, us) in phases.items()),
             b_ms, b_by, counts, units_ms, card))
    lap("phase 46")
    return [{"name": "tik_solve[persistent]", "route": "cuda",
             "source": "nsol_tpu_torch/csrc/tikhonov_persistent.cu",
             "replaces": "nsol_tpu/ops/pallas/fused.py:716",
             "launches": int(launches), "max_abs_err": err,
             "ms": float(np.median(rows["Lena TK1L2 x 64"][1:3])),
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": None, "device_ms": stamps_ms,
             "sequence_ms": float(np.median(rows["Lena TK1L2 x 64"][::3])),
             "graph_replay_ms": float(np.median(graph_t[::3]))}]


# -------------------------------------------------------------- phase 47 --

#: phase 47's bit cases of the robust ADMM solve: label → (problem, loss,
#: storage, records, (outer, sweeps, CG)): Lena at phase 13's 10 × 3 × 6 in
#: the four losses, exact and dirs, with and without records (the main
#: path); the 64³ phantom; the rule's edge shapes (80³: threads with two
#: voxels of a pass; a ragged volume; a 2-plane stack)
IRLS_BIT_CASES = dict(
    [("Lena %s %s%s" % (loss, storage, " records" if record else ""),
      ("lena", loss, storage, record, ROBUST_ITERS["lena"]))
     for loss in ROBUST_LOSSES for storage in ("exact", "dirs")
     for record in (False, True)]
    + [("64^3 huber exact", ("phantom", "huber", "exact", False,
                             ROBUST_ITERS["lena"])),
       ("64^3 huber dirs records", ("phantom", "huber", "dirs", True,
                                    ROBUST_ITERS["lena"])),
       ("80^3 huber exact records", ((80, 80, 80), "huber", "exact", True,
                                     (3, 3, 6))),
       ("37x45x53 cauchy dirs", ((37, 45, 53), "cauchy", "dirs", False,
                                 (3, 3, 6))),
       ("2x256x512 huber exact records", ((2, 256, 512), "huber", "exact",
                                          True, (3, 3, 6)))])
#: phase 47's bit cases of the robust Tikhonov batch: label → (problem,
#: regulariser, storage, loss, configurations, C varying): phase 17's Lena
#: huber sweeps (every 8th α, 5 sweeps × 8 CG, C = 1) exact and compact,
#: then a batch mixing α and C, a batch of 1, one longer than the
#: configurations a launch runs side by side (turns), and 64³
IRLS_TIK_CASES = {
    "Lena TK1 huber exact x 8": ("lena", "TK1", "exact", "huber", 8, False),
    "Lena TK1 huber qf32 x 8": ("lena", "TK1", "qf32", "huber", 8, False),
    "Lena TK0 huber exact x 8": ("lena", "TK0", "exact", "huber", 8, False),
    "Lena TK0 huber qf32 x 8": ("lena", "TK0", "qf32", "huber", 8, False),
    "Lena TK1 cauchy exact x 20, C varying": ("lena", "TK1", "exact",
                                              "cauchy", 20, True),
    "Lena TK0 soft_l1 qf32 x 1": ("lena", "TK0", "qf32", "soft_l1", 1,
                                  True),
    "Lena TK1 arctan exact x 130": ("lena", "TK1", "exact", "arctan", 130,
                                    True),
    "64^3 TK1 huber exact x 8": ("phantom", "TK1", "exact", "huber", 8,
                                 False)}
#: the shapes inside the rule's cap besides Lena and 64³ that phase 47
#: times in turns (solves and x 8 batches): the rule's edges and the
#: route test's shapes it takes
IRLS_EDGE_SHAPES = (("80^3", (80, 80, 80)), ("512^2", (512, 512)),
                    ("2x256x512", (2, 256, 512)),
                    ("37x45x53", (37, 45, 53)),
                    ("32x128x128", (32, 128, 128)))
IRLS_KERNEL = "irls_persistent_kernel"
#: launch shapes phase 47 reads: (label, dims, configurations, storage,
#: regulariser) and the configurations side by side the C rule
#: (``batch_width`` over a slot's ten volumes) gives: as many as 32 MiB
#: hold (Lena exact 2.5 MiB a configuration: 12; dirs 2.25 MiB: 14; 64³
#: exact 10 MiB: 3), in turns of equal size; a solve is a batch of one
IRLS_WIDTHS = ((("Lena solve", (1, 256, 256), 1, "exact", "TK1"), 1),
               (("Lena x 8", (1, 256, 256), 8, "exact", "TK1"), 8),
               (("Lena x 8 dirs", (1, 256, 256), 8, "dirs", "TK0"), 8),
               (("Lena x 130", (1, 256, 256), 130, "exact", "TK1"), 12),
               (("Lena x 130 dirs", (1, 256, 256), 130, "dirs", "TK1"), 13),
               (("64^3 x 8", (64, 64, 64), 8, "exact", "TK1"), 3))
#: host-clock calls a persistent call's parts are taken over (their medians)
HOST_SPLIT_CALLS = 20


def irls_problem(src, problems, device, seed=47):
    """``b`` of a case: a named problem of :func:`persistent_problems` or
    a random volume of the shape ``src``."""
    import torch

    if isinstance(src, str):
        return problems[src][0]
    return torch.as_tensor(np.random.RandomState(seed).rand(*src).astype(
        np.float32), device=device)


def nan_bits_equal(a, b):
    """NaN at the same entries and the same bits everywhere else (signed
    zeros included): ``torch.equal``, NaN-equal, and stricter on zeros."""
    import torch

    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and bits_equal(
        a.masked_fill(nan, 0.0), b.masked_fill(nan, 0.0))


def irls_same(got, want, record):
    """:func:`nan_bits_equal` of x, and of the records."""
    if not record:
        return nan_bits_equal(got, want)
    return nan_bits_equal(got[0], want[0]) and all(
        nan_bits_equal(got[1][k], want[1][k]) for k in ("Reg", "Data"))


def irls_case(F, label, solve, args, kwargs=None, record=False):
    """``solve.sequence`` once and the library call (the default route)
    :data:`PERSISTENT_REPEATS` times: each output (with ``record`` x and
    the records) bit for bit the sequence's, NaN-equal, one
    ``irls_persistent`` launch a call, nothing else launched and no plain
    call. Returns the first output."""
    import torch

    kwargs = kwargs or {}
    want = solve.sequence(*args, **kwargs)
    torch.cuda.synchronize()
    F.reset_counts()
    got = [solve(*args, **kwargs) for _ in range(PERSISTENT_REPEATS)]
    torch.cuda.synchronize()
    counts = used_counts(F)
    require(solve.route == "persistent"
            and counts == ({"irls_persistent": PERSISTENT_REPEATS}, {}),
            "phase 47: %s takes %s, launches %s" % (label, solve.route,
                                                    counts))
    for g in got:
        require(irls_same(g, want, record), "phase 47: %s: the persistent "
                "launch is not the launch sequence's bits" % label)
    return got[0]


def irls_bits(F, T, device, problems):
    """Every case of :data:`IRLS_BIT_CASES` and :data:`IRLS_TIK_CASES`, and
    a NaN in b and in x0 of each kind of solve, through :func:`irls_case`.
    Returns ``{case: max |x|}`` (NaN cases: the NaN count) and the Lena
    huber exact solve."""
    import torch

    out, lena = {}, None
    for label, (src, loss, storage, record, (its, sweeps, cgi)) in \
            IRLS_BIT_CASES.items():
        b = irls_problem(src, problems, device)
        kw = FUSED_COMPACT if storage == "dirs" else {}
        solve = F.make_fused_admm_solver(
            tuple(b.shape), np.eye(b.dim()), iterations=its, iter_max=sweeps,
            data_loss=loss, irls_cg_iters=cgi, record=record, **kw)
        x = irls_case(F, label, solve, (b, b, ALPHA, RHO),
                      dict(data_loss_scale=0.7, record_dls=0.9) if record
                      else None, record)
        x = x[0] if record else x
        require(bool(torch.isfinite(x).all()), "phase 47: %s not finite"
                % label)
        out[label] = float(x.abs().max())
        if label == "Lena huber exact":
            lena = x
    for label, (src, reg, storage, loss, n, varying) in \
            IRLS_TIK_CASES.items():
        b = irls_problem(src, problems, device)
        solve = tik_solver(T, b, reg, storage, iter_max=HUBER_SWEEPS,
                           data_loss=loss, irls_cg_iters=HUBER_CG)
        alphas, scales = tik_grid(n)
        if not varying:
            alphas = [float(a) for a in TK_ALPHAS[::HUBER_STEP]]
            scales = [HUBER_SCALE] * n
        x = irls_case(F, label, solve, (b, b, alphas, scales))
        require(x.shape == (n,) + tuple(b.shape)
                and bool(torch.isfinite(x).all()),
                "phase 47: %s not finite or misshapen" % label)
        out[label] = float(x.abs().max())
    # a NaN in b and in x0: the NaNs where the sequence has them
    b = problems["lena"][0]
    nan_b, nan_x0 = b.clone(), b.clone()
    nan_b[100, 100] = float("nan")
    nan_x0[10, 20] = float("nan")
    admm = F.make_fused_admm_solver(tuple(b.shape), np.eye(2), iterations=2,
                                    iter_max=2, data_loss="huber",
                                    irls_cg_iters=3)
    tik = tik_solver(T, b, iter_max=2, data_loss="huber", irls_cg_iters=3)
    alphas, scales = tik_grid(4)
    for label, solve, args in (
            ("ADMM NaN in b", admm, (nan_b, nan_b, ALPHA, RHO)),
            ("ADMM NaN in x0", admm, (b, nan_x0, ALPHA, RHO)),
            ("TK1 x 4 NaN in b", tik, (nan_b, b, alphas, scales)),
            ("TK1 x 4 NaN in x0", tik, (b, nan_x0, alphas, scales))):
        x = irls_case(F, label, solve, args)
        out[label] = int(torch.isnan(x).sum())
        require(out[label] > 0, "phase 47: %s left no NaN" % label)
    return out, lena


def irls_refusals(F, R, T, device):
    """Shapes and storage the rule leaves to the launch sequence make no
    persistent launch there and their units' launches: 256³ and 100³
    (their units march), the blocked solve's ``"io"`` storage at 64³, a
    256³ robust Tikhonov batch. Returns their launches."""
    import torch

    out = {}
    iso = np.eye(3)
    for label, shape, make in (
            ("256^3", SCALE_SHAPE, partial(F.make_fused_admm_solver,
                                           SCALE_SHAPE, iso)),
            ("100^3", (100,) * 3, partial(F.make_fused_admm_solver,
                                          (100,) * 3, iso)),
            ("64^3 io", (64,) * 3, partial(R.blocked_robust_admm_solve,
                                           (64,) * 3, iso,
                                           compact_dirs=True))):
        its, sweeps, cgi = 1, 2, 3
        b = torch.as_tensor(np.random.RandomState(48).rand(*shape).astype(
            np.float32), device=device)
        solve = make(iterations=its, iter_max=sweeps, data_loss="huber",
                     irls_cg_iters=cgi)
        F.reset_counts()
        solve(b, b, ALPHA, RHO)
        torch.cuda.synchronize()
        counts = used_counts(F)[0]
        applies = counts.get("weighted_apply", 0) + counts.get(
            "weighted_apply_march", 0)
        require(getattr(solve, "route", "sequence") == "sequence"
                and "irls_persistent" not in counts
                and applies == its * sweeps * cgi
                and counts.get("irls_step") == its * sweeps,
                "phase 47: %s takes %s, launches %s"
                % (label, getattr(solve, "route", None), counts))
        out[label] = counts
        del b
    b = torch.as_tensor(np.random.RandomState(48).rand(
        *SCALE_SHAPE).astype(np.float32), device=device)
    solve = tik_solver(T, b, iter_max=1, data_loss="huber", irls_cg_iters=2)
    alphas, scales = tik_grid(2)
    F.reset_counts()
    solve(b, b, alphas, scales)
    torch.cuda.synchronize()
    counts = used_counts(F)[0]
    require(solve.route == "sequence" and "irls_persistent" not in counts
            and counts.get("tik_clip") == 2,
            "phase 47: the 256^3 huber batch takes %s, launches %s"
            % (solve.route, counts))
    out["256^3 TK1 huber x 2"] = counts
    del b
    torch.cuda.empty_cache()
    return out


def irls_study(device, loss_reg):
    """Phase 17's Lena TK1L2 huber sweep (``loss_reg`` ``"TK1"``; every
    8th α, 5 sweeps × 8 CG, C = 1, records) or its TK0L2 form through
    ``TikhonovLinearSolver.run_sweep`` (exact storage): a closure
    returning its x and records."""
    import torch

    from nsol_tpu_torch.ops import losses
    from nsol_tpu_torch.solvers.wrappers import TikhonovLinearSolver

    img, xs, A, D, Dt = lena_problem()
    B_, Bt = (D, Dt) if loss_reg == "TK1" else ((lambda x: x),) * 2
    bt = torch.as_tensor(img, dtype=torch.float64, device=device)
    solver = TikhonovLinearSolver(
        A, A, img, B_, Bt, img, x_scale=xs, data_loss="huber",
        data_loss_scale=HUBER_SCALE, minimizer="auto", iter_max=HUBER_SWEEPS,
        irls_cg_iters=HUBER_CG, blur_cov=np.eye(2), spacing=np.ones(2),
        reg_kind=loss_reg, device=device)
    measures = {
        "Reg": lambda x: 0.5 * torch.sum(B_(x) * B_(x)),
        "Data": lambda x: losses.cost_from_residual(
            A(x) - bt.to(x.dtype), "huber", HUBER_SCALE)}
    params = {"alpha": TK_ALPHAS[::HUBER_STEP].astype(np.float64)}

    def run():
        with exact_storage():
            x, recs = solver.run_sweep(params, measures=measures)
        return dict(recs, x=x)
    return run


def irls_admm_study(device):
    """Phase 31's Lena TV-L2 ADMM huber study (4 α × 2 ρ, 10 × 3 × 6,
    records, its default compact storage) through
    ``ADMMLinearSolver.run_sweep``: a closure returning its x and records."""
    import torch

    from nsol_tpu_torch.ops import losses
    from nsol_tpu_torch.solvers.wrappers import ADMMLinearSolver

    img, xs, A, D, Dt = lena_problem()
    bt = torch.as_tensor(img, dtype=torch.float64, device=device)
    its, sweeps, cgi = ROBUST_ITERS["lena"]
    solver = ADMMLinearSolver(
        A, A, img, D, Dt, img, x_scale=xs, data_loss="huber",
        data_loss_scale=HUBER_SCALE, minimizer="auto", iterations=its,
        iter_max=sweeps, irls_cg_iters=cgi, blur_cov=np.eye(2),
        spacing=np.ones(2), device=device)
    measures = {
        "Reg": lambda x: torch.sum(torch.sqrt(torch.sum(D(x) ** 2, 0))),
        "Data": lambda x: losses.cost_from_residual(
            A(x) - bt.to(x.dtype), "huber", HUBER_SCALE)}
    grid = [(float(a), r) for a in TV_ALPHAS[::2] for r in TV_RHOS]
    params = {"alpha": np.array([g[0] for g in grid]),
              "rho": np.array([g[1] for g in grid])}

    def run():
        x, recs = solver.run_sweep(params, measures=measures)
        return dict(recs, x=x)
    return run


def irls_cli(tmp):
    """``nsol_torch_run_deconvolution --data-loss huber`` on the Lena PNG
    (phase 15's 10 × 3 × 6, its default compact storage): a closure
    returning the result."""
    from nsol_tpu_torch import data
    from nsol_tpu_torch.cli import run_deconvolution
    from nsol_tpu_torch.io import DataReader

    its, sweeps, cgi = ROBUST_ITERS["lena"]
    out = os.path.join(tmp, "x.mat")

    def run():
        rc = run_deconvolution.main([
            "--observation", data.path("2D_Lena_256_blur_noise.png"),
            "--result", out, "--solver", "ADMM", "--reconstruction-type",
            "TVL2", "--data-loss", "huber", "--alpha", str(ALPHA), "--blur",
            str(SIGMA), "--iterations", str(its), "--iter-max", str(sweeps),
            "--irls-cg-iters", str(cgi), "--device", "cuda"])
        require(rc == 0, "phase 47: the huber CLI exited %r" % rc)
        reader = DataReader(out)
        reader.read_data()
        return reader.get_data()
    return run


@contextlib.contextmanager
def _host_timed(acc, part, obj, name):
    """Inside the block ``obj.name`` adds its host seconds to
    ``acc[part]``."""
    orig = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return orig(*args, **kwargs)
        finally:
            acc[part] = acc.get(part, 0.0) + time.perf_counter() - t0
    setattr(obj, name, timed)
    try:
        yield
    finally:
        setattr(obj, name, orig)


def host_split(fn, hooks):
    """The parts of one persistent call ``fn()`` by host clock, medians
    over :data:`HOST_SPLIT_CALLS` calls after a warm-up, in ms: each
    ``part`` of ``hooks`` (``(part, obj, name)``: the time spent in
    ``obj.name``), the whole call until it returns (``host``), the rest
    (``other``), and the call by CUDA events (``events``: the stream from
    before the call's first enqueue to after its kernel's end)."""
    import torch

    fn()
    torch.cuda.synchronize()
    rows = []
    for _ in range(HOST_SPLIT_CALLS):
        acc = {}
        with contextlib.ExitStack() as stack:
            for part, obj, name in hooks:
                stack.enter_context(_host_timed(acc, part, obj, name))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fn()
            host = time.perf_counter() - t0
            end.record()
        end.synchronize()
        acc["host"] = host
        acc["other"] = host - sum(v for k, v in acc.items() if k != "host")
        acc = {k: 1e3 * v for k, v in acc.items()}
        acc["events"] = start.elapsed_time(end)
        rows.append(acc)
    return {k: float(np.median([r.get(k, 0.0) for r in rows]))
            for k in rows[0]}


def host_hooks(lib, entry, rule, shape=None):
    """The parts :func:`host_split` times in a persistent call: the route
    rule, the launch shape's query, the scratch allocations, the α/C (and
    x0) copies and the C entry (its own shape query and the cooperative
    launch's enqueue)."""
    import torch

    hooks = [("rule",) + rule, ("launch", lib, entry)]
    if shape is not None:
        hooks.append(("shape",) + shape)
    hooks += [("alloc", torch, name) for name in ("empty", "empty_like",
                                                  "zeros")]
    hooks += [("copy", torch, "tensor"), ("copy", torch.Tensor, "clone"),
              ("copy", torch.Tensor, "pin_memory"),
              ("copy", torch.Tensor, "to")]
    return hooks


def run_irls_persistent_phase(device, card):
    """Phase 47: the robust IRLS sweep as one persistent cooperative launch
    (``csrc/irls_persistent.cu``), for the fused robust ADMM solve and the
    robust Tikhonov batch. Its build (ptxas registers and spills, no
    constant-cache load in its SASS), its launch shape (the configurations
    side by side against the C rule's) and grid barriers (against the
    kernel's stamps); every case of :data:`IRLS_BIT_CASES` and
    :data:`IRLS_TIK_CASES` and the NaN cases bit for bit against the
    launch sequence, three times each, one launch a solve or batch; Lena
    within 1e-4 of 101.442567; the Lena TK1L2 huber sweep at phase 17's
    float64 anchors; each main path against its plain version; the Lena
    ADMM huber study and the huber CLI equal on both routes and to their
    library solves; the shapes the rule refuses on the sequence; the rule
    in C against its mirror; times in turns (sequence, persistent,
    persistent, sequence) by CUDA events of the Lena and 64³ solves, the
    Lena huber batches and sweeps, the study and the CLI; a CUDA graph
    replay of the sequence, the device busy share, the device time by the
    kernel's stamps, the bound, the barriers alone; and a persistent
    call's host parts (the rule, the shape, the allocations, the copies,
    the launch) by host clock, for this kernel's entries and the linear
    Tikhonov batch's. Returns the ``kernels`` records of
    ``irls_solve[persistent]`` and ``irls_batch[persistent]``."""
    import torch

    from nsol_tpu_torch import data, interop, policy
    from nsol_tpu_torch.io import DataReader
    from nsol_tpu_torch.ops import conv as C
    from nsol_tpu_torch.ops.cuda import fused as F
    from nsol_tpu_torch.ops.cuda import robust as R
    from nsol_tpu_torch.ops.cuda import tikhonov as T
    from nsol_tpu_torch.ops.cuda import tiled as Z

    regs = persistent_ptxas(IRLS_KERNEL, "RobustT")
    require(regs == ["cached"] or all("Used 64 registers" in r for r in regs),
            "phase 47: the persistent kernel's registers %s" % regs)
    sass = persistent_sass(IRLS_KERNEL, "RobustT")
    require(sass and all(c == 0 for _, c in sass.values()),
            "phase 47: constant-cache loads in the persistent kernel %s"
            % sass)
    blur = {2: F.taps_lengths([np.ones(7)] * 2)[0],
            3: F.taps_lengths([np.ones(7)] * 3)[0]}
    its, sweeps, cgi = ROBUST_ITERS["lena"]
    shapes = {}
    for (k, d, nconf, storage, reg), width in IRLS_WIDTHS:
        shapes[k] = R.persistent_shape(d, blur[2 if d[0] == 1 else 3], nconf,
                                       storage, reg)
        require(shapes[k][4] == width, "phase 47: %s runs %d side by side, "
                "not %d" % (k, shapes[k][4], width))
    barriers = {
        "Lena solve": R.persistent_barriers(its, sweeps, cgi),
        "Lena solve records": R.persistent_barriers(its, sweeps, cgi, True),
        "Lena x 8": R.persistent_barriers(1, HUBER_SWEEPS, HUBER_CG),
        "Lena x 130": R.persistent_barriers(1, HUBER_SWEEPS, HUBER_CG,
                                            turns=-(-130 // 12))}
    barrier_ms = {k: F.persistent_barrier_ms(barriers["Lena solve"], v[1],
                                             v[3], device)
                  for k, v in shapes.items() if k in ("Lena solve",
                                                      "64^3 x 8")}
    print("phase 47 build: ptxas %s; SASS (global loads, constant-cache "
          "loads) %s; launch shape (blocks an SM, grid, the sequence's "
          "blocks a volume, threads a block, configurations side by side) "
          "%s, the widths %s as the C rule gives; grid barriers %s; %d "
          "barriers alone at the Lena solve's and the 64^3 batch's grid %s "
          "ms [%s]"
          % (regs, sass, shapes, [w for _, w in IRLS_WIDTHS], barriers,
             barriers["Lena solve"],
             {k: "%.3f" % v for k, v in barrier_ms.items()}, card))

    problems = persistent_problems(device)
    maxes, lena_x = irls_bits(F, T, device, problems)
    b = problems["lena"][0]
    A2, _ = C.make_blur_operators(np.eye(2), alpha_cut=3, dtype=np.float64)
    obj = robust_objective(lena_x, b, A2, ALPHA)
    dev = abs(obj - LENA_ROBUST_ANCHOR) / LENA_ROBUST_ANCHOR
    require(dev <= ROBUST_ANCHOR_BAND, "phase 47: Lena objective %.6f "
            "deviates %.3g from %.6f" % (obj, dev, LENA_ROBUST_ANCHOR))
    refused = irls_refusals(F, R, T, device)
    # the rule in C (nsol_robust_persistent_route) against its mirror
    lib = F.build.load()
    rule_cases = 0
    for shape in PERSISTENT_ROUTE_SHAPES + (SCALE_SHAPE, (64, 128, 128),
                                            (64, 128, 129)):
        dims = (1,) * (3 - len(shape)) + tuple(shape)
        for taps in (7, 61):
            lens = F.taps_lengths([np.ones(taps)] * len(shape))[0]
            for storage in R.ROBUST_STORAGE:
                c = lib.nsol_robust_persistent_route(
                    R.ROBUST_STORAGE.index(storage), *lens, *dims)
                py = Z.irls_persistent_fits(dims, lens, storage)
                require(bool(c) == py, "phase 47: the rule of %s taps %d %s:"
                        " C %d, Python %s" % (shape, taps, storage, c, py))
                rule_cases += 1
    print("phase 47 bits: %d cases x %d calls bit for bit (NaN and signed "
          "zeros) the launch sequence's, one launch a solve or batch, no "
          "plain call: %s; Lena huber objective %.6f (anchor %.6f, dev "
          "%.2e); the refusals (launches) %s; the rule in C equal to its "
          "Python mirror in %d cases [%s]"
          % (len(maxes), PERSISTENT_REPEATS, sorted(maxes), obj,
             LENA_ROBUST_ANCHOR, dev, refused, rule_cases, card))
    lap("phase 47 bits")

    # the studies, the CLI and the sweeps on both routes: the same results
    rows, got = {}, {}
    runs = {"Lena TK1L2 huber run_sweep": irls_study(device, "TK1"),
            "Lena TK0L2 huber run_sweep": irls_study(device, "TK0"),
            "Lena ADMM huber study": irls_admm_study(device)}
    with tempfile.TemporaryDirectory() as tmp:
        runs["huber CLI"] = irls_cli(tmp)
        for key, fn in runs.items():
            rows[key] = []
            for turn in ("sequence", "persistent", "persistent", "sequence"):
                route = robust_sequence() \
                    if turn == "sequence" else contextlib.nullcontext()
                with route:
                    F.reset_counts()
                    got[(key, turn)], ms = timed_once(fn)
                    rows[key].append(ms)
                    launched = used_counts(F)[0]
                require(("irls_persistent" in launched) == (
                    turn == "persistent"), "phase 47: %s, %s turn, launches "
                    "%s" % (key, turn, launched))
                if turn == "persistent" and key == "Lena ADMM huber study":
                    require(launched["irls_persistent"] == 8,
                            "phase 47: the study launches %s" % launched)
            seq, pers = got[(key, "sequence")], got[(key, "persistent")]
            same = np_bits(seq, pers) if key == "huber CLI" else all(
                np_bits(seq[k], pers[k]) for k in seq)
            require(same, "phase 47: %s differs on the two routes" % key)
        # the CLI is its library solve (the policy's compact fused solve)
        reader = DataReader(data.path("2D_Lena_256_blur_noise.png"))
        reader.read_data()
        nda = reader.get_data()
        xs = np.max(nda)
        build, kw = policy.tvl2_solver(nda.shape, np.eye(2), np.ones(2),
                                       "cuda", its, sweeps, "huber", cgi)
        bs = torch.as_tensor(nda / xs, dtype=torch.float32, device=device)
        lib_x = interop.to_numpy(build(**kw)(bs, bs, ALPHA, RHO))
        require(np.array_equal(got[("huber CLI", "persistent")],
                               lib_x.astype(np.float64) * xs),
                "phase 47: the huber CLI is not its library solve")
    # the Lena TK1L2 huber sweep at phase 17's float64 anchors
    img, xs, A, D, _ = lena_problem()
    bt = torch.as_tensor(img / xs, dtype=torch.float32, device=device)
    xk = torch.as_tensor(got[("Lena TK1L2 huber run_sweep", "persistent")]
                         ["x"] / xs, device=device)
    anchors = {}
    for (reg, loss, i), anchor in TK_ANCHORS.items():
        if (reg, loss) != ("TK1", "huber"):
            continue
        o = tk_objective(xk[i // HUBER_STEP], bt, A, D, float(TK_ALPHAS[i]),
                         loss)
        anchors[i] = abs(o - anchor) / anchor
        require(anchors[i] <= STUDY_ANCHOR_BAND, "phase 47: TK1L2 huber "
                "alpha[%d] objective %.9f deviates %.3g from %.9f"
                % (i, o, anchors[i], anchor))
    print("phase 47 on both routes the same bits: %s; the huber CLI equals "
          "its library solve (%s); the TK1L2 huber sweep vs the float64 "
          "anchors %s (band %g) [%s]"
          % (sorted(runs), build.__name__,
             {i: "%.2e" % d for i, d in anchors.items()}, STUDY_ANCHOR_BAND,
             card))

    # times in turns, by CUDA events: the main paths, the 64³ phantom and
    # the rule's other shapes (IRLS_EDGE_SHAPES)
    cube = problems["phantom"][0]
    edges = {label: irls_problem(shape, problems, device)
             for label, shape in IRLS_EDGE_SHAPES}
    solves = [("Lena huber exact", b, {}), ("Lena huber dirs", b,
                                            FUSED_COMPACT),
              ("64^3 huber exact", cube, {}), ("64^3 huber dirs", cube,
                                               FUSED_COMPACT)]
    solves += [("%s huber exact" % k, v, {}) for k, v in edges.items()]
    for key, src, kw in solves:
        solve = F.make_fused_admm_solver(tuple(src.shape),
                                         np.eye(src.dim()), iterations=its,
                                         iter_max=sweeps, data_loss="huber",
                                         irls_cg_iters=cgi, **kw)
        require(solve.route == "persistent", "phase 47: %s takes %s"
                % (key, solve.route))
        rows[key] = turns_ms(partial(solve.sequence, src, src, ALPHA, RHO),
                             partial(solve, src, src, ALPHA, RHO), 5)
    h_alphas = [float(a) for a in TK_ALPHAS[::HUBER_STEP]]
    batches = [("Lena TK1L2 huber x 8 batch", b, "TK1"),
               ("Lena TK0L2 huber x 8 batch", b, "TK0"),
               ("64^3 TK1L2 huber x 8 batch", cube, "TK1")]
    batches += [("%s TK1L2 huber x 8 batch" % k, v, "TK1")
                for k, v in edges.items()]
    for key, src, reg in batches:
        solve = tik_solver(T, src, reg, iter_max=HUBER_SWEEPS,
                           data_loss="huber", irls_cg_iters=HUBER_CG)
        require(solve.route == "persistent", "phase 47: %s takes %s"
                % (key, solve.route))
        rows[key] = turns_ms(partial(solve.sequence, src, src, h_alphas),
                             partial(solve, src, src, h_alphas), 5)
    del edges
    # the shapes where the sequence's turns came out faster (the rule
    # keeps every shape the launch beats)
    slower = sorted(k for k, v in rows.items() if k not in runs
                    and np.median(v[1:3]) >= np.median(v[::3]))
    print("phase 47 ms by CUDA events, turns sequence / persistent / "
          "persistent / sequence (a solve or batch: median of 5; run_sweep, "
          "the study and the CLI: one run each, their results equal on the "
          "two routes): %s; the persistent launch no faster than the "
          "sequence at: %s [%s]" % ("; ".join(
              "%s %s" % (k, turns_line(v)) for k, v in rows.items()),
              ", ".join(slower) or "none", card))
    lap("phase 47 times")

    # the main paths: the Lena huber solve and the Lena TK1L2 huber × 8
    # batch; a CUDA graph replay of each launch sequence; the device busy
    # share; the device time by the stamps; the bound
    solve = F.make_fused_admm_solver(tuple(b.shape), np.eye(2),
                                     iterations=its, iter_max=sweeps,
                                     data_loss="huber", irls_cg_iters=cgi)
    batch = tik_solver(T, b, iter_max=HUBER_SWEEPS, data_loss="huber",
                       irls_cg_iters=HUBER_CG)
    mains = {"irls_solve[persistent]": (
                 solve, (b, b, ALPHA, RHO), rows["Lena huber exact"],
                 "nsol_tpu/ops/pallas/fused.py:382", 1),
             "irls_batch[persistent]": (
                 batch, (b, b, h_alphas), rows["Lena TK1L2 huber x 8 batch"],
                 "nsol_tpu/ops/pallas/fused.py:716", len(h_alphas))}
    entries = []
    for name, (fn, args, turns, replaces, outputs) in mains.items():
        pers = partial(fn, *args)
        graph, x_graph = graph_of(partial(fn.sequence, *args))
        graph.replay()
        torch.cuda.synchronize()
        require(nan_bits_equal(x_graph, pers()), "phase 47: %s: the graph "
                "replay differs from the persistent launch" % name)
        graph_t = [cuda_median_ms(f, 5) for f in (graph.replay, pers, pers,
                                                  graph.replay)]
        del graph
        busy = {}
        for route, f in (("sequence", partial(fn.sequence, *args)),
                         ("persistent", pers)):
            busy[route] = (device_busy_ms(f)[0], cuda_median_ms(f, 3))
        phases = F.persistent_phases(pers, device)
        stamps_ms = sum(us for _, us in phases.values()) / 1e3
        stamped = sum(c for k, (c, _) in phases.items() if k != "reduce")
        want = barriers["Lena solve" if outputs == 1 else "Lena x 8"]
        require(stamped == want, "phase 47: %s stamped %d barriers, the "
                "formula %d" % (name, stamped, want))
        torch.cuda.synchronize()
        F.reset_counts()
        x = pers()
        torch.cuda.synchronize()
        launches = F.launch_counts(F.PERSISTENT_UNITS)["irls_persistent"]
        require(launches == 1, "phase 47: the %s main path made %d "
                "persistent launches" % (name, launches))
        F.reset_counts()
        fn.sequence(*args)
        torch.cuda.synchronize()
        counts = {k: v for k, v in F.launch_counts().items() if v}
        (b_ms, b_by), units_ms = persistent_bound(
            counts, 256 ** 2, (1, 13, 13), blur[2], outputs=outputs)
        x_p, plain_ms = timed_once(partial(fn.plain, *args))
        err = float((x - x_p).abs().max())
        require(max_rel(x, x_p) <= SOLVE_VOX_TOL and bool(x.isfinite().all()),
                "phase 47: %s vs plain voxel rel %.3g" % (name,
                                                          max_rel(x, x_p)))
        print("phase 47 %s Lena (%s): launches %d, max|d| vs plain %.3e "
              "(rel %.2e, limit %g); CUDA graph replay of the launch "
              "sequence vs the persistent launch, ms (turns graph / "
              "persistent / persistent / graph) %s; device busy "
              "(torch.profiler device ms / wall ms) %s; device ms by the "
              "global timer's stamps %.4f (%.1f %% of the persistent wall "
              "ms); a traced call's phases (count x "
              "mean us): %s; bound %.4f ms (%s: b, x0 in and %d x out, and "
              "the sequence's %s operations), its units' bounds summed "
              "%.4f ms [%s]"
              % (name, "10 x 3 x 6" if outputs == 1 else "x 8, 5 x 8",
                 launches, err, max_rel(x, x_p), SOLVE_VOX_TOL,
                 turns_line(graph_t), {
                     k: "%s/%.3f" % (ms_text(d), w)
                     for k, (d, w) in busy.items()}, stamps_ms,
                 100 * stamps_ms / float(np.median(graph_t[1:3])), "; ".join(
                     "%s %d x %.2f" % (k, c, us / c)
                     for k, (c, us) in phases.items()),
                 b_ms, b_by, outputs, counts, units_ms, card))
        entries.append({
            "name": name, "route": "cuda",
            "source": "nsol_tpu_torch/csrc/irls_persistent.cu",
            "replaces": replaces, "launches": int(launches),
            "max_abs_err": err, "ms": float(np.median(turns[1:3])),
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "device_ms": stamps_ms,
            "sequence_ms": float(np.median(turns[::3])),
            "graph_replay_ms": float(np.median(graph_t[::3]))})
    lap("phase 47 main paths")

    # a persistent call's host parts, for this kernel's two entries and
    # the linear Tikhonov batch of phase 46
    linear = tik_solver(T, b)
    tk_alphas = [float(a) for a in TK_ALPHAS]
    split = {
        "irls_solve Lena": host_split(
            partial(solve, b, b, ALPHA, RHO),
            host_hooks(lib, "nsol_robust_admm_solve_persistent",
                       (Z, ROBUST_RULE))),
        "irls_batch Lena huber x 8": host_split(
            partial(batch, b, b, h_alphas),
            host_hooks(lib, "nsol_irls_batch_persistent",
                       (T, "tikhonov_persistent_route"),
                       (R, "persistent_shape"))),
        "tik_persistent Lena TK1L2 x 64": host_split(
            partial(linear, b, b, tk_alphas),
            host_hooks(lib, "nsol_tikhonov_solve_persistent",
                       (T, "tikhonov_persistent_route"),
                       (T, "persistent_shape")))}
    print("phase 47 a persistent call's parts by host clock, ms (medians of "
          "%d calls; host: the call until it returns; events: the call by "
          "CUDA events): %s [%s]"
          % (HOST_SPLIT_CALLS, "; ".join(
              "%s %s" % (k, ", ".join("%s %.4f" % kv for kv in v.items()))
              for k, v in split.items()), card))
    for entry in entries:
        entry["host_split_ms"] = split[
            "irls_solve Lena" if entry["name"].startswith("irls_solve")
            else "irls_batch Lena huber x 8"]
    lap("phase 47")
    return entries


# ------------------------------------------- phase 48 (pd_persistent) --

#: phase 48's bit cases: (label, problem or shape, spacing): Lena and the
#: 64³ phantom (the main paths), a ragged image and two ragged volumes,
#: anisotropic where the label says so; each at every type × schedule ×
#: storage × records, B = 1 and 3
PD_BIT_SHAPES = (("Lena", "lena", None), ("37x53 aniso", (37, 53),
                                          PD_SPACING[:2]),
                 ("64^3 phantom", "phantom", None),
                 ("37x45x53", (37, 45, 53), None),
                 ("5x40x33 aniso", (5, 40, 33), PD_SPACING))
#: phase 48's turns: (label, problem, batch, records) of the rule's side
#: and, forced onto the one launch, past it (the state's MiB: Lena x 28
#: 28.25 of the rule's 32, x 36 36.25; Man x 1 20, x 2 36)
PD_TURNS = (("Lena x 1", "lena", 1, False), ("Lena x 1 records", "lena", 1,
                                             True),
            ("Lena x 8 records", "lena", 8, True),
            ("64^3 phantom", "phantom", 1, False),
            ("Man 1024^2 x 1", "man", 1, False),
            ("Lena x 28", "lena", 28, False),
            ("Lena x 36 (past the rule)", "lena", 36, False),
            ("Man 1024^2 x 2 (past the rule)", "man", 2, False))
#: the route's table (the C rule, ``solve.route(nb)``): (problem, batch,
#: compact) → the one launch
PD_ROUTE_TABLE = {("lena", 1, False): True, ("lena", 1, True): True,
                  ("lena", 8, False): True, ("lena", 8, True): True,
                  ("lena", 64, False): False, ("lena", 64, True): False,
                  ("phantom", 1, False): True, ("phantom", 1, True): True,
                  ("man", 1, False): True, ("man", 1, True): True,
                  ("man", 64, False): False, ("man", 64, True): False,
                  ("256^3", 1, False): False, ("256^3", 1, True): False}
PD_KERNEL = "pd_persistent_kernel"
#: the most bytes an instance of it may spill: at two blocks an SM (64
#: registers) the bf16 image records' march spills 76
PD_SPILL_BYTES = 128


def pd_problems(device):
    """The denoising path's images, scaled to max 1: Lena 256² (the
    noisy PNG), the noisy 64³ phantom of phase 10, Man 1024²."""
    import torch

    from nsol_tpu_torch import data
    from nsol_tpu_torch.io import read_nifti, read_png

    lena = read_png(data.path("2D_Lena_256_noise.png")).astype(np.float64)
    phantom = read_nifti(data.path("3D_SheppLoganPhantom_64.nii.gz")) \
        .data.astype(np.float64)
    noisy = phantom + np.random.RandomState(0).normal(
        0, 0.05 * phantom.max(), phantom.shape)
    man = read_png(data.path("2D_Man_1024.png")).astype(np.float64)
    return {k: torch.as_tensor((v / v.max()).astype(np.float32),
                               device=device)
            for k, v in (("lena", lena), ("phantom", noisy), ("man", man))}


def pd_case(F, label, solve, args, record, repeats=1):
    """``solve.sequence`` once and the library call (the default route)
    ``repeats`` times: each output bit for bit the sequence's, NaN-equal,
    one ``pd_persistent`` launch a call, nothing else launched and no plain
    call."""
    import torch

    want = solve.sequence(*args)
    torch.cuda.synchronize()
    F.reset_counts()
    got = [solve(*args) for _ in range(repeats)]
    torch.cuda.synchronize()
    counts = used_counts(F)
    require(counts == ({"pd_persistent": repeats}, {}), "phase 48: %s "
            "launches %s" % (label, counts))
    for g in got:
        require(irls_same(g, want, record), "phase 48: %s: the one launch is "
                "not the launch sequence's bits" % label)


def pd_persistent_bound(counts, n, nd, batch, compact=False):
    """The one-launch solve's bound: the bytes it must move (b read, x0
    read and ``batch`` x written at the state's width) and the float32
    operations of the launch sequence's units at the counts that sequence
    makes (:func:`unit_bound`'s operations a voxel); and the sum of the
    units' own bounds at those counts (each unit's volumes through HBM: no
    floor where the state sits in the 50 MB L2)."""
    ops = {"pd_dual": 12 * nd, "pd_primal": 10 + 3 * nd,
           "pd_record": 10 + 3 * nd}
    elt = 2 if compact else 4
    total = sum(ops[k] * c for k, c in counts.items() if c)
    units = sum(unit_bound(k, n, nd=nd, batch=batch)[0] * c
                for k, c in counts.items() if c)
    return bound(4.0 * n + elt * n * (1 + batch),
                 float(n) * batch * total), units


@contextlib.contextmanager
def pd_persistent_forced():
    """Inside the block every PD solve on the card takes the one launch,
    whatever the rule says (to time it past the rule)."""
    from nsol_tpu_torch.ops.cuda import fused as F

    saved = F.pd_persistent_route
    F.pd_persistent_route = lambda *args, **kwargs: True
    try:
        yield
    finally:
        F.pd_persistent_route = saved


def run_pd_persistent_phase(device, card):
    """Phase 48: the fused primal-dual denoise as one persistent
    cooperative launch (``csrc/pd_persistent.cu``). Its build (ptxas
    registers and spills, no constant-cache load in its SASS), its launch
    shapes and grid barriers (against the kernel's stamps); every case of
    :data:`PD_BIT_SHAPES` (4 types × 3 schedules × exact/compact ×
    records, B 1 and 3) and the NaN strips of :func:`pd_nan_case` (in b
    and in x0) bit for bit against ``nsol_pd_solve``'s launch sequence,
    one launch a call; the route's table in C; the refusals on the
    sequence; times in turns (sequence, persistent, persistent, sequence)
    by CUDA events of :data:`PD_TURNS`; on Lena a CUDA graph replay of the
    sequence, the device busy share, the device time by the stamps, the
    bound, and a persistent call's host parts (the rule, the schedules,
    the allocations, the C entry) by host clock. Returns the ``kernels``
    record of ``pd_solve[persistent]``."""
    import torch

    from nsol_tpu_torch.ops.cuda import fused as F

    regs = persistent_ptxas(PD_KERNEL, PD_KERNEL)
    spills = [int(m) for r in regs
              for m in re.findall(r"(\d+) bytes spill stores", r)]
    require(regs == ["cached"] or (len(spills) == len(regs) == 6 and max(
        spills) <= PD_SPILL_BYTES), "phase 48: the persistent kernel's "
        "instances or spills %s" % regs)
    sass = persistent_sass(PD_KERNEL, PD_KERNEL)
    require(sass and all(c == 0 for _, c in sass.values()),
            "phase 48: constant-cache loads in the persistent kernel %s"
            % sass)
    problems = pd_problems(device)
    shapes = {}
    for key, rec in (("Lena x 1", False), ("Lena x 1 records", True),
                     ("Lena x 8 records", True), ("64^3", False),
                     ("Man x 1", False)):
        src = {"L": "lena", "6": "phantom", "M": "man"}[key[0]]
        shape = tuple(problems[src].shape)
        nb = 8 if "x 8" in key else 1
        shapes[key] = F.pd_persistent_shape(
            len(shape), False, rec, (nb,) + (1,) * (3 - len(shape)) + shape)
    barriers = {"50 iterations": F.pd_persistent_barriers(ITERATIONS),
                "50 iterations, records": F.pd_persistent_barriers(
                    ITERATIONS, True)}
    print("phase 48 build: ptxas %s; SASS (global loads, constant-cache "
          "loads) %s; launch shape (blocks an SM, grid, the sequence's "
          "blocks a dual/primal phase, threads a block, the record march's "
          "blocks) %s; grid barriers a solve %s (the sequence: 100 "
          "launches, 202 with records) [%s]"
          % (regs, sass, shapes, barriers, card))

    # the route's table, in C
    route_rows = {}
    for (src, nb, compact), takes in PD_ROUTE_TABLE.items():
        shape = (256,) * 3 if src == "256^3" else tuple(problems[src].shape)
        solve = F.make_fused_pd_denoise_solver(shape, "TVL2",
                                               compact=compact)
        got = solve.route(nb)
        route_rows["%s x %d%s" % (src, nb, " compact" if compact else "")] \
            = got
        require(got == ("persistent" if takes else "sequence"),
                "phase 48: the rule sends %s x %d compact %s to %s"
                % (src, nb, compact, got))

    # every bit case, one launch a call
    cases = 0
    for label, src, spacing in PD_BIT_SHAPES:
        b = problems[src] if isinstance(src, str) else torch.as_tensor(
            np.random.RandomState(48).rand(*src).astype(np.float32),
            device=device)
        shape = tuple(b.shape)
        for rtype in PD_TYPES:
            for alg in PD_ALGS:
                for compact in (False, True):
                    for record in (False, True):
                        solve = F.make_fused_pd_denoise_solver(
                            shape, rtype, alg, ITERATIONS, spacing=spacing,
                            record=record, compact=compact)
                        main = (label in ("Lena", "64^3 phantom")
                                and (rtype, alg) == ("TVL2", "ALG2"))
                        for alphas in (PD_ALPHA, list(PD_UNIT_ALPHAS)):
                            pd_case(F, "%s %s %s compact %s records %s B %d"
                                    % (label, rtype, alg, compact, record,
                                       np.size(alphas)), solve,
                                    (b, b, alphas, PD_L2), record,
                                    PERSISTENT_REPEATS if main else 1)
                            cases += 1
    nans = {}
    for shape in ((40, 33), (12, 16, 16)):
        clean = torch.as_tensor(np.random.RandomState(8).rand(*shape)
                                .astype(np.float32), device=device)
        strip = clean.clone()
        strip[:2] = float("nan")
        for rtype in PD_TYPES:
            solve = F.make_fused_pd_denoise_solver(shape, rtype,
                                                   iterations=6, record=True)
            for where, args in (("b", (strip, clean)), ("x0", (clean,
                                                                strip))):
                pd_case(F, "NaN in %s %s %s" % (where, rtype, shape), solve,
                        args + ([0.1, 0.5], PD_L2), True)
                x = solve(*args, [0.1, 0.5], PD_L2)[0]
                nans["%s %s %s" % (where, rtype, "x".join(map(str, shape)))] \
                    = int(torch.isnan(x).sum())
                cases += 1
    # past the rule: the launch sequence
    refused = {}
    for src, nb, compact in (("lena", 64, False), ("lena", 64, True)):
        b = problems[src]
        solve = F.make_fused_pd_denoise_solver(tuple(b.shape), "TVL2",
                                               iterations=ITERATIONS,
                                               compact=compact)
        F.reset_counts()
        solve(b, b, list(np.linspace(0.01, 1.5, nb, dtype=np.float32)),
              PD_L2)
        torch.cuda.synchronize()
        got = F.launch_counts(F.PD_UNITS)
        refused["%s x %d%s" % (src, nb, " compact" if compact else "")] = got
        require(got == {"pd_dual": ITERATIONS, "pd_primal": ITERATIONS,
                        "pd_record": 0, "pd_persistent": 0},
                "phase 48: %s x %d compact %s launches %s" % (src, nb,
                                                              compact, got))
    print("phase 48 bits: %d cases bit for bit (NaN and signed zeros) the "
          "launch sequence's, one launch a call, no plain call (the main "
          "paths' %d times); NaN voxels of x with a NaN strip %s; the C "
          "rule's routes %s; past the rule (launches) %s [%s]"
          % (cases, PERSISTENT_REPEATS, nans, route_rows, refused, card))
    lap("phase 48 bits")

    # times in turns, by CUDA events
    rows = {}
    for label, src, nb, record in PD_TURNS:
        b = problems[src]
        solve = F.make_fused_pd_denoise_solver(tuple(b.shape), "TVL2",
                                               "ALG2", ITERATIONS,
                                               record=record)
        alphas = PD_ALPHA if nb == 1 else list(np.linspace(
            0.01, 1.5, nb, dtype=np.float32))
        past = "past the rule" in label
        require((solve.route(nb) == "sequence") == past,
                "phase 48: %s takes %s" % (label, solve.route(nb)))
        with pd_persistent_forced() if past else contextlib.nullcontext():
            rows[label] = turns_ms(partial(solve.sequence, b, b, alphas,
                                           PD_L2),
                                   partial(solve, b, b, alphas, PD_L2), 10)
    slower = sorted(k for k, v in rows.items() if "past the rule" not in k
                    and np.median(v[1:3]) >= np.median(v[::3]))
    print("phase 48 ms a solve by CUDA events, TVL2/ALG2 %d iterations, "
          "turns sequence / persistent / persistent / sequence (median of "
          "10; past the rule the one launch forced): %s; the persistent "
          "launch no faster than the sequence at (shapes the rule takes): "
          "%s [%s]" % (ITERATIONS, "; ".join(
              "%s %s" % (k, turns_line(v)) for k, v in rows.items()),
              ", ".join(slower) or "none", card))
    lap("phase 48 times")

    # the main path, Lena 256² x 1: a CUDA graph replay of the sequence,
    # the device busy share, the device time by the stamps, the bound, the
    # host parts; the records' solve's stamps too
    b = problems["lena"]
    solve = F.make_fused_pd_denoise_solver(tuple(b.shape), "TVL2", "ALG2",
                                           ITERATIONS)
    args = (b, b, PD_ALPHA, PD_L2)
    pers = partial(solve, *args)
    # the graph holds the sequence's device work (its schedules made
    # before: a host-to-device copy cannot be captured)
    sched = F.interop.pd_schedules(*F._pd_schedules(
        PD_ALPHA, PD_L2, ITERATIONS, "ALG2", np.float32), device)
    graph, x_graph = graph_of(partial(
        F._pd_solve_cuda, b, b, sched, (1.0, 1.0), False, False,
        F.HUBER_CONJ_GAMMA, False, F.HUBER_CONJ_GAMMA, False, "sequence"))
    graph.replay()
    torch.cuda.synchronize()
    require(nan_bits_equal(x_graph[0][0], pers()), "phase 48: the graph "
            "replay differs from the persistent launch")
    graph_t = [cuda_median_ms(f, 10) for f in (graph.replay, pers, pers,
                                               graph.replay)]
    del graph
    busy = {}
    for route, fn in (("sequence", partial(solve.sequence, *args)),
                      ("persistent", pers)):
        busy[route] = (device_busy_ms(fn)[0], cuda_median_ms(fn, 5))
    traced = {}
    for key, record in (("Lena x 1", False), ("Lena x 1 records", True)):
        s = F.make_fused_pd_denoise_solver(tuple(b.shape), "TVL2", "ALG2",
                                           ITERATIONS, record=record)
        phases = F.persistent_phases(partial(s, *args), device)
        stamped = sum(c for k, (c, _) in phases.items() if k != "pd end")
        want = F.pd_persistent_barriers(ITERATIONS, record)
        require(stamped == want, "phase 48: %s stamped %d barriers, the "
                "formula %d" % (key, stamped, want))
        traced[key] = (sum(us for _, us in phases.values()) / 1e3, phases)
    stamps_ms = traced["Lena x 1"][0]
    torch.cuda.synchronize()
    F.reset_counts()
    x = pers()
    torch.cuda.synchronize()
    launches = F.launch_counts(F.PD_UNITS)
    require(launches == PD_ONE_LAUNCH, "phase 48: the Lena main path "
            "launched %s" % launches)
    F.reset_counts()
    solve.sequence(*args)
    torch.cuda.synchronize()
    counts = {k: v for k, v in F.launch_counts(F.PD_UNITS).items() if v}
    (b_ms, b_by), units_ms = pd_persistent_bound(counts, 256 ** 2, 2, 1)
    x_p, plain_ms = timed_once(partial(solve.plain, *args))
    err = float((x - x_p).abs().max())
    require(max_rel(x, x_p) <= KERNEL_TOL and bool(x.isfinite().all()),
            "phase 48: Lena vs plain voxel rel %.3g" % max_rel(x, x_p))
    lib = F.build.load()
    split = host_split(pers, [
        ("rule", F, "pd_persistent_route"),
        ("launch", lib, "nsol_pd_solve_persistent"),
        ("schedules", F, "_pd_schedules"),
        ("schedule copy", F.interop, "pd_schedules"),
        ("alloc", torch, "empty"), ("alloc", torch, "empty_like")])
    wall = float(np.median(rows["Lena x 1"][1:3]))
    print("phase 48 pd_solve[persistent] Lena 256^2 TVL2/ALG2 %d: launches "
          "%s; max|d| vs plain %.3e (rel %.2e, limit %g); CUDA graph replay "
          "of the launch sequence vs the persistent launch, ms (turns graph "
          "/ persistent / persistent / graph) %s; device busy "
          "(torch.profiler device ms / wall ms) %s; device ms by the global "
          "timer's stamps %.4f (%.1f %% of the persistent wall ms by CUDA "
          "events); a traced call's phases (count x mean us): %s; with "
          "records %.4f ms: %s; bound %.4f ms (%s: b, x0 in, x out, and the "
          "sequence's %s operations), its units' bounds summed %.4f ms; a "
          "persistent call's parts by host clock, ms (medians of %d calls; "
          "host: the call until it returns; events: the call by CUDA "
          "events): %s [%s]"
          % (ITERATIONS, launches, err, max_rel(x, x_p), KERNEL_TOL,
             turns_line(graph_t), {
                 k: "%s/%.3f" % (ms_text(d), w) for k, (d, w) in busy.items()},
             stamps_ms, 100 * stamps_ms / wall, "; ".join(
                 "%s %d x %.2f" % (k, c, us / c)
                 for k, (c, us) in traced["Lena x 1"][1].items()),
             traced["Lena x 1 records"][0], "; ".join(
                 "%s %d x %.2f" % (k, c, us / c)
                 for k, (c, us) in traced["Lena x 1 records"][1].items()),
             b_ms, b_by, counts, units_ms, HOST_SPLIT_CALLS, ", ".join(
                 "%s %.4f" % kv for kv in split.items()), card))
    lap("phase 48")
    return [{"name": "pd_solve[persistent]", "route": "cuda",
             "source": "nsol_tpu_torch/csrc/pd_persistent.cu",
             "replaces": "nsol_tpu/ops/pallas/fused.py:957",
             "launches": int(launches["pd_persistent"]), "max_abs_err": err,
             "ms": wall, "plain_ms": plain_ms, "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": None, "device_ms": stamps_ms,
             "sequence_ms": float(np.median(rows["Lena x 1"][::3])),
             "graph_replay_ms": float(np.median(graph_t[::3])),
             "units_bound_ms": units_ms, "host_split_ms": split}]


#: ``csrc/probes.cu``'s kernels and the TPU kernels (def lines) each
#: replaces in ``benchmarks/``
PROBE_REPLACES = {
    "probe_scale": "benchmarks/shard_pallas_diag.py:68, "
    "benchmarks/shard_pallas_diag2.py:45, benchmarks/shard_pallas_diag3.py:48, "
    "benchmarks/shard_pallas_diag4.py:89",
    "probe_window_scale": "benchmarks/shard_pallas_diag4.py:46, "
    "benchmarks/shard_pallas_diag5.py:68, benchmarks/shard_pallas_diag6.py:48",
    "probe_block_matmul": "benchmarks/shard_pallas_diag6.py:48, "
    "benchmarks/shard_pallas_diag7.py:46",
    "probe_block_matmul[default]": "benchmarks/shard_pallas_diag7.py:46"}
#: the streams' shapes: the probes' two, 40 planes of 24 × 40 (a ragged
#: last z-block, a plane of 240 16-byte columns), 5 planes of 24 × 40 (fewer
#: planes than a z-block of 8) and 3 of 512 × 512 (65536 columns: K2's tiles
#: in more than one wave); the products': the
#: probes', 8 × 48 × 80 and 5 × 136 × 200 (a ragged last tile, band and k
#: step on every axis), 3 × 37 × 45 (rows not 16-byte aligned: the 4-byte
#: copies), 4 × 64 × 384 (an x-side matrix past "DEFAULT"'s resident
#: budget: two parts of 256 rows, a ring of 3 slots), and 2 × 520 × 136 and
#: 2 × 40 × 520 (a matrix past :data:`PROBE_PLAIN_MAX_K` on the y and on
#: the x side: three parts of 256 rows, k in two parts whose sums are read
#: back)
PROBE_STREAM_SHAPES = (SCALE_SHAPE, (32, 64, 64), (40, 24, 40), (5, 24, 40),
                       (3, 512, 512))
#: the streams' z-blocks: the probes' 32 and 8, and 4 (2·R > zb: a window
#: shares planes with more than one neighbour)
PROBE_STREAM_ZB = (32, 8, 4)
PROBE_MATMUL_SHAPES = (SCALE_SHAPE, (8, 48, 80), (5, 136, 200), (3, 37, 45),
                       (4, 64, 384), (2, 520, 136), (2, 40, 520))
#: K3's forms the probes run: diag7's x side, diag6's y and x side with trans
PROBE_MATMUL_FORMS = (("x", False), ("x", True), ("y", True))
#: K3 against the float64 product ("HIGHEST": float32 sums of 256 terms)
#: and against its plain version on the same bf16-rounded inputs
#: ("DEFAULT": the products exact in float32, only the order of the sums
#: differs), as max |Δ| / max |ref|
PROBE_MATMUL_TOL = {"HIGHEST": 1e-5, "DEFAULT": 1e-6}
#: past this many products a sum, "DEFAULT" is held to the float64 sum of
#: the bf16-rounded inputs instead: the plain version's own float32 sums
#: then carry rounding of the gate's order (the kernel's distance to them
#: reached 1.03e-6 on a 2 × 520 × 136 y-trans case)
PROBE_PLAIN_MAX_K = 384
PROBE_KERNELS = ("probe_scale_kernel", "probe_window_kernel",
                 "probe_sgemm_kernel", "probe_mma_stream_kernel")


def probe_matmul_bound(shape, precision):
    """``(bound_ms, bound_by)`` of one x-side product of every plane of a
    ``shape`` volume with an (X, X) matrix: x and the matrix read once, the
    volume written once; 2·X operations a voxel, at the float32 rate
    ("HIGHEST") or the tensor cores' bf16 rate ("DEFAULT")."""
    n, k = int(np.prod(shape)), shape[2]
    nbytes = 4.0 * (2 * n + k * k)
    tb = nbytes / HBM_BYTES_S * 1e3
    to = 2.0 * n * k / (F32_OPS_S if precision == "HIGHEST"
                        else BF16_OPS_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def probe_matmul_reference(SP, x, m, side, precision, trans):
    """What K3 is held to within :data:`PROBE_MATMUL_TOL`: "HIGHEST" the
    float64 product; "DEFAULT" its plain version, or the float64 sum of the
    bf16-rounded inputs past :data:`PROBE_PLAIN_MAX_K` products a sum."""
    k = x.shape[2] if side == "x" else x.shape[1]
    if precision == "HIGHEST" or k > PROBE_PLAIN_MAX_K:
        return SP.probe_block_matmul_plain(x.double(), m.double(), side,
                                           precision, trans)
    return SP.probe_block_matmul_plain(x, m, side, precision, trans)


def probe_refusals(SP, device):
    """The wrappers refuse a misaligned view, a plane not of 16-byte
    columns, a window holding no centre plane and a matrix of another size
    (``ValueError``, before any launch)."""
    import torch

    flat = torch.rand(4 * 8 * 8 + 1, device=device)
    odd = torch.rand(4, 3, 5, device=device)
    cases = {"misaligned view": lambda: SP.probe_scale(
        flat[1:].view(4, 8, 8), 2.0),
        "plane of 15": lambda: SP.probe_scale(odd, 2.0),
        "window of 2 halos": lambda: SP.probe_window_scale(
            torch.rand(12, 8, 8, device=device), 2.0, 32, 6),
        "matrix (8, 8) on 16 columns": lambda: SP.probe_block_matmul(
            torch.rand(2, 8, 16, device=device),
            torch.rand(8, 8, device=device))}
    before = SP.launch_counts()
    for what, call in cases.items():
        try:
            call()
        except ValueError:
            continue
        raise PhaseFailure("phase 49: %s not refused" % what)
    require(SP.launch_counts() == before, "phase 49: a refused call launched")
    return sorted(cases)


def probe_bits(SP, device, rng):
    """K1 and K2 bit for bit against their plain versions on
    :data:`PROBE_STREAM_SHAPES` (K1 at each zb of :data:`PROBE_STREAM_ZB`,
    factors 2, 1.0000001 and 1.0000001 in device memory; K2 the same at
    halo 0 and 6, one slot and two), K3 within :data:`PROBE_MATMUL_TOL` of
    :func:`probe_matmul_reference` on :data:`PROBE_MATMUL_SHAPES` (both
    sides, with and without ``trans``).
    Returns ``{kernel: max |Δ| on the probes' 256³ forms}`` and the number
    of cases."""
    import torch

    s_dev = torch.full((1, 1), SP.SCALE, dtype=torch.float32, device=device)
    err = {k: 0.0 for k in SP.KERNELS}
    cases = 0
    for shape in PROBE_STREAM_SHAPES:
        x = torch.as_tensor(rng.rand(*shape).astype(np.float32),
                            device=device)
        exts = {halo: torch.as_tensor(rng.rand(
            shape[0] + 2 * halo, *shape[1:]).astype(np.float32),
            device=device) for halo in (0, SP.R)}
        for zb in PROBE_STREAM_ZB:
            for s in (2.0, SP.SCALE, s_dev):
                got, want = SP.probe_scale(x, s, zb), \
                    SP.probe_scale_plain(x, s)
                require(torch.equal(got, want), "phase 49: probe_scale %s "
                        "zb %d s %s off its plain version" % (shape, zb, s))
                cases += 1
                for halo, ext in exts.items():
                    want = SP.probe_window_scale_plain(ext, s, halo)
                    for slots in (1, 2):
                        got = SP.probe_window_scale(ext, s, zb, halo, slots)
                        require(torch.equal(got, want),
                                "phase 49: probe_window_scale %s zb %d halo "
                                "%d slots %d s %s off its plain version"
                                % (shape, zb, halo, slots, s))
                        cases += 1
    for shape in PROBE_MATMUL_SHAPES:
        x = torch.as_tensor(rng.rand(*shape).astype(np.float32),
                            device=device)
        for side in SP.SIDES:
            k = shape[2] if side == "x" else shape[1]
            m = torch.as_tensor(rng.rand(k, k).astype(np.float32) - 0.5,
                                device=device)
            for trans in (False, True):
                for prec, key in (("HIGHEST", "probe_block_matmul"),
                                  ("DEFAULT", "probe_block_matmul[default]")):
                    ref = probe_matmul_reference(SP, x, m, side, prec, trans)
                    got = SP.probe_block_matmul(x, m, side, prec, trans)
                    delta = float((got.double() - ref.double()).abs().max())
                    rel = delta / float(ref.abs().max())
                    require(rel <= PROBE_MATMUL_TOL[prec],
                            "phase 49: probe_block_matmul %s %s side trans "
                            "%s: max |Δ| / max |ref| %.3g > %g"
                            % (shape, side, trans, rel,
                               PROBE_MATMUL_TOL[prec]))
                    if shape == SCALE_SHAPE:
                        err[key] = max(err[key], delta)
                    cases += 1
    return err, cases


def probe_mesh_run(SP, device, card):
    """The probes' run at 256³: every variant plain and on a real NCCL
    group of world size 1 (the group made and destroyed as phase 27's),
    the counts set to 0 just before and read just after. Each variant's
    probe-kernel launches each way equal its steps × the kernels a step;
    d1, d4, e5, diag3's apply1 and g3 launch the normal units they run.
    Returns the rows and the counts."""
    import torch

    from nsol_tpu_torch.parallel import distributed as dist
    from nsol_tpu_torch.parallel import make_space_mesh

    dist.initialize(coordinator_address="localhost:%d" % free_port(),
                    num_processes=1, process_id=0)
    try:
        mesh = make_space_mesh()
        require(mesh.group is not None and mesh.size == 1
                and mesh.device == device
                and torch.distributed.get_backend() == "nccl",
                "phase 49: mesh %r, backend %s" % (
                    mesh, torch.distributed.get_backend()))
        SP.reset_counts()
        rows = SP.run_probes(mesh=mesh, device=device)
        counts = SP.launch_counts()
    finally:
        torch.distributed.destroy_process_group()
    for r in rows:
        for side in ("plain", "mesh"):
            got = {k: r["launches"][side][k] for k in SP.KERNELS}
            want = {k: r["expect"].get(k, 0) for k in SP.KERNELS}
            require(got == want, "phase 49: %s %s launches %s, expected %s"
                    % (r["name"], side, got, want))
            for unit in r["units"]:
                require(r["launches"][side][unit] > 0, "phase 49: %s %s "
                        "launched no %s" % (r["name"], side, unit))
        print("phase 49 %-13s %-13s %-42s plain %.4f ms, mesh %.4f ms a %s "
              "(%d x %d) | %s" % (r["name"], r["script"], r["what"], r["ms"],
                                  r["mesh_ms"], r["per"], r["n"], r["inner"],
                                  card))
    for k in SP.KERNELS:
        require(counts[k] == 2 * sum(r["expect"].get(k, 0) for r in rows)
                and counts[k] > 0, "phase 49: %s launched %d times on the "
                "probes' run" % (k, counts[k]))
    return rows, counts


def run_probe_phase(device, card):
    """Phase 49: the shard probes (``csrc/probes.cu``,
    ``nsol_tpu_torch/parallel/shard_probe.py``), the counterparts of the 8
    Pallas kernels of ``benchmarks/shard_pallas_diag*.py``. The kernels'
    ptxas report; :func:`probe_bits` (K1 and K2 bit for bit, K3 within its
    tolerances); :func:`probe_refusals`; :func:`probe_mesh_run` (every
    variant d1-i3 at 256³ plain and on a NCCL group of world size 1, with
    its launches); each kernel's time at the probes' 256³ by CUDA events
    (a wrapper call) and ``torch.profiler`` (device), beside its plain
    version's, its library call's and its bound. Returns the kernels'
    ``kernels`` records."""
    import torch

    from nsol_tpu_torch.parallel import shard_probe as SP

    for kernel in PROBE_KERNELS:
        print("phase 49 ptxas %s: %s" % (kernel, kernel_ptxas(kernel, 256)
                                          or "cached"))
    rng = np.random.RandomState(49)
    err, cases = probe_bits(SP, device, rng)
    refused = probe_refusals(SP, device)
    print("phase 49 checks: %d cases (K1, K2 bit for bit; K3 HIGHEST "
          "within %g of the float64 product, DEFAULT within %g of its plain "
          "version, past %d products a sum of the float64 sum of the "
          "bf16-rounded inputs), refused: %s"
          % (cases, PROBE_MATMUL_TOL["HIGHEST"], PROBE_MATMUL_TOL["DEFAULT"],
             PROBE_PLAIN_MAX_K, ", ".join(refused)))
    lap("phase 49 checks")
    rows, counts = probe_mesh_run(SP, device, card)
    lap("phase 49 probes")

    n = int(np.prod(SCALE_SHAPE))
    x = torch.as_tensor(rng.rand(*SCALE_SHAPE).astype(np.float32),
                        device=device)
    ext = torch.as_tensor(rng.rand(SCALE_SHAPE[0] + 2 * SP.R,
                                   *SCALE_SHAPE[1:]).astype(np.float32),
                          device=device)
    m = torch.eye(SCALE_SHAPE[2], device=device) * 0.999999
    forms = {  # kernel, plain version, library call, bound
        "probe_scale": (
            lambda: SP.probe_scale(x, 2.0, SP.ZB),
            lambda: SP.probe_scale_plain(x, 2.0),
            lambda: torch.mul(x, 2.0), unit_bound("probe_scale", n)),
        "probe_window_scale": (
            lambda: SP.probe_window_scale(ext, SP.SCALE, SP.ZB, SP.R, 2),
            lambda: SP.probe_window_scale_plain(ext, SP.SCALE, SP.R),
            lambda: torch.mul(ext.narrow(0, SP.R, SCALE_SHAPE[0]), SP.SCALE),
            unit_bound("probe_window_scale", n))}
    # K2's own traffic beside its bound: each window of ZB + 2R planes read
    dma_ms, _ = unit_bound("probe_window_scale", n,
                           reads=(SP.ZB + 2 * SP.R) / SP.ZB)
    print("phase 49 probe_window_scale 256^3: its windows' bytes (%d planes "
          "a %d-plane block) at the memory rate %.4f ms | %s"
          % (SP.ZB + 2 * SP.R, SP.ZB, dma_ms, card))
    extra = {"probe_window_scale": {"window_bytes_ms": dma_ms}}
    entries = []
    for name, (kern, plain, lib, (b_ms, b_by)) in forms.items():
        ms, plain_ms = cuda_ms(kern, 50), cuda_ms(plain, 10)
        lib_ms, lib_dev = cuda_ms(lib, 50), device_ms_of(lib, 20)
        dev = device_ms_of(kern, 20, keys=("probe_",))
        print("phase 49 %s 256^3: kernel %.4f ms a wrapper call (device %s), "
              "plain %.4f, library %s (device %s), bound %.4f (%s) | %s"
              % (name, ms, ms_text(dev), plain_ms, "%.4f" % lib_ms,
                 ms_text(lib_dev), b_ms, b_by, card))
        entries.append({
            "name": name, "route": "cuda",
            "source": "nsol_tpu_torch/csrc/probes.cu",
            "replaces": PROBE_REPLACES[name], "launches": int(counts[name]),
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "device_ms": dev, "library_device_ms": lib_dev,
            **extra.get(name, {})})
    entries += probe_matmul_times(SP, x, m, err, counts, card)
    # the other forms the variants run, a wrapper call each
    for label, fn in (
            ("probe_window_scale halo 6, one slot",
             lambda: SP.probe_window_scale(ext, SP.SCALE, SP.ZB, SP.R, 1)),
            ("probe_window_scale halo 0, one slot",
             lambda: SP.probe_window_scale(x, SP.SCALE, SP.ZB, 0, 1)),
            ("probe_scale zb 8", lambda: SP.probe_scale(x, 2.0, 8))):
        print("phase 49 %s 256^3: %.4f ms a wrapper call | %s"
              % (label, cuda_ms(fn, 50), card))
    lap("phase 49 times")
    return entries


@contextlib.contextmanager
def matmul_precision(mode):
    """torch's float32 matmul precision ``mode`` inside the block, as it
    was after it."""
    import torch

    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(mode)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def probe_matmul_times(SP, x, m, err, counts, card):
    """K3's two kernels at the probes' 256³, each form of
    :data:`PROBE_MATMUL_FORMS`: the kernel's device ms (``torch.profiler``)
    and a wrapper call's (CUDA events), its plain version's, its library
    call's, its bound. The library call: "HIGHEST" ``torch.matmul`` in
    float32 (TF32 off); "DEFAULT" (float32 in, both rounded to bf16,
    float32 sums and out) ``torch.matmul`` at float32 matmul precision
    "medium", counted only where it holds to the plain version within
    :data:`PROBE_MATMUL_TOL` (TF32 inside misses it by ~1e-3), else none;
    beside it, as context, ``torch.mm`` of bf16 inputs with a float32
    output (x side), the cast of x to bf16, and ``torch.matmul`` of bf16
    inputs and output. The x side's numbers are the ``kernels`` record's;
    every form's are under its ``forms``."""
    import torch

    entries = []
    for prec, name in (("HIGHEST", "probe_block_matmul"),
                       ("DEFAULT", "probe_block_matmul[default]")):
        b_ms, b_by = probe_matmul_bound(tuple(x.shape), prec)
        forms = {}
        for side, trans in PROBE_MATMUL_FORMS:
            mm = m.T if trans else m

            def lib(mm=mm, side=side):
                return torch.matmul(x, mm) if side == "x" else \
                    torch.matmul(mm.T, x)

            def kern(side=side, trans=trans):
                return SP.probe_block_matmul(x, m, side, prec, trans)

            def plain(side=side, trans=trans):
                return SP.probe_block_matmul_plain(x, m, side, prec, trans)

            form = {"device_ms": device_ms_of(kern, 20, keys=("probe_",)),
                    "ms": cuda_ms(kern, 50), "plain_ms": cuda_ms(plain, 10)}
            context = {}
            if prec == "HIGHEST":
                form["library"] = "torch.matmul f32, TF32 off"
                form["library_ms"] = cuda_ms(lib, 50)
                form["library_device_ms"] = device_ms_of(lib, 20)
            else:
                ref = plain()
                with matmul_precision("medium"):
                    rel = float((lib().double() - ref.double()).abs().max()
                                / ref.double().abs().max())
                    counted = rel <= PROBE_MATMUL_TOL["DEFAULT"]
                    lib_ms = cuda_ms(lib, 50)
                    lib_dev = device_ms_of(lib, 20)
                form["library"] = "torch.matmul f32 at precision medium"
                form["library_ms"] = lib_ms if counted else None
                form["library_device_ms"] = lib_dev if counted else None
                form["library_rel"] = rel
                context["torch.matmul f32 at precision medium (%s the "
                        "plain version within %g, max |d| / max |ref| %.3g)"
                        % ("holds to" if counted else "misses",
                           PROBE_MATMUL_TOL["DEFAULT"], rel)] = lib_dev
                xb, mb = x.to(torch.bfloat16), mm.to(torch.bfloat16)
                if side == "x":
                    context["torch.mm bf16 in, f32 out"] = device_ms_of(
                        lambda: torch.mm(xb.view(-1, x.shape[2]), mb,
                                         out_dtype=torch.float32), 20)
                    context["torch.matmul bf16 in, bf16 out"] = device_ms_of(
                        lambda: torch.matmul(xb, mb), 20)
                context["x.to(bfloat16)"] = device_ms_of(
                    lambda: x.to(torch.bfloat16), 20)
                form["context_device_ms"] = context
            key = "%s%s" % (side, " trans" if trans else "")
            forms[key] = form
            print("phase 49 %s %s side trans %s 256^3: kernel device %s ms, "
                  "a wrapper call %.4f; plain %.4f; library (%s) %s, device "
                  "%s; bound %.4f (%s)%s | %s"
                  % (name, side, trans, ms_text(form["device_ms"]),
                     form["ms"], form["plain_ms"], form["library"],
                     "none" if form["library_ms"] is None
                     else "%.4f" % form["library_ms"],
                     ms_text(form["library_device_ms"]), b_ms, b_by,
                     "".join("; %s device %s" % (k, ms_text(v))
                             for k, v in context.items()), card))
        x_side = forms["x"]
        entries.append({
            "name": name, "route": "cuda",
            "source": "nsol_tpu_torch/csrc/probes.cu",
            "replaces": PROBE_REPLACES[name], "launches": int(counts[name]),
            "max_abs_err": err[name], "ms": x_side["ms"],
            "plain_ms": x_side["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": x_side["library_ms"],
            "device_ms": x_side["device_ms"],
            "library_device_ms": x_side["library_device_ms"],
            "forms": forms})
    return entries


#: the phase groups, in the order they run; ``--only`` picks some of them
GROUPS = ("admm", "pd", "robust", "units", "tikhonov", "study", "cli",
          "scale", "compact", "sharded", "compact_robust", "pd_surface",
          "volume", "volume_solves", "tail", "sweep", "engines", "batch",
          "persistent", "tik_persistent", "irls_persistent",
          "pd_persistent", "probes")
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


#: units whose kernel lives in another source than their group's
KERNEL_SOURCE = {"cg_direction": "nsol_tpu_torch/csrc/stream.cuh",
                 "admm_tail": "nsol_tpu_torch/csrc/admm_tail.cu",
                 "normal_apply_prepadded": "nsol_tpu_torch/csrc/tiled.cu",
                 "weighted_apply_prepadded": "nsol_tpu_torch/csrc/tiled.cu",
                 "tik_clip": "nsol_tpu_torch/csrc/stream.cuh"}


def kernel_entries(group, launches, err, times, n, taps, nd=3, batch=1,
                   ext=None, reads=None):
    """The ``kernels`` records of one group's units: launches on its main
    path, max |Δ| against the plain version, kernel / plain / library ms
    per call at ``n`` voxels (× ``batch`` images), the kernel's and the
    library call's device ms where the profiler measured them (the times'
    fourth and fifth entries), and the bound there (``taps``: the chain's
    stencil lengths, or a dict of them by unit;
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
        out.append({"name": name, "route": "cuda",
                    "source": KERNEL_SOURCE.get(name, source),
                    "replaces": tpu, "launches": int(launches[name]),
                    "max_abs_err": err[name], "ms": t[0], "plain_ms": t[1],
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": t[2] if len(t) > 2 else None})
        if len(t) > 3:
            out[-1].update(device_ms=t[3], library_device_ms=t[4])
        routed(out[-1], launches)
    return out


def main(argv=None):
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default=",".join(GROUPS),
                        help="comma-separated phase groups of %s to run "
                        "(for development; only the full run prints the "
                        "result line)" % (GROUPS,))
    parser.add_argument("--tail-bits", default=None, metavar="PATH",
                        help="phase 39: hold every admm_tail output bit for "
                        "bit to the digests a run of another package wrote "
                        "to PATH, or write them there where it is absent")
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
    from nsol_tpu_torch.ops.cuda import robust as R

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
            run_tikhonov_phase(device, card)
        lap("phase 17")
    if "study" in groups:
        study = run_admm_study_phase(device, card)
        lap("phase 18")
    if "cli" in groups:
        scale_cli = run_scale_cli_phase(device, card)
        lap("phase 19")
    # the slice's units, errors and times at the Lena shape (phase 16);
    # their launches on the default routes that still launch them, past the
    # persistent rules (every Lena solve and sweep takes one persistent
    # launch): admm_record on phase 18's 100³ robust solve with records,
    # tik_clip on phase 19's 256³ TK1L2 sweep
    if {"units", "study"} <= set(groups):
        kernels += kernel_entries("record", study["launches"], units["err"],
                                  units["times"], 256 ** 2,
                                  iso2.blur.lengths, nd=2)
    if {"units", "cli"} <= set(groups):
        kernels += kernel_entries("tikhonov", scale_cli["launches"],
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
    if "volume" in groups:
        vol = run_volume_phases(device, card)
    if "volume_solves" in groups:
        rows = run_volume_solves(device, card)
        if "volume" in groups and "entries" in vol:
            kernels += volume_entries(B, R, vol, rows)
    if "tail" in groups:
        # the two units' device ms at their main paths' shapes (64³, the
        # Man sweep's 64 × 1024² TVL2 float32)
        tail = run_tail_phase(device, card, args.tail_bits)
        for entry in kernels:
            if entry["name"] in tail:
                entry["device_ms"] = tail[entry["name"]]
    if "sweep" in groups:
        kernels += run_sweep_phase(device, card)
        lap("phase 40")
    if "engines" in groups:
        run_engine_phases(device, card)
    if "batch" in groups:
        run_batch_phase(device, card)
    if "persistent" in groups:
        kernels += run_persistent_phase(device, card)
    if "tik_persistent" in groups:
        kernels += run_tik_persistent_phase(device, card)
    if "irls_persistent" in groups:
        kernels += run_irls_persistent_phase(device, card)
    if "pd_persistent" in groups:
        kernels += run_pd_persistent_phase(device, card)
    if "probes" in groups:
        kernels += run_probe_phase(device, card)
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
