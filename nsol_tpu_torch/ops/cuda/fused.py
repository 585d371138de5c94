"""The whole ADMM TV-L2 deconvolution solve on the GPU: counterpart of
``nsol_tpu/ops/pallas/fused.py::make_fused_admm_solver`` (:382), linear
branch, on 2-D images and 3-D volumes, with the ``record=True`` L-curve
records (:624-638, 653-654) of :mod:`.record`.

The TPU kernel holds the whole solve in VMEM. On the H100 the ~16-volume
state does not fit one SM's shared memory, so the solve becomes a short
sequence of kernel launches that one C function in ``csrc/admm.cu``
enqueues on the caller's stream (``nsol_admm_solve``): ``Aᵀb`` once, then
per outer iteration the CG residual, ``iter_max`` × (:func:`cg_step`,
:func:`cg_update`) and :func:`admm_tail`. Every CG scalar stays on the
device: nothing syncs with the host inside a solve. A 2-D image runs as a
``(1, Y, X)`` volume with z taps ``[1]`` and ``1/h_z = 1/h_z² = 0``: every
z term is an exact zero.

This module adds the fourth kernel unit, :func:`admm_tail` (fused.py:645,
651-667): clip ``x ≥ 0``, ``t = ∇x/h + w``, grouped shrink at
``τ = α/ρ``, ``v``/``w`` updates, then the next
``rhs = Aᵀb + ρ·div(v − w)``. Two passes, because the divergence needs
neighbours of ``v − w``; bytes bound it (~11 volumes moved).

The reference's ``compact_dirs=True`` (with ``precision="high3"``) stores
each CG direction in bfloat16, as the same C sequence does under the
storage mode ``"qf32"`` of :data:`~.blocked.STORAGE` (:func:`linear_admm_solver`,
which also runs ``blocked_admm_solve``'s "step" and "sweep" modes). Its
MXU pass schedules (``precision``, ``blur_reorder``, ``diff_matmul``,
``pipelined_cg``) are accepted at the values whose result is the exact
f32 one (:func:`~.blocked.check_options`). A robust ``data_loss`` builds
the IRLS solve of :mod:`nsol_tpu_torch.ops.cuda.robust`
(``csrc/robust.cu``); its ``compact_dirs`` stores the inner CG's
direction in bfloat16 in the same way (the robust storage mode
``"dirs"``).

The whole primal-dual (Chambolle–Pock) denoising solve on the GPU:
counterpart of ``fused.py::make_fused_pd_denoise_solver`` (:957). The TPU
kernel runs every iteration inside one VMEM-resident program; here each
iteration is two kernel units, :func:`pd_dual` and :func:`pd_primal`, plus
:func:`pd_record` for the L-curve records, enqueued by one C function in
``csrc/pd.cu`` (``nsol_pd_solve``) with the step schedules precomputed on
the host (:func:`_pd_schedules`) and indexed on the device. Bytes bound
every unit; see the note at the top of ``csrc/pd.cu``. The batch over α is
a grid dimension (the counterpart of ``jax.vmap`` over the runtime α).
The TPU kernel's minor-axis difference matmuls (``_exact_bf16_matmul``,
``_banded_diff``, the exact1 pass) schedule the TPU's matrix unit and have
no counterpart: the port computes the plain f32 differences.

``compact=True`` (K10b.4, ``fused.py:1091-1167``) stores the PD state —
x, x̄ and every p_i — in bfloat16: each unit takes state tensors of
bfloat16 and computes in float32 on their exact upcasts, rounding where
the reference does (the fresh dual before the divergence reads it, the new
x before the records and the over-relaxation see it, x̄); the state
starts at ``round(x0)`` and the output is the upcast of the stored x. The
state's dtype is the storage flag of every unit and of its plain version.
"""

import numpy as np
import torch

from nsol_tpu_torch import interop
from nsol_tpu_torch.ops import conv as C
from nsol_tpu_torch.ops import grad as G
from nsol_tpu_torch.ops import losses
from nsol_tpu_torch.ops.prox import (
    HUBER_CONJ_GAMMA, prox_ell1_denoising, prox_ell2_denoising,
    prox_huber_conj, prox_tv_conj, vectorial_soft_threshold)
from nsol_tpu_torch.ops.cuda import blocked as B
from nsol_tpu_torch.ops.cuda import build
from nsol_tpu_torch.ops.cuda import record as Rec
from nsol_tpu_torch.ops.cuda import robust as R
from nsol_tpu_torch.ops.cuda import tikhonov as T
from nsol_tpu_torch.ops.cuda import tiled as Z
from nsol_tpu_torch.solvers.primal_dual import ALG_TYPES, step_schedules

__all__ = ["admm_tail", "admm_tail_plain", "make_fused_admm_solver",
           "pd_dual", "pd_dual_plain", "pd_primal", "pd_primal_plain",
           "pd_record", "pd_record_plain", "make_fused_pd_denoise_solver",
           "PD_TYPES", "ADMM_UNITS", "PD_UNITS", "ROBUST_UNITS",
           "RECORD_UNITS", "TIKHONOV_UNITS", "TILED_UNITS", "SWEEP_UNITS",
           "SHARDED_UNITS",
           "linear_admm_solver", "reset_counts",
           "launch_counts", "plain_counts"]


# ------------------------------------------------------------- admm_tail --

def admm_tail_plain(x, v, w, Atb, inv_h, tau, rho, init=False):
    """Plain version of :func:`admm_tail`."""
    admm_tail_plain.calls += 1
    ndim = x.ndim
    xc = x if init else torch.clamp(x, min=0.0)
    for i in range(ndim):
        g = G.forward_difference(xc, ndim - 1 - i) * inv_h[i]
        if init:
            v[i] = g
            w[i] = 0.0
        else:
            w[i] += g
    if not init:
        # w holds t = ∇x/h + w here
        v.copy_(vectorial_soft_threshold(w, tau))
        w.sub_(v)
        x.clamp_(min=0.0)
    div = None
    for i in range(ndim):
        t = G.forward_difference_adjoint(v[i] - w[i], ndim - 1 - i) \
            * inv_h[i]
        div = t if div is None else div + t
    return Atb + rho * div


admm_tail_plain.calls = 0


def admm_tail(x, v, w, Atb, inv_h, tau, rho, init=False):
    """ADMM prox/dual update and the next CG right-hand side.

    ``init``: ``v = ∇x/h``, ``w = 0`` and no clip (fused.py:579-580).
    Otherwise ``x = max(x, 0)``; ``t = ∇x/h + w``; ``v = shrink(t, τ)``;
    ``w = t − v``. Both forms return ``rhs = Aᵀb + ρ·Σ_k D_kᵀ(v_k − w_k)/h_k``.
    ``x``, ``v``, ``w`` are updated in place; ``v``/``w`` are stacked
    ``(d, *shape)``, x component first; ``inv_h`` is in (x, y, z) order.
    """
    if x.device.type == "cpu":
        return admm_tail_plain(x, v, w, Atb, inv_h, tau, rho, init)
    name = "admm_tail"
    dims = B.volume_dims(name, x)
    nd = x.dim()
    B.check_tensors(name, x.shape, x, Atb)
    B.check_tensors(name, (nd,) + tuple(x.shape), v, w, device=x.device)
    if nd == 2:  # the kernel's z component, an exact zero, in scratch
        pad = torch.zeros((1,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        v3, w3 = torch.cat([v, pad]), torch.cat([w, pad])
    else:
        v3, w3 = v, w
    lib = build.load()
    rhs = torch.empty_like(x)
    counts = build.new_counts(5)
    err = lib.nsol_admm_tail(
        build.tensor_ptr(x), build.tensor_ptr(v3), build.tensor_ptr(w3),
        build.tensor_ptr(Atb), build.tensor_ptr(rhs), *B.spacing3(inv_h),
        float(tau), float(rho), int(bool(init)), *dims,
        build.stream_ptr(x.device), counts)
    build.check(err, name)
    if nd == 2:
        v.copy_(v3[:2])
        w.copy_(w3[:2])
    admm_tail.launches += counts[3]
    return rhs


admm_tail.launches = 0

_ADMM_UNITS = (B.normal_apply, B.cg_step, B.cg_update, admm_tail)
_ADMM_PLAIN = (B.normal_apply_plain, B.cg_step_plain, B.cg_update_plain,
               admm_tail_plain)


# ----------------------------------------------------------------- solver --

def _solve_steps(steps, st, b, x0, alpha, rho, iterations, iter_max,
                 record=None, storage="exact", sweep=None):
    """The solve as a sequence of kernel-unit calls — the same sequence
    ``nsol_admm_solve`` enqueues in C. ``steps`` are the four units
    (the dispatching wrappers, or the plain versions); ``record`` is
    ``None`` or ``(record unit, loss, C)``; ``storage`` a
    :data:`~.blocked.STORAGE` mode; ``sweep`` ``None`` or the
    :func:`~.blocked.cg_sweep` unit (or its plain version), which then
    runs each CG iteration. Returns ``(x, reg, data)``, the float64
    records or None."""
    normal_apply, cg_step, cg_update, tail = steps
    r_io = B.STORAGE[storage][0]
    tau = float(np.float32(alpha) / np.float32(rho)) \
        if st.dtype == torch.float32 else alpha / rho
    scal = B.new_scalars(b.device)
    x = x0.clone()
    v = torch.empty((st.ndim,) + tuple(x.shape), dtype=x.dtype,
                    device=x.device)
    w = torch.empty_like(v)
    reg = data = None
    if record is not None:
        rec, loss, rec_scale = record
        reg, data = Rec.new_records(iterations + 1, b.device)
        rec(x, b, st.blur, st.inv_h, loss, rec_scale, reg, data, 0)
    Atb = normal_apply(b, st.blur, st.inv_h2, 0.0)  # A = Aᵀ
    rhs = tail(x, v, w, Atb, st.inv_h, tau, rho, init=True)
    for it in range(iterations):
        # bf16 state reads x as bf16 here; compact_dirs keeps it exact
        r = normal_apply(x, st.normal, st.inv_h2, rho, rhs=rhs, scal=scal,
                         io_dtype=r_io)
        p = None
        if sweep is not None:
            q = torch.empty_like(r)
            for k in range(iter_max):
                r, p = sweep(x, r, p, q, scal, st.normal, st.inv_h2, rho,
                             first=(k == 0))
            if iter_max:  # the last sweep's owed x += a·p'
                cg_update(x, None, p, None, scal)
        else:
            for k in range(iter_max):
                p, q = cg_step(r, p, scal, st.normal, st.inv_h2, rho,
                               first=(k == 0), storage=storage)
                cg_update(x, r, p, q, scal)
        rhs = tail(x, v, w, Atb, st.inv_h, tau, rho)
        if record is not None:
            rec(x, b, st.blur, st.inv_h, loss, rec_scale, reg, data, it + 1)
    return x, reg, data


def _solve_cuda(st, b, x0, alpha, rho, iterations, iter_max,
                record_dls=None, storage="exact", sweep=False):
    name = "make_fused_admm_solver"
    dims = B.volume_dims(name, b)
    B.check_tensors(name, b.shape, b, x0)
    (R, P, Q), sid = B.storage_ids(storage)
    lib = build.load()
    x = x0.clone()
    vols = [torch.empty(b.shape, dtype=dt, device=b.device)
            for dt in (torch.float32,) * 2 + (R, R, P, P, Q)
            + (torch.float32,) * 2]  # Aᵀb rhs r0 r1 p0 p1 q t1 t2
    v = torch.empty((3,) + tuple(b.shape), dtype=b.dtype, device=b.device)
    w = torch.empty_like(v)
    partials = torch.empty((4 if sweep else 1) * lib.nsol_max_blocks(),
                           dtype=torch.float64, device=b.device)
    scal = B.new_scalars(b.device)
    tau = float(np.float32(alpha) / np.float32(rho))
    reg = data = parts = None
    if record_dls is not None:
        reg, data = Rec.new_records(iterations + 1, b.device)
        parts = Rec.rec_partials(b.device)
    ta, tn = st.blur.as_volume(), st.normal.as_volume()
    counts = build.new_counts(6)
    err = lib.nsol_admm_solve(
        build.tensor_ptr(b), build.tensor_ptr(x), build.tensor_ptr(v),
        build.tensor_ptr(w), *[build.tensor_ptr(t) for t in vols],
        build.tensor_ptr(partials), build.tensor_ptr(scal),
        build.tensor_ptr(ta.buf), *ta.lengths,
        build.tensor_ptr(tn.buf), *tn.lengths,
        *B.spacing3(st.inv_h), *B.spacing3(st.inv_h2), tau, float(rho),
        int(iterations), int(iter_max), sid, int(bool(sweep)),
        build.tensor_ptr(reg), build.tensor_ptr(data),
        build.tensor_ptr(parts), Rec.LOSS_IDS.index("linear"),
        float(1.0 if record_dls is None else record_dls), *dims,
        build.stream_ptr(b.device), counts)
    build.check(err, name)
    for f, n in zip(_ADMM_UNITS + (Rec.admm_record, B.cg_sweep), counts):
        f.launches += n
    return x, reg, data


def linear_admm_solver(shape, cov, alpha_cut=3, spacing=None, iterations=10,
                       iter_max=10, storage="exact", sweep=False,
                       record=False):
    """Build the linear ADMM TV-L2 solve ``solve(b, x0, alpha, rho,
    data_loss_scale=1.0, record_dls=1.0)`` of :func:`make_fused_admm_solver`
    and of ``blocked_admm_solve``'s "step" and "sweep" modes: CG vectors
    stored as :data:`~.blocked.STORAGE` ``[storage]`` says, each CG
    iteration a ``cg_step`` + ``cg_update`` or (``sweep``, storage
    ``"exact"``/``"state"``) a ``cg_sweep``. ``solve.plain`` runs the
    plain versions."""
    B.storage_ids(storage)
    if sweep and storage not in ("exact", "state"):
        raise ValueError("the sweep stores r, p, q alike: storage 'exact' or "
                         "'state', got %r" % (storage,))
    shape = tuple(shape)
    if len(shape) not in (2, 3):
        raise ValueError("fused ADMM solver supports 2-D/3-D volumes")
    factors = C.blur_factors(cov, alpha_cut, spacing)
    cache = {}

    def result(out, dtype):
        x, reg, data = out
        if not record:
            return x
        return x, {"Reg": reg.to(dtype), "Data": data.to(dtype)}

    def stencils(t):
        return B.stencils_for(cache, shape, factors, spacing, t)

    def solve(b, x0, alpha, rho, data_loss_scale=1.0, record_dls=1.0):
        st = stencils(b)
        if b.device.type == "cpu":
            rec = (Rec.admm_record, "linear", record_dls) if record else None
            out = _solve_steps(_ADMM_UNITS, st, b, x0, alpha, rho,
                               iterations, iter_max, rec, storage,
                               B.cg_sweep if sweep else None)
        else:
            out = _solve_cuda(st, b, x0, alpha, rho, iterations, iter_max,
                              record_dls if record else None, storage, sweep)
        return result(out, b.dtype)

    def plain(b, x0, alpha, rho, data_loss_scale=1.0, record_dls=1.0):
        rec = (Rec.admm_record_plain, "linear", record_dls) if record \
            else None
        return result(_solve_steps(_ADMM_PLAIN, stencils(b), b, x0, alpha,
                                   rho, iterations, iter_max, rec, storage,
                                   B.cg_sweep_plain if sweep else None),
                      b.dtype)

    solve.plain = plain
    return solve


def make_fused_admm_solver(shape, cov, alpha_cut=3, spacing=None,
                           iterations=10, iter_max=10, dtype=np.float32,
                           precision="HIGHEST", data_loss="linear",
                           irls_cg_iters=8, record=False, interpret=False,
                           compact_dirs=False, pipelined_cg=False,
                           blur_reorder=True, diff_matmul=None):
    """Build ``solve(b, x0, alpha, rho, data_loss_scale=1.0,
    record_dls=1.0)`` (the reference's positional order, ``fused.py:382``).

    ``data_loss="linear"``: ``iterations`` ADMM steps, each with
    ``iter_max`` warm-started CG iterations on
    ``(AᵀA + ρDᵀD) x = Aᵀb + ρ·div(v − w)``, a non-negativity clip, and the
    grouped shrink at ``α/ρ`` — ``admm_solve(minimizer="cg")`` step for
    step, with the fused TPU kernel's guards; ``data_loss_scale`` is
    ignored. ``compact_dirs=True`` (with ``precision="high3"``, as the
    reference requires) rounds each CG direction ``p`` to bfloat16 and
    stores it so (``fused.py:329-379``); ``q``, ``r``, ``x`` and every sum
    stay float32 (the :data:`~.blocked.STORAGE` mode ``"qf32"``). A robust
    loss (huber/soft_l1/cauchy/arctan): ``admm_solve(minimizer="irls")``,
    ``iter_max`` MM sweeps of ``irls_cg_iters`` masked-CG iterations per
    step at the runtime ``data_loss_scale``
    (:func:`~nsol_tpu_torch.ops.cuda.robust.make_robust_solver`); its
    ``compact_dirs=True`` (``fused.py:583-622``, ``_cg_inkernel``'s
    ``round_dir``) rounds the inner CG's direction ``p = r`` and each
    ``p = r + β·p`` to bfloat16 and stores it so, the weights, ``q``,
    ``x``, ``r`` and every sum staying float32 (robust storage
    ``"dirs"``).

    ``record=True``: ``solve`` returns ``(x, {"Reg": ..., "Data": ...})``
    with ``(iterations+1,)`` rows, row 0 the ``x0`` state — ``Reg =
    TV(∇x)``, ``Data = ½Σρ_C(r²)``, ``r = Ax − b``, the solve's loss at the
    runtime scale ``record_dls`` (:func:`~nsol_tpu_torch.ops.cuda.record.
    admm_record`); accumulated in float64, returned in the solve's dtype.

    ``dtype`` (float32), ``precision`` (``None``, ``"HIGHEST"`` or
    ``"high3"``: each the exact f32 arithmetic), ``pipelined_cg``,
    ``blur_reorder`` and ``diff_matmul`` (their defaults only) go through
    :func:`~.blocked.check_options`; ``interpret=True`` runs the plain
    versions.

    Device and dtype follow ``b``: on CUDA the whole solve runs as the
    kernel sequence of ``csrc/admm.cu`` (linear) or ``csrc/robust.cu``
    (robust), 2-D or 3-D float32; on the CPU it runs the plain versions
    (2-D or 3-D, any float dtype). ``solve.plain`` runs the plain versions
    on any device — the reference the kernels are held against.
    ``alpha``/``rho`` are runtime scalars.
    """
    robust = data_loss != "linear"
    interpret, opt = B.check_options(
        dict(dtype=dtype, precision=precision, interpret=interpret,
             compact_dirs=compact_dirs, pipelined_cg=pipelined_cg,
             blur_reorder=blur_reorder, diff_matmul=diff_matmul),
        ported=("compact_dirs",), defaults={"blur_reorder": True})
    compact = opt.get("compact_dirs", False)
    if compact not in (False, True):
        raise ValueError("the fused solve's compact_dirs is True or False, "
                         "got %r" % (compact,))
    if compact and precision != "high3":
        raise ValueError("compact_dirs requires precision='high3'")
    shape = tuple(shape)
    if len(shape) not in (2, 3):
        raise ValueError("fused ADMM solver supports 2-D/3-D volumes")
    if robust:
        robust_solve = R._make_solver(
            shape, cov, alpha_cut, spacing, iterations, iter_max,
            irls_cg_iters, data_loss, True,
            storage="dirs" if compact else "exact")

        def run(fn, b, x0, alpha, rho, data_loss_scale=1.0, record_dls=1.0):
            x, reg, data = fn(b, x0, alpha, rho, data_loss_scale,
                              record_dls=record_dls)
            if not record:
                return x
            return x, {"Reg": reg.to(b.dtype), "Data": data.to(b.dtype)}

        def solve_robust(*args, **kwargs):
            return run(robust_solve.plain if interpret else robust_solve,
                       *args, **kwargs)

        solve_robust.plain = lambda *a, **k: run(robust_solve.plain, *a, **k)
        return solve_robust
    solve = linear_admm_solver(shape, cov, alpha_cut, spacing, iterations,
                               iter_max, "qf32" if compact else "exact",
                               record=record)
    return B.plain_only(solve) if interpret else solve


# ------------------------------------------------- primal-dual denoising --

#: reconstruction types of the denoising solve
PD_TYPES = ("TVL1", "TVL2", "HuberL1", "HuberL2")
#: rows of the schedule tensor (4, B, iterations)
SIGMA, TAU, FT, THETA = range(4)


#: ``(σ_t, τ_t, τ_t·λ, θ_t)`` for one α (``fused.py:918``): the generic
#: solver's schedules, so both solves step alike
_pd_schedules = step_schedules


def _sched_at(sched, row, t, nd):
    """Row ``row`` of the schedule at iteration ``t``, shaped to broadcast
    over a batch of ``nd``-D images."""
    return sched[row, :, t].reshape((-1,) + (1,) * nd)


def pd_dual_plain(x_mean, p, sched, t, inv_h, huber=False,
                  gamma=HUBER_CONJ_GAMMA):
    """Plain version of :func:`pd_dual`."""
    pd_dual_plain.calls += 1
    nd = p.shape[1]
    s = _sched_at(sched, SIGMA, t, nd)
    xm = x_mean.to(sched.dtype)  # the upcast of a bf16 state
    for i in range(nd):
        q = p[:, i].to(sched.dtype) + s * (
            G.forward_difference(xm, xm.dim() - 1 - i) * inv_h[i])
        # stored into a bf16 p: rounded before the divergence reads it
        p[:, i] = prox_huber_conj(q, s, gamma) if huber \
            else prox_tv_conj(q, s)


def pd_primal_plain(x, x_mean, p, b, sched, t, inv_h, ell1=False):
    """Plain version of :func:`pd_primal`."""
    pd_primal_plain.calls += 1
    nd = p.shape[1]
    xw, pw = x.to(b.dtype), p.to(b.dtype)
    div = None
    for i in range(nd):
        d = G.forward_difference_adjoint(pw[:, i], x.dim() - 1 - i) \
            * inv_h[i]
        div = d if div is None else div + d
    z = xw - _sched_at(sched, TAU, t, nd) * div
    prox = prox_ell1_denoising if ell1 else prox_ell2_denoising
    # the stored iterate (rounded for a bf16 state) is what x̄ sees
    x_new = prox(z, _sched_at(sched, FT, t, nd), b).to(x.dtype).to(b.dtype)
    x_mean.copy_(x_new + _sched_at(sched, THETA, t, nd) * (x_new - xw))
    x.copy_(x_new)


def pd_record_plain(x, b, reg, data, t, inv_h, ell1=False, huber=False,
                    gamma=HUBER_CONJ_GAMMA):
    """Plain version of :func:`pd_record`."""
    pd_record_plain.calls += 1
    x = x.to(b.dtype)
    g2 = None
    for i in range(x.dim() - 1):
        g = G.forward_difference(x, x.dim() - 1 - i) * inv_h[i]
        g2 = g * g if g2 is None else g2 + g * g
    r = losses.huber(g2, gamma=gamma) if huber else torch.sqrt(g2)
    d = x - b
    dv = torch.abs(d) if ell1 else d * d
    reg[:, t] = r.flatten(1).double().sum(1) * (0.5 if huber else 1.0)
    data[:, t] = dv.flatten(1).double().sum(1)


for _f in (pd_dual_plain, pd_primal_plain, pd_record_plain):
    _f.calls = 0


def _pd_dims(name, x, nd):
    """``(B, Z, Y, X)`` of a batch of ``nd``-D images ``(B, *shape)``; a
    2-D image runs with ``Z = 1`` and no z component (never as a
    ``(1, Y, X)`` volume: the zero-padded z difference would be −x)."""
    if nd not in (2, 3) or x.dim() != nd + 1:
        raise ValueError("%s: expected a batch of 2-D/3-D images, got shape "
                         "%s" % (name, tuple(x.shape)))
    nb = x.shape[0]
    if not 1 <= nb <= 65535:
        raise ValueError("%s: batch of %d, the kernel takes 1..65535"
                         % (name, nb))
    if nb * nd * x[0].numel() >= 2 ** 31:
        raise ValueError("%s: %s with %d dual components is too large for "
                         "the kernel's 32-bit indexing"
                         % (name, tuple(x.shape), nd))
    return (nb,) + (1,) * (3 - nd) + tuple(x.shape[1:])


def _state_dtype(name, *state):
    """The dtype of the PD state tensors (float32, or bfloat16 for the
    compact state), which must agree."""
    dtype = state[0].dtype
    if dtype not in (torch.float32, B.BF16) \
            or any(t.dtype != dtype for t in state):
        raise ValueError("%s: the state must be all float32 or all bfloat16, "
                         "got %s" % (name, [t.dtype for t in state]))
    return dtype


def _check_pd_consts(name, device, nb, sched=None, t=None, bufs=()):
    if sched is not None:
        if (sched.device != device or sched.dtype != torch.float32
                or not sched.is_contiguous() or sched.dim() != 3
                or tuple(sched.shape[:2]) != (4, nb)):
            raise ValueError("%s: sched must be a contiguous float32 (4, %d, "
                             "iterations) tensor on %s" % (name, nb, device))
        if t is not None and not 0 <= t < sched.shape[2]:
            raise ValueError("%s: iteration %d outside the schedule"
                             % (name, t))
    for buf in bufs:
        if (buf.device != device or buf.dtype != torch.float64
                or not buf.is_contiguous() or buf.dim() != 2
                or buf.shape[0] != nb):
            raise ValueError("%s: records must be contiguous float64 (%d, "
                             "iterations+1) tensors on %s"
                             % (name, nb, device))


def _inv_h3(inv_h):
    return tuple(float(h) for h in inv_h) + (0.0,) * (3 - len(inv_h))


def pd_dual(x_mean, p, sched, t, inv_h, huber=False, gamma=HUBER_CONJ_GAMMA):
    """Dual ascent and conjugate prox at iteration ``t``, in place:
    ``p_i ← proj(p_i + σ_t · D_i x̄ / h_i)`` with the componentwise
    ``proj(q) = q / max(1, |q|)`` (Huber types: ``q / (1 + σ_t γ)``
    first). ``x_mean`` is ``(B, *shape)``, ``p`` ``(B, ndim, *shape)`` x
    component first, both float32 or both bfloat16 (the compact state),
    ``sched`` the ``(4, B, iterations)`` schedules, ``inv_h`` ``1/h`` in
    (x, y[, z]) order."""
    if x_mean.device.type == "cpu":
        return pd_dual_plain(x_mean, p, sched, t, inv_h, huber, gamma)
    name = "pd_dual"
    nd = p.dim() - 2
    dims = _pd_dims(name, x_mean, nd)
    dtype = _state_dtype(name, x_mean, p)
    B.check_tensors(name, x_mean.shape, x_mean, dtype=dtype)
    B.check_tensors(name, (dims[0], nd) + tuple(x_mean.shape[1:]), p,
                    device=x_mean.device, dtype=dtype)
    _check_pd_consts(name, x_mean.device, dims[0], sched, t)
    lib = build.load()
    counts = build.new_counts(3)
    err = lib.nsol_pd_dual(
        build.tensor_ptr(x_mean), build.tensor_ptr(p),
        build.tensor_ptr(sched), int(t), sched.shape[2], int(bool(huber)),
        float(gamma), int(dtype == B.BF16), nd, *dims, *_inv_h3(inv_h),
        build.stream_ptr(x_mean.device), counts)
    build.check(err, name)
    pd_dual.launches += counts[0]


def pd_primal(x, x_mean, p, b, sched, t, inv_h, ell1=False):
    """Primal prox and over-relaxation at iteration ``t``, in place:
    ``z = x − τ_t·Σ_i D_iᵀ p_i / h_i``; ``x_new`` the ℓ1 shifted
    soft-threshold (``ell1``) or the ℓ2 closed form at ``τ_t·λ`` with
    ``x0 = b``; ``x̄ = x_new + θ_t (x_new − x)``; ``x = x_new``. ``b`` is
    one float32 image shared by the batch; the state ``x``, ``x̄``, ``p``
    float32 or bfloat16 (``x_new`` rounded to it before ``x̄`` is formed)."""
    if x.device.type == "cpu":
        return pd_primal_plain(x, x_mean, p, b, sched, t, inv_h, ell1)
    name = "pd_primal"
    nd = p.dim() - 2
    dims = _pd_dims(name, x, nd)
    dtype = _state_dtype(name, x, x_mean, p)
    B.check_tensors(name, x.shape, x, x_mean, dtype=dtype)
    B.check_tensors(name, x.shape[1:], b, device=x.device)
    B.check_tensors(name, (dims[0], nd) + tuple(x.shape[1:]), p,
                    device=x.device, dtype=dtype)
    _check_pd_consts(name, x.device, dims[0], sched, t)
    lib = build.load()
    counts = build.new_counts(3)
    err = lib.nsol_pd_primal(
        build.tensor_ptr(x), build.tensor_ptr(x_mean), build.tensor_ptr(p),
        build.tensor_ptr(b), build.tensor_ptr(sched), int(t),
        sched.shape[2], int(bool(ell1)), int(dtype == B.BF16), nd, *dims,
        *_inv_h3(inv_h), build.stream_ptr(x.device), counts)
    build.check(err, name)
    pd_primal.launches += counts[1]


def _pd_partials(device, dims, n):
    nparts = build.load().nsol_pd_grid(dims[0], n)
    return torch.empty(2 * dims[0] * nparts, dtype=torch.float64,
                       device=device)


def pd_record(x, b, reg, data, t, inv_h, ell1=False, huber=False,
              gamma=HUBER_CONJ_GAMMA):
    """L-curve records of the batch ``x`` into column ``t`` of the float64
    ``(B, iterations+1)`` buffers: ``Data`` = ``Σ|x−b|`` (``ell1``) or
    ``Σ(x−b)²``; ``Reg`` = ``Σ√g²`` (TV) or ``½Σ huber(g², γ)`` (``huber``)
    with ``g² = Σ_i (D_i x / h_i)²``; per-voxel terms in the working dtype,
    sums in float64. ``x`` is float32 or the bfloat16 state (measured on
    its upcast)."""
    if x.device.type == "cpu":
        return pd_record_plain(x, b, reg, data, t, inv_h, ell1, huber, gamma)
    name = "pd_record"
    nd = x.dim() - 1
    dims = _pd_dims(name, x, nd)
    dtype = _state_dtype(name, x)
    B.check_tensors(name, x.shape, x, dtype=dtype)
    B.check_tensors(name, x.shape[1:], b, device=x.device)
    _check_pd_consts(name, x.device, dims[0], bufs=(reg, data))
    if reg.shape != data.shape or not 0 <= t < reg.shape[1]:
        raise ValueError("%s: column %d outside the records %s"
                         % (name, t, tuple(reg.shape)))
    lib = build.load()
    counts = build.new_counts(3)
    err = lib.nsol_pd_record(
        build.tensor_ptr(x), build.tensor_ptr(b),
        build.tensor_ptr(_pd_partials(x.device, dims, x[0].numel())),
        build.tensor_ptr(reg), build.tensor_ptr(data), int(t), reg.shape[1],
        int(bool(ell1)), int(bool(huber)), float(gamma), int(dtype == B.BF16),
        nd, *dims, *_inv_h3(inv_h), build.stream_ptr(x.device), counts)
    build.check(err, name)
    pd_record.launches += counts[2]


for _f in (pd_dual, pd_primal, pd_record):
    _f.launches = 0

_PD_UNITS = (pd_dual, pd_primal, pd_record)
_PD_PLAIN = (pd_dual_plain, pd_primal_plain, pd_record_plain)


def _pd_steps(units, b, x0, sched, inv_h, ell1, huber, gamma, record,
              record_gamma, compact=False):
    """The solve as a sequence of unit calls — the sequence
    ``nsol_pd_solve`` enqueues in C. Returns ``(x, reg, data)`` batched,
    the state ``x`` as stored (bfloat16 with ``compact``: it starts at
    ``round(x0)``), the records float64 or None."""
    dual, primal, rec = units
    nb, iterations = sched.shape[1], sched.shape[2]
    shape = tuple(b.shape)
    dtype = B.BF16 if compact else b.dtype
    x = torch.empty((nb,) + shape, dtype=dtype, device=b.device)
    x.copy_(x0)
    x_mean = x.clone()
    p = torch.zeros((nb, len(shape)) + shape, dtype=dtype, device=b.device)
    reg = data = None
    if record:
        reg = torch.empty((nb, iterations + 1), dtype=torch.float64,
                          device=b.device)
        data = torch.empty_like(reg)
        rec(x, b, reg, data, 0, inv_h, ell1, huber, record_gamma)
    for t in range(iterations):
        dual(x_mean, p, sched, t, inv_h, huber, gamma)
        primal(x, x_mean, p, b, sched, t, inv_h, ell1)
        if record:
            rec(x, b, reg, data, t + 1, inv_h, ell1, huber, record_gamma)
    return x, reg, data


def _pd_solve_cuda(b, x0, sched, inv_h, ell1, huber, gamma, record,
                   record_gamma, compact=False):
    name = "make_fused_pd_denoise_solver"
    nb, iterations = sched.shape[1], sched.shape[2]
    shape = tuple(b.shape)
    nd = len(shape)
    B.check_tensors(name, shape, b, x0)
    dtype = B.BF16 if compact else b.dtype
    x0 = x0.to(dtype)  # the stored initial state, round(x0) if compact
    x = torch.empty((nb,) + shape, dtype=dtype, device=b.device)
    dims = _pd_dims(name, x, nd)
    _check_pd_consts(name, b.device, nb, sched)
    x_mean = torch.empty_like(x)
    p = torch.empty((nb, nd) + shape, dtype=dtype, device=b.device)
    reg = data = partials = None
    if record:
        reg = torch.empty((nb, iterations + 1), dtype=torch.float64,
                          device=b.device)
        data = torch.empty_like(reg)
        partials = _pd_partials(b.device, dims, b.numel())
    lib = build.load()
    counts = build.new_counts(3)
    err = lib.nsol_pd_solve(
        build.tensor_ptr(b), build.tensor_ptr(x0), build.tensor_ptr(x),
        build.tensor_ptr(x_mean), build.tensor_ptr(p), build.tensor_ptr(sched),
        build.tensor_ptr(partials), build.tensor_ptr(reg),
        build.tensor_ptr(data), int(bool(record)), float(record_gamma),
        int(bool(ell1)), int(bool(huber)), float(gamma), int(compact),
        iterations, nd, *dims, *_inv_h3(inv_h), build.stream_ptr(b.device),
        counts)
    build.check(err, name)
    for f, n in zip(_PD_UNITS, counts):
        f.launches += n
    return x, reg, data


def make_fused_pd_denoise_solver(shape, reconstruction_type,
                                 alg_type="ALG2", iterations=50,
                                 spacing=None, huber_gamma=HUBER_CONJ_GAMMA,
                                 record=False, compact=False, **options):
    """Build ``solve(b, x0, alpha, L2, record_gamma=huber_gamma)``: the
    whole Chambolle–Pock denoising solve of ``fused.py:957``.

    ``reconstruction_type``: TVL1/TVL2 (componentwise TV-conj projection,
    reference quirk kept) or HuberL1/HuberL2 (shrink by ``1/(1+σγ)`` with
    ``γ = huber_gamma`` first); L1 vs L2 picks the shifted soft-threshold
    or the closed-form ℓ2 primal prox with ``x0 = b``. ``alpha`` is a
    scalar (``x`` of ``shape`` is returned) or a 1-D sequence/tensor of B
    alphas (``(B, *shape)``; ``b`` and ``x0`` are shared by the batch, as
    ``jax.vmap`` over α does). ``L2`` is a scalar. The schedules are
    computed on the host per call, in the solve's dtype.

    ``record=True`` returns ``(x, {"Reg": ..., "Data": ...})`` with
    ``(iterations+1,)`` (or ``(B, iterations+1)``) rows, row 0 the x0
    state: ``Data`` is SAD for L1 and SSD for L2 types, ``Reg`` isotropic
    TV for TV types and ``½Σ huber(|∇x|², record_gamma)`` for Huber types;
    accumulated in float64, returned in the solve's dtype.

    ``compact=True`` (the reference's opt-in bf16 state, ``fused.py:
    1091-1167``): x, x̄ and p are stored in bfloat16 and every step
    computes in the solve's dtype on their exact upcasts, rounding where
    the reference does; the records measure the rounded iterate and the
    result is the upcast of the stored x.

    Device and dtype follow ``b``: on CUDA the solve runs the kernels of
    ``csrc/pd.cu`` (float32, 2-D or 3-D); on the CPU the plain versions.
    ``solve.plain`` runs the plain versions on any device, and
    ``solve.plain_steps(b, x0, sched, record_gamma)`` runs them on a given
    ``(4, B, iterations)`` schedule tensor (``interop.pd_schedules``),
    returning batched results.
    """
    if reconstruction_type not in PD_TYPES:
        raise ValueError("unknown reconstruction type '%s'"
                         % reconstruction_type)
    if alg_type not in ALG_TYPES:
        raise ValueError("alg_type must be one of ALG2/ALG2_AHMOD/ALG3")
    shape = tuple(shape)
    if len(shape) not in (2, 3):
        raise ValueError("fused PD solver supports 2-D/3-D volumes")
    if compact not in (False, True):
        raise ValueError("compact must be False or True, got %r"
                         % (compact,))
    interpret, _ = B.check_options(options)
    ell1 = reconstruction_type.endswith("L1")
    huber = reconstruction_type.startswith("Huber")
    s = G._spacing_array(spacing, len(shape))

    def inv_h(dtype):
        rnd = np.float32 if dtype == torch.float32 else np.float64
        return tuple(float(rnd(1.0 / si)) for si in s)

    def check(b, x0):
        for t in (b, x0):
            if tuple(t.shape) != shape:
                raise ValueError("input shape %s, solver built for %s"
                                 % (tuple(t.shape), shape))
        if x0.dtype != b.dtype or x0.device != b.device:
            raise ValueError("b and x0 differ in dtype or device")

    def schedules(b, alpha, L2):
        if isinstance(alpha, torch.Tensor):
            alpha = alpha.detach().cpu().numpy()
        batched = np.ndim(alpha) > 0
        if batched and np.ndim(alpha) != 1:
            raise ValueError("alpha must be a scalar or 1-D, got shape %s"
                             % (np.shape(alpha),))
        np_dtype = np.float32 if b.dtype == torch.float32 else np.float64
        rows = [_pd_schedules(float(a), float(L2), iterations, alg_type,
                              np_dtype) for a in np.atleast_1d(alpha)]
        sched = interop.pd_schedules(*(np.stack(c) for c in zip(*rows)),
                                     device=b.device, dtype=b.dtype)
        return sched, batched

    def result(x, reg, data, dtype, batched):
        x = x.to(dtype)  # the upcast of a compact state
        if not batched:
            x = x[0]
            reg, data = (None, None) if reg is None else (reg[0], data[0])
        if not record:
            return x
        return x, {"Reg": reg.to(dtype), "Data": data.to(dtype)}

    def run(units, b, x0, sched, record_gamma):
        return _pd_steps(units, b, x0, sched, inv_h(b.dtype), ell1, huber,
                         huber_gamma, record, record_gamma, compact)

    def solve(b, x0, alpha, L2, record_gamma=huber_gamma):
        check(b, x0)
        sched, batched = schedules(b, alpha, L2)
        if b.device.type == "cpu":
            out = run(_PD_UNITS, b, x0, sched, record_gamma)
        else:
            out = _pd_solve_cuda(b, x0, sched, inv_h(b.dtype), ell1, huber,
                                 huber_gamma, record, record_gamma, compact)
        return result(*out, b.dtype, batched)

    def plain(b, x0, alpha, L2, record_gamma=huber_gamma):
        check(b, x0)
        sched, batched = schedules(b, alpha, L2)
        return result(*run(_PD_PLAIN, b, x0, sched, record_gamma), b.dtype,
                      batched)

    def plain_steps(b, x0, sched, record_gamma=huber_gamma):
        check(b, x0)
        return result(*run(_PD_PLAIN, b, x0, sched, record_gamma), b.dtype,
                      True)

    solve.plain = plain
    solve.plain_steps = plain_steps
    if interpret:
        solve = B.plain_only(solve)
        solve.plain_steps = plain_steps
    return solve


# ----------------------------------------------------------------- counts --

#: kernel units of each path, by wrapper name
ADMM_UNITS = tuple(f.__name__ for f in _ADMM_UNITS)
PD_UNITS = tuple(f.__name__ for f in _PD_UNITS)
ROBUST_UNITS = tuple(f.__name__ for f in R.UNITS)
RECORD_UNITS = ("admm_record",)
#: the Tikhonov solve's own unit; it runs the ADMM and robust units too
TIKHONOV_UNITS = tuple(f.__name__ for f in T.UNITS)
#: the one-pass tiled units of the 512-wide-plane scale path
TILED_UNITS = tuple(f.__name__ for f in Z.UNITS)
#: the whole-CG-iteration unit of ``blocked_admm_solve(mode="sweep")``
SWEEP_UNITS = ("cg_sweep",)
#: the per-shard window units of the sharded path (``parallel/``)
_SHARDED = ((B.normal_apply_prepadded, B.normal_apply_prepadded_plain),
            (R.blur_apply_prepadded, R.blur_apply_prepadded_plain),
            (R.weighted_apply_prepadded, R.weighted_apply_prepadded_plain))
SHARDED_UNITS = tuple(f.__name__ for f, _ in _SHARDED)
_UNITS = {f.__name__: (f, p) for f, p in zip(
    _ADMM_UNITS + _PD_UNITS + R.UNITS + (Rec.admm_record,) + T.UNITS
    + Z.UNITS + (B.cg_sweep,) + tuple(f for f, _ in _SHARDED),
    _ADMM_PLAIN + _PD_PLAIN + R.PLAIN + (Rec.admm_record_plain,) + T.PLAIN
    + Z.PLAIN + (B.cg_sweep_plain,) + tuple(p for _, p in _SHARDED))}


def reset_counts():
    """Set every kernel's launch count and every plain version's call
    count to 0."""
    for f, p in _UNITS.values():
        f.launches = 0
        p.calls = 0


def launch_counts(names=None):
    """``{unit: launches}`` of the named units (all by default)."""
    return {k: _UNITS[k][0].launches for k in (names or _UNITS)}


def plain_counts(names=None):
    """``{unit_plain: calls}`` of the named units' plain versions."""
    return {_UNITS[k][1].__name__: _UNITS[k][1].calls
            for k in (names or _UNITS)}
