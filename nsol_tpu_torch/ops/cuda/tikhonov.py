"""The whole Tikhonov (TK0/TK1) deconvolution solve on the GPU: counterpart
of ``nsol_tpu/ops/pallas/fused.py::make_fused_tikhonov_solver`` (:716).

The TPU kernel holds one solve in VMEM and ``jax.vmap`` batches it over
the study's α × data-loss-scale grid. Here one C function in
``csrc/tikhonov.cu`` (``nsol_tikhonov_solve``) enqueues a batch of solves
back to back on the caller's stream, each with its own α (and ``C``)
passed in and a fresh device-side CG state, built from the units of
``csrc/admm.cu`` (:func:`~.blocked.normal_apply`, :func:`~.blocked.cg_step`,
:func:`~.blocked.cg_update`) and ``csrc/robust.cu`` (the IRLS sweep) with
``ρ := α`` and the regulariser ``BᵀB`` a template parameter (``"TK1"``:
the Laplacian ``DᵀD``; ``"TK0"``: the identity). It adds one kernel unit,
with its plain PyTorch version beside it and a launch counter:

* :func:`tik_clip` — ``out = max(in, 0)``: the box projection of ``x0`` on
  entry (``fused.py:812``; the ADMM kernels do not clip there) and of the
  CG solution on exit (``fused.py:877``).

Semantics are ``tikhonov_solve``'s with ``b_reg = 0`` and bounds
``(0, ∞)``: linear loss → ``iter_max`` warm-started CG iterations on
``(AᵀA + α BᵀB) x = Aᵀb`` with the zero-guards of ``_cg_inkernel``;
robust loss → ``iter_max`` projected IRLS sweeps of ``irls_cg_iters``
masked-CG iterations (``b_reg``-ignoring quirk included). The TPU-only
``precision``/``compact_dirs`` options raise.
"""

import numpy as np
import torch

from nsol_tpu_torch.ops import conv as C
from nsol_tpu_torch.ops.cuda import blocked as B
from nsol_tpu_torch.ops.cuda import build
from nsol_tpu_torch.ops.cuda import record as Rec
from nsol_tpu_torch.ops.cuda import robust as R

__all__ = ["tik_clip", "tik_clip_plain", "make_fused_tikhonov_solver",
           "UNITS", "PLAIN"]


def tik_clip_plain(out, x):
    """Plain version of :func:`tik_clip`."""
    tik_clip_plain.calls += 1
    out.copy_(torch.clamp(x, min=0.0))


tik_clip_plain.calls = 0


def tik_clip(out, x):
    """In place: ``out = max(x, 0)`` (``out`` may be ``x``)."""
    if out.device.type == "cpu":
        return tik_clip_plain(out, x)
    name = "tik_clip"
    B.check_tensors(name, out.shape, out, x)
    lib = build.load()
    counts = build.new_counts(1)
    err = lib.nsol_tik_clip(build.tensor_ptr(out), build.tensor_ptr(x),
                            out.numel(), build.stream_ptr(out.device), counts)
    build.check(err, name)
    tik_clip.launches += counts[0]


tik_clip.launches = 0

#: this module's unit, in the order of ``csrc/tikhonov.cu``'s counts
UNITS = (tik_clip,)
PLAIN = (tik_clip_plain,)

_LINEAR = (B.normal_apply, B.cg_step, B.cg_update)
_LINEAR_PLAIN = (B.normal_apply_plain, B.cg_step_plain, B.cg_update_plain)


def _tik_steps(units, st, b, x0, alphas, scales, reg, loss, iter_max,
               cg_iters):
    """The batch of solves as a sequence of unit calls — the sequence
    ``nsol_tikhonov_solve`` enqueues in C. ``units``: ``(clip, linear
    units, robust units)``. Returns ``(B, *shape)``."""
    clip, (normal_apply, cg_step, cg_update), robust = units
    out = torch.empty((len(alphas),) + tuple(b.shape), dtype=b.dtype,
                      device=b.device)
    if loss == "linear":
        Atb = normal_apply(b, st.blur, st.inv_h2, 0.0)  # A = Aᵀ
    for k, (alpha, scale) in enumerate(zip(alphas, scales)):
        scal = B.new_scalars(b.device)
        x = out[k]
        clip(x, x0)
        if loss != "linear":
            blur, head, wapply, step, update = robust
            for _ in range(iter_max):
                wts, y = head(x, b, st.blur, loss, scale)
                free, rk = blur(y, st.blur, st.inv_h2, x, alpha, scal=scal,
                                reg=reg)
                xk = torch.zeros_like(x)
                p = None
                for j in range(cg_iters):
                    p, q = wapply(rk, p, free, wts, scal, st.blur,
                                  st.inv_h2, alpha, first=(j == 0), reg=reg)
                    update(xk, rk, p, q, scal)
                step(x, xk)
            continue
        r = normal_apply(x, st.normal, st.inv_h2, alpha, rhs=Atb, scal=scal,
                         reg=reg)
        p = None
        for j in range(iter_max):
            p, q = cg_step(r, p, scal, st.normal, st.inv_h2, alpha,
                           first=(j == 0), reg=reg)
            cg_update(x, r, p, q, scal)
        clip(x, x)
    return out


def _tik_solve_cuda(st, b, x0, alphas, scales, reg, loss, iter_max,
                    cg_iters):
    name = "make_fused_tikhonov_solver"
    dims = B.volume_dims(name, b)
    B.check_tensors(name, b.shape, b, x0)
    nconf = len(alphas)
    lib = build.load()
    out = torch.empty((nconf,) + tuple(b.shape), dtype=b.dtype,
                      device=b.device)
    robust = loss != "linear"
    # Aᵀb (linear), r p0 p1 q t1 t2, wts free xk (robust)
    vols = [torch.empty_like(b) if need else None
            for need in [not robust] + [True] * 6 + [robust] * 3]
    partials = torch.empty(lib.nsol_max_blocks(), dtype=torch.float64,
                           device=b.device)
    scal = B.new_scalars(b.device)
    a_host = (build.ctypes.c_float * nconf)(*[float(a) for a in alphas])
    c_host = (build.ctypes.c_float * nconf)(*[float(c) for c in scales])
    ta, tn = st.blur.as_volume(), st.normal.as_volume()
    admm_counts, robust_counts = build.new_counts(5), build.new_counts(5)
    counts = build.new_counts(1)
    err = lib.nsol_tikhonov_solve(
        build.tensor_ptr(b), build.tensor_ptr(x0), build.tensor_ptr(out),
        *[build.tensor_ptr(t) for t in vols], build.tensor_ptr(partials),
        build.tensor_ptr(scal), build.tensor_ptr(ta.buf), *ta.lengths,
        build.tensor_ptr(tn.buf), *tn.lengths, *B.spacing3(st.inv_h2),
        B.reg_id(reg), Rec.LOSS_IDS.index(loss), a_host, c_host, nconf,
        int(iter_max), int(cg_iters), *dims, build.stream_ptr(b.device),
        admm_counts, robust_counts, counts)
    build.check(err, name)
    for f, n in zip(_LINEAR, admm_counts):
        f.launches += n
    for f, n in zip(R.UNITS, robust_counts):
        f.launches += n
    tik_clip.launches += counts[0]
    return out


_TPU_ONLY = ("precision", "compact_dirs")


def make_fused_tikhonov_solver(shape, cov, alpha_cut=3, spacing=None,
                               reg="TK1", iter_max=10, data_loss="linear",
                               irls_cg_iters=8, **tpu_options):
    """Build ``solve(b, x0, alpha, data_loss_scale=1.0)``: whole Tikhonov
    deconvolution solves ``min ½Σρ_C((Ax−b)²) + α/2 ‖Bx‖²`` on the box
    ``(0, ∞)`` (``fused.py:716``), ``B = I`` for ``reg="TK0"``, the stacked
    gradient for ``"TK1"``.

    ``alpha`` is a scalar (returns ``x`` of ``shape``) or a 1-D sequence of
    B values (returns ``(B, *shape)``, the counterpart of ``jax.vmap`` over
    the runtime α); ``data_loss_scale`` is a scalar or one value per α.
    Device and dtype follow ``b``: on CUDA the batch runs as one
    ``nsol_tikhonov_solve`` call (2-D or 3-D float32), on the CPU as the
    plain versions (any float dtype). ``solve.plain`` runs the plain
    versions on any device.
    """
    for key in tpu_options:
        if key not in _TPU_ONLY:
            raise TypeError("unexpected argument %r" % key)
        raise ValueError("%s schedules the TPU's matrix unit and has no "
                         "counterpart in the port (exact f32 only)" % key)
    if reg not in B.REGS:
        raise ValueError("reg must be TK0 or TK1")
    if data_loss not in Rec.LOSS_IDS:
        raise ValueError("unknown data loss %r" % (data_loss,))
    shape = tuple(shape)
    if len(shape) not in (2, 3):
        raise ValueError("fused Tikhonov solver supports 2-D/3-D volumes")
    factors = C.blur_factors(cov, alpha_cut, spacing)
    cache = {}

    def batch(alpha, data_loss_scale):
        if isinstance(alpha, torch.Tensor):
            alpha = alpha.detach().cpu().numpy()
        if isinstance(data_loss_scale, torch.Tensor):
            data_loss_scale = data_loss_scale.detach().cpu().numpy()
        batched = np.ndim(alpha) > 0
        alphas = [float(a) for a in np.atleast_1d(alpha)]
        scales = np.broadcast_to(np.asarray(data_loss_scale, np.float64),
                                 (len(alphas),))
        return alphas, [float(c) for c in scales], batched

    def check(b, x0):
        if x0.shape != b.shape or x0.dtype != b.dtype \
                or x0.device != b.device:
            raise ValueError("b and x0 differ in shape, dtype or device")

    def run(units, b, x0, alpha, data_loss_scale, cuda):
        check(b, x0)
        st = B.stencils_for(cache, shape, factors, spacing, b)
        alphas, scales, batched = batch(alpha, data_loss_scale)
        if cuda:
            out = _tik_solve_cuda(st, b, x0, alphas, scales, reg, data_loss,
                                  iter_max, irls_cg_iters)
        else:
            out = _tik_steps(units, st, b, x0, alphas, scales, reg,
                             data_loss, iter_max, irls_cg_iters)
        return out if batched else out[0]

    def solve(b, x0, alpha, data_loss_scale=1.0):
        return run((tik_clip, _LINEAR, R.UNITS), b, x0, alpha,
                   data_loss_scale, b.device.type != "cpu")

    def plain(b, x0, alpha, data_loss_scale=1.0):
        return run((tik_clip_plain, _LINEAR_PLAIN, R.PLAIN), b, x0, alpha,
                   data_loss_scale, False)

    solve.plain = plain
    return solve
