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

* :func:`tik_clip` — ``out = max(in, 0)``, a NaN kept as ``jnp.maximum``
  keeps it: the box projection of ``x0`` on entry (``fused.py:812``; the
  ADMM kernels do not clip there) and of the CG solution on exit
  (``fused.py:877``). Its kernel is ``csrc/stream.cuh``'s ``stream_clip``
  (16-byte accesses, one 4-voxel chunk a thread).

Where :func:`tikhonov_persistent_route` takes the shape (storage exact or
qf32, at most 2^20 voxels where no unit of that sequence marches: the Lena
and 64³ sweeps), the batch runs instead as one persistent cooperative
launch: the linear loss on ``csrc/tikhonov_persistent.cu``
(:func:`tik_persistent`'s count), a robust loss on
``csrc/irls_persistent.cu`` (:func:`~.robust.irls_persistent`'s count):
each unit of the sequence a phase between grid barriers, the batch's
configurations side by side, the same bits.

Semantics are ``tikhonov_solve``'s with ``b_reg = 0`` and bounds
``(0, ∞)``: linear loss → ``iter_max`` warm-started CG iterations on
``(AᵀA + α BᵀB) x = Aᵀb`` with the zero-guards of ``_cg_inkernel``;
robust loss → ``iter_max`` projected IRLS sweeps of ``irls_cg_iters``
masked-CG iterations (``b_reg``-ignoring quirk included).

``compact_dirs=True`` (with ``precision="high3"``, ``fused.py:783-797``):
every CG direction is rounded to bfloat16 where it is formed and stored
so — the linear CG's :data:`~.blocked.STORAGE` mode ``"qf32"``
(``cg_step``/``cg_update`` on a bfloat16 ``p``), the IRLS sweep's
:data:`~.robust.ROBUST_STORAGE` mode ``"dirs"`` —; ``r``, ``q``, ``x``, the
weights and every sum stay float32. The TPU's matrix-unit pass schedules
are not ported: the port computes their f32 result on the rounded
directions.
"""

import numpy as np
import torch

from nsol_tpu_torch.ops import conv as C
from nsol_tpu_torch.ops.cuda import blocked as B
from nsol_tpu_torch.ops.cuda import build
from nsol_tpu_torch.ops.cuda import record as Rec
from nsol_tpu_torch.ops.cuda import robust as R
from nsol_tpu_torch.ops.cuda import tiled as Z

__all__ = ["tik_clip", "tik_clip_plain", "make_fused_tikhonov_solver",
           "tik_persistent", "tikhonov_persistent_route",
           "persistent_barriers", "persistent_shape", "COUNTS",
           "PERSISTENT_SLOT", "UNITS", "PLAIN"]


def tik_clip_plain(out, x):
    """Plain version of :func:`tik_clip`."""
    tik_clip_plain.calls += 1
    out.copy_(torch.clamp(x, min=0.0))


tik_clip_plain.calls = 0


def tik_clip(out, x):
    """In place: ``out = max(x, 0)`` (``out`` may be ``x``); a NaN stays
    NaN. Contiguous float32 CUDA tensors of one shape, of any alignment."""
    if out.device.type == "cpu":
        return tik_clip_plain(out, x)
    name = "tik_clip"
    B.check_tensors(name, out.shape, out, x)
    lib = build.load()
    counts = build.new_counts(COUNTS)
    err = lib.nsol_tik_clip(build.tensor_ptr(out), build.tensor_ptr(x),
                            out.numel(), build.stream_ptr(out.device), counts)
    build.check(err, name)
    tik_clip.launches += counts[0]


tik_clip.launches = 0

#: this module's unit, in the order of ``csrc/tikhonov.cu``'s counts
UNITS = (tik_clip,)
PLAIN = (tik_clip_plain,)
#: ``csrc/tikhonov.cu``'s count slots: ``tik_clip``'s, then in
#: :data:`PERSISTENT_SLOT` the one launch of ``csrc/tikhonov_persistent.cu``
COUNTS = 2
PERSISTENT_SLOT = 1


def tikhonov_persistent_route(dims, blur, normal, storage="exact",
                              data_loss="linear"):
    """Whether the Tikhonov batch of a ``(Z, Y, X)`` volume (a 2-D image as
    ``(1, Y, X)``) runs on the card as one cooperative launch rather than
    as ``nsol_tikhonov_solve``'s launch sequence. The linear loss:
    ``csrc/tikhonov_persistent.cu`` where :func:`~.tiled.persistent_fits`
    takes the shape and storage (exact or qf32, at most 2^20 voxels, no
    unit of the sequence marching at the ``blur`` and ``normal`` taps'
    lengths, :func:`~.tiled.taps_lengths`). A robust loss:
    ``csrc/irls_persistent.cu``'s batch where
    :func:`~.tiled.irls_persistent_fits` takes the shape at the
    ``blur`` taps, storage exact, or qf32 (compact) as the sweep's
    ``"dirs"``. The shape decides, never a failure. Mirrors
    ``csrc/tikhonov_persistent.cu``'s ``nsol_tikhonov_persistent_route``."""
    if data_loss == "linear":
        return Z.persistent_fits(dims, blur, normal, storage)
    return storage in ("exact", "qf32") and Z.irls_persistent_fits(
        dims, blur, "dirs" if storage == "qf32" else "exact")


def persistent_barriers(nconf, iter_max, width):
    """Grid barriers one persistent batch takes: three for ``Aᵀb``; for
    each turn of ``width`` configurations side by side, three for
    the residual's chain and, each CG iteration, three for ``cg_step``'s
    chain and one after ``cg_update`` but the last (its reduce, which
    nothing reads, is not formed; the exit clip runs on each thread's own
    voxels). Every block forms its configuration's reduces itself, with no
    barrier after them."""
    turns = -(-int(nconf) // int(width))
    return 3 + turns * (3 + max(4 * int(iter_max) - 1, 0))


def persistent_shape(dims, blur, normal, nconf, storage="exact", reg="TK1"):
    """``(blocks an SM, grid, the launch sequence's blocks a volume, threads
    a block, configurations side by side)`` of the persistent batch of
    ``nconf`` configurations of ``dims`` at the taps' lengths ``blur``,
    ``normal`` on the current card: side by side as many as
    ``csrc/tikhonov_persistent.cu``'s ``kSideBySideBytes`` holds (their x
    and 6 volumes of scratch each), at least 1 and at most one a block, in
    turns of equal size (``batch_width`` there)."""
    out = (build.ctypes.c_int * 5)()
    build.check(build.load().nsol_tikhonov_persistent_shape(
        B.storage_ids(storage)[1], B.reg_id(reg), *blur, *normal, int(nconf),
        *dims, out), "tik_persistent")
    return tuple(out)


def tik_persistent(*args):
    """The C entry of the one-launch batch
    (``nsol_tikhonov_solve_persistent``), whose launches
    :func:`~.fused.launch_counts` reports as ``"tik_persistent"``."""
    counts = build.new_counts(COUNTS)
    err = build.load().nsol_tikhonov_solve_persistent(*args, counts)
    build.check(err, "tik_persistent")
    tik_persistent.launches += counts[PERSISTENT_SLOT]


tik_persistent.launches = 0

_LINEAR = (B.normal_apply, B.cg_step, B.cg_update)
_LINEAR_PLAIN = (B.normal_apply_plain, B.cg_step_plain, B.cg_update_plain)


def _tik_steps(units, st, b, x0, alphas, scales, reg, loss, iter_max,
               cg_iters, compact=False):
    """The batch of solves as a sequence of unit calls — the sequence
    ``nsol_tikhonov_solve`` enqueues in C. ``units``: ``(clip, linear
    units, robust units)``; ``compact``: bfloat16 CG directions. Returns
    ``(B, *shape)``."""
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
                                  st.inv_h2, alpha, first=(j == 0), reg=reg,
                                  storage="dirs" if compact else "exact")
                    update(xk, rk, p, q, scal)
                step(x, xk)
            continue
        r = normal_apply(x, st.normal, st.inv_h2, alpha, rhs=Atb, scal=scal,
                         reg=reg)
        p = None
        for j in range(iter_max):
            p, q = cg_step(r, p, scal, st.normal, st.inv_h2, alpha,
                           first=(j == 0), reg=reg,
                           storage="qf32" if compact else "exact")
            cg_update(x, r, p, q, scal)
        clip(x, x)
    return out


def _tik_persistent(st, b, x0, alphas, reg, iter_max, compact, dims, ta,
                    tn):
    """The linear batch as one cooperative launch: ``(B, *shape)``."""
    nconf = len(alphas)
    storage = "qf32" if compact else "exact"
    slots = persistent_shape(dims, ta.lengths, tn.lengths, nconf, storage,
                             reg)[4]
    out = torch.empty((nconf,) + tuple(b.shape), dtype=b.dtype,
                      device=b.device)
    atb = torch.empty_like(b)
    # r p0 p1 q t1 t2 of each configuration side by side; p0, p1 are the
    # CG directions
    p_dtype = B.BF16 if compact else b.dtype
    vols = [torch.empty((slots,) + tuple(b.shape),
                        dtype=p_dtype if k in (1, 2) else b.dtype,
                        device=b.device) for k in range(6)]
    partials = torch.empty(2 * slots * build.load().nsol_max_blocks(),
                           dtype=torch.float64, device=b.device)
    # the α from pinned memory, with no wait for the stream
    a_dev = torch.tensor([float(a) for a in alphas],
                         dtype=torch.float32).pin_memory().to(
                             b.device, non_blocking=True)
    tik_persistent(
        build.tensor_ptr(b), build.tensor_ptr(x0), build.tensor_ptr(out),
        build.tensor_ptr(atb), *[build.tensor_ptr(t) for t in vols],
        build.tensor_ptr(partials), build.tensor_ptr(a_dev), nconf, slots,
        build.tensor_ptr(ta.buf), *ta.lengths, build.tensor_ptr(tn.buf),
        *tn.lengths, *B.spacing3(st.inv_h2), B.reg_id(reg), int(iter_max),
        B.storage_ids(storage)[1], *dims, build.stream_ptr(b.device))
    return out


def _tik_irls_persistent(st, b, x0, alphas, scales, reg, loss, iter_max,
                         cg_iters, compact, dims, ta):
    """The robust batch as one cooperative launch: ``(B, *shape)``."""
    nconf = len(alphas)
    storage = "dirs" if compact else "exact"
    slots = R.persistent_shape(dims, ta.lengths, nconf, storage, reg)[4]
    out = torch.empty((nconf,) + tuple(b.shape), dtype=b.dtype,
                      device=b.device)
    # wts free r p0 p1 q xk t1 t2 of each configuration side by side; p0,
    # p1 are the CG directions
    p_dtype = B.BF16 if compact else b.dtype
    vols = [torch.empty((slots,) + tuple(b.shape),
                        dtype=p_dtype if k in (3, 4) else b.dtype,
                        device=b.device) for k in range(9)]
    partials = torch.empty(2 * slots * build.load().nsol_max_blocks(),
                           dtype=torch.float64, device=b.device)
    # the α and C from pinned memory, with no wait for the stream
    ac = torch.tensor([[float(a) for a in alphas], [float(c) for c in scales]],
                      dtype=torch.float32).pin_memory().to(
                          b.device, non_blocking=True)
    R.irls_persistent("nsol_irls_batch_persistent", [
        build.tensor_ptr(b), build.tensor_ptr(x0), build.tensor_ptr(out),
        *[build.tensor_ptr(t) for t in vols], build.tensor_ptr(partials),
        build.tensor_ptr(ac[0]), build.tensor_ptr(ac[1]), nconf, slots,
        build.tensor_ptr(ta.buf), *ta.lengths, *B.spacing3(st.inv_h2),
        B.reg_id(reg), Rec.LOSS_IDS.index(loss), int(iter_max),
        int(cg_iters), R.ROBUST_STORAGE.index(storage), *dims,
        build.stream_ptr(b.device)])
    return out


def _tik_solve_cuda(st, b, x0, alphas, scales, reg, loss, iter_max,
                    cg_iters, compact=False, route=None):
    """The batch on the card by ``route``: ``None`` takes
    :func:`tikhonov_persistent_route`'s, ``"sequence"``
    ``nsol_tikhonov_solve``'s launch sequence (the bit reference)."""
    name = "make_fused_tikhonov_solver"
    if route not in (None, "sequence"):
        raise ValueError("route must be None or 'sequence', got %r"
                         % (route,))
    dims = B.volume_dims(name, b)
    ta, tn = st.blur.as_volume(), st.normal.as_volume()
    B.check_tensors(name, b.shape, b, x0)
    if route is None and tikhonov_persistent_route(
            dims, ta.lengths, tn.lengths, "qf32" if compact else "exact",
            loss):
        if loss != "linear":
            return _tik_irls_persistent(st, b, x0, alphas, scales, reg, loss,
                                        iter_max, cg_iters, compact, dims,
                                        ta)
        return _tik_persistent(st, b, x0, alphas, reg, iter_max, compact,
                               dims, ta, tn)
    nconf = len(alphas)
    lib = build.load()
    out = torch.empty((nconf,) + tuple(b.shape), dtype=b.dtype,
                      device=b.device)
    robust = loss != "linear"
    # Aᵀb (linear), r p0 p1 q t1 t2, wts free xk (robust); p0, p1 are the
    # CG directions
    p_dtype = B.BF16 if compact else b.dtype
    vols = [torch.empty(b.shape, dtype=p_dtype if k in (2, 3) else b.dtype,
                        device=b.device) if need else None
            for k, need in enumerate([not robust] + [True] * 6
                                     + [robust] * 3)]
    # cg_step's and weighted_apply's march partials (vol_route)
    partials = Z.tiled_partials(b.device, dims)
    scal = B.new_scalars(b.device)
    a_host = (build.ctypes.c_float * nconf)(*[float(a) for a in alphas])
    c_host = (build.ctypes.c_float * nconf)(*[float(c) for c in scales])
    admm_counts = build.new_counts(B.COUNTS)
    robust_counts = build.new_counts(B.COUNTS)
    counts = build.new_counts(COUNTS)
    err = lib.nsol_tikhonov_solve(
        build.tensor_ptr(b), build.tensor_ptr(x0), build.tensor_ptr(out),
        *[build.tensor_ptr(t) for t in vols], build.tensor_ptr(partials),
        build.tensor_ptr(scal), build.tensor_ptr(ta.buf), *ta.lengths,
        build.tensor_ptr(tn.buf), *tn.lengths, *B.spacing3(st.inv_h2),
        B.reg_id(reg), Rec.LOSS_IDS.index(loss), a_host, c_host, nconf,
        int(iter_max), int(cg_iters), int(bool(compact)), *dims,
        build.stream_ptr(b.device),
        admm_counts, robust_counts, counts)
    build.check(err, name)
    for f, n in zip(_LINEAR, admm_counts):
        f.launches += n
    for f, n in zip(R.UNITS, robust_counts):
        f.launches += n
    B.count_marches(admm_counts, B.cg_step, B.normal_apply)
    B.count_marches(robust_counts, R.weighted_apply, R.blur_apply,
                    R.irls_head)
    tik_clip.launches += counts[0]
    return out


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
    cooperative launch of ``csrc/tikhonov_persistent.cu`` (linear) or
    ``csrc/irls_persistent.cu`` (robust) where
    :func:`tikhonov_persistent_route` takes the shape (``solve.route``),
    else as one ``nsol_tikhonov_solve`` call (2-D or 3-D float32); on the
    CPU as the plain versions (any float dtype). ``interpret=True`` and
    ``solve.plain`` run the plain versions on any device; on the card
    ``solve.sequence`` runs the launch sequence whatever the rule says.
    ``compact_dirs=True`` needs ``precision="high3"``, as in the reference
    (``ValueError`` otherwise): the CG directions in bfloat16 (module
    docstring); ``solve.compact`` says whether they are.
    """
    interpret, opt = B.check_options(tpu_options, ported=("compact_dirs",))
    compact = opt.get("compact_dirs", False)
    if compact not in (False, True):
        raise ValueError("the Tikhonov solve's compact_dirs is True or "
                         "False, got %r" % (compact,))
    if compact and tpu_options.get("precision") != "high3":
        raise ValueError("compact_dirs requires precision='high3'")
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

    def run(units, b, x0, alpha, data_loss_scale, cuda, route=None):
        check(b, x0)
        st = B.stencils_for(cache, shape, factors, spacing, b)
        alphas, scales, batched = batch(alpha, data_loss_scale)
        if cuda:
            out = _tik_solve_cuda(st, b, x0, alphas, scales, reg, data_loss,
                                  iter_max, irls_cg_iters, compact, route)
        else:
            out = _tik_steps(units, st, b, x0, alphas, scales, reg,
                             data_loss, iter_max, irls_cg_iters, compact)
        return out if batched else out[0]

    def solve(b, x0, alpha, data_loss_scale=1.0):
        return run((tik_clip, _LINEAR, R.UNITS), b, x0, alpha,
                   data_loss_scale, b.device.type != "cpu")

    def plain(b, x0, alpha, data_loss_scale=1.0):
        return run((tik_clip_plain, _LINEAR_PLAIN, R.PLAIN), b, x0, alpha,
                   data_loss_scale, False)

    def sequence(b, x0, alpha, data_loss_scale=1.0):
        return run(None, b, x0, alpha, data_loss_scale, True, "sequence")

    solve.plain = plain
    solve = B.plain_only(solve) if interpret else solve
    solve.sequence = sequence
    solve.compact = compact
    # the route a batch on the card takes
    solve.route = "persistent" if tikhonov_persistent_route(
        (1,) * (3 - len(shape)) + shape, *Z.taps_lengths(factors),
        "qf32" if compact else "exact", data_loss) else "sequence"
    return solve
