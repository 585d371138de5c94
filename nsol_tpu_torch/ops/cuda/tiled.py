"""One-pass (z, y)-tiled kernels of the 512-wide-plane scale path:
counterparts of the 2-D blocked TPU kernels of
``nsol_tpu/ops/pallas/blocked.py`` and ``nsol_tpu/ops/pallas/robust.py``.

Four kernel units (CUDA C++ in ``csrc/tiled.cu``), each with its plain
PyTorch version beside it and a launch counter on its wrapper:

* :func:`normal_apply_zy` — ``q = AᵀA v + ρ·DᵀD v``; replaces
  ``blocked.py::make_blocked_normal_operator_2d`` (:754). With ``rhs`` it
  returns the CG residual ``rhs − q`` and sets ``γ = ‖rhs − q‖²``,
  ``β = 0``; with ``scal`` alone it sets ``pq = Σ v·q`` and ``a = γ/pq``
  (guarded), the dot of the "apply" CG.
* :func:`cg_step_zy` — ``p' = r + β·p`` formed in the tile and written
  once, ``q = M p'``, ``pq = Σ p'·q`` and ``a = γ/pq``; replaces
  ``blocked.py::make_blocked_cg_step_2d`` (:878).
* :func:`blur_apply_zy` — ``A y``, with ``u`` ``A y + ρ·DᵀD u``; replaces
  ``robust.py::make_blocked_blur_operator_2d`` (:734). It also carries the
  IRLS gradient form of :func:`~.robust.blur_apply` (``scal``: the active
  set ``free``, ``rk = −free·g``, ``γ``) and the IRLS head of
  :func:`~.robust.irls_head` (``head=(b, loss, C)``: ``wts = ρ'_C(r²)``,
  ``y = wts·r`` for ``r = A x − b``), so a sweep enqueues no more launches
  than the per-axis route.
* :func:`weighted_apply_zy` — ``p' = r + β·p``, ``pf = free·p'``,
  ``q = free·(Aᵀ(wts·A pf) + ρ·DᵀD pf) + (p' − pf)``, ``pq``, ``a``;
  replaces ``robust.py::make_blocked_weighted_normal_operator_2d`` (:564).
  ``A pf`` lives only on the block's extended tile. It takes the masked
  CG's storage modes (:data:`~.robust.ROBUST_STORAGE`: bfloat16 ``p``,
  ``p'``; under ``"io"``, its ``io_dtype``, the weights read as bfloat16
  and the core rounded to bfloat16).

and :func:`cg_direction` (``p = r + β·p``), the "apply" CG's direction
update, which the JAX package leaves to XLA; its kernel is
``csrc/stream.cuh``'s ``stream_direction`` (16-byte accesses, one chunk of
voxels a thread). ``DᵀD`` is the zero-boundary Laplacian (the units have
no TK0 instance: the scale path is TV only).
``normal_apply_zy`` and ``cg_direction`` also store their vectors in
bfloat16 (``io_dtype``, the "apply" CG of ``blocked_admm_solve`` under
``compact_dirs`` or ``state_dtype``), their sums in float32.

Each unit makes one pass over halo-extended tiles: no intermediate volume
reaches device memory (see the note at the top of ``csrc/march.cuh``). The
single-stencil units share one march, whose window instances are
:func:`~.blocked.normal_apply_prepadded`'s and
:func:`~.robust.blur_apply_prepadded`'s tiled routes and whose
whole-volume instances are :func:`~.blocked.cg_step`'s (every storage
mode, TK1 and TK0), :func:`~.blocked.normal_apply`'s (float32 and
bfloat16, plain and residual, TK1 and TK0), :func:`~.robust.blur_apply`'s
(plain, with u, the gradient, TK1 and TK0) and :func:`~.robust.irls_head`'s
(every loss); the units here are their TV instances. The weighted unit
has a march of its own (two stencils, the second a plane behind the
first), whose window instance is
:func:`~.robust.weighted_apply_prepadded`'s tiled route and whose
whole-volume instance (every storage mode, masked or not, TK1 and TK0) is
:func:`~.robust.weighted_apply`'s. Each form of either equals the
three-pass units bit for bit. A block holds its windows and rings in at
most 227 KB of shared memory, so a wide blur does not fit:
:func:`route_fits` is the shape decision by which the solves take the
per-axis units instead, before any launch, and :func:`vol_route` the one
by which the whole-volume units take the march or the three-pass chain.
:func:`tile_z` mirrors the rule that sizes a march's z tile from the
volume and the card (``csrc/march.cuh``'s ``march_tile_z``).
Each wrapper runs the plain version only for CPU tensors; on a CUDA
tensor it launches the kernel (2-D or 3-D, contiguous, float32 or the
bfloat16 its storage names) or raises (``ValueError`` for stencils past
the shared memory).
"""

import numpy as np
import torch

from nsol_tpu_torch.ops.cuda import blocked as B
from nsol_tpu_torch.ops.cuda import build
from nsol_tpu_torch.ops.cuda import record as Rec
from nsol_tpu_torch.ops.cuda import robust as R
from nsol_tpu_torch.solvers.cg import guarded_ratio

__all__ = ["normal_apply_zy", "normal_apply_zy_plain", "cg_step_zy",
           "cg_step_zy_plain", "blur_apply_zy", "blur_apply_zy_plain",
           "weighted_apply_zy", "weighted_apply_zy_plain", "cg_direction",
           "cg_direction_plain", "tiled_partials", "smem_bytes",
           "require_fit", "route_fits", "vol_route", "march_fits",
           "halo_steps", "tile_z", "persistent_fits", "taps_lengths",
           "irls_persistent_fits", "PERSISTENT_STORAGE",
           "PERSISTENT_MAX_VOXELS", "IRLS_PERSISTENT_STORAGE",
           "UNITS", "PLAIN"]


# ------------------------------------------------------------ plain forms --
# The per-axis units' plain versions compute the same functions; these keep
# their own call counts and add the dot and head forms.

@B.counted
def normal_apply_zy_plain(v, taps, inv_h2, rho, rhs=None, scal=None,
                          io_dtype=None, p_dtype=None):
    """Plain version of :func:`normal_apply_zy`."""
    q = B.normal_apply_plain.__wrapped__(v, taps, inv_h2, rho, rhs, scal,
                                         io_dtype=io_dtype)
    if rhs is not None:
        return q if p_dtype is None else (q, q.to(p_dtype, copy=True))
    if scal is not None:
        cd = taps.buf.dtype
        pq = torch.sum(v.to(cd) * q.to(cd)).to(scal.dtype)
        scal[B.PQ] = pq
        scal[B.A] = guarded_ratio(scal[B.GAMMA], pq)
    return q


#: plain version of :func:`cg_step_zy`
cg_step_zy_plain = B.counted(B.cg_step_plain.__wrapped__, "cg_step_zy_plain")


@B.counted
def blur_apply_zy_plain(y, taps, inv_h2, u=None, rho=0.0, scal=None,
                        head=None):
    """Plain version of :func:`blur_apply_zy`."""
    if head is None:
        return R.blur_apply_plain.__wrapped__(y, taps, inv_h2, u, rho, scal)
    b, loss, scale = head
    return R.irls_head_plain.__wrapped__(y, b, taps, loss, scale)


#: plain version of :func:`weighted_apply_zy`
weighted_apply_zy_plain = B.counted(R.weighted_apply_plain.__wrapped__,
                                    "weighted_apply_zy_plain")


@B.counted
def cg_direction_plain(p, r, scal, q=None):
    """Plain version of :func:`cg_direction` (updates ``p``, and with
    ``q`` ``r``, in place)."""
    cd = torch.promote_types(r.dtype, torch.float32)
    rw = r.to(cd)
    if q is not None:
        rw = rw - scal[B.A].to(cd) * q.to(cd)
        r.copy_(rw)
    p.copy_(rw + scal[B.BETA].to(cd) * p.to(cd))


# ---------------------------------------------------------- shared memory --

#: ``csrc/march.cuh``'s output tile (kTileY, kTileX) and the most shared
#: memory a block may take (kMaxSmem)
TILE_Y, TILE_X, MAX_SMEM = 16, 32, 232448
_OUT_N = TILE_Y * TILE_X
_RAW_N = (TILE_Y + 2) * (TILE_X + 2)


def _up(v, m):
    return -(-v // m) * m


def smem_bytes(lengths, nin=1, lap=True, weighted=False, two_byte=False,
               res=False):
    """Bytes of shared memory one block takes for stencils of lengths
    ``(kz, ky, kx)``: ``weighted_apply_zy``'s (``weighted``), or a
    single-stencil unit's over ``nin`` input windows with or without the
    Laplacian's ring (``two_byte``: a bfloat16 window among two or three,
    whose x margin is 16 bytes of bfloat16) and with or without the
    sweep's r' ring (``res``: a plane of the tile a step of the raw
    ring), in the march's instance with runtime-length taps (the
    larger) — ``csrc/march.cuh``'s ``weighted_geo`` / ``stencil_smem``,
    which ``nsol_tiled_smem`` returns (without ``res``)."""
    kz, ky, kx = lengths
    hz, hy, hx = (max(k // 2, 1) for k in lengths)
    taps = sum(_up(k, 4) for k in lengths)
    if weighted:
        # the runtime-length instance: tables, the r, p and free windows
        # (one buffer, halo 2h, plain margins) and pf on the window, the
        # x-blurred window rows, s on the extended tile (halo h) and its
        # x-blurred rows, the two z rings and the raw ring of pf (two
        # planes more than the z reach: the next plane's pf is formed
        # while the second stage runs a step behind the first)
        wy, wx = TILE_Y + 4 * hy, TILE_X + 4 * hx
        ey, ex = TILE_Y + 2 * hy, TILE_X + 2 * hx
        depth = hz - kz // 2 + kz
        words = (taps + _up(wy + wx, 4) + 4 * wy * wx + wy * ex + ey * ex
                 + ey * TILE_X + depth * (ey * ex + _OUT_N)
                 + (2 * hz + 4) * _RAW_N)
    else:
        # the window's x margin rounds the halo up to 16 bytes of the input
        # (8 values for one input, which may be bfloat16, and for a
        # bfloat16 one of two; 4 for two float ones); each axis's taps and
        # the tables are 16-byte aligned
        margin = 8 if nin == 1 or two_byte else 4
        wy, wx = TILE_Y + 2 * hy, TILE_X + 2 * _up(hx, margin)
        words = (taps + _up(wy + wx, 4)
                 + 2 * nin * wy * wx + wy * TILE_X + (2 * hz + 1) * _OUT_N
                 + (hz + 2) * _RAW_N * bool(lap) + (hz + 2) * _OUT_N * bool(res))
    return 4 * words


def require_fit(name, lengths, **form):
    """Raise ``ValueError`` unless a block of ``name`` holds stencils of
    ``lengths`` in the form ``form`` (:func:`smem_bytes`)."""
    need = smem_bytes(lengths, **form)
    if need > MAX_SMEM:
        raise ValueError(
            "%s: stencils of lengths %s take %d bytes of shared memory a "
            "block, past the %d of the tiled kernel; the per-axis units "
            "take them" % (name, tuple(lengths), need, MAX_SMEM))


#: the stencil forms each route's tiled units launch: (which taps, input
#: windows, Laplacian, weighted)
_ROUTE_FORMS = {
    "apply": (("normal", 1, True, False), ("blur", 1, False, False)),
    "step2d": (("normal", 2, True, False), ("blur", 1, False, False)),
    "robust": (("blur", 2, True, False), ("blur", 1, True, True)),
}


def route_fits(factors, route):
    """Whether every tiled unit of ``route`` (``"apply"``/``"step2d"``, the
    linear CG's, or ``"robust"``, the IRLS sweep's) holds the stencils of
    the per-axis blur ``factors`` in a block's shared memory: the shape
    decision the solves make before any launch, as the JAX package picks
    its 1-D kernels where its 2-D ones do not fit."""
    blur = tuple(len(f) for f in factors)
    taps = {"blur": blur, "normal": tuple(2 * k - 1 for k in blur)}
    return all(smem_bytes(taps[t], nin, lap, weighted) <= MAX_SMEM
               for t, nin, lap, weighted in _ROUTE_FORMS[route])


#: the whole-volume units :func:`vol_route` routes, by the index
#: ``csrc/stencil.cuh``'s VolUnit gives them, and the C entries' routes
#: (its Route enum: the solves take "rule" inside the C code, the
#: wrappers pass the route they computed)
VOL_UNITS = ("cg_step", "weighted_apply", "normal_apply", "blur_apply",
             "irls_head", "cg_sweep")
ROUTES = ("rule", "chain", "march")
#: the fewest voxels (exclusive) a whole-volume unit marches over: past
#: the fused solves' fit (16 volumes in 64 MiB) for ``cg_step``,
#: ``weighted_apply`` and ``cg_sweep``; past 2^19 for the lighter ``normal_apply``,
#: ``blur_apply`` and ``irls_head``, whose marches beat their chains from
#: 88³ (not at 80³) on the H100 (``csrc/march.cuh``'s ``vol_min_voxels``)
MARCH_MIN_VOXELS = 1 << 20
VOL_MIN_VOXELS = {"cg_step": MARCH_MIN_VOXELS,
                  "weighted_apply": MARCH_MIN_VOXELS,
                  "normal_apply": 1 << 19, "blur_apply": 1 << 19,
                  "irls_head": 1 << 19, "cg_sweep": MARCH_MIN_VOXELS}
#: the form of each unit's march whose block :func:`march_fits` measures
#: (its largest, so that every storage mode and form of a unit takes one
#: route): ``cg_step``'s with bfloat16 margins, ``blur_apply``'s with
#: ``u`` (the gradient's), ``irls_head``'s one window without the
#: Laplacian, ``cg_sweep``'s three windows (r, q, p) with bfloat16 margins
#: and its r' ring — ``csrc/march.cuh``'s ``vol_smem``
_VOL_FORMS = {"cg_step": dict(nin=2, two_byte=True),
              "weighted_apply": dict(weighted=True),
              "normal_apply": dict(nin=1),
              "blur_apply": dict(nin=2),
              "irls_head": dict(nin=1, lap=False),
              "cg_sweep": dict(nin=3, two_byte=True, res=True)}


#: the most steps a block of each unit's march may take a plane it
#: writes, ``(Z + halo steps) / Z``, as ``(num, den)``: 2.5, or 4 for the
#: one-window ``normal_apply`` and ``irls_head``; ``cg_sweep`` takes
#: ``cg_step``'s (``csrc/march.cuh``'s ``vol_steps``)
VOL_STEPS = {"cg_step": (5, 2), "weighted_apply": (5, 2),
             "normal_apply": (4, 1), "blur_apply": (5, 2),
             "irls_head": (4, 1), "cg_sweep": (5, 2)}


def vol_route(unit, lengths, dims):
    """``"march"`` or ``"chain"``: how the whole-volume ``unit``
    (:data:`VOL_UNITS`) runs on the card at the taps' ``lengths`` (the
    normal taps of ``cg_step``, ``cg_sweep`` and ``normal_apply`` — or the
    blur taps of its ``Aᵀb`` form —, the blur taps of ``weighted_apply``,
    ``blur_apply`` and ``irls_head``, as ``(kz, ky, kx)``) on a volume of
    ``dims`` ``(Z, Y, X)`` — the march on a volume of more than
    :data:`VOL_MIN_VOXELS` voxels deep enough that a block takes at most
    :data:`VOL_STEPS` steps a plane it writes (its :func:`halo_steps`
    beside its planes: at σ = 1, ``Z >= 8`` for ``cg_step`` and
    ``cg_sweep``, 9 for
    ``weighted_apply``, 4 for ``normal_apply`` and ``blur_apply``, 2 for
    ``irls_head``; no 2-D view) where a block's shared memory holds the
    taps (:func:`march_fits`), else the three-pass chain, which took
    half the march's time at 64³ and on a 256² image and less than it on
    the thinnest stacks (PERF.md). Mirrors ``csrc/march.cuh``'s
    ``vol_route`` (``nsol_vol_route``)."""
    Z, Y, X = dims
    fits = march_fits(unit, lengths)
    num, den = VOL_STEPS[unit]
    deep = (Z + halo_steps(lengths[0], unit == "weighted_apply")) * den \
        <= num * Z
    return "march" if fits and deep and Z * Y * X > VOL_MIN_VOXELS[unit] \
        else "chain"


#: the storage modes of :data:`~.blocked.STORAGE` the persistent solves run
#: (``csrc/admm_persistent.cu``, ``csrc/tikhonov_persistent.cu``), and the
#: most voxels the routes of every persistent solve take
#: (``csrc/persistent.cuh``'s ``kPersistentMaxVoxels``)
PERSISTENT_STORAGE = ("exact", "qf32")
PERSISTENT_MAX_VOXELS = 1 << 20


def persistent_fits(dims, blur, normal, storage):
    """Whether a persistent solve runs the linear CG's launch sequence on a
    ``(Z, Y, X)`` volume (a 2-D image as ``(1, Y, X)``): storage in
    :data:`PERSISTENT_STORAGE`, at most :data:`PERSISTENT_MAX_VOXELS`
    voxels, where no unit of the sequence takes its march
    (:func:`vol_route` of ``Aᵀb``'s ``normal_apply`` at the ``blur`` taps'
    lengths, the residual's at the ``normal`` taps' and ``cg_step``'s):
    the kernels give the chain's bits, whose partial sums a march would not
    give. The shape decides, never a failure. Mirrors
    ``csrc/admm_persistent.cu``'s ``nsol_admm_persistent_route`` without
    the sweep."""
    if storage not in PERSISTENT_STORAGE:
        return False
    if int(np.prod(dims)) > PERSISTENT_MAX_VOXELS:
        return False
    return all(vol_route(unit, tuple(lengths), tuple(dims)) == "chain"
               for unit, lengths in (("normal_apply", blur),
                                     ("normal_apply", normal),
                                     ("cg_step", normal)))


#: the :data:`~.robust.ROBUST_STORAGE` modes the persistent IRLS sweep runs
#: (``csrc/irls_persistent.cu``)
IRLS_PERSISTENT_STORAGE = ("exact", "dirs")


def irls_persistent_fits(dims, blur, storage):
    """Whether the persistent IRLS sweep runs the robust solve's launch
    sequence on a ``(Z, Y, X)`` volume (a 2-D image as ``(1, Y, X)``):
    storage in :data:`IRLS_PERSISTENT_STORAGE`, at most
    :data:`PERSISTENT_MAX_VOXELS` voxels, where none of the sweep's
    ``irls_head``, ``blur_apply`` or ``weighted_apply`` takes its march
    (:func:`vol_route` at the ``blur`` taps' lengths): the kernel gives the
    chain's bits, whose partial sums a march would not give. The shape
    decides, never a failure. Mirrors ``csrc/irls_persistent.cu``'s
    ``nsol_robust_persistent_route``."""
    if storage not in IRLS_PERSISTENT_STORAGE:
        return False
    if int(np.prod(dims)) > PERSISTENT_MAX_VOXELS:
        return False
    return all(vol_route(unit, tuple(blur), tuple(dims)) == "chain"
               for unit in ("irls_head", "blur_apply", "weighted_apply"))


def taps_lengths(factors):
    """``(blur, normal)``: the lengths ``(kz, ky, kx)`` of a separable
    blur's taps and of its self-correlated normal taps, as the kernels take
    them (a 2-D image's with the z tap ``[1]``)."""
    pad = (1,) * (3 - len(factors))
    return (pad + tuple(len(f) for f in factors),
            pad + tuple(2 * len(f) - 1 for f in factors))


def march_fits(unit, lengths):
    """Whether a block of the whole-volume ``unit``'s march
    (:data:`VOL_UNITS`) holds taps of ``lengths`` in its shared memory, in
    the unit's largest form (:func:`smem_bytes` of the runtime-length
    instance), as :func:`vol_route` measures it."""
    if unit not in _VOL_FORMS:
        raise ValueError("unit must be one of %s, got %r" % (VOL_UNITS, unit))
    return smem_bytes(lengths, **_VOL_FORMS[unit]) <= MAX_SMEM


#: ``csrc/march.cuh``'s z tiles: the longest (kTileZ; twice it for the
#: weighted march), the shortest (kMinTileZ), and the blocks an SM holds at
#: once (kStencilResident, kWeightedResident; the sweep's instance of the
#: single-stencil march kSweepResident, by its shared memory)
TILE_Z, MIN_TILE_Z = 128, 8
RESIDENT = {False: 4, True: 2}
SWEEP_RESIDENT = 3


def halo_steps(kz, weighted):
    """Steps of z halo a block of the single-stencil march (``2h``) or of
    the weighted one (``weighted``: ``4h + 1``) takes beside its own
    planes at z taps ``kz`` (``h = max(kz // 2, 1)``) — ``csrc/march.cuh``'s
    ``march_halo_steps``."""
    h = max(kz // 2, 1)
    return 4 * h + 1 if weighted else 2 * h


def tile_z(dims, kz, weighted, sms, resident=None):
    """Planes a block of the single-stencil march (z taps ``kz``) or of
    the weighted one (``weighted``, blur z taps ``kz``) marches through on
    a volume of ``dims`` ``(Z, Y, X)`` on a card of ``sms`` SMs: of the
    longest tile, half of it, ..., :data:`MIN_TILE_Z` planes, the one with
    the least (waves of its grid) × (steps a block), a wave being the
    blocks the card holds at once (``resident`` an SM: by default the
    march's :data:`RESIDENT`, the sweep's instance
    :data:`SWEEP_RESIDENT`) and a block taking ``min(tile, Z)`` plus
    its :func:`halo_steps`; ties keep the longer tile. Mirrors
    ``csrc/march.cuh``'s ``march_tile_z`` (``nsol_march_tile_z``)."""
    Z, Y, X = dims
    top = 2 * TILE_Z if weighted else TILE_Z
    extra = halo_steps(kz, weighted)
    cols = -(-X // TILE_X) * -(-Y // TILE_Y)
    slots = max(sms, 1) * (resident or RESIDENT[bool(weighted)])
    best, best_cost, tz = top, None, top
    while tz >= MIN_TILE_Z:
        blocks = cols * -(-Z // tz)
        cost = -(-blocks // slots) * (min(tz, Z) + extra)
        if best_cost is None or cost < best_cost:
            best, best_cost = tz, cost
        tz //= 2
    return best


# ---------------------------------------------------------------- kernels --

def tiled_partials(device, dims, sets=1):
    """Per-block float64 partials of the tiled units at ``dims`` (Z, Y, X)
    — the blocks of a march's shortest z tile —, large enough for the
    per-axis units too; ``sets`` such sets (the sweep's four dots)."""
    lib = build.load()
    n = sets * max(lib.nsol_tiled_blocks(*dims), lib.nsol_max_blocks())
    return torch.empty(n, dtype=torch.float64, device=device)


def _check(name, v, tensors, taps, scal=None, dtype=torch.float32, **form):
    dims = B.volume_dims(name, v)
    B.check_tensors(name, v.shape, v, dtype=dtype)
    B.check_tensors(name, v.shape, *[t for t in tensors if t is not None],
                    device=v.device)
    B._check_consts(name, v.device, taps, scal)
    tv = taps.as_volume()
    require_fit(name, tv.lengths, **form)
    return dims, tv


def normal_apply_zy(v, taps, inv_h2, rho, rhs=None, scal=None,
                    io_dtype=None, p_dtype=None):
    """``q = AᵀA v + ρ·DᵀD v`` (``taps``: the normal
    :class:`~blocked.Taps`). With ``rhs`` (and ``scal``) returns
    ``rhs − q`` and sets ``scal[GAMMA] = ‖rhs − q‖²``, ``scal[BETA] = 0``
    — and with ``p_dtype`` returns ``(r, p)``, ``p = r`` stored as
    ``p_dtype``, the "apply" CG's first direction —; with ``scal`` alone
    returns ``q`` and sets ``scal[PQ] = Σ v·q``, ``scal[A] = γ/pq`` (0
    unless pq > 0). ``io_dtype=bfloat16`` (``blocked.py:754``'s
    ``io_dtype``): ``v`` and ``q`` bfloat16, the sums float32 and ``pq``
    taking the rounded ``q``; the residual form then reads a float32 ``v``
    as bfloat16 and returns the residual in bfloat16."""
    if v.device.type == "cpu":
        return normal_apply_zy_plain(v, taps, inv_h2, rho, rhs, scal,
                                     io_dtype, p_dtype)
    name = "normal_apply_zy"
    if rhs is not None and scal is None:
        raise ValueError("%s: the residual form needs scal" % name)
    io = B.io_flag(name, io_dtype)
    out_dtype = B.BF16 if io else torch.float32
    dims, tv = _check(name, v, [], taps, scal,
                      dtype=out_dtype if rhs is None else torch.float32)
    p_out = None
    if rhs is not None:
        B.check_tensors(name, v.shape, rhs, device=v.device)
        if p_dtype is not None:
            if B.io_flag(name, p_dtype) < io:
                raise ValueError("%s: a bfloat16 residual takes a bfloat16 "
                                 "direction" % name)
            p_out = torch.empty(v.shape, dtype=p_dtype, device=v.device)
    out = torch.empty(v.shape, dtype=out_dtype, device=v.device)
    parts = tiled_partials(v.device, dims) if scal is not None else None
    counts = build.new_counts(5)
    err = build.load().nsol_normal_apply_zy(
        build.tensor_ptr(v), build.tensor_ptr(out), build.tensor_ptr(rhs),
        build.tensor_ptr(p_out), int(p_dtype == B.BF16),
        build.tensor_ptr(parts), build.tensor_ptr(scal),
        build.tensor_ptr(tv.buf), *tv.lengths, float(rho), io,
        *B.spacing3(inv_h2), *dims, build.stream_ptr(v.device), counts)
    build.check(err, name)
    normal_apply_zy.launches += counts[0]
    return out if p_out is None else (out, p_out)


def cg_step_zy(r, p, scal, taps, inv_h2, rho, first=False):
    """``p' = r + β·p`` (``p' = r`` when ``first``), ``q = (AᵀA + ρDᵀD) p'``,
    ``scal[PQ] = Σ p'·q`` and ``scal[A] = γ/pq`` (0 unless pq > 0).
    Returns ``(p', q)``."""
    if r.device.type == "cpu":
        return cg_step_zy_plain(r, p, scal, taps, inv_h2, rho, first)
    name = "cg_step_zy"
    if scal is None:
        raise ValueError("%s: needs scal" % name)
    dims, tv = _check(name, r, [None if first else p], taps, scal, nin=2)
    p_new, q = torch.empty_like(r), torch.empty_like(r)
    counts = build.new_counts(5)
    err = build.load().nsol_cg_step_zy(
        build.tensor_ptr(r), None if first else build.tensor_ptr(p),
        build.tensor_ptr(p_new), build.tensor_ptr(q),
        build.tensor_ptr(tiled_partials(r.device, dims)),
        build.tensor_ptr(scal), int(bool(first)), build.tensor_ptr(tv.buf),
        *tv.lengths, float(rho), *B.spacing3(inv_h2), *dims,
        build.stream_ptr(r.device), counts)
    build.check(err, name)
    cg_step_zy.launches += counts[1]
    return p_new, q


def blur_apply_zy(y, taps, inv_h2, u=None, rho=0.0, scal=None, head=None):
    """``A y`` (``taps``: the blur :class:`~blocked.Taps`); with ``u``,
    ``A y + ρ·DᵀD u``. With ``scal`` (``u`` is then the IRLS iterate
    ``x``): returns ``(free, rk)``, ``free = 0`` where ``x ≤ 0`` and
    ``g > 0`` (else 1), ``rk = −free·g``, and sets ``scal[GAMMA] = ‖rk‖²``,
    ``scal[BETA] = 0``. With ``head = (b, loss, C)`` (``y`` is then ``x``):
    returns ``(wts, y')`` with ``wts = ρ'_C(r²)``, ``y' = wts·r``,
    ``r = A x − b``."""
    if head is not None and head[1] not in Rec.LOSS_IDS:
        raise ValueError("unknown data loss %r" % (head[1],))
    if y.device.type == "cpu":
        return blur_apply_zy_plain(y, taps, inv_h2, u, rho, scal, head)
    name = "blur_apply_zy"
    if scal is not None and u is None:
        raise ValueError("%s: the gradient form needs u = x" % name)
    b, loss, scale = head if head is not None else (None, "linear", 1.0)
    dims, tv = _check(name, y, [u, b], taps, scal, nin=2 if u is not None
                      else 1, lap=u is not None)
    out = free = rk = wts = yout = parts = None
    if head is not None:
        wts, yout = torch.empty_like(y), torch.empty_like(y)
    elif scal is not None:
        free, rk = torch.empty_like(y), torch.empty_like(y)
        parts = tiled_partials(y.device, dims)
    else:
        out = torch.empty_like(y)
    counts = build.new_counts(5)
    err = build.load().nsol_blur_apply_zy(
        build.tensor_ptr(y), build.tensor_ptr(u), build.tensor_ptr(out),
        build.tensor_ptr(free), build.tensor_ptr(rk), build.tensor_ptr(b),
        build.tensor_ptr(wts), build.tensor_ptr(yout), build.tensor_ptr(parts),
        build.tensor_ptr(scal), build.tensor_ptr(tv.buf), *tv.lengths,
        float(rho), Rec.LOSS_IDS.index(loss), float(scale),
        *B.spacing3(inv_h2), *dims, build.stream_ptr(y.device), counts)
    build.check(err, name)
    blur_apply_zy.launches += counts[2]
    if head is not None:
        return wts, yout
    return out if scal is None else (free, rk)


def weighted_apply_zy(r, p, free, wts, scal, taps, inv_h2, rho, first=False,
                      storage="exact"):
    """Masked CG direction and weighted SPD apply in one pass:
    ``p' = r + β·p`` (``p' = r`` when ``first``), ``pf = free·p'``,
    ``q = free·(Aᵀ(wts·A pf) + ρ·DᵀD pf) + (p' − pf)`` (``free=None``: every
    voxel free), ``scal[PQ] = Σ p'·q``, ``scal[A] = γ/pq`` (0 unless
    pq > 0). Returns ``(p', q)``. ``storage``: the masked CG's
    :data:`~.robust.ROBUST_STORAGE` mode, as
    :func:`~.robust.weighted_apply` takes it."""
    if r.device.type == "cpu":
        return weighted_apply_zy_plain(r, p, free, wts, scal, taps, inv_h2,
                                       rho, first, storage=storage)
    name = "weighted_apply_zy"
    if scal is None:
        raise ValueError("%s: needs scal" % name)
    dims, tv = _check(name, r, [wts, free], taps, scal, weighted=True)
    p_dtype = R.check_directions(name, r, p, first, storage)
    p_new = torch.empty(r.shape, dtype=p_dtype, device=r.device)
    q = torch.empty_like(r)
    counts = build.new_counts(5)
    err = build.load().nsol_weighted_apply_zy(
        build.tensor_ptr(r), None if first else build.tensor_ptr(p),
        build.tensor_ptr(p_new), build.tensor_ptr(q), build.tensor_ptr(free),
        build.tensor_ptr(wts), build.tensor_ptr(tiled_partials(r.device, dims)),
        build.tensor_ptr(scal), int(bool(first)), build.tensor_ptr(tv.buf),
        *tv.lengths, float(rho), R.ROBUST_STORAGE.index(storage),
        *B.spacing3(inv_h2), *dims, build.stream_ptr(r.device), counts)
    build.check(err, name)
    weighted_apply_zy.launches += counts[3]
    return p_new, q


def cg_direction(p, r, scal, q=None):
    """In place: ``p = r + β·p`` with ``β = scal[BETA]``, stored as ``p``
    is (float32 or bfloat16; the sum in float32). With ``q`` (the "apply"
    CG under bfloat16 state, whose :func:`~.blocked.cg_update` left ``r``
    alone): ``r' = r − a·q`` first (``a = scal[A]``), stored in ``r``, and
    ``p = r' + β·p`` from the unrounded ``r'``. Elementwise: the kernel
    takes contiguous tensors of any shape and alignment."""
    if p.device.type == "cpu":
        return cg_direction_plain(p, r, scal, q)
    name = "cg_direction"
    sid = B.storage_ids(B.storage_of(r.dtype, p.dtype,
                                     None if q is None else q.dtype))[1]
    for t in (p, r, q):
        if t is not None:
            B.check_tensors(name, p.shape, t, device=p.device, dtype=t.dtype)
    B._check_consts(name, p.device, scal=scal)
    counts = build.new_counts(5)
    err = build.load().nsol_cg_direction(
        build.tensor_ptr(p), build.tensor_ptr(r), build.tensor_ptr(q),
        build.tensor_ptr(scal), p.numel(), sid, build.stream_ptr(p.device),
        counts)
    build.check(err, name)
    cg_direction.launches += counts[4]


#: the units, in the order of ``csrc/tiled.cu``'s counts
UNITS = (normal_apply_zy, cg_step_zy, blur_apply_zy, weighted_apply_zy,
         cg_direction)
PLAIN = (normal_apply_zy_plain, cg_step_zy_plain, blur_apply_zy_plain,
         weighted_apply_zy_plain, cg_direction_plain)
for _f in UNITS:
    _f.launches = 0
