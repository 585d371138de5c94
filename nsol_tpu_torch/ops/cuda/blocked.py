"""Normal-operator apply and CG kernels: counterparts of
``nsol_tpu/ops/pallas/blocked.py``.

Four kernel units (CUDA C++ in ``csrc/admm.cu``), each with its plain
PyTorch version beside it and a launch counter on its wrapper:

* :func:`normal_apply` — ``q = AᵀA v + ρ·BᵀB v``; replaces
  ``blocked.py::make_blocked_normal_operator`` (:402) and the in-kernel
  ``conv_all``/``lap`` of ``fused.py`` (:467-496, and ``reg_apply`` of the
  Tikhonov kernel, :776-783). With ``rhs`` it returns the CG residual
  ``rhs − q`` and sets ``γ = ‖rhs − q‖²``, ``β = 0``.
* :func:`cg_step` — ``p' = r + β·p ; q = M p' ; pq = Σ p'·q`` and
  ``a = γ/pq`` (guarded); replaces ``blocked.py::make_blocked_cg_step``
  (:988).
* :func:`cg_update` — ``x += a·p' ; r −= a·q ; γ' = ‖r‖²`` and
  ``β = γ'/γ`` (guarded): the x/r update and the second reduction of the
  in-kernel CG (``fused.py:365-374``).
* :func:`cg_sweep` — one whole CG iteration in one pass with its four
  dots and the scalar recurrence; replaces
  ``blocked.py::make_blocked_cg_sweep`` (:1139), ``blocked_admm_solve``'s
  ``mode="sweep"``.
* :func:`normal_apply_prepadded` — ``q = AᵀA v + ρ·DᵀD v`` on a z-window
  of a sharded volume whose halo planes the ring exchange has attached,
  the Laplacian's global boundary rows placed by ``row0``/``z_total``;
  replaces ``blocked.py::make_blocked_normal_operator_prepadded`` (:478),
  the per-shard apply of :mod:`nsol_tpu_torch.parallel`.

``BᵀB`` is the regulariser's normal operator, ``reg="TK1"`` the
zero-boundary Laplacian ``DᵀD`` (TV and TK1) or ``reg="TK0"`` the
identity; the kernels take it as a template parameter of their
epilogues. The CG scalars live in a float64 device tensor ``scal`` (slots
γ, pq, a, β, and the sweep's rq, qq), so a solve never waits for the
host. What bounds the kernels on the H100 is bytes moved (3 passes of ~2
volumes each per apply); see the note at the top of ``csrc/admm.cu``.

Storage (the TPU kernels' ``io_dtype``/``r_dtype``/``q_dtype``, and
``blocked_admm_solve``'s ``compact_dirs``/``state_dtype``): the CG vectors
``r``, ``p``, ``q`` may be stored in bfloat16 (:data:`STORAGE`), every
stencil, update and sum running in float32 (float64 sums on the device)
and each value rounded to nearest even where the reference stores it.
:func:`check_options` is the one check of every solver factory's JAX-package
arguments.

The (z, y)-blocked family of the 512-wide-plane scale path
(``blocked.py:754, 841, 878, 1293``) lives at the end:
:func:`pick_zy_blocks` (the JAX package's routing criterion),
:func:`make_blocked_normal_operator_2d` and :func:`make_blocked_cg_step_2d`
over the one-pass tiled units of :mod:`.tiled` (``csrc/tiled.cu``), and
:func:`blocked_admm_solve`, whose ``"apply"``/``"step2d"`` modes one C
function enqueues (``nsol_blocked_admm_solve``), its ``"step"`` and
``"sweep"`` modes another (``nsol_admm_solve``).

A 2-D image runs on CUDA as a ``(1, Y, X)`` volume with z taps ``[1]``
and ``1/h_z = 1/h_z² = 0``, so every z term is an exact zero (the CPU
tests show the plain versions agree bit for bit on both views). Each
wrapper runs the plain version only for CPU tensors; on a CUDA tensor it
launches the kernel (2-D or 3-D, contiguous, float32 or the bfloat16 its
storage names) or raises.
"""

import functools

import numpy as np
import torch

from nsol_tpu_torch.ops import conv as C
from nsol_tpu_torch.ops import grad as G
from nsol_tpu_torch.ops.cuda import build
from nsol_tpu_torch.solvers.cg import guarded_ratio

__all__ = ["Stencils", "new_scalars", "normal_apply", "normal_apply_plain",
           "cg_step", "cg_step_plain", "cg_update", "cg_update_plain",
           "cg_sweep", "cg_sweep_plain", "normal_apply_prepadded",
           "normal_apply_prepadded_plain", "slab_blur_plain",
           "window_laplacian_plain", "prepadded_window",
           "make_blocked_normal_operator_prepadded",
           "make_blocked_normal_operator",
           "make_blocked_cg_step", "make_blocked_cg_sweep", "counted",
           "check_tensors", "volume_dims", "spacing3", "stencils_for",
           "check_options", "storage_dtype", "storage_ids", "storage_of",
           "STORAGE", "STORAGE_KEYS", "pick_zy_blocks", "takes_zy_route",
           "zy_halos", "resolve_zy_blocks",
           "make_blocked_normal_operator_2d",
           "make_blocked_cg_step_2d", "blocked_admm_solve", "plain_only",
           "MODES", "REGS",
           "GAMMA", "PQ", "A", "BETA", "RQ", "QQ"]

#: slots of the CG scalar tensor (the sweep's dots rq, qq last)
GAMMA, PQ, A, BETA, RQ, QQ = 0, 1, 2, 3, 4, 5
#: regularisers ``BᵀB`` by the index the kernels take (``RegKind`` of
#: ``csrc/stencil.cuh``): ``"TK1"`` the Laplacian ``DᵀD``, ``"TK0"`` ``I``
REGS = ("TK1", "TK0")


class Taps(object):
    """Per-array-axis 1-D stencils, concatenated in one device buffer."""

    def __init__(self, factors, device, dtype):
        self._factors = [np.asarray(f, np.float64) for f in factors]
        self.lengths = tuple(int(len(f)) for f in factors)
        self.buf = torch.as_tensor(np.concatenate(self._factors),
                                   dtype=dtype, device=device).contiguous()
        self.per_axis = list(torch.split(self.buf, self.lengths))
        self._volume = self if len(factors) == 3 else None

    def as_volume(self):
        """These taps for a 2-D image viewed as a (1, Y, X) volume: the z
        tap ``[1]`` first, so the z pass copies exactly."""
        if self._volume is None:
            self._volume = Taps([np.ones(1)] + self._factors,
                                self.buf.device, self.buf.dtype)
        return self._volume


class Stencils(object):
    """Operator constants of one problem on one device: the blur taps
    ``A``, the self-correlated normal taps ``AᵀA`` (both per array axis),
    and the spacing factors ``1/h``, ``1/h²`` in spatial (x, y[, z])
    order, rounded to the working dtype once."""

    def __init__(self, factors, spacing, device, dtype=torch.float32):
        ndim = len(factors)
        s = G._spacing_array(spacing, ndim)
        self.ndim = ndim
        self.dtype = dtype
        self.blur = Taps(factors, device, dtype)
        self.normal = Taps([np.convolve(f, f[::-1]) for f in factors],
                           device, dtype)
        rnd = np.float32 if dtype == torch.float32 else np.float64
        self.inv_h = tuple(float(rnd(1.0 / si)) for si in s)
        self.inv_h2 = tuple(float(rnd(1.0 / si ** 2)) for si in s)

    @classmethod
    def from_cov(cls, cov, alpha_cut=3, spacing=None, device="cpu",
                 dtype=torch.float32):
        return cls(C.blur_factors(cov, alpha_cut, spacing), spacing, device,
                   dtype)


def new_scalars(device):
    """CG scalar state (γ, pq, a, β, and the sweep's rq, qq) in float64 on
    ``device``."""
    return torch.zeros(6, dtype=torch.float64, device=device)


# ---------------------------------------------------------------- storage --

BF16 = torch.bfloat16
#: storage of the CG vectors ``(r, p, q)`` by mode, in the order of
#: ``csrc/stencil.cuh``'s Storage enum — ``None`` is the working dtype:
#: ``"exact"``; ``"qf32"`` (the fused solve's ``compact_dirs``, and the
#: blocked ``compact_dirs="qf32"``: p bf16); ``"dirs"`` (the blocked
#: ``compact_dirs=True``: p, q bf16); ``"state"`` (``state_dtype=bfloat16``:
#: r, p, q bf16)
STORAGE = {"exact": (None, None, None), "qf32": (None, BF16, None),
           "dirs": (None, BF16, BF16), "state": (BF16, BF16, BF16)}


def storage_ids(storage):
    """``(R, P, Q)`` of ``storage`` as CUDA dtypes, and its enum index."""
    if storage not in STORAGE:
        raise ValueError("storage must be one of %s, got %r"
                         % (tuple(STORAGE), storage))
    dts = tuple(torch.float32 if d is None else d for d in STORAGE[storage])
    return dts, tuple(STORAGE).index(storage)


def storage_of(r_dtype, p_dtype, q_dtype):
    """The storage mode whose CUDA dtypes are ``(r, p, q)``'s (``q_dtype``
    None: any); ``ValueError`` where no mode stores them so."""
    for name in STORAGE:
        (r, p, q), _ = storage_ids(name)
        if (r, p) == (r_dtype, p_dtype) and q_dtype in (None, q):
            return name
    raise ValueError("no storage mode keeps r, p, q as %s, %s, %s"
                     % (r_dtype, p_dtype, q_dtype))


def _store(t, dtype):
    """``t`` stored as ``dtype`` (None: as it is); rounds to nearest even,
    as JAX's ``astype``."""
    return t if dtype is None else t.to(dtype)


def _round(t, dtype):
    """``t`` rounded to ``dtype``'s precision, in ``t``'s dtype."""
    return t if dtype is None else t.to(dtype).to(t.dtype)


# ------------------------------------------------------------ plain forms --

def counted(fn, name=None):
    """``fn`` with a call counter ``.calls``, as each plain version keeps
    (named ``name``, or as ``fn``); ``.__wrapped__`` is ``fn`` itself,
    uncounted, for a plain version that another one builds on."""
    @functools.wraps(fn)
    def plain(*args, **kwargs):
        plain.calls += 1
        return fn(*args, **kwargs)

    plain.calls = 0
    if name is not None:
        plain.__name__ = plain.__qualname__ = name
    return plain


def _laplacian(v, inv_h2):
    ndim = v.ndim
    out = None
    for i in range(ndim):
        t = G.second_difference(v, ndim - 1 - i) * inv_h2[i]
        out = t if out is None else out + t
    return out


def _blur_plain(v, taps):
    u = v
    for ax in reversed(range(v.ndim)):  # x pass first, as the kernel does
        u = C.convolve_axis(u, taps.per_axis[ax], ax)
    return u


def reg_normal_plain(v, inv_h2, reg="TK1"):
    """``BᵀB v``: the Laplacian for ``"TK1"``, ``v`` for ``"TK0"``."""
    if reg not in REGS:
        raise ValueError("reg must be one of %s, got %r" % (REGS, reg))
    return v if reg == "TK0" else _laplacian(v, inv_h2)


def _apply_plain(v, taps, inv_h2, rho, reg="TK1"):
    return _blur_plain(v, taps) + rho * reg_normal_plain(v, inv_h2, reg)


@counted
def normal_apply_plain(v, taps, inv_h2, rho, rhs=None, scal=None,
                       reg="TK1", io_dtype=None):
    """Plain version of :func:`normal_apply`."""
    cd = taps.buf.dtype
    q = _apply_plain(_round(v.to(cd), io_dtype), taps, inv_h2, rho, reg)
    if rhs is None:
        return _store(q, io_dtype)
    r = rhs - _round(q, io_dtype)
    scal[GAMMA] = torch.sum(r * r)
    scal[BETA] = 0.0
    return _store(r, io_dtype)


@counted
def cg_step_plain(r, p, scal, taps, inv_h2, rho, first=False, reg="TK1",
                  storage="exact"):
    """Plain version of :func:`cg_step`: returns ``(p', q)`` and sets
    ``scal[PQ]``, ``scal[A]``."""
    _, P, Q = STORAGE[storage]
    cd = taps.buf.dtype
    rw = r.to(cd)
    p_new = _store(rw.clone() if first
                   else rw + scal[BETA].to(cd) * p.to(cd), P)
    pw = p_new.to(cd)
    q = _apply_plain(pw, taps, inv_h2, rho, reg)
    pq = torch.sum(pw * q).to(scal.dtype)
    scal[PQ] = pq
    scal[A] = guarded_ratio(scal[GAMMA], pq)
    return p_new, _store(q, Q)


@counted
def cg_update_plain(x, r, p, q, scal, store_r=True):
    """Plain version of :func:`cg_update` (updates x, r, scal in place)."""
    a = scal[A].to(x.dtype)
    x.add_(a * p.to(x.dtype))
    if r is None:
        return
    r_new = r.to(x.dtype) - a * q.to(x.dtype)
    gamma_new = torch.sum(r_new * r_new).to(scal.dtype)
    if store_r:
        r.copy_(r_new)
    scal[BETA] = guarded_ratio(gamma_new, scal[GAMMA])
    scal[GAMMA] = gamma_new


def _sweep_scalars(scal, g, pq, rq, qq):
    """The sweep's recurrence (``blocked.py:1505-1509``): ``a = g/pq``,
    ``γ = max(g − 2a·rq + a²·qq, 0)``, ``β = γ/g`` (zero-guarded)."""
    a = guarded_ratio(g, pq)
    gn = torch.clamp(g - 2.0 * a * rq + a * a * qq, min=0.0)
    scal[GAMMA], scal[PQ], scal[RQ], scal[QQ] = g, pq, rq, qq
    scal[BETA] = guarded_ratio(gn, g)
    scal[A] = a


@counted
def cg_sweep_plain(x, r, p, q, scal, taps, inv_h2, rho, first=False):
    """Plain version of :func:`cg_sweep`."""
    cd = taps.buf.dtype
    io = None if r.dtype == cd else r.dtype
    rw = r.to(cd)
    if first:
        r_new, pn = rw.clone(), rw
    else:
        a, beta = scal[A].to(cd), scal[BETA].to(cd)
        pw_old = p.to(cd)
        r_new = rw - a * q.to(cd)
        pn = r_new + beta * pw_old
        x.add_(a * pw_old)
    p_new = _store(pn, io)
    pw = p_new.to(cd)
    qn = _apply_plain(pw, taps, inv_h2, rho)
    dots = [torch.sum(u * v).to(scal.dtype)
            for u, v in ((r_new, r_new), (pw, qn), (r_new, qn), (qn, qn))]
    q.copy_(qn)
    _sweep_scalars(scal, *dots)
    return _store(r_new, io), p_new


def slab_blur_plain(v_ext, taps, h):
    """The window chain of ``csrc/stencil.cuh`` (``blur_chain_slab``): the
    x and y taps wrap within each plane of ``v_ext``, then the z taps read
    its planes contiguously, with no wrap — out plane ``k`` =
    ``Σ_j taps_z[j] · u[k + h + c − j]`` (``c = K // 2 ≤ h``) on the
    ``v_ext.shape[0] − 2h`` centre planes."""
    u = C.convolve_axis(v_ext, taps.per_axis[2], 2)
    u = C.convolve_axis(u, taps.per_axis[1], 1)
    zt = taps.per_axis[0]
    c, n = len(zt) // 2, v_ext.shape[0] - 2 * h
    acc = None
    for j in range(len(zt)):
        term = zt[j] * u[h + c - j:h + c - j + n]
        acc = term if acc is None else acc + term
    return acc


def window_laplacian_plain(v_ext, h, inv_h2, row0, z_total):
    """``DᵀD`` of the centre planes of a z-window (``h ≥ 1`` halo planes a
    side) of a volume of ``z_total`` rows whose first centre plane is
    global row ``row0``: x and y as on the whole volume, z from the halo
    rows, with the zero-boundary rows (``ops/grad.py``) only at global rows
    0 and ``z_total − 1``."""
    n = v_ext.shape[0] - 2 * h
    c, down, up = (v_ext[h + k:h + k + n] for k in (0, -1, 1))
    rows = (torch.arange(n, device=v_ext.device) + int(row0)).view(-1, 1, 1)
    zero = torch.zeros_like(c)
    lz = torch.where(rows > 0, c - down, zero) \
        + (c - torch.where(rows + 1 < int(z_total), up, zero))
    return G.second_difference(c, 2) * inv_h2[0] \
        + G.second_difference(c, 1) * inv_h2[1] + lz * inv_h2[2]


@counted
def normal_apply_prepadded_plain(v_ext, taps, inv_h2, rho, row0, z_total):
    """Plain version of :func:`normal_apply_prepadded`."""
    h = prepadded_halo(taps)
    prepadded_window("normal_apply_prepadded", v_ext, h, row0, z_total)
    return slab_blur_plain(v_ext, taps, h) + rho * window_laplacian_plain(
        v_ext, h, inv_h2, row0, z_total)


# ---------------------------------------------------------------- kernels --

def check_tensors(name, shape, *tensors, device=None, dtype=torch.float32):
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype``
    (float32 by default) and ``shape``, all on one device (``device``, or
    the first tensor's)."""
    device = tensors[0].device if device is None else device
    for t in tensors:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError("%s: expected CUDA tensors on one device, got "
                             "%s" % (name, t.device))
        if t.dtype != dtype:
            raise ValueError("%s: the CUDA kernel takes %s here, got %s"
                             % (name, dtype, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s: tensors must be contiguous" % name)
        if tuple(t.shape) != tuple(shape):
            raise ValueError("%s: shape %s, expected %s"
                             % (name, tuple(t.shape), tuple(shape)))


def volume_dims(name, v):
    """``(Z, Y, X)`` of a 3-D volume, ``(1, Y, X)`` of a 2-D image: the
    kernels run a 2-D image as a one-plane volume (z taps ``[1]``,
    ``1/h_z = 1/h_z² = 0``, so every z term is an exact zero)."""
    if v.dim() not in (2, 3):
        raise ValueError("%s: the CUDA kernel takes a 2-D image or a 3-D "
                         "volume, got shape %s" % (name, tuple(v.shape)))
    return (1,) * (3 - v.dim()) + tuple(v.shape)


def spacing3(inv_h):
    """``1/h`` or ``1/h²`` in (x, y, z) order, 0 for a 2-D image's z."""
    return tuple(float(h) for h in inv_h) + (0.0,) * (3 - len(inv_h))


def reg_id(reg):
    if reg not in REGS:
        raise ValueError("reg must be one of %s, got %r" % (REGS, reg))
    return REGS.index(reg)


def io_flag(name, io_dtype):
    """The kernels' io flag: 0 for float32 (or None), 1 for bfloat16."""
    if io_dtype in (None, torch.float32):
        return 0
    if io_dtype == BF16:
        return 1
    raise ValueError("%s: io_dtype must be float32 or bfloat16, got %s"
                     % (name, io_dtype))


def _check_consts(name, device, taps=None, scal=None, nscal=4):
    if taps is not None and (taps.buf.device != device
                             or taps.buf.dtype != torch.float32):
        raise ValueError("%s: taps must be float32 on %s" % (name, device))
    if scal is not None and (scal.device != device
                             or scal.dtype != torch.float64
                             or scal.numel() < nscal):
        raise ValueError("%s: scal must be float64[%d] on %s"
                         % (name, nscal, device))


def _partials(device, sets=1):
    return torch.empty(sets * build.load().nsol_max_blocks(),
                       dtype=torch.float64, device=device)


def normal_apply(v, taps, inv_h2, rho, rhs=None, scal=None, reg="TK1",
                 io_dtype=None):
    """``q = Σ-separable wrap conv of v with taps + rho·BᵀB v``; with
    ``rhs`` returns ``rhs − q`` and sets ``scal[GAMMA] = ‖rhs − q‖²``,
    ``scal[BETA] = 0``. ``taps``: a :class:`Taps` (the normal taps, or the
    blur taps with ``rho=0`` for ``Aᵀb``). ``io_dtype=torch.bfloat16``
    (``blocked.py:402``'s ``io_dtype``): ``v`` and ``q`` bfloat16, the
    sums in float32; the residual form then reads a float32 ``v`` as
    bfloat16, rounds ``q`` before ``rhs − q`` and returns it in
    bfloat16 (γ from the unrounded residual)."""
    if v.device.type == "cpu":
        return normal_apply_plain(v, taps, inv_h2, rho, rhs, scal, reg,
                                  io_dtype)
    name = "normal_apply"
    io = io_flag(name, io_dtype)
    out_dtype = BF16 if io else torch.float32
    dims = volume_dims(name, v)
    if rhs is None:
        check_tensors(name, v.shape, v, dtype=out_dtype)
    else:
        check_tensors(name, v.shape, v, rhs)
    _check_consts(name, v.device, taps, scal)
    if rhs is not None and scal is None:
        raise ValueError("%s: the residual form needs scal" % name)
    lib = build.load()
    out = torch.empty(v.shape, dtype=out_dtype, device=v.device)
    t1, t2 = (torch.empty(v.shape, device=v.device) for _ in range(2))
    partials = _partials(v.device) if rhs is not None else None
    tv = taps.as_volume()
    counts = build.new_counts(6)
    err = lib.nsol_normal_apply(
        build.tensor_ptr(v), build.tensor_ptr(out), build.tensor_ptr(t1),
        build.tensor_ptr(t2), build.tensor_ptr(rhs),
        build.tensor_ptr(partials), build.tensor_ptr(scal),
        build.tensor_ptr(tv.buf), *tv.lengths, float(rho), reg_id(reg), io,
        *spacing3(inv_h2), *dims, build.stream_ptr(v.device), counts)
    build.check(err, name)
    normal_apply.launches += counts[0]
    return out


def cg_step(r, p, scal, taps, inv_h2, rho, first=False, reg="TK1",
            storage="exact"):
    """``p' = r + β·p`` (``p' = r`` when ``first``), ``q = M p'`` with
    ``M = taps-conv + ρ·BᵀB``, then ``scal[PQ] = Σ p'·q`` and
    ``scal[A] = γ/pq`` (0 unless pq > 0). Returns ``(p', q)``, stored as
    :data:`STORAGE` ``[storage]`` says (``blocked.py:988``'s ``io_dtype``,
    ``r_dtype``, ``q_dtype``): ``pq`` takes the rounded ``p'`` and the
    float ``q`` before its rounding."""
    if r.device.type == "cpu":
        return cg_step_plain(r, p, scal, taps, inv_h2, rho, first, reg,
                             storage)
    name = "cg_step"
    (R, P, Q), sid = storage_ids(storage)
    dims = volume_dims(name, r)
    check_tensors(name, r.shape, r, dtype=R)
    if not first:
        check_tensors(name, r.shape, p, device=r.device, dtype=P)
    _check_consts(name, r.device, taps, scal)
    lib = build.load()
    p_new = torch.empty(r.shape, dtype=P, device=r.device)
    q = torch.empty(r.shape, dtype=Q, device=r.device)
    t1, t2 = (torch.empty(r.shape, device=r.device) for _ in range(2))
    tv = taps.as_volume()
    counts = build.new_counts(6)
    err = lib.nsol_cg_step(
        build.tensor_ptr(r), None if first else build.tensor_ptr(p),
        build.tensor_ptr(p_new), build.tensor_ptr(q), build.tensor_ptr(t1),
        build.tensor_ptr(t2), build.tensor_ptr(_partials(r.device)),
        build.tensor_ptr(scal), int(bool(first)), build.tensor_ptr(tv.buf),
        *tv.lengths, float(rho), reg_id(reg), sid, *spacing3(inv_h2), *dims,
        build.stream_ptr(r.device), counts)
    build.check(err, name)
    cg_step.launches += counts[1]
    return p_new, q


def cg_update(x, r, p, q, scal, store_r=True):
    """In place: ``x += a·p``, ``r −= a·q`` with ``a = scal[A]``; then
    ``β = ‖r‖²/γ`` (0 unless γ > 0) and ``γ = ‖r‖²``. ``r``, ``p``, ``q``
    may be stored as a :data:`STORAGE` mode keeps them (x float32; the
    arithmetic and ‖r‖² in float32, before r is rounded); ``store_r=False``
    sums the new r without storing it; ``r=None`` (and ``q=None``) does
    ``x += a·p`` alone, the sweep's owed update. Elementwise: the kernel
    takes tensors of any shape."""
    if x.device.type == "cpu":
        return cg_update_plain(x, r, p, q, scal, store_r)
    name = "cg_update"
    sid = storage_ids(storage_of(torch.float32 if r is None else r.dtype,
                                 p.dtype, None if q is None else q.dtype))[1]
    check_tensors(name, x.shape, x)
    for t in (r, p, q):
        if t is not None:
            check_tensors(name, x.shape, t, device=x.device, dtype=t.dtype)
    _check_consts(name, x.device, scal=scal)
    lib = build.load()
    counts = build.new_counts(6)
    err = lib.nsol_cg_update(
        build.tensor_ptr(x), build.tensor_ptr(r), build.tensor_ptr(p),
        build.tensor_ptr(q), build.tensor_ptr(_partials(x.device)),
        build.tensor_ptr(scal), x.numel(), sid, int(bool(store_r)),
        build.stream_ptr(x.device), counts)
    build.check(err, name)
    cg_update.launches += counts[2]


def cg_sweep(x, r, p, q, scal, taps, inv_h2, rho, first=False):
    """One whole CG iteration in one pass (``blocked.py::
    make_blocked_cg_sweep``, :1139): with ``a = scal[A]``,
    ``β = scal[BETA]`` (both 0 when ``first``), ``r' = r − a·q``,
    ``p' = r' + β·p``, ``q ← (AᵀA + ρDᵀD) p'`` in place, ``x += a·p`` in
    place; the dots ``g = Σr'²``, ``pq = Σp'q'``, ``rq = Σr'q'``,
    ``qq = Σq'²`` into ``scal[GAMMA, PQ, RQ, QQ]`` and the recurrence's
    next ``a``, ``β``. ``r``, ``p``, ``q`` are all float32 or all
    bfloat16 (``io_dtype``): the arithmetic and the dots are float32,
    ``pq`` takes the rounded ``p'``, the others the unrounded ``r'``,
    ``q'``. ``taps``: the normal taps (the TV Laplacian). Returns
    ``(r', p')``."""
    if x.device.type == "cpu":
        return cg_sweep_plain(x, r, p, q, scal, taps, inv_h2, rho, first)
    name = "cg_sweep"
    T = r.dtype
    io = io_flag(name, T)
    dims = volume_dims(name, x)
    check_tensors(name, x.shape, x)
    check_tensors(name, x.shape, r, q, *([] if first else [p]),
                  device=x.device, dtype=T)
    _check_consts(name, x.device, taps, scal, nscal=6)
    lib = build.load()
    r_new, p_new = torch.empty_like(r), torch.empty_like(r)
    t1, t2 = (torch.empty(x.shape, device=x.device) for _ in range(2))
    tv = taps.as_volume()
    counts = build.new_counts(6)
    err = lib.nsol_cg_sweep(
        build.tensor_ptr(x), build.tensor_ptr(r),
        None if first else build.tensor_ptr(p), build.tensor_ptr(q),
        build.tensor_ptr(r_new), build.tensor_ptr(p_new), build.tensor_ptr(t1),
        build.tensor_ptr(t2), build.tensor_ptr(_partials(x.device, 4)),
        build.tensor_ptr(scal), int(bool(first)), build.tensor_ptr(tv.buf),
        *tv.lengths, float(rho), io, *spacing3(inv_h2), *dims,
        build.stream_ptr(x.device), counts)
    build.check(err, name)
    cg_sweep.launches += counts[5]
    return r_new, p_new


def prepadded_halo(taps):
    """The z halo a window unit takes with ``taps``: their z half-width,
    at least 1 (the Laplacian's z neighbours)."""
    return max(taps.lengths[0] // 2, 1)


def prepadded_window(name, v_ext, h, row0, z_total, *others):
    """``(Zl, Y, X)`` of a window of ``v_ext.shape[0] = Zl + 2h`` planes,
    after checking that it is 3-D, that each of ``others`` has its shape,
    and that rows ``row0 .. row0 + Zl − 1`` lie in a volume of ``z_total``
    rows; raises ``ValueError`` otherwise."""
    if v_ext.dim() != 3:
        raise ValueError("%s: the window units are 3-D, got shape %s"
                         % (name, tuple(v_ext.shape)))
    zl = v_ext.shape[0] - 2 * h
    if zl < 1:
        raise ValueError("%s: a window of %d planes holds no centre plane "
                         "inside its halo of %d" % (name, v_ext.shape[0], h))
    if not 0 <= int(row0) <= int(z_total) - zl:
        raise ValueError("%s: rows %d..%d outside a volume of %d rows"
                         % (name, int(row0), int(row0) + zl - 1,
                            int(z_total)))
    for t in others:
        if t is not None and tuple(t.shape) != tuple(v_ext.shape):
            raise ValueError("%s: shape %s, expected %s"
                             % (name, tuple(t.shape), tuple(v_ext.shape)))
    return (zl,) + tuple(v_ext.shape[1:])


def normal_apply_prepadded(v_ext, taps, inv_h2, rho, row0, z_total):
    """``q = AᵀA v + ρ·DᵀD v`` on a z-window of a sharded volume
    (``blocked.py::make_blocked_normal_operator_prepadded``, :478):
    ``v_ext`` holds the ``Zl`` local planes and ``r`` halo planes on each
    side (``r`` = :func:`prepadded_halo` of the normal ``taps``), wrapped
    in from the neighbouring ranks; ``q`` is ``(Zl, Y, X)``. The z taps
    read the window with no wrap, the x and y taps wrap within each plane,
    and the Laplacian's z term takes its neighbours from the halo rows,
    with the zero-boundary rows only where ``row0 + k`` is 0 or
    ``z_total − 1``."""
    h = prepadded_halo(taps)
    name = "normal_apply_prepadded"
    dims = prepadded_window(name, v_ext, h, row0, z_total)
    if v_ext.device.type == "cpu":
        return normal_apply_prepadded_plain(v_ext, taps, inv_h2, rho, row0,
                                            z_total)
    check_tensors(name, v_ext.shape, v_ext)
    _check_consts(name, v_ext.device, taps)
    lib = build.load()
    out = torch.empty(dims, device=v_ext.device)
    t1, t2 = torch.empty_like(v_ext), torch.empty_like(v_ext)
    counts = build.new_counts(7)
    err = lib.nsol_normal_apply_prepadded(
        build.tensor_ptr(v_ext), build.tensor_ptr(out), build.tensor_ptr(t1),
        build.tensor_ptr(t2), build.tensor_ptr(taps.buf), *taps.lengths,
        float(rho), *spacing3(inv_h2), h, int(row0), int(z_total), *dims,
        build.stream_ptr(v_ext.device), counts)
    build.check(err, name)
    normal_apply_prepadded.launches += counts[6]
    return out


for _f in (normal_apply, cg_step, cg_update, cg_sweep, normal_apply_prepadded):
    _f.launches = 0


# ------------------------------------------- reference-shaped entry points --

def stencils_for(cache, shape, factors, spacing, t):
    """The :class:`Stencils` for ``t``'s device and working dtype (float32
    for a bfloat16 ``t``), built once per solver in ``cache``; raises
    unless ``t`` has the solver's ``shape``."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError("input shape %s, operator built for %s"
                         % (tuple(t.shape), tuple(shape)))
    dtype = torch.float32 if t.dtype == BF16 else t.dtype
    key = (t.device, dtype)
    if key not in cache:
        cache[key] = Stencils(factors, spacing, t.device, dtype)
    return cache[key]


# ----------------------------------------------- the factories' arguments --

#: the TPU kernels' MXU/VMEM schedule options: the port computes the exact
#: f32 result under each default, and refuses any other value
_SCHEDULE = {"block": None, "n_buf": None, "blur_reorder": None,
             "diff_matmul": None, "pipelined_cg": False}
#: storage-precision options of the JAX package's solver factories
STORAGE_KEYS = ("compact_dirs", "io_dtype", "r_dtype", "q_dtype",
                "state_dtype", "compact")


def _dtype_name(value):
    if isinstance(value, torch.dtype):
        return str(value).replace("torch.", "")
    try:
        return np.dtype(value).name
    except TypeError:
        return getattr(value, "__name__", str(value))


def storage_dtype(value, key="dtype"):
    """``None`` (float32 storage) or ``torch.bfloat16`` for a storage dtype
    given as a torch, NumPy or JAX dtype or its name; ``ValueError`` for
    any other."""
    if value is None:
        return None
    name = _dtype_name(value)
    if name == "float32":
        return None
    if name == "bfloat16":
        return BF16
    raise ValueError("%s must be float32 or bfloat16, got %r" % (key, value))


def _exact_precision(value):
    return value in (None, "HIGHEST", "high3") \
        or getattr(value, "name", None) == "HIGHEST"


def check_options(options, ported=(), defaults=None):
    """The one check of a solver factory's JAX-package arguments. Returns
    ``(interpret, storage)``: ``interpret=True`` runs the plain versions;
    ``storage`` maps each option of ``ported`` to its value (a storage
    dtype to ``None`` or ``torch.bfloat16``, ``compact_dirs`` to False,
    True or ``"qf32"``).

    ``dtype`` must be float32 and ``precision`` ``None``, ``"HIGHEST"``
    (or a precision named so) or ``"high3"`` — each gives the exact f32
    arithmetic —, each schedule option its default (``defaults`` overrides
    :data:`_SCHEDULE`): ``ValueError`` otherwise. Any other argument
    raises ``TypeError``."""
    schedule = dict(_SCHEDULE, **(defaults or {}))
    interpret, storage = False, {}
    for key, value in options.items():
        if key == "dtype":
            if _dtype_name(value) != "float32":
                raise ValueError("dtype must be float32 (the CUDA kernels' "
                                 "type), got %r" % (value,))
        elif key == "interpret":
            interpret = bool(value)
        elif key == "precision":
            if not _exact_precision(value):
                raise ValueError("precision=%r: the port computes the exact "
                                 "f32 result, as under 'HIGHEST' and 'high3'"
                                 % (value,))
        elif key in schedule:
            if value != schedule[key]:
                raise ValueError("%s=%r schedules the TPU's matrix unit or "
                                 "VMEM blocks; the port takes its default "
                                 "%r only" % (key, value, schedule[key]))
        elif key in ported:
            if key == "compact_dirs":
                if value not in (False, True, "qf32"):
                    raise ValueError("compact_dirs must be False, True or "
                                     "'qf32', got %r" % (value,))
                storage[key] = value
            else:
                storage[key] = storage_dtype(value, key)
        else:
            raise TypeError("unexpected argument %r" % key)
    return interpret, storage


def make_blocked_normal_operator(shape, cov, alpha_cut=3, spacing=None,
                                 **options):
    """Build ``apply(v, rho) -> AᵀA v + rho·DᵀD v``
    (``nsol_tpu/ops/pallas/blocked.py:402``). Device and working dtype
    follow ``v``. ``io_dtype=bfloat16``: ``v`` is read as bfloat16 and the
    result returned in bfloat16 (float32 sums). ``interpret=True`` runs
    the plain version; the other JAX-package arguments go through
    :func:`check_options`."""
    interpret, opt = check_options(options, ported=("io_dtype",))
    io = opt.get("io_dtype")
    if len(shape) != 3:
        raise ValueError("blocked kernels are 3-D only")
    factors = C.blur_factors(cov, alpha_cut, spacing)
    unit = normal_apply_plain if interpret else normal_apply
    cache = {}

    def apply(v, rho):
        st = stencils_for(cache, shape, factors, spacing, v)
        return unit(_store(v, io), st.normal, st.inv_h2, rho, io_dtype=io)

    return apply


def make_blocked_normal_operator_prepadded(local_shape, cov, alpha_cut=3,
                                           spacing=None, z_total=None,
                                           block=None, dtype=np.float32,
                                           precision="HIGHEST",
                                           interpret=False, vma=None):
    """Build ``apply(v_ext, rho, row0) -> AᵀA v + rho·DᵀD v`` over a
    prepadded z-window of a volume of ``z_total`` rows (default: the local
    extent) — the per-shard apply of the sharded path
    (``nsol_tpu/ops/pallas/blocked.py:478``, the same positional order),
    through :func:`normal_apply_prepadded`. ``v_ext`` is
    ``(Zl + 2·apply.halo, Y, X)`` for ``local_shape = (Zl, Y, X)``;
    ``row0`` the global row of local row 0. ``apply.halo`` is the normal
    taps' z half-width (at least 1), ``apply.block`` the window's ``Zl``
    (the CUDA unit has no z-blocks). ``block`` (the TPU's VMEM block) and
    ``vma`` (JAX's varying-axes type) are accepted and ignored;
    ``dtype``/``precision`` go through :func:`check_options` and
    ``interpret=True`` runs the plain version."""
    interpret, _ = check_options(dict(dtype=dtype, precision=precision,
                                      interpret=interpret))
    local_shape = tuple(int(n) for n in local_shape)
    if len(local_shape) != 3:
        raise ValueError("blocked kernels are 3-D only")
    z_total = local_shape[0] if z_total is None else int(z_total)
    factors = C.blur_factors(cov, alpha_cut, spacing)
    halo = prepadded_halo(Taps([np.convolve(f, f[::-1]) for f in factors],
                               "cpu", torch.float32))
    ext = (local_shape[0] + 2 * halo,) + local_shape[1:]
    unit = normal_apply_prepadded_plain if interpret \
        else normal_apply_prepadded
    cache = {}

    def apply(v_ext, rho, row0):
        st = stencils_for(cache, ext, factors, spacing, v_ext)
        return unit(v_ext, st.normal, st.inv_h2, rho, row0, z_total)

    apply.halo = halo
    apply.block = local_shape[0]
    return apply


def make_blocked_cg_step(shape, cov, alpha_cut=3, spacing=None, **options):
    """Build ``step(r, p, beta, rho) -> (p_new, q, pq)`` with
    ``p_new = r + β·p``, ``q = (AᵀA + ρDᵀD) p_new``, ``pq = Σ p_new·q``
    (``nsol_tpu/ops/pallas/blocked.py:988``); ``pq`` is a 0-dim tensor on
    the device of ``r``. ``io_dtype`` (p, p', q), ``r_dtype`` and
    ``q_dtype`` (bfloat16 or float32) store the vectors as that kernel
    does (:data:`STORAGE`); ``interpret=True`` runs the plain version."""
    interpret, opt = check_options(
        options, ported=("io_dtype", "r_dtype", "q_dtype"))
    io = opt.get("io_dtype")
    # r_dtype/q_dtype None: as io_dtype (a float32 one resolves to None too)
    R = io if options.get("r_dtype") is None else opt["r_dtype"]
    Q = io if options.get("q_dtype") is None else opt["q_dtype"]
    storage = storage_of(*(torch.float32 if d is None else d
                           for d in (R, io, Q)))
    if len(shape) != 3:
        raise ValueError("blocked kernels are 3-D only")
    factors = C.blur_factors(cov, alpha_cut, spacing)
    unit = cg_step_plain if interpret else cg_step
    cache = {}

    def step(r, p, beta, rho):
        st = stencils_for(cache, shape, factors, spacing, r)
        scal = new_scalars(r.device)
        scal[BETA] = beta
        p_new, q = unit(_store(r, R), _store(p, io), scal, st.normal,
                        st.inv_h2, rho, storage=storage)
        return p_new, q, scal[PQ].to(st.dtype)

    return step


def make_blocked_cg_sweep(shape, cov, alpha_cut=3, spacing=None, **options):
    """Build ``sweep(x, r, p, q, a, beta, rho) -> (x', r', q', p', g, pq,
    rq, qq)`` (``nsol_tpu/ops/pallas/blocked.py:1139``): one CG iteration
    per pass through :func:`cg_sweep` — ``r' = r − a·q``,
    ``p' = r' + β·p``, ``q' = (AᵀA + ρDᵀD) p'``, ``x' = x + a·p`` and the
    dots ``g = Σr'²``, ``pq = Σp'q'``, ``rq = Σr'q'``, ``qq = Σq'²``
    (0-dim tensors). ``io_dtype=bfloat16`` stores r, p, q in bfloat16;
    ``interpret=True`` runs the plain version."""
    interpret, opt = check_options(options, ported=("io_dtype",))
    io = opt.get("io_dtype")
    if len(shape) != 3:
        raise ValueError("blocked kernels are 3-D only")
    factors = C.blur_factors(cov, alpha_cut, spacing)
    unit = cg_sweep_plain if interpret else cg_sweep
    cache = {}

    def sweep(x, r, p, q, a, beta, rho):
        st = stencils_for(cache, shape, factors, spacing, x)
        scal = new_scalars(x.device)
        scal[A], scal[BETA] = a, beta
        xo, qo = x.clone(), _store(q, io).clone()
        ro, po = unit(xo, _store(r, io), _store(p, io), qo, scal, st.normal,
                      st.inv_h2, rho)
        return (xo, ro, qo, po) + tuple(scal[k].to(x.dtype)
                                        for k in (GAMMA, PQ, RQ, QQ))

    return sweep


# ------------------------------------- the (z, y)-blocked family (K9, K8) --

def pick_zy_blocks(shape, halo, halo_y=None):
    """``(z_block, y_block)`` of the JAX package's (z, y)-blocked kernels
    for ``shape`` (``nsol_tpu/ops/pallas/blocked.py:841``), or
    ``(None, None)`` where that package takes its 1-D z-blocked family:
    the same criterion (a 3-D shape with ``Y ≥ 512``, ``Y % 128 == 0`` and
    a z axis that splits into ≥ 2 blocks of 32, 16 or 8 no smaller than
    ``halo``), without the TPU's VMEM budget. ``halo``/``halo_y``: the
    normal bands' z and y half-widths. The port routes by it; the CUDA
    kernels tile with their own sizes (``csrc/tiled.cu``)."""
    if len(shape) != 3:
        return None, None
    Z, Y, _ = shape
    if Y < 512 or Y % 128:
        return None, None
    ry = -((-max(halo_y if halo_y is not None else halo, 1)) // 8) * 8
    for Bz in (32, 16, 8):
        if Z % Bz or Z // Bz < 2 or Bz < halo:
            continue
        if 128 < ry or Y // 128 < 2:
            continue
        return Bz, 128
    return None, None


def zy_halos(shape, cov, alpha_cut=3, spacing=None):
    """``(factors, halo, halo_y)``: the blur factors and the z and y
    half-widths of the normal bands (a self-correlated factor of ``L``
    taps spans ``2L − 1``). Raises for a shape that is not 3-D."""
    if len(shape) != 3:
        raise ValueError("blocked kernels are 3-D only")
    factors = C.blur_factors(cov, alpha_cut, spacing)
    return factors, len(factors[0]) - 1, len(factors[1]) - 1


def takes_zy_route(shape, cov, alpha_cut=3, spacing=None, route="apply"):
    """Whether ``shape`` takes the tiled units on ``route`` (``"apply"`` or
    ``"step2d"``, the linear solve's, or ``"robust"``): where the JAX
    package runs it through its (z, y)-blocked kernels
    (:func:`pick_zy_blocks` at the normal bands' halos) and the blur's
    stencils fit the tiled kernels' shared memory
    (:func:`~.tiled.route_fits`), as that package falls back to its 1-D
    kernels where its 2-D ones do not fit."""
    if len(shape) != 3:
        return False
    factors, halo, halo_y = zy_halos(shape, cov, alpha_cut, spacing)
    return pick_zy_blocks(shape, halo, halo_y)[0] is not None \
        and _tiled().route_fits(factors, route)


def resolve_zy_blocks(shape, halo, halo_y, z_block, y_block, what):
    """The JAX package's (z, y) blocks for ``shape``: the explicit ones, the
    rest from :func:`pick_zy_blocks`, checked as that package checks them
    (``ValueError`` where it finds no layout for ``what``). They only
    validate: the CUDA kernels' tiles do not follow them."""
    if z_block is None or y_block is None:
        zb, yb = pick_zy_blocks(shape, halo, halo_y)
        z_block = z_block or zb
        y_block = y_block or yb
    if z_block is None:
        raise ValueError("no 2-D block layout of shape %s for the %s"
                         % (tuple(shape), what))
    Z, Y, _ = shape
    ry = -((-max(halo_y, 1)) // 8) * 8
    Bz, By = int(z_block), int(y_block)
    for n, b, h, name in ((Z, Bz, halo, "z"), (Y, By, ry, "y")):
        if n % b or n // b < 2 or b < h:
            raise ValueError("%s axis %d must split into >=2 blocks of %d >= "
                             "halo %d" % (name, n, b, h))
    if By % 8:
        raise ValueError("y_block must be a multiple of 8")


def _tiled():
    from nsol_tpu_torch.ops.cuda import tiled

    return tiled


def _normal_lengths(factors):
    return [2 * len(f) - 1 for f in factors]


def make_blocked_normal_operator_2d(shape, cov, alpha_cut=3, spacing=None,
                                    z_block=32, y_block=128, **options):
    """Build ``apply(v, rho) -> AᵀA v + rho·DᵀD v`` through the one-pass
    tiled kernel ``normal_apply_zy``
    (``nsol_tpu/ops/pallas/blocked.py:754``). ``z_block``/``y_block`` are
    checked as the JAX package checks them and do not shape the CUDA
    tiles; a blur too wide for the kernel's shared memory raises
    ``ValueError``. Device and working dtype follow ``v``;
    ``io_dtype=bfloat16`` reads ``v`` and returns the result in bfloat16,
    ``interpret=True`` runs the plain version."""
    interpret, opt = check_options(options, ported=("io_dtype",),
                                   defaults={"n_buf": 2})
    io = opt.get("io_dtype")
    factors, halo, halo_y = zy_halos(shape, cov, alpha_cut, spacing)
    resolve_zy_blocks(shape, halo, halo_y, z_block, y_block,
                      "normal operator")
    T = _tiled()
    T.require_fit("normal_apply_zy", _normal_lengths(factors))
    unit = T.normal_apply_zy_plain if interpret else T.normal_apply_zy
    cache = {}

    def apply(v, rho):
        st = stencils_for(cache, shape, factors, spacing, v)
        return unit(_store(v, io), st.normal, st.inv_h2, rho, io_dtype=io)

    return apply


def make_blocked_cg_step_2d(shape, cov, alpha_cut=3, spacing=None,
                            z_block=None, y_block=None, **options):
    """Build ``step(r, p, beta, rho) -> (p_new, q, pq)`` through the
    one-pass tiled kernel ``cg_step_zy``
    (``nsol_tpu/ops/pallas/blocked.py:878``): ``p_new = r + β·p``,
    ``q = (AᵀA + ρDᵀD) p_new``, ``pq = Σ p_new·q`` (a 0-dim tensor on the
    device of ``r``). Raises ``ValueError`` where the JAX package finds no
    (z, y) layout, or the blur is too wide for the kernel's shared
    memory; ``interpret=True`` runs the plain version."""
    interpret, _ = check_options(options)
    factors, halo, halo_y = zy_halos(shape, cov, alpha_cut, spacing)
    resolve_zy_blocks(shape, halo, halo_y, z_block, y_block,
                      "blocked CG step")
    T = _tiled()
    T.require_fit("cg_step_zy", _normal_lengths(factors), nin=2)
    unit = T.cg_step_zy_plain if interpret else T.cg_step_zy
    cache = {}

    def step(r, p, beta, rho):
        st = stencils_for(cache, shape, factors, spacing, r)
        scal = new_scalars(r.device)
        scal[BETA] = beta
        p_new, q = unit(r, p, scal, st.normal, st.inv_h2, rho)
        return p_new, q, scal[PQ].to(r.dtype)

    return step


#: the C solve's CG formulations
_ZY_MODES = ("apply", "step2d")


def _zy_units(plain):
    """The units of the "apply"/"step2d" solve: ``normal_apply_zy``,
    ``cg_step_zy``, ``blur_apply_zy``, ``cg_direction``, ``cg_update`` and
    ``admm_tail`` — the dispatching wrappers, or their plain versions."""
    from nsol_tpu_torch.ops.cuda import fused as F

    T = _tiled()
    if plain:
        return (T.normal_apply_zy_plain, T.cg_step_zy_plain,
                T.blur_apply_zy_plain, T.cg_direction_plain, cg_update_plain,
                F.admm_tail_plain)
    return (T.normal_apply_zy, T.cg_step_zy, T.blur_apply_zy, T.cg_direction,
            cg_update, F.admm_tail)


def _blocked_steps(units, st, b, x0, alpha, rho, iterations, iter_max, mode,
                   storage="exact"):
    """The solve as unit calls — the sequence ``nsol_blocked_admm_solve``
    enqueues in C. ``storage`` (``"apply"`` only): :data:`STORAGE`'s
    ``"exact"``, ``"dirs"`` or ``"state"``."""
    normal, step, blur, direction, update, tail = units
    R, P, Q = STORAGE[storage]
    state = storage == "state"
    tau = float(np.float32(alpha) / np.float32(rho)) \
        if st.dtype == torch.float32 else alpha / rho
    scal = new_scalars(b.device)
    x = x0.clone()
    v = torch.empty((3,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    w = torch.empty_like(v)
    Atb = blur(b, st.blur, st.inv_h2)  # A = Aᵀ
    rhs = tail(x, v, w, Atb, st.inv_h, tau, rho, init=True)
    for _ in range(iterations):
        if mode == "apply":
            # r0 (x read as R) and the first direction p = r, stored as P
            r, p = normal(x, st.normal, st.inv_h2, rho, rhs=rhs, scal=scal,
                          io_dtype=R, p_dtype=P or x.dtype)
            for k in range(iter_max):
                q = normal(p, st.normal, st.inv_h2, rho, scal=scal,
                           io_dtype=Q)
                # bf16 state: the direction takes the unrounded r' (formed
                # again from r, q in cg_direction)
                update(x, r, p, q, scal, store_r=not state)
                if k + 1 < iter_max:
                    direction(p, r, scal, q=q if state else None)
        else:
            r = normal(x, st.normal, st.inv_h2, rho, rhs=rhs, scal=scal)
            p = None
            for k in range(iter_max):
                p, q = step(r, p, scal, st.normal, st.inv_h2, rho,
                            first=(k == 0))
                update(x, r, p, q, scal)
        rhs = tail(x, v, w, Atb, st.inv_h, tau, rho)
    return x


def _blocked_solve_cuda(st, b, x0, alpha, rho, iterations, iter_max, mode,
                        storage="exact"):
    from nsol_tpu_torch.ops.cuda import fused as F

    T = _tiled()
    name = "blocked_admm_solve"
    dims = volume_dims(name, b)
    check_tensors(name, b.shape, b, x0)
    (R, P, Q), sid = storage_ids(storage)
    lib = build.load()
    x = x0.clone()
    vols = [torch.empty(b.shape, dtype=dt, device=b.device)
            for dt in (torch.float32, torch.float32, R, P, P, Q)]
    v = torch.empty((3,) + tuple(b.shape), dtype=b.dtype, device=b.device)
    w = torch.empty_like(v)
    scal = new_scalars(b.device)
    tau = float(np.float32(alpha) / np.float32(rho))
    ta, tn = st.blur.as_volume(), st.normal.as_volume()
    counts, admm_counts = build.new_counts(5), build.new_counts(6)
    err = lib.nsol_blocked_admm_solve(
        build.tensor_ptr(b), build.tensor_ptr(x), build.tensor_ptr(v),
        build.tensor_ptr(w), *[build.tensor_ptr(t) for t in vols],
        build.tensor_ptr(T.tiled_partials(b.device, dims)),
        build.tensor_ptr(scal), build.tensor_ptr(ta.buf), *ta.lengths,
        build.tensor_ptr(tn.buf), *tn.lengths, *spacing3(st.inv_h),
        *spacing3(st.inv_h2), tau, float(rho), int(iterations),
        int(iter_max), _ZY_MODES.index(mode), sid, *dims,
        build.stream_ptr(b.device), counts, admm_counts)
    build.check(err, name)
    for f, n in zip(T.UNITS, counts):
        f.launches += n
    cg_update.launches += admm_counts[2]
    F.admm_tail.launches += admm_counts[3]
    return x


#: ``blocked_admm_solve``'s CG formulations
MODES = ("auto", "sweep", "step", "step2d", "apply")


def blocked_admm_solve(shape, cov, alpha_cut=3, spacing=None, iterations=10,
                       iter_max=10, dtype=np.float32, precision="HIGHEST",
                       block=None, interpret=False, mode="auto",
                       state_dtype=None, compact_dirs=False,
                       blur_reorder="auto"):
    """Build ``solve(b, x0, alpha, rho) -> x``: ADMM TV-L2 deconvolution of
    a 3-D volume past the fused solve's reach
    (``nsol_tpu/ops/pallas/blocked.py:1293``, the same positional order),
    ``admm_solve(minimizer="cg")`` step for step with the TPU kernels'
    guards.

    ``mode``: ``"apply"`` — a CG around the tiled ``normal_apply_zy`` (the
    dot fused into it, ``cg_update``, ``cg_direction``); ``"step2d"`` — the
    tiled ``cg_step_zy`` plus ``cg_update``; ``"step"`` — the 1-D
    ``cg_step`` plus ``cg_update`` (the sequence of
    :func:`~nsol_tpu_torch.ops.cuda.fused.make_fused_admm_solver`);
    ``"sweep"`` — one :func:`cg_sweep` per CG iteration, the scalar
    recurrence between sweeps on the device and the owed ``x += a·p`` after
    the last (``cg_update`` on ``x`` alone); ``"auto"`` — ``"apply"``
    where :func:`takes_zy_route` (the JAX package's pick at 512-wide
    planes, and a blur that fits the tiled kernels' shared memory), else
    ``"step"``, never ``"sweep"`` (the JAX package's VMEM test is not
    reproduced). An explicit ``"apply"``/``"step2d"`` with a blur too
    wide for the tiled kernels raises ``ValueError``. In
    ``"apply"``/``"step2d"`` the one-time ``Aᵀb`` is the tiled
    ``blur_apply_zy`` and the residual of each outer step
    ``normal_apply_zy``; the prox/dual chain is ``admm_tail``.

    Storage, with the reference's guards: ``state_dtype=bfloat16`` keeps
    r, p, q in bfloat16 and reads x as bfloat16 in the outer residual;
    ``compact_dirs=True`` keeps p, q in bfloat16 (``"qf32"``: p alone, in
    "step") with r, x and an exact outer residual in float32. The two
    exclude each other; ``compact_dirs`` with "sweep" and either with
    "step2d" raise ``ValueError``. Every sum is float32 (float64 on the
    device's reductions). ``dtype``, ``precision``, ``block`` and
    ``blur_reorder`` go through :func:`check_options`;
    ``interpret=True`` runs the plain versions.

    Device and dtype follow ``b``: on CUDA one C function
    (``nsol_blocked_admm_solve``, or ``nsol_admm_solve`` for "step" and
    "sweep") enqueues the whole solve (float32); on the CPU the plain
    versions run the same sequence. ``solve.plain`` runs the plain
    versions on any device; ``solve.mode`` is the resolved mode,
    ``solve.storage`` the :data:`STORAGE` mode.
    """
    interpret, opt = check_options(
        dict(dtype=dtype, precision=precision, block=block,
             interpret=interpret, blur_reorder=blur_reorder,
             state_dtype=state_dtype, compact_dirs=compact_dirs),
        ported=("state_dtype", "compact_dirs"),
        defaults={"blur_reorder": "auto"})
    compact_dirs, state = opt["compact_dirs"], opt["state_dtype"]
    shape = tuple(shape)
    factors, halo, halo_y = zy_halos(shape, cov, alpha_cut, spacing)
    if mode not in MODES:
        raise ValueError("mode must be auto/sweep/step/step2d/apply, got %r"
                         % (mode,))
    if compact_dirs and state is not None:
        raise ValueError("compact_dirs and state_dtype are mutually "
                         "exclusive")
    if compact_dirs and mode == "sweep":
        raise ValueError("compact_dirs is not supported for the sweep "
                         "formulation")
    storage = "state" if state is not None else \
        {False: "exact", True: "dirs", "qf32": "qf32"}[compact_dirs]
    zb, _ = pick_zy_blocks(shape, halo, halo_y)
    if mode == "auto":
        mode = "apply" if takes_zy_route(shape, cov, alpha_cut, spacing) \
            else "step"
    if mode == "step2d" and storage != "exact":
        raise ValueError("state_dtype and compact_dirs are not supported "
                         "for mode='step2d'")
    if mode == "step2d" and zb is None:
        raise ValueError("no 2-D block layout of shape %s for mode 'step2d'"
                         % (shape,))
    if mode in _ZY_MODES and not _tiled().route_fits(factors, mode):
        raise ValueError(
            "mode %r: the blur's stencils %s are too wide for the tiled "
            "kernels' shared memory; mode 'step' runs the per-axis units"
            % (mode, tuple(len(f) for f in factors)))
    if mode in ("step", "sweep"):
        from nsol_tpu_torch.ops.cuda import fused as F

        solve = F.linear_admm_solver(shape, cov, alpha_cut, spacing,
                                     iterations, iter_max, storage=storage,
                                     sweep=mode == "sweep")
    else:
        if storage == "qf32":  # the apply's q is stored as its io dtype
            storage = "dirs"
        cache = {}

        def solve(b, x0, alpha, rho):
            st = stencils_for(cache, shape, factors, spacing, b)
            if b.device.type == "cpu":
                return _blocked_steps(_zy_units(False), st, b, x0, alpha,
                                      rho, iterations, iter_max, mode,
                                      storage)
            return _blocked_solve_cuda(st, b, x0, alpha, rho, iterations,
                                       iter_max, mode, storage)

        def plain(b, x0, alpha, rho):
            return _blocked_steps(
                _zy_units(True),
                stencils_for(cache, shape, factors, spacing, b), b, x0,
                alpha, rho, iterations, iter_max, mode, storage)

        solve.plain = plain
    if interpret:
        solve = plain_only(solve)
    solve.mode = mode
    solve.storage = storage
    return solve


def plain_only(solve):
    """``solve`` whose every call runs its plain versions
    (``interpret=True``)."""
    def plain(*args, **kwargs):
        return solve.plain(*args, **kwargs)

    plain.plain = solve.plain
    return plain
