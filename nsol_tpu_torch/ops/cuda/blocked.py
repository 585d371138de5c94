"""Normal-operator apply and CG kernels: counterparts of
``nsol_tpu/ops/pallas/blocked.py``.

Three kernel units (CUDA C++ in ``csrc/admm.cu``), each with its plain
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

``BᵀB`` is the regulariser's normal operator, ``reg="TK1"`` the
zero-boundary Laplacian ``DᵀD`` (TV and TK1) or ``reg="TK0"`` the
identity; the kernels take it as a template parameter of their
epilogues. The CG scalars live in a float64 device tensor ``scal`` (slots
γ, pq, a, β), so a solve never waits for the host. What bounds the kernels on the
H100 is bytes moved (3 passes of ~2 volumes each per apply); see the note
at the top of ``csrc/admm.cu``.

The (z, y)-blocked family of the 512-wide-plane scale path
(``blocked.py:754, 841, 878, 1293``) lives at the end:
:func:`pick_zy_blocks` (the JAX package's routing criterion),
:func:`make_blocked_normal_operator_2d` and :func:`make_blocked_cg_step_2d`
over the one-pass tiled units of :mod:`.tiled` (``csrc/tiled.cu``), and
:func:`blocked_admm_solve`, whose ``"apply"``/``"step2d"`` modes one C
function enqueues (``nsol_blocked_admm_solve``).

A 2-D image runs on CUDA as a ``(1, Y, X)`` volume with z taps ``[1]``
and ``1/h_z = 1/h_z² = 0``, so every z term is an exact zero (the CPU
tests show the plain versions agree bit for bit on both views). Each
wrapper runs the plain version only for CPU tensors; on a CUDA tensor it
launches the kernel (2-D or 3-D float32, contiguous) or raises.
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
           "make_blocked_normal_operator", "make_blocked_cg_step",
           "counted", "check_tensors", "volume_dims", "spacing3",
           "stencils_for",
           "check_options", "pick_zy_blocks", "takes_zy_route", "zy_halos",
           "resolve_zy_blocks",
           "make_blocked_normal_operator_2d",
           "make_blocked_cg_step_2d", "blocked_admm_solve", "REGS", "GAMMA",
           "PQ", "A", "BETA"]

#: slots of the CG scalar tensor
GAMMA, PQ, A, BETA = 0, 1, 2, 3
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
    """CG scalar state (γ, pq, a, β) in float64 on ``device``."""
    return torch.zeros(4, dtype=torch.float64, device=device)


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
                       reg="TK1"):
    """Plain version of :func:`normal_apply`."""
    q = _apply_plain(v, taps, inv_h2, rho, reg)
    if rhs is None:
        return q
    r = rhs - q
    scal[GAMMA] = torch.sum(r * r)
    scal[BETA] = 0.0
    return r


@counted
def cg_step_plain(r, p, scal, taps, inv_h2, rho, first=False, reg="TK1"):
    """Plain version of :func:`cg_step`: returns ``(p', q)`` and sets
    ``scal[PQ]``, ``scal[A]``."""
    p_new = r.clone() if first else r + scal[BETA].to(r.dtype) * p
    q = _apply_plain(p_new, taps, inv_h2, rho, reg)
    pq = torch.sum(p_new * q).to(scal.dtype)
    scal[PQ] = pq
    scal[A] = guarded_ratio(scal[GAMMA], pq)
    return p_new, q


@counted
def cg_update_plain(x, r, p, q, scal):
    """Plain version of :func:`cg_update` (updates x, r, scal in place)."""
    a = scal[A].to(x.dtype)
    x.add_(a * p)
    r.sub_(a * q)
    gamma_new = torch.sum(r * r).to(scal.dtype)
    scal[BETA] = guarded_ratio(gamma_new, scal[GAMMA])
    scal[GAMMA] = gamma_new


# ---------------------------------------------------------------- kernels --

def check_tensors(name, shape, *tensors, device=None):
    """Raise unless every tensor is a contiguous float32 CUDA tensor of
    ``shape``, all on one device (``device``, or the first tensor's)."""
    device = tensors[0].device if device is None else device
    for t in tensors:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError("%s: expected CUDA tensors on one device, got "
                             "%s" % (name, t.device))
        if t.dtype != torch.float32:
            raise ValueError("%s: the CUDA kernel takes float32, got %s"
                             % (name, t.dtype))
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


def _check_consts(name, device, taps=None, scal=None):
    if taps is not None and (taps.buf.device != device
                             or taps.buf.dtype != torch.float32):
        raise ValueError("%s: taps must be float32 on %s" % (name, device))
    if scal is not None and (scal.device != device
                             or scal.dtype != torch.float64
                             or scal.numel() < 4):
        raise ValueError("%s: scal must be float64[4] on %s"
                         % (name, device))


def _partials(device):
    return torch.empty(build.load().nsol_max_blocks(), dtype=torch.float64,
                       device=device)


def normal_apply(v, taps, inv_h2, rho, rhs=None, scal=None, reg="TK1"):
    """``q = Σ-separable wrap conv of v with taps + rho·BᵀB v``; with
    ``rhs`` returns ``rhs − q`` and sets ``scal[GAMMA] = ‖rhs − q‖²``,
    ``scal[BETA] = 0``. ``taps``: a :class:`Taps` (the normal taps, or the
    blur taps with ``rho=0`` for ``Aᵀb``)."""
    if v.device.type == "cpu":
        return normal_apply_plain(v, taps, inv_h2, rho, rhs, scal, reg)
    name = "normal_apply"
    dims = volume_dims(name, v)
    check_tensors(name, v.shape, v, *([rhs] if rhs is not None else []))
    _check_consts(name, v.device, taps, scal)
    if rhs is not None and scal is None:
        raise ValueError("%s: the residual form needs scal" % name)
    lib = build.load()
    out, t1, t2 = (torch.empty_like(v) for _ in range(3))
    partials = _partials(v.device) if rhs is not None else None
    tv = taps.as_volume()
    counts = build.new_counts(5)
    err = lib.nsol_normal_apply(
        build.tensor_ptr(v), build.tensor_ptr(out), build.tensor_ptr(t1),
        build.tensor_ptr(t2), build.tensor_ptr(rhs),
        build.tensor_ptr(partials), build.tensor_ptr(scal),
        build.tensor_ptr(tv.buf), *tv.lengths, float(rho), reg_id(reg),
        *spacing3(inv_h2), *dims, build.stream_ptr(v.device), counts)
    build.check(err, name)
    normal_apply.launches += counts[0]
    return out


def cg_step(r, p, scal, taps, inv_h2, rho, first=False, reg="TK1"):
    """``p' = r + β·p`` (``p' = r`` when ``first``), ``q = M p'`` with
    ``M = taps-conv + ρ·BᵀB``, then ``scal[PQ] = Σ p'·q`` and
    ``scal[A] = γ/pq`` (0 unless pq > 0). Returns ``(p', q)``."""
    if r.device.type == "cpu":
        return cg_step_plain(r, p, scal, taps, inv_h2, rho, first, reg)
    name = "cg_step"
    dims = volume_dims(name, r)
    check_tensors(name, r.shape, r, *([] if first else [p]))
    _check_consts(name, r.device, taps, scal)
    lib = build.load()
    p_new, q, t1, t2 = (torch.empty_like(r) for _ in range(4))
    tv = taps.as_volume()
    counts = build.new_counts(5)
    err = lib.nsol_cg_step(
        build.tensor_ptr(r), None if first else build.tensor_ptr(p),
        build.tensor_ptr(p_new), build.tensor_ptr(q), build.tensor_ptr(t1),
        build.tensor_ptr(t2), build.tensor_ptr(_partials(r.device)),
        build.tensor_ptr(scal), int(bool(first)), build.tensor_ptr(tv.buf),
        *tv.lengths, float(rho), reg_id(reg), *spacing3(inv_h2), *dims,
        build.stream_ptr(r.device), counts)
    build.check(err, name)
    cg_step.launches += counts[1]
    return p_new, q


def cg_update(x, r, p, q, scal):
    """In place: ``x += a·p``, ``r −= a·q`` with ``a = scal[A]``; then
    ``β = ‖r‖²/γ`` (0 unless γ > 0) and ``γ = ‖r‖²``. Elementwise: the
    kernel takes tensors of any shape."""
    if x.device.type == "cpu":
        return cg_update_plain(x, r, p, q, scal)
    name = "cg_update"
    check_tensors(name, x.shape, x, r, p, q)
    _check_consts(name, x.device, scal=scal)
    lib = build.load()
    counts = build.new_counts(5)
    err = lib.nsol_cg_update(
        build.tensor_ptr(x), build.tensor_ptr(r), build.tensor_ptr(p),
        build.tensor_ptr(q), build.tensor_ptr(_partials(x.device)),
        build.tensor_ptr(scal), x.numel(), build.stream_ptr(x.device),
        counts)
    build.check(err, name)
    cg_update.launches += counts[2]


for _f in (normal_apply, cg_step, cg_update):
    _f.launches = 0


# ------------------------------------------- reference-shaped entry points --

def stencils_for(cache, shape, factors, spacing, t):
    """The :class:`Stencils` for ``t``'s device and dtype, built once per
    solver in ``cache``; raises unless ``t`` has the solver's ``shape``."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError("input shape %s, operator built for %s"
                         % (tuple(t.shape), tuple(shape)))
    key = (t.device, t.dtype)
    if key not in cache:
        cache[key] = Stencils(factors, spacing, t.device, t.dtype)
    return cache[key]


def make_blocked_normal_operator(shape, cov, alpha_cut=3, spacing=None):
    """Build ``apply(v, rho) -> AᵀA v + rho·DᵀD v``
    (``nsol_tpu/ops/pallas/blocked.py:402``). Device and dtype follow
    ``v``."""
    if len(shape) != 3:
        raise ValueError("blocked kernels are 3-D only")
    factors = C.blur_factors(cov, alpha_cut, spacing)
    cache = {}

    def apply(v, rho):
        st = stencils_for(cache, shape, factors, spacing, v)
        return normal_apply(v, st.normal, st.inv_h2, rho)

    return apply


def make_blocked_cg_step(shape, cov, alpha_cut=3, spacing=None):
    """Build ``step(r, p, beta, rho) -> (p_new, q, pq)`` with
    ``p_new = r + β·p``, ``q = (AᵀA + ρDᵀD) p_new``, ``pq = Σ p_new·q``
    (``nsol_tpu/ops/pallas/blocked.py:988``); ``pq`` is a 0-dim tensor on
    the device of ``r``."""
    if len(shape) != 3:
        raise ValueError("blocked kernels are 3-D only")
    factors = C.blur_factors(cov, alpha_cut, spacing)
    cache = {}

    def step(r, p, beta, rho):
        st = stencils_for(cache, shape, factors, spacing, r)
        scal = new_scalars(r.device)
        scal[BETA] = beta
        p_new, q = cg_step(r, p, scal, st.normal, st.inv_h2, rho)
        return p_new, q, scal[PQ].to(r.dtype)

    return step


# ------------------------------------- the (z, y)-blocked family (K9, K8) --

#: options of the TPU kernels that schedule its matrix unit or shape its
#: VMEM blocks: the port computes the exact f32 result and refuses them
_MXU_ONLY = ("precision", "block", "blur_reorder", "n_buf")
#: storage-precision options, still to port (ROADMAP Queue 2 K10)
_STORAGE = ("compact_dirs", "io_dtype", "state_dtype")


def check_options(tpu_options):
    """Refuse the JAX package's TPU-only options: ``NotImplementedError``
    naming K10 for a storage-precision one that is set, ``ValueError`` for
    the MXU/VMEM schedule forms, ``TypeError`` for any other."""
    for key, value in tpu_options.items():
        if key in _STORAGE:
            if value is None or value is False:
                continue
            raise NotImplementedError(
                "%s (compact storage) is not ported yet (ROADMAP Queue 2 K10)"
                % key)
        if key not in _MXU_ONLY:
            raise TypeError("unexpected argument %r" % key)
        raise ValueError("%s shapes the TPU kernel's blocks or precision and "
                         "has no counterpart in the port (exact f32 only)"
                         % key)


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
                                    z_block=32, y_block=128, **tpu_options):
    """Build ``apply(v, rho) -> AᵀA v + rho·DᵀD v`` through the one-pass
    tiled kernel ``normal_apply_zy``
    (``nsol_tpu/ops/pallas/blocked.py:754``). ``z_block``/``y_block`` are
    checked as the JAX package checks them and do not shape the CUDA
    tiles; a blur too wide for the kernel's shared memory raises
    ``ValueError``. Device and dtype follow ``v``."""
    check_options(tpu_options)
    factors, halo, halo_y = zy_halos(shape, cov, alpha_cut, spacing)
    resolve_zy_blocks(shape, halo, halo_y, z_block, y_block,
                      "normal operator")
    _tiled().require_fit("normal_apply_zy", _normal_lengths(factors))
    cache = {}

    def apply(v, rho):
        st = stencils_for(cache, shape, factors, spacing, v)
        return _tiled().normal_apply_zy(v, st.normal, st.inv_h2, rho)

    return apply


def make_blocked_cg_step_2d(shape, cov, alpha_cut=3, spacing=None,
                            z_block=None, y_block=None, **tpu_options):
    """Build ``step(r, p, beta, rho) -> (p_new, q, pq)`` through the
    one-pass tiled kernel ``cg_step_zy``
    (``nsol_tpu/ops/pallas/blocked.py:878``): ``p_new = r + β·p``,
    ``q = (AᵀA + ρDᵀD) p_new``, ``pq = Σ p_new·q`` (a 0-dim tensor on the
    device of ``r``). Raises ``ValueError`` where the JAX package finds no
    (z, y) layout, or the blur is too wide for the kernel's shared
    memory."""
    check_options(tpu_options)
    factors, halo, halo_y = zy_halos(shape, cov, alpha_cut, spacing)
    resolve_zy_blocks(shape, halo, halo_y, z_block, y_block,
                      "blocked CG step")
    _tiled().require_fit("cg_step_zy", _normal_lengths(factors), nin=2)
    cache = {}

    def step(r, p, beta, rho):
        st = stencils_for(cache, shape, factors, spacing, r)
        scal = new_scalars(r.device)
        scal[BETA] = beta
        p_new, q = _tiled().cg_step_zy(r, p, scal, st.normal, st.inv_h2, rho)
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


def _blocked_steps(units, st, b, x0, alpha, rho, iterations, iter_max, mode):
    """The solve as unit calls — the sequence ``nsol_blocked_admm_solve``
    enqueues in C."""
    normal, step, blur, direction, update, tail = units
    tau = float(np.float32(alpha) / np.float32(rho)) \
        if st.dtype == torch.float32 else alpha / rho
    scal = new_scalars(b.device)
    x = x0.clone()
    v = torch.empty((3,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    w = torch.empty_like(v)
    Atb = blur(b, st.blur, st.inv_h2)  # A = Aᵀ
    rhs = tail(x, v, w, Atb, st.inv_h, tau, rho, init=True)
    for _ in range(iterations):
        r = normal(x, st.normal, st.inv_h2, rho, rhs=rhs, scal=scal)
        if mode == "apply":
            p = r.clone()
            for k in range(iter_max):
                q = normal(p, st.normal, st.inv_h2, rho, scal=scal)
                update(x, r, p, q, scal)
                if k + 1 < iter_max:
                    direction(p, r, scal)
        else:
            p = None
            for k in range(iter_max):
                p, q = step(r, p, scal, st.normal, st.inv_h2, rho,
                            first=(k == 0))
                update(x, r, p, q, scal)
        rhs = tail(x, v, w, Atb, st.inv_h, tau, rho)
    return x


def _blocked_solve_cuda(st, b, x0, alpha, rho, iterations, iter_max, mode):
    from nsol_tpu_torch.ops.cuda import fused as F

    T = _tiled()
    name = "blocked_admm_solve"
    dims = volume_dims(name, b)
    check_tensors(name, b.shape, b, x0)
    lib = build.load()
    x = x0.clone()
    vols = [torch.empty_like(b) for _ in range(6)]  # Aᵀb rhs r p0 p1 q
    v = torch.empty((3,) + tuple(b.shape), dtype=b.dtype, device=b.device)
    w = torch.empty_like(v)
    scal = new_scalars(b.device)
    tau = float(np.float32(alpha) / np.float32(rho))
    ta, tn = st.blur.as_volume(), st.normal.as_volume()
    counts, admm_counts = build.new_counts(5), build.new_counts(5)
    err = lib.nsol_blocked_admm_solve(
        build.tensor_ptr(b), build.tensor_ptr(x), build.tensor_ptr(v),
        build.tensor_ptr(w), *[build.tensor_ptr(t) for t in vols],
        build.tensor_ptr(T.tiled_partials(b.device, dims)),
        build.tensor_ptr(scal), build.tensor_ptr(ta.buf), *ta.lengths,
        build.tensor_ptr(tn.buf), *tn.lengths, *spacing3(st.inv_h),
        *spacing3(st.inv_h2), tau, float(rho), int(iterations),
        int(iter_max), _ZY_MODES.index(mode), *dims,
        build.stream_ptr(b.device), counts, admm_counts)
    build.check(err, name)
    for f, n in zip(T.UNITS, counts):
        f.launches += n
    cg_update.launches += admm_counts[2]
    F.admm_tail.launches += admm_counts[3]
    return x


def blocked_admm_solve(shape, cov, alpha_cut=3, spacing=None, iterations=10,
                       iter_max=10, mode="auto", state_dtype=None,
                       compact_dirs=False, **tpu_options):
    """Build ``solve(b, x0, alpha, rho) -> x``: ADMM TV-L2 deconvolution of
    a 3-D volume past the fused solve's reach
    (``nsol_tpu/ops/pallas/blocked.py:1293``), ``admm_solve(minimizer=
    "cg")`` step for step with the TPU kernels' guards.

    ``mode``: ``"apply"`` — a CG around the tiled ``normal_apply_zy`` (the
    dot fused into it, ``cg_update``, ``cg_direction``); ``"step2d"`` — the
    tiled ``cg_step_zy`` plus ``cg_update``; ``"step"`` — the 1-D
    ``cg_step`` plus ``cg_update`` (the sequence of
    :func:`~nsol_tpu_torch.ops.cuda.fused.make_fused_admm_solver`);
    ``"auto"`` — ``"apply"`` where :func:`takes_zy_route` (the JAX
    package's pick at 512-wide planes, and a blur that fits the tiled
    kernels' shared memory), else ``"step"`` (the JAX package's VMEM test
    is not reproduced). An explicit ``"apply"``/``"step2d"`` with a blur
    too wide for the tiled kernels raises ``ValueError``. In
    ``"apply"``/``"step2d"`` the one-time ``Aᵀb`` is the tiled
    ``blur_apply_zy`` and the residual of each outer step ``normal_apply_zy``;
    the prox/dual chain is ``admm_tail``. ``"sweep"`` (K8) and the compact
    storage options (K10) raise ``NotImplementedError``.

    Device and dtype follow ``b``: on CUDA one C function
    (``nsol_blocked_admm_solve``) enqueues the whole solve (float32); on
    the CPU the plain versions run the same sequence. ``solve.plain`` runs
    the plain versions on any device; ``solve.mode`` is the resolved mode.
    """
    check_options(dict(tpu_options, state_dtype=state_dtype,
                       compact_dirs=compact_dirs))
    shape = tuple(shape)
    factors, halo, halo_y = zy_halos(shape, cov, alpha_cut, spacing)
    if mode == "sweep":
        raise NotImplementedError("mode='sweep' (make_blocked_cg_sweep) is "
                                  "not ported yet (ROADMAP Queue 2 K8)")
    if mode not in ("auto", "step", "step2d", "apply"):
        raise ValueError("mode must be auto/sweep/step/step2d/apply, got %r"
                         % (mode,))
    zb, _ = pick_zy_blocks(shape, halo, halo_y)
    if mode == "auto":
        mode = "apply" if takes_zy_route(shape, cov, alpha_cut, spacing) \
            else "step"
    if mode == "step2d" and zb is None:
        raise ValueError("no 2-D block layout of shape %s for mode 'step2d'"
                         % (shape,))
    if mode in _ZY_MODES and not _tiled().route_fits(factors, mode):
        raise ValueError(
            "mode %r: the blur's stencils %s are too wide for the tiled "
            "kernels' shared memory; mode 'step' runs the per-axis units"
            % (mode, tuple(len(f) for f in factors)))
    if mode == "step":
        from nsol_tpu_torch.ops.cuda import fused as F

        solve = F.make_fused_admm_solver(shape, cov, alpha_cut, spacing,
                                         iterations, iter_max)
        solve.mode = mode
        return solve
    cache = {}

    def solve(b, x0, alpha, rho):
        st = stencils_for(cache, shape, factors, spacing, b)
        if b.device.type == "cpu":
            return _blocked_steps(_zy_units(False), st, b, x0, alpha, rho,
                                  iterations, iter_max, mode)
        return _blocked_solve_cuda(st, b, x0, alpha, rho, iterations,
                                   iter_max, mode)

    def plain(b, x0, alpha, rho):
        return _blocked_steps(
            _zy_units(True), stencils_for(cache, shape, factors, spacing, b),
            b, x0, alpha, rho, iterations, iter_max, mode)

    solve.plain = plain
    solve.mode = mode
    return solve
