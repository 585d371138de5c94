"""Normal-operator apply and CG kernels: counterparts of
``nsol_tpu/ops/pallas/blocked.py``.

Three kernel units (CUDA C++ in ``csrc/admm.cu``), each with its plain
PyTorch version beside it and a launch counter on its wrapper:

* :func:`normal_apply` — ``q = AᵀA v + ρ·DᵀD v``; replaces
  ``blocked.py::make_blocked_normal_operator`` (:402) and the in-kernel
  ``conv_all``/``lap`` of ``fused.py`` (:467-496). With ``rhs`` it returns
  the CG residual ``rhs − q`` and sets ``γ = ‖rhs − q‖²``, ``β = 0``.
* :func:`cg_step` — ``p' = r + β·p ; q = M p' ; pq = Σ p'·q`` and
  ``a = γ/pq`` (guarded); replaces ``blocked.py::make_blocked_cg_step``
  (:988).
* :func:`cg_update` — ``x += a·p' ; r −= a·q ; γ' = ‖r‖²`` and
  ``β = γ'/γ`` (guarded): the x/r update and the second reduction of the
  in-kernel CG (``fused.py:365-374``).

The CG scalars live in a float64 device tensor ``scal`` (slots γ, pq, a,
β), so a solve never waits for the host. What bounds the kernels on the
H100 is bytes moved (3 passes of ~2 volumes each per apply); see the note
at the top of ``csrc/admm.cu``.

Each wrapper runs the plain version only for CPU tensors; on a CUDA tensor
it launches the kernel (3-D float32, contiguous) or raises.
"""

import numpy as np
import torch

from nsol_tpu_torch.ops import conv as C
from nsol_tpu_torch.ops import grad as G
from nsol_tpu_torch.ops.cuda import build
from nsol_tpu_torch.solvers.cg import guarded_ratio

__all__ = ["Stencils", "new_scalars", "normal_apply", "normal_apply_plain",
           "cg_step", "cg_step_plain", "cg_update", "cg_update_plain",
           "make_blocked_normal_operator", "make_blocked_cg_step",
           "check_tensors", "check_volume", "stencils_for", "GAMMA", "PQ", "A", "BETA"]

#: slots of the CG scalar tensor
GAMMA, PQ, A, BETA = 0, 1, 2, 3


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


def _apply_plain(v, taps, inv_h2, rho):
    return _blur_plain(v, taps) + rho * _laplacian(v, inv_h2)


def normal_apply_plain(v, taps, inv_h2, rho, rhs=None, scal=None):
    """Plain version of :func:`normal_apply`."""
    normal_apply_plain.calls += 1
    q = _apply_plain(v, taps, inv_h2, rho)
    if rhs is None:
        return q
    r = rhs - q
    scal[GAMMA] = torch.sum(r * r)
    scal[BETA] = 0.0
    return r


def cg_step_plain(r, p, scal, taps, inv_h2, rho, first=False):
    """Plain version of :func:`cg_step`: returns ``(p', q)`` and sets
    ``scal[PQ]``, ``scal[A]``."""
    cg_step_plain.calls += 1
    p_new = r.clone() if first else r + scal[BETA].to(r.dtype) * p
    q = _apply_plain(p_new, taps, inv_h2, rho)
    pq = torch.sum(p_new * q).to(scal.dtype)
    scal[PQ] = pq
    scal[A] = guarded_ratio(scal[GAMMA], pq)
    return p_new, q


def cg_update_plain(x, r, p, q, scal):
    """Plain version of :func:`cg_update` (updates x, r, scal in place)."""
    cg_update_plain.calls += 1
    a = scal[A].to(x.dtype)
    x.add_(a * p)
    r.sub_(a * q)
    gamma_new = torch.sum(r * r).to(scal.dtype)
    scal[BETA] = guarded_ratio(gamma_new, scal[GAMMA])
    scal[GAMMA] = gamma_new


for _f in (normal_apply_plain, cg_step_plain, cg_update_plain):
    _f.calls = 0


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


def check_volume(name, v):
    """Raise unless ``v`` is a 3-D volume: the CUDA path is 3-D only (a 2-D
    image cannot run as (1, Y, X): the z Laplacian's first-row rule would
    give x[0] there, not 0)."""
    if v.dim() != 3:
        raise ValueError("%s: the CUDA kernel is 3-D only, got shape %s"
                         % (name, tuple(v.shape)))


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


def normal_apply(v, taps, inv_h2, rho, rhs=None, scal=None):
    """``q = Σ-separable wrap conv of v with taps + rho·DᵀD v``; with
    ``rhs`` returns ``rhs − q`` and sets ``scal[GAMMA] = ‖rhs − q‖²``,
    ``scal[BETA] = 0``. ``taps``: a :class:`Taps` (the normal taps, or the
    blur taps with ``rho=0`` for ``Aᵀb``)."""
    if v.device.type == "cpu":
        return normal_apply_plain(v, taps, inv_h2, rho, rhs, scal)
    name = "normal_apply"
    check_volume(name, v)
    check_tensors(name, v.shape, v, *([rhs] if rhs is not None else []))
    _check_consts(name, v.device, taps, scal)
    if rhs is not None and scal is None:
        raise ValueError("%s: the residual form needs scal" % name)
    lib = build.load()
    out, t1, t2 = (torch.empty_like(v) for _ in range(3))
    partials = _partials(v.device) if rhs is not None else None
    counts = build.new_counts(4)
    Z, Y, X = v.shape
    err = lib.nsol_normal_apply(
        build.tensor_ptr(v), build.tensor_ptr(out), build.tensor_ptr(t1),
        build.tensor_ptr(t2), build.tensor_ptr(rhs),
        build.tensor_ptr(partials), build.tensor_ptr(scal),
        build.tensor_ptr(taps.buf), *taps.lengths, float(rho), *inv_h2,
        Z, Y, X, build.stream_ptr(v.device), counts)
    build.check(err, name)
    normal_apply.launches += counts[0]
    return out


def cg_step(r, p, scal, taps, inv_h2, rho, first=False):
    """``p' = r + β·p`` (``p' = r`` when ``first``), ``q = M p'``, then
    ``scal[PQ] = Σ p'·q`` and ``scal[A] = γ/pq`` (0 unless pq > 0).
    Returns ``(p', q)``."""
    if r.device.type == "cpu":
        return cg_step_plain(r, p, scal, taps, inv_h2, rho, first)
    name = "cg_step"
    check_volume(name, r)
    check_tensors(name, r.shape, r, *([] if first else [p]))
    _check_consts(name, r.device, taps, scal)
    lib = build.load()
    p_new, q, t1, t2 = (torch.empty_like(r) for _ in range(4))
    counts = build.new_counts(4)
    Z, Y, X = r.shape
    err = lib.nsol_cg_step(
        build.tensor_ptr(r), None if first else build.tensor_ptr(p),
        build.tensor_ptr(p_new), build.tensor_ptr(q), build.tensor_ptr(t1),
        build.tensor_ptr(t2), build.tensor_ptr(_partials(r.device)),
        build.tensor_ptr(scal), int(bool(first)), build.tensor_ptr(taps.buf),
        *taps.lengths, float(rho), *inv_h2, Z, Y, X,
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
    counts = build.new_counts(4)
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
