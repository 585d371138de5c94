"""The ADMM study's in-solve L-curve records: counterpart of the
``record=True`` branch of ``nsol_tpu/ops/pallas/fused.py::
make_fused_admm_solver`` (``write_measures``, :624-638, 653-654).

One kernel unit (CUDA C++ in ``csrc/admm.cu``), with its plain PyTorch
version beside it and a launch counter on its wrapper:

* :func:`admm_record` — row ``t`` of the records of an iterate ``x``:
  ``Reg = Σ √(Σ_i (D_i x / h_i)²)`` (isotropic TV, zero-boundary forward
  differences) and ``Data = ½ Σ ρ_C(r²)`` with ``r = A x − b`` and the
  loss's value ``ρ_C`` (``nsol_tpu/ops/losses.py``) at a runtime scale
  ``C``. Per-voxel terms in float32, sums in float64 with a deterministic
  two-stage reduction, into float64 ``reg``/``data`` buffers.

Bytes bound it (a blur chain of ``x`` and one pass over ``x`` for the TV);
the linear and robust solves of ``csrc/admm.cu``/``csrc/robust.cu`` run it
once for ``x0`` and once per outer iteration.
"""

import torch

from nsol_tpu_torch.ops import grad as G
from nsol_tpu_torch.ops import losses
from nsol_tpu_torch.ops.cuda import blocked as B
from nsol_tpu_torch.ops.cuda import build

__all__ = ["admm_record", "admm_record_plain", "LOSS_IDS", "new_records"]

#: data losses by the index the kernels take (``Loss`` of ``csrc/losses.cuh``)
LOSS_IDS = tuple(losses.LOSSES)


def new_records(rows, device):
    """Empty float64 ``(reg, data)`` record buffers of ``rows`` rows."""
    reg = torch.empty(rows, dtype=torch.float64, device=device)
    return reg, torch.empty_like(reg)


def admm_record_plain(x, b, taps, inv_h, loss, scale, reg, data, t):
    """Plain version of :func:`admm_record`."""
    admm_record_plain.calls += 1
    nd = x.dim()
    g2 = None
    for i in range(nd):
        g = G.forward_difference(x, nd - 1 - i) * inv_h[i]
        g2 = g * g if g2 is None else g2 + g * g
    r = B._blur_plain(x, taps) - b
    c = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    reg[t] = torch.sqrt(g2).double().sum()
    data[t] = 0.5 * losses.LOSSES[loss](r * r, f_scale=c).double().sum()


admm_record_plain.calls = 0


def admm_record(x, b, taps, inv_h, loss, scale, reg, data, t):
    """Write row ``t`` of the L-curve records of ``x`` into the float64
    buffers ``reg`` and ``data``: ``Reg = Σ √(Σ_i (D_i x/h_i)²)``,
    ``Data = ½ Σ ρ_C((A x − b)²)`` for the named ``loss`` at ``C = scale``.
    ``taps``: the blur :class:`~blocked.Taps`; ``inv_h``: ``1/h`` in
    (x, y[, z]) order."""
    if loss not in LOSS_IDS:
        raise ValueError("unknown data loss %r" % (loss,))
    if x.device.type == "cpu":
        return admm_record_plain(x, b, taps, inv_h, loss, scale, reg, data, t)
    name = "admm_record"
    dims = B.volume_dims(name, x)
    B.check_tensors(name, x.shape, x, b)
    B._check_consts(name, x.device, taps)
    for buf in (reg, data):
        if (buf.device != x.device or buf.dtype != torch.float64
                or not buf.is_contiguous() or buf.dim() != 1):
            raise ValueError("%s: records must be contiguous 1-D float64 "
                             "tensors on %s" % (name, x.device))
    if reg.shape != data.shape or not 0 <= t < reg.shape[0]:
        raise ValueError("%s: row %d outside the records %s"
                         % (name, t, tuple(reg.shape)))
    lib = build.load()
    t1, t2 = torch.empty_like(x), torch.empty_like(x)
    tv = taps.as_volume()
    counts = build.new_counts(5)
    err = lib.nsol_admm_record(
        build.tensor_ptr(x), build.tensor_ptr(b), build.tensor_ptr(t1),
        build.tensor_ptr(t2), build.tensor_ptr(rec_partials(x.device)),
        build.tensor_ptr(reg), build.tensor_ptr(data), int(t),
        build.tensor_ptr(tv.buf), *tv.lengths, LOSS_IDS.index(loss),
        float(scale), *B.spacing3(inv_h), *dims, build.stream_ptr(x.device),
        counts)
    build.check(err, name)
    admm_record.launches += counts[4]


admm_record.launches = 0


def rec_partials(device):
    """Scratch of the record unit: the data and the TV partials."""
    return torch.empty(2 * build.load().nsol_max_blocks(),
                       dtype=torch.float64, device=device)
