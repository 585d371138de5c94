"""Halo exchange and sharded stencil operators over ``torch.distributed``
(counterpart of ``nsol_tpu/parallel/halo.py``).

A (z, y[, x]) volume is sharded along its leading axis, one slab a rank
(:class:`~nsol_tpu_torch.parallel.mesh.Mesh`). The forward-difference
stencil exchanges a 1-plane ghost zone with its neighbours, the Gaussian
blur its half-width around a ring (the reference's ``mode="wrap"``), and
every CG dot is all-reduced (``Mesh.reduce``). The reference's
``lax.ppermute`` becomes point-to-point sends and receives
(``batch_isend_irecv``) of the halo planes; a send to this rank itself (the
ring at world size 1, a hop of the world size) is a local copy, since NCCL
refuses a send to the sending rank. A rank with no neighbour receives
zeros, as ``ppermute``'s unaddressed destinations do: the global
zero boundary of the derivative stencils.

Every function takes this rank's block and the mesh; each rank calls it
with its own block.
"""

import numpy as np
import torch
import torch.distributed as tdist

from nsol_tpu_torch.ops import conv as C
from nsol_tpu_torch.ops import grad as G

__all__ = [
    "exchange_plane_up", "exchange_plane_down", "exchange_halo_wrap",
    "make_sharded_gradient_operators", "make_sharded_blur_operators",
    "separable_halo_apply",
]

_NON_SEPARABLE = ("a non-separable (full-covariance) blur is not ported on "
                  "the sharded path (ROADMAP Queue 1 item 8)")


def _sendrecv(mesh, send, dst, src, like):
    """Send ``send`` to rank ``dst`` and return what rank ``src`` sends,
    shaped like ``like`` (zeros where ``src`` is None); either side may be
    None. A message to this rank itself is a copy."""
    out = None
    if src is not None and src == mesh.rank and dst == mesh.rank:
        return send.clone()
    ops = []
    if dst is not None:
        ops.append(tdist.P2POp(tdist.isend, send.contiguous(), dst,
                               group=mesh.group))
    if src is not None:
        out = torch.empty_like(like, memory_format=torch.contiguous_format)
        ops.append(tdist.P2POp(tdist.irecv, out, src, group=mesh.group))
    if ops:
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
    return torch.zeros_like(like) if out is None else out


def exchange_plane_up(x, mesh, axis=0, width=1):
    """Receive the *first* ``width`` planes of the next rank (rank+1). The
    last rank receives zeros (global zero boundary)."""
    planes = x.narrow(axis, 0, width)
    n, k = mesh.size, mesh.rank
    return _sendrecv(mesh, planes, k - 1 if k > 0 else None,
                     k + 1 if k + 1 < n else None, planes)


def exchange_plane_down(x, mesh, axis=0, width=1):
    """Receive the *last* ``width`` planes of the previous rank (rank−1).
    The first rank receives zeros."""
    planes = x.narrow(axis, x.shape[axis] - width, width)
    n, k = mesh.size, mesh.rank
    return _sendrecv(mesh, planes, k + 1 if k + 1 < n else None,
                     k - 1 if k > 0 else None, planes)


def _ring_recv(x, mesh, shift):
    """Receive ``x`` from rank ``(k − shift) mod n`` (ring collective)."""
    n, k = mesh.size, mesh.rank
    return _sendrecv(mesh, x, (k + shift) % n, (k - shift) % n, x)


def exchange_halo_wrap(x, mesh, lo, hi, axis=0):
    """Circular halo: ``cat(prev[lo], x, next[hi])`` along ``axis`` with
    ring wrap-around — the sharded form of the ``mode="wrap"`` blur
    boundary. A halo wider than the local extent takes several hops (hop
    ``h`` brings the block ``h`` ranks away), as the reference's multi-hop
    ``ppermute`` does."""
    local = x.shape[axis]
    parts_lo, remaining, hop = [], lo, 1
    while remaining > 0:
        take = min(remaining, local)
        parts_lo.insert(0, _ring_recv(x.narrow(axis, local - take, take),
                                      mesh, hop))
        remaining -= take
        hop += 1
    parts_hi, remaining, hop = [], hi, 1
    while remaining > 0:
        take = min(remaining, local)
        parts_hi.append(_ring_recv(x.narrow(axis, 0, take), mesh, -hop))
        remaining -= take
        hop += 1
    return torch.cat(parts_lo + [x] + parts_hi, dim=axis)


def make_sharded_gradient_operators(spacing=None, mesh=None, ndim=None):
    """Gradient/divergence pair for blocks sharded along array axis 0: on
    the assembled volume exactly :func:`nsol_tpu_torch.ops.grad.gradient`
    and its adjoint (component order, spacing, zero boundary). ``mesh``
    None: one rank, no exchange."""
    mesh = _mesh_or_single(mesh)

    def grad(x):
        nd = x.ndim
        s = G._spacing_array(spacing, nd)
        comps = []
        for i in range(nd):
            axis = nd - 1 - i
            if axis == 0:
                # D(x)[k] = x[k+1] − x[k]; the last local row needs the
                # next rank's first plane (zeros at the global end)
                nxt = exchange_plane_up(x, mesh)
                d = torch.cat([x[1:], nxt], dim=0) - x
            else:
                d = G.forward_difference(x, axis)
            comps.append(d / float(s[i]))
        return torch.stack(comps, dim=0)

    def grad_adj(g):
        nd = g.ndim - 1
        s = G._spacing_array(spacing, nd)
        out = None
        for i in range(nd):
            axis = nd - 1 - i
            gi = g[i]
            if axis == 0:
                # Dᵀ(y)[k] = y[k−1] − y[k]; the first local row needs the
                # previous rank's last plane (zeros at the global start)
                prv = exchange_plane_down(gi, mesh)
                a = torch.cat([prv, gi[:-1]], dim=0) - gi
            else:
                a = G.forward_difference_adjoint(gi, axis)
            a = a / float(s[i])
            out = a if out is None else out + a
        return out

    return grad, grad_adj


def separable_halo_apply(factors, mesh):
    """Separable wrap convolution of a block sharded along axis 0: the
    ring halo of the axis-0 factor's half-width, its taps read with no
    wrap, then each local axis wrapped in place (``convolve_axis``). The
    factors are 1-D numpy arrays (odd lengths, as every Gaussian factor)."""
    taps = [np.asarray(f, np.float64).tolist() for f in factors]
    t0 = taps[0]
    c = len(t0) // 2
    lo, hi = len(t0) - 1 - c, c

    def apply(x):
        xp = exchange_halo_wrap(x, mesh, lo, hi)
        n = x.shape[0]
        y = None
        for j, t in enumerate(t0):
            # y[i] = Σ_j t[j] x[i + c − j] = Σ_j t[j] xp[i + c − j + lo]
            term = t * xp[c - j + lo:c - j + lo + n]
            y = term if y is None else y + term
        for ax in range(1, x.ndim):
            y = C.convolve_axis(y, taps[ax], ax)
        return y

    return apply


def _factors(cov, alpha_cut, spacing):
    try:
        return C.blur_factors(cov, alpha_cut, spacing)
    except NotImplementedError:
        raise NotImplementedError(_NON_SEPARABLE) from None


def make_sharded_blur_operators(cov, alpha_cut=3, spacing=None, mesh=None,
                                dtype=np.float64):
    """Gaussian blur pair ``(A, A)`` for blocks sharded along array axis 0
    (wrap boundary globally; the stencil is symmetric). Separable blurs
    only: a non-separable one raises ``NotImplementedError`` (ROADMAP
    Queue 1 item 8). ``dtype`` is the reference's kernel dtype; the
    arithmetic follows the block's."""
    A = separable_halo_apply(_factors(cov, alpha_cut, spacing),
                             _mesh_or_single(mesh))
    return A, A


def _mesh_or_single(mesh):
    if mesh is not None:
        return mesh
    from nsol_tpu_torch.parallel.mesh import Mesh

    return Mesh.single("cpu")
