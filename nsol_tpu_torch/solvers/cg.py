"""Matrix-free CG on the normal equations (counterpart of
``nsol_tpu/solvers/cg.py``: ``cg`` and ``tree_vdot``; ``cgls`` comes with
the Tikhonov engines of a later slice).

Fixed trip count, the reference's zero-guards, and no host synchronization:
the scalars stay 0-dim tensors on the device and the guards are
``torch.where`` selections, so a solve on the GPU never waits for the host.

``reduce`` plays the role of the reference's ``axis_name``: a function of
a 0-dim dot that sums it over the ranks holding the other slabs of a
sharded volume (``Mesh.reduce`` of :mod:`nsol_tpu_torch.parallel`, an
all-reduce that is enqueued on the stream like any kernel).
"""

import torch

__all__ = ["tree_vdot", "guarded_ratio", "cg"]


def _leaves(a):
    return list(a) if isinstance(a, (list, tuple)) else [a]


def tree_vdot(a, b, reduce=None):
    """Σ over all leaves of ``<a_i, b_i>`` (tensors or sequences of them),
    summed over the ranks by ``reduce`` when given."""
    s = sum(torch.sum(x * y) for x, y in zip(_leaves(a), _leaves(b)))
    return s if reduce is None else reduce(s)


def guarded_ratio(num, den):
    """``num / den`` where ``den > 0``, else 0 (the reference's CG guard)."""
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def cg(apply_M, b, x0, iters, reduce=None):
    """Plain CG for SPD ``M x = b`` from ``x0`` with ``iters`` iterations;
    its dots summed over the ranks by ``reduce`` when given."""
    x = x0
    r = b - apply_M(x0)
    p = r
    gamma = tree_vdot(r, r, reduce)
    for _ in range(iters):
        q = apply_M(p)
        alpha = guarded_ratio(gamma, tree_vdot(p, q, reduce))
        x = x + alpha * p
        r = r - alpha * q
        gamma_new = tree_vdot(r, r, reduce)
        beta = guarded_ratio(gamma_new, gamma)
        p = r + beta * p
        gamma = gamma_new
    return x
