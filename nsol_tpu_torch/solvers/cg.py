"""Matrix-free CG and CGLS (counterpart of ``nsol_tpu/solvers/cg.py``:
``cg``, ``cgls`` and ``tree_vdot``).

Fixed trip count, the reference's zero-guards, and no host synchronization:
the scalars stay 0-dim tensors on the device and the guards are
``torch.where`` selections, so a solve on the GPU never waits for the host.

``reduce`` plays the role of the reference's ``axis_name``: a function of
a 0-dim dot that sums it over the ranks holding the other slabs of a
sharded volume (``Mesh.reduce`` of :mod:`nsol_tpu_torch.parallel`, an
all-reduce that is enqueued on the stream like any kernel).
"""

import torch

__all__ = ["tree_vdot", "guarded_ratio", "cgls", "cg"]


def _leaves(a):
    return list(a) if isinstance(a, (list, tuple)) else [a]


def _tree(fn, *trees):
    """``fn`` leaf by leaf over tensors or equally long tuples of them."""
    if isinstance(trees[0], (list, tuple)):
        return tuple(fn(*leaves) for leaves in zip(*trees))
    return fn(*trees)


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


def cgls(apply_A, apply_At, b, x0, iters, reduce=None):
    """Minimize ``‖A x − b‖²`` from ``x0`` with ``iters`` CGLS steps
    (``nsol_tpu/solvers/cg.py:37-75``), the reference's fixed-trip lsmr.

    ``apply_A`` maps ``x`` to a tensor or a tuple of tensors (the augmented
    system ``(A x, √α·B x)``), ``apply_At`` maps such a tuple back to ``x``;
    ``b`` has ``apply_A``'s structure. The reference's freeze is kept: once
    ``‖Aᵀr‖²`` falls to ``γ0·eps²`` (``eps`` of ``x0``'s dtype) every later
    step is a no-op, which keeps the recurrence from drifting on roundoff
    after convergence. Dots are summed over the ranks by ``reduce``."""
    r = _tree(lambda bi, ai: bi - ai, b, apply_A(x0))
    p = apply_At(r)
    gamma = tree_vdot(p, p, reduce)
    eps = torch.finfo(x0.dtype).eps
    floor = gamma * (eps * eps)
    active = gamma > floor
    x = x0
    for _ in range(iters):
        q = apply_A(p)
        qq = tree_vdot(q, q, reduce)
        ok = active & (qq > 0)
        alpha = torch.where(ok, guarded_ratio(gamma, qq),
                            torch.zeros_like(gamma))
        x = x + alpha * p
        r = _tree(lambda ri, qi: ri - alpha * qi, r, q)
        s = apply_At(r)
        gamma_new = tree_vdot(s, s, reduce)
        beta = torch.where(ok, guarded_ratio(gamma_new, gamma),
                           torch.zeros_like(gamma))
        p = s + beta * p
        active = active & (gamma_new > floor)
        gamma = gamma_new
    return x


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
