"""Bounded L-BFGS for the robust-loss minimizer path (counterpart of
``nsol_tpu/solvers/lbfgs.py``).

The same algorithm, step for step (``lbfgs.py:24-138``): the start point
projected onto the box, a circular history of ``history`` pairs, the
two-loop recursion, the steepest-descent safeguard, projected Armijo
backtracking of at most ``max_backtracks`` halvings, the old point kept
when the search fails, and a pair stored only where ``s·y > 1e-10``.

The gradient is ``torch.autograd.grad`` of the cost on a detached leaf
(the reference's ``jax.value_and_grad``). The reference's
``lax.while_loop`` line search becomes a Python loop that reads one
Armijo test a trial to the host; :data:`HOST_READS` counts those reads.
Every other selection stays on the device (``torch.where``).

``reduce`` plays the reference's ``axis_name``: the cost must already be
the rank-summed scalar (:func:`summed`), and every dot here is summed over
the ranks, so all ranks take identical steps.
"""

import math

import torch

__all__ = ["lbfgs_box", "summed", "HOST_READS"]

#: Armijo tests read to the host by :func:`lbfgs_box` since the process
#: started (one a line-search trial); reset it by ``HOST_READS[0] = 0``
HOST_READS = [0]


class _Summed(torch.autograd.Function):
    """A rank-local cost summed over the ranks; its gradient is the local
    one (every rank's term enters the global cost with weight 1)."""

    @staticmethod
    def forward(ctx, c, reduce):
        return reduce(c.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def summed(c, reduce=None):
    """The scalar ``c`` summed over the ranks by ``reduce`` (``c`` itself
    with none), differentiable with the local gradient."""
    return c if reduce is None else _Summed.apply(c, reduce)


def _project(x, lower, upper):
    if lower == -math.inf and upper == math.inf:
        return x
    return torch.clamp(x, min=None if lower == -math.inf else lower,
                       max=None if upper == math.inf else upper)


def lbfgs_box(cost_fn, x0, lower=-math.inf, upper=math.inf, iters=50,
              history=10, max_backtracks=25, armijo_c=1e-4, tol=0.0,
              reduce=None):
    """Minimize ``cost_fn`` over the box ``[lower, upper]`` from ``x0`` with
    ``iters`` outer iterations.

    ``cost_fn`` maps a tensor shaped like ``x0`` to a 0-dim tensor and must
    be differentiable by autograd. ``reduce`` sums the dots over the ranks
    of a sharded unknown (``x0`` this rank's block; ``cost_fn`` must return
    the rank-summed cost, e.g. through :func:`summed`). ``tol`` is the
    reference's unused argument."""
    lower, upper = float(lower), float(upper)

    def dot(a, b):
        s = torch.sum(a * b)
        return s if reduce is None else reduce(s)

    def value_and_grad(x):
        leaf = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = cost_fn(leaf)
            (g,) = torch.autograd.grad(f, leaf)
        return f.detach(), g

    with torch.no_grad():
        x = _project(x0, lower, upper)
    f, g = value_and_grad(x)
    dtype, device = x.dtype, x.device
    zero = torch.zeros((), dtype=dtype, device=device)
    S = [torch.zeros_like(x) for _ in range(history)]
    Y = [torch.zeros_like(x) for _ in range(history)]
    rho = [zero] * history
    gamma = torch.ones((), dtype=dtype, device=device)

    with torch.no_grad():
        for k in range(iters):
            # two-loop recursion over the circular history
            q = g
            alphas = [zero] * history
            for i in range(history - 1, -1, -1):
                a = torch.where(rho[i] > 0, rho[i] * dot(S[i], q), zero)
                q = q - a * Y[i]
                alphas[i] = a
            r = gamma * q
            for i in range(history):
                b = torch.where(rho[i] > 0, rho[i] * dot(Y[i], r), zero)
                r = r + (alphas[i] - b) * S[i]
            d = -r
            # safeguard: steepest descent where d is no descent direction
            # (the reference's gTd = min(gTd, −g·g) after it is read by
            # nothing, so it is not formed)
            d = torch.where(dot(g, d) < 0, d, -g)

            # projected Armijo backtracking: x(t) = P(x + t d)
            t = 1.0
            xt = _project(x + t * d, lower, upper)
            ft = cost_fn(xt)
            for it in range(max_backtracks):
                HOST_READS[0] += 1
                if not bool(ft > f + armijo_c * dot(g, xt - x)):
                    break
                t *= 0.5
                xt = _project(x + t * d, lower, upper)
                ft = cost_fn(xt)

            # keep the old point where the search did not decrease f
            improved = ft < f
            x_new = torch.where(improved, xt, x)
            f_new = torch.where(improved, ft, f)
            _, g_new = value_and_grad(x_new)

            s = x_new - x
            y = g_new - g
            sy = dot(s, y)
            good = sy > 1e-10
            slot = k % history
            S[slot] = torch.where(good, s, torch.zeros_like(s))
            Y[slot] = torch.where(good, y, torch.zeros_like(y))
            rho[slot] = torch.where(
                good, 1.0 / torch.where(good, sy, torch.ones_like(sy)), zero)
            yy = dot(y, y)
            gamma = torch.where(
                good, sy / torch.where(yy > 0, yy, torch.ones_like(yy)),
                gamma)
            x, f, g = x_new, f_new, g_new
    return x
