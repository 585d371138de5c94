"""Standalone optimizer entry points (counterpart of ``nsol_tpu/optimize.py``).

The reference's ``Optimize`` is a set of thin static wrappers over
scipy (nsol/optimize.py); the JAX package's, and this one, expose the
library's own solvers under one roof: CGLS for ``lsmr``, CG, the
projected-Newton sweep for ``nnls``, and the box L-BFGS for
``least_squares`` and ``minimize``. Every method runs on the device of
its inputs.
"""

import numpy as np
import torch

from nsol_tpu_torch.solvers.cg import cg as _cg, cgls as _cgls
from nsol_tpu_torch.solvers.lbfgs import lbfgs_box as _lbfgs_box
from nsol_tpu_torch.solvers.tikhonov import tikhonov_solve as _tikhonov_solve

__all__ = ["Optimize"]


class Optimize(object):
    """Static collection mirroring the reference's ``Optimize`` surface."""

    @staticmethod
    def lsmr(A, A_adj, b, x0=None, iter_max=100, reduce=None):
        """Least squares ``min ‖Ax−b‖²`` by fixed-trip CGLS."""
        if x0 is None:
            x0 = torch.zeros_like(A_adj(b))
        return _cgls(A, A_adj, b, x0, iters=iter_max, reduce=reduce)

    @staticmethod
    def cg(M, b, x0=None, iter_max=100, reduce=None):
        """SPD solve ``Mx = b`` by conjugate gradients."""
        if x0 is None:
            x0 = torch.zeros_like(b)
        return _cg(M, b, x0, iters=iter_max, reduce=reduce)

    @staticmethod
    def nnls(A, A_adj, b, x0=None, iter_max=30, cg_iters=8):
        """Non-negative least squares ``min_{x≥0} ½‖Ax−b‖²``: the
        ``minimizer="irls"`` engine with the linear loss, ``iter_max``
        sweeps that freeze the active set and run ``cg_iters`` CG
        iterations on the free variables (``nsol_tpu/optimize.py:41-60``)."""
        if x0 is None:
            x0 = torch.zeros_like(A_adj(b))

        def ident(z):
            return z

        return _tikhonov_solve(
            A, A_adj, ident, ident, b, b_reg=torch.zeros_like(x0), x0=x0,
            alpha=0.0, minimizer="irls", iter_max=iter_max,
            bounds=(0.0, np.inf), irls_cg_iters=cg_iters)

    @staticmethod
    def least_squares(fun, x0, bounds=(-np.inf, np.inf), iter_max=100):
        """Nonlinear least squares ``min ½‖fun(x)‖²`` over a box by the box
        L-BFGS."""
        def cost(x):
            r = fun(x)
            return 0.5 * torch.sum(r * r)

        return _lbfgs_box(cost, x0, lower=bounds[0], upper=bounds[1],
                          iters=iter_max)

    @staticmethod
    def minimize(fun, x0, bounds=None, iter_max=100):
        """Smooth minimization with optional box bounds by the box L-BFGS
        (``fun`` differentiable by autograd)."""
        lo = -np.inf if bounds is None else bounds[0]
        hi = np.inf if bounds is None else bounds[1]
        return _lbfgs_box(fun, x0, lower=lo, upper=hi, iters=iter_max)
