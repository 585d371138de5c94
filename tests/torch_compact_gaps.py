"""How far the fused Tikhonov batch's compact solves (bf16 CG directions)
lie apart, on the noisy problems of
``tests/test_torch_tik_persistent.py::test_plain_compact_batch_on_a_noisy_problem``.

For TK0 (6 × 8 × 10) and TK1 (16 × 16), CG 6, each configuration of the
batch (α and C varying), it prints, as fractions of max |x| of the JAX
package's compact solve:

* ``port-jax exact``: the port's plain batch against the JAX package's
  ``make_fused_tikhonov_solver(..., interpret=True)``, exact storage;
* ``port-jax compact``: the same, both compact;
* ``jax compact-exact``, ``port compact-exact``: what compaction moves each
  side's own solve;
* ``jax ulp compact``, ``jax ulp exact``: what moving every value of ``b``
  by one float32 ulp (up) moves the JAX package's own solve.

Run on the CPU, from the repository root::

    python3 tests/torch_compact_gaps.py

It needs jax and torch; pytest does not collect it.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from nsol_tpu.ops.pallas import fused as JF  # noqa: E402
from nsol_tpu_torch import interop  # noqa: E402
from nsol_tpu_torch.ops.cuda import tikhonov as T  # noqa: E402
from test_torch_tik_persistent import (ALPHAS, COMPACT, SCALES,  # noqa: E402
                                       _problem)


def solves(reg):
    shape = (16, 16) if reg == "TK1" else (6, 8, 10)
    b = _problem(shape, 5)
    b_ulp = np.nextafter(b, np.float32(np.inf))
    out = {}
    for name, opt in (("exact", {}), ("compact", COMPACT)):
        kw = dict(reg=reg, iter_max=6, **opt)
        jsolve = JF.make_fused_tikhonov_solver(shape, np.eye(len(shape)),
                                               interpret=True, **kw)
        solve = T.make_fused_tikhonov_solver(shape, np.eye(len(shape)), **kw)
        out["port " + name] = interop.to_numpy(solve(
            interop.to_torch(b, "cpu"), interop.to_torch(b, "cpu"), ALPHAS,
            SCALES))
        for key, rhs in (("jax ", b), ("jax ulp ", b_ulp)):
            out[key + name] = np.stack([
                np.asarray(jsolve(rhs, rhs, a, data_loss_scale=c))
                for a, c in zip(ALPHAS, SCALES)])
    return out


def main():
    pairs = (("port-jax exact", "port exact", "jax exact"),
             ("port-jax compact", "port compact", "jax compact"),
             ("jax compact-exact", "jax compact", "jax exact"),
             ("port compact-exact", "port compact", "port exact"),
             ("jax ulp compact", "jax ulp compact", "jax compact"),
             ("jax ulp exact", "jax ulp exact", "jax exact"))
    for reg in ("TK0", "TK1"):
        out = solves(reg)
        for k, (a, c) in enumerate(zip(ALPHAS, SCALES)):
            scale = np.abs(out["jax compact"][k]).max()
            print("%s alpha %g C %g max|x| %.4g: %s" % (
                reg, a, c, scale, "; ".join(
                    "%s %.3g" % (label, np.abs(out[u][k] - out[v][k]).max()
                                 / scale) for label, u, v in pairs)))


if __name__ == "__main__":
    main()
