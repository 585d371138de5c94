"""Principal component analysis and robust-PCA variants (counterpart of
``nsol_tpu/pca.py``; reference: nsol/principal_component_analysis.py).

* :class:`PrincipalComponentAnalysis`: eigendecomposition of the point
  covariance (``torch.linalg.eigh``), eigenpairs sorted descending, a
  right-handed 3-D frame;
* :class:`AlmRobustPrincipalComponentAnalysis`: inexact augmented-Lagrange
  RPCA ``D = L + S`` with singular-value shrinkage (Candes 2011,
  Algorithm 1), stopping on the host once the residual falls below its
  tolerance (one host read an iteration);
* :class:`AdmmRobustPrincipalComponentAnalysis`: the 3-way ADMM split
  (Frobenius + entrywise L1 + nuclear), its 100 steps run with the
  converged flag held on the device, as the reference's ``lax.scan``.

Each class computes in float64 on its ``device`` (the card unless the
caller passes ``device="cpu"``) and returns numpy arrays. Singular vectors
differ between libraries in sign and order; the shrunk products and the
eigenvalues do not.
"""

import numpy as np
import torch

from nsol_tpu_torch.solvers.base import resolve_device

__all__ = [
    "PrincipalComponentAnalysis",
    "AlmRobustPrincipalComponentAnalysis",
    "AdmmRobustPrincipalComponentAnalysis",
]


def _f64(a, device):
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)


def _numpy(t):
    return t.detach().cpu().numpy()


class PrincipalComponentAnalysis(object):
    """PCA on (n_points, dim) point clouds, dim in {2, 3}."""

    def __init__(self, points, device="cuda"):
        points = np.array(points.detach().cpu() if isinstance(
            points, torch.Tensor) else points)
        if points.ndim != 2 or points.shape[1] not in (2, 3):
            raise IOError("Numpy array must be of shape N x dim, "
                          "with dim either 2 or 3.")
        self._device = resolve_device(device)
        self._points = points
        self._mean = None
        self._cov = None
        self._eigval = None
        self._eigvec = None

    def run(self):
        pts = _f64(self._points, self._device)
        mean = torch.mean(pts, dim=0)
        centred = pts - mean
        # np.cov(rowvar=False) of the centred points: 1/(n−1) normalization
        cov = centred.T @ centred / (pts.shape[0] - 1)
        eigval, eigvec = torch.linalg.eigh(cov)
        idx = torch.argsort(eigval, descending=True)
        eigval, eigvec = eigval[idx], eigvec[:, idx]
        if pts.shape[1] == 3:
            # right-handed frame (reference: pca.py:69)
            eigvec[:, 2] = torch.linalg.cross(eigvec[:, 0], eigvec[:, 1])
        self._mean, self._cov = _numpy(mean), _numpy(cov)
        self._eigval, self._eigvec = _numpy(eigval), _numpy(eigvec)

    def get_mean(self):
        return self._mean

    def get_cov(self):
        return self._cov

    def get_eigvec(self):
        return self._eigvec

    def get_eigval(self):
        return self._eigval

    def show(self, title="PCA", ax=None, step=1, path=None):
        """The principal-axes plot of the reference
        (nsol/principal_component_analysis.py:76-111): the point cloud (every
        ``step``-th point) and one arrow a principal axis, from the mean,
        of length its eigenvalue; 2-D and 3-D. With ``path`` the figure is
        saved there (matplotlib's Agg backend, headless). Returns the axes.
        matplotlib is imported here only."""
        import matplotlib
        if path is not None:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        if self._eigvec is None:
            raise RuntimeError("Run 'run' first")
        dim = self._points.shape[1]
        pts = self._points[::step]

        fig = None
        if ax is None:
            fig = plt.figure(title)
            fig.clf()
            ax = (fig.add_subplot(111, projection="3d") if dim == 3
                  else fig.add_subplot(111))
        axis_colors = ["g", "b", "k"]
        if dim == 3:
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], color="red",
                       marker="x")
            for i in range(3):
                arrow = self._eigval[i] * self._eigvec[:, i]
                ax.quiver(*self._mean, *arrow, color=axis_colors[i],
                          label="eigvec%d" % (i + 1))
        else:
            ax.scatter(pts[:, 0], pts[:, 1], color="red", marker="x")
            for i in range(2):
                arrow = self._eigval[i] * self._eigvec[:, i]
                ax.quiver(self._mean[0], self._mean[1], arrow[0], arrow[1],
                          angles="xy", scale_units="xy", scale=1,
                          color=axis_colors[i], label="eigvec%d" % (i + 1))
            ax.set_aspect("equal")
        ax.set_title(title)
        ax.legend()
        if path is not None and fig is not None:
            fig.savefig(path)
            plt.close(fig)
        return ax


def _soft_shrink(M, tau):
    return torch.sign(M) * torch.clamp(torch.abs(M) - tau, min=0.0)


def _svd_shrink(M, tau):
    U, S, Vt = torch.linalg.svd(M, full_matrices=False)
    return (U * _soft_shrink(S, tau)[None, :]) @ Vt


class AlmRobustPrincipalComponentAnalysis(object):
    """RPCA ``D = L + S`` via inexact ALM."""

    def __init__(self, D, mu=None, lmbda=None, device="cuda"):
        self._device = resolve_device(device)
        self.D = np.asarray(D.detach().cpu() if isinstance(
            D, torch.Tensor) else D, dtype=np.float64)
        self.S = np.zeros(self.D.shape)
        self.Y = np.zeros(self.D.shape)
        if mu:
            self.mu = mu
        else:
            self.mu = np.prod(self.D.shape) / (4 * np.sum(self.D ** 2))
        self.mu_inv = 1.0 / self.mu
        self.lmbda = (lmbda if lmbda
                      else 1.0 / np.sqrt(np.max(self.D.shape)))
        self.L = None

    def fit(self, tol=None, max_iter=1000, iter_print=100):
        D = _f64(self.D, self._device)
        _tol = tol if tol else 1e-7 * float(np.sum(self.D ** 2))
        mu, mu_inv, lmbda = self.mu, self.mu_inv, self.lmbda
        Lk = torch.zeros_like(D)
        Sk, Yk = _f64(self.S, self._device), _f64(self.Y, self._device)
        err, it = np.inf, 0
        while err > _tol and it < max_iter:
            Lk = _svd_shrink(D - Sk + mu_inv * Yk, mu_inv)
            Sk = _soft_shrink(D - Lk + mu_inv * Yk, mu_inv * lmbda)
            Yk = Yk + mu * (D - Lk - Sk)
            err = float(torch.sum(torch.abs(D - Lk - Sk) ** 2))
            it += 1
        print("iteration: {0}, error: {1}".format(it, err))
        self.L = _numpy(Lk)
        self.S = _numpy(Sk)
        return self.L, self.S


class AdmmRobustPrincipalComponentAnalysis(object):
    """RPCA via a 3-way ADMM split: ``A = X1 + X2 + X3`` with Frobenius
    (noise), entrywise-L1 (foreground), nuclear (low-rank background)
    penalties."""

    MAX_ITER = 100
    ABSTOL = 1e-4
    RELTOL = 1e-2

    def __init__(self, D, device="cuda"):
        self._device = resolve_device(device)
        self._data = np.asarray(D.detach().cpu() if isinstance(
            D, torch.Tensor) else D, dtype=np.float64)

    def run(self):
        A = _f64(self._data, self._device)
        m, n = A.shape
        N = 3
        # g2_max = ||Aᵀ||_inf (max column abs sum), g3_max = spectral norm
        # (reference: pca.py:311-314)
        g2 = 0.15 * float(np.linalg.norm(self._data.T, np.inf))
        g3 = 0.15 * float(np.linalg.norm(self._data, 2))
        lambdap = 1.0
        rho = 1.0 / lambdap
        norm = torch.linalg.norm

        X1 = X2 = X3 = U = torch.zeros_like(A)
        z = torch.zeros((m, N * n), dtype=A.dtype, device=A.device)
        done = torch.zeros((), dtype=torch.bool, device=A.device)
        hist = {k: [] for k in ("objval", "r_norm", "s_norm", "eps_pri",
                                "eps_dual", "active")}
        for _ in range(self.MAX_ITER):
            B = (X1 + X2 + X3) / N - A / N + U
            X1n = (1.0 / (1.0 + lambdap)) * (X1 - B)
            X2n = _soft_shrink(X2 - B, lambdap * g2)
            X3n = _svd_shrink(X3 - B, lambdap * g3)
            X1 = torch.where(done, X1, X1n)
            X2 = torch.where(done, X2, X2n)
            X3 = torch.where(done, X3, X3n)

            x = torch.cat([X1, X2, X3], dim=1)
            zold = z
            znew = x + (-(X1 + X2 + X3) / N + A / N).repeat(1, N)
            z = torch.where(done, z, znew)
            U = torch.where(done, U, B)

            r_norm = norm(x - z)
            s_norm = norm(-rho * (z - zold))
            eps_pri = (np.sqrt(m * n * N) * self.ABSTOL
                       + self.RELTOL * torch.maximum(norm(x), norm(z)))
            eps_dual = (np.sqrt(m * n * N) * self.ABSTOL
                        + self.RELTOL * np.sqrt(N) * norm(rho * U))
            conv = (r_norm < eps_pri) & (s_norm < eps_dual)
            objval = (torch.sum(X1 * X1) + g2 * torch.sum(torch.abs(X2))
                      + g3 * torch.sum(torch.abs(torch.linalg.svdvals(X3))))
            for k, v in (("objval", objval), ("r_norm", r_norm),
                         ("s_norm", s_norm), ("eps_pri", eps_pri),
                         ("eps_dual", eps_dual), ("active", ~done)):
                hist[k].append(v)
            done = done | conv

        n_iter = int(torch.sum(torch.stack(hist.pop("active"))))
        h = {k: _numpy(torch.stack(v)) for k, v in hist.items()}
        h["admm_iter"] = max(0, n_iter - 1)
        h["X1_admm"] = _numpy(X1)   # sparse
        h["X2_admm"] = _numpy(X2)   # error/noise
        h["X3_admm"] = _numpy(X3)   # low-rank
        return h
