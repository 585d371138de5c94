"""Data corruption (noise) tooling (counterpart of ``nsol_tpu/noise.py``).

The reference's Noise class (nsol/noise.py:20-109) with the JAX package's
fix: an explicit generator, ``np.random.RandomState(seed)``, in place of
the reference's global ``np.random.seed``. The draws are numpy's on the
host, so the same seed gives the same noise bit for bit in both packages;
the data may be a numpy array or a tensor (brought to the host).
"""

import numpy as np
import torch

__all__ = ["Noise"]


class Noise(object):

    def __init__(self, data, seed=None):
        self._rng = np.random.RandomState(seed)
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        self._data = np.array(data)

    def get_noisy_data(self):
        return self._data

    def add_gaussian_noise(self, noise_level=0.01, mean=0, sigma=1):
        """Additive Gaussian noise scaled by ``noise_level * data.max()``."""
        self._data = self._data + noise_level * self._data.max() * \
            self._rng.normal(size=self._data.shape, loc=mean, scale=sigma)

    def add_poisson_noise(self, noise_level=0.01, lmbda=1):
        self._data = self._data + noise_level * self._data.max() * \
            self._rng.poisson(size=self._data.shape, lam=lmbda)

    def add_uniform_noise(self, noise_level=0.01):
        self._data = self._data + noise_level * self._data.max() * \
            self._rng.rand(*self._data.shape)

    def add_salt_and_pepper_noise(self, salt_vs_pepper=0.5, amount=0.1):
        """Replace a random ``amount`` of the voxels by the maximum (salt)
        and the minimum (pepper), written through a flat view."""
        val_salt = self._data.max()
        val_pepper = self._data.min()
        shape = self._data.shape
        flat = self._data.reshape(-1)
        size = int(amount * flat.size)
        samples = self._rng.choice(np.arange(flat.size), size=size,
                                   replace=False)
        n_white = int(salt_vs_pepper * samples.size)
        flat[samples[:n_white]] = val_salt
        flat[samples[n_white:]] = val_pepper
        self._data = flat.reshape(*shape)
