"""Tool to smooth data and add noise to it (counterpart of
``nsol_tpu/cli/corrupt_data.py``; reference:
nsol/application/corrupt_data.py:30-91).

Reads an image or volume, blurs it with the wrap Gaussian of ``--blur``
(one σ or one per axis, in voxels; ``--blur 0`` skips it) by the FFT form
on ``--device`` (the card unless ``--device cpu``), in the default dtype,
adds ``Noise(seed=1)`` of the ``--noise`` type at ``--noise-level`` times
the data maximum, and writes the result with the input's NIfTI header.
"""

import numpy as np
import torch

from nsol_tpu_torch.cli.argparser import InputArgparser
from nsol_tpu_torch.defaults import default_dtype
from nsol_tpu_torch.io import DataReader, DataWriter
from nsol_tpu_torch.noise import Noise
from nsol_tpu_torch.ops import conv as C
from nsol_tpu_torch.solvers.base import resolve_device


def blur_cov(blur, ndim):
    """The covariance of ``--blur`` on ``ndim`` axes: ``σ²·I`` from one σ,
    ``diag(σ²)`` from one a axis."""
    blur = np.atleast_1d(blur).astype(np.float64)
    if blur.size == 1:
        return np.diag(np.ones(ndim)) * blur ** 2
    if blur.size == ndim:
        return np.diag(blur ** 2)
    raise IOError("Blur information must be either 1- or d-dimensional")


def corrupt(nda, blur, noise, noise_level, device):
    """The blurred (``blur[0] > 0``) and noisy ``nda`` as a numpy array."""
    blur = np.atleast_1d(blur).astype(np.float64)
    if blur[0] > 0:
        A, _ = C.make_blur_operators(blur_cov(blur, nda.ndim), alpha_cut=3,
                                     shape=nda.shape, method="fft")
        x = torch.as_tensor(np.asarray(nda), dtype=default_dtype(),
                            device=device)
        nda = A(x).cpu().numpy()
    out = Noise(nda, seed=1)
    if noise == "gaussian":
        out.add_gaussian_noise(noise_level=noise_level, sigma=1)
    elif noise == "poisson":
        out.add_poisson_noise(noise_level=noise_level, lmbda=1)
    elif noise == "uniform":
        out.add_uniform_noise(noise_level=noise_level)
    elif noise in ("s&p", "salt_and_pepper"):
        out.add_salt_and_pepper_noise(salt_vs_pepper=0.5, amount=0.1)
    elif noise not in (None, "none", "None"):
        raise IOError("Noise type '%s' not known" % noise)
    return out.get_noisy_data()


def main(argv=None):
    input_parser = InputArgparser(
        description="Tool to smooth data and add noise to it")
    input_parser.add_filename(required=True)
    input_parser.add_result(required=True)
    input_parser.add_noise(default="gaussian")
    input_parser.add_noise_level(default=0.05)
    input_parser.add_blur(default=[1])
    input_parser.add_device(default="cuda")
    args = input_parser.parse_args(argv)
    input_parser.print_arguments(args)
    device = resolve_device(args.device)

    data_reader = DataReader(args.filename)
    data_reader.read_data()
    noisy = corrupt(data_reader.get_data(), args.blur, args.noise,
                    args.noise_level, device)
    DataWriter(noisy, args.result,
               data_reader.get_image_nifti()).write_data()
    return 0


if __name__ == "__main__":
    main()
