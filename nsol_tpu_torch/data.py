"""Benchmark/test input resolution and the stand-in inputs (counterpart of
``nsol_tpu/data.py``).

The deterministic stand-in set (an analytic 3-D Shepp-Logan phantom and
seeded synthetic photographs, with their noisy and blurred-noisy
observations) lives under ``<repo>/.generated_data``, where it is tracked;
``$NSOL_TPU_DATA_DIR`` overrides the directory, as in the reference.
:func:`data_dir` generates whatever is missing there, and
:func:`generate_standalone_data` writes the set with numpy, scipy and the
port's own PNG and NIfTI writers (no Pillow). The files reproduce the
reference's frozen content hashes (:data:`CONTENT_SHA256`, a copy of
``nsol_tpu/data.py:54-73``: the SHA-256 of the decoded uint8 pixels of a
PNG, of the float32 voxels of the NIfTI), which
:func:`verify_standalone_data` checks.
"""

import hashlib
import os

import numpy as np

__all__ = ["data_dir", "path", "generate_standalone_data",
           "verify_standalone_data", "shepp_logan_3d", "CONTENT_SHA256"]

_FILES = (
    "2D_BrainWeb.png",
    "2D_Cameraman_256.png",
    "2D_House_256.png",
    "2D_Lena_256.png",
    "2D_Lena_256_blur_noise.png",
    "2D_Lena_256_noise.png",
    "2D_Lena_512.png",
    "2D_Man_1024.png",
    "3D_SheppLoganPhantom_64.nii.gz",
)

#: frozen content hashes of the stand-ins (``nsol_tpu/data.py:54-73``)
CONTENT_SHA256 = {
    "2D_BrainWeb.png":
        "9c0c61a7ac7b1958e5c01216adfac08451875ab9727536ab1852a555bfb2cc66",
    "2D_Cameraman_256.png":
        "45613fe71675ed489f022edbf07eb15f4a00b1e4f06bb7f5befc05154a81f504",
    "2D_House_256.png":
        "efb061c7b4844c42299ac884d143837531feb075aa491433a38c5bdfa5e3d6ab",
    "2D_Lena_256.png":
        "9224663a0b245b6b43e1be2bf4221f48594a787d954fc7591bca9837ca3b6db6",
    "2D_Lena_256_blur_noise.png":
        "319569d40862883d4fb0742c48a68a498f37c4a3f59ca5dc37ece9576f497a3e",
    "2D_Lena_256_noise.png":
        "a372bab42cb82ebda373c878e52fb1f0fd2ef561790f99bc9b28702cafe2bd9c",
    "2D_Lena_512.png":
        "fd96f2f3742899a8e5d2e138d9f4d858f72674ce8da7e2c18ea4baf362cfbbbb",
    "2D_Man_1024.png":
        "69fdf13253d6309b97ef7d4be93fc6c67038844df478a3fbe35cecce923b6a69",
    "3D_SheppLoganPhantom_64.nii.gz":
        "4ad12df223864d4f4f9f248721b492b77db6d731ba640edb7455368916725696",
}


def _content_hash(file_path):
    if file_path.endswith(".png"):
        from nsol_tpu_torch.io.png import read_png

        arr = np.ascontiguousarray(read_png(file_path), dtype=np.uint8)
    else:
        from nsol_tpu_torch.io.nifti import read_nifti

        arr = np.ascontiguousarray(
            np.asarray(read_nifti(file_path).data, np.float32))
    return hashlib.sha256(arr.tobytes()).hexdigest()


def verify_standalone_data(directory):
    """Check every stand-in in ``directory`` against its frozen content
    hash; raises ``RuntimeError`` on drift."""
    for name, want in CONTENT_SHA256.items():
        got = _content_hash(os.path.join(directory, name))
        if got != want:
            raise RuntimeError(
                "Generated stand-in '%s' does not match its frozen content "
                "hash (%s != %s): the generator pipeline (numpy/scipy) "
                "drifted, so the recorded standalone objectives no longer "
                "anchor." % (name, got, want))


def data_dir():
    """Directory holding the benchmark inputs, with the missing stand-ins
    generated into ``.generated_data`` (a no-op while they are there)."""
    override = os.environ.get("NSOL_TPU_DATA_DIR")
    if override:
        return override
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".generated_data")
    generate_standalone_data(out)
    return out


def path(name):
    """Absolute path of one named benchmark input; raises if it is missing."""
    full = os.path.join(data_dir(), name)
    if not os.path.isfile(full):
        raise FileNotFoundError(
            "benchmark input '%s' not found; the stand-ins are generated "
            "under .generated_data (or set NSOL_TPU_DATA_DIR)" % full)
    return full


# ---------------------------------------------------------------------------
# Deterministic stand-in generation (nsol_tpu/data.py:124-240)
# ---------------------------------------------------------------------------

#: 3-D Shepp-Logan ellipsoids: (density, a, b, c, x0, y0, z0, phi_deg),
#: semi-axes and centres in [-1, 1] coordinates, phi a rotation about z
#: (the modified-contrast table of the standard phantom3d generators)
_SHEPP_LOGAN_3D = (
    (1.00, 0.6900, 0.920, 0.810, 0.00, 0.000, 0.00, 0.0),
    (-0.80, 0.6624, 0.874, 0.780, 0.00, -0.0184, 0.00, 0.0),
    (-0.20, 0.1100, 0.310, 0.220, 0.22, 0.000, 0.00, -18.0),
    (-0.20, 0.1600, 0.410, 0.280, -0.22, 0.000, 0.00, 18.0),
    (0.10, 0.2100, 0.250, 0.410, 0.00, 0.350, -0.15, 0.0),
    (0.10, 0.0460, 0.046, 0.050, 0.00, 0.100, 0.25, 0.0),
    (0.10, 0.0460, 0.046, 0.050, 0.00, -0.100, 0.25, 0.0),
    (0.10, 0.0460, 0.023, 0.050, -0.08, -0.605, 0.00, 0.0),
    (0.10, 0.0230, 0.023, 0.020, 0.00, -0.606, 0.00, 0.0),
    (0.10, 0.0230, 0.046, 0.020, 0.06, -0.605, 0.00, 0.0),
)


def shepp_logan_3d(n=64):
    """Analytic 3-D Shepp-Logan phantom on an n-cubed grid, scaled to
    [0, 255] like the reference's bundled volume."""
    axis = (np.arange(n) + 0.5) / n * 2.0 - 1.0
    z, y, x = np.meshgrid(axis, axis, axis, indexing="ij")
    vol = np.zeros((n, n, n))
    for rho, a, b, c, x0, y0, z0, phi in _SHEPP_LOGAN_3D:
        t = np.deg2rad(phi)
        xr = (x - x0) * np.cos(t) + (y - y0) * np.sin(t)
        yr = -(x - x0) * np.sin(t) + (y - y0) * np.cos(t)
        zr = z - z0
        vol += rho * ((xr / a) ** 2 + (yr / b) ** 2 + (zr / c) ** 2 <= 1.0)
    vol = np.clip(vol, 0.0, None)
    return (vol / vol.max() * 255.0) if vol.max() > 0 else vol


def _synthetic_photo(n, seed):
    """Deterministic structured grayscale image in [0, 255]: smooth
    low-frequency shading, piecewise-constant ellipses and blocks (the
    edges TV regularizers act on) and mild high-frequency texture."""
    import scipy.ndimage as ndi

    rng = np.random.RandomState(seed)
    base = ndi.gaussian_filter(rng.rand(n, n), n / 12.0)
    img = (base - base.min()) / (np.ptp(base) + 1e-12)

    yy, xx = np.mgrid[0:n, 0:n] / float(n)
    for _ in range(12):  # flat ellipses: sharp TV-friendly boundaries
        cy, cx = rng.rand(2)
        ry, rx = 0.05 + 0.2 * rng.rand(2)
        t = rng.rand() * np.pi
        yr = (yy - cy) * np.cos(t) + (xx - cx) * np.sin(t)
        xr = -(yy - cy) * np.sin(t) + (xx - cx) * np.cos(t)
        mask = (yr / ry) ** 2 + (xr / rx) ** 2 <= 1.0
        img[mask] = 0.15 + 0.7 * rng.rand()
    for _ in range(6):  # axis-aligned blocks
        y0, x0 = (rng.rand(2) * 0.8 * n).astype(int)
        h, w = (0.05 * n + rng.rand(2) * 0.15 * n).astype(int)
        img[y0:y0 + h, x0:x0 + w] = 0.1 + 0.8 * rng.rand()
    img = img + 0.03 * ndi.gaussian_filter(rng.randn(n, n), 1.5)
    img = np.clip(img, 0.0, 1.0)
    return img * 255.0


def _corrupt(img, blur_sigma=None, noise_level=0.05, seed=1):
    """Observation synthesis: an optional Gaussian blur by
    ``scipy.ndimage.gaussian_filter`` (which the frozen hashes pin), then
    additive Gaussian noise at ``noise_level * data.max()``, clipped to
    [0, 255]."""
    import scipy.ndimage as ndi

    from nsol_tpu_torch.noise import Noise

    out = np.asarray(img, dtype=np.float64)
    if blur_sigma:
        out = ndi.gaussian_filter(out, blur_sigma)
    noise = Noise(out, seed=seed)
    noise.add_gaussian_noise(noise_level=noise_level)
    return np.clip(noise.get_noisy_data(), 0.0, 255.0)


def generate_standalone_data(directory):
    """Write the stand-in set into ``directory`` (files already present are
    kept) and verify it against the frozen hashes. Nothing is imported
    before the check for missing files (the reference imports Pillow
    first; ROADMAP R5)."""
    os.makedirs(directory, exist_ok=True)
    missing = [f for f in _FILES
               if not os.path.isfile(os.path.join(directory, f))]
    if not missing:
        return directory
    from nsol_tpu_torch.io.nifti import write_nifti
    from nsol_tpu_torch.io.png import write_png

    def save_png(name, arr):
        if name in missing:
            write_png(np.round(arr).astype(np.uint8),
                      os.path.join(directory, name))

    lena = _synthetic_photo(256, seed=2026)
    save_png("2D_Lena_256.png", lena)
    save_png("2D_Lena_256_noise.png", _corrupt(lena, noise_level=0.08))
    save_png("2D_Lena_256_blur_noise.png",
             _corrupt(lena, blur_sigma=1.0, noise_level=0.05))
    save_png("2D_Lena_512.png", _synthetic_photo(512, seed=2027))
    save_png("2D_Man_1024.png", _synthetic_photo(1024, seed=2028))
    save_png("2D_Cameraman_256.png", _synthetic_photo(256, seed=2029))
    save_png("2D_House_256.png", _synthetic_photo(256, seed=2030))
    save_png("2D_BrainWeb.png", _synthetic_photo(256, seed=2031))

    name = "3D_SheppLoganPhantom_64.nii.gz"
    if name in missing:
        write_nifti(shepp_logan_3d(64), os.path.join(directory, name),
                    spacing=np.ones(3))
    verify_standalone_data(directory)
    return directory
