"""Interactive 3-D viewing where a viewer is installed (counterpart of
``nsol_tpu/viewer.py``).

The reference hands 3-D reconstructions to ITK-Snap with their spatial
metadata (nsol/application/show_parameter_study.py:279-313,
nsol/application/run_denoising.py:197-248). :func:`try_interactive_3d`
opens them in an ``itksnap`` executable on ``PATH`` or in ``napari`` —
all volumes together, the first as the main image, an optional mask as the
segmentation, the voxel spacing applied — and returns False when neither
is there, so that callers fall back to their headless figures.
"""

import os
import shutil
import subprocess
import tempfile

import numpy as np

from nsol_tpu_torch.io.nifti import write_nifti

__all__ = ["try_interactive_3d"]


def _safe(label):
    return "".join(c if c.isalnum() else "_" for c in str(label))


def try_interactive_3d(volumes, labels, spacing=None, segmentation=None,
                       block=False):
    """Open the 3-D ``volumes`` ((z, y, x) arrays) interactively.

    ``itksnap`` first: the volumes written as float32 NIfTI files into a
    new temporary directory, the first as ``-g``, the rest as ``-o``,
    ``segmentation`` as ``-s`` (the reference viewer's contract); then
    ``napari``. ``spacing`` is the (x, y, z) voxel spacing; ``block`` waits
    for ``itksnap`` to exit. Returns True when a viewer was launched."""
    spacing = (np.ones(3) if spacing is None
               else np.asarray(spacing, dtype=np.float64))

    exe = shutil.which("itksnap")
    if exe:
        tmpdir = tempfile.mkdtemp(prefix="nsol_tpu_torch_view_")
        paths = []
        for vol, lab in zip(volumes, labels):
            path = os.path.join(tmpdir, _safe(lab) + ".nii.gz")
            write_nifti(np.asarray(vol, dtype=np.float32), path,
                        spacing=spacing)
            paths.append(path)
        cmd = [exe, "-g", paths[0]]
        if len(paths) > 1:
            cmd += ["-o"] + paths[1:]
        if segmentation is not None:
            seg_path = os.path.join(tmpdir, "segmentation.nii.gz")
            write_nifti(np.asarray(segmentation, dtype=np.float32), seg_path,
                        spacing=spacing)
            cmd += ["-s", seg_path]
        proc = subprocess.Popen(cmd)
        if block:
            proc.wait()
        return True

    try:
        import napari
    except ImportError:
        return False
    viewer = napari.Viewer()
    scale = spacing[::-1]  # napari's scale is in array (z, y, x) order
    for vol, lab in zip(volumes, labels):
        viewer.add_image(np.asarray(vol), name=str(lab), scale=scale)
    if segmentation is not None:
        viewer.add_labels(np.asarray(segmentation).astype(np.int32),
                          name="mask", scale=scale)
    napari.run()
    return True
