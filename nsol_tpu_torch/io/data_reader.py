"""DataReader: extension-dispatched input (png / mat / nii / nii.gz).

API-parity port of the reference DataReader (nsol/data_reader.py:22-66) with
the SimpleITK/pysitk stack replaced by the zlib-and-numpy PNG reader
(:mod:`nsol_tpu_torch.io.png`, Pillow's ``convert("L")`` semantics),
scipy.io (mat) and the self-contained NIfTI-1 parser. The extension sniff keeps the reference's
``basename.split(".")[1]`` convention (so ``x.nii.gz`` → "nii",
nsol/data_reader.py:27).
"""

import os

import numpy as np
import scipy.io

from nsol_tpu_torch.io import nifti, png

__all__ = ["DataReader"]


class DataReader(object):

    def __init__(self, path_to_file):
        self._path_to_file = path_to_file
        self._file_type = os.path.basename(path_to_file).split(".")[1]
        self._read_data = {
            "png": self._read_data_png,
            "mat": self._read_data_mat,
            "nii": self._read_data_nii,
        }
        self._nda = None
        self._image_nifti = None

    def read_data(self):
        if not os.path.isfile(self._path_to_file):
            raise IOError("Filename '%s' not found" % self._path_to_file)
        if self._file_type not in self._read_data:
            raise IOError("Unsupported file type '%s'" % self._file_type)
        self._read_data[self._file_type]()

    def get_data(self):
        return np.array(self._nda, dtype=np.float64)

    def get_image_nifti(self):
        """Header carrier for round-tripping (reference: get_image_sitk)."""
        return self._image_nifti

    # kept for call-site familiarity with the reference surface
    get_image_sitk = get_image_nifti

    def get_reconstruction_info(self):
        """Spatial metadata dict for the study npz: always ``shape``; for
        nii inputs also ``origin``/``spacing``/``direction`` so the study
        viewer (and downstream consumers like NiftyMIC) can display 3-D
        reconstructions spatially correct — the reference persists the same
        trio (nsol/application/show_parameter_study.py:279-291)."""
        info = {"shape": np.array(np.shape(self._nda))}
        if self._image_nifti is not None:
            info["origin"] = np.asarray(self._image_nifti.get_origin())
            info["spacing"] = np.asarray(self._image_nifti.get_spacing())
            info["direction"] = np.asarray(
                self._image_nifti.get_direction())
        return info

    def _read_data_png(self):
        self._nda = png.read_png(self._path_to_file)

    def _read_data_mat(self):
        dic = scipy.io.loadmat(self._path_to_file)
        ndas = [dic[k] for k in dic.keys()
                if isinstance(dic[k], np.ndarray)
                and not k.startswith("__")]
        if len(ndas) != 1:
            raise IOError("MAT file '%s' must include one array only"
                          % self._path_to_file)
        self._nda = ndas[0]

    def _read_data_nii(self):
        self._image_nifti = nifti.read_nifti(self._path_to_file)
        self._nda = self._image_nifti.data
