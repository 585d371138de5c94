"""DataWriter: extension-dispatched output (txt / png / mat / nii / nii.gz).

API-parity port of the reference DataWriter (nsol/data_writer.py:21-71):
png output is uint8-rounded (:53-55) and written by the zlib-and-numpy
encoder of :mod:`nsol_tpu_torch.io.png` as 8-bit grayscale, nii output copies the header of the
originally read image when given (:65-71).
"""

import os

import numpy as np
import scipy.io

from nsol_tpu_torch.io import nifti, png

__all__ = ["DataWriter"]


class DataWriter(object):

    def __init__(self, nda, path_to_file, image_nifti=None):
        self._nda = np.asarray(nda)
        self._path_to_file = path_to_file
        self._image_nifti = image_nifti
        self._file_type = os.path.basename(path_to_file).split(".")[1]
        self._write_data = {
            "txt": self._write_data_txt,
            "png": self._write_data_png,
            "mat": self._write_data_mat,
            "nii": self._write_data_nii,
        }

    def write_data(self):
        d = os.path.dirname(self._path_to_file)
        if d:
            os.makedirs(d, exist_ok=True)
        if self._file_type not in self._write_data:
            raise IOError("Unsupported file type '%s'" % self._file_type)
        self._write_data[self._file_type]()
        print("--- File written to '%s'" % self._path_to_file)

    def _write_data_png(self):
        nda = np.round(np.array(self._nda)).astype(np.uint8)
        png.write_png(nda, self._path_to_file)

    def _write_data_txt(self):
        np.savetxt(self._path_to_file, np.atleast_1d(self._nda))

    def _write_data_mat(self):
        scipy.io.savemat(self._path_to_file, {"nda": self._nda})

    def _write_data_nii(self):
        nifti.write_nifti(self._nda, self._path_to_file,
                          like=self._image_nifti)
