"""Data I/O: png / mat / NIfTI read & write (counterpart of
``nsol_tpu/io``). Every format needs numpy, scipy and the standard library
only: PNG through zlib (``io/png.py``), NIfTI through gzip."""

from nsol_tpu_torch.io.data_reader import DataReader
from nsol_tpu_torch.io.data_writer import DataWriter
from nsol_tpu_torch.io.nifti import NiftiImage, read_nifti, write_nifti
from nsol_tpu_torch.io.png import read_png, write_png

__all__ = ["DataReader", "DataWriter", "NiftiImage", "read_nifti",
           "write_nifti", "read_png", "write_png"]
