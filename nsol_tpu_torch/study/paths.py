"""Path conventions for persisted parameter studies (counterpart of
``nsol_tpu/study/paths.py``).

The same artifact schema as the reference (nsol/parameter_study.py:43-91)
and the JAX package, so that studies written by either package are read by
the other's reader: ``<name>_parameters.txt``, ``<name>_measure_<M>.txt``,
``<name>_computational_time.txt``, ``<name>_reconstructions.npz``.
"""

import os

from nsol_tpu_torch.defaults import STUDY_FILE_EXTENSION

__all__ = ["ParameterStudy"]


class ParameterStudy(object):

    def __init__(self, directory, name):
        self._directory = directory
        self._name = name

    def get_parameter_study_name(self):
        return self._name

    def _get_path_to_file_parameters(self, specifier="_parameters"):
        return os.path.join(
            self._directory,
            self._name + specifier + "." + STUDY_FILE_EXTENSION)

    def _get_path_to_file_measures(self, measure, specifier="_measure_"):
        return os.path.join(
            self._directory,
            self._name + specifier + measure + "." + STUDY_FILE_EXTENSION)

    def _get_path_to_file_computational_time(
            self, specifier="_computational_time"):
        return os.path.join(
            self._directory,
            self._name + specifier + "." + STUDY_FILE_EXTENSION)

    def _get_path_to_file_reconstructions(self, specifier="_reconstructions"):
        return os.path.join(self._directory,
                            self._name + specifier + ".npz")
