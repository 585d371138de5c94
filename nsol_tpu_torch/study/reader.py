"""Read persisted parameter studies back (counterpart of
``nsol_tpu/study/reader.py``; it reads the studies of either package).

Parity port of the reference ReaderParameterStudy
(nsol/reader_parameter_study.py:21-348): regex-discovers measure files,
parses the parameter lines, rebuilds the swept parameter dictionary
(natural-sorted, float-cast when possible), maps parameter tuples to result
rows, builds human-readable labels, and loads measure arrays / the
reconstructions npz.
"""

import os
import re

import numpy as np

from nsol_tpu_torch.natsort import natsorted
from nsol_tpu_torch.study.paths import ParameterStudy
from nsol_tpu_torch.defaults import STUDY_FILE_EXTENSION

__all__ = ["ReaderParameterStudy"]

REGEX_FILENAMES = "[A-Za-z0-9+-_]+"


class ReaderParameterStudy(ParameterStudy):

    def __init__(self, directory, name):
        ParameterStudy.__init__(self, directory, name)
        self._lines_params = None

    def read_study(self):
        if not os.path.isdir(self._directory):
            raise ValueError("Directory '%s' does not exist"
                             % self._directory)
        self._measures = self._get_measure_names()
        if len(self._measures) == 0:
            raise RuntimeError(
                "Directory '%s' holds no measure files for a study named "
                "'%s'" % (self._directory, self._name))
        self._lines_params = self._read_parameter_file_lines()
        self._parameters_dic = self._get_parameters()
        for k, v in self._parameters_dic.items():
            if len(v) == 0:
                raise RuntimeError(
                    "Directory '%s' does not contain suitable parameter "
                    "study info" % self._directory)

    def get_reconstructions(self):
        path = self._get_path_to_file_reconstructions()
        if not os.path.isfile(path):
            raise IOError("File '%s' not available" % path)
        return np.load(path)

    def get_measures(self):
        self._check_that_study_was_read()
        return self._measures

    def get_file_header(self):
        self._check_that_study_was_read()
        with open(self._get_path_to_file_parameters()) as f:
            return f.readlines()[0]

    def get_results(self, measure):
        """(rows = parameter configs) × (cols = iterations) array."""
        return np.loadtxt(self._get_path_to_file_measures(measure),
                          skiprows=2)

    def get_computational_times(self):
        with open(self._get_path_to_file_computational_time()) as f:
            return [line.strip() for line in f.readlines()[2:]]

    def get_parameters(self):
        self._check_that_study_was_read()
        return self._parameters_dic

    def get_parameters_to_line(self):
        self._check_that_study_was_read()
        lines = self._lines_params[1:]
        return {tuple(line.split("\t")): i for i, line in enumerate(lines)}

    def get_parameter_keys(self):
        """The swept parameter names, in stored column order."""
        self._check_that_study_was_read()
        return self._lines_params[0].split("\t")

    def get_lines_to_parameters(self, parameters):
        """Row indices for a 1-D slice of the study grid.

        ``parameters`` fixes every swept key to a scalar except (at most)
        one, given as a sequence of values to walk; returns the
        parameter-file row of each point along that axis. Behavioral
        contract as in the reference reader
        (nsol/reader_parameter_study.py:278-316): callers like the L-curve
        plot use this to slice out the varying-alpha rows.
        """
        self._check_that_study_was_read()
        if parameters.keys() != self._parameters_dic.keys():
            raise ValueError(
                "Parameter slice must name exactly the swept keys of this "
                "study: %s" % sorted(self._parameters_dic))

        sequence_keys = [k for k, v in parameters.items()
                         if isinstance(v, (tuple, list, np.ndarray))]
        for k in sequence_keys:
            if len(parameters[k]) < 2:
                raise ValueError(
                    "Key '%s' holds a length-%d sequence; fixed axes take "
                    "a bare scalar, the varying axis a sequence of >= 2 "
                    "values" % (k, len(parameters[k])))
        if len(sequence_keys) > 1:
            raise ValueError(
                "At most one axis may vary per slice, but sequences were "
                "given for all of %s" % sequence_keys)

        row_of = self.get_parameters_to_line()
        # tuple keys in row_of follow the parameter-file column order
        columns = list(self._parameters_dic.keys())
        if not sequence_keys:
            return np.zeros(0, dtype=int)
        axis = sequence_keys[0]
        rows = np.empty(len(parameters[axis]), dtype=int)
        for i, value in enumerate(parameters[axis]):
            point = tuple(str(value) if k == axis else str(parameters[k])
                          for k in columns)
            rows[i] = row_of[point]
        return rows

    def get_line_to_parameter_labels(self, separator=", ", compact=False):
        self._check_that_study_was_read()
        lines = self._lines_params[1:]
        out = {}
        for i, line in enumerate(lines):
            if compact:
                out[i] = separator.join(line.split("\t"))
            else:
                out[i] = separator.join(
                    "%s=%s" % (k, v) for k, v in
                    zip(self._parameters_dic.keys(), line.split("\t")))
        return out

    # ------------------------------------------------------------------

    def _read_parameter_file_lines(self):
        with open(self._get_path_to_file_parameters()) as f:
            lines = f.readlines()[1:]
        return [re.sub("\n", "", re.sub("## ", "", line)) for line in lines]

    def _get_measure_names(self):
        pattern = (self._name + "_measure_(" + REGEX_FILENAMES + ")[.]"
                   + STUDY_FILE_EXTENSION)
        p = re.compile(pattern)
        return [p.match(f).group(1)
                for f in os.listdir(self._directory) if p.match(f)]

    def _get_parameters(self):
        lines = list(self._lines_params)
        parameters = lines[0].split("\t")
        lines = lines[1:]
        parameters_dic = {}
        for i, parameter in enumerate(parameters):
            vals = list(set(line.split("\t")[i] for line in lines))
            vals = natsorted(vals, key=lambda y: y.lower())
            try:
                vals = sorted(float(v) for v in vals)
            except ValueError:
                pass
            parameters_dic[parameter] = vals
        return parameters_dic

    def _check_that_study_was_read(self):
        if self._lines_params is None:
            raise UnboundLocalError(
                "Parameter information is only available after calling "
                "read_study()")
