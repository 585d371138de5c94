"""Parameter-study engine: grid sweeps with persisted artifacts
(counterpart of ``nsol_tpu/study/engine.py``).

Parity port of the reference engine (nsol/solver_parameter_study.py:29-335)
with the JAX package's file schema, header validation and append/resume
semantics, so that each package's reader reads the other's studies. When
every swept parameter is a runtime scalar of the solver (the ``alpha×rho``
grid), the whole cartesian product goes to the solver's ``run_sweep`` in
one call (the "vmapped" route: on the GPU the fused kernels' batched
solves, in memory-budgeted chunks, ``solvers/wrappers.py``); a sweep that
also names a string parameter (``data_loss``) runs one such call per
value of it (the "hybrid" route); anything else runs the
reflective-setter serial loop, the reference's ``set_<key>``/``get_<key>``
contract.

With a ``"batch"`` mesh (``mesh=``) the vmapped and hybrid routes split
the grid over the mesh's ranks (``run_sweep(mesh=...)``); the serial route
does not use it, as in the reference. Every rank holds the whole result,
only rank 0 writes the study's files, and every rank waits for the others
at the end of :meth:`SolverParameterStudy.run`, so that a study appended
afterwards reads the same rows on every rank.
"""

import datetime
import itertools
import math
import os
import re

import numpy as np

from nsol_tpu_torch import timer as ph
from nsol_tpu_torch.solvers import wrappers as W
from nsol_tpu_torch.study.paths import ParameterStudy
from nsol_tpu_torch.study.reader import ReaderParameterStudy

__all__ = [
    "SolverParameterStudy", "TikhonovLinearSolverParameterStudy",
    "ADMMLinearSolverParameterStudy", "PrimalDualSolverParameterStudy",
]


def _is_float(s):
    try:
        float(s)
        return True
    except (TypeError, ValueError):
        return False


def _timestamp():
    return datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")


class SolverParameterStudy(ParameterStudy):
    """Abstract sweep engine; concrete subclasses pin solver type, header
    keys, and the vmappable parameter set."""

    _header_keys = []
    _vmappable = frozenset()

    def __init__(self, solver, observer, dir_output, name, parameters,
                 reconstruction_info=None, append=False, use_vmap=True,
                 mesh=None):
        ParameterStudy.__init__(self, directory=dir_output, name=name)
        self._solver = solver
        self._parameters = dict(parameters)
        self._observer = observer
        self._reconstruction_info = dict(reconstruction_info or {})
        self._append = append
        self._use_vmap = use_vmap
        #: a "batch" mesh for the sharded sweep: its ranks split the grid
        #: and rank 0 alone writes the files
        self._mesh = mesh
        self._writes = mesh is None or mesh.rank == 0
        self._computational_time = None

    def get_parameters(self):
        return self._parameters

    def get_computational_time(self):
        return self._computational_time

    def run(self):
        self._observer.set_name(self._name)
        self._observer.clear_x_list()
        self._solver.set_observer(self._observer)

        prev_exists = os.path.isfile(self._get_path_to_file_parameters())
        if not self._append or not prev_exists:
            if self._writes:
                os.makedirs(self._directory, exist_ok=True)
                self._create_file_parameters()
                self._create_files_measures()
                self._create_file_computational_time()
            self._append = False
        else:
            ph.print_info("Append previous study ... ")
            self._check_that_studies_match()

        time_start = ph.start_timing()
        self._run()
        self._computational_time = ph.stop_timing(time_start)
        if self._mesh is not None:
            self._mesh.barrier()

    # -- append validation (behavioral contract as in the reference engine,
    #    nsol/solver_parameter_study.py:104-149: static solver settings in
    #    the stored header must match the current configuration, numeric
    #    values to ~1e-6; implemented here by parsing both headers into
    #    key→value maps and diffing them) ----------------------------------

    @staticmethod
    def _parse_header_settings(header):
        """Split a parameters-file header line into its study name and a
        ``{setting: value}`` map.

        Header lines look like ``## <name>, k1=v1, k2=v2 (<timestamp>)``;
        the trailing timestamp is write-time metadata, not configuration,
        and is dropped.
        """
        body = header.strip()
        if body.startswith("##"):
            body = body[2:].strip()
        body = re.sub(r"\s*\([^()]*\)\s*$", "", body)
        name, *pairs = body.split(", ")
        settings = {}
        for pair in pairs:
            key, _, value = pair.partition("=")
            settings[key] = value
        return name, settings

    def _check_that_studies_match(self):
        reader = ReaderParameterStudy(directory=self._directory,
                                      name=self._name)
        reader.read_study()
        stored_header = reader.get_file_header()
        name_stored, stored = self._parse_header_settings(stored_header)
        name_now, now = self._parse_header_settings(self._get_fileheader())

        def incompatible(why):
            raise RuntimeError(
                "Study '%s' cannot be appended: %s. Stored header: %r"
                % (self._name, why, stored_header.strip()))

        if name_stored != name_now:
            incompatible("study is named '%s' on disk" % name_stored)
        if set(stored) != set(now):
            incompatible("configured settings %s differ from the stored "
                         "ones %s" % (sorted(now), sorted(stored)))
        for key, value in now.items():
            prev = stored[key]
            if value == prev:
                continue
            # numeric settings match up to the reference's 1e-6 header
            # tolerance (combined rel+abs so large magnitudes compare
            # relatively — ADVICE r4); everything else must be literal
            if (_is_float(value) and _is_float(prev)
                    and math.isclose(float(value), float(prev),
                                     rel_tol=1e-6, abs_tol=1e-6)):
                continue
            incompatible("setting '%s' is %s on disk but %s in the "
                         "current solver" % (key, prev, value))

    @staticmethod
    def _stored_combo(stored_rows, vals):
        """True when a parameter combination already has a stored row.
        Stored values are the writer's strings; numeric values match to
        the study engine's 1e-6 tolerance (combined rel+abs, so
        large-magnitude grid values compare relatively and sub-1e-6
        grid spacings are not silently merged — ADVICE r4), everything
        else literally."""
        for stored in stored_rows:
            if len(stored) != len(vals):
                continue
            ok = True
            for s, v in zip(stored, vals):
                if _is_float(s) and _is_float(v):
                    if not math.isclose(float(s), float(v),
                                        rel_tol=1e-6, abs_tol=1e-6):
                        ok = False
                        break
                elif str(s) != str(v):
                    ok = False
                    break
            if ok:
                return True
        return False

    # -- execution ---------------------------------------------------------

    def _run(self):
        combos = list(itertools.product(*self._parameters.values()))
        keys = list(self._parameters.keys())

        if self._append:
            reader = ReaderParameterStudy(directory=self._directory,
                                          name=self._name)
            reader.read_study()
            stored_rows = reader.get_parameters_to_line()
            previous = len(stored_rows)
            dic_x = dict(reader.get_reconstructions())
            stored_keys = reader.get_parameter_keys()
            if stored_keys != keys:
                raise RuntimeError(
                    "Study '%s' cannot be appended: swept parameters %s "
                    "differ from the stored ones %s"
                    % (self._name, keys, stored_keys))
            # resume-aware append: a killed sweep re-run with the same
            # grid executes only the missing combinations (the reference
            # uses get_parameters_to_line the same way to count completed
            # rows, nsol/solver_parameter_study.py:158-168)
            combos = [c for c in combos
                      if not self._stored_combo(stored_rows, c)]
            skipped = len(stored_rows) and (
                len(list(itertools.product(*self._parameters.values())))
                - len(combos))
            if skipped:
                ph.print_info(
                    "Append: %d of the configured combinations are "
                    "already stored — running the remaining %d"
                    % (skipped, len(combos)))
            if not combos:
                ph.print_info("Append: study already complete; "
                              "nothing to run")
                return
        else:
            previous = 0
            dic_x = dict(self._reconstruction_info)

        vmap_keys = [k for k in keys if k in self._vmappable]
        static_keys = [k for k in keys if k not in self._vmappable]
        if self._use_vmap and len(combos) > 1 and not static_keys:
            self._run_vmapped(keys, combos, previous, dic_x)
        elif (self._use_vmap and len(combos) > 1 and vmap_keys
              and all(hasattr(self._solver, "set_%s" % k)
                      for k in static_keys)):
            self._run_hybrid(keys, vmap_keys, static_keys, combos,
                             previous, dic_x)
        else:
            self._run_serial(keys, combos, previous, dic_x)

    def _run_serial(self, keys, combos, previous, dic_x):
        for i, vals in enumerate(combos):
            ph.print_title("%s: Iteration %d/%d"
                           % (self._name, i + 1, len(combos)))
            dic_parameter = {}
            for j, key in enumerate(keys):
                getattr(self._solver, "set_%s" % key)(vals[j])
                dic_parameter[key] = str(
                    getattr(self._solver, "get_%s" % key)())
                ph.print_info(key + " = %s" % dic_parameter[key])

            self._solver.run()
            results = self._observer.compute_measures()
            for measure, arr in results.items():
                self._add_to_file_measures(measure,
                                           np.asarray(arr).reshape(1, -1))
            self._add_to_file_computational_time(
                self._observer.get_computational_time())
            self._add_to_file_parameters(dic_parameter)

            dic_x[str(i + previous)] = np.array(self._solver.get_x(),
                                                dtype=np.float16)
            self._write_to_file_reconstructions(dic_x)

            self._observer.clear_x_list()
            self._observer.clear_results()
            self._solver.set_x0(self._solver.get_x0())

    def _run_hybrid(self, keys, vmap_keys, static_keys, combos, previous,
                    dic_x):
        """Mixed sweep: batch the runtime-scalar axes within each
        combination of the static (string) axes — e.g. the reference's
        default ``alpha × data_loss`` grid runs as one ``run_sweep`` per
        data_loss. Results are written in the original cartesian row order.
        """
        ph.print_title(
            "%s: hybrid sweep — batching %s within each %s combination "
            "(%d configurations)"
            % (self._name, vmap_keys, static_keys, len(combos)))
        measures = self._observer.get_measures()

        # group rows by their static-key values, preserving global indices
        groups = {}
        for i, vals in enumerate(combos):
            static_vals = tuple(v for k, v in zip(keys, vals)
                                if k in static_keys)
            groups.setdefault(static_vals, []).append(i)

        results = {}
        t0 = ph.start_timing()
        for static_vals, rows in groups.items():
            for k, v in zip(static_keys, static_vals):
                getattr(self._solver, "set_%s" % k)(v)
            param_values = {
                k: np.array([combos[i][keys.index(k)] for i in rows],
                            dtype=np.float64)
                for k in vmap_keys}
            x_all, records = self._solver.run_sweep(
                param_values, measures=measures, mesh=self._mesh)
            for j, i in enumerate(rows):
                results[i] = (x_all[j],
                              {m: records[m][j] for m in measures}
                              if measures else {})
        elapsed = ph.stop_timing(t0)
        per_config = elapsed / len(combos)

        for i, vals in enumerate(combos):
            x_i, recs_i = results[i]
            dic_parameter = {k: str(v) for k, v in zip(keys, vals)}
            for measure in measures:
                self._add_to_file_measures(
                    measure, np.asarray(recs_i[measure]).reshape(1, -1))
            self._add_to_file_computational_time(per_config)
            self._add_to_file_parameters(dic_parameter)
            dic_x[str(i + previous)] = np.array(x_i, dtype=np.float16)
        self._write_to_file_reconstructions(dic_x)

    def _run_vmapped(self, keys, combos, previous, dic_x):
        ph.print_title("%s: batched sweep over %d configurations"
                       % (self._name, len(combos)))
        param_values = {
            k: np.array([c[j] for c in combos], dtype=np.float64)
            for j, k in enumerate(keys)}
        measures = self._observer.get_measures()

        t0 = ph.start_timing()
        x_all, records = self._solver.run_sweep(param_values,
                                                measures=measures,
                                                mesh=self._mesh)
        elapsed = ph.stop_timing(t0)
        per_config = elapsed / len(combos)

        for i, vals in enumerate(combos):
            dic_parameter = {k: str(v) for k, v in zip(keys, vals)}
            for measure in measures:
                arr = np.asarray(records[measure][i]).reshape(1, -1)
                self._add_to_file_measures(measure, arr)
            self._add_to_file_computational_time(per_config)
            self._add_to_file_parameters(dic_parameter)
            dic_x[str(i + previous)] = np.array(x_all[i], dtype=np.float16)
        self._write_to_file_reconstructions(dic_x)

    # -- file writing (schema: nsol/solver_parameter_study.py:223-325) -----

    def _create_file_parameters(self):
        header = self._get_fileheader()
        header += "## " + "\t".join(self._parameters.keys()) + "\n"
        with open(self._get_path_to_file_parameters(), "w") as f:
            f.write(header)

    def _create_files_measures(self):
        for measure in self._observer.get_measures():
            header = self._get_fileheader()
            header += "## " + measure + " for iteration 0 to n\n"
            with open(self._get_path_to_file_measures(measure), "w") as f:
                f.write(header)

    def _create_file_computational_time(self):
        header = self._get_fileheader()
        # Semantics note: serial sweeps time each configuration's solve
        # individually; the vmapped/hybrid fast paths execute the whole
        # grid as one batched program, so their rows carry the batch
        # wall-time divided by the number of configurations (an amortized
        # figure, not a per-config measurement).
        header += ("## Computational time measured for n iterations "
                   "(vmapped sweeps: batch wall-time / #configs, "
                   "amortized)\n")
        with open(self._get_path_to_file_computational_time(), "w") as f:
            f.write(header)

    def _add_to_file_parameters(self, dic_parameters):
        if not self._writes:
            return
        with open(self._get_path_to_file_parameters(), "a") as f:
            f.write("\t".join(dic_parameters.values()) + "\n")

    def _add_to_file_measures(self, measure, nda):
        if not self._writes:
            return
        with open(self._get_path_to_file_measures(measure), "ab") as f:
            np.savetxt(f, nda, fmt="%.10e")

    def _add_to_file_computational_time(self, computational_time):
        if not self._writes:
            return
        with open(self._get_path_to_file_computational_time(), "a") as f:
            f.write(str(computational_time) + "\n")

    def _write_to_file_reconstructions(self, dic):
        if not self._writes:
            return
        np.savez_compressed(self._get_path_to_file_reconstructions(), **dic)
        ph.print_info("File '%s' written"
                      % self._get_path_to_file_reconstructions())

    def _get_fileheader(self):
        header = "## " + self._name
        for key in self._header_keys:
            if key not in self._parameters:
                header += ", %s=%s" % (
                    key, str(getattr(self._solver, "get_%s" % key)()))
        header += " (%s)" % _timestamp()
        header += "\n"
        return header


class TikhonovLinearSolverParameterStudy(SolverParameterStudy):
    """Header keys per nsol/tikhonov_linear_solver_parameter_study.py:62-81."""

    _header_keys = ["alpha", "minimizer", "iter_max", "x_scale",
                    "data_loss", "data_loss_scale"]
    _vmappable = frozenset({"alpha", "data_loss_scale"})

    def __init__(self, solver, observer, dir_output, name="Tikhonov",
                 parameters=None, reconstruction_info=None, append=False,
                 use_vmap=True, mesh=None):
        if not isinstance(solver, W.TikhonovLinearSolver):
            raise TypeError("solver must be of type 'TikhonovLinearSolver'")
        if parameters is None:
            parameters = {
                "alpha": np.arange(0.02, 0.5, 0.05),
                "data_loss": ["linear", "arctan"],
            }
        SolverParameterStudy.__init__(
            self, solver=solver, observer=observer, dir_output=dir_output,
            name=name, parameters=parameters,
            reconstruction_info=reconstruction_info, append=append,
            use_vmap=use_vmap, mesh=mesh)


class ADMMLinearSolverParameterStudy(SolverParameterStudy):
    """Header keys per nsol/admm_linear_solver_parameter_study.py:63-85."""

    _header_keys = ["alpha", "rho", "iterations", "minimizer", "iter_max",
                    "x_scale", "data_loss", "data_loss_scale", "dimension"]
    _vmappable = frozenset({"alpha", "rho", "data_loss_scale"})

    def __init__(self, solver, observer, dir_output, name="ADMM",
                 parameters=None, reconstruction_info=None, append=False,
                 use_vmap=True, mesh=None):
        if not isinstance(solver, W.ADMMLinearSolver):
            raise TypeError("solver must be of type 'ADMMLinearSolver'")
        if parameters is None:
            parameters = {
                "alpha": np.arange(0.01, 0.06, 0.01),
                "rho": [0.1, 0.5, 1.0],
            }
        SolverParameterStudy.__init__(
            self, solver=solver, observer=observer, dir_output=dir_output,
            name=name, parameters=parameters,
            reconstruction_info=reconstruction_info, append=append,
            use_vmap=use_vmap, mesh=mesh)



class PrimalDualSolverParameterStudy(SolverParameterStudy):
    """Header keys per nsol/primal_dual_solver_parameter_study.py:61-78."""

    _header_keys = ["alpha", "iterations", "x_scale", "L2"]
    _vmappable = frozenset({"alpha"})

    def __init__(self, solver, observer, dir_output, name="PrimalDual",
                 parameters=None, reconstruction_info=None, append=False,
                 use_vmap=True, mesh=None):
        if not isinstance(solver, W.PrimalDualSolver):
            raise TypeError("solver must be of type 'PrimalDualSolver'")
        if parameters is None:
            parameters = {
                "alpha": np.arange(0.01, 0.05, 0.01),
                "alg_type": ["ALG2", "ALG2_AHMOD", "ALG3"],
            }
        SolverParameterStudy.__init__(
            self, solver=solver, observer=observer, dir_output=dir_output,
            name=name, parameters=parameters,
            reconstruction_info=reconstruction_info, append=append,
            use_vmap=use_vmap, mesh=mesh)
