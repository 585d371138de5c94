"""Parameter-study engine (counterpart of ``nsol_tpu/study``): grid sweeps,
persisted artifacts in the reference's schema, append/resume, the study
reader (nsol/solver_parameter_study.py, nsol/reader_parameter_study.py)."""

from nsol_tpu_torch.study.paths import ParameterStudy
from nsol_tpu_torch.study.reader import ReaderParameterStudy
from nsol_tpu_torch.study.engine import (
    SolverParameterStudy, TikhonovLinearSolverParameterStudy,
    ADMMLinearSolverParameterStudy, PrimalDualSolverParameterStudy,
)

__all__ = [
    "ParameterStudy", "ReaderParameterStudy", "SolverParameterStudy",
    "TikhonovLinearSolverParameterStudy", "ADMMLinearSolverParameterStudy",
    "PrimalDualSolverParameterStudy",
]
