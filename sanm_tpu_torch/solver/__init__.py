"""Continuation drivers, assembly kernels, the host sparse solver and the
card's band Cholesky (port of ``sanm_tpu/solver``)."""

from .anm import (  # noqa: F401
    ANMEqnSolver,
    ANMImplicitSolver,
    ANMSolverVecScale,
    EqnHyperParam,
    HyperParam,
)
from .remap import LinearRemap  # noqa: F401
