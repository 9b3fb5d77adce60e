"""Continuation drivers, assembly kernels and the host sparse solver
(port of ``sanm_tpu/solver``)."""

from .anm import (  # noqa: F401
    ANMEqnSolver,
    ANMSolverVecScale,
    EqnHyperParam,
    HyperParam,
)
