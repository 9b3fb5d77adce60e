"""Host sparse LU: the factorize-once / solve-N-times linear solver.

Port of ``host_splu`` (``sanm_tpu/solver/linear.py:50-96``).  As in the
JAX package, the sparse factorization and the per-order
back-substitutions run on the host in SciPy's SuperLU; the right-hand
side crosses from the card to the host once per order.
"""

from __future__ import annotations

import numpy as np


def host_splu(Acsc):
    """Host SuperLU factorization of the stiffness, symmetric-mode first.

    The ANM stiffness is structurally symmetric and near-SPD along stable
    branches, so SuperLU's ``SymmetricMode`` (MMD ordering on A+A^T with
    near-diagonal threshold pivoting) keeps the symbolic fill.  Threshold
    pivoting can lose digits on indefinite states, so the factor is
    validated with one deterministic random-RHS solve; on relative
    residual >= 1e-12, or a SuperLU error, it falls back to the default
    COLAMD factorization."""
    import scipy.sparse.linalg as spla

    try:
        lu = spla.splu(
            Acsc,
            permc_spec="MMD_AT_PLUS_A",
            options=dict(SymmetricMode=True, DiagPivotThresh=0.001),
        )
        b = np.random.default_rng(0).standard_normal(Acsc.shape[0])
        x = lu.solve(b)
        rel = np.linalg.norm(Acsc @ x - b) / np.linalg.norm(b)
        if np.isfinite(rel) and rel < 1e-12:
            return lu
    except RuntimeError:
        # SuperLU reports a singular or failed factorization as
        # RuntimeError; the COLAMD factorization below decides
        pass
    return spla.splu(Acsc)
