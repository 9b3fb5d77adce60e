"""Linear solvers: host sparse LU and the refined factor solve.

Port of ``host_splu`` (``sanm_tpu/solver/linear.py:50-96``): on the
``host_lu`` path, as in the JAX package, the sparse factorization and the
per-order back-substitutions run on the host in SciPy's SuperLU; the
right-hand side crosses from the card to the host once per order.

Port of ``chol_refine_solve`` (``:462-538``): the iterative refinement
around the card's band factor (``solver/band.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import ScopedProfiler


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


class HostSparseLU:
    """The ``host_lu`` path's solver, with the contract of
    :class:`~sanm_tpu_torch.solver.band.DeviceBandCholSolver` (``solve(b)``
    and ``apply(x)`` on device tensors): SuperLU of the CSR Jacobian ``A``
    on the host, of ``A^T A + pen I`` with the l2 penalty.  Each solve
    pulls b from its device (``bias_pull``), back-substitutes on the host
    and returns x on b's device."""

    def __init__(self, A, pen=0.0):
        import scipy.sparse as sp

        self.A = A
        if pen:
            G = (A.T @ A).tocsc() + pen * sp.identity(A.shape[0],
                                                      format="csc")
            lu = host_splu(G)
            self._solve = lambda b: lu.solve(A.T @ b)
        else:
            self._solve = host_splu(A.tocsc()).solve

    def solve(self, b):
        with ScopedProfiler("bias_pull"):
            bh = b.cpu().numpy()
        with ScopedProfiler("sparse_solve"):
            x = self._solve(bh)
        return torch.as_tensor(x).to(b.device)

    def apply(self, x):
        with ScopedProfiler("eqn_check_host"):
            return torch.as_tensor(self.A @ x.cpu().numpy()).to(x.device)


#: refinement trips at most, and the early exit (``linear.py:462-538``)
REFINE_STEPS = 8
REFINE_RTOL = 1e-12


def chol_refine_solve(tri_solve, s, b, matvec, refine_steps=REFINE_STEPS,
                      rtol=REFINE_RTOL, with_resid=False):
    """Solve ``A x = b`` through a factor of the Jacobi-equilibrated,
    sign-flipped system ``-(D A D)``, ``D = diag(s)``, with up to
    ``refine_steps`` rounds of iterative refinement against the exact
    operator ``matvec`` (x -> A x), exiting once
    ``||b - A x|| <= rtol ||b||`` (``rtol <= 0``: every round runs).

    Port of ``sanm_tpu/solver/linear.py:462-538`` with the same sign and
    scale convention: one back-substitution of ``r`` is
    ``-(tri_solve((r / ||r||) s) s) ||r||``.  The factor is f64 here, so
    the JAX package's f32 downcast is gone.  The early-exit test reads
    one scalar per round on the host.

    Returns ``(x, trips)``, or ``(x, trips, rel)`` with ``with_resid``,
    where ``rel`` is the final relative residual as a 0-d tensor."""

    def backsub(r):
        scale = torch.linalg.vector_norm(r)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        y = tri_solve((r / safe) * s)
        return -(y * s) * safe

    x = backsub(b)
    bnorm = torch.linalg.vector_norm(b)
    thresh = rtol * bnorm
    r = b - matvec(x)
    trips = 0
    while trips < refine_steps and (
            rtol <= 0 or bool(torch.linalg.vector_norm(r) > thresh)):
        x = x + backsub(r)
        trips += 1
        r = b - matvec(x)
    if not with_resid:
        return x, trips
    rel = torch.linalg.vector_norm(r) / torch.clamp(bnorm, min=1e-300)
    return x, trips, rel
