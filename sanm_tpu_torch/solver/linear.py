"""Linear solvers: host sparse LU, the dense solvers and the refined
factor solve.

* Port of ``host_splu`` (``sanm_tpu/solver/linear.py:50-96``): on the
  ``host_lu`` path, as in the JAX package, the sparse factorization and
  the per-order back-substitutions run on the host in SciPy's SuperLU;
  the right-hand side crosses from the card to the host once per order.
* Port of ``chol_refine_solve`` (``:462-538``): the iterative refinement
  around the card's Cholesky factors (:class:`RefinedCholSolver`: the
  band in ``solver/band.py``, the dense one here, SPIKE in
  ``solver/spike.py``).
* K6, the ``dense_chol`` solver (``:305-459``, ``:541-633``): the
  Jacobi-scaled, sign-flipped matrix assembled densely (K5a with the
  dense scatter map, ``solver/assemble.py`` :class:`~sanm_tpu_torch.
  solver.assemble.DensePlan`), then two hand-written CUDA kernels
  (``csrc/dense_chol.cu``): K6b :func:`dense_factor`, the right-looking
  blocked Cholesky in place, and K6c :func:`dense_solve`, its forward and
  backward substitutions.  Each wrapper launches its kernel for tensors
  on the card, runs its ``*_plain`` torch version for tensors on the
  CPU, and raises for anything else.
* :class:`DenseFactorSolver` (``:98-207``), the ``dense`` solver: plain
  torch QR, or Cholesky of ``A^T A + lambda I`` in Tikhonov mode, as the
  JAX package calls the library there.
* K9, the ``cg`` solver (:class:`SparseCG`, ``:636-752``): block-Jacobi
  PCG on the CSR values, in chunks of iterations that run on the card
  without a host synchronisation (:func:`pcg_chunk`, ``csrc/cg.cu``) and
  one scalar read between chunks; its products are K4 COO
  (``solver/assemble.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..utils import SANMError, ScopedProfiler
from .assemble import (CSRMaps, DensePlan, csr_matvec, csr_matvec_plain,
                       csr_matvec_t, csr_matvec_t_plain, dense_assemble,
                       diag_blocks)

_f64 = torch.float64


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


class RefinedCholSolver:
    """What the card's Cholesky solvers share (``band_chol``,
    ``dense_chol``, ``spike_band``): a factor of ``-(D A D)`` built in the
    subclass's constructor, ``solve`` through :func:`chol_refine_solve`
    with the subclass's ``tri_solve`` and f64 refinement against
    ``matvec`` (x -> A x, the exact operator), ``factor_ok()`` flagging an
    indefinite state.  Tikhonov mode is refused, as in the JAX package.

    ``solves`` and ``trips`` count the solves and their refinement
    trips."""

    name = None

    def __init__(self, matvec, l2_penalty, refine_steps):
        if l2_penalty:
            raise SANMError("%s: Tikhonov mode not supported" % self.name)
        self.matvec = matvec
        self.refine_steps = int(refine_steps)
        self.solves = 0
        self.trips = 0

    def tri_solve(self, r):
        """``(-(D A D))^-1 r`` through the factor."""
        raise NotImplementedError

    def factor_ok(self) -> bool:
        raise NotImplementedError

    def solve(self, b, with_resid=False):
        """x with A x = b; with ``with_resid`` also the relative
        residual ||b - A x|| / ||b|| (a 0-d tensor)."""
        with ScopedProfiler("sparse_solve", block=True):
            out = chol_refine_solve(self.tri_solve, self.scale, b,
                                    self.matvec, self.refine_steps,
                                    with_resid=with_resid)
        self.solves += 1
        self.trips += out[1]
        return (out[0], out[2]) if with_resid else out[0]

    def apply(self, x):
        return self.matvec(x)


# ---------------------------------------------------------------------------
# K6b dense_factor
# ---------------------------------------------------------------------------


def dense_factor(plan: DensePlan, M):
    """Blocked Cholesky of the lower triangle of ``M`` (npad, npad) in
    place: its lower triangle becomes L (the upper triangle is left
    holding junk).  Returns the inverses of the diagonal blocks
    (nb, s, s); NaN where the input is indefinite."""
    kernels.check(M, "M", (plan.npad, plan.npad), _f64)
    if not kernels.on_card(M):
        return dense_factor_plain(plan, M)
    kernels.check_block(plan.s)
    s = plan.s
    inv = torch.empty((plan.nb, s, s), dtype=_f64, device=M.device)
    T = torch.empty((max(plan.nb - 1, 1) * s, s), dtype=_f64,
                    device=M.device)
    kernels.launch("dense_factor", "sanm_dense_factor", M.data_ptr(),
                   inv.data_ptr(), T.data_ptr(), plan.nb)
    return inv


def chol_nan(D):
    """Lower Cholesky factor of the block whose lower triangle is ``D``'s
    (the upper half is junk); all NaN when it is not positive definite,
    as ``lax.linalg.cholesky`` gives."""
    low = torch.tril(D)
    L, info = torch.linalg.cholesky_ex(low + torch.tril(D, -1).mT)
    if int(info) != 0 or not bool(torch.isfinite(L).all()):
        L = torch.full_like(L, float("nan"))
    return L


def dense_factor_plain(plan: DensePlan, M):
    s, npad = plan.s, plan.npad
    inv = torch.empty((plan.nb, s, s), dtype=_f64, device=M.device)
    eye = torch.eye(s, dtype=_f64, device=M.device)
    for j in range(plan.nb):
        c0, c1 = j * s, (j + 1) * s
        Ljj = chol_nan(M[c0:c1, c0:c1])
        inv[j] = torch.linalg.solve_triangular(Ljj, eye, upper=False)
        M[c0:c1, c0:c1] = Ljj + torch.triu(M[c0:c1, c0:c1], 1)
        if c1 < npad:
            T = M[c1:, c0:c1] @ inv[j].mT
            M[c1:, c0:c1] = T
            M[c1:, c1:] -= T @ T.mT
    return inv


def dense_factor_ok(inv) -> bool:
    """All-finite check on the diagonal blocks' inverses: a NaN pivot
    reaches every later diagonal block (``linear.py:613-618``)."""
    return bool(torch.isfinite(inv).all())


# ---------------------------------------------------------------------------
# K6c dense_solve
# ---------------------------------------------------------------------------


def dense_solve(plan: DensePlan, L, inv, rhs):
    """``(L L^T)^{-1} rhs`` for ``rhs`` (n,): zero-extended to npad,
    forward and backward substitution against L's lower triangle
    (``blocked_chol_solve``, ``linear.py:416-436``)."""
    kernels.check(rhs, "rhs", (plan.n,), _f64)
    kernels.check(L, "L", (plan.npad, plan.npad), _f64)
    kernels.check(inv, "inv", (plan.nb, plan.s, plan.s), _f64)
    if not kernels.on_card(rhs, L, inv):
        return dense_solve_plain(plan, L, inv, rhs)
    kernels.check_block(plan.s)
    dev = rhs.device
    work = torch.empty((plan.npad,), dtype=_f64, device=dev)
    groups = max(1, -(-(plan.npad - plan.s) // 64))
    partial = torch.empty((groups, plan.s), dtype=_f64, device=dev)
    out = torch.empty((plan.n,), dtype=_f64, device=dev)
    kernels.launch("dense_solve", "sanm_dense_solve", L.data_ptr(),
                   inv.data_ptr(), rhs.data_ptr(), work.data_ptr(),
                   partial.data_ptr(), out.data_ptr(), plan.n, plan.nb)
    return out


def dense_solve_plain(plan: DensePlan, L, inv, rhs):
    s = plan.s
    r = torch.zeros((plan.npad,), dtype=_f64, device=rhs.device)
    r[: plan.n] = rhs
    for j in range(plan.nb):
        c0, c1 = j * s, (j + 1) * s
        yj = inv[j] @ r[c0:c1]
        r[c1:] -= L[c1:, c0:c1] @ yj
        r[c0:c1] = yj
    for j in reversed(range(plan.nb)):
        c0, c1 = j * s, (j + 1) * s
        yj = r[c0:c1] - L[c1:, c0:c1].mT @ r[c1:]
        r[c0:c1] = inv[j].mT @ yj
    return r[: plan.n]


class DeviceCholSolver(RefinedCholSolver):
    """The ``dense_chol`` solver (``linear.py:541-633``): ``-(D A D)``
    assembled into the dense (npad, npad) matrix, factored in place by K6b
    and kept with its diagonal blocks' inverses; each solve runs K6c per
    refinement trip (:class:`RefinedCholSolver`).  The factor is f64 (the
    JAX package's f32 factor is not ported)."""

    name = "dense_chol"

    def __init__(self, plan: DensePlan, data, matvec, l2_penalty=0.0,
                 refine_steps: int = REFINE_STEPS):
        super().__init__(matvec, l2_penalty, refine_steps)
        self.plan = plan
        self.L, self.scale = dense_assemble(plan, data)
        self.inv = dense_factor(plan, self.L)

    def factor_ok(self) -> bool:
        return dense_factor_ok(self.inv)

    def tri_solve(self, r):
        return dense_solve(self.plan, self.L, self.inv, r)


class DenseFactorSolver:
    """The ``dense`` solver (``linear.py:98-207``): factor the dense A
    once, back-substitute many times, in plain torch on A's device.  QR
    of A, or with ``l2_penalty`` (Tikhonov mode, reference
    ``sparse_solver.cpp:327-421``) the Cholesky factor of
    ``A^T A + l2_penalty I`` and the solve of ``(A^T A + l2_penalty I) x
    = A^T b``.  The factor is f64 (the JAX package's f32 factor is not
    ported); the JAX package's monotone refinement loop stays: each round
    keeps the new iterate only when it lowers the residual, and the loop
    ends at ``refine_tol`` relative, after ``max_refine`` rounds, or at the
    first round that does not improve."""

    def __init__(self, A, l2_penalty: float = 0.0, refine_tol: float = 1e-14,
                 max_refine: int = 25):
        if A.shape[0] != A.shape[1]:
            raise SANMError("square system required")
        self.A = A
        self.l2_penalty = float(l2_penalty)
        self.refine_tol = refine_tol
        self.max_refine = max_refine
        if self.l2_penalty:
            self.G = A.mT @ A + self.l2_penalty * torch.eye(
                A.shape[0], dtype=A.dtype, device=A.device)
            self._chol = torch.linalg.cholesky(self.G)
        else:
            self._q, self._r = torch.linalg.qr(A)

    def _backsub(self, b):
        if self.l2_penalty:
            y = torch.linalg.solve_triangular(self._chol, b[:, None],
                                              upper=False)
            x = torch.linalg.solve_triangular(self._chol.mT, y, upper=True)
        else:
            x = torch.linalg.solve_triangular(
                self._r, (self._q.mT @ b)[:, None], upper=True)
        return x[:, 0]

    def solve(self, b):
        b = b.reshape(-1)
        if self.l2_penalty:
            b = self.A.mT @ b
            mat = self.G
        else:
            mat = self.A
        x = self._backsub(b)
        bnorm = float(torch.linalg.vector_norm(b)) + 1e-300
        rnorm = float(torch.linalg.vector_norm(b - mat @ x))
        for _ in range(self.max_refine):
            if not rnorm > self.refine_tol * bnorm:
                break
            x_new = x + self._backsub(b - mat @ x)
            rnorm_new = float(torch.linalg.vector_norm(b - mat @ x_new))
            if not rnorm_new < rnorm:
                break
            x, rnorm = x_new, rnorm_new
        return x

    def apply(self, x):
        return self.A @ x.reshape(-1)


# ---------------------------------------------------------------------------
# K9 pcg_chunk: the block-Jacobi PCG iterations of the cg solver
# ---------------------------------------------------------------------------

#: CTAs of each K9 launch, and so the partial sums of each dot product
PCG_CTAS = 528


class PCGState:
    """One PCG solve's state on b's device: x, r, z, p (n,), the scratch
    Ap, y (n,) and ``part`` (3, :data:`PCG_CTAS`), and the scalars ``S``
    (7,): slot c (``S[3c:3c+3]``) holds r.z, r.r and the count of live
    iterations, iteration ``it`` reads slot ``it & 1`` and writes the
    other; ``S[6]`` is b.b.  It starts as ``sanm_tpu/solver/linear.py
    :731-739`` does: x = 0, r = b, z = p = M^-1 b."""

    def __init__(self, b, binv):
        n = b.numel()
        self.it = 0
        self.x = torch.zeros_like(b)
        self.r = b.clone()
        self.z = precond(binv, b)
        self.p = self.z.clone()
        self.Ap = torch.empty_like(b)
        self.y = torch.empty_like(b)
        self.part = torch.empty((3, PCG_CTAS), dtype=_f64, device=b.device)
        zero = b.new_zeros(())
        bb = b @ b
        self.S = torch.stack([b @ self.z, bb, zero, zero, zero, zero,
                              bb]).contiguous()
        self.n = n

    def slot(self):
        """The scalars after the last iteration (r.z, r.r, live count)."""
        c = self.it & 1
        return self.S[3 * c: 3 * c + 3]

    def clone(self, device=None):
        """A copy, on ``device`` (default: where the state lies)."""
        out = PCGState.__new__(PCGState)
        out.__dict__.update({
            k: v.to(device or v.device, copy=True) if torch.is_tensor(v)
            else v for k, v in self.__dict__.items()})
        return out


def precond(binv, v):
    """M^-1 v per 3-block (``linear.py:663-668``)."""
    nb = binv.shape[0]
    return (binv @ v.reshape(nb, 3, 1)).reshape(-1)


def pcg_chunk(csr: CSRMaps, data, binv, st: PCGState, n_steps, tol,
              pen=0.0):
    """``n_steps`` PCG iterations of ``st`` in place, with the freeze
    guard of ``linear.py:700-716``; with ``pen`` on A^T A + pen I.  One
    launch of the K9 entry point, which launches three kernels (four in
    Tikhonov mode) per iteration and does not synchronise."""
    n = st.n
    kernels.check(data, "data", (csr.nnz,), _f64)
    kernels.check(binv, "binv", (n // 3, 3, 3), _f64)
    for name in ("x", "r", "z", "p", "Ap", "y"):
        kernels.check(getattr(st, name), name, (csr.n,), _f64)
    kernels.check(st.S, "S", (7,), _f64)
    kernels.check(st.part, "part", (3, PCG_CTAS), _f64)
    if csr.n != csr.n_rows or n % 3:
        raise SANMError("PCG needs a square system of 3-blocks, not %d x %d"
                        % (csr.n_rows, csr.n))
    t = csr.transposed if pen else ()
    if not kernels.on_card(data, binv, st.x, st.r, st.z, st.p, st.Ap, st.y,
                           st.S, st.part, csr.row_ptr, csr.cols, *t):
        return pcg_chunk_plain(csr, data, binv, st, n_steps, tol, pen)
    t = t or (None, None, None)
    kernels.launch("pcg_step", "sanm_pcg_step", csr.row_ptr.data_ptr(),
                   csr.cols.data_ptr(),
                   *(None if a is None else a.data_ptr() for a in t),
                   data.data_ptr(), binv.data_ptr(), st.x.data_ptr(),
                   st.r.data_ptr(), st.z.data_ptr(), st.p.data_ptr(),
                   st.Ap.data_ptr(), st.y.data_ptr(), st.S.data_ptr(),
                   st.part.data_ptr(), n, n_steps, st.it, PCG_CTAS,
                   tol * tol, float(pen))
    st.it += n_steps
    return st


def pcg_chunk_plain(csr: CSRMaps, data, binv, st: PCGState, n_steps, tol,
                    pen=0.0):
    """``_chunk_kernel``'s body (``linear.py:689-718``) in torch on the
    state's scalars, with no host synchronisation."""
    x, r, p, S = st.x, st.r, st.p, st.S
    tol2 = tol * tol
    for _ in range(n_steps):
        c, nx = st.it & 1, 1 - (st.it & 1)
        rz, rr, count, bb = S[3 * c], S[3 * c + 1], S[3 * c + 2], S[6]
        live = rr > tol2 * bb
        Ap = csr_matvec_plain(csr, data, p)
        if pen:
            Ap = csr_matvec_t_plain(csr, data, Ap) + pen * p
        pap = p @ Ap
        alpha = torch.where(live, rz / torch.where(pap != 0, pap, 1.0), 0.0)
        x.copy_(torch.where(live, x + alpha * p, x))
        r.copy_(torch.where(live, r - alpha * Ap, r))
        st.z.copy_(precond(binv, r))
        rz2, rr2 = r @ st.z, r @ r
        beta = torch.where(live, rz2 / torch.where(rz != 0, rz, 1.0), 0.0)
        p.copy_(st.z + beta * p)
        S[3 * nx: 3 * nx + 3] = torch.stack([rz2, rr2, count + live])
        st.it += 1
    return st


class SparseCG:
    """The ``cg`` solver (``sanm_tpu/solver/linear.py:636-752``):
    block-Jacobi PCG on the CSR operator (A, or A^T A + pen I with the l2
    penalty, whose right-hand side becomes A^T b), the preconditioner
    inv(blocks + 1e-300 I) of A's own 3 x 3 diagonal blocks built once.
    ``solve`` runs chunks of :attr:`CHUNK` iterations while fewer than
    :attr:`MAX_ITER` ran and reads ||r|| after each; it stops once ||r||
    <= :attr:`TOL` ||b|| (the JAX package's defaults, ``:641``).  The
    class counters ``STATS`` add up the solves, the live (not frozen)
    iterations and the iterations run."""

    TOL = 1e-13
    MAX_ITER = 2000
    CHUNK = 64
    STATS = {"solves": 0, "iterations": 0, "max_iterations": 0, "run": 0}

    def __init__(self, csr: CSRMaps, data, l2_penalty: float = 0.0):
        if csr.n != csr.n_rows or csr.n % 3:
            raise SANMError("PCG needs a square system of 3-blocks, not "
                            "%d x %d" % (csr.n_rows, csr.n))
        self.csr = csr
        self._data = data
        self.l2_penalty = float(l2_penalty)
        blocks = diag_blocks(csr, data)
        self.binv = torch.linalg.inv(
            blocks + 1e-300 * torch.eye(3, dtype=_f64,
                                        device=data.device)).contiguous()

    @classmethod
    def reset_stats(cls):
        for k in cls.STATS:
            cls.STATS[k] = 0

    def solve(self, b):
        with ScopedProfiler("sparse_solve", block=True):
            b = b.reshape(-1).to(_f64).contiguous()
            if self.l2_penalty:
                b = csr_matvec_t(self.csr, self._data, b)
            bnorm = float(torch.linalg.vector_norm(b))
            if bnorm == 0.0:
                return torch.zeros_like(b)
            st = PCGState(b, self.binv)
            done = 0
            while done < self.MAX_ITER:
                pcg_chunk(self.csr, self._data, self.binv, st, self.CHUNK,
                          self.TOL, self.l2_penalty)
                done += self.CHUNK
                _, rr, live = st.slot().tolist()
                if np.sqrt(rr) <= self.TOL * bnorm:
                    break
        stats = SparseCG.STATS
        stats["solves"] += 1
        stats["iterations"] += int(live)
        stats["max_iterations"] = max(stats["max_iterations"], int(live))
        stats["run"] += done
        return st.x

    def apply(self, x):
        return csr_matvec(self.csr, self._data, x.reshape(-1))

    def coeff_l2(self):
        return torch.sqrt(torch.sum(self._data * self._data))
