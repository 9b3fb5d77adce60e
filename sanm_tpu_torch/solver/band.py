"""K5: the skyline band Cholesky, the sparse direct solve on the card.

Port of ``sanm_tpu/solver/band.py``.  The symbolic phase stays on the
host (:class:`BandPlan`: reverse Cuthill-McKee ordering, the skyline
reach of every block column, the static scatter maps), built once per
topology.  The numeric phase runs on the card through three hand-written
CUDA kernels (``csrc/band.cu``):

* K5a :func:`band_assemble` (``band.py:225``): the Jacobi scale
  ``s = |diag A|^-1/2`` and ``-(D A D)`` scattered into the working band;
* K5b :func:`band_factor` (``band.py:247``): the right-looking blocked
  skyline Cholesky, one block column after another, each at its own
  reach ``blk_w[j]``;
* K5c :func:`band_solve` (``band.py:321,369``): the permuted forward and
  backward substitutions against the panels.

Storage.  The working band keeps the LOWER band in block-row windows of
the uniform width ``W = (w+1)s``: ``band[i*s + r, c]`` holds
``A[i*s + r, (i - w)*s + c]``; only the lower triangle of a diagonal
block is valid.  It lives only during the factorization.  The factor is
one flat f64 buffer of per-column panels: panel ``j`` (at
``panel_off[j]``) stacks ``inv(L[j,j])`` (s x s) over the ``blk_w[j]``
subdiagonal blocks ``L[j+1+m, j]``.  The JAX package runs the block
columns in a few merged runs of one width each (to bound its number of
XLA programs); here every column runs at its own reach, so
:meth:`BandPlan.factor_flops` counts per column.

Precision: the factor is f64 on the card (the TPU's f32 factor is not
ported), refined against the exact operator by
:func:`~sanm_tpu_torch.solver.linear.chol_refine_solve`.  An indefinite
state gives NaN in the factor (the square root of a negative pivot),
never a clamp; :func:`band_factor_ok` detects it and the ANM driver falls
back to host LU.

Each wrapper launches its kernel for tensors on the card, runs its
``*_plain`` torch version for tensors on the CPU, and raises for anything
else.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..utils import sanm_assert
from .assemble import arrays_on, scaled_scatter, scaled_scatter_plain
from .linear import REFINE_STEPS, RefinedCholSolver, chol_nan
from .remap import diag_nnz_pos

_f64 = torch.float64
_i32 = torch.int32
_i64 = torch.int64

class BandPlan:
    """Host-side symbolic analysis, built once per topology: RCM
    ordering, the skyline reach of every block column and the static
    assembly scatter map (``sanm_tpu/solver/band.py:79-222``).

    ``s`` is the block size (default :data:`~sanm_tpu_torch.kernels.BLOCK`,
    the only one the CUDA kernels take: the skyline FLOPs are ~4x below
    the JAX package's TPU pick of s = 4096 at armadillo scale; the plain
    versions take any s)."""

    def __init__(self, csr_rowidx, csr_cols, n: int, s: int = None):
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        s = kernels.BLOCK if s is None else int(s)
        sanm_assert(s > 0, "block size %d", s)
        r = np.asarray(csr_rowidx, np.int64)
        c = np.asarray(csr_cols, np.int64)
        self.n = n = int(n)
        self.nnz = int(r.size)
        pat = sp.csr_matrix(
            (np.ones(r.size, np.float32), (r, c)), shape=(n, n)
        )
        perm = np.asarray(
            reverse_cuthill_mckee(pat, symmetric_mode=True), np.int64
        )
        invp = np.empty(n, np.int64)
        invp[perm] = np.arange(n)
        rp, cp = invp[r], invp[c]
        bw = int(np.abs(rp - cp).max()) if r.size else 1
        w = max(1, -(-bw // s))
        self.s, self.w, self.bw = s, w, bw
        self.nb = nb = -(-n // s)
        self.nrow_tot = (nb + w) * s
        self.W = (w + 1) * s

        # skyline reach: profile Cholesky fill stays within each row's
        # profile [first_i, i], so block row i touches block column j iff
        # fblk[i] <= j; the reach of column j is its farthest such row
        first = np.full(n, np.iinfo(np.int64).max)
        np.minimum.at(first, rp, cp)
        blk_of = np.arange(n) // s
        fblk = np.full(nb, nb, np.int64)
        np.minimum.at(fblk, blk_of, first // s)
        w_need = np.zeros(nb, np.int64)
        for i in range(nb):
            lo = int(fblk[i])
            if lo < i:
                j = np.arange(lo, i)
                np.maximum.at(w_need, j, i - j)
        sanm_assert(int(w_need.max(initial=0)) <= w,
                    "skyline reach exceeds global band width")
        self.blk_w = w_need
        # panel j: (blk_w[j] + 1) s x s doubles at panel_off[j]
        self.panel_off = np.zeros(nb + 1, np.int64)
        np.cumsum((w_need + 1) * s * s, out=self.panel_off[1:])

        # assembly scatter: LOWER-triangle nnz entry e -> flat position
        # in the working band
        low = np.nonzero(rp >= cp)[0]
        self.band_sel = low.astype(np.int32)
        self.band_idx = rp[low] * self.W + (
            cp[low] - (rp[low] // s) * s + w * s)
        # unit-diagonal pad positions (dofs n .. nrow_tot)
        d = np.arange(n, self.nrow_tot, dtype=np.int64)
        self.pad_idx = d * self.W + (d % s + w * s)
        # permutation extended over the pad region (identity there)
        self.perm_ext = np.concatenate(
            [perm, np.arange(n, self.nrow_tot, dtype=np.int64)])
        self.invp_ext = np.concatenate(
            [invp, np.arange(n, self.nrow_tot, dtype=np.int64)])

        # what band_assemble reads besides the values: the rows and
        # columns of the scattered entries, and each row's diagonal
        # position in the CSR values (-1: none, scale 1)
        self.sel_rows = np.asarray(csr_rowidx, np.int32)[low]
        self.sel_cols = np.asarray(csr_cols, np.int32)[low]
        pos, prow = diag_nnz_pos(csr_rowidx, csr_cols)
        self.diag_of_row = np.full(n, -1, np.int32)
        self.diag_of_row[prow] = pos
        self._dev = {}

    def mem_bytes(self) -> int:
        """Persistent factor bytes (the f64 skyline panels)."""
        return 8 * int(self.panel_off[-1])

    def work_mem_bytes(self) -> int:
        """Transient working-band bytes during the factorization (f64)."""
        return 8 * self.nrow_tot * self.W

    def factor_flops(self) -> float:
        """f64 operations that the factorization needs, every block column
        at its own reach w_j: Cholesky and inversion of the diagonal block
        (s^3/3 each), the panels (w_j s x s dense times the s x s
        triangular inverse: w_j s^2 (s + 1)) and the lower trailing update
        (w_j (w_j - 1)/2 full blocks at 2 s^3 and w_j diagonal blocks'
        lower halves at s^3).  The CUDA panel product runs over the zero
        half of the inverse as well; that work is not counted."""
        wj = self.blk_w.astype(np.float64)
        s = float(self.s)
        return float(np.sum((2.0 / 3.0 + wj + wj * wj) * s ** 3
                            + wj * s * s))

    def on(self, device):
        """The plan's index arrays on ``device`` (cached)."""
        return arrays_on(self._dev, device, lambda: dict(
            diag_of_row=(self.diag_of_row, _i32),
            band_sel=(self.band_sel, _i32), sel_rows=(self.sel_rows, _i32),
            sel_cols=(self.sel_cols, _i32), band_idx=(self.band_idx, _i64),
            pad_idx=(self.pad_idx, _i64), perm_ext=(self.perm_ext, _i32),
            invp_ext=(self.invp_ext, _i32)))

    def panel(self, panels, j):
        """Panel j of a factor as a (blk_w[j] + 1, s, s) view."""
        s = self.s
        lo, hi = int(self.panel_off[j]), int(self.panel_off[j + 1])
        return panels[lo:hi].view(-1, s, s)


def _kernel_block(plan):
    kernels.check_block(plan.s)


# ---------------------------------------------------------------------------
# K5a band_assemble
# ---------------------------------------------------------------------------


def _band_scatter_args(plan, data):
    arrs = plan.on(data.device)
    return (data, arrs["diag_of_row"], arrs["band_sel"], arrs["sel_rows"],
            arrs["sel_cols"], arrs["band_idx"], arrs["pad_idx"],
            plan.nrow_tot * plan.W)


def band_assemble(plan: BandPlan, data):
    """``-(D A D)`` from the CSR values ``data`` (nnz,) into a new
    working band (nrow_tot, W), unit diagonal on the pad rows; returns
    ``(band, scale)`` with the Jacobi scale (n,)."""
    kernels.check(data, "data", (plan.nnz,), _f64)
    flat, scale = scaled_scatter(*_band_scatter_args(plan, data))
    return flat.view(plan.nrow_tot, plan.W), scale


def band_assemble_plain(plan: BandPlan, data):
    flat, scale = scaled_scatter_plain(*_band_scatter_args(plan, data))
    return flat.view(plan.nrow_tot, plan.W), scale


# ---------------------------------------------------------------------------
# K5b band_factor
# ---------------------------------------------------------------------------


def band_factor(plan: BandPlan, band):
    """Blocked skyline Cholesky of the working band (overwritten: the
    trailing updates land in it).  Returns the flat panel buffer
    (``plan.panel_off[-1]``,); NaN where the input is indefinite."""
    kernels.check(band, "band", (plan.nrow_tot, plan.W), _f64)
    if not kernels.on_card(band):
        return band_factor_plain(plan, band)
    _kernel_block(plan)
    panels = torch.empty((int(plan.panel_off[-1]),), dtype=_f64,
                         device=band.device)
    kernels.launch("band_factor", "sanm_band_factor", band.data_ptr(),
                   panels.data_ptr(), plan.panel_off.ctypes.data,
                   plan.blk_w.ctypes.data, plan.nb, plan.w)
    return panels


def band_factor_plain(plan: BandPlan, band):
    s, w = plan.s, plan.w
    panels = torch.empty((int(plan.panel_off[-1]),), dtype=_f64,
                         device=band.device)
    eye = torch.eye(s, dtype=_f64, device=band.device)
    for j in range(plan.nb):
        wj = int(plan.blk_w[j])
        c0 = j * s
        Ljj = chol_nan(band[c0:c0 + s, w * s:(w + 1) * s])
        inv = torch.linalg.solve_triangular(Ljj, eye, upper=False)
        out = plan.panel(panels, j)
        out[0] = inv
        if not wj:
            continue
        # subdiagonal block (j+1+m, j) sits in block row j+1+m at window
        # offset (w-1-m)s
        P = torch.stack([
            band[(j + 1 + m) * s:(j + 2 + m) * s, (w - 1 - m) * s:(w - m) * s]
            for m in range(wj)
        ])
        T = torch.matmul(P, inv.mT)
        out[1:] = T
        Tf = T.reshape(wj * s, s)
        U = torch.matmul(Tf, Tf.mT)
        # block (j+1+m, j+1+p), p <= m, sits at window offset (w-m+p)s
        for m in range(wj):
            r0 = (j + 1 + m) * s
            width = (m + 1) * s
            band[r0:r0 + s, (w - m) * s:(w - m) * s + width] -= (
                U[m * s:(m + 1) * s, :width])
    return panels


def band_factor_ok(panels) -> bool:
    """All-finite check on the factor (``band.py:311-318``)."""
    return bool(torch.isfinite(panels).all())


# ---------------------------------------------------------------------------
# K5c band_solve
# ---------------------------------------------------------------------------


def band_solve(plan: BandPlan, panels, rhs):
    """``(L L^T)^{-1} rhs`` for ``rhs`` (n,) in the original ordering:
    zero-extended to nrow_tot, permuted by ``perm_ext``, forward and
    backward substitution against the panels, permuted back by
    ``invp_ext`` (``band_tri_solve_fn``, ``band.py:369-385``)."""
    arrs = plan.on(rhs.device)
    kernels.check(rhs, "rhs", (plan.n,), _f64)
    kernels.check(panels, "panels", (int(plan.panel_off[-1]),), _f64)
    if not kernels.on_card(rhs, panels, arrs["perm_ext"]):
        return band_solve_plain(plan, panels, rhs)
    _kernel_block(plan)
    work = torch.empty((plan.nrow_tot,), dtype=_f64, device=rhs.device)
    # the backward step's column sums: at most 2 w row groups of 64
    partial = torch.empty((2 * plan.w, plan.s), dtype=_f64,
                          device=rhs.device)
    out = torch.empty((plan.n,), dtype=_f64, device=rhs.device)
    kernels.launch("band_solve", "sanm_band_solve", panels.data_ptr(),
                   plan.panel_off.ctypes.data, plan.blk_w.ctypes.data,
                   arrs["perm_ext"].data_ptr(), arrs["invp_ext"].data_ptr(),
                   rhs.data_ptr(), work.data_ptr(), partial.data_ptr(),
                   out.data_ptr(), plan.n, plan.nrow_tot, plan.nb)
    return out


def band_tri_solve_plain(plan: BandPlan, panels, rhs):
    """The substitutions on the padded, permuted vector (nrow_tot,)
    (``band_tri_solve``, ``band.py:321-366``); pad rows solve to exact
    zeros."""
    s = plan.s
    r = rhs.clone()
    for j in range(plan.nb):
        wj = int(plan.blk_w[j])
        c0 = j * s
        P = plan.panel(panels, j)
        yj = P[0] @ r[c0:c0 + s]
        if wj:
            r[c0 + s:c0 + s + wj * s] -= P[1:].reshape(wj * s, s) @ yj
        r[c0:c0 + s] = yj
    for j in reversed(range(plan.nb)):
        wj = int(plan.blk_w[j])
        c0 = j * s
        P = plan.panel(panels, j)
        yj = r[c0:c0 + s]
        if wj:
            yj = yj - r[c0 + s:c0 + s + wj * s] @ P[1:].reshape(wj * s, s)
        r[c0:c0 + s] = yj @ P[0]
    return r


def band_solve_plain(plan: BandPlan, panels, rhs):
    arrs = plan.on(rhs.device)
    rf = torch.zeros((plan.nrow_tot,), dtype=_f64, device=rhs.device)
    rf[: plan.n] = rhs
    y = band_tri_solve_plain(plan, panels, rf[arrs["perm_ext"].long()])
    return y[arrs["invp_ext"].long()][: plan.n]


class DeviceBandCholSolver(RefinedCholSolver):
    """Factorize once, back-substitute N times on the card
    (``band.py:388-440``): the working band is assembled and factored in
    the constructor and freed; each solve runs one permuted substitution
    per refinement trip (:class:`~sanm_tpu_torch.solver.linear.
    RefinedCholSolver`)."""

    name = "band_chol"

    def __init__(self, plan: BandPlan, data, matvec, l2_penalty=0.0,
                 refine_steps: int = REFINE_STEPS):
        super().__init__(matvec, l2_penalty, refine_steps)
        self.plan = plan
        band, self.scale = band_assemble(plan, data)
        self.panels = band_factor(plan, band)
        del band

    def factor_ok(self) -> bool:
        return band_factor_ok(self.panels)

    def tri_solve(self, r):
        return band_solve(self.plan, self.panels, r)
