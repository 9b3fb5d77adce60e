"""Static sparse linear remaps and the host plan of the condensed assembly.

Port of the host (NumPy) half of ``sanm_tpu/solver/remap.py``:
:class:`LinearRemap` (``:24-155``), ``_row_unique`` (``:157``) and the
plan built by ``SparseAssembler.__init__`` (``:207-289``), the t column
of the implicit continuation included.  On top of that,
:func:`gather_map` inverts the scatter-adds (``apply_out``, the CSR
values, the t column and A^T y) so that the device kernels sum them in
gather form, in a fixed order and without atomics (see
``solver/assemble.py``); :func:`csr_row_ptr` and :func:`diag_block_map`
are the maps of the CSR products and the block-Jacobi preconditioner.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from ..utils import sanm_assert


class LinearRemap:
    """out[o] = sum_s coef[o, s] * x[idx[o, s]], stored as padded
    (n_out, width) index and coefficient arrays (mesh topology is
    static).  Dead slots have coefficient 0."""

    def __init__(self, idx, coef, inp_size: int, out_shape: Tuple[int, ...]):
        self.idx = np.ascontiguousarray(idx, np.int32)
        self.coef = np.ascontiguousarray(coef, np.float64)
        self.inp_size = int(inp_size)
        self.out_shape = tuple(out_shape)
        self.n_out = int(math.prod(self.out_shape))
        sanm_assert(self.idx.shape == self.coef.shape
                    and self.idx.shape[0] == self.n_out)
        self._transposed = None

    def apply_np(self, x):
        """Host apply to a flat (inp_size,) vector."""
        x = np.asarray(x).reshape(-1)
        return np.sum(self.coef * x[self.idx], axis=1).reshape(self.out_shape)

    def transposed_padded(self):
        """Per-input-position padded list of (output_row, coef): arrays
        (inp_size, T).  Entries of one input keep the (row, slot) order
        in which they occur, as the JAX package builds them."""
        if self._transposed is not None:
            return self._transposed
        n_out, width = self.idx.shape
        flat_c = self.coef.reshape(-1)
        live = np.nonzero(flat_c != 0.0)[0]
        inp = self.idx.reshape(-1)[live]
        order = np.argsort(inp, kind="stable")
        inp_s = inp[order]
        src = live[order]
        counts = np.bincount(inp_s, minlength=self.inp_size)
        T = max(int(counts.max(initial=0)), 1)
        start = np.zeros(self.inp_size + 1, np.int64)
        np.cumsum(counts, out=start[1:])
        pos = np.arange(len(inp_s)) - start[inp_s]
        ridx = np.zeros((self.inp_size, T), np.int32)
        rcoef = np.zeros((self.inp_size, T), np.float64)
        ridx[inp_s, pos] = src // width
        rcoef[inp_s, pos] = flat_c[src]
        self._transposed = (ridx, rcoef)
        return self._transposed


def _row_unique(vals, pad):
    """Per-row unique of a (B, W) int array where ``pad`` marks dead
    slots (pad must compare greater than every live value).

    Returns ``(uniq (B, D), loc (B, W), D)``: ``uniq`` padded with
    ``pad``; ``loc[b, w]`` is the local index of ``vals[b, w]`` within
    ``uniq[b]`` (arbitrary-but-valid for dead slots, whose coefficients
    are zero)."""
    B, W = vals.shape
    order = np.argsort(vals, axis=1, kind="stable")
    sv = np.take_along_axis(vals, order, axis=1)
    isnew = np.ones((B, W), bool)
    isnew[:, 1:] = sv[:, 1:] != sv[:, :-1]
    isnew &= sv != pad  # dead slots sort last
    loc_sorted = np.cumsum(isnew, axis=1) - 1
    D = max(int(loc_sorted.max(initial=-1)) + 1, 1)
    uniq = np.full((B, D), pad, vals.dtype)
    bidx = np.broadcast_to(np.arange(B)[:, None], (B, W))
    uniq[bidx[isnew], loc_sorted[isnew]] = sv[isnew]
    loc = np.empty((B, W), np.int64)
    np.put_along_axis(loc, order, np.maximum(loc_sorted, 0), axis=1)
    return uniq, loc, D


def gather_map(targets, n_targets):
    """Inverse of a scatter: for every target t the sources s with
    ``targets[s] == t``, in ascending s.  Sources aimed at ``n_targets``
    or beyond are dead.  Returns CSR-style (ptr (n_targets+1,), src)
    int32 arrays."""
    targets = np.asarray(targets).reshape(-1)
    live = np.nonzero(targets < n_targets)[0]
    order = np.argsort(targets[live], kind="stable")
    src = live[order].astype(np.int32)
    counts = np.bincount(targets[live], minlength=n_targets)
    ptr = np.zeros(n_targets + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    sanm_assert(ptr[-1] < 2 ** 31, "gather map too large for int32")
    return ptr.astype(np.int32), src


class SparseAssembler:
    """Host plan of the static-topology assembly A = R_out blockdiag(J) R_in.

    Per element ``b`` the remaps touch only a handful of distinct global
    rows/columns, so A decomposes as::

        E[b] = Lout[b] @ J[b] @ Lin[b]          (B, Dout, Din)
        A[loc_rows[b, i], loc_cols[b, j]] += E[b, i, j]

    The arrays are computed exactly as ``sanm_tpu``'s
    ``SparseAssembler.__init__`` computes them: the condensed remaps
    (``Lin``, ``Lout``, ``loc_rows``, ``loc_cols``) here, the CSR side
    (:data:`CSR_ATTRS`, :func:`csr_plan`) at first use.  Contributions
    in the t column (column n, implicit continuation) go to the grad_t
    vector through ``t_slot_row`` instead of the CSR values."""

    def __init__(self, remap_out: LinearRemap, remap_in: LinearRemap,
                 B: int, odim: int, idim: int, n_unknown: int):
        self.B, self.odim, self.idim = B, odim, idim
        self.n = n = int(n_unknown)
        self.n_rows = remap_out.n_out

        # ---- columns: distinct unknowns read by each element ----------
        in_idx = remap_in.idx.reshape(B, -1).astype(np.int64)
        in_coef = remap_in.coef.reshape(B, -1)
        col_pad = n + 1  # real cols in [0, n]; n = the t column
        cvals = np.where(in_coef != 0, in_idx, col_pad)
        loc_cols, cloc, Din = _row_unique(cvals, col_pad)
        Lin = np.zeros((B, idim, Din))
        bI = np.broadcast_to(np.arange(B)[:, None], cvals.shape)
        qI = np.broadcast_to(
            np.repeat(np.arange(idim), in_idx.shape[1] // idim)[None, :],
            cvals.shape,
        )
        np.add.at(Lin, (bI, qI, cloc), in_coef)

        # ---- rows: distinct unknowns written by each element ----------
        outT_idx, outT_coef = remap_out.transposed_padded()
        oT = outT_idx.reshape(B, -1).astype(np.int64)
        oC = outT_coef.reshape(B, -1)
        row_pad = self.n_rows
        rvals = np.where(oC != 0, oT, row_pad)
        loc_rows, rloc, Dout = _row_unique(rvals, row_pad)
        Lout = np.zeros((B, Dout, odim))
        bO = np.broadcast_to(np.arange(B)[:, None], rvals.shape)
        pO = np.broadcast_to(
            np.repeat(np.arange(odim), oT.shape[1] // odim)[None, :],
            rvals.shape,
        )
        np.add.at(Lout, (bO, rloc, pO), oC)

        self.Dout, self.Din = Dout, Din
        self.Lout, self.Lin = Lout, Lin
        self.loc_rows = loc_rows.astype(np.int32)  # (B, Dout), pad=n_rows
        self.loc_cols = loc_cols.astype(np.int32)  # (B, Din), pad=n+1

    #: the CSR side of the plan, built at first use (a force-only model
    #: never builds it)
    CSR_ATTRS = ("nnz", "csr_rowidx", "csr_cols", "slot_pos", "t_slot_row",
                 "has_t")

    def __getattr__(self, name):
        if name in SparseAssembler.CSR_ATTRS:
            self.__dict__.update(csr_plan(self.loc_rows, self.loc_cols,
                                          self.n_rows, self.n))
            return self.__dict__[name]
        raise AttributeError(name)

    def _diag_nnz_pos(self):
        """``(pos, row)``: the CSR positions of the diagonal entries and
        their rows (``sanm_tpu/solver/remap.py:380-387``)."""
        return diag_nnz_pos(self.csr_rowidx, self.csr_cols)


def csr_plan(loc_rows, loc_cols, n_rows, n):
    """The CSR structure over the (B, Dout, Din) element slots, as
    ``sanm_tpu``'s ``SparseAssembler.__init__`` computes it
    (``:255-279``): ``nnz``; the COO ``csr_rowidx`` / ``csr_cols``;
    ``slot_pos`` (slot -> value position, dump value nnz for dead and t
    slots); ``t_slot_row`` (t-column slot -> its row, dump value
    n_rows elsewhere) and ``has_t``."""
    B, Dout = loc_rows.shape
    Din = loc_cols.shape[1]
    rows = np.broadcast_to(
        loc_rows[:, :, None].astype(np.int64), (B, Dout, Din)).reshape(-1)
    cols = np.broadcast_to(
        loc_cols[:, None, :].astype(np.int64), (B, Dout, Din)).reshape(-1)
    dead = (rows == n_rows) | (cols == n + 1)
    is_t = ~dead & (cols == n)
    mat_slot = ~dead & ~is_t
    keys = np.where(mat_slot, rows * (n + 2) + cols, -1)
    uniq, inv = np.unique(keys, return_inverse=True)
    offset = 1 if len(uniq) and uniq[0] == -1 else 0
    nnz = len(uniq) - offset
    uk = uniq[offset:]
    return dict(
        nnz=nnz,
        csr_rowidx=(uk // (n + 2)).astype(np.int32),
        csr_cols=(uk % (n + 2)).astype(np.int32),
        slot_pos=np.where(mat_slot, inv - offset, nnz).astype(np.int32),
        t_slot_row=np.where(is_t, rows, n_rows).astype(np.int32),
        has_t=bool(is_t.any()),
    )


def diag_nnz_pos(csr_rowidx, csr_cols):
    """The CSR positions ``pos`` with ``rowidx == cols`` and their rows,
    both int32, in CSR order."""
    rowidx = np.asarray(csr_rowidx)
    sel = np.nonzero(rowidx == np.asarray(csr_cols))[0]
    return sel.astype(np.int32), rowidx[sel].astype(np.int32)


def csr_row_ptr(csr_rowidx, n_rows):
    """The (n_rows+1,) int32 row pointer of row-sorted COO rows: row r's
    values are positions ``ptr[r] : ptr[r+1]``.  Raises unless the rows
    are sorted (the CSR of :func:`csr_plan` is, by construction)."""
    rowidx = np.asarray(csr_rowidx).reshape(-1)
    sanm_assert(not (np.diff(rowidx) < 0).any(), "CSR rows are not sorted")
    counts = np.bincount(rowidx, minlength=n_rows)
    sanm_assert(len(counts) == n_rows, "CSR row index out of range")
    ptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    sanm_assert(ptr[-1] < 2 ** 31, "CSR too large for int32")
    return ptr.astype(np.int32)


def diag_block_map(csr_rowidx, csr_cols, n, nnz, block):
    """The (n/block, block, block) int32 value positions of the diagonal
    blocks, dump value ``nnz`` where a block has no value, built as
    ``sanm_tpu/solver/remap.py:423-437`` builds it."""
    nb = n // block
    r = np.asarray(csr_rowidx).astype(np.int64)
    c = np.asarray(csr_cols).astype(np.int64)
    sel = (r // block == c // block) & (r < n)
    dmap = np.full((nb, block, block), nnz, np.int32)
    dmap[r[sel] // block, r[sel] % block, c[sel] % block] = (
        np.nonzero(sel)[0].astype(np.int32))
    return dmap
