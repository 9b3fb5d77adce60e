"""Static sparse linear remaps and the host plan of the condensed assembly.

Port of the host (NumPy) half of ``sanm_tpu/solver/remap.py``:
:class:`LinearRemap` (``:24-155``), ``_row_unique`` (``:157``) and the
plan built by ``SparseAssembler.__init__`` (``:207-289``).  On top of
that, :func:`inverse_maps` builds the maps that let the
device kernels sum the two scatter-adds in gather form, in a fixed order
and without atomics (see ``solver/assemble.py``).
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


def _gather_map(targets, n_targets):
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
    ``SparseAssembler.__init__`` computes them.  A t column (implicit
    continuation) is recognised (``has_t``), but its assembly belongs to
    the implicit slice and raises on the device side."""

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

        # ---- CSR structure over the (B, Dout, Din) element slots -------
        rows = np.broadcast_to(
            loc_rows[:, :, None], (B, Dout, Din)
        ).reshape(-1)
        cols = np.broadcast_to(
            loc_cols[:, None, :], (B, Dout, Din)
        ).reshape(-1)
        dead = (rows == row_pad) | (cols == col_pad)
        is_t = ~dead & (cols == n)
        mat_slot = ~dead & ~is_t
        keys = np.where(mat_slot, rows * (n + 2) + cols, -1)
        uniq, inv = np.unique(keys, return_inverse=True)
        offset = 1 if len(uniq) and uniq[0] == -1 else 0
        self.nnz = len(uniq) - offset
        uk = uniq[offset:]
        self.csr_rowidx = (uk // (n + 2)).astype(np.int32)  # COO rows
        self.csr_cols = (uk % (n + 2)).astype(np.int32)
        # slot -> nnz position (dump slot nnz for dead/t)
        self.slot_pos = np.where(
            mat_slot, inv - offset, self.nnz
        ).astype(np.int32)
        self.has_t = bool(is_t.any())


def inverse_maps(loc_rows, n_rows, slot_pos, nnz):
    """Gather-form maps for the deterministic device sums:
    ``(row_ptr, row_ent)``: output row r of ``apply_out`` sums the flat
    (b, i) entries ``row_ent[row_ptr[r]:row_ptr[r+1]]``;
    ``(nz_ptr, nz_slot)``: CSR value z sums the flat (b, i, j) slots
    ``nz_slot[nz_ptr[z]:nz_ptr[z+1]]``.  Both in ascending order."""
    row_ptr, row_ent = _gather_map(loc_rows, n_rows)
    nz_ptr, nz_slot = _gather_map(slot_pos, nnz)
    return row_ptr, row_ent, nz_ptr, nz_slot
