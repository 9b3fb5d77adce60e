"""K2 and K3: the condensed remaps and the Jacobian + CSR assembly.

Device half of ``sanm_tpu/solver/remap.py``'s ``SparseAssembler``:

* K2 :func:`remap_in` / :func:`remap_out` replace ``apply_in`` /
  ``apply_out`` (``:308-339``), once per Taylor order;
* K3 :func:`jac_asm` replaces ``jac_asm`` of
  ``sanm_tpu/solver/anm.py:278-291`` (``batched_jacobian`` +
  ``assemble_csr_elem``), once per restart, specialised to the NHC stress.

Both scatter-adds (``apply_out`` and the CSR assembly) are summed in
gather form from host-built inverse maps, in a fixed order and without
atomics (``csrc/remap.cu``, ``csrc/jac_asm.cu``).  Each wrapper launches
its kernel for tensors on the card, runs its ``*_plain`` torch version
for tensors on the CPU, and raises for anything else.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..ops.nhc_series import NHCElements
from ..utils import SANMError
from .remap import inverse_maps

_f64 = torch.float64
_i32 = torch.int32


class DeviceAssembler:
    """The assembler plan's arrays on one device, plus the inverse maps.

    ``Lin`` (B, idim, Din), ``Lout`` (B, Dout, odim), ``loc_cols``
    (B, Din) with pad n+1, ``loc_rows`` (B, Dout) with pad n_rows,
    ``slot_pos`` (B*Dout*Din,) with dump value nnz; ``csr_rowidx`` /
    ``csr_cols`` stay on the host for SciPy."""

    def __init__(self, Lin, Lout, loc_rows, loc_cols, slot_pos, csr_rowidx,
                 csr_cols, n_rows, n, device, has_t=False):
        if has_t:
            raise SANMError("a t column in the assembly (implicit "
                            "continuation) is not ported yet")
        dev = torch.device(device)
        self.device = dev
        self.B, self.idim, self.Din = Lin.shape
        self.Dout, self.odim = Lout.shape[1:]
        self.n, self.n_rows = int(n), int(n_rows)
        self.nnz = len(csr_rowidx)
        self.csr_rowidx = np.asarray(csr_rowidx, np.int32)
        self.csr_cols = np.asarray(csr_cols, np.int32)
        row_ptr, row_ent, nz_ptr, nz_slot = inverse_maps(
            np.asarray(loc_rows), self.n_rows, np.asarray(slot_pos), self.nnz
        )

        def dt(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                device=dev, dtype=dtype).contiguous()

        self.Lin = dt(Lin, _f64)
        self.Lout = dt(Lout, _f64)
        self.loc_cols = dt(loc_cols, _i32)
        self.loc_rows = dt(loc_rows, _i32)
        self.slot_pos = dt(slot_pos, _i32)
        self.row_ptr = dt(row_ptr, _i32)
        self.row_ent = dt(row_ent, _i32)
        self.nz_ptr = dt(nz_ptr, _i32)
        self.nz_slot = dt(nz_slot, _i32)

    @classmethod
    def from_plan(cls, plan, device):
        """From a host :class:`~sanm_tpu_torch.solver.remap.SparseAssembler`."""
        return cls(plan.Lin, plan.Lout, plan.loc_rows, plan.loc_cols,
                   plan.slot_pos, plan.csr_rowidx, plan.csr_cols,
                   plan.n_rows, plan.n, device, plan.has_t)

    def pad_vector(self, xt):
        """The (n+2,) remap_in operand: the (n+1,) solver vector (t entry
        included) plus one dead zero that the pad columns index."""
        xp = torch.zeros(self.n + 2, dtype=_f64, device=self.device)
        xp[: xt.shape[0]] = torch.as_tensor(xt, dtype=_f64).to(self.device)
        return xp

    def apply_in(self, xt):
        """remap_in of the full solver vector (numpy or tensor, length n or
        n+1): the (B, idim) graph input."""
        return remap_in(self, self.pad_vector(xt))

    def apply_out(self, b):
        """remap_out of the (B, odim) graph output: the (n_rows,) vector."""
        return remap_out(self, b)


# ---------------------------------------------------------------------------
# K2 remap_in
# ---------------------------------------------------------------------------


def remap_in(asm: DeviceAssembler, xp, out=None):
    """gin[b, q] = sum_d Lin[b, q, d] * xp[loc_cols[b, d]];
    ``xp`` (n+2,) float64 (see :meth:`DeviceAssembler.pad_vector`)."""
    kernels.check(xp, "xp", (asm.n + 2,), _f64)
    if out is None:
        out = torch.empty((asm.B, asm.idim), dtype=_f64, device=xp.device)
    kernels.check(out, "out", (asm.B, asm.idim), _f64)
    if not kernels.on_card(xp, out, asm.Lin, asm.loc_cols):
        return remap_in_plain(asm, xp, out)
    kernels.launch("remap_in", "sanm_remap_in", asm.Lin.data_ptr(),
                   asm.loc_cols.data_ptr(), xp.data_ptr(), out.data_ptr(),
                   asm.B, asm.idim, asm.Din)
    return out


def remap_in_plain(asm: DeviceAssembler, xp, out=None):
    gin = (asm.Lin * xp[asm.loc_cols.long()][:, None, :]).sum(-1)
    if out is None:
        return gin
    return out.copy_(gin)


# ---------------------------------------------------------------------------
# K2 remap_out
# ---------------------------------------------------------------------------


def remap_out(asm: DeviceAssembler, bb, out=None):
    """out[r] = sum_{(b,i) -> r} sum_p Lout[b, i, p] * bb[b, p];
    ``bb`` (B, odim) float64."""
    kernels.check(bb, "bb", (asm.B, asm.odim), _f64)
    if out is None:
        out = torch.empty((asm.n_rows,), dtype=_f64, device=bb.device)
    kernels.check(out, "out", (asm.n_rows,), _f64)
    if not kernels.on_card(bb, out, asm.Lout, asm.row_ptr):
        return remap_out_plain(asm, bb, out)
    contrib = torch.empty((asm.B * asm.Dout,), dtype=_f64, device=bb.device)
    kernels.launch("remap_out", "sanm_remap_out", asm.Lout.data_ptr(),
                   bb.data_ptr(), asm.row_ptr.data_ptr(),
                   asm.row_ent.data_ptr(), contrib.data_ptr(),
                   out.data_ptr(), asm.n_rows, asm.B * asm.Dout, asm.Dout,
                   asm.odim)
    return out


def remap_out_plain(asm: DeviceAssembler, bb, out=None):
    contrib = (asm.Lout * bb[:, None, :]).sum(-1)
    acc = torch.zeros(asm.n_rows + 1, dtype=_f64, device=bb.device)
    acc.index_add_(0, asm.loc_rows.reshape(-1).long(), contrib.reshape(-1))
    if out is None:
        return acc[: asm.n_rows]
    return out.copy_(acc[: asm.n_rows])


# ---------------------------------------------------------------------------
# K3 Jacobian + CSR assembly
# ---------------------------------------------------------------------------


def jac_asm(asm: DeviceAssembler, elems: NHCElements, gin0):
    """Per-element NHC Jacobian at graph input ``gin0`` (B, 9), condensed
    stiffness E (B, Dout, Din) and the CSR values (nnz,) over
    ``(asm.csr_rowidx, asm.csr_cols)``.  Returns ``(data, E)``."""
    if (asm.idim, asm.odim) != (9, 9):
        raise SANMError("jac_asm takes 3x3 graph inputs and outputs")
    kernels.check(gin0, "gin0", (asm.B, 9), _f64)
    kernels.check(elems.dminv, "dminv", (asm.B, 9), _f64)
    kernels.check(elems.bias, "bias", (asm.B, 9), _f64)
    if not kernels.on_card(gin0, elems.dminv, elems.bias, asm.Lin,
                           asm.nz_ptr):
        return jac_asm_plain(asm, elems, gin0)
    E = torch.empty((asm.B, asm.Dout, asm.Din), dtype=_f64,
                    device=gin0.device)
    data = torch.empty((asm.nnz,), dtype=_f64, device=gin0.device)
    kernels.launch("jac_asm", "sanm_jac_asm", gin0.data_ptr(),
                   elems.bias.data_ptr(), elems.dminv.data_ptr(),
                   asm.Lout.data_ptr(), asm.Lin.data_ptr(),
                   asm.nz_ptr.data_ptr(), asm.nz_slot.data_ptr(),
                   E.data_ptr(), data.data_ptr(), asm.B, asm.Dout, asm.Din,
                   asm.nnz, float(elems.mu), float(elems.lam))
    return data, E


def nhc_jacobian_plain(elems: NHCElements, gin0):
    """(B, 9, 9) Jacobian of P(g) at ``gin0``: closed-form dP/dF of the
    NHC stress chained through F = (g + bias) Dm^-1 (see
    ``csrc/jac_asm.cu``)."""
    from ..ops.linalg import batched_det, batched_inv

    B = elems.B
    M = elems.dminv.reshape(B, 3, 3)
    F = torch.bmm((gin0 + elems.bias).reshape(B, 3, 3), M)
    G = batched_inv(F)
    H = torch.bmm(M, G)  # H[n, i] = sum_l M[n, l] G[l, i]
    c1 = elems.mu - elems.lam * torch.log(batched_det(F))
    eye = torch.eye(3, dtype=_f64, device=gin0.device)
    # J4[b, i, j, m, n]
    GT, HT = G.transpose(1, 2), H.transpose(1, 2)
    J4 = (
        elems.mu * eye[None, :, None, :, None]
        * M.transpose(1, 2)[:, None, :, None, :]  # mu d_im M[n, j]
        + c1[:, None, None, None, None]
        * G[:, None, :, :, None] * HT[:, :, None, None, :]  # G[j,m] H[n,i]
        + elems.lam
        * GT[:, :, :, None, None] * HT[:, None, None, :, :]  # G[j,i] H[n,m]
    )
    return J4.reshape(B, 9, 9)


def jac_asm_plain(asm: DeviceAssembler, elems: NHCElements, gin0):
    J = nhc_jacobian_plain(elems, gin0)
    E = torch.einsum("bdp,bpq,bqe->bde", asm.Lout, J, asm.Lin)
    acc = torch.zeros(asm.nnz + 1, dtype=_f64, device=gin0.device)
    acc.index_add_(0, asm.slot_pos.long(), E.reshape(-1))
    return acc[: asm.nnz].contiguous(), E
