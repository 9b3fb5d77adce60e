"""K2 and K3: the condensed remaps and the Jacobian + CSR assembly.

Device half of ``sanm_tpu/solver/remap.py``'s ``SparseAssembler``:

* K2 :func:`remap_in` / :func:`remap_out` replace ``apply_in`` /
  ``apply_out`` (``:308-339``), once per Taylor order;
* :func:`jac_asm` replaces ``jac_asm`` of
  ``sanm_tpu/solver/anm.py:278-291`` (``batched_jacobian`` +
  ``assemble_csr_elem``), once per restart, with the material's
  closed-form Jacobian: K3 for the NHC stress, K3n
  (:func:`jac_asm_nhi`) for NHI, K3s (:func:`jac_asm_stvk`) for the StVK
  stretch, K8c (:func:`jac_asm_arap`) for ARAP,
  whose SVD-W of F runs through K8a first, and for the inverse model's
  Cauchy stress K3i (:func:`jac_asm_inv` NHC, :func:`jac_asm_inv_nhi`
  NHI; ``solver/anm.py:278`` on ``make_inverse``'s graph); each returns
  ``(data, grad_t, E)``, where grad_t, the assembled t column of the
  implicit continuation (None without one), is K3t :func:`grad_t`;
* K10 :func:`hess_proj` (NHC), :func:`hess_proj_nhi` and
  :func:`hess_proj_arap` replace ``_Kernels.hess_blocks`` of
  ``sanm_tpu/fea/baseline.py:178`` (the baselines' eigen-projected
  element Hessians): the material's dP/dF in F, projected, then K3's E
  and CSR values, ``(data, E)``;
* K4 :func:`element_matvec` replaces ``SparseAssembler.element_matvec``
  (``sanm_tpu/solver/remap.py:453-478``): A x from the condensed element
  stiffness E, for the refinement and the sanity residual of the band
  solve;
* K4 COO :func:`csr_matvec`, :func:`csr_matvec_t` and :func:`diag_blocks`
  replace ``SparseAssembler.matvec`` / ``matvec_t`` / ``diag_blocks``
  (``:423-451``): A x and A^T y from the CSR values, and the 3 x 3
  diagonal blocks, for the PCG solver (``cg``, ``solver/linear.py``) on
  the maps of :class:`CSRMaps`.

K5a's scaled, sign-flipped scatter (:func:`scaled_scatter`, launched
as ``band_assemble``) serves the three Cholesky solvers: the band
(``solver/band.py``), the dense matrix of :class:`DensePlan`
(``dense_chol``, ``sanm_tpu/solver/remap.py:380-421``) and the SPIKE
partitions (``solver/spike.py``).

The scatter-adds (``apply_out``, the CSR assembly, grad_t,
``element_matvec``, A^T y) are summed in gather form from host-built
inverse maps, in a fixed order and without atomics (``csrc/remap.cu``,
``csrc/jac_asm.cu``, ``csrc/cg.cu``).  Each wrapper launches its kernel
for tensors on the card, runs its ``*_plain`` torch version for tensors
on the CPU, and raises for anything else.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from .. import kernels
from ..ops.elements import Elements, InvElements
from ..ops.svd_w import svd_w_jvp
from ..utils import SANMError
from .remap import csr_row_ptr, diag_block_map, diag_nnz_pos, gather_map

_f64 = torch.float64
_i32 = torch.int32
_i64 = torch.int64


class DeviceAssembler:
    """The assembler plan's arrays on one device, plus the inverse maps.

    ``Lin`` (B, idim, Din), ``Lout`` (B, Dout, odim), ``loc_cols``
    (B, Din) with pad n+1, ``loc_rows`` (B, Dout) with pad n_rows, and
    the gather map of ``apply_out``, built here.  ``csr`` is the host CSR
    side: an object with the attributes of
    :data:`~sanm_tpu_torch.solver.remap.SparseAssembler.CSR_ATTRS`
    (``slot_pos`` (B*Dout*Din,) with dump value nnz, ``csr_rowidx`` /
    ``csr_cols``, ``t_slot_row``, ``has_t``), from which the Jacobian's
    arrays are built (``csr_rowidx`` / ``csr_cols`` stay on the host for
    SciPy); None makes a force-only assembler (``jacobian`` False), which
    has the remaps alone."""

    def __init__(self, Lin, Lout, loc_rows, loc_cols, n_rows, n, device,
                 csr=None):
        dev = torch.device(device)
        self.device = dev
        self.B, self.idim, self.Din = Lin.shape
        self.Dout, self.odim = Lout.shape[1:]
        self.n, self.n_rows = int(n), int(n_rows)
        loc_rows = np.asarray(loc_rows)
        row_ptr, row_ent = gather_map(loc_rows, self.n_rows)
        # K4's map from an entry (b, i) to its place in row order (-1:
        # dead), the inverse of row_ent
        ent_pos = np.full(loc_rows.size, -1, np.int32)
        ent_pos[row_ent] = np.arange(row_ent.size, dtype=np.int32)
        self.Lin = self._dev(Lin, _f64)
        self.Lout = self._dev(Lout, _f64)
        self.loc_cols = self._dev(loc_cols, _i32)
        self.loc_rows = self._dev(loc_rows, _i32)
        self.row_ptr = self._dev(row_ptr, _i32)
        self.row_ent = self._dev(row_ent, _i32)
        self.ent_pos = self._dev(ent_pos, _i32)
        self.n_live = int(row_ent.size)
        self.jacobian = csr is not None
        if not self.jacobian:
            return
        self.nnz = len(csr.csr_rowidx)
        self.csr_rowidx = np.asarray(csr.csr_rowidx, np.int32)
        self.csr_cols = np.asarray(csr.csr_cols, np.int32)
        slot_pos = np.asarray(csr.slot_pos)
        nz_ptr, nz_slot = gather_map(slot_pos, self.nnz)
        self.slot_pos = self._dev(slot_pos, _i32)
        self.nz_ptr = self._dev(nz_ptr, _i32)
        self.nz_slot = self._dev(nz_slot, _i32)
        self.has_t = bool(csr.has_t)
        self.t_slot_row = self.t_ptr = self.t_slot = None
        if self.has_t:
            t_ptr, t_slot = gather_map(csr.t_slot_row, self.n_rows)
            self.t_slot_row = self._dev(csr.t_slot_row, _i32)
            self.t_ptr = self._dev(t_ptr, _i32)
            self.t_slot = self._dev(t_slot, _i32)

    def _dev(self, a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            device=self.device, dtype=dtype).contiguous()

    @functools.cached_property
    def csr_maps(self) -> "CSRMaps":
        """The maps of the CSR products on this device, built at first use
        (only the ``cg`` solver reads them)."""
        return CSRMaps(self.csr_rowidx, self.csr_cols, self.n_rows, self.n,
                       self.device)

    @classmethod
    def from_plan(cls, plan, device, jacobian=True):
        """From a host :class:`~sanm_tpu_torch.solver.remap.SparseAssembler`
        (force-only unless ``jacobian``; then its CSR side is built)."""
        return cls(plan.Lin, plan.Lout, plan.loc_rows, plan.loc_cols,
                   plan.n_rows, plan.n, device, plan if jacobian else None)

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
# K4 element_matvec
# ---------------------------------------------------------------------------


def element_matvec(asm: DeviceAssembler, E, x):
    """A x (n_rows,) from the condensed element stiffness ``E``
    (B, Dout, Din) for ``x`` (n,): per element the (Dout x Din)
    contraction of the gathered unknowns (the t column and the dead
    padding read as zero), then the row sums of ``apply_out``.  The
    kernel stores each entry's contraction at its place in row order
    (``ent_pos``) and sums each row's stretch in ascending order."""
    kernels.check(E, "E", (asm.B, asm.Dout, asm.Din), _f64)
    kernels.check(x, "x", (asm.n,), _f64)
    if not kernels.on_card(E, x, asm.loc_cols, asm.row_ptr):
        return element_matvec_plain(asm, E, x)
    out = torch.empty((asm.n_rows,), dtype=_f64, device=x.device)
    crow = torch.empty((asm.n_live,), dtype=_f64, device=x.device)
    kernels.launch("element_matvec", "sanm_element_matvec", E.data_ptr(),
                   asm.loc_cols.data_ptr(), x.data_ptr(),
                   asm.ent_pos.data_ptr(), asm.row_ptr.data_ptr(),
                   crow.data_ptr(), out.data_ptr(), asm.n, asm.n_rows,
                   asm.B, asm.Dout, asm.Din)
    return out


def element_matvec_plain(asm: DeviceAssembler, E, x):
    xp = torch.zeros(asm.n + 2, dtype=_f64, device=x.device)
    xp[: asm.n] = x
    contrib = (E * xp[asm.loc_cols.long()][:, None, :]).sum(-1)
    acc = torch.zeros(asm.n_rows + 1, dtype=_f64, device=x.device)
    acc.index_add_(0, asm.loc_rows.reshape(-1).long(), contrib.reshape(-1))
    return acc[: asm.n_rows]


# ---------------------------------------------------------------------------
# K3t grad_t: the t column of the implicit continuation's Jacobian
# ---------------------------------------------------------------------------


def grad_t(asm: DeviceAssembler, E):
    """K3t: grad_t (n_rows,), row r the sum of the condensed stiffness
    E's (B, Dout, Din) t-column slots of that row, in ascending slot
    order; None when the plan has no t column."""
    if not asm.has_t:
        return None
    kernels.check(E, "E", (asm.B, asm.Dout, asm.Din), _f64)
    if not kernels.on_card(E, asm.t_ptr, asm.t_slot):
        return grad_t_plain(asm, E)
    out = torch.empty((asm.n_rows,), dtype=_f64, device=E.device)
    kernels.launch("grad_t", "sanm_grad_t", E.data_ptr(),
                   asm.t_ptr.data_ptr(), asm.t_slot.data_ptr(),
                   out.data_ptr(), asm.n_rows)
    return out


def grad_t_plain(asm: DeviceAssembler, E):
    """Plain torch version of K3t: E's slots scatter-added over
    ``t_slot_row`` (dump row n_rows), as ``assemble_csr_elem``."""
    acc = torch.zeros(asm.n_rows + 1, dtype=_f64, device=E.device)
    acc.index_add_(0, asm.t_slot_row.long(), E.reshape(-1))
    return acc[: asm.n_rows].contiguous()


# ---------------------------------------------------------------------------
# Jacobian + CSR assembly: K3 (NHC), K3n (NHI), K8c (ARAP), K3i (inverse)
# ---------------------------------------------------------------------------


def _check_3x3(asm):
    if (asm.idim, asm.odim) != (9, 9):
        raise SANMError("jac_asm takes 3x3 graph inputs and outputs")


def _check_jac(asm, elems, gin0, const="dminv"):
    _check_3x3(asm)
    kernels.check(gin0, "gin0", (asm.B, 9), _f64)
    kernels.check(getattr(elems, const), const, (asm.B, 9), _f64)
    kernels.check(elems.bias, "bias", (asm.B, 9), _f64)


def _jac_asm_nh(asm, elems, gin0, counter, fn_name, c2, plain,
                const="dminv"):
    """A Neo-Hookean Jacobian + assembly kernel (K3, K3n or K3i), whose C
    entry point takes the graph input, the bias, the per-element matrix
    ``const`` (Dm^-1, or the inverse model's Ds) and (mu, ``c2``)."""
    _check_jac(asm, elems, gin0, const)
    mat = getattr(elems, const)
    if not kernels.on_card(gin0, mat, elems.bias, asm.Lin, asm.nz_ptr):
        return plain(asm, elems, gin0)
    E = torch.empty((asm.B, asm.Dout, asm.Din), dtype=_f64,
                    device=gin0.device)
    data = torch.empty((asm.nnz,), dtype=_f64, device=gin0.device)
    kernels.launch(counter, fn_name, gin0.data_ptr(),
                   elems.bias.data_ptr(), mat.data_ptr(),
                   asm.Lout.data_ptr(), asm.Lin.data_ptr(),
                   asm.nz_ptr.data_ptr(), asm.nz_slot.data_ptr(),
                   E.data_ptr(), data.data_ptr(), asm.B, asm.Dout, asm.Din,
                   asm.nnz, float(elems.mu), float(c2))
    return data, grad_t(asm, E), E


def jac_asm(asm: DeviceAssembler, elems: Elements, gin0):
    """K3: per-element Jacobian of the NHC stress P(g) at graph input
    ``gin0`` (B, 9), condensed stiffness E (B, Dout, Din) and the CSR
    values (nnz,) over ``(asm.csr_rowidx, asm.csr_cols)``, then K3t's
    grad_t.  Returns ``(data, grad_t, E)``."""
    return _jac_asm_nh(asm, elems, gin0, "jac_asm", "sanm_jac_asm",
                       elems.lam, jac_asm_plain)


def jac_asm_nhi(asm: DeviceAssembler, elems: Elements, gin0):
    """K3n: :func:`jac_asm` for the NHI stress (mu and the bulk modulus
    kappa).  Launches the kernel for card tensors, runs
    :func:`jac_asm_nhi_plain` for CPU tensors."""
    return _jac_asm_nh(asm, elems, gin0, "jac_asm_nhi", "sanm_jac_asm_nhi",
                       elems.kappa, jac_asm_nhi_plain)


def jac_asm_stvk(asm: DeviceAssembler, elems: Elements, gin0):
    """K3s: :func:`jac_asm` for the StVK stretch stress P = mu (F F^T F -
    F) (mu only).  Launches the kernel for card tensors, runs
    :func:`jac_asm_stvk_plain` for CPU tensors."""
    _check_jac(asm, elems, gin0)
    if not kernels.on_card(gin0, elems.dminv, elems.bias, asm.Lin,
                           asm.nz_ptr):
        return jac_asm_stvk_plain(asm, elems, gin0)
    E = torch.empty((asm.B, asm.Dout, asm.Din), dtype=_f64,
                    device=gin0.device)
    data = torch.empty((asm.nnz,), dtype=_f64, device=gin0.device)
    kernels.launch("jac_asm_stvk", "sanm_jac_asm_stvk", gin0.data_ptr(),
                   elems.bias.data_ptr(), elems.dminv.data_ptr(),
                   asm.Lout.data_ptr(), asm.Lin.data_ptr(),
                   asm.nz_ptr.data_ptr(), asm.nz_slot.data_ptr(),
                   E.data_ptr(), data.data_ptr(), asm.B, asm.Dout, asm.Din,
                   asm.nnz, float(elems.mu))
    return data, grad_t(asm, E), E


def jac_asm_inv(asm: DeviceAssembler, elems: InvElements, gin0):
    """K3i: :func:`jac_asm` for the inverse model's NHC Cauchy stress in
    the rest shape (``elems`` an :class:`InvElements`).  Launches the
    kernel for card tensors, runs :func:`jac_asm_inv_plain` for CPU
    tensors."""
    return _jac_asm_nh(asm, elems, gin0, "jac_asm_inv", "sanm_jac_asm_inv",
                       elems.lam, jac_asm_inv_plain, "ds")


def jac_asm_inv_nhi(asm: DeviceAssembler, elems: InvElements, gin0):
    """K3i (NHI): :func:`jac_asm_inv` for the incompressible Cauchy
    stress (mu and the bulk modulus kappa)."""
    return _jac_asm_nh(asm, elems, gin0, "jac_asm_inv_nhi",
                       "sanm_jac_asm_inv_nhi", elems.kappa,
                       jac_asm_inv_nhi_plain, "ds")


def jac_asm_arap(asm: DeviceAssembler, elems: Elements, u, s, w):
    """K8c: the ARAP Jacobian of P(g) from the SVD-W ``(u, s, w)`` of F at
    the expansion point (K8a's results: (B, 3, 3), (B, 3), (B, 3, 3)),
    then E and the CSR values as :func:`jac_asm`.  Launches the kernel
    for card tensors, runs :func:`jac_asm_arap_plain` for CPU tensors."""
    _check_3x3(asm)
    B = asm.B
    kernels.check(u, "u", (B, 3, 3), _f64)
    kernels.check(s, "s", (B, 3), _f64)
    kernels.check(w, "w", (B, 3, 3), _f64)
    kernels.check(elems.dminv, "dminv", (B, 9), _f64)
    if not kernels.on_card(u, s, w, elems.dminv, asm.Lin, asm.nz_ptr):
        return jac_asm_arap_plain(asm, elems, u, s, w)
    E = torch.empty((B, asm.Dout, asm.Din), dtype=_f64, device=u.device)
    data = torch.empty((asm.nnz,), dtype=_f64, device=u.device)
    kernels.launch("jac_asm_arap", "sanm_jac_asm_arap", u.data_ptr(),
                   s.data_ptr(), w.data_ptr(), elems.dminv.data_ptr(),
                   asm.Lout.data_ptr(), asm.Lin.data_ptr(),
                   asm.nz_ptr.data_ptr(), asm.nz_slot.data_ptr(),
                   E.data_ptr(), data.data_ptr(), B, asm.Dout, asm.Din,
                   asm.nnz, float(elems.mu))
    return data, grad_t(asm, E), E


def nhc_dpdf_plain(elems: Elements, gin0):
    """(B, 9, 9) dP_ij/dF_ml of the NHC stress at F = (g + bias) Dm^-1,
    in F (before the chain through Dm^-1; see ``csrc/jac_asm.cu``)."""
    from ..ops.linalg import batched_det, batched_inv

    B = elems.B
    F = elems.deformation_gradient(gin0)
    G = batched_inv(F)
    GT = G.transpose(1, 2)
    c1 = elems.mu - elems.lam * torch.log(batched_det(F))
    eye = torch.eye(3, dtype=_f64, device=gin0.device)
    # D4[b, i, j, m, l]
    D4 = (elems.mu * eye[None, :, None, :, None]
          * eye[None, None, :, None, :]  # mu d_im d_jl
          + c1[:, None, None, None, None]
          * G[:, None, :, :, None] * GT[:, :, None, None, :]  # G_jm G_li
          + elems.lam
          * GT[:, :, :, None, None] * GT[:, None, None, :, :])  # G_ji G_lm
    return D4.reshape(B, 9, 9)


def nhi_dpdf_plain(elems: Elements, gin0):
    """(B, 9, 9) dP_ij/dF_ml of the NHI stress P = mu A F + c F^-T
    (A = J^(-2/3), c = (-mu/3) A Ic + kappa J^2 - kappa J), in F (see
    ``csrc/jac_asm.cu``)."""
    from ..ops.linalg import batched_det, batched_inv

    B = elems.B
    mu, kap = elems.mu, elems.kappa
    F = elems.deformation_gradient(gin0)
    G = batched_inv(F)
    GT = G.transpose(1, 2)
    J = batched_det(F)
    Ic = (F * F).sum((1, 2))
    A = J ** (-2.0 / 3.0)
    c = (-mu / 3.0) * A * Ic + kap * J * J - kap * J
    d1 = (2.0 * mu / 9.0) * A * Ic + 2.0 * kap * J * J - kap * J
    a23 = (2.0 * mu / 3.0) * A

    def b5(x):
        return x[:, None, None, None, None]

    eye = torch.eye(3, dtype=_f64, device=gin0.device)
    X = d1[:, None, None] * GT - a23[:, None, None] * F  # (B, m, l)
    # D4[b, i, j, m, l]
    D4 = (b5(mu * A) * eye[None, :, None, :, None]
          * eye[None, None, :, None, :]  # mu A d_im d_jl
          - b5(a23) * F[:, :, :, None, None] * GT[:, None, None, :, :]
          + GT[:, :, :, None, None] * X[:, None, None, :, :]  # G_ji X_ml
          - b5(c) * G[:, None, :, :, None] * GT[:, :, None, None, :])
    return D4.reshape(B, 9, 9)


def stvk_dpdf_plain(elems: Elements, gin0):
    """(B, 9, 9) dP_ij/dF_ml of the StVK stretch stress P = mu (F F^T F -
    F): mu (d_im C_lj + F_il F_mj + b_im d_jl - d_im d_jl) with C = F^T F,
    b = F F^T, in F (see ``csrc/jac_asm.cu``)."""
    B = elems.B
    F = elems.deformation_gradient(gin0)
    C = torch.bmm(F.transpose(1, 2), F)
    b = torch.bmm(F, F.transpose(1, 2))
    eye = torch.eye(3, dtype=_f64, device=gin0.device)
    # D4[b, i, j, m, l]
    D4 = (eye[None, :, None, :, None] * C.transpose(1, 2)[:, None, :, None, :]
          + F[:, :, None, None, :] * F.transpose(1, 2)[:, None, :, :, None]
          + b[:, :, None, :, None] * eye[None, None, :, None, :]
          - eye[None, :, None, :, None] * eye[None, None, :, None, :])
    return (elems.mu * D4).reshape(B, 9, 9)


def arap_dpdf_plain(elems: Elements, u, s, w):
    """(B, 9, 9) dP/dF of the ARAP stress mu (F - W(F)) from the SVD-W
    of F: per basis direction dF = e_m e_l^T, mu (dF - dW)."""
    B = elems.B
    D = torch.empty((B, 9, 9), dtype=_f64, device=u.device)
    for q in range(9):
        dF = torch.zeros((B, 3, 3), dtype=_f64, device=u.device)
        dF[:, q // 3, q % 3] = 1.0
        dw = svd_w_jvp(u, s, w, dF)[2]
        D[:, :, q] = ((dF - dw) * elems.mu).reshape(B, 9)
    return D


def chain_plain(elems: Elements, D):
    """(B, 9, 9) Jacobian in g from the F-space ``D`` (B, 9, 9) through
    F = (g + bias) Dm^-1: Jg[(i,j), (m,n)] = sum_l D[(i,j), (m,l)]
    Dm^-1[n, l]."""
    B = elems.B
    M = elems.dminv.reshape(B, 3, 3)
    return torch.einsum("bpml,bnl->bpmn", D.reshape(B, 9, 3, 3),
                        M).reshape(B, 9, 9)


def nhc_jacobian_plain(elems: Elements, gin0):
    """(B, 9, 9) Jacobian of the NHC stress P(g) at ``gin0``: its dP/dF
    chained through F (:func:`chain_plain`)."""
    return chain_plain(elems, nhc_dpdf_plain(elems, gin0))


def nhi_jacobian_plain(elems: Elements, gin0):
    """(B, 9, 9) Jacobian of the NHI stress P(g) at ``gin0``: its dP/dF
    chained through F (:func:`chain_plain`)."""
    return chain_plain(elems, nhi_dpdf_plain(elems, gin0))


def stvk_jacobian_plain(elems: Elements, gin0):
    """(B, 9, 9) Jacobian of the StVK stretch stress P(g) at ``gin0``: its
    dP/dF chained through F (:func:`chain_plain`)."""
    return chain_plain(elems, stvk_dpdf_plain(elems, gin0))


def _inv_factors(elems: InvElements, gin0):
    """Y = Dm^-1, F = Ds Y, b = F F^T, R = F Y^T (B, 3, 3) and
    J = det F (B,) at the rest shape ``gin0`` + bias."""
    from ..ops.linalg import batched_det, batched_inv

    B = elems.B
    Dm = (gin0 + elems.bias).reshape(B, 3, 3)
    Ds = elems.ds.reshape(B, 3, 3)
    Y = batched_inv(Dm)
    F = torch.bmm(Ds, Y)
    b = torch.bmm(F, F.transpose(1, 2))
    R = torch.bmm(F, Y.transpose(1, 2))
    return Y, F, b, R, batched_det(Ds) / batched_det(Dm)


def _inv_db(Y, F, b, R, a):
    """a (b_ij Y_nm) - F_im R_jn - R_in F_jm as J4[b, i, j, m, n]: with
    a = 1 the NHC, with a = 5/3 the NHI shape of dsigma/dDm."""
    YT = Y.transpose(1, 2)  # YT[m, n] = Y[n, m]
    return (a * b[:, :, :, None, None] * YT[:, None, None, :, :]
            - F[:, :, None, :, None] * R[:, None, :, None, :]
            - R[:, :, None, None, :] * F[:, None, :, :, None])


def inv_nhc_jacobian_plain(elems: InvElements, gin0):
    """(B, 9, 9) Jacobian of the inverse model's NHC Cauchy stress in g
    at ``gin0``: closed form through dF = -F dDm Dm^-1 (see
    ``csrc/jac_asm.cu``)."""
    B = elems.B
    Y, F, b, R, J = _inv_factors(elems, gin0)
    Jinv = 1.0 / J
    cd = Jinv * (elems.mu + elems.lam * (torch.log(Jinv) + 1.0))
    eye = torch.eye(3, dtype=_f64, device=gin0.device)
    YT = Y.transpose(1, 2)
    J4 = ((elems.mu * Jinv)[:, None, None, None, None] * _inv_db(Y, F, b, R,
                                                                 1.0)
          - (cd[:, None, None] * YT)[:, None, None, :, :]
          * eye[None, :, :, None, None])
    return J4.reshape(B, 9, 9)


def inv_nhi_jacobian_plain(elems: InvElements, gin0):
    """(B, 9, 9) Jacobian of the inverse model's NHI Cauchy stress in g
    at ``gin0`` (see ``csrc/jac_asm.cu``)."""
    B = elems.B
    mu, kap = elems.mu, elems.kappa
    Y, F, b, R, J = _inv_factors(elems, gin0)
    A = J ** (-5.0 / 3.0)
    Ic = b.diagonal(dim1=1, dim2=2).sum(-1)
    S = torch.bmm(F.transpose(1, 2), R)  # (F^T R)[m, n]
    YT = Y.transpose(1, 2)
    eye = torch.eye(3, dtype=_f64, device=gin0.device)
    diag = ((-mu / 3.0) * A[:, None, None]
            * ((5.0 / 3.0) * Ic[:, None, None] * YT - 2.0 * S)
            - (kap * J)[:, None, None] * YT)  # (B, m, n)
    J4 = ((mu * A)[:, None, None, None, None] * _inv_db(Y, F, b, R,
                                                        5.0 / 3.0)
          + diag[:, None, None, :, :] * eye[None, :, :, None, None])
    return J4.reshape(B, 9, 9)


def arap_jacobian_plain(elems: Elements, u, s, w):
    """(B, 9, 9) Jacobian of the ARAP stress P(g) from the SVD-W of F:
    its dP/dF chained through F (:func:`chain_plain`)."""
    return chain_plain(elems, arap_dpdf_plain(elems, u, s, w))


def assemble_csr_elem(asm: DeviceAssembler, J):
    """``(data, grad_t, E)`` from the per-element Jacobian ``J`` (B, odim,
    idim): E = Lout J Lin, the CSR values and grad_t, scatter-added in
    plain torch (``sanm_tpu/solver/remap.py:356`` ``assemble_csr_elem``).
    The plain versions of the Jacobian kernels end here, and so does the
    function entry point's Jacobian (``solver/anm.py``)."""
    E = torch.einsum("bdp,bpq,bqe->bde", asm.Lout, J, asm.Lin).contiguous()
    acc = torch.zeros(asm.nnz + 1, dtype=_f64, device=J.device)
    acc.index_add_(0, asm.slot_pos.long(), E.reshape(-1))
    gt = grad_t_plain(asm, E) if asm.has_t else None
    return acc[: asm.nnz].contiguous(), gt, E


def jac_asm_plain(asm: DeviceAssembler, elems: Elements, gin0):
    """Plain torch version of K3 (NHC)."""
    return assemble_csr_elem(asm, nhc_jacobian_plain(elems, gin0))


def jac_asm_nhi_plain(asm: DeviceAssembler, elems: Elements, gin0):
    """Plain torch version of K3n (:func:`jac_asm_nhi`)."""
    return assemble_csr_elem(asm, nhi_jacobian_plain(elems, gin0))


def jac_asm_stvk_plain(asm: DeviceAssembler, elems: Elements, gin0):
    """Plain torch version of K3s (:func:`jac_asm_stvk`)."""
    return assemble_csr_elem(asm, stvk_jacobian_plain(elems, gin0))


def jac_asm_inv_plain(asm: DeviceAssembler, elems: InvElements, gin0):
    """Plain torch version of K3i (:func:`jac_asm_inv`)."""
    return assemble_csr_elem(asm, inv_nhc_jacobian_plain(elems, gin0))


def jac_asm_inv_nhi_plain(asm: DeviceAssembler, elems: InvElements, gin0):
    """Plain torch version of K3i NHI (:func:`jac_asm_inv_nhi`)."""
    return assemble_csr_elem(asm, inv_nhi_jacobian_plain(elems, gin0))


def jac_asm_arap_plain(asm: DeviceAssembler, elems: Elements, u, s, w):
    """Plain torch version of K8c (:func:`jac_asm_arap`)."""
    return assemble_csr_elem(asm, arap_jacobian_plain(elems, u, s, w))


# ---------------------------------------------------------------------------
# K10: the eigen-projected element Hessian of the baselines
# ---------------------------------------------------------------------------


def _hess_proj_launch(asm, counter, fn_name, ptrs, consts, dev):
    """Launch a K10 entry point on the material's pointers ``ptrs`` and
    constants ``consts``; returns ``(data, E)``."""
    E = torch.empty((asm.B, asm.Dout, asm.Din), dtype=_f64, device=dev)
    data = torch.empty((asm.nnz,), dtype=_f64, device=dev)
    kernels.launch(counter, fn_name, *ptrs, asm.Lout.data_ptr(),
                   asm.Lin.data_ptr(), asm.nz_ptr.data_ptr(),
                   asm.nz_slot.data_ptr(), E.data_ptr(), data.data_ptr(),
                   asm.B, asm.Dout, asm.Din, asm.nnz, *consts)
    return data, E


def _hess_proj_nh(asm, elems, gin0, counter, fn_name, c2, plain):
    _check_jac(asm, elems, gin0)
    if not kernels.on_card(gin0, elems.dminv, elems.bias, asm.Lin,
                           asm.nz_ptr):
        return plain(asm, elems, gin0)
    return _hess_proj_launch(
        asm, counter, fn_name, (gin0.data_ptr(), elems.bias.data_ptr(),
                                elems.dminv.data_ptr()),
        (float(elems.mu), float(c2)), gin0.device)


def hess_proj(asm: DeviceAssembler, elems: Elements, gin0):
    """K10: per element the eigen-projected dP/dF of the NHC stress at
    graph input ``gin0`` (B, 9), D+ = V max(L, 0) V^T of its symmetric
    part, chained to g; then E (B, Dout, Din) and the CSR values (nnz,)
    as :func:`jac_asm`, in the ANM Jacobian's sign: minus the projected
    Hessian of the energy.  Returns ``(data, E)``; launches the kernel
    for card tensors, runs :func:`hess_proj_plain` for CPU tensors."""
    return _hess_proj_nh(asm, elems, gin0, "hess_proj", "sanm_hess_proj",
                         elems.lam, hess_proj_plain)


def hess_proj_nhi(asm: DeviceAssembler, elems: Elements, gin0):
    """K10 for the NHI stress (:func:`hess_proj`)."""
    return _hess_proj_nh(asm, elems, gin0, "hess_proj_nhi",
                         "sanm_hess_proj_nhi", elems.kappa,
                         hess_proj_nhi_plain)


def hess_proj_arap(asm: DeviceAssembler, elems: Elements, u, s, w):
    """K10 for the ARAP stress (:func:`hess_proj`), from K8a's SVD-W
    ``(u, s, w)`` of F at the point."""
    _check_3x3(asm)
    B = asm.B
    kernels.check(u, "u", (B, 3, 3), _f64)
    kernels.check(s, "s", (B, 3), _f64)
    kernels.check(w, "w", (B, 3, 3), _f64)
    kernels.check(elems.dminv, "dminv", (B, 9), _f64)
    if not kernels.on_card(u, s, w, elems.dminv, asm.Lin, asm.nz_ptr):
        return hess_proj_arap_plain(asm, elems, u, s, w)
    return _hess_proj_launch(
        asm, "hess_proj_arap", "sanm_hess_proj_arap",
        (u.data_ptr(), s.data_ptr(), w.data_ptr(), elems.dminv.data_ptr()),
        (float(elems.mu),), u.device)


#: blocks per ``torch.linalg.eigh`` call: on the card cuSOLVER's batched
#: syev refuses batches of 32,768 and more
EIGH_CHUNK = 16384


def eigh_blocks(A):
    """``torch.linalg.eigh`` of the symmetric blocks ``A`` (B, m, m), in
    chunks of :data:`EIGH_CHUNK`."""
    parts = [torch.linalg.eigh(A[i:i + EIGH_CHUNK])
             for i in range(0, A.shape[0], EIGH_CHUNK)]
    return (torch.cat([w for w, _ in parts]),
            torch.cat([v for _, v in parts]))


def project_plain(elems: Elements, D):
    """K10's projection of the F-space blocks ``D`` (B, 9, 9): D+ =
    V max(L, 0) V^T of sym(D) by ``torch.linalg.eigh``
    (:func:`eigh_blocks`), chained to g (:func:`chain_plain`).  A
    non-finite block (J <= 0) gives NaN, as in the kernel (``eigh`` would
    fail on it)."""
    ok = torch.isfinite(D).all(dim=2).all(dim=1)[:, None, None]
    w, v = eigh_blocks(torch.where(ok, 0.5 * (D + D.transpose(1, 2)), 0.0))
    Dp = torch.where(ok, (v * w.clamp(min=0.0)[:, None, :])
                     @ v.transpose(1, 2), float("nan"))
    return chain_plain(elems, Dp)


def hess_proj_plain(asm: DeviceAssembler, elems: Elements, gin0):
    """Plain torch version of K10 (:func:`hess_proj`, NHC)."""
    data, _, E = assemble_csr_elem(
        asm, project_plain(elems, nhc_dpdf_plain(elems, gin0)))
    return data, E


def hess_proj_nhi_plain(asm: DeviceAssembler, elems: Elements, gin0):
    """Plain torch version of K10 for NHI (:func:`hess_proj_nhi`)."""
    data, _, E = assemble_csr_elem(
        asm, project_plain(elems, nhi_dpdf_plain(elems, gin0)))
    return data, E


def hess_proj_arap_plain(asm: DeviceAssembler, elems: Elements, u, s, w):
    """Plain torch version of K10 for ARAP (:func:`hess_proj_arap`)."""
    data, _, E = assemble_csr_elem(
        asm, project_plain(elems, arap_dpdf_plain(elems, u, s, w)))
    return data, E


# ---------------------------------------------------------------------------
# K5a: the scaled, sign-flipped scatter of the Cholesky solvers
# ---------------------------------------------------------------------------


def arrays_on(cache, device, arrays):
    """A host plan's index arrays on ``device``, built once per device and
    kept in ``cache``: ``arrays()`` gives ``{name: (numpy array, torch
    dtype)}``."""
    key = str(torch.device(device))
    if key not in cache:
        cache[key] = {
            name: torch.as_tensor(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype).contiguous()
            for name, (a, dtype) in arrays().items()}
    return cache[key]


_PLANS = {}  # per plan class: (pattern key, plan) of the last pattern


def plan_for(cls, csr_rowidx, csr_cols, n: int):
    """The plan (``cls``: the band, the dense or the SPIKE plan) of a
    sparsity pattern, kept for the last pattern asked for: the solvers of
    one mesh and boundary (the deform task's continuation and refinement,
    a warm task re-run) share it."""
    rows = np.ascontiguousarray(csr_rowidx, np.int32)
    cols = np.ascontiguousarray(csr_cols, np.int32)
    key = (int(n), hashlib.sha1(rows.tobytes()).digest(),
           hashlib.sha1(cols.tobytes()).digest())
    hit = _PLANS.get(cls)
    if hit is None or hit[0] != key:
        _PLANS.pop(cls, None)
        _PLANS[cls] = (key, cls(rows, cols, n))
    return _PLANS[cls][1]


def scaled_scatter(data, diag_of_row, sel, rows, cols, idx, pad_idx,
                   length):
    """K5a on any target: ``out[idx[e]] = -(data[sel[e]] s[rows[e]]
    s[cols[e]])`` into a new zeroed f64 buffer of ``length``, 1 at
    ``pad_idx``, with the Jacobi scale ``s = |diag A|^-1/2`` (1 where a row
    has no or a zero diagonal; ``diag_of_row`` is each row's diagonal
    position in ``data``, -1 for none).  Returns ``(out, s)``.  The band,
    the dense matrix (K6) and the SPIKE partitions (K7) are its targets."""
    if not kernels.on_card(data, diag_of_row, sel, rows, cols, idx,
                           pad_idx):
        return scaled_scatter_plain(data, diag_of_row, sel, rows, cols, idx,
                                    pad_idx, length)
    for t, name in ((diag_of_row, "diag_of_row"), (sel, "sel"),
                    (rows, "rows"), (cols, "cols")):
        kernels.check(t, name, t.shape, _i32)
    for t, name in ((idx, "idx"), (pad_idx, "pad_idx")):
        kernels.check(t, name, t.shape, _i64)
    n = diag_of_row.numel()
    out = torch.empty((length,), dtype=_f64, device=data.device)
    scale = torch.empty((n,), dtype=_f64, device=data.device)
    kernels.launch("band_assemble", "sanm_band_assemble", data.data_ptr(),
                   diag_of_row.data_ptr(), sel.data_ptr(), rows.data_ptr(),
                   cols.data_ptr(), idx.data_ptr(), pad_idx.data_ptr(),
                   scale.data_ptr(), out.data_ptr(), n, sel.numel(),
                   pad_idx.numel(), length)
    return out, scale


def scaled_scatter_plain(data, diag_of_row, sel, rows, cols, idx, pad_idx,
                         length):
    pos = diag_of_row.long()
    d = torch.where(pos >= 0, data[pos.clamp(min=0)].abs(),
                    torch.zeros((), dtype=_f64, device=data.device))
    scale = torch.rsqrt(torch.where(d > 0, d, torch.ones_like(d)))
    vals = -(data[sel.long()] * scale[rows.long()] * scale[cols.long()])
    out = torch.zeros(length, dtype=_f64, device=data.device)
    out[idx] = vals
    out[pad_idx] = 1.0
    return out, scale


class DensePlan:
    """The dense matrix of the ``dense_chol`` solver (K6): ``-(D A D)``
    scattered straight into one (npad, npad) f64 buffer with a unit
    diagonal in the pad (``sanm_tpu/solver/remap.py:380-421``
    ``assemble_dense_scaled_neg``).  npad is n rounded up to the block
    size ``s`` (default :data:`~sanm_tpu_torch.kernels.BLOCK`, the
    only one the K6 kernels take), not to the JAX package's 2048
    (``chol_pad_n``).  Every CSR entry is scattered, both triangles, as
    the JAX package scatters them; the factor reads the lower one."""

    def __init__(self, csr_rowidx, csr_cols, n: int, s: int = None):
        self.n = n = int(n)
        self.s = s = kernels.BLOCK if s is None else int(s)
        self.nb = -(-n // s)
        self.npad = npad = self.nb * s
        r = np.asarray(csr_rowidx, np.int64)
        c = np.asarray(csr_cols, np.int64)
        self.nnz = int(r.size)
        self.rows = r.astype(np.int32)
        self.cols = c.astype(np.int32)
        self.idx = r * npad + c
        d = np.arange(n, npad, dtype=np.int64)
        self.pad_idx = d * (npad + 1)
        pos, prow = diag_nnz_pos(csr_rowidx, csr_cols)
        self.diag_of_row = np.full(n, -1, np.int32)
        self.diag_of_row[prow] = pos
        self._dev = {}

    def mem_bytes(self) -> int:
        """The factor's bytes: the (npad, npad) f64 matrix, overwritten by
        L, and the inverses of its nb diagonal blocks."""
        return 8 * (self.npad * self.npad + self.nb * self.s * self.s)

    def factor_flops(self) -> float:
        """f64 operations of the blocked Cholesky: npad^3 / 3 (the
        trailing updates, the panels and the diagonal blocks) plus the
        inverses of the diagonal blocks (s^3 / 3 each)."""
        return self.npad ** 3 / 3.0 + self.nb * self.s ** 3 / 3.0

    def on(self, device):
        """The scatter maps on ``device`` (cached)."""
        return arrays_on(self._dev, device, lambda: dict(
            diag_of_row=(self.diag_of_row, _i32),
            sel=(np.arange(self.nnz), _i32), rows=(self.rows, _i32),
            cols=(self.cols, _i32), idx=(self.idx, _i64),
            pad_idx=(self.pad_idx, _i64)))


def _dense_scatter_args(plan: DensePlan, data):
    a = plan.on(data.device)
    return (data, a["diag_of_row"], a["sel"], a["rows"], a["cols"],
            a["idx"], a["pad_idx"], plan.npad * plan.npad)


def dense_assemble(plan: DensePlan, data):
    """``-(D A D)`` from the CSR values ``data`` into a new (npad, npad)
    matrix, unit diagonal in the pad, through K5a; returns ``(M, scale)``
    with the Jacobi scale (n,)."""
    kernels.check(data, "data", (plan.nnz,), _f64)
    flat, scale = scaled_scatter(*_dense_scatter_args(plan, data))
    return flat.view(plan.npad, plan.npad), scale


def dense_assemble_plain(plan: DensePlan, data):
    flat, scale = scaled_scatter_plain(*_dense_scatter_args(plan, data))
    return flat.view(plan.npad, plan.npad), scale


# ---------------------------------------------------------------------------
# K4 COO: csr_matvec, csr_matvec_t, diag_blocks
# ---------------------------------------------------------------------------


class CSRMaps:
    """The CSR values' maps on one device: the row pointer ``row_ptr``
    (n_rows+1,) and ``cols`` (nnz,) of A x; at first use the gather form
    of A^T y (``t_ptr`` (n+1,), ``t_src`` (nnz,): per column its value
    positions in ascending order, ``t_rows`` = their rows), the COO rows
    ``rowidx`` of the plain versions and the diagonal-block map ``dmap``
    (n/3, 3, 3) with dump value nnz.  The rows must be sorted (the CSR of
    the assembler plan is)."""

    def __init__(self, csr_rowidx, csr_cols, n_rows, n, device):
        self.n_rows, self.n = int(n_rows), int(n)
        self.device = torch.device(device)
        self._rowidx = np.ascontiguousarray(csr_rowidx, np.int32)
        self._cols = np.ascontiguousarray(csr_cols, np.int32)
        self.nnz = len(self._rowidx)
        self.row_ptr = self._dev(csr_row_ptr(self._rowidx, self.n_rows))
        self.cols = self._dev(self._cols)

    def _dev(self, a):
        return torch.as_tensor(a).to(device=self.device,
                                     dtype=_i32).contiguous()

    def to(self, device):
        """The same maps on ``device``."""
        return CSRMaps(self._rowidx, self._cols, self.n_rows, self.n, device)

    @functools.cached_property
    def rowidx(self):
        return self._dev(self._rowidx)

    @functools.cached_property
    def transposed(self):
        """``(t_ptr, t_src, t_rows)``: the gather form of A^T y."""
        ptr, src = gather_map(self._cols, self.n)
        return self._dev(ptr), self._dev(src), self._dev(self._rowidx[src])

    @functools.cached_property
    def dmap(self):
        return self._dev(diag_block_map(self._rowidx, self._cols, self.n,
                                        self.nnz, 3))


def _csr_launch(counter, ptr, pos, idx, data, v, out):
    kernels.launch(counter, "sanm_csr_matvec", ptr.data_ptr(),
                   None if pos is None else pos.data_ptr(), idx.data_ptr(),
                   data.data_ptr(), v.data_ptr(), out.data_ptr(),
                   out.numel())
    return out


def csr_matvec(csr: CSRMaps, data, x):
    """A x (n_rows,) from the CSR values ``data`` (nnz,) for ``x`` (n,):
    one warp per row over its contiguous values."""
    kernels.check(data, "data", (csr.nnz,), _f64)
    kernels.check(x, "x", (csr.n,), _f64)
    if not kernels.on_card(data, x, csr.row_ptr, csr.cols):
        return csr_matvec_plain(csr, data, x)
    out = torch.empty((csr.n_rows,), dtype=_f64, device=x.device)
    return _csr_launch("csr_matvec", csr.row_ptr, None, csr.cols, data, x,
                       out)


def csr_matvec_plain(csr: CSRMaps, data, x):
    """``matvec``'s scatter-add (``remap.py:439-444``)."""
    acc = torch.zeros(csr.n_rows, dtype=_f64, device=x.device)
    return acc.index_add_(0, csr.rowidx.long(), data * x[csr.cols.long()])


def csr_matvec_t(csr: CSRMaps, data, y):
    """A^T y (n,) for ``y`` (n_rows,): one warp per column over its value
    positions in ascending order (the gather form of ``matvec_t``)."""
    kernels.check(data, "data", (csr.nnz,), _f64)
    kernels.check(y, "y", (csr.n_rows,), _f64)
    t_ptr, t_src, t_rows = csr.transposed
    if not kernels.on_card(data, y, t_ptr, t_src, t_rows):
        return csr_matvec_t_plain(csr, data, y)
    out = torch.empty((csr.n,), dtype=_f64, device=y.device)
    return _csr_launch("csr_matvec_t", t_ptr, t_src, t_rows, data, y, out)


def csr_matvec_t_plain(csr: CSRMaps, data, y):
    """``matvec_t``'s scatter-add (``remap.py:446-451``)."""
    acc = torch.zeros(csr.n, dtype=_f64, device=y.device)
    return acc.index_add_(0, csr.cols.long(), data * y[csr.rowidx.long()])


def diag_blocks(csr: CSRMaps, data):
    """The (n/3, 3, 3) diagonal blocks of A from its CSR values (zero
    where A has no value)."""
    kernels.check(data, "data", (csr.nnz,), _f64)
    dmap = csr.dmap
    if not kernels.on_card(data, dmap):
        return diag_blocks_plain(csr, data)
    out = torch.empty(dmap.shape, dtype=_f64, device=data.device)
    kernels.launch("diag_blocks", "sanm_diag_blocks", dmap.data_ptr(),
                   data.data_ptr(), out.data_ptr(), dmap.numel(), csr.nnz)
    return out


def diag_blocks_plain(csr: CSRMaps, data):
    """``diag_blocks`` (``remap.py:423-437``): the values padded with one
    zero, gathered by the map."""
    padded = torch.cat([data, data.new_zeros(1)])
    return padded[csr.dmap.long()]
