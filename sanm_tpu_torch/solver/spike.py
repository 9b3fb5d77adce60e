"""K7: the SPIKE partitioned band solve (the ``spike_band`` solver).

Port of ``sanm_tpu/solver/spike.py``.  The RCM-ordered matrix is split
into P diagonal partitions of m rows,

    A = blkdiag(A_0 .. A_{P-1}) + couplings C_p (b x b, b = w s),

where C_p couples the top b rows of partition p+1 with the bottom b rows
of partition p.  Once per restart: each A_p's skyline band factor (K5b,
``solver/band.py``, at the partition's own reach, so the local factors are
no fatter than band_chol's), the spikes ``V_p = A_p^-1 [0; C_p^T]`` and
``W_p = A_p^-1 [C_{p-1}; 0]`` (K7b :func:`spike_rhs_solve`), and the
reduced block-Thomas precompute

    K_p = I - Wt_p Mhb_{p-1},  G_p = Wb_p Mhb_{p-1},
    Mht_p = K_p^-1 Vt_p,       Mhb_p = Vb_p + G_p Mht_p

(Wt, Wb: the top and bottom b rows of W; the same for V), which calls the
library (``torch.matmul``, ``torch.linalg.lu_factor_ex``, ``lu_solve``
and, for the inverses of the diagonal blocks of each K_p's triangular
factors, ``solve_triangular``), as the JAX package calls it there
(``jsl.lu_factor`` / ``lu_solve``, ``spike.py:340-341``).  Per solve
(K7c :func:`spike_solve`): the permuted local substitution batched over
the partitions, the P-step reduced forward and backward recursion with
K_p's triangular solves, and the rank-b recombination
``x_p = g_p - V_p t_{p+1} - W_p u_{p-1}``, all hand-written
(``csrc/spike.cu``).

The symbolic phase (:class:`SpikePlan`) stays on the host.  Its scatter
maps, P, m, b, rows_loc and W equal the JAX package's plan at the same
block size and partition count; the local storage keeps the JAX layout
(the working band of ``band.py`` per partition, rows_loc = (m/s + w) s
rows), and the local substitutions run over the m rows, since no
partition's reach passes its last block.  Precision: f64 throughout (the
JAX package's f32 factors are not ported), refined against the exact
operator.  An indefinite state gives NaN in a local factor, which
propagates into the spikes and the reduced factors; :meth:`SpikeFactor.ok`
detects it and the ANM driver falls back to host LU.

Each wrapper launches its kernel for tensors on the card, runs its
``*_plain`` torch version for tensors on the CPU, and raises for anything
else.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..utils import SANMError, sanm_assert
from .assemble import arrays_on, scaled_scatter
from .band import BandPlan, band_factor, band_factor_ok
from .linear import REFINE_STEPS, RefinedCholSolver
from .remap import diag_nnz_pos

_f64 = torch.float64
_i32 = torch.int32
_i64 = torch.int64


def default_nparts(n: int, b: int) -> int:
    """Partition count: the largest power of two <= min(8, n // b) (the
    m >= b validity bound), at least 1 (``spike.py:73-84``; the JAX
    package's ``SANM_SPIKE_P`` override is the ``nparts`` argument
    here)."""
    cap = max(1, n // max(b, 1))
    p = 1
    while p * 2 <= min(8, cap):
        p *= 2
    return p


class LocalBand:
    """One partition's skyline band: what K5b's wrappers read of a
    :class:`~sanm_tpu_torch.solver.band.BandPlan` (s, w, nb, the working
    band's rows and width, the reach ``blk_w`` and the panel offsets)."""

    panel = BandPlan.panel

    def __init__(self, s, w, nb, blk_w):
        self.s, self.w, self.nb = s, w, nb
        self.nrow_tot = (nb + w) * s
        self.W = (w + 1) * s
        self.blk_w = np.ascontiguousarray(blk_w, np.int64)
        self.panel_off = np.zeros(nb + 1, np.int64)
        np.cumsum((self.blk_w + 1) * s * s, out=self.panel_off[1:])


class SpikePlan:
    """Host-side symbolic analysis, built once per topology
    (``spike.py:87-201``): RCM ordering, the partition layout, the
    scatter maps into the per-partition band storage and the coupling
    blocks, and each partition's skyline reach.

    ``s`` is the block size (default :data:`~sanm_tpu_torch.kernels.BLOCK`,
    the only one the kernels take), ``nparts`` the partition count
    (default :func:`default_nparts`)."""

    def __init__(self, csr_rowidx, csr_cols, n: int, s: int = None,
                 nparts: int = None):
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        s = kernels.BLOCK if s is None else int(s)
        sanm_assert(s > 0, "block size %d", s)
        r = np.asarray(csr_rowidx, np.int64)
        c = np.asarray(csr_cols, np.int64)
        self.n = n = int(n)
        self.nnz = int(r.size)
        pat = sp.csr_matrix(
            (np.ones(r.size, np.float32), (r, c)), shape=(n, n))
        perm = np.asarray(
            reverse_cuthill_mckee(pat, symmetric_mode=True), np.int64)
        invp = np.empty(n, np.int64)
        invp[perm] = np.arange(n)
        rp, cp = invp[r], invp[c]
        bw = int(np.abs(rp - cp).max()) if r.size else 1
        w = max(1, -(-bw // s))
        self.s, self.w, self.bw = s, w, bw
        self.b = b = w * s
        P = int(nparts) if nparts is not None else default_nparts(n, b)
        m = max(b, -(-n // (P * s)) * s)
        self.P, self.m = P, m
        sanm_assert(m >= b, "spike: partition smaller than bandwidth")
        self.mb = mb = m // s
        self.rows_loc = (mb + w) * s
        self.W = (w + 1) * s
        ntot = P * m

        # lower-triangle entries: in-partition ones -> the partition's band
        # storage (band.py's working-band layout), the rest -> the corner
        # blocks C_{p-1} (row in partition p's top b, column in p-1's
        # bottom b)
        low = np.nonzero(rp >= cp)[0]
        lr_, lc_ = rp[low], cp[low]
        part = lr_ // m
        local = lc_ >= part * m
        il = np.nonzero(local)[0]
        p_i = part[il]
        r_i, c_i = lr_[il] - p_i * m, lc_[il] - p_i * m
        off = c_i - (r_i // s) * s + w * s
        sanm_assert(int(off.min(initial=0)) >= 0
                    and int(off.max(initial=0)) < self.W,
                    "spike: local band offset out of range")
        self.loc_sel = low[il].astype(np.int32)
        self.loc_idx = (p_i * self.rows_loc + r_i) * self.W + off
        ic = np.nonzero(~local)[0]
        p_c, rr, cc = part[ic], lr_[ic], lc_[ic]
        sanm_assert(bool(np.all(cc >= (p_c - 1) * m)),
                    "spike: coupling spans non-adjacent partitions")
        rloc = rr - p_c * m
        cloc = cc - (p_c * m - b)
        sanm_assert(int(rloc.max(initial=0)) < b
                    and int(cloc.min(initial=0)) >= 0,
                    "spike: coupling outside corner block")
        self.coup_sel = low[ic].astype(np.int32)
        self.coup_idx = ((p_c - 1) * b + rloc) * b + cloc

        # unit-diagonal pad: global rows >= n plus each partition's rows
        # [m, rows_loc)
        pads = []
        for p in range(P):
            lr = np.arange(max(0, n - p * m), self.rows_loc, dtype=np.int64)
            lr = lr[(lr >= m) | (p * m + lr >= n)]
            pads.append((p * self.rows_loc + lr) * self.W + (lr % s + w * s))
        self.pad_idx = np.concatenate(pads)
        self.perm_ext = np.concatenate(
            [perm, np.arange(n, ntot, dtype=np.int64)])
        self.invp_ext = np.concatenate(
            [invp, np.arange(n, ntot, dtype=np.int64)])

        # each partition's skyline reach from its own sub-pattern (as
        # BandPlan's): block row i of partition p touches its block column
        # j iff the first local column of one of its rows is in block <= j
        first = np.full(ntot, np.iinfo(np.int64).max)
        np.minimum.at(first, lr_[il], lc_[il])
        self.local = []
        for p in range(P):
            f = first[p * m:(p + 1) * m]
            has = f < np.iinfo(np.int64).max
            fblk = np.full(mb, mb, np.int64)
            rows = np.nonzero(has)[0]
            np.minimum.at(fblk, rows // s, (f[rows] - p * m) // s)
            w_need = np.zeros(mb, np.int64)
            for i in range(mb):
                lo = int(fblk[i])
                if lo < i:
                    j = np.arange(lo, i)
                    np.maximum.at(w_need, j, i - j)
            sanm_assert(int(w_need.max(initial=0)) <= w,
                        "spike: skyline reach exceeds the band width")
            self.local.append(LocalBand(s, w, mb, w_need))
        self.blk_w = np.stack([lb.blk_w for lb in self.local])
        self.wmax = np.ascontiguousarray(self.blk_w.max(axis=0))
        sizes = [int(lb.panel_off[-1]) for lb in self.local]
        self.panel_base = np.concatenate([[0], np.cumsum(sizes)])
        self.panel_off = np.stack(
            [self.panel_base[p] + lb.panel_off[:mb]
             for p, lb in enumerate(self.local)])

        # what K5a reads besides the values
        self.loc_rows = np.asarray(csr_rowidx, np.int32)[self.loc_sel]
        self.loc_cols = np.asarray(csr_cols, np.int32)[self.loc_sel]
        self.coup_rows = np.asarray(csr_rowidx, np.int32)[self.coup_sel]
        self.coup_cols = np.asarray(csr_cols, np.int32)[self.coup_sel]
        pos, prow = diag_nnz_pos(csr_rowidx, csr_cols)
        self.diag_of_row = np.full(n, -1, np.int32)
        self.diag_of_row[prow] = pos
        self._dev = {}

    def sizes_bytes(self):
        """f64 bytes of the factor's parts: the local panels, the spikes V
        and W, and the reduced blocks (LU, G, Mht, Mhb and the inverses of
        the diagonal blocks of each K_p's triangular factors); and of the
        transient working storage (the local bands and the coupling
        blocks)."""
        P, m, b, s = self.P, self.m, self.b, self.s
        return dict(panels=8 * int(self.panel_base[-1]),
                    spikes=8 * 2 * P * m * b,
                    reduced=8 * (4 * P * b * b + 2 * P * b * s),
                    work=8 * (P * self.rows_loc * self.W
                              + max(P - 1, 0) * b * b))

    def mem_bytes(self) -> int:
        """Persistent factor bytes (f64)."""
        z = self.sizes_bytes()
        return z["panels"] + z["spikes"] + z["reduced"]

    def on(self, device):
        """The plan's index arrays on ``device`` (cached)."""
        return arrays_on(self._dev, device, lambda: dict(
            diag_of_row=(self.diag_of_row, _i32),
            loc_sel=(self.loc_sel, _i32), loc_rows=(self.loc_rows, _i32),
            loc_cols=(self.loc_cols, _i32), loc_idx=(self.loc_idx, _i64),
            pad_idx=(self.pad_idx, _i64), coup_sel=(self.coup_sel, _i32),
            coup_rows=(self.coup_rows, _i32),
            coup_cols=(self.coup_cols, _i32),
            coup_idx=(self.coup_idx, _i64), no_pad=(np.zeros(0), _i64),
            perm_ext=(self.perm_ext, _i32), invp_ext=(self.invp_ext, _i32),
            panel_off=(self.panel_off, _i64), blk_w=(self.blk_w, _i64)))

    def panels_of(self, panels, p):
        """Partition p's panels within the flat buffer of all of them."""
        return panels[int(self.panel_base[p]):int(self.panel_base[p + 1])]


def spike_assemble(plan: SpikePlan, data):
    """``-(D A D)`` scattered into the per-partition band storage and the
    coupling corner blocks through K5a (``assemble_spike_scaled_neg``,
    ``spike.py:204-234``); returns ``(Bloc (P, rows_loc, W),
    C (P-1, b, b), scale)``."""
    kernels.check(data, "data", (plan.nnz,), _f64)
    a = plan.on(data.device)
    flat, scale = scaled_scatter(
        data, a["diag_of_row"], a["loc_sel"], a["loc_rows"], a["loc_cols"],
        a["loc_idx"], a["pad_idx"], plan.P * plan.rows_loc * plan.W)
    nc, b = max(plan.P - 1, 0), plan.b
    if nc:
        cf, _ = scaled_scatter(
            data, a["diag_of_row"], a["coup_sel"], a["coup_rows"],
            a["coup_cols"], a["coup_idx"], a["no_pad"], nc * b * b)
    else:
        cf = torch.zeros(0, dtype=_f64, device=data.device)
    return (flat.view(plan.P, plan.rows_loc, plan.W), cf.view(nc, b, b),
            scale)


def spike_local_factor(plan: SpikePlan, Bloc):
    """The P local skyline factors (K5b per partition, each at its own
    reach; ``Bloc`` is overwritten), as one flat panel buffer."""
    return torch.cat([band_factor(lb, Bloc[p])
                      for p, lb in enumerate(plan.local)])


# ---------------------------------------------------------------------------
# K7b spike_rhs_solve
# ---------------------------------------------------------------------------


def spike_rhs_solve(plan: SpikePlan, panels, R):
    """``X_p = (L_p L_p^T)^-1 R_p`` for the P partitions' right-hand sides
    ``R`` (P, m, k) (``uband_tri_solve``, ``spike.py:237-292``, on all k
    columns at once); ``R`` is overwritten.  k is a multiple of 64 on the
    card."""
    P, m = plan.P, plan.m
    kernels.check(R, "R", (P, m, R.shape[2]), _f64)
    kernels.check(panels, "panels", (int(plan.panel_base[-1]),), _f64)
    if not kernels.on_card(R, panels):
        return spike_rhs_solve_plain(plan, panels, R)
    kernels.check_block(plan.s)
    k = R.shape[2]
    if k % 64:
        raise SANMError("spike_rhs_solve: %d columns, not a "
                                "multiple of 64" % k)
    a = plan.on(R.device)
    X = torch.empty_like(R)
    Z = torch.empty((P, plan.s, k), dtype=_f64, device=R.device)
    kernels.launch("spike_rhs_solve", "sanm_spike_rhs_solve",
                   panels.data_ptr(), a["panel_off"].data_ptr(),
                   a["blk_w"].data_ptr(), plan.wmax.ctypes.data,
                   R.data_ptr(), X.data_ptr(), Z.data_ptr(), P, plan.mb, k)
    return X


def local_tri_solve_plain(plan: SpikePlan, panels, p, r):
    """``(L_p L_p^T)^-1 r`` for partition p's (m,) or (m, k) ``r``: the
    band substitutions (``band_tri_solve_plain``) at the partition's
    reach."""
    lb, s = plan.local[p], plan.s
    pp = plan.panels_of(panels, p)
    r = r.clone()
    for j in range(lb.nb):
        wj = int(lb.blk_w[j])
        c0, c1 = j * s, (j + 1) * s
        Pj = lb.panel(pp, j)
        yj = Pj[0] @ r[c0:c1]
        if wj:
            r[c1:c1 + wj * s] -= Pj[1:].reshape(wj * s, s) @ yj
        r[c0:c1] = yj
    for j in reversed(range(lb.nb)):
        wj = int(lb.blk_w[j])
        c0, c1 = j * s, (j + 1) * s
        Pj = lb.panel(pp, j)
        yj = r[c0:c1]
        if wj:
            yj = yj - Pj[1:].reshape(wj * s, s).mT @ r[c1:c1 + wj * s]
        r[c0:c1] = Pj[0].mT @ yj
    return r


def spike_rhs_solve_plain(plan: SpikePlan, panels, R):
    return torch.stack([local_tri_solve_plain(plan, panels, p, R[p])
                        for p in range(plan.P)])


# ---------------------------------------------------------------------------
# the factor
# ---------------------------------------------------------------------------


class SpikeFactor:
    """What the solve reads (``spike.py:343-354``): the local panels, the
    spikes V and W (P, m, b), each K_p's LU factor (P, b, b) with its
    pivots (LAPACK's) and row permutation, the inverses of the diagonal
    blocks of its unit lower and upper factors (invUt transposed), G
    (P, b, b) and Mh (2, P, b, b) = Mht over Mhb."""

    def __init__(self, panels, V=None, W=None):
        self.panels, self.V, self.W = panels, V, W
        self.LU = self.piv = self.lu_perm = None
        self.invL = self.invUt = self.G = self.Mh = None

    def ok(self) -> bool:
        """All finite (``spike_factor_ok``, ``spike.py:357-363``): a NaN
        from an indefinite local block propagates through the spikes and
        the reduced factors."""
        parts = (self.panels, self.V, self.W, self.LU, self.G, self.Mh)
        return all(t is not None and bool(torch.isfinite(t).all())
                   for t in parts)


def spike_factor(plan: SpikePlan, panels, C):
    """The spikes (K7b) and the reduced block-Thomas precompute
    (``_spike_factor_impl``, ``spike.py:300-354``) from the local factor
    ``panels`` and the coupling blocks ``C``; stops after the local factor
    when it is not finite."""
    F = SpikeFactor(panels)
    if not band_factor_ok(panels):
        return F
    P, m, b, s = plan.P, plan.m, plan.b, plan.s
    dev = panels.device
    R = torch.zeros((P, m, b), dtype=_f64, device=dev)
    R[1:, :b] = C
    F.W = spike_rhs_solve(plan, panels, R)
    R.zero_()
    R[:-1, m - b:] = C.mT
    F.V = spike_rhs_solve(plan, panels, R)
    del R
    Wt, Wb = F.W[:, :b], F.W[:, m - b:]
    Vt, Vb = F.V[:, :b], F.V[:, m - b:]
    eye = torch.eye(b, dtype=_f64, device=dev)
    F.LU = torch.empty((P, b, b), dtype=_f64, device=dev)
    F.piv = torch.empty((P, b), dtype=_i32, device=dev)
    F.G = torch.empty((P, b, b), dtype=_f64, device=dev)
    F.Mh = torch.empty((2, P, b, b), dtype=_f64, device=dev)
    Mhb_prev = torch.zeros((b, b), dtype=_f64, device=dev)
    for p in range(P):
        F.G[p] = Wb[p] @ Mhb_prev
        lu, piv, _ = torch.linalg.lu_factor_ex(eye - Wt[p] @ Mhb_prev)
        F.LU[p], F.piv[p] = lu, piv
        F.Mh[0, p] = torch.linalg.lu_solve(lu, piv, Vt[p])
        F.Mh[1, p] = Vb[p] + F.G[p] @ F.Mh[0, p]
        Mhb_prev = F.Mh[1, p]
    del lu, Mhb_prev
    # the row permutation of LAPACK's sequential swaps (row i with row
    # piv[i] - 1)
    perm = np.tile(np.arange(b, dtype=np.int32), (P, 1))
    for p, pv in enumerate(F.piv.cpu().numpy() - 1):
        for i, q in enumerate(pv):
            perm[p, i], perm[p, q] = perm[p, q], perm[p, i]
    F.lu_perm = torch.as_tensor(perm).to(dev)
    nbb = b // s
    D = torch.stack([F.LU[:, i * s:(i + 1) * s, i * s:(i + 1) * s]
                     for i in range(nbb)], dim=1)
    eye_s = torch.eye(s, dtype=_f64, device=dev).expand_as(D)
    F.invL = torch.linalg.solve_triangular(
        torch.tril(D, -1) + eye_s, eye_s, upper=False,
        unitriangular=True).contiguous()
    F.invUt = torch.linalg.solve_triangular(
        torch.triu(D), eye_s, upper=True).mT.contiguous()
    return F


# ---------------------------------------------------------------------------
# K7c spike_solve
# ---------------------------------------------------------------------------


def spike_solve(plan: SpikePlan, F: SpikeFactor, rhs):
    """``A^-1 rhs`` for ``rhs`` (n,) in the original ordering through the
    SPIKE factor (``_spike_tri_solve_impl``, ``spike.py:375-428``)."""
    kernels.check(rhs, "rhs", (plan.n,), _f64)
    P, m, b = plan.P, plan.m, plan.b
    for t, name, shape in (
            (F.panels, "panels", (int(plan.panel_base[-1]),)),
            (F.V, "V", (P, m, b)), (F.W, "W", (P, m, b)),
            (F.LU, "LU", (P, b, b)), (F.G, "G", (P, b, b)),
            (F.Mh, "Mh", (2, P, b, b))):
        kernels.check(t, name, shape, _f64)
    if not kernels.on_card(rhs, F.panels, F.V):
        return spike_solve_plain(plan, F, rhs)
    kernels.check_block(plan.s)
    nbb = b // plan.s
    kernels.check(F.lu_perm, "lu_perm", (P, b), _i32)
    for t, name in ((F.invL, "invL"), (F.invUt, "invUt")):
        kernels.check(t, name, (P, nbb, plan.s, plan.s), _f64)
    a = plan.on(rhs.device)
    dev = rhs.device
    ngmax = max(1, -(-int(plan.wmax.max(initial=0)) * plan.s // 64))
    work = torch.empty((P * m,), dtype=_f64, device=dev)
    partial = torch.empty((P, ngmax, plan.s), dtype=_f64, device=dev)
    red = torch.empty((3 + 4 * P, b), dtype=_f64, device=dev)
    out = torch.empty((plan.n,), dtype=_f64, device=dev)
    kernels.launch(
        "spike_solve", "sanm_spike_solve", F.panels.data_ptr(),
        a["panel_off"].data_ptr(), a["blk_w"].data_ptr(),
        plan.wmax.ctypes.data, F.V.data_ptr(), F.W.data_ptr(),
        F.LU.data_ptr(), F.lu_perm.data_ptr(), F.invL.data_ptr(),
        F.invUt.data_ptr(), F.G.data_ptr(), F.Mh.data_ptr(),
        a["perm_ext"].data_ptr(), a["invp_ext"].data_ptr(), rhs.data_ptr(),
        work.data_ptr(), partial.data_ptr(), red.data_ptr(), out.data_ptr(),
        plan.n, P, plan.mb, b)
    return out


def spike_solve_plain(plan: SpikePlan, F: SpikeFactor, rhs):
    P, m, b, n = plan.P, plan.m, plan.b, plan.n
    a = plan.on(rhs.device)
    rf = torch.zeros((P * m,), dtype=_f64, device=rhs.device)
    rf[:n] = rhs
    x = rf[a["perm_ext"].long()].view(P, m)
    g = torch.stack([local_tri_solve_plain(plan, F.panels, p, x[p])
                     for p in range(P)])
    Wt, Wb = F.W[:, :b], F.W[:, m - b:]
    yts, yus = [], []
    yu_prev = torch.zeros((b,), dtype=_f64, device=rhs.device)
    for p in range(P):
        ct = g[p, :b] - Wt[p] @ yu_prev
        cu = g[p, m - b:] - Wb[p] @ yu_prev
        yt = torch.linalg.lu_solve(F.LU[p], F.piv[p], ct[:, None])[:, 0]
        yu_prev = cu + F.G[p] @ yt
        yts.append(yt)
        yus.append(yu_prev)
    zt = [None] * (P + 1)
    zu = [None] * P
    zt[P] = torch.zeros((b,), dtype=_f64, device=rhs.device)
    for p in reversed(range(P)):
        zt[p] = yts[p] - F.Mh[0, p] @ zt[p + 1]
        zu[p] = yus[p] - F.Mh[1, p] @ zt[p + 1]
    t_next = torch.stack(zt[1:])
    u_prev = torch.stack([torch.zeros_like(zt[P])] + zu[:-1])
    x = (g - torch.einsum("pmb,pb->pm", F.V, t_next)
         - torch.einsum("pmb,pb->pm", F.W, u_prev))
    return x.reshape(-1)[a["invp_ext"].long()][:n]


class DeviceSpikeBandSolver(RefinedCholSolver):
    """The ``spike_band`` solver (``spike.py:431-483``): the local band
    storage and coupling blocks assembled through K5a, the local factors
    through K5b (the storage freed after), the spikes through K7b and the
    reduced precompute in the constructor; each solve runs K7c per
    refinement trip (:class:`~sanm_tpu_torch.solver.linear.
    RefinedCholSolver`)."""

    name = "spike_band"

    def __init__(self, plan: SpikePlan, data, matvec, l2_penalty=0.0,
                 refine_steps: int = REFINE_STEPS):
        super().__init__(matvec, l2_penalty, refine_steps)
        self.plan = plan
        Bloc, C, self.scale = spike_assemble(plan, data)
        panels = spike_local_factor(plan, Bloc)
        del Bloc
        self.F = spike_factor(plan, panels, C)

    def factor_ok(self) -> bool:
        return self.F.ok()

    def tri_solve(self, r):
        return spike_solve(self.plan, self.F, r)
