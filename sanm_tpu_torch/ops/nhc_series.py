"""K1: the per-order Taylor step of the compressible Neo-Hookean stress.

Takes the place of the JAX package's generic Taylor engine
(``sanm_tpu/taylor.py`` + ``sanm_tpu/taylor_scan.py``) for this one
graph, ``P = mu F - mu F^-T + lam log(det F) F^-T`` with
``F = (g + bias) Dm^-1``.  Per element the series state is kept in one
preallocated history ``hist`` (order+1, 23, B), float64: components F
0-8, row 0 of the cofactor C 9-11 (the only rows a later order reads:
J = F[0,:] . C[0,:]), Q = F^-T 12-20, J = det F 21, L = log J 22.

:func:`nhc_step` commits order k from the graph input ``g_k`` and returns
the order-(k+1) bias of P (P_{k+1} with g_{k+1} = 0).  The recurrences
(Cauchy products, the quotient and the log recurrence) are written out
in ``csrc/nhc_series.cu``; :func:`nhc_step_plain` computes the same with
torch ops, as the CPU path and the kernel's test oracle.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import kernels
from ..utils import SANMError

NCOMP = 23
_F, _C0, _Q, _J, _L = slice(0, 9), slice(9, 12), slice(12, 21), 21, 22
# a history row's component groups (F, C row 0, Q, J, L), for comparisons
GROUPS = (_F, _C0, _Q, slice(_J, _J + 1), slice(_L, _L + 1))
_SIGN = torch.tensor([1.0, -1.0, 1.0, -1.0, 1.0, -1.0, 1.0, -1.0, 1.0],
                     dtype=torch.float64)
# minor (i, j) = F[r0, c0] F[r1, c1] - F[r0, c1] F[r1, c0], flat indices
_R = [(1, 2), (0, 2), (0, 1)]
_M1A = [_R[i][0] * 3 + _R[j][0] for i in range(3) for j in range(3)]
_M1B = [_R[i][1] * 3 + _R[j][1] for i in range(3) for j in range(3)]
_M2A = [_R[i][0] * 3 + _R[j][1] for i in range(3) for j in range(3)]
_M2B = [_R[i][1] * 3 + _R[j][0] for i in range(3) for j in range(3)]


@dataclass
class NHCElements:
    """Per-element constants of the NHC graph on one device: Dm^-1 and
    the fixed-coordinate bias of Ds, both (B, 9) float64, and the Lame
    parameters."""

    dminv: torch.Tensor
    bias: torch.Tensor
    mu: float
    lam: float

    @property
    def B(self):
        return self.dminv.shape[0]

    @property
    def device(self):
        return self.dminv.device


def _check_step(hist, k, gin, elems, out):
    B = elems.B
    if hist.dim() != 3 or hist.shape[1:] != (NCOMP, B):
        raise SANMError("hist: shape %s, expected (order+1, %d, %d)"
                        % (tuple(hist.shape), NCOMP, B))
    kernels.check(hist, "hist", hist.shape, torch.float64)
    kernels.check(gin, "gin", (B, 9), torch.float64)
    kernels.check(elems.bias, "bias", (B, 9), torch.float64)
    kernels.check(elems.dminv, "dminv", (B, 9), torch.float64)
    order = hist.shape[0] - 1
    want_bias = out is not None
    if not 0 <= k <= order or (want_bias and k + 1 > order):
        raise SANMError("order k=%d out of range for histories of order %d"
                        % (k, order))
    if want_bias:
        kernels.check(out, "out", (B, 9), torch.float64)
    return order, want_bias


def nhc_step(hist, k: int, gin, elems: NHCElements, out=None):
    """Commit order k into ``hist`` from graph input ``gin`` (B, 9); when
    ``out`` (B, 9) is given, write the order-(k+1) bias of P into it.
    Launches the CUDA kernel for card tensors, runs
    :func:`nhc_step_plain` for CPU tensors, raises for anything else."""
    order, want_bias = _check_step(hist, k, gin, elems, out)
    tensors = [hist, gin, elems.bias, elems.dminv] + ([out] if want_bias
                                                      else [])
    if not kernels.on_card(*tensors):
        return nhc_step_plain(hist, k, gin, elems, out)
    kernels.launch(
        "nhc_step", "sanm_nhc_step", hist.data_ptr(), gin.data_ptr(),
        elems.bias.data_ptr(), elems.dminv.data_ptr(),
        out.data_ptr() if want_bias else None, elems.B, k, order,
        float(elems.mu), float(elems.lam), int(want_bias),
    )
    return out


def _order_pass(hist, m, Fm, mu, lam, commit):
    """Plain order-m pass over histories 0..m-1 with F_m = ``Fm``; see
    ``csrc/nhc_series.cu`` for the recurrences.  Commit stores C row 0,
    Q, J and L of order m; otherwise returns P_m (B, 9)."""
    def F(t):
        return Fm if t == m else hist[t, _F]

    s1 = torch.zeros_like(Fm)
    s2 = torch.zeros_like(Fm)
    for t in range(m + 1):
        A, Bv = F(t), F(m - t)
        s1 = s1 + A[_M1A] * Bv[_M1B]
        s2 = s2 + A[_M2A] * Bv[_M2B]
    Cm = (s1 - s2) * _SIGN.to(Fm.device)[:, None]
    Jm = torch.zeros_like(Fm[0])
    for t in range(m + 1):
        f = F(t)[0:3]
        c = Cm[0:3] if t == 0 else hist[m - t, _C0]
        for j in range(3):
            Jm = Jm + f[j] * c[j]
    if m == 0:
        Qm = Cm / Jm
        Lm = torch.log(Jm)
    else:
        J0 = hist[0, _J]
        conv = torch.zeros_like(Cm)
        for t in range(1, m):
            conv = conv + hist[t, _Q] * hist[m - t, _J]
        Qm = (Cm - hist[0, _Q] * Jm - conv) / J0
        cl = torch.zeros_like(Jm)
        for t in range(1, m):
            cl = cl + hist[t, _L] * hist[m - t, _J] * (t / m)
        Lm = Jm / J0 + (-cl / J0)
    if commit:
        hist[m, _C0] = Cm[0:3]
        hist[m, _Q] = Qm
        hist[m, _J] = Jm
        hist[m, _L] = Lm
        return None
    conv = torch.zeros_like(Qm)
    for t in range(m + 1):
        lt = Lm if t == m else hist[t, _L]
        qt = Qm if t == 0 else hist[m - t, _Q]
        conv = conv + (lam * lt) * qt
    return (mu * Fm - mu * Qm) + conv


def nhc_step_plain(hist, k: int, gin, elems: NHCElements, out=None):
    """Plain torch version of :func:`nhc_step` (same function, same
    arguments)."""
    _check_step(hist, k, gin, elems, out)
    B = elems.B
    g = gin + elems.bias if k == 0 else gin
    Fk = torch.bmm(g.reshape(B, 3, 3), elems.dminv.reshape(B, 3, 3))
    Fk = Fk.reshape(B, 9).T.contiguous()  # component-major like hist
    hist[k, _F] = Fk
    _order_pass(hist, k, Fk, elems.mu, elems.lam, commit=True)
    if out is None:
        return None
    P = _order_pass(hist, k + 1, torch.zeros_like(Fk), elems.mu, elems.lam,
                    commit=False)
    out.copy_(P.T)
    return out


def committed_output(hist, k: int, elems: NHCElements):
    """P_k (B, 9) of a committed order k, from the histories (plain torch;
    used to hold the port's commits against another engine's)."""
    Fk = hist[k, _F]
    mu, lam = elems.mu, elems.lam
    conv = torch.zeros_like(Fk)
    for t in range(k + 1):
        conv = conv + (lam * hist[t, _L]) * hist[k - t, _Q]
    return ((mu * Fk - mu * hist[k, _Q]) + conv).T.contiguous()


class NHCSeries:
    """Series state of one expansion: the histories and a bias buffer.

    ``start(gin0)`` commits order 0 (and checks that the order-1 bias is
    structurally zero); ``step(k, gin_k)`` commits order k and returns
    the order-(k+1) bias (B, 9)."""

    def __init__(self, elems: NHCElements, order: int):
        self.elems = elems
        self.order = int(order)
        dev = elems.device
        self.hist = torch.empty((self.order + 1, NCOMP, elems.B),
                                dtype=torch.float64, device=dev)
        self.bias_out = torch.empty((elems.B, 9), dtype=torch.float64,
                                    device=dev)

    def start(self, gin0):
        b1 = nhc_step(self.hist, 0, gin0, self.elems, self.bias_out)
        if int(torch.count_nonzero(b1)) != 0:
            raise SANMError("order-1 bias must be structurally zero")

    def step(self, k: int, gin_k):
        return nhc_step(self.hist, k, gin_k, self.elems, self.bias_out)
