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

import torch

from .. import kernels
from ..utils import SANMError
from .elements import Elements

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


def check_step(hist, k, gin, elems, out, ncomp=NCOMP, const="dminv"):
    """Check the arguments of a Neo-Hookean series step (histories of
    ``ncomp`` components; ``const`` names the per-element matrix the step
    reads besides the bias: Dm^-1, or the inverse model's Ds); returns
    ``(order, want_bias)``."""
    B = elems.B
    if hist.dim() != 3 or hist.shape[1:] != (ncomp, B):
        raise SANMError("hist: shape %s, expected (order+1, %d, %d)"
                        % (tuple(hist.shape), ncomp, B))
    kernels.check(hist, "hist", hist.shape, torch.float64)
    kernels.check(gin, "gin", (B, 9), torch.float64)
    kernels.check(elems.bias, "bias", (B, 9), torch.float64)
    kernels.check(getattr(elems, const), const, (B, 9), torch.float64)
    order = hist.shape[0] - 1
    want_bias = out is not None
    if not 0 <= k <= order or (want_bias and k + 1 > order):
        raise SANMError("order k=%d out of range for histories of order %d"
                        % (k, order))
    if want_bias:
        kernels.check(out, "out", (B, 9), torch.float64)
    return order, want_bias


def nhc_step(hist, k: int, gin, elems: Elements, out=None):
    """Commit order k into ``hist`` from graph input ``gin`` (B, 9); when
    ``out`` (B, 9) is given, write the order-(k+1) bias of P into it.
    Launches the CUDA kernel for card tensors, runs
    :func:`nhc_step_plain` for CPU tensors, raises for anything else."""
    order, want_bias = check_step(hist, k, gin, elems, out)
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


def cofactor_det(hist, m, Fm):
    """``(C_m, J_m)`` (9, B), (B,): order m of the cofactor and of det F
    from histories 0..m-1 (F 0-8, C row 0 9-11, J 21, as the Neo-Hookean
    steps lay them out) with F_m = ``Fm``; the Cauchy products of
    ``csrc/nh_series.h``."""
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
    return Cm, Jm


def quotient(hist, m, Nm, Jm):
    """Order m of Q = N / J (9, B) from the histories of Q (12-20) and J
    (21) and N_m = ``Nm``, J_m = ``Jm``: the div rule of
    ``csrc/nh_series.h``."""
    if m == 0:
        return Nm / Jm
    J0 = hist[0, _J]
    conv = torch.zeros_like(Nm)
    for t in range(1, m):
        conv = conv + hist[t, _Q] * hist[m - t, _J]
    return (Nm - hist[0, _Q] * Jm - conv) / J0


def cofactor_terms(hist, m, Fm):
    """``(C_m, J_m, Q_m)`` (9, B), (B,), (9, B): order m of the cofactor,
    det F and F^-T = C / J (:func:`cofactor_det`, :func:`quotient`)."""
    Cm, Jm = cofactor_det(hist, m, Fm)
    return Cm, Jm, quotient(hist, m, Cm, Jm)


def _order_pass(hist, m, Fm, mu, lam, commit):
    """Plain order-m pass over histories 0..m-1 with F_m = ``Fm``; see
    ``csrc/nhc_series.cu`` for the recurrences.  Commit stores C row 0,
    Q, J and L of order m; otherwise returns P_m (B, 9)."""
    Cm, Jm, Qm = cofactor_terms(hist, m, Fm)
    if m == 0:
        Lm = torch.log(Jm)
    else:
        J0 = hist[0, _J]
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


def order_f(k, gin, elems: Elements):
    """F_k (9, B), component-major like the histories: g_k Dm^-1, with
    the bias added to g_0."""
    B = elems.B
    g = gin + elems.bias if k == 0 else gin
    Fk = torch.bmm(g.reshape(B, 3, 3), elems.dminv.reshape(B, 3, 3))
    return Fk.reshape(B, 9).T.contiguous()


def nhc_step_plain(hist, k: int, gin, elems: Elements, out=None):
    """Plain torch version of :func:`nhc_step` (same function, same
    arguments)."""
    check_step(hist, k, gin, elems, out)
    Fk = order_f(k, gin, elems)
    hist[k, _F] = Fk
    _order_pass(hist, k, Fk, elems.mu, elems.lam, commit=True)
    if out is None:
        return None
    P = _order_pass(hist, k + 1, torch.zeros_like(Fk), elems.mu, elems.lam,
                    commit=False)
    out.copy_(P.T)
    return out


def committed_output(hist, k: int, elems: Elements):
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
    the order-(k+1) bias (B, 9).  :class:`~.nhi_series.NHISeries` is the
    same with NHI's step and histories."""

    ncomp = NCOMP
    step_fn = staticmethod(nhc_step)

    def __init__(self, elems: Elements, order: int):
        self.elems = elems
        self.order = int(order)
        dev = elems.device
        self.hist = torch.empty((self.order + 1, self.ncomp, elems.B),
                                dtype=torch.float64, device=dev)
        self.bias_out = torch.empty((elems.B, 9), dtype=torch.float64,
                                    device=dev)

    def start(self, gin0):
        b1 = self.step_fn(self.hist, 0, gin0, self.elems, self.bias_out)
        if int(torch.count_nonzero(b1)) != 0:
            raise SANMError("order-1 bias must be structurally zero")

    def step(self, k: int, gin_k):
        return self.step_fn(self.hist, k, gin_k, self.elems, self.bias_out)
