"""K1n: the per-order Taylor step of the incompressible Neo-Hookean stress.

Takes the place of the JAX package's generic Taylor engine
(``sanm_tpu/taylor.py`` + ``sanm_tpu/taylor_scan.py``, with the
non-integer power rule ``_pow_like_rule``) for this one graph
(``sanm_tpu/fea/material.py:80-89``)::

    P = mu A F + s Q,   A = J^(-2/3),   s = (-mu/3) A Ic + k J J - k J,
    Q = F^-T,   J = det F,   Ic = |F|^2,   F = (g + bias) Dm^-1.

Per element the series state is kept in one preallocated history
``hist`` (order+1, 25, B), float64, holding only what a later order
reads: F 0-8 (the cofactor's, Ic's and P's products), row 0 of the
cofactor C 9-11 (J = F[0,:] . C[0,:] reads no other row), Q 12-20 (its
own quotient recurrence and P's product s Q), J 21 (Q's and A's
recurrences and J J), A 22 (its own power recurrence, A F and A Ic),
Ic 23 (A Ic) and s 24 (s Q).  The layout of F, C row 0, Q and J is
NHC's (``ops/nhc_series.py``), so both steps share
:func:`~.nhc_series.cofactor_terms`.

:func:`nhi_step` commits order k from the graph input ``g_k`` and returns
the order-(k+1) bias of P (P_{k+1} with g_{k+1} = 0).  The recurrences
are written out in ``csrc/nhi_series.cu``; :func:`nhi_step_plain`
computes the same with torch ops, as the CPU path and the kernel's test
oracle.
"""

from __future__ import annotations

import torch

from .. import kernels
from .elements import Elements
from .nhc_series import NHCSeries, check_step, cofactor_terms, order_f

NCOMP = 25
P_EXP = -2.0 / 3.0  # A = J^P_EXP
_F, _C0, _Q, _J, _A, _IC, _S = (slice(0, 9), slice(9, 12), slice(12, 21),
                                21, 22, 23, 24)
# a history row's component groups, for comparisons
GROUPS = (_F, _C0, _Q) + tuple(slice(c, c + 1) for c in (_J, _A, _IC, _S))


def nhi_step(hist, k: int, gin, elems: Elements, out=None):
    """Commit order k into ``hist`` from graph input ``gin`` (B, 9); when
    ``out`` (B, 9) is given, write the order-(k+1) bias of P into it.
    Launches the CUDA kernel for card tensors, runs
    :func:`nhi_step_plain` for CPU tensors, raises for anything else."""
    order, want_bias = check_step(hist, k, gin, elems, out, NCOMP)
    tensors = [hist, gin, elems.bias, elems.dminv] + ([out] if want_bias
                                                      else [])
    if not kernels.on_card(*tensors):
        return nhi_step_plain(hist, k, gin, elems, out)
    kernels.launch(
        "nhi_step", "sanm_nhi_step", hist.data_ptr(), gin.data_ptr(),
        elems.bias.data_ptr(), elems.dminv.data_ptr(),
        out.data_ptr() if want_bias else None, elems.B, k, order,
        float(elems.mu), float(elems.kappa), int(want_bias),
    )
    return out


def _order_pass(hist, m, Fm, mu, kappa, commit):
    """Plain order-m pass over histories 0..m-1 with F_m = ``Fm``; see
    ``csrc/nhi_series.cu`` for the recurrences.  Commit stores C row 0,
    Q, J, A, Ic and s of order m; otherwise returns P_m (B, 9)."""
    Cm, Jm, Qm = cofactor_terms(hist, m, Fm)

    def F(t):
        return Fm if t == m else hist[t, _F]

    Icm = torch.zeros_like(Jm)
    for t in range(m + 1):
        Icm = Icm + (F(t) * F(m - t)).sum(0)
    if m == 0:
        Am = Jm ** P_EXP
    else:
        J0, A0 = hist[0, _J], hist[0, _A]
        conv = torch.zeros_like(Jm)
        for i in range(1, m):
            conv = conv + ((i / m) * (P_EXP + 1.0) - 1.0) * (
                hist[i, _J] * hist[m - i, _A])
        Am = (P_EXP * A0 / J0) * Jm + conv / J0

    def at(c, cm):
        return lambda t: cm if t == m else hist[t, c]

    A, J, Ic = at(_A, Am), at(_J, Jm), at(_IC, Icm)
    a_ic = torch.zeros_like(Jm)
    jj = torch.zeros_like(Jm)
    for t in range(m + 1):
        a_ic = a_ic + A(t) * Ic(m - t)
        jj = jj + J(t) * J(m - t)
    Sm = (-mu / 3.0) * a_ic + kappa * jj - kappa * Jm
    if commit:
        hist[m, _C0] = Cm[0:3]
        hist[m, _Q] = Qm
        hist[m, _J] = Jm
        hist[m, _A] = Am
        hist[m, _IC] = Icm
        hist[m, _S] = Sm
        return None
    S = at(_S, Sm)
    P = torch.zeros_like(Fm)
    for t in range(m + 1):
        qt = Qm if t == 0 else hist[m - t, _Q]
        P = P + mu * A(t) * F(m - t) + S(t) * qt
    return P


def nhi_step_plain(hist, k: int, gin, elems: Elements, out=None):
    """Plain torch version of :func:`nhi_step` (same function, same
    arguments)."""
    check_step(hist, k, gin, elems, out, NCOMP)
    Fk = order_f(k, gin, elems)
    hist[k, _F] = Fk
    _order_pass(hist, k, Fk, elems.mu, elems.kappa, commit=True)
    if out is None:
        return None
    P = _order_pass(hist, k + 1, torch.zeros_like(Fk), elems.mu,
                    elems.kappa, commit=False)
    out.copy_(P.T)
    return out


def committed_output(hist, k: int, elems: Elements):
    """P_k (B, 9) of a committed order k, from the histories (plain torch;
    used to hold the port's commits against another engine's)."""
    P = torch.zeros_like(hist[k, _F])
    for t in range(k + 1):
        P = P + elems.mu * hist[t, _A] * hist[k - t, _F] \
            + hist[t, _S] * hist[k - t, _Q]
    return P.T.contiguous()


class NHISeries(NHCSeries):
    """:class:`~.nhc_series.NHCSeries` with the NHI step (K1n) and its
    25-component histories."""

    ncomp = NCOMP
    step_fn = staticmethod(nhi_step)
