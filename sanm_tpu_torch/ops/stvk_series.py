"""K1s: the per-order Taylor step of the St. Venant-Kirchhoff stretch stress.

Takes the place of the JAX package's generic Taylor engine
(``sanm_tpu/taylor.py`` + ``sanm_tpu/taylor_scan.py``, the
``_dot_general_rule`` and ``_add_rule``) for this one graph
(``sanm_tpu/fea/material.py:95-100``)::

    P = mu (b F - F),   b = F F^T,   F = (g + bias) Dm^-1.

Per element the series state is kept in one preallocated history
``hist`` (order+1, 15, B), float64, holding only what a later order
reads: F 0-8 (b's products and b F) and the six entries of the
symmetric b 9-14, in the order b00, b01, b02, b11, b12, b22 (b F).  Per
order m::

    b_m = sum_{t=0..m} F_t F_{m-t}^T
    P_m = mu (sum_{t=0..m} b_t F_{m-t} - F_m)

The bias of order m is P_m with g_m held at zero: F_m enters P_m through
b_0 F_m, through the terms F_0 F_m^T + F_m F_0^T of b_m, and through
-F_m, and all three drop out with F_m = 0.  At m = 1 every term holds a
factor of order 1, so the bias is exactly zero.

:func:`stvk_step` commits order k from the graph input ``g_k`` and
returns the order-(k+1) bias of P.  The recurrence is written out in
``csrc/stvk_series.cu``; :func:`stvk_step_plain` computes the same with
torch ops, summing over t in ascending order, as the CPU path and the
kernel's test oracle.
"""

from __future__ import annotations

import torch

from .. import kernels
from .elements import Elements
from .nhc_series import NHCSeries, check_step, order_f

NCOMP = 15
_F, _B = slice(0, 9), slice(9, 15)
# a history row's component groups (F, b), for comparisons
GROUPS = (_F, _B)
# b's stored entries (i, j), i <= j, and the full 3x3 from them
_BI = [0, 0, 0, 1, 1, 2]
_BJ = [0, 1, 2, 1, 2, 2]
_SYM = [0, 1, 2, 1, 3, 4, 2, 4, 5]


def stvk_step(hist, k: int, gin, elems: Elements, out=None):
    """Commit order k into ``hist`` from graph input ``gin`` (B, 9); when
    ``out`` (B, 9) is given, write the order-(k+1) bias of P into it.
    Launches the CUDA kernel for card tensors, runs
    :func:`stvk_step_plain` for CPU tensors, raises for anything else."""
    order, want_bias = check_step(hist, k, gin, elems, out, NCOMP)
    tensors = [hist, gin, elems.bias, elems.dminv] + ([out] if want_bias
                                                      else [])
    if not kernels.on_card(*tensors):
        return stvk_step_plain(hist, k, gin, elems, out)
    kernels.launch(
        "stvk_step", "sanm_stvk_step", hist.data_ptr(), gin.data_ptr(),
        elems.bias.data_ptr(), elems.dminv.data_ptr(),
        out.data_ptr() if want_bias else None, elems.B, k, order,
        float(elems.mu), int(want_bias),
    )
    return out


def _order_pass(hist, m, Fm, mu, commit):
    """Plain order-m pass over histories 0..m-1 with F_m = ``Fm`` (9, B);
    see ``csrc/stvk_series.cu``.  Commit stores b_m; otherwise (the bias,
    ``Fm`` zero) returns P_m (9, B) from the terms free of F_m, without
    reading b_0."""
    B = Fm.shape[1]
    lo = 0 if commit else 1

    def F(t):
        return (Fm if t == m else hist[t, _F]).reshape(3, 3, B)

    bm = torch.zeros((6, B), dtype=Fm.dtype, device=Fm.device)
    for t in range(lo, m + 1 - lo):
        bm = bm + (F(t)[_BI] * F(m - t)[_BJ]).sum(1)
    if commit:
        hist[m, _B] = bm
        return None
    P = torch.zeros((3, 3, B), dtype=Fm.dtype, device=Fm.device)
    for t in range(1, m + 1):
        bt = (bm if t == m else hist[t, _B])[_SYM].reshape(3, 3, B)
        P = P + (bt[:, :, None, :] * F(m - t)[None, :, :, :]).sum(1)
    return mu * (P.reshape(9, B) - Fm)


def stvk_step_plain(hist, k: int, gin, elems: Elements, out=None):
    """Plain torch version of :func:`stvk_step` (same function, same
    arguments)."""
    check_step(hist, k, gin, elems, out, NCOMP)
    Fk = order_f(k, gin, elems)
    hist[k, _F] = Fk
    _order_pass(hist, k, Fk, elems.mu, commit=True)
    if out is None:
        return None
    P = _order_pass(hist, k + 1, torch.zeros_like(Fk), elems.mu,
                    commit=False)
    out.copy_(P.T)
    return out


def committed_output(hist, k: int, elems: Elements):
    """P_k (B, 9) of a committed order k, from the histories (plain torch;
    used to hold the port's commits against another engine's)."""
    B = hist.shape[2]
    P = torch.zeros((3, 3, B), dtype=hist.dtype, device=hist.device)
    for t in range(k + 1):
        bt = hist[t, _B][_SYM].reshape(3, 3, B)
        P = P + (bt[:, :, None, :]
                 * hist[k - t, _F].reshape(3, 3, B)[None]).sum(1)
    return (elems.mu * (P.reshape(9, B) - hist[k, _F])).T.contiguous()


class StVKSeries(NHCSeries):
    """:class:`~.nhc_series.NHCSeries` with the StVK step (K1s) and its
    15-component histories."""

    ncomp = NCOMP
    step_fn = staticmethod(stvk_step)
