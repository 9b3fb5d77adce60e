"""K8b: the per-order Taylor step of the ARAP stress.

Takes the place of the JAX package's generic Taylor engine for the graph
``P = mu (F - W)``, ``W = polar_w(F)``, ``F = (g + bias) Dm^-1``
(``sanm_tpu/fea/material.py:93-94``), whose only non-linear operator is
SVD-W in polar mode (``sanm_tpu/ops/svd_w.py:469-508``).  The series
state of one expansion is one preallocated history ``hist``
(order+2, 24, B), float64, element index fastest: rows 0..order hold
per order M = F (components 0-8), the symmetric stretch S = U S U^T as
its 6 unique entries 00, 01, 02, 11, 12, 22 (9-14) and W (15-23); row
order+1 holds the order-0 factors U0 (0-8), s0 (9-11) and V0 = W0^T U0
(12-20).

:meth:`ARAPSeries.start` commits order 0 through K8a (``svd_w``);
:func:`arap_step` commits order k >= 1 from the graph input ``g_k`` and
returns the order-(k+1) bias of P (P_{k+1} with g_{k+1} = 0).  The rule
is written out in ``csrc/arap_series.cu``; :func:`arap_step_plain`
computes the same with :func:`~sanm_tpu_torch.ops.svd_w.pw_order`, as
the CPU path and the kernel's oracle.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..utils import SANMError
from .elements import Elements
from .svd_w import pw_order, svd_w

NCOMP = 24
_M, _S, _W = slice(0, 9), slice(9, 15), slice(15, 24)
_U, _S0, _V = slice(0, 9), slice(9, 12), slice(12, 21)  # constants row
# a history row's component groups (M, S, W), for comparisons
GROUPS = (_M, _S, _W)
_SYM = (0, 1, 2, 4, 5, 8)  # flat 3x3 indices of S's unique entries
_FULL = (0, 1, 2, 1, 3, 4, 2, 4, 5)  # flat 3x3 index -> unique entry


def _mat(rows):
    """(9, B) component rows -> (B, 3, 3)."""
    return rows.T.reshape(-1, 3, 3)


def _rows(x):
    """(B, 3, 3) -> (9, B) component rows."""
    return x.reshape(-1, 9).T


def _sym(rows):
    """(6, B) unique entries -> (B, 3, 3) symmetric."""
    return _mat(rows[list(_FULL)])


def _check_step(hist, k, gin, elems, out):
    B = elems.B
    if hist.dim() != 3 or hist.shape[1:] != (NCOMP, B):
        raise SANMError("hist: shape %s, expected (order+2, %d, %d)"
                        % (tuple(hist.shape), NCOMP, B))
    kernels.check(hist, "hist", hist.shape, torch.float64)
    kernels.check(gin, "gin", (B, 9), torch.float64)
    kernels.check(elems.dminv, "dminv", (B, 9), torch.float64)
    order = hist.shape[0] - 2
    want_bias = out is not None
    if not 1 <= k <= order or (want_bias and k + 1 > order):
        raise SANMError("order k=%d out of range 1..%d for histories of "
                        "order %d" % (k, order, order))
    if want_bias:
        kernels.check(out, "out", (B, 9), torch.float64)
    return order, want_bias


def arap_step(hist, k: int, gin, elems: Elements, out=None):
    """Commit order k >= 1 into ``hist`` from the graph input ``gin``
    (B, 9); when ``out`` (B, 9) is given, write the order-(k+1) bias of
    P into it.  Launches the K8b kernel for card tensors, runs
    :func:`arap_step_plain` for CPU tensors, raises for anything else."""
    order, want_bias = _check_step(hist, k, gin, elems, out)
    tensors = [hist, gin, elems.dminv] + ([out] if want_bias else [])
    if not kernels.on_card(*tensors):
        return arap_step_plain(hist, k, gin, elems, out)
    kernels.launch(
        "arap_step", "sanm_arap_step", hist.data_ptr(), gin.data_ptr(),
        elems.dminv.data_ptr(), out.data_ptr() if want_bias else None,
        elems.B, k, order, float(elems.mu), int(want_bias),
    )
    return out


def arap_step_plain(hist, k: int, gin, elems: Elements, out=None):
    """Plain torch version of :func:`arap_step` (same function, same
    arguments)."""
    order, _ = _check_step(hist, k, gin, elems, out)
    B = elems.B
    const = hist[order + 1]
    u0, v0 = _mat(const[_U]), _mat(const[_V])
    s0 = const[_S0].T
    w0 = _mat(hist[0, _W])

    def ms(i):
        return _mat(hist[i, _M])

    def ss(i):
        return _sym(hist[i, _S])

    def ws(i):
        return _mat(hist[i, _W])

    m_k = torch.bmm(gin.reshape(B, 3, 3), elems.dminv.reshape(B, 3, 3))
    s_k, w_k = pw_order(u0, s0, v0, w0, ms, ss, ws, m_k, k)
    hist[k, _M] = _rows(m_k)
    hist[k, _S] = _rows(s_k)[list(_SYM)]
    hist[k, _W] = _rows(w_k)
    if out is None:
        return None
    zero = torch.zeros_like(m_k)
    _, w_m = pw_order(u0, s0, v0, w0, ms, ss, ws, zero, k + 1)
    out.copy_(((zero - w_m) * elems.mu).reshape(B, 9))
    return out


def committed_output(hist, k: int, elems: Elements):
    """P_k = mu (M_k - W_k) (B, 9) of a committed order k, from the
    histories (plain torch; used to hold the port's commits against
    another engine's)."""
    return ((hist[k, _M] - hist[k, _W]) * elems.mu).T.contiguous()


class ARAPSeries:
    """Series state of one expansion: the histories and a bias buffer,
    with the interface of :class:`~sanm_tpu_torch.ops.nhc_series.
    NHCSeries`.

    ``start(gin0)`` commits order 0 (F0 and its SVD-W through K8a; the
    order-1 bias is zero: every convolution is empty and M_1 = 0);
    ``step(k, gin_k)`` commits order k and returns the order-(k+1) bias
    (B, 9)."""

    def __init__(self, elems: Elements, order: int):
        self.elems = elems
        self.order = int(order)
        dev = elems.device
        self.hist = torch.zeros((self.order + 2, NCOMP, elems.B),
                                dtype=torch.float64, device=dev)
        self.bias_out = torch.empty((elems.B, 9), dtype=torch.float64,
                                    device=dev)

    def start(self, gin0):
        F0 = self.elems.deformation_gradient(gin0)
        u, s, w = svd_w(F0)
        h, c = self.hist[0], self.hist[self.order + 1]
        h[_M] = _rows(F0)
        h[_S] = _rows((u * s[:, None, :]) @ u.transpose(1, 2))[list(_SYM)]
        h[_W] = _rows(w)
        c[_U] = _rows(u)
        c[_S0] = s.T
        c[_V] = _rows(w.transpose(1, 2) @ u)

    def step(self, k: int, gin_k):
        return arap_step(self.hist, k, gin_k, self.elems, self.bias_out)
