"""SVD-W: the decomposition M = U S U^T W with orthogonal U, W (K8a).

Port of ``sanm_tpu/ops/svd_w.py`` for 3x3 batches.  Writing M = U S V^T
for the ordinary SVD, W = U V^T is the rotation factor of the polar
decomposition M = P W with P = U S U^T symmetric.  Here:

* :func:`svd_w` evaluates the batched decomposition with the
  ``require_rotation`` sign flip that makes det(W) = +1
  (``svd_w.py:71-117``, line for line).  It is the K8a wrapper: it
  launches ``csrc/svd_w.cu`` for card tensors and runs
  :func:`svd_w_plain` for CPU tensors.  The kernel always flips; the
  unflipped decomposition (``require_rotation=False``) is plain only;
* :func:`svd_w_jvp`, the analytic first-order rule (``svd_w.py:173``);
* :func:`pw_order`, the polar-mode order-k rule (``_svd_taylor_pw``,
  ``svd_w.py:295``, and the pw branch of ``_svd_scan_rule``,
  ``:469-508``) as a plain function of the series so far; the K8b kernel
  (``csrc/arap_series.cu``) writes the same rule out per element.

Degenerate spectra are handled with the Tikhonov-regularised division
``clip_div(x, y) = x y / (y^2 + 1e-12)``.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..utils import SANMError
from .linalg import batched_det
from .svd3 import svd_batched_small

CLIP_EPS = 1e-12
GROUP_EPS = 1e-3  # singular values closer than this are one group


def clip_div(x, y):
    return x * y / (y * y + CLIP_EPS)


# ---------------------------------------------------------------------------
# K8a: the decomposition
# ---------------------------------------------------------------------------


def svd_w_plain(m, require_rotation: bool = True):
    """Plain torch version of :func:`svd_w` (same arguments, same
    results)."""
    u, s, vh = svd_batched_small(m)
    if require_rotation:
        # flip a group of singular values (and the matching U columns) so
        # that det(U) det(V) = +1, hence det(W) = +1: prefer the group of
        # smallest values with the least repetitions; negate the whole
        # group when its size is odd, otherwise a single member
        n = 3
        B = m.shape[0]
        dev = m.device
        need = batched_det(u) * batched_det(vh.transpose(-1, -2)) < 0
        is_start = [torch.ones(B, dtype=torch.bool, device=dev)]
        for i in range(1, n):
            is_start.append((s[:, i - 1] - s[:, i]) >= GROUP_EPS)
        sizes = []
        for i in range(n):
            nr = torch.ones(B, dtype=torch.int32, device=dev)
            alive = torch.ones(B, dtype=torch.bool, device=dev)
            for j in range(i + 1, n):
                alive = alive & ~is_start[j]
                nr = nr + alive.to(torch.int32)
            sizes.append(torch.where(is_start[i], nr, torch.zeros_like(nr)))
        best_idx = torch.zeros(B, dtype=torch.int32, device=dev)
        best_nr = torch.full((B,), n + 1, dtype=torch.int32, device=dev)
        for i in range(n):
            nr = sizes[i]
            cand = is_start[i] & (
                (nr <= best_nr) | ((nr == best_nr + 1) & (nr % 2 == 1)))
            best_idx = torch.where(cand, torch.full_like(best_idx, i),
                                   best_idx)
            best_nr = torch.where(cand, nr, best_nr)
        single = (best_nr == 1) | (best_nr % 2 == 0)
        idxs = torch.arange(n, device=dev)
        in_group = (idxs[None, :] >= best_idx[:, None]) & (
            idxs[None, :] < (best_idx + best_nr)[:, None])
        flip_mask = torch.where(single[:, None],
                                idxs[None, :] == best_idx[:, None], in_group)
        sign = torch.where(need[:, None] & flip_mask, -1.0, 1.0).to(s.dtype)
        s = s * sign
        u = u * sign[:, None, :]
    w = u @ vh
    return u, s, w


def svd_w(m, require_rotation: bool = True):
    """Batched SVD-W of ``m`` (B, 3, 3) float64: ``(u, s, w)`` with
    ``m = u diag(s) u^T w``.  Launches the K8a kernel for a card tensor,
    runs :func:`svd_w_plain` for a CPU tensor, raises for anything
    else, and on the card for ``require_rotation=False`` (the kernel
    always makes det(W) = +1)."""
    if kernels.tracing():
        # the SVD-W Taylor rules (the polar and the full mode) are not in
        # the port's engine yet: a traced graph that calls svd_w has no
        # rule, as in the JAX engine for a primitive without one
        raise SANMError("no Taylor rule for svd_w in the port's engine")
    if m.dim() != 3:
        raise SANMError("m: shape %s, expected (B, 3, 3)" % (tuple(m.shape),))
    B = m.shape[0]
    kernels.check(m, "m", (B, 3, 3), torch.float64)
    if not kernels.on_card(m):
        return svd_w_plain(m, require_rotation)
    if not require_rotation:
        raise SANMError("svd_w on the card always applies the det(W) = +1 "
                        "flip")
    u = torch.empty_like(m)
    w = torch.empty_like(m)
    s = torch.empty((B, 3), dtype=m.dtype, device=m.device)
    kernels.launch("svd_w", "sanm_svd_w", m.data_ptr(), u.data_ptr(),
                   s.data_ptr(), w.data_ptr(), B)
    return u, s, w


def polar_w(m):
    """Rotation factor W, det(W) = +1, of the polar decomposition
    m = P W."""
    return svd_w(m)[2]


# ---------------------------------------------------------------------------
# first order: with A = U^T dM V,
#   dS = diag(A),  dW = U X V^T, X_ij = (A_ij - A_ji) / (s_i + s_j),
#   dU = U Omega,  Omega_ij = (s_j A_ij + s_i A_ji) / (s_j^2 - s_i^2)
# ---------------------------------------------------------------------------


def svd_w_jvp(u, s, w, dm):
    """Tangents ``(du, ds, dw)`` of :func:`svd_w` at its results
    ``(u, s, w)`` along ``dm`` (B, 3, 3) (``svd_w.py:173-199``)."""
    v = w.transpose(-1, -2) @ u  # V = W^T U
    a = u.transpose(-1, -2) @ dm @ v
    at = a.transpose(-1, -2)
    ds = torch.diagonal(a, dim1=-2, dim2=-1)
    sp = s[:, :, None] + s[:, None, :]
    sm2 = s[:, None, :] ** 2 - s[:, :, None] ** 2  # s_j^2 - s_i^2 at (i, j)
    x = clip_div(a - at, sp)
    dw = u @ x @ v.transpose(-1, -2)
    omega = clip_div(s[:, None, :] * a + s[:, :, None] * at, sm2)
    omega = omega * (1.0 - torch.eye(3, dtype=dm.dtype, device=dm.device))
    du = u @ omega
    return du, ds, dw


# ---------------------------------------------------------------------------
# order k, polar mode: with the convolution biases
#   Bm_k = sum_{0<i<k} M_i M_{k-i}^T, Bp_k = sum_{0<i<k} S_i S_{k-i},
#   Bpw_k = sum_{0<i<k} S_i W_{k-i},
# the series of S = U S U^T and W satisfy
#   S_k S_0 + S_0 S_k = M_k M_0^T + M_0 M_k^T + Bm_k - Bp_k,
#   W_k = S_0^-1 (M_k - Bpw_k - S_k W_0),
# and S_k = U0 z U0^T turns the first into (s_i + s_j) z_ij = e_ij.
# ---------------------------------------------------------------------------


def _mm(a, b):
    return a @ b


def _mm_t2(a, b):  # a b^T
    return a @ b.transpose(-1, -2)


def _conv_sym(xs, k, combine):
    """``sum_{i=1..k-1} combine(xs(i), xs(k-i))`` for terms that pair as
    transposes: the ``i < k/2`` half summed, mirrored, plus the even-k
    middle term once (``ScanEngine.buf_conv_sym``,
    ``taylor_scan.py:250``).  ``xs(i)`` gives order i as (B, 3, 3)."""
    acc = None
    for i in range(1, (k + 1) // 2):
        t = combine(xs(i), xs(k - i))
        acc = t if acc is None else acc + t
    res = None if acc is None else acc + acc.transpose(-1, -2)
    if k % 2 == 0 and k >= 2:
        mid = combine(xs(k // 2), xs(k // 2))
        res = mid if res is None else res + mid
    return res


def _conv(xs, ys, k):
    """``sum_{i=1..k-1} xs(i) @ ys(k-i)``, or None when empty."""
    acc = None
    for i in range(1, k):
        t = xs(i) @ ys(k - i)
        acc = t if acc is None else acc + t
    return acc


def pw_order(u0, s0, v0, w0, ms, ss, ws, m_k, k):
    """``(S_k, W_k)`` of the polar-mode series at order k >= 1, each
    (B, 3, 3), from the order-0 factors ``u0``, ``s0`` (B, 3), ``v0``,
    ``w0``, the series so far (``ms(i)``, ``ss(i)``, ``ws(i)`` give
    order i < k of M, S, W) and the input coefficient ``m_k``."""
    zero = torch.zeros_like(m_k)
    bm = _conv_sym(ms, k, _mm_t2)
    bp = _conv_sym(ss, k, _mm)  # every S_i is symmetric
    bpw = _conv(ss, ws, k)
    c = (zero if bm is None else bm) - (zero if bp is None else bp)
    e = (u0.transpose(-1, -2) @ c) @ u0
    umv = (u0.transpose(-1, -2) @ m_k) @ v0  # U0^T M_k V0
    e = e + umv * s0[:, None, :] + s0[:, :, None] * umv.transpose(-1, -2)
    z = clip_div(e, s0[:, :, None] + s0[:, None, :])
    s_k = _mm_t2(u0 @ z, u0)  # U0 z U0^T
    resid = m_k - s_k @ w0
    if bpw is not None:
        resid = resid - bpw
    s0inv = clip_div(torch.ones_like(s0), s0)
    w_k = _mm_t2(u0 * s0inv[:, None, :], u0) @ resid  # S0^-1 resid
    return s_k, w_k
