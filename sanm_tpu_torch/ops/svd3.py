"""Batched 3x3 SVD by one-sided Jacobi, as plain torch.

Port of ``sanm_tpu/ops/svd3.py``: every matrix rotates in lockstep
through a fixed number of cyclic sweeps over the column pairs (0, 1),
(0, 2), (1, 2), with the same overflow-free rotation (``_rotate_pair``,
``svd3.py:24-61``), the same stable descending sort and the same
cross-product repair of a null third column.  The arithmetic is written
in the same order as the JAX version, so that near-ties are decided the
same way.  It is the plain version of the SVD inside the K8a kernel
(``csrc/svd_w.cu``).
"""

from __future__ import annotations

import torch

from ..utils import SANMError

N_SWEEPS = 12  # quadratic convergence; 3x3 reaches f64 limits in ~6
PAIRS = ((0, 1), (0, 2), (1, 2))


def _dot3(a, b):
    """Row-wise dot product of (B, 3) tensors, summed left to right."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _rotate_pair(A, V, p, q):
    """One Jacobi rotation orthogonalising columns p, q of every A (in
    place; V accumulates the rotations)."""
    ap = A[:, :, p].clone()
    aq = A[:, :, q].clone()
    app = _dot3(ap, ap)
    aqq = _dot3(aq, aq)
    apq = _dot3(ap, aq)
    # t = 2 apq sign(d) / (|d| + sqrt(d^2 + 4 apq^2)), d = aqq - app: never
    # divides by apq, so it cannot overflow for a tiny apq
    d = aqq - app
    den = torch.abs(d) + torch.sqrt(d * d + 4.0 * apq * apq)
    sign_d = torch.where(d < 0, -1.0, 1.0).to(d.dtype)
    t = 2.0 * apq * sign_d / torch.where(den == 0, torch.ones_like(den), den)
    t = torch.where(torch.abs(apq) <= 1e-300, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    cb = c[:, None]
    sb = s[:, None]
    A[:, :, p] = cb * ap - sb * aq
    A[:, :, q] = sb * ap + cb * aq
    vp = V[:, :, p].clone()
    vq = V[:, :, q].clone()
    V[:, :, p] = cb * vp - sb * vq
    V[:, :, q] = sb * vp + cb * vq


def svd_batched_small(m):
    """SVD of (B, 3, 3): ``(u, s, vh)`` with the singular values sorted
    descending and ``m = u @ diag(s) @ vh``."""
    if m.dim() != 3 or tuple(m.shape[1:]) != (3, 3):
        raise SANMError("svd_batched_small takes (B, 3, 3), got %s"
                        % (tuple(m.shape),))
    B = m.shape[0]
    A = m.clone()
    V = torch.eye(3, dtype=m.dtype, device=m.device).expand(B, 3, 3).clone()
    for _ in range(N_SWEEPS):
        for p, q in PAIRS:
            _rotate_pair(A, V, p, q)

    s = torch.sqrt(A[:, 0, :] * A[:, 0, :] + A[:, 1, :] * A[:, 1, :]
                   + A[:, 2, :] * A[:, 2, :])  # column norms (B, 3)
    order = torch.argsort(-s, dim=1, stable=True)
    s = torch.gather(s, 1, order)
    idx = order[:, None, :].expand(B, 3, 3)
    A = torch.gather(A, 2, idx)
    V = torch.gather(V, 2, idx)

    # columns of A into U; a near-null third column is rebuilt as the
    # cross product of the first two (keeps U orthogonal)
    u = A / torch.where(s > 1e-300, s, torch.ones_like(s))[:, None, :]
    a, b = u[:, :, 0], u[:, :, 1]
    cross = torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                         a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                         a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)
    cn = torch.sqrt(_dot3(cross, cross))[:, None]
    cross = cross / torch.where(cn > 0, cn, torch.ones_like(cn))
    bad = (s[:, 2] <= 1e-15 * s[:, 0])[:, None]
    u[:, :, 2] = torch.where(bad, cross, u[:, :, 2])
    return u, s, V.transpose(1, 2)
