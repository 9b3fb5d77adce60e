"""Batched small-matrix linear algebra as elementwise torch.

Port of ``sanm_tpu/ops/linalg.py:23-110``: closed-form transpose,
determinant, cofactor and inverse of (B, n, n) tensors for n <= 3,
written as products and sums of entries.  The generic-n primitives
(SVD cofactor, polymat determinant) belong to a later slice.
"""

from __future__ import annotations

import torch

from ..utils import SANMError


def batched_transpose(x):
    """(B, m, n) -> (B, n, m)."""
    return x.transpose(-1, -2)


def batched_det(x):
    """Batched determinant via the Leibniz expansion (n <= 3)."""
    n = x.shape[-1]
    if x.shape[-2] != n:
        raise SANMError("batched_det: not square")
    if n == 1:
        return x[..., 0, 0]
    if n == 2:
        return x[..., 0, 0] * x[..., 1, 1] - x[..., 0, 1] * x[..., 1, 0]
    if n == 3:
        return (
            x[..., 0, 0] * (x[..., 1, 1] * x[..., 2, 2] - x[..., 1, 2] * x[..., 2, 1])
            - x[..., 0, 1] * (x[..., 1, 0] * x[..., 2, 2] - x[..., 1, 2] * x[..., 2, 0])
            + x[..., 0, 2] * (x[..., 1, 0] * x[..., 2, 1] - x[..., 1, 1] * x[..., 2, 0])
        )
    raise SANMError("batched_det: n=%d is not ported (n <= 3 only)" % n)


def batched_cofactor(x):
    """Cofactor matrix C with C[i,j] = d det(x) / d x[i,j]
    (so ``det(x) * inv(x) == C^T``)."""
    n = x.shape[-1]
    if n == 1:
        return torch.ones_like(x)
    if n == 2:
        a, b = x[..., 0, 0], x[..., 0, 1]
        c, d = x[..., 1, 0], x[..., 1, 1]
        return torch.stack(
            [torch.stack([d, -c], dim=-1), torch.stack([-b, a], dim=-1)],
            dim=-2,
        )
    if n == 3:
        def minor(i, j):
            rows = [r for r in range(3) if r != i]
            cols = [c for c in range(3) if c != j]
            return (
                x[..., rows[0], cols[0]] * x[..., rows[1], cols[1]]
                - x[..., rows[0], cols[1]] * x[..., rows[1], cols[0]]
            )

        entries = [
            [minor(i, j) * ((-1.0) ** (i + j)) for j in range(3)]
            for i in range(3)
        ]
        return torch.stack(
            [torch.stack(row, dim=-1) for row in entries], dim=-2
        )
    raise SANMError("batched_cofactor: n=%d is not ported (n <= 3 only)" % n)


def batched_inv(x):
    """Batched inverse via adjugate / determinant (n <= 3)."""
    det = batched_det(x)
    adj = batched_transpose(batched_cofactor(x))
    return adj / det[..., None, None]
