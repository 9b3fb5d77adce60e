"""Tensor-level operators: closed-form 3x3 linear algebra, the
per-element constants, the NHC Taylor-series kernel (K1), the batched
3x3 SVD-W (K8a) and the ARAP Taylor-series kernel (K8b)."""

from .linalg import (  # noqa: F401
    batched_cofactor,
    batched_det,
    batched_inv,
    batched_mul_eye,
    batched_transpose,
)
