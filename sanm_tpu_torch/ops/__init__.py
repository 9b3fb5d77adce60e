"""Tensor-level operators: closed-form 3x3 linear algebra and the NHC
Taylor-series kernel (K1)."""

from .linalg import (  # noqa: F401
    batched_cofactor,
    batched_det,
    batched_inv,
    batched_transpose,
)
