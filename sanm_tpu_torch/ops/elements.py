"""Per-element constants of the stress graph of a model.

The ported materials evaluate P(F) per tetrahedron with
``F = (g + bias) Dm^-1`` from the remapped graph input ``g``: NHC reads
both Lame parameters, NHI mu and the bulk modulus kappa, ARAP only mu.
:class:`Elements` holds what the per-element kernels (K1, K1n, K3, K3n,
K8a-c) read besides their inputs.  The inverse model's graph reads the
rest shape matrix ``Dm = g + bias`` and the constant shape matrix Ds of
the given (deformed) mesh, ``F = Ds (g + bias)^-1``:
:class:`InvElements` holds what its kernels (K1i, K3i) read.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .linalg import batched_inv


@dataclass
class Elements:
    """Dm^-1 and the fixed-coordinate bias of Ds, both (B, 9) float64 on
    one device, the Lame parameters and the bulk modulus."""

    dminv: torch.Tensor
    bias: torch.Tensor
    mu: float
    lam: float
    kappa: float

    @property
    def B(self):
        return self.dminv.shape[0]

    @property
    def device(self):
        return self.dminv.device

    def deformation_gradient(self, gin):
        """F = (g + bias) Dm^-1 (B, 3, 3) for the graph input ``gin``
        (B, 9)."""
        B = self.B
        return torch.bmm((gin + self.bias).reshape(B, 3, 3),
                         self.dminv.reshape(B, 3, 3))


@dataclass
class InvElements:
    """The inverse model's constants: Ds of the given mesh and the
    fixed-coordinate bias of Dm, both (B, 9) float64 on one device, the
    Lame parameters and the bulk modulus."""

    ds: torch.Tensor
    bias: torch.Tensor
    mu: float
    lam: float
    kappa: float

    @property
    def B(self):
        return self.ds.shape[0]

    @property
    def device(self):
        return self.ds.device

    def deformation_gradient(self, gin):
        """F = Ds (g + bias)^-1 (B, 3, 3) for the graph input ``gin``
        (B, 9), the inverse through the adjugate as the JAX package's
        ``batched_inv``."""
        B = self.B
        return torch.bmm(self.ds.reshape(B, 3, 3),
                         batched_inv((gin + self.bias).reshape(B, 3, 3)))
