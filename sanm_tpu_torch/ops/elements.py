"""Per-element constants of the stress graph of a forward model.

The ported materials evaluate P(F) per tetrahedron with
``F = (g + bias) Dm^-1`` from the remapped graph input ``g``: NHC reads
both Lame parameters, NHI mu and the bulk modulus kappa, ARAP only mu.
:class:`Elements` holds what the per-element kernels (K1, K1n, K3, K3n,
K8a-c) read besides their inputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


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
