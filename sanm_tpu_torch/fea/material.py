"""Hyperelastic material models as batched torch expressions.

Port of ``sanm_tpu/fea/material.py`` (reference ``fea/material.{h,cpp}``)
for every material: the energy-model names, the moduli, ``pk1`` for
the compressible (NHC) and incompressible (NHI) Neo-Hookean models, for
ARAP (whose SVD-W runs through K8a on the card) and for the stretch term
of St. Venant-Kirchhoff (StVK), the Cauchy stress of NHC and NHI (the
inverse model's), and the ARAP energy density.

Conventions: F deformation gradient (B, 3, 3), J = det(F),
b = F F^T, P first Piola-Kirchhoff stress, sigma Cauchy stress.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch

from ..ops import batched_det, batched_inv, batched_transpose
from ..ops.svd_w import polar_w
from ..utils import SANMError


class EnergyModel(enum.Enum):
    """Reference ``fea::EnergyModel`` (``fea/material.h:50-55``)."""

    NEOHOOKEAN_I = "neohookean_i"  # incompressible neo-hookean
    NEOHOOKEAN_C = "neohookean_c"  # compressible neo-hookean
    ARAP = "arap"  # as-rigid-as-possible
    StVK_STRETCH = "stvk_stretch"  # stretch term of St. Venant-Kirchhoff

    @staticmethod
    def from_name(name: str) -> "EnergyModel":
        for e in EnergyModel:
            if e.value == name:
                return e
        raise SANMError(f"unknown energy model {name!r}")


@dataclass(frozen=True)
class MaterialProperty:
    """Elastic moduli (reference ``fea::MaterialProperty``,
    ``fea/material.h:19-48``, conversions ``material.cpp:10-18``)."""

    young_modulus: float
    poisson_ratio: float
    density: float = 0.0

    @property
    def bulk_modulus(self):  # K
        return self.young_modulus / (3.0 * (1.0 - 2.0 * self.poisson_ratio))

    @property
    def shear_modulus(self):  # mu (Lame second)
        return self.young_modulus / (2.0 * (1.0 + self.poisson_ratio))

    @property
    def lame_first(self):  # lambda
        E, nu = self.young_modulus, self.poisson_ratio
        return E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))

    @staticmethod
    def from_young_poisson(E, nu, density=0.0):
        return MaterialProperty(E, nu, density)


def pk1(energy_model: EnergyModel, material: MaterialProperty, F, dim: int):
    """First Piola-Kirchhoff stress P(F) (reference ``fea::pk1``,
    ``fea/material.cpp:55-99``)."""
    mu = material.shear_modulus
    if energy_model == EnergyModel.NEOHOOKEAN_I:
        k = material.bulk_modulus
        FTinv = batched_transpose(batched_inv(F))
        J = batched_det(F)[:, None, None]
        Ic = torch.sum(F * F, dim=(-1, -2))[:, None, None]
        J23 = J ** (-2.0 / 3.0)
        t2 = ((-mu / 3.0) * J23 * Ic + k * J * J - k * J) * FTinv
        return mu * J23 * F + t2
    if energy_model == EnergyModel.NEOHOOKEAN_C:
        lam = material.lame_first
        FTinv = batched_transpose(batched_inv(F))
        J = batched_det(F)[:, None, None]
        return mu * F - mu * FTinv + lam * torch.log(J) * FTinv
    if energy_model == EnergyModel.ARAP:
        return (F - polar_w(F)) * mu
    if energy_model == EnergyModel.StVK_STRETCH:
        b = torch.bmm(F, F.transpose(1, 2))
        return mu * (torch.bmm(b, F) - F)
    raise SANMError(f"pk1 unimplemented for {energy_model}")


def cauchy_stress(energy_model: EnergyModel, material: MaterialProperty, F,
                  dim: int):
    """Cauchy stress sigma(F) (reference ``fea::cauchy_stress``,
    ``fea/material.cpp:20-53``), which the inverse model reads since it
    acts on *deformed* normals."""
    mu = material.shear_modulus
    eye = torch.eye(dim, dtype=F.dtype, device=F.device)
    if energy_model == EnergyModel.NEOHOOKEAN_I:
        k = material.bulk_modulus
        b = torch.bmm(F, F.transpose(1, 2))
        J = batched_det(F)
        Ic = torch.sum(F * F, dim=(-1, -2))
        J53 = J ** (-5.0 / 3.0)
        t2 = (-mu / 3.0) * (J53 * Ic) + k * J - k
        return mu * J53[:, None, None] * b + t2[:, None, None] * eye
    if energy_model == EnergyModel.NEOHOOKEAN_C:
        lam = material.lame_first
        b = torch.bmm(F, F.transpose(1, 2))
        Jinv = batched_det(F) ** (-1.0)
        xI = mu * Jinv + lam * Jinv * torch.log(Jinv)
        return mu * Jinv[:, None, None] * b - xI[:, None, None] * eye
    raise SANMError(f"cauchy_stress unimplemented for {energy_model}")


def elastic_potential_density(energy_model: EnergyModel,
                              material: MaterialProperty, F, dim: int):
    """Per-element elastic energy density; None when the model does not
    provide it (reference ``fea::elastic_potential_density``,
    ``fea/material.cpp:101-115``, ARAP only)."""
    if energy_model == EnergyModel.ARAP:
        d = F - polar_w(F)
        return torch.sum(d * d, dim=(-1, -2)) * (material.shear_modulus / 2.0)
    return None
