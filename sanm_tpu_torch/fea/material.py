"""Hyperelastic material models as batched torch expressions.

Port of ``sanm_tpu/fea/material.py`` (reference ``fea/material.{h,cpp}``)
for this slice: the energy-model names, the moduli, and ``pk1`` for the
compressible Neo-Hookean model (NHC).  The other models' stresses
belong to later slices of the port and raise.

Conventions: F deformation gradient (B, 3, 3), J = det(F),
P first Piola-Kirchhoff stress.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch

from ..ops import batched_det, batched_inv, batched_transpose
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
    if energy_model == EnergyModel.NEOHOOKEAN_C:
        mu = material.shear_modulus
        lam = material.lame_first
        FTinv = batched_transpose(batched_inv(F))
        J = batched_det(F)[:, None, None]
        return mu * F - mu * FTinv + lam * torch.log(J) * FTinv
    raise SANMError(f"pk1 for {energy_model} is not ported yet")
