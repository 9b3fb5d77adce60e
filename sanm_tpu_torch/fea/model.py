"""Deformable body: assembling the elastic force model.

Port of ``sanm_tpu/fea/model.py`` (reference ``DeformableBody``,
``fea/mesh_template.h:163-237``), forward model only: the unknowns are
the deformed free vertex coordinates; the graph maps remapped shape
matrices Ds to the first Piola-Kirchhoff stress P(F) with
F = (g + bias) Dm^-1; the output remap (rest-shape normals) turns P into
nodal forces.  The model lives on one device: its remaps run through
the K2 kernels (``solver/assemble.py``) and the stress in f64 torch
(ARAP's SVD-W through K8a).  It hands the ANM driver its material's
series and Jacobian assembly (:data:`MATERIAL_KERNELS`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..ops.arap_series import ARAPSeries
from ..ops.elements import Elements
from ..ops.nhc_series import NHCSeries
from ..ops.nhi_series import NHISeries
from ..ops.svd_w import svd_w
from ..solver.assemble import (DeviceAssembler, jac_asm, jac_asm_arap,
                               jac_asm_nhi)
from ..solver.remap import SparseAssembler
from ..utils import SANMError
from .material import EnergyModel, MaterialProperty, pk1
from .mesh import TetrahedralMesh
from .remap import ForceOutputRemap, ShapeMatRemap


def _jac_asm_arap(asm, elems, gin0):
    """K8a's SVD-W of F at ``gin0``, then K8c."""
    return jac_asm_arap(asm, elems,
                        *svd_w(elems.deformation_gradient(gin0)))


#: per ported energy model, its series class (K1, K1n, K8b) and its
#: Jacobian assembly ``(asm, elems, gin0) -> (data, E)`` (K3, K3n,
#: K8a + K8c)
MATERIAL_KERNELS = {
    EnergyModel.NEOHOOKEAN_C: (NHCSeries, jac_asm),
    EnergyModel.NEOHOOKEAN_I: (NHISeries, jac_asm_nhi),
    EnergyModel.ARAP: (ARAPSeries, _jac_asm_arap),
}
#: the energy models whose series and Jacobian kernels are ported
PORTED = tuple(MATERIAL_KERNELS)


@dataclass
class ElasticForceModel:
    """Reference ``DeformableBody::ElasticForceModel``
    (``fea/mesh_template.h:153-159``), with its device state: the
    assembler plan (``asm``) and the per-element constants
    (``elems``)."""

    energy_model: EnergyModel
    material: MaterialProperty
    lt_inp: ShapeMatRemap
    lt_out: ForceOutputRemap
    asm: DeviceAssembler
    elems: Elements

    @property
    def device(self):
        return self.asm.device

    def x0(self):
        return self.lt_inp.x0

    def stress(self, gin):
        """P (B, 9) at graph input ``gin`` (B, 9)."""
        F = self.elems.deformation_gradient(gin)
        return pk1(self.energy_model, self.material, F, 3).reshape(-1, 9)

    def series(self, order: int):
        """The material's Taylor-series state for one expansion of
        ``order`` (:data:`MATERIAL_KERNELS`)."""
        return MATERIAL_KERNELS[self.energy_model][0](self.elems, order)

    def jac_asm(self, gin0):
        """``(data, E)``: the CSR values and the condensed element
        stiffness of the material's Jacobian at ``gin0``
        (:data:`MATERIAL_KERNELS`)."""
        return MATERIAL_KERNELS[self.energy_model][1](self.asm, self.elems,
                                                      gin0)

    def eval_force(self, x):
        """Nodal force (n,) at unknown vector x, evaluated in f64 on the
        model's device; returned as NumPy."""
        gin = self.asm.apply_in(np.asarray(x).reshape(-1))
        return self.asm.apply_out(self.stress(gin)).cpu().numpy()


class DeformableBody:
    """Reference ``DeformableBody<3, TetrahedralMesh>``."""

    def __init__(self, material: MaterialProperty, mesh: TetrahedralMesh):
        self.material = material
        self.mesh = mesh
        self.coord_fixed_mask = np.zeros((mesh.nr_vertices, 3), bool)

    def make_forward(self, energy_model: EnergyModel,
                     device=None) -> ElasticForceModel:
        """Forward model (reference ``make_forward``,
        ``fea/mesh_template.h:191-219``) on ``device`` (default: the
        card; see :func:`sanm_tpu_torch.resolve_device`)."""
        if energy_model not in PORTED:
            raise SANMError("energy model %s is not ported yet (ported: %s)"
                            % (energy_model.value,
                               ", ".join(m.value for m in PORTED)))
        dev = resolve_device(device)
        lt_inp = ShapeMatRemap(self.mesh, self.coord_fixed_mask)
        lt_out = ForceOutputRemap(lt_inp)
        T = self.mesh.nr_tet
        plan = SparseAssembler(lt_out.remap, lt_inp.remap, T, 9, 9,
                               lt_inp.n_unknown_vtx)
        dm_inv = np.linalg.inv(self.mesh.shape_matrix)
        elems = Elements(
            dminv=torch.as_tensor(dm_inv.reshape(T, 9)).to(dev),
            bias=torch.as_tensor(lt_inp.bias.reshape(T, 9)).to(dev),
            mu=self.material.shear_modulus,
            lam=self.material.lame_first,
            kappa=self.material.bulk_modulus,
        )
        return ElasticForceModel(
            energy_model, self.material, lt_inp, lt_out,
            DeviceAssembler.from_plan(plan, dev), elems,
        )

    @staticmethod
    def compute_force_rms(model: ElasticForceModel, xt, f_load,
                          final_mesh=None, sanity_check=False) -> float:
        """Recompute the force residual RMS at a solution (reference
        ``compute_force_rms``, ``fea/mesh_template.h:221-237``)."""
        force = np.asarray(model.eval_force(xt))
        f_load = np.asarray(f_load).reshape(-1)
        if sanity_check:
            scale = np.maximum(np.abs(force), 1.0)
            if np.max(np.abs(force + f_load) / scale) > 1e-5:
                raise SANMError("force equilibrium check failed")
        r = force + f_load
        return float(np.sqrt(np.mean(r * r)))
