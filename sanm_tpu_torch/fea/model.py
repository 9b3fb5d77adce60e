"""Deformable body: assembling the elastic force model.

Port of ``sanm_tpu/fea/model.py`` (reference ``DeformableBody``,
``fea/mesh_template.h:163-237``), forward model only: the unknowns are
the deformed free vertex coordinates; the graph maps remapped shape
matrices Ds to the first Piola-Kirchhoff stress P(F) with
F = (g + bias) Dm^-1; the output remap (rest-shape normals) turns P into
nodal forces.  The model lives on one device: its remaps run through
the K2 kernels (``solver/assemble.py``) and the stress in f64 torch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..ops.nhc_series import NHCElements
from ..solver.assemble import DeviceAssembler
from ..solver.remap import SparseAssembler
from ..utils import SANMError
from .material import EnergyModel, MaterialProperty, pk1
from .mesh import TetrahedralMesh
from .remap import ForceOutputRemap, ShapeMatRemap


@dataclass
class ElasticForceModel:
    """Reference ``DeformableBody::ElasticForceModel``
    (``fea/mesh_template.h:153-159``), with its device state: the
    assembler plan (``asm``) and the NHC per-element constants
    (``elems``)."""

    energy_model: EnergyModel
    material: MaterialProperty
    lt_inp: ShapeMatRemap
    lt_out: ForceOutputRemap
    asm: DeviceAssembler
    elems: NHCElements

    @property
    def device(self):
        return self.asm.device

    def x0(self):
        return self.lt_inp.x0

    def stress(self, gin):
        """P (B, 9) at graph input ``gin`` (B, 9)."""
        B = self.elems.B
        F = torch.bmm((gin + self.elems.bias).reshape(B, 3, 3),
                      self.elems.dminv.reshape(B, 3, 3))
        return pk1(self.energy_model, self.material, F, 3).reshape(B, 9)

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
        if energy_model != EnergyModel.NEOHOOKEAN_C:
            raise SANMError("energy model %s is not ported yet (this slice "
                            "ports neohookean_c)" % energy_model.value)
        dev = resolve_device(device)
        lt_inp = ShapeMatRemap(self.mesh, self.coord_fixed_mask)
        lt_out = ForceOutputRemap(lt_inp)
        T = self.mesh.nr_tet
        plan = SparseAssembler(lt_out.remap, lt_inp.remap, T, 9, 9,
                               lt_inp.n_unknown_vtx)
        dm_inv = np.linalg.inv(self.mesh.shape_matrix)
        elems = NHCElements(
            dminv=torch.as_tensor(dm_inv.reshape(T, 9)).to(dev),
            bias=torch.as_tensor(lt_inp.bias.reshape(T, 9)).to(dev),
            mu=self.material.shear_modulus,
            lam=self.material.lame_first,
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
