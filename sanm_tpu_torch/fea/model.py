"""Deformable body: assembling the elastic force model.

Port of ``sanm_tpu/fea/model.py`` (reference ``DeformableBody``,
``fea/mesh_template.h:163-237``):

* forward model: the unknowns are the deformed free vertex coordinates
  (and, with a ``vtx_delta``, the continuation parameter t of the
  implicit solver); the graph maps remapped shape matrices Ds to the
  first Piola-Kirchhoff stress P(F) with F = (g + bias) Dm^-1; the output
  remap (rest-shape normals) turns P into nodal forces;
* inverse model (rest-shape design): the unknowns are the *rest*
  coordinates; the graph maps remapped rest shape matrices Dm to the
  Cauchy stress sigma(F) with F = Ds (g + bias)^-1 (Ds of the given,
  deformed mesh); the output remap uses the given mesh's normals.  Its
  Jacobian is not symmetric (``symmetric`` False), so its solve stays on
  host LU.

The model lives on one device: its remaps run through the K2 kernels
(``solver/assemble.py``) and the stress in f64 torch (ARAP's SVD-W
through K8a).  It hands the ANM driver its material's series and
Jacobian assembly (:data:`MATERIAL_KERNELS`), and the baselines K10's
projected Hessian (:data:`HESS_PROJ`).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..ops.arap_series import ARAPSeries
from ..ops.elements import Elements, InvElements
from ..ops.inv_series import InvNHCSeries, InvNHISeries
from ..ops.nhc_series import NHCSeries
from ..ops.nhi_series import NHISeries
from ..ops.stvk_series import StVKSeries
from ..ops.svd_w import svd_w
from ..solver.assemble import (DeviceAssembler, hess_proj, hess_proj_arap,
                               hess_proj_nhi, jac_asm, jac_asm_arap,
                               jac_asm_inv, jac_asm_inv_nhi, jac_asm_nhi,
                               jac_asm_stvk)
from ..solver.remap import SparseAssembler
from ..utils import SANMError
from .material import (EnergyModel, MaterialProperty, cauchy_stress,
                       elastic_potential_density, pk1)
from .mesh import TetrahedralMesh
from .remap import ForceOutputRemap, ShapeMatRemap


def _jac_asm_arap(asm, elems, gin0):
    """K8a's SVD-W of F at ``gin0``, then K8c (and K3t)."""
    return jac_asm_arap(asm, elems,
                        *svd_w(elems.deformation_gradient(gin0)))


def _hess_proj_arap(asm, elems, gin0):
    """K8a's SVD-W of F at ``gin0``, then K10."""
    return hess_proj_arap(asm, elems,
                          *svd_w(elems.deformation_gradient(gin0)))


#: per ported energy model, K10's projected Hessian of a forward model
#: ``(asm, elems, gin0) -> (data, E)`` (the baselines)
HESS_PROJ = {
    EnergyModel.NEOHOOKEAN_C: hess_proj,
    EnergyModel.NEOHOOKEAN_I: hess_proj_nhi,
    EnergyModel.ARAP: _hess_proj_arap,
}


#: per ported (energy model, inverse), its series class (K1, K1n, K1s,
#: K8b; K1i) and its Jacobian assembly ``(asm, elems, gin0) -> (data,
#: grad_t, E)`` (K3, K3n, K3s, K8a + K8c, each followed by K3t where the
#: plan has a t column; K3i).  StVK has no K10 entry: the JAX baselines
#: have no StVK energy (``sanm_tpu/fea/baseline.py:87``).
MATERIAL_KERNELS = {
    (EnergyModel.NEOHOOKEAN_C, False): (NHCSeries, jac_asm),
    (EnergyModel.NEOHOOKEAN_I, False): (NHISeries, jac_asm_nhi),
    (EnergyModel.StVK_STRETCH, False): (StVKSeries, jac_asm_stvk),
    (EnergyModel.ARAP, False): (ARAPSeries, _jac_asm_arap),
    (EnergyModel.NEOHOOKEAN_C, True): (InvNHCSeries, jac_asm_inv),
    (EnergyModel.NEOHOOKEAN_I, True): (InvNHISeries, jac_asm_inv_nhi),
}
#: the energy models whose forward series and Jacobian kernels are ported
PORTED = tuple(em for em, inverse in MATERIAL_KERNELS if not inverse)


@dataclass
class ElasticForceModel:
    """Reference ``DeformableBody::ElasticForceModel``
    (``fea/mesh_template.h:153-159``), with its device state: the
    assembler plan (``asm``) and the per-element constants (``elems``:
    :class:`Elements`, or :class:`InvElements` for an ``inverse``
    model)."""

    energy_model: EnergyModel
    material: MaterialProperty
    lt_inp: ShapeMatRemap
    lt_out: ForceOutputRemap
    asm: DeviceAssembler
    elems: Elements
    vols: torch.Tensor  # (B,) volumes of the mesh the model was made on
    inverse: bool = False

    @property
    def device(self):
        return self.asm.device

    @property
    def symmetric(self):
        """Whether the Jacobian is symmetric: a forward model's is (the
        Hessian of an energy), the inverse model's is not.  The band
        Cholesky factors only a symmetric one (``solver/anm.py``)."""
        return not self.inverse

    @property
    def n_input(self):
        """The length of the input remap's operand: the unknowns, plus t
        for a model with a ``vtx_delta``."""
        return self.lt_inp.remap.inp_size

    def x0(self):
        return self.lt_inp.x0

    def fn(self, g):
        """The stress graph as a plain torch function of the graph input
        ``g`` (B, 3, 3), in the shape the input remap gives it: P (B, 3, 3)
        (sigma for an inverse model), as the JAX model's ``fn``
        (``sanm_tpu/fea/model.py:41``).  It is what the Taylor engine
        (``taylor.py``) traces; the ANM driver runs the material's kernels
        (:data:`MATERIAL_KERNELS`) instead."""
        F = self.elems.deformation_gradient(g.reshape(-1, 9))
        stress = cauchy_stress if self.inverse else pk1
        return stress(self.energy_model, self.material, F, 3)

    def stress(self, gin):
        """P (B, 9) at graph input ``gin`` (B, 9); sigma for an inverse
        model."""
        return self.fn(gin).reshape(-1, 9)

    def _kernels(self):
        return MATERIAL_KERNELS[(self.energy_model, self.inverse)]

    def series(self, order: int):
        """The material's Taylor-series state for one expansion of
        ``order`` (:data:`MATERIAL_KERNELS`)."""
        return self._kernels()[0](self.elems, order)

    def jac_asm(self, gin0):
        """``(data, grad_t, E)``: the CSR values, the assembled t column
        (None without a ``vtx_delta``) and the condensed element
        stiffness of the material's Jacobian at ``gin0``
        (:data:`MATERIAL_KERNELS`)."""
        if not self.asm.jacobian:
            raise SANMError("a force-only model has no Jacobian plan")
        return self._kernels()[1](self.asm, self.elems, gin0)

    def hess_proj(self, gin0):
        """``(data, E)``: K10's eigen-projected Hessian of the energy at
        ``gin0``, as CSR values and condensed element blocks in the ANM
        Jacobian's sign (:data:`HESS_PROJ`; the baselines)."""
        if self.inverse or not self.asm.jacobian:
            raise SANMError("the projected Hessian needs a forward model "
                            "with a Jacobian plan")
        return HESS_PROJ[self.energy_model](self.asm, self.elems, gin0)

    def eval_force(self, x):
        """Nodal force (n,) at unknown vector x ((n + 1,) with the t
        entry for a model with a ``vtx_delta``), evaluated in f64 on the
        model's device; returned as NumPy."""
        gin = self.asm.apply_in(np.asarray(x).reshape(-1))
        return self.asm.apply_out(self.stress(gin)).cpu().numpy()

    def eval_potential(self, x):
        """The elastic energy sum_e W(F_e) vol_e at x, as a float; None
        for a material without a potential density (NHC, NHI: only ARAP
        has one, as in the JAX package) and for an inverse model."""
        if self.inverse:
            return None
        F = self.elems.deformation_gradient(
            self.asm.apply_in(np.asarray(x).reshape(-1)))
        w = elastic_potential_density(self.energy_model, self.material, F, 3)
        return None if w is None else float((w * self.vols).sum())


class DeformableBody:
    """Reference ``DeformableBody<3, TetrahedralMesh>``."""

    def __init__(self, material: MaterialProperty, mesh: TetrahedralMesh):
        self.material = material
        self.mesh = mesh
        self.coord_fixed_mask = np.zeros((mesh.nr_vertices, 3), bool)
        self._lt_out = (None, None)  # (key, ForceOutputRemap)

    def _force_output_remap(self, lt_inp):
        """The output remap: it depends on the fixed mask and the rest
        mesh only, so the deform task's five models (the continuation,
        two force checks, the potential, the refinement) share one."""
        key = hashlib.sha1(self.coord_fixed_mask.tobytes()
                           + self.mesh.vertices.tobytes()).digest()
        if self._lt_out[0] != key:
            self._lt_out = (key, ForceOutputRemap(lt_inp))
        return self._lt_out[1]

    def make_forward(self, energy_model: EnergyModel, init_vtx_coord=None,
                     vtx_delta=None, device=None,
                     jacobian=True) -> ElasticForceModel:
        """Forward model (reference ``make_forward``,
        ``fea/mesh_template.h:191-219``) from the vertex coordinates
        ``init_vtx_coord`` (default: the mesh's), with the implicit
        solver's t column when ``vtx_delta`` (V, 3) is given, on
        ``device`` (default: the card; see
        :func:`sanm_tpu_torch.resolve_device`).  ``jacobian=False`` makes
        a force-only model, which evaluates forces and the potential and
        skips the Jacobian's CSR plan (about half of the host set-up)."""
        if energy_model not in PORTED:
            raise SANMError("energy model %s is not ported yet (ported: %s)"
                            % (energy_model.value,
                               ", ".join(m.value for m in PORTED)))
        dev = resolve_device(device)
        lt_inp = ShapeMatRemap(self.mesh, self.coord_fixed_mask,
                               init_vtx_coord, vtx_delta)
        dm_inv = np.linalg.inv(self.mesh.shape_matrix)
        return self._model(energy_model, lt_inp, Elements, dm_inv, dev,
                           jacobian, False)

    def make_inverse(self, energy_model: EnergyModel, device=None,
                     jacobian=True) -> ElasticForceModel:
        """Inverse (rest-shape design) model (reference ``make_inverse``,
        ``fea/mesh_template.h:172-189``): the unknowns are the rest
        coordinates, starting from the mesh's (the given, deformed
        shape); the graph is sigma(Ds (g + bias)^-1), Ds the mesh's shape
        matrix; on ``device`` as :meth:`make_forward`.  Only NHC and NHI
        have a Cauchy stress, as in the JAX package."""
        if (energy_model, True) not in MATERIAL_KERNELS:
            raise SANMError(f"cauchy_stress unimplemented for {energy_model}")
        dev = resolve_device(device)
        lt_inp = ShapeMatRemap(self.mesh, self.coord_fixed_mask, None, None)
        return self._model(energy_model, lt_inp, InvElements,
                           self.mesh.shape_matrix, dev, jacobian, True)

    def _model(self, energy_model, lt_inp, elems_cls, mat, dev, jacobian,
               inverse):
        """The model on ``dev`` from its input remap: the output remap,
        the assembler plan and the per-element constants (``mat``
        (T, 3, 3): Dm^-1, or the inverse model's Ds)."""
        lt_out = self._force_output_remap(lt_inp)
        T = self.mesh.nr_tet
        plan = SparseAssembler(lt_out.remap, lt_inp.remap, T, 9, 9,
                               lt_inp.n_unknown_vtx)
        elems = elems_cls(
            torch.as_tensor(np.reshape(mat, (T, 9))).to(dev),
            bias=torch.as_tensor(lt_inp.bias.reshape(T, 9)).to(dev),
            mu=self.material.shear_modulus,
            lam=self.material.lame_first,
            kappa=self.material.bulk_modulus,
        )
        return ElasticForceModel(
            energy_model, self.material, lt_inp, lt_out,
            DeviceAssembler.from_plan(plan, dev, jacobian), elems,
            torch.as_tensor(self.mesh.tet_volumes).to(dev), inverse,
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
