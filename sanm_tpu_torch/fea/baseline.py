"""Classical baseline solvers: projected Newton energy minimisation and
Levenberg-Marquardt force equilibrium.

Port of ``sanm_tpu/fea/baseline.py`` (reference ``fea/baseline/*``,
``baseline/main.cpp:228-510``).  These exist for benchmark comparison:
the ANM solver is the product.

The card does the per-element work, on one forward model of the mesh
whose unknowns are the free coordinates and whose fixed coordinates sit
at the start (:class:`_Kernels`): the energy density (:func:`_psi`, f64
torch; ARAP's W through K8a), the forces from the stress through K2's
fixed-order gather (``-dE/dx`` without autograd: at rest the singular
values of F are degenerate and the SVD's backward is not finite there),
and the Hessian: K10's eigen-projected element Hessians, or unprojected,
minus the ANM Jacobian (K3, K3n, K8a + K8c), as CSR values over the free
dofs.  The Newton and Levenberg-Marquardt control loops and the linear
solves run on the host (SciPy's SuperLU, or ``cho_factor`` for small
dense systems), as in the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops import batched_det
from ..solver.remap import diag_nnz_pos
from ..utils import (SANMError, SANMNumericalError, ScopedProfiler, Timer,
                     sanm_assert)
from .material import (EnergyModel, MaterialProperty,
                       elastic_potential_density)
from .mesh import TetrahedralMesh
from .model import DeformableBody


@dataclass
class BaselineStat:
    """Reference ``baseline::Stat`` (``baseline/main.h:11-18``)."""

    nr_iter: int = 0
    nr_iter_refine: int = 0
    tot_time: float = 0.0
    tot_newton_time: float = 0.0
    df: float = 0.0
    dx: float = 0.0
    grad_rms: float = 0.0
    grad_rms_refine: float = 0.0
    energy: float = 0.0
    vtx: Optional[np.ndarray] = None

    def as_json(self):
        """Stat-JSON keys as emitted by the reference
        (``make_baseline_stat``, ``fea/main.cpp:158-170``)."""
        return {
            "iter_tot": self.nr_iter,
            "iter_refine": self.nr_iter_refine,
            "df": self.df,
            "dx": self.dx,
            "force_rms": self.grad_rms,
            "force_rms_refine": self.grad_rms_refine,
            "potential": self.energy,
            "time": self.tot_time,
            "newton_time": self.tot_newton_time,
        }


def material_desc_from_config(config) -> tuple:
    m = config["material"]
    mat = MaterialProperty.from_young_poisson(
        float(m["young"]), float(m["poisson"]), float(m.get("density", 0))
    )
    return EnergyModel.from_name(config["energy_model"]), mat


def _psi(em: EnergyModel, mat: MaterialProperty, F):
    """Energy density per element (B,) of F (B, 3, 3); consistent with
    :func:`~sanm_tpu_torch.fea.material.pk1`."""
    mu = mat.shear_modulus
    J = batched_det(F)
    Ic = torch.sum(F * F, dim=(1, 2))
    if em == EnergyModel.NEOHOOKEAN_C:
        lam = mat.lame_first
        return mu / 2 * (Ic - 3) - mu * torch.log(J) + lam / 2 * torch.log(J) ** 2
    if em == EnergyModel.NEOHOOKEAN_I:
        k = mat.bulk_modulus
        return mu / 2 * (J ** (-2.0 / 3.0) * Ic - 3) + k / 2 * (J - 1) ** 2
    if em == EnergyModel.ARAP:
        return elastic_potential_density(em, mat, F, 3)
    raise SANMError(f"baseline energy unimplemented for {em}")


class _Kernels:
    """The element programs of one (mesh, fixed mask, material) on one
    device: a forward model built from ``rest_vtx`` whose fixed
    coordinates sit at ``vtx_dst``.  Every method takes the full vertex
    array (V, 3), whose fixed coordinates must be ``vtx_dst``'s (both
    solvers move only the free ones), and reads its free coordinates.

    ``hessian(v, proj)`` gives the free-dof Hessian as CSR values (nnz,)
    over ``(rows, cols)``: K10's projected one, or minus the ANM Jacobian;
    ``hessian_diag_reg`` adds ``reg * I_12`` to every element block, that
    is ``reg`` times the vertex's element count to each diagonal entry,
    on the host."""

    def __init__(self, tets, rest_vtx, vtx_dst, bnd_mask, em, mat,
                 hessian_proj, hessian_diag_reg, device=None):
        mesh = TetrahedralMesh(rest_vtx, tets)
        body = DeformableBody(mat, mesh)
        body.coord_fixed_mask[:] = np.asarray(bnd_mask, bool).reshape(-1, 3)
        self.model = body.make_forward(em, vtx_dst, device=device)
        self.em, self.mat = em, mat
        self.proj = hessian_proj
        self.diag_reg = float(hessian_diag_reg)
        self.nV = mesh.nr_vertices
        self.free_flat = ~body.coord_fixed_mask.reshape(-1)
        asm = self.model.asm
        self.rows, self.cols = asm.csr_rowidx, asm.csr_cols
        self.n = asm.n
        self.indptr = np.zeros(asm.n + 1, np.int64)
        np.cumsum(np.bincount(self.rows, minlength=asm.n),
                  out=self.indptr[1:])
        if self.diag_reg:
            pos, row = diag_nnz_pos(self.rows, self.cols)
            deg = np.bincount(mesh.tets.reshape(-1), minlength=self.nV)
            vtx_of = self.model.lt_inp.vertex_loc[:, 0]
            self._reg = (pos, self.diag_reg * deg[vtx_of[row]])

    def _free(self, v):
        return np.asarray(v, np.float64).reshape(-1)[self.free_flat]

    def _gin(self, v):
        return self.model.asm.apply_in(self._free(v))

    def energy(self, v):
        """The elastic energy sum_e psi(F_e) vol_e at ``v``."""
        m = self.model
        F = m.elems.deformation_gradient(self._gin(v))
        return float((_psi(self.em, self.mat, F) * m.vols).sum())

    def forces(self, v):
        """-dE/dx on the free coordinates (n,), NumPy."""
        return self.model.eval_force(self._free(v))

    def hessian(self, v, proj):
        """The free-dof Hessian's CSR values (n nnz,) at ``v``, NumPy:
        K10's eigen-projected one with ``proj``, else the unprojected
        one; a non-finite projected Hessian (J <= 0) raises
        :class:`SANMNumericalError`."""
        gin = self._gin(v)
        with ScopedProfiler("newton_hess", block=True):
            if proj:
                data, E = self.model.hess_proj(gin)
                if not bool(torch.isfinite(E).all()):
                    # inverted elements (J <= 0) make log(J)/J^(-2/3) NaN;
                    # the reference baseline materials throw the same way
                    # (``baseline/neohookean_material.cpp:15-16,128-129``)
                    raise SANMNumericalError(
                        "non-finite element Hessian (J <= 0 in %s): the "
                        "Newton baseline, like the reference's, cannot "
                        "start from a configuration with inverted elements"
                        % self.em
                    )
            else:
                data = self.model.jac_asm(gin)[0]
            h = -data.cpu().numpy()
        if self.diag_reg:
            pos, add = self._reg
            h[pos] += add
        return h


_SPARSE_THRESHOLD = 3000  # dofs beyond which scipy.sparse is used


def _assemble_hessian(kern: _Kernels, data):
    """The free-dof Hessian from its CSR values: a dense ndarray for
    small systems (3V <= :data:`_SPARSE_THRESHOLD`), else a SciPy CSR
    matrix (the reference always uses sparse PARDISO; we pick by
    size)."""
    n = kern.n
    if 3 * kern.nV <= _SPARSE_THRESHOLD:
        H = np.zeros((n, n))
        H[kern.rows, kern.cols] = data
        return H
    import scipy.sparse as sp

    return sp.csr_matrix((data, kern.cols, kern.indptr), shape=(n, n))


def _solve_dense(H, rhs, spd):
    import scipy.linalg as sla
    import scipy.sparse as sp

    with ScopedProfiler("newton_solve"):
        if sp.issparse(H):
            import scipy.sparse.linalg as spla

            return spla.splu(H.tocsc()).solve(rhs)
        if spd:
            try:
                c = sla.cho_factor(H)
                return sla.cho_solve(c, rhs)
            except np.linalg.LinAlgError:
                pass
        return sla.solve(H, rhs)


def check_hessian_fd(kern: _Kernels, vtx, eps=1e-6, samples=8, seed=0):
    """Finite-difference validation of the (unprojected) free-dof Hessian
    against the force: H u ~= -(f(v+eps u) - f(v-eps u))/(2 eps).

    Counterpart of the reference's env-gated FD Hessian checker
    (``fea/baseline/hcheck.cpp:6-77``, enabled by FEA_CHECK,
    ``baseline/main.cpp:130-146``)."""
    import scipy.sparse as sp

    vtx = np.asarray(vtx, np.float64)
    H = sp.csr_matrix((kern.hessian(vtx, False), kern.cols, kern.indptr),
                      shape=(kern.n, kern.n))
    rng = np.random.default_rng(seed)
    worst = 0.0
    for _ in range(samples):
        u = rng.standard_normal(kern.n)
        u /= np.linalg.norm(u)
        vp, vm = vtx.copy(), vtx.copy()
        vp.reshape(-1)[kern.free_flat] += eps * u
        vm.reshape(-1)[kern.free_flat] -= eps * u
        fd = -(kern.forces(vp) - kern.forces(vm)) / (2 * eps)
        hu = H @ u
        err = np.linalg.norm(fd - hu) / max(np.linalg.norm(hu), 1e-30)
        worst = max(worst, err)
    if worst > 1e-4:
        raise SANMError("FD Hessian check failed: rel err %g" % worst)
    return worst


def solve_energy_min(
    elements,
    vtx_init,
    vtx_dst,
    f_ext,
    bnd_mask,
    material_desc,
    gtol_refine,
    iter_callback=None,
    hessian_proj=True,
    hessian_diag_reg=0.0,
    device=None,
) -> BaselineStat:
    """Projected Newton with backtracking line search + unprojected
    refinement (reference ``baseline::solve_energy_min``,
    ``baseline/main.cpp:228-390``), from ``vtx_dst`` (its fixed
    coordinates stay) on the rest mesh ``vtx_init``, on ``device``
    (default: the card)."""
    em, mat = material_desc
    vtx_init = np.asarray(vtx_init, np.float64)
    nV = vtx_init.shape[0]
    kern = _Kernels(elements, vtx_init, vtx_dst, bnd_mask, em, mat,
                    hessian_proj, hessian_diag_reg, device)
    free_flat = kern.free_flat
    f_ext_flat = (
        None if f_ext is None else np.asarray(f_ext).reshape(-1)
    )

    def total_energy(v):
        e = kern.energy(v)
        if f_ext_flat is not None:
            e += float(
                (vtx_init.reshape(-1) - v.reshape(-1)) @ f_ext_flat
            )
        return e

    def grad_free(v):
        """force (= -dE/dx) on free coords."""
        f = kern.forces(v)
        if f_ext_flat is not None:
            f = f + f_ext_flat[free_flat]
        return f

    def hess_free(v, proj):
        return _assemble_hessian(kern, kern.hessian(v, proj))

    if os.environ.get("FEA_CHECK"):
        # FD Hessian validation, gated like the reference
        # (baseline/main.cpp:130-146)
        err = check_hessian_fd(kern, np.asarray(vtx_dst, np.float64))
        print("FEA_CHECK hessian FD rel err: %g" % err)

    vertices = np.asarray(vtx_dst, np.float64).reshape(nV, 3).copy()
    stat = BaselineStat()
    timer = Timer().start()
    newton_timer = Timer()
    gtol, xtol, ls_c1 = 1e-6, 1e-6, 0.2

    while True:
        grad = grad_free(vertices)
        H = hess_free(vertices, hessian_proj)
        stat.nr_iter += 1
        newton_timer.start()
        u = _solve_dense(H, grad, spd=hessian_proj)
        step = 1.0
        energy = total_energy(vertices)
        c1_g_p = -ls_c1 * float(u @ grad)
        dx_base = float(np.linalg.norm(u)) / (
            float(np.linalg.norm(vertices)) + 1.0
        )
        if hessian_proj:
            sanm_assert(c1_g_p < 0, "not a descent direction")
        else:
            c1_g_p = min(c1_g_p, 0.0)
        new_vertices = vertices
        while True:
            new_vertices = vertices.copy()
            nv = new_vertices.reshape(-1)
            nv[free_flat] += u * step
            new_energy = total_energy(new_vertices)
            if new_energy < energy + step * c1_g_p:
                break
            step /= 2
            if dx_base * step < xtol:
                new_vertices = vertices
                new_energy = energy
                break
        newton_timer.stop()
        stat.tot_newton_time = newton_timer.time()
        grad_rms = float(np.sqrt(np.mean(grad * grad)))
        df = (energy - new_energy) / (new_energy + 1)
        dx = dx_base * step
        vertices = new_vertices
        if iter_callback and not iter_callback(vertices):
            break
        if grad_rms < gtol or dx < xtol:
            stat.df = df
            stat.dx = dx
            stat.grad_rms = grad_rms
            stat.energy = energy
            break

    if stat.grad_rms > gtol_refine:
        # unprojected Newton refinement (baseline/main.cpp:355-388)
        while True:
            grad = grad_free(vertices)
            grad_rms = float(np.sqrt(np.mean(grad * grad)))
            if grad_rms < gtol_refine or stat.nr_iter_refine >= 20:
                stat.grad_rms_refine = grad_rms
                break
            H = hess_free(vertices, False)
            stat.nr_iter += 1
            stat.nr_iter_refine += 1
            newton_timer.start()
            u = _solve_dense(H, grad, spd=False)
            v = vertices.reshape(-1)
            v[free_flat] += u
            newton_timer.stop()
            stat.tot_newton_time = newton_timer.time()
            if iter_callback and not iter_callback(vertices):
                break

    stat.tot_time = timer.stop().time()
    stat.vtx = vertices
    return stat


def solve_force_equ_levmar(
    elements,
    vtx_init,
    f_ext,
    bnd_mask,
    material_desc,
    gtol,
    iter_callback=None,
    hessian_diag_reg=0.0,
    device=None,
) -> BaselineStat:
    """Levenberg-Marquardt on the force residual (reference
    ``baseline::solve_force_equ_levmar``, ``baseline/main.cpp:392-510``):
    solve (H^T H with damped diagonal) delta = H^T f, adaptive damping,
    on ``device`` (default: the card)."""
    em, mat = material_desc
    vtx_init = np.asarray(vtx_init, np.float64)
    kern = _Kernels(elements, vtx_init, vtx_init, bnd_mask, em, mat, False,
                    hessian_diag_reg, device)
    free_flat = kern.free_flat
    f_ext_flat = np.asarray(f_ext).reshape(-1)[free_flat]

    def force_free(v):
        return kern.forces(v) + f_ext_flat

    def hess_free(v):
        return _assemble_hessian(kern, kern.hessian(v, False))

    vertices = vtx_init.copy()
    stat = BaselineStat()
    timer = Timer().start()
    newton_timer = Timer()
    damp = 1e-4
    damp_k = 10.0
    damp_min = np.finfo(np.float64).eps
    max_iters = 1000

    import scipy.linalg as sla
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    while True:
        stat.nr_iter += 1
        force = force_free(vertices)
        H = hess_free(vertices)
        newton_timer.start()
        energy = float(np.sqrt(np.mean(force * force)))
        # Above _SPARSE_THRESHOLD dofs _assemble_hessian returns CSR; the
        # damped normal equations then stay sparse end-to-end (the
        # reference always solves them with PardisoLLT on the sparse A'A,
        # baseline/main.cpp:186-220,392-510).
        sparse = sp.issparse(H)
        HtH = (H.T @ H).tocsr() if sparse else H.T @ H
        rhs = H.T @ force
        diag = HtH.diagonal().copy() if sparse else np.diag(HtH).copy()
        search_cnt = 0
        while True:
            search_cnt += 1
            damped = HtH.copy()
            if sparse:
                damped.setdiag(diag * (1 + damp))
                try:
                    with ScopedProfiler("newton_solve"):
                        delta = spla.splu(damped.tocsc()).solve(rhs)
                except RuntimeError:
                    # singular damped normal matrix: treat like a
                    # rejected trial step so the damping search raises
                    # damp (the dense branch's LinAlgError analog)
                    damp *= damp_k
                    if search_cnt >= 50:
                        stat.grad_rms = energy
                        stat.dx = -1
                        stat.tot_time = timer.stop().time()
                        stat.vtx = vertices
                        return stat
                    continue
            else:
                np.fill_diagonal(damped, diag * (1 + damp))
                try:
                    delta = sla.solve(damped, rhs, assume_a="pos")
                except np.linalg.LinAlgError:
                    delta = sla.solve(damped, rhs)
            new_vertices = vertices.copy()
            nv = new_vertices.reshape(-1)
            nv[free_flat] += delta
            try:
                nf = force_free(new_vertices)
                new_energy = float(np.sqrt(np.mean(nf * nf)))
                if not np.isfinite(new_energy):
                    new_energy = energy * 1.1
            except FloatingPointError:
                new_energy = energy * 1.1
            if new_energy < energy:
                damp = max(damp / damp_k, damp_min)
                break
            damp *= damp_k
            if search_cnt >= 50:
                stat.grad_rms = energy
                stat.dx = -1
                stat.tot_time = timer.stop().time()
                stat.vtx = vertices
                return stat
        newton_timer.stop()
        stat.tot_newton_time = newton_timer.time()
        dx = float(np.linalg.norm(delta)) / (
            float(np.linalg.norm(new_vertices)) + 1.0
        )
        vertices = new_vertices
        energy = new_energy
        if iter_callback and not iter_callback(vertices):
            break
        if energy < gtol or stat.nr_iter >= max_iters:
            stat.dx = dx
            stat.grad_rms = energy
            break

    stat.tot_time = timer.stop().time()
    stat.vtx = vertices
    return stat


def run_from_config(config, deformable, f_load_full, thresh,
                    device=None) -> BaselineStat:
    """Dispatch per the ``baseline`` config section (reference
    ``setup_baseline`` + the baseline branch of ``run_and_save``,
    ``fea/main.cpp:123-133,343-379``)."""
    bc = config["baseline"]
    proj = not bc.get("hessian_no_proj", False)
    reg = float(bc.get("hessian_diag", 0.0))
    desc = material_desc_from_config(config)
    print(": using baseline: proj=%d reg=%g" % (proj, reg))
    if bc.get("use_levmar", False):
        print("opt: levmar")
        return solve_force_equ_levmar(
            deformable.mesh.tets,
            deformable.mesh.vertices,
            f_load_full,
            deformable.coord_fixed_mask,
            desc,
            thresh,
            hessian_diag_reg=reg,
            device=device,
        )
    return solve_energy_min(
        deformable.mesh.tets,
        deformable.mesh.vertices,
        deformable.mesh.vertices,
        f_load_full,
        deformable.coord_fixed_mask,
        desc,
        thresh,
        hessian_proj=proj,
        hessian_diag_reg=reg,
        device=device,
    )
