"""Shared set-up of the parity tests between sanm_tpu (JAX) and
sanm_tpu_torch: one small NHC cuboid model built by each package from the
same NumPy inputs."""

import numpy as np

MATERIAL = dict(E=1e7, nu=0.45)
CUBOID = dict(nx=6, ny=4, nz=4, spacing=0.025)  # 225 tets


def rel_err(a, b):
    """max |a - b| / max |b| (0 when both are zero)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    s = np.abs(b).max()
    d = np.abs(a - b).max()
    return d / s if s > 0 else d


def cuboid_load(mesh, nx, spacing, fz=-200.0):
    f = np.zeros((mesh.nr_vertices, 3))
    f[mesh.vertices[:, 0] > (nx - 1) * spacing - spacing / 2, 2] = fz
    return f


def jax_model(fz=-200.0):
    """The JAX package's forward NHC model, its assembler plan and load."""
    from sanm_tpu.fea import (DeformableBody, EnergyModel, MaterialProperty,
                              TetrahedralMesh)
    from sanm_tpu.solver.remap import SparseAssembler

    c = CUBOID
    mesh = TetrahedralMesh.make_cuboid(c["nx"], c["ny"], c["nz"],
                                       c["spacing"])
    body = DeformableBody(
        MaterialProperty.from_young_poisson(MATERIAL["E"], MATERIAL["nu"]),
        mesh)
    body.coord_fixed_mask[mesh.vertices[:, 0] <= c["spacing"] / 2, :] = True
    model = body.make_forward(EnergyModel.NEOHOOKEAN_C)
    T = mesh.nr_tet
    n = model.x0().size
    plan = SparseAssembler(model.lt_out.remap, model.lt_inp.remap, T, 9, 9,
                           n)
    f_sub = model.lt_inp.copy_vtx_values(
        cuboid_load(mesh, c["nx"], c["spacing"], fz))
    return body, model, plan, f_sub


def port_state(body, model, plan, f_sub):
    """The port's state fed from the JAX side's host arrays."""
    from sanm_tpu_torch.convert import state_from_numpy

    mat = body.material
    return state_from_numpy(
        vertices=body.mesh.vertices, tets=body.mesh.tets,
        fixed_mask=body.coord_fixed_mask,
        dm_inv=np.linalg.inv(body.mesh.shape_matrix),
        bias=model.lt_inp.bias, x0=model.x0(), f_load_sub=f_sub,
        Lin=plan._Lin, Lout=plan._Lout, loc_rows=plan._loc_rows,
        loc_cols=plan._loc_cols, slot_pos=plan.slot_pos,
        csr_rowidx=plan.csr_rowidx, csr_cols=plan.csr_cols,
        mu=mat.shear_modulus, lam=mat.lame_first, device="cpu",
    )


def write_tetgen(mesh, base):
    """Write a mesh as tetgen .node/.ele/.face files."""
    with open(base + ".node", "w") as f:
        f.write("%d 3 0 0\n" % mesh.nr_vertices)
        for i, v in enumerate(mesh.vertices):
            f.write("%d %.17g %.17g %.17g\n" % (i, *v))
    with open(base + ".ele", "w") as f:
        f.write("%d 4 0\n" % mesh.nr_tet)
        for i, t in enumerate(mesh.tets):
            f.write("%d %d %d %d %d\n" % (i, *t))
    with open(base + ".face", "w") as f:
        f.write("%d 1\n" % len(mesh.surfaces))
        for i, t in enumerate(mesh.surfaces):
            f.write("%d %d %d %d -1 # face\n" % (i, *t))
