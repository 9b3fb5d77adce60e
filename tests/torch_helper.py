"""Shared set-up of the parity tests between sanm_tpu (JAX) and
sanm_tpu_torch: one small cuboid model (NHC unless a test asks for another
material) built by each package from the same NumPy inputs."""

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


def jax_model(fz=-200.0, energy_model=None, inverse=False):
    """The JAX package's forward model (NHC unless ``energy_model`` names
    another; the inverse model with ``inverse``), its assembler plan and
    load."""
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
    em = energy_model or EnergyModel.NEOHOOKEAN_C
    model = body.make_inverse(em) if inverse else body.make_forward(em)
    T = mesh.nr_tet
    n = model.x0().size
    plan = SparseAssembler(model.lt_out.remap, model.lt_inp.remap, T, 9, 9,
                           n)
    f_sub = model.lt_inp.copy_vtx_values(
        cuboid_load(mesh, c["nx"], c["spacing"], fz))
    return body, model, plan, f_sub


def port_state(body, model, plan, f_sub, inverse=False):
    """The port's state fed from the JAX side's host arrays (of an inverse
    model with ``inverse``: Ds in place of Dm^-1)."""
    from sanm_tpu_torch.convert import state_from_numpy

    mat = body.material
    shape = body.mesh.shape_matrix
    return state_from_numpy(
        vertices=body.mesh.vertices, tets=body.mesh.tets,
        fixed_mask=body.coord_fixed_mask,
        **({"ds": shape} if inverse
           else {"dm_inv": np.linalg.inv(shape)}),
        bias=model.lt_inp.bias, x0=model.x0(), f_load_sub=f_sub,
        Lin=plan._Lin, Lout=plan._Lout, loc_rows=plan._loc_rows,
        loc_cols=plan._loc_cols, slot_pos=plan.slot_pos,
        csr_rowidx=plan.csr_rowidx, csr_cols=plan.csr_cols,
        mu=mat.shear_modulus, lam=mat.lame_first,
        kappa=mat.bulk_modulus, device="cpu",
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


def random_sparse_spd(n, half_bw, rng, density=0.3):
    """The random system of ``tests/test_band.py:_random_sparse_spd``:
    -A for an SPD A with entries only inside |i-j| <= half_bw, in a
    scrambled ordering (so the band plan's RCM has real work); CSR."""
    import scipy.sparse as sp

    rows, cols, vals = [], [], []
    for i in range(n):
        for j in range(max(0, i - half_bw), i):
            if rng.uniform() < density:
                v = rng.standard_normal() * 0.3
                rows += [i, j]
                cols += [j, i]
                vals += [v, v]
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    d = np.abs(A).sum(axis=1).A1 + rng.uniform(1.0, 2.0, n)
    A = A + sp.diags(d)
    p = rng.permutation(n)
    A = A[p][:, p].tocoo()
    return -sp.csr_matrix((A.data, (A.row, A.col)), shape=(n, n))


def ragged_spd(sizes, half_bws, rng):
    """A block-diagonal system of :func:`random_sparse_spd` components,
    scrambled by one permutation; CSR.  Components whose sizes are
    multiples of the band's block size keep to their own block columns
    after the plan's RCM, so the skyline reach is ragged and the last
    column of each component reaches nothing (w_j = 0)."""
    import scipy.sparse as sp

    A = sp.block_diag([random_sparse_spd(m, h, rng)
                       for m, h in zip(sizes, half_bws)]).tocsr()
    p = rng.permutation(A.shape[0])
    return A[p][:, p].tocsr()


def coo_of(A):
    """``(rows, cols, vals)`` of a CSR matrix in COO order (int32 indices),
    as ``tests/test_band.py``'s stub assembler holds them."""
    coo = A.tocoo()
    return (coo.row.astype(np.int32), coo.col.astype(np.int32),
            coo.data.copy())


def torch_matvec(rows, cols, vals, n):
    """x -> A x for COO arrays, in torch on the device of ``vals``."""
    import torch

    r = torch.as_tensor(rows, dtype=torch.int64, device=vals.device)
    c = torch.as_tensor(cols, dtype=torch.int64, device=vals.device)

    def mv(x):
        out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
        return out.index_add_(0, r, vals * x[c])

    return mv
