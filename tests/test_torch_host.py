"""The port's host (NumPy) modules against the JAX package's.

Mesh arrays, the shape-matrix and force-output remaps, the assembler
plan, ``polynomial`` and ``pade`` of ``sanm_tpu_torch`` must equal those
of ``sanm_tpu`` on the same inputs: integer arrays exactly, float arrays
to 1e-15 relative (in fact the port computes them with the same
operations, so they are bitwise equal)."""

import numpy as np
import pytest

import sanm_tpu.fea.mesh as jmesh
import sanm_tpu.fea.remap as jremap
import sanm_tpu.pade as jpade
import sanm_tpu.polynomial as jpoly
import sanm_tpu.solver.remap as jsremap
import sanm_tpu_torch.fea.mesh as pmesh
import sanm_tpu_torch.fea.remap as premap
import sanm_tpu_torch.pade as ppade
import sanm_tpu_torch.polynomial as ppoly
import sanm_tpu_torch.solver.remap as psremap
from torch_helper import CUBOID, rel_err, write_tetgen

FTOL = 1e-15


def feq(a, b, tol=FTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert rel_err(a, b) <= tol


def ieq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(a, b)


def padded_eq(r_port, r_jax):
    """Two padded remaps are equal up to trailing all-dead columns (the
    JAX package's native builder pads the shape remap to width 3)."""
    w = max(r_port.idx.shape[1], r_jax._np_idx.shape[1])

    def pad(a):
        return np.pad(np.asarray(a), ((0, 0), (0, w - a.shape[1])))

    ic, cc = pad(r_port.idx), pad(r_port.coef)
    ij, cj = pad(r_jax._np_idx), pad(r_jax._np_coef)
    ieq(np.where(cc != 0, ic, 0), np.where(cj != 0, ij, 0))
    feq(cc, cj)
    assert r_port.inp_size == r_jax.inp_size
    assert r_port.out_shape == r_jax.out_shape


def meshes(kind, tmp_path):
    c = CUBOID
    jm = jmesh.TetrahedralMesh.make_cuboid(c["nx"], c["ny"], c["nz"],
                                           c["spacing"])
    pm = pmesh.TetrahedralMesh.make_cuboid(c["nx"], c["ny"], c["nz"],
                                           c["spacing"])
    if kind == "tetgen":
        base = str(tmp_path / "box")
        write_tetgen(jm, base)
        jm = jmesh.TetrahedralMesh.from_tetgen_files(base)
        pm = pmesh.TetrahedralMesh.from_tetgen_files(base)
    return jm, pm


def fixed_masks(jm):
    yield np.zeros((jm.nr_vertices, 3), bool)
    m = np.zeros((jm.nr_vertices, 3), bool)
    m[jm.vertices[:, 0] <= CUBOID["spacing"] / 2] = True
    yield m
    rng = np.random.default_rng(7)
    yield rng.random((jm.nr_vertices, 3)) < 0.3


@pytest.mark.parametrize("kind", ["cuboid", "tetgen"])
def test_mesh_arrays(kind, tmp_path):
    jm, pm = meshes(kind, tmp_path)
    feq(pm.vertices, jm.vertices)
    ieq(pm.tets, jm.tets)
    assert pm.surface_vtx == jm.surface_vtx
    assert pm.surfaces == jm.surfaces
    feq(pm.shape_matrix, jm.shape_matrix)
    feq(pm.tet_volumes, jm.tet_volumes)
    feq(pm.vertex_norms, jm.vertex_norms)
    jm.resize_inplace(1e-3)
    pm.resize_inplace(1e-3)
    feq(pm.vertex_norms, jm.vertex_norms)


def test_write_obj_equal(tmp_path):
    jm, pm = meshes("cuboid", tmp_path)
    jm.write_obj(str(tmp_path / "j.obj"))
    pm.write_obj(str(tmp_path / "p.obj"))
    sel = set(range(0, jm.nr_vertices, 2))
    jm.write_obj(str(tmp_path / "jf.obj"), sel)
    pm.write_obj(str(tmp_path / "pf.obj"), sel)
    for a, b in (("j", "p"), ("jf", "pf")):
        assert (tmp_path / (a + ".obj")).read_text() == (
            tmp_path / (b + ".obj")).read_text()


@pytest.mark.parametrize("mask_id", [0, 1, 2])
def test_shape_and_force_remaps(mask_id, tmp_path):
    jm, pm = meshes("cuboid", tmp_path)
    fixed = list(fixed_masks(jm))[mask_id]
    js = jremap.ShapeMatRemap(jm, fixed)
    ps = premap.ShapeMatRemap(pm, fixed)
    ieq(ps.vtx2uidx, js.vtx2uidx)
    ieq(ps.vertex_loc, js.vertex_loc)
    feq(ps.x0, js.x0)
    feq(ps.bias, js.bias)
    padded_eq(ps.remap, js.remap)
    jf = jremap.ForceOutputRemap(js)
    pf = premap.ForceOutputRemap(ps)
    padded_eq(pf.remap, jf.remap)
    ti_p, tc_p = pf.remap.transposed_padded()
    ti_j, tc_j = jf.remap.transposed_padded()
    ieq(ti_p, ti_j)
    feq(tc_p, tc_j)
    # the remap rebuilds the mesh's shape matrices at x0
    ds = ps.remap.apply_np(ps.x0) + ps.bias
    feq(ds, pm.shape_matrix, 1e-12)


@pytest.mark.parametrize("mask_id", [1, 2])
def test_assembler_plan(mask_id, tmp_path):
    jm, pm = meshes("cuboid", tmp_path)
    fixed = list(fixed_masks(jm))[mask_id]
    js = jremap.ShapeMatRemap(jm, fixed)
    ps = premap.ShapeMatRemap(pm, fixed)
    jf = jremap.ForceOutputRemap(js)
    pf = premap.ForceOutputRemap(ps)
    n, T = ps.n_unknown_vtx, pm.nr_tet
    ja = jsremap.SparseAssembler(jf.remap, js.remap, T, 9, 9, n)
    pa = psremap.SparseAssembler(pf.remap, ps.remap, T, 9, 9, n)
    assert (pa.Din, pa.Dout, pa.nnz, pa.has_t) == (
        ja.Din, ja.Dout, ja.nnz, ja.has_t)
    feq(pa.Lin, ja._Lin)
    feq(pa.Lout, ja._Lout)
    ieq(pa.loc_rows, ja._loc_rows)
    ieq(pa.loc_cols, ja._loc_cols)
    ieq(pa.slot_pos, ja.slot_pos)
    ieq(pa.csr_rowidx, ja.csr_rowidx)
    ieq(pa.csr_cols, ja.csr_cols)
    # the inverse maps reproduce both scatter-adds in gather form
    row_ptr, row_ent, nz_ptr, nz_slot = psremap.inverse_maps(
        pa.loc_rows, pa.n_rows, pa.slot_pos, pa.nnz)
    rng = np.random.default_rng(1)
    vals = rng.standard_normal(pa.loc_rows.size)
    ref = np.zeros(pa.n_rows + 1)
    np.add.at(ref, pa.loc_rows.reshape(-1), vals)
    got = np.array([vals[row_ent[row_ptr[r]:row_ptr[r + 1]]].sum()
                    for r in range(pa.n_rows)])
    feq(got, ref[:-1], 1e-14)
    slots = rng.standard_normal(pa.slot_pos.size)
    ref = np.zeros(pa.nnz + 1)
    np.add.at(ref, pa.slot_pos, slots)
    got = np.add.reduceat(slots[nz_slot], nz_ptr[:-1])
    feq(got, ref[:-1], 1e-14)
    assert np.all(np.diff(nz_ptr) > 0)


def test_polynomial_equal():
    rng = np.random.default_rng(3)
    c = rng.standard_normal(21) * 0.5 ** np.arange(21)
    c[1] = abs(c[1]) + 0.5
    for x in (0.0, 0.3, -1.2, 2.5):
        assert ppoly.eval_poly(c, x) == jpoly.eval_poly(c, x)
    arr = rng.standard_normal((21, 7))
    ieq(ppoly.eval_tensor_poly(arr, 0.7), jpoly.eval_tensor_poly(arr, 0.7))
    for order in (2, 8, 16, 20):
        assert ppoly.stable_x_range(order) == jpoly.stable_x_range(order)
    t = ppoly.eval_poly(c, 0.4)
    assert ppoly.solve_eqn(c, 0.0, 1.0, t) == jpoly.solve_eqn(c, 0.0, 1.0, t)


@pytest.mark.parametrize("anm_cond", [True, False])
def test_pade_equal(anm_cond):
    rng = np.random.default_rng(5)
    N, dim = 20, 9
    xs = rng.standard_normal((N + 1, dim)) * (0.7 ** np.arange(N + 1))[:, None]
    xs[:, -1] = np.abs(xs[:, -1]) + 0.1
    if anm_cond:  # x_i . x_1 = 0 for i >= 2, |x_1| = 1
        xs[1] /= np.linalg.norm(xs[1])
        xs[2:] -= np.outer(xs[2:] @ xs[1], xs[1])
    pp = ppade.PadeApproximation(xs, anm_cond=anm_cond)
    jp = jpade.PadeApproximation(xs, anm_cond=anm_cond)
    assert pp.ok == jp.ok
    assert pp.reject_reason == jp.reject_reason
    if pp.ok:
        for a in (0.1, 0.5, 1.0):
            ieq(pp.eval_xt(a), jp.eval_xt(a))
        okp = pp.estimate_valid_range(0.5, 1e-6, 5.0)
        okj = jp.estimate_valid_range(0.5, 1e-6, 5.0)
        assert okp == okj
        if okp:
            assert pp.t_max_a == jp.t_max_a and pp.t_max == jp.t_max
