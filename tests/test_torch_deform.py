"""The deform slice of the port against the JAX package, on the CPU:
the delta remap, the t column of the assembly plan (K3t's plain
version), the implicit continuation and the ``mesh_twist`` /
``test_cuboid_twist`` / ``test_cuboid`` tasks.

Both packages get the same inputs, made with NumPy from a seed: the
225-tet cuboid of ``tests/torch_helper.py`` with its x = 0 face fixed and
its far face fixed and moved by a random displacement (``face``).  An
element that reads t then has a moved, hence fixed, vertex, so the plan
keeps Din = 12 columns; a second case (``all``) also gives the free
vertices a delta, which the remap takes as well, so that elements with
four free vertices read t too and Din = 13.  Tolerances:

* the delta remap 1e-15 absolute (the same products of coefficients 0,
  +-1 and the delta differences, summed in another order);
* the plan's integer arrays: equal;
* ``(data, grad_t, E)`` of the plain Jacobians 1e-12 relative (closed
  form against JAX's forward-mode ``batched_jacobian``);
* the implicit expansions 1e-9 relative over restarts 1 and 2 (f64
  solves of the same systems; the start point of restart 2 carries the
  first restart's rounding through the series and Pade);
* the tasks: the same restarts, force-RMS <= 1e-10 (the paper's
  target), no inverted element, the relative displacement within 1e-9
  relative of the JAX package's, coordinates within 1e-9 of the largest.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_arap import CONFIGS, _port_cli
from torch_helper import CUBOID, MATERIAL, rel_err

RMS = 1e-10
COORD_RTOL = 1e-9
JAC_TOL = 1e-12
SERIES_RTOL = 1e-9
ORDER = 20
MATERIALS = ("neohookean_c", "neohookean_i", "arap")


@functools.lru_cache(maxsize=None)
def deform_bodies(where="face", seed=7):
    """The cuboid in both packages: the x = 0 face fixed, the far face
    fixed and moved by a 90 degree twist about the x axis plus a random
    part of up to 0.05 x the spacing per coordinate (``where="all"``:
    the free vertices get a random delta of up to 0.1 x the spacing
    too); a random interior perturbation as the start coordinates.
    Returns ``(jax_body, port_body, init, delta)``."""
    from sanm_tpu import fea as jfea
    from sanm_tpu_torch import fea as pfea

    c = CUBOID
    h = c["spacing"]
    bodies = []
    for fea in (jfea, pfea):
        mesh = fea.TetrahedralMesh.make_cuboid(c["nx"], c["ny"], c["nz"], h)
        body = fea.DeformableBody(
            fea.MaterialProperty.from_young_poisson(MATERIAL["E"],
                                                    MATERIAL["nu"]), mesh)
        vx = mesh.vertices[:, 0]
        body.coord_fixed_mask[(vx <= h / 2) | (vx >= (c["nx"] - 1.5) * h),
                              :] = True
        bodies.append(body)
    rng = np.random.default_rng(seed)
    verts = bodies[0].mesh.vertices
    moved = verts[:, 0] >= (c["nx"] - 1.5) * h
    face = verts[moved]
    mid = face.mean(0)
    twist = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])
    delta = np.zeros_like(verts)
    delta[moved] = ((face - mid) @ twist.T + mid - face
                    + rng.uniform(-0.05, 0.05, face.shape) * h)
    if where == "all":
        delta[~moved] = rng.uniform(-0.1, 0.1, ((~moved).sum(), 3)) * h
    init = verts.copy()
    free = ~bodies[0].coord_fixed_mask[:, 0]
    init[free] += rng.uniform(-0.02, 0.02, (free.sum(), 3)) * h
    return bodies[0], bodies[1], init, delta


@pytest.fixture(params=["face", "all"])
def bodies(request):
    return deform_bodies(request.param)


def test_delta_remap_matches_jax(bodies):
    from sanm_tpu.fea.remap import ShapeMatRemap as JaxRemap
    from sanm_tpu_torch.fea.remap import ShapeMatRemap

    jb, pb, init, delta = bodies
    js = JaxRemap(jb.mesh, jb.coord_fixed_mask, init, delta)
    ps = ShapeMatRemap(pb.mesh, pb.coord_fixed_mask, init, delta)
    n = ps.n_unknown_vtx
    assert n == js.n_unknown_vtx and ps.has_delta
    assert ps.remap.inp_size == js.remap.inp_size == n + 1
    assert np.abs(ps.bias - js.bias).max() <= 1e-15
    assert np.array_equal(ps.x0, js.x0)
    rng = np.random.default_rng(11)
    for _ in range(3):
        xt = rng.standard_normal(n + 1)
        got = ps.remap.apply_np(xt)
        want = np.asarray(js.remap.apply_np(xt))
        assert np.abs(got - want).max() <= 1e-15
    # the entries whose vertices' deltas differ read t, and only those
    t_rows = ((ps.remap.idx == n) & (ps.remap.coef != 0)).any(axis=1)
    tets = pb.mesh.tets
    dt = (np.transpose(delta[tets[:, 1:]], (0, 2, 1))
          - delta[tets[:, 0]][:, :, None])
    assert t_rows.any() and np.array_equal(t_rows, (dt != 0).reshape(-1))


def test_t_column_plan_matches_jax(bodies):
    from sanm_tpu.fea.remap import ForceOutputRemap as JaxOut
    from sanm_tpu.fea.remap import ShapeMatRemap as JaxRemap
    from sanm_tpu.solver.remap import SparseAssembler as JaxPlan
    from sanm_tpu_torch.fea.remap import ForceOutputRemap, ShapeMatRemap
    from sanm_tpu_torch.solver.remap import SparseAssembler, gather_map

    jb, pb, init, delta = bodies
    js = JaxRemap(jb.mesh, jb.coord_fixed_mask, init, delta)
    ps = ShapeMatRemap(pb.mesh, pb.coord_fixed_mask, init, delta)
    n, T = ps.n_unknown_vtx, pb.mesh.nr_tet
    ja = JaxPlan(JaxOut(js).remap, js.remap, T, 9, 9, n)
    pa = SparseAssembler(ForceOutputRemap(ps).remap, ps.remap, T, 9, 9, n)
    assert pa.has_t and ja.has_t
    assert (pa.Din, pa.Dout, pa.nnz) == (ja.Din, ja.Dout, ja.nnz)
    free = ~pb.coord_fixed_mask[:, 0]
    assert pa.Din == (13 if delta[free].any() else 12)
    for mine, theirs in ((pa.loc_rows, ja._loc_rows),
                         (pa.loc_cols, ja._loc_cols),
                         (pa.csr_rowidx, ja.csr_rowidx),
                         (pa.csr_cols, ja.csr_cols),
                         (pa.slot_pos, ja.slot_pos),
                         (pa.t_slot_row, ja.t_slot_row)):
        assert mine.dtype == theirs.dtype
        assert np.array_equal(mine, theirs)
    assert np.abs(pa.Lin - ja._Lin).max() <= 1e-15
    # t slots land in the dump slot of the CSR values, never in data
    is_t = pa.t_slot_row < pa.n_rows
    assert is_t.any() and (pa.slot_pos[is_t] == pa.nnz).all()
    # the gather map sums each row's t slots in ascending order
    t_ptr, t_slot = gather_map(pa.t_slot_row, pa.n_rows)
    vals = np.random.default_rng(2).standard_normal(pa.t_slot_row.size)
    ref = np.zeros(pa.n_rows + 1)
    np.add.at(ref, pa.t_slot_row, vals)
    got = np.array([vals[t_slot[t_ptr[r]:t_ptr[r + 1]]].sum()
                    for r in range(pa.n_rows)])
    assert np.abs(got - ref[:-1]).max() <= 1e-13
    assert all((np.diff(t_slot[t_ptr[r]:t_ptr[r + 1]]) > 0).all()
               for r in range(pa.n_rows))


def models(bodies, name):
    """The JAX and port forward models with the t column, and the JAX
    plan."""
    from sanm_tpu.fea import EnergyModel as JaxEM
    from sanm_tpu.solver.remap import SparseAssembler as JaxPlan
    from sanm_tpu_torch.fea import EnergyModel

    jb, pb, init, delta = bodies
    jm = jb.make_forward(JaxEM.from_name(name), init, delta)
    pm = pb.make_forward(EnergyModel.from_name(name), init, delta,
                         device="cpu")
    T = jb.mesh.nr_tet
    plan = JaxPlan(jm.lt_out.remap, jm.lt_inp.remap, T, 9, 9,
                   jm.x0().size)
    return jm, pm, plan


@pytest.mark.parametrize("name", MATERIALS)
def test_jac_asm_with_t_matches_jax(bodies, name):
    """``(data, grad_t, E)`` of the port's plain K3 / K3n / K8c + K3t at a
    start point with t0 = 0.37 against JAX's ``assemble_csr_elem`` of
    ``batched_jacobian``."""
    from sanm_tpu.taylor import TaylorFn, batched_jacobian

    jm, pm, plan = models(bodies, name)
    T = pm.asm.B
    xt0 = np.concatenate([pm.x0(), [0.37]])
    tfn = TaylorFn(jm.fn, jax.ShapeDtypeStruct((T, 3, 3), jnp.float64))
    J = batched_jacobian(lambda g: tfn(g), jm.lt_inp.remap.apply(
        jnp.asarray(xt0)))
    data_j, gt_j, E_j = plan.assemble_csr_elem(J)
    data, gt, E = pm.jac_asm(pm.asm.apply_in(xt0))
    assert gt is not None and gt_j is not None
    assert gt.shape == (pm.asm.n_rows,) and E.shape == E_j.shape
    assert float(np.abs(np.asarray(gt_j)).max()) > 0
    for mine, theirs in ((data, data_j), (gt, gt_j), (E, E_j)):
        assert rel_err(mine.numpy(), np.asarray(theirs)) <= JAC_TOL


def implicit_solvers(solver):
    """The implicit solver on the ARAP cuboid in both packages (order 20,
    from t0 = 0), after their first restart.  Pade is off: its range
    estimate evaluates a rational fit whose denominator solve turns the
    series' 1e-14 rounding into ~1e-9 at the end of the range, so with
    it the next start point, and all of restart 2, would test the fit's
    conditioning rather than the driver (the CLI tests run with Pade
    on)."""
    from sanm_tpu.solver.anm import ANMImplicitSolver as JaxImplicit
    from sanm_tpu.solver.anm import HyperParam as JaxHP
    from sanm_tpu_torch.solver import ANMImplicitSolver, HyperParam

    jm, pm, _ = models(deform_bodies(), "arap")
    kw = dict(order=ORDER, use_pade=False, solution_check_tol=10.0)
    sj = JaxImplicit(jm.fn, jm.lt_inp.remap, jm.lt_out.remap, jm.x0(), 0.0,
                     JaxHP(solver="host_lu", **kw))
    sp = ANMImplicitSolver(pm, pm.x0(), 0.0, HyperParam(solver=solver, **kw))
    return sj, sp


@pytest.mark.parametrize("solver", ["host_lu", "band_chol"])
def test_implicit_expansions_match_jax(solver):
    """The coefficients and the validated t range of restarts 1 and 2
    against the JAX package's ``ANMImplicitSolver``.  Restart 2 starts
    where restart 1's validated range ends (t0 > 0), so it reads t in the
    series and the Jacobian."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the plain band factor: many small calls
    try:
        sj, sp = implicit_solvers(solver)
        for restart in (1, 2):
            assert sp.xt_coeffs.shape == sj.xt_coeffs.shape
            assert rel_err(sp.xt_coeffs, sj.xt_coeffs) <= SERIES_RTOL
            assert abs(sp.get_t_upper() - sj.get_t_upper()) <= \
                SERIES_RTOL * abs(sj.get_t_upper())
            if restart == 1:
                assert sp.get_t0() == 0.0 and sp.get_t_upper() < 1.0
                sj.update_approx()
                sp.update_approx()
        assert 0.0 < sp.get_t0() < sp.get_t_upper()
        assert sp.get_nr_iter() == sj.get_nr_iter() == 2
        assert sp.solver_resolved() == solver
    finally:
        torch.set_num_threads(threads)


def _jax_task(tmp_path, monkeypatch, *configs):
    from sanm_tpu.fea.app import TASKS, merge_configs

    cfg = merge_configs([os.path.join(CONFIGS, c) for c in configs])
    jdir = tmp_path / "jax"
    jdir.mkdir()
    monkeypatch.chdir(jdir)
    monkeypatch.delenv("SANM_WARM_TIMING", raising=False)
    return TASKS[cfg["func"]](cfg, CONFIGS)


def _override(tmp_path, solver):
    path = tmp_path / ("override_%s.json" % solver)
    path.write_text(json.dumps({"solver": solver}))
    return str(path)


def check_deform(port, jstat, iter_deform, iter_refine, solver):
    assert port["solver_resolved"] == solver
    assert port["iter_deform"] == jstat["iter_deform"] == iter_deform
    assert port["iter_refine"] == jstat["iter_refine"] == iter_refine
    assert port["force_rms_recomp"] <= RMS
    assert port["nr_inverted"] == 0
    assert abs(port["displacement"] - jstat["displacement"]) <= 1e-9 * abs(
        jstat["displacement"])
    for key in jstat:
        assert key in port, key


@pytest.mark.parametrize("solver", ["host_lu", "band_chol"])
def test_simple_cuboid_twist_cli(tmp_path, monkeypatch, solver):
    """``configs/test_simple_cuboid_twist.json`` (ARAP, V = 12, one bend
    step) through the port's CLI against the JAX package's task: 4
    deform and 1 refine restarts, force-RMS <= 1e-10, no inverted
    element, the relative displacement within 1e-9 relative (JAX:
    0.34999111732154403)."""
    _port_cli(tmp_path, "test_simple_cuboid_twist.json",
              _override(tmp_path, solver))
    port = json.loads((tmp_path / "cuboid-twist.json").read_text())
    jstat = _jax_task(tmp_path, monkeypatch,
                      "test_simple_cuboid_twist.json").stat
    assert abs(jstat["displacement"] - 0.34999111732154403) <= 1e-12
    check_deform(port, jstat, 4, 1, solver)
    assert port["device"] == "cpu"
    assert port["expansions"][solver] == 5


@pytest.mark.slow
def test_armadillo_small_arap_bend(tmp_path, monkeypatch):
    """The deform cell, armadillo-small + ``armadillo_small_bend_override
    .json`` (ARAP) as it is, port on host LU against the JAX package: 2
    deform + 1 refine restarts, force-RMS <= 1e-10, coordinates within
    1e-9 of the largest coordinate."""
    from sanm_tpu_torch.fea import app

    configs = ("armadillo_small.json", "armadillo_small_bend_override.json")
    cfg = app.merge_configs([os.path.join(CONFIGS, c) for c in configs])
    cfg["solver"] = "host_lu"
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("SANM_WARM_TIMING", raising=False)
    port = app.TASKS["mesh_twist"](cfg, CONFIGS, device="cpu")
    jres = _jax_task(tmp_path, monkeypatch, *configs)
    check_deform(port.stat, jres.stat, 2, 1, "host_lu")
    assert rel_err(port.mesh.vertices, jres.mesh.vertices) <= COORD_RTOL


def test_cuboid_cli(tmp_path, monkeypatch):
    """``configs/test_cuboid.json`` (NHC, the 20 x 8 x 8 cuboid) through
    the port's CLI against the JAX package's ``test_cuboid`` task: the
    same restarts, force-RMS <= 1e-10, the relative displacement within
    1e-9 relative."""
    _port_cli(tmp_path, "test_cuboid.json")
    port = json.loads(
        (tmp_path / "cuboid-i0-neohookean_c.json").read_text())
    jstat = _jax_task(tmp_path, monkeypatch, "test_cuboid.json").stat
    assert port["iter"] == jstat["iter"]
    assert port["force_rms_recomp"] <= RMS
    assert port["nr_inverted"] == 0
    assert abs(port["displacement"] - jstat["displacement"]) <= 1e-9 * abs(
        jstat["displacement"])
