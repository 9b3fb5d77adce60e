"""The slice end to end: NHC equilibrium in both packages, and the port's
gravity CLI against the JAX package's stat JSON.

Tolerances: force-RMS <= 1e-10 (the paper's target, reference
``fea/main.cpp:28``) in both; coordinates within 1e-9 relative of the
largest coordinate (both solve the same restarts with f64 host LU; the
residual f(x0) is NumPy on the JAX side and torch on the port's)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_helper import CUBOID, MATERIAL, cuboid_load, rel_err

ORDER = 20
COORD_RTOL = 1e-9
RMS = 1e-10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def solve_jax(fz, pen):
    from sanm_tpu.fea import DeformableBody
    from sanm_tpu.fea.app import RMS_THRESH_FORCE_EQU, run_anm_eqn
    from sanm_tpu.solver import ANMEqnSolver
    from sanm_tpu.solver.anm import EqnHyperParam
    from torch_helper import jax_model

    body, model, plan, f_sub = jax_model(fz)
    hp = EqnHyperParam(order=ORDER, use_pade=True, solver="host_lu",
                       xcoeff_l2_penalty=pen)
    hp.converge_rms = RMS_THRESH_FORCE_EQU
    hp.solution_check_tol = 1e-3
    s = ANMEqnSolver(model.fn, model.lt_inp.remap, model.lt_out.remap,
                     model.x0(), f_sub, hp)
    x = run_anm_eqn(s, progress=False)
    rms = DeformableBody.compute_force_rms(model, x, f_sub)
    assert s._solver_mode() == "host_lu" and s._loop_mode() == "hybrid"
    return s, x, rms


def solve_port(fz, pen, solver="auto"):
    from sanm_tpu_torch.fea import (DeformableBody, EnergyModel,
                                    MaterialProperty, TetrahedralMesh)
    from sanm_tpu_torch.fea.app import RMS_THRESH_FORCE_EQU, run_anm_eqn
    from sanm_tpu_torch.solver import ANMEqnSolver, EqnHyperParam

    c = CUBOID
    mesh = TetrahedralMesh.make_cuboid(c["nx"], c["ny"], c["nz"],
                                       c["spacing"])
    body = DeformableBody(
        MaterialProperty.from_young_poisson(MATERIAL["E"], MATERIAL["nu"]),
        mesh)
    body.coord_fixed_mask[mesh.vertices[:, 0] <= c["spacing"] / 2, :] = True
    model = body.make_forward(EnergyModel.NEOHOOKEAN_C, device="cpu")
    f_sub = model.lt_inp.copy_vtx_values(
        cuboid_load(mesh, c["nx"], c["spacing"], fz))
    hp = EqnHyperParam(order=ORDER, use_pade=True, xcoeff_l2_penalty=pen,
                       solver=solver)
    hp.converge_rms = RMS_THRESH_FORCE_EQU
    hp.solution_check_tol = 1e-3
    s = ANMEqnSolver(model, model.x0(), f_sub, hp)
    x = run_anm_eqn(s, progress=False)
    return s, x, DeformableBody.compute_force_rms(model, x, f_sub)


@pytest.mark.parametrize("fz, pen", [(-200.0, 0.0), (-600.0, 0.0),
                                     (-1500.0, 0.0), (-600.0, 1e-3)])
def test_equilibrium_matches_jax(fz, pen):
    """2, 3 and 4 restarts, with Pade accepted and rejected; the last
    case with the l2 coefficient penalty of override_l2_penalty.json."""
    sj, xj, rms_j = solve_jax(fz, pen)
    sp, xp, rms_p = solve_port(fz, pen)
    assert sp.get_nr_iter() == sj.get_nr_iter()
    assert rms_j <= RMS and rms_p <= RMS
    assert rel_err(xp, xj) <= COORD_RTOL
    assert [r["accepted"] for r in sp.pade_log] == [
        r["accepted"] for r in sj.pade_log]
    # the factorization-reuse decision (fact_reuse_rel_step) agrees
    fact = {"x0": xj.copy()}
    for step in (0.0, 1e-3, 0.1):
        sj.hp.fact_reuse_rel_step = sp.hp.fact_reuse_rel_step = step
        for scale in (0.0, 1e-4, 1e-2):
            xt0 = np.concatenate([xj * (1.0 + scale), [0.0]])
            assert sp._fact_reusable(fact, xt0) == sj._fact_reusable(
                fact, xt0)
        assert not sp._fact_reusable(None, xt0)


def write_tiny_gravity(tmp):
    """A 4x3x3 cuboid as tetgen files plus a gravity task config."""
    from sanm_tpu_torch.fea.mesh import TetrahedralMesh
    from torch_helper import write_tetgen

    mesh = TetrahedralMesh.make_cuboid(4, 3, 3, 0.05)
    write_tetgen(mesh, str(tmp / "tiny"))
    task = {
        "func": "gravity",
        "material": {"type": "young_poisson", "young": 1e5,
                     "poisson": 0.45, "density": 1000.0},
        "energy_model": "neohookean_c",
        "mesh": "tiny",
        "g": [0, -9.81, 0],
        "out_filename": "tiny",
        "boundary_thresh": 0.05,
        "order": 8,
        "solver": "host_lu",
    }
    (tmp / "task.json").write_text(json.dumps(task))
    (tmp / "sys.json").write_text(json.dumps({"verbosity": 0,
                                              "threads": 1}))
    return task


def test_gravity_cli_stat_keys(tmp_path, monkeypatch):
    task = write_tiny_gravity(tmp_path)
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("SANM_WARM_TIMING", None)
    res = subprocess.run(
        [sys.executable, "-m", "sanm_tpu_torch.fea", "--device", "cpu",
         "sys.json", "task.json"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    port = json.loads((tmp_path / "tiny-i0-neohookean_c.json").read_text())
    for f in ("tiny-boundary.obj", "tiny-orig.obj",
              "tiny-i0-neohookean_c.obj"):
        assert (tmp_path / f).exists()
    assert port["force_rms_recomp"] <= RMS
    assert port["threads_semantics"] == "cuda_device_count"

    from sanm_tpu.fea.app import gravity

    jdir = tmp_path / "jax"
    jdir.mkdir()
    monkeypatch.chdir(jdir)
    monkeypatch.delenv("SANM_WARM_TIMING", raising=False)
    jstat = gravity(dict(task), str(tmp_path)).stat
    assert set(jstat) <= set(port)
    assert set(port) - set(jstat) == {"device", "expansions",
                                      "band_fallbacks"}
    assert port["iter"] == jstat["iter"]
    assert port["mesh_V"] == jstat["mesh_V"]
    assert port["mesh_F"] == jstat["mesh_F"]
    assert abs(port["displacement"] - jstat["displacement"]) <= 1e-9 * abs(
        jstat["displacement"])
