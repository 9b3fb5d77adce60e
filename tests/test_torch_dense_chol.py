"""The dense_chol and dense solvers of the port (``sanm_tpu_torch/solver/
linear.py``, K6 through its plain versions; the dense branch of
``solver/anm.py``) against NumPy and the JAX package, on the CPU.

Inputs are made with NumPy from a seed: the random SPD systems of
``tests/test_band.py`` and the 225-tet NHC cuboid of
``tests/torch_helper.py``.  Tolerances, each with its reason:

* the dense matrix: 1e-6 relative to the JAX package's (its matrix is
  f32; the port's is f64), the scale 1e-15 (f64 on both sides);
* the plain f64 factor: 1e-12 relative to ``numpy.linalg.cholesky`` of
  the same matrix (one f64 Cholesky against another, summed in another
  order);
* solves: 1e-10 relative to the largest entry, as ``tests/test_band.py``
  (the JAX package's factor is f32, refined in f64 to a 1e-12
  residual);
* equilibria: the iterations and Pade decisions equal, coordinates within
  ``COORD_RTOL`` = 1e-9 of the largest coordinate, force-RMS <= 1e-10, as
  ``tests/test_torch_slice.py``.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanm_tpu.solver.linear import DeviceCholSolver as JaxCholSolver
from sanm_tpu.solver.remap import SparseAssembler
from test_band import _StubAssembler
from sanm_tpu_torch import SANMError
from sanm_tpu_torch.solver import anm as panm
from sanm_tpu_torch.solver import linear as plinear
from sanm_tpu_torch.solver.assemble import (DensePlan, dense_assemble,
                                            dense_assemble_plain)
from torch_helper import jax_model, rel_err, torch_matvec
from test_torch_band import SOLVE_TOL, SYSTEMS, random_system
from test_torch_slice import COORD_RTOL, RMS, ROOT, solve_port

FACTOR_TOL = 1e-12
MATRIX_TOL = 1e-6


class DenseStub(_StubAssembler):
    """``tests/test_band.py``'s assembler facade with the JAX package's
    dense assembly (what its ``DeviceCholSolver`` calls)."""

    assemble_dense_scaled_neg = SparseAssembler.assemble_dense_scaled_neg


@pytest.fixture(autouse=True)
def one_thread():
    # the plain factors are many small BLAS calls, which the CPU's thread
    # pool slows down
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed, n, half_bw", SYSTEMS[:3])
def test_dense_assembly_matches_jax(seed, n, half_bw):
    """-(D A D) in the (npad, npad) buffer, unit diagonal in the pad,
    against ``assemble_dense_scaled_neg`` at the same npad."""
    A, (rows, cols, vals) = random_system(seed, n, half_bw)
    plan = DensePlan(rows, cols, n, 64)
    assert plan.npad == -(-n // 64) * 64 and plan.nb * 64 == plan.npad
    M, scale = dense_assemble(plan, torch.as_tensor(vals))
    stub = DenseStub(A)
    assert np.array_equal(stub.csr_rowidx, rows)
    Mj, sj = stub.assemble_dense_scaled_neg(jnp.asarray(vals), plan.npad)
    assert rel_err(scale.numpy(), np.asarray(sj)) <= 1e-15
    assert rel_err(M.numpy(), np.asarray(Mj)) <= MATRIX_TOL
    # every CSR entry lands on its own position
    assert len(np.unique(plan.idx)) == plan.nnz
    assert torch.equal(M, dense_assemble_plain(plan, torch.as_tensor(vals))[0])


@pytest.mark.parametrize("s", [32, 64])
@pytest.mark.parametrize("seed, n, half_bw", SYSTEMS[:3])
def test_dense_factor_matches_numpy_cholesky(seed, n, half_bw, s):
    A, (rows, cols, vals) = random_system(seed, n, half_bw)
    plan = DensePlan(rows, cols, n, s)
    M, _ = dense_assemble(plan, torch.as_tensor(vals))
    L_ref = np.linalg.cholesky(M.numpy())
    inv = plinear.dense_factor(plan, M)
    assert plinear.dense_factor_ok(inv)
    assert rel_err(np.tril(M.numpy()), L_ref) <= FACTOR_TOL
    for j in range(plan.nb):
        blk = L_ref[j * s:(j + 1) * s, j * s:(j + 1) * s]
        assert rel_err(inv[j].numpy(), np.linalg.inv(blk)) <= FACTOR_TOL


@pytest.mark.parametrize("seed, n, half_bw", SYSTEMS[:3])
def test_dense_chol_solve_matches_numpy_and_jax(seed, n, half_bw):
    A, (rows, cols, vals) = random_system(seed, n, half_bw)
    b = np.random.default_rng(seed + 10).standard_normal(n)
    x_ref = np.linalg.solve(A.toarray(), b)
    plan = DensePlan(rows, cols, n, 64)
    data = torch.as_tensor(vals)
    bt = torch.as_tensor(b)

    # the plain assemble + factor + substitution alone, unrefined; the pad
    # rows solve to exact zeros
    M, scale = dense_assemble(plan, data)
    inv = plinear.dense_factor(plan, M)
    y = plinear.dense_solve(plan, M, inv, bt * scale)
    assert rel_err(-(y * scale).numpy(), x_ref) <= SOLVE_TOL

    solver = plinear.DeviceCholSolver(plan, data,
                                      torch_matvec(rows, cols, data, n))
    x, rel = solver.solve(bt, with_resid=True)
    assert float(rel) <= 1e-12
    assert rel_err(x.numpy(), x_ref) <= SOLVE_TOL
    stub = DenseStub(A)
    xj = JaxCholSolver(stub, stub.data()).solve(jnp.asarray(b))
    assert rel_err(x.numpy(), np.asarray(xj)) <= SOLVE_TOL
    assert solver.solves == 1 and solver.trips <= 1
    assert rel_err(solver.apply(x).numpy(), A @ x.numpy()) <= 1e-13


def test_dense_chol_indefinite_is_not_ok():
    """The negated (positive definite A: -A indefinite) system gives NaN,
    never a clamp, as the band factor (``tests/test_band.py:128``)."""
    _, (rows, cols, vals) = random_system(2, 300, 15)
    plan = DensePlan(rows, cols, 300, 64)
    data = torch.as_tensor(vals)
    good = plinear.DeviceCholSolver(plan, data,
                                    torch_matvec(rows, cols, data, 300))
    assert good.factor_ok()
    neg = plinear.DeviceCholSolver(plan, -data,
                                   torch_matvec(rows, cols, -data, 300))
    assert not neg.factor_ok()
    assert torch.isnan(neg.inv).any()


@pytest.mark.parametrize("seed, n, half_bw", SYSTEMS[:2])
@pytest.mark.parametrize("pen", [0.0, 1e-3])
def test_dense_factor_solver_matches_numpy(seed, n, half_bw, pen):
    """The ``dense`` solver: QR, and Cholesky of A^T A + pen I in
    Tikhonov mode, each refined, against NumPy's solves."""
    A, _ = random_system(seed, n, half_bw)
    Ad = A.toarray()
    b = np.random.default_rng(seed + 20).standard_normal(n)
    solver = plinear.DenseFactorSolver(torch.as_tensor(Ad), pen)
    if pen:
        want = np.linalg.solve(Ad.T @ Ad + pen * np.eye(n), Ad.T @ b)
    else:
        want = np.linalg.solve(Ad, b)
    x = solver.solve(torch.as_tensor(b))
    assert rel_err(x.numpy(), want) <= SOLVE_TOL
    assert rel_err(solver.apply(x).numpy(), Ad @ x.numpy()) <= 1e-13


def solve_jax(fz, pen, solver):
    from sanm_tpu.fea import DeformableBody
    from sanm_tpu.fea.app import RMS_THRESH_FORCE_EQU, run_anm_eqn
    from sanm_tpu.solver import ANMEqnSolver
    from sanm_tpu.solver.anm import EqnHyperParam

    body, model, plan, f_sub = jax_model(fz)
    hp = EqnHyperParam(order=20, use_pade=True, solver=solver,
                       xcoeff_l2_penalty=pen)
    hp.converge_rms = RMS_THRESH_FORCE_EQU
    hp.solution_check_tol = 1e-3
    s = ANMEqnSolver(model.fn, model.lt_inp.remap, model.lt_out.remap,
                     model.x0(), f_sub, hp)
    x = run_anm_eqn(s, progress=False)
    assert getattr(s, "_factor_gate_fails", 0) == 0
    return s, x, DeformableBody.compute_force_rms(model, x, f_sub)


@pytest.mark.parametrize("solver, fz, pen", [
    ("dense_chol", -1500.0, 0.0), ("dense_chol", -600.0, 1e-3),
    ("dense", -600.0, 1e-3)])
def test_dense_equilibrium_matches_jax(solver, fz, pen):
    """The cuboid cases of ``tests/test_torch_slice.py`` on the same
    solver in both packages; with the l2 penalty dense_chol leaves the
    solve to host LU (it refuses Tikhonov mode) and dense keeps it."""
    sj, xj, rms_j = solve_jax(fz, pen, solver)
    sp, xp, rms_p = solve_port(fz, pen, solver=solver)
    assert sp.get_nr_iter() == sj.get_nr_iter()
    assert rms_j <= RMS and rms_p <= RMS
    assert rel_err(xp, xj) <= COORD_RTOL
    assert [r["accepted"] for r in sp.pade_log] == [
        r["accepted"] for r in sj.pade_log]
    assert not any(sp.band_fallbacks.values())
    mode = "host_lu" if pen and solver == "dense_chol" else solver
    assert sp._solver_mode() == solver and sp._fact["mode"] == mode
    assert sp.solver_resolved() == mode
    assert sp.expansions[mode] == sp.get_nr_iter()
    if mode == "dense_chol":
        fact = sp._fact["solver"]
        assert isinstance(fact, plinear.DeviceCholSolver)
        assert fact.solves == 20 and fact.trips <= fact.solves


@pytest.mark.parametrize("solver", ["dense_chol", "spike_band"])
def test_old_device_factor_freed_before_the_next(monkeypatch, solver):
    """A restart that does not reuse the factor lets the old one go
    before it builds the new one: on the card the dense factor is 11.6 GB
    at armadillo-small, and two of them must not be alive at once."""
    import weakref

    made = []
    factorize = panm.ANMEqnSolver._factorize

    def checked(self, mode, data, E):
        assert all(ref() is None for ref in made), "old factor still alive"
        out = factorize(self, mode, data, E)
        made.append(weakref.ref(out))
        return out

    monkeypatch.setattr(panm.ANMEqnSolver, "_factorize", checked)
    sp, _, rms = solve_port(-600.0, 0.0, solver=solver)
    assert len(made) == sp.get_nr_iter() == 3
    assert sp.expansions == {solver: 3, "host_lu": 0}
    assert rms <= RMS


@pytest.mark.parametrize("solver", ["dense_chol", "spike_band"])
def test_device_factor_pre_gate_falls_back_to_host_lu(monkeypatch, solver):
    """An impossible pre-gate (``tests/test_torch_band.py``): host LU for
    the rest of the solve after one device solve, counted, converging to
    the host-LU solution; ``reset`` clears the override."""
    monkeypatch.setattr(panm, "FACTOR_GATE", -1.0)
    sp, xp, rms = solve_port(-600.0, 0.0, solver=solver)
    assert sp._factor_gate_fails == 1
    assert sp.band_fallbacks == {"gate": 1, "checks": 0, "not_finite": 0}
    assert sp._solver_override == "host_lu"
    assert sp._fact["mode"] == "host_lu"
    assert sp.expansions == {solver: 0, "host_lu": sp.get_nr_iter()}
    assert sp.solver_resolved() == "host_lu"
    assert rms <= RMS
    sh, xh, _ = solve_port(-600.0, 0.0)
    assert sp.get_nr_iter() == sh.get_nr_iter()
    assert rel_err(xp, xh) <= COORD_RTOL
    monkeypatch.setattr(panm, "FACTOR_GATE", 1e-8)
    sp.reset()
    assert sp._solver_override is None and sp._fact["mode"] == solver


@pytest.mark.parametrize("solver, cls", [
    ("dense_chol", "sanm_tpu_torch.solver.linear.DeviceCholSolver"),
    ("spike_band", "sanm_tpu_torch.solver.spike.DeviceSpikeBandSolver")])
def test_device_factor_failing_checks_falls_back(monkeypatch, solver, cls):
    """A device expansion that passes the pre-gate but fails the order
    checks (a wrong operator in the sanity residual) is redone on host
    LU, which takes the rest of the solve; a factor that is not finite
    hands each restart to host LU."""
    monkeypatch.setattr(cls + ".apply", lambda self, x: self.matvec(x) * 2.0)
    sp, xp, rms = solve_port(-600.0, 0.0, solver=solver)
    assert sp.band_fallbacks == {"gate": 0, "checks": 1, "not_finite": 0}
    assert sp._factor_gate_fails == 1
    assert sp._solver_override == "host_lu"
    assert sp.expansions == {solver: 1, "host_lu": sp.get_nr_iter()}
    assert sp.solver_resolved() == "mixed"
    assert rms <= RMS
    monkeypatch.undo()
    monkeypatch.setattr(cls + ".factor_ok", lambda self: False)
    sp, xp, rms = solve_port(-600.0, 0.0, solver=solver)
    it = sp.get_nr_iter()
    assert sp.band_fallbacks == {"gate": 0, "checks": 0, "not_finite": it}
    assert sp._solver_override is None
    assert sp.expansions == {solver: 0, "host_lu": it}
    assert rms <= RMS


@pytest.mark.parametrize("solver", ["dense_chol", "spike_band"])
def test_implicit_driver_on_device_factor(solver):
    """The implicit driver (the deform task's; ``tests/
    test_sparse_solver.py:311-338``) on the dense and SPIKE factors: the
    ARAP cuboid's first two restarts against the JAX package's
    ``ANMImplicitSolver``, every expansion on the device factor."""
    from test_torch_deform import SERIES_RTOL, implicit_solvers

    sj, sp = implicit_solvers(solver)
    for restart in (1, 2):
        assert sp.xt_coeffs.shape == sj.xt_coeffs.shape
        assert rel_err(sp.xt_coeffs, sj.xt_coeffs) <= SERIES_RTOL
        assert abs(sp.get_t_upper() - sj.get_t_upper()) <= \
            SERIES_RTOL * abs(sj.get_t_upper())
        if restart == 1:
            sj.update_approx()
            sp.update_approx()
    assert sp.get_nr_iter() == 2 and sp.solver_resolved() == solver
    assert sp.expansions == {solver: 2, "host_lu": 0}
    assert sp._fact["mode"] == solver


@pytest.mark.parametrize("solver", ["dense_chol", "spike_band"])
def test_device_factors_refuse_inverse_and_penalty(solver):
    """Both factor -(D A D) by Cholesky: the solver classes refuse
    Tikhonov mode, and the driver refuses the inverse model (whose
    Jacobian is not symmetric), as for band_chol."""
    from sanm_tpu_torch.fea import (DeformableBody, EnergyModel,
                                    MaterialProperty, TetrahedralMesh)
    from sanm_tpu_torch.solver import ANMEqnSolver, EqnHyperParam
    from sanm_tpu_torch.solver.spike import (DeviceSpikeBandSolver,
                                             SpikePlan)

    _, (rows, cols, vals) = random_system(1, 100, 9)
    cls, plan_cls = ((plinear.DeviceCholSolver, DensePlan)
                     if solver == "dense_chol"
                     else (DeviceSpikeBandSolver, SpikePlan))
    with pytest.raises(SANMError, match="Tikhonov"):
        cls(plan_cls(rows, cols, 100, 64), torch.as_tensor(vals), None,
            l2_penalty=1e-3)
    mesh = TetrahedralMesh.make_cuboid(3, 2, 2, 0.1)
    body = DeformableBody(MaterialProperty.from_young_poisson(1e6, 0.4),
                          mesh)
    body.coord_fixed_mask[mesh.vertices[:, 0] <= 0.05, :] = True
    inv = body.make_inverse(EnergyModel.NEOHOOKEAN_C, device="cpu")
    with pytest.raises(SANMError, match="symmetric"):
        ANMEqnSolver(inv, inv.x0(), np.zeros(inv.x0().size),
                     EqnHyperParam(order=4, solver=solver))


def test_gravity_cli_solver_from_env(tmp_path):
    """``SANM_SOLVER`` selects the solver over the config's, as in the
    JAX package (``sanm_tpu/fea/app.py:94-96``): ``dense_chol`` and
    ``cg`` run; an unknown value still raises."""
    from test_torch_slice import write_tiny_gravity

    write_tiny_gravity(tmp_path)
    env = dict(os.environ, PYTHONPATH=ROOT, SANM_SOLVER="dense_chol")
    env.pop("SANM_WARM_TIMING", None)
    cmd = [sys.executable, "-m", "sanm_tpu_torch.fea", "--device", "cpu",
           "sys.json", "task.json"]
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    port = json.loads((tmp_path / "tiny-i0-neohookean_c.json").read_text())
    assert port["solver_backend"] == "dense_chol"
    assert port["solver_resolved"] == "dense_chol"
    assert port["expansions"] == {"dense_chol": port["iter"], "host_lu": 0}
    assert port["force_rms_recomp"] <= RMS
    res = subprocess.run(cmd, cwd=tmp_path, env=dict(env, SANM_SOLVER="cg"),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    port = json.loads((tmp_path / "tiny-i0-neohookean_c.json").read_text())
    assert port["solver_backend"] == "cg"
    assert port["expansions"] == {"cg": port["iter"], "host_lu": 0}
    assert port["force_rms_recomp"] <= RMS
    res = subprocess.run(cmd, cwd=tmp_path,
                         env=dict(env, SANM_SOLVER="pardiso"),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "unknown solver" in res.stdout + res.stderr
