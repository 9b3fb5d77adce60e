"""The spike_band solver of the port (``sanm_tpu_torch/solver/spike.py``,
K7 through its plain versions) against NumPy and the JAX package, on the
CPU.

Inputs are made with NumPy from a seed: the random SPD systems of
``tests/test_band.py`` / ``tests/test_spike.py`` and the 225-tet NHC
cuboid of ``tests/torch_helper.py``.  Tolerances, each with its reason:

* plan arrays: equal (the same integer arithmetic on the same ordering);
* the local factors: 1e-12 relative to ``numpy.linalg.cholesky`` of each
  partition's matrix (one f64 Cholesky against another);
* solves: 1e-10 relative to the largest entry, as ``tests/test_spike.py``
  (the JAX package's factor is f32, refined in f64 to a 1e-12
  residual);
* equilibria: the iterations and Pade decisions equal, coordinates within
  ``COORD_RTOL`` = 1e-9 of the largest coordinate, force-RMS <= 1e-10, as
  ``tests/test_torch_slice.py``; the bar's displacement within 1e-9
  relative.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanm_tpu.solver import spike as jspike
from test_band import _StubAssembler
from sanm_tpu_torch.solver import spike as pspike
from torch_helper import jax_model, rel_err, torch_matvec
from test_torch_band import SOLVE_TOL, random_system
from test_torch_slice import COORD_RTOL, RMS, ROOT, solve_port

FACTOR_TOL = 1e-12
# (seed, n, half bandwidth, partitions): tests/test_spike.py's systems
SPIKE_SYSTEMS = [(11, 601, 37, 1), (12, 601, 37, 2), (13, 601, 37, 3),
                 (20, 800, 61, 2), (21, 700, 23, 2)]


@pytest.fixture(autouse=True)
def one_thread():
    # the plain factors are many small BLAS calls, which the CPU's thread
    # pool slows down
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plans(monkeypatch, rows, cols, n, s, nparts):
    monkeypatch.setenv("SANM_BAND_S", str(s))
    return (pspike.SpikePlan(rows, cols, n, s, nparts),
            jspike.SpikePlan(rows, cols, n, nparts=nparts))


@pytest.mark.parametrize("s", [64, 128])
@pytest.mark.parametrize("seed, n, half_bw, nparts", SPIKE_SYSTEMS)
def test_spike_plan_matches_jax(monkeypatch, seed, n, half_bw, nparts, s):
    _, (rows, cols, _) = random_system(seed, n, half_bw)
    pp, jp = plans(monkeypatch, rows, cols, n, s, nparts)
    for name in ("s", "w", "bw", "b", "P", "m", "mb", "rows_loc", "W"):
        assert getattr(pp, name) == getattr(jp, name), name
    for name in ("loc_sel", "loc_idx", "coup_sel", "coup_idx", "pad_idx",
                 "perm_ext", "invp_ext"):
        assert np.array_equal(getattr(pp, name), getattr(jp, name)), name
    # each partition's reach stays inside the band and the partition
    for lb in pp.local:
        assert lb.blk_w.max(initial=0) <= pp.w
        assert np.all(np.arange(pp.mb) + lb.blk_w < pp.mb)


@pytest.mark.parametrize("nparts, want", [(None, 1), (2, 2)])
def test_spike_plan_matches_jax_on_cuboid(monkeypatch, nparts, want):
    """The cuboid's 240 unknowns hold one partition of b = 128 by default,
    two when asked for."""
    _, _, plan, _ = jax_model()
    pp, jp = plans(monkeypatch, plan.csr_rowidx, plan.csr_cols, plan.n, 128,
                   nparts)
    assert pp.P == jp.P == want
    for name in ("loc_idx", "coup_idx", "pad_idx", "perm_ext"):
        assert np.array_equal(getattr(pp, name), getattr(jp, name)), name


@pytest.mark.parametrize("seed, n, half_bw, nparts", SPIKE_SYSTEMS[:3])
def test_spike_local_factors_match_numpy_cholesky(seed, n, half_bw, nparts):
    """Each partition's panels against a dense Cholesky of its block of
    the permuted, scaled matrix: inv(L[j,j]) and L[j+1+m, j]."""
    A, (rows, cols, vals) = random_system(seed, n, half_bw)
    plan = pspike.SpikePlan(rows, cols, n, 64, nparts)
    Bloc, C, scale = pspike.spike_assemble(plan, torch.as_tensor(vals))
    panels = pspike.spike_local_factor(plan, Bloc)
    d = scale.numpy()
    M = np.eye(plan.P * plan.m)
    p = plan.perm_ext[:n]
    M[:n, :n] = -(d[:, None] * A.toarray() * d[None, :])[p][:, p]
    s, m = plan.s, plan.m
    for q, lb in enumerate(plan.local):
        L = np.linalg.cholesky(M[q * m:(q + 1) * m, q * m:(q + 1) * m])
        pq = plan.panels_of(panels, q)
        for j in range(plan.mb):
            P = lb.panel(pq, j).numpy()
            blk = L[j * s:(j + 1) * s, j * s:(j + 1) * s]
            assert rel_err(P[0], np.linalg.inv(blk)) <= FACTOR_TOL
            for k in range(int(lb.blk_w[j])):
                r0 = (j + 1 + k) * s
                assert rel_err(P[1 + k], L[r0:r0 + s, j * s:(j + 1) * s]) \
                    <= FACTOR_TOL
            r0 = (j + 1 + int(lb.blk_w[j])) * s
            assert np.abs(L[r0:, j * s:(j + 1) * s]).max(initial=0.0) == 0.0
        # the coupling block against the matrix
        if q:
            want = M[q * m:q * m + plan.b, q * m - plan.b:q * m]
            assert rel_err(C[q - 1].numpy(), want) <= 1e-15


@pytest.mark.parametrize("seed, n, half_bw, nparts", SPIKE_SYSTEMS)
def test_spike_solve_matches_numpy_and_jax(monkeypatch, seed, n, half_bw,
                                           nparts):
    A, (rows, cols, vals) = random_system(seed, n, half_bw)
    b = np.random.default_rng(seed + 10).standard_normal(n)
    x_ref = np.linalg.solve(A.toarray(), b)
    plan, _ = plans(monkeypatch, rows, cols, n, 64, nparts)
    data = torch.as_tensor(vals)
    bt = torch.as_tensor(b)
    solver = pspike.DeviceSpikeBandSolver(plan, data,
                                          torch_matvec(rows, cols, data, n))
    assert solver.factor_ok()
    # the unrefined substitution alone
    y = pspike.spike_solve(plan, solver.F, bt * solver.scale)
    assert rel_err(-(y * solver.scale).numpy(), x_ref) <= SOLVE_TOL
    x, rel = solver.solve(bt, with_resid=True)
    assert float(rel) <= 1e-12
    assert rel_err(x.numpy(), x_ref) <= SOLVE_TOL
    stub = _StubAssembler(A)
    xj = jspike.DeviceSpikeBandSolver(stub, stub.data(), nparts=nparts).solve(
        jnp.asarray(b))
    assert rel_err(x.numpy(), np.asarray(xj)) <= SOLVE_TOL
    assert solver.solves == 1 and solver.trips <= 1


@pytest.mark.parametrize("nparts", [2, 3])
def test_spike_rhs_solve_is_the_local_solve(nparts):
    """K7b's plain version on k columns against the dense solves of each
    partition's block."""
    A, (rows, cols, vals) = random_system(12, 601, 37)
    plan = pspike.SpikePlan(rows, cols, 601, 64, nparts)
    Bloc, _, scale = pspike.spike_assemble(plan, torch.as_tensor(vals))
    panels = pspike.spike_local_factor(plan, Bloc)
    R = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (plan.P, plan.m, 64)))
    X = pspike.spike_rhs_solve(plan, panels, R.clone())
    d = scale.numpy()
    full = np.eye(plan.P * plan.m)
    p = plan.perm_ext[:601]
    full[:601, :601] = -(d[:, None] * A.toarray() * d[None, :])[p][:, p]
    m = plan.m
    for q in range(plan.P):
        blk = full[q * m:(q + 1) * m, q * m:(q + 1) * m]
        assert rel_err(X[q].numpy(), np.linalg.solve(blk, R[q].numpy())) \
            <= SOLVE_TOL


def test_spike_indefinite_is_not_ok():
    """The negated system gives NaN in the local factors, which the factor
    check sees; the spikes are not computed then."""
    _, (rows, cols, vals) = random_system(2, 300, 15)
    plan = pspike.SpikePlan(rows, cols, 300, 32, 2)
    data = torch.as_tensor(vals)
    good = pspike.DeviceSpikeBandSolver(plan, data,
                                        torch_matvec(rows, cols, data, 300))
    assert good.factor_ok()
    neg = pspike.DeviceSpikeBandSolver(plan, -data,
                                       torch_matvec(rows, cols, -data, 300))
    assert not neg.factor_ok()
    assert torch.isnan(neg.F.panels).any() and neg.F.V is None


def test_spike_factor_of_an_indefinite_state_is_not_ok():
    """The cuboid's Jacobian at moves of up to 8% of its spacing is
    indefinite (``tests/test_torch_band.py``): the SPIKE factor flags it,
    and a 0.8% move keeps it definite."""
    from sanm_tpu_torch.solver.assemble import jac_asm
    from torch_helper import port_state

    body, model, plan, f_sub = jax_model()
    st = port_state(body, model, plan, f_sub)
    sp = pspike.SpikePlan(plan.csr_rowidx, plan.csr_cols, plan.n)
    for amp, ok in ((2e-4, True), (2e-3, False)):
        x = model.x0() + np.random.default_rng(4).uniform(-amp, amp,
                                                          plan.n)
        data, _, _ = jac_asm(st.asm, st.elems, st.asm.apply_in(x))
        solver = pspike.DeviceSpikeBandSolver(sp, data, None)
        assert solver.factor_ok() == ok


@pytest.mark.parametrize("fz", [-1500.0])
def test_spike_equilibrium_matches_jax(fz):
    """The cuboid cases of ``tests/test_torch_slice.py`` with
    ``solver="spike_band"`` in both packages (one partition at s = 128 in
    the port; the JAX package picks its own block size)."""
    from test_torch_dense_chol import solve_jax

    sj, xj, rms_j = solve_jax(fz, 0.0, "spike_band")
    sp, xp, rms_p = solve_port(fz, 0.0, solver="spike_band")
    assert sp.get_nr_iter() == sj.get_nr_iter()
    assert rms_j <= RMS and rms_p <= RMS
    assert rel_err(xp, xj) <= COORD_RTOL
    assert [r["accepted"] for r in sp.pade_log] == [
        r["accepted"] for r in sj.pade_log]
    assert not any(sp.band_fallbacks.values())
    assert sp.solver_resolved() == "spike_band"
    fact = sp._fact["solver"]
    assert isinstance(fact, pspike.DeviceSpikeBandSolver)
    assert fact.plan.P == 1
    assert fact.solves == 20 and fact.trips <= fact.solves


def _bar_override(tmp_path, solver):
    """configs/bar.json with the NHC material (override_neo_comp.json) on
    ``solver``."""
    path = tmp_path / ("solver_%s.json" % solver)
    path.write_text(json.dumps({"solver": solver}))
    return [os.path.join(ROOT, "configs", f) for f in (
        "sys.json", "bar.json", "override_neo_comp.json")] + [str(path)]


@pytest.mark.slow
@pytest.mark.parametrize("solver", ["dense_chol", "spike_band"])
def test_bar_gravity_cli_matches_jax(tmp_path, monkeypatch, solver):
    """Bar NHC gravity (``configs/bar.json``, 1,620 vertices) through the
    port's CLI against the JAX package's task on the same solver: the
    same restarts, the displacement within 1e-9 relative, force-RMS <=
    1e-10, every expansion on the device factor."""
    from sanm_tpu.fea.app import TASKS, merge_configs

    files = _bar_override(tmp_path, solver)
    pdir = tmp_path / "port"
    pdir.mkdir()
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("SANM_WARM_TIMING", None)
    env.pop("SANM_SOLVER", None)
    res = subprocess.run(
        [sys.executable, "-m", "sanm_tpu_torch.fea", "--device", "cpu",
         *files], cwd=pdir, env=env, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    outs = [f for f in os.listdir(pdir) if f.endswith(".json")]
    assert len(outs) == 1, outs
    port = json.loads((pdir / outs[0]).read_text())

    cfg = merge_configs(files[1:])
    jdir = tmp_path / "jax"
    jdir.mkdir()
    monkeypatch.chdir(jdir)
    monkeypatch.delenv("SANM_WARM_TIMING", raising=False)
    monkeypatch.delenv("SANM_SOLVER", raising=False)
    jstat = TASKS[cfg["func"]](cfg, os.path.join(ROOT, "configs")).stat
    assert port["iter"] == jstat["iter"]
    assert port["force_rms_recomp"] <= RMS
    assert port["nr_inverted"] == 0
    assert abs(port["displacement"] - jstat["displacement"]) <= 1e-9 * abs(
        jstat["displacement"])
    assert port["solver_backend"] == port["solver_resolved"] == solver
    assert port["expansions"] == {solver: port["iter"], "host_lu": 0}
    assert port["band_fallbacks"] == {"gate": 0, "checks": 0,
                                      "not_finite": 0}
