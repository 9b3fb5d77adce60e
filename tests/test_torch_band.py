"""The band_chol path of the port (``sanm_tpu_torch/solver/band.py``, the
band branch of ``solver/anm.py``) against the JAX package, on the CPU
through the plain versions of the K4/K5 kernels.

Inputs are made with NumPy from a seed: the random SPD systems of
``tests/test_band.py`` and the 225-tet NHC cuboid of
``tests/torch_helper.py``.  Tolerances, each with its reason:

* plan arrays: equal (the same integer arithmetic on the same ordering);
* solves: 1e-10 relative to the largest entry, as ``tests/test_band.py``
  (the port's factor is f64; the JAX package's is f32 refined in f64 to
  a 1e-12 residual);
* ``element_matvec``: 1e-13 relative (f64 sums in another order);
* the kernels' orders walked on the CPU (:func:`band_tri_solve_walk`,
  :func:`element_matvec_walk`): 1e-13 relative against the plain versions
  and the JAX package (the same operations, summed in another order);
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

from sanm_tpu.solver import band as jband
from sanm_tpu.solver.linear import chol_refine_solve as jax_refine
from test_band import _random_sparse_spd, _StubAssembler
from sanm_tpu_torch.solver import anm as panm
from sanm_tpu_torch.solver import band as pband
from sanm_tpu_torch.solver import linear as plinear
from sanm_tpu_torch.solver.assemble import element_matvec, jac_asm
from sanm_tpu_torch.solver.linear import chol_refine_solve
from sanm_tpu_torch.utils import SANMError, SANMNumericalError
from torch_helper import (coo_of, jax_model, port_state, ragged_spd,
                          random_sparse_spd, rel_err, torch_matvec)
from test_torch_slice import COORD_RTOL, RMS, ROOT, solve_port

SOLVE_TOL = 1e-10
MATVEC_TOL = 1e-13
SYSTEMS = [(0, 601, 37), (1, 100, 9), (3, 800, 61), (4, 257, 5)]


@pytest.fixture(autouse=True)
def one_thread():
    # the plain factor is many small BLAS calls, which the CPU's thread
    # pool slows down by orders of magnitude here
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_system(seed, n, half_bw):
    """The random system of ``tests/test_band.py`` and its COO arrays; the
    copy in ``torch_helper`` (which the card tests use, without JAX) makes
    the same matrix."""
    A = _random_sparse_spd(n, half_bw, np.random.default_rng(seed))
    mine = random_sparse_spd(n, half_bw, np.random.default_rng(seed))
    assert (A != mine).nnz == 0
    return A, coo_of(A)


def jax_plan(monkeypatch, rows, cols, n, s):
    monkeypatch.setenv("SANM_BAND_S", str(s))
    return jband.BandPlan(rows, cols, n)


def assert_plans_equal(pp, jp):
    for name in ("s", "w", "bw", "nb", "nrow_tot", "W"):
        assert getattr(pp, name) == getattr(jp, name), name
    for name in ("blk_w", "band_sel", "band_idx", "pad_idx", "perm_ext",
                 "invp_ext"):
        assert np.array_equal(getattr(pp, name), getattr(jp, name)), name
    # every nnz of the lower triangle lands on its own band position
    assert len(np.unique(pp.band_idx)) == pp.band_idx.size
    assert pp.band_idx.max() < pp.nrow_tot * pp.W


@pytest.mark.parametrize("s", [64, 128])
@pytest.mark.parametrize("seed, n, half_bw", SYSTEMS)
def test_band_plan_matches_jax(monkeypatch, seed, n, half_bw, s):
    _, (rows, cols, _) = random_system(seed, n, half_bw)
    assert_plans_equal(pband.BandPlan(rows, cols, n, s),
                       jax_plan(monkeypatch, rows, cols, n, s))


@pytest.mark.parametrize("s", [64, 128])
def test_band_plan_matches_jax_on_cuboid(monkeypatch, s):
    _, _, plan, _ = jax_model()
    pp = pband.BandPlan(plan.csr_rowidx, plan.csr_cols, plan.n, s)
    assert_plans_equal(pp, jax_plan(monkeypatch, plan.csr_rowidx,
                                    plan.csr_cols, plan.n, s))
    pos, row = plan._diag_nnz_pos()
    assert np.array_equal(pp.diag_of_row[row], pos)
    assert (pp.diag_of_row >= 0).sum() == len(pos)


def test_diag_nnz_pos_matches_jax():
    from sanm_tpu_torch.solver.remap import SparseAssembler

    _, model, plan, _ = jax_model()
    T = model.lt_inp.remap.out_shape[0]
    mine = SparseAssembler(model.lt_out.remap, model.lt_inp.remap, T, 9, 9,
                           plan.n)
    for a, b in zip(mine._diag_nnz_pos(), plan._diag_nnz_pos()):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed, n, half_bw", SYSTEMS[:3])
def test_band_solve_matches_numpy_and_jax(monkeypatch, seed, n, half_bw):
    A, (rows, cols, vals) = random_system(seed, n, half_bw)
    b = np.random.default_rng(seed + 10).standard_normal(n)
    x_ref = np.linalg.solve(A.toarray(), b)
    plan = pband.BandPlan(rows, cols, n, 64)
    data = torch.as_tensor(vals)
    bt = torch.as_tensor(b)

    # the plain assemble + factor + substitution alone, unrefined
    band, scale = pband.band_assemble(plan, data)
    panels = pband.band_factor(plan, band)
    assert pband.band_factor_ok(panels)
    y = pband.band_solve(plan, panels, bt * scale)
    assert rel_err(-(y * scale).numpy(), x_ref) <= SOLVE_TOL

    # the solver class (refined) against numpy and the JAX package's
    solver = pband.DeviceBandCholSolver(plan, data,
                                        torch_matvec(rows, cols, data, n))
    x = solver.solve(bt)
    assert rel_err(x.numpy(), x_ref) <= SOLVE_TOL
    monkeypatch.setenv("SANM_BAND_S", "64")
    stub = _StubAssembler(A)
    xj = jband.DeviceBandCholSolver(stub, stub.data()).solve(jnp.asarray(b))
    assert rel_err(x.numpy(), np.asarray(xj)) <= SOLVE_TOL
    assert solver.solves == 1 and solver.trips <= 1
    assert rel_err(solver.apply(x).numpy(), A @ x.numpy()) <= MATVEC_TOL


def test_band_factor_indefinite_is_not_ok():
    """The negated (positive definite A: -A indefinite) system gives NaN,
    never a clamp (``tests/test_band.py:128``)."""
    A, (rows, cols, vals) = random_system(2, 300, 15)
    plan = pband.BandPlan(rows, cols, 300, 64)
    data = torch.as_tensor(vals)
    good = pband.DeviceBandCholSolver(plan, data,
                                      torch_matvec(rows, cols, data, 300))
    assert good.factor_ok()
    neg = pband.DeviceBandCholSolver(plan, -data,
                                     torch_matvec(rows, cols, -data, 300))
    assert not neg.factor_ok()
    assert torch.isnan(neg.panels).any()


def test_band_factor_of_an_indefinite_state_is_not_ok():
    """The cuboid's Jacobian at moves of up to 8% of its 0.025 m spacing
    has eigenvalues of both signs; its factor holds NaN at either block
    size, while moves of up to 0.8% keep it definite (the state of the
    card tests' factor checks)."""
    body, model, plan, f_sub = jax_model()
    st = port_state(body, model, plan, f_sub)
    for amp, ok in ((2e-4, True), (2e-3, False)):
        x = model.x0() + np.random.default_rng(4).uniform(-amp, amp,
                                                          plan.n)
        data, _, _ = jac_asm(st.asm, st.elems, st.asm.apply_in(x))
        for s in (64, 128):
            bp = pband.BandPlan(plan.csr_rowidx, plan.csr_cols, plan.n, s)
            band, _ = pband.band_assemble(bp, data)
            assert pband.band_factor_ok(pband.band_factor(bp, band)) == ok


@pytest.mark.parametrize("seed, n, half_bw", [(1, 100, 9), (3, 800, 61)])
def test_band_pad_rows_solve_to_zero(seed, n, half_bw):
    _, (rows, cols, vals) = random_system(seed, n, half_bw)
    plan = pband.BandPlan(rows, cols, n, 64)
    assert plan.nrow_tot > n
    band, _ = pband.band_assemble(plan, torch.as_tensor(vals))
    panels = pband.band_factor(plan, band)
    rhs = torch.zeros(plan.nrow_tot, dtype=torch.float64)
    rhs[:n] = torch.as_tensor(
        np.random.default_rng(seed).standard_normal(n))
    y = pband.band_tri_solve_plain(plan, panels, rhs)
    assert bool((y[n:] == 0.0).all())
    assert bool(torch.isfinite(y).all())


def test_band_factor_matches_dense_cholesky():
    """The panels against a dense Cholesky of the permuted, scaled matrix:
    inv(L[j,j]) and the subdiagonal blocks L[j+1+m, j]."""
    A, (rows, cols, vals) = random_system(3, 800, 61)
    plan = pband.BandPlan(rows, cols, 800, 64)
    band, scale = pband.band_assemble(plan, torch.as_tensor(vals))
    panels = pband.band_factor(plan, band)
    d = scale.numpy()
    M = np.eye(plan.nrow_tot)
    p = plan.perm_ext[:800]
    M[:800, :800] = -(d[:, None] * A.toarray() * d[None, :])[p][:, p]
    L = np.linalg.cholesky(M)
    s = plan.s
    for j in range(plan.nb):
        P = plan.panel(panels, j).numpy()
        blk = L[j * s:(j + 1) * s, j * s:(j + 1) * s]
        assert rel_err(P[0], np.linalg.inv(blk)) <= SOLVE_TOL
        for m in range(int(plan.blk_w[j])):
            r0 = (j + 1 + m) * s
            assert rel_err(P[1 + m], L[r0:r0 + s, j * s:(j + 1) * s]) <= (
                SOLVE_TOL), (j, m)
        # beyond the skyline reach the factor is exactly zero
        r0 = (j + 1 + int(plan.blk_w[j])) * s
        assert np.abs(L[r0:, j * s:(j + 1) * s]).max(initial=0.0) == 0.0


# K5c's persistent kernels (csrc/band.cu) walk BandPlan.row_lo forward and
# each panel's blocks from the farthest back; the backward kernel sums
# each column over SLICES row slices (rows k = q mod SLICES), kSubSlices.
SLICES = 4
WALK_TOL = 1e-13
# the ragged system's component sizes and half bandwidths (the card tests'
# too)
RAGGED = ([512, 256, 768], [300, 12, 150])


def band_tri_solve_walk(plan, panels, r):
    """The substitutions in the order of K5c's kernels, on the padded,
    permuted vector ``r``: block row i subtracts block (i, j) times y_j
    for j = row_lo[i] .. i-1 ascending, then y_i = inv_i r_i; block column
    j sums its blocks m = w_j-1 .. 0 times x_{j+1+m} per row slice, then
    x_j = inv_j^T (y_j - the slices in order)."""
    s = plan.s
    y = r.clone()
    for i in range(plan.nb):
        ri = r[i * s:(i + 1) * s]
        for j in range(int(plan.row_lo[i]), i):
            ri = ri - plan.panel(panels, j)[i - j] @ y[j * s:(j + 1) * s]
        y[i * s:(i + 1) * s] = plan.panel(panels, i)[0] @ ri
    x = y.clone()
    for j in reversed(range(plan.nb)):
        P = plan.panel(panels, j)
        acc = torch.zeros((SLICES, s), dtype=r.dtype)
        for m in reversed(range(int(plan.blk_w[j]))):
            xb = x[(j + 1 + m) * s:(j + 2 + m) * s]
            acc += (P[1 + m] * xb[:, None]).view(-1, SLICES, s).sum(0)
        t = y[j * s:(j + 1) * s]
        for q in range(SLICES):
            t = t - acc[q]
        x[j * s:(j + 1) * s] = t @ P[0]
    return x


def walk_systems():
    """(name, rows, cols, vals, n, s): the random systems at s = 64, a
    ragged one at s = 128 (components of 512, 256 and 768 unknowns: reach
    0-3, zero at the end of each) and one of a single block (n = 100, s =
    128)."""
    out = []
    for seed, n, half_bw in SYSTEMS:
        _, (rows, cols, vals) = random_system(seed, n, half_bw)
        out.append(("random%d" % seed, rows, cols, vals, n, 64))
    A = ragged_spd(*RAGGED, np.random.default_rng(9))
    out.append(("ragged", *coo_of(A), A.shape[0], 128))
    _, (rows, cols, vals) = random_system(1, 100, 9)
    out.append(("one block", rows, cols, vals, 100, 128))
    return out


@pytest.mark.parametrize("case", walk_systems(), ids=lambda c: c[0])
def test_row_reach_lists_each_block_rows_columns(case):
    """row_lo[i] .. i-1 are exactly the block columns whose skyline reach
    covers block row i."""
    name, rows, cols, _, n, s = case
    plan = pband.BandPlan(rows, cols, n, s)
    for i in range(plan.nb):
        touch = [j for j in range(i) if j + plan.blk_w[j] >= i]
        assert touch == list(range(int(plan.row_lo[i]), i)), (name, i)
    if name == "ragged":
        assert (plan.blk_w == 0).sum() >= 3
        assert len(np.unique(plan.blk_w)) >= 4
    if name == "one block":
        assert plan.nb == 1 and list(plan.row_lo) == [0]
    with pytest.raises(SANMError):
        pband.row_reach([0, 3, 0, 0])


def jax_panels(jp, plan, panels):
    """The port's flat panels in the JAX package's layout: per run of
    width wr, (ln, (wr + 1) s, s), zero past each column's own reach."""
    s = plan.s
    out = []
    for j0, ln, wr in jp.runs:
        cols = []
        for j in range(j0, j0 + ln):
            P = plan.panel(panels, j).numpy()
            full = np.zeros((wr + 1, s, s))
            full[:P.shape[0]] = P
            cols.append(full.reshape(-1, s))
        out.append(jnp.asarray(np.stack(cols)))
    return tuple(out)


@pytest.mark.parametrize("case", walk_systems(), ids=lambda c: c[0])
def test_band_walk_matches_plain_and_jax(monkeypatch, case):
    name, rows, cols, vals, n, s = case
    plan = pband.BandPlan(rows, cols, n, s)
    band, _ = pband.band_assemble(plan, torch.as_tensor(vals))
    panels = pband.band_factor(plan, band)
    r = torch.zeros(plan.nrow_tot, dtype=torch.float64)
    r[:n] = torch.as_tensor(np.random.default_rng(3).standard_normal(n))
    got = band_tri_solve_walk(plan, panels, r)
    want = pband.band_tri_solve_plain(plan, panels, r)
    assert rel_err(got.numpy(), want.numpy()) <= WALK_TOL
    assert bool((got[n:] == 0.0).all())
    jp = jax_plan(monkeypatch, rows, cols, n, s)
    assert np.array_equal(jp.blk_w, plan.blk_w)
    yj = jband.band_tri_solve(jp, jax_panels(jp, plan, panels),
                              jnp.asarray(r.numpy()))
    assert rel_err(got.numpy(), np.asarray(yj)) <= WALK_TOL


def test_band_walk_on_cuboid(monkeypatch):
    """The walk on the cuboid's Jacobian at a definite state, at both
    block sizes, against the plain version and the JAX package."""
    _, model, plan, f_sub = jax_model()
    body, _, _, _ = jax_model()
    st = port_state(body, model, plan, f_sub)
    x = model.x0() + np.random.default_rng(4).uniform(-2e-4, 2e-4, plan.n)
    data, _, _ = jac_asm(st.asm, st.elems, st.asm.apply_in(x))
    for s in (64, 128):
        bp = pband.BandPlan(plan.csr_rowidx, plan.csr_cols, plan.n, s)
        band, _ = pband.band_assemble(bp, data)
        panels = pband.band_factor(bp, band)
        r = torch.zeros(bp.nrow_tot, dtype=torch.float64)
        r[:plan.n] = torch.as_tensor(f_sub)
        got = band_tri_solve_walk(bp, panels, r)
        want = pband.band_tri_solve_plain(bp, panels, r)
        assert rel_err(got.numpy(), want.numpy()) <= WALK_TOL
        jp = jax_plan(monkeypatch, plan.csr_rowidx, plan.csr_cols, plan.n,
                      s)
        yj = jband.band_tri_solve(jp, jax_panels(jp, bp, panels),
                                  jnp.asarray(r.numpy()))
        assert rel_err(got.numpy(), np.asarray(yj)) <= WALK_TOL


def element_matvec_walk(asm, E, x):
    """A x in the order of K4's kernels: each entry's contraction in
    ascending j stored at its place in row order (``ent_pos``), then each
    row's stretch summed in ascending order."""
    xp = torch.zeros(asm.n + 2, dtype=torch.float64)
    xp[:asm.n] = x
    g = xp[asm.loc_cols.long()]
    c = torch.zeros((asm.B, asm.Dout), dtype=torch.float64)
    for j in range(asm.Din):
        c = c + E[:, :, j] * g[:, None, j]
    pos = asm.ent_pos.long()
    live = pos >= 0
    crow = torch.zeros(asm.n_live, dtype=torch.float64)
    crow[pos[live]] = c.reshape(-1)[live]
    ptr = asm.row_ptr.long()
    cnt = ptr[1:] - ptr[:-1]
    out = torch.zeros(asm.n_rows, dtype=torch.float64)
    for t in range(int(cnt.max())):
        m = cnt > t
        out[m] += crow[ptr[:-1][m] + t]
    return out


def test_ent_pos_inverts_the_row_gather_map():
    body, model, plan, f_sub = jax_model()
    asm = port_state(body, model, plan, f_sub).asm
    pos, ent = asm.ent_pos.numpy(), asm.row_ent.numpy()
    assert asm.n_live == ent.size == int(asm.row_ptr[-1])
    assert np.array_equal(pos[ent], np.arange(ent.size))
    dead = np.asarray(asm.loc_rows).reshape(-1) >= asm.n_rows
    assert np.array_equal(pos < 0, dead)


def test_element_matvec_walk_matches_plain_and_jax():
    body, model, plan, f_sub = jax_model()
    st = port_state(body, model, plan, f_sub)
    x0 = model.x0() + np.random.default_rng(5).uniform(-0.002, 0.002,
                                                       plan.n)
    _, _, E = jac_asm(st.asm, st.elems, st.asm.apply_in(x0))
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(plan.n))
    got = element_matvec_walk(st.asm, E, x)
    assert rel_err(got.numpy(), element_matvec(st.asm, E, x).numpy()) <= (
        WALK_TOL)
    want = plan.element_matvec(jnp.asarray(E.numpy()), jnp.asarray(x))
    assert rel_err(got.numpy(), np.asarray(want)) <= WALK_TOL


def test_element_matvec_walk_with_t_column():
    """Din = 13 (the deform plan's t column, read as zero) against the
    plain version and the JAX package's plan."""
    from test_torch_deform import deform_bodies, models

    jm, pm, plan = models(deform_bodies("all"), "neohookean_c")
    assert pm.asm.Din == 13
    xt0 = np.concatenate([pm.x0(), [0.37]])
    _, _, E = pm.jac_asm(pm.asm.apply_in(xt0))
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(pm.asm.n))
    got = element_matvec_walk(pm.asm, E, x)
    assert rel_err(got.numpy(), element_matvec(pm.asm, E, x).numpy()) <= (
        WALK_TOL)
    want = plan.element_matvec(jnp.asarray(E.numpy()), jnp.asarray(x))
    assert rel_err(got.numpy(), np.asarray(want)) <= WALK_TOL


def test_element_matvec_matches_jax():
    body, model, plan, f_sub = jax_model()
    st = port_state(body, model, plan, f_sub)
    rng = np.random.default_rng(5)
    x0 = model.x0() + rng.uniform(-0.002, 0.002, model.x0().shape)
    _, _, E = jac_asm(st.asm, st.elems, st.asm.apply_in(x0))
    for seed in (0, 1):
        x = np.random.default_rng(seed).standard_normal(plan.n)
        got = element_matvec(st.asm, E, torch.as_tensor(x))
        want = plan.element_matvec(jnp.asarray(E.numpy()), jnp.asarray(x))
        assert rel_err(got.numpy(), np.asarray(want)) <= MATVEC_TOL


def test_chol_refine_solve_matches_jax(monkeypatch):
    A, (rows, cols, vals) = random_system(0, 601, 37)
    n = 601
    b = np.random.default_rng(7).standard_normal(n) * 1e-20
    plan = pband.BandPlan(rows, cols, n, 64)
    data = torch.as_tensor(vals)
    band, scale = pband.band_assemble(plan, data)
    panels = pband.band_factor(plan, band)
    x, trips, rel = chol_refine_solve(
        lambda r: pband.band_solve(plan, panels, r), scale,
        torch.as_tensor(b), torch_matvec(rows, cols, data, n),
        with_resid=True)

    monkeypatch.setenv("SANM_BAND_S", "64")
    stub = _StubAssembler(A)
    jp = jband.BandPlan(rows, cols, n)
    Bb, sj = jband.assemble_band_scaled_neg(jp, stub, stub.data())
    xj, relj = jax_refine(jband.band_cholesky(jp, Bb), sj, stub.data(),
                          jnp.asarray(b), stub.matvec, 8,
                          tri_solve=jband.band_tri_solve_fn(jp),
                          with_resid=True)
    assert rel_err(scale.numpy(), np.asarray(sj)) <= 1e-15
    assert rel_err(x.numpy(), np.asarray(xj)) <= SOLVE_TOL
    assert float(rel) <= 1e-12 and float(relj) <= 1e-12
    assert trips <= 1
    # the fixed-trip form (rtol 0) runs every round
    _, trips0 = chol_refine_solve(
        lambda r: pband.band_solve(plan, panels, r), scale,
        torch.as_tensor(b), torch_matvec(rows, cols, data, n), 3, rtol=0.0)
    assert trips0 == 3


def solve_jax_band(fz, pen):
    from sanm_tpu.fea import DeformableBody
    from sanm_tpu.fea.app import RMS_THRESH_FORCE_EQU, run_anm_eqn
    from sanm_tpu.solver import ANMEqnSolver
    from sanm_tpu.solver.anm import EqnHyperParam

    body, model, plan, f_sub = jax_model(fz)
    hp = EqnHyperParam(order=20, use_pade=True, solver="band_chol",
                       xcoeff_l2_penalty=pen)
    hp.converge_rms = RMS_THRESH_FORCE_EQU
    hp.solution_check_tol = 1e-3
    s = ANMEqnSolver(model.fn, model.lt_inp.remap, model.lt_out.remap,
                     model.x0(), f_sub, hp)
    x = run_anm_eqn(s, progress=False)
    assert getattr(s, "_factor_gate_fails", 0) == 0
    return s, x, DeformableBody.compute_force_rms(model, x, f_sub)


@pytest.mark.parametrize("fz, pen", [(-200.0, 0.0), (-600.0, 0.0),
                                     (-1500.0, 0.0), (-600.0, 1e-3)])
def test_band_equilibrium_matches_jax(fz, pen):
    """The cuboid cases of ``tests/test_torch_slice.py`` with
    ``solver="band_chol"`` in both packages; with the l2 penalty both take
    host LU (band_chol refuses Tikhonov mode)."""
    sj, xj, rms_j = solve_jax_band(fz, pen)
    sp, xp, rms_p = solve_port(fz, pen, solver="band_chol")
    assert sp.get_nr_iter() == sj.get_nr_iter()
    assert rms_j <= RMS and rms_p <= RMS
    assert rel_err(xp, xj) <= COORD_RTOL
    assert [r["accepted"] for r in sp.pade_log] == [
        r["accepted"] for r in sj.pade_log]
    assert not any(sp.band_fallbacks.values())
    assert sp._solver_override is None
    mode = "host_lu" if pen else "band_chol"
    assert sp._solver_mode() == "band_chol" and sp._fact["mode"] == mode
    assert sp.solver_resolved() == mode
    assert sp.expansions[mode] == sp.get_nr_iter()
    if not pen:
        solver = sp._fact["solver"]
        assert solver.solves == 20 and solver.trips <= solver.solves


def test_band_pre_gate_falls_back_to_host_lu(monkeypatch):
    """An impossible pre-gate (``tests/test_sparse_solver.py:130-170``):
    host LU for the rest of the solve after one band solve, counted,
    still converging to the host-LU solution; ``reset`` clears the
    override."""
    monkeypatch.setattr(panm, "FACTOR_GATE", -1.0)
    sp, xp, rms = solve_port(-600.0, 0.0, solver="band_chol")
    assert sp._factor_gate_fails >= 1
    assert sp.band_fallbacks == {"gate": 1, "checks": 0, "not_finite": 0}
    assert sp._solver_override == "host_lu"
    assert sp._fact["mode"] == "host_lu"
    # the failed band expansion ran no order: host LU ran every one
    assert sp.expansions == {"band_chol": 0, "host_lu": sp.get_nr_iter()}
    assert sp.solver_resolved() == "host_lu"
    assert rms <= RMS
    sh, xh, _ = solve_port(-600.0, 0.0)
    assert sp.get_nr_iter() == sh.get_nr_iter()
    assert rel_err(xp, xh) <= COORD_RTOL
    # a warm re-solve starts on the band path again, and falls back again
    fails = sp._factor_gate_fails
    sp.reset()
    assert sp._factor_gate_fails == fails + 1
    monkeypatch.setattr(panm, "FACTOR_GATE", 1e-8)
    sp.reset()
    assert sp._solver_override is None and sp._fact["mode"] == "band_chol"


def test_band_factor_not_finite_hands_each_restart_to_host_lu(monkeypatch):
    """A band factor that is not finite hands its restart to host LU,
    counted, without the sticky override: every restart tries the band
    factor again."""
    monkeypatch.setattr(pband.DeviceBandCholSolver, "factor_ok",
                        lambda self: False)
    sp, xp, rms = solve_port(-600.0, 0.0, solver="band_chol")
    it = sp.get_nr_iter()
    assert sp.band_fallbacks == {"gate": 0, "checks": 0, "not_finite": it}
    assert sp._solver_override is None and sp._factor_gate_fails == 0
    assert sp.expansions == {"band_chol": 0, "host_lu": it}
    assert sp.solver_resolved() == "host_lu"
    assert rms <= RMS
    sh, xh, _ = solve_port(-600.0, 0.0)
    assert it == sh.get_nr_iter()
    assert rel_err(xp, xh) <= COORD_RTOL


def test_band_expansion_failing_checks_falls_back(monkeypatch):
    """A band expansion that passes the pre-gate but fails the order
    checks (here: a wrong operator in the sanity residual) is redone on
    host LU, which takes the rest of the solve (``anm.py:1320-1350``)."""
    monkeypatch.setattr(pband.DeviceBandCholSolver, "apply",
                        lambda self, x: self.matvec(x) * 2.0)
    sp, xp, rms = solve_port(-600.0, 0.0, solver="band_chol")
    assert sp.band_fallbacks == {"gate": 0, "checks": 1, "not_finite": 0}
    assert sp._factor_gate_fails == 1
    assert sp._solver_override == "host_lu"
    assert sp.expansions == {"band_chol": 1,
                             "host_lu": sp.get_nr_iter()}
    assert sp.solver_resolved() == "mixed"
    assert rms <= RMS


def test_host_lu_expansion_failing_checks_is_not_a_band_failure(
        monkeypatch):
    """After a non-finite band factor handed the restart to host LU, a
    failing host-LU expansion raises: it is not counted as a band failure
    and the same host-LU expansion is not run again."""
    monkeypatch.setattr(pband.DeviceBandCholSolver, "factor_ok",
                        lambda self: False)
    calls = []

    def bad_apply(self, x):
        calls.append(1)
        return torch.as_tensor(self.A @ x.numpy() * 2.0)

    monkeypatch.setattr(plinear.HostSparseLU, "apply", bad_apply)
    with pytest.raises(SANMNumericalError):
        solve_port(-600.0, 0.0, solver="band_chol")
    # one expansion of 19 checked orders, not two
    assert len(calls) == 19


def test_band_solver_refuses_penalty_and_unported_solvers():
    from sanm_tpu_torch import SANMError
    from sanm_tpu_torch.fea.app import setup_solver_param

    _, (rows, cols, vals) = random_system(1, 100, 9)
    plan = pband.BandPlan(rows, cols, 100, 64)
    with pytest.raises(SANMError):
        pband.DeviceBandCholSolver(plan, torch.as_tensor(vals), None,
                                   l2_penalty=1e-3)
    for name in ("band_chol", "dense", "dense_chol", "spike_band", "cg"):
        assert setup_solver_param({"solver": name}).solver == name
    with pytest.raises(SANMError, match="unknown solver"):
        setup_solver_param({"solver": "pardiso"})


def test_gravity_cli_band_chol(tmp_path, monkeypatch):
    """``python -m sanm_tpu_torch.fea --device cpu`` with a
    ``{"solver": "band_chol"}`` override against the JAX package's
    gravity with the same override."""
    from test_torch_slice import write_tiny_gravity

    task = write_tiny_gravity(tmp_path)
    (tmp_path / "band.json").write_text(json.dumps({"solver": "band_chol"}))
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("SANM_WARM_TIMING", None)
    res = subprocess.run(
        [sys.executable, "-m", "sanm_tpu_torch.fea", "--device", "cpu",
         "sys.json", "task.json", "band.json"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    port = json.loads((tmp_path / "tiny-i0-neohookean_c.json").read_text())
    assert port["solver_backend"] == "band_chol"
    assert port["solver_resolved"] == "band_chol"
    assert port["band_fallbacks"] == {"gate": 0, "checks": 0,
                                      "not_finite": 0}
    assert port["expansions"]["host_lu"] == 0
    assert port["force_rms_recomp"] <= RMS

    from sanm_tpu.fea.app import gravity

    jdir = tmp_path / "jax"
    jdir.mkdir()
    monkeypatch.chdir(jdir)
    monkeypatch.delenv("SANM_WARM_TIMING", raising=False)
    jstat = gravity(dict(task, solver="band_chol"), str(tmp_path)).stat
    assert jstat["solver_resolved"] == "band_chol"
    assert port["iter"] == jstat["iter"]
    assert abs(port["displacement"] - jstat["displacement"]) <= (
        COORD_RTOL * abs(jstat["displacement"]))
