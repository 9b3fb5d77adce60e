"""The port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``: they skip on a machine without a card.  Run them on the
card with ``python -m pytest tests/test_torch_card.py -m cuda -q``.
This file does not import JAX (the card machine has none); the plain
torch versions are the oracle, and they are held against the JAX package
by ``test_torch_kernels.py`` on the CPU.  Tolerance: 1e-12 relative to
the largest magnitude (f64 sums in another order, fused multiply-adds)."""

import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOL = 1e-12


@pytest.fixture
def models():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sanm_tpu_torch.fea import (DeformableBody, EnergyModel,
                                    MaterialProperty, TetrahedralMesh)

    out = {}
    for dev in ("cuda", "cpu"):
        mesh = TetrahedralMesh.make_cuboid(6, 4, 4, 0.025)
        body = DeformableBody(MaterialProperty.from_young_poisson(1e7, 0.45),
                              mesh)
        body.coord_fixed_mask[mesh.vertices[:, 0] <= 0.0125, :] = True
        out[dev] = body.make_forward(EnergyModel.NEOHOOKEAN_C, device=dev)
    return out


def rel(a, b):
    a, b = a.cpu(), b.cpu()
    return float((a - b).abs().max() / b.abs().max())


def test_remaps_and_jacobian(models):
    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.solver import assemble as K

    g, c = models["cuda"], models["cpu"]
    x = np.random.default_rng(0).standard_normal(g.asm.n + 1) * 1e-3
    x[: g.asm.n] += g.x0()
    n0 = dict(kernels.LAUNCHES)
    gin_g = g.asm.apply_in(x)
    gin_c = c.asm.apply_in(x)
    assert rel(gin_g, gin_c) <= TOL
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (g.asm.B, 9)))
    assert rel(g.asm.apply_out(b.cuda()), c.asm.apply_out(b)) <= TOL
    data_g, _, E_g = K.jac_asm(g.asm, g.elems, gin_g)
    data_c, _, E_c = K.jac_asm(c.asm, c.elems, gin_c)
    assert rel(E_g, E_c) <= TOL and rel(data_g, data_c) <= TOL
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["remap_in"] == n0["remap_in"] + 1
    assert kernels.LAUNCHES["remap_out"] == n0["remap_out"] + 1
    assert kernels.LAUNCHES["jac_asm"] == n0["jac_asm"] + 1


def test_nhc_series(models):
    from sanm_tpu_torch.ops.nhc_series import NHCSeries

    g, c = models["cuda"], models["cpu"]
    rng = np.random.default_rng(2)
    sg = NHCSeries(g.elems, 20)
    sc = NHCSeries(c.elems, 20)
    sg.start(g.asm.apply_in(g.x0()))
    sc.start(c.asm.apply_in(c.x0()))
    for k in range(1, 20):
        xk = rng.standard_normal(g.asm.n) * 1e-3 * 0.5 ** k
        bg = sg.step(k, g.asm.apply_in(xk))
        bc = sc.step(k, c.asm.apply_in(xk))
        assert rel(bg, bc) <= TOL, k
        assert rel(sg.hist[k], sc.hist[k]) <= TOL, k


# K4 and K5 against their plain versions.  Tolerances (relative to the
# largest magnitude): band_assemble 1e-14 (the same products; the scale
# is 1/sqrt on the card, rsqrt in torch), band_factor 1e-10 (f64 Cholesky
# and triangular inverses summed in another order, growing with the
# blocks' conditioning), band_solve 1e-12 and element_matvec 1e-12 (f64
# sums in another order).
BAND_TOL = {"band_assemble": 1e-14, "band_factor": 1e-10,
            "band_solve": 1e-12, "element_matvec": 1e-12}


def band_systems(models):
    """The cuboid's Jacobian at a perturbed state (cuda and cpu; moves of
    up to 1% of the 0.025 m spacing keep its stiffness definite) and a
    random SPD system of 800 unknowns, as (rows, cols, data_cuda,
    data_cpu, matvec_cuda, n)."""
    import torch_helper as th
    from sanm_tpu_torch.solver import assemble as K

    g, c = models["cuda"], models["cpu"]
    x = g.x0() + np.random.default_rng(4).uniform(-2e-4, 2e-4, g.asm.n)
    data_g, _, E_g = K.jac_asm(g.asm, g.elems, g.asm.apply_in(x))
    data_c, _, _ = K.jac_asm(c.asm, c.elems, c.asm.apply_in(x))
    out = [(g.asm.csr_rowidx, g.asm.csr_cols, data_g, data_c,
            lambda v: K.element_matvec(g.asm, E_g, v), g.asm.n)]
    A = th.random_sparse_spd(800, 61, np.random.default_rng(3))
    rows, cols, vals = th.coo_of(A)
    dg = torch.as_tensor(vals).cuda()
    out.append((rows, cols, dg, torch.as_tensor(vals),
                th.torch_matvec(rows, cols, dg, 800), 800))
    return out


def k5c_systems(models):
    """:func:`band_systems` plus two for the band solve's kernels: a
    ragged skyline (reach 0-3 blocks, zero at the end of each of three
    components) and a single block column (n = 100)."""
    import torch_helper as th

    out = band_systems(models)
    for A in (th.ragged_spd([512, 256, 768], [300, 12, 150],
                            np.random.default_rng(9)),
              th.random_sparse_spd(100, 9, np.random.default_rng(1))):
        rows, cols, vals = th.coo_of(A)
        dg = torch.as_tensor(vals).cuda()
        out.append((rows, cols, dg, torch.as_tensor(vals),
                    th.torch_matvec(rows, cols, dg, A.shape[0]), A.shape[0]))
    return out


def check_band_solve(K5, plan, panels, rhs):
    """K5c on the card against the plain version: within BAND_TOL, the
    pad rows of the permuted solution exact zeros, and a second call the
    same bits."""
    work = torch.empty(plan.nb * plan.s, dtype=torch.float64, device="cuda")
    y = K5.band_solve(plan, panels, rhs.cuda(), work=work)
    y_p = K5.band_solve_plain(plan, panels.cpu(), rhs.cpu())
    assert rel(y, y_p) <= BAND_TOL["band_solve"]
    assert bool((work[plan.n:] == 0.0).all())
    assert torch.equal(K5.band_solve(plan, panels, rhs.cuda()), y)
    return y


def test_band_kernels(models):
    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.solver import band as K5

    for rows, cols, data_g, data_c, mv, n in k5c_systems(models):
        plan = K5.BandPlan(rows, cols, n)
        n0 = dict(kernels.LAUNCHES)
        band_g, sc_g = K5.band_assemble(plan, data_g)
        band_c, sc_c = K5.band_assemble(plan, data_c)
        assert rel(band_g, band_c) <= BAND_TOL["band_assemble"]
        assert rel(sc_g, sc_c) <= BAND_TOL["band_assemble"]
        # both factors from the card's band
        band_p = band_g.cpu()
        pan_g = K5.band_factor(plan, band_g)
        pan_p = K5.band_factor_plain(plan, band_p)
        assert K5.band_factor_ok(pan_p) and K5.band_factor_ok(pan_g)
        assert rel(pan_g, pan_p) <= BAND_TOL["band_factor"]
        rhs = torch.as_tensor(np.random.default_rng(5).standard_normal(n))
        check_band_solve(K5, plan, pan_g, rhs)
        # the refined solver converges on the card
        solver = K5.DeviceBandCholSolver(plan, data_g, mv)
        x, res = solver.solve(rhs.cuda(), with_resid=True)
        assert float(res) <= 1e-12
        # the negated (indefinite) system gives NaN
        neg = K5.DeviceBandCholSolver(plan, -data_g, mv)
        assert not neg.factor_ok()
        torch.cuda.synchronize()
        for name, count in (("band_assemble", 3), ("band_factor", 3),
                            ("band_solve", 2)):
            assert kernels.LAUNCHES[name] >= n0[name] + count, name


def test_band_solve_error_word(models):
    """A set error word (what a timed-out wait leaves) stops the band
    solve's kernels at once and makes the call, or the solver, raise."""
    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.solver import band as K5
    from sanm_tpu_torch.utils import SANMError

    rows, cols, data_g, _, mv, n = band_systems(models)[1]
    plan = K5.BandPlan(rows, cols, n)
    band, scale = K5.band_assemble(plan, data_g)
    panels = K5.band_factor(plan, band)
    rhs = torch.as_tensor(np.random.default_rng(5).standard_normal(n)).cuda()
    err = torch.ones((1,), dtype=torch.int32, device="cuda")
    K5.band_solve(plan, panels, rhs, err=err)
    torch.cuda.synchronize()
    with pytest.raises(SANMError, match="timed out"):
        kernels.check_spin(err[0], "band_solve")
    solver = K5.DeviceBandCholSolver(plan, data_g, mv)
    solver.solve(rhs)
    solver.err.fill_(1)
    with pytest.raises(SANMError, match="timed out"):
        solver.solve(rhs)


@pytest.fixture(scope="module")
def armadillo():
    """armadillo-small NHC gravity on the card: the model, the Jacobian
    (data, E) at rest and the load."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sanm_tpu_torch.fea import app

    path = os.path.join(ROOT, "configs", "armadillo_small.json")
    cfg = app.read_json(path)
    body, f_full, _ = app.gravity_setup(cfg, os.path.dirname(path))
    model = body.make_forward(app.energy_model_of(cfg), device="cuda")
    data, _, E = model.jac_asm(model.asm.apply_in(model.x0()))
    return model, data, E, model.lt_inp.copy_vtx_values(f_full)


def test_band_solve_at_armadillo(armadillo):
    """K5c at armadillo-small's plan (298 block columns) on the scaled
    load and a random vector."""
    from sanm_tpu_torch.solver import band as K5

    model, data, _, f = armadillo
    asm = model.asm
    plan = K5.BandPlan(asm.csr_rowidx, asm.csr_cols, asm.n)
    band, scale = K5.band_assemble(plan, data)
    panels = K5.band_factor(plan, band)
    del band
    assert K5.band_factor_ok(panels)
    check_band_solve(K5, plan, panels,
                     torch.as_tensor(f, dtype=torch.float64).cuda() * scale)
    check_band_solve(K5, plan, panels, torch.as_tensor(
        np.random.default_rng(12).standard_normal(asm.n)))


def test_band_factor_indefinite_state(models):
    """The cuboid's Jacobian at moves of up to 8% of the spacing is
    indefinite: the kernel's factor, like the plain one, holds NaN."""
    from sanm_tpu_torch.solver import assemble as K
    from sanm_tpu_torch.solver import band as K5

    g = models["cuda"]
    x = g.x0() + np.random.default_rng(4).uniform(-2e-3, 2e-3, g.asm.n)
    data, _, _ = K.jac_asm(g.asm, g.elems, g.asm.apply_in(x))
    plan = K5.BandPlan(g.asm.csr_rowidx, g.asm.csr_cols, g.asm.n)
    band, _ = K5.band_assemble(plan, data)
    band_p = band.cpu()
    assert not K5.band_factor_ok(K5.band_factor(plan, band))
    assert not K5.band_factor_ok(K5.band_factor_plain(plan, band_p))


# K6 and K7 against their plain versions on the same systems as K5:
# factors within 1e-10 (K5b's tolerance), substitutions within 1e-12.
DIRECT_TOL = {"dense_factor": 1e-10, "dense_solve": 1e-12,
              "spike_rhs_solve": 1e-12, "spike_solve": 1e-12}


def test_dense_chol_kernels(models):
    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.solver import linear as K6
    from sanm_tpu_torch.solver.assemble import DensePlan, dense_assemble

    for rows, cols, data_g, data_c, mv, n in band_systems(models):
        plan = DensePlan(rows, cols, n)
        n0 = dict(kernels.LAUNCHES)
        M, _ = dense_assemble(plan, data_g)
        M_p = M.cpu()
        inv = K6.dense_factor(plan, M)
        inv_p = K6.dense_factor_plain(plan, M_p)
        assert K6.dense_factor_ok(inv) and K6.dense_factor_ok(inv_p)
        assert rel(torch.tril(M), torch.tril(M_p)) <= DIRECT_TOL[
            "dense_factor"]
        assert rel(inv, inv_p) <= DIRECT_TOL["dense_factor"]
        rhs = torch.as_tensor(np.random.default_rng(5).standard_normal(n))
        y = K6.dense_solve(plan, M, inv, rhs.cuda())
        y_p = K6.dense_solve_plain(plan, M.cpu(), inv.cpu(), rhs)
        assert rel(y, y_p) <= DIRECT_TOL["dense_solve"]
        solver = K6.DeviceCholSolver(plan, data_g, mv)
        _, res = solver.solve(rhs.cuda(), with_resid=True)
        assert float(res) <= 1e-12
        assert not K6.DeviceCholSolver(plan, -data_g, mv).factor_ok()
        torch.cuda.synchronize()
        for name, count in (("dense_factor", 3), ("dense_solve", 2)):
            assert kernels.LAUNCHES[name] >= n0[name] + count, name


@pytest.mark.parametrize("nparts", [2, 3])
def test_spike_kernels(models, nparts):
    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.solver import spike as K7

    for rows, cols, data_g, data_c, mv, n in band_systems(models):
        plan = K7.SpikePlan(rows, cols, n, nparts=nparts)
        assert plan.P == nparts
        n0 = dict(kernels.LAUNCHES)
        Bloc, C, _ = K7.spike_assemble(plan, data_g)
        panels = K7.spike_local_factor(plan, Bloc)
        R = torch.as_tensor(np.random.default_rng(6).standard_normal(
            (plan.P, plan.m, 128)))
        X = K7.spike_rhs_solve(plan, panels, R.cuda())
        X_p = K7.spike_rhs_solve_plain(plan, panels.cpu(), R)
        assert rel(X, X_p) <= DIRECT_TOL["spike_rhs_solve"]
        F = K7.spike_factor(plan, panels, C)
        assert F.ok()
        rhs = torch.as_tensor(np.random.default_rng(5).standard_normal(n))
        y = K7.spike_solve(plan, F, rhs.cuda())
        y_p = K7.spike_solve_plain(plan, F, rhs.cuda())
        assert rel(y, y_p) <= DIRECT_TOL["spike_solve"]
        solver = K7.DeviceSpikeBandSolver(plan, data_g, mv)
        _, res = solver.solve(rhs.cuda(), with_resid=True)
        assert float(res) <= 1e-12
        assert not K7.DeviceSpikeBandSolver(plan, -data_g, mv).factor_ok()
        torch.cuda.synchronize()
        for name, count in (("spike_rhs_solve", 3), ("spike_solve", 2)):
            assert kernels.LAUNCHES[name] >= n0[name] + count, name


def test_element_matvec(models):
    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.solver import assemble as K

    g, c = models["cuda"], models["cpu"]
    x = g.x0() + np.random.default_rng(6).uniform(-2e-3, 2e-3, g.asm.n)
    _, _, E_g = K.jac_asm(g.asm, g.elems, g.asm.apply_in(x))
    v = torch.as_tensor(np.random.default_rng(7).standard_normal(g.asm.n))
    n0 = kernels.LAUNCHES["element_matvec"]
    got = K.element_matvec(g.asm, E_g, v.cuda())
    want = K.element_matvec_plain(c.asm, E_g.cpu(), v)
    assert rel(got, want) <= BAND_TOL["element_matvec"]
    assert torch.equal(K.element_matvec(g.asm, E_g, v.cuda()), got)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["element_matvec"] == n0 + 2


def test_element_matvec_at_armadillo(armadillo):
    """K4 at armadillo-small (Din = 12) against the plain version,
    repeating its bits (Din = 13: test_deform_kernels)."""
    from sanm_tpu_torch.solver import assemble as K

    model, _, E, _ = armadillo
    asm = model.asm
    v = torch.as_tensor(
        np.random.default_rng(14).standard_normal(asm.n)).cuda()
    got = K.element_matvec(asm, E, v)
    assert rel(got, K.element_matvec_plain(asm, E, v)) <= BAND_TOL[
        "element_matvec"]
    assert torch.equal(K.element_matvec(asm, E, v), got)


# K8a-c (ARAP) against their plain versions.  Tolerances (relative to the
# largest magnitude): svd_w 1e-12 on s, W and the stretch U diag(s) U^T
# (U alone is not unique where singular values nearly tie), with no
# element whose flip choice differs, and 1e-10 where elements flip (a
# single flipped member of a pair closer than GROUP_EPS makes W depend on
# that pair's columns of U, fixed only to about 1e-16 / their gap);
# arap_step 1e-11 per order (f64 sums in another order, with fused
# multiply-adds, through 19 orders of recurrences); jac_asm_arap 1e-12.
ARAP_TOL = {"svd_w": 1e-12, "svd_w_flipped": 1e-10, "arap_step": 1e-11,
            "jac_asm_arap": 1e-12}


@pytest.fixture
def arap_models():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sanm_tpu_torch.fea import (DeformableBody, EnergyModel,
                                    MaterialProperty, TetrahedralMesh)

    out = {}
    for dev in ("cuda", "cpu"):
        mesh = TetrahedralMesh.make_cuboid(6, 4, 4, 0.025)
        body = DeformableBody(MaterialProperty.from_young_poisson(1e7, 0.45),
                              mesh)
        body.coord_fixed_mask[mesh.vertices[:, 0] <= 0.0125, :] = True
        out[dev] = body.make_forward(EnergyModel.ARAP, device=dev)
    return out


def svd_w_errors(m_cuda):
    """Kernel vs plain svd_w on the same card tensor: the largest
    relative error of s, W and U diag(s) U^T, and the number of elements
    whose flip choice (the signs of s) differs."""
    from sanm_tpu_torch.ops import svd_w as K8a

    u, s, w = K8a.svd_w(m_cuda)
    pu, ps, pw = K8a.svd_w_plain(m_cuda)

    def stretch(u, s):
        return (u * s.abs()[:, None, :]) @ u.transpose(1, 2)

    err = max(rel(s, ps), rel(w, pw), rel(stretch(u, s), stretch(pu, ps)))
    flips = int(((s < 0) != (ps < 0)).any(dim=1).sum())
    return err, flips


def test_svd_w(arap_models):
    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.ops import svd_w as K8a
    from sanm_tpu_torch.utils import SANMError

    g = arap_models["cuda"]
    x = g.x0() + np.random.default_rng(8).uniform(-2e-3, 2e-3, g.asm.n)
    F = g.elems.deformation_gradient(g.asm.apply_in(x))
    n0 = kernels.LAUNCHES["svd_w"]
    refl = F.clone()
    refl[:, 0, :] *= -1  # det < 0: every element needs its flip
    rng = np.random.default_rng(9)
    rand = torch.as_tensor(rng.standard_normal((4096, 3, 3))).cuda()
    for m in (F, refl, rand):
        err, flips = svd_w_errors(m.contiguous())
        tol = ARAP_TOL["svd_w" if m is F else "svd_w_flipped"]
        assert err <= tol and flips == 0
    with pytest.raises(SANMError):  # the kernel always flips
        K8a.svd_w(F, False)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["svd_w"] == n0 + 3


def test_arap_series(arap_models):
    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.ops.arap_series import ARAPSeries

    g, c = arap_models["cuda"], arap_models["cpu"]
    rng = np.random.default_rng(10)
    x0 = g.x0() + rng.uniform(-1e-3, 1e-3, g.asm.n)
    sg = ARAPSeries(g.elems, 20)
    sc = ARAPSeries(c.elems, 20)
    sg.start(g.asm.apply_in(x0))
    sc.start(c.asm.apply_in(x0))
    n0 = kernels.LAUNCHES["arap_step"]
    for k in range(1, 20):
        xk = rng.standard_normal(g.asm.n) * 1e-3 * 0.5 ** k
        bg = sg.step(k, g.asm.apply_in(xk))
        bc = sc.step(k, c.asm.apply_in(xk))
        assert rel(bg, bc) <= ARAP_TOL["arap_step"], k
        assert rel(sg.hist[k], sc.hist[k]) <= ARAP_TOL["arap_step"], k
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["arap_step"] == n0 + 19


def test_arap_jacobian(arap_models):
    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.ops.svd_w import svd_w
    from sanm_tpu_torch.solver import assemble as K

    g = arap_models["cuda"]
    x = g.x0() + np.random.default_rng(11).uniform(-2e-3, 2e-3, g.asm.n)
    F = g.elems.deformation_gradient(g.asm.apply_in(x))
    u, s, w = svd_w(F)
    n0 = kernels.LAUNCHES["jac_asm_arap"]
    data, _, E = K.jac_asm_arap(g.asm, g.elems, u, s, w)
    data_p, _, E_p = K.jac_asm_arap_plain(g.asm, g.elems, u, s, w)
    assert rel(E, E_p) <= ARAP_TOL["jac_asm_arap"]
    assert rel(data, data_p) <= ARAP_TOL["jac_asm_arap"]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["jac_asm_arap"] == n0 + 1


# K1n and K3n (NHI) against their plain versions.  Tolerances (relative to
# the largest magnitude): nhi_step 1e-11 per order (f64 sums in another
# order, with fused multiply-adds, through 19 orders of recurrences; the
# power recurrence divides by J_0 at every order); jac_asm_nhi 1e-12.
NHI_TOL = {"nhi_step": 1e-11, "jac_asm_nhi": 1e-12}


@pytest.fixture
def nhi_models():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sanm_tpu_torch.fea import (DeformableBody, EnergyModel,
                                    MaterialProperty, TetrahedralMesh)

    out = {}
    for dev in ("cuda", "cpu"):
        mesh = TetrahedralMesh.make_cuboid(6, 4, 4, 0.025)
        body = DeformableBody(MaterialProperty.from_young_poisson(1e7, 0.45),
                              mesh)
        body.coord_fixed_mask[mesh.vertices[:, 0] <= 0.0125, :] = True
        out[dev] = body.make_forward(EnergyModel.NEOHOOKEAN_I, device=dev)
    return out


def test_nhi_series(nhi_models):
    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.ops.nhi_series import GROUPS, NHISeries

    g, c = nhi_models["cuda"], nhi_models["cpu"]
    rng = np.random.default_rng(12)
    x0 = g.x0() + rng.uniform(-1e-3, 1e-3, g.asm.n)
    sg = NHISeries(g.elems, 20)
    sc = NHISeries(c.elems, 20)
    n0 = kernels.LAUNCHES["nhi_step"]
    sg.start(g.asm.apply_in(x0))
    sc.start(c.asm.apply_in(x0))
    for k in range(1, 20):
        xk = rng.standard_normal(g.asm.n) * 1e-3 * 0.5 ** k
        bg = sg.step(k, g.asm.apply_in(xk))
        bc = sc.step(k, c.asm.apply_in(xk))
        assert rel(bg, bc) <= NHI_TOL["nhi_step"], k
        for sl in GROUPS:
            assert rel(sg.hist[k, sl], sc.hist[k, sl]) \
                <= NHI_TOL["nhi_step"], (k, sl)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["nhi_step"] == n0 + 20


def test_nhi_jacobian(nhi_models):
    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.solver import assemble as K

    g = nhi_models["cuda"]
    x = g.x0() + np.random.default_rng(13).uniform(-2e-3, 2e-3, g.asm.n)
    gin = g.asm.apply_in(x)
    n0 = kernels.LAUNCHES["jac_asm_nhi"]
    data, _, E = K.jac_asm_nhi(g.asm, g.elems, gin)
    data_p, _, E_p = K.jac_asm_nhi_plain(g.asm, g.elems, gin)
    assert rel(E, E_p) <= NHI_TOL["jac_asm_nhi"]
    assert rel(data, data_p) <= NHI_TOL["jac_asm_nhi"]
    assert g.jac_asm(gin)[0].shape == data.shape
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["jac_asm_nhi"] == n0 + 2


# The deform slice: K3t (grad_t) for the three materials, and K2
# remap_in, the Jacobians (K3, K3n, K8c) and K4 at Din = 13.  A far-face
# delta alone keeps Din = 12 (an element that reads t has a fixed
# vertex); a delta on every vertex, which the remap takes as well, gives
# the elements with four free vertices a 13th column.
@pytest.fixture(params=["neohookean_c", "neohookean_i", "arap"])
def deform_models(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sanm_tpu_torch.fea import (DeformableBody, EnergyModel,
                                    MaterialProperty, TetrahedralMesh)

    h = 0.025
    rng = np.random.default_rng(9)
    out = {}
    for dev in ("cuda", "cpu"):
        mesh = TetrahedralMesh.make_cuboid(6, 4, 4, h)
        body = DeformableBody(MaterialProperty.from_young_poisson(1e7, 0.45),
                              mesh)
        vx = mesh.vertices[:, 0]
        body.coord_fixed_mask[(vx <= h / 2) | (vx >= 4.5 * h), :] = True
        if dev == "cuda":
            delta = rng.uniform(-0.1, 0.1, mesh.vertices.shape) * h
        out[dev] = body.make_forward(EnergyModel.from_name(request.param),
                                     vtx_delta=delta, device=dev)
    return out


def test_deform_kernels(deform_models):
    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.solver import assemble as K

    g, c = deform_models["cuda"], deform_models["cpu"]
    assert g.asm.Din == 13 and g.asm.has_t
    xt = np.concatenate([g.x0(), [0.37]])
    n0 = dict(kernels.LAUNCHES)
    gin_g = K.remap_in(g.asm, g.asm.pad_vector(xt))
    gin_c = K.remap_in_plain(c.asm, c.asm.pad_vector(xt))
    assert rel(gin_g, gin_c) <= TOL
    data_g, gt_g, E_g = g.jac_asm(gin_g)
    data_c, gt_c, E_c = c.jac_asm(gin_c)
    assert gt_g.shape == (g.asm.n_rows,) and float(gt_c.abs().max()) > 0
    for a, b in ((data_g, data_c), (gt_g, gt_c), (E_g, E_c)):
        assert rel(a, b) <= TOL
    assert rel(K.grad_t(g.asm, E_g), K.grad_t_plain(c.asm, E_c)) <= TOL
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(g.asm.n))
    y = K.element_matvec(g.asm, E_g, x.cuda())
    assert rel(y, K.element_matvec_plain(c.asm, E_c, x)) <= TOL
    assert torch.equal(K.element_matvec(g.asm, E_g, x.cuda()), y)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["remap_in"] == n0["remap_in"] + 1
    assert kernels.LAUNCHES["grad_t"] == n0["grad_t"] + 2
    assert kernels.LAUNCHES["element_matvec"] == n0["element_matvec"] + 2


# The inverse slice: K1i and K3i for NHC and NHI against their plain
# versions on the 225-tet cuboid's inverse model at a perturbed rest
# state (at the given mesh F = I, and half of the terms vanish).
# Tolerances: inv_*_step 1e-11 (every order divides by det Dm_0, NHI's
# also by J_0, through 19 orders of recurrences), jac_asm_inv* 1e-12.
INV_TOL = {"step": 1e-11, "jac": 1e-12}


@pytest.fixture(params=["neohookean_c", "neohookean_i"])
def inv_models(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sanm_tpu_torch.fea import (DeformableBody, EnergyModel,
                                    MaterialProperty, TetrahedralMesh)

    out = {}
    for dev in ("cuda", "cpu"):
        mesh = TetrahedralMesh.make_cuboid(6, 4, 4, 0.025)
        body = DeformableBody(MaterialProperty.from_young_poisson(1e7, 0.45),
                              mesh)
        body.coord_fixed_mask[mesh.vertices[:, 0] <= 0.0125, :] = True
        out[dev] = body.make_inverse(EnergyModel.from_name(request.param),
                                     device=dev)
    return request.param, out


def test_inverse_series(inv_models):
    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.ops import inv_series as K1i

    em, models = inv_models
    mat = "nhc" if em == "neohookean_c" else "nhi"
    g, c = models["cuda"], models["cpu"]
    rng = np.random.default_rng(14)
    x0 = g.x0() + rng.uniform(-1e-3, 1e-3, g.asm.n)
    sg, sc = g.series(20), c.series(20)
    counter = "inv_%s_step" % mat
    n0 = kernels.LAUNCHES[counter]
    sg.start(g.asm.apply_in(x0))
    sc.start(c.asm.apply_in(x0))
    for k in range(1, 20):
        xk = rng.standard_normal(g.asm.n) * 1e-3 * 0.5 ** k
        bg = sg.step(k, g.asm.apply_in(xk))
        bc = sc.step(k, c.asm.apply_in(xk))
        assert rel(bg, bc) <= INV_TOL["step"], k
        for sl in K1i.GROUPS[mat]:
            assert rel(sg.hist[k, sl], sc.hist[k, sl]) \
                <= INV_TOL["step"], (k, sl)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[counter] == n0 + 20


def test_inverse_jacobian(inv_models):
    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.solver import assemble as K

    em, models = inv_models
    g = models["cuda"]
    name = "jac_asm_inv" if em == "neohookean_c" else "jac_asm_inv_nhi"
    x = g.x0() + np.random.default_rng(15).uniform(-2e-3, 2e-3, g.asm.n)
    gin = g.asm.apply_in(x)
    n0 = kernels.LAUNCHES[name]
    data, _, E = getattr(K, name)(g.asm, g.elems, gin)
    data_p, _, E_p = getattr(K, name + "_plain")(g.asm, g.elems, gin)
    assert rel(E, E_p) <= INV_TOL["jac"]
    assert rel(data, data_p) <= INV_TOL["jac"]
    assert g.jac_asm(gin)[0].shape == data.shape
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == n0 + 2


HESS_TOL = 1e-11  # K10: Jacobi against torch's eigh, D+ unique


@pytest.fixture(params=["neohookean_c", "neohookean_i", "arap"])
def hess_model(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sanm_tpu_torch.fea import (DeformableBody, EnergyModel,
                                    MaterialProperty, TetrahedralMesh)

    mesh = TetrahedralMesh.make_cuboid(6, 4, 4, 0.025)
    body = DeformableBody(MaterialProperty.from_young_poisson(1e7, 0.45),
                          mesh)
    body.coord_fixed_mask[mesh.vertices[:, 0] <= 0.0125, :] = True
    return body.make_forward(EnergyModel.from_name(request.param),
                             device="cuda")


def test_hess_proj(hess_model):
    """K10 against its plain version on the same card tensors, at rest
    (degenerate spectra), squashed (indefinite) and at a random state;
    an inverted state gives non-finite blocks."""
    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.solver import assemble as K

    g = hess_model
    asm, elems = g.asm, g.elems
    name = {"neohookean_c": "hess_proj", "neohookean_i": "hess_proj_nhi",
            "arap": "hess_proj_arap"}[g.energy_model.value]
    verts = g.lt_inp.mesh.vertices
    free = ~g.lt_inp.fixed_mask
    rng = np.random.default_rng(16)
    squashed = verts * np.array([1.0, 1.0, 0.4])
    n0 = kernels.LAUNCHES[name]
    for x in (verts[free], squashed[free],
              verts[free] + rng.uniform(-2e-3, 2e-3, asm.n)):
        gin = asm.apply_in(x)
        if name == "hess_proj_arap":
            from sanm_tpu_torch.ops.svd_w import svd_w

            args = svd_w(elems.deformation_gradient(gin))
        else:
            args = (gin,)
        data, E = getattr(K, name)(asm, elems, *args)
        data_p, E_p = getattr(K, name + "_plain")(asm, elems, *args)
        assert rel(E, E_p) <= HESS_TOL
        assert rel(data, data_p) <= HESS_TOL
    assert g.hess_proj(gin)[0].shape == data.shape
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == n0 + 4
    if name != "hess_proj_arap":
        bad = verts.copy()
        bad[bad[:, 0] > 0.1, 0] = 0.0  # the far layers past x = 0: J < 0
        _, E = g.hess_proj(asm.apply_in(bad[free]))
        assert not bool(torch.isfinite(E).all())


# K4 COO and K9 (the cg solver) against their plain versions on the
# 225-tet cuboid's Jacobian at a displaced state.  Tolerances (relative to
# the largest magnitude): the products 1e-13 (f64 sums of the same
# products in another order); diag_blocks equal (a gather); one PCG
# iteration 1e-12; a whole solve's x 1e-10 (both stop at a 1e-13
# residual; the iterates in between are not compared: CG carries each
# iteration's rounding into every later direction, and on this displaced
# state a perturbation of b in its last bits moves the 64th iterate
# visibly).
CG_TOL = {"products": 1e-13, "step": 1e-12, "solve": 1e-10}


def test_cg_kernels(models):
    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.solver import assemble as K
    from sanm_tpu_torch.solver import linear as L

    g, c = models["cuda"], models["cpu"]
    x = g.x0() + np.random.default_rng(8).uniform(-2e-3, 2e-3, g.asm.n)
    data_g, _, _ = K.jac_asm(g.asm, g.elems, g.asm.apply_in(x))
    data_c = data_g.cpu()
    csr_g, csr_c = g.asm.csr_maps, c.asm.csr_maps
    v = torch.as_tensor(np.random.default_rng(9).standard_normal(g.asm.n))
    n0 = dict(kernels.LAUNCHES)
    for fn, plain in ((K.csr_matvec, K.csr_matvec_plain),
                      (K.csr_matvec_t, K.csr_matvec_t_plain)):
        got = fn(csr_g, data_g, v.cuda())
        assert rel(got, plain(csr_c, data_c, v)) <= CG_TOL["products"]
    blocks = K.diag_blocks(csr_g, data_g)
    assert torch.equal(blocks.cpu(), K.diag_blocks_plain(csr_c, data_c))
    cg = L.SparseCG(csr_g, data_g)
    tol = L.SparseCG.TOL
    st = L.PCGState(v.cuda(), cg.binv)
    sp = L.PCGState(v, cg.binv.cpu())
    L.pcg_chunk(csr_g, data_g, cg.binv, st, 1, tol)
    L.pcg_chunk_plain(csr_c, data_c, cg.binv.cpu(), sp, 1, tol)
    for name in ("x", "r", "z", "p", "S"):
        assert rel(getattr(st, name), getattr(sp, name)) <= CG_TOL["step"]
    got = cg.solve(v.cuda())
    want = L.SparseCG(csr_c, data_c).solve(v)
    assert rel(got, want) <= CG_TOL["solve"]
    torch.cuda.synchronize()
    for name in ("csr_matvec", "csr_matvec_t", "diag_blocks", "pcg_step"):
        assert kernels.LAUNCHES[name] > n0[name], name
