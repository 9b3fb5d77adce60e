"""The NHI slice of the port against the JAX package, on the CPU.

Both packages get the same inputs, made with NumPy from a seed.  On the
CPU each wrapper runs its plain torch version, which is the oracle of
its CUDA kernel on the card (K1n ``nhi_step``, K3n ``jac_asm_nhi``).
Tolerances, relative to the largest magnitude of each compared array:

* ``pk1`` 1e-12: the same closed forms (J^(-2/3) through ``pow``), sums
  in another order;
* the series 1e-11 at every order 1..20 (the power recurrence divides by
  J_0 at every order, so rounding grows with the order);
* the Jacobian and its assembly 1e-12 (closed form against JAX's
  forward-mode ``batched_jacobian``);
* forces: 1e-10 against the JAX model's ``eval_force``, and 1e-8 per
  entry against the torch autograd gradient of the energy, as
  ``tests/test_fea.py::test_force_vs_energy_grad``;
* equilibria: same restarts, force-RMS <= 1e-10 (the paper's target),
  coordinates within 1e-9 of the largest coordinate, the relative
  displacement of the gravity task within 1e-9 relative (both stop at
  force-RMS 1e-10 from the same restarts with f64 solves).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helper import require_tensor_eq, tensor_rng
from sanm_tpu.fea import EnergyModel
from sanm_tpu.fea import MaterialProperty as JaxMaterial
from sanm_tpu.fea.material import pk1 as jax_pk1
from sanm_tpu.taylor import TaylorFn, batched_jacobian
from sanm_tpu_torch.fea import EnergyModel as PortEnergyModel
from sanm_tpu_torch.fea import MaterialProperty as PortMaterial
from sanm_tpu_torch.fea.material import pk1
from sanm_tpu_torch.ops.nhi_series import (NHISeries, committed_output,
                                           nhi_step)
from sanm_tpu_torch.solver.assemble import (jac_asm_nhi, nhi_jacobian_plain,
                                            remap_in, remap_in_plain)
from test_torch_arap import CONFIGS, _jax_gravity, _port_cli
from torch_helper import jax_model, port_state, rel_err

PK1_TOL = 1e-12
SERIES_TOL = 1e-11
JAC_TOL = 1e-12
FORCE_TOL = 1e-10
COORD_RTOL = 1e-9
RMS = 1e-10
ORDER = 20
NHI = EnergyModel.NEOHOOKEAN_I


def deformation_cases():
    """(name, (B, 3, 3) matrices with det > 0)."""
    rng = np.random.default_rng(5)
    near = np.eye(3) + 0.05 * rng.standard_normal((64, 3, 3))
    rand = tensor_rng((64, 3, 3), seed=200)
    rand[np.linalg.det(rand) < 0, 0] *= -1
    # stretched and compressed: singular values 0.3 .. 3
    q1 = np.linalg.qr(rng.standard_normal((32, 3, 3)))[0]
    q2 = np.linalg.qr(rng.standard_normal((32, 3, 3)))[0]
    s = rng.uniform(0.3, 3.0, (32, 3))
    big = np.einsum("bij,bj,bkj->bik", q1, s, q2)
    big[np.linalg.det(big) < 0, 0] *= -1
    return [("near_identity", near), ("random", rand), ("stretched", big)]


@pytest.mark.parametrize("case", deformation_cases(), ids=lambda c: c[0])
def test_nhi_pk1_matches_jax(case):
    _, F = case
    assert (np.linalg.det(F) > 0).all()
    E, nu = 3.68e6, 0.45
    want = np.asarray(jax_pk1(NHI, JaxMaterial.from_young_poisson(E, nu),
                              jnp.asarray(F), 3))
    got = pk1(PortEnergyModel.NEOHOOKEAN_I,
              PortMaterial.from_young_poisson(E, nu), torch.as_tensor(F), 3)
    assert got.shape == F.shape
    assert rel_err(got.numpy(), want) <= PK1_TOL


@pytest.fixture(scope="module")
def nhi_cuboid():
    body, model, plan, f_sub = jax_model(energy_model=NHI)
    st = port_state(body, model, plan, f_sub)
    T = body.mesh.nr_tet
    tfn = TaylorFn(model.fn, jax.ShapeDtypeStruct((T, 3, 3), jnp.float64))
    return body, model, plan, st, tfn


def perturbed_x0(model, seed=3):
    rng = np.random.default_rng(seed)
    return model.x0() + rng.uniform(-0.002, 0.002, model.x0().shape)


def test_nhi_series_matches_taylor_engine(nhi_cuboid):
    """Per-order biases and commits of K1n's plain version at every order
    1..20 on a perturbed state of the 225-tet cuboid, against the JAX
    TaylorEngine of the model's NHI graph; the order-1 bias is zero in
    both, and the affine invariant P_k = J g_k + b_k holds with the
    port's Jacobian."""
    body, model, plan, st, tfn = nhi_cuboid
    rng = np.random.default_rng(11)
    x0 = perturbed_x0(model)
    T = body.mesh.nr_tet
    eng = tfn.engine()
    P0 = eng.start(model.lt_inp.remap.apply(jnp.asarray(x0)))
    series = NHISeries(st.elems, ORDER)
    gin0 = remap_in(st.asm, st.asm.pad_vector(x0))
    series.start(gin0)
    assert not torch.count_nonzero(series.bias_out)
    assert rel_err(committed_output(series.hist, 0, st.elems).numpy(),
                   np.asarray(P0).reshape(T, 9)) <= PK1_TOL
    J = nhi_jacobian_plain(st.elems, gin0).numpy()
    bias = series.bias_out.clone()
    for k in range(1, ORDER + 1):
        b_j = eng.order_bias()
        if k == 1:
            assert b_j is None
        else:
            assert rel_err(bias.numpy(), np.asarray(b_j).reshape(T, 9)) \
                <= SERIES_TOL, "bias order %d" % k
        x_k = rng.standard_normal(x0.size) * 1e-3 * 0.5 ** k
        P_j = eng.push(model.lt_inp.remap.apply(jnp.asarray(x_k)))
        gin_k = remap_in(st.asm, st.asm.pad_vector(x_k))
        b_k = bias
        if k < ORDER:
            bias = series.step(k, gin_k).clone()
        else:
            nhi_step(series.hist, k, gin_k, st.elems)
        pk = committed_output(series.hist, k, st.elems).numpy()
        assert rel_err(pk, np.asarray(P_j).reshape(T, 9)) <= SERIES_TOL, \
            "commit order %d" % k
        lin = np.einsum("boi,bi->bo", J, gin_k.numpy())
        assert rel_err(lin + b_k.numpy(), pk) <= SERIES_TOL, \
            "affine invariant at order %d" % k


@pytest.mark.parametrize("perturb", [False, True])
def test_nhi_jacobian_matches_batched_jacobian(nhi_cuboid, perturb):
    body, model, plan, st, tfn = nhi_cuboid
    x = perturbed_x0(model) if perturb else model.x0()
    gin0 = model.lt_inp.remap.apply(jnp.asarray(x))
    J = batched_jacobian(lambda g: tfn(g), gin0)
    data_j, gt_j, E_j = plan.assemble_csr_elem(J)
    assert gt_j is None
    gin = remap_in(st.asm, st.asm.pad_vector(x))
    Jp = nhi_jacobian_plain(st.elems, gin)
    assert rel_err(Jp.numpy(), np.asarray(J).reshape(Jp.shape)) <= JAC_TOL
    data, _, E = jac_asm_nhi(st.asm, st.elems, gin)
    assert E.shape == E_j.shape and data.shape == data_j.shape
    assert rel_err(E.numpy(), np.asarray(E_j)) <= JAC_TOL
    assert rel_err(data.numpy(), np.asarray(data_j)) <= JAC_TOL


# ---------------------------------------------------------------------------
# forces
# ---------------------------------------------------------------------------


def cuboid_bodies(E=1e7, nu=0.45):
    """``tests/test_fea.py``'s 3x2x2 cuboid body in both packages."""
    from sanm_tpu import fea as jfea
    from sanm_tpu_torch import fea as pfea

    out = []
    for fea in (jfea, pfea):
        mesh = fea.TetrahedralMesh.make_cuboid(3, 2, 2, 0.025)
        body = fea.DeformableBody(
            fea.MaterialProperty.from_young_poisson(E, nu), mesh)
        body.coord_fixed_mask[mesh.vertices[:, 0] <= 0.0125, :] = True
        out.append(body)
    return out


def bar_bodies():
    """``configs/bar.json``'s mesh and material in both packages, its
    lowest vertices fixed."""
    from sanm_tpu import fea as jfea
    from sanm_tpu_torch import fea as pfea

    base = os.path.join(CONFIGS, "model", "beam3_tet.1")
    out = []
    for fea in (jfea, pfea):
        mesh = fea.TetrahedralMesh.from_tetgen_files(base)
        body = fea.DeformableBody(
            fea.MaterialProperty.from_young_poisson(680000, 0.45), mesh)
        y = mesh.vertices[:, 1]
        body.coord_fixed_mask[y <= y.min() + 0.01 * np.ptp(y), :] = True
        out.append(body)
    return out


@pytest.mark.parametrize("em", ["neohookean_c", "neohookean_i"])
def test_force_vs_energy_grad(em):
    """Port of ``tests/test_fea.py::test_force_vs_energy_grad`` for NHC
    and NHI: the port's nodal forces equal minus the torch autograd
    gradient of the total elastic energy on the cuboid."""
    _, body = cuboid_bodies()
    model = body.make_forward(PortEnergyModel.from_name(em), device="cpu")
    mat = body.material
    mu, lam, k = mat.shear_modulus, mat.lame_first, mat.bulk_modulus
    vols = torch.as_tensor(body.mesh.tet_volumes)
    asm, el = model.asm, model.elems

    def energy(x):
        xp = torch.cat([x, torch.zeros(2, dtype=x.dtype)])
        F = el.deformation_gradient(remap_in_plain(asm, xp))
        J = torch.linalg.det(F)
        Ic = (F * F).sum((1, 2))
        if em == "neohookean_c":
            psi = mu / 2 * (Ic - 3) - mu * torch.log(J) \
                + lam / 2 * torch.log(J) ** 2
        else:  # psi = mu/2 (J^{-2/3} Ic - 3) + k/2 (J - 1)^2
            psi = mu / 2 * (J ** (-2.0 / 3.0) * Ic - 3) + k / 2 * (J - 1) ** 2
        return (psi * vols).sum()

    rng = np.random.default_rng(3)
    x = model.x0() + rng.uniform(-0.002, 0.002, model.x0().shape)
    xt = torch.tensor(x, requires_grad=True)
    (grad,) = torch.autograd.grad(energy(xt), xt)
    force = model.eval_force(x)
    require_tensor_eq(force, -grad.numpy(), 1e-8,
                      msg="force vs -dE/dx (%s)" % em)


@pytest.mark.parametrize("em", ["neohookean_c", "neohookean_i"])
@pytest.mark.parametrize("mesh", ["cuboid", "bar"])
def test_eval_force_matches_jax(mesh, em):
    jbody, pbody = cuboid_bodies() if mesh == "cuboid" else bar_bodies()
    jm = jbody.make_forward(EnergyModel.from_name(em))
    pm = pbody.make_forward(PortEnergyModel.from_name(em), device="cpu")
    rng = np.random.default_rng(4)
    x0 = jm.x0()
    assert np.array_equal(x0, pm.x0())
    # a few percent of the smallest element's size: no element inverts
    h = float(pbody.mesh.tet_volumes.min()) ** (1.0 / 3.0)
    x = x0 + rng.uniform(-0.03, 0.03, x0.shape) * h
    want = np.asarray(jm.eval_force(jnp.asarray(x)))
    assert rel_err(pm.eval_force(x), want) <= FORCE_TOL


# ---------------------------------------------------------------------------
# equilibria
# ---------------------------------------------------------------------------


def cuboid_solve(pkg, solver, fz):
    """NHI equilibrium of the 225-tet cuboid of ``tests/torch_helper.py``
    (order 20, Pade on) in one package."""
    from importlib import import_module

    from torch_helper import CUBOID, MATERIAL, cuboid_load

    fea = import_module(pkg + ".fea")
    app = import_module(pkg + ".fea.app")
    smod = import_module(pkg + ".solver")
    c = CUBOID
    mesh = fea.TetrahedralMesh.make_cuboid(c["nx"], c["ny"], c["nz"],
                                           c["spacing"])
    body = fea.DeformableBody(
        fea.MaterialProperty.from_young_poisson(MATERIAL["E"],
                                                MATERIAL["nu"]), mesh)
    body.coord_fixed_mask[mesh.vertices[:, 0] <= c["spacing"] / 2, :] = True
    kw = {} if pkg == "sanm_tpu" else {"device": "cpu"}
    model = body.make_forward(fea.EnergyModel.NEOHOOKEAN_I, **kw)
    f_sub = model.lt_inp.copy_vtx_values(
        cuboid_load(mesh, c["nx"], c["spacing"], fz))
    hp = smod.EqnHyperParam(order=ORDER, use_pade=True, solver=solver)
    hp.converge_rms = app.RMS_THRESH_FORCE_EQU
    hp.solution_check_tol = 1e-3
    if pkg == "sanm_tpu":
        s = smod.ANMEqnSolver(model.fn, model.lt_inp.remap,
                              model.lt_out.remap, model.x0(), f_sub, hp)
    else:
        s = smod.ANMEqnSolver(model, model.x0(), f_sub, hp)
    x = app.run_anm_eqn(s, progress=False)
    return s, x, fea.DeformableBody.compute_force_rms(model, x, f_sub)


@pytest.mark.parametrize("fz", [-200.0, -1500.0])
@pytest.mark.parametrize("solver", ["host_lu", "band_chol"])
def test_cuboid_nhi_equilibrium_matches_jax(solver, fz):
    sj, xj, rms_j = cuboid_solve("sanm_tpu", "host_lu", fz)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the plain band factor: many small calls
    try:
        sp, xp, rms_p = cuboid_solve("sanm_tpu_torch", solver, fz)
    finally:
        torch.set_num_threads(threads)
    assert sp.solver_resolved() == solver
    assert sp.get_nr_iter() == sj.get_nr_iter()
    assert rms_j <= RMS and rms_p <= RMS
    assert rel_err(xp, xj) <= COORD_RTOL
    assert [r["accepted"] for r in sp.pade_log] == [
        r["accepted"] for r in sj.pade_log]


@pytest.mark.parametrize("configs, out_name, want_disp, solver", [
    (("bar.json",), "bar-i0-neohookean_i.json", 0.195388005722574,
     "host_lu"),
    (("bar.json", "override_neo_comp.json"), "bar-i0-neohookean_c.json",
     0.195355607965, "host_lu"),
    (("bar.json", "override_neo_comp.json"), "bar-i0-neohookean_c.json",
     0.195355607965, "band_chol"),
], ids=["nhi", "nhc", "nhc-band_chol"])
def test_bar_gravity_cli(tmp_path, monkeypatch, configs, out_name,
                         want_disp, solver):
    """``configs/bar.json`` (NHI, its own material) and bar NHC through
    the port's CLI against the JAX package's gravity task: 2 restarts,
    force-RMS <= 1e-10, the relative displacement within 1e-9 relative of
    JAX's (which is ``want_disp`` to the digits given).  On host LU (what
    ``auto`` takes on the CPU), and bar NHC also on the band factor's
    plain versions, asked for by an override file."""
    over = ()
    if solver != "host_lu":
        path = tmp_path / "override_solver.json"
        path.write_text(json.dumps({"solver": solver}))
        over = (str(path),)
    _port_cli(tmp_path, *configs, *over)
    port = json.loads((tmp_path / out_name).read_text())
    jstat = _jax_gravity(tmp_path, monkeypatch, *configs).stat
    assert abs(jstat["displacement"] - want_disp) <= 1e-11
    assert port["solver_resolved"] == solver
    assert port["iter"] == jstat["iter"] == 2
    assert port["force_rms_recomp"] <= RMS
    assert port["nr_inverted"] == 0
    assert abs(port["displacement"] - jstat["displacement"]) <= 1e-9 * abs(
        jstat["displacement"])


def _gravity_host_lu_vs_jax(tmp_path, monkeypatch, configs, iters):
    from sanm_tpu_torch.fea import app

    cfg = app.merge_configs([os.path.join(CONFIGS, c) for c in configs])
    cfg["solver"] = "host_lu"
    monkeypatch.chdir(tmp_path)
    port = app.gravity(cfg, CONFIGS, device="cpu")
    jres = _jax_gravity(tmp_path, monkeypatch, *configs)
    assert port.stat["iter"] == jres.stat["iter"] == iters
    assert port.stat["force_rms_recomp"] <= RMS
    assert jres.stat["force_rms_recomp"] <= RMS
    assert port.stat["nr_inverted"] == 0
    assert rel_err(port.mesh.vertices, jres.mesh.vertices) <= COORD_RTOL
    return port, jres


@pytest.mark.slow
def test_human_nhi_host_lu(tmp_path, monkeypatch):
    """``configs/human.json`` as it is (NHI, 78,067 tets), port on host LU
    against the JAX package: 2 restarts, force-RMS <= 1e-10, coordinates
    within 1e-9 of the largest coordinate, and the relative displacement
    within 1e-9 relative of JAX's 0.008425376847673133."""
    port, jres = _gravity_host_lu_vs_jax(tmp_path, monkeypatch,
                                         ("human.json",), 2)
    want = jres.stat["displacement"]
    assert abs(want - 0.008425376847673133) <= 1e-13
    assert abs(port.stat["displacement"] - want) <= 1e-9 * want


@pytest.mark.slow
def test_armadillo_small_nhc_host_lu(tmp_path, monkeypatch):
    """The main path's cell, armadillo-small NHC gravity, port on host LU
    against the JAX package: 2 restarts, force-RMS <= 1e-10, coordinates
    within 1e-9 of the largest coordinate."""
    _gravity_host_lu_vs_jax(tmp_path, monkeypatch,
                            ("armadillo_small.json",), 2)
