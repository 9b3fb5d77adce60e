"""The inverse (rest-shape design) slice of the port against the JAX
package, on the CPU.

Both packages get the same inputs, made with NumPy from a seed.  On the
CPU each wrapper runs its plain torch version, which is the oracle of
its CUDA kernel on the card (K1i ``inv_nhc_step`` / ``inv_nhi_step``,
K3i ``jac_asm_inv`` / ``jac_asm_inv_nhi``).  Tolerances, relative to the
largest magnitude of each compared array:

* ``cauchy_stress`` 1e-12: the same closed forms, sums in another order;
* the series 1e-11 at every order 1..20: the port's route (Dm^-1 through
  Dm's cofactor and det, W = Dm^-T^T Dm^-T, J^-1 = det Dm / det Ds)
  differs from the JAX program's (adj / det, then F = Ds Dm^-1 and the
  stress's products), and every order divides by det Dm_0 (and J_0);
* the Jacobian and its assembly 1e-12 (closed form against JAX's
  forward-mode ``batched_jacobian``);
* forces 1e-10 against the JAX model's ``eval_force``;
* equilibria: same restarts, force-RMS <= 1e-10 (the paper's target),
  coordinates within 1e-9 of the largest coordinate, the CLI's relative
  displacement within 1e-9 relative of the JAX package's.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanm_tpu.fea import EnergyModel
from sanm_tpu.fea import MaterialProperty as JaxMaterial
from sanm_tpu.fea.material import cauchy_stress as jax_cauchy_stress
from sanm_tpu.taylor import TaylorFn, batched_jacobian
from sanm_tpu_torch import SANMError
from sanm_tpu_torch.fea import EnergyModel as PortEnergyModel
from sanm_tpu_torch.fea import MaterialProperty as PortMaterial
from sanm_tpu_torch.fea.material import cauchy_stress
from sanm_tpu_torch.ops import inv_series as K1i
from sanm_tpu_torch.solver import assemble as K3
from test_torch_arap import CONFIGS, _jax_gravity, _port_cli
from test_torch_nhi import bar_bodies, cuboid_bodies, deformation_cases
from torch_helper import (CUBOID, MATERIAL, cuboid_load, jax_model,
                          port_state, rel_err)

STRESS_TOL = 1e-12
SERIES_TOL = 1e-11
JAC_TOL = 1e-12
FORCE_TOL = 1e-10
COORD_RTOL = 1e-9
RMS = 1e-10
ORDER = 20
MATERIALS = {"nhc": EnergyModel.NEOHOOKEAN_C, "nhi": EnergyModel.NEOHOOKEAN_I}
JAC_PLAIN = {"nhc": K3.inv_nhc_jacobian_plain,
             "nhi": K3.inv_nhi_jacobian_plain}
JAC_ASM = {"nhc": K3.jac_asm_inv, "nhi": K3.jac_asm_inv_nhi}


@pytest.mark.parametrize("mat", ["nhc", "nhi"])
@pytest.mark.parametrize("case", deformation_cases(), ids=lambda c: c[0])
def test_cauchy_stress_matches_jax(case, mat):
    _, F = case
    E, nu = 3.68e6, 0.45
    want = np.asarray(jax_cauchy_stress(
        MATERIALS[mat], JaxMaterial.from_young_poisson(E, nu),
        jnp.asarray(F), 3))
    got = cauchy_stress(PortEnergyModel(MATERIALS[mat].value),
                        PortMaterial.from_young_poisson(E, nu),
                        torch.as_tensor(F), 3)
    assert got.shape == F.shape
    assert rel_err(got.numpy(), want) <= STRESS_TOL


def test_cauchy_stress_raises_for_arap():
    """As the JAX package: no Cauchy stress (so no inverse model) for
    ARAP."""
    with pytest.raises(SANMError, match="cauchy_stress unimplemented"):
        cauchy_stress(PortEnergyModel.ARAP, PortMaterial(1e6, 0.4),
                      torch.eye(3, dtype=torch.float64)[None], 3)
    _, body = cuboid_bodies()
    with pytest.raises(SANMError, match="cauchy_stress unimplemented"):
        body.make_inverse(PortEnergyModel.ARAP, device="cpu")


@pytest.fixture(scope="module", params=["nhc", "nhi"])
def inv_cuboid(request):
    mat = request.param
    body, model, plan, f_sub = jax_model(energy_model=MATERIALS[mat],
                                         inverse=True)
    st = port_state(body, model, plan, f_sub, inverse=True)
    T = body.mesh.nr_tet
    tfn = TaylorFn(model.fn, jax.ShapeDtypeStruct((T, 3, 3), jnp.float64))
    return mat, body, model, plan, st, tfn


def perturbed_x0(model, seed=3):
    rng = np.random.default_rng(seed)
    return model.x0() + rng.uniform(-0.002, 0.002, model.x0().shape)


def test_inverse_series_matches_taylor_engine(inv_cuboid):
    """Per-order biases and commits of K1i's plain version at every order
    1..20 on a perturbed rest state of the 225-tet cuboid (at the given
    mesh F = I, and half of the terms vanish), against the JAX
    TaylorEngine of ``make_inverse``'s graph; the order-1 bias is zero in
    both, and the affine invariant sigma_k = J g_k + b_k holds with the
    port's Jacobian."""
    mat, body, model, plan, st, tfn = inv_cuboid
    rng = np.random.default_rng(11)
    x0 = perturbed_x0(model)
    T = body.mesh.nr_tet
    eng = tfn.engine()
    S0 = eng.start(model.lt_inp.remap.apply(jnp.asarray(x0)))
    series = (K1i.InvNHCSeries if mat == "nhc" else K1i.InvNHISeries)(
        st.elems, ORDER)
    gin0 = K3.remap_in(st.asm, st.asm.pad_vector(x0))
    series.start(gin0)
    assert not torch.count_nonzero(series.bias_out)
    assert rel_err(K1i.committed_output(mat, series.hist, 0,
                                        st.elems).numpy(),
                   np.asarray(S0).reshape(T, 9)) <= STRESS_TOL
    J = JAC_PLAIN[mat](st.elems, gin0).numpy()
    bias = series.bias_out.clone()
    for k in range(1, ORDER + 1):
        b_j = eng.order_bias()
        if k == 1:
            assert b_j is None
        else:
            assert rel_err(bias.numpy(), np.asarray(b_j).reshape(T, 9)) \
                <= SERIES_TOL, "bias order %d" % k
        x_k = rng.standard_normal(x0.size) * 1e-3 * 0.5 ** k
        S_j = eng.push(model.lt_inp.remap.apply(jnp.asarray(x_k)))
        gin_k = K3.remap_in(st.asm, st.asm.pad_vector(x_k))
        b_k = bias
        if k < ORDER:
            bias = series.step(k, gin_k).clone()
        else:
            series.step_fn(series.hist, k, gin_k, st.elems)
        sk = K1i.committed_output(mat, series.hist, k, st.elems).numpy()
        assert rel_err(sk, np.asarray(S_j).reshape(T, 9)) <= SERIES_TOL, \
            "commit order %d" % k
        lin = np.einsum("boi,bi->bo", J, gin_k.numpy())
        assert rel_err(lin + b_k.numpy(), sk) <= SERIES_TOL, \
            "affine invariant at order %d" % k


@pytest.mark.parametrize("perturb", [False, True])
def test_inverse_jacobian_matches_batched_jacobian(inv_cuboid, perturb):
    mat, body, model, plan, st, tfn = inv_cuboid
    x = perturbed_x0(model) if perturb else model.x0()
    gin0 = model.lt_inp.remap.apply(jnp.asarray(x))
    J = batched_jacobian(lambda g: tfn(g), gin0)
    data_j, gt_j, E_j = plan.assemble_csr_elem(J)
    assert gt_j is None
    gin = K3.remap_in(st.asm, st.asm.pad_vector(x))
    Jp = JAC_PLAIN[mat](st.elems, gin)
    assert rel_err(Jp.numpy(), np.asarray(J).reshape(Jp.shape)) <= JAC_TOL
    data, _, E = JAC_ASM[mat](st.asm, st.elems, gin)
    assert E.shape == E_j.shape and data.shape == data_j.shape
    assert rel_err(E.numpy(), np.asarray(E_j)) <= JAC_TOL
    assert rel_err(data.numpy(), np.asarray(data_j)) <= JAC_TOL


@pytest.mark.parametrize("em", ["neohookean_c", "neohookean_i"])
@pytest.mark.parametrize("mesh", ["cuboid", "bar"])
def test_inverse_eval_force_matches_jax(mesh, em):
    jbody, pbody = cuboid_bodies() if mesh == "cuboid" else bar_bodies()
    jm = jbody.make_inverse(EnergyModel.from_name(em))
    pm = pbody.make_inverse(PortEnergyModel.from_name(em), device="cpu")
    assert pm.inverse and not pm.symmetric
    x0 = jm.x0()
    assert np.array_equal(x0, pm.x0())
    h = float(pbody.mesh.tet_volumes.min()) ** (1.0 / 3.0)
    x = x0 + np.random.default_rng(4).uniform(-0.03, 0.03, x0.shape) * h
    want = np.asarray(jm.eval_force(jnp.asarray(x)))
    assert rel_err(pm.eval_force(x), want) <= FORCE_TOL
    assert pm.eval_potential(x) is None


def test_inverse_jacobian_is_not_symmetric():
    """Why the inverse model's solve stays on host LU: its assembled
    Jacobian on the 3x2x2 cuboid at a perturbed state is far from
    symmetric (max |A - A^T| / max |A| ~ 0.04), where the forward model's
    is symmetric to rounding."""
    import scipy.sparse as sp

    _, body = cuboid_bodies(6.8e5, 0.45)
    asym = {}
    for inverse in (False, True):
        em = PortEnergyModel.NEOHOOKEAN_C
        model = (body.make_inverse(em, device="cpu") if inverse
                 else body.make_forward(em, device="cpu"))
        x = perturbed_x0(model, seed=8)
        data, _, _ = model.jac_asm(model.asm.apply_in(x))
        A = sp.csr_matrix((data.numpy(), (model.asm.csr_rowidx,
                                          model.asm.csr_cols)),
                          shape=(model.asm.n,) * 2).toarray()
        asym[inverse] = np.abs(A - A.T).max() / np.abs(A).max()
    assert asym[False] <= 1e-13
    assert asym[True] >= 1e-2


def test_band_chol_refuses_the_inverse_model():
    """An explicit ``band_chol`` on an inverse model raises and says why;
    ``auto`` takes host LU (on the CPU, and for this model on the card
    too)."""
    from sanm_tpu_torch.solver import ANMEqnSolver, EqnHyperParam

    _, body = cuboid_bodies()
    model = body.make_inverse(PortEnergyModel.NEOHOOKEAN_I, device="cpu")
    f = np.zeros(model.asm.n)
    with pytest.raises(SANMError, match="not symmetric"):
        ANMEqnSolver(model, model.x0(), f,
                     EqnHyperParam(order=4, solver="band_chol"))
    s = ANMEqnSolver(model, model.x0(), f, EqnHyperParam(order=4))
    assert s._solver_mode() == "host_lu" and not s._band_auto_ok()


# ---------------------------------------------------------------------------
# equilibria
# ---------------------------------------------------------------------------


def cuboid_inverse_solve(pkg, em, fz=-200.0):
    """Inverse equilibrium of the 225-tet cuboid (order 20, Pade on, host
    LU) in one package."""
    from importlib import import_module

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
    model = body.make_inverse(fea.EnergyModel.from_name(em), **kw)
    f_sub = model.lt_inp.copy_vtx_values(
        cuboid_load(mesh, c["nx"], c["spacing"], fz))
    hp = smod.EqnHyperParam(order=ORDER, use_pade=True, solver="host_lu")
    hp.converge_rms = app.RMS_THRESH_FORCE_EQU
    hp.solution_check_tol = 1e-3
    if pkg == "sanm_tpu":
        s = smod.ANMEqnSolver(model.fn, model.lt_inp.remap,
                              model.lt_out.remap, model.x0(), f_sub, hp)
    else:
        s = smod.ANMEqnSolver(model, model.x0(), f_sub, hp)
    x = app.run_anm_eqn(s, progress=False)
    return s, x, fea.DeformableBody.compute_force_rms(model, x, f_sub)


@pytest.mark.parametrize("em", ["neohookean_c", "neohookean_i"])
def test_cuboid_inverse_equilibrium_matches_jax(em):
    sj, xj, rms_j = cuboid_inverse_solve("sanm_tpu", em)
    sp, xp, rms_p = cuboid_inverse_solve("sanm_tpu_torch", em)
    assert sp.solver_resolved() == "host_lu"
    assert sp.get_nr_iter() == sj.get_nr_iter()
    assert rms_j <= RMS and rms_p <= RMS
    assert rel_err(xp, xj) <= COORD_RTOL
    assert [r["accepted"] for r in sp.pade_log] == [
        r["accepted"] for r in sj.pade_log]


def test_bar_inverse_cli(tmp_path):
    """``configs/bar.json`` + ``override_inverse.json`` (NHI) through the
    port's CLI on the CPU: 2 restarts, force-RMS <= 1e-10, no inverted
    element, host LU, and the relative displacement within 1e-9 relative
    of the JAX package's 0.23795925070324328 (its CPU run of the same
    command, ``python -m sanm_tpu.fea configs/sys.json configs/bar.json
    configs/override_inverse.json``)."""
    _port_cli(tmp_path, "bar.json", "override_inverse.json")
    port = json.loads((tmp_path / "bar-i1-neohookean_i.json").read_text())
    want = 0.23795925070324328
    assert port["solver_resolved"] == "host_lu"
    assert port["iter"] == 2
    assert port["force_rms_recomp"] <= RMS
    assert port["nr_inverted"] == 0
    assert abs(port["displacement"] - want) <= 1e-9 * want


def _single_tet(app, monkeypatch, workdir, argv_prefix):
    """``do_main`` of ``app`` on the single tet with
    ``override_order16.json`` layered on (as ``tests/test_app_cli.py``),
    in ``workdir``; returns the task's result."""
    got = []
    task = app.TASKS["test_single_tet_inverse"]

    def keep(*a, **kw):
        got.append(task(*a, **kw))
        return got[-1]

    monkeypatch.setitem(app.TASKS, "test_single_tet_inverse", keep)
    workdir.mkdir(exist_ok=True)
    monkeypatch.chdir(workdir)
    assert app.do_main(argv_prefix + [
        os.path.join(CONFIGS, f) for f in (
            "sys.json", "test_single_tet_inverse.json",
            "override_order16.json")]) == 0
    return got[0]


def test_single_tet_inverse_cli(tmp_path, monkeypatch):
    from sanm_tpu.fea import app as japp
    from sanm_tpu_torch.fea import app as papp

    monkeypatch.delenv("FEA_INVCHECK", raising=False)
    monkeypatch.delenv("SANM_WARM_TIMING", raising=False)
    pres = _single_tet(papp, monkeypatch, tmp_path / "port",
                       ["--device", "cpu"])
    jres = _single_tet(japp, monkeypatch, tmp_path / "jax", [])
    stat = json.loads(
        (tmp_path / "port" / "test.stl-i1-neohookean_i.json").read_text())
    assert stat["order"] == 16 and stat["solver_resolved"] == "host_lu"
    assert stat["force_rms_recomp"] <= RMS
    assert stat["iter"] == jres.stat["iter"]
    v = pres.mesh.vertices
    assert np.abs(v - jres.mesh.vertices).max() <= 1e-9 * np.abs(v).max()
    assert v[3, 2] > 0.025  # the apex's rest height is above the given


def test_invcheck_round_trip(tmp_path, monkeypatch):
    """``FEA_INVCHECK``: the single tet's rest shape, solved forward under
    the same load, lands back on the given mesh."""
    from sanm_tpu_torch.fea import app

    monkeypatch.setenv("FEA_INVCHECK", "1")
    monkeypatch.chdir(tmp_path)
    cfg = app.merge_configs([os.path.join(CONFIGS, f) for f in (
        "test_single_tet_inverse.json", "override_order16.json")])
    res = app.test_single_tet_inverse(cfg, CONFIGS, device="cpu")
    assert res.stat["invcheck_norm"] <= 1e-12


# ---------------------------------------------------------------------------
# slow tier: the two reference-protocol inverse cells
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("configs, out_name, want", [
    (("armadillo_small.json", "override_inverse.json"),
     "armadillo-small-i1-neohookean_c.json", 0.02004404485674439),
    (("bob.json", "override_inverse.json"), "bob-i1-neohookean_i.json",
     0.03516520364643996),
], ids=["armadillo_small-nhc", "bob-nhi"])
def test_inverse_gravity_cli_matches_jax(tmp_path, monkeypatch, configs,
                                         out_name, want):
    """armadillo-small NHC and bob NHI inverse gravity through the port's
    CLI on the CPU against the JAX package's gravity task: 1 restart,
    force-RMS <= 1e-10, no inverted element, the relative displacement
    within 1e-9 relative of JAX's (``want`` to the digits given)."""
    _port_cli(tmp_path, *configs)
    port = json.loads((tmp_path / out_name).read_text())
    jstat = _jax_gravity(tmp_path, monkeypatch, *configs).stat
    assert abs(jstat["displacement"] - want) <= 1e-11 * want
    assert port["solver_resolved"] == "host_lu"
    assert port["iter"] == jstat["iter"] == 1
    assert port["force_rms_recomp"] <= RMS
    assert port["nr_inverted"] == 0
    assert abs(port["displacement"] - want) <= 1e-9 * want
