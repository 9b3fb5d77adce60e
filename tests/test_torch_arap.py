"""The ARAP slice of the port against the JAX package, on the CPU.

Both packages get the same inputs, made with NumPy from a seed.  On the
CPU each wrapper runs its plain torch version, which is the oracle of
its CUDA kernel on the card (K8a ``svd_w``, K8b ``arap_step``, K8c
``jac_asm_arap``).  Tolerances, relative to the largest magnitude of
each compared array:

* svd_w and polar_w 1e-13: the same rotations, sort, repair and flip in
  the same order of arithmetic;
* the JVP 1e-13 against JAX's rule; 1e-6 against central differences of
  step 1e-6;
* the series 1e-10 at every order 1..20 (rounding of the recurrences
  grows with the order);
* the Jacobian and its assembly 1e-12;
* equilibria: same restarts, force-RMS <= 1e-10 (the paper's target),
  coordinates within 1e-9 of the largest coordinate (both stop at
  force-RMS 1e-10 from the same restarts with f64 solves).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helper import tensor_rng
from sanm_tpu.fea import EnergyModel
from sanm_tpu.fea import MaterialProperty as JaxMaterial
from sanm_tpu.fea.material import \
    elastic_potential_density as jax_energy_density
from sanm_tpu.ops.svd_w import polar_w as jax_polar_w
from sanm_tpu.ops.svd_w import svd_w as jax_svd_w
from sanm_tpu.taylor import TaylorFn, batched_jacobian
from sanm_tpu_torch.fea import EnergyModel as PortEnergyModel
from sanm_tpu_torch.fea import MaterialProperty as PortMaterial
from sanm_tpu_torch.fea.material import elastic_potential_density
from sanm_tpu_torch.ops import svd_w as K8a
from sanm_tpu_torch.ops.arap_series import (ARAPSeries, arap_step,
                                            committed_output)
from sanm_tpu_torch.ops.elements import Elements
from sanm_tpu_torch.solver.assemble import (arap_jacobian_plain,
                                            jac_asm_arap)
from test_taylor import eval_series
from torch_helper import jax_model, port_state, rel_err

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
SVD_TOL = 1e-13
SERIES_TOL = 1e-10
JAC_TOL = 1e-12
COORD_RTOL = 1e-9
RMS = 1e-10
ORDER = 20


def svd_cases():
    """(name, (B, 3, 3) matrices) for the SVD-W comparisons."""
    rng = np.random.default_rng(0)
    rand = tensor_rng((64, 3, 3), seed=100)
    refl = rng.standard_normal((32, 3, 3))
    refl[:, 0] *= -1  # about half of them reflections
    near = []  # tests/test_taylor.py:532-540: gap 2e-4 < GROUP_EPS
    for i in range(12):
        q1, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        q2, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        if i % 2:
            q1[:, 0] *= -1  # det < 0: the whole-group or single flip
        near.append((q1 * np.array([2.0, 2.0 + 2e-4, 0.5])) @ q2.T)
    # tests/test_taylor.py:572: identity plus denormal-scale coupling
    orth = np.broadcast_to(np.eye(3), (16, 3, 3)).copy()
    orth += np.random.default_rng(7).standard_normal((16, 3, 3)) * 1e-308
    return [("random", rand), ("reflections", refl),
            ("near_degenerate", np.stack(near)),
            ("near_orthogonal", orth)]


@pytest.mark.parametrize("rot", [False, True])
@pytest.mark.parametrize("case", svd_cases(), ids=lambda c: c[0])
def test_svd_w_matches_jax(case, rot):
    _, m = case
    ju, js, jw = (np.asarray(a) for a in jax_svd_w(jnp.asarray(m), rot))
    pu, ps, pw = K8a.svd_w(torch.as_tensor(m), rot)
    assert not np.isnan(pw.numpy()).any()
    for got, want in ((pu, ju), (ps, js), (pw, jw)):
        assert rel_err(got.numpy(), want) <= SVD_TOL
    # the flip choice agrees element by element
    assert np.array_equal(ps.numpy() < 0, js < 0)
    if rot:
        assert (np.linalg.det(pw.numpy()) > 0).all()
        jp = np.asarray(jax_polar_w(jnp.asarray(m), True))
        assert rel_err(K8a.polar_w(torch.as_tensor(m)).numpy(), jp) <= SVD_TOL


@pytest.mark.parametrize("case", svd_cases(), ids=lambda c: c[0])
def test_arap_energy_density_matches_jax(case):
    """The ARAP elastic energy density mu/2 |F - W|^2 (plain only; no
    kernel of the port reads it yet) against the JAX package's, and
    None for NHC in both packages."""
    _, m = case
    E, nu = 1e7, 0.45
    want = np.asarray(jax_energy_density(
        EnergyModel.ARAP, JaxMaterial.from_young_poisson(E, nu),
        jnp.asarray(m), 3))
    got = elastic_potential_density(
        PortEnergyModel.ARAP, PortMaterial.from_young_poisson(E, nu),
        torch.as_tensor(m), 3)
    assert got.shape == (m.shape[0],)
    assert rel_err(got.numpy(), want) <= SVD_TOL
    assert elastic_potential_density(
        PortEnergyModel.NEOHOOKEAN_C, PortMaterial.from_young_poisson(E, nu),
        torch.as_tensor(m), 3) is None


def test_svd_w_jvp_matches_jax_and_differences():
    rng = np.random.default_rng(1)
    m = rng.standard_normal((40, 3, 3)) + 3 * np.eye(3)
    m[::2, 1] *= -1
    dm = rng.standard_normal((40, 3, 3))
    _, (jdu, jds, jdw) = jax.jvp(lambda x: jax_svd_w(x, True),
                                 (jnp.asarray(m),), (jnp.asarray(dm),))
    tm, tdm = torch.as_tensor(m), torch.as_tensor(dm)
    u, s, w = K8a.svd_w(tm, True)
    du, ds, dw = K8a.svd_w_jvp(u, s, w, tdm)
    assert rel_err(dw.numpy(), np.asarray(jdw)) <= SVD_TOL
    assert rel_err(ds.numpy(), np.asarray(jds)) <= SVD_TOL
    assert rel_err(du.numpy(), np.asarray(jdu)) <= SVD_TOL
    h = 1e-6
    fd = (K8a.polar_w(tm + h * tdm) - K8a.polar_w(tm - h * tdm)) / (2 * h)
    assert rel_err(dw.numpy(), fd.numpy()) <= 1e-6


def _identity_elements(B, mu):
    """Elements with Dm^-1 = I and no bias, so that the graph input is F."""
    eye = torch.eye(3, dtype=torch.float64).reshape(1, 9).repeat(B, 1)
    return Elements(dminv=eye, bias=torch.zeros(B, 9, dtype=torch.float64),
                    mu=mu, lam=0.0, kappa=0.0)


def test_arap_series_matches_taylor_engine():
    """Per-order commits and biases of ARAPSeries at every order 1..20
    against the JAX TaylorEngine on ``mu (F - polar_w(F))``, with the
    inputs of ``tests/test_taylor.py``'s svd_w tests (well-separated
    spectrum, as ``test_pw_mode_matches_full_mode``), and the
    check_taylor_prop invariants on the port's own series: the affine
    invariant P_k = J x_k + b_k with the port's Jacobian, and the
    truncated series against plain evaluation."""
    B, mu = 7, 3.7
    xarr = [tensor_rng((B, 3, 3), -1, 1, seed=4242 + i) for i in range(5)]
    xarr[0] = eval_series(xarr, 0.03) + np.diag([2.0, 4.0, 7.0])
    xarr += [np.zeros_like(xarr[0])] * (ORDER + 1 - len(xarr))

    def fn(F):
        return (F - jax_polar_w(F, True)) * mu

    tfn = TaylorFn(fn, jnp.asarray(xarr[0]))

    def full(x0, xks):
        eng = tfn.engine()
        y0 = eng.start(x0)
        ys, bs = [y0], []
        for xk in xks:
            bk = eng.order_bias()
            yk = eng.push(xk)
            ys.append(jnp.zeros_like(y0) if yk is None else yk)
            bs.append(jnp.zeros_like(y0) if bk is None else bk)
        return jnp.stack(ys), jnp.stack(bs)

    ys, bs = jax.jit(full)(jnp.asarray(xarr[0]),
                           [jnp.asarray(x) for x in xarr[1:]])
    ys = np.asarray(ys).reshape(ORDER + 1, B, 9)
    bs = np.asarray(bs).reshape(ORDER, B, 9)

    el = _identity_elements(B, mu)
    series = ARAPSeries(el, ORDER)
    series.start(torch.as_tensor(xarr[0].reshape(B, 9)))
    assert rel_err(committed_output(series.hist, 0, el).numpy(), ys[0]) \
        <= SVD_TOL
    u, s, w = K8a.svd_w(torch.as_tensor(xarr[0]), True)
    J = arap_jacobian_plain(el, u, s, w).numpy()
    bias = torch.zeros(B, 9, dtype=torch.float64)  # order 1: zero
    port_y = [committed_output(series.hist, 0, el).numpy()]
    for k in range(1, ORDER + 1):
        assert rel_err(bias.numpy(), bs[k - 1]) <= SERIES_TOL \
            or not np.abs(bs[k - 1]).max(), "bias order %d" % k
        gk = torch.as_tensor(xarr[k].reshape(B, 9))
        if k < ORDER:
            b_next = series.step(k, gk).clone()
        else:
            arap_step(series.hist, k, gk, el)
        pk = committed_output(series.hist, k, el).numpy()
        assert rel_err(pk, ys[k]) <= SERIES_TOL, "commit order %d" % k
        lin = np.einsum("boi,bi->bo", J, xarr[k].reshape(B, 9))
        assert rel_err(lin + bias.numpy(), pk) <= SERIES_TOL, \
            "affine invariant at order %d" % k
        port_y.append(pk)
        if k < ORDER:
            bias = b_next
    for a in (0.01, -0.01, 0.02):
        xt = torch.as_tensor(eval_series(xarr, a))
        got = eval_series(port_y, a)
        want = ((xt - K8a.polar_w(xt)) * mu).reshape(B, 9).numpy()
        assert rel_err(got, want) <= 1e-10


@pytest.fixture(scope="module")
def arap_cuboid():
    body, model, plan, f_sub = jax_model(energy_model=EnergyModel.ARAP)
    st = port_state(body, model, plan, f_sub)
    T = body.mesh.nr_tet
    tfn = TaylorFn(model.fn, jax.ShapeDtypeStruct((T, 3, 3), jnp.float64))
    return body, model, plan, st, tfn


def perturbed_x0(model, seed=3):
    rng = np.random.default_rng(seed)
    return model.x0() + rng.uniform(-0.002, 0.002, model.x0().shape)


def test_arap_series_on_the_model(arap_cuboid):
    """The series of the ARAP cuboid's force graph (F from the remapped
    coordinates) at a perturbed state, commits and biases of orders
    1..20, against the JAX TaylorEngine of the model's graph."""
    body, model, plan, st, tfn = arap_cuboid
    rng = np.random.default_rng(11)
    x0 = perturbed_x0(model)
    T = body.mesh.nr_tet
    eng = tfn.engine()
    P0 = eng.start(model.lt_inp.remap.apply(jnp.asarray(x0)))
    series = ARAPSeries(st.elems, ORDER)
    series.start(st.asm.apply_in(x0))
    assert rel_err(committed_output(series.hist, 0, st.elems).numpy(),
                   np.asarray(P0).reshape(T, 9)) <= SVD_TOL
    bias = None
    for k in range(1, ORDER + 1):
        b_j = eng.order_bias()
        if k == 1:
            assert b_j is None
        else:
            assert rel_err(bias.numpy(), np.asarray(b_j).reshape(T, 9)) \
                <= SERIES_TOL, "bias order %d" % k
        x_k = rng.standard_normal(x0.size) * 1e-3 * 0.5 ** k
        P_j = eng.push(model.lt_inp.remap.apply(jnp.asarray(x_k)))
        gin_k = st.asm.apply_in(x_k)
        if k < ORDER:
            bias = series.step(k, gin_k).clone()
        else:
            arap_step(series.hist, k, gin_k, st.elems)
        assert rel_err(committed_output(series.hist, k, st.elems).numpy(),
                       np.asarray(P_j).reshape(T, 9)) <= SERIES_TOL, \
            "commit order %d" % k


def test_arap_jacobian_matches_batched_jacobian(arap_cuboid):
    body, model, plan, st, tfn = arap_cuboid
    x = perturbed_x0(model)
    gin0 = model.lt_inp.remap.apply(jnp.asarray(x))
    J = batched_jacobian(lambda g: tfn(g), gin0)
    data_j, gt_j, E_j = plan.assemble_csr_elem(J)
    gin = st.asm.apply_in(x)
    u, s, w = K8a.svd_w(st.elems.deformation_gradient(gin), True)
    Jp = arap_jacobian_plain(st.elems, u, s, w)
    assert rel_err(Jp.numpy(), np.asarray(J).reshape(Jp.shape)) <= JAC_TOL
    data, _, E = jac_asm_arap(st.asm, st.elems, u, s, w)
    assert rel_err(E.numpy(), np.asarray(E_j)) <= JAC_TOL
    assert rel_err(data.numpy(), np.asarray(data_j)) <= JAC_TOL


def cuboid_setup(pkg, solver):
    """``tests/test_fea.py``'s ARAP equilibrium (3x2x2 cuboid, order 8,
    -50 N on the free end's lower edge) in one package."""
    from importlib import import_module

    fea = import_module(pkg + ".fea")
    app = import_module(pkg + ".fea.app")
    spacing, nx, ny, nz = 0.025, 3, 2, 2
    mesh = fea.TetrahedralMesh.make_cuboid(nx, ny, nz, spacing)
    body = fea.DeformableBody(
        fea.MaterialProperty.from_young_poisson(1e7, 0.45), mesh)
    body.coord_fixed_mask[mesh.vertices[:, 0] <= spacing / 2, :] = True
    f = np.zeros((mesh.nr_vertices, 3))
    sel = (mesh.vertices[:, 0] > (nx - 1) * spacing - spacing / 2) & (
        mesh.vertices[:, 2] < spacing / 2)
    f[sel, 2] = -50.0
    kw = {} if pkg == "sanm_tpu" else {"device": "cpu"}
    model = body.make_forward(fea.EnergyModel.ARAP, **kw)
    f_sub = model.lt_inp.copy_vtx_values(f)
    solver_mod = import_module(pkg + ".solver")
    hp = solver_mod.EqnHyperParam(order=8, use_pade=True, solver=solver)
    hp.converge_rms = app.RMS_THRESH_FORCE_EQU
    hp.solution_check_tol = 1e-3
    return fea, app, solver_mod, model, f_sub, hp


@pytest.mark.parametrize("solver", ["host_lu", "band_chol"])
def test_cuboid_arap_equilibrium_matches_jax(solver):
    fea, app, smod, model, f_sub, hp = cuboid_setup("sanm_tpu", "host_lu")
    sj = smod.ANMEqnSolver(model.fn, model.lt_inp.remap,
                           model.lt_out.remap, model.x0(), f_sub, hp)
    xj = app.run_anm_eqn(sj, progress=False)
    rms_j = fea.DeformableBody.compute_force_rms(model, xj, f_sub)

    fea, app, smod, model, f_sub, hp = cuboid_setup("sanm_tpu_torch", solver)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the plain band factor: many small calls
    try:
        sp = smod.ANMEqnSolver(model, model.x0(), f_sub, hp)
        xp = app.run_anm_eqn(sp, progress=False)
    finally:
        torch.set_num_threads(threads)
    rms_p = fea.DeformableBody.compute_force_rms(model, xp, f_sub)
    assert sp.solver_resolved() == solver
    assert sp.get_nr_iter() == sj.get_nr_iter()
    assert rms_j <= RMS and rms_p <= RMS
    assert rel_err(xp, xj) <= COORD_RTOL


def _port_cli(tmp_path, *configs):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    env.pop("SANM_WARM_TIMING", None)
    res = subprocess.run(
        [sys.executable, "-m", "sanm_tpu_torch.fea", "--device", "cpu",
         os.path.join(CONFIGS, "sys.json"),
         *[os.path.join(CONFIGS, c) for c in configs]],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    return res


def _jax_gravity(tmp_path, monkeypatch, *configs):
    from sanm_tpu.fea.app import gravity, merge_configs

    cfg = merge_configs([os.path.join(CONFIGS, c) for c in configs])
    jdir = tmp_path / "jax"
    jdir.mkdir()
    monkeypatch.chdir(jdir)
    monkeypatch.delenv("SANM_WARM_TIMING", raising=False)
    return gravity(cfg, CONFIGS)


def test_bar_arap_gravity_cli(tmp_path, monkeypatch):
    """``configs/bar.json`` + ``override_arap.json`` through the port's
    CLI (host LU on the CPU) against the JAX package's gravity task:
    3 restarts, force-RMS <= 1e-10, the relative displacement within
    1e-9 relative (JAX gives 0.347507443601828)."""
    _port_cli(tmp_path, "bar.json", "override_arap.json")
    port = json.loads((tmp_path / "bar-i0-arap.json").read_text())
    jstat = _jax_gravity(tmp_path, monkeypatch, "bar.json",
                         "override_arap.json").stat
    assert port["solver_resolved"] == "host_lu"
    assert port["iter"] == jstat["iter"] == 3
    assert port["force_rms_recomp"] <= RMS
    assert port["nr_inverted"] == 0
    assert abs(port["displacement"] - jstat["displacement"]) <= 1e-9 * abs(
        jstat["displacement"])


@pytest.mark.slow
def test_armadillo_small_arap_stiff(tmp_path, monkeypatch):
    """armadillo-small ARAP with the stiff material (the reference
    protocol's cell), port on host LU against the JAX package: 4
    restarts, force-RMS <= 1e-10, coordinates within 1e-9 of the
    largest coordinate."""
    from sanm_tpu_torch.fea import app

    configs = ("armadillo_small.json", "override_arap.json",
               "override_stiff_material.json")
    cfg = app.merge_configs([os.path.join(CONFIGS, c) for c in configs])
    cfg["solver"] = "host_lu"
    monkeypatch.chdir(tmp_path)
    port = app.gravity(cfg, CONFIGS, device="cpu")
    jres = _jax_gravity(tmp_path, monkeypatch, *configs)
    assert port.stat["iter"] == jres.stat["iter"] == 4
    assert port.stat["force_rms_recomp"] <= RMS
    assert port.stat["nr_inverted"] == 0
    assert rel_err(port.mesh.vertices, jres.mesh.vertices) <= COORD_RTOL
