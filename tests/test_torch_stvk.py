"""The StVK stretch slice of the port against the JAX package, on the CPU.

Both packages get the same inputs, made with NumPy from a seed.  On the
CPU each wrapper runs its plain torch version, which is the oracle of
its CUDA kernel on the card (K1s ``stvk_step``, K3s ``jac_asm_stvk``).
Tolerances, relative to the largest magnitude of each compared array:

* ``pk1`` 1e-12: the same products, sums in another order;
* forces: 1e-8 per entry against the torch autograd gradient of the
  energy mu/4 |F^T F - I|^2, as ``tests/test_fea.py:93-123``;
* the series 1e-11 at every order 1..20, against both engines (the JAX
  package's ``TaylorEngine`` and the port's, ``taylor.py``);
* the Jacobian and its assembly 1e-12 (closed form against JAX's
  forward-mode ``batched_jacobian`` and ``assemble_csr_elem``);
* equilibria: the same restarts, force-RMS <= 1e-10 (the paper's
  target), the relative displacement within 1e-9 relative, and the
  written OBJs' coordinates within 1e-9 of the largest.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helper import require_tensor_eq
from sanm_tpu.fea import EnergyModel
from sanm_tpu.fea import MaterialProperty as JaxMaterial
from sanm_tpu.fea.material import pk1 as jax_pk1
from sanm_tpu.taylor import TaylorFn, batched_jacobian
from sanm_tpu_torch import taylor as ptaylor
from sanm_tpu_torch.fea import EnergyModel as PortEnergyModel
from sanm_tpu_torch.fea import MaterialProperty as PortMaterial
from sanm_tpu_torch.fea.material import pk1
from sanm_tpu_torch.ops.stvk_series import (StVKSeries, committed_output,
                                            stvk_step)
from sanm_tpu_torch.solver.assemble import (jac_asm_stvk,
                                            jac_asm_stvk_plain, remap_in,
                                            remap_in_plain,
                                            stvk_jacobian_plain)
from test_torch_arap import CONFIGS, _jax_gravity, _port_cli
from test_torch_deform import _jax_task
from test_torch_nhi import cuboid_bodies, deformation_cases, perturbed_x0
from torch_helper import jax_model, port_state, rel_err

PK1_TOL = 1e-12
SERIES_TOL = 1e-11
JAC_TOL = 1e-12
RMS = 1e-10
ORDER = 20
STVK = EnergyModel.StVK_STRETCH
OVERRIDE = {"energy_model": "stvk_stretch"}


@pytest.mark.parametrize("case", deformation_cases(), ids=lambda c: c[0])
def test_stvk_pk1_matches_jax(case):
    _, F = case
    E, nu = 3.68e6, 0.45
    want = np.asarray(jax_pk1(STVK, JaxMaterial.from_young_poisson(E, nu),
                              jnp.asarray(F), 3))
    got = pk1(PortEnergyModel.StVK_STRETCH,
              PortMaterial.from_young_poisson(E, nu), torch.as_tensor(F), 3)
    assert got.shape == F.shape
    assert rel_err(got.numpy(), want) <= PK1_TOL


def test_stvk_force_vs_energy_grad():
    """Port of ``tests/test_fea.py::test_force_vs_energy_grad`` for StVK:
    the nodal forces equal minus the autograd gradient of the energy
    sum_e vol_e mu/4 |F^T F - I|^2 on the cuboid."""
    _, body = cuboid_bodies()
    model = body.make_forward(PortEnergyModel.StVK_STRETCH, device="cpu")
    mu = body.material.shear_modulus
    vols = torch.as_tensor(body.mesh.tet_volumes)
    asm, el = model.asm, model.elems
    eye = torch.eye(3, dtype=torch.float64)

    def energy(x):
        xp = torch.cat([x, torch.zeros(2, dtype=x.dtype)])
        F = el.deformation_gradient(remap_in_plain(asm, xp))
        E = torch.bmm(F.transpose(1, 2), F) - eye
        return ((mu / 4.0) * (E * E).sum((1, 2)) * vols).sum()

    rng = np.random.default_rng(3)
    x = model.x0() + rng.uniform(-0.002, 0.002, model.x0().shape)
    xt = torch.tensor(x, requires_grad=True)
    (grad,) = torch.autograd.grad(energy(xt), xt)
    require_tensor_eq(model.eval_force(x), -grad.numpy(), 1e-8,
                      msg="force vs -dE/dx (stvk)")


@pytest.fixture(scope="module")
def stvk_cuboid():
    body, model, plan, f_sub = jax_model(energy_model=STVK)
    st = port_state(body, model, plan, f_sub)
    T = body.mesh.nr_tet
    tfn = TaylorFn(model.fn, jax.ShapeDtypeStruct((T, 3, 3), jnp.float64))
    return body, model, plan, st, tfn


def test_stvk_series_matches_both_engines(stvk_cuboid):
    """Per-order biases and commits of K1s's plain version at every order
    1..20 along a series from a perturbed state of the 225-tet cuboid,
    against the JAX package's TaylorEngine of the model's StVK graph and
    against the port's engine of the same graph (the port model's
    ``fn``); the order-1 bias is zero in all three, and the affine
    invariant P_k = J g_k + b_k holds with K3s's plain Jacobian."""
    body, model, plan, st, tfn = stvk_cuboid
    rng = np.random.default_rng(11)
    x0 = perturbed_x0(model)
    T = body.mesh.nr_tet
    pbody = cuboid_port_body(body)
    pm = pbody.make_forward(PortEnergyModel.StVK_STRETCH, device="cpu")
    eng = tfn.engine()
    P0 = eng.start(model.lt_inp.remap.apply(jnp.asarray(x0)))
    gin0 = remap_in(st.asm, st.asm.pad_vector(x0))
    peng = ptaylor.TaylorFn(pm.fn, gin0.reshape(T, 3, 3)).engine()
    P0p = peng.start(gin0.reshape(T, 3, 3))
    series = StVKSeries(st.elems, ORDER)
    series.start(gin0)
    assert not torch.count_nonzero(series.bias_out)
    assert rel_err(committed_output(series.hist, 0, st.elems).numpy(),
                   np.asarray(P0).reshape(T, 9)) <= PK1_TOL
    assert rel_err(P0p.reshape(T, 9).numpy(),
                   np.asarray(P0).reshape(T, 9)) <= PK1_TOL
    J = stvk_jacobian_plain(st.elems, gin0).numpy()
    bias = series.bias_out.clone()
    for k in range(1, ORDER + 1):
        b_j = eng.order_bias()
        b_p = peng.order_bias()
        if k == 1:
            assert b_j is None and b_p is None
        else:
            want = np.asarray(b_j).reshape(T, 9)
            assert rel_err(bias.numpy(), want) <= SERIES_TOL, \
                "bias order %d" % k
            assert rel_err(b_p.reshape(T, 9).numpy(), want) <= SERIES_TOL, \
                "port engine bias order %d" % k
        x_k = rng.standard_normal(x0.size) * 1e-3 * 0.5 ** k
        P_j = eng.push(model.lt_inp.remap.apply(jnp.asarray(x_k)))
        gin_k = remap_in(st.asm, st.asm.pad_vector(x_k))
        P_p = peng.push(gin_k.reshape(T, 3, 3))
        b_k = bias
        if k < ORDER:
            bias = series.step(k, gin_k).clone()
        else:
            stvk_step(series.hist, k, gin_k, st.elems)
        pk = committed_output(series.hist, k, st.elems).numpy()
        want = np.asarray(P_j).reshape(T, 9)
        assert rel_err(pk, want) <= SERIES_TOL, "commit order %d" % k
        assert rel_err(P_p.reshape(T, 9).numpy(), want) <= SERIES_TOL, \
            "port engine commit order %d" % k
        lin = np.einsum("boi,bi->bo", J, gin_k.numpy())
        assert rel_err(lin + b_k.numpy(), pk) <= SERIES_TOL, \
            "affine invariant at order %d" % k


def cuboid_port_body(jbody):
    """The port's body of the JAX side's cuboid (same mesh, material and
    fixed mask)."""
    from sanm_tpu_torch import fea as pfea

    m = jbody.mesh
    mesh = pfea.TetrahedralMesh(m.vertices.copy(), m.tets.copy())
    body = pfea.DeformableBody(
        PortMaterial(jbody.material.young_modulus,
                     jbody.material.poisson_ratio), mesh)
    body.coord_fixed_mask[:] = jbody.coord_fixed_mask
    return body


@pytest.mark.parametrize("perturb", [False, True])
def test_stvk_jacobian_matches_batched_jacobian(stvk_cuboid, perturb):
    body, model, plan, st, tfn = stvk_cuboid
    x = perturbed_x0(model) if perturb else model.x0()
    gin0 = model.lt_inp.remap.apply(jnp.asarray(x))
    J = batched_jacobian(lambda g: tfn(g), gin0)
    data_j, gt_j, E_j = plan.assemble_csr_elem(J)
    assert gt_j is None
    gin = remap_in(st.asm, st.asm.pad_vector(x))
    Jp = stvk_jacobian_plain(st.elems, gin)
    assert rel_err(Jp.numpy(), np.asarray(J).reshape(Jp.shape)) <= JAC_TOL
    for fn in (jac_asm_stvk, jac_asm_stvk_plain):
        data, _, E = fn(st.asm, st.elems, gin)
        assert E.shape == E_j.shape and data.shape == data_j.shape
        assert rel_err(E.numpy(), np.asarray(E_j)) <= JAC_TOL
        assert rel_err(data.numpy(), np.asarray(data_j)) <= JAC_TOL


# ---------------------------------------------------------------------------
# equilibria
# ---------------------------------------------------------------------------


def obj_vertices(path):
    with open(path) as f:
        return np.array([[float(v) for v in line.split()[1:4]]
                         for line in f if line.startswith("v ")])


def test_cuboid_stvk_cli(tmp_path, monkeypatch):
    """``configs/test_cuboid.json`` (the 20 x 8 x 8 cuboid) with a StVK
    override through the port's CLI (host LU on the CPU) against the JAX
    package's ``test_cuboid`` task: the same restarts (2), force-RMS <=
    1e-10, the relative displacement within 1e-9 relative, and the
    written OBJs' coordinates within 1e-9 of the largest."""
    over = tmp_path / "override_stvk.json"
    over.write_text(json.dumps(OVERRIDE))
    _port_cli(tmp_path, "test_cuboid.json", str(over))
    name = "cuboid-i0-stvk_stretch"
    port = json.loads((tmp_path / (name + ".json")).read_text())
    jstat = _jax_task(tmp_path, monkeypatch, "test_cuboid.json",
                      str(over)).stat
    assert port["solver_resolved"] == "host_lu"
    assert port["iter"] == jstat["iter"] == 2
    assert port["force_rms_recomp"] <= RMS
    assert port["nr_inverted"] == 0
    assert abs(port["displacement"] - jstat["displacement"]) <= 1e-9 * abs(
        jstat["displacement"])
    vp = obj_vertices(tmp_path / (name + ".obj"))
    vj = obj_vertices(tmp_path / "jax" / (name + ".obj"))
    assert vp.shape == vj.shape
    assert np.abs(vp - vj).max() <= 1e-9 * np.abs(vj).max()


@pytest.mark.slow
def test_armadillo_small_stvk_stiff(tmp_path, monkeypatch):
    """The StVK cell of the card: armadillo-small gravity with
    ``override_stiff_material.json`` and a StVK override, port on host LU
    against the JAX package: 2 restarts, force-RMS <= 1e-10, the relative
    displacement within 1e-9 relative of JAX's 0.02616150932393459."""
    from sanm_tpu_torch.fea import app

    over = tmp_path / "override_stvk.json"
    over.write_text(json.dumps(OVERRIDE))
    configs = ("armadillo_small.json", "override_stiff_material.json",
               str(over))
    cfg = app.merge_configs([os.path.join(CONFIGS, c) for c in configs])
    cfg["solver"] = "host_lu"
    monkeypatch.chdir(tmp_path)
    port = app.gravity(cfg, CONFIGS, device="cpu")
    jstat = _jax_gravity(tmp_path, monkeypatch, *configs).stat
    assert abs(jstat["displacement"] - 0.02616150932393459) <= 1e-13
    assert port.stat["iter"] == jstat["iter"] == 2
    assert port.stat["force_rms_recomp"] <= RMS
    assert port.stat["nr_inverted"] == 0
    assert abs(port.stat["displacement"] - jstat["displacement"]) <= 1e-9 * \
        jstat["displacement"]
