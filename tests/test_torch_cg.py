"""The ``cg`` solver of the port (``sanm_tpu_torch/solver/linear.py``
``SparseCG``, K9 through its plain version; K4 COO's CSR products in
``solver/assemble.py``) against the JAX package, on the CPU.

Inputs are made with NumPy from a seed and handed to both packages: the
Jacobian of the 4 x 3 x 3 cuboid of ``tests/test_sparse_solver.py`` (and
random values on its pattern), the SPD system of
``tests/test_linear_solvers.py``.  Tolerances, each with its reason:

* the products: 1e-13 relative to the largest entry (f64 sums of the
  same products; the port's plain version adds them in the JAX package's
  COO order, its kernel in row order); the diagonal blocks: equal (a
  gather);
* ``SparseCG``: x within 1e-10 relative (both stop at a 1e-13 residual of
  the same iterations; the recurrences round differently);
* the ANM runs: the same restarts and coordinates within 1e-9 of the
  largest coordinate (the JAX package's tolerance for the other
  solvers); the CLI runs: the same restarts, force-RMS <= 1e-10 (1e-9 in
  Tikhonov mode, as ``tests/test_app_cli.py``), the relative displacement
  within 1e-9 relative.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanm_tpu.solver.linear import SparseCG as JaxCG
from test_linear_solvers import _assembler_for, banded_system
from test_torch_arap import CONFIGS, _port_cli
from torch_helper import rel_err
from sanm_tpu_torch import SANMError
from sanm_tpu_torch.solver import assemble as K4
from sanm_tpu_torch.solver import linear as K9

PRODUCT_TOL = 1e-13
CG_TOL = 1e-10
COORD_RTOL = 1e-9
RMS = 1e-10


def cuboid_bodies(nx=4, ny=3, nz=3, spacing=0.025, fz=-30.0):
    """The cuboid of ``tests/test_sparse_solver.py:29-36`` (x = 0 fixed,
    ``fz`` on each far-face vertex) in both packages: ``(jax_body,
    port_body, load)``."""
    from sanm_tpu import fea as jfea
    from sanm_tpu_torch import fea as pfea

    out = []
    for fea in (jfea, pfea):
        mesh = fea.TetrahedralMesh.make_cuboid(nx, ny, nz, spacing)
        body = fea.DeformableBody(
            fea.MaterialProperty.from_young_poisson(1e7, 0.45), mesh)
        body.coord_fixed_mask[mesh.vertices[:, 0] <= spacing / 2, :] = True
        out.append(body)
    verts = out[0].mesh.vertices
    f = np.zeros((len(verts), 3))
    f[verts[:, 0] > (nx - 1) * spacing - spacing / 2, 2] = fz
    return out[0], out[1], f


def cuboid_jacobian():
    """The JAX assembler plan of the 4 x 3 x 3 cuboid, its CSR values at
    rest, and the port's model of the same cuboid."""
    from sanm_tpu.fea import EnergyModel as JaxEM
    from sanm_tpu.solver.remap import SparseAssembler
    from sanm_tpu.taylor import batched_jacobian
    from sanm_tpu_torch.fea import EnergyModel

    jb, pb, _ = cuboid_bodies()
    jm = jb.make_forward(JaxEM.NEOHOOKEAN_C)
    gin0 = jm.lt_inp.remap.apply(jnp.asarray(jm.x0()))
    asm = SparseAssembler(jm.lt_out.remap, jm.lt_inp.remap, gin0.shape[0],
                          9, 9, jm.lt_inp.n_unknown_vtx)
    data, _ = asm.assemble_csr(batched_jacobian(jm.fn, gin0))
    pm = pb.make_forward(EnergyModel.NEOHOOKEAN_C, device="cpu")
    return asm, np.array(data), pm


@pytest.mark.parametrize("values", ["jacobian", "random"])
def test_csr_products_match_jax(values):
    """``csr_matvec``, ``csr_matvec_t`` and ``diag_blocks`` on the port
    model's CSR maps against the JAX assembler's ``matvec``, ``matvec_t``
    and ``diag_blocks`` on the same pattern (the cuboid's Jacobian at
    rest, or random values on its pattern)."""
    asm, data, pm = cuboid_jacobian()
    csr = pm.asm.csr_maps
    assert np.array_equal(pm.asm.csr_rowidx, asm.csr_rowidx)
    assert np.array_equal(pm.asm.csr_cols, asm.csr_cols)
    assert csr.nnz == asm.nnz and csr.n == asm.n == csr.n_rows
    rng = np.random.default_rng(11)
    if values == "random":
        data = rng.standard_normal(asm.nnz)
    x = rng.standard_normal(asm.n)
    d, xt = torch.as_tensor(data), torch.as_tensor(x)
    jd, jx = jnp.asarray(data), jnp.asarray(x)
    for mine, theirs in (
            (K4.csr_matvec(csr, d, xt), asm.matvec(jd, jx)),
            (K4.csr_matvec_t(csr, d, xt), asm.matvec_t(jd, jx))):
        assert mine.shape == theirs.shape
        assert rel_err(mine.numpy(), np.asarray(theirs)) <= PRODUCT_TOL
    blocks = K4.diag_blocks(csr, d)
    assert blocks.shape == (asm.n // 3, 3, 3)
    assert np.array_equal(blocks.numpy(), np.asarray(asm.diag_blocks(jd, 3)))


def spd_system():
    """The SPD system and right-hand side of
    ``tests/test_linear_solvers.py:114-127``."""
    A = banded_system(150)
    A = A @ A.T + 10 * np.eye(150)
    b = np.random.default_rng(4).normal(size=150)
    return A, b


def both_cg(A, b, pen=0.0):
    asm, data = _assembler_for(A)
    jcg = JaxCG(asm, jnp.asarray(data), block=3, l2_penalty=pen)
    xj = np.asarray(jcg.solve(jnp.asarray(b)))
    csr = K4.CSRMaps(asm.csr_rowidx, asm.csr_cols, A.shape[0], A.shape[0],
                     "cpu")
    cg = K9.SparseCG(csr, torch.as_tensor(np.array(data)), l2_penalty=pen)
    x = cg.solve(torch.as_tensor(b)).numpy()
    assert abs(float(cg.coeff_l2()) - float(jcg.coeff_l2())) <= (
        1e-15 * float(jcg.coeff_l2()))
    y = np.random.default_rng(5).standard_normal(len(b))
    assert rel_err(cg.apply(torch.as_tensor(y)).numpy(),
                   np.asarray(jcg.apply(jnp.asarray(y)))) <= PRODUCT_TOL
    return cg, x, xj


@pytest.mark.parametrize("pen", [0.0, 1e-3])
def test_sparse_cg_matches_jax(pen):
    """The SPD system, and Tikhonov mode (A^T A + pen I, right-hand side
    A^T b), against the JAX package's ``SparseCG`` (``solve``, and in
    ``both_cg`` its ``apply`` and ``coeff_l2``)."""
    A, b = spd_system()
    K9.SparseCG.reset_stats()
    cg, x, xj = both_cg(A, b, pen)
    assert rel_err(x, xj) <= CG_TOL
    G = A.T @ A + pen * np.eye(len(b)) if pen else A
    rhs = A.T @ b if pen else b
    assert np.linalg.norm(G @ x - rhs) / np.linalg.norm(rhs) < 1e-10
    st = K9.SparseCG.STATS
    assert st["solves"] == 1 and 0 < st["iterations"] <= st["run"]
    assert st["run"] % 64 == 0 and st["run"] <= 2048


def test_sparse_cg_freezes_mid_chunk():
    """The SPD system converges inside its first chunk of 64: the frozen
    iterations keep x and r bit for bit (a second chunk changes neither),
    count no live iteration, and x matches the JAX package's."""
    A, b = spd_system()
    cg, x, xj = both_cg(A, b)
    assert rel_err(x, xj) <= CG_TOL
    st = K9.PCGState(torch.as_tensor(b), cg.binv)
    K9.pcg_chunk(cg.csr, cg._data, cg.binv, st, 64, K9.SparseCG.TOL)
    live = st.slot()[2].item()
    assert 0 < live < 64
    x1, r1 = st.x.clone(), st.r.clone()
    K9.pcg_chunk(cg.csr, cg._data, cg.binv, st, 64, K9.SparseCG.TOL)
    assert torch.equal(st.x, x1) and torch.equal(st.r, r1)
    assert st.slot()[2].item() == live and st.it == 128
    assert torch.equal(st.x, torch.as_tensor(x))


def test_sparse_cg_zero_rhs_and_shapes():
    """b = 0 returns zeros without an iteration, as the JAX package's; a
    system that is not square or not of 3-blocks raises."""
    A, _ = spd_system()
    cg, x, xj = both_cg(A, np.zeros(150))
    assert not x.any() and not np.asarray(xj).any()
    rows, cols = np.nonzero(np.ones((6, 6)))
    for n_rows, n in ((6, 5), (5, 5)):
        sel = (rows < n_rows) & (cols < n)
        csr = K4.CSRMaps(rows[sel], cols[sel], n_rows, n, "cpu")
        with pytest.raises(SANMError):
            K9.SparseCG(csr, torch.ones(int(sel.sum()), dtype=torch.float64))


def solve_eqn(pkg, solver):
    """The 4 x 3 x 3 cuboid's equilibrium (order 8, Pade on, as
    ``tests/test_sparse_solver.py:106-127``) with ``solver`` in the JAX
    package (``pkg="jax"``) or the port."""
    jb, pb, f = cuboid_bodies()
    if pkg == "jax":
        from sanm_tpu.fea import EnergyModel
        from sanm_tpu.fea.app import RMS_THRESH_FORCE_EQU, run_anm_eqn
        from sanm_tpu.solver import ANMEqnSolver
        from sanm_tpu.solver.anm import EqnHyperParam

        model = jb.make_forward(EnergyModel.NEOHOOKEAN_C)
        args = (model.fn, model.lt_inp.remap, model.lt_out.remap)
    else:
        from sanm_tpu_torch.fea import EnergyModel
        from sanm_tpu_torch.fea.app import RMS_THRESH_FORCE_EQU, run_anm_eqn
        from sanm_tpu_torch.solver import ANMEqnSolver, EqnHyperParam

        model = pb.make_forward(EnergyModel.NEOHOOKEAN_C, device="cpu")
        args = (model,)
    hp = EqnHyperParam(order=8, use_pade=True, solver=solver)
    hp.converge_rms = RMS_THRESH_FORCE_EQU
    s = ANMEqnSolver(*args, model.x0(), model.lt_inp.copy_vtx_values(f), hp)
    return s, np.asarray(run_anm_eqn(s, progress=False))


def test_anm_cg_matches_jax():
    """``ANMEqnSolver`` with ``solver="cg"`` against the JAX package's on
    the 4 x 3 x 3 cuboid (the tier-1 counterpart of its slow ``cg``
    case): equal restarts, coordinates within 1e-9; every expansion on
    cg."""
    sj, xj = solve_eqn("jax", "cg")
    sp, xp = solve_eqn("port", "cg")
    assert sp.get_nr_iter() == sj.get_nr_iter()
    assert rel_err(xp, xj) <= COORD_RTOL
    assert sp.solver_resolved() == "cg"
    assert sp.expansions == {"cg": sp.get_nr_iter(), "host_lu": 0}
    assert sp.band_fallbacks == {"gate": 0, "checks": 0, "not_finite": 0}
    assert isinstance(sp._fact["solver"], K9.SparseCG)


def test_cg_expansion_failure_raises():
    """A cg expansion that fails its checks raises, as in the JAX package:
    no fallback to host LU."""
    from sanm_tpu_torch.solver import ANMEqnSolver, EqnHyperParam
    from sanm_tpu_torch.utils import SANMNumericalError

    _, pb, f = cuboid_bodies()
    from sanm_tpu_torch.fea import EnergyModel

    model = pb.make_forward(EnergyModel.NEOHOOKEAN_C, device="cpu")
    calls = []
    real = K9.SparseCG.solve

    def bad_solve(self, b):
        calls.append(1)
        return real(self, b) * (1.0 + 0.01 * len(calls))

    hp = EqnHyperParam(order=8, solver="cg")
    K9.SparseCG.solve = bad_solve
    try:
        with pytest.raises(SANMNumericalError):
            ANMEqnSolver(model, model.x0(), model.lt_inp.copy_vtx_values(f),
                         hp)
    finally:
        K9.SparseCG.solve = real
    assert calls


def _jax_task(tmp_path, monkeypatch, cfg):
    from sanm_tpu.fea.app import TASKS

    jdir = tmp_path / "jax"
    jdir.mkdir()
    monkeypatch.chdir(jdir)
    monkeypatch.delenv("SANM_WARM_TIMING", raising=False)
    return TASKS[cfg["func"]](cfg, CONFIGS).stat


def _write(tmp_path, name, cfg):
    path = tmp_path / name
    path.write_text(json.dumps(cfg))
    return str(path)


def test_cuboid_twist_cli_cg(tmp_path, monkeypatch):
    """The implicit driver (``ANMImplicitSolver``, the t column) on cg:
    ``configs/test_simple_cuboid_twist.json`` (ARAP, V = 12) with a
    ``{"solver": "cg"}`` override through the port's CLI against the JAX
    package's task with the same override: 4 deform and 1 refine
    restarts, the relative displacement within 1e-9 relative."""
    from sanm_tpu.fea.app import merge_configs

    over = _write(tmp_path, "cg.json", {"solver": "cg"})
    _port_cli(tmp_path, "test_simple_cuboid_twist.json", over)
    port = json.loads((tmp_path / "cuboid-twist.json").read_text())
    jstat = _jax_task(tmp_path, monkeypatch, merge_configs(
        [os.path.join(CONFIGS, "test_simple_cuboid_twist.json"), over]))
    assert port["solver_resolved"] == "cg"
    assert port["expansions"] == {"cg": 5, "host_lu": 0}
    assert (port["iter_deform"], port["iter_refine"]) == (
        jstat["iter_deform"], jstat["iter_refine"]) == (4, 1)
    assert port["force_rms_recomp"] <= RMS and port["nr_inverted"] == 0
    assert abs(port["displacement"] - jstat["displacement"]) <= (
        COORD_RTOL * abs(jstat["displacement"]))


SMALL_CUBOID = {
    "func": "test_cuboid", "energy_model": "neohookean_c",
    "material": {"type": "young_poisson", "young": 1e7, "poisson": 0.45},
    "spacing": 0.025, "x": 6, "y": 3, "z": 3, "out_filename": "cub"}
# the Tikhonov case of tests/test_app_cli.py:55-74
PENALTY_CUBOID = dict(SMALL_CUBOID, x=3, y=2, z=2, order=8,
                      out_filename="cub_l2", xcoeff_l2_penalty=1e-5,
                      disable_anm_sanity_check=True)


@pytest.mark.parametrize("task, rms", [(SMALL_CUBOID, RMS),
                                       (PENALTY_CUBOID, 1e-9)])
def test_cuboid_cli_cg(tmp_path, monkeypatch, task, rms):
    """``python -m sanm_tpu_torch.fea --device cpu`` on a small
    ``test_cuboid`` with ``{"solver": "cg"}`` (and the l2-penalty config
    of ``tests/test_app_cli.py``) against the JAX package's task with the
    same config."""
    cfg = dict(task, solver="cg")
    _port_cli(tmp_path, _write(tmp_path, "task.json", cfg))
    name = "%s-i0-neohookean_c.json" % cfg["out_filename"]
    port = json.loads((tmp_path / name).read_text())
    jstat = _jax_task(tmp_path, monkeypatch, cfg)
    assert port["solver_backend"] == "cg" and port["solver_resolved"] == "cg"
    assert port["expansions"] == {"cg": port["iter"], "host_lu": 0}
    assert port["iter"] == jstat["iter"]
    assert max(port["force_rms_recomp"], jstat["force_rms_recomp"]) <= rms
    assert abs(port["displacement"] - jstat["displacement"]) <= (
        COORD_RTOL * abs(jstat["displacement"]))
