"""The baseline solvers of the port against the JAX package, on the CPU:
projected Newton (``solve_energy_min``, with and without projection) and
Levenberg-Marquardt (``solve_force_equ_levmar``, its dense and its sparse
branch) on the 3 x 2 x 2 cuboid of ``tests/test_baseline.py``.  The
app's baseline branches are in ``tests/test_torch_baseline_app.py``.

Both packages get the same NumPy inputs.  Tolerances: the same Newton
and refinement iterations (the line search's energy test flips only on
a last-bit tie, which these inputs do not reach); vertices within 1e-9
of the largest displacement (f64 solves of systems equal to ~1e-15);
force-RMS <= 1e-10, the paper's target.
"""

import numpy as np
import pytest

E_YOUNG, NU = 1e7, 0.45
RMS = 1e-10
COORD_RTOL = 1e-9
H = 0.025


def cuboid_problem():
    """``(tets, vertices, fixed mask, load)``: the 3 x 2 x 2 cuboid, x = 0
    fixed, -50 N on the bottom edge of the far face (test_baseline.py)."""
    from sanm_tpu.fea import TetrahedralMesh

    mesh = TetrahedralMesh.make_cuboid(3, 2, 2, H)
    v = mesh.vertices
    fixed = np.zeros((mesh.nr_vertices, 3), bool)
    fixed[v[:, 0] <= H / 2, :] = True
    f = np.zeros((mesh.nr_vertices, 3))
    f[(v[:, 0] > 2 * H - H / 2) & (v[:, 2] < H / 2), 2] = -50.0
    return mesh.tets, v, fixed, f


def descs(em_name):
    """The (energy model, material) of each package."""
    from sanm_tpu import fea as jfea
    from sanm_tpu_torch import fea as pfea

    return [(fea.EnergyModel.from_name(em_name),
             fea.MaterialProperty.from_young_poisson(E_YOUNG, NU))
            for fea in (jfea, pfea)]


def check_stats(port, jax, rest, refine=True):
    """The same iterations, the port converged, vertices within
    ``COORD_RTOL`` of the largest displacement."""
    assert port.as_json().keys() == jax.as_json().keys()
    assert port.nr_iter == jax.nr_iter
    assert port.nr_iter_refine == jax.nr_iter_refine
    rms = port.grad_rms_refine if refine and port.nr_iter_refine else (
        port.grad_rms)
    assert rms < RMS
    disp = np.abs(jax.vtx - rest).max()
    assert np.abs(port.vtx - jax.vtx).max() <= COORD_RTOL * disp


@pytest.mark.parametrize("em_name,proj", [
    ("neohookean_c", True), ("neohookean_i", True), ("arap", True),
    ("neohookean_c", False), ("neohookean_i", False)])
def test_energy_min_matches_jax(em_name, proj):
    """Projected Newton + unprojected refinement (``hessian_proj``) and
    Newton without projection: the JAX package's iterations and
    equilibrium."""
    from sanm_tpu.fea import baseline as jb
    from sanm_tpu_torch.fea import baseline as pb

    tets, v, fixed, f = cuboid_problem()
    jd, pd = descs(em_name)
    js = jb.solve_energy_min(tets, v, v, f, fixed, jd, RMS,
                             hessian_proj=proj)
    ps = pb.solve_energy_min(tets, v, v, f, fixed, pd, RMS,
                             hessian_proj=proj, device="cpu")
    check_stats(ps, js, v)


@pytest.mark.parametrize("branch", ["dense", "sparse"])
def test_levmar_matches_jax(monkeypatch, branch):
    """Levenberg-Marquardt (NHC): the dense normal equations at this size,
    and the sparse branch with ``_SPARSE_THRESHOLD`` at 1 in both
    packages (``tests/test_baseline.py:82-95``)."""
    from sanm_tpu.fea import baseline as jb
    from sanm_tpu_torch.fea import baseline as pb

    if branch == "sparse":
        monkeypatch.setattr(jb, "_SPARSE_THRESHOLD", 1)
        monkeypatch.setattr(pb, "_SPARSE_THRESHOLD", 1)
    tets, v, fixed, f = cuboid_problem()
    jd, pd = descs("neohookean_c")
    js = jb.solve_force_equ_levmar(tets, v, f, fixed, jd, RMS)
    ps = pb.solve_force_equ_levmar(tets, v, f, fixed, pd, RMS,
                                   device="cpu")
    check_stats(ps, js, v, refine=False)


def test_sparse_hessian_matches_dense(monkeypatch):
    """The free-dof Hessian as a SciPy CSR matrix (above the threshold)
    holds the dense branch's values."""
    from sanm_tpu_torch.fea import baseline as pb

    tets, v, fixed, _ = cuboid_problem()
    kern = pb._Kernels(tets, v, v, fixed, *descs("arap")[1], True, 0.0,
                       device="cpu")
    h = kern.hessian(v, True)
    dense = pb._assemble_hessian(kern, h)
    monkeypatch.setattr(pb, "_SPARSE_THRESHOLD", 1)
    sparse = pb._assemble_hessian(kern, h)
    assert isinstance(dense, np.ndarray)
    assert np.array_equal(sparse.toarray(), dense)
    assert sparse.has_sorted_indices
