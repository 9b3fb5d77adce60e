"""The baselines' element programs in the port against the JAX package,
on the CPU: the energy density and the forces of ``fea/baseline.py``'s
``_Kernels``, K10's plain version (the eigen-projected Hessian) and the
unprojected Hessian, which is minus the ANM Jacobian (the plain versions
of K3, K3n and K8c), against ``_Kernels.energy``, ``forces`` and
``hess_blocks`` of ``sanm_tpu/fea/baseline.py``; the projected Hessian's
descent property and the finite-difference check.

Inputs: the 3 x 2 x 2 cuboid of ``tests/test_baseline.py`` (10 tets, the
x = 0 face fixed), at rest (F = I: dP/dF has three zero eigenvalues, the
degenerate spectrum on which the TPU's f64 ``eigh`` failed) and squashed
(``v[:, 2] *= 0.4``: dP/dF indefinite), for NHC, NHI and ARAP.
Tolerances:

* energy and forces 1e-12 of the squashed state's magnitude (at rest both
  are zero up to rounding): the same f64 closed forms, summed in another
  order, and ``-dE/dx`` from the stress against JAX's autograd;
* Hessians 1e-11 relative: D+ = V max(L, 0) V^T from torch's ``eigh``
  against NumPy's (unique where the eigenvectors are not), contracted in
  another order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helper import rel_err

E_YOUNG, NU = 1e7, 0.45
MATERIALS = ("neohookean_c", "neohookean_i", "arap")
STATES = ("rest", "squashed")
FORCE_TOL = 1e-12
HESS_TOL = 1e-11


@functools.lru_cache(maxsize=None)
def cuboid():
    """``(tets, rest vertices, fixed mask)`` of the 3 x 2 x 2 cuboid."""
    from sanm_tpu.fea import TetrahedralMesh

    h = 0.025
    mesh = TetrahedralMesh.make_cuboid(3, 2, 2, h)
    fixed = np.zeros((mesh.nr_vertices, 3), bool)
    fixed[mesh.vertices[:, 0] <= h / 2, :] = True
    return mesh.tets, mesh.vertices, fixed


def state(name):
    v = cuboid()[1].copy()
    if name == "squashed":
        v[:, 2] *= 0.4
    return v


@functools.lru_cache(maxsize=None)
def jax_kernels(em_name, reg=0.0):
    """The JAX package's ``_Kernels`` (projection on; ``hess_blocks``
    reads the toggle per call)."""
    from sanm_tpu.fea import EnergyModel, MaterialProperty
    from sanm_tpu.fea import baseline

    tets, rest, _ = cuboid()
    return baseline._Kernels(tets, rest, EnergyModel.from_name(em_name),
                             MaterialProperty.from_young_poisson(E_YOUNG, NU),
                             True, reg)


def port_kernels(em_name, v, proj=True, reg=0.0):
    """The port's ``_Kernels`` on the CPU, its fixed coordinates at
    ``v``'s."""
    from sanm_tpu_torch.fea import EnergyModel, MaterialProperty
    from sanm_tpu_torch.fea import baseline

    tets, rest, fixed = cuboid()
    return baseline._Kernels(tets, rest, v, fixed,
                             EnergyModel.from_name(em_name),
                             MaterialProperty.from_young_poisson(E_YOUNG, NU),
                             proj, reg, device="cpu")


def jax_hessian(em_name, v, proj, reg):
    """The JAX package's free-dof Hessian (dense at this size) and its
    (B, 12, 12) element blocks."""
    from sanm_tpu.fea import baseline

    tets, _, fixed = cuboid()
    kern = jax_kernels(em_name, reg)
    kern.proj = proj
    blocks = np.asarray(kern.hess_blocks(jnp.asarray(v)))
    H = baseline._assemble_hessian(blocks, kern.tets, v.shape[0],
                                   ~fixed.reshape(-1))
    return H, blocks


@pytest.mark.parametrize("name", STATES)
@pytest.mark.parametrize("em_name", MATERIALS)
def test_energy_and_forces_match_jax(em_name, name):
    """The port's energy and ``-dE/dx`` on the free coordinates (from the
    stress through K2's plain version) against JAX's ``energy`` and
    autograd ``forces``."""
    _, _, fixed = cuboid()
    free = ~fixed.reshape(-1)
    kern = jax_kernels(em_name)
    squashed = state("squashed")
    e_scale = abs(float(kern.energy(jnp.asarray(squashed))))
    f_scale = np.abs(np.asarray(kern.forces(jnp.asarray(squashed)))).max()
    assert e_scale > 0 and f_scale > 0
    v = state(name)
    pk = port_kernels(em_name, v)
    e_j = float(kern.energy(jnp.asarray(v)))
    f_j = np.asarray(kern.forces(jnp.asarray(v))).reshape(-1)[free]
    assert abs(pk.energy(v) - e_j) <= FORCE_TOL * e_scale
    f_p = pk.forces(v)
    assert f_p.shape == f_j.shape
    assert np.abs(f_p - f_j).max() <= FORCE_TOL * f_scale


def _free_blocks(kern, E):
    """``{b: (-E[b], dof order)}`` of the elements whose four vertices
    are free: their condensed block in the Hessian's sign, and the
    permutation of the JAX block's 12 rows into its (ascending unknown)
    order."""
    tets = kern.model.lt_inp.mesh.tets
    free = ~kern.model.lt_inp.fixed_mask[:, 0]
    out = {}
    for b in np.nonzero(free[tets].all(axis=1))[0]:
        order = np.argsort(tets[b], kind="stable")
        idx = (3 * order[:, None] + np.arange(3)[None, :]).reshape(-1)
        out[b] = (-E[b].numpy(), idx)
    return out


@pytest.mark.parametrize("name", STATES)
@pytest.mark.parametrize("em_name", MATERIALS)
def test_projected_hessian_matches_jax(em_name, name):
    """K10's plain version (``hess_proj*_plain`` through the model)
    against ``hess_blocks`` with projection on: the assembled free-dof
    Hessian and the element blocks of the elements with four free
    vertices (D+ and K_e are compared, never eigenvectors)."""
    v = state(name)
    pk = port_kernels(em_name, v)
    H_j, blocks = jax_hessian(em_name, v, True, 0.0)
    from sanm_tpu_torch.fea.baseline import _assemble_hessian

    H_p = _assemble_hessian(pk, pk.hessian(v, True))
    assert rel_err(H_p, H_j) <= HESS_TOL
    _, E = pk.model.hess_proj(pk._gin(v))
    scale = np.abs(blocks).max()
    fb = _free_blocks(pk, E)
    assert fb
    for b, (blk, idx) in fb.items():
        assert np.abs(blk - blocks[b][np.ix_(idx, idx)]).max() <= (
            HESS_TOL * scale)


@pytest.mark.parametrize("name", STATES)
@pytest.mark.parametrize("em_name", MATERIALS)
def test_unprojected_hessian_is_minus_the_anm_jacobian(em_name, name):
    """The unprojected Hessian of the refinement and of
    ``hessian_no_proj`` is minus the ANM Jacobian's CSR values (K3, K3n
    or K8a + K8c, plain here): it equals ``hess_blocks`` with projection
    off, assembled."""
    v = state(name)
    pk = port_kernels(em_name, v, proj=False)
    data = pk.model.jac_asm(pk._gin(v))[0].numpy()
    assert np.array_equal(pk.hessian(v, False), -data)
    from sanm_tpu_torch.fea.baseline import _assemble_hessian

    H_j, _ = jax_hessian(em_name, v, False, 0.0)
    assert rel_err(_assemble_hessian(pk, -data), H_j) <= HESS_TOL


@pytest.mark.parametrize("proj", [True, False])
@pytest.mark.parametrize("name", STATES)
def test_hessian_diag_matches_jax(name, proj):
    """``hessian_diag`` 1e-3 (NHC): reg I_12 on every element block in
    the JAX package, reg times the element count on each free diagonal
    entry in the port."""
    v = state(name)
    pk = port_kernels("neohookean_c", v, proj, 1e-3)
    from sanm_tpu_torch.fea.baseline import _assemble_hessian

    H_p = _assemble_hessian(pk, pk.hessian(v, proj))
    H_j, _ = jax_hessian("neohookean_c", v, proj, 1e-3)
    H_0, _ = jax_hessian("neohookean_c", v, proj, 0.0)
    assert np.abs(np.diag(H_j - H_0)).min() >= 1e-3 * 0.999
    assert rel_err(H_p, H_j) <= HESS_TOL


@pytest.mark.parametrize("em_name", MATERIALS)
def test_projected_hessian_descent(em_name):
    """Port of ``tests/test_baseline.py::test_projected_hessian_descent``:
    in the squashed (indefinite) state every projected element block,
    and so the assembled Hessian, is positive semi-definite, while the
    unprojected one is not."""
    v = state("squashed")
    pk = port_kernels(em_name, v)
    _, E = pk.model.hess_proj(pk._gin(v))
    K = -E.numpy()
    w = np.linalg.eigvalsh(0.5 * (K + K.transpose(0, 2, 1)))
    assert w.min() > -1e-6 * abs(w).max()
    from sanm_tpu_torch.fea.baseline import _assemble_hessian

    for proj in (True, False):
        H = _assemble_hessian(pk, pk.hessian(v, proj))
        w = np.linalg.eigvalsh(H)
        assert (w.min() > -1e-6 * abs(w).max()) == proj


def test_hessian_finite_difference():
    """Port of ``tests/test_baseline.py::test_hessian_finite_difference``
    (the reference's FD Hessian checker, ``hcheck.cpp:6-77``)."""
    from sanm_tpu_torch.fea import baseline

    v = state("rest")
    v[:, 2] *= 0.9
    err = baseline.check_hessian_fd(port_kernels("neohookean_c", v), v,
                                    samples=4)
    assert err < 1e-4


def test_hessian_finite_difference_catches_a_wrong_hessian(monkeypatch):
    """The FD check fails on a Hessian that is not the force's
    derivative (the projected one in the squashed state)."""
    from sanm_tpu_torch import SANMError
    from sanm_tpu_torch.fea import baseline

    v = state("squashed")
    kern = port_kernels("neohookean_c", v)
    true_hessian = kern.hessian
    monkeypatch.setattr(kern, "hessian", lambda v, proj: true_hessian(v,
                                                                      True))
    with pytest.raises(SANMError):
        baseline.check_hessian_fd(kern, v, samples=4)


def test_inverted_element_raises():
    """An inverted element (J < 0) makes the projected Hessian
    non-finite: :class:`SANMNumericalError`, as the JAX package raises
    from ``hess_blocks``."""
    from sanm_tpu.utils import SANMNumericalError as JaxNumericalError

    from sanm_tpu_torch import SANMNumericalError

    v = state("rest")
    v[v[:, 0] > 0.03, 0] = 0.0125  # the far layer past the middle one
    for em_name in ("neohookean_c", "neohookean_i"):
        kern = jax_kernels(em_name)
        kern.proj = True
        with pytest.raises(JaxNumericalError):
            kern.hess_blocks(jnp.asarray(v))
        with pytest.raises(SANMNumericalError):
            port_kernels(em_name, v).hessian(v, True)


def test_hess_proj_plain_on_cpu_counts_no_launch():
    """On CPU tensors the K10 wrappers run their plain versions and leave
    the launch counts as they were."""
    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.ops.svd_w import svd_w
    from sanm_tpu_torch.solver import assemble as K

    v = state("squashed")
    before = dict(kernels.LAUNCHES)
    for em_name in MATERIALS:
        pk = port_kernels(em_name, v)
        asm, elems = pk.model.asm, pk.model.elems
        gin = pk._gin(v)
        if em_name == "arap":
            args, fn = svd_w(elems.deformation_gradient(gin)), K.hess_proj_arap
        else:
            args = (gin,)
            fn = K.hess_proj if em_name == "neohookean_c" else K.hess_proj_nhi
        data, E = fn(asm, elems, *args)
        assert data.shape == (asm.nnz,)
        assert E.shape == (asm.B, asm.Dout, asm.Din)
    assert kernels.LAUNCHES == before
