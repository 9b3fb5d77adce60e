"""The port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``: they skip on a machine without a card.  Run them on the
card with ``python -m pytest tests/test_torch_card.py -m cuda -q``.
This file does not import JAX (the card machine has none); the plain
torch versions are the oracle, and they are held against the JAX package
by ``test_torch_kernels.py`` on the CPU.  Tolerance: 1e-12 relative to
the largest magnitude (f64 sums in another order, fused multiply-adds)."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

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
    data_g, E_g = K.jac_asm(g.asm, g.elems, gin_g)
    data_c, E_c = K.jac_asm(c.asm, c.elems, gin_c)
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
