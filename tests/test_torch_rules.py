"""Rules of the port that hold without a card.

* Neither ``sanm_tpu_torch`` nor ``chip_smoke.py`` imports ``jax`` or
  anything of ``sanm_tpu``: checked in a fresh interpreter (this test
  process has JAX loaded by ``tests/conftest.py``) and over every import
  statement of their sources, function-level ones included.
* An entry point without CUDA raises unless the caller passes
  ``device="cpu"``; a wrapper given anything but CPU or card tensors
  raises; the kernel build without ``nvcc`` raises; a kernel launch
  while a function is traced for the Taylor engine raises.  None falls
  back.
* ``auto`` takes host LU on the CPU; the band path runs there only when
  asked for, through the plain versions.
"""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "sanm_tpu_torch")


def port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def port_modules():
    mods = []
    for path in port_sources():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        if rel.endswith(".__init__"):
            rel = rel[: -len(".__init__")]
        mods.append(rel)
    return mods


def forbidden(name):
    return (name == "jax" or name.startswith("jax.") or name == "jaxlib"
            or name == "sanm_tpu" or name.startswith("sanm_tpu."))


def test_no_jax_in_sys_modules():
    code = (
        "import importlib, sys\n"
        "for m in %r: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'sanm_tpu' or "
        "m.startswith('sanm_tpu.'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n" % (port_modules(),)
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_statement(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert not forbidden(name), "%s imports %s" % (path, name)


def test_entry_points_need_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a card")
    from sanm_tpu_torch import SANMError, resolve_device
    from sanm_tpu_torch.fea import (DeformableBody, EnergyModel,
                                    MaterialProperty, TetrahedralMesh)
    from sanm_tpu_torch.fea.app import TASKS, gravity

    with pytest.raises(SANMError):
        resolve_device()
    with pytest.raises(SANMError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    body = DeformableBody(MaterialProperty.from_young_poisson(1e6, 0.4),
                          TetrahedralMesh.make_cuboid(3, 2, 2, 0.1))
    with pytest.raises(SANMError):
        body.make_forward(EnergyModel.NEOHOOKEAN_C)
    with pytest.raises(SANMError):
        body.make_forward(EnergyModel.NEOHOOKEAN_C, device="cuda")
    assert body.make_forward(EnergyModel.NEOHOOKEAN_C,
                             device="cpu").device.type == "cpu"
    with pytest.raises(SANMError):
        gravity({"material": {}}, ".")
    # the deform tasks refuse before they read their configs
    for name in ("mesh_twist", "test_cuboid_twist", "test_cuboid"):
        with pytest.raises(SANMError):
            TASKS[name]({"material": {}}, ".")
        with pytest.raises(SANMError):
            TASKS[name]({"material": {}}, ".", device="cuda")


def test_wrappers_do_not_fall_back():
    from sanm_tpu_torch import SANMError, kernels
    from sanm_tpu_torch.fea import (DeformableBody, EnergyModel,
                                    MaterialProperty, TetrahedralMesh)
    from sanm_tpu_torch.ops.nhc_series import NHCSeries
    from sanm_tpu_torch.solver import assemble, band

    body = DeformableBody(MaterialProperty.from_young_poisson(1e6, 0.4),
                          TetrahedralMesh.make_cuboid(3, 2, 2, 0.1))
    model = body.make_forward(EnergyModel.NEOHOOKEAN_C, device="cpu")
    asm = model.asm
    before = dict(kernels.LAUNCHES)
    meta = torch.empty(asm.n + 2, dtype=torch.float64, device="meta")
    with pytest.raises(SANMError):
        assemble.remap_in(asm, meta)
    with pytest.raises(SANMError):  # wrong dtype
        assemble.remap_in(asm, torch.zeros(asm.n + 2, dtype=torch.float32))
    with pytest.raises(SANMError):  # wrong shape
        assemble.remap_out(asm, torch.zeros(asm.B, 8, dtype=torch.float64))
    with pytest.raises(SANMError):  # not contiguous
        assemble.jac_asm(asm, model.elems,
                         torch.zeros(9, asm.B, dtype=torch.float64).T)
    series = NHCSeries(model.elems, 4)
    with pytest.raises(SANMError):  # order out of range
        series.step(4, torch.zeros(asm.B, 9, dtype=torch.float64))
    # K4 and K5: wrong device, dtype, shape, contiguity, block size
    E = torch.zeros(asm.B, asm.Dout, asm.Din, dtype=torch.float64)
    x = torch.zeros(asm.n, dtype=torch.float64)
    with pytest.raises(SANMError):
        assemble.element_matvec(asm, E.to("meta"), x.to("meta"))
    with pytest.raises(SANMError):
        assemble.element_matvec(asm, E, x.float())
    with pytest.raises(SANMError):
        assemble.element_matvec(asm, E.transpose(1, 2), x)
    plan = band.BandPlan(asm.csr_rowidx, asm.csr_cols, asm.n, 64)
    data = torch.ones(asm.nnz, dtype=torch.float64)
    with pytest.raises(SANMError):
        band.band_assemble(plan, data.to("meta"))
    with pytest.raises(SANMError):
        band.band_assemble(plan, data[:-1])
    bnd, scale = band.band_assemble(plan, data)
    with pytest.raises(SANMError):
        band.band_factor(plan, bnd.to("meta"))
    with pytest.raises(SANMError):
        band.band_factor(plan, bnd[:, :-1])
    panels = band.band_factor(plan, bnd)
    with pytest.raises(SANMError):
        band.band_solve(plan, panels.to("meta"), x.to("meta"))
    with pytest.raises(SANMError):
        band.band_solve(plan, panels, x[:-1])
    with pytest.raises(SANMError):  # the kernels take s = 128 only
        band._kernel_block(plan)
    # the CPU path ran no kernel
    series.start(assemble.remap_in(asm, asm.pad_vector(model.x0())))
    band.band_solve(plan, panels, x)
    assemble.element_matvec(asm, E, x)
    assert kernels.LAUNCHES == before


def test_stvk_wrappers_do_not_fall_back():
    """K1s and K3s check their arguments, refuse other devices and run
    their plain versions on the CPU without counting a launch."""
    from sanm_tpu_torch import SANMError, kernels
    from sanm_tpu_torch.fea import (DeformableBody, EnergyModel,
                                    MaterialProperty, TetrahedralMesh)
    from sanm_tpu_torch.ops.stvk_series import NCOMP, StVKSeries, stvk_step
    from sanm_tpu_torch.solver import assemble

    body = DeformableBody(MaterialProperty.from_young_poisson(1e6, 0.4),
                          TetrahedralMesh.make_cuboid(3, 2, 2, 0.1))
    model = body.make_forward(EnergyModel.StVK_STRETCH, device="cpu")
    asm, el = model.asm, model.elems
    before = dict(kernels.LAUNCHES)
    hist = torch.zeros(5, NCOMP, asm.B, dtype=torch.float64)
    g = torch.zeros(asm.B, 9, dtype=torch.float64)
    with pytest.raises(SANMError):  # wrong history width
        stvk_step(torch.zeros(5, NCOMP + 1, asm.B, dtype=torch.float64), 0,
                  g, el)
    with pytest.raises(SANMError):
        stvk_step(hist.to("meta"), 0, g.to("meta"), el)
    with pytest.raises(SANMError):  # order out of range
        StVKSeries(el, 4).step(4, g)
    with pytest.raises(SANMError):  # wrong dtype
        assemble.jac_asm_stvk(asm, el, g.float())
    gin = asm.apply_in(model.x0())
    StVKSeries(el, 4).start(gin)
    assemble.jac_asm_stvk(asm, el, gin)
    assert kernels.LAUNCHES == before


def test_no_kernel_launch_while_tracing():
    """A kernel launched while the Taylor engine traces a function would
    run on the example data and leave no trace in the graph: the launch
    raises instead (before any build)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from sanm_tpu_torch import SANMError, kernels

    def fn(x):
        kernels.launch("remap_in", "sanm_remap_in")
        return x

    assert not kernels.tracing()
    with pytest.raises(SANMError, match="traced"):
        make_fx(fn)(torch.ones(2, dtype=torch.float64))


def test_auto_takes_host_lu_on_the_cpu():
    """``auto`` resolves to host LU on the CPU (the band path is taken on
    the card only), and an explicit ``band_chol``, ``dense_chol``,
    ``spike_band`` or ``dense`` runs the plain versions there without
    counting a launch."""
    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.fea import (DeformableBody, EnergyModel,
                                    MaterialProperty, TetrahedralMesh)
    from sanm_tpu_torch.solver import ANMEqnSolver, EqnHyperParam

    mesh = TetrahedralMesh.make_cuboid(3, 2, 2, 0.1)
    body = DeformableBody(MaterialProperty.from_young_poisson(1e6, 0.4),
                          mesh)
    body.coord_fixed_mask[mesh.vertices[:, 0] <= 0.05, :] = True
    model = body.make_forward(EnergyModel.NEOHOOKEAN_C, device="cpu")
    f = np.zeros(model.x0().size)
    f[2::3] = -1e-3
    before = dict(kernels.LAUNCHES)
    for solver, mode in (("auto", "host_lu"), ("band_chol", "band_chol"),
                         ("dense_chol", "dense_chol"),
                         ("spike_band", "spike_band"), ("dense", "dense")):
        s = ANMEqnSolver(model, model.x0(), f,
                         EqnHyperParam(order=4, solver=solver))
        assert s._solver_mode() == mode and s._fact["mode"] == mode
    assert kernels.LAUNCHES == before


def test_build_without_nvcc_raises():
    from sanm_tpu_torch import SANMError, kernels

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("checks the behaviour of a machine without nvcc")
    with pytest.raises(SANMError):
        kernels.library()


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a card")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    for script, cwd in ((os.path.join(ROOT, "chip_smoke.py"), ROOT),
                        (str(alone), str(tmp_path))):
        res = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


def test_arap_wrappers_do_not_fall_back():
    """K8a svd_w, K8b arap_step and K8c jac_asm_arap raise on a meta
    tensor, a wrong dtype, shape or order range, and a non-contiguous
    tensor; on CPU tensors they run their plain versions and count no
    launch."""
    from sanm_tpu_torch import SANMError, kernels
    from sanm_tpu_torch.fea import (DeformableBody, EnergyModel,
                                    MaterialProperty, TetrahedralMesh)
    from sanm_tpu_torch.ops.arap_series import ARAPSeries, arap_step
    from sanm_tpu_torch.ops.svd_w import svd_w
    from sanm_tpu_torch.solver import assemble

    body = DeformableBody(MaterialProperty.from_young_poisson(1e6, 0.4),
                          TetrahedralMesh.make_cuboid(3, 2, 2, 0.1))
    model = body.make_forward(EnergyModel.ARAP, device="cpu")
    asm, elems = model.asm, model.elems
    B = asm.B
    before = dict(kernels.LAUNCHES)
    F = torch.eye(3, dtype=torch.float64).repeat(B, 1, 1)
    with pytest.raises(SANMError):
        svd_w(F.to("meta"))
    with pytest.raises(SANMError):  # wrong dtype
        svd_w(F.float())
    with pytest.raises(SANMError):  # wrong shape
        svd_w(F[:, :2])
    with pytest.raises(SANMError):  # not contiguous
        svd_w(F.transpose(1, 2))
    u, s, w = svd_w(F, True)
    with pytest.raises(SANMError):
        assemble.jac_asm_arap(asm, elems, u.to("meta"), s.to("meta"),
                              w.to("meta"))
    with pytest.raises(SANMError):
        assemble.jac_asm_arap(asm, elems, u, s.float(), w)
    with pytest.raises(SANMError):
        assemble.jac_asm_arap(asm, elems, u, s[:, :2], w)
    with pytest.raises(SANMError):
        assemble.jac_asm_arap(asm, elems, u.transpose(1, 2), s, w)
    series = ARAPSeries(elems, 4)
    series.start(asm.apply_in(model.x0()))
    g = torch.zeros(B, 9, dtype=torch.float64)
    with pytest.raises(SANMError):
        arap_step(series.hist.to("meta"), 1, g.to("meta"), elems)
    with pytest.raises(SANMError):
        arap_step(series.hist, 1, g.float(), elems)
    with pytest.raises(SANMError):
        arap_step(series.hist[:, :20], 1, g, elems)
    with pytest.raises(SANMError):
        arap_step(series.hist, 1, torch.zeros(9, B, dtype=torch.float64).T,
                  elems)
    with pytest.raises(SANMError):  # order 0 is committed by start
        arap_step(series.hist, 0, g, elems)
    with pytest.raises(SANMError):  # no order 5 for the bias of order 4
        series.step(4, g)
    series.step(1, g)
    assemble.jac_asm_arap(asm, elems, u, s, w)
    assert kernels.LAUNCHES == before


def test_nhi_wrappers_do_not_fall_back():
    """K1n nhi_step and K3n jac_asm_nhi raise on a meta tensor, a wrong
    dtype, shape (NHC's 23-component histories) or order range, and a
    non-contiguous tensor; on CPU tensors they run their plain versions
    and count no launch."""
    from sanm_tpu_torch import SANMError, kernels
    from sanm_tpu_torch.fea import (DeformableBody, EnergyModel,
                                    MaterialProperty, TetrahedralMesh)
    from sanm_tpu_torch.ops.nhc_series import NHCSeries
    from sanm_tpu_torch.ops.nhi_series import NHISeries, nhi_step
    from sanm_tpu_torch.solver import assemble

    body = DeformableBody(MaterialProperty.from_young_poisson(1e6, 0.4),
                          TetrahedralMesh.make_cuboid(3, 2, 2, 0.1))
    model = body.make_forward(EnergyModel.NEOHOOKEAN_I, device="cpu")
    asm, elems = model.asm, model.elems
    B = asm.B
    before = dict(kernels.LAUNCHES)
    gin0 = asm.apply_in(model.x0())
    with pytest.raises(SANMError):
        assemble.jac_asm_nhi(asm, elems, gin0.to("meta"))
    with pytest.raises(SANMError):  # wrong dtype
        assemble.jac_asm_nhi(asm, elems, gin0.float())
    with pytest.raises(SANMError):  # wrong shape
        assemble.jac_asm_nhi(asm, elems, gin0[:, :8])
    with pytest.raises(SANMError):  # not contiguous
        assemble.jac_asm_nhi(asm, elems,
                             torch.zeros(9, B, dtype=torch.float64).T)
    series = NHISeries(elems, 4)
    g = torch.zeros(B, 9, dtype=torch.float64)
    with pytest.raises(SANMError):
        nhi_step(series.hist.to("meta"), 0, gin0.to("meta"), elems)
    with pytest.raises(SANMError):
        nhi_step(series.hist, 0, gin0.float(), elems)
    with pytest.raises(SANMError):  # NHC's histories
        nhi_step(NHCSeries(elems, 4).hist, 0, gin0, elems)
    with pytest.raises(SANMError):
        nhi_step(series.hist, 0, torch.zeros(9, B, dtype=torch.float64).T,
                 elems)
    with pytest.raises(SANMError):  # no order 5 for the bias of order 4
        series.step(4, g)
    series.start(gin0)
    series.step(1, g)
    assemble.jac_asm_nhi(asm, elems, gin0)
    model.jac_asm(gin0)
    assert isinstance(model.series(4), NHISeries)
    assert kernels.LAUNCHES == before


def test_grad_t_wrapper_does_not_fall_back():
    """K3t grad_t raises on a meta tensor, a wrong dtype or shape and a
    non-contiguous tensor; without a t column it returns None; on CPU
    tensors it runs its plain version and counts no launch, also inside
    the Jacobians that call it."""
    from sanm_tpu_torch import SANMError, kernels
    from sanm_tpu_torch.fea import (DeformableBody, EnergyModel,
                                    MaterialProperty, TetrahedralMesh)
    from sanm_tpu_torch.solver import assemble

    mesh = TetrahedralMesh.make_cuboid(3, 2, 2, 0.1)
    body = DeformableBody(MaterialProperty.from_young_poisson(1e6, 0.4),
                          mesh)
    body.coord_fixed_mask[mesh.vertices[:, 0] <= 0.05, :] = True
    delta = np.zeros_like(mesh.vertices)
    delta[mesh.vertices[:, 0] <= 0.05, 1] = 0.01
    before = dict(kernels.LAUNCHES)
    plain = body.make_forward(EnergyModel.NEOHOOKEAN_C, device="cpu")
    E0 = torch.zeros(plain.asm.B, plain.asm.Dout, plain.asm.Din,
                     dtype=torch.float64)
    assert assemble.grad_t(plain.asm, E0) is None
    for em in (EnergyModel.NEOHOOKEAN_C, EnergyModel.NEOHOOKEAN_I,
               EnergyModel.ARAP):
        model = body.make_forward(em, vtx_delta=delta, device="cpu")
        asm = model.asm
        E = torch.zeros(asm.B, asm.Dout, asm.Din, dtype=torch.float64)
        with pytest.raises(SANMError):
            assemble.grad_t(asm, E.to("meta"))
        with pytest.raises(SANMError):  # wrong dtype
            assemble.grad_t(asm, E.float())
        with pytest.raises(SANMError):  # wrong shape
            assemble.grad_t(asm, E[:, :, :-1])
        with pytest.raises(SANMError):  # not contiguous
            assemble.grad_t(asm, E.transpose(1, 2))
        xt = np.concatenate([model.x0(), [0.5]])
        data, gt, E = model.jac_asm(asm.apply_in(xt))
        assert gt.shape == (asm.n_rows,) and float(gt.abs().max()) > 0
        assert torch.equal(assemble.grad_t(asm, E), gt)
    assert kernels.LAUNCHES == before


def test_inverse_wrappers_do_not_fall_back():
    """K1i (inv_nhc_step, inv_nhi_step) and K3i (jac_asm_inv,
    jac_asm_inv_nhi) raise on a meta tensor, a wrong dtype, shape (the
    other material's histories) or order range, and a non-contiguous
    tensor; on CPU tensors they run their plain versions and count no
    launch."""
    from sanm_tpu_torch import SANMError, kernels
    from sanm_tpu_torch.fea import (DeformableBody, EnergyModel,
                                    MaterialProperty, TetrahedralMesh)
    from sanm_tpu_torch.ops import inv_series as K1i
    from sanm_tpu_torch.solver import assemble

    mesh = TetrahedralMesh.make_cuboid(3, 2, 2, 0.1)
    body = DeformableBody(MaterialProperty.from_young_poisson(1e6, 0.4),
                          mesh)
    body.coord_fixed_mask[mesh.vertices[:, 0] <= 0.05, :] = True
    before = dict(kernels.LAUNCHES)
    cases = ((EnergyModel.NEOHOOKEAN_C, K1i.InvNHCSeries, K1i.InvNHISeries,
              assemble.jac_asm_inv),
             (EnergyModel.NEOHOOKEAN_I, K1i.InvNHISeries, K1i.InvNHCSeries,
              assemble.jac_asm_inv_nhi))
    for em, cls, other, jac in cases:
        model = body.make_inverse(em, device="cpu")
        asm, elems = model.asm, model.elems
        B = asm.B
        gin0 = asm.apply_in(model.x0())
        with pytest.raises(SANMError):
            jac(asm, elems, gin0.to("meta"))
        with pytest.raises(SANMError):  # wrong dtype
            jac(asm, elems, gin0.float())
        with pytest.raises(SANMError):  # wrong shape
            jac(asm, elems, gin0[:, :8])
        with pytest.raises(SANMError):  # not contiguous
            jac(asm, elems, torch.zeros(9, B, dtype=torch.float64).T)
        series = cls(elems, 4)
        step = cls.step_fn
        g = torch.zeros(B, 9, dtype=torch.float64)
        with pytest.raises(SANMError):
            step(series.hist.to("meta"), 0, gin0.to("meta"), elems)
        with pytest.raises(SANMError):
            step(series.hist, 0, gin0.float(), elems)
        with pytest.raises(SANMError):  # the other material's histories
            step(other(elems, 4).hist, 0, gin0, elems)
        with pytest.raises(SANMError):
            step(series.hist, 0, torch.zeros(9, B, dtype=torch.float64).T,
                 elems)
        with pytest.raises(SANMError):  # no order 5 for the bias of order 4
            series.step(4, g)
        series.start(gin0)
        series.step(1, g)
        jac(asm, elems, gin0)
        model.jac_asm(gin0)
        assert isinstance(model.series(4), cls)
    assert kernels.LAUNCHES == before


def test_hess_proj_wrappers_do_not_fall_back():
    """K10 (hess_proj, hess_proj_nhi, hess_proj_arap) raises on a meta
    tensor, a wrong dtype or shape and a non-contiguous tensor; on CPU
    tensors it runs its plain version and counts no launch; the model
    refuses it for an inverse or a force-only model."""
    from sanm_tpu_torch import SANMError, kernels
    from sanm_tpu_torch.fea import (DeformableBody, EnergyModel,
                                    MaterialProperty, TetrahedralMesh)
    from sanm_tpu_torch.ops.svd_w import svd_w
    from sanm_tpu_torch.solver import assemble

    body = DeformableBody(MaterialProperty.from_young_poisson(1e6, 0.4),
                          TetrahedralMesh.make_cuboid(3, 2, 2, 0.1))
    body.coord_fixed_mask[body.mesh.vertices[:, 0] <= 0.05, :] = True
    before = dict(kernels.LAUNCHES)
    for em, fn in ((EnergyModel.NEOHOOKEAN_C, assemble.hess_proj),
                   (EnergyModel.NEOHOOKEAN_I, assemble.hess_proj_nhi)):
        model = body.make_forward(em, device="cpu")
        asm, elems = model.asm, model.elems
        B = asm.B
        gin0 = asm.apply_in(model.x0())
        with pytest.raises(SANMError):
            fn(asm, elems, gin0.to("meta"))
        with pytest.raises(SANMError):  # wrong dtype
            fn(asm, elems, gin0.float())
        with pytest.raises(SANMError):  # wrong shape
            fn(asm, elems, gin0[:, :8])
        with pytest.raises(SANMError):  # not contiguous
            fn(asm, elems, torch.zeros(9, B, dtype=torch.float64).T)
        fn(asm, elems, gin0)
    model = body.make_forward(EnergyModel.ARAP, device="cpu")
    asm, elems = model.asm, model.elems
    u, s, w = svd_w(elems.deformation_gradient(asm.apply_in(model.x0())))
    with pytest.raises(SANMError):
        assemble.hess_proj_arap(asm, elems, u.to("meta"), s.to("meta"),
                                w.to("meta"))
    with pytest.raises(SANMError):
        assemble.hess_proj_arap(asm, elems, u, s.float(), w)
    with pytest.raises(SANMError):
        assemble.hess_proj_arap(asm, elems, u, s[:, :2], w)
    with pytest.raises(SANMError):
        assemble.hess_proj_arap(asm, elems, u.transpose(1, 2), s, w)
    assemble.hess_proj_arap(asm, elems, u, s, w)
    model.hess_proj(asm.apply_in(model.x0()))
    gin0 = asm.apply_in(model.x0())
    for bad in (body.make_inverse(EnergyModel.NEOHOOKEAN_C, device="cpu"),
                body.make_forward(EnergyModel.ARAP, device="cpu",
                                  jacobian=False)):
        with pytest.raises(SANMError):
            bad.hess_proj(gin0)
    assert kernels.LAUNCHES == before


def test_direct_wrappers_do_not_fall_back():
    """K6b dense_factor, K6c dense_solve, K7b spike_rhs_solve and K7c
    spike_solve (and K5a's dense and SPIKE scatters) raise on a meta
    tensor, a wrong dtype or shape, a tensor that is not contiguous and a
    block size the kernels do not take; on CPU tensors they run their
    plain versions and count no launch."""
    from sanm_tpu_torch import SANMError, kernels
    from sanm_tpu_torch.solver import linear, spike
    from sanm_tpu_torch.solver.assemble import DensePlan, dense_assemble
    from torch_helper import coo_of, random_sparse_spd

    rows, cols, vals = coo_of(random_sparse_spd(
        300, 15, np.random.default_rng(2)))
    data = torch.as_tensor(vals)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(300))
    before = dict(kernels.LAUNCHES)
    dp = DensePlan(rows, cols, 300, 64)
    with pytest.raises(SANMError):
        dense_assemble(dp, data.to("meta"))
    with pytest.raises(SANMError):
        dense_assemble(dp, data.float())
    M, _ = dense_assemble(dp, data)
    with pytest.raises(SANMError):
        linear.dense_factor(dp, M.to("meta"))
    with pytest.raises(SANMError):
        linear.dense_factor(dp, M[:, :-1])
    with pytest.raises(SANMError):
        linear.dense_factor(dp, M.T)
    inv = linear.dense_factor(dp, M)
    with pytest.raises(SANMError):
        linear.dense_solve(dp, M.to("meta"), inv.to("meta"), x.to("meta"))
    with pytest.raises(SANMError):
        linear.dense_solve(dp, M, inv, x[:-1])
    with pytest.raises(SANMError):
        linear.dense_solve(dp, M, inv.float(), x)
    with pytest.raises(SANMError):  # the kernels take s = 128 only
        kernels.check_block(dp.s)
    linear.dense_solve(dp, M, inv, x)

    sp = spike.SpikePlan(rows, cols, 300, 32, 2)
    with pytest.raises(SANMError):
        spike.spike_assemble(sp, data.to("meta"))
    Bloc, C, _ = spike.spike_assemble(sp, data)
    panels = spike.spike_local_factor(sp, Bloc)
    R = torch.zeros((sp.P, sp.m, 64), dtype=torch.float64)
    with pytest.raises(SANMError):
        spike.spike_rhs_solve(sp, panels.to("meta"), R.to("meta"))
    with pytest.raises(SANMError):
        spike.spike_rhs_solve(sp, panels, R[:, :-1])
    with pytest.raises(SANMError):
        spike.spike_rhs_solve(sp, panels, R.transpose(1, 2))
    spike.spike_rhs_solve(sp, panels, R)
    F = spike.spike_factor(sp, panels, C)
    assert F.ok()
    for name in ("invL", "invUt", "LU", "V", "W", "G", "Mh"):
        assert getattr(F, name).is_contiguous(), name
    with pytest.raises(SANMError):
        spike.spike_solve(sp, F, x.to("meta"))
    with pytest.raises(SANMError):
        spike.spike_solve(sp, F, x[:-1])
    spike.spike_solve(sp, F, x)
    assert kernels.LAUNCHES == before


def test_cg_wrappers_do_not_fall_back():
    """K4 COO (csr_matvec, csr_matvec_t, diag_blocks) and K9 (pcg_chunk)
    raise on a meta tensor, a wrong dtype or shape and a tensor that is
    not contiguous; on CPU tensors they run their plain versions and
    count no launch."""
    from sanm_tpu_torch import SANMError, kernels
    from sanm_tpu_torch.solver import assemble, linear
    from torch_helper import coo_of, random_sparse_spd

    rows, cols, vals = coo_of(random_sparse_spd(
        300, 15, np.random.default_rng(2)))
    csr = assemble.CSRMaps(rows, cols, 300, 300, "cpu")
    data = torch.as_tensor(vals)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(300))
    before = dict(kernels.LAUNCHES)
    for fn in (assemble.csr_matvec, assemble.csr_matvec_t):
        with pytest.raises(SANMError):
            fn(csr, data.to("meta"), x.to("meta"))
        with pytest.raises(SANMError):
            fn(csr, data.float(), x)
        with pytest.raises(SANMError):
            fn(csr, data, x[:-1])
        with pytest.raises(SANMError):
            fn(csr, data, torch.stack([x, x], 1)[:, 0])
        fn(csr, data, x)
    with pytest.raises(SANMError):
        assemble.diag_blocks(csr, data.to("meta"))
    with pytest.raises(SANMError):
        assemble.diag_blocks(csr, data[:-1])
    blocks = assemble.diag_blocks(csr, data)
    assert blocks.shape == (100, 3, 3)
    cg = linear.SparseCG(csr, data)
    tol = linear.SparseCG.TOL
    st = linear.PCGState(x, cg.binv)
    with pytest.raises(SANMError):
        linear.pcg_chunk(csr, data.to("meta"), cg.binv.to("meta"), st, 1,
                         tol)
    with pytest.raises(SANMError):
        linear.pcg_chunk(csr, data, cg.binv.float(), st, 1, tol)
    with pytest.raises(SANMError):
        linear.pcg_chunk(csr, data, cg.binv[:-1], st, 1, tol)
    with pytest.raises(SANMError):
        linear.pcg_chunk(csr, data, cg.binv.transpose(1, 2), st, 1, tol)
    bad = st.clone()
    bad.p = torch.stack([st.p, st.p], 1)[:, 0]
    with pytest.raises(SANMError):
        linear.pcg_chunk(csr, data, cg.binv, bad, 1, tol)
    linear.pcg_chunk(csr, data, cg.binv, st, 2, tol)
    assert st.it == 2
    cg.solve(x)
    assert kernels.LAUNCHES == before


def test_cg_wrappers_refuse_mixed_devices():
    """Every tensor whose address K4 COO or K9 would hand to the card is
    checked for its device: a PCG state, a transposed map or a block map
    with one tensor elsewhere raises instead of running."""
    from sanm_tpu_torch import SANMError, kernels
    from sanm_tpu_torch.solver import assemble, linear
    from torch_helper import coo_of, random_sparse_spd

    rows, cols, vals = coo_of(random_sparse_spd(
        60, 15, np.random.default_rng(4)))
    data = torch.as_tensor(vals)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(60))
    before = dict(kernels.LAUNCHES)
    csr = assemble.CSRMaps(rows, cols, 60, 60, "cpu")
    cg = linear.SparseCG(csr, data)
    tol = linear.SparseCG.TOL
    st = linear.PCGState(x, cg.binv)
    for name in ("x", "r", "z", "p", "Ap", "y", "S", "part"):
        bad = st.clone()
        setattr(bad, name, getattr(st, name).to("meta"))
        with pytest.raises(SANMError):
            linear.pcg_chunk(csr, data, cg.binv, bad, 1, tol)
    for name in ("transposed", "dmap"):
        odd = assemble.CSRMaps(rows, cols, 60, 60, "cpu")
        maps = getattr(odd, name)
        odd.__dict__[name] = (tuple(m.to("meta") for m in maps)
                              if name == "transposed" else maps.to("meta"))
        with pytest.raises(SANMError):
            if name == "dmap":
                assemble.diag_blocks(odd, data)
            else:
                assemble.csr_matvec_t(odd, data, x)
        if name == "transposed":
            with pytest.raises(SANMError):
                linear.pcg_chunk(odd, data, cg.binv, st.clone(), 1, tol,
                                 pen=1e-3)
    assert st.it == 0
    assert kernels.LAUNCHES == before


def test_cg_modules_import_without_jax():
    """The modules of the cg path import in a fresh interpreter without
    JAX or the JAX package."""
    code = (
        "import sys\n"
        "import sanm_tpu_torch.solver.linear as L\n"
        "import sanm_tpu_torch.solver.assemble as A\n"
        "import sanm_tpu_torch.solver.anm as N\n"
        "import sanm_tpu_torch.fea.app as P\n"
        "assert 'cg' in N.SOLVERS and L.SparseCG and A.CSRMaps\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sanm_tpu'))\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _c_entry_points(text, extern_only):
    """``{name: number of parameters}`` of the ``int sanm_*(...)``
    functions declared or defined in C source ``text``."""
    import re

    text = re.sub(r"//[^\n]*", "", text)
    pre = r'extern\s+"C"\s+' if extern_only else r"(?<![\w\"])"
    out = {}
    for m in re.finditer(pre + r"int\s+(sanm_\w+)\s*\(([^)]*)\)", text):
        out[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])
    return out


def test_c_interface_matches_ctypes_signatures():
    """Every kernel entry point that ``kernels.py`` binds is declared in
    ``csrc/sanm_kernels.h`` and defined in one ``csrc/*.cu`` with as many
    parameters as its ctypes signature, so that a launch cannot pass a
    stale argument list (nvcc, which would catch a mismatch with the
    header, runs only on the card's machine)."""
    from sanm_tpu_torch import kernels

    csrc = os.path.join(PKG, "csrc")
    header = _c_entry_points(
        open(os.path.join(csrc, "sanm_kernels.h")).read(), False)
    defined = {}
    for f in sorted(os.listdir(csrc)):
        if f.endswith(".cu"):
            for name, n in _c_entry_points(
                    open(os.path.join(csrc, f)).read(), True).items():
                assert name not in defined, name
                defined[name] = n
    assert set(kernels._SIGNATURES) == set(header) == set(defined)
    for name, args in kernels._SIGNATURES.items():
        assert len(args) == header[name] == defined[name], name
