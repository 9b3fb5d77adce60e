"""Rules of the port that hold without a card.

* Neither ``sanm_tpu_torch`` nor ``chip_smoke.py`` imports ``jax`` or
  anything of ``sanm_tpu``: checked in a fresh interpreter (this test
  process has JAX loaded by ``tests/conftest.py``) and over every import
  statement of their sources, function-level ones included.
* An entry point without CUDA raises unless the caller passes
  ``device="cpu"``; a wrapper given anything but CPU or card tensors
  raises; the kernel build without ``nvcc`` raises.  None falls back.
"""

import ast
import os
import shutil
import subprocess
import sys

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
    from sanm_tpu_torch.fea.app import gravity

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


def test_wrappers_do_not_fall_back():
    from sanm_tpu_torch import SANMError, kernels
    from sanm_tpu_torch.fea import (DeformableBody, EnergyModel,
                                    MaterialProperty, TetrahedralMesh)
    from sanm_tpu_torch.ops.nhc_series import NHCSeries
    from sanm_tpu_torch.solver import assemble

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
    # the CPU path ran no kernel
    series.start(assemble.remap_in(asm, asm.pad_vector(model.x0())))
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
