"""The baselines through the port's app against the JAX package, on the
CPU: the ``test_cuboid`` task with ``override_baseline.json`` through the
port's CLI; each baseline override through the task under
``SANM_WARM_TIMING``; the ``FEA_CHECK`` gate; the deform branch; the
refusals (inverse mode; a deform start with inverted elements); and, in
the slow tier, bar NHC gravity through the CLI.

Tolerances: the same Newton and refinement iterations; force-RMS <=
1e-10, the paper's target; the stat's relative displacement within 1e-9
relative; vertices within 1e-9 of the largest displacement.
"""

import json
import os

import numpy as np
import pytest

from test_torch_arap import CONFIGS, _port_cli
from test_torch_baseline_solve import (COORD_RTOL, E_YOUNG, NU, RMS, H,
                                       cuboid_problem, descs)


def _jax_task(tmp_path, monkeypatch, cfg):
    from sanm_tpu.fea.app import TASKS

    jdir = tmp_path / "jax"
    jdir.mkdir()
    monkeypatch.chdir(jdir)
    monkeypatch.delenv("SANM_WARM_TIMING", raising=False)
    return TASKS[cfg["func"]](cfg, CONFIGS)


def test_cuboid_baseline_cli(tmp_path, monkeypatch):
    """``configs/test_cuboid.json`` + ``override_baseline.json`` (NHC, the
    20 x 8 x 8 cuboid, sparse) through the port's CLI against the JAX
    package's task: the same Newton and refinement iterations, the
    solution keys (not the solver's or the machine's) equal in name and
    close in value."""
    from sanm_tpu.fea.app import merge_configs

    _port_cli(tmp_path, "test_cuboid.json", "override_baseline.json")
    port = json.loads(
        (tmp_path / "cuboid-i0-neohookean_c.json").read_text())
    cfg = merge_configs([os.path.join(CONFIGS, c) for c in (
        "test_cuboid.json", "override_baseline.json")])
    jstat = _jax_task(tmp_path, monkeypatch, cfg).stat
    assert port.keys() == jstat.keys()
    for key in ("iter_tot", "iter_refine", "mesh_V", "mesh_F",
                "nr_inverted"):
        assert port[key] == jstat[key], key
    assert port["nr_inverted"] == 0
    assert port["force_rms_recomp"] <= RMS
    assert port["force_rms_refine"] <= RMS
    for key in ("displacement", "potential"):
        assert abs(port[key] - jstat[key]) <= 1e-9 * abs(jstat[key]), key


def _twist_problem(fea, shift):
    """A 3 x 2 x 2 cuboid (NHC) with its x = 0 face fixed and its far face
    fixed and moved by ``shift`` (in spacings), for
    ``run_with_vtx_delta``: ``(config, body, vtx_delta)``."""
    mesh = fea.TetrahedralMesh.make_cuboid(3, 2, 2, H)
    body = fea.DeformableBody(
        fea.MaterialProperty.from_young_poisson(E_YOUNG, NU), mesh)
    vx = mesh.vertices[:, 0]
    far = vx >= 1.5 * H
    body.coord_fixed_mask[(vx <= H / 2) | far, :] = True
    delta = np.zeros_like(mesh.vertices)
    delta[far] = np.asarray(shift) * H
    cfg = {"material": {"young": E_YOUNG, "poisson": NU},
           "energy_model": "neohookean_c", "baseline": {}}
    return cfg, body, delta


def _run_delta(fea, app, shift, **kw):
    cfg, body, delta = _twist_problem(fea, shift)
    vtx = body.mesh.vertices.copy()
    stat = app.run_with_vtx_delta("twist", cfg, body, delta, vtx, False,
                                  progress=False, **kw)
    return stat, vtx


def test_deform_baseline_matches_jax():
    """The deform branch (projected Newton from the moved boundary, then
    the boundary enforced) on a mild shear of the far face."""
    from sanm_tpu import fea as jfea
    from sanm_tpu.fea import app as japp
    from sanm_tpu_torch import fea as pfea
    from sanm_tpu_torch.fea import app as papp

    shift = (0.0, 0.3, -0.2)
    js, jv = _run_delta(jfea, japp, shift)
    ps, pv = _run_delta(pfea, papp, shift, device="cpu")
    assert ps.keys() == js.keys()
    for key in ("iter_tot", "iter_refine", "nr_inverted", "V", "F"):
        assert ps[key] == js[key], key
    assert ps["force_rms_recomp"] <= RMS
    assert abs(ps["displacement"] - js["displacement"]) <= 1e-9 * abs(
        js["displacement"])
    rest = jfea.TetrahedralMesh.make_cuboid(3, 2, 2, H).vertices
    assert np.abs(pv - jv).max() <= COORD_RTOL * np.abs(jv - rest).max()


def test_deform_baseline_inverted_start_raises():
    """An NHC deform start with inverted elements (the far face pushed
    past the middle one) raises ``SANMNumericalError`` in both packages:
    the reference protocol's "n/a"."""
    from sanm_tpu import fea as jfea
    from sanm_tpu.fea import app as japp
    from sanm_tpu.utils import SANMNumericalError as JaxNumericalError

    from sanm_tpu_torch import SANMNumericalError
    from sanm_tpu_torch import fea as pfea
    from sanm_tpu_torch.fea import app as papp

    shift = (-1.5, 0.0, 0.0)
    with pytest.raises(JaxNumericalError, match="inverted elements"):
        _run_delta(jfea, japp, shift)
    with pytest.raises(SANMNumericalError, match="inverted elements"):
        _run_delta(pfea, papp, shift, device="cpu")


def test_inverse_mode_baseline_raises(tmp_path, monkeypatch):
    """Inverse mode with a baseline raises ``SANMAssertionError`` in both
    packages (``sanm_tpu/fea/app.py:226``)."""
    from sanm_tpu.fea.app import TASKS as JTASKS
    from sanm_tpu.utils import SANMAssertionError as JaxAssertionError

    from sanm_tpu_torch import SANMError
    from sanm_tpu_torch.fea.app import TASKS
    from sanm_tpu_torch.utils import SANMAssertionError

    cfg = {"func": "test_cuboid", "x": 3, "y": 2, "z": 2, "spacing": H,
           "material": {"type": "young_poisson", "young": E_YOUNG,
                        "poisson": NU},
           "energy_model": "neohookean_c", "inverse": True, "baseline": {},
           "out_filename": "cuboid"}
    monkeypatch.chdir(tmp_path)
    with pytest.raises(JaxAssertionError):
        JTASKS["test_cuboid"](dict(cfg), ".")
    with pytest.raises(SANMAssertionError):
        TASKS["test_cuboid"](dict(cfg), ".", device="cpu")
    assert issubclass(SANMAssertionError, SANMError)


@pytest.mark.parametrize("override", [
    "override_baseline.json", "override_baseline_noproj.json",
    "override_baseline_levmar.json"])
def test_baseline_overrides_through_the_app(tmp_path, monkeypatch,
                                            override):
    """Each baseline override through the port's ``test_cuboid`` task (the
    3 x 2 x 2 cuboid) under ``SANM_WARM_TIMING``: the JAX package's stat
    keys, ``time_solve_warm`` from the warm re-run, converged."""
    from sanm_tpu_torch.fea.app import TASKS, read_json

    cfg = {"func": "test_cuboid", "x": 3, "y": 2, "z": 2, "spacing": H,
           "material": {"type": "young_poisson", "young": E_YOUNG,
                        "poisson": NU},
           "energy_model": "neohookean_c", "out_filename": "cuboid"}
    cfg.update(read_json(os.path.join(CONFIGS, override)))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SANM_WARM_TIMING", "1")
    st = TASKS["test_cuboid"](cfg, CONFIGS, device="cpu").stat
    assert list(st) == [
        "time_prep", "time_solve_warm", "iter_tot", "iter_refine", "df",
        "dx", "force_rms", "force_rms_refine", "potential", "time",
        "newton_time", "force_rms_recomp", "mesh_V", "mesh_F",
        "displacement", "nr_inverted"]
    assert st["time_solve_warm"] > 0
    assert st["force_rms_recomp"] <= RMS
    assert st["nr_inverted"] == 0
    saved = json.loads((tmp_path / "cuboid-i0-neohookean_c.json").read_text())
    assert saved.keys() == st.keys()


def test_fea_check_gate(monkeypatch, capsys):
    """``FEA_CHECK`` runs the finite-difference Hessian check before the
    Newton loop and prints its error (``baseline/main.cpp:130-146``)."""
    from sanm_tpu_torch.fea import baseline as pb

    tets, v, fixed, f = cuboid_problem()
    monkeypatch.setenv("FEA_CHECK", "1")
    st = pb.solve_energy_min(tets, v, v, f, fixed, descs("neohookean_c")[1],
                             RMS, device="cpu")
    out = capsys.readouterr().out
    assert "FEA_CHECK hessian FD rel err:" in out
    err = float(out.split("FEA_CHECK hessian FD rel err:")[1].split()[0])
    assert err < 1e-4
    assert st.grad_rms_refine < RMS


@pytest.mark.slow
def test_bar_nhc_baseline_cli(tmp_path, monkeypatch):
    """bar NHC gravity (``bar.json`` + ``override_neo_comp.json`` +
    ``override_baseline.json``, 19,552 tets) through the port's CLI
    against the JAX package's task: 44 + 2 iterations in both, the
    displacement within 1e-9 relative."""
    from sanm_tpu.fea.app import merge_configs

    configs = ("bar.json", "override_neo_comp.json",
               "override_baseline.json")
    _port_cli(tmp_path, *configs)
    port = json.loads((tmp_path / "bar-i0-neohookean_c.json").read_text())
    cfg = merge_configs([os.path.join(CONFIGS, c) for c in configs])
    jstat = _jax_task(tmp_path, monkeypatch, cfg).stat
    assert port.keys() == jstat.keys()
    assert (port["iter_tot"], port["iter_refine"]) == (
        jstat["iter_tot"], jstat["iter_refine"]) == (44, 2)
    assert port["force_rms_recomp"] <= RMS
    assert port["nr_inverted"] == 0
    assert abs(port["displacement"] - jstat["displacement"]) <= 1e-9 * abs(
        jstat["displacement"])
