"""FEA application: config layering, the gravity task, the stat JSON.

Port of the ``gravity`` path of ``sanm_tpu/fea/app.py`` (reference
``fea/main.cpp``): the CLI
``python -m sanm_tpu_torch.fea [--device cpu|cuda] <sys.json> <task.json>
[override.json ...]`` merges positional JSON files left to right, runs
the task named by ``func`` and writes the same OBJ and stat-JSON files,
with the same keys, into the current directory.  The device defaults to
the card.  The other tasks, the baselines, ``save_interm`` and inverse
mode belong to later slices of the port and raise.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..solver.anm import ANMEqnSolver, EqnHyperParam
from ..utils import SANMError, ScopedProfiler, Timer, sanm_assert
from .material import EnergyModel, MaterialProperty
from .mesh import TetrahedralMesh
from .model import DeformableBody

#: convergence target used by the paper benchmarks
#: (reference ``fea/main.cpp:28``)
RMS_THRESH_FORCE_EQU = 1e-10


def _warm_repeat_count():
    """Number of warm re-solves under ``SANM_WARM_TIMING`` (``=N`` runs N
    and reports the minimum; any non-integer truthy value runs one)."""
    v = os.environ.get("SANM_WARM_TIMING", "")
    try:
        return max(1, int(v))
    except ValueError:
        return 1


_total_nr_iter = [0]


# ----------------------------------------------------------------------------
# config helpers (reference fea/main.cpp:90-150)
# ----------------------------------------------------------------------------


def read_json(path):
    with open(path) as f:
        return json.load(f)


def merge_configs(paths):
    cfg = read_json(paths[0])
    for p in paths[1:]:
        cfg.update(read_json(p))
    return cfg


def make_material_property(mconf, need_density=False) -> MaterialProperty:
    sanm_assert(mconf["type"] == "young_poisson", "unknown material type")
    density = float(mconf.get("density", 0.0))
    if need_density:
        sanm_assert("density" in mconf, "density required")
    return MaterialProperty.from_young_poisson(
        float(mconf["young"]), float(mconf["poisson"]), density
    )


def setup_solver_param(config):
    """Reference ``setup_solver_param`` (``fea/main.cpp:105-119``), for
    the equation solver."""
    hp = EqnHyperParam()
    hp.order = int(config.get("order", 20))
    hp.xcoeff_l2_penalty = float(config.get("xcoeff_l2_penalty", 0.0))
    hp.use_pade = not config.get("disable_pade", False)
    hp.sanity_check = not config.get("disable_anm_sanity_check", False)
    solver = config.get("solver", "auto")
    if solver not in ("auto", "host_lu"):
        raise SANMError("solver %r is not ported yet (host_lu only)" % solver)
    hp.converge_rms = RMS_THRESH_FORCE_EQU
    return hp


def energy_model_of(config) -> EnergyModel:
    return EnergyModel.from_name(config["energy_model"])


def save_json(path, stat):
    with open(path, "w") as f:
        json.dump(stat, f, indent=4)
        f.write("\n")


def run_anm_eqn(solver: ANMEqnSolver, progress=True):
    """Reference ``run_anm`` (``fea/main.cpp:172-215``)."""
    it = 0
    while not solver.converged():
        if progress:
            print(" %.2g" % solver.residual_rms(), end="", flush=True)
        solver.next_iter()
        it += 1
        if it > 10000:
            raise SANMError("ANM did not converge")
    it = solver.get_nr_iter()
    _total_nr_iter[0] += it
    if progress:
        print(" iter=%d" % it)
    return solver.get_x()


class TaskResult:
    """Task return value: the deformed mesh + the stat dict that is also
    written next to the output OBJ (reference ``fea/main.cpp:276-296``)."""

    def __init__(self, mesh, stat):
        self.mesh = mesh
        self.stat = stat


def relative_displacement(v0, v1):
    v0 = np.asarray(v0)
    v1 = np.asarray(v1)
    vmin = v0.min(axis=0)
    vmax = v0.max(axis=0)
    d = np.sqrt(((v1 - v0) ** 2).sum() / v0.size)
    return float(d / np.linalg.norm(vmax - vmin))


def get_nr_inverted(tets, v0, v1):
    def signs(v):
        x = v[tets]
        det = np.einsum(
            "ti,ti->t",
            x[:, 1] - x[:, 0],
            np.cross(x[:, 2] - x[:, 0], x[:, 3] - x[:, 0]),
        )
        return det >= 0

    return int((signs(np.asarray(v0)) != signs(np.asarray(v1))).sum())


# ----------------------------------------------------------------------------
# equilibrium solve (reference run_and_save, fea/main.cpp:247-433)
# ----------------------------------------------------------------------------


def run_and_save(name, config, deformable: DeformableBody,
                 inverse_mode: bool, f_load_full, save=True, progress=True,
                 device=None):
    if inverse_mode:
        raise SANMError("inverse mode is not ported yet")
    if config.get("baseline") is not None:
        raise SANMError("the baselines are not ported yet")
    if config.get("save_interm", False):
        raise SANMError("save_interm is not ported yet")
    if os.environ.get("FEA_INVCHECK"):
        raise SANMError("FEA_INVCHECK (inverse round trip) is not ported yet")
    dev = resolve_device(device)
    if progress:
        print("solving %s " % name, end="", flush=True)
    jstat = {}
    timer = Timer().start()

    model = deformable.make_forward(energy_model_of(config), device=dev)
    f_load_sub = model.lt_inp.copy_vtx_values(f_load_full)
    jstat["time_prep"] = timer.stop().time()

    iter_begin = _total_nr_iter[0]
    timer.reset().start()
    hp = setup_solver_param(config)
    hp.solution_check_tol = 1e-3
    if progress:
        print("order=%d:" % hp.order, end="", flush=True)
    solver = ANMEqnSolver(model, model.x0(), f_load_sub, hp)
    xt = run_anm_eqn(solver, progress)
    jstat["time_solve"] = timer.stop().time()
    jstat["iter"] = _total_nr_iter[0] - iter_begin
    if os.environ.get("SANM_WARM_TIMING"):
        # warm re-solve reusing the device state and the host assembler
        # (a long-lived production solver), without host topology setup
        # or the kernel build; N re-solves report the best
        runs = []
        for _ in range(_warm_repeat_count()):
            sp0 = (ScopedProfiler.total("sparse_prep")
                   + ScopedProfiler.total("sparse_solve"))
            t = Timer().start()
            solver.reset()
            xt = run_anm_eqn(solver, progress=False)
            tw = t.stop().time()
            sp1 = (ScopedProfiler.total("sparse_prep")
                   + ScopedProfiler.total("sparse_solve"))
            runs.append((tw, (sp1 - sp0) / tw if sp1 > sp0 else None))
        best = min(runs, key=lambda r: r[0])
        jstat["time_solve_warm"] = best[0]
        jstat["warm_samples"] = [round(r[0], 4) for r in runs]
        if best[1] is not None:
            # share of the warm solve spent in the sparse solver
            jstat["sparse_share_warm"] = best[1]
    jstat["order"] = hp.order
    jstat["name"] = name
    jstat["pade"] = hp.use_pade
    jstat["pade_log"] = getattr(solver, "pade_log", [])
    # "threads" keeps the reference stat-JSON key (fea/main.cpp:276-296)
    # but counts CUDA devices, not CPU threads; threads_semantics says so
    ncuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    jstat["threads"] = ncuda
    jstat["solver_threads"] = ncuda
    jstat["threads_semantics"] = "cuda_device_count"
    jstat["solver_backend"] = config.get("solver", "auto")
    jstat["solver_resolved"] = "host_lu"
    jstat["loop_resolved"] = "hybrid"
    jstat["loop_mode"] = "hybrid"
    jstat["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu")
    return _post_process(name, config, deformable, model, xt, f_load_sub,
                         jstat, save, True)


def _post_process(name, config, deformable, model, xt, f_load_sub, jstat,
                  save, solution_sanity_check):
    out_mesh = deformable.mesh.copy()
    out_mesh.replace_with_mask(deformable.coord_fixed_mask, xt)

    jstat["force_rms_recomp"] = DeformableBody.compute_force_rms(
        model, xt, f_load_sub, out_mesh, solution_sanity_check
    )
    jstat["mesh_V"] = deformable.mesh.nr_vertices
    jstat["mesh_F"] = deformable.mesh.nr_tet
    jstat["displacement"] = relative_displacement(
        deformable.mesh.vertices, out_mesh.vertices
    )
    jstat["nr_inverted"] = get_nr_inverted(
        deformable.mesh.tets, deformable.mesh.vertices, out_mesh.vertices
    )
    if save:
        out = config["out_filename"]
        deformable.mesh.write_obj(out + "-orig.obj")
        out += "-i0-%s" % config["energy_model"]
        out_mesh.write_obj(out + ".obj")
        save_json(out + ".json", jstat)
        if "out_surface_vtx" in config:
            out_mesh.write_surface_vtx(config["out_surface_vtx"])
    return TaskResult(out_mesh, jstat)


# ----------------------------------------------------------------------------
# gravity (reference fea/main.cpp:921-1046)
# ----------------------------------------------------------------------------


def setup_boundary_by_config(body: DeformableBody, default_proj_dir, config):
    """Fix surface vertices below a projection threshold (reference
    ``setup_boundary_by_config``, ``fea/main.cpp:921-982``)."""
    mesh = body.mesh
    vtx = mesh.vertices
    proj_dir = np.asarray(
        config.get("boundary_proj_dir", default_proj_dir), float
    )
    proj_dir = proj_dir / np.linalg.norm(proj_dir)
    p = vtx @ proj_dir
    thresh = p.min() + (p.max() - p.min()) * float(
        config["boundary_thresh"]
    )
    print("proj range: %g %g thr=%g" % (p.min(), p.max(), thresh))

    keep = np.ones(mesh.nr_vertices, bool)
    if "boundary_filter" in config:
        fcfg = config["boundary_filter"]
        fdir = np.asarray(fcfg["dir"], float)
        fp = vtx @ fdir
        d = fp.max() - fp.min()
        th0 = fp.min() + d * float(fcfg["min"])
        th1 = fp.min() + d * float(fcfg["max"])
        print("filter range: [%g, %g]" % (th0, th1))
        keep = (fp >= th0) & (fp <= th1)

    surface = np.zeros(mesh.nr_vertices, bool)
    sanm_assert(mesh.surface_vtx)
    surface[list(mesh.surface_vtx)] = True
    sel = (p <= thresh) & surface & keep
    body.coord_fixed_mask[sel, :] = True


def _gravity_load(mesh, material, g_acc):
    """Per-tet gravity lumped to the four corners (reference
    ``fea/main.cpp:1026-1036``)."""
    vols = mesh.tet_volumes
    grav = vols[:, None] * material.density * np.asarray(g_acc)[None, :]
    f = np.zeros((mesh.nr_vertices, 3))
    np.add.at(f, mesh.tets.reshape(-1),
              np.repeat(grav / 4.0, 4, axis=0))
    tot = float(np.linalg.norm(grav, axis=1).sum())
    return f, tot


def gravity_setup(config, rootpath="."):
    """Host set-up of the gravity task: the body (mesh read and resized,
    boundary fixed) and the per-vertex gravity load; writes nothing.
    Returns ``(body, f_load_full, mesh_file)``."""
    material = make_material_property(config["material"], need_density=True)
    mesh_file = os.path.join(rootpath, config["mesh"])
    mesh = TetrahedralMesh.from_tetgen_files(mesh_file)
    body = DeformableBody(material, mesh)
    g_acc = np.asarray(config["g"], float)
    if "scale" in config:
        mesh.resize_inplace(float(config["scale"]))

    bou_path = mesh_file + ".bou"
    if os.path.exists(bou_path):
        with open(bou_path) as f:
            for tok in f.read().split():
                idx = int(tok)
                sanm_assert(idx > 0)
                body.coord_fixed_mask[idx - 1, :] = True
    else:
        print("bou file does not exist; fix lowest points ...")
        setup_boundary_by_config(body, -g_acc, config)
    f_load_full, tot_gravity = _gravity_load(mesh, material, g_acc)
    print(
        "mesh loading finished %s:\n nr_vtx=%d nr_tet=%d boundary_vtx=%d "
        "gravity=%.3f"
        % (mesh_file, mesh.nr_vertices, mesh.nr_tet,
           int(body.coord_fixed_mask[:, 0].sum()), tot_gravity)
    )
    return body, f_load_full, mesh_file


def gravity(config, rootpath=".", device=None):
    """Reference ``gravity`` (``fea/main.cpp:984-1046``) on ``device``
    (default: the card)."""
    dev = resolve_device(device)
    body, f_load_full, mesh_file = gravity_setup(config, rootpath)
    fixed_vid = set(np.nonzero(body.coord_fixed_mask[:, 0])[0].tolist())
    body.mesh.write_obj(config["out_filename"] + "-boundary.obj", fixed_vid)
    return run_and_save(
        "mesh %s" % os.path.basename(mesh_file), config, body,
        bool(config.get("inverse", False)), f_load_full, device=dev,
    )


TASKS = {
    "gravity": gravity,
}


def do_main(argv):
    """Reference ``do_main`` (``fea/main.cpp:1066-1102``).  A leading
    ``--device cpu|cuda`` picks the device (default: the card)."""
    device = None
    if argv and argv[0].startswith("--device"):
        if argv[0] == "--device":
            if len(argv) < 2:
                raise SANMError("--device needs a value")
            device, argv = argv[1], argv[2:]
        else:
            device, argv = argv[0].split("=", 1)[1], argv[1:]
    if len(argv) < 2:
        print(
            "usage: python -m sanm_tpu_torch.fea [--device cpu|cuda] "
            "<system config> <task config> [override json ...]"
        )
        return -1
    sys_config = read_json(argv[0])
    # system config: verbosity/threads, accepted for config compatibility
    _ = sys_config.get("threads")
    config = merge_configs(argv[1:])
    func = config["func"]
    if func not in TASKS:
        raise SANMError("unknown or not yet ported func: %s" % func)
    rootpath = os.path.dirname(os.path.abspath(argv[1]))
    t0 = time.time()
    TASKS[func](config, rootpath, device=device)
    print("total time: %.3fs" % (time.time() - t0))
    if os.environ.get("SANM_PROFILE"):
        print(ScopedProfiler.report())
    return 0
