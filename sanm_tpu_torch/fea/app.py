"""FEA application: config layering, the tasks, the stat JSON.

Port of ``sanm_tpu/fea/app.py`` (reference ``fea/main.cpp``): the CLI
``python -m sanm_tpu_torch.fea [--device cpu|cuda] <sys.json> <task.json>
[override.json ...]`` merges positional JSON files left to right, runs
the task named by ``func`` and writes the same OBJ and stat-JSON files,
with the same keys, into the current directory.  The device defaults to
the card.  The tasks: ``gravity`` and ``test_cuboid`` (equilibrium under
a load, :func:`run_and_save`), ``mesh_twist`` and ``test_cuboid_twist``
(prescribed boundary displacement by implicit continuation, then an
order-6 refinement, :func:`run_with_vtx_delta`), and
``test_single_tet_inverse``.

Inverse mode (rest-shape design: the rest shape that the load deforms
into the given mesh) is ``"inverse": true`` in a config, e.g.
``configs/override_inverse.json`` after ``configs/armadillo_small.json``;
it writes ``<out>-i1-<energy>.json``.  On the CPU::

    python -m sanm_tpu_torch.fea --device cpu configs/sys.json \
        configs/armadillo_small.json configs/override_inverse.json

and ``configs/test_single_tet_inverse.json`` for the single tet; with
``FEA_INVCHECK=1`` set, the result is solved back in the other mode and
``invcheck norm`` prints how far that lands from the start.  On the card
drop ``--device cpu``.  The inverse model's Jacobian is not symmetric, so
its solve stays on host LU (SuperLU), as in the JAX package: ``auto``
takes host LU and the Cholesky solvers (``band_chol``, ``dense_chol``,
``spike_band``) raise.  ``save_interm`` and the ``cg`` solver belong to
a later slice of the port and raise.

The classical baselines (``fea/baseline.py``: projected Newton with its
unprojected refinement, Newton without projection, Levenberg-Marquardt)
run in place of the ANM when a config has a ``"baseline"`` section, e.g.
``configs/override_baseline.json`` (``override_baseline_noproj.json``,
``override_baseline_levmar.json``) after the task config, in the
``gravity`` and ``test_cuboid`` tasks and, as projected Newton, in the
deform tasks; they write the JAX package's stat keys (``iter_tot``,
``iter_refine``, ``force_rms``, ``time``, ...).  On the CPU::

    python -m sanm_tpu_torch.fea --device cpu configs/sys.json \
        configs/test_cuboid.json configs/override_baseline.json

The solver is the config's ``"solver"`` (``auto``, ``host_lu``,
``band_chol``, ``dense_chol``, ``spike_band`` or ``dense``), e.g. an
override file holding ``{"solver": "spike_band"}`` after the task
config, or the environment's ``SANM_SOLVER``, which takes precedence.
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..solver.anm import (SOLVERS, ANMEqnSolver, ANMImplicitSolver,
                          EqnHyperParam, HyperParam, resolved_solver)
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
_total_solve_time = [0.0]


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


def setup_solver_param(config, eqn=False):
    """Reference ``setup_solver_param`` (``fea/main.cpp:105-119``): the
    implicit solver's parameters, or (``eqn=True``) the equation
    solver's."""
    hp = EqnHyperParam() if eqn else HyperParam()
    hp.order = int(config.get("order", 20))
    hp.xcoeff_l2_penalty = float(config.get("xcoeff_l2_penalty", 0.0))
    hp.use_pade = not config.get("disable_pade", False)
    hp.sanity_check = not config.get("disable_anm_sanity_check", False)
    # SANM_SOLVER overrides the config, as in the JAX package (the
    # experiment harness's knob, sanm_tpu/fea/app.py:94-96)
    hp.solver = os.environ.get("SANM_SOLVER", config.get("solver", "auto"))
    if hp.solver not in SOLVERS:
        raise SANMError("solver %r is not ported yet (ported: %s)"
                        % (hp.solver, ", ".join(SOLVERS)))
    if eqn:
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


def run_anm_implicit(solver: ANMImplicitSolver, t_dest=1.0, progress=True):
    """Reference ``run_anm`` for the implicit solver: restart until the
    validated range reaches ``t_dest``; returns x(t_dest)."""
    it = 0
    while True:
        if progress:
            print(" %.2g" % solver.get_t_upper(), end="", flush=True)
        if solver.get_t_upper() >= t_dest:
            break
        solver.update_approx()
        it += 1
        if it > 10000:
            raise SANMError("implicit continuation stalled")
    _total_nr_iter[0] += solver.get_nr_iter()
    if progress:
        print(" iter=%d" % solver.get_nr_iter())
    return solver.eval(solver.solve_a(t_dest))[0]


def _solver_stats(jstat, solvers, dev):
    """The port's stat keys: the solver that ran the expansions of
    ``solvers`` (``mixed`` after a fallback to host LU), the expansions
    of each solver and the band factor's fallbacks, summed over
    ``solvers``, and the device."""
    exp = {k: sum(s.expansions[k] for s in solvers)
           for k in solvers[0].expansions}
    jstat["solver_resolved"] = resolved_solver(exp)
    jstat["expansions"] = exp
    jstat["band_fallbacks"] = {k: sum(s.band_fallbacks[k] for s in solvers)
                               for k in solvers[0].band_fallbacks}
    jstat["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu")


class TaskResult:
    """Task return value: the deformed mesh + the stat dict that is also
    written next to the output OBJ (reference ``fea/main.cpp:276-296``),
    and the equation solver that produced them (None where none ran)."""

    def __init__(self, mesh, stat, solver=None):
        self.mesh = mesh
        self.stat = stat
        self.solver = solver
        self.cold = None  # the first run's result under a warm re-run


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
                 device=None, allow_invcheck=True):
    """Solve the equilibrium of ``deformable`` under ``f_load_full``
    (V, 3): the deformed shape, or with ``inverse_mode`` the rest shape
    that the load deforms into the mesh; then :func:`_post_process`."""
    if config.get("save_interm", False):
        raise SANMError("save_interm is not ported yet")
    dev = resolve_device(device)
    baseline = config.get("baseline") is not None
    if progress:
        print("solving %s%s " % (name, " (inv)" if inverse_mode else ""),
              end="", flush=True)
    jstat = {}
    timer = Timer().start()

    em = energy_model_of(config)
    # a baseline builds its own model; this one only checks the solution
    model = (deformable.make_inverse(em, device=dev) if inverse_mode
             else deformable.make_forward(em, device=dev,
                                          jacobian=not baseline))
    f_load_sub = model.lt_inp.copy_vtx_values(f_load_full)
    jstat["time_prep"] = timer.stop().time()

    if baseline:
        from . import baseline as bl

        sanm_assert(not inverse_mode)
        stat = bl.run_from_config(config, deformable, f_load_full,
                                  RMS_THRESH_FORCE_EQU, dev)
        if os.environ.get("SANM_WARM_TIMING"):
            # re-run with the kernels built and the caches warm: the
            # reported times then exclude the kernel build, the analog
            # of the reference timing a long-lived process
            t = Timer().start()
            stat = bl.run_from_config(config, deformable, f_load_full,
                                      RMS_THRESH_FORCE_EQU, dev)
            jstat["time_solve_warm"] = t.stop().time()
        jstat.update(stat.as_json())
        xt = model.lt_inp.copy_vtx_values(stat.vtx)
        return _post_process(
            name, config, deformable, model, xt, f_load_sub, f_load_full,
            jstat, inverse_mode, save, allow_invcheck, progress, dev,
            not config["baseline"].get("use_levmar", False))

    iter_begin = _total_nr_iter[0]
    timer.reset().start()
    hp = setup_solver_param(config, eqn=True)
    hp.solution_check_tol = 1e-3
    if progress:
        print("order=%d:" % hp.order, end="", flush=True)
    solver = ANMEqnSolver(model, model.x0(), f_load_sub, hp)
    xt = run_anm_eqn(solver, progress)
    jstat["time_solve"] = timer.stop().time()
    _total_solve_time[0] += jstat["time_solve"]
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
    jstat["solver_backend"] = hp.solver
    # cold and warm solves together
    _solver_stats(jstat, [solver], dev)
    jstat["loop_resolved"] = "hybrid"
    jstat["loop_mode"] = "hybrid"
    res = _post_process(name, config, deformable, model, xt, f_load_sub,
                        f_load_full, jstat, inverse_mode, save,
                        allow_invcheck, progress, dev)
    res.solver = solver
    return res


def _post_process(name, config, deformable, model, xt, f_load_sub,
                  f_load_full, jstat, inverse_mode, save, allow_invcheck,
                  progress, dev, solution_sanity_check=True):
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
        out += "-i%d-%s" % (int(inverse_mode), config["energy_model"])
        out_mesh.write_obj(out + ".obj")
        save_json(out + ".json", jstat)
        if "out_surface_vtx" in config:
            out_mesh.write_surface_vtx(config["out_surface_vtx"])

    if allow_invcheck and os.environ.get("FEA_INVCHECK"):
        # forward/inverse round trip (reference fea/main.cpp:299-310): the
        # result solved in the other mode should land on the start mesh;
        # the new body on the result builds its own output remap
        inv_body = DeformableBody(deformable.material, out_mesh)
        inv_body.coord_fixed_mask = deformable.coord_fixed_mask
        restored = run_and_save(
            name + " invcheck", config, inv_body, not inverse_mode,
            f_load_full, save=False, progress=progress, device=dev,
            allow_invcheck=False,
        )
        norm = float(np.linalg.norm(restored.mesh.vertices
                                    - deformable.mesh.vertices))
        jstat["invcheck_norm"] = norm
        jstat["invcheck_solver_resolved"] = restored.stat["solver_resolved"]
        print("invcheck norm: %g" % norm)
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


# ----------------------------------------------------------------------------
# prescribed-displacement continuation
# (reference run_with_vtx_delta, fea/main.cpp:436-582)
# ----------------------------------------------------------------------------


def run_with_vtx_delta(name, config, deformable: DeformableBody, vtx_delta,
                       vtx_coord, require_refine: bool, refine_f_load=None,
                       progress=True, device=None):
    """Move the boundary by ``vtx_delta`` (V, 3) from ``vtx_coord`` (V, 3,
    updated in place) by implicit continuation in t from 0 to 1, then,
    when asked or when the force residual is above
    :data:`RMS_THRESH_FORCE_EQU`, refine with an order-6 equation solve
    under ``refine_f_load``.  With a ``"baseline"`` config, projected
    Newton from the moved boundary replaces both.  Returns the stat
    dict."""
    if config.get("save_interm", False):
        raise SANMError("save_interm is not ported yet")
    dev = resolve_device(device)
    if progress:
        print("solving %s(delta) " % name, end="", flush=True)
    jstat = {}
    timer = Timer().start()
    vtx_dst_boundary = deformable.mesh.vertices + vtx_delta
    mask = deformable.coord_fixed_mask
    em = energy_model_of(config)

    def eval_force_rms():
        m = deformable.make_forward(em, vtx_coord, device=dev,
                                    jacobian=False)
        f = m.eval_force(m.x0())
        return float(np.sqrt(np.mean(f * f)))

    def eval_potential():
        m = deformable.make_forward(em, vtx_coord, device=dev,
                                    jacobian=False)
        p = m.eval_potential(m.x0())
        return -1.0 if p is None else p

    if config.get("baseline") is not None:
        from . import baseline as bl

        stat = bl.solve_energy_min(
            deformable.mesh.tets, deformable.mesh.vertices,
            vtx_dst_boundary, None, mask,
            bl.material_desc_from_config(config), RMS_THRESH_FORCE_EQU,
            device=dev,
        )
        vtx_coord[:] = stat.vtx
        vtx_coord[mask] = vtx_dst_boundary[mask]
        _delta_stats(jstat, deformable, vtx_coord, eval_force_rms,
                     eval_potential)
        jstat.update(stat.as_json())
        return jstat

    model = deformable.make_forward(em, vtx_coord, vtx_delta, device=dev)
    iter_begin = _total_nr_iter[0]
    time_prep = timer.stop().time()
    timer.reset().start()
    hp = setup_solver_param(config)
    hp.solution_check_tol = 10.0  # high tolerance (fea/main.cpp:513)
    if progress:
        print("order=%d:" % hp.order, end="", flush=True)
    solver = ANMImplicitSolver(model, model.x0(), 0.0, hp)
    xt = run_anm_implicit(solver, 1.0, progress)
    timer.stop()
    if progress:
        print("timing(sec): prep=%.3f solve=%.3f" % (time_prep, timer.time()))
    vtx_coord[~mask] = np.asarray(xt).reshape(-1)
    vtx_coord += vtx_delta

    force_rms = eval_force_rms()
    if progress:
        print("force rms: %g" % force_rms)
    require_refine = require_refine or force_rms >= RMS_THRESH_FORCE_EQU
    iters_before_refine = _total_nr_iter[0]
    solvers = [solver]
    if require_refine:
        # low-order error-correcting refinement (fea/main.cpp:554-574)
        model2 = deformable.make_forward(em, vtx_coord, device=dev)
        if refine_f_load is not None:
            f_load_sub = model2.lt_inp.copy_vtx_values(refine_f_load)
        else:
            f_load_sub = np.zeros(model2.lt_inp.n_unknown_vtx)
        hp2 = setup_solver_param(config, eqn=True)
        hp2.order = 6
        timer.start()
        rsolver = ANMEqnSolver(model2, model2.x0(), f_load_sub, hp2)
        if progress:
            print("refine %s:" % name, end="", flush=True)
        xt = run_anm_eqn(rsolver, progress)
        timer.stop()
        vtx_coord[~mask] = np.asarray(xt).reshape(-1)
        solvers.append(rsolver)

    vtx_coord[mask] = vtx_dst_boundary[mask]
    _delta_stats(jstat, deformable, vtx_coord, eval_force_rms,
                 eval_potential)
    jstat["iter_tot"] = _total_nr_iter[0] - iter_begin
    jstat["iter_deform"] = iters_before_refine - iter_begin
    jstat["iter_refine"] = _total_nr_iter[0] - iters_before_refine
    jstat["time"] = timer.time()
    _total_solve_time[0] += jstat["time"]
    jstat["pade"] = hp.use_pade
    jstat["pade_log"] = getattr(solver, "pade_log", [])
    _solver_stats(jstat, solvers, dev)
    return jstat


def _delta_stats(jstat, deformable, vtx_coord, eval_force_rms,
                 eval_potential):
    m = deformable.mesh
    jstat["force_rms_recomp"] = eval_force_rms()
    jstat["potential_recomp"] = eval_potential()
    jstat["displacement"] = relative_displacement(m.vertices, vtx_coord)
    jstat["nr_inverted"] = get_nr_inverted(m.tets, m.vertices, vtx_coord)
    jstat["V"] = m.nr_vertices
    jstat["F"] = m.nr_tet


# ----------------------------------------------------------------------------
# procedural cuboid tasks (reference fea/main.cpp:623-772)
# ----------------------------------------------------------------------------


def test_single_tet_inverse(config, rootpath=".", device=None):
    """Reference ``test_single_tet_inverse`` (``fea/main.cpp:584-621``):
    the rest shape of one tet whose base is fixed and whose apex, pulled
    down by 1000 N, lands on the given shape."""
    dev = resolve_device(device)
    spacing = float(config["spacing"])
    material = make_material_property(config["material"])
    angle = 2 * math.pi / 3
    coords = np.zeros((4, 3))
    for i in range(3):
        coords[i, 0] = math.cos(angle * i) * spacing
        coords[i, 1] = math.sin(angle * i) * spacing
    coords[3, 2] = spacing
    mesh = TetrahedralMesh(coords, np.arange(4)[None, :])
    body = DeformableBody(material, mesh)
    body.coord_fixed_mask[:3, :] = True
    f_load_full = np.zeros((4, 3))
    f_load_full[3, 2] = -1000.0
    res = run_and_save("single tet inv", config, body, True, f_load_full,
                       device=dev)
    for i in range(4):
        a, b = coords[i], res.mesh.vertices[i]
        print("vertex %d: (%.3f, %.3f, %.3f) -> (%.3f, %.3f, %.3f)"
              % (i, *a, *b))
    return res


def test_cuboid(config, rootpath=".", device=None):
    """Reference ``test_cuboid`` (``fea/main.cpp:623-663``): a cuboid
    fixed at x = 0 under a downward load on a bottom strip."""
    dev = resolve_device(device)
    nx, ny, nz = int(config["x"]), int(config["y"]), int(config["z"])
    spacing = float(config["spacing"])
    material = make_material_property(config["material"])
    mesh = TetrahedralMesh.make_cuboid(nx, ny, nz, spacing)
    body = DeformableBody(material, mesh)
    vtx = mesh.vertices
    body.coord_fixed_mask[vtx[:, 0] <= spacing / 2, :] = True
    f_load_full = np.zeros((mesh.nr_vertices, 3))
    sel = (vtx[:, 0] > (nx // 2 - 1) * spacing - spacing / 2) & (
        vtx[:, 2] < spacing / 2)
    f_load_full[sel, 2] = -50.0
    inverse = bool(config.get("inverse", False))
    return run_and_save("cuboid inverse" if inverse else "cuboid", config,
                        body, inverse, f_load_full, device=dev)


def _rot(ang, axes):
    """The 3x3 rotation by ``ang`` radians in the plane of ``axes``."""
    rmat = np.eye(3)
    c, s = math.cos(ang), math.sin(ang)
    i, j = axes
    rmat[i, i], rmat[i, j], rmat[j, i], rmat[j, j] = c, -s, s, c
    return rmat


def test_cuboid_twist(config, rootpath=".", device=None):
    """Reference ``test_cuboid_twist`` (``fea/main.cpp:665-772``):
    incremental rotation (about x) of the right face, then bend steps
    (rotation about z + shift) with refinement."""
    dev = resolve_device(device)
    nx, ny, nz = int(config["x"]), int(config["y"]), int(config["z"])
    spacing = float(config["spacing"])
    material = make_material_property(config["material"])
    mesh = TetrahedralMesh.make_cuboid(nx, ny, nz, spacing)
    print("cuboid twist: V=%d F=%d" % (mesh.nr_vertices, mesh.nr_tet))
    body = DeformableBody(material, mesh)
    x_thresh = spacing * (nx - 1.5)
    vtx_cur = mesh.vertices.copy()
    left = vtx_cur[:, 0] <= spacing / 2
    right = vtx_cur[:, 0] >= x_thresh
    body.coord_fixed_mask[left | right, :] = True
    vtx_bnd_idx = np.nonzero(right)[0]
    sanm_assert(len(vtx_bnd_idx) > 0)

    vtx_delta = np.zeros_like(vtx_cur)
    out_filename = config["out_filename"]
    save_cnt = [0]

    def save():
        TetrahedralMesh(vtx_cur, mesh.tets, mesh.surface_vtx,
                        mesh.surfaces).write_obj(
            "%s-%d.obj" % (out_filename, save_cnt[0]))
        save_cnt[0] += 1

    last_stat = {}

    def update_to_next(name, vtx_bnd_next, require_refine, cfg):
        nonlocal last_stat
        vtx_delta[:] = 0
        vtx_delta[vtx_bnd_idx] = vtx_bnd_next - vtx_cur[vtx_bnd_idx]
        last_stat = run_with_vtx_delta(name, cfg, body, vtx_delta, vtx_cur,
                                       require_refine, device=dev)
        save()

    cfg_rot = dict(config, save_interm=False)
    rotate_split = float(config.get("rotate_split", 90))
    remain = float(config["rotate"])
    finished = 0.0
    save()
    vtx_bnd_init = vtx_cur[vtx_bnd_idx].copy()
    qcnt = 0
    while remain > 1e-5:
        rot = min(remain, rotate_split)
        remain -= rot
        finished += rot
        nxt = vtx_bnd_init @ _rot(math.radians(finished), (1, 2)).T
        nxt += vtx_bnd_init.mean(0) - nxt.mean(0)
        update_to_next("rot%d(rem %.1f)" % (qcnt, remain), nxt, False,
                       cfg_rot)
        qcnt += 1

    vtx_bnd_init = vtx_cur[vtx_bnd_idx].copy()
    for bend in config["bend"]:
        rmat = _rot(math.radians(float(bend["angle"])), (0, 1))
        nxt = (vtx_bnd_init @ rmat.T
               + np.asarray(bend["shift"], float) * spacing)
        update_to_next("bend", nxt, True, config)

    last_stat["V"] = mesh.nr_vertices
    last_stat["F"] = mesh.nr_tet
    save_json(out_filename + ".json", last_stat)
    out_mesh = mesh.copy()
    out_mesh.replace_vtx(vtx_cur)
    return TaskResult(out_mesh, last_stat)


def twist_setup(config, rootpath="."):
    """Host set-up of the ``mesh_twist`` task: the body (mesh read and
    resized; the surface vertices in the lowest ``ratio_lo`` and highest
    ``ratio_hi`` of the mesh along ``axis`` fixed), the moved (top)
    vertices and the mesh's extent along the axis; writes nothing.
    Returns ``(body, vtx_bnd_idx, proj_dist)``."""
    material = make_material_property(config["material"])
    mesh_file = os.path.join(rootpath, config["mesh"])
    mesh = TetrahedralMesh.from_tetgen_files(mesh_file)
    if float(config.get("scale", 0)) > 0:
        mesh.resize_inplace(float(config["scale"]))
    print("mesh twist: V=%d F=%d" % (mesh.nr_vertices, mesh.nr_tet))
    body = DeformableBody(material, mesh)
    p = mesh.vertices @ np.asarray(config["axis"], float)
    proj_dist = float(p.max() - p.min())
    th0 = p.min() + (p.max() - p.min()) * float(config["ratio_lo"])
    th1 = p.min() + (p.max() - p.min()) * (1 - float(config["ratio_hi"]))
    include_int = bool(config.get("include_int_points", False))
    surface = np.zeros(mesh.nr_vertices, bool)
    sanm_assert(mesh.surface_vtx)
    surface[list(mesh.surface_vtx)] = True
    print("proj range: %g %g thr=%g,%g" % (p.min(), p.max(), th0, th1))
    sel = ((p <= th0) | (p >= th1)) & (surface | include_int)
    body.coord_fixed_mask[sel, :] = True
    return body, np.nonzero(sel & (p >= th1))[0], proj_dist


def twist_delta(config, vtx_cur, vtx_bnd_idx, proj_dist):
    """``vtx_delta`` (V, 3): the moved vertices of ``vtx_cur`` taken
    through the config's rotations and shifts (``transforms``, else the
    config itself), zero elsewhere."""
    vtx_bnd_next = vtx_cur[vtx_bnd_idx].copy()
    for tc in config.get("transforms", [config]):
        ax = [i for i in range(3) if i != int(tc.get("rot_axis", 2))]
        rmat = _rot(math.radians(float(tc["angle"])), ax)
        vtx_bnd_next = (vtx_bnd_next @ rmat.T
                        + np.asarray(tc["shift"], float) * proj_dist)
    vtx_delta = np.zeros_like(vtx_cur)
    vtx_delta[vtx_bnd_idx] = vtx_bnd_next - vtx_cur[vtx_bnd_idx]
    return vtx_delta


def mesh_twist(config, rootpath=".", device=None):
    """Reference ``mesh_twist`` (``fea/main.cpp:774-919``): the body of
    :func:`twist_setup`, after an optional gravity sag
    (``add_gravity``), follows its moved vertices
    (:func:`twist_delta`) by :func:`run_with_vtx_delta`."""
    dev = resolve_device(device)
    body, vtx_bnd_idx, proj_dist = twist_setup(config, rootpath)
    mesh = body.mesh
    out_filename = config["out_filename"]
    fixed_vid = set(np.nonzero(body.coord_fixed_mask[:, 0])[0].tolist())
    mesh.write_obj(out_filename + "-orig.obj")
    mesh.write_obj(out_filename + "-boundary.obj", fixed_vid)

    f_load_full = None
    if config.get("add_gravity", False):
        g_acc = np.asarray(config["g"], float)
        f_load_full, tot = _gravity_load(mesh, body.material, g_acc)
        print("add gravity=%.3f" % tot)
        mesh_deformed = run_and_save(
            "gravity_init", dict(config, save_interm=False), body, False,
            f_load_full, save=False, device=dev).mesh
        mesh_deformed.write_obj(out_filename + "-gravity.obj")
        vtx_cur = mesh_deformed.vertices.copy()
    else:
        vtx_cur = mesh.vertices.copy()
    vtx_delta = twist_delta(config, vtx_cur, vtx_bnd_idx, proj_dist)

    mesh_copy = mesh.copy()
    mesh_copy.replace_vtx(vtx_cur + vtx_delta)
    mesh_copy.write_obj(out_filename + "-boundary-dst.obj", fixed_vid)

    stat = run_with_vtx_delta("mesh_twist", config, body, vtx_delta, vtx_cur,
                              False, f_load_full, device=dev)
    mesh.replace_vtx(vtx_cur)
    mesh.write_obj(out_filename + ".obj")
    save_json(out_filename + ".json", stat)
    if "out_surface_vtx" in config:
        mesh.write_surface_vtx(config["out_surface_vtx"])
    return TaskResult(mesh, stat)


def _with_warm_rerun(fn):
    """Warm-timing wrapper of the continuation tasks (``mesh_twist``,
    ``test_cuboid_twist``), whose solvers are rebuilt for every
    transform step: under ``SANM_WARM_TIMING`` the whole task runs a
    second time in the same process (kernels built, caches warm), and
    the re-run's result is returned, with ``time_solve_warm`` (the solve
    timers of the re-run) and ``time_task_warm`` (its wall time) in its
    stat; the first run's result is kept as its ``cold`` attribute."""

    def wrapped(config, rootpath=".", device=None):
        res = fn(config, rootpath, device=device)
        if os.environ.get("SANM_WARM_TIMING"):
            cold = res
            solve_begin = _total_solve_time[0]
            t = Timer().start()
            res = fn(config, rootpath, device=device)
            wall = t.stop().time()
            res.stat["time_solve_warm"] = _total_solve_time[0] - solve_begin
            res.stat["time_task_warm"] = wall
            save_json(config["out_filename"] + ".json", res.stat)
            res.cold = cold
        return res

    wrapped.__name__ = fn.__name__
    wrapped.__doc__ = fn.__doc__
    return wrapped


TASKS = {
    "test_single_tet_inverse": test_single_tet_inverse,
    "test_cuboid": test_cuboid,
    "test_cuboid_twist": _with_warm_rerun(test_cuboid_twist),
    "gravity": gravity,
    "mesh_twist": _with_warm_rerun(mesh_twist),
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
