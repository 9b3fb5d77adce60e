#!/usr/bin/env python3
"""PCG iterations of the port's ``cg`` solver on a task's first system.

    python3 scripts/torch_cg_iters.py [--device cpu|cuda] TASK.json \
        [OVERRIDE.json ...]

Builds the task's model (``gravity`` or ``test_cuboid``) with the port,
takes the Jacobian at the rest shape and the task's load as right-hand
side (the system of the first ANM restart's first solve), and runs
``SparseCG.solve`` (block-Jacobi PCG, the ``cg`` solver) on it twice,
to 1e-6 and to the solver's 1e-13 relative residual ||r|| / ||b||, each
time reading ||r|| after every iteration and without the JAX package's
2,048-iteration limit.  Prints the iterations each goal took and the
true relative residual ||b - A x|| / ||b|| at the end; last, one JSON
line with those numbers.  The default device is the CPU, through the
kernels' plain versions."""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: iterations at most (the JAX package stops at 2,048)
MAX_ITER = 20_000


def task_system(configs, device):
    """The task's model on ``device`` and its load vector, set up as the
    port's entry point sets the task up."""
    from sanm_tpu_torch.fea import app

    cfg = app.merge_configs(configs)
    root = os.path.dirname(os.path.abspath(configs[0]))
    if cfg["func"] == "gravity":
        body, f_full, _ = app.gravity_setup(cfg, root)
    elif cfg["func"] == "test_cuboid":
        body, f_full = app.cuboid_setup(cfg)
    else:
        raise SystemExit("task %s: gravity or test_cuboid only" % cfg["func"])
    model = body.make_forward(app.energy_model_of(cfg), device=device)
    return model, model.lt_inp.copy_vtx_values(f_full)


def main(argv):
    device = "cpu"
    if argv[:1] == ["--device"]:
        device, argv = argv[1], argv[2:]
    if not argv:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    import torch

    from sanm_tpu_torch.solver import assemble as K4
    from sanm_tpu_torch.solver import linear as K9

    model, f = task_system(argv, device)
    asm = model.asm
    data, _, _ = model.jac_asm(K4.remap_in(asm, asm.pad_vector(model.x0())))
    csr = asm.csr_maps
    b = torch.as_tensor(f, dtype=torch.float64).to(asm.device)
    # SparseCG.solve itself, reading ||r|| after every iteration and
    # stopping at MAX_ITER: its live iterations are the count to the goal
    cg = K9.SparseCG(csr, data)
    cg.MAX_ITER, cg.CHUNK = MAX_ITER, 1
    first = {}
    for goal in (1e-6, K9.SparseCG.TOL):
        cg.TOL = goal
        K9.SparseCG.reset_stats()
        x = cg.solve(b)
        live = K9.SparseCG.STATS["iterations"]
        first[goal] = live if live < MAX_ITER else None
    tol = K9.SparseCG.TOL
    true = float(torch.linalg.vector_norm(b - K4.csr_matvec(csr, data, x))
                 / torch.linalg.vector_norm(b))
    out = {"task": [os.path.basename(a) for a in argv], "n": csr.n,
           "nnz": csr.nnz, "iterations_to_1e-6": first.get(1e-6),
           "iterations_to_1e-13": first.get(tol),
           "iterations_run": live, "true_rel_residual": true,
           "within_2048": (first[tol] or MAX_ITER + 1) <= 2048}
    print("%s: n %d, nnz %d; ||r||/||b|| <= 1e-6 after %s iterations, <= "
          "1e-13 after %s; true relative residual %.3e at the end"
          % (" ".join(out["task"]), out["n"], out["nnz"],
             out["iterations_to_1e-6"], out["iterations_to_1e-13"], true))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
