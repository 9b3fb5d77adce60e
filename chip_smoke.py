#!/usr/bin/env python3
"""Smoke test of the sanm_tpu_torch port on one CUDA card.

    python3 chip_smoke.py [--out DIR]

Phases, each timed:

1. the card's name and power limit (``nvidia-smi``);
2. build: one ``nvcc`` call compiles every ``sanm_tpu_torch/csrc/*.cu``
   into the gitignored ``sanm_tpu_torch/_build/``;
3. slice: ``gravity`` on ``configs/armadillo_small.json`` (NHC, order 20,
   Pade on) through the port's entry point, cold and warm, to force-RMS
   <= 1e-10; every kernel's launch count in that run must be > 0;
4. kernels: K1, K2 (remap_in, remap_out) and K3 are each held against
   their plain PyTorch version on the armadillo-small model state, with
   the f64 tolerances in ``TOL``: remap_in, K3 and remap_out at the
   deformed equilibrium the slice converged to, remap_out also on every
   K1 bias, K1 along a real first ANM restart (bias orders 2..20);
   kernel, plain and (where one PyTorch call computes the same function)
   library times, and the least time the card could take (``bound``);
5. parity: NHC equilibrium of a small cuboid, order 20, solved through
   the kernels and through the plain versions on the CPU: same
   iterations, coordinates within ``PARITY_RTOL``.

It then prints the ``{"kernels": [...]}`` line and, last, the result line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and no result line is printed; the same holds without a
CUDA device.  A watchdog (``faulthandler``) turns a hang into a stack
dump and a non-zero exit after ``BUDGET_S`` seconds.  Outputs of the
solve go to a temporary directory; only ``--out`` writes a log there.
"""

import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import time

BUDGET_S = 300
ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "armadillo_small.json")
# H100 SXM data sheet: HBM3 3.35 TB/s, f64 without tensor cores 34 TFLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F64_S = 34e12
# kernel vs plain, max |diff| / max |plain| (per component group for K1):
# f64 sums in another order (and with fused multiply-adds) than torch's
TOL = {"remap_in": 1e-13, "remap_out": 1e-12, "jac_asm": 1e-12,
       "nhc_step": 1e-11}
PARITY_RTOL = 1e-9
RMS_TARGET = 1e-10
REPLACES = {
    "remap_in": "sanm_tpu/solver/remap.py:308",
    "remap_out": "sanm_tpu/solver/remap.py:327",
    "jac_asm": "sanm_tpu/solver/anm.py:278",
    "nhc_step": "sanm_tpu/solver/anm.py:293",
}
SOURCES = {
    "remap_in": "sanm_tpu_torch/csrc/remap.cu",
    "remap_out": "sanm_tpu_torch/csrc/remap.cu",
    "jac_asm": "sanm_tpu_torch/csrc/jac_asm.cu",
    "nhc_step": "sanm_tpu_torch/csrc/nhc_series.cu",
}

_T0 = time.perf_counter()
_LOG = []


def say(*parts):
    line = " ".join(str(p) for p in parts)
    print(line, flush=True)
    _LOG.append(line)


def phase_done(name, t0):
    say("[phase] %s: %.2f s (elapsed %.2f s)"
        % (name, time.perf_counter() - t0, time.perf_counter() - _T0))


class Fail(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise Fail(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class Timing:
    """Per-launch CUDA-event timing with the 50 MB L2 flushed before each
    launch, as the main path finds its operands (other kernels stream
    hundreds of MB between two launches of one kernel).

    A spin kernel of ``COVER_CYCLES`` runs between the flush and the start
    event, so the host work of a call (argument checks, allocation, the
    ctypes launch) is done while the card is still busy and the events
    bracket device time only.  ``host_ms`` keeps the longest host time of
    a timed call; where it exceeds ``cover_ms`` the excess is in the
    reading (so it is for the plain versions, whose host work is most of
    their cost)."""

    COVER_CYCLES = 4_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(self.COVER_CYCLES)
        s.record()
        torch.cuda._sleep(self.COVER_CYCLES)
        e.record()
        torch.cuda.synchronize()
        self.cover_ms = s.elapsed_time(e)
        self.host_ms = 0.0

    def ms(self, fn, reps=10, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        self.host_ms = 0.0
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(self.COVER_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            s.record()
            fn()
            e.record()
            self.host_ms = max(self.host_ms,
                               (time.perf_counter() - h0) * 1e3)
            torch.cuda.synchronize()
            total += s.elapsed_time(e)
        return total / reps

    def kernel_ms(self, fn, reps=10, warmup=2):
        """Device time of a kernel wrapper; fails if its host work was not
        hidden behind the spin."""
        t = self.ms(fn, reps, warmup)
        require(self.host_ms < self.cover_ms,
                "host work of a timed launch (%.3f ms) not covered by the "
                "spin (%.3f ms)" % (self.host_ms, self.cover_ms))
        return t


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(bytes_moved, flops):
    tb = bytes_moved / PEAK_BYTES_S * 1e3
    tf = flops / PEAK_F64_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def k1_flops(k):
    """f64 operations per element of K1 at commit order k + bias k+1,
    counting only terms the data needs (not the zero g_{k+1} terms)."""
    m = k + 1
    commit = 36 * (k + 1) + 9 + 6 * (k + 1) + 9 * (2 * k + 1) + 3 * k + 18
    bias = 36 * (m - 1) + 9 + 6 * m + 9 * (2 * m + 1) + 3 * m + 27 * (m + 1)
    return commit + bias


def rel_err(a, b):
    d = float((a - b).abs().max())
    s = float(b.abs().max())
    return d, d / s if s > 0 else d


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(res.returncode == 0 and res.stdout.strip(),
            "nvidia-smi failed: %s" % res.stderr)
    return res.stdout.strip().splitlines()[0]


def phase_build():
    from sanm_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.library()
    info = kernels.BUILD_INFO
    say("build: %s in %.2f s (%s)" % (
        os.path.relpath(info["path"], ROOT), info["seconds"],
        "cached" if info["cached"] else "one nvcc call"))
    for line in info.get("report", "").splitlines():
        if "registers" in line or "spill" in line:
            say("  ptxas:", line.strip())
    phase_done("build", t0)
    return info["seconds"]


def armadillo_model():
    """The gravity task's model on the card (its own host set-up,
    ``app.gravity_setup``) and the load vector."""
    from sanm_tpu_torch.fea import app

    cfg = app.read_json(CONFIG)
    body, f_full, _ = app.gravity_setup(cfg, os.path.dirname(CONFIG))
    model = body.make_forward(app.energy_model_of(cfg), device="cuda")
    return model, model.lt_inp.copy_vtx_values(f_full)


def phase_kernels(torch, timing, verts_eq):
    """Each kernel against its plain version; ``verts_eq`` are the
    vertices of the equilibrium the slice converged to."""
    import numpy as np
    import scipy.sparse as sp

    from sanm_tpu_torch.ops import nhc_series as K1
    from sanm_tpu_torch.solver import assemble as K23
    from sanm_tpu_torch.solver.linear import host_splu

    t0 = time.perf_counter()
    model, f_load = armadillo_model()
    asm, elems = model.asm, model.elems
    n, B = asm.n, asm.B
    say("model: B=%d n=%d nnz=%d Din=%d Dout=%d (host prep %.2f s); "
        "timing spin %.3f ms" % (B, n, asm.nnz, asm.Din, asm.Dout,
                                 time.perf_counter() - t0, timing.cover_ms))
    rows = {}

    def report(name, err, rel, ms, plain_ms, bnd, lib_ms=None, extra=""):
        b_ms, b_by = bnd
        require(rel <= TOL[name], "%s disagrees with its plain version: "
                "rel err %.3g > %.1g" % (name, rel, TOL[name]))
        say("kernel %-9s max_abs_err=%.3e rel=%.3e (tol %.0e) ms=%.4f "
            "plain_ms=%.4f bound_us=%.2f (%s) library_ms=%s %s"
            % (name, err, rel, TOL[name], ms, plain_ms, b_ms * 1e3, b_by,
               "%.4f" % lib_ms if lib_ms is not None else "null", extra))
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

    # ---- K2 remap_in at the deformed equilibrium ----
    x_eq = model.lt_inp.copy_vtx_values(verts_eq)
    xp = asm.pad_vector(x_eq)
    gin = K23.remap_in(asm, xp)
    ref = K23.remap_in_plain(asm, xp)
    err, rel = rel_err(gin, ref)
    F = torch.bmm((gin + elems.bias).reshape(B, 3, 3),
                  elems.dminv.reshape(B, 3, 3))
    strain = float((F - torch.eye(3, dtype=F.dtype, device="cuda"))
                   .abs().max())
    say("deformed state: max |F - I| = %.4f over %d tets" % (strain, B))
    require(strain >= 1e-3, "the equilibrium is not deformed")
    del F
    S_in = torch.sparse_csr_tensor(
        torch.arange(0, B * 9 * asm.Din + 1, asm.Din, device="cuda"),
        asm.loc_cols.long()[:, None, :].expand(B, 9, asm.Din).reshape(-1),
        asm.Lin.reshape(-1), size=(B * 9, n + 2))
    lib_in = timing.ms(lambda: S_in @ xp)
    err_lib, _ = rel_err((S_in @ xp).reshape(B, 9), ref)
    report("remap_in", err, rel,
           timing.kernel_ms(lambda: K23.remap_in(asm, xp)),
           timing.ms(lambda: K23.remap_in_plain(asm, xp)),
           bound_ms(nbytes(asm.Lin, asm.loc_cols, xp, gin),
                    2 * B * 9 * asm.Din), lib_in,
           "(library err %.1e)" % err_lib)
    del S_in

    # ---- K3 at the deformed equilibrium ----
    data, E = K23.jac_asm(asm, elems, gin)
    data_p, E_p = K23.jac_asm_plain(asm, elems, gin)
    err, rel = rel_err(data, data_p)
    err_e, rel_e = rel_err(E, E_p)
    flops = B * (800 + asm.Dout * 9 * 9 * 2 + asm.Dout * asm.Din * 9 * 2)
    report("jac_asm", max(err, err_e), max(rel, rel_e),
           timing.kernel_ms(lambda: K23.jac_asm(asm, elems, gin), reps=5),
           timing.ms(lambda: K23.jac_asm_plain(asm, elems, gin), reps=3),
           bound_ms(nbytes(gin, elems.bias, elems.dminv, asm.Lout, asm.Lin,
                           asm.nz_ptr, asm.nz_slot, E, data), flops))
    del data, E, data_p, E_p

    # ---- K2 remap_out on the stress at the equilibrium; its error is
    # joined below by the K1 biases of the restart ----
    bb = model.stress(gin).contiguous()
    out = K23.remap_out(asm, bb)
    ref = K23.remap_out_plain(asm, bb)
    out_err, out_rel = rel_err(out, ref)
    nent = int(asm.row_ent.numel())
    ent = asm.row_ent.long()
    S_out = torch.sparse_csr_tensor(
        asm.row_ptr.long() * 9,
        ((ent // asm.Dout) * 9)[:, None].add(
            torch.arange(9, device="cuda")).reshape(-1),
        asm.Lout.reshape(-1, 9)[ent].reshape(-1),
        size=(n, B * 9))
    bflat = bb.reshape(-1)
    lib_out = timing.ms(lambda: S_out @ bflat)
    err_lib_out, _ = rel_err(S_out @ bflat, ref)
    out_ms = timing.kernel_ms(lambda: K23.remap_out(asm, bb))
    out_plain_ms = timing.ms(lambda: K23.remap_out_plain(asm, bb))
    out_bnd = bound_ms(nbytes(asm.Lout, bb, asm.row_ptr, asm.row_ent, out),
                       2 * nent * 9 + nent)
    del S_out

    # ---- K1 along a real first restart from the rest shape (f(x0) + y
    # as the homotopy) ----
    gin0 = K23.remap_in(asm, asm.pad_vector(model.x0()))
    data0, _ = K23.jac_asm(asm, elems, gin0)
    A = sp.csr_matrix((data0.cpu().numpy(), (asm.csr_rowidx, asm.csr_cols)),
                      shape=(n, n))
    del data0
    solve = host_splu(A.tocsc()).solve
    v = K23.remap_out(asm, model.stress(gin0)).cpu().numpy() + f_load
    xgt = solve(v)
    t1 = 1.0 / np.sqrt(xgt @ xgt + 1.0)
    x1 = -t1 * xgt
    order = 20
    series = K1.NHCSeries(elems, order)
    series.start(gin0)
    xt_k = np.concatenate([x1, [t1]])
    worst, ms_k, plain_k, bnd_k, err_k = 0.0, [], [], [], 0.0
    for k in range(1, order):
        gin_k = asm.apply_in(xt_k)
        hist_k = series.hist[: k + 2]  # rows the step reads and writes
        snap = hist_k.clone()
        b_plain = torch.empty_like(series.bias_out)
        K1.nhc_step_plain(snap, k, gin_k, elems, b_plain)
        b = series.step(k, gin_k)
        e_b, r_b = rel_err(b, b_plain)
        r_h = max(rel_err(series.hist[k, sl], snap[k, sl])[1]
                  for sl in K1.GROUPS)
        worst = max(worst, r_b, r_h)
        err_k = max(err_k, e_b)
        ms = timing.kernel_ms(lambda: K1.nhc_step(
            hist_k, k, gin_k, elems, series.bias_out), reps=5)
        pms = timing.ms(lambda: K1.nhc_step_plain(snap, k, gin_k, elems,
                                                  b_plain), reps=2, warmup=1)
        m = k + 1
        # reads the 23 history components of orders < k, gin, Dm^-1;
        # writes order k's components and the bias
        bnd = bound_ms(8 * B * (K1.NCOMP * (k + 1) + 27), B * k1_flops(k))
        ms_k.append(ms)
        plain_k.append(pms)
        bnd_k.append(bnd[0])
        if k in (1, 9, 19):
            say("  K1 bias order %2d: rel err bias %.2e hist %.2e, ms=%.4f "
                "plain_ms=%.3f bound_us=%.2f (%s)"
                % (m, r_b, r_h, ms, pms, bnd[0] * 1e3, bnd[1]))
        del snap
        # remap_out on this real bias, then the next order's coefficient
        # through the host solve
        rb = K23.remap_out(asm, b)
        e_o, r_o = rel_err(rb, K23.remap_out_plain(asm, b))
        out_err, out_rel = max(out_err, e_o), max(out_rel, r_o)
        xb = solve(rb.cpu().numpy())
        tk = (xb @ x1) / (t1 - x1 @ xgt)
        xt_k = np.concatenate([-tk * xgt - xb, [tk]])
        require(np.isfinite(xt_k).all(), "non-finite series at order %d" % m)
    report("nhc_step", err_k, worst, float(np.mean(ms_k)),
           float(np.mean(plain_k)), (float(np.mean(bnd_k)), "bytes"),
           extra="(mean over the 19 per-order launches of one restart)")
    report("remap_out", out_err, out_rel, out_ms, out_plain_ms, out_bnd,
           lib_out, "(error over the equilibrium stress and the 19 K1 "
           "biases; times on the stress; library err %.1e)" % err_lib_out)
    del series
    torch.cuda.empty_cache()
    phase_done("kernels", t0)
    return rows


def cuboid_solve(device):
    import numpy as np

    from sanm_tpu_torch.fea import (DeformableBody, EnergyModel,
                                    MaterialProperty, TetrahedralMesh)
    from sanm_tpu_torch.fea.app import RMS_THRESH_FORCE_EQU, run_anm_eqn
    from sanm_tpu_torch.solver import ANMEqnSolver, EqnHyperParam

    nx, ny, nz, h = 6, 4, 4, 0.025
    mesh = TetrahedralMesh.make_cuboid(nx, ny, nz, h)
    body = DeformableBody(MaterialProperty.from_young_poisson(1e7, 0.45),
                          mesh)
    body.coord_fixed_mask[mesh.vertices[:, 0] <= h / 2, :] = True
    f = np.zeros((mesh.nr_vertices, 3))
    f[mesh.vertices[:, 0] > (nx - 1) * h - h / 2, 2] = -200.0
    model = body.make_forward(EnergyModel.NEOHOOKEAN_C, device=device)
    fs = model.lt_inp.copy_vtx_values(f)
    hp = EqnHyperParam(order=20, use_pade=True)
    hp.converge_rms = RMS_THRESH_FORCE_EQU
    hp.solution_check_tol = 1e-3
    s = ANMEqnSolver(model, model.x0(), fs, hp)
    x = run_anm_eqn(s, progress=False)
    rms = DeformableBody.compute_force_rms(model, x, fs)
    return s.get_nr_iter(), x, rms


def phase_parity():
    import numpy as np

    t0 = time.perf_counter()
    it_c, x_c, rms_c = cuboid_solve("cuda")
    it_p, x_p, rms_p = cuboid_solve("cpu")
    rel = float(np.abs(x_c - x_p).max() / np.abs(x_p).max())
    say("parity cuboid (225 tets, order 20): iter card %d / cpu %d, "
        "force-RMS card %.3e / cpu %.3e, coord rel diff %.3e (tol %.0e)"
        % (it_c, it_p, rms_c, rms_p, rel, PARITY_RTOL))
    require(it_c == it_p, "iterations differ between card and CPU")
    require(rel <= PARITY_RTOL, "card and CPU solutions differ")
    require(max(rms_c, rms_p) <= RMS_TARGET, "cuboid not converged")
    phase_done("parity", t0)


def phase_slice(torch):
    import numpy as np

    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.fea import app
    from sanm_tpu_torch.utils import ScopedProfiler

    t0 = time.perf_counter()
    os.environ["SANM_WARM_TIMING"] = "1"
    ScopedProfiler.enabled = True
    ScopedProfiler.reset()
    cfg = app.read_json(CONFIG)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            kernels.reset_launches()
            res = app.gravity(cfg, os.path.dirname(CONFIG), device="cuda")
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
        finally:
            os.chdir(cwd)
    st = res.stat
    verts = res.mesh.vertices
    say("slice: iterations=%d" % st["iter"])
    say("slice: force_rms_recomp=%.3e (target %.0e) nr_inverted=%d "
        "displacement=%.4g" % (st["force_rms_recomp"], RMS_TARGET,
                                st["nr_inverted"], st["displacement"]))
    say("slice: time_solve cold=%.3f s warm=%.3f s time_prep=%.3f s"
        % (st["time_solve"], st["time_solve_warm"], st["time_prep"]))
    per = {}
    for name, unit in (("sparse_prep", 1.0), ("sparse_solve", 1.0),
                       ("order_step", 1e3), ("bias_pull", 1e3),
                       ("build_sparse_coeff", 1.0), ("eval_fx0", 1.0)):
        calls, tot = ScopedProfiler.stats(name)
        per[name] = (calls, tot / calls * unit if calls else float("nan"))
    say("slice: factor s/restart=%.4f (%d)  backsolve s/solve=%.5f (%d)  "
        "K1+K2 ms/order=%.4f (%d)  bias_pull ms/order=%.4f (%d)  "
        "jac+K1 start s/restart=%.4f (%d)  f(x0) s=%.4f (%d)" % (
            per["sparse_prep"][1], per["sparse_prep"][0],
            per["sparse_solve"][1], per["sparse_solve"][0],
            per["order_step"][1], per["order_step"][0],
            per["bias_pull"][1], per["bias_pull"][0],
            per["build_sparse_coeff"][1], per["build_sparse_coeff"][0],
            per["eval_fx0"][1], per["eval_fx0"][0]))
    say("slice: launches", json.dumps(launches))
    require(np.isfinite(verts).all() and verts.shape == (13665, 3),
            "bad output mesh")
    require(st["force_rms_recomp"] <= RMS_TARGET, "not converged")
    require(st["nr_inverted"] == 0, "inverted elements")
    for name, count in launches.items():
        require(count > 0, "kernel %s was not launched on the main path"
                % name)
    ScopedProfiler.enabled = False
    phase_done("slice", t0)
    return launches, st, verts


def main(argv):
    out_dir = None
    if len(argv) == 2 and argv[0] == "--out":
        out_dir = argv[1]
    elif argv:
        print("usage: python3 chip_smoke.py [--out DIR]", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(BUDGET_S, exit=True)
    say(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s = phase_build()
    launches, stat, verts_eq = phase_slice(torch)
    timing = Timing(torch)
    rows = phase_kernels(torch, timing, verts_eq)
    del timing
    torch.cuda.empty_cache()
    phase_parity()
    kern = []
    for name in ("nhc_step", "remap_in", "remap_out", "jac_asm"):
        r = rows[name]
        kern.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
    say("build_s=%.2f total_s=%.2f" % (build_s, time.perf_counter() - _T0))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke.log"), "w") as f:
            f.write("\n".join(_LOG) + "\n")
        with open(os.path.join(out_dir, "chip_smoke_stat.json"), "w") as f:
            json.dump(stat, f, indent=1)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
