#!/usr/bin/env python3
"""The port's band factor (K5b) and band solve (K5c) of two checkouts,
compared on one CUDA card in one process.

    python3 scripts/torch_band_ab.py OTHER_ROOT

Builds OTHER_ROOT's kernel library (its own ``sanm_tpu_torch/kernels.py``,
in a subprocess) beside this checkout's, assembles the band of the
armadillo-small NHC Jacobian at rest once (this checkout's K5a), and with
each library factors it and solves the scaled load.  Each library's
factor and solve are captured in a CUDA graph and replayed, timed as
``chip_smoke.py`` times them (CUDA events, L2 flushed, host work behind
a ~10 ms spin), in the order this, other, other, this, ``ROUNDS`` times.
Prints the two libraries' max output differences and, per kernel, each
library's mean and per-round times, then one JSON line of them.  Exits
non-zero without a CUDA card, or when the outputs differ by more than
1e-12 relative."""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

ROUNDS = 5
NAMES = ("sanm_band_factor", "sanm_band_solve")
TRIES = 3


class Timing(cs.Timing):
    """``chip_smoke.py``'s timing with a ~10 ms spin: a stall of the
    shared host outlasts its 2 ms one now and then."""

    COVER_CYCLES = 20_000_000


def graph_ms(timing, fn, reps, setup=None):
    """``Timing.graph_ms``, measured again (at most ``TRIES`` times) when
    a replay's host work was not covered by the spin."""
    for _ in range(TRIES - 1):
        try:
            return timing.graph_ms(fn, reps, setup)
        except cs.Fail as e:
            cs.say("timing: %s; measured again" % e)
    return timing.graph_ms(fn, reps, setup)


def other_library(root, signatures):
    """OTHER_ROOT's kernel library, built by its own ``kernels.build``."""
    code = ("import sys; sys.path.insert(0, %r); "
            "from sanm_tpu_torch import kernels; print(kernels.build())"
            % root)
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    cs.require(res.returncode == 0, "build of %s failed:\n%s"
               % (root, res.stderr[-4000:]))
    lib = ctypes.CDLL(res.stdout.split()[-1])
    for name in NAMES:
        fn = getattr(lib, name)
        fn.argtypes = signatures[name]
        fn.restype = ctypes.c_int
    return lib


def main(argv):
    if len(argv) != 1 or not os.path.isdir(argv[0]):
        print("usage: python3 scripts/torch_band_ab.py OTHER_ROOT",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch_band_ab: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.solver import band as K5

    cs.say(cs.card_line())
    libs = {"this": kernels.library(),
            "other": other_library(os.path.abspath(argv[0]),
                                   kernels._SIGNATURES)}
    model, f_load = cs.armadillo_model()
    asm = model.asm
    data, _, _ = model.jac_asm(asm.apply_in(model.x0()))
    plan = K5.BandPlan(asm.csr_rowidx, asm.csr_cols, asm.n)
    arrs = plan.on("cuda")
    band, scale = K5.band_assemble(plan, data)
    rhs = torch.as_tensor(f_load, dtype=torch.float64).cuda() * scale
    f64 = torch.float64
    work_band = torch.empty_like(band)
    npanel = int(plan.panel_off[-1])
    bufs = {k: dict(panels=torch.empty(npanel, dtype=f64, device="cuda"),
                    work=torch.empty(plan.nrow_tot, dtype=f64, device="cuda"),
                    partial=torch.empty((2 * plan.w, plan.s), dtype=f64,
                                        device="cuda"),
                    out=torch.empty(plan.n, dtype=f64, device="cuda"))
            for k in libs}

    def check(err):
        cs.require(err == 0, "launch failed: CUDA error %d" % err)

    def factor(k):
        b = bufs[k]
        check(libs[k].sanm_band_factor(
            work_band.data_ptr(), b["panels"].data_ptr(),
            plan.panel_off.ctypes.data, plan.blk_w.ctypes.data, plan.nb,
            plan.w, torch.cuda.current_stream().cuda_stream))

    def solve(k):
        b = bufs[k]
        check(libs[k].sanm_band_solve(
            b["panels"].data_ptr(), plan.panel_off.ctypes.data,
            plan.blk_w.ctypes.data, arrs["perm_ext"].data_ptr(),
            arrs["invp_ext"].data_ptr(), rhs.data_ptr(), b["work"].data_ptr(),
            b["partial"].data_ptr(), b["out"].data_ptr(), plan.n,
            plan.nrow_tot, plan.nb, torch.cuda.current_stream().cuda_stream))

    def restore():
        work_band.copy_(band)

    for k in libs:
        restore()
        factor(k)
        solve(k)
    torch.cuda.synchronize()
    diffs = {}
    for name, a, b in (("panels", bufs["this"]["panels"],
                        bufs["other"]["panels"]),
                       ("solve", bufs["this"]["out"], bufs["other"]["out"])):
        diffs[name] = cs.rel_err(a, b)[1]
        cs.say("%s: max |this - other| / max |other| = %.3e"
               % (name, diffs[name]))
        cs.require(diffs[name] <= 1e-12, "the two libraries' %s differ"
                   % name)

    timing = Timing(torch)
    times = {kern: {k: [] for k in libs} for kern in NAMES}
    for _ in range(ROUNDS):
        for k in ("this", "other", "other", "this"):
            times["sanm_band_factor"][k].append(graph_ms(
                timing, lambda: factor(k), 2, restore))
            times["sanm_band_solve"][k].append(graph_ms(
                timing, lambda: solve(k), 10))
    out = {}
    for kern, by in times.items():
        for k, ts in by.items():
            mean = sum(ts) / len(ts)
            out["%s_%s_ms" % (kern, k)] = mean
            cs.say("%s %s: mean %.4f ms over %d readings: %s" % (
                kern, k, mean, len(ts), " ".join("%.4f" % t for t in ts)))
        cs.say("%s: this / other = %.4f" % (
            kern, out["%s_this_ms" % kern] / out["%s_other_ms" % kern]))
    print(json.dumps(dict(out, **{"max_rel_diff_" + k: v
                                  for k, v in diffs.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
