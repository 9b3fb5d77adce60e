#!/usr/bin/env python3
"""The port's forward Jacobian kernels K3 (NHC), K3n (NHI) and K8c (ARAP)
of two checkouts, compared on one CUDA card in one process.

    python3 scripts/torch_jac_ab.py OTHER_ROOT

Builds OTHER_ROOT's kernel library (its own ``sanm_tpu_torch/kernels.py``,
in a subprocess) beside this checkout's.  On the armadillo-small mesh with
each of the three materials, at its rest shape moved by a seeded random
displacement, it runs both libraries' ``sanm_jac_asm``,
``sanm_jac_asm_nhi`` and ``sanm_jac_asm_arap`` on the same inputs and
prints how far their E and CSR values differ: the largest difference over
the largest value, and the share of values with the same bits.  Each
kernel is then timed as ``chip_smoke.py`` times it (CUDA events, L2
flushed, host work behind a spin), in the order this, other, other, this,
``ROUNDS`` times.  Ends with one JSON line of the differences and mean
times.  Exits non-zero without a CUDA card, or when the outputs differ by
more than ``TOL`` relative."""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

ROUNDS = 5
TOL = 1e-12
SEED = 11
#: the random displacement, relative to the mesh's largest coordinate
#: (det F of every element in 0.82-1.14 with SEED)
SCALE = 2e-5
#: per kernel: its C entry point and the override file of its material
CASES = (("jac_asm", "sanm_jac_asm", None),
         ("jac_asm_nhi", "sanm_jac_asm_nhi", "override_neo_incomp.json"),
         ("jac_asm_arap", "sanm_jac_asm_arap", "override_arap.json"))


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
    for _, fn_name, _ in CASES:
        fn = getattr(lib, fn_name)
        fn.argtypes = signatures[fn_name]
        fn.restype = ctypes.c_int
    return lib


def case_inputs(torch, override):
    """The model of armadillo-small with ``override`` and the kernel's
    leading pointers and constants at the displaced state."""
    from sanm_tpu_torch.ops.svd_w import svd_w

    configs = [cs.CONFIG] + ([os.path.join(ROOT, "configs", override)]
                             if override else [])
    model, _ = cs.armadillo_model(configs)
    asm, elems = model.asm, model.elems
    x0 = model.x0()
    rng = np.random.default_rng(SEED)
    x = x0 + SCALE * float(np.abs(x0).max()) * rng.uniform(-1, 1, x0.shape)
    gin = asm.apply_in(x)
    F = elems.deformation_gradient(gin)
    cs.require(bool((torch.linalg.det(F) > 0).all()),
               "the displaced state inverts an element")
    if override == "override_arap.json":
        keep = svd_w(F)
        ptrs = [t.data_ptr() for t in keep] + [elems.dminv.data_ptr()]
        consts = (float(elems.mu),)
    else:
        keep = (gin,)
        c2 = elems.kappa if override else elems.lam
        ptrs = [gin.data_ptr(), elems.bias.data_ptr(),
                elems.dminv.data_ptr()]
        consts = (float(elems.mu), float(c2))
    return model, keep, ptrs, consts


def main(argv):
    if len(argv) != 1 or not os.path.isdir(argv[0]):
        print("usage: python3 scripts/torch_jac_ab.py OTHER_ROOT",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch_jac_ab: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from sanm_tpu_torch import kernels

    cs.say(cs.card_line())
    libs = {"this": kernels.library(),
            "other": other_library(os.path.abspath(argv[0]),
                                   kernels._SIGNATURES)}
    timing = cs.Timing(torch)
    out = {}
    for name, fn_name, override in CASES:
        model, keep, ptrs, consts = case_inputs(torch, override)
        asm = model.asm
        bufs = {k: (torch.empty((asm.B, asm.Dout, asm.Din),
                                dtype=torch.float64, device="cuda"),
                    torch.empty(asm.nnz, dtype=torch.float64, device="cuda"))
                for k in libs}

        def run(k):
            E, data = bufs[k]
            err = getattr(libs[k], fn_name)(
                *ptrs, asm.Lout.data_ptr(), asm.Lin.data_ptr(),
                asm.nz_ptr.data_ptr(), asm.nz_slot.data_ptr(), E.data_ptr(),
                data.data_ptr(), asm.B, asm.Dout, asm.Din, asm.nnz, *consts,
                torch.cuda.current_stream().cuda_stream)
            cs.require(err == 0, "%s launch failed: CUDA error %d"
                       % (fn_name, err))

        for k in libs:
            run(k)
        torch.cuda.synchronize()
        for part, i in (("E", 0), ("data", 1)):
            a, b = bufs["this"][i], bufs["other"][i]
            rel = cs.rel_err(a, b)[1]
            same = float((a == b).double().mean())
            out["%s_%s_max_rel_diff" % (name, part)] = rel
            out["%s_%s_same_bits" % (name, part)] = same
            cs.say("%s %s: max |this - other| / max |other| = %.3e, "
                   "%.4f of the values have the same bits"
                   % (name, part, rel, same))
            cs.require(rel <= TOL, "the two libraries' %s %s differ"
                       % (name, part))
        times = {k: [] for k in libs}
        for _ in range(ROUNDS):
            for k in ("this", "other", "other", "this"):
                times[k].append(timing.kernel_ms(lambda: run(k), reps=5))
        for k, ts in times.items():
            mean = sum(ts) / len(ts)
            out["%s_%s_ms" % (name, k)] = mean
            cs.say("%s %s: mean %.4f ms over %d readings: %s" % (
                name, k, mean, len(ts), " ".join("%.4f" % t for t in ts)))
        cs.say("%s: this / other = %.4f" % (
            name, out["%s_this_ms" % name] / out["%s_other_ms" % name]))
        del model, keep, bufs
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
