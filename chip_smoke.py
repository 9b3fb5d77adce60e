#!/usr/bin/env python3
"""Smoke test of the sanm_tpu_torch port on one CUDA card.

    python3 chip_smoke.py [--out DIR]

Phases, each timed:

1. the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` compiles every ``sanm_tpu_torch/csrc/*.cu``, one
   process per source, all started together, and links them into the
   gitignored ``sanm_tpu_torch/_build/``;
3. slice: ``gravity`` on ``configs/armadillo_small.json`` (NHC, order 20,
   Pade on) through the port's entry point with ``"solver": "host_lu"``
   (host SuperLU), cold, to force-RMS <= 1e-10, with the JAX package's
   restarts and displacement (``ARMADILLO_DISPLACEMENT``, 1e-9 relative);
   K1-K3 must launch in that run;
4. band: the same task with ``"solver": "band_chol"`` (the card's
   skyline band Cholesky, the path ``auto`` takes on the card), cold and
   warm: force-RMS <= 1e-10, no inverted element, no fallback to host
   LU, coordinates within ``BAND_COORD_RTOL`` of the slice's, the JAX
   package's restarts and displacement, and every one of the eight
   kernels launched in that run;
4b. direct: the same task with ``"solver": "dense_chol"`` (the K6 dense
   blocked Cholesky) and with ``"solver": "spike_band"`` (the K7 SPIKE
   partitioned band), each cold and warm, with the checks of 4 and K6b/c
   or K5a/b + K7b/c launched; the plan sizes, the peak card memory (the
   dense phase fails above 1.5 factors) and the factor, solve,
   refinement and step times are printed;
5. mma probe: the card's f64 mma.sync shapes (m8n8k4, m16n8k4, k8, k16)
   checked against torch on one warp's product and timed on one SM and
   on the card, and the factors' product tile (``tile_nt``) in its
   variants against ``torch.addmm`` at depths 128 and 256;
   kernels: K1, K2 (remap_in, remap_out), K3, K4 (element_matvec) and
   K5 (band_assemble, band_factor, band_solve) are each held against
   their plain PyTorch version on the armadillo-small model state, with
   the f64 tolerances in ``TOL``: remap_in, K3, K4, K5 and remap_out at
   the deformed equilibrium the band phase converged to, remap_out also
   on every K1 bias, K1 along a real first ANM restart (bias orders
   2..20); kernel, plain and (where one PyTorch call computes the same
   function) library times, and the least time the card could take
   (``bound``); the factors' diagonal step alone on the band's first
   diagonal block, against its plain version and timed; K5b and K6b
   repeat their bits; K6b (dense_factor) and K6c (dense_solve) on the dense
   matrix of the same Jacobian, K7b (spike_rhs_solve) on its SPIKE
   spikes' right-hand sides and K7c (spike_solve) on the scaled load,
   with the band rows' dense library times as their yardsticks (K7b: a
   batched cholesky_solve with the dense local factors); K4 COO
   (csr_matvec, csr_matvec_t on a seeded vector, diag_blocks) and K9
   (pcg_step: one iteration and one chunk of 64 from the start of a solve
   of the load, against the plain version on the CPU, whose sums run in
   one order; both repeat their bits) on the same Jacobian, and that
   solve's relative residual and CG functional along its 2,048
   iterations (printed);
6. arap: ``gravity`` on armadillo-small with ``override_arap.json`` and
   ``override_stiff_material.json`` (ARAP, the reference protocol's
   cell), with ``"solver": "host_lu"`` (cold) and with
   ``"solver": "band_chol"`` (cold and warm): force-RMS <= 1e-10, no
   inverted element, the relative displacement within 1e-9 relative of
   the JAX package's CPU value (``ARAP_DISPLACEMENT``), K8a-c (svd_w,
   arap_step, jac_asm_arap) launched, the two equilibria within
   ``BAND_COORD_RTOL``; a fallback of the band factor to host LU is
   counted and printed, and passes if the run converges;
7. arap kernels: K8a (svd_w), K8c (jac_asm_arap) at the ARAP equilibrium
   and K8b (arap_step) along a real first ARAP restart (bias orders
   2..20), each against its plain version, with K8a's flip choice
   compared element by element (also on the equilibrium's mirror image,
   where every element flips), timed as in 5;
8. nhi: ``gravity`` on ``configs/human.json`` as it is (NHI, 78,067
   tets, order 20, Pade on) with ``"solver": "band_chol"``, cold and
   warm: force-RMS <= 1e-10, no inverted element, the relative
   displacement within 1e-9 relative of the JAX package's CPU value
   (``HUMAN_DISPLACEMENT``), K1n, K3n, K2, K4 and K5a-c launched; a band
   fallback to host LU is counted and printed, and passes if the run
   converges (its host-LU leg runs under ``--records``);
9. nhi kernels: K3n (jac_asm_nhi) at the human equilibrium and K1n
   (nhi_step) along a real first restart from the rest shape (bias
   orders 2..20, solved with the card's band factor), each against its
   plain version, timed as in 5;
9b. stvk: ``gravity`` on armadillo-small with
   ``override_stiff_material.json`` and a StVK override written to a
   temporary file (``STVK_OVERRIDE``; StVK diverges at armadillo's own
   material in both packages) on ``"solver": "band_chol"``, cold and
   warm: 2 restarts, force-RMS <= 1e-10, no inverted element, no band
   fallback, the relative displacement within 1e-9 relative of the JAX
   package's CPU value (``STVK_DISPLACEMENT``), K1s, K3s, K2, K4 and
   K5a-c launched and no NHC kernel; then docs/GUIDE.md section 1 (x * x
   = 4) through the function entry point ``ANMEqnSolver(fn, remap_inp,
   remap_out, x0, y, hp)`` with no device given: it runs on the card and
   reaches x = 2 within 1e-9;
9c. stvk kernels: K3s (jac_asm_stvk) at the StVK equilibrium and K1s
   (stvk_step) along a real first restart from the rest shape (bias
   orders 2..20, solved with the card's band factor), each against its
   plain version, timed as in 5; on the same restart the port's Taylor
   engine (``taylor.py``) runs the model's StVK graph on the card at
   full width, and its biases must equal K1s's plain version's within
   1e-11; its ``batched_jacobian`` at the equilibrium must equal K3s's
   plain Jacobian within 1e-12;
10. deform: ``mesh_twist`` on ``configs/armadillo_small.json`` +
   ``armadillo_small_bend_override.json`` as it is (ARAP, implicit
   continuation in t through K3t's t column, then an order-6 refinement)
   with ``"solver": "band_chol"`` (cold and a warm task re-run) and
   ``"host_lu"`` (cold), and the same bend with
   ``override_neo_comp.json`` (NHC) on band_chol (cold): 2 deform + 1
   refine restarts, force-RMS <= 1e-10, no inverted element, the
   displacement within 1e-9 relative of the JAX package's CPU value
   (``DEFORM_DISPLACEMENT``), K3t, K2, K4, K5a-c and the material's
   kernels launched in the band runs; a band fallback to host LU is
   printed and passes if the run converges;
11. deform kernels: K3t (grad_t) at the bend's first restart against its
   plain version, timed as in 5 with ``index_add_`` as its library call;
   K2 remap_in, K8c + K3t and K4 at Din = 13 (a delta on every vertex)
   against theirs;
12. parity: NHC, NHI and ARAP equilibria of a small cuboid, order 20,
   solved through the kernels and through the plain versions on the CPU,
   with host LU, the band, the dense and the SPIKE solvers: same
   iterations, coordinates within ``PARITY_RTOL``; and the Tikhonov
   cuboid of ``tests/test_app_cli.py`` (``CG_PENALTY_TASK``) on ``cg``,
   card against CPU, with csr_matvec_t launched;
13. profile: one warm band_chol re-solve of armadillo-small (NHC) under
   ``torch.profiler``: device time by kernel, the card's busy share and
   the factors' diagonal step's share.

14. inverse: ``gravity`` on ``configs/armadillo_small.json`` (NHC) and
   ``configs/bob.json`` (NHI), each with ``override_inverse.json`` (the
   rest-shape design of the reference protocol's two inverse cells), as
   they are (``auto``, which takes host LU for the inverse model: its
   Jacobian is not symmetric), cold: 1 restart, force-RMS <= 1e-10, no
   inverted element, ``solver_resolved`` host_lu, the relative
   displacement within 1e-9 relative of the JAX package's CPU value
   (``INV_DISPLACEMENT``), K1i and K3i launched and no band kernel; an
   explicit ``band_chol`` on the inverse model must raise;
15. invcheck: ``FEA_INVCHECK=1`` on ``configs/bar.json`` (NHI): forward
   on ``auto`` (band_chol on the card), then the result solved back in
   inverse mode on host LU; the restored rest vertices within
   ``INVCHECK_TOL`` of the original in norm;
16. inverse kernels: K3i at the first restart (the given mesh) and at the
   rest shape found, and K1i along that first restart (bias orders
   2..20), of the armadillo (NHC) and bob (NHI) inverse runs, each
   against its plain version, timed as in 5;
17. baseline: the classical projected Newton baseline
   (``override_baseline.json``) through the port's entry point, cold, on
   the armadillo ARAP bend (``mesh_twist`` with
   ``armadillo_small_bend_override.json`` + ``override_arap.json``):
   force-RMS <= 1e-10, no inverted element, the displacement within
   1e-8 relative of the JAX package's CPU value
   (``BASELINE_DISPLACEMENT``), K10 (the projected Hessian) and the
   refinement's Jacobian kernel launched; Newton and refinement
   iterations, ``time``, ``newton_time``, the host SuperLU share and the
   K10 launches are printed beside the JAX package's CPU iterations.
   K10 also has rows in 5 (NHC at the armadillo equilibrium), 7 (ARAP at
   the ARAP one) and 9 (NHI at human's), each against its plain version
   (1e-11) with ``torch.linalg.eigh`` + clamp + reconstruction of the
   same blocks as its library yardstick; 12 adds projected Newton (NHC,
   NHI, ARAP) and Levenberg-Marquardt (NHC) on the cuboid, card against
   CPU.  The ``kernels`` line's K10 launches are the ARAP bend's for
   ``hess_proj_arap`` and the cuboid's for ``hess_proj`` and
   ``hess_proj_nhi``, whose rows say so (``launches_on``).

18. cg: ``test_cuboid`` on ``configs/test_cuboid.json`` as it is (20 x 8
   x 8 vertices, NHC, order 20) with ``"solver": "cg"`` (the block-Jacobi
   PCG on the card), cold and warm: force-RMS <= 1e-10, no inverted
   element, ``solver_resolved`` cg, the displacement within 1e-9 relative
   of the JAX package's CPU value (``CG_DISPLACEMENT``), K4 COO
   (csr_matvec, diag_blocks) and K9 (pcg_step) launched; the restarts
   beside the JAX package's, the PCG iterations per solve and the
   factor, solve and step times are printed.

``python3 chip_smoke.py --records [--out DIR]`` instead runs only the
build and :func:`phase_records`: ``configs/jet.json`` (NHI, 47,668 tets)
on ``band_chol`` and on ``host_lu``, cold (restarts, force-RMS, the
solver that ran, band fallbacks, refinement trips per solve), the human
ARAP bend on ``band_chol``, cold, the band solve's residual after
each refinement trip on three meshes, and the projected Newton
baseline (``override_baseline.json``) with the checks of 17 on bar NHC
gravity (``bar.json`` + ``override_neo_comp.json``, 44 + 2 iterations)
and on armadillo-small NHC gravity, as bench.py's Newton leg runs it (36
+ 2 iterations of host SuperLU; its displacement within 1e-8 relative
of ``ARMADILLO_DISPLACEMENT``), the host-LU leg of 8 (human NHI on
band_chol and host_lu with the equilibria compared within
``BAND_COORD_RTOL``), armadillo-small NHC gravity on ``cg``, cold (its
expected outcome is the JAX package's: ``SANMNumericalError``, caught
and reported), and the solve of 5's 2,048 PCG iterations of the gravity
load at the armadillo-small NHC equilibrium run by the kernel on the
card and by the plain version on the CPU side by side (relative
residual and CG functional, printed).

It then prints the ``{"kernels": [...]}`` line and, last, the result line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and no result line is printed; the same holds without a
CUDA device.  A watchdog (``faulthandler``) turns a hang into a stack
dump and a non-zero exit after ``BUDGET_S`` seconds.  Outputs of the
solve go to a temporary directory; only ``--out`` writes a log there.
"""

import faulthandler
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

BUDGET_S = 300
ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "armadillo_small.json")
# the JAX package's relative displacement of armadillo-small NHC gravity on
# the CPU (f64, host LU, 2 restarts, force-RMS 6.55e-14), from
#   SANM_PLATFORM=cpu python -m sanm_tpu.fea configs/sys.json \
#       configs/armadillo_small.json
# (the stat JSON armadillo-small-i0-neohookean_c.json); the card's must
# agree to 1e-9 relative on every solver
ARMADILLO_DISPLACEMENT = 0.05313850203213072
ARMADILLO_RESTARTS = 2
# the device direct solvers besides band_chol and the kernels each runs
DIRECT_KERNELS = {"dense_chol": ("dense_factor", "dense_solve"),
                  "spike_band": ("spike_rhs_solve", "spike_solve")}
# the ARAP cell: armadillo-small with the ARAP and stiff-material overrides
ARAP_CONFIGS = [CONFIG] + [os.path.join(ROOT, "configs", f) for f in (
    "override_arap.json", "override_stiff_material.json")]
# the JAX package's relative displacement of that task on the CPU (f64,
# host LU, 4 restarts, force-RMS 1.81e-14), from
#   SANM_PLATFORM=cpu python -m sanm_tpu.fea configs/sys.json \
#       configs/armadillo_small.json configs/override_arap.json \
#       configs/override_stiff_material.json
# (the stat JSON armadillo-small-i0-arap.json); the card's must agree to
# 1e-9 relative
ARAP_DISPLACEMENT = 0.16226651633126318
ARAP_CPU_RESTARTS = 4
# the NHI cell: human as it is (NHI is its own energy model)
HUMAN_CONFIGS = [os.path.join(ROOT, "configs", "human.json")]
# the JAX package's relative displacement of that task on the CPU (f64,
# host LU, 2 restarts, force-RMS 1.04e-13), from
#   SANM_PLATFORM=cpu python -m sanm_tpu.fea configs/sys.json \
#       configs/human.json
# (the stat JSON human-i0-neohookean_i.json); the card's must agree to
# 1e-9 relative
HUMAN_DISPLACEMENT = 0.008425376847673133
HUMAN_CPU_RESTARTS = 2
# the StVK cell: armadillo-small with the stiff material and this
# override, written to a temporary file (no config selects StVK)
STVK_CONFIGS = [CONFIG, os.path.join(ROOT, "configs",
                                     "override_stiff_material.json")]
STVK_OVERRIDE = {"energy_model": "stvk_stretch"}
# the JAX package's relative displacement of that task on the CPU (f64,
# host LU, 2 restarts, force-RMS 2.86e-14), from
#   SANM_PLATFORM=cpu python -m sanm_tpu.fea configs/sys.json \
#       configs/armadillo_small.json configs/override_stiff_material.json \
#       override_stvk.json
# (a file holding STVK_OVERRIDE; the stat JSON
# armadillo-small-i0-stvk_stretch.json); the card's must agree to 1e-9
# relative
STVK_DISPLACEMENT = 0.02616150932393459
STVK_RESTARTS = 2
JET_CONFIGS = [os.path.join(ROOT, "configs", "jet.json")]
# the deform cell: armadillo-small with its bend override as it is (ARAP,
# mesh_twist: implicit continuation, then an order-6 refinement), and the
# same bend with the NHC material
DEFORM_CONFIGS = [CONFIG, os.path.join(ROOT, "configs",
                                       "armadillo_small_bend_override.json")]
DEFORM_NHC_CONFIGS = DEFORM_CONFIGS + [
    os.path.join(ROOT, "configs", "override_neo_comp.json")]
# the JAX package's relative displacement of these tasks on the CPU (f64,
# host LU, 2 deform + 1 refine restarts, force-RMS 6.25e-15 and 4.75e-14),
# from
#   SANM_PLATFORM=cpu python -m sanm_tpu.fea configs/sys.json \
#       configs/armadillo_small.json \
#       configs/armadillo_small_bend_override.json \
#       [configs/override_neo_comp.json]
# (the stat JSON armadillo-small.json); the card's must agree to 1e-9
# relative
DEFORM_DISPLACEMENT = {"arap": 0.07364899211351035,
                       "neohookean_c": 0.07357511995817433}
DEFORM_RESTARTS = (2, 1)  # iter_deform, iter_refine
# records: the human ARAP bend (the TPU reference: 3 + 1 restarts,
# force-RMS 1.9e-15, RESULTS.md:247)
HUMAN_BEND_CONFIGS = HUMAN_CONFIGS + [
    os.path.join(ROOT, "configs", "human_bend_override.json")]
# the inverse cells: armadillo-small (NHC) and bob (NHI) with
# override_inverse.json, as the reference protocol runs them
INV_CONFIGS = {
    cell: [os.path.join(ROOT, "configs", f), os.path.join(
        ROOT, "configs", "override_inverse.json")]
    for cell, f in (("armadillo", "armadillo_small.json"),
                    ("bob", "bob.json"))}
# the JAX package's relative displacement of these tasks on the CPU (f64,
# host LU, 1 restart, force-RMS 6.29e-14 and 6.46e-14), from
#   SANM_PLATFORM=cpu python -m sanm_tpu.fea configs/sys.json \
#       configs/<mesh>.json configs/override_inverse.json
# (the stat JSON <out>-i1-<energy>.json); the card's must agree to 1e-9
# relative
INV_DISPLACEMENT = {"armadillo": 0.02004404485674439,
                    "bob": 0.03516520364643996}
INV_RESTARTS = 1
# the material's K1i and K3i, per inverse cell
INV_CELL_KERNELS = {"armadillo": ("inv_nhc_step", "jac_asm_inv"),
                    "bob": ("inv_nhi_step", "jac_asm_inv_nhi")}
BAR_CONFIGS = [os.path.join(ROOT, "configs", "bar.json")]
# the baseline cells (projected Newton, override_baseline.json): the
# armadillo ARAP bend (mesh_twist) in the smoke run; bar NHC gravity (44
# factors of host SuperLU, ~24 s on the card machine) and armadillo-small
# NHC gravity (38 factors of ~2.7 s) under --records
BASELINE = os.path.join(ROOT, "configs", "override_baseline.json")
BASELINE_CELLS = {"arap bend": DEFORM_CONFIGS + [os.path.join(
    ROOT, "configs", "override_arap.json"), BASELINE]}
BASELINE_RECORD_CELLS = {
    "bar nhc": BAR_CONFIGS + [os.path.join(ROOT, "configs",
                                           "override_neo_comp.json"),
                              BASELINE],
    "armadillo nhc": [CONFIG, BASELINE]}
# the JAX package's relative displacement and (iter_tot, iter_refine) of
# these tasks on the CPU (f64, host SuperLU; force-RMS 2.78e-13, 3.00e-12
# and 5.16e-14), from
#   SANM_PLATFORM=cpu python -m sanm_tpu.fea configs/sys.json <configs>
# (the stat JSONs armadillo-small.json, bar-i0-neohookean_c.json and
# armadillo-small-i0-neohookean_c.json); the card's displacement must
# agree to 1e-8 relative (armadillo-small NHC: with the ANM's
# ARMADILLO_DISPLACEMENT, from which the JAX package's Newton lands
# 9.1e-11), its iterations are printed beside these (a line-search test
# may flip on the last bit)
BASELINE_DISPLACEMENT = {"arap bend": 0.07364899211351118,
                         "bar nhc": 0.19535560509805577,
                         "armadillo nhc": ARMADILLO_DISPLACEMENT}
BASELINE_ITERS = {"arap bend": (10, 1), "bar nhc": (44, 2),
                  "armadillo nhc": (36, 2)}
BASELINE_RTOL = 1e-8
# where the kernels line's K10 NHC and NHI launches come from
BASELINE_CUBOID_ONLY = ("3x2x2 cuboid projected Newton (parity phase) "
                        "only, not full size")
# per cell the K10 instantiation and the refinement's Jacobian kernel
BASELINE_CELL_KERNELS = {"arap bend": ("hess_proj_arap", "jac_asm_arap"),
                         "bar nhc": ("hess_proj", "jac_asm"),
                         "armadillo nhc": ("hess_proj", "jac_asm")}
# the FEA_INVCHECK round trip's restored rest vertices vs the original,
# in norm (the TPU record reads 5.5e-12, RESULTS.md:429-437)
INVCHECK_TOL = 1e-9
# the cg cell: configs/test_cuboid.json (20 x 8 x 8 vertices, NHC, order 20)
# with the PCG solver, and the JAX package's relative displacement of that
# task on the CPU (f64, 1 restart, force-RMS 8.39e-11), from
#   SANM_PLATFORM=cpu python -m sanm_tpu.fea configs/sys.json \
#       configs/test_cuboid.json cg.json
# where cg.json holds {"solver": "cg"} (the stat JSON
# cuboid-i0-neohookean_c.json); the card's must agree to 1e-9 relative
CG_CONFIGS = [os.path.join(ROOT, "configs", "test_cuboid.json")]
CG_DISPLACEMENT = 0.06289575066704964
CG_RESTARTS = 1
# the Tikhonov case of tests/test_app_cli.py:55-74 with the PCG solver
CG_PENALTY_TASK = {
    "func": "test_cuboid", "energy_model": "neohookean_c",
    "material": {"type": "young_poisson", "young": 1e7, "poisson": 0.45},
    "spacing": 0.025, "x": 3, "y": 2, "z": 2, "order": 8,
    "out_filename": "cub_l2", "xcoeff_l2_penalty": 1e-5,
    "disable_anm_sanity_check": True, "solver": "cg"}
CG_PENALTY_ONLY = ("3x2x2 cuboid with xcoeff_l2_penalty 1e-5 on cg "
                   "(parity phase): the Tikhonov right-hand side A^T b")
# H100 SXM data sheet: HBM3 3.35 TB/s, f64 without tensor cores 34
# TFLOP/s, f64 on the tensor cores (band_factor's mma.sync) 67 TFLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F64_S = 34e12
PEAK_F64_TC_S = 67e12
# kernel vs plain, max |diff| / max |plain| (per component group for K1):
# f64 sums in another order (and with fused multiply-adds) than torch's;
# band_assemble computes the same products (1/sqrt on the card, rsqrt in
# torch); band_factor's and dense_factor's Cholesky and triangular
# inverses round in another order, which the blocks' conditioning
# amplifies; svd_w is
# compared on s, W and the stretch U diag(|s|) U^T (U alone is not unique
# where singular values nearly tie), arap_step per component group through
# 19 orders of recurrences
TOL = {"remap_in": 1e-13, "remap_out": 1e-12, "jac_asm": 1e-12,
       "nhc_step": 1e-11, "element_matvec": 1e-12, "band_assemble": 1e-14,
       "band_factor": 1e-10, "band_solve": 1e-12, "svd_w": 1e-12,
       "arap_step": 1e-11, "jac_asm_arap": 1e-12, "nhi_step": 1e-11,
       "jac_asm_nhi": 1e-12, "grad_t": 1e-12, "inv_nhc_step": 1e-11,
       "inv_nhi_step": 1e-11, "jac_asm_inv": 1e-12, "jac_asm_inv_nhi": 1e-12,
       "dense_factor": 1e-10, "dense_solve": 1e-12, "spike_rhs_solve": 1e-12,
       "spike_solve": 1e-12, "hess_proj": 1e-11, "hess_proj_nhi": 1e-11,
       "hess_proj_arap": 1e-11, "csr_matvec": 1e-13, "csr_matvec_t": 1e-13,
       "diag_blocks": 0.0, "pcg_step": 1e-12, "stvk_step": 1e-11,
       "jac_asm_stvk": 1e-12}
# the port's Taylor engine against K1s's plain version (biases of one
# restart) and its batched_jacobian against K3s's plain Jacobian
ENGINE_TOL = {"series": 1e-11, "jacobian": 1e-12}
# svd_w on the mirrored equilibrium, where every element flips: a single
# flipped member of a pair of singular values closer than GROUP_EPS makes
# W depend on that pair's columns of U, which are fixed only to about
# 1e-16 / (their gap)
MIRROR_TOL = 1e-10
PARITY_RTOL = 1e-9
RMS_TARGET = 1e-10
# band vs host-LU equilibrium, max |diff| / max displacement: both stop
# at force-RMS <= 1e-10, about 1e-6 of the ~1.6e-4 N gravity load of a
# vertex
BAND_COORD_RTOL = 1e-6
# K5c's dynamic shared memory per CTA (sub_smem_bytes of csrc/band.cu): the
# 128 x 128 inverse, two vectors of 128 and 512 partial sums, f64
K5C_SMEM_BYTES = (128 * 128 + 2 * 128 + 512) * 8
KERNELS = ("nhc_step", "remap_in", "remap_out", "jac_asm", "element_matvec",
           "band_assemble", "band_factor", "band_solve")
ARAP_KERNELS = ("svd_w", "arap_step", "jac_asm_arap")
NHI_KERNELS = ("nhi_step", "jac_asm_nhi")
STVK_KERNELS = ("stvk_step", "jac_asm_stvk")
DEFORM_KERNELS = ("grad_t",)
INV_KERNELS = ("inv_nhc_step", "inv_nhi_step", "jac_asm_inv",
               "jac_asm_inv_nhi")
DIRECT_KERNEL_NAMES = sum(DIRECT_KERNELS.values(), ())
BASELINE_KERNELS = ("hess_proj", "hess_proj_nhi", "hess_proj_arap")
CG_KERNELS = ("csr_matvec", "csr_matvec_t", "diag_blocks", "pcg_step")
REPLACES = {
    "remap_in": "sanm_tpu/solver/remap.py:308",
    "remap_out": "sanm_tpu/solver/remap.py:327",
    "jac_asm": "sanm_tpu/solver/anm.py:278",
    "nhc_step": "sanm_tpu/solver/anm.py:293",
    "element_matvec": "sanm_tpu/solver/remap.py:453",
    "band_assemble": "sanm_tpu/solver/band.py:225",
    "band_factor": "sanm_tpu/solver/band.py:247",
    "band_solve": "sanm_tpu/solver/band.py:321",
    "svd_w": "sanm_tpu/ops/svd_w.py:60",
    "arap_step": "sanm_tpu/ops/svd_w.py:469",
    "jac_asm_arap": "sanm_tpu/ops/svd_w.py:173",
    "nhi_step": "sanm_tpu/taylor_scan.py:543",
    "jac_asm_nhi": "sanm_tpu/taylor.py:611",
    "grad_t": "sanm_tpu/solver/remap.py:366",
    "inv_nhc_step": "sanm_tpu/solver/anm.py:293",
    "inv_nhi_step": "sanm_tpu/taylor_scan.py:543",
    "jac_asm_inv": "sanm_tpu/solver/anm.py:278",
    "jac_asm_inv_nhi": "sanm_tpu/taylor.py:611",
    "dense_factor": "sanm_tpu/solver/linear.py:305",
    "dense_solve": "sanm_tpu/solver/linear.py:364",
    "spike_rhs_solve": "sanm_tpu/solver/spike.py:237",
    "spike_solve": "sanm_tpu/solver/spike.py:375",
    "hess_proj": "sanm_tpu/fea/baseline.py:178",
    "hess_proj_nhi": "sanm_tpu/fea/baseline.py:178",
    "hess_proj_arap": "sanm_tpu/fea/baseline.py:178",
    "csr_matvec": "sanm_tpu/solver/remap.py:439",
    "csr_matvec_t": "sanm_tpu/solver/remap.py:446",
    "diag_blocks": "sanm_tpu/solver/remap.py:423",
    "pcg_step": "sanm_tpu/solver/linear.py:671",
    "stvk_step": "sanm_tpu/solver/anm.py:293",
    "jac_asm_stvk": "sanm_tpu/taylor.py:611",
}
SOURCES = {
    "remap_in": "sanm_tpu_torch/csrc/remap.cu",
    "remap_out": "sanm_tpu_torch/csrc/remap.cu",
    "jac_asm": "sanm_tpu_torch/csrc/jac_asm.cu",
    "nhc_step": "sanm_tpu_torch/csrc/nhc_series.cu",
    "element_matvec": "sanm_tpu_torch/csrc/remap.cu",
    "band_assemble": "sanm_tpu_torch/csrc/band.cu",
    "band_factor": "sanm_tpu_torch/csrc/band.cu",
    "band_solve": "sanm_tpu_torch/csrc/band.cu",
    "svd_w": "sanm_tpu_torch/csrc/svd_w.cu",
    "arap_step": "sanm_tpu_torch/csrc/arap_series.cu",
    "jac_asm_arap": "sanm_tpu_torch/csrc/jac_asm.cu",
    "nhi_step": "sanm_tpu_torch/csrc/nhi_series.cu",
    "jac_asm_nhi": "sanm_tpu_torch/csrc/jac_asm.cu",
    "grad_t": "sanm_tpu_torch/csrc/jac_asm.cu",
    "inv_nhc_step": "sanm_tpu_torch/csrc/inv_series.cu",
    "inv_nhi_step": "sanm_tpu_torch/csrc/inv_series.cu",
    "jac_asm_inv": "sanm_tpu_torch/csrc/jac_asm.cu",
    "jac_asm_inv_nhi": "sanm_tpu_torch/csrc/jac_asm.cu",
    "dense_factor": "sanm_tpu_torch/csrc/dense_chol.cu",
    "dense_solve": "sanm_tpu_torch/csrc/dense_chol.cu",
    "spike_rhs_solve": "sanm_tpu_torch/csrc/spike.cu",
    "spike_solve": "sanm_tpu_torch/csrc/spike.cu",
    "hess_proj": "sanm_tpu_torch/csrc/jac_asm.cu",
    "hess_proj_nhi": "sanm_tpu_torch/csrc/jac_asm.cu",
    "hess_proj_arap": "sanm_tpu_torch/csrc/jac_asm.cu",
    "csr_matvec": "sanm_tpu_torch/csrc/cg.cu",
    "csr_matvec_t": "sanm_tpu_torch/csrc/cg.cu",
    "diag_blocks": "sanm_tpu_torch/csrc/cg.cu",
    "pcg_step": "sanm_tpu_torch/csrc/cg.cu",
    "stvk_step": "sanm_tpu_torch/csrc/stvk_series.cu",
    "jac_asm_stvk": "sanm_tpu_torch/csrc/jac_asm.cu",
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
    event, so the host work of a
    call (argument checks, allocation, the ctypes launch) is done while
    the card is still busy and the events bracket device time only.
    ``setup`` runs before each launch, outside the window (band_factor
    overwrites its input band, which is restored there).  ``host_ms`` keeps the longest host time of
    a timed call; where it exceeds ``cover_ms`` the excess is in the
    reading (so it is for the plain versions, whose host work is most of
    their cost)."""

    COVER_CYCLES = 4_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
        # read by a flush that leaves L2 clean (never written, so no line
        # of it is dirty): the timed kernel then pays no write-back of the
        # flush's lines, which zero_() leaves dirty
        self.clean = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(self.COVER_CYCLES)
        s.record()
        torch.cuda._sleep(self.COVER_CYCLES)
        e.record()
        torch.cuda.synchronize()
        self.cover_ms = s.elapsed_time(e)
        self.host_ms = 0.0
        gc.collect()  # the large host objects of the solves before

    def ms(self, fn, reps=10, warmup=2, setup=None, cover_cycles=None,
           read_flush=False):
        torch = self.torch
        for _ in range(warmup):
            if setup is not None:
                setup()
            fn()
        torch.cuda.synchronize()
        self.host_ms = 0.0
        # a garbage collection would land in a timed call's host work
        gc.disable()
        try:
            total = self._timed(fn, reps, setup, cover_cycles, read_flush)
        finally:
            gc.enable()
        return total / reps

    def _timed(self, fn, reps, setup, cover_cycles, read_flush=False):
        torch = self.torch
        total = 0.0
        for _ in range(reps):
            if setup is not None:
                setup()
            if read_flush:
                self.clean.sum()
            else:
                self.flush.zero_()
            torch.cuda._sleep(cover_cycles or self.COVER_CYCLES)
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
        return total

    #: measurements of a kernel_ms reading at most: a host stall (the
    #: process descheduled on the shared host) during one of them is
    #: measured again, and every reading kept was covered by the spin
    TRIES = 3

    def kernel_ms(self, fn, reps=10, warmup=2, cover_cycles=None,
                  read_flush=False):
        """Device time of a kernel wrapper; fails if its host work was not
        hidden behind the spin (of ``cover_cycles``, default
        ``COVER_CYCLES``) in ``TRIES`` measurements."""
        cover = self.cover_ms * (cover_cycles or self.COVER_CYCLES) \
            / self.COVER_CYCLES
        for _ in range(self.TRIES):
            t = self.ms(fn, reps, warmup, cover_cycles=cover_cycles,
                        read_flush=read_flush)
            if self.host_ms < cover:
                return t
            say("timing: host work of a timed launch (%.3f ms) not covered "
                "by the spin (%.3f ms); measured again"
                % (self.host_ms, cover))
        require(False, "host work of a timed launch (%.3f ms) not covered "
                "by the spin (%.3f ms) in %d measurements"
                % (self.host_ms, cover, self.TRIES))

    def graph_ms(self, fn, reps=10, setup=None, read_flush=False):
        """Device time of a wrapper that launches several kernels (the
        band factor loops over the block columns on the host; the band
        solve launches a memset and two kernels): captured once in a CUDA
        graph and replayed, so that its launches run back to back, without
        the host's launch gaps."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            if setup is not None:
                setup()
            fn()
        torch.cuda.current_stream().wait_stream(side)
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            fn()
        torch.cuda.synchronize()
        t = self.ms(graph.replay, reps, 1, setup, read_flush=read_flush)
        require(self.host_ms < self.cover_ms,
                "host work of a graph replay (%.3f ms) not covered by the "
                "spin (%.3f ms)" % (self.host_ms, self.cover_ms))
        del graph
        return t


def phase_profile(torch, solver):
    """One warm re-solve of the band path under ``torch.profiler``: device
    time by kernel name, and the share of the wall time the card was
    busy.  Last, since the profiler slows launches after it."""
    from torch.profiler import ProfilerActivity, profile

    from sanm_tpu_torch.fea.app import run_anm_eqn

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        solver.reset()
        run_anm_eqn(solver, progress=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e3
    parts = {}
    for ev in prof.key_averages():
        t = float(getattr(ev, "device_time_total", 0.0)) / 1e3
        if t > 0:
            key = ev.key.replace("(anonymous namespace)::", "")
            name = key.split("(")[0].split()[-1].split("::")[-1]
            ms, cnt = parts.get(name, (0.0, 0))
            parts[name] = (ms + t, cnt + ev.count)
    if not parts:
        say("profile: not measured (the profiler saw no device time)")
    else:
        busy = sum(ms for ms, _ in parts.values())
        say("profile of one warm band_chol re-solve (%d restarts): wall "
            "%.1f ms under the profiler, device busy %.1f ms (%.1f%%)"
            % (solver.get_nr_iter(), wall_ms, busy, 100.0 * busy / wall_ms))
        top = sorted(parts.items(), key=lambda kv: -kv[1][0])
        say("profile by kernel: " + ", ".join(
            "%s %.3f ms x%d" % (k, ms, c) for k, (ms, c) in top[:16]))
        d_ms, d_n = parts.get("diag_factor_kernel<false>", (0.0, 0))
        say("profile: the factors' diagonal step %.3f ms x%d, %.1f%% of the "
            "device time, %.1f%% of the wall" % (
                d_ms, d_n, 100.0 * d_ms / busy, 100.0 * d_ms / wall_ms))
    phase_done("profile", t0)


MMA_SHAPES = ((8, 8, 4), (16, 8, 4), (16, 8, 8), (16, 8, 16))
TILE_VARIANTS = ("128x64 m8n8k4", "128x64 m16n8k4", "128x64 m16n8k8",
                 "128x64 m16n8k16", "128x128 m16n8k8 3 stages",
                 "128x128 m16n8k8 4 stages", "128x128 m16n8k4 4 stages",
                 "64x128 m16n8k8", "128x128 m16n8k8 16 warps 3 stages",
                 "128x128 m16n8k8 16 warps 4 stages",
                 "256x64 m16n8k8 16 warps", "128x64 m16n8k8 4 warps",
                 "128x64 m16n8k8 2 stages of 32",
                 "128x64 m16n8k8 4 warps 2 stages of 32",
                 "128x64 m16n8k8 a subtraction per 128 deep")


def phase_mma_probe(torch):
    """The card's f64 mma.sync shapes (``csrc/mma_probe.cu``): each one's
    fragment maps against torch on one warp's product, and its rate on one
    SM and on the card (8 warps a CTA, 8 independent products a warp);
    then the factors' product tile (``tile_nt``) in each variant against
    ``torch.addmm`` at depth 128 (a band column's update) and 256 (the
    dense factor's pairs), on an 8192 x 8192 output."""
    from sanm_tpu_torch import kernels

    t0 = time.perf_counter()
    lib = kernels.library()
    f64 = torch.float64
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(0)

    def ev_ms(fn, reps):
        fn()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps

    for shape, (m, n, k) in enumerate(MMA_SHAPES):
        A = torch.randn(m, k, dtype=f64, device="cuda", generator=g)
        B = torch.randn(k, n, dtype=f64, device="cuda", generator=g)
        C = torch.zeros(m, n, dtype=f64, device="cuda")
        require(lib.sanm_mma_layout(shape, A.data_ptr(), B.data_ptr(),
                                    C.data_ptr(), stream) == 0,
                "mma layout probe failed to launch")
        _, lay = rel_err(C, A @ B)
        require(lay <= 1e-14, "mma m%dn%dk%d fragment maps wrong: rel err "
                "%.2g" % (m, n, k, lay))
        fl = 2 * m * n * k
        iters = 20000 * 512 // fl
        rates = []
        for ctas in (1, 264):
            out = torch.empty(ctas * 256, dtype=f64, device="cuda")
            ms = ev_ms(lambda: lib.sanm_mma_rate(shape, ctas, iters,
                                                 out.data_ptr(), stream), 2)
            rates.append(ctas * 64 * iters * fl / ms / 1e9)
        say("mma.sync m%dn%dk%d f64: fragment maps rel err %.1e; %.3f "
            "TFLOP/s on one SM, %.2f on the card" % (m, n, k, lay, *rates))
    M = N = 8192
    for K in (128, 256):
        A = torch.randn(M, K, dtype=f64, device="cuda", generator=g)
        B = torch.randn(N, K, dtype=f64, device="cuda", generator=g)
        C0 = torch.randn(M, N, dtype=f64, device="cuda", generator=g)
        ref = torch.addmm(C0, A, B.T, alpha=-1.0)
        C = C0.clone()
        fl = 2.0 * M * N * K
        lib_ms = ev_ms(lambda: torch.addmm(C0, A, B.T, alpha=-1.0, out=C), 3)
        parts = ["torch.addmm %.1f" % (fl / lib_ms / 1e9)]
        for v, name in enumerate(TILE_VARIANTS):
            C.copy_(C0)
            require(lib.sanm_tile_probe(v, A.data_ptr(), B.data_ptr(),
                                        C.data_ptr(), M, N, K, stream) == 0,
                    "tile probe failed to launch")
            _, err = rel_err(C, ref)
            require(err <= 1e-13, "tile %s disagrees with torch.addmm: rel "
                    "err %.2g" % (name, err))
            ms = ev_ms(lambda: lib.sanm_tile_probe(
                v, A.data_ptr(), B.data_ptr(), C.data_ptr(), M, N, K,
                stream), 3)
            parts.append("%s %.1f" % (name, fl / ms / 1e9))
        say("product tile C -= A B^T, %d x %d at depth %d, TFLOP/s: %s"
            % (M, N, K, ", ".join(parts)))
        del A, B, C0, C, ref
    torch.cuda.empty_cache()
    phase_done("mma probe", t0)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(bytes_moved, flops, peak_flops=PEAK_F64_S):
    tb = bytes_moved / PEAK_BYTES_S * 1e3
    tf = flops / peak_flops * 1e3
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


def reporter(rows):
    """``report(name, err, rel, ms, plain_ms, bound, lib_ms, extra)``:
    check a kernel's error against ``TOL``, print its row and keep it in
    ``rows``."""
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
    return report


#: f64 operations of K10's function per element, fixed by its inputs:
#: the material's dP/dF in F (NHC, NHI, ARAP: its 81 entries from U, s,
#: V), and for all three the symmetrisation (72), a symmetric 9x9
#: eigensolve with vectors at the symmetric QR algorithm's ~9 n^3
#: (6,561; Golub and Van Loan), D+ = V diag(max(L, 0)) V^T (2 n^3 + n^2
#: = 1,539) and the chain (405); K3's contraction is added per plan.
#: The kernel's Jacobi runs more (~6,400 operations a sweep): those are
#: its algorithm's, not the function's, and are not counted.
K10_DPDF_OPS = {"hess_proj": 700, "hess_proj_nhi": 1100,
                "hess_proj_arap": 5400}
K10_COMMON_OPS = 72 + 9 * 9 ** 3 + (2 * 9 ** 3 + 9 ** 2) + 405
K10_DPDF = {"hess_proj": "nhc_dpdf_plain", "hess_proj_nhi": "nhi_dpdf_plain",
            "hess_proj_arap": "arap_dpdf_plain"}


def k10_row(torch, timing, report, name, model, args):
    """K10 ``name`` against its plain version on ``model`` at ``args``
    (the graph input, or for ARAP K8a's u, s, w of F), timed as the other
    rows; the bound counts each input read and each output written once
    and :data:`K10_DPDF_OPS` and :data:`K10_COMMON_OPS` per element; the
    library yardstick is ``torch.linalg.eigh`` of the same symmetric
    F-space blocks (in chunks: cuSOLVER's batched syev refuses 32,768
    blocks and more) plus the clamp and the reconstruction (the
    projection alone, without dP/dF, the chain, the contraction and the
    gather)."""
    from sanm_tpu_torch.solver import assemble as K23

    asm, elems = model.asm, model.elems
    B = asm.B
    fn, plain = getattr(K23, name), getattr(K23, name + "_plain")
    data, E = fn(asm, elems, *args)
    data_p, E_p = plain(asm, elems, *args)
    e_d, r_d = rel_err(data, data_p)
    e_e, r_e = rel_err(E, E_p)
    del data_p, E_p
    flops = B * (K10_DPDF_OPS[name] + K10_COMMON_OPS
                 + asm.Dout * 9 * 9 * 2 + asm.Dout * asm.Din * 9 * 2)
    D = getattr(K23, K10_DPDF[name])(elems, *args)
    D = 0.5 * (D + D.transpose(1, 2))

    def library():
        w, v = K23.eigh_blocks(D)
        return (v * w.clamp(min=0.0)[:, None, :]) @ v.transpose(1, 2)

    lib_ms = timing.ms(library, reps=3, warmup=1)
    ins = args if name == "hess_proj_arap" else (args[0], elems.bias)
    report(name, max(e_d, e_e), max(r_d, r_e),
           timing.kernel_ms(lambda: fn(asm, elems, *args), reps=5),
           timing.ms(lambda: plain(asm, elems, *args), reps=2, warmup=1),
           bound_ms(nbytes(*ins, elems.dminv, asm.Lout, asm.Lin, asm.nz_ptr,
                           asm.nz_slot, E, data), flops), lib_ms,
           "(library: torch.linalg.eigh in chunks of %d + clamp + "
           "reconstruction of the symmetric F-space blocks, the "
           "projection alone)" % K23.EIGH_CHUNK)
    del data, E, D


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
        "cached" if info["cached"] else "nvcc, one process per source"))
    for line in info.get("report", "").splitlines():
        if "registers" in line or "spill" in line:
            say("  ptxas:", line.strip())
    phase_done("build", t0)
    return info["seconds"]


def ptxas_usage(kernel):
    """ptxas's registers, shared memory and spills for the entry
    functions whose (mangled) name contains ``kernel``, from the build's
    ``-Xptxas -v`` report."""
    from sanm_tpu_torch import kernels

    out, cur, spill = [], None, ""
    for line in kernels.BUILD_INFO.get("report", "").splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1] if "'" in line else None
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and cur \
                and kernel in cur:
            out.append("%s; %s" % (line.split(":", 1)[1].strip(), spill))
            cur = None
    return " | ".join(out) or "not in the report (cached build)"


def rest_vertices():
    """armadillo-small's vertices as the gravity task loads them."""
    from sanm_tpu_torch.fea import app

    body, _, _ = app.gravity_setup(app.read_json(CONFIG),
                                   os.path.dirname(CONFIG))
    return body.mesh.vertices


def armadillo_model(configs=(CONFIG,)):
    """The gravity task's model on the card (its own host set-up,
    ``app.gravity_setup``) and the load vector, for the task of the
    merged ``configs``."""
    from sanm_tpu_torch.fea import app

    cfg = app.merge_configs(list(configs))
    body, f_full, _ = app.gravity_setup(cfg, os.path.dirname(CONFIG))
    model = body.make_forward(app.energy_model_of(cfg), device="cuda")
    return model, model.lt_inp.copy_vtx_values(f_full)


def host_lu_factor(model):
    """``factor(data, E) -> solve``: host SuperLU of the CSR values."""
    import scipy.sparse as sp

    from sanm_tpu_torch.solver.linear import host_splu

    asm = model.asm

    def factor(data, E):
        A = sp.csr_matrix((data.cpu().numpy(), (asm.csr_rowidx,
                                                asm.csr_cols)),
                          shape=(asm.n, asm.n))
        return host_splu(A.tocsc()).solve
    return factor


def band_chol_factor(model, plan):
    """``factor(data, E) -> solve``: the card's refined band solve (K5a-c
    refined against K4), for a mesh whose host LU is slow."""
    from functools import partial

    import torch

    from sanm_tpu_torch.solver.assemble import element_matvec
    from sanm_tpu_torch.solver.band import DeviceBandCholSolver

    def factor(data, E):
        s = DeviceBandCholSolver(plan, data,
                                 partial(element_matvec, model.asm, E))
        require(s.factor_ok(), "band factor of the restart not finite")
        return lambda r: s.solve(torch.as_tensor(r).cuda()).cpu().numpy()
    return factor


def first_restart(model, f_load, series, step, order=20, x0=None,
                  factor=None):
    """Drive a real ANM restart of ``model`` from ``x0`` (default: its
    rest shape; f(x0) + y as the homotopy) through ``factor`` (default:
    :func:`host_lu_factor`): ``series.start`` at x0, then for k =
    1..order-1 ``step(k, gin_k)`` commits order k and returns the
    order-(k+1) bias (B, 9), from which the solve gives the next
    coefficient."""
    import numpy as np

    from sanm_tpu_torch.solver import assemble as K23

    asm = model.asm
    gin0 = K23.remap_in(asm, asm.pad_vector(model.x0() if x0 is None
                                            else x0))
    data, _, E = model.jac_asm(gin0)
    solve = (factor or host_lu_factor(model))(data, E)
    xgt = solve(K23.remap_out(asm, model.stress(gin0)).cpu().numpy()
                + f_load)
    t1 = 1.0 / np.sqrt(xgt @ xgt + 1.0)
    x1 = -t1 * xgt
    series.start(gin0)
    xt_k = np.concatenate([x1, [t1]])
    for k in range(1, order):
        b = step(k, asm.apply_in(xt_k))
        xb = solve(K23.remap_out(asm, b).cpu().numpy())
        tk = (xb @ x1) / (t1 - x1 @ xgt)
        xt_k = np.concatenate([-tk * xgt - xb, [tk]])
        require(np.isfinite(xt_k).all(),
                "non-finite series at order %d" % (k + 1))


def series_row(timing, label, model, f_load, series, kernel, plain, groups,
               rows, bound_of, on_bias=None, x0=None, factor=None,
               check=None):
    """A series kernel against its plain version along
    :func:`first_restart` from ``x0`` (bias orders 2..20): per order k the
    plain step
    runs on a copy of the history rows the step reads and writes
    (``rows(hist, k)``), then the kernel on the live ones; errors of the
    bias and of order k's component ``groups``, kernel and plain times
    and the bound ``bound_of(k)``.  ``on_bias(b)`` sees each bias,
    ``check(k, gin_k, b_plain)`` each order's input and the plain
    version's bias.
    Returns the largest absolute and relative error and the mean kernel,
    plain and bound ms."""
    import numpy as np

    import torch

    elems = model.elems
    worst, err_k, ms_k, plain_k, bnd_k = 0.0, 0.0, [], [], []

    def step(k, gin_k):
        nonlocal worst, err_k
        hist_k = rows(series.hist, k)
        snap = hist_k.clone()
        b_plain = torch.empty_like(series.bias_out)
        plain(snap, k, gin_k, elems, b_plain)
        if check is not None:
            check(k, gin_k, b_plain)
        b = series.step(k, gin_k)
        e_b, r_b = rel_err(b, b_plain)
        r_h = max(rel_err(series.hist[k, sl], snap[k, sl])[1]
                  for sl in groups)
        worst, err_k = max(worst, r_b, r_h), max(err_k, e_b)
        # a longer spin: these launches follow the restart's host solves,
        # after which a launch's host work has been seen to stall for ~3 ms
        ms = timing.kernel_ms(lambda: kernel(hist_k, k, gin_k, elems,
                                             series.bias_out), reps=5,
                              cover_cycles=3 * timing.COVER_CYCLES)
        pms = timing.ms(lambda: plain(snap, k, gin_k, elems, b_plain),
                        reps=2, warmup=1)
        bnd = bound_of(k)
        ms_k.append(ms)
        plain_k.append(pms)
        bnd_k.append(bnd[0])
        if k in (1, 9, 19):
            say("  %s bias order %2d: rel err bias %.2e hist %.2e, ms=%.4f "
                "plain_ms=%.3f bound_us=%.2f (%s)"
                % (label, k + 1, r_b, r_h, ms, pms, bnd[0] * 1e3, bnd[1]))
        if on_bias is not None:
            on_bias(b)
        return b

    first_restart(model, f_load, series, step, x0=x0, factor=factor)
    return (err_k, worst, float(np.mean(ms_k)), float(np.mean(plain_k)),
            float(np.mean(bnd_k)))


def phase_kernels(torch, timing, verts_eq):
    """Each kernel against its plain version; ``verts_eq`` are the
    vertices of the equilibrium the slice converged to."""
    from sanm_tpu_torch.ops import nhc_series as K1
    from sanm_tpu_torch.solver import assemble as K23

    t0 = time.perf_counter()
    model, f_load = armadillo_model()
    asm, elems = model.asm, model.elems
    n, B = asm.n, asm.B
    say("model: B=%d n=%d nnz=%d Din=%d Dout=%d (host prep %.2f s); "
        "timing spin %.3f ms" % (B, n, asm.nnz, asm.Din, asm.Dout,
                                 time.perf_counter() - t0, timing.cover_ms))
    rows = {}
    report = reporter(rows)

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
    data, _, E = K23.jac_asm(asm, elems, gin)
    data_p, _, E_p = K23.jac_asm_plain(asm, elems, gin)
    err, rel = rel_err(data, data_p)
    err_e, rel_e = rel_err(E, E_p)
    flops = B * (800 + asm.Dout * 9 * 9 * 2 + asm.Dout * asm.Din * 9 * 2)
    report("jac_asm", max(err, err_e), max(rel, rel_e),
           timing.kernel_ms(lambda: K23.jac_asm(asm, elems, gin), reps=5),
           timing.ms(lambda: K23.jac_asm_plain(asm, elems, gin), reps=3),
           bound_ms(nbytes(gin, elems.bias, elems.dminv, asm.Lout, asm.Lin,
                           asm.nz_ptr, asm.nz_slot, E, data), flops))
    del data_p, E_p
    # ---- K10 (NHC) at the deformed equilibrium ----
    k10_row(torch, timing, report, "hess_proj", model, (gin,))
    libs = band_rows(torch, timing, model, data, E, x_eq, f_load, report)
    direct_rows(torch, timing, model, data, f_load, report, *libs)
    cg_rows(torch, timing, model, data, f_load, report)
    del data, E

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

    # ---- K1 along a real first restart from the rest shape; remap_out
    # also on each of its biases ----
    def on_bias(b):
        nonlocal out_err, out_rel
        e_o, r_o = rel_err(K23.remap_out(asm, b), K23.remap_out_plain(asm, b))
        out_err, out_rel = max(out_err, e_o), max(out_rel, r_o)

    # reads the 23 history components of orders <= k, gin, Dm^-1; writes
    # order k's components and the bias
    err_k, worst, ms_k, plain_k, bnd_k = series_row(
        timing, "K1", model, f_load, K1.NHCSeries(elems, 20), K1.nhc_step,
        K1.nhc_step_plain, K1.GROUPS, lambda h, k: h[: k + 2],
        lambda k: bound_ms(8 * B * (K1.NCOMP * (k + 1) + 27),
                           B * k1_flops(k)), on_bias)
    report("nhc_step", err_k, worst, ms_k, plain_k, (bnd_k, "bytes"),
           extra="(mean over the 19 per-order launches of one restart)")
    report("remap_out", out_err, out_rel, out_ms, out_plain_ms, out_bnd,
           lib_out, "(error over the equilibrium stress and the 19 K1 "
           "biases; times on the stress; library err %.1e)" % err_lib_out)
    torch.cuda.empty_cache()
    phase_done("kernels", t0)
    return rows


def band_rows(torch, timing, model, data, E, x_eq, f_load, report):
    """K4 and K5 on the Jacobian ``data`` / ``E`` at the equilibrium
    ``x_eq``: element_matvec on the equilibrium displacement, the band
    assembly and factor of that Jacobian, the band solve of the scaled
    load."""
    import numpy as np

    from sanm_tpu_torch.solver import assemble as K23
    from sanm_tpu_torch.solver import band as K5
    from sanm_tpu_torch.solver import linear as K6

    f64, i64 = torch.float64, torch.int64
    asm = model.asm
    n, B = asm.n, asm.B
    t0 = time.perf_counter()
    plan = K5.BandPlan(asm.csr_rowidx, asm.csr_cols, n)
    arrs = plan.on("cuda")
    say("band plan: s=%d bw=%d w=%d nb=%d W=%d nrow_tot=%d mean reach "
        "%.2f blocks; factor %.3f GB, working band %.3f GB, %.4e f64 "
        "operations (host %.2f s)" % (
            plan.s, plan.bw, plan.w, plan.nb, plan.W, plan.nrow_tot,
            float(plan.blk_w.mean()), plan.mem_bytes() / 1e9,
            plan.work_mem_bytes() / 1e9, plan.factor_flops(),
            time.perf_counter() - t0))

    # ---- K4 element_matvec on the equilibrium displacement ----
    xd = torch.as_tensor(np.asarray(x_eq) - model.x0(), dtype=f64).cuda()
    y = K23.element_matvec(asm, E, xd)
    yp = K23.element_matvec_plain(asm, E, xd)
    err, rel = rel_err(y, yp)
    counts = np.bincount(asm.csr_rowidx, minlength=n)
    crow = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]),
                           dtype=i64).cuda()
    rows_t = torch.as_tensor(asm.csr_rowidx, dtype=i64).cuda()
    cols_t = torch.as_tensor(asm.csr_cols, dtype=i64).cuda()
    S = torch.sparse_csr_tensor(crow, cols_t, data, size=(n, n))
    lib = timing.ms(lambda: S @ xd)
    err_lib, _ = rel_err(S @ xd, yp)
    nent = B * asm.Dout
    require(torch.equal(K23.element_matvec(asm, E, xd), y),
            "element_matvec does not repeat its bits")
    # what the L2 flush costs a kernel that streams E: E summed alone, and
    # K4 and the library again after a flush that leaves L2 clean
    e_read = timing.ms(lambda: E.sum())
    clean_ms = timing.kernel_ms(lambda: K23.element_matvec(asm, E, xd),
                                read_flush=True)
    lib_clean = timing.ms(lambda: S @ xd, read_flush=True)
    e_clean = timing.ms(lambda: E.sum(), read_flush=True)
    report("element_matvec", err, rel,
           timing.kernel_ms(lambda: K23.element_matvec(asm, E, xd)),
           timing.ms(lambda: K23.element_matvec_plain(asm, E, xd)),
           bound_ms(nbytes(E, asm.loc_cols, xd, asm.row_ptr, asm.ent_pos, y),
                    2 * nent * asm.Din + nent), lib,
           "(library: CSR SpMV, err %.1e; repeats its bits; the former "
           "one-thread-per-entry kernel took 0.0535 ms; E.sum() "
           "alone %.4f ms; after a flush that leaves L2 clean: K4 %.4f ms, "
           "library %.4f ms, E.sum() %.4f ms; ptxas: entries %s; rows %s)"
           % (err_lib, e_read, clean_ms, lib_clean, e_clean,
              ptxas_usage("element_matvec_entries"),
              ptxas_usage("element_matvec_rows")))
    del S

    # ---- K5a band_assemble ----
    band, scale = K5.band_assemble(plan, data)
    band_p, scale_p = K5.band_assemble_plain(plan, data)
    e_b, r_b = rel_err(band, band_p)
    e_s, r_s = rel_err(scale, scale_p)
    del band_p, scale_p
    nlow = len(plan.band_sel)
    asm_in = [arrs[k] for k in ("diag_of_row", "band_sel", "sel_rows",
                                "sel_cols", "band_idx", "pad_idx")]
    report("band_assemble", max(e_b, e_s), max(r_b, r_s),
           timing.kernel_ms(lambda: K5.band_assemble(plan, data), reps=5),
           timing.ms(lambda: K5.band_assemble_plain(plan, data), reps=2,
                     warmup=1),
           bound_ms(nbytes(data, *asm_in, band, scale), 3 * nlow + 2 * n),
           extra="(memset of the %.2f GB band + scatter)"
           % (nbytes(band) / 1e9))

    # ---- the factors' diagonal step alone (K5b's first kernel, K6b's
    # too) on the band's first diagonal block, restored by setup ----
    s = plan.s
    blk0 = band[:s, plan.w * s:(plan.w + 1) * s].contiguous()
    blk = torch.empty_like(blk0)

    def restore_blk():
        blk.copy_(blk0)

    restore_blk()
    d_inv = K6.diag_factor(blk)
    d_l = torch.tril(blk)
    restore_blk()
    d_inv_p = K6.diag_factor_plain(blk)
    _, r_di = rel_err(d_inv, d_inv_p)
    _, r_dl = rel_err(d_l, torch.tril(blk))
    require(max(r_di, r_dl) <= TOL["band_factor"], "the diagonal step "
            "disagrees with its plain version: rel err %.3g"
            % max(r_di, r_dl))
    d_ms = timing.ms(lambda: K6.diag_factor(blk), reps=20,
                     setup=restore_blk)
    d_b2b = timing.ms(lambda: [K6.diag_factor(blk) for _ in range(50)],
                      reps=2, setup=restore_blk) / 50
    d_plain_ms = timing.ms(lambda: K6.diag_factor_plain(blk), reps=5,
                           setup=restore_blk)
    say("diagonal step alone (diag_factor_kernel, band block 0): %.2f us "
        "(%.2f us a launch in 50 back to back; plain %.3f ms), rel err L "
        "%.1e inv %.1e; ptxas %s" % (d_ms * 1e3, d_b2b * 1e3, d_plain_ms,
                                      r_dl, r_di,
                                      ptxas_usage("diag_factor_kernel")))
    del blk, blk0

    # ---- K5b band_factor: the kernel overwrites its band, which setup
    # restores from the pristine copy ----
    work = torch.empty_like(band)

    def restore():
        work.copy_(band)

    restore()
    panels = K5.band_factor(plan, work)
    restore()
    panels_p = K5.band_factor_plain(plan, work)
    require(K5.band_factor_ok(panels), "band factor not finite")
    e_f, r_f = rel_err(panels, panels_p)
    del panels_p
    restore()
    require(torch.equal(K5.band_factor(plan, work), panels),
            "band_factor does not repeat its bits")
    f_ms = timing.graph_ms(lambda: K5.band_factor(plan, work), reps=3,
                           setup=restore)
    f_launch_ms = timing.ms(lambda: K5.band_factor(plan, work), reps=2,
                            warmup=0, setup=restore, cover_cycles=1)
    f_plain_ms = timing.ms(lambda: K5.band_factor_plain(plan, work), reps=1,
                           warmup=0, setup=restore)
    del work
    # library: dense Cholesky of the same (n, n) matrix
    M = torch.zeros((n, n), dtype=f64, device="cuda")
    M[rows_t, cols_t] = -(data * scale[rows_t] * scale[cols_t])
    Lc = torch.linalg.cholesky(M)
    f_lib_ms = timing.ms(lambda: torch.linalg.cholesky(M), reps=2, warmup=0)
    del M
    report("band_factor", e_f, r_f, f_ms, f_plain_ms,
           bound_ms(nbytes(band, panels), plan.factor_flops(), PEAK_F64_TC_S),
           f_lib_ms, "(one CUDA-graph replay of the look-ahead's two "
           "streams; %.4f ms launched from the host; repeats its bits; the "
           "diagonal step alone %.2f us; library: dense "
           "torch.linalg.cholesky of the %.1f GB matrix; ptxas: panel %s; "
           "updates %s)" % (f_launch_ms, d_ms * 1e3, 8.0 * n * n / 1e9,
                            ptxas_usage("band_panel_kernel"),
                            ptxas_usage("band_update_kernel")))
    del band

    # ---- K5c band_solve of the scaled load vector ----
    rhs = torch.as_tensor(f_load, dtype=f64).cuda() * scale
    ys = K5.band_solve(plan, panels, rhs)
    ys_p = K5.band_solve_plain(plan, panels, rhs)
    e_y, r_y = rel_err(ys, ys_p)
    s_lib = timing.ms(lambda: torch.cholesky_solve(rhs[:, None], Lc), reps=3)
    err_lib_s, _ = rel_err(torch.cholesky_solve(rhs[:, None], Lc)[:, 0], ys_p)
    del Lc
    torch.cuda.empty_cache()
    require(torch.equal(K5.band_solve(plan, panels, rhs), ys),
            "band_solve does not repeat its bits")
    s_ms = timing.graph_ms(lambda: K5.band_solve(plan, panels, rhs))
    # from the host as the solver launches it (its error word read once a
    # solve), and with the call's own word read back after each call
    err_word = torch.zeros((1,), dtype=torch.int32, device="cuda")
    s_launch_ms = timing.ms(
        lambda: K5.band_solve(plan, panels, rhs, err=err_word),
        cover_cycles=1)
    require(int(err_word[0]) == 0, "band_solve: a wait timed out")
    s_own_ms = timing.ms(lambda: K5.band_solve(plan, panels, rhs),
                         cover_cycles=1)
    s_clean = timing.graph_ms(lambda: K5.band_solve(plan, panels, rhs),
                              read_flush=True)
    report("band_solve", e_y, r_y, s_ms,
           timing.ms(lambda: K5.band_solve_plain(plan, panels, rhs), reps=2,
                     warmup=1),
           bound_ms(nbytes(panels, rhs, arrs["perm_ext"], ys),
                    4 * panels.numel()), s_lib,
           "(one CUDA-graph replay of the memset and the two persistent "
           "kernels; %.4f ms launched from the host as the solver launches "
           "it, %.4f ms with the error word read back after the call; "
           "%.3f us per block column and direction; panels read "
           "once in the bound, twice by the algorithm; repeats its bits; "
           "%.4f ms in a graph after a flush that leaves L2 clean; "
           "the former host loop of ~1,190 kernels took 4.761 ms in a "
           "graph and 6.322 ms from the host; library: "
           "torch.cholesky_solve with the dense factor, err %.1e; ptxas: "
           "forward %s; backward %s; dynamic shared memory %d B each)"
           % (s_launch_ms, s_own_ms, s_ms * 1e3 / (2 * plan.nb), s_clean,
              err_lib_s,
              ptxas_usage("band_fwd_kernel"), ptxas_usage("band_bwd_kernel"),
              K5C_SMEM_BYTES))
    del panels
    torch.cuda.empty_cache()
    return f_lib_ms, s_lib


def max_tril_diff(torch, A, B, rows=2048):
    """max |tril(A) - tril(B)| and max |tril(B)| of two (N, N) matrices,
    a slab of rows at a time (no N x N temporary)."""
    err = ref = 0.0
    for r0 in range(0, A.shape[0], rows):
        a = torch.tril(A[r0:r0 + rows], r0)
        b = torch.tril(B[r0:r0 + rows], r0)
        err = max(err, float((a - b).abs().max()))
        ref = max(ref, float(b.abs().max()))
    return err, err / ref


def local_dense(torch, sp, Bloc):
    """Each SPIKE partition's matrix (P, m, m), dense, from its band
    storage ``Bloc`` (the lower triangle, mirrored)."""
    m, s, w = sp.m, sp.s, sp.w
    r = torch.arange(m, device="cuda")[:, None]
    c = (r // s - w) * s + torch.arange(sp.W, device="cuda")[None, :]
    keep = (c >= 0) & (c <= r)
    rr, cc = r.expand(-1, sp.W)[keep], c[keep]
    A = torch.zeros((sp.P, m, m), dtype=Bloc.dtype, device="cuda")
    for p in range(sp.P):
        v = Bloc[p, :m][keep]
        A[p, cc, rr] = v
        A[p, rr, cc] = v
    return A


def direct_rows(torch, timing, model, data, f_load, report, f_lib_ms,
                s_lib_ms):
    """K6 and K7 on the Jacobian ``data`` at the equilibrium: the dense
    factor of its dense matrix and the solve of the scaled load, the SPIKE
    spikes' substitution (the W spikes of the factor) and the SPIKE solve
    of the scaled load, each against its plain version.  The library
    times of K6b, K6c and K7c are those of the band rows' dense Cholesky
    and cholesky_solve (the same functions of the same matrix), not
    measured again; K7b's is a batched cholesky_solve with the dense
    local factors."""
    from sanm_tpu_torch.solver import linear as K6
    from sanm_tpu_torch.solver import spike as K7
    from sanm_tpu_torch.solver.assemble import DensePlan, dense_assemble

    f64 = torch.float64
    asm = model.asm
    n = asm.n
    t0 = time.perf_counter()

    # ---- K6b dense_factor: the kernel overwrites its matrix, which setup
    # restores from the pristine copy ----
    dp = DensePlan(asm.csr_rowidx, asm.csr_cols, n)
    M, scale = dense_assemble(dp, data)
    work = torch.empty_like(M)

    def restore():
        work.copy_(M)

    f_ms = timing.graph_ms(lambda: K6.dense_factor(dp, work), reps=2,
                           setup=restore)
    restore()
    inv = K6.dense_factor(dp, work)
    require(K6.dense_factor_ok(inv), "dense factor not finite")
    again = torch.empty_like(M)
    again.copy_(M)
    require(torch.equal(K6.dense_factor(dp, again), inv)
            and torch.equal(again, work), "dense_factor does not repeat its "
            "bits")
    del again
    plain = {}
    f_plain_ms = timing.ms(
        lambda: plain.update(inv=K6.dense_factor_plain(dp, M)), reps=1,
        warmup=0)
    e_l, r_l = max_tril_diff(torch, work, M)
    e_i, r_i = rel_err(inv, plain.pop("inv"))
    del M
    torch.cuda.empty_cache()
    tri = 8 * dp.npad * (dp.npad + 1) // 2
    report("dense_factor", max(e_l, e_i), max(r_l, r_i), f_ms, f_plain_ms,
           bound_ms(tri * 2 + nbytes(inv), dp.factor_flops(), PEAK_F64_TC_S),
           f_lib_ms, "(npad %d, %.2f GB; one CUDA-graph replay of the "
           "look-ahead's two streams, the trailing update two block columns "
           "deep; repeats its bits; bound: the lower triangle read and "
           "written once; library: the band rows' dense "
           "torch.linalg.cholesky; ptxas: panel %s; updates %s)"
           % (dp.npad, 8.0 * dp.npad ** 2 / 1e9,
              ptxas_usage("dense_panel_kernel"),
              ptxas_usage("dense_update_kernel")))

    # ---- K6c dense_solve of the scaled load ----
    rhs = torch.as_tensor(f_load, dtype=f64).cuda() * scale
    ys = K6.dense_solve(dp, work, inv, rhs)
    e_y, r_y = rel_err(ys, K6.dense_solve_plain(dp, work, inv, rhs))
    s_ms = timing.graph_ms(lambda: K6.dense_solve(dp, work, inv, rhs))
    report("dense_solve", e_y, r_y, s_ms,
           timing.ms(lambda: K6.dense_solve_plain(dp, work, inv, rhs),
                     reps=2, warmup=1),
           bound_ms(tri + nbytes(inv, rhs, ys), 2.0 * dp.npad ** 2),
           s_lib_ms, "(launches back to back in a CUDA graph; the lower "
           "triangle read once in the bound, twice by the algorithm; "
           "library: the band rows' torch.cholesky_solve)")
    del work, inv
    torch.cuda.empty_cache()

    # ---- K7b spike_rhs_solve: the W spikes' right-hand sides (the
    # coupling blocks in each partition's top b rows), restored by setup
    sp = K7.SpikePlan(asm.csr_rowidx, asm.csr_cols, n)
    Bloc, C, sc = K7.spike_assemble(sp, data)
    Ld = torch.linalg.cholesky(local_dense(torch, sp, Bloc))
    panels = K7.spike_local_factor(sp, Bloc)
    del Bloc
    P, m, b, s = sp.P, sp.m, sp.b, sp.s
    R0 = torch.zeros((P, m, b), dtype=f64, device="cuda")
    R0[1:, :b] = C
    R = torch.empty_like(R0)

    def restore_r():
        R.copy_(R0)

    b_ms = timing.graph_ms(lambda: K7.spike_rhs_solve(sp, panels, R),
                           reps=2, setup=restore_r)
    restore_r()
    X = K7.spike_rhs_solve(sp, panels, R)
    restore_r()
    b_plain_ms = timing.ms(
        lambda: plain.update(X=K7.spike_rhs_solve_plain(sp, panels, R)),
        reps=1, warmup=0)
    e_x, r_x = rel_err(X, plain.pop("X"))
    # library: one batched cholesky_solve with the dense local factors
    b_lib_ms = timing.ms(lambda: torch.cholesky_solve(R0, Ld), reps=2,
                         warmup=1)
    e_lib, _ = rel_err(torch.cholesky_solve(R0, Ld), X)
    del X, R, Ld
    # the work this input needs: the partitions whose right-hand sides are
    # not zero (all but partition 0), per block column the diagonal
    # product and the panel product, forward and backward, on b columns;
    # their panels read once, R read and X written once
    live = [p for p in range(P) if bool(R0[p].any())]
    flops = 4.0 * s * s * b * float((1 + sp.blk_w[live]).sum())
    report("spike_rhs_solve", e_x, r_x, b_ms, b_plain_ms,
           bound_ms(sum(nbytes(sp.panels_of(panels, p)) for p in live)
                    + 2 * nbytes(R0), flops, PEAK_F64_TC_S),
           b_lib_ms,
           "(P=%d partitions x m=%d rows x b=%d columns, %d of them with "
           "right-hand sides in the bound; launches back to back in a CUDA "
           "graph; library: torch.cholesky_solve with the dense local "
           "factors, err %.1e)" % (P, m, b, len(live), e_lib))
    del R0
    torch.cuda.empty_cache()

    # ---- K7c spike_solve of the scaled load ----
    F = K7.spike_factor(sp, panels, C)
    require(F.ok(), "SPIKE factor not finite")
    rhs = torch.as_tensor(f_load, dtype=f64).cuda() * sc
    ys = K7.spike_solve(sp, F, rhs)
    e_y, r_y = rel_err(ys, K7.spike_solve_plain(sp, F, rhs))
    s_ms = timing.graph_ms(lambda: K7.spike_solve(sp, F, rhs))
    reads = nbytes(F.panels, F.V, F.W, F.LU, F.lu_perm, F.invL, F.invUt,
                   F.G, F.Mh, rhs, ys)
    flops = 2.0 * (2 * P * m * b + 6 * P * b * b + 2 * F.panels.numel())
    report("spike_solve", e_y, r_y, s_ms,
           timing.ms(lambda: K7.spike_solve_plain(sp, F, rhs), reps=2,
                     warmup=1),
           bound_ms(reads, flops), s_lib_ms,
           "(launches back to back in a CUDA graph; library: the band "
           "rows' torch.cholesky_solve with the dense factor)")
    del F, panels, C
    torch.cuda.empty_cache()
    say("direct kernels: %.2f s" % (time.perf_counter() - t0))


#: one chunk of 64 PCG iterations from the start of a solve, the kernel
#: on the card against the plain version on the CPU, max |diff| / max
#: |plain| over x, r, z, p.  Both repeat their bits (checked), so the
#: reading is stable.  CG carries each iteration's rounding into every
#: later direction: a 1e-16 relative change of b moves the plain chunk by
#: up to ~1e-6 at armadillo-small (printed beside the reading), and the
#: kernel sums in another order than the plain version, ~1e-15 relative
#: apart after one iteration (held to TOL["pcg_step"]), ten times a
#: 1e-16 change; so a chunk may differ by up to ten times the
#: perturbation's effect
PCG_CHUNK_TOL = 1e-5


def pcg_trace(torch, csr, data, binv, b):
    """The 2,048 PCG iterations of ``SparseCG`` (chunks of 64, no early
    stop) on ``b``, on the device of the tensors (the kernel on the card,
    the plain version on the CPU): after every 512, the relative residual
    of the recurrence and the true one ||b - A x|| / ||b||; after every
    chunk, the CG functional phi = b.x - x.(A x) / 2, which decreases in
    exact arithmetic when -A is positive definite (phi - phi(x*) is half
    the error's squared -A norm).  Returns them and phi's largest rise
    over a chunk, relative to |phi| at the end (0 when it never rose)."""
    from sanm_tpu_torch.solver import assemble as K4
    from sanm_tpu_torch.solver import linear as K9

    st = K9.PCGState(b, binv)
    bnorm = float(torch.linalg.vector_norm(b))
    rec, true, phi = {}, {}, []
    while st.it < K9.SparseCG.MAX_ITER:
        K9.pcg_chunk(csr, data, binv, st, K9.SparseCG.CHUNK,
                     K9.SparseCG.TOL)
        ax = K4.csr_matvec(csr, data, st.x)
        phi.append(float(b @ st.x - 0.5 * (st.x @ ax)))
        if st.it % 512 == 0:
            rec[st.it] = float(st.slot()[1].sqrt()) / bnorm
            true[st.it] = float(torch.linalg.vector_norm(b - ax)) / bnorm
    rose = max([0.0] + [q - p for p, q in zip(phi, phi[1:])]) / abs(phi[-1])
    return {"rel_residual": rec, "true_rel_residual": true,
            "phi": {(i + 1) * 64: v for i, v in enumerate(phi)
                    if (i + 1) % 8 == 0}, "phi_rose": rose}


def trace_line(tr):
    """One line of :func:`pcg_trace`'s readings."""
    return "; ".join("%d: %.3e / %.3e, phi %.9e" % (
        it, tr["rel_residual"][it], tr["true_rel_residual"][it],
        tr["phi"][it]) for it in tr["rel_residual"]) + (
        "; phi's largest rise over a chunk, relative: %.1e" % tr["phi_rose"])


def cg_rows(torch, timing, model, data, f_load, report):
    """K4 COO and K9 on the CSR values ``data`` of the Jacobian at the
    equilibrium, with the gravity load ``f_load`` as vector and
    right-hand side: csr_matvec and csr_matvec_t, diag_blocks, one PCG
    iteration and one chunk of 64 from the same start, each against its
    plain version (the products on a seeded vector); then the relative
    residual of the solve's 2,048 iterations (printed, not checked)."""
    import numpy as np

    from sanm_tpu_torch.solver import assemble as K4
    from sanm_tpu_torch.solver import linear as K9

    t0 = time.perf_counter()
    csr = model.asm.csr_maps
    n, nnz = csr.n, csr.nnz
    b = torch.as_tensor(np.asarray(f_load), dtype=torch.float64).cuda()
    # the products on a seeded vector (A times the load nearly cancels in
    # the interior rows, which makes a relative error meaningless)
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(n)).cuda()

    # ---- csr_matvec, csr_matvec_t on v ----
    # the bound counts what A x or A^T y needs, A's CSR (row pointer,
    # columns, values), the vector and the result, not csr_matvec_t's
    # own gather map
    t_ptr, t_src, t_rows = csr.transposed
    for name, fn, plain, lib_mat in (
            ("csr_matvec", K4.csr_matvec, K4.csr_matvec_plain,
             (csr.row_ptr, csr.cols, data)),
            ("csr_matvec_t", K4.csr_matvec_t, K4.csr_matvec_t_plain,
             (t_ptr, t_rows, data[t_src.long()]))):
        y = fn(csr, data, v)
        yp = plain(csr, data, v)
        err, rel = rel_err(y, yp)
        S = torch.sparse_csr_tensor(lib_mat[0].long(), lib_mat[1].long(),
                                    lib_mat[2], size=(n, n))
        lib = timing.ms(lambda: S @ v)
        err_lib, _ = rel_err(S @ v, yp)
        report(name, err, rel,
               timing.kernel_ms(lambda: fn(csr, data, v)),
               timing.ms(lambda: plain(csr, data, v)),
               bound_ms(nbytes(csr.row_ptr, csr.cols, data, v, y), 2 * nnz),
               lib, "(library: CSR SpMV%s, err %.1e)"
               % (" of A^T" if name == "csr_matvec_t" else "", err_lib))
        del S

    # ---- diag_blocks ----
    blk = K4.diag_blocks(csr, data)
    err, rel = rel_err(blk, K4.diag_blocks_plain(csr, data))
    read = int((csr.dmap < nnz).sum())
    report("diag_blocks", err, rel,
           timing.kernel_ms(lambda: K4.diag_blocks(csr, data)),
           timing.ms(lambda: K4.diag_blocks_plain(csr, data)),
           bound_ms(nbytes(csr.dmap, blk) + 8 * read, 0),
           extra="(%d of %d block entries read)" % (read, blk.numel()))

    # ---- pcg_step: one iteration and one chunk of 64 from the start,
    # against the plain version on the CPU, whose sums run in one order ----
    cg = K9.SparseCG(csr, data)
    tol = K9.SparseCG.TOL
    # M^-1 is torch.linalg.inv of the blocks on the card (the JAX package
    # calls jnp.linalg.inv), held against the same call on the CPU
    eye = torch.eye(3, dtype=torch.float64)
    inv_err = rel_err(cg.binv.cpu(),
                      torch.linalg.inv(blk.cpu() + 1e-300 * eye))
    say("pcg_step: M^-1 (torch.linalg.inv of the %d diagonal blocks) on the "
        "card vs on the CPU: max abs err %.3e, rel %.3e" % (
            blk.shape[0], *inv_err))
    st0 = K9.PCGState(b, cg.binv)
    csr_c, data_c, binv_c = csr.to("cpu"), data.cpu(), cg.binv.cpu()

    def run(steps, on_card=True, start=st0):
        if on_card:
            st = K9.pcg_chunk(csr, data, cg.binv, start.clone(), steps, tol)
        else:
            st = K9.pcg_chunk_plain(csr_c, data_c, binv_c,
                                    start.clone("cpu"), steps, tol)
        return [t.cpu() for t in (st.x, st.r, st.z, st.p, st.S)]

    errs = [rel_err(a, c) for a, c in zip(run(1), run(1, False))]
    err1, rel1 = max(e for e, _ in errs), max(r for _, r in errs)
    kern64, plain64 = run(64), run(64, False)
    same = (all(torch.equal(a, c) for a, c in zip(kern64, run(64))),
            all(torch.equal(a, c) for a, c in zip(plain64, run(64, False))))
    rel64 = max(rel_err(a, c)[1] for a, c in zip(kern64[:4], plain64[:4]))
    noise = 1e-16 * torch.as_tensor(
        np.random.default_rng(1).standard_normal(n)).cuda()
    moved = max(rel_err(a, c)[1] for a, c in zip(
        run(64, False, K9.PCGState(b * (1 + noise), cg.binv))[:4],
        plain64[:4]))
    say("pcg_step: a chunk of 64 iterations from the start, kernel on the "
        "card vs plain on the CPU: rel err %.3e (tol %.0e); each repeats "
        "its bits: kernel %s, plain %s; the plain chunk moves by %.3e when "
        "b is perturbed by 1e-16 relative" % (rel64, PCG_CHUNK_TOL, *same,
                                               moved))
    require(all(same), "a PCG chunk does not repeat its bits")
    require(rel64 <= PCG_CHUNK_TOL, "pcg_step's chunk disagrees with its "
            "plain version")
    st_k, st_p = st0.clone(), st0.clone()
    ms = timing.kernel_ms(
        lambda: K9.pcg_chunk(csr, data, cg.binv, st_k, 64, tol), reps=5)
    plain_ms = timing.ms(
        lambda: K9.pcg_chunk_plain(csr, data, cg.binv, st_p, 64, tol),
        reps=2, warmup=1)
    # a chunk reads A, M^-1 and x, r, p once and writes x, r, z, p and the
    # scalars; per iteration 2 nnz for A p and 17 n for the dot products,
    # the updates and M^-1 r
    ins = (csr.row_ptr, csr.cols, data, cg.binv, st0.x, st0.r, st0.p)
    outs = (st0.x, st0.r, st0.z, st0.p, st0.S)
    report("pcg_step", err1, rel1, ms, plain_ms,
           bound_ms(nbytes(*ins, *outs), 64 * (2 * nnz + 17 * n)),
           extra="(error: one iteration, against the plain version on the "
                 "CPU; ms: one chunk of 64; %.2f us an iteration)"
                 % (ms * 1e3 / 64))

    # ---- a solve of the load, 2,048 iterations (it does not converge) ----
    say("cg on the armadillo-small Jacobian at the equilibrium, gravity "
        "load, 2,048 iterations on the card (the JAX package stops there), "
        "relative residual of the recurrence / true and the CG functional "
        "after each number of iterations: %s"
        % trace_line(pcg_trace(torch, csr, data, cg.binv, b)))
    del cg, st0, st_k, st_p
    say("cg kernels: %.2f s" % (time.perf_counter() - t0))


def run_cg_cuboid(torch):
    """``test_cuboid`` (configs/test_cuboid.json) with ``"solver": "cg"``
    through the port's entry point on the card, cold and one warm
    re-solve, the launch counts set to 0 just before; returns the task
    result, the counts, the scope stats and the PCG counters."""
    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.fea import app
    from sanm_tpu_torch.solver.linear import SparseCG
    from sanm_tpu_torch.utils import ScopedProfiler

    os.environ["SANM_WARM_TIMING"] = "1"
    ScopedProfiler.enabled = True
    ScopedProfiler.reset()
    SparseCG.reset_stats()
    cfg = dict(app.merge_configs(CG_CONFIGS), solver="cg")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            kernels.reset_launches()
            res = app.test_cuboid(cfg, os.path.dirname(CONFIG),
                                  device="cuda")
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
        finally:
            os.chdir(cwd)
    per = {}
    for name in ("sparse_prep", "sparse_solve", "order_step"):
        calls, tot = ScopedProfiler.stats(name)
        per[name] = (calls, tot / calls if calls else float("nan"))
    ScopedProfiler.enabled = False
    return res, launches, per, dict(SparseCG.STATS)


def phase_cg(torch):
    """The cg cell: test_cuboid on the PCG solver, cold and warm, against
    the JAX package's restarts and displacement."""
    import numpy as np

    t0 = time.perf_counter()
    res, launches, per, pcg = run_cg_cuboid(torch)
    st = res.stat
    label = "cg test_cuboid"
    rel = abs(st["displacement"] - CG_DISPLACEMENT) / CG_DISPLACEMENT
    say("%s: restarts %d (JAX package on the CPU: %d) solver_resolved=%s "
        "force_rms_recomp=%.3e (target %.0e; JAX package on the CPU "
        "8.39e-11) nr_inverted=%d" % (
            label, st["iter"], CG_RESTARTS, st["solver_resolved"],
            st["force_rms_recomp"], RMS_TARGET, st["nr_inverted"]))
    say("%s: displacement %.16g vs the JAX package's %.16g: rel diff %.3e "
        "(tol 1e-9)" % (label, st["displacement"], CG_DISPLACEMENT, rel))
    say("%s: time_solve cold=%.3f s warm=%.3f s time_prep=%.3f s" % (
        label, st["time_solve"], st["time_solve_warm"], st["time_prep"]))
    say("%s: PCG iterations per solve mean %.1f max %d over %d solves "
        "(%d run in chunks of 64); factor s/restart=%.4f (%d)  solve "
        "ms/solve=%.4f (%d)  step ms/order=%.4f (%d)" % (
            label, pcg["iterations"] / max(pcg["solves"], 1),
            pcg["max_iterations"], pcg["solves"], pcg["run"],
            per["sparse_prep"][1], per["sparse_prep"][0],
            per["sparse_solve"][1] * 1e3, per["sparse_solve"][0],
            per["order_step"][1] * 1e3, per["order_step"][0]))
    say("%s: launches %s" % (label, json.dumps(launches)))
    nv = 20 * 8 * 8
    require(np.isfinite(res.mesh.vertices).all()
            and res.mesh.vertices.shape == (nv, 3)
            and st["mesh_V"] == nv, "bad output mesh")
    require(st["force_rms_recomp"] <= RMS_TARGET, "not converged")
    require(st["nr_inverted"] == 0, "inverted elements")
    require(st["solver_resolved"] == "cg", "cg not taken (%s ran)"
            % st["solver_resolved"])
    require(rel <= 1e-9, "test_cuboid displacement on cg differs from the "
            "JAX package's")
    for name in ("csr_matvec", "diag_blocks", "pcg_step", "remap_in",
                 "remap_out", "nhc_step", "jac_asm"):
        require(launches[name] > 0, "kernel %s was not launched on the cg "
                "path" % name)
    phase_done("cg", t0)
    return launches, st


def cg_penalty_parity(torch):
    """The Tikhonov case ``CG_PENALTY_TASK`` on the card and on the CPU:
    same restarts, coordinates within ``PARITY_RTOL``, force-RMS <= 1e-9
    (the JAX package's test), cg in both; returns the card run's launch
    counts (csr_matvec_t's only main-path launches)."""
    import numpy as np

    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.fea import app

    os.environ.pop("SANM_WARM_TIMING", None)
    out = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for dev in ("cuda", "cpu"):
                kernels.reset_launches()
                out[dev] = app.test_cuboid(dict(CG_PENALTY_TASK), tmp,
                                           device=dev)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    launches = dict(kernels.LAUNCHES)
        finally:
            os.chdir(cwd)
    s_c, s_p = out["cuda"].solver, out["cpu"].solver
    x0 = s_p.model.x0()
    rel = float(np.abs(s_c.get_x() - s_p.get_x()).max()
                / np.abs(s_p.get_x() - x0).max())
    rms = max(r.stat["force_rms_recomp"] for r in out.values())
    say("parity cuboid (12 vertices, neohookean_c, order 8, cg, "
        "xcoeff_l2_penalty 1e-5): iter card %d / cpu %d, force-RMS <= "
        "%.3e, coord rel diff %.3e (tol %.0e); card launches csr_matvec_t "
        "%d pcg_step %d" % (s_c.get_nr_iter(), s_p.get_nr_iter(), rms, rel,
                            PARITY_RTOL, launches["csr_matvec_t"],
                            launches["pcg_step"]))
    require(s_c.get_nr_iter() == s_p.get_nr_iter(),
            "iterations differ between card and CPU")
    require(rel <= PARITY_RTOL, "card and CPU solutions differ")
    require(rms <= 1e-9, "Tikhonov cuboid not converged")
    require(all(r.stat["solver_resolved"] == "cg" for r in out.values()),
            "cg not taken")
    for name in ("csr_matvec_t", "pcg_step", "diag_blocks"):
        require(launches[name] > 0, "kernel %s was not launched on the "
                "Tikhonov cg path" % name)
    return launches


def cuboid_body():
    """The parity cuboid (6 x 4 x 4, 225 tets, x = 0 fixed) and its load,
    -200 N on each vertex of the far face."""
    import numpy as np

    from sanm_tpu_torch.fea import (DeformableBody, MaterialProperty,
                                    TetrahedralMesh)

    nx, ny, nz, h = 6, 4, 4, 0.025
    mesh = TetrahedralMesh.make_cuboid(nx, ny, nz, h)
    body = DeformableBody(MaterialProperty.from_young_poisson(1e7, 0.45),
                          mesh)
    body.coord_fixed_mask[mesh.vertices[:, 0] <= h / 2, :] = True
    f = np.zeros((mesh.nr_vertices, 3))
    f[mesh.vertices[:, 0] > (nx - 1) * h - h / 2, 2] = -200.0
    return body, f


def cuboid_solve(device, solver, energy_model):
    from sanm_tpu_torch.fea import DeformableBody, EnergyModel
    from sanm_tpu_torch.fea.app import RMS_THRESH_FORCE_EQU, run_anm_eqn
    from sanm_tpu_torch.solver import ANMEqnSolver, EqnHyperParam

    body, f = cuboid_body()
    model = body.make_forward(EnergyModel.from_name(energy_model),
                              device=device)
    fs = model.lt_inp.copy_vtx_values(f)
    hp = EqnHyperParam(order=20, use_pade=True, solver=solver)
    hp.converge_rms = RMS_THRESH_FORCE_EQU
    hp.solution_check_tol = 1e-3
    s = ANMEqnSolver(model, model.x0(), fs, hp)
    x = run_anm_eqn(s, progress=False)
    rms = DeformableBody.compute_force_rms(model, x, fs)
    require(s.solver_resolved() == solver,
            "cuboid on %s: %s ran" % (solver, s.solver_resolved()))
    return s.get_nr_iter(), x, rms


def cuboid_baseline(device, energy_model, levmar=False):
    """Projected Newton (or Levenberg-Marquardt) on the parity cuboid."""
    from sanm_tpu_torch.fea import EnergyModel, baseline
    from sanm_tpu_torch.fea.app import RMS_THRESH_FORCE_EQU

    body, f = cuboid_body()
    m = body.mesh
    desc = (EnergyModel.from_name(energy_model), body.material)
    if levmar:
        return baseline.solve_force_equ_levmar(
            m.tets, m.vertices, f, body.coord_fixed_mask, desc,
            RMS_THRESH_FORCE_EQU, device=device)
    return baseline.solve_energy_min(
        m.tets, m.vertices, m.vertices, f, body.coord_fixed_mask, desc,
        RMS_THRESH_FORCE_EQU, device=device)


def baseline_parity(torch):
    """Projected Newton (NHC, NHI, ARAP) and Levenberg-Marquardt (NHC) on
    the parity cuboid, card against CPU: same iterations, coordinates
    within ``PARITY_RTOL``, converged.  Returns the launch counts of the
    card runs (K10 NHI's only main-path launches)."""
    import numpy as np

    from sanm_tpu_torch import kernels

    launches = {}
    for em, levmar in (("neohookean_c", False), ("neohookean_i", False),
                       ("arap", False), ("neohookean_c", True)):
        kernels.reset_launches()
        st_c = cuboid_baseline("cuda", em, levmar)
        torch.cuda.synchronize()
        for k, v in kernels.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + v
        st_p = cuboid_baseline("cpu", em, levmar)
        rest = cuboid_body()[0].mesh.vertices
        rel = float(np.abs(st_c.vtx - st_p.vtx).max()
                    / np.abs(st_p.vtx - rest).max())
        rms = max(s.grad_rms_refine if s.nr_iter_refine else s.grad_rms
                  for s in (st_c, st_p))
        say("parity cuboid (225 tets, %s, %s): iter card %d + %d / cpu %d + "
            "%d, force-RMS <= %.3e, coord rel diff %.3e (tol %.0e)"
            % (em, "levmar" if levmar else "projected Newton", st_c.nr_iter,
               st_c.nr_iter_refine, st_p.nr_iter, st_p.nr_iter_refine, rms,
               rel, PARITY_RTOL))
        require((st_c.nr_iter, st_c.nr_iter_refine)
                == (st_p.nr_iter, st_p.nr_iter_refine),
                "baseline iterations differ between card and CPU")
        require(rel <= PARITY_RTOL, "card and CPU baselines differ")
        require(rms <= RMS_TARGET, "cuboid baseline not converged")
    for name in BASELINE_KERNELS:
        require(launches[name] > 0, "kernel %s was not launched in the "
                "cuboid's projected Newton" % name)
    return launches


def phase_parity():
    import numpy as np

    import torch

    t0 = time.perf_counter()
    threads = torch.get_num_threads()
    for em in ("neohookean_c", "neohookean_i", "arap"):
        for solver in ("host_lu", "band_chol", "dense_chol", "spike_band"):
            it_c, x_c, rms_c = cuboid_solve("cuda", solver, em)
            # the plain band factor is many small BLAS calls, which a pool
            # of CPU threads slows down
            torch.set_num_threads(1)
            try:
                it_p, x_p, rms_p = cuboid_solve("cpu", solver, em)
            finally:
                torch.set_num_threads(threads)
            rel = float(np.abs(x_c - x_p).max() / np.abs(x_p).max())
            say("parity cuboid (225 tets, %s, order 20, %s): iter card %d / "
                "cpu %d, force-RMS card %.3e / cpu %.3e, coord rel diff %.3e "
                "(tol %.0e)" % (em, solver, it_c, it_p, rms_c, rms_p, rel,
                                PARITY_RTOL))
            require(it_c == it_p, "iterations differ between card and CPU")
            require(rel <= PARITY_RTOL, "card and CPU solutions differ")
            require(max(rms_c, rms_p) <= RMS_TARGET, "cuboid not converged")
    launches = baseline_parity(torch)
    for k, v in cg_penalty_parity(torch).items():
        launches[k] = launches.get(k, 0) + v
    phase_done("parity", t0)
    return launches


def mesh_vertex_count(cfg):
    """The vertex count in the header of the task's tetgen .node file."""
    path = os.path.join(os.path.dirname(CONFIG), cfg["mesh"] + ".node")
    with open(path) as f:
        return int(f.readline().split()[0])


def run_gravity(torch, solver, configs=(CONFIG,), label=None,
                allow_fallback=False, warm=True, want=None):
    """``app.gravity`` on the task of the merged ``configs`` (default
    armadillo-small) with ``solver``, cold and (``warm``) one warm
    re-solve, with the profiler on and the launch counts set to 0 just
    before; returns the task result, the counts and the scope stats.
    The solver that ran must be ``want`` (default ``solver``; ``auto``
    names none); ``allow_fallback`` accepts a band solve that fell back
    to host LU (``mixed``)."""
    from sanm_tpu_torch import kernels
    import numpy as np

    from sanm_tpu_torch.fea import app
    from sanm_tpu_torch.utils import ScopedProfiler

    label = label or solver
    if warm:
        os.environ["SANM_WARM_TIMING"] = "1"
    else:
        os.environ.pop("SANM_WARM_TIMING", None)
    ScopedProfiler.enabled = True
    ScopedProfiler.reset()
    cfg = dict(app.merge_configs(list(configs)), solver=solver)
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
    per = {}
    for name in ("sparse_prep", "sparse_solve", "order_step", "bias_pull",
                 "build_sparse_coeff", "eval_fx0"):
        calls, tot = ScopedProfiler.stats(name)
        per[name] = (calls, tot / calls if calls else float("nan"))
    ScopedProfiler.enabled = False
    st = res.stat
    say("%s: iterations=%d solver_resolved=%s" % (
        label, st["iter"], st["solver_resolved"]))
    say("%s: force_rms_recomp=%.3e (target %.0e) nr_inverted=%d "
        "displacement=%.4g" % (label, st["force_rms_recomp"], RMS_TARGET,
                                st["nr_inverted"], st["displacement"]))
    say("%s: time_solve cold=%.3f s warm=%s s time_prep=%.3f s"
        % (label, st["time_solve"],
           "%.3f" % st["time_solve_warm"] if warm else "not run",
           st["time_prep"]))
    say("%s: launches %s" % (label, json.dumps(launches)))
    nv = mesh_vertex_count(cfg)
    require(np.isfinite(res.mesh.vertices).all()
            and res.mesh.vertices.shape == (nv, 3)
            and st["mesh_V"] == nv, "bad output mesh")
    require(st["force_rms_recomp"] <= RMS_TARGET, "not converged")
    require(st["nr_inverted"] == 0, "inverted elements")
    ran, want = st["solver_resolved"], want or solver
    require(ran == want or (allow_fallback and ran == "mixed"),
            "solver %s not taken (%s ran)" % (want, ran))
    return res, launches, per


def check_armadillo(label, st):
    """armadillo-small NHC gravity's restarts and displacement against the
    JAX package's on the CPU."""
    rel = (abs(st["displacement"] - ARMADILLO_DISPLACEMENT)
           / ARMADILLO_DISPLACEMENT)
    say("%s: restarts %d (JAX package on the CPU: %d); displacement %.16g "
        "vs the JAX package's %.16g: rel diff %.3e (tol 1e-9)"
        % (label, st["iter"], ARMADILLO_RESTARTS, st["displacement"],
           ARMADILLO_DISPLACEMENT, rel))
    require(st["iter"] == ARMADILLO_RESTARTS, "armadillo-small restarts "
            "differ from the JAX package's")
    require(rel <= 1e-9, "armadillo-small displacement differs from the "
            "JAX package's")


def phase_slice(torch):
    """The first slice's path: host SuperLU, cold only (its warm
    re-solve left the script for the NHI phase's time)."""
    t0 = time.perf_counter()
    res, launches, per = run_gravity(torch, "host_lu", warm=False)
    say("host_lu: factor s/restart=%.4f (%d)  backsolve s/solve=%.5f (%d)  "
        "K1+K2 ms/order=%.4f (%d)  bias_pull ms/order=%.4f (%d)  "
        "jac+K1 start s/restart=%.4f (%d)  f(x0) s=%.4f (%d)" % (
            per["sparse_prep"][1], per["sparse_prep"][0],
            per["sparse_solve"][1], per["sparse_solve"][0],
            per["order_step"][1] * 1e3, per["order_step"][0],
            per["bias_pull"][1] * 1e3, per["bias_pull"][0],
            per["build_sparse_coeff"][1], per["build_sparse_coeff"][0],
            per["eval_fx0"][1], per["eval_fx0"][0]))
    for name in ("nhc_step", "remap_in", "remap_out", "jac_asm"):
        require(launches[name] > 0, "kernel %s was not launched on the "
                "host_lu path" % name)
    check_armadillo("host_lu", res.stat)
    phase_done("slice", t0)
    return launches, res.stat, res.mesh.vertices


def phase_band(torch, verts_lu, verts_rest):
    """The band_chol path; its equilibrium against the host_lu one."""
    import numpy as np

    t0 = time.perf_counter()
    res, launches, per = run_gravity(torch, "band_chol")
    solver = res.solver
    solves = per["sparse_solve"][0]
    trips = launches["band_solve"] / solves - 1 if solves else float("nan")
    say("band_chol: factor s/restart=%.4f (%d)  band solve ms/solve=%.4f "
        "(%d)  refinement trips/solve=%.3f  K1+K2 ms/order=%.4f (%d)  "
        "jac+K1 start s/restart=%.4f (%d)  f(x0) s=%.4f (%d)" % (
            per["sparse_prep"][1], per["sparse_prep"][0],
            per["sparse_solve"][1] * 1e3, solves, trips,
            per["order_step"][1] * 1e3, per["order_step"][0],
            per["build_sparse_coeff"][1], per["build_sparse_coeff"][0],
            per["eval_fx0"][1], per["eval_fx0"][0]))
    verts = res.mesh.vertices
    disp = float(np.abs(verts_lu - verts_rest).max())
    diff = float(np.abs(verts - verts_lu).max()) / disp
    st = res.stat
    say("band_chol: expansions %s, fallbacks to host LU %s; coordinates "
        "vs host_lu: max diff / max displacement %.3e (tol %.0e)" % (
            json.dumps(st["expansions"]), json.dumps(st["band_fallbacks"]),
            diff, BAND_COORD_RTOL))
    require(not any(st["band_fallbacks"].values())
            and st["expansions"]["host_lu"] == 0,
            "the band path fell back to host LU")
    require(diff <= BAND_COORD_RTOL, "band and host-LU equilibria differ")
    for name in KERNELS:
        require(launches[name] > 0, "kernel %s was not launched on the "
                "band_chol path" % name)
    check_armadillo("band_chol", st)
    phase_done("band", t0)
    return launches, res.stat, verts, solver


def phase_direct(torch, verts_lu, verts_rest):
    """armadillo-small NHC gravity on the dense and the SPIKE device
    factors, cold and warm: the restarts and displacement of the JAX
    package, no fallback, the path's kernels launched, the equilibrium
    within ``BAND_COORD_RTOL`` of host LU's, and the peak card memory
    over the phase's start (dense_chol: at most 1.5 factors).  Returns
    each run's launch counts and stat."""
    import numpy as np

    out = {}
    for mode, names in DIRECT_KERNELS.items():
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res, launches, per = run_gravity(torch, mode)
        peak = torch.cuda.max_memory_allocated() - base
        plan = res.solver._fact["solver"].plan
        say("%s: peak card memory allocated over the phase's start %.3f GB "
            "(the factor %.3f GB)" % (mode, peak / 1e9,
                                      plan.mem_bytes() / 1e9))
        if mode == "dense_chol":
            # a restart frees the old factor before it builds the new one
            require(peak <= 1.5 * plan.mem_bytes(),
                    "two dense factors alive at once")
        if mode == "dense_chol":
            say("%s plan: s=%d nb=%d npad=%d; matrix %.3f GB, %.4e f64 "
                "operations" % (mode, plan.s, plan.nb, plan.npad,
                                plan.mem_bytes() / 1e9, plan.factor_flops()))
        else:
            z = plan.sizes_bytes()
            say("%s plan: s=%d w=%d b=%d P=%d m=%d rows_loc=%d, reach max %s "
                "mean %s blocks; GB: local panels %.3f, spikes %.3f, reduced "
                "%.3f (factor %.3f), working bands %.3f" % (
                    mode, plan.s, plan.w, plan.b, plan.P, plan.m,
                    plan.rows_loc, plan.blk_w.max(axis=1).tolist(),
                    np.round(plan.blk_w.mean(axis=1), 2).tolist(),
                    z["panels"] / 1e9, z["spikes"] / 1e9, z["reduced"] / 1e9,
                    plan.mem_bytes() / 1e9, z["work"] / 1e9))
        band_line(mode, res, launches, per, names[1])
        st = res.stat
        require(not any(st["band_fallbacks"].values())
                and st["expansions"]["host_lu"] == 0,
                "the %s path fell back to host LU" % mode)
        for name in KERNELS[:4] + ("element_matvec", "band_assemble") + names:
            require(launches[name] > 0, "kernel %s was not launched on the "
                    "%s path" % (name, mode))
        if mode == "spike_band":
            require(launches["band_factor"] > 0, "the local band factors "
                    "did not run")
        disp = float(np.abs(verts_lu - verts_rest).max())
        diff = float(np.abs(res.mesh.vertices - verts_lu).max()) / disp
        say("%s: coordinates vs host_lu: max diff / max displacement %.3e "
            "(tol %.0e)" % (mode, diff, BAND_COORD_RTOL))
        require(diff <= BAND_COORD_RTOL, "%s and host-LU equilibria differ"
                % mode)
        check_armadillo(mode, st)
        out[mode] = (launches, st)
        del res
        gc.collect()
        torch.cuda.empty_cache()
        phase_done(mode, t0)
    return out


def phase_arap(torch, verts_rest):
    """The ARAP cell on host LU, cold, and on the band solver, cold and
    warm, then the two equilibria compared; a band fallback to host LU is
    counted, printed with its restart, and accepted when the run
    converges."""
    import numpy as np

    t0 = time.perf_counter()
    out = {}
    for solver in ("host_lu", "band_chol"):
        label = "arap " + solver
        res, launches, per = run_gravity(torch, solver, ARAP_CONFIGS, label,
                                         allow_fallback=solver == "band_chol",
                                         warm=solver == "band_chol")
        st = res.stat
        say("%s: expansions %s, fallbacks to host LU %s at (restart, kind) "
            "%s; factor s/restart=%.4f (%d)  solve ms/solve=%.4f (%d)  "
            "step ms/order=%.4f (%d)  jac+start s/restart=%.4f (%d)  f(x0) "
            "s=%.4f (%d)" % (
                label, json.dumps(st["expansions"]),
                json.dumps(st["band_fallbacks"]),
                res.solver.band_fallback_log,
                per["sparse_prep"][1], per["sparse_prep"][0],
                per["sparse_solve"][1] * 1e3, per["sparse_solve"][0],
                per["order_step"][1] * 1e3, per["order_step"][0],
                per["build_sparse_coeff"][1], per["build_sparse_coeff"][0],
                per["eval_fx0"][1], per["eval_fx0"][0]))
        for name in ARAP_KERNELS + ("remap_in", "remap_out"):
            require(launches[name] > 0, "kernel %s was not launched on the "
                    "ARAP %s path" % (name, solver))
        require(launches["nhc_step"] == 0 and launches["jac_asm"] == 0,
                "an NHC kernel ran on the ARAP path")
        rel = abs(st["displacement"] - ARAP_DISPLACEMENT) / ARAP_DISPLACEMENT
        say("%s: restarts %d (JAX package on the CPU: %d); displacement "
            "%.16g vs the JAX package's %.16g: rel diff %.3e (tol 1e-9)"
            % (label, st["iter"], ARAP_CPU_RESTARTS, st["displacement"],
               ARAP_DISPLACEMENT, rel))
        require(rel <= 1e-9, "ARAP displacement differs from the JAX "
                "package's")
        out[solver] = (res, launches)
    verts = out["band_chol"][0].mesh.vertices
    verts_lu = out["host_lu"][0].mesh.vertices
    disp = float(np.abs(verts_lu - verts_rest).max())
    diff = float(np.abs(verts - verts_lu).max()) / disp
    say("arap: band_chol vs host_lu coordinates: max diff / max "
        "displacement %.3e (tol %.0e)" % (diff, BAND_COORD_RTOL))
    require(diff <= BAND_COORD_RTOL, "ARAP band and host-LU equilibria "
            "differ")
    phase_done("arap", t0)
    stats = {s: r.stat for s, (r, _) in out.items()}
    return out["band_chol"][1], stats, verts


def band_line(label, res, launches, per, solve_kernel="band_solve"):
    """Print a device factor's fallbacks, refinement trips and scopes of a
    gravity run (``solve_kernel``: the factor's substitution); returns the
    refinement trips per solve."""
    st = res.stat
    solves = per["sparse_solve"][0]
    trips = (launches[solve_kernel] / solves - 1 if solves
             else float("nan"))
    say("%s: expansions %s, fallbacks to host LU %s at (restart, kind) %s; "
        "refinement trips/solve=%.3f  factor s/restart=%.4f (%d)  solve "
        "ms/solve=%.4f (%d)  step ms/order=%.4f (%d)  jac+start "
        "s/restart=%.4f (%d)  f(x0) s=%.4f (%d)" % (
            label, json.dumps(st["expansions"]),
            json.dumps(st["band_fallbacks"]), res.solver.band_fallback_log,
            trips, per["sparse_prep"][1], per["sparse_prep"][0],
            per["sparse_solve"][1] * 1e3, solves,
            per["order_step"][1] * 1e3, per["order_step"][0],
            per["build_sparse_coeff"][1], per["build_sparse_coeff"][0],
            per["eval_fx0"][1], per["eval_fx0"][0]))
    return trips


def phase_nhi(torch, solvers=("band_chol",)):
    """The NHI cell (human as it is) on the band solver, cold and warm,
    and (``solvers`` with ``host_lu``, under ``--records``) on host LU,
    cold, then the two equilibria compared; a band fallback to host LU is
    counted, printed with its restart, and accepted when the run
    converges.  Returns the band run's result and launch counts and the
    runs' stats."""
    import numpy as np

    t0 = time.perf_counter()
    out = {}
    for solver in solvers:
        label = "nhi " + solver
        res, launches, per = run_gravity(
            torch, solver, HUMAN_CONFIGS, label,
            allow_fallback=solver == "band_chol", warm=solver == "band_chol")
        st = res.stat
        if solver == "band_chol":
            band_line(label, res, launches, per)
            need = NHI_KERNELS + ("remap_in", "remap_out", "element_matvec",
                                  "band_assemble", "band_factor",
                                  "band_solve")
        else:
            say("%s: factor s/restart=%.4f (%d)  backsolve s/solve=%.5f (%d)"
                "  step ms/order=%.4f (%d)" % (
                    label, per["sparse_prep"][1], per["sparse_prep"][0],
                    per["sparse_solve"][1], per["sparse_solve"][0],
                    per["order_step"][1] * 1e3, per["order_step"][0]))
            need = NHI_KERNELS + ("remap_in", "remap_out")
        for name in need:
            require(launches[name] > 0, "kernel %s was not launched on the "
                    "NHI %s path" % (name, solver))
        require(launches["nhc_step"] == 0 and launches["jac_asm"] == 0,
                "an NHC kernel ran on the NHI path")
        rel = abs(st["displacement"] - HUMAN_DISPLACEMENT) / HUMAN_DISPLACEMENT
        say("%s: restarts %d (JAX package on the CPU: %d); displacement "
            "%.16g vs the JAX package's %.16g: rel diff %.3e (tol 1e-9)"
            % (label, st["iter"], HUMAN_CPU_RESTARTS, st["displacement"],
               HUMAN_DISPLACEMENT, rel))
        require(rel <= 1e-9, "NHI displacement differs from the JAX "
                "package's")
        out[solver] = (res, launches)
    if "host_lu" in out:
        verts = out["band_chol"][0].mesh.vertices
        verts_lu = out["host_lu"][0].mesh.vertices
        model = out["host_lu"][0].solver.model
        disp = float(np.abs(model.lt_inp.copy_vtx_values(verts_lu)
                            - model.x0()).max())
        diff = float(np.abs(verts - verts_lu).max()) / disp
        say("nhi: band_chol vs host_lu coordinates: max diff / max "
            "displacement %.3e (tol %.0e)" % (diff, BAND_COORD_RTOL))
        require(diff <= BAND_COORD_RTOL, "NHI band and host-LU equilibria "
                "differ")
    phase_done("nhi", t0)
    stats = {s: r.stat for s, (r, _) in out.items()}
    return out["band_chol"][0], out["band_chol"][1], stats


def nhi_step_flops(k):
    """f64 operations per element of K1n at commit order k + bias k+1,
    counting only terms the data needs (not the zero g_{k+1} terms)."""
    m = k + 1
    commit = (36 * (k + 1) + 9 + 6 * (k + 1) + 9 * (2 * k + 1)  # C, J, Q
              + 18 * (k + 1) + 6 * max(k - 1, 0) + 5  # Ic, A
              + 4 * (k + 1) + 5)  # s
    bias = (36 * (m - 1) + 9 + 6 * m + 9 * (2 * m + 1)
            + 18 * (m - 1) + 6 * (m - 1) + 5 + 4 * (m + 1) + 5
            + 36 * m + 18)  # P
    return commit + bias


def phase_nhi_kernels(torch, timing, res):
    """K1n and K3n against their plain versions on the human model state
    of the NHI band run ``res`` (its model, load, band plan and
    equilibrium)."""
    from sanm_tpu_torch.ops import nhi_series as K1n
    from sanm_tpu_torch.solver import assemble as K23

    t0 = time.perf_counter()
    model, f_load = res.solver.model, res.solver.eqn_y
    asm, elems = model.asm, model.elems
    B = asm.B
    rows = {}
    report = reporter(rows)
    plan = res.solver.band_plan()
    say("human model: B=%d n=%d nnz=%d; band plan: s=%d bw=%d nb=%d mean "
        "reach %.2f blocks; factor %.3f GB, working band %.3f GB, %.4e f64 "
        "operations" % (B, asm.n, asm.nnz, plan.s, plan.bw, plan.nb,
                        float(plan.blk_w.mean()), plan.mem_bytes() / 1e9,
                        plan.work_mem_bytes() / 1e9, plan.factor_flops()))

    # ---- K3n at the equilibrium ----
    x_eq = model.lt_inp.copy_vtx_values(res.mesh.vertices)
    gin = K23.remap_in(asm, asm.pad_vector(x_eq))
    F = elems.deformation_gradient(gin)
    strain = float((F - torch.eye(3, dtype=F.dtype, device="cuda"))
                   .abs().max())
    del F
    say("human equilibrium: max |F - I| = %.4f" % strain)
    require(strain >= 1e-3, "the NHI equilibrium is not deformed")
    data, _, E = K23.jac_asm_nhi(asm, elems, gin)
    data_p, _, E_p = K23.jac_asm_nhi_plain(asm, elems, gin)
    e_d, r_d = rel_err(data, data_p)
    e_e, r_e = rel_err(E, E_p)
    del data_p, E_p
    flops = B * (900 + asm.Dout * 9 * 9 * 2 + asm.Dout * asm.Din * 9 * 2)
    report("jac_asm_nhi", max(e_d, e_e), max(r_d, r_e),
           timing.kernel_ms(lambda: K23.jac_asm_nhi(asm, elems, gin),
                            reps=5),
           timing.ms(lambda: K23.jac_asm_nhi_plain(asm, elems, gin),
                     reps=2, warmup=1),
           bound_ms(nbytes(gin, elems.bias, elems.dminv, asm.Lout, asm.Lin,
                           asm.nz_ptr, asm.nz_slot, E, data), flops))
    del data, E
    # ---- K10 (NHI) at the equilibrium ----
    k10_row(torch, timing, report, "hess_proj_nhi", model, (gin,))

    # ---- K1n along a real first restart from the rest shape, solved
    # with the card's band factor (host SuperLU of the human mesh takes
    # seconds a factor).  At k it reads the 25 components of orders <= k,
    # gin, Dm^-1 and writes order k's components and the bias ----
    err_k, worst, ms_k, plain_k, bnd_k = series_row(
        timing, "K1n", model, f_load, K1n.NHISeries(elems, 20),
        K1n.nhi_step, K1n.nhi_step_plain, K1n.GROUPS,
        lambda h, k: h[: k + 2],
        lambda k: bound_ms(8 * B * (K1n.NCOMP * (k + 1) + 27),
                           B * nhi_step_flops(k)),
        factor=band_chol_factor(model, plan))
    report("nhi_step", err_k, worst, ms_k, plain_k, (bnd_k, "bytes"),
           extra="(mean over the 19 per-order launches of one restart)")
    torch.cuda.empty_cache()
    phase_done("nhi kernels", t0)
    return rows


def phase_stvk(torch):
    """The StVK cell (armadillo-small, the stiff material) on the band
    solver, cold and warm.  Returns the run's result, launch counts and
    stat."""
    t0 = time.perf_counter()
    label = "stvk band_chol"
    with tempfile.TemporaryDirectory() as tmp:
        over = os.path.join(tmp, "override_stvk.json")
        with open(over, "w") as f:
            json.dump(STVK_OVERRIDE, f)
        res, launches, per = run_gravity(torch, "band_chol",
                                         STVK_CONFIGS + [over], label)
    st = res.stat
    band_line(label, res, launches, per)
    require(not any(st["band_fallbacks"].values())
            and st["expansions"]["host_lu"] == 0,
            "the StVK band path fell back to host LU")
    for name in STVK_KERNELS + ("remap_in", "remap_out", "element_matvec",
                                "band_assemble", "band_factor",
                                "band_solve"):
        require(launches[name] > 0, "kernel %s was not launched on the "
                "StVK band_chol path" % name)
    require(launches["nhc_step"] == 0 and launches["jac_asm"] == 0,
            "an NHC kernel ran on the StVK path")
    rel = abs(st["displacement"] - STVK_DISPLACEMENT) / STVK_DISPLACEMENT
    say("%s: restarts %d (JAX package on the CPU: %d); displacement %.16g "
        "vs the JAX package's %.16g: rel diff %.3e (tol 1e-9)"
        % (label, st["iter"], STVK_RESTARTS, st["displacement"],
           STVK_DISPLACEMENT, rel))
    require(st["iter"] == STVK_RESTARTS, "StVK restarts differ from the "
            "JAX package's")
    require(rel <= 1e-9, "StVK displacement differs from the JAX package's")
    phase_done("stvk", t0)
    return res, launches, st


def phase_guide(torch):
    """docs/GUIDE.md section 1 through the function entry point, with no
    device given (the card): x * x = 4 from x = 1."""
    import numpy as np

    from sanm_tpu_torch.solver import ANMEqnSolver, EqnHyperParam, LinearRemap

    t0 = time.perf_counter()
    n = 3
    remap = LinearRemap.identity(n)
    hp = EqnHyperParam(order=8, use_pade=True)
    hp.converge_rms = 1e-10
    s = ANMEqnSolver(lambda x: x * x, remap, remap, np.full(n, 1.0),
                     np.full(n, -4.0), hp)
    it = 0
    while not s.converged():
        s.next_iter()
        it += 1
        require(it < 50, "the GUIDE example did not converge")
    x = np.asarray(s.get_x())
    err = float(np.abs(x - 2.0).max() / 2.0)
    say("guide: ANMEqnSolver(fn, remap, remap, x0, y, hp) on %s: %d "
        "restarts, solver %s, x = %s, rel err %.2e (tol 1e-9)"
        % (s.model.device, s.get_nr_iter(), s.solver_resolved(),
           x.tolist(), err))
    require(s.model.device.type == "cuda", "the function entry point did "
            "not run on the card")
    require(err <= 1e-9, "the GUIDE example missed x = 2")
    phase_done("guide", t0)


def stvk_step_flops(k):
    """f64 operations per element of K1s at commit order k + bias k+1,
    counting only terms the data needs (not the zero g_{k+1} terms):
    F_k 45, b_k 36 (k + 1); the bias's b_{k+1} 36 k and P 54 (k + 1) +
    18."""
    return 45 + 36 * (k + 1) + 36 * k + 54 * (k + 1) + 18


#: f64 operations of K3s's dP/dF and chain per element: F 54, C and b 90,
#: the 81 entries ~324, the chain through Dm^-1 405
K3S_OPS = 880


def phase_stvk_kernels(torch, timing, res):
    """K1s and K3s against their plain versions on the armadillo-small
    StVK state of the band run ``res`` (its model, load, band plan and
    equilibrium), with the port's Taylor engine on the same graph."""
    from sanm_tpu_torch import taylor
    from sanm_tpu_torch.ops import stvk_series as K1s
    from sanm_tpu_torch.solver import assemble as K23

    t0 = time.perf_counter()
    model, f_load = res.solver.model, res.solver.eqn_y
    asm, elems = model.asm, model.elems
    B = asm.B
    rows = {}
    report = reporter(rows)
    plan = res.solver.band_plan()

    # ---- K3s at the equilibrium ----
    x_eq = model.lt_inp.copy_vtx_values(res.mesh.vertices)
    gin = K23.remap_in(asm, asm.pad_vector(x_eq))
    F = elems.deformation_gradient(gin)
    strain = float((F - torch.eye(3, dtype=F.dtype, device="cuda"))
                   .abs().max())
    del F
    say("stvk equilibrium: max |F - I| = %.4f" % strain)
    require(strain >= 1e-3, "the StVK equilibrium is not deformed")
    data, _, E = K23.jac_asm_stvk(asm, elems, gin)
    data_p, _, E_p = K23.jac_asm_stvk_plain(asm, elems, gin)
    e_d, r_d = rel_err(data, data_p)
    e_e, r_e = rel_err(E, E_p)
    del data_p, E_p
    flops = B * (K3S_OPS + asm.Dout * 9 * 9 * 2 + asm.Dout * asm.Din * 9 * 2)
    report("jac_asm_stvk", max(e_d, e_e), max(r_d, r_e),
           timing.kernel_ms(lambda: K23.jac_asm_stvk(asm, elems, gin),
                            reps=5),
           timing.ms(lambda: K23.jac_asm_stvk_plain(asm, elems, gin),
                     reps=2, warmup=1),
           bound_ms(nbytes(gin, elems.bias, elems.dminv, asm.Lout, asm.Lin,
                           asm.nz_ptr, asm.nz_slot, E, data), flops))
    del data, E
    # ---- the engine's batched_jacobian against K3s's plain Jacobian ----
    t1 = time.perf_counter()
    J_eng = taylor.batched_jacobian(model.fn, gin.reshape(B, 3, 3))
    torch.cuda.synchronize()
    jac_s = time.perf_counter() - t1
    _, r_j = rel_err(J_eng, K23.stvk_jacobian_plain(elems, gin))
    del J_eng
    say("engine: batched_jacobian of the StVK graph at the equilibrium "
        "(B=%d, 9 tangents in sequence, %.3f s) vs K3s's plain Jacobian: "
        "rel err %.3e (tol %.0e)" % (B, jac_s, r_j, ENGINE_TOL["jacobian"]))
    require(r_j <= ENGINE_TOL["jacobian"], "the engine's Jacobian disagrees "
            "with K3s's plain version")

    # ---- K1s along a real first restart from the rest shape (band
    # factor), the engine on the same restart.  At k the kernel reads
    # F_0..F_{k-1}, b_1..b_{k-1}, gin and Dm^-1 and writes F_k, b_k and
    # the bias: 15 (k + 1) + 21 values per element ----
    tfn = taylor.TaylorFn(model.fn, gin.reshape(B, 3, 3))
    state = {"err": 0.0}

    class EngineChecked(K1s.StVKSeries):
        def start(self, gin0):
            super().start(gin0)
            state["eng"] = eng = tfn.engine()
            eng.start(gin0.reshape(B, 3, 3))
            require(eng.order_bias() is None, "the engine's order-1 bias "
                    "is not zero")

    def check(k, gin_k, b_plain):
        eng = state["eng"]
        eng.push(gin_k.reshape(B, 3, 3))
        state["err"] = max(state["err"], rel_err(
            eng.order_bias().reshape(B, 9), b_plain)[1])

    t1 = time.perf_counter()
    err_k, worst, ms_k, plain_k, bnd_k = series_row(
        timing, "K1s", model, f_load, EngineChecked(elems, 20),
        K1s.stvk_step, K1s.stvk_step_plain, K1s.GROUPS,
        lambda h, k: h[: k + 2],
        lambda k: bound_ms(8 * B * (K1s.NCOMP * (k + 1) + 21),
                           B * stvk_step_flops(k)),
        factor=band_chol_factor(model, plan), check=check)
    say("engine: the StVK graph's biases of orders 2..20 on the card (B=%d; "
        "the restart with both %.2f s) vs K1s's plain version: max rel err "
        "%.3e (tol %.0e)" % (B, time.perf_counter() - t1, state["err"],
                             ENGINE_TOL["series"]))
    require(state["err"] <= ENGINE_TOL["series"], "the engine's series "
            "disagrees with K1s's plain version")
    report("stvk_step", err_k, worst, ms_k, plain_k, (bnd_k, "bytes"),
           extra="(mean over the 19 per-order launches of one restart)")
    del state, tfn
    torch.cuda.empty_cache()
    phase_done("stvk kernels", t0)
    return rows


def run_deform(torch, solver, configs=DEFORM_CONFIGS, label=None,
               warm=False, want=None, device="cuda"):
    """The ``mesh_twist`` task of the merged ``configs`` (default the
    armadillo ARAP bend) through the port's entry point with ``solver``,
    cold and (``warm``) one warm task re-run, with the profiler on and
    the launch counts set to 0 just before; every run must converge
    without inverted elements and, where ``want`` (the JAX package's
    displacement) is given, take ``DEFORM_RESTARTS`` and agree with it to
    1e-9 relative.  Returns the task result (its ``cold`` the first
    run's under ``warm``), the counts and the scope stats."""
    import numpy as np

    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.fea import app
    from sanm_tpu_torch.utils import ScopedProfiler

    label = label or solver
    if warm:
        os.environ["SANM_WARM_TIMING"] = "1"
    else:
        os.environ.pop("SANM_WARM_TIMING", None)
    ScopedProfiler.enabled = True
    ScopedProfiler.reset()
    cfg = dict(app.merge_configs(list(configs)), solver=solver)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            kernels.reset_launches()
            t0 = time.perf_counter()
            res = app.TASKS["mesh_twist"](cfg, os.path.dirname(CONFIG),
                                          device=device)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
        finally:
            os.chdir(cwd)
            os.environ.pop("SANM_WARM_TIMING", None)
    per = {}
    for name in ("sparse_prep", "sparse_solve", "order_step",
                 "build_sparse_coeff", "eval_fx0"):
        calls, tot = ScopedProfiler.stats(name)
        per[name] = (calls, tot / calls if calls else float("nan"))
    ScopedProfiler.enabled = False
    nv = mesh_vertex_count(cfg)
    for tag, r in (("cold", res.cold or res), ("warm", res if warm else None)):
        if r is None:
            continue
        st = r.stat
        rel = abs(st["displacement"] - want) / want if want else None
        ref = ("(JAX package on the CPU: %d + %d; displacement %.16g, rel "
               "diff %.3e, tol 1e-9)" % (*DEFORM_RESTARTS, want, rel)
               if want else "(no CPU reference)")
        say("%s %s: restarts %d + %d; solver_resolved=%s expansions %s band "
            "fallbacks %s; force_rms_recomp=%.3e nr_inverted=%d; "
            "displacement %.16g %s; time %.3f s"
            % (label, tag, st["iter_deform"], st["iter_refine"],
               st["solver_resolved"], json.dumps(st["expansions"]),
               json.dumps(st["band_fallbacks"]), st["force_rms_recomp"],
               st["nr_inverted"], st["displacement"], ref, st["time"]))
        require(np.isfinite(r.mesh.vertices).all()
                and r.mesh.vertices.shape == (nv, 3) and st["V"] == nv,
                "bad output mesh")
        require(st["force_rms_recomp"] <= RMS_TARGET, "not converged")
        require(st["nr_inverted"] == 0, "inverted elements")
        ran = st["solver_resolved"]
        require(ran == solver or (solver == "band_chol" and ran == "mixed"),
                "solver %s not taken (%s ran)" % (solver, ran))
        if want:
            require((st["iter_deform"], st["iter_refine"])
                    == DEFORM_RESTARTS, "restarts differ from the JAX "
                    "package's")
            require(rel <= 1e-9, "displacement differs from the JAX "
                    "package's")
    st = res.stat
    say("%s: task wall %.3f s%s; factor s/restart=%.4f (%d)  solve "
        "ms/solve=%.4f (%d)  step ms/order=%.4f (%d)  jac+start "
        "s/restart=%.4f (%d)  f(x0) s=%.4f (%d)" % (
            label, wall, " (cold + warm; warm solve %.3f s, warm task "
            "%.3f s)" % (st["time_solve_warm"], st["time_task_warm"])
            if warm else "",
            per["sparse_prep"][1], per["sparse_prep"][0],
            per["sparse_solve"][1] * 1e3, per["sparse_solve"][0],
            per["order_step"][1] * 1e3, per["order_step"][0],
            per["build_sparse_coeff"][1], per["build_sparse_coeff"][0],
            per["eval_fx0"][1], per["eval_fx0"][0]))
    say("%s: launches %s" % (label, json.dumps(launches)))
    return res, launches, per


#: the deform phase's runs: (solver, material, warm re-run, its kernels)
DEFORM_LEGS = (("band_chol", "arap", True, ARAP_KERNELS),
               ("host_lu", "arap", False, ARAP_KERNELS),
               ("band_chol", "neohookean_c", False, ("nhc_step", "jac_asm")))


def phase_deform(torch):
    """The deform cell (armadillo ARAP bend as it is) on the band solver,
    cold and with a warm task re-run, and on host LU, cold; the same bend
    with NHC on the band solver, cold.  Every run: 2 deform + 1 refine
    restarts, force-RMS <= 1e-10, no inverted element, the displacement
    within 1e-9 relative of the JAX package's; a band fallback to host
    LU is printed and passes if the run converges.  Returns the ARAP band
    run's launch counts and every run's stat."""
    t0 = time.perf_counter()
    stats = {}
    band = ("grad_t", "remap_in", "remap_out", "element_matvec",
            "band_assemble", "band_factor", "band_solve")
    for solver, em, warm, material in DEFORM_LEGS:
        label = "deform %s %s" % (em, solver)
        configs = DEFORM_CONFIGS if em == "arap" else DEFORM_NHC_CONFIGS
        res, launches, _ = run_deform(torch, solver, configs, label, warm,
                                      DEFORM_DISPLACEMENT[em])
        need = material + (band if solver == "band_chol" else
                           ("grad_t", "remap_in", "remap_out"))
        for name in need:
            require(launches[name] > 0, "kernel %s was not launched on the "
                    "%s path" % (name, label))
        if (em, solver) == ("arap", "band_chol"):
            arap_launches = launches
        stats[label] = res.stat
        del res
        torch.cuda.empty_cache()
    phase_done("deform", t0)
    return arap_launches, stats


def phase_deform_kernels(torch, timing, device="cuda"):
    """K3t against its plain version at the deform's first restart (the
    armadillo ARAP bend at rest, t = 0), and K2 remap_in, K8c (with K3t)
    and K4 at Din = 13 on the same mesh with a delta on every vertex
    (the bend's plan has Din = 12: an element that reads t has a moved,
    hence fixed, vertex), each against its plain version."""
    import numpy as np

    from sanm_tpu_torch.fea import app
    from sanm_tpu_torch.ops import svd_w as K8a
    from sanm_tpu_torch.solver import assemble as K23
    from sanm_tpu_torch.solver.band import BandPlan

    t0 = time.perf_counter()
    rows = {}
    report = reporter(rows)
    cfg = app.merge_configs(DEFORM_CONFIGS)
    body, idx, dist = app.twist_setup(cfg, os.path.dirname(CONFIG))
    delta = app.twist_delta(cfg, body.mesh.vertices, idx, dist)
    em = app.energy_model_of(cfg)
    model = body.make_forward(em, vtx_delta=delta, device=device)
    asm, elems = model.asm, model.elems
    gin = K23.remap_in(asm, asm.pad_vector(np.append(model.x0(), 0.0)))
    data, gt, E = model.jac_asm(gin)
    n_t = int(asm.t_slot.numel())
    plan = K23.plan_for(BandPlan, asm.csr_rowidx, asm.csr_cols, asm.n)
    say("deform model: %d fixed vertices, %d of them moved; B=%d n=%d "
        "nnz=%d Din=%d Dout=%d, %d t-column slots in %d rows; max |grad_t| "
        "%.3e; band plan: s=%d bw=%d nb=%d mean reach %.2f blocks, factor "
        "%.3f GB, working band %.3f GB, %.4e f64 operations" % (
            int(body.coord_fixed_mask[:, 0].sum()), len(idx), asm.B, asm.n,
            asm.nnz, asm.Din, asm.Dout, n_t,
            int((asm.t_ptr[1:] > asm.t_ptr[:-1]).sum()),
            float(gt.abs().max()), plan.s, plan.bw, plan.nb,
            float(plan.blk_w.mean()), plan.mem_bytes() / 1e9,
            plan.work_mem_bytes() / 1e9, plan.factor_flops()))
    require(float(gt.abs().max()) > 0, "grad_t of the bend is zero")
    ref = K23.grad_t_plain(asm, E)
    err, rel = rel_err(K23.grad_t(asm, E), ref)
    acc = torch.zeros(asm.n_rows + 1, dtype=torch.float64, device=device)
    idx_t = asm.t_slot_row.long()
    flat = E.reshape(-1)
    report("grad_t", err, rel,
           timing.kernel_ms(lambda: K23.grad_t(asm, E)),
           timing.ms(lambda: K23.grad_t_plain(asm, E)),
           bound_ms(nbytes(asm.t_ptr, asm.t_slot, gt) + 8 * n_t, n_t),
           timing.ms(lambda: acc.index_add_(0, idx_t, flat)),
           "(library: index_add_ of E over t_slot_row)")
    del data, gt, E, ref, acc, idx_t, flat, model

    # ---- Din = 13: a delta on every vertex ----
    rng = np.random.default_rng(13)
    h = float(np.cbrt(body.mesh.tet_volumes.mean()))
    model = body.make_forward(
        em, vtx_delta=rng.uniform(-0.05, 0.05, delta.shape) * h,
        device=device)
    asm, elems = model.asm, model.elems
    require(asm.Din == 13, "Din %d, expected 13" % asm.Din)
    xp = asm.pad_vector(np.append(model.x0(), 0.37))
    gin = K23.remap_in(asm, xp)
    e_in = rel_err(gin, K23.remap_in_plain(asm, xp))[1]
    u, s, w = K8a.svd_w(elems.deformation_gradient(gin).contiguous())
    data, gt, E = K23.jac_asm_arap(asm, elems, u, s, w)
    data_p, gt_p, E_p = K23.jac_asm_arap_plain(asm, elems, u, s, w)
    e_j = max(rel_err(a, b)[1] for a, b in ((data, data_p), (gt, gt_p),
                                             (E, E_p)))
    del data_p, gt_p, E_p
    x = torch.sin(torch.arange(asm.n, dtype=torch.float64, device=device))
    e_mv = rel_err(K23.element_matvec(asm, E, x),
                   K23.element_matvec_plain(asm, E, x))[1]
    say("Din 13 (B=%d n=%d nnz=%d): rel err remap_in %.2e (tol %.0e), "
        "jac_asm_arap + grad_t %.2e (tol %.0e), element_matvec %.2e "
        "(tol %.0e); remap_in ms=%.4f plain_ms=%.4f, jac_asm_arap ms=%.4f "
        "plain_ms=%.4f" % (
            asm.B, asm.n, asm.nnz, e_in, TOL["remap_in"], e_j,
            TOL["jac_asm_arap"], e_mv, TOL["element_matvec"],
            timing.kernel_ms(lambda: K23.remap_in(asm, xp)),
            timing.ms(lambda: K23.remap_in_plain(asm, xp)),
            timing.kernel_ms(lambda: K23.jac_asm_arap(asm, elems, u, s, w),
                             reps=5),
            timing.ms(lambda: K23.jac_asm_arap_plain(asm, elems, u, s, w),
                      reps=2, warmup=1)))
    require(e_in <= TOL["remap_in"] and e_j <= TOL["jac_asm_arap"]
            and e_mv <= TOL["element_matvec"],
            "a kernel disagrees with its plain version at Din = 13")
    torch.cuda.empty_cache()
    phase_done("deform kernels", t0)
    return rows


def refine_trace(torch, label, configs, trips=8):
    """The relative residual ||b - A x|| / ||b|| after 0..``trips``
    refinement trips of the card's band solve against K4 (no early exit),
    with the tangent at rest of the task of ``configs``, for two
    right-hand sides: the gravity load (the first solve of a restart)
    and A v for a smooth v (no cancellation in b)."""
    from functools import partial

    import numpy as np

    from sanm_tpu_torch.solver.assemble import element_matvec
    from sanm_tpu_torch.solver.band import (BandPlan, DeviceBandCholSolver,
                                            band_solve)
    from sanm_tpu_torch.solver.linear import chol_refine_solve

    model, f_load = armadillo_model(configs)
    asm = model.asm
    data, _, E = model.jac_asm(asm.apply_in(model.x0()))
    mv = partial(element_matvec, asm, E)
    plan = BandPlan(asm.csr_rowidx, asm.csr_cols, asm.n)
    s = DeviceBandCholSolver(plan, data, mv)
    require(s.factor_ok(), "band factor at rest not finite")
    v = torch.sin(torch.arange(asm.n, dtype=torch.float64,
                               device="cuda") * 1e-3)
    for name, b in (("gravity load", torch.as_tensor(f_load).cuda()),
                    ("A v", mv(v))):
        rel = [float(chol_refine_solve(
            lambda r: band_solve(plan, s.panels, r), s.scale, b, mv,
            refine_steps=k, rtol=0.0, with_resid=True)[2])
            for k in range(trips + 1)]
        say("refinement %s (%s): rel residual after 0..%d trips %s"
            % (label, name, trips, " ".join("%.1e" % r for r in rel)))
        require(np.isfinite(rel).all(), "refinement not finite")


def run_baseline(torch, label, configs):
    """The task of the merged ``configs`` with a baseline section through
    the port's entry point, cold, with the profiler on and the launch
    counts set to 0 just before: force-RMS <= 1e-10, no inverted element,
    the displacement within ``BASELINE_RTOL`` of the JAX package's CPU
    value, the cell's K10 and (with a refinement) its Jacobian kernel
    launched.  Returns the stat and the counts."""
    import numpy as np

    from sanm_tpu_torch import kernels
    from sanm_tpu_torch.fea import app
    from sanm_tpu_torch.utils import ScopedProfiler

    os.environ.pop("SANM_WARM_TIMING", None)
    ScopedProfiler.enabled = True
    ScopedProfiler.reset()
    cfg = app.merge_configs(list(configs))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            kernels.reset_launches()
            t0 = time.perf_counter()
            res = app.TASKS[cfg["func"]](cfg, os.path.dirname(CONFIG),
                                         device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
        finally:
            os.chdir(cwd)
    n_lu, t_lu = ScopedProfiler.stats("newton_solve")
    n_h, t_h = ScopedProfiler.stats("newton_hess")
    ScopedProfiler.enabled = False
    st = res.stat
    want = BASELINE_DISPLACEMENT[label]
    rel = abs(st["displacement"] - want) / want
    k10, jac = BASELINE_CELL_KERNELS[label]
    say("baseline %s: iter_tot %d iter_refine %d (JAX package on the CPU: "
        "%d + %d); time %.3f s newton_time %.3f s (task wall %.3f s); host "
        "SuperLU %d factors %.3f s (%.1f%% of time); Hessian (card + copy "
        "to the host) %d x %.4f s; K10 %s launches %d, %s %d"
        % ((label, st["iter_tot"], st["iter_refine"])
           + BASELINE_ITERS[label]
           + (st["time"], st["newton_time"], wall, n_lu, t_lu,
              100.0 * t_lu / st["time"], n_h, t_h / max(n_h, 1), k10,
              launches[k10], jac, launches[jac])))
    say("baseline %s: force_rms_recomp=%.3e (target %.0e) nr_inverted=%d; "
        "displacement %.16g vs the JAX package's %.16g: rel diff %.3e (tol "
        "%.0e)" % (label, st["force_rms_recomp"], RMS_TARGET,
                   st["nr_inverted"], st["displacement"], want, rel,
                   BASELINE_RTOL))
    say("baseline %s: launches %s" % (label, json.dumps(launches)))
    nv = mesh_vertex_count(cfg)
    require(np.isfinite(res.mesh.vertices).all()
            and res.mesh.vertices.shape == (nv, 3), "bad output mesh")
    require(st["force_rms_recomp"] <= RMS_TARGET, "%s not converged" % label)
    require(st["nr_inverted"] == 0, "inverted elements")
    require(rel <= BASELINE_RTOL, "%s displacement differs from the JAX "
            "package's" % label)
    require(launches[k10] > 0, "K10 %s was not launched" % k10)
    require(st["iter_refine"] == 0 or launches[jac] > 0,
            "the refinement's %s was not launched" % jac)
    return st, launches


def phase_baseline(torch, cells=BASELINE_CELLS):
    """The projected Newton baseline on ``cells`` (:func:`run_baseline`;
    the smoke run's: the armadillo ARAP bend).  Returns per cell the stat
    and the launch counts."""
    t0 = time.perf_counter()
    out = {}
    for label, configs in cells.items():
        out[label] = run_baseline(torch, label, configs)
        torch.cuda.empty_cache()
    phase_done("baseline", t0)
    return out


def phase_records(torch):
    """Records outside the smoke run: the jet NHI cell
    (``configs/jet.json``) on band_chol and on host_lu, cold (a fallback
    is counted and printed, and a run passes if it converges), the human
    ARAP bend (``human.json`` + ``human_bend_override.json``) on
    band_chol, cold, the refinement trace of :func:`refine_trace` on
    armadillo-small NHC, human NHI and jet NHI, human NHI on band_chol
    and host_lu, armadillo-small NHC on cg (:func:`armadillo_cg_record`),
    the PCG witness (:func:`cg_witness_record`) and the baselines' full
    size cells."""
    t0 = time.perf_counter()
    stats = {}
    for solver in ("band_chol", "host_lu"):
        label = "jet " + solver
        res, launches, per = run_gravity(
            torch, solver, JET_CONFIGS, label,
            allow_fallback=solver == "band_chol", warm=False)
        if solver == "band_chol":
            band_line(label, res, launches, per)
        stats[solver] = res.stat
    del res
    res = run_deform(torch, "band_chol", HUMAN_BEND_CONFIGS,
                     "human arap bend band_chol")[0]
    stats["human_bend"] = res.stat
    del res
    torch.cuda.empty_cache()
    for label, configs in (("armadillo-small NHC", [CONFIG]),
                           ("human NHI", HUMAN_CONFIGS),
                           ("jet NHI", JET_CONFIGS)):
        refine_trace(torch, label, configs)
        torch.cuda.empty_cache()
    stats["nhi"] = phase_nhi(torch, ("band_chol", "host_lu"))[2]
    torch.cuda.empty_cache()
    stats["armadillo cg"] = armadillo_cg_record(torch)
    torch.cuda.empty_cache()
    stats["cg witness"] = cg_witness_record(torch)
    torch.cuda.empty_cache()
    phase_done("records", t0)
    for label, (st, _) in phase_baseline(torch,
                                         BASELINE_RECORD_CELLS).items():
        stats["baseline " + label] = st
    return stats


def armadillo_cg_record(torch):
    """armadillo-small NHC gravity on the PCG solver, cold: the JAX
    package's cg stops after 2,048 iterations a solve, short of 1e-13 on
    this Jacobian, and its expansion fails the order checks there
    (``SANMNumericalError``), which this record expects and reports; any
    other outcome is printed as it is."""
    from sanm_tpu_torch.solver.linear import SparseCG
    from sanm_tpu_torch.utils import SANMNumericalError, ScopedProfiler

    SparseCG.reset_stats()
    t = time.perf_counter()
    try:
        res = run_gravity(torch, "cg", label="armadillo cg", warm=False)[0]
        out = {"outcome": "converged", "iter": res.stat["iter"],
               "force_rms_recomp": res.stat["force_rms_recomp"],
               "displacement": res.stat["displacement"]}
    except SANMNumericalError as e:
        out = {"outcome": "SANMNumericalError", "error": str(e)}
    except Fail as e:
        out = {"outcome": "failed check", "error": str(e)}
    ScopedProfiler.enabled = False
    pcg = dict(SparseCG.STATS)
    out.update(seconds=time.perf_counter() - t, pcg=pcg)
    say("armadillo cg (records): %s; PCG iterations per solve mean %.1f max "
        "%d over %d solves" % (json.dumps({k: v for k, v in out.items()
                                           if k != "pcg"}),
                               pcg["iterations"] / max(pcg["solves"], 1),
                               pcg["max_iterations"], pcg["solves"]))
    return out


def cg_witness_record(torch):
    """The solve of :func:`cg_rows`, two witnesses: armadillo-small NHC
    gravity on band_chol, cold, gives the equilibrium; at its Jacobian
    the 2,048 PCG iterations of the gravity load run by the kernel on the
    card and by the plain version on the CPU (:func:`pcg_trace`, the same
    M^-1), printed side by side."""
    import numpy as np

    from sanm_tpu_torch.solver import assemble as K23
    from sanm_tpu_torch.solver import linear as K9
    from sanm_tpu_torch.utils import ScopedProfiler

    res = run_gravity(torch, "band_chol", label="cg witness", warm=False)[0]
    ScopedProfiler.enabled = False
    model, f_load = armadillo_model()
    asm = model.asm
    gin = K23.remap_in(asm, asm.pad_vector(
        model.lt_inp.copy_vtx_values(res.mesh.vertices)))
    data = K23.jac_asm(asm, model.elems, gin)[0]
    del res, gin
    b = torch.as_tensor(np.asarray(f_load), dtype=torch.float64).cuda()
    csr = asm.csr_maps
    binv = K9.SparseCG(csr, data).binv
    out = {}
    for dev, c in (("card, kernel", csr), ("CPU, plain", csr.to("cpu"))):
        t = time.perf_counter()
        out[dev] = pcg_trace(torch, c, data.to(c.device), binv.to(c.device),
                             b.to(c.device))
        out[dev]["seconds"] = time.perf_counter() - t
        say("cg witness (records), armadillo-small NHC equilibrium, "
            "gravity load, %s (%.2f s): relative residual of the recurrence "
            "/ true and the CG functional after each number of iterations: "
            "%s" % (dev, out[dev]["seconds"], trace_line(out[dev])))
    return out


def svd_w_check(torch, m):
    """K8a against its plain version on ``m``: the
    largest error of s, W and the stretch U diag(|s|) U^T (absolute,
    relative) and the number of elements whose flip choice (the signs of
    s) differs."""
    from sanm_tpu_torch.ops import svd_w as K8a

    u, s, w = K8a.svd_w(m)
    pu, ps, pw = K8a.svd_w_plain(m)

    def stretch(u, s):
        return (u * s.abs()[:, None, :]) @ u.transpose(1, 2)

    errs = [rel_err(s, ps), rel_err(w, pw),
            rel_err(stretch(u, s), stretch(pu, ps))]
    flips = int(((s < 0) != (ps < 0)).any(dim=1).sum())
    return max(e[0] for e in errs), max(e[1] for e in errs), flips


def arap_step_flops(k):
    """f64 operations per element of K8b at commit order k + bias k+1:
    the convolutions each pass needs (i < m/2 pairs of two 3x3 products
    mirrored, the middle term, m-1 products for Bpw) plus nine 3x3
    products and the element-wise terms of the rule."""
    def conv(m):
        half = (m - 1) // 2
        mid = 1 if m % 2 == 0 and m >= 2 else 0
        return 2 * 45 * (half + mid) + 2 * 9 * half + 45 * (m - 1) + 9
    fixed = 9 * 45 + 60
    return conv(k) + conv(k + 1) + 2 * fixed + 45


def phase_arap_kernels(torch, timing, verts_eq):
    """K8a-c against their plain versions on the ARAP cell's state:
    ``verts_eq`` are the vertices of the ARAP equilibrium."""
    from sanm_tpu_torch.ops import arap_series as K8b
    from sanm_tpu_torch.ops import svd_w as K8a
    from sanm_tpu_torch.solver import assemble as K23

    t0 = time.perf_counter()
    model, f_load = armadillo_model(ARAP_CONFIGS)
    asm, elems = model.asm, model.elems
    B = asm.B
    rows = {}
    report = reporter(rows)

    # ---- K8a at the equilibrium, and on its mirror image (det < 0 in
    # every element, so that every element flips) ----
    x_eq = model.lt_inp.copy_vtx_values(verts_eq)
    gin = K23.remap_in(asm, asm.pad_vector(x_eq))
    F = elems.deformation_gradient(gin).contiguous()
    mirror = F.clone()
    mirror[:, 0, :] *= -1
    err, rel, flips = svd_w_check(torch, F)
    err_m, rel_m, flips_m = svd_w_check(torch, mirror)
    say("K8a flip choice: %d of %d elements differ at the equilibrium, %d "
        "on its mirror image (rel err %.2e there, tol %.0e)"
        % (flips, B, flips_m, rel_m, MIRROR_TOL))
    require(flips == 0 and flips_m == 0, "K8a's flip choice differs from "
            "its plain version's")
    require(rel_m <= MIRROR_TOL, "K8a disagrees with its plain version on "
            "the mirror image: rel err %.3g" % rel_m)

    def library_svd_w():
        U, S, Vh = torch.linalg.svd(F)
        return U @ Vh

    report("svd_w", err, rel,
           timing.kernel_ms(lambda: K8a.svd_w(F)),
           timing.ms(lambda: K8a.svd_w_plain(F), reps=3),
           bound_ms(8 * B * (9 + 9 + 3 + 9), B * (36 * 66 + 150)),
           timing.ms(library_svd_w, reps=3),
           "(library: torch.linalg.svd + U Vh, without the flip)")

    # ---- K8c at the equilibrium ----
    u, s, w = K8a.svd_w(F)
    data, _, E = K23.jac_asm_arap(asm, elems, u, s, w)
    data_p, _, E_p = K23.jac_asm_arap_plain(asm, elems, u, s, w)
    e_d, r_d = rel_err(data, data_p)
    e_e, r_e = rel_err(E, E_p)
    del data_p, E_p
    flops = B * (81 * 70 + asm.Dout * 9 * 9 * 2 + asm.Dout * asm.Din * 9 * 2)
    report("jac_asm_arap", max(e_d, e_e), max(r_d, r_e),
           timing.kernel_ms(lambda: K23.jac_asm_arap(asm, elems, u, s, w),
                            reps=5),
           timing.ms(lambda: K23.jac_asm_arap_plain(asm, elems, u, s, w),
                     reps=2, warmup=1),
           bound_ms(nbytes(u, s, w, elems.dminv, asm.Lout, asm.Lin,
                           asm.nz_ptr, asm.nz_slot, E, data), flops))
    del data, E
    # ---- K10 (ARAP) at the equilibrium ----
    k10_row(torch, timing, report, "hess_proj_arap", model, (u, s, w))

    # ---- K8b along two real restarts: the first from the rest shape
    # (timed and reported; there F0 = I, so s0 = (1, 1, 1)) and one from
    # the ARAP equilibrium back to no load (a separated spectrum s0, so
    # that the s-dependent terms are held too; the worse error is
    # reported).  At order k it must read the 24 components of orders
    # 1..k-1, row 0's W0, the constants row's 21, gin and Dm^-1, and
    # write order k and the bias ----
    def k8b_row(label, f, x0):
        return series_row(
            timing, label, model, f, K8b.ARAPSeries(elems, 20),
            K8b.arap_step, K8b.arap_step_plain, K8b.GROUPS, lambda h, k: h,
            lambda k: bound_ms(8 * B * (24 * (k - 1) + 9 + 21 + 18 + 24 + 9),
                               B * arap_step_flops(k)), x0=x0)

    err_k, worst, ms_k, plain_k, bnd_k = k8b_row("K8b", f_load, None)
    s_eq = K8a.svd_w(F)[1].abs()
    say("K8b from the ARAP equilibrium: s0 spread max |s0 - 1| = %.3e"
        % float((s_eq - 1).abs().max()))
    require(float((s_eq - 1).abs().max()) >= 1e-3,
            "the ARAP equilibrium is not deformed")
    err_eq, worst_eq = k8b_row("K8b (eq)", 0 * f_load, x_eq)[:2]
    report("arap_step", max(err_k, err_eq), max(worst, worst_eq), ms_k,
           plain_k, (bnd_k, "bytes"),
           extra="(times: mean over the 19 per-order launches of the "
                 "restart from the rest shape; error: the worse of that "
                 "restart and the one from the ARAP equilibrium)")
    torch.cuda.empty_cache()
    phase_done("arap kernels", t0)
    return rows


def phase_inverse(torch):
    """The two inverse cells as they are (``auto``), cold: each must take
    host LU, converge in the JAX package's restarts to its displacement,
    and launch its material's K1i and K3i and no band kernel; an explicit
    ``band_chol`` on the inverse model must raise.  Returns per cell the
    result and the launch counts."""
    from sanm_tpu_torch import SANMError
    from sanm_tpu_torch.solver import ANMEqnSolver, EqnHyperParam

    t0 = time.perf_counter()
    out = {}
    for cell, cfgs in INV_CONFIGS.items():
        label = "inverse " + cell
        res, launches, per = run_gravity(torch, "auto", cfgs, label,
                                         warm=False, want="host_lu")
        st = res.stat
        say("%s: factor s/restart=%.4f (%d)  backsolve s/solve=%.5f (%d)  "
            "step ms/order=%.4f (%d)  jac+start s/restart=%.4f (%d)  f(x0) "
            "s=%.4f (%d)" % (
                label, per["sparse_prep"][1], per["sparse_prep"][0],
                per["sparse_solve"][1], per["sparse_solve"][0],
                per["order_step"][1] * 1e3, per["order_step"][0],
                per["build_sparse_coeff"][1], per["build_sparse_coeff"][0],
                per["eval_fx0"][1], per["eval_fx0"][0]))
        step, jac = INV_CELL_KERNELS[cell]
        say("%s: K1i (%s) launches %d, K3i (%s) %d, K2 remap_in %d "
            "remap_out %d" % (label, step, launches[step], jac,
                              launches[jac], launches["remap_in"],
                              launches["remap_out"]))
        for name in (step, jac, "remap_in", "remap_out"):
            require(launches[name] > 0, "kernel %s was not launched on the "
                    "%s path" % (name, label))
        for name in KERNELS + ARAP_KERNELS + NHI_KERNELS + DEFORM_KERNELS:
            if name not in ("remap_in", "remap_out"):
                require(launches[name] == 0, "kernel %s ran on the %s path"
                        % (name, label))
        want = INV_DISPLACEMENT[cell]
        rel = abs(st["displacement"] - want) / want
        say("%s: restarts %d (JAX package on the CPU: %d); displacement "
            "%.16g vs the JAX package's %.16g: rel diff %.3e (tol 1e-9)"
            % (label, st["iter"], INV_RESTARTS, st["displacement"], want,
               rel))
        require(st["iter"] == INV_RESTARTS, "%s: %d restarts, the JAX "
                "package takes %d" % (label, st["iter"], INV_RESTARTS))
        require(rel <= 1e-9, "%s displacement differs from the JAX "
                "package's" % label)
        out[cell] = (res, launches)
    model = out["armadillo"][0].solver.model
    try:
        ANMEqnSolver(model, model.x0(), torch.zeros(model.asm.n).numpy(),
                     EqnHyperParam(order=4, solver="band_chol"))
    except SANMError as e:
        say("inverse: explicit band_chol raises: %s" % e)
    else:
        raise Fail("band_chol on the inverse model did not raise")
    phase_done("inverse", t0)
    return out


def phase_invcheck(torch):
    """``FEA_INVCHECK`` on bar NHI: forward on ``auto`` (the band factor),
    then the result solved back in inverse mode (host LU); the restored
    rest vertices must lie within ``INVCHECK_TOL`` of the original in
    norm.  Returns the stat."""
    t0 = time.perf_counter()
    os.environ["FEA_INVCHECK"] = "1"
    try:
        res, launches, _ = run_gravity(torch, "auto", BAR_CONFIGS,
                                       "invcheck bar", allow_fallback=True,
                                       warm=False, want="band_chol")
    finally:
        os.environ.pop("FEA_INVCHECK", None)
    st = res.stat
    say("invcheck bar: forward %s, inverse %s; invcheck norm %.3e (tol "
        "%.0e); launches nhi_step %d band_factor %d inv_nhi_step %d "
        "jac_asm_inv_nhi %d" % (
            st["solver_resolved"], st["invcheck_solver_resolved"],
            st["invcheck_norm"], INVCHECK_TOL, launches["nhi_step"],
            launches["band_factor"], launches["inv_nhi_step"],
            launches["jac_asm_inv_nhi"]))
    require(st["invcheck_solver_resolved"] == "host_lu",
            "the inverse half of the round trip did not run on host LU")
    for name in ("nhi_step", "inv_nhi_step", "jac_asm_nhi",
                 "jac_asm_inv_nhi"):
        require(launches[name] > 0, "kernel %s was not launched in the "
                "round trip" % name)
    require(st["invcheck_norm"] <= INVCHECK_TOL,
            "the round trip does not restore the rest shape")
    phase_done("invcheck", t0)
    return st


def inv_step_flops(k, mat):
    """f64 operations per element of K1i (``mat`` "nhc" or "nhi") at
    commit order k + bias k+1, counting only terms the data needs (not
    the zero g_{k+1} terms)."""
    def order_pass(m, zero):
        ops = (36 * (m - 1 if zero else m + 1) + 9  # cofactor
               + 6 * (m if zero else m + 1)  # det Dm
               + 9 * (2 * m + 1)  # Q
               + 36 * (m + 1))  # W
        return ops + (3 * m + 3 if mat == "nhc" else 6 * m + 1)
    m = k + 1
    stress = 12 * (m + 1) + 120 + (2 * (m + 1) if mat == "nhc" else 0)
    return order_pass(k, False) + order_pass(m, True) + stress


def phase_inverse_kernels(torch, timing, runs):
    """K3i and K1i against their plain versions on the model states of
    the inverse runs ``runs`` (per cell the result and launch counts of
    :func:`phase_inverse`)."""
    from functools import partial

    from sanm_tpu_torch.ops import inv_series as K1i
    from sanm_tpu_torch.solver import assemble as K23

    t0 = time.perf_counter()
    rows = {}
    report = reporter(rows)
    for cell, (res, _) in runs.items():
        model, f_load = res.solver.model, res.solver.eqn_y
        asm, elems = model.asm, model.elems
        B = asm.B
        mat = "nhc" if cell == "armadillo" else "nhi"
        step_name, jac_name = INV_CELL_KERNELS[cell]
        jac = getattr(K23, jac_name)
        jac_plain = getattr(K23, jac_name + "_plain")
        say("inverse %s model: B=%d n=%d nnz=%d" % (cell, B, asm.n, asm.nnz))

        # ---- K3i at the first restart (the given mesh) and at the rest
        # shape found ----
        x_rest = model.lt_inp.copy_vtx_values(res.mesh.vertices)
        err = rel = 0.0
        for x in (model.x0(), x_rest):
            gin = K23.remap_in(asm, asm.pad_vector(x))
            data, _, E = jac(asm, elems, gin)
            data_p, _, E_p = jac_plain(asm, elems, gin)
            for a, b in ((data, data_p), (E, E_p)):
                e, r = rel_err(a, b)
                err, rel = max(err, e), max(rel, r)
            del data, E, data_p, E_p
        gin = K23.remap_in(asm, asm.pad_vector(model.x0()))
        data, _, E = jac(asm, elems, gin)
        flops = B * (1300 + asm.Dout * 9 * 9 * 2 + asm.Dout * asm.Din * 9 * 2)
        report(jac_name, err, rel,
               timing.kernel_ms(lambda: jac(asm, elems, gin), reps=5),
               timing.ms(lambda: jac_plain(asm, elems, gin), reps=2,
                         warmup=1),
               bound_ms(nbytes(gin, elems.bias, elems.ds, asm.Lout, asm.Lin,
                               asm.nz_ptr, asm.nz_slot, E, data), flops),
               extra="(error at the first restart and at the rest shape "
               "found; times at the first restart)")
        del data, E

        # ---- K1i along the first restart from the given mesh: at k it
        # reads the NC components of orders <= k, gin, Ds and writes order
        # k's components and the bias ----
        nc = K1i.NCOMP[mat]
        cls = K1i.InvNHCSeries if mat == "nhc" else K1i.InvNHISeries
        err_k, worst, ms_k, plain_k, bnd_k = series_row(
            timing, "K1i " + cell, model, f_load, cls(elems, 20),
            cls.step_fn, partial(K1i.inv_step_plain, mat), K1i.GROUPS[mat],
            lambda h, k: h[: k + 2],
            lambda k: bound_ms(8 * B * (nc * (k + 1) + 27),
                               B * inv_step_flops(k, mat)))
        report(step_name, err_k, worst, ms_k, plain_k, (bnd_k, "bytes"),
               extra="(mean over the 19 per-order launches of one restart)")
        torch.cuda.empty_cache()
    phase_done("inverse kernels", t0)
    return rows


def write_out(out_dir, stats):
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke.log"), "w") as f:
            f.write("\n".join(_LOG) + "\n")
        with open(os.path.join(out_dir, "chip_smoke_stat.json"), "w") as f:
            json.dump(stats, f, indent=1)


def main(argv):
    records = "--records" in argv
    argv = [a for a in argv if a != "--records"]
    out_dir = None
    if len(argv) == 2 and argv[0] == "--out":
        out_dir = argv[1]
    elif argv:
        print("usage: python3 chip_smoke.py [--records] [--out DIR]",
              file=sys.stderr)
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
    if records:
        stats = phase_records(torch)
        write_out(out_dir, {"records": stats})
        faulthandler.cancel_dump_traceback_later()
        say("records done in %.2f s" % (time.perf_counter() - _T0))
        return 0
    _, stat_lu, verts_lu = phase_slice(torch)
    verts_rest = rest_vertices()
    launches, stat, verts_eq, band_solver = phase_band(
        torch, verts_lu, verts_rest)
    torch.cuda.empty_cache()
    direct = phase_direct(torch, verts_lu, verts_rest)
    launches_arap, stats_arap, verts_arap = phase_arap(torch, verts_rest)
    torch.cuda.empty_cache()
    res_nhi, launches_nhi, stats_nhi = phase_nhi(torch)
    torch.cuda.empty_cache()
    res_stvk, launches_stvk, stat_stvk = phase_stvk(torch)
    phase_guide(torch)
    torch.cuda.empty_cache()
    launches_deform, stats_deform = phase_deform(torch)
    torch.cuda.empty_cache()
    runs_inv = phase_inverse(torch)
    stat_invcheck = phase_invcheck(torch)
    torch.cuda.empty_cache()
    runs_base = phase_baseline(torch)
    launches_cg, stat_cg = phase_cg(torch)
    timing = Timing(torch)
    phase_mma_probe(torch)
    rows = phase_kernels(torch, timing, verts_eq)
    rows.update(phase_arap_kernels(torch, timing, verts_arap))
    rows.update(phase_nhi_kernels(torch, timing, res_nhi))
    rows.update(phase_stvk_kernels(torch, timing, res_stvk))
    rows.update(phase_deform_kernels(torch, timing))
    rows.update(phase_inverse_kernels(torch, timing, runs_inv))
    launches_inv = {name: runs_inv[cell][1][name]
                    for cell, names in INV_CELL_KERNELS.items()
                    for name in names}
    stats_inv = {cell: r.stat for cell, (r, _) in runs_inv.items()}
    del timing, res_nhi, res_stvk, runs_inv
    torch.cuda.empty_cache()
    launches_parity = phase_parity()
    phase_profile(torch, band_solver)
    del band_solver
    # K10 on the baselines: ARAP on the full-size armadillo bend, NHC and
    # NHI only on the 3x2x2 cuboid's projected Newton (parity phase; the
    # full-size NHC cells run under --records); each K10 row says which
    launches_base = {"hess_proj": launches_parity["hess_proj"],
                     "hess_proj_arap": runs_base["arap bend"][1][
                         "hess_proj_arap"],
                     "hess_proj_nhi": launches_parity["hess_proj_nhi"]}
    launches_on = {"hess_proj": BASELINE_CUBOID_ONLY,
                   "hess_proj_nhi": BASELINE_CUBOID_ONLY,
                   "hess_proj_arap": "armadillo-small ARAP bend, projected "
                                     "Newton baseline, full size",
                   "csr_matvec_t": CG_PENALTY_ONLY}
    launches_cg["csr_matvec_t"] = launches_parity["csr_matvec_t"]
    kern = []
    for name in (KERNELS + ARAP_KERNELS + NHI_KERNELS + STVK_KERNELS
                 + DEFORM_KERNELS + INV_KERNELS + DIRECT_KERNEL_NAMES
                 + BASELINE_KERNELS + CG_KERNELS):
        r = rows[name]
        # launches on the path auto takes on the card: the NHC band phase
        # for K1-K5, the ARAP band phase for K8a-c, the NHI band phase for
        # K1n and K3n, the StVK band phase for K1s and K3s, the ARAP
        # deform band phase (cold + warm) for K3t,
        # the armadillo (NHC) and bob (NHI) inverse runs for K1i and K3i,
        # the NHC dense_chol and spike_band phases for K6 and K7, the
        # baselines for K10, the test_cuboid cg phase (cold + warm) for K4
        # COO and K9 (csr_matvec_t: the Tikhonov cuboid of the parity
        # phase)
        runs = (launches_cg if name in CG_KERNELS else
                launches_base if name in BASELINE_KERNELS else
                launches_arap if name in ARAP_KERNELS else
                launches_nhi if name in NHI_KERNELS else
                launches_stvk if name in STVK_KERNELS else
                launches_deform if name in DEFORM_KERNELS else
                launches_inv if name in INV_KERNELS else
                direct["dense_chol"][0] if name in DIRECT_KERNELS[
                    "dense_chol"] else
                direct["spike_band"][0] if name in DIRECT_KERNELS[
                    "spike_band"] else launches)
        kern.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=runs[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
        if name in launches_on:
            kern[-1]["launches_on"] = launches_on[name]
    say("build_s=%.2f total_s=%.2f" % (build_s, time.perf_counter() - _T0))
    write_out(out_dir, {"band_chol": stat, "host_lu": stat_lu,
                        "dense_chol": direct["dense_chol"][1],
                        "spike_band": direct["spike_band"][1],
                        "arap": stats_arap, "nhi": stats_nhi,
                        "stvk": stat_stvk,
                        "deform": stats_deform, "inverse": stats_inv,
                        "invcheck": stat_invcheck, "cg": stat_cg,
                        "baseline": {k: st for k, (st, _) in
                                     runs_base.items()}})
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
