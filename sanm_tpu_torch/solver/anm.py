"""ANM continuation drivers: the host LU and the card's factor solve paths.

Port of the ``host_lu`` + ``hybrid`` path and of the ``band_chol``
device loop of ``sanm_tpu/solver/anm.py`` (reference
``libsanm/anm.{h,cpp}``): numerical continuation of ``H(x, t) = 0`` by
an order-N Taylor expansion of the solution curve with the arc-length
normalization ``x_1 . x_1 + t_1^2 = 1`` and the per-order orthogonality
``x_k . x_1 + t_k t_1 = 0``.  Per order::

    A x_k + gt t_k + b_k = 0,      A = d(remap_out . f . remap_in)/dx

with the same A for every k.  Per restart the card computes the element
Jacobian and the CSR values and the order-0 series; per order it runs K2
remap_in, the material's series step (commit k + bias k+1) and K2
remap_out.  The model supplies both material kernels (``model.jac_asm``,
``model.series``): K3 and K1 for NHC, K3n and K1n for NHI, K8a + K8c and
K8b for ARAP, K3i and K1i for the inverse model.

* ``host_lu``: the host factorizes A once (SuperLU); b crosses to the
  host once per order (``bias_pull``), is back-substituted, and the host
  runs the scalar t_k / x_k recurrence.
* ``band_chol``: the card factorizes A once (the K5 skyline band
  Cholesky, ``solver/band.py``) and per order runs the refined band solve
  (K5c, refinement and sanity residual through K4 ``element_matvec``)
  and the t_k / x_k recurrence on device tensors; b and x_k stay on the
  card, and the coefficient matrix and the sanity residuals cross to the
  host once per restart.  A factor that is not finite, or whose first
  refined solve misses the pre-gate :data:`FACTOR_GATE`, falls back to
  host LU (the latter for the rest of the solve).
* ``dense_chol`` (the K6 dense blocked Cholesky, ``solver/linear.py``)
  and ``spike_band`` (the K7 SPIKE partitioned band, ``solver/spike.py``):
  the same loop, contract and fallbacks as ``band_chol`` with another
  factor on the card (:data:`DEVICE_FACTORS`).
* ``dense``: the dense A factored by QR (Cholesky of A^T A + lambda I
  with the l2 penalty) in plain torch on A's device, as the JAX package
  calls the library there.
* ``cg``: block-Jacobi PCG on the card (K9 over K4 COO's CSR products,
  ``solver/linear.py`` :class:`~sanm_tpu_torch.solver.linear.SparseCG`),
  built once per restart, Tikhonov mode included.  It is no device
  factor: an expansion that fails its checks raises, as in the JAX
  package, and ``auto`` never takes it.

The continuation control (restarts, Pade, convergence) is host Python on
the (N+1, n+1) coefficient matrix.

The model here is an
:class:`~sanm_tpu_torch.fea.model.ElasticForceModel`, forward or inverse,
or a :class:`FunctionModel`: the function entry point of the JAX package,
``ANMEqnSolver(fn, remap_inp, remap_out, x0, y, hp, device=None)`` (and
likewise for the other two drivers), where ``fn`` is a plain torch
function of the remapped graph input whose series come from the Taylor
engine (``taylor.py``) and whose Jacobian from ``batched_jacobian``.  Its
f(x0) is evaluated in f64 on the model's device.  The inverse model's and
a function's Jacobian are not taken as symmetric (``model.symmetric``),
so ``auto`` takes host LU for them and the Cholesky solvers raise.  Two
kinds of curve
share the driver: f(x) + t v = 0 (:class:`ANMSolverVecScale`, and
:class:`ANMEqnSolver` on top of it), where dH/dt is the vector v, and
f(x, t) = f(x0, t0) (:class:`ANMImplicitSolver`), whose model reads t
and whose dH/dt is the t column that K3t assembles with A.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from .. import polynomial, resolve_device
from ..pade import PadeApproximation
from ..utils import (
    SANMError,
    SANMNumericalError,
    ScopedProfiler,
    sanm_assert,
    verbose_mode,
)
from .assemble import (DeviceAssembler, DensePlan, assemble_csr_elem,
                       element_matvec, plan_for)
from .band import BandPlan, DeviceBandCholSolver
from .linear import (DenseFactorSolver, DeviceCholSolver, HostSparseLU,
                     SparseCG)
from .remap import SparseAssembler
from .spike import DeviceSpikeBandSolver, SpikePlan

#: the linear solvers (``sanm_tpu/solver/anm.py:54-64``)
SOLVERS = ("auto", "host_lu", "band_chol", "dense", "dense_chol",
           "spike_band", "cg")
_DEVICE_SOLVERS = {"band_chol": (DeviceBandCholSolver, BandPlan),
                   "dense_chol": (DeviceCholSolver, DensePlan),
                   "spike_band": (DeviceSpikeBandSolver, SpikePlan)}
#: the solvers whose factor of -(D A D) lives on the device, refined
#: against the exact operator, with the pre-gate and the fallback to host
#: LU (``anm.py:423-480``)
DEVICE_FACTORS = tuple(_DEVICE_SOLVERS)
#: the kinds of fallback from a device factor to host LU
FALLBACKS = ("gate", "checks", "not_finite")
#: factor-quality pre-gate: the first refined device solve's relative
#: residual must reach this, or the solve falls back to host LU
#: (``anm.py:712-740``)
FACTOR_GATE = 1e-8


@dataclass
class HyperParam:
    """Reference ``ANMDriverHelper::HyperParam`` (``libsanm/anm.h:100-114``).

    ``solver``: ``"host_lu"`` (host SuperLU), ``"band_chol"`` (the card's
    skyline band Cholesky), ``"dense_chol"`` (the card's dense blocked
    Cholesky), ``"spike_band"`` (the card's SPIKE partitioned band),
    ``"dense"`` (dense QR in plain torch), ``"cg"`` (block-Jacobi PCG on
    the card) or ``"auto"``: ``band_chol`` on the card when its factor and
    working band fit in half of the card's free memory, else ``host_lu``
    (see ``_band_auto_ok``); ``auto`` never takes the other four.
    ``fact_reuse_rel_step``: reuse the previous restart's factorization
    when the start point moved by less than this relative step (0
    disables)."""

    use_pade: bool = False
    sanity_check: bool = True
    order: int = 8
    maxr: float = 1e-6
    solution_check_tol: float = 1e-4
    xcoeff_l2_penalty: float = 0.0
    solver: str = "auto"
    fact_reuse_rel_step: float = 0.0


@dataclass
class EqnHyperParam(HyperParam):
    """Reference ``ANMEqnSolver::HyperParam`` (``libsanm/anm.h:244-248``)."""

    converge_rms: float = 1e-5


class EngineSeries:
    """The Taylor engine of a traced function behind the series interface
    of the material kernels (``NHCSeries``): ``start(gin0)`` runs order 0
    and checks that the order-1 bias is structurally zero;
    ``step(k, gin_k)`` commits order k and returns the order-(k+1) bias
    (B, odim)."""

    def __init__(self, tfn, in_shape, B, odim):
        self.engine = tfn.engine()
        self.in_shape = in_shape
        self.out_2d = (B, odim)

    def start(self, gin0):
        self.engine.start(gin0.reshape(self.in_shape))
        if self.engine.order_bias() is not None:
            raise SANMError("order-1 bias must be structurally zero")

    def step(self, k: int, gin_k):
        self.engine.push(gin_k.reshape(self.in_shape))
        b = self.engine.order_bias()
        if b is None:
            return torch.zeros(self.out_2d, dtype=torch.float64,
                               device=gin_k.device)
        return b.reshape(self.out_2d).contiguous()


class FunctionModel:
    """A driver's model for a plain torch function ``fn`` of the graph
    input: H(x) = remap_out(fn(remap_inp(x))), as the JAX drivers take it
    (``sanm_tpu/solver/anm.py:107``).

    The remaps' plan is ``SparseAssembler(remap_out, remap_inp, B, odim,
    idim, n)`` with B the first axis of ``remap_inp``'s output shape;
    ``fn`` must be elementwise over that axis (its Jacobian is assembled
    per batch element).  The series come from the Taylor engine of ``fn``
    traced once (``taylor.TaylorFn``); the Jacobian from
    ``taylor.batched_jacobian``, then E = Lout J Lin and the CSR values as
    ``assemble_csr_elem``.  The Jacobian is not taken as symmetric, so
    ``auto`` takes host LU.  Runs on ``device`` (default: the card; see
    :func:`sanm_tpu_torch.resolve_device`)."""

    symmetric = False

    def __init__(self, fn, remap_inp, remap_out, n_unknown: int,
                 device=None):
        from ..taylor import TaylorFn

        dev = resolve_device(device)
        self.fn = fn
        self.n_input = int(remap_inp.inp_size)
        self.in_shape = tuple(remap_inp.out_shape)
        B = self.in_shape[0]
        plan = SparseAssembler(remap_out, remap_inp, B,
                               remap_out.inp_size // B,
                               remap_inp.n_out // B, n_unknown)
        self.asm = DeviceAssembler.from_plan(plan, dev)
        self.tfn = TaylorFn(fn, torch.zeros(self.in_shape,
                                            dtype=torch.float64, device=dev))
        if self.tfn.multi:
            raise SANMError("the ANM drivers take a function of one output")

    @property
    def device(self):
        return self.asm.device

    def series(self, order: int):
        return EngineSeries(self.tfn, self.in_shape, self.asm.B,
                            self.asm.odim)

    def jac_asm(self, gin0):
        """``(data, grad_t, E)`` at the graph input ``gin0`` (B, idim)."""
        from ..taylor import batched_jacobian

        J = batched_jacobian(self.fn, gin0.reshape(self.in_shape))
        return assemble_csr_elem(self.asm, J.contiguous())

    def eval_force(self, x):
        """H(x) (n,) at the unknown vector x ((n + 1,) with t for the
        implicit solver), evaluated in f64 on the model's device; returned
        as NumPy."""
        gin = self.asm.apply_in(np.asarray(x).reshape(-1))
        out = self.fn(gin.reshape(self.in_shape))
        return self.asm.apply_out(
            out.reshape(self.asm.B, self.asm.odim).contiguous()
        ).cpu().numpy()


def _driver_args(args, device):
    """``(model, rest)`` from a driver's positional arguments: ``(model,
    x0, ...)`` with a model (``asm`` and the rest of the interface above),
    or the JAX package's ``(fn, remap_inp, remap_out, x0, ...)``, which
    makes a :class:`FunctionModel` on ``device``."""
    if args and hasattr(args[0], "asm"):
        if device is not None:
            raise SANMError("device= belongs to the function form; a model "
                            "lives on its own device")
        return args[0], args[1:]
    if len(args) < 4:
        raise SANMError("expected (model, x0, ...) or (fn, remap_inp, "
                        "remap_out, x0, ...)")
    fn, remap_inp, remap_out, x0 = args[:4]
    model = FunctionModel(fn, remap_inp, remap_out, np.asarray(x0).size,
                          device)
    return model, args[3:]


def _hyper_param(more, hyper_param):
    """The hyper parameters, given after the other positional arguments or
    by keyword."""
    sanm_assert(len(more) <= 1 and not (more and hyper_param is not None),
                "too many arguments")
    return more[0] if more else hyper_param


def resolved_solver(expansions):
    """The solver that ran the counted ``expansions`` ({solver: count}):
    a device factor's name or ``host_lu``, ``mixed`` when both did (after
    a fallback), None before the first."""
    ran = [m for m, c in expansions.items() if c]
    return ran[0] if len(ran) == 1 else ("mixed" if ran else None)


class _ANMDriverBase:
    """Shared continuation machinery (reference ``ANMDriverHelper``)."""

    def __init__(self, model, n_unknown: int, hyper_param=None):
        self.hp = hyper_param or HyperParam()
        sanm_assert(self.hp.order >= 2, "order=%d", self.hp.order)
        sanm_assert(self.hp.solver in SOLVERS, "unknown solver %r",
                    self.hp.solver)
        if self.hp.solver in DEVICE_FACTORS and not model.symmetric:
            raise SANMError(
                "solver %s factors -(D A D) by Cholesky, which needs a "
                "symmetric Jacobian A; this model's (the inverse model's) "
                "is not symmetric: use host_lu or auto" % self.hp.solver)
        self.model = model
        self.asm = model.asm
        self.n = int(n_unknown)
        sanm_assert(self.asm.n == self.n and self.asm.n_rows == self.n)
        self.max_a_bound = polynomial.stable_x_range(self.hp.order)
        self._series = model.series(self.hp.order)
        self._fact = None
        self._last_fact_reused = False
        # device-factor state: the host plans (topology-static), the auto
        # decision, the sticky host-LU override, the device factor's
        # fallbacks to host LU (a missed pre-gate, an expansion that failed
        # its checks, a factor that is not finite) and the expansions each
        # solver ran, over the solver's life
        self._band_plan = None
        self._band_auto = None
        self._solver_override = None
        self._last_mode = None
        # (restart, kind) of each fallback, kind one of FALLBACKS;
        # restarts count over the solver's life, 1-based
        self.band_fallback_log = []
        # the expansions of the configured solver (auto and host_lu: of
        # band_chol, as before the other solvers were ported) and of host LU
        first = (self.hp.solver if self.hp.solver not in ("auto", "host_lu")
                 else "band_chol")
        self.expansions = {first: 0, "host_lu": 0}

        self._iter = 0
        self.xt0 = None  # np (n+1,)
        self.xt_coeffs = None  # np (order+1, n+1)
        self._t_coeffs = None
        self._pade = None
        self._t_max = 0.0
        self._t_max_a = 0.0

    #: whether the remap's input carries t (its last entry) and the
    #: assembled t column is dH/dt (:class:`ANMImplicitSolver`)
    is_implicit = False

    # -- subclass interface ---------------------------------------------
    def prepare_inp(self, xt):
        """Strip or keep the trailing t before remap_in (reference
        ``prepare_inp``, ``libsanm/anm.h:173``)."""
        return xt[: self.n]

    def on_fx0_computed(self, fx) -> bool:
        raise NotImplementedError

    def _gt_payload(self):
        """dH/dt (VecScale: the vector v; implicit: None, the assembled t
        column takes its place)."""
        raise NotImplementedError

    # -- device work -------------------------------------------------------
    def _eval_fx(self, xt):
        """f(x) (implicit: f(x, t)) in f64 on the model's device, as
        NumPy."""
        return self.model.eval_force(self.prepare_inp(xt))

    def _order_step(self, k, xt_k):
        """Commit order k and return the assembled order-(k+1) bias
        (n,) on the device: K2 remap_in, the series step, K2 remap_out."""
        gin = self.asm.apply_in(xt_k)
        return self.asm.apply_out(self._series.step(k, gin))

    def _ncmp(self):
        """The entries of the start point the factor depends on: x, and t
        for the implicit solver, whose A and grad_t depend on t."""
        return self.n + 1 if self.is_implicit else self.n

    def _fact_reusable(self, fact, xt0_np) -> bool:
        """Whether a cached factorization from a previous restart is
        close enough to the new start point to reuse."""
        if fact is None or self.hp.fact_reuse_rel_step <= 0:
            return False
        return float(
            np.linalg.norm(xt0_np[: self._ncmp()] - fact["x0"])
        ) <= self.hp.fact_reuse_rel_step * (
            float(np.linalg.norm(fact["x0"])) + 1e-30
        )

    # -- linear solver dispatch (anm.py:1168-1275) -----------------------
    def _solver_mode(self):
        """The solver of the next expansion: the sticky host-LU override
        after a failed band factor, else ``hp.solver`` with ``auto``
        resolved."""
        if self._solver_override is not None:
            return self._solver_override
        mode = self.hp.solver
        if mode == "auto":
            mode = "band_chol" if self._band_auto_ok() else "host_lu"
        return mode

    @property
    def _factor_gate_fails(self):
        """Device factors that missed the pre-gate or whose expansion
        failed its checks (the JAX package's count over every device mode;
        each sets the override)."""
        return self.band_fallbacks["gate"] + self.band_fallbacks["checks"]

    def solver_resolved(self):
        """The solver that ran the expansions so far (see
        :func:`resolved_solver`)."""
        return resolved_solver(self.expansions)

    def _band_auto_ok(self):
        """Whether ``auto`` takes ``band_chol``: on the card only (the CPU
        keeps host LU), for a model whose Jacobian is symmetric (not the
        inverse model's: the band factor is a Cholesky), without the l2
        penalty (band_chol refuses Tikhonov mode), before a second failed
        pre-gate, and when the plan's factor plus working band fit in half
        of the card's free memory.  The JAX package's TPU threshold on the factor FLOPs is
        not ported; on the H100 the band path wins on armadillo-small
        (PERF.md)."""
        if (self.asm.device.type != "cuda" or not self.model.symmetric
                or self.hp.xcoeff_l2_penalty
                or self._factor_gate_fails >= 2):
            return False
        if self._band_auto is None:
            plan = self.band_plan()
            free, _ = torch.cuda.mem_get_info(self.asm.device)
            self._band_auto = (
                plan.mem_bytes() + plan.work_mem_bytes() <= free / 2)
        return self._band_auto

    def _count_fallback(self, kind):
        self.band_fallback_log.append((self._iter + 1, kind))

    @property
    def band_fallbacks(self):
        """The device factor's fallbacks to host LU by kind: a missed
        pre-gate, an expansion that failed its checks, a factor that is
        not finite."""
        out = dict.fromkeys(FALLBACKS, 0)
        for _, kind in self.band_fallback_log:
            out[kind] += 1
        return out

    def band_plan(self) -> BandPlan:
        """The band solver's host plan (the sparsity is topology-static,
        so solvers of one pattern share it, :func:`~sanm_tpu_torch.solver.
        assemble.plan_for`)."""
        if self._band_plan is None:
            self._band_plan = plan_for(BandPlan, self.asm.csr_rowidx,
                                       self.asm.csr_cols, self.n)
        return self._band_plan

    def _factorize(self, mode, data, E):
        """The solver of one expansion from the CSR values ``data`` and
        the element stiffness ``E``: a device factor (None when it is not
        finite), the dense QR, the PCG solver or host SuperLU
        (``anm.py:1245-1275``)."""
        asm = self.asm
        if mode in DEVICE_FACTORS:
            cls, plan_cls = _DEVICE_SOLVERS[mode]
            solver = cls(plan_for(plan_cls, asm.csr_rowidx, asm.csr_cols,
                                  self.n),
                         data, partial(element_matvec, asm, E))
            return solver if solver.factor_ok() else None
        if mode == "dense":
            A = torch.zeros((self.n, self.n), dtype=torch.float64,
                            device=data.device)
            A[torch.as_tensor(asm.csr_rowidx, dtype=torch.long),
              torch.as_tensor(asm.csr_cols, dtype=torch.long)] = data
            return DenseFactorSolver(A, self.hp.xcoeff_l2_penalty)
        if mode == "cg":
            return SparseCG(asm.csr_maps, data,
                            l2_penalty=self.hp.xcoeff_l2_penalty)
        import scipy.sparse as sp

        A = sp.csr_matrix((data.cpu().numpy(),
                           (asm.csr_rowidx, asm.csr_cols)),
                          shape=(self.n, self.n))
        return HostSparseLU(A, self.hp.xcoeff_l2_penalty)

    def _expand(self, xt0_np, v_np, mode=None):
        """Full expansion (``anm.py:423-537,670-750``): the device graph
        passes, the linear solves (on the card for the device factors, on
        the host for host_lu), the t_k / x_k recurrence and the sanity
        residuals on device tensors.  Returns ``(coeffs, diag)`` as NumPy.
        A device factor that is not finite hands this restart to host LU;
        one whose first refined solve misses the pre-gate hands it the
        rest of the solve.  With the l2 penalty the device factors (which
        refuse Tikhonov mode) leave the solve to host LU, as in the JAX
        package; ``dense`` and ``cg`` keep it."""
        hp = self.hp
        n = self.n
        asm = self.asm
        pen = hp.xcoeff_l2_penalty
        if mode is None:
            mode = self._solver_mode()
            if pen and mode in DEVICE_FACTORS:
                mode = "host_lu"
        self._last_mode = mode
        fact = self._fact
        if fact is not None and fact["mode"] != mode:
            fact = None
        reuse = self._fact_reusable(fact, xt0_np)
        self._last_fact_reused = reuse
        with ScopedProfiler("build_sparse_coeff", block=True):
            gin0 = asm.apply_in(self.prepare_inp(xt0_np))
            if not reuse:
                data, gt_asm, E = self.model.jac_asm(gin0)
            self._series.start(gin0)
        if reuse:
            solver, gt_asm = fact["solver"], fact["gt"]
        else:
            # free the old factor before the new one (the local reference
            # too: a dense factor is 11.6 GB at armadillo-small)
            fact = self._fact = None
            with ScopedProfiler("sparse_prep", block=True):
                solver = self._factorize(mode, data, E)
                del data, E
            if solver is None:
                self._count_fallback("not_finite")
                if verbose_mode():
                    print("%s: indefinite stiffness; host-LU fallback"
                          % mode)
                return self._expand(xt0_np, v_np, "host_lu")
            self._fact = {"mode": mode, "x0": xt0_np[: self._ncmp()].copy(),
                          "solver": solver, "gt": gt_asm}
        if self.is_implicit:
            grad_t = gt_asm
        else:
            grad_t = torch.as_tensor(v_np, dtype=torch.float64).to(
                asm.device)
        if mode in DEVICE_FACTORS:
            xgt, gate = solver.solve(grad_t, with_resid=True)
            gate = float(gate)
            if not gate <= FACTOR_GATE:
                # the first refined solve doubles as the factor-quality
                # pre-gate: host LU for the rest of this solve (cleared
                # by reset); auto stops taking band_chol after two strikes
                # (of any device factor)
                self._count_fallback("gate")
                self._solver_override = "host_lu"
                fact = self._fact = solver = None
                if verbose_mode():
                    print("%s factor pre-gate failed (resid %g > %g); "
                          "host-LU fallback" % (mode, gate, FACTOR_GATE))
                return self._expand(xt0_np, v_np)
        else:
            xgt = solver.solve(grad_t)
        self.expansions[mode] += 1
        t1 = 1.0 / torch.sqrt(xgt @ xgt + 1.0)
        x1 = -t1 * xgt
        denom = t1 - x1 @ xgt
        XT = torch.zeros((hp.order + 1, n + 1), dtype=torch.float64,
                         device=asm.device)
        XT[0] = torch.as_tensor(xt0_np, dtype=torch.float64)
        XT[1, :n] = x1
        XT[1, n] = t1
        sanity = hp.sanity_check and not pen
        diag = torch.zeros(hp.order + 1, dtype=torch.float64,
                           device=asm.device)
        with ScopedProfiler("order_step", block=True):
            b = self._order_step(1, XT[1])
        for k in range(2, hp.order + 1):
            xb = solver.solve(b)
            tk = (xb @ x1) / denom
            xk = -tk * xgt - xb
            XT[k, :n] = xk
            XT[k, n] = tk
            if sanity:
                rhs = grad_t * tk + b
                resid = solver.apply(xk) + rhs
                diag[k] = torch.linalg.vector_norm(resid) / torch.clamp(
                    torch.linalg.vector_norm(rhs), min=1e-30)
            if k < hp.order:
                with ScopedProfiler("order_step", block=True):
                    b = self._order_step(k, XT[k])
        dg = diag[2:].cpu().numpy() if sanity else np.zeros(0)
        return XT.cpu().numpy(), dg

    # -- host control -----------------------------------------------------
    def init_xt0(self, x, t):
        x = np.asarray(x).reshape(-1)
        sanm_assert(x.size == self.n)
        self.xt0 = np.concatenate([x, [float(t)]])

    def solve_expansion_coeffs(self):
        with ScopedProfiler("solve_expansion_coeffs", block=True):
            with ScopedProfiler("eval_fx0"):
                fx = self._eval_fx(self.xt0)
            if not self.on_fx0_computed(np.asarray(fx)):
                self.xt_coeffs = self.xt0[None, :]
                return
            try:
                self._expand_and_check()
            except SANMNumericalError:
                if self._last_fact_reused:
                    # the stale-Jacobian expansion went numerically bad:
                    # redo this restart with a fresh factorization
                    self._fact = None
                    self._expand_and_check()
                elif self._last_mode in DEVICE_FACTORS:
                    # the device expansion passed the pre-gate but failed
                    # the order checks: the factor can be the weak link;
                    # host LU for the rest of this solve (anm.py:1320-1350)
                    if verbose_mode():
                        print("%s expansion failed checks; host-LU "
                              "fallback" % self._last_mode)
                    self._solver_override = "host_lu"
                    self._count_fallback("checks")
                    self._fact = None
                    self._expand_and_check()
                else:
                    raise
        self._iter += 1
        if verbose_mode():
            print(
                "ANM iter %d: bound=%g t_max=%g |x_k|=%s"
                % (self._iter, self._t_max_a, self._t_max,
                   [float(np.linalg.norm(c)) for c in self.xt_coeffs])
            )

    def _expand_and_check(self):
        hp = self.hp
        coeffs, diag = self._expand(self.xt0, self._gt_payload())
        if not np.isfinite(coeffs).all():
            raise SANMNumericalError("non-finite expansion coefficients")
        if hp.sanity_check and diag.size:
            worst = float(diag.max())
            if not np.isfinite(worst) or worst > 1e-4:
                raise SANMNumericalError(
                    "ANM coefficient equation check failed: rel err %g"
                    % worst
                )
            # orthogonality checks (anm.cpp:279-284); relative to the
            # coefficient magnitudes since high-order terms can be huge
            d = coeffs[1:] @ coeffs[1]
            if abs(d[0] - 1) > 1e-4:
                raise SANMNumericalError("|x1|^2+t1^2 != 1: %g" % d[0])
            scales = np.linalg.norm(coeffs[2:], axis=1) * np.linalg.norm(
                coeffs[1]
            ) + 1e-30
            if len(d) > 1 and (np.abs(d[1:]) / scales).max() > 1e-4:
                raise SANMNumericalError(
                    "orthogonality violated: %g"
                    % (np.abs(d[1:]) / scales).max()
                )
        self.xt_coeffs = self._truncate_noise_tail(coeffs)
        self._estimate_valid_range()

    def _truncate_noise_tail(self, coeffs):
        """Adaptive effective order: drop trailing coefficients that are
        amplified numerical noise (a V-shaped |x_k| tail: decay to a
        noise floor, then geometric regrowth).  Truncating at the
        V-bottom keeps the informative orders; the error-correcting
        restarts absorb the truncation error."""
        norms = np.linalg.norm(coeffs, axis=1)
        self._tail_truncated = False
        if len(norms) < 7:
            return coeffs
        kmin = int(np.argmin(norms[1:])) + 1
        # threshold 100: genuine series plateau/oscillate within ~10x of
        # their envelope; a 100x regrowth is amplified noise
        if kmin >= 5 and kmin < len(norms) - 1 and (
            norms[-1] > norms[kmin] * 100.0
        ):
            if verbose_mode():
                print(
                    "ANM: truncating noise tail at order %d "
                    "(|x_%d|=%.2g, |x_N|=%.2g)"
                    % (kmin, kmin, norms[kmin], norms[-1])
                )
            self._tail_truncated = True
            return coeffs[: kmin + 1]
        return coeffs

    def _estimate_valid_range(self):
        """Reference ``estimate_valid_range`` (``libsanm/anm.cpp:117-154``):
        a_max = (maxr * |x_1| / |x_N|)^(1/(N-1)), optionally extended by
        the Pade approximant.  Uses the effective order."""
        coeffs = self.xt_coeffs
        n_eff = len(coeffs) - 1
        max_a_bound = (
            self.max_a_bound
            if n_eff == self.hp.order
            else polynomial.stable_x_range(n_eff)
        )
        x1n = float(np.linalg.norm(coeffs[1]))
        xback = max(float(np.linalg.norm(coeffs[-1])), 1e-15)
        a_bound = (self.hp.maxr / xback * x1n) ** (1.0 / (n_eff - 1))
        a_bound = min(a_bound, max_a_bound)
        self._t_coeffs = coeffs[:, -1].copy()
        if not self._t_coeffs[1] > 0:
            raise SANMNumericalError(
                "t does not increase: t1=%g" % self._t_coeffs[1]
            )
        self._t_max_a = a_bound
        self._t_max = polynomial.eval_poly(self._t_coeffs, a_bound)
        if self._t_max <= self._t_coeffs[0]:
            raise SANMNumericalError(
                "t does not increase at iter %d: t0=%g tmax=%g bound=%g"
                % (self._iter, self._t_coeffs[0], self._t_max, a_bound)
            )

        self._pade = None
        use_pade = self.hp.use_pade
        if use_pade and a_bound < max_a_bound:
            with ScopedProfiler("pade_build"):
                pade = PadeApproximation(
                    self.xt_coeffs,
                    anm_cond=not self.hp.xcoeff_l2_penalty,
                )
            with ScopedProfiler("pade_est"):
                ok = pade.ok and pade.estimate_valid_range(
                    a_bound, self.hp.maxr, max_a_bound
                )
            if ok:
                self._pade = pade
                self._t_max_a = pade.t_max_a
                self._t_max = pade.t_max
            self._log_pade(a_bound, ok, pade)
        elif use_pade:
            self._log_pade(a_bound, False, None)

    def _log_pade(self, a_bound, accepted, pade):
        """Per-restart Pade acceptance record: why each step's extension
        was accepted or rejected and by how much it gained."""
        rec = {
            "iter": self._iter + 1,
            "a_series": float(a_bound),
            "accepted": bool(accepted),
        }
        if accepted:
            rec["a_pade"] = float(pade.t_max_a)
            rec["gain"] = float(pade.t_max_a / a_bound)
        elif pade is not None:
            rec["reject"] = pade.reject_reason or "range estimation"
        else:
            rec["reject"] = "series bound hit stable_x_range"
        self.pade_log = getattr(self, "pade_log", [])
        self.pade_log.append(rec)
        if verbose_mode():
            print("pade:", rec)

    # -- public API (reference ANMDriverHelper public section) -----------
    def get_t_upper(self):
        return self._t_max

    def get_t_max_a(self):
        return self._t_max_a

    def get_t0(self):
        return float(self._t_coeffs[0])

    def get_nr_iter(self):
        return self._iter

    def eval_xt(self, a):
        if self._pade is not None:
            return self._pade.eval_xt(a)
        return polynomial.eval_tensor_poly(self.xt_coeffs, a)

    def eval(self, a):
        xt = self.eval_xt(a)
        return xt[: self.n], float(xt[self.n])

    def solve_a(self, t):
        """Find a such that t(a) = t (reference ``anm.cpp:174-191``)."""
        if t == self._t_max:
            return self._t_max_a
        if self._pade is not None:
            return self._pade.solve_a(t)
        sanm_assert(t >= self._t_coeffs[0] and t < self._t_max)
        lo, hi = (0.0, self._t_max_a) if self._t_max_a > 0 else (
            -self._t_max_a,
            0.0,
        )
        return polynomial.solve_eqn(self._t_coeffs, lo, hi, t)

    def update_approx(self):
        """Move the start point to the end of the validated range and
        re-expand (reference ``anm.cpp:156-159``)."""
        with ScopedProfiler("eval_xt"):
            self.xt0 = np.asarray(self.eval_xt(self._t_max_a))
        self.solve_expansion_coeffs()


class ANMSolverVecScale(_ANMDriverBase):
    """Solve f(x) + t*v = 0 for the curve x(t)
    (reference ``ANMSolverVecScale``, ``libsanm/anm.cpp:319-443``):
    ``ANMSolverVecScale(model, x0, t0, v, hyper_param=None)`` or
    ``ANMSolverVecScale(fn, remap_inp, remap_out, x0, t0, v,
    hyper_param=None, device=None)``."""

    def __init__(self, *args, hyper_param=None, device=None,
                 _defer_init=False):
        model, (x0, t0, v, *more) = _driver_args(args, device)
        hyper_param = _hyper_param(more, hyper_param)
        x0 = np.asarray(x0).reshape(-1)
        super().__init__(model, x0.size, hyper_param)
        self.v = None if v is None else np.asarray(v).reshape(-1)
        if self.v is not None:
            sanm_assert(self.v.size == self.n)
        self.init_xt0(x0, t0)
        if not _defer_init:
            self.solve_expansion_coeffs()

    def _gt_payload(self):
        return self.v

    def on_fx0_computed(self, fx) -> bool:
        self._check_t0v_match(fx)
        return True

    def _check_t0v_match(self, fx):
        """f(x0) + t0*v = 0 must hold at the start point
        (reference ``check_t0v_match``, ``libsanm/anm.cpp:343-360``)."""
        t0 = float(self.xt0[self.n])
        a = fx.reshape(-1)
        b = self.v * t0
        maxerr = (
            np.maximum(np.minimum(np.abs(a), np.abs(b)), 1.0)
            * self.hp.solution_check_tol
        )
        bad = np.abs(a + b) > maxerr
        if bad.any():
            i = int(np.argmax(np.abs(a + b)))
            raise SANMNumericalError(
                "f(x0)+t0*v is not zero: lhs=%g rhs=%g idx=%d iter=%d"
                % (a[i], b[i], i, self._iter)
            )


class ANMEqnSolver(ANMSolverVecScale):
    """Solve f(x) + y = 0 with error-correcting restarts
    (reference ``ANMEqnSolver``, ``libsanm/anm.cpp:445-491``).

    Each restart expands the homotopy f(x) + t*(f(x0)+y) = f(x0) from
    t=0; reaching t=1 solves the equation, and restarting from the
    current point re-targets the remaining residual.
    ``ANMEqnSolver(model, x0, y, hyper_param=None)`` or
    ``ANMEqnSolver(fn, remap_inp, remap_out, x0, y, hyper_param=None,
    device=None)``."""

    def __init__(self, *args, hyper_param=None, device=None):
        model, (x0, y, *more) = _driver_args(args, device)
        hp = _hyper_param(more, hyper_param) or EqnHyperParam()
        self._converge_rms = getattr(hp, "converge_rms", 1e-5)
        self._converged = False
        self._residual_rms = np.inf
        self.eqn_y = np.asarray(y).reshape(-1)
        super().__init__(model, x0, 0.0, None, hyper_param=hp,
                         _defer_init=True)
        sanm_assert(self.eqn_y.size == self.n)
        self._x0_init = np.asarray(x0).reshape(-1).copy()
        self.solve_expansion_coeffs()

    def on_fx0_computed(self, fx) -> bool:
        if self._converged:
            return False
        self.v = fx.reshape(-1) + self.eqn_y
        self._residual_rms = float(np.sqrt(np.mean(self.v * self.v)))
        if self._residual_rms < self._converge_rms:
            self._converged = True
            return False
        return True

    def next_iter(self):
        """Reference ``ANMEqnSolver::next_iter`` (``anm.cpp:464-478``),
        plus the residual backoff of the JAX package: after a series
        whose noise tail was truncated, halve ``a`` until the candidate's
        residual does not regress by more than 1.5x (at most 6 probes,
        each one f64 forward evaluation on the device)."""
        if self._converged:
            return self
        a = self.solve_a(1.0) if self.get_t_upper() >= 1.0 else (
            self.get_t_max_a()
        )
        prev_rms = self._residual_rms
        cand = np.asarray(self.eval_xt(a))
        if getattr(self, "_tail_truncated", False):
            for _ in range(6):
                v = self._eval_fx(cand).reshape(-1) + self.eqn_y
                rms = float(np.sqrt(np.mean(v * v)))
                if np.isfinite(rms) and rms <= prev_rms * 1.5:
                    break
                a *= 0.5
                if verbose_mode():
                    print("ANM backoff: rms %g > 1.5x prev %g; a -> %g"
                          % (rms, prev_rms, a))
                cand = np.asarray(self.eval_xt(a))
        self.xt0 = cand
        self.xt0[self.n] = 0.0  # reset t0
        self.solve_expansion_coeffs()
        return self

    def residual_rms(self):
        return self._residual_rms

    def converged(self):
        return self._converged

    def get_x(self):
        return self.xt0[: self.n]

    def reset(self, x0=None):
        """Restart the homotopy from ``x0`` (default: the original start
        point), reusing the device state and host assembler: the warm
        path of a long-lived solver.  Runs the first expansion."""
        if x0 is None:
            x0 = self._x0_init
        self.xt0 = np.concatenate([np.asarray(x0).reshape(-1), [0.0]])
        self._converged = False
        self._residual_rms = np.inf
        self._pade = None
        self._t_max = 0.0
        self._t_max_a = 0.0
        self._solver_override = None
        self.solve_expansion_coeffs()
        return self


class ANMImplicitSolver(_ANMDriverBase):
    """Solve f(x, t) = f(x0, t0) for the curve x(t), t increasing from
    t0 (reference ``ANMImplicitSolver``, ``libsanm/anm.cpp:493-615``;
    ``sanm_tpu/solver/anm.py:1754-1793``).  The model's remap reads t as
    its last input (a model made with a ``vtx_delta``, or a function whose
    ``remap_inp`` reads the entry n); the assembled t column (K3t) is
    dH/dt.  ``ANMImplicitSolver(model, x0, t0, hyper_param=None)`` or
    ``ANMImplicitSolver(fn, remap_inp, remap_out, x0, t0,
    hyper_param=None, device=None)``."""

    is_implicit = True

    def __init__(self, *args, hyper_param=None, device=None):
        model, (x0, t0, *more) = _driver_args(args, device)
        hyper_param = _hyper_param(more, hyper_param)
        x0 = np.asarray(x0).reshape(-1)
        super().__init__(model, x0.size, hyper_param)
        sanm_assert(model.n_input == self.n + 1,
                    "the implicit solver needs a model with a t column")
        self._fx0 = None
        self.init_xt0(x0, t0)
        self.solve_expansion_coeffs()

    def prepare_inp(self, xt):
        return xt

    def _gt_payload(self):
        return None

    def on_fx0_computed(self, fx) -> bool:
        """f(x, t) must stay f(x0, t0) along the curve, to
        ``solution_check_tol`` relative."""
        if self._fx0 is None:
            self._fx0 = fx.copy()
        else:
            scale = np.maximum(
                np.maximum(np.abs(self._fx0), np.abs(fx)), 1.0)
            err = float(np.max(np.abs(self._fx0 - fx) / scale))
            if err > self.hp.solution_check_tol:
                raise SANMNumericalError(
                    "check f(x0,t0)=f(x,t) failed: rel err %g" % err)
        return True

    def fx0(self):
        return self._fx0
