"""ANM continuation drivers: host sparse LU and the per-order device step.

Port of the ``host_lu`` + ``hybrid`` path of ``sanm_tpu/solver/anm.py``
(reference ``libsanm/anm.{h,cpp}``): numerical continuation of
``H(x, t) = 0`` by an order-N Taylor expansion of the solution curve
with the arc-length normalization ``x_1 . x_1 + t_1^2 = 1`` and the
per-order orthogonality ``x_k . x_1 + t_k t_1 = 0``.  Per order::

    A x_k + gt t_k + b_k = 0,      A = d(remap_out . f . remap_in)/dx

with the same A for every k.  Per restart the card computes the element
Jacobian and the CSR values (K3) and the order-0 series (K1); the host
factorizes A once (SuperLU).  Per order the card runs K2 remap_in, K1
(commit k + bias k+1) and K2 remap_out; b crosses to the host once
(``bias_pull``), is back-substituted, and the host runs the scalar
t_k / x_k recurrence.  The continuation control (restarts, Pade,
convergence) is host Python on the (N+1, n+1) coefficient matrix.

The model here is the NHC forward model of
:class:`~sanm_tpu_torch.fea.model.ElasticForceModel`; its f(x0) is
evaluated in f64 on the model's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import polynomial
from ..ops.nhc_series import NHCSeries
from ..pade import PadeApproximation
from ..utils import (
    SANMNumericalError,
    ScopedProfiler,
    sanm_assert,
    verbose_mode,
)
from .assemble import jac_asm
from .linear import host_splu


@dataclass
class HyperParam:
    """Reference ``ANMDriverHelper::HyperParam`` (``libsanm/anm.h:100-114``).

    The linear solver is host SuperLU, the one solver of this slice.
    ``fact_reuse_rel_step``: reuse the previous restart's factorization
    when the start point moved by less than this relative step (0
    disables)."""

    use_pade: bool = False
    sanity_check: bool = True
    order: int = 8
    maxr: float = 1e-6
    solution_check_tol: float = 1e-4
    xcoeff_l2_penalty: float = 0.0
    fact_reuse_rel_step: float = 0.0


@dataclass
class EqnHyperParam(HyperParam):
    """Reference ``ANMEqnSolver::HyperParam`` (``libsanm/anm.h:244-248``)."""

    converge_rms: float = 1e-5


class _ANMDriverBase:
    """Shared continuation machinery (reference ``ANMDriverHelper``)."""

    def __init__(self, model, n_unknown: int, hyper_param=None):
        self.hp = hyper_param or HyperParam()
        sanm_assert(self.hp.order >= 2, "order=%d", self.hp.order)
        self.model = model
        self.asm = model.asm
        self.n = int(n_unknown)
        sanm_assert(self.asm.n == self.n and self.asm.n_rows == self.n)
        self.max_a_bound = polynomial.stable_x_range(self.hp.order)
        self._series = NHCSeries(model.elems, self.hp.order)
        self._fact = None
        self._last_fact_reused = False

        self._iter = 0
        self.xt0 = None  # np (n+1,)
        self.xt_coeffs = None  # np (order+1, n+1)
        self._t_coeffs = None
        self._pade = None
        self._t_max = 0.0
        self._t_max_a = 0.0

    # -- subclass interface ---------------------------------------------
    def on_fx0_computed(self, fx) -> bool:
        raise NotImplementedError

    def _gt_payload(self):
        """dH/dt (VecScale: the vector v)."""
        raise NotImplementedError

    # -- device work -------------------------------------------------------
    def _eval_fx(self, xt):
        """f(x) in f64 on the model's device, as NumPy."""
        return self.model.eval_force(xt[: self.n])

    def _order_step(self, k, xt_k):
        """Commit order k and return the assembled order-(k+1) bias
        (n,) on the device: K2 remap_in, K1, K2 remap_out."""
        gin = self.asm.apply_in(xt_k)
        return self.asm.apply_out(self._series.step(k, gin))

    def _fact_reusable(self, fact, xt0_np) -> bool:
        """Whether a cached factorization from a previous restart is
        close enough to the new start point to reuse."""
        if fact is None or self.hp.fact_reuse_rel_step <= 0:
            return False
        return float(
            np.linalg.norm(xt0_np[: self.n] - fact["x0"])
        ) <= self.hp.fact_reuse_rel_step * (
            float(np.linalg.norm(fact["x0"])) + 1e-30
        )

    def _splu_factorize(self, A, pen):
        """Sparse LU returning a ``solve(b)`` closure."""
        import scipy.sparse as sp

        if pen:
            G = (A.T @ A).tocsc() + pen * sp.identity(self.n, format="csc")
            lu = host_splu(G)
            return lambda b: lu.solve(A.T @ b)
        return host_splu(A.tocsc()).solve

    def _expand(self, xt0_np, v_np):
        """Full expansion: device graph passes, host sparse solves."""
        import scipy.sparse as sp

        hp = self.hp
        n = self.n
        asm = self.asm
        pen = hp.xcoeff_l2_penalty
        reuse = self._fact_reusable(self._fact, xt0_np)
        self._last_fact_reused = reuse
        with ScopedProfiler("build_sparse_coeff", block=True):
            gin0 = asm.apply_in(xt0_np[:n])
            if not reuse:
                data, _E = jac_asm(asm, self.model.elems, gin0)
            self._series.start(gin0)
        if reuse:
            A = self._fact["A"]
            solve = self._fact["solve"]
        else:
            with ScopedProfiler("sparse_prep"):
                A = sp.csr_matrix(
                    (data.cpu().numpy(), (asm.csr_rowidx, asm.csr_cols)),
                    shape=(n, n),
                )
                del data, _E
                solve = self._splu_factorize(A, pen)
            self._fact = {"x0": xt0_np[:n].copy(), "A": A, "solve": solve}
        grad_t = v_np
        with ScopedProfiler("sparse_solve"):
            xgt = solve(grad_t)
        t1 = 1.0 / np.sqrt(xgt @ xgt + 1.0)
        x1 = -t1 * xgt
        xgt_dot_x1 = x1 @ xgt
        coeffs = np.zeros((hp.order + 1, n + 1))
        coeffs[0] = xt0_np
        coeffs[1, :n] = x1
        coeffs[1, n] = t1
        diag = []
        sanity = hp.sanity_check and not pen
        with ScopedProfiler("order_step", block=True):
            b_dev = self._order_step(1, coeffs[1])
        for k in range(2, hp.order + 1):
            with ScopedProfiler("bias_pull"):
                b = b_dev.cpu().numpy()
            with ScopedProfiler("sparse_solve"):
                xb = solve(b)
            tk = (xb @ x1) / (t1 - xgt_dot_x1)
            xk = -tk * xgt - xb
            coeffs[k, :n] = xk
            coeffs[k, n] = tk
            if sanity:
                with ScopedProfiler("eqn_check_host"):
                    resid = A @ xk + grad_t * tk + b
                    scale = max(np.linalg.norm(grad_t * tk + b), 1e-30)
                    diag.append(np.linalg.norm(resid) / scale)
            if k < hp.order:
                with ScopedProfiler("order_step", block=True):
                    b_dev = self._order_step(k, coeffs[k])
        return coeffs, np.asarray(diag)

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
                if not self._last_fact_reused:
                    raise
                # the stale-Jacobian expansion went numerically bad:
                # redo this restart with a fresh factorization
                self._fact = None
                self._expand_and_check()
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
    (reference ``ANMSolverVecScale``, ``libsanm/anm.cpp:319-443``)."""

    def __init__(self, model, x0, t0, v, hyper_param=None,
                 _defer_init=False):
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
    current point re-targets the remaining residual."""

    def __init__(self, model, x0, y, hyper_param=None):
        hp = hyper_param or EqnHyperParam()
        self._converge_rms = getattr(hp, "converge_rms", 1e-5)
        self._converged = False
        self._residual_rms = np.inf
        self.eqn_y = np.asarray(y).reshape(-1)
        super().__init__(model, x0, 0.0, None, hp, _defer_init=True)
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
        self.solve_expansion_coeffs()
        return self
