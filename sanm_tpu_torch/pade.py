"""Pade approximant extension of the ANM power series.

Counterpart of reference ``libsanm/pade.{h,cpp}``: the order-N Taylor
series of ``[x(a); t(a)]`` is upgraded to the rational (Pade-like) form
used in ANM literature (Cochelin & Najah)::

    x(a) = x_0 + a * sum_{i=1..n-1} x_i a^{i-1} D_{n-i}(a) / D_n(a)

where ``D_m(a) = sum_{j<m} d_j a^j`` and the ``d_j`` come from a
Gram-Schmidt orthonormalization of the coefficient vectors.  The
approximant usually stays accurate well beyond the series radius,
cutting continuation iterations (the reference measures "Pade benefit"
as iterations saved, ``render/gen_table_figs.py:341-359``).

This runs on the host in NumPy: the inputs are the (N+1, n+1)
coefficient matrix already pulled from the device once per continuation
step, and all subsequent work is O(N^2 n).
"""

from __future__ import annotations

import numpy as np

from . import polynomial
from .utils import SANMError, sanm_assert


class PadeApproximation:
    """Build from stacked coefficients ``xs`` with shape (N+1, dim)
    (last component of dim is t, as in the ANM drivers).

    ``anm_cond``: the coefficient vectors from an un-regularized ANM
    expansion satisfy x_i . x_1 = 0 for i >= 2, which is exploited for
    stability (reference ``pade.cpp:36-40``)."""

    def __init__(self, xs, anm_cond=True, sanity_check=False):
        xs = np.asarray(xs, dtype=np.float64)
        self.xs = xs
        self.ok = False
        self._d = None
        self.reject_reason = None  # diagnostics for the Pade-benefit study
        n = xs.shape[0] - 1
        dim = xs.shape[1]
        # rejection rules mirror pade.cpp:18: need enough dimensions and
        # a high-enough order for the rational form to be meaningful
        if dim < 2 * (n + 1) or n + 1 <= 4:
            self.reject_reason = "dim/order rule"
            return

        # Gram-Schmidt orthonormalization of xs[1..n]
        a = np.zeros((n + 1, n + 1))
        orth = np.zeros((n, dim))  # orth[i-1] = orthonormalized xs[i]
        eps = np.finfo(np.float64).eps
        for i in range(1, n + 1):
            u = xs[i].copy()
            for j in range(1, i):
                aij = float(xs[i] @ orth[j - 1])
                if anm_cond and j == 1:
                    # exact ANM orthogonality: x_i . x_1 = 0 for i >= 2
                    if abs(aij) >= 1e-4:
                        self.reject_reason = "anm orthogonality %g" % aij
                        return  # not an ANM series; refuse
                    a[i, j] = 0.0
                else:
                    a[i, j] = aij
                    u -= aij * orth[j - 1]
            norm = float(np.linalg.norm(u))
            if norm == 0.0:
                self.reject_reason = "zero-norm coefficient"
                return
            a[i, i] = norm
            u = u / max(norm, eps)
            if norm < eps:
                u = u / np.linalg.norm(u)
            orth[i - 1] = u

        def solve_d(nn):
            d = np.zeros(nn)
            d[0] = 1.0
            for i in range(1, nn):
                s = 0.0
                for j in range(i):
                    s += a[nn - j, nn - i] * d[j]
                y = a[nn - i, nn - i]
                d[i] = -s * y / (y * y + 1e-20)
            return d

        self._d = solve_d(n)
        self._d_lo = solve_d(n - 1)
        self._n = n

        # numerator coefficients for t(a) - t0
        self._t0 = float(xs[0, -1])
        tn = np.zeros(n)
        for i in range(1, n):
            ti = float(xs[i, -1])
            for j in range(n - i):
                tn[i + j] += self._d[j] * ti
        self._t_nume = tn
        self.ok = True
        self.t_max_a = 0.0
        self.t_max = 0.0

        if sanity_check:
            for i in range(1, n + 1):
                rec = sum(a[i, j] * orth[j - 1] for j in range(1, i + 1))
                if not np.allclose(rec, xs[i], rtol=1e-6, atol=1e-9):
                    raise SANMError("pade orthogonalization check failed")

    # ------------------------------------------------------------------
    def estimate_valid_range(self, start, eps, limit=0.0) -> bool:
        """Find the largest ``a`` at which the order-n and order-(n-1)
        approximants agree to relative ``eps``; reject if no gain over
        ``start`` (reference ``pade.cpp:107-173``)."""
        sanm_assert(start > 0 and eps > 0)
        if not self.ok:
            return False
        rts = polynomial.roots(self._d, only_real=True)
        if rts is None:
            self.reject_reason = "denominator roots failed"
            return False
        pole = 0.0
        for r in rts:
            if r.real > 0 and (pole == 0.0 or r.real < pole):
                pole = r.real
        if pole == 0.0:
            pole = start * 4
        if pole <= start:
            self.reject_reason = "pole %g <= start %g" % (pole, start)
            return False

        eps2 = eps * eps
        n = self.xs.shape[0] - 2

        def check(av):
            dn = polynomial.eval_poly(self._d, av)
            dlo = polynomial.eval_poly(self._d_lo, av)
            pn = self._eval_nume(av, self._d, n)
            pn_lo = self._eval_nume(av, self._d_lo, n - 1)
            diff = pn_lo * (dn / dlo) - pn
            return float(diff @ diff) <= float(pn @ pn) * eps2

        left = start * 1.001
        right = start + (pole - start) * 0.99
        if not check(left):
            self.reject_reason = "order-n/(n-1) disagree at start*1.001"
            return False
        if limit and right > limit:
            right = limit
        if right > start * 2:
            if check(start * 2):
                left = start * 2
            else:
                right = start * 2
        # bisection tolerance is RELATIVE to the search interval scale
        # (an absolute 1e-3 over-resolves tiny ranges and under-resolves
        # large ones; the reference bisects a fixed 8 rounds,
        # pade.cpp:152-167 — 8 rounds at relative 2^-8 ~ 4e-3 matches)
        tol = max(1e-3 * right, 1e-12)
        it = 0
        while it < 8 and right - left > tol:
            mid = 0.5 * (left + right)
            if check(mid):
                left = mid
            else:
                right = mid
            it += 1
        self.t_max_a = left
        self.t_max = self.eval_t(left)
        return True

    # ------------------------------------------------------------------
    def _eval_nume(self, a, d, n):
        """sum_{i=n..1} xs[i] a^{i-1} * D_{n-i+1}(a) via Horner
        (reference ``pade.cpp:181-189``)."""
        s = np.zeros_like(self.xs[0])
        for i in range(n, 0, -1):
            s = s * a
            scale = polynomial.eval_poly(d[: n - i + 1], a)
            s = s + self.xs[i] * scale
        return s

    def eval_xt(self, a):
        ret = self._eval_nume(a, self._d, self._n)
        ret = ret * (a / polynomial.eval_poly(self._d, a))
        return ret + self.xs[0]

    def eval_t(self, a):
        return (
            polynomial.eval_poly(self._t_nume, a)
            / polynomial.eval_poly(self._d, a)
            + self._t0
        )

    def solve_a(self, t):
        sanm_assert(self._t0 <= t <= self.t_max)
        if t == self.t_max:
            return self.t_max_a
        c = self._t_nume - (t - self._t0) * self._d
        return polynomial.solve_eqn(c, 0.0, self.t_max_a, 0.0)
