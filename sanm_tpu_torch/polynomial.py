"""Univariate polynomial utilities (host-side).

Counterpart of reference ``libsanm/unary_polynomial.{h,cpp}``.  These
run on the host in NumPy: they operate on the tiny ``t(a)`` coefficient
vectors (length = ANM order + 1) inside the continuation control loop,
which is data-dependent Python anyway.  The Brent routines of the
reference become bracketed bisection/Newton (fixed tolerance), and the
ACM-Algorithm-30 root finder (``unary_polynomial.cpp:128-334``) becomes
the companion-matrix eigenvalue method of ``numpy.roots``.
"""

from __future__ import annotations

import numpy as np

from .utils import SANMError, sanm_assert


def eval_poly(coeffs, x):
    """Horner evaluation, coeffs[i] multiplies x**i
    (reference ``unary_polynomial::eval``)."""
    acc = 0.0
    for c in reversed(list(coeffs)):
        acc = acc * x + c
    return acc


def eval_tensor_poly(coeff_arrays, a):
    """Horner over an (N+1, ...) stacked coefficient array
    (reference ``unary_polynomial::eval_tensor``)."""
    coeff_arrays = np.asarray(coeff_arrays)
    acc = np.zeros_like(coeff_arrays[0])
    for c in coeff_arrays[::-1]:
        acc = acc * a + c
    return acc


def stable_x_range(order: int) -> float:
    """Largest |a| keeping a**order within ~15.9 double digits
    (reference ``unary_polynomial.cpp:97-103``)."""
    return float(np.power(1e15, 1.0 / order))


def solve_quad(a, b, c):
    """Larger root of a x^2 + b x + c (vertex if no real root);
    reference ``unary_polynomial::solve_quad``."""
    sanm_assert(a > 0, "bad a: %g", a)
    delta = b * b - 4 * a * c
    if delta < 0:
        return -b / (2 * a)
    return (np.sqrt(delta) - b) / (2 * a)


def solve_eqn(coeffs, xmin, xmax, b=0.0, eps=1e-12, max_iter=200):
    """Solve poly(x) = b for x in [xmin, xmax] (bracketing required);
    reference ``unary_polynomial::solve_eqn`` (Brent -> bisection+secant).
    """
    coeffs = list(coeffs)
    f = lambda x: eval_poly(coeffs, x) - b
    f0, f1 = f(xmin), f(xmax)
    if f0 == 0.0:
        return xmin
    if f1 == 0.0:
        return xmax
    sanm_assert(f0 * f1 <= 0, "no zero point: f0=%g f1=%g", f0, f1)
    lo, hi, flo = xmin, xmax, f0
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        fm = f(mid)
        if fm == 0.0 or hi - lo < eps * max(1.0, abs(mid)):
            return mid
        if flo * fm <= 0:
            hi = mid
        else:
            lo, flo = mid, fm
    return 0.5 * (lo + hi)


def _global_opt(coeffs, xmin, xmax, minimize, n_grid=512, n_newton=40):
    """Global min/max of a polynomial on [xmin, xmax]: dense grid +
    local refinement (replaces Brent ``glomin``,
    reference ``unary_polynomial.cpp:38-68``)."""
    coeffs = np.asarray(list(coeffs), dtype=np.float64)
    sanm_assert(len(coeffs) >= 1 and xmin < xmax)
    sign = 1.0 if minimize else -1.0
    xs = np.linspace(xmin, xmax, n_grid)
    powers = xs[:, None] ** np.arange(len(coeffs))[None, :]
    ys = powers @ coeffs * sign
    i = int(np.argmin(ys))
    lo = xs[max(0, i - 1)]
    hi = xs[min(n_grid - 1, i + 1)]
    # golden-section refinement
    gr = 0.5 * (np.sqrt(5.0) - 1.0)
    a_, b_ = lo, hi
    c_ = b_ - gr * (b_ - a_)
    d_ = a_ + gr * (b_ - a_)
    f = lambda x: sign * eval_poly(coeffs, x)
    fc, fd = f(c_), f(d_)
    for _ in range(n_newton):
        if fc < fd:
            b_, d_, fd = d_, c_, fc
            c_ = b_ - gr * (b_ - a_)
            fc = f(c_)
        else:
            a_, c_, fc = c_, d_, fd
            d_ = a_ + gr * (b_ - a_)
            fd = f(d_)
    x = 0.5 * (a_ + b_)
    return float(x), float(eval_poly(coeffs, x))


def minimize(coeffs, xmin, xmax):
    return _global_opt(coeffs, xmin, xmax, True)


def maximize(coeffs, xmin, xmax):
    return _global_opt(coeffs, xmin, xmax, False)


def roots(coeffs, only_real=False, tol=1e-9):
    """All roots of sum_i coeffs[i] x^i via the companion matrix
    (replaces the ACM-30 Bairstow/Newton iteration,
    reference ``unary_polynomial.cpp:154-334``).

    Returns None if the polynomial is degenerate (all ~zero)."""
    c = np.asarray(list(coeffs), dtype=np.float64)
    # strip trailing (high-order) zeros
    nz = np.nonzero(np.abs(c) > 0)[0]
    if len(nz) == 0:
        return None
    c = c[: nz[-1] + 1]
    if len(c) < 2:
        return []
    r = np.roots(c[::-1])
    if only_real:
        r = [complex(x.real, 0.0) for x in r if abs(x.imag) <= tol * max(1.0, abs(x.real))]
    else:
        r = [complex(x) for x in r]
    return r
