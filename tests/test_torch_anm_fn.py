"""The port's function entry point of the ANM drivers against the JAX
package's, on the CPU.

``ANMEqnSolver(fn, remap_inp, remap_out, x0, y, hp, device="cpu")`` and
the other two drivers take a plain torch function, as the JAX package's
take a jnp one (``docs/GUIDE.md`` section 1): the Taylor engine gives the
series, ``batched_jacobian`` the Jacobian.  Ports of the GUIDE example
(``tests/test_guide_examples.py:8``) and of ``tests/test_anm.py``'s
``TestGeneralSolve`` (less SVD-W), ``TestImplicitSolver``,
``TestPaperGeoExample`` and ``TestRosenbrockDer``: each runs through both
packages on the same seeded inputs and must take the JAX package's
restarts and reach its solution within ``SOL_RTOL`` = 1e-9 relative to
the largest entry (both stop at the same residual test with f64
solves), besides the original checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helper import require_tensor_eq, tensor_rng
from sanm_tpu import solver as jsolver
from sanm_tpu_torch import solver as psolver
from sanm_tpu_torch.utils import SANMError
from torch_helper import rel_err

SOL_RTOL = 1e-9
DEV = {"device": "cpu"}


def id_remaps(pkg, shape):
    n = int(np.prod(shape))
    return (pkg.LinearRemap.identity(n, out_shape=tuple(shape)),
            pkg.LinearRemap.identity(n))


def general_solve(pkg, fn, x0, y, maxiter=20, hp=None):
    """Solve fn(x) = y with ``pkg``'s ANMEqnSolver (f(x) + (-y) = 0);
    returns the solution and the restarts."""
    rin, rout = id_remaps(pkg, x0.shape)
    hp = hp or pkg.EqnHyperParam()
    kw = DEV if pkg is psolver else {}
    s = pkg.ANMEqnSolver(fn, rin, rout, x0.reshape(-1), -y.reshape(-1), hp,
                         **kw)
    it = 0
    while not s.converged():
        it += 1
        assert it <= maxiter, "no convergence, rms=%g" % s.residual_rms()
        s.next_iter()
    return np.asarray(s.get_x()).reshape(x0.shape), s.get_nr_iter()


def both_general_solve(fn, jfn, x0, y, **kw):
    """Both packages; the same restarts and solutions within SOL_RTOL."""
    xp, itp = general_solve(psolver, fn, x0, y, **kw)
    kw = dict(kw)
    if kw.get("hp") is not None:
        kw["hp"] = jsolver.EqnHyperParam(**vars(kw["hp"]))
    xj, itj = general_solve(jsolver, jfn, x0, y, **kw)
    assert itp == itj, "restarts %d, the JAX package's %d" % (itp, itj)
    assert rel_err(xp, xj) <= SOL_RTOL
    return xp


def run_vecscale_to(s, t_dst, maxiter=20):
    it = 0
    while s.get_t_upper() <= t_dst:
        it += 1
        assert it <= maxiter
        s.update_approx()
    x, t = s.eval(s.solve_a(t_dst))
    assert t == pytest.approx(t_dst)
    return np.asarray(x), s.get_nr_iter()


# ---------------------------------------------------------------------------
# docs/GUIDE.md section 1
# ---------------------------------------------------------------------------


def guide_solve(pkg, **kw):
    n = 3
    remap = pkg.LinearRemap.identity(n)
    hp = pkg.EqnHyperParam(order=8, use_pade=True)
    hp.converge_rms = 1e-10
    s = pkg.ANMEqnSolver(lambda x: x * x, remap, remap, np.full(n, 1.0),
                         np.full(n, -4.0), hp, **kw)
    it = 0
    while not s.converged():
        s.next_iter()
        it += 1
        assert it < 50
    return np.asarray(s.get_x()), s


def test_guide_anm_example():
    x, s = guide_solve(psolver, **DEV)
    np.testing.assert_allclose(x, 2.0, rtol=1e-9)
    xj, sj = guide_solve(jsolver)
    assert s.get_nr_iter() == sj.get_nr_iter()
    assert s.solver_resolved() == "host_lu"
    assert rel_err(x, xj) <= SOL_RTOL


def test_function_entry_point_needs_a_card_or_cpu():
    """Without ``device`` the entry point runs on the card, and raises
    where there is none; no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a card")
    with pytest.raises(SANMError, match="no CUDA device"):
        guide_solve(psolver)
    remap = psolver.LinearRemap.identity(3)
    with pytest.raises(SANMError):
        psolver.ANMSolverVecScale(lambda x: x * x, remap, remap,
                                  np.ones(3), 0.0, np.ones(3))
    with pytest.raises(SANMError):
        psolver.ANMEqnSolver(lambda x: x * x, remap, remap, np.ones(3),
                             np.ones(3), device="cuda")


def test_function_model_is_not_symmetric():
    """A function's Jacobian is not taken as symmetric: ``auto`` takes host
    LU and an explicit device Cholesky solver raises."""
    remap = psolver.LinearRemap.identity(3)
    with pytest.raises(SANMError, match="symmetric"):
        psolver.ANMEqnSolver(lambda x: x * x, remap, remap, np.ones(3),
                             np.full(3, -4.0),
                             psolver.EqnHyperParam(solver="band_chol"),
                             **DEV)


# ---------------------------------------------------------------------------
# tests/test_anm.py TestGeneralSolve (less SVD-W)
# ---------------------------------------------------------------------------


def test_sqr():
    xsol = tensor_rng((10, 20), 0.2, 1.5, seed=300)
    ysol = xsol * xsol
    xinit = xsol * tensor_rng(xsol.shape, 0.6, 1.5, seed=301)
    xt = both_general_solve(lambda x: x * x, lambda x: x * x, xinit, ysol)
    require_tensor_eq(xt * xt, ysol, 1e-4, msg="sqr solution")


def test_pow_log_pow_strict():
    """No error correction: f(x) - f(x0) + t (f(x0) - y) = 0 to t = 1
    (``ANMSolverVecScale``)."""
    xsol = tensor_rng((10, 20), 1.5, 4.3, seed=310)
    ysol = np.log(xsol ** 2.3) ** 1.5
    xinit = xsol * tensor_rng(xsol.shape, 0.8, 1.4, seed=311)
    f0 = np.log(xinit ** 2.3) ** 1.5
    f0_t = torch.as_tensor(f0)
    out = {}
    for pkg, log, c, kw in ((psolver, torch.log, f0_t, DEV),
                            (jsolver, jnp.log, jnp.asarray(f0), {})):
        rin, rout = id_remaps(pkg, xinit.shape)
        s = pkg.ANMSolverVecScale(
            lambda x, log=log, c=c: log(x ** 2.3) ** 1.5 - c, rin, rout,
            xinit.reshape(-1), 0.0, (f0 - ysol).reshape(-1), **kw)
        out[pkg] = run_vecscale_to(s, 1.0)
    (xp, itp), (xj, itj) = out[psolver], out[jsolver]
    assert itp == itj
    assert rel_err(xp, xj) <= SOL_RTOL
    require_tensor_eq(np.log(xp.reshape(xinit.shape) ** 2.3) ** 1.5, ysol,
                      1e-4, msg="plp")


@pytest.mark.parametrize("exp", [2, 5, 6, 8, 15])
def test_pow_zero_grad(exp):
    xsol = tensor_rng((10, 8, 3), 0.8, 1.5, seed=320)
    xinit = xsol * tensor_rng(xsol.shape, 0.8, 1.2, seed=321)
    ysol = xsol ** 1.7 + np.log(xsol) ** exp
    xinit.reshape(-1)[2] = 1.0  # log -> 0: zero grad of the integer pow
    xt = both_general_solve(lambda x: x ** 1.7 + torch.log(x) ** exp,
                            lambda x: x ** 1.7 + jnp.log(x) ** exp,
                            xinit, ysol)
    require_tensor_eq(xt ** 1.7 + np.log(xt) ** exp, ysol, 1e-4,
                      msg="pow-zg")


def test_ln_vecscale():
    """Solve ln(x) = t y0 to t = 2."""
    x0 = tensor_rng((10, 20), 0.1, 2.5, seed=330)
    y0 = np.log(x0)
    out = {}
    for pkg, log, kw in ((psolver, torch.log, DEV), (jsolver, jnp.log, {})):
        rin, rout = id_remaps(pkg, x0.shape)
        s = pkg.ANMSolverVecScale(log, rin, rout, x0.reshape(-1), 1.0,
                                  -y0.reshape(-1), **kw)
        out[pkg] = run_vecscale_to(s, 2.0)
    (xp, itp), (xj, itj) = out[psolver], out[jsolver]
    assert itp == itj
    assert rel_err(xp, xj) <= SOL_RTOL
    require_tensor_eq(np.log(xp.reshape(x0.shape)), y0 * 2, 1e-4,
                      msg="ln to t=2")


# ---------------------------------------------------------------------------
# tests/test_anm.py TestImplicitSolver, TestPaperGeoExample,
# TestRosenbrockDer
# ---------------------------------------------------------------------------


def test_implicit_pow_delta():
    """remap [x; t] -> x + t dx elementwise, f = x^1.5: the continuation
    moves x by -dx while f(x + t dx) stays fixed."""
    batch = 5
    x0 = tensor_rng((batch,), 1.0, 2.0, seed=340)
    dx = tensor_rng((batch,), -2.0, -1.0, seed=341)
    rows = [[(i, 1.0), (batch, float(dx[i]))] for i in range(batch)]
    out = {}
    for pkg, kw in ((psolver, DEV), (jsolver, {})):
        rin = pkg.LinearRemap(rows, batch + 1, (batch,))
        s = pkg.ANMImplicitSolver(lambda x: x ** 1.5, rin,
                                  pkg.LinearRemap.identity(batch), x0, 0.0,
                                  **kw)
        it = 0
        while s.get_t_upper() < 1.0:
            it += 1
            assert it < 20
            s.update_approx()
        xt, t = s.eval(s.solve_a(1.0))
        assert t == pytest.approx(1.0)
        out[pkg] = (np.asarray(xt), s.get_nr_iter())
    (xp, itp), (xj, itj) = out[psolver], out[jsolver]
    assert itp == itj
    assert rel_err(xp, xj) <= SOL_RTOL
    require_tensor_eq((xp + dx) ** 1.5, x0 ** 1.5, 1e-4, msg="implicit")


def geo_f(m):
    """The paper's geometric example in the array module ``m`` (torch or
    jax.numpy)."""
    cat = m.cat if m is torch else m.concatenate

    def f_all(c):
        x = c[:, 0:1]
        y = c[:, 1:2]
        f0 = 2 * x ** 2 - 5 * x + y ** 2 - 4 * y - 2 * x * y - 5.0
        f1 = (x + 1.0) ** 2 + y ** 2 - 2.0
        return (cat([f0, f1], dim=1) if m is torch
                else cat([f0, f1], axis=1))

    return f_all


def test_geo():
    coord_init = np.array([[0.0, -1.0]])
    df = np.array([[0.0, -6.0]])
    out = {}
    for pkg, m, kw in ((psolver, torch, DEV), (jsolver, jnp, {})):
        rin, rout = id_remaps(pkg, coord_init.shape)
        s = pkg.ANMSolverVecScale(geo_f(m), rin, rout,
                                  coord_init.reshape(-1), 0.0,
                                  df.reshape(-1), pkg.HyperParam(order=20),
                                  **kw)
        it = 0
        while s.get_t_upper() < 1.0:
            it += 1
            assert it < 30
            s.update_approx()
        sol, t = s.eval(s.solve_a(1.0))
        out[pkg] = (np.asarray(sol), s.get_nr_iter())
    (xp, itp), (xj, itj) = out[psolver], out[jsolver]
    assert itp == itj
    assert rel_err(xp, xj) <= SOL_RTOL
    err = geo_f(torch)(torch.as_tensor(xp.reshape(1, 2))).numpy()
    assert abs(err[0, 0]) < 1e-4
    assert abs(err[0, 1] - 6) < 1e-4
    # the equation solver's route must agree
    sol2 = both_general_solve(geo_f(torch), geo_f(jnp), coord_init, -df,
                              hp=psolver.EqnHyperParam(order=20))
    err2 = geo_f(torch)(torch.as_tensor(sol2)).numpy()
    assert abs(err2[0, 0]) < 1e-4
    assert abs(err2[0, 1] - 6) < 1e-4


def test_rosenbrock_der():
    """The Rosenbrock gradient through the port's traced graph and through
    a function model's evaluation, against scipy's documented values."""
    from sanm_tpu_torch.solver.anm import FunctionModel
    from sanm_tpu_torch.taylor import TaylorFn

    def rosen_der(x):
        xm, xm_m1, xm_p1 = x[:, 1:-1], x[:, :-2], x[:, 2:]
        x0, x1 = x[:, 0:1], x[:, 1:2]
        xp1, xp2 = x[:, -1:], x[:, -2:-1]
        der0 = -400.0 * x0 * (x1 - x0 ** 2) + 2 * x0 - 2.0
        der1 = (200.0 * xm - 200.0 * xm_m1 ** 2
                - 400.0 * (xm_p1 - xm ** 2) * xm + 2 * xm - 2.0)
        der2 = 200.0 * xp1 - 200.0 * xp2 ** 2
        return torch.cat([der0, der1, der2], dim=1)

    x0 = np.array([[1.3, 0.7, 0.8, 1.9, 1.2]])
    want = np.array([[515.4, -285.4, -341.6, 2085.4, -482.0]])
    got = TaylorFn(rosen_der, torch.zeros(1, 5, dtype=torch.float64))(
        torch.as_tensor(x0)).numpy()
    require_tensor_eq(got, want, 1e-10, msg="rosen der")
    rin, rout = id_remaps(psolver, x0.shape)
    model = FunctionModel(rosen_der, rin, rout, 5, "cpu")
    require_tensor_eq(model.eval_force(x0.reshape(-1)), want.reshape(-1),
                      1e-10, msg="rosen der through the model")


def test_function_branching_on_data_raises():
    """A function whose control flow depends on its input's data cannot be
    one Taylor graph: the function entry point raises, as the JAX
    package's does when its trace meets the abstract value."""
    def fn(pkg):
        def f(x):
            return x * x if bool((x > 0).all()) else x * x * x
        return f

    x0, y = np.ones((1, 3)), np.full((1, 3), 4.0)
    with pytest.raises(SANMError, match="branches on its"):
        general_solve(psolver, fn(torch), x0, y)
    with pytest.raises(Exception):
        general_solve(jsolver, fn(jnp), x0, y)
