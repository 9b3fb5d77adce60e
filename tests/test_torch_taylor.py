"""The port's Taylor engine (``sanm_tpu_torch/taylor.py``) against the JAX
package's, on the CPU.

A port of ``tests/test_taylor.py``'s ``check_taylor_prop``: for every
order k the port's engine satisfies the affine invariant
f_k = J x_k + b_k (J from the port's ``batched_jacobian``), and the
truncated series matches the plain evaluation of the traced function at
sample points.  Besides, the same seeded inputs go through the JAX
package's ``TaylorEngine`` and ``batched_jacobian``: every per-order
coefficient, bias and Jacobian of the port equals the JAX package's
within ``PARITY`` = 1e-12, relative to the largest magnitude of each
compared array (the same rules, with sums in another order).

Covered: the elementwise cases of ``TestElemwise``, the 3x3 linear
algebra of ``TestLinalg`` (``:214-237``, ``:298``, ``:309``), the
polynomial-matrix determinant against a NumPy brute force (``:474``,
n <= 3: the generic-n determinant is a later slice), and the NHC, NHI
and StVK force graphs of the FEA model (``:543``).  A graph that calls
``svd_w`` raises: the SVD-W rules are a later slice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helper import require_tensor_eq, tensor_rng
from sanm_tpu import taylor as jtaylor
from sanm_tpu_torch import taylor
from sanm_tpu_torch.ops import batched_det, batched_inv, batched_mul_eye
from sanm_tpu_torch.utils import SANMError, SANMNumericalError
from torch_helper import rel_err

PARITY = 1e-12


def eval_series(coeffs, a):
    acc = np.zeros_like(np.asarray(coeffs[0]))
    for c in reversed(coeffs):
        acc = acc * a + (0.0 if c is None else np.asarray(c))
    return acc


def run_port(fn, xarr, jacobian=True):
    """Per-order outputs and biases of the port's engine along ``xarr``,
    and its ``batched_jacobian`` at x_0."""
    x0 = torch.as_tensor(xarr[0])
    tfn = taylor.TaylorFn(fn, x0)
    eng = tfn.engine()
    y0 = eng.start(x0)
    ys, bs = [y0.numpy()], []
    for xk in xarr[1:]:
        bk = eng.order_bias()
        yk = eng.push(torch.as_tensor(xk))
        ys.append(np.zeros(y0.shape) if yk is None else yk.numpy())
        bs.append(np.zeros(y0.shape) if bk is None else bk.numpy())
    J = taylor.batched_jacobian(fn, x0).numpy() if jacobian else None
    return tfn, ys, bs, J


def run_jax(fn, xarr, jacobian=True):
    """The same through the JAX package's engine (eager)."""
    x0 = jnp.asarray(xarr[0])
    eng = jtaylor.TaylorFn(fn, x0).engine()
    y0 = np.asarray(eng.start(x0))
    ys, bs = [y0], []
    for xk in xarr[1:]:
        bk = eng.order_bias()
        yk = eng.push(jnp.asarray(xk))
        ys.append(np.zeros(y0.shape) if yk is None else np.asarray(yk))
        bs.append(np.zeros(y0.shape) if bk is None else np.asarray(bk))
    J = (np.asarray(jtaylor.batched_jacobian(fn, x0)) if jacobian
         else None)
    return ys, bs, J


def check_taylor_prop(fn, jfn, xarr, avals, eps_coeff=1e-7, eps_eval=1e-5):
    """``fn`` (torch) and ``jfn`` (JAX) compute the same function; ``xarr``
    the input coefficients of orders 0..N."""
    tfn, ys, bs, J = run_port(fn, xarr)
    out_shape = ys[0].shape
    B = xarr[0].shape[0]
    for k in range(1, len(xarr)):
        lin = np.einsum("boi,bi->bo", J,
                        np.asarray(xarr[k]).reshape(B, -1))
        require_tensor_eq(lin.reshape(out_shape) + bs[k - 1], ys[k],
                          eps_coeff, msg=f"affine invariant at order {k}")
    for a in avals:
        xt = eval_series(xarr, a)
        yt = eval_series(ys, a)
        yget = tfn(torch.as_tensor(xt)).numpy()
        require_tensor_eq(yt, yget, eps_eval, msg=f"series vs eval at a={a}")
    ys_j, bs_j, J_j = run_jax(jfn, xarr)
    assert rel_err(J, J_j) <= PARITY, "batched_jacobian"
    for k, (a, b) in enumerate(zip(ys, ys_j)):
        assert rel_err(a, b) <= PARITY, "coefficient of order %d" % k
    for k, (a, b) in enumerate(zip(bs, bs_j), start=1):
        assert rel_err(a, b) <= PARITY, "bias of order %d" % k


def _rng_arr(shape, lo, hi, n, seed):
    return [tensor_rng(shape, lo, hi, seed=seed + i) for i in range(n)]


def _zeros_tail(xarr, n):
    return xarr + [np.zeros_like(xarr[0])] * n


# ---------------------------------------------------------------------------
# elementwise (tests/test_taylor.py:104-211)
# ---------------------------------------------------------------------------


def test_mul_square():
    xarr = _rng_arr((5, 4), 0.5, 2.0, 4, 100)
    check_taylor_prop(lambda x: x * x, lambda x: x * x,
                      _zeros_tail(xarr, 4), [0.05, -0.05])


def test_mul_three_way():
    def f(x):
        return (x * 2.0 + 1.0) * (x - 0.5) * x

    xarr = _rng_arr((5, 4), 0.5, 2.0, 4, 110)
    check_taylor_prop(f, f, _zeros_tail(xarr, 4), [0.05, -0.05])


def test_div():
    def f(x):
        return (x + 1.0) / (x * x + 0.5)

    xarr = _rng_arr((5, 4), 1.0, 2.0, 4, 120)
    check_taylor_prop(f, f, _zeros_tail(xarr, 4), [0.02, -0.02])


@pytest.mark.parametrize("p", [2.3, -1.0, 0.5, -5.0 / 3.0])
def test_pow(p):
    xarr = _rng_arr((5, 4), 1.0, 2.0, 4, 130)
    check_taylor_prop(lambda x: x ** p, lambda x: x ** p,
                      _zeros_tail(xarr, 4), [0.02, -0.02])


@pytest.mark.parametrize("n", [2, 3, 5, 6, 8, 15])
def test_integer_pow(n):
    # exact zeros in x0: the convolution chain must handle them.  Orders
    # up to 12 (the JAX test stops at 8): x^15 of a quartic input is of
    # degree 60, and the series-vs-eval check is truncation-limited
    xarr = _rng_arr((5, 4), -1.0, 1.0, 5, 140)
    xarr[0][0, 0] = 0.0
    xarr[0][1, 2] = 0.0
    check_taylor_prop(lambda x: x ** n, lambda x: x ** n,
                      _zeros_tail(xarr, 8), [0.05, -0.05], eps_eval=1e-4)


@pytest.mark.parametrize("p", [2.0, 3.0])
def test_pow_float_integral_exponent_zero_base(p):
    # an integral float exponent at a zero base takes the convolution
    # chain instead of dividing by x0
    xarr = _rng_arr((5, 4), -1.0, 1.0, 4, 150)
    xarr[0][0, 0] = 0.0
    xarr[0][2, 3] = 0.0
    check_taylor_prop(lambda x: torch.pow(x, p), lambda x: jax.lax.pow(x, p),
                      _zeros_tail(xarr, 7), [0.05, -0.05])


def test_pow_zero_base_noninteger_raises():
    x0 = torch.tensor([1.0, 0.0, 2.0], dtype=torch.float64)
    eng = taylor.TaylorFn(lambda x: x ** 0.5, x0).engine()
    eng.start(x0)
    with pytest.raises(SANMNumericalError):
        eng.order_bias()
        eng.push(torch.ones(3, dtype=torch.float64))
        eng.order_bias()


def test_log():
    xarr = _rng_arr((5, 4), 1.0, 3.0, 4, 160)
    check_taylor_prop(torch.log, jnp.log, _zeros_tail(xarr, 4),
                      [0.05, -0.05])


def test_exp_sqrt():
    xarr = _rng_arr((5, 4), 0.5, 1.5, 4, 170)
    check_taylor_prop(lambda x: torch.exp(x) + torch.sqrt(x * x + 1.0),
                      lambda x: jnp.exp(x) + jnp.sqrt(x * x + 1.0),
                      _zeros_tail(xarr, 4), [0.05, -0.05])


def test_rsqrt_reciprocal():
    xarr = _rng_arr((5, 4), 0.5, 1.5, 4, 175)
    check_taylor_prop(lambda x: torch.rsqrt(x) + 1.0 / (x + 2.0),
                      lambda x: jax.lax.rsqrt(x) + 1.0 / (x + 2.0),
                      _zeros_tail(xarr, 4), [0.05, -0.05])


def test_pow_log_pow_composition():
    xarr = _rng_arr((10, 20), 1.5, 4.3, 4, 180)
    check_taylor_prop(lambda x: torch.log(x ** 2.3) ** 1.5,
                      lambda x: jnp.log(x ** 2.3) ** 1.5,
                      _zeros_tail(xarr, 6), [0.02, -0.02])


def test_reduce_and_broadcast():
    def f(x):
        ic = torch.sum(x ** 2, dim=(1, 2))
        return x * ic[:, None, None]

    def jf(x):
        ic = jnp.sum(x ** 2, axis=(1, 2))
        return x * ic[:, None, None]

    xarr = _rng_arr((5, 3, 3), 0.5, 1.5, 4, 190)
    check_taylor_prop(f, jf, _zeros_tail(xarr, 4), [0.03, -0.03])


def test_slices_where_and_constants():
    """Slices, a concatenation, a captured constant tensor and a
    ``where`` on a constant mask (the make_fx forms of the JAX package's
    slice, concatenate and select_n rules)."""
    mask_np = tensor_rng((5, 3), -1, 1, seed=195) > 0
    c_np = tensor_rng((5, 3), 0.5, 1.0, seed=196)
    mask, c = torch.as_tensor(mask_np), torch.as_tensor(c_np)

    def f(x):
        y = torch.cat([x[:, 1:] * x[:, :1], x[:, :1] - 2.0], dim=1)
        return torch.where(mask, y * c, -y)

    def jf(x):
        y = jnp.concatenate([x[:, 1:] * x[:, :1], x[:, :1] - 2.0], axis=1)
        return jax.lax.select(jnp.asarray(mask_np), y * c_np, -y)

    xarr = _rng_arr((5, 3), 0.5, 1.5, 4, 197)
    check_taylor_prop(f, jf, _zeros_tail(xarr, 4), [0.03, -0.03])


# ---------------------------------------------------------------------------
# 3x3 linear algebra (tests/test_taylor.py:214-237, :298, :309)
# ---------------------------------------------------------------------------


def test_matmul():
    xarr = _rng_arr((5, 3, 3), -1, 1, 4, 200)
    check_taylor_prop(lambda x: torch.einsum("bij,bjk->bik", x, x),
                      lambda x: jnp.einsum("bij,bjk->bik", x, x),
                      _zeros_tail(xarr, 4), [0.05, -0.05])


def test_det_3x3():
    from sanm_tpu.ops import batched_det as jdet

    xarr = _rng_arr((6, 3, 3), -1, 1, 5, 210)
    xarr[0] += 3 * np.eye(3)
    check_taylor_prop(batched_det, jdet, _zeros_tail(xarr, 5),
                      [0.03, -0.03])


def test_inv_3x3():
    from sanm_tpu.ops import batched_inv as jinv

    xarr = _rng_arr((6, 3, 3), -1, 1, 4, 220)
    xarr[0] += 3 * np.eye(3)
    check_taylor_prop(batched_inv, jinv, _zeros_tail(xarr, 5),
                      [0.02, -0.02])


def test_log_det_composite():
    from sanm_tpu.ops import batched_det as jdet

    xarr = _rng_arr((10, 3, 3), -1, 1, 5, 230)
    xarr[0] += 3 * np.eye(3)
    check_taylor_prop(
        lambda x: torch.log(batched_det(torch.einsum("bji,bjk->bik", x, x))),
        lambda x: jnp.log(jdet(jnp.einsum("bji,bjk->bik", x, x))),
        _zeros_tail(xarr, 8), [0.01, -0.01])


def test_mul_eye_combination():
    from sanm_tpu.ops import batched_det as jdet
    from sanm_tpu.ops import batched_mul_eye as jmul_eye

    xarr = _rng_arr((4, 3, 3), -1, 1, 4, 240)
    xarr[0] += 2.5 * np.eye(3)

    def f(x):
        j = batched_det(x)
        return x * j[:, None, None] ** (-2.0 / 3.0) + batched_mul_eye(
            j * 0.5 - 1.0, 3)

    def jf(x):
        j = jdet(x)
        return x * j[:, None, None] ** (-2.0 / 3.0) + jmul_eye(
            j * 0.5 - 1.0, 3)

    check_taylor_prop(f, jf, _zeros_tail(xarr, 5), [0.02, -0.02])


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("order", [0, 1, 3, 5])
def test_det_coeff_vs_bruteforce(m, order):
    """The engine's coefficient of det(X(a)), X(a) = sum_t mats[t] a^t,
    against a NumPy sample-and-fit brute force (the oracle of
    ``tests/test_taylor.py:474``, 1e-6: the fit's conditioning) and
    against the JAX package's ``polymat_det_coeff`` (1e-12)."""
    from sanm_tpu.ops.polymat import polymat_det_coeff

    L = 4
    mats = _rng_arr((3, m, m), -1, 1, L, 250 + 10 * m)
    _, ys, _, _ = run_port(batched_det, _zeros_tail(mats, 6),
                           jacobian=False)
    got = ys[order]
    deg = (L - 1) * m
    a = np.linspace(-1.0, 1.0, deg + 1)
    vals = np.stack([np.linalg.det(sum(mats[t] * (ai ** t)
                                       for t in range(L))) for ai in a])
    coeffs = np.linalg.solve(np.vander(a, deg + 1, increasing=True), vals)
    require_tensor_eq(got, coeffs[order], 1e-6, msg="det coefficient")
    want = np.asarray(polymat_det_coeff([jnp.asarray(x) for x in mats],
                                        order))
    assert rel_err(got, want) <= PARITY


# ---------------------------------------------------------------------------
# FEA force graphs (tests/test_taylor.py:543)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("em", ["neohookean_c", "neohookean_i",
                                "stvk_stretch"])
def test_fea_force_graph(em):
    """The model's stress graph ``model.fn`` (the port's ``ElasticForceModel``
    and the JAX package's) on the 3x2x2 cuboid at a perturbed state, along
    four orders of seeded input coefficients and eight zero ones (StVK's
    cubic stress of a quartic input then has its whole series)."""
    from sanm_tpu.fea import EnergyModel
    from sanm_tpu_torch.fea import EnergyModel as PortEnergyModel
    from test_torch_nhi import cuboid_bodies

    jbody, pbody = cuboid_bodies()
    jm = jbody.make_forward(EnergyModel.from_name(em))
    pm = pbody.make_forward(PortEnergyModel.from_name(em), device="cpu")
    rng = np.random.default_rng(31)
    x0 = jm.x0() + rng.uniform(-0.002, 0.002, jm.x0().shape)
    T = pbody.mesh.nr_tet
    xs = [x0] + [rng.standard_normal(x0.size) * 1e-3 * 0.5 ** k
                 for k in range(1, 5)] + [np.zeros(x0.size)] * 8
    garr = [np.asarray(jm.lt_inp.remap.apply(jnp.asarray(x))) for x in xs]
    gport = [pm.asm.apply_in(x).reshape(T, 3, 3).numpy() for x in xs]
    assert rel_err(gport[0], garr[0]) <= PARITY
    check_taylor_prop(pm.fn, jm.fn, garr, [0.3, -0.3])


def test_svd_w_graph_raises():
    """The SVD-W rules are a later slice: tracing a graph that calls
    ``svd_w`` (here ARAP's stress) raises, as the JAX engine raises for a
    primitive without a rule."""
    from sanm_tpu_torch.fea import EnergyModel
    from sanm_tpu_torch.ops.svd_w import polar_w
    from test_torch_nhi import cuboid_bodies

    _, pbody = cuboid_bodies()
    pm = pbody.make_forward(EnergyModel.ARAP, device="cpu")
    g = pm.asm.apply_in(pm.x0()).reshape(-1, 3, 3)
    with pytest.raises(SANMError, match="svd_w"):
        taylor.TaylorFn(pm.fn, g)
    with pytest.raises(SANMError, match="svd_w"):
        taylor.TaylorFn(lambda x: x - polar_w(x), g)


def test_operator_without_rule_raises():
    with pytest.raises(SANMError, match="no Taylor rule"):
        taylor.TaylorFn(torch.abs, torch.ones(3, dtype=torch.float64))


def _branch_all(x):
    return x * x if bool((x > 0).all()) else -x


def _branch_item(x):
    return x * x.sum().item()


@pytest.mark.parametrize("fn,match", [(_branch_all, "branches on its"),
                                      (_branch_item, "no Taylor rule")],
                         ids=["bool", "item"])
def test_data_dependent_control_flow_raises(fn, match):
    """The trace reads no input values, as the JAX package's trace of an
    abstract value: a function whose control flow or constants depend on
    its input's data raises instead of fixing the branch taken at the
    example input (here all ones, where ``_branch_all`` takes x * x)."""
    with pytest.raises(SANMError, match=match):
        taylor.TaylorFn(fn, torch.ones(3, dtype=torch.float64))
