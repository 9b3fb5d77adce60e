"""The plain versions of the port's kernels against the JAX package.

Both packages get the same state (``sanm_tpu_torch.convert.
state_from_numpy`` on the JAX side's host arrays) and the same inputs,
made with NumPy from a seed.  On the CPU each wrapper runs its plain
torch version, which is the CUDA kernel's oracle on the card.  Tolerance:
1e-12 relative to the largest magnitude of each compared array (f64
sums taken in another order than XLA's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanm_tpu.taylor import TaylorFn, batched_jacobian
from sanm_tpu_torch.ops.nhc_series import (NHCSeries, committed_output,
                                           nhc_step)
from sanm_tpu_torch.solver.assemble import (jac_asm, remap_in, remap_out)
from torch_helper import jax_model, port_state, rel_err

TOL = 1e-12
ORDER = 20


@pytest.fixture(scope="module")
def models():
    body, model, plan, f_sub = jax_model()
    st = port_state(body, model, plan, f_sub)
    T = body.mesh.nr_tet
    tfn = TaylorFn(model.fn, jax.ShapeDtypeStruct((T, 3, 3), jnp.float64))
    return body, model, plan, st, tfn


def perturbed_x0(model, seed=3):
    rng = np.random.default_rng(seed)
    return model.x0() + rng.uniform(-0.002, 0.002, model.x0().shape)


@pytest.mark.parametrize("seed", [0, 1])
def test_remap_in_matches_apply_in(models, seed):
    body, model, plan, st, _ = models
    rng = np.random.default_rng(seed)
    xt = rng.standard_normal(st.asm.n + 1)
    ref = np.asarray(plan.apply_in(jnp.asarray(xt))).reshape(-1, 9)
    got = remap_in(st.asm, st.asm.pad_vector(xt))
    assert got.shape == ref.shape
    assert rel_err(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_remap_out_matches_apply_out(models, seed):
    body, model, plan, st, _ = models
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((st.asm.B, 9))
    ref = np.asarray(plan.apply_out(jnp.asarray(b.reshape(-1, 3, 3))))
    got = remap_out(st.asm, torch.as_tensor(b))
    assert got.shape == ref.shape
    assert rel_err(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("perturb", [False, True])
def test_jac_asm_matches_assemble_csr_elem(models, perturb):
    body, model, plan, st, tfn = models
    x = perturbed_x0(model) if perturb else model.x0()
    gin0 = model.lt_inp.remap.apply(jnp.asarray(x))
    J = batched_jacobian(lambda g: tfn(g), gin0)
    data_j, gt_j, E_j = plan.assemble_csr_elem(J)
    assert gt_j is None
    data, E = jac_asm(st.asm, st.elems,
                      remap_in(st.asm, st.asm.pad_vector(x)))
    assert E.shape == E_j.shape and data.shape == data_j.shape
    assert rel_err(E.numpy(), np.asarray(E_j)) <= TOL
    assert rel_err(data.numpy(), np.asarray(data_j)) <= TOL


def test_nhc_series_matches_taylor_engine(models):
    """Per-order biases and commits of K1 at every k <= 20 on a perturbed
    state, against the JAX package's TaylorEngine."""
    body, model, plan, st, tfn = models
    rng = np.random.default_rng(11)
    x0 = perturbed_x0(model)
    T = body.mesh.nr_tet
    eng = tfn.engine()
    P0 = eng.start(model.lt_inp.remap.apply(jnp.asarray(x0)))
    series = NHCSeries(st.elems, ORDER)
    series.start(remap_in(st.asm, st.asm.pad_vector(x0)))
    # order-1 bias: structurally zero in both
    assert not torch.count_nonzero(series.bias_out)
    assert rel_err(committed_output(series.hist, 0, st.elems).numpy(),
                   np.asarray(P0).reshape(T, 9)) <= TOL
    bias = series.bias_out.clone()
    for k in range(1, ORDER + 1):
        b_j = eng.order_bias()
        if k == 1:
            assert b_j is None
        else:
            assert rel_err(bias.numpy(), np.asarray(b_j).reshape(T, 9)) \
                <= TOL, "bias order %d" % k
        x_k = rng.standard_normal(x0.size) * 1e-3 * 0.5 ** k
        P_j = eng.push(model.lt_inp.remap.apply(jnp.asarray(x_k)))
        gin_k = remap_in(st.asm, st.asm.pad_vector(x_k))
        if k < ORDER:
            bias = series.step(k, gin_k).clone()
        else:
            nhc_step(series.hist, k, gin_k, st.elems)
        assert rel_err(committed_output(series.hist, k, st.elems).numpy(),
                       np.asarray(P_j).reshape(T, 9)) <= TOL, \
            "commit order %d" % k
