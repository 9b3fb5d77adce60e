"""Taylor-coefficient propagation engine over traced torch graphs.

Port of ``sanm_tpu/taylor.py`` (reference ``libsanm/symbolic.{h,cpp}``):
a model is a plain torch function; :class:`TaylorFn` traces it once with
``torch.fx.experimental.proxy_tensor.make_fx`` into a graph of ATen
operators, and :class:`TaylorEngine` interprets that graph with one
incremental Taylor rule per operator overload (:data:`RULES`).

Mathematical contract (the reference's, ``libsanm/symbolic.h:319-383``):
for the input series ``x(a) = sum_k x_k a^k`` every intermediate and
output series ``v(a) = sum_k v_k a^k`` has order-k coefficient::

    v_k = J_v x_k + b_v_k

with the same order-0 Jacobian ``J_v`` at every k and a bias ``b_v_k``
that depends on coefficients of orders < k only.  Per order the engine
runs two passes (``TaylorCoeffProp::compute_next_order_bias`` /
``push_xi``, ``libsanm/symbolic.cpp:140-303``):

* :meth:`TaylorEngine.order_bias` runs every rule with the input's
  order-k coefficient at zero, giving ``b_k`` of the outputs, and keeps
  each rule's convolution terms;
* :meth:`TaylorEngine.push` commits order k from the solved ``x_k``,
  reusing those convolutions.

``None`` stands for a structural zero (``taylor.py:61-87``): constants,
captured tensors (``get_attr`` nodes) and everything computed from them
alone are zero at every order >= 1, so no rule runs for them and no
history is kept for their partners.  A graph that reaches an operator
without a rule raises :class:`~sanm_tpu_torch.utils.SANMError` naming it,
as the JAX engine does for a primitive without one.  The SVD-W rules are
not ported yet: tracing a graph that calls ``svd_w`` raises.

:func:`batched_jacobian` is ``taylor.py:611``: the per-batch-element
Jacobian by forward-mode tangents.

Not ported (TPU-only, see ``ROADMAP.md``): ``cast_taylor_fn``,
``promote_island``, ``_vpu_dot`` and ``numpy_eval``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
from torch.fx.node import Node, map_arg

from .utils import SANMError, SANMNumericalError

aten = torch.ops.aten

# ----------------------------------------------------------------------------
# structural-zero helpers ("None" == zero)
# ----------------------------------------------------------------------------


def z_add(*xs):
    """Sum that skips structural zeros; None if every term is None."""
    acc = None
    for x in xs:
        if x is None:
            continue
        acc = x if acc is None else acc + x
    return acc


def z_neg(x):
    return None if x is None else -x


def z_scale(x, s):
    return None if x is None else x * s


def z_mul(a, b, op=None):
    if a is None or b is None:
        return None
    return a * b if op is None else op(a, b)


# ----------------------------------------------------------------------------
# rule registry
# ----------------------------------------------------------------------------

#: rule(engine, node, k, env_k, cache, commit) -> (out_k, cache)
RULES: Dict[object, Callable] = {}
#: hist_needs(node, is_varying) -> (input nodes whose history the rule
#: reads, whether it reads the output's)
HIST_NEEDS: Dict[object, Callable] = {}


def register_rule(ops, rule, hist_needs=None):
    for op in ops:
        RULES[op] = rule
        if hist_needs is not None:
            HIST_NEEDS[op] = hist_needs


def _no_hist(node, vy):
    return [], False


def _flat_outputs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


# ----------------------------------------------------------------------------
# engine
# ----------------------------------------------------------------------------


class TaylorFn:
    """A traced model function with Taylor propagation support
    (``sanm_tpu/taylor.py:133``; reference ``ComputingGraph``).

    ``TaylorFn(fn, *example_inputs)`` traces ``fn`` on fake tensors of
    the example tensors' shapes, dtype and device (their values are never
    read) and analyses the graph: the live nodes, the series-varying nodes
    (downstream of an input) and the nodes whose coefficient history a
    rule reads.  As the JAX package traces abstract values, control flow
    that depends on the input's data raises :class:`SANMError` instead of
    fixing one branch.  Calling it evaluates the graph; :meth:`engine`
    gives a fresh per-expansion state."""

    def __init__(self, fn: Callable, *example_inputs):
        from torch._subclasses.fake_tensor import DataDependentOutputException
        from torch.fx.experimental.proxy_tensor import make_fx
        from torch.fx.experimental.symbolic_shapes import (
            GuardOnDataDependentSymNode)

        # through a wrapper: make_fx reads the arity off the signature,
        # which for a bound method (a model's ``fn``) counts ``self``;
        # captured real tensors become the graph's constants
        try:
            self.gm = make_fx(lambda *xs: fn(*xs), tracing_mode="fake",
                              _allow_non_fake_inputs=True)(*example_inputs)
        except (GuardOnDataDependentSymNode,
                DataDependentOutputException) as e:
            raise SANMError("the traced function branches on its input's "
                            "data, which a Taylor graph cannot hold: %s"
                            % str(e).splitlines()[0]) from e
        self._analyze()

    def _analyze(self):
        nodes = list(self.gm.graph.nodes)
        self.inputs = [n for n in nodes if n.op == "placeholder"]
        out = [n for n in nodes if n.op == "output"][0].args[0]
        self.multi = isinstance(out, (tuple, list))
        self.outputs = _flat_outputs(out)
        used = {o for o in self.outputs if isinstance(o, Node)}
        live = []
        for node in reversed(nodes):
            if node in used and node.op != "placeholder":
                live.append(node)
                used.update(node.all_input_nodes)
        live.reverse()
        self.live = live
        # series-varying nodes: transitively downstream of an input.  The
        # rest (constants and what is computed from them alone) is zero at
        # every order >= 1: no rule runs for it, and no history is kept for
        # a partner of it in a product (e.g. Ds in F = Ds Dm^-1)
        varying = set(self.inputs)
        for node in live:
            if any(a in varying for a in node.all_input_nodes):
                varying.add(node)
        self.varying = varying
        self.rule_nodes = [n for n in live if n in varying]

        def is_varying(a):
            return isinstance(a, Node) and a in varying

        need = set()
        for node in self.rule_nodes:
            if node.op != "call_function" or node.target not in RULES:
                raise SANMError(
                    "no Taylor rule for operator %s (node: %s)"
                    % (getattr(node.target, "__name__", node.target),
                       node.format_node()))
            fn = HIST_NEEDS.get(node.target, _no_hist)
            ins, out_need = fn(node, is_varying)
            need.update(a for a in ins if is_varying(a))
            if out_need:
                need.add(node)
        self.need_hist = need

    def attr(self, node):
        """The tensor of a ``get_attr`` node (a captured constant)."""
        obj = self.gm
        for part in node.target.split("."):
            obj = getattr(obj, part)
        return obj

    def __call__(self, *xs):
        """Plain evaluation of the traced graph."""
        return self.gm(*xs)

    def engine(self) -> "TaylorEngine":
        return TaylorEngine(self)


class TaylorEngine:
    """Per-expansion Taylor propagation state (``sanm_tpu/taylor.py:222``;
    reference ``TaylorCoeffProp``)."""

    def __init__(self, tfn: TaylorFn):
        self.tfn = tfn
        self.k = -1  # the last committed order
        self._pending = False
        self.val0: Dict[Node, object] = {}
        self.hist: Dict[Node, list] = {}
        self.userdata: Dict[Node, object] = {}
        self._caches: Dict[Node, object] = {}

    # -- coefficient access (used by the rules) ------------------------------
    def coeff(self, a, i):
        """Order-i coefficient of an argument (None == zero).  Python
        scalars, constants and constant-derived nodes are order 0 only."""
        if not isinstance(a, Node):
            return a if i == 0 else None
        if i == 0:
            return self.val0[a]
        if a not in self.tfn.varying:
            return None
        h = self.hist.get(a)
        if h is None or i >= len(h):
            raise SANMError(
                "history of %s not stored up to order %d; hist_needs "
                "analysis bug" % (a.name, i))
        return h[i]

    def coeff0(self, a):
        return self.coeff(a, 0)

    def series_const(self, a):
        """True when ``a`` is zero at every order >= 1."""
        return not isinstance(a, Node) or a not in self.tfn.varying

    def conv(self, u, v, k, op=None):
        """sum_{i=1..k-1} u_i v_{k-i}, elementwise (``op`` None) or with
        the bilinear ``op``: the Cauchy-product bias of a product."""
        if self.series_const(u) or self.series_const(v):
            return None
        return z_add(*[z_mul(self.coeff(u, i), self.coeff(v, k - i), op)
                       for i in range(1, k)])

    def shape(self, node):
        return self.val0[node].shape

    # -- order 0 ---------------------------------------------------------------
    def start(self, *x0s):
        """Evaluate order 0 through the graph and reset the series state
        (``taylor.py:284``); returns the output(s)."""
        tfn = self.tfn
        if len(x0s) != len(tfn.inputs):
            raise SANMError("expected %d inputs, got %d"
                            % (len(tfn.inputs), len(x0s)))
        env = {n: torch.as_tensor(x) for n, x in zip(tfn.inputs, x0s)}
        with torch.no_grad():
            for node in tfn.live:
                if node.op == "get_attr":
                    env[node] = tfn.attr(node)
                    continue
                args = map_arg(node.args, env.__getitem__)
                kwargs = map_arg(node.kwargs, env.__getitem__)
                env[node] = node.target(*args, **kwargs)
        self.val0 = env
        self.hist = {n: [env[n]] for n in tfn.need_hist}
        self.userdata = {}
        self._caches = {}
        self.k = 0
        self._pending = False
        return self._pack([env.get(o, o) if isinstance(o, Node) else o
                           for o in tfn.outputs])

    def _pack(self, outs):
        return tuple(outs) if self.tfn.multi else outs[0]

    # -- one pass over the graph at order k ----------------------------------
    def _run_pass(self, k, in_ks, commit):
        tfn = self.tfn
        env_k = {n: x for n, x in zip(tfn.inputs, in_ks)}
        with torch.no_grad():
            for node in tfn.rule_nodes:
                cache = self._caches.get(node) if commit else None
                out, cache = RULES[node.target](self, node, k, env_k, cache,
                                                commit)
                if not commit:
                    self._caches[node] = cache
                env_k[node] = out
        if commit:
            for node in tfn.need_hist:
                h = self.hist[node]
                if len(h) != k:
                    raise SANMError("history out of sync")
                h.append(env_k.get(node))
        return self._pack([env_k.get(o) if isinstance(o, Node) else None
                           for o in tfn.outputs])

    def order_bias(self):
        """The order-(k+1) bias of the outputs, the input's coefficient
        held at zero (``taylor.py:347``); None for an all-zero bias (always
        at order 1)."""
        if self._pending:
            raise SANMError("order_bias called twice without push")
        self._caches = {}
        outs = self._run_pass(self.k + 1, [None] * len(self.tfn.inputs),
                              commit=False)
        self._pending = True
        return outs

    def push(self, *xks):
        """Commit order k from the solved input coefficient(s)
        (``taylor.py:361``); returns the output coefficient(s)."""
        if not self._pending:
            raise SANMError("push without preceding order_bias")
        k = self.k + 1
        outs = self._run_pass(k, [torch.as_tensor(x) for x in xks],
                              commit=True)
        self.k = k
        self._pending = False
        return outs


# ----------------------------------------------------------------------------
# batched Jacobian (taylor.py:611)
# ----------------------------------------------------------------------------

#: above this many tangent entries (batch x input size) the tangents go
#: through one at a time, as in the JAX package
JVP_SEQUENTIAL = 200_000


def batched_jacobian(fn: Callable, x0):
    """Dense per-batch-element Jacobian ``(B, odim, idim)`` of a function
    that maps ``(B, *in_inner)`` to ``(B, *out_inner)`` elementwise over
    the batch: the ``idim`` basis tangents, broadcast over the batch,
    pushed through ``torch.func.jvp``, under ``vmap`` up to
    :data:`JVP_SEQUENTIAL` tangent entries and one at a time above."""
    x0 = torch.as_tensor(x0)
    in_inner = tuple(x0.shape[1:])
    idim = int(math.prod(in_inner))
    B = x0.shape[0]
    eye = torch.eye(idim, dtype=x0.dtype, device=x0.device)
    tans = eye.reshape((idim, 1) + in_inner).expand((idim, B) + in_inner)

    def lin(t):
        return torch.func.jvp(fn, (x0,), (t,))[1]

    if B * idim > JVP_SEQUENTIAL:
        cols = torch.stack([lin(tans[i].contiguous()) for i in range(idim)])
    else:
        cols = torch.func.vmap(lin)(tans.contiguous())
    return cols.reshape(idim, B, -1).movedim(0, 2)


# ----------------------------------------------------------------------------
# rules
# ----------------------------------------------------------------------------


def _k(env_k, a):
    """The order-k coefficient of an argument in this pass (None == 0)."""
    return env_k.get(a) if isinstance(a, Node) else None


def _fit(engine, node, out):
    """Broadcast a coefficient to the node's shape (a product or sum whose
    varying operand is smaller than its output)."""
    shape = engine.shape(node)
    if out is not None and out.shape != shape:
        out = torch.broadcast_to(out, shape).contiguous()
    return out


# -- linear and structural operators: apply the operator to the order-k
# coefficients, zero for constant operands --------------------------------

_RESHAPES = {aten.view.default, aten._unsafe_view.default}


def _linear_rule(engine, node, k, env_k, cache, commit):
    ins = node.all_input_nodes
    if all(_k(env_k, a) is None for a in ins):
        return None, cache

    def coef(a):
        x = env_k.get(a)
        return torch.zeros_like(engine.val0[a]) if x is None else x

    args = map_arg(node.args, coef)
    kwargs = map_arg(node.kwargs, coef)
    # a view of an order-k coefficient may meet another memory layout
    # than the order-0 value had: reshape copies where it must
    target = aten.reshape.default if node.target in _RESHAPES \
        else node.target
    return target(*args, **kwargs), cache


register_rule(
    [aten.view.default, aten._unsafe_view.default, aten.reshape.default,
     aten.permute.default, aten.transpose.int, aten.t.default,
     aten.expand.default, aten.unsqueeze.default, aten.squeeze.dim,
     aten.squeeze.dims, aten.squeeze.default, aten.select.int,
     aten.slice.Tensor, aten.cat.default, aten.stack.default,
     aten.sum.dim_IntList, aten.sum.default, aten.mean.dim,
     aten.clone.default, aten.alias.default, aten.neg.default,
     aten.flip.default, aten._to_copy.default, aten.detach.default],
    _linear_rule)


# -- add / sub ---------------------------------------------------------------


def _add_rule(sign):
    def rule(engine, node, k, env_k, cache, commit):
        u, v = node.args[0], node.args[1]
        alpha = node.kwargs.get("alpha", 1)
        s = sign * alpha
        out = z_add(_k(env_k, u),
                    None if _k(env_k, v) is None
                    else (_k(env_k, v) if s == 1 else _k(env_k, v) * s))
        return _fit(engine, node, out), cache

    return rule


def _rsub_rule(engine, node, k, env_k, cache, commit):
    """other - alpha x."""
    x = _k(env_k, node.args[0])
    other = _k(env_k, node.args[1])
    alpha = node.kwargs.get("alpha", 1)
    return _fit(engine, node, z_add(other, z_scale(x, -alpha))), cache


register_rule([aten.add.Tensor, aten.add.Scalar], _add_rule(1))
register_rule([aten.sub.Tensor, aten.sub.Scalar], _add_rule(-1))
register_rule([aten.rsub.Scalar, aten.rsub.Tensor], _rsub_rule)


# -- products (Cauchy products) --------------------------------------------


def _bilinear_rule(op=None):
    """out = op(u, v) for a product bilinear in (u, v) (elementwise when
    ``op`` is None, else a matrix product):
    out_k = op(u_0, v_k) + op(u_k, v_0) + sum_{0<i<k} op(u_i, v_{k-i})
    (``taylor.py:708``, ``:761``; reference Multiply and BatchedMatMul)."""
    def rule(engine, node, k, env_k, cache, commit):
        u, v = node.args[0], node.args[1]
        if cache is None:
            cache = engine.conv(u, v, k, op)
        out = z_add(z_mul(engine.coeff0(u), _k(env_k, v), op),
                    z_mul(_k(env_k, u), engine.coeff0(v), op), cache)
        return _fit(engine, node, out), cache

    return rule


def _bilinear_hist(node, vy):
    u, v = node.args[0], node.args[1]
    return [a for a, other in ((u, v), (v, u)) if vy(other)], False


register_rule([aten.mul.Tensor, aten.mul.Scalar], _bilinear_rule(),
              _bilinear_hist)
for _op in (aten.bmm.default, aten.mm.default):
    register_rule([_op], _bilinear_rule(_op), _bilinear_hist)


def _div_rule(engine, node, k, env_k, cache, commit):
    """w = u / v: w_k = (u_k - w_0 v_k - sum_{0<i<k} w_i v_{k-i}) / v_0
    (``taylor.py:731``)."""
    u, v = node.args[0], node.args[1]
    if cache is None:
        cache = engine.conv(node, v, k)
    num = z_add(_k(env_k, u), z_neg(z_mul(engine.coeff0(node),
                                           _k(env_k, v))), z_neg(cache))
    out = None if num is None else num / engine.coeff0(v)
    return _fit(engine, node, out), cache


def _div_hist(node, vy):
    v = node.args[1]
    return ([v] if vy(v) else []), vy(v)


register_rule([aten.div.Tensor, aten.div.Scalar], _div_rule, _div_hist)


# -- analytic unary operators ------------------------------------------------


def _pow_series(engine, node, x, p, k, env_k, cache):
    """f = x^p, x_0 != 0: f_k = p f_0 / x_0 x_k
    + (1/x_0) sum_{0<i<k} ((i/k)(p+1) - 1) f_{k-i} x_i
    (``taylor.py:806``, reference ``libsanm/analytic_unary.cpp:133-137``).
    A zero base with p not a non-negative integer has no Taylor series:
    SANMNumericalError, as the reference raises."""
    x0 = engine.coeff0(x)
    checked = ("zero base", node)
    if checked not in engine.userdata:
        if bool(torch.any(torch.as_tensor(x0) == 0.0)):
            raise SANMNumericalError(
                "pow: zero base with non-integer exponent %r has no Taylor "
                "expansion" % (p,))
        engine.userdata[checked] = True
    if cache is None:
        terms = []
        if not engine.series_const(x):
            for i in range(1, k):
                t = z_mul(engine.coeff(node, k - i), engine.coeff(x, i))
                if t is not None:
                    terms.append(t * ((i / k) * (p + 1) - 1.0))
        s = z_add(*terms)
        cache = None if s is None else s / x0
    xk = _k(env_k, x)
    lin = None if xk is None else (p * engine.coeff0(node) / x0) * xk
    return z_add(lin, cache), cache


def _binary_chain(n):
    """Square-and-multiply chain of x^n (``taylor.py:908``):
    ``chain[i] = (ia, ib)`` means ``V[i+1] = V[ia] * V[ib]``, ``V[0] = x``;
    returns ``(chain, out_idx)``."""
    bits = []
    e = n
    while e:
        bits.append(e & 1)
        e >>= 1
    chain = []
    sq_idx = [0]
    for _ in range(1, len(bits)):
        chain.append((sq_idx[-1], sq_idx[-1]))
        sq_idx.append(len(chain))
    acc = None
    for j, bit in enumerate(bits):
        if bit:
            if acc is None:
                acc = sq_idx[j]
            else:
                chain.append((acc, sq_idx[j]))
                acc = len(chain)
    return chain, acc


def _integer_pow(engine, node, x, n, k, env_k, cache, commit):
    """f = x^n for an integer n >= 0 through the convolution chain of
    :func:`_binary_chain`, valid at any x_0 including 0
    (``taylor.py:944``)."""
    xk = _k(env_k, x)
    if n == 1:
        return xk, cache
    if n == 0:
        return None, cache
    chain, out_idx = _binary_chain(n)
    series = engine.userdata.get(node)
    if series is None:
        vals0 = [engine.coeff0(x)]
        for ia, ib in chain:
            vals0.append(vals0[ia] * vals0[ib])
        series = engine.userdata[node] = [[v] for v in vals0]

    def val_coeff(vi, i):
        if vi == 0:
            return engine.coeff(x, i) if i < k else None
        return series[vi][i] if i < len(series[vi]) else None

    if cache is None:
        cache = [z_add(*[z_mul(val_coeff(ia, i), val_coeff(ib, k - i))
                         for i in range(1, k)]) for ia, ib in chain]
    cur = [xk] + [None] * len(chain)
    for ci, (ia, ib) in enumerate(chain):
        cur[ci + 1] = z_add(z_mul(val_coeff(ia, 0), cur[ib]),
                            z_mul(cur[ia], val_coeff(ib, 0)), cache[ci])
    if commit:
        for vi in range(1, len(chain) + 1):
            if len(series[vi]) != k:
                raise SANMError("integer pow chain out of sync")
            series[vi].append(cur[vi])
    return cur[out_idx], cache


def _static_exponent(engine, node):
    """The exponent of a pow node: a Python number, or a constant
    (non-varying) 0-d tensor."""
    e = node.args[1]
    if isinstance(e, Node):
        if e in engine.tfn.varying:
            raise SANMError("pow exponent must be a static constant")
        return float(engine.coeff0(e))
    return float(e)


def _pow_rule(get_p):
    def rule(engine, node, k, env_k, cache, commit):
        x = node.args[0]
        p = get_p(engine, node)
        if float(p).is_integer() and p >= 0:
            # an integral exponent takes the convolution chain at any x_0,
            # 0 included (the reference's |x0| < 1e-3 switch, made
            # unconditional as in the JAX package)
            out, cache = _integer_pow(engine, node, x, int(p), k, env_k,
                                      cache, commit)
        else:
            out, cache = _pow_series(engine, node, x, p, k, env_k, cache)
        return _fit(engine, node, out), cache

    return rule


def _unary_hist(node, vy):
    x = node.args[0]
    return [x], vy(x)


register_rule([aten.pow.Tensor_Scalar, aten.pow.Tensor_Tensor],
              _pow_rule(_static_exponent), _unary_hist)
register_rule([aten.sqrt.default], _pow_rule(lambda e, n: 0.5), _unary_hist)
register_rule([aten.rsqrt.default], _pow_rule(lambda e, n: -0.5),
              _unary_hist)
register_rule([aten.reciprocal.default], _pow_rule(lambda e, n: -1.0),
              _unary_hist)


def _log_rule(engine, node, k, env_k, cache, commit):
    """f = log x: f_k = x_k / x_0 - (1/x_0) sum_{0<i<k} (i/k) f_i x_{k-i}
    (``taylor.py:875``)."""
    x = node.args[0]
    x0 = engine.coeff0(x)
    if cache is None:
        terms = []
        if not engine.series_const(x):
            for i in range(1, k):
                t = z_mul(engine.coeff(node, i), engine.coeff(x, k - i))
                if t is not None:
                    terms.append(t * (i / k))
        s = z_add(*terms)
        cache = None if s is None else -s / x0
    xk = _k(env_k, x)
    return z_add(None if xk is None else xk / x0, cache), cache


def _exp_rule(engine, node, k, env_k, cache, commit):
    """f = exp x: f_k = f_0 x_k + sum_{0<i<k} (i/k) x_i f_{k-i}
    (``taylor.py:901``)."""
    x = node.args[0]
    if cache is None:
        terms = []
        if not engine.series_const(x):
            for i in range(1, k):
                t = z_mul(engine.coeff(x, i), engine.coeff(node, k - i))
                if t is not None:
                    terms.append(t * (i / k))
        cache = z_add(*terms)
    xk = _k(env_k, x)
    return z_add(None if xk is None else engine.coeff0(node) * xk,
                 cache), cache


register_rule([aten.log.default], _log_rule, _unary_hist)
register_rule([aten.exp.default], _exp_rule, _unary_hist)


# -- selection with a constant predicate, comparisons -------------------------


def _where_rule(engine, node, k, env_k, cache, commit):
    """where(c, a, b) with a predicate that is constant along the series
    (``taylor.py:1257``): the order-k coefficients selected by c_0."""
    cond, a, b = node.args[0], node.args[1], node.args[2]
    if _k(env_k, cond) is not None:
        raise SANMError("where: the predicate must be constant along the "
                        "series")
    ak, bk = _k(env_k, a), _k(env_k, b)
    if ak is None and bk is None:
        return None, cache
    shape = engine.shape(node)
    zero = torch.zeros(shape, dtype=engine.val0[node].dtype,
                       device=engine.val0[node].device)
    return torch.where(engine.coeff0(cond), zero if ak is None else ak,
                       zero if bk is None else bk), cache


def _cmp_rule(engine, node, k, env_k, cache, commit):
    """Comparisons feed masks: zero past order 0 (valid while the inputs
    do not cross the boundary along the expansion, ``taylor.py:1282``)."""
    return None, cache


register_rule([aten.where.self], _where_rule)
register_rule([getattr(getattr(aten, name), ov)
               for name in ("eq", "ne", "lt", "le", "gt", "ge")
               for ov in ("Tensor", "Scalar")]
              + [aten.logical_and.default, aten.logical_or.default,
                 aten.logical_not.default], _cmp_rule)
