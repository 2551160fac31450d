"""Algebraic canonicalization and specialization rewrites.

Counterpart of ``pytensor_tpu/tensor/rewriting/math.py`` (PyTensor's
tensor/rewriting/math.py AlgebraicCanonizer:1119 and the exp/log/pow
rules), cut to the rewrites that fire on the radon logp+dlogp graphs, on
the logistic-regression and MLP steps and on the Elman BPTT step, and the
rewrites that change a value: the identities at NaN and inf
(``local_useless_eq_neq``, ``local_comparison_self``, ``local_mod_self``,
``local_zero_div``) and the stabilisations (``local_log1p``,
``local_log_sigmoid``, ``local_log1p_exp_to_softplus``,
``local_log_sum_exp``, ``local_exp_over_1_plus_exp``, ``local_expm1``,
``local_log1mexp``, ``local_log1msigm``, ``local_mul_exp_to_exp_add``).
Each keeps its name, tags, database and registration order.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.compile.mode import (
    register_canonicalize,
    register_specialize,
    register_stabilize,
)
from pytensor_tpu_torch.graph.basic import Constant
from pytensor_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter
from pytensor_tpu_torch.tensor import math as tm
from pytensor_tpu_torch.tensor.basic import as_tensor_variable, cast
from pytensor_tpu_torch.tensor.elemwise import CAReduce, DimShuffle, Elemwise
from pytensor_tpu_torch.tensor.variable import TensorConstant


def _is_ew(node, name):
    return isinstance(node.op, Elemwise) and node.op.scalar_op.name == name


def _unique_value(v):
    """Scalar value if v is a constant with all-equal entries, else None.
    A complex value is its real part where its imaginary part is 0, and
    None otherwise: the rewrites fold constants as floats, and a complex
    one with an imaginary part would lose it."""
    u = _unique_value_any(v)
    if u is not None and np.iscomplexobj(u):
        return u.real if u.imag == 0 else None
    return u


def _unique_value_any(v):
    if isinstance(v, TensorConstant):
        return v.unique_value
    if isinstance(v, Constant):
        data = np.asarray(v.data)
        if data.size and np.all(data == data.flat[0]):
            return data.flat[0]
    if v.owner is not None and isinstance(v.owner.op, DimShuffle):
        return _unique_value(v.owner.inputs[0])
    if v.owner is not None and isinstance(v.owner.op, Elemwise) \
            and v.owner.op.scalar_op.name in ("second", "cast"):
        # fill(x, c) / cast(c): the value is the last input's value
        return _unique_value(v.owner.inputs[-1])
    from pytensor_tpu_torch.tensor.basic import Alloc

    if v.owner is not None and isinstance(v.owner.op, Alloc):
        return _unique_value(v.owner.inputs[0])
    return None


def _needs_broadcast_fix(res_type, out_type):
    """True when ``res`` may be narrower than the node output: a static
    1 where the output is not statically 1 means the dropped operand was
    the broadcast carrier (e.g. add(sum_keepdims, x*0) -> sum_keepdims
    silently loses x's shape)."""
    if res_type.ndim != out_type.ndim:
        return True
    return any(r == 1 and o != 1
               for r, o in zip(res_type.shape, out_type.shape))


def _same_type_out(node, result):
    out = node.outputs[0]
    result = as_tensor_variable(result)
    if result.type.dtype != out.type.dtype:
        result = cast(result, out.type.dtype)
    if result.type.ndim != out.type.ndim \
            or not out.type.is_super(result.type) \
            or _needs_broadcast_fix(result.type, out.type):
        # broadcast up using an existing input as the shape carrier; the
        # carrier must itself REACH the output shape (an input with a
        # static-1 dim where the output has more would under-broadcast)
        if result.type.ndim <= out.type.ndim:
            carrier = None
            for i in node.inputs:
                if (i.type.ndim == out.type.ndim
                        and out.type.is_super(i.type)
                        and not _needs_broadcast_fix(i.type, out.type)):
                    carrier = i
                    break
            if carrier is not None:
                result = tm.second(carrier, result)
            else:
                return None
        else:
            return None
    if result.type.dtype != out.type.dtype:
        result = cast(result, out.type.dtype)
    if not out.type.is_super(result.type):
        return None
    copy_stack_trace(out, result)
    return result


@node_rewriter([Elemwise])
def local_add_neutral(fgraph, node):
    """add(..., 0, ...) -> add(...); single term passes through."""
    if not _is_ew(node, "add"):
        return False
    new_inputs = []
    changed = False
    for i in node.inputs:
        u = _unique_value(i)
        if u is not None and u == 0:
            changed = True
            continue
        new_inputs.append(i)
    if not changed:
        return False
    if not new_inputs:
        new_inputs = [node.inputs[0]]
    res = new_inputs[0] if len(new_inputs) == 1 else tm.add(*new_inputs)
    res = _same_type_out(node, res)
    return [res] if res is not None else False


register_canonicalize(local_add_neutral, name="local_add_neutral")


@node_rewriter([Elemwise])
def local_mul_neutral(fgraph, node):
    """mul(..., 1, ...) -> mul(...); mul(..., 0, ...) -> 0."""
    if not _is_ew(node, "mul"):
        return False
    new_inputs = []
    changed = False
    for i in node.inputs:
        u = _unique_value(i)
        if u is not None and u == 1:
            changed = True
            continue
        if u is not None and u == 0:
            res = _same_type_out(node, as_tensor_variable(0.0))
            return [res] if res is not None else False
        new_inputs.append(i)
    if not changed:
        return False
    if not new_inputs:
        new_inputs = [node.inputs[0]]
    res = new_inputs[0] if len(new_inputs) == 1 else tm.mul(*new_inputs)
    res = _same_type_out(node, res)
    return [res] if res is not None else False


register_canonicalize(local_mul_neutral, name="local_mul_neutral")


@node_rewriter([Elemwise])
def local_flatten_assoc(fgraph, node):
    """add(add(x,y),z) -> add(x,y,z); same for mul (fusion prep)."""
    if not (_is_ew(node, "add") or _is_ew(node, "mul")):
        return False
    name = node.op.scalar_op.name
    new_inputs = []
    changed = False
    for i in node.inputs:
        if (
            i.owner is not None
            and _is_ew(i.owner, name)
            and len(fgraph.clients.get(i, ())) == 1
            and i.type.ndim == node.outputs[0].type.ndim
        ):
            new_inputs.extend(i.owner.inputs)
            changed = True
        else:
            new_inputs.append(i)
    if not changed:
        return False
    fn = tm.add if name == "add" else tm.mul
    res = _same_type_out(node, fn(*new_inputs))
    return [res] if res is not None else False


register_canonicalize(local_flatten_assoc, name="local_flatten_assoc")


@node_rewriter([Elemwise])
def local_log_exp(fgraph, node):
    """log(exp(x)) -> x (float domain)."""
    if not _is_ew(node, "log"):
        return False
    inner = node.inputs[0].owner
    if inner is not None and _is_ew(inner, "exp"):
        res = _same_type_out(node, inner.inputs[0])
        return [res] if res is not None else False
    return False


register_canonicalize(local_log_exp, name="local_log_exp")
register_specialize(local_log_exp, name="local_log_exp")


@node_rewriter([Elemwise])
def local_pow_specialize(fgraph, node):
    """pow(x, const) for const in {0, 0.5, 1, 2, -1, -2} -> cheaper forms."""
    if not _is_ew(node, "pow"):
        return False
    x, y = node.inputs
    u = _unique_value(y)
    if u is None:
        return False
    u = float(u)
    if u == 1.0:
        res = x
    elif u == 2.0:
        res = tm.sqr(x)
    elif u == 0.5:
        res = tm.sqrt(x)
    elif u == -1.0:
        res = tm.reciprocal(x)
    elif u == -2.0:
        res = tm.reciprocal(tm.sqr(x))
    elif u == 0.0:
        from pytensor_tpu_torch.tensor.basic import ones_like

        res = ones_like(x)
    else:
        return False
    res = _same_type_out(node, res)
    return [res] if res is not None else False


register_specialize(local_pow_specialize, name="local_pow_specialize")


@node_rewriter([Elemwise])
def local_log1p(fgraph, node):
    """log(1 + x) -> log1p(x); log(1 - y) -> log1p(-y)."""
    if not _is_ew(node, "log"):
        return False
    inner = node.inputs[0].owner
    if inner is None:
        return False
    if _is_ew(inner, "sub"):
        a, b = inner.inputs
        if _unique_value(a) == 1:
            res = _same_type_out(node, tm.log1p(-b))
            return [res] if res is not None else False
        return False
    if not _is_ew(inner, "add"):
        return False
    terms = inner.inputs
    ones_idx = [k for k, t in enumerate(terms) if _unique_value(t) == 1]
    if not ones_idx:
        return False
    rest = [t for k, t in enumerate(terms) if k != ones_idx[0]]
    arg = rest[0] if len(rest) == 1 else tm.add(*rest)
    res = _same_type_out(node, tm.log1p(arg))
    return [res] if res is not None else False


register_stabilize(local_log1p, name="local_log1p")


@node_rewriter([Elemwise])
def local_log_sigmoid(fgraph, node):
    """log(sigmoid(x)) -> -softplus(-x)."""
    if not _is_ew(node, "log"):
        return False
    inner = node.inputs[0].owner
    if inner is not None and _is_ew(inner, "sigmoid"):
        res = _same_type_out(node, -tm.softplus(-inner.inputs[0]))
        return [res] if res is not None else False
    return False


register_stabilize(local_log_sigmoid, name="local_log_sigmoid")


@node_rewriter([Elemwise])
def local_log1p_exp_to_softplus(fgraph, node):
    """log1p(exp(x)) -> softplus(x)."""
    if not _is_ew(node, "log1p"):
        return False
    inner = node.inputs[0].owner
    if inner is not None and _is_ew(inner, "exp"):
        res = _same_type_out(node, tm.softplus(inner.inputs[0]))
        return [res] if res is not None else False
    return False


register_stabilize(local_log1p_exp_to_softplus, name="local_log1p_exp_to_softplus")


@node_rewriter([Elemwise])
def local_one_minus_sigmoid(fgraph, node):
    """1 - sigmoid(x) -> sigmoid(-x)."""
    if not _is_ew(node, "sub"):
        return False
    one, s = node.inputs
    if _unique_value(one) != 1:
        return False
    inner = s.owner
    if inner is not None and _is_ew(inner, "sigmoid"):
        res = _same_type_out(node, tm.sigmoid(-inner.inputs[0]))
        return [res] if res is not None else False
    return False


register_stabilize(local_one_minus_sigmoid, name="local_one_minus_sigmoid")


@node_rewriter([CAReduce])
def local_sum_of_neg(fgraph, node):
    """sum(-x) -> -sum(x)."""
    if node.op.scalar_op.name != "add":
        return False
    inner = node.inputs[0].owner
    if inner is not None and _is_ew(inner, "neg") and \
            len(fgraph.clients.get(node.inputs[0], ())) == 1:
        s = type(node.op)(node.op.scalar_op, node.op.axis, node.op.dtype,
                          node.op.acc_dtype, node.op.upcast_discrete_output)(
            inner.inputs[0]
        )
        res = _same_type_out(node, -s)
        return [res] if res is not None else False
    return False


register_specialize(local_sum_of_neg, name="local_sum_of_neg")


@node_rewriter([Elemwise])
def local_useless_eq_neq(fgraph, node):
    """eq(x, x) -> ones; neq(x, x) -> zeros (NaN included, as the
    reference)."""
    name = node.op.scalar_op.name
    if name not in ("eq", "neq") or len(node.inputs) != 2:
        return False
    x, y = node.inputs
    if x is not y:
        return False
    from pytensor_tpu_torch.tensor.basic import ones_like, zeros_like

    res = ones_like(x, dtype="bool") if name == "eq" else zeros_like(x, dtype="bool")
    res = _same_type_out(node, res)
    return [res] if res is not None else False


register_canonicalize(local_useless_eq_neq, name="local_useless_eq_neq")


@node_rewriter([Elemwise])
def local_sqrt_sqr(fgraph, node):
    """sqrt(sqr(x)) -> abs(x)."""
    if not _is_ew(node, "sqrt"):
        return False
    inner = node.inputs[0].owner
    if inner is not None and _is_ew(inner, "sqr"):
        res = _same_type_out(node, tm.abs(inner.inputs[0]))
        return [res] if res is not None else False
    return False


register_canonicalize(local_sqrt_sqr, name="local_sqrt_sqr")


@node_rewriter([Elemwise])
def local_log_sum_exp(fgraph, node):
    """log(sum(exp(x), axis)) -> the stable logsumexp graph."""
    if not _is_ew(node, "log"):
        return False
    s = node.inputs[0].owner
    if s is None or not isinstance(s.op, CAReduce) or s.op.scalar_op.name != "add":
        return False
    if len(fgraph.clients.get(node.inputs[0], ())) != 1:
        return False
    e = s.inputs[0].owner
    if e is None or not _is_ew(e, "exp"):
        return False
    if len(fgraph.clients.get(s.inputs[0], ())) != 1:
        return False
    res = tm.logsumexp(e.inputs[0], axis=s.op.axis)
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype:
        res = cast(res, out.type.dtype)
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_stabilize(local_log_sum_exp, name="local_log_sum_exp")


@node_rewriter([Elemwise])
def local_exp_over_1_plus_exp(fgraph, node):
    """exp(x) / (1 + exp(x)) -> sigmoid(x); 1 / (1 + exp(-x)) -> sigmoid(x)."""
    if not _is_ew(node, "true_div"):
        return False
    num, den = node.inputs
    if den.owner is None or not _is_ew(den.owner, "add") or len(den.owner.inputs) != 2:
        return False
    a, b = den.owner.inputs
    one_side, exp_side = (a, b) if _unique_value(a) == 1 else (b, a)
    if _unique_value(one_side) != 1 or exp_side.owner is None \
            or not _is_ew(exp_side.owner, "exp"):
        return False
    (z,) = exp_side.owner.inputs
    if num.owner is not None and _is_ew(num.owner, "exp") and num.owner.inputs[0] is z:
        res = _same_type_out(node, tm.sigmoid(z))
    elif _unique_value(num) == 1:
        res = _same_type_out(node, tm.sigmoid(-z))
    else:
        return False
    if res is None:
        return False
    copy_stack_trace(node.outputs[0], res)
    return [res]


register_stabilize(local_exp_over_1_plus_exp, name="local_exp_over_1_plus_exp")


# ---------------------------------------------------------------------------
# Algebraic canonicalization (reference tensor/rewriting/math.py
# AlgebraicCanonizer:1119, redesigned: instead of a generic two-op
# canonizer class we walk single-client mul/div/neg/reciprocal (resp.
# add/sub/neg) chains once, fold constants, and cancel identical factors.
# Fires only when it provably simplified, so the equilibrium pass is
# stable without an uncanonicalize undo step.
# ---------------------------------------------------------------------------

_MUL_CHAIN = ("mul", "true_div", "neg", "reciprocal")


def _single_client(fgraph, v):
    return len(fgraph.clients.get(v, ())) == 1


def _collect_mul(fgraph, v, num, den, state, invert=False, root=False,
                 at_top=False):
    """Collect multiplicative factors of v into num/den lists.

    state tracks: coeff (python float), n_const (constants folded),
    n_inner_div (div/reciprocal found outside the canonical position).
    The canonical form is [neg] true_div(mul(c?, f...), mul(g...)), so
    one div at the top spine (root, possibly under pure negs) is NOT
    structural change — anything else is.
    """
    node = v.owner
    name = node.op.scalar_op.name if (
        node is not None and isinstance(node.op, Elemwise)) else None
    absorb = root or (name in _MUL_CHAIN and _single_client(fgraph, v))
    if name == "mul" and absorb:
        for i in node.inputs:
            _collect_mul(fgraph, i, num, den, state, invert)
        return
    if name == "true_div" and absorb:
        if (root or at_top) and not state["seen_top_div"]:
            state["seen_top_div"] = True
        else:
            state["n_inner_div"] += 1
        _collect_mul(fgraph, node.inputs[0], num, den, state, invert)
        _collect_mul(fgraph, node.inputs[1], num, den, state, not invert)
        return
    if name == "reciprocal" and absorb:
        if not (root or at_top):
            state["n_inner_div"] += 1
        _collect_mul(fgraph, node.inputs[0], num, den, state, not invert)
        return
    if name == "neg" and absorb:
        state["coeff"] = -state["coeff"]
        state["n_neg"] += 1
        _collect_mul(fgraph, node.inputs[0], num, den, state, invert,
                     at_top=root or at_top)
        return
    u = _unique_value(v)
    if u is not None and v.type.ndim == 0 and np.isfinite(u):
        state["n_const"] += 1
        if invert:
            if float(u) == 0.0:
                # 1/0: keep symbolic (inf/nan semantics)
                den.append(v)
                state["n_const"] -= 1
            else:
                state["coeff"] /= float(u)
        else:
            state["coeff"] *= float(u)
        return
    (den if invert else num).append(v)


@node_rewriter([Elemwise])
def local_mul_div_canonizer(fgraph, node):
    """Canonicalize mul/div/neg/reciprocal trees: fold constants into one
    coefficient, flatten nested divisions, cancel identical factors.
    x/x -> 1, (2*x)/(4*y) -> 0.5*x/y, 1/(1/x) -> x, (-x)*(-y) -> x*y."""
    name = node.op.scalar_op.name
    if name not in ("mul", "true_div", "reciprocal", "neg"):
        return False
    out = node.outputs[0]
    if out.type.dtype.startswith(("int", "uint", "bool")):
        return False  # integer semantics (floor, overflow) differ
    num, den = [], []
    state = {"coeff": 1.0, "n_const": 0, "n_inner_div": 0, "n_neg": 0,
             "seen_top_div": False}
    _collect_mul(fgraph, out, num, den, state, root=True)

    # cancel identical factors (same Variable object; CSE makes these
    # common), only when types match exactly so broadcasting is preserved
    n_cancel = 0
    new_den = []
    for d in den:
        hit = next((k for k, n in enumerate(num)
                    if n is d and n.type == d.type), None)
        if hit is not None:
            del num[hit]
            n_cancel += 1
        else:
            new_den.append(d)
    den = new_den

    coeff = state["coeff"]
    fired = (
        n_cancel > 0
        or state["n_const"] >= 2
        or state["n_inner_div"] > 0
        or (coeff == 0.0 and not den)
        or state["n_neg"] >= 2  # (-x)*(-y) -> x*y
        # a sign folding into a real constant (not +-1, which would just
        # re-emit the same neg node and loop the equilibrium pass):
        or (state["n_neg"] >= 1 and state["n_const"] >= 1
            and coeff not in (1.0, -1.0))
        or (state["n_const"] == 1 and coeff == 1.0 and num)
    )
    if not fired:
        return False

    if coeff == 0.0 and not den:
        res = _same_type_out(node, as_tensor_variable(0.0))
        return [res] if res is not None else False

    dtype = out.type.dtype
    factors = list(num)
    negate = False
    if coeff == -1.0:
        negate = True
    elif coeff != 1.0:
        factors.insert(0, constant_like(coeff, dtype))
    if not factors:
        num_expr = constant_like(1.0, dtype)
    elif len(factors) == 1:
        num_expr = factors[0]
    else:
        num_expr = tm.mul(*factors)
    if den:
        den_expr = den[0] if len(den) == 1 else tm.mul(*den)
        res = tm.true_div(num_expr, den_expr)
    else:
        res = num_expr
    if negate:
        res = -res
    res = _same_type_out(node, res)
    return [res] if res is not None else False


def constant_like(value, dtype):
    from pytensor_tpu_torch.tensor.basic import constant

    return constant(np.array(value, dtype=dtype))


register_canonicalize(local_mul_div_canonizer, name="local_mul_div_canonizer")


def _collect_add(fgraph, v, terms, state, sign=1, root=False):
    node = v.owner
    name = node.op.scalar_op.name if (
        node is not None and isinstance(node.op, Elemwise)) else None
    absorb = root or (name in ("add", "sub", "neg")
                      and _single_client(fgraph, v))
    if name == "add" and absorb:
        for i in node.inputs:
            _collect_add(fgraph, i, terms, state, sign)
        return
    if name == "sub" and absorb:
        _collect_add(fgraph, node.inputs[0], terms, state, sign)
        _collect_add(fgraph, node.inputs[1], terms, state, -sign)
        return
    if name == "neg" and absorb:
        _collect_add(fgraph, node.inputs[0], terms, state, -sign)
        return
    u = _unique_value(v)
    if u is not None and v.type.ndim == 0 and np.isfinite(u):
        state["n_const"] += 1
        state["coeff"] += sign * float(u)
        return
    terms.append((v, sign))


@node_rewriter([Elemwise])
def local_add_sub_canonizer(fgraph, node):
    """Canonicalize add/sub/neg trees: fold constants, cancel x + (-x).
    (x + 2) - (x + 1) -> 1;  (a - b) + b -> a."""
    name = node.op.scalar_op.name
    if name not in ("add", "sub"):
        return False
    out = node.outputs[0]
    if out.type.dtype.startswith(("uint", "bool")):
        return False
    terms = []
    state = {"coeff": 0.0, "n_const": 0}
    _collect_add(fgraph, out, terms, state, root=True)

    n_cancel = 0
    kept = []
    for v, s in terms:
        hit = next((k for k, (w, t) in enumerate(kept)
                    if w is v and t == -s and w.type == v.type), None)
        if hit is not None:
            del kept[hit]
            n_cancel += 1
        else:
            kept.append((v, s))

    if not (n_cancel > 0 or state["n_const"] >= 2):
        return False

    dtype = out.type.dtype
    coeff = state["coeff"]
    pos = [v for v, s in kept if s > 0]
    neg = [v for v, s in kept if s < 0]
    if coeff != 0.0:
        pos.append(constant_like(coeff, dtype))
    if not pos and not neg:
        res = _same_type_out(node, as_tensor_variable(0.0))
        return [res] if res is not None else False
    pos_expr = (pos[0] if len(pos) == 1 else tm.add(*pos)) if pos else None
    neg_expr = (neg[0] if len(neg) == 1 else tm.add(*neg)) if neg else None
    if pos_expr is None:
        res = -neg_expr
    elif neg_expr is None:
        res = pos_expr
    else:
        res = tm.sub(pos_expr, neg_expr)
    res = _same_type_out(node, res)
    return [res] if res is not None else False


register_canonicalize(local_add_sub_canonizer, name="local_add_sub_canonizer")


@node_rewriter([Elemwise])
def local_expm1(fgraph, node):
    """exp(x) - 1 -> expm1(x) (and add(exp(x), -1))."""
    name = node.op.scalar_op.name
    if name == "sub":
        a, b = node.inputs
        if _unique_value(b) == 1 and a.owner is not None and _is_ew(a.owner, "exp"):
            res = _same_type_out(node, tm.expm1(a.owner.inputs[0]))
            return [res] if res is not None else False
    elif name == "add":
        exps = [i for i in node.inputs if i.owner is not None and _is_ew(i.owner, "exp")]
        m1 = [i for i in node.inputs if _unique_value(i) == -1]
        if len(exps) == 1 and len(m1) == 1 and len(node.inputs) == 2:
            res = _same_type_out(node, tm.expm1(exps[0].owner.inputs[0]))
            return [res] if res is not None else False
    return False


register_stabilize(local_expm1, name="local_expm1")


@node_rewriter([Elemwise])
def local_log1mexp(fgraph, node):
    """log1p(-exp(x)) -> log1mexp(x)."""
    if not _is_ew(node, "log1p"):
        return False
    inner = node.inputs[0].owner
    if inner is None or not _is_ew(inner, "neg"):
        return False
    e = inner.inputs[0].owner
    if e is None or not _is_ew(e, "exp"):
        return False
    res = _same_type_out(node, tm.log1mexp(e.inputs[0]))
    return [res] if res is not None else False


register_stabilize(local_log1mexp, name="local_log1mexp")


@node_rewriter([Elemwise])
def local_log1msigm(fgraph, node):
    """log1p(-sigmoid(x)) -> -softplus(x)."""
    if not _is_ew(node, "log1p"):
        return False
    inner = node.inputs[0].owner
    if inner is None or not _is_ew(inner, "neg"):
        return False
    s = inner.inputs[0].owner
    if s is None or not _is_ew(s, "sigmoid"):
        return False
    res = _same_type_out(node, -tm.softplus(s.inputs[0]))
    return [res] if res is not None else False


register_stabilize(local_log1msigm, name="local_log1msigm")


@node_rewriter([Elemwise])
def local_mul_exp_to_exp_add(fgraph, node):
    """exp(a) * exp(b) -> exp(a + b); exp(a) / exp(b) -> exp(a - b)."""
    name = node.op.scalar_op.name
    if name == "mul":
        exps = [i for i in node.inputs
                if i.owner is not None and _is_ew(i.owner, "exp") and _single_client(fgraph, i)]
        if len(exps) < 2:
            return False
        rest = [i for i in node.inputs if i not in exps]
        combined = tm.exp(tm.add(*[e.owner.inputs[0] for e in exps]))
        res = _same_type_out(node, combined if not rest else tm.mul(combined, *rest))
        return [res] if res is not None else False
    if name == "true_div":
        a, b = node.inputs
        if (a.owner is not None and _is_ew(a.owner, "exp")
                and b.owner is not None and _is_ew(b.owner, "exp")
                and _single_client(fgraph, a) and _single_client(fgraph, b)):
            res = _same_type_out(node, tm.exp(a.owner.inputs[0] - b.owner.inputs[0]))
            return [res] if res is not None else False
    return False


register_specialize(local_mul_exp_to_exp_add, name="local_mul_exp_to_exp_add")


@node_rewriter([Elemwise])
def local_abs_simplify(fgraph, node):
    """abs(abs(x)) -> abs(x); abs(-x) -> abs(x); abs(sqr(x)) -> sqr(x);
    abs(exp(x)) -> exp(x) (all real-dtype)."""
    if not _is_ew(node, "abs"):
        return False
    inner = node.inputs[0].owner
    if inner is None or not isinstance(inner.op, Elemwise):
        return False
    if node.inputs[0].type.dtype.startswith("complex"):
        return False
    name = inner.op.scalar_op.name
    if name == "abs":
        res = _same_type_out(node, node.inputs[0])
    elif name == "neg":
        res = _same_type_out(node, tm.abs(inner.inputs[0]))
    elif name in ("sqr", "exp", "sqrt", "softplus", "exp2", "expm1"):
        # nonnegative-range ops (expm1 >= -1 is NOT nonneg; exclude)
        if name == "expm1":
            return False
        res = _same_type_out(node, node.inputs[0])
    else:
        return False
    return [res] if res is not None else False


register_canonicalize(local_abs_simplify, name="local_abs_simplify")


@node_rewriter([Elemwise])
def local_mul_to_sqr(fgraph, node):
    """x * x -> sqr(x) (one read instead of two)."""
    if not _is_ew(node, "mul") or len(node.inputs) != 2:
        return False
    a, b = node.inputs
    if a is not b:
        return False
    res = _same_type_out(node, tm.sqr(a))
    return [res] if res is not None else False


register_specialize(local_mul_to_sqr, name="local_mul_to_sqr")


@node_rewriter([Elemwise])
def local_comparison_self(fgraph, node):
    """lt(x, x), gt(x, x) -> False; le(x, x), ge(x, x) -> True."""
    name = node.op.scalar_op.name
    if name not in ("lt", "gt", "le", "ge") or len(node.inputs) != 2:
        return False
    x, y = node.inputs
    if x is not y:
        return False
    from pytensor_tpu_torch.tensor.basic import ones_like, zeros_like

    val = ones_like if name in ("le", "ge") else zeros_like
    res = _same_type_out(node, val(x, dtype="bool"))
    return [res] if res is not None else False


register_canonicalize(local_comparison_self, name="local_comparison_self")


@node_rewriter([CAReduce])
def local_sum_div_by_scalar(fgraph, node):
    """sum(x / c) -> sum(x) / c for 0-d c (one division instead of n)."""
    if node.op.scalar_op.name != "add":
        return False
    inner_var = node.inputs[0]
    inner = inner_var.owner
    if inner is None or not _is_ew(inner, "true_div"):
        return False
    if len(fgraph.clients.get(inner_var, ())) != 1:
        return False
    num, den = inner.inputs
    if den.type.ndim != 0:
        return False
    s = CAReduce(node.op.scalar_op, node.op.axis, node.op.dtype,
                 node.op.acc_dtype, node.op.upcast_discrete_output)(num)
    res = s / den
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype:
        res = cast(res, out.type.dtype)
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_sum_div_by_scalar, name="local_sum_div_by_scalar")


@node_rewriter([Elemwise])
def local_mod_self(fgraph, node):
    """mod(x, x) -> 0 (mod(0, 0) included)."""
    if node.op.scalar_op.name != "mod" or len(node.inputs) != 2:
        return False
    x, y = node.inputs
    if x is not y:
        return False
    from pytensor_tpu_torch.tensor.basic import zeros_like

    res = _same_type_out(node, zeros_like(x))
    return [res] if res is not None else False


register_canonicalize(local_mod_self, name="local_mod_self")


@node_rewriter([Elemwise])
def local_add_neg_to_sub(fgraph, node):
    """x + (-y) -> x - y; (-x) + y -> y - x."""
    if not _is_ew(node, "add") or len(node.inputs) != 2:
        return False
    x, y = node.inputs
    if y.owner is not None and _is_ew(y.owner, "neg") \
            and _unique_value(y.owner.inputs[0]) is None:
        res = _same_type_out(node, x - y.owner.inputs[0])
        return [res] if res is not None else False
    if x.owner is not None and _is_ew(x.owner, "neg") \
            and _unique_value(x.owner.inputs[0]) is None:
        res = _same_type_out(node, y - x.owner.inputs[0])
        return [res] if res is not None else False
    return False


register_specialize(local_add_neg_to_sub, name="local_add_neg_to_sub")


def _split_const_factors(v):
    """Flatten v = const * core: returns (const, [non-const factors])."""
    if v.owner is not None and _is_ew(v.owner, "mul"):
        const = 1.0
        rest = []
        for i in v.owner.inputs:
            c = _unique_value(i)
            if c is not None:
                const *= float(c)
            else:
                rest.append(i)
        return const, rest
    if v.owner is not None and _is_ew(v.owner, "neg"):
        c, rest = _split_const_factors(v.owner.inputs[0])
        return -c, rest
    if v.owner is not None and _is_ew(v.owner, "true_div"):
        num, den = v.owner.inputs
        cd = _unique_value(den)
        if cd is not None and float(cd) != 0:
            c, rest = _split_const_factors(num)
            return c / float(cd), rest
    c = _unique_value(v)
    if c is not None:
        return float(c), []
    return 1.0, [v]


@node_rewriter([Elemwise])
def local_div_abs_to_sign(fgraph, node):
    """(c1*x) / (c2*abs(c3*x)) -> (c1/(c2*|c3|)) * sign(x) — finite at
    x = 0 where the unrewritten division is 0/0 (reference
    AlgebraicCanonizer behavior, test_abs_mul_div)."""
    if not _is_ew(node, "true_div"):
        return False
    num, den = node.inputs
    cn, num_f = _split_const_factors(num)
    cd, den_f = _split_const_factors(den)
    if len(num_f) != 1 or len(den_f) != 1 or cd == 0.0:
        return False
    a = den_f[0]
    if a.owner is None or not _is_ew(a.owner, "abs"):
        return False
    ca, abs_f = _split_const_factors(a.owner.inputs[0])
    if len(abs_f) != 1 or abs_f[0] is not num_f[0] or ca == 0.0:
        return False
    x = num_f[0]
    k = cn / (cd * abs(ca))
    res = tm.sign(x) if k == 1.0 else (
        np.asarray(k, dtype=node.outputs[0].type.dtype) * tm.sign(x))
    res = _same_type_out(node, res)
    return [res] if res is not None else False


register_canonicalize(local_div_abs_to_sign, name="local_div_abs_to_sign")
register_specialize(local_div_abs_to_sign, name="local_div_abs_to_sign")


@node_rewriter([Elemwise])
def local_zero_div(fgraph, node):
    """0 / x -> 0 (true_div and int_div)."""
    if node.op.scalar_op.name not in ("true_div", "int_div") or len(node.inputs) != 2:
        return False
    c = _unique_value(node.inputs[0])
    if c is None or float(c) != 0.0:
        return False
    # a new constant, never zeros_like of the node's own output: that would
    # read the node being replaced and loop the equilibrium rewriter
    zero = as_tensor_variable(np.asarray(0, dtype=node.outputs[0].type.dtype))
    res = _same_type_out(node, zero)
    return [res] if res is not None else False


register_canonicalize(local_zero_div, name="local_zero_div")


@node_rewriter([Elemwise])
def local_div_by_one(fgraph, node):
    """x // 1 -> x; x / 1 -> x (dtype-preserving)."""
    if node.op.scalar_op.name not in ("int_div", "true_div") \
            or len(node.inputs) != 2:
        return False
    c = _unique_value(node.inputs[1])
    if c is None or float(c) != 1.0:
        return False
    num = node.inputs[0]
    if num.type.dtype != node.outputs[0].type.dtype:
        if node.op.scalar_op.name == "true_div":
            return False  # true_div upcasts ints; keep the cast semantics
        num = cast(num, node.outputs[0].type.dtype)
    res = _same_type_out(node, num)
    return [res] if res is not None else False


register_canonicalize(local_div_by_one, name="local_div_by_one")


@node_rewriter([Elemwise])
def local_div_exp_to_mul_exp(fgraph, node):
    """y / exp(x) -> y * exp(-x); 1 / exp(x) -> exp(-x) (mul fuses
    better than div and feeds local_mul_exp_to_exp_add)."""
    if not _is_ew(node, "true_div") or len(node.inputs) != 2:
        return False
    num, den = node.inputs
    if den.owner is None or not _is_ew(den.owner, "exp"):
        return False
    if num.owner is not None and _is_ew(num.owner, "exp"):
        return False  # exp/exp handled by local_mul_exp_to_exp_add
    en = tm.exp(-den.owner.inputs[0])
    c = _unique_value(num)
    res = en if (c is not None and float(c) == 1.0) else num * en
    res = _same_type_out(node, res)
    return [res] if res is not None else False


register_specialize(local_div_exp_to_mul_exp, name="local_div_exp_to_mul_exp")


def _is_nonneg(v, depth=0):
    """Structurally non-negative: Shape/Shape_i outputs, non-negative
    constants, and add/mul/maximum over such."""
    from pytensor_tpu_torch.tensor.shape import Shape, Shape_i

    if depth > 4:
        return False
    c = _unique_value(v)
    if c is not None:
        return float(c) >= 0
    if isinstance(v, Constant):
        data = np.asarray(v.data)
        return data.size > 0 and bool((data >= 0).all())
    if v.owner is None:
        return v.type.dtype.startswith("uint") or v.type.dtype == "bool"
    if isinstance(v.owner.op, (Shape, Shape_i)):
        return True
    if isinstance(v.owner.op, Elemwise) \
            and v.owner.op.scalar_op.name in ("add", "mul", "maximum",
                                              "minimum", "abs"):
        return all(_is_nonneg(i, depth + 1) for i in v.owner.inputs)
    if isinstance(v.owner.op, DimShuffle):
        return _is_nonneg(v.owner.inputs[0], depth + 1)
    return False


@node_rewriter([Elemwise])
def local_shape_cmp_zero(fgraph, node):
    """Comparisons/extrema of structurally non-negative values (shapes)
    against 0: lt(s, 0) -> 0, ge(s, 0) -> 1, maximum(s, 0) -> s,
    minimum(s, 0) -> 0, eq(s, -1) -> 0."""
    name = node.op.scalar_op.name
    if name not in ("lt", "gt", "le", "ge", "maximum", "minimum", "eq") \
            or len(node.inputs) != 2:
        return False
    from pytensor_tpu_torch.tensor.basic import zeros_like

    a, b = node.inputs
    ca, cb = _unique_value(a), _unique_value(b)
    out_dt = node.outputs[0].type.dtype
    # constants built standalone (NOT zeros_like(node.outputs[0]),
    # which would reference the node being replaced and loop)
    zero = as_tensor_variable(np.asarray(0, dtype=out_dt))
    one = as_tensor_variable(np.asarray(1, dtype=out_dt))
    res = None
    if cb is not None and float(cb) == 0.0 and _is_nonneg(a):
        if name == "lt":
            res = zero
        elif name == "ge":
            res = one
        elif name == "maximum":
            res = a
        elif name == "minimum":
            res = zeros_like(a)
    elif ca is not None and float(ca) == 0.0 and _is_nonneg(b):
        if name == "gt":
            res = zero
        elif name == "le":
            res = one
        elif name == "maximum":
            res = b
        elif name == "minimum":
            res = zeros_like(b)
    elif name == "eq":
        for s, c in ((a, cb), (b, ca)):
            if c is not None and float(c) < 0 and _is_nonneg(s):
                res = zero
                break
    if res is None:
        return False
    res = _same_type_out(node, res)
    return [res] if res is not None else False


register_canonicalize(local_shape_cmp_zero, name="local_shape_cmp_zero")
