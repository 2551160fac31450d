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
``local_log1mexp``, ``local_log1msigm``, ``local_mul_exp_to_exp_add``),
and the special-function rewrites (``local_one_pm_erf``,
``local_log_erfc``, ``local_grad_log_erfc_neg``,
``local_grad_log_erfc_neg_mul``, ``local_reciprocal_1_plus_exp``,
``local_sigm_times_exp``, ``local_odds_sigmoid``,
``local_sigmoid_of_logit``, ``local_logit_of_sigmoid``,
``local_logdiffexp``, ``local_log_kv_iv``, ``local_polygamma_specialize``).
The twenty-three rewrites that the probe of ROADMAP Queue 3 item 1
(``tests/torch_math_probe.py``) showed to change a value, or that it named:
``local_exp_log``, ``local_sum_sum``, ``local_sum_mul_by_scalar``,
``local_mul_switch_sink``, ``local_div_switch_sink``, ``local_0_dot_x``,
``local_log_sqrt``, ``local_exp_log_nan_switch``, ``local_pow_pow``,
``local_reduce_chain``, ``local_sum_of_alloc``, ``local_odd_fn_of_neg``,
``local_inverse_composition``, ``local_log_reciprocal_or_div_const``,
``local_sign_reciprocal_or_div_const``, ``local_sqr_of_sqrt``,
``local_exp_of_log_nan_switch``, ``local_logexp_of_log_nan_switch``,
``local_pow_to_nested_squaring``, ``local_log_neg_expm1``,
``local_func_inverse``, ``local_mul_pow_to_pow_add`` and
``local_sumsqr2dot``.  And the eighteen that change only op counts,
which decide which K1 groups form and how large they are:
``local_neg_neg``, ``local_sqr_of_sqrt_even_pow``,
``local_extremum_self``, ``local_extremum_inf``, ``local_logical_self``,
``local_useless_clip``, ``local_extremum_of_neg``,
``local_even_fn_of_neg``, ``local_useless_floor_ceil_int``,
``local_sign_of_sign``, ``local_reduce_empty_axis``,
``local_sum_of_makevector``, ``local_sub_neg_to_add``,
``local_mul_minus_one``, ``local_merge_switch_same_cond``,
``local_xor_self``, ``local_reduce_join`` and ``local_dot_to_mul``.  So the
port has every ``local_*`` rewrite of the JAX package's file; each keeps
its name, tags, database and registration order.
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
def local_neg_neg(fgraph, node):
    if not _is_ew(node, "neg"):
        return False
    inner = node.inputs[0].owner
    if inner is not None and _is_ew(inner, "neg"):
        res = _same_type_out(node, inner.inputs[0])
        return [res] if res is not None else False
    return False


register_canonicalize(local_neg_neg, name="local_neg_neg")
# also in specialize: later-phase rewrites (odds-sigmoid, reciprocal-of-
# 1+exp) emit fresh neg(neg(x)) / log(exp(x)) that canonicalize has
# already finished cleaning
register_specialize(local_neg_neg, name="local_neg_neg")


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
        # log(1 - y) -> log1p(-y)
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


@node_rewriter([Elemwise])
def local_exp_log(fgraph, node):
    """exp(log(x)) -> x is unsafe (domain); but exp(log1p(x)) -> 1+x is
    similarly unsafe.  Do the safe one: exp(-softplus(-x)) -> sigmoid(x)."""
    if not _is_ew(node, "exp"):
        return False
    inner = node.inputs[0].owner
    if inner is not None and _is_ew(inner, "neg"):
        inner2 = inner.inputs[0].owner
        if inner2 is not None and _is_ew(inner2, "softplus"):
            arg = inner2.inputs[0].owner
            if arg is not None and _is_ew(arg, "neg"):
                res = _same_type_out(node, tm.sigmoid(arg.inputs[0]))
                return [res] if res is not None else False
    return False


register_specialize(local_exp_log, name="local_exp_softplus_sigmoid")


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


@node_rewriter([CAReduce])
def local_sum_sum(fgraph, node):
    """sum(sum(x, a), b) -> one sum over the combined axes."""
    if node.op.scalar_op.name != "add":
        return False
    inner_var = node.inputs[0]
    if inner_var.owner is None or not isinstance(inner_var.owner.op, CAReduce):
        return False
    if inner_var.owner.op.scalar_op.name != "add":
        return False
    if len(fgraph.clients.get(inner_var, ())) != 1:
        return False
    x = inner_var.owner.inputs[0]
    inner_axes = inner_var.owner.op.axis
    outer_axes = node.op.axis
    if inner_axes is None or outer_axes is None:
        combined = None
    else:
        # outer axes index the reduced tensor: map back to x's axes
        kept = [d for d in range(x.type.ndim) if d not in inner_axes]
        combined = tuple(sorted(set(inner_axes) | {kept[a] for a in outer_axes}))
    from pytensor_tpu_torch.tensor.elemwise import Sum

    res = Sum(combined, dtype=node.op.dtype)(x)
    out = node.outputs[0]
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_canonicalize(local_sum_sum, name="local_sum_sum")


@node_rewriter([CAReduce])
def local_sum_mul_by_scalar(fgraph, node):
    """sum(x * c) -> c * sum(x) when c is 0-d (fewer flops on big x)."""
    if node.op.scalar_op.name != "add" or node.op.axis is not None:
        return False
    inner_var = node.inputs[0]
    if inner_var.owner is None or not _is_ew(inner_var.owner, "mul"):
        return False
    if len(fgraph.clients.get(inner_var, ())) != 1:
        return False
    scalars = []
    tensors = []
    for i in inner_var.owner.inputs:
        if i.type.ndim == 0:
            scalars.append(i)
        else:
            tensors.append(i)
    if not scalars or not tensors:
        return False
    from pytensor_tpu_torch.tensor.elemwise import Sum

    base = tensors[0] if len(tensors) == 1 else tm.mul(*tensors)
    res = tm.mul(*scalars) * Sum(None, dtype=node.op.dtype)(base)
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype:
        from pytensor_tpu_torch.tensor.basic import cast

        res = cast(res, out.type.dtype)
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_sum_mul_by_scalar, name="local_sum_mul_by_scalar")


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
        from pytensor_tpu_torch.tensor.basic import cast

        res = cast(res, out.type.dtype)
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_stabilize(local_log_sum_exp, name="local_log_sum_exp")



def _as_guarded_switch(v, fgraph):
    """If v (possibly under neg) is switch(c, ...) with a zero branch and a
    single client chain, return (cond, zero_idx, other_branch, negate)."""
    negate = False
    while v.owner is not None and _is_ew(v.owner, "neg") \
            and len(fgraph.clients.get(v, ())) == 1:
        negate = not negate
        v = v.owner.inputs[0]
    if v.owner is None or not _is_ew(v.owner, "switch") \
            or len(fgraph.clients.get(v, ())) != 1:
        return None
    cond, tbranch, fbranch = v.owner.inputs
    if _unique_value(tbranch) == 0:
        return cond, 1, fbranch, negate
    if _unique_value(fbranch) == 0:
        return cond, 2, tbranch, negate
    return None


@node_rewriter([Elemwise])
def local_mul_switch_sink(fgraph, node):
    """mul(switch(c, 0, x), y) -> switch(c, 0, mul(x, y)) (reference
    rewriting/math.py local_mul_switch_sink).  Load-bearing for NaN-free
    gradients: logp graphs guard invalid regions with switch(cond, 0, expr);
    without sinking, grad produces 0 * inf = NaN."""
    if not _is_ew(node, "mul"):
        return False
    for pos, inp in enumerate(node.inputs):
        got = _as_guarded_switch(inp, fgraph)
        if got is None:
            continue
        cond, zero_idx, other_branch, negate = got
        others = [i for k, i in enumerate(node.inputs) if k != pos]
        new_mul = tm.mul(other_branch, *others)
        if negate:
            new_mul = -new_mul
        zero = tm.second(new_mul, cast(as_tensor_variable(0.0),
                                       new_mul.type.dtype))
        if zero_idx == 1:
            res = tm.switch(cond, zero, new_mul)
        else:
            res = tm.switch(cond, new_mul, zero)
        res = _same_type_out(node, res)
        if res is None:
            return False
        copy_stack_trace(node.outputs[0], res)
        return [res]
    return False


register_specialize(local_mul_switch_sink, name="local_mul_switch_sink")


@node_rewriter([Elemwise])
def local_div_switch_sink(fgraph, node):
    """true_div(switch(c, 0, x), y) -> switch(c, 0, x/y) (reference
    local_div_switch_sink); same NaN-guard rationale as mul."""
    if not _is_ew(node, "true_div"):
        return False
    num, den = node.inputs
    got = _as_guarded_switch(num, fgraph)
    if got is None:
        return False
    cond, zero_idx, other_branch, negate = got
    new_div = tm.true_div(other_branch, den)
    if negate:
        new_div = -new_div
    zero = tm.second(new_div, cast(as_tensor_variable(0.0),
                                   new_div.type.dtype))
    if zero_idx == 1:
        res = tm.switch(cond, zero, new_div)
    else:
        res = tm.switch(cond, new_div, zero)
    res = _same_type_out(node, res)
    if res is None:
        return False
    copy_stack_trace(node.outputs[0], res)
    return [res]


register_specialize(local_div_switch_sink, name="local_div_switch_sink")


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


@node_rewriter(None)
def local_0_dot_x(fgraph, node):
    """dot(zeros, x) -> zeros (reference local_0_dot_x)."""
    from pytensor_tpu_torch.tensor.basic import zeros
    from pytensor_tpu_torch.tensor.math import Dot
    from pytensor_tpu_torch.tensor.shape import shape

    if not isinstance(node.op, Dot):
        return False
    x, y = node.inputs
    if _unique_value(x) == 0 or _unique_value(y) == 0:
        out = node.outputs[0]
        # output dims: x's leading dim when x is a matrix, then y's
        # trailing dim when y is a matrix (never index shape(v)[1] of a
        # vector -- static-shape indexing raises at graph build)
        if out.type.ndim == 0:
            shp = []
        elif out.type.ndim == 1:
            shp = [shape(x)[0]] if x.type.ndim == 2 else [shape(y)[1]]
        else:
            shp = [shape(x)[0], shape(y)[1]]
        res = zeros(shp, dtype=out.type.dtype) if shp else \
            cast(as_tensor_variable(0.0), out.type.dtype)
        if res.type.ndim == out.type.ndim and any(d is not None
                                                  for d in out.type.shape):
            from pytensor_tpu_torch.tensor.shape import specify_shape

            res = specify_shape(res, out.type.shape)
        if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
            return False
        copy_stack_trace(out, res)
        return [res]
    return False


register_canonicalize(local_0_dot_x, name="local_0_dot_x")


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


# ---------------------------------------------------------------------------
# exp / log family (reference rewriting/math.py stabilize rules)
# ---------------------------------------------------------------------------

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
def local_log_sqrt(fgraph, node):
    """log(sqrt(x)) -> 0.5 * log(x)."""
    if not _is_ew(node, "log"):
        return False
    inner = node.inputs[0].owner
    if inner is None or not _is_ew(inner, "sqrt"):
        return False
    if not _single_client(fgraph, node.inputs[0]):
        return False
    x = inner.inputs[0]
    res = _same_type_out(node, 0.5 * tm.log(x))
    return [res] if res is not None else False


register_stabilize(local_log_sqrt, name="local_log_sqrt")


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
def local_exp_log_nan_switch(fgraph, node):
    """exp(x)**c with constant c -> exp(c*x)."""
    if not _is_ew(node, "pow"):
        return False
    base, expo = node.inputs
    if base.owner is None or not _is_ew(base.owner, "exp"):
        return False
    if _unique_value(expo) is None:
        return False
    if not _single_client(fgraph, base):
        return False
    res = _same_type_out(node, tm.exp(expo * base.owner.inputs[0]))
    return [res] if res is not None else False


register_specialize(local_exp_log_nan_switch, name="local_pow_of_exp")


# ---------------------------------------------------------------------------
# abs / sqr / pow simplifications
# ---------------------------------------------------------------------------

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
def local_pow_pow(fgraph, node):
    """(x**a)**b -> x**(a*b) for constant positive-integer a, b (the only
    composition that is domain-safe for all real x)."""
    if not _is_ew(node, "pow"):
        return False
    base, expo = node.inputs
    if base.owner is None or not _is_ew(base.owner, "pow"):
        return False
    if not _single_client(fgraph, base):
        return False
    a = _unique_value(base.owner.inputs[1])
    b = _unique_value(expo)
    if a is None or b is None:
        return False
    af, bf = float(a), float(b)
    if af <= 0 or bf <= 0 or af != int(af) or bf != int(bf):
        return False
    res = _same_type_out(
        node, tm.pow(base.owner.inputs[0],
                     constant_like(af * bf, node.outputs[0].type.dtype)))
    return [res] if res is not None else False


register_canonicalize(local_pow_pow, name="local_pow_pow")


@node_rewriter([Elemwise])
def local_sqr_of_sqrt_even_pow(fgraph, node):
    """sqr(abs(x)) -> sqr(x) (even powers ignore sign)."""
    if not _is_ew(node, "sqr"):
        return False
    inner = node.inputs[0].owner
    if inner is not None and _is_ew(inner, "abs"):
        res = _same_type_out(node, tm.sqr(inner.inputs[0]))
        return [res] if res is not None else False
    return False


register_canonicalize(local_sqr_of_sqrt_even_pow, name="local_sqr_of_abs")


# ---------------------------------------------------------------------------
# comparison / extremum / logical simplifications
# (reference rewriting/math.py local_useless_elemwise family)
# ---------------------------------------------------------------------------

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


@node_rewriter([Elemwise])
def local_extremum_self(fgraph, node):
    """maximum(x,x) -> x; minimum(x,x) -> x."""
    name = node.op.scalar_op.name
    if name not in ("maximum", "minimum") or len(node.inputs) != 2:
        return False
    x, y = node.inputs
    if x is not y:
        return False
    res = _same_type_out(node, x)
    return [res] if res is not None else False


register_canonicalize(local_extremum_self, name="local_extremum_self")


@node_rewriter([Elemwise])
def local_extremum_inf(fgraph, node):
    """maximum(x, -inf) -> x; minimum(x, +inf) -> x; also the saturated
    duals maximum(x, +inf) -> +inf etc. for float dtypes."""
    name = node.op.scalar_op.name
    if name not in ("maximum", "minimum") or len(node.inputs) != 2:
        return False
    out = node.outputs[0]
    if not out.type.dtype.startswith("float"):
        return False
    for pos in (0, 1):
        u = _unique_value(node.inputs[pos])
        if u is None or np.isfinite(u):
            continue
        other = node.inputs[1 - pos]
        if (name == "maximum") == (float(u) < 0):
            res = _same_type_out(node, other)  # neutral element
        else:
            res = _same_type_out(node, as_tensor_variable(float(u)))
        if res is not None:
            return [res]
    return False


register_canonicalize(local_extremum_inf, name="local_extremum_inf")


@node_rewriter([Elemwise])
def local_logical_self(fgraph, node):
    """and_(x,x)->x, or_(x,x)->x, xor(x,x)->0."""
    name = node.op.scalar_op.name
    if name not in ("and_", "or_", "xor") or len(node.inputs) != 2:
        return False
    x, y = node.inputs
    if x is not y:
        return False
    from pytensor_tpu_torch.tensor.basic import zeros_like

    res = zeros_like(x) if name == "xor" else x
    res = _same_type_out(node, res)
    return [res] if res is not None else False


register_canonicalize(local_logical_self, name="local_logical_self")


@node_rewriter([Elemwise])
def local_useless_clip(fgraph, node):
    """clip(x, -inf, +inf) -> x; one-sided infinities -> maximum/minimum."""
    if node.op.scalar_op.name != "clip":
        return False
    x, lo, hi = node.inputs
    lo_u, hi_u = _unique_value(lo), _unique_value(hi)
    lo_free = lo_u is not None and np.isneginf(float(lo_u))
    hi_free = hi_u is not None and np.isposinf(float(hi_u))
    if lo_free and hi_free:
        res = _same_type_out(node, x)
    elif lo_free:
        res = _same_type_out(node, tm.minimum(x, hi))
    elif hi_free:
        res = _same_type_out(node, tm.maximum(x, lo))
    else:
        return False
    return [res] if res is not None else False


register_canonicalize(local_useless_clip, name="local_useless_clip")


# ---------------------------------------------------------------------------
# reduction rewrites (reference local_reduce_chain / local_sum_prod_*)
# ---------------------------------------------------------------------------

_CHAINABLE_REDUCE = ("mul", "maximum", "minimum", "and_", "or_")


@node_rewriter([CAReduce])
def local_reduce_chain(fgraph, node):
    """reduce(reduce(x, a), b) -> one reduce over combined axes, for
    prod/max/min/all/any (sum handled by local_sum_sum)."""
    name = node.op.scalar_op.name
    if name not in _CHAINABLE_REDUCE:
        return False
    inner_var = node.inputs[0]
    inner = inner_var.owner
    if inner is None or not isinstance(inner.op, CAReduce):
        return False
    if inner.op.scalar_op.name != name:
        return False
    if len(fgraph.clients.get(inner_var, ())) != 1:
        return False
    x = inner.inputs[0]
    inner_axes = inner.op.axis
    outer_axes = node.op.axis
    if inner_axes is None or outer_axes is None:
        combined = None
    else:
        kept = [d for d in range(x.type.ndim) if d not in inner_axes]
        combined = tuple(sorted(set(inner_axes) | {kept[a] for a in outer_axes}))
    res = CAReduce(node.op.scalar_op, combined, node.op.dtype,
                   node.op.acc_dtype, node.op.upcast_discrete_output)(x)
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_canonicalize(local_reduce_chain, name="local_reduce_chain")


@node_rewriter([CAReduce])
def local_extremum_of_neg(fgraph, node):
    """max(-x) -> -min(x); min(-x) -> -max(x)."""
    name = node.op.scalar_op.name
    if name not in ("maximum", "minimum"):
        return False
    inner_var = node.inputs[0]
    inner = inner_var.owner
    if inner is None or not _is_ew(inner, "neg") \
            or len(fgraph.clients.get(inner_var, ())) != 1:
        return False
    from pytensor_tpu_torch.scalar import basic as ps

    dual = ps.minimum if name == "maximum" else ps.maximum
    s = CAReduce(dual, node.op.axis, node.op.dtype, node.op.acc_dtype,
                 node.op.upcast_discrete_output)(inner.inputs[0])
    res = _same_type_out(node, -s)
    return [res] if res is not None else False


register_specialize(local_extremum_of_neg, name="local_extremum_of_neg")


@node_rewriter([CAReduce])
def local_sum_of_alloc(fgraph, node):
    """sum(alloc(c, s0, s1, ...), axis) -> alloc(c * prod(reduced sizes),
    kept sizes) for scalar fill c: removes the materialization entirely."""
    from pytensor_tpu_torch.tensor.basic import Alloc, alloc

    if node.op.scalar_op.name != "add":
        return False
    inner_var = node.inputs[0]
    inner = inner_var.owner
    if inner is None or not isinstance(inner.op, Alloc):
        return False
    if len(fgraph.clients.get(inner_var, ())) != 1:
        return False
    c, *shape_vars = inner.inputs
    if c.type.ndim != 0:
        return False
    ndim = len(shape_vars)
    axes = node.op.axis if node.op.axis is not None else tuple(range(ndim))
    out = node.outputs[0]
    count = None
    for a in axes:
        count = shape_vars[a] if count is None else count * shape_vars[a]
    scaled = c * cast(count, out.type.dtype) if count is not None else c
    if scaled.type.dtype != out.type.dtype:
        scaled = cast(scaled, out.type.dtype)
    kept = [shape_vars[d] for d in range(ndim) if d not in axes]
    res = alloc(scaled, *kept) if kept else scaled
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_sum_of_alloc, name="local_sum_of_alloc")


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


# ---------------------------------------------------------------------------
# parity (even/odd) function rules + inverse-composition identities
# ---------------------------------------------------------------------------

_EVEN_FNS = ("cos", "cosh", "sqr", "abs")
_ODD_FNS = ("sin", "tan", "sinh", "tanh", "arcsin", "arctan", "arcsinh",
            "arctanh", "erf", "sign", "cbrt")


@node_rewriter([Elemwise])
def local_even_fn_of_neg(fgraph, node):
    """f(-x) -> f(x) for even f (cos, cosh, sqr, abs)."""
    name = node.op.scalar_op.name
    if name not in _EVEN_FNS:
        return False
    inner = node.inputs[0].owner
    if inner is None or not _is_ew(inner, "neg"):
        return False
    res = _same_type_out(node, Elemwise(node.op.scalar_op)(inner.inputs[0]))
    return [res] if res is not None else False


register_canonicalize(local_even_fn_of_neg, name="local_even_fn_of_neg")


@node_rewriter([Elemwise])
def local_odd_fn_of_neg(fgraph, node):
    """f(-x) -> -f(x) for odd f: pulls the neg up where canonizers can
    cancel it."""
    name = node.op.scalar_op.name
    if name not in _ODD_FNS:
        return False
    inner = node.inputs[0].owner
    if inner is None or not _is_ew(inner, "neg"):
        return False
    res = _same_type_out(node, -Elemwise(node.op.scalar_op)(inner.inputs[0]))
    return [res] if res is not None else False


register_canonicalize(local_odd_fn_of_neg, name="local_odd_fn_of_neg")


@node_rewriter([Elemwise])
def local_inverse_composition(fgraph, node):
    """tan(arctan(x)) -> x, sinh(arcsinh(x)) -> x (total-domain inverse
    pairs only, so NaN semantics are preserved)."""
    name = node.op.scalar_op.name
    pairs = {"tan": "arctan", "sinh": "arcsinh"}
    if name not in pairs:
        return False
    inner = node.inputs[0].owner
    if inner is None or not _is_ew(inner, pairs[name]):
        return False
    res = _same_type_out(node, inner.inputs[0])
    return [res] if res is not None else False


register_canonicalize(local_inverse_composition, name="local_inverse_composition")


@node_rewriter([Elemwise])
def local_useless_floor_ceil_int(fgraph, node):
    """floor/ceil/trunc/round of an integer-dtype tensor -> identity."""
    name = node.op.scalar_op.name
    if name not in ("floor", "ceil", "trunc", "round_half_to_even"):
        return False
    x = node.inputs[0]
    if not x.type.dtype.startswith(("int", "uint", "bool")):
        return False
    res = _same_type_out(node, x)
    return [res] if res is not None else False


register_canonicalize(local_useless_floor_ceil_int,
                      name="local_useless_floor_ceil_int")


@node_rewriter([Elemwise])
def local_sign_of_sign(fgraph, node):
    """sign(sign(x)) -> sign(x)."""
    if not _is_ew(node, "sign"):
        return False
    inner = node.inputs[0].owner
    if inner is not None and _is_ew(inner, "sign"):
        res = _same_type_out(node, node.inputs[0])
        return [res] if res is not None else False
    return False


register_canonicalize(local_sign_of_sign, name="local_sign_of_sign")


@node_rewriter([CAReduce])
def local_reduce_empty_axis(fgraph, node):
    """reduce(x, axis=()) -> x (dtype-adjusted): reduces nothing."""
    if node.op.axis != ():
        return False
    x = node.inputs[0]
    res = _same_type_out(node, x)
    return [res] if res is not None else False


register_canonicalize(local_reduce_empty_axis, name="local_reduce_empty_axis")


@node_rewriter([CAReduce])
def local_sum_of_makevector(fgraph, node):
    """sum(make_vector(a, b, c)) -> a + b + c: no buffer, pure scalar
    adds."""
    from pytensor_tpu_torch.tensor.basic import MakeVector

    if node.op.scalar_op.name != "add" or node.op.axis not in (None, (0,)):
        return False
    v = node.inputs[0]
    if v.owner is None or not isinstance(v.owner.op, MakeVector):
        return False
    if len(fgraph.clients.get(v, ())) != 1:
        return False
    elems = v.owner.inputs
    if not elems:
        return False
    res = elems[0] if len(elems) == 1 else tm.add(*elems)
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype:
        res = cast(res, out.type.dtype)
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_sum_of_makevector, name="local_sum_of_makevector")


# ---------------------------------------------------------------------------
# erf / erfc family (PyTensor's local_one_plus_erf, local_one_minus_erf,
# local_erf_minus_one, local_one_minus_erfc, local_erf_neg_minus_one,
# local_log_erfc, local_grad_log_erfc_neg)
# ---------------------------------------------------------------------------

def _split_pm_one(node):
    """For add/sub nodes: return (sign_of_one, other) when one operand is
    the constant +-1: add(1, t) -> (+1, t); sub(1, t) -> (+1, -t-slot);
    handled per caller.  Returns (const_val, other, other_is_rhs)."""
    if len(node.inputs) != 2:
        return None
    a, b = node.inputs
    va, vb = _unique_value(a), _unique_value(b)
    if va is not None and va in (1, -1, 1.0, -1.0):
        return (float(va), b, True)
    if vb is not None and vb in (1, -1, 1.0, -1.0):
        return (float(vb), a, False)
    return None


def _strip_neg(v):
    """Peel neg(x) / mul(-1, x) -> (flipped, x)."""
    if v.owner is not None and _is_ew(v.owner, "neg"):
        return True, v.owner.inputs[0]
    if v.owner is not None and _is_ew(v.owner, "mul") \
            and len(v.owner.inputs) == 2:
        for i, j in ((0, 1), (1, 0)):
            c = _unique_value(v.owner.inputs[i])
            if c is not None and c in (-1, -1.0):
                return True, v.owner.inputs[j]
    return False, v


@node_rewriter([Elemwise])
def local_one_pm_erf(fgraph, node):
    """1 + erf(x) -> erfc(-x); 1 - erf(x) -> erfc(x);
    erf(x) - 1 -> -erfc(x); -1 + erfc(-x) composes via
    local_odd_fn_of_neg."""
    name = node.op.scalar_op.name
    if name not in ("add", "sub"):
        return False
    split = _split_pm_one(node)
    if split is None:
        return False
    cval, other, one_first = split
    neg_other, core = _strip_neg(other)
    if core.owner is None:
        return False
    if _is_ew(core.owner, "erf"):
        x = core.owner.inputs[0]
        # effective expression: c1*1 + c2*erf(x) with c2 = +-1
        if name == "add":
            one_sign, erf_sign = cval, (-1.0 if neg_other else 1.0)
        elif one_first:   # sub(1, t) = 1 - t
            one_sign, erf_sign = cval, (1.0 if neg_other else -1.0)
        else:             # sub(t, 1) = t - 1
            one_sign, erf_sign = -cval, (-1.0 if neg_other else 1.0)
        if one_sign == 1.0 and erf_sign == 1.0:
            res = tm.erfc(-x)
        elif one_sign == 1.0 and erf_sign == -1.0:
            res = tm.erfc(x)
        elif one_sign == -1.0 and erf_sign == 1.0:
            res = -tm.erfc(x)
        else:  # -1 - erf(x) = -erfc(-x)
            res = -tm.erfc(-x)
        res = _same_type_out(node, res)
        return [res] if res is not None else False
    if _is_ew(core.owner, "erfc"):
        x = core.owner.inputs[0]
        if name == "add":
            one_sign, e_sign = cval, (-1.0 if neg_other else 1.0)
        elif one_first:
            one_sign, e_sign = cval, (1.0 if neg_other else -1.0)
        else:
            one_sign, e_sign = -cval, (-1.0 if neg_other else 1.0)
        # 1 - erfc(x) -> erf(x); -1 + erfc(x) -> -erf(x)
        if one_sign == 1.0 and e_sign == -1.0:
            res = tm.erf(x)
        elif one_sign == -1.0 and e_sign == 1.0:
            res = -tm.erf(x)
        else:
            return False
        res = _same_type_out(node, res)
        return [res] if res is not None else False
    return False


register_stabilize(local_one_pm_erf, name="local_one_pm_erf")
register_specialize(local_one_pm_erf, name="local_one_pm_erf")


def _erfc_thresholds(dtype):
    if dtype in ("float32", "float16", "bfloat16"):
        return 9.0
    return 26.0


def _is_clamped_min(v):
    """True when v is minimum(x, const): marks an already-stabilized
    erfc argument (recursion guard)."""
    return (v.owner is not None and _is_ew(v.owner, "minimum")
            and any(_unique_value(i) is not None for i in v.owner.inputs))


@node_rewriter([Elemwise])
def local_log_erfc(fgraph, node):
    """log(erfc(x)) -> switch(x < T, log(erfc(min(x, T))), asymptotic).

    erfc underflows around x=26.64 (f64) / 10.05 (f32); beyond the
    threshold use -x^2 - log(x) - log(pi)/2 + log1p(-1/(2x^2) + 3/(4x^4)
    - 15/(8x^6)) (PyTensor's tensor/rewriting/math.py:3080).  The safe branch's
    argument is clamped to T so it never underflows AND so this rewrite
    does not re-match its own output."""
    if not _is_ew(node, "log"):
        return False
    inner = node.inputs[0].owner
    if inner is None or not _is_ew(inner, "erfc"):
        return False
    x = inner.inputs[0]
    if x.type.dtype.startswith(("int", "uint", "bool")):
        return False
    if _is_clamped_min(x):
        return False
    T = _erfc_thresholds(node.outputs[0].type.dtype)
    xs = tm.minimum(x, T)
    x2 = tm.sqr(x)
    stab = (-x2 - tm.log(tm.abs(x) + 1e-300) - 0.5 * float(np.log(np.pi))
            + tm.log1p(-1 / (2 * x2) + 3 / (4 * tm.sqr(x2))
                       - 15 / (8 * x2 * tm.sqr(x2))))
    res = tm.switch(x < T, tm.log(tm.erfc(xs)), stab)
    res = _same_type_out(node, res)
    return [res] if res is not None else False


register_stabilize(local_log_erfc, name="local_log_erfc")


def _is_neg_sqr_of(t, x):
    """True when t == -(x**2) structurally: flattens nested neg/mul
    trees and constant -1 factors, accepting sqr(x) or x*x as the
    square (grad graphs spell ``-i*i`` as mul(neg(x), x))."""
    if t.owner is None:
        return False
    sign = 1.0
    stack = [t]
    factors = []
    for _ in range(16):
        if not stack:
            break
        v = stack.pop()
        if v.owner is not None and _is_ew(v.owner, "neg"):
            sign = -sign
            stack.append(v.owner.inputs[0])
        elif v.owner is not None and _is_ew(v.owner, "mul"):
            stack.extend(v.owner.inputs)
        else:
            c = _unique_value(v)
            if c is not None:
                if float(c) not in (1.0, -1.0):
                    return False
                sign *= float(c)
            else:
                factors.append(v)
    if stack or sign != -1.0:
        return False
    if len(factors) == 1:
        u = factors[0]
        return (u.owner is not None and _is_ew(u.owner, "sqr")
                and u.owner.inputs[0] is x)
    if len(factors) == 2:
        return factors[0] is x and factors[1] is x
    return False


@node_rewriter([Elemwise])
def local_grad_log_erfc_neg(fgraph, node):
    """([y*]exp(-x^2))/erfc(x) -> switch to the asymptotic
    sqrt(pi)*x/(1 - 1/(2x^2) + 3/(4x^4) - 15/(8x^6)) beyond the erfc
    underflow threshold (the grad of log(erfc(x));
    PyTensor's tensor/rewriting/math.py:3126)."""
    if not _is_ew(node, "true_div"):
        return False
    num, den = node.inputs
    if den.owner is None or not _is_ew(den.owner, "erfc"):
        return False
    x = den.owner.inputs[0]
    if _is_clamped_min(x) or x.type.dtype.startswith(("int", "uint", "bool")):
        return False
    # num = exp(t) or mul(y..., exp(t)) with t == -(x**2)
    y_factors = []
    exp_v = None
    if num.owner is not None and _is_ew(num.owner, "exp"):
        exp_v = num
    elif num.owner is not None and _is_ew(num.owner, "mul"):
        for i in num.owner.inputs:
            if exp_v is None and i.owner is not None \
                    and _is_ew(i.owner, "exp") \
                    and _is_neg_sqr_of(i.owner.inputs[0], x):
                exp_v = i
            else:
                y_factors.append(i)
    if exp_v is None or not _is_neg_sqr_of(exp_v.owner.inputs[0], x):
        return False
    T = _erfc_thresholds(x.type.dtype)
    xs = tm.minimum(x, T)
    safe = tm.exp(-tm.sqr(xs)) / tm.erfc(xs)
    x2 = tm.sqr(x)
    stab = (x * float(np.sqrt(np.pi))
            / (1 - 1 / (2 * x2) + 3 / (4 * tm.sqr(x2))
               - 15 / (8 * x2 * tm.sqr(x2))))
    core = tm.switch(x < T, safe, stab)
    if not y_factors:
        res = core
    else:
        y = y_factors[0] if len(y_factors) == 1 else tm.mul(*y_factors)
        res = y * core
    res = _same_type_out(node, res)
    return [res] if res is not None else False


register_stabilize(local_grad_log_erfc_neg, name="local_grad_log_erfc_neg")
register_specialize(local_grad_log_erfc_neg, name="local_grad_log_erfc_neg")


def _flat_mul_factors(v, depth=0):
    """Flatten nested mul/neg trees into (sign, [factors])."""
    if depth > 6 or v.owner is None:
        return 1.0, [v]
    if _is_ew(v.owner, "neg"):
        s, fs = _flat_mul_factors(v.owner.inputs[0], depth + 1)
        return -s, fs
    if _is_ew(v.owner, "mul"):
        sign = 1.0
        factors = []
        for i in v.owner.inputs:
            s, fs = _flat_mul_factors(i, depth + 1)
            sign *= s
            factors.extend(fs)
        return sign, factors
    return 1.0, [v]


@node_rewriter([Elemwise])
def local_grad_log_erfc_neg_mul(fgraph, node):
    """mul(..., true_div(y, erfc(x)), ..., exp(-x^2), ...) — the shape
    actual pullback graphs take (the exp factor multiplies OUTSIDE the
    division) — rewritten to the stabilized switch form.  Complements
    local_grad_log_erfc_neg, which needs the exp inside the numerator."""
    if not _is_ew(node, "mul"):
        return False
    sign, factors = _flat_mul_factors(node.outputs[0])
    div_i = exp_i = None
    x = None
    for i, f in enumerate(factors):
        if div_i is None and f.owner is not None \
                and _is_ew(f.owner, "true_div") \
                and f.owner.inputs[1].owner is not None \
                and _is_ew(f.owner.inputs[1].owner, "erfc"):
            cand = f.owner.inputs[1].owner.inputs[0]
            if not _is_clamped_min(cand) \
                    and not cand.type.dtype.startswith(("int", "uint",
                                                        "bool")):
                div_i, x = i, cand
    if div_i is None:
        return False
    for i, f in enumerate(factors):
        if i != div_i and f.owner is not None and _is_ew(f.owner, "exp") \
                and _is_neg_sqr_of(f.owner.inputs[0], x):
            exp_i = i
            break
    if exp_i is None:
        return False
    T = _erfc_thresholds(x.type.dtype)
    xs = tm.minimum(x, T)
    safe = tm.exp(-tm.sqr(xs)) / tm.erfc(xs)
    x2 = tm.sqr(x)
    stab = (x * float(np.sqrt(np.pi))
            / (1 - 1 / (2 * x2) + 3 / (4 * tm.sqr(x2))
               - 15 / (8 * x2 * tm.sqr(x2))))
    core = tm.switch(x < T, safe, stab)
    rest = [f for i, f in enumerate(factors) if i not in (div_i, exp_i)]
    num = factors[div_i].owner.inputs[0]
    if _unique_value(num) not in (1, 1.0):
        rest.append(num)
    res = core if not rest else tm.mul(*rest, core)
    if sign < 0:
        res = -res
    res = _same_type_out(node, res)
    return [res] if res is not None else False


register_stabilize(local_grad_log_erfc_neg_mul,
                   name="local_grad_log_erfc_neg_mul")
register_specialize(local_grad_log_erfc_neg_mul,
                    name="local_grad_log_erfc_neg_mul")


# ---------------------------------------------------------------------------
# sigmoid / exp specializations (PyTensor's local_reciprocal_1_plus_exp,
# local_sigm_times_exp, local_logit_sigmoid, odds-sigmoid patterns;
# pinned by PyTensor's tests/tensor/rewriting/test_math.py TestSigmoidRewrites)
# ---------------------------------------------------------------------------

@node_rewriter([Elemwise])
def local_reciprocal_1_plus_exp(fgraph, node):
    """reciprocal(1 + exp(x)) -> sigmoid(-x); c/(1 + exp(x)) with c = +-1
    -> +-sigmoid(-x)."""
    name = node.op.scalar_op.name
    if name == "reciprocal":
        den, c = node.inputs[0], 1.0
    elif name == "true_div" and len(node.inputs) == 2:
        c = _unique_value(node.inputs[0])
        if c is None or float(c) not in (1.0, -1.0):
            return False
        c = float(c)
        den = node.inputs[1]
    else:
        return False
    if den.owner is None or not _is_ew(den.owner, "add") \
            or len(den.owner.inputs) != 2:
        return False
    a, b = den.owner.inputs
    for one, e in ((a, b), (b, a)):
        if _unique_value(one) in (1, 1.0) and e.owner is not None \
                and _is_ew(e.owner, "exp"):
            x = e.owner.inputs[0]
            res = tm.sigmoid(-x) if c == 1.0 else -tm.sigmoid(-x)
            res = _same_type_out(node, res)
            return [res] if res is not None else False
    return False


register_stabilize(local_reciprocal_1_plus_exp,
                   name="local_reciprocal_1_plus_exp")
register_specialize(local_reciprocal_1_plus_exp,
                    name="local_reciprocal_1_plus_exp")


@node_rewriter([Elemwise])
def local_sigm_times_exp(fgraph, node):
    """sigmoid(-x) * exp(x) -> sigmoid(x); sigmoid(x) * exp(-x) ->
    sigmoid(-x) (pairwise inside a flat mul)."""
    if not _is_ew(node, "mul"):
        return False
    ins = list(node.inputs)
    sig_idx = [i for i, v in enumerate(ins)
               if v.owner is not None and _is_ew(v.owner, "sigmoid")]
    exp_idx = [i for i, v in enumerate(ins)
               if v.owner is not None and _is_ew(v.owner, "exp")]
    for si in sig_idx:
        s_arg = ins[si].owner.inputs[0]
        s_neg, s_core = _strip_neg(s_arg)
        for ei in exp_idx:
            e_arg = ins[ei].owner.inputs[0]
            e_neg, e_core = _strip_neg(e_arg)
            merged = None
            if s_neg and not e_neg and s_core is e_arg:
                merged = tm.sigmoid(e_arg)       # sig(-x)*exp(x)
            elif e_neg and not s_neg and e_core is s_arg:
                merged = tm.sigmoid(-s_arg)      # sig(x)*exp(-x)
            if merged is not None:
                rest = [v for i, v in enumerate(ins) if i not in (si, ei)]
                res = merged if not rest else tm.mul(*rest, merged)
                res = _same_type_out(node, res)
                return [res] if res is not None else False
    return False


register_stabilize(local_sigm_times_exp, name="local_sigm_times_exp")
register_specialize(local_sigm_times_exp, name="local_sigm_times_exp")


@node_rewriter([Elemwise])
def local_odds_sigmoid(fgraph, node):
    """sigmoid(x) / sigmoid(-x) -> exp(x)  (the odds ratio
    sigmoid/(1-sigmoid); 1-sigmoid has already been canonicalized to
    sigmoid(-x) by local_one_minus_sigmoid).  1 - sigmoid cancels to
    exactly 0 for x >~ 37 so the unrewritten ratio hits inf long before
    exp(x) overflows."""
    if not _is_ew(node, "true_div"):
        return False
    num, den = node.inputs
    if num.owner is None or den.owner is None \
            or not _is_ew(num.owner, "sigmoid") \
            or not _is_ew(den.owner, "sigmoid"):
        return False
    a = num.owner.inputs[0]
    b = den.owner.inputs[0]
    a_neg, a_core = _strip_neg(a)
    b_neg, b_core = _strip_neg(b)
    if (b_neg and not a_neg and b_core is a) \
            or (a_neg and not b_neg and a_core is b):
        res = _same_type_out(node, tm.exp(a))
        return [res] if res is not None else False
    return False


register_specialize(local_odds_sigmoid, name="local_odds_sigmoid")
register_stabilize(local_odds_sigmoid, name="local_odds_sigmoid")


@node_rewriter([Elemwise])
def local_sigmoid_of_logit(fgraph, node):
    """sigmoid(log(x / (1 - x))) -> x (also via logit())."""
    if not _is_ew(node, "sigmoid"):
        return False
    inner = node.inputs[0].owner
    if inner is not None and _is_ew(inner, "logit"):
        res = _same_type_out(node, inner.inputs[0])
        return [res] if res is not None else False
    if inner is None or not _is_ew(inner, "log"):
        return False
    div = inner.inputs[0].owner
    if div is None or not _is_ew(div, "true_div"):
        return False
    x, den = div.inputs
    d = den.owner
    if d is not None and _is_ew(d, "sub") and len(d.inputs) == 2 \
            and _unique_value(d.inputs[0]) in (1, 1.0) \
            and d.inputs[1] is x:
        res = _same_type_out(node, x)
        return [res] if res is not None else False
    return False


register_specialize(local_sigmoid_of_logit, name="local_sigmoid_of_logit")


@node_rewriter([Elemwise])
def local_logit_of_sigmoid(fgraph, node):
    """log(sigmoid(x) / sigmoid(-x)) -> x; logit(sigmoid(x)) -> x."""
    name = node.op.scalar_op.name
    if name == "logit":
        inner = node.inputs[0].owner
        if inner is not None and _is_ew(inner, "sigmoid"):
            res = _same_type_out(node, inner.inputs[0])
            return [res] if res is not None else False
        return False
    if name != "log":
        return False
    inner = node.inputs[0].owner
    if inner is not None and _is_ew(inner, "exp"):
        # log(exp(x)) -> x: covered by local_log_exp; skip
        return False
    return False


register_specialize(local_logit_of_sigmoid, name="local_logit_of_sigmoid")


# ---------------------------------------------------------------------------
# log/exp stabilizations (PyTensor's local_logdiffexp, log_kv/log_iv
# stabilization, log/sign of reciprocal and constant divisions)
# ---------------------------------------------------------------------------

@node_rewriter([Elemwise])
def local_logdiffexp(fgraph, node):
    """log(exp(x) - exp(y)) -> x + log1mexp(y - x)."""
    if not _is_ew(node, "log"):
        return False
    inner = node.inputs[0].owner
    if inner is None or not _is_ew(inner, "sub") or len(inner.inputs) != 2:
        return False
    ex, ey = inner.inputs
    if ex.owner is None or ey.owner is None \
            or not _is_ew(ex.owner, "exp") or not _is_ew(ey.owner, "exp"):
        return False
    x = ex.owner.inputs[0]
    y = ey.owner.inputs[0]
    res = _same_type_out(node, x + tm.log1mexp(y - x))
    return [res] if res is not None else False


register_stabilize(local_logdiffexp, name="local_logdiffexp")


@node_rewriter([Elemwise])
def local_log_kv_iv(fgraph, node):
    """log(kv(v, x)) -> log(kve(v, x)) - x (kv underflows ~700 for f64);
    log(iv(v, x)) -> log(ive(v, x)) + x (iv overflows)."""
    if not _is_ew(node, "log"):
        return False
    inner = node.inputs[0].owner
    if inner is None:
        return False
    if _is_ew(inner, "kv"):
        v, x = inner.inputs
        res = _same_type_out(node, tm.log(tm.kve(v, x)) - x)
        return [res] if res is not None else False
    if _is_ew(inner, "iv"):
        v, x = inner.inputs
        res = _same_type_out(node, tm.log(tm.ive(v, x)) + x)
        return [res] if res is not None else False
    return False


register_stabilize(local_log_kv_iv, name="local_log_kv_iv")


def _pos_const(v):
    c = _unique_value(v)
    if c is None:
        return None
    c = float(c)
    return c if c > 0 else None


@node_rewriter([Elemwise])
def local_log_reciprocal_or_div_const(fgraph, node):
    """log(1/x) -> -log(x); log(c/x) -> log(c) - log(x) (c > 0 const);
    log(x/c) -> log(x) - log(c)."""
    if not _is_ew(node, "log"):
        return False
    inner = node.inputs[0].owner
    if inner is None:
        return False
    if _is_ew(inner, "reciprocal"):
        res = _same_type_out(node, -tm.log(inner.inputs[0]))
        return [res] if res is not None else False
    if _is_ew(inner, "true_div") and len(inner.inputs) == 2:
        num, den = inner.inputs
        out_dt = node.outputs[0].type.dtype
        cn = _pos_const(num)
        if cn is not None:
            if cn == 1.0:
                res = -tm.log(den)
            else:
                # fold the constant's log at the OUTPUT dtype (a bare
                # Python float would round through floatX=float32)
                res = np.asarray(np.log(np.float64(cn)),
                                 dtype=out_dt) - tm.log(den)
            res = _same_type_out(node, res)
            return [res] if res is not None else False
        cd = _pos_const(den)
        if cd is not None:
            res = tm.log(num) - np.asarray(np.log(np.float64(cd)),
                                           dtype=out_dt)
            res = _same_type_out(node, res)
            return [res] if res is not None else False
    return False


register_stabilize(local_log_reciprocal_or_div_const,
                   name="local_log_reciprocal_or_div_const")
register_specialize(local_log_reciprocal_or_div_const,
                    name="local_log_reciprocal_or_div_const")


@node_rewriter([Elemwise])
def local_sign_reciprocal_or_div_const(fgraph, node):
    """sign(1/x) -> sign(x); sign(c/x) -> sign(c)*sign(x);
    sign(x/c) -> sign(c)*sign(x) (c a nonzero constant)."""
    if not _is_ew(node, "sign"):
        return False
    inner = node.inputs[0].owner
    if inner is None:
        return False
    if _is_ew(inner, "reciprocal"):
        res = _same_type_out(node, tm.sign(inner.inputs[0]))
        return [res] if res is not None else False
    if _is_ew(inner, "true_div") and len(inner.inputs) == 2:
        num, den = inner.inputs
        for c_v, other in ((num, den), (den, num)):
            c = _unique_value(c_v)
            if c is not None and float(c) != 0.0:
                s = tm.sign(other)
                res = s if float(c) > 0 else -s
                res = _same_type_out(node, res)
                return [res] if res is not None else False
    return False


register_specialize(local_sign_reciprocal_or_div_const,
                    name="local_sign_reciprocal_or_div_const")
register_stabilize(local_sign_reciprocal_or_div_const,
                   name="local_sign_reciprocal_or_div_const")


# ---------------------------------------------------------------------------
# add/sub-of-neg specializations and sqr/sqrt inverses
# ---------------------------------------------------------------------------

@node_rewriter([Elemwise])
def local_sub_neg_to_add(fgraph, node):
    """x - (-y) -> x + y."""
    if not _is_ew(node, "sub") or len(node.inputs) != 2:
        return False
    x, y = node.inputs
    if y.owner is not None and _is_ew(y.owner, "neg"):
        res = _same_type_out(node, x + y.owner.inputs[0])
        return [res] if res is not None else False
    return False


register_canonicalize(local_sub_neg_to_add, name="local_sub_neg_to_add")


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


@node_rewriter([Elemwise])
def local_sqr_of_sqrt(fgraph, node):
    """sqr(sqrt(x)) -> switch(x >= 0, x, nan) (preserves the sqrt's
    domain error signal)."""
    if not _is_ew(node, "sqr"):
        return False
    inner = node.inputs[0].owner
    if inner is not None and _is_ew(inner, "sqrt"):
        x = inner.inputs[0]
        res = tm.switch(tm.ge(x, 0), x,
                        np.asarray(np.nan, dtype=node.outputs[0].type.dtype))
        res = _same_type_out(node, res)
        return [res] if res is not None else False
    return False


register_specialize(local_sqr_of_sqrt, name="local_sqr_of_sqrt")


# ---------------------------------------------------------------------------
# exp/expm1 of the log family -> closed form guarded by a domain nan-switch
# (reference rewriting/math.py local_exp_log_nan_switch)
# ---------------------------------------------------------------------------

@node_rewriter([Elemwise])
def local_exp_of_log_nan_switch(fgraph, node):
    """exp/expm1(log|log1p|log1mexp(x)) -> closed form wrapped in
    switch(<domain>, value, nan) preserving the inner log's domain error;
    exp/expm1(softplus(x)) -> 1+exp(x) / exp(x) needs no guard
    (reference local_exp_log_nan_switch + local_exp_log)."""
    name = node.op.scalar_op.name
    if name not in ("exp", "expm1"):
        return False
    inner = node.inputs[0].owner
    if inner is None or not isinstance(inner.op, Elemwise):
        return False
    iname = inner.op.scalar_op.name
    if iname not in ("log", "log1p", "log1mexp", "softplus"):
        return False
    x = inner.inputs[0]
    nan = np.asarray(np.nan, dtype=node.outputs[0].type.dtype)
    if iname == "softplus":
        res = 1 + tm.exp(x) if name == "exp" else tm.exp(x)
    elif iname == "log":
        val = x if name == "exp" else x - 1
        res = tm.switch(tm.ge(x, 0), val, nan)
    elif iname == "log1p":
        val = x + 1 if name == "exp" else x
        res = tm.switch(tm.ge(x, -1), val, nan)
    else:  # log1mexp
        val = 1 - tm.exp(x) if name == "exp" else -tm.exp(x)
        res = tm.switch(tm.le(x, 0), val, nan)
    res = _same_type_out(node, res)
    return [res] if res is not None else False


register_specialize(local_exp_of_log_nan_switch, name="local_exp_log_nan_switch")


@node_rewriter([Elemwise])
def local_logexp_of_log_nan_switch(fgraph, node):
    """softplus(log(x)) -> log1p(x); log1mexp(log(x)) -> log1p(-x);
    log1mexp(log1mexp(x)) -> x — each guarded by the inner log's domain
    nan-switch (reference local_exp_log_nan_switch tail cases)."""
    name = node.op.scalar_op.name
    if name not in ("softplus", "log1mexp"):
        return False
    inner = node.inputs[0].owner
    if inner is None or not isinstance(inner.op, Elemwise):
        return False
    iname = inner.op.scalar_op.name
    x = inner.inputs[0]
    nan = np.asarray(np.nan, dtype=node.outputs[0].type.dtype)
    if iname == "log":
        val = tm.log1p(x) if name == "softplus" else tm.log1p(-x)
        res = tm.switch(tm.ge(x, 0), val, nan)
    elif iname == "log1mexp" and name == "log1mexp":
        res = tm.switch(tm.le(x, 0), x, nan)
    else:
        return False
    res = _same_type_out(node, res)
    return [res] if res is not None else False


register_specialize(local_logexp_of_log_nan_switch,
                    name="local_logexp_log_nan_switch")


@node_rewriter([Elemwise])
def local_pow_to_nested_squaring(fgraph, node):
    """pow(x, integer const n) with 2 < |n| <= 512 -> binary-exponentiation
    multiply/square chain (reference local_pow_to_nested_squaring): about
    log2(n) multiplies in place of a pow."""
    if not _is_ew(node, "pow"):
        return False
    x, y = node.inputs
    u = _unique_value(y)
    if u is None:
        return False
    try:
        f = float(u)
    except (TypeError, ValueError):
        return False
    if not f.is_integer():
        return False
    n = int(f)
    if not (2 < abs(n) <= 512):
        return False
    if n < 0 and x.type.dtype.startswith(("int", "uint")):
        # numpy raises on negative integer powers of ints; keep the pow so
        # the oracle raises identically
        return False
    m = abs(n)
    pow2 = x
    result = None
    while m:
        if m & 1:
            result = pow2 if result is None else result * pow2
        m >>= 1
        if m:
            pow2 = tm.sqr(pow2)
    if n < 0:
        result = tm.reciprocal(result)
    res = _same_type_out(node, result)
    return [res] if res is not None else False


register_specialize(local_pow_to_nested_squaring,
                    name="local_pow_to_nested_squaring")


@node_rewriter([Elemwise])
def local_mul_minus_one(fgraph, node):
    """mul(..., -1, ...) -> +-neg(mul(rest)) (reference
    local_mul_specialize's -1 case)."""
    if not _is_ew(node, "mul"):
        return False
    negs, rest, changed = 0, [], False
    for i in node.inputs:
        u = _unique_value(i)
        if u is not None and u == -1:
            negs += 1
            changed = True
        else:
            rest.append(i)
    if not changed or not rest:
        return False
    res = rest[0] if len(rest) == 1 else tm.mul(*rest)
    if negs % 2:
        res = tm.neg(res)
    res = _same_type_out(node, res)
    return [res] if res is not None else False


register_specialize(local_mul_minus_one, name="local_mul_minus_one")


# ---------------------------------------------------------------------------
# polygamma specialization + x/abs(x) -> sign(x)
# ---------------------------------------------------------------------------

@node_rewriter([Elemwise])
def local_polygamma_specialize(fgraph, node):
    """polygamma(0, x) -> psi(x); polygamma(1, x) -> tri_gamma(x)
    (cheaper dedicated kernels)."""
    if not _is_ew(node, "polygamma"):
        return False
    n, x = node.inputs
    c = _unique_value(n)
    if c is None:
        return False
    if int(c) == 0:
        res = _same_type_out(node, tm.psi(x))
    elif int(c) == 1:
        res = _same_type_out(node, tm.tri_gamma(x))
    else:
        return False
    return [res] if res is not None else False


register_specialize(local_polygamma_specialize,
                    name="local_polygamma_specialize")


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


# ---------------------------------------------------------------------------
# switch merging, zero/one division, pow grouping, functional inverses,
# shape-vs-zero comparisons, reduce-of-join (reference
# local_merge_switch_same_cond, local_zero_div, local_div_by_one,
# local_mul_pow_to_pow_add, local_func_inv, local_useless_elemwise_
# comparison shape cases, local_reduce_join)
# ---------------------------------------------------------------------------

@node_rewriter([Elemwise])
def local_merge_switch_same_cond(fgraph, node):
    """op(switch(c, a, b), switch(c, x, y), ...) ->
    switch(c, op(a, x, ...), op(b, y, ...)): one select instead of N."""
    name = node.op.scalar_op.name
    if name == "switch":
        return False
    cond = None
    n_switch = 0
    for i in node.inputs:
        if i.owner is not None and _is_ew(i.owner, "switch"):
            if cond is None:
                cond = i.owner.inputs[0]
                n_switch = 1
            elif i.owner.inputs[0] is cond:
                n_switch += 1
    if cond is None or n_switch < 2:
        return False
    trues, falses = [], []
    for i in node.inputs:
        if i.owner is not None and _is_ew(i.owner, "switch") \
                and i.owner.inputs[0] is cond:
            trues.append(i.owner.inputs[1])
            falses.append(i.owner.inputs[2])
        else:
            trues.append(i)
            falses.append(i)
    op = node.op
    res = tm.switch(cond, op(*trues), op(*falses))
    res = _same_type_out(node, res)
    return [res] if res is not None else False


register_canonicalize(local_merge_switch_same_cond,
                      name="local_merge_switch_same_cond")


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


@node_rewriter([Elemwise])
def local_log_neg_expm1(fgraph, node):
    """log(-expm1(x)) -> log1mexp(x) (also reaches log(-(exp(x)-1))
    after expm1 canonicalization)."""
    if not _is_ew(node, "log"):
        return False
    inner = node.inputs[0].owner
    if inner is None or not _is_ew(inner, "neg"):
        return False
    em = inner.inputs[0].owner
    if em is None or not _is_ew(em, "expm1"):
        return False
    res = _same_type_out(node, tm.log1mexp(em.inputs[0]))
    return [res] if res is not None else False


register_stabilize(local_log_neg_expm1, name="local_log_neg_expm1")


# functional-inverse pairs: outer(inner(x)) == x on the inner's range.
# Only pairs that are true inverses for all real inputs the INNER op
# accepts (matching the reference's local_func_inv table).
_INVERSE_PAIRS = {
    ("deg2rad", "rad2deg"), ("rad2deg", "deg2rad"),
    ("cosh", "arccosh"), ("arcsinh", "sinh"), ("sinh", "arcsinh"),
    ("arctanh", "tanh"), ("tanh", "arctanh"),
    ("neg", "neg"), ("reciprocal", "reciprocal"),
    ("conj", "conj"), ("arccosh", "cosh"),
    ("log1p", "expm1"), ("expm1", "log1p"),
}


@node_rewriter([Elemwise])
def local_func_inverse(fgraph, node):
    """outer(inner(x)) -> x for functional-inverse pairs (deg2rad/
    rad2deg, sinh/arcsinh, tanh/arctanh, cosh/arccosh, log1p/expm1,
    self-inverses)."""
    name = node.op.scalar_op.name
    inner = node.inputs[0].owner if node.inputs else None
    if inner is None or not isinstance(inner.op, Elemwise):
        return False
    pair = (name, inner.op.scalar_op.name)
    if pair not in _INVERSE_PAIRS:
        return False
    x = inner.inputs[0]
    out = node.outputs[0]
    if x.type.dtype != out.type.dtype:
        # float(int) round trips are exact for the small table above;
        # keep the float output dtype
        x = cast(x, out.type.dtype)
    res = _same_type_out(node, x)
    return [res] if res is not None else False


register_specialize(local_func_inverse, name="local_func_inverse")


@node_rewriter([Elemwise])
def local_xor_self(fgraph, node):
    """xor(x, x) -> 0."""
    if node.op.scalar_op.name != "xor" or len(node.inputs) != 2:
        return False
    x, y = node.inputs
    if x is not y:
        return False
    from pytensor_tpu_torch.tensor.basic import zeros_like

    res = _same_type_out(node, zeros_like(x))
    return [res] if res is not None else False


register_canonicalize(local_xor_self, name="local_xor_self")


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


@node_rewriter([Elemwise])
def local_mul_pow_to_pow_add(fgraph, node):
    """a^x * a^y -> a^(x+y) inside a flat mul, grouping repeated bases
    (and composing with the exp grouping)."""
    if not _is_ew(node, "mul") or len(node.inputs) < 2:
        return False
    groups = {}
    others = []
    order = []
    for i in node.inputs:
        if i.owner is not None and _is_ew(i.owner, "pow"):
            base, expo = i.owner.inputs
            key = id(base)
            if key not in groups:
                groups[key] = (base, [])
                order.append(key)
            groups[key][1].append(expo)
        else:
            others.append(i)
    if not any(len(exps) > 1 for _, exps in groups.values()):
        return False
    factors = list(others)
    for key in order:
        base, exps = groups[key]
        factors.append(base ** (exps[0] if len(exps) == 1 else tm.add(*exps)))
    res = factors[0] if len(factors) == 1 else tm.mul(*factors)
    res = _same_type_out(node, res)
    return [res] if res is not None else False


register_specialize(local_mul_pow_to_pow_add, name="local_mul_pow_to_pow_add")


@node_rewriter([CAReduce])
def local_reduce_join(fgraph, node):
    """reduce(join(0, a[None], b[None], ...), axis=0) -> elemwise
    op(a, b, ...) for sum/prod/max/min: no concat buffer (reference
    local_reduce_join)."""
    if node.op.axis not in ((0,),):
        return False
    name = node.op.scalar_op.name
    if name not in ("add", "mul", "maximum", "minimum"):
        return False
    j = node.inputs[0]
    from pytensor_tpu_torch.tensor.basic import Join

    if j.owner is None or not isinstance(j.owner.op, Join):
        return False
    ax = j.owner.inputs[0]
    ax_c = _unique_value(ax)
    if ax_c is None or int(ax_c) != 0:
        return False
    parts = []
    for p in j.owner.inputs[1:]:
        # each part must be a length-1 slab along axis 0:
        # expand_dims (DimShuffle x->(1,...)) or static shape[0] == 1
        if p.owner is not None and isinstance(p.owner.op, DimShuffle) \
                and p.owner.op.new_order[0] == "x":
            inner = p.owner.inputs[0]
            if p.owner.op.new_order[1:] == tuple(range(inner.type.ndim)):
                parts.append(inner)
                continue
        if p.type.shape[0] == 1:
            parts.append(p[0])
            continue
        return False
    if len(parts) < 2:
        return False
    fn = {"add": tm.add, "mul": tm.mul,
          "maximum": tm.maximum, "minimum": tm.minimum}[name]
    res = fn(*parts)
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype:
        res = cast(res, out.type.dtype)
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_reduce_join, name="local_reduce_join")


# ---------------------------------------------------------------------------
# dot-to-mul and sumsqr-to-dot (reference rewriting/math.py local_dot_to_mul
# :456, local_sumsqr2dot:763; pinned by tests/tensor/rewriting/test_math.py)
# ---------------------------------------------------------------------------

def _dot_to_mul_tracks():
    from pytensor_tpu_torch.tensor.blockwise import Blockwise
    from pytensor_tpu_torch.tensor.math import Dot

    return [Blockwise, Dot]


@node_rewriter(_dot_to_mul_tracks())
def local_dot_to_mul(fgraph, node):
    """dot(a (..,m,1), b (..,1,n)) with a length-1 contracted dim ->
    broadcast mul: no summation happens, and the elemwise form fuses.
    Core (unbatched) outer products are kept as Dot (one product call;
    mul would materialize the full (m, n) intermediate for any consumer
    chain), as in the JAX package."""
    from pytensor_tpu_torch.tensor.blockwise import Blockwise
    from pytensor_tpu_torch.tensor.math import Dot

    op = node.op
    if isinstance(op, Blockwise):
        if not isinstance(op.core_op, Dot) \
                or op.signature != "(m,k),(k,n)->(m,n)":
            return False
        batched = True
    elif isinstance(op, Dot):
        batched = False
    else:
        return False
    a, b = node.inputs
    if a.type.ndim < 2 or b.type.ndim < 2:
        return False
    a_shape = a.type.shape
    b_shape = b.type.shape
    if not (a_shape[-1] == 1 or b_shape[-2] == 1):
        return False
    if not batched and not (a_shape[-2] == 1 or b_shape[-1] == 1):
        # unbatched outer product: keep as Dot (see docstring)
        return False
    from pytensor_tpu_torch.tensor.shape import specify_shape

    if a_shape[-1] != 1:
        a = specify_shape(a, (None,) * (a.type.ndim - 1) + (1,))
    if b_shape[-2] != 1:
        b = specify_shape(b, (None,) * (b.type.ndim - 2) + (1, None))
    out = node.outputs[0]
    res = tm.mul(a, b)
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_canonicalize(local_dot_to_mul, name="local_dot_to_mul")
register_specialize(local_dot_to_mul, name="local_dot_to_mul")


@node_rewriter([CAReduce])
def local_sumsqr2dot(fgraph, node):
    """sqr(W.dimshuffle('x',0,1) * G.dimshuffle(0,'x',1)).sum(axis=(1,2))
    -> dot(sqr(G), sqr(W).sum(axis=0)): the (n, r, c) broadcast product
    never materializes (reference local_sumsqr2dot)."""
    if node.op.scalar_op.name != "add" or node.op.axis != (1, 2):
        return False
    sq = node.inputs[0]
    if sq.owner is None or not _is_ew(sq.owner, "sqr"):
        return False
    m = sq.owner.inputs[0]
    if m.owner is None or not _is_ew(m.owner, "mul") \
            or len(m.owner.inputs) != 2:
        return False
    W = G = None
    for v in m.owner.inputs:
        if v.owner is not None and isinstance(v.owner.op, DimShuffle):
            order = v.owner.op.new_order
            if order == ("x", 0, 1):
                W = v.owner.inputs[0]
            elif order == (0, "x", 1):
                G = v.owner.inputs[0]
    if W is None or G is None:
        return False
    from pytensor_tpu_torch.tensor.math import _dot

    res = _dot(tm.sqr(G), tm.sqr(W).sum(axis=0))
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype:
        res = cast(res, out.type.dtype)
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_sumsqr2dot, name="local_sumsqr2dot")
