"""Graph-to-graph reverse-mode differentiation.

Counterpart of ``pytensor_tpu/gradient.py`` (PyTensor's gradient.py
grad:568, pullback:452), cut to ``grad``, ``pullback``, ``jacobian``
(rows batched by ``vectorize_graph``), ``hessian``,
``hessian_vector_product``, ``verify_grad`` with ``numeric_grad``, the
gradient-manipulating ops (``gradient.py:447-517``: ZeroGrad,
DisconnectedGrad, UndefinedGrad, GradClip, GradScale, identities in the
forward pass), forward mode as the JAX package builds it (``pushforward``
as the double pullback, ``:331-359``, with ``Rop`` and ``Lop`` its
aliases and ``Rop_via_pushforward`` for the ops' ``R_op``),
``subgraph_grad`` and ``as_list_or_tuple``.  Everything
stays in graph land: grad() returns symbolic graphs built from per-Op
L_op rules, so ``dlogp`` is a graph the rewrites and the linker see like
any other.
"""

from __future__ import annotations


import numpy as np

from pytensor_tpu_torch.config import config
from pytensor_tpu_torch.graph.basic import Apply, Variable
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.graph.null_type import DisconnectedType, NullType
from pytensor_tpu_torch.graph.traversal import io_toposort
from pytensor_tpu_torch.utils import dtype_kind


class GradientError(Exception):
    pass


class DisconnectedInputError(ValueError):
    pass


class NullTypeGradError(TypeError):
    pass


def grad_undefined(op, x_pos, x, comment=""):
    """Gradient formally undefined wrt this input."""
    return NullType(
        f"Gradient of {op} wrt input {x_pos} ({x}) is undefined: {comment}"
    )()


def grad_not_implemented(op, x_pos, x, comment=""):
    return NullType(
        f"Gradient of {op} wrt input {x_pos} ({x}) is not implemented: {comment}"
    )()


def _is_disconnected(g) -> bool:
    return g is not None and isinstance(getattr(g, "type", None), DisconnectedType)


def _is_null(g) -> bool:
    return g is not None and isinstance(getattr(g, "type", None), NullType)


def _zeros_like_var(v):
    from pytensor_tpu_torch.tensor.basic import as_tensor_variable, zeros_like
    from pytensor_tpu_torch.tensor.type import TensorType, discrete_dtypes

    if isinstance(v.type, TensorType):
        if v.type.dtype in discrete_dtypes:
            return zeros_like(v, dtype=config.floatX)
        return zeros_like(v)
    # non-tensor types (RNG etc.) get disconnected
    return DisconnectedType()()


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def grad(
    cost,
    wrt,
    consider_constant=None,
    disconnected_inputs: str = "raise",
    add_names: bool = True,
    known_grads: dict | None = None,
    return_disconnected: str = "zero",
    null_gradients: str = "raise",
):
    """Symbolic gradient of ``cost`` (0-d) wrt each variable in ``wrt``."""
    from pytensor_tpu_torch.tensor.basic import as_tensor_variable, ones_like
    from pytensor_tpu_torch.tensor.type import TensorType

    one_wrt = isinstance(wrt, Variable)
    wrt_list = _as_list(wrt)
    for w in wrt_list:
        if not isinstance(w, Variable):
            raise TypeError(f"wrt elements must be Variables, got {type(w)}")

    if cost is not None and isinstance(cost.type, TensorType) and cost.type.ndim != 0:
        raise TypeError("cost must be a scalar (0-d tensor)")
    if cost is None and not known_grads:
        raise ValueError("grad needs a cost or known_grads")

    grad_dict: dict[Variable, Variable] = {}
    outputs = []
    if cost is not None:
        g_cost = ones_like(cost)
        if dtype_kind(g_cost.type.dtype) in "biu":
            from pytensor_tpu_torch.tensor.basic import cast

            g_cost = cast(g_cost, config.floatX)
        grad_dict[cost] = g_cost
        outputs.append(cost)
    if known_grads:
        for var, g in known_grads.items():
            grad_dict[var] = as_tensor_variable(g)
            outputs.append(var)

    consider_constant = set(_as_list(consider_constant))

    return _populate_and_collect(
        outputs, wrt_list, grad_dict, consider_constant,
        disconnected_inputs, return_disconnected, null_gradients,
        add_names, cost, one_wrt,
    )


def _populate_and_collect(
    outputs, wrt_list, grad_dict, consider_constant,
    disconnected_inputs, return_disconnected, null_gradients,
    add_names, cost, one_wrt,
):
    from pytensor_tpu_torch.tensor.basic import as_tensor_variable, cast
    from pytensor_tpu_torch.tensor.type import TensorType, discrete_dtypes

    # forward dependence on wrt
    nodes = io_toposort([], outputs)
    depends: dict[Variable, bool] = {w: True for w in wrt_list}

    def var_depends(v):
        return depends.get(v, False)

    for node in nodes:
        node_dep = any(var_depends(i) for i in node.inputs)
        for o in node.outputs:
            if o not in depends:
                depends[o] = node_dep

    # reverse accumulation
    def accumulate(var, g):
        if _is_disconnected(g):
            return
        cur = grad_dict.get(var)
        if cur is None or _is_disconnected(cur):
            grad_dict[var] = g
        elif _is_null(cur) or _is_null(g):
            grad_dict[var] = g if _is_null(g) else cur
        else:
            grad_dict[var] = cur + g

    for node in reversed(nodes):
        if not any(o in grad_dict for o in node.outputs):
            continue
        if not any(var_depends(i) or i in wrt_list for i in node.inputs):
            continue
        if any(i in consider_constant for i in node.outputs):
            continue
        ogs = []
        all_disc = True
        for o in node.outputs:
            g = grad_dict.get(o)
            if g is None or _is_disconnected(g):
                ogs.append(DisconnectedType()())
            else:
                all_disc = False
                ogs.append(g)
        if all_disc:
            continue
        # replace disconnected output grads with zeros so L_op rules can be
        # written without Disconnected handling
        ogs_filled = []
        for o, g in zip(node.outputs, ogs):
            if _is_disconnected(g):
                z = _zeros_like_var(o)
                ogs_filled.append(z if not _is_disconnected(z) else g)
            else:
                ogs_filled.append(g)
        # Null output-grad propagation (reference gradient.py:1354-1360):
        # L_op never sees a NullType cotangent (it is replaced by zeros);
        # afterwards any input grad that is not Disconnected and whose
        # input is connected (per connection_pattern) to a null output
        # grad is overridden with that null.
        null_idx = [j for j, g in enumerate(ogs_filled) if _is_null(g)]
        null_conn = None
        if null_idx:
            try:
                conn = node.op.connection_pattern(node)
            except Exception:
                conn = None
            null_conn = [
                next((ogs_filled[j] for j in null_idx
                      if conn is None or conn[i][j]), None)
                for i in range(len(node.inputs))
            ]
            filled2 = []
            for o, g in zip(node.outputs, ogs_filled):
                if _is_null(g):
                    z = _zeros_like_var(o)
                    filled2.append(z if not _is_disconnected(z)
                                   else DisconnectedType()())
                else:
                    filled2.append(g)
            ogs_filled = filled2
        try:
            igs = node.op.L_op(node.inputs, node.outputs, ogs_filled)
        except NotImplementedError:
            igs = [grad_not_implemented(node.op, i, inp)
                   for i, inp in enumerate(node.inputs)]
        if len(igs) != len(node.inputs):
            raise ValueError(
                f"{node.op}.L_op returned {len(igs)} gradients for "
                f"{len(node.inputs)} inputs"
            )
        if null_conn is not None:
            igs = [
                ng if (ng is not None and g is not None
                       and not _is_disconnected(g)) else g
                for g, ng in zip(igs, null_conn)
            ]
        for inp, g in zip(node.inputs, igs):
            if g is None:
                g = DisconnectedType()()
            # NOTE consider_constant stops propagation THROUGH a variable
            # (the node-output guard above), but its own accumulated
            # gradient is still collected — subgraph_grad's end-grads and
            # the reference's consider_constant semantics rely on this
            if not (var_depends(inp) or inp in wrt_list or inp.owner is not None):
                # gradient wrt a leaf we don't need — skip accumulation for
                # leaves unrelated to wrt to keep graphs lean
                if inp not in wrt_list:
                    pass
            if _is_null(g):
                accumulate(inp, g)
                continue
            if _is_disconnected(g):
                continue
            if isinstance(inp.type, TensorType) and isinstance(
                getattr(g, "type", None), TensorType
            ):
                if inp.type.dtype not in discrete_dtypes and g.type.dtype != inp.type.dtype:
                    g = cast(g, inp.type.dtype)
                if g.type.ndim != inp.type.ndim:
                    raise ValueError(
                        f"{node.op}.L_op returned a gradient of rank {g.type.ndim} "
                        f"for input of rank {inp.type.ndim}"
                    )
            accumulate(inp, g)

    # collect
    results = []
    for w in wrt_list:
        g = grad_dict.get(w)
        if g is not None and _is_null(g):
            if null_gradients == "raise":
                raise NullTypeGradError(
                    f"grad encountered a NaN-producing/undefined gradient for {w}: "
                    f"{g.type.why_null}"
                )
            results.append(g)
            continue
        if g is None or _is_disconnected(g):
            if disconnected_inputs == "raise" and g is None and not _depends_on(
                outputs, w
            ):
                raise DisconnectedInputError(
                    f"grad: cost is not a function of input {w} "
                    "(pass disconnected_inputs='ignore' to get zeros)"
                )
            if disconnected_inputs == "warn" and g is None:
                import warnings

                warnings.warn(f"grad: disconnected input {w}")
            if return_disconnected == "zero":
                results.append(_zeros_like_var(w))
            elif return_disconnected == "none":
                results.append(None)
            else:
                results.append(DisconnectedType()())
            continue
        results.append(g)

    if add_names and cost is not None:
        for w, r in zip(wrt_list, results):
            if r is not None and getattr(r, "name", None) is None and w.name is not None \
                    and isinstance(r, Variable):
                cost_name = cost.name or "cost"
                r.name = f"(d{cost_name}/d{w.name})"
    return results[0] if one_wrt else results


def _depends_on(outputs, w):
    from pytensor_tpu_torch.graph.traversal import ancestors

    return any(a is w for a in ancestors(outputs))


def pullback(outputs, inputs, output_grads=None, **kwargs):
    """vJp: gradients of sum(outputs * output_grads) wrt inputs."""
    from pytensor_tpu_torch.tensor.basic import as_tensor_variable

    outputs = _as_list(outputs)
    one = isinstance(inputs, Variable)
    inputs_l = _as_list(inputs)
    if output_grads is None:
        raise ValueError("pullback requires output_grads (the cotangents)")
    output_grads = [as_tensor_variable(g) for g in _as_list(output_grads)]
    known = dict(zip(outputs, output_grads))
    res = grad(cost=None, wrt=inputs_l, known_grads=known,
               disconnected_inputs=kwargs.get("disconnected_inputs", "raise"),
               return_disconnected=kwargs.get("return_disconnected", "zero"))
    return res[0] if one else res


def Lop(f, wrt, eval_points, **kwargs):
    """``pullback`` by its older name (PyTensor's gradient.py:544)."""
    return pullback(f, wrt, eval_points, **kwargs)


def pushforward(outputs, inputs, input_tangents, **kwargs):
    """The Jacobian-vector product of ``outputs`` at ``inputs`` along
    ``input_tangents``, as two pullbacks (PyTensor's
    pushforward_through_pullback:163): the pullback of dummy cotangents
    ``u`` is linear in ``u``, so the pullback of its inner product with the
    tangents, taken with respect to ``u``, is the product.  It holds for
    every op with an ``L_op``."""
    from pytensor_tpu_torch.graph.replace import graph_replace
    from pytensor_tpu_torch.tensor import math as tm
    from pytensor_tpu_torch.tensor.basic import as_tensor_variable

    one = isinstance(outputs, Variable)
    outputs_l = _as_list(outputs)
    inputs_l = _as_list(inputs)
    tangents = [as_tensor_variable(t) for t in _as_list(input_tangents)]

    u = [o.type() for o in outputs_l]
    vjps = grad(cost=None, wrt=inputs_l, known_grads=dict(zip(outputs_l, u)),
                disconnected_inputs="ignore", return_disconnected="zero")
    inner = None
    for g, t in zip(vjps, tangents):
        term = tm.sum(g * t)
        inner = term if inner is None else inner + term
    jvps = grad(cost=None, wrt=u, known_grads={inner: _ones_like_scalar(inner)},
                disconnected_inputs="ignore", return_disconnected="zero")
    # the value does not depend on u, but a shape-only reference (fill,
    # second) may keep u in the graph: the outputs, of the same types,
    # take its place
    jvps = graph_replace(jvps, dict(zip(u, outputs_l)), strict=False)
    return jvps[0] if one else jvps


# PyTensor's name for the same construction
pushforward_through_pullback = pushforward


def _ones_like_scalar(v):
    # a constant seed: ones_like(v) would keep the dummy cotangents' graph
    # in the product
    from pytensor_tpu_torch.tensor.basic import constant

    return constant(np.ones((), dtype=v.type.dtype))


def Rop(f, wrt, eval_points, **kwargs):
    """``pushforward`` by its older name (PyTensor's gradient.py:521)."""
    return pushforward(f, wrt, eval_points, **kwargs)


def Rop_via_pushforward(op, inputs, eval_points):
    """An op's ``R_op`` by ``pushforward`` of one application of it (an
    absent tangent is zero)."""
    node = op.make_node(*inputs)
    tangents = [ep if ep is not None else _zeros_like_var(i)
                for i, ep in zip(inputs, eval_points)]
    return _as_list(pushforward(node.outputs, list(inputs), tangents))


def jacobian(expression, wrt, consider_constant=None, disconnected_inputs="raise",
             vectorize=False):
    """Jacobian of a 0-d or 1-d ``expression``: row i is the gradient of
    ``expression[i]``, the rows batched over i by ``vectorize_graph``."""
    from pytensor_tpu_torch.graph.replace import vectorize_graph
    from pytensor_tpu_torch.tensor.basic import arange, as_tensor_variable
    from pytensor_tpu_torch.tensor.shape import shape
    from pytensor_tpu_torch.tensor.type import TensorType

    expression = as_tensor_variable(expression)
    one = isinstance(wrt, Variable)
    wrt_l = _as_list(wrt)
    if expression.type.ndim > 1:
        raise ValueError("jacobian expects a 0-d or 1-d expression")
    if expression.type.ndim == 0:
        res = grad(expression, wrt_l, consider_constant=consider_constant,
                   disconnected_inputs=disconnected_inputs)
        return res[0] if one else res
    idx = TensorType("int64", ())()
    row_grads = grad(expression[idx], wrt_l, consider_constant=consider_constant,
                     disconnected_inputs=disconnected_inputs)
    rows = vectorize_graph(row_grads, replace={idx: arange(shape(expression)[0])})
    return rows[0] if one else rows


def hessian(cost, wrt, consider_constant=None, disconnected_inputs="raise"):
    one = isinstance(wrt, Variable)
    wrt_l = _as_list(wrt)
    g = grad(cost, wrt_l, consider_constant=consider_constant,
             disconnected_inputs=disconnected_inputs)
    res = [jacobian(gi, wi, consider_constant=consider_constant,
                    disconnected_inputs=disconnected_inputs)
           for gi, wi in zip(g, wrt_l)]
    return res[0] if one else res


def hessian_vector_product(cost, wrt, p, **kwargs):
    """Hvp without materializing the Hessian: grad of <grad, p>."""
    from pytensor_tpu_torch.tensor import math as tm

    one = isinstance(wrt, Variable)
    wrt_l = _as_list(wrt)
    g = grad(cost, wrt_l, **kwargs)
    inner = None
    for gi, pi in zip(g, _as_list(p)):
        term = tm.sum(gi * disconnected_grad(pi))
        inner = term if inner is None else inner + term
    res = grad(inner, wrt_l, disconnected_inputs="ignore")
    return res[0] if one else res


# --- gradient-manipulation ops ---------------------------------------------

class GradManipulatorOp(Op):
    view_map = {0: [0]}

    def make_node(self, x):
        from pytensor_tpu_torch.tensor.basic import as_tensor_variable

        x = as_tensor_variable(x)
        return Apply(self, [x], [x.type()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = inputs[0]

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]


class ZeroGrad(GradManipulatorOp):
    __props__ = ()

    def L_op(self, inputs, outputs, output_grads):
        return [_zeros_like_var(inputs[0])]

    def R_op(self, inputs, eval_points):
        return [None]


class DisconnectedGrad(GradManipulatorOp):
    __props__ = ()

    def L_op(self, inputs, outputs, output_grads):
        return [DisconnectedType()()]

    def connection_pattern(self, node):
        return [[False]]


class UndefinedGrad(GradManipulatorOp):
    __props__ = ()

    def L_op(self, inputs, outputs, output_grads):
        return [grad_undefined(self, 0, inputs[0])]


class GradClip(GradManipulatorOp):
    __props__ = ("clip_lower_bound", "clip_upper_bound")

    def __init__(self, clip_lower_bound, clip_upper_bound):
        self.clip_lower_bound = float(clip_lower_bound)
        self.clip_upper_bound = float(clip_upper_bound)

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.tensor import math as tm

        return [tm.clip(output_grads[0], self.clip_lower_bound, self.clip_upper_bound)]


class GradScale(GradManipulatorOp):
    __props__ = ("multiplier",)

    def __init__(self, multiplier):
        self.multiplier = float(multiplier)

    def L_op(self, inputs, outputs, output_grads):
        return [self.multiplier * output_grads[0]]


zero_grad_ = ZeroGrad()
disconnected_grad_ = DisconnectedGrad()
undefined_grad_ = UndefinedGrad()


def zero_grad(x):
    return zero_grad_(x)


def disconnected_grad(x):
    return disconnected_grad_(x)


def undefined_grad(x):
    return undefined_grad_(x)


def grad_clip(x, lower_bound, upper_bound):
    return GradClip(lower_bound, upper_bound)(x)


def grad_scale(x, multiplier):
    return GradScale(multiplier)(x)


consider_constant = zero_grad  # legacy alias


# --- numerical verification -------------------------------------------------

class numeric_grad:
    """Central finite-difference gradient of ``f`` at ``pt`` (float64)."""

    def __init__(self, f, pt, eps=None):
        self.f = f
        self.pt = [np.asarray(p, dtype="float64") for p in pt]
        self.eps = eps = (1e-7 ** 0.5 * 10) if eps is None else eps
        self.gf = []
        for p in self.pt:
            g = np.zeros_like(p)
            flat, gflat = p.reshape(-1), g.reshape(-1)
            for j in range(flat.size):
                old = flat[j]
                flat[j] = old + eps
                f_plus = np.asarray(f(*self.pt), dtype="float64")
                flat[j] = old - eps
                f_minus = np.asarray(f(*self.pt), dtype="float64")
                flat[j] = old
                gflat[j] = np.sum(f_plus - f_minus) / (2 * eps)
            self.gf.append(g)


def verify_grad(fun, pt, n_tests=2, rng=None, eps=None, out_grad_dtype=None, abs_tol=None,
                rel_tol=None, mode=None, cast_to_output_dtype=False, no_debug_ref=True, *,
                device="cuda"):
    """Check the gradient of ``fun`` at ``pt`` against central finite
    differences of a random projection of its output to a scalar, as the
    JAX package's ``verify_grad`` does; raises ``GradientError`` on a
    mismatch.  The functions are compiled for ``device``."""
    import torch

    from pytensor_tpu_torch.compile.maker import function
    from pytensor_tpu_torch.tensor import math as tm
    from pytensor_tpu_torch.tensor.basic import as_tensor_variable
    from pytensor_tpu_torch.tensor.type import TensorType

    rng = np.random.default_rng(382354) if rng is None else rng
    abs_tol = 1e-4 if abs_tol is None else abs_tol
    rel_tol = 1e-4 if rel_tol is None else rel_tol
    pt = [np.asarray(p) for p in pt]
    sym_inputs = [TensorType("float64" if p.dtype.kind == "f" else str(p.dtype), p.shape)(f"v{i}")
                  for i, p in enumerate(pt)]
    pt = [p.astype("float64") if p.dtype.kind == "f" else p for p in pt]
    outputs = fun(*sym_inputs)
    if isinstance(outputs, (list, tuple)):
        raise TypeError("verify_grad expects a single-output function")

    def numpy_of(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    out_f = function(sym_inputs, outputs, mode=mode, device=device)
    rng.random()  # the JAX package draws the scalar of an unused projection here
    proj_val = rng.random(numpy_of(out_f(*pt)).shape)
    cost = tm.sum(outputs * as_tensor_variable(proj_val))
    grads = grad(cost, sym_inputs, disconnected_inputs="ignore")
    grad_fn = function(sym_inputs, grads, mode=mode, device=device)

    def cost_fn(*vals):
        return np.sum(numpy_of(out_f(*vals)) * proj_val)

    analytic = [numpy_of(g) for g in grad_fn(*pt)]
    num = numeric_grad(cost_fn, pt, eps)
    for i, (a, n) in enumerate(zip(analytic, num.gf)):
        a = np.asarray(a, dtype="float64")
        if a.shape != n.shape:
            raise GradientError(f"grad {i}: shape mismatch {a.shape} vs {n.shape}")
        rel = np.abs(a - n) / np.maximum(np.maximum(np.abs(a), np.abs(n)), 1e-12)
        bad = (np.abs(a - n) > abs_tol) & (rel > rel_tol)
        if np.any(bad):
            idx = np.unravel_index(np.argmax(np.abs(a - n)), a.shape)
            raise GradientError(
                f"verify_grad failed for input {i} at {idx}: analytic={a[idx]}, "
                f"numeric={n[idx]}, abs_err={np.abs(a - n)[idx]}, rel_err={rel[idx]}")
    return True


def as_list_or_tuple(use_list, use_tuple, outputs):
    """``outputs`` as a list, a tuple, or as it is (PyTensor's
    gradient.py:51)."""
    if use_list and use_tuple:
        raise ValueError("Both flags cannot be simultaneously True")
    if use_list or use_tuple:
        if isinstance(outputs, (list, tuple)):
            return list(outputs) if use_list else tuple(outputs)
        return [outputs] if use_list else (outputs,)
    return outputs


def subgraph_grad(wrt, end, start=None, cost=None, details=False):
    """The gradients of ``cost`` and of the cotangents ``start`` with
    respect to ``wrt`` and to ``end``, stopping at ``end`` (PyTensor's
    gradient.py:817): ``end`` is held constant, so the ``end`` gradients
    chain into a further call.  With ``details`` the ``start`` and
    ``cost`` parts come separately too."""
    if cost is None and start is None:
        raise ValueError("`cost` or `start` must be specified.")
    if not isinstance(end, list):
        raise TypeError("`end` must be a list.")
    if not isinstance(wrt, list):
        raise TypeError("`wrt` must be a list.")
    if start is not None and not isinstance(start, dict):
        raise TypeError("`start` must be a dictionary.")

    params = list(dict.fromkeys(wrt + end))
    start_grads = cost_grads = None
    if start is not None:
        start_grads = list(grad(cost=None, wrt=params, known_grads=dict(start),
                                consider_constant=end, disconnected_inputs="ignore"))
    if cost is not None:
        cost_grads = list(grad(cost=cost, wrt=params, consider_constant=end,
                               disconnected_inputs="ignore"))
    if start is None:
        grads = cost_grads
    else:
        grads = list(start_grads)
        if cost_grads is not None:
            grads = [g + cg for g, cg in zip(grads, cost_grads)]
    pgrads = dict(zip(params, grads))
    wrt_grads = [pgrads[k] for k in wrt]
    end_grads = [pgrads[k] for k in end]
    if details:
        return wrt_grads, end_grads, start_grads, cost_grads
    return wrt_grads, end_grads
