"""Elemwise / reduction assumption rules (reference
assumptions/elemwise.py)."""

from __future__ import annotations

from pytensor_tpu_torch.assumptions import FactState, register_assumption
from pytensor_tpu_torch.tensor.elemwise import CAReduce, Elemwise


def _is_zero_constant(v):
    import numpy as np

    from pytensor_tpu_torch.graph.basic import Constant

    return isinstance(v, Constant) and np.all(np.asarray(v.data) == 0)


def elemwise_rule(node, fact, holds_fn):
    name = node.op.scalar_op.name
    if fact == "lower_triangular" or fact == "upper_triangular":
        # elementwise product with a triangular matrix keeps the zeros
        if name == "mul":
            for i in node.inputs:
                if i.type.ndim == node.outputs[0].type.ndim and \
                        holds_fn(i, fact) == FactState.TRUE:
                    return FactState.TRUE
        if name in ("add", "sub", "neg"):
            subs = [holds_fn(i, fact) for i in node.inputs
                    if i.type.ndim == node.outputs[0].type.ndim]
            if subs and all(s == FactState.TRUE for s in subs) and \
                    len(subs) == len(node.inputs):
                return FactState.TRUE
    if fact in ("diagonal", "lower_triangular", "upper_triangular") and \
            name == "switch":
        # switch(mask, x, 0): the mask's exact zeros survive, so the
        # output inherits the mask's sparsity-pattern fact (this is how
        # diag(v) and tril/triu are constructed — select, not multiply,
        # to keep non-finite x confined to the kept positions)
        cond, _, other = node.inputs
        if cond.type.ndim == node.outputs[0].type.ndim and \
                holds_fn(cond, fact) == FactState.TRUE and \
                _is_zero_constant(other):
            return FactState.TRUE
    if fact == "diagonal":
        if name == "mul":
            for i in node.inputs:
                if i.type.ndim == node.outputs[0].type.ndim and \
                        holds_fn(i, fact) == FactState.TRUE:
                    return FactState.TRUE
        if name in ("add", "sub", "neg"):
            subs = [holds_fn(i, fact) for i in node.inputs]
            if all(s == FactState.TRUE for s in subs):
                return FactState.TRUE
    if fact == "symmetric":
        # any elementwise op of symmetric (or scalar) inputs is symmetric
        subs = []
        for i in node.inputs:
            if i.type.ndim == 0:
                continue
            subs.append(holds_fn(i, "symmetric"))
        if subs and all(s == FactState.TRUE for s in subs):
            return FactState.TRUE
    if fact == "positive":
        if name == "sqrt" or name == "reciprocal":
            return holds_fn(node.inputs[0], "positive")
        if name == "true_div":
            subs = [holds_fn(i, "positive") for i in node.inputs]
            if all(s == FactState.TRUE for s in subs):
                return FactState.TRUE
        if name in ("exp", "sigmoid", "softplus", "cosh"):
            return FactState.TRUE
        if name == "sqr":
            return FactState.UNKNOWN  # non_negative, not strictly positive
        if name in ("add", "mul"):
            subs = [holds_fn(i, "positive") for i in node.inputs]
            if all(s == FactState.TRUE for s in subs):
                return FactState.TRUE
    if fact == "non_negative":
        if name in ("exp", "sigmoid", "softplus", "sqr", "abs", "cosh"):
            return FactState.TRUE
        if name in ("add", "mul"):
            subs = [holds_fn(i, "non_negative") for i in node.inputs]
            if all(s == FactState.TRUE for s in subs):
                return FactState.TRUE
    return FactState.UNKNOWN


def careduce_rule(node, fact, holds_fn):
    name = node.op.scalar_op.name
    if fact in ("non_negative", "positive") and name in ("add", "mul",
                                                         "maximum"):
        return holds_fn(node.inputs[0], fact)
    return FactState.UNKNOWN


register_assumption(Elemwise, elemwise_rule)
register_assumption(CAReduce, careduce_rule)
