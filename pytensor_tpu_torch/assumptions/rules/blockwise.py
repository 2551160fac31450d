"""Blockwise assumption rules: batched matrix facts delegate to the
core op (reference assumptions/blockwise.py).  Matrix facts here mean
"for every batch member" — e.g. a Blockwise Cholesky output is a stack
of lower-triangular factors.
"""

from __future__ import annotations

from pytensor_tpu_torch.assumptions import FactState, _rules, register_assumption
from pytensor_tpu_torch.tensor.blockwise import Blockwise


def blockwise_rule(node, fact, holds_fn, out_index=None):
    from types import SimpleNamespace

    core = node.op.core_op
    # rules read node.op / node.inputs / node.outputs; present the core
    # op with the batched operands (facts read "for every batch member")
    proxy = SimpleNamespace(op=core, inputs=node.inputs,
                            outputs=node.outputs)
    for op_type, fns in _rules.items():
        if op_type is Blockwise:
            continue
        if isinstance(core, op_type):
            for fn in fns:
                try:
                    res = fn(proxy, fact, holds_fn, out_index=out_index)
                except TypeError:
                    res = fn(proxy, fact, holds_fn)
                if res != FactState.UNKNOWN:
                    return res
    return FactState.UNKNOWN


register_assumption(Blockwise, blockwise_rule)
