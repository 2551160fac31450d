"""Blockwise: gufunc-signature batching of any core op.

Counterpart of ``pytensor_tpu/tensor/blockwise.py``, ported whole:
``parse_signature``, ``signature_from_core_node``, ``Blockwise`` (with
``infer_shape``, ``L_op``, ``_core_ndims`` and ``node_batch_ndim``),
``vectorize_node_fallback`` and the batching rules of ``Elemwise``,
``DimShuffle``, ``CAReduce``, ``Subtensor``, ``Reshape``, ``Shape_i``
and ``Shape``.  The static shapes ``Blockwise.make_node`` gives its
outputs are the JAX package's, ``None`` where it has ``None``: the
eligibility rule of the scan kernel (K2) reads them.  The torch lowering
(``link/torch/dispatch.py``) broadcasts the batch dimensions and maps the
core lowering over them; a ``Blockwise{Dot}`` is one batched
``torch.matmul``.
"""

from __future__ import annotations

import re
from typing import Sequence

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply, Variable
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.graph.null_type import DisconnectedType, NullType
from pytensor_tpu_torch.graph.replace import _vectorize_node, vectorize_graph
from pytensor_tpu_torch.tensor.elemwise import (
    CAReduce,
    DimShuffle,
    Elemwise,
    broadcast_static_shapes,
)
from pytensor_tpu_torch.tensor.type import TensorType

_sig_re = re.compile(r"^\s*\(([^)]*)\)\s*$")


def parse_signature(sig: str):
    """Parse a gufunc signature '(m,k),(k,n)->(m,n)' into dim-name tuples."""
    in_s, out_s = sig.split("->")
    def split_args(s):
        parts = []
        depth = 0
        cur = ""
        for ch in s:
            if ch == "(":
                depth += 1
                cur = ""
            elif ch == ")":
                depth -= 1
                parts.append(tuple(d.strip() for d in cur.split(",") if d.strip()))
            elif depth:
                cur += ch
        return tuple(parts)

    return split_args(in_s), split_args(out_s)


def signature_from_core_node(node: Apply) -> str:
    """Derive a signature from a core Apply's input/output ndims."""
    names = iter("ijklmnopqrstuvwxyz" + "".join(f"d{i}" for i in range(100)))
    parts_in = []
    for i in node.inputs:
        dims = [f"i{id(i) % 997}_{d}" for d in range(i.type.ndim)]
        parts_in.append("(" + ",".join(dims) + ")")
    parts_out = []
    for o in node.outputs:
        dims = [f"o{id(o) % 997}_{d}" for d in range(o.type.ndim)]
        parts_out.append("(" + ",".join(dims) + ")")
    return ",".join(parts_in) + "->" + ",".join(parts_out)


class Blockwise(Op):
    __props__ = ("core_op", "signature")

    def __init__(self, core_op: Op, signature: str | None = None, name=None,
                 **kwargs):
        if isinstance(core_op, Blockwise):
            raise TypeError("Cannot nest Blockwise")
        self.core_op = core_op
        if signature is None:
            signature = getattr(core_op, "gufunc_signature", None)
        if signature is None:
            raise ValueError(f"Blockwise({core_op}) needs a signature")
        self.signature = signature
        self.name = name
        self.inputs_sig, self.outputs_sig = parse_signature(signature)

    def _core_ndims(self):
        return [len(s) for s in self.inputs_sig], [len(s) for s in self.outputs_sig]

    def make_node(self, *inputs):
        from pytensor_tpu_torch.tensor.basic import as_tensor_variable

        inputs = [as_tensor_variable(i) for i in inputs]
        in_core, out_core = self._core_ndims()
        if len(inputs) != len(in_core):
            raise ValueError(f"Blockwise expected {len(in_core)} inputs")
        batch_ndims = []
        for i, c in zip(inputs, in_core):
            if i.type.ndim < c:
                raise TypeError(f"input {i} has fewer dims than core {c}")
            batch_ndims.append(i.type.ndim - c)
        nb = max(batch_ndims, default=0)
        # pad batched inputs on the left so all have nb batch dims
        from pytensor_tpu_torch.tensor.basic import shape_padleft

        padded = [
            shape_padleft(i, nb - b) if b < nb else i
            for i, b in zip(inputs, batch_ndims)
        ]
        batch_shape = broadcast_static_shapes(
            *[p.type.shape[: nb] for p in padded]
        ) if nb else ()
        # core node for output types
        core_inputs = [
            TensorType(i.type.dtype, i.type.shape[i.type.ndim - c:] if c else ())()
            for i, c in zip(padded, in_core)
        ]
        core_node = self.core_op.make_node(*core_inputs)
        outputs = [
            TensorType(o.type.dtype, tuple(batch_shape) + o.type.shape)()
            for o in core_node.outputs
        ]
        return Apply(self, padded, outputs)

    @property
    def batch_ndim(self):
        return None  # depends on node; use node_batch_ndim

    def node_batch_ndim(self, node):
        return node.outputs[0].type.ndim - len(self.outputs_sig[0])

    def perform(self, node, inputs, output_storage):
        in_core, out_core = self._core_ndims()
        nb = self.node_batch_ndim(node)
        batch_shape = np.broadcast_shapes(
            *[np.shape(i)[: np.ndim(i) - c] for i, c in zip(inputs, in_core)]
        )
        bcast = [
            np.broadcast_to(i, batch_shape + np.shape(i)[np.ndim(i) - c:])
            for i, c in zip(inputs, in_core)
        ]
        results = [None] * len(node.outputs)
        for idx in np.ndindex(*batch_shape):
            core_ins = [b[idx] for b in bcast]
            storage = [[None] for _ in node.outputs]
            self.core_op.perform(
                self.core_op.make_node(
                    *[TensorType(str(np.asarray(ci).dtype), np.shape(ci))()
                      for ci in core_ins]
                ),
                core_ins, storage,
            )
            for k, s in enumerate(storage):
                if results[k] is None:
                    results[k] = np.empty(
                        batch_shape + np.shape(s[0]),
                        dtype=node.outputs[k].type.numpy_dtype,
                    )
                results[k][idx] = s[0]
        if not batch_shape.__len__() or 0 in batch_shape:
            # empty batch: produce empty outputs with correct shapes
            for k, o in enumerate(node.outputs):
                if results[k] is None:
                    core_shape = tuple(
                        0 if s is None else s for s in o.type.shape[nb:]
                    )
                    results[k] = np.empty(batch_shape + core_shape,
                                          dtype=o.type.numpy_dtype)
        for s, r in zip(output_storage, results):
            s[0] = r

    def infer_shape(self, fgraph, node, input_shapes):
        from pytensor_tpu_torch.tensor import math as tm
        from pytensor_tpu_torch.tensor.basic import constant

        nb = self.node_batch_ndim(node)
        in_core, out_core = self._core_ndims()
        # batch dims: take from the first input that has them non-broadcast
        batch_dims = []
        for d in range(nb):
            cands = []
            for (i, ishp), c in zip(zip(node.inputs, input_shapes), in_core):
                if i.type.shape[d] != 1:
                    cands.append(ishp[d])
            batch_dims.append(cands[0] if cands else constant(np.int64(1)))
        # core dims by name
        dim_values = {}
        for (i, ishp), sig in zip(zip(node.inputs, input_shapes), self.inputs_sig):
            for k, name in enumerate(sig):
                dim_values.setdefault(name, ishp[nb + k])
        out = []
        for o, sig in zip(node.outputs, self.outputs_sig):
            dims = list(batch_dims)
            for name in sig:
                if name in dim_values:
                    dims.append(dim_values[name])
                else:
                    raise NotImplementedError(f"unknown output core dim {name}")
            out.append(tuple(dims))
        return out

    def L_op(self, inputs, outputs, output_grads):
        # build core grads then batch them with vectorize_graph
        in_core, out_core = self._core_ndims()
        core_inputs = [
            TensorType(i.type.dtype, i.type.shape[i.type.ndim - c:] if c else ())()
            for i, c in zip(inputs, in_core)
        ]
        core_node = self.core_op.make_node(*core_inputs)
        core_ogs = [
            TensorType(g.type.dtype,
                       g.type.shape[g.type.ndim - c:] if c else ())()
            for g, c in zip(output_grads, out_core)
        ]
        core_grads = self.core_op.L_op(core_node.inputs, core_node.outputs, core_ogs)
        replace = dict(zip(core_inputs, inputs))
        replace.update(dict(zip(core_ogs, output_grads)))
        batched = []
        for g, inp in zip(core_grads, inputs):
            if g is None or isinstance(getattr(g, "type", None),
                                       (DisconnectedType, NullType)):
                batched.append(g)
                continue
            bg = vectorize_graph(g, replace=replace)
            # sum over broadcasted batch dims of this input
            from pytensor_tpu_torch.tensor.elemwise import _sum_grad_over_bcasted_dims

            batched.append(_sum_grad_over_bcasted_dims(inp, bg))
        return batched

    def __str__(self):
        return self.name or f"Blockwise{{{self.core_op}, {self.signature}}}"


def vectorize_node_fallback(op, node, *batched_inputs):
    """Default batching: rebuild if nothing is batched, else Blockwise."""
    batched = any(
        bi.type.ndim > i.type.ndim for bi, i in zip(batched_inputs, node.inputs)
    )
    if not batched:
        return op.make_node(*batched_inputs)
    signature = getattr(op, "gufunc_signature", None) or signature_from_core_node(node)
    return Blockwise(op, signature=signature).make_node(*batched_inputs)


# --- vectorize rules for structural ops --------------------------------------

@_vectorize_node.register(Elemwise)
def _vectorize_elemwise(op, node, *batched_inputs):
    from pytensor_tpu_torch.tensor.basic import as_tensor_variable

    batched_inputs = [as_tensor_variable(b) for b in batched_inputs]
    core_out_ndim = node.outputs[0].type.ndim
    batch_ndims = [
        b.type.ndim - i.type.ndim for b, i in zip(batched_inputs, node.inputs)
    ]
    nb = max(batch_ndims, default=0)
    if nb == 0:
        return op.make_node(*batched_inputs)
    new_inputs = []
    for b, i, bn in zip(batched_inputs, node.inputs, batch_ndims):
        ci = i.type.ndim
        pad = core_out_ndim - ci
        lead_pad = nb - bn
        if pad or lead_pad:
            order = (
                ["x"] * lead_pad
                + list(range(bn))
                + ["x"] * pad
                + [bn + d for d in range(ci)]
            )
            b = DimShuffle(b.type.ndim, order)(b)
        new_inputs.append(b)
    return op.make_node(*new_inputs)


@_vectorize_node.register(DimShuffle)
def _vectorize_dimshuffle(op, node, x):
    bn = x.type.ndim - op.input_ndim
    if bn == 0:
        return op.make_node(x)
    new_order = list(range(bn)) + [
        "x" if o == "x" else o + bn for o in op.new_order
    ]
    return DimShuffle(x.type.ndim, new_order).make_node(x)


@_vectorize_node.register(CAReduce)
def _vectorize_careduce(op, node, x):
    bn = x.type.ndim - node.inputs[0].type.ndim
    if bn == 0:
        return op.make_node(x)
    core_ndim = node.inputs[0].type.ndim
    axis = op.axis if op.axis is not None else tuple(range(core_ndim))
    new_axis = tuple(a % core_ndim + bn for a in axis)
    return type(op)(op.scalar_op, new_axis, op.dtype, op.acc_dtype,
                    op.upcast_discrete_output).make_node(x)


def _register_structural_vectorizers():
    from pytensor_tpu_torch.tensor.basic import Alloc, Join, MakeVector
    from pytensor_tpu_torch.tensor.shape import Reshape, Shape, Shape_i, SpecifyShape
    from pytensor_tpu_torch.tensor.subtensor import (
        DYN,
        AdvancedSubtensor1,
        Subtensor,
        advanced_subtensor1,
    )

    @_vectorize_node.register(Subtensor)
    def _vectorize_subtensor(op, node, x, *dyn):
        x_b = x.type.ndim - node.inputs[0].type.ndim
        dyn_b = [
            d.type.ndim - i.type.ndim for d, i in zip(dyn, node.inputs[1:])
        ]
        if x_b == 0 and all(b == 0 for b in dyn_b):
            return op.make_node(x, *dyn)
        if (
            x_b == 0
            and len(op.idx_list) == 1
            and op.idx_list[0] == DYN
            and len(dyn) == 1
            and dyn_b[0] == 1
        ):
            # scalar index became a vector: gather along axis 0
            return advanced_subtensor1.make_node(x, dyn[0])
        return vectorize_node_fallback(op, node, x, *dyn)

    @_vectorize_node.register(Reshape)
    def _vectorize_reshape(op, node, x, shp):
        """Batched reshape keeps the batch dims and reshapes the core:
        reshape(x, s) over batch -> reshape(x, (*batch_shape, *s)).  A
        Blockwise{Reshape} would feed a batched shape vector to the core
        op, which reads its shape on the host."""
        from pytensor_tpu_torch.graph.basic import Constant as _Const
        from pytensor_tpu_torch.tensor.basic import as_tensor_variable, join

        x = as_tensor_variable(x)
        shp = as_tensor_variable(shp)
        x_b = x.type.ndim - node.inputs[0].type.ndim
        shp_b = shp.type.ndim - node.inputs[1].type.ndim
        if x_b == 0 and shp_b == 0:
            return op.make_node(x, shp)
        if shp_b > 0:
            if isinstance(shp, _Const):
                data = np.asarray(shp.data).reshape(-1, shp.type.shape[-1])
                if not (data == data[0]).all():
                    return vectorize_node_fallback(op, node, x, shp)
                shp = as_tensor_variable(data[0])
            elif all(s == 1 for s in shp.type.shape[:-1]):
                shp = shp.reshape((shp.type.shape[-1],))
            else:
                return vectorize_node_fallback(op, node, x, shp)
        from pytensor_tpu_torch.tensor.basic import MakeVector as _MakeVector
        from pytensor_tpu_torch.tensor.math import cast as _cast
        from pytensor_tpu_torch.tensor.shape import Shape_i as _Shape_i

        # element-wise MakeVector (not Join) so constant entries stay
        # host values
        entries = [_cast(_Shape_i(d)(x), "int64") for d in range(x_b)]
        entries += [_cast(shp[i], "int64") for i in range(op.ndim)]
        new_shp = _MakeVector("int64")(*entries)
        return Reshape(x_b + op.ndim).make_node(x, new_shp)

    @_vectorize_node.register(Shape_i)
    def _vectorize_shape_i(op, node, x):
        bn = x.type.ndim - node.inputs[0].type.ndim
        if bn == 0:
            return op.make_node(x)
        # core dim i of the unbatched input = dim i+bn of the batched one
        return Shape_i(op.i + bn).make_node(x)

    @_vectorize_node.register(Shape)
    def _vectorize_shape(op, node, x):
        bn = x.type.ndim - node.inputs[0].type.ndim
        if bn == 0:
            return op.make_node(x)
        # shape of the core part: the trailing core dims of the batched input
        core_ndim = node.inputs[0].type.ndim
        entries = [Shape_i(bn + d)(x) for d in range(core_ndim)]
        return MakeVector("int64").make_node(*entries)


_register_structural_vectorizers()
