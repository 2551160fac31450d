"""DimShuffle, Elemwise, CAReduce.

Counterpart of ``pytensor_tpu/tensor/elemwise.py`` (PyTensor's
tensor/elemwise.py DimShuffle:41, Elemwise:375, CAReduce:1233).  The
torch lowerings live in ``link/torch/dispatch.py``; a fused chain of
Elemwise nodes runs as one generated kernel (``tensor/fused.py``).
Gradients call the scalar op's tensor-level grad rule directly.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from pytensor_tpu_torch.config import config
from pytensor_tpu_torch.graph.basic import Apply, Variable
from pytensor_tpu_torch.graph.null_type import DisconnectedType, NullType
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.scalar.basic import ScalarOp
from pytensor_tpu_torch.tensor.type import TensorType
from pytensor_tpu_torch.utils import np_dtype


def broadcast_static_shapes(*shapes: tuple) -> tuple:
    """Merge static shapes under numpy broadcasting (None = unknown)."""
    ndim = max((len(s) for s in shapes), default=0)
    padded = [(None,) * (ndim - len(s)) + tuple(s) for s in shapes]
    # treat missing (padded) dims as 1
    padded = [
        tuple(1 if (i < ndim - len(orig)) else d for i, d in enumerate(p))
        for orig, p in zip(shapes, padded)
    ]
    out = []
    for dims in zip(*padded):
        known = {d for d in dims if d is not None and d != 1}
        if len(known) > 1:
            raise ValueError(f"Cannot broadcast shapes {shapes}")
        if known:
            out.append(known.pop())
        elif any(d is None for d in dims):
            out.append(None)
        else:
            out.append(1)
    return tuple(out)


class DimShuffle(Op):
    """Transpose / broadcast-insert / squeeze in one op.

    ``new_order`` mixes input axis indices and "x" (new length-1 axis).
    Dropped axes must be statically length 1.
    """

    __props__ = ("input_ndim", "new_order")
    view_map = {0: [0]}

    def __init__(self, input_ndim: int, new_order: Sequence):
        self.input_ndim = int(input_ndim)
        self.new_order = tuple(
            "x" if o == "x" else int(o) for o in new_order
        )
        for o in self.new_order:
            if o != "x" and not (0 <= o < self.input_ndim):
                raise ValueError(f"new_order {self.new_order} out of range for ndim {input_ndim}")
        seen = [o for o in self.new_order if o != "x"]
        if len(seen) != len(set(seen)):
            raise ValueError("duplicate axis in new_order")
        self.shuffle = tuple(o for o in self.new_order if o != "x")
        self.drop = tuple(i for i in range(self.input_ndim) if i not in self.shuffle)
        self.augment = tuple(i for i, o in enumerate(self.new_order) if o == "x")
        self.is_transpose = not self.drop and not self.augment
        self.transposition = self.shuffle + self.drop

    def make_node(self, x):
        from pytensor_tpu_torch.tensor.basic import as_tensor_variable

        x = as_tensor_variable(x)
        if x.type.ndim != self.input_ndim:
            raise TypeError(f"DimShuffle expected ndim {self.input_ndim}, got {x.type.ndim}")
        for d in self.drop:
            # statically-known != 1 is a build error; unknown dims are
            # accepted and checked at runtime (reference tensor/elemwise.py:
            # DimShuffle builds on shape=(None, ...) and perform raises)
            if x.type.shape[d] is not None and x.type.shape[d] != 1:
                raise TypeError(
                    f"Cannot drop non-broadcastable (len != 1) dim {d} of {x.type}"
                )
        out_shape = tuple(
            1 if o == "x" else x.type.shape[o] for o in self.new_order
        )
        return Apply(self, [x], [TensorType(x.type.dtype, out_shape)()])

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        for d in self.drop:
            if x.shape[d] != 1:
                raise ValueError(
                    f"Cannot drop dim {d} of length {x.shape[d]} (!= 1)"
                )
        res = np.transpose(x, self.transposition)
        shape = list(res.shape[: len(self.shuffle)])
        for a in self.augment:
            shape.insert(a, 1)
        output_storage[0][0] = np.reshape(res, shape)

    def infer_shape(self, fgraph, node, input_shapes):
        (ishp,) = input_shapes
        from pytensor_tpu_torch.tensor.basic import constant

        return [
            tuple(
                constant(np.int64(1)) if o == "x" else ishp[o]
                for o in self.new_order
            )
        ]

    def L_op(self, inputs, outputs, output_grads):
        (gz,) = output_grads
        if isinstance(gz.type, (DisconnectedType, NullType)):
            return [gz]
        grad_order = [
            self.new_order.index(i) if i in self.new_order else "x"
            for i in range(self.input_ndim)
        ]
        # dims this op inserted as length-1 may come back with an unknown
        # static size in gz (e.g. through Join/Split grads); pin them so
        # the reverse drop is type-valid — semantically they ARE 1
        dropped = [d for d in self.augment if gz.type.shape[d] is None]
        if dropped:
            from pytensor_tpu_torch.tensor.shape import specify_shape

            pinned = [1 if d in dropped else gz.type.shape[d]
                      for d in range(gz.type.ndim)]
            gz = specify_shape(gz, pinned)
        return [DimShuffle(gz.type.ndim, grad_order)(gz)]

    def R_op(self, inputs, eval_points):
        if eval_points[0] is None:
            return [None]
        return [self(eval_points[0])]

    def c_like_str(self):
        return f"DimShuffle{{{','.join(map(str, self.new_order))}}}"

    def __str__(self):
        if self.is_transpose:
            return f"Transpose{{axes={self.shuffle}}}"
        return f"DimShuffle{{{self.input_ndim}->{self.new_order}}}"


class Elemwise(Op):
    """Lift a ScalarOp to tensors with numpy broadcasting semantics."""

    __props__ = ("scalar_op",)

    def __init__(self, scalar_op: ScalarOp, inplace_pattern=None, name=None):
        self.scalar_op = scalar_op
        self.name = name

    @property
    def nfunc_spec(self):
        return None

    def make_node(self, *inputs):
        from pytensor_tpu_torch.tensor.basic import as_tensor_variable

        # Python float literals are weak-typed: when a
        # sibling operand is a float tensor WIDER than floatX, convert
        # the literal at that width.  Under floatX=float32 a bare
        # ``x_f64 * 2.0/sqrt(pi)`` would otherwise round the constant
        # through float32 and silently poison the float64 graph (the
        # output dtype is unchanged — mul(f64, f32const) already
        # upcast to f64; only the constant's precision improves).
        weak_dtype = None
        if any(isinstance(i, float) for i in inputs):
            from pytensor_tpu_torch.config import config

            widest = None
            for i in inputs:
                dt = getattr(getattr(i, "type", None), "dtype", None)
                if dt is None and isinstance(i, (np.ndarray, np.generic)):
                    dt = str(i.dtype)
                if dt and dt.startswith("float"):
                    if widest is None or (np.dtype(dt).itemsize
                                          > np.dtype(widest).itemsize):
                        widest = dt
            if widest is not None and (np.dtype(widest).itemsize
                                       > np_dtype(config.floatX).itemsize):
                weak_dtype = widest
        inputs = [
            as_tensor_variable(i, dtype=weak_dtype)
            if weak_dtype is not None and isinstance(i, float)
            else as_tensor_variable(i)
            for i in inputs
        ]
        nin = self.scalar_op.nin
        if nin != -1 and len(inputs) != nin:
            raise ValueError(
                f"{self.scalar_op} expected {nin} inputs, got {len(inputs)}"
            )
        if nin == -1 and len(inputs) < 1:
            raise ValueError("variadic elemwise needs at least 1 input")
        out_shape = broadcast_static_shapes(*(i.type.shape for i in inputs))
        out_dtype = self.scalar_op.output_dtype(*(i.type.dtype for i in inputs))
        out = TensorType(out_dtype, out_shape)()
        return Apply(self, inputs, [out])

    @staticmethod
    def _check_runtime_broadcast(node, shapes):
        """Reference semantics (tensor/elemwise.py perform/c_code): a dim may
        only broadcast if its STATIC shape is 1; a runtime 1 stretching
        against >1 is an error on every backend."""
        out_shape = np.broadcast_shapes(*shapes)
        nd = len(out_shape)
        for inp, shp in zip(node.inputs, shapes):
            off = nd - len(shp)
            for d, s in enumerate(shp):
                if (s == 1 and out_shape[off + d] != 1
                        and inp.type.shape[d] != 1):
                    raise ValueError(
                        "Runtime broadcasting not allowed. "
                        "One input had a distinct runtime dimension of 1 "
                        f"(input shape {shp}, output shape {out_shape}). "
                        "If broadcasting was intended, use "
                        "`specify_broadcastable` on the relevant input."
                    )

    def outer(self, x, y):
        """``op.outer(x, y)[i..., j...] = op(x[i...], y[j...])``, the
        ufunc's ``.outer``."""
        from pytensor_tpu_torch.tensor.basic import as_tensor_variable

        x = as_tensor_variable(x)
        y = as_tensor_variable(y)
        xd = DimShuffle(x.type.ndim,
                        tuple(range(x.type.ndim)) + ("x",) * y.type.ndim)(x)
        return self(xd, y)

    def perform(self, node, inputs, output_storage):
        self._check_runtime_broadcast(node, [np.shape(i) for i in inputs])
        out = self.scalar_op.impl(*inputs)
        dt = node.outputs[0].type.numpy_dtype
        out = np.asarray(out)
        if out.dtype != dt:
            out = out.astype(dt)
        # broadcast fully (scalar ops like second may under-broadcast)
        shp = np.broadcast_shapes(*(np.shape(i) for i in inputs))
        if out.shape != shp:
            out = np.broadcast_to(out, shp).copy()
        output_storage[0][0] = out

    def infer_shape(self, fgraph, node, input_shapes):
        from pytensor_tpu_torch.tensor.basic import constant

        out_ndim = node.outputs[0].type.ndim
        result = []
        for d in range(out_ndim):
            static = node.outputs[0].type.shape[d]
            if static is not None:
                result.append(constant(np.int64(static)))
                continue
            # Reference semantics (tensor/elemwise.py infer_shape +
            # the "Could not broadcast dimensions" runtime assert):
            # broadcasting requires a STATIC length-1 dim, so every
            # unknown candidate dim is equal at runtime and any one of
            # them is the output dim — no runtime max needed.
            candidates = []
            for inp, ishp in zip(node.inputs, input_shapes):
                offset = out_ndim - inp.type.ndim
                if d >= offset:
                    idim = d - offset
                    if inp.type.shape[idim] is None:
                        candidates.append(ishp[idim])
                    elif inp.type.shape[idim] != 1:
                        # statically known non-1: this IS the output dim
                        candidates = [ishp[idim]]
                        break
            if not candidates:
                result.append(constant(np.int64(1)))
            else:
                result.append(candidates[0])
        return [tuple(result)]

    def L_op(self, inputs, outputs, output_grads):
        so = self.scalar_op
        if hasattr(so, "L_op"):
            # PyTensor-style ops (scalar/compatnames.py): L_op(inputs,
            # outputs, grads), which chains to grad(inputs, grads)
            scalar_grads = so.L_op(inputs, outputs, output_grads)
        else:
            scalar_grads = so.grad(inputs, outputs, output_grads)
        rval = []
        for g, inp in zip(scalar_grads, inputs):
            if isinstance(getattr(g, "type", None), (DisconnectedType, NullType)):
                rval.append(g)
                continue
            rval.append(_sum_grad_over_bcasted_dims(inp, g))
        return rval

    def R_op(self, inputs, eval_points):
        # the scalar op's gradient rule, applied forward
        from pytensor_tpu_torch.gradient import Rop_via_pushforward

        return Rop_via_pushforward(self, inputs, eval_points)

    def __str__(self):
        if self.name:
            return self.name
        return f"Elemwise{{{self.scalar_op}}}"


def _sum_grad_over_bcasted_dims(inp: Variable, grad: Variable) -> Variable:
    """Sum ``grad`` over dims along which ``inp`` was broadcast."""
    from pytensor_tpu_torch.tensor import math as tm
    from pytensor_tpu_torch.tensor.basic import cast

    if not hasattr(grad, "type") or not isinstance(grad.type, TensorType):
        return grad
    g_ndim = grad.type.ndim
    i_ndim = inp.type.ndim
    lead = g_ndim - i_ndim
    axes = list(range(lead))
    for d in range(i_ndim):
        if inp.type.shape[d] == 1 and grad.type.shape[lead + d] != 1:
            axes.append(lead + d)
    if axes:
        grad = tm.sum(grad, axis=axes, keepdims=True)
    if lead:
        grad = DimShuffle(grad.type.ndim, list(range(lead, g_ndim)))(grad)
    return grad


# reduction helpers: numpy callables per scalar op name
_np_reducers = {
    "add": np.add.reduce,
    "mul": np.multiply.reduce,
    "maximum": np.maximum.reduce,
    "minimum": np.minimum.reduce,
    "and_": np.logical_and.reduce,
    "or_": np.logical_or.reduce,
    "xor": np.bitwise_xor.reduce,
}


class CAReduce(Op):
    """Reduce a tensor along axes with a commutative-associative scalar op.

    Parallels reference CAReduce (tensor/elemwise.py:1233).  Named
    reductions (Sum, Prod, Max, ...) are instances distinguished by
    ``scalar_op`` with gradient rules dispatched on it.
    """

    __props__ = ("scalar_op", "axis", "dtype", "acc_dtype", "upcast_discrete_output")

    def __init__(self, scalar_op: ScalarOp, axis=None, dtype=None, acc_dtype=None,
                 upcast_discrete_output=False):
        self.scalar_op = scalar_op
        if axis is None:
            self.axis = None
        elif isinstance(axis, (int, np.integer)) or (
            isinstance(axis, np.ndarray) and axis.ndim == 0
        ):
            self.axis = (int(axis),)
        else:
            axis = [int(a) for a in axis]
            if len(set(axis)) != len(axis):
                raise ValueError(f"repeated axis in {axis}")
            self.axis = tuple(sorted(axis))
        self.dtype = dtype
        self.acc_dtype = acc_dtype
        self.upcast_discrete_output = upcast_discrete_output

    def _output_dtype(self, idtype: str) -> str:
        if self.dtype is not None:
            return self.dtype
        if self.upcast_discrete_output:
            # sum/prod of low-precision ints accumulate in int64/uint64
            if idtype in ("bool", "int8", "int16", "int32", "int64"):
                return "int64"
            if idtype in ("uint8", "uint16", "uint32", "uint64"):
                return "uint64"
        if self.scalar_op.name in ("and_", "or_"):
            return "bool"
        return idtype

    def make_node(self, x):
        from pytensor_tpu_torch.tensor.basic import as_tensor_variable

        x = as_tensor_variable(x)
        if self.acc_dtype is not None:
            # an accumulator may only upcast; discrete inputs may also
            # accumulate in a continuous dtype (reference CAReduce
            # tensor/elemwise.py acc_dtype validation)
            from pytensor_tpu_torch.scalar.basic import upcast
            from pytensor_tpu_torch.tensor.type import continuous_dtypes, discrete_dtypes

            idt = x.type.dtype
            if not (
                self.acc_dtype == upcast(idt, self.acc_dtype)
                or (idt in discrete_dtypes and self.acc_dtype in continuous_dtypes)
            ):
                raise TypeError(
                    f"acc_dtype {self.acc_dtype} would downcast input dtype {idt}"
                )
        axis = self.axis
        if axis is not None:
            # numpy reduce semantics: 0-d operands accept axis 0/-1 as a
            # no-op reduction (reference TestCAReduce.test_scalar_input)
            bound = max(x.type.ndim, 1)
            for a in axis:
                if not (-bound <= a < bound):
                    raise np.exceptions.AxisError(a, x.type.ndim)
            if x.type.ndim == 0:
                axis = ()
            else:
                axis = tuple(a % x.type.ndim for a in axis)
            if axis != self.axis:
                # normalize negative axes into a new op instance
                return type(self)(self.scalar_op, axis, self.dtype, self.acc_dtype,
                                  self.upcast_discrete_output).make_node(x)
            out_shape = tuple(
                s for d, s in enumerate(x.type.shape) if d not in axis
            )
        else:
            out_shape = ()
        out_dtype = self._output_dtype(x.type.dtype)
        return Apply(self, [x], [TensorType(out_dtype, out_shape)()])

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        x = np.asarray(x)
        axis = self.axis if self.axis is not None else tuple(range(x.ndim))
        dt = node.outputs[0].type.numpy_dtype
        reducer = _np_reducers[self.scalar_op.name]
        acc = x
        acc_dt = np_dtype(self.acc_dtype) if self.acc_dtype is not None else dt
        if self.scalar_op.name in ("add", "mul") and acc.dtype != acc_dt:
            acc = acc.astype(acc_dt)
        for a in sorted(axis, reverse=True):
            acc = reducer(acc, axis=a)
        acc = np.asarray(acc)
        if acc.dtype != dt:
            acc = acc.astype(dt)
        output_storage[0][0] = acc

    def infer_shape(self, fgraph, node, input_shapes):
        (ishp,) = input_shapes
        if self.axis is None:
            return [()]
        return [tuple(s for d, s in enumerate(ishp) if d not in self.axis)]

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.tensor import math as tm
        from pytensor_tpu_torch.tensor.basic import cast

        (x,) = inputs
        (gz,) = output_grads
        name = self.scalar_op.name
        axis = self.axis if self.axis is not None else tuple(range(x.type.ndim))
        # re-insert reduced dims as broadcastable, then broadcast
        order = []
        j = 0
        for d in range(x.type.ndim):
            if d in axis:
                order.append("x")
            else:
                order.append(j)
                j += 1
        gz_b = DimShuffle(gz.type.ndim, order)(gz) if x.type.ndim else gz
        if name == "add":
            g = tm.second(x, gz_b)
            g = cast(g, x.type.dtype) if x.type.dtype != g.type.dtype else g
            return [g]
        (out,) = outputs
        out_b = DimShuffle(out.type.ndim, order)(out) if x.type.ndim else out
        if name == "mul":
            # zero-safe Prod gradient (PyTensor's Prod.grad): a nonzero entry
            # sees out/x (0 when the product holds a zero); a zero entry sees
            # the product of the nonzero rest if it is the only zero
            from pytensor_tpu_torch.tensor.basic import ones_like, zeros_like

            iszero = tm.eq(x, 0)
            nzeros = tm.sum(cast(iszero, "int64"), axis=list(axis))
            pnz = tm.prod(tm.switch(iszero, ones_like(x), x), axis=list(axis))
            if x.type.ndim:
                nz_b = DimShuffle(nzeros.type.ndim, order)(nzeros)
                pnz_b = DimShuffle(pnz.type.ndim, order)(pnz)
            else:
                nz_b, pnz_b = nzeros, pnz
            g = gz_b * tm.switch(
                iszero,
                tm.switch(tm.eq(nz_b, 1), pnz_b, zeros_like(pnz_b)),
                out_b / tm.switch(iszero, ones_like(x), x),
            )
            return [cast(g, x.type.dtype) if g.type.dtype != x.type.dtype else g]
        if name in ("maximum", "minimum"):
            # each tied extremum receives the full output gradient
            return [gz_b * cast(tm.eq(x, out_b), gz.type.dtype)]
        if name in ("and_", "or_", "xor"):
            # the gradient of a boolean reduction is zeros, not null
            # (PyTensor's All/Any.pullback)
            from pytensor_tpu_torch.config import config as _cfg
            from pytensor_tpu_torch.tensor.basic import zeros_like

            return [zeros_like(x, dtype=_cfg.floatX)]
        from pytensor_tpu_torch.gradient import grad_not_implemented

        return [grad_not_implemented(self, 0, x)]

    def __str__(self):
        name = {
            "add": "Sum", "mul": "Prod", "maximum": "Max", "minimum": "Min",
            "and_": "All", "or_": "Any",
        }.get(self.scalar_op.name, f"Reduce{{{self.scalar_op}}}")
        ax = "" if self.axis is None else f"{{axis={list(self.axis)}}}"
        return f"{name}{ax}"


def Sum(axis=None, dtype=None, acc_dtype=None):
    from pytensor_tpu_torch.scalar import basic as ps

    return CAReduce(ps.add, axis, dtype, acc_dtype, upcast_discrete_output=True)


def Max(axis=None):
    from pytensor_tpu_torch.scalar import basic as ps

    return CAReduce(ps.maximum, axis)


def Prod(axis=None, dtype=None, acc_dtype=None):
    from pytensor_tpu_torch.scalar import basic as ps

    return CAReduce(ps.mul, axis, dtype, acc_dtype, upcast_discrete_output=True)


def Min(axis=None):
    from pytensor_tpu_torch.scalar import basic as ps

    return CAReduce(ps.minimum, axis)


def All(axis=None):
    from pytensor_tpu_torch.scalar import basic as ps

    return CAReduce(ps.and_, axis, dtype="bool")


def Any(axis=None):
    from pytensor_tpu_torch.scalar import basic as ps

    return CAReduce(ps.or_, axis, dtype="bool")


def scalar_elemwise(scalar_op, name=None):
    """The tensor-level callable of a scalar op."""
    return Elemwise(scalar_op, name=name)


def get_normalized_batch_axes(core_axes, core_ndim, batch_ndim):
    """Map core reduction axes to batched axes (for vectorize)."""
    if core_axes is None:
        core_axes = tuple(range(core_ndim))
    else:
        core_axes = tuple(a % core_ndim for a in core_axes)
    return tuple(batch_ndim + a for a in core_axes)
