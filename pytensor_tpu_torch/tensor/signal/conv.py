"""Convolutions: ``Convolve1d``, ``Convolve2d`` and their gradients.

Counterpart of ``pytensor_tpu/tensor/signal/conv.py`` (PyTensor's
tensor/signal/conv.py Convolve1d:120, Convolve2d:253).  The oracle is
``np.convolve`` (which swaps its operands when the second is the longer)
and ``scipy.signal.convolve2d``; the torch lowerings
(``link/torch/dispatch.py``, section "signal") are true convolutions:
``torch.nn.functional.conv1d``/``conv2d`` with the kernel flipped and
padded for ``full`` and ``same``.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.scalar.basic import upcast
from pytensor_tpu_torch.tensor.basic import as_tensor_variable
from pytensor_tpu_torch.tensor.type import TensorType


class Convolve1d(Op):
    __props__ = ("mode",)
    gufunc_signature = "(n),(k)->(m)"

    def __init__(self, mode="full"):
        if mode not in ("full", "valid", "same"):
            raise ValueError("mode must be full/valid/same")
        self.mode = mode

    def make_node(self, in1, in2):
        in1, in2 = as_tensor_variable(in1), as_tensor_variable(in2)
        if in1.type.ndim != 1 or in2.type.ndim != 1:
            raise TypeError("Convolve1d core works on vectors (Blockwise to batch)")
        n, k = in1.type.shape[0], in2.type.shape[0]
        if n is not None and k is not None:
            if self.mode == "full":
                m = n + k - 1
            elif self.mode == "valid":
                m = max(n, k) - min(n, k) + 1
            else:
                m = n
        else:
            m = None
        dtype = upcast(in1.type.dtype, in2.type.dtype)
        return Apply(self, [in1, in2], [TensorType(dtype, (m,))()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.asarray(
            np.convolve(*inputs, mode=self.mode),
            dtype=node.outputs[0].type.numpy_dtype,
        )

    def infer_shape(self, fgraph, node, input_shapes):
        from pytensor_tpu_torch.tensor import math as tm
        from pytensor_tpu_torch.tensor.basic import constant

        (n,), (k,) = input_shapes
        if self.mode == "full":
            return [(n + k - constant(np.int64(1)),)]
        if self.mode == "valid":
            return [(tm.maximum(n, k) - tm.minimum(n, k) + constant(np.int64(1)),)]
        return [(n,)]

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.tensor.subtensor import flip

        in1, in2 = inputs
        (gz,) = output_grads
        if self.mode == "full":
            g1 = Convolve1d("valid")(gz, flip(in2, 0))
            g2 = Convolve1d("valid")(gz, flip(in1, 0))
            return [g1, g2]
        if self.mode == "valid":
            # y[t] = sum_j x[t+K-1-j] k[j]  (np.convolve valid, n >= k)
            # => dk[j] = sum_t gz[t] x[t+K-1-j] = flip(valid(x, flip(gz)))
            g1 = Convolve1d("full")(gz, flip(in2, 0))
            g2 = flip(Convolve1d("valid")(in1, flip(gz, 0)), 0)
            return [g1, g2]
        # mode == "same": y = full(x, k)[(K-1)//2 : (K-1)//2 + N].
        # Embed gz into the full-length cotangent, then reuse the
        # full-mode pullback.
        from pytensor_tpu_torch.gradient import grad_not_implemented
        from pytensor_tpu_torch.tensor.basic import zeros
        from pytensor_tpu_torch.tensor.shape import shape
        from pytensor_tpu_torch.tensor.subtensor import set_subtensor

        n_s, k_s = in1.type.shape[0], in2.type.shape[0]
        if n_s is None or k_s is None:
            return [grad_not_implemented(self, 0, in1,
                                         "same-mode grad needs static dims"),
                    grad_not_implemented(self, 1, in2,
                                         "same-mode grad needs static dims")]
        off = (k_s - 1) // 2
        gzf = set_subtensor(
            zeros((n_s + k_s - 1,), dtype=gz.type.dtype)[off: off + n_s], gz)
        g1 = Convolve1d("valid")(gzf, flip(in2, 0))
        g2 = Convolve1d("valid")(gzf, flip(in1, 0))
        return [g1, g2]


def convolve1d(in1, in2, mode="full"):
    in1, in2 = as_tensor_variable(in1), as_tensor_variable(in2)
    if in1.type.ndim > 1 or in2.type.ndim > 1:
        from pytensor_tpu_torch.tensor.blockwise import Blockwise

        return Blockwise(Convolve1d(mode), signature="(n),(k)->(m)")(in1, in2)
    return Convolve1d(mode)(in1, in2)


class Convolve2d(Op):
    __props__ = ("mode",)
    gufunc_signature = "(m,n),(j,k)->(p,q)"

    def __init__(self, mode="full"):
        if mode not in ("full", "valid", "same"):
            raise ValueError("mode must be full/valid/same")
        self.mode = mode

    def make_node(self, in1, in2):
        in1, in2 = as_tensor_variable(in1), as_tensor_variable(in2)
        if in1.type.ndim != 2 or in2.type.ndim != 2:
            raise TypeError("Convolve2d core works on matrices")
        dtype = upcast(in1.type.dtype, in2.type.dtype)

        def dim(n, k):
            if n is None or k is None:
                return None
            if self.mode == "full":
                return n + k - 1
            if self.mode == "valid":
                return max(n, k) - min(n, k) + 1
            return n

        out_shape = tuple(
            dim(n, k) for n, k in zip(in1.type.shape, in2.type.shape)
        )
        return Apply(self, [in1, in2], [TensorType(dtype, out_shape)()])

    def perform(self, node, inputs, output_storage):
        import scipy.signal as ss

        output_storage[0][0] = np.asarray(
            ss.convolve2d(*inputs, mode=self.mode),
            dtype=node.outputs[0].type.numpy_dtype,
        )

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.tensor.subtensor import flip

        def flip2(v):
            return flip(flip(v, 0), 1)

        in1, in2 = inputs
        (gz,) = output_grads
        if self.mode == "full":
            return [Convolve2d("valid")(gz, flip2(in2)),
                    Convolve2d("valid")(gz, flip2(in1))]
        if self.mode == "valid":
            # same derivation as Convolve1d.L_op, per axis
            return [Convolve2d("full")(gz, flip2(in2)),
                    flip2(Convolve2d("valid")(in1, flip2(gz)))]
        from pytensor_tpu_torch.gradient import grad_not_implemented
        from pytensor_tpu_torch.tensor.basic import zeros
        from pytensor_tpu_torch.tensor.subtensor import set_subtensor

        shp1, shp2 = in1.type.shape, in2.type.shape
        if None in shp1 or None in shp2:
            return [grad_not_implemented(self, 0, in1,
                                         "same-mode grad needs static dims"),
                    grad_not_implemented(self, 1, in2,
                                         "same-mode grad needs static dims")]
        offs = tuple((k - 1) // 2 for k in shp2)
        full_shape = tuple(n + k - 1 for n, k in zip(shp1, shp2))
        idx = tuple(slice(o, o + n) for o, n in zip(offs, shp1))
        gzf = set_subtensor(
            zeros(full_shape, dtype=gz.type.dtype)[idx], gz)
        return [Convolve2d("valid")(gzf, flip2(in2)),
                Convolve2d("valid")(gzf, flip2(in1))]


def convolve2d(in1, in2, mode="full"):
    return Convolve2d(mode)(in1, in2)
