"""Real FFT ops: ``RFFTOp``, ``IRFFTOp``, ``rfft``, ``irfft``.

Counterpart of ``pytensor_tpu/tensor/fft.py`` (PyTensor's tensor/fft.py
RFFTOp:12, IRFFTOp:72).  A complex spectrum is packed as a trailing
(real, imaginary) pair of floats, as in the JAX package: the port has no
complex dtypes yet (ROADMAP Queue 1).  The torch lowerings
(``link/torch/dispatch.py``, section "fft") run ``torch.fft``, cuFFT on a
card, and carry ``norm`` through.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.tensor.basic import as_tensor_variable
from pytensor_tpu_torch.tensor.type import TensorType


class RFFTOp(Op):
    __props__ = ("norm",)

    def __init__(self, norm=None):
        self.norm = norm

    def make_node(self, a, s=None):
        a = as_tensor_variable(a)
        if a.type.ndim < 1:
            raise TypeError("rfft needs ndim >= 1")
        half = None
        if a.type.shape[-1] is not None:
            half = a.type.shape[-1] // 2 + 1
        out_shape = (*a.type.shape[:-1], half, 2)
        out = TensorType(a.type.dtype if a.type.dtype == "float64" else "float32",
                         out_shape)()
        return Apply(self, [a], [out])

    def perform(self, node, inputs, output_storage):
        (a,) = inputs
        res = np.fft.rfft(a, axis=-1, norm=self.norm)
        packed = np.stack([res.real, res.imag], axis=-1)
        output_storage[0][0] = packed.astype(node.outputs[0].type.numpy_dtype)

    def infer_shape(self, fgraph, node, input_shapes):
        from pytensor_tpu_torch.tensor.basic import constant

        (ashp,) = input_shapes
        return [(*ashp[:-1], ashp[-1] // 2 + 1, constant(np.int64(2)))]

    def L_op(self, inputs, outputs, output_grads):
        # adjoint of the packed real FFT (reference fft.py:50): interior
        # bins are double-counted by the inverse's hermitian symmetry —
        # halve them, then apply N * irfft (our irfft is normalized)
        from pytensor_tpu_torch.tensor.shape import shape
        from pytensor_tpu_torch.tensor.subtensor import set_subtensor

        if self.norm is not None:
            from pytensor_tpu_torch.gradient import grad_not_implemented

            return [grad_not_implemented(self, 0, inputs[0],
                                         "rfft grad with norm")]
        (a,) = inputs
        (gout,) = output_grads
        n = shape(a)[-1]
        idx = ([slice(None)] * (gout.type.ndim - 2)
               + [slice(1, (n // 2) + (n % 2)), slice(None)])
        gout = set_subtensor(gout[tuple(idx)], gout[tuple(idx)] * 0.5)
        from pytensor_tpu_torch.tensor.basic import cast

        n_static = a.type.shape[-1]
        if n_static is None:
            from pytensor_tpu_torch.gradient import grad_not_implemented

            return [grad_not_implemented(
                self, 0, a, "rfft grad needs a static last dim")]
        return [IRFFTOp(n=n_static)(gout) * cast(n, gout.type.dtype)]


class IRFFTOp(Op):
    __props__ = ("norm", "n")

    def __init__(self, norm=None, n=None):
        self.norm = norm
        self.n = None if n is None else int(n)

    def make_node(self, a, n=None):
        a = as_tensor_variable(a)
        if a.type.ndim < 2 or a.type.shape[-1] not in (2, None):
            raise TypeError("irfft expects packed (..., k, 2) input")
        if self.n is not None:
            last = self.n
        elif a.type.shape[-2] is not None:
            last = 2 * (a.type.shape[-2] - 1)
        else:
            last = None
        out = TensorType(
            a.type.dtype if a.type.dtype == "float64" else "float32",
            (*a.type.shape[:-2], last),
        )()
        return Apply(self, [a], [out])

    def perform(self, node, inputs, output_storage):
        (a,) = inputs
        comp = a[..., 0] + 1j * a[..., 1]
        res = np.fft.irfft(comp, n=self.n, axis=-1, norm=self.norm)
        output_storage[0][0] = res.astype(node.outputs[0].type.numpy_dtype)

    def infer_shape(self, fgraph, node, input_shapes):
        from pytensor_tpu_torch.tensor.basic import constant

        (ashp,) = input_shapes
        return [(*ashp[:-2], (ashp[-2] - constant(np.int64(1))) * 2)]

    def L_op(self, inputs, outputs, output_grads):
        # adjoint of normalized irfft (reference fft.py:111 modulo our
        # np-normalized convention): rfft(gout) with interior doubled, / N
        from pytensor_tpu_torch.tensor.basic import cast
        from pytensor_tpu_torch.tensor.shape import shape
        from pytensor_tpu_torch.tensor.subtensor import set_subtensor

        if self.norm is not None:
            from pytensor_tpu_torch.gradient import grad_not_implemented

            return [grad_not_implemented(self, 0, inputs[0],
                                         "irfft grad with norm")]
        (a,) = inputs
        (gout,) = output_grads
        n = shape(gout)[-1]
        gf = RFFTOp()(gout)
        idx = ([slice(None)] * (gf.type.ndim - 2)
               + [slice(1, (n // 2) + (n % 2)), slice(None)])
        gf = set_subtensor(gf[tuple(idx)], gf[tuple(idx)] * 2.0)
        return [gf / cast(n, gf.type.dtype)]


def rfft(inp, norm=None):
    return RFFTOp(norm)(inp)


def irfft(inp, norm=None):
    return IRFFTOp(norm)(inp)
