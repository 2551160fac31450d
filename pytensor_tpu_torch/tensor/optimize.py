"""Optimization ops: minimize and root, with implicit-function gradients.

Counterpart of ``pytensor_tpu/tensor/optimize.py`` (PyTensor's
tensor/optimize.py MinimizeOp:672, MinimizeScalarOp:552, RootOp:1043,
RootScalarOp:886).  Each op wraps an inner objective graph of ``(x,
*args)``; its inputs are ``(x0, *args)``, its outputs ``(x*, success)``.
The forward pass runs a solver, the gradient comes from the implicit
function theorem on the optimality condition (``L_op``).

Two forward passes, as in the JAX package:

- ``perform`` is the oracle: scipy (``minimize``, ``minimize_scalar``,
  ``root`` with ``hybr``, ``root_scalar`` with ``newton``) on the inner
  graph linked for the CPU; ``RootScalarOp``'s ``fprime`` is the symbolic
  gradient of the inner graph, linked.
- the lowering (``link/torch/optimize.py``) runs the JAX package's device
  loops in torch on the function's device: BFGS (jax's ``minimize_bfgs``
  and its Wolfe line search) for ``MinimizeOp`` and ``MinimizeScalarOp``,
  25 Newton steps for ``RootOp`` and ``RootScalarOp``.  It ignores
  ``optimizer_kwargs``, as the JAX package's lowering does.
"""

from __future__ import annotations

import copy

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply, Constant, clone_get_equiv
from pytensor_tpu_torch.graph.fg import FunctionGraph
from pytensor_tpu_torch.graph.null_type import DisconnectedType
from pytensor_tpu_torch.graph.op import HasInnerGraph, Op
from pytensor_tpu_torch.graph.traversal import graph_inputs
from pytensor_tpu_torch.tensor.basic import as_tensor_variable
from pytensor_tpu_torch.tensor.type import TensorType


def _cpu_function(fgraph):
    """``fgraph`` linked for the CPU, as a function of numpy values that
    returns numpy values."""
    from pytensor_tpu_torch.link.torch.convert import to_numpy
    from pytensor_tpu_torch.link.torch.linker import fgraph_to_torch

    plan = fgraph_to_torch(fgraph, "cpu")

    def fn(*args):
        return [to_numpy(r) for r in plan(*args)]

    return fn


class MinimizeOp(Op, HasInnerGraph):
    """argmin_x f(x, *args); inputs (x0, *args) -> (x_star, success).

    The gradient with respect to ``args`` is the implicit function
    theorem's on the stationarity condition grad_x f(x*, args) = 0:
    d x*/d args = -H_xx^{-1} H_x,args.
    """

    default_output = 0

    def __init__(self, fgraph: FunctionGraph, method="BFGS", optimizer_kwargs=None):
        # fgraph: inputs [x, *args], outputs [objective]
        self.fgraph = fgraph
        self.method = method
        self.optimizer_kwargs = optimizer_kwargs or {}
        self._fn = None

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)

    def clone(self):
        res = copy.copy(self)
        res.fgraph = self.fgraph.clone()
        res._fn = None
        return res

    def make_node(self, x0, *args):
        x0 = as_tensor_variable(x0)
        args = [as_tensor_variable(a) for a in args]
        success = TensorType("bool", ())()
        return Apply(self, [x0, *args], [x0.type(), success])

    def _objective_callable(self):
        """The inner graph on the CPU: ``fn(x, *args)`` gives its output."""
        if self._fn is None:
            inner = _cpu_function(self.fgraph)
            self._fn = lambda x, *args: inner(x, *args)[0]
        return self._fn

    def perform(self, node, inputs, output_storage):
        import scipy.optimize as sopt

        x0, *args = inputs
        fn = self._objective_callable()

        def obj(x):
            return float(fn(np.asarray(x, dtype=x0.dtype).reshape(np.shape(x0)), *args))

        res = sopt.minimize(obj, np.asarray(x0).ravel(), method=self.method,
                            **self.optimizer_kwargs)
        output_storage[0][0] = np.asarray(res.x, dtype=node.outputs[0].type.numpy_dtype
                                          ).reshape(np.shape(x0))
        output_storage[1][0] = np.asarray(bool(res.success))

    def _at_solution(self, inputs, outputs):
        """The inner output re-expressed at ``disconnected_grad(x*)`` with
        the outer args, so that the inner gradients do not recurse into
        this op's own ``L_op``."""
        from pytensor_tpu_torch import gradient as G

        x0, *args = inputs
        x_cut = G.disconnected_grad(outputs[0])
        memo = {self.fgraph.inputs[0]: x_cut}
        memo.update(zip(self.fgraph.inputs[1:], args))
        memo = clone_get_equiv(self.fgraph.inputs, self.fgraph.outputs,
                               copy_inputs=False, copy_orphans=False, memo=memo)
        return x_cut, memo[self.fgraph.outputs[0]]

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch import gradient as G
        from pytensor_tpu_torch.tensor.linalg import solve

        args = inputs[1:]
        gx = output_grads[0]
        x_cut, obj = self._at_solution(inputs, outputs)
        gstar = G.grad(obj, x_cut, disconnected_inputs="ignore")
        grads = [DisconnectedType()()]
        if x_cut.type.ndim == 0:
            hess = G.grad(gstar, x_cut, disconnected_inputs="ignore")
            lam = -gx / hess
            for a in args:
                grads.append(G.grad(gstar * G.disconnected_grad(lam), a,
                                    disconnected_inputs="ignore"))
            return grads
        H = G.hessian(obj, x_cut)
        lam = -solve(H, gx, assume_a="sym", b_ndim=1)
        for a in args:
            inner_prod = (gstar * G.disconnected_grad(lam)).sum()
            grads.append(G.grad(inner_prod, a, disconnected_inputs="ignore"))
        return grads

    def __str__(self):
        return f"MinimizeOp{{{self.method}}}"


def _params(expr, x):
    """Every non-constant root input of ``expr`` but ``x``."""
    return [v for v in graph_inputs([expr])
            if v is not x and v.owner is None and not isinstance(v, Constant)]


def minimize(objective, x, method="BFGS", optimizer_kwargs=None, debug=False):
    """Symbolic argmin of ``objective`` with respect to ``x``; every other
    graph input is a parameter with an implicit-function gradient."""
    x = as_tensor_variable(x)
    params = _params(objective, x)
    fg = FunctionGraph([x, *params], [objective], clone=True)
    op = MinimizeOp(fg, method=method, optimizer_kwargs=optimizer_kwargs)
    x_star = op(x, *params)
    return (x_star, x_star.owner.outputs[1]), op


class RootOp(MinimizeOp):
    """Solve f(x, args) = 0; the gradient is d x*/d args = -J_x^{-1} J_args."""

    def perform(self, node, inputs, output_storage):
        import scipy.optimize as sopt

        x0, *args = inputs
        fn = self._objective_callable()

        def fun(x):
            return np.asarray(fn(np.asarray(x, dtype=x0.dtype).reshape(np.shape(x0)),
                                 *args)).ravel()

        res = sopt.root(fun, np.asarray(x0).ravel(), method="hybr")
        output_storage[0][0] = np.asarray(
            res.x, dtype=node.outputs[0].type.numpy_dtype).reshape(np.shape(x0))
        output_storage[1][0] = np.asarray(bool(res.success))

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch import gradient as G
        from pytensor_tpu_torch.tensor.basic import matrix_transpose
        from pytensor_tpu_torch.tensor.linalg import solve

        args = inputs[1:]
        gx = output_grads[0]
        x_cut, f_star = self._at_solution(inputs, outputs)
        grads = [DisconnectedType()()]
        if x_cut.type.ndim == 0:
            jxx = G.grad(f_star, x_cut, disconnected_inputs="ignore")
            lam = -gx / jxx
            for a in args:
                grads.append(G.grad(f_star * G.disconnected_grad(lam), a,
                                    disconnected_inputs="ignore"))
            return grads
        J = G.jacobian(f_star, x_cut)
        lam = -solve(matrix_transpose(J), gx, b_ndim=1)
        for a in args:
            inner_prod = (f_star * G.disconnected_grad(lam)).sum()
            grads.append(G.grad(inner_prod, a, disconnected_inputs="ignore"))
        return grads

    def __str__(self):
        return "RootOp"


def root(equations, variables, method="hybr", optimizer_kwargs=None):
    x = as_tensor_variable(variables)
    params = _params(equations, x)
    fg = FunctionGraph([x, *params], [equations], clone=True)
    op = RootOp(fg, optimizer_kwargs=optimizer_kwargs)
    x_star = op(x, *params)
    return (x_star, x_star.owner.outputs[1]), op


class MinimizeScalarOp(MinimizeOp):
    """argmin over a scalar variable.  The oracle runs
    ``scipy.optimize.minimize_scalar`` (brent or golden); the lowering is
    ``MinimizeOp``'s, BFGS on the one-element ``x``, as in the JAX package
    (whose docstring says a safeguarded Newton, but whose lowering takes
    the BFGS branch)."""

    def __init__(self, fgraph, method="brent", optimizer_kwargs=None):
        super().__init__(fgraph, method=method, optimizer_kwargs=optimizer_kwargs)

    def perform(self, node, inputs, output_storage):
        import scipy.optimize as sopt

        x0, *args = inputs
        fn = self._objective_callable()

        def obj(x):
            return float(fn(np.asarray(x, dtype=x0.dtype), *args))

        res = sopt.minimize_scalar(obj, method=self.method, **self.optimizer_kwargs)
        output_storage[0][0] = np.asarray(res.x, dtype=node.outputs[0].type.numpy_dtype)
        output_storage[1][0] = np.asarray(bool(res.success))

    def __str__(self):
        return f"MinimizeScalarOp{{{self.method}}}"


def _scalar_variable(x, what, instead):
    x = as_tensor_variable(x)
    if x.type.ndim != 0:
        raise ValueError(f"{what} requires a scalar variable; use {instead}")
    return x


def minimize_scalar(objective, x, method="brent", optimizer_kwargs=None):
    """Symbolic scalar argmin: ``x`` must be a 0-d variable; every other
    root input is a parameter with an implicit-function gradient."""
    x = _scalar_variable(x, "minimize_scalar", "minimize for vectors")
    params = _params(objective, x)
    fg = FunctionGraph([x, *params], [objective], clone=True)
    op = MinimizeScalarOp(fg, method=method, optimizer_kwargs=optimizer_kwargs)
    x_star = op(x, *params)
    return (x_star, x_star.owner.outputs[1]), op


class RootScalarOp(RootOp):
    """Solve f(x) = 0 for a scalar x.  The oracle runs
    ``scipy.optimize.root_scalar`` (newton by default, with the symbolic
    gradient of the inner graph as ``fprime``); the lowering is
    ``RootOp``'s 25 Newton steps."""

    def __init__(self, fgraph, method="newton", optimizer_kwargs=None):
        super().__init__(fgraph, method=method, optimizer_kwargs=optimizer_kwargs)
        self._fprime = None

    def clone(self):
        res = super().clone()
        res._fprime = None
        return res

    def _fprime_callable(self):
        """d f / d x of the inner graph, linked for the CPU."""
        if self._fprime is None:
            from pytensor_tpu_torch.gradient import grad

            x, *params = self.fgraph.inputs
            g = grad(self.fgraph.outputs[0], x, disconnected_inputs="ignore")
            inner = _cpu_function(FunctionGraph([x, *params], [g], clone=True))
            self._fprime = lambda x, *args: inner(x, *args)[0]
        return self._fprime

    def perform(self, node, inputs, output_storage):
        import scipy.optimize as sopt

        x0, *args = inputs
        fn = self._objective_callable()

        def f(x):
            return float(fn(np.asarray(x, dtype=x0.dtype), *args))

        kwargs = dict(self.optimizer_kwargs)
        if self.method in ("newton", "halley") and "fprime" not in kwargs:
            fp = self._fprime_callable()
            kwargs["fprime"] = lambda x: float(fp(np.asarray(x, dtype=x0.dtype), *args))
        res = sopt.root_scalar(f, x0=float(np.asarray(x0)), method=self.method, **kwargs)
        output_storage[0][0] = np.asarray(res.root, dtype=node.outputs[0].type.numpy_dtype)
        output_storage[1][0] = np.asarray(bool(res.converged))

    def __str__(self):
        return f"RootScalarOp{{{self.method}}}"


def root_scalar(equation, variables, method="newton", optimizer_kwargs=None):
    """Symbolic scalar root."""
    x = _scalar_variable(variables, "root_scalar", "root for systems")
    params = _params(equation, x)
    fg = FunctionGraph([x, *params], [equation], clone=True)
    op = RootScalarOp(fg, method=method, optimizer_kwargs=optimizer_kwargs)
    x_star = op(x, *params)
    return (x_star, x_star.owner.outputs[1]), op
