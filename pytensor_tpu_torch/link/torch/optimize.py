"""The lowerings of ``tensor/optimize.py``: the JAX package's BFGS and Newton
loops in torch, on the function's device.

Counterpart of ``pytensor_tpu/tensor/optimize.py:346-394``, which runs
``jax.scipy.optimize.minimize(method="BFGS")`` for ``MinimizeOp`` and
``MinimizeScalarOp`` (jax's ``minimize_bfgs``,
``jax/_src/scipy/optimize/bfgs.py``, with its ``line_search`` and
``_zoom``, ``line_search.py``) and 25 Newton steps under ``lax.scan`` for
``RootOp`` and ``RootScalarOp``.  Both ignore ``optimizer_kwargs``, as the
JAX package's lowering does.

**BFGS** copies jax's algorithm, not only its results: the inverse
Hessian's update ``w H w^T + rho s s^T`` (kept where ``rho`` is not
finite), the Wolfe constants (``c1 = 1e-4``, ``c2 = 0.9``), the zoom's
cubic, quadratic and bisection steps and its thresholds (``1e-5`` below
64 bits, ``1e-10``; 30 steps), a line search of at most 10 steps that
starts at ``min(1, 2.02 (f_k - f_{k-1}) / phi'(0))`` and doubles, the
stopping rule ``|g|_inf < 1e-5`` and ``maxiter = 200 * size``, jax's
``status``, the step of an iteration whose line search failed still taken
(a failed zoom gives the step 1), and the float32 floor of 1e-8 on the
step.  Its design:

- The objective and its gradient at ``x = xk + t pk`` are one linked
  function of ``(xk, pk, t, *args)`` (``_evaluation_graph``: the inner
  graph, the port's ``grad`` of it, rewritten with ``FAST_RUN`` so that its
  elementwise chains are K1 groups), which gives ``g`` and four numbers:
  ``f``, ``phi'(t) = g . pk``, ``|g|_inf`` and ``|g|_2``.  It is linked once
  per op and device; on a card each signature is captured once
  (``linker.py _capture``) and each evaluation is one replay of that CUDA
  graph with its K1 launches, after ``xk``, ``pk`` and ``t`` are written
  into its static inputs (the args are copied in once a fit).
- The vectors and ``H`` (size x size) stay on the device; jax's
  ``while_loop`` state of scalars (the line search's and the zoom's) is
  kept on the host as numpy scalars of ``x``'s dtype, so that a float32
  fit does its scalar arithmetic in float32, as jax's does.  Each
  evaluation reads its four numbers back, once; each iteration reads
  ``phi'(0) = g_k . p_k`` once more, before its line search.
- The loop's exit is read from the device, so the lowering declares
  ``reads_back`` and a plan holding it runs eagerly, around the captured
  evaluations.

**Newton** (``RootOp``): 25 steps of ``x - J^{-1} f`` (``f / J`` for a 0-d
``x``), ``J`` by the port's vectorized ``jacobian``, each solve
``torch.linalg.solve_ex`` (a library solve, as the JAX package leaves
``jnp.linalg.solve`` to XLA), then ``success = all(|f(x*)| < 1e-8)``.
Nothing is read back, so a plan holding it is captured whole: 26
evaluations of one linked function of ``f`` and ``J`` (the last for the
residual) with their K1 launches, and 25 solves.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pytensor_tpu_torch.config import config
from pytensor_tpu_torch.link.torch.dispatch import ports, torch_funcify
from pytensor_tpu_torch.tensor.optimize import MinimizeOp, RootOp

# jax's minimize_bfgs and line_search defaults
GTOL = 1e-5
LINE_SEARCH_STEPS = 10
C1, C2 = 1e-4, 0.9
ZOOM_STEPS = 30
NEWTON_STEPS = 25
NEWTON_TOL = 1e-8


def _rewritten(inputs, outputs):
    """The FunctionGraph of ``outputs`` rewritten with ``FAST_RUN``."""
    from pytensor_tpu_torch.compile.mode import FAST_RUN
    from pytensor_tpu_torch.graph.fg import FunctionGraph

    fg = FunctionGraph(inputs, outputs, clone=True)
    FAST_RUN.optimizer.rewrite(fg)
    return fg


def _objective_at(op, x, args):
    """The op's inner output with its inputs replaced by ``x`` and ``args``."""
    from pytensor_tpu_torch.graph.replace import clone_replace

    return clone_replace(op.fgraph.outputs, dict(zip(op.fgraph.inputs, [x, *args])))[0]


def _evaluation_graph(op):
    """``(xk, pk, t, *args) -> (stats, g)``: at ``x = xk + t pk``, ``g`` the
    gradient of the objective and ``stats`` ``[f, g . pk, |g|_inf, |g|_2]``
    in the objective's dtype."""
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.gradient import grad
    from pytensor_tpu_torch.tensor.type import TensorType

    x_var = op.fgraph.inputs[0]
    xk, pk = x_var.type(), x_var.type()
    t = TensorType(x_var.type.dtype, ())()
    args = [i.type() for i in op.fgraph.inputs[1:]]
    f = _objective_at(op, xk + t * pk, args)
    g = grad(f, xk)
    dt = f.type.dtype
    stats = pt.stack([pt.cast(v, dt) for v in
                      (f, pt.sum(g * pk), pt.max(pt.abs(g)), pt.sqrt(pt.sum(g * g)))])
    return _rewritten([xk, pk, t, *args], [stats, g])


class Evaluations:
    """The objective and its gradient along a line (``_evaluation_graph``)
    on one device: ``start(x, args)`` binds a fit's args, then
    ``evaluate(xk, pk, t)`` gives the four numbers (host floats) and ``g``
    (a tensor valid until the next evaluation).  On a card, with
    ``config.xla__jit`` and a capturable plan, each signature is captured
    once and each evaluation is a replay; ``graphs`` holds the captures."""

    def __init__(self, op, device):
        from pytensor_tpu_torch.link.torch.linker import fgraph_to_torch

        self.plan = fgraph_to_torch(_evaluation_graph(op), device, trust_input=True)
        dev = self.plan.device
        self.dtype = op.fgraph.inputs[0].type.dtype
        self.captured = dev.type == "cuda" and config.xla__jit and self.plan.capturable
        self.graphs: dict = {}
        self.graph = None
        self.args = ()
        self.count = 0

    def start(self, x, args):
        from pytensor_tpu_torch.link.torch.linker import _capture, _copy_into, _signature

        self.args = list(args)
        if not self.captured:
            return
        key = tuple(_signature(a) for a in (x, *self.args))
        graph = self.graphs.get(key)
        if graph is None:
            t = torch.zeros((), dtype=x.dtype, device=x.device)
            graph, _ = _capture(self.plan, [x, torch.zeros_like(x), t, *self.args])
            self.graphs[key] = graph
        for buffer, value in zip(graph.inputs[3:], self.args):
            _copy_into(buffer, value)
        self.graph = graph

    def evaluate(self, xk, pk, t):
        self.count += 1
        if self.captured:
            graph = self.graph
            graph.inputs[0].copy_(xk)
            graph.inputs[1].copy_(pk)
            graph.inputs[2].fill_(float(t))
            stats, g = graph.run()
        else:
            tt = torch.full((), float(t), dtype=xk.dtype, device=xk.device)
            stats, g = self.plan.execute([xk, pk, tt, *self.args])
        return stats.tolist(), g


class _Point:
    """A point of the line search: its step, value, slope along ``p``,
    ``|g|_inf`` and gradient (a device tensor of its own)."""

    __slots__ = ("a", "phi", "dphi", "gmax", "g")

    def __init__(self, a, phi, dphi, gmax, g):
        self.a, self.phi, self.dphi, self.gmax, self.g = a, phi, dphi, gmax, g


def _cubicmin(R, a, fa, fpa, b, fb, c, fc):
    """jax's ``_cubicmin`` in dtype ``R`` (NaN where the cubic has no
    minimum: the bounds checks then refuse it)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    d0, d1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * d0 + -(db ** 2) * d1) / denom
    B = (-(dc ** 3) * d0 + db ** 3 * d1) / denom
    radical = B * B - R(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (R(3.0) * A)


def _quadmin(R, a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (R(2.0) * B)


class BFGS:
    """jax's ``minimize_bfgs`` over ``Evaluations``; ``run(x0, args)``
    returns ``(x*, success)`` and leaves the fit's record in ``last``:
    iterations, evaluations, reads of the device, ``status``, the last
    ``|g|_inf`` and the wall seconds."""

    def __init__(self, evaluations):
        self.ev = evaluations
        self.R = np.dtype(evaluations.dtype).type
        self.wide = np.finfo(self.R).bits == 64
        self.last: dict = {}

    def _eval(self, xk, pk, t):
        """The point at step ``t``, its gradient copied out of the capture."""
        (phi, dphi, gmax, _), g = self.ev.evaluate(xk, pk, t)
        self.reads += 1
        R = self.R
        return _Point(R(t), R(phi), R(dphi), R(gmax), g.clone())

    def run(self, x0, args):
        t0 = time.perf_counter()
        R = self.R
        self.reads = 0
        n0 = self.ev.count
        shape = x0.shape
        x = x0.reshape(-1).clone()
        d = x.numel()
        maxiter = 200 * d
        self.ev.start(x.view(shape), args)

        def view(v):
            return v.view(shape)

        (f, _, gmax, gnorm), g = self.ev.evaluate(view(x), view(torch.zeros_like(x)), R(0.0))
        self.reads += 1
        f, gmax, g = R(f), R(gmax), g.reshape(-1).clone()
        eye = torch.eye(d, dtype=x.dtype, device=x.device)
        H = eye.clone()
        converged, failed, k, ls_status = bool(gmax < R(GTOL)), False, 0, 0
        old_old = f + R(gnorm) / R(2.0)
        while not converged and not failed and k < maxiter:
            p = -(H @ g)
            dphi0 = R(torch.dot(g, p).item())
            self.reads += 1
            point = _Point(R(0.0), f, dphi0, gmax, g)
            star, failed, ls_status = self._line_search(view(x), view(p), point, old_old)
            s = p * float(star.a)
            x_next = x + s
            y = star.g.reshape(-1) - g
            rho = torch.reciprocal(torch.dot(y, s))
            w = eye - rho * torch.outer(s, y)
            H = torch.where(torch.isfinite(rho), w @ H @ w.T + rho * torch.outer(s, s), H)
            converged = bool(star.gmax < R(GTOL))
            k += 1
            x, old_old, f, g, gmax = x_next, f, star.phi, star.g.reshape(-1), star.gmax
        status = (0 if converged else 1 if k == maxiter else 2 + ls_status if failed else -1)
        self.last = {"iterations": k, "evaluations": self.ev.count - n0, "reads": self.reads,
                     "status": status, "gmax": float(gmax),
                     "seconds": time.perf_counter() - t0}
        success = torch.tensor(converged and not failed, device=x.device)
        return x.view(shape), success

    def _line_search(self, xk, pk, p0, old_old):
        """jax's ``line_search`` from ``p0`` (step 0); returns the accepted
        point (step floored in float32), ``failed`` and its status."""
        R = self.R
        phi0, dphi0 = p0.phi, p0.dphi
        with np.errstate(all="ignore"):
            cand = R(1.01 * 2) * (phi0 - old_old) / dphi0
        start = R(1.0) if cand > 1 else cand

        def wolfe_one(a, phi):
            return phi > phi0 + R(C1) * a * dphi0

        def wolfe_two(dphi):
            return abs(dphi) <= -R(C2) * dphi0

        done, failed, i = False, False, 1
        prev = p0
        star = _Point(R(0.0), phi0, dphi0, p0.gmax, p0.g)
        while not done and i <= LINE_SEARCH_STEPS and not failed:
            a = start if i == 1 else prev.a * R(2.0)
            cur = self._eval(xk, pk, a)
            to_zoom1 = wolfe_one(a, cur.phi) or (cur.phi >= prev.phi and i > 1)
            to_i = wolfe_two(cur.dphi) and not to_zoom1
            to_zoom2 = cur.dphi >= 0 and not to_zoom1 and not to_i
            if to_zoom1 or to_zoom2:
                lo, hi = (prev, cur) if to_zoom1 else (cur, prev)
                zstar, zfailed = self._zoom(xk, pk, lo, hi, p0, wolfe_one, wolfe_two)
                star, done, failed = zstar, True, failed or zfailed
            elif to_i:
                star, done = cur, True
            i += 1
            prev = cur
        status = 1 if failed else 3 if i > LINE_SEARCH_STEPS else 0
        failed = failed or not done
        if not self.wide and abs(star.a) < R(1e-8):
            star = _Point(np.sign(star.a) * R(1e-8), star.phi, star.dphi, star.gmax, star.g)
        return star, failed, status

    def _zoom(self, xk, pk, lo, hi, p0, wolfe_one, wolfe_two):
        """jax's ``_zoom`` between ``lo`` and ``hi``; returns the point it
        accepted (a step of 1 at ``lo``'s value and ``p0``'s gradient if
        none) and whether it failed."""
        R = self.R
        threshold = R(1e-10) if self.wide else R(1e-5)
        a_lo, phi_lo, dphi_lo = lo.a, lo.phi, lo.dphi
        a_hi, phi_hi, dphi_hi = hi.a, hi.phi, hi.dphi
        a_rec, phi_rec = (a_lo + a_hi) / R(2.0), (phi_lo + phi_hi) / R(2.0)
        star = _Point(R(1.0), phi_lo, dphi_lo, p0.gmax, p0.g)
        done, failed, j = False, False, 0
        while not done and not failed:
            dalpha = a_hi - a_lo
            a, b = min(a_hi, a_lo), max(a_hi, a_lo)
            cchk, qchk = R(0.2) * dalpha, R(0.1) * dalpha
            failed = failed or bool(dalpha <= threshold)
            with np.errstate(all="ignore"):
                cubic = _cubicmin(R, a_lo, phi_lo, dphi_lo, a_hi, phi_hi, a_rec, phi_rec)
                quad = _quadmin(R, a_lo, phi_lo, dphi_lo, a_hi, phi_hi)
            use_cubic = j > 0 and a + cchk < cubic < b - cchk
            use_quad = not use_cubic and a + qchk < quad < b - qchk
            a_j = cubic if use_cubic else quad if use_quad else (a_lo + a_hi) / R(2.0)
            cur = self._eval(xk, pk, a_j)
            hi_to_j = wolfe_one(a_j, cur.phi) or cur.phi >= phi_lo
            star_to_j = wolfe_two(cur.dphi) and not hi_to_j
            hi_to_lo = cur.dphi * (a_hi - a_lo) >= 0 and not hi_to_j and not star_to_j
            lo_to_j = not hi_to_j and not star_to_j
            if hi_to_j:
                a_rec, phi_rec = a_hi, phi_hi
                a_hi, phi_hi, dphi_hi = a_j, cur.phi, cur.dphi
            if star_to_j:
                done, star = True, cur
            if hi_to_lo:
                a_rec, phi_rec = a_hi, phi_hi
                a_hi, phi_hi, dphi_hi = a_lo, phi_lo, dphi_lo
            if lo_to_j and not hi_to_lo:
                a_rec, phi_rec = a_lo, phi_lo
            if lo_to_j:
                a_lo, phi_lo, dphi_lo = a_j, cur.phi, cur.dphi
            j += 1
            failed = failed or j >= ZOOM_STEPS
        return star, failed


@torch_funcify.register(MinimizeOp)
@ports(reads_back="BFGS reads each evaluation's value, slope and gradient norm back, "
                  "and its loop ends on them")
def _minimize(op, node=None, device=None, **kw):
    """BFGS (``BFGS``) for ``MinimizeOp`` and ``MinimizeScalarOp``: returns
    ``minimize(x0, *args) -> (x*, success)``; ``.bfgs`` is the loop, whose
    ``last`` records the latest fit."""
    bfgs = BFGS(Evaluations(op, device))

    def minimize(x0, *args):
        if not x0.is_floating_point():
            raise TypeError(f"BFGS minimizes over a float x, got {x0.dtype}")
        return bfgs.run(x0, args)

    minimize.bfgs = bfgs
    return minimize


@torch_funcify.register(RootOp)
def _root(op, node=None, device=None, **kw):
    """25 Newton steps for ``RootOp`` and ``RootScalarOp``: returns
    ``newton(x0, *args) -> (x*, success)``; ``.inner`` is the plan of
    ``f`` and its Jacobian, whose host reads the capture rule reads."""
    from pytensor_tpu_torch import gradient as G
    from pytensor_tpu_torch.link.torch.linker import fgraph_to_torch

    x_var = op.fgraph.inputs[0]
    if x_var.type.ndim > 1:
        raise NotImplementedError("Newton's lowering takes a 0-d or 1-d x")
    x = x_var.type()
    args = [i.type() for i in op.fgraph.inputs[1:]]
    f = _objective_at(op, x, args)
    J = G.jacobian(f, x) if x_var.type.ndim else G.grad(f, x)
    plan = fgraph_to_torch(_rewritten([x, *args], [f, J]), device, trust_input=True)

    def newton(x0, *args):
        x = x0
        for _ in range(NEWTON_STEPS):
            fx, jx = plan.run([x, *args])
            if x.ndim:
                dx = torch.linalg.solve_ex(jx, fx.unsqueeze(-1))[0].squeeze(-1)
            else:
                dx = fx / jx
            x = x - dx
        resid = plan.run([x, *args])[0]
        return x, torch.all(torch.abs(resid) < NEWTON_TOL)

    newton.inner = plan
    return newton
