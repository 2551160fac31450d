"""The converged power iteration: ``benchsuite.py:160 ours_sparse`` as a
while-scan.

One step is the sparse power iteration's ``y = A x``, ``x_new = y /
(max|y| + 1e-9)``; the scan stops after the step at which ``max|x_new -
x| < tol``, or at ``n_steps``.  ``A`` is a scipy CSR matrix, a graph
constant, so the routed rewrite makes each product a K4 launch on a card
(``sparse/basic.py``), and the gradient's reverse scan one launch of K4 on
``A``'s transpose a step it runs.  ``power_graphs`` builds the graphs from
a package's namespaces, so that a test can build the same graphs in the
JAX package; ``power_reference`` is the float64 scipy loop.
"""

from __future__ import annotations

import numpy as np

N_STEPS = 64


def power_matrix(n=65536, nnz_per_row=10, seed=0):
    """``benchsuite.py ours_sparse``'s matrix and start: a float32 scipy
    CSR of ``n``² at ``nnz_per_row`` nonzeros a row and a ``(n, 1)``
    start, from one generator seeded with ``seed``."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=nnz_per_row / n, format="csr", random_state=rng, dtype="float32")
    x0 = rng.standard_normal((n, 1)).astype("float32")
    return A, x0


def power_graphs(ptt, pt, sparse, A, tol, n_steps=N_STEPS, stop=True):
    """``(x0, w, traces, grad)`` of a package's namespaces (``ptt`` the
    package, ``pt`` its tensor module, ``sparse`` its sparse module):
    ``traces`` is ``[xs]``, the executed prefix of the iterates from the
    input ``x0``, and ``grad`` the gradient of ``sum(xs[-1] * w)`` with
    respect to ``x0``.  Without ``stop``, the same steps as a for-scan of
    ``n_steps``, which computes the same test a step and traces it:
    ``traces`` is then ``[xs, converged]``."""
    import importlib

    until = importlib.import_module(ptt.__name__ + ".scan").until
    dtype = A.dtype.name
    a = sparse.as_sparse_variable(A)
    x0 = pt.tensor("x0", dtype=dtype, shape=(A.shape[0], 1))
    w = pt.tensor("w", dtype=dtype, shape=(A.shape[0], 1))
    tol = np.asarray(tol, dtype=dtype)

    def step(x):
        y = sparse.structured_dot(a, x)
        x_new = y / (pt.max(pt.abs(y)) + np.asarray(1e-9, dtype=dtype))
        converged = pt.lt(pt.max(pt.abs(x_new - x)), tol)
        if stop:
            return x_new, until(converged)
        return x_new, converged

    traces, _ = ptt.scan(step, outputs_info=[x0] + ([] if stop else [None]), n_steps=n_steps,
                         name="power")
    traces = [traces] if stop else list(traces)
    return x0, w, traces, ptt.grad(pt.sum(traces[0][-1] * w), x0)


def make_power_functions(A, tol, n_steps=N_STEPS, stop=True, mode=None, *, device="cuda"):
    """``(f, g)``: ``f(x0) -> traces``, ``power_graphs``' (the iterates'
    length is the exit step), and ``g(x0, w) -> [xs[-1], d sum(xs[-1] *
    w) / d x0]``, linked in ``mode``.  Both run eagerly: the step loop
    reads its condition on the host after each step.  Without ``stop``,
    the for-scan of ``n_steps``."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.sparse as sparse
    import pytensor_tpu_torch.tensor as pt

    x0, w, traces, g = power_graphs(ptt, pt, sparse, A, tol, n_steps, stop)
    f = ptt.function([x0], traces, name="power_until", mode=mode, device=device)
    fg = ptt.function([x0, w], [traces[0][-1], g], name="power_until_grad", mode=mode,
                      device=device)
    return f, fg


def power_reference(A, x0, n_steps=N_STEPS):
    """The float64 scipy loop's ``max|x_new - x|`` after each of ``n_steps``
    steps, with no stop: a tolerance between two of them fires at the
    later one."""
    A = A.astype("float64")
    x = x0.astype("float64")
    diffs = []
    for _ in range(n_steps):
        y = A @ x
        x_new = y / (np.max(np.abs(y)) + 1e-9)
        diffs.append(float(np.max(np.abs(x_new - x))))
        x = x_new
    return np.asarray(diffs)


def choose_tol(diffs, step):
    """A tolerance that fires at ``step`` (1-based) of the float64 loop:
    the geometric mean of the differences after steps ``step - 1`` and
    ``step``, so that either side has the same margin; returns it and the
    margin (the ratio of the two differences' square root)."""
    a, b = diffs[step - 2], diffs[step - 1]
    if not (diffs[: step - 1] > np.sqrt(a * b)).all():
        raise ValueError("the differences do not fall below the tolerance first at this step")
    return float(np.sqrt(a * b)), float(np.sqrt(a / b))
