"""Two sparse learning paths built from the public sparse API.

(a) Learned edge weights: the pattern of ``benchsuite.py:160
ours_sparse`` (65,536², ten stored entries a row, float32) with its
stored values an input vector ``w``: ``W = CSM("csr")(w, indices, indptr,
shape)``, ``loss = sum(sqr(structured_dot(W, X) - T))`` and its gradient
in ``w``.  The gradient runs ``CSM.L_op`` (``CSMProperties`` into
``CSMGrad``); ``local_csm_grad_same_pattern`` does not fire in either
package (the cotangent's pattern is ``StructuredDotGrad``'s, computed on
the device, x's a constant), so ``CSMGrad`` looks the cotangent up at the
pattern, and nothing reads the device back.

(b) A tf-idf softmax-regression SGD step: a sparse ``X`` shaped like
scikit-learn's ``fetch_20newsgroups_vectorized`` training split (11,314
documents x 130,107 terms, float32, 20 classes; row lengths and terms
drawn from a seed, ~158 stored entries a row; nothing is downloaded),
``Xn = row_scale(X, 1 / sp_sum(X, axis=1))``, ``logits = dot(Xn, W) +
b``, mean cross-entropy against one-hot targets plus ``1e-4 *
sum(sqr(W))``, and one SGD update of the shared ``W`` and ``b``.  It runs
``SpSum``, ``_MajorIds``, ``CSMProperties``/``CSM``, a ``StructuredDot``
with a 2-d operand and ``Transpose`` in the gradient.

The ``*_graphs`` functions take a package's namespaces (``ptt``, its
``tensor`` and ``sparse`` modules), so a test builds the same graphs in
the JAX package; the ``*_reference`` functions are float64 NumPy.
"""

from __future__ import annotations

import numpy as np

EDGE_N, EDGE_NNZ_ROW, EDGE_WIDTH = 65536, 10, 16
DOCS, TERMS, CLASSES, TERMS_A_DOC = 11314, 130107, 20, 158
TFIDF_LR, TFIDF_L2 = 0.5, 1e-4


def edge_pattern(n=EDGE_N, nnz_per_row=EDGE_NNZ_ROW, width=EDGE_WIDTH, seed=0):
    """``benchsuite.py:160``'s float32 scipy CSR of ``n``² at
    ``nnz_per_row`` stored entries a row (canonical), and from the same
    generator ``w`` (its stored values), ``X`` and ``T`` (``n`` x
    ``width``)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=nnz_per_row / n, format="csr", random_state=rng,
                  dtype="float32")
    A.sum_duplicates()
    A.sort_indices()
    X = rng.standard_normal((n, width)).astype("float32")
    T = rng.standard_normal((n, width)).astype("float32")
    return A, A.data.copy(), X, T


def edge_weight_graphs(ptt, pt, sparse, A, width=EDGE_WIDTH):
    """``([w, X, T], [loss, dloss/dw])`` of a package's namespaces, on the
    pattern of scipy CSR ``A``."""
    dtype = A.dtype.name
    n_rows, n_cols = A.shape
    w = pt.tensor("w", dtype=dtype, shape=(A.nnz,))
    X = pt.tensor("X", dtype=dtype, shape=(n_cols, width))
    T = pt.tensor("T", dtype=dtype, shape=(n_rows, width))
    W = sparse.CSM("csr")(w, np.asarray(A.indices, "int32"), np.asarray(A.indptr, "int32"),
                          np.asarray(A.shape, "int64"))
    loss = pt.sum(pt.sqr(sparse.structured_dot(W, X) - T))
    return [w, X, T], [loss, ptt.grad(loss, w)]


def make_edge_weights(A, width=EDGE_WIDTH, device="cuda"):
    """The port's function ``(w, X, T) -> (loss, dloss/dw)`` on
    ``device``."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch import sparse

    ins, outs = edge_weight_graphs(ptt, pt, sparse, A, width)
    return ptt.function(ins, outs, device=device)


def edge_weights_reference(A, w, X, T):
    """``(loss, dloss/dw)`` in float64 scipy: ``R = W X - T``, the loss
    ``sum(R**2)`` and ``2 R[row] . X[col]`` at each stored entry."""
    import scipy.sparse as sp

    W = sp.csr_matrix((w.astype("float64"), A.indices, A.indptr), shape=A.shape)
    X64 = X.astype("float64")
    R = W @ X64 - T.astype("float64")
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    return float((R ** 2).sum()), 2.0 * np.einsum("ij,ij->i", R[rows], X64[A.indices])


def tfidf_matrix(n_docs=DOCS, n_terms=TERMS, per_doc=TERMS_A_DOC, n_classes=CLASSES, seed=0):
    """A float32 scipy CSR shaped like ``fetch_20newsgroups_vectorized``'s
    training split (canonical: no duplicates, columns sorted), with
    one-hot float32 targets.  Row lengths are Poisson(``per_doc``), at
    least 1, of distinct terms drawn by a Zipf law over a shuffled
    vocabulary; values are positive (counts times idf-like weights); a
    document's class is decided by its terms through a seeded linear
    teacher."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    lengths = np.maximum(rng.poisson(per_doc, n_docs), 1)
    p = 1.0 / np.arange(1, n_terms + 1) ** 1.05
    vocab = rng.permutation(n_terms)
    # draw more terms than a row holds, and keep its first distinct ones
    draws = np.ceil(1.8 * lengths).astype(np.int64)
    rows = np.repeat(np.arange(n_docs), draws)
    cols = vocab[rng.choice(n_terms, size=int(draws.sum()), p=p / p.sum())]
    first = np.sort(np.unique(rows * n_terms + cols, return_index=True)[1])
    rows, cols = rows[first], cols[first]
    rank = np.arange(rows.size) - np.searchsorted(rows, np.arange(n_docs))[rows]
    keep = rank < lengths[rows]
    rows, cols = rows[keep], cols[keep]
    vals = (rng.integers(1, 4, rows.size) * (1.0 + rng.random(rows.size))).astype("float32")
    X = sp.csr_matrix((vals, (rows, cols)), shape=(n_docs, n_terms), dtype="float32")
    X.sort_indices()
    # a document's class follows from its terms, as a newsgroup's does: the
    # largest score of its row-normalised terms against a seeded teacher
    # whose cubed normal weights make a few terms a class's topic words,
    # each class's scores standardised over the documents so the classes
    # are near balanced.  (Labels drawn apart from the terms leave W's
    # gradient near the rounding of its cancelling sums.)
    teacher = rng.standard_normal((n_terms, n_classes)) ** 3
    scores = X.multiply(1.0 / np.asarray(X.sum(axis=1), "float64")).tocsr() @ teacher
    scores = (scores - scores.mean(axis=0)) / scores.std(axis=0)
    Y = np.eye(n_classes, dtype="float32")[np.argmax(scores, axis=1)]
    return X, Y


def tfidf_graphs(ptt, pt, sparse, W, b, n_classes=CLASSES, lr=TFIDF_LR, l2=TFIDF_L2):
    """``([X, Y], loss, updates)`` of a package's namespaces for the shared
    ``W`` (terms x classes) and ``b``: the step's inputs, its loss before
    the update and the SGD updates of ``W`` and ``b``."""
    X = sparse.csr_matrix("X", dtype="float32")
    Y = pt.tensor("Y", dtype="float32", shape=(None, n_classes))
    Xn = sparse.row_scale(X, 1 / sparse.sp_sum(X, axis=1))
    logits = sparse.dot(Xn, W) + b
    xent = -pt.mean(pt.sum(Y * pt.special.log_softmax(logits, axis=1), axis=1))
    loss = xent + np.float32(l2) * pt.sum(pt.sqr(W))
    gW, gb = ptt.grad(loss, [W, b])
    lr = np.float32(lr)
    return [X, Y], loss, {W: W - lr * gW, b: b - lr * gb}


def make_tfidf_step(n_terms=TERMS, n_classes=CLASSES, lr=TFIDF_LR, l2=TFIDF_L2,
                    device="cuda"):
    """The port's SGD step ``f(X, Y) -> loss`` on ``device`` with its shared
    ``W`` and ``b`` (zeros, float32); returns ``(f, W, b)``."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch import sparse

    W = ptt.shared(np.zeros((n_terms, n_classes), "float32"), name="W", device=device)
    b = ptt.shared(np.zeros(n_classes, "float32"), name="b", device=device)
    ins, loss, updates = tfidf_graphs(ptt, pt, sparse, W, b, n_classes, lr, l2)
    return ptt.function(ins, loss, updates=updates, device=device), W, b


def tfidf_reference(X, Y, W, b, lr=TFIDF_LR, l2=TFIDF_L2, data_grad=True):
    """``(loss, W_new, b_new)`` of one step in float64 NumPy; without
    ``data_grad`` the data term of ``W``'s gradient is zeroed (a control
    that a hold of ``W`` must refuse)."""
    X64 = X.astype("float64")
    Xn = X64.multiply(1.0 / np.asarray(X64.sum(axis=1))).tocsr()
    W64, b64, Y64 = W.astype("float64"), b.astype("float64"), Y.astype("float64")
    logits = Xn @ W64 + b64
    logits -= logits.max(axis=1, keepdims=True)
    logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    n = X.shape[0]
    loss = -(Y64 * logp).sum() / n + l2 * (W64 ** 2).sum()
    d = (np.exp(logp) - Y64) / n
    gW = (Xn.T @ d if data_grad else 0.0) + 2 * l2 * W64
    gb = d.sum(axis=0)
    return float(loss), W64 - lr * gW, b64 - lr * gb
