"""einsum: the ``Einsum`` op, its pullback and ``einsum()``.

Counterpart of ``pytensor_tpu/tensor/einsum.py`` (PyTensor's
tensor/einsum.py Einsum:38).  The op, its gradient graph and ``einsum()``
(repeated labels of an operand taken as diagonals, ``...`` made explicit)
are the JAX package's, so graphs match op for op.  Only the lowering
differs: the JAX package hands the contraction order to XLA
(``jnp.einsum``); the port plans it itself (``contraction_path``: numpy's
optimal path on the static shapes, computed on the host once per input
signature) and runs it as pairwise contractions
(``link/torch/dispatch.py``), never ``torch.einsum`` of more than two
operands, which contracts left to right.  The numpy oracle is
``np.einsum``.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.scalar.basic import upcast
from pytensor_tpu_torch.tensor.basic import as_tensor_variable
from pytensor_tpu_torch.tensor.type import TensorType


class Einsum(Op):
    __props__ = ("subscripts",)

    def __init__(self, subscripts: str):
        self.subscripts = subscripts

    def _parse(self, ndims):
        subs = self.subscripts.replace(" ", "")
        if "->" in subs:
            in_spec, out_spec = subs.split("->")
        else:
            in_spec = subs
            # implicit output: alphabetically sorted non-repeated indices
            counts = {}
            for term in in_spec.split(","):
                for ch in term.replace("...", ""):
                    counts[ch] = counts.get(ch, 0) + 1
            out_spec = "".join(sorted(c for c, n in counts.items() if n == 1))
        return in_spec.split(","), out_spec

    def make_node(self, *operands):
        operands = [as_tensor_variable(o) for o in operands]
        in_specs, out_spec = self._parse([o.type.ndim for o in operands])
        if len(in_specs) != len(operands):
            raise ValueError("einsum: operand count mismatch")
        # static shape inference by index bookkeeping
        sizes: dict[str, int | None] = {}
        for spec, op_v in zip(in_specs, operands):
            if "..." in spec:
                named = spec.replace("...", "")
                offset = op_v.type.ndim - len(named)
                dims = op_v.type.shape[offset:]
            else:
                dims = op_v.type.shape
                if len(spec) != op_v.type.ndim:
                    raise ValueError(
                        f"einsum: spec {spec} does not match ndim {op_v.type.ndim}"
                    )
            for ch, d in zip(spec.replace("...", ""), dims):
                if ch in sizes and sizes[ch] is not None and d is not None \
                        and sizes[ch] != d and sizes[ch] != 1 and d != 1:
                    raise ValueError(f"einsum: inconsistent size for index {ch}")
                if ch not in sizes or sizes[ch] is None:
                    sizes[ch] = d
        if "..." in out_spec:
            raise NotImplementedError("einsum ellipsis output: pass explicit spec")
        out_shape = tuple(sizes.get(ch) for ch in out_spec)
        dtype = upcast(*(o.type.dtype for o in operands))
        return Apply(self, list(operands), [TensorType(dtype, out_shape)()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.asarray(
            np.einsum(self.subscripts, *inputs),
            dtype=node.outputs[0].type.numpy_dtype,
        )

    def infer_shape(self, fgraph, node, input_shapes):
        from pytensor_tpu_torch.tensor.basic import constant

        in_specs, out_spec = self._parse(None)
        dims = {}
        for spec, shp in zip(in_specs, input_shapes):
            for ch, d in zip(spec.replace("...", ""), shp):
                dims.setdefault(ch, d)
        return [tuple(dims[ch] for ch in out_spec)]

    def L_op(self, inputs, outputs, output_grads):
        (gz,) = output_grads
        in_specs, out_spec = self._parse(None)
        grads = []
        for k, inp in enumerate(inputs):
            # grad wrt operand k: einsum with k's spec as output, using gz
            # in place of operand k; repeated/summed indices need care:
            # indices of k missing from (others + out) are summed in the
            # forward -> the grad broadcasts along them
            other_specs = [s for j, s in enumerate(in_specs) if j != k]
            other_ops = [o for j, o in enumerate(inputs) if j != k]
            target = in_specs[k]
            known = set(out_spec) | set("".join(other_specs))
            missing = [ch for ch in target if ch not in known]
            # labels summed only in this operand: the grad is constant
            # along them — compute over the known labels and broadcast
            target_known = "".join(ch for ch in target if ch not in missing)
            sub = ",".join([out_spec] + other_specs) + "->" + target_known
            g = Einsum(sub)(gz, *other_ops)
            if missing:
                from pytensor_tpu_torch.tensor.elemwise import DimShuffle
                from pytensor_tpu_torch.tensor.math import second

                order = [target_known.index(ch) if ch in target_known
                         else "x" for ch in target]
                g = DimShuffle(g.type.ndim, order)(g)
                g = second(inp, g)
            from pytensor_tpu_torch.tensor.basic import cast

            if g.type.dtype != inp.type.dtype:
                g = cast(g, inp.type.dtype)
            grads.append(g)
        return grads


def _expand_ellipsis(subscripts, operands):
    """Rewrite '...' into explicit right-aligned index letters, with numpy
    ellipsis-broadcast semantics: a statically-size-1 batch dim facing a
    larger one elsewhere is squeezed away and its letter dropped from that
    operand (einsum broadcasts along letters an operand doesn't carry).
    Returns ``(new_subscripts, new_operands)``."""
    import string

    if "->" in subscripts:
        ins, out = subscripts.split("->")
    else:
        ins, out = subscripts, None
    in_specs = ins.split(",")
    used = set(subscripts) - {".", ",", "-", ">"}
    fresh = [c for c in string.ascii_letters if c not in used]
    ell_ndims = []
    for spec, opd in zip(in_specs, operands):
        if "..." in spec:
            named = len(spec.replace("...", ""))
            ell_ndims.append(opd.type.ndim - named)
        else:
            ell_ndims.append(0)
    max_ell = max(ell_ndims)
    letters = "".join(fresh[:max_ell])
    new_specs = []
    for spec, k in zip(in_specs, ell_ndims):
        if "..." in spec:
            # right-aligned: an operand with fewer ellipsis dims matches
            # the trailing batch letters (numpy broadcast alignment)
            new_specs.append(spec.replace("...", letters[max_ell - k:]))
        else:
            new_specs.append(spec)
    if out is None:
        counts = {}
        for c in ",".join(new_specs).replace(",", ""):
            counts[c] = counts.get(c, 0) + 1
        named_out = "".join(sorted(c for c, n in counts.items()
                                   if n == 1 and c not in letters))
        out = letters + named_out
    else:
        out = out.replace("...", letters)
    # numpy broadcasting inside '...': where one operand's batch dim is
    # statically 1 and another operand's (or an unknown) is not, squeeze
    # the 1-dim and drop the letter from that operand's spec
    ell = set(letters)
    sizes = {}
    for spec, opd in zip(new_specs, operands):
        for pos, ch in enumerate(spec):
            if ch in ell:
                sizes.setdefault(ch, []).append(opd.type.shape[pos])
    bcast = {ch for ch, ss in sizes.items()
             if 1 in ss and any(s is None or s != 1 for s in ss)}
    operands = list(operands)
    if bcast:
        squeezed = []
        for k, (spec, opd) in enumerate(zip(new_specs, operands)):
            drop = {pos for pos, ch in enumerate(spec)
                    if ch in bcast and opd.type.shape[pos] == 1}
            if drop:
                keep = [p for p in range(len(spec)) if p not in drop]
                operands[k] = opd.dimshuffle(*keep)
                spec = "".join(ch for p, ch in enumerate(spec)
                               if p not in drop)
            squeezed.append(spec)
        new_specs = squeezed
    return ",".join(new_specs) + "->" + out, tuple(operands)


def einsum(subscripts, *operands, optimize=None):
    from pytensor_tpu_torch.tensor.basic import as_tensor_variable, diagonal

    # normalize: make the output explicit (numpy implicit rule) and
    # extract in-operand repeated labels as diagonals so the Einsum op
    # only ever sees unique labels per operand (its pullback then covers
    # every case, including 'ii->' trace gradients)
    subscripts = subscripts.replace(" ", "")
    operands = tuple(as_tensor_variable(o) for o in operands)
    if "..." in subscripts:
        subscripts, operands = _expand_ellipsis(subscripts, operands)
    if "->" in subscripts:
        ins, out = subscripts.split("->")
    else:
        ins = subscripts
        counts = {}
        for c in ins.replace(",", ""):
            counts[c] = counts.get(c, 0) + 1
        out = "".join(sorted(c for c, n in counts.items() if n == 1))
    in_specs = ins.split(",")
    new_ops = []
    new_specs = []
    for spec, opd in zip(in_specs, operands):
        opd = as_tensor_variable(opd)
        while len(set(spec)) != len(spec):
            rep_i = rep_j = None
            for i, c in enumerate(spec):
                j = spec.find(c, i + 1)
                if j != -1:
                    rep_i, rep_j, rep_c = i, j, c
                    break
            opd = diagonal(opd, axis1=rep_i, axis2=rep_j)
            spec = "".join(ch for k, ch in enumerate(spec)
                           if k not in (rep_i, rep_j)) + rep_c
        new_ops.append(opd)
        new_specs.append(spec)
    return Einsum(",".join(new_specs) + "->" + out)(*new_ops)


def contraction_path(subscripts, shapes):
    """The contraction order of ``np.einsum_path(..., optimize="optimal")``
    for operands of ``shapes`` (no operand is read: each is a broadcast
    0-d dummy, as the order depends on the shapes alone).  Returns ``(steps, flops)``: each step is ``(positions,
    spec)``, the positions in the list of remaining operands that it
    contracts (its result goes to the end of the list, numpy's
    convention) and the two-operand (or one-operand) einsum spec of that
    contraction; ``flops`` is numpy's count of the whole path."""
    dummies = [np.broadcast_to(np.empty(()), tuple(s)) for s in shapes]
    path, _ = np.einsum_path(subscripts, *dummies, optimize="optimal")
    ins, out = subscripts.split("->")
    specs = ins.split(",")
    sizes = {}
    for spec, shp in zip(specs, shapes):
        for ch, d in zip(spec, shp):
            sizes[ch] = max(sizes.get(ch, 1), int(d))
    steps, flops = [], 0
    for pos in path[1:]:
        pos = tuple(sorted(pos, reverse=True))
        taken = [specs.pop(p) for p in pos]
        rest = set(out).union(*specs)
        involved = set().union(*taken)
        # the labels another operand or the output still needs, in the
        # order numpy's path keeps them; the last step gives the output
        result = out if not specs else "".join(
            sorted(ch for ch in involved if ch in rest))
        size = int(np.prod([sizes[ch] for ch in involved])) if involved else 1
        factor = max(1, len(taken) - 1) + (1 if involved - set(result) else 0)
        flops += size * factor
        steps.append((pos, ",".join(taken) + "->" + result))
        specs.append(result)
    return steps, flops
