"""K1: a Triton kernel generated from the inner graph of a FusedElemwise.

Replaces ``pytensor_tpu/tensor/fused.py:33 pallas_elemwise_call``, which
broadcast and flattened every input, padded it to (rows, 128) lane tiles
and ran the inner jnp expression on VMEM blocks of 256 rows.

On Hopper the pass is bound by bytes, not operations: a fused node reads
each input once and writes each output once.  So the kernel broadcasts by
strides instead of materialising ``broadcast_to`` copies (a broadcast dim
has stride 0, a 0-d input has all strides 0), writes contiguous outputs,
masks the ragged edge, and keeps every intermediate in registers.  One
program handles ``BLOCK`` elements of the flattened iteration space and
unravels its offsets into per-dim indices.

The body is emitted at link time, one ``tl`` expression per scalar op in
topological order.  Scalar constants of the inner graph become
``tl.full`` literals of their exact dtype: a Python float literal in a
Triton kernel is float32, and a float64 graph must not round its
constants through float32.  Array constants of the inner graph (the radon
observations) become extra inputs, moved to the device once.  ``exp``,
``log``, ``sqrt``, ``pow`` and float division go through libdevice's
correctly rounded or few-ulp functions rather than Triton's fast
approximations, so the kernel agrees with torch's own to a few ulp.

``@triton.jit`` reads its function's source with ``inspect``, so the
generated source is written to a module under ``build/triton/`` (listed
in ``.gitignore``) and imported from there, keyed by a hash of the
source: the source is a function of the inner graph's ops and constants,
the dtypes and the ndim, which is the structural key.  Triton's own cache
of compiled binaries goes to ``build/triton_cache/`` unless
``TRITON_CACHE_DIR`` names another.  Triton is imported only when a kernel
is built: the CPU tests import this module without it.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
from pathlib import Path

import numpy as np
import torch

from pytensor_tpu_torch.graph.basic import Constant

BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
BLOCK = 1024
NUM_WARPS = 4

# launches of the kernel since the count was last set to 0
LAUNCHES = 0

_TL_DTYPES = {
    "float32": "tl.float32",
    "float64": "tl.float64",
    "int8": "tl.int8",
    "int16": "tl.int16",
    "int32": "tl.int32",
    "int64": "tl.int64",
}

# scalar op name -> Triton expression over the (already cast) operands
_EMIT = {
    "add": lambda a: "(" + " + ".join(a) + ")",
    "mul": lambda a: "(" + " * ".join(a) + ")",
    "sub": lambda a: f"({a[0]} - {a[1]})",
    "neg": lambda a: f"(-{a[0]})",
    "abs": lambda a: f"tl.abs({a[0]})",
    "sqr": lambda a: f"({a[0]} * {a[0]})",
    "true_div": lambda a: f"libdevice.div_rn({a[0]}, {a[1]})",
    "reciprocal": lambda a: f"libdevice.div_rn(tl.full([BLOCK], 1, {a[0]}.dtype), {a[0]})",
    "exp": lambda a: f"libdevice.exp({a[0]})",
    "log": lambda a: f"libdevice.log({a[0]})",
    "sqrt": lambda a: f"libdevice.sqrt_rn({a[0]})",
    "pow": lambda a: f"libdevice.pow({a[0]}, {a[1]})",
    "sin": lambda a: f"libdevice.sin({a[0]})",
    "cos": lambda a: f"libdevice.cos({a[0]})",
    "tanh": lambda a: f"libdevice.tanh({a[0]})",
    "sigmoid": lambda a: (f"libdevice.div_rn(tl.full([BLOCK], 1, {a[0]}.dtype), "
                          f"1 + libdevice.exp(-{a[0]}))"),
    # NaN in either operand gives NaN, as numpy's and torch's maximum do
    "maximum": lambda a: f"tl.where(({a[0]} > {a[1]}) | ({a[0]} != {a[0]}), {a[0]}, {a[1]})",
}
# ops whose libdevice form exists only for floats
_FLOAT_ONLY = frozenset({"true_div", "reciprocal", "exp", "log", "sqrt", "pow",
                         "sin", "cos", "tanh", "sigmoid"})


def emittable(node) -> bool:
    """True when K1 can emit this Elemwise node's scalar op at its dtypes."""
    name = node.op.scalar_op.name
    if name not in _EMIT:
        return False
    dtypes = [v.type.dtype for v in node.inputs + node.outputs]
    if any(d not in _TL_DTYPES for d in dtypes):
        return False
    return name not in _FLOAT_ONLY or node.outputs[0].type.dtype.startswith("float")


def _literal(value, dtype: str) -> str | None:
    """``tl.full`` of an exact scalar, or None when it has no literal form."""
    v = np.asarray(value).astype(dtype).item()
    if isinstance(v, float) and not np.isfinite(v):
        return None
    return f"tl.full([BLOCK], {v!r}, {_TL_DTYPES[dtype]})"


class FusedElemwiseKernel:
    """K1 for one FusedElemwise node on one device.

    ``__call__`` takes the node's input tensors.  On CPU tensors it runs
    the plain version; on CUDA tensors it launches the kernel, or raises.
    """

    def __init__(self, fgraph, device):
        self.fgraph = fgraph
        self.order = fgraph.toposort()
        self.inputs = list(fgraph.inputs)
        self.outputs = list(fgraph.outputs)
        from pytensor_tpu_torch.link.torch.convert import as_torch, resolve_device

        self.device = resolve_device(device)
        for node in self.order:
            if not emittable(node):
                raise TypeError(f"K1 cannot emit {node}")
        # scalar constants are literals; every other constant is an input
        literals = {}
        array_consts = []
        for node in self.order:
            for i in node.inputs:
                if not isinstance(i, Constant) or i in literals or i in array_consts:
                    continue
                lit = (_literal(i.data, node.outputs[0].type.dtype)
                       if np.ndim(i.data) == 0 else None)
                if lit is None:
                    array_consts.append(i)
                else:
                    literals[i] = lit
        self.array_consts = array_consts
        self.tensor_vars = self.inputs + array_consts
        self.const_tensors = [as_torch(c.data, self.device) for c in array_consts]
        self._plain_consts: dict = {}
        self.ndim = max([1] + [v.type.ndim for v in self.tensor_vars + self.outputs])
        self.source = self._emit(literals)
        self.key = hashlib.sha256(self.source.encode()).hexdigest()[:16]
        self._layouts: dict = {}

    # --- code generation -------------------------------------------------
    def _emit(self, literals) -> str:
        nd, nin, nout = self.ndim, len(self.tensor_vars), len(self.outputs)
        params = ([f"x{k}" for k in range(nin)] + [f"y{j}" for j in range(nout)]
                  + ["N"] + [f"d{d}" for d in range(nd)]
                  + [f"xs{k}_{d}" for k in range(nin) for d in range(nd)]
                  + [f"ys{j}_{d}" for j in range(nout) for d in range(nd)]
                  + ["BLOCK: tl.constexpr"])
        body = [
            "    pid = tl.program_id(0)",
            "    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)",
            "    mask = offs < N",
            "    rem = offs",
        ]
        for d in range(nd - 1, 0, -1):
            body.append(f"    i{d} = rem % d{d}")
            body.append(f"    rem = rem // d{d}")
        body.append("    i0 = rem")
        names = {}
        for k, v in enumerate(self.tensor_vars):
            off = " + ".join(f"i{d} * xs{k}_{d}" for d in range(nd))
            body.append(f"    a{k} = tl.load(x{k} + ({off}), mask=mask)")
            names[v] = (f"a{k}", v.type.dtype)
        for n, node in enumerate(self.order):
            out_dt = node.outputs[0].type.dtype
            args = []
            for i in node.inputs:
                if i in literals:
                    args.append(_literal(i.data, out_dt))
                    continue
                expr, dt = names[i]
                args.append(expr if dt == out_dt else f"{expr}.to({_TL_DTYPES[out_dt]})")
            body.append(f"    v{n} = {_EMIT[node.op.scalar_op.name](args)}")
            names[node.outputs[0]] = (f"v{n}", out_dt)
        for j, o in enumerate(self.outputs):
            off = " + ".join(f"i{d} * ys{j}_{d}" for d in range(nd))
            expr, dt = names[o]
            body.append(f"    tl.store(y{j} + ({off}), {expr}.to({_TL_DTYPES[o.type.dtype]}), mask=mask)")
        header = [
            "import triton",
            "import triton.language as tl",
            "",
            "try:",
            "    from triton.language.extra import libdevice",
            "except ImportError:",
            "    from triton.language.extra.cuda import libdevice",
            "",
            "",
            "@triton.jit",
            f"def fused_elemwise({', '.join(params)}):",
        ]
        return "\n".join(header + body) + "\n"

    # --- runtime layout ----------------------------------------------------
    def _layout(self, args):
        """Iteration shape, output shapes and strides for these inputs."""
        key = tuple((tuple(a.shape), tuple(a.stride())) for a in args)
        hit = self._layouts.get(key)
        if hit is not None:
            return hit
        nd = self.ndim
        shapes = {v: tuple(a.shape) for v, a in zip(self.tensor_vars, args)}
        for node in self.order:
            shapes[node.outputs[0]] = tuple(torch.broadcast_shapes(
                *[shapes.get(i, ()) for i in node.inputs]))
        it = tuple(torch.broadcast_shapes(*shapes.values()))
        it = (1,) * (nd - len(it)) + it

        def strides(shape, stride):
            pad = nd - len(shape)
            st = [0] * pad + [0 if s == 1 else t for s, t in zip(shape, stride)]
            return [0 if it[d] == 1 else st[d] for d in range(nd)]

        xstrides = [strides(tuple(a.shape), a.stride()) for a in args]
        out_shapes = [shapes[o] for o in self.outputs]
        ystrides = [strides(s, torch.empty(s, device="meta").stride()) for s in out_shapes]
        hit = (it, out_shapes, xstrides, ystrides)
        self._layouts[key] = hit
        return hit

    def _args(self, inputs):
        if len(inputs) != len(self.inputs):
            raise TypeError(f"FusedElemwise expected {len(self.inputs)} inputs, got {len(inputs)}")
        return list(inputs) + self.const_tensors

    # --- the two versions ----------------------------------------------------
    def __call__(self, *inputs):
        if all(t.device.type == "cpu" for t in inputs):
            return self.plain(*inputs)
        return self.launch(*inputs)

    def launch(self, *inputs):
        """Run the Triton kernel on CUDA tensors."""
        global LAUNCHES
        from pytensor_tpu_torch.link.torch.convert import torch_dtype

        args = self._args(inputs)
        for v, a in zip(self.tensor_vars, args):
            if a.device != self.device or self.device.type != "cuda":
                raise RuntimeError(
                    f"K1 runs on {self.device} CUDA tensors; got a tensor on {a.device}")
            if a.dtype != torch_dtype(v.type.dtype):
                raise TypeError(f"K1 input dtype {a.dtype} != {v.type.dtype}")
        it, out_shapes, xstrides, ystrides = self._layout(args)
        outs = [torch.empty(s, dtype=torch_dtype(o.type.dtype), device=self.device)
                for s, o in zip(out_shapes, self.outputs)]
        n = int(np.prod(it))
        if n:
            kernel = _load_kernel(self.key, self.source)
            grid = ((n + BLOCK - 1) // BLOCK,)
            kernel[grid](*args, *outs, n, *it,
                         *[s for st in xstrides for s in st],
                         *[s for st in ystrides for s in st],
                         BLOCK=BLOCK, num_warps=NUM_WARPS)
            LAUNCHES += 1
        return outs

    def plain(self, *inputs):
        """The same inner graph evaluated with torch ops, on any device."""
        from pytensor_tpu_torch.link.torch.dispatch import elemwise_fn
        from pytensor_tpu_torch.link.torch.convert import as_torch

        args = self._args(inputs)
        dev = args[0].device if args else self.device
        consts = self._plain_consts.get(dev)
        if consts is None:
            consts = self._plain_consts[dev] = {
                i: as_torch(i.data, dev)
                for node in self.order for i in node.inputs
                if isinstance(i, Constant)}
        storage = {**consts, **dict(zip(self.tensor_vars, (a.to(dev) for a in args)))}
        for node in self.order:
            storage[node.outputs[0]] = elemwise_fn(node)(*[storage[i] for i in node.inputs])
        return [storage[o].contiguous() for o in self.outputs]


_KERNELS: dict = {}


def _use_build_cache():
    """Point Triton's cache of compiled binaries, which defaults to
    ``$HOME/.triton``, at the checkout's build directory, through Triton's
    own ``knobs``; a cache directory the user chose is left alone."""
    from triton import knobs

    if not os.environ.get("TRITON_CACHE_DIR"):
        knobs.cache.dir = str(BUILD_DIR / "triton_cache")


def _load_kernel(key: str, source: str):
    """Import (building on first use) the generated module for ``source``."""
    kernel = _KERNELS.get(key)
    if kernel is not None:
        return kernel
    _use_build_cache()
    out_dir = BUILD_DIR / "triton"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"fused_{key}.py"
    if not path.exists() or path.read_text() != source:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(source)
        os.replace(tmp, path)
    spec = importlib.util.spec_from_file_location(f"pytensor_tpu_torch_fused_{key}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    kernel = _KERNELS[key] = module.fused_elemwise
    return kernel
