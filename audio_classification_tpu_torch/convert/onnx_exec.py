"""Generic ONNX graph executor over torch (port of
audio_classification_tpu/models/convert/onnx_exec.py, an onnxruntime
replacement).

The reference executes its entire model zoo as ONNX graphs under the
onnxruntime C++ EPs (reference: requirements.txt:6-7, src/model.py:10,64;
the zoo is SURVEY.md §2.2: ERes2Net speaker ONNX, SenseVoice int8, silero
VAD, optional Paraformer / transducer / whisper ONNX). The graph-aware
importers in ``onnx_graph_map`` handle graphs whose topology matches the
port's own modules; this module runs any parsed ``OnnxGraph``
(convert/onnx_import) directly as torch operations on the device, so a
user can point the port at their actual .onnx files: exact topology, exact
weights.

Execution model
---------------
* Nodes run in file order (ONNX requires topological order). The
  environment maps value names to either **numpy arrays (constants)** or
  **torch tensors on the device**.
* **Partial evaluation**: a node whose inputs are all constants and whose
  op has a numpy path is folded on the host. ``Shape`` always returns a
  numpy constant, so the shape-arithmetic chains ONNX exporters emit
  (Shape -> Gather -> Unsqueeze -> Concat -> Reshape) resolve to static
  reshapes, and an input that must be constant (a Reshape's shape, a
  Slice's bounds) raises ``UnsupportedOnnxOp`` when it is not, as in JAX.
* Initializers are split into **params** (floating-point and int8 / uint8
  weight tensors, moved to the device once at load; ``params=`` swaps them)
  and **baked constants** (int64 shape vectors, indices, scalars, which
  stay numpy so they can drive static shapes).
* Control flow: ``If`` with a constant condition inlines the taken branch;
  with a device condition the condition is read and the taken branch runs
  (JAX lowers it to ``lax.cond``). ``Loop`` takes a constant trip count
  and is unrolled; LSTM / GRU run a loop over time steps in the ONNX gate
  order (iofc / zrh) with JAX's op order, not ``nn.LSTM`` (cuDNN orders
  its sums otherwise and takes TF32).
* Every Conv and MatMul runs under ``ops/signal.no_tf32``: cuDNN takes
  TF32 for convolutions by default.
* Integer products (MatMulInteger, QLinearMatMul, QGemm) are exact int32:
  on the card ``torch._int_mm`` on int8 operands (rows padded to 32, K and
  N to 8) with the zero-point corrections in int32; on the CPU, and for a
  per-row a zero point, a float64 product, exact for these sums (never
  ops/quant.int_matmul's float32, rounded above 2^24).
  ConvInteger / QLinearConv accumulate in float64, exact likewise.

Dtypes, where the port differs from JAX: JAX runs with 32-bit values, so a
traced int64 becomes int32 and a traced float64 float32. The port keeps
torch's int64 for indices and integer results (Shape, ArgMax, TopK
indices, Cast to int64), and like JAX turns float64 into float32 on the
device. ``QuantizeLinear`` / ``Round`` round half to even in both, as the
ONNX spec says.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.quant import int_matmul_work
from ..ops.signal import no_tf32
from ..ops.work import counted, loop_step
from .onnx_import import OnnxGraph, OnnxNode, load_onnx_graph

_DTYPE_CODES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}

# numpy dtype -> the torch dtype a device tensor takes (float64 -> float32
# as in JAX; the unsigned types torch lacks widen to int64)
_TORCH_OF = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float32,
    np.dtype(np.float16): torch.float16, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool, np.dtype(np.uint16): torch.int64,
    np.dtype(np.uint32): torch.int64, np.dtype(np.uint64): torch.int64,
}
_NUMPY_OF = {
    torch.float32: np.dtype(np.float32), torch.float64: np.dtype(np.float64),
    torch.float16: np.dtype(np.float16), torch.bfloat16: np.dtype(np.float32),
    torch.uint8: np.dtype(np.uint8), torch.int8: np.dtype(np.int8),
    torch.int16: np.dtype(np.int16), torch.int32: np.dtype(np.int32),
    torch.int64: np.dtype(np.int64), torch.bool: np.dtype(np.bool_),
}


def _is_const(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic, int, float, bool))


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _as_list(v, default=None):
    if v is None:
        return default
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v]


def _attr_str(node: OnnxNode, key: str, default: str = "") -> str:
    v = node.attrs.get(key)
    if v is None:
        return default
    return v.decode() if isinstance(v, bytes) else str(v)


class UnsupportedOnnxOp(NotImplementedError):
    pass


def _dtype_of(x) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return _NUMPY_OF[x.dtype]
    return _np(x).dtype


def _shape_of(x) -> Tuple[int, ...]:
    return tuple(_np(x).shape) if _is_const(x) else tuple(x.shape)


def _astype(x, dt):
    """``x.astype(dt)`` for a numpy constant or a device tensor."""
    if _is_const(x):
        return _np(x).astype(dt)
    return x.to(_TORCH_OF[np.dtype(dt)])


class _TorchNP:
    """The numpy functions the handlers call, over torch tensors on one
    device. Every operand goes through ``t``: numpy constants move to the
    device (float64 as float32), python scalars stay scalars."""

    def __init__(self, device: torch.device):
        self.device = device

    def t(self, x):
        if x is None or isinstance(x, torch.Tensor):
            return x
        if isinstance(x, (bool, int, float)):
            return x
        a = _np(x)
        dt = _TORCH_OF[a.dtype]
        if a.dtype in (np.uint16, np.uint32, np.uint64):
            a = a.astype(np.int64)
        return torch.as_tensor(a, dtype=dt, device=self.device)

    def tt(self, x) -> torch.Tensor:
        """Like ``t`` but a python scalar becomes a 0-d tensor too."""
        x = self.t(x)
        return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, device=self.device)

    # elementwise
    def maximum(self, x, y):
        x, y = self.tt(x), self.tt(y)
        return torch.maximum(*self._promote(x, y))

    def minimum(self, x, y):
        x, y = self.tt(x), self.tt(y)
        return torch.minimum(*self._promote(x, y))

    @staticmethod
    def _promote(x, y):
        dt = torch.result_type(x, y)
        return x.to(dt), y.to(dt)

    def exp(self, x): return torch.exp(self.t(x))
    def log(self, x): return torch.log(self.t(x))
    def sqrt(self, x): return torch.sqrt(self.t(x))
    def tanh(self, x): return torch.tanh(self.t(x))
    def abs(self, x): return torch.abs(self.t(x))
    def floor(self, x): return torch.floor(self.t(x))
    def ceil(self, x): return torch.ceil(self.t(x))
    def round(self, x): return torch.round(self.t(x))
    def logical_not(self, x): return torch.logical_not(self.t(x))
    def sign(self, x): return torch.sign(self.t(x))
    def sin(self, x): return torch.sin(self.t(x))
    def cos(self, x): return torch.cos(self.t(x))
    def square(self, x): return torch.square(self.t(x))

    def logaddexp(self, x, y):
        x = self.t(x)
        return torch.logaddexp(x, torch.full_like(x, float(y)))

    def floor_divide(self, x, y): return torch.floor_divide(self.tt(x), self.tt(y))
    def fmod(self, x, y): return torch.fmod(self.tt(x), self.tt(y))
    def mod(self, x, y): return torch.remainder(self.tt(x), self.tt(y))
    def equal(self, x, y): return torch.eq(self.tt(x), self.tt(y))
    def greater(self, x, y): return torch.gt(self.tt(x), self.tt(y))
    def greater_equal(self, x, y): return torch.ge(self.tt(x), self.tt(y))
    def less(self, x, y): return torch.lt(self.tt(x), self.tt(y))
    def less_equal(self, x, y): return torch.le(self.tt(x), self.tt(y))
    def logical_and(self, x, y): return torch.logical_and(self.tt(x), self.tt(y))
    def logical_or(self, x, y): return torch.logical_or(self.tt(x), self.tt(y))
    def logical_xor(self, x, y): return torch.logical_xor(self.tt(x), self.tt(y))

    def where(self, c, x, y):
        c, x, y = self.tt(c), self.tt(x), self.tt(y)
        dt = torch.result_type(x, y)
        return torch.where(c.to(torch.bool), x.to(dt), y.to(dt))

    def clip(self, x, lo, hi):
        return self.minimum(self.maximum(x, lo), hi)

    # shapes
    def reshape(self, x, shape): return self.t(x).reshape(tuple(int(d) for d in shape))

    def transpose(self, x, perm=None):
        x = self.t(x)
        return x.permute(*(perm if perm is not None else reversed(range(x.ndim))))

    def swapaxes(self, x, a, b): return torch.swapaxes(self.t(x), a, b)
    def moveaxis(self, x, src, dst): return torch.movedim(self.t(x), src, dst)

    def concatenate(self, xs, axis=0):
        ts = [self.tt(x) for x in xs]
        dt = ts[0].dtype
        for x in ts[1:]:
            dt = torch.promote_types(dt, x.dtype)
        return torch.cat([x.to(dt) for x in ts], dim=axis)

    def squeeze(self, x, axis=None):
        x = self.t(x)
        return x.squeeze() if axis is None else x.squeeze(tuple(axis))

    def expand_dims(self, x, a): return self.t(x).unsqueeze(a)
    def broadcast_to(self, x, shape): return torch.broadcast_to(self.tt(x), tuple(shape))
    def tile(self, x, reps): return torch.tile(self.t(x), tuple(reps))
    def triu(self, x, k=0): return torch.triu(self.t(x), k)
    def tril(self, x, k=0): return torch.tril(self.t(x), k)
    def asarray(self, x, dtype=None):
        x = self.tt(x)
        return x if dtype is None else x.to(_TORCH_OF[np.dtype(dtype)])

    def arange(self, n): return torch.arange(int(n), device=self.device)

    def ones(self, shape, dtype=bool):
        return torch.ones(tuple(shape), dtype=_TORCH_OF[np.dtype(dtype)], device=self.device)

    def take_along_axis(self, x, idx, axis):
        x, idx = self.t(x), self.tt(idx).long()
        idx = torch.where(idx < 0, idx + x.shape[axis], idx)
        return torch.gather(x, axis, idx)

    # reductions
    @staticmethod
    def _dims(x, axis):
        if axis is None:
            return tuple(range(x.ndim))
        return tuple(a % x.ndim for a in (axis if isinstance(axis, (tuple, list)) else (axis,)))

    def sum(self, x, axis=None, keepdims=False):
        x = self.t(x)
        return torch.sum(x, dim=self._dims(x, axis), keepdim=keepdims)

    def mean(self, x, axis=None, keepdims=False):
        x = self.t(x)
        if not x.is_floating_point():
            x = x.float()
        return torch.mean(x, dim=self._dims(x, axis), keepdim=keepdims)

    def max(self, x, axis=None, keepdims=False):
        x = self.t(x)
        return torch.amax(x, dim=self._dims(x, axis), keepdim=keepdims)

    def min(self, x, axis=None, keepdims=False):
        x = self.t(x)
        return torch.amin(x, dim=self._dims(x, axis), keepdim=keepdims)

    def prod(self, x, axis=None, keepdims=False):
        x = self.t(x)
        for d in sorted(self._dims(x, axis), reverse=True):
            x = torch.prod(x, dim=d, keepdim=keepdims)
        return x

    def argmax(self, x, axis): return torch.argmax(self.t(x), dim=axis)
    def argmin(self, x, axis): return torch.argmin(self.t(x), dim=axis)

    def cumsum(self, x, axis):
        x = self.t(x)
        return torch.cumsum(x, dim=axis, dtype=x.dtype)

    def matmul(self, x, y):
        with no_tf32():
            return torch.matmul(*self._promote(self.tt(x), self.tt(y)))


_HANDLERS: Dict[str, Callable] = {}


def _op(*names: str):
    def deco(fn):
        for n in names:
            _HANDLERS[n] = fn
        return fn
    return deco


class _Ctx:
    """Per-execution state: value environment + the device's namespace."""

    def __init__(self, env: Dict[str, Any], parent: Optional["_Ctx"] = None,
                 device: Optional[torch.device] = None):
        self.env = env
        self.parent = parent
        self.device = parent.device if device is None else device
        self.tx = _TorchNP(self.device)

    def lookup(self, name: str):
        ctx: Optional[_Ctx] = self
        while ctx is not None:
            if name in ctx.env:
                return ctx.env[name]
            ctx = ctx.parent
        raise KeyError(f"onnx_exec: undefined value '{name}'")

    def inputs(self, node: OnnxNode) -> List[Any]:
        # ONNX uses "" for omitted optional inputs.
        return [self.lookup(n) if n else None for n in node.inputs]

    def xp(self, ins: Sequence[Any]):
        """numpy for all-constant inputs (fold), torch otherwise."""
        if all(x is None or _is_const(x) for x in ins):
            return np
        return self.tx

    def const(self, node: OnnxNode, value, what: str) -> np.ndarray:
        if value is None or not _is_const(value):
            raise UnsupportedOnnxOp(
                f"{node.op_type} '{node.name}': {what} must be constant "
                f"(static shapes are required under jit)"
            )
        return _np(value)


# --------------------------------------------------------------- elementwise

def _erf(xp, x):
    if xp is np:
        return np.vectorize(math.erf, otypes=[np.float32])(x)
    return torch.erf(xp.t(x))


_UNARY = {
    "Relu": lambda xp, x: xp.maximum(x, 0),
    "Sigmoid": lambda xp, x: 1.0 / (1.0 + xp.exp(-x)),
    "Tanh": lambda xp, x: xp.tanh(x),
    "Exp": lambda xp, x: xp.exp(x),
    "Log": lambda xp, x: xp.log(x),
    "Sqrt": lambda xp, x: xp.sqrt(x),
    "Neg": lambda xp, x: -x,
    "Abs": lambda xp, x: xp.abs(x),
    "Floor": lambda xp, x: xp.floor(x),
    "Ceil": lambda xp, x: xp.ceil(x),
    "Round": lambda xp, x: xp.round(x),  # half-to-even in numpy & torch
    "Reciprocal": lambda xp, x: 1.0 / x,
    "Not": lambda xp, x: xp.logical_not(x),
    "Sign": lambda xp, x: xp.sign(x),
    "Sin": lambda xp, x: xp.sin(x),
    "Cos": lambda xp, x: xp.cos(x),
    "Erf": _erf,
    "Softplus": lambda xp, x: xp.logaddexp(x, 0.0),
}


@_op(*_UNARY)
def _unary(ctx, node, ins):
    (x,) = ins
    xp = ctx.xp([x])
    if xp is not np:
        x = xp.t(x)
    return [_UNARY[node.op_type](xp, x)]


_BINARY = {
    "Add": lambda x, y: x + y,
    "Sub": lambda x, y: x - y,
    "Mul": lambda x, y: x * y,
    "Div": lambda x, y: x / y,
    "Pow": lambda x, y: x ** y,
}


@_op(*_BINARY)
def _binary(ctx, node, ins):
    x, y = ins
    xp = ctx.xp(ins)
    if node.op_type == "Div" and np.issubdtype(_dtype_of(x), np.integer) \
            and np.issubdtype(_dtype_of(y), np.integer):
        return [xp.floor_divide(x, y)]  # ONNX integer Div truncates toward 0 for
        # non-negative operands (shape arithmetic); see spec Div.
    if xp is not np:
        x, y = xp.tt(x), xp.tt(y)
    return [_BINARY[node.op_type](x, y)]


@_op("Mod")
def _mod(ctx, node, ins):
    x, y = ins
    xp = ctx.xp(ins)
    if node.attrs.get("fmod", 0):
        return [xp.fmod(x, y)]
    return [xp.mod(x, y)]


@_op("Min", "Max", "Sum", "Mean")
def _variadic(ctx, node, ins):
    xp = ctx.xp(ins)
    if xp is not np:
        ins = [xp.tt(v) for v in ins]
    out = ins[0]
    if node.op_type == "Min":
        for v in ins[1:]:
            out = xp.minimum(out, v)
    elif node.op_type == "Max":
        for v in ins[1:]:
            out = xp.maximum(out, v)
    else:
        for v in ins[1:]:
            out = out + v
        if node.op_type == "Mean":
            out = out / len(ins)
    return [out]


@_op("Equal", "Greater", "GreaterOrEqual", "Less", "LessOrEqual", "And",
     "Or", "Xor")
def _compare(ctx, node, ins):
    x, y = ins
    xp = ctx.xp(ins)
    fn = {
        "Equal": xp.equal, "Greater": xp.greater,
        "GreaterOrEqual": xp.greater_equal, "Less": xp.less,
        "LessOrEqual": xp.less_equal, "And": xp.logical_and,
        "Or": xp.logical_or, "Xor": xp.logical_xor,
    }[node.op_type]
    return [fn(x, y)]


@_op("Where")
def _where(ctx, node, ins):
    cond, x, y = ins
    return [ctx.xp(ins).where(cond, x, y)]


@_op("Clip")
def _clip(ctx, node, ins):
    x = ins[0]
    lo = ins[1] if len(ins) > 1 and ins[1] is not None else node.attrs.get("min")
    hi = ins[2] if len(ins) > 2 and ins[2] is not None else node.attrs.get("max")
    xp = ctx.xp([x, lo, hi])
    if lo is not None:
        x = xp.maximum(x, lo)
    if hi is not None:
        x = xp.minimum(x, hi)
    return [x]


@_op("LeakyRelu")
def _leaky(ctx, node, ins):
    (x,) = ins
    alpha = node.attrs.get("alpha", 0.01)
    xp = ctx.xp(ins)
    if xp is not np:
        x = xp.t(x)
    return [xp.where(x >= 0, x, alpha * x)]


@_op("PRelu")
def _prelu(ctx, node, ins):
    x, slope = ins
    xp = ctx.xp(ins)
    # ONNX: slope broadcasts unidirectionally to x (per-channel [C] against
    # NC* x aligns on the channel axis, like torch's PReLU).
    s = _np(slope) if _is_const(slope) else slope
    xnd = len(_shape_of(x))
    if s.ndim == 1 and s.shape[0] != 1 and xnd > 2:
        s = s.reshape((s.shape[0],) + (1,) * (xnd - 2))
    if xp is not np:
        x, s = xp.t(x), xp.t(s)
    return [xp.where(x >= 0, x, s * x)]


@_op("Elu")
def _elu(ctx, node, ins):
    (x,) = ins
    alpha = node.attrs.get("alpha", 1.0)
    xp = ctx.xp(ins)
    if xp is not np:
        x = xp.t(x)
    return [xp.where(x > 0, x, alpha * (xp.exp(x) - 1.0))]


@_op("HardSigmoid")
def _hardsigmoid(ctx, node, ins):
    (x,) = ins
    a = node.attrs.get("alpha", 0.2)
    b = node.attrs.get("beta", 0.5)
    xp = ctx.xp(ins)
    if xp is not np:
        x = xp.t(x)
    return [xp.clip(a * x + b, 0.0, 1.0)]


@_op("HardSwish")
def _hardswish(ctx, node, ins):
    (x,) = ins
    xp = ctx.xp(ins)
    if xp is not np:
        x = xp.t(x)
    return [x * xp.clip(x / 6.0 + 0.5, 0.0, 1.0)]


@_op("Gelu")
def _gelu(ctx, node, ins):
    (x,) = ins
    approx = _attr_str(node, "approximate", "none") == "tanh"
    return [F.gelu(ctx.tx.t(x), approximate="tanh" if approx else "none")]


@_op("Softmax", "LogSoftmax")
def _softmax(ctx, node, ins):
    (x,) = ins
    axis = node.attrs.get("axis", -1)
    fn = torch.softmax if node.op_type == "Softmax" else torch.log_softmax
    return [fn(ctx.tx.t(x), dim=axis)]


@_op("Cast")
def _cast(ctx, node, ins):
    (x,) = ins
    dt = _DTYPE_CODES.get(node.attrs.get("to"))
    if dt is None:
        raise UnsupportedOnnxOp(f"Cast to dtype code {node.attrs.get('to')}")
    return [_astype(x, dt)]


@_op("Identity", "CastLike")
def _identity(ctx, node, ins):
    if node.op_type == "CastLike":
        x, like = ins
        return [_astype(x, _dtype_of(like))]
    return [ins[0]]


@_op("Dropout")
def _dropout(ctx, node, ins):
    x = ins[0]
    outs: List[Any] = [x]
    if len(node.outputs) > 1 and node.outputs[1]:
        xp = ctx.xp([x])
        outs.append(xp.ones(_shape_of(x), dtype=bool))
    return outs


# ------------------------------------------------------------------- shapes

@_op("Shape")
def _shape(ctx, node, ins):
    (x,) = ins
    shp = _shape_of(x)
    start = node.attrs.get("start", 0)
    end = node.attrs.get("end", len(shp))
    return [np.asarray(shp[start:end], dtype=np.int64)]


@_op("Size")
def _size(ctx, node, ins):
    (x,) = ins
    return [np.asarray(int(np.prod(_shape_of(x), dtype=np.int64)), np.int64)]


@_op("Reshape")
def _reshape(ctx, node, ins):
    x, shape = ins
    tgt = ctx.const(node, shape, "shape").astype(np.int64).tolist()
    src = _shape_of(x)
    if not node.attrs.get("allowzero", 0):
        tgt = [src[i] if d == 0 else d for i, d in enumerate(tgt)]
    return [ctx.xp([x]).reshape(x, tgt)]


@_op("Transpose")
def _transpose(ctx, node, ins):
    (x,) = ins
    perm = _as_list(node.attrs.get("perm"))
    return [ctx.xp(ins).transpose(x, perm)]


@_op("Concat")
def _concat(ctx, node, ins):
    axis = node.attrs.get("axis", 0)
    return [ctx.xp(ins).concatenate(ins, axis=axis)]


@_op("Split")
def _split(ctx, node, ins):
    x = ins[0]
    axis = node.attrs.get("axis", 0)
    xp = ctx.xp([x])
    sizes = None
    if len(ins) > 1 and ins[1] is not None:
        sizes = ctx.const(node, ins[1], "split sizes").astype(np.int64).tolist()
    elif "split" in node.attrs:
        sizes = _as_list(node.attrs["split"])
    n_out = len([o for o in node.outputs if o])
    dim = _shape_of(x)[axis]
    if sizes is None:
        q, r = divmod(dim, n_out)
        sizes = [q + (1 if i < r else 0) for i in range(n_out)]
    offs = np.cumsum([0] + sizes)
    if xp is np:
        return [np.take(x, np.arange(offs[i], offs[i + 1]), axis=axis)
                for i in range(len(sizes))]
    x = xp.t(x)
    return [x.narrow(axis % x.ndim, int(offs[i]), int(sizes[i])) for i in range(len(sizes))]


def _slice_tensor(x: torch.Tensor, sl) -> torch.Tensor:
    """``x[sl]`` for slices with any step (torch takes no negative step)."""
    for a, s in enumerate(sl):
        if s == slice(None):
            continue
        n = x.shape[a]
        start, stop, step = s.indices(n)
        if step > 0:
            x = x.narrow(a, 0, n)[(slice(None),) * a + (slice(start, stop, step),)]
        else:
            idx = torch.arange(start, stop, step, device=x.device)
            x = x.index_select(a, idx)
    return x


@_op("Slice")
def _slice(ctx, node, ins):
    x = ins[0]
    if len(ins) > 1:  # opset >= 10: inputs
        starts = ctx.const(node, ins[1], "starts").astype(np.int64).tolist()
        ends = ctx.const(node, ins[2], "ends").astype(np.int64).tolist()
        axes = (ctx.const(node, ins[3], "axes").astype(np.int64).tolist()
                if len(ins) > 3 and ins[3] is not None
                else list(range(len(starts))))
        steps = (ctx.const(node, ins[4], "steps").astype(np.int64).tolist()
                 if len(ins) > 4 and ins[4] is not None else [1] * len(starts))
    else:  # opset < 10: attributes
        starts = _as_list(node.attrs.get("starts"), [])
        ends = _as_list(node.attrs.get("ends"), [])
        axes = _as_list(node.attrs.get("axes"), list(range(len(starts))))
        steps = [1] * len(starts)
    nd = len(_shape_of(x))
    big = np.iinfo(np.int32).max
    sl = [slice(None)] * nd
    for s, e, a, st in zip(starts, ends, axes, steps):
        a = a % nd
        # Exporters use INT64/INT32_MAX (or its negation) as "to the end".
        end: Optional[int] = e
        if st > 0 and e >= big:
            end = None
        elif st < 0 and e <= -big:
            end = None
        sl[a] = slice(s, end, st)
    if _is_const(x):
        return [_np(x)[tuple(sl)]]
    return [_slice_tensor(x, sl)]


@_op("Gather")
def _gather(ctx, node, ins):
    x, idx = ins
    axis = node.attrs.get("axis", 0)
    xp = ctx.xp(ins)
    if xp is np:
        return [np.take(_np(x), _np(idx).astype(np.int64), axis=axis)]
    x, idx = xp.tt(x), xp.tt(idx).long()
    axis = axis % x.ndim
    dim = x.shape[axis]
    idx = torch.where(idx < 0, idx + dim, idx)
    out = x.index_select(axis, idx.reshape(-1))
    return [out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])]


@_op("GatherElements")
def _gather_elements(ctx, node, ins):
    x, idx = ins
    axis = node.attrs.get("axis", 0)
    return [ctx.xp(ins).take_along_axis(x, idx, axis=axis)]


@_op("GatherND")
def _gather_nd(ctx, node, ins):
    xp = ctx.xp(ins)
    x = xp.asarray(ins[0])
    idx = xp.asarray(ins[1])
    if xp is not np:
        idx = idx.long()
    b = int(node.attrs.get("batch_dims", 0))
    k = _shape_of(idx)[-1]
    if b:
        # fold the shared leading batch dims into explicit index columns,
        # reducing to the batch_dims=0 case
        pre = _shape_of(idx)[:-1]
        grids = []
        for d in range(b):
            shape = [1] * len(pre)
            shape[d] = pre[d]
            g = xp.arange(pre[d]).reshape(shape)
            grids.append(xp.broadcast_to(g, tuple(pre))[..., None])
        idx = xp.concatenate(grids + [idx], axis=-1)
        k += b
    return [x[tuple(idx[..., i] for i in range(k))]]


@_op("ScatterND")
def _scatter_nd(ctx, node, ins):
    data, indices, updates = ins
    xp = ctx.xp(ins)
    k = _shape_of(indices)[-1]
    red = node.attrs.get("reduction", b"none")
    red = red.decode() if isinstance(red, bytes) else str(red)
    if xp is np:
        out = _np(data).copy()
        tup = tuple(_np(indices)[..., i] for i in range(k))
        if red == "add":
            np.add.at(out, tup, _np(updates))
        else:
            out[tup] = _np(updates)
        return [out]
    out = xp.tt(data).clone()
    idx = xp.tt(indices).long()
    tup = tuple(idx[..., i] for i in range(k))
    out.index_put_(tup, xp.tt(updates).to(out.dtype), accumulate=red == "add")
    return [out]


@_op("ReverseSequence")
def _reverse_sequence(ctx, node, ins):
    """Per-row reversal of the first sequence_lens[b] steps: the op
    bidirectional-RNN exports (silero / wenet style) wrap their backward
    pass in."""
    x, seq_lens = ins
    batch_axis = int(node.attrs.get("batch_axis", 1))
    time_axis = int(node.attrs.get("time_axis", 0))
    xp = ctx.xp(ins)
    x = xp.asarray(x)
    x2 = xp.moveaxis(x, (batch_axis, time_axis), (0, 1))
    t = x2.shape[1]
    lens = xp.asarray(seq_lens).astype(np.int64) if xp is np else xp.tt(seq_lens).long()
    lens = lens.reshape(-1)
    ar = xp.arange(t)[None, :]
    idx = lens[:, None] - 1 - ar
    idx = xp.where(idx >= 0, idx, ar)
    idx = idx.reshape(tuple(idx.shape) + (1,) * (x2.ndim - 2))
    out = xp.take_along_axis(x2, xp.broadcast_to(idx, x2.shape), axis=1)
    return [xp.moveaxis(out, (0, 1), (batch_axis, time_axis))]


@_op("Squeeze")
def _squeeze(ctx, node, ins):
    x = ins[0]
    axes = None
    if len(ins) > 1 and ins[1] is not None:
        axes = ctx.const(node, ins[1], "axes").astype(np.int64).tolist()
    elif "axes" in node.attrs:
        axes = _as_list(node.attrs["axes"])
    xp = ctx.xp([x])
    if axes is None:
        return [xp.squeeze(x)]
    return [xp.squeeze(x, axis=tuple(a % len(_shape_of(x)) for a in axes))]


@_op("Unsqueeze")
def _unsqueeze(ctx, node, ins):
    x = ins[0]
    if len(ins) > 1 and ins[1] is not None:
        axes = ctx.const(node, ins[1], "axes").astype(np.int64).tolist()
    else:
        axes = _as_list(node.attrs.get("axes"), [])
    out_nd = len(_shape_of(x)) + len(axes)
    axes = sorted(a % out_nd for a in axes)
    xp = ctx.xp([x])
    for a in axes:
        x = xp.expand_dims(x, a)
    return [x]


@_op("Flatten")
def _flatten(ctx, node, ins):
    (x,) = ins
    axis = node.attrs.get("axis", 1)
    shp = _shape_of(x)
    lead = int(np.prod(shp[:axis], dtype=np.int64)) if axis else 1
    return [ctx.xp(ins).reshape(x, (lead, -1))]


@_op("Expand")
def _expand(ctx, node, ins):
    x, shape = ins
    tgt = ctx.const(node, shape, "shape").astype(np.int64).tolist()
    # ONNX Expand is bidirectional broadcast.
    out = np.broadcast_shapes(_shape_of(x), tuple(tgt))
    return [ctx.xp([x]).broadcast_to(x, out)]


@_op("Tile")
def _tile(ctx, node, ins):
    x, reps = ins
    r = ctx.const(node, reps, "repeats").astype(np.int64).tolist()
    return [ctx.xp([x]).tile(x, r)]


@_op("Constant")
def _constant(ctx, node, ins):
    for key in ("value", "value_float", "value_int", "value_floats",
                "value_ints"):
        if key in node.attrs:
            v = node.attrs[key]
            return [np.asarray(v)]
    raise UnsupportedOnnxOp("Constant node without a value attribute")


@_op("ConstantOfShape")
def _constant_of_shape(ctx, node, ins):
    shape = ctx.const(node, ins[0], "shape").astype(np.int64).tolist()
    v = node.attrs.get("value")
    if v is None:
        v = np.zeros(1, np.float32)
    v = _np(v)
    return [np.full(shape, v.reshape(-1)[0], dtype=v.dtype)]


@_op("Range")
def _range(ctx, node, ins):
    start, limit, delta = (ctx.const(node, v, "range operand") for v in ins)
    return [np.arange(start.item(), limit.item(), delta.item(),
                      dtype=start.dtype)]


@_op("OneHot")
def _onehot(ctx, node, ins):
    idx, depth, values = ins
    d = int(ctx.const(node, depth, "depth").item())
    axis = node.attrs.get("axis", -1)
    vals = ctx.const(node, values, "values")  # [off, on]
    idx = ctx.tx.tt(idx)
    # jax.nn.one_hot: float32, an index outside [0, d) gives a zero row
    oh = (idx[..., None] == torch.arange(d, device=idx.device)).float()
    oh = torch.movedim(oh, -1, axis % oh.ndim)
    return [oh * ctx.tx.t(vals[1] - vals[0]) + ctx.tx.t(vals[0])]


@_op("Trilu")
def _trilu(ctx, node, ins):
    x = ins[0]
    k = int(ctx.const(node, ins[1], "k").item()) if len(ins) > 1 and \
        ins[1] is not None else 0
    xp = ctx.xp([x])
    return [xp.triu(x, k) if node.attrs.get("upper", 1) else xp.tril(x, k)]


def _pad_index(n: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """Source index of each of the n + lo + hi output cells along one axis
    for numpy.pad's ``reflect`` / ``edge`` / ``wrap``."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    period = max(2 * (n - 1), 1)  # reflect: the edge cell is not repeated
    m = torch.remainder(i, period)
    return torch.where(m >= n, period - m, m)


@_op("Pad")
def _pad(ctx, node, ins):
    x = ins[0]
    mode = _attr_str(node, "mode", "constant")
    if len(ins) > 1 and ins[1] is not None:
        pads = ctx.const(node, ins[1], "pads").astype(np.int64).tolist()
        cval = ins[2] if len(ins) > 2 and ins[2] is not None else 0.0
    else:
        pads = _as_list(node.attrs.get("pads"), [])
        cval = node.attrs.get("value", 0.0)
    nd = len(_shape_of(x))
    axes = (ctx.const(node, ins[3], "axes").astype(np.int64).tolist()
            if len(ins) > 3 and ins[3] is not None else list(range(nd)))
    width = [(0, 0)] * nd
    half = len(pads) // 2
    for i, a in enumerate(axes):
        width[a % nd] = (pads[i], pads[half + i])
    xp = ctx.xp([x])
    mode_map = {"constant": "constant", "reflect": "reflect", "edge": "edge",
                "wrap": "wrap"}
    if xp is np:
        if mode == "constant":
            return [np.pad(x, width, mode="constant",
                           constant_values=_np(cval).item() if _is_const(cval) else cval)]
        return [np.pad(x, width, mode=mode_map[mode])]
    x = xp.t(x)
    if mode == "constant":
        c = _np(cval).item() if _is_const(cval) else float(cval.reshape(-1)[0].item())
        flat = [p for lo_hi in reversed(width) for p in lo_hi]
        return [F.pad(x, flat, mode="constant", value=c)]
    if mode not in mode_map:
        raise KeyError(mode)  # as the JAX executor's mode_map lookup
    for a, (lo, hi) in enumerate(width):
        if lo or hi:
            x = x.index_select(a, _pad_index(x.shape[a], lo, hi, mode, x.device))
    return [x]


# ------------------------------------------------------------------ reduces

@_op("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd",
     "ReduceL2", "ReduceLogSumExp")
def _reduce(ctx, node, ins):
    x = ins[0]
    keep = bool(node.attrs.get("keepdims", 1))
    axes = None
    if len(ins) > 1 and ins[1] is not None:  # opset >= 18
        axes = tuple(ctx.const(node, ins[1], "axes").astype(np.int64).tolist())
    elif "axes" in node.attrs:
        axes = tuple(_as_list(node.attrs["axes"]))
    if axes is not None and len(axes) == 0:
        axes = None
        if node.attrs.get("noop_with_empty_axes", 0):
            return [x]
    xp = ctx.xp([x])
    op = node.op_type
    if op == "ReduceL2":
        return [xp.sqrt(xp.sum(xp.square(x), axis=axes, keepdims=keep))]
    if op == "ReduceLogSumExp":
        if xp is np:
            m = np.max(x, axis=axes, keepdims=True)
            out = np.log(np.sum(np.exp(x - m), axis=axes, keepdims=True)) + m
            return [out if keep else np.squeeze(out, axis=axes)]
        x = xp.t(x)
        return [torch.logsumexp(x, dim=xp._dims(x, axes), keepdim=keep)]
    fn = {"ReduceMean": xp.mean, "ReduceSum": xp.sum, "ReduceMax": xp.max,
          "ReduceMin": xp.min, "ReduceProd": xp.prod}[op]
    return [fn(x, axis=axes, keepdims=keep)]


@_op("ArgMax", "ArgMin")
def _argmax(ctx, node, ins):
    (x,) = ins
    axis = node.attrs.get("axis", 0)
    keep = bool(node.attrs.get("keepdims", 1))
    xp = ctx.xp(ins)
    fn = xp.argmax if node.op_type == "ArgMax" else xp.argmin
    out = fn(x, axis=axis)
    if keep:
        out = xp.expand_dims(out, axis)
    return [out.astype(np.int64) if xp is np else out]


@_op("CumSum")
def _cumsum(ctx, node, ins):
    x, axis = ins
    a = int(ctx.const(node, axis, "axis").item())
    if node.attrs.get("exclusive", 0) or node.attrs.get("reverse", 0):
        raise UnsupportedOnnxOp("CumSum exclusive/reverse")
    return [ctx.xp([x]).cumsum(x, axis=a)]


@_op("TopK")
def _topk(ctx, node, ins):
    x, k = ins
    kk = int(ctx.const(node, k, "k").item())
    axis = node.attrs.get("axis", -1)
    x = ctx.tx.tt(x)
    axis = axis % x.ndim
    # a stable descending sort: ties keep the lower index first, as
    # lax.top_k orders them
    vals, idx = torch.sort(x, dim=axis, descending=True, stable=True)
    return [vals.narrow(axis, 0, kk), idx.narrow(axis, 0, kk)]


# --------------------------------------------------------------- linear alg

@_op("MatMul")
def _matmul(ctx, node, ins):
    x, y = ins
    return [ctx.xp(ins).matmul(x, y)]


@_op("Gemm")
def _gemm(ctx, node, ins):
    a, b = ins[0], ins[1]
    c = ins[2] if len(ins) > 2 else None
    xp = ctx.xp(ins)
    if node.attrs.get("transA", 0):
        a = xp.swapaxes(a, -1, -2)
    if node.attrs.get("transB", 0):
        b = xp.swapaxes(b, -1, -2)
    out = node.attrs.get("alpha", 1.0) * xp.matmul(a, b)
    if c is not None:
        out = out + node.attrs.get("beta", 1.0) * (c if xp is np else xp.t(c))
    return [out]


@_op("Einsum")
def _einsum(ctx, node, ins):
    eq = _attr_str(node, "equation")
    with no_tf32():
        return [torch.einsum(eq, *(ctx.tx.tt(x) for x in ins))]


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


@counted(lambda a8, b8: int_matmul_work(a8.numel() // max(a8.shape[-1], 1), a8.shape[-1],
                                         b8.shape[1]))
def _int8_mm(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """int8 [..., M, K] x int8 [K, N] -> the exact int32 sums [..., M, N]
    (the s32 accumulator of the JAX path's s8 MXU dot). A work count
    (ops/work) takes ``int_matmul_work`` on either device."""
    lead, k = a8.shape[:-1], a8.shape[-1]
    n = b8.shape[1]
    a2 = a8.reshape(-1, k)
    if a8.device.type != "cuda":
        # float64 holds these sums exactly (|sum| < K * 2^14 << 2^53) and
        # runs on the CPU's BLAS, unlike an int32 matmul
        return torch.round(torch.matmul(a2.double(), b8.double())).to(torch.int32).reshape(*lead, n)
    # torch._int_mm takes K and N in multiples of 8 and more than 16 rows,
    # and cuBLASLt on the H100 refuses row counts off a multiple of 32 when
    # K < 128 (ops/quant.int_matmul pads the same way); zero rows and
    # columns add nothing to the sums
    m = a2.shape[0]
    mp, kp, np_ = max(_pad_to(m, 32), 32), _pad_to(k, 8), _pad_to(n, 8)
    if (mp, kp) != (m, k):
        a2 = F.pad(a2, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b8 = F.pad(b8, (0, np_ - n, 0, kp - k))
    acc = torch._int_mm(a2.contiguous(), b8.contiguous())
    return acc[:m, :n].reshape(*lead, n)


def _int_matmul_core(ctx, a, b, azp, bzp):
    """(a - azp) @ (b - bzp) in exact int32 (core of MatMulInteger /
    QLinearMatMul, ORT's dynamic- and static-quant linear layers).

    As in JAX, the product itself runs on int8 operands with the zero
    points applied by the algebraic expansion
      (a - za)(b - zb) = ab - za*colsum(b) - zb*rowsum(a) + K*za*zb
    (integer math; bit-identical to the upcast form): uint8 operands shift
    to int8 by -128 with the zero point shifted to match, and the b zero
    point may be per-column ([N], ORT per-channel weight quantization). A
    per-row a zero point takes the upcast form, in float64 (exact for these
    sums; the card has no int32 matmul)."""
    xp = ctx.xp([a, b, azp, bzp])
    a_dt, b_dt = _dtype_of(a), _dtype_of(b)

    def _zp_rank(z):
        # size-1 vectors count as per-tensor scalars ([1]-shaped zps occur
        # in the wild even though the spec says shape [])
        if z is None:
            return 0
        if _is_const(z):
            return 0 if _np(z).size == 1 else _np(z).ndim
        if z.ndim == 1 and z.shape[0] == 1:
            return 0
        return z.ndim

    n_cols = _shape_of(b)[-1] if len(_shape_of(b)) == 2 else -1
    bzp_ok = _zp_rank(bzp) == 0 or (
        _zp_rank(bzp) == 1 and _shape_of(bzp)[0] == n_cols)
    if (xp is not np and _zp_rank(azp) == 0 and bzp_ok
            and a_dt in (np.int8, np.uint8) and b_dt in (np.int8, np.uint8)
            and len(_shape_of(a)) >= 2 and len(_shape_of(b)) == 2):
        tx = ctx.tx

        def to_s8(x, zp, dt):
            # zero point: None if it statically vanishes, else an int32
            # scalar / [N] vector (python int for a scalar constant zp, a
            # tensor for a per-column or device zp: DynamicQuantizeLinear
            # emits its zp as a device value)
            if zp is None:
                zv = None
            elif _is_const(zp):
                zn = _np(zp).astype(np.int32)
                zv = (int(zn.reshape(())) or None) if zn.size == 1 \
                    else tx.t(zn.reshape(-1))
            else:
                zv = zp.to(torch.int32).reshape(() if zp.ndim == 0 else (-1,))
            if dt == np.uint8:
                # u8 - 128 fits s8 exactly; shift the zero point to match
                x = (x.to(torch.int16) - 128).to(torch.int8)
                zv = -128 if zv is None else zv - 128
            return x, zv

        a8, za = to_s8(tx.tt(a), azp, a_dt)
        b8, zb = to_s8(tx.tt(b), bzp, b_dt)
        k = int(a8.shape[-1])
        corr = _int8_mm(a8, b8)  # [..., M, N] int32
        if za is not None:
            colsum = torch.sum(b8.to(torch.int32), dim=0, dtype=torch.int32)  # [N]
            corr = corr - za * colsum
        if zb is not None:
            # scalar zb broadcasts; per-column zb [N] broadcasts over the
            # output columns against rowsum's [..., M, 1]
            rowsum = torch.sum(a8.to(torch.int32), dim=-1, keepdim=True, dtype=torch.int32)
            corr = corr - zb * rowsum
        if za is not None and zb is not None:
            corr = corr + k * za * zb
        return corr.to(torch.int32)
    if _zp_rank(azp) == 1:
        # a per-row a zero point ([M], the spec's shape) subtracts along
        # the rows (the JAX fallback broadcasts it along the columns)
        azp = _np(azp).reshape(-1, 1) if _is_const(azp) else azp.reshape(-1, 1)
    if xp is np:
        a32 = np.asarray(a, np.int32)
        b32 = np.asarray(b, np.int32)
        if azp is not None:
            a32 = a32 - np.asarray(azp, np.int32)
        if bzp is not None:
            b32 = b32 - np.asarray(bzp, np.int32)
        return np.matmul(a32, b32)
    tx = ctx.tx
    a32 = tx.tt(a).to(torch.int32)
    b32 = tx.tt(b).to(torch.int32)
    if azp is not None:
        a32 = a32 - tx.tt(azp).to(torch.int32)
    if bzp is not None:
        b32 = b32 - tx.tt(bzp).to(torch.int32)
    return torch.round(torch.matmul(a32.double(), b32.double())).to(torch.int32)


@_op("MatMulInteger")
def _matmul_integer(ctx, node, ins):
    """See _int_matmul_core (sherpa-onnx int8 exports, e.g. SenseVoice:
    DynamicQuantizeLinear activations x int8 weights)."""
    a, b = ins[0], ins[1]
    azp = ins[2] if len(ins) > 2 and ins[2] is not None else None
    bzp = ins[3] if len(ins) > 3 and ins[3] is not None else None
    return [_int_matmul_core(ctx, a, b, azp, bzp)]


@_op("QLinearMatMul")
def _qlinear_matmul(ctx, node, ins):
    """Static-quant matmul: deq(a) @ deq(b) requantized to y's scale / zp.

    Integer core via _int_matmul_core, then one float rescale:
    y = saturate(round(acc * (sa*sb/sy)) + y_zp)."""
    a, a_s, a_zp, b, b_s, b_zp, y_s, y_zp = ins[:8]
    acc = _int_matmul_core(ctx, a, b, a_zp, b_zp)
    xp = ctx.xp(ins)
    scale = _fval(a_s) * _fval(b_s) / _fval(y_s)
    if getattr(scale, "ndim", 0) == 1 and scale.shape[0] > 1:
        scale = scale.reshape(-1)  # per-column b scale broadcasts over N
    return [_requant_scaled(xp, acc, scale, y_zp)]


def _fval(x):
    """scale / zero-point operand -> float32 (constant or device)."""
    return _astype(x, np.float32)


def _deq_f32(xp, x, scale, zp):
    """dequantize to float32 (per-tensor scale / zp, constant or device)."""
    xf = _astype(x, np.float32)
    if xp is not np:
        xf = xp.t(xf)
    if zp is not None:
        xf = xf - (_fval(zp) if xp is np else xp.t(_fval(zp)))
    return xf * (_fval(scale) if xp is np else xp.t(_fval(scale)))


def _requant(xp, y_f32, y_scale, y_zp):
    """round / shift / saturate float32 back onto y's integer grid."""
    return _requant_scaled(xp, y_f32, 1.0 / _fval(y_scale), y_zp)


def _requant_scaled(xp, acc, scale, y_zp):
    """saturate(round(acc * scale) + y_zp): the single rescale step shared
    by every QLinear output (matmul / conv pass sa*sb/sy pre-combined,
    possibly per-channel shaped; eltwise passes 1/sy)."""
    y_dt = _dtype_of(y_zp) if y_zp is not None else np.dtype(np.uint8)
    info = np.iinfo(y_dt)
    if xp is np:
        q = np.round(np.asarray(acc).astype(np.float32) * scale)
        if y_zp is not None:
            q = q + _fval(y_zp)
        return np.clip(q, info.min, info.max).astype(y_dt)
    q = torch.round(xp.t(acc).float() * xp.t(scale))
    if y_zp is not None:
        q = q + xp.t(_fval(y_zp))
    return torch.clamp(q, info.min, info.max).to(_TORCH_OF[y_dt])


def _qlinear_eltwise(fn):
    """com.microsoft QLinear elementwise family (QLinearAdd / Mul):
    deq -> float op -> requant, the float-rescale semantics ORT's contrib
    kernels implement."""
    def handler(ctx, node, ins):
        a, a_s, a_zp, b, b_s, b_zp, y_s, y_zp = ins[:8]
        xp = ctx.xp(ins)
        y = fn(xp, _deq_f32(xp, a, a_s, a_zp), _deq_f32(xp, b, b_s, b_zp), node)
        return [_requant(xp, y, y_s, y_zp)]
    return handler


_op("QLinearAdd")(_qlinear_eltwise(lambda xp, a, b, node: a + b))
_op("QLinearMul")(_qlinear_eltwise(lambda xp, a, b, node: a * b))


def _qlinear_unary(fn):
    def handler(ctx, node, ins):
        x, x_s, x_zp, y_s, y_zp = ins[:5]
        xp = ctx.xp(ins)
        return [_requant(xp, fn(xp, node, _deq_f32(xp, x, x_s, x_zp)), y_s, y_zp)]
    return handler


_op("QLinearSigmoid")(_qlinear_unary(lambda xp, node, x: 1.0 / (1.0 + xp.exp(-x))))
_op("QLinearLeakyRelu")(_qlinear_unary(
    lambda xp, node, x: xp.where(x >= 0, x, float(np.float32(node.attrs.get("alpha", 0.01))) * x)))


@_op("QLinearGlobalAveragePool")
def _qlinear_global_avgpool(ctx, node, ins):
    x, x_s, x_zp, y_s, y_zp = ins[:5]
    xp = ctx.xp(ins)
    nd = len(_shape_of(x))
    axes = tuple(range(1, nd - 1)) if node.attrs.get("channels_last", 0) \
        else tuple(range(2, nd))
    # mean over the integer grid first (exact up to one float division),
    # then one rescale: avoids materializing the dequantized tensor
    mean = xp.mean(_astype(x, np.float32), axis=axes, keepdims=True)
    if xp is not np:
        if x_zp is not None:
            mean = mean - xp.t(_fval(x_zp))
        return [_requant(xp, mean * xp.t(_fval(x_s)), y_s, y_zp)]
    if x_zp is not None:
        mean = mean - _fval(x_zp)
    return [_requant(xp, mean * _fval(x_s), y_s, y_zp)]


@_op("QGemm")
def _qgemm(ctx, node, ins):
    """com.microsoft QGemm: alpha * deq(A') @ deq(B') + bias, with A' / B'
    optionally transposed; integer core via _int_matmul_core. Bias is int32
    at scale a_scale*b_scale. Output is quantized when y_scale is given,
    float32 otherwise (per contrib-op spec)."""
    a, a_s, a_zp, b, b_s, b_zp = ins[:6]
    bias = ins[6] if len(ins) > 6 and ins[6] is not None else None
    y_s = ins[7] if len(ins) > 7 and ins[7] is not None else None
    y_zp = ins[8] if len(ins) > 8 and ins[8] is not None else None
    xp = ctx.xp(ins)
    if node.attrs.get("transA", 0):
        a = xp.swapaxes(_np(a) if _is_const(a) else a, -1, -2)
    if node.attrs.get("transB", 0):
        b = xp.swapaxes(_np(b) if _is_const(b) else b, -1, -2)
    acc = _int_matmul_core(ctx, a, b, a_zp, b_zp)
    if bias is not None:
        b32 = _astype(bias, np.int32)
        acc = acc + (b32 if xp is np else xp.t(b32))
    alpha = np.float32(node.attrs.get("alpha", 1.0))
    scale = alpha * _fval(a_s) * _fval(b_s)
    if getattr(scale, "ndim", 0) == 1 and scale.shape[0] > 1:
        scale = scale.reshape(-1)
    if xp is np:
        y = acc.astype(np.float32) * scale
    else:
        y = xp.t(acc).float() * xp.t(scale)
    if y_s is None:
        return [y]
    return [_requant(xp, y, y_s, y_zp)]


@_op("DequantizeLinear")
def _dequantize(ctx, node, ins):
    x, scale = ins[0], ins[1]
    zp = ins[2] if len(ins) > 2 and ins[2] is not None else None
    axis = node.attrs.get("axis", 1)
    xp = ctx.xp(ins)
    s = _np(scale) if _is_const(scale) else scale
    z = (_np(zp) if _is_const(zp) else zp) if zp is not None else None
    nd = len(_shape_of(x))
    if s.ndim == 1 and s.shape[0] > 1 and nd > 1:
        shape = [1] * nd
        shape[axis % nd] = s.shape[0]
        s = s.reshape(shape)
        if z is not None and z.ndim == 1:
            z = z.reshape(shape)
    xf = _astype(x, np.float32)
    if xp is not np:
        xf = xp.t(xf)
    if z is not None:
        zf = _astype(z, np.float32)
        xf = xf - (zf if xp is np else xp.t(zf))
    sf = _astype(s, np.float32)
    return [xf * (sf if xp is np else xp.t(sf))]


@_op("QuantizeLinear")
def _quantize(ctx, node, ins):
    x, scale = ins[0], ins[1]
    zp = ins[2] if len(ins) > 2 and ins[2] is not None else None
    dt = _dtype_of(zp) if zp is not None else np.dtype(np.uint8)
    info = np.iinfo(dt)
    xp = ctx.xp(ins)
    if xp is np:
        q = np.round(x / scale)
        if zp is not None:
            q = q + _np(zp).astype(np.float32)
        return [np.clip(q, info.min, info.max).astype(dt)]
    q = torch.round(xp.t(x) / xp.t(scale))
    if zp is not None:
        q = q + xp.t(_astype(zp, np.float32))
    return [torch.clamp(q, info.min, info.max).to(_TORCH_OF[dt])]


@_op("DynamicQuantizeLinear")
def _dyn_quantize(ctx, node, ins):
    (x,) = ins
    x = ctx.tx.tt(x)
    # Spec: scale over [min(x,0), max(x,0)] onto uint8.
    xmin = torch.clamp_max(torch.amin(x), 0.0)
    xmax = torch.clamp_min(torch.amax(x), 0.0)
    scale = (xmax - xmin) / 255.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    zp = torch.clamp(torch.round(0.0 - xmin / scale), 0, 255).to(torch.uint8)
    y = torch.clamp(torch.round(x / scale) + zp.float(), 0, 255)
    return [y.to(torch.uint8), scale.float(), zp]


# ----------------------------------------------------------- conv / pooling

def _conv_padding(node: OnnxNode, in_spatial, k_eff, strides):
    auto = _attr_str(node, "auto_pad", "NOTSET")
    nsp = len(in_spatial)
    if auto in ("", "NOTSET"):
        pads = _as_list(node.attrs.get("pads"), [0] * (2 * nsp))
        return [(pads[i], pads[nsp + i]) for i in range(nsp)]
    if auto == "VALID":
        return [(0, 0)] * nsp
    out = []
    for i in range(nsp):
        o = -(-in_spatial[i] // strides[i])  # ceil
        total = max(0, (o - 1) * strides[i] + k_eff[i] - in_spatial[i])
        if auto == "SAME_UPPER":
            out.append((total // 2, total - total // 2))
        else:  # SAME_LOWER
            out.append((total - total // 2, total // 2))
    return out


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _pad_spatial(x: torch.Tensor, pads, value=0.0) -> torch.Tensor:
    """Pad the spatial axes of an NC* tensor by (lo, hi) pairs."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return F.pad(x, flat, value=value) if any(flat) else x


def _conv_nd(x, w, strides, pads, dil, groups):
    """Zero-padded cross-correlation of an NC* tensor (lax.conv_general_dilated)."""
    x = _pad_spatial(x, pads)
    with no_tf32():
        return _CONV[w.ndim - 2](x, w, stride=tuple(strides), dilation=tuple(dil),
                                 groups=groups)


@_op("Conv")
def _conv(ctx, node, ins):
    x, w = ins[0], ins[1]
    b = ins[2] if len(ins) > 2 else None
    nsp = len(_shape_of(w)) - 2
    strides = _as_list(node.attrs.get("strides"), [1] * nsp)
    dil = _as_list(node.attrs.get("dilations"), [1] * nsp)
    groups = node.attrs.get("group", 1)
    k = _shape_of(w)[2:]
    k_eff = [(kk - 1) * d + 1 for kk, d in zip(k, dil)]
    pads = _conv_padding(node, _shape_of(x)[2:], k_eff, strides)
    tx = ctx.tx
    x, w = tx.tt(x), tx.tt(w)
    out = _conv_nd(x, w.to(x.dtype), strides, pads, dil, groups)
    if b is not None:
        out = out + tx.tt(b).reshape((1, -1) + (1,) * nsp)
    return [out]


def _int_conv_core(ctx, node, x, w, xzp, wzp):
    """Integer conv with the exact int32 result (core of ConvInteger /
    QLinearConv).

    Zero points are subtracted BEFORE the conv so the zero padding is exact
    (a padded cell represents x_zero_point, i.e. dequantized 0:
    onnxruntime's semantics). The shifted operands convolve in float64,
    exact for any real kernel (products fit 18 bits, sums far below 2^53);
    the w zero point may be per-output-channel [M]."""
    tx = ctx.tx
    nsp = len(_shape_of(w)) - 2
    strides = _as_list(node.attrs.get("strides"), [1] * nsp)
    dil = _as_list(node.attrs.get("dilations"), [1] * nsp)
    groups = node.attrs.get("group", 1)
    k = _shape_of(w)[2:]
    k_eff = [(kk - 1) * d + 1 for kk, d in zip(k, dil)]
    pads = _conv_padding(node, _shape_of(x)[2:], k_eff, strides)

    def shift(t, zp, channel_shape=None):
        t = tx.tt(t).to(torch.float64)
        if zp is not None and _is_const(zp) and not _np(zp).any():
            zp = None
        if zp is None:
            return t
        z = tx.tt(zp).to(torch.float64)
        if z.ndim == 1 and z.numel() > 1 and channel_shape:
            z = z.reshape(channel_shape)
        return t - z

    xs = shift(x, xzp)
    ws = shift(w, wzp, channel_shape=(-1,) + (1,) * (nsp + 1))
    return torch.round(_conv_nd(xs, ws, strides, pads, dil, groups)).to(torch.int32)


@_op("ConvInteger")
def _conv_integer(ctx, node, ins):
    """See _int_conv_core (ORT dynamic-quant conv)."""
    x, w = ins[0], ins[1]
    xzp = ins[2] if len(ins) > 2 and ins[2] is not None else None
    wzp = ins[3] if len(ins) > 3 and ins[3] is not None else None
    return [_int_conv_core(ctx, node, x, w, xzp, wzp)]


@_op("QLinearConv")
def _qlinear_conv(ctx, node, ins):
    """Static-quant conv: deq(x) * deq(w) (+ int32 bias pre-scaled to
    x_scale*w_scale) requantized to y's scale / zp. Integer core via
    _int_conv_core, then one float rescale (per-output-channel w scale
    supported)."""
    x, x_s, x_zp, w, w_s, w_zp, y_s, y_zp = ins[:8]
    bias = ins[8] if len(ins) > 8 and ins[8] is not None else None
    acc = _int_conv_core(ctx, node, x, w, x_zp, w_zp)
    nsp = acc.ndim - 2
    tx = ctx.tx
    if bias is not None:
        acc = acc + tx.tt(_astype(bias, np.int32)).reshape((1, -1) + (1,) * nsp)
    scale = _fval(x_s) * _fval(w_s) / _fval(y_s)
    if getattr(scale, "ndim", 0) == 1 and scale.shape[0] > 1:
        scale = scale.reshape((1, -1) + (1,) * nsp)  # per-channel w scale
    return [_requant_scaled(tx, acc, scale, y_zp)]


@_op("ConvTranspose")
def _conv_transpose(ctx, node, ins):
    x, w = ins[0], ins[1]
    b = ins[2] if len(ins) > 2 else None
    wshape = _shape_of(w)  # [C_in, C_out/g, *k]
    nsp = len(wshape) - 2
    strides = _as_list(node.attrs.get("strides"), [1] * nsp)
    dil = _as_list(node.attrs.get("dilations"), [1] * nsp)
    groups = node.attrs.get("group", 1)
    if groups != 1:
        raise UnsupportedOnnxOp("grouped ConvTranspose")
    out_pad = _as_list(node.attrs.get("output_padding"), [0] * nsp)
    pads = _as_list(node.attrs.get("pads"), [0] * (2 * nsp))
    tx = ctx.tx
    x, w = tx.tt(x), tx.tt(w)
    with no_tf32():
        full = _CONV_T[nsp](x, w.to(x.dtype), stride=tuple(strides), dilation=tuple(dil))
    # the full transposed conv covers every contribution; ONNX crops
    # pads[i] at the start and pads[nsp + i] - output_padding at the end
    # (cells past the full length take no contribution: zeros)
    for i in range(nsp):
        lo, hi = pads[i], pads[nsp + i] - out_pad[i]
        if hi < 0:
            widths = [(0, 0)] * nsp
            widths[i] = (0, -hi)
            full = _pad_spatial(full, widths)
            hi = 0
        full = full.narrow(2 + i, lo, full.shape[2 + i] - lo - hi)
    if b is not None:
        full = full + tx.tt(b).reshape((1, -1) + (1,) * nsp)
    return [full]


def _pool(ctx, node, ins, kind: str):
    (x,) = ins[:1]
    x = ctx.tx.tt(x)
    shp = tuple(x.shape)
    nsp = len(shp) - 2
    k = _as_list(node.attrs.get("kernel_shape"))
    strides = _as_list(node.attrs.get("strides"), [1] * nsp)
    dil = _as_list(node.attrs.get("dilations"), [1] * nsp)
    k_eff = [(kk - 1) * d + 1 for kk, d in zip(k, dil)]
    pads = _conv_padding(node, shp[2:], k_eff, strides)
    if node.attrs.get("ceil_mode", 0):
        pads = list(pads)
        for i in range(nsp):
            span = shp[2 + i] + pads[i][0] + pads[i][1] - k_eff[i]
            out_ceil = -(-span // strides[i]) + 1
            need = (out_ceil - 1) * strides[i] + k_eff[i] - shp[2 + i] - pads[i][0]
            pads[i] = (pads[i][0], max(pads[i][1], need))

    def windows(t):
        # lax.reduce_window over the padded input: each spatial axis cut
        # into strided windows of k_eff cells, every dil-th cell taken
        for i in range(nsp):
            t = t.unfold(2 + i, k_eff[i], strides[i])[..., ::dil[i]]
        return t

    red = tuple(range(-nsp, 0))
    if kind == "max":
        fill = -math.inf if x.is_floating_point() else np.iinfo(_dtype_of(x)).min
        return [torch.amax(windows(_pad_spatial(x, pads, fill)), dim=red)]
    total = torch.sum(windows(_pad_spatial(x, pads)), dim=red)
    if node.attrs.get("count_include_pad", 0):
        return [total / float(np.prod(k))]
    counts = torch.sum(windows(_pad_spatial(torch.ones_like(x), pads)), dim=red)
    return [total / counts]


@_op("MaxPool")
def _maxpool(ctx, node, ins):
    return _pool(ctx, node, ins, "max")


@_op("AveragePool")
def _avgpool(ctx, node, ins):
    return _pool(ctx, node, ins, "avg")


@_op("GlobalAveragePool", "GlobalMaxPool")
def _globalpool(ctx, node, ins):
    (x,) = ins
    tx = ctx.tx
    axes = tuple(range(2, len(_shape_of(x))))
    fn = tx.mean if node.op_type == "GlobalAveragePool" else tx.max
    return [fn(x, axis=axes, keepdims=True)]


# ------------------------------------------------------------ normalization

@_op("BatchNormalization")
def _batchnorm(ctx, node, ins):
    x, scale, bias, mean, var = (ctx.tx.tt(v) for v in ins[:5])
    eps = node.attrs.get("epsilon", 1e-5)
    nsp = x.ndim - 2
    shape = (1, -1) + (1,) * nsp
    inv = scale.reshape(shape) / torch.sqrt(var.reshape(shape) + eps)
    return [x * inv + (bias.reshape(shape) - mean.reshape(shape) * inv)]


@_op("LayerNormalization")
def _layernorm(ctx, node, ins):
    tx = ctx.tx
    x, scale = tx.tt(ins[0]), tx.tt(ins[1])
    bias = tx.t(ins[2]) if len(ins) > 2 else None
    axis = node.attrs.get("axis", -1)
    eps = node.attrs.get("epsilon", 1e-5)
    axes = tuple(range(axis % x.ndim, x.ndim))
    mu = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=axes, keepdim=True)
    out = (x - mu) / torch.sqrt(var + eps) * scale
    if bias is not None:
        out = out + bias
    outs = [out]
    if len(node.outputs) > 1:
        outs += [mu, 1.0 / torch.sqrt(var + eps)][: len(node.outputs) - 1]
    return outs


@_op("InstanceNormalization")
def _instancenorm(ctx, node, ins):
    x, scale, bias = (ctx.tx.tt(v) for v in ins)
    eps = node.attrs.get("epsilon", 1e-5)
    nsp = x.ndim - 2
    axes = tuple(range(2, 2 + nsp))
    mu = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=axes, keepdim=True)
    shape = (1, -1) + (1,) * nsp
    return [(x - mu) / torch.sqrt(var + eps) * scale.reshape(shape)
            + bias.reshape(shape)]


@_op("LpNormalization")
def _lpnorm(ctx, node, ins):
    x = ctx.tx.tt(ins[0])
    axis = node.attrs.get("axis", -1)
    p = node.attrs.get("p", 2)
    if p == 2:
        n = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True))
    else:
        n = torch.sum(torch.abs(x), dim=axis, keepdim=True)
    return [x / torch.clamp_min(n, 1e-12)]


# -------------------------------------------------------------- recurrences

def _rnn_common(ctx, node, ins):
    """Shared unpack for LSTM / GRU: returns (x[T,B,I], w, r, layout,
    direction, directions)."""
    tx = ctx.tx
    x, w, r = tx.tt(ins[0]), tx.tt(ins[1]), tx.tt(ins[2])
    layout = node.attrs.get("layout", 0)
    if layout == 1:  # [B,T,I] -> [T,B,I]
        x = torch.swapaxes(x, 0, 1)
    direction = _attr_str(node, "direction", "forward")
    ndir = 2 if direction == "bidirectional" else 1
    return x, w, r, layout, direction, ndir


def _valid_steps(tx, seq_lens, T, B, reverse):
    """[T, B] bool: step t of row b is inside its sequence length."""
    if seq_lens is None:
        return torch.ones((T, B), dtype=torch.bool, device=tx.device)
    steps = torch.arange(T, device=tx.device)
    tidx = (T - 1 - steps) if reverse else steps
    return tidx[:, None] < tx.tt(seq_lens)[None, :]


@_op("LSTM")
def _lstm(ctx, node, ins):
    tx = ctx.tx
    x, w, r, layout, direction, ndir = _rnn_common(ctx, node, ins)
    T, B, _ = x.shape
    H = node.attrs.get("hidden_size", r.shape[-1])
    b = ins[3] if len(ins) > 3 and ins[3] is not None else None
    seq_lens = ins[4] if len(ins) > 4 and ins[4] is not None else None
    h0 = ins[5] if len(ins) > 5 and ins[5] is not None else None
    c0 = ins[6] if len(ins) > 6 and ins[6] is not None else None
    if len(ins) > 7 and ins[7] is not None:
        raise UnsupportedOnnxOp("LSTM peepholes")

    def run_dir(d: int, reverse: bool):
        wd, rd = w[d], r[d]  # [4H, I], [4H, H]
        if b is not None:
            bd = tx.tt(b)[d]
            bias = bd[: 4 * H] + bd[4 * H:]
        else:
            bias = torch.zeros((4 * H,), dtype=x.dtype, device=x.device)
        h = tx.tt(h0)[d] if h0 is not None else torch.zeros((B, H), dtype=x.dtype,
                                                             device=x.device)
        c = tx.tt(c0)[d] if c0 is not None else torch.zeros((B, H), dtype=x.dtype,
                                                             device=x.device)
        xs = torch.flip(x, (0,)) if reverse else x
        with no_tf32():
            pre_x = torch.einsum("tbi,gi->tbg", xs, wd) + bias
        valid = _valid_steps(tx, seq_lens, T, B, reverse)
        ys = []
        for t in range(T):
            with loop_step(t, T), no_tf32():
                z = pre_x[t] + h @ rd.T
                i = torch.sigmoid(z[:, 0 * H:1 * H])
                o = torch.sigmoid(z[:, 1 * H:2 * H])
                f = torch.sigmoid(z[:, 2 * H:3 * H])
                g = torch.tanh(z[:, 3 * H:4 * H])
                c_new = f * c + i * g
                h_new = o * torch.tanh(c_new)
                m = valid[t][:, None]
                h = torch.where(m, h_new, h)
                c = torch.where(m, c_new, c)
                ys.append(torch.where(m, h_new, torch.zeros_like(h_new)))
        ys = torch.stack(ys) if ys else pre_x.new_zeros((0, B, H))
        if reverse:
            ys = torch.flip(ys, (0,))
        return ys, h, c

    dirs = [(0, direction == "reverse")]
    if ndir == 2:
        dirs = [(0, False), (1, True)]
    ys, hs, cs = zip(*(run_dir(d, rev) for d, rev in dirs))
    Y = torch.stack(ys, dim=1)  # [T, D, B, H]
    Yh = torch.stack(hs, dim=0)  # [D, B, H]
    Yc = torch.stack(cs, dim=0)
    if layout == 1:
        Y = Y.permute(2, 0, 1, 3)  # -> [B, T, D, H]
        Yh = torch.swapaxes(Yh, 0, 1)
        Yc = torch.swapaxes(Yc, 0, 1)
    return [Y, Yh, Yc][: max(1, len(node.outputs))]


@_op("GRU")
def _gru(ctx, node, ins):
    tx = ctx.tx
    x, w, r, layout, direction, ndir = _rnn_common(ctx, node, ins)
    T, B, _ = x.shape
    H = node.attrs.get("hidden_size", r.shape[-1])
    b = ins[3] if len(ins) > 3 and ins[3] is not None else None
    seq_lens = ins[4] if len(ins) > 4 and ins[4] is not None else None
    h0 = ins[5] if len(ins) > 5 and ins[5] is not None else None
    lbr = node.attrs.get("linear_before_reset", 0)

    def run_dir(d: int, reverse: bool):
        wd, rd = w[d], r[d]  # [3H, I], [3H, H]
        if b is not None:
            bd = tx.tt(b)[d]
            wb, rb = bd[: 3 * H], bd[3 * H:]
        else:
            wb = rb = torch.zeros((3 * H,), dtype=x.dtype, device=x.device)
        h = tx.tt(h0)[d] if h0 is not None else torch.zeros((B, H), dtype=x.dtype,
                                                             device=x.device)
        xs = torch.flip(x, (0,)) if reverse else x
        with no_tf32():
            pre_x = torch.einsum("tbi,gi->tbg", xs, wd) + wb
        valid = _valid_steps(tx, seq_lens, T, B, reverse)
        ys = []
        for t in range(T):
            with loop_step(t, T), no_tf32():
                zx = pre_x[t]
                hr = h @ rd.T + rb
                zt = torch.sigmoid(zx[:, :H] + hr[:, :H])
                rt = torch.sigmoid(zx[:, H:2 * H] + hr[:, H:2 * H])
                if lbr:
                    ht = torch.tanh(zx[:, 2 * H:] + rt * hr[:, 2 * H:])
                else:
                    ht = torch.tanh(zx[:, 2 * H:] + (rt * h) @ rd[2 * H:].T + rb[2 * H:])
                h_new = (1.0 - zt) * ht + zt * h
                m = valid[t][:, None]
                h = torch.where(m, h_new, h)
                ys.append(torch.where(m, h_new, torch.zeros_like(h_new)))
        ys = torch.stack(ys) if ys else pre_x.new_zeros((0, B, H))
        if reverse:
            ys = torch.flip(ys, (0,))
        return ys, h

    dirs = [(0, direction == "reverse")]
    if ndir == 2:
        dirs = [(0, False), (1, True)]
    ys, hs = zip(*(run_dir(d, rev) for d, rev in dirs))
    Y = torch.stack(ys, dim=1)
    Yh = torch.stack(hs, dim=0)
    if layout == 1:
        Y = Y.permute(2, 0, 1, 3)
        Yh = torch.swapaxes(Yh, 0, 1)
    return [Y, Yh][: max(1, len(node.outputs))]


# ------------------------------------------------------------------- signal

@_op("STFT")
def _stft(ctx, node, ins):
    tx = ctx.tx
    signal, frame_step = ins[0], ins[1]
    window = ins[2] if len(ins) > 2 and ins[2] is not None else None
    frame_len = ins[3] if len(ins) > 3 and ins[3] is not None else None
    step = int(ctx.const(node, frame_step, "frame_step").item())
    sig = tx.tt(signal)
    if sig.ndim == 3:  # [B, L, 1]
        sig = sig[..., 0]
    if frame_len is not None:
        flen = int(ctx.const(node, frame_len, "frame_length").item())
    elif window is not None:
        flen = _shape_of(window)[0]
    else:
        raise UnsupportedOnnxOp("STFT without frame_length or window")
    B, L = sig.shape
    n_frames = 1 + (L - flen) // step
    idx = np.arange(flen)[None, :] + step * np.arange(n_frames)[:, None]
    frames = sig[:, tx.t(idx)]  # [B, F, flen]
    if window is not None:
        frames = frames * tx.tt(window)
    if node.attrs.get("onesided", 1):
        spec = torch.fft.rfft(frames, n=flen, dim=-1)
    else:
        spec = torch.fft.fft(frames, n=flen, dim=-1)
    return [torch.stack([spec.real, spec.imag], dim=-1)]


def _resize_kernel(method: str, x: torch.Tensor) -> torch.Tensor:
    if method == "linear":
        return torch.clamp_min(1.0 - torch.abs(x), 0.0)
    # Keys cubic, a = -0.5
    x = torch.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in: int, n_out: int, method: str, device) -> torch.Tensor:
    """[n_in, n_out] interpolation weights of jax.image.resize
    (scale_and_translate, half-pixel centres, antialiased when
    downsampling)."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(n_in, dtype=torch.float32,
                                                   device=device)[:, None]) / kernel_scale
    w = _resize_kernel(method, x)
    total = torch.sum(w, dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


@_op("Resize")
def _resize(ctx, node, ins):
    x = ins[0]
    shp = _shape_of(x)
    sizes = None
    if len(ins) > 3 and ins[3] is not None:
        sizes = ctx.const(node, ins[3], "sizes").astype(np.int64).tolist()
    elif len(ins) > 2 and ins[2] is not None:
        scales = ctx.const(node, ins[2], "scales").astype(np.float64)
        if scales.size:
            sizes = [int(math.floor(s * d)) for s, d in zip(scales, shp)]
    if sizes is None:
        raise UnsupportedOnnxOp("Resize without scales/sizes")
    mode = _attr_str(node, "mode", "nearest")
    method = {"nearest": "nearest", "linear": "linear", "cubic": "cubic"}[mode]
    # jax.image.resize, axis by axis over the axes whose size changes
    x = ctx.tx.tt(x)
    for d, (m, n) in enumerate(zip(shp, sizes)):
        if m == n:
            continue
        if method == "nearest":
            off = (torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * m / n
            x = x.index_select(d, torch.floor(off).long())
        else:
            wm = _resize_weights(m, n, method, x.device).to(x.dtype)
            with no_tf32():
                x = torch.movedim(torch.tensordot(x, wm, dims=([d], [0])), -1, d)
    return [x]


# ------------------------------------------------------------- control flow

@_op("If")
def _if(ctx, node, ins):
    (cond,) = ins
    then_g = node.attrs.get("then_branch")
    else_g = node.attrs.get("else_branch")
    if _is_const(cond):
        taken = bool(_np(cond).reshape(-1)[0])
        return _run_graph(then_g if taken else else_g, _Ctx({}, parent=ctx))
    # a device condition: read it and run the branch taken (JAX lowers the
    # pair to lax.cond); outputs are device tensors, as lax.cond's are
    taken = bool(cond.reshape(-1)[0].item())
    outs = _run_graph(then_g if taken else else_g, _Ctx({}, parent=ctx))
    return [ctx.tx.tt(o) for o in outs]


@_op("Loop")
def _loop(ctx, node, ins):
    trip = ins[0]
    cond = ins[1]
    carried = list(ins[2:])
    body: OnnxGraph = node.attrs.get("body")
    if trip is None or not _is_const(trip):
        raise UnsupportedOnnxOp("Loop with non-constant trip count")
    M = int(_np(trip).item())
    cond_val = True if cond is None else bool(_np(cond).reshape(-1)[0]) \
        if _is_const(cond) else None
    if cond_val is None:
        raise UnsupportedOnnxOp("Loop with traced initial condition")
    n_carry = len(carried)
    body_inputs = body.input_names  # iter_num, cond, carried...
    scan_outs: List[List[Any]] = [[] for _ in
                                  range(len(body.output_names) - 1 - n_carry)]
    it = 0
    while it < M and cond_val:
        sub = _Ctx({}, parent=ctx)
        sub.env[body_inputs[0]] = np.asarray(it, np.int64)
        sub.env[body_inputs[1]] = np.asarray(cond_val)
        for name, v in zip(body_inputs[2:], carried):
            sub.env[name] = v
        outs = _run_graph(body, sub)
        cond_out = outs[0]
        if not _is_const(cond_out):
            raise UnsupportedOnnxOp("Loop with traced continuation condition")
        cond_val = bool(_np(cond_out).reshape(-1)[0])
        carried = list(outs[1: 1 + n_carry])
        for i, so in enumerate(outs[1 + n_carry:]):
            scan_outs[i].append(so)
        it += 1
    result = carried
    for col in scan_outs:
        result.append(torch.stack([ctx.tx.tt(v) for v in col], dim=0) if col
                      else np.zeros((0,), np.float32))
    return result


# ---------------------------------------------------------------- execution

def _run_graph(graph: OnnxGraph, ctx: _Ctx) -> List[Any]:
    for name, arr in graph.initializers.items():
        if name not in ctx.env:
            ctx.env[name] = arr
    for node in graph.nodes:
        handler = _HANDLERS.get(node.op_type)
        if handler is None:
            raise UnsupportedOnnxOp(
                f"op '{node.op_type}' (node '{node.name}') is not "
                f"implemented; supported: {sorted(_HANDLERS)}")
        ins = ctx.inputs(node)
        outs = handler(ctx, node, ins)
        for oname, val in zip(node.outputs, outs):
            if oname:
                ctx.env[oname] = val
    return [ctx.lookup(n) for n in graph.output_names]


# Input slots whose value must be a constant because it drives static
# shapes or other decisions made on the host (mirrors each handler's
# ctx.const() calls above).
_CONST_SLOTS = {
    ("Reshape", 1), ("Expand", 1), ("Tile", 1), ("ConstantOfShape", 0),
    ("Slice", 1), ("Slice", 2), ("Slice", 3), ("Slice", 4),
    ("Resize", 2), ("Resize", 3),
    ("Range", 0), ("Range", 1), ("Range", 2),
    ("Pad", 1), ("Pad", 3),
    ("Unsqueeze", 1), ("Squeeze", 1), ("Split", 1),
    ("TopK", 1), ("CumSum", 1), ("OneHot", 1), ("OneHot", 2),
    ("Trilu", 1), ("STFT", 1), ("STFT", 3),
    ("Loop", 0), ("Loop", 1),
} | {
    (op, 1) for op in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin",
                       "ReduceProd", "ReduceL2", "ReduceLogSumExp")
}


def _const_demanded(graph: OnnxGraph, out: set) -> None:
    for node in graph.nodes:
        for i, name in enumerate(node.inputs):
            if name and (node.op_type, i) in _CONST_SLOTS:
                out.add(name)
        for v in node.attrs.values():
            if isinstance(v, OnnxGraph):
                _const_demanded(v, out)
            elif isinstance(v, list):
                for g in v:
                    if isinstance(g, OnnxGraph):
                        _const_demanded(g, out)


def split_params(graph: OnnxGraph) -> Tuple[Dict[str, np.ndarray],
                                            Dict[str, np.ndarray]]:
    """Initializers -> (params, baked constants), classified by usage.

    Floating and quantized (int8 / uint8) weight tensors become reloadable
    params, UNLESS some node consumes them in a shape-driving input slot
    (Reshape shapes, Slice bounds, Resize scales, ...), in which case they
    stay numpy to keep shapes static. Integer tensors always stay numpy:
    they are shape / index vectors in these graphs.
    """
    demanded: set = set()
    _const_demanded(graph, demanded)
    params: Dict[str, np.ndarray] = {}
    consts: Dict[str, np.ndarray] = {}
    for name, arr in graph.initializers.items():
        floaty = np.issubdtype(arr.dtype, np.floating)
        quanty = arr.dtype in (np.int8, np.uint8)
        if (floaty or quanty) and name not in demanded:
            params[name] = arr
        else:
            consts[name] = arr
    return params, consts


class OnnxModel:
    """A loaded ONNX graph, run by torch on ``device``.

    >>> m = OnnxModel("model.onnx")               # on the card
    >>> outs = m(x=feats, x_length=lens)           # dict name -> tensor

    ``device`` defaults to the first CUDA device and raises without one
    (engine/runtime.resolve_device); the CPU runs only when asked for.
    ``m.params`` is the reloadable weight dict (name -> tensor on the
    device), moved there once at load; pass ``params=`` to __call__ to run
    with swapped weights (same shapes). ``bake_params=True`` keeps every
    initializer a numpy constant, so the whole graph may fold on the host.
    Feeds may be numpy arrays or tensors; they move to the device.
    """

    def __init__(self, model: object, bake_params: bool = False, device=None):
        from ..engine.runtime import resolve_device

        self.device = resolve_device(device)
        self.graph = (model if isinstance(model, OnnxGraph)
                      else load_onnx_graph(str(model)))
        if bake_params:
            host, self._consts = {}, dict(self.graph.initializers)
        else:
            host, self._consts = split_params(self.graph)
        tx = _TorchNP(self.device)
        self.params: Dict[str, torch.Tensor] = {k: tx.t(v) for k, v in host.items()}
        self.input_names = self.graph.input_names
        self.output_names = self.graph.output_names

    def raw_fn(self, params: Dict[str, Any], feeds: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The (params, feeds) -> {name: tensor} function the engine's
        stages call; feeds are taken as given (device tensors)."""
        env: Dict[str, Any] = dict(self._consts)
        env.update(params)
        env.update(feeds)
        ctx = _Ctx(env, device=self.device)
        outs = _run_graph(self.graph, ctx)
        return {n: ctx.tx.tt(o) for n, o in zip(self.graph.output_names, outs)}

    def __call__(self, params: Optional[Dict[str, Any]] = None, **feeds):
        missing = [n for n in self.input_names if n not in feeds]
        if missing:
            raise TypeError(f"missing graph inputs: {missing} "
                            f"(expected {self.input_names})")
        extra = [n for n in feeds if n not in self.input_names]
        if extra:
            raise TypeError(f"unknown graph inputs: {extra} "
                            f"(expected {self.input_names})")
        tx = _TorchNP(self.device)
        dev_feeds = {k: tx.tt(v) for k, v in feeds.items()}
        with torch.inference_mode():
            return self.raw_fn(self.params if params is None else params, dev_feeds)

    def describe(self) -> str:
        """Human-readable IO + op census (for `convert_models --probe`)."""
        from collections import Counter
        census = Counter(n.op_type for n in self.graph.nodes)
        lines = [f"graph '{self.graph.name}'"]
        for vi in self.graph.inputs:
            if vi.name not in self.graph.initializers:
                lines.append(f"  in  {vi.name}: "
                             f"{np.dtype(vi.dtype).name if vi.dtype else '?'}"
                             f"{list(vi.shape)}")
        for vi in self.graph.outputs:
            lines.append(f"  out {vi.name}: "
                         f"{np.dtype(vi.dtype).name if vi.dtype else '?'}"
                         f"{list(vi.shape)}")
        lines.append(f"  params: {len(self.params)} tensors, "
                     f"{sum(v.numel() for v in self.params.values()):,} elems")
        lines.append("  ops: " + ", ".join(
            f"{k}×{v}" for k, v in sorted(census.items())))
        unsup = sorted({n.op_type for n in self.graph.nodes}
                       - set(_HANDLERS))
        if unsup:
            lines.append(f"  UNSUPPORTED: {', '.join(unsup)}")
        return "\n".join(lines)


def supported_ops() -> List[str]:
    return sorted(_HANDLERS)
