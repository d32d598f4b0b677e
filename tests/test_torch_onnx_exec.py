"""The port's ONNX executor (audio_classification_tpu_torch/convert/
onnx_exec) against the JAX package's (models/convert/onnx_exec, jitted: the
serving configuration) on the same graphs and feeds.

Every op of ``supported_ops()`` runs in at least one case below, grouped as
tests/test_onnx_exec.py groups them: elementwise and broadcasting, shape
chains, gather / scatter, pads, reductions, linear algebra and the integer
products, quantization, convs and pools, norms, recurrences, signal ops and
control flow. Float outputs agree within 1e-5 of their max, integer outputs
exactly (JAX runs 32-bit ints, the port keeps torch's int64 for indices:
values are compared). Graphs come from tests/helpers_onnx; feeds from a
seeded numpy generator.
"""
import numpy as np
import pytest

from audio_classification_tpu.models.convert import onnx_exec as jax_exec
from audio_classification_tpu_torch.convert import onnx_exec as port_exec
from helpers_onnx import GraphBuilder, Subgraph, graph_bytes, model_bytes, node, value_info

F32 = np.float32


def _rng(seed=0):
    return np.random.default_rng(seed)


def _single(op, inputs, feeds, n_out=1, init=None, out_names=None, **attrs):
    """One node over declared inputs -> (bytes, feeds)."""
    outs = out_names or [f"y{i}" for i in range(n_out)]
    nodes = [node(op, inputs, outs, name=op, **attrs)]
    decl = [value_info(k, v.dtype, list(v.shape)) for k, v in feeds.items()]
    return model_bytes(nodes, init or {}, decl, [value_info(o, F32, []) for o in outs]), feeds


def _chain(nodes, feeds, outs, init=None):
    decl = [value_info(k, v.dtype, list(v.shape)) for k, v in feeds.items()]
    return model_bytes(nodes, init or {}, decl, [value_info(o, F32, []) for o in outs]), feeds


def _x(*shape, seed=0, lo=None):
    a = _rng(seed).standard_normal(shape).astype(F32)
    return np.abs(a) + lo if lo is not None else a


def _u8(*shape, seed=0):
    return _rng(seed).integers(0, 255, shape, dtype=np.uint8)


def _s8(*shape, seed=0, lo=-127, hi=127):
    return _rng(seed).integers(lo, hi, shape, dtype=np.int8)


CASES = {}


def case(group, name):
    def deco(fn):
        CASES[f"{group}-{name}"] = fn
        return fn
    return deco


# ------------------------------------------------------------ elementwise
_POSITIVE = {"Log", "Sqrt"}
for _op in ("Relu", "Sigmoid", "Tanh", "Exp", "Log", "Sqrt", "Neg", "Abs", "Floor",
            "Ceil", "Round", "Reciprocal", "Sign", "Sin", "Cos", "Erf", "Softplus",
            "Elu", "HardSigmoid", "HardSwish", "LeakyRelu", "Softmax", "LogSoftmax"):
    case("elementwise", _op)(
        lambda op=_op: _single(op, ["x"], {"x": _x(2, 3, 5, lo=0.1 if op in _POSITIVE else None)
                                           * (2.0 if op in ("Round",) else 1.0)}))

case("elementwise", "Not")(lambda: _single("Not", ["x"], {"x": _x(3, 4) > 0}))
case("elementwise", "Gelu-erf")(lambda: _single("Gelu", ["x"], {"x": _x(3, 7)}))
case("elementwise", "Gelu-tanh")(lambda: _single("Gelu", ["x"], {"x": _x(3, 7)},
                                                 approximate="tanh"))
for _op in ("Add", "Sub", "Mul", "Div", "Pow"):
    case("elementwise", _op)(lambda op=_op: _single(
        op, ["x", "y"], {"x": _x(2, 3, 4, lo=0.5), "y": _x(4, seed=1, lo=0.5)}))
case("elementwise", "Div-int")(lambda: _single(
    "Div", ["x", "y"], {"x": np.arange(1, 13, dtype=np.int32).reshape(3, 4),
                        "y": np.full((4,), 3, np.int32)}))
case("elementwise", "Mod")(lambda: _single("Mod", ["x", "y"], {
    "x": np.arange(-6, 6, dtype=np.int32), "y": np.full((12,), 4, np.int32)}))
case("elementwise", "Mod-fmod")(lambda: _single("Mod", ["x", "y"], {
    "x": _x(12), "y": np.full((12,), 0.7, F32)}, fmod=1))
for _op in ("Min", "Max", "Sum", "Mean"):
    case("elementwise", _op)(lambda op=_op: _single(
        op, ["a", "b", "c"], {"a": _x(2, 4), "b": _x(4, seed=1), "c": _x(2, 1, seed=2)}))
for _op in ("Equal", "Greater", "GreaterOrEqual", "Less", "LessOrEqual"):
    case("elementwise", _op)(lambda op=_op: _single(op, ["a", "b"], {
        "a": np.round(_x(3, 4)), "b": np.round(_x(4, seed=1))}))
for _op in ("And", "Or", "Xor"):
    case("elementwise", _op)(lambda op=_op: _single(op, ["a", "b"], {
        "a": _x(3, 4) > 0, "b": _x(3, 4, seed=1) > 0}))
case("elementwise", "Where")(lambda: _single("Where", ["c", "a", "b"], {
    "c": _x(3, 4) > 0, "a": _x(3, 4, seed=1), "b": _x(4, seed=2)}))
case("elementwise", "Clip")(lambda: _single("Clip", ["x", "lo", "hi"], {"x": _x(3, 5)},
                                            init={"lo": np.float32(-0.5),
                                                  "hi": np.float32(0.7)}))
case("elementwise", "PRelu")(lambda: _single("PRelu", ["x", "s"], {"x": _x(2, 3, 6)},
                                             init={"s": _x(3, seed=4)}))
case("elementwise", "Cast")(lambda: _single("Cast", ["x"], {"x": _x(3, 4) * 5}, to=6))
case("elementwise", "Identity")(lambda: _single("Identity", ["x"], {"x": _x(3)}))
case("elementwise", "CastLike")(lambda: _single("CastLike", ["x", "l"], {
    "x": _x(3, 4) * 5, "l": np.zeros(2, np.int32)}))
case("elementwise", "Dropout")(lambda: _single("Dropout", ["x"], {"x": _x(3, 4)}, n_out=2))


# ------------------------------------------------------------- shape chains
@case("shapes", "Shape-Size-Reshape")
def _shape_chain():
    init = {"i0": np.array([0], np.int64), "m1": np.array([-1], np.int64)}
    return _chain([node("Shape", ["x"], ["shp"]), node("Gather", ["shp", "i0"], ["d0"], axis=0),
                   node("Concat", ["d0", "m1"], ["tgt"], axis=0),
                   node("Reshape", ["x", "tgt"], ["y"]), node("Size", ["x"], ["n"])],
                  {"x": _x(3, 4, 5)}, ["y", "n", "shp"], init)


case("shapes", "Transpose")(lambda: _single("Transpose", ["x"], {"x": _x(2, 3, 4)},
                                            perm=[2, 0, 1]))
case("shapes", "Concat")(lambda: _single("Concat", ["a", "b"], {"a": _x(2, 3),
                                                                "b": _x(2, 5, seed=1)}, axis=1))
case("shapes", "Split")(lambda: _single("Split", ["x"], {"x": _x(2, 7)}, n_out=3, axis=1))
case("shapes", "Split-sizes")(lambda: _single("Split", ["x", "s"], {"x": _x(6, 2)}, n_out=2,
                                              init={"s": np.array([2, 4], np.int64)}))


@case("shapes", "Slice")
def _slice_case():
    init = {"s": np.array([1, -1], np.int64), "e": np.array([2 ** 62, -(2 ** 62)], np.int64),
            "a": np.array([1, 0], np.int64), "st": np.array([2, -1], np.int64)}
    return _single("Slice", ["x", "s", "e", "a", "st"], {"x": _x(4, 10)}, init=init)


case("shapes", "Squeeze-Unsqueeze")(lambda: _chain(
    [node("Unsqueeze", ["x", "a"], ["u"]), node("Squeeze", ["u", "a"], ["y"]),
     node("Squeeze", ["u"], ["z"])], {"x": _x(3, 4)}, ["u", "y", "z"],
    {"a": np.array([0, -1], np.int64)}))
case("shapes", "Flatten")(lambda: _single("Flatten", ["x"], {"x": _x(2, 3, 4)}, axis=2))
case("shapes", "Expand")(lambda: _single("Expand", ["x", "s"], {"x": _x(3, 1)},
                                         init={"s": np.array([2, 3, 4], np.int64)}))
case("shapes", "Tile")(lambda: _single("Tile", ["x", "r"], {"x": _x(2, 3)},
                                       init={"r": np.array([2, 3], np.int64)}))


@case("shapes", "Constant-ConstantOfShape-Range")
def _const_case():
    return _chain([node("Constant", [], ["c"], value=np.arange(4, dtype=F32)),
                   node("ConstantOfShape", ["shp"], ["z"], value=np.array([2.5], F32)),
                   node("Range", ["r0", "r1", "r2"], ["r"]),
                   node("Add", ["x", "c"], ["y"])],
                  {"x": _x(3, 4)}, ["y", "z", "r"],
                  {"shp": np.array([2, 3], np.int64), "r0": np.array(1, np.int64),
                   "r1": np.array(9, np.int64), "r2": np.array(3, np.int64)})


case("shapes", "OneHot")(lambda: _single("OneHot", ["i", "d", "v"], {
    "i": np.array([[0, 3], [2, 1]], np.int64)},
    init={"d": np.array(4, np.int64), "v": np.array([-1.0, 2.0], F32)}, axis=1))
case("shapes", "Trilu")(lambda: _single("Trilu", ["x", "k"], {"x": _x(4, 5)},
                                        init={"k": np.array(1, np.int64)}, upper=0))


# ---------------------------------------------------------- gather / scatter
case("gather", "Gather")(lambda: _single("Gather", ["x", "i"], {
    "x": _x(5, 6), "i": np.array([[-1, 0], [2, 4]], np.int64)}, axis=1))
case("gather", "GatherElements")(lambda: _single("GatherElements", ["x", "i"], {
    "x": _x(3, 4), "i": np.array([[0, 3], [1, 2], [-1, 0]], np.int64)}, axis=1))
case("gather", "GatherND")(lambda: _single("GatherND", ["x", "i"], {
    "x": _x(4, 5, 6), "i": np.array([[1, 2], [3, 0], [0, 4]], np.int64)}))
case("gather", "GatherND-batch")(lambda: _single("GatherND", ["x", "i"], {
    "x": _x(2, 5, 3), "i": np.array([[[1], [4]], [[0], [2]]], np.int64)}, batch_dims=1))
case("gather", "ScatterND")(lambda: _single("ScatterND", ["x", "i", "u"], {
    "x": _x(5, 3), "i": np.array([[1], [3]], np.int64), "u": _x(2, 3, seed=1)}))
case("gather", "ScatterND-add")(lambda: _single("ScatterND", ["x", "i", "u"], {
    "x": _x(5, 3), "i": np.array([[1], [1]], np.int64), "u": _x(2, 3, seed=1)},
    reduction="add"))
case("gather", "ReverseSequence")(lambda: _single("ReverseSequence", ["x", "l"], {
    "x": _x(3, 7, 2), "l": np.array([7, 4, 1], np.int64)}, batch_axis=0, time_axis=1))
case("gather", "ReverseSequence-time-major")(lambda: _single("ReverseSequence", ["x", "l"], {
    "x": _x(7, 3, 2), "l": np.array([7, 4, 1], np.int64)}))


# --------------------------------------------------------------------- pads
for _mode in ("constant", "reflect", "edge", "wrap"):
    case("pads", f"Pad-{_mode}")(lambda m=_mode: _single(
        "Pad", ["x", "p"], {"x": _x(2, 3, 6)},
        init={"p": np.array([0, 1, 2, 0, 2, 3], np.int64)}, mode=m))
case("pads", "Pad-value-axes")(lambda: _single("Pad", ["x", "p", "v", "a"], {"x": _x(3, 4)},
                                               init={"p": np.array([1, 2], np.int64),
                                                     "v": np.array(1.5, F32),
                                                     "a": np.array([1], np.int64)}))


# --------------------------------------------------------------- reductions
for _op in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd", "ReduceL2",
            "ReduceLogSumExp"):
    case("reduce", _op)(lambda op=_op: _single(op, ["x"], {"x": _x(3, 4, 5)}, axes=[1, 2],
                                               keepdims=0))
case("reduce", "ReduceSum-axes-input")(lambda: _single(
    "ReduceSum", ["x", "a"], {"x": _x(3, 4, 5)}, init={"a": np.array([1], np.int64)}))
for _op in ("ArgMax", "ArgMin"):
    case("reduce", _op)(lambda op=_op: _single(op, ["x"], {"x": _x(3, 4, 5)}, axis=1))
case("reduce", "CumSum")(lambda: _single("CumSum", ["x", "a"], {"x": _x(3, 5)},
                                         init={"a": np.array(1, np.int64)}))
case("reduce", "TopK")(lambda: _single("TopK", ["x", "k"], {"x": _x(3, 8)}, n_out=2,
                                       init={"k": np.array([3], np.int64)}))
case("reduce", "TopK-axis0")(lambda: _single("TopK", ["x", "k"], {"x": _x(6, 3)}, n_out=2,
                                             init={"k": np.array([2], np.int64)}, axis=0))


# ----------------------------------------------------------- linear algebra
case("linear", "MatMul")(lambda: _single("MatMul", ["x", "w"], {"x": _x(2, 5, 12)},
                                         init={"w": _x(12, 7, seed=1)}))
case("linear", "Gemm")(lambda: _single("Gemm", ["x", "w", "b"], {"x": _x(6, 4)},
                                       init={"w": _x(5, 6, seed=1), "b": _x(5, seed=2)},
                                       transA=1, transB=1, alpha=0.5, beta=2.0))
case("linear", "Einsum")(lambda: _single("Einsum", ["a", "b"], {"a": _x(2, 3, 4),
                                                                "b": _x(2, 4, 5, seed=1)},
                                         equation="bij,bjk->bik"))


for _adt in (np.uint8, np.int8):
    @case("intmm", f"MatMulInteger-{np.dtype(_adt).name}")
    def _mmi(adt=_adt):
        lo, hi = (0, 255) if adt == np.uint8 else (-127, 127)
        a = _rng(3).integers(lo, hi, (2, 5, 12), dtype=adt)
        return _single("MatMulInteger", ["x", "w", "azp", "bzp"], {"x": a},
                       init={"w": _s8(12, 7), "azp": np.asarray(131 if adt == np.uint8 else -9,
                                                                adt),
                             "bzp": np.asarray(3, np.int8)})


case("intmm", "MatMulInteger-per-column")(lambda: _single(
    "MatMulInteger", ["x", "w", "azp", "bzp"], {"x": _u8(4, 10)},
    init={"w": _s8(10, 6), "azp": np.asarray(77, np.uint8),
          "bzp": _rng(5).integers(-8, 8, 6).astype(np.int8)}))
case("intmm", "MatMulInteger-per-row-a")(lambda: _single(
    "MatMulInteger", ["x", "w", "azp"], {"x": _u8(4, 10)},
    init={"w": _s8(10, 6), "azp": _rng(6).integers(0, 255, (4, 1)).astype(np.uint8)}))
case("intmm", "MatMulInteger-K512")(lambda: _single(
    "MatMulInteger", ["x", "w", "azp", "bzp"], {"x": _u8(3, 512)},
    init={"w": _s8(512, 16), "azp": np.asarray(0, np.uint8), "bzp": np.asarray(0, np.int8)}))
case("intmm", "QLinearMatMul")(lambda: _single(
    "QLinearMatMul", ["x", "as", "azp", "w", "ws", "wzp", "ys", "yzp"], {"x": _u8(3, 8)},
    init={"as": np.float32(0.02), "azp": np.uint8(120), "w": _s8(8, 5),
          "ws": np.float32(0.1), "wzp": np.int8(4), "ys": np.float32(0.05),
          "yzp": np.uint8(128)}))
for _q in (True, False):
    @case("intmm", f"QGemm-{'quantized' if _q else 'float'}")
    def _qgemm(q=_q):
        init = {"as": np.float32(0.02), "az": np.uint8(99), "w": _s8(4, 6),
                "ws": np.float32(0.07), "wz": np.int8(2),
                "bias": _rng(7).integers(-500, 500, 4).astype(np.int32)}
        if q:
            init.update(ys=np.float32(0.2), yz=np.uint8(128))
        return _single("QGemm", ["x"] + list(init), {"x": _u8(3, 6)}, init=init, transB=1,
                       alpha=1.0)


# ------------------------------------------------------------- quantization
case("quant", "DequantizeLinear-axis")(lambda: _single(
    "DequantizeLinear", ["x", "s", "z"], {"x": _s8(4, 6)},
    init={"s": _x(4, lo=0.01), "z": _rng(8).integers(-10, 10, 4).astype(np.int8)}, axis=0))
case("quant", "QuantizeLinear")(lambda: _single("QuantizeLinear", ["x", "s", "z"],
                                                {"x": _x(3, 9) * 3},
                                                init={"s": np.float32(0.02),
                                                      "z": np.uint8(128)}))
case("quant", "DynamicQuantizeLinear")(lambda: _single("DynamicQuantizeLinear", ["x"],
                                                       {"x": _x(5, 12)}, n_out=3))


@case("quant", "dynamic-int8-linear")
def _dyn_linear():
    return _chain([node("DynamicQuantizeLinear", ["x"], ["xq", "xs", "xzp"]),
                   node("MatMulInteger", ["xq", "w", "xzp", "wzp"], ["mi"]),
                   node("Cast", ["mi"], ["mf"], to=1), node("Mul", ["mf", "xs"], ["m1"]),
                   node("Mul", ["m1", "ws"], ["y"])],
                  {"x": _x(2, 5, 12)}, ["y", "mi"],
                  {"w": _s8(12, 7), "wzp": np.zeros((), np.int8), "ws": np.float32(0.05)})


_QADD = {"as": np.float32(0.02), "az": np.uint8(10), "c": _u8(2, 9, seed=2),
         "cs": np.float32(0.03), "cz": np.uint8(20), "ys": np.float32(0.05), "yz": np.uint8(7)}
for _op in ("QLinearAdd", "QLinearMul"):
    case("quant", _op)(lambda op=_op: _single(op, ["x"] + list(_QADD), {"x": _u8(2, 9)},
                                              init=dict(_QADD)))
_QUN = {"xs": np.float32(1 / 32), "xz": np.uint8(128), "ys": np.float32(1 / 256),
        "yz": np.uint8(0)}
for _op in ("QLinearSigmoid", "QLinearLeakyRelu", "QLinearGlobalAveragePool"):
    case("quant", _op)(lambda op=_op: _single(op, ["x"] + list(_QUN), {"x": _u8(1, 3, 10)},
                                              init=dict(_QUN)))


# ---------------------------------------------------------- convs and pools
for _s, _d, _g in ((1, 1, 1), (2, 2, 1), (1, 1, 2)):
    case("conv", f"Conv1d-s{_s}-d{_d}-g{_g}")(lambda s=_s, d=_d, g=_g: _single(
        "Conv", ["x", "w", "b"], {"x": _x(2, 4, 21)},
        init={"w": _x(6, 4 // g, 5, seed=1), "b": _x(6, seed=2)},
        strides=[s], pads=[2, 2], dilations=[d], group=g))
case("conv", "Conv2d-same-upper")(lambda: _single(
    "Conv", ["x", "w", "b"], {"x": _x(1, 3, 13, 9)},
    init={"w": _x(5, 3, 3, 3, seed=1), "b": _x(5, seed=2)}, strides=[2, 2],
    auto_pad="SAME_UPPER"))
case("conv", "ConvTranspose")(lambda: _single(
    "ConvTranspose", ["x", "w", "b"], {"x": _x(2, 6, 10)},
    init={"w": _x(6, 4, 5, seed=1), "b": _x(4, seed=2)}, strides=[3], pads=[2, 2],
    output_padding=[1]))
case("conv", "ConvTranspose-outpad")(lambda: _single(
    "ConvTranspose", ["x", "w"], {"x": _x(1, 3, 6)}, init={"w": _x(3, 2, 4, seed=1)},
    strides=[2], pads=[0, 0], output_padding=[1]))
case("conv", "ConvInteger")(lambda: _single(
    "ConvInteger", ["x", "w", "xzp", "wzp"], {"x": _u8(2, 3, 17)},
    init={"w": _s8(5, 3, 4), "xzp": np.uint8(101),
          "wzp": _rng(9).integers(-6, 6, 5).astype(np.int8)}, strides=[2], pads=[1, 1]))
case("conv", "QLinearConv")(lambda: _single(
    "QLinearConv", ["x", "xs", "xzp", "w", "ws", "wzp", "ys", "yzp", "bias"],
    {"x": _u8(1, 2, 15)},
    init={"xs": np.float32(0.04), "xzp": np.uint8(114), "w": _s8(4, 2, 3),
          "ws": _x(4, lo=0.01) * 0.05, "wzp": np.zeros(4, np.int8), "ys": np.float32(0.1),
          "yzp": np.uint8(128), "bias": _rng(10).integers(-2000, 2000, 4).astype(np.int32)},
    pads=[1, 1]))
for _c in (0, 1):
    case("conv", f"MaxPool-ceil{_c}")(lambda c=_c: _single(
        "MaxPool", ["x"], {"x": _x(2, 3, 17)}, kernel_shape=[4], strides=[3], pads=[1, 1],
        ceil_mode=c))
    case("conv", f"AveragePool-pad{_c}")(lambda c=_c: _single(
        "AveragePool", ["x"], {"x": _x(2, 3, 16)}, kernel_shape=[4], strides=[2],
        pads=[1, 1], count_include_pad=c))
case("conv", "MaxPool2d-dilated")(lambda: _single(
    "MaxPool", ["x"], {"x": _x(1, 2, 9, 8)}, kernel_shape=[2, 3], strides=[2, 1],
    dilations=[2, 1]))
for _op in ("GlobalAveragePool", "GlobalMaxPool"):
    case("conv", _op)(lambda op=_op: _single(op, ["x"], {"x": _x(2, 5, 7, 3)}))


# -------------------------------------------------------------------- norms
case("norm", "BatchNormalization")(lambda: _single(
    "BatchNormalization", ["x", "s", "b", "m", "v"], {"x": _x(2, 5, 9)},
    init={"s": _x(5, seed=1), "b": _x(5, seed=2), "m": _x(5, seed=3),
          "v": _x(5, seed=4, lo=0.5)}))
case("norm", "LayerNormalization")(lambda: _single(
    "LayerNormalization", ["x", "s", "b"], {"x": _x(2, 7, 12)},
    init={"s": _x(12, seed=1), "b": _x(12, seed=2)}))
case("norm", "InstanceNormalization")(lambda: _single(
    "InstanceNormalization", ["x", "s", "b"], {"x": _x(2, 4, 11)},
    init={"s": _x(4, seed=1), "b": _x(4, seed=2)}))
for _p in (1, 2):
    case("norm", f"LpNormalization-p{_p}")(lambda p=_p: _single(
        "LpNormalization", ["x"], {"x": _x(3, 6)}, p=p))


# ------------------------------------------------------------- recurrences
def _rnn(op, gates, bidir, lens=None, **attrs):
    T, B, I, H = 6, 3, 4, 5
    D = 2 if bidir else 1
    init = {"w": _x(D, gates * H, I, seed=1) * 0.5, "r": _x(D, gates * H, H, seed=2) * 0.5,
            "b": _x(D, 2 * gates * H, seed=3) * 0.5}
    ins = ["x", "w", "r", "b"]
    if lens is not None:
        init["lens"] = lens
        ins.append("lens")
    else:
        ins.append("")
    init["h0"] = _x(D, B, H, seed=4)
    ins.append("h0")
    if op == "LSTM":
        init["c0"] = _x(D, B, H, seed=5)
        ins.append("c0")
    n_out = 3 if op == "LSTM" else 2
    return _single(op, ins, {"x": _x(T, B, I)}, n_out=n_out, init=init, hidden_size=H,
                   direction="bidirectional" if bidir else "forward", **attrs)


case("rnn", "LSTM-forward-lens")(lambda: _rnn("LSTM", 4, False,
                                              lens=np.array([6, 3, 1], np.int32)))
case("rnn", "LSTM-bidirectional")(lambda: _rnn("LSTM", 4, True))
case("rnn", "GRU-lbr1")(lambda: _rnn("GRU", 3, False, linear_before_reset=1))
case("rnn", "GRU-bidirectional-lbr0")(lambda: _rnn("GRU", 3, True))


# ------------------------------------------------------------------- signal
case("signal", "STFT")(lambda: _single("STFT", ["x", "fs", "w"], {"x": _x(2, 64)},
                                       init={"fs": np.array(8, np.int64),
                                             "w": np.hanning(16).astype(F32)}, onesided=1))
for _mode, _size in (("nearest", [1, 2, 9, 5]), ("linear", [1, 2, 9, 5]),
                     ("linear", [1, 2, 3, 2]), ("cubic", [1, 2, 8, 12])):
    case("signal", f"Resize-{_mode}-{'x'.join(map(str, _size))}")(
        lambda m=_mode, s=_size: _single("Resize", ["x", "", "", "sz"], {"x": _x(1, 2, 6, 4)},
                                         init={"sz": np.array(s, np.int64)}, mode=m))


# -------------------------------------------------------------- control flow
def _branches():
    then_g = graph_bytes([node("Mul", ["x", "x"], ["sq"])], {},
                         outputs=[value_info("sq", F32, [])], name=b"then")
    else_g = graph_bytes([node("Neg", ["x"], ["ng"])], {},
                         outputs=[value_info("ng", F32, [])], name=b"else")
    return Subgraph(then_g), Subgraph(else_g)


@case("control", "If-constant")
def _if_const():
    t, e = _branches()
    return _single("If", ["c"], {"x": _x(3)}, init={"c": np.array(True)}, then_branch=t,
                   else_branch=e)


for _sign in (1, -1):
    @case("control", f"If-device-{'then' if _sign > 0 else 'else'}")
    def _if_dev(sign=_sign):
        t, e = _branches()
        return _chain([node("ReduceSum", ["x"], ["s"], keepdims=0),
                       node("Greater", ["s", "z"], ["c"]),
                       node("If", ["c"], ["y"], then_branch=t, else_branch=e)],
                      {"x": (_x(3, lo=1.0) * sign).astype(F32)}, ["y"],
                      {"z": np.zeros((), F32)})


@case("control", "Loop")
def _loop():
    body = graph_bytes(
        [node("Add", ["acc_in", "x"], ["acc_out"]), node("Identity", ["cond_in"], ["cond_out"]),
         node("Identity", ["acc_out"], ["scan0"])], {},
        inputs=[value_info("it", np.int64, []), value_info("cond_in", np.bool_, []),
                value_info("acc_in", F32, [])],
        outputs=[value_info("cond_out", np.bool_, []), value_info("acc_out", F32, []),
                 value_info("scan0", F32, [])], name=b"body")
    return _single("Loop", ["M", "c", "acc0"], {"x": _x(2)}, n_out=2,
                   init={"M": np.array(4, np.int64), "c": np.array(True),
                         "acc0": np.zeros((2,), F32)}, body=Subgraph(body))


# --------------------------------------------------------------------- runs
def _outputs(tmp_path, case_fn):
    blob, feeds = case_fn()
    path = tmp_path / "m.onnx"
    path.write_bytes(blob)
    ref = jax_exec.OnnxModel(str(path), jit=True)(**feeds)
    got = port_exec.OnnxModel(str(path), device="cpu")(**feeds)
    return {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_executor_matches_jax(tmp_path, name):
    ref, got = _outputs(tmp_path, CASES[name])
    assert set(ref) == set(got)
    for k in ref:
        r, g = ref[k], got[k]
        assert r.shape == g.shape, (k, r.shape, g.shape)
        if np.issubdtype(r.dtype, np.floating):
            assert np.issubdtype(g.dtype, np.floating), (k, g.dtype)
            tol = 1e-5 * max(1.0, float(np.max(np.abs(r))) if r.size else 1.0)
            np.testing.assert_allclose(g, r, rtol=0, atol=tol, err_msg=k)
        else:
            assert not np.issubdtype(g.dtype, np.floating), (k, g.dtype)
            np.testing.assert_array_equal(g, r, err_msg=k)


def test_every_supported_op_has_a_case(tmp_path):
    assert port_exec.supported_ops() == jax_exec.supported_ops()
    seen = set()
    for i, fn in enumerate(CASES.values()):
        path = tmp_path / f"{i}.onnx"
        path.write_bytes(fn()[0])
        seen |= {n.op_type for n in port_exec.load_onnx_graph(str(path)).nodes}
    assert set(port_exec.supported_ops()) <= seen, sorted(set(port_exec.supported_ops()) - seen)


def test_integer_products_are_exact_int32(tmp_path):
    """K = 1040 int8 x uint8 sums reach 2^25, past float32's 2^24, where
    float32 holds only even integers: the port's MatMulInteger keeps the
    int32 accumulator exact."""
    a = np.full((3, 1040), 255, np.uint8)
    w = np.full((1040, 16), -127, np.int8)
    w[0, 0] = -126
    blob, feeds = _single("MatMulInteger", ["x", "w"], {"x": a}, init={"w": w})
    (tmp_path / "m.onnx").write_bytes(blob)
    got = port_exec.OnnxModel(str(tmp_path / "m.onnx"), device="cpu")(x=a)["y0"]
    assert got.dtype == port_exec.torch.int32
    ref = a.astype(np.int64) @ w.astype(np.int64)
    assert abs(ref).max() > 2 ** 24
    np.testing.assert_array_equal(got.numpy(), ref)


def test_per_row_a_zero_point_of_the_spec_shape(tmp_path):
    """A per-row a zero point of shape [M] (the ONNX spec's) subtracts along
    the rows; the JAX fallback does not broadcast this shape (ROADMAP §3)."""
    a, w = _u8(4, 10), _s8(10, 6)
    azp = _rng(6).integers(0, 255, 4).astype(np.uint8)
    blob, feeds = _single("MatMulInteger", ["x", "w", "azp"], {"x": a},
                          init={"w": w, "azp": azp})
    (tmp_path / "m.onnx").write_bytes(blob)
    got = port_exec.OnnxModel(str(tmp_path / "m.onnx"), device="cpu")(**feeds)["y0"]
    ref = (a.astype(np.int64) - azp.astype(np.int64)[:, None]) @ w.astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), ref)


def _unsupported_graphs():
    sub = graph_bytes([node("Identity", ["cond_in"], ["cond_out"])], {},
                      inputs=[value_info("it", np.int64, []),
                              value_info("cond_in", np.bool_, [])],
                      outputs=[value_info("cond_out", np.bool_, [])], name=b"body")
    return {
        "unknown-op": (_single("TotallyMadeUpOp", ["x"], {"x": _x(2)}), "TotallyMadeUpOp"),
        "device-reshape-shape": (_single("Reshape", ["x", "s"], {
            "x": _x(2, 3), "s": np.array([3, 2], np.int64)}), "must be constant"),
        "device-loop-trip": (_single("Loop", ["M", "c"], {"M": np.array(2, np.int64)},
                                     init={"c": np.array(True)}, body=Subgraph(sub)),
                             "trip count"),
        "cumsum-exclusive": (_single("CumSum", ["x", "a"], {"x": _x(3)},
                                     init={"a": np.array(0, np.int64)}, exclusive=1),
                             "exclusive"),
        "grouped-convtranspose": (_single("ConvTranspose", ["x", "w"], {"x": _x(1, 4, 5)},
                                          init={"w": _x(4, 2, 3)}, group=2), "grouped"),
    }


@pytest.mark.parametrize("name", sorted(_unsupported_graphs()))
def test_unsupported_inputs_raise_in_both(tmp_path, name):
    (blob, feeds), match = _unsupported_graphs()[name]
    (tmp_path / "m.onnx").write_bytes(blob)
    with pytest.raises(jax_exec.UnsupportedOnnxOp, match=match):
        jax_exec.OnnxModel(str(tmp_path / "m.onnx"), jit=True)(**feeds)
    with pytest.raises(port_exec.UnsupportedOnnxOp, match=match):
        port_exec.OnnxModel(str(tmp_path / "m.onnx"), device="cpu")(**feeds)


def test_params_reload_and_api_errors(tmp_path):
    """params= swaps weights; missing / unknown feeds raise TypeError; the
    census names unsupported ops; a card path without a card raises."""
    b = GraphBuilder()
    b.gemm(_x(4, 6), _x(4, seed=1))
    path = b.write(tmp_path / "m.onnx")
    m = port_exec.OnnxModel(path, device="cpu")
    x = _x(3, 6, seed=2)
    base = m(input=x)[b.value].numpy()
    params = dict(m.params)
    bias = [k for k, v in params.items() if tuple(v.shape) == (4,)][0]
    params[bias] = port_exec.torch.zeros(4)
    np.testing.assert_allclose(m(params=params, input=x)[b.value].numpy(),
                               base - m.params[bias].numpy(), atol=1e-5)
    with pytest.raises(TypeError, match="missing graph inputs"):
        m()
    with pytest.raises(TypeError, match="unknown graph inputs"):
        m(input=x, bogus=1)
    assert "Gemm" in m.describe()
    if not port_exec.torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_exec.OnnxModel(path)
