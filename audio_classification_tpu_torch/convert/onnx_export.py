"""ONNX export for the port's models (pure protobuf wire writing): the
port's own copy of audio_classification_tpu/models/convert/onnx_export.py.

The reference consumes its model zoo as ONNX files (SURVEY.md §2.2: sherpa
exports, 3D-Speaker, asteroid re-exports); this module closes the loop in
the OTHER direction: a model trained by the port (cli/train_*) is written
to a standard ONNX file that onnxruntime, or the port's own graph executor
(convert/onnx_exec, ``--onnx-exec direct``), runs. No ``onnx`` package is
needed: ModelProto / GraphProto / NodeProto / TensorProto / AttributeProto
are written directly in protobuf wire format (mirror of the reader in
onnx_import.py; field numbers match the ONNX schema).

The exporters read the flax-layout trees of numpy arrays the JAX exporters
read (``convert/from_jax.state_dict_to_variables`` of a port module, or
``pyannet_state_dict_to_params``), so the same weights give the same bytes
as the JAX package's export, but for the ModelProto's producer name
(``PRODUCER``). The one computed initializer, PyanNet's sinc filter bank,
comes from the port's ``models/pyannet.sinc_filters`` (torch's sin / cos
instead of XLA's).

Design choices:
- opset 17 conventions: Pad/Slice/Unsqueeze carry pads/starts/axes as
  int64 INPUT tensors, ReduceMean keeps `axes` as an attribute.
- NCW layout throughout (ONNX Conv convention); flax kernels
  [K, Cin/g, Cout] transpose to ONNX [Cout, Cin/g, K].
- the time length is baked static (pick `seconds` at export; the batch dim
  stays symbolic "batch"), as the reference's own exports pin feature dims
  while leaving batch free.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

_NP_TO_ONNX = {
    np.dtype(np.float32): 1,
    np.dtype(np.uint8): 2,
    np.dtype(np.int8): 3,
    np.dtype(np.int32): 6,
    np.dtype(np.int64): 7,
    np.dtype(np.bool_): 9,
    np.dtype(np.float64): 11,
}

#: ModelProto.producer_name of every file the port writes
PRODUCER = "audio_classification_tpu_torch"

# attribute type codes (AttributeProto.AttributeType)
_AT_FLOAT, _AT_INT, _AT_STRING, _AT_TENSOR, _AT_INTS = 1, 2, 3, 4, 7


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _ld(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _vi(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _tensor(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    arr = np.ascontiguousarray(arr)
    code = _NP_TO_ONNX[arr.dtype]
    out = b"".join(_vi(1, int(d)) for d in arr.shape)
    out += _vi(2, code)
    out += _ld(8, name.encode())
    out += _ld(9, arr.astype(arr.dtype.newbyteorder("<")).tobytes())
    return out


def _attr(name: str, val) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, ints=8, type=20."""
    out = _ld(1, name.encode())
    if isinstance(val, float):
        out += _key(2, 5) + struct.pack("<f", val) + _vi(20, _AT_FLOAT)
    elif isinstance(val, (bool, int, np.integer)):
        out += _vi(3, int(val) & ((1 << 64) - 1)) + _vi(20, _AT_INT)
    elif isinstance(val, (str, bytes)):
        b = val.encode() if isinstance(val, str) else val
        out += _ld(4, b) + _vi(20, _AT_STRING)
    elif isinstance(val, np.ndarray):
        out += _ld(5, _tensor("", val)) + _vi(20, _AT_TENSOR)
    elif isinstance(val, (list, tuple)):
        packed = b"".join(_varint(int(x) & ((1 << 64) - 1)) for x in val)
        out += _ld(8, packed) + _vi(20, _AT_INTS)
    else:
        raise TypeError(f"unsupported attribute {name}: {type(val)}")
    return out


def _node(op: str, inputs: Sequence[str], outputs: Sequence[str],
          name: str = "", **attrs) -> bytes:
    out = b"".join(_ld(1, i.encode()) for i in inputs)
    out += b"".join(_ld(2, o.encode()) for o in outputs)
    if name:
        out += _ld(3, name.encode())
    out += _ld(4, op.encode())
    out += b"".join(_ld(5, _attr(k, v)) for k, v in attrs.items())
    return out


def _value_info(name: str, dtype, shape: Sequence) -> bytes:
    """ValueInfoProto; str entries in `shape` become symbolic dim_param."""
    code = _NP_TO_ONNX[np.dtype(dtype)]
    dims = b"".join(
        _ld(1, _ld(2, d.encode()) if isinstance(d, str) else _vi(1, int(d)))
        for d in shape)
    tensor_type = _vi(1, code) + _ld(2, dims)
    return _ld(1, name.encode()) + _ld(2, _ld(1, tensor_type))


class OnnxGraphWriter:
    """Accumulates nodes/initializers and serializes one ModelProto."""

    def __init__(self, name: str = PRODUCER):
        self.name = name
        self.nodes: List[bytes] = []
        self.inits: Dict[str, np.ndarray] = {}
        self._n = 0

    def fresh(self, stem: str) -> str:
        self._n += 1
        return f"{stem}_{self._n}"

    def init(self, stem: str, arr: np.ndarray) -> str:
        name = self.fresh(stem)
        self.inits[name] = np.ascontiguousarray(arr)
        return name

    def add(self, op: str, inputs: Sequence[str], out: Optional[str] = None,
            n_out: int = 1, **attrs):
        outs = [out or self.fresh(op.lower())] if n_out == 1 else [
            self.fresh(op.lower()) for _ in range(n_out)]
        self.nodes.append(_node(op, inputs, outs, name=self.fresh(op), **attrs))
        return outs[0] if n_out == 1 else outs

    def serialize(self, inputs: Sequence[tuple], outputs: Sequence[tuple],
                  opset: int = 17, ir_version: int = 8,
                  metadata: Optional[Dict[str, str]] = None,
                  producer: str = PRODUCER) -> bytes:
        """inputs/outputs: [(name, np dtype, shape)] triples."""
        graph = b"".join(_ld(1, n) for n in self.nodes)
        graph += b"".join(_ld(5, _tensor(k, v)) for k, v in self.inits.items())
        graph += _ld(2, self.name.encode())
        graph += b"".join(_ld(11, _value_info(*t)) for t in inputs)
        graph += b"".join(_ld(12, _value_info(*t)) for t in outputs)
        opset_b = _ld(1, b"") + _vi(2, opset)
        out = _vi(1, ir_version) + _ld(2, producer.encode())
        out += _ld(7, graph) + _ld(8, opset_b)
        for k, v in (metadata or {}).items():
            out += _ld(14, _ld(1, k.encode()) + _ld(2, str(v).encode()))
        return out


# ---------------------------------------------------------------- helpers

def _conv_w(kernel: np.ndarray) -> np.ndarray:
    """flax [K, Cin/g, Cout] -> ONNX Conv weight [Cout, Cin/g, K]."""
    return np.ascontiguousarray(np.transpose(np.asarray(kernel, np.float32),
                                             (2, 1, 0)))


def _gln(g: OnnxGraphWriter, x: str, scope: dict, eps: float) -> str:
    """GlobalLayerNorm over (C, T) of an NCW tensor (models/common.py:20-44:
    statistics over time AND channels jointly — Conv-TasNet's gLN)."""
    gamma = np.asarray(scope["gamma"], np.float32).reshape(1, -1, 1)
    beta = np.asarray(scope["beta"], np.float32).reshape(1, -1, 1)
    mean = g.add("ReduceMean", [x], axes=[1, 2], keepdims=1)
    d = g.add("Sub", [x, mean])
    sq = g.add("Mul", [d, d])
    var = g.add("ReduceMean", [sq], axes=[1, 2], keepdims=1)
    ve = g.add("Add", [var, g.init("eps", np.float32(eps).reshape(()))])
    y = g.add("Div", [d, g.add("Sqrt", [ve])])
    y = g.add("Mul", [y, g.init("gamma", gamma)])
    return g.add("Add", [y, g.init("beta", beta)])


def _prelu(g: OnnxGraphWriter, x: str, scope: dict) -> str:
    slope = np.asarray(scope["alpha"], np.float32).reshape(1)
    return g.add("PRelu", [x, g.init("slope", slope)])


def _qdq_act(g: OnnxGraphWriter, x: str, scale: float = 0.05) -> str:
    """ORT static-quant QDQ boundary on an activation: QuantizeLinear ->
    DequantizeLinear (uint8, zero point 128). ``scale`` stands in for the
    calibration range a real ORT quantizer derives from data (scale 0.05 =
    ±6.4 around zero on the uint8 grid)."""
    s = g.init("qs", np.float32(scale).reshape(()))
    zp = g.init("qzp", np.uint8(128).reshape(()))
    xq = g.add("QuantizeLinear", [x, s, zp])
    return g.add("DequantizeLinear", [xq, s, zp])


def _qdq_weight(g: OnnxGraphWriter, w: np.ndarray, axis: int) -> str:
    """Per-channel symmetric int8 weight as int8 initializer +
    DequantizeLinear(axis) — the QDQ graphs ORT's static quantizer writes
    (weights ship quantized; activations carry Q/DQ pairs)."""
    ch = np.moveaxis(w, axis, 0).reshape(w.shape[axis], -1)
    w_scale = (np.max(np.abs(ch), axis=1) / 127.0).astype(np.float32)
    w_scale[w_scale == 0] = 1.0
    shape = [1] * w.ndim
    shape[axis] = w.shape[axis]
    w_q = np.clip(np.round(w / w_scale.reshape(shape)), -127, 127).astype(np.int8)
    return g.add("DequantizeLinear",
                 [g.init("wq", w_q), g.init("ws", w_scale)], axis=axis)


def _conv(g: OnnxGraphWriter, x: str, scope: dict, *, stride: int = 1,
          dilation: int = 1, groups: int = 1, pads=(0, 0),
          quant: str = "none") -> str:
    if quant == "qdq":
        # static-quant QDQ Conv: Q/DQ on the activation, per-output-channel
        # int8 weight (axis 0 of [Cout, Cin/g, K])
        x = _qdq_act(g, x)
        ins = [x, _qdq_weight(g, _conv_w(scope["kernel"]), axis=0)]
    else:
        ins = [x, g.init("w", _conv_w(scope["kernel"]))]
    if "bias" in scope:
        ins.append(g.init("b", np.asarray(scope["bias"], np.float32)))
    y = g.add("Conv", ins, strides=[stride], dilations=[dilation],
              group=groups, pads=list(pads))
    return _qdq_act(g, y, scale=0.1) if quant == "qdq" else y


def _dense(g: OnnxGraphWriter, x: str, scope: dict, quant: str = "none") -> str:
    """nn.Dense / DenseQ on a rank-3 tensor: MatMul [.., Din]x[Din, F] + bias.

    ``quant="int8"`` emits the onnxruntime dynamic-quant transform instead
    — the graph shape of the reference's own int8 SenseVoice export
    (sherpa-onnx, src/model.py:79-87): DynamicQuantizeLinear(x) ->
    MatMulInteger(x_u8, w_s8, x_zp, 0) -> Cast -> * (x_scale*w_scale) + b.
    Weights ship as int8 with one symmetric per-tensor scale.

    ``quant="qdq"`` emits ORT STATIC-quant QDQ form: Q/DQ pairs on
    activations, per-channel int8 weights behind DequantizeLinear — the
    other graph family install.sh-era model zoos deliver.
    """
    if quant == "qdq":
        xd = _qdq_act(g, x)
        wd = _qdq_weight(g, np.asarray(scope["kernel"], np.float32), axis=1)
        y = g.add("MatMul", [xd, wd])
        y = g.add("Add", [y, g.init("b", np.asarray(scope["bias"], np.float32))])
        return _qdq_act(g, y, scale=0.1)
    if quant != "int8":
        y = g.add("MatMul", [x, g.init("w", np.asarray(scope["kernel"], np.float32))])
        return g.add("Add", [y, g.init("b", np.asarray(scope["bias"], np.float32))])
    w = np.asarray(scope["kernel"], np.float32)
    w_scale = float(np.max(np.abs(w)) / 127.0) or 1.0
    w_q = np.clip(np.round(w / w_scale), -127, 127).astype(np.int8)
    xq, x_scale, x_zp = g.add("DynamicQuantizeLinear", [x], n_out=3)
    y = g.add("MatMulInteger", [xq, g.init("wq", w_q), x_zp,
                                g.init("wzp", np.int8(0).reshape(()))])
    y = g.add("Cast", [y], to=1)  # -> float32
    y = g.add("Mul", [y, g.add("Mul", [x_scale, g.init(
        "wscale", np.float32(w_scale).reshape(()))])])
    return g.add("Add", [y, g.init("b", np.asarray(scope["bias"], np.float32))])


def _layernorm(g: OnnxGraphWriter, x: str, scope: dict, eps: float = 1e-6) -> str:
    """Per-frame channel LN -> opset-17 LayerNormalization. Accepts both
    flax nn.LayerNorm params (scale/bias, eps 1e-6) and the in-house
    ChannelLayerNorm's (gamma/beta, eps 1e-8 — models/common.py:47-61)."""
    scale = scope["scale"] if "scale" in scope else scope["gamma"]
    bias = scope["bias"] if "bias" in scope else scope["beta"]
    return g.add("LayerNormalization", [
        x,
        g.init("ln_scale", np.asarray(scale, np.float32)),
        g.init("ln_bias", np.asarray(bias, np.float32)),
    ], axis=-1, epsilon=eps)


def _gelu_tanh(g: OnnxGraphWriter, x: str) -> str:
    """jax.nn.gelu(approximate=True): 0.5*x*(1+tanh(√(2/π)*(x+0.044715x³)))."""
    c3 = g.init("c3", np.float32(0.044715).reshape(()))
    cs = g.init("cs", np.float32(np.sqrt(2.0 / np.pi)).reshape(()))
    half = g.init("half", np.float32(0.5).reshape(()))
    one = g.init("one", np.float32(1.0).reshape(()))
    x3 = g.add("Mul", [g.add("Mul", [x, x]), x])
    inner = g.add("Mul", [g.add("Add", [x, g.add("Mul", [x3, c3])]), cs])
    t = g.add("Tanh", [inner])
    return g.add("Mul", [g.add("Mul", [half, x]), g.add("Add", [one, t])])


def _silu(g: OnnxGraphWriter, x: str) -> str:
    return g.add("Mul", [x, g.add("Sigmoid", [x])])


def _same_pads(t: int, k: int, stride: int = 1) -> tuple:
    """XLA SAME padding (lo, hi) for a static length t."""
    out = -(-t // stride)
    total = max((out - 1) * stride + k - t, 0)
    return total // 2, total - total // 2


def _transformer_block(g: OnnxGraphWriter, x: str, blk: dict, dim: int,
                       heads: int, conv_kernel: int,
                       quant: str = "none") -> str:
    """models/common.TransformerBlock (dense path, no mask): pre-LN MHSA ->
    optional depthwise-conv branch -> gelu FFN, residuals throughout."""
    dh = dim // heads
    ln = 0

    # --- self-attention (common.py:186-231)
    h = _layernorm(g, x, blk[f"LayerNorm_{ln}"]); ln += 1
    qkv = _dense(g, h, blk["MultiHeadSelfAttention_0"]["qkv"], quant)
    q, k, v = g.add("Split", [qkv], n_out=3, axis=-1)

    def _heads(z):
        z = g.add("Reshape", [z, g.init(
            "shape", np.asarray([0, 0, heads, dh], np.int64))])
        return g.add("Transpose", [z], perm=[0, 2, 1, 3])    # [B, H, T, dh]

    q, k, v = _heads(q), _heads(k), _heads(v)
    kt = g.add("Transpose", [k], perm=[0, 1, 3, 2])
    scores = g.add("Mul", [g.add("MatMul", [q, kt]),
                           g.init("scale",
                                  np.float32(1.0 / np.sqrt(dh)).reshape(()))])
    attn = g.add("Softmax", [scores], axis=-1)
    o = g.add("MatMul", [attn, v])                           # [B, H, T, dh]
    o = g.add("Transpose", [o], perm=[0, 2, 1, 3])
    o = g.add("Reshape", [o, g.init(
        "shape", np.asarray([0, 0, dim], np.int64))])
    o = _dense(g, o, blk["MultiHeadSelfAttention_0"]["out"], quant)
    x = g.add("Add", [x, o])

    # --- FSMN-equivalent depthwise-conv branch (common.py:252-257)
    if conv_kernel > 0:
        h = _layernorm(g, x, blk[f"LayerNorm_{ln}"]); ln += 1
        hc = g.add("Transpose", [h], perm=[0, 2, 1])         # NCW
        hc = _conv(g, hc, blk["dwconv"], groups=dim,
                   pads=_same_pads(1, conv_kernel))  # stride-1 SAME: (⌊(k-1)/2⌋, ⌈(k-1)/2⌉)
        hc = g.add("Transpose", [hc], perm=[0, 2, 1])
        x = g.add("Add", [x, _silu(g, hc)])

    # --- FFN (common.py:258-263)
    h = _layernorm(g, x, blk[f"LayerNorm_{ln}"])
    h = _dense(g, h, blk["Dense_0"], quant)
    h = _gelu_tanh(g, h)
    return g.add("Add", [x, _dense(g, h, blk["Dense_1"], quant)])


# ------------------------------------------------------------- ConvTasNet

def export_convtasnet(params, cfg, path: str, seconds: float = 4.0,
                      quant: str = "none") -> str:
    """Serialize ConvTasNet (models/convtasnet.py) to an ONNX file.

    Input  `mix` [batch, T] float32 (T = seconds * cfg.sample_rate, static;
    batch symbolic), output `est` [batch, n_src, T] — the same contract as
    ConvTasNet.__call__ without a sample mask (callers feed one bucketed
    segment per row, the reference's per-segment convention:
    src/osd/separation.py:88-103).
    """
    p = params["params"] if "params" in params else params
    c = cfg
    t = int(round(seconds * c.sample_rate))
    stride = c.stride
    pad = (-(t - c.enc_kernel)) % stride if t >= c.enc_kernel else c.enc_kernel - t
    n_frames = (t + pad - c.enc_kernel) // stride + 1
    t_dec = (n_frames - 1) * stride + c.enc_kernel

    g = OnnxGraphWriter("convtasnet")
    x = "mix"
    if pad:
        pads = g.init("pads", np.asarray([0, 0, 0, pad], np.int64))
        x = g.add("Pad", [x, pads], mode="constant")
    x = g.add("Unsqueeze", [x, g.init("axes", np.asarray([1], np.int64))])

    # encoder [B, 1, T'] -> [B, N, F], relu (convtasnet.py:93-95)
    w = _conv(g, x, p["encoder"], stride=stride, quant=quant)
    w = g.add("Relu", [w])

    # masker TCN (convtasnet.py:104-121)
    h = _gln(g, w, p["ln_in"], 1e-8)
    h = _conv(g, h, p["bottleneck"], quant=quant)
    skips = None
    for r in range(c.n_repeats):
        for xb in range(c.n_blocks):
            blk = p[f"tcn_{r}_{xb}"]
            d = 2 ** xb
            y = _conv(g, h, blk["in_conv"], quant=quant)
            y = _prelu(g, y, blk["prelu1"])
            y = _gln(g, y, blk["norm1"], 1e-8)
            half = d * (c.conv_kernel - 1) // 2
            y = _conv(g, y, blk["dw_conv"], dilation=d, groups=c.hidden,
                      pads=(half, d * (c.conv_kernel - 1) - half), quant=quant)
            y = _prelu(g, y, blk["prelu2"])
            y = _gln(g, y, blk["norm2"], 1e-8)
            res = _conv(g, y, blk["res_conv"], quant=quant)
            skip = _conv(g, y, blk["skip_conv"], quant=quant)
            h = g.add("Add", [h, res])
            skips = skip if skips is None else g.add("Add", [skips, skip])

    m = _prelu(g, skips, p["mask_prelu"])
    m = _conv(g, m, p["mask_conv"], quant=quant)                      # [B, S*N, F]
    m = g.add("Reshape", [m, g.init(
        "shape", np.asarray([-1, c.n_src, c.enc_dim, n_frames], np.int64))])
    act = {"relu": "Relu", "sigmoid": "Sigmoid", "softmax": "Softmax"}[c.mask_act]
    m = (g.add("Softmax", [m], axis=1) if c.mask_act == "softmax"
         else g.add(act, [m]))                           # [B, S, N, F]

    wu = g.add("Unsqueeze", [w, g.init("axes", np.asarray([1], np.int64))])
    masked = g.add("Mul", [wu, m])                       # [B, S, N, F]
    masked = g.add("Reshape", [masked, g.init(
        "shape", np.asarray([-1, c.enc_dim, n_frames], np.int64))])

    # decoder == transposed conv / overlap-add (convtasnet.py:130-139);
    # flax decoder param [K, N] -> ConvTranspose weight [Cin=N, Cout=1, K]
    dec = np.asarray(p["decoder"], np.float32).T.reshape(c.enc_dim, 1,
                                                         c.enc_kernel)
    sig = g.add("ConvTranspose", [masked, g.init("dec", dec)],
                strides=[stride])                        # [B*S, 1, T'']
    sq = g.add("Squeeze", [sig, g.init("axes", np.asarray([1], np.int64))])
    if t_dec > t:
        sq = g.add("Slice", [
            sq,
            g.init("starts", np.asarray([0], np.int64)),
            g.init("ends", np.asarray([t], np.int64)),
            g.init("axes", np.asarray([1], np.int64)),
        ])
    est = g.add("Reshape", [sq, g.init(
        "shape", np.asarray([-1, c.n_src, t], np.int64))], out="est")

    blob = g.serialize(
        inputs=[("mix", np.float32, ["batch", t])],
        outputs=[("est", np.float32, ["batch", c.n_src, t])],
        metadata={
            "model_type": "convtasnet",
            "n_src": c.n_src, "enc_dim": c.enc_dim,
            "enc_kernel": c.enc_kernel, "bottleneck": c.bottleneck,
            "hidden": c.hidden, "n_blocks": c.n_blocks,
            "n_repeats": c.n_repeats, "sample_rate": c.sample_rate,
            "mask_act": c.mask_act, "quant": quant,
        })
    with open(path, "wb") as f:
        f.write(blob)
    return path


# ----------------------------------------------------- SenseVoice encoder

def export_sensevoice(params, cfg, path: str, frames: int,
                      use_itn: bool = True, quant: str = "none") -> str:
    """Serialize the SenseVoice-style CTC encoder (models/asr/sensevoice.py)
    to ONNX — a trained/fine-tuned recognizer (cli/train_asr) becomes a
    standard export deployable on onnxruntime or this framework's own graph
    executor.

    The contract mirrors how the reference's real SenseVoice export is
    shaped (reference: src/model.py:79-87 consumes feats-level sherpa
    exports whose frontend — fbank+LFR+CMVN — runs host-side): inputs are
    `feats` [batch, frames, lfr_m*num_mel] float32 (frames static, batch
    symbolic) and `language` [1] int64 (index into LANGUAGES; the sherpa
    convention of language as a runtime input), output `logits`
    [batch, num_prompt+frames, vocab] — consumers skip the first
    `num_prompt` rows before CTC decode, exactly like the serving engine
    (engine/runtime.py drops prompt frames before greedy decode).

    `use_itn` is baked at export time (one row of the itn embedding becomes
    a constant), matching how the trained model is deployed for one text
    norm mode.
    """
    from ..models.asr.sensevoice import LANGUAGES
    from ..models.common import sinusoidal_positions

    p = params["params"] if "params" in params else params
    c = cfg
    t, pr = int(frames), int(c.num_prompt)

    g = OnnxGraphWriter("sensevoice")
    x = _dense(g, "feats", p["in_proj"], quant)              # [B, T, D]

    # prompt rows: language row gathered at runtime, itn row baked,
    # padding rows constant (sensevoice.py:75-93)
    lang_row = g.add("Gather", [
        g.init("lang_embed", np.asarray(p["lang_embed"], np.float32)),
        "language"], axis=0)                                 # [1, D]
    itn_row = g.init("itn_row", np.asarray(
        p["itn_embed"][1 if use_itn else 0], np.float32)[None])
    pad_rows = g.init("prompt_pad", np.asarray(p["prompt_pad"], np.float32))
    prompt = g.add("Concat", [lang_row, itn_row, pad_rows], axis=0)
    prompt = g.add("Unsqueeze", [prompt, g.init(
        "axes", np.asarray([0], np.int64))])                 # [1, P, D]

    # tile over the symbolic batch: Expand to [Shape(feats)[0], P, D]
    shp = g.add("Shape", ["feats"])
    batch = g.add("Slice", [shp,
                            g.init("starts", np.asarray([0], np.int64)),
                            g.init("ends", np.asarray([1], np.int64))])
    target = g.add("Concat", [batch,
                              g.init("pd", np.asarray([pr, c.dim], np.int64))],
                   axis=0)
    prompt = g.add("Expand", [prompt, target])               # [B, P, D]
    x = g.add("Concat", [prompt, x], axis=1)                 # [B, P+T, D]

    pos = sinusoidal_positions(t + pr, c.dim)
    x = g.add("Add", [x, g.init("pos", pos)])

    for i in range(c.layers):
        x = _transformer_block(g, x, p[f"block_{i}"], c.dim, c.heads,
                               c.conv_kernel, quant=quant)

    x = _layernorm(g, x, p["final_ln"])
    head = _dense(g, x, p["ctc_head"], quant)
    g.add("Identity", [head], out="logits")

    blob = g.serialize(
        inputs=[("feats", np.float32, ["batch", t, c.lfr_m * c.num_mel]),
                ("language", np.int64, [1])],
        outputs=[("logits", np.float32, ["batch", pr + t, c.vocab_size])],
        metadata={
            "model_type": "sensevoice",
            "vocab_size": c.vocab_size, "dim": c.dim, "heads": c.heads,
            "layers": c.layers, "ffn_mult": c.ffn_mult,
            "conv_kernel": c.conv_kernel, "lfr_m": c.lfr_m, "lfr_n": c.lfr_n,
            "num_mel": c.num_mel, "num_prompt": pr, "use_itn": int(use_itn),
            "quant": quant,
            "languages": ",".join(LANGUAGES),
        })
    with open(path, "wb") as f:
        f.write(blob)
    return path


# ----------------------------------------------------------------- OSDNet

def export_osdnet(params, cfg, path: str, frames: int,
                  quant: str = "none") -> str:
    """Serialize OSDNet (models/osd.py) to ONNX: fbank feats
    [batch, frames, num_mel] -> [batch, frames//subsample, 2] probs
    (p(speech), p(overlap)) — the fast OSD head, e.g. one distilled from a
    pyannote teacher (cli/distill_osd), deployable outside the framework.
    Frame semantics match OverlapAnalyzer's rasterization (reference:
    src/osd/osd.py:73-147 consumes the same per-frame probabilities).
    """
    from ..models.common import sinusoidal_positions

    p = params["params"] if "params" in params else params
    c = cfg

    g = OnnxGraphWriter("osdnet")
    x = g.add("Transpose", ["feats"], perm=[0, 2, 1])        # NCW
    x = _conv(g, x, p["sub1"], stride=2, pads=_same_pads(frames, 5, 2),
              quant=quant)
    t1 = -(-frames // 2)
    x = g.add("Transpose", [x], perm=[0, 2, 1])
    x = _gelu_tanh(g, x)
    x = g.add("Transpose", [x], perm=[0, 2, 1])
    x = _conv(g, x, p["sub2"], stride=2, pads=_same_pads(t1, 5, 2),
              quant=quant)
    t2 = -(-t1 // 2)
    x = g.add("Transpose", [x], perm=[0, 2, 1])
    x = _gelu_tanh(g, x)

    x = g.add("Add", [x, g.init("pos", sinusoidal_positions(t2, c.dim))])
    for i in range(c.layers):
        x = _transformer_block(g, x, p[f"block_{i}"], c.dim, c.heads,
                               c.conv_kernel, quant=quant)
    logits = _dense(g, x, p["head"])
    g.add("Sigmoid", [logits], out="probs")

    blob = g.serialize(
        inputs=[("feats", np.float32, ["batch", frames, c.num_mel])],
        outputs=[("probs", np.float32, ["batch", t2, 2])],
        metadata={
            "model_type": "osdnet",
            "num_mel": c.num_mel, "dim": c.dim, "heads": c.heads,
            "layers": c.layers, "conv_kernel": c.conv_kernel,
            "subsample": c.subsample, "sample_rate": c.sample_rate,
            "frame_shift_ms": c.frame_shift_ms,
        })
    with open(path, "wb") as f:
        f.write(blob)
    return path


# -------------------------------------------------------------- MossFormer

def export_mossformer(params, cfg, path: str, seconds: float = 4.0) -> str:
    """Serialize MossFormer (models/mossformer.py) to ONNX.

    Same contract as export_convtasnet: `mix` [batch, T] (T static, batch
    symbolic) -> `est` [batch, n_src, T]. The GAU blocks decompose to
    MatMul/Relu/Mul primitives; the 1/T attention scale and the conv
    padding are baked for the exported length. Second separation backend
    (reference: src/mossformer/infer.py:13-23) gets the same train->export
    deployment loop as ConvTasNet.
    """
    p = params["params"] if "params" in params else params
    c = cfg
    t = int(round(seconds * c.sample_rate))
    stride = c.stride
    pad = (-(t - c.enc_kernel)) % stride if t >= c.enc_kernel else c.enc_kernel - t
    n_frames = (t + pad - c.enc_kernel) // stride + 1
    t_dec = (n_frames - 1) * stride + c.enc_kernel

    g = OnnxGraphWriter("mossformer")
    x = "mix"
    if pad:
        x = g.add("Pad", [x, g.init("pads", np.asarray([0, 0, 0, pad], np.int64))],
                  mode="constant")
    x = g.add("Unsqueeze", [x, g.init("axes", np.asarray([1], np.int64))])

    # encoder [B, 1, T'] -> [B, N, F], relu (mossformer.py:89-91)
    w = _conv(g, x, p["encoder"], stride=stride)
    w = g.add("Relu", [w])
    wt = g.add("Transpose", [w], perm=[0, 2, 1])             # [B, F, N]

    h = _dense(g, wt, p["in_proj"])                          # [B, F, dim]
    inv_t = np.float32(1.0 / n_frames).reshape(())
    for i in range(c.layers):
        blk = p[f"gau_{i}"]
        # GAU (mossformer.py:49-71): cLN -> conv mix -> gated attention
        hn = _layernorm(g, h, blk["ln"], eps=1e-8)
        hc = g.add("Transpose", [hn], perm=[0, 2, 1])
        hc = _conv(g, hc, blk["dwconv"], groups=c.dim,
                   pads=_same_pads(1, c.conv_kernel))
        hc = g.add("Transpose", [hc], perm=[0, 2, 1])
        hn = g.add("Add", [hn, _silu(g, hc)])
        u = _silu(g, _dense(g, hn, blk["to_u"]))
        v = _silu(g, _dense(g, hn, blk["to_v"]))
        z = _dense(g, hn, blk["to_qk"])
        gamma = np.asarray(blk["gamma"], np.float32)
        beta = np.asarray(blk["beta"], np.float32)
        q = g.add("Add", [g.add("Mul", [z, g.init("gma", gamma[0])]),
                          g.init("bta", beta[0])])
        k = g.add("Add", [g.add("Mul", [z, g.init("gma", gamma[1])]),
                          g.init("bta", beta[1])])
        logits = g.add("Mul", [
            g.add("MatMul", [q, g.add("Transpose", [k], perm=[0, 2, 1])]),
            g.init("inv_t", inv_t)])
        attn = g.add("Relu", [logits])
        attn = g.add("Mul", [attn, attn])                    # relu(.)²
        out = g.add("Mul", [u, g.add("MatMul", [attn, v])])
        out = _dense(g, out, blk["to_out"])
        h = g.add("Add", [h, out])

    h = _layernorm(g, h, p["ln_out"], eps=1e-8)
    m = _dense(g, h, p["mask_head"])                         # [B, F, S*N]
    m = g.add("Relu", [m])
    m = g.add("Reshape", [m, g.init(
        "shape", np.asarray([-1, n_frames, c.n_src, c.enc_dim], np.int64))])

    # masked = w[:, :, None, :] * m with w as [B, F, N] (mossformer.py:116)
    wu = g.add("Unsqueeze", [wt, g.init("axes", np.asarray([2], np.int64))])
    masked = g.add("Mul", [wu, m])                           # [B, F, S, N]
    masked = g.add("Transpose", [masked], perm=[0, 2, 3, 1]) # [B, S, N, F]
    masked = g.add("Reshape", [masked, g.init(
        "shape", np.asarray([-1, c.enc_dim, n_frames], np.int64))])

    # decoder == overlap-add == ConvTranspose (mossformer.py:107-109);
    # flax decoder [K, N] -> ConvTranspose weight [Cin=N, Cout=1, K]
    dec = np.asarray(p["decoder"], np.float32).T.reshape(c.enc_dim, 1,
                                                         c.enc_kernel)
    sig = g.add("ConvTranspose", [masked, g.init("dec", dec)],
                strides=[stride])
    sq = g.add("Squeeze", [sig, g.init("axes", np.asarray([1], np.int64))])
    if t_dec > t:
        sq = g.add("Slice", [
            sq,
            g.init("starts", np.asarray([0], np.int64)),
            g.init("ends", np.asarray([t], np.int64)),
            g.init("axes", np.asarray([1], np.int64)),
        ])
    g.add("Reshape", [sq, g.init(
        "shape", np.asarray([-1, c.n_src, t], np.int64))], out="est")

    blob = g.serialize(
        inputs=[("mix", np.float32, ["batch", t])],
        outputs=[("est", np.float32, ["batch", c.n_src, t])],
        metadata={
            "model_type": "mossformer",
            "n_src": c.n_src, "enc_dim": c.enc_dim,
            "enc_kernel": c.enc_kernel, "dim": c.dim, "qk_dim": c.qk_dim,
            "expansion": c.expansion, "layers": c.layers,
            "conv_kernel": c.conv_kernel, "sample_rate": c.sample_rate,
        })
    with open(path, "wb") as f:
        f.write(blob)
    return path


# -------------------------------------------------------- SpeakerEmbedder

def _conv2d(g: OnnxGraphWriter, x: str, scope: dict, *, strides=(1, 1),
            pads=(0, 0, 0, 0), quant: str = "none") -> str:
    """flax nn.Conv kernel [kh, kw, Cin/g, Cout] -> ONNX NCHW Conv."""
    w = np.transpose(np.asarray(scope["kernel"], np.float32), (3, 2, 0, 1))
    if quant == "qdq":
        x = _qdq_act(g, x)
        ins = [x, _qdq_weight(g, np.ascontiguousarray(w), axis=0)]
    else:
        ins = [x, g.init("w", np.ascontiguousarray(w))]
    if "bias" in scope:
        ins.append(g.init("b", np.asarray(scope["bias"], np.float32)))
    y = g.add("Conv", ins, strides=list(strides), pads=list(pads))
    return _qdq_act(g, y, scale=0.1) if quant == "qdq" else y


def _bn2d(g: OnnxGraphWriter, x: str, pscope: dict, sscope: dict,
          eps: float = 1e-5) -> str:
    """flax nn.BatchNorm (inference mode) on an NCHW tensor."""
    return g.add("BatchNormalization", [
        x,
        g.init("bn_s", np.asarray(pscope["scale"], np.float32)),
        g.init("bn_b", np.asarray(pscope["bias"], np.float32)),
        g.init("bn_m", np.asarray(sscope["mean"], np.float32)),
        g.init("bn_v", np.asarray(sscope["var"], np.float32)),
    ], epsilon=eps)


def export_speaker(variables, cfg, path: str, frames: int,
                   quant: str = "none") -> str:
    """Serialize SpeakerEmbedder (models/speaker.py) to ONNX — the same role
    as the reference's 3D-Speaker ERes2Net export (reference:
    src/model.py:103-124 consumes it via sherpa's
    SpeakerEmbeddingExtractor): fbank `feats` [batch, frames, num_mel] ->
    `emb` [batch, embed_dim] (unnormalized, like the flax module; callers
    l2-normalize before cosine search).

    `variables` is the embedder's full variable dict ({"params", 
    "batch_stats"}) — e.g. the tree cli/train_speaker exports. BatchNorms
    are emitted in inference mode from the stored statistics.
    """
    p = variables["params"]
    s = variables.get("batch_stats", {})
    c = cfg

    g = OnnxGraphWriter("speaker_embedder")
    # [B, T, F] -> NCHW [B, 1, T, F]
    x = g.add("Unsqueeze", ["feats", g.init("axes", np.asarray([1], np.int64))])

    def same2d(t, f, k, stride):
        lo_t, hi_t = _same_pads(t, k, stride)
        lo_f, hi_f = _same_pads(f, k, stride)
        return (lo_t, lo_f, hi_t, hi_f)  # ONNX pads: [t_lo, f_lo, t_hi, f_hi]

    t_cur, f_cur = frames, c.num_mel
    x = _conv2d(g, x, p["stem"], pads=same2d(t_cur, f_cur, 3, 1), quant=quant)
    x = g.add("Relu", [_bn2d(g, x, p["bn0"], s["bn0"])])

    for i, ch in enumerate(c.channels):
        stride = 1 if i == 0 else 2
        bp, bs = p[f"block_{i}"], s[f"block_{i}"]
        # Res2Block (speaker.py:36-67), NCHW
        y = _conv2d(g, x, bp["in_conv"], strides=(stride, stride), quant=quant)
        y = g.add("Relu", [_bn2d(g, y, bp["bn_in"], bs["bn_in"])])
        t_cur, f_cur = -(-t_cur // stride), -(-f_cur // stride)
        parts = g.add("Split", [y], n_out=c.scale, axis=1)
        outs, prev = [parts[0]], None
        for j in range(1, c.scale):
            inp = parts[j] if prev is None else g.add("Add", [parts[j], prev])
            z = _conv2d(g, inp, bp[f"conv_{j}"], pads=same2d(t_cur, f_cur, 3, 1),
                        quant=quant)
            prev = g.add("Relu", [_bn2d(g, z, bp[f"bn_{j}"], bs[f"bn_{j}"])])
            outs.append(prev)
        y = g.add("Concat", outs, axis=1)
        y = _conv2d(g, y, bp["out_conv"], quant=quant)
        y = _bn2d(g, y, bp["bn_out"], bs["bn_out"])
        if "short" in bp:
            x = _conv2d(g, x, bp["short"], strides=(stride, stride), quant=quant)
        x = g.add("Relu", [g.add("Add", [x, y])])

    # fold freq into channels, matching NHWC reshape (speaker.py:106-107):
    # NCHW [B, C, T, F] -> NHWC [B, T, F, C] -> [B, T, F*C]
    ch_last = c.channels[-1]
    x = g.add("Transpose", [x], perm=[0, 2, 3, 1])
    x = g.add("Reshape", [x, g.init(
        "shape", np.asarray([0, 0, f_cur * ch_last], np.int64))])

    # attentive stats pooling (speaker.py:70-85), no mask
    asp = p["asp"]
    a = _dense(g, x, asp["Dense_0"])
    a = g.add("Tanh", [a])
    a = _dense(g, a, asp["Dense_1"])
    w = g.add("Softmax", [a], axis=1)
    wx = g.add("Mul", [w, x])
    # opset-13+ ReduceSum carries axes as an INPUT (unlike ReduceMean,
    # which keeps the attribute form until opset 18)
    ax1 = g.init("axes", np.asarray([1], np.int64))
    mean_k = g.add("ReduceSum", [wx, ax1], keepdims=1)        # [B, 1, D]
    d = g.add("Sub", [x, mean_k])
    var = g.add("ReduceSum", [g.add("Mul", [w, g.add("Mul", [d, d])]), ax1],
                keepdims=0)                                   # [B, D]
    std = g.add("Sqrt", [g.add("Add", [
        var, g.init("eps", np.float32(1e-7).reshape(()))])])
    mean = g.add("Squeeze", [mean_k, g.init("axes", np.asarray([1], np.int64))])
    pooled = g.add("Concat", [mean, std], axis=-1)            # [B, 2D]

    g.add("MatMul", [pooled, g.init("w", np.asarray(p["proj"]["kernel"],
                                                    np.float32))], out="mm_proj")
    g.add("Add", ["mm_proj", g.init("b", np.asarray(p["proj"]["bias"],
                                                    np.float32))], out="emb")

    blob = g.serialize(
        inputs=[("feats", np.float32, ["batch", frames, c.num_mel])],
        outputs=[("emb", np.float32, ["batch", c.embed_dim])],
        metadata={
            "model_type": "speaker_embedder",
            "num_mel": c.num_mel,
            "channels": ",".join(str(v) for v in c.channels),
            "scale": c.scale, "embed_dim": c.embed_dim,
            "asp_hidden": c.asp_hidden, "sample_rate": c.sample_rate,
        })
    with open(path, "wb") as f:
        f.write(blob)
    return path


# ----------------------------------------------------------------- PyanNet

def export_pyannet(params, cfg, path: str, samples: int) -> str:
    """Serialize the exact-parity PyanNet OSD (models/pyannet.py) to ONNX.

    Input `wav` [batch, samples] float32 (samples static, batch symbolic;
    every row full-length — pyannote's own chunked-inference convention),
    output `probs` [batch, frames, num_classes] per-frame sigmoid
    activations (reference: src/osd/osd.py:20-71 runs this model through
    the pyannote pipeline). The learnable SincNet band parameters are
    materialized into a static conv kernel at export; the BiLSTM stack maps
    onto ONNX LSTM nodes (torch gate order i,f,g,o -> ONNX i,o,f,c).
    """
    import torch

    from ..models.pyannet import sinc_filters

    c = cfg
    p = params

    def _reorder_gates(m: np.ndarray, h: int) -> np.ndarray:
        """torch rows (i,f,g,o) -> ONNX rows (i,o,f,c)."""
        m = np.asarray(m, np.float32)
        return np.concatenate([m[0 * h:1 * h], m[3 * h:4 * h],
                               m[1 * h:2 * h], m[2 * h:3 * h]], axis=0)

    g = OnnxGraphWriter("pyannet")
    x = g.add("Unsqueeze", ["wav", g.init("axes", np.asarray([1], np.int64))])
    x = g.add("InstanceNormalization", [
        x,
        g.init("in_s", np.asarray(p["wav_norm"]["weight"], np.float32)),
        g.init("in_b", np.asarray(p["wav_norm"]["bias"], np.float32)),
    ], epsilon=1e-5)

    # SincNet front end (pyannet.py:152-184): bands -> static VALID conv
    filt = sinc_filters(c, torch.as_tensor(np.asarray(p["sinc"]["low_hz"], np.float32)),
                        torch.as_tensor(np.asarray(p["sinc"]["band_hz"], np.float32)))
    x = g.add("Conv", [x, g.init("sinc", filt.numpy())], strides=[c.stride])  # [F, 1, K]
    x = g.add("Abs", [x])
    t = (samples - c.kernel_size) // c.stride + 1

    def block_tail(x, t, norm):
        x = g.add("MaxPool", [x], kernel_shape=[c.pool], strides=[c.pool])
        t //= c.pool
        x = g.add("InstanceNormalization", [
            x,
            g.init("in_s", np.asarray(norm["weight"], np.float32)),
            g.init("in_b", np.asarray(norm["bias"], np.float32)),
        ], epsilon=1e-5)
        return g.add("LeakyRelu", [x], alpha=0.01), t

    x, t = block_tail(x, t, p["norm0"])
    for i in range(1, 1 + len(c.conv_channels)):
        w = np.asarray(p[f"conv{i}"]["weight"], np.float32)    # [O, I, K] torch
        x = g.add("Conv", [x, g.init("w", w),
                           g.init("b", np.asarray(p[f"conv{i}"]["bias"],
                                                  np.float32))])
        t -= c.conv_kernel - 1
        x, t = block_tail(x, t, p[f"norm{i}"])

    # BiLSTM stack (pyannet.py:221-234,288-296): [B, C, T] -> [T, B, C]
    x = g.add("Transpose", [x], perm=[2, 0, 1])
    h = c.lstm_hidden
    ndir = 2 if c.bidirectional else 1
    for lp in p["lstm"]:
        dirs = ["fw", "bw"] if c.bidirectional else ["fw"]
        W = np.stack([_reorder_gates(lp[d]["w_ih"], h) for d in dirs])
        R = np.stack([_reorder_gates(lp[d]["w_hh"], h) for d in dirs])
        B = np.stack([np.concatenate([_reorder_gates(lp[d]["b_ih"], h),
                                      _reorder_gates(lp[d]["b_hh"], h)])
                      for d in dirs])
        y = g.add("LSTM", [x, g.init("W", W), g.init("R", R), g.init("B", B)],
                  n_out=2, hidden_size=h,
                  direction="bidirectional" if c.bidirectional else "forward")[0]
        # Y [T, ndir, B, H] -> [T, B, ndir*H]
        y = g.add("Transpose", [y], perm=[0, 2, 1, 3])
        x = g.add("Reshape", [y, g.init(
            "shape", np.asarray([0, 0, ndir * h], np.int64))])
    x = g.add("Transpose", [x], perm=[1, 0, 2])                # [B, T, ndir*H]

    for lp in p["linear"]:
        w = np.asarray(lp["weight"], np.float32).T
        x = g.add("Add", [g.add("MatMul", [x, g.init("w", w)]),
                          g.init("b", np.asarray(lp["bias"], np.float32))])
        x = g.add("LeakyRelu", [x], alpha=0.01)
    w = np.asarray(p["classifier"]["weight"], np.float32).T
    logits = g.add("Add", [g.add("MatMul", [x, g.init("w", w)]),
                           g.init("b", np.asarray(p["classifier"]["bias"],
                                                  np.float32))])
    g.add("Sigmoid", [logits], out="probs")

    blob = g.serialize(
        inputs=[("wav", np.float32, ["batch", samples])],
        outputs=[("probs", np.float32, ["batch", t, c.num_classes])],
        metadata={
            "model_type": "pyannet",
            "sample_rate": c.sample_rate, "num_classes": c.num_classes,
            "lstm_hidden": c.lstm_hidden, "lstm_layers": c.lstm_layers,
            "bidirectional": int(c.bidirectional),
            "frames": t,
        })
    with open(path, "wb") as f:
        f.write(blob)
    return path


# ------------------------------------------------------------------ VADNet

def export_vadnet(params, cfg, path: str, frames: int,
                  quant: str = "none") -> str:
    """Serialize VADNet (models/vad.py) to ONNX: fbank feats
    [batch, frames, num_mel] -> [batch, frames] speech probabilities — the
    same role as the reference's silero VAD export (reference:
    speaker-identification-with-vad-non-streaming-asr.py:497-516); the
    hysteresis segmenter downstream is host logic in both designs.
    """
    p = params["params"] if "params" in params else params
    c = cfg

    g = OnnxGraphWriter("vadnet")
    x = g.add("Transpose", ["feats"], perm=[0, 2, 1])        # NCW
    for i in range(c.layers):
        d = 2 ** i
        total = (c.kernel - 1) * d                            # stride-1 SAME
        x = _conv(g, x, p[f"conv_{i}"], dilation=d,
                  pads=(total // 2, total - total // 2), quant=quant)
        x = g.add("Transpose", [x], perm=[0, 2, 1])
        x = _gelu_tanh(g, x)
        if i < c.layers - 1:
            x = g.add("Transpose", [x], perm=[0, 2, 1])
    logits = _dense(g, x, p["head"])                         # [B, T, 1]
    probs3 = g.add("Sigmoid", [logits])
    g.add("Squeeze", [probs3, g.init("axes", np.asarray([2], np.int64))],
          out="probs")

    blob = g.serialize(
        inputs=[("feats", np.float32, ["batch", frames, c.num_mel])],
        outputs=[("probs", np.float32, ["batch", frames])],
        metadata={
            "model_type": "vadnet",
            "num_mel": c.num_mel, "dim": c.dim, "layers": c.layers,
            "kernel": c.kernel, "sample_rate": c.sample_rate,
            "frame_shift_ms": c.frame_shift_ms,
        })
    with open(path, "wb") as f:
        f.write(blob)
    return path
