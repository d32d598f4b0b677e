"""ONNX parsing without the onnx package (pure protobuf wire reading): the
port's own copy of audio_classification_tpu/models/convert/onnx_import.py.

The reference's model zoo ships as ONNX graphs executed by onnxruntime
(reference: SURVEY.md §2.2-2.3: 3D-Speaker ERes2Net embedder, SenseVoice
int8, silero VAD). Reading those weights needs the initializer tensors plus
the graph structure (node op types, inputs, attributes), so weights can be
assigned to module parameters by structural position; this module
implements a minimal protobuf wire reader for ModelProto -> GraphProto ->
{TensorProto, NodeProto, AttributeProto}. numpy only. int8-quantized
tensors are returned raw together with any scale / zero-point tensors, so
callers can dequantize (the graph walker in onnx_graph_map resolves
DequantizeLinear chains).

Wire format reference: protobuf encoding docs (varint, 64-bit, length-
delimited, 32-bit field types).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Tuple

import numpy as np

# TensorProto.DataType -> numpy dtype
_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _iter_fields(buf: memoryview) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over one message body."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field_no = key >> 3
        wire = key & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = bytes(buf[pos : pos + 8])
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = bytes(buf[pos : pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field_no, wire, val


def _parse_tensor(buf: memoryview) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype_code = 1
    name = ""
    raw = b""
    float_data: List[float] = []
    int32_data: List[int] = []
    int64_data: List[int] = []
    double_data: List[float] = []
    for field_no, wire, val in _iter_fields(buf):
        if field_no == 1:  # dims
            if wire == 0:
                dims.append(int(val))
            else:  # packed
                pos = 0
                mv = val
                while pos < len(mv):
                    v, pos = _read_varint(mv, pos)
                    dims.append(v)
        elif field_no == 2 and wire == 0:
            dtype_code = int(val)
        elif field_no == 4:  # float_data (packed or repeated 32-bit)
            if wire == 2:
                float_data.extend(np.frombuffer(bytes(val), dtype="<f4").tolist())
            else:
                float_data.append(struct.unpack("<f", val)[0])
        elif field_no == 5:  # int32_data
            if wire == 2:
                pos = 0
                mv = val
                while pos < len(mv):
                    v, pos = _read_varint(mv, pos)
                    int32_data.append(v)
            else:
                int32_data.append(int(val))
        elif field_no == 7:  # int64_data
            if wire == 2:
                pos = 0
                mv = val
                while pos < len(mv):
                    v, pos = _read_varint(mv, pos)
                    int64_data.append(v)
            else:
                int64_data.append(int(val))
        elif field_no == 8 and wire == 2:
            name = bytes(val).decode("utf-8", errors="replace")
        elif field_no == 9 and wire == 2:
            raw = bytes(val)
        elif field_no == 10:  # double_data
            if wire == 2:
                double_data.extend(np.frombuffer(bytes(val), dtype="<f8").tolist())
            else:
                double_data.append(struct.unpack("<d", val)[0])
    dtype = _DTYPES.get(dtype_code)
    if dtype is None:
        raise ValueError(f"unsupported ONNX tensor dtype {dtype_code} for '{name}'")
    if raw:
        arr = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder("<")).copy()
    elif float_data:
        arr = np.asarray(float_data, dtype=np.float32)
    elif double_data:
        arr = np.asarray(double_data, dtype=np.float64)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=np.int64)
    elif int32_data:
        # int32_data carries int32/int16/int8/bool/fp16 payloads
        arr = np.asarray(int32_data, dtype=np.int32).astype(dtype)
    else:
        arr = np.zeros(0, dtype=dtype)
    if dims:
        arr = arr.reshape(dims)
    return name, arr


def _signed64(v: int) -> int:
    """Protobuf varints encode negative int64 as two's-complement 64-bit."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_attribute(buf: memoryview):
    """AttributeProto -> (name, python value).

    Handled: f(2), i(3), s(4), t(5, TensorProto), g(6, GraphProto ->
    OnnxGraph), floats(7), ints(8), strings(9), graphs(11).
    """
    name = ""
    val = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    graphs: List["OnnxGraph"] = []
    for field_no, wire, v in _iter_fields(buf):
        if field_no == 1 and wire == 2:
            name = bytes(v).decode("utf-8", errors="replace")
        elif field_no == 2 and wire == 5:  # f
            val = struct.unpack("<f", v)[0]
        elif field_no == 3 and wire == 0:  # i
            val = _signed64(int(v))
        elif field_no == 4 and wire == 2:  # s
            val = bytes(v)
        elif field_no == 5 and wire == 2:  # t
            val = _parse_tensor(v)[1]
        elif field_no == 6 and wire == 2:  # g (subgraph: If/Loop/Scan bodies)
            val = _parse_graph(v)
        elif field_no == 11 and wire == 2:  # graphs
            graphs.append(_parse_graph(v))
        elif field_no == 7:  # floats
            if wire == 2:
                floats.extend(np.frombuffer(bytes(v), dtype="<f4").tolist())
            else:
                floats.append(struct.unpack("<f", v)[0])
        elif field_no == 8:  # ints
            if wire == 2:
                pos = 0
                while pos < len(v):
                    x, pos = _read_varint(v, pos)
                    ints.append(_signed64(x))
            else:
                ints.append(_signed64(int(v)))
        elif field_no == 9 and wire == 2:  # strings
            strings.append(bytes(v))
    if floats:
        val = floats
    elif ints:
        val = ints
    elif strings:
        val = strings
    elif graphs:
        val = graphs
    return name, val


@dataclass
class OnnxNode:
    op_type: str
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    name: str = ""
    attrs: Dict[str, object] = field(default_factory=dict)


def _parse_node(buf: memoryview) -> OnnxNode:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    node = OnnxNode(op_type="")
    for field_no, wire, v in _iter_fields(buf):
        if field_no == 1 and wire == 2:
            node.inputs.append(bytes(v).decode("utf-8", errors="replace"))
        elif field_no == 2 and wire == 2:
            node.outputs.append(bytes(v).decode("utf-8", errors="replace"))
        elif field_no == 3 and wire == 2:
            node.name = bytes(v).decode("utf-8", errors="replace")
        elif field_no == 4 and wire == 2:
            node.op_type = bytes(v).decode("utf-8", errors="replace")
        elif field_no == 5 and wire == 2:
            k, val = _parse_attribute(v)
            if k:
                node.attrs[k] = val
    return node


@dataclass
class ValueInfo:
    """Parsed ValueInfoProto (graph input/output signature entry).

    `shape` entries are ints for fixed dims, strings for symbolic dims
    (dim_param, e.g. "batch"/"T"), None for unspecified.
    """

    name: str
    dtype: object = None  # numpy dtype or None
    shape: List[object] = field(default_factory=list)


def _parse_value_info(buf: memoryview) -> ValueInfo:
    """ValueInfoProto: name=1, type=2 (TypeProto.tensor_type=1 ->
    elem_type=1, shape=2 (TensorShapeProto.dim=1: dim_value=1,
    dim_param=2))."""
    vi = ValueInfo(name="")
    for field_no, wire, v in _iter_fields(buf):
        if field_no == 1 and wire == 2:
            vi.name = bytes(v).decode("utf-8", errors="replace")
        elif field_no == 2 and wire == 2:  # TypeProto
            for f2, w2, v2 in _iter_fields(v):
                if f2 == 1 and w2 == 2:  # tensor_type
                    for f3, w3, v3 in _iter_fields(v2):
                        if f3 == 1 and w3 == 0:  # elem_type
                            vi.dtype = _DTYPES.get(int(v3))
                        elif f3 == 2 and w3 == 2:  # shape
                            for f4, w4, v4 in _iter_fields(v3):
                                if f4 == 1 and w4 == 2:  # dim
                                    dim: object = None
                                    for f5, w5, v5 in _iter_fields(v4):
                                        if f5 == 1 and w5 == 0:
                                            dim = _signed64(int(v5))
                                        elif f5 == 2 and w5 == 2:
                                            dim = bytes(v5).decode(
                                                "utf-8", errors="replace"
                                            )
                                    vi.shape.append(dim)
    return vi


@dataclass
class OnnxGraph:
    """Parsed GraphProto: nodes in file order (ONNX requires topological
    order) + initializer tensors + input/output signatures."""

    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    inputs: List[ValueInfo] = field(default_factory=list)
    outputs: List[ValueInfo] = field(default_factory=list)
    name: str = ""

    def ops(self, *op_types: str) -> List[OnnxNode]:
        """Nodes of the given op types, in graph (execution) order."""
        want = set(op_types)
        return [n for n in self.nodes if n.op_type in want]

    @property
    def input_names(self) -> List[str]:
        """Graph inputs that are NOT initializers (i.e. runtime feeds);
        pre-IR-4 models list initializers in inputs too."""
        return [
            vi.name for vi in self.inputs if vi.name not in self.initializers
        ]

    @property
    def output_names(self) -> List[str]:
        return [vi.name for vi in self.outputs]


def _parse_graph(buf: memoryview) -> OnnxGraph:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    g = OnnxGraph(nodes=[], initializers={})
    for field_no, wire, val in _iter_fields(buf):
        if field_no == 1 and wire == 2:  # node
            g.nodes.append(_parse_node(val))
        elif field_no == 2 and wire == 2:  # name
            g.name = bytes(val).decode("utf-8", errors="replace")
        elif field_no == 5 and wire == 2:  # initializer
            name, arr = _parse_tensor(val)
            g.initializers[name] = arr
        elif field_no == 11 and wire == 2:  # input
            g.inputs.append(_parse_value_info(val))
        elif field_no == 12 and wire == 2:  # output
            g.outputs.append(_parse_value_info(val))
    return g


def _graph_body(path: str) -> memoryview:
    data = memoryview(open(path, "rb").read())
    for field_no, wire, val in _iter_fields(data):  # ModelProto
        if field_no == 7 and wire == 2:  # graph
            return val
    raise ValueError(f"{path}: no GraphProto found (not an ONNX model?)")


def load_onnx_graph(path: str) -> OnnxGraph:
    """Parse an ONNX file -> nodes (topological order) + initializers +
    input/output signatures."""
    return _parse_graph(_graph_body(path))


def load_onnx_metadata(path: str) -> Dict[str, str]:
    """ModelProto.metadata_props (field 14, StringStringEntryProto) ->
    {key: value}. sherpa-onnx exports store model hyperparameters here —
    whisper's sot/eot token ids, sot_sequence, n_mels, language token
    tables (reference: src/model.py:79-99 relies on sherpa-onnx reading
    exactly these keys to configure its recognizers)."""
    out: Dict[str, str] = {}
    data = memoryview(open(path, "rb").read())
    for field_no, wire, val in _iter_fields(data):  # ModelProto
        if field_no == 14 and wire == 2:
            k = v = ""
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    k = bytes(v2).decode("utf-8", errors="replace")
                elif f2 == 2 and w2 == 2:
                    v = bytes(v2).decode("utf-8", errors="replace")
            if k:
                out[k] = v
    return out


def load_onnx_weights(path: str) -> Dict[str, np.ndarray]:
    """Extract initializer tensors from an ONNX file -> {name: array}."""
    out: Dict[str, np.ndarray] = {}
    for field_no, wire, val in _iter_fields(_graph_body(path)):  # GraphProto
        if field_no == 5 and wire == 2:  # initializer (TensorProto)
            name, arr = _parse_tensor(val)
            out[name] = arr
    return out


def dequantize_int8(weights: Dict[str, np.ndarray], name: str) -> np.ndarray:
    """Dequantize `name` using its conventional scale/zero-point companions
    (ORT naming: <name>_scale / <name>_zero_point)."""
    w = weights[name]
    scale = weights.get(f"{name}_scale")
    zp = weights.get(f"{name}_zero_point")
    if scale is None:
        raise KeyError(f"no scale tensor for {name}")
    z = zp.astype(np.float32) if zp is not None else 0.0
    return (w.astype(np.float32) - z) * scale.astype(np.float32)
