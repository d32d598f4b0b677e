"""The port's protobuf reader (audio_classification_tpu_torch/convert/
onnx_import) against the JAX package's (models/convert/onnx_import): every
graph the port's ONNX tests build (the executor's cases, the graph-aware
importer's fixtures, a whisper pair with metadata, the exporters' int8 and
QDQ SenseVoice) parses to equal structures: nodes (op, name, inputs,
outputs, attributes, subgraphs), initializers byte for byte, value infos,
metadata; and ``load_onnx_weights`` / ``dequantize_int8`` agree."""
import numpy as np
import pytest

from audio_classification_tpu.models.convert import onnx_import as jax_import
from audio_classification_tpu_torch.convert import onnx_export
from audio_classification_tpu_torch.convert import onnx_import as port_import
from audio_classification_tpu_torch.convert.from_jax import state_dict_to_variables
from audio_classification_tpu_torch.models.asr.sensevoice import SenseVoiceConfig, SenseVoiceEncoder
from audio_classification_tpu_torch.train.trainer import flax_init_
from test_torch_onnx_exec import CASES
from test_torch_onnx_graph_map import FIXTURES, build_fixture
from torch_onnx_helpers import whisper_pair


def _same(a, b, where="graph"):
    """Deep equality of two parsed values (graphs, nodes, arrays, lists)."""
    if isinstance(a, jax_import.OnnxGraph):
        assert isinstance(b, port_import.OnnxGraph), where
        assert a.name == b.name, where
        assert [(v.name, v.dtype, v.shape) for v in a.inputs] == \
            [(v.name, v.dtype, v.shape) for v in b.inputs], where
        assert [(v.name, v.dtype, v.shape) for v in a.outputs] == \
            [(v.name, v.dtype, v.shape) for v in b.outputs], where
        assert list(a.initializers) == list(b.initializers), where
        for k in a.initializers:
            _same(a.initializers[k], b.initializers[k], f"{where}/{k}")
        assert len(a.nodes) == len(b.nodes), where
        for i, (na, nb) in enumerate(zip(a.nodes, b.nodes)):
            w = f"{where}/node{i}:{na.op_type}"
            assert (na.op_type, na.name, na.inputs, na.outputs) == \
                (nb.op_type, nb.name, nb.inputs, nb.outputs), w
            assert list(na.attrs) == list(nb.attrs), w
            for k in na.attrs:
                _same(na.attrs[k], nb.attrs[k], f"{w}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for x, y in zip(a, b):
            _same(x, y, where)
    else:
        assert type(a) is type(b) and a == b, where


def _graphs(tmp_path):
    for name, fn in CASES.items():
        p = tmp_path / f"exec-{name}.onnx"
        p.write_bytes(fn()[0])
        yield str(p)
    for name in FIXTURES:
        p = tmp_path / f"map-{name}.onnx"
        build_fixture(name, p)
        yield str(p)
    yield from whisper_pair(tmp_path, np.random.RandomState(0), metadata={"eot": "7"})
    cfg = SenseVoiceConfig(vocab_size=16, dim=16, heads=2, layers=1, conv_kernel=3)
    tree = state_dict_to_variables(flax_init_(SenseVoiceEncoder(cfg), 0))
    for quant in ("int8", "qdq"):
        p = str(tmp_path / f"sv-{quant}.onnx")
        onnx_export.export_sensevoice(tree, cfg, p, frames=6, quant=quant)
        yield p


def test_every_test_graph_parses_to_equal_structures(tmp_path):
    paths = list(_graphs(tmp_path))
    assert len(paths) > 150
    for path in paths:
        _same(jax_import.load_onnx_graph(path), port_import.load_onnx_graph(path), path)
        assert jax_import.load_onnx_metadata(path) == port_import.load_onnx_metadata(path)
        a, b = jax_import.load_onnx_weights(path), port_import.load_onnx_weights(path)
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k], f"{path}:{k}")


def test_dequantize_int8_and_garbage_input(tmp_path):
    rng = np.random.default_rng(1)
    w = {"w": rng.integers(-127, 127, (4, 5), dtype=np.int8),
         "w_scale": np.float32(0.02), "w_zero_point": np.int8(3)}
    np.testing.assert_array_equal(port_import.dequantize_int8(w, "w"),
                                  jax_import.dequantize_int8(w, "w"))
    with pytest.raises(KeyError):
        port_import.dequantize_int8({"v": w["w"]}, "v")
    bad = tmp_path / "bad.onnx"
    bad.write_bytes(b"\x08\x01\x12\x00")
    for mod in (jax_import, port_import):
        with pytest.raises(ValueError, match="no GraphProto"):
            mod.load_onnx_graph(str(bad))
