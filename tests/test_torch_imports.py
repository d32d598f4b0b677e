"""The port stands alone: no module of audio_classification_tpu_torch, and
not chip_smoke.py, imports jax, flax, optax, orbax or the JAX package, and
none of their code strings reaches into the JAX package's directory."""
import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "audio_classification_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "flax", "optax", "orbax", "audio_classification_tpu")
JAX_PACKAGE = re.compile(r"audio_classification_tpu(?!_torch)")
# the one allowed mention in code: a "file.py:line" citation of the TPU kernel
# a CUDA kernel replaces (chip_smoke.py's kernel table)
CITATION = re.compile(r"^audio_classification_tpu/[\w/]+\.py:\d+$")


def _docstrings(tree) -> set:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                out.add(id(body[0].value))
    return out


def test_walks_the_whole_port():
    assert len(FILES) >= 45 and (REPO / "chip_smoke.py") in FILES


def test_walks_the_training_slice():
    """The training package and the training CLIs are among the files held."""
    port = REPO / "audio_classification_tpu_torch"
    want = [port / "train" / f"{m}.py" for m in ("losses", "trainer", "checkpoint", "data")]
    want += [port / "cli" / f"train_{m}.py" for m in ("separator", "asr", "speaker")]
    assert all(p in FILES for p in want)


def test_walks_the_quality_gate_slice():
    """The quality gate, distill_osd, the native codecs' loaders and their
    build are among the files held; the C++ sources are the port's own."""
    port = REPO / "audio_classification_tpu_torch"
    want = [port / "pipelines" / "quality_gate.py", port / "cli" / "quality_gate.py",
            port / "cli" / "distill_osd.py", port / "audio_io" / "wav.py",
            port / "audio_io" / "stream_buffer.py", port / "_build.py"]
    assert all(p in FILES for p in want)
    for name in ("wavcodec", "ringbuffer"):
        assert (port / "native" / f"{name}.cpp").is_file()


def test_walks_the_onnx_slice():
    """The ONNX reader, executor, graph-aware importer, stages, exporters and
    verification harness, and the ONNX CLIs, are among the files held: the
    port's own copies, numpy-only ones included."""
    port = REPO / "audio_classification_tpu_torch"
    want = [port / "convert" / f"{m}.py" for m in ("onnx_import", "onnx_exec", "onnx_graph_map",
                                                   "onnx_stage", "onnx_export", "verify")]
    want += [port / "cli" / f"{m}.py" for m in ("convert_models", "export_models",
                                                "distill_asr")]
    assert all(p in FILES for p in want)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_and_no_path_into_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    doc = _docstrings(tree)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"
        if isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", "")) \
                in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            assert str(node.args[0].value).split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno}"
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in doc:
            if JAX_PACKAGE.search(node.value) and not CITATION.match(node.value):
                raise AssertionError(f"{path}:{node.lineno} names the JAX package in code: "
                                     f"{node.value!r}")
