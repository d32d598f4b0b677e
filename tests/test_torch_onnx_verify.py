"""cli/convert_models --verify (convert/verify) of the port over a
reference-layout model directory (tests/torch_onnx_helpers.
reference_model_dir: the tiny pack's speaker and VAD exports, a
sherpa-style SenseVoice dir, an asteroid Conv-TasNet checkpoint) against
the JAX harness on the same files and weights: every check passes, with
the JAX report's keys, check names and statuses. A checkpoint that cannot
import fails the run."""
import json

import pytest
import torch

import audio_classification_tpu.engine.runtime as jax_runtime
import audio_classification_tpu.pipelines.offline_overlap3 as jax_pipeline_mod
from audio_classification_tpu.models.convert import verify as jax_verify
from audio_classification_tpu_torch.cli import convert_models
from audio_classification_tpu_torch.convert.verify import discover_models
from audio_classification_tpu_torch.engine import ModelPack, tiny_preset
from test_torch_onnx_cli import CHARS
from torch_onnx_helpers import reference_model_dir, twin_pack_factory

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pack():
    return ModelPack(tiny_preset(), seed=0, device="cpu")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, pack):
    return reference_model_dir(tmp_path_factory.mktemp("reference_models"), pack, CHARS)


def test_verify_model_dir_reports_as_jax(model_dir, tmp_path, pack, monkeypatch, capsys):
    """convert_models --verify: every check of the reference-layout tree
    passes on the port (device vs host-folded exec, map vs direct for the
    speaker, SenseVoice and VAD, the asteroid import), with the JAX
    harness's report keys and check names."""
    out = tmp_path / "port.json"
    result = convert_models.main(["--verify", str(model_dir), "--verify-out", str(out),
                                  "--preset", "tiny", "--provider", "cpu"])
    assert result["ok"], result["checks"]
    assert {d.kind for d in discover_models(model_dir)} == \
        {"speaker", "vad", "sensevoice", "convtasnet3"}
    by = {(r["model"].split(":")[0], r["check"]): r for r in result["checks"]}
    for kind in ("speaker", "vad", "sensevoice"):
        assert by[(kind, "map_vs_direct")]["status"] == "pass", by[(kind, "map_vs_direct")]
        assert by[(kind, "exec_consistency[model]")]["status"] == "pass"
    assert by[("convtasnet3", "torch_import")]["status"] == "pass"
    assert "verify: OK" in capsys.readouterr().out
    monkeypatch.setattr(jax_runtime, "ModelPack", twin_pack_factory(pack))
    monkeypatch.setattr(jax_pipeline_mod, "ModelPack", twin_pack_factory(pack))
    ref = jax_verify.verify_model_dir(model_dir, tmp_path / "jax.json", preset="tiny")
    assert sorted(ref) == sorted(result)
    assert [(r["model"], r["check"]) for r in ref["checks"]] == \
        [(r["model"], r["check"]) for r in result["checks"]]
    for r, g in zip(ref["checks"], result["checks"]):
        assert r["status"] == g["status"] and sorted(r) == sorted(g), (r, g)
    assert json.loads(out.read_text())["ok"]


def test_verify_reports_failure(tmp_path):
    """A checkpoint that cannot import fails the run (exit code 1), the
    report carrying the diagnostic."""
    root = tmp_path / "models"
    root.mkdir()
    torch.save({"bogus.weight": torch.randn(3, 3)}, root / "mossformer_broken.bin")
    out = tmp_path / "verify.json"
    with pytest.raises(SystemExit):
        convert_models.main(["--verify", str(root), "--verify-out", str(out), "--preset",
                             "tiny", "--provider", "cpu"])
    report = json.loads(out.read_text())
    assert not report["ok"]
    assert any(r["status"] == "error" for r in report["checks"])
