"""The port's quality-gate CLI on its own, on the CPU: the plumbing run at
--steps-scale 0.01 (artifact schema and gate logic; a handful of steps
cannot pass the gates, so --no-gate-exit), then --ckpt-dir / --reuse-ckpt
restoring the very pack that training saved, and an orbax directory
refused with the converter's hint."""
import json
from pathlib import Path

import pytest
import torch

from audio_classification_tpu_torch.cli import quality_gate as cli
from audio_classification_tpu_torch.pipelines import quality_gate as qg
from audio_classification_tpu_torch.train.checkpoint import ORBAX_HINT

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def plumbing(tmp_path_factory):
    work = tmp_path_factory.mktemp("gate")
    out, ckpt = work / "QUALITY_smoke.json", work / "world_pack"
    artifact = cli.main(["--out", str(out), "--steps-scale", "0.01", "--scenes", "2",
                         "--no-gate-exit", "--provider", "cpu", "--ckpt-dir", str(ckpt)])
    return work, out, ckpt, artifact


def test_quality_gate_cli_plumbing(plumbing):
    _, out, _, artifact = plumbing
    on_disk = json.loads(out.read_text())
    assert on_disk["kind"] == "quality_gate"
    for key in ("quality_ok", "gates", "target_hit_rate_segments",
                "cer_mean", "cer_concat_mean", "sep_sisdr_mean",
                "sep_sisdri_mean", "sv_threshold_calibrated",
                "sep_final_loss", "osd_final_loss", "spk_final_loss", "asr_final_loss",
                "train_wall_sec", "pipeline_wall_sec", "pipeline_wall_cold_sec", "backend"):
        assert key in on_disk, key
    assert (on_disk["backend"], on_disk["device"]) == ("cpu", "cpu")
    # the keys of the JAX package's committed full-scale artifact, in order
    assert list(on_disk) == list(json.loads((REPO / "QUALITY_r05.json").read_text()))
    assert on_disk["n_scenes"] == 2 and on_disk["steps_scale"] == 0.01
    assert on_disk["restored_from_ckpt"] is False
    assert isinstance(on_disk["quality_ok"], bool)
    assert artifact["quality_ok"] == on_disk["quality_ok"]
    if on_disk["cer_mean"] is not None:
        assert 0.0 <= on_disk["cer_mean"] <= 1.5


def test_reuse_ckpt_restores_the_saved_pack(plumbing):
    """The saved pack restores stage by stage, bit for bit, with the losses
    file beside it; --reuse-ckpt then skips training and reports them."""
    work, out, ckpt, artifact = plumbing
    losses = json.loads((work / "world_pack.losses.json").read_text())
    assert set(losses) == {"sep_final_loss", "osd_final_loss", "spk_final_loss",
                           "asr_final_loss", "train_wall_sec"}
    restored, _ = qg.build_world_engine(0, str(ckpt), device="cpu")
    seeded, _ = qg.build_world_engine(0, device="cpu")
    saved = torch.load(ckpt / "pack.pt", weights_only=True)
    for stage in ("sep3", "osd", "spk", "asr"):
        for name, v in restored.pack.models[stage].state_dict().items():
            assert torch.equal(v, saved[stage][name]), (stage, name)
    # the four trained stages moved away from the seed init
    for stage in ("sep3", "osd", "spk", "asr"):
        a = restored.pack.models[stage].state_dict()
        b = seeded.pack.models[stage].state_dict()
        assert any(not torch.equal(a[k], b[k]) for k in a), stage
    again = cli.main(["--out", str(work / "again.json"), "--scenes", "2", "--no-gate-exit",
                      "--provider", "cpu", "--ckpt-dir", str(ckpt), "--reuse-ckpt"])
    assert again["restored_from_ckpt"] is True
    for key in ("sep_final_loss", "asr_final_loss"):
        assert again[key] == round(losses[key], 4) == artifact[key]
    for key in ("target_hit_rate_segments", "cer_mean", "sv_threshold_calibrated",
                "sep_sisdr_mean"):
        assert again[key] == artifact[key], key


def test_orbax_world_pack_raises_with_the_hint(tmp_path):
    (tmp_path / "_CHECKPOINT_METADATA").write_text("{}")  # what orbax writes
    with pytest.raises(NotImplementedError, match="orbax_to_torch"):
        qg.build_world_engine(0, str(tmp_path), device="cpu")
    assert "orbax_to_torch" in ORBAX_HINT
