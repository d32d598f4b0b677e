"""The eval half of the port's quality gate against the JAX package's, on
the CPU: both packages' train_world_pack are replaced by engines on shared
weights (the JAX build_world_engine(0) pack, carried across by
convert/from_jax), with the OSD head's overlap logit lifted so every
segment takes the overlap path (separation, per-branch SV, best-branch ASR
and the SI-SDR evaluation); then run_quality_gate(n_scenes=2) in both, at an
eval seed whose scenes pass the calibrated SV gate on these random weights
(their best-branch scores 5.5e-3 and 7e-3 above the threshold; at the
default seed neither does, and no record would be compared).

Held: the pipeline's records equal in kind, span and text; the calibrated
SV threshold within 1e-4; the SI-SDR fields within 1e-2 dB; the CER fields
exact; the artifact's keys equal JAX's.
"""
import json

import jax
import numpy as np
import pytest
import torch

import audio_classification_tpu.pipelines.offline_overlap3 as jax_pipeline
import audio_classification_tpu_torch.pipelines.offline_overlap3 as port_pipeline
import audio_classification_tpu_torch.pipelines.quality_gate as qg
from audio_classification_tpu.pipelines import quality_gate as jqg
from audio_classification_tpu_torch.convert.from_jax import params_to_state_dicts

torch.set_num_threads(2)
N_SCENES = 2
EVAL_SEED = 4
SISDR = ("sep_sisdr_mean", "sep_sisdri_mean")
CER = ("cer_mean", "cer_records", "cer_concat_mean", "cer_clean_mean", "cer_oracle_sep_mean")


def _recording_runs(monkeypatch, module, runs):
    """Keep every PipelineResult Overlap3Pipeline.run returns."""
    run = module.Overlap3Pipeline.run

    def recorded(self):
        result = run(self)
        runs.append(result)
        return result

    monkeypatch.setattr(module.Overlap3Pipeline, "run", recorded)


@pytest.fixture(scope="module")
def gates():
    mp = pytest.MonkeyPatch()
    try:
        jengine, jtokens = jqg.build_world_engine(0)
        # the overlap logit of OSDNet's head lifted: every frame overlapped
        params = jax.tree.map(np.asarray, jengine.pack.params)
        params["osd"]["params"]["head"]["bias"] = np.array([0.0, 30.0], np.float32)
        jengine.pack.load_params("osd", params["osd"])
        pengine, ptokens = qg.build_world_engine(0, device="cpu")
        pengine.pack.load_state_dicts(params_to_state_dicts(params))
        mp.setattr(jqg, "train_world_pack", lambda *a, **k: (jengine, jtokens, {}))
        mp.setattr(qg, "train_world_pack", lambda *a, **k: (pengine, ptokens, {}))
        jruns, pruns, jlog, plog = [], [], [], []
        _recording_runs(mp, jax_pipeline, jruns)
        _recording_runs(mp, port_pipeline, pruns)
        jm = jqg.run_quality_gate(n_scenes=N_SCENES, eval_seed=EVAL_SEED, log=jlog.append)
        pm = qg.run_quality_gate(n_scenes=N_SCENES, eval_seed=EVAL_SEED, log=plog.append,
                                 device="cpu")
    finally:
        mp.undo()
    return jm, pm, jruns, pruns, jlog, plog


def _records(result):
    return [(r["wav"].rsplit("/", 1)[-1], r["kind"], round(r["start"], 6),
             round(r["end"], 6), r["text"]) for r in sorted(result.segments,
                                                           key=lambda r: (r["wav"], r["start"]))]


def test_records_equal_jax(gates):
    """Cold and warm passes, in both packages: the same records (kind, span,
    text), every one an overlap segment, the warm pass equal to the cold."""
    _, _, jruns, pruns, jlog, plog = gates
    assert len(jruns) == len(pruns) == 2
    for j, p in zip(jruns, pruns):
        assert _records(p) == _records(j)
    recs = _records(pruns[1])
    assert len(recs) == N_SCENES and all(kind == "overlap" for _, kind, *_ in recs)
    assert _records(pruns[0]) == recs
    # the per-record log lines (truth, hypothesis, oracle hypothesis) too;
    # both print kind=clean for these overlap records: the JAX gate reads a
    # key ("is_overlap") the pipeline's records do not carry, and the port
    # prints what it prints
    rec_lines = [ln for ln in plog if ln.startswith("  rec ")]
    assert rec_lines and rec_lines == [ln for ln in jlog if ln.startswith("  rec ")]


def test_metrics_equal_jax(gates):
    jm, pm, *_ = gates
    assert abs(pm["sv_threshold_calibrated"] - jm["sv_threshold_calibrated"]) <= 1e-4
    for key in SISDR:
        assert jm[key] is not None and abs(pm[key] - jm[key]) <= 1e-2, key
    for key in CER:
        assert pm[key] == jm[key], key
    for key in ("target_hit_rate_segments", "segments_total", "n_scenes", "steps_scale",
                "restored_from_ckpt"):
        assert pm[key] == jm[key], key
    assert set(pm) == set(jm)
    assert "XLA" not in pm["pipeline_wall_note"] and "kernels" in pm["pipeline_wall_note"]


def test_artifact_keys_equal_jax(gates, tmp_path):
    jm, pm, *_ = gates
    jart = jqg.write_quality_json(jm, str(tmp_path / "jax.json"))
    part = qg.write_quality_json(pm, str(tmp_path / "port.json"), device="cpu")
    assert list(part) == list(jart)
    on_disk = json.loads((tmp_path / "port.json").read_text())
    assert on_disk == json.loads(json.dumps(part))
    assert (on_disk["backend"], on_disk["device"]) == ("cpu", "cpu")
    assert on_disk["quality_ok"] == jart["quality_ok"]
    assert on_disk["gates"] == jart["gates"]
    assert on_disk["frontend_evidence"].keys() == jart["frontend_evidence"].keys()
