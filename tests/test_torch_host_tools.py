"""PyTorch port vs the JAX package: the small host CLIs (batch_eval,
mix_wavs, split_speakers, generate_speaker_list, version) and
utils/profiling (trace, the engine's stage ranges). Each CLI
runs in both packages on the same seeded files; their outputs are compared
as files or JSON (CPU)."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_classification_tpu.audio_io import read_wav as jax_read_wav
from audio_classification_tpu.cli import batch_eval as jax_batch_eval
from audio_classification_tpu.cli import generate_speaker_list as jax_gen_list
from audio_classification_tpu.cli import mix_wavs as jax_mix_wavs
from audio_classification_tpu.cli import split_speakers as jax_split
from audio_classification_tpu_torch.audio_io import write_wav
from audio_classification_tpu_torch.cli import (
    batch_eval,
    generate_speaker_list,
    mix_wavs,
    split_speakers,
    version,
)
from audio_classification_tpu_torch.engine import ModelPack, StageEngine, tiny_preset
from audio_classification_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
SR = 16000


def _noise(seed, n, amp=0.3):
    return (amp * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


_METRIC_FIELDS = ("rtf_total", "rtf_asr", "time_compute_total_sec", "time_osd_sec",
                  "time_sep_sec", "time_asr_sec", "sep_sisdr_mean", "sep_sisdri_mean", "cpu_avg",
                  "rss_avg_mb", "total_audio_sec", "audio_overlap_sec")


def test_batch_eval_matches_jax(tmp_path):
    """batch_analysis.json and the report .txt byte-equal to the JAX CLI's
    over seeded run dirs (one with zero fields the aggregator drops, one
    without metrics.json)."""
    rng = np.random.default_rng(0)
    runs = tmp_path / "runs"
    for i in range(4):
        d = runs / f"2026-01-0{i + 1}_00-00-00"
        d.mkdir(parents=True)
        if i == 3:
            continue
        m = {k: float(rng.uniform(0.1, 10.0)) for k in _METRIC_FIELDS}
        m["target_hit_rate_segments"] = 0.0 if i == 1 else float(rng.uniform())
        m["segments_total"] = int(rng.integers(1, 20))
        (d / "metrics.json").write_text(json.dumps(m))
    for name, mod in (("jax", jax_batch_eval), ("torch", batch_eval)):
        mod.main(["--results-dir", str(runs), "--output", str(tmp_path / f"{name}.json")])
    for suffix in (".json", ".txt"):
        assert (tmp_path / f"torch{suffix}").read_bytes() == \
            (tmp_path / f"jax{suffix}").read_bytes()
    assert json.loads((tmp_path / "torch.json").read_text())["total_results"] == 3


@pytest.mark.parametrize("spec", [
    dict(offsets="0,0.25,0.5", snr="0,3,6"),
    dict(offsets="0.1", gains_db="-3,0,2"),
    dict(offsets="", snr="", gains_db=""),
])
def test_mix_wavs_matches_jax(tmp_path, spec):
    """16 kHz sources: the mixture files byte-equal. With one 8 kHz source
    (resampled on the way in by each package's resampler, ~2e-7 apart) the
    decoded samples within one int16 step, and the lengths equal."""
    paths = []
    for i, n in enumerate((16000, 12000, 20000)):
        paths.append(tmp_path / f"src{i}.wav")
        write_wav(paths[-1], _noise(i, n), SR)
    low = tmp_path / "src_8k.wav"
    write_wav(low, _noise(7, 6000), 8000)
    for inputs, exact in ((paths, True), ([paths[0], low, paths[2]], False)):
        outs = {}
        for name, mod in (("jax", jax_mix_wavs), ("torch", mix_wavs)):
            out = tmp_path / f"{name}_{exact}.wav"
            argv = [*map(str, inputs), "--out", str(out)]
            for key, flag in (("offsets", "--offsets"), ("snr", "--snr"),
                              ("gains_db", "--gains-db")):
                if spec.get(key):
                    argv.append(f"{flag}={spec[key]}")
            res = mod.main(argv + (["--provider", "cpu"] if name == "torch" else []))
            outs[name] = (out, res)
        (jo, _), (to, res) = outs["jax"], outs["torch"]
        if exact:
            assert to.read_bytes() == jo.read_bytes()
        else:
            a, b = jax_read_wav(str(jo))[0], jax_read_wav(str(to))[0]
            assert a.shape == b.shape and np.abs(a - b).max() <= 1.0 / 32768 + 1e-9
        assert res.num_samples == len(jax_read_wav(str(jo))[0])


def test_mix_wavs_library_call_matches_jax(tmp_path):
    """``mix`` as a function: MixResult fields equal to the JAX result's."""
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"s{i}.wav"))
        write_wav(paths[-1], _noise(10 + i, 8000, amp=0.9), SR)
    want = jax_mix_wavs.mix(paths, str(tmp_path / "a.wav"), offsets=[0.0, 0.2],
                            snr_dbs=[0.0, -6.0])
    got = mix_wavs.mix(paths, str(tmp_path / "b.wav"), offsets=[0.0, 0.2], snr_dbs=[0.0, -6.0],
                       device="cpu")
    assert (got.sample_rate, got.num_samples) == (want.sample_rate, want.num_samples)
    assert got.peak_before_limit == want.peak_before_limit > 0.98
    assert got.limiter_gain == want.limiter_gain
    np.testing.assert_array_equal(got.scales, want.scales)
    with pytest.raises(ValueError, match="either --snr or --gains-db"):
        mix_wavs.mix(paths, str(tmp_path / "c.wav"), snr_dbs=[0, 1], gains_db=[0, 1],
                     device="cpu")


@pytest.mark.parametrize("mode", ["utterance", "speaker"])
@pytest.mark.parametrize("seed,ratio", [(42, 0.8), (7, 0.5), (3, 0.05)])
def test_split_speakers_matches_jax(tmp_path, mode, seed, ratio):
    """The same --seed gives the same split: train and test files equal."""
    rng = np.random.default_rng(seed)
    lines = [f"spk{s} /data/spk{s}/utt{u}.wav" for s in range(6)
             for u in range(int(rng.integers(1, 5)))]
    rng.shuffle(lines)
    src = tmp_path / "speaker.txt"
    src.write_text("\n".join(lines) + "\n")
    for name, mod in (("jax", jax_split), ("torch", split_speakers)):
        mod.main(["--input", str(src), "--train-out", str(tmp_path / f"{name}_train.txt"),
                  "--test-out", str(tmp_path / f"{name}_test.txt"), "--seed", str(seed),
                  "--train-ratio", str(ratio), "--mode", mode])
    for part in ("train", "test"):
        assert (tmp_path / f"torch_{part}.txt").read_text() == \
            (tmp_path / f"jax_{part}.txt").read_text()
    assert (tmp_path / "torch_test.txt").read_text().strip()


def test_generate_speaker_list_matches_jax(tmp_path):
    root = tmp_path / "data"
    for spk, n in (("alice", 2), ("bob", 3), ("carol", 1)):
        for u in range(n):
            sub = root / spk / ("deep" if u == 2 else "")
            sub.mkdir(parents=True, exist_ok=True)
            (sub / f"u{u}.wav").write_bytes(b"")
    (root / "notes.txt").write_text("not a speaker")
    for name, mod in (("jax", jax_gen_list), ("torch", generate_speaker_list)):
        mod.main([str(root), "--out", str(tmp_path / f"{name}.txt")])
    text = (tmp_path / "torch.txt").read_text()
    assert text == (tmp_path / "jax.txt").read_text() and len(text.splitlines()) == 6


def test_version_prints_without_jax_or_a_build():
    """The version CLI in a fresh interpreter: every field printed, no JAX
    module imported, no library built (none is on a tree nvcc never ran on)."""
    code = ("import sys; from audio_classification_tpu_torch.cli import version; "
            "info = version.main(); "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'audio_classification_tpu.')) "
            "for m in sys.modules), 'jax imported'")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    keys = [line.split(":", 1)[0].strip() for line in out.stdout.splitlines()]
    assert keys == ["python", "framework", "numpy", "torch", "torch CUDA", "devices", "nvcc",
                    "kernel library"]
    info = version.main()
    assert info["torch"] == torch.__version__


def test_trace_is_a_no_op_without_a_directory(tmp_path):
    with profiling.trace(""):
        x = torch.ones(3) * 2
    with profiling.trace(None):
        x = x + 1
    assert x.tolist() == [3.0, 3.0, 3.0] and not list(tmp_path.iterdir())


def test_trace_writes_a_chrome_trace_with_the_stage_ranges(tmp_path):
    """A CPU trace of engine stages: one JSON file in the directory, whose
    events name the stage programs that ran (engine.osd, engine.overlap,
    engine.clean, engine.asr)."""
    eng = StageEngine(ModelPack(tiny_preset(), seed=0, device="cpu"))
    wav = _noise(1, SR)
    vec = eng.embed([wav])[0]
    with profiling.trace(str(tmp_path / "prof")):
        eng.osd_segments(wav, SR, 0.5, 0.5, 0.1)
        eng.collect_overlap(eng.launch_overlap([wav], [vec]), [wav])
        eng.collect_clean(eng.launch_clean([wav], [vec]))
        eng.transcribe([wav])
    files = list((tmp_path / "prof").glob("torch_trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert {"engine.osd", "engine.overlap", "engine.clean", "engine.asr"} <= names
