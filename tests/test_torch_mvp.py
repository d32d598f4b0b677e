"""The second slice of the port against the JAX package, end to end on the
CPU (tiny preset, float32, the same converted weights, synthetic LibriMix
trees at 8 kHz written here): the flagship pipeline with the MossFormer
backend, separation evaluation, the resource monitor and dataset mode; the
2-source MVP runner for both backends; the source evaluator; the MossFormer
demo; the facades."""
import csv
import json
import types

import numpy as np
import pytest
import torch

from audio_classification_tpu.cli import evaluate_with_sources as jax_evaluate
from audio_classification_tpu.cli import mossformer_infer as jax_mossformer_infer
from audio_classification_tpu.cli import offline_overlap_mvp as jax_mvp
from audio_classification_tpu.engine import BucketSpec as JaxBucketSpec
from audio_classification_tpu.engine import ModelPack as JaxModelPack
from audio_classification_tpu.engine import StageEngine as JaxStageEngine
from audio_classification_tpu.engine import default_buckets as jax_default_buckets
from audio_classification_tpu.engine import tiny_preset as jax_tiny_preset
from audio_classification_tpu.models import facades as jax_facades
from audio_classification_tpu.pipelines.offline_overlap3 import Overlap3Pipeline as JaxPipeline
from audio_classification_tpu.utils.config import Overlap3Config as JaxConfig
from audio_classification_tpu_torch.audio_io import read_wav, write_wav
from audio_classification_tpu_torch.cli import (
    evaluate_with_sources,
    mossformer_infer,
    offline_overlap_3src,
    offline_overlap_mvp,
)
from audio_classification_tpu_torch.convert.from_jax import params_to_state_dicts
from audio_classification_tpu_torch.data import Libri2Mix8kDataset, LibriMixDataset
from audio_classification_tpu_torch.engine import BucketSpec, ModelPack, StageEngine, tiny_preset
from audio_classification_tpu_torch.engine.bucketing import default_buckets
from audio_classification_tpu_torch.models import facades
from audio_classification_tpu_torch.pipelines.offline_overlap3 import Overlap3Pipeline
from audio_classification_tpu_torch.utils.config import Overlap3Config

torch.set_num_threads(2)
SR8 = 8000
# Texts are compared exactly after both packages resample 8 kHz audio; the
# two resamplers agree to ~2e-7, which flips a few int16 samples by one step,
# and the random tiny recognizer turns that into another token only where two
# of its logits nearly tie. Seed 0's noise holds one such tie; this one none.
FIXTURE_SEED = 1
TIMING = ("time_", "rtf_", "share_", "cpu_", "rss_", "gpu_", "elapsed")


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's, on the same tiny weights and buckets."""
    jax_pack = JaxModelPack(jax_tiny_preset(), seed=0)
    pack = ModelPack(tiny_preset(), seed=1, device="cpu")  # every weight is overwritten
    pack.load_state_dicts(params_to_state_dicts(
        {k: jax_pack.params[k] for k in ModelPack.STAGES}))
    jax_eng = JaxStageEngine(jax_pack, JaxBucketSpec(jax_default_buckets(16000, 0.5, 4.0), 4))
    eng = StageEngine(pack, BucketSpec(default_buckets(16000, 0.5, 4.0), 4))
    return jax_eng, eng


def _tone(n, hz, lo, hi, rng, amp=0.3):
    t = np.arange(n) / SR8
    gate = (t >= lo) & (t < hi)
    return (amp * np.sin(2 * np.pi * hz * t) * gate + 0.004 * rng.standard_normal(n)).astype(
        np.float32)


@pytest.fixture(scope="module")
def librimix_root(tmp_path_factory):
    """Libri2Mix and Libri3Mix 'test' splits at 8 kHz, two mixtures each,
    sources overlapping in the middle of every mixture."""
    root = tmp_path_factory.mktemp("torch_librimix")
    rng = np.random.default_rng(FIXTURE_SEED)
    for n_spk in (2, 3):
        base = root / f"Libri{n_spk}Mix" / "wav8k" / "min" / "test"
        for sub in ["mix_clean"] + [f"s{i + 1}" for i in range(n_spk)]:
            (base / sub).mkdir(parents=True)
        for m in range(2):
            n = 2 * SR8 + 1500 * m
            srcs = [_tone(n, 180 + 90 * i + 25 * m, 0.3 * i, 1.4 + 0.3 * i, rng)
                    for i in range(n_spk)]
            for i, s in enumerate(srcs):
                write_wav(base / f"s{i + 1}" / f"mix{m}.wav", s, SR8)
            write_wav(base / "mix_clean" / f"mix{m}.wav", np.sum(srcs, axis=0), SR8)
    return root


def _assert_records_equal(got, ref):
    assert len(got) == len(ref) >= 1
    for g, r in zip(got, ref):
        for key in ("wav", "kind", "start", "end", "stream", "text", "target_src",
                    "target_src_text"):
            assert g[key] == r[key], key
        assert abs(g["sv_score"] - r["sv_score"]) <= 1e-4 + 1e-9


def _assert_metrics_equal(got, ref, tol=1e-2):
    """Non-timing fields: counts and durations exact, SI-SDR statistics in dB
    within ``tol`` (float32 branches that differ by ~1e-6). The monitor's
    fields are there only if the run outlasted one sampling interval, so they
    are held to the reference's key names and not required."""
    def plain(m):
        return {k for k in m if not k.startswith(TIMING)}

    assert plain(got) == plain(ref)
    assert {k for k in got if k.startswith(("cpu_", "rss_", "gpu_"))} <= {
        "cpu_avg", "cpu_peak", "rss_avg_mb", "rss_peak_mb", "gpu_mem_allocated_avg_mb",
        "gpu_mem_allocated_peak_mb", "gpu_mem_reserved_peak_mb"}
    for key, r in ref.items():
        if key.startswith(TIMING):
            continue
        if isinstance(r, float) and key.startswith("sep_"):
            assert abs(got[key] - r) <= tol, key
        else:
            assert got[key] == r, key


@pytest.mark.parametrize("osd_thr,kind", [(0.0, "overlap"), (1.0, "clean")])
def test_mossformer_file_mode_matches_jax(engines, librimix_root, osd_thr, kind):
    """File mode on an 8 kHz Libri2Mix mixture (resampled on the way in) with
    sep_backend="mossformer", eval_separation against the two reference
    sources and enable_metrics, both forced scenes."""
    jax_eng, eng = engines
    base = librimix_root / "Libri2Mix" / "wav8k" / "min" / "test"
    kw = dict(input_wavs=[str(base / "mix_clean" / "mix0.wav")],
              target_wav=str(base / "s1" / "mix0.wav"),
              ref_wavs=[str(base / "s1" / "mix0.wav"), str(base / "s2" / "mix0.wav")],
              preset="tiny", seed=0, sv_threshold=-1.0, max_batch=4, max_segment_sec=4.0,
              osd_thr=osd_thr, sep_backend="mossformer", eval_separation=True,
              enable_metrics=True, monitor_interval=0.1)
    ref = JaxPipeline(JaxConfig(**kw), engine=jax_eng).run()
    got = Overlap3Pipeline(Overlap3Config(**kw), engine=eng).run()
    _assert_records_equal(got.segments, ref.segments)
    assert all(s["kind"] == kind for s in got.segments)
    if kind == "overlap":
        assert all(s["stream"] in (0, 1) for s in got.segments)  # MossFormer has 2 branches
        assert got.metrics["sep_eval_segments"] == ref.metrics["sep_eval_segments"] >= 1
        assert len(got.sep_details_rows) == len(ref.sep_details_rows) >= 1
        for g, r in zip(got.sep_details_rows, ref.sep_details_rows):
            assert g[:4] == r[:4] and g[6] == r[6]
            assert abs(float(g[4]) - float(r[4])) <= 1e-2 and abs(float(g[5]) - float(r[5])) <= 1e-2
    _assert_metrics_equal(got.metrics, ref.metrics)


@pytest.mark.parametrize("backend", ["convtasnet", "mossformer"])
def test_dataset_mode_matches_jax(engines, librimix_root, backend):
    """Dataset mode over the Libri3Mix split at 8 kHz: the seeded random
    target pick, wave-batched resampling of mixtures and sources, separation
    evaluation against the dataset's sources (K = 3 needs three branches, so
    MossFormer's two give no SI-SDR rows, as in the reference)."""
    jax_eng, eng = engines
    kw = dict(librimix_root=str(librimix_root), sample_rate=8000, preset="tiny", seed=3,
              sv_threshold=-1.0, max_batch=4, max_segment_sec=4.0, osd_thr=0.0,
              sep_backend=backend, eval_separation=True)
    ref = JaxPipeline(JaxConfig(**kw), engine=jax_eng).run()
    got = Overlap3Pipeline(Overlap3Config(**kw), engine=eng).run()
    _assert_records_equal(got.segments, ref.segments)
    assert got.dataset_name == ref.dataset_name == "LibriMix"
    assert got.processed_mixtures == ref.processed_mixtures == 2
    assert [r[:4] for r in got.sep_details_rows] == [r[:4] for r in ref.sep_details_rows]
    if backend == "convtasnet":
        assert got.metrics["sep_eval_segments"] >= 1
    _assert_metrics_equal(got.metrics, ref.metrics)


def test_flagship_cli_dataset_mode_writes_artifacts(librimix_root, tmp_path):
    out_dir, result = offline_overlap_3src.main([
        "--librimix-root", str(librimix_root), "--sample-rate", "8000", "--preset", "tiny",
        "--provider", "cpu", "--seed", "0", "--sv-threshold", "-1", "--osd-thr", "0.0",
        "--sep-backend", "mossformer", "--eval-separation", "--save-sep-details",
        "--enable-metrics", "--max-segment-sec", "4", "--out-dir", str(tmp_path)])
    metrics = json.loads((out_dir / "metrics.json").read_text())
    assert metrics["segments_total"] == result.metrics["segments_total"] >= 1
    assert "sep_eval_segments" in metrics and (out_dir / "overlap_sep_details.csv").is_file()
    assert json.loads((out_dir / "summary.json").read_text())["dataset"] == "LibriMix"


def _rows(path):
    with path.open(newline="", encoding="utf-8") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("backend,osd_thr", [("convtasnet", "0.0"), ("mossformer", "0.0"),
                                             ("convtasnet", "1.0")])
def test_overlap_mvp_cli_matches_jax(engines, librimix_root, tmp_path, monkeypatch, backend,
                                     osd_thr):
    """offline_overlap_mvp over the Libri2Mix split (8 kHz -> 16 kHz, OSD,
    2-source separation, ASR on both branches; threshold 0.0 makes every
    segment overlap, 1.0 every segment clean): CSV rows and JSONL records
    equal the JAX runner's apart from asr_time; non-timing metrics equal."""
    jax_eng, eng = engines
    monkeypatch.setattr(jax_mvp, "build_engine", lambda args: jax_eng)
    monkeypatch.setattr(offline_overlap_mvp, "build_engine", lambda args: eng)
    outs = {}
    for name, mod in (("jax", jax_mvp), ("torch", offline_overlap_mvp)):
        argv = ["--librimix-root", str(librimix_root), "--preset", "tiny", "--osd-thr", osd_thr,
                "--sep-backend", backend, "--enable-metrics", "--monitor-interval", "0.1",
                "--out-dir", str(tmp_path / name)]
        mod.main(argv + (["--provider", "cpu"] if name == "torch" else []))
        (outs[name],) = list((tmp_path / name).iterdir())
    ref_rows, got_rows = (_rows(outs[k] / "segments.csv") for k in ("jax", "torch"))
    assert len(got_rows) == len(ref_rows) >= 3
    assert [r[:6] for r in got_rows] == [r[:6] for r in ref_rows]  # all but asr_time
    assert {r[3] for r in got_rows[1:]} == {"overlap" if osd_thr == "0.0" else "clean"}
    recs = {k: [json.loads(x) for x in (outs[k] / "segments.jsonl").read_text().splitlines()]
            for k in outs}
    for g, r in zip(recs["torch"], recs["jax"]):
        g.pop("asr_time"), r.pop("asr_time")
        assert g == r
    _assert_metrics_equal(json.loads((outs["torch"] / "metrics.json").read_text()),
                          json.loads((outs["jax"] / "metrics.json").read_text()))
    summary = json.loads((outs["torch"] / "summary.json").read_text())
    assert summary["dataset"] == "Libri2Mix_8k" and summary["processed_mixtures"] == 2


def test_overlap_mvp_cli_builds_its_engine_on_the_cpu_when_asked(librimix_root, tmp_path):
    out_dir, metrics = offline_overlap_mvp.main([
        "--librimix-root", str(librimix_root), "--preset", "tiny", "--provider", "cpu",
        "--osd-thr", "0.0", "--sep-backend", "mossformer", "--max-files", "1",
        "--max-segment-sec", "4", "--out-dir", str(tmp_path)])
    assert metrics["segments_overlap_streams"] >= 2 and (out_dir / "summary.json").is_file()
    orbax = tmp_path / "orbax"  # a directory an orbax checkpointer wrote
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="not ported"):
        offline_overlap_mvp.main(["--librimix-root", str(librimix_root), "--preset", "tiny",
                                  "--provider", "cpu", "--checkpoint-dir", str(orbax),
                                  "--out-dir", str(tmp_path)])


@pytest.mark.parametrize("backend,nsrc", [("convtasnet", 2), ("mossformer", 2), ("convtasnet", 3)])
def test_evaluate_with_sources_cli_matches_jax(engines, librimix_root, tmp_path, monkeypatch,
                                               backend, nsrc):
    """evaluation.json: OSD frame counts, precision / recall / F1 / IoU and
    the ASR aggregates equal the JAX evaluator's; SI-SDR statistics within
    1e-2 dB; detail rows equal apart from the dB columns (3 decimals, within
    0.011)."""
    jax_eng, eng = engines
    monkeypatch.setattr(jax_evaluate, "build_engine", lambda args: jax_eng)
    monkeypatch.setattr(evaluate_with_sources, "build_engine", lambda args: eng)
    outs = {}
    for name, mod in (("jax", jax_evaluate), ("torch", evaluate_with_sources)):
        argv = ["--librimix-root", str(librimix_root), "--preset", "tiny", "--osd-thr", "0.0",
                "--sep-backend", backend, "--sep-nsrc", str(nsrc), "--save-details",
                "--enable-asr", "--out-dir", str(tmp_path / name)]
        mod.main(argv + (["--provider", "cpu"] if name == "torch" else []))
        (outs[name],) = list((tmp_path / name).iterdir())
    got, ref = (json.loads((outs[k] / "evaluation.json").read_text()) for k in ("torch", "jax"))
    for key in ("dataset", "files_limit", "hop_sec", "win_sec", "sep_nsrc", "activity_thr",
                "min_overlap_dur", "gt_overlap_total_sec", "pred_overlap_total_sec",
                "audio_total_sec", "osd", "asr", "notes"):
        assert got[key] == ref[key], key
    assert set(got["timing"]) == set(ref["timing"])
    # the CPU report's averages are there only if the run outlasted one sample
    assert got["cpu"]["enabled"] is True and set(got["cpu"]) <= {
        "enabled", "count", "cpu_avg_percent", "cpu_avg_percent_raw", "cpu_peak_percent",
        "cpu_peak_percent_raw", "interval_sec", "cpu_logical_cores", "normalized"}
    for stat in ("si_sdr", "si_sdri"):
        g, r = got["separation"][stat], ref["separation"][stat]
        assert g["count"] == r["count"] >= 1
        for k in r:
            assert abs(g[k] - r[k]) <= 1e-2, (stat, k)
    got_rows, ref_rows = (_rows(outs[k] / "overlap_details.csv") for k in ("torch", "jax"))
    assert len(got_rows) == len(ref_rows) >= 2
    for g, r in zip(got_rows[1:], ref_rows[1:]):
        assert g[:4] == r[:4] and g[6:] == r[6:]
        assert abs(float(g[4]) - float(r[4])) <= 0.011 and abs(float(g[5]) - float(r[5])) <= 0.011


def test_mossformer_infer_cli_matches_jax(engines, librimix_root, tmp_path):
    """One 8 kHz wav at MossFormer's native rate -> int16 branch wavs equal
    to the JAX demo's within one int16 step (the two codecs round a float32
    that differs by ~1e-7 to the nearest of 2^16 levels)."""
    jax_eng, eng = engines
    wav = librimix_root / "Libri2Mix" / "wav8k" / "min" / "test" / "mix_clean" / "mix1.wav"
    jax_facades.set_default_engine(jax_eng)
    facades.set_default_engine(eng)
    try:
        jax_mossformer_infer.main([str(wav), "--out-dir", str(tmp_path / "jax"),
                                   "--preset", "tiny"])
        written = mossformer_infer.main([str(wav), "--out-dir", str(tmp_path / "torch"),
                                         "--preset", "tiny", "--provider", "cpu"])
    finally:
        jax_facades.set_default_engine(None)
        facades.set_default_engine(None)
    assert [p.name for p in written] == ["mix1_spk0.wav", "mix1_spk1.wav"]
    for p in written:
        got, sr = read_wav(p)
        ref, ref_sr = read_wav(tmp_path / "jax" / p.name)
        assert sr == ref_sr == 8000 and got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1.0 / 32767 + 1e-7
        assert np.abs(got).max() > 0


def test_facades_match_jax(engines, librimix_root):
    jax_eng, eng = engines
    rng = np.random.default_rng(5)
    wav8 = (0.2 * rng.standard_normal(9000)).astype(np.float32)
    ana, jana = (m.OverlapAnalyzer(threshold=0.4, engine=e)
                 for m, e in ((facades, eng), (jax_facades, jax_eng)))
    assert ana.analyze(wav8, SR8) == jana.analyze(wav8, SR8) != []
    assert ana.analyze(wav8[:0], SR8) == []
    for backend, n_src in (("convtasnet", 2), ("convtasnet", 3), ("mossformer", 2)):
        sep = facades.Separator(backend=backend, n_src=n_src, engine=eng)
        jsep = jax_facades.Separator(backend=backend, n_src=n_src, engine=jax_eng)
        assert sep.sample_rate == jsep.sample_rate == (8000 if backend == "mossformer" else 16000)
        got, ref = sep.separate(wav8, SR8), jsep.separate(wav8, SR8)
        assert len(got) == len(ref) == n_src
        for g, r in zip(got, ref):  # 2e-5 abs, float32 separators on |x| ~ 1
            assert g.shape == r.shape and np.abs(g - np.asarray(r)).max() < 2e-5
        batch = sep.separate_batch([wav8, wav8[:5000]], SR8)
        assert len(batch) == 2 and batch[1][0].shape == sep._ensure_sr(wav8[:5000], SR8).shape
    rec = facades.ASRRecognizer(eng)
    jrec = jax_facades.ASRRecognizer(jax_eng)
    assert rec.transcribe(wav8, SR8) == jrec.transcribe(wav8, SR8)
    assert rec.transcribe_batch([wav8], SR8) == jrec.transcribe_batch([wav8], SR8)
    ext, jext = facades.SpeakerExtractor(eng), jax_facades.SpeakerExtractor(jax_eng)
    assert ext.dim == jext.dim
    assert np.abs(ext.compute(wav8, SR8) - jext.compute(wav8, SR8)).max() < 1e-4
    assert ext.compute_batch([wav8, wav8[:6000]], SR8).shape == (2, ext.dim)


def test_facades_unported_parts_name_their_slice(engines, librimix_root, tmp_path):
    """An orbax Separator checkpoint (a directory) still raises naming its
    slice, and a missing torch file raises FileNotFoundError as in JAX; the
    SID facade (ported) builds on the engine and identifies an enrolled
    talker."""
    eng = engines[1]
    (tmp_path / "_CHECKPOINT_METADATA").write_text("{}")  # what orbax writes
    with pytest.raises(NotImplementedError, match="slice 14"):
        facades.Separator(checkpoint=str(tmp_path), engine=eng)
    with pytest.raises(FileNotFoundError, match="not found"):
        facades.Separator(checkpoint=str(tmp_path / "sep.ckpt"), engine=eng)
    models = facades.SpeakerASRModels(types.SimpleNamespace(provider="cpu"), engine=eng)
    wav = read_wav(next(iter(sorted((librimix_root / "Libri2Mix").rglob("s1/*.wav")))))[0]
    models.enroll_from_map({"spk": ["w"]}, lambda _w: (wav, SR8))
    pred, score = models.identify(wav, SR8, threshold=0.5)
    assert pred == "spk" and abs(score - 1.0) < 1e-5
    assert isinstance(models.asr_infer(wav, SR8), str)


def test_default_engine_needs_a_card_unless_cpu_is_named():
    facades.set_default_engine(None)
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                facades.default_engine("tiny")
        eng = facades.default_engine("tiny", device="cpu")
        assert eng.device.type == "cpu" and facades.default_engine("tiny") is eng
    finally:
        facades.set_default_engine(None)


def test_librimix_walkers(librimix_root):
    ds = LibriMixDataset(str(librimix_root), subset="test", num_speakers=3, sample_rate=8000)
    sr, mix, sources = ds[1]
    assert len(ds) == 2 and sr == 8000 and len(sources) == 3 and mix.shape == sources[0].shape
    assert ds.get_metadata(0)[1].startswith("Libri3Mix/")
    shim = Libri2Mix8kDataset.load_test(str(librimix_root))
    assert len(shim) == 2 and shim[0]["id"] == "mix0" and "s2_wav:FILE" in shim[0]
    with pytest.raises(ValueError, match="unknown task"):
        LibriMixDataset(str(librimix_root), task="nope")
