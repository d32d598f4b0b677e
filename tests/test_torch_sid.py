"""PyTorch port vs the JAX package: the speaker-ID product (tiny preset,
CPU, the same converted weights): SpeakerBank, the VAD, the SID benchmark's
loaders, SpeakerASRModels, and the two CLIs (benchmark_pipeline,
speaker_id_vad_asr) against the JAX CLIs with shared-weight engines.

Scores are compared within 1e-4 (float32 embeddings, cosine in one matmul
on either side), predictions and texts exactly.
"""
import csv
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_tpu.cli import benchmark_pipeline as jax_bench
from audio_classification_tpu.cli import speaker_id_vad_asr as jax_spid
from audio_classification_tpu.engine import BucketSpec as JaxBucketSpec
from audio_classification_tpu.engine import StageEngine as JaxStageEngine
from audio_classification_tpu.models import facades as jax_facades
from audio_classification_tpu.models.speaker import SpeakerBank as JaxSpeakerBank
from audio_classification_tpu.models.vad import VADConfig as JaxVADConfig
from audio_classification_tpu.models.vad import VoiceActivityDetector as JaxVAD
from audio_classification_tpu.pipelines import sid_benchmark as jax_sid
from audio_classification_tpu_torch.audio_io import write_wav
from audio_classification_tpu_torch.cli import benchmark_pipeline, speaker_id_vad_asr
from audio_classification_tpu_torch.engine import BucketSpec, StageEngine
from audio_classification_tpu_torch.models import facades
from audio_classification_tpu_torch.models.speaker import SpeakerBank
from audio_classification_tpu_torch.models.vad import VADConfig, VoiceActivityDetector
from audio_classification_tpu_torch.parallel.mesh import make_mesh
from audio_classification_tpu_torch.pipelines import sid_benchmark
from test_torch_asr_families import family_packs

torch.set_num_threads(2)
SR = 16000
LENGTHS = (4000, 8000, 16000, 32000)
SCORE_TOL = 1e-4


def _voice(hz, dur=1.0, seed=0, sr=SR):
    rng = np.random.default_rng(seed)
    t = np.arange(int(dur * sr)) / sr
    x = sum(0.2 / (k + 1) * np.sin(2 * np.pi * hz * (k + 1) * t) for k in range(4))
    # syllable-rate bursts so that the VAD and the recognizer see structure
    x = x * (0.55 + 0.45 * np.sin(2 * np.pi * 3.0 * t + seed))
    return (x + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def sid_set(tmp_path_factory):
    """4 talkers x 2 enrollment wavs, 8 test wavs (one at 8 kHz), a TSV of
    reference texts and a `<utt_id> <text>` list keyed by core ids."""
    d = tmp_path_factory.mktemp("torch_sid")
    speakers = {"alice": 180.0, "bob": 260.0, "carol": 330.0, "dave": 120.0}
    enroll, test, tsv, ids = [], [], [], []
    for s, (spk, hz) in enumerate(speakers.items()):
        for i in range(2):
            p = d / f"{spk}_enroll_{i}.wav"
            write_wav(p, _voice(hz, 1.0 + 0.2 * i, seed=10 * s + i), SR)
            enroll.append(f"{spk} {p}")
        for i in range(2):
            p = d / f"{spk}_x_y_{i}_test.wav"
            sr = 8000 if (s, i) == (1, 1) else SR
            write_wav(p, _voice(hz * (1.02 if i else 0.98), 0.8 + 0.3 * i, seed=50 + s,
                                sr=sr), sr)
            test.append(f"{spk} {p}")
            tsv.append(f"{p}\thello {spk}")
            ids.append(f"{spk}_x_y_{i} 你好 {spk}")
    (d / "speakers.txt").write_text("\n".join(enroll) + "\n")
    (d / "test.txt").write_text("\n".join(test) + "\n")
    (d / "refs.tsv").write_text("\n".join(tsv) + "\n")
    (d / "refs_ids.txt").write_text("\n".join(ids) + "\n")
    return d


@pytest.fixture(scope="module", params=["sensevoice", "paraformer"])
def engines(request):
    jax_pack, pack = family_packs(request.param)
    return (request.param, JaxStageEngine(jax_pack, JaxBucketSpec(LENGTHS, 4)),
            StageEngine(pack, BucketSpec(LENGTHS, 4)))


# ------------------------------------------------------------------ SpeakerBank
def test_speaker_bank_matches_jax():
    """add (a duplicate name and a wrong width refused), scores in one
    matmul, search at a threshold, an empty bank."""
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((5, 16)).astype(np.float32)
    bank, jbank = SpeakerBank(16, device="cpu"), JaxSpeakerBank(16)
    assert bank.search(vecs[0], 0.0) == jbank.search(vecs[0], 0.0) == ""
    for i, v in enumerate(vecs[:4]):
        assert bank.add(f"s{i}", v * (i + 1)) == jbank.add(f"s{i}", v * (i + 1)) is True
    assert bank.add("s0", vecs[4]) is False and bank.add("x", vecs[4][:8]) is False
    q = vecs + 0.3 * rng.standard_normal(vecs.shape).astype(np.float32)
    got, ref = bank.scores(q).numpy(), np.asarray(jbank.scores(jnp.asarray(q)))
    assert got.shape == (5, 4)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    for thr in (-1.0, 0.5, 0.99):
        assert [bank.search(v, thr) for v in q] == [jbank.search(v, thr) for v in q]


@pytest.mark.parametrize("sharded", [False, True])
def test_speaker_bank_search_batch_matches_jax(sharded):
    """search_batch: [(name or "", top-1 score)] for every row from one
    scores call, as the JAX method (models/speaker.py:179), on a plain bank
    and on one sharded over a 2-entry mesh (13 speakers: a zero-padded
    shard); ("", nan) for each row of an empty bank."""
    from audio_classification_tpu.parallel.mesh import make_mesh as jax_make_mesh

    rng = np.random.default_rng(2)
    vecs = rng.standard_normal((13, 16)).astype(np.float32)
    bank = SpeakerBank(16, device="cpu",
                       mesh=make_mesh(2, devices=["cpu"] * 2) if sharded else None)
    jbank = JaxSpeakerBank(16, mesh=jax_make_mesh(2, model_axis=1) if sharded else None)
    q = np.concatenate([vecs[:4] + 0.2 * rng.standard_normal((4, 16)),
                        rng.standard_normal((3, 16))]).astype(np.float32)
    empty = bank.search_batch(q, 0.5)
    assert len(empty) == len(q) and all(n == "" and np.isnan(x) for n, x in empty)
    assert len(jbank.search_batch(q, 0.5)) == len(q)
    for i, v in enumerate(vecs):
        assert bank.add(f"s{i}", v) and jbank.add(f"s{i}", v)
    for thr in (-1.0, 0.5, 0.95):
        got, ref = bank.search_batch(q, thr), jbank.search_batch(q, thr)
        assert [n for n, _ in got] == [n for n, _ in ref]
        np.testing.assert_allclose([x for _, x in got], [x for _, x in ref], atol=1e-6)
    assert [n for n, _ in bank.search_batch(q, 0.5)][:4] == ["s0", "s1", "s2", "s3"]


def test_speaker_bank_mesh_rule():
    """A mesh whose shards live on one device keeps the bank there, its rows
    split over the shards (zero-padded: 3 speakers on 2 shards); a mesh over
    several distinct devices in one process is refused by make_mesh with
    the torchrun command (one rank per card, tests/test_torch_mesh_ranks.py);
    the default device is the card, which raises without one."""
    bank = SpeakerBank(4, mesh=make_mesh(2, devices=["cpu"] * 2))
    assert bank.device.type == "cpu"
    for name, v in (("a", [1, 0, 0, 0]), ("b", [0, 1, 0, 0]), ("c", [0, 0, 1, 1])):
        bank.add(name, np.asarray(v, np.float32))
    assert bank.matrix.shape == (4, 4)
    assert bank.scores(np.ones((1, 4), np.float32)).shape == (1, 3)
    assert bank.search(np.asarray([0, 0, 1, 0.9]), 0.9) == "c"
    with pytest.raises(ValueError, match="torchrun --nproc-per-node"):
        make_mesh(2, devices=["cpu", "meta"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SpeakerBank(4)


# ------------------------------------------------------------------ VAD
def test_vad_probs_match_jax(engines):
    """VADNet through both engines' bucketed batches on speech-like wavs
    over a noise floor: frame probabilities within 1e-5, the frame counts
    equal. (Digital silence is left out: there the log-mel floor carries the
    two frontends' float32 cancellation, tests/test_torch_ops.py.)"""
    _name, jax_eng, eng = engines
    wavs = [_voice(180, 0.45, 1), _voice(300, 1.0, 2), _voice(120, 0.3, 3)]
    got, ref = eng.vad_probs_batch(wavs), jax_eng.vad_probs_batch(wavs)
    for g, r in zip(got, ref):
        assert g.shape == np.asarray(r).shape
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-5)
    assert eng.vad_probs(wavs[0]).shape == got[0].shape


def test_vadnet_matches_jax():
    """The model alone on the same features, a padded row: 1e-6 abs."""
    jax_pack, pack = family_packs("sensevoice")
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 50, 80)).astype(np.float32)
    mask = (np.arange(50)[None, :] < np.array([[50], [31]])).astype(np.float32)
    ref = np.asarray(jax_pack.vad_model.apply(jax_pack.params["vad"], jnp.asarray(feats),
                                              jnp.asarray(mask)))
    with torch.no_grad():
        got = pack.models["vad"](torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert (got[1, 31:] == 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vad_segments_match_jax(seed):
    """The host hysteresis on the same probabilities: equal segments, with
    short gaps bridged and short runs dropped."""
    rng = np.random.default_rng(seed)
    probs = np.repeat(rng.uniform(size=60), rng.integers(1, 40, 60))
    cfg = dict(min_silence_duration=0.25, min_speech_duration=0.25 + 0.1 * seed)
    dur = probs.size * 0.01
    got = VoiceActivityDetector(VADConfig(**cfg)).segments(probs, dur)
    assert got == JaxVAD(JaxVADConfig(**cfg)).segments(probs, dur)
    assert got


# ------------------------------------------------------------------ loaders
def test_loaders_match_jax(sid_set):
    """load_pairs, load_refs in both modes (TSV, and `<utt_id> <text>`
    broadcast by core id), load_audio with the 8 kHz test wav resampled."""
    for name in ("speakers.txt", "test.txt"):
        assert sid_benchmark.load_pairs(str(sid_set / name)) == jax_sid.load_pairs(
            str(sid_set / name))
    tests = [w for ws in sid_benchmark.load_pairs(str(sid_set / "test.txt")).values() for w in ws]
    for name in ("refs.tsv", "refs_ids.txt"):
        got = sid_benchmark.load_refs(str(sid_set / name), tests)
        assert got == jax_sid.load_refs(str(sid_set / name), tests) and len(got) == 8
    assert sid_benchmark.load_refs("", tests) == {}
    for w in tests[2:4]:
        (s, sr, dur), (js, jsr, jdur) = sid_benchmark.load_audio(w), jax_sid.load_audio(w)
        assert sr == jsr == SR and dur == jdur
        np.testing.assert_allclose(s, js, atol=1e-7)
    bad = sid_set / "bad.txt"
    bad.write_text("only_one_field\n")
    with pytest.raises(ValueError, match="Bad line"):
        sid_benchmark.load_pairs(str(bad))


# ------------------------------------------------------------------ SpeakerASRModels
def _args(**kw):
    import types

    base = dict(provider="cpu", preset="tiny", language="auto", emb_cache_dir="",
                save_speaker_embeds="", load_speaker_embeds="", threshold=0.5)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_speaker_asr_models_match_jax(engines, sid_set, tmp_path):
    """Enrollment (mean of each talker's l2-normalised embeddings, .npy
    caches written and then read, the npz saved and loaded back), identify
    and asr_infer against the JAX facade on the same weights."""
    _name, jax_eng, eng = engines
    spk_map = sid_benchmark.load_pairs(str(sid_set / "speakers.txt"))
    kw = dict(emb_cache_dir=str(tmp_path / "cache"), save_speaker_embeds=str(tmp_path / "s.npz"))
    models = facades.SpeakerASRModels(_args(**kw), engine=eng)
    jmodels = jax_facades.SpeakerASRModels(_args(emb_cache_dir=str(tmp_path / "jcache")),
                                           engine=jax_eng)
    models.enroll_from_map(spk_map, sid_benchmark.load_audio)
    jmodels.enroll_from_map(spk_map, jax_sid.load_audio)
    assert list(models.enrolled) == list(jmodels.enrolled) == list(spk_map)
    for spk in spk_map:
        np.testing.assert_allclose(models.enrolled[spk], jmodels.enrolled[spk], atol=SCORE_TOL)
    assert len(list((tmp_path / "cache").glob("*.npy"))) == 8
    # cached embeddings are read back: the same means
    again = facades.SpeakerASRModels(_args(emb_cache_dir=str(tmp_path / "cache")), engine=eng)
    again.enroll_from_map(spk_map, lambda w: (_ for _ in ()).throw(AssertionError(w)))
    loaded = facades.SpeakerASRModels(_args(load_speaker_embeds=str(tmp_path / "s.npz")),
                                      engine=eng)
    loaded.enroll_from_map({}, sid_benchmark.load_audio)
    for spk in spk_map:
        np.testing.assert_allclose(again.enrolled[spk], models.enrolled[spk], atol=1e-6)
        np.testing.assert_allclose(loaded.enrolled[spk], models.enrolled[spk], atol=1e-6)
    for _spk, wavs in sid_benchmark.load_pairs(str(sid_set / "test.txt")).items():
        for w in wavs:
            s, sr, _ = sid_benchmark.load_audio(w)
            for thr in (-1.0, 0.5):
                pred, score = models.identify(s, sr, thr)
                jpred, jscore = jmodels.identify(s, sr, thr)
                assert pred == jpred and abs(score - jscore) <= SCORE_TOL
            assert models.asr_infer(s, sr) == jmodels.asr_infer(s, sr)
    assert models.manager.device.type == "cpu" and not models.using_cuda


# ------------------------------------------------------------------ CLIs
def _rows(path):
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f))


def _only_dir(base: Path) -> Path:
    (d,) = [p for p in base.iterdir() if p.is_dir()]
    return d


FAMILY_FLAG = {"sensevoice": ["--sense-voice", "seeded"], "paraformer": ["--paraformer", "s"]}


@pytest.mark.parametrize("batch", [False, True])
def test_benchmark_pipeline_cli_matches_jax(engines, sid_set, tmp_path, monkeypatch, batch):
    """benchmark_pipeline against the JAX CLI on shared-weight engines:
    predictions.csv equal on wav / speaker_true / speaker_pred / text and
    score within 1e-4 (printed to 3 decimals, so within one step of the last
    digit), detail.jsonl's CER and summary.json's counts equal. Per
    utterance, and with --batch-mode."""
    family, jax_eng, eng = engines
    monkeypatch.setattr(jax_bench, "build_engine", lambda args: jax_eng)
    monkeypatch.setattr(benchmark_pipeline, "build_engine", lambda args: eng)
    argv = ["--speaker-file", str(sid_set / "speakers.txt"), "--test-list",
            str(sid_set / "test.txt"), "--ref-text-list", str(sid_set / "refs.tsv"),
            "--preset", "tiny", "--threshold", "0.3", *FAMILY_FLAG[family],
            *(["--batch-mode"] if batch else [])]
    out_dir, summary = benchmark_pipeline.main([*argv, "--provider", "cpu",
                                                "--out-dir", str(tmp_path / "port")])
    jax_bench.main([*argv, "--out-dir", str(tmp_path / "jax")])
    jdir = _only_dir(tmp_path / "jax")
    got, ref = _rows(out_dir / "predictions.csv"), _rows(jdir / "predictions.csv")
    assert len(got) == len(ref) == 8
    for g, r in zip(got, ref):
        for key in ("wav", "speaker_true", "speaker_pred", "text", "dur_sec", "cer"):
            assert g[key] == r[key], key
        assert abs(float(g["score"]) - float(r["score"])) <= 1e-3 + 1e-9
    jsum = json.loads((jdir / "summary.json").read_text())
    for key in ("total_utts", "train_speakers", "correct", "unknown", "accuracy", "cer_mean",
                "duration_audio_sum_sec", "threshold", "asr_model_type"):
        assert summary[key] == jsum[key], key
    assert json.loads((out_dir / "summary.json").read_text())["total_utts"] == 8
    assert (out_dir / "summary.txt").is_file() and len(
        (out_dir / "detail.jsonl").read_text().splitlines()) == 8


@pytest.mark.parametrize("flags", [[], ["--apply-vad"], ["--long-form"]])
def test_speaker_id_vad_asr_cli_matches_jax(engines, sid_set, tmp_path, monkeypatch, flags):
    """speaker_id_vad_asr against the JAX CLI on shared-weight engines:
    predictions.csv equal on wav / speaker_true / speaker_pred / text, the
    top-1 score within 1e-4, report.txt equal; with
    --apply-vad (one batched VAD pass trims each test wav) and --long-form
    (one full-context program per utterance)."""
    family, jax_eng, eng = engines
    monkeypatch.setattr(jax_spid, "build_engine", lambda args: jax_eng)
    monkeypatch.setattr(speaker_id_vad_asr, "build_engine", lambda args: eng)
    argv = ["--speaker-file", str(sid_set / "speakers.txt"), "--test-list",
            str(sid_set / "test.txt"), "--preset", "tiny", "--threshold", "0.3",
            *FAMILY_FLAG[family], *flags]
    run_dir = speaker_id_vad_asr.main([*argv, "--provider", "cpu",
                                       "--out-dir", str(tmp_path / "port")])
    jax_spid.main([*argv, "--out-dir", str(tmp_path / "jax")])
    jdir = _only_dir(tmp_path / "jax")
    got, ref = _rows(run_dir / "predictions.csv"), _rows(jdir / "predictions.csv")
    assert len(got) == len(ref) == 8
    for g, r in zip(got, ref):
        for key in ("wav", "speaker_true", "speaker_pred", "text"):
            assert g[key] == r[key], key
        assert abs(float(g["score"]) - float(r["score"])) <= SCORE_TOL
    assert (run_dir / "report.txt").read_text() == (jdir / "report.txt").read_text()


def test_sid_clis_build_their_engine_and_refuse_weight_files(sid_set, tmp_path):
    """Without a stand-in engine the CLIs build a seeded tiny engine on the
    CPU when asked, and write their files; an .onnx model file (the VAD's,
    the speaker model's or a family's) is read, so a missing one raises
    FileNotFoundError (tests/test_torch_onnx_cli.py loads real ones)."""
    base = ["--speaker-file", str(sid_set / "speakers.txt"), "--test-list",
            str(sid_set / "test.txt"), "--preset", "tiny", "--provider", "cpu"]
    run_dir = speaker_id_vad_asr.main([*base, "--whisper-encoder", "w", "--out-dir",
                                       str(tmp_path / "a")])
    assert len(_rows(run_dir / "predictions.csv")) == 8
    out_dir, summary = benchmark_pipeline.main([*base, "--encoder", "e", "--decoding-method",
                                                "modified_beam_search", "--out-dir",
                                                str(tmp_path / "b")])
    assert summary["asr_model_type"] == "transducer" and summary["total_utts"] == 8
    for flags in (["--silero-vad-model", "vad.onnx"], ["--model", "spk.onnx"],
                  ["--paraformer", "p.onnx"]):
        with pytest.raises(FileNotFoundError, match=r"\.onnx"):
            speaker_id_vad_asr.main([*base, "--sense-voice", "s", *flags])
    with pytest.raises(ValueError, match="one ASR model family"):
        speaker_id_vad_asr.main(base)
