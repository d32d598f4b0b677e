"""PyTorch port vs the JAX package: the Paraformer, transducer (greedy and
modified beam search) and whisper-style families through the engine and
the runners (tiny preset, CPU, weights from the JAX ModelPack): bucketed
transcription, ``transcribe(long_form=True)`` (and Paraformer over a mesh
against the JAX mesh path), the flagship CLI in forced scenes, the family
flags through ``build_engine``, streaming and serving. Texts are compared
exactly, with the 64-symbol token table of test_torch_asr_families.py;
sv_score within 1e-4 (2e-3 through the streaming helpers).
"""
import pytest
import torch

from audio_classification_tpu.engine import BucketSpec as JaxBucketSpec
from audio_classification_tpu.engine import StageEngine as JaxStageEngine
from audio_classification_tpu.models import facades as jax_facades
from audio_classification_tpu.parallel.mesh import make_mesh as jax_make_mesh
from audio_classification_tpu.pipelines.offline_overlap3 import Overlap3Pipeline as JaxPipeline
from audio_classification_tpu.pipelines.serving import StreamingServer as JaxStreamingServer
from audio_classification_tpu.pipelines.streaming import (
    StreamingOverlap3Pipeline as JaxStreamingPipeline,
)
from audio_classification_tpu.utils.config import Overlap3Config as JaxConfig
from audio_classification_tpu_torch.audio_io import write_wav
from audio_classification_tpu_torch.cli import offline_overlap_3src, serve_streams
from audio_classification_tpu_torch.cli import streaming_overlap_3src
from audio_classification_tpu_torch.engine import BucketSpec, StageEngine
from audio_classification_tpu_torch.engine.bucketing import default_buckets
from audio_classification_tpu_torch.models import facades
from audio_classification_tpu_torch.parallel.mesh import make_mesh
from audio_classification_tpu_torch.pipelines import offline_overlap3
from audio_classification_tpu_torch.pipelines.offline_overlap3 import build_engine
from audio_classification_tpu_torch.pipelines.serving import StreamingServer
from audio_classification_tpu_torch.pipelines.streaming import StreamingOverlap3Pipeline
from test_torch_asr_families import CFG_FIELDS, FAMILIES, FLAGS, LENGTHS, family_packs
from test_torch_long_form import _bursts
from torch_port_helpers import SR, _args, _tone, assert_records_match, run_stream

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["paraformer", "transducer", "whisper",
                                        "transducer-beam"])
def engines(request):
    family, decoding = (("transducer", "modified_beam_search") if request.param.endswith("beam")
                        else (request.param, "greedy_search"))
    jax_pack, pack = family_packs(family, decoding=decoding, beam_width=3)
    return (request.param, JaxStageEngine(jax_pack, JaxBucketSpec(LENGTHS, 4)),
            StageEngine(pack, BucketSpec(LENGTHS, 4)))


# ------------------------------------------------------------------ engines and CLIs
def test_engine_transcribe_matches_jax(engines):
    """Bucketed batches of several lengths through the family's stage: texts
    exact, at least one of them non-empty."""
    _name, jax_eng, eng = engines
    wavs = [_bursts(n, seed=s) for n, s in ((3800, 3), (7000, 4), (12000, 5), (2500, 6))]
    got = eng.transcribe(wavs)
    assert got == jax_eng.transcribe(wavs)
    assert any(got)


def test_engine_transcribe_long_matches_jax(engines):
    """transcribe(long_form=True) through the facade, inside and past the
    largest bucket: texts exact (whisper with its decode budget scaled to
    the audio)."""
    name, jax_eng, eng = engines
    for n in (14000, 40000):
        wav = _bursts(n, seed=7)
        ref = jax_facades.ASRRecognizer(jax_eng).transcribe(wav, SR, long_form=True)
        got = facades.ASRRecognizer(eng).transcribe(wav, SR, long_form=True)
        assert got == ref, (name, n)


@pytest.mark.parametrize("n", [2, 4])
def test_paraformer_long_form_over_a_mesh_matches_jax(n):
    """Paraformer's encoder ring-parallel over n shards of the CPU against
    the JAX engine on n virtual devices (under jax.jit) and against the
    port without a mesh: texts exact. A transducer engine with a mesh falls
    back to segment mode, as the JAX engine does."""
    jax_pack, pack = family_packs("paraformer")
    wav = _bursts(40000, seed=8)
    spec, jspec = BucketSpec(LENGTHS, 4), JaxBucketSpec(LENGTHS, 4)
    sharded = StageEngine(pack, spec, mesh=make_mesh(n, devices=["cpu"] * n))
    jsharded = JaxStageEngine(jax_pack, jspec, mesh=jax_make_mesh(n, model_axis=1))
    got = sharded.transcribe_long(wav)
    assert got == jsharded.transcribe_long(wav)
    assert got == StageEngine(pack, spec).transcribe_long(wav)
    assert len(got) >= 3
    assert StageEngine.LONG_FORM_FAMILIES == ("sensevoice", "paraformer")


def test_transducer_with_a_mesh_falls_back_to_segments():
    _jax_pack, pack = family_packs("transducer")
    wav = _bursts(14000, seed=9)
    sharded = StageEngine(pack, BucketSpec(LENGTHS, 4), mesh=make_mesh(2, devices=["cpu"] * 2))
    assert sharded.transcribe_long(wav) == sharded.transcribe([wav])[0]


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_families")
    for i, n in enumerate((9600, 14400, 16000)):
        write_wav(d / f"mix{i}.wav", _bursts(n, seed=12 + i), SR)
    write_wav(d / "target.wav", _tone(1.0, 440), SR)
    return d


@pytest.mark.parametrize("osd_thr,kind", [(0.0, "overlap"), (1.0, "clean")])
def test_flagship_cli_with_a_family_matches_jax(engines, wavs, tmp_path, monkeypatch, osd_thr,
                                                kind):
    """offline_overlap_3src with the family's flags (non-.onnx values select
    the family with seeded weights) against the JAX pipeline on the same
    weights, forced overlap and forced clean: records equal on kind, span,
    stream and texts, sv_score within 1e-4. The CLI's config is checked to
    select the family before the shared engine stands in for the seeded
    one."""
    name, jax_eng, eng = engines
    family = "transducer" if name.startswith("transducer") else name
    decoding = "modified_beam_search" if name.endswith("beam") else "greedy_search"
    seen = []

    def shared(cfg, device=None):
        seen.append((offline_overlap3.asr_family(cfg), cfg.decoding_method, cfg.num_active_paths))
        return eng

    monkeypatch.setattr(offline_overlap3, "build_engine", shared)
    extra = ["--decoding-method", decoding, "--num-active-paths", "3"] if decoding != \
        "greedy_search" else []
    mixes = [str(wavs / f"mix{i}.wav") for i in range(3)]
    _out, got = offline_overlap_3src.main([
        "--input-wavs", *mixes, "--target-wav", str(wavs / "target.wav"),
        "--preset", "tiny", "--provider", "cpu", "--sv-threshold", "-1", "--osd-thr",
        str(osd_thr), "--max-batch", "4", "--max-segment-sec", "1.0",
        "--out-dir", str(tmp_path), *FLAGS[family], *extra])
    assert seen == [(family, decoding, 3 if extra else 4)]
    kw = dict(input_wavs=mixes, target_wav=str(wavs / "target.wav"),
              preset="tiny", seed=0, sv_threshold=-1.0, max_batch=4, max_segment_sec=1.0,
              osd_thr=osd_thr, decoding_method=decoding, **CFG_FIELDS[family])
    ref = JaxPipeline(JaxConfig(**kw), engine=jax_eng).run()
    assert len(got.segments) == len(ref.segments) >= 3
    for g, r in zip(got.segments, ref.segments):
        assert g["kind"] == kind
        for key in ("kind", "start", "end", "stream", "text", "target_src_text"):
            assert g[key] == r[key], key
        assert abs(g["sv_score"] - r["sv_score"]) <= 1e-4 + 1e-9
    assert any(g["text"] for g in got.segments)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_build_engine_wires_the_family_flags(family, quant):
    """build_engine from the CLI's own flags, on the seeded weights: the
    pack's family and its int8 switch follow the flags; the seeded engine
    transcribes. Beam search outside the transducer raises the JAX
    package's ValueError; an .onnx value is read as a model file (a missing
    one raises FileNotFoundError, as the JAX runner's reader does)."""
    args = offline_overlap_3src.parse_args(
        ["--input-wavs", "m.wav", "--target-wav", "t.wav", "--preset", "tiny",
         "--provider", "cpu", "--quant", quant, *FLAGS[family]])
    eng = build_engine(args)
    assert eng.pack.asr_family == family and eng.device.type == "cpu"
    cfg = getattr(eng.pack, f"{family}_cfg")
    assert cfg.quant == quant
    assert cfg.vocab_size == 64
    assert isinstance(eng.transcribe([_bursts(6000, seed=1)])[0], str)
    onnx = list(FLAGS[family])
    onnx[1] = "model.onnx"
    with pytest.raises(FileNotFoundError, match="model.onnx"):
        build_engine(offline_overlap_3src.parse_args(
            ["--input-wavs", "m.wav", "--preset", "tiny", "--provider", "cpu", *onnx]))
    if family != "transducer":
        with pytest.raises(ValueError, match="transducer"):
            build_engine(offline_overlap_3src.parse_args(
                ["--input-wavs", "m.wav", "--preset", "tiny", "--provider", "cpu",
                 *FLAGS[family], "--decoding-method", "modified_beam_search"]))


def test_streaming_and_serving_with_a_family_match_jax(engines, wavs):
    """The streaming pipeline's worker thread and the multi-session server's
    batched tick on the family's engines (8 s buckets): records equal to the
    JAX package's (kind, stream, text, span length; sv_score within 2e-3)."""
    name, jax_eng, eng = engines
    spec = default_buckets(SR, 0.5, 8.0)
    jax_eng = JaxStageEngine(jax_eng.pack, JaxBucketSpec(spec, 4))
    eng = StageEngine(eng.pack, BucketSpec(spec, 4))
    target = str(wavs / "target.wav")
    chunks = [_bursts(2 * SR, seed=31), _bursts(2 * SR, seed=32)]
    ref, _ = run_stream(JaxStreamingPipeline, _args(), target, jax_eng, chunks)
    got, stats = run_stream(StreamingOverlap3Pipeline, _args(), target, eng, chunks)
    assert stats["chunks"] == 2
    for g, r in zip(got, ref):
        assert_records_match(g, r)
    assert any(x["text"] for window in got for x in window)
    served = {}
    for key, cls, e in (("jax", JaxStreamingServer, jax_eng), ("torch", StreamingServer, eng)):
        srv = cls(_args(process_seconds=2.0), engine=e, autostart=False)
        try:
            sids = [srv.open_session(target_wav=target) for _ in chunks]
            for sid, mix in zip(sids, chunks):
                srv.add_audio(sid, mix)
            assert srv.step() == 2
            served[key] = [srv.get_results(sid) for sid in sids]
        finally:
            srv.close()
    for g, r in zip(served["torch"], served["jax"]):
        assert_records_match(g, r)


@pytest.mark.parametrize("family", FAMILIES)
def test_streaming_and_serving_clis_take_the_family_flags(family, wavs, tmp_path):
    """streaming_overlap_3src and serve_streams pass the family flags to
    build_engine (seeded weights): both run to the end on the family's pack;
    the transducer also with modified_beam_search."""
    extra = (["--decoding-method", "modified_beam_search", "--num-active-paths", "2"]
             if family == "transducer" else [])
    common = ["--preset", "tiny", "--provider", "cpu", "--sv-threshold", "-1",
              "--max-segment-sec", "8", *FLAGS[family], *extra]
    app = streaming_overlap_3src.main(["--target-wav", str(wavs / "target.wav"), "--input-wav",
                                       str(wavs / "mix2.wav"), "--no-realtime",
                                       "--output-dir", str(tmp_path), *common])
    assert app.pipeline.engine.pack.asr_family == family
    assert app.pipeline.latency_stats()["chunks"] == 1
    stats = serve_streams.main(["--wavs", str(wavs / "mix0.wav"), str(wavs / "mix1.wav"),
                                "--targets", str(wavs / "target.wav"),
                                "--out", str(tmp_path / "r.jsonl"), *common])
    assert stats["sessions"] == 2 and stats["ticks"] >= 1
    assert (tmp_path / "r.jsonl").read_text().count("full_separation") == 6
