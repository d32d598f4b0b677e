"""The port's multi-session streaming server and its replay runner against
the JAX package and against solo runs of the port's own streaming pipeline
(tiny preset, CPU, float32 and ``--quant int8``, the same converted weights).

Records are compared as in tests/test_torch_streaming.py: kind, stream, text
and ``end - start`` exactly, sv_score within 2e-3. Servers are driven by
``step()`` (``autostart=False``) except where the tick thread itself is
under test; every wait is bounded and every server closed in a ``finally``.
The multi-GPU mesh server has no counterpart yet: ``--data-parallel`` raises.
"""
import json

import numpy as np
import pytest
import torch

from audio_classification_tpu.pipelines.serving import StreamingServer as JaxStreamingServer
from audio_classification_tpu_torch.audio_io import write_wav
from audio_classification_tpu_torch.cli import serve_streams
from audio_classification_tpu_torch.pipelines.serving import StreamingServer
from audio_classification_tpu_torch.pipelines.streaming import StreamingOverlap3Pipeline
from torch_port_helpers import (
    SR,
    _args,
    _tone,
    assert_records_match,
    run_stream,
    shared_engines,
)

torch.set_num_threads(2)


def _sargs(**kw):
    return _args(**{"process_seconds": 2.0, **kw})


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serving")
    rng = np.random.default_rng(1)
    write_wav(d / "t1.wav", _tone(1.0, 440), SR)
    write_wav(d / "t2.wav", _tone(1.0, 700), SR)
    noise = lambda: 0.01 * rng.standard_normal(2 * SR).astype(np.float32)  # noqa: E731
    mix1 = _tone(2.0, 440) + np.concatenate([np.zeros(SR, np.float32), _tone(1.0, 880)]) + noise()
    mix2 = _tone(2.0, 700) + 0.2 * _tone(2.0, 250) + noise()
    return dict(dir=d, targets=[str(d / "t1.wav"), str(d / "t2.wav")], mixes=[mix1, mix2])


@pytest.fixture(scope="module", params=["none", "int8"])
def engines(request):
    return (request.param, *shared_engines(request.param))


@pytest.fixture(scope="module")
def server():
    srv = StreamingServer(_sargs(), engine=shared_engines("none")[1], autostart=False)
    yield srv
    srv.close()


def test_multi_session_matches_jax_and_solo(engines, fixtures):
    """Two sessions with their own targets in ONE batched tick: each
    session's records equal the JAX server's, and equal a solo run of the
    port's single-session pipeline on the same engine (batching across
    sessions and gathering from the tick arena change nothing)."""
    quant, jax_eng, eng = engines
    got = {}
    for name, cls, e in (("jax", JaxStreamingServer, jax_eng), ("torch", StreamingServer, eng)):
        srv = cls(_sargs(quant=quant), engine=e, autostart=False)
        try:
            sids = [srv.open_session(target_wav=t) for t in fixtures["targets"]]
            for sid, mix in zip(sids, fixtures["mixes"]):
                srv.add_audio(sid, mix)
            assert srv.step() == 2
            got[name] = [srv.get_results(sid) for sid in sids]
            assert srv.stats()["chunks_per_tick_max"] == 2 and srv.stats()["ticks"] == 1
        finally:
            srv.close()
    for g, r, mix, target in zip(got["torch"], got["jax"], fixtures["mixes"], fixtures["targets"]):
        assert sum(x["kind"] == "full_separation" for x in g) == 3
        assert_records_match(g, r)
        solo, _ = run_stream(StreamingOverlap3Pipeline, _sargs(quant=quant), target, eng, [mix])
        assert_records_match(g, solo[0])


def test_record_fields_and_stats(server, fixtures):
    sid = server.open_session(target_wav=fixtures["targets"][0])
    server.add_audio(sid, fixtures["mixes"][0])
    assert server.pending_depth(sid) == 1
    assert server.step() == 1 and server.pending_depth(sid) == 0
    recs = server.get_results(sid)
    required = {"start", "end", "kind", "stream", "text", "asr_time", "sv_score",
                "target_src_text"}
    assert recs and all(set(r) == required for r in recs)
    assert "full_separation" in {r["kind"] for r in recs}
    assert server.get_results(sid) == []  # handed out once
    st = server.stats()
    assert st["ticks"] >= 1 and st["chunks_dropped"] == 0
    assert st["session_latency_records"] >= len(recs) and st["session_latency_p95_sec"] > 0
    server.close_session(sid)


def test_windowing_and_flush(server, fixtures):
    """Sub-window chunks buffer until process_seconds accumulate; flush
    forces a partial window out."""
    sid = server.open_session(target_wav=fixtures["targets"][0])
    part = _tone(0.8, 440)
    server.add_audio(sid, part)
    assert server.step() == 0          # below the 2 s window: nothing pending
    server.add_audio(sid, part)
    assert server.step() == 0
    server.add_audio(sid, part)        # 2.4 s buffered -> one pending chunk
    assert server.step() == 1
    full = [r for r in server.get_results(sid) if r["kind"] == "full_separation"]
    assert full and abs((full[0]["end"] - full[0]["start"]) - 2.4) < 1e-6
    server.add_audio(sid, part)
    server.flush(sid)                  # partial window forced out
    assert server.step() == 1
    server.close_session(sid)


def test_backpressure_drops_oldest(server, fixtures):
    sid = server.open_session(target_wav=fixtures["targets"][0])
    dropped = server.chunks_dropped
    for i in range(StreamingServer.MAX_PENDING + 3):
        server.add_audio(sid, _tone(2.0, 300 + 20 * i))
    assert server.pending_depth(sid) == StreamingServer.MAX_PENDING
    assert server.chunks_dropped == dropped + 3
    ticks = 0
    while server.step():
        ticks += 1
    assert ticks == StreamingServer.MAX_PENDING  # one chunk per session per tick, in order
    server.close_session(sid)


def test_mixed_rate_sessions(server, fixtures):
    """8 kHz callers are resampled inside the tick, one batch per source
    rate: their records equal those of the same audio fed at 16 kHz."""
    t8 = np.arange(int(2.0 * 8000)) / 8000
    mix8 = (0.3 * np.sin(2 * np.pi * 440 * t8) + 0.3 * np.sin(2 * np.pi * 880 * t8)).astype(
        np.float32)
    mix16 = server.engine.resample(mix8, 8000, SR)
    sid8 = server.open_session(target_wav=fixtures["targets"][0])
    sid16 = server.open_session(target_wav=fixtures["targets"][0])
    server.add_audio(sid8, mix8, sample_rate=8000)
    server.add_audio(sid16, mix16)
    assert server.step() == 2          # both rates in ONE batched tick
    got8, got16 = server.get_results(sid8), server.get_results(sid16)
    assert got8
    assert_records_match(got8, got16)
    server.close_session(sid8)
    server.close_session(sid16)


def test_session_lifecycle(server, fixtures):
    sid = server.open_session(target_wav=fixtures["targets"][0])
    server.add_audio(sid, fixtures["mixes"][0])
    server.close_session(sid)          # drops what was pending
    assert server.step() == 0 and server.pending_depth(sid) == 0
    with pytest.raises(KeyError):
        server.add_audio(sid, _tone(2.0, 440))
    with pytest.raises(KeyError):
        server.flush(sid)
    with pytest.raises(ValueError):
        server.open_session()
    # enrollment from a precomputed vector skips the embed and transcribe calls
    sid2 = server.open_session(target_vec=np.zeros(32, np.float32))
    assert server.get_results(sid2) == [] and server.get_results(10 ** 6) == []
    server.close_session(sid2)


def test_chunk_over_the_bucket_cap_takes_per_batch_uploads(fixtures):
    """A window longer than the largest bucket cannot go through the tick
    arena: the tick takes per-batch uploads (an ad-hoc bucket) and answers
    as the JAX server does."""
    jax_eng, eng = shared_engines("none")
    got = {}
    for name, cls, e in (("jax", JaxStreamingServer, jax_eng), ("torch", StreamingServer, eng)):
        srv = cls(_sargs(process_seconds=9.0), engine=e, autostart=False)
        try:
            sid = srv.open_session(target_wav=fixtures["targets"][0])
            srv.add_audio(sid, _tone(9.0, 440))
            with pytest.warns(UserWarning, match="exceeds the largest configured bucket"):
                assert srv.step() == 1
            got[name] = srv.get_results(sid)
        finally:
            srv.close()
    assert eng.upload_arena([np.zeros(9 * SR, np.float32)]) is None
    assert sum(r["kind"] == "full_separation" for r in got["torch"]) == 3
    assert_records_match(got["torch"], got["jax"])


def test_autostart_worker_end_to_end(fixtures, capsys):
    """The background tick thread drives the same path; a tick that raises
    is printed and not counted in stats()["ticks"]."""
    srv = StreamingServer(_sargs(), engine=shared_engines("none")[1], autostart=True)
    try:
        sid = srv.open_session(target_wav=fixtures["targets"][0])
        srv.add_audio(sid, fixtures["mixes"][0])
        assert srv.drain(timeout=120)
        recs = srv.get_results(sid)
        assert recs and srv.stats()["ticks"] == 1
        real = srv._tick_compute

        def boom(work):
            srv._tick_compute = real
            raise RuntimeError("kernel launch failed")

        srv._tick_compute = boom
        srv.add_audio(sid, fixtures["mixes"][0])
        assert srv.drain(timeout=120)
        srv.add_audio(sid, fixtures["mixes"][1])
        assert srv.drain(timeout=120)
    finally:
        srv.close()
    assert "serving tick error: RuntimeError: kernel launch failed" in capsys.readouterr().out
    assert srv.stats()["ticks"] == 2 and srv.get_results(sid)
    assert not srv._worker.is_alive()


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_serve_streams_cli(fixtures, tmp_path, quant):
    """Three callers (one at 8 kHz, resampled on the way in), one target
    repeated: every window of every session is answered and written."""
    wavs = []
    for i, mix in enumerate(fixtures["mixes"]):
        write_wav(tmp_path / f"call{i}.wav", np.concatenate([mix, mix]), SR)
        wavs.append(str(tmp_path / f"call{i}.wav"))
    t8 = np.arange(4 * 8000) / 8000
    write_wav(tmp_path / "call8k.wav", (0.3 * np.sin(2 * np.pi * 500 * t8)).astype(np.float32),
              8000)
    wavs.append(str(tmp_path / "call8k.wav"))
    out = tmp_path / "records.jsonl"
    stats = serve_streams.main([
        "--wavs", *wavs, "--targets", fixtures["targets"][0], "--sv-threshold", "-1",
        "--preset", "tiny", "--max-batch", "4", "--max-segment-sec", "8", "--provider", "cpu",
        "--quant", quant, "--out", str(out)])
    assert stats["sessions"] == 3 and stats["chunks_dropped"] == 0
    assert stats["ticks"] >= 2 and stats["chunks_per_tick_max"] <= 3
    assert stats["audio_sec_total"] == 12.0 and stats["serving_rtf"] > 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    for sid in range(3):
        full = [r for r in recs if r["session"] == sid and r["kind"] == "full_separation"]
        assert len(full) == 2 * 3  # two windows, three branches each


@pytest.mark.parametrize("flags", [
    ["--data-parallel", "2"], ["--model-parallel", "2"], ["--slices", "2"],
    ["--arena-codec", "mulaw"], ["--checkpoint-dir", "ORBAX_DIR"],
    ["--sense-voice", "ORBAX_DIR"], ["--spk-embed-model", "ORBAX_DIR"],
])
def test_serve_streams_unported_flags_raise(fixtures, tmp_path, flags):
    """(.onnx model files load since the ONNX slice; an orbax directory of a
    weight flag still raises.)"""
    # a directory an orbax checkpointer wrote (the port's own loads)
    (tmp_path / "orbax").mkdir()
    (tmp_path / "orbax" / "_CHECKPOINT_METADATA").write_text("{}")
    flags = [str(tmp_path / "orbax") if f == "ORBAX_DIR" else f for f in flags]
    with pytest.raises(NotImplementedError, match="not ported"):
        serve_streams.main(["--wavs", "a.wav", "--targets", fixtures["targets"][0],
                            "--preset", "tiny", "--provider", "cpu", *flags])


def test_serve_streams_without_a_card_raises(fixtures):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists here")
    assert serve_streams.parse_args(["--wavs", "a", "--targets", "b"]).provider == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_streams.main(["--wavs", "a.wav", "--targets", fixtures["targets"][0],
                            "--preset", "tiny"])
