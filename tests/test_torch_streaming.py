"""The port's streaming pipeline, its file-replay application and its ring
buffer against the JAX package (tiny preset, CPU, float32 and ``--quant
int8``, the same converted weights, windows made from a numpy seed).

Records are compared on kind, stream, text, ``end - start`` (the absolute
times come from ``time.time()``) and sv_score within 2e-3: 1e-4 covers the
float path, the rest the int8 separator ahead of the float speaker embedder.
Texts are compared exactly, so the windows come from a fixture seed on which
the random tiny recognizer has no two logits nearly tied.

Every test that starts a worker thread bounds its waits and closes the
pipeline in a ``finally``.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

from audio_classification_tpu.pipelines.streaming import (
    StreamingOverlap3Pipeline as JaxStreamingPipeline,
)
from audio_classification_tpu_torch.audio_io import RingBuffer, write_wav
from audio_classification_tpu_torch.cli import streaming_overlap_3src
from audio_classification_tpu_torch.pipelines.streaming import StreamingOverlap3Pipeline
from torch_port_helpers import (
    SR,
    _args,
    _tone,
    assert_records_match,
    run_stream,
    shared_engines,
    windows,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["none", "int8"])
def engines(request):
    return (request.param, *shared_engines(request.param))


@pytest.fixture(scope="module")
def float_engine():
    return shared_engines("none")[1]


@pytest.fixture(scope="module")
def target_wav(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_streaming") / "target.wav"
    write_wav(p, _tone(1.0, 440), SR)
    return str(p)


def test_streaming_records_match_jax(engines, target_wav):
    """The same windows through both packages' worker threads: per window the
    same records (the unconditional full_separation rows, every branch over
    the threshold, clean and overlap rows as OSD cuts them)."""
    quant, jax_eng, eng = engines
    chunks = windows()
    ref, _ = run_stream(JaxStreamingPipeline, _args(quant=quant), target_wav, jax_eng, chunks)
    got, stats = run_stream(StreamingOverlap3Pipeline, _args(quant=quant), target_wav, eng, chunks)
    assert stats["chunks"] == len(chunks)
    required = {"start", "end", "kind", "stream", "text", "asr_time", "sv_score",
                "target_src_text"}
    for g, r in zip(got, ref):
        assert_records_match(g, r)
        kinds = [x["kind"] for x in g]
        assert kinds.count("full_separation") == 3  # sv_threshold -1: all three branches
        assert all(set(x) == required and x["end"] >= x["start"] for x in g)


@pytest.mark.parametrize("osd_thr,kind", [(0.0, "overlap"), (1.0, "clean")])
def test_streaming_forced_scenes_match_jax(engines, target_wav, osd_thr, kind):
    """Every OSD frame forced to overlap / to clean: the OSD-derived rows of
    that kind beside the full_separation rows."""
    quant, jax_eng, eng = engines
    chunks = windows(n=1)
    args = _args(quant=quant, osd_thr=osd_thr)
    ref, _ = run_stream(JaxStreamingPipeline, args, target_wav, jax_eng, chunks)
    got, _ = run_stream(StreamingOverlap3Pipeline, args, target_wav, eng, chunks)
    assert_records_match(got[0], ref[0])
    assert {x["kind"] for x in got[0]} == {kind, "full_separation"}


def test_streaming_gate_blocks(float_engine, target_wav):
    """No score clears a threshold of 2: the chunk is analysed and emits
    nothing."""
    got, stats = run_stream(StreamingOverlap3Pipeline, _args(sv_threshold=2.0), target_wav,
                            float_engine, [_tone(2.0, 440)])
    assert got == [[]] and stats["chunks"] == 1


def test_streaming_buffers_until_flush_and_resamples(float_engine, target_wav):
    """flush_buffer forwards what add_audio_data left (nothing, since each
    call enqueues); an 8 kHz stream is resampled per chunk."""
    pipe = StreamingOverlap3Pipeline(_args(sample_rate=8000), target_wav, engine=float_engine)
    try:
        t = np.arange(2 * 8000) / 8000.0
        pipe.add_audio_data((0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32))
        pipe.flush_buffer()
        pipe.drain(timeout=120)
    finally:
        pipe.close()
    recs = pipe.get_results()
    assert pipe.latency_stats()["chunks"] == 1
    full = [r for r in recs if r["kind"] == "full_separation"]
    assert len(full) == 3 and all(abs((r["end"] - r["start"]) - 2.0) < 1e-6 for r in full)


def test_streaming_worker_prints_a_failure_and_does_not_count_it(float_engine, target_wav,
                                                                 capsys, monkeypatch):
    """A chunk whose analysis raises is printed and skipped, the worker goes
    on, and latency_stats()["chunks"] counts only the chunks analysed to the
    end: the equality a caller checks to see that nothing was swallowed."""
    pipe = StreamingOverlap3Pipeline(_args(), target_wav, engine=float_engine)
    real = pipe._analyze_segment
    calls = []

    def flaky(seg):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("kernel launch failed")
        return real(seg)

    monkeypatch.setattr(pipe, "_analyze_segment", flaky)
    try:
        for c in windows(n=2):
            pipe.add_audio_data(c)
        pipe.drain(timeout=120)
    finally:
        pipe.close()
    assert "Segment analysis error: kernel launch failed" in capsys.readouterr().out
    assert len(calls) == 2 and pipe.latency_stats()["chunks"] == 1
    assert pipe.get_results()


def test_streaming_warmup_and_backpressure(float_engine, target_wav):
    """warmup() runs one silent chunk on the calling thread and leaves no
    record; a full work queue drops its oldest chunk, never blocks."""
    pipe = StreamingOverlap3Pipeline(_args(), target_wav, engine=float_engine)
    try:
        pipe.warmup(1.0)
        assert pipe.get_results() == [] and pipe.latency_stats() == {}
        gate = threading.Event()
        real = pipe._analyze_segment
        pipe._analyze_segment = lambda seg: (gate.wait(60), real(seg))
        t0 = time.time()
        for _ in range(12):  # the worker holds one, the queue takes 8
            pipe.add_audio_data(_tone(0.5, 440))
        assert time.time() - t0 < 5.0 and pipe._work.qsize() <= 8
        gate.set()
        pipe.drain(timeout=120)
    finally:
        pipe.close()
    assert 1 <= pipe.latency_stats()["chunks"] <= 9


def test_worker_thread_runs_without_autograd(float_engine, target_wav):
    """torch.inference_mode is thread-local: the engine's public methods set
    it themselves, so nothing the worker thread produces carries a graph."""
    seen = []
    pipe = StreamingOverlap3Pipeline(_args(), target_wav, engine=float_engine)
    real = float_engine._overlap_path_fn

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append((threading.current_thread().name, torch.is_inference_mode_enabled(),
                     any(t.requires_grad for t in out if isinstance(t, torch.Tensor))))
        return out

    float_engine._overlap_path_fn = spy
    try:
        pipe.add_audio_data(_tone(1.0, 440))
        pipe.drain(timeout=120)
    finally:
        pipe.close()
        del float_engine._overlap_path_fn
    assert seen and all(name == "overlap3-worker" and inf and not grad
                        for name, inf, grad in seen)


# ------------------------------------------------------------ application
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_streaming_app_file_replay(target_wav, tmp_path, quant):
    """The CLI replays a wav as fast as it can, builds its own engine on the
    CPU when asked, and writes its JSONL; every window is analysed."""
    mix = _tone(4.0, 440) + np.concatenate([np.zeros(SR, np.float32), _tone(3.0, 880)])
    write_wav(tmp_path / "mix.wav", mix, SR)
    out = tmp_path / "stream_out"
    app = streaming_overlap_3src.main([
        "--target-wav", target_wav, "--input-wav", str(tmp_path / "mix.wav"), "--no-realtime",
        "--process-seconds", "2", "--sv-threshold", "-1", "--preset", "tiny",
        "--max-segment-sec", "8", "--provider", "cpu", "--quant", quant,
        "--output-dir", str(out)])
    assert app.pipeline.engine.device.type == "cpu"
    assert app.pipeline.engine.pack.models["sep3"].cfg.quant == quant
    # 64000 samples in blocks of 31 x 1024: two whole blocks and the rest
    assert app.pipeline.latency_stats()["chunks"] == 3
    assert sum(r["kind"] == "full_separation" for r in app.all_results) == 9
    jsonls = sorted(out.glob("results_*.jsonl"))
    assert jsonls
    recs = [json.loads(line) for line in jsonls[-1].read_text().splitlines()]
    assert len(recs) == len(app.all_results)


def test_streaming_app_max_seconds_and_8k_input(target_wav, tmp_path):
    t = np.arange(6 * 8000) / 8000.0
    write_wav(tmp_path / "mix8k.wav", (0.3 * np.sin(2 * np.pi * 300 * t)).astype(np.float32), 8000)
    app = streaming_overlap_3src.main([
        "--target-wav", target_wav, "--input-wav", str(tmp_path / "mix8k.wav"), "--no-realtime",
        "--process-seconds", "2", "--max-seconds", "2", "--sv-threshold", "-1", "--preset",
        "tiny", "--max-segment-sec", "8", "--provider", "cpu",
        "--output-dir", str(tmp_path / "out")])
    assert 1 <= app.pipeline.latency_stats()["chunks"] < 7  # stopped early: 6 s would be 7 blocks
    assert app.all_results


_NOT_READ = (NotImplementedError, "not ported")
_TORCHRUN = (ValueError, "one rank per card: torchrun --nproc-per-node 2")


@pytest.mark.parametrize("flags,refusal", [
    (["--data-parallel", "2"], _TORCHRUN), (["--model-parallel", "2"], _TORCHRUN),
    (["--slices", "2"], None),
    (["--checkpoint-dir", "ORBAX_DIR"], _NOT_READ),
    (["--sense-voice", "ORBAX_DIR"], _NOT_READ), (["--sep-checkpoint", "ORBAX_DIR"], _NOT_READ),
    (["--spk-embed-model", "ORBAX_DIR"], _NOT_READ), (["--osd-checkpoint", "ORBAX_DIR"], _NOT_READ),
])
def test_streaming_app_unported_flags_raise(target_wav, tmp_path, flags, refusal):
    """(.onnx model files load since the ONNX slice; an orbax directory of a
    weight flag still raises.) --data-parallel / --model-parallel above 1 in
    one process raise with the torchrun command to run (the gloo ranks of
    tests/test_torch_mesh_ranks.py run them); --slices without a mesh does
    nothing, as in JAX, and the replay runs."""
    # a directory an orbax checkpointer wrote (the port's own loads)
    (tmp_path / "orbax").mkdir()
    (tmp_path / "orbax" / "_CHECKPOINT_METADATA").write_text("{}")
    flags = [str(tmp_path / "orbax") if f == "ORBAX_DIR" else f for f in flags]
    argv = ["--target-wav", target_wav, "--preset", "tiny", "--provider", "cpu",
            "--output-dir", str(tmp_path), *flags]
    if refusal is None:
        write_wav(tmp_path / "mix.wav", _tone(2.0, 440), SR)
        app = streaming_overlap_3src.main([*argv, "--input-wav", str(tmp_path / "mix.wav"),
                                           "--no-realtime", "--process-seconds", "2",
                                           "--max-segment-sec", "8"])
        assert app.pipeline.latency_stats()["chunks"] >= 1 and app.all_results
        return
    with pytest.raises(refusal[0], match=refusal[1]):
        streaming_overlap_3src.main(argv)


def test_streaming_app_beam_search_needs_the_transducer(target_wav, tmp_path):
    """--decoding-method modified_beam_search is ported: without --encoder it
    raises the JAX package's ValueError (beam search is a transducer
    decoder), not NotImplementedError."""
    with pytest.raises(ValueError, match="only supported for the transducer"):
        streaming_overlap_3src.main(["--target-wav", target_wav, "--preset", "tiny",
                                     "--provider", "cpu", "--output-dir", str(tmp_path),
                                     "--decoding-method", "modified_beam_search"])


def test_streaming_app_without_a_card_raises(target_wav, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists here")
    assert streaming_overlap_3src.parse_args(["--target-wav", "t.wav"]).provider == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming_overlap_3src.main(["--target-wav", target_wav, "--preset", "tiny",
                                     "--output-dir", str(tmp_path)])


# ------------------------------------------------------------ ring buffer
def test_ring_push_pop_fifo():
    rb = RingBuffer(1024)
    x = np.arange(100, dtype=np.float32)
    assert rb.push(x) == 100 and rb.size == 100
    np.testing.assert_array_equal(rb.pop(60), x[:60])
    np.testing.assert_array_equal(rb.pop(100), x[60:])  # only 40 left
    assert rb.size == 0 and rb.pop(5).size == 0


def test_ring_overflow_drops_newest():
    rb = RingBuffer(16)
    assert rb.push(np.arange(32, dtype=np.float32)) == 16
    assert rb.dropped == 16 and rb.size == 16
    np.testing.assert_array_equal(rb.pop(16), np.arange(16, dtype=np.float32))
    assert rb.push(np.ones(4, np.float64)) == 4 and rb.pop(4).dtype == np.float32


def test_ring_wraparound():
    rb = RingBuffer(8)
    rb.push(np.arange(6, dtype=np.float32))
    rb.pop(6)
    x = np.arange(10, 18, dtype=np.float32)
    assert rb.push(x) == 8
    np.testing.assert_array_equal(rb.pop(8), x)


def test_ring_one_producer_one_consumer():
    rb = RingBuffer(1 << 14)
    total = 50_000
    out = []
    deadline = time.time() + 60

    def producer():
        sent = 0
        while sent < total and time.time() < deadline:
            n = min(997, total - sent)
            chunk = np.arange(sent, sent + n, dtype=np.float32)
            done = 0
            while done < n and time.time() < deadline:
                done += rb.push(chunk[done:])
            sent += n

    def consumer():
        got = 0
        while got < total and time.time() < deadline:
            y = rb.pop(1024)
            if y.size:
                out.append(y)
                got += y.size

    threads = [threading.Thread(target=producer), threading.Thread(target=consumer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    assert not any(t.is_alive() for t in threads)
    np.testing.assert_array_equal(np.concatenate(out), np.arange(total, dtype=np.float32))
