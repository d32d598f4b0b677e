"""The port's tracer (utils/profiling): off, it records nothing and enters no
profiler range; on, spans nest by parent and job, the engine's launch and
wait spans carry their counters, only ``engine.*`` spans are mirrored onto a
profiler's clock (and land where the profiler put them, by the anchor), one
pipeline run is one job whose brackets the time_* fields are summed from,
and ``--trace-spans`` writes the store (tiny preset, CPU)."""
import gc
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audio_classification_tpu_torch.audio_io import write_wav
from audio_classification_tpu_torch.cli.offline_overlap_3src import main
from audio_classification_tpu_torch.engine import BucketSpec, ModelPack, StageEngine, tiny_preset
from audio_classification_tpu_torch.engine.bucketing import default_buckets
from audio_classification_tpu_torch.pipelines.offline_overlap3 import Overlap3Pipeline
from audio_classification_tpu_torch.utils import profiling
from audio_classification_tpu_torch.utils.config import Overlap3Config

torch.set_num_threads(2)
SR = 16000


@pytest.fixture(autouse=True)
def tracer_off():
    profiling.disable()
    profiling.clear()
    yield
    profiling.disable()
    profiling.clear()


@pytest.fixture(scope="module")
def eng():
    return StageEngine(ModelPack(tiny_preset(), seed=0, device="cpu"),
                       BucketSpec(default_buckets(SR, 0.5, 4.0), 4))


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tracing")
    rng = np.random.default_rng(0)
    t = np.arange(3 * SR) / SR
    mix = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 990 * t)
           + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    write_wav(d / "mix.wav", mix, SR)
    write_wav(d / "target.wav", (0.3 * np.sin(2 * np.pi * 440 * t[: 2 * SR])).astype(np.float32),
              SR)
    return d


def _noise(seed, n):
    return (0.3 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def _engine_calls(eng):
    """One call of each engine path the pipeline uses, and the resamplers."""
    wav, short = _noise(1, SR), _noise(2, SR // 2)
    vec = eng.embed([wav])[0]
    eng.osd_segments(wav, SR, 0.5, 0.5, 0.1)
    eng.collect_overlap(eng.launch_overlap([wav, short], [vec, vec]), [wav, short])
    eng.collect_clean(eng.launch_clean([wav], [vec]))
    eng.transcribe([wav])
    eng.resample(wav, 8000)
    eng.resample_batch([wav, short], 8000)


def test_off_the_engine_records_nothing_and_enters_no_profiler_range(eng, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    assert not profiling.on()
    assert profiling.span("engine.x") is profiling.OFF
    _engine_calls(eng)
    assert entered == [] and profiling.spans() == [] and profiling.anchors() == []


def test_spans_nest_by_parent_and_job_per_thread():
    profiling.enable()
    with profiling.bracket("pipeline.job", new_job=True) as job:
        with profiling.span("pipeline.a") as a:
            with profiling.span("engine.b", n=1) as b:
                b.set(n=3)
                profiling.note(m=2)
        other = threading.Thread(target=lambda: profiling.span("engine.t").__enter__().__exit__())
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
    with profiling.span("engine.c"):
        pass
    by = {r.name: r for r in profiling.spans()}
    assert set(by) == {"pipeline.job", "pipeline.a", "engine.b", "engine.t", "engine.c"}
    assert (by["pipeline.job"].parent, by["pipeline.job"].job) == (0, job.id)
    assert (by["pipeline.a"].parent, by["pipeline.a"].job) == (job.id, job.id)
    assert (by["engine.b"].parent, by["engine.b"].job) == (a.id, job.id)
    assert by["engine.b"].attrs == {"n": 3, "m": 2}
    assert (by["engine.t"].parent, by["engine.t"].job) == (0, 0)  # its own thread's stack
    assert by["engine.t"].thread != by["engine.b"].thread
    assert (by["engine.c"].parent, by["engine.c"].job) == (0, 0)
    for r in by.values():
        assert r.end_ns >= r.start_ns
    assert by["pipeline.job"].start_ns <= by["engine.b"].start_ns
    assert by["engine.b"].end_ns <= by["pipeline.job"].end_ns


def test_a_bracket_times_itself_with_the_tracer_off():
    with profiling.bracket("pipeline.x") as b:
        sum(range(1000))
    assert b.ns > 0 and profiling.spans() == []


def test_launch_and_wait_spans_carry_occupancy_first_calls_and_copies(eng):
    profiling.enable()
    wav, short = _noise(3, SR), _noise(4, 3 * SR // 4)  # one bucket, one batch
    vec = eng.embed([wav])[0]
    for _ in range(2):
        eng.collect_clean(eng.launch_clean([wav, short], [vec, vec]))
    launches = [r for r in profiling.spans() if r.name == "engine.launch.clean_path"]
    waits = [r for r in profiling.spans() if r.name == "engine.wait.clean_path"]
    bucket = eng.buckets.bucket_for(SR)
    bs = eng.buckets.batch_size_for(2)
    assert launches[1].attrs == {"first_call": 0, "rows_real": 2, "rows_batch": bs,
                                 "samples_valid": SR + 3 * SR // 4, "samples_batch": bs * bucket}
    assert [w.attrs for w in waits] == [{"copies": 3}] * 2  # score, ids, n_tokens
    assert all(w.start_ns >= l.end_ns for l, w in zip(launches, waits))
    # a new program key (another bucket): the first call of its shapes
    eng.collect_clean(eng.launch_clean([_noise(5, 3 * SR)], [vec]))
    last = [r for r in profiling.spans() if r.name == "engine.launch.clean_path"][-1]
    assert last.attrs["first_call"] == 1 and last.start_ns > waits[-1].end_ns


def test_under_a_profiler_only_engine_spans_are_ranges_on_its_clock(eng):
    """Mirrored ranges are the store's ``engine.*`` spans, one for one; the
    store's starts moved by the session's anchor lie within 50 us of them."""
    _engine_calls(eng)  # warm: no first call of a program in the session
    with profile(activities=[ProfilerActivity.CPU]):
        _engine_calls(eng)
    profiling.clear()
    gc.collect()
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("warm-up"):  # the session's first range
                pass
            with profiling.bracket("pipeline.job", new_job=True):
                _engine_calls(eng)
    finally:
        gc.enable()
    assert not profiling.on()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    ranges = sorted((e for e in prof.events()
                     if e.name.startswith(("engine.", "pipeline."))),
                    key=lambda e: e.time_range.start)
    store = sorted((r for r in profiling.spans() if r.name.startswith("engine.")),
                   key=lambda r: r.start_ns)
    assert {r.name for r in profiling.spans()} >= {"pipeline.job", "engine.launch.spk",
                                                    "engine.wait.osd", "engine.overlap"}
    assert [e.name for e in ranges] == [r.name for r in store]
    assert {e.name.split(".")[1] for e in ranges} >= {"launch", "wait", "osd", "asr"}
    (anchor,) = profiling.anchors()
    for r, e in zip(store, ranges):
        assert abs((r.start_ns + anchor - start_ns) / 1e3 - e.time_range.start) < 50.0, r.name


@pytest.mark.parametrize("osd_thr,fused,kind", [(0.0, True, "overlap"), (1.0, True, "clean"),
                                                (0.0, False, "overlap")])
def test_one_run_is_one_job_whose_brackets_sum_to_the_time_fields(wavs, eng, osd_thr, fused,
                                                                  kind):
    cfg = Overlap3Config(input_wavs=[str(wavs / "mix.wav")], target_wav=str(wavs / "target.wav"),
                         preset="tiny", seed=0, sv_threshold=-1.0, max_batch=4,
                         max_segment_sec=4.0, osd_thr=osd_thr, fused_paths=fused)
    off = Overlap3Pipeline(cfg, engine=eng).run()
    assert profiling.spans() == []
    profiling.enable()
    res = Overlap3Pipeline(cfg, engine=eng).run()
    records = profiling.spans()
    assert [s["kind"] for s in res.segments] == [s["kind"] for s in off.segments] == [kind]
    roots = [r for r in records if r.parent == 0]
    assert [r.name for r in roots] == ["pipeline.job"]
    by_id = {r.id: r for r in records}
    for r in records:
        assert r.job == roots[0].id
        up = r
        while up.parent:
            up = by_id[up.parent]
        assert up is roots[0]
    names = {r.name for r in records}
    assert {"pipeline.load", "pipeline.enroll", "pipeline.osd", "pipeline.rows",
            "pipeline.gate", "pipeline.records"} <= names
    assert ("pipeline.launch" in names) == ("pipeline.collect" in names) == fused
    assert ("pipeline.granular" in names) != fused
    waits = [r for r in records if r.name.startswith("engine.wait.")]
    # the enrollment's embedding and transcript, OSD, the fused path (granular:
    # separation, the branches' embeddings, the best branches' transcripts),
    # the target spans
    assert len(waits) == (5 if fused else 7)

    def secs(*brackets):
        return sum((r.end_ns - r.start_ns) * 1e-9 for r in records if r.name in brackets)

    # the wave's launches count toward time_sep_sec where the overlap path ran
    launched = ("pipeline.launch", "pipeline.collect.overlap")
    booked = {"osd": secs("pipeline.osd"),
              "sep": secs("pipeline.separate") + (secs(*launched) if kind == "overlap" and fused
                                                  else 0.0),
              "asr": secs("pipeline.enroll.asr", "pipeline.collect.clean",
                          "pipeline.collect.target", "pipeline.transcribe")}
    for field, seconds in booked.items():
        assert res.metrics[f"time_{field}_sec"] == round(seconds, 3), field
        assert f"time_{field}_sec" in off.metrics
    assert (res.metrics["time_sep_sec"] > 0) == (kind == "overlap")


@pytest.mark.parametrize("profiled", [False, True])
def test_cli_trace_spans_writes_a_chrome_trace(wavs, tmp_path, profiled):
    path = tmp_path / "spans" / "run.json"
    argv = ["--input-wavs", str(wavs / "mix.wav"), "--target-wav", str(wavs / "target.wav"),
            "--preset", "tiny", "--seed", "0", "--sv-threshold", "-1", "--max-segment-sec", "4",
            "--provider", "cpu", "--out-dir", str(tmp_path / "out"), "--trace-spans", str(path)]
    if profiled:
        argv += ["--profile-dir", str(tmp_path / "prof")]
    main(argv)
    assert not profiling.on() and profiling.spans() == []
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    assert {e["ph"] for e in events} == {"X"}
    (job,) = [e for e in events if e["name"] == "pipeline.job"]
    assert job["args"]["parent"] == 0
    assert all(e["args"]["job"] == job["args"]["id"] for e in events)
    assert {e["args"]["id"] for e in events} >= {e["args"]["parent"] for e in events} - {0}
    launch = next(e for e in events if e["name"].startswith("engine.launch."))
    assert {"rows_real", "rows_batch", "samples_valid", "samples_batch",
            "first_call"} <= set(launch["args"])
    assert all(e["dur"] >= 0 for e in events)
    assert len(doc["anchors_ns"]) == (1 if profiled else 0)
    assert len(list((tmp_path / "prof").glob("torch_trace_*.json"))) == (1 if profiled else 0)
