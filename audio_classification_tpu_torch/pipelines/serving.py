"""Multi-session streaming server: N concurrent streams, one device (port
of audio_classification_tpu/pipelines/serving.py).

The single-session streaming pipeline serves one capture and one enrolled
target per worker thread; many simultaneous callers would mean one process
per stream, each paying its own per-chunk model calls. Here any number of
sessions share ONE StageEngine, and every tick gathers the pending chunk
from each session and runs the whole set through the same bucketed stages:

  tick:  [chunk_s1, chunk_s2, ...] -> OSD (one batched launch)
         -> clean rows (all sessions)   -> fused SV+ASR launch
         -> overlap + full-chunk rows   -> fused sep+SV+ASR launch
         -> per-branch extras           -> one batched transcribe

so S sessions cost about one set of launches per tick instead of S. Per-session
semantics (record fields, the unconditional full_separation row, every
branch clearing the SV threshold emitted) are identical to
StreamingOverlap3Pipeline (tests hold the records to solo runs).

Per-session enrollment is one embed call at open_session; per-session
ordering is preserved by taking at most one pending chunk per session per
tick. Backpressure mirrors the single-session pipeline: a bounded pending
queue per session that drops the oldest chunk when full. The tick thread
runs the engine only through its public methods, which set
``torch.inference_mode`` themselves (the mode is thread-local); as in the
reference it prints a tick's failure and goes on, and ``stats()["ticks"]``
counts only the ticks that ran to the end.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from ..audio_io import read_wav, to_mono
from ..engine.runtime import G_SAMPLE_RATE, StageEngine
from .offline_overlap3 import build_engine


@dataclass
class _Session:
    sid: int
    target_vec: np.ndarray
    target_text: str
    pending: List[dict] = field(default_factory=list)   # [{audio, start, end}]
    results: List[dict] = field(default_factory=list)
    buffered: List[np.ndarray] = field(default_factory=list)
    closed: bool = False


class StreamingServer:
    """Cross-session-batched streaming serving over one StageEngine."""

    MAX_PENDING = 4  # per-session backpressure bound (chunks)

    def __init__(self, args, engine: Optional[StageEngine] = None,
                 autostart: bool = True):
        """``autostart=False`` skips the background tick thread; the caller
        then drives ticks synchronously with step() — the embedding-friendly
        (and deterministic-test) mode."""
        self.args = args
        self.engine = engine or build_engine(args)
        self._sessions: Dict[int, _Session] = {}
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        # serializes StageEngine access between the tick thread and callers
        # that hit the engine directly (open_session enrollment): two threads
        # share one engine, one CUDA stream and one kernel build
        self._eng_lock = threading.Lock()
        self._stopped = False
        self.tick_latencies: List[float] = []
        self.tick_batch_sizes: List[int] = []
        # capture-to-text latency per EMITTED record: emit time minus the
        # moment the session's window was enqueued — what one caller
        # experiences at capacity (queue wait + batched tick compute),
        # not just how long a tick takes
        self.session_latencies: List[float] = []
        self.chunks_dropped = 0
        self._worker = None
        if autostart:
            self._worker = threading.Thread(target=self._tick_loop, daemon=True,
                                            name="serving-ticks")
            self._worker.start()

    # ---------------------------------------------------------- sessions
    def open_session(self, target_wav: str = "", target_vec: Optional[np.ndarray] = None,
                     transcribe_target: bool = True) -> int:
        """Enroll a target speaker and return the session id.

        ``target_wav`` path or a precomputed l2-normalized ``target_vec``
        (e.g. from an embedding cache): one of the two.
        """
        eng = self.engine
        text = ""
        if target_vec is None:
            if not target_wav:
                raise ValueError("open_session needs target_wav or target_vec")
            wav, sr = read_wav(target_wav)
            wav = to_mono(wav)
            with self._eng_lock:   # don't race the tick thread's dispatch
                t_np = eng.resample(wav, sr, G_SAMPLE_RATE)
                target_vec = eng.embed([t_np])[0]
                if transcribe_target:
                    text = eng.transcribe(
                        [t_np], getattr(self.args, "language", "auto"))[0]
        with self._lock:
            sid = next(self._ids)
            self._sessions[sid] = _Session(sid, np.asarray(target_vec, np.float32), text)
        return sid

    def close_session(self, sid: int) -> None:
        with self._lock:
            s = self._sessions.get(sid)
            if s is not None:
                s.closed = True
                s.pending.clear()
                s.buffered.clear()

    # ------------------------------------------------------------- input
    def add_audio(self, sid: int, chunk: np.ndarray,
                  sample_rate: Optional[int] = None) -> None:
        """Buffer audio for a session; a full process window enqueues work.

        Chunks accumulate until ``process_seconds`` of audio is buffered
        (the streaming app's windowing), then the window becomes one pending tick item.
        """
        sr = int(sample_rate or getattr(self.args, "sample_rate", G_SAMPLE_RATE))
        window = float(getattr(self.args, "process_seconds", 2.0))
        with self._lock:
            s = self._require(sid)
            s.buffered.append(np.asarray(chunk, np.float32))
            if sum(len(c) for c in s.buffered) >= window * sr:
                self._enqueue_locked(s, sr)

    def flush(self, sid: int) -> None:
        """Force a partial window into the tick queue."""
        sr = int(getattr(self.args, "sample_rate", G_SAMPLE_RATE))
        with self._lock:
            s = self._require(sid)
            if s.buffered:
                self._enqueue_locked(s, sr)

    def _require(self, sid: int) -> _Session:
        s = self._sessions.get(sid)
        if s is None or s.closed:
            raise KeyError(f"no open session {sid}")
        return s

    def _enqueue_locked(self, s: _Session, sr: int) -> None:
        audio = np.concatenate(s.buffered)
        s.buffered.clear()
        now = time.time()
        item = dict(audio=audio, sr=sr, start=now - len(audio) / sr, end=now)
        if len(s.pending) >= self.MAX_PENDING:   # drop-oldest backpressure
            s.pending.pop(0)
            self.chunks_dropped += 1
        s.pending.append(item)
        self._wake.notify()

    def pending_depth(self, sid: int) -> int:
        """Pending (unprocessed) windows for a session — file-replay feeders
        pace on this instead of tripping drop-oldest backpressure (which is
        meant for live capture that cannot wait)."""
        with self._lock:
            s = self._sessions.get(sid)
            return len(s.pending) if s is not None and not s.closed else 0

    # ------------------------------------------------------------ output
    def get_results(self, sid: int) -> List[Dict[str, Any]]:
        with self._lock:
            s = self._sessions.get(sid)
            if s is None:
                return []
            out, s.results = s.results, []
            return out

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until every pending chunk has been processed.

        Returns True when the queue drained; False on timeout (work still
        pending or a tick still running) so callers can tell a complete
        result set from a truncated one."""
        t0 = time.time()
        while time.time() - t0 < timeout:
            with self._lock:
                if not any(s.pending for s in self._sessions.values()):
                    if not self._busy:
                        return True
            time.sleep(0.02)
        return False

    def close(self) -> None:
        with self._lock:
            self._stopped = True
            self._wake.notify()
        if self._worker is not None:
            self._worker.join(timeout=300)

    def step(self) -> int:
        """Run ONE tick synchronously (autostart=False mode): gather the
        pending chunk from every session, process them as one batched pass.
        Returns the number of chunks processed."""
        with self._lock:
            work = self._gather_work_locked()
        if not work:
            return 0
        t0 = time.time()
        self._tick(work)
        self.tick_latencies.append(time.time() - t0)
        self.tick_batch_sizes.append(len(work))
        return len(work)

    def stats(self) -> Dict[str, Any]:
        """Aggregate serving stats: tick latency percentiles + how much
        cross-session batching each tick achieved."""
        if not self.tick_latencies:
            return {}
        lat = np.asarray(self.tick_latencies)
        bs = np.asarray(self.tick_batch_sizes)
        out = {
            "ticks": int(lat.size),
            "sessions": len([s for s in self._sessions.values() if not s.closed]),
            "tick_latency_mean_sec": round(float(lat.mean()), 4),
            "tick_latency_p95_sec": round(float(np.percentile(lat, 95)), 4),
            "chunks_per_tick_mean": round(float(bs.mean()), 2),
            "chunks_per_tick_max": int(bs.max()),
            "chunks_dropped": self.chunks_dropped,
        }
        if self.session_latencies:
            sl = np.asarray(self.session_latencies)
            out["session_latency_p50_sec"] = round(float(np.percentile(sl, 50)), 4)
            out["session_latency_p95_sec"] = round(float(np.percentile(sl, 95)), 4)
            out["session_latency_records"] = int(sl.size)
        return out

    # ------------------------------------------------------------- ticks
    _busy = False

    def _gather_work_locked(self) -> List[tuple]:
        # one pending chunk per session per tick: fair batching,
        # per-session ordering preserved
        work = []
        for s in self._sessions.values():
            if s.pending and not s.closed:
                work.append((s, s.pending.pop(0)))
        return work

    def _tick_loop(self) -> None:
        while True:
            with self._lock:
                while not self._stopped and not any(
                    s.pending for s in self._sessions.values()
                ):
                    self._wake.wait(timeout=0.5)
                if self._stopped:
                    return
                work = self._gather_work_locked()
                self._busy = True
            if not work:
                with self._lock:
                    self._busy = False
                continue
            try:
                t0 = time.time()
                self._tick(work)
                self.tick_latencies.append(time.time() - t0)
                self.tick_batch_sizes.append(len(work))
            except Exception as e:  # keep serving on a bad tick
                print(f"serving tick error: {type(e).__name__}: {e}")
            finally:
                with self._lock:
                    self._busy = False

    def _tick(self, work: List[tuple]) -> None:
        """Process one chunk from each active session as ONE batched pass."""
        with self._eng_lock:
            self._tick_compute(work)

    def _tick_compute(self, work: List[tuple]) -> None:
        eng, args = self.engine, self.args
        lang = getattr(args, "language", "auto")
        thr = float(getattr(args, "sv_threshold", 0.6))
        min_ov = float(getattr(args, "min_overlap_dur", 0.4))
        backend = getattr(args, "sep_backend", "convtasnet")

        # resample non-16k sessions in one bucketed batch per source rate
        # instead of one resampler call per session per tick
        chunks = [np.asarray(item["audio"], np.float32) for _s, item in work]
        by_sr: Dict[int, List[int]] = {}
        for i, (_s, item) in enumerate(work):
            if item["sr"] != G_SAMPLE_RATE:
                by_sr.setdefault(int(item["sr"]), []).append(i)
        for src_sr, idxs in by_sr.items():
            for i, w in zip(idxs, eng.resample_batch(
                    [chunks[i] for i in idxs], src_sr, G_SAMPLE_RATE)):
                chunks[i] = w

        # one ARENA upload per tick: every session chunk's audio goes to the
        # device ONCE; the OSD batch, the unconditional whole-chunk
        # separation rows and the OSD-derived segment rows below all gather
        # their windows from it on the device. Per-batch uploads only when
        # the arena can't serve the input (chunks over the bucket cap).
        arena = eng.upload_arena(chunks)
        # OSD across every session's chunk in one batched launch; the
        # whole-chunk separation rows don't depend on OSD output, so their
        # fused launch is queued BEFORE the OSD collect and the device goes
        # on while the host waits for the OSD probabilities
        h_osd = (eng.launch_osd_arena(arena) if arena is not None
                 else eng.launch_osd_batch(chunks, G_SAMPLE_RATE))
        # sep/SV/ASR wall from here: with the launch overlap it also covers
        # the OSD collect it hides behind the separation dispatch
        t_a = time.time()
        full_rows = [dict(s=s, item=item, chunk=audio, kind="full_separation",
                          start=item["start"], end=item["end"])
                     for (s, item), audio in zip(work, chunks)]
        full_tv = [r["s"].target_vec for r in full_rows]
        if arena is not None:
            full_spans = [(int(arena.offsets[i]), int(arena.lengths[i]))
                          for i in range(len(chunks))]
            h_full = eng.launch_overlap(None, full_tv, lang,
                                        return_branches=True, backend=backend,
                                        arena=arena, spans=full_spans)
        else:
            h_full = eng.launch_overlap([r["chunk"] for r in full_rows],
                                        full_tv, lang,
                                        return_branches=True, backend=backend)
        seg_lists = eng.collect_osd_batch(
            h_osd, getattr(args, "osd_thr", 0.5),
            getattr(args, "osd_win", 0.5), getattr(args, "osd_hop", 0.1))

        clean_rows: List[dict] = []
        ov_rows: List[dict] = []
        for si, ((s, item), audio, segs) in enumerate(zip(work, chunks, seg_lists)):
            if not segs:
                segs = [(0.0, len(audio) / G_SAMPLE_RATE, False)]
            for start, end, is_overlap in segs:
                a, b = int(start * G_SAMPLE_RATE), int(end * G_SAMPLE_RATE)
                sub = audio[a:b]
                if sub.size == 0:
                    continue
                row = dict(s=s, item=item, chunk=sub,
                           start=item["start"] + start, end=item["start"] + end)
                if arena is not None:
                    # segment window into the tick arena (device gather)
                    row["span"] = (int(arena.offsets[si]) + a, b - a)
                if is_overlap and (end - start) >= min_ov:
                    row["kind"] = "overlap"
                    ov_rows.append(row)
                else:
                    row["kind"] = "clean"
                    clean_rows.append(row)

        # back-to-back fused launches for the OSD-derived rows, then collect
        kw_cl = (dict(arena=arena, spans=[r["span"] for r in clean_rows])
                 if arena is not None else {})
        kw_ov = (dict(arena=arena, spans=[r["span"] for r in ov_rows])
                 if arena is not None else {})
        h_cl = eng.launch_clean([r["chunk"] for r in clean_rows],
                                [r["s"].target_vec for r in clean_rows],
                                lang, **kw_cl) if clean_rows else None
        h_ov = (eng.launch_overlap([r["chunk"] for r in ov_rows],
                                   [r["s"].target_vec for r in ov_rows],
                                   lang, return_branches=True, backend=backend,
                                   **kw_ov)
                if ov_rows else None)

        emitted: List[dict] = []
        if h_cl is not None:
            for row, (score, text) in zip(clean_rows, eng.collect_clean(h_cl)):
                if score >= thr:
                    emitted.append(dict(row=row, stream=None, sv_score=float(score),
                                        text=text))
        extra_refs: List[tuple] = []
        extras: List[dict] = []
        for handle, rows in ((h_ov, ov_rows), (h_full, full_rows)):
            if handle is None:
                continue
            for row, rec in zip(rows, eng.collect_overlap(
                    handle, [r["chunk"] for r in rows], return_branches=True,
                    backend=backend, lazy_branches=True)):
                for bi, sc in enumerate(np.asarray(rec["scores"])):
                    if sc < thr:
                        continue
                    if bi == rec["best"]:
                        emitted.append(dict(row=row, stream=bi, sv_score=float(sc),
                                            text=rec["text"]))
                    else:   # non-best branches over threshold: batched transcribe
                        extra_refs.append(rec["branches"].ref(bi))
                        extras.append(dict(row=row, stream=bi, sv_score=float(sc)))
        if extra_refs:
            # extras ASR runs straight off the device-resident branches:
            # an on-device gather + quantise feeds the ASR batch, so the
            # branch audio never visits the host
            for ex, text in zip(extras, eng.transcribe_branches(extra_refs, lang)):
                emitted.append(dict(text=text, **ex))
        asr_elapsed = time.time() - t_a

        total = sum(len(e["row"]["chunk"]) for e in emitted) or 1
        now = time.time()
        with self._lock:
            for e in emitted:
                row = e["row"]
                s = row["s"]
                if s.closed:
                    continue
                self.session_latencies.append(now - row["item"]["end"])
                s.results.append({
                    "start": row["start"],
                    "end": row["end"],
                    "kind": row["kind"],
                    "stream": e["stream"],
                    "text": e["text"],
                    "asr_time": asr_elapsed * len(row["chunk"]) / total,
                    "sv_score": e["sv_score"],
                    "target_src_text": s.target_text,
                })
