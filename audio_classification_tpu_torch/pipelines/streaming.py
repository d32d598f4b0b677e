"""Streaming overlap-3src pipeline, the low-latency chunked path (port of
audio_classification_tpu/pipelines/streaming.py).

`StreamingOverlap3Pipeline` keeps the reference's public API
(`add_audio_data(chunk)`, `get_results()`, `flush_buffer()`, `drain()`,
`close()`, `warmup()`, `latency_stats()`) and its per-chunk behaviour: OSD
over the buffered chunk; clean spans -> SV gate -> ASR; overlap spans ->
3-source separation -> per-branch SV -> ASR; plus the unconditional
whole-chunk separation that emits kind="full_separation" records.

A single bounded worker thread drains a queue of chunks; within a chunk all
rows of a kind batch into one fused engine launch. The worker runs the
engine only through its public methods, which set ``torch.inference_mode``
themselves (the mode is thread-local). As in the reference, the worker
prints a chunk's failure and goes on; ``latency_stats()["chunks"]`` counts
only the chunks that were analysed to the end, so a caller can tell.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from ..audio_io import read_wav, to_mono
from ..engine.runtime import G_SAMPLE_RATE, StageEngine
from ..parallel.collectives import spans_ranks, world_min
from .offline_overlap3 import build_engine


_FEED_END = 2 ** 62   # a closed feed, in the ranks' agreement on a chunk


@dataclass
class StreamingSegment:
    """One buffered audio chunk queued for analysis."""

    audio_data: np.ndarray
    start_time: float
    end_time: float
    sample_rate: int
    is_overlap: bool = False
    stream_id: Optional[int] = None
    seq: int = 0   # the chunk's number in its pipeline's feed


class StreamingOverlap3Pipeline:
    def __init__(self, args, target_wav_path: str, engine: Optional[StageEngine] = None):
        self.args = args
        self.engine = engine or build_engine(args)
        self.audio_buffer: List[np.ndarray] = []
        self.chunk_latencies: List[float] = []   # per-chunk processing wall time
        self.results_queue: "queue.Queue[Dict[str, Any]]" = queue.Queue()
        self._work: "queue.Queue[Optional[StreamingSegment]]" = queue.Queue(maxsize=8)
        self._worker = threading.Thread(target=self._worker_loop, daemon=True, name="overlap3-worker")
        self._stopped = False
        self._chunks_in = 0
        self._load_target_speaker(target_wav_path)
        self._worker.start()

    # ------------------------------------------------------------- setup
    def _load_target_speaker(self, target_wav_path: str):
        wav, sr = read_wav(target_wav_path)
        wav = to_mono(wav)
        print(f"Target audio original sample rate: {sr}Hz")
        if sr != G_SAMPLE_RATE:
            print(f"Resampling target audio from {sr}Hz to {G_SAMPLE_RATE}Hz")
        t_np = self.engine.resample(wav, sr, G_SAMPLE_RATE)
        self.enrolled_vec_norm = self.engine.embed([t_np])[0]
        self.target_src_text = self.engine.transcribe([t_np], getattr(self.args, "language", "auto"))[0]
        print(f"Target speaker enrolled. Text: '{self.target_src_text}'")

    def warmup(self, chunk_sec: float = 5.0):
        """Run one silent chunk through every stage, so the first real
        chunk pays no first-use cost (kernel build and load, allocator
        growth, library initialisation)."""
        sr = int(getattr(self.args, "sample_rate", G_SAMPLE_RATE))
        chunk = np.zeros(int(chunk_sec * sr), np.float32)
        seg = StreamingSegment(chunk, 0.0, chunk_sec, sr)
        self._analyze_segment(seg)
        while not self.results_queue.empty():
            self.results_queue.get()

    # ------------------------------------------------------------- input
    def add_audio_data(self, audio_chunk: np.ndarray):
        self.audio_buffer.append(np.asarray(audio_chunk, np.float32))
        self._process_audio_chunk()

    def _process_audio_chunk(self):
        if not self.audio_buffer:
            return
        audio = np.concatenate(self.audio_buffer)
        self.audio_buffer = []
        now = time.time()
        sr = int(getattr(self.args, "sample_rate", G_SAMPLE_RATE))
        seg = StreamingSegment(audio, now - len(audio) / sr, now, sr, seq=self._chunks_in)
        self._chunks_in += 1
        try:
            self._work.put_nowait(seg)
        except queue.Full:
            # bounded backpressure: drop the oldest pending chunk
            try:
                self._work.get_nowait()
            except queue.Empty:
                pass
            self._work.put_nowait(seg)

    def flush_buffer(self):
        if self.audio_buffer:
            self._process_audio_chunk()

    def drain(self, timeout: float = 30.0):
        """Block until queued chunks are processed (test/shutdown helper)."""
        t0 = time.time()
        while not self._work.empty() and time.time() - t0 < timeout:
            time.sleep(0.02)

    def close(self):
        # The worker must not be left alive inside a device call at
        # interpreter shutdown, so wait for the in-flight chunk to finish
        # before returning.
        self._stopped = True
        self._work.put(None)
        self._worker.join(timeout=300)

    # ------------------------------------------------------------- worker
    def _worker_loop(self):
        lockstep = spans_ranks(self.engine.mesh)
        while True:
            seg = self._work.get()
            if lockstep:
                seg = self._agreed_segment(seg)
            if seg is None or (self._stopped and not lockstep):
                return
            try:
                t0 = time.time()
                self._analyze_segment(seg)
                self.chunk_latencies.append(time.time() - t0)
            except Exception as e:  # keep the worker alive on bad chunks
                print(f"Segment analysis error: {e}")

    def _agreed_segment(self, seg: Optional[StreamingSegment]) -> Optional[StreamingSegment]:
        """Under an engine mesh over several ranks every rank runs this
        pipeline on the same feed, each queue with its own drop-oldest
        bound, and a chunk's analysis is a collective. The ranks agree
        (collectives.world_min) on the newest of the chunks they took; a rank
        behind it takes further chunks up to it, and a rank's closed feed
        stands past every chunk. -> the agreed chunk, or None to stop."""
        mesh = self.engine.mesh
        while True:
            mine = _FEED_END if seg is None else seg.seq
            newest, oldest = world_min([-mine, mine], mesh)
            if -newest == oldest:
                return seg
            while seg is not None and seg.seq < -newest:
                seg = self._work.get()

    def _analyze_segment(self, segment: StreamingSegment):
        eng = self.engine
        args = self.args
        sr = segment.sample_rate
        audio = segment.audio_data
        if sr != G_SAMPLE_RATE:
            audio = eng.resample(audio, sr, G_SAMPLE_RATE)
            sr = G_SAMPLE_RATE

        tv = self.enrolled_vec_norm
        lang = getattr(args, "language", "auto")
        backend = getattr(args, "sep_backend", "convtasnet")

        # the unconditional full-chunk separation doesn't depend on OSD
        # output, so its fused launch is queued right behind the OSD batch:
        # the device works through both while the host waits for OSD only
        h_osd = eng.launch_osd_batch([audio], sr)
        h_full = eng.launch_overlap([audio], [tv], lang, return_branches=True,
                                    backend=backend)
        osd_segments = eng.collect_osd_batch(
            h_osd, args.osd_thr, args.osd_win, args.osd_hop)[0]
        if not osd_segments:
            osd_segments = [(0.0, len(audio) / sr, False)]

        # collect work: clean chunks + overlap chunks from the OSD segments
        clean_items: List[dict] = []
        overlap_rows: List[dict] = []
        for start, end, is_overlap in osd_segments:
            a, b = int(start * sr), int(end * sr)
            sub = audio[a:b]
            if sub.size == 0:
                continue
            if is_overlap and (end - start) >= args.min_overlap_dur:
                overlap_rows.append(dict(a=a, b=b, chunk=sub))
            else:
                clean_items.append(dict(a=a, b=b, chunk=sub))

        results: List[dict] = []
        t_a = time.time()

        # back-to-back fused launches for the OSD-derived rows, collects
        # after both are in flight
        h_cl = (eng.launch_clean([c["chunk"] for c in clean_items],
                                 [tv] * len(clean_items), lang)
                if clean_items else None)
        h_ov = (eng.launch_overlap([r["chunk"] for r in overlap_rows],
                                   [tv] * len(overlap_rows), lang,
                                   return_branches=True, backend=backend)
                if overlap_rows else None)

        if h_cl is not None:
            for c, (score, text) in zip(clean_items, eng.collect_clean(h_cl)):
                if score >= args.sv_threshold:
                    results.append(dict(kind="clean", stream=None, sv_score=float(score),
                                        text=text, samples=len(c["chunk"]),
                                        start=segment.start_time + c["a"] / sr,
                                        end=segment.start_time + c["b"] / sr))

        # the streaming contract emits EVERY branch clearing the threshold
        # (reference behavior), so non-best branches above threshold fall
        # back to a granular branch fetch + transcribe
        ov_meta = [
            dict(kind="overlap", start=segment.start_time + r["a"] / sr,
                 end=segment.start_time + r["b"] / sr)
            for r in overlap_rows
        ]
        full_meta = [dict(kind="full_separation", start=segment.start_time,
                          end=segment.end_time)]
        extra_branch_refs: List[tuple] = []
        extra_meta: List[dict] = []
        for handle, metas, inputs in (
            (h_ov, ov_meta, [r["chunk"] for r in overlap_rows]),
            (h_full, full_meta, [audio]),
        ):
            if handle is None:
                continue
            for rec, meta, chunk in zip(
                eng.collect_overlap(handle, inputs, return_branches=True,
                                    backend=backend, lazy_branches=True),
                metas, inputs,
            ):
                scores = np.asarray(rec["scores"])
                for bi, sc in enumerate(scores):
                    if sc < args.sv_threshold:
                        continue
                    if bi == rec["best"]:
                        results.append(dict(kind=meta["kind"], stream=bi,
                                            sv_score=float(sc),
                                            text=rec["text"], samples=len(chunk),
                                            start=meta["start"], end=meta["end"]))
                    else:
                        extra_branch_refs.append(rec["branches"].ref(bi))
                        extra_meta.append(dict(kind=meta["kind"], stream=bi,
                                               sv_score=float(sc),
                                               samples=len(chunk),
                                               start=meta["start"], end=meta["end"]))
        if extra_branch_refs:
            # extras ASR straight off the device-resident branches (one
            # on-device gather + quantise into the ASR batch)
            for meta, text in zip(extra_meta,
                                   eng.transcribe_branches(extra_branch_refs, lang)):
                results.append(dict(text=text, **meta))

        asr_elapsed = time.time() - t_a
        total = sum(r["samples"] for r in results) or 1
        for rec in results:
            self.results_queue.put({
                "start": rec["start"],
                "end": rec["end"],
                "kind": rec["kind"],
                "stream": rec["stream"],
                "text": rec["text"],
                "asr_time": asr_elapsed * rec["samples"] / total,
                "sv_score": rec["sv_score"],
                "target_src_text": self.target_src_text,
            })

    def latency_stats(self) -> Dict[str, float]:
        """Per-chunk processing latency summary (seconds).

        Chunk latency against chunk duration is the streaming real-time
        margin. ``chunks`` counts the chunks analysed to the end.
        """
        if not self.chunk_latencies:
            return {}
        arr = np.asarray(self.chunk_latencies)
        return {
            "chunks": int(arr.size),
            "latency_mean_sec": round(float(arr.mean()), 4),
            "latency_p95_sec": round(float(np.percentile(arr, 95)), 4),
            "latency_max_sec": round(float(arr.max()), 4),
        }

    # ------------------------------------------------------------- output
    def get_results(self) -> List[Dict[str, Any]]:
        results = []
        while not self.results_queue.empty():
            results.append(self.results_queue.get())
        return results
