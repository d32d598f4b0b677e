"""Streaming overlap-3src application, microphone or file-replay capture
(port of audio_classification_tpu/cli/streaming_overlap_3src.py).

Captures 16 kHz audio in chunk_size frames, batches `process_seconds` of
audio into the pipeline, drains results on a second thread, and saves JSONL
periodically and at shutdown.

Capture sources:
- ``--input-wav``: file replay, paced at real time unless --no-realtime;
- the microphone through pyaudio when it is installed (imported only then).

Capture pushes into a bounded ring buffer (audio_io/stream_buffer) and never
blocks; shutdown is a plain queue drain. Runs on the GPU unless
``--provider cpu`` is given; flags whose feature is not ported yet raise
NotImplementedError (pipelines/offline_overlap3.check_ported).

    python -m audio_classification_tpu_torch.cli.streaming_overlap_3src \
        --target-wav target.wav --input-wav mix.wav --no-realtime --quant int8
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from datetime import datetime
from pathlib import Path

import numpy as np

from ..parallel.launch import is_writer
from ..audio_io import RingBuffer, read_wav, to_mono
from ..pipelines.streaming import StreamingOverlap3Pipeline


def parse_args(argv=None):
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--chunk-size", type=int, default=1024, help="Audio chunk size")
    p.add_argument("--process-seconds", type=float, default=2.0,
                   help="Seconds of audio to process each time")
    p.add_argument("--target-wav", required=True, help="Enrollment audio for target speaker")
    p.add_argument("--osd-backend", default="osdnet")
    p.add_argument("--osd-thr", type=float, default=0.5)
    p.add_argument("--osd-win", type=float, default=0.5)
    p.add_argument("--osd-hop", type=float, default=0.1)
    p.add_argument("--sep-backend", default="convtasnet")
    p.add_argument("--sep-checkpoint", default="")
    p.add_argument("--osd-checkpoint", default="", help="OSD weights: a params dir of cli/distill_osd or a pyannote segmentation torch checkpoint (.bin/.ckpt/.pt/.pth); an orbax dir raises (scripts/orbax_to_torch.py converts it)")
    p.add_argument("--paraformer", default="")
    p.add_argument("--sense-voice", default="")
    p.add_argument("--encoder", default="")
    p.add_argument("--decoder", default="")
    p.add_argument("--joiner", default="")
    p.add_argument("--whisper-encoder", default="",
                   help="Whisper-style ASR family (seeded weights unless an .onnx file, "
                        "which is not ported yet: raises)")
    p.add_argument("--whisper-decoder", default="")
    p.add_argument("--tokens", default="")
    p.add_argument("--cmvn", default="", help="kaldi am.mvn CMVN stats for the ASR frontend")
    p.add_argument("--decoding-method", default="greedy_search")
    p.add_argument("--num-active-paths", type=int, default=4,
                   help="beam width for modified_beam_search (transducer)")
    p.add_argument("--feature-dim", type=int, default=80)
    p.add_argument("--language", default="auto")
    p.add_argument("--num-threads", type=int, default=1)
    p.add_argument("--provider", default="cuda",
                   help="Device: cuda (raises when no GPU is found) or cpu")
    p.add_argument("--spk-embed-model", default="", help="Speaker embedding checkpoint")
    p.add_argument("--sv-threshold", type=float, default=0.6)
    p.add_argument("--min-overlap-dur", type=float, default=0.4)
    p.add_argument("--output-dir", default="streaming_results")
    p.add_argument("--save-interval", type=float, default=10.0,
                   help="Save results interval in seconds")
    # capture source
    p.add_argument("--input-wav", default="", help="Replay this wav instead of the microphone")
    p.add_argument("--no-realtime", action="store_true",
                   help="Replay as fast as possible instead of real-time pacing")
    p.add_argument("--max-seconds", type=float, default=0.0,
                   help="Stop after this many captured seconds (0 = until EOF/Ctrl-C)")
    p.add_argument("--preset", default="full", choices=["full", "tiny"])
    p.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="int8: the Conv-TasNet separators and the ASR encoders run "
                        "dynamic int8 (ops/quant); the masker streams int8 weights")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-segment-sec", type=float, default=16.0)
    p.add_argument("--data-parallel", type=int, default=0,
                   help="Shard per-chunk stage batches over N cards, one torchrun "
                        "rank each (torchrun --nproc-per-node N)")
    p.add_argument("--model-parallel", type=int, default=0,
                   help="Shard the separators' TCN hidden dim over M cards "
                        "(mesh = data x model torchrun ranks)")
    p.add_argument("--slices", type=int, default=1,
                   help="Multi-node meshes: the data axis node-major over the ranks")
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16 compute: the models run as a bfloat16 copy of their weights "
                        "(the JAX engine's bf16 mode; every ASR family, OSDNet or an "
                        "--osd-checkpoint PyanNet)")
    return p.parse_args(argv)


class StreamingApplication:
    def __init__(self, args):
        self.args = args
        self.chunk_size = args.chunk_size
        self.chunks_per_process = max(1, int(args.sample_rate * args.process_seconds / args.chunk_size))
        self.pipeline = StreamingOverlap3Pipeline(args, args.target_wav)
        self.ring = RingBuffer(capacity=args.sample_rate * 60)
        self.all_results = []
        self.running = False
        self.output_dir = Path(args.output_dir)
        if is_writer():  # a rank of a mesh: rank 0 writes
            self.output_dir.mkdir(parents=True, exist_ok=True)
        self._threads = []

    # ------------------------------------------------------------ capture
    def _capture_file(self):
        wav, sr = read_wav(self.args.input_wav)
        wav = to_mono(wav)
        if sr != self.args.sample_rate:
            wav = self.pipeline.engine.resample(wav, sr, self.args.sample_rate)
        pos = 0
        chunk = self.chunk_size
        period = chunk / self.args.sample_rate
        next_t = time.time()
        while self.running and pos < len(wav):
            self.ring.push(wav[pos : pos + chunk])
            pos += chunk
            if not self.args.no_realtime:
                next_t += period
                delay = next_t - time.time()
                if delay > 0:
                    time.sleep(delay)
        self.running = False if pos >= len(wav) else self.running

    def _capture_mic(self):  # pragma: no cover - requires hardware
        import pyaudio

        pa = pyaudio.PyAudio()
        stream = pa.open(format=pyaudio.paInt16, channels=1, rate=self.args.sample_rate,
                         input=True, frames_per_buffer=self.chunk_size)
        while self.running:
            data = stream.read(self.chunk_size, exception_on_overflow=False)
            x = np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32768.0
            self.ring.push(x)
        stream.stop_stream()
        stream.close()
        pa.terminate()

    # ------------------------------------------------------------ pumps
    def _pump_loop(self):
        """Pop process_seconds blocks from the ring into the pipeline."""
        block = self.chunks_per_process * self.chunk_size
        captured = 0
        while self.running or self.ring.size > 0:
            if self.ring.size >= block or (not self.running and self.ring.size > 0):
                want = min(block, max(self.ring.size, 1))
                x = self.ring.pop(want)
                if x.size:
                    self.pipeline.add_audio_data(x)
                    captured += x.size
                    if self.args.max_seconds and captured >= self.args.max_seconds * self.args.sample_rate:
                        self.running = False
            else:
                time.sleep(0.01)

    def _result_loop(self):
        last_save = time.time()
        while self.running or not self.pipeline._work.empty():
            for rec in self.pipeline.get_results():
                self.all_results.append(rec)
                print(f"[{rec['kind']}] {rec['start']:.1f}-{rec['end']:.1f}s "
                      f"stream={rec['stream']} sv={rec['sv_score']:.3f}: {rec['text']}")
            if time.time() - last_save >= self.args.save_interval:
                self._save_results()
                last_save = time.time()
            time.sleep(0.05)
        for rec in self.pipeline.get_results():
            self.all_results.append(rec)

    def _save_results(self):
        if not self.all_results or not is_writer():
            return
        ts = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        out = self.output_dir / f"results_{ts}.jsonl"
        with out.open("w", encoding="utf-8") as f:
            for rec in self.all_results:
                f.write(json.dumps(rec, ensure_ascii=False) + "\n")
        print(f"Results saved to {out}")

    # ------------------------------------------------------------ control
    def start(self):
        self.running = True
        cap = self._capture_file if self.args.input_wav else self._capture_mic
        for name, fn in [("capture", cap), ("pump", self._pump_loop), ("results", self._result_loop)]:
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self):
        self.running = False
        for t in self._threads:
            t.join(timeout=10)
        self.pipeline.flush_buffer()
        self.pipeline.drain()
        # close() joins the worker, so the in-flight chunk's results are all
        # enqueued before the final harvest (drain() only waits for the work
        # queue to empty, not for the last _analyze_segment to finish).
        self.pipeline.close()
        for rec in self.pipeline.get_results():
            self.all_results.append(rec)
        stats = self.pipeline.latency_stats()
        if stats:
            print(f"chunk latency: mean {stats['latency_mean_sec']}s "
                  f"p95 {stats['latency_p95_sec']}s over {stats['chunks']} chunks "
                  f"(chunk duration {self.args.process_seconds}s)")
        self._save_results()

    def run_until_done(self):
        self.start()
        try:
            while self.running:
                time.sleep(0.1)
        except KeyboardInterrupt:
            print("Stopping ...")
        # capture ended; let pump/results drain
        time.sleep(0.2)
        self.stop()


def main(argv=None):
    args = parse_args(argv)
    app = StreamingApplication(args)
    print(f"Streaming: process every {args.process_seconds}s, sv_threshold={args.sv_threshold}")
    app.run_until_done()
    print(f"Done. {len(app.all_results)} results.")
    return app


if __name__ == "__main__":
    main()
