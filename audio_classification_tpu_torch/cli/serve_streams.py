"""Multi-session streaming serving runner: N wavs replayed as concurrent
callers over one shared engine (port of
audio_classification_tpu/cli/serve_streams.py).

Each --wav becomes one session; --targets enrolls a per-session target
speaker (one target repeats across sessions). Chunks from all sessions
batch into the same bucketed stages per tick (pipelines/serving).

Prints per-session records as they arrive and, at EOF, the aggregate
serving stats (tick latency percentiles, cross-session chunks per tick).
Runs on the GPU unless ``--provider cpu`` is given; flags whose feature is
not ported yet raise NotImplementedError
(pipelines/offline_overlap3.check_ported).

Example:
  python -m audio_classification_tpu_torch.cli.serve_streams \\
    --wavs call1.wav call2.wav call3.wav --targets spk1.wav spk2.wav spk3.wav \\
    --quant int8 --out records.jsonl
"""
from __future__ import annotations

import argparse
import json
import time

from ..parallel.launch import is_writer
from ..audio_io import read_wav, to_mono
from ..pipelines.serving import StreamingServer


def parse_args(argv=None):
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--wavs", nargs="+", required=True,
                   help="One wav per concurrent session")
    p.add_argument("--targets", nargs="+", required=True,
                   help="Enrollment wav per session (one value repeats)")
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--process-seconds", type=float, default=2.0)
    p.add_argument("--realtime", action="store_true",
                   help="Pace replay at real time instead of max speed")
    p.add_argument("--osd-backend", default="osdnet")
    p.add_argument("--osd-thr", type=float, default=0.5)
    p.add_argument("--osd-win", type=float, default=0.5)
    p.add_argument("--osd-hop", type=float, default=0.1)
    p.add_argument("--sep-backend", default="convtasnet")
    p.add_argument("--sep-checkpoint", default="")
    p.add_argument("--osd-checkpoint", default="")
    p.add_argument("--sense-voice", default="")
    p.add_argument("--paraformer", default="")
    p.add_argument("--encoder", default="")
    p.add_argument("--decoder", default="")
    p.add_argument("--joiner", default="")
    p.add_argument("--whisper-encoder", default="",
                   help="Whisper-style ASR family (seeded weights unless an .onnx file, "
                        "which is not ported yet: raises)")
    p.add_argument("--whisper-decoder", default="")
    p.add_argument("--decoding-method", default="greedy_search",
                   choices=["greedy_search", "modified_beam_search"])
    p.add_argument("--num-active-paths", type=int, default=4,
                   help="beam width for modified_beam_search (transducer)")
    p.add_argument("--tokens", default="")
    p.add_argument("--cmvn", default="")
    p.add_argument("--spk-embed-model", default="")
    p.add_argument("--language", default="auto")
    p.add_argument("--provider", default="cuda",
                   help="Device: cuda (raises when no GPU is found) or cpu")
    p.add_argument("--sv-threshold", type=float, default=0.6)
    p.add_argument("--min-overlap-dur", type=float, default=0.4)
    p.add_argument("--preset", default="full", choices=["full", "tiny"])
    p.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="int8: the Conv-TasNet separators and the ASR encoders run "
                        "dynamic int8 (ops/quant); the masker streams int8 weights")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-batch", type=int, default=16)
    p.add_argument("--max-segment-sec", type=float, default=16.0)
    p.add_argument("--data-parallel", type=int, default=0,
                   help="Shard every tick's cross-session batches over N "
                        "cards, one torchrun rank each")
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
    p.add_argument("--arena-codec", dest="arena_codec", default="i16",
                   choices=["i16", "mulaw"],
                   help="Wave-arena encoding: int16, or 8-bit mu-law (half the bytes)")
    p.add_argument("--out", default="", help="Write all records to this JSONL")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    server = StreamingServer(args)
    targets = (args.targets * len(args.wavs))[: len(args.wavs)]
    sessions = []
    for wav_path, tgt in zip(args.wavs, targets):
        sid = server.open_session(target_wav=tgt)
        wav, sr = read_wav(wav_path)
        wav = to_mono(wav)
        if sr != args.sample_rate:
            wav = server.engine.resample(wav, sr, args.sample_rate)
        sessions.append(dict(sid=sid, wav=wav, path=wav_path, pos=0, records=[]))
        print(f"session {sid}: {wav_path} ({len(wav)/args.sample_rate:.1f}s), "
              f"target={tgt}")

    window = int(args.process_seconds * args.sample_rate)
    t0 = time.time()
    audio_total = sum(len(s["wav"]) for s in sessions) / args.sample_rate
    while any(s["pos"] < len(s["wav"]) for s in sessions):
        for s in sessions:
            if s["pos"] < len(s["wav"]):
                # File replay must not trip the drop-oldest backpressure
                # (that bound is for live capture): pace on pending depth so
                # every window is processed, and the wait also yields the
                # host core to the tick thread.
                while server.pending_depth(s["sid"]) >= server.MAX_PENDING - 1:
                    time.sleep(0.05)
                server.add_audio(s["sid"], s["wav"][s["pos"]: s["pos"] + window])
                s["pos"] += window
        if args.realtime:
            time.sleep(args.process_seconds)
        for s in sessions:
            for rec in server.get_results(s["sid"]):
                s["records"].append(rec)
                print(f"[s{s['sid']}] {rec['kind']}"
                      f"{'' if rec['stream'] is None else '/b' + str(rec['stream'])}"
                      f" {rec['start']:.1f}-{rec['end']:.1f}s"
                      f" sv={rec['sv_score']:.2f}: {rec['text']}")
    for s in sessions:
        server.flush(s["sid"])
    if not server.drain(timeout=600.0):
        print("WARNING: drain timed out — output records are incomplete")
    for s in sessions:
        s["records"].extend(server.get_results(s["sid"]))
    wall = time.time() - t0
    server.close()

    stats = server.stats()
    stats["sessions"] = len(sessions)
    stats["audio_sec_total"] = round(audio_total, 1)
    stats["wall_sec"] = round(wall, 2)
    stats["serving_rtf"] = round(wall / audio_total, 4) if audio_total else None
    print(f"serving stats: {json.dumps(stats)}")
    if args.out and is_writer():  # a rank of a mesh: rank 0 writes
        with open(args.out, "w") as f:
            for s in sessions:
                for rec in s["records"]:
                    f.write(json.dumps(dict(session=s["sid"], **rec),
                                       ensure_ascii=False) + "\n")
        print(f"records -> {args.out}")
    return stats


if __name__ == "__main__":
    main()
