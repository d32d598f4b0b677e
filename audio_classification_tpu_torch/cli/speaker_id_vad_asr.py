"""VAD + speaker-ID + non-streaming ASR offline evaluation, PyTorch port
(port of audio_classification_tpu/cli/speaker_id_vad_asr.py).

The reference script (reference:
scripts/speaker-identification-with-vad-non-streaming-asr.py:82-614):
enroll mean embeddings from a `<spk> <wav>` file, build a silero-style VAD
config (constructed with min_silence/min_speech = 0.25 just like the
reference — whose offline eval loop also never feeds it, :510-591), then
per test utterance: embedding -> bank search (threshold) -> ASR -> top-1
cosine score. Writes predictions.csv (wav,speaker_true,speaker_pred,text,
score) and report.txt with the same lines.

The reference registers five recognizer families (paraformer, sense_voice,
transducer, wenet_ctc, whisper — :278-359); the one-of selection is
validated the same way and each flag selects the engine's family, with
seeded weights or the .onnx files it names (``build_engine``: graph-aware
mapping; --wenet-ctc serves its graph directly and shares the CTC decode
path). An .onnx --silero-vad-model maps onto the VAD stage
(convert/onnx_graph_map), as the JAX CLI loads it. Runs on the GPU unless
``--provider cpu`` is given.

    python -m audio_classification_tpu_torch.cli.speaker_id_vad_asr \
        --speaker-file enroll.txt --test-list test.txt --paraformer seeded --apply-vad
"""
from __future__ import annotations

import argparse
import csv
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..parallel.launch import is_writer
from ..models.facades import SpeakerExtractor, create_asr_model, set_default_engine
from ..models.speaker import SpeakerBank
from ..models.vad import VADConfig, VoiceActivityDetector
from ..pipelines.offline_overlap3 import build_engine
from ..pipelines.sid_benchmark import load_audio, load_pairs


def get_args(argv=None):
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--silero-vad-model", default="", help="Silero VAD model (path or checkpoint slot)")
    p.add_argument("--apply-vad", action="store_true",
                   help="Trim non-speech with the VAD before embedding/ASR "
                        "(framework extension: the reference constructs its VAD "
                        "but never feeds it, sp-id:510-591)")
    p.add_argument("--speaker-file", required=True, help="Enrollment list <spk> <wav>")
    p.add_argument("--test-list", required=True, help="Test list <spk> <wav>")
    p.add_argument("--model", default="", help="Speaker embedding model path")
    p.add_argument("--tokens", default="")
    p.add_argument("--cmvn", default="", help="kaldi am.mvn CMVN stats for the ASR frontend")
    p.add_argument("--encoder", default="")
    p.add_argument("--decoder", default="")
    p.add_argument("--joiner", default="")
    p.add_argument("--paraformer", default="")
    p.add_argument("--sense-voice", default="")
    p.add_argument("--wenet-ctc", default="")
    p.add_argument("--whisper-encoder", default="")
    p.add_argument("--whisper-decoder", default="")
    p.add_argument("--whisper-language", default="")
    p.add_argument("--whisper-task", default="transcribe", choices=["transcribe", "translate"])
    p.add_argument("--decoding-method", default="greedy_search")
    p.add_argument("--num-active-paths", type=int, default=4,
                   help="beam width for modified_beam_search (transducer)")
    p.add_argument("--feature-dim", type=int, default=80)
    p.add_argument("--language", default="auto")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--num-threads", type=int, default=1)
    p.add_argument("--provider", default="cuda",
                   help="Device: cuda (raises when no GPU is found) or cpu")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--out-dir", default="test")
    p.add_argument("--preset", default="full", choices=["full", "tiny"])
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--data-parallel", type=int, default=0, dest="data_parallel",
                   help="Cards on the mesh 'data' axis, one torchrun rank each "
                        "(DP batch sharding)")
    p.add_argument("--model-parallel", type=int, default=0, dest="model_parallel",
                   help="Cards on the mesh 'model' axis (TP)")
    p.add_argument("--long-form", action="store_true", dest="long_form",
                   help="Transcribe each utterance as ONE full-context "
                        "program instead of per-segment batching; the encoder's "
                        "attention runs flash attention (K3) unsharded, for "
                        "all four families")
    return p.parse_args(argv)


def create_recognizer(args, engine):
    """One-of family selection incl. wenet_ctc/whisper slots
    (reference: :278-359)."""
    if args.paraformer or args.sense_voice or args.encoder:
        return create_asr_model(
            paraformer=args.paraformer, sense_voice=args.sense_voice,
            encoder=args.encoder, decoder=args.decoder, joiner=args.joiner,
            tokens=args.tokens, num_threads=args.num_threads,
            feature_dim=args.feature_dim, decoding_method=args.decoding_method,
            debug=args.debug, language=args.language, provider=args.provider,
            engine=engine,
        )
    if getattr(args, "wenet_ctc", ""):
        # CTC family shares the engine's CTC decode path
        return create_asr_model(sense_voice=args.wenet_ctc, tokens=args.tokens,
                                language=args.language, engine=engine)
    if getattr(args, "whisper_encoder", ""):
        # engine was already built with asr_family="whisper" (build_engine
        # reads whisper_encoder); the recognizer handle is family-agnostic
        return create_asr_model(sense_voice="", paraformer="", encoder="whisper",
                                decoder=args.whisper_decoder, joiner="x",
                                tokens=args.tokens, language=args.whisper_language or "auto",
                                engine=engine)
    raise ValueError("Please specify exactly one ASR model family")


def write_eval_outputs(*, base_out_dir: Path, rows, train_speakers: int, total: int,
                       correct: int, unknown_cnt: int, model: str,
                       test_list_path: str, threshold: float) -> Path:
    ts = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    run_dir = base_out_dir / ts
    run_dir.mkdir(parents=True, exist_ok=True)
    with (run_dir / "predictions.csv").open("w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["wav", "speaker_true", "speaker_pred", "text", "score"])
        for r in rows:
            w.writerow(r)
    acc = (correct / total) if total else 0.0
    with (run_dir / "report.txt").open("w", encoding="utf-8") as f:
        f.write("Speaker Identification Offline Evaluation\n")
        f.write(f"Train speakers: {train_speakers}\n")
        f.write(f"Test utterances: {total}\n")
        f.write(f"Accuracy: {acc:.4f} ({correct}/{total})\n")
        f.write(f"Unknown predicted: {unknown_cnt}\n")
        f.write(f"Model: {model}\n")
        f.write(f"Test list: {test_list_path}\n")
        f.write(f"Threshold: {threshold}\n")
    return run_dir


def main(argv=None):
    args = get_args(argv)
    print(args)
    engine = build_engine(args)
    set_default_engine(engine)
    recognizer = create_recognizer(args, engine)
    extractor = SpeakerExtractor(engine)
    speaker_file = load_pairs(args.speaker_file)

    manager = SpeakerBank(extractor.dim, device=engine.device)
    enrolled: Dict[str, np.ndarray] = {}
    for name, filenames in speaker_file.items():
        wavs = []
        for fn in filenames:
            print(f"processing {fn}")
            samples, sr, _ = load_audio(fn)
            wavs.append(samples)
        embs = extractor.compute_batch(wavs, 16000)
        embedding = embs.mean(axis=0)
        enrolled[name] = embedding.astype(np.float32)
        if not manager.add(name, embedding):
            raise RuntimeError(f"Failed to register speaker {name}")

    def _l2(x):
        n = np.linalg.norm(x)
        return x if n == 0 else x / n

    enrolled_norm = {k: _l2(v) for k, v in enrolled.items()}

    # VAD configured exactly as the reference does; by default it is NOT fed
    # (reference parity — the reference's offline loop never applies it),
    # --apply-vad makes it a working front gate.
    vad = VoiceActivityDetector(VADConfig(min_silence_duration=0.25, min_speech_duration=0.25))
    if args.silero_vad_model.endswith(".onnx"):
        from ..convert.onnx_graph_map import import_onnx_state_dict

        engine.pack.load_params(
            "vad", import_onnx_state_dict(args.silero_vad_model, "vad", engine.pack.preset.vad))
        print(f"loaded VAD weights from {args.silero_vad_model}")

    test_list_path = Path(args.test_list)
    assert test_list_path.is_file(), f"{test_list_path} not found"
    print(f"Using test list: {test_list_path}")
    test_map = load_pairs(str(test_list_path))

    total = correct = unknown_cnt = 0
    rows: List[Tuple[str, str, str, str, float]] = []
    flat = [(spk, wav) for spk, wavs in test_map.items() for wav in wavs]
    # batch the whole test list through the device: one embedding batch +
    # one transcribe batch (the per-utterance prints/rows are unchanged)
    loaded = [load_audio(wav) for _, wav in flat]
    inputs = [s for s, _, _ in loaded]
    if args.apply_vad:
        # one batched VAD pass, then keep only the detected speech spans
        # (falling back to the full utterance when nothing clears the
        # hysteresis rules, so downstream stages never see empty audio)
        probs = engine.vad_probs_batch(inputs)
        trimmed = []
        for s, pr in zip(inputs, probs):
            segs = vad.segments(pr, len(s) / 16000)
            parts = [s[int(a * 16000): int(b * 16000)] for a, b in segs]
            cut = np.concatenate(parts) if parts else s
            trimmed.append(cut if cut.size else s)
        kept = sum(len(t) for t in trimmed) / max(sum(len(s) for s in inputs), 1)
        print(f"VAD applied: kept {kept * 100:.1f}% of test audio")
        inputs = trimmed
    embs = extractor.compute_batch(inputs, 16000)
    if args.long_form:
        texts = [recognizer.transcribe(s, 16000, long_form=True)
                 for s in inputs]
    else:
        texts = recognizer.transcribe_batch(inputs, 16000)
    for (spk_true, wav), embedding, text in zip(flat, embs, texts):
        emb_n = _l2(np.asarray(embedding, dtype=np.float32))
        pred = manager.search(embedding, threshold=args.threshold) or "unknown"
        if enrolled_norm:
            names = list(enrolled_norm.keys())
            mat = np.stack([enrolled_norm[n] for n in names])
            scores = mat @ emb_n
            top1 = float(scores[int(np.argmax(scores))])
        else:
            top1 = float("nan")
        total += 1
        if pred == spk_true:
            correct += 1
        elif pred == "unknown":
            unknown_cnt += 1
        print(f"{total}: true={spk_true} pred={pred} text={text} file={Path(wav).name}")
        rows.append((str(wav), spk_true, pred, text, top1))

    acc = correct / total if total else 0.0
    print(f"Eval done. Accuracy: {acc:.4f} ({correct}/{total}), unknown: {unknown_cnt}")
    if not is_writer():  # a rank of a mesh: rank 0 writes
        return None
    run_dir = write_eval_outputs(
        base_out_dir=Path(args.out_dir), rows=rows, train_speakers=len(enrolled),
        total=total, correct=correct, unknown_cnt=unknown_cnt, model=args.model,
        test_list_path=str(test_list_path), threshold=args.threshold,
    )
    print(f"Outputs saved to: {run_dir}")
    return run_dir


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        print("\nCaught Ctrl + C. Exiting")
