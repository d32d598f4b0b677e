"""Export a model pack's stages to standard ONNX files in one command (port
of audio_classification_tpu/cli/export_models.py).

The inverse of cli/convert_models: where that tool brings the reference's
checkpoints INTO the port (reference: scripts/install.sh:52-61 downloads
ONNX / torch files the port imports), this one ships the port's weights OUT
as ONNX: a pack trained or converted here becomes a directory of files that
onnxruntime, or the port's own ``--onnx-exec direct`` executor, serves.

Stages and their exporters (convert/onnx_export):

  sep3/sep2   ConvTasNet        mix [batch, T] -> est
  mossformer  MossFormer        mix [batch, T] -> est
  asr         SenseVoice-CTC    feats+language -> logits (sensevoice only;
                                the other ASR families are import-only)
  osd         OSDNet            fbank feats -> per-frame probs
  spk         SpeakerEmbedder   fbank feats -> embedding
  vad         VADNet            fbank feats -> speech probs

Weights come from ``--checkpoint-dir`` (the port's model-pack directory,
the one the pipelines load) or seed init (useful for topology checks).
Time lengths are baked static per export (``--seconds``), as the
reference's own exports pin feature dims. The pack is built on the card
unless ``--provider cpu``.

    python -m audio_classification_tpu_torch.cli.export_models --out-dir onnx_dir \\
        [--checkpoint-dir pack_dir]
"""
from __future__ import annotations

import argparse
from pathlib import Path

ALL_STAGES = ("sep3", "sep2", "mossformer", "asr", "osd", "spk", "vad")


def parse_args(argv=None):
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--out-dir", required=True, help="Directory for the .onnx files")
    p.add_argument("--checkpoint-dir", default="",
                   help="model-pack directory of the port (default: seed init)")
    p.add_argument("--preset", default="full", choices=["full", "tiny"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--provider", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--stages", nargs="*", default=list(ALL_STAGES),
                   choices=list(ALL_STAGES), help="Subset of stages to export")
    p.add_argument("--seconds", type=float, default=10.0,
                   help="Static audio length baked into each export")
    p.add_argument("--use-itn", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="Text-norm row baked into the asr export "
                        "(--no-use-itn for the other mode)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..convert import onnx_export as ox
    from ..convert.from_jax import state_dict_to_variables
    from ..engine.runtime import EnginePreset, ModelPack, tiny_preset
    from ..ops.fbank import FbankConfig

    preset = tiny_preset() if args.preset == "tiny" else EnginePreset()
    pack = ModelPack(preset, seed=args.seed, device=args.provider)
    if args.checkpoint_dir:
        from ..train.checkpoint import load_model_pack

        load_model_pack(pack, args.checkpoint_dir)
        print(f"[export_models] loaded pack: {args.checkpoint_dir}")

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    fb = FbankConfig()
    written = []

    def emit(stage, fn, cfg, **kw):
        path = str(out / f"{stage}.onnx")
        fn(state_dict_to_variables(pack.models[stage]), cfg, path, **kw)
        written.append(path)
        print(f"[export_models] {stage:<10} -> {path}")

    for stage in args.stages:
        if stage == "sep3":
            emit(stage, ox.export_convtasnet, preset.sep3, seconds=args.seconds)
        elif stage == "sep2":
            emit(stage, ox.export_convtasnet, preset.sep2, seconds=args.seconds)
        elif stage == "mossformer":
            emit(stage, ox.export_mossformer, preset.mossformer, seconds=args.seconds)
        elif stage == "asr":
            if pack.asr_family != "sensevoice":
                print(f"[export_models] asr skipped: family "
                      f"'{pack.asr_family}' is import-only (exporter covers "
                      "the trainable sensevoice family)")
                continue
            cfg = pack.asr_cfg
            n = int(args.seconds * fb.sample_rate)
            frames = cfg.out_frames(n) - cfg.num_prompt
            emit(stage, ox.export_sensevoice, cfg, frames=frames, use_itn=args.use_itn)
        elif stage == "osd":
            frames = fb.frames_for(int(args.seconds * fb.sample_rate))
            emit(stage, ox.export_osdnet, preset.osd, frames=frames)
        elif stage == "spk":
            frames = fb.frames_for(int(args.seconds * fb.sample_rate))
            emit(stage, ox.export_speaker, preset.spk, frames=frames)
        elif stage == "vad":
            frames = fb.frames_for(int(args.seconds * fb.sample_rate))
            emit(stage, ox.export_vadnet, preset.vad, frames=frames)
    print(f"[export_models] wrote {len(written)} files -> {out}")
    return written


if __name__ == "__main__":
    main()
