"""Convert reference model checkpoints into a checkpoint directory of the
port (port of audio_classification_tpu/cli/convert_models.py).

Migration bridge for users of the reference: point this tool at locally
downloaded reference checkpoints and get a model-pack directory
(train/checkpoint.save_model_pack) that every runner of the port loads with
``--checkpoint-dir`` (the JAX tool writes an orbax directory instead).

Supported sources:
- asteroid Conv-TasNet torch checkpoints (2-src and 3-src; the weights the
  reference's Separator downloads, reference: separation.py:105-163)
  -> exact architecture mapping (convert/torch_import).
- ONNX models: with ``--map speaker|sensevoice|vad|...`` the graph-aware
  importer (convert/onnx_graph_map) assigns the weights onto the matching
  module by structural position (validating shapes, resolving int8
  DequantizeLinear); without --map the initializer tensors are dumped to an
  .npz + a JSON inventory (names, shapes, dtypes, int8 scale pairing) for
  mapping work on graphs whose topology does not match the port's modules.
- ``--verify MODEL_DIR``: the acceptance procedure of convert/verify over a
  local copy of the reference's model directory; ``--probe``: each --onnx
  graph's signature and op census; ``--pyannet-to-onnx``: a pyannote
  segmentation checkpoint as an ONNX file.

Everything not converted stays at seed initialization in the output pack.
Runs on the card unless ``--provider cpu``.

    python -m audio_classification_tpu_torch.cli.convert_models --onnx spk.onnx \\
        --map speaker --out pack_dir
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Convert reference checkpoints -> a model-pack "
                                            "directory of the port")
    p.add_argument("--out", default="", help="Output model-pack directory")
    p.add_argument("--probe", action="store_true",
                   help="Print each --onnx graph's IO signature, op census "
                        "and any ops the direct executor (onnx_exec) does "
                        "not support, then exit (no checkpoint written)")
    p.add_argument("--verify", default="", metavar="MODEL_DIR",
                   help="Acceptance procedure over a LOCAL copy of the "
                        "reference's model dir (install.sh layout): per "
                        "graph device-vs-host exec parity, per stage mapped-"
                        "module vs direct-graph parity, torch import smoke; "
                        "writes verify.json and exits non-zero on any "
                        "failed check")
    p.add_argument("--verify-out", default="verify.json",
                   help="Report path for --verify (default verify.json)")
    p.add_argument("--preset", default="full", choices=["full", "tiny"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--provider", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--pyannet-to-onnx", default="", metavar="TORCH_CKPT",
                   help="Convert a pyannote segmentation torch checkpoint "
                        "to a standard ONNX file (--onnx-out; pyannote has "
                        "no official ONNX export: this produces one)")
    p.add_argument("--onnx-out", default="pyannet.onnx",
                   help="Output path for --pyannet-to-onnx")
    p.add_argument("--seconds", type=float, default=10.0,
                   help="Static input length baked into --pyannet-to-onnx "
                        "(pyannote's chunked-inference window)")
    p.add_argument("--sep-checkpoint-3", default="", help="asteroid ConvTasNet 3-src torch checkpoint")
    p.add_argument("--sep-checkpoint-2", default="", help="asteroid ConvTasNet 2-src torch checkpoint")
    p.add_argument("--onnx", nargs="*", default=[],
                   help="ONNX files to inventory (weights -> <name>.weights.npz + .inventory.json)")
    p.add_argument("--map", nargs="*", default=[], dest="map_targets",
                   choices=["speaker", "sensevoice", "vad", "whisper",
                            "mossformer", "paraformer", "transducer",
                            "inventory"],
                   help="Per --onnx file: graph-aware mapping target "
                        "('inventory' keeps the npz/JSON dump behavior)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.verify:
        from ..convert.verify import verify_model_dir

        result = verify_model_dir(args.verify, args.verify_out, preset=args.preset,
                                  device=args.provider)
        for rec in result["checks"]:
            extra = rec.get("reason") or ", ".join(
                f"{k}={v}" for k, v in rec.items()
                if k not in ("model", "check", "status", "seconds", "reason"))
            print(f"[{rec['status']:>7}] {rec['model']} :: {rec['check']} "
                  f"({rec['seconds']}s) {extra}")
        print(f"verify: {'OK' if result['ok'] else 'FAILED'} -- "
              f"{len(result['models_found'])} models, "
              f"{len(result['checks'])} checks -> {args.verify_out}")
        if not result["ok"]:
            raise SystemExit(1)
        return result
    if args.pyannet_to_onnx:
        from ..convert.from_jax import pyannet_state_dict_to_params
        from ..convert.onnx_export import export_pyannet
        from ..convert.torch_import import load_pyannet_torch

        pn_cfg, pn_sd = load_pyannet_torch(args.pyannet_to_onnx)
        samples = int(args.seconds * pn_cfg.sample_rate)
        export_pyannet(pyannet_state_dict_to_params(pn_sd), pn_cfg, args.onnx_out,
                       samples=samples)
        print(f"exported PyanNet ONNX: {args.onnx_out} "
              f"(wav [batch,{samples}] -> probs; classes={pn_cfg.num_classes})")
        return args.onnx_out
    if args.probe:
        if not args.onnx:
            raise SystemExit("--probe needs at least one --onnx file")
        from ..convert.onnx_exec import OnnxModel

        for onnx_path in args.onnx:
            print(f"== {onnx_path}")
            print(OnnxModel(onnx_path, device=args.provider).describe())
        return None
    if not args.out:
        raise SystemExit("--out is required (or use --probe)")
    from ..engine.runtime import EnginePreset, ModelPack, tiny_preset
    from ..train.checkpoint import save_model_pack

    preset = tiny_preset() if args.preset == "tiny" else EnginePreset()
    # an ASR map target dictates the pack's recognizer family so the mapped
    # tree lands on a matching architecture
    asr_targets = {"paraformer", "transducer", "whisper"} & set(args.map_targets)
    if len(asr_targets) > 1:
        raise SystemExit(f"conflicting ASR map targets: {sorted(asr_targets)}")
    family = asr_targets.pop() if asr_targets else "sensevoice"
    pack = ModelPack(preset, seed=args.seed, asr_family=family, device=args.provider)
    if family != "sensevoice":
        print(f"pack ASR family: {family}")

    if args.sep_checkpoint_3 or args.sep_checkpoint_2:
        from ..convert.torch_import import load_convtasnet_torch

        for stage, path in (("sep3", args.sep_checkpoint_3), ("sep2", args.sep_checkpoint_2)):
            if path:
                pack.load_params(stage, load_convtasnet_torch(path, getattr(preset, stage)))
                print(f"converted {stage[-1]}-src ConvTasNet from {path}")

    if args.map_targets and len(args.map_targets) != len(args.onnx):
        raise SystemExit("--map must list one target per --onnx file")
    pack_key = {"speaker": "spk", "sensevoice": "asr", "vad": "vad",
                "whisper": "asr", "mossformer": "mossformer",
                "paraformer": "asr", "transducer": "asr"}
    map_cfg = {"speaker": preset.spk, "sensevoice": pack.asr_cfg, "vad": preset.vad,
               "whisper": pack.whisper_cfg, "mossformer": preset.mossformer,
               "paraformer": pack.paraformer_cfg, "transducer": pack.transducer_cfg}
    for i, onnx_path in enumerate(args.onnx):
        target = args.map_targets[i] if args.map_targets else "inventory"
        if target != "inventory":
            from ..convert.onnx_graph_map import import_onnx_state_dict

            pack.load_params(pack_key[target],
                             import_onnx_state_dict(onnx_path, target, map_cfg[target]))
            print(f"mapped {onnx_path} -> {pack_key[target]} (graph-aware, target={target})")
            continue
        from ..convert.onnx_import import load_onnx_weights

        weights = load_onnx_weights(onnx_path)
        stem = Path(onnx_path).with_suffix("")
        np.savez_compressed(f"{stem}.weights.npz", **weights)
        inventory = {
            name: {
                "shape": list(w.shape),
                "dtype": str(w.dtype),
                "quantized": f"{name}_scale" in weights,
            }
            for name, w in weights.items()
        }
        Path(f"{stem}.inventory.json").write_text(json.dumps(inventory, indent=2))
        print(f"inventoried {len(weights)} tensors from {onnx_path} -> {stem}.weights.npz")

    save_model_pack(pack, args.out)
    print(f"wrote checkpoint dir: {args.out}")
    return args.out


if __name__ == "__main__":
    main()
