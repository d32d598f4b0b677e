#!/usr/bin/env python3
"""Convert an orbax checkpoint of the JAX package into the PyTorch port's
checkpoint format.

The machine that runs the port on the GPU has no JAX, orbax or tensorstore,
so the port reads only its own directories (audio_classification_tpu_torch/
train/checkpoint.py: torch.save files of state_dicts and a meta.json). This
script runs where the JAX package is installed (JAX on the CPU is enough):

- it restores the orbax directory with the JAX package's
  train/checkpoint.load_params, as the checkpoint was written (no template);
- a model pack (train/checkpoint.save_model_pack: {stage: variables}) becomes
  a model-pack directory of the port, which ``--checkpoint-dir`` loads;
- a params-only export (cli/train_separator, train_asr, train_speaker
  ``--export``, and cli/distill_osd ``--out``: one stage's {"params":
  ...(, "batch_stats": ...)}) becomes a params directory, which
  ``--sep-checkpoint`` / ``Separator(checkpoint=)``, ``--sense-voice``,
  ``--spk-embed-model`` and ``--osd-checkpoint`` load;
- the leaves map through audio_classification_tpu_torch/convert/from_jax.py
  (``params_to_state_dicts`` / ``variables_to_state_dict``).

    JAX_PLATFORMS=cpu python scripts/orbax_to_torch.py ORBAX_DIR OUT_DIR

The port itself never imports this script.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def convert(src: str, dst: str) -> str:
    """Convert orbax directory ``src`` into the port's directory ``dst``;
    -> the kind written ("model_pack" or "params")."""
    import numpy as np

    from audio_classification_tpu.train.checkpoint import load_params as jax_load_params
    from audio_classification_tpu_torch.convert.from_jax import (params_to_state_dicts,
                                                                  variables_to_state_dict)
    from audio_classification_tpu_torch.train.checkpoint import save_params, save_state_dicts

    import jax

    tree = jax.tree.map(np.asarray, jax_load_params(None, src))
    if "params" in tree:  # one stage's variables: a params-only export
        save_params(variables_to_state_dict(tree), dst, source=str(src))
        return "params"
    save_state_dicts(params_to_state_dicts(tree), dst, source=str(src))
    return "model_pack"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="orbax checkpoint directory (JAX package)")
    p.add_argument("dst", help="output directory in the port's format")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    kind = convert(args.src, args.dst)
    print(f"[orbax_to_torch] {args.src} -> {args.dst} ({kind})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
