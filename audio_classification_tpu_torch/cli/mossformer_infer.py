"""Standalone MossFormer separation demo (port of
audio_classification_tpu/cli/mossformer_infer.py).

Parity with the reference demo (reference: src/mossformer/infer.py:13-23):
separate one wav with the MossFormer backend at its native 8 kHz and emit
int16 PCM branches — here written as wav files next to the input (the
reference returns in-memory PCM bytes from the ModelScope pipeline).
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..audio_io import read_wav, to_mono, write_wav
from ..models.facades import Separator, default_engine


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("input", help="Input mixture wav")
    p.add_argument("--out-dir", default="", help="Output dir (default: alongside input)")
    p.add_argument("--n-src", type=int, default=2)
    p.add_argument("--preset", default="full", choices=["full", "tiny"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--provider", default="cuda",
                   help="Device: cuda (raises when no GPU is found) or cpu")
    args = p.parse_args(argv)

    engine = default_engine(args.preset, seed=args.seed, device=args.provider)
    sep = Separator(backend="mossformer", n_src=args.n_src, engine=engine)
    wav, sr = read_wav(args.input)
    branches = sep.separate(to_mono(wav), sr)

    out_dir = Path(args.out_dir) if args.out_dir else Path(args.input).parent
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = Path(args.input).stem
    written = []
    for i, b in enumerate(branches):
        # int16 PCM branches like the reference pipeline output
        pcm = np.clip(b, -1.0, 1.0)
        out = out_dir / f"{stem}_spk{i}.wav"
        write_wav(out, pcm, sep.sample_rate, encoding="pcm16")
        written.append(out)
        print(f"wrote {out}")
    return written


if __name__ == "__main__":
    main()
