"""Generate a `<spk> <wav>` list from a directory tree (port of
audio_classification_tpu/cli/generate_speaker_list.py).

Equivalent of the reference's shell tool (reference:
scripts/generate-speaker-text.sh — find+awk over <root>/<speaker>/*.wav
into speaker.txt): each immediate subdirectory name is the speaker id;
every .wav below it becomes one line.
"""
from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("root", help="Dataset root: <root>/<speaker>/**.wav")
    p.add_argument("--out", default="speaker.txt")
    args = p.parse_args(argv)

    root = Path(args.root)
    lines = []
    for spk_dir in sorted(d for d in root.iterdir() if d.is_dir()):
        for wav in sorted(spk_dir.rglob("*.wav")):
            lines.append(f"{spk_dir.name} {wav}")
    Path(args.out).write_text("\n".join(lines) + ("\n" if lines else ""), encoding="utf-8")
    print(f"Wrote {len(lines)} lines to {args.out}")


if __name__ == "__main__":
    main()
