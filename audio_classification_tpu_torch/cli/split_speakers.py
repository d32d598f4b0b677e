"""Split a `<spk> <wav>` list into train/test sets (port of
audio_classification_tpu/cli/split_speakers.py).

Same capability surface as the reference tool (reference:
scripts/split_speakers.py:36-167): two modes with small-dataset guards,
deterministic under --seed.

- ``speaker``   — the splits get DISJOINT speaker identities (held-out
  speakers), each guaranteed non-empty when two or more speakers exist.
- ``utterance`` — every speaker appears in both splits: their utterances
  are shuffled and divided per the ratio, always leaving at least one
  utterance on each side for speakers with two or more (a single-utterance
  speaker goes to train); if a whole side still comes out empty, one
  utterance migrates to fill it.
"""
from __future__ import annotations

import argparse
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Split speaker list into train/test")
    p.add_argument("--input", "-i", type=Path, required=True, help="Path to input speaker.txt")
    p.add_argument("--train-out", type=Path, required=True)
    p.add_argument("--test-out", type=Path, required=True)
    p.add_argument("--train-ratio", type=float, default=0.8, help="Ratio for train set (0-1)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--mode", type=str, choices=["speaker", "utterance"], default="utterance")
    return p.parse_args(argv)


@dataclass
class Split:
    train: List[str]
    test: List[str]
    speakers: List[str]


def _spk(line: str) -> str:
    return line.split(maxsplit=1)[0]


def _speakers_in(lines: List[str]) -> set:
    return {_spk(ln) for ln in lines}


def _group(lines: List[str]) -> Dict[str, List[str]]:
    groups: Dict[str, List[str]] = {}
    for ln in lines:
        groups.setdefault(_spk(ln), []).append(ln)
    return groups


def _split_by_speaker(lines: List[str], speakers: List[str],
                      train_ratio: float, rng: random.Random) -> Split:
    order = list(speakers)
    rng.shuffle(order)
    cut = int(len(order) * train_ratio)
    # a degenerate ratio or tiny roster may empty one side: move the cut so
    # both splits exist whenever two speakers do. Operating on the shuffled
    # list (not set iteration order) keeps the donated speaker deterministic
    # under --seed regardless of PYTHONHASHSEED.
    if cut == 0 and len(order) > 1:
        cut = 1
    elif cut == len(order) and len(order) > 1:
        cut = len(order) - 1
    train_ids, test_ids = set(order[:cut]), set(order[cut:])
    return Split(
        train=[ln for ln in lines if _spk(ln) in train_ids],
        test=[ln for ln in lines if _spk(ln) in test_ids],
        speakers=speakers,
    )


def _split_by_utterance(lines: List[str], speakers: List[str],
                        train_ratio: float, rng: random.Random) -> Split:
    groups = _group(lines)
    train: List[str] = []
    test: List[str] = []
    for spk in speakers:
        utts = list(groups[spk])
        rng.shuffle(utts)
        if len(utts) == 1:
            take = 1
        else:
            # at least one utterance stays on each side of the cut
            take = min(max(int(len(utts) * train_ratio), 1), len(utts) - 1)
        train += utts[:take]
        test += utts[take:]
    # tiny-dataset guards: migrate one utterance into an empty split,
    # preferring a speaker that keeps >=1 line on the donating side
    if not test and train:
        donors = [spk for spk in reversed(speakers)
                  if sum(1 for ln in train if _spk(ln) == spk) >= 2]
        if donors:
            moved = next(ln for ln in reversed(train) if _spk(ln) == donors[0])
            train.remove(moved)
            test.append(moved)
    if not train and test:
        train.append(test.pop())
    return Split(train=train, test=test, speakers=speakers)


def split_lines(lines: List[str], mode: str, train_ratio: float,
                seed: int) -> Tuple[List[str], List[str], List[str]]:
    """-> (train_lines, test_lines, sorted unique speakers)."""
    speakers = sorted(_group(lines))
    if not speakers:
        raise SystemExit("No speakers found in input file")
    rng = random.Random(seed)
    splitter = _split_by_speaker if mode == "speaker" else _split_by_utterance
    result = splitter(lines, speakers, train_ratio, rng)
    return result.train, result.test, result.speakers


def _write_list(path: Path, lines: List[str]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + ("\n" if lines else ""), encoding="utf-8")


def main(argv=None) -> None:
    args = parse_args(argv)
    assert 0.0 < args.train_ratio < 1.0, "train-ratio must be in (0,1)"
    with args.input.open("r", encoding="utf-8") as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    train, test, speakers = split_lines(lines, args.mode, args.train_ratio, args.seed)

    _write_list(args.train_out, train)
    _write_list(args.test_out, test)

    print(f"Mode: {args.mode}")
    label = "train/test" if args.mode == "speaker" else "in-train/in-test"
    print(f"Speakers: total={len(speakers)}, "
          f"{label.split('/')[0]}={len(_speakers_in(train))}, "
          f"{label.split('/')[1]}={len(_speakers_in(test))}")
    print(f"Lines: train={len(train)}, test={len(test)}")
    print(f"Wrote: {args.train_out} and {args.test_out}")


if __name__ == "__main__":
    main()
