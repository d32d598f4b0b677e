"""LibriMix / Libri2Mix / Libri3Mix directory walker (host copy of
audio_classification_tpu/data/librimix.py).

Pure host I/O replacement for ``torchaudio.datasets.LibriMix``
(reference: overlap3_core.py:27,324-335) and the ModelScope Libri2Mix_8k
loader (reference: src/mossformer/dataset.py:15-32). Directory layout:

  <root>/Libri{N}Mix/wav{8k|16k}/{min|max}/{subset}/
      mix_clean/ | mix_both/ | mix_single/   (task-dependent)
      s1/ s2/ [s3/]  [noise/]

Items are sorted by filename for deterministic indexing; `get_metadata`
returns relative paths like the torchaudio dataset so the pipeline's
path-resolution logic matches the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..audio_io import read_wav, to_mono

_TASK_TO_MIXDIR = {
    "sep_clean": "mix_clean",
    "sep_noisy": "mix_both",
    "enh_single": "mix_single",
    "enh_both": "mix_both",
}


@dataclass
class LibriMixItem:
    mix_path: Path
    source_paths: List[Path]


class LibriMixDataset:
    def __init__(
        self,
        root: str,
        subset: str = "test",
        num_speakers: int = 3,
        sample_rate: int = 16000,
        task: str = "sep_clean",
        mode: str = "min",
    ):
        self.root = Path(root)
        self.subset = subset
        self.num_speakers = num_speakers
        self.sample_rate = sample_rate
        self.task = task
        self.mode = mode
        sr_dir = "wav8k" if sample_rate == 8000 else "wav16k"
        mix_dir = _TASK_TO_MIXDIR.get(task)
        if mix_dir is None:
            raise ValueError(f"unknown task {task}")
        self.base = self.root / f"Libri{num_speakers}Mix" / sr_dir / mode / subset
        mix_root = self.base / mix_dir
        if not mix_root.is_dir():
            raise FileNotFoundError(f"LibriMix mix dir not found: {mix_root}")
        self.items: List[LibriMixItem] = []
        for mix_path in sorted(mix_root.glob("*.wav")):
            srcs = [self.base / f"s{i+1}" / mix_path.name for i in range(num_speakers)]
            self.items.append(LibriMixItem(mix_path, srcs))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Tuple[int, np.ndarray, Optional[List[np.ndarray]]]:
        """-> (sample_rate, mix [T], [sources [T]] or None)."""
        item = self.items[idx]
        mix, sr = read_wav(item.mix_path)
        mix = to_mono(mix)
        sources: Optional[List[np.ndarray]] = None
        if all(p.is_file() for p in item.source_paths):
            sources = [to_mono(read_wav(p)[0]) for p in item.source_paths]
        return sr, mix, sources

    def get_metadata(self, idx: int) -> Tuple[int, str, List[str]]:
        """-> (sample_rate, relative mix path, relative source paths)."""
        item = self.items[idx]
        rel = lambda p: str(p.relative_to(self.root))
        return self.sample_rate, rel(item.mix_path), [rel(p) for p in item.source_paths]


class Libri2Mix8kDataset:
    """API-parity shim for the reference's ModelScope-backed loader
    (reference: src/mossformer/dataset.py:15-32): classmethod loaders over a
    local LibriMix root (this package never downloads)."""

    def __init__(self, root: str, split: str):
        self.ds = LibriMixDataset(root, subset=split, num_speakers=2, sample_rate=8000)

    @classmethod
    def load_test(cls, root: str) -> "Libri2Mix8kDataset":
        return cls(root, "test")

    @classmethod
    def load_train(cls, root: str) -> "Libri2Mix8kDataset":
        return cls(root, "train-100")

    @classmethod
    def load_dev(cls, root: str) -> "Libri2Mix8kDataset":
        return cls(root, "dev")

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, idx: int) -> dict:
        sr, mix, sources = self.ds[idx]
        item = self.ds.items[idx]
        rec = {
            "id": item.mix_path.stem,
            "mix_wav:FILE": str(item.mix_path),
            "length": mix.shape[-1],
        }
        for i, p in enumerate(item.source_paths):
            rec[f"s{i+1}_wav:FILE"] = str(p)
        return rec
