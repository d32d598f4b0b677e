"""Manifest and waveform plumbing of the training CLIs (port of
audio_classification_tpu/train/data.py).

cli/train_asr and cli/train_speaker read the same two on-disk shapes: a
JSONL manifest of ``{"wav": ..., <value>: ...}`` records (or a
``wav<TAB>value`` TSV), and 16 kHz mono waveforms decoded by the port's own
codec and polyphase resampler.
"""
from __future__ import annotations

import json
import subprocess
from pathlib import Path

import numpy as np

SR = 16000


def read_manifest(path: str, value_field: str):
    """-> [(wav_path, value)]; JSONL {"wav", value_field} or TSV."""
    items = []
    for ln in Path(path).read_text(encoding="utf-8").splitlines():
        ln = ln.strip()
        if not ln:
            continue
        if ln.startswith("{"):
            rec = json.loads(ln)
            items.append((rec["wav"], str(rec[value_field])))
        else:
            wav, value = ln.split("\t", 1)
            items.append((wav, value))
    if not items:
        raise SystemExit(f"empty manifest: {path}")
    return items


class WavCache:
    """Decode + resample to 16 kHz mono on the CPU, memoised; flushed
    wholesale past ``limit`` entries (bounds memory over large corpora)."""

    def __init__(self, limit: int = 512):
        self.limit = limit
        self._cache: dict = {}

    def __call__(self, path: str) -> np.ndarray:
        if path not in self._cache:
            import torch

            from ..audio_io import read_wav, to_mono
            from ..ops.resample import resample_poly

            wav, sr = read_wav(path)
            wav = to_mono(wav)
            if sr != SR:
                wav = resample_poly(torch.from_numpy(np.asarray(wav, np.float32)), sr, SR).numpy()
            if len(self._cache) > self.limit:
                self._cache.clear()
            self._cache[path] = np.asarray(wav, np.float32)
        return self._cache[path]


def write_run_manifest(out_dir, args, extra: dict | None = None) -> str:
    """A run.json beside a checkpoint or export: the argv namespace, the git
    revision, the torch version and the device the run trained on (CUDA
    device name and card count) -- enough to reproduce or audit it."""
    import torch

    rev = ""
    try:
        rev = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                             timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    cuda = torch.cuda.is_available()
    meta = {
        "argv": {k: v for k, v in sorted(vars(args).items())},
        "git_rev": rev,
        "torch_version": torch.__version__,
        "device": getattr(args, "provider", "cuda"),
        "cuda_device_name": torch.cuda.get_device_name(0) if cuda else None,
        "n_devices": torch.cuda.device_count() if cuda else 0,
    }
    meta.update(extra or {})
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / "run.json"
    path.write_text(json.dumps(meta, indent=2, default=str) + "\n", encoding="utf-8")
    return str(path)
