"""N-source WAV mixer (fixture/synthesis tool; port of
audio_classification_tpu/cli/mix_wavs.py).

Covers the reference tool's capability surface (reference:
scripts/tools/mix_wavs.py:49-243): per-source start offsets, either
relative-SNR-to-source-0 or absolute per-source dB gains (mutually
exclusive), auto-resample to the target rate, and a global peak limiter at
0.98. Decode/encode use the framework's own codec; resampling uses the
device polyphase resampler (ops/resample.resample_poly), on the card unless
``--provider cpu`` is given.

Structure: ``plan_scales`` turns the gain specification into one linear
scale per source, ``mix`` assembles the offset sum and applies the limiter,
returning a ``MixResult`` the CLI reports from.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..audio_io import read_wav, to_mono, write_wav
from ..engine.runtime import resolve_device
from ..ops.resample import resample_poly
from ..ops.signal import no_tf32


@dataclass
class MixResult:
    """What ``mix`` produced, for reporting and tests."""

    out_path: str
    sample_rate: int
    num_samples: int
    peak_before_limit: float
    limiter_gain: float
    scales: np.ndarray  # per-source linear gains

    @property
    def duration_sec(self) -> float:
        return self.num_samples / self.sample_rate


def _rms(x: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(x.astype(np.float64))) + 1e-12))


def _load_mono(path: str, target_sr: int, device: torch.device) -> np.ndarray:
    wav, sr = read_wav(path)
    wav = to_mono(wav)
    if sr != target_sr:
        with torch.inference_mode(), no_tf32():
            x = torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(device)
            wav = resample_poly(x, sr, target_sr).cpu().numpy()
    return wav.astype(np.float32)


def plan_scales(
    waves: Sequence[np.ndarray],
    snr_dbs: Optional[Sequence[float]],
    gains_db: Optional[Sequence[float]],
) -> np.ndarray:
    """Per-source linear gains from exactly one of the two dB specs.

    ``gains_db`` are absolute. ``snr_dbs`` are relative to source 0: a
    positive value makes that source quieter than source 0 by that many dB
    of RMS (source 0 itself conventionally gets 0).
    """
    n = len(waves)
    if snr_dbs is not None and gains_db is not None:
        raise ValueError("Use either --snr or --gains-db, not both")
    if gains_db is not None:
        if len(gains_db) != n:
            raise ValueError("gains-db length must match number of inputs")
        return 10.0 ** (np.asarray(gains_db, dtype=np.float64) / 20.0)
    if snr_dbs is not None:
        if len(snr_dbs) != n:
            raise ValueError("snr length must match number of inputs")
        ref_rms = _rms(waves[0]) or 1e-3
        per_source_rms = np.asarray([max(_rms(w), 1e-6) for w in waves])
        attenuation = 10.0 ** (-np.asarray(snr_dbs, dtype=np.float64) / 20.0)
        return attenuation * (ref_rms / per_source_rms)
    return np.ones(n, dtype=np.float64)


def mix(
    inputs: List[str],
    out_path: str,
    sr: int = 16000,
    offsets: Optional[List[float]] = None,
    snr_dbs: Optional[List[float]] = None,
    gains_db: Optional[List[float]] = None,
    peak_limit: float = 0.98,
    device=None,
) -> MixResult:
    """``device`` runs the resampler (default: the card, raising without
    one; ``"cpu"`` when asked for)."""
    if not inputs:
        raise ValueError("No input files provided")
    offsets = offsets if offsets is not None else [0.0] * len(inputs)
    if len(offsets) != len(inputs):
        raise ValueError("offsets length must match number of inputs")

    dev = resolve_device(device)
    waves = [_load_mono(p, sr, dev) for p in inputs]
    scales = plan_scales(waves, snr_dbs, gains_db)
    starts = [int(max(0.0, o) * sr) for o in offsets]

    acc = np.zeros(max(s + len(w) for s, w in zip(starts, waves)), dtype=np.float64)
    for wav, start, scale in zip(waves, starts, scales):
        acc[start : start + len(wav)] += wav.astype(np.float64) * scale

    peak = float(np.max(np.abs(acc)) + 1e-12)
    limiter = peak_limit / peak if peak > peak_limit else 1.0
    out = (acc * limiter).astype(np.float32)

    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    write_wav(out_path, out, sr)
    return MixResult(
        out_path=str(out_path), sample_rate=sr, num_samples=len(out),
        peak_before_limit=peak, limiter_gain=limiter, scales=scales,
    )


def _csv_floats(raw: str, n: int) -> Optional[List[float]]:
    """Comma list -> n floats (a single value broadcasts); '' -> None."""
    if not raw:
        return None
    vals = [float(p) for p in raw.split(",") if p.strip()]
    if len(vals) == 1:
        vals = vals * n
    if len(vals) != n:
        raise ValueError(f"List length mismatch: expected {n}, got {len(vals)}")
    return vals


def main(argv=None):
    ap = argparse.ArgumentParser(description="Mix multiple WAVs into one mixture.")
    ap.add_argument("inputs", nargs="+", help="Input WAV files (mono or multi-channel)")
    ap.add_argument("--out", required=True, help="Output WAV file path")
    ap.add_argument("--sr", type=int, default=16000, help="Target sample rate (Hz)")
    ap.add_argument("--offsets", default="", help="Comma list of start offsets in seconds")
    ap.add_argument("--snr", default="", help="Comma list of per-source SNR dB relative to source 0")
    ap.add_argument("--gains-db", default="", help="Comma list of absolute per-source gains in dB")
    ap.add_argument("--peak-limit", type=float, default=0.98)
    ap.add_argument("--provider", default="cuda", choices=["cuda", "cpu"],
                    help="device of the resampler (the card by default)")
    args = ap.parse_args(argv)

    n = len(args.inputs)
    res = mix(
        args.inputs, args.out, sr=args.sr,
        offsets=_csv_floats(args.offsets, n) or [0.0] * n,
        snr_dbs=_csv_floats(args.snr, n),
        gains_db=_csv_floats(args.gains_db, n),
        peak_limit=args.peak_limit, device=args.provider,
    )
    print(f"Saved mixture: {res.out_path}")
    print(f"- target SR     : {res.sample_rate}")
    print(f"- duration (s)  : {res.duration_sec:.3f}")
    print(f"- peak (before) : {res.peak_before_limit:.4f}, global gain: {res.limiter_gain:.4f}")
    print("- per-source scales (linear):", ", ".join(f"{s:.4f}" for s in res.scales))
    return res


if __name__ == "__main__":
    main()
