"""The one traffic generator: a workload file's parameters + a seed -> jobs.

A job is what one ``Overlap3Pipeline.run()`` gets in file mode: a list of
mixture wavs and the enrollment wav of the target talker. Every mixture holds
the target talker. Talkers are synthetic and harmonic (a copy of
``chip_smoke.talkers``: eight harmonics of a vibrato f0 under a syllable-rate
envelope over a -50 dB noise floor), made on the device in bulk, with each
talker's f0 drawn from the seed.

Every seed gets the same multiset of mixture lengths (a stratified grid over
the workload's range, dealt to the jobs in a seeded order), so that a seed
changes what is said and in which order, never how much work a window holds.

Workload keys (``perfbench/workloads/<name>.json``):

    mixtures_per_job   mixtures in one job (one ``run()``)
    talkers            talkers in each mixture, the target among them
    length_s           [lo, hi] mixture seconds, uniform over the pool
    bucket_s           the engine bucket (seconds; buckets double) that
                       ``length_s`` must lie in: checked, ``make_jobs``
                       raises where it does not
    enroll_s           seconds of the enrollment wav
    osd                pyannote hysteresis: onset, offset, min_on, min_off
    kind               the record kind every mixture must give
    pool_jobs          distinct jobs the window cycles through
    warm_jobs          jobs run in set-up (every shape the window uses)
    check_jobs         jobs whose outputs are compared with the reference
"""
from __future__ import annotations

import json
import math
import os
import wave
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np
import torch

SR = 16000
HERE = Path(__file__).resolve().parent
F0_TARGET = (100.0, 250.0)
F0_OTHER = (90.0, 280.0)


@dataclass
class Job:
    """One job: int16 samples of each mixture and of the enrollment, and the
    wav files that hold them once ``write`` has run."""

    mixtures: List[np.ndarray]
    target: np.ndarray
    paths: List[str]
    target_path: str

    @property
    def audio_s(self) -> float:
        return sum(len(m) for m in self.mixtures) / SR


def load_workload(name: str, root: Path = HERE) -> dict:
    with open(root / "workloads" / f"{name}.json", encoding="utf-8") as f:
        return json.load(f)


def _talker(n: int, f0: torch.Tensor, gen: torch.Generator, device) -> torch.Tensor:
    """[k] f0s -> [k, n] talkers (float64 on ``device``)."""
    k = f0.shape[0]
    u = torch.rand((k, 4), generator=gen, device=device, dtype=torch.float64)
    t = torch.arange(n, device=device, dtype=torch.float64)[None, :] / SR
    vib = f0[:, None] * (1.0 + 0.03 * torch.sin(2 * math.pi * (3.0 + 3.0 * u[:, :1]) * t))
    phase = 2 * math.pi * torch.cumsum(vib, dim=1) / SR
    src = sum(torch.sin(h * phase) / h for h in range(1, 9))
    env = torch.clamp(torch.sin(2 * math.pi * (3.0 + 2.0 * u[:, 1:2]) * t + 6.0 * u[:, 2:3]),
                      min=0.0)
    noise = 0.003 * torch.randn((k, n), generator=gen, device=device, dtype=torch.float64)
    return src * env + noise


def _quantize(x: torch.Tensor) -> np.ndarray:
    """Peak 0.6, then int16 (the samples both sides read)."""
    x = 0.6 * x / torch.clamp_min(x.abs().max(), 1e-9)
    return torch.round(x * 32767.0).to(torch.int16).cpu().numpy()


def mixture_lengths(wl: dict, seed: int) -> np.ndarray:
    """[pool_jobs, mixtures_per_job] samples: a stratified grid over
    ``length_s``, in a seeded order."""
    n = wl["pool_jobs"] * wl["mixtures_per_job"]
    lo, hi = wl["length_s"]
    if not wl["bucket_s"] / 2 <= lo < hi <= wl["bucket_s"]:
        raise ValueError(f"length_s {wl['length_s']} is not inside the {wl['bucket_s']} s "
                         f"bucket (above {wl['bucket_s'] / 2} s, up to {wl['bucket_s']} s)")
    grid = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    order = np.random.default_rng([seed, 1]).permutation(n)
    return np.round(grid[order] * SR).astype(np.int64).reshape(wl["pool_jobs"], -1)


def make_jobs(wl: dict, seed: int, device="cpu", n_jobs: int = 0) -> List[Job]:
    """The workload's pool of jobs for ``seed`` (the first ``n_jobs`` when
    given), samples only: ``write`` puts them into files."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    lengths = mixture_lengths(wl, seed)
    n_jobs = n_jobs or wl["pool_jobs"]
    jobs = []
    for j in range(n_jobs):
        f0s = torch.rand((1 + wl["talkers"] * wl["mixtures_per_job"],), generator=gen,
                         device=device, dtype=torch.float64)
        f0_t = F0_TARGET[0] + (F0_TARGET[1] - F0_TARGET[0]) * f0s[:1]
        target = _quantize(_talker(int(wl["enroll_s"] * SR), f0_t, gen, device)[0])
        mixtures = []
        for m, n in enumerate(lengths[j]):
            other = f0s[1 + m * wl["talkers"]: (m + 1) * wl["talkers"]]
            f0 = torch.cat([f0_t, F0_OTHER[0] + (F0_OTHER[1] - F0_OTHER[0]) * other])
            mixtures.append(_quantize(_talker(int(n), f0, gen, device).sum(dim=0)))
        jobs.append(Job(mixtures, target, [], ""))
    return jobs


def _write_wav(path: str, samples: np.ndarray) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(samples.astype("<i2").tobytes())


def write(jobs: List[Job], folder: str) -> None:
    """Each job's mixtures and enrollment as 16-bit PCM wavs in ``folder``."""
    os.makedirs(folder, exist_ok=True)
    for j, job in enumerate(jobs):
        job.paths = []
        for m, x in enumerate(job.mixtures):
            path = os.path.join(folder, f"job{j}_mix{m}.wav")
            _write_wav(path, x)
            job.paths.append(path)
        job.target_path = os.path.join(folder, f"job{j}_target.wav")
        _write_wav(job.target_path, job.target)
