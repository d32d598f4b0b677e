"""Background resource monitor: CPU/RSS via psutil, GPU memory via
torch.cuda (port of audio_classification_tpu/runtime/monitor.py).

Mirrors the reference's `_resource_monitor` thread and aggregate fields
(reference: overlap3_core.py:232-308): samples every `interval` seconds,
aggregates avg/peak. The GPU fields are the caching allocator's counters of
the current CUDA device (absent on a CPU-only run, where the aggregate
reports 0.0 as the reference does without device statistics).
"""
from __future__ import annotations

import os
import threading
from statistics import mean
from typing import Any, Dict, List, Optional

try:
    import psutil
except ImportError:  # pragma: no cover
    psutil = None


def _device_mem_mb() -> Dict[str, float]:
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    return {
        "gpu_mem_allocated": torch.cuda.memory_allocated() / (1024**2),
        "gpu_max_mem_allocated": torch.cuda.max_memory_allocated() / (1024**2),
        "gpu_mem_reserved": torch.cuda.memory_reserved() / (1024**2),
    }


class ResourceMonitor:
    def __init__(self, interval: float = 0.5):
        self.interval = interval if interval > 0.1 else 0.1
        self.samples: List[dict] = []
        self._halt = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._proc = psutil.Process(os.getpid()) if psutil else None

    def _loop(self):
        if self._proc:
            self._proc.cpu_percent(interval=None)  # prime the delta window
        while self._proc and not self._halt.wait(self.interval):
            try:
                rec = {
                    "cpu": self._proc.cpu_percent(interval=None),
                    "rss_mb": self._proc.memory_info().rss / (1024**2),
                }
                rec.update(_device_mem_mb())
                self.samples.append(rec)
            except Exception:
                break

    def start(self):
        if self._proc is None:
            return
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def stop(self):
        self._halt.set()
        if self._worker is not None:
            self._worker.join(2.0)

    def aggregate(self) -> Dict[str, Any]:
        if not self.samples:
            return {}
        cpu = [s["cpu"] for s in self.samples if "cpu" in s]
        rss = [s["rss_mb"] for s in self.samples if "rss_mb" in s]
        alloc = [s.get("gpu_mem_allocated", 0.0) for s in self.samples]
        res = [s.get("gpu_mem_reserved", 0.0) for s in self.samples]
        return {
            "cpu_avg": round(mean(cpu), 2) if cpu else None,
            "cpu_peak": round(max(cpu), 2) if cpu else None,
            "rss_avg_mb": round(mean(rss), 2) if rss else None,
            "rss_peak_mb": round(max(rss), 2) if rss else None,
            "gpu_mem_allocated_avg_mb": round(mean(alloc), 2) if alloc else None,
            "gpu_mem_allocated_peak_mb": round(max(alloc), 2) if alloc else None,
            "gpu_mem_reserved_peak_mb": round(max(res), 2) if res else None,
        }


class CPUMonitor:
    """Core-normalized CPU aggregate, reported under the artifact keys the
    reference's evaluator emits (evaluate_with_sources.py:447-511 — key
    names only; the sampling itself is delegated to ResourceMonitor above,
    whose per-sample dicts already carry process cpu_percent)."""

    def __init__(self, interval: float = 0.5):
        self._mon = ResourceMonitor(interval)
        self.interval = self._mon.interval

    def start(self) -> None:
        self._mon.start()

    def stop(self) -> Dict[str, Any]:
        self._mon.stop()
        if self._mon._proc is None:
            return {"enabled": False, "reason": "psutil_unavailable"}
        cpu = [s["cpu"] for s in self._mon.samples if "cpu" in s]
        report: Dict[str, Any] = {"enabled": True, "count": len(cpu)}
        if not cpu:
            return report
        cores = max(1, (psutil.cpu_count(logical=True) or 1) if psutil else 1)
        for label, value in (("avg", mean(cpu)), ("peak", max(cpu))):
            report[f"cpu_{label}_percent"] = round(min(100.0, value / cores), 2)
            report[f"cpu_{label}_percent_raw"] = round(value, 2)
        report.update(interval_sec=self.interval, cpu_logical_cores=cores, normalized=True)
        return report
