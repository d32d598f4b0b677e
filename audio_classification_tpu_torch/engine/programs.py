"""The stage programs' registry: the port's counterpart of the JAX engine's
``_AotProgram`` cache (audio_classification_tpu/engine/runtime.py:265-337),
behind ``StageEngine.program_stats`` / ``executed_flops`` /
``compile_summary``.

A program is keyed as the JAX engine keys its executables: (name, the
(shape, dtype) of each argument after the params, the sorted statics),
dtypes by numpy's names (``'int16'``, ``'float32'``), with one exception:
the arena programs leave the arena's length out (``(None,)``), where JAX
compiles one program per arena length on its 16384-sample grid, so that a
server's ticks and a dataset's waves of any total length reuse their
programs. PyTorch runs eagerly, so there is no executable to keep; a key's
first call records what JAX records when it lowers and compiles:

- ``flops`` and ``bytes``: that call's work (``ops/work.WorkCount``): the
  padded shape's products by torch's formulas, as XLA counts the padded
  program; each hand-written kernel by its own ``work()`` (on the TPU the
  JAX count has none for the Pallas kernels: no ``pl.pallas_call`` passes a
  ``cost_estimate``); a decoder's host loop by its first step, taken once
  a step (its steps do the same work; XLA counts a loop's body once); a
  block or model that an earlier call counted at the same shapes by that
  count (``ops/work.shape_keyed``), so a first call runs mostly natively;
- ``lower_s``: the host wall of that call (work counted), less nvcc's time;
- ``compile_s``: the seconds the kernels' build (``_build``) spent in nvcc
  during that call; 0.0 when the library was current, as a JAX
  persistent-cache hit.

Later calls of a key only add to ``calls``: no dispatch mode is active on
the warm path. Host threads share an engine (serving, streaming): a key is
registered under a lock, and its first call is counted once.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Sequence

import torch

from .. import _build
from ..ops.work import WorkCount


def program_key(name: str, args: Sequence[Any], statics: Mapping[str, Any]) -> tuple:
    """(name, ((shape, dtype), ...) of ``args``, sorted statics). An
    argument is a tensor, or its key entry (shape, dtype) given outright,
    where the key leaves a dimension out (None)."""
    return (name, tuple((tuple(a[0]), str(a[1]).replace("torch.", "")) if isinstance(a, tuple)
                        else (tuple(a.shape), str(a.dtype).replace("torch.", "")) for a in args),
            tuple(sorted(statics.items())))


class ProgramRegistry:
    """Per program key: name, first-call seconds and work, and calls."""

    def __init__(self):
        self._entries: Dict[tuple, Dict[str, Any]] = {}
        self._lock = threading.Lock()

    def call(self, name: str, args: Sequence[torch.Tensor], statics: Mapping[str, Any],
             run: Callable[[], Any]) -> Any:
        """``run()`` as one call of program ``name`` on ``args`` (its key's
        arguments) with ``statics``; the key's first call is counted."""
        key = program_key(name, args, statics)
        with self._lock:
            ent = self._entries.get(key)
            first = ent is None
            if first:
                ent = self._entries[key] = {"name": name, "key": key, "lower_s": 0.0,
                                            "compile_s": 0.0, "flops": 0.0, "bytes": 0.0,
                                            "calls": 0}
            ent["calls"] += 1
        if not first:
            return run()
        built = _build.build_seconds
        t0 = time.perf_counter()
        try:
            with WorkCount() as count:
                out = run()
        except BaseException:
            with self._lock:  # as a program that fails to compile: not registered
                self._entries.pop(key, None)
            raise
        ent["compile_s"] = _build.build_seconds - built
        ent["lower_s"] = time.perf_counter() - t0 - ent["compile_s"]
        ent["flops"], ent["bytes"] = count.flops, count.bytes
        return out

    def stats(self) -> List[Dict[str, Any]]:
        """One dict a key: name, shapes, static, lower_s, compile_s, flops,
        bytes, calls (the JAX ``program_stats``)."""
        with self._lock:
            entries = list(self._entries.values())
        return [{k: v for k, v in ent.items() if k != "key"}
                | {"shapes": str(ent["key"][1]), "static": str(ent["key"][2])}
                for ent in entries]

    def executed_flops(self) -> float:
        with self._lock:
            return float(sum(e["flops"] * e["calls"] for e in self._entries.values()))

    def summary(self) -> Dict[str, float]:
        with self._lock:
            entries = list(self._entries.values())
        return {"n_programs": len(entries),
                "lower_total_s": round(sum(e["lower_s"] for e in entries), 3),
                "compile_total_s": round(sum(e["compile_s"] for e in entries), 3)}
