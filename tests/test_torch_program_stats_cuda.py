"""Program statistics on the card equal the CPU's (engine/programs.py).

A tiny-preset engine on the card and the same engine on the CPU record the
same programs, keys, calls, flops and bytes over scenes that reach every
kernel entry (chip_smoke.PROGRAM_STATS_SCENES): the flagship's stages with
both separation backends (K1, K2, K4), 32 s buckets (K3 from 512 frames),
transcribe_long over a mesh of 4 shards (K5), PyanNet serving OSD (its
LSTMs: cuDNN's fused op on the card, the CPU's decomposition, both counted
by ``ops/work.rnn_work``). Each kernel reports its ``work()``; on the card
its ctypes launch is invisible to the dispatcher and on the CPU its twin's
ops are hidden, so a program counts the same on both.

CUDA kernels have no CPU mode: without a CUDA device every test here skips.
On the GPU machine (no JAX there) run

    python -m pytest tests/test_torch_program_stats_cuda.py -q --noconftest
"""
import numpy as np
import pytest
import torch

import chip_smoke
from audio_classification_tpu_torch.ops.kernels import attention, fbank, gau, tcn

pytestmark = pytest.mark.cuda

COUNTERS = {"fbank_power_mel": fbank.fbank_power_mel, "tcn_masker": tcn.fused_tcn_masker,
            "gau_attention": gau.gau_attention, "flash_attention": attention.flash_attention,
            "flash_attention_stats": attention.flash_attention_stats}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


def _rows(engine):
    return [{k: s[k] for k in ("name", "shapes", "static", "calls", "flops", "bytes")}
            for s in engine.program_stats()]


@pytest.mark.parametrize("scene", list(chip_smoke.PROGRAM_STATS_SCENES))
def test_card_counts_what_the_cpu_counts(dev, scene):
    expect, _cap = chip_smoke.PROGRAM_STATS_SCENES[scene]
    rows = {}
    for device in (dev, torch.device("cpu")):
        engine = chip_smoke.program_stats_engine(scene, device)
        before = {k: fn.launches for k, fn in COUNTERS.items()}
        chip_smoke.drive_program_stats_scene(np, engine, scene)
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert all(COUNTERS[k].launches > before[k] for k in expect), scene
        rows[device.type] = _rows(engine)
    assert rows["cuda"] and rows["cuda"] == rows["cpu"]
