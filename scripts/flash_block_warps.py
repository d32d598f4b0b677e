#!/usr/bin/env python3
"""K3 / K5 device time with 64-row blocks (4 warps, the library's) against
32-row blocks (2 warps), at the main path's shapes.

At batch 1 the grid is small ([1,8,537] gives 72 blocks of 64 rows, [1,4,800]
52, on 132 SMs), so halving the block doubles the blocks. The script builds
the kernel library twice, the second time with ``-DACT_FLASH_WARPS=2``, and
times the wrappers of each build by CUDA-graph replay (``chip_smoke.graph_ms``:
device time, no host time). Prints the card's nvidia-smi name and power limit,
then one JSON object per build and shape.

    python3 scripts/flash_block_warps.py

Needs nvcc (CUDA_HOME or PATH) and a CUDA device.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (kernel, B, H, Tq, Tk, valid keys of each item): chip_smoke.py's shapes
SHAPES = (("K3", 8, 8, 537, 537, None), ("K3", 1, 8, 537, 537, None),
          ("K3", 1, 4, 800, 800, None), ("K3", 1, 8, 4271, 4271, 3337),
          ("K5", 1, 8, 1068, 1068, 1068), ("K5", 1, 8, 1068, 1068, 133))


def main() -> int:
    import torch

    from audio_classification_tpu_torch import _build
    from audio_classification_tpu_torch.ops.kernels import attention
    from chip_smoke import gpu_name_and_power_limit, graph_ms

    print(gpu_name_and_power_limit(), flush=True)
    dev = torch.device("cuda")
    base = _build.NVCC_FLAGS
    for warps in (4, 2):
        _build.NVCC_FLAGS = base if warps == 4 else (*base, f"-DACT_FLASH_WARPS={warps}")
        _build._library.cache_clear()
        _build._entry.cache_clear()
        _build.build()
        gen = torch.Generator(device="cpu").manual_seed(1)
        for name, b, h, tq, tk, valid in SHAPES:
            q = torch.randn((b, h, tq, 64), generator=gen).to(dev)
            k, v = (torch.randn((b, h, tk, 64), generator=gen).to(dev) for _ in range(2))
            lens = torch.tensor([valid or tk - 97 * i % tk for i in range(b)], device=dev)
            mask = torch.arange(tk, device=dev)[None, :] < lens[:, None]
            fn = attention.flash_attention if name == "K3" else attention.flash_attention_stats
            print(json.dumps({"warps": warps, "rows_per_block": 16 * warps, "kernel": name,
                              "shape": [b, h, tq, 64], "keys": tk, "valid_keys": int(mask.sum()),
                              "ms": graph_ms(torch, lambda: fn(q, k, v, mask), 50)}), flush=True)
    _build.NVCC_FLAGS = base
    return 0


if __name__ == "__main__":
    sys.exit(main())
