"""Small signal helpers (port of audio_classification_tpu/ops/signal.py)."""
from __future__ import annotations

import numpy as np
import torch


def l2norm(v):
    """Zero-safe L2 normalization over the last axis, for numpy arrays and
    torch tensors (reference: src/model.py:32-34)."""
    if isinstance(v, torch.Tensor):
        n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        return torch.where(n > 0, v / torch.where(n > 0, n, torch.ones_like(n)), v)
    n = np.sqrt(np.sum(v * v, axis=-1, keepdims=True))
    return np.where(n > 0, v / np.where(n > 0, n, 1.0), v)
