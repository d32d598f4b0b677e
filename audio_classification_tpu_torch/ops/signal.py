"""Small signal helpers (port of audio_classification_tpu/ops/signal.py),
and ``no_tf32``, the float32 guard of code the card may run outside a
StageEngine (which sets the same flags for its whole life)."""
from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls, convolutions and RNNs without TF32 inside (cuDNN
    takes TF32 for convolutions and RNNs by default); the caller's flags
    restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def l2norm(v):
    """Zero-safe L2 normalization over the last axis, for numpy arrays and
    torch tensors (reference: src/model.py:32-34)."""
    if isinstance(v, torch.Tensor):
        n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        return torch.where(n > 0, v / torch.where(n > 0, n, torch.ones_like(n)), v)
    n = np.sqrt(np.sum(v * v, axis=-1, keepdims=True))
    return np.where(n > 0, v / np.where(n > 0, n, 1.0), v)
