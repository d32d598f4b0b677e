"""Greedy CTC decode on device (port of
audio_classification_tpu/models/asr/ctc.py::ctc_greedy_decode)."""
from __future__ import annotations

import torch


def ctc_greedy_decode(logits: torch.Tensor, frame_mask: torch.Tensor, blank_id: int = 0):
    """[B, T, V] logits + [B, T] mask -> (ids [B, T], lengths [B]).

    Repeats collapse, blanks drop; ids[b, :lengths[b]] are the kept tokens,
    left-packed, and positions beyond the length are blank_id.
    """
    best = logits.argmax(dim=-1)  # [B, T]
    prev = torch.cat([torch.full_like(best[:, :1], blank_id), best[:, :-1]], dim=1)
    keep = (best != blank_id) & (best != prev) & frame_mask.bool()
    pos = torch.cumsum(keep.long(), dim=1) - 1
    lengths = keep.long().sum(dim=1)
    b, t = best.shape
    # scatter kept tokens to their packed positions (dropped ones go to slot T)
    packed = torch.full((b, t + 1), blank_id, dtype=best.dtype, device=best.device)
    packed.scatter_(1, torch.where(keep, pos, torch.full_like(pos, t)), best)
    return packed[:, :t], lengths
