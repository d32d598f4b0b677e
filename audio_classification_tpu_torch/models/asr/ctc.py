"""Greedy CTC decode on device and the CTC training loss (port of
audio_classification_tpu/models/asr/ctc.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


def ctc_loss(logits: torch.Tensor, frame_mask: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """Mean over the batch of the per-sequence CTC negative log-likelihood
    (the JAX function is ``optax.ctc_loss``, XLA code, and so is this:
    ``F.ctc_loss``). logits [B, T, V] (log_softmax is taken here, as optax
    takes it), frame_mask [B, T] with the valid frames first (its sum is
    each item's frame count), labels [B, S] padded past ``label_lengths``.

    torch's reduction="mean" would also divide each NLL by its label length,
    which the JAX function does not: the per-sequence values are averaged
    here. A label that cannot fit its frames gives ``inf`` (zero_infinity
    stays off) where optax gives a large finite value (its log_epsilon is
    -1e5); ROADMAP section 3 records the difference."""
    # float32 at least (bfloat16 logits widen), float64 as it is
    log_probs = torch.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)),
                                  dim=-1).transpose(0, 1)  # [T, B, V]
    input_lengths = frame_mask.to(torch.int64).sum(dim=1)
    per_seq = F.ctc_loss(log_probs, labels.to(torch.int64), input_lengths,
                         label_lengths.to(torch.int64), blank=blank_id, reduction="none",
                         zero_infinity=False)
    return per_seq.mean()
