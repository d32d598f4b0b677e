"""Modified beam search shared by the transducer decoders (port of
audio_classification_tpu/models/asr/beam.py).

The hypotheses sit on a static beam axis beside the batch axis. Every frame
scores all beam x vocab continuations with one predictor / joiner call, and
the top ``beam`` of the flattened candidates (blank included) form the next
beam: one loop over frames on device tensors, then a backtrack from the
last frame to the first over the recorded (parent, symbol) pairs. No
hypothesis merging, as in the reference: slots stay distinct, so a score
can only under-report a hypothesis's mass. ``beam=1`` is exactly greedy.
"""
from __future__ import annotations

from typing import Callable

import torch

from ...ops.work import loop_step

_NEG_INF = -1e30


def left_pack_symbols(syms_bt: torch.Tensor, blank_id: int) -> tuple:
    """[B, T] per-frame symbols (blank where no symbol was emitted) ->
    (ids [B, T] left-packed and blank-padded, counts [B])."""
    b, t = syms_bt.shape
    emit = syms_bt != blank_id
    counts = emit.to(torch.int32).sum(dim=1)
    pos = torch.cumsum(emit.to(torch.int64), dim=1) - 1
    scatter = torch.where(emit, pos, t)  # a frame without a symbol writes the spare column
    packed = torch.full((b, t + 1), blank_id, dtype=syms_bt.dtype, device=syms_bt.device)
    packed.scatter_(1, scatter, syms_bt)  # emitted positions are distinct; the spare takes blanks
    return packed[:, :t], counts


def modified_beam_search(enc: torch.Tensor, mask: torch.Tensor,
                         score_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], *,
                         blank_id: int, context: int, beam: int,
                         return_score: bool = False) -> tuple:
    """Beam search over encoder frames.

    ``enc`` [B, T, D], ``mask`` [B, T] bool; ``score_fn(e_t, ctx)`` maps one
    frame [B, D] and every hypothesis's predictor context [B, K, context]
    to joiner logits [B, K, V]. -> (ids [B, T] left-packed, counts [B]),
    plus the best hypothesis's log-probability [B] with ``return_score``.

    The top k is a stable descending sort, so equal candidates keep the
    lower flat index first, as ``jax.lax.top_k`` does."""
    b, t, _ = enc.shape
    k = int(beam)
    dev = enc.device
    beam_iota = torch.arange(k, device=dev)[None, :]                        # [1, K]
    ctx = torch.full((b, k, context), blank_id, dtype=torch.int64, device=dev)
    # only slot 0 starts alive, else the top k would be k copies of one
    # empty hypothesis
    scores = torch.where(beam_iota == 0, 0.0, _NEG_INF).to(torch.float32).expand(b, k)
    parents, syms = [], []
    for i in range(t):
        with loop_step(i, t):
            logp = torch.log_softmax(score_fn(enc[:, i], ctx).float(), dim=-1)  # [B, K, V]
            vocab = logp.shape[-1]
            cand = (scores[:, :, None] + logp).reshape(b, k * vocab)
            top_scores, top_idx = torch.sort(cand, dim=1, descending=True, stable=True)
            top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
            parent = torch.div(top_idx, vocab, rounding_mode="floor")
            sym = top_idx % vocab
            emit = sym != blank_id
            parent_ctx = torch.gather(ctx, 1, parent[:, :, None].expand(-1, -1, context))
            new_ctx = torch.where(emit[:, :, None],
                                  torch.cat([parent_ctx[:, :, 1:], sym[:, :, None]], dim=2),
                                  parent_ctx)
            # a padded frame freezes the beam: identity parents, no symbol
            live = mask[:, i][:, None]                                           # [B, 1]
            ctx = torch.where(live[:, :, None], new_ctx, ctx)
            scores = torch.where(live, top_scores, scores)
            parents.append(torch.where(live, parent, beam_iota))
            syms.append(torch.where(live & emit, sym, blank_id))

    cur = scores.argmax(dim=-1)                                              # [B]
    best = [None] * t
    for i in range(t - 1, -1, -1):
        with loop_step(t - 1 - i, t):
            best[i] = torch.gather(syms[i], 1, cur[:, None])[:, 0]
            cur = torch.gather(parents[i], 1, cur[:, None])[:, 0]
    best_syms = (torch.stack(best, dim=1) if t else
                 torch.zeros((b, 0), dtype=torch.int64, device=dev))
    packed, counts = left_pack_symbols(best_syms, blank_id)
    if return_score:
        return packed, counts, scores.max(dim=-1).values
    return packed, counts
