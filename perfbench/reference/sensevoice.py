"""The reference's recognizer call of the ``sensevoice`` family
(``perfbench/asr/sensevoice.py``): the LFR log-mel frontend, the
SenseVoice-style CTC encoder and greedy CTC decoding of ``models.py``, and
what ``check`` reads of the call.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from . import models as M

TOKEN_CAP = 512  # the engine's cap on the ids of one recognizer call


def recognize(ops: M.Ops, w: M.SD, c: dict, symbols: List[str], wav: torch.Tensor,
              lengths: torch.Tensor, given: Optional[dict] = None) -> dict:
    """[B, T] waves -> the call's ``feats``, ``mask``, ``logits``, ``pos``
    (the logit rows that count: the prompt frames and the valid frames),
    ``texts`` and ``margin`` (each item's smallest top-2 logit gap over its
    valid frames). CTC needs no teacher forcing: ``given``, the program's
    entry of the same call, is not read."""
    feats, mask = M.sensevoice_frontend(ops, c, wav, lengths)
    logits = M.sensevoice(ops, w, c, feats, mask)
    n_p = c["num_prompt"]
    body = logits[:, n_p:]
    ids = M.ctc_greedy(body, mask, TOKEN_CAP)
    top2 = body.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).masked_fill(~mask, float("inf"))
    pos = torch.cat([torch.ones((mask.shape[0], n_p), dtype=torch.bool, device=mask.device),
                     mask], dim=1)
    texts = [M.decode_text(x, symbols) for x in ids]
    return {"feats": feats, "mask": mask, "logits": logits, "pos": pos, "texts": texts,
            "margin": gap.min(dim=1).values}
