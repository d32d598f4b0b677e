"""Training losses (port of audio_classification_tpu/train/losses.py):
permutation-invariant negative SI-SDR for the separators, masked frame BCE
for the OSD / VAD heads and the additive-angular-margin softmax for the
speaker embedder. Each is the JAX function op for op, so values and
gradients agree to float32 rounding.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..metrics.sisdr import _assignments


def si_sdr_loss_matrix(refs: torch.Tensor, ests: torch.Tensor, mask: torch.Tensor,
                       eps: float = 1e-8) -> torch.Tensor:
    """Differentiable pairwise SI-SDR [B, K, N] (dB) over masked samples:
    refs [B, K, T], ests [B, N, T], mask [B, T]."""
    mask = mask.to(refs.dtype)
    m = mask[:, None, :]
    count = torch.clamp_min(mask.sum(dim=-1), 1.0)[:, None, None]
    r = (refs - (refs * m).sum(-1, keepdim=True) / count) * m
    e = (ests - (ests * m).sum(-1, keepdim=True) / count) * m
    dots = torch.einsum("bkt,bnt->bkn", r, e)
    r_e = (r * r).sum(-1) + eps
    e_e = (e * e).sum(-1) + eps
    scale = dots / r_e[..., None]
    proj = scale * scale * r_e[..., None] + eps
    noise = torch.clamp_min(e_e[:, None, :] - 2 * scale * dots + scale * scale * r_e[..., None],
                            eps)
    return 10.0 * (torch.log10(proj) - torch.log10(noise))


def frame_bce_loss(probs: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                   eps: float = 1e-7) -> torch.Tensor:
    """Masked binary cross-entropy over frames: probs, labels [..., T(, C)],
    mask broadcastable over the frame axis."""
    p = torch.clamp(probs, eps, 1.0 - eps)
    bce = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    m = mask.to(bce.dtype)
    while m.ndim < bce.ndim:
        m = m[..., None]
    ratio = bce.numel() / m.numel() if m.numel() else 1.0
    return (bce * m).sum() / torch.clamp_min(m.sum() * ratio, 1.0)


def aam_softmax_loss(embeddings: torch.Tensor, labels: torch.Tensor, weight: torch.Tensor,
                     margin: float = 0.2, scale: float = 30.0) -> torch.Tensor:
    """Additive-angular-margin softmax: embeddings [B, D] (any norm), labels
    [B] int, weight [C, D] class centres."""
    e = embeddings / torch.clamp_min(torch.linalg.norm(embeddings, dim=-1, keepdim=True), 1e-12)
    w = weight / torch.clamp_min(torch.linalg.norm(weight, dim=-1, keepdim=True), 1e-12)
    cos = e @ w.t()  # [B, C]
    theta = torch.arccos(torch.clamp(cos, -1.0 + 1e-7, 1.0 - 1e-7))
    onehot = F.one_hot(labels.long(), w.shape[0]).to(cos.dtype)
    logits = scale * (onehot * torch.cos(theta + margin) + (1.0 - onehot) * cos)
    return -(onehot * torch.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def pit_si_sdr_loss(ests: torch.Tensor, refs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of -(best mean SI-SDR over source permutations):
    ests [B, N, T], refs [B, K, T], mask [B, T]."""
    k, n = refs.shape[1], ests.shape[1]
    sdr = si_sdr_loss_matrix(refs, ests, mask)  # [B, K, N]
    assigns = torch.as_tensor(np.asarray(_assignments(n, k), dtype=np.int64), device=sdr.device)
    picked = sdr[:, torch.arange(k, device=sdr.device)[None, :], assigns]  # [B, M, K]
    return -picked.mean(dim=-1).amax(dim=-1).mean()
