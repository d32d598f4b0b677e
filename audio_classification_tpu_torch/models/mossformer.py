"""MossFormer-style gated-attention separator, the second separation
backend (port of audio_classification_tpu/models/mossformer.py):
convolutional encoder and decoder around a masker of gated single-head
attention units (GAU, relu^2 scores) with a depthwise-conv token mixer.

From ``FLASH_MIN_T`` frames on the attention core is kernel K4 (its
blockwise twin on the CPU), below it the dense expression. At stride 8 every
bucket of 0.5 s or more at 16 kHz has at least 999 frames, so on the card
the engine's buckets always run K4; the dense [T, T] scores of one 8 s
bucket (T = 15999) would be 15999^2 x 4 bytes = 1.0 GB per item and layer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.attention import FLASH_MIN_T
from ..ops.kernels.gau import gau_attention
from ..parallel.collectives import enter_sharded
from ..parallel.mesh import mossformer_param_spec
from ..parallel.tp import model_shards, of, row_sum
from .common import F32, ChannelLayerNorm, Conv1d, Dense, param_as
from .convtasnet import _frame_lengths


@dataclass(frozen=True)
class MossFormerConfig:
    n_src: int = 2
    enc_dim: int = 512
    enc_kernel: int = 16
    dim: int = 384
    qk_dim: int = 128
    expansion: int = 2
    layers: int = 8
    conv_kernel: int = 17
    sample_rate: int = 8000

    @property
    def stride(self) -> int:
        return self.enc_kernel // 2


class GAUBlock(nn.Module):
    """Gated attention unit: u * (relu(q k^T / T)^2 v) with conv position
    mixing. T is the padded frame count of the batch, not the valid length,
    and the key mask multiplies the scaled logits (a masked key adds 0)."""

    def __init__(self, c: MossFormerConfig):
        super().__init__()
        d_e = c.dim * c.expansion
        self.ln = ChannelLayerNorm(c.dim)
        self.dwconv = Conv1d(c.dim, c.dim, c.conv_kernel, groups=c.dim)
        self.to_u = Dense(c.dim, d_e)
        self.to_v = Dense(c.dim, d_e)
        self.to_qk = Dense(c.dim, c.qk_dim)
        # one projection z, per-role scale and shift: row 0 makes q, row 1 k
        self.gamma = nn.Parameter(torch.ones(2, c.qk_dim))
        self.beta = nn.Parameter(torch.zeros(2, c.qk_dim))
        self.to_out = Dense(d_e, c.dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], mesh=None) -> torch.Tensor:
        h = self.ln(x)
        h = h + F.silu(self.dwconv(h))
        z = self.to_qk(h)
        q = z * self.gamma[0] + self.beta[0]
        k = z * self.gamma[1] + self.beta[1]
        t = x.shape[1]
        # a model axis above 1 splits d_e over its shards (parallel/tp.py)
        shards = model_shards(self, mesh, mossformer_param_spec, ("to_u", "to_v", "to_out"),
                              ("to_out",))
        tp = shards[0] is not None
        if tp:
            h, q, k = (enter_sharded(a, mesh) for a in (h, q, k))
        outs = []
        for s in shards:
            u = F.silu(self.to_u(h, of(s, "to_u")))
            v = F.silu(self.to_v(h, of(s, "to_v")))
            if t >= FLASH_MIN_T:
                att = gau_attention(q, k, v, mask, 1.0 / t)
            else:
                # float32 scores and a float32 p v on bfloat16 q, k, v, as the
                # reference's einsums with a float32 result (its p is not rounded)
                logits = torch.matmul(q.float(), k.float().transpose(1, 2)) / t
                if mask is not None:
                    logits = logits * mask[:, None, :].to(logits.dtype)
                att = torch.matmul(torch.relu(logits) ** 2, v.float())
            # att is float32 on both paths: from here the block, and the stream
            # after it, run in float32 (with bfloat16 weights in a bfloat16 copy)
            outs.append(self.to_out(u * att, of(s, "to_out")))
        out = row_sum(outs, mesh, self.to_out.bias)
        if mask is not None:
            out = out * mask[..., None]
        return x + out


class MossFormer(nn.Module):
    """[B, T] mixture (+ sample mask) -> [B, n_src, T]."""

    def __init__(self, cfg: MossFormerConfig = MossFormerConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.encoder = Conv1d(1, c.enc_dim, c.enc_kernel, stride=c.stride, use_bias=False,
                              padding="VALID")
        self.in_proj = Dense(c.enc_dim, c.dim)
        for i in range(c.layers):
            self.add_module(f"gau_{i}", GAUBlock(c))
        self.ln_out = ChannelLayerNorm(c.dim)
        self.mask_head = Dense(c.dim, c.n_src * c.enc_dim)
        self.decoder = nn.Parameter(torch.empty(c.enc_kernel, c.enc_dim))  # [L, N]

    def forward(self, mix: torch.Tensor, sample_mask: Optional[torch.Tensor] = None,
                mesh=None) -> torch.Tensor:
        """``mesh`` with a model axis above 1 runs every GAU tensor-parallel
        (d_e split over the model shards, K4 on each shard's columns of v)."""
        c = self.cfg
        b, t = mix.shape
        stride = c.stride
        pad = (-(t - c.enc_kernel)) % stride if t >= c.enc_kernel else c.enc_kernel - t
        x = F.pad(mix, (0, pad))[..., None]
        if sample_mask is not None:
            x = x * F.pad(sample_mask.to(x.dtype), (0, pad))[..., None]

        w = torch.relu(self.encoder(x))  # [B, F, N]
        n_frames = w.shape[1]
        frame_mask = None
        if sample_mask is not None:
            f_len = _frame_lengths(sample_mask, c.enc_kernel, stride)
            frame_mask = torch.arange(n_frames, device=w.device)[None, :] < f_len[:, None]

        h = self.in_proj(w)
        for i in range(c.layers):
            h = getattr(self, f"gau_{i}")(h, frame_mask, mesh)
        m = torch.relu(self.mask_head(self.ln_out(h))).reshape(b, n_frames, c.n_src, c.enc_dim)

        masked = w[:, :, None, :] * m  # [B, F, S, N]
        # decoder: sum_n masked[f, n] dec[k, n] overlap-added at f*stride + k
        # is a transposed conv with weight dec^T [N, 1, L] (as in ConvTasNet)
        frames = masked.permute(0, 2, 3, 1).reshape(b * c.n_src, c.enc_dim, n_frames)
        sig = F.conv_transpose1d(frames.float(), param_as(self, "decoder", F32).t()[:, None, :],
                                 stride=stride)
        sig = sig.reshape(b, c.n_src, -1)[..., :t]
        if sig.shape[-1] < t:
            sig = F.pad(sig, (0, t - sig.shape[-1]))
        if sample_mask is not None:
            sig = sig * sample_mask[:, None, :].to(sig.dtype)
        return sig
