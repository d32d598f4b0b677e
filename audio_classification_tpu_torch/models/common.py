"""Shared model-layer building blocks (port of
audio_classification_tpu/models/common.py).

Conventions follow the JAX package so converted weights and tests compare
like with like:
- feature tensors are time-major [B, T, C]; convs transpose internally;
- every module takes an optional boolean frame mask [B, T] and keeps padded
  positions inert;
- submodule names equal the flax param names (``LayerNorm_0``,
  ``MultiHeadSelfAttention_0``, ...), so convert/from_jax.py maps trees
  by path.
Traps carried over: flax ``nn.LayerNorm`` eps is 1e-6 (torch's is 1e-5),
``jax.nn.gelu`` is the tanh approximation, and XLA "SAME" padding is
asymmetric for stride > 1 (``same_padding``).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.attention import FLASH_MIN_T, attention_reference, flash_attention


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation)."""
    return F.gelu(x, approximate="tanh")


def same_padding(t: int, kernel: int, stride: int = 1, dilation: int = 1) -> tuple:
    """XLA "SAME" padding (lo, hi): out = ceil(t / stride), extra pad on the
    right. For k=5, s=2 it is (1, 2) at even t and (2, 2) at odd t."""
    out = -(-t // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - t, 0)
    return total // 2, total - total // 2


class GlobalLayerNorm(nn.Module):
    """gLN over (time, channels) jointly, masked for padding, f32 stats."""

    def __init__(self, channels: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is None:
            mean = x.mean(dim=(1, 2), keepdim=True)
            var = ((x - mean) ** 2).mean(dim=(1, 2), keepdim=True)
        else:
            m = mask[..., None].float()
            count = torch.clamp_min(m.sum(dim=(1, 2), keepdim=True) * x.shape[-1], 1.0)
            mean = (x * m).sum(dim=(1, 2), keepdim=True) / count
            var = (((x - mean) * m) ** 2).sum(dim=(1, 2), keepdim=True) / count
        return (x - mean) * torch.rsqrt(var + self.eps) * self.gamma + self.beta


class ChannelLayerNorm(nn.Module):
    """Per-frame LN over channels (cLN). Input [B, T, C]."""

    def __init__(self, channels: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.gamma + self.beta


class PReLU(nn.Module):
    """Parametric ReLU with a single learnable slope."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


class Conv1d(nn.Module):
    """Feature-last 1-D convolution, [B, T, Cin] -> [B, T', Cout], with
    XLA "SAME" / "VALID" padding. weight [Cout, Cin/groups, K]."""

    def __init__(self, cin: int, features: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1, use_bias: bool = True,
                 padding: str = "SAME"):
        super().__init__()
        self.kernel_size, self.stride, self.dilation = kernel_size, stride, dilation
        self.groups, self.padding = groups, padding
        self.weight = nn.Parameter(torch.empty(features, cin // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)
        if self.padding == "SAME":
            x = F.pad(x, same_padding(x.shape[-1], self.kernel_size, self.stride,
                                      self.dilation))
        y = F.conv1d(x, self.weight, self.bias, self.stride, 0, self.dilation, self.groups)
        return y.transpose(1, 2)


def sinusoidal_positions(n: int, d: int, offset: int = 0) -> np.ndarray:
    """Standard transformer sin/cos position table [n, d] (host constant)."""
    pos = np.arange(offset, offset + n, dtype=np.float64)[:, None]
    i = np.arange(d, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / d)
    table = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return table.astype(np.float32)


@functools.lru_cache(maxsize=64)
def position_table(n: int, d: int, device: torch.device) -> torch.Tensor:
    """sinusoidal_positions(n, d) on ``device``, uploaded once per shape (a
    per-call copy would make the host wait for the device's queue)."""
    return torch.from_numpy(sinusoidal_positions(n, d)).to(device)


class MultiHeadSelfAttention(nn.Module):
    """Masked MHSA, [B, T, D] with boolean frame mask [B, T]. From
    ``FLASH_MIN_T`` frames on the core is kernel K3 (its twin on CPU);
    below it the dense masked softmax, as on the TPU."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = x.shape
        d_head = self.dim // self.heads
        q, k, v = (z.reshape(b, t, self.heads, d_head).transpose(1, 2)
                   for z in self.qkv(x).split(self.dim, dim=-1))
        attend = flash_attention if t >= FLASH_MIN_T else attention_reference
        out = attend(q, k, v, mask)
        return self.out(out.transpose(1, 2).reshape(b, t, self.dim))


class TransformerBlock(nn.Module):
    """Pre-LN encoder block with a depthwise conv branch (a light conformer
    flavour: attn -> conv -> ffn). Every model of the ported slice uses the
    conv branch, so it is not optional here."""

    def __init__(self, dim: int, heads: int, ffn_mult: int = 4, conv_kernel: int = 3):
        super().__init__()
        if conv_kernel <= 0:
            raise ValueError("TransformerBlock: the port needs conv_kernel > 0")
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-6)
        self.MultiHeadSelfAttention_0 = MultiHeadSelfAttention(dim, heads)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=1e-6)
        self.dwconv = Conv1d(dim, dim, conv_kernel, groups=dim)
        self.LayerNorm_2 = nn.LayerNorm(dim, eps=1e-6)
        self.Dense_0 = nn.Linear(dim, dim * ffn_mult)
        self.Dense_1 = nn.Linear(dim * ffn_mult, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.MultiHeadSelfAttention_0(self.LayerNorm_0(x), mask)
        h = self.LayerNorm_1(x)
        if mask is not None:
            h = h * mask[..., None]
        x = x + F.silu(self.dwconv(h))
        x = x + self.Dense_1(gelu(self.Dense_0(self.LayerNorm_2(x))))
        if mask is not None:
            x = x * mask[..., None]
        return x


def lengths_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] int lengths -> [B, max_len] boolean mask."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]
