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

Reduced precision (the engine's ``compute_dtype="bfloat16"`` runs a bfloat16
copy of every module) follows flax's dtype rules, so both packages round at
the same points: ``Dense`` / ``DenseQ`` / ``Conv2d`` compute in
``promote(x, weight)`` and add the bias after the product's rounding;
``Conv1d`` computes in x's dtype (flax casts the kernel to it); the norms take
float32 statistics and return the input's dtype (``LayerNorm`` the promoted
one); ``BatchNorm2d`` runs flax's op order in the input's dtype. A float32
tensor meeting bfloat16 weights promotes to float32, so the float32
positional table, or a kernel's float32 output, turns the rest of a stack
float32 with bfloat16-rounded weights. With float32 inputs and weights every
layer is the plain torch call it always was.
"""
from __future__ import annotations

import functools
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.attention import FLASH_MIN_T, attention_reference, flash_attention
from ..ops.quant import constant_of, int8_conv1d, int8_matmul, quantize_weight
from ..parallel.ring_attention import ring_attention

F32 = torch.float32


def promote(*tensors) -> torch.dtype:
    """The dtype jnp's promotion gives these (floating) tensors."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    return dt


def _all_f32(*tensors) -> bool:
    return all(t is None or t.dtype == F32 for t in tensors)


def wide(x: torch.Tensor) -> torch.dtype:
    """The dtype of float32 statistics and products: float32, or x's dtype
    where that is wider (float64, as a gradient check runs)."""
    return torch.promote_types(x.dtype, F32)


def param_as(owner: nn.Module, name: str, dtype: torch.dtype) -> Optional[torch.Tensor]:
    """``owner``'s parameter or buffer ``name`` in ``dtype``: itself when it
    has that dtype, else a cast made once per value of it
    (ops/quant.constant_of). A bfloat16 copy's weights meet float32
    activations on every call of every layer past the positional table; a
    cast a call would be a device op a call."""
    p = getattr(owner, name)
    if p is None or p.dtype == dtype:
        return p
    return constant_of(owner, f"{name}_as_{dtype}", (p,), lambda: p.to(dtype))


def leaf_as(owner: nn.Module, name: str, dtype: torch.dtype,
            params: Optional[dict] = None) -> Optional[torch.Tensor]:
    """``param_as``, or with ``params`` (a tensor-parallel shard's leaves,
    parallel/tp.model_shards) ``params[name]`` cast on each call, None where
    the shard has no such leaf. A shard is a new view a call, and model
    shard 0 starts where its leaf does: a kept cast of it would be keyed like
    the whole leaf's."""
    if params is None:
        return param_as(owner, name, dtype)
    p = params.get(name)
    return None if p is None else p.to(dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation)."""
    return F.gelu(x, approximate="tanh")


def same_padding(t: int, kernel: int, stride: int = 1, dilation: int = 1) -> tuple:
    """XLA "SAME" padding (lo, hi): out = ceil(t / stride), extra pad on the
    right. For k=5, s=2 it is (1, 2) at even t and (2, 2) at odd t."""
    out = -(-t // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - t, 0)
    return total // 2, total - total // 2


def conv1d(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1, dilation: int = 1,
           padding="SAME", groups: int = 1) -> torch.Tensor:
    """[B, T, Cin] x [K, Cin/groups, Cout] -> [B, T', Cout]: the JAX package's
    feature-last functional conv (lax.conv_general_dilated with
    ("NHC", "HIO", "NHC")). ``padding`` is "SAME" (XLA's: extra pad on the
    right, so asymmetric at stride 2), "VALID" or ``[(lo, hi)]``."""
    k = kernel.shape[0]
    if padding == "SAME":
        pad = same_padding(x.shape[1], k, stride, dilation)
    elif padding == "VALID":
        pad = (0, 0)
    else:
        pad = tuple(padding[0])
    xt = F.pad(x.transpose(1, 2), pad) if pad != (0, 0) else x.transpose(1, 2)
    y = F.conv1d(xt, kernel.permute(2, 1, 0).to(x.dtype), None, stride, 0, dilation, groups)
    return y.transpose(1, 2)


class GlobalLayerNorm(nn.Module):
    """gLN over (time, channels) jointly, masked for padding: float32
    statistics and affine (``wide``), the result in x's dtype
    (models/common.py:20-47)."""

    def __init__(self, channels: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.shards([x], mask)[0]

    def shards(self, xs: List[torch.Tensor], mask: Optional[torch.Tensor] = None,
               params: Optional[List[Optional[dict]]] = None,
               total: Optional[Callable] = None) -> List[torch.Tensor]:
        """gLN of a tensor split along its channels: ``xs`` one tensor, or
        a rank's tensor-parallel shards with their ``params`` (gamma / beta
        columns) and ``total`` summing per-shard statistics over every shard
        of the axis (parallel/collectives.psum). The count runs over all of
        ``gamma``'s channels."""
        dt = wide(xs[0])
        xf = [x.to(dt) for x in xs]
        total = total or (lambda parts: parts[0])
        channels = self.gamma.shape[0]
        if mask is None:
            m, count = None, float(xs[0].shape[1] * channels)
        else:
            m = mask[..., None].to(dt)
            count = torch.clamp_min(m.sum(dim=(1, 2), keepdim=True) * channels, 1.0)
        mean = total([(x if m is None else x * m).sum(dim=(1, 2), keepdim=True)
                      for x in xf]) / count
        var = total([((x - mean if m is None else (x - mean) * m) ** 2).sum(dim=(1, 2),
                                                                            keepdim=True)
                     for x in xf]) / count
        inv = torch.rsqrt(var + self.eps)
        return [((xv - mean) * inv * leaf_as(self, "gamma", dt, p)
                 + leaf_as(self, "beta", dt, p)).to(x.dtype)
                for xv, x, p in zip(xf, xs, params or [None] * len(xs))]


class ChannelLayerNorm(nn.Module):
    """Per-frame LN over channels (cLN). Input [B, T, C]; float32 statistics
    and affine (``wide``), the result in x's dtype."""

    def __init__(self, channels: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = wide(x)
        xf = x.to(dt)
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + self.eps) * param_as(self, "gamma", dt)
             + param_as(self, "beta", dt))
        return y.to(x.dtype)


class PReLU(nn.Module):
    """Parametric ReLU with a single learnable slope."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), init))

    def forward(self, x: torch.Tensor, params: Optional[dict] = None) -> torch.Tensor:
        return torch.where(x >= 0, x, leaf_as(self, "alpha", x.dtype, params) * x)


class Conv1d(nn.Module):
    """Feature-last 1-D convolution, [B, T, Cin] -> [B, T', Cout], with
    XLA "SAME" / "VALID" padding or explicit ``((lo, hi),)`` pads (as
    lax.conv takes them: the transducer's kernel-centred ``((2, 2),)`` at
    stride 2, which is not "SAME"). weight [Cout, Cin/groups, K].

    ``quant="int8"`` (groups == 1 only; a depthwise conv stays float) runs the
    conv through ops/quant.int8_conv1d: per-sample activation scales bounded
    by the optional frame ``mask``, per-out-channel weight scales, exact
    integer accumulation; the bias is added after, in float. Without
    gradients the int8 weight is made once and kept until the weight changes
    (ops/quant.constant_of).

    ``params`` stands in for the module's weight and bias (a tensor-parallel
    shard, parallel/tp.model_shards; a float conv): the groups then follow
    the shard's input width."""

    def __init__(self, cin: int, features: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1, use_bias: bool = True,
                 padding="SAME", quant: str = "none"):
        super().__init__()
        self.kernel_size, self.stride, self.dilation = kernel_size, stride, dilation
        self.groups, self.padding, self.quant = groups, padding, quant
        self.weight = nn.Parameter(torch.empty(features, cin // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                params: Optional[dict] = None) -> torch.Tensor:
        if self.padding == "SAME":
            pad = same_padding(x.shape[1], self.kernel_size, self.stride, self.dilation)
        elif self.padding == "VALID":
            pad = (0, 0)
        else:
            pad = tuple(self.padding[0])
        bias = leaf_as(self, "bias", x.dtype, params)
        if self.quant == "int8" and self.groups == 1 and params is None:
            kernel = self.weight.permute(2, 1, 0)
            wq = constant_of(self, "wq", (self.weight,), lambda: quantize_weight(kernel))
            y = int8_conv1d(x, kernel, self.stride, self.dilation, pad, mask=mask, wq=wq,
                            out_dtype=x.dtype)
            return y if bias is None else y + bias
        weight = self.weight if params is None else params["weight"]
        groups = self.groups if params is None else x.shape[-1] // weight.shape[1]
        plain = _all_f32(x, weight)
        x = x.transpose(1, 2)
        if pad != (0, 0):
            x = F.pad(x, pad)
        # flax casts the kernel to x's dtype and adds the bias to the rounded
        # product; in float32 the bias rides in the convolution
        y = F.conv1d(x, leaf_as(self, "weight", x.dtype, params), bias if plain else None,
                     self.stride, 0, self.dilation, groups)
        if not plain and bias is not None:
            y = y + bias[:, None]
        return y.transpose(1, 2)


class Dense(nn.Linear):
    """``nn.Linear`` with flax ``nn.Dense`` dtype semantics: x, weight and
    bias promote to one dtype, the product accumulates in float32 and rounds
    to it, and the bias is added after that rounding. All-float32 is
    ``nn.Linear`` as it is. ``params`` stands in for the weight and bias (a
    tensor-parallel shard, parallel/tp.model_shards; no bias where it has
    none)."""

    def forward(self, x: torch.Tensor, params: Optional[dict] = None) -> torch.Tensor:
        weight, bias = ((self.weight, self.bias) if params is None
                        else (params["weight"], params.get("bias")))
        if _all_f32(x, weight, bias):
            return F.linear(x, weight, bias)
        dt = promote(x, weight, bias)
        y = F.linear(x.to(dt), leaf_as(self, "weight", dt, params))
        return y if bias is None else y + leaf_as(self, "bias", dt, params)


class DenseQ(Dense):
    """``Dense`` with an optional dynamic-int8 path: the same parameters
    (``weight`` [out, in], ``bias``) and, under ``quant="none"``, the same
    arithmetic, so a ``state_dict`` and a seeded init do not change.
    ``quant="int8"`` routes the product through ops/quant.int8_matmul with
    the frame ``mask`` [B, T] bounding the per-sample activation scale; the
    result is in ``promote(x, weight)``, as models/common.py:156-158."""

    def __init__(self, in_features: int, out_features: int, quant: str = "none"):
        super().__init__(in_features, out_features)
        self.quant = quant

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                quant: Optional[str] = None) -> torch.Tensor:
        """``quant`` overrides the module's setting for this call (the
        sequence-parallel path runs float projections in an int8 model)."""
        if (self.quant if quant is None else quant) != "int8":
            return super().forward(x)
        m = None if mask is None else mask[..., None]
        wq = constant_of(self, "wq", (self.weight,), lambda: quantize_weight(self.weight.t()))
        y = int8_matmul(x, self.weight.t(), mask=m, wq=wq, out_dtype=promote(x, self.weight))
        return y + self.bias


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm`` (eps 1e-6): float32 statistics (``wide``), the
    result in ``promote(x, weight, bias)``. All-float32 is ``nn.LayerNorm``
    as it is."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _all_f32(x, self.weight, self.bias):
            return super().forward(x)
        dt = wide(x)
        y = F.layer_norm(x.to(dt), self.normalized_shape, param_as(self, "weight", dt),
                         param_as(self, "bias", dt), self.eps)
        return y.to(promote(x, self.weight, self.bias))


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
    below it the dense masked softmax, as on the TPU. ``quant="int8"``
    quantises the two projections; the attention core stays float32.

    With ``mesh`` the core is sequence-parallel ring attention over
    ``sp_axis`` (parallel/ring_attention) on the same parameters, and both
    projections run in float even in an int8 model: a per-sample activation
    scale would have to span the shards."""

    def __init__(self, dim: int, heads: int, quant: str = "none"):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.qkv = DenseQ(dim, 3 * dim, quant)
        self.out = DenseQ(dim, dim, quant)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, mesh=None,
                sp_axis: str = "data") -> torch.Tensor:
        b, t, _ = x.shape
        d_head = self.dim // self.heads
        if mesh is not None:
            q, k, v = (z.reshape(b, t, self.heads, d_head)
                       for z in self.qkv(x, mask, quant="none").split(self.dim, dim=-1))
            kv_mask = mask if mask is not None else torch.ones(
                (b, t), dtype=torch.bool, device=x.device)
            # an encoder that entered through sp_seq_shard arrives with T a
            # multiple of the shard count, and this pad stays unused
            pad = (-t) % mesh.shape[sp_axis]
            if pad:
                q, k, v = (F.pad(z, (0, 0, 0, 0, 0, pad)) for z in (q, k, v))
                kv_mask = F.pad(kv_mask, (0, pad))
            out = ring_attention(q, k, v, mesh, axis=sp_axis, kv_mask=kv_mask)
            return self.out(out[:, :t].reshape(b, t, self.dim), quant="none")
        q, k, v = (z.reshape(b, t, self.heads, d_head).transpose(1, 2)
                   for z in self.qkv(x, mask).split(self.dim, dim=-1))
        attend = flash_attention if t >= FLASH_MIN_T else attention_reference
        out = attend(q, k, v, mask)
        return self.out(out.transpose(1, 2).reshape(b, t, self.dim), mask)


class TransformerBlock(nn.Module):
    """Pre-LN encoder block with an optional depthwise conv branch (a light
    conformer flavour: attn -> conv -> ffn); ``conv_kernel=0`` leaves the
    branch out (the Paraformer decoder). ``quant="int8"`` quantises the
    attention and FFN projections; the depthwise conv stays float. ``mesh``
    routes the attention core through ring attention and runs every
    projection of the block in float.

    flax numbers the LayerNorms in call order, so the FFN's is
    ``LayerNorm_2`` behind the conv branch and ``LayerNorm_1`` without it."""

    def __init__(self, dim: int, heads: int, ffn_mult: int = 4, conv_kernel: int = 3,
                 quant: str = "none"):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim)
        self.MultiHeadSelfAttention_0 = MultiHeadSelfAttention(dim, heads, quant)
        self.LayerNorm_1 = LayerNorm(dim)
        self.dwconv = None
        if conv_kernel > 0:
            self.dwconv = Conv1d(dim, dim, conv_kernel, groups=dim)
            self.LayerNorm_2 = LayerNorm(dim)
        self.Dense_0 = DenseQ(dim, dim * ffn_mult, quant)
        self.Dense_1 = DenseQ(dim * ffn_mult, dim, quant)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, mesh=None,
                sp_axis: str = "data") -> torch.Tensor:
        quant = None if mesh is None else "none"
        x = x + self.MultiHeadSelfAttention_0(self.LayerNorm_0(x), mask, mesh, sp_axis)
        ffn_ln = self.LayerNorm_1
        if self.dwconv is not None:
            h = self.LayerNorm_1(x)
            if mask is not None:
                h = h * mask[..., None]
            x = x + F.silu(self.dwconv(h))
            ffn_ln = self.LayerNorm_2
        x = x + self.Dense_1(gelu(self.Dense_0(ffn_ln(x), mask, quant)), mask, quant)
        if mask is not None:
            x = x * mask[..., None]
        return x


def lengths_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] int lengths -> [B, max_len] boolean mask."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]
