"""Dynamic int8 compute for ``quant="int8"`` inference (port of
audio_classification_tpu/ops/quant.py).

- activations are quantised dynamically PER SAMPLE (leading batch row), the
  absmax taken under an optional validity mask, so a sample's result never
  depends on its batch mates or on padding;
- weights are quantised per OUTPUT channel (symmetric, no zero point, so the
  integer accumulator needs no correction term);
- the product accumulates in exact integers and is rescaled by one float32
  product ``acc * (sx * sw)``.

The integer product is a library call, as the reference leaves it to XLA:
``torch._int_mm`` (s8 x s8 -> s32 on the tensor cores) for CUDA tensors, a
float64 GEMM for CPU tensors. Both are exact: |acc| <= K * 127^2, far below
2^31 and 2^53 for every K in the models (a float32 GEMM would be exact only
up to K = 1040, and SenseVoice's second FFN projection has K = 2048).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .work import counted, uncounted

_EPS = 1e-12


def _per_sample_scale(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """absmax over every axis but the first -> [B, 1, ..., 1], over 127.

    ``mask`` (broadcastable to x, nonzero = valid) keeps padded positions out
    of the reduction; their clipped values only feed padded outputs."""
    a = x.abs()
    if mask is not None:
        a = a * mask.to(a.dtype)
    amax = a.amax(dim=tuple(range(1, x.ndim)), keepdim=True)
    return torch.clamp_min(amax, _EPS) / 127.0


def _to_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # divide (not a reciprocal product); torch.round rounds half to even
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_dynamic(x: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """float [B, ...] -> (int8 values, float32 per-sample scale)."""
    x = x.float()
    scale = _per_sample_scale(x, mask)
    return _to_int8(x, scale), scale


def quantize_weight(w: torch.Tensor, channel_axis: int = -1, keep_axes: tuple = ()):
    """float kernel -> (int8 kernel, float32 per-out-channel scale), the
    scale's shape 1 everywhere except ``channel_axis`` and ``keep_axes``
    (leading axes of a stack of kernels that are quantised one by one)."""
    w = w.float()
    kept = {a % w.ndim for a in (channel_axis, *keep_axes)}
    ax = tuple(i for i in range(w.ndim) if i not in kept)
    scale = torch.clamp_min(w.abs().amax(dim=ax, keepdim=True), _EPS) / 127.0
    # contiguous: callers pass transposed views, and the integer GEMM would
    # otherwise copy the int8 kernel on every call
    return _to_int8(w, scale).contiguous(), scale


def constant_of(owner, name: str, params, make):
    """``make()`` once per value of constant parameters: the result is kept
    on ``owner`` (a module) under ``name`` and made again when one of
    ``params`` was written in place, replaced or moved. With gradients enabled
    nothing is kept (training changes the weights between calls).

    Inference quantises constant weights; doing that on every forward is
    repeated work that changes no number."""
    if torch.is_grad_enabled():
        return make()
    key = tuple((p.data_ptr(), 0 if p.is_inference() else p._version, p.device, p.dtype)
                for p in params)
    held = owner.__dict__.setdefault("_constants", {})
    hit = held.get(name)
    if hit is None or hit[0] != key:
        with uncounted():
            hit = held[name] = (key, make())
    return hit[1]


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def int_matmul_work(m: int, k: int, n: int) -> dict:
    """The int8 GEMM's work: 2 M N K products, the int8 operands read and
    the float32 result written once."""
    return {"flops": 2.0 * m * k * n, "bytes": 1.0 * (m * k + k * n) + 4.0 * m * n}


@counted(lambda a8, b8: int_matmul_work(*a8.shape, b8.shape[1]))
def int_matmul(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> float32 [M, N] holding the exact integer
    sums (rounded to nearest even above 2^24, as an int32 -> float32 cast).
    A work count (ops/work) takes ``int_matmul_work`` on either device, not
    the card's padded product or the CPU's float64 one."""
    if a8.device.type == "cpu":
        return (a8.double() @ b8.double()).float()
    # torch._int_mm takes K and N in multiples of 8 and more than 16 rows;
    # cuBLASLt on the H100 moreover refuses row counts off a multiple of 32
    # when K < 128 ([2000, 32] x [32, 512], a 2 s window through the
    # separator's encoder, is refused; [2016, 32] is taken). Zero rows and
    # columns add nothing to the sums
    m, k = a8.shape
    n = b8.shape[1]
    mp, kp, np_ = _pad_to(m, 32), _pad_to(k, 8), _pad_to(n, 8)
    if (mp, kp) != (m, k):
        a8 = F.pad(a8, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b8 = F.pad(b8, (0, np_ - n, 0, kp - k))
    acc = torch._int_mm(a8.contiguous(), b8.contiguous())
    return acc[:m, :n].float()


def int8_matmul(x: torch.Tensor, w: torch.Tensor, mask: Optional[torch.Tensor] = None,
                wq: Optional[tuple] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x [B, ..., K] @ w [K, N] with per-sample activation scales (bounded
    by ``mask``, broadcastable to x) and per-column weight scales, rescaled
    in float32 and rounded once to ``out_dtype``. ``wq``:
    ``quantize_weight(w, channel_axis=-1)`` made earlier, for a constant w."""
    x8, sx = quantize_dynamic(x, mask)
    w8, sw = quantize_weight(w, channel_axis=-1) if wq is None else wq  # [1, N]
    acc = int_matmul(x8.reshape(-1, x8.shape[-1]), w8).reshape(*x8.shape[:-1], w8.shape[-1])
    return (acc * (sx * sw.reshape(-1))).to(out_dtype)


def int8_conv1d(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1, dilation: int = 1,
                padding=(0, 0), mask: Optional[torch.Tensor] = None,
                wq: Optional[tuple] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Feature-last conv1d (groups = 1) on the int8 path.

    x: [B, T, Cin] float; kernel: [K, Cin, Cout] float (tap-major, the
    reference's layout); ``padding``: (lo, hi) zeros, which quantise to 0
    exactly; mask: optional [B, T] validity (scale reduction only). The
    windows are gathered into [B, T', K * Cin] rows for one integer GEMM.
    ``wq``: ``quantize_weight(kernel, channel_axis=-1)`` made earlier, for a
    constant kernel. The float32 rescale rounds once to ``out_dtype``."""
    x8, sx = quantize_dynamic(x, None if mask is None else mask[..., None])
    w8, sw = quantize_weight(kernel, channel_axis=-1) if wq is None else wq  # [1, 1, Cout]
    k, cin, cout = kernel.shape
    if k > 1 or stride > 1 or any(padding):
        x8 = F.pad(x8, (0, 0, int(padding[0]), int(padding[1])))
        span = (k - 1) * dilation + 1
        t_out = (x8.shape[1] - span) // stride + 1
        idx = (torch.arange(t_out, device=x.device)[:, None] * stride
               + torch.arange(k, device=x.device)[None, :] * dilation)
        x8 = x8[:, idx, :]  # [B, T', K, Cin]
    b, t_out = x8.shape[0], x8.shape[1]
    acc = int_matmul(x8.reshape(b * t_out, k * cin), w8.reshape(k * cin, cout))
    return (acc.reshape(b, t_out, cout) * (sx * sw.reshape(1, 1, -1))).to(out_dtype)
