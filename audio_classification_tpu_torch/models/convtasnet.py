"""Conv-TasNet speech separator (port of
audio_classification_tpu/models/convtasnet.py): stride-L/2 encoder, gLN +
bottleneck, R x X dilated TCN blocks (kernel K2 or the dense loop), mask
conv, and the decoder as an overlap-add of basis frames."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.tcn import fused_tcn_masker, stack_tcn_params
from ..ops.quant import constant_of, int8_matmul, quantize_weight
from ..parallel.collectives import enter_sharded
from ..parallel.mesh import convtasnet_param_spec
from ..parallel.tp import model_shards, model_total, of, row_sum, tensor_parallel
from .common import Conv1d, GlobalLayerNorm, PReLU, param_as, wide


@dataclass(frozen=True)
class ConvTasNetConfig:
    n_src: int = 3
    enc_dim: int = 512        # N: encoder basis filters
    enc_kernel: int = 32      # L: encoder window (2 ms @ 16 kHz)
    bottleneck: int = 128     # B: bottleneck channels
    hidden: int = 512         # H: conv block channels
    conv_kernel: int = 3      # P
    n_blocks: int = 8         # X: blocks per repeat (dilations 1..2^(X-1))
    n_repeats: int = 3        # R
    mask_act: str = "relu"
    sample_rate: int = 16000
    quant: str = "none"       # "int8": encoder, bottleneck, mask conv and
                              # decoder through ops/quant (int8 activations
                              # and weights); the masker as fused_tcn says
    fused_tcn: str = "auto"   # "auto": masker through K2 (its twin on CPU)
                              # when conv_kernel == 3; under int8 its weights
                              # stream as int8 + scales and its activations
                              # stay float (weight-only). "off": the dense
                              # block loop, whose pointwise convs quantise
                              # their activations too under int8: the two
                              # forms give different numbers

    @property
    def stride(self) -> int:
        return self.enc_kernel // 2


class TCNBlock(nn.Module):
    """One dilated depthwise-separable conv block with residual + skip.

    ``mesh`` with a model axis above 1 splits H over its model shards
    (parallel/tp.py): in_conv and dw_conv column-parallel, the gLN
    statistics summed over the shards, res_conv and skip_conv row-parallel
    with their sums all-reduced. Without one the block is one shard of its
    own weights."""

    def __init__(self, c: ConvTasNetConfig, dilation: int):
        super().__init__()
        self.in_conv = Conv1d(c.bottleneck, c.hidden, 1, quant=c.quant)
        self.prelu1 = PReLU()
        self.norm1 = GlobalLayerNorm(c.hidden)
        self.dw_conv = Conv1d(c.hidden, c.hidden, c.conv_kernel, dilation=dilation,
                              groups=c.hidden)
        self.prelu2 = PReLU()
        self.norm2 = GlobalLayerNorm(c.hidden)
        self.res_conv = Conv1d(c.hidden, c.bottleneck, 1, quant=c.quant)
        self.skip_conv = Conv1d(c.hidden, c.bottleneck, 1, quant=c.quant)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], mesh=None):
        shards = model_shards(self, mesh, _tcn_rule, _TCN_SUBS, ("res_conv", "skip_conv"))
        tp = shards[0] is not None
        xs = enter_sharded(x, mesh) if tp else x
        # the frame mask bounds the int8 activation scale: padded frames hold
        # normalised garbage after gLN and must not move a sample's grid
        hs = [self.prelu1(self.in_conv(xs, mask, of(s, "in_conv")), of(s, "prelu1"))
              for s in shards]
        hs = self.norm1.shards(hs, mask, [of(s, "norm1") for s in shards], model_total(mesh))
        if mask is not None:
            hs = [h * mask[..., None] for h in hs]
        hs = [self.prelu2(self.dw_conv(h, params=of(s, "dw_conv")), of(s, "prelu2"))
              for h, s in zip(hs, shards)]
        hs = self.norm2.shards(hs, mask, [of(s, "norm2") for s in shards], model_total(mesh))
        res, skip = (row_sum([conv(h, mask, of(s, name)) for h, s in zip(hs, shards)], mesh,
                             conv.bias)
                     for name, conv in (("res_conv", self.res_conv),
                                        ("skip_conv", self.skip_conv)))
        return x + res, skip


_TCN_SUBS = ("in_conv", "prelu1", "norm1", "dw_conv", "prelu2", "norm2", "res_conv", "skip_conv")


def _tcn_rule(name: str, leaf) -> tuple:
    """``convtasnet_param_spec``, with the gLN gamma / beta read by the
    shard's columns of H too."""
    return ("model",) if name.startswith("norm") else convtasnet_param_spec(name, leaf)


class ConvTasNet(nn.Module):
    """[B, T] mixture (+ sample mask) -> [B, n_src, T] estimates."""

    def __init__(self, cfg: ConvTasNetConfig = ConvTasNetConfig()):
        super().__init__()
        if cfg.quant not in ("none", "int8"):
            raise ValueError(f"ConvTasNet: quant must be none|int8, got {cfg.quant!r}")
        self.cfg = c = cfg
        self.encoder = Conv1d(1, c.enc_dim, c.enc_kernel, stride=c.stride, use_bias=False,
                              padding="VALID", quant=c.quant)
        self.ln_in = GlobalLayerNorm(c.enc_dim)
        self.bottleneck = Conv1d(c.enc_dim, c.bottleneck, 1, quant=c.quant)
        for r in range(c.n_repeats):
            for xb in range(c.n_blocks):
                self.add_module(f"tcn_{r}_{xb}", TCNBlock(c, dilation=2 ** xb))
        self.mask_prelu = PReLU()
        self.mask_conv = Conv1d(c.bottleneck, c.n_src * c.enc_dim, 1, quant=c.quant)
        self.decoder = nn.Parameter(torch.empty(c.enc_kernel, c.enc_dim))  # [L, N]

    def tcn_blocks(self) -> list:
        c = self.cfg
        return [getattr(self, f"tcn_{r}_{xb}")
                for r in range(c.n_repeats) for xb in range(c.n_blocks)]

    def forward(self, mix: torch.Tensor, sample_mask: Optional[torch.Tensor] = None,
                mesh=None) -> torch.Tensor:
        """``mesh`` with a model axis above 1 runs the masker tensor-parallel
        (the dense loop of TCNBlocks, H split over the model shards);
        otherwise the mesh changes nothing here."""
        c = self.cfg
        b, t = mix.shape
        stride = c.stride
        # pad so the encoder frames tile the signal exactly
        pad = (-(t - c.enc_kernel)) % stride if t >= c.enc_kernel else c.enc_kernel - t
        x = F.pad(mix, (0, pad))[..., None]  # [B, T', 1]
        if sample_mask is not None:
            x = x * F.pad(sample_mask.to(x.dtype), (0, pad))[..., None]

        # the input is masked above, so the encoder's int8 scale needs no mask
        w = torch.relu(self.encoder(x))  # [B, F, N]
        n_frames = w.shape[1]
        frame_mask = None
        if sample_mask is not None:
            f_len = _frame_lengths(sample_mask, c.enc_kernel, stride)
            frame_mask = torch.arange(n_frames, device=w.device)[None, :] < f_len[:, None]

        h = self.bottleneck(self.ln_in(w, frame_mask), frame_mask)
        tp = tensor_parallel(mesh)
        if tp and c.quant == "int8":
            raise ValueError("tensor parallelism serves float and bfloat16 separators: the "
                             "int8 path's per-sample activation scales span the whole hidden "
                             "width")
        if not tp and c.fused_tcn == "auto" and c.conv_kernel == 3:
            fl = f_len if frame_mask is not None else torch.full(
                (b,), n_frames, dtype=torch.int32, device=w.device)
            # stacked (and, under int8, quantised) once per set of weights and
            # activation dtype
            blocks = self.tcn_blocks()
            key = "tcn_stack" if h.dtype == torch.float32 else f"tcn_stack_{h.dtype}"
            st = constant_of(
                self, key, [p for blk in blocks for p in blk.parameters()],
                lambda: stack_tcn_params(blocks, h.dtype, weight_quant=(c.quant == "int8")))
            skips = fused_tcn_masker(h, fl, st, n_per_repeat=c.n_blocks)
        else:
            skips = 0.0
            for blk in self.tcn_blocks():
                h, skip = blk(h, frame_mask, mesh if tp else None)
                skips = skips + skip
        m = self.mask_conv(self.mask_prelu(skips), frame_mask)
        m = m.reshape(b, n_frames, c.n_src, c.enc_dim)
        if c.mask_act == "relu":
            m = torch.relu(m)
        elif c.mask_act == "sigmoid":
            m = torch.sigmoid(m)
        elif c.mask_act == "softmax":
            m = torch.softmax(m, dim=2)
        else:
            raise ValueError(f"unknown mask_act {c.mask_act}")

        masked = w[:, :, None, :] * m  # [B, F, S, N]
        if frame_mask is not None:
            # frames straddling the valid/pad boundary carry partial real
            # content; zero them so decoding matches the unpadded signal
            masked = masked * frame_mask[:, :, None, None].to(masked.dtype)

        # decoder: sum_n masked[f, n] dec[k, n] overlap-added at f*stride + k,
        # in float32 whatever the activations' dtype (the reference's einsum
        # asks for a float32 result), float64 kept
        if c.quant == "int8":
            # masked is zero at padded frames already; the product over the
            # basis axis goes through the int8 path, then the frames [.., L]
            # overlap-add (two terms per sample, so the order cannot matter)
            wq = constant_of(self, "decoder_wq", (self.decoder,),
                             lambda: quantize_weight(self.decoder.t()))
            frames = int8_matmul(masked, self.decoder.t(), wq=wq)  # [B, F, S, L]
            frames = frames.permute(0, 2, 3, 1).reshape(b * c.n_src, c.enc_kernel, n_frames)
            t_out = (n_frames - 1) * stride + c.enc_kernel
            sig = F.fold(frames, (1, t_out), (1, c.enc_kernel), stride=(1, stride))
        else:
            # a transposed conv with weight dec^T [N, 1, L]
            frames = masked.permute(0, 2, 3, 1).reshape(b * c.n_src, c.enc_dim, n_frames)
            dt = wide(frames)
            sig = F.conv_transpose1d(frames.to(dt), param_as(self, "decoder", dt).t()[:, None, :],
                                     stride=stride)
        sig = sig.reshape(b, c.n_src, -1)[..., :t]
        if sig.shape[-1] < t:
            sig = F.pad(sig, (0, t - sig.shape[-1]))
        if sample_mask is not None:
            sig = sig * sample_mask[:, None, :].to(sig.dtype)
        return sig


def _frame_lengths(sample_mask: torch.Tensor, enc_kernel: int, stride: int) -> torch.Tensor:
    """Valid encoder frames an item, max((sum(mask) - L) // stride + 1, 1),
    in the mask's dtype as the reference computes it
    (models/convtasnet.py:117, models/mossformer.py:105). In bfloat16 the sum
    rounds (320000 -> 319488, 4001 -> 4000) and so do the steps after it,
    and the frame mask compares frame indices rounded to bfloat16: a fault
    of the reference that the port keeps, so that both give the same frames.
    In float32 every step is exact."""
    lengths = sample_mask.sum(dim=-1)
    return torch.clamp_min(torch.div(lengths - enc_kernel, stride, rounding_mode="floor") + 1, 1)
