"""Speaker-embedding extractor, ERes2Net-style, and the enrolled speaker
bank (port of audio_classification_tpu/models/speaker.py): a 2-D CNN of
Res2Net blocks over log-mel, attentive statistics pooling, a projection;
``SpeakerBank`` keeps the enrolled [S, D] matrix on the device and scores a
batch of embeddings against it in one matmul.

Layout: the body runs NCHW [B, C, T, F] (torch's convention); flax is NHWC
[B, T, F, C], and its fold ``x.reshape(b, t, f * ch)`` flattens F-major then
C, so the body permutes to [B, T, F, C] before flattening or ``proj`` would
read the wrong features. BatchNorm runs in inference mode (running stats).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.signal import l2norm
from ..ops.work import shape_keyed
from .common import Dense, param_as, promote


@dataclass(frozen=True)
class SpeakerEmbedderConfig:
    num_mel: int = 80
    channels: tuple = (32, 64, 128, 256)
    scale: int = 4           # res2net split count
    embed_dim: int = 192
    asp_hidden: int = 128    # attentive-stats-pool attention width
    sample_rate: int = 16000


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax ``nn.Conv`` dtype semantics: input, kernel and
    bias promote to one dtype and the bias is added after the product's
    rounding. All-float32 is ``nn.Conv2d`` as it is."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype == self.bias.dtype == torch.float32:
            return super().forward(x)
        dt = promote(x, self.weight, self.bias)
        y = self._conv_forward(x.to(dt), param_as(self, "weight", dt), None)
        return y + param_as(self, "bias", dt)[:, None, None]


class BatchNorm2d(nn.BatchNorm2d):
    """Inference BatchNorm. Below float32 (a bfloat16 copy holds bfloat16
    running statistics, as the reference casts every floating leaf), and
    where the running statistics are trained as parameters
    (pipelines/quality_gate: the reference's gate trains the whole variable
    tree, batch statistics included), it runs flax's op order in the
    promoted dtype, each op rounded:
    y = (x - mean) * (rsqrt(var + eps) * scale) + bias. All-float32 with
    the statistics as buffers is ``nn.BatchNorm2d`` as it is."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (x.dtype == self.weight.dtype == self.running_var.dtype == torch.float32
                and not self.running_var.requires_grad):
            return super().forward(x)
        dt = promote(x, self.running_mean, self.running_var, self.weight, self.bias)

        def col(name):
            return param_as(self, name, dt)[:, None, None]

        mul = torch.rsqrt(col("running_var") + self.eps) * col("weight")
        return (x.to(dt) - col("running_mean")) * mul + col("bias")


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> Conv2d:
    # flax "SAME": pad 1 for 3x3 at stride 1; a 1x1 conv at stride 2 needs
    # no padding (ceil(T/2) outputs either way)
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2)


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=1e-5)  # flax BatchNorm default epsilon


class Res2Block(nn.Module):
    """Multi-scale residual block: split channels, cascade 3x3 convs."""

    def __init__(self, cin: int, channels: int, scale: int, stride: int = 1):
        super().__init__()
        self.scale = scale
        width = channels // scale
        self.in_conv = _conv(cin, channels, 1, stride)
        self.bn_in = _bn(channels)
        for i in range(1, scale):
            self.add_module(f"conv_{i}", _conv(width, width, 3))
            self.add_module(f"bn_{i}", _bn(width))
        self.out_conv = _conv(channels, channels, 1)
        self.bn_out = _bn(channels)
        self.short = _conv(cin, channels, 1, stride) if stride > 1 or cin != channels else None

    @shape_keyed
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn_in(self.in_conv(x)))
        parts = y.chunk(self.scale, dim=1)
        outs = [parts[0]]
        prev = None
        for i in range(1, self.scale):
            inp = parts[i] if prev is None else parts[i] + prev
            prev = F.relu(getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(inp)))
            outs.append(prev)
        y = self.bn_out(self.out_conv(torch.cat(outs, dim=1)))
        if self.short is not None:
            x = self.short(x)
        return F.relu(x + y)


class AttentiveStatsPool(nn.Module):
    """Attention-weighted mean+std pooling over time ([B, T, C] -> [B, 2C])."""

    def __init__(self, channels: int, hidden: int = 128):
        super().__init__()
        self.Dense_0 = Dense(channels, hidden)
        self.Dense_1 = Dense(hidden, channels)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        a = self.Dense_1(torch.tanh(self.Dense_0(x)))
        if mask is not None:
            a = a.masked_fill(~mask[..., None], -1e9)
        if a.dtype == torch.float32:
            w = torch.softmax(a, dim=1)
        else:  # jax.nn.softmax's ops, each rounded to a's dtype
            e = torch.exp(a - a.amax(dim=1, keepdim=True))
            w = e / e.sum(dim=1, keepdim=True)
        mean = (w * x).sum(dim=1)
        var = (w * (x - mean[:, None, :]) ** 2).sum(dim=1)
        return torch.cat([mean, torch.sqrt(var + 1e-7)], dim=-1)


class SpeakerEmbedder(nn.Module):
    """[B, T, mel] fbank (+ frame mask) -> [B, embed_dim] (not normalized)."""

    def __init__(self, cfg: SpeakerEmbedderConfig = SpeakerEmbedderConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.stem = _conv(1, c.channels[0], 3)
        self.bn0 = _bn(c.channels[0])
        cin = c.channels[0]
        freq = c.num_mel
        for i, ch in enumerate(c.channels):
            stride = 1 if i == 0 else 2
            self.add_module(f"block_{i}", Res2Block(cin, ch, c.scale, stride))
            cin = ch
            freq = -(-freq // stride)
        self.asp = AttentiveStatsPool(freq * cin, c.asp_hidden)
        self.proj = Dense(2 * freq * cin, c.embed_dim)

    @shape_keyed
    def forward(self, feats: torch.Tensor, frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        x = F.relu(self.bn0(self.stem(feats[:, None])))  # [B, C, T, F]
        mask = frame_mask
        for i in range(len(c.channels)):
            x = getattr(self, f"block_{i}")(x)
            if mask is not None and i > 0:
                mask = mask[:, ::2][:, : x.shape[2]]
        b, ch, t, f = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, f * ch)  # flax NHWC fold
        return self.proj(self.asp(x, mask))


class SpeakerBank:
    """Enrolled speakers with cosine search, on the device (the equivalent
    of sherpa_onnx.SpeakerEmbeddingManager): ``add`` stores an embedding
    under a name; ``search`` returns the best name when its cosine score
    reaches the threshold, else "" (which callers map to "unknown").

    ``device`` defaults to the first CUDA device (raising without one) or to
    the device of ``mesh``. ``mesh`` shards the bank's rows over
    ``shard_axis`` (the JAX bank's NamedSharding): each local entry holds
    its rows (zero-padded to the axis' tiling), scores them, and the
    scores of every shard come back to every rank (collectives.all_gather),
    so ``scores`` / ``search`` keep their meaning."""

    def __init__(self, dim: int, mesh=None, device=None, shard_axis: str = "data"):
        self.mesh, self.shard_axis = mesh, shard_axis
        if mesh is not None:
            device = mesh.device if device is None else device
        from ..engine.runtime import resolve_device

        self.device = resolve_device(device)
        self.dim = dim
        self.names: List[str] = []
        self._vecs: List[np.ndarray] = []
        self._mat: Optional[torch.Tensor] = None

    def add(self, name: str, vec) -> bool:
        v = np.asarray(vec, dtype=np.float32).reshape(-1)
        if v.size != self.dim or name in self.names:
            return False
        self.names.append(name)
        self._vecs.append(np.asarray(l2norm(v), np.float32))
        self._mat = None
        return True

    @property
    def matrix(self) -> torch.Tensor:
        """[S', D] l2-normalised bank, uploaded once after each change; with
        a mesh, the rows of this rank's shards of the zero-padded bank."""
        if self._mat is None:
            mat = np.stack(self._vecs) if self._vecs else np.zeros((0, self.dim), np.float32)
            if self.mesh is not None and len(self._vecs):
                n = self.mesh.shape[self.shard_axis]
                mat = np.concatenate([mat, np.zeros(((-len(mat)) % n, self.dim), mat.dtype)])
                per = len(mat) // n
                mine = self.mesh.local_range(self.shard_axis)
                mat = mat[mine.start * per:mine.stop * per]
            self._mat = torch.from_numpy(np.ascontiguousarray(mat)).to(self.device)
        return self._mat

    @torch.inference_mode()
    def scores(self, embs) -> torch.Tensor:
        """[B, D] (any scale) -> [B, S] cosine scores in one matmul (a
        matmul a shard under a mesh, then the shards' columns joined)."""
        if not isinstance(embs, torch.Tensor):
            embs = torch.from_numpy(np.ascontiguousarray(embs, np.float32))
        e = embs.to(self.device, torch.float32)
        e = e / torch.clamp_min(e.norm(dim=-1, keepdim=True), 1e-12)
        if self.mesh is None or not self._vecs:
            return e @ self.matrix.t()
        from ..parallel.collectives import all_gather

        per = self.matrix.shape[0] // self.mesh.local_count(self.shard_axis)
        shards = [e @ self.matrix[i * per:(i + 1) * per].t()
                  for i in range(self.mesh.local_count(self.shard_axis))]
        return all_gather(shards, self.mesh, self.shard_axis, dim=1)[:, : len(self.names)]

    def search(self, emb, threshold: float) -> str:
        if not self.names:
            return ""
        s = self.scores(np.asarray(emb, np.float32)[None]).cpu().numpy()[0]
        i = int(np.argmax(s))
        return self.names[i] if s[i] >= threshold else ""

    def search_batch(self, embs, threshold: float) -> List[Tuple[str, float]]:
        """[B, D] -> [(name or "", top-1 score)] from one ``scores`` call;
        ("", nan) for every row of an empty bank."""
        if not self.names:
            return [("", float("nan"))] * len(embs)
        s = self.scores(np.asarray(embs, np.float32)).cpu().numpy()
        return [(self.names[i] if s[b, i] >= threshold else "", float(s[b, i]))
                for b, i in enumerate(s.argmax(axis=-1))]
