"""Time-sharded separation (port of
audio_classification_tpu/parallel/sp_convtasnet.py).

One arbitrarily long mixture's FRAME axis is cut over the mesh, and every op
that looks past a shard edge gets exactly the data it needs from its
neighbours:

- encoder: each shard holds ``frames_per_shard * stride`` samples and takes
  the ``enc_kernel - stride`` sample halo from its right neighbour (zeros on
  the last shard: the dense pad);
- dilated depthwise convs: halos from both neighbours per TCN block (zeros
  at the global ends reproduce XLA SAME padding);
- gLN: global (time, channel) statistics as sums of masked partial sums;
- decoder overlap-add: each shard's trailing ``enc_kernel - stride`` samples
  go to the right neighbour and add into its head.

``sp_separate(model, mix, lengths, mesh)`` equals the dense masked forward
``model(pad(mix), sample_mask)[..., :t]`` (models/convtasnet.py), and
``sp_separate_mossformer`` that of models/mossformer.py, whose relu^2
attention has no softmax, so its ring pass is a plain partial sum.

The shard program is written once over lists that hold this rank's shards
(parallel/mesh.py: every shard at world size 1, the rank's own under
``torchrun``): a per-shard step is a comprehension, and what the JAX body
does with ``ppermute`` and ``psum`` are ``halo_from_right``,
``halo_from_left``, ``psum`` and ``ring_shift`` of parallel/collectives,
which cross ranks at the ends of the list. Every rank takes the whole
mixture and gets the whole output (``all_gather`` at exit). The
pointwise products stay ``torch`` matrix products, outside any hand-written
kernel, as the JAX package leaves them to XLA; K2 and K4 are not on this path.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from ..models.convtasnet import ConvTasNet
from ..models.mossformer import MossFormer
from .collectives import all_gather, halo_from_left, halo_from_right, psum, ring_shift


class _Axis:
    """The mesh axis a shard body runs over: its collectives, bound."""

    def __init__(self, mesh, axis: str):
        self.mesh, self.axis = mesh, axis
        self.n = mesh.shape[axis]
        self.mine = mesh.local_range(axis)

    def right(self, xs, h):
        return halo_from_right(xs, h, self.mesh, self.axis)

    def left(self, xs, h):
        return halo_from_left(xs, h, self.mesh, self.axis)

    def psum(self, xs):
        return psum(xs, self.mesh, self.axis)

    def shift(self, xs):
        return ring_shift(xs, self.mesh, self.axis)

    def gather(self, xs, dim):
        return all_gather(xs, self.mesh, self.axis, dim=dim)


def _gln_sp(xs, masks, norm, ax: _Axis) -> List[torch.Tensor]:
    """models/common.GlobalLayerNorm (masked branch) with statistics summed
    over the shards."""
    ms = [m[..., None].float() for m in masks]
    count = ax.psum([m.sum(dim=(1, 2), keepdim=True) for m in ms])
    count = torch.clamp_min(count * xs[0].shape[-1], 1.0)
    mean = ax.psum([(x * m).sum(dim=(1, 2), keepdim=True) for x, m in zip(xs, ms)]) / count
    var = ax.psum([(((x - mean) * m) ** 2).sum(dim=(1, 2), keepdim=True)
                   for x, m in zip(xs, ms)]) / count
    inv = torch.rsqrt(var + norm.eps)
    return [(x - mean) * inv * norm.gamma + norm.beta for x in xs]


def _dw_conv_sp(xs, conv, dilation: int, ax: _Axis) -> List[torch.Tensor]:
    """Depthwise SAME conv across the sharded frame axis via halos. XLA SAME
    at stride 1 pads total = (k - 1) * dilation, split lo = total // 2,
    hi = total - lo: the split is over the TOTAL, not per tap."""
    total = (conv.kernel_size - 1) * dilation
    lo = total // 2
    hi = total - lo
    parts = [xs]
    if lo:
        parts.insert(0, ax.left(xs, lo))
    if hi:
        parts.append(ax.right(xs, hi))
    return [F.conv1d(torch.cat(p, dim=1).transpose(1, 2), conv.weight, conv.bias, 1, 0,
                     dilation, conv.groups).transpose(1, 2)
            for p in zip(*parts)]


def _plan(name: str, t: int, n: int, stride: int, enc_kernel: int, max_halo: int, hint: str):
    """-> (dense frame count, frames per shard). The frames cover every real
    sample (f * stride >= t; the trailing L - stride overhang comes from
    halos or zeros) and tile the mesh axis."""
    f_dense = max(-(-(t - enc_kernel) // stride) + 1, 1) if t >= enc_kernel else 1
    f = max(f_dense, -(-t // stride))
    fs = -(-f // n)
    if fs < max(max_halo, 1):
        raise ValueError(f"{name}: {fs} frames/shard < {hint} ({max_halo}); use longer "
                         f"audio or fewer shards (t={t}, shards={n})")
    return f_dense, fs


def _encode(model, mix, lengths, ax: _Axis, fs: int):
    """Per shard: the local sample mask, the encoder over the masked samples
    with the right neighbour's halo (exchanged after masking, so boundary
    frames see exactly the dense masked signal), and the frame index.
    -> (w [B, fs, N], smask [B, fs*stride], f_idx [fs]) lists, f_len [B]."""
    c = model.cfg
    stride, L = c.stride, c.enc_kernel
    dev = mix.device
    span = fs * stride
    mix_p = F.pad(mix.float(), (0, ax.n * span - mix.shape[1]))
    pos = torch.arange(span, device=dev)
    smasks = [((i * span + pos)[None, :] < lengths[:, None]).to(mix_p.dtype) for i in ax.mine]
    xs = [mix_p[:, i * span:(i + 1) * span] * sm for i, sm in zip(ax.mine, smasks)]
    halos = ax.right(xs, L - stride)
    ws = [torch.relu(model.encoder(torch.cat([x, h], dim=1)[..., None]))
          for x, h in zip(xs, halos)]
    f_len = torch.clamp_min(torch.div(lengths - L, stride, rounding_mode="floor") + 1, 1)
    f_idx = [i * fs + torch.arange(fs, device=dev) for i in ax.mine]
    return ws, smasks, f_idx, f_len


def _decode(model, masked, smasks, fs: int, t: int, ax: _Axis) -> torch.Tensor:
    """Decoder overlap-add: each shard emits its own fs * stride samples; the
    (L - stride)-sample tail overlaps the right neighbour's head and is
    added there. masked: [B, fs, S, N] per shard -> [B, S, t], joined over
    every shard."""
    c = model.cfg
    stride, L = c.stride, c.enc_kernel
    b = masked[0].shape[0]
    weight = model.decoder.t()[:, None, :]
    sigs = [F.conv_transpose1d(mk.permute(0, 2, 3, 1).reshape(b * c.n_src, c.enc_dim, fs),
                               weight, stride=stride).reshape(b, c.n_src, -1)
            for mk in masked]                       # [B, S, fs*stride + L - stride]
    span = fs * stride
    # the left neighbour's tail [B, L - stride, S] (zeros left of shard 0)
    tails = ax.left([sig[..., span:].transpose(1, 2) for sig in sigs], L - stride)
    out = []
    for sig, tail, sm in zip(sigs, tails, smasks):
        main = sig[..., :span]
        head = main[..., : L - stride] + tail.transpose(1, 2)
        main = torch.cat([head, main[..., L - stride:]], dim=-1)
        out.append(main * sm[:, None, :])
    return ax.gather(out, dim=-1)[..., :t]


def _lengths(lengths, b: int, t: int, dev) -> torch.Tensor:
    if lengths is None:
        return torch.full((b,), t, dtype=torch.int64, device=dev)
    return torch.as_tensor(lengths, device=dev).long()


def sp_separate(model: ConvTasNet, mix: torch.Tensor, lengths, mesh,
                axis: str = "data") -> torch.Tensor:
    """Separate [B, T] mixtures with the time axis cut over ``axis``.

    For every row, ``sp_separate(...)[..., :T]`` equals the dense masked
    forward ``model(padded_mix, sample_mask)[..., :T]``. ``lengths`` [B]
    gives each row's valid sample count (defaults to T)."""
    c = model.cfg
    if c.quant == "int8":
        raise ValueError("sp_separate: int8 pointwise convs use per-sample "
                         "masked scales that would span shards; run the SP "
                         "path in float/bf16")
    ax = _Axis(mesh, axis)
    n = ax.n
    b, t = mix.shape
    lengths = _lengths(lengths, b, t, mix.device)
    d_max = 2 ** (c.n_blocks - 1)
    # widest one-sided halo = hi side of the largest dilation's SAME pads
    max_halo = -(-(c.conv_kernel - 1) * d_max // 2)
    _f_dense, fs = _plan("sp_separate", t, n, c.stride, c.enc_kernel, max_halo,
                         "the TCN's widest halo")
    ws, smasks, f_idx, f_len = _encode(model, mix, lengths, ax, fs)
    fmasks = [idx[None, :] < f_len[:, None] for idx in f_idx]

    # masker TCN (models/convtasnet.py: ln_in, bottleneck, R x X blocks)
    hs = [model.bottleneck(x) for x in _gln_sp(ws, fmasks, model.ln_in, ax)]
    skips = [0.0] * len(hs)
    for blk in model.tcn_blocks():
        gs = [blk.prelu1(blk.in_conv(h)) for h in hs]
        gs = [g * fm[..., None] for g, fm in zip(_gln_sp(gs, fmasks, blk.norm1, ax), fmasks)]
        gs = [blk.prelu2(g) for g in _dw_conv_sp(gs, blk.dw_conv, blk.dw_conv.dilation, ax)]
        gs = _gln_sp(gs, fmasks, blk.norm2, ax)
        hs = [h + blk.res_conv(g) for h, g in zip(hs, gs)]
        skips = [s + blk.skip_conv(g) for s, g in zip(skips, gs)]
    masked = []
    for w, s, fm in zip(ws, skips, fmasks):
        m = model.mask_conv(model.mask_prelu(s)).reshape(b, fs, c.n_src, c.enc_dim)
        if c.mask_act == "relu":
            m = torch.relu(m)
        elif c.mask_act == "sigmoid":
            m = torch.sigmoid(m)
        elif c.mask_act == "softmax":
            m = torch.softmax(m, dim=2)
        else:
            raise ValueError(f"unknown mask_act {c.mask_act}")
        masked.append(w[:, :, None, :] * m * fm[:, :, None, None].to(w.dtype))
    return _decode(model, masked, smasks, fs, t, ax)


def _gau_ring_attn(qs, ks, vs, fmasks, inv_t: float, ax: _Axis) -> List[torch.Tensor]:
    """GAU attention with the key axis sharded: out_t = sum_s relu(q_t . k_s
    * inv_t * m_s)^2 v_s. No softmax, so the ring accumulation is a plain
    partial sum: K, V and mask blocks rotate while each shard adds up its
    queries' sum (models/mossformer.py semantics, mask applied before the
    relu)."""
    loc = range(len(qs))

    def block(q, k, v, m):
        logits = torch.matmul(q, k.transpose(1, 2)) * inv_t
        logits = logits * m[:, None, :].to(logits.dtype)
        return torch.matmul(torch.relu(logits) ** 2, v)

    acc = [block(qs[i], ks[i], vs[i], fmasks[i]) for i in loc]
    for _ in range(1, ax.n):
        ks, vs, fmasks = (ax.shift(z) for z in (ks, vs, fmasks))
        acc = [a + block(qs[i], ks[i], vs[i], fmasks[i]) for i, a in enumerate(acc)]
    return acc


def sp_separate_mossformer(model: MossFormer, mix: torch.Tensor, lengths, mesh,
                           axis: str = "data") -> torch.Tensor:
    """MossFormer separation with the frame axis cut over ``axis``; the same
    contract as ``sp_separate``: equals the dense masked forward
    (models/mossformer.py) sliced to T."""
    c = model.cfg
    ax = _Axis(mesh, axis)
    n = ax.n
    b, t = mix.shape
    lengths = _lengths(lengths, b, t, mix.device)
    max_halo = -(-(c.conv_kernel - 1) // 2)  # hi side of the SAME pads
    f_dense, fs = _plan("sp_separate_mossformer", t, n, c.stride, c.enc_kernel, max_halo,
                        "the conv halo")
    ws, smasks, f_idx, f_len = _encode(model, mix, lengths, ax, fs)
    fmasks = [idx[None, :] < f_len[:, None] for idx in f_idx]
    # frames past the dense tiling (the round-up to the mesh) stand in for
    # the dense forward's SAME zero padding at the conv halos
    tiles = [(idx < f_dense)[None, :, None].to(ws[0].dtype) for idx in f_idx]
    inv_t = 1.0 / float(f_dense)  # the dense forward divides by its frame count

    hs = [model.in_proj(w) for w in ws]
    for li in range(c.layers):
        blk = getattr(model, f"gau_{li}")
        hn = [blk.ln(h) for h in hs]
        hc = _dw_conv_sp([x * tl for x, tl in zip(hn, tiles)], blk.dwconv, 1, ax)
        hn = [x + F.silu(y) for x, y in zip(hn, hc)]
        us = [F.silu(blk.to_u(x)) for x in hn]
        vs = [F.silu(blk.to_v(x)) for x in hn]
        zs = [blk.to_qk(x) for x in hn]
        qs = [z * blk.gamma[0] + blk.beta[0] for z in zs]
        ks = [z * blk.gamma[1] + blk.beta[1] for z in zs]
        att = _gau_ring_attn(qs, ks, vs, fmasks, inv_t, ax)
        hs = [h + blk.to_out(u * a) * fm[..., None]
              for h, u, a, fm in zip(hs, us, att, fmasks)]
    masked = []
    for w, h, tl in zip(ws, hs, tiles):
        m = torch.relu(model.mask_head(model.ln_out(h))).reshape(b, fs, c.n_src, c.enc_dim)
        # the dense forward never zeroes its own invalid frames; only the
        # frames of the round-up, which it does not have, must vanish
        masked.append(w[:, :, None, :] * m * tl[..., None])
    return _decode(model, masked, smasks, fs, t, ax)
