"""K2: the whole Conv-TasNet masker (every TCN block) in one wrapper call.

Kernel: csrc/tcn_masker.cu (CUDA C++, sm_90a), replacing
audio_classification_tpu/ops/pallas/tcn_kernel.py::fused_tcn_masker (float
weight stream; the s8 stream is not ported yet). Bound and design are in
the source's header; ``tcn_masker_reference`` is the plain twin, op for op
the dense TCN loop on the stacked weights (tcn_kernel.py:370-419).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ... import _build

_EPS = 1e-8  # GlobalLayerNorm eps


def stack_tcn_params(blocks) -> dict:
    """Per-block TCNBlock modules (repeat-major order) -> the stacked dict
    of tcn_kernel.stack_tcn_params: w_in [NB, C, H], w_dw [NB, 3, H],
    w_res / w_skip [NB, H, C], vecs [NB, 8, H] (b_in, a1, g1, be1, b_dw, a2,
    g2, be2) and cvecs [NB, 2, C] (b_res, b_skip), all float32."""
    h = blocks[0].in_conv.weight.shape[0]

    def row(x):
        return x.detach().float().reshape(-1).expand(h)

    w_in = torch.stack([b.in_conv.weight[:, :, 0].t() for b in blocks])
    w_dw = torch.stack([b.dw_conv.weight[:, 0, :].t() for b in blocks])
    w_res = torch.stack([b.res_conv.weight[:, :, 0].t() for b in blocks])
    w_skip = torch.stack([b.skip_conv.weight[:, :, 0].t() for b in blocks])
    vecs = torch.stack([torch.stack([
        row(b.in_conv.bias), row(b.prelu1.alpha), row(b.norm1.gamma), row(b.norm1.beta),
        row(b.dw_conv.bias), row(b.prelu2.alpha), row(b.norm2.gamma), row(b.norm2.beta),
    ]) for b in blocks])
    cvecs = torch.stack([torch.stack([b.res_conv.bias, b.skip_conv.bias]) for b in blocks])
    out = {"w_in": w_in, "w_dw": w_dw, "w_res": w_res, "w_skip": w_skip,
           "vecs": vecs, "cvecs": cvecs}
    return {k: v.detach().float().contiguous() for k, v in out.items()}


def tcn_masker_reference(x: torch.Tensor, f_len: torch.Tensor, st: dict, *,
                         n_per_repeat: int) -> torch.Tensor:
    """Plain twin: [B, F, C] + [B] valid-frame counts -> [B, F, C] skip sum."""
    nb, hd = st["w_in"].shape[0], st["w_in"].shape[-1]
    f = x.shape[1]
    mask = torch.arange(f, device=x.device)[None, :] < f_len.to(x.device)[:, None]
    mf = mask[..., None].float()
    count = torch.clamp_min(mf.sum(dim=(1, 2), keepdim=True) * hd, 1.0)

    def gln(z, gamma, beta):
        mean = (z * mf).sum(dim=(1, 2), keepdim=True) / count
        var = (((z - mean) * mf) ** 2).sum(dim=(1, 2), keepdim=True) / count
        return (z - mean) * torch.rsqrt(var + _EPS) * gamma + beta

    def prelu(z, a):
        return torch.where(z >= 0, z, a * z)

    h, skips = x, torch.zeros_like(x)
    for i in range(nb):
        dil = 2 ** (i % n_per_repeat)
        v = st["vecs"][i]
        h1 = prelu(h @ st["w_in"][i] + v[0], v[1, 0])
        h1 = gln(h1, v[2], v[3]) * mf
        h2 = F.conv1d(h1.transpose(1, 2), st["w_dw"][i].t()[:, None, :], padding=dil,
                      dilation=dil, groups=hd).transpose(1, 2)
        h2 = gln(prelu(h2 + v[4], v[5, 0]), v[6], v[7])
        h = h + h2 @ st["w_res"][i] + st["cvecs"][i, 0]
        skips = skips + h2 @ st["w_skip"][i] + st["cvecs"][i, 1]
    return skips


def fused_tcn_masker(x: torch.Tensor, f_len: torch.Tensor, st: dict, *,
                     n_per_repeat: int) -> torch.Tensor:
    """[B, F, C] f32 bottleneck stream + [B] valid-frame counts + stacked
    block weights -> [B, F, C] f32 skip-connection sum.

    CPU tensors run the plain twin; CUDA tensors launch the kernel."""
    if st["w_in"].dtype == torch.int8:
        raise NotImplementedError(
            "fused_tcn_masker: the s8 weight stream (quant='int8') is not ported "
            "yet (ROADMAP slice 13); use the float stack")
    if x.device.type == "cpu":
        return tcn_masker_reference(x, f_len, st, n_per_repeat=n_per_repeat)
    if not x.is_cuda:
        raise ValueError(f"fused_tcn_masker: unsupported device {x.device}")
    b, f, c = x.shape
    nb, _, hd = st["w_in"].shape
    shapes = {"w_in": (nb, c, hd), "w_dw": (nb, 3, hd), "w_res": (nb, hd, c),
              "w_skip": (nb, hd, c), "vecs": (nb, 8, hd), "cvecs": (nb, 2, c)}
    for name, shape in shapes.items():
        t = st[name]
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"fused_tcn_masker: {name} must be float32 {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"fused_tcn_masker: x must be float32, got {x.dtype}")
    if c % 32 or hd % 64:
        raise ValueError(f"fused_tcn_masker: needs C % 32 == 0 and H % 64 == 0, "
                         f"got C={c}, H={hd}")
    if tuple(f_len.shape) != (b,):
        raise ValueError(f"fused_tcn_masker: f_len must be [{b}], got {tuple(f_len.shape)}")
    x = x.contiguous()
    fl = f_len.to(device=x.device, dtype=torch.int32).clamp(0, f).contiguous()
    w_rs = torch.cat([st["w_res"], st["w_skip"]], dim=-1).contiguous()
    weights = [st[k].contiguous() for k in ("w_in", "w_dw", "vecs")]
    cvecs = st["cvecs"].contiguous()
    xa, xb, skips = (torch.empty_like(x) for _ in range(3))
    h1, h2 = (torch.empty((b, f, hd), dtype=torch.float32, device=x.device) for _ in range(2))
    stats = torch.empty((nb, b, 4), dtype=torch.float64, device=x.device)
    fn = _build.kernel("act_tcn_masker", [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
    fused_tcn_masker.launches += 1
    _build.check("act_tcn_masker", fn(
        x.data_ptr(), fl.data_ptr(), weights[0].data_ptr(), weights[1].data_ptr(),
        weights[2].data_ptr(), w_rs.data_ptr(), cvecs.data_ptr(), xa.data_ptr(),
        xb.data_ptr(), h1.data_ptr(), h2.data_ptr(), stats.data_ptr(), skips.data_ptr(),
        b, f, c, hd, nb, n_per_repeat, torch.cuda.current_stream(x.device).cuda_stream))
    return skips


fused_tcn_masker.launches = 0  # kernel launches, counted where they happen
