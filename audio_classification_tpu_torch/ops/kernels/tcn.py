"""K2: the whole Conv-TasNet masker (every TCN block) in one wrapper call.

Kernel: csrc/tcn_masker.cu (CUDA C++, sm_90a), replacing
audio_classification_tpu/ops/pallas/tcn_kernel.py::fused_tcn_masker, with
both of its weight streams: float32 (C entry point ``act_tcn_masker``) and
int8 with per-block, per-out-channel float32 scales (``act_tcn_masker_s8``,
"K2-s8": the kernel reads the int8 weights and applies the scales as it
loads them; activations stay float). Three launches a TCN block: the two
pointwise GEMMs on the tensor cores in 3xTF32 and the depthwise pass, over
the valid rows only, with deterministic gLN statistics; bound and design
are in the source's header. ``tcn_masker_reference`` is the plain twin, op
for op the dense TCN loop on the stacked weights (tcn_kernel.py:370-419),
run on the dequantised stack for an int8 one.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ... import _build
from ..quant import quantize_weight

_EPS = 1e-8  # GlobalLayerNorm eps


def stack_tcn_params(blocks, weight_quant: bool = False) -> dict:
    """Per-block TCNBlock modules (repeat-major order) -> the stacked dict
    of tcn_kernel.stack_tcn_params: w_in [NB, C, H], w_dw [NB, 3, H],
    w_res / w_skip [NB, H, C], vecs [NB, 8, H] (b_in, a1, g1, be1, b_dw, a2,
    g2, be2) and cvecs [NB, 2, C] (b_res, b_skip), all float32.

    ``weight_quant``: the int8 weight stream. The four weight tensors are
    quantised symmetric per OUT channel and per BLOCK (one block's outliers
    must not flatten another block's grid) to int8, and their float32 scales
    ride in the vector bundles: vecs [NB, 10, H] rows 8, 9 (w_in, w_dw) and
    cvecs [NB, 4, C] rows 2, 3 (w_res, w_skip). Inference only."""
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
    out = {k: v.detach().float().contiguous() for k, v in out.items()}
    if weight_quant:
        # [NB, X, OUT] with the block axis kept apart: the absmax runs over X
        # only, which is quantising block by block
        scales = {}
        for name in ("w_in", "w_dw", "w_res", "w_skip"):
            out[name], scales[name] = quantize_weight(out[name], channel_axis=-1, keep_axes=(0,))
        out["vecs"] = torch.cat([out["vecs"], scales["w_in"], scales["w_dw"]], dim=1)
        out["cvecs"] = torch.cat([out["cvecs"], scales["w_res"], scales["w_skip"]], dim=1)
    return out


def dequant_stack(st: dict) -> dict:
    """int8 weight-stream stack -> float stack: ``int8 * scale`` in float32,
    one rounding, exactly what the kernel forms on its operand loads."""
    vecs, cvecs = st["vecs"], st["cvecs"]
    return {
        "w_in": st["w_in"].float() * vecs[:, 8][:, None, :],
        "w_dw": st["w_dw"].float() * vecs[:, 9][:, None, :],
        "w_res": st["w_res"].float() * cvecs[:, 2][:, None, :],
        "w_skip": st["w_skip"].float() * cvecs[:, 3][:, None, :],
        "vecs": vecs[:, :8].contiguous(), "cvecs": cvecs[:, :2].contiguous(),
    }


def tcn_masker_reference(x: torch.Tensor, f_len: torch.Tensor, st: dict, *,
                         n_per_repeat: int) -> torch.Tensor:
    """Plain twin: [B, F, C] + [B] valid-frame counts -> [B, F, C] skip sum.
    An int8 stack is dequantised up front (weight-only quantisation: the
    rest is the float path)."""
    if st["w_in"].dtype == torch.int8:
        st = dequant_stack(st)
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
    block weights (float32, or the int8 stream of
    ``stack_tcn_params(weight_quant=True)``) -> [B, F, C] f32 skip sum.

    Contract, the same on both devices: rows f < f_len[b] are the dense TCN
    loop's skip sum; rows f >= f_len[b] are exactly 0. (The JAX kernel fills
    them with values no caller reads: Conv-TasNet zeroes padded frames after
    the mask conv. No valid row depends on a padded one.) CPU tensors run
    the plain twin and zero its padded rows; CUDA tensors launch the kernel
    of the stack's weight type (counted in ``launches`` / ``launches_s8``),
    which computes no row past f_len."""
    wq = st["w_in"].dtype == torch.int8
    b, f, c = x.shape
    nb, _, hd = st["w_in"].shape
    wt = torch.int8 if wq else torch.float32
    vrows, crows = (10, 4) if wq else (8, 2)
    shapes = {"w_in": (wt, (nb, c, hd)), "w_dw": (wt, (nb, 3, hd)), "w_res": (wt, (nb, hd, c)),
              "w_skip": (wt, (nb, hd, c)), "vecs": (torch.float32, (nb, vrows, hd)),
              "cvecs": (torch.float32, (nb, crows, c))}
    for name, (dtype, shape) in shapes.items():
        t = st[name]
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"fused_tcn_masker: {name} must be {dtype} {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"fused_tcn_masker: x must be float32, got {x.dtype}")
    if tuple(f_len.shape) != (b,):
        raise ValueError(f"fused_tcn_masker: f_len must be [{b}], got {tuple(f_len.shape)}")
    if x.device.type == "cpu":
        out = tcn_masker_reference(x, f_len, st, n_per_repeat=n_per_repeat)
        valid = torch.arange(f)[None, :] < f_len.to(torch.int64)[:, None]
        return torch.where(valid[..., None], out, torch.zeros((), dtype=out.dtype))
    if not x.is_cuda:
        raise ValueError(f"fused_tcn_masker: unsupported device {x.device}")
    if c % 32 or hd % 64 or 1024 % hd:
        raise ValueError(f"fused_tcn_masker: needs C % 32 == 0, H % 64 == 0 and H dividing "
                         f"1024, got C={c}, H={hd}")
    x = x.contiguous()
    fl = f_len.to(device=x.device, dtype=torch.int32).clamp(0, f).contiguous()
    w_rs = torch.cat([st["w_res"], st["w_skip"]], dim=-1).contiguous()
    weights = [st[k].contiguous() for k in ("w_in", "w_dw", "vecs")]
    cvecs = st["cvecs"].contiguous()
    xs, skips = torch.empty_like(x), torch.empty_like(x)
    h1, h2 = (torch.empty((b, f, hd), dtype=torch.float32, device=x.device) for _ in range(2))
    stats = torch.empty((nb, b, 4), dtype=torch.float32, device=x.device)
    # room for one gLN partial per block of an item: GEMM blocks of 128 rows
    # x 64 or 128 columns, depthwise blocks of 4096 / H rows
    n_part = 2 * -(-f // 128) * (hd // 64)
    part = torch.empty((b, n_part, 3), dtype=torch.float32, device=x.device)
    tickets = torch.empty((b,), dtype=torch.int32, device=x.device)
    name = "act_tcn_masker_s8" if wq else "act_tcn_masker"
    fn = _build.kernel(name, [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    if wq:
        fused_tcn_masker.launches_s8 += 1
    else:
        fused_tcn_masker.launches += 1
    _build.check(name, fn(
        x.data_ptr(), fl.data_ptr(), weights[0].data_ptr(), weights[1].data_ptr(),
        weights[2].data_ptr(), w_rs.data_ptr(), cvecs.data_ptr(), xs.data_ptr(), h1.data_ptr(),
        h2.data_ptr(), stats.data_ptr(), part.data_ptr(), tickets.data_ptr(), skips.data_ptr(),
        b, f, c, hd, nb, n_per_repeat, n_part, torch.cuda.current_stream(x.device).cuda_stream))
    return skips


# kernel launches, counted where they happen: the float entry point and the
# int8 weight stream's
fused_tcn_masker.launches = 0
fused_tcn_masker.launches_s8 = 0
