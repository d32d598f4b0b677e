"""K2: the whole Conv-TasNet masker (every TCN block) in one wrapper call.

Kernel: csrc/tcn_masker.cu (CUDA C++, sm_90a), replacing
audio_classification_tpu/ops/pallas/tcn_kernel.py::fused_tcn_masker, with
both of its weight streams: float32 (C entry point ``act_tcn_masker``) and
int8 with per-block, per-out-channel float32 scales (``act_tcn_masker_s8``,
"K2-s8": the kernel dequantises the int8 weights once a call, as the float
path's split copy of the stack is made; activations stay float). A split
launch (the stack transposed to K-major and split into big and small TF32
halves, ``tf32_stack`` on the host), then three launches a TCN block: the
two pointwise GEMMs on Hopper's warpgroup products (``wgmma``, 3xTF32, fed
through a TMA ring by persistent kernels that walk only the valid row
tiles; ``tf32_plan`` picks their tile shapes and grids) and the depthwise
pass, with deterministic gLN statistics; bound and design are in the
source's header. ``tcn_masker_reference`` is the plain twin, op for op the
dense TCN loop on the stacked weights (tcn_kernel.py:370-419), run on the
dequantised stack for an int8 one.

bfloat16 activations (the engine's bf16 mode) take their own entry points,
``act_tcn_masker_bf16`` and ``act_tcn_masker_s8_bf16``: Hopper's warpgroup
products (``wgmma``) fed through a TMA ring by persistent kernels that walk
only the valid row tiles, one bf16 tensor-core product where 3xTF32 takes
three, rounded where the JAX kernel rounds (tcn_kernel.py:176-309,
``dt = x_in.dtype``): the residual stream, h1, h2 and the skip sum are
bfloat16, so ``x += res`` and ``skips += skip`` round at every block. Their
twin is ``tcn_masker_reference_lowp``. ``bf16_plan`` picks their tile shapes
and grids from the bucket on the host.

Gradients: with grad enabled and an input that requires it (x, or a stack
built with grad on, which keeps its weights attached to the TCNBlocks'
parameters), the wrapper goes through ``_MaskerCore``, the counterpart of the
JAX ``custom_vjp`` (tcn_kernel.py:422-445). Its forward is the wrapper's (the
kernel on the card, counted as ever; the twin on the CPU) and saves the
inputs. Its backward recomputes the twin of x's dtype over the whole stack
under autograd and differentiates it for x and the stack's tensors, as the
JAX ``bwd`` differentiates ``tcn_masker_reference`` (at bfloat16:
``tcn_masker_reference_lowp`` with the replica's bias order, ``bias_last``);
f_len gets none, and the cotangent of the padded rows, whose output is the
constant 0, is dropped. An int8 stack's backward raises NotImplementedError,
as the JAX one does. There is no backward kernel, as there is no backward
Pallas kernel: the backward is torch code, as XLA code is outside a kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ... import _build
from ..quant import quantize_weight
from ..work import counted
from .attention import _wants_grad, tf32_split

_EPS = 1e-8  # GlobalLayerNorm eps
_DTYPES = (torch.float32, torch.bfloat16)
#: the GEMMs' tile shapes (bf16, and float32 since its wgmma design),
#: numbered as the C entry points take them: (consumer warpgroups, columns);
#: a tile has 64 rows a warpgroup, and one CTA runs on an SM at 2
#: warpgroups, two at 1
BF16_TILES = ((2, 128), (2, 64), (1, 64))
#: rows of a bf16 depthwise chunk (DR in csrc/tcn_masker.cu), by 64 channels
BF16_DW_ROWS = 128
#: the stack's tensors, in the order _MaskerCore takes them
STACK_KEYS = ("w_in", "w_dw", "w_res", "w_skip", "vecs", "cvecs")


def stack_tcn_params(blocks, dtype: torch.dtype = torch.float32,
                     weight_quant: bool = False) -> dict:
    """Per-block TCNBlock modules (repeat-major order) -> the stacked dict
    of tcn_kernel.stack_tcn_params: w_in [NB, C, H], w_dw [NB, 3, H],
    w_res / w_skip [NB, H, C] in ``dtype`` (the activations'), vecs
    [NB, 8, H] (b_in, a1, g1, be1, b_dw, a2, g2, be2) and cvecs [NB, 2, C]
    (b_res, b_skip) in float32 from the parameters as they are (a bfloat16
    copy's are bfloat16-rounded values).

    ``weight_quant``: the int8 weight stream. The four weight tensors are
    quantised symmetric per OUT channel and per BLOCK (one block's outliers
    must not flatten another block's grid) to int8, and their float32 scales
    ride in the vector bundles: vecs [NB, 10, H] rows 8, 9 (w_in, w_dw) and
    cvecs [NB, 4, C] rows 2, 3 (w_res, w_skip). The kernel dequantises to
    the activations' dtype. Inference only.

    With grad enabled the float stack stays attached to the parameters (its
    gradient reaches each TCNBlock through ``torch.stack``); without, it is
    detached."""
    h = blocks[0].in_conv.weight.shape[0]
    keep = torch.is_grad_enabled() and not weight_quant

    def cut(x):
        return x if keep else x.detach()

    def row(x):
        return cut(x).float().reshape(-1).expand(h)

    weights = {
        "w_in": torch.stack([b.in_conv.weight[:, :, 0].t() for b in blocks]),
        "w_dw": torch.stack([b.dw_conv.weight[:, 0, :].t() for b in blocks]),
        "w_res": torch.stack([b.res_conv.weight[:, :, 0].t() for b in blocks]),
        "w_skip": torch.stack([b.skip_conv.weight[:, :, 0].t() for b in blocks]),
    }
    vecs = torch.stack([torch.stack([
        row(b.in_conv.bias), row(b.prelu1.alpha), row(b.norm1.gamma), row(b.norm1.beta),
        row(b.dw_conv.bias), row(b.prelu2.alpha), row(b.norm2.gamma), row(b.norm2.beta),
    ]) for b in blocks])
    cvecs = torch.stack([torch.stack([b.res_conv.bias, b.skip_conv.bias]) for b in blocks])
    out = {k: cut(v).to(dtype).contiguous() for k, v in weights.items()}
    out["vecs"] = cut(vecs).float().contiguous()
    out["cvecs"] = cut(cvecs).float().contiguous()
    if weight_quant:
        # [NB, X, OUT] with the block axis kept apart: the absmax runs over X
        # only, which is quantising block by block
        scales = {}
        for name in ("w_in", "w_dw", "w_res", "w_skip"):
            out[name], scales[name] = quantize_weight(weights[name].detach(), channel_axis=-1,
                                                      keep_axes=(0,))
        out["vecs"] = torch.cat([out["vecs"], scales["w_in"], scales["w_dw"]], dim=1)
        out["cvecs"] = torch.cat([out["cvecs"], scales["w_res"], scales["w_skip"]], dim=1)
    return out


def dequant_stack(st: dict, dtype: torch.dtype = torch.float32) -> dict:
    """int8 weight-stream stack -> float stack: ``int8 * scale`` in float32,
    rounded once to ``dtype``, exactly what the kernel forms on its operand
    loads (in float32) or at block entry (in bfloat16; tcn_kernel.py:203-212)."""
    vecs, cvecs = st["vecs"], st["cvecs"]
    return {
        "w_in": (st["w_in"].float() * vecs[:, 8][:, None, :]).to(dtype),
        "w_dw": (st["w_dw"].float() * vecs[:, 9][:, None, :]).to(dtype),
        "w_res": (st["w_res"].float() * cvecs[:, 2][:, None, :]).to(dtype),
        "w_skip": (st["w_skip"].float() * cvecs[:, 3][:, None, :]).to(dtype),
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
        h1 = prelu(h @ st["w_in"][i] + v[0], v[1])
        h1 = gln(h1, v[2], v[3]) * mf
        h2 = F.conv1d(h1.transpose(1, 2), st["w_dw"][i].t()[:, None, :], padding=dil,
                      dilation=dil, groups=hd).transpose(1, 2)
        h2 = gln(prelu(h2 + v[4], v[5]), v[6], v[7])
        h = h + h2 @ st["w_res"][i] + st["cvecs"][i, 0]
        skips = skips + h2 @ st["w_skip"][i] + st["cvecs"][i, 1]
    return skips


def tcn_masker_reference_lowp(x: torch.Tensor, f_len: torch.Tensor, st: dict, *,
                              n_per_repeat: int, acc: torch.dtype = torch.float32,
                              bias_last: bool = False) -> torch.Tensor:
    """Plain twin of the bfloat16 entry points: [B, F, C] bf16 + [B]
    valid-frame counts -> [B, F, C] bf16 skip sum, rounded where the JAX
    kernel rounds at ``dt = bfloat16`` (tcn_kernel.py:176-309):

    1. h1 = bf16(x W_in), + b_in in bf16, PReLU in bf16;
    2. gLN-1: statistics over the valid rows of the bf16 values, the affine
       in ``acc``, rounded to bf16, then the row mask;
    3. depthwise: (left w0 + right w2) + mid w1 in ``acc``, rounded, + b_dw
       in bf16, PReLU in bf16; gLN-2 as gLN-1 (no row mask);
    4. res / skip = bf16(gLN-2 W), + the bias in bf16; x += res and
       skips += skip in bf16. With ``bias_last`` the bias comes after the
       sum instead, (x + bf16(gLN-2 W)) + b, as the JAX XLA replica
       ``tcn_masker_reference`` (tcn_kernel.py:411-416) adds it: the
       function the JAX backward differentiates, and so the port's.

    Products and statistics run in ``acc`` (float32; float64 for an oracle
    of the card's kernel fed the same inputs). An int8 stack is dequantised
    to bf16 up front. The statistics are two-pass (mean, then the centred
    sum of squares), as the card's kernel merges them."""
    dt = x.dtype
    if st["w_in"].dtype == torch.int8:
        st = dequant_stack(st, dt)
    nb, hd = st["w_in"].shape[0], st["w_in"].shape[-1]
    f = x.shape[1]
    mask = torch.arange(f, device=x.device)[None, :] < f_len.to(x.device)[:, None]
    mf = mask[..., None].to(acc)
    count = torch.clamp_min(mf.sum(dim=(1, 2), keepdim=True) * hd, 1.0)

    def gln(z, gamma, beta):
        zf = z.to(acc)
        mean = (zf * mf).sum(dim=(1, 2), keepdim=True) / count
        var = (((zf - mean) * mf) ** 2).sum(dim=(1, 2), keepdim=True) / count
        return (((zf - mean) * torch.rsqrt(var + _EPS)) * gamma.to(acc) + beta.to(acc)).to(dt)

    def prelu(z, a):
        return torch.where(z >= 0, z, a.to(dt) * z)

    def mm(a, w):
        return (a.to(acc) @ w.to(acc)).to(dt)

    h, skips = x, torch.zeros_like(x)
    for i in range(nb):
        dil = 2 ** (i % n_per_repeat)
        v, cv = st["vecs"][i], st["cvecs"][i]
        h1 = prelu(mm(h, st["w_in"][i]) + v[0].to(dt), v[1])
        h1 = (gln(h1, v[2], v[3]) * mask[..., None].to(dt)).to(acc)
        pad = F.pad(h1, (0, 0, dil, dil))
        w = st["w_dw"][i].to(acc)
        taps = (pad[:, :f] * w[0] + pad[:, 2 * dil:] * w[2]) + h1 * w[1]
        h2 = gln(prelu(taps.to(dt) + v[4].to(dt), v[5]), v[6], v[7])
        if bias_last:
            h = h + mm(h2, st["w_res"][i]) + cv[0].to(dt)
            skips = skips + mm(h2, st["w_skip"][i]) + cv[1].to(dt)
        else:
            h = h + (mm(h2, st["w_res"][i]) + cv[0].to(dt))
            skips = skips + (mm(h2, st["w_skip"][i]) + cv[1].to(dt))
    return skips


def tf32_plan(batch: int, f: int, c: int, hd: int, sms: int) -> dict:
    """The float32 entry points' launch plan: the bf16 entry points'
    (``bf16_plan``: the float32 GEMMs take the same tile shapes and the
    depthwise pass the same chunks), with ``split_per_block``, the stack's
    split copy (``tf32_stack``), floats a TCN block, in place of the bf16
    copy of an int8 stack."""
    pl = bf16_plan(batch, f, c, hd, sms)
    del pl["wdq_per_block"]
    return {**pl, "split_per_block": 2 * (c * hd + 2 * hd * c)}


def tf32_stack(st: dict) -> torch.Tensor:
    """The float32 kernels' copy of a stack, as their split launch writes it
    once a call (the plain version of ``split_kernel``): an int8 stack
    dequantised first (``dequant_stack``), then W_in transposed to
    [NB, H, C] and [W_res | W_skip] to [NB, 2 C, H] (K-major: the
    contraction index contiguous) and split (``tf32_split``); flat, in the
    order W_in big, W_in small, [W_res | W_skip] big, small."""
    if st["w_in"].dtype == torch.int8:
        st = dequant_stack(st)
    w_in = st["w_in"].transpose(1, 2)
    w_rs = torch.cat([st["w_res"], st["w_skip"]], dim=-1).transpose(1, 2)
    halves = [h for w in (w_in, w_rs) for h in tf32_split(w.float())]
    return torch.cat([h.reshape(-1) for h in halves])


def bf16_plan(batch: int, f: int, c: int, hd: int, sms: int) -> dict:
    """The bf16 entry points' launch plan for a [batch, f] bucket at widths
    (C, H) on a card of ``sms`` multiprocessors: for GEMM A (N = H) and GEMM
    C (N = 2 C), the first tile shape of ``BF16_TILES`` whose columns divide
    N and whose tiles over the whole bucket fill the card, else the one with
    the most tiles (1 x 64); its persistent grid is the tiles, at most a CTA
    a slot (2 an SM at 1 warpgroup). Only the host's shapes enter: f_len
    stays on the device, where each CTA walks the valid tiles of the grid.
    The depthwise pass walks chunks of ``BF16_DW_ROWS`` rows by 64 channels
    the same way, two CTAs an SM (``grid_dw``). ``wdq_per_block``: the int8
    stack's bf16 copy, elements a TCN block."""
    def pick(n):
        best = None
        for cfg, (nwg, bn) in enumerate(BF16_TILES):
            if n % bn:
                continue
            tiles = batch * -(-f // (64 * nwg)) * (n // bn)
            best = (cfg, max(1, min(tiles, sms * (2 if nwg == 1 else 1))))
            if tiles >= sms:
                break
        return best

    (cfg_in, grid_in), (cfg_out, grid_out) = pick(hd), pick(2 * c)
    chunks = batch * -(-f // BF16_DW_ROWS) * (hd // 64)
    return {"cfg_in": cfg_in, "grid_in": grid_in, "cfg_out": cfg_out, "grid_out": grid_out,
            "grid_dw": max(1, min(chunks, 2 * sms)),
            "wdq_per_block": c * hd + 3 * hd + 2 * hd * c}


def bf16_schedule(f_len, bm: int, n_ct: int, grid: int) -> list:
    """The tiles each CTA of a bf16 GEMM or depthwise launch computes, as
    the kernels walk them (``count_tiles`` / ``tile_at`` in csrc/tcn_masker.cu): the
    valid tiles, items in order, then row tiles of ``bm`` rows below the
    item's f_len, then the ``n_ct`` column tiles of a row tile, numbered
    t = 0, 1, ...; CTA k takes t = k, k + grid, ... -> per CTA a list of
    (item, row tile, column tile). The device reads f_len; this is the same
    order on the host, for the tests."""
    tiles = [(b, rt, ct) for b, fl in enumerate(f_len) for rt in range(-(-int(fl) // bm))
             for ct in range(n_ct)]
    return [tiles[k::grid] for k in range(grid)]


def gln_partials(f: int, hd: int) -> int:
    """Room for one gLN partial per tile of an item: GEMM A tiles of 64
    rows x 64 columns at the most, depthwise chunks of ``BF16_DW_ROWS``
    rows x 64 channels."""
    return 2 * -(-f // 128) * (hd // 64)


def _valid_rows(f_len: torch.Tensor, f: int, device) -> torch.Tensor:
    """[B, F, 1] bool: the rows below each item's valid-frame count."""
    return (torch.arange(f, device=device)[None, :]
            < f_len.to(device=device, dtype=torch.int64)[:, None])[..., None]


class _MaskerCore(torch.autograd.Function):
    """K2 under autograd: the wrapper's forward, the twin's backward over
    the whole stack (``STACK_KEYS``); none for f_len."""

    @staticmethod
    def forward(ctx, x, f_len, n_per_repeat, *stack):
        ctx.save_for_backward(x, f_len, *stack)
        ctx.n_per_repeat = n_per_repeat
        return _masker_forward(x, f_len, dict(zip(STACK_KEYS, stack)), n_per_repeat)

    @staticmethod
    def backward(ctx, g):
        x, f_len, *stack = ctx.saved_tensors
        if stack[0].dtype == torch.int8:
            raise NotImplementedError(
                "the s8 weight-stream masker is inference-only: train with "
                "quant='none' (the trainer does), then serve quantized")
        twin = (functools.partial(tcn_masker_reference_lowp, bias_last=True)
                if x.dtype == torch.bfloat16 else tcn_masker_reference)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (x, *stack)]
            out = twin(leaves[0], f_len, dict(zip(STACK_KEYS, leaves[1:])),
                       n_per_repeat=ctx.n_per_repeat)
            g = g * _valid_rows(f_len, x.shape[1], g.device).to(g.dtype)
            # a one-block stack leaves w_res unused (no block reads its residual)
            grads = [torch.zeros_like(t) if d is None else d
                     for t, d in zip(leaves, torch.autograd.grad(out, leaves, g, allow_unused=True))]
        return grads[0], None, None, *grads[1:]


def fused_tcn_masker(x: torch.Tensor, f_len: torch.Tensor, st: dict, *,
                     n_per_repeat: int) -> torch.Tensor:
    """[B, F, C] float32 or bfloat16 bottleneck stream + [B] valid-frame
    counts + stacked block weights (in x's dtype, or the int8 stream of
    ``stack_tcn_params(weight_quant=True)``; vecs and cvecs float32) ->
    [B, F, C] skip sum in x's dtype.

    Contract, the same on both devices: rows f < f_len[b] are the dense TCN
    loop's skip sum (in bfloat16 at the JAX kernel's rounding points); rows
    f >= f_len[b] are exactly 0. (The JAX kernel fills them with values no
    caller reads: Conv-TasNet zeroes padded frames after the mask conv. No
    valid row depends on a padded one.) CPU tensors run the plain twin of x's
    dtype and zero its padded rows; CUDA tensors launch the kernel of x's
    dtype and the stack's weight type (counted in ``launches`` /
    ``launches_s8`` / ``launches_bf16`` / ``launches_s8_bf16``), which
    computes no row past f_len. A bfloat16 x never runs a float32 kernel.
    Under autograd the call goes through ``_MaskerCore`` (the same forward,
    the twin's backward)."""
    if _wants_grad(x, *(st[k] for k in STACK_KEYS)):
        return _MaskerCore.apply(x, f_len, n_per_repeat, *(st[k] for k in STACK_KEYS))
    return _masker_forward(x, f_len, st, n_per_repeat)


def work(b: int, f: int, c: int, hd: int, n_blocks: int, weight_bytes: int, f_len=None,
         itemsize: int = 4) -> dict:
    """K2's work on x [b, f, c] through ``n_blocks`` TCN blocks of hidden
    width ``hd``: per block and frame the in product (C x H), the res|skip
    product (H x 2C) and the 3-tap depthwise conv, nb n (2 C H + 4 H C + 6 H)
    for n frames; bytes: the frames of x in and of the skip sum out at
    ``itemsize`` bytes, and the stack's ``weight_bytes`` (its tensors at
    their own width: one byte a weight in the int8 stream). ``f_len``: the
    valid frames of each item, which the kernel alone computes; None counts
    the padded shape, b x f."""
    n = b * f if f_len is None else sum(f_len)
    return {"flops": n_blocks * n * (2.0 * c * hd + 2.0 * hd * 2 * c + 6.0 * hd),
            "bytes": itemsize * 2.0 * n * c + weight_bytes}


def _stack_work(x, f_len, st, n_per_repeat) -> dict:
    """``work`` of one masker call: the padded shape, the stack at its width."""
    nb, c, hd = st["w_in"].shape
    return work(x.shape[0], x.shape[1], c, hd, nb,
                sum(st[k].numel() * st[k].element_size() for k in STACK_KEYS),
                itemsize=x.element_size())


@counted(_stack_work)
def _masker_forward(x, f_len, st, n_per_repeat):
    wq = st["w_in"].dtype == torch.int8
    b, f, c = x.shape
    nb, _, hd = st["w_in"].shape
    # float64 (the twin's gradcheck) on the CPU only: the kernels take neither
    if x.dtype not in _DTYPES and not (x.dtype == torch.float64 and x.device.type == "cpu"):
        raise ValueError(f"fused_tcn_masker: x must be float32 or bfloat16, got {x.dtype}")
    wt = torch.int8 if wq else x.dtype
    vt = torch.float64 if x.dtype == torch.float64 else torch.float32
    vrows, crows = (10, 4) if wq else (8, 2)
    shapes = {"w_in": (wt, (nb, c, hd)), "w_dw": (wt, (nb, 3, hd)), "w_res": (wt, (nb, hd, c)),
              "w_skip": (wt, (nb, hd, c)), "vecs": (vt, (nb, vrows, hd)),
              "cvecs": (vt, (nb, crows, c))}
    for name, (dtype, shape) in shapes.items():
        t = st[name]
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"fused_tcn_masker: {name} must be {dtype} {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if tuple(f_len.shape) != (b,):
        raise ValueError(f"fused_tcn_masker: f_len must be [{b}], got {tuple(f_len.shape)}")
    lowp = x.dtype == torch.bfloat16
    if x.device.type == "cpu":
        twin = tcn_masker_reference_lowp if lowp else tcn_masker_reference
        out = twin(x, f_len, st, n_per_repeat=n_per_repeat)
        return torch.where(_valid_rows(f_len, f, x.device), out,
                           torch.zeros((), dtype=out.dtype))
    if not x.is_cuda:
        raise ValueError(f"fused_tcn_masker: unsupported device {x.device}")
    if c % 32 or hd % 64 or 1024 % hd:
        raise ValueError(f"fused_tcn_masker: needs C % 32 == 0, H % 64 == 0 and H dividing "
                         f"1024, got C={c}, H={hd}")
    x = x.contiguous()
    fl = f_len.to(device=x.device, dtype=torch.int32).clamp(0, f).contiguous()
    weights = [st[k].contiguous() for k in ("w_in", "w_dw", "vecs")]
    cvecs = st["cvecs"].contiguous()
    xs, skips = torch.empty_like(x), torch.empty_like(x)
    h1, h2 = (torch.empty((b, f, hd), dtype=x.dtype, device=x.device) for _ in range(2))
    stats = torch.empty((nb, b, 4), dtype=torch.float32, device=x.device)
    n_part = gln_partials(f, hd)
    part = torch.empty((b, n_part, 3), dtype=torch.float32, device=x.device)
    # each launch's ticket at index B (its last CTA merges the statistics)
    tickets = torch.empty((b + 1,), dtype=torch.int32, device=x.device)
    ptrs = [x.data_ptr(), fl.data_ptr(), weights[0].data_ptr(), weights[1].data_ptr(),
            weights[2].data_ptr()]
    if lowp:
        w_rs = torch.cat([st["w_res"], st["w_skip"]], dim=-1).contiguous()
        ptrs += [w_rs.data_ptr(), cvecs.data_ptr()]
        pl = bf16_plan(b, f, c, hd, _multiprocessors(x.device))
        plan = [pl["cfg_in"], pl["grid_in"], pl["cfg_out"], pl["grid_out"], pl["grid_dw"]]
        if wq:
            # the whole stack dequantised to bfloat16 once a call
            wdq = torch.empty(nb * pl["wdq_per_block"], dtype=x.dtype, device=x.device)
            ptrs.append(wdq.data_ptr())
    else:
        w_res, w_skip = st["w_res"].contiguous(), st["w_skip"].contiguous()
        pl = tf32_plan(b, f, c, hd, _multiprocessors(x.device))
        plan = [pl["cfg_in"], pl["grid_in"], pl["cfg_out"], pl["grid_out"], pl["grid_dw"]]
        # the stack's K-major split copy, made once a call by the split launch
        wsp = torch.empty(nb * pl["split_per_block"], dtype=torch.float32, device=x.device)
        ptrs += [w_res.data_ptr(), w_skip.data_ptr(), cvecs.data_ptr(), wsp.data_ptr()]
    ptrs += [xs.data_ptr(), h1.data_ptr(), h2.data_ptr(), stats.data_ptr(), part.data_ptr(),
             tickets.data_ptr(), skips.data_ptr()]
    name = "act_tcn_masker" + ("_s8" if wq else "") + ("_bf16" if lowp else "")
    fn = _build.kernel(name, [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * (7 + len(plan))
                       + [ctypes.c_void_p])
    counter = "launches" + ("_s8" if wq else "") + ("_bf16" if lowp else "")
    setattr(fused_tcn_masker, counter, getattr(fused_tcn_masker, counter) + 1)
    _build.launch(name, fn, x.device, *ptrs, b, f, c, hd, nb, n_per_repeat, n_part, *plan)
    return skips


@functools.lru_cache(maxsize=None)
def _multiprocessors(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# kernel launches, counted where they happen: one counter an entry point
# (float32 / int8 weight stream, float32 / bfloat16 activations)
fused_tcn_masker.launches = 0
fused_tcn_masker.launches_s8 = 0
fused_tcn_masker.launches_bf16 = 0
fused_tcn_masker.launches_s8_bf16 = 0
