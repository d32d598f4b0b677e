"""The block chain's split for CUDA graphs (models/block_graphs.py,
models/common.TransformerBlock ``head`` / ``tail``), on the CPU.

What runs here: ``head`` and ``tail`` around the attention core are the
block, bit for bit, for every model that stacks TransformerBlocks; the cut
plan (one segment below ``FLASH_MIN_T``, one more than the blocks from it on,
K3 entered through ``common.flash_attention`` as looked up at each call);
when a chain runs op by op, and the counters that say so; what drops a
chain's graphs. The graphs themselves run only on a card:
tests/test_torch_sensevoice_graphs_cuda.py.
"""
import copy
from typing import Optional

import pytest
import torch
import torch.nn.functional as F

from audio_classification_tpu_torch.engine.runtime import seeded_init_
from audio_classification_tpu_torch.models import block_graphs, common
from audio_classification_tpu_torch.models.asr.paraformer import Paraformer, ParaformerConfig
from audio_classification_tpu_torch.models.asr.sensevoice import (SenseVoiceConfig,
                                                                  SenseVoiceEncoder)
from audio_classification_tpu_torch.models.asr.transducer import Transducer, TransducerConfig
from audio_classification_tpu_torch.models.osd import OSDConfig, OSDNet
from audio_classification_tpu_torch.ops import work
from audio_classification_tpu_torch.ops.kernels.attention import FLASH_MIN_T, attention_reference
from audio_classification_tpu_torch.parallel.mesh import make_mesh
from audio_classification_tpu_torch.utils import profiling

torch.set_num_threads(2)
DIM, HEADS = 16, 2


def _init(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded weights, with biases and norm shifts off zero so that every
    term of a block shows."""
    seeded_init_(model, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model.eval()


# every model that stacks TransformerBlocks, by its first block
USERS = {
    "sensevoice": lambda: SenseVoiceEncoder(SenseVoiceConfig(
        vocab_size=11, dim=DIM, heads=HEADS, layers=1, ffn_mult=2)).block_0,
    "osdnet": lambda: OSDNet(OSDConfig(dim=DIM, heads=HEADS, layers=1)).block_0,
    "paraformer_encoder": lambda: Paraformer(ParaformerConfig(
        vocab_size=11, dim=DIM, heads=HEADS, enc_layers=1, dec_layers=1, ffn_mult=2)).enc_0,
    "paraformer_decoder": lambda: Paraformer(ParaformerConfig(
        vocab_size=11, dim=DIM, heads=HEADS, enc_layers=1, dec_layers=1, ffn_mult=2)).dec_0,
    "transducer": lambda: Transducer(TransducerConfig(
        vocab_size=11, dim=DIM, heads=HEADS, layers=1, ffn_mult=2, pred_dim=DIM,
        joiner_dim=DIM)).encoder.block_0,
}


def _frozen_forward(blk, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The block as it was written before ``head`` / ``tail`` (no mesh): the
    ops, in their order, that every user of the block was held to."""
    mhsa = blk.MultiHeadSelfAttention_0
    h = blk.LayerNorm_0(x)
    b, t, _ = h.shape
    d_head = mhsa.dim // mhsa.heads
    q, k, v = (z.reshape(b, t, mhsa.heads, d_head).transpose(1, 2)
               for z in mhsa.qkv(h, mask).split(mhsa.dim, dim=-1))
    attend = common.flash_attention if t >= FLASH_MIN_T else attention_reference
    out = attend(q, k, v, mask)
    x = x + mhsa.out(out.transpose(1, 2).reshape(b, t, mhsa.dim), mask)
    ffn_ln = blk.LayerNorm_1
    if blk.dwconv is not None:
        h = blk.LayerNorm_1(x)
        if mask is not None:
            h = h * mask[..., None]
        x = x + F.silu(blk.dwconv(h))
        ffn_ln = blk.LayerNorm_2
    x = x + blk.Dense_1(common.gelu(blk.Dense_0(ffn_ln(x), mask)), mask)
    if mask is not None:
        x = x * mask[..., None]
    return x


def _inputs(b: int, t: int, seed: int, masked: bool):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, DIM, generator=gen)
    if not masked:
        return x, None
    lengths = torch.tensor([t, max(1, t // 3)] + [t // 2] * (b - 2))[:b]
    return x, common.lengths_to_mask(lengths, t)


@pytest.mark.parametrize("t", [37, FLASH_MIN_T + 5], ids=["dense_core", "k3_core"])
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("user", sorted(USERS))
def test_head_and_tail_around_the_core_are_the_block_bit_for_bit(user, masked, t):
    """``tail(x, core(*head(x)))`` = ``forward`` = the block as written
    before the split, for every model that stacks it, with and without a
    mask, below and from ``FLASH_MIN_T`` frames (K3's CPU twin there)."""
    blk = _init(USERS[user](), seed=len(user))
    x, mask = _inputs(2, t, seed=t, masked=masked)
    with torch.no_grad():
        split = blk.tail(x, blk.MultiHeadSelfAttention_0.core(*blk.head(x, mask), mask), mask)
        whole = blk(x, mask)
        frozen = _frozen_forward(blk, x, mask)
    assert torch.equal(split, whole) and torch.equal(whole, frozen)


def _stack(n: int, seed: int = 0) -> list:
    enc = _init(SenseVoiceEncoder(SenseVoiceConfig(vocab_size=11, dim=DIM, heads=HEADS,
                                                   layers=n, ffn_mult=2, conv_kernel=3)), seed)
    return [getattr(enc, f"block_{i}") for i in range(n)]


@pytest.mark.parametrize("t, n_segments, k3_calls", [
    (FLASH_MIN_T - 1, 1, 0), (FLASH_MIN_T, 71, 70)], ids=["below", "from"])
def test_cut_plan_is_one_segment_below_flash_min_t_and_cut_at_every_k3_call_from_it(
        monkeypatch, t, n_segments, k3_calls):
    """SenseVoice's 70 blocks: one segment below ``FLASH_MIN_T``; from it on
    71 segments around 70 K3 calls, each through ``common.flash_attention``
    as looked up when called (a stand-in put there afterwards is entered 70
    times); the segments op by op are the block loop, bit for bit."""
    blocks = _stack(70)
    segs = block_graphs.segments(blocks, t)
    entered = []

    def stand_in(q, k, v, kv_mask=None):
        entered.append(tuple(q.shape))
        return attention_reference(q, k, v, kv_mask)

    monkeypatch.setattr(common, "flash_attention", stand_in)
    x, mask = _inputs(1, t, seed=3, masked=True)
    with torch.no_grad():
        chained, attn = block_graphs.run_segments(blocks, segs, x, mask)
        assert len(segs) == n_segments and len(entered) == k3_calls
        loop = x
        for blk in blocks:
            loop = blk(loop, mask)
    assert len(entered) == 2 * k3_calls
    assert set(entered) <= {(1, HEADS, t, DIM // HEADS)}
    assert torch.equal(chained, loop)
    assert (attn is None) == (k3_calls == 0)


class _Mesh:
    """Stands for a mesh: ``eager_reason`` only asks whether there is one."""


@pytest.mark.parametrize("device, mesh, quant, mode, reason", [
    ("cpu", None, "none", "inference", "device"),
    ("cuda", _Mesh(), "none", "inference", "mesh"),
    ("cuda", None, "int8", "inference", "quant"),
    ("cuda", None, "none", "grad", "grad"),
    ("cuda", None, "none", "count", "count"),
    ("cuda", None, "none", "count_hidden", "count"),
    ("cuda", None, "none", "no_grad", None),
    ("cuda", None, "none", "inference", None),
])
def test_eager_reason_names_what_keeps_a_chain_op_by_op(device, mesh, quant, mode, reason):
    """Graphs only on CUDA, without a mesh, at quant "none", with gradients
    off and no work count open on the thread (inside a region hidden from
    it too: a program's first call, whole)."""
    if mode == "grad":
        with torch.enable_grad():
            got = block_graphs.eager_reason(device, mesh, quant)
    elif mode.startswith("count"):
        with torch.no_grad(), work.WorkCount():
            if mode == "count_hidden":
                with work.uncounted():
                    got = block_graphs.eager_reason(device, mesh, quant)
            else:
                got = block_graphs.eager_reason(device, mesh, quant)
    elif mode == "no_grad":
        with torch.no_grad():
            got = block_graphs.eager_reason(device, mesh, quant)
    else:
        with torch.inference_mode():
            got = block_graphs.eager_reason(device, mesh, quant)
    assert got == reason


def _encoder(quant: str = "none", layers: int = 3) -> SenseVoiceEncoder:
    return _init(SenseVoiceEncoder(SenseVoiceConfig(
        vocab_size=11, dim=DIM, heads=HEADS, layers=layers, ffn_mult=2, conv_kernel=3,
        quant=quant)), seed=7)


@pytest.mark.parametrize("case", ["cpu", "mesh", "grad", "int8", "count"])
def test_sensevoice_on_the_eager_paths_counts_eager_blocks_and_no_graph(case):
    """The CPU, a mesh, gradients, int8 blocks and an open work count run
    the encoder's blocks op by op: the innermost span reads 0 replays, 0
    captures and every block eager, and nothing is captured."""
    enc = _encoder("int8" if case == "int8" else "none")
    gen = torch.Generator().manual_seed(1)
    feats = torch.randn(2, 12, enc.cfg.lfr_m * enc.cfg.num_mel, generator=gen)
    mask = common.lengths_to_mask(torch.tensor([12, 5]), 12)
    kwargs = {"mesh": make_mesh(2, devices=["cpu"] * 2)} if case == "mesh" else {}
    profiling.enable()
    try:
        with profiling.span("engine.asr"):
            if case == "grad":
                with torch.enable_grad():
                    enc(feats, mask, **kwargs)
            elif case == "count":
                with torch.inference_mode(), work.WorkCount():
                    enc(feats, mask, **kwargs)
            else:
                with torch.inference_mode():
                    enc(feats, mask, **kwargs)
        rec = [r for r in profiling.spans() if r.name == "engine.asr"][-1]
    finally:
        profiling.disable()
        profiling.clear()
    assert rec.attrs == {"graph_replays": 0, "graph_captures": 0, "eager_blocks": 3}
    assert enc._graphs.keys() == []


def test_a_copy_of_the_encoder_starts_without_graphs_and_keys_its_work_alike():
    """``copy.deepcopy`` (the engine's reduced-precision copy) gives the
    copy a store of its own, empty; the store takes no part in the work
    count's module key (ops/work)."""
    enc = _encoder()
    enc._graphs._failed.add(("a key",))
    twin = copy.deepcopy(enc)
    assert isinstance(twin._graphs, block_graphs.StackGraphs)
    assert twin._graphs is not enc._graphs and twin._graphs._failed == set()
    assert work._module_key(twin) == work._module_key(enc)


@pytest.mark.parametrize("change, current", [
    ("none", True),
    ("data", False),         # a parameter's storage replaced (``.data =``, ``.to()``)
    ("replace", False),      # a new Parameter set on the module
    ("write", False),        # an in-place write (its cast copies are kept constants)
])
def test_weights_snapshot_sees_replaced_and_written_parameters(change, current):
    """What drops a chain's graphs: a parameter replaced, its storage
    swapped or a write in place; nothing else."""
    blocks = _stack(4)
    snap = block_graphs._Weights(blocks)
    w = blocks[2].MultiHeadSelfAttention_0.qkv
    if change == "data":
        w.weight.data = w.weight.data.clone()
    elif change == "replace":
        w.weight = torch.nn.Parameter(w.weight.detach().clone())
    elif change == "write":
        with torch.no_grad():
            blocks[1].LayerNorm_0.bias.add_(0.0)
    assert snap.current() is current
