"""SenseVoice's block chain replayed as CUDA graphs (models/block_graphs.py)
against the same encoder run op by op, on the card.

CUDA graphs have no CPU mode: without a CUDA device every test here skips.
On the GPU machine run them with

    python -m pytest tests/test_torch_sensevoice_graphs_cuda.py -q --noconftest

The op-by-op reference is the encoder itself with gradients on and its
parameters frozen: ``eager_reason`` keeps the chain off the graphs, and
nothing is recorded for autograd.
"""
import sys
import threading

import pytest
import torch

from audio_classification_tpu_torch.engine.runtime import _cast_copy, seeded_init_
from audio_classification_tpu_torch.models.asr.ctc import ctc_greedy_decode
from audio_classification_tpu_torch.models.asr.sensevoice import (SenseVoiceConfig,
                                                                  SenseVoiceEncoder)
from audio_classification_tpu_torch.models.common import lengths_to_mask
from audio_classification_tpu_torch.ops.kernels.attention import flash_attention
from audio_classification_tpu_torch.ops.work import WorkCount
from audio_classification_tpu_torch.utils import profiling

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda

#: SenseVoiceSmall's widths (perfbench/configs/tse3-convtasnet.json)
SMALL = SenseVoiceConfig(vocab_size=25055, dim=512, heads=4, layers=70, ffn_mult=4,
                         conv_kernel=11)
#: the largest logit difference the benchmark's cells allow a recognizer
#: call, over the call's largest logit (perfbench/limits/mf2-overlap.json,
#: the tightest of the three)
LOGITS_LIMIT = 1.2e-4


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _encoder(dev, cfg: SenseVoiceConfig = SMALL, seed: int = 0) -> SenseVoiceEncoder:
    enc = SenseVoiceEncoder(cfg)
    seeded_init_(enc, torch.Generator().manual_seed(seed))
    return enc.to(dev).eval().requires_grad_(False)


@pytest.fixture(scope="module")
def small(dev):
    return _encoder(dev)


def _feats(dev, cfg, b: int, t: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    feats = torch.randn(b, t, cfg.lfr_m * cfg.num_mel, generator=gen)
    lengths = torch.tensor([t] + [max(1, t - 37 * i) for i in range(1, b)])
    return feats.to(dev), lengths_to_mask(lengths, t).to(dev)


def _eager(enc, feats, mask):
    with torch.enable_grad():
        return enc(feats, mask)


def _graphed(enc, feats, mask):
    with torch.inference_mode():
        return enc(feats, mask)


def _captured(enc, feats, mask):
    """Two calls: the key's first runs op by op, its second captures."""
    _graphed(enc, feats, mask)
    _graphed(enc, feats, mask)


def _counters(enc, feats, mask) -> tuple:
    """The graphed call's logits and the counters it noted on its span."""
    profiling.enable()
    try:
        with profiling.span("engine.asr"):
            out = _graphed(enc, feats, mask)
        attrs = [r for r in profiling.spans() if r.name == "engine.asr"][-1].attrs
    finally:
        profiling.disable()
        profiling.clear()
    return out, attrs


def _same_or_within_limit(got, want, mask, prompt):
    """Equal bits; where a library picks another algorithm under capture,
    the largest difference (reported) within the cells' logits limit and the
    same greedy ids."""
    if torch.equal(got, want):
        return
    rel = ((got - want).abs().max() / want.abs().max()).item()
    print(f"graphed vs eager logits: max difference {rel:.3e} of the largest logit")
    assert rel <= LOGITS_LIMIT
    for a, b in zip(ctc_greedy_decode(got[:, prompt:].float(), mask, 0),
                    ctc_greedy_decode(want[:, prompt:].float(), mask, 0)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("b, t, segments", [(1, 138, 1), (8, 271, 1), (8, 537, 71)],
                         ids=["enrollment", "overlap", "clean_k3"])
def test_replay_equals_the_eager_encoder_at_the_benchmark_shapes(dev, small, b, t, segments):
    """The three shapes of the benchmark's SenseVoice calls (T + 4 prompt
    frames: 142 and 275 in one graph, 541 cut at 70 K3 calls): a key's first
    call runs op by op, its second captures, its third replays, each giving
    the eager logits and noting so; K3 still launches 70 times a replay at
    541."""
    feats, mask = _feats(dev, SMALL, b, t, seed=t)
    want = _eager(small, feats, mask)
    first, noted_first = _counters(small, feats, mask)
    second, noted_second = _counters(small, feats, mask)
    launches = flash_attention.launches
    third, noted = _counters(small, feats, mask)
    torch.cuda.synchronize()
    assert noted_first == {"graph_replays": 0, "graph_captures": 0, "eager_blocks": 70}
    assert noted_second == {"graph_replays": segments, "graph_captures": segments,
                            "eager_blocks": 70}
    assert noted == {"graph_replays": segments, "graph_captures": 0, "eager_blocks": 0}
    assert flash_attention.launches - launches == (70 if segments > 1 else 0)
    for got in (first, second, third):
        _same_or_within_limit(got, want, mask, SMALL.num_prompt)


def test_a_counted_first_call_lets_the_next_call_capture(dev, small):
    """An engine program's first call runs under a work count, op by op:
    the key's next call captures (the benchmark's second warm job)."""
    feats, mask = _feats(dev, SMALL, 2, 138, seed=31)
    with torch.inference_mode(), WorkCount():
        small(feats, mask)
    _out, noted = _counters(small, feats, mask)
    assert noted == {"graph_replays": 1, "graph_captures": 1, "eager_blocks": 70}


def test_weights_written_between_calls_keep_the_calls_op_by_op(dev):
    """A trainer's evaluations: the weights change between two calls of a
    key, so neither captures (the second is a first call again)."""
    cfg = SenseVoiceConfig(vocab_size=512, dim=512, heads=4, layers=6, ffn_mult=4,
                           conv_kernel=11)
    enc = _encoder(dev, cfg, seed=6)
    feats, mask = _feats(dev, cfg, 2, 537, seed=7)
    for _ in range(3):
        out, noted = _counters(enc, feats, mask)
        assert noted == {"graph_replays": 0, "graph_captures": 0, "eager_blocks": 6}
        _same_or_within_limit(out, _eager(enc, feats, mask), mask, cfg.num_prompt)
        with torch.no_grad():
            enc.block_2.Dense_0.weight.mul_(0.99)
    assert enc._graphs.keys() == []


def test_two_calls_of_one_key_before_either_is_read_keep_their_own_logits(dev, small):
    """Two replays queued back to back: the second does not overwrite the
    first's logits (they are new tensors, not the graphs' output)."""
    fa, ma = _feats(dev, SMALL, 8, 271, seed=1)
    fb, mb = _feats(dev, SMALL, 8, 271, seed=2)
    _captured(small, fa, ma)
    a = _graphed(small, fa, ma)
    b = _graphed(small, fb, mb)
    torch.cuda.synchronize()
    _same_or_within_limit(a, _eager(small, fa, ma), ma, SMALL.num_prompt)
    _same_or_within_limit(b, _eager(small, fb, mb), mb, SMALL.num_prompt)
    assert not torch.equal(a, b)


def test_callers_on_two_streams_each_get_their_own_logits(dev, small):
    """A replay on another stream than the last one's waits for the last
    caller's reads before it writes the graphs' inputs."""
    fa, ma = _feats(dev, SMALL, 8, 271, seed=21)
    fb, mb = _feats(dev, SMALL, 8, 271, seed=22)
    _captured(small, fa, ma)
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(streams[0]):
        a = _graphed(small, fa, ma)
    with torch.cuda.stream(streams[1]):
        b = _graphed(small, fb, mb)
    torch.cuda.synchronize()
    _same_or_within_limit(a, _eager(small, fa, ma), ma, SMALL.num_prompt)
    _same_or_within_limit(b, _eager(small, fb, mb), mb, SMALL.num_prompt)


def test_the_forward_hooks_output_survives_later_replays(dev, small):
    """The benchmark keeps each call's hook output, without a copy, until
    its window closes: later replays of the key leave it as it was."""
    kept = []
    handle = small.register_forward_hook(lambda _m, args, out: kept.append(out))
    try:
        inputs = [_feats(dev, SMALL, 8, 537, seed=s) for s in (11, 12, 13)]
        for feats, mask in inputs:
            _graphed(small, feats, mask)
    finally:
        handle.remove()
    torch.cuda.synchronize()
    for out, (feats, mask) in zip(kept, inputs):
        _same_or_within_limit(out, _eager(small, feats, mask), mask, SMALL.num_prompt)


@pytest.mark.parametrize("t", [138, 537])
def test_a_weight_load_after_capture_is_seen(dev, t):
    """``load_state_dict`` after a key was captured: the next call gives
    the new weights' logits (graphs captured again on the write), and
    moving the encoder off the card and back does too."""
    cfg = SenseVoiceConfig(vocab_size=512, dim=512, heads=4, layers=6, ffn_mult=4,
                           conv_kernel=11)
    enc = _encoder(dev, cfg, seed=1)
    feats, mask = _feats(dev, cfg, 2, t, seed=5)
    _captured(enc, feats, mask)
    for change in (lambda: enc.load_state_dict(_encoder(dev, cfg, seed=2).state_dict()),
                   lambda: enc.cpu().to(dev)):
        change()
        want = _eager(enc, feats, mask)
        for _ in range(3):  # op by op, captured, replayed
            _same_or_within_limit(_graphed(enc, feats, mask), want, mask, cfg.num_prompt)
        assert len(enc._graphs.keys()) == 1


def test_a_reduced_precision_copy_replays_its_own_graphs(dev):
    """The bf16 engine's copy (``_cast_copy``): float32 activations meet its
    bfloat16 weights through kept casts; its graphs give its eager logits."""
    cfg = SenseVoiceConfig(vocab_size=512, dim=512, heads=4, layers=6, ffn_mult=4,
                           conv_kernel=11)
    enc = _cast_copy(_encoder(dev, cfg, seed=3), torch.bfloat16)
    for t in (138, 537):
        feats, mask = _feats(dev, cfg, 2, t, seed=t)
        want = _eager(enc, feats.bfloat16(), mask)
        _captured(enc, feats.bfloat16(), mask)
        _same_or_within_limit(_graphed(enc, feats.bfloat16(), mask), want, mask,
                              cfg.num_prompt)
    assert len(enc._graphs.keys()) == 2


def test_host_threads_sharing_an_encoder_each_get_their_eager_logits(dev):
    """Six threads (more than the host's cores on the card machine's share),
    one shape, their own inputs, eight calls each, the interpreter switching
    every 10 us: every result is its eager one."""
    cfg = SenseVoiceConfig(vocab_size=512, dim=512, heads=4, layers=6, ffn_mult=4,
                           conv_kernel=11)
    enc = _encoder(dev, cfg, seed=4)
    inputs = [_feats(dev, cfg, 2, 271, seed=100 + i) for i in range(6)]
    wants = [_eager(enc, f, m) for f, m in inputs]
    results = [[] for _ in inputs]
    errors = []

    def worker(i):
        try:
            for _ in range(8):
                results[i].append(_graphed(enc, *inputs[i]))
        except Exception as exc:  # reported below
            errors.append(exc)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(inputs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads) and errors == []
    torch.cuda.synchronize()
    for got, want, (_f, mask) in zip(results, wants, inputs):
        assert len(got) == 8
        for out in got:
            _same_or_within_limit(out, want, mask, cfg.num_prompt)
    assert len(enc._graphs.keys()) == 1
