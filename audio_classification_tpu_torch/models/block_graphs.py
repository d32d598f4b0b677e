"""A chain of TransformerBlocks (models/common.py) replayed as CUDA graphs,
one set a shape, cut only where the attention core is kernel K3.

Eagerly, a block enqueues some twenty device operations (norms, the
projections, the dense attention core, the conv branch, the FFN, masks), and
the host enqueues each: SenseVoice's 70 blocks are about 1,600 launches a
call, which the host takes longer to enqueue than the card to run. Replayed,
a chain is one launch a graph:

- below ``FLASH_MIN_T`` frames the attention core is plain PyTorch, and one
  graph covers every block;
- from ``FLASH_MIN_T`` frames on, each block's core is K3, called from
  Python as the eager block calls it (``common.flash_attention``, looked up
  at the call: a caller may wrap it), so the chain is cut there (``segments``):
  graph 0 is block 0's ``head``, graph i block i-1's ``tail`` and block i's
  ``head``, the last graph the last block's ``tail``. n blocks replay as n + 1
  graphs, n K3 calls on the graphs' own q, k, v, and n copies of K3's output
  into the static input the next graph reads.

``StackGraphs`` keeps the graphs of one encoder, by key: the input's shape,
dtype and device, whether a mask is given, inference mode. A key is captured
at its second call on the card with the same weights, the first call that
may capture (``eager_reason``) after one that ran op by op: an engine's
program runs its first call counted, and its second captures; a trainer's
evaluations, between which the weights change, stay op by op. A capture is
a pass of the chain op by op on the capture stream first (it makes the
streams' library handles and workspaces, the blocks' kept constants and
K3's build), then one capture a segment, all of a key's graphs in one memory
pool, in replay order. A graph's output that a later graph has consumed
goes back to the pool; the q, k, v that K3 reads stay. If a capture raises,
its key runs op by op for the encoder's life. A replay holds the encoder's
lock from the copy of its inputs to the read of its last output
(``finish``), so host threads that share an engine take turns. Graphs hold
the addresses of the blocks' parameters: the keys are dropped, and the
calls seen forgotten, when one is replaced or written in place (by its data
pointer and version).

Each call notes ``graph_replays``, ``graph_captures`` and ``eager_blocks`` on
the innermost open span of the tracer (utils/profiling.py).
"""
from __future__ import annotations

import operator
import threading
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..ops.kernels.attention import FLASH_MIN_T
from ..ops.work import counting
from ..utils.profiling import note

#: segment(x, attn, mask) -> (x, (q, k, v) for the next K3 call or None)
Segment = Callable[..., tuple]


def segments(blocks: Sequence[torch.nn.Module], t: int) -> List[Segment]:
    """The chain of ``blocks`` at ``t`` frames as segments between its K3
    calls: one below ``FLASH_MIN_T`` (each block whole), else
    ``len(blocks) + 1``."""
    if t < FLASH_MIN_T:
        def whole(x, attn, mask):
            for blk in blocks:
                x = blk(x, mask)
            return x, None
        return [whole]

    def first(x, attn, mask):
        return x, blocks[0].head(x, mask)

    def link(done, nxt):
        def seg(x, attn, mask):
            x = done.tail(x, attn, mask)
            return x, nxt.head(x, mask)
        return seg

    def last(x, attn, mask):
        return blocks[-1].tail(x, attn, mask), None

    return [first, *(link(a, b) for a, b in zip(blocks, blocks[1:])), last]


def run_segments(blocks: Sequence[torch.nn.Module], segs: Sequence[Segment],
                 x: torch.Tensor, mask: Optional[torch.Tensor]) -> tuple:
    """The segments op by op, block i's attention core between segments i
    and i + 1 -> (the block loop's result, bit for bit; the last core's
    output, None where the chain is one segment)."""
    x, qkv = segs[0](x, None, mask)
    attn = None
    for blk, seg in zip(blocks, segs[1:]):
        attn = blk.MultiHeadSelfAttention_0.core(*qkv, mask)
        x, qkv = seg(x, attn, mask)
    return x, attn


def eager_reason(device_type: str, mesh, quant: str) -> Optional[str]:
    """Why a chain runs op by op, or None where it may replay graphs: only on
    CUDA, without a mesh (ring attention), for float blocks (an int8 block
    scales its activations per call), with gradients off, and outside a work
    count (ops/work: a program's first call is counted op by op)."""
    if device_type != "cuda":
        return "device"
    if mesh is not None:
        return "mesh"
    if quant != "none":
        return "quant"
    if torch.is_grad_enabled():
        return "grad"
    if counting():
        return "count"
    return None


_version = operator.attrgetter("_version")


class _Weights:
    """The blocks' parameters and buffers as their graphs read them: the
    tensor in each slot, its address and its writes (versions only grow, so
    their sum moves with any write). ``current()`` costs three passes over
    the tensors, not a walk of the modules."""

    def __init__(self, blocks: Sequence[torch.nn.Module]):
        slots = [(d, n) for blk in blocks for m in blk.modules()
                 for d in (m._parameters, m._buffers) for n, t in d.items() if t is not None]
        self._dicts = [d for d, _ in slots]
        self._names = [n for _, n in slots]
        self._tensors = list(map(dict.__getitem__, self._dicts, self._names))
        self._ptrs = list(map(torch.Tensor.data_ptr, self._tensors))
        # an inference tensor counts no versions (nor takes writes outside
        # inference mode)
        self._versioned = [t for t in self._tensors if not t.is_inference()]
        self._writes = sum(map(_version, self._versioned))

    def current(self) -> bool:
        """Whether every slot holds the same tensor, at the same address,
        unwritten since."""
        return (all(map(operator.is_, map(dict.__getitem__, self._dicts, self._names),
                        self._tensors))
                and list(map(torch.Tensor.data_ptr, self._tensors)) == self._ptrs
                and sum(map(_version, self._versioned)) == self._writes)


class _Chain:
    """One key's graphs and static tensors."""

    __slots__ = ("graphs", "x_in", "mask_in", "attn", "qkvs", "x_out", "done", "stream")

    def __init__(self, graphs, x_in, mask_in, attn, qkvs, x_out):
        self.graphs, self.x_in, self.mask_in = graphs, x_in, mask_in
        self.attn, self.qkvs, self.x_out = attn, qkvs, x_out
        self.done = torch.cuda.Event()
        self.stream = None


class StackGraphs:
    """The CUDA graphs of one encoder's block chain (module docstring). A
    copy of the encoder starts with none."""

    def __init__(self):
        self._lock = threading.Lock()
        self._chains: Dict[tuple, _Chain] = {}
        self._seen: set = set()
        self._failed: set = set()
        self._weights: Optional[_Weights] = None
        self._stream = None

    def __deepcopy__(self, memo) -> "StackGraphs":
        return StackGraphs()

    def keys(self) -> List[tuple]:
        """The keys captured (and current)."""
        with self._lock:
            return list(self._chains)

    @staticmethod
    def _key(x: torch.Tensor, mask: Optional[torch.Tensor]) -> tuple:
        return (tuple(x.shape), x.dtype, x.device, mask is not None,
                torch.is_inference_mode_enabled())

    def _check_weights(self, blocks) -> None:
        if self._weights is None or not self._weights.current():
            self._chains.clear()
            self._seen.clear()
            self._weights = _Weights(blocks)

    def saw(self, blocks: Sequence[torch.nn.Module], x: torch.Tensor,
            mask: Optional[torch.Tensor]) -> None:
        """Record a call of the chain that ran op by op on the card under a
        work count (a program's first call): the key's next call captures."""
        with self._lock:
            self._check_weights(blocks)
            self._seen.add(self._key(x, mask))

    def run(self, blocks: Sequence[torch.nn.Module], x: torch.Tensor,
            mask: Optional[torch.Tensor], finish: Callable[[torch.Tensor], torch.Tensor]):
        """``finish`` of the chain's output on ``x`` (a CUDA tensor, under
        the conditions of ``eager_reason``): replayed; captured first where
        the key was seen before with these weights; op by op where it was
        not, or its capture failed."""
        key = self._key(x, mask)
        with self._lock:
            self._check_weights(blocks)
            chain = self._chains.get(key)
            captured = 0
            if chain is None and key in self._seen and key not in self._failed:
                try:
                    chain = self._chains[key] = self._capture(blocks, x, mask)
                except Exception as exc:  # any capture fault: the key stays eager
                    self._failed.add(key)
                    warnings.warn(f"block chain at {tuple(x.shape)}: CUDA graph capture "
                                  f"failed, the shape runs op by op ({exc!r})", stacklevel=3)
                else:
                    captured = len(chain.graphs)
            if chain is None:
                self._seen.add(key)
                for blk in blocks:
                    x = blk(x, mask)
                note(graph_replays=0, graph_captures=0, eager_blocks=len(blocks))
                return finish(x)
            out = self._replay(chain, blocks, x, mask, finish)
            note(graph_replays=len(chain.graphs), graph_captures=captured,
                 eager_blocks=len(blocks) if captured else 0)
            return out

    @staticmethod
    def _replay(chain: _Chain, blocks, x, mask, finish):
        stream = torch.cuda.current_stream(x.device)
        if chain.stream is not None and chain.stream != stream:
            stream.wait_event(chain.done)  # the last caller's stream may still read
        chain.x_in.copy_(x)
        if mask is not None:
            chain.mask_in.copy_(mask)
        chain.graphs[0].replay()
        for blk, qkv, graph in zip(blocks, chain.qkvs, chain.graphs[1:]):
            # K3 on the graph's q, k, v and the caller's own mask
            chain.attn.copy_(blk.MultiHeadSelfAttention_0.core(*qkv, mask))
            graph.replay()
        out = finish(chain.x_out)
        chain.done.record(stream)
        chain.stream = stream
        return out

    def _capture(self, blocks, x, mask) -> _Chain:
        segs = segments(blocks, x.shape[1])
        x_in = x.clone()
        mask_in = None if mask is None else mask.clone()
        stream = torch.cuda.current_stream(x.device)
        if self._stream is None or self._stream.device != x.device:
            self._stream = torch.cuda.Stream(x.device)
        side = self._stream
        side.wait_stream(stream)
        try:
            with torch.cuda.stream(side):
                # the warm pass: handles, workspaces, constants, builds
                _, attn = run_segments(blocks, segs, x_in, mask_in)
            # K3's output lands here, read by the next graph
            attn = None if attn is None else torch.empty_like(
                attn, memory_format=torch.contiguous_format)
            pool = torch.cuda.graph_pool_handle()
            graphs, qkvs = [], []
            y = x_in
            with torch.cuda.stream(side):
                for seg in segs:
                    graph = torch.cuda.CUDAGraph()
                    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                    try:
                        y, qkv = seg(y, attn, mask_in)
                    finally:
                        graph.capture_end()
                    graphs.append(graph)
                    qkvs.append(qkv)
        finally:
            stream.wait_stream(side)
        return _Chain(graphs, x_in, mask_in, attn, qkvs[:-1], y)
