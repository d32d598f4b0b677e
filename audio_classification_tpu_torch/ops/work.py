"""The work of a stage program: floating-point operations and bytes, counted
by torch's formulas for its ops and by a formula of its own for each
hand-written kernel.

``WorkCount`` is a dispatch mode: while it is active on a thread, every op
dispatched there adds its operations (``torch.utils.flop_counter``'s
formulas: products of matmuls, convolutions, attention; elementwise ops
count none) and its bytes (each tensor argument read once, each new output
written once; views, and copies between devices, move nothing on the
device). Two ops that the flop counter does not know are added:
``aten._int_mm`` (2 M N K) and ``aten._cudnn_rnn`` (``rnn_work``).

A kernel's ctypes launch is invisible to the dispatcher, and on the CPU the
same entry runs its plain twin, whose dense ops would be counted instead.
So each kernel entry is decorated ``@counted(lambda ...: work(...))``:
where a count is active it adds the kernel's ``work()`` (``{"flops",
"bytes"}``) and runs the entry with the count's mode off the stack, so its
ops are neither counted nor slowed. A region whose ops differ by device is
counted the same way: the int8 GEMM (``ops/quant.int_matmul``: padded
``torch._int_mm`` on the card, a float64 GEMM on the CPU), PyanNet's LSTMs
(cuDNN's fused op on the card, the CPU's step-by-step decomposition) and
the arena gather (its rows, whatever the arena's length). A program's count
is then the same on the card and on the CPU. A host loop of like steps (a
decoder's) is counted by its first step, taken once a step, and runs its
later steps outside the count (``loop_step``). A function or module whose
work is fixed by its arguments' shapes (a frontend, a block of a stack, a
model) is counted once a key for the process and runs outside the count on
later calls of the key (``shape_keyed``). Constants made once per set of
weights are made under ``uncounted()``. With no count active each of these
costs one thread-local read.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._python_dispatch import _get_current_dispatch_mode as _current_mode
from torch.utils._python_dispatch import _pop_mode, _push_mode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten
_local = threading.local()
_NULL = contextlib.nullcontext()

#: ops that move no data: shape changes of a new tensor, uninitialised
#: allocations, a fresh tensor's lift
_NO_DATA = {aten._unsafe_view, aten.detach, aten.alias, aten.lift_fresh, aten.lift_fresh_copy,
            aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
            aten.new_empty_strided}
#: copies, which move nothing on the device when they cross devices (an
#: upload of a cached constant on the card is no copy at all on the CPU)
_COPIES = {aten._to_copy, aten.copy_, aten.copy}
#: composite ops counted whole: their decomposition differs by device
#: (max pooling returns its indices on the card, not on the CPU)
_WHOLE = {aten.max_pool1d}
#: gates an RNN mode has (cuDNN's numbering: RNN relu / tanh, LSTM, GRU)
_GATES = {0: 1, 1: 1, 2: 4, 3: 3}


def rnn_work(steps: int, batch: int, input_size: int, hidden: int, layers: int = 1,
             directions: int = 1, gates: int = 4, itemsize: int = 4) -> dict:
    """An RNN stack's work: the products of the CPU's decomposition, the
    input projection x W_ih^T and the recurrent h W_hh^T at every step, per
    layer and direction; bytes: the input, the weights and biases and the
    output sequence once each."""
    flops = weights = 0.0
    width = input_size
    for _ in range(layers):
        flops += directions * 2.0 * steps * batch * gates * hidden * (width + hidden)
        weights += directions * gates * hidden * (width + hidden + 2)
        width = hidden * directions
    return {"flops": flops, "bytes": itemsize * (steps * batch * (input_size + width) + weights)}


def _cudnn_rnn_counts(args: tuple) -> dict:
    """``rnn_work`` of an ``aten._cudnn_rnn`` call, from its arguments:
    (input, weights, weight_stride0, weight_buf, hx, cx, mode, hidden_size,
    proj_size, num_layers, batch_first, dropout, train, bidirectional, ...)."""
    x, mode, hidden, layers, batch_first, bidir = (args[0], args[6], args[7], args[9],
                                                   args[10], args[13])
    steps, batch = (x.shape[1], x.shape[0]) if batch_first else (x.shape[0], x.shape[1])
    return rnn_work(steps, batch, x.shape[-1], hidden, layers, 2 if bidir else 1,
                    _GATES[mode], x.element_size())


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class WorkCount(TorchDispatchMode):
    """Counts the operations and bytes of the ops dispatched on this thread
    while it is active (``with WorkCount() as count: ...``), plus the
    ``work`` of each ``counted`` entry entered meanwhile. ``flops`` and
    ``bytes`` hold the totals."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.hidden = 0
        self._depth = 0
        self._outer = None

    def __enter__(self):
        # entered again inside its own handler (``__torch_dispatch__``)
        if not self._depth:
            self._outer = getattr(_local, "count", None)
            _local.count = self
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if not self._depth:
            _local.count = self._outer
        return super().__exit__(*exc)

    def add(self, counts: dict) -> None:
        self.flops += counts["flops"]
        self.bytes += counts["bytes"]

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # no dynamo-disabling wrapper around the handler (a cost on every op;
        # the port never compiles with dynamo)
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.hidden:  # a hidden region it could not leave: runs as it would
            return func(*args, **kwargs)
        composite, kind, formula, new_out = _PLANS.get(func) or _plan(func)
        if composite:
            # a composite op (conv1d, linear, pad, ... reach the mode whole
            # under inference_mode) counts as the ops it decomposes into,
            # as FlopCounterMode counts it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if new_out is None:
            return out
        if kind == _RNN:
            self.add(_cudnn_rnn_counts(args))
            return out
        ins = _tensors(args)
        if kwargs:
            ins += _tensors(kwargs.values())
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if kind == _COPY and len({t.device for t in (*ins, *_tensors(outs))}) > 1:
            return out
        if kind == _INT_MM:
            self.flops += 2 * args[0].shape[0] * args[0].shape[1] * args[1].shape[1]
        elif kind == _FORMULA:
            # the formula on shapes (its registry entry maps them out of the
            # arguments with a pytree, a cost paid on every op)
            self.flops += formula(
                *(a.shape if isinstance(a, torch.Tensor) else a for a in args),
                out_shape=out.shape if isinstance(out, torch.Tensor) else None, **kwargs)
        nbytes = 0
        for t in ins:
            nbytes += t.nbytes
        for i, t in enumerate(outs):
            if isinstance(t, torch.Tensor) and (i >= len(new_out) or new_out[i]):
                nbytes += t.nbytes
        self.bytes += nbytes
        return out


def _tensors(values) -> list:
    """The tensors among ``values`` and inside the lists among them (an
    aten op's arguments)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


#: what the handler counts of an op: bytes only, a copy (nothing when it
#: crosses devices), torch's formula, ``_int_mm``, ``_cudnn_rnn``
_PLAIN, _COPY, _FORMULA, _INT_MM, _RNN = range(5)
#: per op overload: (decomposed?, its kind, its formula or None, which
#: returns are new tensors or None when the op moves no data)
_PLANS: dict = {}


def _plan(func) -> tuple:
    packet = func.overloadpacket
    returns = func._schema.returns
    composite = (packet not in flop_registry and packet not in _WHOLE
                 and func.namespace == "aten"
                 and torch._C._dispatch_has_kernel_for_dispatch_key(
                     func.name(), "CompositeImplicitAutograd"))
    view = bool(returns) and all(r.alias_info is not None and not r.alias_info.is_write
                                 for r in returns)
    new_out = (None if packet in _NO_DATA or view
               else tuple(r.alias_info is None for r in returns))
    formula = None
    if packet is aten._cudnn_rnn:
        kind = _RNN
    elif packet is aten._int_mm:
        kind = _INT_MM
    elif packet in flop_registry:
        kind, formula = _FORMULA, flop_registry[packet]
        formula = getattr(formula, "__wrapped__", formula)
    else:
        kind = _COPY if packet in _COPIES else _PLAIN
    plan = _PLANS[func] = (composite, kind, formula, new_out)
    return plan


class _Hidden:
    """A region hidden from a count: ``work`` added on entry, and while it
    lasts the count's dispatch mode is off this thread's stack, so its ops
    run as they would with no count (none reaches ``__torch_dispatch__``)
    and a counted entry inside adds nothing."""

    __slots__ = ("_count", "_work", "_popped")

    def __init__(self, count: WorkCount, work=None):
        self._count, self._work, self._popped = count, work, False

    def __enter__(self):
        count = self._count
        if self._work is not None:
            count.add(self._work)
        count.hidden += 1
        # the count is the innermost mode wherever model code runs (only its
        # own handler re-enters it, and no counted entry starts there)
        self._popped = _current_mode() is count
        if self._popped:
            _pop_mode()

    def __exit__(self, *exc):
        if self._popped:
            _push_mode(self._count)
        self._count.hidden -= 1


class _Times:
    """Step 0 of a host loop of ``n`` like steps: counted, and its count
    taken n times."""

    __slots__ = ("_count", "_n", "_start")

    def __init__(self, count: WorkCount, n: int):
        self._count, self._n = count, n

    def __enter__(self):
        self._start = (self._count.flops, self._count.bytes)

    def __exit__(self, *exc):
        more = self._n - 1
        self._count.flops += more * (self._count.flops - self._start[0])
        self._count.bytes += more * (self._count.bytes - self._start[1])


def _active():
    """The count active on this thread outside any hidden region, or None."""
    count = getattr(_local, "count", None)
    return None if count is None or count.hidden else count


def counting() -> bool:
    """Whether a count is open on this thread, inside a hidden region of it
    too: a program's first call, all of it."""
    return getattr(_local, "count", None) is not None


def uncounted():
    """A region outside the count: a constant made once per set of weights
    (quantised or stacked weights, a reduced-precision copy of a model) is
    not the work of the call that happens to make it, and a later call of
    the same program does not make it."""
    count = _active()
    return _NULL if count is None else _Hidden(count)


def loop_step(i: int, n: int):
    """Context of step ``i`` of a host loop of ``n`` steps that do the same
    work (a decoder's frames or tokens: the same ops on the same shapes):
    ``for i in range(n): with loop_step(i, n): ...``. Where a count is
    active, step 0 is counted and taken n times and the later steps run
    outside the count, as fast as with none; the total is what counting
    every step gives. Else it costs one thread-local read."""
    count = _active()
    if count is None:
        return _NULL
    return _Times(count, n) if i == 0 else _Hidden(count)


def counted(work: Callable[..., dict]):
    """Decorator of a kernel entry, or of a region counted by formula:
    ``@counted(lambda x, ...: kernel.work(...))`` takes the entry's
    arguments. Where a ``WorkCount`` is active on this thread (and not
    inside another such region), ``work(*args, **kwargs)`` (from host ints
    only: counting never syncs) is added to it and the entry runs hidden
    from it; else the entry runs as it is, for one thread-local read."""
    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            count = _active()
            if count is None:
                return fn(*args, **kwargs)
            with _Hidden(count, work(*args, **kwargs)):
                return fn(*args, **kwargs)
        return entry
    return wrap


#: a counted module call's work by its key (``_call_key``), for the process:
#: a pure function of the key, so any count may reuse it
_MEMO: dict = {}


class _Unkeyed(Exception):
    """A call or module that has no key: it is counted op by op."""


def _value_key(v):
    """A call argument's part of a key: a tensor by its shape, dtype and
    device type; a sequence or dict item by item; a hashable value as it is.
    Any other object leaves the call without a key (``_Unkeyed``)."""
    if isinstance(v, torch.Tensor):
        return ("T", tuple(v.shape), v.dtype, v.device.type)
    if isinstance(v, torch.nn.Module):
        return _module_key(v)
    if isinstance(v, (tuple, list)):
        return (type(v), tuple(_value_key(x) for x in v))
    if isinstance(v, dict):
        return (dict, tuple((k, _value_key(x)) for k, x in v.items()))
    try:
        hash(v)
    except TypeError:
        raise _Unkeyed from None
    return v


def _module_key(module: torch.nn.Module) -> tuple:
    """A module's part of a key: for it and each submodule its class, its
    parameters' and buffers' shapes and dtypes, and its other attributes."""
    parts = []
    for m in module.modules():
        tensors = tuple((name, tuple(t.shape), t.dtype)
                        for name, t in (*m._parameters.items(), *m._buffers.items())
                        if t is not None)
        attrs = tuple((k, _value_key(v)) for k, v in vars(m).items()
                      if not k.startswith("_") and not isinstance(v, torch.nn.Module))
        parts.append((type(m), tensors, attrs))
    return tuple(parts)


def shape_keyed(fn):
    """Decorator of a function, or a module's ``forward``, whose work is
    fixed by its arguments' shapes and values (``_value_key``; a module,
    ``self`` too, by its class, parameter shapes and dtypes and attributes:
    ``_module_key``): a frontend, a repeated block of a stack, a model.
    Where a count is active, the first call of a key is counted op by op
    and its count kept for the process; a later call of the key (the next
    block, the next program or engine with the same model) adds that count
    and runs outside the count, as fast as with none. The totals are what
    counting every call gives."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        count = _active()
        if count is None:
            return fn(*args, **kwargs)
        try:
            key = (fn, torch.is_inference_mode_enabled(), torch.is_grad_enabled(),
                   _value_key(args), _value_key(kwargs))
        except _Unkeyed:
            return fn(*args, **kwargs)
        known = _MEMO.get(key)
        if known is not None:
            with _Hidden(count, known):
                return fn(*args, **kwargs)
        start = (count.flops, count.bytes)
        out = fn(*args, **kwargs)
        _MEMO[key] = {"flops": count.flops - start[0], "bytes": count.bytes - start[1]}
        return out
    return call
