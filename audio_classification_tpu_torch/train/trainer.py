"""Separator and module trainers (port of
audio_classification_tpu/train/trainer.py).

The JAX trainers compile one program a step (loss, gradients, the clipped
Adam update); here a step is the eager forward, ``loss.backward()`` and
``ClippedAdam.step()``. The kernels' autograd Functions
(ops/kernels: K3, K4, K5, and K2 outside the trainer) give the forward the
kernels of the card and the backward the twins' gradients, as the JAX
``custom_vjp``s do.

Both trainers keep their module in ``eval()`` while they train with grad
enabled: the JAX speaker trainer runs BatchNorm on its init statistics
(cli/train_speaker.py), where torch's ``train()`` would normalise by batch
statistics and move the running ones. Only parameters reach the optimizer,
never BatchNorm buffers.

A mesh (parallel/mesh.py) runs a step over its entries, one rank per card
under ``torchrun`` (every entry in one process at world size 1):

- DP: each data entry takes its rows of the batch; the loss is the global
  one (a batch mean over all rows, or a masked mean whose numerator and
  denominator are summed over every row: a loss function may return the
  pair), and the gradients are summed over the data ranks;
- TP (``SeparatorTrainer``, model axis > 1): the separators' TP forwards
  (parallel/tp.py). Every rank holds the logical parameters, and the model
  shards' gradient slices are summed over the model ranks where a weight
  enters its shards (collectives.enter_sharded), so each rank has the full
  gradient and ``optax.clip_by_global_norm``'s norm is the logical
  parameters' norm, each replicated leaf counted once;
- ``time_shard`` / a sequence-parallel loss: the data axis carries time
  (parallel/sp_convtasnet, ring attention), the gradients of the time
  shards summed over the data ranks.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from ..engine.runtime import resolve_device, seeded_init_
from ..models.convtasnet import ConvTasNet, ConvTasNetConfig
from ..models.mossformer import MossFormer, MossFormerConfig
from ..parallel.collectives import reduce_replicated
from ..parallel.mesh import shard_batch
from .losses import pit_si_sdr_loss


@dataclass
class TrainState:
    """A trainer's state as it is saved: the module's ``state_dict``
    (parameters and buffers), the optimizer's (Adam moments and update
    count) and the step."""

    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    step: int = 0


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the gradients, in place: when the global
    L2 norm g of all of them is at least ``max_norm``, each becomes
    grad / g * max_norm; below it nothing changes. (torch's
    ``clip_grad_norm_`` divides by g + 1e-6, another function.) -> g."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.sqrt(sum((g.double() * g.double()).sum() for g in grads)).to(grads[0].dtype)
    if norm >= max_norm:
        for g in grads:
            g.div_(norm).mul_(max_norm)
    return norm


class ClippedAdam:
    """``make_optimizer``'s chain, optax ``clip_by_global_norm(clip)`` then
    ``adam(lr)``: torch.optim.Adam with betas (0.9, 0.999) and eps 1e-8
    computes optax's m_hat / (sqrt(v_hat) + eps). ``lr`` is a float or a
    schedule (update index -> lr); update i uses lr(i), i counted from 0, as
    optax counts its updates."""

    def __init__(self, params, lr: Union[float, Callable[[int], float]] = 1e-3,
                 clip: float = 5.0):
        self.params = [p for p in params if p.requires_grad]
        self.clip = float(clip)
        self.schedule = lr if callable(lr) else (lambda _step, _lr=float(lr): _lr)
        self.adam = torch.optim.Adam(self.params, lr=self.schedule(0), betas=(0.9, 0.999),
                                     eps=1e-8)
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> None:
        clip_by_global_norm_(self.params, self.clip)
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def make_optimizer(params, lr=1e-3, clip: float = 5.0) -> ClippedAdam:
    """``lr`` may be a float or a schedule (update index -> lr)."""
    return ClippedAdam(params, lr, clip)


def warmup_cosine(peak_lr: float, total_steps: int, warmup_frac: float = 0.1,
                  floor_frac: float = 0.05) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(init_value=peak_lr / 25,
    peak_value=peak_lr, warmup_steps=w, decay_steps=max(total_steps, w + 1),
    end_value=peak_lr * floor_frac) written out as a function of the update
    index, w = max(1, int(total_steps * warmup_frac)): linear from
    peak_lr / 25 to peak_lr over w updates, then a cosine down to the floor
    over the rest."""
    warmup = max(1, int(total_steps * warmup_frac))
    decay = max(total_steps, warmup + 1) - warmup
    init, end = peak_lr / 25.0, peak_lr * floor_frac
    alpha = end / peak_lr if peak_lr else 0.0

    def lr(step: int) -> float:
        if step < warmup:
            return (init - peak_lr) * (1.0 - max(step, 0) / warmup) + peak_lr
        count = min(step - warmup, decay)
        return peak_lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * count / decay)) + alpha)

    return lr


def flax_init_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """The port's own initialisation, after flax's rules, from a seeded
    ``torch.Generator`` (engine/runtime.seeded_init_): Dense and Conv
    kernels lecun-normal, biases 0, norm scales 1, and an ``aam_centers``
    parameter normal(1.0). (torch's default ``kaiming_uniform`` is another
    starting point.) Parity tests load the JAX init instead."""
    gen = torch.Generator().manual_seed(int(seed))
    seeded_init_(module, gen)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.rsplit(".", 1)[-1] == "aam_centers":
                p.copy_(torch.randn(p.shape, generator=gen))
    return module


def embedder_with_head(cfg, n_spk: int):
    """The embedder (submodule ``embedder``) and the trainable AAM class
    centres ``aam_centers`` [n_spk, embed_dim] in one module; forward(feats)
    -> (embeddings, centres). cli/train_speaker and the quality gate's
    speaker stage train it (flax_init_ draws the centres)."""
    from ..models.speaker import SpeakerEmbedder

    class EmbedderWithHead(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embedder = SpeakerEmbedder(cfg)
            self.aam_centers = torch.nn.Parameter(torch.empty(n_spk, cfg.embed_dim))

        def forward(self, feats):
            return self.embedder(feats), self.aam_centers

    return EmbedderWithHead()


def _to_device(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x)).to(device)


def _sum_grads(params, group) -> None:
    """Sum every parameter's gradient over the ranks of ``group`` (one
    all-reduce of the flattened gradients; a missing one counts as 0)."""
    import torch.distributed as dist

    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    off = 0
    for p, g in zip(params, grads):
        p.grad = flat[off:off + g.numel()].view_as(g).clone()
        off += g.numel()


def _global_loss(parts, rows, mesh) -> torch.Tensor:
    """Per data entry a batch mean (weighted by its rows) or a (numerator,
    denominator) pair -> the loss of the whole batch, which every rank
    then holds (its backward: each rank's own rows)."""
    if isinstance(parts[0], tuple):
        num = reduce_replicated([p[0] for p in parts], mesh, "data")
        den = reduce_replicated([torch.as_tensor(p[1]).detach().to(num) for p in parts],
                                mesh, "data")
        return num / torch.clamp_min(den, 1.0)
    total = reduce_replicated([p * r for p, r in zip(parts, rows)], mesh, "data")
    return total / float(rows[0] * mesh.shape["data"])  # the entries split evenly


class _Trainer:
    """What both trainers share: the clipped Adam step, the state, save and
    restore."""

    model: torch.nn.Module
    optimizer: ClippedAdam
    step: int
    #: the process group the gradients are summed over, if any
    _grad_group = None

    def _update(self, loss_of: Callable[[], torch.Tensor]) -> float:
        self.optimizer.zero_grad()
        with torch.enable_grad():
            loss = loss_of()
        loss.backward()
        if self._grad_group is not None:
            _sum_grads(self.optimizer.params, self._grad_group)
        self.optimizer.step()
        self.step += 1
        return float(loss.detach())

    @property
    def state(self) -> TrainState:
        return TrainState(self.model.state_dict(), self.optimizer.state_dict(), self.step)

    def save(self, ckpt_dir: str) -> None:
        """Write a resumable mid-run checkpoint (params + Adam moments +
        step); under a mesh rank 0 writes (every rank holds the same)."""
        from ..parallel.launch import is_writer
        from .checkpoint import save_train_state

        if is_writer():
            save_train_state(self.state, ckpt_dir)

    def restore(self, ckpt_dir: str) -> int:
        """Resume from ``save``; returns the restored step."""
        from .checkpoint import load_train_state

        st = load_train_state(ckpt_dir)
        self.model.load_state_dict(st.params)
        self.optimizer.load_state_dict(st.opt_state)
        self.step = st.step
        return st.step


def _data_group(mesh):
    """The data axis's process group when it spans more than one rank."""
    if mesh is None or not mesh.distributed or len(mesh.axis_ranks("data")) < 2:
        return None
    return mesh.groups["data"]


class SeparatorTrainer(_Trainer):
    """PIT SI-SDR trainer for a ConvTasNetConfig or MossFormerConfig model.

    Conv-TasNet trains its dense TCN loop (``fused_tcn="off"``), as the JAX
    trainer does (trainer.py:93), so the trained function is the JAX one.
    With ``mesh`` the batch splits over its "data" entries (DP) and a
    "model" axis above 1 runs the TP forward (parallel/tp.py) by the
    architecture's rule (parallel/mesh.convtasnet_param_spec /
    mossformer_param_spec). ``time_shard=True`` runs the forward through the
    time-sharded separator (parallel/sp_convtasnet) over ``mesh``'s "data"
    shards instead, the batch whole on every shard; the backward runs
    through the same halos and sums. Weights: the port's flax-rule init
    from ``seed``, on ``device`` (default: the mesh's, else the first CUDA
    device)."""

    def __init__(self, cfg, mesh=None, lr=1e-3, seed: int = 0,
                 time_shard: bool = False, device=None):
        self.cfg = cfg
        self.time_shard = bool(time_shard)
        if self.time_shard and mesh is None:
            raise ValueError("SeparatorTrainer: time_shard needs a mesh")
        self.mesh = mesh
        self._grad_group = _data_group(mesh)
        self.device = resolve_device(mesh.device if device is None and mesh is not None
                                     else device)
        if isinstance(cfg, MossFormerConfig):
            self.model = MossFormer(cfg)
        elif isinstance(cfg, ConvTasNetConfig):
            self.model = ConvTasNet(dataclasses.replace(cfg, fused_tcn="off"))
        else:
            raise TypeError(f"unsupported separator config: {type(cfg)}")
        flax_init_(self.model, seed).to(self.device).eval()
        self.optimizer = make_optimizer(self.model.parameters(), lr)
        self.step = 0

    def loss(self, mix: torch.Tensor, refs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The PIT loss of one batch, differentiable (the whole batch's, on
        every rank)."""
        if self.time_shard:
            from ..parallel.sp_convtasnet import sp_separate, sp_separate_mossformer

            sp_fn = sp_separate_mossformer if isinstance(self.cfg, MossFormerConfig) else sp_separate
            lengths = mask.to(torch.int64).sum(dim=-1)
            ests = sp_fn(self.model, mix, lengths, self.mesh)
            return pit_si_sdr_loss(ests, refs, mask)
        if self.mesh is None:
            return pit_si_sdr_loss(self.model(mix, mask), refs, mask)
        shards = shard_batch(self.mesh, (mix, refs, mask))
        parts = [pit_si_sdr_loss(self.model(m, k, mesh=self.mesh), r, k) for m, r, k in shards]
        return _global_loss(parts, [s[0].shape[0] for s in shards], self.mesh)

    def train_step(self, mix, refs, mask) -> float:
        """mix [B, T], refs [B, n_src, T], mask [B, T] -> loss (float)."""
        mix, refs, mask = (_to_device(a, self.device).float() for a in (mix, refs, mask))
        return self._update(lambda: self.loss(mix, refs, mask))


class ModuleTrainer(_Trainer):
    """Trainer for any module and loss: ``loss_fn(module, batch)`` -> a
    scalar batch mean, or a (numerator, denominator) pair for a masked mean
    (``frame_bce_loss(..., parts=True)``), batch a dict of arrays moved to
    the module's device. Covers OSD / VAD frame BCE, speaker AAM softmax and
    SenseVoice CTC. The module's own parameters (as they are: the JAX init
    in the parity tests, the port's init in the CLIs) are what Adam trains.

    With ``mesh`` the batch splits over its "data" entries
    (``shard_batch``) and the loss is the whole batch's: a pair sums its
    numerator and denominator over every row, a mean weighs each entry by
    its rows. ``shard_batch=False`` keeps the batch whole on every entry,
    for a loss that spends the data axis on something else (a
    sequence-parallel encoder); its gradients are then whole on every rank
    already."""

    def __init__(self, module: torch.nn.Module, loss_fn: Callable, lr=1e-3, device=None,
                 mesh=None, shard_batch: bool = True):
        self.model = module
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.shard_batch = bool(shard_batch)
        if device is None:
            device = mesh.device if mesh is not None else next(module.parameters()).device
        self.device = resolve_device(device)
        module.to(self.device).eval()
        self.optimizer = make_optimizer(module.parameters(), lr)
        self.step = 0
        self._grad_group = _data_group(mesh) if self.shard_batch else None

    def _loss(self, batch) -> torch.Tensor:
        if self.mesh is None or not self.shard_batch:
            out = self.loss_fn(self.model, batch)
            return out[0] / torch.clamp_min(torch.as_tensor(out[1]).to(out[0]), 1.0) \
                if isinstance(out, tuple) else out
        shards = shard_batch(self.mesh, batch)
        parts = [self.loss_fn(self.model, b) for b in shards]
        rows = [int(next(iter(b.values())).shape[0]) for b in shards]
        return _global_loss(parts, rows, self.mesh)

    def train_step(self, batch: Dict[str, Any]) -> float:
        batch = {k: _to_device(v, self.device) for k, v in batch.items()}
        return self._update(lambda: self._loss(batch))
