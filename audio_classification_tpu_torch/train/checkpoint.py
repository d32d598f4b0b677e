"""Checkpoints of the port (port of audio_classification_tpu/train/checkpoint.py).

The JAX package writes orbax directories; the machine with the card has no
orbax, tensorstore or JAX, so the port writes and reads its own format: a
directory holding ``torch.save`` files of ``state_dict``s and a small
``meta.json`` (what the directory holds and, where given, the model's
config). Files are read with ``weights_only=True``.

- ``save_model_pack`` / ``load_model_pack``: every stage of a ModelPack
  (``pack.pt``: {stage: state_dict}); loading goes through
  ``ModelPack.load_params``, so ``pack.version`` moves and an engine's
  reduced-precision copy is made again.
- ``save_params`` / ``load_params``: one model's ``state_dict``
  (``params.pt``), what the training CLIs' ``--export`` writes and
  ``--sep-checkpoint`` / ``--sense-voice`` / ``--spk-embed-model`` /
  ``Separator(checkpoint=)`` read.
- ``save_train_state`` / ``load_train_state``: a resumable trainer state
  (``train_state.pt``: params, Adam moments, step).

A shape or name that does not match the model fails loud (ValueError). An
orbax directory (``is_orbax_dir``) is converted where JAX is, by
``scripts/orbax_to_torch.py`` (``ORBAX_HINT``).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Union

import torch

FORMAT = "audio_classification_tpu_torch"
#: what an orbax directory given to the port is told
ORBAX_HINT = ("an orbax checkpoint directory is not ported to audio_classification_tpu_torch: "
              "convert it with scripts/orbax_to_torch.py (ROADMAP slice 14) where JAX and "
              "orbax are installed, and pass the directory that writes")


def is_orbax_dir(path) -> bool:
    """Whether ``path`` is a directory an orbax checkpointer wrote."""
    p = Path(path)
    return p.is_dir() and any((p / name).exists()
                              for name in ("_CHECKPOINT_METADATA", "manifest.ocdbt"))


def _write(path, name: str, payload, meta: Dict[str, Any]) -> None:
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    torch.save(payload, out / name)
    (out / "meta.json").write_text(json.dumps({"format": FORMAT, **meta}, indent=2,
                                              default=str) + "\n", encoding="utf-8")


def read_meta(path) -> Dict[str, Any]:
    """The directory's ``meta.json``; raises NotImplementedError for an
    orbax directory and FileNotFoundError for anything else without one."""
    p = Path(path)
    if is_orbax_dir(p):
        raise NotImplementedError(f"{p}: {ORBAX_HINT}")
    meta_path = p / "meta.json"
    if not meta_path.is_file():
        raise FileNotFoundError(f"{p}: not a checkpoint directory of the port (no meta.json)")
    return json.loads(meta_path.read_text(encoding="utf-8"))


def _read(path, name: str, kind: str):
    meta = read_meta(path)
    if meta.get("kind") != kind:
        raise ValueError(f"{path}: holds a {meta.get('kind')!r} checkpoint, not a {kind!r} one")
    return torch.load(Path(path) / name, map_location="cpu", weights_only=True)


def _cpu(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in sd.items()}


def check_state_dict(sd: Mapping[str, torch.Tensor], template: Mapping[str, torch.Tensor],
                     what: str) -> None:
    """Raise ValueError unless ``sd`` has ``template``'s keys and shapes."""
    missing, extra = sorted(set(template) - set(sd)), sorted(set(sd) - set(template))
    if missing or extra:
        raise ValueError(f"{what}: names do not match the model (missing {missing[:5]}, "
                         f"unexpected {extra[:5]})")
    for k, v in template.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"{what}: {k} has shape {tuple(sd[k].shape)}, the model's is "
                             f"{tuple(v.shape)}")


def save_params(params: Union[torch.nn.Module, Mapping[str, torch.Tensor]], path,
                config: Optional[Mapping[str, Any]] = None, **meta) -> None:
    """One model's weights (a module or its state_dict) into directory
    ``path``; ``config`` (the model's config as a dict) and ``meta`` go to
    meta.json."""
    sd = params.state_dict() if isinstance(params, torch.nn.Module) else params
    _write(path, "params.pt", _cpu(sd), {"kind": "params", "config": config, **meta})


def load_params(path, template: Optional[Union[torch.nn.Module, Mapping]] = None
                ) -> Dict[str, torch.Tensor]:
    """What ``save_params`` wrote -> state_dict (CPU tensors), held to
    ``template``'s names and shapes when given (ValueError otherwise)."""
    sd = _read(path, "params.pt", "params")
    if template is not None:
        tsd = template.state_dict() if isinstance(template, torch.nn.Module) else template
        check_state_dict(sd, tsd, str(path))
    return sd


def save_state_dicts(state_dicts: Mapping[str, Mapping[str, torch.Tensor]], ckpt_dir,
                     **meta) -> None:
    """{stage: state_dict} into a model-pack directory (``load_model_pack``
    reads it); ``meta`` goes to meta.json."""
    _write(ckpt_dir, "pack.pt", {k: _cpu(sd) for k, sd in state_dicts.items()},
           {"kind": "model_pack", **meta})


def save_model_pack(pack, ckpt_dir) -> None:
    """Every stage of ``pack`` into one directory."""
    save_state_dicts({k: m.state_dict() for k, m in pack.models.items()}, ckpt_dir,
                     preset=pack.preset.name, asr_family=pack.asr_family)


def load_model_pack(pack, ckpt_dir) -> None:
    """Load what ``save_model_pack`` (or scripts/orbax_to_torch.py) wrote
    into ``pack``, stage by stage through ``pack.load_params``; a stage
    whose names or shapes differ from the pack's raises ValueError."""
    stages = _read(ckpt_dir, "pack.pt", "model_pack")
    for stage, sd in stages.items():
        if stage not in pack.models:
            raise ValueError(f"{ckpt_dir}: stage {stage!r} is not in the pack "
                             f"({sorted(pack.models)})")
        check_state_dict(sd, pack.models[stage].state_dict(), f"{ckpt_dir} [{stage}]")
        pack.load_params(stage, sd)


def save_train_state(state, ckpt_dir) -> None:
    """A resumable trainer state (trainer.TrainState) into ``ckpt_dir``."""
    _write(ckpt_dir, "train_state.pt",
           {"params": _cpu(state.params), "opt_state": state.opt_state, "step": int(state.step)},
           {"kind": "train_state", "step": int(state.step)})


def load_train_state(ckpt_dir):
    """What ``save_train_state`` wrote -> trainer.TrainState."""
    from .trainer import TrainState

    tree = _read(ckpt_dir, "train_state.pt", "train_state")
    return TrainState(tree["params"], tree["opt_state"], int(tree["step"]))

