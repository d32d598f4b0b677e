"""scripts/orbax_to_torch.py: a JAX orbax model pack, converted, gives the
port's offline_overlap_3src --checkpoint-dir the JAX CLI's records on the
same wavs; a params-only orbax export converts to a directory
--sep-checkpoint loads; an orbax directory given to the port raises naming
the converter (CPU, tiny preset)."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_classification_tpu_torch.audio_io import write_wav
from audio_classification_tpu_torch.cli.offline_overlap_3src import main as overlap3_main
from audio_classification_tpu_torch.models import facades
from test_torch_train_cli import SR, _engine, _equal_weights

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


def _converter():
    spec = importlib.util.spec_from_file_location("orbax_to_torch",
                                                  REPO / "scripts" / "orbax_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def orbax_pack(tmp_path_factory):
    """The JAX tiny pack at seed 0 (the weights test_torch_pipeline holds
    the two pipelines equal on) saved by the JAX package's orbax
    checkpointer, and its conversion."""
    from audio_classification_tpu.engine import ModelPack as JaxModelPack
    from audio_classification_tpu.engine import tiny_preset as jax_tiny_preset
    from audio_classification_tpu.train.checkpoint import save_model_pack

    root = tmp_path_factory.mktemp("orbax")
    save_model_pack(JaxModelPack(jax_tiny_preset(), seed=0), str(root / "orbax"))
    assert _converter().convert(str(root / "orbax"), str(root / "port")) == "model_pack"
    return root


def _wavs(d):
    rng = np.random.default_rng(0)
    t = np.arange(3 * SR) / SR
    mix = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 990 * t)
           + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    write_wav(d / "mix.wav", mix, SR)
    write_wav(d / "target.wav", (0.3 * np.sin(2 * np.pi * 440 * t[: 2 * SR])).astype(np.float32),
              SR)


def test_converted_orbax_pack_gives_the_jax_cli_records(orbax_pack, tmp_path):
    """The JAX CLI on the orbax directory and the port's on its conversion,
    both seeded 5 (so only the checkpoint makes them agree), every segment
    forced to overlap: kind, span, stream and text equal, sv_score within
    1e-4."""
    from audio_classification_tpu.cli.offline_overlap_3src import main as jax_main

    _wavs(tmp_path)
    argv = ["--input-wavs", str(tmp_path / "mix.wav"), "--target-wav", str(tmp_path / "target.wav"),
            "--preset", "tiny", "--seed", "5", "--sv-threshold", "-1", "--osd-thr", "0.0",
            "--max-batch", "4", "--max-segment-sec", "4"]
    jax_main([*argv, "--checkpoint-dir", str(orbax_pack / "orbax"),
              "--out-dir", str(tmp_path / "jax")])
    overlap3_main([*argv, "--checkpoint-dir", str(orbax_pack / "port"), "--provider", "cpu",
                   "--out-dir", str(tmp_path / "port")])

    def records(d):
        (path,) = (tmp_path / d).glob("*/segments.jsonl")
        return [json.loads(ln) for ln in path.read_text().splitlines()]

    got, want = records("port"), records("jax")
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g["kind"] == "overlap"
        for key in ("kind", "start", "end", "stream", "text"):
            assert g[key] == w[key], key
        assert abs(g["sv_score"] - w["sv_score"]) <= 1e-4 + 1e-9


def test_converted_params_export_loads_and_orbax_dirs_raise(orbax_pack, tmp_path):
    """A params-only orbax export (what the JAX train_separator --export
    writes) converts to a directory --sep-checkpoint loads, tensor for
    tensor the JAX params; an orbax directory given to the port itself
    raises NotImplementedError naming the converter, by every door."""
    import jax

    from audio_classification_tpu.engine import ModelPack as JaxModelPack
    from audio_classification_tpu.engine import tiny_preset as jax_tiny_preset
    from audio_classification_tpu.train.checkpoint import save_params
    from audio_classification_tpu_torch.convert.from_jax import variables_to_state_dict

    params = jax.device_get(JaxModelPack(jax_tiny_preset(), seed=2).params["sep3"])
    save_params(params, str(tmp_path / "orbax_sep"))
    assert _converter().convert(str(tmp_path / "orbax_sep"), str(tmp_path / "sep")) == "params"
    want = variables_to_state_dict(params)
    assert _equal_weights(_engine(sep_checkpoint=str(tmp_path / "sep")).pack.models["sep3"], want)
    orbax = str(tmp_path / "orbax_sep")
    for kw in ({"checkpoint_dir": str(orbax_pack / "orbax")}, {"sep_checkpoint": orbax},
               {"sense_voice": orbax}, {"spk_embed_model": orbax}):
        with pytest.raises(NotImplementedError, match="scripts/orbax_to_torch.py"):
            _engine(**kw)
    with pytest.raises(NotImplementedError, match="scripts/orbax_to_torch.py"):
        facades.Separator(checkpoint=orbax, engine=_engine())
