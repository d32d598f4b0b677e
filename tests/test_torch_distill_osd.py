"""The port's cli/distill_osd against the JAX package's, on the CPU, and
--osd-checkpoint DIR: the host functions (make_scene, energy_labels,
teacher_labels) bit-equal from the same rng; the first step's frame-BCE loss
equal to JAX's from the same init and batch (batch 8, energy labels and the
in-port PyanNet teacher); --teacher-npz over a LibriMix tree; the output
directory loaded by build_engine and offline_overlap_3src through
--osd-checkpoint; the JAX tool's orbax output converted by
scripts/orbax_to_torch.py into a directory the port loads; --export-onnx
and an orbax --osd-checkpoint refused."""
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

import audio_classification_tpu.train.trainer as jax_trainer
import audio_classification_tpu_torch.cli.distill_osd as dosd
from audio_classification_tpu.cli import distill_osd as jdosd
from audio_classification_tpu_torch.audio_io import write_wav
from audio_classification_tpu_torch.cli.offline_overlap_3src import main as overlap3_main
from audio_classification_tpu_torch.convert.from_jax import variables_to_state_dict
from audio_classification_tpu_torch.pipelines.offline_overlap3 import build_engine
from audio_classification_tpu_torch.train.checkpoint import load_params
from audio_classification_tpu_torch.utils.config import Overlap3Config
from torch_port_helpers import pyannote_state_dict, save_torch_checkpoint

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
SR = 16000
# a small pyannote segmentation model with pyannote's sinc kernel and stride
PN = dict(sample_rate=SR, n_filters=8, kernel_size=251, stride=10, conv_channels=(6, 6),
          conv_kernel=5, pool=3, lstm_hidden=8, lstm_layers=2, linear_dims=(8,), num_classes=3)
RUN = ["--synthetic", "--preset", "tiny", "--dur", "2.0", "--eval-files", "2",
       "--f1-target", "0.0", "--seed", "0"]


def _pyannote_ckpt(path):
    from audio_classification_tpu.models.pyannet import PyanNetConfig

    return save_torch_checkpoint(path, pyannote_state_dict(PyanNetConfig(**PN),
                                                           np.random.RandomState(2)))


# ------------------------------------------------------------ host functions

@pytest.mark.parametrize("seed,dur", [(0, 4.0), (3, 2.0), (11, 3.3)])
def test_host_functions_bit_equal_to_jax(seed, dur):
    r_port, r_jax = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):
        (a1, a2), (b1, b2) = dosd.make_scene(r_port, dur), jdosd.make_scene(r_jax, dur)
        assert np.array_equal(a1, b1) and np.array_equal(a2, b2) and a1.dtype == b1.dtype
    assert r_port.random() == r_jax.random()
    centers = (np.arange(int(dur * 25)) + 0.5) * 0.04
    for ratio in (0.03, 0.3):
        assert np.array_equal(dosd.energy_labels([a1, a2], centers, ratio),
                              jdosd.energy_labels([b1, b2], centers, ratio))
    probs = np.random.default_rng(seed).uniform(0, 1, (97, 2)).astype(np.float32)
    for frame_sec, shift in ((0.0169, 0.0), (0.02, 1.3)):
        got = dosd.teacher_labels(probs, frame_sec, centers + shift)
        want = jdosd.teacher_labels(probs, frame_sec, centers + shift)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.fixture(scope="module")
def librimix_root(tmp_path_factory):
    """A Libri2Mix train-360 tree at 16 kHz: four 3 s mixtures of the
    synthetic two-voice scenes, written as PCM16."""
    root = tmp_path_factory.mktemp("librimix")
    base = root / "Libri2Mix" / "wav16k" / "min" / "train-360"
    for sub in ("mix_clean", "s1", "s2"):
        (base / sub).mkdir(parents=True)
    rng = np.random.default_rng(5)
    for i in range(4):
        s1, s2 = jdosd.make_scene(rng, 3.0)
        for sub, w in (("s1", s1), ("s2", s2), ("mix_clean", s1 + s2)):
            write_wav(base / sub / f"utt{i}.wav", w, SR)
    return root


# ------------------------------------------------- first step against JAX

def _jax_first_step(monkeypatch, argv):
    """The JAX tool, 1 step: its OSDNet init and its step losses."""
    rec = {"losses": []}

    class Module(jax_trainer.ModuleTrainer):
        def __init__(self, module, params, *a, **k):
            super().__init__(module, params, *a, **k)
            rec["init"] = jax.tree.map(np.asarray, params)

        def train_step(self, batch):
            loss = super().train_step(batch)
            rec["losses"].append(loss)
            rec["final"] = jax.tree.map(np.asarray, self.state.params)
            return loss

    monkeypatch.setattr(jax_trainer, "ModuleTrainer", Module)
    orig_init = nn.Module.init
    # the init jitted: the same values, one compile instead of one an op
    monkeypatch.setattr(nn.Module, "init", lambda self, rngs, *a, **kw: jax.jit(
        lambda r, *x: orig_init(self, r, *x, **kw))(rngs, *a))
    m = jdosd.main(argv)
    monkeypatch.undo()
    return rec, m


def _port_from(monkeypatch, init, losses):
    make = dosd.make_trainer

    def from_jax(*a, **k):
        tr = make(*a, **k)
        tr.model.load_state_dict(variables_to_state_dict(init))
        step = tr.train_step
        tr.train_step = lambda b: losses.append(step(b)) or losses[-1]
        return tr

    monkeypatch.setattr(dosd, "make_trainer", from_jax)


@pytest.mark.parametrize("teacher", [False, True], ids=["energy", "teacher_ckpt"])
def test_first_step_loss_equals_jax(librimix_root, tmp_path, monkeypatch, teacher):
    """Batch 8 (a multiple of the JAX tests' 8 devices: no rounding there),
    one step from the JAX init on LibriMix crops: the same batch from the
    same stream, the same loss within 1e-4 relative, the same held-out F1;
    the weights after it within 2 lr (Adam's first step is lr * sign(g)).

    The crops are PCM16 files, whose quantisation noise floors every mel
    band. The --synthetic scenes are pure harmonics below 1 kHz: their high
    mel bands hold only float32 rounding noise, where the two frontends'
    log-mel values differ by up to 1.2 (of 24) and the first loss by 5e-4
    relative, as on digital silence (test_torch_sid's VAD note)."""
    extra = ["--teacher-ckpt", _pyannote_ckpt(tmp_path / "seg.ckpt")] if teacher else []
    argv = ["--librimix-root", str(librimix_root), "--preset", "tiny", "--dur", "2.0",
            "--eval-files", "2", "--f1-target", "0.0", "--seed", "0", "--steps", "1",
            "--batch", "8", *extra]
    rec, jm = _jax_first_step(monkeypatch, argv + ["--out", str(tmp_path / "jax")])
    losses = []
    _port_from(monkeypatch, rec["init"], losses)
    m = dosd.main(argv + ["--out", str(tmp_path / "port"), "--provider", "cpu"])
    assert len(losses) == len(rec["losses"]) == 1
    assert abs(losses[0] - rec["losses"][0]) <= 1e-4 * abs(rec["losses"][0])
    assert m == jm
    got = load_params(tmp_path / "port")
    want = variables_to_state_dict(rec["final"])
    diffs = np.concatenate([np.abs(got[k].numpy() - want[k].numpy()).ravel() for k in want])
    assert diffs.max() <= 2 * 3e-4 and np.quantile(diffs, 0.99) <= 3e-5
    if not teacher:
        # the JAX tool's orbax output, converted, is what --osd-checkpoint loads
        spec = importlib.util.spec_from_file_location("orbax_to_torch",
                                                      REPO / "scripts" / "orbax_to_torch.py")
        conv = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(conv)
        assert conv.convert(str(tmp_path / "jax"), str(tmp_path / "conv")) == "params"
        eng = build_engine(Overlap3Config(preset="tiny", seed=0, max_batch=2, provider="cpu",
                                          osd_checkpoint=str(tmp_path / "conv")))
        for k, v in eng.pack.models["osd"].state_dict().items():
            assert torch.equal(v, want[k]), k


# ------------------------------------------------------------ port-only runs

@pytest.fixture(scope="module")
def distilled(tmp_path_factory):
    out = tmp_path_factory.mktemp("distill") / "osd_params"
    m = dosd.main(RUN + ["--steps", "3", "--batch", "4", "--out", str(out), "--provider", "cpu"])
    return out, m


def test_distill_osd_synthetic_end_to_end(distilled):
    out, m = distilled
    assert (out / "params.pt").is_file() and (out / "meta.json").is_file()
    run = json.loads((out / "run.json").read_text())
    assert run["f1"] == m["f1"] and run["argv"]["preset"] == "tiny"
    assert m["f1"] is not None


def test_osd_checkpoint_dir_loads_in_build_engine(distilled):
    """The engine's OSD weights are the saved ones, not the seed init."""
    out, _ = distilled
    eng0 = build_engine(Overlap3Config(preset="tiny", seed=0, max_batch=2, provider="cpu"))
    eng1 = build_engine(Overlap3Config(preset="tiny", seed=0, max_batch=2, provider="cpu",
                                       osd_checkpoint=str(out)))
    saved = load_params(out)
    for k, v in eng1.pack.models["osd"].state_dict().items():
        assert torch.equal(v, saved[k]), k
    k0 = eng0.pack.models["osd"].head.weight
    assert not torch.equal(k0, eng1.pack.models["osd"].head.weight)
    assert eng1.pack.osd_pyannet is None
    segs = eng1.osd_segments(np.zeros(SR, np.float32), SR, 0.5, 0.5, 0.1)
    assert isinstance(segs, list)
    # the full preset's OSDNet does not take the tiny one's weights
    with pytest.raises(ValueError, match="--osd-checkpoint"):
        build_engine(Overlap3Config(seed=0, provider="cpu", osd_checkpoint=str(out)))


def test_osd_checkpoint_dir_runs_the_flagship(distilled, tmp_path):
    out, _ = distilled
    rng = np.random.default_rng(0)
    t = np.arange(3 * SR) / SR
    mix = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 990 * t)
           + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    write_wav(tmp_path / "mix.wav", mix, SR)
    write_wav(tmp_path / "target.wav", mix[: 2 * SR], SR)
    out_dir, result = overlap3_main([
        "--input-wavs", str(tmp_path / "mix.wav"), "--target-wav", str(tmp_path / "target.wav"),
        "--preset", "tiny", "--seed", "0", "--sv-threshold", "-1", "--provider", "cpu",
        "--osd-checkpoint", str(out), "--out-dir", str(tmp_path / "o")])
    assert result.metrics["segments_total"] >= 1
    summary = json.loads((out_dir / "summary.json").read_text())
    assert summary["segments"] == result.metrics["segments_total"]


def test_teacher_npz_over_librimix(librimix_root, tmp_path, monkeypatch):
    """--teacher-npz labels LibriMix crops by their stems; every training
    crop's labels come from the dump (teacher_labels), none from energy."""
    root = librimix_root
    probs = np.random.default_rng(0).uniform(0, 1, (200, 2)).astype(np.float32)
    np.savez(tmp_path / "teacher.npz", __frame_sec__=0.02,
             **{f"utt{i}": np.roll(probs, 7 * i, axis=0) for i in range(4)})
    calls = {"teacher": 0, "energy": 0}
    for name, key in (("teacher_labels", "teacher"), ("energy_labels", "energy")):
        fn = getattr(dosd, name)
        monkeypatch.setattr(dosd, name, lambda *a, _fn=fn, _k=key: (
            calls.__setitem__(_k, calls[_k] + 1), _fn(*a))[1])
    m = dosd.main(["--librimix-root", str(root), "--teacher-npz", str(tmp_path / "teacher.npz"),
                   "--preset", "tiny", "--dur", "2.0", "--steps", "2", "--batch", "2",
                   "--eval-files", "2", "--f1-target", "0.0", "--provider", "cpu",
                   "--out", str(tmp_path / "out")])
    assert calls == {"teacher": 1 + 2 * 2, "energy": 0}  # the init draw, then 2 x 2
    assert m["f1"] is not None and (tmp_path / "out" / "params.pt").is_file()


def test_teacher_ckpt_runs_in_the_port(tmp_path):
    m = dosd.main(RUN + ["--steps", "2", "--batch", "2", "--provider", "cpu",
                         "--teacher-ckpt", _pyannote_ckpt(tmp_path / "seg.ckpt"),
                         "--out", str(tmp_path / "out")])
    assert m["f1"] is not None and (tmp_path / "out" / "params.pt").is_file()


def test_export_onnx_raises_before_training(tmp_path, monkeypatch):
    """--export-onnx raised before training until the ONNX slice; it now
    writes the distilled head after training, a graph of the fbank frames of
    a --dur crop that the port's executor runs as the trained module."""
    from audio_classification_tpu_torch.convert.onnx_exec import OnnxModel
    from audio_classification_tpu_torch.engine import tiny_preset
    from audio_classification_tpu_torch.models.osd import OSDNet

    onnx_path = tmp_path / "osd.onnx"
    dosd.main(RUN + ["--steps", "1", "--batch", "2", "--out", str(tmp_path / "o"),
                     "--provider", "cpu", "--export-onnx", str(onnx_path)])
    model = OSDNet(tiny_preset().osd)
    model.load_state_dict(load_params(tmp_path / "o"))
    graph = OnnxModel(str(onnx_path), device="cpu")
    feats = np.random.default_rng(0).standard_normal((1, 198, 80)).astype(np.float32)
    with torch.no_grad():
        ref = model.eval()(torch.from_numpy(feats), torch.ones(1, 198, dtype=torch.bool))
    np.testing.assert_allclose(graph(feats=feats)["probs"].numpy(), ref.numpy(), atol=1e-5)


def test_f1_below_target_exits_1(tmp_path):
    with pytest.raises(SystemExit) as e:
        dosd.main(["--synthetic", "--preset", "tiny", "--dur", "2.0", "--steps", "1",
                   "--batch", "2", "--eval-files", "1", "--f1-target", "1.01",
                   "--provider", "cpu", "--out", str(tmp_path / "o")])
    assert e.value.code == 1 and (tmp_path / "o" / "params.pt").is_file()


def test_orbax_osd_checkpoint_raises_with_the_hint(tmp_path):
    (tmp_path / "_CHECKPOINT_METADATA").write_text("{}")  # what orbax writes
    with pytest.raises(NotImplementedError, match="orbax_to_torch"):
        build_engine(Overlap3Config(preset="tiny", provider="cpu", osd_checkpoint=str(tmp_path)))


def test_distill_osd_needs_the_card_or_the_cpu_asked_for(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dosd.main(RUN + ["--out", str(tmp_path / "o")])
