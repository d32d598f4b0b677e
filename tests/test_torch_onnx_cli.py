"""The port's ONNX tools on the CPU against the JAX package's:
cli/convert_models (--map, the initializer inventory; --verify is
tests/test_torch_onnx_verify.py's), cli/export_models, the training CLIs'
--init-onnx / --export-onnx, and cli/distill_asr.

The JAX tools run on the port pack's weights (tests/torch_onnx_helpers.
jax_twin; their ModelPack is patched to it), so file contents and reports
compare exactly. distill_asr is held to the JAX tool from the JAX init on
PCM16 wavs over a noise floor (pure tones leave the high mel bands at
float32 rounding noise, where the two frontends differ:
tests/test_torch_distill_osd.py); its losses follow the trainer-parity
rule of ROADMAP §3.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import audio_classification_tpu.engine.runtime as jax_runtime
from audio_classification_tpu.cli import convert_models as jax_convert
from audio_classification_tpu.cli import distill_asr as jax_distill
from audio_classification_tpu.cli import export_models as jax_export_models
from audio_classification_tpu_torch.audio_io import write_wav
from audio_classification_tpu_torch.cli import (convert_models, distill_asr, export_models,
                                                train_asr, train_separator, train_speaker)
from audio_classification_tpu_torch.cli.train_asr import _ALPHABET
from audio_classification_tpu_torch.convert import onnx_export
from audio_classification_tpu_torch.convert.from_jax import (state_dict_to_variables,
                                                             variables_to_state_dict)
from audio_classification_tpu_torch.convert.onnx_exec import OnnxModel
from audio_classification_tpu_torch.engine import ModelPack, tiny_preset
from audio_classification_tpu_torch.models.asr.sensevoice import SenseVoiceConfig, SenseVoiceEncoder
from audio_classification_tpu_torch.train.checkpoint import load_params
from torch_onnx_helpers import (reference_model_dir, sensevoice_mappable_graph,
                                twin_pack_factory)

torch.set_num_threads(2)
SR = 16000
CHARS = "".join(chr(ord("a") + i % 26) if i < 26 else chr(0x4e00 + i) for i in range(63))


@pytest.fixture(scope="module")
def pack():
    return ModelPack(tiny_preset(), seed=0, device="cpu")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, pack):
    return reference_model_dir(tmp_path_factory.mktemp("reference_models"), pack, CHARS)


def test_convert_models_maps_each_kind_and_inventories_as_jax(model_dir, tmp_path, pack,
                                                              monkeypatch):
    """--map speaker / vad / sensevoice into a pack directory that loads back
    to the weights the files hold; the initializer dump (npz + JSON
    inventory) equals the JAX tool's."""
    spk = next(model_dir.rglob("3dspeaker*.onnx"))
    vad = next(model_dir.rglob("silero_vad.onnx"))
    sv = next(model_dir.rglob("model.onnx"))
    out = tmp_path / "pack"
    convert_models.main(["--onnx", str(spk), str(vad), str(sv), "--map", "speaker", "vad",
                         "sensevoice", "--out", str(out), "--preset", "tiny",
                         "--provider", "cpu", "--seed", "1"])
    loaded = ModelPack(tiny_preset(), seed=1, device="cpu")
    from audio_classification_tpu_torch.train.checkpoint import load_model_pack

    load_model_pack(loaded, out)
    for stage in ("spk", "vad", "asr"):
        for k, v in pack.models[stage].state_dict().items():
            assert torch.equal(loaded.models[stage].state_dict()[k], v), (stage, k)
    # the inventory mode, next to the file, against the JAX tool's
    monkeypatch.setattr(jax_runtime, "ModelPack", twin_pack_factory(pack))
    monkeypatch.setattr("audio_classification_tpu.train.checkpoint.save_model_pack",
                        lambda *a, **k: None)
    jax_convert.main(["--onnx", str(sv), "--out", str(tmp_path / "jax"), "--preset", "tiny"])
    want_inv = (sv.with_suffix(".inventory.json")).read_text()
    want_npz = dict(np.load(sv.with_suffix(".weights.npz")))
    convert_models.main(["--onnx", str(sv), "--out", str(tmp_path / "port"), "--preset",
                         "tiny", "--provider", "cpu"])
    assert sv.with_suffix(".inventory.json").read_text() == want_inv
    got_npz = dict(np.load(sv.with_suffix(".weights.npz")))
    assert list(got_npz) == list(want_npz)
    assert all(np.array_equal(got_npz[k], want_npz[k]) for k in want_npz)
    with pytest.raises(SystemExit, match="one target per"):
        convert_models.main(["--onnx", str(sv), "--map", "vad", "speaker", "--out", "x",
                             "--provider", "cpu"])


def test_export_models_files_equal_jax(tmp_path, pack, monkeypatch):
    """Every stage of a seeded pack and of a --checkpoint-dir pack: the
    JAX tool's files, byte for byte after the producer name."""
    from audio_classification_tpu_torch.train.checkpoint import save_model_pack

    ck = tmp_path / "ck"
    save_model_pack(pack, ck)
    written = export_models.main(["--out-dir", str(tmp_path / "port"), "--preset", "tiny",
                                  "--seconds", "0.5", "--provider", "cpu",
                                  "--checkpoint-dir", str(ck), "--seed", "3"])
    assert len(written) == 7
    monkeypatch.setattr(jax_runtime, "ModelPack", twin_pack_factory(pack))
    jax_export_models.main(["--out-dir", str(tmp_path / "jax"), "--preset", "tiny",
                            "--seconds", "0.5"])
    head = onnx_export._vi(1, 8)
    for path in written:
        name = path.rsplit("/", 1)[-1]
        got = open(path, "rb").read()
        want = open(tmp_path / "jax" / name, "rb").read()
        g = got[len(head + onnx_export._ld(2, onnx_export.PRODUCER.encode())):]
        w = want[len(head + onnx_export._ld(2, b"audio_classification_tpu")):]
        assert g == w, name


def _sv_graph_for(tmp_path, cfg, seed):
    model = SenseVoiceEncoder(cfg)
    from audio_classification_tpu_torch.train.trainer import flax_init_

    flax_init_(model, seed)
    path = sensevoice_mappable_graph(state_dict_to_variables(model), cfg,
                                     tmp_path / "init.onnx", frames=64)
    return path, model


def test_training_clis_init_and_export_onnx(tmp_path):
    """train_asr --init-onnx starts from the graph's weights (0 steps: the
    export equals them), --export-onnx (float and int8) runs on the port's
    executor; train_separator / train_speaker --export-onnx write graphs the
    executor runs as the trained modules."""
    cfg = dataclasses.replace(tiny_preset().asr, vocab_size=len(_ALPHABET) + 1)
    path, model = _sv_graph_for(tmp_path, cfg, seed=4)
    train_asr.main(["--synthetic", "--steps", "0", "--batch", "2", "--preset", "tiny",
                    "--provider", "cpu", "--init-onnx", path, "--export",
                    str(tmp_path / "asr")])
    sd = load_params(tmp_path / "asr")
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    for quant in ("none", "int8"):
        out = tmp_path / f"asr_{quant}.onnx"
        train_asr.main(["--synthetic", "--steps", "1", "--batch", "2", "--dim", "32",
                        "--heads", "2", "--layers", "1", "--conv-kernel", "3",
                        "--provider", "cpu", "--export-onnx", str(out),
                        "--export-quant", quant])
        m = OnnxModel(str(out), device="cpu")
        frames = m.graph.inputs[0].shape[1]
        logits = m(feats=np.zeros((1, frames, 560), np.float32),
                   language=np.zeros(1, np.int64))["logits"]
        assert logits.shape == (1, frames + 4, len(_ALPHABET) + 1)
        assert torch.isfinite(logits).all()
    c = tiny_preset().sep3
    sep_flags = ["--n-src", "3", "--sample-rate", "16000", "--enc-dim", str(c.enc_dim),
                 "--bottleneck", str(c.bottleneck), "--hidden", str(c.hidden),
                 "--n-blocks", str(c.n_blocks), "--n-repeats", str(c.n_repeats)]
    train_separator.main(["--synthetic", "--seconds", "0.25", "--batch", "2", "--steps", "1",
                          "--provider", "cpu", "--export", str(tmp_path / "sep"),
                          "--export-onnx", str(tmp_path / "sep.onnx"), *sep_flags])
    from audio_classification_tpu_torch.models.convtasnet import ConvTasNet

    sep = ConvTasNet(c)
    sep.load_state_dict(load_params(tmp_path / "sep"))
    mix = (0.3 * np.random.default_rng(1).standard_normal((1, 4000))).astype(np.float32)
    with torch.no_grad():
        ref = sep.eval()(torch.from_numpy(mix), torch.ones(1, 4000)).numpy()
    got = OnnxModel(str(tmp_path / "sep.onnx"), device="cpu")(mix=mix)["est"].numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4 * max(1.0, np.abs(ref).max()))
    train_speaker.main(["--synthetic", "--steps", "1", "--batch", "4", "--max-seconds", "0.5",
                        "--num-speakers", "4", "--channels", "8,16", "--embed-dim", "32",
                        "--provider", "cpu", "--export", str(tmp_path / "spk"),
                        "--export-onnx", str(tmp_path / "spk.onnx")])
    m = OnnxModel(str(tmp_path / "spk.onnx"), device="cpu")
    assert m.graph.inputs[0].shape[1] == 48 and m.output_names == ["emb"]


@pytest.fixture(scope="module")
def distill_set(tmp_path_factory):
    """A teacher export (a seeded 2-layer encoder at 1.2 s of frames), its
    64-symbol tokens.txt and a wav list of PCM16 bursts over noise."""
    root = tmp_path_factory.mktemp("kd")
    tok = root / "tokens.txt"
    tok.write_text("\n".join(["<blk> 0"] + [f"{ch} {i}" for i, ch in enumerate(_ALPHABET, 1)]
                             + [f"<unused{i}> {i}" for i in range(9, 64)]) + "\n",
                   encoding="utf-8")
    cfg = SenseVoiceConfig(vocab_size=64, dim=32, heads=2, layers=2, ffn_mult=2, conv_kernel=3)
    from audio_classification_tpu_torch.train.trainer import flax_init_

    teacher = flax_init_(SenseVoiceEncoder(cfg), 5)
    frames = cfg.out_frames(int(1.2 * SR)) - cfg.num_prompt
    onnx_export.export_sensevoice(state_dict_to_variables(teacher), cfg,
                                  str(root / "teacher.onnx"), frames=frames)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(6):
        n = int((0.7 + 0.1 * i) * SR)
        t = np.arange(n) / SR
        w = 0.2 * np.sin(2 * np.pi * (300 + 90 * i) * t) * (np.sin(2 * np.pi * 3 * t) > 0)
        w = (w + 0.01 * rng.standard_normal(n)).astype(np.float32)
        write_wav(root / f"u{i}.wav", w, SR)
        lines.append(str(root / f"u{i}.wav"))
    (root / "wavs.txt").write_text("\n".join(lines) + "\n")
    return root


STUDENT = ["--dim", "32", "--heads", "2", "--layers", "1", "--conv-kernel", "3",
           "--batch", "2", "--log-every", "100", "--max-seconds", "1.2"]


def test_distill_asr_losses_follow_the_jax_tool(distill_set, tmp_path, monkeypatch):
    """Three steps from the JAX init on the wav list, the same batches: the
    first loss within 1e-4 relative, the next ones within 1e-3 relative
    (Adam's first steps are lr * sign(g)); the student's weights after
    them within 3 lr of the JAX ones, 99% within lr / 10."""
    import jax

    from audio_classification_tpu.models.asr.sensevoice import (
        SenseVoiceConfig as JaxSVConfig, SenseVoiceEncoder as JaxSVEncoder)
    from audio_classification_tpu.train import trainer as jax_trainer_mod

    argv = ["--teacher-onnx", str(distill_set / "teacher.onnx"), "--tokens",
            str(distill_set / "tokens.txt"), "--manifest", str(distill_set / "wavs.txt"),
            "--steps", "3", "--lr", "5e-4", *STUDENT]
    rec = {"losses": []}
    orig_step = jax_trainer_mod.ModuleTrainer.train_step

    def jax_step(self, batch):
        loss = orig_step(self, batch)
        rec["losses"].append(float(loss))
        rec["trainer"] = self
        return loss

    monkeypatch.setattr(jax_trainer_mod.ModuleTrainer, "train_step", jax_step)
    jax_distill.main(argv + ["--data-parallel", "1"])
    jcfg = JaxSVConfig(vocab_size=64, dim=32, heads=2, layers=1, conv_kernel=3)
    init = JaxSVEncoder(jcfg).init(jax.random.PRNGKey(0),
                                   np.zeros((1, 5, jcfg.lfr_m * jcfg.num_mel), np.float32))
    losses = []

    def from_jax(cfg, seed):
        m = SenseVoiceEncoder(cfg)
        m.load_state_dict(variables_to_state_dict(init))
        return m

    monkeypatch.setattr(distill_asr, "make_student", from_jax)
    a0, a1 = distill_asr.main(argv + ["--provider", "cpu", "--export", str(tmp_path / "s")])
    losses = json.loads((tmp_path / "s" / "run.json").read_text())["losses"]
    assert len(losses) == len(rec["losses"]) == 3 and np.isfinite([a0, a1]).all()
    assert abs(losses[0] - rec["losses"][0]) <= 1e-4 * abs(rec["losses"][0])
    for g, w in zip(losses[1:], rec["losses"][1:]):
        assert abs(g - w) <= 1e-3 * abs(w)
    want = variables_to_state_dict(jax.device_get(rec["trainer"].state.params))
    got = load_params(tmp_path / "s")
    diffs = np.concatenate([np.abs(got[k].numpy() - want[k].numpy()).ravel() for k in want])
    assert diffs.max() <= 3 * 5e-4 and np.quantile(diffs, 0.99) <= 5e-5


def test_distill_asr_synthetic_resume_and_ctc(distill_set, tmp_path, capsys):
    """--synthetic with checkpoints, a resume from them and the CTC term;
    losses finite, the export loads into the student's architecture."""
    teacher = ["--teacher-onnx", str(distill_set / "teacher.onnx"), "--tokens",
               str(distill_set / "tokens.txt"), "--synthetic", "--provider", "cpu"]
    ck = str(tmp_path / "ck")
    a0, a1 = distill_asr.main(teacher + ["--steps", "2", "--ckpt-dir", ck, "--save-every",
                                         "1", "--ctc-weight", "0.3", "--export",
                                         str(tmp_path / "e")] + STUDENT)
    assert np.isfinite([a0, a1]).all()
    distill_asr.main(teacher + ["--steps", "3", "--ckpt-dir", ck, "--resume"] + STUDENT)
    out = capsys.readouterr().out
    assert "checkpoint @ step 1" in out and "resumed" in out and "at step 2" in out
    meta = json.loads((tmp_path / "e" / "run.json").read_text())
    assert np.isfinite(meta["losses"]).all()
    SenseVoiceEncoder(SenseVoiceConfig(vocab_size=64, dim=32, heads=2, layers=1,
                                       conv_kernel=3)).load_state_dict(load_params(tmp_path / "e"))
    # a mesh over several cards is one torchrun rank per card; in one
    # process the refusal names the command and the shard flag's one-card form
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2.*--seq-parallel"):
        distill_asr.main(teacher + ["--steps", "1", "--data-parallel", "2"] + STUDENT)
