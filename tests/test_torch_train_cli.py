"""The port's training CLIs on the CPU (--synthetic or a small manifest,
--provider cpu, tiny widths): train, checkpoint, resume, export; each export
loads through the serving flags (--sep-checkpoint / Separator(checkpoint=),
--sense-voice, --spk-embed-model); ONNX and several-card flags raise.
test_torch_orbax_convert.py holds the converter of JAX orbax checkpoints."""
import json

import numpy as np
import pytest
import torch

from audio_classification_tpu_torch.audio_io import write_wav
from audio_classification_tpu_torch.cli import train_asr, train_separator, train_speaker
from audio_classification_tpu_torch.engine.runtime import tiny_preset
from audio_classification_tpu_torch.models import facades
from audio_classification_tpu_torch.pipelines.offline_overlap3 import build_engine
from audio_classification_tpu_torch.train.checkpoint import load_params
from audio_classification_tpu_torch.utils.config import Overlap3Config

torch.set_num_threads(2)
SR = 16000


def _tiny_sep3_flags():
    c = tiny_preset().sep3
    return ["--n-src", "3", "--sample-rate", "16000", "--enc-dim", str(c.enc_dim),
            "--bottleneck", str(c.bottleneck), "--hidden", str(c.hidden),
            "--n-blocks", str(c.n_blocks), "--n-repeats", str(c.n_repeats)]


def _equal_weights(model, sd):
    return all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())


def _engine(**kw):
    return build_engine(Overlap3Config(preset="tiny", seed=0, provider="cpu", max_batch=2,
                                       max_segment_sec=2.0, **kw))


@pytest.fixture(scope="module")
def sep_export(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_sep")
    base = ["--synthetic", "--seconds", "0.25", "--batch", "2", "--log-every", "1",
            "--provider", "cpu", "--ckpt-dir", str(root / "ck"), *_tiny_sep3_flags()]
    before, after = train_separator.main([*base, "--steps", "2", "--save-every", "1",
                                          "--export", str(root / "export")])
    return root, base, before, after


def test_train_separator_resumes_and_exports(sep_export, capsys):
    root, base, before, after = sep_export
    assert np.isfinite(before) and np.isfinite(after)
    meta = json.loads((root / "export" / "run.json").read_text())
    assert meta["argv"]["steps"] == 2 and len(meta["losses"]) == 2
    assert all(np.isfinite(meta["losses"]))
    train_separator.main([*base, "--steps", "3", "--resume"])
    out = capsys.readouterr().out
    assert "resumed" in out and "at step 2" in out and "step     3" in out
    assert "held-out SI-SDRi after" in out


def test_separator_export_loads_through_the_serving_doors(sep_export):
    """--sep-checkpoint DIR (build_engine: the first separator stage whose
    shapes match, sep3 here) and Separator(checkpoint=DIR) carry the
    trained weights; another width fails loud."""
    root = sep_export[0]
    sd = load_params(root / "export")
    eng = _engine(sep_checkpoint=str(root / "export"))
    assert _equal_weights(eng.pack.models["sep3"], sd)
    sep = facades.Separator(checkpoint=str(root / "export"), n_src=3, engine=_engine())
    assert _equal_weights(sep.engine.pack.models["sep3"], sd)
    assert len(sep.separate(np.zeros(8000, np.float32) + 0.01, SR)) == 3
    other = root / "other"
    train_separator.main(["--synthetic", "--seconds", "0.25", "--batch", "1", "--steps", "1",
                          "--provider", "cpu", "--enc-dim", "16", "--bottleneck", "8",
                          "--hidden", "16", "--n-blocks", "2", "--n-repeats", "1",
                          "--export", str(other)])
    with pytest.raises(ValueError, match="matches none"):
        _engine(sep_checkpoint=str(other))


def test_mossformer_time_shard_export_loads(tmp_path):
    """--arch mossformer at the tiny preset's widths, time-sharded over 2
    shards of the card (here the CPU): the export serves the mossformer
    stage through both doors."""
    c = tiny_preset().mossformer
    export = tmp_path / "mf"
    train_separator.main(["--synthetic", "--seconds", "0.25", "--batch", "2", "--steps", "2",
                          "--provider", "cpu", "--arch", "mossformer", "--enc-dim",
                          str(c.enc_dim), "--mf-dim", str(c.dim), "--mf-qk-dim", str(c.qk_dim),
                          "--mf-layers", str(c.layers), "--time-shard", "--data-parallel", "2",
                          "--export", str(export)])
    sd = load_params(export)
    assert _equal_weights(_engine(sep_checkpoint=str(export)).pack.models["mossformer"], sd)
    sep = facades.Separator(backend="mossformer", checkpoint=str(export), engine=_engine())
    assert _equal_weights(sep.engine.pack.models["mossformer"], sd)


def test_train_asr_manifest_resume_export_serves(tmp_path, capsys):
    """A JSONL manifest of 6 tone 'utterances' and a 64-symbol token table
    (the tiny preset's vocab), SenseVoice at the tiny preset's widths;
    resume, then the export serves through --sense-voice."""
    rng = np.random.default_rng(0)
    letters = "abcdefgh"
    lines = []
    for i in range(6):
        word = "".join(rng.choice(list(letters), size=3))
        wav = np.concatenate([0.2 * np.sin(2 * np.pi * (300 + 40 * letters.index(ch))
                                           * np.arange(2400) / SR) for ch in word])
        write_wav(tmp_path / f"u{i}.wav", wav.astype(np.float32), SR)
        lines.append(json.dumps({"wav": str(tmp_path / f"u{i}.wav"), "text": word}))
    (tmp_path / "train.jsonl").write_text("\n".join(lines) + "\n")
    (tmp_path / "tokens.txt").write_text(
        "".join(f"{s} {i}\n" for i, s in enumerate(["<blk>"] + [chr(0x41 + i) for i in range(26)]
                                                    + [chr(0x61 + i) for i in range(26)]
                                                    + list("0123456789!"))))
    c = tiny_preset().asr
    base = ["--manifest", str(tmp_path / "train.jsonl"), "--tokens", str(tmp_path / "tokens.txt"),
            "--max-seconds", "0.5", "--batch", "2", "--provider", "cpu", "--log-every", "1",
            "--dim", str(c.dim), "--heads", str(c.heads), "--layers", str(c.layers),
            "--conv-kernel", str(c.conv_kernel), "--ckpt-dir", str(tmp_path / "ck")]
    c0, c1 = train_asr.main([*base, "--steps", "2", "--export", str(tmp_path / "asr")])
    assert 0.0 <= c0 and 0.0 <= c1
    train_asr.main([*base, "--steps", "3", "--resume"])
    assert "at step 2" in capsys.readouterr().out
    eng = _engine(sense_voice=str(tmp_path / "asr"), tokens=str(tmp_path / "tokens.txt"))
    assert _equal_weights(eng.pack.models["asr"], load_params(tmp_path / "asr"))


def test_train_asr_seq_parallel_and_speaker_export_serves(tmp_path):
    """train_asr --seq-parallel over 2 frame shards; train_speaker at the
    tiny preset's embedder widths, resumed, its export (embedder only, the
    AAM centres dropped) serving --spk-embed-model."""
    train_asr.main(["--synthetic", "--steps", "2", "--batch", "2", "--dim", "32", "--heads",
                    "2", "--layers", "1", "--conv-kernel", "3", "--provider", "cpu",
                    "--seq-parallel", "--data-parallel", "2"])
    base = ["--synthetic", "--batch", "4", "--max-seconds", "0.5", "--num-speakers", "4",
            "--provider", "cpu", "--ckpt-dir", str(tmp_path / "ck")]
    train_speaker.main([*base, "--steps", "2", "--export", str(tmp_path / "spk")])
    train_speaker.main([*base, "--steps", "3", "--resume"])
    sd = load_params(tmp_path / "spk")
    assert not any("aam_centers" in k for k in sd)
    eng = _engine(spk_embed_model=str(tmp_path / "spk"))
    assert _equal_weights(eng.pack.models["spk"], sd)


@pytest.mark.parametrize("cli,flags,slice_", [
    (train_asr, ["--model-parallel", "2"], "slice 16"),
    (train_asr, ["--slices", "2"], "slice 16"),
    (train_separator, ["--slices", "2"], "slice 16"),
    (train_speaker, ["--data-parallel", "2"], "slice 16"),
    (train_separator, ["--model-parallel", "2"], "slice 16"),
    (train_separator, ["--data-parallel", "2"], "slice 16"),
    (train_asr, ["--data-parallel", "2"], "slice 16"),
])
def test_unported_training_flags_raise(cli, flags, slice_):
    """What needs several cards raises (--init-onnx / --export-onnx work
    since the ONNX slice: tests/test_torch_onnx_cli.py)."""
    with pytest.raises(NotImplementedError, match=slice_):
        cli.main(["--synthetic", "--steps", "1", "--provider", "cpu", *flags])


def test_train_separator_on_a_librimix_tree_with_dynamic_mix(tmp_path, capsys):
    """--librimix-root over a Libri2Mix 'dev' split at 8 kHz (three seeded
    two-talker mixtures), with and without --dynamic-mix: the crops come
    from the corpus and the gate line is printed."""
    rng = np.random.default_rng(3)
    base = tmp_path / "Libri2Mix" / "wav8k" / "min" / "dev"
    for sub in ("mix_clean", "s1", "s2"):
        (base / sub).mkdir(parents=True)
    for m in range(3):
        t = np.arange(3000 + 500 * m) / 8000
        srcs = [0.2 * np.sin(2 * np.pi * (150 + 200 * i + 30 * m) * t)
                + 0.01 * rng.standard_normal(t.size) for i in range(2)]
        for i, s in enumerate(srcs):
            write_wav(base / f"s{i + 1}" / f"m{m}.wav", s.astype(np.float32), 8000)
        write_wav(base / "mix_clean" / f"m{m}.wav", np.sum(srcs, axis=0).astype(np.float32), 8000)
    for extra in ([], ["--dynamic-mix"]):
        before, after = train_separator.main([
            "--librimix-root", str(tmp_path), "--subset", "dev", "--seconds", "0.25",
            "--batch", "2", "--steps", "2", "--provider", "cpu", "--enc-dim", "16",
            "--bottleneck", "8", "--hidden", "16", "--n-blocks", "2", "--n-repeats", "1", *extra])
        assert np.isfinite(before) and np.isfinite(after)
    assert capsys.readouterr().out.count("held-out SI-SDRi after") == 2


def test_train_asr_cmvn_reaches_the_frontend(tmp_path):
    """--cmvn am.mvn (LFR dim 560) normalises the training features: the
    same seed with and without it takes different first losses."""
    from torch_port_helpers import write_am_mvn

    rng = np.random.default_rng(1)
    write_am_mvn(tmp_path / "am.mvn", -rng.uniform(5, 15, 560), rng.uniform(0.1, 0.5, 560))
    losses = []
    for extra in ([], ["--cmvn", str(tmp_path / "am.mvn")]):
        ck = tmp_path / f"ck{len(extra)}"
        train_asr.main(["--synthetic", "--steps", "1", "--batch", "2", "--dim", "32", "--heads",
                        "2", "--layers", "1", "--conv-kernel", "3", "--provider", "cpu",
                        "--ckpt-dir", str(ck), *extra])
        losses.append(json.loads((ck / "run.json").read_text())["losses"][0])
    assert all(np.isfinite(losses)) and losses[0] != losses[1]
