"""The port's quality gate (pipelines/quality_gate) against the JAX package's,
on the CPU: the world's host functions bit-equal from the same rng, the
world preset equal field by field, and train_world_pack from the JAX init:
both packages draw the same batches from one numpy stream, so each stage's
losses agree within 1e-4 relative and its trained weights within the
trainer rule of test_torch_trainers.py (every weight within 2 lr a step of
the JAX weight, 99 % within a tenth of the largest lr). The eval half and the
port-only runs are in test_torch_quality_gate_eval.py.

The JAX side runs at a steps_scale of 0.001 (1 step a stage, 2 for ASR),
its flax inits jitted and its ModelPack replaced by a recorder (the weights
are read from the trainers): both only save compile time, neither changes
what is trained.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

import audio_classification_tpu.engine as jax_engine
import audio_classification_tpu.train.trainer as jax_trainer
import audio_classification_tpu_torch.pipelines.quality_gate as qg
from audio_classification_tpu.pipelines import quality_gate as jqg
from audio_classification_tpu_torch.convert.from_jax import variables_to_state_dict
from audio_classification_tpu_torch.train.trainer import warmup_cosine

torch.set_num_threads(2)
SCALE = 0.001


# ------------------------------------------------------------ host functions

@pytest.mark.parametrize("seed", [0, 7, 424242])
def test_world_host_functions_bit_equal_to_jax(seed):
    """say / rand_word from the same rng: equal samples, equal words and the
    streams left in the same state."""
    r_port, r_jax = np.random.default_rng(seed), np.random.default_rng(seed)
    for spk in range(qg.N_SPK):
        for lo, hi in ((2, 4), (6, 6), (3, 12)):
            w_port, w_jax = qg.rand_word(r_port, lo, hi), jqg.rand_word(r_jax, lo, hi)
            assert w_port == w_jax
            a, b = qg.say(r_port, spk, w_port), jqg.say(r_jax, spk, w_jax)
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    assert r_port.random() == r_jax.random()
    assert (qg.SR, qg.ALPHABET, qg.TONE_MS, qg.N_SPK) == (jqg.SR, jqg.ALPHABET, jqg.TONE_MS,
                                                          jqg.N_SPK)


def test_span_truth_rule():
    """The JAX test's cases (letters are 250 ms; >= 50 % of a slot inside
    the span counts), then random spans against the JAX function."""
    assert qg.span_truth("abcd", 0.0, 1.0) == "abcd"
    assert qg.span_truth("abcd", 0.0, 0.624) == "ab"    # c has 49.6% coverage
    assert qg.span_truth("abcd", 0.0, 0.626) == "abc"   # c has 50.4%
    assert qg.span_truth("abcd", 0.13, 0.9) == "bcd"
    assert qg.span_truth("ab", 2.0, 3.0) == ""          # span past the word
    rng = np.random.default_rng(3)
    for _ in range(200):
        word = jqg.rand_word(rng, 1, 12)
        a = rng.uniform(-0.5, 3.0)
        b = a + rng.uniform(0.0, 3.0)
        frac = rng.choice([0.5, 0.25, 0.75])
        assert qg.span_truth(word, a, b, frac) == jqg.span_truth(word, a, b, frac)


def test_world_configs_equal_field_by_field():
    pp, pt = qg.world_configs()
    jp, jt = jqg.world_configs()
    assert dataclasses.asdict(pp) == dataclasses.asdict(jp)
    assert pp.asr_branch_norm == "peak" and pp.asr.utt_cmvn
    assert (pp.asr.fbank.frame_length_ms, pp.asr.fbank.num_bins) == (64.0, 128)
    assert pt.id_to_sym == jt.id_to_sym and pt.blank_id == jt.blank_id


# -------------------------------------------------------------- training half

class _Recorder:
    """What a JAX trainer saw: its initial variables and its step losses."""

    def __init__(self):
        self.init, self.losses, self.final = {}, {}, {}


def _jax_recording_trainers(monkeypatch, rec):
    """The JAX trainers, recording their initial variables, step losses and
    final variables under the stage they train (told apart by their order
    of construction: osd, spk, asr)."""
    order = iter(["osd", "spk", "asr"])

    class Sep(jax_trainer.SeparatorTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.stage = "sep"
            rec.init["sep"] = jax.tree.map(np.asarray, self.state.params)
            rec.losses["sep"] = []

        def train_step(self, *a):
            loss = super().train_step(*a)
            rec.losses[self.stage].append(loss)
            rec.final[self.stage] = jax.tree.map(np.asarray, self.state.params)
            return loss

    class Module(jax_trainer.ModuleTrainer):
        def __init__(self, module, params, *a, **k):
            super().__init__(module, params, *a, **k)
            self.stage = next(order)
            rec.init[self.stage] = jax.tree.map(np.asarray, params)
            rec.losses[self.stage] = []

        def train_step(self, batch):
            loss = super().train_step(batch)
            rec.losses[self.stage].append(loss)
            rec.final[self.stage] = jax.tree.map(np.asarray, self.state.params)
            return loss

    monkeypatch.setattr(jax_trainer, "SeparatorTrainer", Sep)
    monkeypatch.setattr(jax_trainer, "ModuleTrainer", Module)

    class Pack:  # the pack the JAX function assembles: not needed here
        def __init__(self, *a, **k):
            pass

        def load_params(self, name, params):
            pass

    monkeypatch.setattr(jax_engine, "ModelPack", Pack)
    monkeypatch.setattr(jax_engine, "StageEngine", lambda pack, *a, **k: pack)
    orig_init = nn.Module.init

    def jit_init(self, rngs, *args, **kw):
        return jax.jit(lambda r, *a: orig_init(self, r, *a, **kw))(rngs, *args)

    monkeypatch.setattr(nn.Module, "init", jit_init)


def _port_from_jax_init(monkeypatch, rec, got):
    """The port's stage trainers, started from the JAX init and recording
    their step losses."""
    def wrap(stage, make):
        def build(*a, **k):
            tr = make(*a, **k)
            tr.model.load_state_dict(variables_to_state_dict(rec.init[stage]))
            got[stage] = (tr, [])
            step = tr.train_step

            def train_step(*args):
                loss = step(*args)
                got[stage][1].append(loss)
                return loss

            tr.train_step = train_step
            if stage == "sep":  # the separator-in-the-loop forwards of the ASR batches
                got["sep_in_loop"] = 0

                def count(*_):
                    got["sep_in_loop"] += not torch.is_grad_enabled()

                tr.model.register_forward_hook(count)
            return tr
        return build

    for stage in ("sep", "osd", "spk", "asr"):
        name = f"{stage}_stage_trainer"
        monkeypatch.setattr(qg, name, wrap(stage, getattr(qg, name)))


@pytest.fixture(scope="module")
def trained():
    mp = pytest.MonkeyPatch()
    rec, got = _Recorder(), {}
    try:
        _jax_recording_trainers(mp, rec)
        _, _, jlosses = jqg.train_world_pack(SCALE, seed=0, log=lambda *_: None)
        _port_from_jax_init(mp, rec, got)
        engine, _, losses = qg.train_world_pack(SCALE, seed=0, log=lambda *_: None,
                                                device="cpu")
    finally:
        mp.undo()
    return rec, got, jlosses, losses, engine


def test_train_world_pack_losses_match_jax(trained):
    rec, got, jlosses, losses, _ = trained
    assert sorted(losses) == sorted(jlosses) == ["asr_final_loss", "osd_final_loss",
                                                 "sep_final_loss", "spk_final_loss"]
    steps = {"sep": 1, "osd": 1, "spk": 1, "asr": 2}  # round(base * 0.001), at least 1
    for stage, n in steps.items():
        want, mine = rec.losses[stage], got[stage][1]
        assert len(want) == len(mine) == n, (stage, want, mine)
        for w, g in zip(want, mine):
            assert abs(g - w) <= 1e-4 * abs(w), (stage, want, mine)
        assert losses[f"{stage}_final_loss"] == mine[-1]
    # the ASR batches (init draw + 2 steps) held separated rows: the losses
    # above cover the separator-in-the-loop path
    assert got["sep_in_loop"] >= 1


@pytest.mark.parametrize("stage", ["sep", "osd", "spk", "asr"])
def test_train_world_pack_weights_match_jax(trained, stage):
    """PR 13's trainer rule (test_torch_trainers.py) with the stage's own
    lr: Adam's first steps move a weight by about lr * sign(g), and an
    element whose gradient is near 0 may step the other way in one package
    (|difference| up to 2 lr a step; with one separator step, one such
    element of the bottleneck conv is 1.8 lr apart), so each weight is
    within 2 lr a step of the JAX weight, and 99 % of them within a tenth of
    the largest lr (the speaker stage's BatchNorm statistics are trained as
    weights, as the JAX gate trains its whole variable tree)."""
    rec, got, _, _, _ = trained
    tr, losses = got[stage]
    lr = {"sep": [5e-4], "osd": [3e-4], "spk": [3e-4],
          "asr": [warmup_cosine(1e-3, 2)(i) for i in range(2)]}[stage]
    lrs = (lr * len(losses))[: len(losses)] if stage != "asr" else lr
    want = variables_to_state_dict(rec.final[stage])
    diffs = []
    for name, p in tr.model.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        assert diff.max() <= 2 * sum(lrs), (stage, name, diff.max())
        diffs.append(diff.ravel())
    assert np.quantile(np.concatenate(diffs), 0.99) <= max(lrs) / 10
    if stage == "spk":
        names = {n for n, _ in tr.model.named_parameters()}
        assert any(n.endswith("running_var") for n in names)


def test_train_world_pack_assembles_the_pack(trained):
    """Each stage's trained weights are in the returned engine's pack
    (the speaker stage without its AAM centres)."""
    _, got, _, _, engine = trained
    for stage, key in (("sep", "sep3"), ("osd", "osd"), ("asr", "asr")):
        mine = got[stage][0].model.state_dict()
        for name, v in engine.pack.models[key].state_dict().items():
            assert torch.equal(v, mine[name]), (stage, name)
    spk = got["spk"][0].model.state_dict()
    for name, v in engine.pack.models["spk"].state_dict().items():
        assert torch.equal(v, spk[f"embedder.{name}"]), name
    assert engine.pack.device.type == "cpu"


def test_quality_gate_needs_the_card_or_the_cpu_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qg.train_world_pack(SCALE, log=lambda *_: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qg.build_world_engine(0)
    from audio_classification_tpu_torch.cli import quality_gate as cli

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--steps-scale", "0.001", "--scenes", "1"])
