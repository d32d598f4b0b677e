"""The port's ModuleTrainer against the JAX package's from the JAX init (CPU,
float32, tiny widths): SenseVoice CTC, OSD frame BCE and speaker AAM
softmax, 3 steps each, held as test_torch_trainers.py holds the separator
trainer (losses within 1e-4 relative, step-0 gradients within 1e-4 of
max|grad|, weights within the lr-scaled bounds)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from audio_classification_tpu.models.asr.ctc import ctc_loss as jax_ctc_loss
from audio_classification_tpu.models.asr.sensevoice import (
    SenseVoiceConfig as JaxSVConfig,
    SenseVoiceEncoder as JaxSV,
    sensevoice_frontend as jax_sv_frontend,
)
from audio_classification_tpu.models.osd import OSDConfig as JaxOSDConfig, OSDNet as JaxOSD
from audio_classification_tpu.models.speaker import (
    SpeakerEmbedder as JaxEmbedder,
    SpeakerEmbedderConfig as JaxSpkConfig,
)
from audio_classification_tpu.parallel.mesh import make_mesh as jax_make_mesh
from audio_classification_tpu.train import losses as jax_losses
from audio_classification_tpu.train.trainer import ModuleTrainer as JaxModuleTrainer
from audio_classification_tpu_torch.cli.train_asr import SyntheticSampler
from audio_classification_tpu_torch.cli.train_speaker import embedder_with_head
from audio_classification_tpu_torch.convert.from_jax import variables_to_state_dict
from audio_classification_tpu_torch.models.asr.ctc import ctc_loss
from audio_classification_tpu_torch.models.asr.sensevoice import (
    SenseVoiceConfig,
    SenseVoiceEncoder,
    sensevoice_frontend,
)
from audio_classification_tpu_torch.models.asr.tokens import TokenTable
from audio_classification_tpu_torch.models.osd import OSDConfig, OSDNet
from audio_classification_tpu_torch.models.speaker import SpeakerEmbedderConfig
from audio_classification_tpu_torch.train.losses import aam_softmax_loss, frame_bce_loss
from audio_classification_tpu_torch.train.trainer import ModuleTrainer
from test_torch_trainers import LR, STEPS, _compare_grads, _compare_losses, _compare_weights

torch.set_num_threads(2)


def _sensevoice_case():
    tokens = TokenTable.char_table("abcdefgh")
    kw = dict(vocab_size=tokens.vocab_size, dim=32, heads=2, layers=1, conv_kernel=3)
    sampler = SyntheticSampler(tokens, np.random.default_rng(5))
    batches = [sampler.batch(2)[0] for _ in range(STEPS)]
    # a noise floor: on digital silence the two frontends' log-mel floors
    # differ (float32 cancellation), which is not what this test is about
    noise = np.random.default_rng(9)
    for b in batches:
        b["wav"] += (1e-3 * noise.standard_normal(b["wav"].shape)).astype(np.float32)
    jcfg, cfg = JaxSVConfig(**kw), SenseVoiceConfig(**kw)
    jmodel = JaxSV(jcfg)
    feats0, mask0 = jax_sv_frontend(jnp.asarray(batches[0]["wav"]),
                                    jnp.asarray(batches[0]["lens"]), jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), feats0, mask0)

    def jloss(apply_fn, p, b):
        feats, mask = jax_sv_frontend(b["wav"], b["lens"], jcfg)
        logits = apply_fn(p, feats, mask)[:, jcfg.num_prompt:]
        return jax_ctc_loss(logits, mask.astype(jnp.float32), b["labels"], b["lab_lens"])

    def tloss(module, b):
        feats, mask = sensevoice_frontend(b["wav"], b["lens"], cfg)
        logits = module(feats, mask)[:, cfg.num_prompt:]
        return ctc_loss(logits, mask, b["labels"], b["lab_lens"])

    return jmodel, params, jloss, SenseVoiceEncoder(cfg), tloss, batches


def _osd_case():
    kw = dict(dim=32, heads=2, layers=1)
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(STEPS):
        feats = rng.standard_normal((2, 40, 80)).astype(np.float32)
        labels = np.repeat((feats.mean(-1)[:, ::4] > 0).astype(np.float32)[..., None], 2, -1)
        mask = np.ones((2, 40), bool)
        mask[1, 29:] = False
        batches.append({"feats": feats, "labels": labels, "mask": mask})
    jmodel = JaxOSD(JaxOSDConfig(**kw))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batches[0]["feats"][:1]))

    def jloss(apply_fn, p, b):
        probs = apply_fn(p, b["feats"], b["mask"])
        return jax_losses.frame_bce_loss(probs, b["labels"], jnp.ones(probs.shape[:2]))

    def tloss(module, b):
        probs = module(b["feats"], b["mask"])
        return frame_bce_loss(probs, b["labels"], torch.ones(probs.shape[:2]))

    return jmodel, params, jloss, OSDNet(OSDConfig(**kw)), tloss, batches


class _JaxEmbedderWithHead(nn.Module):
    """cli/train_speaker's module: the embedder and the AAM centres."""

    cfg: JaxSpkConfig
    n_spk: int

    @nn.compact
    def __call__(self, feats):
        emb = JaxEmbedder(self.cfg, name="embedder")(feats)
        return emb, self.param("aam_centers", nn.initializers.normal(1.0),
                               (self.n_spk, self.cfg.embed_dim))


def _speaker_case():
    kw = dict(channels=(4, 8), embed_dim=16)
    rng = np.random.default_rng(7)
    batches = [{"feats": rng.standard_normal((4, 40, 80)).astype(np.float32),
                "labels": rng.integers(0, 4, size=4).astype(np.int64)} for _ in range(STEPS)]
    jmodel = _JaxEmbedderWithHead(JaxSpkConfig(**kw), 4)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batches[0]["feats"][:1]))
    stats = {k: v for k, v in variables.items() if k != "params"}

    def jloss(apply_fn, p, b):
        emb, w = apply_fn({**p, **stats}, b["feats"])
        return jax_losses.aam_softmax_loss(emb, b["labels"], w, margin=0.2, scale=30.0)

    def tloss(module, b):
        emb, w = module(b["feats"])
        return aam_softmax_loss(emb, b["labels"], w, margin=0.2, scale=30.0)

    module = embedder_with_head(SpeakerEmbedderConfig(**kw), 4)
    module.load_state_dict(variables_to_state_dict(variables))
    return jmodel, {"params": variables["params"]}, jloss, module, tloss, batches


@pytest.mark.parametrize("case", ["sensevoice_ctc", "osd_bce", "speaker_aam"])
def test_module_trainer_matches_jax(case):
    jmodel, params, jloss, module, tloss, batches = {
        "sensevoice_ctc": _sensevoice_case, "osd_bce": _osd_case,
        "speaker_aam": _speaker_case}[case]()
    if case != "speaker_aam":
        module.load_state_dict(variables_to_state_dict(params))
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    jgrads = jax.jit(jax.grad(lambda p: jloss(jmodel.apply, p, jbatches[0])))(params)
    tr = ModuleTrainer(module, tloss, lr=LR, device="cpu")
    tloss(module, {k: torch.from_numpy(np.asarray(v)) for k, v in batches[0].items()}).backward()
    _compare_grads(jgrads, module)
    tr.optimizer.zero_grad()

    jtr = JaxModuleTrainer(jmodel, params, jloss, mesh=jax_make_mesh(1, model_axis=1), lr=LR,
                           shard_batch=False)
    want = [jtr.train_step(b) for b in jbatches]
    got = [tr.train_step(b) for b in batches]
    _compare_losses(got, want)
    _compare_weights(jtr.state.params, module)
