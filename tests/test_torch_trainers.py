"""The port's SeparatorTrainer against the JAX package's from the JAX init
(CPU, float32, tiny widths): Conv-TasNet, MossFormer, and Conv-TasNet
time-sharded over 2 shards, 3 steps each (test_torch_module_trainers.py
holds ModuleTrainer to JAX's by the same rules).

Held: the loss at each step within 1e-4 relative; the step-0 gradients
within 1e-4 of max|grad| (over all of the model's parameters); the
weights after 3 steps within 2 lr x 3 of
the JAX weights (Adam's first steps are about lr * sign(g), and an element
whose gradient is near 0 may take the other sign) and, for 99 % of the
model's weights, within lr / 10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_tpu.models.convtasnet import ConvTasNetConfig as JaxTasNetConfig
from audio_classification_tpu.models.mossformer import MossFormerConfig as JaxMFConfig
from audio_classification_tpu.parallel.mesh import make_mesh as jax_make_mesh
from audio_classification_tpu.train import losses as jax_losses
from audio_classification_tpu.train.trainer import SeparatorTrainer as JaxSeparatorTrainer
from audio_classification_tpu_torch.cli.train_separator import synthetic_batch
from audio_classification_tpu_torch.convert.from_jax import variables_to_state_dict
from audio_classification_tpu_torch.models.convtasnet import ConvTasNetConfig
from audio_classification_tpu_torch.models.mossformer import MossFormerConfig
from audio_classification_tpu_torch.parallel.mesh import make_mesh
from audio_classification_tpu_torch.train.trainer import SeparatorTrainer

torch.set_num_threads(2)
LR = 1e-3
STEPS = 3


def _compare_grads(jax_grads, model):
    """Every parameter's gradient within 1e-4 of max|grad| over the model."""
    want = variables_to_state_dict(jax_grads)
    top = max(np.abs(want[name].numpy()).max() for name, _ in model.named_parameters())
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        assert np.abs(got - ref).max() <= 1e-4 * top, name


def _compare_weights(jax_params, model):
    """Each weight within lr x STEPS (about what STEPS Adam steps move a
    weight in one package: a tensor whose gradient is analytically 0, as a
    softmax key bias, takes lr-sized steps on rounding noise, 1.1 lr apart
    at most here), and 99 % of all of them (over the model) within lr / 10."""
    want = variables_to_state_dict(jax_params)
    diffs = []
    for name, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        assert diff.max() <= LR * STEPS, name
        diffs.append(diff.ravel())
    assert np.quantile(np.concatenate(diffs), 0.99) <= LR / 10


def _compare_losses(got, want):
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-4 * abs(w), (got, want)


# ------------------------------------------------------------- separators

_SEP_CASES = {
    "convtasnet": (dict(n_src=2, enc_dim=32, enc_kernel=16, bottleneck=16, hidden=32,
                        n_blocks=2, n_repeats=1, sample_rate=8000), False),
    "mossformer": (dict(n_src=2, enc_dim=32, enc_kernel=16, dim=24, qk_dim=16, layers=2,
                        sample_rate=8000), False),
    "convtasnet_time_shard": (dict(n_src=2, enc_dim=32, enc_kernel=16, bottleneck=16,
                                   hidden=32, n_blocks=2, n_repeats=1, sample_rate=8000), True),
}


@pytest.mark.parametrize("case", list(_SEP_CASES))
def test_separator_trainer_matches_jax(case):
    kw, time_shard = _SEP_CASES[case]
    arch = MossFormerConfig if case == "mossformer" else ConvTasNetConfig
    jarch = JaxMFConfig if case == "mossformer" else JaxTasNetConfig
    n = 2 if time_shard else 1
    jtr = JaxSeparatorTrainer(jarch(**kw), mesh=jax_make_mesh(n, model_axis=1), lr=LR, seed=0,
                              time_shard=time_shard)
    mesh = make_mesh(n, devices=["cpu"] * n) if time_shard else None
    tr = SeparatorTrainer(arch(**kw), mesh=mesh, lr=LR, seed=1, time_shard=time_shard,
                          device="cpu")
    tr.model.load_state_dict(variables_to_state_dict(jtr.state.params))
    rng = np.random.default_rng(3)
    batches = [synthetic_batch(rng, 2, 2, 800, 8000) for _ in range(STEPS)]
    mask = np.ones((2, 800), np.float32)
    mask[1, 610:] = 0.0  # a ragged item

    # step-0 gradients: the JAX loss function of the trainer, by jax.grad
    mix, refs = batches[0]
    if time_shard:
        from audio_classification_tpu.parallel.sp_convtasnet import sp_separate

        lengths = jnp.asarray(mask.sum(-1).astype(np.int32))

        def jloss(p):
            ests = sp_separate(p, jtr.cfg, jnp.asarray(mix), lengths, jtr.mesh, axis="data")
            return jax_losses.pit_si_sdr_loss(ests, jnp.asarray(refs), jnp.asarray(mask))
        jgrads = jax.jit(jax.grad(jloss))(jtr.state.params)
    else:
        def jloss(p):
            ests = jtr.model.apply(p, jnp.asarray(mix), jnp.asarray(mask))
            return jax_losses.pit_si_sdr_loss(ests, jnp.asarray(refs), jnp.asarray(mask))
        jgrads = jax.jit(jax.grad(jloss))(jtr.state.params)
    tr.loss(*(torch.from_numpy(a) for a in (mix, refs, mask))).backward()
    _compare_grads(jgrads, tr.model)
    tr.optimizer.zero_grad()

    want = [jtr.train_step(m, r, mask) for m, r in batches]
    got = [tr.train_step(m, r, mask) for m, r in batches]
    _compare_losses(got, want)
    _compare_weights(jtr.state.params, tr.model)
