"""The port's training pieces against the JAX package (CPU, float32): the
four losses and the CTC loss (values within 1e-6 relative, gradients within
1e-5 of max|grad|), the warmup-cosine schedule against optax at every step
(1e-9 relative, optax in 64-bit), one clipped Adam update against optax
(1e-7 of max|param|, the clip on and off), and save / restore / continue
equal to an uninterrupted run, exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_classification_tpu.models.asr.ctc import ctc_loss as jax_ctc_loss
from audio_classification_tpu.train import losses as jax_losses
from audio_classification_tpu.train.trainer import make_optimizer as jax_make_optimizer
from audio_classification_tpu.train.trainer import warmup_cosine as jax_warmup_cosine
from audio_classification_tpu_torch.models.asr.ctc import ctc_loss
from audio_classification_tpu_torch.train import losses
from audio_classification_tpu_torch.train.trainer import (
    ClippedAdam,
    ModuleTrainer,
    SeparatorTrainer,
    warmup_cosine,
)

torch.set_num_threads(2)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _check(jfn, tfn, diff_args, const_args=(), value_tol=1e-6, grad_tol=1e-5):
    """jfn / tfn(*diff_args, *const_args) -> scalar: values and the
    gradients for every differentiable argument."""
    ref = float(jfn(*map(jnp.asarray, diff_args), *map(jnp.asarray, const_args)))
    jgrads = jax.grad(lambda *a: jfn(*a, *map(jnp.asarray, const_args)),
                      argnums=tuple(range(len(diff_args))))(*map(jnp.asarray, diff_args))
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in diff_args]
    got = tfn(*leaves, *(torch.from_numpy(np.asarray(a).copy()) for a in const_args))
    got.backward()
    got = float(got.detach())
    assert abs(got - ref) <= value_tol * abs(ref), (got, ref)
    for leaf, jg in zip(leaves, jgrads):
        jg = np.asarray(jg)
        assert np.abs(leaf.grad.numpy() - jg).max() <= grad_tol * np.abs(jg).max()


def test_si_sdr_loss_matrix_matches_jax():
    refs, ests = _arrays(0, (2, 3, 400), (2, 3, 400))
    mask = (np.arange(400)[None, :] < np.array([400, 313])[:, None]).astype(np.float32)
    w = _arrays(1, (2, 3, 3))[0]
    _check(lambda r, e, m: jnp.sum(jax_losses.si_sdr_loss_matrix(r, e, m) * w),
           lambda r, e, m: (losses.si_sdr_loss_matrix(r, e, m) * torch.from_numpy(w)).sum(),
           (refs, ests), (mask,))


def test_pit_si_sdr_loss_matches_jax():
    """Two sources out of three estimates (6 assignments), ragged mask."""
    refs, ests = _arrays(2, (3, 2, 300), (3, 3, 300))
    ests[:, :2] += 0.8 * refs  # a clear best assignment in each item
    mask = (np.arange(300)[None, :] < np.array([300, 250, 128])[:, None]).astype(np.float32)
    _check(lambda e, r, m: jax_losses.pit_si_sdr_loss(e, r, m), losses.pit_si_sdr_loss,
           (ests, refs), (mask,))


def test_frame_bce_loss_matches_jax():
    logits, = _arrays(3, (2, 40, 2))
    probs = 1.0 / (1.0 + np.exp(-logits))
    labels = (np.random.default_rng(4).random((2, 40, 2)) > 0.5).astype(np.float32)
    mask = (np.arange(40)[None, :] < np.array([40, 27])[:, None]).astype(np.float32)
    _check(jax_losses.frame_bce_loss, losses.frame_bce_loss, (probs,), (labels, mask))


def test_aam_softmax_loss_matches_jax():
    emb, w = _arrays(5, (6, 16), (4, 16))
    labels = np.array([0, 1, 2, 3, 1, 0], np.int64)
    _check(lambda e, w_, lab: jax_losses.aam_softmax_loss(e, lab, w_, margin=0.2, scale=30.0),
           lambda e, w_, lab: losses.aam_softmax_loss(e, lab, w_, margin=0.2, scale=30.0),
           (emb, w), (labels,))


def test_ctc_loss_matches_jax():
    """Mean of per-sequence NLLs (not torch's length-normalised mean), frames
    (20, 15, 11), labels of 5, 3 and 1 symbols with repeats."""
    logits, = _arrays(6, (3, 20, 8))
    mask = (np.arange(20)[None, :] < np.array([20, 15, 11])[:, None]).astype(np.float32)
    labels = np.array([[1, 2, 2, 3, 1], [4, 4, 5, 0, 0], [7, 0, 0, 0, 0]], np.int32)
    lab_lens = np.array([5, 3, 1], np.int32)
    _check(lambda lg, m, lab, ll: jax_ctc_loss(lg, m, lab, ll),
           lambda lg, m, lab, ll: ctc_loss(lg, m, lab, ll), (logits,), (mask, labels, lab_lens))


def test_ctc_loss_infeasible_label_is_inf_where_optax_is_finite():
    """Five symbols with two repeats need 7 frames; given 4, no alignment
    exists. optax answers a large finite NLL (its log_epsilon is -1e5),
    torch's CTC ``inf`` (zero_infinity stays off, as ROADMAP section 3
    records)."""
    logits, = _arrays(7, (1, 4, 6))
    mask = np.ones((1, 4), np.float32)
    labels = np.array([[1, 1, 2, 3, 3]], np.int32)
    lens = np.array([5], np.int32)
    ref = float(jax_ctc_loss(jnp.asarray(logits), jnp.asarray(mask), jnp.asarray(labels),
                             jnp.asarray(lens)))
    got = float(ctc_loss(*(torch.from_numpy(a) for a in (logits, mask, labels, lens))))
    assert np.isfinite(ref) and ref > 1e4
    assert got == float("inf")


def test_warmup_cosine_matches_optax_every_step():
    """Every update index of a 50-step schedule and past its end; optax
    evaluated in 64-bit, so the comparison is of the functions."""
    ours = warmup_cosine(5e-4, 50)
    with jax.enable_x64(True):
        theirs = jax_warmup_cosine(5e-4, 50)
        ref = [float(theirs(jnp.asarray(i, jnp.int64))) for i in range(56)]
    assert ours(0) == pytest.approx(5e-4 / 25, rel=1e-12)
    for i, r in enumerate(ref):
        assert abs(ours(i) - r) <= 1e-9 * abs(r), (i, ours(i), r)


@pytest.mark.parametrize("scale", [0.1, 10.0], ids=["below_clip", "clipped"])
def test_clipped_adam_update_matches_optax(scale):
    """One update of clip_by_global_norm(5) + adam(1e-3) from zero moments,
    with the gradients' global norm below the clip and far above it."""
    a, b, ga, gb = _arrays(8, (5, 7), (7,), (5, 7), (7,))
    ga, gb = ga * scale, gb * scale
    params = {"a": jnp.asarray(a), "b": jnp.asarray(b)}
    tx = jax_make_optimizer(1e-3, clip=5.0)
    upd, _ = tx.update({"a": jnp.asarray(ga), "b": jnp.asarray(gb)}, tx.init(params), params)
    ref = optax.apply_updates(params, upd)
    pa, pb = torch.nn.Parameter(torch.from_numpy(a)), torch.nn.Parameter(torch.from_numpy(b))
    opt = ClippedAdam([pa, pb], lr=1e-3, clip=5.0)
    pa.grad, pb.grad = torch.from_numpy(ga), torch.from_numpy(gb)
    opt.step()
    top = max(np.abs(a).max(), np.abs(b).max())
    for p, r in ((pa, ref["a"]), (pb, ref["b"])):
        assert np.abs(p.detach().numpy() - np.asarray(r)).max() <= 1e-7 * top


def _tiny_tasnet():
    from audio_classification_tpu_torch.models.convtasnet import ConvTasNetConfig

    return ConvTasNetConfig(n_src=2, enc_dim=16, enc_kernel=16, bottleneck=8, hidden=16,
                            n_blocks=2, n_repeats=1, sample_rate=8000)


def _sep_batches(n, seed=0):
    from audio_classification_tpu_torch.cli.train_separator import synthetic_batch

    rng = np.random.default_rng(seed)
    return [synthetic_batch(rng, 2, 2, 800, 8000) for _ in range(n)]


def test_separator_save_restore_continue_equals_uninterrupted(tmp_path):
    """Two steps, save, two more; a trainer of another seed restored from
    the save takes the same two steps to the same losses and weights,
    exactly (CPU)."""
    batches = _sep_batches(4)
    live = SeparatorTrainer(_tiny_tasnet(), lr=1e-3, seed=0, device="cpu")
    for mix, refs in batches[:2]:
        live.train_step(mix, refs, np.ones_like(mix))
    live.save(tmp_path / "ck")
    want = [live.train_step(mix, refs, np.ones_like(mix)) for mix, refs in batches[2:]]
    resumed = SeparatorTrainer(_tiny_tasnet(), lr=1e-3, seed=7, device="cpu")
    assert resumed.restore(tmp_path / "ck") == 2
    got = [resumed.train_step(mix, refs, np.ones_like(mix)) for mix, refs in batches[2:]]
    assert got == want and resumed.step == live.step == 4
    for (name, p), q in zip(live.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(p, q), name
    assert resumed.optimizer.count == live.optimizer.count == 4


def test_module_trainer_keeps_batchnorm_on_its_init_statistics():
    """The module stays in eval(): a speaker embedder's BatchNorm normalises
    by its running statistics, which training does not move, and only
    parameters reach Adam."""
    from audio_classification_tpu_torch.models.speaker import (
        SpeakerEmbedder,
        SpeakerEmbedderConfig,
    )
    from audio_classification_tpu_torch.train.trainer import flax_init_

    model = flax_init_(SpeakerEmbedder(SpeakerEmbedderConfig(channels=(4, 8), embed_dim=8)), 0)
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    tr = ModuleTrainer(model, lambda m, b: (m(b["feats"]) ** 2).mean(), lr=1e-2, device="cpu")
    tr.train_step({"feats": np.random.default_rng(0).standard_normal((3, 24, 80))
                   .astype(np.float32)})
    assert not model.training
    for k, v in model.named_buffers():
        assert torch.equal(v, buffers[k]), k
    assert len(tr.optimizer.params) == len(list(model.parameters()))


def test_separator_loss_is_float64_through_in_float64():
    """A Conv-TasNet (the dense loop the trainer trains) and its PIT SI-SDR
    loss keep float64 inputs in float64 throughout: the norms' statistics
    and the decoder, float32 for float32 and bf16 inputs, widen to the
    input's dtype. gradcheck in float64 on the mixture and on weights of
    the decoder and the norms holds it (a float32 step on the path puts the
    analytic gradient ~1e-7 relative off, past gradcheck's bounds)."""
    import dataclasses

    model = SeparatorTrainer(dataclasses.replace(_tiny_tasnet(), enc_dim=8, bottleneck=4,
                                                 hidden=8),
                             seed=0, device="cpu").model.double()
    rng = np.random.default_rng(3)
    refs = torch.from_numpy(0.3 * rng.standard_normal((2, 2, 64)))
    mask = torch.ones((2, 64), dtype=torch.float64)
    mask[1, 50:] = 0.0
    names = ("decoder", "ln_in.gamma", "tcn_0_1.norm2.gamma", "mask_conv.weight")
    params = dict(model.named_parameters())
    inputs = [torch.from_numpy(0.3 * rng.standard_normal((2, 64))).requires_grad_(),
              *(params[n].detach().clone().requires_grad_() for n in names)]

    def loss(mix, *ws):
        ests = torch.func.functional_call(model, dict(zip(names, ws)), (mix, mask))
        return losses.pit_si_sdr_loss(ests, refs, mask)

    assert torch.autograd.gradcheck(loss, inputs)
