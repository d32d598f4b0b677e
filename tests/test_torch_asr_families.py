"""PyTorch port vs the JAX package: the Paraformer, transducer (greedy and
modified beam search) and whisper-style ASR models (tiny preset, CPU).

Weights come from the JAX ModelPack through convert/from_jax.py, inputs
from a numpy seed. Each model is held to the JAX model (encoder outputs and
logits to a share of their peak, token ids exactly), CIF and the beam search
to their JAX functions, int8 per family to the JAX int8 model, and the
K3 / K5 head-dim rule (zero-pad D to the kernel's instance, scale by the
true D) to the JAX kernels in interpret mode. The engines, runners,
streaming and serving with a family are in test_torch_asr_families_engine.py.

A 64-symbol token table makes every id of the tiny 65-word vocabulary a
character, so a text compares every decoded id.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_tpu.engine import ModelPack as JaxModelPack
from audio_classification_tpu.engine import tiny_preset as jax_tiny_preset
from audio_classification_tpu.models.asr import beam as jax_beam
from audio_classification_tpu.models.asr.paraformer import cif_integrate as jax_cif
from audio_classification_tpu.models.asr.paraformer import paraformer_frontend as jax_pf_frontend
from audio_classification_tpu.models.asr.tokens import TokenTable as JaxTokenTable
from audio_classification_tpu.models.asr.transducer import Transducer as JaxTransducer
from audio_classification_tpu.models.asr.whisper_style import WhisperStyle as JaxWhisper
from audio_classification_tpu.ops.pallas import attention_kernel as jax_attention
from audio_classification_tpu_torch.convert.from_jax import params_to_state_dicts
from audio_classification_tpu_torch.engine import ModelPack, tiny_preset
from audio_classification_tpu_torch.models.asr import beam
from audio_classification_tpu_torch.models.asr.paraformer import cif_integrate, paraformer_frontend
from audio_classification_tpu_torch.models.asr.tokens import TokenTable
from audio_classification_tpu_torch.ops.kernels import attention

torch.set_num_threads(2)
CHARS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 '"
LENGTHS = (4000, 8000, 16000)
FAMILIES = ("paraformer", "transducer", "whisper")
FLAGS = {"paraformer": ["--paraformer", "seeded"],
         "transducer": ["--encoder", "e", "--decoder", "d", "--joiner", "j"],
         "whisper": ["--whisper-encoder", "e", "--whisper-decoder", "d"]}
CFG_FIELDS = {"paraformer": dict(paraformer="seeded"),
              "transducer": dict(encoder="e", decoder="d", joiner="j"),
              "whisper": dict(whisper_encoder="e", whisper_decoder="d")}
MODEL_TOL = 1e-4    # float32 models: share of max|out|
INT8_TOL = 2e-2     # int8 models: share of max|out| (a flipped int8 step is allowed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _presets(quant="none"):
    jp, tp = jax_tiny_preset(), tiny_preset()
    if quant == "int8":
        def q(p):
            return dataclasses.replace(p, **{f: dataclasses.replace(getattr(p, f), quant="int8")
                                             for f in ("transducer", "paraformer", "whisper")})
        jp, tp = q(jp), q(tp)
    return jp, tp


@functools.lru_cache(maxsize=None)
def family_packs(family, quant="none", decoding="greedy_search", beam_width=4):
    """The JAX pack and the port's on the same tiny weights, with the
    64-symbol token table (built once per argument set)."""
    jp, tp = _presets(quant)
    jax_pack = JaxModelPack(jp, seed=0, tokens=JaxTokenTable.char_table(CHARS),
                            asr_family=family, decoding_method=decoding,
                            num_active_paths=beam_width)
    pack = ModelPack(tp, seed=1, device="cpu", tokens=TokenTable.char_table(CHARS),
                     asr_family=family, decoding_method=decoding, num_active_paths=beam_width)
    pack.load_state_dicts(params_to_state_dicts({k: jax_pack.params[k] for k in ModelPack.STAGES}))
    return jax_pack, pack


def _feats(rng, b, t, d, lens):
    feats = rng.standard_normal((b, t, d)).astype(np.float32)
    return feats, np.arange(t)[None, :] < np.array(lens)[:, None]


def _assert_close(out, ref, rows=None, tol=MODEL_TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    if rows is not None:
        out, ref = out * rows, ref * rows
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max(), np.abs(out - ref).max()


# ------------------------------------------------------------------ CIF
@pytest.mark.parametrize("case", ["random", "halves", "overflow", "tail", "below-tail"])
def test_cif_matches_jax(case):
    """Fire decisions equal (counts exact), tokens within 1e-6 of max|h|:
    alpha of exactly 0.5 (fires land on the threshold itself), more fires
    than max_tokens (the last writer keeps the last slot), a residual that
    fires as the tail and one that does not."""
    rng = np.random.default_rng(len(case))
    b, t, d, cap = 3, 40, 8, 12
    h = rng.standard_normal((b, t, d)).astype(np.float32)
    alpha = {"random": rng.uniform(0.0, 0.7, (b, t)),
             "halves": np.full((b, t), 0.5),
             "overflow": rng.uniform(0.6, 1.0, (b, t)),
             "tail": np.full((b, t), 0.3),
             "below-tail": np.concatenate([np.full((b, t - 1), 0.25), np.full((b, 1), 0.1)],
                                          axis=1)}[case].astype(np.float32)
    alpha[1, 25:] = 0.0  # a padded tail
    ref_tok, ref_n = jax_cif(jnp.asarray(h), jnp.asarray(alpha), cap)
    tok, n = cif_integrate(_t(h), _t(alpha), cap)
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    assert np.abs(tok.numpy() - np.asarray(ref_tok)).max() <= 1e-6 * np.abs(h).max()
    if case == "overflow":
        assert (n.numpy() == cap).all()


# ------------------------------------------------------------------ Paraformer
@pytest.mark.parametrize("t,lens", [(23, [23, 9]), (520, [520, 300])])
def test_paraformer_matches_jax(t, lens):
    """Logits within 1e-4 of max on the fired tokens, counts and greedy ids
    exact. At T = 520 the port's encoder attention goes through K3's wrapper
    (its twin on the CPU) against the JAX flash kernel in interpret mode."""
    jax_pack, pack = family_packs("paraformer")
    rng = np.random.default_rng(t)
    cfg = pack.paraformer_cfg
    feats, mask = _feats(rng, 2, t, cfg.lfr_m * cfg.num_mel, lens)
    ref_logits, ref_n = jax_pack.asr_model.apply(jax_pack.params["asr"], jnp.asarray(feats),
                                                 jnp.asarray(mask))
    with torch.no_grad():
        logits, n = pack.models["asr"](_t(feats), _t(mask))
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    rows = (np.arange(cfg.max_tokens)[None, :] < np.asarray(ref_n)[:, None])[..., None]
    _assert_close(logits.numpy(), ref_logits, rows)
    ids = np.where(rows[..., 0], logits.numpy().argmax(-1), 0)
    np.testing.assert_array_equal(ids, np.where(rows[..., 0], np.asarray(ref_logits).argmax(-1), 0))
    assert n.numpy().min() >= 1


def test_paraformer_frontend_matches_jax():
    """Masks equal; LFR features within 1e-3 abs, the fbank parity bound of
    tests/test_torch_ops.py (the JAX frontend's DFT against K1's twin:
    float32 sums in other orders, largest on bins far below the peak)."""
    cfg = tiny_preset().paraformer
    rng = np.random.default_rng(3)
    wav = (0.1 * rng.standard_normal((2, 9000))).astype(np.float32)
    lens = np.array([9000, 5000])
    ref, ref_mask = jax_pf_frontend(jnp.asarray(wav), jnp.asarray(lens),
                                    jax_tiny_preset().paraformer)
    got, mask = paraformer_frontend(_t(wav), _t(lens), cfg)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert np.abs((got.numpy() - np.asarray(ref)) * np.asarray(ref_mask)[..., None]).max() < 1e-3


# ------------------------------------------------------------------ transducer
@pytest.fixture(scope="module")
def transducer_case():
    jax_pack, pack = family_packs("transducer")
    rng = np.random.default_rng(5)
    feats, mask = _feats(rng, 3, 90, 80, [90, 61, 30])
    return jax_pack, pack, feats, mask


def test_transducer_encoder_and_greedy_match_jax(transducer_case):
    """Encoder output within 1e-4 of max on valid frames (mask equal),
    greedy ids and counts exact."""
    jax_pack, pack, feats, mask = transducer_case
    jm, params = jax_pack.asr_model, jax_pack.params["asr"]
    ref_enc, ref_mask = jm.apply(params, jnp.asarray(feats), jnp.asarray(mask),
                                 method=lambda m, f, k: m.encoder(f, k))
    ref_ids, ref_n = jm.apply(params, jnp.asarray(feats), jnp.asarray(mask),
                              method=JaxTransducer.greedy_decode)
    model = pack.models["asr"]
    with torch.no_grad():
        enc, emask = model.encoder(_t(feats), _t(mask))
        ids, n = model.greedy_decode(_t(feats), _t(mask))
    np.testing.assert_array_equal(emask.numpy(), np.asarray(ref_mask))
    _assert_close(enc.numpy(), ref_enc, np.asarray(ref_mask)[..., None])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    assert n.numpy().max() >= 3


@pytest.mark.parametrize("width", [1, 2, 4])
def test_transducer_beam_matches_jax(transducer_case, width):
    """modified_beam_search: ids and counts exact, the best score within
    1e-4 (absolute, log-probabilities of order 10)."""
    jax_pack, pack, feats, mask = transducer_case
    ref_ids, ref_n, ref_s = jax_pack.asr_model.apply(
        jax_pack.params["asr"], jnp.asarray(feats), jnp.asarray(mask), width, True,
        method=JaxTransducer.beam_decode)
    with torch.no_grad():
        ids, n, s = pack.models["asr"].beam_decode(_t(feats), _t(mask), width, True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), atol=1e-4, rtol=0)


def test_transducer_beam1_equals_greedy_and_wider_beams_score_higher(transducer_case):
    _jax_pack, pack, feats, mask = transducer_case
    model = pack.models["asr"]
    with torch.no_grad():
        g_ids, g_n = model.greedy_decode(_t(feats), _t(mask))
        b_ids, b_n, s1 = model.beam_decode(_t(feats), _t(mask), 1, True)
        _, _, s4 = model.beam_decode(_t(feats), _t(mask), 4, True)
    assert torch.equal(g_ids, b_ids) and torch.equal(g_n, b_n)
    assert (s4 >= s1 - 1e-4).all()


@pytest.mark.parametrize("width", [1, 3])
def test_transducer_padded_equals_solo(transducer_case, width):
    """A short utterance decoded inside a padded batch and alone at the same
    padded length: the same ids (greedy and beam), as
    tests/test_asr_families.py holds the JAX decoder."""
    _jax_pack, pack, feats, mask = transducer_case
    model = pack.models["asr"]
    with torch.no_grad():
        ids_b, n_b = model.beam_decode(_t(feats), _t(mask), width)
        ids_s, n_s = model.beam_decode(_t(feats[1:2]), _t(mask[1:2]), width)
        g_b, _ = model.greedy_decode(_t(feats), _t(mask))
        g_s, _ = model.greedy_decode(_t(feats[1:2]), _t(mask[1:2]))
    assert torch.equal(ids_b[1], ids_s[0]) and int(n_b[1]) == int(n_s[0])
    assert torch.equal(g_b[1], g_s[0])


def test_left_pack_symbols_matches_jax():
    rng = np.random.default_rng(9)
    syms = np.where(rng.uniform(size=(4, 17)) < 0.4, rng.integers(1, 9, (4, 17)), 0)
    syms[2] = 0
    ref_ids, ref_n = jax_beam.left_pack_symbols(jnp.asarray(syms, jnp.int32), 0)
    ids, n = beam.left_pack_symbols(_t(syms), 0)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))


# ------------------------------------------------------------------ whisper-style
@pytest.fixture(scope="module")
def whisper_case():
    jax_pack, pack = family_packs("whisper")
    rng = np.random.default_rng(11)
    feats, mask = _feats(rng, 2, 60, 80, [60, 37])
    return jax_pack, pack, feats, mask


def test_whisper_encoder_and_greedy_match_jax(whisper_case):
    """Memory within 1e-4 of max on valid frames, greedy ids and lengths
    exact (with done flags: every position after EOS holds EOS)."""
    jax_pack, pack, feats, mask = whisper_case
    jm, params = jax_pack.asr_model, jax_pack.params["asr"]
    ref_mem, ref_mask = jm.apply(params, jnp.asarray(feats), jnp.asarray(mask),
                                 method=JaxWhisper.encode)
    ref_ids, ref_n = jm.apply(params, jnp.asarray(feats), jnp.asarray(mask),
                              method=JaxWhisper.greedy_decode)
    model = pack.models["asr"]
    with torch.no_grad():
        mem, mmask = model.encode(_t(feats), _t(mask))
        ids, n = model.greedy_decode(_t(feats), _t(mask))
    np.testing.assert_array_equal(mmask.numpy(), np.asarray(ref_mask))
    _assert_close(mem.numpy(), ref_mem, np.asarray(ref_mask)[..., None])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    assert n.numpy().max() >= 3


def test_whisper_max_len_override_matches_jax(whisper_case):
    jax_pack, pack, feats, mask = whisper_case
    ref_ids, ref_n = jax_pack.asr_model.apply(jax_pack.params["asr"], jnp.asarray(feats),
                                              jnp.asarray(mask), 40,
                                              method=JaxWhisper.greedy_decode)
    with torch.no_grad():
        ids, n = pack.models["asr"].greedy_decode(_t(feats), _t(mask), max_len=40)
    assert ids.shape == (2, 39)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))


def test_whisper_kv_cache_equals_full_recompute(whisper_case):
    """The cached greedy decode against teacher forcing over its own output
    (no cache, the whole prefix recomputed): the same argmax at every
    position up to each item's EOS, and the JAX teacher-forced logits within
    1e-4 of max."""
    jax_pack, pack, feats, mask = whisper_case
    model = pack.models["asr"]
    c = pack.whisper_cfg
    with torch.no_grad():
        ids, n = model.greedy_decode(_t(feats), _t(mask))
        tokens = torch.cat([torch.full((2, 1), c.bos_id), ids], dim=1)[:, :-1]
        mem, mmask = model.encode(_t(feats), _t(mask))
        logits = model.decode_logits(tokens, mem, mmask)
    for b in range(2):
        k = int(n[b]) + 1  # the emitted tokens and the EOS after them
        k = min(k, ids.shape[1])
        assert torch.equal(logits[b, :k].argmax(-1), ids[b, :k])
    ref = jax_pack.asr_model.apply(jax_pack.params["asr"], jnp.asarray(feats), jnp.asarray(mask),
                                   jnp.asarray(tokens.numpy()))
    _assert_close(logits.numpy(), ref)


# ------------------------------------------------------------------ int8
@pytest.mark.parametrize("family", FAMILIES)
def test_int8_family_matches_jax(family):
    """--quant int8: the encoder's attention and FFN projections through
    ops/quant with the frame mask, held to the JAX int8 model. Paraformer's
    logits on the fired tokens, the transducer's and whisper's encoder
    outputs within INT8_TOL of max (a flipped int8 step is allowed); ids
    exact; int8 differs from the float model."""
    jax_pack, pack = family_packs(family, quant="int8")
    _jf, fpack = family_packs(family)
    rng = np.random.default_rng(21)
    model, fmodel = pack.models["asr"], fpack.models["asr"]
    jm, params = jax_pack.asr_model, jax_pack.params["asr"]
    if family == "paraformer":
        cfg = pack.paraformer_cfg
        feats, mask = _feats(rng, 2, 30, cfg.lfr_m * cfg.num_mel, [30, 17])
        ref, ref_n = jm.apply(params, jnp.asarray(feats), jnp.asarray(mask))
        with torch.no_grad():
            out, n = model(_t(feats), _t(mask))
            flt, _ = fmodel(_t(feats), _t(mask))
        np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
        rows = (np.arange(cfg.max_tokens)[None, :] < np.asarray(ref_n)[:, None])[..., None]
    else:
        feats, mask = _feats(rng, 2, 64, 80, [64, 40])
        enc = ((lambda m, f, k: m.encoder(f, k)) if family == "transducer"
               else JaxWhisper.encode)
        ref, ref_mask = jm.apply(params, jnp.asarray(feats), jnp.asarray(mask), method=enc)
        torch_enc = model.encoder if family == "transducer" else model.encode
        ftorch_enc = fmodel.encoder if family == "transducer" else fmodel.encode
        with torch.no_grad():
            out, _ = torch_enc(_t(feats), _t(mask))
            flt, _ = ftorch_enc(_t(feats), _t(mask))
        rows = np.asarray(ref_mask)[..., None]
    _assert_close(out.numpy(), ref, rows, INT8_TOL)
    assert np.abs((out.numpy() - flt.numpy()) * rows).max() > 1e-4
    if family != "paraformer":
        ref_ids, _ = jm.apply(params, jnp.asarray(feats), jnp.asarray(mask),
                              method=type(jm).greedy_decode)
        with torch.no_grad():
            ids, _ = model.greedy_decode(_t(feats), _t(mask))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))


# ------------------------------------------------------------------ seeding
def test_seeded_stages_do_not_depend_on_the_family():
    """A seed gives every stage but ``asr`` the same weights whatever ASR
    family the pack holds (the JAX pack keys each stage apart); the stages
    after ``asr`` change with the seed and differ from one another's draws."""
    packs = {f: ModelPack(tiny_preset(), seed=3, device="cpu", asr_family=f)
             for f in ("sensevoice",) + FAMILIES}
    other = ModelPack(tiny_preset(), seed=4, device="cpu", asr_family="paraformer")
    base = packs["sensevoice"]
    for family, pack in packs.items():
        for stage in ModelPack.STAGES:
            if stage == "asr":
                continue
            sd, ref = pack.models[stage].state_dict(), base.models[stage].state_dict()
            assert list(sd) == list(ref)
            for key in sd:
                assert torch.equal(sd[key], ref[key]), (family, stage, key)
    for stage in ("sep2", "mossformer", "vad"):
        a, b = base.models[stage].state_dict(), other.models[stage].state_dict()
        assert any(not torch.equal(a[k], b[k]) for k in a), stage
    assert not torch.equal(base.models["sep2"].state_dict()["encoder.weight"],
                           base.models["sep3"].state_dict()["encoder.weight"])


# ------------------------------------------------------------------ K3 / K5 head dims
@pytest.mark.parametrize("d", [80, 40])
def test_flash_head_dim_rule_matches_jax_kernels(d):
    """The card's rule for a head dim the kernel has no instance of, run
    with the twins: q, k, v zero-padded to the next instance (D = 80 runs
    as it is, 40 pads to 64) and scaled by 1 / sqrt of the TRUE D, the
    padded columns sliced off; against the JAX kernels in interpret mode
    (which pad D to their lane width). K3 1e-5 abs on valid rows; K5's o
    1e-5 of max|o|, m and l 1e-5 relative."""
    assert attention.padded_head_dim(d) == (80 if d == 80 else 64)
    rng = np.random.default_rng(d)
    b, h, t = 2, 2, 150
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3))
    mask = np.arange(t)[None, :] < np.array([t, 97])[:, None]
    qp, kp, vp = attention.pad_head_dim(_t(q), _t(k), _t(v))
    assert qp.shape[-1] == attention.padded_head_dim(d)
    scale = 1.0 / np.sqrt(d)
    out = attention.attention_reference(qp, kp, vp, _t(mask), scale=scale)[..., :d].numpy()
    ref = np.asarray(jax_attention.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), block_q=128,
        block_k=128, interpret=True))
    assert np.abs(out - ref).max() < 1e-5
    o, m, l = attention.attention_stats_reference(qp, kp, vp, _t(mask), scale=scale)
    ro, rm, rl = (np.asarray(x) for x in jax_attention.flash_attention_stats(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), block_q=128,
        block_k=128, interpret=True))
    o = o[..., :d].numpy()
    assert np.abs(o - ro).max() <= 1e-5 * np.abs(ro).max()
    np.testing.assert_allclose(m.numpy(), rm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), rl, rtol=1e-5)


def test_flash_head_dim_above_the_largest_instance_raises():
    """Nothing raises any more: above the largest instance (128) a head dim
    runs on the wide body, zero-padded to a multiple of its 64-wide slab,
    as the JAX kernel pads D to its lane width."""
    assert attention.HEAD_DIMS == (64, 80, 128) and attention.WIDE_SLAB == 64
    assert [attention.padded_head_dim(d) for d in (1, 16, 64, 65, 80, 81, 128)] == \
        [64, 64, 64, 80, 80, 128, 128]
    assert [attention.padded_head_dim(d) for d in (129, 136, 192, 193, 200, 256, 1000)] == \
        [192, 192, 192, 256, 256, 256, 1024]
