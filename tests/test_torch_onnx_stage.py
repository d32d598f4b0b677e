"""Direct ONNX stages and the engine's ONNX paths of the port
(audio_classification_tpu_torch/convert/onnx_stage, engine/runtime,
pipelines/offline_overlap3) against the JAX package's, on the CPU.

The JAX engine holds the port pack's weights (tests/torch_onnx_helpers.
jax_twin); the fixture graphs are tests/test_onnx_stage.py's. Token ids and
texts are compared exactly, stage outputs within 1e-5 of their max,
embeddings of the fixture speaker graph within 5e-5, records as tests/test_torch_pipeline.py compares them (texts
exact, sv_score within 2e-3).
"""
import numpy as np
import pytest
import torch

import audio_classification_tpu.pipelines.offline_overlap3 as jax_pipeline_mod
from audio_classification_tpu.engine import BucketSpec as JaxBucketSpec
from audio_classification_tpu.engine import StageEngine as JaxStageEngine
from audio_classification_tpu.engine import default_buckets as jax_default_buckets
from audio_classification_tpu.engine import tiny_preset as jax_tiny_preset
from audio_classification_tpu.models.asr.tokens import TokenTable as JaxTokenTable
from audio_classification_tpu.models.convert import onnx_stage as jax_stage
from audio_classification_tpu.utils.config import Overlap3Config as JaxConfig
from audio_classification_tpu_torch.audio_io import write_wav
from audio_classification_tpu_torch.convert import onnx_export
from audio_classification_tpu_torch.convert import onnx_stage as port_stage
from audio_classification_tpu_torch.convert.from_jax import state_dict_to_variables
from audio_classification_tpu_torch.engine import BucketSpec, ModelPack, StageEngine, tiny_preset
from audio_classification_tpu_torch.engine.bucketing import default_buckets
from audio_classification_tpu_torch.models.asr.tokens import TokenTable
from audio_classification_tpu_torch.pipelines import offline_overlap3 as port_pipeline_mod
from audio_classification_tpu_torch.utils.config import Overlap3Config
from torch_onnx_helpers import (asr_graph, jax_twin, paraformer_graph,
                                sensevoice_mappable_graph, speaker_graph, transducer_triple,
                                wenet_graph, whisper_pair)

torch.set_num_threads(2)
SR = 16000
CHARS = "".join(chr(ord("a") + i % 26) if i < 26 else chr(0x4e00 + i) for i in range(63))


def _noise(n, seed):
    return (0.3 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def _tone(n, hz=440.0):
    return (0.3 * np.sin(2 * np.pi * hz * np.arange(n) / SR)).astype(np.float32)


def _engines(family="sensevoice", stages=None, decoding_method="greedy_search"):
    """The port's engine and a JAX engine on the same weights, each with
    the direct ONNX stages ``stages(device)`` -> {stage: (port, jax)}
    set before it is built."""
    tokens = dict(tokens=TokenTable.char_table(CHARS))
    pack = ModelPack(tiny_preset(), seed=0, device="cpu", asr_family=family,
                     decoding_method=decoding_method, **tokens)
    jpack = jax_twin(pack, jax_tiny_preset(), asr_family=family,
                     decoding_method=decoding_method,
                     tokens=JaxTokenTable.char_table(CHARS))
    for name, (ps, js) in (stages or {}).items():
        pack.set_onnx_stage(name, ps)
        jpack.set_onnx_stage(name, js)
    eng = StageEngine(pack, BucketSpec(default_buckets(SR, 0.5, 2.0), 4))
    jeng = JaxStageEngine(jpack, JaxBucketSpec(jax_default_buckets(SR, 0.5, 2.0), 4))
    return eng, jeng


def _ids(eng, wavs):
    return [list(np.asarray(i)[: int(n)]) for i, n in eng.collect_tokens(eng.launch_transcribe(wavs))]


def test_stage_feed_inference_and_calls_match_jax(tmp_path):
    """Signature classification, prompt shapes (a declared [1] language as in
    the port's own SenseVoice export), skip_frames and outputs as JAX."""
    rng = np.random.RandomState(0)
    path = asr_graph(tmp_path / "asr.onnx", rng, lfr_dim=16, vocab=8)
    cfg = tiny_preset().asr
    exp = str(tmp_path / "sv.onnx")
    tree = state_dict_to_variables(ModelPack(tiny_preset(), seed=0, device="cpu").models["asr"])
    onnx_export.export_sensevoice(tree, cfg, exp, frames=7)
    x = np.random.default_rng(1)
    for p, dim, t in ((path, 16, 9), (exp, cfg.lfr_m * cfg.num_mel, 7)):
        ps = port_stage.OnnxStage(p, skip_frames=2, device="cpu")
        js = jax_stage.OnnxStage(p, skip_frames=2)
        for attr in ("feats_input", "length_input", "int_inputs", "outputs"):
            assert getattr(ps, attr) == getattr(js, attr), attr
        feats = x.standard_normal((2, t, dim)).astype(np.float32)
        mask = np.arange(t)[None, :] < np.array([[t], [t - 3]])
        got = ps(ps.params, feats, mask, language_id=3, use_itn=False).numpy()
        want = np.asarray(js(js.params, feats, mask, language_id=3, use_itn=False))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5 * max(1, np.abs(want).max()))
    assert "OnnxStage" in ps.describe()


def test_speaker_and_asr_stages_through_the_engine_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    spk = speaker_graph(tmp_path / "spk.onnx", rng)
    lfr = tiny_preset().asr
    asr = asr_graph(tmp_path / "asr.onnx", rng, lfr.lfr_m * lfr.num_mel, 64)
    eng, jeng = _engines(stages={
        "spk": (port_stage.OnnxStage(spk, verbose=False, device="cpu"),
                jax_stage.OnnxStage(spk, verbose=False)),
        "asr": (port_stage.OnnxStage(asr, device="cpu"), jax_stage.OnnxStage(asr))})
    wavs = [_noise(8000, 2), _noise(5000, 3), _tone(12000)]
    got, want = eng.embed(wavs), np.asarray(jeng.embed(wavs))
    # the fixture's N(0, 1) 80 -> 32 projection of raw log-mels amplifies
    # the two frontends' float32 difference to ~2e-5 of the unit embedding
    np.testing.assert_allclose(got, want, atol=5e-5)
    ids = _ids(eng, wavs)
    assert ids == _ids(jeng, wavs) and any(ids)
    target = got[0]
    clean = eng.process_clean(wavs, [target] * 3)
    jclean = jeng.process_clean(wavs, [target] * 3)
    for (s, t), (js, jt) in zip(clean, jclean):
        assert t == jt and abs(s - js) <= 2e-3
    ov = eng.process_overlap(wavs[:2], [target] * 2)
    jov = jeng.process_overlap(wavs[:2], [target] * 2)
    for r, jr in zip(ov, jov):
        assert r["text"] == jr["text"] and r["best"] == jr["best"]
        np.testing.assert_allclose(r["scores"], jr["scores"], atol=2e-3)


def test_bf16_engine_rounds_the_stage_weights_as_jax(tmp_path):
    """At compute_dtype="bfloat16" the JAX engine casts a direct stage's
    weights with the pack's; the port's engine serves the stage from a copy
    rounded to bf16 (float32 features promote every product to float32)."""
    rng = np.random.RandomState(11)
    spk = speaker_graph(tmp_path / "spk.onnx", rng)
    pack = ModelPack(tiny_preset(), seed=0, device="cpu")
    jpack = jax_twin(pack, jax_tiny_preset())
    pack.set_onnx_stage("spk", port_stage.OnnxStage(spk, verbose=False, device="cpu"))
    jpack.set_onnx_stage("spk", jax_stage.OnnxStage(spk, verbose=False))
    eng = StageEngine(pack, BucketSpec(default_buckets(SR, 0.5, 2.0), 4),
                      compute_dtype="bfloat16")
    jeng = JaxStageEngine(jpack, JaxBucketSpec(jax_default_buckets(SR, 0.5, 2.0), 4),
                          compute_dtype="bfloat16")
    wavs = [_noise(8000, 12), _tone(16000)]
    got, want = eng.embed(wavs), np.asarray(jeng.embed(wavs))
    np.testing.assert_allclose(got, want, atol=5e-5)
    f32 = StageEngine(pack, BucketSpec(default_buckets(SR, 0.5, 2.0), 4)).embed(wavs)
    assert np.abs(f32 - got).max() > 1e-4  # the bf16 rounding shows


def _family_stages(family, tmp_path):
    rng = np.random.RandomState(7)
    pre = tiny_preset()
    if family == "paraformer":
        c = pre.paraformer
        p = paraformer_graph(tmp_path / "pf.onnx", rng, c.lfr_m * c.num_mel, 64)
        return {"asr": (port_stage.OnnxStage(p, n_outputs=2, device="cpu"),
                        jax_stage.OnnxStage(p, n_outputs=2))}
    if family == "transducer":
        paths = transducer_triple(tmp_path, rng, mel=pre.transducer.num_mel, V=64)
        return {"asr": (port_stage.OnnxTransducerStage(*paths, device="cpu"),
                        jax_stage.OnnxTransducerStage(*paths))}
    enc, dec = whisper_pair(tmp_path, rng, mel=pre.whisper.num_mel, V=64)
    kw = dict(sot_sequence=(3,), eot_id=2, max_decode_len=10, num_mel=pre.whisper.num_mel)
    return {"asr": (port_stage.OnnxWhisperStage(enc, dec, device="cpu", **kw),
                    jax_stage.OnnxWhisperStage(enc, dec, **kw))}


@pytest.mark.parametrize("family,method", [
    ("paraformer", "greedy_search"), ("transducer", "greedy_search"),
    ("transducer", "modified_beam_search"), ("whisper", "greedy_search")])
def test_family_direct_stages_match_jax(tmp_path, family, method):
    """Each family's direct stage through the engine, ids and texts as the
    JAX engine's. Beam search: the JAX engine's beam program over a direct
    triple fails in this JAX version (its AOT call passes fewer inputs than
    it compiled; ROADMAP §3), so the JAX stage's own ``decode(beam=K)``
    (as tests/test_onnx_stage.py calls it) is held to the port's engine on
    the engine's features."""
    stages = _family_stages(family, tmp_path)
    beam = method == "modified_beam_search"
    eng, jeng = _engines(family, None if beam else stages, decoding_method=method)
    wavs = [_noise(8000, 4), _noise(12000, 5), _noise(4000, 6)]
    if beam:
        ps, js = stages["asr"]
        eng.pack.set_onnx_stage("asr", ps)
        eng = StageEngine(eng.pack, eng.buckets)
        from audio_classification_tpu_torch.engine.bucketing import pad_batch_i16
        from audio_classification_tpu_torch.models.asr.transducer import transducer_frontend

        ids = _ids(eng, wavs)
        for w, got in zip(wavs, ids):
            wav, lens = pad_batch_i16([w], eng.buckets.bucket_for(len(w)), 1)
            feats, mask = transducer_frontend(torch.from_numpy(wav).float() / 32768.0,
                                              torch.from_numpy(lens), eng.pack.transducer_cfg)
            jid, jn = js.decode(js.params, feats.numpy(), mask.numpy(), beam=4)
            assert got == list(np.asarray(jid)[0][: int(np.asarray(jn)[0])])
        assert any(ids)
        return
    ids = _ids(eng, wavs)
    assert ids == _ids(jeng, wavs) and any(ids)
    assert eng.transcribe(wavs) == jeng.transcribe(wavs)
    if family == "whisper":
        assert ids[0] == [4, 5, 6]


def _cfg_kw(tmp_path, **kw):
    return {**dict(preset="tiny", seed=0, max_batch=4, max_segment_sec=2.0), **kw}


def test_build_engine_wenet_ctc_and_modes(tmp_path, monkeypatch):
    """--wenet-ctc (always direct, LFR collapsed, no prompt skip) and the
    three --onnx-exec modes on a graph that cannot map: map raises,
    direct and auto serve the graph; ids as the JAX runner's."""
    rng = np.random.RandomState(22)
    pre = tiny_preset()
    wn = wenet_graph(tmp_path / "wenet.onnx", rng, pre.asr.num_mel, pre.asr.vocab_size)
    spk = speaker_graph(tmp_path / "spk.onnx", rng)
    cfg = Overlap3Config(**_cfg_kw(tmp_path, spk_embed_model=spk, onnx_exec="auto",
                                   provider="cpu"))
    cfg.wenet_ctc = wn  # the SID CLIs' flag (no field of the flagship config)
    eng = port_pipeline_mod.build_engine(cfg)
    assert eng.pack.asr_cfg.lfr_m == eng.pack.asr_cfg.lfr_n == 1
    assert eng.onnx_stages["asr"].skip_frames == 0 and "spk" in eng.onnx_stages
    twin = jax_twin(eng.pack, jax_tiny_preset())
    monkeypatch.setattr(jax_pipeline_mod, "ModelPack", lambda *a, **k: twin)
    cfg = JaxConfig(**_cfg_kw(tmp_path, onnx_exec="auto", spk_embed_model=spk))
    cfg.wenet_ctc = wn
    jeng = jax_pipeline_mod.build_engine(cfg)
    wavs = [_noise(8000, 8), _noise(6000, 9)]
    assert _ids(eng, wavs) == _ids(jeng, wavs)
    np.testing.assert_allclose(eng.embed(wavs), np.asarray(jeng.embed(wavs)), atol=5e-5)
    with pytest.raises(ValueError):
        port_pipeline_mod.build_engine(Overlap3Config(
            **_cfg_kw(tmp_path, spk_embed_model=spk, onnx_exec="map", provider="cpu")))
    eng = port_pipeline_mod.build_engine(Overlap3Config(
        **_cfg_kw(tmp_path, spk_embed_model=spk, onnx_exec="direct", provider="cpu")))
    assert eng.embed([_tone(8000)]).shape == (1, 32)
    with pytest.raises(ValueError, match="onnx-exec"):
        port_pipeline_mod.build_engine(Overlap3Config(
            **_cfg_kw(tmp_path, onnx_exec="bogus", provider="cpu")))


def test_engine_reads_overrides_when_built(tmp_path):
    """As the JAX engine resolves set_onnx_stage when it builds its programs,
    a stage set on the pack after the engine was built is not seen by it."""
    rng = np.random.RandomState(3)
    pack = ModelPack(tiny_preset(), seed=0, device="cpu")
    eng = StageEngine(pack, BucketSpec(default_buckets(SR, 0.5, 2.0), 4))
    before = eng.embed([_tone(8000)])
    pack.set_onnx_stage("spk", port_stage.OnnxStage(speaker_graph(tmp_path / "s.onnx", rng),
                                                    verbose=False, device="cpu"))
    np.testing.assert_array_equal(eng.embed([_tone(8000)]), before)
    assert "spk" not in eng.onnx_stages
    fresh = StageEngine(pack, BucketSpec(default_buckets(SR, 0.5, 2.0), 4))
    assert fresh.embed([_tone(8000)]).shape == (1, 32)


def test_set_onnx_stage_rejects_unsupported(tmp_path):
    rng = np.random.RandomState(6)
    pre = tiny_preset()
    spk = port_stage.OnnxStage(speaker_graph(tmp_path / "s.onnx", rng), verbose=False,
                               device="cpu")
    pf = port_stage.OnnxStage(paraformer_graph(tmp_path / "p.onnx", rng,
                                               pre.paraformer.lfr_m * pre.paraformer.num_mel,
                                               pre.paraformer.vocab_size), device="cpu")
    for family, stage, match in (("sensevoice", "sep3", "not supported"),
                                 ("transducer", "asr", "triple"), ("whisper", "asr", "pair"),
                                 ("paraformer", "asr", "token_num")):
        pack = ModelPack(pre, seed=0, device="cpu", asr_family=family)
        with pytest.raises(ValueError, match=match):
            pack.set_onnx_stage(stage, pf if family == "paraformer" else spk)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("onnx_scene")
    rng = np.random.default_rng(0)
    t = np.arange(3 * SR) / SR
    mix = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 990 * t)
           + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    write_wav(d / "mix.wav", mix, SR)
    write_wav(d / "target.wav", _tone(2 * SR), SR)
    pack = ModelPack(tiny_preset(), seed=0, device="cpu")
    fb = pack.asr_cfg
    sensevoice_mappable_graph(state_dict_to_variables(pack.models["asr"]), fb,
                              d / "sv.onnx", frames=20)
    onnx_export.export_speaker(state_dict_to_variables(pack.models["spk"]), pack.preset.spk,
                               str(d / "spk.onnx"), frames=98)
    asr_graph(d / "asr_dyn.onnx", np.random.RandomState(5), fb.lfr_m * fb.num_mel, 29)
    return d


@pytest.mark.parametrize("mode,osd_thr,kind", [
    ("map", 0.0, "overlap"), ("map", 1.0, "clean"), ("direct", 0.0, "overlap")])
def test_flagship_pipeline_with_onnx_files_matches_jax(scene, monkeypatch, mode, osd_thr,
                                                       kind):
    """The flagship runner with .onnx model files: --sense-voice (the pack's
    SenseVoice with a runtime textnorm input in map mode; a dynamic-length
    fixture graph in direct mode, where a baked frame count takes only one
    bucket) and --spk-embed-model (the port's speaker export), in forced
    scenes, against the JAX runner on the same files and weights. In map
    mode the pack's weights come back unchanged."""
    sv = scene / ("sv.onnx" if mode == "map" else "asr_dyn.onnx")
    kw = dict(input_wavs=[str(scene / "mix.wav")], target_wav=str(scene / "target.wav"),
              sv_threshold=-1.0, osd_thr=osd_thr, sense_voice=str(sv),
              spk_embed_model=str(scene / "spk.onnx"), onnx_exec=mode,
              # the fixture graph emits no prompt frames
              onnx_asr_skip_frames=-1 if mode == "map" else 0,
              **_cfg_kw(scene, max_segment_sec=4.0))
    cfg = Overlap3Config(provider="cpu", **kw)
    eng = port_pipeline_mod.build_engine(cfg)
    assert ("asr" in eng.onnx_stages) == (mode == "direct")
    if mode == "map":
        seeded = ModelPack(tiny_preset(), seed=0, device="cpu")
        for st in ("asr", "spk"):
            for k, v in seeded.models[st].state_dict().items():
                assert torch.equal(eng.pack.models[st].state_dict()[k], v), (st, k)
    twin = jax_twin(eng.pack, jax_tiny_preset())
    monkeypatch.setattr(jax_pipeline_mod, "ModelPack", lambda *a, **k: twin)
    jcfg = JaxConfig(**kw)
    jeng = jax_pipeline_mod.build_engine(jcfg)
    got = port_pipeline_mod.Overlap3Pipeline(cfg, engine=eng).run()
    ref = jax_pipeline_mod.Overlap3Pipeline(jcfg, engine=jeng).run()
    assert len(got.segments) == len(ref.segments) >= 1
    for g, r in zip(got.segments, ref.segments):
        assert g["kind"] == kind
        for key in ("kind", "start", "end", "stream", "text", "target_src_text"):
            assert g[key] == r[key], key
        assert abs(g["sv_score"] - r["sv_score"]) <= 2e-3
