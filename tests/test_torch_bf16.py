"""The port's bfloat16 mode (``compute_dtype="bfloat16"``, the CLIs'
``--compute-dtype bfloat16``) against the JAX engine's, the counterpart of
tests/test_bf16.py: tiny preset, CPU, the same converted weights, inputs
from a numpy seed.

Both packages round at the same points (flax's dtype rules, the kernels'
twins at the JAX kernels' rounding points), so the port is held to the JAX
bf16 engine more tightly than tests/test_bf16.py holds bf16 to float32
(5% of max|out|, cosine 0.999): the rest is float32 summation order, which
flips a bfloat16 rounding here and there. The tiny separators never fuse
their masker in JAX (bottleneck 32), so the port's take fused_tcn="off"
here; the fused K2 twin at bf16 is held to the JAX kernel in
tests/test_torch_bf16_kernels.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from audio_classification_tpu.pipelines.offline_overlap3 import Overlap3Pipeline as JaxPipeline
from audio_classification_tpu.pipelines.serving import StreamingServer as JaxStreamingServer
from audio_classification_tpu.pipelines.streaming import (
    StreamingOverlap3Pipeline as JaxStreamingPipeline,
)
from audio_classification_tpu.utils.config import Overlap3Config as JaxConfig
from audio_classification_tpu_torch.audio_io import read_wav, write_wav
from audio_classification_tpu_torch.cli import serve_streams, streaming_overlap_3src
from audio_classification_tpu_torch.engine import BucketSpec, ModelPack, StageEngine, tiny_preset
from audio_classification_tpu_torch.models.pyannet import BinarizeConfig
from audio_classification_tpu_torch.pipelines.offline_overlap3 import Overlap3Pipeline
from audio_classification_tpu_torch.pipelines.serving import StreamingServer
from audio_classification_tpu_torch.pipelines.streaming import StreamingOverlap3Pipeline
from audio_classification_tpu_torch.utils.config import Overlap3Config
from torch_port_helpers import (
    SR,
    _args,
    _tone,
    assert_records_match,
    run_stream,
    shared_engines,
    windows,
)

torch.set_num_threads(2)

# separation: max |port - JAX| over max |JAX|, both in bf16 (measured 2.4e-3
# Conv-TasNet, 6.1e-3 MossFormer; tests/test_bf16.py allows 5e-2 between f32
# and bf16); embeddings: cosine (measured 0.999997; test_bf16.py: 0.999);
# sv scores: |port - JAX| (the embedder runs wholly in bf16; the float32
# tests allow 1e-4, and 2e-3 under int8). int8 at bf16:
# a bf16 rounding flip moves a value across an int8 step, and later layers
# spread it (measured 2.8e-2), so test_bf16.py's own 5e-2
SEP_TOL = 2e-2
INT8_SEP_TOL = 5e-2
COS_MIN = 0.9999
SV_TOL_BF16 = 3e-3  # measured <= 1.4e-3 in the forced scenes


@pytest.fixture(scope="module")
def engines():
    return shared_engines("none", "bfloat16")


def _sig(n=4000, seed=0):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


@pytest.mark.parametrize("backend", ["convtasnet", "mossformer"])
def test_bf16_separation_matches_jax(engines, backend):
    jax_eng, eng = engines
    x = _sig()
    ref = jax_eng.separate([x], backend=backend)[0]
    got = eng.separate([x], backend=backend)[0]
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() / np.abs(ref).max() < SEP_TOL


def test_bf16_embedding_matches_jax(engines):
    jax_eng, eng = engines
    x = _sig()
    a, b = jax_eng.embed([x])[0], eng.embed([x])[0]
    assert float(a @ b) > COS_MIN


def test_bf16_osd_and_asr_equal_jax(engines):
    jax_eng, eng = engines
    x = _sig(8000)
    assert eng.osd_segments(x, SR, 0.5, 0.5, 0.1) == jax_eng.osd_segments(x, SR, 0.5, 0.5, 0.1)
    assert eng.transcribe([x]) == jax_eng.transcribe([x])


def test_bf16_copy_follows_load_params():
    """The bfloat16 copy is made again when ``load_params`` bumps the pack's
    version (the JAX exec_params' cast cache), and only then."""
    pack = ModelPack(tiny_preset(), seed=0, device="cpu")
    eng = StageEngine(pack, BucketSpec(lengths=(4000, 8000), max_batch=2),
                      compute_dtype="bfloat16")
    x = _sig()
    before = eng.separate([x])[0]
    copy = eng.models["sep3"]
    assert next(copy.parameters()).dtype == torch.bfloat16
    assert eng.models["sep3"] is copy and pack.models["sep3"].encoder.weight.dtype == torch.float32
    old = {k: v.clone() for k, v in pack.models["sep3"].state_dict().items()}
    version = pack.version
    pack.load_params("sep3", {k: v * 0.5 for k, v in old.items()})
    assert pack.version == version + 1
    after = eng.separate([x])[0]
    assert eng.models["sep3"] is not copy
    pack.load_params("sep3", old)
    assert np.abs(before - after).max() > 1e-6
    assert np.array_equal(eng.separate([x])[0], before)


def test_bf16_engine_returns_float32_and_keeps_pack_float32(engines):
    _, eng = engines
    x = _sig()
    assert eng.compute_dtype == torch.bfloat16
    assert eng.embed([x]).dtype == np.float32
    assert all(p.dtype == torch.float32 for m in eng.pack.models.values()
               for p in m.parameters())
    assert all(p.dtype == torch.bfloat16 for m in eng.models.values() for p in m.parameters())
    bn = eng.models["spk"].bn0
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.bfloat16


# ------------------------------------------------------------ pipeline
@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_bf16")
    rng = np.random.default_rng(0)
    t = np.arange(3 * SR) / SR
    mix = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 990 * t)
           + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    write_wav(d / "mix.wav", mix, SR)
    write_wav(d / "target.wav", (0.3 * np.sin(2 * np.pi * 440 * t[: 2 * SR])).astype(np.float32),
              SR)
    return d


def _cfg_kwargs(wavs, osd_thr, backend):
    return dict(input_wavs=[str(wavs / "mix.wav")], target_wav=str(wavs / "target.wav"),
                preset="tiny", seed=0, sv_threshold=-1.0, max_batch=4, max_segment_sec=8.0,
                osd_thr=osd_thr, sep_backend=backend, compute_dtype="bfloat16")


def _assert_pipelines_match(got, ref, kind):
    assert len(got.segments) == len(ref.segments) >= 1
    for g, r in zip(got.segments, ref.segments):
        assert g["kind"] == kind
        for key in ("wav", "kind", "start", "end", "stream", "text", "target_src",
                    "target_src_text"):
            assert g[key] == r[key], key
        assert abs(g["sv_score"] - r["sv_score"]) <= SV_TOL_BF16
    for key in ("segments_total", "segments_clean", "segments_overlap_streams",
                "segments_matched", "segments_missed", "total_audio_sec"):
        assert got.metrics[key] == ref.metrics[key], key


@pytest.mark.parametrize("backend", ["convtasnet", "mossformer"])
@pytest.mark.parametrize("osd_thr,kind", [(0.0, "overlap"), (1.0, "clean")])
def test_bf16_forced_scene_matches_jax_pipeline(wavs, engines, osd_thr, kind, backend):
    """The flagship pipeline in bf16, every segment forced to overlap
    (separation -> per-branch SV -> best-branch ASR) or to clean: records
    agree exactly on kind / span / stream / text, sv_score within
    SV_TOL_BF16."""
    jax_eng, eng = engines
    kw = _cfg_kwargs(wavs, osd_thr, backend)
    ref = JaxPipeline(JaxConfig(**kw), engine=jax_eng).run()
    got = Overlap3Pipeline(Overlap3Config(**kw), engine=eng).run()
    _assert_pipelines_match(got, ref, kind)


@pytest.fixture(scope="module")
def int8_engines():
    return shared_engines("int8", "bfloat16")


@pytest.mark.parametrize("osd_thr,kind", [(0.0, "overlap"), (1.0, "clean")])
def test_bf16_int8_forced_scene_matches_jax_pipeline(wavs, int8_engines, osd_thr, kind):
    """``--quant int8`` with ``--compute-dtype bfloat16``: int8 products
    rescaled into bfloat16 (ops/quant out_dtype), as models/common.py:156-158."""
    jax_eng, eng = int8_engines
    kw = {**_cfg_kwargs(wavs, osd_thr, "convtasnet"), "quant": "int8"}
    ref = JaxPipeline(JaxConfig(**kw), engine=jax_eng).run()
    got = Overlap3Pipeline(Overlap3Config(**kw), engine=eng).run()
    _assert_pipelines_match(got, ref, kind)


def test_bf16_int8_separation_matches_jax(int8_engines):
    jax_eng, eng = int8_engines
    x = _sig()
    ref, got = jax_eng.separate([x])[0], eng.separate([x])[0]
    assert np.abs(got - ref).max() / np.abs(ref).max() < INT8_SEP_TOL


# ------------------------------------------------------------ streaming, serving
@pytest.fixture(scope="module")
def target_wav(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_bf16_stream") / "target.wav"
    write_wav(p, _tone(1.0, 440), SR)
    return str(p)


def test_bf16_streaming_matches_jax(engines, target_wav):
    jax_eng, eng = engines
    chunks = windows(n=2)
    args = _args(compute_dtype="bfloat16")
    ref, _ = run_stream(JaxStreamingPipeline, args, target_wav, jax_eng, chunks)
    got, stats = run_stream(StreamingOverlap3Pipeline, args, target_wav, eng, chunks)
    assert stats["chunks"] == len(chunks)
    for g, r in zip(got, ref):
        assert_records_match(g, r, SV_TOL_BF16)
        assert sum(x["kind"] == "full_separation" for x in g) == 3


def test_bf16_serving_matches_jax(engines, target_wav):
    jax_eng, eng = engines
    mixes = [w for w in windows(seed=2, n=2)]
    got = {}
    for name, cls, e in (("jax", JaxStreamingServer, jax_eng), ("torch", StreamingServer, eng)):
        srv = cls(_args(process_seconds=2.0, compute_dtype="bfloat16"), engine=e,
                  autostart=False)
        try:
            sids = [srv.open_session(target_wav=target_wav) for _ in mixes]
            for sid, mix in zip(sids, mixes):
                srv.add_audio(sid, mix)
            assert srv.step() == len(mixes)
            got[name] = [srv.get_results(sid) for sid in sids]
        finally:
            srv.close()
    for g, r in zip(got["torch"], got["jax"]):
        assert_records_match(g, r, SV_TOL_BF16)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_bf16_streaming_cli(target_wav, tmp_path, quant):
    """The streaming application with ``--compute-dtype bfloat16`` builds a
    bf16 engine and analyses every window."""
    mix = _tone(4.0, 440) + np.concatenate([np.zeros(SR, np.float32), _tone(3.0, 880)])
    write_wav(tmp_path / "mix.wav", mix, SR)
    app = streaming_overlap_3src.main([
        "--target-wav", target_wav, "--input-wav", str(tmp_path / "mix.wav"), "--no-realtime",
        "--process-seconds", "2", "--sv-threshold", "-1", "--preset", "tiny",
        "--max-segment-sec", "8", "--provider", "cpu", "--quant", quant,
        "--compute-dtype", "bfloat16", "--output-dir", str(tmp_path / "out")])
    assert app.pipeline.engine.compute_dtype == torch.bfloat16
    assert app.pipeline.latency_stats()["chunks"] == 3
    assert sum(r["kind"] == "full_separation" for r in app.all_results) == 9


def test_bf16_serve_streams_cli(target_wav, tmp_path):
    wavs = []
    for i in range(2):
        p = tmp_path / f"s{i}.wav"
        write_wav(p, _tone(4.0, 440 + 100 * i), SR)
        wavs.append(str(p))
    out = tmp_path / "r.jsonl"
    stats = serve_streams.main([
        "--wavs", *wavs, "--targets", target_wav, "--sv-threshold", "-1", "--preset", "tiny",
        "--max-batch", "4", "--max-segment-sec", "8", "--provider", "cpu",
        "--compute-dtype", "bfloat16", "--out", str(out)])
    assert stats["sessions"] == 2 and stats["chunks_dropped"] == 0
    assert out.read_text().count("full_separation") == 2 * 2 * 3


# ------------------------------------------------------------ the other families, PyanNet, the mesh
# model-level tolerances, max |port - JAX| over max |JAX|, both at bf16 on
# shared weights (tests/test_bf16.py allows 5e-2 between f32 and bf16):
# Paraformer's logits past its float32 positional table only meet bf16 in
# in_proj, where both round alike (measured 7e-7); the transducer's two
# bf16 conv subsamplers and gelus flip a rounding here and there, carried
# through the encoder (measured 6.9e-3); whisper's one bf16 conv pair
# (measured 5.0e-4). Beam scores: |port - JAX| / |JAX| (measured 1.4e-4).
# PyanNet: absolute, on probabilities (measured 6e-8).
PARA_TOL = 1e-5
TRANSDUCER_TOL = 2e-2
WHISPER_TOL = 2e-3
BEAM_SCORE_RTOL = 1e-3
PYANNET_TOL = 1e-6
BF = torch.bfloat16


def _family_engines(name):
    """The JAX bf16 engine and the port's on one family's shared weights
    (64-symbol table), as tests/test_torch_asr_families_engine.py builds
    them in float32."""
    from audio_classification_tpu.engine import BucketSpec as JaxBucketSpec
    from audio_classification_tpu.engine import StageEngine as JaxStageEngine
    from test_torch_asr_families import LENGTHS, family_packs

    family, decoding = (("transducer", "modified_beam_search") if name.endswith("beam")
                        else (name, "greedy_search"))
    jax_pack, pack = family_packs(family, decoding=decoding, beam_width=3)
    return (JaxStageEngine(jax_pack, JaxBucketSpec(LENGTHS, 4), compute_dtype="bfloat16"),
            StageEngine(pack, BucketSpec(LENGTHS, 4), compute_dtype="bfloat16"))


def _family_feats(seed, b, t, d, lens):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, t, d)).astype(np.float32)
    return feats, np.arange(t)[None, :] < np.array(lens)[:, None]


def _assert_texts_equal_jax(jax_eng, eng):
    """Bucketed transcription of seeded bursts, and long form inside and
    past the largest bucket: texts equal, not all empty."""
    from test_torch_long_form import _bursts

    wavs = [_bursts(n, seed=s) for n, s in ((3800, 3), (7000, 4), (12000, 5), (2500, 6))]
    got = eng.transcribe(wavs)
    assert got == jax_eng.transcribe(wavs) and any(got)
    for n in (14000, 40000):
        wav = _bursts(n, seed=7)
        assert eng.transcribe_long(wav) == jax_eng.transcribe_long(wav), n


def _paraformer_parity():
    """CIF's token counts equal (fires decided on the same float32 alphas),
    logits of the fired tokens within PARA_TOL."""
    import jax.numpy as jnp

    jax_eng, eng = _family_engines("paraformer")
    assert eng.models["asr"].in_proj.weight.dtype == BF
    _assert_texts_equal_jax(jax_eng, eng)
    feats, mask = _family_feats(0, 3, 40, 560, [40, 31, 9])
    lj, cj = jax_eng.pack.asr_model.apply(jax_eng.exec_params["asr"],
                                          jnp.asarray(feats, jnp.bfloat16), jnp.asarray(mask))
    with torch.no_grad():
        lt, ct = eng.models["asr"](torch.from_numpy(feats).to(BF), torch.from_numpy(mask))
    lj, cj = np.asarray(lj, np.float32), np.asarray(cj)
    np.testing.assert_array_equal(ct.numpy(), cj)
    rows = (np.arange(lj.shape[1])[None, :] < cj[:, None])[..., None]
    assert lt.dtype == torch.float32
    assert np.abs((lt.numpy() - lj) * rows).max() <= PARA_TOL * np.abs(lj * rows).max()


def _encoder_outputs(jax_eng, eng, feats, mask):
    import jax.numpy as jnp

    ej, mj = jax_eng.pack.asr_model.apply(
        jax_eng.exec_params["asr"], jnp.asarray(feats, jnp.bfloat16), jnp.asarray(mask),
        method=lambda mod, x, m: mod.encoder(x, m))
    with torch.no_grad():
        et, mt = eng.models["asr"].encoder(torch.from_numpy(feats).to(BF), torch.from_numpy(mask))
    return np.asarray(ej, np.float32), np.asarray(mj), et, mt


def _transducer_parity():
    """Greedy texts equal; the encoder (float32 past its positional add)
    within TRANSDUCER_TOL; the predictor wholly bf16, as JAX's."""
    jax_eng, eng = _family_engines("transducer")
    _assert_texts_equal_jax(jax_eng, eng)
    feats, mask = _family_feats(1, 3, 120, 80, [120, 77, 30])
    ej, mj, et, mt = _encoder_outputs(jax_eng, eng, feats, mask)
    np.testing.assert_array_equal(mt.numpy(), mj)
    assert et.dtype == torch.float32
    assert np.abs((et.numpy() - ej) * mj[..., None]).max() <= TRANSDUCER_TOL * np.abs(ej).max()
    ctx = torch.zeros((2, eng.pack.transducer_cfg.context), dtype=torch.int64)
    with torch.no_grad():
        assert eng.models["asr"].predictor(ctx).dtype == BF


def _whisper_parity():
    """Greedy texts equal (long form with its scaled decode budget);
    teacher-forced logits (float32: the bf16 token embedding meets the
    float32 positional table) within WHISPER_TOL."""
    import jax.numpy as jnp

    jax_eng, eng = _family_engines("whisper")
    _assert_texts_equal_jax(jax_eng, eng)
    feats, mask = _family_feats(2, 2, 60, 80, [60, 33])
    toks = np.random.default_rng(3).integers(0, 64, (2, 7))
    lj = np.asarray(jax_eng.pack.asr_model.apply(
        jax_eng.exec_params["asr"], jnp.asarray(feats, jnp.bfloat16), jnp.asarray(mask),
        jnp.asarray(toks)), np.float32)
    with torch.no_grad():
        lt = eng.models["asr"](torch.from_numpy(feats).to(BF), torch.from_numpy(mask),
                               torch.from_numpy(toks))
    assert lt.dtype == torch.float32
    assert np.abs(lt.numpy() - lj).max() <= WHISPER_TOL * np.abs(lj).max()


def _pyannet_parity():
    """PyanNet OSD at bf16: the float32 wave through weights rounded to
    bf16, against the JAX PyanNet applied op by op to the bf16-cast params
    (the JAX engine's own bf16 osd_fn raises: its lax.conv refuses a
    float32 input with a bf16 kernel, so the reference here widens the two
    conv kernels to float32, as jnp's promotion does at every other op;
    ROADMAP §3). The hysteresis segments then equal the float32 engine's
    on the same activations' thresholds."""
    import jax
    import jax.numpy as jnp

    from audio_classification_tpu.engine import ModelPack as JaxModelPack
    from audio_classification_tpu.engine import StageEngine as JaxStageEngine
    from audio_classification_tpu.engine import tiny_preset as jax_tiny_preset
    from test_torch_pyannet import _models, _ragged

    jmodel, params, model = _models()
    pack = ModelPack(tiny_preset(), seed=0, device="cpu")
    pack.set_osd_pyannet(model.cfg, model.state_dict(), BinarizeConfig(onset=0.4, offset=0.3))
    eng = StageEngine(pack, BucketSpec((8000,), 2), compute_dtype="bfloat16")
    copy = eng.models["osd_pyannet"]
    assert next(copy.parameters()).dtype == torch.float32 and copy.edge_dtype == BF
    bf = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    widened = {**bf, **{f"conv{i}": {**bf[f"conv{i}"],
                                     "weight": bf[f"conv{i}"]["weight"].astype(jnp.float32)}
                        for i in (1, 2)}}
    wav, lens = _ragged(5, [6000, 4100, 2000])
    want = np.asarray(jmodel.apply(widened, wav, lens))
    with torch.no_grad():
        got = copy(torch.from_numpy(wav), torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, atol=PYANNET_TOL)
    # rounding the weights moves the activations: this is not the float32 net
    with torch.no_grad():
        f32 = model(torch.from_numpy(wav), torch.from_numpy(lens)).numpy()
    assert np.abs(f32 - want).max() > 10 * PYANNET_TOL
    segs = eng.osd_segments(wav[0], SR, 0.5, 0.5, 0.1)
    assert segs and segs[-1][1] == pytest.approx(6000 / SR)
    jax_pack = JaxModelPack(jax_tiny_preset(), seed=0)
    jax_pack.set_osd_pyannet(jmodel.cfg, params)
    with pytest.raises(TypeError, match="conv_general_dilated requires arguments to have the same"):
        JaxStageEngine(jax_pack, compute_dtype="bfloat16").osd_segments(wav[0], SR, 0.5, 0.5,
                                                                       0.1)


def _mesh_parity():
    """Long form over a mesh of 2 at bf16, SenseVoice and Paraformer (the
    JAX LONG_FORM_FAMILIES): texts equal to the JAX bf16 mesh engine's on 2
    virtual devices and to the port's unsharded bf16 engine."""
    from audio_classification_tpu.engine import BucketSpec as JaxBucketSpec
    from audio_classification_tpu.engine import StageEngine as JaxStageEngine
    from audio_classification_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from audio_classification_tpu_torch.parallel.mesh import make_mesh
    from test_torch_asr_families import LENGTHS, family_packs
    from test_torch_long_form import _bursts

    wav = _bursts(40000, seed=8)
    for family in StageEngine.LONG_FORM_FAMILIES:
        jax_pack, pack = family_packs(family)
        spec, jspec = BucketSpec(LENGTHS, 4), JaxBucketSpec(LENGTHS, 4)
        got = StageEngine(pack, spec, mesh=make_mesh(2, devices=["cpu"] * 2),
                          compute_dtype="bfloat16").transcribe_long(wav)
        assert got == JaxStageEngine(jax_pack, jspec, mesh=jax_make_mesh(2, model_axis=1),
                                     compute_dtype="bfloat16").transcribe_long(wav), family
        assert got == StageEngine(pack, spec, compute_dtype="bfloat16").transcribe_long(wav)
        assert len(got) >= 3


_PARITY = {"paraformer": _paraformer_parity, "transducer": _transducer_parity,
           "whisper": _whisper_parity, "pyannet": _pyannet_parity, "mesh": _mesh_parity}


@pytest.mark.parametrize("case", ["paraformer", "transducer", "whisper", "pyannet", "mesh"])
def test_bf16_out_of_scope_combinations_raise(case):
    """The combinations that raised until they were ported now run at bf16
    and agree with the JAX bf16 engine on shared weights (the name is
    kept from when they raised): the Paraformer, transducer and
    whisper-style families, PyanNet OSD and long form over a mesh. Each
    case's tolerances are stated above."""
    _PARITY[case]()


@pytest.mark.parametrize("backend,n_src", [("convtasnet", 3), ("mossformer", 2)])
def test_bf16_engine_separate_long_stays_float32(backend, n_src):
    """``Separator.separate_long`` on a bf16 engine runs the pack's float32
    models, as the JAX facade passes the float32 ``pack.params`` to
    ``sp_separate`` (models/facades.py:212-240): the same samples as on a
    float32 engine over the same pack."""
    from audio_classification_tpu_torch.models import facades
    from audio_classification_tpu_torch.parallel.mesh import make_mesh

    pack = ModelPack(tiny_preset(), seed=0, device="cpu")
    mesh = make_mesh(2, devices=["cpu"] * 2)
    x = _sig(6000, seed=4)
    outs = [facades.Separator(backend=backend, n_src=n_src,
                              engine=StageEngine(pack, compute_dtype=dt)).separate_long(x, SR, mesh)
            for dt in ("bfloat16", "float32")]
    assert len(outs[0]) == n_src
    for a, b in zip(*outs):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_bf16_transducer_beam_search_matches_jax():
    """modified_beam_search at bf16: texts equal; the best hypotheses'
    counts equal and their log-probabilities (log_softmax in float32)
    within BEAM_SCORE_RTOL."""
    import jax.numpy as jnp

    from audio_classification_tpu.models.asr.transducer import Transducer as JaxTransducer

    jax_eng, eng = _family_engines("transducer-beam")
    _assert_texts_equal_jax(jax_eng, eng)
    feats, mask = _family_feats(1, 3, 120, 80, [120, 77, 30])
    _ij, nj, sj = jax_eng.pack.asr_model.apply(
        jax_eng.exec_params["asr"], jnp.asarray(feats, jnp.bfloat16), jnp.asarray(mask), 3,
        True, method=JaxTransducer.beam_decode)
    with torch.no_grad():
        _it, nt, st = eng.models["asr"].beam_decode(torch.from_numpy(feats).to(BF),
                                                    torch.from_numpy(mask), 3, return_score=True)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=BEAM_SCORE_RTOL)


@pytest.mark.parametrize("family_flags", [["--paraformer", "seeded"], ["--encoder", "seeded",
                                                                          "--decoder", "seeded",
                                                                          "--joiner", "seeded"]])
def test_bf16_cli_with_another_family_raises(target_wav, tmp_path, monkeypatch, family_flags):
    """The streaming application with ``--compute-dtype bfloat16`` and a
    family's flags (the name is kept from when it raised): build_engine
    gets a bf16 config of that family, and the windows it analyses on the
    shared bf16 engine give the JAX streaming pipeline's records on the JAX
    bf16 engine (texts equal on seeded bursts)."""
    from audio_classification_tpu.engine import BucketSpec as JaxBucketSpec
    from audio_classification_tpu.engine import StageEngine as JaxStageEngine
    from audio_classification_tpu_torch.engine.bucketing import default_buckets
    from audio_classification_tpu_torch.pipelines import offline_overlap3, streaming
    from test_torch_long_form import _bursts

    family = "paraformer" if family_flags[0] == "--paraformer" else "transducer"
    jax_eng, eng = _family_engines(family)
    spec = default_buckets(SR, 0.5, 8.0)
    jax_eng = JaxStageEngine(jax_eng.pack, JaxBucketSpec(spec, 4), compute_dtype="bfloat16")
    eng = StageEngine(eng.pack, BucketSpec(spec, 4), compute_dtype="bfloat16")
    seen = []

    def shared(cfg, device=None):
        seen.append((offline_overlap3.asr_family(cfg), cfg.compute_dtype))
        return eng

    monkeypatch.setattr(streaming, "build_engine", shared)
    write_wav(tmp_path / "mix.wav",
              np.concatenate([_bursts(2 * SR, seed=31), _bursts(2 * SR, seed=32)]), SR)
    mix, _sr = read_wav(tmp_path / "mix.wav")  # the int16 samples the CLI reads
    app = streaming_overlap_3src.main([
        "--target-wav", target_wav, "--input-wav", str(tmp_path / "mix.wav"), "--no-realtime",
        "--process-seconds", "2", "--chunk-size", "1600", "--sv-threshold", "-1",
        "--preset", "tiny", "--max-segment-sec", "8", "--provider", "cpu",
        "--compute-dtype", "bfloat16", "--output-dir", str(tmp_path / "out"), *family_flags])
    assert seen == [(family, "bfloat16")]
    assert app.pipeline.engine is eng and app.pipeline.latency_stats()["chunks"] == 2
    ref, _ = run_stream(JaxStreamingPipeline, _args(compute_dtype="bfloat16"), target_wav,
                        jax_eng, [mix[: 2 * SR], mix[2 * SR:]])
    assert_records_match(app.all_results, [r for window in ref for r in window], SV_TOL_BF16)
    assert any(r["text"] for r in app.all_results)


def test_bf16_flag_reaches_build_engine():
    from audio_classification_tpu_torch.pipelines.offline_overlap3 import build_engine

    eng = build_engine(dataclasses.replace(Overlap3Config(), preset="tiny", provider="cpu",
                                           compute_dtype="bfloat16"))
    assert eng.compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        StageEngine(eng.pack, compute_dtype="float16")


def test_bf16_transcripts_equal_jax_on_bursts():
    """SenseVoice at bf16 on seeded bursts with the 64-symbol table, where
    the random tiny recognizer emits text: the texts equal the JAX bf16
    engine's, and are not all empty."""
    from audio_classification_tpu.engine import BucketSpec as JaxBucketSpec
    from audio_classification_tpu.engine import ModelPack as JaxModelPack
    from audio_classification_tpu.engine import StageEngine as JaxStageEngine
    from audio_classification_tpu.engine import tiny_preset as jax_tiny_preset
    from audio_classification_tpu.models.asr.tokens import TokenTable as JaxTokenTable
    from audio_classification_tpu_torch.convert.from_jax import params_to_state_dicts
    from audio_classification_tpu_torch.models.asr.tokens import TokenTable
    from test_torch_asr_families import CHARS
    from test_torch_long_form import _bursts

    jax_pack = JaxModelPack(jax_tiny_preset(), seed=0, tokens=JaxTokenTable.char_table(CHARS))
    pack = ModelPack(tiny_preset(), seed=1, device="cpu", tokens=TokenTable.char_table(CHARS))
    pack.load_state_dicts(params_to_state_dicts({k: jax_pack.params[k] for k in ModelPack.STAGES}))
    lengths = (4000, 8000, 16000)
    jax_eng = JaxStageEngine(jax_pack, JaxBucketSpec(lengths, 4), compute_dtype="bfloat16")
    eng = StageEngine(pack, BucketSpec(lengths, 4), compute_dtype="bfloat16")
    wavs = [_bursts(n, seed=s) for n, s in ((3800, 3), (7000, 4), (12000, 5), (2500, 6))]
    got = eng.transcribe(wavs)
    assert got == jax_eng.transcribe(wavs)
    assert any(got)
