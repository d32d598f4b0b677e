"""PyTorch port vs the JAX package: the torch-checkpoint and am.mvn imports
and what they open (CPU, float32). One file written here with
``torch.save`` (seeded tensors under pyannote's, asteroid's or ClearVoice's
published names; no real checkpoint is fetched) is read by both packages'
importers, and the models, engines, pipelines and facades that load it are
held to the JAX ones:

- the importers give equal tensors; MossFormer drift raises
  ``MossFormerImportError`` in both;
- ``load_kaldi_cmvn`` in both file forms;
- ``build_engine`` with every newly opened flag (--cmvn, --sep-checkpoint,
  --osd-checkpoint and the four hysteresis flags); orbax directories still
  raise naming slice 14;
- ``osd_segments_batch`` with PyanNet, with and without hysteresis;
- the flagship pipeline in both forced scenes with a PyanNet .ckpt,
  --sep-checkpoint and --cmvn: records equal (kind, span, stream, text
  exact; sv_score within 1e-4);
- ``Separator(checkpoint=file)``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from audio_classification_tpu.engine import BucketSpec as JaxBucketSpec
from audio_classification_tpu.engine import ModelPack as JaxModelPack
from audio_classification_tpu.engine import StageEngine as JaxStageEngine
from audio_classification_tpu.engine import default_buckets as jax_default_buckets
from audio_classification_tpu.engine import tiny_preset as jax_tiny_preset
from audio_classification_tpu.models import facades as jax_facades
from audio_classification_tpu.models import pyannet as jax_pyannet
from audio_classification_tpu.models.convert import assets as jax_assets
from audio_classification_tpu.models.convert import torch_import as jax_import
from audio_classification_tpu.pipelines.offline_overlap3 import Overlap3Pipeline as JaxPipeline
from audio_classification_tpu.pipelines.offline_overlap3 import build_engine as jax_build_engine
from audio_classification_tpu.utils.config import Overlap3Config as JaxConfig
from audio_classification_tpu_torch.audio_io import write_wav
from audio_classification_tpu_torch.convert import assets, torch_import
from audio_classification_tpu_torch.convert.from_jax import (
    params_to_state_dicts,
    pyannet_params_to_state_dict,
    variables_to_state_dict,
)
from audio_classification_tpu_torch.engine import BucketSpec, ModelPack, StageEngine, tiny_preset
from audio_classification_tpu_torch.engine.bucketing import default_buckets
from audio_classification_tpu_torch.models import facades, pyannet
from audio_classification_tpu_torch.models.convtasnet import ConvTasNet
from audio_classification_tpu_torch.models.mossformer import MossFormer
from audio_classification_tpu_torch.pipelines.offline_overlap3 import (
    Overlap3Pipeline,
    build_engine,
)
from audio_classification_tpu_torch.utils.config import Overlap3Config
from torch_port_helpers import (
    asteroid_convtasnet_state_dict,
    clearvoice_mossformer_state_dict,
    pyannote_state_dict,
    save_torch_checkpoint,
    write_am_mvn,
)

torch.set_num_threads(2)
SR = 16000
# a small pyannote segmentation model at 16 kHz with pyannote's sinc kernel
# and stride (251 / 10, the importers' defaults)
PN = dict(sample_rate=SR, n_filters=8, kernel_size=251, stride=10, conv_channels=(6, 6),
          conv_kernel=5, pool=3, lstm_hidden=8, lstm_layers=2, linear_dims=(8,), num_classes=3)


def _assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def _pyannote_ckpt(path, seed=0, nested=True, **over):
    cfg = jax_pyannet.PyanNetConfig(**{**PN, **over})
    return save_torch_checkpoint(path, pyannote_state_dict(cfg, np.random.RandomState(seed)),
                                 nested=nested)


def _lfr_dim():
    cfg = tiny_preset().asr
    return cfg.lfr_m * cfg.num_mel


def _am_mvn(path, bare=False, seed=3):
    rng = np.random.default_rng(seed)
    d = _lfr_dim()
    return write_am_mvn(path, (-8.0 + rng.standard_normal(d)).astype(np.float32),
                        (0.25 + 0.05 * rng.random(d)).astype(np.float32), bare=bare)


# ------------------------------------------------------------------ importers
@pytest.mark.parametrize("nested,over", [
    (True, {}), (False, {}), (True, dict(analytic=False, conv_channels=(6,), lstm_layers=1,
                                          linear_dims=(8, 8), num_classes=2)),
    (True, dict(bidirectional=False))])
def test_load_pyannet_torch_matches_jax(tmp_path, nested, over):
    """The same file: the config inferred equal, the port's state_dict equal
    tensor for tensor to the JAX params carried across by from_jax, and the
    two forwards on a ragged batch within 1e-5 of the probabilities."""
    path = _pyannote_ckpt(tmp_path / "seg.ckpt", nested=nested, **over)
    jcfg, params = jax_import.load_pyannet_torch(path)
    cfg, sd = torch_import.load_pyannet_torch(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _assert_state_dicts_equal(sd, pyannet_params_to_state_dict(params))
    model = pyannet.PyanNet(cfg)
    model.load_state_dict(sd)
    rng = np.random.RandomState(1)
    wav = (0.3 * rng.randn(2, 8000)).astype(np.float32)
    wav[1, 5000:] = 0.0
    lens = np.asarray([8000, 5000], np.int32)
    want = np.asarray(jax.jit(jax_pyannet.PyanNet(jcfg).apply)(params, wav, lens))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(wav), torch.from_numpy(lens)).numpy()
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("n_src", [3, 2])
def test_load_convtasnet_torch_matches_jax(tmp_path, n_src):
    """An asteroid Conv-TasNet file: the port's state_dict equal tensor for
    tensor to the JAX params carried across by from_jax, and it loads into
    the port's model of that config."""
    cfg = getattr(tiny_preset(), f"sep{n_src}")
    path = save_torch_checkpoint(
        tmp_path / "tasnet.pth", asteroid_convtasnet_state_dict(cfg, np.random.RandomState(n_src)))
    jcfg = getattr(jax_tiny_preset(), f"sep{n_src}")
    want = variables_to_state_dict(jax_import.load_convtasnet_torch(path, jcfg))
    got = torch_import.load_convtasnet_torch(path, cfg)
    _assert_state_dicts_equal(got, want)
    ConvTasNet(cfg).load_state_dict(got)


def test_load_mossformer_torch_matches_jax(tmp_path):
    """A ClearVoice-named MossFormer file (with a rotary buffer riding
    along): equal tensors, and it loads into the port's model."""
    cfg = tiny_preset().mossformer
    path = save_torch_checkpoint(
        tmp_path / "moss.bin", clearvoice_mossformer_state_dict(cfg, np.random.RandomState(4)))
    want = variables_to_state_dict(
        jax_import.load_mossformer_torch(path, jax_tiny_preset().mossformer))
    got = torch_import.load_mossformer_torch(path, cfg)
    _assert_state_dicts_equal(got, want)
    MossFormer(cfg).load_state_dict(got)


@pytest.mark.parametrize("drift", ["renamed", "extra", "shape"])
def test_mossformer_drift_raises_in_both(tmp_path, drift):
    """Drifted naming, a leftover weight or a wrong shape: both importers
    raise MossFormerImportError, listing the same roles and leftovers."""
    cfg = tiny_preset().mossformer
    sd = clearvoice_mossformer_state_dict(cfg, np.random.RandomState(5))
    key = "mask_net.mdl.mossformerM.layers.1.to_v.weight"
    if drift == "renamed":
        sd["mask_net.mdl.mossformerM.layers.1.to_value.weight"] = sd.pop(key)
    elif drift == "extra":
        sd["mask_net.extra_gate.weight"] = np.ones((3, 3), np.float32)
    else:
        sd[key] = sd[key][:, :-1]
    path = save_torch_checkpoint(tmp_path / "moss.bin", sd)
    with pytest.raises(jax_import.MossFormerImportError) as jerr:
        jax_import.load_mossformer_torch(path, jax_tiny_preset().mossformer)
    with pytest.raises(torch_import.MossFormerImportError) as err:
        torch_import.load_mossformer_torch(path, cfg)
    assert err.value.missing == jerr.value.missing
    assert err.value.unused == jerr.value.unused
    assert len(err.value.shape_errors) == len(jerr.value.shape_errors) == (drift == "shape")


@pytest.mark.parametrize("bare", [False, True])
def test_load_kaldi_cmvn_matches_jax(tmp_path, bare):
    path = _am_mvn(tmp_path / "am.mvn", bare=bare)
    (js, jr), (s, r) = jax_assets.load_kaldi_cmvn(path), assets.load_kaldi_cmvn(path)
    assert s.dtype == r.dtype == np.float32 and s.shape == (_lfr_dim(),)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(r, jr)
    (tmp_path / "bad.mvn").write_text("<Nnet> [ 1 2 ] </Nnet>")
    with pytest.raises(ValueError, match="am.mvn"):
        assets.load_kaldi_cmvn(tmp_path / "bad.mvn")


# ------------------------------------------------------------------ engines
def _cfg(tmp_path, **kw):
    return dict(preset="tiny", seed=0, max_batch=4, max_segment_sec=4.0, **kw)


def test_build_engine_opens_every_flag(tmp_path):
    """--cmvn, --sep-checkpoint and --osd-checkpoint with hysteresis flags:
    the port's engine carries what the JAX engine carries (CMVN vectors,
    the separator's weights, PyanNet's config and BinarizeConfig with the
    unset fields at their defaults); without hysteresis flags no
    BinarizeConfig, as in JAX."""
    files = dict(cmvn=_am_mvn(tmp_path / "am.mvn"),
                 sep_checkpoint=save_torch_checkpoint(
                     tmp_path / "tasnet.pth",
                     asteroid_convtasnet_state_dict(tiny_preset().sep3, np.random.RandomState(0))),
                 osd_checkpoint=_pyannote_ckpt(tmp_path / "seg.ckpt"))
    for hyst in (dict(osd_onset=0.6, osd_min_off=0.2), {}):
        kw = _cfg(tmp_path, **files, **hyst)
        jeng = jax_build_engine(JaxConfig(**kw))
        eng = build_engine(Overlap3Config(**kw, provider="cpu"))
        jp, p = jeng.pack, eng.pack
        np.testing.assert_array_equal(p.cmvn_shift.numpy(), np.asarray(jp.cmvn_shift))
        np.testing.assert_array_equal(p.cmvn_scale.numpy(), np.asarray(jp.cmvn_scale))
        _assert_state_dicts_equal(
            {k: v for k, v in p.models["sep3"].state_dict().items()},
            variables_to_state_dict(jp.params["sep3"]))
        assert dataclasses.asdict(p.osd_pyannet.cfg) == dataclasses.asdict(jp.osd_pyannet.cfg)
        _assert_state_dicts_equal(p.osd_pyannet.state_dict(),
                                  pyannet_params_to_state_dict(jp.params["osd"]))
        if hyst:
            assert dataclasses.asdict(p.osd_binarize) == dataclasses.asdict(jp.osd_binarize)
            assert (p.osd_binarize.onset, p.osd_binarize.offset,
                    p.osd_binarize.min_duration_off) == (0.6, 0.5, 0.2)
        else:
            assert p.osd_binarize is None and jp.osd_binarize is None


@pytest.mark.parametrize("flag", ["sep_checkpoint", "osd_checkpoint"])
def test_orbax_checkpoints_still_raise(tmp_path, flag):
    """An orbax directory raises NotImplementedError naming slice 14 and the
    converter; an --osd-checkpoint that names neither a directory (the
    params cli/distill_osd writes load since it is ported) nor a torch file
    raises FileNotFoundError."""
    (tmp_path / "_CHECKPOINT_METADATA").write_text("{}")  # what orbax writes
    with pytest.raises(NotImplementedError, match="orbax_to_torch.*slice 14"):
        build_engine(Overlap3Config(**_cfg(tmp_path), provider="cpu", **{flag: str(tmp_path)}))
    if flag == "osd_checkpoint":
        with pytest.raises(FileNotFoundError, match="distill_osd"):
            build_engine(Overlap3Config(**_cfg(tmp_path), provider="cpu", **{flag: "osd_params"}))


def _shared_engines(tmp_path, binarize=None, cmvn=None):
    """The JAX engine and the port's on the same tiny weights, both serving
    OSD with PyanNet from one pyannote file (and CMVN from one am.mvn)."""
    kw = _cfg(tmp_path, osd_checkpoint=_pyannote_ckpt(tmp_path / "seg.ckpt", seed=11))
    if cmvn:
        kw["cmvn"] = cmvn
    for key, value in (binarize or {}).items():
        kw[f"osd_{key}"] = value
    jeng = jax_build_engine(JaxConfig(**kw))
    eng = build_engine(Overlap3Config(**kw, provider="cpu"))
    eng.pack.load_state_dicts(params_to_state_dicts(
        {k: jeng.pack.params[k] for k in ModelPack.STAGES if k != "osd"}))
    return jeng, eng


def _bursts(seed, n):
    """Noise bursts of varying level: PyanNet's scores move with them."""
    rng = np.random.default_rng(seed)
    env = np.repeat(rng.uniform(0.05, 1.0, n // 1600 + 1), 1600)[:n]
    return (0.3 * env * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("binarize", [None, dict(onset=0.52, offset=0.48),
                                      dict(onset=0.5, offset=0.5, min_on=0.1, min_off=0.1)])
def test_osd_segments_batch_with_pyannet_matches_jax(tmp_path, binarize):
    """PyanNet OSD over a ragged batch (segments from the plain threshold,
    or from the hysteresis with and without duration pruning): the segment
    lists equal to the JAX engine's."""
    jeng, eng = _shared_engines(tmp_path, binarize)
    wavs = [_bursts(1, SR * 3), _bursts(2, 25000), _bursts(3, 9000)]
    probs = StageEngine._collect_bucketed(eng.launch_osd_batch(wavs, SR)[0])
    assert max(float(p[:, 1].max()) for p in probs) > 0.5 > min(float(p[:, 1].min())
                                                               for p in probs)
    want = jeng.osd_segments_batch(wavs, SR, 0.5, 0.5, 0.1)
    got = eng.osd_segments_batch(wavs, SR, 0.5, 0.5, 0.1)
    assert got == want
    assert all(s[0][0] == 0.0 for s in got)


@pytest.mark.parametrize("scene", ["overlap", "clean"])
def test_flagship_pipeline_with_checkpoints_matches_jax(tmp_path, scene):
    """The flagship file-mode pipeline with a PyanNet .ckpt forced through
    the hysteresis flags (onset = offset = 0: every frame overlapped, with
    min_on / min_off 0.1; 1: every frame clean), --sep-checkpoint and
    --cmvn: records equal to the JAX pipeline's (kind, span, stream, text
    exact; sv_score within 1e-4)."""
    t = np.arange(3 * SR) / SR
    mix = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 990 * t)
           + 0.02 * np.random.default_rng(0).standard_normal(t.size)).astype(np.float32)
    write_wav(tmp_path / "mix.wav", mix, SR)
    write_wav(tmp_path / "target.wav", (0.3 * np.sin(2 * np.pi * 440 * t[: 2 * SR]))
              .astype(np.float32), SR)
    hyst = dict(onset=0.0, offset=0.0, min_on=0.1, min_off=0.1) if scene == "overlap" else \
        dict(onset=1.0, offset=1.0)
    sep = save_torch_checkpoint(
        tmp_path / "tasnet.pth",
        asteroid_convtasnet_state_dict(tiny_preset().sep3, np.random.RandomState(6)))
    kw = _cfg(tmp_path, osd_checkpoint=_pyannote_ckpt(tmp_path / "seg.ckpt", seed=12),
              sep_checkpoint=sep, cmvn=_am_mvn(tmp_path / "am.mvn"),
              **{f"osd_{k}": v for k, v in hyst.items()})
    run = dict(input_wavs=[str(tmp_path / "mix.wav")], target_wav=str(tmp_path / "target.wav"),
               sv_threshold=-1.0)
    jeng = jax_build_engine(JaxConfig(**kw))
    eng = build_engine(Overlap3Config(**kw, provider="cpu"))
    eng.pack.load_state_dicts(params_to_state_dicts(
        {k: jeng.pack.params[k] for k in ModelPack.STAGES if k not in ("osd", "sep3")}))
    want = JaxPipeline(JaxConfig(**kw, **run), engine=jeng).run().segments
    got = Overlap3Pipeline(Overlap3Config(**kw, **run, provider="cpu"), engine=eng).run().segments
    assert got and all(r["kind"] == scene for r in got)
    key = lambda r: (r["kind"], r["start"], r["end"], r["stream"], r["text"])  # noqa: E731
    assert [key(r) for r in got] == [key(r) for r in want]
    for g, w in zip(got, want):
        assert abs(g["sv_score"] - w["sv_score"]) <= 1e-4


@pytest.mark.parametrize("backend,n_src", [("convtasnet", 3), ("convtasnet", 2),
                                           ("mossformer", 2)])
def test_separator_checkpoint_matches_jax(tmp_path, backend, n_src):
    """Separator(checkpoint=file) in both packages on one file: the
    separated streams within 1e-4 of max|ref| (float32 through the
    separator's blocks)."""
    preset = tiny_preset()
    if backend == "mossformer":
        sd = clearvoice_mossformer_state_dict(preset.mossformer, np.random.RandomState(8))
    else:
        sd = asteroid_convtasnet_state_dict(getattr(preset, f"sep{n_src}"),
                                            np.random.RandomState(7))
    path = save_torch_checkpoint(tmp_path / "sep.pth", sd, nested=False)
    jeng = JaxStageEngine(JaxModelPack(jax_tiny_preset(), seed=0),
                          JaxBucketSpec(jax_default_buckets(SR, 0.5, 4.0), 2))
    eng = StageEngine(ModelPack(tiny_preset(), seed=1, device="cpu"),
                      BucketSpec(default_buckets(SR, 0.5, 4.0), 2))
    jsep = jax_facades.Separator(backend=backend, n_src=n_src, checkpoint=path, engine=jeng)
    sep = facades.Separator(backend=backend, n_src=n_src, checkpoint=path, engine=eng)
    wav = _bursts(9, 2 * SR)
    want, got = jsep.separate(wav, SR), sep.separate(wav, SR)
    assert len(got) == len(want) == n_src
    peak = max(np.abs(w).max() for w in want)
    assert max(np.abs(g - w).max() for g, w in zip(got, want)) <= 1e-4 * peak
