"""The port's graph-aware importer (audio_classification_tpu_torch/convert/
onnx_graph_map) against the JAX package's (models/convert/onnx_graph_map).

Each fixture graph is the one tests/test_onnx_graph_map.py builds for its
mapper (speaker, SenseVoice float and int8, VAD, whisper, MossFormer,
Paraformer, transducer). Both importers map it; the two flax-layout trees
go through convert/from_jax.params_to_state_dicts and must be equal,
tensor for tensor, exactly; the port's state_dict then loads into the
port's module (names and shapes match). A topology mismatch raises the
same ValueError in both.
"""
import numpy as np
import pytest
import torch

from audio_classification_tpu.models.convert import onnx_graph_map as jax_map
from audio_classification_tpu.models.speaker import SpeakerEmbedderConfig
from audio_classification_tpu.models.vad import VADConfig
from audio_classification_tpu_torch.convert import onnx_graph_map as port_map
from audio_classification_tpu_torch.convert.from_jax import params_to_state_dicts
from audio_classification_tpu_torch.models.asr.paraformer import Paraformer, ParaformerConfig
from audio_classification_tpu_torch.models.asr.sensevoice import SenseVoiceConfig, SenseVoiceEncoder
from audio_classification_tpu_torch.models.asr.transducer import Transducer, TransducerConfig
from audio_classification_tpu_torch.models.asr.whisper_style import (WhisperStyle,
                                                                     WhisperStyleConfig)
from audio_classification_tpu_torch.models.mossformer import MossFormer, MossFormerConfig
from audio_classification_tpu_torch.models.speaker import SpeakerEmbedder
from audio_classification_tpu_torch.models.speaker import SpeakerEmbedderConfig as PortSpkConfig
from audio_classification_tpu_torch.models.vad import VADConfig as PortVADConfig
from audio_classification_tpu_torch.models.vad import VADNet
from helpers_onnx import GraphBuilder
from test_onnx_graph_map import (_build_mossformer_fixture, _build_sensevoice_fixture,
                                 _build_speaker_fixture, _build_tblock, _build_whisper_fixture)


def _rgemm(rng, gb, din, dout):
    gb.gemm((rng.standard_normal((dout, din)) * 0.2).astype(np.float32),
            (rng.standard_normal(dout) * 0.05).astype(np.float32))


def _rln(rng, gb, dim):
    gb.layernorm(rng.uniform(0.5, 1.5, dim).astype(np.float32),
                 (rng.standard_normal(dim) * 0.05).astype(np.float32))


def _paraformer(rng, gb):
    """tests/test_onnx_graph_map.py's Paraformer fixture."""
    cfg = ParaformerConfig(vocab_size=11, dim=16, heads=2, enc_layers=2, dec_layers=1,
                           ffn_mult=2, conv_kernel=3, max_tokens=6, lfr_m=1, num_mel=10)
    _rgemm(rng, gb, 10, cfg.dim)
    for _ in range(cfg.enc_layers):
        _build_tblock(cfg.dim, cfg.ffn_mult, cfg.conv_kernel, rng, gb)
    _rln(rng, gb, cfg.dim)
    _rgemm(rng, gb, cfg.dim, cfg.dim)
    _rgemm(rng, gb, cfg.dim, 1)
    for _ in range(cfg.dec_layers):
        _build_tblock(cfg.dim, cfg.ffn_mult, 0, rng, gb)
    _rln(rng, gb, cfg.dim)
    _rgemm(rng, gb, cfg.dim, cfg.vocab_size)
    return cfg, cfg


def _transducer(rng, gb):
    """tests/test_onnx_graph_map.py's transducer fixture (one graph: the
    encoder, predictor and joiner nodes in execution order)."""
    cfg = TransducerConfig(vocab_size=11, dim=16, heads=2, layers=2, ffn_mult=2,
                           conv_kernel=3, context=2, pred_dim=12, joiner_dim=10, num_mel=6)
    for cin in (cfg.num_mel, cfg.dim):
        gb.conv((rng.standard_normal((cfg.dim, cin, 5)) * 0.3).astype(np.float32),
                (rng.standard_normal(cfg.dim) * 0.05).astype(np.float32), strides=[2])
    for _ in range(cfg.layers):
        _build_tblock(cfg.dim, cfg.ffn_mult, cfg.conv_kernel, rng, gb)
    _rln(rng, gb, cfg.dim)
    emb = (rng.standard_normal((cfg.vocab_size, cfg.pred_dim)) * 0.1).astype(np.float32)
    gb.raw("Gather", [gb.add_init("emb", emb), gb.add_init("ids", np.array([0], np.int64))],
           ["pred_emb"])
    _rgemm(rng, gb, cfg.context * cfg.pred_dim, cfg.pred_dim)
    _rgemm(rng, gb, cfg.dim, cfg.joiner_dim)
    _rgemm(rng, gb, cfg.pred_dim, cfg.joiner_dim)
    _rgemm(rng, gb, cfg.joiner_dim, cfg.vocab_size)
    return cfg, cfg


def _speaker(rng, gb):
    kw = dict(num_mel=8, channels=(4, 8), scale=2, embed_dim=16, asp_hidden=24)
    _build_speaker_fixture(SpeakerEmbedderConfig(**kw), rng, gb)
    return SpeakerEmbedderConfig(**kw), PortSpkConfig(**kw)


def _sensevoice(int8):
    def build(rng, gb):
        cfg = SenseVoiceConfig(vocab_size=11, dim=16, heads=2, layers=2, ffn_mult=2,
                               conv_kernel=3, lfr_m=3, num_mel=4)
        _build_sensevoice_fixture(cfg, 12, rng, gb, int8_qkv=int8)
        return cfg, cfg
    return build


def _vad(rng, gb):
    kw = dict(num_mel=8, dim=12, layers=2, kernel=3)
    cin = kw["num_mel"]
    for i in range(kw["layers"]):
        gb.conv((rng.standard_normal((kw["dim"], cin, kw["kernel"])) * 0.3).astype(np.float32),
                (rng.standard_normal(kw["dim"]) * 0.1).astype(np.float32), dilations=[2 ** i])
        cin = kw["dim"]
    _rgemm(rng, gb, kw["dim"], 1)
    return VADConfig(**kw), PortVADConfig(**kw)


def _whisper(rng, gb):
    cfg = WhisperStyleConfig(vocab_size=13, dim=16, heads=2, enc_layers=2, dec_layers=2,
                             ffn_mult=2, num_mel=6, max_decode_len=8)
    _build_whisper_fixture(cfg, rng, gb)
    return cfg, cfg


def _mossformer(rng, gb):
    cfg = MossFormerConfig(n_src=2, enc_dim=12, enc_kernel=8, dim=16, qk_dim=8, expansion=2,
                           layers=2, conv_kernel=5)
    _build_mossformer_fixture(cfg, rng, gb)
    return cfg, cfg


# mapper -> (fixture, the port's module of its config)
FIXTURES = {
    "speaker": (_speaker, SpeakerEmbedder),
    "sensevoice-float": (_sensevoice(False), SenseVoiceEncoder),
    "sensevoice-int8": (_sensevoice(True), SenseVoiceEncoder),
    "vad": (_vad, VADNet),
    "whisper": (_whisper, WhisperStyle),
    "mossformer": (_mossformer, MossFormer),
    "paraformer": (_paraformer, Paraformer),
    "transducer": (_transducer, Transducer),
}


def build_fixture(name, path):
    """Write FIXTURES[name]'s graph to ``path`` -> (jax cfg, port cfg)."""
    gb = GraphBuilder()
    cfgs = FIXTURES[name][0](np.random.default_rng(len(name)), gb)
    gb.write(path)
    return cfgs


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_port_import_equals_jax_import(tmp_path, name):
    path = str(tmp_path / f"{name}.onnx")
    jcfg, tcfg = build_fixture(name, path)
    target = name.split("-")[0]
    want = params_to_state_dicts({"m": jax_map.import_onnx(path, target, jcfg)})["m"]
    got = port_map.import_onnx_state_dict(path, target, tcfg)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    module = FIXTURES[name][1](tcfg)
    module.load_state_dict(got)  # strict: every name and shape of the module


def test_import_onnx_rejects_topology_mismatch(tmp_path):
    """A speaker graph imported as VAD fails loud in both, with one message."""
    path = str(tmp_path / "s.onnx")
    build_fixture("speaker", path)
    errors = []
    for mod, cfg in ((jax_map, VADConfig(num_mel=8, dim=12, layers=2, kernel=3)),
                     (port_map, PortVADConfig(num_mel=8, dim=12, layers=2, kernel=3))):
        with pytest.raises(ValueError) as e:
            mod.import_onnx(path, "vad", cfg)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    with pytest.raises(ValueError, match="unknown map target"):
        port_map.import_onnx(path, "bogus", None)
