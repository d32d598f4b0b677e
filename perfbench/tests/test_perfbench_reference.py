"""The plain reference (perfbench/reference) held to the port's CPU path at
tiny widths, model by model, on the benchmark's own weights: the port's
modules take them by strict ``load_state_dict`` (so the benchmark's spec
names every tensor the port has) and the reference reads them as they are.
This test imports both; the reference imports nothing of the port."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from perfbench import check, harness, weights  # noqa: E402
from perfbench.reference import models as M  # noqa: E402

TINY = Path(__file__).resolve().parent / "tiny"
CFG = json.loads((TINY / "tiny-convtasnet.json").read_text())
MOSS = json.loads((TINY / "tiny-mossformer.json").read_text())
OPS = M.Ops()
SV = harness.load_family("sensevoice")


def _waves(lengths, bucket, seed=0):
    g = torch.Generator().manual_seed(seed)
    wav = torch.zeros(len(lengths), bucket)
    for i, n in enumerate(lengths):
        t = torch.arange(n) / 16000.0
        wav[i, :n] = 0.3 * torch.sin(2 * np.pi * (150 + 40 * i) * t) * torch.rand(1, generator=g) \
            + 0.01 * torch.randn(n, generator=g)
    wav = torch.round(wav * 32768).clamp(-32768, 32767) / 32768
    return wav, torch.tensor(lengths)


def _port(cls, cfg_cls, values, sd):
    cfg = cfg_cls(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in values.items()})
    model = cls(cfg)
    model.load_state_dict(sd)
    return model.eval()


def _close(a, b, rel):
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= rel * max(scale, 1e-12), float((a - b).abs().max())


def test_fbank_and_lfr_match_the_port():
    from audio_classification_tpu_torch.ops.fbank import FbankConfig, apply_lfr, log_mel_fbank

    wav, lengths = _waves([16000, 9000], 16000)
    got, ref = log_mel_fbank(wav, FbankConfig()), M.fbank(OPS, wav)
    valid = torch.ones(got.shape[:2], dtype=torch.bool)
    assert check._power_err(got, ref, valid) < 1e-4
    torch.testing.assert_close(apply_lfr(ref, 7, 6), M.apply_lfr(ref, 7, 6))


def test_pyannet_matches_the_port(tmp_path):
    from audio_classification_tpu_torch.convert.torch_import import load_pyannet_torch
    from audio_classification_tpu_torch.models.pyannet import PyanNet

    path = str(tmp_path / "seg.ckpt")
    weights.write_pyannote_checkpoint(path, CFG["pyannet"], 3, "cpu")
    cfg, sd = load_pyannet_torch(path)
    port = PyanNet(cfg)
    port.load_state_dict(sd)
    wav, lengths = _waves([32000, 20000, 7000], 32000)
    with torch.no_grad():
        got = port.eval()(wav, lengths)
    ref = M.pyannet(OPS, weights.pyannote_state_dict(CFG["pyannet"], 3, "cpu"), wav, lengths)
    torch.testing.assert_close(got, ref, atol=2e-6, rtol=0)
    assert got.shape[1] == M.pyannet_frames(32000)


@pytest.mark.parametrize("bucket", [16000, 32000])
def test_convtasnet_matches_the_port(bucket):
    from audio_classification_tpu_torch.models.convtasnet import ConvTasNet, ConvTasNetConfig

    c = CFG["preset"]["sep3"]
    sd = weights.stage_weights("sep3", c, 4, "cpu")
    port = _port(ConvTasNet, ConvTasNetConfig, c, sd)
    wav, lengths = _waves([bucket, bucket - 5000, 3000], bucket)
    sm = (torch.arange(bucket)[None] < lengths[:, None]).float()
    with torch.no_grad():
        got = port(wav, sm)
    _close(got, M.convtasnet(OPS, sd, c, wav, lengths), 1e-5)


@pytest.mark.parametrize("bucket", [2000, 8000])  # the dense core; K4's twin (999 frames)
def test_mossformer_matches_the_port(bucket):
    from audio_classification_tpu_torch.models.mossformer import MossFormer, MossFormerConfig

    c = MOSS["preset"]["mossformer"]
    sd = weights.stage_weights("mossformer", c, 5, "cpu")
    port = _port(MossFormer, MossFormerConfig, c, sd)
    wav, lengths = _waves([bucket, bucket // 2], bucket)
    sm = (torch.arange(bucket)[None] < lengths[:, None]).float()
    with torch.no_grad():
        got = port(wav, sm)
    _close(got, M.mossformer(OPS, sd, c, wav, lengths), 1e-5)


def test_speaker_embedder_matches_the_port():
    from audio_classification_tpu_torch.models.speaker import (SpeakerEmbedder,
                                                               SpeakerEmbedderConfig)

    c = CFG["preset"]["spk"]
    sd = weights.stage_weights("spk", c, 6, "cpu")
    port = _port(SpeakerEmbedder, SpeakerEmbedderConfig, c, sd)
    wav, lengths = _waves([16000, 8000], 16000)
    feats = M.fbank(OPS, wav)
    valid = M.fbank_frames(lengths)
    mask = torch.arange(feats.shape[1])[None] < valid[:, None]
    with torch.no_grad():
        got = port(feats, mask)
    _close(got, M.speaker(OPS, sd, c, feats, mask), 1e-5)


@pytest.mark.parametrize("bucket", [128000, 512000])  # dense attention; K3's twin (537 frames)
def test_sensevoice_and_ctc_match_the_port(bucket):
    from audio_classification_tpu_torch.models.asr.ctc import ctc_greedy_decode
    from audio_classification_tpu_torch.models.asr.sensevoice import (SenseVoiceConfig,
                                                                      SenseVoiceEncoder,
                                                                      sensevoice_frontend)
    from audio_classification_tpu_torch.models.asr.tokens import TokenTable

    c = CFG["preset"]["asr"]
    sd = weights.stage_weights("asr", c, 7, "cpu", SV.spec)
    port = _port(SenseVoiceEncoder, SenseVoiceConfig, c, sd)
    wav, lengths = _waves([bucket, bucket // 3], bucket)
    feats, mask = M.sensevoice_frontend(OPS, c, wav, lengths)
    p_feats, p_mask = sensevoice_frontend(wav, lengths, port.cfg)
    torch.testing.assert_close(p_mask, mask)
    assert check._power_err(p_feats, feats, mask) < 1e-4
    with torch.no_grad():
        got = port(feats, mask)
    ref = M.sensevoice(OPS, sd, c, feats, mask)
    _close(got, ref, 1e-5)
    ids, n = ctc_greedy_decode(ref[:, 4:], mask)
    symbols = SV.token_symbols(c)
    table = TokenTable(dict(enumerate(symbols)), blank_id=0)
    mine = M.ctc_greedy(ref[:, 4:], mask, 512)
    for row, k, ids_ref in zip(ids, n, mine):
        assert row[:min(int(k), 512)].tolist() == ids_ref
        assert table.decode(row[:int(k)].tolist()) == M.decode_text(ids_ref, symbols)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.14159265])
    r = M.tf32_round(x)
    assert r[0] == 1.0 and r[2] == 1.0 + 2 ** -10
    bits = r.view(torch.int32) & 0x1FFF
    assert int(bits.abs().max()) == 0
    assert float((r - x).abs().max()) <= 2 ** -11 * 4
