"""The benchmark's frozen work formulas equal the port's ``ops/kernels/*.work``
today, at the shapes the cells run, so that a drift of either shows."""
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from perfbench import harness, work  # noqa: E402

HERE = Path(__file__).resolve().parents[1]
TSE3 = json.loads((HERE / "configs" / "tse3-convtasnet.json").read_text())
MOSS = json.loads((HERE / "configs" / "tse2-mossformer.json").read_text())
SV = harness.load_family("sensevoice")


def test_k1_work_matches_at_the_cells_frame_counts():
    import torch

    from audio_classification_tpu_torch.ops.fbank import FbankConfig, fbank_bases
    from audio_classification_tpu_torch.ops.kernels import fbank

    b = fbank_bases(FbankConfig(), torch.device("cpu"))
    assert work.mel_bank_counts() == (b.mel_nnz, b.band_w.shape[0])
    for n in (799, 1598, 3198, 8 * 1598, 24 * 1598):
        assert work.k1_work(n, 512, 80, b.mel_nnz, b.band_w.shape[0]) == \
            fbank.work(n, 512, 80, b.mel_nnz, b.band_w.shape[0])


@pytest.mark.parametrize("f_len", [None, [15999, 12000, 9000, 8499, 14000, 13000, 10000, 11000]])
def test_k2_work_matches_at_tse3_overlap(f_len):
    from audio_classification_tpu_torch.ops.kernels import tcn

    c = TSE3["preset"]["sep3"]
    nb = c["n_blocks"] * c["n_repeats"]
    b, h = c["bottleneck"], c["hidden"]
    wbytes = 4 * nb * (3 * b * h + 3 * h + 10 * h)  # w_in, w_res | w_skip, w_dw, vectors
    args = (8, 15999, c["bottleneck"], c["hidden"], nb, wbytes, f_len)
    assert work.k2_work(*args) == tcn.work(*args)


@pytest.mark.parametrize("keys", [None, [537, 400, 300, 537, 250, 537, 480, 510]])
def test_k3_work_matches_at_tse3_clean(keys):
    from audio_classification_tpu_torch.ops.kernels import attention

    a = TSE3["preset"]["asr"]
    args = (8, a["heads"], 537, 537, a["dim"] // a["heads"], 4, True, keys)
    assert work.k3_work(*args) == attention.work(*args)


@pytest.mark.parametrize("keys", [None, [11999]])
def test_k4_work_matches_at_mf2_overlap(keys):
    from audio_classification_tpu_torch.ops.kernels import gau

    m = MOSS["preset"]["mossformer"]
    args = (1, 15999, m["qk_dim"], m["dim"] * m["expansion"], 4, True, keys)
    assert work.k4_work(*args) == gau.work(*args)


def test_model_flops_are_dominated_by_the_layers_the_cells_name():
    n = 16 * 16000
    a = TSE3["preset"]["asr"]
    assert SV.sensevoice_flops(n, a) > 1e10
    assert work.mossformer_flops(8 * 16000, MOSS["preset"]["mossformer"]) > \
        20 * work.convtasnet_flops(8 * 16000, TSE3["preset"]["sep3"])
    job = work.job_flops([n] * 8, 96000, TSE3, "overlap", SV)
    clean = work.job_flops([n] * 8, 96000, TSE3, "clean", SV)
    assert job > clean > 0
