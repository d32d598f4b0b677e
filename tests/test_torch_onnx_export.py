"""The port's ONNX exporters (audio_classification_tpu_torch/convert/
onnx_export) against the JAX package's (models/convert/onnx_export).

The port exports a module through convert/from_jax.state_dict_to_variables,
which turns its weights back into the flax-layout tree the JAX modules hold
(held here to the JAX modules' own trees: the same names and shapes, and
back through from_jax to the same tensors). Given that tree, the two
exporters write the same file, byte for byte, for each of the seven
exporters and each of its ``quant`` modes, but for two named differences:

* the ModelProto's producer name: the port writes its own package's name
  (``onnx_export.PRODUCER``); everything after that field is compared byte
  for byte;
* PyanNet's sinc filter bank, the one initializer computed at export: the
  port's comes from torch's sin / cos, the JAX one from XLA's, so the
  ``sinc`` initializer is held to four float32 ulps of its max and every
  other byte of the file is compared.

Then each float export runs through the port's executor against the port's
module on the same input. The weights are the port's tiny seeded pack.
"""
import numpy as np
import pytest
import torch

from audio_classification_tpu.engine import tiny_preset as jax_tiny_preset
from audio_classification_tpu.models import pyannet as jax_pyannet
from audio_classification_tpu.models.convert import onnx_export as jax_export
from audio_classification_tpu_torch.convert import onnx_export as port_export
from audio_classification_tpu_torch.convert.from_jax import (
    module_variables, pyannet_params_to_state_dict, pyannet_state_dict_to_params,
    state_dict_to_variables, variables_to_state_dict)
from audio_classification_tpu_torch.convert.onnx_exec import OnnxModel
from audio_classification_tpu_torch.convert.onnx_import import load_onnx_graph
from audio_classification_tpu_torch.engine import ModelPack, tiny_preset
from audio_classification_tpu_torch.models import pyannet
from torch_onnx_helpers import jax_twin

PN_KW = dict(n_filters=8, kernel_size=51, stride=10, conv_channels=(8,), conv_kernel=5,
             pool=3, lstm_hidden=8, lstm_layers=2, linear_dims=(8,), num_classes=3)


@pytest.fixture(scope="module")
def packs():
    tpack = ModelPack(tiny_preset(), seed=0, device="cpu")
    jpack = jax_twin(tpack, jax_tiny_preset())
    jcfg = jax_pyannet.PyanNetConfig(**PN_KW)
    jpn = jax_pyannet.init_pyannet_params(jcfg, seed=0)
    tpn = pyannet.PyanNet(pyannet.PyanNetConfig(**PN_KW))
    tpn.load_state_dict(pyannet_params_to_state_dict(jpn))
    return jpack, tpack, (jcfg, jpn, tpn.eval())


# (exporter, pack stage, quant modes, length keyword)
EXPORTS = {
    "convtasnet": ("export_convtasnet", "sep3", ("none", "qdq"), dict(seconds=0.25)),
    "sensevoice": ("export_sensevoice", "asr", ("none", "int8", "qdq"), dict(frames=12)),
    "osdnet": ("export_osdnet", "osd", ("none", "qdq"), dict(frames=20)),
    "mossformer": ("export_mossformer", "mossformer", (None,), dict(seconds=0.25)),
    "speaker": ("export_speaker", "spk", ("none", "qdq"), dict(frames=20)),
    "vadnet": ("export_vadnet", "vad", ("none", "qdq"), dict(frames=20)),
}
CASES = [(k, q) for k, (_, _, qs, _) in EXPORTS.items() for q in qs] + [("pyannet", None)]


def _cfg(pack, stage):
    if stage == "asr":
        return pack.asr_cfg
    return getattr(pack.preset, stage)


def _export_pair(packs, tmp_path, name, quant):
    jpack, tpack, (jcfg, jpn, tpn) = packs
    jpath, tpath = str(tmp_path / "jax.onnx"), str(tmp_path / "port.onnx")
    if name == "pyannet":
        jax_export.export_pyannet(jpn, jcfg, jpath, samples=2000)
        port_export.export_pyannet(pyannet_state_dict_to_params(tpn.state_dict()), tpn.cfg,
                                   tpath, samples=2000)
        return jpath, tpath
    fn, stage, _, kw = EXPORTS[name]
    kw = dict(kw) if quant is None else dict(kw, quant=quant)
    getattr(jax_export, fn)(jpack.params[stage], _cfg(jpack, stage), jpath, **kw)
    getattr(port_export, fn)(state_dict_to_variables(tpack.models[stage]),
                             _cfg(tpack, stage), tpath, **kw)
    return jpath, tpath


def _split_producer(blob: bytes, producer: str):
    """ModelProto: ir_version (field 1) then producer_name (field 2)."""
    head = port_export._vi(1, 8) + port_export._ld(2, producer.encode())
    assert blob.startswith(head), blob[:40]
    return blob[len(head):]


@pytest.mark.parametrize("name,quant", CASES, ids=[f"{n}-{q}" for n, q in CASES])
def test_export_is_byte_equal_to_jax(packs, tmp_path, name, quant):
    jpath, tpath = _export_pair(packs, tmp_path, name, quant)
    jblob, tblob = open(jpath, "rb").read(), open(tpath, "rb").read()
    jrest = _split_producer(jblob, "audio_classification_tpu")
    trest = _split_producer(tblob, port_export.PRODUCER)
    if name != "pyannet":
        assert trest == jrest
        return
    jg, tg = load_onnx_graph(jpath), load_onnx_graph(tpath)
    sinc = [k for k in jg.initializers if k.startswith("sinc")]
    assert len(sinc) == 1 and list(jg.initializers) == list(tg.initializers)
    a, b = jg.initializers[sinc[0]], tg.initializers[sinc[0]]
    assert a.shape == b.shape and a.dtype == b.dtype
    # measured 1.49e-7 of the max (2.5 float32 ulps of the centre tap 1.0):
    # XLA's float32 sin / cos are not torch's, so 1e-7 of the max does not
    # hold; four ulps of the max do
    assert float(np.max(np.abs(a - b))) <= 4 * 2.0 ** -24 * float(np.max(np.abs(a)))
    # every other byte: the sinc payload replaced by the JAX one
    assert trest.replace(b.tobytes(), a.tobytes()) == jrest


def test_state_dict_to_variables_inverts_from_jax(packs):
    """The port's modules as flax trees: the JAX modules' names and shapes
    (the JAX pack's init traced for shapes), and from_jax maps them back to
    the very tensors; PyanNet's plain tree likewise."""
    from torch_onnx_helpers import shape_only_init
    from audio_classification_tpu.engine import ModelPack as JaxModelPack

    jpack, tpack, (jcfg, jpn, tpn) = packs
    with shape_only_init():
        shapes = JaxModelPack(jax_tiny_preset(), seed=0).params
    back = module_variables(tpack.models)

    def flat(tree, pre=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, pre + (k,))
            else:
                yield pre + (k,), np.asarray(v)

    for stage, module in tpack.models.items():
        want = {k: v.shape for k, v in flat(shapes[stage])}
        got = {k: v.shape for k, v in flat(back[stage])}
        assert got == want, stage
        sd = variables_to_state_dict(back[stage])
        for k, v in module.state_dict().items():
            assert torch.equal(sd[k], v.float()), f"{stage}:{k}"
    got = pyannet_state_dict_to_params(tpn.state_dict())
    sd = pyannet_params_to_state_dict(got)
    for k, v in tpn.state_dict().items():
        assert torch.equal(sd[k], v), k
    np.testing.assert_array_equal(got["lstm"][1]["bw"]["w_hh"],
                                  np.asarray(jpn["lstm"][1]["bw"]["w_hh"]))


def _module_out(tpack, stage, x):
    m = tpack.models[stage]
    with torch.no_grad():
        if stage in ("sep3", "mossformer"):
            return m(x, torch.ones_like(x)).numpy()
        mask = torch.ones(x.shape[:2], dtype=torch.bool)
        if stage == "asr":
            return m(x, mask, language_id=0, use_itn=True).numpy()
        if stage == "vad":
            return m(x, mask.float()).numpy()
        return m(x, mask).numpy()


@pytest.mark.parametrize("name", [n for n in EXPORTS] + ["pyannet"])
def test_float_export_runs_on_the_port_executor_as_the_module(packs, tmp_path, name):
    jpack, tpack, (jcfg, jpn, tpn) = packs
    _, tpath = _export_pair(packs, tmp_path, name, None if name in ("mossformer", "pyannet")
                            else "none")
    m = OnnxModel(tpath, device="cpu")
    rng = np.random.default_rng(7)
    if name == "pyannet":
        wav = (rng.standard_normal((2, 2000)) * 0.3).astype(np.float32)
        ref = tpn(torch.from_numpy(wav), torch.full((2,), 2000)).detach().numpy()
        got = m(wav=wav)["probs"].numpy()
    else:
        _, stage, _, kw = EXPORTS[name]
        cfg = _cfg(tpack, stage)
        if "seconds" in kw:
            x = (rng.standard_normal((2, int(kw["seconds"] * cfg.sample_rate))) * 0.3)
        elif stage == "asr":
            x = rng.standard_normal((2, kw["frames"], cfg.lfr_m * cfg.num_mel))
        else:
            x = rng.standard_normal((2, kw["frames"], cfg.num_mel))
        x = x.astype(np.float32)
        feeds = {m.input_names[0]: x}
        if "language" in m.input_names:
            feeds["language"] = np.zeros(1, np.int64)
        got = m(**feeds)[m.output_names[0]].numpy()
        ref = _module_out(tpack, stage, torch.from_numpy(x))
    assert got.shape == ref.shape
    tol = 2e-4 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
