"""PyTorch port vs the JAX package: the mesh's rules in one process (CPU,
float32). The rank grid of ``make_mesh`` (slice-major data axis) against
the JAX grid's device ids; the tensor-parallel parameter rules' shards of
every leaf against JAX's ``apply_param_specs`` on its virtual 8-device mesh
(bit-equal); the mu-law arena codec (codes and arena bit-equal) and the
flagship pipeline with ``arena_codec="mulaw"`` against the JAX engine with
and without a mesh; a DP 4 and a DP 2 x TP 2 engine of entries on one
device against the meshless one; and the three public names
(``models/common.conv1d``, ``models/pyannet.init_pyannet_params`` /
``PyanNet.init``, ``utils/config.SidBenchmarkConfig``).

The ranks themselves (gloo worlds of 2 and 4 processes) are in
tests/test_torch_mesh_ranks.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from audio_classification_tpu.engine import bucketing as jax_bucketing
from audio_classification_tpu.engine import BucketSpec as JaxBucketSpec
from audio_classification_tpu.engine import StageEngine as JaxStageEngine
from audio_classification_tpu.engine import default_buckets as jax_default_buckets
from audio_classification_tpu.engine import tiny_preset as jax_tiny_preset
from audio_classification_tpu.models import common as jax_common
from audio_classification_tpu.models import pyannet as jax_pyannet
from audio_classification_tpu.models.convtasnet import ConvTasNet as JaxConvTasNet
from audio_classification_tpu.models.mossformer import MossFormer as JaxMossFormer
from audio_classification_tpu.parallel import mesh as jax_mesh
from audio_classification_tpu.pipelines.offline_overlap3 import Overlap3Pipeline as JaxPipeline
from audio_classification_tpu.utils import config as jax_config
from audio_classification_tpu_torch.audio_io import write_wav
from audio_classification_tpu_torch.cli import benchmark_pipeline
from audio_classification_tpu_torch.convert.from_jax import _param, pyannet_params_to_state_dict
from audio_classification_tpu_torch.engine import BucketSpec, ModelPack, StageEngine, tiny_preset
from audio_classification_tpu_torch.engine import bucketing
from audio_classification_tpu_torch.engine.bucketing import default_buckets
from audio_classification_tpu_torch.models.common import conv1d
from audio_classification_tpu_torch.models.pyannet import (PyanNet, PyanNetConfig,
                                                          init_pyannet_params)
from audio_classification_tpu_torch.parallel import mesh as port_mesh
from audio_classification_tpu_torch.pipelines.offline_overlap3 import Overlap3Pipeline
from audio_classification_tpu_torch.utils.config import Overlap3Config, SidBenchmarkConfig
from torch_onnx_helpers import jax_twin
from torch_port_helpers import assert_records_match

SR = 16000


# ------------------------------------------------------------ mesh layout
def test_rank_grid_matches_the_jax_hybrid_grid():
    """make_mesh(8, model_axis=2, slices=2) over a world of 8 ranks: the
    owner rank of each entry is the JAX grid's device id (slice-major data
    axis, a model row inside one slice); at world size 1 every entry is this
    process's, at 4 ranks each owns one model column of two rows."""
    jgrid = np.vectorize(lambda d: d.id)(np.asarray(
        jax_mesh.make_mesh(8, model_axis=2, slices=2).devices))
    m = port_mesh.make_mesh(8, model_axis=2, slices=2, devices=["cpu"] * 8, world=8)
    assert m.shape == {"data": 4, "model": 2}
    np.testing.assert_array_equal(np.asarray(m.ranks), jgrid - jgrid.min())
    one = port_mesh.make_mesh(8, model_axis=2, slices=2, devices=["cpu"] * 8)
    assert set(np.asarray(one.ranks).ravel()) == {0} and one.local_count("data") == 4
    four = port_mesh.make_mesh(8, model_axis=2, devices=["cpu"] * 8, world=4, rank=3)
    assert four.ranks == ((0, 1), (0, 1), (2, 3), (2, 3))
    assert (four.local_range("data"), four.local_range("model")) == (range(2, 4), range(1, 2))
    assert four.axis_ranks("data") == [1, 3] and four.axis_ranks("model") == [2, 3]
    for bad in (dict(n_devices=8, model_axis=1, slices=3), dict(n_devices=8, model_axis=8,
                                                                slices=2)):
        with pytest.raises(ValueError, match="divide"):
            port_mesh.make_mesh(devices=["cpu"] * 8, **bad)
        with pytest.raises(ValueError, match="divide"):
            jax_mesh.make_mesh(**bad)
    with pytest.raises(ValueError, match="world size must divide by the model axis"):
        port_mesh.make_mesh(8, model_axis=4, devices=["cpu"] * 8, world=2)
    # row ranges: P("data") as the rows of this rank's entries
    assert port_mesh.data_sharding(four, 8) == [range(4, 6), range(6, 8)]
    assert port_mesh.replicated(four) == four.device == torch.device("cpu")
    rows = port_mesh.shard_batch(one, {"x": np.arange(8)})
    assert [r["x"].tolist() for r in rows] == [[0, 1], [2, 3], [4, 5], [6, 7]]


def _random_tree(model, seed):
    """The model's variable tree for shapes only, filled from a seed."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 1000)),
                            jnp.ones((1, 1000)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("arch", ["convtasnet", "mossformer"])
def test_tp_param_specs_shard_like_jax(arch):
    """Every leaf's shard of each model column under the port's rule equals,
    bit for bit, the JAX rule's shard on make_mesh(8, model_axis=2) carried
    into the torch layout (the converter's per-leaf transform)."""
    p = jax_tiny_preset()
    model, rule, port_rule = (
        (JaxConvTasNet(p.sep3), jax_mesh.convtasnet_param_spec,
         port_mesh.convtasnet_param_spec) if arch == "convtasnet" else
        (JaxMossFormer(p.mossformer), jax_mesh.mossformer_param_spec,
         port_mesh.mossformer_param_spec))
    tree = _random_tree(model, 3)["params"]
    jm = jax_mesh.make_mesh(8, model_axis=2)
    shardings = jax_mesh.apply_param_specs(jm, tree, rule)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    flat_sh = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    full = {}
    for (path, leaf), _sh in zip(flat, flat_sh):
        key, a = _param(tuple(k.key for k in path), np.asarray(leaf))
        full[key] = torch.from_numpy(np.ascontiguousarray(a))
    pm = port_mesh.make_mesh(8, model_axis=2, devices=["cpu"] * 8)
    shards = port_mesh.apply_param_specs(pm, full, port_rule)
    assert len(shards) == 2
    n_split = 0
    for (path, leaf), sh in zip(flat, flat_sh):
        names = tuple(k.key for k in path)
        placed = jax.device_put(jnp.asarray(leaf), sh)
        by_dev = {s.device.id: np.asarray(s.data) for s in placed.addressable_shards}
        key = _param(names, np.asarray(leaf))[0]
        for j in range(2):
            want = _param(names, by_dev[int(jm.devices[0, j].id)])[1]
            got = shards[j][key].numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{key} column {j}")
        n_split += by_dev[int(jm.devices[0, 0].id)].shape != np.shape(leaf)
    assert n_split >= (8 if arch == "convtasnet" else 10)  # the rule split something


# ------------------------------------------------------------ mu-law
def test_mulaw_codec_bit_equal_to_jax():
    """Codes, the decode table and the packed arena bit-equal to JAX's."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-1.2, 1.2, 5000), [0.0, -0.0, 1.0, -1.0, 1e-9]])
    x = x.astype(np.float32)
    np.testing.assert_array_equal(bucketing.mulaw_encode(x), jax_bucketing.mulaw_encode(x))
    np.testing.assert_array_equal(bucketing.mulaw_decode_lut(), jax_bucketing.mulaw_decode_lut())
    assert bucketing.mulaw_decode_lut()[bucketing.MULAW_ZERO] == 0.0
    items = [x[:1000], x[1000:1777], x[1777:1800]]
    for got, want in zip(bucketing.flat_pack_mulaw(items, 512, 1024),
                         jax_bucketing.flat_pack_mulaw(items, 512, 1024)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mesh_rules")
    rng = np.random.default_rng(0)
    t = np.arange(3 * SR) / SR
    mix = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 990 * t)
           + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    write_wav(d / "mix.wav", mix, SR)
    write_wav(d / "target.wav", (0.3 * np.sin(2 * np.pi * 440 * t[: 2 * SR])).astype(np.float32),
              SR)
    return d


@pytest.fixture(scope="module")
def packs():
    """The port's tiny pack (its separators in the dense loop, as JAX's tiny
    ones always run) and a JAX twin on its weights."""
    tp = tiny_preset()
    tp = dataclasses.replace(tp, sep3=dataclasses.replace(tp.sep3, fused_tcn="off"))
    pack = ModelPack(tp, seed=0, device="cpu")
    return pack, jax_twin(pack, jax_tiny_preset())


def _cfg(wavs, **kw):
    return dict(input_wavs=[str(wavs / "mix.wav")], target_wav=str(wavs / "target.wav"),
                preset="tiny", seed=0, sv_threshold=-1.0, max_batch=4, max_segment_sec=4.0,
                osd_thr=0.0, **kw)


@pytest.mark.parametrize("mesh", [None, (2, 1)], ids=["no_mesh", "dp2"])
def test_mulaw_pipeline_matches_jax(wavs, packs, mesh):
    """The flagship overlap scene with arena_codec="mulaw": records equal to
    the JAX engine's with the same codec (and the same mesh), sv_score
    within 1e-4; the arena the port uploads is the JAX codes."""
    pack, jpack = packs
    spec = BucketSpec(default_buckets(SR, 0.5, 4.0), 4)
    jspec = JaxBucketSpec(jax_default_buckets(SR, 0.5, 4.0), 4)
    pm = jm = None
    if mesh is not None:
        pm = port_mesh.make_mesh(mesh[0] * mesh[1], model_axis=mesh[1], devices=["cpu"] * 2)
        jm = jax_mesh.make_mesh(mesh[0] * mesh[1], model_axis=mesh[1])
    eng = StageEngine(pack, spec, mesh=pm, arena_codec="mulaw")
    jeng = JaxStageEngine(jpack, jspec, mesh=jm, arena_codec="mulaw")
    got = Overlap3Pipeline(Overlap3Config(**_cfg(wavs, arena_codec="mulaw")), engine=eng).run()
    ref = JaxPipeline(jax_config.Overlap3Config(**_cfg(wavs, arena_codec="mulaw")),
                      engine=jeng).run()
    assert len(got.segments) >= 1
    assert_records_match(got.segments, ref.segments, sv_tol=1e-4)
    w = np.random.default_rng(1).uniform(-0.5, 0.5, 9000).astype(np.float32)
    np.testing.assert_array_equal(eng.upload_arena([w]).dev.numpy()[:9000],
                                  jax_bucketing.mulaw_encode(w))


@pytest.mark.parametrize("layout", [(4, 1), (2, 2)], ids=["dp4", "dp2xtp2"])
def test_mesh_entries_engine_matches_meshless(wavs, packs, layout):
    """A mesh's entries on one device (DP 4: each entry's rows; DP 2 x TP 2:
    the TP separator too): the same records as the meshless engine, and the
    batch sizes snap to multiples of the data size."""
    pack, _ = packs
    spec = BucketSpec(default_buckets(SR, 0.5, 4.0), 4)
    mesh = port_mesh.make_mesh(layout[0] * layout[1], model_axis=layout[1],
                               devices=["cpu"] * 4)
    eng = StageEngine(pack, spec, mesh=mesh)
    assert eng.buckets.batch_multiple == layout[0] and eng.buckets.batch_size_for(1) == layout[0]
    cfg = Overlap3Config(**_cfg(wavs))
    got = Overlap3Pipeline(cfg, engine=eng).run()
    ref = Overlap3Pipeline(cfg, engine=StageEngine(pack, spec)).run()
    assert_records_match(got.segments, ref.segments, sv_tol=1e-5)


@pytest.mark.parametrize("backend", ["convtasnet", "mossformer"])
def test_tp_engine_in_bfloat16_matches_meshless(packs, backend):
    """DP 2 x TP 2 at compute_dtype bfloat16, where a bfloat16 copy's shard
    weights meet a float32 stream (MossFormer's from its first GAU's output
    on): the separations of the meshless bfloat16 engine, within 2e-2 of
    max|s| (bfloat16 products summed in another order)."""
    pack, _ = packs
    spec = BucketSpec(default_buckets(SR, 0.5, 4.0), 4)
    mesh = port_mesh.make_mesh(4, model_axis=2, devices=["cpu"] * 4)
    wav = (0.3 * np.random.default_rng(4).standard_normal(12000)).astype(np.float32)
    got, ref = (StageEngine(pack, spec, mesh=m, compute_dtype="bfloat16")
                .separate([wav], backend=backend)[0] for m in (mesh, None))
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


# ------------------------------------------------------------ public names
@pytest.mark.parametrize("kw", [
    dict(k=3, cin=6, cout=8),
    dict(k=5, cin=6, cout=8, stride=2),                   # SAME at stride 2: asymmetric
    dict(k=3, cin=6, cout=6, dilation=4, groups=6),       # dilated depthwise
    dict(k=4, cin=6, cout=4, groups=2, padding="VALID"),
    dict(k=5, cin=6, cout=8, stride=2, padding=[(2, 2)]),  # explicit pads
], ids=["same", "same_stride2", "depthwise_dilated", "grouped_valid", "explicit"])
def test_conv1d_matches_jax(kw):
    kw = dict(kw)
    k, cin, cout = kw.pop("k"), kw.pop("cin"), kw.pop("cout")
    rng = np.random.default_rng(k + cin)
    for t in (37, 40):  # odd and even lengths: SAME's extra pad moves
        x = rng.standard_normal((2, t, cin)).astype(np.float32)
        kern = rng.standard_normal((k, cin // kw.get("groups", 1), cout)).astype(np.float32)
        want = np.asarray(jax_common.conv1d(jnp.asarray(x), jnp.asarray(kern), **kw))
        got = conv1d(torch.from_numpy(x), torch.from_numpy(kern), **kw).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("cfg", [PyanNetConfig(), PyanNetConfig(
    n_filters=40, conv_channels=(16,), lstm_hidden=16, lstm_layers=1, bidirectional=False,
    linear_dims=(8,), analytic=False)], ids=["published", "small"])
def test_init_pyannet_params_bit_equal_to_jax(cfg):
    """The fresh tree of a seed, leaf for leaf, and PyanNet.init's weights."""
    jcfg = jax_pyannet.PyanNetConfig(**dataclasses.asdict(cfg))
    want = jax.tree.map(np.asarray, jax_pyannet.init_pyannet_params(jcfg, seed=7))
    got = init_pyannet_params(cfg, seed=7)
    flat_w, tree_w = jax.tree_util.tree_flatten(want)
    flat_g, tree_g = jax.tree_util.tree_flatten(got)
    assert tree_w == tree_g
    for g, w in zip(flat_g, flat_w):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert jax_pyannet.PyanNet(jcfg).init(7) is not None
    net = PyanNet(cfg).init(7)
    for name, t in pyannet_params_to_state_dict(want).items():
        np.testing.assert_array_equal(net.state_dict()[name].numpy(), t.numpy())


def test_sid_benchmark_config_matches_jax_and_parses_the_flags():
    """Fields, order and defaults equal to the JAX dataclass but provider
    (the port's default device is the card: "cuda", the JAX one "tpu"), and
    benchmark_pipeline's flags parse into it."""
    jf = jax_config.SidBenchmarkConfig.__dataclass_fields__
    pf = SidBenchmarkConfig.__dataclass_fields__
    assert list(pf) == list(jf)
    for name in jf:
        if name != "provider":
            assert pf[name].default == jf[name].default, name
    assert SidBenchmarkConfig().provider == "cuda"
    args = benchmark_pipeline.parse_args([
        "--speaker-file", "enroll.txt", "--test-list", "test.txt", "--model", "spk.onnx",
        "--threshold", "0.3", "--provider", "cpu", "--sense-voice", "sv", "--tokens", "t.txt",
        "--decoding-method", "modified_beam_search", "--num-active-paths", "3",
        "--preset", "tiny", "--max-batch", "2", "--onnx-exec", "direct"])
    cfg = benchmark_pipeline.config_from_args(args)
    assert (cfg.speaker_file, cfg.test_list, cfg.model, cfg.threshold, cfg.provider,
            cfg.sense_voice, cfg.tokens, cfg.decoding_method, cfg.num_active_paths, cfg.preset,
            cfg.max_batch, cfg.onnx_exec) == (
        "enroll.txt", "test.txt", "spk.onnx", 0.3, "cpu", "sv", "t.txt",
        "modified_beam_search", 3, "tiny", 2, "direct")
    assert cfg.monitor_interval == 0.5 and cfg.onnx_asr_skip_frames == -1  # not flags: defaults
