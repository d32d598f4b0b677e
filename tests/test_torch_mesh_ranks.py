"""PyTorch port vs the JAX package: the mesh over ranks (CPU, float32).

A gloo world of 2 and one of 4 processes is spawned once for this module
(tests/torch_dist_worker.py; ``file://`` rendezvous) and runs every case;
each test then holds the ranks' outputs to the JAX mesh code on its
virtual devices. At world 2 the mesh of 4 entries puts 2 on each rank, so
the collectives cross ranks and the local list at once.

- ring attention (4 shards): within 1e-5 of max|o| of the JAX ring;
- the time-sharded Conv-TasNet and MossFormer (4 shards): within 1e-5
  relative of the JAX functions;
- the TP forwards at model 2: within 1e-5 relative of the JAX models
  applied with TP-placed parameters (the JAX TP engine's program);
- the DP engine on the flagship overlap scene: records equal to the JAX mesh
  engine's (kind, span, stream, text exact; sv_score within 1e-4), and the
  CLI with --data-parallel 2, which rank 0 alone writes;
- SpeakerBank with its rows over the ranks: the same search answers;
- SeparatorTrainer DP 2 x TP 2 and time-sharded, ModuleTrainer with the
  masked frame BCE on ragged masks: three steps against JAX's mesh trainers,
  losses within 1e-5 relative, weights within lr a step and 99 % within
  lr / 10; a sequence-parallel encoder's gradients over ranks equal to one
  process's;
- dryrun_multichip over the world.
Every rank's outputs must equal rank 0's (the mesh paths hand every rank
the whole result).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audio_classification_tpu.engine import BucketSpec as JaxBucketSpec
from audio_classification_tpu.engine import StageEngine as JaxStageEngine
from audio_classification_tpu.engine import default_buckets as jax_default_buckets
from audio_classification_tpu.engine import tiny_preset as jax_tiny_preset
from audio_classification_tpu.models.convtasnet import ConvTasNet as JaxConvTasNet
from audio_classification_tpu.models.convtasnet import ConvTasNetConfig as JaxTasNetConfig
from audio_classification_tpu.models.mossformer import MossFormer as JaxMossFormer
from audio_classification_tpu.models.mossformer import MossFormerConfig as JaxMFConfig
from audio_classification_tpu.models.osd import OSDConfig as JaxOSDConfig
from audio_classification_tpu.models.osd import OSDNet as JaxOSD
from audio_classification_tpu.models.speaker import SpeakerBank as JaxSpeakerBank
from audio_classification_tpu.parallel import mesh as jax_mesh
from audio_classification_tpu.parallel.ring_attention import ring_attention as jax_ring
from audio_classification_tpu.parallel.sp_convtasnet import sp_separate as jax_sp_separate
from audio_classification_tpu.parallel.sp_convtasnet import (
    sp_separate_mossformer as jax_sp_separate_mossformer,
)
from audio_classification_tpu.pipelines.offline_overlap3 import Overlap3Pipeline as JaxPipeline
from audio_classification_tpu.train import losses as jax_losses
from audio_classification_tpu.train.trainer import ModuleTrainer as JaxModuleTrainer
from audio_classification_tpu.train.trainer import SeparatorTrainer as JaxSeparatorTrainer
from audio_classification_tpu.utils import config as jax_config
from audio_classification_tpu_torch.audio_io import write_wav
from audio_classification_tpu_torch.cli.train_separator import synthetic_batch
from audio_classification_tpu_torch.convert.from_jax import variables_to_state_dict
from audio_classification_tpu_torch.engine import ModelPack, tiny_preset
from audio_classification_tpu_torch.models.convtasnet import ConvTasNetConfig
from audio_classification_tpu_torch.models.mossformer import MossFormerConfig
from audio_classification_tpu_torch.models.osd import OSDConfig
from torch_dist_worker import run_world
from torch_onnx_helpers import jax_twin
from torch_port_helpers import assert_records_match

SR = 16000
LR = 1e-3
STEPS = 3
BACKPRESSURE_WINDOWS = 10
TCN = dict(n_src=2, enc_dim=16, enc_kernel=16, bottleneck=8, hidden=16, conv_kernel=3,
           n_blocks=3, n_repeats=1, sample_rate=8000)
MOSS = dict(n_src=2, enc_dim=16, enc_kernel=16, dim=16, qk_dim=8, layers=2, conv_kernel=5,
            sample_rate=8000)
TRAIN = dict(n_src=2, enc_dim=32, enc_kernel=16, bottleneck=16, hidden=32, n_blocks=2,
             n_repeats=1, sample_rate=8000)


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - ref).max() / (np.abs(ref).max() + 1e-12))


def _variables(model, seed):
    """A JAX model's variables for shapes only, filled from a seed."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 1000)),
                            jnp.ones((1, 1000)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32),
                        shapes)


def _seps():
    """(arch, JAX model, JAX cfg, port cfg, variables) of the two tiny
    separators whose time-sharded and TP forwards the worlds run."""
    out = {}
    for arch, jcls, jcfg, pcfg in (
            ("convtasnet", JaxConvTasNet, JaxTasNetConfig(**TCN),
             ConvTasNetConfig(**TCN, fused_tcn="off")),
            ("mossformer", JaxMossFormer, JaxMFConfig(**MOSS), MossFormerConfig(**MOSS))):
        model = jcls(jcfg)
        variables = _variables(model, 1 if arch == "convtasnet" else 2)
        out[arch] = (model, jcfg, pcfg, variables)
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Inputs, the JAX references' inputs, and the cases of both worlds."""
    d = tmp_path_factory.mktemp("torch_mesh_ranks")
    rng = np.random.default_rng(0)
    s = {"dir": d}
    # ring attention
    s["qkv"] = [rng.standard_normal((2, 64, 2, 16)).astype(np.float32) for _ in range(3)]
    s["kv_mask"] = np.arange(64)[None, :] < np.array([64, 41])[:, None]
    # separators
    s["seps"] = _seps()
    s["mix"] = (0.3 * rng.standard_normal((2, 1003))).astype(np.float32)
    s["lengths"] = np.array([1003, 700])
    s["smask"] = (np.arange(1003)[None, :] < s["lengths"][:, None]).astype(np.float32)
    # the flagship scene on the port's tiny pack and its JAX twin
    t = np.arange(3 * SR) / SR
    mix = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 990 * t)
           + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    write_wav(d / "mix.wav", mix, SR)
    write_wav(d / "target.wav", (0.3 * np.sin(2 * np.pi * 440 * t[: 2 * SR])).astype(np.float32),
              SR)
    tp = tiny_preset()
    pack = ModelPack(dataclasses.replace(tp, sep3=dataclasses.replace(tp.sep3, fused_tcn="off")),
                     seed=0, device="cpu")
    s["states"] = {k: m.state_dict() for k, m in pack.models.items()}
    s["jpack"] = jax_twin(pack, jax_tiny_preset())
    s["cfg_kw"] = dict(input_wavs=[str(d / "mix.wav")], target_wav=str(d / "target.wav"),
                       preset="tiny", seed=0, sv_threshold=-1.0, max_batch=4,
                       max_segment_sec=4.0, osd_thr=0.0)
    # serving and streaming: two callers of 4 s
    s["serve_wavs"] = []
    for i, hz in enumerate((440, 700)):
        w = (0.3 * np.sin(2 * np.pi * hz * np.arange(4 * SR) / SR)
             + 0.2 * np.sin(2 * np.pi * 990 * np.arange(4 * SR) / SR)).astype(np.float32)
        write_wav(d / f"call{i}.wav", w, SR)
        s["serve_wavs"].append(str(d / f"call{i}.wav"))
    # speaker bank
    s["bank"] = rng.standard_normal((5, 16)).astype(np.float32)
    s["queries"] = (s["bank"][[3, 0, 4]] + 0.3 * rng.standard_normal((3, 16))).astype(np.float32)
    # separator trainer: the JAX mesh trainers' init, batches of 4 rows
    s["jtr"] = JaxSeparatorTrainer(JaxTasNetConfig(**TRAIN), lr=LR, seed=0,
                                   mesh=jax_mesh.make_mesh(4, model_axis=2))
    s["train_state"] = variables_to_state_dict(jax.device_get(s["jtr"].state.params))
    brng = np.random.default_rng(3)
    mask = np.ones((4, 800), np.float32)
    mask[1, 610:] = 0.0
    mask[3, 300:] = 0.0
    s["sep_batches"] = [(*synthetic_batch(brng, 4, 2, 800, 8000), mask) for _ in range(STEPS)]
    ts_mask = np.ones((2, 800), np.float32)
    ts_mask[1, 610:] = 0.0
    s["ts_batches"] = [(*synthetic_batch(brng, 2, 2, 800, 8000), ts_mask) for _ in range(STEPS)]
    # OSD module trainer: a masked frame BCE over ragged output masks
    kw = dict(dim=32, heads=2, layers=1)
    s["osd_cfg"] = OSDConfig(**kw)
    s["josd"] = JaxOSD(JaxOSDConfig(**kw))
    batches = []
    for _ in range(STEPS):
        feats = rng.standard_normal((4, 40, 80)).astype(np.float32)
        labels = np.repeat((feats.mean(-1)[:, ::4] > 0).astype(np.float32)[..., None], 2, -1)
        mask = np.ones((4, 40), bool)
        mask[1, 29:] = False
        lmask = np.ones((4, 10), np.float32)
        lmask[1, 3:] = 0.0
        lmask[2, 8:] = 0.0
        lmask[3, 1:] = 0.0
        batches.append({"feats": feats, "labels": labels, "mask": mask, "lmask": lmask})
    s["osd_batches"] = batches
    s["osd_params"] = s["josd"].init(jax.random.PRNGKey(0), jnp.asarray(feats[:1]))
    s["osd_state"] = variables_to_state_dict(jax.device_get(s["osd_params"]))
    return s


def _cases(s, world):
    seps = s["seps"]
    q, k, v = s["qkv"]
    cases = {"ring": ("case_ring", dict(q=q, k=k, v=v, mask=s["kv_mask"], n=4))}
    for arch, (_m, _jc, pcfg, variables) in seps.items():
        state = variables_to_state_dict(variables)
        cases[f"sp_{arch}"] = ("case_sp", dict(arch=arch, cfg=pcfg, state=state, mix=s["mix"],
                                               lengths=s["lengths"], n=4))
        cases[f"tp_{arch}"] = ("case_tp", dict(arch=arch, cfg=pcfg, state=state, mix=s["mix"],
                                               mask=s["smask"], data=world // 2, model_axis=2))
    cases["sep_trainer"] = ("case_sep_trainer", dict(
        arch="convtasnet", cfg=ConvTasNetConfig(**TRAIN), state=s["train_state"],
        batches=s["sep_batches"], lr=LR, data=2, model_axis=2))
    cases["osd_trainer"] = ("case_osd_trainer", dict(cfg=s["osd_cfg"], state=s["osd_state"],
                                                     batches=s["osd_batches"], lr=LR, data=world))
    cases["dryrun"] = ("case_dryrun", dict(n=world))
    if world == 2:
        cases["pipeline"] = ("case_pipeline", dict(
            cfg_kw=dict(s["cfg_kw"], data_parallel=2, provider="cpu"), states=s["states"]))
        cases["cli"] = ("case_cli", dict(argv=[
            "--input-wavs", *s["cfg_kw"]["input_wavs"], "--target-wav", s["cfg_kw"]["target_wav"],
            "--preset", "tiny", "--provider", "cpu", "--osd-thr", "0.0", "--max-segment-sec",
            "4", "--max-batch", "4", "--data-parallel", "2", "--out-dir",
            str(s["dir"] / "cli_out")]))
        common = ["--preset", "tiny", "--provider", "cpu",
                  "--sv-threshold", "-1", "--max-segment-sec", "8", "--data-parallel", "2"]
        cases["serve"] = ("case_serve", dict(argv=[
            "--wavs", *s["serve_wavs"], "--targets", s["cfg_kw"]["target_wav"],
            "--max-batch", "4", "--out", str(s["dir"] / "serve.jsonl"), *common]))
        cases["serve_backpressure"] = ("case_serve_backpressure", dict(argv=[
            "--wavs", *s["serve_wavs"], "--targets", s["cfg_kw"]["target_wav"],
            "--max-batch", "4", "--process-seconds", "0.5", *common],
            windows=BACKPRESSURE_WINDOWS, slow=0.3))
        cases["stream"] = ("case_stream", dict(argv=[
            "--target-wav", s["cfg_kw"]["target_wav"], "--input-wav", s["serve_wavs"][0],
            "--no-realtime", "--process-seconds", "2", "--output-dir",
            str(s["dir"] / "stream_out"), *common]))
        cases["distill_osd"] = ("case_distill_osd", dict(argv=[
            "--synthetic", "--preset", "tiny", "--dur", "2.0", "--eval-files", "2",
            "--f1-target", "0.0", "--seed", "0", "--steps", "2", "--batch", "4",
            "--provider", "cpu", "--out", str(s["dir"] / "osd_ranks")]))
        cases["mesh_device"] = ("case_mesh_device", dict(n=2))
        cases["bank"] = ("case_bank", dict(bank=s["bank"], queries=s["queries"], threshold=0.1,
                                           n=2))
        cases["ts_trainer"] = ("case_sep_trainer", dict(
            arch="convtasnet", cfg=ConvTasNetConfig(**TRAIN), state=s["train_state"],
            batches=s["ts_batches"], lr=LR, data=2, model_axis=1, time_shard=True))
        cases["sp_encoder_grads"] = ("case_sp_encoder_grads", dict(seed=5, n=4))
    return cases


@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    """Each world spawned once: {world: [rank 0's outputs, rank 1's, ...]}."""
    out = {}
    for world in (2, 4):
        out[world] = run_world(world, _cases(setup, world),
                               tmp_path_factory.mktemp(f"gloo_world{world}"))
    return out


def _out(worlds, world, name):
    """Rank 0's output of a case; a rank's failure is raised here."""
    for r, o in enumerate(worlds[world]):
        if isinstance(o.get(name), Exception):
            raise o[name]
    return worlds[world][0][name]


WORLDS = pytest.mark.parametrize("world", [2, 4], ids=["w2", "w4"])


@WORLDS
def test_ring_attention_over_ranks_matches_jax(setup, worlds, world):
    q, k, v = setup["qkv"]
    ref = np.asarray(jax.jit(lambda a, b, c, m: jax_ring(a, b, c, jax_mesh.make_mesh(4),
                                                          kv_mask=m))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(setup["kv_mask"])))
    got = _out(worlds, world, "ring")
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@WORLDS
@pytest.mark.parametrize("arch", ["convtasnet", "mossformer"])
def test_time_sharded_separators_over_ranks_match_jax(setup, worlds, world, arch):
    _model, jcfg, _pcfg, variables = setup["seps"][arch]
    fn = jax_sp_separate_mossformer if arch == "mossformer" else jax_sp_separate
    mesh = jax_mesh.make_mesh(4)
    ref = np.asarray(jax.jit(lambda p, x, n: fn(p, jcfg, x, n, mesh))(
        variables, jnp.asarray(setup["mix"]), jnp.asarray(setup["lengths"], jnp.int32)))
    got = _out(worlds, world, f"sp_{arch}")
    assert got.shape == ref.shape and np.abs(ref).max() > 0
    assert _rel(got, ref) <= 1e-5


@WORLDS
@pytest.mark.parametrize("arch", ["convtasnet", "mossformer"])
def test_tp_forwards_over_ranks_match_jax(setup, worlds, world, arch):
    """Model 2 (at world 4 also data 2): the JAX model applied with its
    parameters placed by the JAX TP rule on the same mesh shape."""
    model, _jcfg, _pcfg, variables = setup["seps"][arch]
    rule = (jax_mesh.mossformer_param_spec if arch == "mossformer"
            else jax_mesh.convtasnet_param_spec)
    mesh = jax_mesh.make_mesh(world, model_axis=2)
    placed = jax.device_put(variables, jax_mesh.apply_param_specs(mesh, variables, rule))
    ref = np.asarray(jax.jit(model.apply)(placed, jnp.asarray(setup["mix"]),
                                          jnp.asarray(setup["smask"])))
    got = _out(worlds, world, f"tp_{arch}")
    assert _rel(got, ref) <= 1e-5


def test_dp_engine_pipeline_over_ranks_matches_jax_mesh(setup, worlds):
    """--data-parallel 2 over 2 ranks (build_engine's mesh): the records of
    the JAX pipeline on a JAX engine over a 2-device mesh."""
    jeng = JaxStageEngine(setup["jpack"], JaxBucketSpec(jax_default_buckets(SR, 0.5, 4.0), 4),
                          mesh=jax_mesh.make_mesh(2))
    ref = JaxPipeline(jax_config.Overlap3Config(**setup["cfg_kw"]), engine=jeng).run()
    outs = [o["pipeline"] for o in worlds[2]]
    got = _out(worlds, 2, "pipeline")
    assert got["mesh"] == {"data": 2, "model": 1}
    assert [o["writer"] for o in outs] == [True, False]
    assert len(got["segments"]) >= 1
    assert_records_match(got["segments"], ref.segments, sv_tol=1e-4)


def test_cli_data_parallel_over_ranks_rank0_writes(worlds):
    files = [o["cli"] for o in worlds[2]]
    assert not isinstance(files[0], Exception) and not isinstance(files[1], Exception)
    assert files[1] is None
    assert {"segments.jsonl", "segments.csv", "summary.json"} <= set(files[0])


def _rec_key(r):
    return (r.get("session", 0), r["kind"], -1 if r["stream"] is None else r["stream"],
            r["text"], round(r["end"] - r["start"], 3))


def test_serve_streams_and_streaming_over_ranks_match_one_process(setup, worlds):
    """serve_streams and the streaming application with --data-parallel 2
    over 2 ranks (each rank feeds itself; the ticks agree over the ranks,
    nothing is dropped): the records of the same CLIs in one process
    without a mesh."""
    from audio_classification_tpu_torch.cli import serve_streams, streaming_overlap_3src

    serve_argv = _cases(setup, 2)["serve"][1]["argv"]
    stream_argv = _cases(setup, 2)["stream"][1]["argv"]
    one = lambda argv: [a for i, a in enumerate(argv)  # noqa: E731
                        if "--data-parallel" not in argv[max(i - 1, 0):i + 1]]
    ref_out = setup["dir"] / "serve_ref.jsonl"
    serve_ref = one(serve_argv)
    serve_ref[serve_ref.index("--out") + 1] = str(ref_out)
    serve_streams.main(serve_ref)
    ref = [__import__("json").loads(x) for x in ref_out.read_text().splitlines()]
    got = _out(worlds, 2, "serve")
    assert got["stats"]["chunks_dropped"] == 0 and len(ref) >= 2
    assert sorted(map(_rec_key, got["records"])) == sorted(map(_rec_key, ref))
    sref = streaming_overlap_3src.main(one(stream_argv) + ["--output-dir",
                                                           str(setup["dir"] / "stream_ref")])
    sgot = _out(worlds, 2, "stream")
    assert sgot["chunks"] == sref.pipeline.latency_stats()["chunks"] >= 2
    assert sorted(map(_rec_key, sgot["results"])) == sorted(map(_rec_key, sref.all_results))


def test_serving_backpressure_over_ranks_agrees_on_the_drops(worlds):
    """Ticks slower than the feeds, rank 0 fed all at once and rank 1 paced:
    each rank's drop-oldest bound drops windows of its own, and the ranks
    agree on them, so every tick runs the same windows on both ranks, each
    session's window numbers rise to its newest, and the records are
    equal."""
    from audio_classification_tpu_torch.pipelines.serving import StreamingServer

    outs = [_out(worlds, 2, "serve_backpressure"), worlds[2][1]["serve_backpressure"]]
    assert outs[0]["ran"] == outs[1]["ran"] and outs[0]["records"] == outs[1]["records"]
    assert outs[0]["dropped"] > 0 and len(outs[0]["records"]) >= 2
    ran = sum(len(tick) for tick in outs[0]["ran"])
    for o in outs:  # every window a rank did not run it dropped, once
        assert o["dropped"] == 2 * BACKPRESSURE_WINDOWS - ran
    for sid in (0, 1):
        seqs = [q for tick in outs[0]["ran"] for s, q in tick if s == sid]
        assert seqs == sorted(set(seqs)) and seqs[-1] == BACKPRESSURE_WINDOWS - 1
        assert StreamingServer.MAX_PENDING <= len(seqs) < BACKPRESSURE_WINDOWS


def test_distill_osd_over_the_world_matches_one_process(setup, worlds):
    """distill_osd under a world of 2 trains data-parallel over both ranks
    (the frame BCE summed over the whole batch): the held-out metrics and the
    weights rank 0 writes within lr / 10 of one process's run on the same
    stream (two Adam steps of about lr * sign(g): an element whose gradient
    is near 0 may move by less on one side)."""
    from audio_classification_tpu_torch.cli import distill_osd
    from audio_classification_tpu_torch.train.checkpoint import load_params

    argv = _cases(setup, 2)["distill_osd"][1]["argv"]
    ref_dir = setup["dir"] / "osd_one"
    ref = distill_osd.main([a if a != str(setup["dir"] / "osd_ranks") else str(ref_dir)
                            for a in argv])
    assert _out(worlds, 2, "distill_osd") == ref == worlds[2][1]["distill_osd"]
    got, want = load_params(setup["dir"] / "osd_ranks"), load_params(ref_dir)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=3e-4 / 10)  # distill_osd --lr 3e-4


def test_mesh_under_a_group_takes_the_asked_device(worlds):
    """A mesh under a gloo group lives on the device kind its caller asks
    for: the CPU when asked, and CUDA refused (gloo does not carry CUDA
    tensors) instead of moving to the CPU."""
    dev, refusal = _out(worlds, 2, "mesh_device")
    assert dev == "cpu"
    assert refusal is not None and "does not carry cuda tensors" in refusal
    assert "nccl" in refusal


def test_speaker_bank_rows_over_ranks_search_like_jax(setup, worlds):
    jbank = JaxSpeakerBank(16, mesh=jax_mesh.make_mesh(2))
    for i, row in enumerate(setup["bank"]):
        jbank.add(f"spk{i}", row)
    want = [jbank.search(q, 0.1) for q in setup["queries"]]
    assert _out(worlds, 2, "bank") == want == ["spk3", "spk0", "spk4"]


def _compare_training(got, jtr_params, want_losses):
    for g, w in zip(got["losses"], want_losses):
        assert abs(g - w) <= 1e-5 * abs(w), (got["losses"], want_losses)
    want = variables_to_state_dict(jax.device_get(jtr_params))
    diffs = []
    for name, w in want.items():
        diff = np.abs(got["params"][name] - w.numpy())
        assert diff.max() <= LR * STEPS, name
        diffs.append(diff.ravel())
    assert np.quantile(np.concatenate(diffs), 0.99) <= LR / 10


@pytest.fixture(scope="module")
def jax_dp_tp(setup):
    """Three steps of the JAX trainer on a (data 2, model 2) mesh."""
    jtr = setup["jtr"]  # at its init, which the worlds started from
    return [jtr.train_step(*b) for b in setup["sep_batches"]], jtr.state.params


@WORLDS
def test_separator_trainer_dp_tp_over_ranks_matches_jax(worlds, jax_dp_tp, world):
    """DP 2 x TP 2: at world 2 each rank holds one model column of both data
    rows, at world 4 one entry. The clip's global norm is the logical one."""
    want, params = jax_dp_tp
    _compare_training(_out(worlds, world, "sep_trainer"), params, want)


def test_separator_trainer_time_shard_over_ranks_matches_jax(setup, worlds):
    jtr = JaxSeparatorTrainer(JaxTasNetConfig(**TRAIN), lr=LR, seed=0, time_shard=True,
                              mesh=jax_mesh.make_mesh(2))
    want = [jtr.train_step(*b) for b in setup["ts_batches"]]
    _compare_training(_out(worlds, 2, "ts_trainer"), jtr.state.params, want)


@pytest.fixture(scope="module")
def jax_masked_bce(setup):
    """Three steps of the JAX ModuleTrainer over a 4-device data mesh."""
    def jloss(apply_fn, p, b):
        probs = apply_fn(p, b["feats"], b["mask"])
        return jax_losses.frame_bce_loss(probs, b["labels"], b["lmask"])

    jtr = JaxModuleTrainer(setup["josd"], setup["osd_params"], jloss, lr=LR,
                           mesh=jax_mesh.make_mesh(4))
    want = [jtr.train_step({k: jnp.asarray(v) for k, v in b.items()})
            for b in setup["osd_batches"]]
    return want, jtr.state.params


@WORLDS
def test_module_trainer_masked_bce_over_ranks_matches_jax(worlds, jax_masked_bce, world):
    """The masked mean over the whole batch (numerator and denominator
    summed over the ranks), not the mean of the ranks' means: the rows'
    valid frames differ (10, 3, 8, 1)."""
    want, params = jax_masked_bce
    _compare_training(_out(worlds, world, "osd_trainer"), params, want)


def test_sp_encoder_gradients_over_ranks_equal_one_process(worlds):
    got = _out(worlds, 2, "sp_encoder_grads")
    assert got["loss_rel"] <= 1e-6 and got["grad_rel"] <= 1e-5, got


@WORLDS
def test_dryrun_multichip_over_ranks(worlds, world):
    got = _out(worlds, world, "dryrun")
    assert np.isfinite(got["train_loss"]) and got["sp_err"] < 1e-4
    assert got["tp_err"] < 2e-4 and got["sp_sep_err"] < 1e-4


@WORLDS
def test_every_rank_holds_rank0_outputs(worlds, world):
    """The mesh paths give every rank the whole result."""
    outs = worlds[world]
    for name in ("ring", "sp_convtasnet", "tp_mossformer"):
        for o in outs[1:]:
            np.testing.assert_array_equal(o[name], outs[0][name])
    for o in outs[1:]:
        assert o["sep_trainer"]["losses"] == outs[0]["sep_trainer"]["losses"]
        for name, w in outs[0]["sep_trainer"]["params"].items():
            np.testing.assert_array_equal(o["sep_trainer"]["params"][name], w)
