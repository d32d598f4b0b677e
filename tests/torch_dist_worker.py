"""Ranks of a gloo world on the CPU for the port's mesh tests (not a test
module). ``run_world(world, cases, tmp)`` spawns ``world`` processes; each
joins a ``file://`` process group (parallel xdist workers never race for a
port), runs every case of ``cases`` ({name: (function name, kwargs)}) with
the port and writes its outputs to ``tmp/out_<rank>.pt``. The parent gets
every rank's outputs back. The workers import torch and the port only.
"""
import os
import sys
import traceback
from pathlib import Path

import numpy as np
import torch


def _tensor(x):
    return torch.as_tensor(np.asarray(x))


def _mesh(n, model_axis=1):
    """A mesh of n CPU entries over the world (all local without one)."""
    from audio_classification_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n, model_axis=model_axis, devices=["cpu"] * n)


# --------------------------------------------------------------- cases
def case_ring(q, k, v, mask, n, model_axis=1):
    from audio_classification_tpu_torch.parallel.ring_attention import ring_attention

    mesh = _mesh(n, model_axis)
    return ring_attention(_tensor(q), _tensor(k), _tensor(v), mesh,
                          kv_mask=None if mask is None else _tensor(mask)).numpy()


def _separator(arch, cfg, state):
    from audio_classification_tpu_torch.models.convtasnet import ConvTasNet
    from audio_classification_tpu_torch.models.mossformer import MossFormer

    model = (MossFormer if arch == "mossformer" else ConvTasNet)(cfg)
    model.load_state_dict(state)
    return model.eval()


def case_sp(arch, cfg, state, mix, lengths, n):
    from audio_classification_tpu_torch.parallel.sp_convtasnet import (sp_separate,
                                                                     sp_separate_mossformer)

    model = _separator(arch, cfg, state)
    fn = sp_separate_mossformer if arch == "mossformer" else sp_separate
    with torch.no_grad():
        return fn(model, _tensor(mix), _tensor(lengths), _mesh(n)).numpy()


def case_tp(arch, cfg, state, mix, mask, data, model_axis):
    model = _separator(arch, cfg, state)
    with torch.no_grad():
        return model(_tensor(mix), _tensor(mask),
                     mesh=_mesh(data * model_axis, model_axis)).numpy()


def case_pipeline(cfg_kw, states):
    """The flagship pipeline with the engine over the world's mesh; the
    records of rank 0 (the writer) and the segment count of every rank."""
    from audio_classification_tpu_torch.parallel.launch import is_writer
    from audio_classification_tpu_torch.pipelines.offline_overlap3 import (Overlap3Pipeline,
                                                                         build_engine)
    from audio_classification_tpu_torch.utils.config import Overlap3Config

    cfg = Overlap3Config(**cfg_kw)
    engine = build_engine(cfg)
    engine.pack.load_state_dicts(states)
    res = Overlap3Pipeline(cfg, engine=engine).run()
    return {"segments": res.segments, "writer": is_writer(),
            "mesh": None if engine.mesh is None else dict(engine.mesh.shape)}


def case_cli(argv):
    from audio_classification_tpu_torch.cli import offline_overlap_3src

    out_dir, _res = offline_overlap_3src.main(argv)
    return sorted(p.name for p in Path(out_dir).iterdir()) if out_dir else None


def case_serve(argv):
    """serve_streams over the world's mesh -> (stats, records) on rank 0."""
    import json

    from audio_classification_tpu_torch.cli import serve_streams

    stats = serve_streams.main(argv)
    out = Path(argv[argv.index("--out") + 1])
    recs = [json.loads(x) for x in out.read_text().splitlines()] if out.is_file() else None
    return {"stats": stats, "records": recs}


def case_stream(argv):
    """The streaming application over the world's mesh -> its records."""
    from audio_classification_tpu_torch.cli import streaming_overlap_3src

    app = streaming_overlap_3src.main(argv)
    return {"results": app.all_results, "chunks": app.pipeline.latency_stats()["chunks"]}


def case_serve_backpressure(argv, windows, slow):
    """A StreamingServer over the world's mesh whose ticks take ``slow``
    seconds more, fed ``windows`` windows a session at once on rank 0 and one
    every ``slow / 4`` seconds on the others, so the ranks' drop-oldest
    bounds drop different windows -> the window numbers each tick ran per
    session, the records (kind, stream, text) and the windows this rank
    dropped."""
    import time

    from audio_classification_tpu_torch.audio_io import read_wav
    from audio_classification_tpu_torch.cli.serve_streams import parse_args
    from audio_classification_tpu_torch.pipelines.serving import StreamingServer
    from audio_classification_tpu_torch.parallel.mesh import world_info

    args = parse_args(argv)
    server = StreamingServer(args, autostart=False)
    ran = []
    compute = server._tick_compute

    def slow_tick(work):
        ran.append(sorted((s.sid, item["seq"]) for s, item in work))
        time.sleep(slow)
        compute(work)

    server._tick_compute = slow_tick
    targets = (args.targets * len(args.wavs))[:len(args.wavs)]
    sids = [server.open_session(target_wav=t, transcribe_target=False) for t in targets]
    server._worker = __import__("threading").Thread(target=server._tick_loop, daemon=True)
    server._worker.start()
    wavs = [read_wav(w)[0] for w in args.wavs]
    window = int(args.process_seconds * 16000)
    rank = world_info()[0]
    for i in range(windows):
        for sid, w in zip(sids, wavs):
            server.add_audio(sid, w[(i * window) % (len(w) - window):][:window], 16000)
        if rank:
            time.sleep(slow / 4)
    assert server.drain(timeout=120.0)
    server.close()
    recs = sorted((sid, r["kind"], -1 if r["stream"] is None else r["stream"], r["text"])
                  for sid in sids for r in server.get_results(sid))
    return {"ran": ran, "records": recs, "dropped": server.chunks_dropped}


def case_distill_osd(argv):
    """distill_osd over the whole world (DP over every rank) -> its held-out
    OSD metrics and the trained weights (rank 0 writes them)."""
    from audio_classification_tpu_torch.cli import distill_osd

    return distill_osd.main(argv)


def case_bank(bank, queries, threshold, n):
    from audio_classification_tpu_torch.models.speaker import SpeakerBank

    sb = SpeakerBank(bank.shape[1], mesh=_mesh(n))
    for i, row in enumerate(bank):
        sb.add(f"spk{i}", row)
    return [sb.search(q, threshold) for q in queries]


def case_sep_trainer(arch, cfg, state, batches, lr, data, model_axis, time_shard=False):
    from audio_classification_tpu_torch.train.trainer import SeparatorTrainer

    mesh = _mesh(data * model_axis, model_axis)
    tr = SeparatorTrainer(cfg, mesh=mesh, lr=lr, time_shard=time_shard, device="cpu")
    tr.model.load_state_dict(state)
    losses = [tr.train_step(*b) for b in batches]
    return {"losses": losses,
            "params": {k: v.detach().numpy().copy() for k, v in tr.model.state_dict().items()}}


def case_osd_trainer(cfg, state, batches, lr, data):
    from audio_classification_tpu_torch.models.osd import OSDNet
    from audio_classification_tpu_torch.train.losses import frame_bce_loss
    from audio_classification_tpu_torch.train.trainer import ModuleTrainer

    model = OSDNet(cfg)
    model.load_state_dict(state)

    def loss_fn(module, b):
        return frame_bce_loss(module(b["feats"], b["mask"].bool()), b["labels"], b["lmask"],
                              parts=True)

    tr = ModuleTrainer(model, loss_fn, lr=lr, device="cpu", mesh=_mesh(data))
    losses = [tr.train_step(b) for b in batches]
    return {"losses": losses,
            "params": {k: v.detach().numpy().copy() for k, v in tr.model.state_dict().items()}}


def case_sp_encoder_grads(seed, n):
    """A small SenseVoice encoder's loss and gradients with its attention
    ring-parallel over the world's mesh against the same without a mesh ->
    their largest relative differences."""
    from audio_classification_tpu_torch.models.asr.sensevoice import (SenseVoiceConfig,
                                                                     SenseVoiceEncoder)
    from audio_classification_tpu_torch.train.trainer import flax_init_

    enc = flax_init_(SenseVoiceEncoder(SenseVoiceConfig(vocab_size=12, dim=16, heads=2,
                                                        layers=2, ffn_mult=2, conv_kernel=3)),
                     seed).eval()
    gen = torch.Generator().manual_seed(seed)
    feats = torch.randn((2, 40, enc.cfg.lfr_m * enc.cfg.num_mel), generator=gen)
    mask = torch.arange(40)[None, :] < torch.tensor([40, 27])[:, None]
    out = []
    for mesh in (None, _mesh(n)):
        enc.zero_grad()
        loss = (enc(feats, mask, mesh=mesh) ** 2).mean()
        loss.backward()
        out.append((float(loss), {k: p.grad.clone() for k, p in enc.named_parameters()
                                  if p.grad is not None}))
    (l0, g0), (l1, g1) = out
    assert g0.keys() == g1.keys()
    return {"loss_rel": abs(l1 - l0) / abs(l0),
            "grad_rel": max(float((g1[k] - g).abs().max() / g.abs().max().clamp_min(1e-30))
                            for k, g in g0.items())}


def case_mesh_device(n):
    """Under the gloo world: the device of a mesh asked for on the CPU, and
    the refusal of one asked for on CUDA (gloo does not carry CUDA
    tensors) -> (device, message)."""
    from audio_classification_tpu_torch.parallel.launch import mesh_for
    from audio_classification_tpu_torch.parallel.mesh import make_mesh

    dev = str(mesh_for(n, 0, 1, "cpu").device)
    try:
        make_mesh(n, devices=["cuda"] * n)
    except ValueError as e:
        return dev, str(e)
    return dev, None


def case_dryrun(n):
    from audio_classification_tpu_torch.parallel.dryrun import dryrun_multichip

    return dryrun_multichip(n, device="cpu")


# --------------------------------------------------------------- ranks
def _rank_main(rank, world, init_file, cases_file, out_dir):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    out = {}
    try:
        cases = torch.load(cases_file, weights_only=False)
        mod = sys.modules[__name__]
        for name, (fn, kw) in cases.items():
            try:
                out[name] = getattr(mod, fn)(**kw)
            except Exception as e:  # the parent's test of this case reports it
                out[name] = RuntimeError(f"rank {rank}: {type(e).__name__}: {e}\n"
                                         + traceback.format_exc())
    finally:
        torch.save(out, Path(out_dir) / f"out_{rank}.pt")
        dist.destroy_process_group()


def run_world(world: int, cases: dict, tmp: Path, timeout: float = 240.0) -> list:
    """Spawn ``world`` gloo ranks over ``cases`` -> each rank's outputs."""
    import multiprocessing as mp

    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    cases_file = tmp / "cases.pt"
    torch.save(cases, cases_file)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(tmp / "pg_init"), str(cases_file), str(tmp)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    outs = []
    for r in range(world):
        f = tmp / f"out_{r}.pt"
        if not f.is_file():
            raise RuntimeError(f"gloo rank {r} of {world} wrote nothing "
                               f"(exit code {procs[r].exitcode})")
        outs.append(torch.load(f, weights_only=False))
    return outs
