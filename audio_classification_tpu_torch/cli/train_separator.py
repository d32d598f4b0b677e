"""Train a Conv-TasNet or MossFormer separator with checkpoint / resume
(port of audio_classification_tpu/cli/train_separator.py).

- data: LibriMix on disk (``--librimix-root``, ``--dynamic-mix`` remixes
  sources of different items with random gains) or synthetic harmonic
  scenes (``--synthetic``);
- model: ``--arch convtasnet|mossformer`` at the widths of the flags; a
  Conv-TasNet trains its dense TCN loop, as the JAX trainer does;
- parallelism (parallel/launch.py): ``--data-parallel`` N x
  ``--model-parallel`` M ranks under ``torchrun``, one card each: each of
  the N data entries takes ``--batch`` rows (the global batch is N x
  ``--batch``, as in JAX) and the separator runs tensor-parallel over M;
  ``--time-shard`` cuts each crop's time axis into ``--data-parallel`` N
  shards instead (parallel/sp_convtasnet), on N ranks or, in one process,
  on the one card, the backward through the same halos and sums. Only rank
  0 writes checkpoints and exports;
- checkpoint / resume: ``--ckpt-dir`` keeps params, Adam moments and step
  every ``--save-every`` steps; ``--resume`` continues from them exactly;
- ``--export DIR``: the trained weights, which ``--sep-checkpoint DIR`` and
  ``Separator(checkpoint=DIR)`` load.

The gate line at the end is the held-out SI-SDRi through the pipelines' PIT
metric (metrics/sisdr), printed as the JAX CLI prints it. ``--export-onnx
FILE`` writes the trained separator as an ONNX graph (convert/onnx_export:
mix [batch, T] -> est, T baked from ``--seconds``).

    python -m audio_classification_tpu_torch.cli.train_separator --synthetic \\
        --steps 300 --export sep_dir [--provider cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    d = p.add_argument_group("data")
    d.add_argument("--librimix-root", default="", help="LibriMix tree root")
    d.add_argument("--subset", default="train-100",
                   choices=["train-360", "train-100", "dev", "test"])
    d.add_argument("--synthetic", action="store_true",
                   help="Train on synthetic harmonic scenes (no corpus needed)")
    d.add_argument("--dynamic-mix", action="store_true",
                   help="Remix sources from DIFFERENT LibriMix items with random gains "
                        "every step")
    d.add_argument("--n-src", type=int, default=2, choices=[2, 3])
    d.add_argument("--sample-rate", type=int, default=8000, choices=[8000, 16000])
    d.add_argument("--seconds", type=float, default=1.0, help="Training crop length")
    t = p.add_argument_group("training")
    t.add_argument("--steps", type=int, default=300)
    t.add_argument("--batch", type=int, default=8, help="Batch per step")
    t.add_argument("--lr", type=float, default=5e-4)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--log-every", type=int, default=50)
    t.add_argument("--provider", default="cuda", help="cuda (default) or cpu")
    m = p.add_argument_group("model (tiny by default; raise for quality)")
    m.add_argument("--arch", default="convtasnet", choices=["convtasnet", "mossformer"],
                   help="Separator architecture (both serve via --sep-checkpoint / "
                        "Separator(backend=..., checkpoint=...); dims must match the "
                        "serving preset's config to load there)")
    m.add_argument("--enc-dim", type=int, default=128)
    m.add_argument("--bottleneck", type=int, default=64)
    m.add_argument("--hidden", type=int, default=128)
    m.add_argument("--n-blocks", type=int, default=4)
    m.add_argument("--n-repeats", type=int, default=2)
    mf = p.add_argument_group("mossformer model (--arch mossformer)")
    mf.add_argument("--mf-dim", type=int, default=96)
    mf.add_argument("--mf-qk-dim", type=int, default=64)
    mf.add_argument("--mf-layers", type=int, default=4)
    mf.add_argument("--mf-expansion", type=int, default=2)
    par = p.add_argument_group("parallelism")
    par.add_argument("--data-parallel", type=int, default=0,
                     help="Data-parallel ranks (torchrun, one card each); with "
                          "--time-shard the time shards (on the one card without torchrun)")
    par.add_argument("--model-parallel", type=int, default=0)
    par.add_argument("--slices", type=int, default=1)
    par.add_argument("--time-shard", action="store_true",
                     help="Shard each crop's TIME axis (sequence-parallel training)")
    c = p.add_argument_group("checkpointing")
    c.add_argument("--ckpt-dir", default="", help="Resumable train-state dir")
    c.add_argument("--save-every", type=int, default=100)
    c.add_argument("--resume", action="store_true",
                   help="Resume from --ckpt-dir if it holds a checkpoint")
    c.add_argument("--export", default="",
                   help="Write the trained weights (loads via --sep-checkpoint / "
                        "Separator(checkpoint=...))")
    c.add_argument("--export-onnx", default="",
                   help="Also write the trained separator as an ONNX file (mix [batch, T] "
                        "-> est, T = --seconds; Conv-TasNet or MossFormer by --arch)")
    return p.parse_args(argv)


def synthetic_batch(rng, b, n_src, t, sr):
    """Harmonic voices with random f0 / envelopes; distinct f0 bands per
    source so the PIT objective has separable structure to learn."""
    bands = [(80, 220), (240, 500), (520, 900)][:n_src]
    refs = np.zeros((b, n_src, t), np.float32)
    tt = np.arange(t) / sr
    for i in range(b):
        for k in range(n_src):
            f0 = rng.uniform(*bands[k])
            env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.3, 1.5) * tt
                                     + rng.uniform(0, 6.28))
            sig = sum(np.sin(2 * np.pi * f0 * (h + 1) * tt + rng.uniform(0, 6.28))
                      / (h + 1) for h in range(4))
            refs[i, k] = 0.25 * env * sig
    return refs.sum(axis=1).astype(np.float32), refs


class LibriMixSampler:
    """Random fixed-length crops of (mix, sources) from a LibriMix tree;
    ``dynamic=True`` composes each mixture from sources of different items
    with random gains (+-5 dB)."""

    def __init__(self, root, subset, n_src, sr, crop, rng, dynamic=False):
        from ..data.librimix import LibriMixDataset

        self.ds = LibriMixDataset(root, subset=subset, num_speakers=n_src,
                                  sample_rate=sr, task="sep_clean")
        if not len(self.ds):
            raise FileNotFoundError(f"no LibriMix mixtures under {root}")
        self.n_src, self.crop, self.rng = n_src, crop, rng
        self.dynamic = bool(dynamic)

    def _item_sources(self):
        while True:
            _, mix, srcs = self.ds[int(self.rng.integers(len(self.ds)))]
            if srcs is not None:
                return mix, srcs

    def batch(self, b):
        mixes = np.zeros((b, self.crop), np.float32)
        refs = np.zeros((b, self.n_src, self.crop), np.float32)
        for i in range(b):
            if self.dynamic:
                for k in range(self.n_src):
                    _, srcs = self._item_sources()
                    src = srcs[int(self.rng.integers(len(srcs)))]
                    n = min(len(src), self.crop)
                    off = int(self.rng.integers(max(len(src) - self.crop, 0) + 1))
                    gain = 10.0 ** (self.rng.uniform(-5.0, 5.0) / 20.0)
                    refs[i, k, :n] = gain * src[off:off + n]
                mixes[i] = refs[i].sum(axis=0)
            else:
                mix, srcs = self._item_sources()
                n = min(len(mix), self.crop)
                off = int(self.rng.integers(max(len(mix) - self.crop, 0) + 1))
                mixes[i, :n] = mix[off:off + n]
                for k in range(self.n_src):
                    refs[i, k, :n] = srcs[k][off:off + n]
        return mixes, refs


def separator_config(args):
    from ..models.convtasnet import ConvTasNetConfig
    from ..models.mossformer import MossFormerConfig

    if args.arch == "mossformer":
        return MossFormerConfig(n_src=args.n_src, enc_dim=args.enc_dim, enc_kernel=16,
                                dim=args.mf_dim, qk_dim=args.mf_qk_dim, layers=args.mf_layers,
                                expansion=args.mf_expansion, sample_rate=args.sample_rate)
    return ConvTasNetConfig(n_src=args.n_src, enc_dim=args.enc_dim, enc_kernel=16,
                            bottleneck=args.bottleneck, hidden=args.hidden,
                            n_blocks=args.n_blocks, n_repeats=args.n_repeats,
                            sample_rate=args.sample_rate)


def main(argv=None):
    args = parse_args(argv)
    if not args.synthetic and not args.librimix_root:
        raise SystemExit("pick a data source: --librimix-root DIR or --synthetic")
    import torch

    from ..engine.runtime import resolve_device
    from ..metrics import sdr_improvement_pit_2
    from ..parallel.launch import is_writer, training_mesh
    from ..train.checkpoint import save_params
    from ..train.data import write_run_manifest
    from ..train.trainer import SeparatorTrainer

    device = resolve_device(args.provider)
    sr = args.sample_rate
    t = int(args.seconds * sr)
    cfg = separator_config(args)
    mesh = training_mesh(args, device, "--time-shard", args.time_shard)
    device = mesh.device if mesh is not None else device
    trainer = SeparatorTrainer(cfg, mesh=mesh, lr=args.lr, seed=args.seed,
                               time_shard=args.time_shard, device=device)
    global_batch = args.batch * (1 if args.time_shard or mesh is None else mesh.shape["data"])

    start_step = 0
    if args.resume and args.ckpt_dir and Path(args.ckpt_dir).is_dir():
        start_step = trainer.restore(args.ckpt_dir)
        print(f"[train_separator] resumed {args.ckpt_dir} at step {start_step}")
    rng = np.random.default_rng(args.seed + start_step)  # fresh data stream post-resume

    if args.synthetic:
        def sample(b):
            return synthetic_batch(rng, b, args.n_src, t, sr)

        held = synthetic_batch(np.random.default_rng(123), 16, args.n_src, t, sr)
    else:
        sampler = LibriMixSampler(args.librimix_root, args.subset, args.n_src, sr, t, rng,
                                  dynamic=args.dynamic_mix)
        sample = sampler.batch
        # held out on the corpus' REAL mixtures even when training dynamic
        held = LibriMixSampler(args.librimix_root, args.subset, args.n_src, sr, t,
                               np.random.default_rng(123)).batch(16)

    def eval_sisdri(n=16):
        mix, refs = held
        with torch.no_grad():
            m = torch.from_numpy(mix).to(device)
            est = trainer.model(m, torch.ones_like(m)).cpu().numpy()
        vals = []
        for i in range(min(n, mix.shape[0])):
            # the pairwise PIT metric over the first two sources covers both
            # n_src settings
            _, sdri, _, _ = sdr_improvement_pit_2(mix[i], refs[i, 0], refs[i, 1],
                                                  [est[i, 0], est[i, 1]])
            if np.isfinite(sdri):
                vals.append(sdri)
        return float(np.mean(vals)) if vals else float("nan")

    before = eval_sisdri()
    print(f"[train_separator] held-out SI-SDRi at step {start_step}: {before:+.2f} dB")
    losses = []
    t0 = time.time()
    for step in range(start_step + 1, args.steps + 1):
        mix, refs = sample(global_batch)
        loss = trainer.train_step(mix, refs, np.ones_like(mix))
        losses.append(loss)
        if step % args.log_every == 0 or step == start_step + 1:
            rate = (time.time() - t0) / max(step - start_step, 1) * 1000
            print(f"step {step:5d}  loss(-SI-SDR) {loss:8.3f}  ({rate:.0f} ms/step)")
        if args.ckpt_dir and args.save_every and step % args.save_every == 0:
            trainer.save(args.ckpt_dir)
            print(f"[train_separator] checkpoint @ step {step} -> {args.ckpt_dir}")
    if args.ckpt_dir and trainer.step > start_step:
        trainer.save(args.ckpt_dir)
    after = eval_sisdri()
    print(f"[train_separator] held-out SI-SDRi after: {after:+.2f} dB "
          f"(gain {after - before:+.2f} dB)")

    if not is_writer():  # a rank of a mesh: rank 0 writes
        return before, after
    if args.export:
        save_params(trainer.model, args.export, config=dataclasses.asdict(cfg), arch=args.arch)
        print(f"[train_separator] exported serving params -> {args.export} "
              f"(use --sep-checkpoint {args.export})")
    if args.export_onnx:
        from ..convert.from_jax import state_dict_to_variables
        from ..convert.onnx_export import export_convtasnet, export_mossformer

        exporter = export_mossformer if args.arch == "mossformer" else export_convtasnet
        exporter(state_dict_to_variables(trainer.model), cfg, args.export_onnx,
                 seconds=args.seconds)
        print(f"[train_separator] exported ONNX -> {args.export_onnx} "
              f"(mix [batch,{t}] -> est [batch,{args.n_src},{t}])")
    for d in filter(None, {args.ckpt_dir, args.export}):
        write_run_manifest(d, args, {"si_sdri_before": before, "si_sdri_after": after,
                                     "losses": losses})
    return before, after


if __name__ == "__main__":
    main()
