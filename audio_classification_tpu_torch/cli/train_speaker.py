"""Train the speaker embedder (AAM softmax) with resume and a serving export
(port of audio_classification_tpu/cli/train_speaker.py).

- data: a manifest of ``{"wav": ..., "speaker": ...}`` JSONL lines (or
  ``wav<TAB>speaker``), cropped / padded and resampled to 16 kHz, or
  ``--synthetic`` harmonic "speakers" (a fixed timbre and f0 band each);
- objective: additive-angular-margin softmax over the speaker set; the
  class centres train with the embedder and are dropped at export;
- checkpoint / resume (``--ckpt-dir``, ``--resume``) and ``--export DIR``:
  the embedder alone, which ``--spk-embed-model DIR`` serves.

The gate: held-out identification accuracy through SpeakerBank's cosine
search, with same / different-speaker cosine means and the EER, before and
after. The embedder's BatchNorm layers run on their initial statistics (the
module stays in ``eval()``), so they act as learnable affines, as in the JAX
CLI. ``--export-onnx FILE`` writes the embedder as an ONNX graph (fbank
feats [batch, frames] -> emb, frames of the ``--max-seconds`` crop).
``--data-parallel`` N ranks under ``torchrun`` (parallel/launch.py), one
card each, take ``--batch`` rows each (the global batch is N x ``--batch``,
as in JAX); only rank 0 writes.

    python -m audio_classification_tpu_torch.cli.train_speaker --synthetic \\
        --steps 300 --export spk_dir [--provider cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np

from ..train.trainer import embedder_with_head

SR = 16000


def parse_args(argv=None):
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    d = p.add_argument_group("data")
    d.add_argument("--manifest", default="",
                   help="JSONL {wav,speaker} or TSV wav<TAB>speaker list")
    d.add_argument("--val-manifest", default="",
                   help="Held-out list for the accuracy gate (default: tail of --manifest)")
    d.add_argument("--synthetic", action="store_true", help="Harmonic-speaker smoke")
    d.add_argument("--num-speakers", type=int, default=8, help="Synthetic identity count")
    d.add_argument("--max-seconds", type=float, default=2.0,
                   help="Crop / pad every utterance to this length")
    t = p.add_argument_group("training")
    t.add_argument("--steps", type=int, default=300)
    t.add_argument("--batch", type=int, default=16, help="Batch per step")
    t.add_argument("--lr", type=float, default=3e-4)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--log-every", type=int, default=100)
    t.add_argument("--margin", type=float, default=0.2, help="AAM margin")
    t.add_argument("--aam-scale", type=float, default=30.0)
    t.add_argument("--provider", default="cuda", help="cuda (default) or cpu")
    m = p.add_argument_group("model (match the serving preset when exporting: "
                             "full=32,64,128,256/192, tiny=8,16/32)")
    m.add_argument("--channels", default="8,16", help="Comma-separated Res2Net stage widths")
    m.add_argument("--embed-dim", type=int, default=32)
    m.add_argument("--scale", type=int, default=4)
    m.add_argument("--asp-hidden", type=int, default=128)
    par = p.add_argument_group("parallelism")
    par.add_argument("--data-parallel", type=int, default=0)
    par.add_argument("--model-parallel", type=int, default=0)
    par.add_argument("--slices", type=int, default=1)
    c = p.add_argument_group("checkpointing")
    c.add_argument("--ckpt-dir", default="")
    c.add_argument("--save-every", type=int, default=100)
    c.add_argument("--resume", action="store_true")
    c.add_argument("--export", default="",
                   help="Write the embedder's weights (serves via --spk-embed-model <dir>)")
    c.add_argument("--export-onnx", default="",
                   help="Also write the embedder as an ONNX file (fbank feats -> emb)")
    return p.parse_args(argv)


def synth_utterance(rng, spk: int, dur: float = 1.0) -> np.ndarray:
    """A 'speaker' = a stable harmonic amplitude profile + f0 band."""
    t = int(dur * SR)
    tt = np.arange(t) / SR
    prof = np.random.default_rng(1000 + spk)
    amps = prof.uniform(0.2, 1.0, size=6)
    f0 = prof.uniform(90, 300) * rng.uniform(0.95, 1.05)
    phase = rng.uniform(0, 6.28, size=6)
    env = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.5, 2.0) * tt + rng.uniform(0, 6.28))
    sig = sum(a * np.sin(2 * np.pi * f0 * (h + 1) * tt + ph)
              for h, (a, ph) in enumerate(zip(amps, phase)))
    return (0.1 * env * sig).astype(np.float32)


def read_manifest(path: str):
    """-> [(wav_path, speaker)]; JSONL {wav,speaker} or TSV."""
    from ..train.data import read_manifest as _rm

    return _rm(path, "speaker")


class ManifestSampler:
    """Random (cropped wav, label id) batches from a manifest."""

    def __init__(self, items, spk2id, t_max, rng):
        from ..train.data import WavCache

        self.items, self.spk2id = items, spk2id
        self.t_max, self.rng = t_max, rng
        self._wav = WavCache()

    def batch(self, n):
        wavs = np.zeros((n, self.t_max), np.float32)
        labels = np.zeros(n, np.int32)
        for i in range(n):
            path, spk = self.items[int(self.rng.integers(len(self.items)))]
            audio = self._wav(path)
            if audio.size > self.t_max:
                off = int(self.rng.integers(audio.size - self.t_max + 1))
                audio = audio[off:off + self.t_max]
            wavs[i, : audio.size] = audio
            labels[i] = self.spk2id[spk]
        return wavs, labels


class SyntheticSampler:
    def __init__(self, n_spk, t_max, rng):
        self.n_spk, self.t_max, self.rng = n_spk, t_max, rng

    def batch(self, n):
        labels = self.rng.integers(0, self.n_spk, size=n).astype(np.int32)
        wavs = np.zeros((n, self.t_max), np.float32)
        for i, s in enumerate(labels):
            u = synth_utterance(self.rng, int(s), self.t_max / SR)[: self.t_max]
            wavs[i, : u.size] = u
        return wavs, labels


def main(argv=None):
    args = parse_args(argv)
    if not args.synthetic and not args.manifest:
        raise SystemExit("pick a data source: --manifest FILE or --synthetic")
    import torch

    from ..engine.runtime import resolve_device
    from ..metrics import eer
    from ..models.speaker import SpeakerBank, SpeakerEmbedderConfig
    from ..ops.fbank import FbankConfig, log_mel_fbank
    from ..train.checkpoint import save_params
    from ..train.data import write_run_manifest
    from ..train.losses import aam_softmax_loss
    from ..train.trainer import ModuleTrainer, flax_init_

    from ..parallel.launch import is_writer, training_mesh

    device = resolve_device(args.provider)
    mesh = training_mesh(args, device)
    device = mesh.device if mesh is not None else device
    cfg = SpeakerEmbedderConfig(channels=tuple(int(c) for c in args.channels.split(",")),
                                scale=args.scale, embed_dim=args.embed_dim,
                                asp_hidden=args.asp_hidden)
    t_max = int(args.max_seconds * SR)
    rng = np.random.default_rng(args.seed)
    if args.synthetic:
        n_spk = args.num_speakers
        sampler = SyntheticSampler(n_spk, t_max, rng)
        val_sampler = SyntheticSampler(n_spk, t_max, np.random.default_rng(123))
    else:
        items = read_manifest(args.manifest)
        if args.val_manifest:
            val_items = read_manifest(args.val_manifest)
        else:  # hold out the manifest tail
            cut = max(len(items) - max(len(items) // 10, 1), 1)
            items, val_items = items[:cut], items[cut:]
        # ids over the UNION of manifests: a held-out speaker absent from
        # training is fine for the bank-search gate (open set)
        spk2id = {s: i for i, s in enumerate(sorted({s for _, s in items}
                                                    | {s for _, s in val_items}))}
        n_spk = len(spk2id)
        sampler = ManifestSampler(items, spk2id, t_max, rng)
        val_sampler = ManifestSampler(val_items, spk2id, t_max, np.random.default_rng(123))
    print(f"[train_speaker] {n_spk} speakers, crop {args.max_seconds}s")

    fb = FbankConfig()

    def fbank_batch(wavs):
        return log_mel_fbank(torch.from_numpy(np.asarray(wavs, np.float32)).to(device), fb)

    model = flax_init_(embedder_with_head(cfg, n_spk), args.seed).to(device)

    def loss_fn(module, b):
        emb, w = module(b["feats"])
        return aam_softmax_loss(emb, b["labels"], w, margin=args.margin, scale=args.aam_scale)

    trainer = ModuleTrainer(model, loss_fn, lr=args.lr, device=device, mesh=mesh)
    global_batch = args.batch * (1 if mesh is None else mesh.shape["data"])

    start_step = 0
    if args.resume and args.ckpt_dir and Path(args.ckpt_dir).is_dir():
        start_step = trainer.restore(args.ckpt_dir)
        print(f"[train_speaker] resumed {args.ckpt_dir} at step {start_step}")

    def embed(wavs) -> np.ndarray:
        with torch.no_grad():
            emb = model.embedder(fbank_batch(wavs))
            emb = emb / torch.clamp_min(torch.linalg.norm(emb, dim=-1, keepdim=True), 1e-12)
        return emb.cpu().numpy()

    def eval_accuracy():
        """Enroll one utterance per speaker and identify held-out ones
        through SpeakerBank's cosine search."""
        k = min(n_spk, 16)
        enroll_w, enroll_l = val_sampler.batch(4 * k)
        trial_w, trial_l = val_sampler.batch(4 * k)
        embs_e, embs_t = embed(enroll_w), embed(trial_w)
        bank = SpeakerBank(cfg.embed_dim, device=device)
        seen = set()
        for e, lab in zip(embs_e, enroll_l):
            if int(lab) not in seen:
                bank.add(f"spk{int(lab)}", e)
                seen.add(int(lab))
        correct = total = 0
        same, diff = [], []
        for e, lab in zip(embs_t, trial_l):
            if int(lab) not in seen:
                continue
            name = bank.search(e, threshold=-1.0)
            correct += name == f"spk{int(lab)}"
            total += 1
            scores = bank.scores(e[None]).cpu().numpy()[0]
            for j, nm in enumerate(bank.names):
                (same if nm == f"spk{int(lab)}" else diff).append(scores[j])
        acc = correct / max(total, 1)
        e_rate, thr = eer(same, diff)
        return (acc, float(np.mean(same)) if same else float("nan"),
                float(np.mean(diff)) if diff else float("nan"), e_rate, thr)

    a0, s0, d0, e0, _ = eval_accuracy()
    print(f"[train_speaker] held-out id accuracy at step {start_step}: "
          f"{a0:.3f} (same-cos {s0:.3f} / diff-cos {d0:.3f} / EER {e0:.3f})")
    losses = []
    t0 = time.time()
    for step in range(start_step + 1, args.steps + 1):
        wavs, labels = sampler.batch(global_batch)
        loss = trainer.train_step({"feats": fbank_batch(wavs), "labels": labels})
        losses.append(loss)
        if step % args.log_every == 0 or step == start_step + 1:
            rate = (time.time() - t0) / max(step - start_step, 1) * 1000
            print(f"step {step:5d}  AAM loss {loss:8.4f}  ({rate:.0f} ms/step)")
        if args.ckpt_dir and args.save_every and step % args.save_every == 0:
            trainer.save(args.ckpt_dir)
            print(f"[train_speaker] checkpoint @ step {step} -> {args.ckpt_dir}")
    if args.ckpt_dir and trainer.step > start_step:
        trainer.save(args.ckpt_dir)
    a1, s1, d1, e1, thr1 = eval_accuracy()
    print(f"[train_speaker] held-out id accuracy after: {a1:.3f} "
          f"(same-cos {s1:.3f} / diff-cos {d1:.3f} / EER {e1:.3f} "
          f"@thr {thr1:.3f} -- a calibrated --sv-threshold)")

    if not is_writer():  # a rank of a mesh: rank 0 writes
        return a0, a1
    if args.export:
        # the embedder alone, shaped as the engine's spk stage; the AAM
        # centres are dropped
        save_params(model.embedder, args.export, config=dataclasses.asdict(cfg))
        print(f"[train_speaker] exported serving params -> {args.export} "
              f"(use --spk-embed-model {args.export})")
    if args.export_onnx:
        from ..convert.from_jax import state_dict_to_variables
        from ..convert.onnx_export import export_speaker

        frames = fb.frames_for(t_max)  # the training crop's fbank frames
        export_speaker(state_dict_to_variables(model.embedder), cfg, args.export_onnx,
                       frames=frames)
        print(f"[train_speaker] exported ONNX -> {args.export_onnx} "
              f"(feats [batch,{frames},{fb.num_bins}] -> emb)")
    for d in filter(None, {args.ckpt_dir, args.export}):
        write_run_manifest(d, args, {"accuracy_before": a0, "accuracy_after": a1,
                                     "eer_after": e1, "losses": losses})
    return a0, a1


if __name__ == "__main__":
    main()
