"""Distill an ONNX SenseVoice teacher into a small trainable CTC encoder
(port of audio_classification_tpu/cli/distill_asr.py).

The reference's recognizer is a frozen ~25k-vocab int8 export consumed
as-is (reference: src/model.py:79-87); this tool compresses such an export,
or one written by the port's own ``train_asr --export-onnx``, into a
custom-sized encoder by per-frame logit distillation:

- teacher: any SenseVoice-shaped ONNX file, run whole by the port's graph
  executor through the SAME OnnxStage the serving engine uses (real sherpa
  exports' x / x_length / language / textnorm inputs auto-detected, prompt
  frames skipped), with the frontend (kernel K1) in front and the greedy
  CTC ids after, on the card under ``torch.inference_mode``; teacher
  logits are computed once per batch outside the train step (no gradients
  through the teacher);
- student: SenseVoiceEncoder at --dim / --heads / --layers (any size),
  trained by train/trainer.ModuleTrainer (its attention runs K3 from
  512 frames on);
- data: UNLABELED audio, a wav list / manifest or --synthetic scenes; KD
  needs no transcripts;
- loss: temperature-scaled KL(teacher || student) over valid frames
  (Hinton KD, tau^2 compensation), optional CTC on the teacher's own greedy
  labels via --ctc-weight;
- gate: student-vs-teacher greedy-decode agreement CER on held-out audio;
- checkpoint / resume / export as cli/train_asr (``--export`` serves via
  ``--sense-voice <dir>`` when the dims match the preset);
- ``--seq-parallel``: the student's attention ring-parallel over
  ``--data-parallel`` N shards of the frame axis on the one card, as in
  cli/train_asr; several cards raise (slice 16).

Runs on the card unless ``--provider cpu``.

    python -m audio_classification_tpu_torch.cli.distill_asr --teacher-onnx sv.onnx \\
        --tokens tokens.txt --synthetic --steps 400 --export student_dir
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np

from .train_separator import check_parallel

SR = 16000


def parse_args(argv=None):
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    tch = p.add_argument_group("teacher")
    tch.add_argument("--teacher-onnx", required=True,
                     help="SenseVoice-shaped .onnx (sherpa export or "
                          "train_asr --export-onnx output)")
    tch.add_argument("--tokens", required=True,
                     help="tokens.txt matching the teacher's vocab")
    tch.add_argument("--cmvn", default="",
                     help="Teacher's am.mvn stats (applied in the shared "
                          "frontend)")
    tch.add_argument("--skip-frames", type=int, default=-1,
                     help="Leading teacher logit frames to drop "
                          "(-1: the sensevoice prompt count, 4)")
    d = p.add_argument_group("data (unlabeled)")
    d.add_argument("--manifest", default="",
                   help="wav list: one path per line, TSV first column, or "
                        "JSONL with a 'wav' field")
    d.add_argument("--synthetic", action="store_true",
                   help="Synthetic tone scenes (no corpus needed)")
    d.add_argument("--max-seconds", type=float, default=4.0)
    t = p.add_argument_group("training")
    t.add_argument("--steps", type=int, default=400)
    t.add_argument("--batch", type=int, default=16)
    t.add_argument("--lr", type=float, default=5e-4)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--log-every", type=int, default=100)
    t.add_argument("--kd-temp", type=float, default=2.0, help="KD temperature")
    t.add_argument("--ctc-weight", type=float, default=0.0,
                   help=">0: add CTC loss on the teacher's greedy labels")
    t.add_argument("--provider", default="cuda", help="cuda (default) or cpu")
    m = p.add_argument_group("student model")
    m.add_argument("--dim", type=int, default=96)
    m.add_argument("--heads", type=int, default=4)
    m.add_argument("--layers", type=int, default=2)
    m.add_argument("--conv-kernel", type=int, default=7)
    par = p.add_argument_group("parallelism")
    par.add_argument("--data-parallel", type=int, default=0,
                     help="With --seq-parallel: the number of frame shards on the card")
    par.add_argument("--model-parallel", type=int, default=0)
    par.add_argument("--slices", type=int, default=1)
    par.add_argument("--seq-parallel", action="store_true",
                     help="Shard the student's frame axis inside every attention block "
                          "(ring attention)")
    c = p.add_argument_group("checkpointing")
    c.add_argument("--ckpt-dir", default="")
    c.add_argument("--save-every", type=int, default=100)
    c.add_argument("--resume", action="store_true")
    c.add_argument("--export", default="",
                   help="Write the student's weights (serves via "
                        "--sense-voice <dir> when dims match the preset)")
    return p.parse_args(argv)


def read_wav_list(path: str):
    import json

    wavs = []
    for ln in Path(path).read_text(encoding="utf-8").splitlines():
        ln = ln.strip()
        if not ln:
            continue
        if ln.startswith("{"):
            wavs.append(json.loads(ln)["wav"])
        else:
            wavs.append(ln.split("\t", 1)[0])
    if not wavs:
        raise SystemExit(f"empty wav list: {path}")
    return wavs


class WavSampler:
    def __init__(self, wavs, t_max, rng):
        from ..train.data import WavCache

        self.wavs, self.t_max, self.rng = wavs, t_max, rng
        self._wav = WavCache()

    def batch(self, n):
        out = np.zeros((n, self.t_max), np.float32)
        lens = np.zeros(n, np.int32)
        for i in range(n):
            audio = self._wav(self.wavs[int(self.rng.integers(len(self.wavs)))])
            audio = audio[: self.t_max]
            out[i, : audio.size] = audio
            lens[i] = audio.size
        return out, lens


class SyntheticSampler:
    def __init__(self, t_max, rng):
        self.t_max, self.rng = t_max, rng

    def batch(self, n):
        from .train_asr import _ALPHABET, _speak

        out = np.zeros((n, self.t_max), np.float32)
        lens = np.zeros(n, np.int32)
        for i in range(n):
            w = "".join(self.rng.choice(list(_ALPHABET))
                        for _ in range(self.rng.integers(3, 9)))
            audio = _speak(self.rng, w)[: self.t_max]
            out[i, : audio.size] = audio
            lens[i] = audio.size
        return out, lens


def make_student(cfg, seed: int):
    """The student encoder with the port's seeded initialisation (the
    parity tests give it the JAX init instead)."""
    from ..models.asr.sensevoice import SenseVoiceEncoder
    from ..train.trainer import flax_init_

    return flax_init_(SenseVoiceEncoder(cfg), seed)


def main(argv=None):
    args = parse_args(argv)
    if not args.synthetic and not args.manifest:
        raise SystemExit("pick a data source: --manifest FILE or --synthetic")
    n_shards = check_parallel(args, "--seq-parallel", args.seq_parallel)

    import torch

    from ..convert.onnx_exec import OnnxModel
    from ..convert.onnx_stage import OnnxStage
    from ..engine.runtime import resolve_device
    from ..metrics import cer
    from ..models.asr.ctc import ctc_greedy_decode, ctc_loss
    from ..models.asr.sensevoice import SenseVoiceConfig, sensevoice_frontend
    from ..models.asr.tokens import TokenTable
    from ..parallel.mesh import make_mesh
    from ..train.checkpoint import save_params
    from ..train.data import write_run_manifest
    from ..train.trainer import ModuleTrainer

    device = resolve_device(args.provider)
    tokens = TokenTable.load(args.tokens)
    cfg = SenseVoiceConfig(vocab_size=tokens.vocab_size, dim=args.dim,
                           heads=args.heads, layers=args.layers,
                           conv_kernel=args.conv_kernel)
    skip = args.skip_frames if args.skip_frames >= 0 else cfg.num_prompt
    teacher = OnnxStage(OnnxModel(args.teacher_onnx, device=device), skip_frames=skip)
    t_params = teacher.model.params
    print(f"[distill_asr] teacher {args.teacher_onnx} "
          f"(skip_frames={skip}, vocab={tokens.vocab_size})")

    cmvn_mean = cmvn_istd = None
    if args.cmvn:
        from ..convert.assets import load_kaldi_cmvn

        shift, scale = load_kaldi_cmvn(args.cmvn)
        cmvn_mean, cmvn_istd = (torch.as_tensor(np.asarray(a, np.float32)).to(device)
                                for a in (shift, scale))

    def frontend(wav, lens):
        return sensevoice_frontend(wav, lens, cfg, cmvn_mean=cmvn_mean, cmvn_istd=cmvn_istd)

    rng = np.random.default_rng(args.seed)
    t_max = int(args.max_seconds * SR)
    if args.synthetic:
        sampler = SyntheticSampler(t_max, rng)
        val_sampler = SyntheticSampler(t_max, np.random.default_rng(123))
    else:
        wavs = read_wav_list(args.manifest)
        cut = max(len(wavs) - max(len(wavs) // 10, 1), 1)
        sampler = WavSampler(wavs[:cut], t_max, rng)
        val_sampler = WavSampler(wavs[cut:] or wavs[:1], t_max, np.random.default_rng(123))

    def to_dev(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    def teacher_fwd(wav, lens):
        """frontend + the whole teacher graph + greedy ids, no gradients."""
        with torch.inference_mode():
            feats, mask = frontend(wav, lens)
            logits = teacher(t_params, feats, mask)
            ids, id_lens = ctc_greedy_decode(logits, mask, tokens.blank_id)
        return logits.clone(), ids.clone(), id_lens.clone()

    # the JAX tool draws a 2-item batch to initialise the student: the data
    # stream keeps that draw
    sampler.batch(2)
    student = make_student(cfg, args.seed).to(device)
    sp_mesh = make_mesh(n_shards, devices=[device] * n_shards) if args.seq_parallel else None
    temp = float(args.kd_temp)

    def loss_fn(module, b):
        feats, mask = frontend(b["wav"], b["lens"])
        s_logits = module(feats, mask, mesh=sp_mesh)[:, cfg.num_prompt:]
        tp = torch.softmax(b["t_logits"] / temp, dim=-1)
        ls = torch.log_softmax(s_logits / temp, dim=-1)
        kl = torch.sum(tp * (torch.log(torch.clamp(tp, 1e-9, 1.0)) - ls), dim=-1)
        m = mask.to(kl.dtype)
        loss = temp * temp * torch.sum(kl * m) / torch.clamp_min(torch.sum(m), 1.0)
        if args.ctc_weight > 0:
            loss = loss + args.ctc_weight * ctc_loss(s_logits, m, b["labels"], b["lab_lens"],
                                                     blank_id=tokens.blank_id)
        return loss

    trainer = ModuleTrainer(student, loss_fn, lr=args.lr)

    start_step = 0
    if args.resume and args.ckpt_dir and Path(args.ckpt_dir).is_dir():
        start_step = trainer.restore(args.ckpt_dir)
        print(f"[distill_asr] resumed {args.ckpt_dir} at step {start_step}")

    def student_decode(wav, lens):
        with torch.no_grad():
            feats, mask = frontend(wav, lens)
            logits = student(feats, mask)[:, cfg.num_prompt:]
            return ctc_greedy_decode(logits, mask, tokens.blank_id)

    def agreement(n=16):
        """CER of the student's greedy decode vs the TEACHER's on held-out audio."""
        wav, lens = val_sampler.batch(n)
        wav_d, lens_d = to_dev(wav), to_dev(lens)
        _, t_ids, t_lens = teacher_fwd(wav_d, lens_d)
        s_ids, s_lens = student_decode(wav_d, lens_d)
        t_ids, t_lens = t_ids.cpu().numpy(), t_lens.cpu().numpy()
        s_ids, s_lens = s_ids.cpu().numpy(), s_lens.cpu().numpy()
        vals = []
        for i in range(n):
            ref = tokens.decode(t_ids[i][: int(t_lens[i])])
            hyp = tokens.decode(s_ids[i][: int(s_lens[i])])
            if ref:
                vals.append(cer(ref, hyp))
        return float(np.mean(vals)) if vals else float("nan")

    a0 = agreement()
    print(f"[distill_asr] teacher-agreement CER at step {start_step}: {a0:.3f}")
    t0 = time.time()
    max_label = 32
    losses = []
    for step in range(start_step + 1, args.steps + 1):
        wav, lens = sampler.batch(args.batch)
        wav_d, lens_d = to_dev(wav), to_dev(lens)
        t_logits, t_ids, t_lens = teacher_fwd(wav_d, lens_d)
        batch = {"wav": wav_d, "lens": lens_d, "t_logits": t_logits}
        if args.ctc_weight > 0:
            ids = t_ids.cpu().numpy()[:, :max_label]
            ll = np.minimum(t_lens.cpu().numpy(), max_label).astype(np.int32)
            labels = np.zeros((args.batch, max_label), np.int32)
            for i in range(args.batch):
                labels[i, : ll[i]] = ids[i, : ll[i]]
            batch["labels"] = labels
            batch["lab_lens"] = ll
        loss = trainer.train_step(batch)
        losses.append(loss)
        if step % args.log_every == 0 or step == start_step + 1:
            rate = (time.time() - t0) / max(step - start_step, 1) * 1000
            print(f"step {step:5d}  KD loss {loss:8.4f}  ({rate:.0f} ms/step)")
        if args.ckpt_dir and args.save_every and step % args.save_every == 0:
            trainer.save(args.ckpt_dir)
            print(f"[distill_asr] checkpoint @ step {step} -> {args.ckpt_dir}")
    if args.ckpt_dir and trainer.step > start_step:
        trainer.save(args.ckpt_dir)
    a1 = agreement()
    print(f"[distill_asr] teacher-agreement CER after: {a1:.3f}")

    if args.export:
        save_params(student, args.export, config=dataclasses.asdict(cfg))
        print(f"[distill_asr] exported student params -> {args.export} "
              f"(use --sense-voice {args.export}; vocab from --tokens)")
    for d in filter(None, {args.ckpt_dir, args.export}):
        write_run_manifest(d, args, {"agreement_before": a0, "agreement_after": a1,
                                     "losses": losses})
    return a0, a1


if __name__ == "__main__":
    main()
