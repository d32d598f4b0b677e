"""Train the SenseVoice-style CTC recognizer with resume (port of
audio_classification_tpu/cli/train_asr.py).

- data: a manifest of ``{"wav": ..., "text": ...}`` JSONL lines (or
  ``wav<TAB>text``), resampled to 16 kHz, or ``--synthetic`` tone-language
  scenes;
- vocab: ``--tokens tokens.txt`` (single-character symbols) or a char vocab
  built from the manifest's texts; ``--cmvn am.mvn`` normalises the LFR
  features as at serving;
- ``--seq-parallel``: every attention block ring-parallel over
  ``--data-parallel`` N shards of the frame axis on the one card
  (parallel/sp_encoder; K5 in the ring once a shard block has 512 frames);
- checkpoint / resume (``--ckpt-dir``, ``--resume``) and ``--export DIR``,
  which serving loads by ``--sense-voice DIR`` (the vocab must match
  ``--tokens``, the dims the serving preset's).

The gate: CER before and after through the pipelines' greedy CTC decode and
token table. ``--init-onnx FILE`` fine-tunes the weights of a SenseVoice
ONNX graph mapped onto the ``--preset``'s asr dims (convert/onnx_graph_map);
``--export-onnx FILE`` writes the trained encoder as an ONNX graph
(``--export-quant int8`` the dynamic-int8 form; the frames of the
``--max-seconds`` batch are baked in). Several cards raise (slice 16).

    python -m audio_classification_tpu_torch.cli.train_asr --synthetic --steps 400 \\
        --export asr_dir [--provider cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np

from .train_separator import check_parallel

SR = 16000
_ALPHABET = "abcdefgh"
_TONE_MS = 150


def parse_args(argv=None):
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    d = p.add_argument_group("data")
    d.add_argument("--manifest", default="",
                   help="JSONL {wav,text} or TSV wav<TAB>text training list")
    d.add_argument("--val-manifest", default="",
                   help="Held-out list for CER (default: tail of --manifest)")
    d.add_argument("--synthetic", action="store_true", help="Tone-language smoke")
    d.add_argument("--max-seconds", type=float, default=4.0,
                   help="Pad / crop every utterance to this length")
    v = p.add_argument_group("vocab")
    v.add_argument("--tokens", default="",
                   help="tokens.txt (single-char symbols); default: char vocab built from "
                        "the manifest texts")
    t = p.add_argument_group("training")
    t.add_argument("--steps", type=int, default=400)
    t.add_argument("--batch", type=int, default=16, help="Batch per step")
    t.add_argument("--lr", type=float, default=5e-4)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--log-every", type=int, default=100)
    t.add_argument("--provider", default="cuda", help="cuda (default) or cpu")
    m = p.add_argument_group("model")
    m.add_argument("--dim", type=int, default=96)
    m.add_argument("--heads", type=int, default=4)
    m.add_argument("--layers", type=int, default=2)
    m.add_argument("--conv-kernel", type=int, default=7,
                   help="Depthwise conv kernel (match the serving preset's asr config when "
                        "exporting: full=11, tiny=3)")
    m.add_argument("--init-onnx", default="",
                   help="Fine-tune from a SenseVoice .onnx graph (mapped onto the --preset's "
                        "asr dims; --dim / --heads / --layers are then ignored)")
    m.add_argument("--cmvn", default="",
                   help="Kaldi am.mvn stats applied in the frontend (match serving's --cmvn)")
    m.add_argument("--preset", default="full", choices=["full", "tiny"],
                   help="Which preset's asr dims --init-onnx maps onto")
    par = p.add_argument_group("parallelism")
    par.add_argument("--data-parallel", type=int, default=0,
                     help="With --seq-parallel: the number of frame shards on the card")
    par.add_argument("--model-parallel", type=int, default=0)
    par.add_argument("--slices", type=int, default=1)
    par.add_argument("--seq-parallel", action="store_true",
                     help="Shard the frame axis inside every attention block (ring "
                          "attention; gradients flow through the ring)")
    c = p.add_argument_group("checkpointing")
    c.add_argument("--ckpt-dir", default="")
    c.add_argument("--save-every", type=int, default=100)
    c.add_argument("--resume", action="store_true")
    c.add_argument("--export", default="",
                   help="Write the trained weights (serves via --sense-voice <dir>)")
    c.add_argument("--export-onnx", default="",
                   help="Also write the trained encoder as an ONNX file (feats + language "
                        "-> logits)")
    c.add_argument("--export-quant", default="none", choices=["none", "int8"],
                   help="Quantisation of --export-onnx")
    return p.parse_args(argv)


def _speak(rng, word: str) -> np.ndarray:
    seg = int(SR * _TONE_MS / 1000)
    out = []
    for ch in word:
        f = 300.0 * (2 ** (_ALPHABET.index(ch) / 4.0))
        tt = np.arange(seg) / SR
        out.append(0.25 * np.sin(2 * np.pi * f * tt).astype(np.float32))
    return np.concatenate(out)


def read_manifest(path: str):
    """-> [(wav_path, text)]; JSONL {wav,text} or TSV wav<TAB>text."""
    from ..train.data import read_manifest as _rm

    return _rm(path, "text")


class ManifestSampler:
    """Random (padded wav, label ids) batches from a manifest, with a
    bounded decode cache so repeated epochs skip re-decoding."""

    def __init__(self, items, tokens, t_max, rng):
        from ..train.data import WavCache

        self.items, self.tokens, self.t_max, self.rng = items, tokens, t_max, rng
        self.max_label = max((len(tokens.encode(txt)) for _, txt in items), default=1) or 1
        self._wav = WavCache()

    def batch(self, n):
        wavs = np.zeros((n, self.t_max), np.float32)
        lens = np.zeros(n, np.int32)
        labels = np.zeros((n, self.max_label), np.int32)
        lab_lens = np.zeros(n, np.int32)
        texts = []
        for i in range(n):
            path, text = self.items[int(self.rng.integers(len(self.items)))]
            audio = self._wav(path)[: self.t_max]
            wavs[i, : audio.size] = audio
            lens[i] = audio.size
            ids = self.tokens.encode(text)[: self.max_label]
            labels[i, : len(ids)] = ids
            lab_lens[i] = len(ids)
            texts.append(text)
        return dict(wav=wavs, lens=lens, labels=labels, lab_lens=lab_lens), texts


class SyntheticSampler:
    def __init__(self, tokens, rng):
        self.tokens, self.rng = tokens, rng
        self.t_max = int(8 * SR * _TONE_MS / 1000)
        self.max_label = 8

    def batch(self, n):
        wavs = np.zeros((n, self.t_max), np.float32)
        lens = np.zeros(n, np.int32)
        labels = np.zeros((n, self.max_label), np.int32)
        lab_lens = np.zeros(n, np.int32)
        texts = []
        for i in range(n):
            w = "".join(self.rng.choice(list(_ALPHABET))
                        for _ in range(self.rng.integers(3, self.max_label + 1)))
            audio = _speak(self.rng, w)
            wavs[i, : audio.size] = audio
            lens[i] = audio.size
            ids = self.tokens.encode(w)
            labels[i, : len(ids)] = ids
            lab_lens[i] = len(ids)
            texts.append(w)
        return dict(wav=wavs, lens=lens, labels=labels, lab_lens=lab_lens), texts


def main(argv=None):
    args = parse_args(argv)
    if not args.synthetic and not args.manifest:
        raise SystemExit("pick a data source: --manifest FILE or --synthetic")
    n_shards = check_parallel(args, "--seq-parallel", args.seq_parallel)

    import torch

    from ..convert.assets import load_kaldi_cmvn
    from ..engine.runtime import resolve_device
    from ..metrics import cer
    from ..models.asr.ctc import ctc_greedy_decode, ctc_loss
    from ..models.asr.sensevoice import SenseVoiceConfig, SenseVoiceEncoder, sensevoice_frontend
    from ..models.asr.tokens import TokenTable
    from ..parallel.mesh import make_mesh
    from ..train.checkpoint import save_params
    from ..train.data import write_run_manifest
    from ..train.trainer import ModuleTrainer, flax_init_

    device = resolve_device(args.provider)
    rng = np.random.default_rng(args.seed)
    if args.synthetic:
        tokens = TokenTable.char_table(_ALPHABET)
        sampler = SyntheticSampler(tokens, rng)
        val_sampler = SyntheticSampler(tokens, np.random.default_rng(123))
    else:
        items = read_manifest(args.manifest)
        if args.tokens:
            tokens = TokenTable.load(args.tokens)
        else:
            tokens = TokenTable.char_table("".join(sorted({ch for _, txt in items for ch in txt})))
        if args.val_manifest:
            val_items = read_manifest(args.val_manifest)
        else:  # hold out the manifest tail
            cut = max(len(items) - max(len(items) // 10, 1), 1)
            items, val_items = items[:cut], items[cut:]
        t_max = int(args.max_seconds * SR)
        sampler = ManifestSampler(items, tokens, t_max, rng)
        val_sampler = ManifestSampler(val_items, tokens, t_max, np.random.default_rng(123))

    if args.init_onnx:
        from ..convert.onnx_graph_map import import_onnx_state_dict
        from ..engine.runtime import EnginePreset, tiny_preset

        base = tiny_preset() if args.preset == "tiny" else EnginePreset()
        cfg = dataclasses.replace(base.asr, vocab_size=tokens.vocab_size)
        model = SenseVoiceEncoder(cfg)
        model.load_state_dict(import_onnx_state_dict(args.init_onnx, "sensevoice", cfg))
        model = model.to(device)
        print(f"[train_asr] fine-tuning mapped weights from {args.init_onnx}")
    else:
        cfg = SenseVoiceConfig(vocab_size=tokens.vocab_size, dim=args.dim, heads=args.heads,
                               layers=args.layers, conv_kernel=args.conv_kernel)
        model = flax_init_(SenseVoiceEncoder(cfg), args.seed).to(device)

    cmvn_mean = cmvn_istd = None
    if args.cmvn:
        shift, scale = load_kaldi_cmvn(args.cmvn)
        cmvn_mean, cmvn_istd = (torch.as_tensor(np.asarray(a, np.float32)).to(device)
                                for a in (shift, scale))
        print(f"[train_asr] CMVN stats from {args.cmvn} (dim {cmvn_mean.shape[-1]})")

    def frontend(wav, lens):
        return sensevoice_frontend(wav, lens, cfg, cmvn_mean=cmvn_mean, cmvn_istd=cmvn_istd)

    sp_mesh = make_mesh(n_shards, devices=[device] * n_shards) if args.seq_parallel else None

    def loss_fn(module, b):
        feats, mask = frontend(b["wav"], b["lens"])
        logits = module(feats, mask, mesh=sp_mesh)[:, cfg.num_prompt:]
        return ctc_loss(logits, mask, b["labels"], b["lab_lens"], blank_id=tokens.blank_id)

    trainer = ModuleTrainer(model, loss_fn, lr=args.lr)

    start_step = 0
    if args.resume and args.ckpt_dir and Path(args.ckpt_dir).is_dir():
        start_step = trainer.restore(args.ckpt_dir)
        print(f"[train_asr] resumed {args.ckpt_dir} at step {start_step}")

    def eval_cer(n=24):
        b, texts = val_sampler.batch(n)
        with torch.no_grad():
            feats, mask = frontend(torch.from_numpy(b["wav"]).to(device),
                                   torch.from_numpy(b["lens"]).to(device))
            logits = model(feats, mask)[:, cfg.num_prompt:]
            ids, lens_out = (x.cpu().numpy() for x in ctc_greedy_decode(logits, mask,
                                                                          tokens.blank_id))
        hyps = [tokens.decode(ids[i][: int(lens_out[i])]) for i in range(n)]
        pairs = list(zip(texts, hyps))
        return float(np.mean([cer(r, h) for r, h in pairs])), pairs[0]

    c0, (r0, h0) = eval_cer()
    print(f"[train_asr] CER at step {start_step}: {c0:.3f}  (e.g. ref='{r0}' hyp='{h0}')")
    losses = []
    t0 = time.time()
    for step in range(start_step + 1, args.steps + 1):
        b, _ = sampler.batch(args.batch)
        loss = trainer.train_step(b)
        losses.append(loss)
        if step % args.log_every == 0 or step == start_step + 1:
            rate = (time.time() - t0) / max(step - start_step, 1) * 1000
            print(f"step {step:5d}  CTC loss {loss:8.3f}  ({rate:.0f} ms/step)")
        if args.ckpt_dir and args.save_every and step % args.save_every == 0:
            trainer.save(args.ckpt_dir)
            print(f"[train_asr] checkpoint @ step {step} -> {args.ckpt_dir}")
    if args.ckpt_dir and trainer.step > start_step:
        trainer.save(args.ckpt_dir)
    c1, (r1, h1) = eval_cer()
    print(f"[train_asr] CER after: {c1:.3f}  (e.g. ref='{r1}' hyp='{h1}')")

    if args.export:
        save_params(model, args.export, config=dataclasses.asdict(cfg))
        print(f"[train_asr] exported serving params -> {args.export} "
              f"(use --sense-voice {args.export}; vocab must match --tokens)")
    if args.export_onnx:
        from ..convert.from_jax import state_dict_to_variables
        from ..convert.onnx_export import export_sensevoice

        t_len = sampler.t_max  # every batch is padded to it
        with torch.no_grad():
            frames = int(frontend(torch.zeros((1, t_len), device=device),
                                  torch.full((1,), t_len, device=device))[0].shape[1])
        export_sensevoice(state_dict_to_variables(model), cfg, args.export_onnx,
                          frames=frames, quant=args.export_quant)
        q = f", {args.export_quant}" if args.export_quant != "none" else ""
        print(f"[train_asr] exported ONNX -> {args.export_onnx} "
              f"(feats [batch,{frames},{cfg.lfr_m * cfg.num_mel}] + "
              f"language [1] -> logits{q})")
    for d in filter(None, {args.ckpt_dir, args.export}):
        write_run_manifest(d, args, {"cer_before": c0, "cer_after": c1, "losses": losses})
    return c0, c1


if __name__ == "__main__":
    main()
