"""Quality gate: train every stage in the port, run the flagship pipeline,
emit a quality artifact (port of
audio_classification_tpu/pipelines/quality_gate.py).

The reference's deliverable is correct speech output -- its run log records a
93.1% overlap-segment target hit rate and +13.54 dB PIT SI-SDRi
(reference: todo.md:4-11) -- so the port carries the same executable gate: a
synthetic world with real linguistic content and speaker identity, all four
stages trained on it by the port's trainers (3-src Conv-TasNet PIT,
OSD frame BCE, speaker AAM softmax, SenseVoice CTC), then the flagship
``Overlap3Pipeline`` end to end with REAL SV gating at a dev-calibrated
threshold. Metrics come out of the same accumulators the reference's
pipeline reports (overlap3_core.py:842-927).

The world:
- a speaker is an octave band (base 500*2^spk Hz);
- letters a-h are eighth-octave offsets within the speaker's band;
- an utterance voices a word as one 250 ms tone per letter.
Separation splits disjoint bands, speaker ID reads the band, ASR reads the
within-band offsets, OSD detects several active bands: every stage's task is
well-posed, so a healthy pipeline scores high and a fault in training,
conversion, gating or decoding drags a number down.

The contract with the JAX gate is its numpy random stream:
``train_world_pack`` draws from one ``np.random.default_rng(seed)`` across
the four stages in the JAX order, including the batches the JAX stages draw
only to trace their model's init (``osd_batch(1)``, ``spk_batch(2)``,
``asr_batch(2)``). From the same initial weights both packages then see the
same batches. Each stage's trainer comes from one module-level function
(``sep_stage_trainer`` ... ``asr_stage_trainer``), so a test can start it
from the JAX init; the port's own init (train/trainer.flax_init_) follows
flax's rules but not JAX's random numbers.

CER accounting: segments are cut on the OSD hop grid, not on letter
boundaries, so a whole-scene concatenation charges the recognizer for
boundary slivers it never saw. The primary ``cer_mean`` is therefore
PER-RECORD: each emitted text is scored against the letters of the target's
word whose 250 ms slots lie (>=50%) inside that record's span. The
whole-scene concatenation is still reported as ``cer_concat_mean``.

Gates (write_quality_json sets ``quality_ok``):
  target_hit_rate_segments >= 0.9   and   cer_mean <= 0.2
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

SR = 16000
ALPHABET = "abcdefgh"
TONE_MS = 250
N_SPK = 4


def say(rng, spk: int, word: str, gain=0.25) -> np.ndarray:
    """Speaker = octave band (base 500*2^spk Hz); letter = eighth-octave
    offset within the band (freq = base * 2^(idx/8), so bands stay
    disjoint)."""
    seg = int(SR * TONE_MS / 1000)
    base = 500.0 * (2 ** spk) * rng.uniform(0.995, 1.005)
    out = []
    for ch in word:
        f = base * (2 ** (ALPHABET.index(ch) / 8.0))
        t = np.arange(seg) / SR
        sig = np.sin(2 * np.pi * f * t + rng.uniform(0, 6.28))
        out.append(gain * sig)
    return np.concatenate(out).astype(np.float32)


def rand_word(rng, lo=3, hi=6) -> str:
    return "".join(rng.choice(list(ALPHABET)) for _ in range(rng.integers(lo, hi + 1)))


def span_truth(word: str, start: float, end: float, min_frac: float = 0.5) -> str:
    """Letters of ``word`` whose 250 ms slot overlaps [start, end) by at
    least ``min_frac`` of the slot -- the per-record transcript truth."""
    tone = TONE_MS / 1000.0
    out = []
    for i, ch in enumerate(word):
        a, b = i * tone, (i + 1) * tone
        if min(end, b) - max(start, a) >= min_frac * tone:
            out.append(ch)
    return "".join(out)


def world_configs() -> tuple:
    """The gate's stage configs -> (preset, tokens), shared by the training
    path and the checkpoint-restore path so a restored pack is
    shape-compatible with the one training saved."""
    from ..engine.runtime import EnginePreset
    from ..models.asr.paraformer import ParaformerConfig
    from ..models.asr.sensevoice import SenseVoiceConfig
    from ..models.asr.tokens import TokenTable
    from ..models.asr.transducer import TransducerConfig
    from ..models.asr.whisper_style import WhisperStyleConfig
    from ..models.convtasnet import ConvTasNetConfig
    from ..models.mossformer import MossFormerConfig
    from ..models.osd import OSDConfig
    from ..models.speaker import SpeakerEmbedderConfig
    from ..models.vad import VADConfig
    from ..ops.fbank import FbankConfig

    tokens = TokenTable.char_table(ALPHABET)
    sep_cfg = ConvTasNetConfig(n_src=3, enc_dim=128, enc_kernel=16, bottleneck=64,
                               hidden=128, n_blocks=4, n_repeats=2)
    osd_cfg = OSDConfig(dim=96, heads=4, layers=2)
    spk_cfg = SpeakerEmbedderConfig(channels=(16, 32, 64), embed_dim=64)
    # The recognizer's frontend is WIDENED for this world: spk0's letters sit
    # 44 Hz apart at a 500 Hz base, under the resolution of the 25 ms / 80-mel
    # default (its mel filters there are ~40-50 Hz wide). A 64 ms window and
    # 128 mels resolve every band (K1 runs at n_fft 1024 for it). num_mel
    # matches fbank.num_bins so the pack's init shapes follow the frontend.
    # utt_cmvn: the recognizer sits downstream of an SI-SDR-trained separator
    # whose output scale is arbitrary; per-utterance CMVN makes the frontend
    # scale-invariant.
    asr_cfg = SenseVoiceConfig(vocab_size=tokens.vocab_size, dim=96, heads=4,
                               layers=2, conv_kernel=7, num_mel=128,
                               utt_cmvn=True,
                               fbank=FbankConfig(frame_length_ms=64.0,
                                                 num_bins=128))
    preset = EnginePreset(
        name="demo", osd=osd_cfg, sep3=sep_cfg,
        sep2=ConvTasNetConfig(n_src=2, enc_dim=64, enc_kernel=16, bottleneck=32,
                              hidden=64, n_blocks=2, n_repeats=1),
        mossformer=MossFormerConfig(n_src=2, enc_dim=64, dim=48, qk_dim=32, layers=2),
        spk=spk_cfg, asr=asr_cfg,
        transducer=TransducerConfig(vocab_size=tokens.vocab_size, dim=32, heads=2,
                                    layers=1, pred_dim=32, joiner_dim=32, conv_kernel=3),
        paraformer=ParaformerConfig(vocab_size=tokens.vocab_size, dim=32, heads=2,
                                    enc_layers=1, dec_layers=1, conv_kernel=3, max_tokens=16),
        whisper=WhisperStyleConfig(vocab_size=tokens.vocab_size, dim=32, heads=2,
                                   enc_layers=1, dec_layers=1, max_decode_len=16),
        vad=VADConfig(dim=16, layers=2),
        # branch level restoration before branch ASR (pairs with utt_cmvn)
        asr_branch_norm="peak",
    )
    return preset, tokens


def _world_engine(pack):
    from ..engine import BucketSpec, StageEngine
    from ..engine.bucketing import default_buckets

    return StageEngine(pack, BucketSpec(lengths=default_buckets(SR, 0.5, 8.0), max_batch=8))


def build_world_engine(seed: int = 0, ckpt_dir: Optional[str] = None, device=None) -> tuple:
    """ModelPack + StageEngine over the world preset on ``device`` (default:
    the card) -> (engine, tokens). ``ckpt_dir`` (a model-pack directory of
    the port, written by train_world_pack) restores trained weights; an
    orbax directory raises with train/checkpoint.ORBAX_HINT. None gives the
    seeded init (plumbing tests)."""
    from ..engine import ModelPack

    preset, tokens = world_configs()
    pack = ModelPack(preset, seed=seed, tokens=tokens, device=device)
    if ckpt_dir is not None:
        from ..train.checkpoint import load_model_pack

        load_model_pack(pack, ckpt_dir)
    return _world_engine(pack), tokens


# --------------------------------------------------------------- trainers
# One function a stage, so a test can start a stage from the JAX init.


def sep_stage_trainer(cfg, seed: int, device, mesh=None):
    """The 3-source separator's PIT SI-SDR trainer (the dense TCN loop)."""
    from ..train.trainer import SeparatorTrainer

    return SeparatorTrainer(cfg, mesh=mesh, lr=5e-4, seed=seed, device=device)


def osd_stage_trainer(cfg, seed: int, device, mesh=None):
    """OSDNet under frame BCE on every frame."""
    from ..models.osd import OSDNet
    from ..train.losses import frame_bce_loss
    from ..train.trainer import ModuleTrainer, flax_init_

    def loss_fn(module, b):
        return frame_bce_loss(module(b["feats"]), b["labels"],
                              torch.ones(b["labels"].shape[:2], device=b["labels"].device),
                              parts=True)

    return ModuleTrainer(flax_init_(OSDNet(cfg), seed), loss_fn, lr=3e-4, device=device,
                         mesh=mesh)


def _statistics_as_parameters(module: torch.nn.Module) -> torch.nn.Module:
    """Every BatchNorm's running mean and variance become parameters: the
    JAX gate hands the embedder's whole variable tree, batch statistics
    included, to its trainer, so Adam (and the global-norm clip) train them
    by their gradient as weights. Their names in the state_dict stay."""
    for bn in module.modules():
        if isinstance(bn, torch.nn.BatchNorm2d):
            for name in ("running_mean", "running_var"):
                value = bn._buffers.pop(name)
                bn.register_parameter(name, torch.nn.Parameter(value.detach().clone()))
    return module


def spk_stage_trainer(cfg, seed: int, device, mesh=None):
    """The speaker embedder with its AAM head (margin 0.2, scale 30)."""
    from ..train.losses import aam_softmax_loss
    from ..train.trainer import ModuleTrainer, embedder_with_head, flax_init_

    def loss_fn(module, b):
        emb, w = module(b["feats"])
        return aam_softmax_loss(emb, b["labels"], w, margin=0.2, scale=30.0)

    module = _statistics_as_parameters(flax_init_(embedder_with_head(cfg, N_SPK), seed))
    return ModuleTrainer(module, loss_fn, lr=3e-4, device=device, mesh=mesh)


def asr_stage_trainer(cfg, tokens, steps: int, seed: int, device, mesh=None):
    """SenseVoice under CTC, warmup + cosine from a 1e-3 peak over
    ``steps`` updates."""
    from ..models.asr.ctc import ctc_loss
    from ..models.asr.sensevoice import SenseVoiceEncoder, sensevoice_frontend
    from ..train.trainer import ModuleTrainer, flax_init_, warmup_cosine

    def loss_fn(module, b):
        feats, mask = sensevoice_frontend(b["wav"], b["lens"], cfg)
        logits = module(feats, mask)[:, cfg.num_prompt:]
        return ctc_loss(logits, mask, b["labels"], b["lab_lens"], blank_id=tokens.blank_id)

    return ModuleTrainer(flax_init_(SenseVoiceEncoder(cfg), seed), loss_fn,
                         lr=warmup_cosine(1e-3, steps), device=device, mesh=mesh)


def train_world_pack(steps_scale: float = 1.0, seed: int = 0,
                     log=print, ckpt_dir: Optional[str] = None,
                     stages: tuple = ("sep", "osd", "spk", "asr"), device=None,
                     mesh=None) -> tuple:
    """Train the listed stages on the synthetic world -> (engine, tokens,
    stage losses dict). Step counts scale with ``steps_scale`` (1.0 is the
    full gate). ``ckpt_dir`` saves the trained pack (train/checkpoint
    .save_model_pack) and ``<ckpt_dir>.losses.json`` beside it, so eval-side
    work can iterate without retraining (restore via build_world_engine).
    ``stages`` trains a subset (untrained stages keep their seed init;
    without "sep" the ASR's separation-in-the-loop rows fall back to additive
    residue). Everything runs on ``device`` (default: the card). ``mesh``
    (a data-parallel mesh over a torchrun world, as the JAX gate's over every
    device) splits each stage's batches over its data entries; rank 0
    writes. Each stage logs its wall as "  <stage> wall <seconds> s"."""
    from ..engine import ModelPack
    from ..engine.runtime import resolve_device
    from ..ops.fbank import FbankConfig, log_mel_fbank

    device = resolve_device(device if mesh is None else mesh.device)
    # the stage factories take the mesh only when there is one (a test
    # starting a stage from the JAX init replaces them with their old form)
    on_mesh = {} if mesh is None else {"mesh": mesh}

    def n_steps(base: int) -> int:
        return max(1, int(round(base * steps_scale)))

    # the mesh's data axis (1 without a mesh: bs(n) = n). The gate's batches
    # (8, 16) are multiples of the JAX tests' 8 virtual devices too, so both
    # packages draw the same batch sizes.
    n_data = 1 if mesh is None else mesh.shape["data"]

    def bs(n: int) -> int:
        return max(n_data, -(-n // n_data) * n_data)

    fb = FbankConfig()

    def fbank_batch(wavs: np.ndarray) -> torch.Tensor:
        return log_mel_fbank(torch.from_numpy(np.asarray(wavs, np.float32)).to(device), fb)

    preset, tokens = world_configs()
    rng = np.random.default_rng(seed)
    losses: Dict[str, float] = {}
    t_start = time.time()

    sep_cfg = preset.sep3
    osd_cfg = preset.osd
    spk_cfg = preset.spk
    asr_cfg = preset.asr

    def stage_wall(name: str, t0: float) -> None:
        log(f"  {name} wall {time.time() - t0:.3f} s")

    # ------------------------------------------------------- 1. separator
    # Recipe (the JAX gate's r5): the eval scenes always have DISTINCT
    # speaker bands, sources that start / stop inside the segment, and often
    # only two audible sources -- train on that shape.
    t0 = time.time()
    sep_trainer = None
    t_len = SR
    if "sep" in stages:
        log("[1/4] training 3-src separator (PIT SI-SDR)")
        sep_trainer = sep_stage_trainer(sep_cfg, seed, device, **on_mesh)

    def sep_ref(spk: int, gain_scale: float = 1.0) -> np.ndarray:
        """One source track: a word at a random offset, silence elsewhere."""
        w = say(rng, spk, rand_word(rng, 2, 4)) * gain_scale
        ref = np.zeros(t_len, np.float32)
        off = int(rng.integers(0, max(t_len - min(w.size, t_len) + 1, 1)))
        n = min(w.size, t_len - off)
        ref[off:off + n] = w[:n]
        return ref

    for step in range(1, (n_steps(700) + 1) if sep_trainer else 0):
        b_sep = bs(8)
        refs = []
        for _ in range(b_sep):
            spks = rng.choice(N_SPK, 3, replace=False)
            # 25%: near-silent third source -- the 2-active-speaker scenes
            # the flagship pipeline actually feeds the separator
            g3 = 0.05 if rng.random() < 0.25 else 1.0
            refs.append(np.stack([sep_ref(int(spks[0])),
                                  sep_ref(int(spks[1])),
                                  sep_ref(int(spks[2]), g3)]))
        refs = np.stack(refs)
        loss = sep_trainer.train_step(refs.sum(1), refs,
                                      np.ones((b_sep, t_len), np.float32))
        if step % 200 == 0:
            log(f"  sep step {step} loss {loss:.2f}")
    if sep_trainer is not None:
        losses["sep_final_loss"] = float(loss)
        stage_wall("sep", t0)

    # ------------------------------------------------------------- 2. OSD
    t0 = time.time()
    if "osd" in stages:
        log("[2/4] training OSD (frame BCE)")
    dur = 3.0
    t3 = int(dur * SR)

    def osd_batch(n):
        # 30% SOLO scenes, distinct speaker bands, and a wider interferer
        # start / length range than the eval's fixed 0.9 s
        wavs = np.zeros((n, t3), np.float32)
        marks = []
        for i in range(n):
            spks = rng.choice(N_SPK, 2, replace=False)
            s1 = say(rng, int(spks[0]), rand_word(rng, 12, 12))[:t3]
            wavs[i, : s1.size] = s1
            if rng.random() < 0.3:
                marks.append((-1.0, -1.0))       # solo: overlap label all-0
                continue
            a = rng.uniform(0.2, 2.2)
            s2 = say(rng, int(spks[1]), rand_word(rng, 4, 8))
            ia = int(a * SR)
            ib = min(ia + s2.size, t3)
            wavs[i, ia:ib] += s2[: ib - ia]
            marks.append((a, ib / SR))
        feats = fbank_batch(wavs)
        n_out = int(np.ceil(feats.shape[1] / osd_cfg.subsample))
        centers = (np.arange(n_out) + 0.5) * osd_cfg.out_frame_sec
        labels = np.zeros((n, n_out, 2), np.float32)
        labels[:, :, 0] = 1.0
        for i, (a, b) in enumerate(marks):
            labels[i, :, 1] = (centers >= a) & (centers < b)
        return {"feats": feats, "labels": labels}

    osd_trainer = None
    if "osd" in stages:
        osd_batch(1)  # the JAX stage traces its init on this draw
        osd_trainer = osd_stage_trainer(osd_cfg, seed, device, **on_mesh)
        for step in range(1, n_steps(400) + 1):
            loss = osd_trainer.train_step(osd_batch(bs(8)))
            if step % 200 == 0:
                log(f"  osd step {step} bce {loss:.4f}")
        losses["osd_final_loss"] = float(loss)
        stage_wall("osd", t0)

    # --------------------------------------------------------- 3. speaker
    t0 = time.time()

    def spk_batch(n):
        labels = rng.integers(0, N_SPK, size=n)
        wavs = np.zeros((n, SR), np.float32)
        for i, s in enumerate(labels):
            u = say(rng, int(s), rand_word(rng, 4, 4))[:SR]
            wavs[i, : u.size] = u
        return {"feats": fbank_batch(wavs), "labels": labels}

    spk_trainer = None
    if "spk" in stages:
        log("[3/4] training speaker embedder (AAM)")
        spk_batch(2)  # the JAX stage traces its init on this draw
        spk_trainer = spk_stage_trainer(spk_cfg, seed, device, **on_mesh)
        for step in range(1, n_steps(300) + 1):
            loss = spk_trainer.train_step(spk_batch(bs(16)))
            if step % 150 == 0:
                log(f"  spk step {step} aam {loss:.4f}")
        losses["spk_final_loss"] = float(loss)
        stage_wall("spk", t0)

    # ------------------------------------------------------------- 4. ASR
    # The recognizer gets the deepest budget: the gate requires CER <= 0.2.
    # Recipe (the JAX gate's r5):
    #  - wide frontend and per-utterance CMVN (asr_cfg above);
    #  - warmup + cosine lr;
    #  - SUB-WORD WINDOWS: OSD segments start / end mid-word, so a third of
    #    the samples are segment-shaped crops labelled by span_truth's rule;
    #  - SEPARATION-IN-THE-LOOP: a third of the samples are the TRAINED
    #    separator's best branch on a fresh 2-speaker scene;
    #  - additive-residue + gain augmentation for the remainder.
    t0 = time.time()
    if "asr" in stages:
        log("[4/4] training SenseVoice-CTC")
    max_word, t_asr = 12, int(12 * SR * TONE_MS / 1000)
    tone_n = int(SR * TONE_MS / 1000)
    asr_steps = n_steps(2400)

    sep_model = sep_trainer.model if sep_trainer is not None else None

    def residue(audio, db):
        other = say(rng, int(rng.integers(N_SPK)), rand_word(rng, 12, 12))[: audio.size]
        if other.size < audio.size:
            other = np.pad(other, (0, audio.size - other.size))
        s = np.linalg.norm(audio) / (np.linalg.norm(other) + 1e-9) * (10 ** (-db / 20))
        return audio + s * other

    def asr_batch(n):
        wavs = np.zeros((n, t_asr), np.float32)
        lens = np.zeros(n, np.int32)
        labels = np.zeros((n, max_word), np.int32)
        lab_lens = np.zeros(n, np.int32)
        sep_scene = np.zeros((n, t_asr), np.float32)
        sep_tgt = np.zeros((n, t_asr), np.float32)
        sep_idx = []
        for i in range(n):
            w = rand_word(rng, 3, max_word)
            spks = rng.choice(N_SPK, 2, replace=False)
            audio = say(rng, int(spks[0]), w)
            if rng.random() < 0.35:
                # segment-shaped crop: cut mid-letter on both sides, keep
                # the >=50%-covered letters as the label (span_truth's rule)
                a = rng.uniform(0, 0.6 * tone_n / SR) + rng.integers(0, max(len(w) - 2, 1)) * (tone_n / SR)
                b = min(a + rng.uniform(1.5, 2.8), audio.size / SR)
                ia, ib = int(a * SR), int(b * SR)
                if ib - ia > tone_n:
                    w = span_truth(w, a, b)
                    audio = audio[ia:ib]
            if not w:
                w = "a"
                audio = say(rng, 0, w)
            if (sep_model is not None and rng.random() < 0.35
                    and audio.size >= 2 * tone_n and len(sep_idx) < 4):
                # separation-in-the-loop: the sample BECOMES the trained
                # separator's output on a 2-speaker scene (branch chosen by
                # correlation with the true source; batched forward below)
                intr = say(rng, int(spks[1]), rand_word(rng, 3, 8))
                off = int(rng.integers(0, max(audio.size - tone_n, 1)))
                nn_ = min(intr.size, audio.size - off)
                scene = audio.copy()
                scene[off:off + nn_] += intr[:nn_]
                sep_scene[i, : scene.size] = scene
                sep_tgt[i, : audio.size] = audio
                sep_idx.append(i)
            else:
                if rng.random() < 0.4:
                    audio = residue(audio, rng.uniform(8.0, 20.0))
                audio = audio * rng.uniform(0.3, 3.0)
                audio = audio + 0.01 * rng.standard_normal(audio.size).astype(np.float32)
                wavs[i, : audio.size] = audio
            lens[i] = audio.size
            ids = tokens.encode(w)
            labels[i, : len(ids)] = ids
            lab_lens[i] = len(ids)
        if sep_idx:
            # a FIXED 4-row sub-batch (zero-padded) through the trainer's
            # own model, no grad, float32
            rows = np.asarray(sep_idx)
            sub_scene = np.zeros((4, t_asr), np.float32)
            sub_m = np.zeros((4, t_asr), np.float32)
            sub_scene[: len(rows)] = sep_scene[rows]
            sub_m[: len(rows)] = (np.arange(t_asr)[None, :]
                                  < lens[rows, None]).astype(np.float32)
            with torch.no_grad():
                est_all = sep_model(torch.from_numpy(sub_scene).to(device),
                                    torch.from_numpy(sub_m).to(device)).float().cpu().numpy()
            m_all = np.zeros((n, t_asr), np.float32)
            m_all[rows] = sub_m[: len(rows)]
            est, tgt = est_all[: len(rows)], sep_tgt[rows]
            # oracle branch pick: highest correlation with the true source
            corr = np.abs(np.einsum("kst,kt->ks", est, tgt))
            best = np.argmax(corr, axis=1)
            br = est[np.arange(len(rows)), best]
            # level restoration exactly as the engine's asr_branch_norm
            peak = np.maximum(np.max(np.abs(br), axis=1, keepdims=True), 1e-6)
            wavs[rows] = br * (0.25 / peak) * m_all[rows]
        return dict(wav=wavs, lens=lens, labels=labels, lab_lens=lab_lens)

    asr_trainer = None
    if "asr" in stages:
        asr_batch(2)  # the JAX stage traces its init on this draw
        asr_trainer = asr_stage_trainer(asr_cfg, tokens, asr_steps, seed, device, **on_mesh)
        for step in range(1, asr_steps + 1):
            loss = asr_trainer.train_step(asr_batch(bs(16)))
            if step % 300 == 0:
                log(f"  asr step {step} ctc {loss:.3f}")
        losses["asr_final_loss"] = float(loss)
        stage_wall("asr", t0)

    # ------------------------------------------- assemble the model pack
    pack = ModelPack(preset, seed=seed, tokens=tokens, device=device)
    if sep_trainer is not None:
        pack.load_params("sep3", sep_trainer.model.state_dict())
    if osd_trainer is not None:
        pack.load_params("osd", osd_trainer.model.state_dict())
    if spk_trainer is not None:
        prefix = "embedder."
        pack.load_params("spk", {k[len(prefix):]: v.detach()
                                 for k, v in spk_trainer.model.state_dict().items()
                                 if k.startswith(prefix)})
    if asr_trainer is not None:
        pack.load_params("asr", asr_trainer.model.state_dict())
    from ..parallel.launch import is_writer

    if ckpt_dir is not None and is_writer():
        from ..train.checkpoint import save_model_pack

        save_model_pack(pack, ckpt_dir)
        losses["train_wall_sec"] = round(time.time() - t_start, 1)
        Path(f"{ckpt_dir}.losses.json").write_text(json.dumps(losses))
        log(f"saved world pack -> {ckpt_dir}")
    return _world_engine(pack), tokens, losses


def run_quality_gate(steps_scale: float = 1.0, n_scenes: int = 6,
                     seed: int = 0, eval_seed: int = 424242,
                     log=print, ckpt_dir: Optional[str] = None,
                     reuse_ckpt: bool = False, device=None, mesh=None) -> Dict:
    """Train the world pack, calibrate sv_threshold on dev scenes, run the
    flagship pipeline on held-out scenes -> metrics dict (the reference's
    field names + per-record CER, decomposed per layer: clean recognizer /
    oracle-separated spans / actual pipeline branches).

    ``ckpt_dir`` + ``reuse_ckpt`` skip the retrain when a saved world pack
    exists. Everything runs on ``device`` (default: the card); ``mesh``
    trains data-parallel (``train_world_pack``), and every rank then
    evaluates the same scenes."""
    import tempfile

    from ..audio_io import write_wav
    from ..metrics import cer
    from ..utils.config import Overlap3Config
    from .offline_overlap3 import Overlap3Pipeline

    t0 = time.time()
    restored = reuse_ckpt and ckpt_dir is not None and Path(ckpt_dir).exists()
    if restored:
        log(f"restoring world pack from {ckpt_dir} (skipping training)")
        engine, tokens = build_world_engine(seed, ckpt_dir, device=device)
        lp = Path(f"{ckpt_dir}.losses.json")
        losses = json.loads(lp.read_text()) if lp.exists() else {}
    else:
        engine, tokens, losses = train_world_pack(steps_scale, seed, log=log,
                                                  ckpt_dir=ckpt_dir, device=device, mesh=mesh)
    t_train = time.time() - t0

    # ------------------------------ calibrate sv_threshold on dev scenes
    # (pick the operating point from a small dev set; the reference
    # hard-codes 0.6 for its particular checkpoint)
    eval_rng = np.random.default_rng(eval_seed)
    target_spk = 0
    enroll_wav = say(eval_rng, target_spk, rand_word(eval_rng, 6, 6))
    enroll_vec = engine.embed([enroll_wav])[0]
    tgt_scores, other_scores = [], []
    for _ in range(3):
        w_t = rand_word(eval_rng, 6, 6)
        tgt = say(eval_rng, target_spk, w_t)
        intr = say(eval_rng, int(eval_rng.integers(1, N_SPK)), rand_word(eval_rng, 6, 6))
        n = min(tgt.size, intr.size)
        rec = engine.process_overlap([tgt[:n] + intr[:n]], [enroll_vec])[0]
        s = sorted(np.asarray(rec["scores"]), reverse=True)
        tgt_scores.append(s[0])
        other_scores.append(s[1])
    sv_thr = float((np.mean(tgt_scores) + np.mean(other_scores)) / 2)
    log(f"calibrated sv_threshold={sv_thr:.3f} "
        f"(target-branch {np.mean(tgt_scores):.3f}, "
        f"best-other {np.mean(other_scores):.3f})")

    dur = 3.0
    t3 = int(dur * SR)
    with tempfile.TemporaryDirectory() as td:
        tdp = Path(td)
        paths, truths, ref_rows = [], {}, []
        tgt_refs: Dict[str, np.ndarray] = {}   # oracle target source per scene
        for i in range(n_scenes):
            w_t = rand_word(eval_rng, 6, 6) + rand_word(eval_rng, 6, 6)
            tgt = say(eval_rng, target_spk, w_t)[:t3]
            scene = np.zeros(t3, np.float32)
            scene[: tgt.size] += tgt
            intr_spk = int(eval_rng.integers(1, N_SPK))
            w_i = rand_word(eval_rng, 5, 5)
            intr = say(eval_rng, intr_spk, w_i)
            a = int(0.9 * SR)
            b = min(a + intr.size, t3)
            intr_full = np.zeros(t3, np.float32)
            intr_full[a:b] = intr[: b - a]
            scene += intr_full
            mp = tdp / f"scene_{i}.wav"
            write_wav(mp, scene, SR)
            paths.append(str(mp))
            truths[str(mp)] = w_t
            r1 = tdp / f"tref_{i}.wav"
            r2 = tdp / f"iref_{i}.wav"
            tgt_full = np.zeros(t3, np.float32)
            tgt_full[: tgt.size] = tgt
            tgt_refs[str(mp)] = tgt_full
            write_wav(r1, tgt_full, SR)
            write_wav(r2, intr_full, SR)
            ref_rows.append(f"{mp},{r1},{r2}")
        (tdp / "refs.csv").write_text("mix,ref1,ref2\n" + "\n".join(ref_rows))
        write_wav(tdp / "target.wav", enroll_wav, SR)

        cfg = Overlap3Config(
            input_wavs=paths, target_wav=str(tdp / "target.wav"),
            refs_csv=str(tdp / "refs.csv"),
            sv_threshold=sv_thr,       # REAL gating at the calibrated point
            osd_thr=0.5, min_overlap_dur=0.3, max_segment_sec=8.0,
            eval_separation=True, seed=seed, preset="tiny",
        )
        t1 = time.time()
        result = Overlap3Pipeline(cfg, engine=engine).run()
        t_pipe = time.time() - t1
        # warm re-run: the first pass pays the kernels' first build or load,
        # cuDNN's autotuning and the first allocations of every (bucket,
        # batch) shape this world produces. The artifact reports BOTH walls.
        t2 = time.time()
        result_warm = Overlap3Pipeline(cfg, engine=engine).run()
        t_pipe_warm = time.time() - t2
        result = result_warm       # steady-state timings; records identical

        m = dict(result.metrics)
        # ---- CER decomposition: pin the failing layer by data ----
        # Diagnostic crops carry a -46 dB dither: every training sample has
        # a noise floor, so PRISTINE digital tones are out of distribution
        # for the recognizer. The dither makes (a) / (b) measure the
        # recognizer, not that gap.
        dit = np.random.default_rng(1234)

        def dither(x):
            return x + 0.005 * dit.standard_normal(x.size).astype(np.float32)

        # (a) clean recognizer: the oracle target source, whole scene
        clean_hyps = engine.transcribe([dither(tgt_refs[p]) for p in paths])
        clean_cers = [cer(truths[p], h) for p, h in zip(paths, clean_hyps)]
        # per-record CER: emitted text vs the letters the target actually
        # voiced (>=50% of the slot) inside the record's span
        span_cers: List[float] = []
        by_wav: Dict[str, List[str]] = {}
        recs = sorted(result.segments, key=lambda r: (r["wav"], r["start"]))
        # (b) oracle separation: the target SOURCE cut on the pipeline's own
        # spans -- isolates span algebra + recognizer from separator residue
        oracle_crops, oracle_truths = [], []
        for rec in recs:
            ia, ib = int(rec["start"] * SR), int(rec["end"] * SR)
            oracle_crops.append(dither(tgt_refs[rec["wav"]][ia:ib]))
            oracle_truths.append(span_truth(truths[rec["wav"]], rec["start"], rec["end"]))
        oracle_hyps = engine.transcribe(oracle_crops) if oracle_crops else []
        oracle_cers = [cer(t, h) for t, h in zip(oracle_truths, oracle_hyps) if t]
        # (c) the actual pipeline branches
        for rec, o_hyp in zip(recs, oracle_hyps):
            truth = span_truth(truths[rec["wav"]], rec["start"], rec["end"])
            if truth:
                span_cers.append(cer(truth, rec["text"]))
            by_wav.setdefault(rec["wav"], []).append(rec["text"])
            log(f"  rec {Path(rec['wav']).name} [{rec['start']:.2f},{rec['end']:.2f}] "
                f"kind={'ovl' if rec.get('is_overlap') else 'clean'} "
                f"truth={truth!r} hyp={rec['text']!r} oracle_hyp={o_hyp!r}")
        concat_cers = [cer(truths[w], "".join(ts)) for w, ts in by_wav.items()]

    m.update({
        "cer_mean": round(float(np.mean(span_cers)), 4) if span_cers else None,
        "cer_records": len(span_cers),
        "cer_concat_mean": round(float(np.mean(concat_cers)), 4) if concat_cers else None,
        "cer_clean_mean": round(float(np.mean(clean_cers)), 4) if clean_cers else None,
        "cer_oracle_sep_mean": round(float(np.mean(oracle_cers)), 4) if oracle_cers else None,
        "sv_threshold_calibrated": round(sv_thr, 4),
        "n_scenes": n_scenes,
        "steps_scale": steps_scale,
        # restored runs: train_wall_sec is the RESTORE time; the training
        # wall lives with the run that wrote the checkpoint
        "restored_from_ckpt": bool(restored),
        "train_wall_sec": round(t_train, 1),
        "pipeline_wall_sec": round(t_pipe_warm, 1),
        "pipeline_wall_cold_sec": round(t_pipe, 1),
        "pipeline_wall_note": (
            "cold wall includes the CUDA kernels' first build or load, cuDNN "
            "autotuning and first allocations per shape; metrics/rtf come from "
            "the warm pass (records are deterministic and identical)"),
        **{k: round(v, 4) for k, v in losses.items()},
    })
    log("\n==== quality gate metrics ====")
    log(f"target_hit_rate_segments={m['target_hit_rate_segments']}")
    log(f"sep_sisdr_mean={m['sep_sisdr_mean']} sep_sisdri_mean={m['sep_sisdri_mean']}")
    log(f"cer_mean={m['cer_mean']} (per-record, {m['cer_records']} records) "
        f"cer_concat_mean={m['cer_concat_mean']}")
    log(f"decomposition: clean={m['cer_clean_mean']} "
        f"oracle_sep={m['cer_oracle_sep_mean']} pipeline={m['cer_mean']}")
    return m


def write_quality_json(m: Dict, out_path: str, hit_gate: float = 0.9,
                       cer_gate: float = 0.2, device=None) -> Dict:
    """Evaluate the gates, stamp the artifact with the device the gate ran
    on (``device``, default the card: ``backend`` "cuda" or "cpu",
    ``device`` the card's name), write JSON -> artifact."""
    from ..engine.runtime import resolve_device

    dev = resolve_device(device)
    hit = m.get("target_hit_rate_segments")
    c = m.get("cer_mean")
    artifact = {
        "kind": "quality_gate",
        "world": "synthetic octave-band speakers / eighth-octave letters",
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "gates": {"target_hit_rate_segments": f">={hit_gate}",
                  "cer_mean": f"<={cer_gate}"},
        "quality_ok": bool(hit is not None and hit >= hit_gate
                           and c is not None and c <= cer_gate),
        # Why the gate world widens the ASR frontend while the serving preset
        # keeps the 25 ms / 80-mel default: this world's spk0 letters sit
        # 44 Hz apart at a 500 Hz base. The figures are the reference's
        # measurement (its round-4 per-speaker clean-CER sweep), carried as
        # it recorded them; real speech formants are hundreds of Hz apart,
        # which the default frontend resolves.
        "frontend_evidence": {
            "default_25ms_80mel_clean_cer_by_spk": [0.97, 0.72, 0.05, 0.05],
            "wide_64ms_128mel_clean_cer_by_spk": [0.04, 0.02, 0.0, 0.0],
            "measured_in": ("the JAX reference's round-4 _diag_asr per-speaker clean-CER "
                            "sweep (not measured by the port)"),
        },
        **m,
    }
    Path(out_path).write_text(json.dumps(artifact, indent=1))
    return artifact
