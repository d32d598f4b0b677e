"""OSD distillation / training recipe (port of
audio_classification_tpu/cli/distill_osd.py): the path to reference-quality
OSD.

The reference's front gate is pyannote's PRETRAINED OverlappedSpeechDetection
(reference: src/osd/osd.py:64-70); OSDNet's quality comes from training, not
weight conversion. This tool is the recipe:

1. DISTILLATION TARGET -- one of
   - ``--teacher-ckpt``: a pyannote segmentation torch checkpoint run in the
     port as the teacher (models/pyannet.PyanNet via
     convert/torch_import.load_pyannet_torch), once a step over the batch,
     its probabilities resampled onto OSDNet's output grid, or
   - ``--teacher-npz``: frame overlap probabilities dumped from pyannote
     offline (the npz maps each mixture's file stem to a [T, 2] {speech,
     overlap} probability array and carries a ``__frame_sec__`` scalar;
     read for LibriMix crops, whose stems it names), or
   - energy ground truth derived from the mixture's true sources -- the
     evaluator's own GT definition (reference: evaluate_with_sources.py:
     221-235: a source is active when its frame RMS clears a ratio of its
     peak; overlap = >=2 active).
2. DATASET PLAN -- a local LibriMix tree (``--librimix-root``; train-360 for
   the real run) with random ``--dur`` crops, or ``--synthetic`` two-voice
   scenes for smoke tests.
3. QUALITY BAR -- held-out overlap F1 vs energy GT using the evaluator's
   exact mask math; ``--f1-target`` (default 0.90) fails the run (exit code
   1) when unmet.
4. OUTPUT -- ``--out`` is the port's params directory
   (train/checkpoint.save_params) with a run.json manifest, which every
   pipeline loads via ``--osd-checkpoint DIR``.

Runs on the card unless ``--provider cpu``. Under ``torchrun`` the step is
data-parallel over every rank of the world, one card each, as the JAX tool
runs over every device: the batch rounds up to a multiple of the world and
the frame BCE is the masked mean over the whole batch; rank 0 writes. ``--export-onnx FILE`` also
writes the distilled head as an ONNX graph (convert/onnx_export: fbank
feats of a ``--dur`` crop -> per-frame probs).
The batch stays ``--batch`` (the JAX tool rounds it up to a multiple of its
device count; the port trains on one device).

    python -m audio_classification_tpu_torch.cli.distill_osd --synthetic \\
        --steps 2000 --out osd_params [--teacher-ckpt seg.ckpt]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np


SR = 16000


def parse_args(argv=None):
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--librimix-root", default="", help="Local LibriMix tree (else --synthetic)")
    p.add_argument("--subset", default="train-360")
    p.add_argument("--num-speakers", type=int, default=2)
    p.add_argument("--max-files", type=int, default=0)
    p.add_argument("--synthetic", action="store_true",
                   help="Train on generated two-voice scenes (smoke/demo)")
    p.add_argument("--teacher-ckpt", default="",
                   help="pyannote segmentation torch checkpoint -- the teacher "
                        "runs in the port (PyanNet) on each batch")
    p.add_argument("--teacher-npz", default="",
                   help="pyannote probability dump (soft labels); else energy GT")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--dur", type=float, default=4.0, help="Crop length (s)")
    p.add_argument("--eval-files", type=int, default=10, help="Held-out scenes for the F1 bar")
    p.add_argument("--f1-target", type=float, default=0.90,
                   help="Quality bar: exit nonzero when held-out overlap F1 is below this")
    p.add_argument("--osd-thr", type=float, default=0.5)
    p.add_argument("--osd-win", type=float, default=0.5)
    p.add_argument("--osd-hop", type=float, default=0.1)
    p.add_argument("--activity-ratio", type=float, default=0.03,
                   help="Energy-GT activity threshold (ratio of peak RMS)")
    p.add_argument("--preset", default="full", choices=["full", "tiny"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True,
                   help="Output params directory (--osd-checkpoint input)")
    p.add_argument("--export-onnx", default="",
                   help="Also write the distilled OSD head as an ONNX file (fbank feats of a "
                        "--dur crop -> probs)")
    p.add_argument("--provider", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def make_scene(rng, dur: float) -> Tuple[np.ndarray, np.ndarray]:
    """Two harmonic voices; the second active only in an interior window."""
    t = int(dur * SR)
    tt = np.arange(t) / SR

    def voice(f0):
        return (0.25 * sum(np.sin(2 * np.pi * f0 * (h + 1) * tt + rng.uniform(0, 6.28)) / (h + 1)
                           for h in range(4))).astype(np.float32)

    s1 = voice(rng.uniform(100, 200))
    s2 = np.zeros(t, np.float32)
    a = rng.uniform(0.5, dur - 1.5)
    b = a + rng.uniform(0.8, min(1.8, dur - a - 0.1))
    s2[int(a * SR): int(b * SR)] = voice(rng.uniform(260, 500))[int(a * SR): int(b * SR)]
    return s1, s2


def energy_labels(sources: List[np.ndarray], centers: np.ndarray,
                  activity_ratio: float) -> np.ndarray:
    """[n_out, 2] {speech, overlap} targets from per-source frame activity
    (the evaluator's GT rule on OSDNet's output grid)."""
    from ..metrics.osd_metrics import frame_rms_np

    hop = float(centers[1] - centers[0]) if len(centers) > 1 else 0.04
    active = []
    for s in sources:
        rms = frame_rms_np(s, SR, win=max(hop, 0.025), hop=hop)
        thr = activity_ratio * max(float(rms.max()), 1e-6)
        a = rms > thr
        idx = np.clip((centers / hop).astype(int), 0, len(a) - 1)
        active.append(a[idx])
    active = np.stack(active)  # [n_src, n_out]
    labels = np.zeros((len(centers), 2), np.float32)
    labels[:, 0] = active.any(axis=0)
    labels[:, 1] = active.sum(axis=0) >= 2
    return labels


def teacher_labels(probs: np.ndarray, frame_sec: float, centers: np.ndarray) -> np.ndarray:
    """Linearly resample teacher [T, 2] probabilities onto OSDNet's grid."""
    t_teach = (np.arange(probs.shape[0]) + 0.5) * frame_sec
    out = np.stack([
        np.interp(centers, t_teach, probs[:, c]) for c in range(probs.shape[1])
    ], axis=-1)
    return out.astype(np.float32)


def make_trainer(cfg, lr: float, seed: int, device, mesh=None):
    """OSDNet (the port's flax-rule init from ``seed``) under frame BCE over
    the frames both the model's output and the labels have; data-parallel
    over ``mesh``'s data entries when one is given."""
    import torch

    from ..models.osd import OSDNet
    from ..train.losses import frame_bce_loss
    from ..train.trainer import ModuleTrainer, flax_init_

    def loss_fn(module, b):
        probs = module(b["feats"])
        n = min(probs.shape[1], b["labels"].shape[1])
        return frame_bce_loss(probs[:, :n], b["labels"][:, :n],
                              torch.ones(probs[:, :n].shape[:2], device=probs.device),
                              parts=True)

    return ModuleTrainer(flax_init_(OSDNet(cfg), seed), loss_fn, lr=lr, device=device,
                         mesh=mesh)


def main(argv=None) -> dict:
    args = parse_args(argv)

    import torch

    from ..data.librimix import LibriMixDataset
    from ..engine.runtime import EnginePreset, resolve_device, tiny_preset
    from ..engine.segments import flags_to_segments, segments_to_mask
    from ..metrics import build_gt_overlap_mask, compute_osd_metrics
    from ..models.osd import probs_to_hop_flags
    from ..ops.fbank import FbankConfig, log_mel_fbank
    from ..train.checkpoint import save_params
    from ..train.data import write_run_manifest

    from ..parallel.launch import is_writer, world_mesh

    device = resolve_device(args.provider)
    mesh = world_mesh(device)  # DP over every rank of the world, as JAX over every device
    device = mesh.device if mesh is not None else device
    preset = tiny_preset() if args.preset == "tiny" else EnginePreset()
    cfg = preset.osd
    fb = FbankConfig()
    rng = np.random.default_rng(args.seed)
    dur = args.dur

    def fbank_batch(wavs: np.ndarray) -> torch.Tensor:
        return log_mel_fbank(torch.from_numpy(np.asarray(wavs, np.float32)).to(device), fb)

    teacher = None
    teacher_frame_sec = 0.0
    if args.teacher_npz:
        teacher = dict(np.load(args.teacher_npz))
        teacher_frame_sec = float(teacher.pop("__frame_sec__"))
        print(f"teacher: {len(teacher)} utterances @ {teacher_frame_sec}s frames")

    pyannet_teacher = None
    if args.teacher_ckpt:
        # the real pyannote teacher, run in the port (models/pyannet) --
        # takes precedence over --teacher-npz
        from ..convert.torch_import import load_pyannet_torch
        from ..models.pyannet import PyanNet, reduce_overlap_channels

        pn_cfg, pn_sd = load_pyannet_torch(args.teacher_ckpt)
        pn = PyanNet(pn_cfg)
        pn.load_state_dict(pn_sd)
        pn = pn.to(device).eval()

        def pn_apply(w: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
            with torch.no_grad():
                return reduce_overlap_channels(pn(w, lengths))

        pyannet_teacher = (pn_cfg, pn_apply)
        print(f"teacher: PyanNet {args.teacher_ckpt} "
              f"@ {pn_cfg.out_frame_sec:.6f}s frames (in the port)")

    # ---- data plan
    ds = None
    if args.librimix_root and not args.synthetic:
        ds = LibriMixDataset(args.librimix_root, args.subset,
                             num_speakers=args.num_speakers, sample_rate=SR)
        limit = min(len(ds), args.max_files) if args.max_files else len(ds)
        print(f"LibriMix {args.subset}: {limit} mixtures")

    def draw_scene() -> Tuple[np.ndarray, List[np.ndarray], Optional[tuple]]:
        """-> (mix crop, source crops, teacher probs for the crop or None)."""
        if ds is None:
            s1, s2 = make_scene(rng, dur)
            return s1 + s2, [s1, s2], None
        i = int(rng.integers(0, limit))
        _sr, mix, sources = ds[i]
        t = int(dur * SR)
        off = int(rng.integers(0, max(len(mix) - t, 1)))
        crop = slice(off, off + t)
        probs = None
        if teacher is not None:
            stem = Path(ds.get_metadata(i)[1]).stem
            if stem in teacher:
                # full-utterance teacher probs + the crop's absolute start
                probs = (teacher[stem], off / SR)
        mix_c = np.zeros(t, np.float32)
        m = mix[crop]
        mix_c[: len(m)] = m
        srcs_c = []
        for s in sources or []:
            sc = np.zeros(t, np.float32)
            ss = s[crop]
            sc[: len(ss)] = ss
            srcs_c.append(sc)
        return mix_c, srcs_c, probs

    n_frames = fb.frames_for(int(dur * SR))
    n_out = int(np.ceil(n_frames / cfg.subsample))
    centers = (np.arange(n_out) + 0.5) * cfg.out_frame_sec

    def batch(n):
        wavs, labels = [], []
        for _ in range(n):
            mix, sources, probs = draw_scene()
            wavs.append(mix)
            if pyannet_teacher is not None:
                labels.append(None)  # filled by one batched teacher pass
            elif probs is not None:
                full, t0 = probs
                labels.append(teacher_labels(full, teacher_frame_sec,
                                             centers + t0)[:n_out])
            elif sources:
                labels.append(energy_labels(sources, centers,
                                            args.activity_ratio)[:n_out])
            else:
                raise ValueError("no labels: need sources (energy GT), "
                                 "--teacher-ckpt or --teacher-npz")
        wb = np.stack(wavs)
        if pyannet_teacher is not None:
            pn_cfg, pn_apply = pyannet_teacher
            w_dev = torch.from_numpy(wb).to(device)
            tprobs = pn_apply(w_dev, torch.full((len(wavs),), wb.shape[1], dtype=torch.int32,
                                                device=device)).float().cpu().numpy()
            nt = max(int(pn_cfg.out_frames(wb.shape[1])), 1)
            labels = [teacher_labels(tprobs[i, :nt], pn_cfg.out_frame_sec,
                                     centers)[:n_out] for i in range(len(wavs))]
        return {"feats": fbank_batch(wb), "labels": np.stack(labels)}

    batch(1)  # the JAX tool traces OSDNet's init on this draw: the same stream
    n_dev = 1 if mesh is None else mesh.shape["data"]
    bsz = -(-args.batch // n_dev) * n_dev  # even DP shards
    if bsz != args.batch:
        print(f"batch {args.batch} -> {bsz} (multiple of {n_dev} ranks)")
    trainer = make_trainer(cfg, args.lr, args.seed, device, mesh)
    model = trainer.model
    for step in range(1, args.steps + 1):
        loss = trainer.train_step(batch(bsz))
        if step == 1 or step % 100 == 0:
            print(f"step {step:5d}  frame BCE {float(loss):.4f}")

    # ---- quality bar: held-out overlap F1 with the evaluator's mask math
    stats = {"tp": 0, "fp": 0, "fn": 0}
    eval_rng = np.random.default_rng(args.seed + 1)
    for _ in range(args.eval_files):
        if ds is None:
            s1, s2 = make_scene(eval_rng, dur)
            mix, sources = s1 + s2, [s1, s2]
        else:
            i = int(eval_rng.integers(0, limit))
            _sr, mix, sources = ds[i]
            mix, sources = mix[: int(dur * SR)], [s[: int(dur * SR)] for s in sources or []]
        if not sources:
            continue
        f = fbank_batch(mix[None])
        with torch.no_grad():
            probs = model(f)[0].float().cpu().numpy()
        d = len(mix) / SR
        no = int(np.ceil(f.shape[1] / cfg.subsample))
        flags = probs_to_hop_flags(probs[:, 1], no, d, cfg.out_frame_sec,
                                   args.osd_thr, args.osd_win, args.osd_hop)
        pred = segments_to_mask(flags_to_segments(flags, d, args.osd_win, args.osd_hop),
                                d, args.osd_hop, args.osd_win)
        gt = build_gt_overlap_mask(sources, SR, args.osd_win, args.osd_hop,
                                   args.activity_ratio)
        n = min(len(gt), len(pred))
        stats["tp"] += int(np.sum(gt[:n] & pred[:n]))
        stats["fp"] += int(np.sum(~gt[:n] & pred[:n]))
        stats["fn"] += int(np.sum(gt[:n] & ~pred[:n]))
    tp, fp, fn = stats["tp"], stats["fp"], stats["fn"]
    m = compute_osd_metrics(
        np.concatenate([np.ones(tp + fn, bool), np.zeros(fp, bool)]),
        np.concatenate([np.ones(tp, bool), np.zeros(fn, bool), np.ones(fp, bool)]),
    )
    print(f"held-out OSD vs energy GT: precision={m['precision']} "
          f"recall={m['recall']} f1={m['f1']}")

    if not is_writer():  # a rank of the world: rank 0 writes
        return m
    save_params(model, args.out, config=dataclasses.asdict(cfg), preset=args.preset)
    print(f"saved OSD params: {args.out} (use --osd-checkpoint {args.out})")
    write_run_manifest(args.out, args, {"f1": m["f1"],
                                        "precision": m["precision"],
                                        "recall": m["recall"]})
    if args.export_onnx:
        from ..convert.from_jax import state_dict_to_variables
        from ..convert.onnx_export import export_osdnet

        frames = fb.frames_for(int(dur * SR))
        export_osdnet(state_dict_to_variables(model), cfg, args.export_onnx, frames=frames)
        print(f"exported ONNX: {args.export_onnx} "
              f"(feats [batch,{frames},{cfg.num_mel}] -> probs)")
    if m["f1"] is not None and m["f1"] < args.f1_target:
        print(f"QUALITY BAR FAILED: f1 {m['f1']} < target {args.f1_target}")
        sys.exit(1)
    return m


if __name__ == "__main__":
    main()
