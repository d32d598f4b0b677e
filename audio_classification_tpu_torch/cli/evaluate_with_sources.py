"""Source-reference evaluator: OSD quality + separation SI-SDR (+ ASR)
(port of audio_classification_tpu/cli/evaluate_with_sources.py).

Reimplements the reference evaluator (reference:
scripts/osd/evaluate_with_sources.py:85-1046) against a local Libri2Mix/
Libri3Mix root: per mixture it scores predicted OSD segments against an
energy-based GT overlap mask (>=2 sources active above peak*activity_thr),
runs separation on predicted overlap segments for PIT SI-SDR/SI-SDRi
(K=2 with swapped flag / K=3), and optionally a pseudo-reference ASR
comparison (overlap mixture vs separated vs clean WER/CER).

Writes evaluation.json with the same structure/field names (:961-1033) and
optional overlap_details.csv (:659-677).
"""
from __future__ import annotations

import argparse
import csv
import json
import math
import time
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from ..data.librimix import LibriMixDataset
from ..engine.runtime import G_SAMPLE_RATE
from ..metrics import (
    build_gt_overlap_mask,
    cer,
    frame_rms_np,
    sdr_improvement_pit,
    sdr_improvement_pit_2,
    wer,
)
from ..engine.segments import masks_to_segments, segments_to_mask
from ..pipelines.offline_overlap3 import build_engine
from ..runtime.monitor import CPUMonitor


def _log(msg: str):
    print(f"[eval] {msg}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--max-files", type=int, default=0, help="Limit number of mixtures (0=all)")
    p.add_argument("--osd-backend", default="osdnet")
    p.add_argument("--osd-thr", type=float, default=0.5)
    p.add_argument("--osd-win", type=float, default=0.5)
    p.add_argument("--osd-hop", type=float, default=0.1)
    p.add_argument("--sep-backend", default="convtasnet")
    p.add_argument("--sep-checkpoint", default="")
    p.add_argument("--osd-checkpoint", default="", help="OSD weights: orbax dir (cli/distill_osd) or pyannote segmentation torch checkpoint (.bin/.ckpt/.pt)")
    p.add_argument("--osd-onset", type=float, default=-1.0,
                   help="PyanNet OSD: pyannote Binarize onset (enables hysteresis)")
    p.add_argument("--osd-offset", type=float, default=-1.0,
                   help="PyanNet OSD: pyannote Binarize offset")
    p.add_argument("--osd-min-on", type=float, default=-1.0,
                   help="PyanNet OSD: min_duration_on seconds")
    p.add_argument("--osd-min-off", type=float, default=-1.0,
                   help="PyanNet OSD: min_duration_off seconds")
    p.add_argument("--sep-nsrc", type=int, default=2)
    p.add_argument("--min-overlap-dur", type=float, default=0.4)
    p.add_argument("--activity-thr", type=float, default=0.03,
                   help="Frame considered active if RMS > peak_rms * activity_thr")
    p.add_argument("--out-dir", default="test/overlap_eval")
    p.add_argument("--save-details", action="store_true")
    p.add_argument("--provider", default="cuda",
                   help="Device: cuda (raises when no GPU is found) or cpu")
    p.add_argument("--enable-asr", action="store_true")
    p.add_argument("--paraformer", default="")
    p.add_argument("--sense-voice", default="")
    p.add_argument("--encoder", default="")
    p.add_argument("--decoder", default="")
    p.add_argument("--joiner", default="")
    p.add_argument("--tokens", default="")
    p.add_argument("--cmvn", default="", help="kaldi am.mvn CMVN stats for the ASR frontend")
    p.add_argument("--decoding-method", default="greedy_search")
    p.add_argument("--num-active-paths", type=int, default=4,
                   help="beam width for modified_beam_search (transducer)")
    p.add_argument("--feature-dim", type=int, default=80)
    p.add_argument("--num-threads", type=int, default=1)
    p.add_argument("--language", default="auto")
    p.add_argument("--librimix-root", required=True, help="Parent dir of Libri2Mix/Libri3Mix")
    p.add_argument("--num-speakers", type=int, default=2, choices=[2, 3],
                   help="Dataset speaker count (2 -> Libri2Mix, 3 -> Libri3Mix)")
    p.add_argument("--dataset-sample-rate", type=int, default=8000, choices=[8000, 16000])
    p.add_argument("--preset", default="full", choices=["full", "tiny"])
    p.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="int8 inference (not ported yet: raises)")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-segment-sec", type=float, default=64.0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    out_dir = Path(args.out_dir) / datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    out_dir.mkdir(parents=True, exist_ok=True)

    engine = build_engine(args)
    ds = LibriMixDataset(args.librimix_root, subset="test", num_speakers=args.num_speakers,
                         sample_rate=args.dataset_sample_rate, task="sep_clean", mode="min")
    total = len(ds)
    limit = args.max_files if args.max_files and args.max_files > 0 else total
    _log(f"dataset size={total}, processing={limit}")

    cpu_mon = CPUMonitor(0.5)
    cpu_mon.start()

    osd_tp = osd_fp = osd_fn = 0
    gt_overlap_total = pred_overlap_total = 0.0
    audio_total = osd_time = sep_time = asr_time = 0.0
    overlap_pred_sec_for_sep = 0.0
    sdr_list: List[float] = []
    sdri_list: List[float] = []

    details_f = writer = None
    if args.save_details:
        details_f = (out_dir / "overlap_details.csv").open("w", newline="", encoding="utf-8")
        writer = csv.writer(details_f)
        writer.writerow(["wav", "seg_start", "seg_end", "dur", "si_sdr", "si_sdri",
                         "perm_swapped", "selected_pred_indices", "sep_nsrc", "k_refs"])

    overlap_mix_refs: List[str] = []
    overlap_mix_hyps: List[str] = []
    overlap_sep_refs: List[str] = []
    overlap_sep_hyps: List[str] = []
    clean_refs: List[str] = []
    clean_hyps: List[str] = []

    t0 = time.time()
    for idx in range(limit):
        sr_item, mix_raw, sources = ds[idx]
        if sources is None or len(sources) < 2:
            continue
        mix_p = str(ds.items[idx].mix_path)
        resampled = engine.resample_batch([mix_raw] + list(sources), sr_item, G_SAMPLE_RATE)
        mix, srcs = resampled[0], resampled[1:]
        have_s3 = len(srcs) >= 3
        m = min(len(mix), *(len(s) for s in srcs))
        mix = mix[:m]
        srcs = [s[:m] for s in srcs]
        sr = G_SAMPLE_RATE
        dur = m / sr
        audio_total += dur

        t_o = time.time()
        pred_segments = engine.osd_segments(mix, sr, args.osd_thr, args.osd_win, args.osd_hop)
        osd_time += time.time() - t_o
        if not pred_segments:
            pred_segments = [(0.0, dur, False)]
        pred_mask = segments_to_mask(pred_segments, dur, args.osd_hop, args.osd_win)
        pred_overlap_total += sum(e - s for s, e, f in pred_segments if f)

        k_srcs = 3 if have_s3 else 2
        gt_mask = build_gt_overlap_mask(srcs[:k_srcs], sr, args.osd_win, args.osd_hop, args.activity_thr)
        gt_segments = masks_to_segments(gt_mask, args.osd_hop, args.osd_win, dur)
        gt_overlap_total += sum(e - s for s, e in gt_segments)

        n = min(len(gt_mask), len(pred_mask))
        g, pm = gt_mask[:n], pred_mask[:n]
        osd_tp += int(np.sum(g & pm))
        osd_fp += int(np.sum(~g & pm))
        osd_fn += int(np.sum(g & ~pm))

        # --- separation on predicted overlap segments (batched)
        ol_rows = []
        for s, e, is_ol in pred_segments:
            if is_ol and (e - s) >= args.min_overlap_dur and int(e * sr) > int(s * sr):
                ol_rows.append((s, e, int(s * sr), int(e * sr)))
        if ol_rows:
            t_s = time.time()
            preds_all = engine.separate([mix[a:b] for _, _, a, b in ol_rows],
                                        n_src=args.sep_nsrc, backend=args.sep_backend)
            sep_time += time.time() - t_s
            overlap_pred_sec_for_sep += sum(e - s for s, e, _, _ in ol_rows)
            for (s, e, a, b), pred_out in zip(ol_rows, preds_all):
                refs = [src[a:b] for src in srcs[:k_srcs]]
                pred_list = [pred_out[i] for i in range(pred_out.shape[0])]
                k = len(refs)
                if int(args.sep_nsrc) < k:
                    continue
                if k == 2:
                    seg_sdr, seg_sdri, assign_idx, swapped = sdr_improvement_pit_2(
                        mix[a:b], refs[0], refs[1], pred_list)
                else:
                    seg_sdr, seg_sdri, assign_idx = sdr_improvement_pit(mix[a:b], refs, pred_list)
                    swapped = False
                if not math.isnan(seg_sdr):
                    sdr_list.append(seg_sdr)
                if not math.isnan(seg_sdri):
                    sdri_list.append(seg_sdri)
                if writer:
                    writer.writerow([
                        mix_p, f"{s:.3f}", f"{e:.3f}", f"{(e-s):.3f}",
                        f"{(0.0 if math.isnan(seg_sdr) else seg_sdr):.3f}",
                        f"{(0.0 if math.isnan(seg_sdri) else seg_sdri):.3f}",
                        1 if swapped else 0,
                        ";".join(str(i) for i in assign_idx) if assign_idx else "",
                        int(args.sep_nsrc), k,
                    ])

        # --- pseudo-reference ASR eval (reference: :829-918)
        if args.enable_asr:
            rms = [frame_rms_np(s, sr, args.osd_win, args.osd_hop) for s in srcs[:k_srcs]]
            nmin = min(len(r) for r in rms)
            rms = np.stack([r[:nmin] for r in rms])
            peak = max(float(rms.max(initial=0.0)), 1e-9)
            active = rms > peak * args.activity_thr
            gt_overlap_mask = active.sum(axis=0) >= 2
            only = [
                active[i] & ~np.any(np.delete(active, i, axis=0), axis=0)
                for i in range(k_srcs)
            ]
            overlap_segs = [
                (int(s_t * sr), int(e_t * sr))
                for s_t, e_t in masks_to_segments(gt_overlap_mask, args.osd_hop, args.osd_win, dur)
                if (e_t - s_t) >= args.min_overlap_dur and int(e_t * sr) > int(s_t * sr)
            ]
            clean_segs = [
                (i, int(s_t * sr), int(e_t * sr))
                for i in range(k_srcs)
                for s_t, e_t in masks_to_segments(only[i], args.osd_hop, args.osd_win, dur)
                if (e_t - s_t) >= 0.05 and int(e_t * sr) > int(s_t * sr)
            ]
            # one separate call for every GT overlap segment, then ONE
            # transcribe batch covering all of this mixture's ASR work
            t_a = time.time()
            want_sep_asr = int(args.sep_nsrc) == 2 and not have_s3
            pw_all = (
                engine.separate([mix[a:b] for a, b in overlap_segs], n_src=2,
                                backend=args.sep_backend)
                if (want_sep_asr and overlap_segs) else []
            )
            items: List[np.ndarray] = []
            for j, (a, b) in enumerate(overlap_segs):
                items += [srcs[0][a:b], srcs[1][a:b], mix[a:b]]
                if want_sep_asr:
                    items += [pw_all[j][0], pw_all[j][1]]
            for i, a, b in clean_segs:
                items += [srcs[i][a:b], mix[a:b]]
            texts = engine.transcribe(items, args.language) if items else []
            asr_time += time.time() - t_a
            pos = 0
            for _ in overlap_segs:
                ref1_txt, ref2_txt, mix_hyp = texts[pos:pos + 3]
                pos += 3
                if want_sep_asr:
                    hyp1, hyp2 = texts[pos:pos + 2]
                    pos += 2
                    cost_12 = cer(ref1_txt, hyp1) + cer(ref2_txt, hyp2)
                    cost_21 = cer(ref1_txt, hyp2) + cer(ref2_txt, hyp1)
                    hyp_pair = hyp2 + " " + hyp1 if cost_21 < cost_12 else hyp1 + " " + hyp2
                    overlap_sep_refs.append(ref1_txt + " " + ref2_txt)
                    overlap_sep_hyps.append(hyp_pair)
                overlap_mix_refs.append(ref1_txt + " " + ref2_txt)
                overlap_mix_hyps.append(mix_hyp)
            for _ in clean_segs:
                ref_txt, mix_txt = texts[pos:pos + 2]
                pos += 2
                clean_refs.append(ref_txt)
                clean_hyps.append(mix_txt)

        if (idx + 1) % 20 == 0:
            _log(f"Processed {idx+1}/{limit}")

    if details_f:
        details_f.close()
    elapsed = time.time() - t0

    precision = osd_tp / (osd_tp + osd_fp) if (osd_tp + osd_fp) > 0 else 0.0
    recall = osd_tp / (osd_tp + osd_fn) if (osd_tp + osd_fn) > 0 else 0.0
    f1 = 2 * precision * recall / (precision + recall) if (precision + recall) > 0 else 0.0
    iou = osd_tp / (osd_tp + osd_fp + osd_fn) if (osd_tp + osd_fp + osd_fn) > 0 else 0.0

    def _safe_stats(vals: List[float]):
        if not vals:
            return {"count": 0}
        arr = np.asarray(vals)
        return {
            "count": int(arr.size),
            "mean": float(np.mean(arr)),
            "median": float(np.median(arr)),
            "p25": float(np.percentile(arr, 25)),
            "p75": float(np.percentile(arr, 75)),
            "min": float(np.min(arr)),
            "max": float(np.max(arr)),
        }

    div = lambda a, b: (a / b) if (b and b > 0) else 0.0
    eval_json: Dict[str, Any] = {
        "dataset": f"Libri{args.num_speakers}Mix_{'8k' if args.dataset_sample_rate==8000 else '16k'}",
        "files_limit": limit,
        "elapsed_sec": round(elapsed, 3),
        "hop_sec": args.osd_hop,
        "win_sec": args.osd_win,
        "sep_nsrc": int(args.sep_nsrc),
        "activity_thr": args.activity_thr,
        "min_overlap_dur": args.min_overlap_dur,
        "gt_overlap_total_sec": round(gt_overlap_total, 3),
        "pred_overlap_total_sec": round(pred_overlap_total, 3),
        "audio_total_sec": round(audio_total, 3),
        "timing": {
            "time_wall_sec": round(elapsed, 3),
            "time_osd_sec": round(osd_time, 3),
            "time_sep_sec": round(sep_time, 3),
            "time_asr_sec": round(asr_time, 3),
            "overlap_predicted_sec_for_sep": round(overlap_pred_sec_for_sep, 3),
            "rtf_total": round(div(elapsed, audio_total), 4),
            "rtf_osd": round(div(osd_time, audio_total), 4),
            "rtf_sep_total": round(div(sep_time, audio_total), 4),
            "rtf_sep_overlap": round(div(sep_time, overlap_pred_sec_for_sep), 4),
            "rtf_asr": round(div(asr_time, audio_total), 4),
        },
        "osd": {
            "precision": round(precision, 4),
            "recall": round(recall, 4),
            "f1": round(f1, 4),
            "iou": round(iou, 4),
            "tp_frames": osd_tp,
            "fp_frames": osd_fp,
            "fn_frames": osd_fn,
        },
        "separation": {
            "si_sdr": _safe_stats(sdr_list),
            "si_sdri": _safe_stats(sdri_list),
        },
        "notes": "SI-SDR on predicted overlap segments; ASR metrics available when enable-asr. Includes timing & RTF.",
    }
    eval_json["cpu"] = cpu_mon.stop()

    if args.enable_asr:
        def _aggregate(refs: List[str], hyps: List[str]) -> Dict[str, float]:
            if not refs:
                return {"count": 0}
            wers = [wer(r, h) for r, h in zip(refs, hyps)]
            cers = [cer(r, h) for r, h in zip(refs, hyps)]
            return {
                "count": len(refs),
                "wer_mean": round(float(np.mean(wers)), 4),
                "wer_median": round(float(np.median(wers)), 4),
                "cer_mean": round(float(np.mean(cers)), 4),
                "cer_median": round(float(np.median(cers)), 4),
            }

        asr_dict: Dict[str, Any] = {
            "overlap_mixture": _aggregate(overlap_mix_refs, overlap_mix_hyps),
            "clean": _aggregate(clean_refs, clean_hyps),
        }
        if int(args.sep_nsrc) == 2:
            asr_dict["overlap_separated"] = _aggregate(overlap_sep_refs, overlap_sep_hyps)
        else:
            asr_dict["overlap_separated"] = {
                "count": 0,
                "skipped": True,
                "reason": "sep_nsrc != 2; pairing references with >2 predictions is ambiguous for simple text concat.",
            }
        eval_json["asr"] = asr_dict

    with (out_dir / "evaluation.json").open("w", encoding="utf-8") as f:
        json.dump(eval_json, f, ensure_ascii=False, indent=2)
    _log(f"Done. Wrote evaluation to {out_dir / 'evaluation.json'}")
    if sdr_list:
        _log(f"SI-SDR mean={np.mean(sdr_list):.2f}dB, SI-SDRi mean={np.mean(sdri_list):.2f}dB")
    _log(f"OSD precision={precision:.3f} recall={recall:.3f} f1={f1:.3f} iou={iou:.3f}")
    return out_dir, eval_json


if __name__ == "__main__":
    main()
