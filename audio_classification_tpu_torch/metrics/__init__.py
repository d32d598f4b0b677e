"""Evaluation metrics: SI-SDR/PIT, CER/WER, OSD quality, aggregation."""
from .aggregate import agg_stats, agg_stats_full, maybe_round
from .osd_metrics import build_gt_overlap_mask, compute_osd_metrics, frame_rms_np
from .sisdr import (
    pit_best_si_sdr,
    pit_best_si_sdr_2,
    pit_si_sdr_batch,
    sdr_improvement_pit,
    sdr_improvement_pit_2,
    sdr_improvement_pit_batch,
    si_sdr,
    si_sdr_matrix,
)
from .text import cer, edit_distance, normalize_for_cer, wer
from .verification import eer

__all__ = [
    "agg_stats", "agg_stats_full", "maybe_round",
    "build_gt_overlap_mask", "compute_osd_metrics", "frame_rms_np",
    "pit_best_si_sdr", "pit_si_sdr_batch", "sdr_improvement_pit", "pit_best_si_sdr_2", "sdr_improvement_pit_2",
    "sdr_improvement_pit_batch", "si_sdr", "si_sdr_matrix",
    "cer", "edit_distance", "normalize_for_cer", "wer", "eer",
]
