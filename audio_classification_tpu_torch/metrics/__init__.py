"""Evaluation metrics: aggregation (SI-SDR, CER and OSD metrics are not ported yet)."""
from .aggregate import agg_stats, agg_stats_full, maybe_round

__all__ = ["agg_stats", "agg_stats_full", "maybe_round"]
