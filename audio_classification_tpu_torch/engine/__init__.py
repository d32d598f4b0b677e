"""Execution engine: segment algebra, bucketing, batched stage dispatch."""
from .bucketing import BucketSpec, default_buckets, group_by_bucket, pad_batch
from .runtime import G_SAMPLE_RATE, PRESETS, EnginePreset, ModelPack, StageEngine, tiny_preset
from .segments import (
    complement_intervals,
    exclusive_segments,
    flags_to_segments,
    masks_to_segments,
    merge_intervals,
    rasterize_intervals,
    segments_to_mask,
)

__all__ = [
    "BucketSpec", "default_buckets", "group_by_bucket", "pad_batch",
    "G_SAMPLE_RATE", "EnginePreset", "ModelPack", "StageEngine", "tiny_preset",
    "complement_intervals", "exclusive_segments", "flags_to_segments",
    "masks_to_segments", "merge_intervals", "rasterize_intervals", "segments_to_mask",
]  # as the JAX package's (PRESETS is importable, and left out of it there too)
