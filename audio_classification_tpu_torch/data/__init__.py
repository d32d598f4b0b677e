"""Dataset walkers (host I/O)."""
from .librimix import Libri2Mix8kDataset, LibriMixDataset

__all__ = ["LibriMixDataset", "Libri2Mix8kDataset"]
