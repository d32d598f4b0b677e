"""Dataset walkers (host I/O)."""
from .librimix import Libri2Mix8kDataset, LibriMixDataset, LibriMixItem

__all__ = ["Libri2Mix8kDataset", "LibriMixDataset", "LibriMixItem"]
