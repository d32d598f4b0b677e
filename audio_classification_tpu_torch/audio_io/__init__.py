"""Host-side audio I/O: WAV codec."""
from .wav import read_wav, to_mono, write_wav

__all__ = ["read_wav", "write_wav", "to_mono"]
