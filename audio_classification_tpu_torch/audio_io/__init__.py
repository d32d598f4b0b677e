"""Host-side audio I/O: WAV codec and the streaming ring buffer."""
from .stream_buffer import RingBuffer
from .wav import read_wav, to_mono, write_wav

__all__ = ["read_wav", "write_wav", "to_mono", "RingBuffer"]
