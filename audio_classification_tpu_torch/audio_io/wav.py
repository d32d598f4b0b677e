"""WAV codec: RIFF/WAVE read + write without external audio libraries
(host copy of audio_classification_tpu/audio_io/wav.py).

The reference delegates wav decode to libsndfile (soundfile) and torchaudio
(reference: scripts/benchmark_pipeline.py:45,127; overlap3_core.py:25-31).
Neither is available here, and host-side decode is pure I/O anyway, so this
module implements the codec directly:

- ``read_wav``  -> (float32 samples [T] or [C, T], sample_rate)
- ``write_wav`` <- float32/float64/int16 samples

Supported encodings: PCM 8/16/24/32-bit, IEEE float32/float64, any channel
count. ``read_wav`` and ``write_wav`` go through the port's native C++ codec
(native/wavcodec.cpp, built with g++ at first use by ``_build.host_library``;
a failed build raises). The numpy functions ``read_wav_numpy`` /
``write_wav_numpy`` are the plain versions the tests hold it to. As in the
JAX package, a file the native decoder refuses goes through the numpy parser,
which names what is wrong with it, and a pcm16 write the native encoder
cannot make (the file does not open) goes through the numpy writer, which
raises the OS error.
"""
from __future__ import annotations

import ctypes
import functools
import os
import struct
from typing import Tuple

import numpy as np

_RIFF = b"RIFF"
_WAVE = b"WAVE"
_FMT = b"fmt "
_DATA = b"data"

_FORMAT_PCM = 1
_FORMAT_IEEE_FLOAT = 3
_FORMAT_EXTENSIBLE = 0xFFFE

# ---------------------------------------------------------------------------
# native codec (native/wavcodec.cpp)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _native_lib() -> ctypes.CDLL:
    """The C++ codec, built at first use; its entry points declared."""
    from .._build import host_library

    lib = host_library("wavcodec")
    lib.wav_read_info.restype = ctypes.c_int
    lib.wav_read_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)]
    lib.wav_read_f32.restype = ctypes.c_longlong
    lib.wav_read_f32.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_longlong]
    lib.wav_write_pcm16.restype = ctypes.c_int
    lib.wav_write_pcm16.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    return lib


def _shape(x: np.ndarray, channels: int, always_2d: bool) -> np.ndarray:
    if channels > 1:
        x = x.reshape(-1, channels).T
    elif always_2d:
        x = x[None, :]
    return np.ascontiguousarray(x)


# ---------------------------------------------------------------------------
# numpy implementation
# ---------------------------------------------------------------------------


def _decode_pcm24(raw: bytes) -> np.ndarray:
    """Decode little-endian signed 24-bit PCM into int32 (sign-extended)."""
    b = np.frombuffer(raw, dtype=np.uint8)
    n = b.size // 3
    b = b[: n * 3].reshape(n, 3)
    out = (
        b[:, 0].astype(np.int32)
        | (b[:, 1].astype(np.int32) << 8)
        | (b[:, 2].astype(np.int32) << 16)
    )
    # sign-extend from 24 bits
    out = np.where(out & 0x800000, out - (1 << 24), out)
    return out


def _parse_wav_bytes(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Parse a RIFF/WAVE byte string -> (interleaved float32 [N], sr, channels)."""
    if len(data) < 12 or data[:4] != _RIFF or data[8:12] != _WAVE:
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    payload = None
    size_total = len(data)
    while pos + 8 <= size_total:
        cid = data[pos : pos + 4]
        (csize,) = struct.unpack_from("<I", data, pos + 4)
        body_start = pos + 8
        body_end = min(body_start + csize, size_total)
        if cid == _FMT:
            fields = struct.unpack_from("<HHIIHH", data, body_start)
            fmt = {
                "format": fields[0],
                "channels": fields[1],
                "sample_rate": fields[2],
                "bits": fields[5],
            }
            if fmt["format"] == _FORMAT_EXTENSIBLE and csize >= 40:
                # SubFormat GUID: first 2 bytes are the actual format tag
                (sub,) = struct.unpack_from("<H", data, body_start + 24)
                fmt["format"] = sub
        elif cid == _DATA:
            payload = data[body_start:body_end]
        pos = body_start + csize + (csize & 1)  # chunks are word-aligned
    if fmt is None or payload is None:
        raise ValueError("missing fmt/data chunk")

    bits = fmt["bits"]
    tag = fmt["format"]
    if tag == _FORMAT_PCM:
        if bits == 16:
            x = np.frombuffer(payload, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(payload, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            x = _decode_pcm24(payload).astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(payload, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    elif tag == _FORMAT_IEEE_FLOAT:
        if bits == 32:
            x = np.frombuffer(payload, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(payload, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"unsupported float bit depth: {bits}")
    else:
        raise ValueError(f"unsupported WAVE format tag: {tag}")
    return x, int(fmt["sample_rate"]), int(fmt["channels"])


def read_wav(path: str | os.PathLike, always_2d: bool = False) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 samples, sample_rate), by the native codec.

    Mono files return shape [T]; multichannel return [C, T].
    With ``always_2d=True`` mono returns [1, T]. A truncated file gives the
    whole frames it holds.
    """
    path = os.fspath(path)
    lib = _native_lib()
    sr, ch, nf = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    if lib.wav_read_info(path.encode(), ctypes.byref(sr), ctypes.byref(ch), ctypes.byref(nf)) == 0:
        # never allocate more samples than the file could hold (>= 1 byte
        # each), whatever frame count a corrupt header declares
        n = min(nf.value * ch.value, os.path.getsize(path))
        buf = np.empty(n, dtype=np.float32)
        got = lib.wav_read_f32(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
        if got >= 0:
            channels = ch.value
            x = buf[: (got // channels) * channels] if channels > 1 else buf[:got]
            return _shape(x, channels, always_2d), sr.value
    return read_wav_numpy(path, always_2d)


def read_wav_numpy(path: str | os.PathLike, always_2d: bool = False) -> Tuple[np.ndarray, int]:
    """``read_wav``'s plain numpy version (the same decode; ValueError names
    what is wrong with a file it cannot parse)."""
    with open(os.fspath(path), "rb") as f:
        data = f.read()
    x, sr_v, channels = _parse_wav_bytes(data)
    return _shape(x, channels, always_2d), sr_v


def to_mono(x: np.ndarray) -> np.ndarray:
    """Collapse [C, T] to mono [T] by channel mean; pass [T] through.

    Mirrors the reference's mono fold (overlap3_core.py:127-133).
    """
    if x.ndim == 2:
        return x.mean(axis=0).astype(np.float32) if x.shape[0] > 1 else x[0]
    return x.astype(np.float32, copy=False)


def write_wav(
    path: str | os.PathLike,
    samples: np.ndarray,
    sample_rate: int,
    encoding: str = "pcm16",
) -> None:
    """Write samples to a WAV file; float samples to pcm16 go through the
    native encoder, everything else as ``write_wav_numpy`` writes it.

    ``samples``: [T] or [C, T] float (clipped to [-1, 1] for pcm16) or int16.
    ``encoding``: "pcm16" or "float32".
    """
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[None, :]
    if encoding == "pcm16" and x.dtype != np.int16:
        channels = x.shape[0]
        f = np.ascontiguousarray(np.clip(x.T.reshape(-1).astype(np.float32), -1.0, 1.0))
        if _native_lib().wav_write_pcm16(os.fspath(path).encode(),
                                         f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                         f.size, int(channels), int(sample_rate)) == 0:
            return
    write_wav_numpy(path, samples, sample_rate, encoding)


def write_wav_numpy(
    path: str | os.PathLike,
    samples: np.ndarray,
    sample_rate: int,
    encoding: str = "pcm16",
) -> None:
    """``write_wav``'s plain numpy version: the same bytes (pcm16 rounds
    half to even in both)."""
    path = os.fspath(path)
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[None, :]
    channels, frames = x.shape
    interleaved = x.T.reshape(-1)

    if encoding == "pcm16":
        if interleaved.dtype != np.int16:
            f = np.clip(interleaved.astype(np.float32), -1.0, 1.0)
            pcm = np.rint(f * 32767.0).astype("<i2")
        else:
            pcm = interleaved.astype("<i2")
        payload = pcm.tobytes()
        bits, tag = 16, _FORMAT_PCM
    elif encoding == "float32":
        payload = interleaved.astype("<f4").tobytes()
        bits, tag = 32, _FORMAT_IEEE_FLOAT
    else:
        raise ValueError(f"unsupported encoding: {encoding}")

    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    with open(path, "wb") as f:
        f.write(_RIFF)
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(_WAVE)
        f.write(_FMT)
        f.write(struct.pack("<IHHIIHH", 16, tag, channels, sample_rate, byte_rate, block_align, bits))
        f.write(_DATA)
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)
