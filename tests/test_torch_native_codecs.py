"""The port's native host codecs (native/wavcodec.cpp, native/ringbuffer.cpp,
built with g++ at first use by _build.host_library) against their numpy
versions and against the JAX package's read_wav / write_wav / RingBuffer:
equal samples read, equal bytes written, equal ring-buffer contents and drop
counts; and the build itself: named after the source's hash in build/native,
a failed build raising with the compiler's output."""
import struct

import numpy as np
import pytest

from audio_classification_tpu.audio_io import stream_buffer as jax_sb
from audio_classification_tpu.audio_io import wav as jax_wav
from audio_classification_tpu_torch import _build
from audio_classification_tpu_torch.audio_io import RingBuffer, read_wav, write_wav
from audio_classification_tpu_torch.audio_io.stream_buffer import NumpyRingBuffer
from audio_classification_tpu_torch.audio_io.wav import read_wav_numpy, write_wav_numpy

SR = 16000


def _signal(channels, n, seed=0):
    x = np.random.default_rng(seed).uniform(-1.3, 1.3, (channels, n)).astype(np.float32)
    # values on the pcm16 rounding ties and the clip edges
    x[0, :6] = np.array([0.5, 1.5, -0.5, 2.5, 1.0, -1.0], np.float32) / 32767.0
    x[0, 6:8] = [1.0, -1.0]
    return x if channels > 1 else x[0]


def _header(tag, channels, bits, n_bytes, extensible=False, declared=None):
    """A RIFF/WAVE header: fmt (16 bytes, or 40 with the extensible
    SubFormat whose first two bytes carry ``tag``) and the data chunk's."""
    block = channels * bits // 8
    if extensible:
        fmt = struct.pack("<HHIIHH", 0xFFFE, channels, SR, SR * block, block, bits)
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", tag) + b"\x00" * 14
    else:
        fmt = struct.pack("<HHIIHH", tag, channels, SR, SR * block, block, bits)
    data_size = n_bytes if declared is None else declared
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + data_size) + b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data"
            + struct.pack("<I", data_size))


def _pcm24(x):
    v = np.clip(np.rint(x * 8388607.0), -8388608, 8388607).astype("<i4")
    return np.stack([(v >> s) & 0xFF for s in (0, 8, 16)], axis=-1).astype(np.uint8).tobytes()


def _files(tmp_path):
    """name -> path: every encoding the codec reads, mono and multi-channel,
    extensible, and truncated files."""
    out = {}
    mono, stereo, tri = _signal(1, 3001), _signal(2, 2000, 1), _signal(3, 999, 2)
    for name, x in (("mono", mono), ("stereo", stereo), ("three", tri)):
        write_wav_numpy(tmp_path / f"{name}_pcm16.wav", x, SR)
        write_wav_numpy(tmp_path / f"{name}_f32.wav", x, SR, encoding="float32")
        out[f"{name}_pcm16"] = tmp_path / f"{name}_pcm16.wav"
        out[f"{name}_f32"] = tmp_path / f"{name}_f32.wav"
    inter = np.clip(stereo, -1, 1).T.reshape(-1)
    raw = {
        "pcm8": (1, 8, (np.clip(np.rint(inter * 127 + 128), 0, 255)).astype(np.uint8).tobytes()),
        "pcm24": (1, 24, _pcm24(inter)),
        "pcm32": (1, 32, np.rint(inter * 2147483000.0).astype("<i4").tobytes()),
        "f64": (3, 64, inter.astype("<f8").tobytes()),
    }
    for name, (tag, bits, payload) in raw.items():
        for ext in (False, True):
            key = f"stereo_{name}{'_ext' if ext else ''}"
            (tmp_path / f"{key}.wav").write_bytes(_header(tag, 2, bits, len(payload), ext)
                                                  + payload)
            out[key] = tmp_path / f"{key}.wav"
    pcm = np.rint(np.clip(inter, -1, 1) * 32767).astype("<i2").tobytes()
    (tmp_path / "ext_pcm16.wav").write_bytes(_header(1, 2, 16, len(pcm), True) + pcm)
    out["stereo_pcm16_ext"] = tmp_path / "ext_pcm16.wav"
    # truncated: the header declares 1000 more frames than the file holds,
    # cut on a sample (mono) and on a frame (stereo) boundary
    whole = (tmp_path / "mono_pcm16.wav").read_bytes()
    (tmp_path / "trunc_mono.wav").write_bytes(_header(1, 1, 16, 0, declared=2 * 4001)
                                              + whole[44: 44 + 2 * 2500])
    out["truncated_mono"] = tmp_path / "trunc_mono.wav"
    (tmp_path / "trunc_stereo.wav").write_bytes(_header(3, 2, 32, 0, declared=8 * 3000)
                                                + inter.astype("<f4").tobytes()[: 8 * 1500])
    out["truncated_stereo"] = tmp_path / "trunc_stereo.wav"
    return out


def test_native_read_equals_numpy_and_jax(tmp_path):
    for name, path in _files(tmp_path).items():
        for always_2d in (False, True):
            got, sr = read_wav(path, always_2d=always_2d)
            ref, sr_ref = read_wav_numpy(path, always_2d=always_2d)
            jx, sr_j = jax_wav.read_wav(path, always_2d=always_2d)
            assert sr == sr_ref == sr_j == SR, name
            assert got.dtype == ref.dtype == np.float32, name
            assert got.shape == ref.shape == jx.shape, (name, got.shape, ref.shape)
            assert np.array_equal(got, ref) and np.array_equal(got, jx), name
            assert got.flags["C_CONTIGUOUS"]
    assert read_wav(tmp_path / "trunc_mono.wav")[0].shape == (2500,)
    assert read_wav(tmp_path / "trunc_stereo.wav")[0].shape == (2, 1500)
    assert read_wav(tmp_path / "three_pcm16.wav")[0].shape == (3, 999)


def test_odd_truncation_reads_as_jax_native(tmp_path):
    """A PCM16 file cut inside a sample: the native decoder keeps the whole
    samples, as the JAX package's native path does; the numpy parser refuses
    the odd payload."""
    x = _signal(1, 400)
    write_wav_numpy(tmp_path / "a.wav", x, SR)
    data = (tmp_path / "a.wav").read_bytes()
    (tmp_path / "odd.wav").write_bytes(data[:-3])
    got, _ = read_wav(tmp_path / "odd.wav")
    assert np.array_equal(got, jax_wav.read_wav(tmp_path / "odd.wav")[0])
    assert np.array_equal(got, read_wav_numpy(tmp_path / "a.wav")[0][:398])
    with pytest.raises(ValueError):
        read_wav_numpy(tmp_path / "odd.wav")


def test_bad_files_raise_as_numpy_names_them(tmp_path):
    (tmp_path / "junk.wav").write_bytes(b"not a wave file at all")
    with pytest.raises(ValueError, match="RIFF"):
        read_wav(tmp_path / "junk.wav")
    (tmp_path / "pcm12.wav").write_bytes(_header(1, 1, 12, 6) + b"\x00" * 6)
    with pytest.raises(ValueError, match="bit depth"):
        read_wav(tmp_path / "pcm12.wav")
    with pytest.raises(FileNotFoundError):
        read_wav(tmp_path / "missing.wav")


@pytest.mark.parametrize("shape", [(3001,), (2, 2000), (3, 999), (0,)])
@pytest.mark.parametrize("encoding", ["pcm16", "float32"])
def test_native_write_equals_numpy_and_jax(tmp_path, shape, encoding):
    x = _signal(shape[0] if len(shape) == 2 else 1, shape[-1]) if shape[-1] else np.zeros(0)
    for dtype in (np.float32, np.float64):
        write_wav(tmp_path / "native.wav", x.astype(dtype), SR, encoding=encoding)
        write_wav_numpy(tmp_path / "numpy.wav", x.astype(dtype), SR, encoding=encoding)
        jax_wav.write_wav(tmp_path / "jax.wav", x.astype(dtype), SR, encoding=encoding)
        a = (tmp_path / "native.wav").read_bytes()
        assert a == (tmp_path / "numpy.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    if encoding == "pcm16" and shape[-1]:
        i16 = np.rint(np.clip(x, -1, 1) * 32767).astype(np.int16)
        write_wav(tmp_path / "i16.wav", i16, SR)
        jax_wav.write_wav(tmp_path / "ji16.wav", i16, SR)
        assert (tmp_path / "i16.wav").read_bytes() == (tmp_path / "ji16.wav").read_bytes()


def test_write_to_a_missing_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        write_wav(tmp_path / "nope" / "a.wav", np.zeros(10, np.float32), SR)


def test_ring_buffer_native_equals_numpy_and_jax():
    """Random pushes (overflowing) and pops: the same samples out, the same
    sizes, the same drop counts in all three buffers."""
    rng = np.random.default_rng(0)
    bufs = [RingBuffer(257), NumpyRingBuffer(257), jax_sb.RingBuffer(257)]
    assert bufs[2]._native is not None  # the JAX package's native buffer
    fed = 0
    for _ in range(300):
        if rng.random() < 0.55:
            x = rng.standard_normal(int(rng.integers(0, 120))).astype(np.float32)
            took = [b.push(x) for b in bufs]
            assert took[0] == took[1] == took[2], took
            fed += x.size
        else:
            n = int(rng.integers(0, 150))
            outs = [b.pop(n) for b in bufs]
            assert outs[0].dtype == np.float32
            assert np.array_equal(outs[0], outs[1]) and np.array_equal(outs[0], outs[2])
        sizes = [(b.size, b.dropped) for b in bufs]
        assert sizes[0] == sizes[1] == sizes[2], sizes
    assert bufs[0].dropped > 0 and bufs[0].capacity == 257
    assert bufs[0].pop(-3).size == bufs[1].pop(-3).size == 0


def test_ring_buffer_overflow_drops_the_newest():
    for cls in (RingBuffer, NumpyRingBuffer):
        rb = cls(10)
        assert rb.push(np.arange(7)) == 7 and rb.push(np.arange(7, 14)) == 3
        assert (rb.size, rb.dropped) == (10, 4)
        assert np.array_equal(rb.pop(4), np.arange(4, dtype=np.float32))
        assert rb.push(np.arange(100, 106)) == 4 and rb.dropped == 6
        assert np.array_equal(rb.pop(100), np.r_[np.arange(4, 10), 100, 101, 102, 103])
        assert rb.size == 0 and rb.pop(5).size == 0


def test_host_libraries_build_from_the_sources_into_build_native():
    for name in ("wavcodec", "ringbuffer"):
        path = _build.build_host(name)
        assert path == _build.host_library_path(name) and path.is_file()
        assert path.parent == _build.HOST_BUILD_DIR and path.parent.name == "native"
        assert path.parent.parent.name == "build"
        assert (_build.NATIVE / f"{name}.cpp").is_file()


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "wavcodec.cpp").write_text((_build.NATIVE / "wavcodec.cpp").read_text()
                                      + "\nthis is not C++;\n")
    monkeypatch.setattr(_build, "NATIVE", src)
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on native/wavcodec.cpp(.|\n)*error"):
        _build.build_host("wavcodec")
    assert not list((tmp_path / "out").glob("*.so"))
    # an edited source is another library, built beside the first
    repo_name = _build.host_library_path("wavcodec").name
    (src / "wavcodec.cpp").write_text('extern "C" int f() { return 1; }\n')
    assert _build.host_library_path("wavcodec").name != repo_name
    assert _build.build_host("wavcodec").is_file()
    monkeypatch.setattr(_build, "find_gxx", lambda: None)
    (src / "wavcodec.cpp").write_text('extern "C" int f() { return 2; }\n')
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        _build.build_host("wavcodec")
