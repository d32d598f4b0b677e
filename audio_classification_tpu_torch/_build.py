"""Build and load the port's hand-written CUDA kernels and its native host
codecs.

Every ``csrc/*.cu`` file (with the ``csrc/*.cuh`` headers it includes) is
compiled by ``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per source and all
started together, and the objects are linked into ONE shared library with a
plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu        (in parallel)
    nvcc -shared -o build/kernels/libact_kernels_<hash>.so *.o

The library name carries a hash of the sources, headers and flags, so an edit
rebuilds at first use and an unchanged tree reuses the last build. Each C
entry point returns ``cudaGetLastError()`` after its launches; the Python
wrappers raise on a non-zero code (``check``).

The host codecs (``native/wavcodec.cpp``, ``native/ringbuffer.cpp``: the WAV
decoder / encoder and the streaming ring buffer, plain C interfaces) are built
the same way with ``g++`` at first use, one library a source, into
``build/native/`` under a hash of the source and flags (``host_library``):

    g++ -O3 -fPIC -std=c++17 -shared -o build/native/lib<name>_<hash>.so native/<name>.cpp

A failed build raises with the compiler's output: nothing falls back to the
numpy codecs on its own.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
NATIVE = Path(__file__).resolve().parent / "native"
HOST_BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _headers() -> list:
    return sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> Optional[str]:
    """nvcc on PATH, else under CUDA_HOME (default /usr/local/cuda); None
    without a CUDA toolkit."""
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    return None


def _nvcc() -> str:
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed (CUDA_HOME or PATH)")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libact_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> float:
    """Compile the kernels if this source hash has no library yet.

    Returns the seconds spent in nvcc (0.0 when the library was current).
    ``verbose`` adds ``-Xptxas -v`` and prints nvcc's report (registers,
    shared memory and spills per kernel)."""
    out = library_path()
    if out.is_file():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    objs = [out.with_suffix(f".{os.getpid()}.{src.stem}.o") for src in _sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *extra, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src, obj in zip(_sources(), objs)]
    try:
        results = [(src.name, proc.communicate()[1], proc.returncode)
                   for src, proc in zip(_sources(), procs)]
        for name, err, code in results:
            if code != 0:
                raise RuntimeError(f"nvcc failed on {name} ({code}):\n{err}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n{link.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if verbose:
        for name, err, _code in results:
            print(f"[{name}]\n{err}", flush=True)
            reports[name] = err
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    return seconds


def kernel_resources(report: str) -> list:
    """The kernels of an ``nvcc -Xptxas -v`` report with their registers and
    spill bytes (stores + loads): [{kernel, registers, spill_bytes}] in the
    report's order (kernel: the mangled entry name)."""
    out, name, spill = [], None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append({"kernel": name, "registers": int(m.group(1)), "spill_bytes": spill})
            name = None
    return out


#: each source's ``-Xptxas -v`` report from this process's last verbose
#: build (``build(verbose=True)``): {source name: report}
reports: dict = {}

#: seconds this process has spent in nvcc (``build`` through ``_library``):
#: a stage program's first call reads the time it took (engine/programs.py)
build_seconds = 0.0


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    global build_seconds
    build_seconds += build()
    return ctypes.CDLL(str(library_path()))


def kernel(name: str, argtypes: list):
    """The C entry point ``name`` with its argument types declared
    (``c_void_p`` for every pointer and the stream, so 64-bit addresses are
    never cut to 32 bits); declared once, then looked up."""
    return _entry(name, tuple(argtypes))


@functools.lru_cache(maxsize=None)
def _entry(name: str, argtypes: tuple):
    fn = getattr(_library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")


def launch(name: str, fn, device, *args) -> None:
    """Call the kernel entry ``fn(*args, stream)`` with ``device`` current
    and that device's current stream as the last argument: a launch goes to
    the card its tensors are on, whatever card the caller has current."""
    import torch

    with torch.cuda.device(device):
        check(name, fn(*args, torch.cuda.current_stream(device).cuda_stream))


def find_gxx() -> Optional[str]:
    """g++ on PATH; None without one."""
    return shutil.which("g++")


def host_library_path(name: str) -> Path:
    """Where ``native/<name>.cpp`` builds: named after a hash of the source
    and the flags, so an edit rebuilds and an unchanged source reuses."""
    src = NATIVE / f"{name}.cpp"
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src.read_bytes())
    return HOST_BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_host(name: str) -> Path:
    """Compile ``native/<name>.cpp`` with g++ unless this source hash is
    built already -> the library's path. RuntimeError with the compiler's
    output when it fails, or when there is no compiler."""
    out = host_library_path(name)
    if out.is_file():
        return out
    gxx = find_gxx()
    if gxx is None:
        raise RuntimeError(f"no C++ compiler (g++) to build native/{name}.cpp")
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(NATIVE / f"{name}.cpp")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on native/{name}.cpp ({proc.returncode}):\n"
                           f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    return out


@functools.lru_cache(maxsize=None)
def host_library(name: str) -> ctypes.CDLL:
    """The native host library ``name`` ("wavcodec", "ringbuffer"), built
    at first use and loaded once."""
    return ctypes.CDLL(str(build_host(name)))
