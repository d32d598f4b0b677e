"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file (with the ``csrc/*.cuh`` headers it includes) is
compiled by ``nvcc`` for Hopper (``sm_90a``) into ONE shared library with a
plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/libact_kernels_<hash>.so csrc/*.cu

The library name carries a hash of the sources, headers and flags, so an edit
rebuilds at first use and an unchanged tree reuses the last build. Each C
entry point returns ``cudaGetLastError()`` after its launches; the Python
wrappers raise on a non-zero code (``check``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _headers() -> list:
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed (CUDA_HOME or PATH)")


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
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, flush=True)
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    return seconds


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    build()
    return ctypes.CDLL(str(library_path()))


def kernel(name: str, argtypes: list):
    """The C entry point ``name`` with its argument types declared
    (``c_void_p`` for every pointer and the stream, so 64-bit addresses are
    never cut to 32 bits)."""
    fn = getattr(_library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")
