"""Environment sanity print (port of audio_classification_tpu/cli/version.py;
reference: scripts/version.py): python, numpy, torch and its CUDA, the
devices, whether ``nvcc`` is found and whether the kernel library of this
source tree is built. Builds nothing and imports no JAX.

    python -m audio_classification_tpu_torch.cli.version
"""
from __future__ import annotations

import sys


def main(argv=None) -> dict:
    import numpy
    import torch

    from .. import _build

    devices = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    lib = _build.library_path()
    info = {
        "python": sys.version.split()[0],
        "framework": "audio_classification_tpu_torch",
        "numpy": numpy.__version__,
        "torch": torch.__version__,
        "torch CUDA": torch.version.cuda or "none (a CPU build)",
        "devices": ", ".join(devices) if devices else "no CUDA device (CPU only)",
        "nvcc": _build.find_nvcc() or "not found",
        "kernel library": (f"built ({lib})" if lib.is_file()
                           else f"not built (nvcc builds it at the first kernel launch: {lib.name})"),
    }
    for key, value in info.items():
        print(f"{key:<16}: {value}")
    return info


if __name__ == "__main__":
    main()
