"""Builds the port's CUDA kernels from ``ngstpu_torch/csrc`` on first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library under ``ngstpu_torch/kernels/build/``,
then loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
The library's file name carries a hash of the sources and the flags, so an
edited kernel is never served from a stale build. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> {"seconds": build wall time (0.0 when an existing build was
# loaded), "log": nvcc's stderr, which holds the ptxas register/smem report}
BUILD_LOG: dict[str, dict] = {}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _digest(src: pathlib.Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        so = BUILD_DIR / f"lib{name}_{_digest(src)}.so"
        log = {"seconds": 0.0, "log": ""}
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f".{so.name}.{os.getpid()}")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.monotonic()
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed ({r.returncode}): "
                                   f"{' '.join(cmd)}\n{r.stderr}")
            os.replace(tmp, so)
            log = {"seconds": time.monotonic() - t0, "log": r.stderr}
        lib = ctypes.CDLL(str(so))
        BUILD_LOG[name] = log
        _libs[name] = lib
        return lib
