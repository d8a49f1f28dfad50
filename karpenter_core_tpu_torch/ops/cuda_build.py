"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is built
with nvcc for sm_90a into ``csrc/build/lib<name>.so`` (rebuilt whenever the
source is newer; written to a temporary file and renamed into place, so
concurrent builders never load a half-written library) and loaded with
ctypes. A failed build raises KernelError: there is no fallback.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List

from karpenter_core_tpu_torch.obs import envflags

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
DEFAULT_BUILD_DIR = os.path.join(CSRC, "build")
# where the libraries are built and looked for (utils/compilecache.
# enable_persistent_cache moves it)
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# seconds each build took in this process (0.0 when the library was current)
BUILD_SECONDS: Dict[str, float] = {}


class KernelError(RuntimeError):
    """A kernel that did not build, load or launch. Callers that degrade
    on their own errors let this one through."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = envflags.raw("CUDA_HOME") or envflags.raw("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise KernelError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless the library is newer; returns its path."""
    src = os.path.join(CSRC, f"{name}.cu")
    build_dir = BUILD_DIR
    out = os.path.join(build_dir, f"lib{name}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise KernelError(
                f"nvcc failed for {src} (exit {proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return out


def build_all(names) -> Dict[str, str]:
    """Build several kernels at once, one nvcc per source."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(build, names)))


def loaded_names() -> List[str]:
    """The kernels whose library this process has loaded."""
    with _LOCK:
        return sorted(_LIBS)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build(name)
            try:
                lib = _LIBS[name] = ctypes.CDLL(path)
            except OSError as exc:
                raise KernelError(f"cannot load {path}: {exc}") from exc
        return lib
