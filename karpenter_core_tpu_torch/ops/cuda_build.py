"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is built
with nvcc for sm_90a into ``csrc/build/lib<name>.so`` (rebuilt whenever the
source or a ``csrc/`` header it includes is newer; written to a temporary
file and renamed into place, so concurrent builders never load a
half-written library) and loaded with ctypes. A failed build raises
KernelError: there is no fallback.

The flags keep float arithmetic exact to the eager scan's: -fmad=false
(no multiply-add contraction) and never --use_fast_math (the scan's
divisions must be IEEE). ``build_host`` builds a ``csrc/<name>.cpp`` with
g++ into the same directory, with -ffp-contract=off for the same reason:
the pack scan's CPU build, which only the tests load.
"""
from __future__ import annotations

import ctypes
import os
import re
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
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
]
GXX_FLAGS = ["-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC"]
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

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


def _sources(src: str) -> List[str]:
    """`src` and every csrc/ header it includes, transitively."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in seen or not os.path.exists(path):
            continue
        seen.append(path)
        with open(path, encoding="utf-8") as f:
            todo += [os.path.join(CSRC, h) for h in _INCLUDE.findall(f.read())]
    return seen


def _compile(name: str, src: str, out: str, argv) -> str:
    """Run argv (the compiler, its flags, then -o and the output go last)
    unless `out` is newer than `src` and its headers."""
    if os.path.exists(out) and os.path.getmtime(out) >= max(
            os.path.getmtime(p) for p in _sources(src)):
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    t0 = time.perf_counter()
    try:
        try:
            proc = subprocess.run([*argv, "-o", tmp, src], capture_output=True, text=True)
        except OSError as exc:
            raise KernelError(f"{argv[0]} could not run for {src}: {exc}") from exc
        if proc.returncode != 0:
            raise KernelError(
                f"{os.path.basename(argv[0])} failed for {src} (exit {proc.returncode}):\n"
                f"{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return out


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless the library is newer; returns its path."""
    return _compile(name, os.path.join(CSRC, f"{name}.cu"),
                    os.path.join(BUILD_DIR, f"lib{name}.so"), [nvcc_path(), *NVCC_FLAGS])


def build_host(name: str) -> str:
    """Compile csrc/<name>.cpp with g++ unless the library is newer."""
    return _compile(name, os.path.join(CSRC, f"{name}.cpp"),
                    os.path.join(BUILD_DIR, f"lib{name}.so"), ["g++", *GXX_FLAGS])


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


def load(name: str, host: bool = False) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu (host: csrc/<name>.cpp),
    built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_host(name) if host else build(name)
            try:
                lib = _LIBS[name] = ctypes.CDLL(path)
            except OSError as exc:
                raise KernelError(f"cannot load {path}: {exc}") from exc
        return lib
