"""The kernels' build cache, and the compile-cache series.

The port compiles no program at solve time: its device work is eager
PyTorch and the hand-written CUDA kernels of csrc/, which
ops/cuda_build.py builds with nvcc into shared libraries at first use. What
a geometry's first solve pays instead is its warm-up: the first dispatch at
a solve geometry (TorchSolver's warm keys, the solver service's entries)
makes the caching allocator's first blocks there and loads what the
geometry reaches. That first dispatch is this cache's miss; every later
dispatch of the same key is a hit. The series keep the reference's names
and sites, so one dashboard reads both packages.

enable_persistent_cache() names the directory the kernels' libraries are
built into. A library there outlives the process: the next process loads
it instead of running nvcc again (cuda_build rebuilds only when the source
is newer). It is called at boot by the operator entry, the solver service
and the solver host's child, before the first kernel is built.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional

from karpenter_core_tpu_torch.metrics.registry import NAMESPACE, REGISTRY
from karpenter_core_tpu_torch.obs import envflags
from karpenter_core_tpu_torch.obs import reqctx

CACHE_HITS = REGISTRY.counter(
    f"{NAMESPACE}_compile_cache_hits",
    "Compiled-executable cache hits, by cache site",
)
CACHE_MISSES = REGISTRY.counter(
    f"{NAMESPACE}_compile_cache_misses",
    "Compiled-executable cache misses (jit trace + compile paid), by cache site",
)
COMPILE_SECONDS = REGISTRY.histogram(
    f"{NAMESPACE}_compile_cache_compile_seconds",
    "Seconds spent in a cache-missing solve's first dispatch (includes jit "
    "trace + XLA compile, or the persistent disk-cache load)",
)

DISABLED = ("0", "off", "disabled")


def record_lookup(site: str, hit: bool) -> None:
    """One warm-state lookup outcome (site: 'tpu_solver', 'prewarm',
    'replan', 'service', 'service_sharded' (a device grid's entries in the
    solver service; a grid's in-process solves count at 'tpu_solver'
    under keys of their own), 'service_replan_entry', 'service_replan'). A
    bound request context adds a tenant label: which tenant's request paid
    the cold dispatch."""
    (CACHE_HITS if hit else CACHE_MISSES).inc(reqctx.tenant_labels(site=site))


def record_compile_seconds(seconds: float) -> None:
    COMPILE_SECONDS.observe(seconds, reqctx.tenant_labels())


def enable_persistent_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Point the kernels' builds at a directory that outlives the process.

    KARPENTER_COMPILE_CACHE_DIR overrides the default, the package's
    csrc/build/; "0" / "off" / "disabled" turns the cache off, and this
    process then builds into a temporary directory of its own. Returns the
    directory in use, or None when disabled."""
    from karpenter_core_tpu_torch.ops import cuda_build

    env = envflags.raw("KARPENTER_COMPILE_CACHE_DIR")
    if env.strip().lower() in DISABLED:
        cuda_build.BUILD_DIR = tempfile.mkdtemp(prefix="karpenter-kernels-")
        return None
    cache_dir = cache_dir or env or cuda_build.DEFAULT_BUILD_DIR
    os.makedirs(cache_dir, exist_ok=True)
    # the libraries already loaded stay loaded; later builds and loads
    # look here
    cuda_build.BUILD_DIR = cache_dir
    return cache_dir
