"""The native (C++) greedy packer: ctypes bindings, built at first use.

NativeSolver serves the Solver interface on the topology-free path: the
static pod x type feasibility mask (every requirement, taint and offering
rule) comes from ops/feasibility.feasibility_static on the solver's device,
the card by default, and fast_pack.cpp runs the greedy FFD over it on the
host. A batch it cannot pack (topology, more than one template, existing
nodes, provisioner limits) raises NotImplementedError, so the caller takes
another solver.

fast_pack.cpp is built with g++ into ``native/build/libfastpack.so``
(rebuilt whenever the source is newer; written to a temporary file and
renamed into place, so a concurrent loader never opens a half-written
library). A failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "fast_pack.cpp")
BUILD_DIR = os.path.join(_HERE, "build")
LIB = os.path.join(BUILD_DIR, "libfastpack.so")
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None
_load_mu = threading.Lock()
# seconds the build took in this process (0.0 when the library was current)
BUILD_SECONDS = None


def build() -> str:
    """Compile fast_pack.cpp unless the library is newer; returns its path."""
    global BUILD_SECONDS
    if os.path.exists(LIB) and os.path.getmtime(LIB) >= os.path.getmtime(SRC):
        if BUILD_SECONDS is None:
            BUILD_SECONDS = 0.0
        return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, SRC, "-o", tmp],
                                  capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"native packer: g++ could not run ({e})") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"native packer: g++ failed for {SRC} (exit {proc.returncode}):\n"
                f"{proc.stderr}")
        os.replace(tmp, LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_SECONDS = time.perf_counter() - t0
    return LIB


def _load():
    global _lib
    with _load_mu:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.fast_pack.restype = ctypes.c_int
        lib.fast_pack.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        _lib = lib
        return lib


def fast_pack(pod_requests, f_static, type_alloc, daemon, max_nodes: int):
    """Run the native packer. Returns (assigned [P], slot_tmask [N, T],
    slot_used [N, R], slot_pods [N], nopen)."""
    lib = _load()
    P, R = pod_requests.shape
    T = type_alloc.shape[0]
    N = max_nodes
    pod_requests = np.ascontiguousarray(pod_requests, dtype=np.float32)
    f_static = np.ascontiguousarray(f_static, dtype=np.uint8)
    type_alloc = np.ascontiguousarray(type_alloc, dtype=np.float32)
    daemon = np.ascontiguousarray(daemon, dtype=np.float32)
    assigned = np.full(P, -1, dtype=np.int32)
    slot_tmask = np.zeros((N, T), dtype=np.uint8)
    slot_used = np.zeros((N, R), dtype=np.float32)
    slot_pods = np.zeros(N, dtype=np.int32)
    nopen = np.zeros(1, dtype=np.int32)
    lib.fast_pack(P, T, R, N, pod_requests, f_static, type_alloc, daemon,
                  assigned, slot_tmask, slot_used, slot_pods, nopen)
    return assigned, slot_tmask, slot_used, slot_pods, int(nopen[0])


class _SlotState:
    """The packed slots in the shape decode_solve reads."""


class NativeSolver:
    """The Solver interface over the C++ packer: a single template, no
    topology, no existing nodes, no provisioner limits; richer batches
    raise NotImplementedError. `device="cuda"` (the default) computes the
    feasibility mask on the card and raises when there is none;
    `device="cpu"` computes it on the CPU."""

    def __init__(self, max_nodes: int = 1024, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("NativeSolver: no CUDA device is available; pass "
                               "device='cpu' to compute the feasibility mask on the CPU")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"NativeSolver: unsupported device {self.device}")
        self.max_nodes = max_nodes
        # the last solve's seconds: feasibility (device) and pack (host)
        self.last_phase_ms = {}

    def solve(self, pods, provisioners, instance_types, daemonset_pods=None,
              state_nodes=None, kube_client=None, cluster=None):
        from karpenter_core_tpu_torch.solver.torch_solver import (
            DEFAULT_MAX_RELAX_ROUNDS,
            solve_with_relaxation,
        )

        return solve_with_relaxation(
            lambda p: self._solve_once(p, provisioners, instance_types, daemonset_pods,
                                       state_nodes, kube_client, cluster),
            pods, provisioners, instance_types, DEFAULT_MAX_RELAX_ROUNDS,
        )

    def _feasibility(self, snap) -> np.ndarray:
        """F_static [P, T] uint8 of the single template: computed per pod
        class on the device, gathered to the pods on the host."""
        from karpenter_core_tpu_torch.ops.feasibility import feasibility_static

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        u = snap.pod_reqs_u

        def reqs(rs):
            return {k: dev(getattr(rs, k)) for k in ("allow", "out", "defined", "escape")}

        segments = [snap.dictionary.segment(k) for k in snap.dictionary.keys]
        f = feasibility_static(
            reqs(u), reqs(snap.tmpl_reqs), reqs(snap.type_reqs), dev(snap.pod_tol_u),
            dev(snap.tmpl_type_mask), dev(snap.type_offering_ok), snap.zone_seg,
            snap.ct_seg, segments, dev(snap.well_known),
        )
        return f[0].cpu().numpy()[snap.uidx].astype(np.uint8)

    def _solve_once(self, pods, provisioners, instance_types, daemonset_pods,
                    state_nodes, kube_client=None, cluster=None):
        from karpenter_core_tpu_torch.solver.encode import encode_snapshot
        from karpenter_core_tpu_torch.solver.torch_solver import decode_solve

        snap = encode_snapshot(pods, provisioners, instance_types, daemonset_pods,
                               state_nodes, kube_client, cluster, max_nodes=self.max_nodes)
        if snap.topo_meta is not None:
            raise NotImplementedError("native packer handles topology-free batches")
        if len(snap.templates) != 1 or snap.state_nodes:
            raise NotImplementedError("native packer handles single-template fresh packs")
        if any(p.spec.limits is not None for p in provisioners):
            # the device scan enforces limits through its remaining budget
            # (scheduler.go:276-293); the packer has no equivalent
            raise NotImplementedError("native packer does not enforce provisioner limits")

        t0 = time.perf_counter()
        f_static = self._feasibility(snap)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        pod_requests = snap.pod_requests_u[snap.uidx]
        assigned, slot_tmask, slot_used, slot_pods, nopen = fast_pack(
            pod_requests, f_static, snap.type_alloc, snap.tmpl_daemon[0],
            min(self.max_nodes, max(len(pods), 1)),
        )
        t2 = time.perf_counter()
        self.last_phase_ms = {"feasibility": (t1 - t0) * 1e3, "pack": (t2 - t1) * 1e3}

        state = _SlotState()
        state.tmpl = np.zeros(slot_tmask.shape[0], dtype=np.int32)
        state.tmask = slot_tmask.astype(bool)
        state.used = slot_used
        # a slot's merged requirements: the template's, intersected with
        # those of every pod packed on it
        N = slot_tmask.shape[0]
        u = snap.pod_reqs_u
        allow = np.repeat(snap.tmpl_reqs.allow[:1], N, axis=0)
        out = np.repeat(snap.tmpl_reqs.out[:1], N, axis=0)
        defined = np.repeat(snap.tmpl_reqs.defined[:1], N, axis=0)
        for i, slot in enumerate(assigned):
            if slot >= 0:
                c = snap.uidx[i]
                allow[slot] &= u.allow[c]
                out[slot] &= u.out[c]
                defined[slot] |= u.defined[c]
        state.allow, state.out, state.defined = allow, out, defined
        return decode_solve(snap, assigned, state)
