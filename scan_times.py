"""Time the pack scan kernel alone on the card, from a checkout's root.

Two scans at full width: 17a's sequential scan (`chip_smoke.segmented_mix`,
50,000 pods x 500 types over 8 pools, no node, no topology group) and,
unless `--no-mix`, phase 5's full mix (`chip_smoke.full_mix`, 50,000 x 500
over 1,000 nodes, with zonal and hostname spreads and zonal affinity).
Each scan runs `--reps` times through the kernel (its launch alone, CUDA
events); with `--check` it also runs once through the eager scan and must
equal it bit for bit. `--ptxas` first prints the register and spill lines
of the kernel's build. One JSON line comes out.

To compare kernels, copy this file into each checkout and run it there,
alternating the checkouts in one call to the card:

    python3 scan_times.py LABEL [--no-mix] [--check] [--ptxas] [--reps N]
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

import chip_smoke as cs
from karpenter_core_tpu_torch.ops import cuda_build
from karpenter_core_tpu_torch.solver.encode import encode_snapshot


def ptxas_lines() -> list:
    """The register, spill and stack lines of pack_scan.cu's build."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "lib.so"), os.path.join(cuda_build.CSRC, "pack_scan.cu")],
            capture_output=True, text=True)
    return [line.strip() for line in proc.stderr.splitlines()
            if any(w in line for w in ("registers", "spill", "stack frame"))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("label")
    ap.add_argument("--no-mix", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args(argv)
    out = {"label": args.label}
    if args.ptxas:
        out["ptxas"] = ptxas_lines()
    cuda_build.build_all(cs.KERNELS)
    pods, provs, its = cs.segmented_mix(**cs.SEGMENT_FULL)
    work = [("17a", pods, provs, its, [], len(pods) // 4 + 256)]
    if not args.no_mix:
        work.append(("mix", *cs.full_mix(), 50000 // 5 + 1536))
    for name, pods, provs, its, nodes, max_nodes in work:
        snap = encode_snapshot(pods, provs, its, None, nodes, max_nodes=max_nodes)
        program = cs.scan_program(snap, provs, max_nodes)
        runs = [cs.run_scan(*program, plain=False) for _ in range(args.reps)]
        if args.check:
            cs.scan_diff(name, runs[-1], cs.run_scan(*program, plain=True))
        out[name] = {"kernel_ms": [round(r["kernel_ms"], 3) for r in runs],
                     "scan": runs[-1]["scan"], "checked": args.check}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
