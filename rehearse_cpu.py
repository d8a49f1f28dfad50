#!/usr/bin/env python3
"""Rehearse chip_smoke.py's main path on the CPU at reduced sizes.

    python3 rehearse_cpu.py 3500 7000 14000

For each pending-pod count n it builds chip_smoke.live_cluster scaled by
n / 50,000 (nodes, generic classes, ingress pods and StatefulSet replicas
alike, 30 bound pods a node) and the reference mix alone with the same
nodes (phase 5's shape), solves both with TorchSolver(device="cpu") and
prints one JSON line: the scan's items and while-iterations per branch
(ops/pack.LAST_SCAN), the solve's phases, and the encode time of each
workload and of the cluster seeding alone (the host Topology built for
three representative pods). These are counts and host times of this CPU,
used to predict a chip run; they are never device metrics.

    python3 rehearse_cpu.py --replan 3500 7000

runs chip_smoke's phase 8 at those sizes on the CPU: the settled live
cluster (nodes scaled by n / 50,000, 30 bound pods a node, no backlog),
the multi-node ladder and the single-node sweep through the port's
consolidation modules, with each replan's K, chunks, prescreen mode,
scanned items and per-subset time, the exact solves, and the commands.

    python3 rehearse_cpu.py --lifecycle 5000

runs chip_smoke's phase 9 at that size on the CPU: phase 8's ladder on
the settled cluster, its Command executed through testing.ControlLoop
(cordons, drains, evictions, terminations), then three Expiration passes
(one a replacement), a Drift pass and an Emptiness pass, each pass's
Command, compute and execute times, steps and exact solves printed, and
the shape of the first Expiration pass's simulate snapshot (the one whose
planes chip_smoke holds the kernels to in phase 9).

    python3 rehearse_cpu.py --operator 5000 100

runs chip_smoke's phase 10 on the CPU with that many pending pods over
that many nodes (the live cluster scaled alike, 30 bound pods a node):
new_operator with a TorchSolver(device="cpu") from the solver factory, step
1 (the backlog solved, launched and nominated), the kubelet pass and step
2 (machines initialized, the counter), each step's wall and its parts
(sync_state, the reconcile, the solve's last_phase_ms, the launch, the
machine, node and termination controllers, the counter), and the shape of
step 1's snapshot (the one whose planes chip_smoke holds the kernels to
in phase 10).

    python3 rehearse_cpu.py --churn 3500 7000

runs chip_smoke's phases 6b and 7 at those sizes on the CPU instead: the
live cluster solved with screen_mode="tiered" beside the prescreen solve
(wall and device times, items), then phase_churn's steady churn, four
steps of bindings, joining machines, terminations and arrivals through
an incremental and a full solver (each step's churn counts, prescreen
mode, delta rows, columns and budgets, and prescreen times).
"""
import json
import sys
import time

import chip_smoke as cs
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (
    Topology,
    build_domains,
)
from karpenter_core_tpu_torch.ops import pack
from karpenter_core_tpu_torch.solver import torch_solver
from karpenter_core_tpu_torch.solver.encode import encode_snapshot


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, round(time.perf_counter() - t0, 3)


def rehearse(n: int) -> dict:
    f = n / 50000
    nodes, distinct = int(1000 * f), int(1000 * f)
    max_nodes = n // 5 + 1536
    (pods, provs, its, client, cluster), build_s = _timed(lambda: cs.live_cluster(
        n, 500, nodes, distinct=distinct, n_ingress=int(1000 * f), replicas=int(100 * f)))
    state_nodes = cluster.nodes()
    solver = torch_solver.TorchSolver(max_nodes=max_nodes, device="cpu")
    result, wall_s = _timed(lambda: solver.solve(pods, provs, its, state_nodes=state_nodes,
                                                 kube_client=client, cluster=cluster))
    scan, phases = dict(pack.LAST_SCAN), dict(solver.last_phase_ms)
    _, encode_s = _timed(lambda: encode_snapshot(pods, provs, its, None, cluster.nodes(),
                                                 client, cluster, max_nodes=max_nodes))
    _, seeding_s = _timed(lambda: Topology(client, cluster, build_domains(provs, its), pods,
                                           update_pods=pods[:3]))
    mix_pods, mix_provs, mix_its, mix_nodes = cs.full_mix(n, 500, nodes, distinct)
    _, mix_encode_s = _timed(lambda: encode_snapshot(mix_pods, mix_provs, mix_its, None,
                                                     mix_nodes, max_nodes=max_nodes))
    torch_solver.TorchSolver(max_nodes=max_nodes, device="cpu").solve(
        mix_pods, mix_provs, mix_its, state_nodes=mix_nodes)
    return {
        "pending": len(pods), "bound": len(cluster.bindings), "build_s": build_s,
        "wall_s": wall_s, "phases_ms": {k: round(v, 1) for k, v in phases.items()},
        "scan": scan, "failed": len(result.failed_pods), "encode_s": encode_s,
        "seeding_s": seeding_s, "mix_encode_s": mix_encode_s, "mix_scan": dict(pack.LAST_SCAN),
    }


def rehearse_churn(n: int) -> dict:
    f = n / 50000
    nodes, distinct = int(1000 * f), int(1000 * f)
    max_nodes = n // 5 + 1536
    pods, provs, its, client, cluster = cs.live_cluster(
        n, 500, nodes, distinct=distinct, n_ingress=int(1000 * f), replicas=int(100 * f))
    solve = {}
    for mode in ("prescreen", "tiered"):
        solver = torch_solver.TorchSolver(max_nodes=max_nodes, device="cpu",
                                          screen_mode=mode, incremental="off")
        _, wall_s = _timed(lambda: solver.solve(pods, provs, its, state_nodes=cluster.nodes(),
                                                kube_client=client, cluster=cluster))
        solve[mode] = {"wall_s": wall_s, "scan": dict(pack.LAST_SCAN),
                       "phases_ms": {k: round(v, 1) for k, v in solver.last_phase_ms.items()}}
    (_l, _f, steps), churn_s = _timed(lambda: cs.phase_churn(
        pods, provs, its, client, cluster, max_nodes, cs._zones(its), device="cpu"))
    return {"pending": len(pods), "nodes": nodes, "solve": solve, "churn_s": churn_s,
            "steps": [{"mode": st["mode"], "delta": st["delta"], "churn": st["churn"],
                       "refresh_ms": round(st["refresh_ms"], 2),
                       "full_ms": round(st["full_ms"], 2)} for st in steps]}


def rehearse_replan(n: int) -> dict:
    nodes = int(1000 * n / 50000)
    (its, client, cluster, clock), build_s = _timed(lambda: cs.settled_cluster(
        n, 500, nodes, distinct=nodes))
    out = cs.phase_consolidation("rehearse", its, client, cluster, clock, device="cpu")
    cs.check_consolidation(out, on_card=False)
    runs = {}
    for kind, run in out["runs"].items():
        runs[kind] = {
            "candidates": len(run["candidates"]), "screened": len(run["screens"]),
            "feasible": run["feasible"], "action": run["cmd"].action,
            "removed": len(run["cmd"].nodes_to_remove), "wall_s": round(run["wall_s"], 3),
            "replans": [{k: rp[k] for k in ("K", "chunks", "prescreen", "scans",
                                            "phases_ms")}
                        | {"ms_per_subset": round(rp["device_ms_per_subset"], 2)}
                        for rp in run["replans"]],
            "solves": [{"pods": s["pods"], "wall_s": round(s["wall_s"], 3)}
                       for s in run["solves"]],
        }
    return {"nodes": nodes, "bound": len(cluster.bindings), "build_s": build_s,
            "runs": runs, "gen2": out["gen2"]}


def rehearse_lifecycle(n: int) -> dict:
    nodes = int(1000 * n / 50000)
    (its, client, cluster, clock), build_s = _timed(lambda: cs.settled_cluster(
        n, 500, nodes, distinct=nodes))
    out = cs.phase_consolidation("rehearse", its, client, cluster, clock, device="cpu")
    lc = cs.Lifecycle("rehearse lifecycle", its, client, clock, device="cpu")
    setup_s = round(lc.step(), 3)
    ladder = cs.execute_ladder(lc, out["runs"]["multi"]["cmd"])
    cs.ttl_passes(lc, expire=3, spot_pinned=1)
    snap, _provs = lc.passes[0]["solves"][0]["snapshot"]
    return {"nodes": nodes, "bound": len(cluster.bindings), "build_s": build_s,
            "simulate_snapshot": {"existing_rows": int(snap.exist_used.shape[0]),
                                  "items": len(snap.item_counts),
                                  "item_pad": int(snap.item_pad)},
            "loop_build_s": round(lc.build_s, 3), "setup_s": setup_s,
            "ladder": {k: v for k, v in ladder.items() if k != "checked"},
            "passes": [{"name": r["name"], "action": r["key"][1], "removed": len(r["key"][2]),
                        "replacements": len(r["key"][3]),
                        "compute_ms": round(r["compute_ms"], 1),
                        "execute_ms": round(r["execute_ms"], 1),
                        "steps_s": [round(w, 3) for w in r["steps_s"]],
                        "solves": [(s["pods"], round(s["wall_s"], 3)) for s in r["solves"]]}
                       for r in lc.passes]}


def rehearse_operator(n: int, nodes: int) -> dict:
    f = n / 50000
    size = (n, 500, nodes, nodes, dict(n_ingress=int(1000 * f), replicas=int(100 * f)))
    out = cs.phase_operator("rehearse operator", size, device="cpu", max_nodes=n // 5 + 1536)
    snap = out["run"].solves[0]["snapshot"][0]
    return {"nodes": nodes, "machines": out["passed"]["machines"],
            "events": out["events"],
            "snapshot": {"existing_rows": int(snap.exist_used.shape[0]),
                         "items": len(snap.item_counts), "item_pad": int(snap.item_pad),
                         "slots": int(snap.n_slots)},
            "steps": [{"name": st["name"], "wall_s": st["wall_s"], "parts_s": st["parts_s"],
                       "solves": [(len(sv["pods"]), round(sv["wall_s"], 3), sv["phases_ms"])
                                  for sv in st["solves"]]} for st in out["steps"]]}


if __name__ == "__main__":
    args = sys.argv[1:]
    if "--operator" in args:
        n, nodes = (int(a) for a in args[args.index("--operator") + 1:][:2])
        print(json.dumps({"n": n, "device": "cpu", **rehearse_operator(n, nodes)}),
              flush=True)
        sys.exit(0)
    modes = {"--churn": rehearse_churn, "--replan": rehearse_replan,
             "--lifecycle": rehearse_lifecycle}
    fn = next((modes[a] for a in args if a in modes), rehearse)
    for arg in [a for a in args if a not in modes] or ["3500"]:
        print(json.dumps({"n": int(arg), "device": "cpu", **fn(int(arg))}), flush=True)
