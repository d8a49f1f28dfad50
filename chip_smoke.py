#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name, power limit and maximum SM clock; build every CUDA
     kernel of the port (nvcc, sm_90a) from the sources in this checkout;
  2. each kernel against its plain PyTorch version on the card, exactly:
     screen_prep (both sides) and the requirement screen in every form
     (block, one slot row against every item, every slot row against one
     item) on random masks with an empty segment and ragged shapes, on
     wide masks, on 40 keys (two-word key bitmasks), and on the exact
     planes of phase 4's snapshot. Then each of the main path's four screen
     shapes (the existing block E x C, the template rows J x C, the virgin
     row 1 x C, and N x 1) is timed: the wrapper, the kernel alone, the
     plain version, and the card's bound;
  3. parity: BASELINE config 2 (5,000 pods with nodeSelector and
     taints/tolerations over 100 instance types, one provisioner, 200
     existing nodes of the ten smallest types) solved on the card and on
     the CPU must place every pod byte-identically; screen launches per
     form are printed;
  3b. parity on topology: BASELINE config 3 (20,000 pods over 200 types:
     16 hostname anti-affinity services, a zonal spread cohort and
     filler; the machine-region bulk fill) and the upstream benchmark's
     largest grid cell (the 5,000-pod diverse mix over 400 types) placed
     byte-identically on the card and on the CPU, every placement checked;
  4. the generic share of the 50k-pod reference mix (21,428 pods in 1,000
     spec classes) over 500 instance types and 1,000 existing nodes, ~12.5k
     slots, solved cold then warm; every placement is checked on the host,
     and both kernels, the screen in its block form, must have been
     launched by these solves;
  3c. parity on a live cluster's inputs: 5,000 pending pods (the
     reference mix over 400 types, host-port and claim pods among them)
     against 200 nodes registered through a Cluster with CSINode attach
     limits and 6,000 pods bound through the kube client (claims, host
     ports, skewed topology cohorts, zonal anti-affinity), placed
     byte-identically on the card and on the CPU, every placement checked;
  5. the whole 50k-pod reference mix (21,428 generic pods, 7,143
     zonal-spread, 7,143 hostname-spread and 14,286 zonal pod-affinity
     pods) with the same types and nodes, cold then warm; every placement
     and every topology constraint is checked on the host, and
     screen_prep and the screen in its block and row_n1 forms must have
     been launched by these solves;
  6. the main path at full width: phase 5's mix as the backlog of a live
     cluster (live_cluster: 1,000 nodes through a Cluster with EBS attach
     limits of 25, 30,000 bound pods in the kube client, 1,000 hostPort-443
     ingress pods and 500 StatefulSet pods with their own claims on top),
     cold then warm through TorchSolver.solve(..., kube_client=...,
     cluster=...); every pod must be placed, every placement, host port,
     attach limit and topology constraint is checked with the cluster's
     pods counted, and screen_prep and the screen in its block and row_n1
     forms must have been launched;
  2 (the tiered shape). the row_b1 form at the tiered screen's real
     shape, after phase 6: the slot planes of a scan of phase 6's snapshot
     on the card (the ~7,500 open slots) against one class row, held
     exactly against screen_plain at several prefixes and timed beside its
     bound;
  6b. phase 6's workload solved with screen_mode="tiered" (the row_b1
     form once per item; one turn, the prescreen's second solve cut to pay
     for phase 16), the solve with the
     launch counts set to 0 just before it and read just after: placements byte-identical to phase
     6's; a tiered solve must launch row_b1 and no block or row_n1;
  7. steady churn at full width: from phase 6's live cluster, fed through
     the kube client's watches and the informers, two consecutive solves
     by an incremental TorchSolver and one with incremental="off"; between
     them the last placements materialise (pods bind on 20 existing nodes,
     5 of the launched machines join as nodes with their pods), bound pods
     terminate, and new pods arrive, among them a new deployment pinned to
     one zone (tens of nodes touched a step). Each solve's launches are
     read on their own; every step byte-identical, the last one checked;
     the first step must run the full precompute, a later one must refresh
     the resident tensor, each prescreen dispatch must launch exactly what
     its delta needs, and no refresh may fail.
  14a, 14c. the solver boundary, right after phase 6 on its cluster: 14a
     phase 6's backlog through a HostSolver (solver/host.py) whose
     supervised child process solves on the card, placements
     byte-identical to phase 6's in-process solve, the child's launches
     (zeroed just before) with screen_prep and the block form among them;
     its spawn, probe, wall, phases here and in the child, and the frames'
     bytes printed. 14c, where grpc and protobuf import (else one line says
     so): serve() on localhost in this process on the card, RemoteSolver
     solving the same backlog (byte-identical) and a three-subset Replan
     of phase 6's snapshot (equal to the in-process replan), the request
     and response bytes printed;
  8. consolidation at full width: phase 6's live cluster built afresh
     without its backlog, at 200 of its 1,000 nodes (6,000 bound pods;
     the depth cut that pays for phases 14, 16, 17 and, from 300 nodes,
     19), and a
     provisioner with consolidation enabled; through the port's
     deprovisioning modules (candidate_nodes, the ProvisioningController, the
     consolidation deprovisioners, solver/replan.py) on a FakeClock with
     validation_ttl = 0, MultiNodeConsolidation (the prefix ladder of <= 8
     rungs and the ride-along empty subset in one replan) and then
     SingleNodeConsolidation (every candidate a singleton, chunks of 64).
     Each replan's phases, K, chunks, prescreen mode, launches and device
     ms per subset, the winning Commands, the feasible subsets and the
     gen-2 collections inside solves are printed; fatal: a fallback to the
     sequential path, no block-form launch, a ladder winner not confirmed
     by an exact solve on the card, a second replan of the unchanged
     cluster that ran the full precompute;
  8b. phase 3c's cluster at half its pods and nodes (2,250 and 100),
     without its backlog: the ladder and every singleton screened on the
     card and on the CPU must give equal verdicts, equal per-slot counts
     and the same Commands.
  9. the deprovisioning chain executed at full width, on phase 8's
     cluster and FakeClock through testing.ControlLoop (its own Cluster fed
     by watches, the machine, node and termination controllers, the
     Terminator and the DeprovisioningController; a TorchSolver on the
     card): one set-up step puts the termination finalizer on every node;
     phase 8's ladder Command is executed, and steps run until no node
     terminates (fatal unless exactly its nodes are gone from the client
     and the Cluster and the evictions equal their pods); then, with
     consolidation off, three Expiration passes (most expired first, the
     second a replacement launched through the fake provider, a Machine
     and a Node that the machine controller registers and initializes), a
     Drift pass (the node controller annotates the nodes) and an Emptiness
     pass (two empty nodes). Each pass must run the named deprovisioner;
     after each the remaining bound pods pass check_placements and
     check_cluster_usage, the Cluster's bindings are the client's, and the
     nodes are those at the start plus the launches minus the deletions.
     Each pass's Command, compute_command and execute times, steps, screen
     launches and exact solves are printed; fatal: a fallback, or no
     block, row_n1 or screen_prep launch in the phase. Then the first
     Expiration pass's simulate snapshot (the remaining nodes against the
     expired node's pods): screen_prep and every screen form exact against
     their plain versions on its planes, and its block, template and
     virgin-row shapes timed beside their bounds (the kernels line's
     numbers);
  9b. at half of phase 8b's size (1,125 pods over 50 nodes, a depth cut
     that pays for phase 16), Expiration, Drift, Emptiness and a
     consolidation pass executed on the card and on the CPU: the same
     Commands and the same final cluster.
  10. the operator, the port's entry point, at full width: phase 6's live
     cluster with its 51,500-pod backlog created in the kube client as
     pending pods and one provisioner whose limits no solve reaches,
     through new_operator with solver/factory.build_solver() on the card
     and a FakeClock. Step 1 (op.step()) solves, launches and nominates:
     one solve whose placements pass check_placements and
     check_cluster_usage, every launch a Machine and a Node in the client,
     the bind listener and the nominations equal to the placed pods, the
     Nominated events kept as the recorder's token bucket allows, no
     fallback and no launch failure. Phase 10 stops there (the depth cut
     that pays for phase 15); its script's second half runs in 10b and
     11: a kubelet pass (launched nodes Ready, pods bound where the bind
     listener was told); step 2 solves nothing, initializes every machine,
     and the counter's status.resources equals the summed capacity of the
     provisioner's nodes; the inflight checks over every node find
     nothing. Each step's wall is printed with its
     parts (sync_state, the reconcile, the solve's last_phase_ms, the
     launch, the machine, node and termination controllers, the counter)
     and its gen-2 collections (count, seconds, and both by the part open
     when each started);
     fatal without a screen_prep, block and row_n1 launch. Then
     screen_prep and every form held exactly against their plain versions
     on step 1's snapshot and timed there (the kernels line's numbers).
     The phase runs instrumented, as a deployment runs: the tracer on, the
     metrics controllers in step(), the provider decorated per controller,
     the registry empty at the start. Fatal: a step-1 span tree other than
     provisioner.reconcile -> solver.solve (context "provisioning") ->
     solver.phase.* with provisioner.launch beside the solve, a phase span
     more than 1 ms from last_phase_ms, karpenter_pending_pods other than
     the backlog after step 1 and (10b, 11) 0 after step 2, and, after
     step 2, an exposition that does not parse line by line, karpenter_nodes_created
     other than the machines launched, node metrics that miss a node, an
     admission-to-bind count other than the pods step 1 decided. It prints
     the tree, each step's parts (the metrics controllers one of them),
     the exposition's bytes, samples and expose() time, and the size of
     the tracer's Chrome trace (exported into the temporary directory);
  10b. phase 10's script at half of 3c's size (2,250 pods of the mix, 150
     ingress and 200 claim pods over 100 nodes with 42 pods bound on each;
     the depth cut that, with phase 8 at 200 nodes and phases 12 and 14b
     at half size, pays for phase 17) on the card and on the CPU: equal
     placements, launched machines' instance-type options, (reason, kind)
     events, counter resources and counters; then, on the card, an ICE
     leg (the type step 1 launched most exhausted in every pool: its
     launches fail and the ICE cache masks it; once the placed pods bind,
     reconcile(wait_timeout=...) fires the re-trigger and re-solves
     exactly the pods left, every one placed, none on the masked type) and
     a cap leg (batch_max_pods=1300: passes of 1,300, each re-triggering
     the batcher, until the backlog is empty);
  11. flight records (the reference's format, armed from phase 8 on)
     replayed on the card: phase 8b's ladder record through
     replay_consolidation (fatal when the chosen Command is not confirmed;
     disagreeing subsets printed with the reason for their direction);
     the record of 10b's step-1 solve, taken through FLIGHTREC.begin and
     finish around the operator's solver, and phase 3's config-2 solve,
     each through JSON and back, restored and solved on the card and on
     the CPU (fatal when the two differ, and for config 2 when the card's
     placements are not byte-identical to the live solve's; 10b's record
     omits its 6,000 bound pods past the 4,096-pod cap, so its difference
     from the live solve is printed, not fatal). Then a live operator
     step() whose record keeps its bound pods: phase 10's script at 2,500
     pods of the mix plus 1,000 ingress pods over 50 nodes (1,500 bound
     pods, under the cap, the zone-3 guards' inverse anti-affinity among
     them; no StatefulSet claims, which the record format cannot carry),
     its step-1 solve recorded and replayed the same way: fatal when the
     card's replay is not byte-identical to the live solve. Phase 8
     prints the time to take its ladder record at full width.
  12. the fallback paths (phase_fallback), at half of phase 3c's pods and
     nodes (2,400 pods over 100 nodes, 18 pods bound a node, 1,800 under
     the recorder's cap, and no StatefulSet claims, so the record holds
     the whole cluster context; the depth cut that, with 10b, pays for
     phase 17):
     12a: solver/fallback.ResilientSolver(build_solver(), GreedySolver(),
     solve_timeout=900, wedge_stale_after=600) with the real subprocess
     card probe, the launch counts set to 0 just before its solve and read
     just after: the card serves, placements byte-identical to an
     unwrapped TorchSolver's, no fallback series moves, the live record is
     "primary" with the "torch" replayer and replays on the card to its
     placements; 12b: a primary that goes silent before it enters
     TorchSolver (WedgeOnce), wedge_stale_after=3 s and a FakeClock for the
     breaker: SolverWedgedError, the breaker open, GreedySolver serving
     every pod, the series moved exactly as the reference's script moves
     them, the "host.primary_error" record replayed through "greedy"
     byte-identically, the abandoned thread reaped; the clock advanced, the
     real probe re-admits the card, whose solve equals 12a's; 12c:
     GreedySolver against the card to the equivalence bar (every
     constraint holds, the card fails no more pods and opens at most one
     machine more), both walls, and the fixed cost of 100 x 10, 100 x 40
     and 200 x 100 batches through TorchSolver and GreedySolver against the
     small-batch work product; 12d: native.NativeSolver(device="cuda") on
     phase 4's topology-free share without its nodes against TorchSolver
     to the same bar, both walls and the g++ build time.
  14b. the wedge drill at a quarter of phase 13's size (QUARTER_SIZE): ResilientSolver around a
     HostSolver (stale_after 3 s, wedge_stale_after=None: the host
     watches) solves once in the child on the card; the child is stopped
     (SIGSTOP) once the next solve's request frame is written; fatal
     unless the watchdog kills its process group, greedy serves every pod,
     no abandoned thread lives, the killed pid is gone (and gone from
     nvidia-smi's compute processes), health() finds the respawned child,
     and the re-admitted solve is byte-identical to an in-process
     TorchSolver's and to the child's first. Prints the kill's delay after
     the SIGSTOP, the respawn's and the recovery's seconds, the card
     memory freed and nvidia-smi's compute processes before and after;
  13. the process entry, last (its collector tuning is process-wide):
     operator/__main__.run() on a thread, on the card, over PHASE12_SIZE's
     cluster (its nodes and bound pods in the kube client, the provisioner
     not consolidating), with leader election and profiling on, the
     metrics port ephemeral, the webhook on where `cryptography` imports
     (else disable_webhook, printed), every tier of the default ladder (S,
     M, L, XL) prewarmed; once the prewarm is ready the 4,800-pod backlog
     is created in the client. The entry's default primary is the solver
     host: the prewarm and the live solves run in its child on the card,
     whose launches are counted (fatal without screen_prep and the block
     form in the live solve), whose boot and health are printed, and whose
     process group must be gone after the stop. Fatal: a primary other
     than the HostSolver, a tier not "compiled" or "cached",
     karpenter_prewarm_ready not 1, the Lease not the elector's, a backlog
     pod not nominated within 180 s, the first live solve's placements
     failing check_placements (the bound pods counted), /healthz, /readyz, /metrics (with the
     karpenter_prewarm_*, karpenter_slo_* and karpenter_solver_* families),
     /debug/health (healthy, the host alive), /debug/config (the injected
     options and settings) or another endpoint (/debug/tenants,
     /debug/timeline and /debug/programs among them) not 200, a fallback,
     a reconcile error
     or a launch failure, and after the stop a thread still alive (the
     reconcile pools' idle workers live for the process) or the lease still
     held. It prints each tier's seconds with the build's apart, the card
     probe's seconds and which solve paid it, the first live solve's wall
     and last_phase_ms, the launches of the prewarm and of the live solves
     by form, and the gen-2 collections while the backlog is served beside
     phase 10's (without the tuning). Then screen_prep and every form held
     exactly against their plain versions on the first live solve's
     snapshot and timed there.
  15. the soak (run right after phase 2, while the heap is small): the
     operator under seeded churn (loadgen.SoakDriver.run(), realtime,
     op.start()'s watch pumps, batcher windows, solves, launches and the
     driver's kubelet binds) with chaos armed. 15a, hack/soak.py --smoke
     --host: seed 42, 12 s, 2.5 arrival events/s, 12 seed nodes, a
     ResilientSolver around a HostSolver at the drill's admission scale
     (its child on the card), a FakeClock warm-up through the same
     primary, state.diff (p 0.05), cloudprovider.create (p 0.02) and one
     solver.host.crash (after 8 consults), then the overload burst; fatal
     unless the loops live, pods bind and none is left unbound, the crash
     fired and the child respawned, the card is re-admitted with no live
     zombie, a post-drill solve through the host is byte-identical to an
     in-process TorchSolver's, and the burst shed with no error, no
     deadline violation and a re-converged latency. 15b, steady churn at
     a cluster's size: 1,000 seed nodes over 400 types, 40 arrival
     events/s (~100 pods/s), 24 terminations and 3.2 resizes a second for
     25 s (30 s before phase 19), the default Settings() batch windows, the same two faults, the
     entry's default primary (a HostSolver in the entry's ResilientSolver);
     every SoakReport column, the card's solves, the fallbacks and small
     batches, the chaos counts and the children's launches by form
     printed; fatal: a dead loop, a pod unbound after a tail of up to 60
     s, no solve served by the card, or a fallback (no armed fault reaches
     the solver in host mode).
  16. the operator over HTTP (right after phase 15), through the port's
     kube/apiserver.py client to the test apiserver of
     testing/apiserver.py (ApiStore: the port's in-memory store behind the
     REST surface, ApiHTTPServer: it on
     127.0.0.1 at an ephemeral port, one thread per connection, watches as
     chunked newline-delimited events). 16a, the race gate on the card: a
     fresh interpreter with the port's testing/lockwatch.py and
     testing/racewatch.py armed before any lock of the port exists runs
     three iterations of tests/test_deflake.py's harness (Operator.start(),
     a random 0-3 ms before each pump delivery, a creator and a deleter
     thread) over ApiServerKubeClient(UrllibTransport(...)) to an
     apiserver served from this process, solving with a ResilientSolver
     around TorchSolver(device="cuda"); fatal: a pod not provisioned, a
     pump's error, a thread left, a fallback, no screen launch, a
     lock-order cycle or an unsuppressed race; the tracked lock sites, the
     instrumented classes and the leg's wall printed. 16b, phase 13 over
     HTTP: a quarter of phase 13's cluster (HTTP_SIZE: 1,200 pods over 50
     nodes) loaded into an apiserver in a process of its own
     (ApiServerProcess) with kube.transport armed there at p 0.005 (an
     injected fault answers 503), run() with its default primary over
     ApiServerKubeClient, every tier prewarmed, the lease over HTTP, the
     backlog created through the server; phase 13's gates, and
     transport retries above zero, no apiserver error, every watch pump
     gone once the client closes; printed: the creation to the last
     nomination (against 48 s), the HTTP requests by verb, the bytes each
     way, LIST pages, the watch connections and reconnects, the retries by
     method and the list() seconds by calling thread and kind.
  17. the segmented pack scan (right after phase 16), each solve with the
     launch counts set to 0 just before it and read just after. 17a:
     bench.py's partitionable mix at full width (50,000 pods of cpu 1 and
     1Gi, 1,000 app labels, over 8 selector-scoped pools of
     testing.make_pool_provisioners and the fake provider's 500 types)
     solved cold then warm by TorchSolver(pack_scan="sequential") and by
     TorchSolver(pack_scan="segmented"); fatal: a placement check failing,
     placements that differ between the scans, a segmented solve with
     other than 8 segments or fixup_fraction 0.0, or one that launched no
     screen_prep, block or pack_scan (the lanes, one launch), or a screen
     call of the cold segmented solve (the partition's template rows, the
     virgin row; the first 32 of each form and every 16th after, up to
     256) that disagrees with its plain version on the same rows; the segments, the
     largest lane, the segment and merge ms beside the sequential device
     ms and the launches by form printed. 17b: tests/test_segmented.py's pool
     partition with existing nodes at phase 3c's scale (5,000 pods over 4
     pools, 100 types, 200 nodes labelled per pool): segmented on the card
     and on the CPU and sequential on the card byte-identical, with equal
     last_segment_stats. 17c, the degradation ladder on 17b's cluster:
     solver.segment armed once gives reason error:<Type>, 400 bulk
     replicas with hostname anti-affinity give "structure", each placed
     as the sequential scan places it. 17d, hack/segment_smoke.py's gates
     at the card's size: new_operator with TorchSolver(pack_scan=
     "segmented") in process over 4,800 pods x 400 types in 8 pools; one
     step nominates every pod through a segmented solve (more than one
     segment, fixup 0.0) byte-identical to a sequential solve of the same
     batch. Then screen_prep and every form held exactly against their
     plain versions on 17b's snapshot and timed there.
  18. the device grid (parallel/; right after phase 17): every visible
     card when there are several, else a 2 x 2 grid of logical devices on
     the card, named in the output beside every number. 18a: 17a's
     workload through ShardedSolver over the grid, sequential and
     segmented (the lanes on the lead), each byte-identical to 17a's cold
     single-card solve of the same scan and timed against it; fatal: a
     solve off the grid, a segmented solve without 17a's segments, no
     screen_prep, block or pack_scan launch; printed: the prescreen, segment
     and device ms beside 17a's, the launches by form and by device, each
     verdict tile's rank, device and launches, the gathers' bytes (and
     those from another device) and the largest gather timed alone. 18b:
     tests/test_solver_factory.py's mixed batch at 3c's size (5,000 pods,
     200 nodes) solved by TorchSolver, then over the grid through
     serve(mesh=grid) and RemoteSolver (Health naming dp and tp) and
     through ResilientSolver(primary=ShardedSolver), both byte-identical
     to TorchSolver's, no fallback. 18c: the verdict tile of the grid's
     last device (its existing rows against its class columns) held
     exactly against screen_plain and timed there, and the process entry
     with KARPENTER_SOLVER_MODE=sharded: its solver host's child serves
     over the grid, a 600-pod backlog is nominated within 180 s through a
     lookup at the child's service_sharded compile-cache site.
  19. the device grid over processes (right after phase 18): this script
     started again as ranks (--dist-rank) through KARPENTER_DIST_COORDINATOR
     on 127.0.0.1 with _NUM_PROCESSES and _PROCESS_ID: on one card two
     ranks with two logical devices each (a 2 x 2 grid, dp over the ranks,
     gloo), on several one rank per card (NCCL). Every rank builds its
     solver through build_solver(mode="sharded"); 19a solves 17a's
     workload at full width (sequential scan), 19b 18b's mixed batch twice
     on one solver (the second the refresh; the verdict tiles' block form
     on every rank). Every rank prints its placements' sha256, wall,
     prescreen and device ms, gathers (bytes, bytes from other ranks,
     collective ms) and launches; fatal: a digest other than 17a's
     single-card sequential solve's (19a) or 18b's TorchSolver's (19b), a
     rank that exits non-zero or still runs at DIST_DEADLINE_S (every rank
     then killed), a solve off the grid, no refresh, a missing launch.
  20. the pack scan as one device program (right after phase 19): every
     scan under the prescreen with a commit log, topology groups included
     (phases 3-7, 10, 13-19 and these), runs as csrc/pack_scan.cu, one
     launch a solve, a segmented solve's lanes its batch. 20a: every
     parity family of tests/test_torch_cuda.py (mixed, relax, bulk, wide,
     spread, affinity, anti, refmix, cluster, ports_vols) through the
     kernel and through the plain (eager) scan on the card; 20c: the
     mixed and refmix families with their logs cut to half their commits
     (the log overflows); 20d: the bulk, ports_vols and anti families
     with a bulk take budget of one row (the existing slots then go
     through candidate verify; anti's bulk region is the whole slot
     axis); 20b: 17a's workload at full width, sequential and segmented,
     each solved with the kernel and with the plain scan, and the
     sequential scan alone on one solve program's inputs; 20e: phase 5's
     workload (the full reference mix, 50,000 pods x 500 types over 1,000
     nodes: zonal and hostname spread, zonal affinity) solved with the
     kernel and with the plain scan in fresh solvers, then its scan alone
     both ways. Fatal: a log, ptr, PackState field (the topology counts
     included) or final verdict tensor that differs (floats bit for bit),
     a 20d scan with no candidate commit on an existing slot, placements
     whose sha256 is not 17a's (20b) or not the plain solve's (20e), a
     kernel solve that is not one pack_scan launch or launches a row_n1
     of its own. Printed: each scan's kernel ms alone (CUDA events), the
     run against the plain scan's, the solves' device ms with each, the
     bound, the longest launch against WEDGE_STALE_S. Phases 3b, 5, 6 and
     10 print their device ms and row_n1 launches and fail on a scan off
     the kernel; phase 13 prints its first live solve's device ms.
Phase 1 builds the native packer (g++, native/fast_pack.cpp) beside the
CUDA kernels. Phases 4-6 solve with incremental="off", so their warm solves
run the full precompute as before. It prints one JSON line describing
every kernel (the screen, screen_prep, the screen's three forms and
pack_scan, with their launches over phases 4-10, 12a and 13-19, the solver host's
children's, the gRPC service's, 16a's child's and phase 19's ranks'
summed in), then as its last line
{"ok": true, "device": {...}}. Without a CUDA card it exits non-zero.

    python3 chip_smoke.py --profile

adds a third main-path (phase 6) solve under torch.profiler, and one with
screen_mode="tiered", and prints for each the device's busy share, its
costliest device operations and the host's operator count and time.
"""
import contextlib
import copy
import gc
import hashlib
import json
import os
import pickle
import re
import resource
import signal
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from karpenter_core_tpu_torch import chaos, loadgen, native, testing  # noqa: E402
from karpenter_core_tpu_torch.api import settings as api_settings  # noqa: E402
from karpenter_core_tpu_torch.api.machine import CONDITION_MACHINE_INITIALIZED  # noqa: E402
from karpenter_core_tpu_torch.api.labels import (  # noqa: E402
    LABEL_CAPACITY_TYPE,
    LABEL_NODE_INITIALIZED,
    PROVISIONER_NAME_LABEL_KEY,
    VOLUNTARY_DISRUPTION_ANNOTATION_KEY,
)
from karpenter_core_tpu_torch.api.provisioner import (  # noqa: E402
    Consolidation as ProvisionerConsolidation,
)
from karpenter_core_tpu_torch.cloudprovider import fake  # noqa: E402
from karpenter_core_tpu_torch.controllers.deprovisioning import (  # noqa: E402
    consolidation,
)
from karpenter_core_tpu_torch.controllers.deprovisioning import (  # noqa: E402
    controller as deprovisioning_ctrl,
)
from karpenter_core_tpu_torch.controllers.deprovisioning.core import (  # noqa: E402
    candidate_nodes,
)
from karpenter_core_tpu_torch.controllers.provisioning import provisioner  # noqa: E402
from karpenter_core_tpu_torch.controllers.provisioning.provisioner import (  # noqa: E402
    ProvisioningController,
)
from karpenter_core_tpu_torch.events import Recorder  # noqa: E402
from karpenter_core_tpu_torch.kube.apiserver import (  # noqa: E402
    KUBE_TRANSPORT_RETRIES,
    ApiServerKubeClient,
    UrllibTransport,
)
from karpenter_core_tpu_torch.kube.client import InMemoryKubeClient  # noqa: E402
from karpenter_core_tpu_torch.metrics.registry import REGISTRY  # noqa: E402
from karpenter_core_tpu_torch.obs import (  # noqa: E402
    FLIGHTREC,
    LOG_SINK,
    TRACER,
    flightrec,
    proghealth,
)
from karpenter_core_tpu_torch.kube.objects import (  # noqa: E402
    LABEL_HOSTNAME,
    Condition,
    LABEL_INSTANCE_TYPE_STABLE,
    LABEL_TOPOLOGY_ZONE,
    LabelSelector,
    PodAffinityTerm,
    Taint,
    Toleration,
    TopologySpreadConstraint,
)
from karpenter_core_tpu_torch.operator import __main__ as entry  # noqa: E402
from karpenter_core_tpu_torch.operator import controller as operator_controller  # noqa: E402
from karpenter_core_tpu_torch.operator import leaderelection, new_operator  # noqa: E402
from karpenter_core_tpu_torch.operator.options import parse_options  # noqa: E402
from karpenter_core_tpu_torch.ops import cuda_build, pack, pack_scan, screen  # noqa: E402
from karpenter_core_tpu_torch.ops.pack import ScreenOps, class_planes  # noqa: E402
from karpenter_core_tpu_torch.parallel import specs  # noqa: E402
from karpenter_core_tpu_torch.parallel.sharded import ShardedSolver  # noqa: E402
from karpenter_core_tpu_torch.parallel.specs import DeviceGrid  # noqa: E402
from karpenter_core_tpu_torch.scheduling import taints as taints_mod  # noqa: E402
from karpenter_core_tpu_torch.scheduling.requirement import Requirement  # noqa: E402
from karpenter_core_tpu_torch.scheduling.requirements import Requirements  # noqa: E402
from karpenter_core_tpu_torch.solver import torch_solver  # noqa: E402
from karpenter_core_tpu_torch.solver import fallback, incremental  # noqa: E402
from karpenter_core_tpu_torch.solver import prewarm as prewarm_mod  # noqa: E402
from karpenter_core_tpu_torch.solver import replan  # noqa: E402
from karpenter_core_tpu_torch.solver.encode import encode_snapshot  # noqa: E402
from karpenter_core_tpu_torch.solver import host as host_mod  # noqa: E402
from karpenter_core_tpu_torch.solver import factory  # noqa: E402
from karpenter_core_tpu_torch.solver.factory import build_solver, describe  # noqa: E402
from karpenter_core_tpu_torch.solver.host import HostSolver  # noqa: E402
from karpenter_core_tpu_torch.state import informer  # noqa: E402
from karpenter_core_tpu_torch.state.cluster import Cluster  # noqa: E402
from karpenter_core_tpu_torch.state.node import StateNode  # noqa: E402
from karpenter_core_tpu_torch.testing.apiserver import (  # noqa: E402
    ApiHTTPServer,
    ApiServerProcess,
    ApiStore,
)
from karpenter_core_tpu_torch.testing.racegate import (  # noqa: E402
    RACE_ARM,
    deflake_iteration,
    race_report,
)
from karpenter_core_tpu_torch.utils import compilecache, gctuning, resources  # noqa: E402
from karpenter_core_tpu_torch.webhooks.server import HAVE_CRYPTOGRAPHY  # noqa: E402
from karpenter_core_tpu_torch.utils.podutils import (  # noqa: E402
    is_owned_by_daemonset as pod_of_daemonset,
    is_terminal as pod_terminal,
)

# H100 SXM peaks at the 700 W limit (NVIDIA H100 data sheet): HBM
# bandwidth, and the dense int8 tensor-core rate (without sparsity)
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
# 32-bit integer add and logical operations issue at 64 results per clock
# per SM on compute capability 9.0, half the float32 FMA rate (CUDA C++
# Programming Guide, arithmetic instruction throughput table); times the
# card's SMs and its maximum SM clock (nvidia-smi clocks.max.sm)
INT32_OPS_PER_CLOCK_PER_SM = 64
# csrc/screen.cu holds both screen and screen_prep; csrc/pack_scan.cu the scan
KERNELS = ["screen", "pack_scan"]


def say(msg: str) -> None:
    print(msg, flush=True)


# -- workloads -----------------------------------------------------------

def _node(i: int, universe):
    """Existing node i: an initialized provisioned node of type i (mod
    the universe) in zone i % 3 (bench.py's _existing_nodes)."""
    it = universe[i % len(universe)]
    return testing.make_node(
        name=f"node-{i}",
        labels={
            PROVISIONER_NAME_LABEL_KEY: "default",
            LABEL_NODE_INITIALIZED: "true",
            LABEL_INSTANCE_TYPE_STABLE: it.name,
            LABEL_CAPACITY_TYPE: "on-demand",
            LABEL_TOPOLOGY_ZONE: f"test-zone-{1 + i % 3}",
        },
        capacity={k: str(v) for k, v in it.capacity.items()},
    )


def existing_nodes(n: int, universe):
    """n existing nodes over the type universe, 3 zones."""
    return [StateNode(_node(i, universe)) for i in range(n)]


def config2(n_pods=5000, n_types=100, n_nodes=200):
    """BASELINE config 2 (bench.py's config2 grid cell) plus existing nodes
    of the ten smallest types, so the batch both fills existing nodes and
    opens machines."""
    taint = Taint(key="dedicated", value="batch", effect="NoSchedule")
    tol = Toleration(key="dedicated", operator="Equal", value="batch")
    pods = []
    for i in range(n_pods):
        if i % 2:
            pods.append(testing.make_pod(
                name=f"c2-{i}", requests={"cpu": "1"}, tolerations=[tol],
                node_selector={LABEL_TOPOLOGY_ZONE: f"test-zone-{1 + i % 3}"},
                uid=f"uid-c2-{i:06d}", creation_timestamp=1000.0))
        else:
            pods.append(testing.make_pod(
                name=f"c2-{i}", requests={"cpu": "1", "memory": "1Gi"},
                tolerations=[tol], uid=f"uid-c2-{i:06d}", creation_timestamp=1000.0))
    universe = fake.instance_types(n_types)
    provisioners = [testing.make_provisioner(name="default", taints=[taint])]
    return pods, provisioners, {"default": universe}, existing_nodes(n_nodes, universe[:10])


def reference_mix(n_pods=50000, n_types=500, distinct=1, generic_only=False):
    """bench.py's _reference_mix(n_pods, n_types, distinct), the upstream
    benchmark's diverse mix (scheduling_benchmark_test.go:187-199): of
    every 7 pods 1 zonal spread, 1 hostname spread, 2 zonal pod affinity
    (all maxSkew 1, DoNotSchedule, selecting their own kind) and 3 generic
    1 cpu / 1Gi pods in `distinct` label classes. The constraint objects
    are shared across pods, as a deployment's are. generic_only keeps the
    generic share alone. Returns (pods, provisioners, instance types)."""
    sel = lambda app: LabelSelector(match_labels={"app": app})  # noqa: E731
    zonal = TopologySpreadConstraint(1, LABEL_TOPOLOGY_ZONE, "DoNotSchedule", sel("spread"))
    hostname = TopologySpreadConstraint(1, LABEL_HOSTNAME, "DoNotSchedule", sel("hspread"))
    affinity = PodAffinityTerm(topology_key=LABEL_TOPOLOGY_ZONE, label_selector=sel("aff"))
    pods = []
    for i in range(n_pods):
        kind = i % 7
        if kind >= 4:
            name, kw = f"gen-{i}", dict(
                labels={"app": f"gen-0-{i % max(distinct, 1)}"},
                requests={"cpu": "1", "memory": "1Gi"})
        elif generic_only:
            continue
        elif kind == 0:
            name, kw = f"spread-{i}", dict(labels={"app": "spread"}, requests={"cpu": "1"},
                                           topology_spread=[zonal])
        elif kind == 1:
            name, kw = f"hspread-{i}", dict(labels={"app": "hspread"}, requests={"cpu": "1"},
                                            topology_spread=[hostname])
        else:
            name, kw = f"aff-{i}", dict(labels={"app": "aff"}, requests={"cpu": "1"},
                                        pod_affinity_required=[affinity])
        pods.append(testing.make_pod(name=name, uid=f"uid-{i:06d}",
                                     creation_timestamp=1000.0, **kw))
    return pods, [testing.make_provisioner(name="default")], {
        "default": fake.instance_types(n_types)}


def generic_mix(n_pods=50000, n_types=500, n_nodes=1000, distinct=1000):
    """Phase 4: the generic share of reference_mix plus bench.py's
    existing nodes."""
    pods, provisioners, its = reference_mix(n_pods, n_types, distinct, generic_only=True)
    return pods, provisioners, its, existing_nodes(n_nodes, its["default"])


def full_mix(n_pods=50000, n_types=500, n_nodes=1000, distinct=1000):
    """Phase 5: the whole reference mix plus bench.py's existing nodes."""
    pods, provisioners, its = reference_mix(n_pods, n_types, distinct)
    return pods, provisioners, its, existing_nodes(n_nodes, its["default"])


EBS = "ebs.csi.aws.com"
# Kubernetes' default EBS attach limit on Nitro instances
# (DefaultMaxEBSNitroVolumeLimit)
EBS_NITRO_LIMIT = 25


def live_cluster(n_pods=50000, n_types=500, n_nodes=1000, distinct=1000, per_node=30,
                 n_ingress=1000, n_sets=5, replicas=100, clock=None):
    """Phase 6: the reference mix as a live cluster's backlog. Every node
    is registered through a Cluster with a CSINode that gives the EBS
    driver its Nitro attach limit; `per_node` pods are bound on each node
    through the kube client and the Cluster: on node i, i % 26 pods each
    mounting its own EBS claim; on every fourth node one pod holding
    hostPort 443 (on every eighth of those with a specific hostIP); the
    zonal-spread cohort 3 : 2 : 1 over the zones, the hostname-spread
    cohort on every fifth node, the affinity cohort in test-zone-2 only,
    on three zone-3 nodes a pod with required zonal anti-affinity
    against one generic class, and filler. Pending on top of the mix:
    `n_ingress` ingress-like pods with hostPort 443 and `n_sets`
    StatefulSets of `replicas` pods, each with its own EBS claim. `clock`
    is the Cluster's (time.time by default).
    Returns (pods, provisioners, instance types, kube client, cluster)."""
    pods, provisioners, its = reference_mix(n_pods, n_types, distinct)
    universe = its["default"]
    client = InMemoryKubeClient()
    cluster = Cluster(client, clock=clock)
    client.create(testing.make_storage_class("ebs", provisioner=EBS))
    for i in range(n_nodes):
        node = _node(i, universe)
        client.create(node)
        client.create(testing.make_csinode(node.name, EBS, allocatable=EBS_NITRO_LIMIT))
        cluster.update_node(node)
    guard = PodAffinityTerm(topology_key=LABEL_TOPOLOGY_ZONE, label_selector=LabelSelector(
        match_labels={"app": f"gen-0-{4 % max(distinct, 1)}"}))
    for i in range(n_nodes):
        name = f"node-{i}"
        zone = i % 3
        bound = []

        def pod(tag, **kw):
            p = testing.make_pod(name=f"run-{i}-{tag}", node_name=name, unschedulable=False,
                                 phase="Running", requests={"cpu": "25m", "memory": "64Mi"},
                                 uid=f"uid-run-{i}-{tag}", creation_timestamp=900.0, **kw)
            bound.append(p)
            return p

        for j in range(i % 26):
            claim = f"data-{i}-{j}"
            client.create(testing.make_pvc(claim, storage_class="ebs"))
            pod(f"v{j}", labels={"app": f"db-{i % 7}"}).spec.volumes.append(
                testing.pvc_volume(claim))
        if i % 4 == 0:
            p = pod("ingress", labels={"app": "ingress"}, host_ports=[443])
            if i % 32 == 0:
                p.spec.containers[0].ports[0].host_ip = f"10.{i // 256}.{i % 256}.1"
        for j in range(3 - zone):
            pod(f"s{j}", labels={"app": "spread"})
        if i % 5 == 0:
            pod("h", labels={"app": "hspread"})
        if zone == 1:
            pod("a", labels={"app": "aff"})
        if zone == 2 and i < 9:
            pod("guard", labels={"app": "guard"}, pod_anti_affinity_required=[guard])
        for j in range(per_node - len(bound)):
            pod(f"f{j}", labels={"app": f"web-{i % 10}"})
        for p in bound:
            client.create(p)
            cluster.update_pod(p)
    for k in range(n_ingress):
        pods.append(testing.make_pod(
            name=f"ingress-{k}", labels={"app": "ingress-new"}, host_ports=[443],
            requests={"cpu": "2", "memory": "2Gi"}, uid=f"uid-ing-{k:06d}",
            creation_timestamp=1000.0))
    for s_ in range(n_sets):
        for r in range(replicas):
            claim = f"db-{s_}-{r}"
            client.create(testing.make_pvc(claim, storage_class="ebs"))
            p = testing.make_pod(name=claim, labels={"app": f"sts-{s_}"},
                                 requests={"cpu": "2", "memory": "4Gi"},
                                 uid=f"uid-sts-{s_}-{r:04d}", creation_timestamp=1000.0)
            p.spec.volumes.append(testing.pvc_volume(claim))
            pods.append(p)
    return pods, provisioners, its, client, cluster


def config3(n_pods=20000, n_types=200):
    """BASELINE config 3 (bench.py's config3 grid cell): of every 4 pods
    one replica of 16 services whose replicas repel over hostname, one of
    a zonal DoNotSchedule spread cohort, two generic fillers."""
    zonal = TopologySpreadConstraint(1, LABEL_TOPOLOGY_ZONE, "DoNotSchedule",
                                     LabelSelector(match_labels={"app": "spread"}))
    n_groups = 16
    pods = []
    for i in range(n_pods):
        kind = i % 4
        if kind == 0:
            group = f"anti-{i % (4 * n_groups) // 4}"
            kw = dict(labels={"app": group}, requests={"cpu": "1"},
                      pod_anti_affinity_required=[PodAffinityTerm(
                          topology_key=LABEL_HOSTNAME,
                          label_selector=LabelSelector(match_labels={"app": group}))])
        elif kind == 1:
            kw = dict(labels={"app": "spread"}, requests={"cpu": "1"},
                      topology_spread=[zonal])
        else:
            kw = dict(requests={"cpu": "1", "memory": "1Gi"})
        pods.append(testing.make_pod(name=f"c3-{i}", uid=f"uid-c3-{i:06d}",
                                     creation_timestamp=1000.0, **kw))
    return pods, [testing.make_provisioner(name="default")], {
        "default": fake.instance_types(n_types)}


# -- timing and bounds -----------------------------------------------------

def time_on_card(fn, reps: int = 20, busy_cycles: int = 0) -> float:
    """Milliseconds per call: CUDA events around `reps` calls, after a
    warm-up, on the current stream. With busy_cycles the card first spins
    that long, so the host enqueues every call before the first one runs
    and the events time the device work alone (no host launch gaps)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if busy_cycles:
        torch.cuda._sleep(busy_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 50) -> float:
    """Milliseconds of host time per call: what the caller's thread spends
    in the wrapper (Python, checks, allocation, launches), with no
    synchronize inside the timed loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def _bound(bytes_moved: int, tensor_ops: int, int_ops: int, int_rate: float) -> dict:
    times = {
        "bytes": bytes_moved / HBM_BYTES_PER_S * 1e3,
        "tensor int8 operations": tensor_ops / INT8_TENSOR_OPS_PER_S * 1e3,
        "32-bit operations": int_ops / int_rate * 1e3,
    }
    worst = max(times, key=times.get)
    return {
        "bound_ms": times[worst],
        "bound_by": "bytes" if worst == "bytes" else "operations",
        "bound_detail": worst,
        "bytes": bytes_moved, "tensor_ops": tensor_ops, "int_ops": int_ops,
    }


def screen_bound(form: str, N: int, B: int, layout, int_rate: float) -> dict:
    """The least time the card could take for one screen launch on
    prepared sides. Bytes: the prepared value planes the form reads (int8
    bytes for the block form, packed words for the row forms) and the key
    bitmasks (3 words a slot row, 4 an item row, per key group), each read
    once, and one verdict byte per pair written. Operations: the block
    form's contraction, 2 N B 32 W int8 operations on the tensor cores;
    on the SIMT cores, per pair, a test and a set for each key that has
    words and ~12 bitmask operations for each group of 32 keys, plus for
    the row forms an AND and an OR per word."""
    W, KW = layout.n_words, layout.KW
    keys = len(set(layout.word_key.tolist()))
    flag_bytes = (3 * N + 4 * B) * KW * 4
    if form == "block":
        return _bound((N + B) * 32 * W + flag_bytes + N * B, 2 * N * B * 32 * W,
                      N * B * (2 * keys + 12 * KW), int_rate)
    return _bound((N + B) * W * 4 + flag_bytes + N * B, 0,
                  N * B * (2 * W + 2 * keys + 12 * KW), int_rate)


def prep_bound(R: int, layout, item_side: bool, words: bool, planes: bool,
               int_rate: float) -> dict:
    """One prep launch over R rows: the bool planes read once (allow cut to
    the width, out and defined, plus escape and deny on the item side) and
    the words, bytes and key bitmasks written; ~8 32-bit operations per
    value bit (gather, test, two ballots, store)."""
    W, K, KW = layout.n_words, layout.K, layout.KW
    read = R * (layout.width + (4 if item_side else 2) * K)
    written = R * (4 * W * words + 32 * W * planes + 4 * KW * 4)
    return _bound(read + written, 0, R * 32 * W * 8, int_rate)


# -- phase 2: kernels against their plain versions --------------------------

def _random_planes(rng, N, B, segments, device):
    V, K = segments[-1][1], len(segments)
    slot = {"allow": rng.random((N, V)) < 0.7, "out": rng.random((N, K)) < 0.3,
            "defined": rng.random((N, K)) < 0.6}
    items = {"allow": rng.random((B, V)) < 0.6, "out": rng.random((B, K)) < 0.3,
             "defined": rng.random((B, K)) < 0.7, "escape": rng.random((B, K)) < 0.2,
             "custom_deny": rng.random((B, K)) < 0.2}
    to = lambda d: {k: torch.from_numpy(v).to(device) for k, v in d.items()}  # noqa: E731
    return to(slot), to(items)


def _plain(slot, items, layout, rows=slice(None)):
    w = layout.width
    cut = {k: (v[rows, :w] if k == "allow" else v[rows]) for k, v in items.items()}
    return screen.screen_plain(slot["allow"][:, :w], slot["out"], slot["defined"], cut,
                               layout.segments, layout.every_key)


def check_prep(slot, items, layout) -> int:
    """screen_prep of both sides against screen_prep_plain: mismatching
    elements over words, bytes and key bitmasks."""
    bad = 0
    for planes, extra in ((slot, {}), (items, {k: items[k] for k in ("escape", "custom_deny")})):
        got = screen.screen_prep(planes["allow"], planes["out"], planes["defined"], layout,
                                 **extra)
        want = screen.screen_prep_plain(planes["allow"], planes["out"], planes["defined"],
                                        layout, **extra)
        torch.cuda.synchronize()
        bad += sum(int((got[k] != want[k]).sum()) for k in ("words", "bytes", "flags"))
    return bad


def check_screen_case(name, slot, items, segments, width):
    """screen_prep and every form of the screen against their plain
    versions on the same card tensors. Returns the largest absolute
    difference (0 or 1 for bool verdicts and bit planes)."""
    worst = 0
    for every_key in (False, True):
        layout = screen.ScreenLayout(segments, width, every_key=every_key)
        si = screen.ScreenItems(items, layout)
        prep_bad = check_prep(slot, items, layout)
        got = screen.screen_block(slot["allow"], slot["out"], slot["defined"], si, layout)
        want = _plain(slot, items, layout)
        torch.cuda.synchronize()
        diff = int((got != want).sum())
        B, N = si.B, slot["allow"].shape[0]
        for b in sorted({0, 1 % B, B - 1}):  # row_b1: every slot row against item b
            row = screen.screen_row(slot["allow"], slot["out"], slot["defined"], si, b, layout)
            diff += int((row != want[:, b]).sum())
        for n in sorted({0, N // 2, N - 1}):  # row_n1: one slot row against every item
            one = {k: v[n:n + 1] for k, v in slot.items()}
            got_n = screen.screen_block(one["allow"], one["out"], one["defined"], si, layout)
            diff += int((got_n != want[n:n + 1]).sum())
        torch.cuda.synchronize()
        worst = max(worst, 1 if diff or prep_bad else 0)
        say(f"[screen] {name}: N={N} B={B} V={items['allow'].shape[1]} width={width} "
            f"K={layout.K} every_key={every_key} words={layout.n_words} "
            f"mismatches: screen {diff}, prep {prep_bad}")
    if worst:
        raise AssertionError(f"screen kernels disagree with their plain versions on {name}")
    return worst


def _segments(lengths):
    bounds = np.cumsum([0] + list(lengths))
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def time_shape(name, rows, items_pl, layout, b, int_rate: float, busy_cycles: int) -> dict:
    """One screen shape of the main path: the wrapper checked exactly
    against screen_plain, then timed (the wrapper, the kernel alone, the
    slot prep, the plain version) beside the card's bounds. `b` is the
    item row of the B = 1 form, or None for every item."""
    K = rows["out"].shape[1]
    N = rows["allow"].shape[0]
    form = screen.form_of(N, items_pl.B if b is None else 1)
    s_args = (rows["allow"], rows["out"], rows["defined"])
    if b is None:
        wrapper = lambda: screen.screen_block(*s_args, items_pl, layout)  # noqa: E731
        plain = lambda: _plain(rows, items_pl.planes, layout)  # noqa: E731
    else:
        wrapper = lambda: screen.screen_row(*s_args, items_pl, b, layout)  # noqa: E731
        plain = lambda: _plain(rows, items_pl.planes, layout, slice(b, b + 1))  # noqa: E731
    want = plain()
    got = wrapper()
    torch.cuda.synchronize()
    if not torch.equal(got.reshape(want.shape), want):
        raise AssertionError(f"screen disagrees with screen_plain at {name}")
    slot_prep = screen.screen_prep(*s_args, layout, words=form != "block",
                                   planes=form == "block")
    kernel = lambda: screen._launch(form, slot_prep, items_pl, b or 0, layout, N)  # noqa: E731
    prep_kernel = lambda: screen.screen_prep(*s_args, layout, words=form != "block",  # noqa: E731
                                             planes=form == "block")
    B = items_pl.B if b is None else 1
    # ms: a wrapper call as the caller sees it (screen_block / screen_row:
    # slot prep and screen; screen_prep alone for prep_ms), host gaps
    # included; kernel_ms: the one launch alone, the card kept busy
    stats = {
        "form": form, "N": N, "B": B,
        "ms": time_on_card(wrapper, reps=50),
        "host_ms": host_ms(wrapper),
        "kernel_ms": time_on_card(kernel, reps=50, busy_cycles=busy_cycles),
        "prep_ms": time_on_card(prep_kernel, reps=50),
        "prep_kernel_ms": time_on_card(prep_kernel, reps=50, busy_cycles=busy_cycles),
        "plain_ms": time_on_card(plain, reps=5),
        **screen_bound(form, N, B, layout, int_rate),
    }
    prep_b = prep_bound(N, layout, False, form != "block", form == "block", int_rate)
    stats["prep_bound_ms"], stats["prep_bound_by"] = prep_b["bound_ms"], prep_b["bound_by"]
    say(f"[screen] {name} ({form}, N={N} B={B} width={layout.width} K={K} "
        f"words={layout.n_words}): wrapper {stats['ms']:.4f} ms ({stats['host_ms']:.4f} ms "
        f"of it host time), screen kernel {stats['kernel_ms']:.4f} ms, slot prep "
        f"wrapper {stats['prep_ms']:.4f} ms, kernel {stats['prep_kernel_ms']:.4f} ms, "
        f"plain {stats['plain_ms']:.4f} ms; screen bound {stats['bound_ms']:.6f} ms by "
        f"{stats['bound_detail']} ({stats['bytes']} bytes, {stats['tensor_ops']} tensor "
        f"ops, {stats['int_ops']} 32-bit ops), slot prep bound "
        f"{stats['prep_bound_ms']:.6f} ms by {prep_b['bound_detail']}")
    return stats


def phase_tiered_shape(snap, provs, max_nodes: int, int_rate: float, busy_cycles: int):
    """Phase 2's tiered shape: the row_b1 form at the tiered screen's real
    shape, every open slot row of the main path's scan against one class
    row. The slot planes are those of phase 6's snapshot after a scan on
    the card (nopen ~7,500 rows); row_b1 is held exactly against
    screen_plain at several prefixes and class rows, then timed at the
    full prefix."""
    dev = torch.device("cuda")
    geom = torch_solver.solve_geometry(snap, max_nodes)
    N, segments, zone_seg, ct_seg, log_len, screen_v = (
        geom[7], list(geom[8]), geom[9], geom[10], geom[12], geom[16])
    targs = torch_solver.args_to_torch(torch_solver.device_args(snap, provs), dev)
    screen0 = pack.make_prescreen_kernel(segments, N, screen_v=screen_v)(targs[0], targs[9])
    _log, _ptr, state = torch_solver.make_device_run(
        segments, zone_seg, ct_seg, snap.topo_meta, N, log_len, screen_v=screen_v)(
        screen0, *targs)
    nopen = int(state.nopen)
    V = state.allow.shape[1]
    ops = ScreenOps(segments, V, screen_v)
    items_pl = class_planes(targs[0], ops)
    C = items_pl.B
    bad = 0
    for lim in sorted({min(1024, nopen), nopen // 2, nopen}):
        rows = {k: getattr(state, k)[:lim] for k in ("allow", "out", "defined")}
        for b in sorted({0, C // 2, C - 1}):
            got = screen.screen_row(rows["allow"], rows["out"], rows["defined"], items_pl, b,
                                    ops.row_layout)
            want = _plain(rows, items_pl.planes, ops.row_layout, slice(b, b + 1))[:, 0]
            bad += int((got != want).sum())
    torch.cuda.synchronize()
    say(f"[screen] tiered shape: nopen {nopen} of N={N} slots, C={C} class rows; row_b1 "
        f"against screen_plain at prefixes up to {nopen} rows: {bad} mismatches")
    if bad:
        raise AssertionError("row_b1 disagrees with screen_plain at the tiered shape")
    rows = {k: getattr(state, k)[:nopen] for k in ("allow", "out", "defined")}
    stats = time_shape(f"tiered nopen x 1 ({nopen} open slots)", rows, items_pl,
                       ops.row_layout, C // 2, int_rate, busy_cycles)
    stats["max_abs_err"] = float(bad > 0)
    return stats


def phase_kernels(main_snapshot, int_rate: float, busy_cycles: int):
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    worst = 0
    # random masks with an empty segment, ragged N, B and V
    segs = [(0, 3), (3, 3), (3, 10), (10, 40), (40, 41), (41, 170), (170, 171)]
    slot, items = _random_planes(rng, 1037, 333, segs, dev)
    worst = max(worst, check_screen_case("random", slot, items, segs, 171))
    worst = max(worst, check_screen_case("random-cut", slot, items, segs, 41))
    # wide masks: keys spanning many words, many double-buffered stages
    segs = _segments([3, 2500, 1, 0, 1900, 77, 1500])
    slot, items = _random_planes(rng, 2048, 512, segs, dev)
    worst = max(worst, check_screen_case("wide", slot, items, segs, segs[-1][1]))
    # 40 keys: two-word key bitmasks
    segs = _segments(rng.integers(0, 40, size=40))
    slot, items = _random_planes(rng, 700, 300, segs, dev)
    worst = max(worst, check_screen_case("40-keys", slot, items, segs, segs[-1][1] - 9))

    # the exact planes of the main path's prescreen and template rows
    shapes = snapshot_shapes("main path", main_snapshot, None, int_rate, busy_cycles,
                             one_class=True)
    shapes["max_abs_err"] = float(max(worst, shapes["max_abs_err"]))
    return shapes


def snapshot_shapes(label, snap, provisioners, int_rate: float, busy_cycles: int,
                    one_class: bool = False) -> dict:
    """The screen's shapes on one snapshot's own planes, as its prescreen
    and scan call them (ops/pack.py): screen_prep and every form held
    exactly against their plain versions on the existing rows and the
    class planes (check_screen_case), then each shape timed beside its
    bound (time_shape): the existing block E x C, the template rows, the
    virgin row 1 x C (a slot's in-scan re-screen has this shape) and,
    with one_class, one class row N x 1; and the item side's prep."""
    dev = torch.device("cuda")
    args = torch_solver.args_to_torch(torch_solver.device_args(snap, provisioners), dev)
    geom = torch_solver.solve_geometry(snap, 0)
    segments, screen_v = list(geom[8]), geom[16]
    pod_arrays, tmpl, exist = args[0], args[1], args[9]
    V, K = exist["allow"].shape[1], exist["out"].shape[1]
    ops = ScreenOps(segments, V, screen_v)
    items_pl = class_planes(pod_arrays, ops)
    e_rows = {k: exist[k] for k in ("allow", "out", "defined")}
    worst = check_screen_case(f"{label} snapshot", e_rows, items_pl.planes, segments,
                              screen_v)

    virgin = {"allow": torch.ones((1, V), dtype=torch.bool, device=dev),
              "out": torch.ones((1, K), dtype=torch.bool, device=dev),
              "defined": torch.zeros((1, K), dtype=torch.bool, device=dev)}
    t_rows = {k: tmpl[k] for k in ("allow", "out", "defined")}
    shapes = [  # (name, slot rows, layout, item row or None for every item)
        ("existing block E x C", e_rows, ops.rows_layout, None),
        ("template rows J x C", t_rows, ops.rows_layout, None),
        ("virgin row 1 x C", virgin, ops.row_layout, None),
    ] + ([("one class N x 1", e_rows, ops.row_layout, 0)] if one_class else [])
    timed = {name: time_shape(f"{label}: {name}", rows, items_pl, layout, b, int_rate,
                              busy_cycles)
             for name, rows, layout, b in shapes}
    blk = timed["existing block E x C"]

    # the item side's prep (once per ScreenItems: twice per solve)
    ip = items_pl.planes
    i_args = (ip["allow"], ip["out"], ip["defined"], ops.rows_layout)
    i_extra = {"escape": ip["escape"], "custom_deny": ip["custom_deny"]}
    item_prep_ms = time_on_card(lambda: screen.screen_prep(*i_args, **i_extra), reps=50,
                                busy_cycles=busy_cycles)
    item_prep_plain_ms = time_on_card(lambda: screen.screen_prep_plain(*i_args, **i_extra),
                                      reps=5)
    ib = prep_bound(items_pl.B, ops.rows_layout, True, True, True, int_rate)
    say(f"[screen_prep] {label}: item side C={items_pl.B}: kernel {item_prep_ms:.4f} ms, "
        f"plain {item_prep_plain_ms:.4f} ms, bound {ib['bound_ms']:.6f} ms by "
        f"{ib['bound_detail']}")
    # the slot side's prep of the block shape: the kernels line's screen_prep
    s_plain_ms = time_on_card(lambda: screen.screen_prep_plain(
        e_rows["allow"], e_rows["out"], e_rows["defined"], ops.rows_layout), reps=5)
    say(f"[screen_prep] {label}: slot side E={blk['N']} (block form: bytes and bitmasks): "
        f"wrapper {blk['prep_ms']:.4f} ms, kernel {blk['prep_kernel_ms']:.4f} ms, plain "
        f"{s_plain_ms:.4f} ms, bound {blk['prep_bound_ms']:.6f} ms")
    return {"max_abs_err": float(worst), "timed": timed, "slot_prep_plain_ms": s_plain_ms}


# -- host-side checks ---------------------------------------------------------

def check_placements(result, n_pods: int, kube_client=None) -> dict:
    """Every placement fits its node and satisfies its pods' requirements
    and tolerations; every pod is placed or failed exactly once. With a
    kube client, also the cluster's host ports and attach limits, counting
    the pods bound there (check_cluster_usage, whose counts it returns)."""
    seen = result.pod_count_new() + result.pod_count_existing() + len(result.failed_pods)
    if seen != n_pods:
        raise AssertionError(f"{seen} pods accounted for, expected {n_pods}")
    for node, pods in result.existing_assignments:
        if not resources.fits(resources.requests_for_pods(*pods), node.available()):
            raise AssertionError(f"existing node {node.name()} overfilled")
        node_reqs = Requirements.from_labels(node.labels())
        node_reqs.add(Requirement(LABEL_HOSTNAME, "In", [node.hostname()]))
        for p in pods:
            if node_reqs.compatible(Requirements.from_pod(p)) is not None:
                raise AssertionError(f"{p.metadata.name} incompatible with {node.name()}")
            if taints_mod.tolerates(node.taints(), p) is not None:
                raise AssertionError(f"{p.metadata.name} does not tolerate {node.name()}")
    allocatable = {}  # per instance type, computed once
    for m in result.new_machines:
        options = m.instance_type_options
        if not options:
            raise AssertionError("a machine without instance-type options")
        total = resources.requests_for_pods(*m.pods)
        for it in options:
            alloc = allocatable.get(id(it))
            if alloc is None:
                alloc = allocatable[id(it)] = it.allocatable()
            if not resources.fits(total, alloc):
                raise AssertionError(f"machine pods do not fit option {it.name}")
        for p in m.pods:
            reqs = Requirements.from_pod(p)
            if m.template.requirements.compatible(reqs) is not None:
                raise AssertionError(f"{p.metadata.name} incompatible with its template")
            if options[0].requirements.intersects(reqs) is not None:
                raise AssertionError(f"{p.metadata.name} incompatible with {options[0].name}")
            if taints_mod.tolerates(m.template.taints, p) is not None:
                raise AssertionError(f"{p.metadata.name} does not tolerate its template")
    return check_cluster_usage(result, kube_client) if kube_client is not None else {}


def bound_pods(kube_client, batch) -> dict:
    """node name -> the pods the kube client shows running there: bound,
    neither terminal nor terminating, and not of the batch."""
    uids = {p.metadata.uid for p in batch}
    out = {}
    for p in kube_client.list("Pod", copy_objects=False):
        if (p.spec.node_name and p.status.phase not in ("Succeeded", "Failed")
                and p.metadata.deletion_timestamp is None and p.metadata.uid not in uids):
            out.setdefault(p.spec.node_name, []).append(p)
    return out


_ANY_IP = ("", "0.0.0.0", "::")


def _host_ports(p) -> list:
    return [(c.host_ip or "0.0.0.0", c.host_port, c.protocol or "TCP")
            for ct in p.spec.containers for c in ct.ports if c.host_port]


def _ports_conflict(a, b) -> bool:
    return a[1:] == b[1:] and (a[0] == b[0] or a[0] in _ANY_IP or b[0] in _ANY_IP)


def _claims(p, kube_client) -> set:
    """(driver, namespace/claim) of each PVC-backed volume whose driver is
    known: the bound PV's CSI driver, else the StorageClass provisioner."""
    out = set()
    for v in p.spec.volumes:
        if v.persistent_volume_claim is None:
            continue
        name = v.persistent_volume_claim.claim_name
        pvc = kube_client.get("PersistentVolumeClaim", p.metadata.namespace, name)
        if pvc is None:
            continue
        driver = None
        if pvc.spec.volume_name:
            pv = kube_client.get("PersistentVolume", "", pvc.spec.volume_name)
            if pv is not None and pv.spec.csi is not None:
                driver = pv.spec.csi.driver
        if driver is None and pvc.spec.storage_class_name:
            sc = kube_client.get("StorageClass", "", pvc.spec.storage_class_name)
            if sc is not None:
                driver = sc.provisioner
        if driver:
            out.add((driver, f"{p.metadata.namespace}/{name}"))
    return out


def check_cluster_usage(result, kube_client) -> dict:
    """Read from the pods' specs and the kube client, independently of
    the solver: no two pods on one node hold conflicting host ports (the
    pods bound there included), and on each existing node the distinct
    claims per CSI driver, mounted and placed, stay within the CSINode's
    limit. Returns counts of what was checked."""
    batch = [p for _n, ps in result.existing_assignments for p in ps]
    batch += [p for m in result.new_machines for p in m.pods] + list(result.failed_pods)
    running = bound_pods(kube_client, batch)
    checked = {"port_nodes": 0, "volume_nodes": 0, "placed_claims": 0}
    groups = [(n.name(), running.get(n.name(), []), ps) for n, ps in result.existing_assignments]
    groups += [(f"machine/{i}", [], m.pods) for i, m in enumerate(result.new_machines)]
    for name, old, new in groups:
        entries = [(p, e, placed) for placed, ps in ((False, old), (True, new))
                   for p in ps for e in _host_ports(p)]
        for x, (p, a, p_new) in enumerate(entries):
            for q, b, q_new in entries[x + 1:]:
                if q is not p and (p_new or q_new) and _ports_conflict(a, b):
                    raise AssertionError(f"{name}: {p.metadata.name} {a} conflicts with "
                                         f"{q.metadata.name} {b}")
        checked["port_nodes"] += any(placed for _p, _e, placed in entries)
    for node, ps in result.existing_assignments:
        placed = set().union(*(_claims(p, kube_client) for p in ps))
        if not placed:
            continue
        csinode = kube_client.get("CSINode", "", node.name())
        limits = {d.name: d.allocatable_count for d in (csinode.drivers if csinode else [])
                  if d.allocatable_count is not None}
        mounted = set().union(*(_claims(p, kube_client) for p in running.get(node.name(), [])))
        for driver, limit in limits.items():
            n = len({c for d, c in mounted | placed if d == driver})
            if n > limit:
                raise AssertionError(f"{node.name()}: {n} {driver} claims > limit {limit}")
        checked["volume_nodes"] += 1
        checked["placed_claims"] += len(placed)
    return checked


def _machine_zone(machine):
    """The zone a new machine's requirements pin, or None."""
    r = machine.requirements.get(LABEL_TOPOLOGY_ZONE)
    if r is not None and not r.complement and len(r.values) == 1:
        return next(iter(r.values))
    return None


def check_topology(result, zones, kube_client=None) -> dict:
    """The batch's topology constraints hold in the placements, checked
    from the pods' own specs, independently of the solver: every
    DoNotSchedule zonal spread keeps max - min <= maxSkew over `zones`,
    every hostname spread at most maxSkew selected pods a node; the pods
    of one zonal or hostname pod-affinity term share one zone or node; no
    pod with a required anti-affinity term shares its domain with another
    pod its selector matches. With a kube client the pods running in the
    cluster count too: in the spreads' domain counts, as the domain an
    affinity term must share, and on both sides of anti-affinity (a pair
    of running pods is not the solve's). Returns counts of what was
    checked."""
    nodes = []  # (node key, zone or None, pods, placed by this solve)
    for node, pods in result.existing_assignments:
        nodes.append((f"node/{node.name()}", node.labels().get(LABEL_TOPOLOGY_ZONE), pods, True))
    for i, m in enumerate(result.new_machines):
        nodes.append((f"machine/{i}", _machine_zone(m), m.pods, True))
    if kube_client is not None:
        batch = [p for _k, _z, ps, _n in nodes for p in ps] + list(result.failed_pods)
        for name, pods in bound_pods(kube_client, batch).items():
            node = kube_client.get("Node", "", name)
            if node is not None:
                nodes.append((f"node/{name}", node.metadata.labels.get(LABEL_TOPOLOGY_ZONE),
                              pods, False))
    placed = [(key, zone, p) for key, zone, pods, new in nodes if new for p in pods]
    everyone = [(key, zone, p, new) for key, zone, pods, new in nodes for p in pods]

    def selects(selector, owner, p):
        return (p.metadata.namespace == owner.metadata.namespace
                and selector is not None and selector.matches(p.metadata.labels))

    def domain(key, zone, p, topology_key, owner: bool):
        if topology_key == LABEL_HOSTNAME:
            return key
        if topology_key != LABEL_TOPOLOGY_ZONE:
            raise AssertionError(f"check_topology: unchecked key {topology_key}")
        if zone is None and owner:
            raise AssertionError(f"{p.metadata.name} placed on a machine of no single zone")
        return zone

    checked = {"spread": 0, "affinity": 0, "anti": 0}
    spreads, affinities = {}, {}
    for _key, _zone, p in placed:
        for c in p.spec.topology_spread_constraints:
            if c.when_unsatisfiable == "DoNotSchedule":
                spreads.setdefault((c.topology_key, c.max_skew, repr(c.label_selector),
                                    p.metadata.namespace), (c, p))
        aff = p.spec.affinity
        if aff is not None and aff.pod_affinity is not None:
            for t in aff.pod_affinity.required:
                affinities.setdefault((t.topology_key, repr(t.label_selector),
                                       p.metadata.namespace), (t, []))[1].append(p)
    for (tkey, skew, _sel, _ns), (c, owner) in spreads.items():
        counts = {}
        for key, zone, p, new in everyone:
            if selects(c.label_selector, owner, p):
                is_owner = new and c in p.spec.topology_spread_constraints
                d = domain(key, zone, p, tkey, is_owner)
                if d is not None:
                    counts[d] = counts.get(d, 0) + 1
        if tkey == LABEL_HOSTNAME:
            worst = max(counts.values(), default=0)
            if worst > skew:
                raise AssertionError(f"hostname spread: {worst} pods on one node > {skew}")
        else:
            per_zone = [counts.get(z, 0) for z in zones]
            if max(per_zone) - min(per_zone) > skew:
                raise AssertionError(f"zonal spread skew {per_zone} > {skew}")
        checked["spread"] += 1
    placed_at = {id(p): (key, zone) for key, zone, p in placed}
    for (tkey, _sel, _ns), (term, owners) in affinities.items():
        doms = {domain(*placed_at[id(p)], p, tkey, True)
                for p in owners if id(p) in placed_at}
        doms |= {domain(key, zone, p, tkey, False) for key, zone, p, new in everyone
                 if not new and selects(term.label_selector, owners[0], p)}
        if len(doms) > 1:
            raise AssertionError(f"pod affinity over {tkey}: owners in {sorted(doms)}")
        checked["affinity"] += 1
    by_domain = {}
    for key, zone, p, new in everyone:
        by_domain.setdefault((LABEL_HOSTNAME, key), []).append((p, new))
        by_domain.setdefault((LABEL_TOPOLOGY_ZONE, zone), []).append((p, new))
    for key, zone, p, new in everyone:
        aff = p.spec.affinity
        if aff is None or aff.pod_anti_affinity is None:
            continue
        for t in aff.pod_anti_affinity.required:
            mine = domain(key, zone, p, t.topology_key, new)
            for q, q_new in by_domain.get((t.topology_key, mine), []):
                if q is not p and (new or q_new) and selects(t.label_selector, p, q):
                    raise AssertionError(
                        f"{p.metadata.name} shares {mine} with {q.metadata.name}")
            checked["anti"] += 1
    return checked


# -- main ---------------------------------------------------------------------

def profile_solve(solver, workload, cluster, label="profile") -> None:
    """One more main-path solve under torch.profiler: wall time, summed
    device time (busy share), the costliest device operations, and the
    host's operator count and time with its costliest operators."""
    from torch.profiler import ProfilerActivity, profile

    pods, provs, its = workload
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.solve(pods, provs, its, state_nodes=cluster.nodes(),
                     kube_client=cluster.kube_client, cluster=cluster)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    # the device-side events (kernels, copies, memsets) partition busy time
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in on_device) / 1e3
    launches = sum(e.count for e in on_device)
    host_ops = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA]
    host_ms = sum(e.self_cpu_time_total for e in host_ops) / 1e3
    say(f"[{label}] solve {wall_ms:.1f} ms wall, device busy {busy_ms:.1f} ms "
        f"({100.0 * busy_ms / wall_ms:.1f}%), {launches} device operations; host "
        f"operators {sum(e.count for e in host_ops)}, {host_ms:.1f} ms of self time; "
        f"phases {json.dumps({k: round(v, 3) for k, v in solver.last_phase_ms.items()})}")
    for e in sorted(host_ops, key=dev_us, reverse=True)[:10]:
        say(f"[{label}]   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<7d} {e.key[:90]}")
    say(f"[{label}] by host self time:")
    for e in sorted(host_ops, key=lambda e: e.self_cpu_time_total, reverse=True)[:10]:
        say(f"[{label}]   {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<7d} {e.key[:90]}")
    if busy_ms <= 0.0:
        raise AssertionError("the profiler saw no device time")


def _zones(its) -> list:
    return sorted({o.zone for it in its["default"] for o in it.offerings if o.available})


def run_main_path(label, solver, workload, zones=None, cluster=None):
    """Solve `workload` cold then warm with the launch counts set to 0
    just before and read just after; check the placements (and with
    `zones`, the topology constraints) and that both solves agree. With a
    cluster, each solve takes its state nodes from cluster.nodes() (timed
    within the solve's wall time) and reads the cluster and its kube
    client. Returns (launches, launches by form, solver, the cold
    solve's result, the workload's snapshot)."""
    pods, provs, its, nodes = workload
    client = cluster.kube_client if cluster is not None else None
    screen.reset_launches()
    runs = []
    for run in ("cold", "warm"):
        full_gcs = gc.get_stats()[2]["collections"]
        t0 = time.perf_counter()
        if cluster is not None:
            nodes = cluster.nodes()
        nodes_s = time.perf_counter() - t0
        nodes_gcs = gc.get_stats()[2]["collections"]
        result = solver.solve(pods, provs, its, state_nodes=nodes, kube_client=client,
                              cluster=cluster)
        torch.cuda.synchronize()
        runs.append((run, time.perf_counter() - t0, nodes_s, dict(solver.last_phase_ms),
                     dict(pack.LAST_SCAN), result,
                     (nodes_gcs - full_gcs, gc.get_stats()[2]["collections"] - nodes_gcs)))
    launches, forms = dict(screen.LAUNCHES), dict(screen.FORM_LAUNCHES)
    result = runs[0][5]
    t0 = time.perf_counter()
    usage = check_placements(result, len(pods), client)
    checked = check_topology(result, zones, client) if zones else {}
    check_s = time.perf_counter() - t0
    if torch_solver.placements_json(result) != torch_solver.placements_json(runs[1][5]):
        raise AssertionError(f"{label}: cold and warm solves differ")
    for run, wall, nodes_s, phases, scan, res, full_gcs in runs:
        say(f"[{label}] {run}: {wall:.3f} s wall"
            + (f" ({nodes_s:.3f} s of it cluster.nodes())" if cluster is not None else "")
            + f", full garbage collections {full_gcs[0]} in cluster.nodes() and "
            f"{full_gcs[1]} in the solve, scheduled "
            f"{res.pod_count_new() + res.pod_count_existing()} (new {res.pod_count_new()} "
            f"on {len(res.new_machines)} machines, existing "
            f"{res.pod_count_existing()}), failed {len(res.failed_pods)}, rounds "
            f"{res.rounds}, last_phase_ms "
            + json.dumps({k: round(v, 3) for k, v in phases.items()})
            + f", scan {json.dumps(scan)}")
    for run, _wall, _nodes_s, _phases, scan, _res, _gcs in runs:
        check_kernel_route(f"{label} {run}", scan)
    say(f"[{label}] on the pack_scan kernel: device "
        + " / ".join(f"{phases['device']:.1f}" for _r, _w, _n, phases, *_ in runs)
        + f" ms (cold / warm), row_n1 launches {forms['row_n1']} and pack_scan "
        f"{launches['pack_scan']} over the two solves, longest pack_scan launch so far "
        f"{pack_scan.LAST_LAUNCH['max_ms']:.1f} ms")
    if result.failed_pods and cluster is not None:
        raise AssertionError(f"{label}: {len(result.failed_pods)} pods failed, e.g. "
                             f"{result.failed_pods[0].metadata.name}")
    snap = solver.encode(pods, provs, its, state_nodes=nodes, kube_client=client,
                         cluster=cluster)
    groups = len(snap.topo_meta.groups) if snap.topo_meta is not None else 0
    say(f"[{label}] {len(pods)} pods, {len(snap.item_counts)} items, G={groups} "
        f"groups, N={snap.n_slots} slots, V={snap.dictionary.V} (screen width "
        f"{snap.screen_v}), Q={snap.pod_ports_u.shape[1]} port columns, "
        f"W={snap.pod_vols_u.shape[1]} claim columns, D={snap.exist_vol_limits.shape[1]} "
        f"drivers; checks {check_s:.2f} s: topology {json.dumps(checked)}, cluster "
        f"usage {json.dumps(usage)}; over the two solves: {launches_line()}")
    return launches, forms, solver, result, snap


def _bound_copy(pod, node_name: str):
    """The running copy of a pending pod that the scheduler bound to
    `node_name`: its whole spec (ports, claims, constraints) kept."""
    bound = copy.deepcopy(pod)
    bound.spec.node_name = node_name
    bound.status.phase = "Running"
    bound.status.conditions = []
    return bound


def _joined_node(machine, name: str, zones):
    """The node a new machine registers as once it launches: the
    machine's first (cheapest) instance-type option, in the zone its
    requirements pin or else the first zone they allow, on-demand."""
    it = machine.instance_type_options[0]
    zone = _machine_zone(machine)
    if zone is None:
        r = machine.requirements.get(LABEL_TOPOLOGY_ZONE)
        zone = next(z for z in zones if r is None or r.has(z))
    return testing.make_node(
        name=name,
        labels={PROVISIONER_NAME_LABEL_KEY: machine.provisioner_name,
                LABEL_NODE_INITIALIZED: "true", LABEL_INSTANCE_TYPE_STABLE: it.name,
                LABEL_CAPACITY_TYPE: "on-demand", LABEL_TOPOLOGY_ZONE: zone},
        capacity={k: str(v) for k, v in it.capacity.items()},
    )


def churn_step(step, pending, result, client, queues, zones, gen_apps,
               n_bind_nodes=20, per_node=3, n_join=5, n_terminate=15, n_pinned=20) -> list:
    """Steady-state churn between two solves, through the kube client and
    the informers, as a provisioning loop sees it:
      - the scheduler binds part of the last placements on existing
        nodes (up to `per_node` pods on each of `n_bind_nodes` nodes);
      - `n_join` of the machines the last solve launched register as
        nodes (with their CSINode, inside the existing-axis bucket) and
        their pods bind there;
      - one bound filler pod on each of `n_terminate` nodes terminates;
      - new pods arrive at the end of the batch: one replica of a generic
        deployment (of `gen_apps`, in turn) for each pod bound, and `n_pinned` replicas of a new
        deployment pinned to one zone by a nodeSelector (the zone turns
        with the step), so the class mix changes.
    Returns the new pending batch and the counts and nodes touched."""
    taken, touched = set(), set()

    def bind(p, node_name):
        client.create(_bound_copy(p, node_name))
        taken.add(id(p))

    for node, pods in sorted(result.existing_assignments, key=lambda a: a[0].name()):
        if len(touched) >= n_bind_nodes:
            break
        for p in pods[:per_node]:
            bind(p, node.name())
        touched.add(node.name())
    for k, m in enumerate(result.new_machines[:n_join]):
        node = _joined_node(m, f"joined-{step}-{k}", zones)
        client.create(testing.make_csinode(node.name, EBS, allocatable=EBS_NITRO_LIMIT))
        client.create(node)
        for p in m.pods:
            bind(p, node.name)
        touched.add(node.name)
    terminated = 0
    n_base = sum(1 for n in client.list("Node") if n.metadata.name.startswith("node-"))
    for k in range(n_terminate):
        i = (step * n_terminate + k) * 7 % n_base
        victim = client.get("Pod", "default", f"run-{i}-f{step}")
        if victim is not None:
            client.delete(victim)
            touched.add(f"node-{i}")
            terminated += 1
    bound = len(taken)
    arrivals = [testing.make_pod(
        name=f"gen-s{step}-{k}", labels={"app": gen_apps[(step * 131 + k) % len(gen_apps)]},
        requests={"cpu": "1", "memory": "1Gi"}, uid=f"uid-gen-s{step}-{k:05d}",
        creation_timestamp=1000.0 + step) for k in range(bound)]
    zone = zones[step % len(zones)]
    arrivals += [testing.make_pod(
        name=f"pinned-{step}-{k}", labels={"app": f"pinned-{step}"},
        node_selector={LABEL_TOPOLOGY_ZONE: zone}, requests={"cpu": "1", "memory": "1Gi"},
        uid=f"uid-pinned-{step}-{k:04d}", creation_timestamp=1000.0 + step)
        for k in range(n_pinned)]
    events = sum(informer.drain(q, handler) for q, handler in queues)
    return [p for p in pending if id(p) not in taken] + arrivals, {
        "bound": bound, "joined": min(n_join, len(result.new_machines)),
        "terminated": terminated, "arrived": len(arrivals), "pinned_zone": zone,
        "nodes_touched": len(touched), "events": events}


def _add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def dispatch_launches(mode: str, delta, n_exist: int, n_cols: int) -> dict:
    """The launches a prescreen dispatch must make (TorchSolver's
    last_prescreen_launches): one screen_prep of the class planes, then one
    slot-side screen_prep and one screen launch, in the form its shape
    takes (screen.form_of), for each block it computes. The full
    precompute computes the existing block (n_exist x n_cols) and the
    virgin row (1 x n_cols); a refresh the changed rows against every
    column and the changed columns' existing block and virgin row."""
    if mode == "full":
        shapes = [(n_exist, n_cols), (1, n_cols)]
    else:
        rows, cols = delta["rows"], delta["cols"]
        shapes = ([(rows, n_cols)] if rows else []) + (
            [(n_exist, cols), (1, cols)] if cols else [])
    forms = [screen.form_of(n, b) for n, b in shapes]
    out = {"screen": len(forms), "screen_prep": 1 + len(forms), "pack_scan": 0}
    out.update({f: forms.count(f) for f in screen.FORM_LAUNCHES})
    return out


def phase_churn(pods, provs, its, client, cluster, max_nodes: int, zones, steps: int = 4,
                device: str = "cuda"):
    """Phase 7: steady churn at full width, from phase 6's live cluster.
    An incremental TorchSolver and one with incremental="off", both on the
    card, solve `steps` consecutive batches over the same Cluster, which
    the kube client's watches feed through the informers between steps
    (churn_step). Each solve runs with the launch counts set to 0 just
    before it and read just after. Every step's placements must be
    byte-identical; the last step's pass check_placements and
    check_topology with the bound pods counted. The first incremental
    step must run the full precompute, a later one must refresh, every
    prescreen dispatch must have launched exactly the kernels and forms
    its delta needs (dispatch_launches), and no refresh may fail
    (full_deg). Returns (launches, launches by form, per-step records)."""
    if len(cluster.nodes_by_provider_id) < 2:
        raise ValueError("phase_churn: the cluster needs at least two nodes")
    queues = [(client.watch("Node", backlog=False), informer.NodeInformer(cluster)),
              (client.watch("Pod", backlog=False), informer.PodInformer(cluster))]
    inc = torch_solver.TorchSolver(max_nodes=max_nodes, device=device)
    full = torch_solver.TorchSolver(max_nodes=max_nodes, device=device, incremental="off")
    pending = list(pods)
    gen_apps = sorted({p.metadata.labels["app"] for p in pods
                       if p.metadata.labels.get("app", "").startswith("gen-")})
    incremental.reset_outcomes()
    total, modes, steps_out, result = {}, [], [], None
    for step in range(steps):
        churn = None
        if step:
            t0 = time.perf_counter()
            pending, churn = churn_step(step, pending, result, client, queues, zones,
                                        gen_apps)
            churn["s"] = round(time.perf_counter() - t0, 3)
        walls, placed, counts = {}, {}, {}
        for name, solver in (("incremental", inc), ("full", full)):
            screen.reset_launches()
            t0 = time.perf_counter()
            res = solver.solve(pending, provs, its, state_nodes=cluster.nodes(),
                               kube_client=client, cluster=cluster)
            if device == "cuda":
                torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            counts[name] = screen.launch_counts()
            _add_counts(total, counts[name])
            placed[name] = torch_solver.placements_json(res)
            if name == "incremental":
                result = res
        if placed["incremental"] != placed["full"]:
            raise AssertionError(f"churn step {step}: incremental and full placements differ")
        if result.failed_pods:
            raise AssertionError(f"churn step {step}: {len(result.failed_pods)} pods failed")
        mode, delta, pre = inc.last_prescreen_mode, inc.last_prescreen_delta, \
            inc.last_prescreen_launches
        modes.append(mode)
        say(f"[churn] step {step}: churn {json.dumps(churn)}; {len(pending)} pending; "
            f"incremental {walls['incremental']:.3f} s wall, prescreen {mode} delta "
            f"{json.dumps(delta)} {inc.last_phase_ms['prescreen']:.3f} ms against the full "
            f"solver's {full.last_phase_ms['prescreen']:.3f} ms; full {walls['full']:.3f} s "
            f"wall; incremental phases "
            + json.dumps({k: round(v, 3) for k, v in inc.last_phase_ms.items()})
            + f"; placed {result.pod_count_new() + result.pod_count_existing()} (existing "
            f"{result.pod_count_existing()}, new {result.pod_count_new()} on "
            f"{len(result.new_machines)} machines); byte-identical; outcomes "
            f"{json.dumps(incremental.outcome_counts())}; launches: incremental solve "
            f"{json.dumps(counts['incremental'])} (its prescreen dispatch "
            f"{json.dumps(pre)}), full solve {json.dumps(counts['full'])} (its "
            f"prescreen dispatch {json.dumps(full.last_prescreen_launches)})")
        # launches are counted on the card only (the CPU runs the plain
        # versions). Every batch here has more than one class column and
        # more than one existing node, which is all the forms depend on
        n_exist = len(cluster.nodes_by_provider_id)
        for name, solver, got in (("incremental", inc, pre),
                                  ("full", full, full.last_prescreen_launches)):
            want = dispatch_launches(solver.last_prescreen_mode, solver.last_prescreen_delta,
                                     n_exist, 2)
            if device == "cuda" and got != want:
                raise AssertionError(
                    f"churn step {step}: the {name} solver's {solver.last_prescreen_mode} "
                    f"dispatch of {json.dumps(solver.last_prescreen_delta)} launched "
                    f"{json.dumps(got)}, expected {json.dumps(want)}")
        steps_out.append({"mode": mode, "delta": delta, "churn": churn,
                          "refresh_ms": inc.last_phase_ms["prescreen"],
                          "full_ms": full.last_phase_ms["prescreen"],
                          "incremental_launches": counts["incremental"],
                          "prescreen_launches": pre, "full_launches": counts["full"]})
    for kind, (q, _handler) in zip(("Node", "Pod"), queues):
        client.unwatch(kind, q)
    t0 = time.perf_counter()
    usage = check_placements(result, len(pending), client)
    checked = check_topology(result, zones, client)
    say(f"[churn] {steps} steps, modes {modes}; the last step's checks "
        f"{time.perf_counter() - t0:.2f} s: topology {json.dumps(checked)}, cluster usage "
        f"{json.dumps(usage)}; outcomes {json.dumps(incremental.outcome_counts())}; summed "
        f"over the phase's solves: {json.dumps(total)}")
    if modes[0] != "full":
        raise AssertionError(f"churn: the first step ran {modes[0]}, not the full precompute")
    if "refresh" not in modes[1:]:
        raise AssertionError(f"churn: no step refreshed the resident tensor: {modes}")
    failed = incremental.outcome_counts()["full_deg"]
    if failed:
        raise AssertionError(f"churn: {failed} refreshes failed; "
                             f"the last: {inc.last_refresh_error}")
    return ({k: total.get(k, 0) for k in screen.LAUNCHES},
            {k: total.get(k, 0) for k in screen.FORM_LAUNCHES}, steps_out)


# -- phase 8: consolidation over a live cluster --------------------------------

# phase 8's settled cluster: phase 6's at 200 of its 1,000 nodes (6,000
# bound pods), the depth cut that, with 10b at half of 3c's size, pays for
# phases 14, 16 and 17 and, with 18a's single-card solves gone and 15b's
# shorter churn, phase 19 (300 nodes before it: 47.5 s of phase 8 against
# 35.8 s at 200 nodes and 25.7 s of phase 19 on one H100's host). At 150
# nodes the sweep's replan ran the full precompute where the check wants
# the refresh
PHASE8_NODES = 200


def settled_cluster(*args, **kw):
    """live_cluster(*args, **kw) without its pending backlog: the settled
    cluster consolidation runs on, on a FakeClock, with the provisioner
    (consolidation enabled) in the kube client. Returns (instance types,
    kube client, cluster, clock)."""
    clock = testing.FakeClock()
    _pods, _provs, its, client, cluster = live_cluster(*args, clock=clock, **kw)
    client.create(testing.make_provisioner(name="default", consolidation_enabled=True))
    return its, client, cluster, clock


class _GenTwo:
    """Counts gen-2 collections, those that start inside a solve, and the
    seconds they take, by the part of an operator step open when they
    start (`parts` is the stack of open parts; "other" outside them)."""

    def __init__(self):
        self.total = self.in_solve = 0
        self.solving = False
        self.seconds = 0.0
        self.parts = []
        self.by_part = {}
        self._start = None

    def __call__(self, phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            self.total += 1
            self.in_solve += self.solving
            self._start = (time.perf_counter(), self.parts[-1] if self.parts else "other")
        elif self._start is not None:
            t0, part = self._start
            self._start = None
            dt = time.perf_counter() - t0
            self.seconds += dt
            n, secs = self.by_part.get(part, (0, 0.0))
            self.by_part[part] = (n + 1, secs + dt)

    def since(self, mark: tuple) -> dict:
        """The collections since `mark` (a `mark()`): their count, seconds
        and (count, seconds) by part."""
        total, seconds, by_part = mark
        parts = {}
        for part, (n, secs) in self.by_part.items():
            n0, s0 = by_part.get(part, (0, 0.0))
            if n > n0:
                parts[part] = [n - n0, round(secs - s0, 3)]
        return {"n": self.total - total, "s": round(self.seconds - seconds, 3),
                "by_part": parts}

    def mark(self) -> tuple:
        return self.total, self.seconds, dict(self.by_part)


def phase_consolidation(label, its, client, cluster, clock, device="cuda",
                        want_slots=False) -> dict:
    """Phase 8 (and each half of 8b): MultiNodeConsolidation.compute_command
    (the prefix ladder and the ride-along empty subset in one replan) and
    then SingleNodeConsolidation.compute_command (every candidate a
    singleton, in chunks of 64) over the cluster, through the port's
    modules: candidate_nodes, a ProvisioningController, a TorchSolver(max_nodes=1024)
    on `device` (incremental, the operator's defaults), validation_ttl = 0
    on `clock`. Each run's screen launches are zeroed just
    before it and read just after; each replan's phases, K, chunks,
    prescreen mode, own launches and device ms per scanned subset, every
    exact solve, and the gen-2 collections inside solves are recorded.
    Each pass's flight record goes to FLIGHTREC (when it is enabled), its
    time taken. Returns the runs' candidates, screens, commands, records
    and flight records."""
    solver = torch_solver.TorchSolver(max_nodes=1024, device=device)
    cp = fake.FakeCloudProvider(its["default"])
    provisioning = ProvisioningController(client, cp, cluster, solver=solver, clock=clock)
    args = (client, cluster, provisioning, cp, None)
    deps = {
        "multi": consolidation.MultiNodeConsolidation(*args, clock=clock, validation_ttl=0.0),
        "single": consolidation.SingleNodeConsolidation(*args, clock=clock,
                                                        validation_ttl=0.0),
    }
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    replans, solves = [], []
    gen2 = _GenTwo()
    real_replan, real_solve = solver.replan_screen, solver.solve

    def replan_screen(*a, **kw):
        out = real_replan(*a, **kw)
        st = solver.last_replan_stats
        ph = solver.last_replan_phase_ms
        # the union snapshot and its provisioners: the planes the replan's
        # kernels screened, for snapshot_shapes
        replans.append({"union": (a[0], a[1]),
                        "K": st["K"], "chunks": st["chunks"], "prescreen": st["prescreen"],
                        "launches": st["launches"], "scans": st["scans"],
                        "phases_ms": {k: round(v, 3) for k, v in ph.items()},
                        "device_ms_per_subset": ph["device"] / max(st["scans"]["subsets"], 1)})
        return out

    def solve(*a, **kw):
        gen2.solving = True
        t0 = time.perf_counter()
        try:
            res = real_solve(*a, **kw)
            sync()
        finally:
            gen2.solving = False
        solves.append({"wall_s": time.perf_counter() - t0, "pods": len(a[0]),
                       "phases_ms": {k: round(v, 3) for k, v in solver.last_phase_ms.items()}})
        return res

    solver.replan_screen, solver.solve = replan_screen, solve
    real_batched = replan.batched_subset_screen
    if want_slots:
        replan.batched_subset_screen = lambda *a, **kw: real_batched(
            *a, **dict(kw, want_slots=True))
    gc.callbacks.append(gen2)
    out = {"runs": {}}
    try:
        for kind, dep in deps.items():
            captured, recorded = [], []

            def record_pass(c, s, cmd, scenario=None, real=dep._record_pass,
                            captured=captured, recorded=recorded):
                captured.append(s)
                n, t_rec = len(FLIGHTREC.consolidations()), time.perf_counter()
                real(c, s, cmd, scenario=scenario)
                if FLIGHTREC.enabled and len(FLIGHTREC.consolidations()) > n:
                    recorded.append((FLIGHTREC.last_consolidation(),
                                     time.perf_counter() - t_rec))

            dep._record_pass = record_pass
            screen.reset_launches()
            consolidation.reset_fallbacks()
            n_replans, n_solves = len(replans), len(solves)
            t0 = time.perf_counter()
            raw = candidate_nodes(cluster, client, cp, dep.should_deprovision, clock)
            scan_s = time.perf_counter() - t0
            cmd = dep.compute_command(raw)
            sync()
            wall = time.perf_counter() - t0
            counts = screen.launch_counts()
            fallbacks = dict(consolidation.FALLBACKS)
            if any(fallbacks.values()):
                raise AssertionError(f"{label} {kind}: the batched screen fell back to the "
                                     f"sequential path: {fallbacks}")
            screens = [s for pass_screens in captured for s in pass_screens]
            feasible = [s for s in screens
                        if s.all_scheduled and s.conclusive and s.n_new_machines <= 1]
            run = {
                "candidates": [c.name for c in dep.sort_and_filter_candidates(raw)],
                "screens": screens, "feasible": len(feasible), "cmd": cmd,
                "wall_s": wall, "scan_s": scan_s, "launches": counts,
                "replans": replans[n_replans:], "solves": solves[n_solves:],
                "records": recorded,
            }
            out["runs"][kind] = run
            repl = cmd.replacement_machines
            say(f"[{label}] {kind}: {len(run['candidates'])} candidates (scan "
                f"{scan_s:.3f} s), {len(screens)} subsets screened, {len(feasible)} "
                f"feasible; command {cmd.action}: {len(cmd.nodes_to_remove)} nodes "
                f"{[n.metadata.name for n in cmd.nodes_to_remove][:6]}"
                + (f", replacement options {len(repl[0].instance_type_options)}"
                   if repl else "")
                + f"; {wall:.3f} s wall, {len(run['solves'])} exact solves "
                f"({sum(s['wall_s'] for s in run['solves']):.3f} s), launches "
                f"{json.dumps(counts)}")
            for rp in run["replans"]:
                say(f"[{label}] {kind} replan: K {rp['K']} in chunks {rp['chunks']}, "
                    f"prescreen {rp['prescreen']}, last_replan_phase_ms "
                    f"{json.dumps(rp['phases_ms'])}, device ms per subset "
                    f"{rp['device_ms_per_subset']:.3f}, scans {json.dumps(rp['scans'])}, "
                    f"launches {json.dumps(rp['launches'])}")
            for sv in run["solves"]:
                say(f"[{label}] {kind} exact solve: {sv['pods']} pods, {sv['wall_s']:.3f} s, "
                    f"last_phase_ms {json.dumps(sv['phases_ms'])}")
            for rec, rec_s in recorded:
                inputs = rec.get("inputs", {})
                say(f"[{label}] {kind} flight record: {len(rec['subsets'])} subsets, "
                    f"{len(rec['candidates'])} candidates, "
                    + (f"inputs of {len(inputs['stateNodes'])} state nodes and "
                       f"{len(inputs['pods'])} pods, "
                       if inputs else f"inputs omitted ({rec.get('inputsOmitted')} nodes), ")
                    + f"{len(json.dumps(rec))} bytes, taken in {rec_s:.3f} s")
    finally:
        gc.callbacks.remove(gen2)
        replan.batched_subset_screen = real_batched
        solver.replan_screen, solver.solve = real_replan, real_solve
    out["gen2"] = {"total": gen2.total, "in_solves": gen2.in_solve}
    say(f"[{label}] gen-2 collections: {gen2.total} in the phase, {gen2.in_solve} inside "
        f"solves")
    return out


def check_consolidation(out: dict, on_card: bool = True) -> None:
    """Phase 8's fatal checks beyond phase_consolidation's own (no
    sequential fallback): the screen's block form launched (counted on
    the card only), the ladder's winner confirmed through an exact solve,
    and the second replan of the unchanged cluster refreshed the resident
    tensor."""
    multi, single = out["runs"]["multi"], out["runs"]["single"]
    if on_card and multi["launches"]["block"] + single["launches"]["block"] < 1:
        raise AssertionError("consolidation: the block-form screen was not launched")
    if multi["cmd"].action not in ("delete", "replace"):
        raise AssertionError(f"consolidation: the ladder decided {multi['cmd'].action}")
    if not multi["solves"]:
        raise AssertionError("consolidation: the ladder's winner was not confirmed by an "
                             "exact solve")
    if not multi["replans"] or not single["replans"]:
        raise AssertionError("consolidation: a deprovisioner ran no replan")
    if single["replans"][0]["prescreen"] == "full":
        raise AssertionError("consolidation: the second replan of the unchanged cluster "
                             "ran the full precompute")


def _screens_key(screens):
    return [(s.subset, s.all_scheduled, s.n_new_machines, s.conclusive, s.price,
             s.disruption, s.savings, s.priceless) for s in screens]


def _cmd_key(cmd):
    return (cmd.action, [n.metadata.name for n in cmd.nodes_to_remove],
            [[it.name for it in m.instance_type_options] for m in cmd.replacement_machines])


def compare_consolidation(card: dict, cpu: dict) -> dict:
    """Phase 8b: the card's and the CPU's runs agree on candidates, every
    subset's verdict and per-slot counts, and the Command."""
    checked = {}
    for kind in ("multi", "single"):
        a, b = card["runs"][kind], cpu["runs"][kind]
        if a["candidates"] != b["candidates"]:
            raise AssertionError(f"8b {kind}: card and CPU candidates differ")
        if _screens_key(a["screens"]) != _screens_key(b["screens"]):
            raise AssertionError(f"8b {kind}: card and CPU verdicts differ")
        for sa, sb in zip(a["screens"], b["screens"]):
            if not np.array_equal(sa.pods_per_slot, sb.pods_per_slot):
                raise AssertionError(f"8b {kind}: pods_per_slot of {sa.subset} differ")
        if _cmd_key(a["cmd"]) != _cmd_key(b["cmd"]):
            raise AssertionError(f"8b {kind}: card and CPU commands differ")
        checked[kind] = {"subsets": len(a["screens"]), "action": a["cmd"].action,
                         "card_s": round(a["wall_s"], 3), "cpu_s": round(b["wall_s"], 3)}
    return checked


# -- phase 9: the deprovisioning chain executed -----------------------------------

def mark_launched_ready(client) -> int:
    """Play the kubelet of each launched node: it reports Ready with its
    machine's capacity and allocatable, so that the machine controller
    initializes it. Returns how many nodes it marked."""
    n = 0
    for node in client.list("Node"):
        if node.name.startswith("fake-machine-") and not node.ready():
            machine = client.get("Machine", "", node.name)
            node.status.capacity = dict(machine.status.capacity)
            node.status.allocatable = dict(machine.status.allocatable)
            node.status.conditions = [Condition(type="Ready", status="True")]
            client.update_status(node)
            n += 1
    return n


def _launched(name: str) -> str:
    return "<launched>" if name.startswith("fake-machine-") else name


class Lifecycle:
    """Phases 9 and 9b: testing.ControlLoop over a settled cluster's kube
    client (a Cluster fed by its own watches, the machine, node and
    termination controllers, the Terminator and the
    DeprovisioningController) with a TorchSolver(max_nodes=1024) on
    `device`, on the cluster's FakeClock, validation_ttl = 0. It times
    every pass, records each Command, the screen launches and the exact
    solves, and checks the cluster after each."""

    def __init__(self, label, its, client, clock, device="cuda"):
        self.label, self.client, self.clock = label, client, clock
        self.cp = fake.FakeCloudProvider(its["default"])
        self.solver = torch_solver.TorchSolver(max_nodes=1024, device=device)
        self.sync_card = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        t0 = time.perf_counter()
        self.loop = testing.ControlLoop(client, self.cp, self.solver, clock=clock,
                                        validation_ttl=0.0)
        self.loop.sync()
        self.build_s = time.perf_counter() - t0
        self.n0 = len(client.list("Node", copy_objects=False))
        # live_cluster binds 30 pods on every node, more than the two
        # smallest types' pod capacity: those nodes start overfilled, and
        # check() leaves them out of the fit check
        self.overfilled = {
            sn.name() for sn in self.loop.cluster.nodes()
            if not resources.fits(sn.total_pod_requests(), sn.allocatable())}
        deprovisioning_ctrl.reset_counts()
        self.solves, self.passes, self.commands = [], [], []
        real_solve = self.solver.solve

        real_encode = torch_solver.encode_snapshot

        def solve(*a, **kw):
            # the solve's first snapshot and its provisioners: the planes
            # its kernels screened, for snapshot_shapes
            snaps = []
            torch_solver.encode_snapshot = lambda *ea, **ekw: (
                snaps.append(real_encode(*ea, **ekw)) or snaps[-1])
            t0 = time.perf_counter()
            try:
                res = real_solve(*a, **kw)
                self.sync_card()
            finally:
                torch_solver.encode_snapshot = real_encode
            self.solves.append({"wall_s": time.perf_counter() - t0, "pods": len(a[0]),
                                "snapshot": (snaps[0], a[1]) if snaps else None,
                                "prescreen": self.solver.last_prescreen_mode,
                                "phases_ms": {k: round(v, 3) for k, v in
                                              self.solver.last_phase_ms.items()}})
            return res

        self.solver.solve = solve
        real_execute = self.loop.deprovisioning.execute_command

        def execute(dep, cmd):
            t0 = time.perf_counter()
            real_execute(dep, cmd)
            self.sync_card()
            self.executed = (str(dep), cmd, time.perf_counter() - t0)

        self.loop.deprovisioning.execute_command = execute
        say(f"[{label}] control loop over {self.n0} nodes and "
            f"{len(self.loop.cluster.bindings)} bound pods built in {self.build_s:.2f} s; "
            f"overfilled from the start (left out of the fit check): "
            f"{sorted(self.overfilled)}")

    def step(self) -> float:
        t0 = time.perf_counter()
        self.loop.step()
        mark_launched_ready(self.client)
        return time.perf_counter() - t0

    def settle(self, limit: int = 6) -> list:
        """Step until no node is terminating and every launched node is
        initialized; the wall of each step."""
        walls = []
        for _ in range(limit):
            walls.append(self.step())
            self.loop.sync()
            nodes = self.client.list("Node", copy_objects=False)
            if not any(n.metadata.deletion_timestamp is not None
                       or (n.name.startswith("fake-machine-")
                           and n.metadata.labels.get(LABEL_NODE_INITIALIZED) != "true")
                       for n in nodes):
                return walls
        raise AssertionError(f"{self.label}: the cluster did not settle in {limit} steps")

    def command_key(self, dep: str, cmd) -> tuple:
        def req(m, key):
            r = m.requirements.get(key)
            return None if r is None else (r.operator(), r.values_list())

        return (dep, cmd.action, [n.metadata.name for n in cmd.nodes_to_remove],
                [(sorted(it.name for it in m.instance_type_options),
                  req(m, LABEL_TOPOLOGY_ZONE), req(m, LABEL_CAPACITY_TYPE))
                 for m in cmd.replacement_machines])

    def run_pass(self, name: str, want: str) -> dict:
        """One reconcile of the chain, which must execute a Command of the
        `want` deprovisioner, then steps until the cluster settles; the
        pass's screen launches counted on their own."""
        self.loop.sync()
        screen.reset_launches()
        consolidation.reset_fallbacks()
        self.executed = None
        n_solves = len(self.solves)
        t0 = time.perf_counter()
        acted = self.loop.deprovisioning.reconcile()
        self.sync_card()
        wall = time.perf_counter() - t0
        launches = screen.launch_counts()
        if any(consolidation.FALLBACKS.values()):
            raise AssertionError(f"{self.label} {name}: the batched screen fell back to the "
                                 f"sequential path: {consolidation.FALLBACKS}")
        if not acted or self.executed is None:
            raise AssertionError(f"{self.label} {name}: no Command was executed")
        dep, cmd, execute_s = self.executed
        if dep != want:
            raise AssertionError(f"{self.label} {name}: {dep} acted, not {want}")
        steps = self.settle()
        checked = self.check(name)
        rec = {"name": name, "key": self.command_key(dep, cmd), "cmd": cmd,
               "compute_ms": (wall - execute_s) * 1e3, "execute_ms": execute_s * 1e3,
               "steps_s": steps, "launches": launches, "solves": self.solves[n_solves:],
               "checked": checked}
        self.passes.append(rec)
        self.commands.append(rec["key"])
        repl = cmd.replacement_machines
        say(f"[{self.label}] {name}: {dep} {cmd.action} of {len(cmd.nodes_to_remove)} nodes "
            f"{[n.metadata.name for n in cmd.nodes_to_remove][:4]}"
            + (f", {len(repl)} replacement(s): options "
               f"{[len(m.instance_type_options) for m in repl]}, zone / capacity type "
               f"{[rec['key'][3][i][1:] for i in range(len(repl))]}" if repl else "")
            + f"; compute_command {rec['compute_ms']:.1f} ms, execute "
            f"{rec['execute_ms']:.1f} ms, steps {[round(w, 3) for w in steps]} s; launches "
            f"{json.dumps(launches)}; checked {json.dumps(checked)}")
        for sv in rec["solves"]:
            say(f"[{self.label}] {name} exact solve: {sv['pods']} pods, {sv['wall_s']:.3f} s, "
                f"prescreen {sv['prescreen']}, last_phase_ms {json.dumps(sv['phases_ms'])}")
        return rec

    def check(self, name: str) -> dict:
        """After a pass: the bound pods that remain pass check_placements
        and check_cluster_usage on their nodes (those overfilled from the
        start left out), every pod is bound to a
        node that exists, the Cluster's bindings are the client's, and the
        nodes are the ones at the start plus the launches minus the
        deletions, the Cluster tracking each node and each Machine."""
        client, cluster = self.client, self.loop.cluster
        nodes = {n.name: n for n in client.list("Node", copy_objects=False)}
        machines = client.list("Machine", copy_objects=False)
        by_node, bindings = {}, {}
        for p in client.list("Pod", copy_objects=False):
            if p.spec.node_name and p.status.phase not in ("Succeeded", "Failed"):
                by_node.setdefault(p.spec.node_name, []).append(p)
                bindings[(p.metadata.namespace, p.metadata.name)] = p.spec.node_name
        missing = sorted(set(by_node) - set(nodes))
        if missing:
            raise AssertionError(f"{self.label} {name}: pods bound to deleted nodes "
                                 f"{missing[:5]}")
        if {tuple(k): v for k, v in cluster.bindings.items()} != bindings:
            raise AssertionError(f"{self.label} {name}: the Cluster's bindings are not "
                                 f"the client's")
        want = self.n0 + deprovisioning_ctrl.nodes_created() - \
            deprovisioning_ctrl.nodes_terminated()
        if len(nodes) != want:
            raise AssertionError(f"{self.label} {name}: {len(nodes)} nodes, expected "
                                 f"{want} (launches minus deletions)")
        tracked = {n.spec.provider_id for n in nodes.values()} | {
            m.status.provider_id for m in machines}
        if set(cluster.nodes_by_provider_id) != tracked:
            raise AssertionError(f"{self.label} {name}: the Cluster does not track the "
                                 f"nodes and machines")
        state = {sn.name(): sn for sn in cluster.nodes()}
        result = torch_solver.SolveResult()
        for node_name, pods in by_node.items():
            if node_name in self.overfilled:
                continue
            sn = state[node_name]
            sn.pod_requests, sn.daemonset_requests = {}, {}
            result.existing_assignments.append((sn, pods))
        counts = check_placements(
            result, sum(len(pods) for _sn, pods in result.existing_assignments), client)
        return dict(counts, nodes=len(nodes), machines=len(machines), pods=len(bindings))

    def final_state(self) -> tuple:
        """The nodes, machines and the pods left per node, launched names
        made generic."""
        c = self.client
        return (
            sorted((_launched(n.name), n.metadata.labels.get(LABEL_INSTANCE_TYPE_STABLE),
                    n.metadata.labels.get(LABEL_TOPOLOGY_ZONE),
                    n.metadata.labels.get(LABEL_CAPACITY_TYPE), n.spec.unschedulable)
                   for n in c.list("Node", copy_objects=False)),
            sorted((m.metadata.labels.get(LABEL_INSTANCE_TYPE_STABLE),
                    m.metadata.labels.get(LABEL_TOPOLOGY_ZONE),
                    m.metadata.labels.get(LABEL_CAPACITY_TYPE))
                   for m in c.list("Machine", copy_objects=False)),
            sorted((p.metadata.name, _launched(p.spec.node_name))
                   for p in c.list("Pod", copy_objects=False)),
        )


def execute_ladder(lc: "Lifecycle", cmd) -> dict:
    """Phase 9's first part: phase 8's multi-node Command executed through
    the DeprovisioningController, then steps until no node terminates.
    Fatal unless exactly its nodes are gone from the client and the
    Cluster, no pod is left on them, and the evictions equal the
    non-daemon pods they held."""
    client, loop = lc.client, lc.loop
    removed = [n.metadata.name for n in cmd.nodes_to_remove]
    held = sum(1 for name in removed
               for p in client.list("Pod", node_name=name, copy_objects=False)
               if not pod_terminal(p) and not pod_of_daemonset(p))
    before = {n.name for n in client.list("Node", copy_objects=False)}
    evicted0 = loop.eviction_queue.evicted
    multi = next(d for d in loop.deprovisioning.deprovisioners
                 if type(d).__name__ == "MultiNodeConsolidation")
    t0 = time.perf_counter()
    loop.deprovisioning.execute_command(multi, cmd)
    execute_s = time.perf_counter() - t0
    walls = lc.settle()
    after = {n.name for n in client.list("Node", copy_objects=False)}
    if before - after != set(removed):
        raise AssertionError(f"{lc.label}: the ladder removed {len(before - after)} nodes, "
                             f"not its {len(removed)}")
    if any(loop.cluster.node_for(name) is not None for name in removed):
        raise AssertionError(f"{lc.label}: the Cluster still holds a removed node")
    evicted = loop.eviction_queue.evicted - evicted0
    if evicted != held:
        raise AssertionError(f"{lc.label}: {evicted} evictions for {held} pods")
    checked = lc.check("ladder")
    out = {"nodes": len(removed), "pods": held, "execute_s": execute_s,
           "drain_s": walls[0], "terminate_s": walls[1:], "checked": checked}
    say(f"[{lc.label}] phase 8's ladder Command executed: {len(removed)} nodes deleted, "
        f"{held} pods evicted; execute {execute_s:.3f} s, drain step {walls[0]:.3f} s "
        f"(cordons, drains, evictions), termination steps "
        f"{[round(w, 3) for w in walls[1:]]} s; checked {json.dumps(checked)}")
    return out


def ttl_passes(lc: "Lifecycle", expire: int, spot_pinned: int) -> list:
    """The TTL deprovisioners in turn, consolidation off: `expire`
    Expiration passes (as many nodes past the TTL, most expired first; the
    `spot_pinned`-th holds a pod that needs a spot node, so its pass
    launches a replacement through the fake provider, a Machine and a
    Node, and the evicted pod comes back bound to the replacement), one
    Drift pass (the node controller annotates the nodes the provider
    reports drifted; the gate closes after it) and one Emptiness pass (two
    empty nodes past TTLSecondsAfterEmpty, both deleted)."""
    client, clock = lc.client, lc.clock
    prov = client.get("Provisioner", "", "default")
    prov.spec.ttl_seconds_until_expired = 3600
    prov.spec.consolidation = ProvisionerConsolidation(enabled=False)
    client.update(prov)
    names = [n.name for n in client.list("Node", copy_objects=False)][:expire]
    for k, name in enumerate(names):
        node = client.get("Node", "", name)
        node.metadata.creation_timestamp = clock() - 3600 - 600 * (expire - k)
        if k == spot_pinned:
            node.metadata.labels[LABEL_CAPACITY_TYPE] = "spot"
        client.update(node)
        if k == spot_pinned:
            pin = testing.make_pod(name=f"spot-only-{k}", node_name=name, unschedulable=False,
                                   phase="Running", requests={"cpu": "25m"},
                                   node_selector={LABEL_CAPACITY_TYPE: "spot"},
                                   uid=f"uid-spot-only-{k}", creation_timestamp=900.0)
            client.create(pin)
    out = []
    for k, name in enumerate(names):
        rec = lc.run_pass(f"expiration {k + 1}", "expiration")
        if rec["key"][2] != [name]:
            raise AssertionError(f"{lc.label}: expiration {k + 1} removed {rec['key'][2]}, "
                                 f"not the most expired {name}")
        if lc.solver.device.type == "cuda" and not (
                rec["launches"]["screen_prep"] and rec["launches"]["block"]
                and (rec["launches"]["row_n1"] or rec["launches"]["pack_scan"])):
            raise AssertionError(f"{lc.label}: expiration {k + 1}'s simulate solve did not "
                                 f"launch screen_prep, the block and row_n1 or pack_scan: "
                                 f"{rec['launches']}")
        if k == spot_pinned:
            if rec["cmd"].action != "replace":
                raise AssertionError(f"{lc.label}: the spot-pinned node was not replaced")
            # the pod's controller recreates the evicted pod and the
            # scheduler binds it to the replacement launched for it (an
            # empty replacement would be deleted by Emptiness, leaving its
            # Machine record behind: ROADMAP Queue C)
            spot = [n.name for n in client.list("Node", copy_objects=False)
                    if n.name.startswith("fake-machine-")
                    and n.metadata.labels.get(LABEL_CAPACITY_TYPE) == "spot"]
            client.create(testing.make_pod(
                name=f"spot-only-{k}-again", node_name=spot[-1], unschedulable=False,
                phase="Running", requests={"cpu": "25m"},
                node_selector={LABEL_CAPACITY_TYPE: "spot"}, uid=f"uid-spot-only-{k}-again",
                creation_timestamp=900.0))
        out.append(rec)
    api_settings.set_current(api_settings.Settings(drift_enabled=True))
    try:
        lc.cp.drifted = True
        annotate_s = lc.step()
        lc.cp.drifted = False
        lc.loop.sync()
        drifted = sum(1 for n in client.list("Node", copy_objects=False)
                      if n.metadata.annotations.get(VOLUNTARY_DISRUPTION_ANNOTATION_KEY))
        say(f"[{lc.label}] the node controller annotated {drifted} nodes drifted in a "
            f"{annotate_s:.3f} s step")
        out.append(lc.run_pass("drift", "drift"))
    finally:
        api_settings.set_current(api_settings.Settings())
    prov = client.get("Provisioner", "", "default")
    prov.spec.ttl_seconds_after_empty = 30
    client.update(prov)
    universe = lc.cp.get_instance_types()
    empty = []
    for k in range(2):
        node = _node(len(universe) + 7 + k, universe)
        node.metadata.name = f"empty-{k}"
        node.spec.provider_id = f"fake:///empty-{k}"
        client.create(node)
        lc.n0 += 1
        empty.append(node.name)
    lc.step()
    clock.advance(31)
    rec = lc.run_pass("emptiness", "emptiness")
    if not set(empty) <= set(rec["key"][2]):
        raise AssertionError(f"{lc.label}: emptiness removed {rec['key'][2]}, not both "
                             f"empty nodes")
    out.append(rec)
    return out


def phase_lifecycle_pair(devices=("cuda", "cpu"), size=(4500, 400, 200, 100)) -> dict:
    """Phase 9b: at phase 8b's size the same sequence on the card and on
    the CPU (Expiration x1, Drift x1, Emptiness x1, then one pass with
    consolidation enabled, executed) must give the same Commands and
    leave the same cluster. `devices` and `size` (pods, types, nodes,
    distinct classes) let a CPU rehearsal run it small."""
    runs = {}
    for i, device in enumerate(devices):
        n_pods, n_types, n_nodes, distinct = size
        its, client, _cluster, clock = settled_cluster(n_pods, n_types, n_nodes,
                                                       distinct=distinct,
                                                       n_ingress=3 * n_nodes // 2,
                                                       n_sets=max(1, n_nodes // 100))
        del _cluster
        lc = Lifecycle(f"lifecycle 9b {device}", its, client, clock, device)
        lc.step()
        ttl_passes(lc, expire=1, spot_pinned=0)
        prov = client.get("Provisioner", "", "default")
        prov.spec.consolidation = ProvisionerConsolidation(enabled=True)
        client.update(prov)
        lc.run_pass("consolidation", "consolidation")
        runs[i] = lc
    card, cpu = runs[0], runs[1]
    if card.commands != cpu.commands:
        raise AssertionError(f"9b: card and CPU Commands differ: {card.commands} vs "
                             f"{cpu.commands}")
    if card.final_state() != cpu.final_state():
        raise AssertionError("9b: card and CPU leave different clusters")
    return {"passes": [(k[0], k[1], len(k[2]), len(k[3])) for k in card.commands],
            "nodes": len(card.final_state()[0]),
            "card_s": [round((p["compute_ms"] + p["execute_ms"]) / 1e3, 3)
                       for p in card.passes],
            "cpu_s": [round((p["compute_ms"] + p["execute_ms"]) / 1e3, 3)
                      for p in cpu.passes]}


# -- observability (phases 10, 10b and 11) ------------------------------------------

_SAMPLE = re.compile(r'([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\\n]|\\[\\"n])*)"')
_META = re.compile(r'# (HELP|TYPE) ([a-zA-Z_:][a-zA-Z0-9_:]*)( .*)?')


def parse_exposition(text: str) -> dict:
    """Prometheus text (format 0.0.4), line by line: every line a HELP or
    TYPE comment or a sample `name{labels} value`, the labels consumed
    whole, the value a float, a family's samples after its TYPE. Raises on
    anything else. Returns {family: {"type": t, "samples": [(name, labels,
    value)]}}."""
    families, family = {}, None
    for n, line in enumerate(text.split("\n"), 1):
        meta = _META.fullmatch(line)
        if meta:
            kind, name, rest = meta.groups()
            family = families.setdefault(name, {"type": None, "samples": []})
            if kind == "TYPE":
                if rest not in (" counter", " gauge", " histogram") or family["type"]:
                    raise AssertionError(f"exposition line {n}: bad TYPE: {line!r}")
                family["type"] = rest.strip()
            continue
        sample = _SAMPLE.fullmatch(line)
        if not sample:
            raise AssertionError(f"exposition line {n} does not parse: {line!r}")
        name, raw, value = sample.groups()
        labels, pos = {}, 0
        while raw and pos < len(raw):
            lab = _LABEL.match(raw, pos)
            if not lab:
                raise AssertionError(f"exposition line {n}: bad labels: {line!r}")
            labels[lab.group(1)] = lab.group(2)
            pos = lab.end()
            if pos < len(raw):
                if raw[pos] != ",":
                    raise AssertionError(f"exposition line {n}: bad labels: {line!r}")
                pos += 1
        # a sample of a declared family (a gauge may end in _count:
        # karpenter_program_count), else a histogram's _bucket, _sum or
        # _count sample of its base family
        owner = families.get(name)
        if owner is None or owner["type"] is None:
            base = re.sub(r"_(bucket|sum|count)$", "", name)
            owner = families.get(base) if base != name else None
        if owner is None or owner["type"] is None:
            raise AssertionError(f"exposition line {n}: sample before its TYPE: {line!r}")
        owner["samples"].append((name, labels, float(value)))
    return families


def reset_registry() -> None:
    """Every series of the process registry dropped, and the program
    ledger emptied: a fresh exposition, as after a restart, for one
    operator run."""
    for metric in list(REGISTRY.metrics.values()):
        metric.clear()
    proghealth.reset()


def series_of(counter) -> dict:
    """A counter's series as {"label=value,...": value}."""
    return {",".join(f"{k}={v}" for k, v in sorted(labels.items())): value
            for labels, value in counter.series()}


def exposition_values(families: dict, mask=("node_name",)) -> list:
    """Every counter and gauge sample of a parsed exposition, sorted, with
    the `mask` labels blanked (launched nodes take `fake-machine-N` names in
    thread order, each run from its own count)."""
    out = []
    for name, fam in families.items():
        if fam["type"] in ("counter", "gauge"):
            for sample, labels, value in fam["samples"]:
                out.append((sample, tuple(sorted((k, "*" if k in mask else v)
                                                 for k, v in labels.items())), value))
    return sorted(out)


def span_tree(spans) -> list:
    """The spans as an indented name tree, siblings of one name folded
    into one line with their count and summed ms."""
    by_parent = {}
    ids = {sp.span_id for sp in spans}
    for sp in spans:
        by_parent.setdefault(sp.parent_id if sp.parent_id in ids else None, []).append(sp)
    lines = []

    def walk(parent, depth):
        groups = {}
        for sp in by_parent.get(parent, ()):
            groups.setdefault(sp.name, []).append(sp)
        for name, group in groups.items():
            ms = sum(sp.duration_ms for sp in group)
            lines.append(f"{'  ' * depth}{name} x{len(group)} {ms:.3f} ms")
            for sp in group:
                walk(sp.span_id, depth + 1)

    walk(None, 0)
    return lines


# phase spans without a last_phase_ms entry: the warm-state lookup and the
# decode's span of the reference's names, and the log expansion inside it
SPAN_ONLY_PHASES = ("pack", "bind", "expand")


def check_spans(label: str, spans, solve: dict) -> dict:
    """Step 1's spans: one provisioner.reconcile root holding one
    solver.solve of context "provisioning" and a provisioner.launch; each
    solver.phase.<name> span's last occurrence within 1 ms of the solve's
    last_phase_ms[name] (they are read off the same timestamps), and the
    reference's pack and bind spans under the solve. Prints the tree and
    returns the phase spans' names."""
    roots = [sp for sp in spans if sp.name == "provisioner.reconcile"]
    solves = [sp for sp in spans if sp.name == "solver.solve"]
    if len(roots) != 1 or len(solves) != 1 or solves[0].parent_id != roots[0].span_id:
        raise AssertionError(f"{label}: {len(roots)} reconcile roots and {len(solves)} "
                             "solves, or the solve not under the reconcile")
    if solves[0].attrs.get("context") != "provisioning":
        raise AssertionError(f"{label}: solver.solve context "
                             f"{solves[0].attrs.get('context')!r}")
    if not any(sp.name == "provisioner.launch" and sp.parent_id == roots[0].span_id
               for sp in spans):
        raise AssertionError(f"{label}: no provisioner.launch under the reconcile")
    last = {}
    for sp in spans:
        if sp.name.startswith("solver.phase.") and sp.parent_id == solves[0].span_id:
            last[sp.name[len("solver.phase."):]] = sp.duration_ms
    want = solve["phases_raw"]
    off = {k: round(abs(last.get(k, float("inf")) - v), 6) for k, v in want.items()}
    if set(last) - set(want) - set(SPAN_ONLY_PHASES) or any(d > 1.0 for d in off.values()):
        raise AssertionError(f"{label}: phase spans {last} against last_phase_ms {want}")
    if not {"pack", "bind"} <= set(last):
        raise AssertionError(f"{label}: no solver.phase.pack or .bind under the solve: "
                             f"{sorted(last)}")
    tree = span_tree(spans)
    say(f"[{label}] step 1 spans ({len(spans)}):\n" + "\n".join(tree))
    return {"spans": len(spans), "phase_spans": sorted(last),
            "phase_span_vs_last_phase_ms_max_ms": max(off.values())}


def check_exposition(label: str, run: "OperatorRun", n_pending: int, machines: int,
                     decided: int) -> dict:
    """The exposition after step 2: it parses line by line;
    karpenter_nodes_created{reason="provisioning"} equals the machines step
    1 launched; the node metrics cover every node in the client;
    karpenter_admission_to_bind_seconds counted the pods step 1 decided.
    Returns its size, its series, one expose()'s time and the parsed
    families."""
    t0 = time.perf_counter()
    text = REGISTRY.expose()
    expose_s = time.perf_counter() - t0
    families = parse_exposition(text)
    samples = sum(len(f["samples"]) for f in families.values())

    def value(name, **labels):
        family = families.get(re.sub(r"_(bucket|sum|count)$", "", name)) or \
            families.get(name, {"samples": []})
        return sum(v for n, lab, v in family["samples"]
                   if n == name and all(lab.get(k) == w for k, w in labels.items()))

    created = value("karpenter_nodes_created", reason="provisioning")
    if created != machines:
        raise AssertionError(f"{label}: karpenter_nodes_created {created} for {machines} "
                             "machines launched")
    nodes = {n.metadata.name for n in run.client.list("Node", copy_objects=False)}
    covered = {lab["node_name"] for n, lab, _v in
               families.get("karpenter_nodes_allocatable", {"samples": []})["samples"]}
    if covered != nodes:
        raise AssertionError(f"{label}: node metrics cover {len(covered)} nodes of "
                             f"{len(nodes)}")
    counted = value("karpenter_admission_to_bind_seconds_count")
    if counted != decided:
        raise AssertionError(f"{label}: admission to bind counted {counted} of {decided}")
    out = {"bytes": len(text), "families": len(families), "samples": samples,
           "expose_s": round(expose_s, 4), "nodes_created": created,
           "node_series_nodes": len(covered), "admission_to_bind": counted,
           "pending_pods_step1": n_pending}
    say(f"[{label}] exposition after step 2: {json.dumps(out)}")
    out["families_parsed"] = families
    return out


# -- phase 10: the operator ----------------------------------------------------------

OPERATOR_LIMITS = {"cpu": "100000000", "memory": "100000000Gi", "pods": "100000000"}


def operator_cluster(*args, clock=None, **kw):
    """live_cluster(*args, **kw) as the operator meets it: its backlog
    created in the kube client as pending pods, and one provisioner
    "default" with limits no solve reaches. Returns (the pending pods,
    instance types, kube client)."""
    pods, _provs, its, client, _cluster = live_cluster(*args, clock=clock, **kw)
    for p in pods:
        client.create(p)
    client.create(testing.make_provisioner(name="default", limits=OPERATOR_LIMITS))
    return pods, its, client


class OperatorRun:
    """Phase 10: new_operator over a kube client, with a solver from
    solver/factory.build_solver on `device`, on a FakeClock. It times each
    step's parts (sync_state, the provisioning reconcile, the solve and its
    last_phase_ms, the launch, the machine, node and termination
    controllers, the counter, the metrics controllers), keeps each solve's
    result and first snapshot, what the bind listener was told, and each
    pod's nomination calls (before the recorder's dedupe and rate limit).
    The process registry starts empty for each run. With `record`, each
    solve is flight-recorded through FLIGHTREC.begin and finish around the
    operator's solver, its snapshot and commit timed. Gen-2 collections
    are counted and timed in each step, by the part open when each
    starts (`gen2`)."""

    TIMED = (("sync_state", "op", "sync_state"),
             ("reconcile", "provisioning", "reconcile"),
             ("machine", "machine_controller", "reconcile"),
             ("node", "node_controller", "reconcile"),
             ("termination", "termination_controller", "reconcile"),
             ("counter", "counter", "reconcile"),
             ("metrics", "node_metrics", "reconcile"),
             ("metrics", "provisioner_metrics", "reconcile"),
             ("metrics", "provisioner_metrics", "prune"))

    def __init__(self, label, its, client, clock, device="cuda", settings=None,
                 max_nodes=50000 // 5 + 1536, record=False):
        self.label, self.client, self.clock = label, client, clock
        self.cp = fake.FakeCloudProvider(its["default"])
        self.solver = build_solver(max_nodes=max_nodes, device=device)
        self.sync_card = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        reset_registry()
        provisioner.reset_counts()
        self.records = []
        self.op = new_operator(self.cp, kube_client=client,
                               settings=settings or api_settings.Settings(),
                               solver=self.solver, clock=clock)
        self.solves, self.bound, self.nominations, self.launched = [], {}, {}, []
        self.binds = 0
        self.secs = {}
        self.gen2 = _GenTwo()
        op = self.op
        owners = {"op": op, "provisioning": op.provisioning,
                  "machine_controller": op.machine_controller,
                  "node_controller": op.node_controller,
                  "termination_controller": op.termination_controller, "counter": op.counter,
                  "node_metrics": op.node_metrics,
                  "provisioner_metrics": op.provisioner_metrics}
        for key, owner, attr in self.TIMED:
            self._time(key, owners[owner], attr)
        real_launch = op.provisioning._launch_machines_with_errors

        def launch(machines, opts=None):
            names, errors = real_launch(machines, opts)
            self.launched.append((list(machines), names, errors))
            return names, errors

        op.provisioning._launch_machines_with_errors = launch
        self._time("launch", op.provisioning, "_launch_machines_with_errors")
        real_solve, real_encode = self.solver.solve, torch_solver.encode_snapshot

        def solve(*a, **kw):
            snaps, live, rec_s = [], None, 0.0
            if record:
                t0 = time.perf_counter()
                live = FLIGHTREC.begin(*a, daemonset_pods=kw.get("daemonset_pods"),
                                       state_nodes=kw.get("state_nodes"),
                                       kube_client=kw.get("kube_client"),
                                       max_nodes=self.solver.max_nodes)
                rec_s = time.perf_counter() - t0
            torch_solver.encode_snapshot = lambda *ea, **ekw: (
                snaps.append(real_encode(*ea, **ekw)) or snaps[-1])
            t0 = time.perf_counter()
            try:
                res = real_solve(*a, **kw)
                self.sync_card()
            finally:
                torch_solver.encode_snapshot = real_encode
            wall = time.perf_counter() - t0
            if live is not None:
                t1 = time.perf_counter()
                live.finish("torch", res)
                self.records.append({"record": FLIGHTREC.last(), "snapshot_s": rec_s,
                                     "finish_s": time.perf_counter() - t1,
                                     "placements": torch_solver.placements_json(res)})
            self.solves.append({"wall_s": wall, "pods": list(a[0]),
                                "result": res, "snapshot": (snaps[0], a[1]) if snaps else None,
                                "phases_ms": {k: round(v, 3) for k, v in
                                              self.solver.last_phase_ms.items()},
                                "phases_raw": dict(self.solver.last_phase_ms),
                                "scan": dict(pack.LAST_SCAN)})
            return res

        self.solver.solve = solve
        op.provisioning.bind_listeners.append(self._bind)
        real_nominate = op.recorder.nominate_pod

        def nominate(pod, node_name):
            key = (pod.metadata.namespace, pod.metadata.name)
            self.nominations[key] = self.nominations.get(key, 0) + 1
            real_nominate(pod, node_name)

        op.recorder.nominate_pod = nominate

    def _time(self, key, owner, attr):
        real = getattr(owner, attr)

        def timed(*a, **kw):
            self.gen2.parts.append(key)
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                self.secs[key] = self.secs.get(key, 0.0) + time.perf_counter() - t0
                self.gen2.parts.pop()

        setattr(owner, attr, timed)

    def _bind(self, pod, node_name):
        self.binds += 1
        self.bound[(pod.metadata.namespace, pod.metadata.name)] = node_name

    def step(self, name: str) -> dict:
        """One op.step(); its wall and parts, seconds."""
        self.secs = {}
        n_solves = len(self.solves)
        gen2 = self.gen2.mark()
        gc.callbacks.append(self.gen2)
        t0 = time.perf_counter()
        try:
            summary = self.op.step()
            self.sync_card()
        finally:
            gc.callbacks.remove(self.gen2)
        wall = time.perf_counter() - t0
        solves = self.solves[n_solves:]
        parts = {k: round(v, 3) for k, v in self.secs.items()}
        gen2 = self.gen2.since(gen2)
        rec = {"name": name, "wall_s": round(wall, 3), "parts_s": parts, "summary": summary,
               "solves": solves, "gen2": gen2}
        say(f"[{self.label}] {name}: {wall:.3f} s wall, launched {summary['launched']}; parts "
            f"(s) {json.dumps(parts)}; gen-2 collections {json.dumps(gen2)}"
            + "".join(f"; solve of {len(sv['pods'])} pods {sv['wall_s']:.3f} s, "
                      f"last_phase_ms {json.dumps(sv['phases_ms'])}" for sv in solves))
        return rec

    def kubelet(self) -> dict:
        """Every launched node turns Ready with its machine's capacity, and
        every pod binds where the bind listener was told."""
        t0 = time.perf_counter()
        ready = mark_launched_ready(self.client)
        for stored in self.client.list("Pod", copy_objects=False):
            node_name = self.bound.get((stored.metadata.namespace, stored.metadata.name))
            if node_name and not stored.spec.node_name:
                # update() stores a deep copy of what it is given
                pod = copy.copy(stored)
                pod.spec, pod.status = copy.copy(stored.spec), copy.copy(stored.status)
                pod.metadata = copy.copy(stored.metadata)
                pod.spec.node_name = node_name
                pod.status.phase = "Running"
                self.client.update(pod)
        return {"ready": ready, "bound": len(self.bound), "s": time.perf_counter() - t0}

    def counters(self) -> dict:
        return {"launch_failures": {r: provisioner.LAUNCH_FAILURES.get({"reason": r})
                                    for r in ("insufficient_capacity", "transient", "error")},
                "retriggers": provisioner.LAUNCH_RESOLVE_RETRIGGERS.get(),
                "nodes_created": provisioner.NODES_CREATED.get({"reason": "provisioning"}),
                "fallbacks": provisioner.FALLBACKS["solver"],
                "reconcile_errors": series_of(operator_controller.RECONCILE_ERRORS)}

    def pending(self) -> list:
        return [p for p in self.client.list("Pod", copy_objects=False)
                if not p.spec.node_name]


def check_operator_pass(run: "OperatorRun", rec: dict, n_pods: int) -> dict:
    """Step 1 of phase 10: one solve whose placements pass
    check_placements and check_cluster_usage; every launched machine has
    its Machine and its Node in the client; the bind listener was told of
    every placed pod once; each placed pod was nominated once and the
    recorder kept as many Nominated events as its token bucket allows;
    no fallback and no launch failure."""
    label, client = run.label, run.client
    if len(rec["solves"]) != 1:
        raise AssertionError(f"{label}: {len(rec['solves'])} solves in the first step")
    result = rec["solves"][0]["result"]
    if result.failed_pods:
        raise AssertionError(f"{label}: {len(result.failed_pods)} pods failed, e.g. "
                             f"{result.failed_pods[0].metadata.name}")
    usage = check_placements(result, n_pods, client)
    machines, names, errors = run.launched[-1]
    if errors or not all(names) or len(names) != len(result.new_machines):
        raise AssertionError(f"{label}: {len(errors)} launches failed")
    for name in names:
        if client.get("Machine", "", name) is None or client.get("Node", "", name) is None:
            raise AssertionError(f"{label}: launched {name} has no Machine or Node")
    placed = {(p.metadata.namespace, p.metadata.name) for m in result.new_machines
              for p in m.pods}
    placed |= {(p.metadata.namespace, p.metadata.name) for _n, ps in
               result.existing_assignments for p in ps}
    if set(run.bound) != placed or run.binds != len(placed):
        raise AssertionError(f"{label}: the bind listener heard {run.binds} binds of "
                             f"{len(run.bound)} pods for {len(placed)} placed")
    if set(run.nominations) != placed or any(v != 1 for v in run.nominations.values()):
        raise AssertionError(f"{label}: nominations differ from the placed pods")
    kept = sum(1 for e in run.op.recorder.events if e.reason == "Nominated")
    burst = run.op.recorder.POD_NOMINATION_RATE_LIMIT[1]
    if kept != min(len(placed), burst):  # the bucket does not refill on a still clock
        raise AssertionError(f"{label}: {kept} Nominated events kept, expected "
                             f"{min(len(placed), burst)}")
    counters = run.counters()
    if counters["fallbacks"] or any(counters["launch_failures"].values()):
        raise AssertionError(f"{label}: counters {counters}")
    return {"placed": len(placed), "machines": len(names), "usage": usage,
            "nominated_kept": kept}


def check_operator_settled(run: "OperatorRun", rec: dict) -> dict:
    """Step 2 of phase 10: no solve, every machine initialized, the
    counter's resources the summed capacity of the provisioner's nodes,
    and the inflight checks find nothing on any node."""
    label, client = run.label, run.client
    if rec["solves"]:
        raise AssertionError(f"{label}: the settled step solved")
    machines = client.list("Machine", copy_objects=False)
    if not all(m.condition_true(CONDITION_MACHINE_INITIALIZED) for m in machines):
        raise AssertionError(f"{label}: a machine is not initialized")
    nodes = client.list("Node", copy_objects=False)
    want = resources.merge(*(n.status.capacity for n in nodes
                             if n.metadata.labels.get(PROVISIONER_NAME_LABEL_KEY) == "default"))
    got = client.get("Provisioner", "", "default").status.resources
    if got != want:
        raise AssertionError(f"{label}: status.resources {got} != the nodes' {want}")
    t0 = time.perf_counter()
    for node in client.list("Node"):
        run.op.inflight_checks.reconcile(node)
    inflight_s = time.perf_counter() - t0
    findings = [e for e in run.op.recorder.events if e.reason == "FailedInflightCheck"]
    if findings:
        raise AssertionError(f"{label}: inflight findings {findings[:3]}")
    return {"machines": len(machines), "nodes": len(nodes), "inflight_s": round(inflight_s, 3),
            "resources": {k: want[k] for k in sorted(want)}}


def phase_operator(label, size, device="cuda", max_nodes=50000 // 5 + 1536,
                   record=False, trace_path=None, steps: int = 2) -> dict:
    """Phase 10: the operator over operator_cluster(*size) on `device`,
    instrumented as a deployment runs it (the tracer on, the metrics
    controllers in step(), the provider decorated per controller): step 1
    provisions the backlog (check_operator_pass, check_spans, the pending
    pods gauge), then, with steps=2, a kubelet pass and step 2 settles
    (check_operator_settled, check_exposition). The screen's launch counts
    are zeroed just before step 1 and read after the last step. With
    `trace_path` the tracer's Chrome trace is exported there."""
    n_pods, n_types, n_nodes, distinct, kw = size
    clock = testing.FakeClock()
    t0 = time.perf_counter()
    pods, its, client = operator_cluster(n_pods, n_types, n_nodes, distinct=distinct,
                                         clock=clock, **kw)
    build_s = time.perf_counter() - t0
    run = OperatorRun(label, its, client, clock, device, max_nodes=max_nodes, record=record)
    say(f"[{label}] {len(pods)} pending pods, {n_nodes} nodes, "
        f"{len(client.list('Pod', copy_objects=False)) - len(pods)} bound pods in the "
        f"client, built in {build_s:.2f} s")
    TRACER.enable()
    TRACER.clear()
    screen.reset_launches()
    seq = TRACER.mark()
    first = run.step("step 1")
    spans = check_spans(label, TRACER.spans_since(seq), first["solves"][0])
    passed = check_operator_pass(run, first, len(pods))
    pending = REGISTRY.gauge("karpenter_pending_pods").get()
    if pending != len(pods):
        raise AssertionError(f"{label}: karpenter_pending_pods {pending} after step 1 for "
                             f"{len(pods)} pending")
    decided = run.binds
    done = [first]
    kubelet = settled = expo = None
    if steps == 2:
        kubelet = run.kubelet()
        second = run.step("step 2")
        done.append(second)
        settled = check_operator_settled(run, second)
        if REGISTRY.gauge("karpenter_pending_pods").get() != 0:
            raise AssertionError(f"{label}: karpenter_pending_pods not 0 after step 2")
    counts = screen.launch_counts()
    if steps == 2:
        expo = check_exposition(label, run, len(pods), passed["machines"], decided)
    trace_bytes = None
    if trace_path:
        TRACER.export_chrome_trace(trace_path)
        trace_bytes = os.path.getsize(trace_path)
        say(f"[{label}] Chrome trace of the phase's {len(TRACER.spans())} spans: "
            f"{trace_bytes} bytes at {trace_path}")
    run.op.recorder.flush(timeout=60.0)
    events = len(client.list("Event", copy_objects=False))
    settle = (f"kubelet {kubelet['ready']} nodes Ready, {kubelet['bound']} pods bound in "
              f"{kubelet['s']:.2f} s; step 2 checked {json.dumps(settled)}" if kubelet
              else "no step 2")
    say(f"[{label}] step 1 checked {json.dumps(passed)}; {settle}; events posted {events}; "
        f"counters {json.dumps(run.counters())}; launches {json.dumps(counts)}")
    return {"run": run, "steps": done, "launches": counts, "events": events,
            "passed": passed, "settled": settled, "spans": spans, "exposition": expo,
            "trace_bytes": trace_bytes}


def operator_outcome(run: "OperatorRun") -> dict:
    """What phase 10b compares between the card and the CPU."""
    result = run.solves[0]["result"]
    options = sorted(
        tuple(sorted(v for r in c.spec.requirements if r.key == LABEL_INSTANCE_TYPE_STABLE
                     for v in r.values))
        for c in run.cp.create_calls)
    return {"placements": torch_solver.placements_json(result), "options": options,
            "events": sorted((e.reason, e.involved_kind) for e in run.op.recorder.events),
            "resources": run.client.get("Provisioner", "", "default").status.resources,
            "counters": run.counters()}


# the counters and gauges whose values are seconds (the program ledger's
# first-dispatch seconds): 10b compares neither, as it compares no duration
TIMED_FAMILIES = ("karpenter_program_compile_seconds_total",)


def operator_exposition(out: dict) -> list:
    """What 10b compares of a run's exposition after step 2: every counter
    and gauge sample (durations excluded: they are histograms, or counters
    of seconds, TIMED_FAMILIES)."""
    families = {k: v for k, v in out["exposition"]["families_parsed"].items()
                if k not in TIMED_FAMILIES}
    return exposition_values(families)


# phase 10b at half of 3c's pods and nodes (2,600 pending, 3,000 bound,
# under the flight recorder's cap, and two StatefulSets with claims); its
# cap leg still two passes
PAIR_SIZE = (2250, 400, 100, 100, dict(n_ingress=150, n_sets=2))
PAIR_CAP = 1300
# the smoke's clock: with phase 12 the whole script ran 855.5-1,228.7 s of
# its 1,200 s limit on two cards, so phases 6b, 7, 8b, 9b and 10b's cap leg
# run cut: two screen turns, half of 3c's pods and nodes for 8b and 9b, two
# cap passes; phase 13 (about 50 s) took phase 7 from three churn steps to
# two (a full step, then a refresh: about 13 s a step)
PAIR_HALF = (2250, 400, 100, 100)
# phase 9b at a quarter of 3c's pods and nodes (half of 8b's): the depth
# cut that, with phase 8 at 400 nodes and 6b's one turn, pays for phase 16
PAIR_QUARTER = (1125, 400, 50, 50)
CHURN_STEPS = 2
# phase 11's operator record: 1,500 bound pods (under the recorder's
# 4,096-pod cap, so the record keeps them) and no pending claim pods (the
# record carries no PersistentVolumeClaim, StorageClass or CSINode)
RECORD_SIZE = (2500, 100, 50, 50, dict(n_sets=0))


def phase_operator_pair(devices=("cuda", "cpu"), size=PAIR_SIZE) -> dict:
    """Phase 10b: phase 10's script at PAIR_SIZE on the card and on the CPU
    (equal placements, launched machines' options, (reason, kind) events,
    counter resources, counters and every counter and gauge of the
    exposition); then on the card an ICE leg and a batch-cap leg. The
    card's step-1 solve is flight-recorded (phase 11 replays it)."""
    runs = {dev: phase_operator(f"operator 10b {dev}", size, dev, max_nodes=1512,
                                record=dev == devices[0])
            for dev in devices}
    outcome = {dev: dict(operator_outcome(r["run"]), exposition=operator_exposition(r))
               for dev, r in runs.items()}
    if outcome[devices[0]] != outcome[devices[1]]:
        diff = [k for k in outcome[devices[0]]
                if outcome[devices[0]][k] != outcome[devices[1]][k]]
        raise AssertionError(f"10b: card and CPU operator outcomes differ in {diff}")
    card = runs[devices[0]]["run"]
    types = {}
    for name in card.launched[0][1]:
        it = card.client.get("Node", "", name).metadata.labels[LABEL_INSTANCE_TYPE_STABLE]
        types[it] = types.get(it, 0) + 1
    pool = max(sorted(types), key=types.get)
    out = {"machines": len(card.launched[0][1]), "ice": phase_ice(pool, size, devices[0]),
           "cap": phase_cap(size, devices[0], cap=PAIR_CAP), "record": card.records[0],
           "exposition_samples": len(outcome[devices[0]]["exposition"])}
    say(f"[operator 10b] card and CPU agree: {len(outcome[devices[0]]['placements'])} bytes "
        f"of placements, {len(outcome[devices[0]]['options'])} launches, "
        f"{out['exposition_samples']} counter and gauge samples; ICE leg "
        f"{json.dumps(out['ice'])}; cap leg {json.dumps(out['cap'])}")
    return out


def phase_ice(pool: str, size, device) -> dict:
    """10b's ICE leg: `pool` (the instance type the first solve launched
    most) exhausted in every zone and capacity type. Its launches fail and
    the ICE cache masks it; once the placed pods bind, reconcile's wait
    fires the re-trigger and the next pass re-solves the pods left, which
    all find a machine off the masked pool."""
    n_pods, n_types, n_nodes, distinct, kw = size
    clock = testing.FakeClock()
    pods, its, client = operator_cluster(n_pods, n_types, n_nodes, distinct=distinct,
                                         clock=clock, **kw)
    settings = api_settings.Settings(batch_idle_duration=0.05, batch_max_duration=1.0)
    run = OperatorRun("operator 10b ice", its, client, clock, device, settings=settings,
                      max_nodes=1512)
    run.cp.insufficient_capacity = {(pool, "", "")}
    first = run.step("ice step")
    failed = run.counters()["launch_failures"]["insufficient_capacity"]
    keys = run.op.provisioning.ice_cache.keys()
    if not failed or keys != [(pool, "", "")]:
        raise AssertionError(f"10b ice: {failed} ICE launch failures, cache {keys}")
    run.kubelet()
    run.op.sync_state()
    residual = len(run.pending())
    n_solves, deadline = len(run.solves), time.monotonic() + 60.0
    while len(run.solves) == n_solves and time.monotonic() < deadline:
        run.op.provisioning.reconcile(wait_timeout=0.5)
    if len(run.solves) == n_solves or run.counters()["retriggers"] < 1:
        raise AssertionError(f"10b ice: no re-trigger re-solved the {residual} pods left")
    resolve = run.solves[-1]
    if len(resolve["pods"]) != residual or resolve["result"].failed_pods:
        raise AssertionError(f"10b ice: the re-solve took {len(resolve['pods'])} pods "
                             f"for {residual} left")
    run.kubelet()
    run.op.sync_state()
    if run.pending():
        raise AssertionError(f"10b ice: {len(run.pending())} pods still pending")
    on_pool = [n.name for n in client.list("Node", copy_objects=False)
               if n.name.startswith("fake-machine-")
               and n.metadata.labels.get(LABEL_INSTANCE_TYPE_STABLE) == pool]
    if on_pool:
        raise AssertionError(f"10b ice: nodes on the masked pool {on_pool[:3]}")
    return {"pool": pool, "ice_failures": failed, "residual": residual,
            "retriggers": run.counters()["retriggers"],
            "first_wall_s": first["wall_s"], "resolve_s": round(resolve["wall_s"], 3)}


def phase_cap(size, device, cap: int = 1000) -> dict:
    """10b's cap leg: with batch_max_pods=`cap`, passes of `cap` pods, each
    re-triggering the batcher, until the backlog is empty."""
    n_pods, n_types, n_nodes, distinct, kw = size
    clock = testing.FakeClock()
    pods, its, client = operator_cluster(n_pods, n_types, n_nodes, distinct=distinct,
                                         clock=clock, **kw)
    run = OperatorRun("operator 10b cap", its, client, clock, device,
                      settings=api_settings.Settings(batch_max_pods=cap), max_nodes=1512)
    sizes, retriggered = [], []
    for i in range((len(pods) + cap - 1) // cap + 2):
        rec = run.step(f"cap pass {i}")
        sizes += [len(sv["pods"]) for sv in rec["solves"]]
        retriggered.append(run.op.provisioning.batcher._trigger.is_set())
        run.op.provisioning.batcher._trigger.clear()
        run.kubelet()
        if not run.pending():
            break
    want = [cap] * (len(pods) // cap) + ([len(pods) % cap] if len(pods) % cap else [])
    if sizes != want or run.pending() or retriggered[:len(want) - 1] != [True] * (len(want) - 1):
        raise AssertionError(f"10b cap: passes {sizes} (want {want}), re-triggered "
                             f"{retriggered}, {len(run.pending())} pending")
    return {"passes": sizes, "retriggered": retriggered[:len(want)]}


# -- phase 11: flight records replayed on the card ------------------------------

# why a recorded subset's screen verdict and its exact re-solve may differ
# (flightrec.replay_consolidation): the screen is the round-0 kernel while
# the exact solve relaxes, so the solve may accept a subset the screen
# refused, which is expected; the other way the screen passed a subset the
# exact solve refuses, which the exact confirmation catches before any
# Command executes
DISAGREE_REASON = {
    True: "exact solve more permissive: the screen is the round-0 kernel and the "
          "solve relaxes (expected)",
    False: "screen more permissive than the exact solve (the exact confirmation "
           "catches it before a Command executes)",
}


def replay_consolidation_record(label: str, record: dict) -> dict:
    """A consolidation record, through JSON and back, replayed subset by
    subset through the exact solve on the card; fatal when the chosen
    Command is not confirmed. Prints the subsets whose verdicts disagree,
    with the reason for their direction."""
    record = json.loads(json.dumps(record))
    if "inputs" not in record:
        raise AssertionError(f"{label}: the record carries no inputs "
                             f"(inputsOmitted={record.get('inputsOmitted')})")
    screen.reset_launches()
    t0 = time.perf_counter()
    out = flightrec.replay_consolidation(record, "torch")
    wall = time.perf_counter() - t0
    counts = screen.launch_counts()
    if not out["chosen_feasible_seq"]:
        raise AssertionError(f"{label}: the chosen Command {out['chosen']} is not confirmed "
                             "by the exact re-solve")
    if counts["screen_prep"] < 1:
        raise AssertionError(f"{label}: the replay launched no screen on the card")
    disagree = [s for s in out["subsets"] if not s["agrees"]]
    say(f"[replay] {label}: {len(out['subsets'])} subsets re-solved on the card in "
        f"{wall:.3f} s, chosen {json.dumps(out['chosen'])} confirmed; sequential pick "
        f"{out['seq_pick']}; {len(disagree)} subsets disagree; launches {json.dumps(counts)}")
    for sub in disagree:
        say(f"[replay] {label}: subset {sub['members']}: screen all-scheduled "
            f"{sub['allScheduled']} with {sub['nNewMachines']} new, exact "
            f"{sub['seqAllScheduled']} with {sub['seqNewMachines']} new: "
            + DISAGREE_REASON[bool(sub["seqAllScheduled"] and sub["seqNewMachines"] <= 1)])
    return {"subsets": len(out["subsets"]), "disagree": len(disagree), "wall_s": wall,
            "launches": counts}


def replay_solve_record(label: str, taken: dict, must_match_live: bool) -> dict:
    """A solve record (taken around a live solve: its record, the snapshot
    and commit times, the live placements), through JSON and back,
    restored and solved on the card and on the CPU. Fatal: card and CPU
    placements that differ, and card placements not byte-identical to the
    live solve's unless the record lacks what that solve read (bound pods
    past the recorder's cap, or claims: a record carries no
    PersistentVolumeClaim, StorageClass or CSINode) and not
    `must_match_live`."""
    record = taken["record"]
    t0 = time.perf_counter()
    blob = json.dumps(record)
    record = json.loads(blob)
    codec_s = time.perf_counter() - t0
    inputs = record["inputs"]
    screen.reset_launches()
    t0 = time.perf_counter()
    card, result = flightrec.replay(record)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = screen.launch_counts()
    t0 = time.perf_counter()
    cpu, _ = flightrec.replay(record, device="cpu")
    cpu_s = time.perf_counter() - t0
    a, b = flightrec.placements_json(card), flightrec.placements_json(cpu)
    if a != b:
        raise AssertionError(f"{label}: card and CPU replays differ: "
                             f"{flightrec.diff_placements(card, cpu)[:4]}")
    if counts["screen_prep"] < 1:
        raise AssertionError(f"{label}: the replay launched no screen on the card")
    live = a == taken["placements"]
    omitted = inputs.get("clusterOmitted")
    # pods, pending or bound, that mount a claim the record does not carry
    claim_pods = sum(
        any("persistentVolumeClaim" in v for v in d.get("spec", {}).get("volumes") or ())
        for d in list(inputs["pods"]) + list(inputs.get("clusterPods", ())))
    out = {"bytes": len(blob), "pods": len(inputs["pods"]),
           "state_nodes": len(inputs["stateNodes"]),
           "cluster_pods": len(inputs.get("clusterPods", ())), "cluster_omitted": omitted,
           "claim_pods": claim_pods,
           "snapshot_s": round(taken["snapshot_s"], 3), "finish_s": round(taken["finish_s"], 3),
           "json_round_trip_s": round(codec_s, 3), "replay_card_s": round(card_s, 3),
           "replay_cpu_s": round(cpu_s, 3), "digest": record["digest"],
           "identical_to_live": live, "launches": counts}
    say(f"[replay] {label}: {json.dumps(out)}")
    if not live:
        diff = flightrec.diff_placements(json.loads(taken["placements"]), card)
        why = []
        if omitted:
            why.append(f"the record omits the cluster context ({omitted} bound pods past "
                       f"the reference's cap of {flightrec.MAX_CLUSTER_SNAPSHOT_PODS}), so "
                       "the replay counts no bound pod in topology and has no Cluster")
        if claim_pods:
            why.append(f"{claim_pods} of its pods mount claims, and the record carries no "
                       "PersistentVolumeClaim, StorageClass or CSINode")
        say(f"[replay] {label}: the replay differs from the live solve "
            f"({'; '.join(why) or 'the record holds all the solve read'}): {diff[:4]}")
        if must_match_live or not why:
            raise AssertionError(f"{label}: the card's replay is not byte-identical to "
                                 "the live solve")
    return out


# -- phase 12: the fallback paths on the card ---------------------------------

# phase 3c's pods and nodes, with 18 pods bound a node (3,978 bound pods,
# under the flight recorder's cap of 4,096) and no StatefulSet claims (a
# record carries no PersistentVolumeClaim), so the live solve's record holds
# its whole cluster context and can replay to its placements: phase 13's
# cluster, and phase 12's at half of it
PHASE12_SIZE = (4500, 400, 200, 100, dict(n_ingress=300, n_sets=0, per_node=18))
# phase 12 at half of it (2,400 pods over 100 nodes, 1,800 bound): the
# depth cut that, with 10b at half of 3c's size and phase 8 at 200 nodes,
# pays for phase 17
DRILL_SIZE = (2250, 400, 100, 100, dict(n_ingress=150, n_sets=0, per_node=18))
# phases 14b and 16b at a quarter of phase 13's cluster (1,200 pods over 50
# nodes, 900 bound): the depth cut that keeps the smoke under 1,000 s on a
# host 20% slower than the one it was sized on (991.4 s printed there with
# both at half)
QUARTER_SIZE = (1125, 400, 50, 100, dict(n_ingress=75, n_sets=0, per_node=18))
# ResilientSolver as the reference's process entry wraps its primary
# (operator/__main__.py:636-668)
RESILIENT_KW = dict(solve_timeout=900.0, wedge_stale_after=600.0)
FALLBACK_SERIES = ("SOLVER_FALLBACK_TOTAL", "SOLVER_SMALL_BATCH_TOTAL", "SOLVER_WEDGED_TOTAL",
                   "SOLVER_ABANDONED_TOTAL", "BREAKER_TRANSITIONS")


def fallback_counts() -> dict:
    """Every series of solver/fallback.py, by labels."""
    return {(name, tuple(sorted(labels.items()))): v for name in FALLBACK_SERIES
            for labels, v in getattr(fallback, name).series()}


def counts_moved(before: dict) -> dict:
    """The series that moved since `before`, by how much, as strings."""
    after = fallback_counts()
    return {f"{name}{dict(labels)}": v - before.get((name, labels), 0.0)
            for (name, labels), v in after.items() if v != before.get((name, labels), 0.0)}


class TimedSolver:
    """A solver that keeps the wall time and the result of its last solve."""

    def __init__(self, solver):
        self.solver = solver
        self.wall_s = None
        self.result = None

    def solve(self, *a, **k):
        t0 = time.perf_counter()
        self.result = self.solver.solve(*a, **k)
        self.wall_s = time.perf_counter() - t0
        return self.result


class WedgeOnce:
    """The card's solver behind a wedge: its first solve goes silent, not
    touching the bound heartbeat, BEFORE it enters TorchSolver.solve, until
    released; it then raises without entering it, so a thread the watchdog
    abandons never touches the card. Later solves go straight through."""

    def __init__(self, solver):
        self.solver = solver
        self.release = threading.Event()
        self.armed = True

    @property
    def max_nodes(self):
        return self.solver.max_nodes

    def solve(self, *a, **k):
        if self.armed:
            self.armed = False
            self.release.wait(120.0)
            raise RuntimeError("the wedged dispatch was released")
        return self.solver.solve(*a, **k)


class TimedProbe:
    """The real subprocess card probe (fallback.probe_backend), timed."""

    def __init__(self):
        self.seconds = []
        self.reasons = []

    def __call__(self):
        t0 = time.perf_counter()
        reason = fallback.probe_backend(60.0)
        self.seconds.append(round(time.perf_counter() - t0, 3))
        self.reasons.append(reason)
        return reason


def equivalence_bar(label, device, host, n_pods: int, kube_client=None, zones=None) -> dict:
    """tests/test_differential_fuzz.py's bar between a device result and a
    host one: every constraint holds in both (check_placements, and with
    zones check_topology), the device fails no more pods than the host and
    opens at most one machine more."""
    for res in (device, host):
        check_placements(res, n_pods, kube_client)
        if zones:
            check_topology(res, zones, kube_client)
    out = {"device": [len(device.new_machines), len(device.failed_pods)],
           "host": [len(host.new_machines), len(host.failed_pods)]}
    if len(device.failed_pods) > len(host.failed_pods):
        raise AssertionError(f"{label}: the device failed more pods than the host: {out}")
    if len(device.new_machines) > len(host.new_machines) + 1:
        raise AssertionError(f"{label}: the device opened more than one machine more than "
                             f"the host: {out}")
    return out


def expect_moved(label, before: dict, want: dict) -> dict:
    got = counts_moved(before)
    if got != want:
        raise AssertionError(f"{label}: the fallback series moved {got}, expected {want}")
    return got


def _fixed_cost(device, n_pods: int, n_types: int, reps: int = 5) -> dict:
    """One small batch (n_pods generic pods over n_types instance types, one
    provisioner) through TorchSolver and through GreedySolver: the median
    of `reps` warm solves each (one solve before them warms up)."""
    its = {"default": fake.instance_types(n_types)}
    provs = [testing.make_provisioner(name="default")]
    pods = [testing.make_pod(name=f"small-{i}", requests={"cpu": ["250m", "500m", "1"][i % 3],
                                                           "memory": "512Mi"},
                             uid=f"uid-small-{i:05d}", creation_timestamp=1000.0)
            for i in range(n_pods)]
    out = {"pods": n_pods, "types": n_types, "work": n_pods * n_types}
    for name, solver in (("card", torch_solver.TorchSolver(max_nodes=1024, device=device)),
                         ("greedy", torch_solver.GreedySolver())):
        walls = []
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            res = solver.solve(pods, provs, its)
            if device == "cuda":
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[f"{name}_ms"] = round(float(np.median(walls[1:])) * 1e3, 3)
        out[f"{name}_failed"] = len(res.failed_pods)
    return out


def phase_fallback(device="cuda", size=DRILL_SIZE, stale_s: float = 3.0,
                   prober=None) -> dict:
    """Phase 12: the fallback paths. `prober` replaces the real subprocess
    card probe only to rehearse the phase on the CPU. The gen-2 collections
    that start in each wrapped solve are counted (`gen2`)."""
    prober = prober or TimedProbe()
    gen2 = _GenTwo()
    gc.callbacks.append(gen2)
    # the earlier phases' long-lived objects stay out of this phase's
    # collections: one gen-2 collection of the whole heap took 13.0 s inside
    # a wrapped solve on one card's host
    gc.freeze()
    try:
        return _phase_fallback(device, size, stale_s, prober, gen2)
    finally:
        gc.unfreeze()
        gc.callbacks.remove(gen2)


def _phase_fallback(device, size, stale_s, prober, gen2) -> dict:
    n_pods, n_types, n_nodes, distinct, kw = size
    pods, provs, its, client, cluster = live_cluster(n_pods, n_types, n_nodes,
                                                     distinct=distinct, **kw)
    zones = _zones(its)
    n = len(pods)
    solve_kw = dict(kube_client=client, cluster=cluster)
    out = {"pods": n, "nodes": n_nodes, "bound": len(cluster.bindings)}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def build():
        return build_solver(max_nodes=1512, device=device)

    # 12a: the card's solver through the wrapper, against it unwrapped
    t0 = time.perf_counter()
    plain = build().solve(pods, provs, its, state_nodes=cluster.nodes(), **solve_kw)
    sync()
    out["plain_s"] = round(time.perf_counter() - t0, 3)
    resilient = fallback.ResilientSolver(build(), torch_solver.GreedySolver(), prober=prober,
                                         **RESILIENT_KW)
    FLIGHTREC.enable()
    FLIGHTREC.clear()
    before = fallback_counts()
    mark = gen2.mark()
    screen.reset_launches()
    t0 = time.perf_counter()
    served = resilient.solve(pods, provs, its, state_nodes=cluster.nodes(), **solve_kw)
    sync()
    out["wrapped_s"] = round(time.perf_counter() - t0, 3)
    out["wrapped_gen2"] = gen2.since(mark)
    launches = screen.launch_counts()
    out["launches"] = launches
    out["moved_12a"] = expect_moved("12a", before, {})
    if torch_solver.placements_json(served) != torch_solver.placements_json(plain):
        raise AssertionError("12a: the wrapped solve differs from the unwrapped TorchSolver's")
    if device == "cuda" and (launches["screen_prep"] < 1 or launches["block"] < 1):
        raise AssertionError(f"12a: the wrapped solve launched {json.dumps(launches)}")
    record = FLIGHTREC.last()
    if record is None or (record["backend"], record["replayer"]) != ("primary", "torch"):
        raise AssertionError(f"12a: the live record is {record and record['backend']}")
    if record["inputs"].get("clusterOmitted"):
        raise AssertionError("12a: the record omits its cluster context")
    out["record_solve_ms"] = record["duration_ms"]
    t0 = time.perf_counter()
    replayed, _ = flightrec.replay(json.loads(json.dumps(record)), device=device)
    sync()
    out["replay_s"] = round(time.perf_counter() - t0, 3)
    if flightrec.placements_json(replayed) != torch_solver.placements_json(served):
        raise AssertionError(f"12a: the primary record's replay differs: "
                             f"{flightrec.diff_placements(replayed, flightrec.canonical_placements(served))[:4]}")
    out["probe_s_12a"] = list(getattr(prober, "seconds", []))
    check_placements(served, n, client)
    say(f"[fallback 12a] the card through ResilientSolver: {json.dumps(out)}")

    # 12b: a wedge before TorchSolver is entered, the fallback, the record,
    # and re-admission through the real probe on a fake clock
    clock = testing.FakeClock()
    events = Recorder(clock=clock)
    wedge = WedgeOnce(build())
    greedy = TimedSolver(torch_solver.GreedySolver())
    resilient = fallback.ResilientSolver(wedge, greedy, recorder=events, clock=clock,
                                         prober=prober, solve_timeout=900.0,
                                         wedge_stale_after=stale_s, watchdog_poll=0.25)
    probes_before = len(getattr(prober, "seconds", []))
    before = fallback_counts()
    FLIGHTREC.clear()
    mark = gen2.mark()
    t0 = time.perf_counter()
    host = resilient.solve(pods, provs, its, state_nodes=cluster.nodes(), **solve_kw)
    wedge_s = time.perf_counter() - t0
    wedge_gen2 = gen2.since(mark)
    wedge.release.set()
    moved = expect_moved("12b wedge", before, {
        "SOLVER_WEDGED_TOTAL{}": 1.0, "SOLVER_ABANDONED_TOTAL{'kind': 'wedged'}": 1.0,
        "SOLVER_FALLBACK_TOTAL{'reason': 'wedged'}": 1.0,
        "BREAKER_TRANSITIONS{'breaker': 'solver.device', 'to': 'open'}": 1.0})
    if resilient.breaker.state != fallback.CircuitBreaker.OPEN:
        raise AssertionError(f"12b: the breaker is {resilient.breaker.state} after the wedge")
    if host is not greedy.result:
        raise AssertionError("12b: the wedged solve was not served by GreedySolver")
    check_placements(host, n, client)
    record = FLIGHTREC.last()
    if (record["backend"], record["replayer"]) != ("host.primary_error", "greedy") or (
            "SolverWedgedError" not in record.get("primary_error", "")):
        raise AssertionError(f"12b: the fallback record is {record['backend']}/"
                             f"{record['replayer']}")
    t0 = time.perf_counter()
    replayed, _ = flightrec.replay(json.loads(json.dumps(record)))
    greedy_replay_s = time.perf_counter() - t0
    if flightrec.placements_json(replayed) != torch_solver.placements_json(host):
        raise AssertionError("12b: the host.primary_error record's greedy replay differs")
    deadline = time.monotonic() + 30.0
    while resilient.health_report()["abandoned_live"] and time.monotonic() < deadline:
        time.sleep(0.1)
    report = resilient.health_report()
    if (report["abandoned_total"], report["abandoned_live"]) != (1, 0):
        raise AssertionError(f"12b: abandoned threads {report['abandoned_threads']}")
    clock.advance(resilient.reprobe_interval)
    before = fallback_counts()
    mark = gen2.mark()
    screen.reset_launches()
    t0 = time.perf_counter()
    back = resilient.solve(pods, provs, its, state_nodes=cluster.nodes(), **solve_kw)
    sync()
    back_s = time.perf_counter() - t0
    back_gen2 = gen2.since(mark)
    back_launches = screen.launch_counts()
    expect_moved("12b re-admission", before, {
        "BREAKER_TRANSITIONS{'breaker': 'solver.device', 'to': 'half_open'}": 1.0,
        "BREAKER_TRANSITIONS{'breaker': 'solver.device', 'to': 'open'}": 1.0,
        "BREAKER_TRANSITIONS{'breaker': 'solver.device', 'to': 'closed'}": 1.0})
    if resilient.breaker.state != fallback.CircuitBreaker.CLOSED:
        raise AssertionError(f"12b: the breaker is {resilient.breaker.state} after the probe")
    if torch_solver.placements_json(back) != torch_solver.placements_json(plain):
        raise AssertionError("12b: the re-admitted card's solve differs from 12a's")
    if device == "cuda" and back_launches["screen_prep"] < 1:
        raise AssertionError("12b: the re-admitted solve launched no screen")
    reasons = [e.reason for e in events.for_object("Solver", "solver")]
    if reasons != ["SolverWedged", "SolverRecovered"]:
        raise AssertionError(f"12b: events {reasons}")
    probes = list(getattr(prober, "seconds", []))[probes_before:]
    b = {"wedged_solve_s": round(wedge_s, 3), "wedged_gen2": wedge_gen2,
         "greedy_s": round(greedy.wall_s, 3), "greedy_replay_s": round(greedy_replay_s, 3),
         "readmitted_solve_s": round(back_s, 3), "readmitted_gen2": back_gen2,
         "probes_s": probes, "moved": moved, "events": reasons,
         "wedge": report["wedge_history"][-1]}
    out["12b"] = b
    say(f"[fallback 12b] wedge, fallback and re-admission: {json.dumps(b)}")

    # 12c: GreedySolver against the card on 12a's inputs, and the card's
    # fixed cost against the small-batch work product
    bar = equivalence_bar("12c", plain, host, n, client, zones)
    c = {"bar": bar, "card_s": out["plain_s"], "greedy_s": round(greedy.wall_s, 3),
         "fixed_cost": [_fixed_cost(device, n_p, n_t)
                        for n_p, n_t in ((100, 10), (100, 40), (200, 100))],
         "small_batch_work_max": resilient.small_batch_work_max}
    out["12c"] = c
    say(f"[fallback 12c] greedy against the card: {json.dumps(c)}")
    del pods, provs, its, client, cluster, plain, served, host, back
    FLIGHTREC.clear()
    FLIGHTREC.disable()

    # 12d: the native packer on phase 4's topology-free share, fresh (the
    # packer refuses existing nodes)
    g_pods, g_provs, g_its, _nodes = generic_mix()
    max_nodes = 50000 // 5 + 1536
    packer = native.NativeSolver(max_nodes=max_nodes, device=device)
    t0 = time.perf_counter()
    packed = packer.solve(g_pods, g_provs, g_its)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = torch_solver.TorchSolver(max_nodes=max_nodes, device=device,
                                    incremental="off").solve(g_pods, g_provs, g_its)
    sync()
    card_s = time.perf_counter() - t0
    d = {"pods": len(g_pods), "types": len(g_its["default"]),
         "bar": equivalence_bar("12d", card, packed, len(g_pods)),
         "native_s": round(native_s, 3), "native_phase_ms": {
             k: round(v, 3) for k, v in packer.last_phase_ms.items()},
         "card_s": round(card_s, 3), "gxx_build_s": native.BUILD_SECONDS}
    out["12d"] = d
    say(f"[fallback 12d] the native packer against the card: {json.dumps(d)}")
    return out


# -- phase 13: the process entry ------------------------------------------------

# every tier of the default bucket ladder is prewarmed
ENTRY_TIERS = ("S", "M", "L", "XL")
# every backlog pod nominated within this many seconds of its creation
ENTRY_BOUND_S = 180.0
ENTRY_FAMILIES = ("karpenter_prewarm_", "karpenter_slo_", "karpenter_solver_")
# phase 16b: the share of the apiserver's store calls that answer 503
HTTP_CHAOS_P = 0.005
# phase 16b's cluster: a quarter of phase 13's (QUARTER_SIZE: 1,200 pods
# over 50 nodes, 900 bound), the depth cut that gives the smoke its margin
# under 1,000 s with phase 17
HTTP_SIZE = QUARTER_SIZE


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _http_get(port: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.read()


def _wait_for(cond, timeout: float, what: str) -> float:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"entry: {what} not reached in {timeout} s")
        time.sleep(0.05)
    return time.perf_counter() - t0


class EntryProbe:
    """Wraps the wired solvers once run() hands over its Process: the
    ResilientSolver's prober (seconds, and the thread that paid each
    probe), its solve (wall, probe included), and the primary's solve
    (wall, last_phase_ms, the solver host child's phases, and its first
    encoded snapshot, as OperatorRun keeps them)."""

    def __init__(self, proc):
        self.proc = proc
        self.probes, self.wrapped, self.solves, self.bound = [], [], [], {}
        self.bound_at = {}  # pod -> wall time of its first nomination
        solver, primary = proc.solver, proc.primary
        real_prober, real_wrapped, real_solve = solver.prober, solver.solve, primary.solve
        # the solver host encodes through its own encode(), in this process;
        # the in-process solver through torch_solver's encode_snapshot
        host = isinstance(primary, HostSolver)
        encoder = primary if host else torch_solver
        real_encode = getattr(encoder, "encode" if host else "encode_snapshot")
        on_card = torch.device(primary.device).type == "cuda" and not host
        sync = torch.cuda.synchronize if on_card else (lambda: None)

        def prober():
            t0 = time.perf_counter()
            reason = real_prober()
            self.probes.append({"s": round(time.perf_counter() - t0, 3), "reason": reason,
                                "thread": threading.current_thread().name,
                                "in_solve": len(self.wrapped) + 1})
            return reason

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            res = real_wrapped(*a, **kw)
            self.wrapped.append({"pods": len(a[0]), "wall_s": round(time.perf_counter() - t0, 3)})
            return res

        def solve(*a, **kw):
            snaps = []
            name = "encode" if host else "encode_snapshot"
            setattr(encoder, name, lambda *ea, **ekw: (
                snaps.append(real_encode(*ea, **ekw)) or snaps[-1]))
            t0, at = time.perf_counter(), time.time()
            try:
                res = real_solve(*a, **kw)
                sync()
            finally:
                if host:
                    del primary.encode
                else:
                    torch_solver.encode_snapshot = real_encode
            self.solves.append({"pods": len(a[0]), "at": at,
                                "wall_s": round(time.perf_counter() - t0, 3),
                                "phases_ms": {k: round(v, 3)
                                              for k, v in primary.last_phase_ms.items()},
                                "child_phases_ms": dict(getattr(primary,
                                                                "last_child_phase_ms", {})),
                                "snapshot": (snaps[0], a[1]) if snaps else None,
                                "result": res, "failed": len(res.failed_pods)})
            return res

        solver.prober, solver.solve, primary.solve = prober, wrapped, solve
        def bound(pod, node):
            key = (pod.metadata.namespace, pod.metadata.name)
            self.bound[key] = node
            self.bound_at.setdefault(key, time.time())

        proc.operator.provisioning.bind_listeners.append(bound)


def phase_entry(device="cuda", size=PHASE12_SIZE, tiers=ENTRY_TIERS,
                bound_s=ENTRY_BOUND_S, gen2_without=None, http=None) -> dict:
    """Phase 13: the process entry, run(cloud_provider, kube_client=...,
    stop_event=..., options=...) on a thread, on `device`, over PHASE12_SIZE's
    cluster (its nodes and bound pods in the kube client, the provisioner
    not consolidating), with leader election and profiling on, the metrics
    port ephemeral, the webhook on where `cryptography` imports, and every
    tier of `tiers` prewarmed. Once the prewarm is ready, the backlog is
    created in the client as pending pods. Fatal: a tier not "compiled" or
    "cached", karpenter_prewarm_ready not 1, a lease not held by the
    elector, a backlog pod not nominated within `bound_s`, an endpoint
    other than 200 or without its families, /debug/health not healthy,
    /debug/config without the options and settings, a fallback or a
    reconcile error, a thread still alive or the lease still held after the
    stop. The launch counts are zeroed before run() and read after its
    stop; gen-2 collections are counted while the backlog is served (with
    apply_server_gc_tuning applied by run()). Restores the collector's
    state when it ends.

    With `http` (phase 16b: an OverHTTP), the cluster is in an apiserver
    in a process of its own, the backlog is created there over HTTP by the
    BacklogCreator's process, and run() and every check go through
    ApiServerKubeClient(UrllibTransport(...)); the client's watch pumps
    must be gone once it is closed."""
    threshold = gc.get_threshold()
    gen2 = _GenTwo()
    gc.callbacks.append(gen2)
    try:
        return _phase_entry(device, size, tiers, bound_s, gen2, gen2_without, http)
    finally:
        gc.callbacks.remove(gen2)
        # run() froze the heap, widened gen-2 and armed the tracer, the
        # flight recorder and the structured log for the process's life
        gc.unfreeze()
        gc.set_threshold(*threshold)
        gctuning._applied = False
        TRACER.disable()
        FLIGHTREC.disable()
        LOG_SINK.disable()


def _entry_cluster(size, tag: str):
    """Phase 12's cluster for the entry: the backlog, the types and the
    in-memory client with the nodes, the bound pods and the provisioner."""
    n_pods, n_types, n_nodes, distinct, kw = size
    t0 = time.perf_counter()
    pods, provs, its, client, _cluster = live_cluster(n_pods, n_types, n_nodes,
                                                      distinct=distinct, **kw)
    del _cluster  # the operator builds its own from the client's watches
    client.create(provs[0])
    say(f"[{tag}] {len(pods)} backlog pods, {n_nodes} nodes, "
        f"{len(client.list('Pod', copy_objects=False))} bound pods in the client, built in "
        f"{time.perf_counter() - t0:.2f} s")
    return pods, its, client


class OverHTTP:
    """Phase 16b's set-up, made ahead: HTTP_SIZE's cluster handed to an
    ApiServerProcess with kube.transport armed there at `chaos_p`, which
    loads it while 16a runs; start() waits for it to serve and starts the
    backlog's BacklogCreator."""

    def __init__(self, size=HTTP_SIZE, chaos_p: float = 0.0):
        self.size = size
        self.pods, self.its, store = _entry_cluster(size, "entry 16b")
        self.t0 = time.perf_counter()
        self.server = ApiServerProcess(store, chaos_p=chaos_p)
        self.creator = None

    def start(self) -> None:
        t0 = time.perf_counter()
        url = self.server.url
        say(f"[entry 16b] the cluster loaded into the apiserver process {self.server.pid} "
            f"at {url}, {time.perf_counter() - self.t0:.2f} s after its start (waited "
            f"{time.perf_counter() - t0:.2f} s for it here)")
        self.creator = BacklogCreator(url, self.pods)

    def close(self) -> None:
        if self.creator is not None:
            self.creator.close()
        self.server.close()


def cache_counts(primary) -> dict:
    """karpenter_compile_cache_{hits,misses} by site, and the compile
    seconds' count and sum, where the primary keeps them: the solver host's
    child (its stats frame) or this process."""
    if isinstance(primary, HostSolver):
        stats = primary.host.stats()
        return {"hits": stats["compile_cache_hits"], "misses": stats["compile_cache_misses"],
                "compile_seconds": stats["compile_seconds"]}

    def by_site(counter):
        return {labels.get("site", ""): value for labels, value in counter.series()}

    _buckets, count, total = compilecache.COMPILE_SECONDS.snapshot()
    return {"hits": by_site(compilecache.CACHE_HITS),
            "misses": by_site(compilecache.CACHE_MISSES),
            "compile_seconds": {"count": count, "sum": total}}


def check_prewarm_cache(tag, primary, outcomes) -> dict:
    """After the prewarm: one miss per tier the prewarm compiled, at the
    site that keys the primary's warm state (the service's entries in the
    solver host's child, the prewarm's lookups in process)."""
    got = cache_counts(primary)
    site = "service" if isinstance(primary, HostSolver) else "prewarm"
    compiled = sum(1 for o in outcomes.values() if o == "compiled")
    if got["misses"].get(site, 0) != compiled:
        raise AssertionError(f"{tag}: {got['misses']} compile-cache misses after the prewarm, "
                             f"not one per tier compiled ({compiled} at {site})")
    return got


def check_live_hit(tag, proc, its, tier_name) -> dict:
    """One live solve of a prewarmed geometry (the tier's synthetic
    workload, as tests/test_bucket_ladder.py solves it) through the wired
    primary: it must count as a compile-cache hit and mint no entry."""
    primary = proc.primary
    tier = next(t for t in api_settings.current().bucket_ladder if t.name == tier_name)
    provs = [p for p in proc.operator.kube_client.list("Provisioner", copy_objects=False)]
    pods, nodes = prewarm_mod.synthetic_workload(tier, provs, its)
    before = cache_counts(primary)
    t0 = time.perf_counter()
    # the class's solve: the probe's per-instance wrapper records backlog solves
    res = type(primary).solve(primary, pods[:40], provs, its, state_nodes=nodes)
    wall = round(time.perf_counter() - t0, 3)
    after = cache_counts(primary)
    site = "service" if isinstance(primary, HostSolver) else "tpu_solver"
    hits = after["hits"].get(site, 0) - before["hits"].get(site, 0)
    misses = sum(after["misses"].values()) - sum(before["misses"].values())
    if res.pod_count_new() + res.pod_count_existing() != 40 or hits != 1 or misses:
        raise AssertionError(f"{tag}: the live solve of prewarmed tier {tier_name} counted "
                             f"{hits} hits and {misses} misses at {site}")
    return {"tier": tier_name, "site": site, "hits": hits, "misses": misses, "wall_s": wall}


def _phase_entry(device, size, tiers, bound_s, gen2, gen2_without, http=None) -> dict:
    if http is None:
        pods, its, client = _entry_cluster(size, "entry")
        server = creator = None
    else:
        try:
            http.start()
        except BaseException:
            http.close()
            raise
        pods, its, server, creator = http.pods, http.its, http.server, http.creator
        client = server.client()
    keys = {(p.metadata.namespace, p.metadata.name) for p in pods}
    n_nodes = size[2]
    try:
        return _phase_entry_run(device, tiers, bound_s, gen2, gen2_without, pods, its,
                                client, keys, n_nodes, server, creator,
                                "entry" if http is None else "entry 16b")
    finally:
        if server is not None:
            client.close()
            http.close()


def _phase_entry_run(device, tiers, bound_s, gen2, gen2_without, pods, its, client, keys,
                     n_nodes, server, creator, tag) -> dict:
    lists = ListClock(client) if server is not None else None
    argv = ["--metrics-port", "0", "--enable-profiling", "--leader-elect"]
    if HAVE_CRYPTOGRAPHY:
        argv += ["--webhook-port", str(_free_port())]
    else:
        argv += ["--disable-webhook"]
        say("[entry] disable_webhook: the `cryptography` package does not import here, so "
            "the entry runs without admission webhooks")
    opts = parse_options(argv)
    os.environ["KARPENTER_PREWARM"] = "1"
    os.environ["KARPENTER_PREWARM_TIERS"] = ",".join(tiers)
    reset_registry()
    provisioner.reset_counts()
    operator_controller.reset_counts()
    fb_before = fallback_counts()
    stop, got = threading.Event(), {}
    before = {th.ident for th in threading.enumerate()}

    def main():
        try:
            got["op"] = entry.run(fake.FakeCloudProvider(its["default"]), kube_client=client,
                                  stop_event=stop, options=opts,
                                  device=None if device == "cuda" else device,
                                  on_start=lambda proc: got.update(probe=EntryProbe(proc)))
        except BaseException as exc:  # noqa: BLE001 — raised below
            got["error"] = exc

    # the server's collector tuning, timed: run() freezes the whole heap
    real_tuning, tuning_s = gctuning.apply_server_gc_tuning, []

    def tuning(*a, **kw):
        t0 = time.perf_counter()
        real_tuning(*a, **kw)
        tuning_s.append(round(time.perf_counter() - t0, 3))

    gctuning.apply_server_gc_tuning = tuning
    screen.reset_launches()
    TRACER.clear()

    def launch_counts():
        # the solver host's child launches the kernels in host mode
        primary = got["probe"].proc.primary if "probe" in got else None
        if isinstance(primary, HostSolver):
            return _host_launches(primary)
        return screen.launch_counts()

    t_run = time.perf_counter()
    thread = threading.Thread(target=main, name="entry-main")
    thread.start()
    out = {"pods": len(pods), "nodes": n_nodes, "webhook": HAVE_CRYPTOGRAPHY}
    host = None
    try:
        out["start_s"] = round(_wait_for(lambda: "probe" in got or "error" in got, 300,
                                         "the entry's start"), 3)
        if "error" in got:
            raise got["error"]
        probe = got["probe"]
        proc = probe.proc
        out["prewarm_wait_s"] = round(_wait_for(
            lambda: proc.prewarm is None or not proc.prewarm.is_alive(), 600,
            "the prewarm's end"), 3)
        outcomes = {labels["tier"]: labels["outcome"]
                    for labels, _ in prewarm_mod.PREWARM_TOTAL.series()}
        ready = prewarm_mod.PREWARM_READY.get()
        tier_s = {sp.attrs["tier"]: round(sp.duration_ms / 1e3, 3) for sp in TRACER.spans()
                  if sp.name == "solver.prewarm"}
        out["prewarm"] = {"outcomes": outcomes, "ready": ready, "tier_s": tier_s,
                          "build_s": dict(cuda_build.BUILD_SECONDS)}
        if sorted(outcomes) != sorted(tiers) or any(
                o not in ("compiled", "cached") for o in outcomes.values()) or ready != 1.0:
            raise AssertionError(f"entry: prewarm {json.dumps(out['prewarm'])}")
        out["launches_prewarm"] = launch_counts()
        out["compile_cache"] = {"after_prewarm": check_prewarm_cache(tag, proc.primary,
                                                                      outcomes)}
        host = proc.primary if isinstance(proc.primary, HostSolver) else None
        out["primary"] = describe(proc.primary)
        if device == "cuda" and host is None:
            raise AssertionError("entry: the default primary is not the solver host")
        if host is not None:
            report = host.host_report()
            out["child"] = {"pid": report["pid"], "generation": report["generation"],
                            "spawn_s": report["last_boot_s"],
                            "startup_s": host.host.last_startup_s,
                            "health": host.health(timeout=120.0)}
        lease = client.get("Lease", leaderelection.LEASE_NAMESPACE, leaderelection.LEASE_NAME)
        if lease is None or lease.spec.holder_identity != proc.elector.identity:
            raise AssertionError(f"entry: the lease is {lease and lease.spec.holder_identity}, "
                                 f"not the elector's {proc.elector.identity}")
        # the backlog, created as a deployment's pods arrive: over HTTP by
        # the creator's process, as a workload controller's, while this
        # process serves them
        mark = gen2.mark()
        t0 = time.perf_counter()
        if server is None:
            created_at = {}
            for p in pods:
                created_at[(p.metadata.namespace, p.metadata.name)] = time.time()
                client.create(p)
            out["created_s"] = round(time.perf_counter() - t0, 3)
        else:
            creator.go()
        out["nominated_s"] = round(_wait_for(lambda: keys <= set(probe.bound), bound_s,
                                             "every backlog pod nominated"), 3)
        if server is not None:
            made = creator.wait()
            created_at = made["created_at"]
            out["created_s"], out["creator"] = made["s"], made["retries"]
            # where the wait went: the batch windows, the reconciles, the
            # solves and the launches, in s from the first creation
            out["timeline"] = [
                (sp.name, round(sp.start_ns / 1e9 - t0, 3), round(sp.duration_ms / 1e3, 3))
                for sp in TRACER.spans()
                if sp.name in ("batcher.window", "provisioner.reconcile", "solver.solve",
                               "provisioner.launch") and sp.start_ns / 1e9 >= t0 - 5.0][:24]
            say(f"[{tag}] started in {out['start_s']} s, prewarmed in "
                f"{out['prewarm_wait_s']} s; {len(pods)} pods created in {out['created_s']} s "
                f"and nominated {out['nominated_s']} s after the first")
        # the metric: the backlog's first creation to its last nomination
        out["creation_to_last_nomination_s"] = round(
            max(probe.bound_at[k] for k in keys) - min(created_at.values()), 3)
        out["creation_to_nomination"] = percentiles(
            [probe.bound_at[k] - created_at[k] for k in keys])
        out["gen2_serving"] = gen2.since(mark)
        port = proc.health_port
        served = {}
        for path in ("/healthz", "/readyz", "/metrics", "/debug/health", "/debug/config",
                     "/debug/", "/debug/backend", "/debug/slo", "/debug/trace/summary",
                     "/debug/tenants", "/debug/timeline", "/debug/programs"):
            status, body = _http_get(port, path)
            served[path] = [status, len(body)]
            if status != 200:
                raise AssertionError(f"entry: {path} answered {status}")
            if path == "/metrics":
                text = body.decode()
                missing = [f for f in ENTRY_FAMILIES if f not in text]
                if missing:
                    raise AssertionError(f"entry: /metrics lacks {missing}")
            elif path == "/debug/health":
                health = json.loads(body)
                if health["status"] != "ok" or health["solver"]["healthy"] is not True:
                    raise AssertionError(f"entry: /debug/health {health}")
                if host is not None and not (health["solver"]["host"] or {}).get("alive"):
                    raise AssertionError(f"entry: /debug/health has no live host {health}")
            elif path == "/debug/programs":
                programs = json.loads(body)
                out["programs"] = sorted({(r["process"], r["family"])
                                          for r in programs["programs"]})
                # each solve geometry's cold seconds, by its slot tier: the
                # prewarmed tiers' and the backlog's
                out["compile_cache"]["solve_programs"] = sorted(
                    (r.get("tier", ""), r.get("origin", ""), r["compile_seconds"])
                    for r in programs["programs"] if r["family"] == "solve")
            elif path == "/debug/config":
                config = json.loads(body)
                if (config["options"]["enable_profiling"] is not True
                        or config["options"]["metrics_port"] != 0
                        or "batch_max_duration" not in config["settings"]):
                    raise AssertionError(f"entry: /debug/config {config}")
            elif path == "/debug/backend":
                out["backend"] = json.loads(body)
        out["served"] = served
        out["compile_cache"]["after_backlog"] = cache_counts(proc.primary)
        if server is None:
            out["compile_cache"]["live_prewarmed"] = check_live_hit(tag, proc, its, tiers[0])
        say(f"[{tag}] compile cache: {json.dumps(out['compile_cache'])}")
    finally:
        if server is not None:
            say(f"[{tag}] stopping {round(time.perf_counter() - t_run, 3)} s after run()")
        stop.set()
        thread.join(timeout=300)
        gctuning.apply_server_gc_tuning = real_tuning
    out["gc_tuning_s"] = tuning_s
    if thread.is_alive():
        raise AssertionError("entry: run() did not return within 300 s of the stop")
    if "error" in got:
        raise got["error"]
    out["run_s"] = round(time.perf_counter() - t_run, 3)
    out["launches"] = launch_counts()
    if host is not None:
        # run()'s stop closed the primary: its child's process group is gone
        time.sleep(0.2)
        if not _pid_gone(out["child"]["pid"]) or host.host.alive():
            raise AssertionError(f"entry: the solver host's child {out['child']['pid']} "
                                 "outlived the stop")
    out["launches_live"] = {k: out["launches"][k] - out["launches_prewarm"][k]
                            for k in out["launches"]}
    if proc.alive:
        raise AssertionError(f"{tag}: threads alive after the stop: {proc.alive}")
    if server is not None:
        # the client's watch pumps end with it
        client.close()
        for th in client.watch_threads():
            th.join(timeout=5.0)
    pooled = {th for pool in operator_controller._pools.values() for th in pool._threads}
    left = [th.name for th in threading.enumerate()
            if th.ident not in before and th.is_alive() and th not in pooled]
    if left:
        raise AssertionError(f"entry: threads left after run() returned: {left}")
    lease = client.get("Lease", leaderelection.LEASE_NAMESPACE, leaderelection.LEASE_NAME)
    if lease.spec.renew_time is not None:
        raise AssertionError("entry: the lease was not released")
    counters = {"fallback": counts_moved(fb_before),
                "solver_fallbacks": provisioner.FALLBACKS["solver"],
                "reconcile_errors": series_of(operator_controller.RECONCILE_ERRORS),
                "launch_failures": series_of(provisioner.LAUNCH_FAILURES)}
    if (counters["fallback"] or counters["solver_fallbacks"]
            or any(counters["reconcile_errors"].values())
            or any(counters["launch_failures"].values())):
        raise AssertionError(f"entry: counters {counters}")
    if not probe.solves or probe.solves[0]["snapshot"] is None:
        raise AssertionError("entry: the backlog reached no card solve")
    if device == "cuda" and (out["launches_live"]["screen_prep"] < 1
                             or out["launches_live"]["block"] < 1):
        raise AssertionError(f"entry: the backlog was not screened on the card (in the "
                             f"solver host's child): {out['launches_live']}")
    first = probe.solves[0]
    # the first decision's placements, against the bound pods in the client
    out["placements"] = check_placements(first["result"], first["pods"], client)
    out.update(probes=probe.probes, wrapped=probe.wrapped[:3],
               n_solves=len(probe.solves),
               # each solve's start in s from the backlog's first creation
               solves=[dict({k: v for k, v in sv.items()
                             if k not in ("snapshot", "result", "at")},
                            at_s=round(sv["at"] - min(created_at.values()), 3))
                       for sv in probe.solves[:3]],
               machines=len(client.list("Machine", copy_objects=False)),
               counters=counters, gen2_without=gen2_without)
    if server is not None:
        out["http"] = http_report(server, client, lists)
        if out["http"]["server_errors"]:
            raise AssertionError(f"entry over HTTP: the apiserver failed: {out['http']}")
        if server.chaos_p and not sum(out["http"]["retries"].values()):
            raise AssertionError("entry over HTTP: kube.transport was armed, and no request "
                                 "was retried")
    say(f"[{tag}] {json.dumps(out)}")
    return {"out": out, "snapshot": first["snapshot"], "launches": out["launches"]}


# -- phase 14: the solver boundary ----------------------------------------------

# the wedge drill's heartbeat staleness threshold (12b's)
WEDGE_STALE_S = 3.0


def _host_launches(host) -> dict:
    """A HostSolver child's launches since its last reset_launches(), by
    kernel and by form."""
    counts = host.launch_counts()
    return {k: int(counts.get(k, 0)) for k in (*screen.LAUNCHES, *screen.FORM_LAUNCHES)}


def _pid_gone(pid) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def compute_apps() -> dict:
    """pid -> used memory (MiB) of the card's compute processes, as
    nvidia-smi lists them."""
    lines = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    out = {}
    for line in lines:
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            out[int(parts[0])] = parts[1]
    return out


def phase_boundary_full(pods, provs, its, client, cluster, max_nodes, want, device="cuda"):
    """14a: phase 6's full-width live-cluster backlog through a HostSolver
    whose child solves on `device`: placements byte-identical to phase 6's
    in-process solve (`want`), the child's launches (zeroed just before the
    solve) with screen_prep and the block form among them. Prints the
    child's spawn and probe seconds, the solve's wall and its parts in
    this process and in the child, the frames' bytes."""
    hs = HostSolver(max_nodes=max_nodes, device=device, spawn_timeout=300.0,
                    solve_timeout=900.0)
    try:
        t0 = time.perf_counter()
        health = hs.health(timeout=300.0)
        probe_s = time.perf_counter() - t0
        hs.reset_launches()
        t0 = time.perf_counter()
        res = hs.solve(pods, provs, its, state_nodes=cluster.nodes(), kube_client=client,
                       cluster=cluster)
        wall = time.perf_counter() - t0
        launches = _host_launches(hs)
        a, b = torch_solver.placements_json(res), torch_solver.placements_json(want)
        if a != b:
            raise AssertionError("14a: the solver host's placements differ from phase 6's "
                                 "in-process ones")
        if device == "cuda" and (launches["screen_prep"] < 1 or launches["block"] < 1):
            raise AssertionError(f"14a: the child launched {launches}")
        out = {"pods": len(pods), "device": health["device"],
               "spawn_s": round(hs.host.last_boot_s, 3),
               "child_startup_s": hs.host.last_startup_s, "probe_s": round(probe_s, 3),
               "wall_s": round(wall, 3), "phases_ms": hs.last_phase_ms,
               "child_phases_ms": hs.last_child_phase_ms,
               "request_bytes": hs.last_bytes[0], "response_bytes": hs.last_bytes[1],
               "placement_bytes": len(a), "launches": launches}
    finally:
        hs.close()
    say(f"[boundary 14a] phase 6's backlog through the solver host: {json.dumps(out)}; "
        "placements byte-identical to phase 6's")
    return out


def phase_wedge_drill(device="cuda", size=QUARTER_SIZE, stale_s: float = WEDGE_STALE_S):
    """14b: at a quarter of phase 13's size (QUARTER_SIZE), a ResilientSolver around a HostSolver
    (wedge_stale_after=None: the host watches) solves once on the child;
    the child is stopped (SIGSTOP) once the next solve's request is
    written, the watchdog must kill its process group at `stale_s`, and
    GreedySolver serves that solve. The killed pid must be gone from
    nvidia-smi's compute processes; health() respawns and probes the
    child, and the next solve, through the breaker's re-admission, is
    byte-identical to an in-process TorchSolver's. Prints the respawn and
    recovery seconds and the card's free memory around the kill."""
    n_pods, n_types, n_nodes, distinct, kw = size
    pods, provs, its, client, cluster = live_cluster(n_pods, n_types, n_nodes,
                                                     distinct=distinct, **kw)
    hs = HostSolver(device=device, stale_after=stale_s, spawn_timeout=300.0,
                    solve_timeout=900.0)
    resilient = fallback.ResilientSolver(hs, torch_solver.GreedySolver(), solve_timeout=900.0,
                                         wedge_stale_after=None, reprobe_interval=1.0,
                                         probe_timeout=300.0, small_batch_work_max=0)

    def solve(solver):
        return solver.solve(pods, provs, its, state_nodes=cluster.nodes(), kube_client=client,
                            cluster=cluster)

    out = {"pods": len(pods), "nodes": n_nodes, "stale_after_s": stale_s}
    real_write = host_mod._write_frame
    stop = {"armed": False, "at": None}

    def write(stream, header, body=b""):
        real_write(stream, header, body)
        if header.get("op") == "solve" and stop["armed"]:
            stop["armed"] = False
            stop["at"] = time.monotonic()
            os.kill(hs.host.pid, signal.SIGSTOP)

    hs.reset_launches()
    try:
        t0 = time.perf_counter()
        first = solve(resilient)
        out["first_s"] = round(time.perf_counter() - t0, 3)
        out["spawn_s"] = round(hs.host.last_boot_s, 3)
        wedged = hs.host.pid
        on_card = device == "cuda"
        apps = compute_apps() if on_card else {}
        out["pid_listed_before"] = wedged in apps
        out["compute_apps_before"] = apps
        free_before = torch.cuda.mem_get_info()[0] if device == "cuda" else 0
        host_mod._write_frame = write
        stop["armed"] = True
        t0 = time.perf_counter()
        try:
            served = solve(resilient)
        finally:
            host_mod._write_frame = real_write
        out["wedged_solve_s"] = round(time.perf_counter() - t0, 3)
        kill = hs.host.last_kill or {}
        report = resilient.health_report()
        if kill.get("kind") != "wedged" or kill.get("pid") != wedged or stop["at"] is None:
            raise AssertionError(f"14b: the wedge was not killed: {kill}")
        # the watchdog's kill, in seconds after the SIGSTOP
        out["killed_after_s"] = round(kill["at"] - stop["at"], 3)
        out["kill_note"] = kill["note"]
        if report["wedge_history"][-1]["kind"] != "wedged" or report["abandoned_live"]:
            raise AssertionError(f"14b: {report}")
        if served.pod_count_new() + served.pod_count_existing() < len(pods) // 2:
            raise AssertionError("14b: greedy did not serve the wedged solve")
        out["greedy_placed"] = served.pod_count_new() + served.pod_count_existing()
        if not _pid_gone(wedged):
            raise AssertionError(f"14b: the wedged child {wedged} is still alive")
        deadline = time.perf_counter() + 20.0
        while on_card:
            apps = compute_apps()
            if wedged not in apps or time.perf_counter() > deadline:
                break
            time.sleep(0.5)
        out["compute_apps_after"] = apps
        if wedged in apps:
            raise AssertionError(f"14b: nvidia-smi still lists the killed pid {wedged}: {apps}")
        if device == "cuda":
            out["free_mib_gained"] = round((torch.cuda.mem_get_info()[0] - free_before)
                                           / 2 ** 20, 1)
        # the watchdog respawned the child at the kill, while greedy served:
        # its boot (spawn to ready frame) is the respawn, and the recovery
        # runs from the kill to the ready frame
        t0 = time.perf_counter()
        hs.health(timeout=300.0)
        out["health_s"] = round(time.perf_counter() - t0, 3)
        out["respawn_s"] = round(hs.host.last_boot_s, 3)
        out["recovery_s"] = round(hs.host._spawned_at + hs.host.last_boot_s - kill["at"], 3)
        out["generation"] = hs.host.generation
        time.sleep(1.1)  # the breaker's reset timeout (reprobe_interval)
        t0 = time.perf_counter()
        again = solve(resilient)
        out["readmitted_s"] = round(time.perf_counter() - t0, 3)
        if resilient.breaker.state != "closed" or resilient.health_report()["healthy"] is not True:
            raise AssertionError(f"14b: not re-admitted: {resilient.health_report()}")
        local = solve(torch_solver.TorchSolver(device=device))
        if torch_solver.placements_json(again) != torch_solver.placements_json(local):
            raise AssertionError("14b: the re-admitted host's solve differs from the "
                                 "in-process one")
        if torch_solver.placements_json(again) != torch_solver.placements_json(first):
            raise AssertionError("14b: the re-admitted host's solve differs from its first")
        out["launches"] = _host_launches(hs)
    finally:
        host_mod._write_frame = real_write
        hs.close()
    # the scan kernel's longest launch so far in this process (phases 17-20
    # run before), beside the watchdog's stale threshold: a scan near it
    # would lean on the kernel's item counter to read as alive
    out["pack_scan_longest_ms"] = pack_scan.LAST_LAUNCH["max_ms"]
    out["wedge_stale_s"] = stale_s
    say(f"[boundary 14b] the wedge drill: {json.dumps(out)}")
    return out


def phase_grpc(pods, provs, its, client, cluster, max_nodes, want, snap, device="cuda"):
    """14c, where `grpc` imports: serve() on localhost in this process on
    `device`, then RemoteSolver solves phase 6's backlog (placements
    byte-identical to phase 6's) and screens three subsets of its snapshot
    (verdicts and per-slot counts equal to the in-process replan). Prints
    the request and response bytes. Returns None, printing why, where
    `grpc` does not import."""
    try:
        import grpc  # noqa: F401
        from karpenter_core_tpu_torch.solver import service_pb2  # noqa: F401
    except ImportError as exc:
        say(f"[boundary 14c] skipped: the gRPC path needs grpc and protobuf, which do not "
            f"import here ({exc}); the CPU tests hold it (tests/test_torch_service.py)")
        return None
    from karpenter_core_tpu_torch.solver import service

    server, port, svc = service.serve(device=device)
    client_ = service.RemoteSolver(f"127.0.0.1:{port}", max_nodes=max_nodes, timeout=900.0)
    screen_before = screen.launch_counts()
    try:
        t0 = time.perf_counter()
        res = client_.solve(pods, provs, its, state_nodes=cluster.nodes(), kube_client=client,
                            cluster=cluster)
        wall = time.perf_counter() - t0
        if torch_solver.placements_json(res) != torch_solver.placements_json(want):
            raise AssertionError("14c: the gRPC solve's placements differ from phase 6's")
        out = {"wall_s": round(wall, 3), "request_bytes": client_.last_request_bytes,
               "response_bytes": client_.last_response_bytes,
               "service_phases_ms": {k: round(v, 3) for k, v in svc.last_phase_ms.items()}}
        E = snap.exist_used.shape[0]
        count_rows = np.zeros((3, snap.item_pad), np.int32)
        count_rows[:, 0] = (1, 2, 3)
        exist_open = np.ones((3, E), bool)
        exist_open[1, 0] = False
        got = client_.replan_screen(snap, provs, count_rows, exist_open, want_slots=True)
        out["replan_request_bytes"] = client_.last_request_bytes
        out["replan_response_bytes"] = client_.last_response_bytes
        local = torch_solver.TorchSolver(max_nodes=max_nodes, device=device).replan_screen(
            snap, provs, count_rows, exist_open, want_slots=True)
        if not (np.array_equal(got[0], local[0]) and np.array_equal(got[1], local[1])):
            raise AssertionError("14c: the Replan RPC differs from the in-process replan")
        after = screen.launch_counts()
        out["launches"] = {k: after[k] - screen_before[k] for k in after}
    finally:
        client_.close()
        server.stop(0)
    say(f"[boundary 14c] phase 6's backlog and a replan over gRPC: {json.dumps(out)}; "
        "placements and replan byte-identical")
    return out


# -- phase 15: the soak, the operator under seeded churn on the card ----------------

SOAK_MAX_NODES = 64
# hack/soak.py --smoke --host: seed 42, 12 s, arrivals 2.5/s, terminations
# and resizes at 0.6 and 0.08 of it, 12 seed nodes
SOAK_DRILL = dict(seed=42, duration_s=12.0, arrival_rate=2.5, termination_rate=2.5 * 0.6,
                  resize_rate=2.5 * 0.08, initial_nodes=12)
# steady churn at a cluster's size: phase 6's 1,000 nodes over upstream's
# largest grid of 400 types (scheduling_benchmark_test.go:56-76), 40
# arrival events/s (~100 pods/s with the default mix at 2.4 pods an event,
# upstream's floor, scheduling_benchmark_test.go:50), the soak's ratios for
# terminations and resizes
# 15b's churn runs 25 s (30 s before phase 19: the depth cut that, with
# phase 8 at 200 nodes and 18a's single-card solves gone, pays for it)
STEADY_CHURN = dict(seed=42, duration_s=25.0, arrival_rate=40.0, termination_rate=24.0,
                    resize_rate=3.2, initial_nodes=1000)
STEADY_TYPES = 400
STEADY_TAIL_S = 60.0


def arm_soak_faults(seed: int) -> None:
    """hack/soak.py:446-449: the change feed's fault the incremental path
    must degrade under, and transient cloud-provider create failures."""
    chaos.arm(chaos.STATE_DIFF, error="conn", probability=0.05, seed=seed)
    chaos.arm(chaos.CLOUDPROVIDER_CREATE, error="conn", probability=0.02, seed=seed + 1)


def armed_counts() -> dict:
    return {p: {"calls": f.calls, "injected": f.injected}
            for p, f in sorted(chaos.armed_points().items())}


def soak_columns(label: str, report) -> dict:
    cols = report.as_columns()
    say(f"[{label}] SoakReport {json.dumps(cols, sort_keys=True)}")
    return cols


def nomination_clock(driver) -> list:
    """Each nominated pod's wait from its creation to its nomination, in
    seconds on the wall clock, appended by a bind listener beside the
    driver's own: the admission-to-bind histogram's buckets are too coarse
    to tell 6 s from 9 s."""
    waits = []
    driver.op.provisioning.bind_listeners.append(
        lambda pod, _node: waits.append(time.time() - pod.metadata.creation_timestamp))
    return waits


def percentiles(values) -> dict:
    if not values:
        return {"n": 0}
    v = sorted(values)
    return {"n": len(v), "p50_s": round(v[len(v) // 2], 3),
            "p99_s": round(v[min(len(v) - 1, int(0.99 * len(v)))], 3), "max_s": round(v[-1], 3)}


def overload_burst(resilient, host_solver, n_threads: int = 10) -> dict:
    """hack/soak.py:114-160: a concurrent burst against the host's
    drill-scale admission gate. The gate sheds (brownout first), every
    shed request is served by greedy (never an error), no accepted request
    dispatches past its deadline, and the sequential latency re-converges
    once the burst drains."""
    pods = [testing.make_pod(requests={"cpu": "1"}) for _ in range(12)]
    provisioners = [testing.make_provisioner(name="burst")]
    its = {"burst": fake.instance_types(8)}

    def timed_solve():
        t0 = time.monotonic()
        resilient.solve(pods, provisioners, its)
        return time.monotonic() - t0

    timed_solve()  # this geometry's first dispatch, out of the measurement
    pre = sorted(timed_solve() for _ in range(3))
    gate = host_solver.admission
    shed_before = sum(gate.stats()["shed"].values())
    errors = []

    def worker():
        try:
            resilient.solve(pods, provisioners, its)
        except Exception as e:  # noqa: BLE001 — counted, gated to zero
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=worker, daemon=True, name=f"burst-{i}")
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    stats = gate.stats()
    post = sorted(timed_solve() for _ in range(3))
    return {"shed": sum(stats["shed"].values()) - shed_before, "shed_reasons": stats["shed"],
            "deadline_violations": stats["deadline_violations"], "errors": errors,
            "pre_p50_s": round(pre[1], 3), "post_p99_s": round(post[-1], 3)}


def phase_soak_drill(device="cuda", config=None, tail_s: float = 25.0) -> dict:
    """15a: hack/soak.py --smoke --host on `device`. A ResilientSolver
    around a HostSolver (the entry's default primary, whose child solves on
    the card) at the drill's admission scale; a FakeClock warm-up of the
    opening window through the same primary; then state.diff (p 0.05) and
    cloudprovider.create (p 0.02) armed and one solver.host.crash (times 1,
    after 8), and SoakDriver.run() in real time; then the overload burst.
    Fatal (hack/soak.py:480-620): a dead reconcile loop, no bind, a pod
    unbound at the end, an empty admission histogram, a crash that never
    fired or did not respawn the child, the breaker not re-admitting the
    card, a live zombie, a post-drill solve through the host that is not
    byte-identical to an in-process TorchSolver's, a burst that did not
    shed or re-converge, an accepted request past its deadline, an error
    instead of greedy. The child's launches (zeroed just before the
    warm-up, read after the drill) are returned."""
    from dataclasses import replace

    config = loadgen.ChurnConfig(**(config or SOAK_DRILL))
    primary = HostSolver(max_nodes=SOAK_MAX_NODES, device=device, stale_after=600.0,
                         solve_timeout=60.0, spawn_timeout=300.0, max_queue=4,
                         brownout_at=4, queue_deadline_s=30.0)
    resilient = fallback.ResilientSolver(primary, torch_solver.GreedySolver(),
                                         small_batch_work_max=0, solve_timeout=120.0,
                                         wedge_stale_after=None, reprobe_interval=3.0,
                                         probe_timeout=300.0)
    chaos.reset()
    out = {}
    primary.reset_launches()
    try:
        t0 = time.perf_counter()
        warm = loadgen.SoakDriver(replace(config, duration_s=min(config.duration_s, 12.0)),
                                  clock=testing.FakeClock(), solver=primary,
                                  max_nodes=SOAK_MAX_NODES).run_steps()
        out["warmup_s"] = round(time.perf_counter() - t0, 3)
        out["boot_s"] = round(primary.host.last_boot_s, 3)
        say(f"[soak 15a] warm-up (virtual time, {warm.binds} binds) in {out['warmup_s']} s, "
            f"the child's boot {out['boot_s']} s")
        arm_soak_faults(config.seed)
        chaos.arm(chaos.SOLVER_HOST_CRASH, error="runtime", times=1, after=8,
                  seed=config.seed + 3)
        driver = loadgen.SoakDriver(config, max_nodes=SOAK_MAX_NODES, solver=resilient,
                                    tail_timeout_s=tail_s)
        waits = nomination_clock(driver)
        t0 = time.perf_counter()
        report = driver.run()
        out["run_s"] = round(time.perf_counter() - t0, 3)
        out["columns"] = soak_columns("soak 15a", report)
        out["nominated"] = percentiles(waits)
        out["chaos"] = armed_counts()
        crash = chaos.armed_points().get(chaos.SOLVER_HOST_CRASH)
        crash_injected = crash.injected if crash else 0
        chaos.reset()
        launches = _host_launches(primary)
        out["launches"] = launches
        # the burst starts from a healthy primary: wait out the reprobe
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and not resilient.healthy():
            time.sleep(0.5)
        burst = out["burst"] = overload_burst(resilient, primary)
        health = resilient.health_report()
        pods = [testing.make_pod(name=f"drill-{i}", requests={"cpu": "1"},
                                 uid=f"uid-drill-{i}", creation_timestamp=1000.0 + i)
                for i in range(10)]
        provs = [testing.make_provisioner(name="default")]
        its = {"default": fake.instance_types(10)}
        through_host = torch_solver.placements_json(resilient.solve(pods, provs, its))
        local = torch_solver.placements_json(
            torch_solver.TorchSolver(max_nodes=SOAK_MAX_NODES, device=device).solve(
                pods, provs, its))
        child_inc = primary.host.stats().get("incremental", {})
        out["host"] = {"crash_injected": crash_injected,
                       "generations": primary.host.generation,
                       "respawns": primary.host.respawns,
                       "live_zombies": health["abandoned_live"],
                       "breaker": resilient.breaker.state,
                       "parity_byte_identical": through_host == local,
                       "child_incremental": child_inc}
    finally:
        chaos.reset()
        primary.close()
    say(f"[soak 15a] chaos {json.dumps(out['chaos'])}; host drill {json.dumps(out['host'])}; "
        f"overload burst {json.dumps(burst)}; creation to nomination "
        f"{json.dumps(out['nominated'])}; the children's launches "
        f"{json.dumps(launches)}; warm-up and run {out['warmup_s']} + {out['run_s']} s")
    cols, host = out["columns"], out["host"]
    failures = []
    if not cols["churn_loops_alive"]:
        failures.append("a reconcile loop died")
    if cols["churn_binds"] == 0:
        failures.append("no pod was ever bound")
    if cols["churn_admission_count"] == 0:
        failures.append("the admission histogram recorded nothing")
    if cols["churn_unbound_at_end"]:
        failures.append(f"{cols['churn_unbound_at_end']} pods stranded unbound")
    if host["crash_injected"] < 1:
        failures.append("solver.host.crash never fired")
    if host["generations"] < 2:
        failures.append(f"host generation {host['generations']} < 2: no respawn")
    if host["breaker"] != fallback.CircuitBreaker.CLOSED or not resilient._healthy:
        failures.append(f"the card not re-admitted (breaker {host['breaker']})")
    if host["live_zombies"]:
        failures.append(f"{host['live_zombies']} live zombie(s)")
    if not host["parity_byte_identical"]:
        failures.append("the post-drill host solve is not byte-identical to in-process")
    if burst["shed"] == 0:
        failures.append("the overload burst never shed")
    if burst["deadline_violations"]:
        failures.append(f"{burst['deadline_violations']} accepted request(s) past their "
                        "deadline")
    if burst["errors"]:
        failures.append(f"the burst raised instead of serving greedy: {burst['errors'][:3]}")
    if burst["post_p99_s"] > max(4.0 * burst["pre_p50_s"], 3.0):
        failures.append(f"post-burst p99 {burst['post_p99_s']} s never re-converged "
                        f"(pre-burst p50 {burst['pre_p50_s']} s)")
    if device == "cuda" and not launches.get("screen_prep"):
        failures.append("the children launched no screen_prep")
    if failures:
        raise AssertionError("soak 15a: " + "; ".join(failures))
    return out


def phase_steady_churn(device="cuda", config=None, n_types: int = STEADY_TYPES,
                       tail_s: float = STEADY_TAIL_S) -> dict:
    """15b: SoakDriver.run() in real time at a cluster's size
    (STEADY_CHURN: 1,000 seed nodes over 400 types, ~100 pods/s) with the
    port's default Settings() batch windows (1 s idle, 10 s at most, no
    batch cap), the soak's state.diff and cloudprovider.create faults
    armed, and the entry's default primary: a HostSolver (max_nodes 1,024)
    in the entry's ResilientSolver, its child on the card and booted
    before the soak (as the entry's prewarm boots it). Prints every
    SoakReport column, the fallbacks by reason, the small batches routed
    to greedy, the solves the card served, the chaos counts and the
    children's launches by form (zeroed just before, read after). Fatal: a
    dead reconcile loop, a pod unbound after the tail (up to `tail_s`), no
    solve served by the card, or any fallback: no armed fault reaches the
    solver in host mode."""
    config = loadgen.ChurnConfig(**(config or STEADY_CHURN))
    primary = HostSolver(device=device, spawn_timeout=300.0)
    resilient = fallback.ResilientSolver(primary, torch_solver.GreedySolver(),
                                         solve_timeout=900.0, wedge_stale_after=None)
    served = {"solves": 0, "pods": 0, "s": []}
    inner = primary.solve

    def counted(pods, *a, **kw):
        t0 = time.perf_counter()
        result = inner(pods, *a, **kw)
        served["solves"] += 1
        served["pods"] += len(pods)
        served["s"].append(time.perf_counter() - t0)
        return result

    primary.solve = counted
    chaos.reset()
    before = fallback_counts()
    out = {"nodes": config.initial_nodes, "types": n_types}
    try:
        # a running control plane meets churn with its child up (the
        # entry's prewarm boots it at the start): the boot is paid here,
        # before the soak, and printed apart
        t0 = time.perf_counter()
        primary.health(timeout=300.0)
        out["boot_s"] = round(time.perf_counter() - t0, 3)
        primary.reset_launches()
        driver = loadgen.SoakDriver(config, instance_type_count=n_types, solver=resilient,
                                    settings=api_settings.Settings(),
                                    max_nodes=primary.max_nodes, tail_timeout_s=tail_s)
        waits = nomination_clock(driver)
        arm_soak_faults(config.seed)
        t0 = time.perf_counter()
        report = driver.run()
        out["run_s"] = round(time.perf_counter() - t0, 3)
        out["chaos"] = armed_counts()
        chaos.reset()
        out["columns"] = soak_columns("steady churn 15b", report)
        out["nominated"] = percentiles(waits)
        out["launches"] = _host_launches(primary)
        out["moved"] = counts_moved(before)
        out["child_incremental"] = primary.host.stats().get("incremental", {})
    finally:
        chaos.reset()
        primary.close()
    walls = sorted(served["s"])
    out["card"] = {"solves": served["solves"], "pods": served["pods"],
                   "wall_p50_s": round(walls[len(walls) // 2], 3) if walls else None,
                   "wall_max_s": round(walls[-1], 3) if walls else None}
    cols = out["columns"]
    say(f"[steady churn 15b] {config.initial_nodes} nodes x {n_types} types, "
        f"{config.arrival_rate} arrival events/s for {config.duration_s} s: run "
        f"{out['run_s']} s (the tail included), {cols['churn_pods_created']} pods created, "
        f"{cols['churn_binds']} bound, admission p50 {cols['churn_admission_p50_s']} s p99 "
        f"{cols['churn_admission_p99_s']} s (histogram buckets), creation to nomination "
        f"{json.dumps(out['nominated'])}; the card served {json.dumps(out['card'])}; "
        f"fallback and small-batch series moved {json.dumps(out['moved'])}; chaos "
        f"{json.dumps(out['chaos'])}; the child's boot {out['boot_s']} s, its incremental "
        f"outcomes {json.dumps(out['child_incremental'])}; the children's launches "
        f"{json.dumps(out['launches'])}")
    failures = []
    if not cols["churn_loops_alive"]:
        failures.append("a reconcile loop died")
    if cols["churn_unbound_at_end"]:
        failures.append(f"{cols['churn_unbound_at_end']} pods unbound after a tail of up to "
                        f"{tail_s:.0f} s")
    if not served["solves"]:
        failures.append("the card's solver served no solve")
    fell_back = {k: v for k, v in out["moved"].items()
                 if k.startswith("SOLVER_FALLBACK_TOTAL")}
    if fell_back:
        failures.append(f"fallbacks no armed fault caused: {fell_back}")
    if failures:
        raise AssertionError("steady churn 15b: " + "; ".join(failures))
    return out


# -- phase 16: the operator over HTTP --------------------------------------------
#
# The apiserver it runs against (karpenter_core_tpu_torch/testing/apiserver.py)
# is test scaffolding, not a part of the port.


class BacklogCreator:
    """A backlog's pods POSTed through the apiserver by a process of its
    own (`python3 chip_smoke.py --create-backlog URL PICKLE`), as a
    workload controller creates a deployment's pods, so that the
    operator's process only serves them. It starts at once and imports
    while the operator starts; go() sends it off, and wait() returns each
    pod's wall time of creation, the seconds it took, and its client's
    transport retries by method."""

    def __init__(self, url: str, pods, start_timeout: float = 180.0):
        fd, self._load = tempfile.mkstemp(prefix="karpenter-backlog-", suffix=".pkl")
        with os.fdopen(fd, "wb") as f:
            pickle.dump(list(pods), f, protocol=pickle.HIGHEST_PROTOCOL)
        self._err = tempfile.TemporaryFile()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--create-backlog", url,
             self._load], stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self._err,
            cwd=ROOT)
        self.start_timeout = start_timeout

    def _line(self, timeout: float) -> str:
        import select

        ready, _, _ = select.select([self.proc.stdout], [], [], timeout)
        return self.proc.stdout.readline().decode() if ready else ""

    def go(self) -> None:
        line = self._line(self.start_timeout)
        if line.strip() != "ready":
            raise AssertionError(f"the backlog's creator did not start: {line!r} "
                                 f"{self.stderr_tail()}")
        self.proc.stdin.write(b"go\n")
        self.proc.stdin.flush()

    def wait(self, timeout: float = 300.0) -> dict:
        line = self._line(timeout)
        if not line.startswith("{"):
            raise AssertionError(f"the backlog's creator failed: {line!r} "
                                 f"{self.stderr_tail()}")
        self.proc.wait(timeout=30)
        got = json.loads(line)
        got["created_at"] = {tuple(k.split("/", 1)): t for k, t in got["created_at"].items()}
        return got

    def stderr_tail(self) -> str:
        self._err.seek(0)
        return self._err.read()[-3000:].decode(errors="replace")

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if os.path.exists(self._load):
            os.unlink(self._load)


def create_backlog(argv) -> int:
    """BacklogCreator's side: `--create-backlog URL PICKLE`. Prints `ready`
    once loaded, waits for `go` on its stdin, POSTs every pod through
    ApiServerKubeClient(UrllibTransport(URL)), one after another, and
    prints one JSON line: each pod's wall time of creation, the seconds,
    the retries."""
    url, path = argv[argv.index("--create-backlog") + 1:][:2]
    with open(path, "rb") as f:
        pods = pickle.load(f)
    kube = ApiServerKubeClient(UrllibTransport(url))
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        return 1
    created_at = {}
    t0 = time.perf_counter()
    for p in pods:
        created_at[f"{p.metadata.namespace}/{p.metadata.name}"] = time.time()
        kube.create(p)
    print(json.dumps({"created_at": created_at, "s": round(time.perf_counter() - t0, 3),
                      "retries": series_of(KUBE_TRANSPORT_RETRIES)}), flush=True)
    return 0


class ListClock:
    """Times a client's list() calls: calls and seconds by kind and by the
    calling thread (its name without a trailing number: the singleton
    loops, the watch pumps' relists, the reconcile pools)."""

    def __init__(self, client):
        self._mu = threading.Lock()
        self.by = {}
        real = client.list

        def timed(kind, *a, **kw):
            t0 = time.perf_counter()
            try:
                return real(kind, *a, **kw)
            finally:
                who = re.sub(r"[-_]?\d+$", "", threading.current_thread().name)
                with self._mu:
                    row = self.by.setdefault(f"{who}/{kind}", [0, 0.0])
                    row[0] += 1
                    row[1] += time.perf_counter() - t0

        client.list = timed

    def report(self) -> dict:
        with self._mu:
            return {k: {"calls": n, "s": round(s, 3)} for k, (n, s) in sorted(self.by.items())}


def http_report(server: ApiServerProcess, client, lists: ListClock) -> dict:
    """What went over HTTP: requests by verb (LIST and WATCH apart from
    GET), bytes each way, LIST pages, watch connections against the pumps
    that made them, resumes, the non-2xx statuses (the injected 503s among
    them), the client's retries by method, and its list() time."""
    st = server.stats()
    pumps = len(client.watch_threads())
    watches = st["requests"].get("WATCH", 0)
    return {"requests": st["requests"], "by_kind": st["by_kind"], "bytes_in": st["wire"]["in"],
            "bytes_out": st["wire"]["out"], "pages": st["pages"], "watch_streams": pumps,
            "watch_reconnects": watches - pumps, "resumed": st["resumed"],
            "statuses": st["status"], "injected_503": st["status"].get("503", 0),
            "chaos_p": server.chaos_p, "retries": series_of(KUBE_TRANSPORT_RETRIES),
            "lists": lists.report(), "server_errors": st["n_errors"],
            "errors": st["errors"]}


def race_leg(url: str, device: str = "cuda", iterations: int = 3) -> None:
    """Phase 16a's body, in an interpreter RACE_ARM armed: deflake
    iterations over ApiServerKubeClient(UrllibTransport(url)), each on an
    emptied store (POST /debug/reset), solving with ResilientSolver around
    TorchSolver(device=`device`); prints one JSON line."""
    import urllib.request

    from karpenter_core_tpu_torch.solver.fallback import ResilientSolver

    t0 = time.perf_counter()
    solver = ResilientSolver(torch_solver.TorchSolver(max_nodes=256, device=device),
                             torch_solver.GreedySolver(), prober=lambda: None,
                             small_batch_work_max=0, solve_timeout=120.0)
    runs = []
    for seed in range(iterations):
        req = urllib.request.Request(url + "/debug/reset", data=b"{}", method="POST")
        urllib.request.urlopen(req, timeout=30).read()
        kube = ApiServerKubeClient(UrllibTransport(url))
        try:
            runs.append(deflake_iteration(1600 + seed, kube_client=kube, solver=solver))
        finally:
            kube.close()
        deadline = time.time() + 5.0
        while any(th.is_alive() for th in kube.watch_threads()) and time.time() < deadline:
            time.sleep(0.05)
        if any(th.is_alive() for th in kube.watch_threads()):
            raise AssertionError("race gate: a watch pump outlived the client's close")
    print(json.dumps({"race_leg": race_report(), "iterations": runs,
                      "launches": screen.launch_counts(), "fallback": fallback_counts(),
                      "wall_s": round(time.perf_counter() - t0, 3)}), flush=True)


def phase_race_gate(device: str = "cuda", iterations: int = 3, timeout_s: float = 300.0) -> dict:
    """Phase 16a: the deflake scenario in a fresh interpreter with the
    port's lockwatch and racewatch armed first, over HTTP to an apiserver
    served from this process, on `device`. Fatal: the child failing (a pod
    not provisioned, a pump crashed, a thread left), a lock-order cycle or
    an unsuppressed race."""
    srv = ApiHTTPServer(ApiStore())
    t0 = time.perf_counter()
    try:
        code = RACE_ARM.format(root=ROOT) + (
            "import chip_smoke\n"
            f"chip_smoke.race_leg({srv.url!r}, device={device!r}, iterations={iterations})\n")
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=timeout_s, cwd=ROOT)
        stats = srv.stats()
    finally:
        srv.close()
    if proc.returncode != 0:
        raise AssertionError(f"race gate: the child exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    rep = got["race_leg"]
    if rep["cycles"] or rep["races"]:
        raise AssertionError(f"race gate: {rep['witnesses']}")
    if not rep["tracked_sites"] or not rep["instrumented_classes"]:
        raise AssertionError(f"race gate: nothing of the port was watched: {rep}")
    if stats["n_errors"]:
        raise AssertionError(f"race gate: the apiserver failed: {stats['errors']}")
    if any(got["fallback"].values()):
        raise AssertionError(f"race gate: the solves fell back: {got['fallback']}")
    if device == "cuda" and (got["launches"]["screen_prep"] < 1 or got["launches"]["block"] < 1):
        raise AssertionError(f"race gate: the card screened nothing: {got['launches']}")
    out = {k: rep[k] for k in ("tracked_sites", "instrumented_classes", "accesses",
                               "tracked_instances", "cycles", "races", "suppressed_hits")}
    out.update(iterations=got["iterations"], launches=got["launches"],
               fallback=got["fallback"],
               child_wall_s=got["wall_s"], leg_s=round(time.perf_counter() - t0, 3),
               http={k: stats[k] for k in ("requests", "wire", "pages", "watches", "resumed",
                                           "status")},
               classes=rep["classes"])
    say(f"[race gate] {json.dumps(out)}")
    return out


# -- phase 17: the segmented pack scan ------------------------------------------

SEGMENT_FULL = dict(n_pods=50000, distinct=1000, pools=8, n_types=500)
SEGMENT_EXIST = dict(n_pods=5000, pools=4, n_types=100, n_nodes=200)
SEGMENT_OPERATOR = dict(n_pods=4800, pools=8, n_types=400)
SEGMENT_ANTI_PODS = 400


def segmented_mix(n_pods=50000, distinct=1000, pools=8, n_types=500, seed=0):
    """bench.py's _segmented_probe_workload: the reference mix's generic
    share (cpu 1, memory 1Gi, `distinct` app labels) split across `pools`
    selector-scoped provisioners (testing.make_pool_provisioners) over the
    fake provider's `n_types` types."""
    provs, its = testing.make_pool_provisioners(pools, fake.instance_types(n_types))
    pods = [testing.make_pod(name=f"seg-{seed}-{i}",
                             labels={"app": f"seg-{seed}-{i % max(distinct, 1)}"},
                             requests={"cpu": "1", "memory": "1Gi"},
                             node_selector={"team": f"pool-{i % pools}"})
            for i in range(n_pods)]
    return pods, provs, its


def segmented_cluster(n_pods=5000, pools=4, n_types=100, n_nodes=200, seed=3):
    """tests/test_segmented.py's pool partition with existing nodes at phase
    3c's scale: `pools` selector-scoped pools over `n_types` types, node e
    of type e (mod the universe) labelled with pool e % pools, and pods of
    0.25-0.75 cpu selecting a random pool (seeded)."""
    rng = np.random.default_rng(seed)
    universe = fake.instance_types(n_types)
    provs, its = testing.make_pool_provisioners(pools, universe)
    nodes = []
    for e in range(n_nodes):
        it = universe[e % len(universe)]
        nodes.append(StateNode(node=testing.make_node(
            name=f"seg-node-{e}",
            labels={PROVISIONER_NAME_LABEL_KEY: f"pool-{e % pools}",
                    LABEL_NODE_INITIALIZED: "true", LABEL_INSTANCE_TYPE_STABLE: it.name,
                    LABEL_CAPACITY_TYPE: "on-demand", LABEL_TOPOLOGY_ZONE: "test-zone-1",
                    "team": f"pool-{e % pools}"},
            capacity={k: str(v) for k, v in it.capacity.items()})))
    pods = []
    for i in range(n_pods):
        p = int(rng.integers(pools))
        pods.append(testing.make_pod(
            name=f"seg-pod-{i}", labels={"app": f"dep-{p}-{int(rng.integers(8))}"},
            requests={"cpu": str(0.25 + 0.25 * int(rng.integers(3)))},
            node_selector={"team": f"pool-{p}"}))
    return pods, provs, its, nodes


def segmented_solve(label, solver, pods, provs, its, nodes=None, sync=None) -> dict:
    """One solve with the launch counts set to 0 just before it and read just
    after: its result, wall, last_phase_ms, last_segment_stats and launches
    by kernel and form."""
    screen.reset_launches()
    t0 = time.perf_counter()
    res = solver.solve(pods, provs, its,
                       state_nodes=[n.deep_copy() for n in nodes] if nodes else None)
    if sync is not None:
        sync()
    wall = time.perf_counter() - t0
    counts = screen.launch_counts()
    # a ResilientSolver's phases and stats are its primary's
    inner = getattr(solver, "primary", solver)
    out = {"result": res, "wall_s": wall, "phases": dict(inner.last_phase_ms),
           "stats": dict(inner.last_segment_stats or {}), "launches": counts,
           "placements": torch_solver.placements_json(res), "scan": dict(pack.LAST_SCAN)}
    say(f"[{label}] {wall:.3f} s wall; last_phase_ms "
        + json.dumps({k: round(v, 3) for k, v in out["phases"].items()})
        + f"; stats {json.dumps(out['stats'])}; launches {json.dumps(counts)}")
    return out


def _sum_launches(runs) -> dict:
    total = {}
    for r in runs:
        _add_counts(total, r["launches"])
    return total


class ScreenAudit:
    """The screen calls one solve makes on the card, kept as it makes them:
    ops/pack.py's ScreenOps reaches the kernels through pack.screen_block,
    which this wraps while it is entered. Of each form it keeps the first
    `head` calls that launch and every `every`-th after, up to `cap` (their
    slot rows, item planes, layout and verdicts, copied); check() then
    holds each kept verdict against screen_plain on the same rows, and both
    sides' screen_prep against screen_prep_plain, and times the largest
    block and the last row_n1 kept. The wrapper calls the real one once, so
    the launch counts are those of the solve."""

    def __init__(self, head=32, every=16, cap=256, device="cuda"):
        self.head, self.every, self.cap, self.device = head, every, cap, device
        self.seen, self.kept = {}, {}

    def __enter__(self):
        self.real = real = pack.screen_block

        def screen_block(s_allow, s_out, s_defined, items, layout):
            got = real(s_allow, s_out, s_defined, items, layout)
            N = s_allow.shape[0]
            if N and items.B and s_allow.device.type == self.device:
                form = screen.form_of(N, items.B)
                n = self.seen[form] = self.seen.get(form, 0) + 1
                kept = self.kept.setdefault(form, [])
                if len(kept) < self.cap and (n <= self.head or n % self.every == 0):
                    rows = {"allow": s_allow.clone(), "out": s_out.clone(),
                            "defined": s_defined.clone()}
                    kept.append((rows, items, layout, got.clone()))
            return got

        pack.screen_block = screen_block
        return self

    def __exit__(self, *exc):
        pack.screen_block = self.real
        return False

    def check(self, label, int_rate: float, busy_cycles: int) -> dict:
        bad, prep_bad, shapes, items_done = 0, 0, {}, set()
        for form, kept in self.kept.items():
            for rows, items, layout, got in kept:
                bad += int((got != _plain(rows, items.planes, layout)).sum())
                for planes, extra in ((rows, {}), (items.planes, {
                        k: items.planes[k] for k in ("escape", "custom_deny")})):
                    if extra and (id(items), id(layout)) in items_done:
                        continue
                    items_done.add((id(items), id(layout)))
                    args = (planes["allow"], planes["out"], planes["defined"], layout)
                    g = screen.screen_prep(*args, **extra)
                    w = screen.screen_prep_plain(*args, **extra)
                    prep_bad += sum(int((g[k] != w[k]).sum()) for k in ("words", "bytes",
                                                                        "flags"))
                shapes.setdefault(form, set()).add((rows["allow"].shape[0], items.B))
        torch.cuda.synchronize()
        kept_n = {f: len(k) for f, k in self.kept.items()}
        say(f"[screen] {label}: the solve's screen calls by form {json.dumps(self.seen)}, "
            f"kept {json.dumps(kept_n)} at (N, B) "
            f"{json.dumps({f: sorted(v) for f, v in shapes.items()})}: mismatches against "
            f"the plain versions: screen {bad}, prep {prep_bad}")
        if bad or prep_bad or not kept_n.get("block") or not kept_n.get("row_n1"):
            raise AssertionError(f"{label}: the screen kernels disagree with their plain "
                                 f"versions on the solve's own inputs, or a form was not kept")
        timed = {}
        for form, (rows, items, layout, _got) in (
                ("block", max(self.kept["block"], key=lambda c: c[0]["allow"].shape[0])),
                ("row_n1", self.kept["row_n1"][-1])):
            st = time_shape(f"{label}: {form}", rows, items, layout, None, int_rate,
                            busy_cycles)
            st["prep_plain_ms"] = time_on_card(lambda: screen.screen_prep_plain(
                rows["allow"], rows["out"], rows["defined"], layout), reps=5)
            timed[form] = st
        self.kept.clear()
        return {"max_abs_err": float(bad > 0 or prep_bad > 0), "seen": dict(self.seen),
                "kept": kept_n, "timed": timed}


def phase_segmented_full(device="cuda", size=None, int_rate: float = 0.0,
                         busy_cycles: int = 0) -> dict:
    """17a: the partitionable mix at full width, solved cold then warm with
    pack_scan="sequential" and with "segmented" on `device`. Fatal: a
    placement check failing, placements that differ between the scans, a
    segmented solve that did not engage `pools` segments with fixup 0.0,
    or launched no screen_prep, block or pack_scan (the lanes' scans). On the card the cold
    segmented solve's screen calls are kept and held against their plain
    versions (ScreenAudit: the partition's template rows, the lanes'
    re-screens at C = 1,024) and timed."""
    size = dict(SEGMENT_FULL, **(size or {}))
    t0 = time.perf_counter()
    pods, provs, its = segmented_mix(**size)
    build_s = time.perf_counter() - t0
    max_nodes = max(512, size["n_pods"] // 4 + 256)
    sync = torch.cuda.synchronize if device == "cuda" else None
    out = {}
    audit = ScreenAudit()
    for mode in ("sequential", "segmented"):
        solver = torch_solver.TorchSolver(max_nodes=max_nodes, device=device, pack_scan=mode)
        for turn in ("cold", "warm"):
            audited = device == "cuda" and (mode, turn) == ("segmented", "cold")
            with audit if audited else contextlib.nullcontext():
                out[(mode, turn)] = segmented_solve(f"segmented 17a {mode} {turn}", solver,
                                                    pods, provs, its, sync=sync)
    checked = check_placements(out[("segmented", "cold")]["result"], len(pods))
    for turn in ("cold", "warm"):
        seq, seg = out[("sequential", turn)], out[("segmented", turn)]
        if seq["placements"] != seg["placements"]:
            raise AssertionError(f"segmented 17a ({turn}): placements differ from sequential")
        st = seg["stats"]
        if (st.get("mode") != "segmented" or st.get("segments") != size["pools"]
                or st.get("fixup_fraction") != 0.0):
            raise AssertionError(f"segmented 17a ({turn}): stats {json.dumps(st)}")
        for k in ("screen_prep", "block", "pack_scan"):
            if device == "cuda" and not seg["launches"].get(k):
                raise AssertionError(f"segmented 17a ({turn}): no {k} launch")
    seg, seq = out[("segmented", "warm")], out[("sequential", "warm")]
    res = seg["result"]
    say(f"[segmented 17a] {len(pods)} pods x {len(next(iter(its.values())))} types over "
        f"{size['pools']} pools (built in {build_s:.2f} s): new {res.pod_count_new()} on "
        f"{len(res.new_machines)} machines, failed {len(res.failed_pods)}; segments "
        f"{seg['stats']['segments']}, max segment {seg['stats']['max_segment']} items, lanes "
        f"{seg['stats']['lanes']}, frozen {seg['stats']['frozen']}; warm: segment "
        f"{seg['phases'].get('segment', 0.0):.3f} ms + device {seg['phases']['device']:.3f} "
        f"+ fetch {seg['phases']['fetch']:.3f} + merge {seg['phases']['merge']:.3f} ms "
        f"against the sequential device {seq['phases']['device']:.3f} + fetch "
        f"{seq['phases']['fetch']:.3f} ms; cold segmented wall "
        f"{out[('segmented', 'cold')]['wall_s']:.3f} s, sequential "
        f"{out[('sequential', 'cold')]['wall_s']:.3f} s; placements byte-identical "
        f"({len(seg['placements'])} bytes); checked {json.dumps(checked)}")
    checked_calls = (audit.check("segmented 17a cold", int_rate, busy_cycles)
                     if device == "cuda" else None)
    return {"runs": out, "launches": _sum_launches(out.values()), "n_pods": len(pods),
            "audit": checked_calls, "workload": (pods, provs, its, max_nodes)}


def phase_segmented_pair(devices=("cuda", "cpu"), size=None) -> dict:
    """17b and 17c on segmented_cluster: the segmented scan on each device
    of `devices` and the sequential scan on the first place every pod
    byte-identically with equal last_segment_stats (segment_ms aside);
    then on the first device the degradation ladder: solver.segment armed
    once gives reason error:<Type>, and bulk replicas with hostname
    anti-affinity over the same nodes give "structure", each solve's
    placements those of the sequential scan."""
    size = dict(SEGMENT_EXIST, **(size or {}))
    pods, provs, its, nodes = segmented_cluster(**size)
    max_nodes = 1512
    first = devices[0]
    sync = torch.cuda.synchronize if first == "cuda" else None
    runs = {}
    for dev in devices:
        solver = torch_solver.TorchSolver(max_nodes=max_nodes, device=dev,
                                          pack_scan="segmented")
        runs[("segmented", dev)] = segmented_solve(
            f"segmented 17b segmented {dev}", solver, pods, provs, its, nodes,
            sync=sync if dev == "cuda" else None)
    seq_solver = torch_solver.TorchSolver(max_nodes=max_nodes, device=first,
                                          pack_scan="sequential")
    runs[("sequential", first)] = segmented_solve(
        f"segmented 17b sequential {first}", seq_solver, pods, provs, its, nodes, sync=sync)
    want = runs[("sequential", first)]["placements"]
    for key, run in runs.items():
        if run["placements"] != want:
            raise AssertionError(f"segmented 17b: {key} placements differ")
    stats = [_segment_stats_of(runs[("segmented", dev)]) for dev in devices]
    if any(st != stats[0] for st in stats) or stats[0].get("mode") != "segmented" \
            or stats[0].get("fixup_fraction") != 0.0:
        raise AssertionError(f"segmented 17b: stats {json.dumps(stats)}")
    res = runs[("segmented", first)]["result"]
    if res.pod_count_existing() <= 0:
        raise AssertionError("segmented 17b: no pod placed on an existing node")
    checked = check_placements(res, len(pods))
    say(f"[segmented 17b] {len(pods)} pods, {len(nodes)} nodes over {size['pools']} pools: "
        f"existing {res.pod_count_existing()}, new {res.pod_count_new()} on "
        f"{len(res.new_machines)} machines; {' and '.join(devices)} segmented and {first} "
        f"sequential byte-identical ({len(want)} bytes); stats {json.dumps(stats[0])}; "
        f"checked {json.dumps(checked)}")

    # 17c: the degradation ladder on the first device
    solver = torch_solver.TorchSolver(max_nodes=max_nodes, device=first, pack_scan="segmented")
    chaos.arm(chaos.SOLVER_SEGMENT, error="runtime", times=1)
    try:
        runs["chaos"] = segmented_solve("segmented 17c solver.segment armed", solver, pods,
                                        provs, its, nodes, sync=sync)
    finally:
        chaos.disarm(chaos.SOLVER_SEGMENT)
    st = runs["chaos"]["stats"]
    if (runs["chaos"]["placements"] != want or st.get("mode") != "sequential-fallback"
            or not str(st.get("reason", "")).startswith("error:")
            or st.get("fixup_fraction") != 1.0):
        raise AssertionError(f"segmented 17c (chaos): stats {json.dumps(st)}")
    anti = PodAffinityTerm(topology_key=LABEL_HOSTNAME,
                           label_selector=LabelSelector(match_labels={"app": "seg-anti"}))
    anti_pods = [testing.make_pod(name=f"seg-anti-{i}", labels={"app": "seg-anti"},
                                  requests={"cpu": "0.5"}, pod_anti_affinity_required=[anti])
                 for i in range(SEGMENT_ANTI_PODS)]
    runs["anti"] = segmented_solve("segmented 17c anti-affinity", solver, anti_pods, provs,
                                   its, nodes, sync=sync)
    runs["anti seq"] = segmented_solve("segmented 17c anti-affinity sequential", seq_solver,
                                       anti_pods, provs, its, nodes, sync=sync)
    st = runs["anti"]["stats"]
    if (runs["anti"]["placements"] != runs["anti seq"]["placements"]
            or st.get("reason") != "structure" or st.get("fixup_fraction") != 1.0):
        raise AssertionError(f"segmented 17c (anti-affinity): stats {json.dumps(st)}")
    check_placements(runs["anti"]["result"], len(anti_pods))
    say(f"[segmented 17c] solver.segment armed once: {json.dumps(runs['chaos']['stats'])}; "
        f"{len(anti_pods)} anti-affinity replicas: {json.dumps(st)}; both placed as the "
        f"sequential scan places them")
    snap = encode_snapshot(pods, provs, its, None, nodes, max_nodes=max_nodes)
    # launches are counted on the card only: the CPU's solves add none
    return {"runs": runs, "launches": _sum_launches(runs.values()), "snapshot": (snap, provs)}


def _segment_stats_of(run) -> dict:
    return {k: v for k, v in run["stats"].items() if k != "segment_ms"}


def phase_segmented_operator(device="cuda", size=None) -> dict:
    """17d, hack/segment_smoke.py's gates at the card's size: new_operator
    with TorchSolver(pack_scan="segmented") in process over 8 selector-
    scoped pools and their backlog in the kube client; one step must
    nominate every pod through a segmented solve (more than one segment,
    fixup 0.0) whose placements are byte-identical to a sequential solve
    of the same batch (run right after it, on the same inputs)."""
    size = dict(SEGMENT_OPERATOR, **(size or {}))
    n_pods, pools = size["n_pods"], size["pools"]
    universe = fake.instance_types(size["n_types"])
    provs, _its = testing.make_pool_provisioners(pools, universe)
    client, clock = InMemoryKubeClient(), testing.FakeClock()
    for p in provs:
        client.create(p)
    for i in range(n_pods):
        client.create(testing.make_pod(
            name=f"seg-op-{i}", labels={"app": f"seg-op-{i % 100}"},
            requests={"cpu": "1", "memory": "1Gi"}, node_selector={"team": f"pool-{i % pools}"}))
    max_nodes = 2048
    solver = torch_solver.TorchSolver(max_nodes=max_nodes, device=device, pack_scan="segmented")
    seq = torch_solver.TorchSolver(max_nodes=max_nodes, device=device, pack_scan="sequential")
    real_solve, solves, compared = solver.solve, [], {}

    def solve(*a, **kw):
        res = real_solve(*a, **kw)
        stats = dict(solver.last_segment_stats or {})
        phases = dict(solver.last_phase_ms)
        # the comparison's own launches are kept out of the phase's counts
        before = screen.launch_counts()
        want = seq.solve(*a, **kw)
        _add_counts(compared, {k: v - before[k] for k, v in screen.launch_counts().items()})
        solves.append({"pods": len(a[0]), "stats": stats, "phases": phases,
                       "same": torch_solver.placements_json(res)
                       == torch_solver.placements_json(want)})
        return res

    solver.solve = solve
    op = new_operator(fake.FakeCloudProvider(universe), kube_client=client,
                      settings=api_settings.Settings(), solver=solver, clock=clock)
    bound = {}
    op.provisioning.bind_listeners.append(
        lambda pod, node_name: bound.__setitem__(pod.metadata.name, node_name))
    screen.reset_launches()
    t0 = time.perf_counter()
    op.step()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v - compared.get(k, 0) for k, v in screen.launch_counts().items()}
    if len(bound) != n_pods:
        raise AssertionError(f"segmented 17d: {len(bound)} of {n_pods} pods nominated")
    if not solves:
        raise AssertionError("segmented 17d: the step solved nothing")
    for sv in solves:
        st = sv["stats"]
        if (st.get("mode") != "segmented" or st.get("segments", 0) < 2
                or st.get("fixup_fraction") != 0.0 or not sv["same"]):
            raise AssertionError(f"segmented 17d: solve {json.dumps(sv)}")
    say(f"[segmented 17d] the operator's step nominated {len(bound)} pods in {wall:.3f} s "
        f"(a sequential solve of each batch inside it); solves "
        f"{json.dumps([{k: v for k, v in sv.items() if k != 'phases'} for sv in solves])}, "
        f"last_phase_ms {json.dumps({k: round(v, 3) for k, v in solves[-1]['phases'].items()})}"
        f"; launches {json.dumps(counts)} (the sequential comparison's "
        f"{json.dumps(compared)} apart)")
    return {"launches": counts, "solves": solves}


# -- phase 18: the device grid -------------------------------------------------

GRID_MIXED = dict(n_pods=5000, n_existing=200)
GRID_ENTRY = dict(n_pods=600, n_types=100)
GRID_LOGICAL = 4


def smoke_grid(device="cuda"):
    """Phase 18's grid and its kind: every visible card ("real") when the
    machine has more than one, else a 2 x 2 grid of logical devices on the
    first card (or on the CPU), the port's form of the reference's virtual
    devices."""
    if device == "cuda" and torch.cuda.device_count() > 1:
        return factory.detect_mesh(device="cuda"), "real"
    dev = torch.device("cuda:0" if device == "cuda" else device)
    return DeviceGrid.of([dev] * GRID_LOGICAL, 2), "logical"


def _grid_name(grid, kind) -> str:
    return (f"{kind} {grid.shape['dp']} x {grid.shape['tp']} grid over "
            f"{', '.join(str(d) for d in grid.distinct())}")


def grid_mixed_batch(n_pods=5000, n_existing=200):
    """tests/test_solver_factory.py's mixed_batch at phase 3c's size: a
    zonal spread, zonal pod affinity, hostPort 8080 and generic pods (one
    kind in five each, two generic) over `n_existing` initialized nodes of
    4 cpu, 8Gi and 20 pods, the fake provider's 8 types."""
    spread = TopologySpreadConstraint(
        max_skew=1, topology_key=LABEL_TOPOLOGY_ZONE, when_unsatisfiable="DoNotSchedule",
        label_selector=LabelSelector(match_labels={"app": "spread"}))
    aff = PodAffinityTerm(topology_key=LABEL_TOPOLOGY_ZONE,
                          label_selector=LabelSelector(match_labels={"app": "aff"}))
    pods = []
    for i in range(n_pods):
        kind, name = i % 5, f"grid-mixed-{i}"
        if kind == 0:
            pods.append(testing.make_pod(name=name, labels={"app": "spread"},
                                         requests={"cpu": "1"}, topology_spread=[spread]))
        elif kind == 1:
            pods.append(testing.make_pod(name=name, labels={"app": "aff"},
                                         requests={"cpu": "1"}, pod_affinity_required=[aff]))
        elif kind == 2:
            pods.append(testing.make_pod(name=name, requests={"cpu": "1"}, host_ports=[8080]))
        else:
            pods.append(testing.make_pod(name=name, requests={"cpu": "1", "memory": "1Gi"}))
    nodes = [StateNode(node=testing.make_node(
        name=f"grid-node-{e}",
        labels={PROVISIONER_NAME_LABEL_KEY: "default", LABEL_NODE_INITIALIZED: "true"},
        capacity={"cpu": "4", "memory": "8Gi", "pods": "20"})) for e in range(n_existing)]
    return pods, [testing.make_provisioner(name="default")], {
        "default": fake.instance_types(8)}, nodes


def grid_solve(label, solver, pods, provs, its, nodes=None, sync=None) -> dict:
    """segmented_solve through the grid: also the launches by device, the
    verdict tiles' launches and the gather's bytes, each set to 0 just
    before the solve and read just after."""
    specs.reset_gather()
    shapes, real = [], specs.SpecLayout.gather

    def gather(self, tiles, spec, *a, **kw):
        got = real(self, tiles, spec, *a, **kw)
        shapes.append((spec, tuple(got.shape), got.dtype))
        return got

    specs.SpecLayout.gather = gather
    try:
        out = segmented_solve(label, solver, pods, provs, its, nodes=nodes, sync=sync)
    finally:
        specs.SpecLayout.gather = real
    out["gathered"] = shapes
    out["by_device"] = screen.device_launch_counts()
    out["tiles"] = [dict(tile=[i, j], rank=r, device=d,
                         launches={k: v for k, v in c.items() if v})
                    for i, j, r, d, c in pack.LAST_TILES]
    out["gather"] = dict(specs.GATHER)
    out["path"] = getattr(solver, "last_path", None)
    say(f"[grid] {label}: path {out['path']}, launches by device "
        f"{json.dumps(out['by_device'])}, verdict tiles {json.dumps(out['tiles'])}, gather "
        f"{json.dumps(out['gather'])}")
    return out


def gather_ms(layout, tensor, spec, device) -> float:
    """One gather of `tensor`'s tiles under `spec` onto the lead, timed
    with a synchronize of every grid device on each side."""
    tiles = layout.split(tensor, spec)

    def sync():
        if device == "cuda":
            for d in layout.mesh.distinct():
                torch.cuda.synchronize(d)

    sync()
    t0 = time.perf_counter()
    layout.gather(tiles, spec)
    sync()
    return (time.perf_counter() - t0) * 1e3


def phase_grid_segmented(seg_full, grid, kind, device="cuda") -> dict:
    """18a: phase 17a's workload (its pods, pools and types) through
    ShardedSolver over the grid, sequential and segmented (the lanes on
    the lead device), each placed byte-identically to phase 17a's
    single-card cold solve of the same scan and timed against it. Fatal:
    a placement that differs, a solve that did not take the grid, a
    segmented solve without 17a's segments, or one that launched no
    screen_prep, block or row_n1 (counts set to 0 just before, read just
    after)."""
    pods, provs, its, max_nodes = seg_full["workload"]

    def sync():
        for d in grid.distinct():
            torch.cuda.synchronize(d)

    out = {"grid": _grid_name(grid, kind)}
    for mode in ("sequential", "segmented"):
        solver = ShardedSolver(grid, max_nodes=max_nodes, pack_scan=mode)
        run = grid_solve(f"grid 18a {mode}", solver, pods, provs, its,
                         sync=sync if device == "cuda" else None)
        single = seg_full["runs"][(mode, "cold")]
        if run["path"] != "mesh":
            raise AssertionError(f"grid 18a ({mode}): the solve took the {run['path']} path")
        if run["placements"] != single["placements"]:
            raise AssertionError(f"grid 18a ({mode}): placements differ from phase 17a's "
                                 f"single-card solve")
        for k in ("screen_prep", "block", "pack_scan"):
            if device == "cuda" and not run["launches"].get(k):
                raise AssertionError(f"grid 18a ({mode}): no {k} launch")
        if mode == "segmented" and (run["stats"].get("mode") != "segmented"
                                    or run["stats"].get("segments")
                                    != single["stats"].get("segments")):
            raise AssertionError(f"grid 18a: stats {json.dumps(run['stats'])}")
        # the largest gather of the solve, again, timed alone on a tensor
        # of its shape
        layout = solver.last_spec_layout
        spec, shape, dtype = max(run["gathered"], key=lambda g: int(np.prod(g[1])))
        run["largest_gather"] = {"spec": list(spec), "shape": list(shape), "dtype": str(dtype),
                                 "ms": gather_ms(layout, torch.zeros(shape, dtype=dtype,
                                                                     device=grid.lead),
                                                 spec, device)}
        run["gathered"] = [[list(sp), list(sh)] for sp, sh, _dt in run["gathered"]]
        warm = seg_full["runs"][(mode, "warm")]
        say(f"[grid 18a] {mode} over the {out['grid']}: wall {run['wall_s']:.3f} s against "
            f"phase 17a's single-card cold {single['wall_s']:.3f} s and warm "
            f"{warm['wall_s']:.3f} s; prescreen {run['phases'].get('prescreen', 0.0):.3f} "
            f"ms, segment {run['phases'].get('segment', 0.0):.3f} ms, device "
            f"{run['phases']['device']:.3f} ms (17a's cold: prescreen "
            f"{single['phases'].get('prescreen', 0.0):.3f}, segment "
            f"{single['phases'].get('segment', 0.0):.3f}, device "
            f"{single['phases']['device']:.3f}); screen launches by form "
            f"{json.dumps(run['launches'])}; gathered {run['gather']['bytes']} bytes "
            f"({run['gather']['moved_bytes']} from another device) in "
            f"{run['gather']['calls']} gathers, {run['gather']['host_ms']:.3f} ms of host "
            f"time; the largest gather {json.dumps(run['largest_gather'])}; "
            f"placements byte-identical ({len(run['placements'])} bytes)")
        out[mode] = {k: v for k, v in run.items() if k != "result"}
    return out


def phase_grid_mixed(grid, kind, device="cuda", size=None) -> dict:
    """18b: test_solver_factory.py's mixed batch at phase 3c's size, solved
    by TorchSolver on the lead device, then over the grid through
    serve(mesh=grid) and RemoteSolver, and through
    ResilientSolver(primary=ShardedSolver); both byte-identical to the
    single device's, the service's Health naming the grid, no fallback."""
    from karpenter_core_tpu_torch.solver.service import RemoteSolver, serve

    size = dict(GRID_MIXED, **(size or {}))
    pods, provs, its, nodes = grid_mixed_batch(**size)
    max_nodes = size["n_pods"] // 2 + size["n_existing"]
    lead = str(grid.lead)
    sync = torch.cuda.synchronize if device == "cuda" else None
    single = segmented_solve("grid 18b single", torch_solver.TorchSolver(
        max_nodes=max_nodes, device=lead), pods, provs, its, nodes=nodes, sync=sync)
    checked = check_placements(single["result"], len(pods))
    out = {"grid": _grid_name(grid, kind), "pods": len(pods), "nodes": len(nodes),
           "single_s": single["wall_s"], "checked": checked,
           "single_sha": sha256_of(single["placements"])}
    server, port, service = serve(mesh=grid, device=lead)
    client = RemoteSolver(f"127.0.0.1:{port}", max_nodes=max_nodes, timeout=600.0)
    try:
        health = client.health()
        if f"dp={grid.shape['dp']}" not in health.device or "tp=" not in health.device:
            raise AssertionError(f"grid 18b: health device {health.device!r}")
        screen.reset_launches()
        t0 = time.perf_counter()
        remote = client.solve(pods, provs, its, state_nodes=[n.deep_copy() for n in nodes])
        out["remote_s"] = time.perf_counter() - t0
        out["remote_launches"] = screen.launch_counts()
        out["remote_by_device"] = screen.device_launch_counts()
        out["remote_phases"] = service.phase_ms()
        out["health"] = health.device
        out["service_keys"] = [str(k[-1]) for k in service._compiled]
    finally:
        client.close()
        server.stop(0)
    if torch_solver.placements_json(remote) != single["placements"]:
        raise AssertionError("grid 18b: serve(mesh=grid) placements differ from TorchSolver's")
    if all(k == "None" for k in out["service_keys"]):
        raise AssertionError("grid 18b: the service solved off the grid")
    primary = ShardedSolver(grid, max_nodes=max_nodes)
    before = fallback_counts()
    resilient = fallback.ResilientSolver(primary, torch_solver.GreedySolver(),
                                         prober=lambda: None, small_batch_work_max=1,
                                         **RESILIENT_KW)
    run = segmented_solve("grid 18b resilient", resilient, pods, provs, its, nodes=nodes,
                          sync=sync)
    moved = counts_moved(before)
    if run["placements"] != single["placements"] or primary.last_path != "mesh" or moved:
        raise AssertionError(f"grid 18b: ResilientSolver(ShardedSolver) path "
                             f"{primary.last_path}, fallbacks {json.dumps(moved)}, placements "
                             f"{'equal' if run['placements'] == single['placements'] else 'differ'}")
    out.update(resilient_s=run["wall_s"], resilient_phases=run["phases"],
               resilient_launches=run["launches"])
    say(f"[grid 18b] {len(pods)} mixed pods over {len(nodes)} nodes on the {out['grid']}: "
        f"TorchSolver {single['wall_s']:.3f} s, serve(mesh) + RemoteSolver "
        f"{out['remote_s']:.3f} s (service phases {json.dumps(out['remote_phases'])}, "
        f"launches {json.dumps(out['remote_launches'])} by device "
        f"{json.dumps(out['remote_by_device'])}), ResilientSolver(ShardedSolver) "
        f"{run['wall_s']:.3f} s (phases "
        f"{json.dumps({k: round(v, 3) for k, v in run['phases'].items()})}); health "
        f"{health.device!r}; placements byte-identical ({len(single['placements'])} bytes); "
        f"checked {json.dumps(checked)}")
    return out


def grid_tile_check(grid, kind, int_rate: float, busy_cycles: int,
                    size=None) -> dict:
    """18c's kernel check: the verdict tile of the grid's last device (the
    last dp row's existing slots against the last tp column's classes) of
    18b's snapshot, screened on that device by the screen kernel, held
    exactly against screen_plain on the same inputs and timed there."""
    size = dict(GRID_MIXED, **(size or {}))
    pods, provs, its, nodes = grid_mixed_batch(**size)
    max_nodes = size["n_pods"] // 2 + size["n_existing"]
    snap = encode_snapshot(pods, provs, its, state_nodes=nodes, max_nodes=max_nodes)
    geom = torch_solver.solve_geometry(snap, max_nodes)
    layout = specs.SpecLayout(grid)
    targs = torch_solver.args_to_torch(torch_solver.device_args(snap, provs), grid.lead)
    ops = ScreenOps(geom[8], targs[0]["allow"].shape[1], geom[16])
    items_pl = class_planes(targs[0], ops)
    cols = layout.split(items_pl.planes, (layout.tp_axis, None))[-1][-1]
    rows = layout.split({k: targs[9][k] for k in ("allow", "out", "defined")},
                        layout.slot_plane())[-1][-1]
    dev = grid.devices[-1][-1]
    # the lead current, as a solve leaves it: the tile's launches must take
    # their own card (the wrappers' device guard); the timing then runs
    # with the tile's card current, where time_shape's events record
    torch.cuda.set_device(grid.lead)
    items = screen.ScreenItems(cols, ops.rows_layout)
    got = screen.screen_block(rows["allow"], rows["out"], rows["defined"], items,
                              ops.rows_layout)
    want = _plain(rows, items.planes, ops.rows_layout)
    torch.cuda.synchronize(dev)
    if got.device != dev or not torch.equal(got.reshape(want.shape), want):
        raise AssertionError(f"grid 18c: the verdict tile on {dev}, launched with "
                             f"{grid.lead} current, disagrees with screen_plain")
    with torch.cuda.device(dev):
        st = time_shape(f"grid tile ({dev}, {kind})", rows, items, ops.rows_layout, None,
                        int_rate, busy_cycles)
    st["max_abs_err"] = 0.0  # both checks raised on any mismatch
    st["device"] = str(dev)
    return st


def phase_grid_entry(device="cuda", logical: bool = True, size=None) -> dict:
    """18c's entry drill: run() on a thread with KARPENTER_SOLVER_MODE=
    sharded (and KARPENTER_MESH_LOGICAL_DEVICES for a logical grid), its
    default primary the solver host, whose child builds its service over
    the grid; a backlog of pending pods (above the small-batch bound) is
    created and must be nominated within ENTRY_BOUND_S through one live
    solve counted at the child's service_sharded compile-cache site. No
    fallback. Restores the collector, the tracer, the recorder and the log
    as phase 13 does."""
    size = dict(GRID_ENTRY, **(size or {}))
    env = {"KARPENTER_SOLVER_MODE": "sharded", "KARPENTER_PREWARM": "0",
           "KARPENTER_MESH_LOGICAL_DEVICES": str(GRID_LOGICAL) if logical else "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    threshold = gc.get_threshold()
    its = fake.instance_types(size["n_types"])
    client = InMemoryKubeClient()
    client.create(testing.make_provisioner(name="default"))
    stop, got, bound = threading.Event(), {}, {}
    fb_before = fallback_counts()

    def main():
        try:
            got["op"] = entry.run(
                fake.FakeCloudProvider(its), kube_client=client, stop_event=stop,
                options=parse_options(["--metrics-port", "0", "--disable-webhook",
                                       "--no-leader-elect"]),
                device=None if device == "cuda" else device,
                on_start=lambda proc: got.update(proc=proc))
        except BaseException as exc:  # noqa: BLE001 — raised below
            got["error"] = exc

    thread = threading.Thread(target=main, name="grid-entry-main")
    t0 = time.perf_counter()
    thread.start()
    out = {}
    try:
        out["start_s"] = _wait_for(lambda: "proc" in got or "error" in got, 300,
                                   "the sharded entry's start")
        if "error" in got:
            raise got["error"]
        proc = got["proc"]
        proc.operator.provisioning.bind_listeners.append(
            lambda pod, node: bound.setdefault(pod.metadata.name, node))
        out["primary"] = describe(proc.primary)
        before = cache_counts(proc.primary)
        names = [f"grid-entry-{i}" for i in range(size["n_pods"])]
        t_backlog = time.perf_counter()
        for name in names:
            client.create(testing.make_pod(name=name, requests={"cpu": "1", "memory": "1Gi"}))
        out["nominated_s"] = _wait_for(lambda: all(n in bound for n in names), ENTRY_BOUND_S,
                                       "the sharded entry's backlog")
        out["backlog_s"] = time.perf_counter() - t_backlog
        after = cache_counts(proc.primary)
        out["compile_cache"] = {
            kind: {s: after[kind].get(s, 0) - before[kind].get(s, 0)
                   for s in set(after[kind]) | set(before[kind])
                   if after[kind].get(s, 0) != before[kind].get(s, 0)}
            for kind in ("hits", "misses")}
        grid_lookups = (out["compile_cache"]["hits"].get("service_sharded", 0)
                        + out["compile_cache"]["misses"].get("service_sharded", 0)
                        + out["compile_cache"]["hits"].get("tpu_solver", 0)
                        + out["compile_cache"]["misses"].get("tpu_solver", 0))
        if not grid_lookups:
            raise AssertionError(f"grid 18c: the entry's live solve counted no lookup at a "
                                 f"grid site: {json.dumps(out['compile_cache'])}")
        if isinstance(proc.primary, HostSolver) and not (
                out["compile_cache"]["misses"].get("service_sharded", 0)
                + out["compile_cache"]["hits"].get("service_sharded", 0)):
            raise AssertionError(f"grid 18c: the solver host's child served off the grid: "
                                 f"{json.dumps(out['compile_cache'])}")
        moved = counts_moved(fb_before)
        if moved:
            raise AssertionError(f"grid 18c: fallbacks {json.dumps(moved)}")
    finally:
        stop.set()
        thread.join(timeout=120)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        gc.unfreeze()
        gc.set_threshold(*threshold)
        gctuning._applied = False
        TRACER.disable()
        FLIGHTREC.disable()
        LOG_SINK.disable()
    if thread.is_alive():
        raise AssertionError("grid 18c: the entry did not stop")
    out["wall_s"] = time.perf_counter() - t0
    say(f"[grid 18c] the entry with KARPENTER_SOLVER_MODE=sharded "
        f"({'logical' if logical else 'real'} grid): primary {out['primary']}, started in "
        f"{out['start_s']:.3f} s; {size['n_pods']} pods x {size['n_types']} types nominated "
        f"{out['backlog_s']:.3f} s after their creation; compile-cache lookups by site "
        f"{json.dumps(out['compile_cache'])}; wall {out['wall_s']:.3f} s")
    return out


# -- phase 19: the device grid over processes ------------------------------------

# on a one-card machine: two ranks, each with two logical devices on the
# card (a 2 x 2 grid, dp over the ranks, gloo); on several cards one rank
# per card (NCCL)
DIST_RANKS_ONE_CARD = 2
DIST_LOGICAL = 2
DIST_DEADLINE_S = 360.0


def sha256_of(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def dist_solve(label: str, solver, pods, provs, its, nodes=None) -> dict:
    """One solve of a rank, its counts set to 0 just before and read just
    after: the placements' sha256, the wall, the phases, the gathers, the
    launches, the path and the verdict tiles this rank screened."""
    screen.reset_launches()
    specs.reset_gather()
    t0 = time.perf_counter()
    res = solver.solve(pods, provs, its,
                       state_nodes=[n.deep_copy() for n in nodes] if nodes else None)
    solver._sync()
    wall = time.perf_counter() - t0
    out = {"sha": sha256_of(torch_solver.placements_json(res)), "wall_s": wall,
           "phases": dict(solver.last_phase_ms), "gather": dict(specs.GATHER),
           "launches": screen.launch_counts(), "path": solver.last_path,
           "prescreen_mode": solver.last_prescreen_mode,
           "tiles": [dict(tile=[i, j], rank=r, device=d,
                          launches={k: v for k, v in c.items() if v})
                     for i, j, r, d, c in pack.LAST_TILES]}
    say(f"[dist] {label}: {json.dumps({k: v for k, v in out.items() if k != 'phases'})}; "
        f"last_phase_ms {json.dumps({k: round(v, 3) for k, v in out['phases'].items()})}")
    return out


def dist_rank() -> int:
    """One rank of phase 19 (python3 chip_smoke.py --dist-rank), started by
    phase_dist with KARPENTER_DIST_*: build_solver(mode="sharded") lays
    the grid over every rank's devices; 19a solves phase 17a's workload
    (sequential scan), 19b 18b's mixed batch twice on one solver (the
    second the refresh). Prints its results as one line "RANK19 {json}"."""
    t0 = time.perf_counter()
    out = {}
    max_nodes = max(512, SEGMENT_FULL["n_pods"] // 4 + 256)
    solver = build_solver(max_nodes=max_nodes, mode="sharded", pack_scan="sequential")
    grid = solver.mesh
    out["grid"] = {"shape": grid.shape, "ranks": [list(r) for r in grid.ranks],
                   "rank": grid.rank, "world": grid.world, "backend": grid.backend,
                   "lead": str(grid.lead), "card": torch.cuda.get_device_name(grid.lead)}
    out["start_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    pods, provs, its = segmented_mix(**SEGMENT_FULL)
    out["build_s"] = time.perf_counter() - t1
    out["19a"] = dist_solve(f"19a rank {grid.rank}", solver, pods, provs, its)
    del pods, provs, its
    gc.collect()
    pods, provs, its, nodes = grid_mixed_batch(**GRID_MIXED)
    solver = build_solver(max_nodes=GRID_MIXED["n_pods"] // 2 + GRID_MIXED["n_existing"],
                          mode="sharded")
    out["19b"] = [dist_solve(f"19b rank {grid.rank} solve {k + 1}", solver, pods, provs, its,
                             nodes=nodes) for k in range(2)]
    out["wall_s"] = time.perf_counter() - t0
    print("RANK19 " + json.dumps(out), flush=True)
    return 0


def phase_dist(want_19a: str, want_19b: str) -> dict:
    """Phase 19: the grid over processes. Starts the ranks (this script
    with --dist-rank) through KARPENTER_DIST_COORDINATOR on 127.0.0.1 with
    _NUM_PROCESSES and _PROCESS_ID: on one card DIST_RANKS_ONE_CARD ranks
    with KARPENTER_MESH_LOGICAL_DEVICES=DIST_LOGICAL each, on several one
    rank per card (CUDA_VISIBLE_DEVICES). Fatal: a rank that exits
    non-zero, one still running at DIST_DEADLINE_S (then every rank is
    killed), a solve off the grid, a digest of 19a other than phase 17a's
    single-card sequential solve's (`want_19a`) or of 19b other than
    18b's single-card solve's (`want_19b`), a second 19b solve that did
    not refresh, or a 19a or first 19b solve of a rank that launched no
    screen_prep or pack_scan (19b also no block)."""
    cards = torch.cuda.device_count()
    ranks = cards if cards > 1 else DIST_RANKS_ONE_CARD
    port = _free_port()
    t0 = time.perf_counter()
    procs = []
    for r in range(ranks):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("KARPENTER_DIST_", "KARPENTER_MESH_"))}
        env.update(KARPENTER_DIST_COORDINATOR=f"127.0.0.1:{port}",
                   KARPENTER_DIST_NUM_PROCESSES=str(ranks), KARPENTER_DIST_PROCESS_ID=str(r),
                   KARPENTER_SOLVER_HOST="0", KARPENTER_PREWARM="0")
        if cards > 1:
            env["CUDA_VISIBLE_DEVICES"] = str(r)
        else:
            env["KARPENTER_MESH_LOGICAL_DEVICES"] = str(DIST_LOGICAL)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--dist-rank"], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True))
    results, errors = [], []
    deadline = t0 + DIST_DEADLINE_S
    try:
        for r, p in enumerate(procs):
            try:
                stdout, stderr = p.communicate(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"dist 19: rank {r} still running at the phase's "
                                     f"{DIST_DEADLINE_S:.0f} s deadline") from None
            for line in stderr.splitlines()[-12:]:
                say(f"[dist] rank {r} stderr: {line}")
            lines = [ln for ln in stdout.splitlines() if ln.startswith("RANK19 ")]
            if p.returncode != 0 or not lines:
                errors.append(f"rank {r} exited {p.returncode}")
                continue
            results.append(json.loads(lines[-1][len("RANK19 "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    if errors:
        raise AssertionError(f"dist 19: {'; '.join(errors)}")
    wall = time.perf_counter() - t0
    for res in results:
        r = res["grid"]["rank"]
        a, b1, b2 = res["19a"], res["19b"][0], res["19b"][1]
        if a["path"] != "mesh" or b1["path"] != "mesh":
            raise AssertionError(f"dist 19 rank {r}: a solve took the single path")
        if a["sha"] != want_19a:
            raise AssertionError(f"dist 19a rank {r}: placements differ from phase 17a's "
                                 f"single-card solve")
        if b1["sha"] != want_19b or b2["sha"] != want_19b:
            raise AssertionError(f"dist 19b rank {r}: placements differ from 18b's single card")
        if b2["prescreen_mode"] != "refresh":
            raise AssertionError(f"dist 19b rank {r}: the second solve's prescreen "
                                 f"{b2['prescreen_mode']}")
        for run, kinds in ((a, ("screen_prep", "pack_scan")), (b1, ("screen_prep", "block"))):
            for k in kinds:
                if not run["launches"].get(k):
                    raise AssertionError(f"dist 19 rank {r}: no {k} launch")
    grid = results[0]["grid"]
    launches = {}
    for res in results:
        for run in (res["19a"], *res["19b"]):
            _add_counts(launches, run["launches"])
    say(f"[dist 19] {len(results)} ranks on {grid['card']}, a {grid['shape']['dp']} x "
        f"{grid['shape']['tp']} grid (cells' ranks {grid['ranks']}), collectives over "
        f"{grid['backend']}; phase wall {wall:.3f} s")
    for res in results:
        a = res["19a"]
        say(f"[dist 19a] rank {res['grid']['rank']}: start {res['start_s']:.3f} s, workload "
            f"built in {res['build_s']:.3f} s; wall {a['wall_s']:.3f} s, prescreen "
            f"{a['phases'].get('prescreen', 0.0):.3f} ms, device {a['phases']['device']:.3f} "
            f"ms; gathers {json.dumps(a['gather'])}; launches {json.dumps(a['launches'])}; "
            f"placements' sha256 {a['sha']} (phase 17a's {want_19a})")
        for k, b in enumerate(res["19b"]):
            say(f"[dist 19b] rank {res['grid']['rank']} solve {k + 1}: wall "
                f"{b['wall_s']:.3f} s, prescreen {b['prescreen_mode']} "
                f"{b['phases'].get('prescreen', 0.0):.3f} ms, device "
                f"{b['phases']['device']:.3f} ms; gathers {json.dumps(b['gather'])}; "
                f"launches {json.dumps(b['launches'])}; tiles {json.dumps(b['tiles'])}")
    say(f"[dist 19] every rank's 19a digest equals phase 17a's single-card digest, every "
        f"19b digest 18b's; the ranks' launches summed {json.dumps(launches)}")
    return {"results": results, "wall_s": wall, "launches": launches, "grid": grid}


# -- phase 20: the pack scan as one device program -----------------------------

# the parity families of tests/test_torch_cuda.py, topology groups or none:
# the pack_scan kernel's route
SCAN_FAMILIES = ("mixed", "relax", "bulk", "wide", "spread", "affinity", "anti", "refmix",
                 "cluster", "ports_vols")


@contextlib.contextmanager
def bulk_budget(rows):
    """Every scan built while entered, eager or kernel, with a bulk take
    budget of `rows` (None: the scan's own)."""
    if rows is None:
        yield
        return
    make, real_run = torch_solver.make_pack_kernel, pack_scan.run

    def make_cut(*a, **k):
        scan = make(*a, **k)
        return lambda *pa, **pk: scan(*pa, **dict(pk, bulk_len=rows))

    torch_solver.make_pack_kernel = make_cut
    pack_scan.run = lambda *a, **k: real_run(*a, **dict(k, bulk_len=rows))
    try:
        yield
    finally:
        torch_solver.make_pack_kernel, pack_scan.run = make, real_run


@contextlib.contextmanager
def plain_scans():
    """Every scan eager (make_pack_kernel.pack, the kernel's plain version)
    while entered: the routing predicate answers no."""
    routes = pack.kernel_routes
    pack.kernel_routes = lambda *a: False
    try:
        yield
    finally:
        pack.kernel_routes = routes


def scan_program(snap, provs, max_nodes, log_len=None, device="cuda", bulk_len=None):
    """A solve program's pieces for one snapshot on `device`: run(), its
    uploaded arguments and the prescreen tensor; bulk_len cuts the scan's
    bulk take budget."""
    geom = torch_solver.solve_geometry(snap, max_nodes)
    N, segs, zs, cs, L, screen_v = (geom[7], geom[8], geom[9], geom[10], geom[12], geom[16])
    targs = torch_solver.args_to_torch(torch_solver.device_args(snap, provs), device)
    scr = pack.make_prescreen_kernel(segs, N, screen_v=screen_v)(targs[0], targs[9])
    with bulk_budget(bulk_len):
        run = torch_solver.make_device_run(segs, zs, cs, snap.topo_meta, N,
                                           L if log_len is None else log_len, screen_v=screen_v)

    def run_cut(*a, **k):
        with bulk_budget(bulk_len):
            return run(*a, **k)

    return run_cut, targs, scr


def run_scan(run, targs, scr, plain: bool) -> dict:
    """One scan of a solve program on the card, timed on the host, with
    the launch counts set to 0 just before it and read just after."""
    screen.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    verdicts = []
    with plain_scans() if plain else contextlib.nullcontext():
        log, ptr, state = run(scr, *targs, verdicts=verdicts)
    torch.cuda.synchronize()
    return {"log": log, "ptr": ptr, "state": state, "verdicts": verdicts,
            "ms": (time.perf_counter() - t0) * 1e3,
            "launches": screen.launch_counts(), "scan": dict(pack.LAST_SCAN),
            "kernel_ms": None if plain else pack_scan.LAST_LAUNCH["ms"],
            "templates": targs[2].shape[0]}


def scan_diff(label: str, got: dict, want: dict) -> float:
    """Fatal unless the kernel's log, ptr, every PackState field and the
    final verdict tensor (the in-scan re-screens' result) equal the plain
    scan's, floats bit for bit; returns the largest absolute difference
    of the float fields (0.0)."""
    bad = []
    if len(got["verdicts"]) != 1 or len(want["verdicts"]) != 1 or not torch.equal(
            got["verdicts"][0].cpu(), want["verdicts"][0].cpu()):
        bad.append("verdicts")
    if got["ptr"] != want["ptr"] or got["log"]["bulk_n"] != want["log"]["bulk_n"]:
        bad.append(f"ptr {got['ptr']} / {want['ptr']}, bulk_n {got['log']['bulk_n']} / "
                   f"{want['log']['bulk_n']}")
    for k in ("item", "slot", "ns", "k", "k_last"):
        if not np.array_equal(np.asarray(got["log"][k]), np.asarray(want["log"][k])):
            bad.append(f"log {k}")
    if not torch.equal(got["log"]["bulk_take"].cpu(), want["log"]["bulk_take"].cpu()):
        bad.append("log bulk_take")
    err = 0.0
    for name in want["state"]._fields:
        a, b = getattr(got["state"], name).cpu(), getattr(want["state"], name).cpu()
        if a.dtype == torch.float32:
            finite = torch.isfinite(a) & torch.isfinite(b)
            if finite.any():
                err = max(err, float((a[finite] - b[finite]).abs().max()))
            a, b = a.view(torch.int32), b.view(torch.int32)
        if a.shape != b.shape or not torch.equal(a, b):
            bad.append(f"state.{name}")
    if bad:
        raise AssertionError(f"{label}: the pack_scan kernel differs from the plain scan: "
                             f"{', '.join(bad)}")
    return err


def scan_bound(snap, targs, runs, n_items: int) -> dict:
    """The least time the card could take for the scans of one launch: the
    bytes each input must be read and each output written, once. Inputs:
    the stepped items' rows, the template and type planes, each scan's
    entry state and verdict rows over the slots it reaches, the topology
    groups' counts and node-filter terms; outputs: those rows' final state
    and verdicts, the groups' final counts, and the commit log. The rows
    past a scan's final nopen are never read nor written. The scan's
    arithmetic (compares and a few float operations per slot, type and
    column) is far below the byte time."""
    pod_arrays, tmpl = targs[0], targs[1]
    V, K = pod_arrays["allow"].shape[1], pod_arrays["out"].shape[1]
    R, T = targs[5].shape[1], targs[5].shape[0]
    J = targs[2].shape[0]
    Q, W = pod_arrays["ports"].shape[1], pod_arrays["vols"].shape[1]
    C = pod_arrays["scls_first"].shape[0]
    G = targs[14].shape[0]  # topo_counts0 [G, V]
    GT = targs[17]["allow"].shape[0]  # the node-filter terms
    item_row = V + 2 * K + 4 * R + targs[8].shape[1] + 2 * Q + W + J * (T + 1) + 12 + 2 * G
    slot_row = V + 2 * K + T + 8 * R + Q + 14 + C + 4 * G
    tmpl_rows = J * (V + 2 * K + 4 * R + T + C + R * 4)
    type_rows = T * (V + 4 * K + 8 * R + targs[7][0].numel())
    topo_rows = GT * (V + 3 * K) + 2 * len(runs) * G * V * 5
    reached = sum(int(r["state"].nopen) for r in runs)
    L = len(runs[0]["log"]["item"])
    total = (n_items * item_row + tmpl_rows + type_rows + topo_rows + 2 * reached * slot_row
             + len(runs) * 5 * L * 4)
    return _bound(total, 0, 0, 1.0)


def phase_scan_families(device="cuda") -> dict:
    """20a: each parity family of tests/test_torch_cuda.py (topology
    groups or none) through the kernel and through the plain scan on the
    card; 20c the mixed and refmix families again with their logs cut to
    half their commits, so that they overflow; 20d the bulk, ports_vols
    and anti families with a bulk take budget of one row. Fatal: any
    difference (scan_diff), a kernel scan that is not one pack_scan
    launch or launches a row_n1 of its own, a cut log that did not fill,
    a 20d scan without a candidate commit on an existing slot."""
    import importlib.util

    # by path: a `tests` package installed on the machine may shadow the
    # checkout's (a namespace package)
    spec = importlib.util.spec_from_file_location(
        "scan_parity_workloads", os.path.join(ROOT, "tests", "test_torch_cuda.py"))
    families = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(families)
    workload = families.workload
    out, err, launches = {}, 0.0, 0
    cases = ([(f, "a", None) for f in SCAN_FAMILIES]
             + [(f"{f} (log cut)", "c", None) for f in ("mixed", "refmix")]
             + [(f"{f} (bulk budget 1)", "d", 1) for f in ("bulk", "ports_vols", "anti")])
    for family, sub, rows in cases:
        name = family.split()[0]
        pods, provs, its, daemons, nodes, max_nodes, client, cluster = workload(name, "torch")
        snap = encode_snapshot(pods, provs, its, daemons, nodes, client, cluster,
                               max_nodes=max_nodes)
        cut = None
        if sub == "c":
            full = run_scan(*scan_program(snap, provs, max_nodes, device=device), plain=True)
            cut = full["ptr"] // 2
        runs = {}
        for plain in (False, True):
            program = scan_program(snap, provs, max_nodes, log_len=cut, device=device,
                                   bulk_len=rows)
            runs[plain] = run_scan(*program, plain=plain)
        got, want = runs[False], runs[True]
        err = max(err, scan_diff(f"scan 20{sub} {family}", got, want))
        # one template's verdict row (before the scan) is a row_n1 launch
        if (got["launches"]["pack_scan"] != 1
                or got["launches"]["row_n1"] != int(got["templates"] == 1)
                or got["scan"]["impl"] != "kernel" or want["scan"]["impl"] != "eager"):
            raise AssertionError(f"scan 20a {family}: launches {json.dumps(got['launches'])}, "
                                 f"impl {got['scan']['impl']} / {want['scan']['impl']}")
        if cut is not None and got["ptr"] != cut:
            raise AssertionError(f"scan 20c: the log cut to {cut} did not fill ({got['ptr']})")
        if rows is not None:
            slot, ns = (np.asarray(got["log"][k])[:got["ptr"]] for k in ("slot", "ns"))
            cand_ex = int(((ns == 1) & got["state"].is_existing.cpu().numpy()[slot]).sum())
            if got["log"]["bulk_n"] != rows or not cand_ex:
                raise AssertionError(f"scan 20d {family}: bulk rows {got['log']['bulk_n']}, "
                                     f"candidate commits on existing slots {cand_ex}")
        launches += got["launches"]["pack_scan"]
        out[family] = {"ptr": got["ptr"], "nopen": int(got["state"].nopen),
                       "groups": int(got["state"].tcounts.shape[0]),
                       "kernel_ms": got["kernel_ms"], "ms": got["ms"], "plain_ms": want["ms"],
                       "scan": {k: got["scan"][k] for k in pack.SCAN_COUNTERS}}
        say(f"[scan 20{sub}] {family}: {len(pods)} pods, {out[family]['groups']} topology "
            f"groups, log {got['ptr']} "
            f"entries (bulk {got['log']['bulk_n']}), nopen {int(got['state'].nopen)}, scan "
            f"{json.dumps(out[family]['scan'])}: kernel and plain equal bit for bit, verdict "
            f"tensors {tuple(got['verdicts'][0].shape)} included; kernel "
            f"{got['kernel_ms']:.3f} ms alone, the run {got['ms']:.1f} ms against the plain "
            f"{want['ms']:.1f} ms")
    return {"families": out, "max_abs_err": err, "launches": launches}


def phase_scan_full(workload, want_sha: str, device="cuda") -> dict:
    """20b: phase 17a's workload at full width (50,000 pods, 8 pools, 500
    types), sequential and segmented, each solved with the kernel and with
    the plain scan (fresh solvers, cold). Fatal: placements whose sha256 is
    not 17a's sequential digest, a kernel solve that is not one pack_scan
    launch or launches a row_n1 of its own (past its prescreen's), any
    difference between the kernel's and the plain scan's sequential state
    (scan_diff). Printed: the solves' device ms with the kernel and with
    the plain scan, the kernel alone (CUDA events), the launches."""
    pods, provs, its, max_nodes = workload
    sync = torch.cuda.synchronize
    out = {}
    for mode in ("sequential", "segmented"):
        for plain in (False, True):
            solver = torch_solver.TorchSolver(max_nodes=max_nodes, device=device,
                                              pack_scan=mode)
            with plain_scans() if plain else contextlib.nullcontext():
                run = segmented_solve(f"scan 20b {mode} {'plain' if plain else 'kernel'}",
                                      solver, pods, provs, its, sync=sync)
            run["kernel_ms"] = None if plain else pack_scan.LAST_LAUNCH["ms"]
            run["scans"] = None if plain else pack_scan.LAST_LAUNCH["scans"]
            run["prescreen_launches"] = dict(solver.last_prescreen_launches or {})
            out[(mode, plain)] = run
            if sha256_of(run["placements"]) != want_sha:
                raise AssertionError(f"scan 20b {mode} ({'plain' if plain else 'kernel'}): "
                                     f"placements differ from phase 17a's digest")
        got = out[(mode, False)]
        scan_row_n1 = got["launches"]["row_n1"] - got["prescreen_launches"].get("row_n1", 0)
        if got["launches"]["pack_scan"] != 1 or scan_row_n1 or got["scan"]["impl"] != "kernel":
            raise AssertionError(f"scan 20b {mode}: launches {json.dumps(got['launches'])} "
                                 f"(the prescreen's {json.dumps(got['prescreen_launches'])}), "
                                 f"impl {got['scan']['impl']}")
    # the sequential scan's state, kernel against plain, on the same inputs
    snap = encode_snapshot(pods, provs, its, None, [], max_nodes=max_nodes)
    program = scan_program(snap, provs, max_nodes, device=device)
    kern, plain = run_scan(*program, plain=False), run_scan(*program, plain=True)
    err = scan_diff("scan 20b sequential state", kern, plain)
    bound = scan_bound(snap, program[1], [kern], kern["scan"]["items"])
    for mode in ("sequential", "segmented"):
        k, p = out[(mode, False)], out[(mode, True)]
        say(f"[scan 20b] {mode}: {len(pods)} pods, placements sha256 "
            f"{sha256_of(k['placements'])} (17a's); device {k['phases']['device']:.1f} ms "
            f"with the kernel ({k['scans']} scans in one launch, {k['kernel_ms']:.3f} ms "
            f"alone) against {p['phases']['device']:.1f} ms with the plain scan; walls "
            f"{k['wall_s']:.3f} / {p['wall_s']:.3f} s; launches {json.dumps(k['launches'])} "
            f"against {json.dumps(p['launches'])}")
    say(f"[scan 20b] the sequential scan alone: kernel {kern['kernel_ms']:.3f} ms "
        f"(the run {kern['ms']:.1f} ms) against the plain {plain['ms']:.1f} ms, bound "
        f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} ({bound['bytes']} bytes); state "
        f"equal bit for bit; scan {json.dumps({k: kern['scan'][k] for k in pack.SCAN_COUNTERS})}")
    return {"runs": out, "max_abs_err": err, "seq": {"kernel_ms": kern["kernel_ms"],
            "ms": kern["ms"], "plain_ms": plain["ms"], **bound},
            "launches": sum(r["launches"]["pack_scan"] for r in out.values())
            + kern["launches"]["pack_scan"]}


def phase_scan_mix(workload, max_nodes: int, device="cuda") -> dict:
    """20e: phase 5's workload (the full reference mix at full width: 1/7
    zonal spread, 1/7 hostname spread, 2/7 zonal affinity, 3/7 generic,
    over 1,000 existing nodes) solved with the kernel and with the plain
    scan, each in a fresh solver (incremental="off", cold), then the scan
    alone both ways on one solve program's inputs. Fatal: placements that
    are not byte-identical, a kernel solve that is not one pack_scan
    launch or launches a row_n1 of its own past its prescreen's and the
    template rows', any scan_diff. Printed: both solves' device ms, the
    kernel alone (CUDA events) against its bound by bytes, the launches,
    the longest launch so far."""
    pods, provs, its, nodes = workload
    solves = {}
    for plain in (False, True):
        solver = torch_solver.TorchSolver(max_nodes=max_nodes, device=device,
                                          incremental="off")
        screen.reset_launches()
        t0 = time.perf_counter()
        with plain_scans() if plain else contextlib.nullcontext():
            res = solver.solve(pods, provs, its, state_nodes=nodes)
        torch.cuda.synchronize()
        solves[plain] = {"wall_s": time.perf_counter() - t0,
                         "phases": dict(solver.last_phase_ms),
                         "launches": screen.launch_counts(), "scan": dict(pack.LAST_SCAN),
                         "prescreen_launches": dict(solver.last_prescreen_launches or {}),
                         "kernel_ms": None if plain else pack_scan.LAST_LAUNCH["ms"],
                         "placements": torch_solver.placements_json(res),
                         "failed": len(res.failed_pods)}
    kern_solve, plain_solve = solves[False], solves[True]
    if kern_solve["placements"] != plain_solve["placements"]:
        raise AssertionError("scan 20e: the kernel's and the plain scan's placements differ")
    snap = encode_snapshot(pods, provs, its, None, nodes, max_nodes=max_nodes)
    program = scan_program(snap, provs, max_nodes, device=device)
    n_templates = program[1][2].shape[0]
    scan_row_n1 = (kern_solve["launches"]["row_n1"]
                   - kern_solve["prescreen_launches"].get("row_n1", 0))
    if (kern_solve["launches"]["pack_scan"] != 1 or scan_row_n1 > int(n_templates == 1)
            or kern_solve["scan"]["impl"] != "kernel" or plain_solve["scan"]["impl"] != "eager"):
        raise AssertionError(f"scan 20e: launches {json.dumps(kern_solve['launches'])} (the "
                             f"prescreen's {json.dumps(kern_solve['prescreen_launches'])}), "
                             f"impl {kern_solve['scan']['impl']} / "
                             f"{plain_solve['scan']['impl']}")
    kern, plain = run_scan(*program, plain=False), run_scan(*program, plain=True)
    err = scan_diff("scan 20e full mix state", kern, plain)
    bound = scan_bound(snap, program[1], [kern], kern["scan"]["items"])
    groups = len(snap.topo_meta.groups) if snap.topo_meta is not None else 0
    say(f"[scan 20e] full mix: {len(pods)} pods, {len(nodes)} nodes, {groups} topology "
        f"groups, N={snap.n_slots}: placements byte-identical "
        f"({len(kern_solve['placements'])} bytes, {kern_solve['failed']} failed); device "
        f"{kern_solve['phases']['device']:.1f} ms with the kernel ({kern_solve['kernel_ms']:.3f} "
        f"ms alone) against {plain_solve['phases']['device']:.1f} ms with the plain scan; "
        f"walls {kern_solve['wall_s']:.3f} / {plain_solve['wall_s']:.3f} s; launches "
        f"{json.dumps(kern_solve['launches'])} against {json.dumps(plain_solve['launches'])}; "
        f"scan {json.dumps({k: kern_solve['scan'][k] for k in pack.SCAN_COUNTERS})}")
    say(f"[scan 20e] the scan alone: kernel {kern['kernel_ms']:.3f} ms (the run "
        f"{kern['ms']:.1f} ms) against the plain {plain['ms']:.1f} ms, bound "
        f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} ({bound['bytes']} bytes); state "
        f"(tcounts, thost, tdoms included), log and verdicts equal bit for bit; longest "
        f"pack_scan launch so far {pack_scan.LAST_LAUNCH['max_ms']:.1f} ms against the "
        f"watchdogs' {WEDGE_STALE_S:.1f} s staleness")
    return {"max_abs_err": err, "solves": solves,
            "seq": {"kernel_ms": kern["kernel_ms"], "ms": kern["ms"], "plain_ms": plain["ms"],
                    **bound},
            "launches": kern_solve["launches"]["pack_scan"] + kern["launches"]["pack_scan"]}


def check_kernel_route(label: str, scan: dict) -> None:
    """Fatal unless the solve's scan ran on the pack_scan kernel."""
    if scan.get("impl") != "kernel":
        raise AssertionError(f"{label}: the scan ran {scan.get('impl')}, not on the "
                             f"pack_scan kernel")


def launches_line() -> str:
    return (f"kernel launches {json.dumps(screen.LAUNCHES)}, screen by form "
            f"{json.dumps(screen.FORM_LAUNCHES)}")


def main() -> int:
    if not torch.cuda.is_available():
        say("chip_smoke: no CUDA card is available")
        return 2
    t_start = time.perf_counter()

    def mark(phase: str) -> None:
        peak_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
        say(f"[time] {phase} done at {time.perf_counter() - t_start:.1f} s, "
            f"peak host RSS so far {peak_gib:.2f} GiB")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"card: {smi}")
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_rate = INT32_OPS_PER_CLOCK_PER_SM * sms * max_sm_mhz * 1e6
    # 5 ms of spinning covers the host's enqueue of 50 timed launches
    busy_cycles = int(5e-3 * max_sm_mhz * 1e6)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}; "
        f"{sms} SMs, max SM clock {max_sm_mhz:.0f} MHz: 32-bit integer peak "
        f"{int_rate / 1e12:.2f} T ops/s")

    # phase 1: build: every CUDA kernel (one nvcc per source) and the
    # native packer (g++), all started together
    t0 = time.perf_counter()
    gxx = threading.Thread(target=native.build, name="gxx-fast-pack")
    gxx.start()
    cuda_build.build_all(KERNELS)
    gxx.join()
    for name in KERNELS:
        cuda_build.load(name)
    native.fast_pack(np.zeros((1, 1), np.float32), np.ones((1, 1), np.uint8),
                     np.ones((1, 1), np.float32), np.zeros(1, np.float32), 1)
    say(f"[build] {KERNELS} and the native packer in {time.perf_counter() - t0:.2f} s "
        f"(per kernel: {cuda_build.BUILD_SECONDS}; g++ fast_pack.cpp "
        f"{native.BUILD_SECONDS:.2f} s)")

    # the main path's workload, encoded once here for phase 2's planes
    gen = generic_mix()
    gen_pods, gen_provs, gen_its, gen_nodes = gen
    max_nodes = 50000 // 5 + 1536
    t0 = time.perf_counter()
    snap = encode_snapshot(gen_pods, gen_provs, gen_its, None, gen_nodes,
                           max_nodes=max_nodes)
    say(f"[encode] main path: {len(gen_pods)} pods, {len(snap.item_counts)} items, "
        f"{len(gen_nodes)} existing nodes, N={snap.n_slots} slots, "
        f"V={snap.dictionary.V} (screen width {snap.screen_v}), "
        f"K={snap.dictionary.K}, in {time.perf_counter() - t0:.2f} s")

    mark("phase 1")

    # phase 2: kernels against their plain versions
    kstats = phase_kernels(snap, int_rate, busy_cycles)
    mark("phase 2")

    # phase 15: the soak, the operator under seeded churn with faults armed,
    # early while this process's heap is small (a realtime loop pays for
    # every gen-2 collection of what later phases leave): 15a the
    # reference's host-mode drill, 15b steady churn at a cluster's size
    tracing = TRACER.enabled
    soak = phase_soak_drill()
    mark("phase 15a")
    steady = phase_steady_churn()
    TRACER.enabled = tracing
    gc.collect()
    mark("phase 15b")

    # phase 16: the operator over HTTP: 16a the race gate on the card, 16b
    # the process entry at HTTP_SIZE over an apiserver of its own
    prep16 = OverHTTP(size=HTTP_SIZE, chaos_p=HTTP_CHAOS_P)
    try:
        race = phase_race_gate()
    except BaseException:
        prep16.close()
        raise
    mark("phase 16a")
    over_http = phase_entry(size=HTTP_SIZE, http=prep16)["out"]
    TRACER.enabled = tracing
    gc.collect()
    mark("phase 16b")

    # phase 17: the segmented pack scan: 17a the partitionable mix at full
    # width, 17b-17c card against CPU over existing nodes and the
    # degradations, 17d the live operator; then the kernels at 17b's shapes
    seg_full = phase_segmented_full(int_rate=int_rate, busy_cycles=busy_cycles)
    audit17 = seg_full["audit"]
    mark("phase 17a")
    seg_pair = phase_segmented_pair()
    segmented_shapes = snapshot_shapes("segmented (17b)", *seg_pair["snapshot"], int_rate,
                                       busy_cycles)
    mark("phase 17b-17c")
    seg_op = phase_segmented_operator()
    b17 = {k: seg_full["launches"][k] + seg_pair["launches"][k] + seg_op["launches"][k]
           for k in seg_full["launches"]}
    mark("phase 17d")

    # phase 18: the device grid, every card when there are several, else a
    # 2 x 2 grid of logical devices on the card: 18a phase 17a's workload
    # through ShardedSolver against 17a's single-card placements, 18b the
    # mixed batch through serve(mesh=grid) and ResilientSolver(
    # ShardedSolver), 18c a verdict tile on the grid's last device against
    # its plain version and the entry with KARPENTER_SOLVER_MODE=sharded
    grid, grid_kind = smoke_grid()
    say(f"[grid] phase 18 on the {_grid_name(grid, grid_kind)}")
    g18a = phase_grid_segmented(seg_full, grid, grid_kind)
    want_19a = sha256_of(seg_full["runs"][("sequential", "cold")]["placements"])
    w17 = seg_full["workload"]
    del seg_full, seg_pair
    gc.collect()
    mark("phase 18a")
    g18b = phase_grid_mixed(grid, grid_kind)
    mark("phase 18b")
    tile18 = grid_tile_check(grid, grid_kind, int_rate, busy_cycles)
    g18c = phase_grid_entry(logical=grid_kind == "logical")
    mark("phase 18c")
    b18 = {k: g18a["sequential"]["launches"][k] + g18a["segmented"]["launches"][k]
           + g18b["remote_launches"][k] + g18b["resilient_launches"][k]
           for k in g18b["remote_launches"]}
    say(f"[grid] phase 18 on the {_grid_name(grid, grid_kind)}: launches {json.dumps(b18)}; "
        f"18c the entry's primary {g18c['primary']}")

    # phase 19: the grid over processes, ranks started through
    # KARPENTER_DIST_COORDINATOR: 19a phase 17a's workload against 17a's
    # single-card digest, 19b 18b's mixed batch twice against 18b's
    g19 = phase_dist(want_19a, g18b["single_sha"])
    b19 = {k: g19["launches"].get(k, 0) for k in b18}
    mark("phase 19")

    # phase 20: the pack scan as one device program: 20a every parity
    # family, topology groups included, 20c logs that overflow and 20d a
    # bulk budget of one row, kernel against the plain scan on the card;
    # 20b 17a's workload, sequential and segmented; 20e phase 5's full
    # reference mix (kept for phase 5)
    scan20 = phase_scan_families()
    mark("phase 20a, 20c, 20d")
    full20 = phase_scan_full(w17, want_19a)
    del w17
    gc.collect()
    mark("phase 20b")
    mix = full_mix()
    mark("building the full mix")
    mix20 = phase_scan_mix(mix, max_nodes)
    mark("phase 20e")

    # phase 3: card and CPU place config 2 identically; the card's solve is
    # flight-recorded (phase 11 replays the record)
    pods, provs, its, nodes = config2()
    recorder = flightrec.FlightRecorder().enable()
    t0 = time.perf_counter()
    live = recorder.begin(pods, provs, its, state_nodes=nodes, max_nodes=2048)
    config2_record = {"snapshot_s": time.perf_counter() - t0}
    screen.reset_launches()
    t0 = time.perf_counter()
    on_card = torch_solver.TorchSolver(max_nodes=2048, device="cuda").solve(
        pods, provs, its, state_nodes=nodes)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    live.finish("torch", on_card)
    config2_record.update(record=recorder.last(), finish_s=time.perf_counter() - t0,
                          placements=torch_solver.placements_json(on_card))
    say(f"[parity] config 2 on the card: {launches_line()}")
    t0 = time.perf_counter()
    on_cpu = torch_solver.TorchSolver(max_nodes=2048, device="cpu").solve(
        pods, provs, its, state_nodes=nodes)
    t_cpu = time.perf_counter() - t0
    a, b = torch_solver.placements_json(on_card), torch_solver.placements_json(on_cpu)
    if a != b:
        raise AssertionError("config 2: card and CPU placements differ")
    check_placements(on_card, len(pods))
    say(f"[parity] config 2: {len(pods)} pods, new {on_card.pod_count_new()} on "
        f"{len(on_card.new_machines)} machines, existing "
        f"{on_card.pod_count_existing()}, failed {len(on_card.failed_pods)}; "
        f"card {t_card:.2f} s, cpu {t_cpu:.2f} s; placements byte-identical "
        f"({len(a)} bytes)")
    mark("phase 3")

    # phase 3b: card and CPU place the topology cells identically
    for name, (pods, provs, its), nodes, mn in (
        ("config 3", config3(), [], 20000 // 3 + 64),
        ("diverse 5k x 400", reference_mix(5000, 400), [], max(1024, 5000 // 5 + 512)),
    ):
        zones = _zones(its)
        screen.reset_launches()
        t0 = time.perf_counter()
        card_solver = torch_solver.TorchSolver(max_nodes=mn, device="cuda")
        on_card = card_solver.solve(pods, provs, its, state_nodes=nodes)
        t_card = time.perf_counter() - t0
        scan = dict(pack.LAST_SCAN)
        check_kernel_route(name, scan)
        card_launches = launches_line()
        card_device_ms = card_solver.last_phase_ms["device"]
        card_row_n1 = screen.FORM_LAUNCHES["row_n1"]
        t0 = time.perf_counter()
        on_cpu = torch_solver.TorchSolver(max_nodes=mn, device="cpu").solve(
            pods, provs, its, state_nodes=nodes)
        t_cpu = time.perf_counter() - t0
        a, b = torch_solver.placements_json(on_card), torch_solver.placements_json(on_cpu)
        if a != b:
            raise AssertionError(f"{name}: card and CPU placements differ")
        check_placements(on_card, len(pods))
        checked = check_topology(on_card, zones)
        say(f"[parity] {name}: {len(pods)} pods, new {on_card.pod_count_new()} on "
            f"{len(on_card.new_machines)} machines, existing "
            f"{on_card.pod_count_existing()}, failed {len(on_card.failed_pods)}, rounds "
            f"{on_card.rounds}; card {t_card:.2f} s, cpu {t_cpu:.2f} s; placements "
            f"byte-identical ({len(a)} bytes); topology checked {json.dumps(checked)}; "
            f"card scan {json.dumps(scan)}; {card_launches}")
        say(f"[parity] {name} on the kernel: device {card_device_ms:.1f} ms, row_n1 "
            f"launches {card_row_n1}, longest pack_scan launch so far "
            f"{pack_scan.LAST_LAUNCH['max_ms']:.1f} ms")
    mark("phase 3b")

    # phase 3c: card and CPU place a live cluster's inputs identically
    pods, provs, its, client, cluster = live_cluster(4500, 400, 200, distinct=100,
                                                     n_ingress=300, n_sets=2)
    zones = _zones(its)
    got = {}
    for dev in ("cuda", "cpu"):
        screen.reset_launches()
        t0 = time.perf_counter()
        got[dev] = torch_solver.TorchSolver(max_nodes=1512, device=dev).solve(
            pods, provs, its, state_nodes=cluster.nodes(), kube_client=client,
            cluster=cluster)
        got[dev + "_s"] = time.perf_counter() - t0
        got[dev + "_scan"] = dict(pack.LAST_SCAN)
        got[dev + "_launches"] = launches_line()
    on_card = got["cuda"]
    a, b = torch_solver.placements_json(on_card), torch_solver.placements_json(got["cpu"])
    if a != b:
        raise AssertionError("live cluster 5k: card and CPU placements differ")
    if on_card.failed_pods:
        raise AssertionError(f"live cluster 5k: {len(on_card.failed_pods)} pods failed")
    usage = check_placements(on_card, len(pods), client)
    checked = check_topology(on_card, zones, client)
    say(f"[parity] live cluster 5k: {len(pods)} pods, 200 nodes, 6,000 bound pods; new "
        f"{on_card.pod_count_new()} on {len(on_card.new_machines)} machines, existing "
        f"{on_card.pod_count_existing()}, failed {len(on_card.failed_pods)}, rounds "
        f"{on_card.rounds}; card {got['cuda_s']:.2f} s, cpu {got['cpu_s']:.2f} s; "
        f"placements byte-identical ({len(a)} bytes); topology checked "
        f"{json.dumps(checked)}; cluster usage {json.dumps(usage)}; card scan "
        f"{json.dumps(got['cuda_scan'])}; {got['cuda_launches']}")
    mark("phase 3c")

    # phase 4: the generic share at full width, cold then warm
    # phases 4-6 solve each workload cold then warm with the full
    # precompute, as they always have; phase 7 drives the incremental path
    solver = torch_solver.TorchSolver(max_nodes=max_nodes, device="cuda", incremental="off")
    gen_launches, gen_forms, *_ = run_main_path("generic", solver, gen)
    if gen_launches["screen"] < 1 or gen_launches["screen_prep"] < 1 or gen_forms["block"] < 1:
        raise AssertionError("the generic path did not launch screen_prep and the "
                             "block-form screen")
    mark("phase 4")

    # phase 5: the main path, the whole reference mix at full width (20e's)
    mix_launches, mix_forms, *_ = run_main_path(
        "main", torch_solver.TorchSolver(max_nodes=max_nodes, device="cuda",
                                         incremental="off"), mix,
        zones=_zones(mix[2]))
    if (mix_launches["screen_prep"] < 1 or mix_forms["block"] < 1
            or mix_forms["row_n1"] < 1):
        raise AssertionError("the main path did not launch screen_prep and the screen "
                             "in its block and row_n1 forms")
    mark("phase 5")

    # phase 6: the slice's main path, the reference mix as a live cluster's
    # backlog at full width
    t0 = time.perf_counter()
    pods, provs, its, client, cluster = live_cluster()
    say(f"[cluster] built {len(pods)} pending pods, {len(cluster.nodes_by_provider_id)} "
        f"nodes, {len(cluster.bindings)} bound pods in {time.perf_counter() - t0:.2f} s")
    mark("building the live cluster")
    live_launches, live_forms, live_solver, live_result, live_snap = run_main_path(
        "cluster", torch_solver.TorchSolver(max_nodes=max_nodes, device="cuda",
                                            incremental="off"),
        (pods, provs, its, None), zones=_zones(its), cluster=cluster)
    if (live_launches["screen_prep"] < 1 or live_forms["block"] < 1
            or live_forms["row_n1"] < 1):
        raise AssertionError("the live-cluster path did not launch screen_prep and the "
                             "screen in its block and row_n1 forms")
    mark("phase 6")
    if "--profile" in sys.argv[1:]:
        profile_solve(live_solver, (pods, provs, its), cluster)
        profile_solve(torch_solver.TorchSolver(max_nodes=max_nodes, device="cuda",
                                               screen_mode="tiered"),
                      (pods, provs, its), cluster, label="profile tiered")
        mark("the profiled solves")

    # phase 14a and 14c (the solver boundary) on phase 6's cluster before
    # phase 7 changes it: its backlog through the solver host's child, then
    # over gRPC, each byte-identical to phase 6's in-process solve
    b14a = phase_boundary_full(pods, provs, its, client, cluster, max_nodes, live_result)
    b14c = phase_grpc(pods, provs, its, client, cluster, max_nodes, live_result, live_snap)
    mark("phase 14a and 14c")

    # phase 2's tiered shape: row_b1 on the main path's slot planes
    tiered_shape = phase_tiered_shape(live_snap, provs, max_nodes, int_rate, busy_cycles)
    mark("phase 2 (the tiered shape)")

    # phase 6b: the live cluster solved with the tiered screen (one turn:
    # the prescreen's turn, phase 6's solve again, is the depth cut that
    # pays for phase 16), with the launch counts set to 0 just before the
    # solve and read just after
    solver = torch_solver.TorchSolver(max_nodes=max_nodes, device="cuda",
                                      screen_mode="tiered", incremental="off")
    screen.reset_launches()
    t0 = time.perf_counter()
    res = solver.solve(pods, provs, its, state_nodes=cluster.nodes(), kube_client=client,
                       cluster=cluster)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = screen.launch_counts()
    a = torch_solver.placements_json(res)
    if a != torch_solver.placements_json(live_result):
        raise AssertionError("tiered: placements differ from the prescreen solve's (phase 6)")
    if counts["row_b1"] < 1 or counts["block"] or counts["row_n1"]:
        raise AssertionError(f"tiered: the solve launched {json.dumps(counts)}; expected "
                             "row_b1 and no block or row_n1")
    say(f"[tiered] live cluster, tiered: {wall:.3f} s wall, last_phase_ms "
        + json.dumps({k: round(v, 3) for k, v in solver.last_phase_ms.items()})
        + f", scan {json.dumps(pack.LAST_SCAN)}, launches {json.dumps(counts)}; "
        f"placements byte-identical to phase 6 ({len(a)} bytes)")
    tiered_launches = {k: counts.get(k, 0) for k in screen.LAUNCHES}
    tiered_forms = {k: counts.get(k, 0) for k in screen.FORM_LAUNCHES}
    mark("phase 6b")

    # phase 7: steady churn over the live cluster, incremental against full
    churn_launches, churn_forms, _steps = phase_churn(
        pods, provs, its, client, cluster, max_nodes, _zones(its), steps=CHURN_STEPS)
    mark("phase 7")

    del pods, provs, its, client, cluster, live_solver, live_result, live_snap
    gc.collect()

    # phase 8: consolidation over a settled live cluster at full width; from
    # here on the flight recorder is armed, as the operator runs it, and
    # records each consolidation pass
    FLIGHTREC.enable()
    t0 = time.perf_counter()
    c_its, c_client, c_cluster, c_clock = settled_cluster(n_nodes=PHASE8_NODES)
    say(f"[consolidation] built {len(c_cluster.nodes_by_provider_id)} nodes, "
        f"{len(c_cluster.bindings)} bound pods in {time.perf_counter() - t0:.2f} s")
    cons = phase_consolidation("consolidation", c_its, c_client, c_cluster, c_clock)
    check_consolidation(cons)
    ladder_records = cons["runs"]["multi"]["records"]
    if not ladder_records or "inputs" not in ladder_records[-1][0]:
        raise AssertionError("consolidation: the ladder pass left no flight record with "
                             "inputs")
    say(f"[consolidation] the ladder's flight record at full width: "
        f"{len(ladder_records[-1][0]['inputs']['stateNodes'])} state nodes, taken in "
        f"{ladder_records[-1][1]:.3f} s; no cluster context (record_consolidation "
        f"snapshots without a kube client, as the reference's does)")
    # the kernels at this path's own shapes: each deprovisioner's union
    # snapshot, held exactly against the plain versions and timed
    union = {}
    for kind in ("multi", "single"):
        u_snap, u_provs = cons["runs"][kind]["replans"][0]["union"]
        union[kind] = snapshot_shapes(f"union ({kind})", u_snap, u_provs, int_rate,
                                      busy_cycles)
    cons_launches = {}
    for run in cons["runs"].values():
        _add_counts(cons_launches, run["launches"])
    cons_forms = {k: cons_launches.get(k, 0) for k in screen.FORM_LAUNCHES}
    cons_launches = {k: cons_launches.get(k, 0) for k in screen.LAUNCHES}
    mark("phase 8")

    # phase 9: the chain executed on phase 8's cluster: phase 8's ladder
    # Command, then the TTL deprovisioners, through the lifecycle
    lc = Lifecycle("lifecycle", c_its, c_client, c_clock)
    t0 = time.perf_counter()
    lc.step()
    say(f"[lifecycle] set-up step (termination finalizers on "
        f"{sum(1 for n in c_client.list('Node', copy_objects=False) if n.metadata.finalizers)}"
        f" nodes) in {time.perf_counter() - t0:.3f} s")
    ladder = execute_ladder(lc, cons["runs"]["multi"]["cmd"])
    ttl_passes(lc, expire=3, spot_pinned=1)
    # the kernels at this path's own shapes: the first Expiration pass's
    # simulate snapshot (the remaining nodes against the class axis of the
    # expired node's pods), held exactly against the plain versions and
    # timed
    first = lc.passes[0]["solves"]
    if not first or first[0]["snapshot"] is None:
        raise AssertionError("lifecycle: expiration 1 ran no simulate solve")
    simulate = snapshot_shapes("simulate (expiration 1)", *first[0]["snapshot"], int_rate,
                               busy_cycles)
    life_launches = {}
    for rec in lc.passes:
        _add_counts(life_launches, rec["launches"])
    for k in ("screen_prep", "block", "row_n1"):
        if not life_launches.get(k) and not (k == "row_n1" and life_launches.get("pack_scan")):
            raise AssertionError(f"lifecycle: phase 9's passes launched no {k}")
    life_forms = {k: life_launches.get(k, 0) for k in screen.FORM_LAUNCHES}
    life_launches = {k: life_launches.get(k, 0) for k in screen.LAUNCHES}
    say(f"[lifecycle] passes {[(r['name'], r['key'][1], len(r['key'][2])) for r in lc.passes]}"
        f", ladder {json.dumps({k: ladder[k] for k in ('nodes', 'pods')})}, launches "
        f"{json.dumps(life_launches)} by form {json.dumps(life_forms)}, deprovisioning "
        f"{json.dumps(series_of(deprovisioning_ctrl.ACTIONS))}")
    del c_its, c_client, c_cluster, cons, lc
    gc.collect()
    mark("phase 9")

    # phase 8b: the card and the CPU decide alike at half of phase 3c's size
    s_its, s_client, s_cluster, s_clock = settled_cluster(*PAIR_HALF[:3],
                                                          distinct=PAIR_HALF[3],
                                                          n_ingress=150, n_sets=2)
    on_card = phase_consolidation("consolidation 8b card", s_its, s_client, s_cluster,
                                  s_clock, want_slots=True)
    on_cpu = phase_consolidation("consolidation 8b cpu", s_its, s_client, s_cluster,
                                 s_clock, device="cpu", want_slots=True)
    say(f"[consolidation 8b] card and CPU agree: "
        f"{json.dumps(compare_consolidation(on_card, on_cpu))}")
    ladder_8b = on_card["runs"]["multi"]["records"][-1][0]
    del on_card, on_cpu
    mark("phase 8b")

    # phase 9b: the card and the CPU execute alike at half of phase 8b's size
    say(f"[lifecycle 9b] card and CPU agree: "
        f"{json.dumps(phase_lifecycle_pair(size=PAIR_QUARTER))}")
    mark("phase 9b")

    # phase 10: the operator at full width, phase 6's live cluster through
    # new_operator and two steps
    trace_path = os.path.join(tempfile.gettempdir(),
                              f"karpenter-operator-trace-{os.getpid()}.json")
    op10 = phase_operator("operator", (50000, 500, 1000, 1000, {}), trace_path=trace_path,
                          steps=1)
    op_counts = op10["launches"]
    for k in ("screen_prep", "block", "row_n1"):
        if not op_counts.get(k):
            raise AssertionError(f"operator: phase 10's steps launched no {k}")
    op_solve = op10["run"].solves[0]
    check_kernel_route("operator step 1", op_solve["scan"])
    say(f"[operator] step 1's solve on the pack_scan kernel: device "
        f"{op_solve['phases_raw']['device']:.1f} ms, row_n1 launches {op_counts['row_n1']} "
        f"and pack_scan {op_counts['pack_scan']} in the step, scan "
        f"{json.dumps(op_solve['scan'])}, longest pack_scan launch so far "
        f"{pack_scan.LAST_LAUNCH['max_ms']:.1f} ms")
    op_snap = op_solve["snapshot"]
    operator_shapes = snapshot_shapes("operator (step 1)", *op_snap, int_rate, busy_cycles)
    step_walls = [(st["name"], st["wall_s"], st["parts_s"], st["gen2"])
                  for st in op10["steps"]]
    # phase 10's collections, without the server's collector tuning: phase
    # 13's "without"
    op10_gen2 = {st["name"]: st["gen2"] for st in op10["steps"]}
    say(f"[operator] steps {json.dumps(step_walls)}; machines launched "
        f"{op10['passed']['machines']}, events posted {op10['events']}; spans "
        f"{json.dumps(op10['spans'])}")
    del op10, op_snap, op_solve
    gc.collect()
    mark("phase 10")

    # phase 10b: card against CPU at half of 3c's size, with the ICE and
    # cap legs
    pair = phase_operator_pair()
    gc.collect()
    mark("phase 10b")

    # phase 11: the flight records replayed on the card: 8b's ladder
    # decision, 10b's step-1 solve (its pods mount claims the record lacks),
    # phase 3's config-2 solve (a whole record) and an operator step's
    # solve whose record keeps its bound pods
    replay_consolidation_record("8b ladder record", ladder_8b)
    replay_solve_record("10b step-1 record", pair["record"], must_match_live=False)
    replay_solve_record("config 2 record", config2_record, must_match_live=True)
    under = phase_operator("operator 11", RECORD_SIZE, max_nodes=1512, record=True)
    replay_solve_record("operator step-1 record (bound pods under the cap)",
                        under["run"].records[0], must_match_live=True)
    del under
    TRACER.disable()
    FLIGHTREC.disable()
    mark("phase 11")

    # phase 12: the fallback paths: ResilientSolver around the card's
    # solver (12a), a wedge and its recovery (12b), GreedySolver against
    # the card and the card's fixed cost (12c), the native packer (12d)
    fb = phase_fallback()
    mark("phase 12")

    # phase 14b: the wedge drill through the solver host at half of phase
    # 13's size
    b14b = phase_wedge_drill()
    mark("phase 14b")

    # phase 13: the process entry, run() on a thread over PHASE12_SIZE's
    # cluster
    # (it runs last: the collector tuning and the signal handlers are
    # process-wide; it restores the collector when it ends)
    ent = phase_entry(gen2_without=op10_gen2)
    first_live = ent["out"]["solves"][0]
    say(f"[entry] the first live solve (pack_scan loaded by the prewarm): device "
        f"{first_live['child_phases_ms'].get('device', first_live['phases_ms'].get('device'))}"
        f" ms in the solver host's child, {first_live['pods']} pods")
    entry_shapes = snapshot_shapes("entry (first live solve)", *ent["snapshot"], int_rate,
                                   busy_cycles)
    mark("phase 13")

    op_launches = {k: op_counts.get(k, 0) for k in screen.LAUNCHES}
    op_forms = {k: op_counts.get(k, 0) for k in screen.FORM_LAUNCHES}
    fb_launches = {k: fb["launches"].get(k, 0) for k in screen.LAUNCHES}
    fb_forms = {k: fb["launches"].get(k, 0) for k in screen.FORM_LAUNCHES}
    ent_launches = {k: ent["launches"].get(k, 0) for k in screen.LAUNCHES}
    ent_forms = {k: ent["launches"].get(k, 0) for k in screen.FORM_LAUNCHES}
    # phase 14's: the solver host's children (14a, 14b) and the gRPC
    # service in this process (14c)
    b14 = {k: b14a["launches"][k] + b14b["launches"][k]
           + (b14c["launches"].get(k, 0) if b14c else 0) for k in b14a["launches"]}
    # phase 15's: the solver host's children of 15a and 15b
    b15 = {k: soak["launches"][k] + steady["launches"][k] for k in soak["launches"]}
    # phase 16's: 16a's child (its in-process solver on the card) and 16b's
    # solver host's child
    b16 = {k: race["launches"][k] + over_http["launches"][k] for k in race["launches"]}
    runs = (gen_launches, mix_launches, live_launches, tiered_launches, churn_launches,
            cons_launches, life_launches, op_launches, fb_launches, ent_launches, b14, b15,
            b16, b17, b18, b19)
    form_runs = (gen_forms, mix_forms, live_forms, tiered_forms, churn_forms, cons_forms,
                 life_forms, op_forms, fb_forms, ent_forms, b14, b15, b16, b17, b18, b19)
    launches = {k: sum(r[k] for r in runs) for k in gen_launches}
    forms = {k: sum(r[k] for r in form_runs) for k in gen_forms}
    if not launches["pack_scan"]:
        raise AssertionError("no solve of phases 4-19 launched the pack_scan kernel")
    say(f"[launches] phase 10 {json.dumps(op_counts)}, phase 12a {json.dumps(fb['launches'])}"
        f", phase 13 (the solver host's child) {json.dumps(ent['launches'])}, phase 14 "
        f"{json.dumps(b14)} (14a {json.dumps(b14a['launches'])}, 14b "
        f"{json.dumps(b14b['launches'])}, 14c "
        f"{json.dumps(b14c['launches']) if b14c else 'not run'}), phase 15 {json.dumps(b15)} "
        f"(15a {json.dumps(soak['launches'])}, 15b {json.dumps(steady['launches'])}), phase 16 "
        f"{json.dumps(b16)} (16a {json.dumps(race['launches'])}, 16b "
        f"{json.dumps(over_http['launches'])}), phase 17 {json.dumps(b17)}, phase 18 "
        f"{json.dumps(b18)}, phase 19 (its ranks summed) {json.dumps(b19)}; phases 4-10, "
        f"12a and 13-19 summed {json.dumps(launches)} by form {json.dumps(forms)}")

    # the line's numbers are those of this slice's main path, phase 10's
    # first operator step (the live cluster's backlog, solved through
    # new_operator); "shapes" keeps each shape the script timed: the
    # earlier slices' (phase 2 on the main path's snapshot, both unions of
    # phase 8, phase 9's simulate) and phase 10's. row_b1 is not on the
    # paths of phases 8-10 (prescreen mode): it keeps the tiered screen's
    # shape
    main_shapes = operator_shapes
    err = max(kstats["max_abs_err"], simulate["max_abs_err"], operator_shapes["max_abs_err"],
              entry_shapes["max_abs_err"], segmented_shapes["max_abs_err"],
              audit17["max_abs_err"], tile18["max_abs_err"],
              *(u["max_abs_err"] for u in union.values()))
    common = {"route": "cuda", "source": "karpenter_core_tpu_torch/csrc/screen.cu",
              "replaces": "karpenter_core_tpu/ops/pallas_kernels.py:29",
              "max_abs_err": err, "library_ms": None}
    by_shape = {"main path (phase 2)": kstats, "union multi (phase 8)": union["multi"],
                "union single (phase 8)": union["single"],
                "simulate expiration 1 (phase 9)": simulate,
                "operator step 1 (phase 10)": operator_shapes,
                "entry first live solve (phase 13)": entry_shapes,
                "segmented existing nodes (phase 17b)": segmented_shapes}

    def times(stats, prep=False):
        if prep:
            return {"ms": stats["prep_ms"], "kernel_ms": stats["prep_kernel_ms"],
                    "bound_ms": stats["prep_bound_ms"], "bound_by": stats["prep_bound_by"],
                    "N": stats["N"]}
        return {k: stats[k] for k in ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                      "form", "N", "B")}

    def shapes_of(shape_name, prep=False):
        out = {}
        for where, sh in by_shape.items():
            st = times(sh["timed"][shape_name], prep)
            if prep:
                st["plain_ms"] = sh["slot_prep_plain_ms"]
            out[where] = st
        return out

    # phase 17a's own calls at full width (ScreenAudit): its largest block
    # and a lane's row_n1 re-screen, beside the shapes above
    where17 = "segmented full width (phase 17a)"
    blk17, row17 = audit17["timed"]["block"], audit17["timed"]["row_n1"]
    # phase 18c's verdict tile on the grid's last device
    where18 = f"grid tile on {tile18['device']}, {grid_kind} grid (phase 18c)"
    prep17 = dict(times(blk17, prep=True), plain_ms=blk17["prep_plain_ms"])

    def form_entry(form, stats, replaces, shapes):
        return dict(common, name=f"screen/{form}", replaces=replaces,
                    launches=forms[form], ms=stats["ms"], kernel_ms=stats["kernel_ms"],
                    plain_ms=stats["plain_ms"], bound_ms=stats["bound_ms"],
                    bound_by=stats["bound_by"], shapes=shapes,
                    max_abs_err=max(err, stats.get("max_abs_err", 0.0)))

    # ms is the wrapper's time at the block shape (screen: screen_block, its
    # slot prep included; screen_prep: the slot side's screen_prep call);
    # kernel_ms is that kernel's launch alone. The per-form entries time
    # each form at its shape on the path: the existing block, the virgin
    # row (a slot's in-scan re-screen), and the tiered screen's open slots
    # against one class row
    blk = main_shapes["timed"]["existing block E x C"]
    row_n1 = main_shapes["timed"]["virgin row 1 x C"]
    kernels = [
        dict(common, name="screen", launches=launches["screen"],
             ms=blk["ms"], kernel_ms=blk["kernel_ms"], plain_ms=blk["plain_ms"],
             bound_ms=blk["bound_ms"], bound_by=blk["bound_by"],
             shapes=dict(shapes_of("existing block E x C"), **{where17: times(blk17),
                                                               where18: times(tile18)})),
        dict(common, name="screen_prep", launches=launches["screen_prep"],
             ms=blk["prep_ms"], kernel_ms=blk["prep_kernel_ms"],
             plain_ms=main_shapes["slot_prep_plain_ms"],
             bound_ms=blk["prep_bound_ms"], bound_by=blk["prep_bound_by"],
             shapes=dict(shapes_of("existing block E x C", prep=True), **{where17: prep17})),
        form_entry("block", blk, "karpenter_core_tpu/ops/pallas_kernels.py:160",
                   dict(shapes_of("existing block E x C"), **{where17: times(blk17),
                                                              where18: times(tile18)})),
        form_entry("row_n1", row_n1, "karpenter_core_tpu/ops/pallas_kernels.py:160",
                   dict(shapes_of("virgin row 1 x C"), **{where17: times(row17)})),
        form_entry("row_b1", tiered_shape, "karpenter_core_tpu/ops/pallas_kernels.py:104",
                   {"tiered nopen x 1 (phase 6)": times(tiered_shape)}),
    ]
    # the scan kernel at the full reference mix's scan (phase 20e, phase
    # 5's workload): ms is the solve program's run (feasibility, the scan's
    # set-up, the launch and the read), kernel_ms the launch alone,
    # plain_ms the same run with the eager scan; "shapes" keeps 17a's
    # sequential scan (20b) and each parity family's (20a, 20c, 20d)
    seq20, mix_seq = full20["seq"], mix20["seq"]
    kernels.append(dict(
        name="pack_scan", route="cuda", source="karpenter_core_tpu_torch/csrc/pack_scan.cu",
        replaces="karpenter_core_tpu/ops/pack.py:909", launches=launches["pack_scan"],
        max_abs_err=max(scan20["max_abs_err"], full20["max_abs_err"], mix20["max_abs_err"]),
        ms=mix_seq["ms"], kernel_ms=mix_seq["kernel_ms"], plain_ms=mix_seq["plain_ms"],
        bound_ms=mix_seq["bound_ms"], bound_by=mix_seq["bound_by"], library_ms=None,
        shapes=dict({"17a sequential (phase 20b)": {
            k: seq20[k] for k in ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by")}},
            **{f"{family} (phase 20)": st for family, st in scan20["families"].items()})))
    longest = pack_scan.LAST_LAUNCH["max_ms"]
    say(f"[pack_scan] the longest launch of the run: {longest:.1f} ms against the "
        f"watchdogs' {WEDGE_STALE_S:.1f} s staleness (its progress word moves at each item "
        f"and every 64th step)")
    say(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    if "--create-backlog" in argv:
        code = create_backlog(argv)
    elif "--dist-rank" in argv:
        code = dist_rank()
    else:
        code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # leave without the interpreter's teardown of the phases' heap (peak
    # RSS ~9 GiB): it checks nothing, and the whole command took 865.4 s
    # against the 797.4 s the script printed on one H100's host
    os._exit(code)
