"""Batched consolidation replan: K candidate node-subsets screened in a
few device dispatches (the reference's solver/replan.py).

The upstream deprovisioner evaluates multi-node consolidation with
O(log N) sequential scheduling simulations (multinodeconsolidation.go:
87-113) and single-node consolidation with one simulation per candidate
(singlenodeconsolidation.go:44-86). Here the whole search (the multi-node
prefix ladder, every single-node singleton, the all-empty-nodes subset)
screens as a handful of dispatches of TorchSolver.replan_screen:

  * the union scenario is encoded once: every candidate stays in the
    snapshot as an existing slot, and every candidate's pods enter the pod
    axis tagged with their candidate index;
  * subset k closes its victims' slots (exist_open) and activates their
    pods' replica counts (count_row); everything else (the feasibility
    planes, the [N, C] prescreen verdict tensor, the instance types) is
    shared across subsets (ops/pack.make_batched_replan_kernel);
  * replan_screen stages the call as a live solve does, so the prescreen
    dispatch, the resident verdict tensor and its delta refresh
    (solver/incremental.py) are shared with the provisioning path;
  * each subset comes back with (all_scheduled, n_new_machines,
    conclusive) and a host-computed objective: the subset's current price
    (deprovisioning.core.node_prices per candidate), its disruption cost,
    and the savings bound the caller ranks by.

The caller confirms winners through the exact solve path
(simulate_scheduling: price rules, relaxation).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_core_tpu_torch.utils import podutils


@dataclass
class SubsetScreen:
    """One candidate subset's device verdict + host objective."""

    subset: Tuple[int, ...]  # candidate indices (into the caller's list)
    all_scheduled: bool
    n_new_machines: int
    conclusive: bool  # False when an uninitialized existing node took pods
    # objective (host-computed): the subset's current offering price sum,
    # its eviction-cost disruption, and the savings bound used for ranking
    # (price minus the cheapest possible replacement when any new machine
    # is needed; deletes save the full price)
    price: float = 0.0
    disruption: float = 0.0
    savings: float = 0.0
    # True when any member node's current offering is unknown (the price
    # contribution is 0 — rank-conservative; the exact path still applies
    # the reference's price rules to any REPLACE)
    priceless: bool = False
    # [N] per-slot re-pack pod counts, fetched only on request
    # (parity tests / smoke — production reads only the verdict scalars)
    pods_per_slot: Optional[np.ndarray] = None

    @property
    def size(self) -> int:
        return len(self.subset)


@dataclass
class UnionScenario:
    """The union-encoded replan scenario: everything a subset dispatch
    needs beyond the subsets themselves."""

    snap: object  # EncodedSnapshot
    candidates: Sequence
    pods: List  # union pod axis (pending + deleting-node + candidate pods)
    cand_of_pod: Dict[str, int]  # pod uid -> candidate index (-1 = always on)
    provisioners: List
    instance_types: Dict
    daemonset_pods: List
    state_nodes: List  # residual nodes EXCLUDING candidates
    cand_slot: np.ndarray  # [C] candidate -> existing-slot index (-1 = none)
    uninitialized: np.ndarray  # [E] uninitialized existing-slot mask
    counts_base: np.ndarray  # [I] always-active replica count per item
    counts_per_cand: np.ndarray  # [I, C] per-candidate replica counts
    item_pad: int
    prices: List[Optional[float]] = field(default_factory=list)
    replacement_floor: float = 0.0

    def subset_rows(self, subsets: Sequence[Tuple[int, ...]]):
        """(count_rows [K, I_pad] int32, exist_open [K, E] bool) for K
        subsets — the only candidate-axis-batched planes."""
        E = self.snap.exist_used.shape[0]
        K = len(subsets)
        count_rows = np.zeros((K, self.item_pad), dtype=np.int32)
        exist_open = np.ones((K, E), dtype=bool)
        I = len(self.counts_base)
        for r, subset in enumerate(subsets):
            row = self.counts_base.copy()
            for ci in subset:
                row += self.counts_per_cand[:, ci]
                if self.cand_slot[ci] >= 0:
                    exist_open[r, self.cand_slot[ci]] = False
            count_rows[r, :I] = row
        return count_rows, exist_open

    def objective(self, subset: Tuple[int, ...], n_new: int):
        """(price, disruption, savings, priceless) for one subset. Savings
        = what the cluster stops paying (node_prices) minus an optimistic
        floor for any replacement launch (the cheapest worst_launch_price
        in the universe) — a sound RANKING bound: the exact confirming
        path still enforces the reference's strictly-cheaper price filter
        before any REPLACE executes."""
        price = 0.0
        priceless = False
        for ci in subset:
            p = self.prices[ci]
            if p is None:
                priceless = True
            else:
                price += p
        disruption = sum(
            self.candidates[ci].disruption_cost for ci in subset
        )
        savings = price - (self.replacement_floor if n_new > 0 else 0.0)
        return price, disruption, savings, priceless


def build_union_scenario(
    kube_client,
    cluster,
    provisioning,
    candidates,
    max_nodes: int = 1024,
) -> UnionScenario:
    """Encode the union scenario once. Raises CandidateNodeDeletingError
    under the same conditions as simulate_scheduling (a candidate is
    already mid-delete)."""
    from karpenter_core_tpu_torch.controllers.deprovisioning.core import (
        CandidateNodeDeletingError,
        candidate_price,
        replacement_price_floor,
    )
    from karpenter_core_tpu_torch.solver.encode import bucket_pow2, encode_snapshot

    candidate_names = {c.name for c in candidates}
    state_nodes = []
    deleting_nodes = []
    for node in cluster.nodes():
        if node.is_marked_for_deletion():
            deleting_nodes.append(node)
        elif node.name() not in candidate_names:
            state_nodes.append(node)
    if any(n.name() in candidate_names for n in deleting_nodes):
        raise CandidateNodeDeletingError()

    # pod axis: pending + deleting-node pods (always active) + candidate
    # pods (active in the subsets that remove their node)
    pods: List = []
    cand_of: List[int] = []
    for p in provisioning.get_pending_pods():
        pods.append(p)
        cand_of.append(-1)
    for node in deleting_nodes:
        for p in kube_client.list(
            "Pod",
            node_name=node.name(),
            copy_objects=False,  # read-only below; see clone note
        ):
            if not podutils.is_terminal(p) and not podutils.is_owned_by_daemonset(p):
                pods.append(p)
                cand_of.append(-1)
    for ci, c in enumerate(candidates):
        for p in c.pods:
            if not podutils.is_owned_by_daemonset(p):
                pods.append(p)
                cand_of.append(ci)
    # NO clone_for_simulation here, unlike simulate_scheduling. INVARIANT:
    # this path stays strictly read-only over live Pod objects (shared
    # references of the kube client's store): encode_snapshot consumes
    # specs and labels without normalizing them, the device path never
    # reads spec.node_name, and the round-0 scan does no preference
    # relaxation (the only mutating step of the exact path). A consumer
    # of snap.pods that mutates or reads node_name must reinstate the
    # shallow clone.
    cand_of_pod: Dict[str, int] = {
        p.metadata.uid: ci for p, ci in zip(pods, cand_of)
    }

    provisioners = [
        p for p in kube_client.list("Provisioner")
        if p.metadata.deletion_timestamp is None
    ]
    instance_types = {
        p.name: provisioning.cloud_provider.get_instance_types(p)
        for p in provisioners
    }
    daemonset_pods = provisioning.get_daemonset_pods()

    # candidate slots appended AFTER the regular nodes so their indices are
    # stable under encode's owned() filter (candidates are always owned)
    all_nodes = state_nodes + [c.state_node for c in candidates]
    snap = encode_snapshot(
        pods,
        provisioners,
        instance_types,
        daemonset_pods,
        all_nodes,
        kube_client=kube_client,
        cluster=cluster,
        max_nodes=max_nodes,
    ) if provisioners else None

    if snap is None:
        return UnionScenario(
            snap=None, candidates=candidates, pods=pods,
            cand_of_pod=cand_of_pod, provisioners=[], instance_types={},
            daemonset_pods=daemonset_pods, state_nodes=state_nodes,
            cand_slot=np.full(len(candidates), -1, np.int64),
            uninitialized=np.zeros(0, bool),
            counts_base=np.zeros(0, np.int32),
            counts_per_cand=np.zeros((0, len(candidates)), np.int32),
            item_pad=0,
            prices=[candidate_price(c) for c in candidates],
        )

    E = snap.exist_used.shape[0]  # bucket-padded existing axis
    name_to_slot = {n.name(): e for e, n in enumerate(snap.state_nodes)}
    cand_slot = np.full(len(candidates), -1, dtype=np.int64)
    for ci, c in enumerate(candidates):
        cand_slot[ci] = name_to_slot.get(c.name, -1)
    uninitialized = np.zeros(E, dtype=bool)  # padded sentinel rows: False
    uninitialized[: len(snap.state_nodes)] = [
        not n.initialized() for n in snap.state_nodes
    ]

    # per-item replica counts, factored by candidate membership so K
    # subset rows build by vectorized gather instead of a K x P host scan
    members = snap.item_members or [[i] for i in range(len(snap.pods))]
    I = len(snap.item_counts) if snap.item_counts is not None else len(snap.pods)
    item_of = np.zeros(len(snap.pods), dtype=np.int64)
    for it, mem in enumerate(members):
        for m in mem:
            item_of[m] = it
    cand_of_row = np.array(
        [cand_of_pod.get(p.metadata.uid, -1) for p in snap.pods],
        dtype=np.int64,
    )
    counts_base = np.zeros(I, dtype=np.int32)
    counts_per_cand = np.zeros((I, max(len(candidates), 1)), dtype=np.int32)
    if len(snap.pods):
        base_sel = cand_of_row < 0
        np.add.at(counts_base, item_of[base_sel], 1)
        cand_sel = ~base_sel
        if cand_sel.any():
            np.add.at(
                counts_per_cand,
                (item_of[cand_sel], cand_of_row[cand_sel]),
                1,
            )

    item_pad = snap.item_pad or bucket_pow2(max(I, 1), 32)
    return UnionScenario(
        snap=snap, candidates=candidates, pods=list(snap.pods),
        cand_of_pod=cand_of_pod, provisioners=provisioners,
        instance_types=instance_types, daemonset_pods=daemonset_pods,
        state_nodes=state_nodes, cand_slot=cand_slot,
        uninitialized=uninitialized, counts_base=counts_base,
        counts_per_cand=counts_per_cand, item_pad=item_pad,
        prices=[candidate_price(c) for c in candidates],
        replacement_floor=replacement_price_floor(instance_types),
    )


def batched_subset_screen(
    kube_client,
    cluster,
    provisioning,
    candidates,
    subsets: Sequence[Sequence[int]],
    max_nodes: int = 1024,
    want_slots: bool = False,
    scenario: Optional[UnionScenario] = None,
) -> Tuple[List[SubsetScreen], UnionScenario]:
    """One union encode + batched device dispatches screening every
    candidate subset, with the per-subset objective attached. Returns
    (screens in input order, the union scenario, reusable for further
    dispatches in the same pass).

    Raises CandidateNodeDeletingError like simulate_scheduling."""
    if scenario is None:
        scenario = build_union_scenario(
            kube_client, cluster, provisioning, candidates,
            max_nodes=max_nodes,
        )
    return (
        _screen_subsets(provisioning, scenario, subsets, want_slots, cluster),
        scenario,
    )


def _screen_subsets(provisioning, scenario: UnionScenario,
                    subsets: Sequence[Sequence[int]],
                    want_slots: bool, cluster=None) -> List[SubsetScreen]:
    """The subsets' verdicts from one replan_screen call, with their
    objectives. The cluster's change feed gates the solver's resident
    tensor here as in a solve (the reference passes no cluster): the exact
    solves that confirm a winner consult the same feed, and a first
    consult by them would otherwise drop the replan's residency before the
    next pass's replan could refresh it."""
    subsets = [tuple(s) for s in subsets]
    if scenario.snap is None:
        # no live provisioners: nothing can re-pack anywhere — feasible
        # only when the union scenario strands no pods at all (the same
        # verdict simulate_scheduling returns, helpers.go:41-105)
        screens = []
        for subset in subsets:
            price, disruption, savings, priceless = scenario.objective(
                subset, 0
            )
            screens.append(
                SubsetScreen(
                    subset=subset, all_scheduled=not scenario.pods,
                    n_new_machines=0, conclusive=True, price=price,
                    disruption=disruption, savings=savings,
                    priceless=priceless,
                )
            )
        return screens

    count_rows, exist_open = scenario.subset_rows(subsets)
    verdicts, pods = provisioning.solver.replan_screen(
        scenario.snap, scenario.provisioners, count_rows, exist_open,
        uninitialized=scenario.uninitialized, cluster=cluster,
        want_slots=want_slots,
    )
    screens = []
    for r, subset in enumerate(subsets):
        scheduled, expected, n_new, incon = (int(v) for v in verdicts[r])
        price, disruption, savings, priceless = scenario.objective(
            subset, n_new
        )
        screens.append(
            SubsetScreen(
                subset=subset,
                all_scheduled=scheduled >= expected,
                n_new_machines=n_new,
                conclusive=not incon,
                price=price,
                disruption=disruption,
                savings=savings,
                priceless=priceless,
                pods_per_slot=pods[r] if pods is not None else None,
            )
        )
    return screens


