"""Consolidation deprovisioners: base logic + empty/multi/single-node.

The port of pkg/controllers/deprovisioning/{consolidation,
emptynodeconsolidation,multinodeconsolidation,singlenodeconsolidation,
validation}.go, as the reference package has it: the multi-node binary
search over candidate prefixes (O(log N) sequential simulated solves,
multinodeconsolidation.go:87-113) becomes a geometric prefix ladder, and
the single-node sweep a batch of singletons, both screened through
TorchSolver.replan_screen (solver/replan.py) and ranked by savings, with
the winner confirmed through the exact solve.

A failed batched screen degrades to the sequential simulate path, as in
the reference; FALLBACKS counts those degradations (reset_fallbacks()).
"""
from __future__ import annotations

import math
import time
from typing import List

from karpenter_core_tpu_torch.api import labels as api_labels
from karpenter_core_tpu_torch.controllers.deprovisioning.core import (
    ACTION_DELETE,
    ACTION_DO_NOTHING,
    ACTION_REPLACE,
    ACTION_RETRY,
    CandidateNode,
    CandidateNodeDeletingError,
    Command,
    PDBLimits,
    can_be_terminated,
    candidate_nodes,
    filter_by_price,
    instance_types_are_subset,
    node_prices,
    simulate_scheduling,
)
from karpenter_core_tpu_torch.obs import flightrec
from karpenter_core_tpu_torch.obs.log import get_logger
from karpenter_core_tpu_torch.scheduling.requirement import OP_IN, Requirement

LOG = get_logger("karpenter.deprovisioning.consolidation")

CONSOLIDATION_TTL = 15.0  # consolidation.go:66

# batched screens that failed and fell back to the sequential path, by
# deprovisioner
FALLBACKS = {"multi": 0, "single": 0}


def reset_fallbacks() -> None:
    for k in FALLBACKS:
        FALLBACKS[k] = 0


class Consolidation:
    """consolidation.go:36-110 (shared base)."""

    def __init__(self, kube_client, cluster, provisioning, cloud_provider, recorder,
                 clock=time.time, validation_ttl: float = CONSOLIDATION_TTL):
        self.kube_client = kube_client
        self.cluster = cluster
        self.provisioning = provisioning
        self.cloud_provider = cloud_provider
        self.recorder = recorder
        self.clock = clock
        self.validation_ttl = validation_ttl

    def __str__(self) -> str:
        return "consolidation"

    def should_deprovision(self, state_node, provisioner, pods) -> bool:
        """consolidation.go:89-104."""
        annotations = state_node.annotations()
        if api_labels.DO_NOT_CONSOLIDATE_NODE_ANNOTATION_KEY in annotations:
            return annotations[api_labels.DO_NOT_CONSOLIDATE_NODE_ANNOTATION_KEY] != "true"
        if provisioner is None:
            return False
        return bool(provisioner.spec.consolidation and provisioner.spec.consolidation.enabled)

    def sort_and_filter_candidates(self, candidates: List[CandidateNode]) -> List[CandidateNode]:
        """consolidation.go:69-87: PDB/do-not-evict gate, ascending
        disruption cost."""
        pdbs = PDBLimits(self.kube_client)
        out = []
        for candidate in candidates:
            reason, ok = can_be_terminated(candidate, pdbs)
            if not ok:
                if self.recorder:
                    self.recorder.deprovisioning_blocked("Node", candidate.name, reason)
                continue
            out.append(candidate)
        return sorted(out, key=lambda c: c.disruption_cost)

    def _disruption_budget(self) -> int:
        """The configured victims-per-pass cap (0 = unbounded):
        Settings.consolidation_disruption_budget bounds how many nodes any
        single consolidation command may terminate, so a large savings win
        can never drain more of the cluster in one pass than the operator
        signed up for."""
        from karpenter_core_tpu_torch.api import settings as api_settings

        return api_settings.current().consolidation_disruption_budget

    def _any_relaxable(self, candidates: List[CandidateNode]) -> bool:
        """True when any involved pod (the candidates' or pending) still
        carries a relaxable soft constraint — a negative round-0 screen is
        inconclusive for those (scheduler.go:114-123 relaxes until
        exhaustion), so the exact (relaxing) path must confirm."""
        from karpenter_core_tpu_torch.scheduling.preferences import Preferences

        prefs = Preferences()
        pods = [p for c in candidates for p in c.pods]
        pods += list(self.provisioning.get_pending_pods())
        return any(prefs.is_relaxable(p) for p in pods)

    def _record_pass(self, candidates, screens, cmd: Command,
                     scenario=None) -> None:
        """Flight-record this consolidation decision (the candidate set,
        every screened subset's verdict and objective, the chosen Command,
        and the union scenario's inputs under the recorder's caps), so
        that flightrec.replay_consolidation can re-run each subset through
        the exact solve offline. Recording never breaks the pass."""
        try:
            flightrec.FLIGHTREC.record_consolidation(
                type(self).__name__, candidates, screens, cmd, scenario=scenario)
        except Exception:  # noqa: BLE001 — recording never breaks the pass
            pass

    def compute_consolidation(self, candidates: List[CandidateNode]) -> Command:
        """consolidation.go:180-264: delete if 0 replacements; replace if
        exactly 1 cheaper; spot->spot forbidden; OD->[OD,spot] forces spot."""
        try:
            new_machines, all_scheduled = simulate_scheduling(
                self.kube_client, self.cluster, self.provisioning, candidates
            )
        except CandidateNodeDeletingError:
            return Command(action=ACTION_DO_NOTHING)
        if not all_scheduled:
            self._blocked(candidates, "not all pods would schedule")
            return Command(action=ACTION_DO_NOTHING)
        if len(new_machines) == 0:
            return Command(
                nodes_to_remove=[c.node for c in candidates], action=ACTION_DELETE
            )
        if len(new_machines) != 1:
            self._blocked(
                candidates, f"can't remove without creating {len(new_machines)} nodes"
            )
            return Command(action=ACTION_DO_NOTHING)

        replacement = new_machines[0]
        try:
            current_price = node_prices(candidates)
        except ValueError:
            # a candidate's current offering is unknown (priceless node):
            # the reference's getNodePrices err branch — block the REPLACE
            # (deletes never price and returned above)
            self._blocked(candidates, "unable to determine node prices")
            return Command(action=ACTION_DO_NOTHING)
        replacement.instance_type_options = filter_by_price(
            replacement.instance_type_options, replacement.requirements, current_price
        )
        if not replacement.instance_type_options:
            self._blocked(candidates, "can't replace with a cheaper node")
            return Command(action=ACTION_DO_NOTHING)

        all_spot = all(c.capacity_type == api_labels.CAPACITY_TYPE_SPOT for c in candidates)
        ct_req = replacement.requirements.get_requirement(api_labels.LABEL_CAPACITY_TYPE)
        if all_spot and ct_req.has(api_labels.CAPACITY_TYPE_SPOT):
            self._blocked(candidates, "can't replace a spot node with a spot node")
            return Command(action=ACTION_DO_NOTHING)
        # OD->[OD,spot] flexibility forces the spot side (consolidation.go:246-251)
        if ct_req.has(api_labels.CAPACITY_TYPE_SPOT) and ct_req.has(
            api_labels.CAPACITY_TYPE_ON_DEMAND
        ):
            replacement.requirements.add(
                Requirement(
                    api_labels.LABEL_CAPACITY_TYPE, OP_IN, [api_labels.CAPACITY_TYPE_SPOT]
                )
            )
        return Command(
            nodes_to_remove=[c.node for c in candidates],
            action=ACTION_REPLACE,
            replacement_machines=new_machines,
        )

    def validate_command(self, cmd: Command, candidates: List[CandidateNode]) -> bool:
        """consolidation.go:114-175: re-simulation invariants after TTL."""
        names = {n.metadata.name for n in cmd.nodes_to_remove}
        to_delete = [c for c in candidates if c.name in names]
        if not to_delete:
            return False
        try:
            new_machines, all_scheduled = simulate_scheduling(
                self.kube_client, self.cluster, self.provisioning, to_delete
            )
        except CandidateNodeDeletingError:
            return False
        if not all_scheduled:
            return False
        if len(new_machines) == 0:
            return len(cmd.replacement_machines) == 0
        if len(new_machines) > 1:
            return False
        if not cmd.replacement_machines:
            return False
        return instance_types_are_subset(
            cmd.replacement_machines[0].instance_type_options,
            new_machines[0].instance_type_options,
        )

    def validate_after_ttl(self, cmd: Command) -> bool:
        """validation.go:63-103: wait the TTL, re-scan candidates, nominated
        nodes block, re-validate."""
        self._wait(self.validation_ttl)
        candidates = candidate_nodes(
            self.cluster,
            self.kube_client,
            self.cloud_provider,
            self.should_deprovision,
            self.clock,
        )
        names = {n.metadata.name for n in cmd.nodes_to_remove}
        remaining = [c for c in candidates if c.name in names]
        if len(remaining) != len(names):
            return False
        for candidate in remaining:
            if candidate.state_node.nominated():
                return False
        return self.validate_command(cmd, remaining)

    def _wait(self, seconds: float) -> None:
        """Clock-driven TTL wait (validation.go:60-67). Under the real clock
        this sleeps; under a steppable test clock (anything exposing
        `.sleep`, e.g. testing.FakeClock) it blocks until the clock is
        ADVANCED past the deadline by another thread — the same contract as
        the reference's clock.Sleep on a FakeClock, so the 15s revalidation
        window is actually exercised in tests instead of no-opped. A bare
        callable clock with neither wall-time nor step semantics waits
        nothing."""
        if seconds <= 0:
            return
        sleep = getattr(self.clock, "sleep", None)
        if sleep is not None:
            sleep(seconds)
        elif self.clock is time.time:
            time.sleep(seconds)

    def _blocked(self, candidates: List[CandidateNode], reason: str) -> None:
        if self.recorder and len(candidates) == 1:
            self.recorder.deprovisioning_blocked("Node", candidates[0].name, reason)


class EmptyNodeConsolidation(Consolidation):
    """emptynodeconsolidation.go:44-94."""

    def __str__(self) -> str:
        return "emptiness"

    def compute_command(self, candidates: List[CandidateNode]) -> Command:
        if self.cluster.consolidated():
            return Command(action=ACTION_DO_NOTHING)
        candidates = self.sort_and_filter_candidates(candidates)
        empty = [c for c in candidates if not c.pods]
        budget = self._disruption_budget()
        if budget:
            # victims-per-pass cap (ascending disruption cost — the sort
            # above): the remainder re-enters the next reconcile pass
            empty = empty[:budget]
        if not empty:
            return Command(action=ACTION_DO_NOTHING)
        cmd = Command(nodes_to_remove=[c.node for c in empty], action=ACTION_DELETE)
        # revalidate after TTL: still empty and not nominated
        self._wait(self.validation_ttl)
        revalidated = candidate_nodes(
            self.cluster, self.kube_client, self.cloud_provider,
            self.should_deprovision, self.clock,
        )
        names = {n.metadata.name for n in cmd.nodes_to_remove}
        for candidate in revalidated:
            if candidate.name in names and candidate.pods and not candidate.state_node.nominated():
                return Command(action=ACTION_RETRY)
        return cmd


class MultiNodeConsolidation(Consolidation):
    """multinodeconsolidation.go:42-166, with the parallel prefix ladder in
    place of binary search."""

    LADDER_POINTS = 8

    def __str__(self) -> str:
        return "consolidation"

    def compute_command(self, candidates: List[CandidateNode]) -> Command:
        if self.cluster.consolidated():
            return Command(action=ACTION_DO_NOTHING)
        candidates = self.sort_and_filter_candidates(candidates)
        cmd = self.first_n_consolidation_ladder(candidates)
        if cmd.action == ACTION_DO_NOTHING:
            return cmd
        if not self.validate_after_ttl(cmd):
            # If the rejected command came straight from the batched screen
            # (the delete shortcut), force the NEXT ladder through exact
            # per-rung confirmation: a screen/exact disagreement would
            # otherwise reproduce the identical screen answer every loop —
            # a retry livelock that also shadows smaller, genuinely
            # feasible rungs.
            if cmd.from_screen:
                self._confirm_deletes_once = True
            return Command(action=ACTION_RETRY)
        return cmd

    def first_n_consolidation_ladder(self, candidates: List[CandidateNode]) -> Command:
        """Evaluate a geometric ladder of prefix sizes (plus the all-empty
        subset); keep the best by the savings objective. Replaces the
        reference's sequential binary search
        (multinodeconsolidation.go:87-113).

        On a solver with batched-replan support (TorchSolver), every
        subset is screened in one batched dispatch over a shared union
        encode (solver/replan.py), and feasible subsets rank by REAL
        savings (current node prices minus the replacement floor) with
        disruption cost as the tie-break — not first-feasible-prefix. A
        conclusive 0-new-machine winner becomes the DELETE command
        directly (validate_after_ttl re-simulates through the exact path
        before execution; a validation rejection flips the next ladder
        back to exact per-subset confirmation); REPLACE winners are always
        confirmed through the exact solve path, stepping down the ranking
        on disagreement. Without batched-replan support each prefix rung
        is a full solve (host fallback). The configured disruption budget
        (api/settings.py) caps victims per pass on both paths."""
        if len(candidates) < 2:
            return Command(action=ACTION_DO_NOTHING)
        n = len(candidates)
        budget = self._disruption_budget()
        if budget:
            n = min(n, budget)
        if n < 2:
            return Command(action=ACTION_DO_NOTHING)
        sizes = sorted(
            {
                max(2, min(n, round(n ** (i / (self.LADDER_POINTS - 1)))))
                for i in range(self.LADDER_POINTS)
            }
        ) if n > 2 else [2]

        if getattr(self.provisioning.solver, "supports_batched_replan", False):
            return self._ladder_batched(candidates, sizes)
        return self._ladder_sequential(candidates, sizes)

    def _ladder_sequential(self, candidates: List[CandidateNode],
                           sizes: List[int]) -> Command:
        """The host fallback: one exact solve per prefix rung, keep the
        largest actionable (the pre-batched behavior, and the degrade path
        when the batched screen itself fails)."""
        best = Command(action=ACTION_DO_NOTHING)
        for size in sizes:
            cmd = self._evaluate_prefix(candidates, size)
            if cmd.action in (ACTION_REPLACE, ACTION_DELETE):
                best = cmd
            else:
                break  # larger prefixes are monotonically harder
        return best

    def _evaluate_subset(self, subset: List[CandidateNode]) -> Command:
        """Exact evaluation of one candidate subset: full solve +
        price/same-type rules."""
        cmd = self.compute_consolidation(subset)
        if cmd.action == ACTION_REPLACE:
            cmd.replacement_machines[0].instance_type_options = self._filter_out_same_type(
                cmd.replacement_machines[0], subset
            )
            if not cmd.replacement_machines[0].instance_type_options:
                cmd = Command(action=ACTION_DO_NOTHING)
        return cmd

    def _evaluate_prefix(self, candidates: List[CandidateNode], size: int) -> Command:
        return self._evaluate_subset(candidates[:size])

    def _ladder_batched(self, candidates: List[CandidateNode],
                        sizes: List[int]) -> Command:
        """One batched screen over the prefix rungs + the all-empty-nodes
        subset; feasible subsets rank by (savings desc, disruption asc,
        size desc). Conclusive 0-new-machine winners short-circuit to
        DELETE, REPLACE winners get exact confirmation (price and
        same-type rules live there), stepping down the ranking on
        disagreement. See first_n_consolidation_ladder for the validation
        backstop on the delete shortcut."""
        from karpenter_core_tpu_torch.solver.replan import batched_subset_screen

        confirm_deletes = getattr(self, "_confirm_deletes_once", False)
        subsets = [tuple(range(s)) for s in sizes]
        prefix_count = len(subsets)
        # ride-along emptiness subset: all pod-free candidates in one
        # DELETE — a non-contiguous subset the prefix ladder would only
        # find if the empties happened to sort first (they usually do —
        # zero pods is zero disruption cost — but PDB/price ordering can
        # interleave); free to screen, and it exercises the evaluator's
        # arbitrary-subset encoding on every pass
        budget = self._disruption_budget()
        empty_idx = tuple(
            i for i, c in enumerate(candidates) if not c.pods
        )[: budget or None]
        if len(empty_idx) >= 2 and empty_idx not in set(subsets):
            subsets.append(empty_idx)
        try:
            screens, scenario = batched_subset_screen(
                self.kube_client, self.cluster, self.provisioning, candidates,
                subsets, max_nodes=getattr(
                    self.provisioning.solver, "max_nodes", 1024
                ),
            )
        except CandidateNodeDeletingError:
            # transient (a candidate is mid-delete): keep the one-shot flag
            # so the NEXT successful ladder still runs exact confirmation
            return Command(action=ACTION_DO_NOTHING)
        except Exception as exc:  # noqa: BLE001 — screen is an optimization
            # a solver/RPC fault (remote replan unreachable, breaker open,
            # device error) must degrade to the sequential simulate path —
            # the parity oracle kept for exactly this — never crash the
            # deprovisioning reconcile loop
            LOG.warning("batched consolidation screen failed; sequential fallback",
                        error=type(exc).__name__, error_detail=str(exc)[:200])
            FALLBACKS["multi"] += 1
            return self._ladder_sequential(candidates, sizes)
        self._confirm_deletes_once = False
        feasible = [
            s for s in screens
            if s.all_scheduled and s.conclusive and s.n_new_machines <= 1
        ]
        ranked = sorted(
            feasible, key=lambda s: (-s.savings, s.disruption, -s.size)
        )
        cmd = Command(action=ACTION_DO_NOTHING)
        for screen in ranked:
            subset = [candidates[i] for i in screen.subset]
            # A conclusive 0-new-machine subset IS the delete decision: the
            # screen ran the same round-0 kernel the exact path would (the
            # delete branch of consolidation.go:180-264 checks only "all
            # scheduled, zero replacements" — price/spot/same-type rules
            # exist only for REPLACE), relaxation could only make pods MORE
            # schedulable, and validate_after_ttl re-simulates through the
            # exact path before any node is touched. Skipping the
            # confirming solve here halves the replan's critical path.
            # confirm_deletes (set after a validation rejection of a
            # screen-sourced delete) routes every subset through the exact
            # path instead, restoring the step-down on disagreement.
            if screen.n_new_machines == 0 and not confirm_deletes:
                cmd = Command(
                    nodes_to_remove=[c.node for c in subset],
                    action=ACTION_DELETE,
                    from_screen=True,
                )
                break
            exact = self._evaluate_subset(subset)
            if exact.action in (ACTION_REPLACE, ACTION_DELETE):
                cmd = exact
                break
        else:
            # The screen is the round-0 kernel only — no preference
            # relaxation (scheduler.go:114-123 relaxes until exhaustion).
            # A negative screen is therefore inconclusive when any
            # involved pod still carries a relaxable soft constraint;
            # confirm those prefix rungs through the exact (relaxing) path
            # before concluding nothing consolidates.
            feasible_ids = {s.subset for s in feasible}
            blocked = [
                s for s in sizes if tuple(range(s)) not in feasible_ids
            ]
            if blocked and self._any_relaxable(candidates[: blocked[-1]]):
                for size in blocked:
                    exact = self._evaluate_prefix(candidates, size)
                    if exact.action in (ACTION_REPLACE, ACTION_DELETE):
                        cmd = exact
                    else:
                        break
        self._record_pass(candidates, screens, cmd, scenario=scenario)
        return cmd

    def _filter_out_same_type(self, replacement, consolidated: List[CandidateNode]):
        """multinodeconsolidation.go:133-166: prevent replacing with the same
        instance type unless strictly cheaper than the cheapest existing use
        of that type."""
        existing_types = set()
        prices_by_type = {}
        for c in consolidated:
            existing_types.add(c.instance_type.name)
            offering = c.instance_type.offerings.get(c.capacity_type, c.zone)
            if offering is not None:
                prices_by_type[c.instance_type.name] = min(
                    prices_by_type.get(c.instance_type.name, math.inf), offering.price
                )
        max_price = math.inf
        for it in replacement.instance_type_options:
            if it.name in existing_types:
                max_price = min(max_price, prices_by_type.get(it.name, math.inf))
        return filter_by_price(
            replacement.instance_type_options, replacement.requirements, max_price
        )


class SingleNodeConsolidation(Consolidation):
    """singlenodeconsolidation.go:44-86, with the per-candidate simulation
    sweep replaced by the batched subset evaluator: every singleton subset
    screens in a few chunked device dispatches (solver/replan.py), and
    only the feasible candidates — ranked by savings — pay an exact
    confirming solve. The sequential sweep is kept verbatim as the
    fallback (no batched-replan solver) and as the screened-out backstop
    when relaxable pods make a negative screen inconclusive."""

    def __str__(self) -> str:
        return "consolidation"

    def compute_command(self, candidates: List[CandidateNode]) -> Command:
        if self.cluster.consolidated():
            return Command(action=ACTION_DO_NOTHING)
        candidates = self.sort_and_filter_candidates(candidates)
        order, screens, scenario = self._ranked_candidates(candidates)
        failed_validation = False
        final = Command(action=ACTION_DO_NOTHING)
        for candidate in order:
            cmd = self.compute_consolidation([candidate])
            if cmd.action in (ACTION_DO_NOTHING, ACTION_RETRY):
                continue
            if not self.validate_after_ttl(cmd):
                failed_validation = True
                continue
            final = cmd
            break
        if final.action == ACTION_DO_NOTHING and failed_validation:
            final = Command(action=ACTION_RETRY)
        if screens is not None:
            self._record_pass(candidates, screens, final, scenario=scenario)
        return final

    def _ranked_candidates(self, candidates: List[CandidateNode]):
        """(exact-confirmation order, screens, scenario): feasible
        singletons first, ranked by (savings desc, disruption asc);
        screened-out candidates are dropped UNLESS relaxable pods are in
        play (the screen is the round-0 kernel — a negative verdict is
        inconclusive for them), in which case they trail in the
        reference's original order. Falls back to the untouched candidate
        order (screens=None) when no batched-replan solver is attached or
        the screen fails — the screen is an optimization, never a
        correctness dependency."""
        if len(candidates) < 2 or not getattr(
            self.provisioning.solver, "supports_batched_replan", False
        ):
            return candidates, None, None
        from karpenter_core_tpu_torch.solver.replan import batched_subset_screen

        try:
            screens, scenario = batched_subset_screen(
                self.kube_client, self.cluster, self.provisioning,
                candidates, [(i,) for i in range(len(candidates))],
                max_nodes=getattr(
                    self.provisioning.solver, "max_nodes", 1024
                ),
            )
        except CandidateNodeDeletingError:
            # transient: the sequential sweep handles the mid-delete
            # candidate per-simulation (compute_consolidation catches it)
            return candidates, None, None
        except Exception as exc:  # noqa: BLE001 — screen is an optimization
            LOG.warning("batched consolidation screen failed; sequential sweep",
                        error=type(exc).__name__, error_detail=str(exc)[:200])
            FALLBACKS["single"] += 1
            return candidates, None, None
        feasible = [
            s for s in screens
            if s.all_scheduled and s.conclusive and s.n_new_machines <= 1
        ]
        feasible_ids = {id(s) for s in feasible}
        ranked = sorted(feasible, key=lambda s: (-s.savings, s.disruption))
        order = [candidates[s.subset[0]] for s in ranked]
        screened_out = [
            candidates[s.subset[0]] for s in screens
            if id(s) not in feasible_ids
        ]
        if screened_out and self._any_relaxable(screened_out):
            order += screened_out
        return order, screens, scenario
