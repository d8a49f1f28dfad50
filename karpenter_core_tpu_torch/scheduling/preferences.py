"""Soft-constraint relaxation in fixed order (preferences.go:36-145).

Order: required node-affinity term (OR semantics: drop the head term) ->
preferred pod affinity -> preferred pod anti-affinity -> preferred node
affinity (heaviest first) -> ScheduleAnyway topology spreads ->
(optionally) tolerate PreferNoSchedule taints.
"""
from __future__ import annotations

from typing import Optional

from karpenter_core_tpu_torch.kube.objects import Toleration


class Preferences:
    def __init__(self, tolerate_prefer_no_schedule: bool = False):
        self.tolerate_prefer_no_schedule = tolerate_prefer_no_schedule

    def relax(self, pod) -> bool:
        relaxations = [
            self._remove_required_node_affinity_term,
            self._remove_preferred_pod_affinity_term,
            self._remove_preferred_pod_anti_affinity_term,
            self._remove_preferred_node_affinity_term,
            self._remove_topology_spread_schedule_anyway,
        ]
        if self.tolerate_prefer_no_schedule:
            relaxations.append(self._tolerate_prefer_no_schedule_taints)
        for relax_fn in relaxations:
            if relax_fn(pod) is not None:
                return True
        return False

    def is_relaxable(self, pod) -> bool:
        """True when relax(pod) would still change something: the pod
        carries a soft constraint the fixed order can drop. Mutates
        nothing; the consolidation search reads it to tell whether a
        negative round-0 screen is conclusive."""
        affinity = pod.spec.affinity
        if affinity is not None:
            node_aff = affinity.node_affinity
            if node_aff is not None and (len(node_aff.required) > 1 or node_aff.preferred):
                return True
            if affinity.pod_affinity is not None and affinity.pod_affinity.preferred:
                return True
            if (affinity.pod_anti_affinity is not None
                    and affinity.pod_anti_affinity.preferred):
                return True
        return any(
            tsc.when_unsatisfiable == "ScheduleAnyway"
            for tsc in pod.spec.topology_spread_constraints
        )

    def _remove_required_node_affinity_term(self, pod) -> Optional[str]:
        """Required terms are ORed; drop the head term only while >1 remain
        (preferences.go:73-86)."""
        affinity = pod.spec.affinity
        if (affinity is None or affinity.node_affinity is None
                or len(affinity.node_affinity.required) <= 1):
            return None
        dropped = affinity.node_affinity.required[0]
        affinity.node_affinity.required = affinity.node_affinity.required[1:]
        return f"removed required node affinity term {dropped}"

    def _remove_preferred_pod_affinity_term(self, pod) -> Optional[str]:
        affinity = pod.spec.affinity
        if (affinity is None or affinity.pod_affinity is None
                or not affinity.pod_affinity.preferred):
            return None
        terms = sorted(affinity.pod_affinity.preferred, key=lambda t: -t.weight)
        affinity.pod_affinity.preferred = terms[1:]
        return f"removed preferred pod affinity term {terms[0]}"

    def _remove_preferred_pod_anti_affinity_term(self, pod) -> Optional[str]:
        affinity = pod.spec.affinity
        if (affinity is None or affinity.pod_anti_affinity is None
                or not affinity.pod_anti_affinity.preferred):
            return None
        terms = sorted(affinity.pod_anti_affinity.preferred, key=lambda t: -t.weight)
        affinity.pod_anti_affinity.preferred = terms[1:]
        return f"removed preferred pod anti-affinity term {terms[0]}"

    def _remove_preferred_node_affinity_term(self, pod) -> Optional[str]:
        affinity = pod.spec.affinity
        if (affinity is None or affinity.node_affinity is None
                or not affinity.node_affinity.preferred):
            return None
        terms = sorted(affinity.node_affinity.preferred, key=lambda t: -t.weight)
        affinity.node_affinity.preferred = terms[1:]
        return f"removed preferred node affinity term {terms[0]}"

    def _remove_topology_spread_schedule_anyway(self, pod) -> Optional[str]:
        for i, tsc in enumerate(pod.spec.topology_spread_constraints):
            if tsc.when_unsatisfiable == "ScheduleAnyway":
                pod.spec.topology_spread_constraints.pop(i)
                return f"removed ScheduleAnyway topology spread {tsc}"
        return None

    def _tolerate_prefer_no_schedule_taints(self, pod) -> Optional[str]:
        """preferences.go:131-145."""
        for t in pod.spec.tolerations:
            if t.operator == "Exists" and t.effect == "PreferNoSchedule" and t.key == "":
                return None
        pod.spec.tolerations.append(
            Toleration(operator="Exists", effect="PreferNoSchedule")
        )
        return "added toleration for PreferNoSchedule taints"
