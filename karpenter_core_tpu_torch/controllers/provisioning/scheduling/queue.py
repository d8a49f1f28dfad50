"""The host scheduler's FFD pod queue with progress detection
(queue.go:26-110)."""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

from karpenter_core_tpu_torch.utils import resources


def ffd_sort_key(pod) -> Tuple:
    """CPU descending, then memory descending, then creation time, then UID
    (queue.go:74-110)."""
    requests = resources.requests_for_pods(pod)
    return (
        -requests.get("cpu", 0.0),
        -requests.get("memory", 0.0),
        pod.metadata.creation_timestamp,
        pod.metadata.uid,
    )


class Queue:
    def __init__(self, pods: List):
        self.pods: deque = deque(sorted(pods, key=ffd_sort_key))
        self.last_len: Dict[str, int] = {}

    def pop(self) -> Optional[object]:
        """None when empty, or when the head pod comes back with the queue's
        length unchanged: no progress is being made (queue.go:39-50)."""
        if not self.pods:
            return None
        pod = self.pods[0]
        if self.last_len.get(pod.metadata.uid) == len(self.pods):
            return None
        return self.pods.popleft()

    def push(self, pod, relaxed: bool) -> None:
        """Re-queue a failed pod; a relaxation resets the progress tracking
        (queue.go:53-60)."""
        self.pods.append(pod)
        if relaxed:
            self.last_len = {}
        else:
            self.last_len[pod.metadata.uid] = len(self.pods)

    def list(self) -> List:
        return list(self.pods)
