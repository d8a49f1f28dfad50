"""Preferences live in the neutral scheduling layer (scheduling/
preferences.py), where the device solver's relaxation loop reads them;
re-exported here under the scheduler's module path."""
from karpenter_core_tpu_torch.scheduling.preferences import Preferences  # noqa: F401
