"""The multi-device solve: a grid of devices in one process (specs.py) and
the solver over it (sharded.py)."""
