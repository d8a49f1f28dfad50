"""The non-segmented cases of the reference's wide differential fuzz
(tests/test_differential_fuzz_wide.py), run on the port: G1, G2 and the
screen kernel's fuzz here, G3-G5 in tests/test_torch_fuzz_wide_g3_g5_suites.py,
so that `--dist loadfile` spreads them over two workers.

Each case runs from the suite's own source, executed under an `__import__`
that maps every import of the reference package to the port's module of
the same path (tests/torch_suites.py), and must pass: the device solve
holds every constraint and is no worse than the host GreedySolver oracle,
as the reference's bar is. The reference's own run of each case is its own
file's.

The seed budget: each geometry takes the prefix of its seeds that SEEDS
names (at least the first 3). Every seed of the suite (N_SEEDS, 13 a
geometry) fits: on one CPU worker the G2-G5 cases took
0.1-0.4 s each, and each file runs in under 20 s.

Where the port's counterpart has another name or needs the CPU:
- `TPUSolver(max_nodes, backend)` is `TorchSolver(max_nodes,
  device="cpu")`; `GreedySolver` is the port's;
- `test_fuzz_pallas_slot_screen` holds the port's screen kernel in its
  B = 1 form (`screen_row`, the reference's `slot_screen_pallas`; its
  plain version on the CPU) against the port's `compat.rows_compat_m` on
  the suite's random masks: `karpenter_core_tpu.ops.pallas_kernels` maps
  to `ops/screen.py`, whose `slot_screen_pallas` here is that form, and
  both take the suite's `jnp` arrays as tensors.

Left out (LEFT_OUT): `test_fuzz_g{1..5}_mxu_lowering`, which re-solve
through the reference's TPU (`backend="mxu"`) lowering, as
tests/test_mxu_branch.py is; and the segmented cases, which
tests/test_torch_segmented_suites.py runs.
"""
import types

import numpy as np
import pytest
import torch

# each package's fake provider registers its well-known labels on import
from karpenter_core_tpu.cloudprovider import fake as _ref_fake  # noqa: F401
from karpenter_core_tpu_torch.cloudprovider import fake as _port_fake  # noqa: F401
from karpenter_core_tpu_torch.ops import compat as tcompat
from karpenter_core_tpu_torch.ops import screen as tscreen

import tests.test_differential_fuzz_wide as fuzz_wide
from tests.torch_suites import PORT, REF, Mapping, cases, cpu_substitutes, reference_names

# the seeds each geometry's case takes: a prefix of the suite's
SEEDS = {g: fuzz_wide.N_SEEDS for g in ("g1", "g2", "g3", "g4", "g5")}
LEFT_OUT = {
    **{f"test_fuzz_g{g}_mxu_lowering": "the reference's TPU lowering "
       "(backend='mxu'), as tests/test_mxu_branch.py" for g in range(1, 6)},
    "test_fuzz_g3_sequential_vs_segmented": "segmented: tests/test_torch_segmented_suites.py",
    "test_fuzz_g4_sequential_vs_segmented": "segmented: tests/test_torch_segmented_suites.py",
}


def _t(a):
    return torch.as_tensor(np.array(a))


def slot_screen_pallas(slot_allow, slot_out, slot_defined, pod, seg_mat, interpret=True):
    """The port's screen in its B = 1 form (ops/screen.screen_row) with the
    reference's signature: N slot rows against one pod row, the segments
    read off the [V, K] segment matrix."""
    sm = np.asarray(seg_mat)
    segments = [(int(np.flatnonzero(sm[:, k])[0]), int(np.flatnonzero(sm[:, k])[-1]) + 1)
                for k in range(sm.shape[1])]
    layout = tscreen.ScreenLayout(segments, sm.shape[0], every_key=True)
    items = tscreen.ScreenItems({k: _t(v)[None] for k, v in pod.items()}, layout)
    return tscreen.screen_row(_t(slot_allow), _t(slot_out), _t(slot_defined), items, 0,
                              layout)


def _compat_of_arrays() -> types.ModuleType:
    """ops/compat whose rows_compat_m takes the suite's arrays."""
    mod = types.ModuleType(tcompat.__name__)
    mod.__dict__.update(vars(tcompat))

    def rows_compat_m(node, pod_row, seg_mat, custom_deny=None):
        return tcompat.rows_compat_m(
            {k: _t(v) for k, v in node.items()}, {k: _t(v) for k, v in pod_row.items()},
            _t(seg_mat), custom_deny=None if custom_deny is None else _t(custom_deny))

    mod.rows_compat_m = rows_compat_m
    return mod


MAPPING = Mapping(
    {**cpu_substitutes(),
     (f"{PORT}.ops", "compat"): _compat_of_arrays(),
     (f"{PORT}.ops.screen", "slot_screen_pallas"): slot_screen_pallas},
    renames={f"{REF}.ops.pallas_kernels": f"{PORT}.ops.screen"},
    mapped_suites={"tests.test_differential_fuzz", "tests.test_differential_fuzz_wide"})


def geometry_cases(*names: str) -> list:
    """(case, params, id) of the suite's cases of the named geometries
    ("g1".."g5", "pallas"), each geometry's seeds cut to SEEDS."""
    out = []
    for _suite, case, params, cid, _slow in cases("fuzz_wide", fuzz_wide, left_out=LEFT_OUT):
        geometry = "pallas" if "pallas" in case else case.split("_")[2]
        if geometry not in names:
            continue
        seeds = sorted(p["seed"] for _s, c, p, _i, _sl in cases(
            "fuzz_wide", fuzz_wide, selected=(case,)))
        if geometry != "pallas" and params["seed"] not in seeds[:SEEDS[geometry]]:
            continue
        out.append((case, params, cid))
    return out


def run_case(case: str, params: dict) -> None:
    from tests.torch_suites import Case

    Case(vars(MAPPING.suite_module(fuzz_wide.__name__))).run(case, params, reraise=True)


CASES = geometry_cases("g1", "g2", "pallas")


@pytest.mark.parametrize("case,params", [c[:2] for c in CASES], ids=[c[2] for c in CASES])
def test_case_passes_on_the_port(case, params):
    run_case(case, params)


def test_cases_cover_the_suite():
    """Every case of the suite is run by one of the files or left out with
    its reason; each geometry takes at least its first 3 seeds."""
    every = {c[1] for c in cases("fuzz_wide", fuzz_wide)}
    run = {c[0] for c in geometry_cases("g1", "g2", "g3", "g4", "g5", "pallas")}
    assert every == run | set(LEFT_OUT)
    assert not run & set(LEFT_OUT)
    assert all(n >= 3 for n in SEEDS.values())
    assert len(CASES) == SEEDS["g1"] + SEEDS["g2"] + 10


def test_port_run_reaches_no_reference_object():
    assert reference_names(vars(MAPPING.suite_module(fuzz_wide.__name__)),
                           skip=("validate_machines",)) == []
