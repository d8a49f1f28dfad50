"""The port's solver service (solver/service.py, solver/codec.py) against
the reference's, on the CPU.

- the wire helpers on seeded device_args of the shared workload families:
  the same geometry_json, tensor names, dtypes, shapes and bytes, and the
  same request bytes;
- the codec against service_pb2 (the port's copy and the reference's):
  equal bytes and each parsing the other's, for every message, empty
  fields, negative shape entries, unknown fields and multi-MiB tensors;
- SolverService(device="cpu") against the reference's SolverService on
  JAX's CPU: the same response tensors (the log, ptr and every state field)
  for the same request bytes, then a refresh against the same; the Replan
  RPC likewise;
- RemoteSolver over localhost gRPC both ways across the packages, against
  each package's in-process solver: placements byte-identical;
- a message over gRPC's default 4 MiB limit reaches the port's server from
  either client, and the reference's server refuses it;
- the typed errors, retry-after parsing and the refusals (no card, the
  mesh).
"""
import json

import numpy as np
import pytest
import torch

from karpenter_core_tpu.obs.flightrec import canonical_placements, placements_json
from karpenter_core_tpu.solver import encode as jencode
from karpenter_core_tpu.solver import service as jservice
from karpenter_core_tpu.solver import service_pb2 as jpb2
from karpenter_core_tpu.solver import tpu_solver as jsolver
from karpenter_core_tpu_torch.solver import codec
from karpenter_core_tpu_torch.solver import encode as tencode
from karpenter_core_tpu_torch.solver import service as tservice
from karpenter_core_tpu_torch.solver import service_pb2 as tpb2
from karpenter_core_tpu_torch.solver import torch_solver as tsolver

from tests.test_torch_cuda import _mods, workload

WIRE_FAMILIES = ("mixed", "spread", "cluster")


def _snapshots(family):
    jp, jprov, jits, jds, jnodes, max_nodes, jkc, jcl = workload(family, "jax")
    tp, tprov, tits, tds, tnodes, _, tkc, tcl = workload(family, "torch")
    js = jencode.encode_snapshot(jp, jprov, jits, jds, jnodes, kube_client=jkc, cluster=jcl,
                                 max_nodes=max_nodes)
    ts = tencode.encode_snapshot(tp, tprov, tits, tds, tnodes, tkc, tcl, max_nodes=max_nodes)
    return (js, jprov), (ts, tprov), max_nodes


@pytest.mark.parametrize("family", WIRE_FAMILIES)
def test_wire_request_matches_reference(family):
    (js, jprov), (ts, tprov), _ = _snapshots(family)
    assert tservice.geometry_json(ts) == jservice.geometry_json(js)
    want = jservice._flatten_args(jsolver.device_args(js, jprov))
    got = tservice._flatten_args(tsolver.device_args(ts, tprov))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert (str(a.dtype), a.shape) == (str(b.dtype), b.shape), name
        assert a.tobytes() == b.tobytes(), name
    assert tsolver.RUN_ARG_NAMES == jsolver.RUN_ARG_NAMES
    got_req = tservice.solve_request(ts, tprov).SerializeToString()
    want_req = jpb2.SolveRequest(
        geometry=jservice.geometry_json(js),
        tensors=[jservice.tensor_to_pb(n, a) for n, a in want]).SerializeToString()
    assert got_req == want_req
    # the replan request too (the reference's client builds it inline)
    E = ts.exist_used.shape[0]
    count_rows = np.zeros((3, ts.item_pad), np.int32)
    count_rows[:, 0] = (1, 2, 3)
    exist_open = np.ones((3, E), bool)
    got_rep = tservice.replan_request(ts, tprov, count_rows, exist_open,
                                      uninitialized=[True], want_slots=True)
    names = [t.name for t in got_rep.tensors[-4:]]
    assert names == ["replan/count_rows", "replan/exist_open", "replan/uninitialized",
                     "replan/want_slots"]
    uninit = tservice.tensor_from_pb(got_rep.tensors[-2])
    assert uninit.shape == (E,) and uninit[0] and not uninit[1:].any()


def _messages(pbm, big: bytes):
    """One of each message, with its fields set, empty, and large."""
    tensors = [pbm.Tensor(name="pod_arrays/allow", dtype="bool", shape=[2, 3], data=b"\x01" * 6),
               pbm.Tensor(name="neg", dtype="int64", shape=[-1, 0, 7], data=b""),
               pbm.Tensor()]
    return [
        *tensors,
        pbm.Tensor(name="big", dtype="uint8", shape=[len(big)], data=big),
        pbm.SolveRequest(geometry=json.dumps({"n_slots": 3, "é": "ü"}), tensors=tensors),
        pbm.SolveRequest(),
        pbm.SolveRequest(geometry="", tensors=[pbm.Tensor(name="big", data=big)]),
        pbm.SolveResponse(tensors=tensors, error=""),
        pbm.SolveResponse(error="INTERNAL: boom"),
        pbm.SolveResponse(),
        pbm.HealthRequest(),
        pbm.HealthResponse(status="ok", device="NVIDIA H100 80GB HBM3", solves=12),
        pbm.HealthResponse(status="wedged", solves=-3),
        pbm.HealthResponse(),
    ]


@pytest.mark.parametrize("pb2", [tpb2, jpb2], ids=["port-copy", "reference"])
def test_codec_matches_service_pb2_byte_for_byte(pb2):
    big = np.random.default_rng(7).integers(0, 256, size=5 << 20, dtype=np.uint8).tobytes()
    for mine, theirs in zip(_messages(codec, big), _messages(pb2, big)):
        kind = type(mine).__name__
        data = theirs.SerializeToString()
        assert mine.SerializeToString() == data, kind
        # each parses the other's bytes to the same message
        assert getattr(codec, kind).FromString(data) == mine, kind
        back = getattr(pb2, kind).FromString(mine.SerializeToString())
        assert back.SerializeToString() == data, kind


def test_codec_skips_unknown_fields_and_reads_unpacked_shapes():
    t = codec.Tensor(name="x", dtype="int32", shape=[2, 5], data=b"abcd")
    # field 9 (a varint), field 10 (bytes), then an unpacked shape entry
    extra = b"\x48\x05" + b"\x52\x02hi" + b"\x18\x03"
    parsed = codec.Tensor.FromString(t.SerializeToString() + extra)
    assert parsed.shape == [2, 5, 3] and parsed.data == b"abcd" and parsed.name == "x"
    with pytest.raises(ValueError):
        codec.SolveRequest.FromString(b"\x12\x10short")


def _response_tensors(response):
    return {t.name: tservice.tensor_from_pb(t) for t in response.tensors}


def _assert_same_tensors(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        a, b = got[name], np.asarray(want[name])
        assert (a.dtype, a.shape) == (b.dtype, b.shape), name
        assert a.tobytes() == b.tobytes(), name


@pytest.fixture(scope="module")
def services():
    return tservice.SolverService(device="cpu"), jservice.SolverService()


@pytest.mark.parametrize("family", ("mixed", "spread"))
def test_service_responses_match_reference(services, family):
    tsvc, jsvc = services
    (js, jprov), (ts, tprov), _ = _snapshots(family)
    request = tservice.solve_request(ts, tprov)
    body = request.SerializeToString()
    got = tsvc.solve(codec.SolveRequest.FromString(body))
    want = jsvc.solve(jpb2.SolveRequest.FromString(body))
    assert not got.error and not want.error, (got.error, want.error)
    got_t, want_t = _response_tensors(got), _response_tensors(want)
    _assert_same_tensors(got_t, want_t)
    assert any(k.startswith("state/") for k in got_t) and "log/bulk_take" in got_t
    # decoded, the two responses place every pod alike
    got_res = tservice.decode_response(ts, got)
    want_res = jsolver.decode_solve(
        js, ({k[4:]: v for k, v in want_t.items() if k.startswith("log/")},
             int(want_t["ptr"].reshape(-1)[0])),
        jservice._StateView({k[6:]: v for k, v in want_t.items() if k.startswith("state/")}))
    assert placements_json(canonical_placements(got_res)) == placements_json(
        canonical_placements(want_res))
    # the same request again: the port refreshes its resident tensor, the
    # reference its own; both answer alike
    again = _response_tensors(tsvc.solve(codec.SolveRequest.FromString(body)))
    _assert_same_tensors(again, want_t)
    assert tsvc.last_prescreen_mode == "refresh"


def test_services_pack_sequentially_under_segmented_scan(services, monkeypatch):
    """KCT_PACK_SCAN=segmented: both packages' services serve a solve with
    the sequential scan (the reference's never reads the scan mode), the
    same response tensors, and placements byte-identical to the port's
    in-process sequential solve, on a workload the segmented scan would
    split."""
    from tests.test_torch_segmented import MAX_NODES, pool_workload

    monkeypatch.setenv("KCT_PACK_SCAN", "segmented")
    tsvc, jsvc = services
    m = _mods("torch")
    pods, provs, its, nodes = pool_workload(m, 7)
    ts = tencode.encode_snapshot(pods, provs, its, max_nodes=MAX_NODES)
    body = tservice.solve_request(ts, provs).SerializeToString()
    got = tsvc.solve(codec.SolveRequest.FromString(body))
    want = jsvc.solve(jpb2.SolveRequest.FromString(body))
    assert not got.error and not want.error, (got.error, want.error)
    _assert_same_tensors(_response_tensors(got), _response_tensors(want))
    assert "segment" not in tsvc.last_phase_ms
    seq = tsolver.TorchSolver(max_nodes=MAX_NODES, device="cpu", pack_scan="sequential")
    assert tsolver.placements_json(tservice.decode_response(ts, got)) == (
        tsolver.placements_json(seq.solve(pods, provs, its)))
    seg = tsolver.TorchSolver(max_nodes=MAX_NODES, device="cpu")
    seg.solve(pods, provs, its)
    assert seg.last_segment_stats["mode"] == "segmented"


def test_service_replan_matches_reference_and_in_process(services):
    tsvc, jsvc = services
    (js, jprov), (ts, tprov), max_nodes = _snapshots("cluster")
    E = ts.exist_used.shape[0]
    rng = np.random.default_rng(11)
    count_rows = np.zeros((3, ts.item_pad), np.int32)
    count_rows[:, : len(ts.item_counts)] = rng.integers(0, 2, size=(3, len(ts.item_counts)))
    exist_open = np.ones((3, E), bool)
    exist_open[1, 0] = False
    body = tservice.replan_request(ts, tprov, count_rows, exist_open,
                                   want_slots=True).SerializeToString()
    got = _response_tensors(tsvc.replan(codec.SolveRequest.FromString(body)))
    want = _response_tensors(jsvc.replan(jpb2.SolveRequest.FromString(body)))
    _assert_same_tensors(got, want)
    local_v, local_p = tsolver.TorchSolver(max_nodes=max_nodes, device="cpu").replan_screen(
        ts, tprov, count_rows, exist_open, want_slots=True)
    np.testing.assert_array_equal(got["verdicts"], local_v)
    np.testing.assert_array_equal(got["pods"], local_p)
    assert tsvc.replans == 1


def test_service_health_and_refusals(services):
    tsvc, _ = services
    health = tsvc.health(codec.HealthRequest())
    assert (health.status, health.device) == ("ok", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tservice.SolverService()
    # mesh=True detects a grid: one CPU device has none, so the service
    # serves the single device, as the reference's does
    assert tservice.SolverService(device="cpu", mesh=True).mesh is None


def test_service_entries_are_lru_bounded_and_retired(monkeypatch):
    from karpenter_core_tpu_torch.obs import proghealth

    proghealth.reset(enabled=True)
    try:
        svc = tservice.SolverService(device="cpu")
        monkeypatch.setattr(svc, "MAX_COMPILED", 2)
        geoms = [json.dumps({"segments": [[0, 2]], "zone_seg": [0, 1], "ct_seg": [1, 2],
                             "n_slots": n, "screen_v": 2, "log_len": 128,
                             "topo_groups": None}) for n in (8, 16, 32)]
        for g in geoms:
            svc._entry(g, "prescreen")
        assert [k[0] for k in svc._compiled] == geoms[1:]
        totals = proghealth.LEDGER.snapshot()["totals"]["solve"]
        assert (totals["minted"], totals["retired"]) == (3, 1)
    finally:
        proghealth.reset()


def test_typed_errors_and_retry_after():
    err = tservice.error_from_string("RESOURCE_EXHAUSTED: queue full; retry_after_ms=250")
    assert isinstance(err, tservice.SolverResourceExhaustedError)
    assert err.retry_after_s == 0.25 and err.marks_unhealthy is False
    assert isinstance(tservice.error_from_string("nonsense"), tservice.SolverInternalError)
    for exc, code in ((ValueError("x"), "INVALID_ARGUMENT"), (MemoryError(), "RESOURCE_EXHAUSTED"),
                      (RuntimeError("launch failed"), "INTERNAL")):
        assert tservice.classify_exception(exc)[0] == code
        assert jservice.classify_exception(exc)[0] == code


# -- gRPC, both ways across the packages ------------------------------------------


@pytest.fixture(scope="module")
def servers():
    tserver, tport, tsvc = tservice.serve(device="cpu")
    jserver, jport, jsvc = jservice.serve()
    yield (tport, tsvc), (jport, jsvc)
    tserver.stop(0)
    jserver.stop(0)


def test_port_client_against_reference_server(servers):
    _, (jport, jsvc) = servers
    tp, tprov, tits, tds, tnodes, max_nodes, tkc, tcl = workload("mixed", "torch")
    client = tservice.RemoteSolver(f"127.0.0.1:{jport}", max_nodes=max_nodes)
    try:
        assert client.health().status == "ok"
        got = client.solve(tp, tprov, tits, daemonset_pods=tds, state_nodes=tnodes)
        want = tsolver.TorchSolver(max_nodes=max_nodes, device="cpu").solve(
            tp, tprov, tits, daemonset_pods=tds, state_nodes=tnodes)
        assert tsolver.placements_json(got) == tsolver.placements_json(want)
        assert client.last_request_bytes > 0 and client.last_response_bytes > 0
    finally:
        client.close()


def test_reference_client_against_port_server(servers):
    (tport, tsvc), _ = servers
    jp, jprov, jits, jds, jnodes, max_nodes, jkc, jcl = workload("mixed", "jax")
    client = jservice.RemoteSolver(f"127.0.0.1:{tport}", max_nodes=max_nodes)
    assert client.health().device == "cpu"
    got = client.solve(jp, jprov, jits, daemonset_pods=jds, state_nodes=jnodes)
    want = jsolver.TPUSolver(max_nodes=max_nodes, backend="mxu", incremental="off").solve(
        jp, jprov, jits, daemonset_pods=jds, state_nodes=jnodes)
    assert placements_json(canonical_placements(got)) == placements_json(
        canonical_placements(want))
    assert tsvc.solves >= 1


def test_remote_replan_matches_in_process(servers):
    (tport, _), _ = servers
    (_, _), (ts, tprov), max_nodes = _snapshots("mixed")
    E = ts.exist_used.shape[0]
    count_rows = np.zeros((2, ts.item_pad), np.int32)
    count_rows[:, 0] = (1, 2)
    exist_open = np.ones((2, E), bool)
    client = tservice.RemoteSolver(f"127.0.0.1:{tport}", max_nodes=max_nodes)
    try:
        got_v, got_p = client.replan_screen(ts, tprov, count_rows, exist_open, want_slots=True)
    finally:
        client.close()
    want_v, want_p = tsolver.TorchSolver(max_nodes=max_nodes, device="cpu").replan_screen(
        ts, tprov, count_rows, exist_open, want_slots=True)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_p, want_p)


def _big_request() -> bytes:
    return codec.SolveRequest(geometry="{}", tensors=[codec.Tensor(
        name="pad", dtype="uint8", shape=[6 << 20], data=b"\0" * (6 << 20))]).SerializeToString()


@pytest.mark.parametrize("side", ["port", "reference"])
def test_messages_over_four_mib_reach_the_port_server(servers, side):
    """A request past gRPC's 4 MiB default reaches the port's server, from
    either package's client (gRPC limits what a side receives, and the
    port's server takes up to MAX_MESSAGE_BYTES): it answers it as a
    malformed solve, INVALID_ARGUMENT, not RESOURCE_EXHAUSTED."""
    (tport, _), _ = servers
    if side == "port":
        client = tservice.RemoteSolver(f"127.0.0.1:{tport}", rpc_retries=0)
        try:
            with pytest.raises(tservice.SolverInvalidArgumentError):
                client._invoke_solve(_big_request(), None)
        finally:
            client.close()
    else:
        client = jservice.RemoteSolver(f"127.0.0.1:{tport}", rpc_retries=0)
        with pytest.raises(jservice.SolverInvalidArgumentError):
            client._invoke_solve(jpb2.SolveRequest.FromString(_big_request()), None)


def test_reference_server_refuses_over_four_mib(servers):
    """The reference's serve() sets no message options, so its server
    refuses a request past 4 MiB at the transport (ROADMAP Queue C)."""
    _, (jport, _) = servers
    client = tservice.RemoteSolver(f"127.0.0.1:{jport}", rpc_retries=0)
    try:
        with pytest.raises(tservice.SolverResourceExhaustedError):
            client._invoke_solve(_big_request(), None)
    finally:
        client.close()
