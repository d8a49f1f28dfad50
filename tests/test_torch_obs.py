"""The port's observability modules against the JAX reference's, on the
CPU: the metrics registry (exposition, snapshots, the cross-process
merger), the tracer (nesting, retroactive spans, the Chrome trace, the
metrics bridge), the structured log (gating, bound context, trace-id
correlation, logfmt and JSON records), the request context, the disabled
paths, and the span tree of one provisioning reconcile.

Each parity case is one script run against both packages' modules; the
two results must be equal (timestamps, pids and thread ids masked where a
case renders them)."""
import io
import re
import threading
import time
from types import SimpleNamespace

import pytest

from karpenter_core_tpu.metrics import registry as jreg
from karpenter_core_tpu.obs import log as jlog
from karpenter_core_tpu.obs import reqctx as jreqctx
from karpenter_core_tpu.obs import tracer as jtracer
from karpenter_core_tpu_torch.metrics import registry as treg
from karpenter_core_tpu_torch.obs import log as tlog
from karpenter_core_tpu_torch.obs import reqctx as treqctx
from karpenter_core_tpu_torch.obs import tracer as ttracer

PKGS = {
    "jax": SimpleNamespace(registry=jreg, tracer=jtracer, log=jlog, reqctx=jreqctx),
    "torch": SimpleNamespace(registry=treg, tracer=ttracer, log=tlog, reqctx=treqctx),
}


def both(script):
    """script(m) for each package; the reference's and the port's results."""
    return script(PKGS["jax"]), script(PKGS["torch"])


# -- the metrics registry ------------------------------------------------------


def _golden(m):
    r = m.registry.Registry()
    c = r.counter("t_requests", "Total requests")
    c.inc({"code": "200"})
    c.inc({"code": '5"00\n'}, 2)
    g = r.gauge("t_temp", "Temp\nnow")
    g.set(3.5, {"room": "a"})
    h = r.histogram("t_lat", "Latency", buckets=[0.1, 1])
    h.observe(0.05)
    h.observe(0.5, {"p": "x"})
    h.observe(5, {"p": "x"})
    return r.expose()


def _escaping(m):
    r = m.registry.Registry()
    r.gauge("t_path").set(1.0, {"dir": "C:\\tmp"})
    r.counter("t_nothing", "never incremented")
    r.counter("t_big").inc(value=2.0 ** 60)
    r.counter("t_frac").inc(value=0.1 + 0.2)
    return r.expose()


def _cumulative(m):
    r = m.registry.Registry()
    h = r.histogram("t_d", "", buckets=[1, 2, 4])
    for v in (0.5, 1.5, 3, 100):
        h.observe(v, {"op": "solve"})
    return r.expose(), h.series(), h.snapshot({"op": "solve"})


def _type_mismatch(m):
    r = m.registry.Registry()
    r.counter("t_x")
    errors = []
    for make in (r.gauge, r.histogram):
        try:
            make("t_x")
        except TypeError as e:
            errors.append(str(e))
    return errors, r.counter("t_x") is r.counter("t_x")


def _gauges(m):
    g = m.registry.Gauge("t_g")
    out = [g.get()]
    g.set(2.0)
    g.set(3.0, {"a": "b"})
    out.append((g.get(), g.get({"a": "b"})))
    g.delete({"a": "b"})
    out.append(g.get({"a": "b"}))
    g.replace_all([(1.0, {"k": "1"}), (2.0, {"k": "2"})])
    out.append(sorted(g.values.items()))
    g.clear()
    out.append(dict(g.values))
    return out


def _percentiles(m):
    h = m.registry.Histogram("t_h", buckets=[0.1, 1, 10])
    out = [h.percentile(0.99)]
    for _ in range(3):
        h.observe(0.05)
    base = h.snapshot()
    merged_base = h.merged_snapshot()
    h.observe(5)
    h.observe(5, {"tenant": "a"})
    h.observe(50)
    out += [h.percentile(0.5), h.percentile(0.5, baseline=base), h.count_since(base),
            h.count_since(), h.percentile(1.0), h.percentile(0.5, {"tenant": "a"}),
            h.merged_snapshot(), h.merged_percentile(0.5, baseline=merged_base)]
    return out


def _exemplars(m):
    r = m.registry.Registry()
    h = r.histogram("t_lat", "Latency", buckets=[0.1, 1])
    h.observe(0.05)
    h.observe(0.5, exemplar={"trace_id": "t0000002a"})
    h.observe(7.0, exemplar={"trace_id": "t0000002b"})
    return r.expose(), r.expose(exemplars=True)


def _externals(m):
    class Source:
        def __init__(self, fams, fail=False):
            self.fams, self.fail = fams, fail

        def families(self):
            if self.fail:
                raise RuntimeError("sick")
            return self.fams

    r = m.registry.Registry()
    r.counter("t_solves", "Solves").inc({"k": "local"})
    good = Source({
        "t_solves": {"kind": "counter", "help": "Solves",
                     "series": [[{"k": "child", "process": "host"}, 3.0]]},
        "t_only_ext": {"kind": "histogram", "help": "Ext", "buckets": [1.0, 2.0],
                       "series": [[{"process": "host"},
                                   {"buckets": [1, 2], "sum": 2.5, "count": 3}]]},
    })
    r.add_external(good)
    r.add_external(Source({}, fail=True))
    text = r.expose()
    r.remove_external(good)
    return text, r.expose()


def _merger(m):
    """A child's cumulative snapshots folded per generation: re-ingesting
    a snapshot is a no-op, a respawn (generation 2, a fresh registry)
    counts on top, a retire folds once."""
    reg = m.registry

    def child_run(n):
        child = reg.Registry()
        c = child.counter("karpenter_t_solves", "Solves")
        h = child.histogram("karpenter_t_phase", "Phase", buckets=[1, 2])
        for _ in range(n):
            c.inc({"k": "v"})
            h.observe(1.5, {"phase": "device"})
        return reg.snapshot_families(child)

    merger = reg.ProcessSeriesMerger("host")
    first = child_run(3)
    merger.ingest(1, first)
    merger.ingest(1, first)
    merger.ingest(2, child_run(2))
    merger.retire(2)
    merger.retire(2)
    parent = reg.Registry()
    parent.add_external(merger)
    big = reg.Registry()
    for i in range(6):
        big.counter(f"karpenter_t_c{i}").inc({"i": str(i)})
    out = [first, merger.families(), parent.expose(),
           reg.snapshot_families(big, max_series=3)]
    merger.clear()
    return out + [merger.families()]


def _module_series(m):
    reg = m.registry
    return [(x.name, x.help) for x in (reg.NODES_CREATED, reg.NODES_TERMINATED,
                                       reg.MACHINES_CREATED, reg.MACHINES_TERMINATED)]


def _concurrent(m):
    c = m.registry.Counter("t_c")

    def work():
        for _ in range(500):
            c.inc({"k": "v"})
            c.get({"k": "v"})

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return c.get({"k": "v"})


REGISTRY_CASES = {f.__name__.strip("_"): f for f in (
    _golden, _escaping, _cumulative, _type_mismatch, _gauges, _percentiles, _exemplars,
    _externals, _merger, _module_series, _concurrent)}


@pytest.mark.parametrize("case", sorted(REGISTRY_CASES))
def test_registry_matches_reference(case):
    """The same counter, gauge and histogram operations on both registries:
    byte-equal expose(), equal snapshots, families and merged views."""
    ref, port = both(REGISTRY_CASES[case])
    assert port == ref


def test_exposition_golden_text():
    """The port's exposition, line for line (the reference's golden)."""
    assert _golden(PKGS["torch"]) == "\n".join([
        '# HELP t_lat Latency',
        '# TYPE t_lat histogram',
        't_lat_bucket{le="0.1"} 1',
        't_lat_bucket{le="1"} 1',
        't_lat_bucket{le="+Inf"} 1',
        't_lat_sum 0.05',
        't_lat_count 1',
        't_lat_bucket{p="x",le="0.1"} 0',
        't_lat_bucket{p="x",le="1"} 1',
        't_lat_bucket{p="x",le="+Inf"} 2',
        't_lat_sum{p="x"} 5.5',
        't_lat_count{p="x"} 2',
        '# HELP t_requests Total requests',
        '# TYPE t_requests counter',
        't_requests{code="200"} 1',
        't_requests{code="5\\"00\\n"} 2',
        '# HELP t_temp Temp\\nnow',
        '# TYPE t_temp gauge',
        't_temp{room="a"} 3.5',
    ])


def test_counter_and_histogram_clear():
    """The port's clear(): one series or all, exposition restarting at 0."""
    r = treg.Registry()
    c = r.counter("t_c")
    c.inc({"a": "1"}, 2)
    c.inc({"a": "2"})
    c.clear({"a": "1"})
    assert c.series() == [({"a": "2"}, 1.0)]
    c.clear()
    assert c.series() == [] and c.get({"a": "2"}) == 0.0
    h = r.histogram("t_h", buckets=[1])
    h.observe(0.5, exemplar={"trace_id": "t1"})
    h.clear()
    assert h.series() == []
    assert r.expose() == "# TYPE t_c counter\n# TYPE t_h histogram"
    assert h.count_since() == 0


# -- the tracer -------------------------------------------------------------------


def _mask_trace(trace):
    """chrome_trace() with timestamps, durations, pids and thread ids
    masked: what is left is names, nesting and attributes."""
    events = []
    for e in trace["traceEvents"]:
        e = {k: v for k, v in e.items() if k not in ("ts", "dur", "pid", "tid")}
        if e["ph"] == "M":
            e["args"] = {"name": re.sub(r"\d+", "N", e["args"]["name"])}
        events.append(e)
    return events, trace["displayTimeUnit"], trace["otherData"]["dropped_spans"]


def _fresh(m, capacity=1024):
    return m.tracer.Tracer(capacity=capacity).enable()


def _nesting(m):
    t = _fresh(m)
    out = []
    with t.span("outer", kind="root") as outer:
        with t.span("inner") as inner:
            out.append((inner.parent_id == outer.span_id, inner.trace_id == outer.trace_id))
        with t.span("inner2", pods=5) as inner2:
            inner2.set(rounds=2)
    with t.span("outer2") as outer2:
        out.append((outer2.trace_id != outer.trace_id, outer2.parent_id))
    with t.span("server", trace_id="t-propagated"):
        with t.span("child") as child:
            out.append(child.trace_id)
    out.append(_mask_trace(t.chrome_trace()))
    return out


def _retroactive(m):
    t = _fresh(m)
    t0 = time.perf_counter_ns()
    with t.span("solver.solve"):
        t.add_span("solver.phase.args", t0, t0 + 1_000_000, n=3)
        t.add_span("solver.phase.args", t0, t0 + 2_000_000)
    phase = next(s for s in t.spans() if s.name == "solver.phase.args")
    seq = t.mark()
    t.add_span("solver.phase.fetch", t0, t0 + 500_000)
    return (phase.duration_ms, phase.attrs, t.phase_ms_since(0),
            t.phase_ms_since(0, last_only=True), [s.name for s in t.spans_since(seq)],
            _mask_trace(t.chrome_trace()))


def _errors(m):
    t = _fresh(m)
    try:
        with t.span("boom"):
            raise ValueError("x")
    except ValueError:
        pass
    return _mask_trace(t.chrome_trace())


def _ring(m):
    t = _fresh(m, capacity=4)
    for i in range(10):
        with t.span(f"s{i}"):
            pass
    return [s.name for s in t.spans()], t.dropped, t.mark()


def _export(m):
    t = _fresh(m)
    with t.span("solver.host.dispatch"):
        for i in range(10):
            with t.span(f"solver.phase.p{i}", idx=i):
                pass
    out = []
    for kw in ({}, {"max_spans": 4}, {"max_bytes": 300}):
        payload = m.tracer.export_spans(t.spans(), **kw)
        out.append(([{k: v for k, v in e.items() if k not in ("s", "e", "d")}
                     for e in payload["spans"]], payload["dropped"]))
    return out


def _bridge(m):
    """The metrics bridge into the process-wide registry: phase and solve
    histograms by label, the batch-size gauge from provisioning solves."""
    tr = m.tracer
    t = _fresh(m)

    def count(h, labels):
        return h.count_since(labels=labels)

    before = [count(tr.SOLVER_PHASE_DURATION, {"phase": "upload"}),
              count(tr.SOLVER_SOLVE_DURATION, {"context": "provisioning"}),
              count(tr.SOLVER_SOLVE_DURATION, {"context": "simulation"})]
    with t.span("solver.phase.upload"):
        pass
    with t.span("solver.solve", pods=123):
        pass
    size = tr.SOLVER_BATCH_SIZE.get()
    with t.span("solver.solve", pods=9999, context="simulation"):
        pass
    after = [count(tr.SOLVER_PHASE_DURATION, {"phase": "upload"}),
             count(tr.SOLVER_SOLVE_DURATION, {"context": "provisioning"}),
             count(tr.SOLVER_SOLVE_DURATION, {"context": "simulation"})]
    return [a - b for a, b in zip(after, before)], size, tr.SOLVER_BATCH_SIZE.get()


def _env_switch(m):
    import os

    tr = m.tracer
    was, old = tr.TRACER.enabled, os.environ.get("KARPENTER_TPU_TRACE")
    out = []
    try:
        for raw, default_on in [("1", False), ("true", False), ("on", False), ("", False),
                                ("0", True), ("false", True), ("", True)]:
            tr.TRACER.disable()
            os.environ["KARPENTER_TPU_TRACE"] = raw
            out.append(tr.enable_tracing_from_env(default_on))
    finally:
        tr.TRACER.enabled = was
        if old is None:
            os.environ.pop("KARPENTER_TPU_TRACE", None)
        else:
            os.environ["KARPENTER_TPU_TRACE"] = old
    return out


def _instant(m):
    """Instant events (a breaker transition, a wedge verdict): zero-length
    spans drawn as 'i' markers, parented like any span; a disabled tracer
    records nothing."""
    t = _fresh(m)
    with t.span("solver.solve"):
        t.instant("solver.wedge", kind="wedged", phase="solver.phase.device")
    t.instant("breaker.solver.device", to="open", from_state="closed", failures=3)
    spans = [(s.name, s.start_ns == s.end_ns, s.attrs) for s in t.spans()]
    off = m.tracer.Tracer(capacity=8)
    off.instant("solver.wedge", kind="timeout")
    return spans, off.spans(), _mask_trace(t.chrome_trace())


TRACER_CASES = {f.__name__.strip("_"): f for f in (
    _nesting, _retroactive, _errors, _ring, _export, _bridge, _env_switch, _instant)}


@pytest.mark.parametrize("case", sorted(TRACER_CASES))
def test_tracer_matches_reference(case):
    """The same span calls on both tracers: the same chrome_trace event
    names, nesting and attributes once timestamps and pids are masked, the
    same exports and metric observations."""
    ref, port = both(TRACER_CASES[case])
    assert port == ref


def test_export_chrome_trace_round_trips(tmp_path):
    import json

    t = _fresh(PKGS["torch"])
    with t.span("provisioner.reconcile"):
        with t.span("solver.phase.encode", pods=5):
            pass
    path = t.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        trace = json.load(f)
    events = [e for e in trace["traceEvents"] if e["ph"] != "M"]
    assert [e["name"] for e in events] == ["solver.phase.encode", "provisioner.reconcile"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert events[0]["args"]["parent_id"] == events[1]["args"]["span_id"]


def test_device_profiler_is_opt_in_and_raises_when_it_cannot_start(monkeypatch, tmp_path):
    """No KARPENTER_TPU_PROFILE: a no-op. Asked for: a torch.profiler
    capture exported as a Chrome trace; a profiler that cannot start
    raises instead of passing for a trace."""
    import contextlib
    import json

    import torch

    monkeypatch.delenv("KARPENTER_TPU_PROFILE", raising=False)
    assert ttracer.profile_dir() == ""
    assert isinstance(ttracer.device_profiler(), contextlib.nullcontext)
    monkeypatch.setenv("KARPENTER_TPU_PROFILE", str(tmp_path / "prof"))
    with ttracer.device_profiler() as prof:
        torch.ones(64).sum()
    with open(prof.path) as f:
        assert json.load(f)["traceEvents"]

    def broken(*a, **kw):
        raise RuntimeError("CUPTI unavailable")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    with pytest.raises(RuntimeError, match="CUPTI"):
        with ttracer.device_profiler():
            pass


# -- the structured log -------------------------------------------------------------


class _Sink:
    """A fresh sink with a capture stream, swapped in as the module's."""

    def __init__(self, m, fmt="logfmt"):
        self.m = m
        self.sink = m.log.LogSink(capacity=8)
        self.sink.configure(level=m.log.INFO, fmt=fmt, stream=io.StringIO())

    def __enter__(self):
        self.orig = self.m.log.SINK
        self.m.log.SINK = self.sink
        return self.sink

    def __exit__(self, *exc):
        self.m.log.SINK = self.orig
        return False


def _records(m, sink, ts=1_700_000_000.25):
    """The sink's records with the timestamp pinned (and the stack of an
    exception record dropped), rendered by the package's logfmt and JSON
    formatters."""
    out = []
    for r in sink.records():
        r = dict(r, ts=ts)
        r.pop("stack", None)
        out.append((r, m.log.format_logfmt(r), m.log.format_json(r)))
    return out


def _levels(m):
    with _Sink(m) as sink:
        log = m.log.get_logger("karpenter.test")
        log.debug("dropped")
        log.info("kept", pods=3, ratio=0.5, ok=True)
        log.warning("kept too", msg_with_space="a b", quote='say "hi"')
        sink.level = m.log.ERROR
        log.warning("now dropped")
        log.error("boom", kind="Pod")
        sink.disable()
        log.info("nope")
        log.error("still visible")
        return _records(m, sink), sink.stream.getvalue().count("\n"), sink.enabled


def _bound_ctx(m):
    with _Sink(m) as sink:
        log = m.log.get_logger("karpenter.test")
        seen = {}
        with m.log.bound(controller="provisioning", reconcile="r7"):
            log.info("outer")
            with m.log.bound(phase="launch"):
                log.info("inner")
                seen["ctx"] = m.log.bound_context()
            log.info("overridden", controller="b")

            def worker():
                seen["thread"] = m.log.bound_context()

            t = threading.Thread(target=worker)
            t.start()
            t.join()
        log.info("unbound")
        return _records(m, sink), seen


def _trace_ids(m):
    with _Sink(m) as sink:
        tracer = m.tracer.Tracer(capacity=16).enable()
        orig = m.log.TRACER
        m.log.TRACER = tracer
        try:
            log = m.log.get_logger("karpenter.test")
            log.info("outside any span")
            with tracer.span("solver.solve"):
                log.info("inside the solve")
        finally:
            m.log.TRACER = orig
        return _records(m, sink)


def _exceptions(m):
    with _Sink(m, fmt="json") as sink:
        log = m.log.get_logger("karpenter.test")
        try:
            raise RuntimeError("pump died")
        except RuntimeError:
            log.exception("watch pump failed", kind="Pod")
        stack = sink.records()[-1]["stack"]
        return _records(m, sink), "RuntimeError: pump died" in stack, sink.lines().count("\n")


def _ring_and_lines(m):
    with _Sink(m) as sink:
        log = m.log.get_logger("karpenter.test")
        for i in range(12):
            log.info("n", i=i)
        lines = [re.sub(r"ts=\S+ ", "", ln) for ln in sink.lines().splitlines()]
        return sink.dropped, lines, len(sink.records())


def _specs(m):
    specs = ["", "off", "0", "1", "true", "debug", "warn", "error:json", "json",
             "debug:json", "verbose", " INFO "]
    return [m.log.parse_log_spec(s) for s in specs]


LOG_CASES = {f.__name__.strip("_"): f for f in (
    _levels, _bound_ctx, _trace_ids, _exceptions, _ring_and_lines, _specs)}


@pytest.mark.parametrize("case", sorted(LOG_CASES))
def test_log_matches_reference(case):
    """The same log calls on both packages: the same records, and the same
    logfmt and JSON lines."""
    ref, port = both(LOG_CASES[case])
    assert port == ref


def test_log_records_render_alike_in_both_packages():
    """One record through each package's formatters: identical lines."""
    r = {"ts": 1_700_000_000.5, "level": "info", "logger": "karpenter.x", "msg": "a b",
         "n": 3, "f": 0.25, "ok": False, "s": 'q"\n', "none": None}
    assert tlog.format_logfmt(r) == jlog.format_logfmt(r)
    assert tlog.format_json(r) == jlog.format_json(r)


def test_singleton_reconcile_binds_log_context_and_span():
    """Every Singleton reconcile runs in a controller/reconcile-id log scope
    and a controller.reconcile span; its failure line carries the same id."""
    from karpenter_core_tpu_torch.operator.controller import Singleton

    captured = {}
    with _Sink(PKGS["torch"]) as sink:
        tracer = ttracer.TRACER
        was = tracer.enabled
        tracer.enable()
        seq = tracer.mark()
        try:
            def reconcile():
                captured.update(tlog.bound_context())
                tlog.get_logger("karpenter.test").info("inside reconcile")

            Singleton("unit-test", reconcile).reconcile_once()

            def failing():
                raise RuntimeError("injected")

            assert Singleton("failing", failing).reconcile_once() > 0
        finally:
            tracer.enabled = was
        spans = [s for s in tracer.spans_since(seq) if s.name == "controller.reconcile"]
        inside = next(r for r in sink.records() if r["msg"] == "inside reconcile")
        failed = next(r for r in sink.records() if r["msg"] == "reconcile failed")
    assert captured["controller"] == "unit-test" and inside["reconcile"] == captured["reconcile"]
    assert [s.attrs["controller"] for s in spans] == ["unit-test", "failing"]
    assert spans[1].attrs["error"] == "RuntimeError"
    assert failed["controller"] == "failing" and failed["failures"] == 1
    assert failed["error"] == "RuntimeError" and failed["reconcile"].startswith("r")


# -- the request context ---------------------------------------------------------------


def _reqctx(m):
    rc = m.reqctx
    out = [rc.current(), rc.current_tenant(), rc.tenant_labels(), rc.tenant_labels(kind="x")]
    with rc.bind(rc.RequestContext(tenant="a", request_id="q1", deadline_s=2.0)):
        out.append((rc.current_tenant(), rc.current().deadline_s, m.log.bound_context()))
        with rc.bind(rc.RequestContext(tenant="b")):
            out.append((rc.current_tenant(), m.log.bound_context()))
        seen = {}
        t = threading.Thread(target=lambda: seen.setdefault("t", rc.current_tenant()))
        t.start()
        t.join()
        out.append(seen["t"])
    try:
        with rc.bind(rc.RequestContext(tenant="c")):
            raise KeyError("x")
    except KeyError:
        pass
    out.append(rc.current())
    guard = rc.TenantGuard(cap=2)
    out.append([guard.admit(t) for t in ("a", "b", "c", "a", None, "d")])
    out.append((guard.tenants(), guard.stats()))
    flood = rc.TenantGuard(cap=3)
    out.append(len({flood.admit(f"t{i}") for i in range(1000)}))
    out.append((rc.DEFAULT_TENANT_CAP, rc.OVERFLOW_TENANT, rc.TENANT_HEADER,
                rc.TENANTS.cap))
    return out


def test_reqctx_matches_reference():
    ref, port = both(_reqctx)
    assert port == ref


# -- the disabled paths -------------------------------------------------------------


def test_disabled_paths_hold_the_reference_tripwires():
    """A disabled tracer returns the shared no-op span and records nothing;
    a disabled recorder's begin() is None; a disabled sink records nothing
    below error."""
    from karpenter_core_tpu_torch.obs import FLIGHTREC, TRACER
    from karpenter_core_tpu_torch.obs.tracer import NOOP_SPAN

    t = ttracer.Tracer()
    assert not t.enabled
    assert t.span("a") is NOOP_SPAN and t.span("b", pods=50000) is NOOP_SPAN
    with t.span("c") as sp:
        assert sp.set(x=1) is NOOP_SPAN
    t.add_span("d", 0, 10)
    assert t.mark() == 0 and not t.spans()
    was_t, was_f = TRACER.enabled, FLIGHTREC.enabled
    try:
        TRACER.disable()
        FLIGHTREC.disable()
        assert TRACER.span("solver.solve") is NOOP_SPAN
        assert FLIGHTREC.begin([], [], {}) is None
    finally:
        TRACER.enabled, FLIGHTREC.enabled = was_t, was_f
    sink = tlog.LogSink()
    assert not sink.enabled and sink.level == tlog.OFF


def test_port_imports_no_jax():
    """The observability modules of the port import nothing of JAX or of
    the reference package (checked in a fresh interpreter)."""
    import subprocess
    import sys

    code = ("import sys; import karpenter_core_tpu_torch.obs, "
            "karpenter_core_tpu_torch.obs.flightrec, "
            "karpenter_core_tpu_torch.controllers.metrics.controllers, "
            "karpenter_core_tpu_torch.cloudprovider.metrics, "
            "karpenter_core_tpu_torch.kube.serialization, "
            "karpenter_core_tpu_torch.utils.compilecache, "
            "karpenter_core_tpu_torch.analysis.__main__; "
            "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.') "
            "or k == 'karpenter_core_tpu' or k.startswith('karpenter_core_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- one provisioning reconcile: the span tree -------------------------------------

# the port also decodes under `decode`, a retroactive phase span recorded
# beside `bind`, spliced out of its tree (its children move up to the
# parent). `pack` and `bind` are spans without a phase: the port's
# last_phase_ms keeps its own keys. Both time the prescreen dispatch as
# `prescreen`.
PORT_ONLY_PHASES = ("solver.phase.decode",)
SPAN_ONLY_PHASES = ("solver.phase.pack", "solver.phase.bind")


def _span_tree(spans, splice):
    by_id = {s.span_id: s for s in spans}
    children = {}
    for s in spans:
        parent = s.parent_id
        while parent in by_id and by_id[parent].name in splice:
            parent = by_id[parent].parent_id
        children.setdefault(parent if parent in by_id else None, []).append(s)

    def tree(s):
        return (s.name, tuple(sorted(tree(c) for c in children.get(s.span_id, ())
                                     if c.name not in splice)))

    return tuple(sorted(tree(s) for s in children.get(None, ()) if s.name not in splice))


def _reconcile_spans(pkg):
    if pkg == "jax":
        from karpenter_core_tpu import testing as t
        from karpenter_core_tpu.cloudprovider import fake
        from karpenter_core_tpu.obs import TRACER
        from karpenter_core_tpu.operator import new_operator
        from karpenter_core_tpu.solver.tpu_solver import TPUSolver

        solver = TPUSolver(max_nodes=32, backend="mxu", incremental="off")
    else:
        from karpenter_core_tpu_torch import testing as t
        from karpenter_core_tpu_torch.cloudprovider import fake
        from karpenter_core_tpu_torch.obs import TRACER
        from karpenter_core_tpu_torch.operator import new_operator
        from karpenter_core_tpu_torch.solver.torch_solver import TorchSolver

        solver = TorchSolver(max_nodes=32, device="cpu", incremental="off")
    op = new_operator(fake.FakeCloudProvider(fake.instance_types(6)), solver=solver,
                      clock=t.FakeClock(1_700_000_000.0))
    op.kube_client.create(t.make_provisioner(name="default"))
    for i in range(12):
        pod = t.make_pod(name=f"p-{i}", requests={"cpu": "1"})
        pod.metadata.uid, pod.metadata.creation_timestamp = f"uid-{i:03d}", 1000.0 + i
        op.kube_client.create(pod)
    was = TRACER.enabled
    TRACER.enable()
    seq = TRACER.mark()
    try:
        op.step()
    finally:
        TRACER.enabled = was
    return TRACER.spans_since(seq), solver


def test_provisioning_reconcile_span_tree_matches_reference():
    """One provisioning reconcile through each package's operator: the same
    span-name tree (provisioner.reconcile -> solver.solve -> solver.phase.*,
    provisioner.launch), apart from the port's own phase listed above;
    the port's phase spans but `pack` and `bind` equal its last_phase_ms."""
    ref_spans, _ = _reconcile_spans("jax")
    port_spans, solver = _reconcile_spans("torch")
    ref = _span_tree(ref_spans, ())
    port = _span_tree(port_spans, PORT_ONLY_PHASES)
    assert port == ref
    assert ref == ((
        "provisioner.reconcile", (
            ("provisioner.launch", ()),
            ("solver.solve", tuple(sorted(
                [("solver.phase.bind", (("solver.phase.expand", ()),))]
                + [(f"solver.phase.{p}", ()) for p in
                   ("args", "device", "encode", "fetch", "pack", "prescreen", "upload")]))),
        )),)
    names = {s.name for s in port_spans}
    assert set(PORT_ONLY_PHASES) <= names
    solve = next(s for s in port_spans if s.name == "solver.solve")
    assert solve.attrs["context"] == "provisioning" and solve.attrs["pods"] == 12
    phases = {s.name[len("solver.phase."):]: s.duration_ms for s in port_spans
              if s.name.startswith("solver.phase.")
              and s.name not in ("solver.phase.expand", *SPAN_ONLY_PHASES)}
    assert phases == solver.last_phase_ms
