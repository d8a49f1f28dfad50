"""Minimal in-process metrics registry (counters, gauges, histograms): the
port's own copy of the reference package's, series for series.

The reference exposes prometheus metrics (pkg/metrics/metrics.go:13-38 and
per-controller instruments). This registry mirrors that surface — namespaced
metric names, label sets, duration buckets — with an in-memory store and a
text exposition dump, so the operator runtime can serve/inspect the same
signals without a prometheus client dependency. expose() emits the real
Prometheus text format (HELP/TYPE lines, cumulative histogram buckets with
the +Inf series, escaped label values) so promtool and a real scraper can
parse the endpoint.
"""
from __future__ import annotations

import bisect
import threading
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

NAMESPACE = "karpenter"

# metrics.go DurationBuckets
DURATION_BUCKETS = [
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120, 300,
]


LabelValues = Tuple[Tuple[str, str], ...]


def _labels(labels: Optional[Dict[str, str]]) -> LabelValues:
    return tuple(sorted((labels or {}).items()))


def _escape_label(value: str) -> str:
    """Label-value escaping per the exposition format: backslash, quote,
    newline."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(lv: LabelValues, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in lv]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(value: float) -> str:
    """Full-precision sample rendering (the python client's convention):
    %g's 6 significant digits would corrupt large counters/sums under
    rate()/increase() on a real scraper."""
    if value == int(value) and abs(value) < 1e17:
        return str(int(value))
    return repr(float(value))


def _fmt_exemplar(ex: Optional[Tuple[Dict[str, str], float]]) -> str:
    """OpenMetrics exemplar suffix for a bucket line ('' when absent):
    ` # {trace_id="t42"} 0.93` — the metric -> trace -> flight-record link
   . Rendered only on lines that carry one, so exemplar-free
    exposition stays byte-identical to the plain 0.0.4 format."""
    if not ex:
        return ""
    labels, value = ex
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
    )
    return f" # {{{inner}}} {_fmt_value(value)}"


def _render_external(name: str, kind: str, fam: dict) -> List[str]:
    """Sample lines for one external family (no HELP/TYPE — the caller
    emitted the one header for this name). Series labels are rendered
    as-is; the source is responsible for disambiguating its series from
    the local ones (the solver host adds a `process` label)."""
    lines: List[str] = []
    series = sorted(
        ((_labels(labels), value) for labels, value in fam.get("series", ())),
    )
    if kind in ("counter", "gauge"):
        for lv, value in series:
            try:
                lines.append(f"{name}{_fmt_labels(lv)} {_fmt_value(value)}")
            except (TypeError, ValueError):
                continue
        return lines
    bounds = list(fam.get("buckets", ()))
    for lv, hist in series:
        if not isinstance(hist, dict):
            continue
        counts = list(hist.get("buckets", ()))
        count = int(hist.get("count", 0))
        for bound, c in zip(bounds, counts):
            le = _fmt_labels(lv, f'le="{bound:g}"')
            lines.append(f"{name}_bucket{le} {int(c)}")
        inf = _fmt_labels(lv, 'le="+Inf"')
        lines.append(f"{name}_bucket{inf} {count}")
        lines.append(
            f"{name}_sum{_fmt_labels(lv)} {_fmt_value(float(hist.get('sum', 0.0)))}"
        )
        lines.append(f"{name}_count{_fmt_labels(lv)} {count}")
    return lines


class Counter:
    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._mu = threading.Lock()
        self.values: Dict[LabelValues, float] = defaultdict(float)

    def inc(self, labels: Optional[Dict[str, str]] = None, value: float = 1.0) -> None:
        with self._mu:
            self.values[_labels(labels)] += value

    def get(self, labels: Optional[Dict[str, str]] = None) -> float:
        with self._mu:
            return self.values.get(_labels(labels), 0.0)

    def clear(self, labels: Optional[Dict[str, str]] = None) -> None:
        """Drop one labeled series, or every series when `labels` is None:
        a test or a smoke phase that wants a fresh count (the exposition of
        a cleared series restarts from zero, as after a process restart)."""
        with self._mu:
            if labels is None:
                self.values.clear()
            else:
                self.values.pop(_labels(labels), None)

    def series(self) -> List[Tuple[Dict[str, str], float]]:
        """Snapshot of every labeled series: [(labels, value), ...]. Used
        by out-of-process reporters (the solver host's stats frame) that
        need the whole counter, not one label combination."""
        with self._mu:
            return [(dict(lv), v) for lv, v in self.values.items()]


class Gauge:
    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._mu = threading.Lock()
        self.values: Dict[LabelValues, float] = {}

    def set(self, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        with self._mu:
            self.values[_labels(labels)] = value

    def get(self, labels: Optional[Dict[str, str]] = None) -> Optional[float]:
        with self._mu:
            return self.values.get(_labels(labels))

    def delete(self, labels: Optional[Dict[str, str]] = None) -> None:
        with self._mu:
            self.values.pop(_labels(labels), None)

    def clear(self) -> None:
        with self._mu:
            self.values.clear()

    def replace_all(self, pairs: Iterable[Tuple[float, Optional[Dict[str, str]]]]) -> None:
        """Atomically swap the whole series set to `pairs` ((value, labels)
        tuples): scrapers reading under the same lock (expose) see either
        the previous generation or the new one, never a cleared/partial
        one — the clear()-then-set scrape race's fix."""
        new_values = {_labels(labels): value for value, labels in pairs}
        with self._mu:
            self.values = new_values


class Histogram:
    def __init__(self, name: str, help: str = "", buckets: Iterable[float] = DURATION_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = sorted(buckets)
        self._mu = threading.Lock()
        # bucket_counts are CUMULATIVE (le semantics), matching exposition
        self.bucket_counts: Dict[LabelValues, List[int]] = {}
        self.sums: Dict[LabelValues, float] = defaultdict(float)
        self.counts: Dict[LabelValues, int] = defaultdict(int)
        # last exemplar per (series, bucket index): {trace_id: ...} labels +
        # the observed value, rendered OpenMetrics-style on bucket lines so
        # a bad p99 bucket links metric -> trace -> flight record
        self.exemplars: Dict[LabelValues, Dict[int, Tuple[Dict[str, str], float]]] = {}

    def observe(self, value: float, labels: Optional[Dict[str, str]] = None,
                exemplar: Optional[Dict[str, str]] = None) -> None:
        lv = _labels(labels)
        with self._mu:
            counts = self.bucket_counts.setdefault(lv, [0] * len(self.buckets))
            i = bisect.bisect_left(self.buckets, value)
            for b in range(i, len(self.buckets)):
                counts[b] += 1
            self.sums[lv] += value
            self.counts[lv] += 1
            if exemplar:
                # i == len(buckets) attaches to the +Inf bucket
                self.exemplars.setdefault(lv, {})[i] = (dict(exemplar), value)

    def clear(self) -> None:
        """Drop every series (a fresh count for a test or a smoke phase)."""
        with self._mu:
            self.bucket_counts.clear()
            self.sums.clear()
            self.counts.clear()
            self.exemplars.clear()

    def series(self) -> List[Tuple[Dict[str, str], Dict[str, object]]]:
        """Snapshot of every labeled series: [(labels, {"buckets":
        cumulative-counts, "sum": s, "count": n}), ...] — the histogram
        twin of Counter.series(), ridden by out-of-process reporters (the
        solver host's stats frame)."""
        with self._mu:
            return [
                (
                    dict(lv),
                    {
                        "buckets": list(self.bucket_counts.get(lv, ())),
                        "sum": self.sums[lv],
                        "count": count,
                    },
                )
                for lv, count in self.counts.items()
            ]

    def snapshot(self, labels: Optional[Dict[str, str]] = None):
        """(cumulative bucket counts, count, sum) at this instant — pass a
        snapshot back into percentile()/count_since() as `baseline` to read
        the distribution of ONLY the observations made since (counters are
        process-cumulative; SLO windows are not)."""
        lv = _labels(labels)
        with self._mu:
            return (
                list(self.bucket_counts.get(lv, ())),
                self.counts[lv],
                self.sums[lv],
            )

    def count_since(self, baseline=None, labels: Optional[Dict[str, str]] = None) -> int:
        lv = _labels(labels)
        with self._mu:
            return self.counts[lv] - (baseline[1] if baseline else 0)

    def merged_snapshot(self):
        """Cross-series aggregate in snapshot() shape: (cumulative bucket
        counts, count, sum) summed over EVERY labeled series. The
        attribution plane splits one logical stream into per-tenant series
       ; readers that want the whole stream regardless of who
        it was billed to — an SLO window's math — baseline-diff
        against this instead of the unlabeled series."""
        with self._mu:
            agg = [0] * len(self.buckets)
            total = 0
            s = 0.0
            for lv, count in list(self.counts.items()):
                for i, v in enumerate(self.bucket_counts.get(lv, ())):
                    agg[i] += v
                total += count
                s += self.sums[lv]
            return agg, total, s

    def merged_percentile(self, q: float, baseline=None) -> Optional[float]:
        """percentile() over the merged_snapshot() aggregate; `baseline`
        must also be a merged_snapshot()."""
        counts, total, _ = self.merged_snapshot()
        base_counts, base_total = (
            (baseline[0], baseline[1]) if baseline else ((), 0)
        )
        total -= base_total
        if total <= 0:
            return None
        target = q * total
        for i, (bucket, c) in enumerate(zip(self.buckets, counts)):
            c -= base_counts[i] if i < len(base_counts) else 0
            if c >= target:
                return bucket
        return self.buckets[-1]

    def percentile(self, q: float, labels: Optional[Dict[str, str]] = None,
                   baseline=None) -> Optional[float]:
        """Upper bucket bound at quantile q; values above the largest
        finite bucket saturate to it (histogram_quantile's convention).
        With `baseline` (a prior snapshot()), quantiles cover only the
        observations recorded after the snapshot."""
        lv = _labels(labels)
        base_counts, base_total = (
            (baseline[0], baseline[1]) if baseline else ((), 0)
        )
        with self._mu:
            counts = self.bucket_counts.get(lv)
            total = self.counts[lv] - base_total
            if not counts or total <= 0:
                return None
            target = q * total
            for i, (bucket, c) in enumerate(zip(self.buckets, counts)):
                c -= base_counts[i] if i < len(base_counts) else 0
                if c >= target:
                    return bucket
            return self.buckets[-1]


class Registry:
    def __init__(self):
        self._mu = threading.Lock()
        self.metrics: Dict[str, object] = {}
        # external sample sources: objects with a `families()`
        # method returning {name: {"kind", "help", "buckets", "series"}} —
        # the solver host's merged child-process metrics register here so
        # the ONE exposition carries both processes' series (same metric
        # family, disjoint label sets: child series carry a `process`
        # label). Registered sources must never raise from families().
        self._externals: List[object] = []

    def add_external(self, source) -> None:
        with self._mu:
            if source not in self._externals:
                self._externals.append(source)

    def remove_external(self, source) -> None:
        with self._mu:
            if source in self._externals:
                self._externals.remove(source)

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, lambda: Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, lambda: Gauge(name, help))

    def histogram(self, name: str, help: str = "", buckets=DURATION_BUCKETS) -> Histogram:
        return self._get_or_create(
            name, Histogram, lambda: Histogram(name, help, buckets)
        )

    def _get_or_create(self, name: str, cls, factory):
        with self._mu:
            existing = self.metrics.get(name)
            if existing is None:
                existing = self.metrics[name] = factory()
            elif not isinstance(existing, cls):
                raise TypeError(
                    f"metric {name!r} is already registered as "
                    f"{type(existing).__name__}, not {cls.__name__}"
                )
            return existing

    def expose(self, exemplars: bool = False) -> str:
        """Prometheus text exposition (format version 0.0.4 by default).

        ``exemplars=True`` appends OpenMetrics `# {…}` exemplar suffixes
        on histogram bucket lines that carry one — callers serving that
        form MUST declare the openmetrics content type (the 0.0.4 parser
        treats the suffix as a malformed timestamp and fails the whole
        scrape), which is why the default exposition never renders them:
        exemplars are only reachable through content negotiation
        (a /metrics endpoint honors `Accept: application/openmetrics-text`).
        External sources' series render under the same family header as
        the local metric of that name (one HELP/TYPE per name — duplicate
        headers are illegal exposition), after the local series."""
        lines: List[str] = []
        with self._mu:
            metrics = dict(self.metrics)
            externals = list(self._externals)
        ext_families: Dict[str, List[dict]] = {}
        for source in externals:
            try:
                fams = source.families()
            except Exception:  # noqa: BLE001 — a sick source must not kill /metrics
                continue
            for name, fam in (fams or {}).items():
                ext_families.setdefault(name, []).append(fam)
        for name in sorted(set(metrics) | set(ext_families)):
            metric = metrics.get(name)
            fams = ext_families.get(name, [])
            help_text = metric.help if metric is not None else next(
                (f.get("help", "") for f in fams if f.get("help")), ""
            )
            if metric is not None:
                kind = (
                    "counter" if isinstance(metric, Counter)
                    else "gauge" if isinstance(metric, Gauge)
                    else "histogram"
                )
            else:
                kind = str(fams[0].get("kind", "counter"))
            if help_text:
                lines.append(f"# HELP {name} {_escape_help(help_text)}")
            lines.append(f"# TYPE {name} {kind}")
            if isinstance(metric, (Counter, Gauge)):
                with metric._mu:
                    values = dict(metric.values)
                for lv, value in sorted(values.items()):
                    lines.append(f"{name}{_fmt_labels(lv)} {_fmt_value(value)}")
            elif isinstance(metric, Histogram):
                with metric._mu:
                    series = {
                        lv: (
                            list(metric.bucket_counts.get(lv, [])),
                            metric.sums[lv],
                            count,
                            dict(metric.exemplars.get(lv, ())),
                        )
                        for lv, count in metric.counts.items()
                    }
                for lv, (buckets, total_sum, count, ex) in sorted(
                    series.items()
                ):
                    for i, (bound, c) in enumerate(zip(metric.buckets, buckets)):
                        le = _fmt_labels(lv, f'le="{bound:g}"')
                        lines.append(
                            f"{name}_bucket{le} {c}"
                            + (_fmt_exemplar(ex.get(i)) if exemplars else "")
                        )
                    inf = _fmt_labels(lv, 'le="+Inf"')
                    lines.append(
                        f"{name}_bucket{inf} {count}"
                        + (_fmt_exemplar(ex.get(len(metric.buckets)))
                           if exemplars else "")
                    )
                    lines.append(
                        f"{name}_sum{_fmt_labels(lv)} {_fmt_value(total_sum)}"
                    )
                    lines.append(f"{name}_count{_fmt_labels(lv)} {count}")
            for fam in fams:
                lines.extend(_render_external(name, kind, fam))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# cross-process metric merging: the solver-host child snapshots
# its registry into a JSON-able families dict that rides the stats frame;
# the parent folds snapshots into a ProcessSeriesMerger registered as an
# external exposition source, so child counters/histograms appear in the
# ONE parent /metrics under a `process` label — double-count-proof across
# kill->respawn cycles (cumulative snapshots are keyed by child generation;
# a dead generation's last snapshot is committed once, never re-added).


def snapshot_families(registry: "Registry", prefix: str = NAMESPACE + "_",
                      max_series: int = 512) -> Dict[str, dict]:
    """JSON-able cumulative snapshot of a registry's counters + histograms
    (gauges deliberately excluded: a dead child's last gauge reading is
    not a fact about the parent process). Bounded: at most `max_series`
    series total — oversized registries truncate deterministically (sorted
    name order) rather than bloat the frame."""
    out: Dict[str, dict] = {}
    with registry._mu:
        metrics = dict(registry.metrics)
    budget = max_series
    for name in sorted(metrics):
        if budget <= 0:
            break
        if not name.startswith(prefix):
            continue
        metric = metrics[name]
        if isinstance(metric, Counter):
            series = [
                [labels, value] for labels, value in metric.series()
            ][:budget]
            if not series:
                continue
            out[name] = {"kind": "counter", "help": metric.help,
                         "series": series}
        elif isinstance(metric, Histogram):
            series = [
                [labels, state] for labels, state in metric.series()
            ][:budget]
            if not series:
                continue
            out[name] = {
                "kind": "histogram", "help": metric.help,
                "buckets": list(metric.buckets), "series": series,
            }
        else:
            continue
        budget -= len(out[name]["series"])
    return out


def _merge_state(kind: str, a, b):
    """a + b for one series' cumulative state (scalar or histogram dict)."""
    if kind != "histogram":
        return float(a) + float(b)
    ab, bb = list(a.get("buckets", ())), list(b.get("buckets", ()))
    if len(ab) < len(bb):
        ab += [0] * (len(bb) - len(ab))
    elif len(bb) < len(ab):
        bb += [0] * (len(ab) - len(bb))
    return {
        "buckets": [int(x) + int(y) for x, y in zip(ab, bb)],
        "sum": float(a.get("sum", 0.0)) + float(b.get("sum", 0.0)),
        "count": int(a.get("count", 0)) + int(b.get("count", 0)),
    }


class ProcessSeriesMerger:
    """Merged view over one child process's cumulative metric snapshots.

    Contract (the respawn-idempotency story):

      * ``ingest(generation, families)`` REPLACES the live view for that
        generation — re-ingesting the same cumulative snapshot is a no-op
        on the merged totals (snapshots are states, not deltas);
      * a generation bump (respawn) folds the previous generation's last
        snapshot into the committed base exactly once, so a child that
        died counting 7 solves contributes 7 forever, and its successor
        counts from 0 on top;
      * ``retire(generation)`` folds eagerly on a kill, so the exposition
        never loses the dead child's tail while the respawn boots.

    ``families()`` renders base+live with the ``process`` label added to
    every series — the disambiguator against the parent's own series."""

    def __init__(self, process: str):
        self.process = process
        self._mu = threading.Lock()
        self._meta: Dict[str, Tuple[str, str, Tuple[float, ...]]] = {}
        # name -> {label-tuple: state}; states are scalars (counter) or
        # {"buckets","sum","count"} dicts (histogram)
        self._base: Dict[str, Dict[LabelValues, object]] = {}
        self._live: Dict[str, Dict[LabelValues, object]] = {}
        self._live_gen: Optional[int] = None

    def _parse(self, families: Dict[str, dict]) -> Dict[str, Dict[LabelValues, object]]:
        parsed: Dict[str, Dict[LabelValues, object]] = {}
        for name, fam in (families or {}).items():
            kind = str(fam.get("kind", "counter"))
            if kind not in ("counter", "histogram"):
                continue
            self._meta[name] = (
                kind, str(fam.get("help", "")),
                tuple(fam.get("buckets", ())),
            )
            parsed[name] = {
                _labels(dict(labels)): state
                for labels, state in fam.get("series", ())
            }
        return parsed

    def _fold_live_locked(self) -> None:
        for name, series in self._live.items():
            kind = self._meta.get(name, ("counter",))[0]
            base = self._base.setdefault(name, {})
            for lv, state in series.items():
                if lv in base:
                    base[lv] = _merge_state(kind, base[lv], state)
                else:
                    base[lv] = state
        self._live = {}
        self._live_gen = None

    def ingest(self, generation: int, families: Dict[str, dict]) -> None:
        with self._mu:
            if self._live_gen is not None and generation != self._live_gen:
                self._fold_live_locked()
            self._live_gen = generation
            self._live = self._parse(families)

    def retire(self, generation: int) -> None:
        """The child of `generation` is dead: commit its last snapshot to
        the base (idempotent — retiring an already-folded or never-seen
        generation is a no-op)."""
        with self._mu:
            if self._live_gen == generation:
                self._fold_live_locked()

    def clear(self) -> None:
        with self._mu:
            self._base = {}
            self._live = {}
            self._live_gen = None

    def families(self) -> Dict[str, dict]:
        with self._mu:
            names = set(self._base) | set(self._live)
            out: Dict[str, dict] = {}
            for name in sorted(names):
                kind, help_text, buckets = self._meta.get(
                    name, ("counter", "", ())
                )
                merged: Dict[LabelValues, object] = dict(
                    self._base.get(name, ())
                )
                for lv, state in self._live.get(name, {}).items():
                    if lv in merged:
                        merged[lv] = _merge_state(kind, merged[lv], state)
                    else:
                        merged[lv] = state
                series = []
                for lv in sorted(merged):
                    labels = dict(lv)
                    labels["process"] = self.process
                    series.append([labels, merged[lv]])
                fam: Dict[str, object] = {
                    "kind": kind, "help": help_text, "series": series,
                }
                if kind == "histogram":
                    fam["buckets"] = list(buckets)
                out[name] = fam
            return out


REGISTRY = Registry()

# shared instruments (pkg/metrics/metrics.go:13-38)
NODES_CREATED = REGISTRY.counter(
    f"{NAMESPACE}_nodes_created", "Nodes created in total by the framework, by reason"
)
NODES_TERMINATED = REGISTRY.counter(
    f"{NAMESPACE}_nodes_terminated", "Nodes terminated in total by the framework, by reason"
)
MACHINES_CREATED = REGISTRY.counter(f"{NAMESPACE}_machines_created")
MACHINES_TERMINATED = REGISTRY.counter(f"{NAMESPACE}_machines_terminated")
