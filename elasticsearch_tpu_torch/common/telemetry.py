"""Node-wide telemetry: a cheap, thread-safe metrics registry.

Reference: the ES 8.0 line ships a first-class telemetry layer — APM
tracing via ``tracing.apm`` plus the long-standing stats surfaces — and
the engine's own serving work (blocked kNN, pipelined dispatch) has
twice needed diagnoses the node could not report: first-hit XLA
compiles landing mid-traffic, per-stage serving cost. This module is the
metrics half of that layer (``common/tracing.py`` is the trace half):

- :class:`Counter` / :class:`Gauge` / :class:`Histogram` — the three
  metric kinds. Histograms keep a bounded sample ring (p50/p99 computed
  at snapshot time, never on the hot path) plus monotonic count/sum.
- :class:`TelemetryRegistry` — label-aware get-or-create registry.
  Series cardinality is bounded (:attr:`TelemetryRegistry.MAX_SERIES`
  per family; overflow collapses into an ``overflow="true"`` series) so
  a shape-explosion bug can never grow memory without limit.
- Producers that keep their own state (microbatch stage rings, plane
  caches, breakers, task manager…) register *collectors* — callables
  returning family docs at snapshot time — instead of double-writing
  every update.
- Two exposition forms: :meth:`TelemetryRegistry.stats_doc` (JSON, the
  ``GET /_nodes/telemetry`` body) and
  :meth:`TelemetryRegistry.prometheus_text` (text exposition format
  0.0.4: ``# HELP``/``# TYPE`` + escaped labels; histograms render as
  summaries with p50/p99 quantile series).

Device instrumentation hooks (:func:`record_compile`,
:func:`record_transfer`, :func:`instrument_step`,
:func:`device_stats_doc`) live here too so the compile/transfer
counters land in the same registry the REST layer exposes.

The default registry is PROCESS-scoped (same documented-singleton
pattern as ``common/breakers.DEFAULT``): in-process multi-node test
clusters share one registry — compile counts and device bytes are
per-process truths on shared hardware — while per-node surfaces
(plane serving, tasks) are contributed by node-scoped collectors that
label themselves and are pruned when their node is garbage-collected.
"""

from __future__ import annotations

import re
import threading
import time
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "TelemetryRegistry", "DEFAULT",
    "record_compile", "record_transfer", "record_ann", "record_lex",
    "record_planner", "record_planner_dispatch",
    "record_agg_dispatch", "record_agg_pairs", "record_agg_sketch_merge",
    "record_warmed_shapes", "warmed_shapes_count",
    "record_mesh_dispatch", "mesh_idle_devices",
    "instrument_step", "device_stats_doc", "ann_drift_count",
    "lex_prune_off_count",
    "record_search_retry", "record_shard_failover",
    "record_recovery_bytes", "record_plane_handoff_ms",
    "record_tier_transition", "record_tier_stream_bytes",
]


class Counter:
    """Monotonic float counter (Prometheus counter semantics)."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Point-in-time value; either set directly or backed by a callable
    sampled at snapshot time."""

    __slots__ = ("_value", "_fn", "_lock")

    def __init__(self):
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)
            self._fn = None

    def set_fn(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self._fn = fn

    def set_max(self, v: float) -> None:
        """High-watermark update (device-memory peaks)."""
        with self._lock:
            self._value = max(self._value, float(v))
            self._fn = None

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:   # noqa: BLE001 — a dead provider reads 0
            return 0.0


class Histogram:
    """Bounded-sample histogram: monotonic count/sum plus a ring of the
    most recent ``cap`` observations for snapshot-time percentiles.

    Observations may carry an *exemplar* — a trace id (or any short
    correlation token) kept in its own bounded ring — so a latency
    family's p99 breach links straight to one ``GET /_trace/{id}`` span
    tree. Exemplars render in the exposition output as OpenMetrics
    ``# {trace_id="..."} value`` suffixes (see :meth:`TelemetryRegistry.
    prometheus_text`)."""

    __slots__ = ("count", "sum", "_ring", "_exemplars", "_lock",
                 "_sorted")

    CAP = 2048
    #: retained (value, exemplar) pairs — small: only the worst recent
    #: samples matter for the p99-breach → trace link
    EXEMPLAR_CAP = 64

    def __init__(self, cap: int = CAP):
        self.count = 0
        self.sum = 0.0
        self._ring: deque = deque(maxlen=cap)
        self._exemplars: deque = deque(maxlen=self.EXEMPLAR_CAP)
        self._lock = threading.Lock()
        #: cached sorted view of the ring; invalidated on observe so a
        #: scrape storm (N families x M pollers) sorts each ring at
        #: most once per new observation instead of once per scrape
        self._sorted: Optional[list] = None

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        with self._lock:
            self.count += 1
            self.sum += v
            self._ring.append(v)
            self._sorted = None
            if exemplar:
                self._exemplars.append((float(v), str(exemplar)))

    def exemplar_at_least(self, threshold: Optional[float]) \
            -> Optional[Tuple[float, str]]:
        """The retained exemplar best illustrating values >= ``threshold``
        (the smallest qualifying one, so a p99 exemplar is a p99-ish
        sample, not always the single worst); falls back to the largest
        retained exemplar when none qualifies."""
        with self._lock:
            pairs = list(self._exemplars)
        if not pairs:
            return None
        if threshold is not None:
            over = [p for p in pairs if p[0] >= threshold]
            if over:
                return min(over, key=lambda p: p[0])
        return max(pairs, key=lambda p: p[0])

    def snapshot(self) -> dict:
        with self._lock:
            if self._sorted is None:
                self._sorted = sorted(self._ring)
            # the cached list is never mutated after creation (observe
            # replaces it wholesale), so reading it outside the lock is
            # safe
            vals = self._sorted
            count, total = self.count, self.sum
        doc = {"count": count, "sum": round(total, 3)}
        if vals:
            def q(p: float) -> float:
                return vals[min(len(vals) - 1, int(p * len(vals)))]
            doc.update(p50=round(q(0.50), 3), p99=round(q(0.99), 3),
                       min=round(vals[0], 3), max=round(vals[-1], 3))
        ex = self.exemplar_at_least(doc.get("p99"))
        if ex is not None:
            doc["exemplar"] = {"value": round(ex[0], 3), "trace_id": ex[1]}
        return doc


_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_OK = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize_name(name: str) -> str:
    name = _NAME_OK.sub("_", str(name))
    return name if name and not name[0].isdigit() else f"_{name}"


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label escaping: backslash, double-quote,
    line-feed."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _labels_key(labels: Optional[dict]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((_LABEL_OK.sub("_", str(k)), str(v))
                        for k, v in labels.items()))


class TelemetryRegistry:
    """Thread-safe metric registry: families keyed by name, series keyed
    by their label set."""

    #: series cap per family — overflow collapses into one
    #: ``overflow="true"`` series instead of growing without bound
    MAX_SERIES = 256

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._lock = threading.RLock()
        # name -> {"type", "help", "series": {labels_key: (labels, metric)}}
        self._families: Dict[str, dict] = {}
        # name -> callable() -> {family: {"type","help","samples":[(labels,v)]}}
        self._collectors: Dict[str, Callable[[], dict]] = {}

    # -- metric get-or-create ------------------------------------------------

    def _metric(self, kind: str, name: str, labels: Optional[dict],
                help_: str):
        name = _sanitize_name(name)
        key = _labels_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = {
                    "type": kind, "help": help_, "series": {}}
            if fam["type"] != kind:
                raise ValueError(
                    f"metric [{name}] already registered as "
                    f"[{fam['type']}], not [{kind}]")
            series = fam["series"]
            ent = series.get(key)
            if ent is None:
                if len(series) >= self.MAX_SERIES:
                    key = (("overflow", "true"),)
                    ent = series.get(key)
                if ent is None:
                    ent = series[key] = (dict(key), self._KINDS[kind]())
            return ent[1]

    def counter(self, name: str, labels: Optional[dict] = None,
                help: str = "") -> Counter:
        return self._metric("counter", name, labels, help)

    def gauge(self, name: str, labels: Optional[dict] = None,
              help: str = "") -> Gauge:
        return self._metric("gauge", name, labels, help)

    def histogram(self, name: str, labels: Optional[dict] = None,
                  help: str = "") -> Histogram:
        return self._metric("histogram", name, labels, help)

    # -- collectors ----------------------------------------------------------

    def register_collector(self, name: str,
                           fn: Callable[[], dict]) -> None:
        """Register (or replace) a snapshot-time producer. ``fn()``
        returns ``{family_name: {"type", "help", "samples":
        [(labels_dict, value), ...]}}``; exceptions and dead weakref
        closures (returning None) drop the collector silently."""
        with self._lock:
            self._collectors[name] = fn

    def unregister_collector(self, name: str) -> None:
        with self._lock:
            self._collectors.pop(name, None)

    def register_object_collector(self, name: str, obj,
                                  fn: Callable[[object], dict]) -> None:
        """Collector bound to ``obj`` via weakref: auto-pruned once the
        object is garbage-collected (test suites create many short-lived
        nodes against the process-scoped default registry)."""
        ref = weakref.ref(obj)

        def collect():
            target = ref()
            if target is None:
                return None
            return fn(target)

        self.register_collector(name, collect)

    def _collected(self) -> Dict[str, dict]:
        with self._lock:
            items = list(self._collectors.items())
        out: Dict[str, dict] = {}
        dead = []
        for name, fn in items:
            try:
                doc = fn()
            except Exception:   # noqa: BLE001 — one broken producer must
                continue        # not take down the whole surface
            if doc is None:
                dead.append(name)
                continue
            for fam, spec in doc.items():
                fam = _sanitize_name(fam)
                prev = out.get(fam)
                if prev is None:
                    out[fam] = {"type": spec.get("type", "gauge"),
                                "help": spec.get("help", ""),
                                "samples": list(spec.get("samples", ()))}
                else:
                    # same family from several collectors (one per node
                    # in an in-process cluster): series MERGE — each
                    # node's samples are label-distinguished
                    prev["samples"].extend(spec.get("samples", ()))
        if dead:
            with self._lock:
                for name in dead:
                    self._collectors.pop(name, None)
        return out

    # -- exposition ----------------------------------------------------------

    def family_values(self, name: str) -> List[Tuple[dict, float]]:
        """[(labels, value)] for ONE registered counter/gauge family —
        the cheap point read for pollers (the SLO watchdog samples two
        counter families per tick; a full :meth:`metrics_doc` would
        snapshot-sort every histogram ring in the registry each time).
        Histogram families return their monotonic counts."""
        name = _sanitize_name(name)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return []
            series = [(dict(labels), m)
                      for labels, m in fam["series"].values()]
        return [(labels,
                 float(m.count if isinstance(m, Histogram) else m.value))
                for labels, m in series]

    def metrics_doc(self) -> dict:
        """JSON snapshot of the REGISTERED metrics only — no collector
        invocation (collectors may themselves read this snapshot, so the
        full :meth:`stats_doc` path must never be re-entered from one)."""
        out: Dict[str, dict] = {}
        with self._lock:
            fams = {name: (fam["type"],
                           [(dict(labels), m) for labels, m
                            in fam["series"].values()])
                    for name, fam in self._families.items()}
        for name, (kind, series) in fams.items():
            out[name] = {"type": kind, "series": [
                {"labels": labels,
                 "value": (m.snapshot() if kind == "histogram"
                           else round(m.value, 6))}
                for labels, m in series]}
        return out

    def stats_doc(self) -> dict:
        """JSON snapshot: every family → list of {labels, value} (or the
        histogram snapshot doc), registry metrics and collector families
        merged."""
        out = self.metrics_doc()
        for name, spec in self._collected().items():
            fam = {"type": spec.get("type", "gauge"), "series": [
                {"labels": dict(labels), "value": v}
                for labels, v in spec.get("samples", ())]}
            if name in out:
                out[name]["series"].extend(fam["series"])
            else:
                out[name] = fam
        return out

    def prometheus_text(self, exemplars: bool = False) -> str:
        """Text exposition format 0.0.4. Histograms render as summaries
        (quantile series + _count/_sum).

        ``exemplars=True`` (``GET /_prometheus/metrics?exemplars=true``)
        appends OpenMetrics ``# {trace_id="..."} value`` suffixes to p99
        quantile lines that have one. OFF by default: a strict 0.0.4
        parser rejects anything after the sample value, and a scrape
        that errors drops EVERY metric — so exemplars are opt-in for
        OpenMetrics-aware scrapers."""
        lines: List[str] = []
        with self._lock:
            fams = {name: (fam["type"], fam["help"],
                           [(dict(labels), m) for labels, m
                            in fam["series"].values()])
                    for name, fam in self._families.items()}
        for name, spec in self._collected().items():
            fams[name] = (spec.get("type", "gauge"), spec.get("help", ""),
                          list(spec.get("samples", ())))

        def fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
            merged = dict(labels or {})
            if extra:
                merged.update(extra)
            if not merged:
                return ""
            inner = ",".join(
                f'{_LABEL_OK.sub("_", str(k))}='
                f'"{_escape_label_value(v)}"'
                for k, v in sorted(merged.items()))
            return "{" + inner + "}"

        for name in sorted(fams):
            kind, help_, series = fams[name]
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(
                f"# TYPE {name} "
                f"{'summary' if kind == 'histogram' else kind}")
            for labels, m in series:
                if kind == "histogram":
                    snap = m.snapshot() if isinstance(m, Histogram) else m
                    for q, k in (("0.5", "p50"), ("0.99", "p99")):
                        if k in snap:
                            line = (f"{name}"
                                    f"{fmt_labels(labels, {'quantile': q})}"
                                    f" {snap[k]}")
                            ex = snap.get("exemplar") \
                                if exemplars and isinstance(snap, dict) \
                                else None
                            if q == "0.99" and ex:
                                # OpenMetrics exemplar: the p99 sample
                                # links to ONE trace id so a latency
                                # breach resolves to GET /_trace/{id}
                                line += (
                                    ' # {trace_id="'
                                    + _escape_label_value(ex["trace_id"])
                                    + f'"}} {ex["value"]}')
                            lines.append(line)
                    lines.append(
                        f"{name}_count{fmt_labels(labels)} {snap['count']}")
                    lines.append(
                        f"{name}_sum{fmt_labels(labels)} {snap['sum']}")
                else:
                    v = m.value if isinstance(m, (Counter, Gauge)) else m
                    lines.append(f"{name}{fmt_labels(labels)} {v}")
        return "\n".join(lines) + "\n"


#: PROCESS-scoped registry (documented singleton, like breakers.DEFAULT)
DEFAULT = TelemetryRegistry()


# ---------------------------------------------------------------------------
# compile / device instrumentation (the families keep the reference's
# ``es_xla_*`` names, so dashboards read both packages)
# ---------------------------------------------------------------------------

def record_compile(site: str, shape, ms: float,
                   registry: Optional[TelemetryRegistry] = None) -> None:
    """One compile (the first execution of a fresh input-shape signature
    through a step; in this package, its first launches, kernel builds
    included) at ``site`` took ``ms``. Counted total and
    per (site, shape) — the shape label is the concrete signature, so a
    compile-churn regression names the offending shape."""
    reg = registry or DEFAULT
    shape_s = str(shape)
    reg.counter("es_xla_compiles_total", {"site": site},
                help="XLA step compiles by site").inc()
    reg.counter("es_xla_compile_millis_total", {"site": site},
                help="XLA compile wall-milliseconds by site").inc(ms)
    reg.counter("es_xla_compiles_by_shape_total",
                {"site": site, "shape": shape_s},
                help="XLA step compiles by (site, shape)").inc()
    reg.counter("es_xla_compile_millis_by_shape_total",
                {"site": site, "shape": shape_s}).inc(ms)


def compile_count(registry: Optional[TelemetryRegistry] = None) -> int:
    """Total XLA compiles recorded so far (all sites) — the compile-churn
    ratchet reads this before/after a serving burst."""
    reg = registry or DEFAULT
    doc = reg.metrics_doc().get("es_xla_compiles_total")
    if not doc:
        return 0
    return int(sum(s["value"] for s in doc["series"]))


def record_transfer(h2d_bytes: int = 0, d2h_bytes: int = 0,
                    registry: Optional[TelemetryRegistry] = None) -> None:
    """Device transfer accounting for one dispatch (host→device uploads,
    device→host result fetches)."""
    reg = registry or DEFAULT
    if h2d_bytes:
        reg.counter("es_device_transfer_bytes_total",
                    {"direction": "h2d"},
                    help="bytes moved between host and device").inc(
                        h2d_bytes)
    if d2h_bytes:
        reg.counter("es_device_transfer_bytes_total",
                    {"direction": "d2h"}).inc(d2h_bytes)


def record_ann(clusters_probed: int = 0, candidates_reranked: int = 0,
               quantized_bytes: int = 0, exact_bytes: int = 0,
               below_default: bool = False,
               registry: Optional[TelemetryRegistry] = None) -> None:
    """One IVF (cluster-pruned ANN) dispatch: how much of the corpus the
    pruning actually visited. ``quantized_bytes`` is what the pruned
    int8/bf16 scan read, ``exact_bytes`` what the f32 re-rank gather
    read — their sum vs the full-corpus f32 bytes is the dispatch's
    bandwidth win (ROOFLINE.md IVF model). ``below_default`` marks a
    dispatch served under the benched nprobe — recall-config drift the
    ``plane_serving`` health indicator surfaces as yellow."""
    reg = registry or DEFAULT
    if clusters_probed:
        reg.counter("es_ann_clusters_probed_total",
                    help="IVF clusters visited (queries × nprobe)").inc(
                        clusters_probed)
    if candidates_reranked:
        reg.counter("es_ann_candidates_reranked_total",
                    help="quantized-scan survivors re-scored exactly "
                         "from the f32 tier").inc(candidates_reranked)
    if quantized_bytes:
        reg.counter("es_ann_bytes_read_total", {"tier": "quantized"},
                    help="bytes the ANN dispatch read per tier").inc(
                        quantized_bytes)
    if exact_bytes:
        reg.counter("es_ann_bytes_read_total", {"tier": "exact"}).inc(
            exact_bytes)
    if below_default:
        reg.counter("es_ann_nprobe_below_default_total",
                    help="ANN dispatches served with nprobe below the "
                         "benched default (recall-config drift)").inc()


def ann_drift_count(registry: Optional[TelemetryRegistry] = None) -> int:
    """Dispatches served below the benched nprobe so far — the health
    indicator's recall-drift signal."""
    reg = registry or DEFAULT
    doc = reg.metrics_doc().get("es_ann_nprobe_below_default_total")
    if not doc:
        return 0
    return int(sum(s["value"] for s in doc["series"]))


def record_lex(blocks_scored: int = 0, blocks_skipped: int = 0,
               quantized_bytes: int = 0, exact_bytes: int = 0,
               prune_off: bool = False,
               registry: Optional[TelemetryRegistry] = None) -> None:
    """One block-max pruned lexical dispatch: how much of the impact-
    ordered tier the rank-safe scan actually visited (the lexical mirror
    of :func:`record_ann`). ``quantized_bytes`` is what the pruned int8
    block scan read (surviving blocks + bound table), ``exact_bytes``
    what the survivor re-score read from the f32 CSR. ``prune_off``
    marks a request that explicitly forced ``prune=off`` on a
    tier-bearing plane — benched-default drift the ``plane_serving``
    health indicator surfaces as yellow."""
    reg = registry or DEFAULT
    # families are created unconditionally (zero increments included) so
    # their presence is deterministic — the telemetry lint and health
    # indicator read them on nodes whose corpora never early-exit
    reg.counter("es_lex_blocks_scored_total",
                help="block-max blocks the pruned lexical scan "
                     "scored").inc(blocks_scored)
    reg.counter("es_lex_blocks_skipped_total",
                help="block-max blocks skipped by the rank-safe "
                     "early exit").inc(blocks_skipped)
    reg.counter("es_lex_bytes_read_total", {"tier": "quantized"},
                help="bytes the lexical dispatch read per tier").inc(
                    quantized_bytes)
    reg.counter("es_lex_bytes_read_total", {"tier": "exact"}).inc(
        exact_bytes)
    reg.counter("es_lex_prune_off_total",
                help="lexical dispatches that forced prune=off on a "
                     "block-max plane (benched-default drift)").inc(
                         1 if prune_off else 0)


def record_warmed_shapes(n: int,
                         registry: Optional[TelemetryRegistry]
                         = None) -> None:
    """Warmup-lattice shape pre-compiles, PROCESS-CUMULATIVE — unlike
    the per-batcher ``warmed_shapes`` stat (which dies with its
    batcher's weakref'd collector when a generation retires), this
    counter survives repacks, so the ``compile_churn`` health window
    can credit a new generation's warmup compiles even after the old
    batcher's credit was garbage-collected. Recorded with n=0 at every
    warmup START so the family's presence is deterministic."""
    reg = registry or DEFAULT
    reg.counter("es_warmup_shapes_total",
                help="serving shapes pre-compiled by warmup lattices "
                     "(cumulative across retired generations)").inc(n)


def warmed_shapes_count(registry: Optional[TelemetryRegistry]
                        = None) -> int:
    reg = registry or DEFAULT
    doc = reg.metrics_doc().get("es_warmup_shapes_total")
    if not doc:
        return 0
    return int(sum(s["value"] for s in doc["series"]))


def record_planner(outcome: str,
                   registry: Optional[TelemetryRegistry] = None) -> None:
    """One request through the one-dispatch query planner
    (``search/query_planner.py``): ``outcome="fused"`` when the lowered
    plan actually served as a single fused dispatch, ``"fallback"``
    when the body was not lowerable or its runner could not serve it
    and the legacy two-dispatch + host-fusion path served instead."""
    reg = registry or DEFAULT
    # both label values are pre-created so the family's label space is
    # stable for the telemetry lint on nodes that only ever see one
    for oc in ("fused", "fallback"):
        reg.counter("es_planner_lowered_total", {"outcome": oc},
                    help="query-planner routing verdicts per request"
                    ).inc(1 if oc == outcome else 0)


def record_planner_dispatch(stages_n: int,
                            registry: Optional[TelemetryRegistry]
                            = None) -> None:
    """One FUSED serving dispatch: how many pipeline stages (lexical
    scan, knn scan, rank fusion, rescore reorder) it folded into the
    single program — the planner's fusion-depth distribution."""
    reg = registry or DEFAULT
    reg.histogram("es_planner_stages_per_dispatch",
                  help="retrieval stages folded into one fused "
                       "dispatch").observe(float(stages_n))


def record_agg_dispatch(stages_n: int,
                        registry: Optional[TelemetryRegistry]
                        = None) -> None:
    """One fused serving dispatch that carried aggregation stages: how
    many aggregator nodes (terms, sub-metrics, sketches, ...) rode the
    device program alongside the scoring scan."""
    reg = registry or DEFAULT
    reg.histogram("es_agg_stages_per_dispatch",
                  help="aggregation tree nodes folded into one fused "
                       "dispatch").observe(float(stages_n))


def record_agg_pairs(n: int,
                     registry: Optional[TelemetryRegistry] = None) -> None:
    """Doc-values pairs pushed through a DEVICE aggregation kernel
    (masked ordinal/bucket/register reduces) — the agg analogue of the
    postings counters on the lexical side."""
    reg = registry or DEFAULT
    reg.counter("es_agg_device_pairs_total",
                help="doc-values pairs reduced by device agg "
                     "kernels").inc(int(n))


def record_agg_sketch_merge(kind: str,
                            registry: Optional[TelemetryRegistry]
                            = None) -> None:
    """One cardinality partial folded at reduce: ``kind="hll"`` for a
    register-maximum sketch merge, ``"exact"`` for an exact value-set
    union below the precision threshold."""
    reg = registry or DEFAULT
    # pre-create both label values so the family's label space is stable
    for k in ("hll", "exact"):
        reg.counter("es_agg_sketch_merges_total", {"kind": k},
                    help="cardinality partials merged at reduce, by "
                         "representation").inc(1 if k == kind else 0)


def record_mesh_dispatch(n_shard_devices: int, n_replica_devices: int,
                         registry: Optional[TelemetryRegistry]
                         = None) -> None:
    """One device-program dispatch over the serving mesh: counts the
    dispatch's device fan-out per mesh axis (``es_mesh_dispatch_total
    {axis="shard"|"replica"}`` grows by that axis's extent), so the
    corpus-partition vs query-replication work split is visible per
    scrape interval. A 1×1 mesh grows both axes by 1 per dispatch —
    the single-device baseline."""
    reg = registry or DEFAULT
    reg.counter("es_mesh_dispatch_total", {"axis": "shard"},
                help="mesh dispatches weighted by axis extent "
                     "(devices the dispatch fanned out over)").inc(
                         max(int(n_shard_devices), 1))
    reg.counter("es_mesh_dispatch_total", {"axis": "replica"}).inc(
        max(int(n_replica_devices), 1))


def mesh_idle_devices(registry: Optional[TelemetryRegistry]
                      = None) -> int:
    """Devices the most recent search mesh left stranded
    (``es_mesh_devices{state="idle"}``) — the plane_serving health
    indicator's under-utilization signal."""
    reg = registry or DEFAULT
    doc = reg.metrics_doc().get("es_mesh_devices")
    if not doc:
        return 0
    return int(sum(s["value"] for s in doc["series"]
                   if s["labels"].get("state") == "idle"))


def lex_prune_off_count(registry: Optional[TelemetryRegistry]
                        = None) -> int:
    """Dispatches that forced prune=off on a tier-bearing plane so far —
    the plane_serving health indicator's lexical-drift signal."""
    reg = registry or DEFAULT
    doc = reg.metrics_doc().get("es_lex_prune_off_total")
    if not doc:
        return 0
    return int(sum(s["value"] for s in doc["series"]))


# ---------------------------------------------------------------------------
# cluster failover / recovery instrumentation
# ---------------------------------------------------------------------------

def record_search_retry(outcome: str, n: int = 1,
                        registry: Optional[TelemetryRegistry]
                        = None) -> None:
    """Coordinator-side copy-failover accounting for the cluster search
    fan-out: ``outcome="retried"`` per shard-group RPC that failed and
    was re-routed to another in-sync copy, ``"recovered"`` per group
    that then answered from a fallback copy, ``"exhausted"`` per shard
    whose every copy failed (it lands in the response's
    ``_shards.failures``). Every label value is pre-created so the
    family's label space is stable for the telemetry lint."""
    reg = registry or DEFAULT
    for oc in ("retried", "recovered", "exhausted"):
        reg.counter("es_search_retries_total", {"outcome": oc},
                    help="cluster search copy-failover events per "
                         "outcome").inc(n if oc == outcome else 0)


def record_shard_failover(n: int = 1,
                          registry: Optional[TelemetryRegistry]
                          = None) -> None:
    """Master-side: ``n`` shards whose primary died were failed over
    onto in-sync replica copies (routing-table promotion +
    primary-term bump)."""
    reg = registry or DEFAULT
    reg.counter("es_shard_failovers_total",
                help="primaries promoted onto in-sync replicas after "
                     "node death").inc(n)


def record_recovery_bytes(kind: str, n: int,
                          registry: Optional[TelemetryRegistry]
                          = None) -> None:
    """Bytes shipped for one recovery transfer leg: ``kind="plane"``
    for serialized serving-plane bundles (warm handoff),
    ``kind="segment"`` for translog/segment op replay."""
    reg = registry or DEFAULT
    reg.counter("es_recovery_bytes_total", {"kind": kind},
                help="recovery bytes shipped per transfer kind").inc(n)


def record_plane_handoff_ms(ms: float, exemplar: Optional[str] = None,
                            registry: Optional[TelemetryRegistry]
                            = None) -> None:
    """One completed warm plane handoff (chunked transfer + import +
    generation swap) took ``ms`` end to end on the receiving node.
    ``exemplar`` is the recovery trace id (the pull runs inside its own
    root span), so a slow handoff on a scrape links straight to
    ``GET /_trace/{id}``, as the SLO latency family's exemplars do."""
    reg = registry or DEFAULT
    reg.histogram("es_plane_handoff_ms",
                  help="warm plane handoff wall ms (transfer + import) "
                       "on the receiving node (exemplars carry the "
                       "recovery trace id)").observe(
        float(ms), exemplar=exemplar)


def record_tier_transition(op: str, to_tier: str,
                           registry: Optional[TelemetryRegistry]
                           = None) -> None:
    """One plane-generation tier transition: ``op="promote"`` with
    ``to_tier`` in (hot, warm) — a colder generation climbed a tier on
    access pressure; ``op="demote"`` with ``to_tier`` in (warm, cold)
    — the tier manager spilled a generation to fit the device/host
    budgets. Every label value is pre-created so the families' label
    spaces are stable for the telemetry lint."""
    reg = registry or DEFAULT
    for tt in ("hot", "warm"):
        reg.counter("es_plane_tier_promotions_total", {"to": tt},
                    help="plane generations promoted per destination "
                         "tier (demand promotion on access "
                         "pressure)").inc(
            1 if op == "promote" and tt == to_tier else 0)
    for tt in ("warm", "cold"):
        reg.counter("es_plane_tier_demotions_total", {"to": tt},
                    help="plane generations demoted per destination "
                         "tier (budget-pressure spill)").inc(
            1 if op == "demote" and tt == to_tier else 0)


def record_tier_stream_bytes(n: int,
                             registry: Optional[TelemetryRegistry]
                             = None) -> None:
    """Bytes streamed host→device for one warm-tier dispatch (the
    per-dispatch corpus re-upload the ``*_streamed`` roofline families
    model)."""
    reg = registry or DEFAULT
    reg.counter("es_plane_tier_stream_bytes_total",
                help="host→device bytes streamed by warm-tier "
                     "dispatches").inc(n)


#: per-thread flag: did the LAST instrumented-step call on this thread
#: compile? The dispatching thread reads it right after the call to
#: label the request's profile with compile-cache hit/miss.
_STEP_TLS = threading.local()


def last_call_compiled() -> bool:
    return bool(getattr(_STEP_TLS, "compiled", False))


def _sync_outputs(out) -> None:
    """Wait for the card to finish ``out`` (a tensor or a tuple/list of
    them): ``torch.cuda.synchronize`` on each CUDA device it names,
    nothing for host tensors."""
    import torch
    stack, devs = [out], set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devs.add(x.device)
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    for d in devs:
        torch.cuda.synchronize(d)


def instrument_step(fn, site: str,
                    registry: Optional[TelemetryRegistry] = None):
    """Wrap a device step so each FIRST execution of a new input-shape
    signature is timed (synced) and recorded as one compile (for the
    port: the kernels' first launches at that shape, builds included).
    Steady-state calls pay one tuple build + set probe (~µs) — well under
    the 2% serving-overhead budget. The first call of a shape waits for
    the card so its time lands in the compile counter, not smeared into
    the first request's fetch stage."""
    seen: set = set()
    lock = threading.Lock()

    def wrapped(*args):
        sig = tuple(getattr(a, "shape", None) for a in args)
        with lock:
            first = sig not in seen
            if first:
                seen.add(sig)
        _STEP_TLS.compiled = first
        if not first:
            return fn(*args)
        t0 = time.perf_counter()
        out = fn(*args)
        try:
            _sync_outputs(out)
        except Exception:   # noqa: BLE001 — timing stays best-effort
            pass
        record_compile(site, sig, (time.perf_counter() - t0) * 1e3,
                       registry)
        return out

    wrapped.__wrapped__ = fn
    return wrapped


#: peak allocated-device-bytes seen at any snapshot; "last"/"t" memoize
#: the read for 1s — see :func:`_live_array_bytes`
_PEAK_LOCK = threading.Lock()
_PEAK_BYTES = {"v": 0, "last": 0, "t": float("-inf")}


def _live_array_bytes() -> Tuple[int, int]:
    """(current, watermark) bytes that PyTorch's CUDA allocator holds for
    live tensors on every card (``torch.cuda.memory_allocated`` and
    ``max_memory_allocated``; 0 with no card) — shared by
    :func:`device_stats_doc` and the process "device" collector (which
    must NOT call device_stats_doc: that reads the registry snapshot,
    and a collector re-entering the snapshot path would recurse). A short
    TTL memo bounds the reads to once per second regardless of poll
    fan-out."""
    now = time.monotonic()
    with _PEAK_LOCK:
        if now - _PEAK_BYTES["t"] < 1.0:
            return _PEAK_BYTES["last"], _PEAK_BYTES["v"]
    live_bytes = peak_bytes = 0
    try:
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            for i in range(torch.cuda.device_count()):
                live_bytes += int(torch.cuda.memory_allocated(i))
                peak_bytes += int(torch.cuda.max_memory_allocated(i))
    except Exception:   # noqa: BLE001 — no card / API drift: 0
        live_bytes = peak_bytes = 0
    with _PEAK_LOCK:
        _PEAK_BYTES["v"] = max(_PEAK_BYTES["v"], peak_bytes, live_bytes)
        _PEAK_BYTES["last"] = live_bytes
        _PEAK_BYTES["t"] = now
        return live_bytes, _PEAK_BYTES["v"]


def device_stats_doc() -> dict:
    """The nodes-stats ``device`` section: per-card name and memory
    (``torch.cuda.get_device_name``, ``torch.cuda.mem_get_info``), the
    allocator's live-tensor byte total and its process-lifetime
    watermark. With no card the device list is empty."""
    doc: dict = {"devices": [], "compiles": {}, "transfer": {}}
    try:
        import torch
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    except Exception as e:   # noqa: BLE001 — no backend: empty section
        return {"devices": [], "error": str(e)[:200]}
    live_bytes, peak = _live_array_bytes()
    for i in range(n):
        ent = {"id": i, "platform": "gpu"}
        try:
            ent["kind"] = str(torch.cuda.get_device_name(i))
            free, total = torch.cuda.mem_get_info(i)
            ent["memory"] = {
                "bytes_in_use": int(torch.cuda.memory_allocated(i)),
                "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
                "bytes_limit": int(total), "bytes_free": int(free)}
        except Exception:   # noqa: BLE001 — a card that cannot be read
            pass
        doc["devices"].append(ent)
    doc["live_array_bytes"] = live_bytes
    doc["live_array_bytes_watermark"] = peak
    # compile / transfer rollups from the registry (JSON-friendly).
    # metrics_doc, NOT stats_doc: this function is itself reachable from
    # a registered collector, and invoking collectors here would recurse
    snap = DEFAULT.metrics_doc()
    comp = snap.get("es_xla_compiles_total")
    if comp:
        doc["compiles"] = {
            s["labels"].get("site", "?"): int(s["value"])
            for s in comp["series"]}
        doc["compiles"]["total"] = int(
            sum(s["value"] for s in comp["series"]))
    comp_ms = snap.get("es_xla_compile_millis_total")
    if comp_ms:
        doc["compile_millis"] = {
            s["labels"].get("site", "?"): round(s["value"], 1)
            for s in comp_ms["series"]}
    xfer = snap.get("es_device_transfer_bytes_total")
    if xfer:
        doc["transfer"] = {
            s["labels"].get("direction", "?"): int(s["value"])
            for s in xfer["series"]}
    return doc


def _ensure_process_collectors() -> None:
    """Register the process-singleton producers (breakers, indexing
    pressure) exactly once against the default registry."""
    with DEFAULT._lock:
        if "breakers" in DEFAULT._collectors:
            return

    def breakers_doc():
        from .breakers import DEFAULT as svc
        samples_used, samples_limit, samples_trip = [], [], []
        for name, st in svc.stats().items():
            lbl = {"breaker": name}
            samples_used.append((lbl, st["estimated_size_in_bytes"]))
            samples_limit.append((lbl, st["limit_size_in_bytes"]))
            samples_trip.append((lbl, st["tripped"]))
        return {
            "es_breaker_estimated_bytes": {
                "type": "gauge", "help": "circuit breaker estimated bytes",
                "samples": samples_used},
            "es_breaker_limit_bytes": {
                "type": "gauge", "samples": samples_limit},
            "es_breaker_tripped_total": {
                "type": "counter", "help": "breaker trips",
                "samples": samples_trip},
        }

    def pressure_doc():
        from .indexing_pressure import DEFAULT as ip
        return {
            "es_indexing_pressure_current_bytes": {
                "type": "gauge", "samples": [({}, ip.current_bytes)]},
            "es_indexing_pressure_total_bytes": {
                "type": "counter", "samples": [({}, ip.total_bytes)]},
            "es_indexing_pressure_rejections_total": {
                "type": "counter", "samples": [({}, ip.rejections)]},
        }

    def device_doc():
        live, peak = _live_array_bytes()
        return {
            "es_device_live_array_bytes": {
                "type": "gauge", "help": "bytes held by live device tensors",
                "samples": [({}, live)]},
            "es_device_live_array_bytes_watermark": {
                "type": "gauge", "samples": [({}, peak)]},
        }

    DEFAULT.register_collector("breakers", breakers_doc)
    DEFAULT.register_collector("indexing_pressure", pressure_doc)
    DEFAULT.register_collector("device", device_doc)


_ensure_process_collectors()
