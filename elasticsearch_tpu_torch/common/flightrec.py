"""Flight recorder: an always-on cluster event journal + SLO burn-rate
watchdog with automatic post-mortem capture.

Reference: the chaos harness (``scripts/bench_chaos.py``) proved the
cluster survives a kill-and-rejoin, but the only record of *what
happened* during the failure window was the bench's pass/fail gates.
Operators of the reference get ``hot_threads``, the health report, and
(via APM) a durable event trail; this module is that trail for the
TPU-native stack, in three parts:

- :class:`FlightRecorder` — a lock-light, bounded ring journal of
  structured events (plane swap/repack, warm-handoff manifest/chunk/
  done, search failover waves and copy exhaustion, breaker trips,
  allocation verdicts, watchdog transitions, dispatches slower than a
  settings-driven threshold). Every event is stamped with wall +
  monotonic time, the ambient ``trace.id``/task id
  (``common/tracing.py`` context), and the emitting node. The ring is
  bounded (``flightrec.journal.size`` / ``ES_TPU_FLIGHTREC_CAP``);
  evicted events are counted in ``es_flightrec_dropped_total``, kept
  events in ``es_flightrec_events_total{type}``.

- :class:`SloBurnEngine` — multi-window burn-rate evaluation (the SRE
  multi-window multi-burn-rate alert shape) over the
  ``es_query_latency_ms`` stream and a failure rate derived from
  ``es_search_retries_total``/``es_shard_failovers_total``. Burn rate =
  (bad fraction in window) / (error budget); RED requires BOTH the fast
  (~1m) and slow (~10m) windows to burn past the threshold, so a single
  p99 spike (fast-window blip) can never fire a capture, while a step-
  function degradation trips fast-then-slow in order and recovery
  clears fast-then-slow the same way.

- :class:`Watchdog` — a background thread (with a real teardown:
  :meth:`Watchdog.close` joins it — ESTP-T01) that ticks the engine,
  publishes ``es_slo_burn_rate{window}``, journals every status
  transition, and on the green/yellow→RED transition fires an automatic
  diagnostic capture — hot-threads sample, telemetry snapshot, recent
  journal slice, micro-batcher queue depths, device stats — into a
  bounded capture store (``GET /_flight_recorder/captures``), counted
  in ``es_watchdog_captures_total{trigger}``.

The journal and watchdog are PROCESS-scoped singletons (the documented
pattern of ``breakers.DEFAULT`` / ``tracing.DEFAULT_STORE``): in a real
deployment one process IS one node, so the ring is the per-node journal;
in-process multi-node test clusters share it, every event carries its
``node``, and the cluster fan-in dedupes by the process-unique ``seq``.

Lock discipline: one flat lock per structure, held for O(1) appends and
snapshot copies only; NOTHING here is called while a serving lock is
held (``estpulint`` ESTP-L02 treats this module like ``telemetry``/
``tracing`` — a recorder write under a serving-module lock is a
finding). Emission is a dict build + deque append + one counter inc.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from contextvars import ContextVar
from typing import Callable, Dict, List, Optional

import weakref

from .settings import CLUSTER_SETTINGS, Setting

__all__ = [
    "FlightRecorder", "SloBurnEngine", "Watchdog", "DEFAULT", "ENGINE",
    "record", "observe_query_latency", "bind_ambient", "reset_ambient",
    "bind_shape", "reset_shape", "set_shape", "current_shape",
    "ensure_watchdog", "get_watchdog", "register_node",
    "slow_dispatch_threshold_ms",
]

GREEN, YELLOW, RED = "green", "yellow", "red"

# -- settings (registered like common/retry.py's timeout lanes, with env
# -- overrides so benches/chaos harnesses tune per process) -----------------

SETTING_JOURNAL_SIZE = CLUSTER_SETTINGS.register(
    Setting.int_setting("flightrec.journal.size", 4096,
                        scope="cluster", dynamic=True, min_value=64))
SETTING_SLOW_DISPATCH_MS = CLUSTER_SETTINGS.register(
    Setting.float_setting("flightrec.slow_dispatch_ms", 250.0,
                          scope="cluster", dynamic=True))
SETTING_SLO_LATENCY_MS = CLUSTER_SETTINGS.register(
    Setting.float_setting("slo.latency.threshold_ms", 1000.0,
                          scope="cluster", dynamic=True))
SETTING_SLO_LATENCY_BUDGET = CLUSTER_SETTINGS.register(
    Setting.float_setting("slo.latency.budget", 0.01,
                          scope="cluster", dynamic=True))
SETTING_SLO_FAILURE_BUDGET = CLUSTER_SETTINGS.register(
    Setting.float_setting("slo.failure.budget", 0.01,
                          scope="cluster", dynamic=True))
SETTING_SLO_FAST_S = CLUSTER_SETTINGS.register(
    Setting.float_setting("slo.window.fast_seconds", 60.0,
                          scope="cluster", dynamic=True))
SETTING_SLO_SLOW_S = CLUSTER_SETTINGS.register(
    Setting.float_setting("slo.window.slow_seconds", 600.0,
                          scope="cluster", dynamic=True))
SETTING_SLO_BURN_RED = CLUSTER_SETTINGS.register(
    Setting.float_setting("slo.burn_rate.red", 8.0,
                          scope="cluster", dynamic=True))
SETTING_SLO_MIN_QUERIES = CLUSTER_SETTINGS.register(
    Setting.int_setting("slo.min_window_queries", 16,
                        scope="cluster", dynamic=True, min_value=1))


def _envf(name: str, setting) -> float:
    raw = os.environ.get(name)
    if raw is not None:
        try:
            return float(raw)
        except ValueError:
            pass
    return float(setting.default)


#: live cluster-settings overlay (``apply_cluster_settings``); env
#: overrides still win, reads/writes under the lock so a REST update
#: racing a dispatcher's threshold read is never a torn view
_SETTINGS_LOCK = threading.Lock()
_SETTINGS = None


def apply_cluster_settings(values: dict) -> None:
    """``PUT /_cluster/settings`` hook for the dynamic ``slo.*`` /
    ``flightrec.*`` knobs: re-resolve the SLO engine thresholds and
    stash the overlay for the per-call resolvers. The journal ring's
    SIZE stays fixed at construction (a deque cannot re-bound in
    place); everything else takes effect on the next tick/dispatch."""
    from .settings import Settings
    global _SETTINGS
    s = Settings(values)
    with _SETTINGS_LOCK:
        _SETTINGS = s
    ENGINE.configure(s)


def slow_dispatch_threshold_ms() -> float:
    """Micro-batch dispatches slower than this journal a
    ``slow_dispatch`` event (``ES_TPU_FLIGHTREC_SLOW_MS`` env override,
    then the live ``flightrec.slow_dispatch_ms`` cluster setting)."""
    raw = os.environ.get("ES_TPU_FLIGHTREC_SLOW_MS")
    if raw is not None:
        try:
            return float(raw)
        except ValueError:
            pass
    with _SETTINGS_LOCK:
        s = _SETTINGS
    if s is not None:
        try:
            return float(SETTING_SLOW_DISPATCH_MS.get(s))
        except Exception:   # noqa: BLE001 — malformed live value
            pass
    return float(SETTING_SLOW_DISPATCH_MS.default)


# -- ambient context (node + task id, bound at the REST edge) ---------------

#: (node_id, task_id) ambient pair — mirrors ``tracing._CTX``: bound by
#: the REST dispatcher for the request's lifetime so every emission on
#: the request path stamps both without argument plumbing
_AMBIENT: ContextVar = ContextVar("es_flightrec_ambient", default=None)


def bind_ambient(node: Optional[str] = None, task: Optional[str] = None):
    return _AMBIENT.set((node, task))


def reset_ambient(token) -> None:
    _AMBIENT.reset(token)


def ambient_node() -> Optional[str]:
    """The node id bound for the current request context, if any (the
    dispatch profiler stamps it into slots at enqueue — dispatcher
    threads carry no request context of their own)."""
    amb = _AMBIENT.get()
    return amb[0] if amb is not None else None


#: query shape id ambient holder — a single-slot MUTABLE list so the
#: shard layer can upgrade the id mid-request (the structural
#: fingerprint bound at the REST/index edge becomes the plan-based one
#: once the planner lowers the body) and every later reader — slow
#: log, task ledger, dispatch-profile slots, journal events — sees the
#: final id without re-binding the context
_SHAPE: ContextVar = ContextVar("es_flightrec_shape", default=None)


def bind_shape(shape_id: Optional[str] = None):
    """Bind a fresh shape holder for the current request; returns the
    reset token (``reset_shape`` in a finally, like ``bind_ambient``)."""
    holder = [shape_id]
    try:
        # the continuous profiler samples from a foreign thread, so it
        # cannot read this contextvar — publish the MUTABLE holder into
        # its thread->attribution map (mid-request set_shape upgrades
        # stay visible with no further hooks)
        from . import contprof as _contprof
        _contprof.note_shape_holder(holder)
    except Exception:   # noqa: BLE001 — profiling must never break
        pass            # the request binding it
    return _SHAPE.set(holder)


def reset_shape(token) -> None:
    _SHAPE.reset(token)


def set_shape(shape_id: Optional[str]) -> None:
    """Upgrade the bound holder's shape id in place (no-op when no
    holder is bound — direct shard-level calls in tests)."""
    holder = _SHAPE.get()
    if holder is not None:
        if holder[0] != shape_id:
            try:
                # profile samples folded under the early structural id
                # converge onto this final id at render time
                from . import contprof as _contprof
                _contprof.note_shape_alias(holder[0], shape_id)
            except Exception:   # noqa: BLE001 — profiling must never
                pass            # break the request
        holder[0] = shape_id


def current_shape() -> Optional[str]:
    """The query shape id bound for the current request, if any."""
    holder = _SHAPE.get()
    return holder[0] if holder is not None else None


def has_shape_holder() -> bool:
    """True when a shape holder is already bound on this context (the
    REST edge binds one per search; inner layers then upgrade it in
    place rather than shadowing it with a second scope)."""
    return _SHAPE.get() is not None


# -- the ring journal -------------------------------------------------------

_SEQ = itertools.count(1)


class FlightRecorder:
    """Bounded per-node ring journal of structured events."""

    def __init__(self, cap: Optional[int] = None, registry=None):
        if cap is None:
            cap = int(_envf("ES_TPU_FLIGHTREC_CAP", SETTING_JOURNAL_SIZE))
        self.cap = max(int(cap), 64)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.cap)
        self._dropped = 0
        self._emitted = 0
        self._registry = registry
        self._counters: Dict[str, object] = {}
        # the dropped family exists from construction so its presence is
        # deterministic for the telemetry lint (events_total appears with
        # the first emit, which the lint workload drives)
        self._reg().counter(
            "es_flightrec_dropped_total",
            help="journal events evicted from the bounded flight-recorder "
                 "ring before being read").inc(0)

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from . import telemetry as _tm
        return _tm.DEFAULT

    def emit(self, type_: str, *, node: Optional[str] = None,
             trace_id: Optional[str] = None,
             task: Optional[str] = None, **attrs) -> dict:
        """Append one structured event. O(1): dict build + locked deque
        append + one counter inc. Never raises (an observability write
        must not fail the operation it observes)."""
        try:
            from . import tracing as _tracing
            amb = _AMBIENT.get()
            if node is None and amb is not None:
                node = amb[0]
            if task is None and amb is not None:
                task = amb[1]
            if trace_id is None:
                trace_id = _tracing.current_trace_id()
            shape = current_shape()
            ev = {"seq": next(_SEQ), "type": str(type_),
                  "ts_ms": round(time.time() * 1e3, 3),
                  "mono_ms": round(time.monotonic() * 1e3, 3)}
            if node:
                ev["node"] = node
            if trace_id:
                ev["trace_id"] = trace_id
            if task:
                ev["task"] = task
            if shape:
                ev["shape"] = shape
            if attrs:
                ev["attrs"] = attrs
            with self._lock:
                evicted = len(self._ring) >= self.cap
                self._ring.append(ev)
                self._emitted += 1
                if evicted:
                    self._dropped += 1
                c = self._counters.get(type_)
            if c is None:
                c = self._reg().counter(
                    "es_flightrec_events_total", {"type": str(type_)},
                    help="flight-recorder journal events by type")
                with self._lock:
                    self._counters[type_] = c
            c.inc()
            if evicted:
                self._reg().counter("es_flightrec_dropped_total").inc()
            return ev
        except Exception:   # noqa: BLE001 — journaling is best-effort
            return {}

    def events(self, type_: Optional[str] = None,
               since_ms: Optional[float] = None,
               trace_id: Optional[str] = None,
               limit: int = 256) -> List[dict]:
        """Chronological (oldest→newest) filtered slice of the retained
        ring, capped to the NEWEST ``limit`` matches. ``type_`` may be a
        comma-separated list; ``since_ms`` is a wall epoch-ms floor."""
        types = None
        if type_:
            types = {t.strip() for t in str(type_).split(",") if t.strip()}
        with self._lock:
            snap = list(self._ring)
        out = []
        for ev in snap:
            if types is not None and ev.get("type") not in types:
                continue
            if since_ms is not None and ev.get("ts_ms", 0) < since_ms:
                continue
            if trace_id is not None and ev.get("trace_id") != trace_id:
                continue
            out.append(ev)
        if limit and limit > 0:
            out = out[-int(limit):]
        return out

    def stats_doc(self) -> dict:
        with self._lock:
            return {"retained": len(self._ring), "cap": self.cap,
                    "emitted": self._emitted, "dropped": self._dropped}


#: PROCESS-scoped journal (documented singleton, like breakers.DEFAULT)
DEFAULT = FlightRecorder()


def record(type_: str, **kw) -> dict:
    """Module entry every emission site uses: journal one event into the
    process ring (node/trace/task resolved from the ambient context
    unless passed explicitly)."""
    return DEFAULT.emit(type_, **kw)


# -- SLO burn-rate engine ---------------------------------------------------

class SloBurnEngine:
    """Multi-window burn-rate evaluation over the query-latency stream
    plus an externally-fed failure count.

    Observations aggregate into per-second buckets (bounded by the slow
    window), so a 10-minute window over production qps costs O(600)
    memory, not O(queries). All thresholds resolve from settings with
    ``ES_TPU_SLO_*`` env overrides; ``clock`` is injectable (the
    burn-rate tests drive synthetic latency streams through fake
    time)."""

    def __init__(self, *, latency_threshold_ms: Optional[float] = None,
                 latency_budget: Optional[float] = None,
                 failure_budget: Optional[float] = None,
                 fast_s: Optional[float] = None,
                 slow_s: Optional[float] = None,
                 burn_red: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.configure(
            latency_threshold_ms=latency_threshold_ms,
            latency_budget=latency_budget, failure_budget=failure_budget,
            fast_s=fast_s, slow_s=slow_s, burn_red=burn_red)
        self.clock = clock
        self._lock = threading.Lock()
        # per-second rows: [sec, queries, bad_latency, failures]
        self._buckets: deque = deque()

    def configure(self, settings=None, *,
                  latency_threshold_ms: Optional[float] = None,
                  latency_budget: Optional[float] = None,
                  failure_budget: Optional[float] = None,
                  fast_s: Optional[float] = None,
                  slow_s: Optional[float] = None,
                  burn_red: Optional[float] = None) -> None:
        """(Re-)resolve every threshold from (explicit kwarg, env
        override, ``settings`` value, registered default) — the
        ``retry.RpcTimeouts.configure`` shape, so the dynamic
        ``slo.*`` cluster settings have a live re-resolve hook instead
        of being a dead control."""
        def pick(explicit, env_name, setting):
            if explicit is not None:
                return float(explicit)
            raw = os.environ.get(env_name)
            if raw is not None:
                try:
                    return float(raw)
                except ValueError:
                    pass
            if settings is not None:
                return float(setting.get(settings))
            return float(setting.default)

        self.latency_threshold_ms = pick(
            latency_threshold_ms, "ES_TPU_SLO_LATENCY_MS",
            SETTING_SLO_LATENCY_MS)
        self.latency_budget = pick(
            latency_budget, "ES_TPU_SLO_LATENCY_BUDGET",
            SETTING_SLO_LATENCY_BUDGET)
        self.failure_budget = pick(
            failure_budget, "ES_TPU_SLO_FAILURE_BUDGET",
            SETTING_SLO_FAILURE_BUDGET)
        self.fast_s = pick(fast_s, "ES_TPU_SLO_FAST_S",
                           SETTING_SLO_FAST_S)
        self.slow_s = pick(slow_s, "ES_TPU_SLO_SLOW_S",
                           SETTING_SLO_SLOW_S)
        self.burn_red = pick(burn_red, "ES_TPU_SLO_BURN_RED",
                             SETTING_SLO_BURN_RED)
        #: a window with fewer SAMPLES than this carries no burn signal
        #: at all: one recovered RPC retry on an idle cluster must not
        #: read as a 100% failure rate and fire a capture (the
        #: single-blip invariant, volume-floored)
        self.min_window_queries = int(pick(
            None, "ES_TPU_SLO_MIN_QUERIES", SETTING_SLO_MIN_QUERIES))

    # -- feeds --------------------------------------------------------------

    def _bucket(self, now: Optional[float]):
        """The row for int(now) (caller holds the lock)."""
        sec = int(now if now is not None else self.clock())
        if self._buckets and self._buckets[-1][0] == sec:
            return self._buckets[-1]
        row = [sec, 0, 0, 0]
        self._buckets.append(row)
        floor = sec - int(self.slow_s) - 1
        while self._buckets and self._buckets[0][0] < floor:
            self._buckets.popleft()
        return row

    def observe(self, latency_ms: float,
                now: Optional[float] = None) -> None:
        """One served query's wall latency (the es_query_latency_ms
        stream)."""
        with self._lock:
            row = self._bucket(now)
            row[1] += 1
            if latency_ms > self.latency_threshold_ms:
                row[2] += 1

    def note_failures(self, n: int, now: Optional[float] = None) -> None:
        """``n`` failure events since the last feed (deltas of
        es_search_retries_total / es_shard_failovers_total, sampled by
        the watchdog tick)."""
        if n <= 0:
            return
        with self._lock:
            self._bucket(now)[3] += int(n)

    # -- evaluation ---------------------------------------------------------

    def _window(self, now: float, span_s: float):
        floor = int(now) - int(span_s)
        q = bad = fails = 0
        for sec, nq, nb, nf in self._buckets:
            if sec > floor:
                q += nq
                bad += nb
                fails += nf
        return q, bad, fails

    def burn_rates(self, now: Optional[float] = None) -> Dict[str, dict]:
        """Per-window burn rates: ``burn`` is the max of the latency and
        failure burn (each = bad fraction / its budget)."""
        t = now if now is not None else self.clock()
        with self._lock:
            out = {}
            for name, span in (("fast", self.fast_s),
                               ("slow", self.slow_s)):
                q, bad, fails = self._window(t, span)
                # the failure denominator counts COMPLETED queries plus
                # the failure events themselves: during a total outage
                # nothing completes (the latency observe happens after
                # a successful return), and a completed-only
                # denominator would leave the watchdog green through
                # the very incident it exists to capture
                denom = q + fails
                if denom < self.min_window_queries:
                    # not enough samples to judge: no burn (a lone
                    # failure event with ~zero traffic is a blip, not
                    # an incident — it would otherwise read as a 100%
                    # failure rate and trip BOTH windows at once)
                    lat_frac = fail_frac = 0.0
                else:
                    lat_frac = bad / q if q else 0.0
                    fail_frac = fails / denom
                lat_burn = lat_frac / max(self.latency_budget, 1e-9)
                fail_burn = fail_frac / max(self.failure_budget, 1e-9)
                out[name] = {
                    "queries": q, "bad_latency": bad, "failures": fails,
                    "latency_burn": round(lat_burn, 3),
                    "failure_burn": round(fail_burn, 3),
                    "burn": round(max(lat_burn, fail_burn), 3)}
        return out

    def status(self, now: Optional[float] = None) -> tuple:
        """(status, burn_rates): RED only when BOTH windows burn past
        the threshold (a fast-window blip — one p99 spike — can never go
        red alone); YELLOW when either window burns (onset, or the slow
        window still draining through recovery)."""
        rates = self.burn_rates(now)
        fast, slow = rates["fast"]["burn"], rates["slow"]["burn"]
        if fast >= self.burn_red and slow >= self.burn_red:
            return RED, rates
        if fast >= self.burn_red or slow >= self.burn_red:
            return YELLOW, rates
        return GREEN, rates


#: PROCESS-scoped engine the query-latency observation site feeds
ENGINE = SloBurnEngine()


def observe_query_latency(latency_ms: float) -> None:
    """Feed one query latency into the SLO engine (called where
    ``es_query_latency_ms`` is observed — O(1), one locked bucket
    update)."""
    ENGINE.observe(latency_ms)


# -- the watchdog -----------------------------------------------------------

#: registered node APIs whose serving surfaces captures walk (weak — a
#: retired test node must not pin itself through the watchdog)
_PROVIDERS: "weakref.WeakSet" = weakref.WeakSet()


def register_node(api) -> None:
    _PROVIDERS.add(api)


class Watchdog:
    """Ticks the SLO engine, journals transitions, and fires automatic
    diagnostic captures on the RED transition.

    Owns ONE background thread (``start()``); :meth:`close` signals and
    joins it (ESTP-T01 — the thread must never outlive its owner).
    ``tick()`` is callable directly (tests, the lint workload) without
    the thread."""

    #: capture triggers, pre-created so the counter's label space is
    #: stable for the telemetry lint
    TRIGGERS = ("slo_red", "manual")

    def __init__(self, recorder: Optional[FlightRecorder] = None,
                 engine: Optional[SloBurnEngine] = None,
                 registry=None,
                 interval_s: Optional[float] = None,
                 capture_cap: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 qos_controller=None):
        self.recorder = recorder or DEFAULT
        self.engine = engine or ENGINE
        self._registry = registry
        #: QoS controller to push overload signals to each tick (queue
        #: depth, burn status, breaker fraction → common/qos.py shed
        #: hysteresis). Injected, NOT defaulted to the process
        #: controller: test/lint watchdogs that drive synthetic RED
        #: burns must not engage shedding for every other test in the
        #: process — only ensure_watchdog's serving singleton (and
        #: benches that opt in) feed the real controller.
        self.qos_controller = qos_controller
        # default tick 5s: the windows are ~1m/~10m, so 5s still
        # samples the fast window 12x while keeping the always-on
        # thread near-inert (benches with second-scale windows set
        # ES_TPU_WATCHDOG_TICK_S down explicitly). Env parsing is
        # guarded: a malformed value must degrade to the default, not
        # crash every node constructor in the process.
        def _env_num(name, default, cast):
            try:
                return cast(os.environ.get(name, default))
            except (TypeError, ValueError):
                return cast(default)

        self.interval_s = interval_s if interval_s is not None else \
            _env_num("ES_TPU_WATCHDOG_TICK_S", "5.0", float)
        self.capture_cap = capture_cap if capture_cap is not None else \
            _env_num("ES_TPU_WATCHDOG_CAPTURES", "8", int)
        self.clock = clock
        self._lock = threading.Lock()
        self._captures: deque = deque(maxlen=max(self.capture_cap, 1))
        self._status = GREEN
        self._last_rates: Dict[str, dict] = {}
        self._fail_seen: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = self._reg()
        for t in self.TRIGGERS:
            reg.counter("es_watchdog_captures_total", {"trigger": t},
                        help="automatic post-mortem captures by "
                             "trigger").inc(0)
        for w in ("fast", "slow"):
            reg.gauge("es_slo_burn_rate", {"window": w},
                      help="SLO burn rate per evaluation window (bad "
                           "fraction / error budget; >=red threshold "
                           "in BOTH windows fires a capture)").set(0.0)

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from . import telemetry as _tm
        return _tm.DEFAULT

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Watchdog":
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                t = threading.Thread(target=self._run,
                                     name="es-watchdog-slo", daemon=True)
                self._thread = t
                t.start()
        return self

    def close(self, timeout: float = 5.0) -> None:
        """Signal and JOIN the watchdog thread (orderly teardown)."""
        self._stop.set()
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None and t.is_alive():
            t.join(timeout)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:   # noqa: BLE001 — the watchdog must
                pass            # survive any broken surface it samples

    # -- evaluation ---------------------------------------------------------

    def _failure_count(self) -> float:
        """Cumulative failure-ish events from the registry: search copy
        retries/exhaustions + master-side shard failovers. Targeted
        two-family point reads — a full registry snapshot would
        quantile-sort every histogram ring on every tick."""
        reg = self._reg()
        total = sum(
            v for labels, v in reg.family_values("es_search_retries_total")
            if labels.get("outcome") in ("retried", "exhausted"))
        total += sum(v for _labels, v in
                     reg.family_values("es_shard_failovers_total"))
        return total

    def tick(self, now: Optional[float] = None) -> str:
        """One evaluation round: fold failure-counter deltas into the
        engine, compute burn rates, publish gauges, journal transitions,
        and fire a capture on the RED transition. Returns the status."""
        t = now if now is not None else self.clock()
        fails = self._failure_count()
        with self._lock:
            seen = self._fail_seen
            self._fail_seen = fails
        if seen is not None and fails > seen:
            self.engine.note_failures(int(fails - seen), now=t)
        status, rates = self.engine.status(now=t)
        reg = self._reg()
        for w in ("fast", "slow"):
            reg.gauge("es_slo_burn_rate", {"window": w}).set(
                rates[w]["burn"])
        with self._lock:
            prev = self._status
            self._status = status
            self._last_rates = rates
        if status != prev:
            self.recorder.emit(
                "watchdog", transition=f"{prev}->{status}",
                fast_burn=rates["fast"]["burn"],
                slow_burn=rates["slow"]["burn"])
            if status == RED:
                self.capture("slo_red", rates=rates)
        total_depth = self._sample_batcher_queues()
        if self.qos_controller is not None:
            # push this tick's overload evidence into the QoS shed
            # hysteresis — the edge then reads O(1) state per request
            # instead of walking batchers itself
            try:
                self.qos_controller.note_signals(
                    queue_depth=total_depth, burn_status=status,
                    breaker_fraction=self._breaker_fraction())
            except Exception:   # noqa: BLE001 — QoS must not kill the
                pass            # tick that feeds it
        # the same tick feeds the downsampling history ring — one poll
        # cadence for every windowed consumer (lazy import: history is
        # optional for watchdog-less embedders)
        from . import metrics_history as _mh
        _mh.record_tick()
        return status

    def _sample_batcher_queues(self) -> int:
        """Periodic ``es_batcher_queue_depth{index,kind,class}`` gauges
        — queue depth was only visible inside watchdog CAPTURES before;
        sampling it on the existing tick makes the convoy signal a
        scrapeable time series with no new thread. Depths sum per
        (index, kind, priority class) over a cache's live generations
        (several generations of one index share the serving load).
        Returns the TOTAL depth across all series — the QoS shed
        signal."""
        reg = self._reg()
        depths: Dict[tuple, int] = {}
        for d in self._batcher_queues():
            by_class = d.get("by_class") or {"interactive":
                                             int(d.get("depth", 0))}
            for cls, n in by_class.items():
                key = (d.get("index"), d.get("kind", "text"), str(cls))
                depths[key] = depths.get(key, 0) + int(n)
        total = sum(depths.values())
        # series whose batcher disappeared (index deleted, cache torn
        # down) zero out instead of freezing at their last sampled
        # depth — a stale nonzero depth would alert forever on a
        # nonexistent index (zeroed once; dropped from tracking after)
        live = set(depths)
        prev = getattr(self, "_queue_depth_keys", set())
        for index, kind, cls in prev - live:
            depths[(index, kind, cls)] = 0
        self._queue_depth_keys = live
        for (index, kind, cls), depth in depths.items():
            reg.gauge(
                "es_batcher_queue_depth",
                {"index": str(index), "kind": str(kind),
                 "class": str(cls)},
                help="micro-batcher slots waiting for a dispatch by "
                     "priority class, sampled per watchdog "
                     "tick").set(depth)
        return total

    @staticmethod
    def _breaker_fraction() -> float:
        """Parent-breaker memory pressure as a 0..1 fraction (the third
        QoS shed signal, next to queue depth and burn status)."""
        try:
            from .breakers import DEFAULT as _brk
            limit = float(_brk.parent.limit)
            if limit <= 0:
                return 0.0
            return float(_brk.parent.total_used()) / limit
        except Exception:   # noqa: BLE001 — breaker-less embedder
            return 0.0

    # -- captures -----------------------------------------------------------

    def capture(self, trigger: str, rates: Optional[dict] = None) -> dict:
        """One diagnostic capture into the bounded store: hot-threads
        sample, telemetry snapshot, recent journal slice, micro-batcher
        queue depths, device stats. Runs on the watchdog thread (or the
        caller for ``manual``), NEVER on a serving path."""
        cap_id = f"cap-{next(_SEQ):08x}"
        doc: dict = {"id": cap_id, "trigger": trigger,
                     "ts_ms": round(time.time() * 1e3, 3),
                     "status": self._status,
                     "burn_rates": rates or self.engine.burn_rates()}
        try:
            from ..utils.hot_threads import hot_threads
            doc["hot_threads"] = hot_threads(
                threads=3, interval_ms=60.0, snapshots=3)
        except Exception as e:   # noqa: BLE001 — partial captures beat
            doc["hot_threads"] = f"<failed: {e}>"        # no capture
        try:
            doc["telemetry"] = self._reg().metrics_doc()
        except Exception:   # noqa: BLE001
            doc["telemetry"] = {}
        doc["journal"] = self.recorder.events(limit=128)
        doc["batcher_queues"] = self._batcher_queues()
        try:
            # attributed CPU profile slice: the live sampler's windows,
            # or a short burst when the always-on thread is gated off —
            # SLO-red post-mortems answer "where was the CPU going"
            from . import contprof as _contprof
            doc["profile"] = _contprof.capture_doc()
        except Exception:   # noqa: BLE001 — partial captures beat none
            doc["profile"] = {}
        try:
            from . import telemetry as _tm
            doc["device"] = _tm.device_stats_doc()
        except Exception:   # noqa: BLE001
            doc["device"] = {}
        with self._lock:
            self._captures.append(doc)
        self._reg().counter("es_watchdog_captures_total",
                            {"trigger": str(trigger)}).inc()
        self.recorder.emit("capture", id=cap_id, trigger=trigger)
        return doc

    @staticmethod
    def _batcher_queues() -> List[dict]:
        out = []
        try:
            providers = list(_PROVIDERS)
        except RuntimeError:    # racing a node registration: skip this
            return out          # capture's queue section, keep the rest
        for api in providers:
            try:
                for name, svc in list(api.indices.indices.items()):
                    for b in svc.plane_cache.serving_batchers():
                        doc = {
                            "node": api.node_id, "index": name,
                            "plane": type(b.plane).__name__,
                            "kind": getattr(b, "kind", "text"),
                            "depth": b.queue_depth(),
                            "dispatches": b.n_dispatches}
                        by_cls = getattr(b, "queue_depth_by_class",
                                         None)
                        if by_cls is not None:
                            # per-priority-class split (foreign
                            # batchers without it fold into
                            # class="interactive" at sampling)
                            doc["by_class"] = by_cls()
                        out.append(doc)
            except Exception:   # noqa: BLE001 — a mid-teardown node
                continue        # contributes nothing
        return out

    def captures(self) -> List[dict]:
        """Newest-last capture summaries (without the heavy payloads)."""
        with self._lock:
            snap = list(self._captures)
        return [{k: c[k] for k in ("id", "trigger", "ts_ms", "status",
                                   "burn_rates") if k in c}
                for c in snap]

    def get_capture(self, cap_id: str) -> Optional[dict]:
        with self._lock:
            for c in self._captures:
                if c["id"] == cap_id:
                    return c
        return None

    def status_doc(self) -> dict:
        with self._lock:
            return {"status": self._status,
                    "burn_rates": dict(self._last_rates),
                    "captures": len(self._captures),
                    "interval_s": self.interval_s,
                    "running": self._thread is not None
                    and self._thread.is_alive()}


# -- process singleton ------------------------------------------------------

_WATCHDOG_LOCK = threading.Lock()
_WATCHDOG: Optional[Watchdog] = None


def ensure_watchdog() -> Optional[Watchdog]:
    """Start (once) the process watchdog thread. ``ES_TPU_WATCHDOG=0``
    disables it (returns None). Idempotent — every node constructed in
    this process shares the one watchdog, the way they share the breaker
    service and the telemetry registry."""
    if os.environ.get("ES_TPU_WATCHDOG", "1").lower() in ("0", "false"):
        return None
    global _WATCHDOG
    with _WATCHDOG_LOCK:
        if _WATCHDOG is None:
            # the serving singleton feeds the process QoS controller
            # (test-constructed Watchdogs don't — see __init__)
            try:
                from . import qos as _qos
                ctl = _qos.controller()
            except Exception:   # noqa: BLE001
                ctl = None
            _WATCHDOG = Watchdog(qos_controller=ctl)
            _WATCHDOG.start()
        return _WATCHDOG


def get_watchdog() -> Optional[Watchdog]:
    with _WATCHDOG_LOCK:
        return _WATCHDOG
