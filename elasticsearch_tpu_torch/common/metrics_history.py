"""Windowed metrics history: a bounded in-memory downsampling ring.

The SLO burn engine (``common/flightrec.py``) hand-rolls one per-second
bucket ring for exactly two signals; every other ``es_*`` family is a
point-in-time read with no past. This module generalizes those buckets
into the time-series input every future controller decision (ROADMAP
item 4 — rebalance by cost, not count) needs:

- :class:`MetricsHistory` records a SELECTED list of counter/gauge
  families once per watchdog tick via
  :meth:`TelemetryRegistry.family_values` — the cheap point read; a
  tick never snapshot-sorts histogram rings (histogram families record
  their monotonic counts).
- Samples land in three downsampling tiers per series:
  **raw** (one point per tick, default 256 points), **10s** (last
  value per 10-second bucket, default 360 points ≈ 1 h), and **1m**
  (last value per minute, default 1440 points ≈ 24 h). Memory is
  bounded by ``families x series x tier caps``.
- :meth:`doc` serves ``GET /_telemetry/history?family=&window=`` with
  ``rate=true`` support: per-second derivatives between consecutive
  retained points, clamped at zero so counter resets (process restart)
  read as silence, not negative rates.

The clock is injectable (the SLO-parity test drives a fake clock
through the engine and the history side by side); recording never
raises and takes only this module's own lock — no serving lock is ever
held here (ESTP-L02 lists this module with ``common/telemetry``).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import telemetry
from .settings import CLUSTER_SETTINGS, Setting

__all__ = ["MetricsHistory", "DEFAULT", "record_tick",
           "default_families", "TIERS"]

#: (window name, bucket seconds, default retained points). ``raw``
#: keeps one point per tick (bucket 0 = no alignment).
TIERS = (("raw", 0.0, 256), ("10s", 10.0, 360), ("1m", 60.0, 1440))

SETTING_RAW_POINTS = CLUSTER_SETTINGS.register(
    Setting.int_setting("history.raw_points", 256,
                        scope="cluster", dynamic=False, min_value=16))
SETTING_10S_POINTS = CLUSTER_SETTINGS.register(
    Setting.int_setting("history.10s_points", 360,
                        scope="cluster", dynamic=False, min_value=16))
SETTING_1M_POINTS = CLUSTER_SETTINGS.register(
    Setting.int_setting("history.1m_points", 1440,
                        scope="cluster", dynamic=False, min_value=16))

#: families recorded when no explicit selection is configured — the
#: SLO inputs plus the cost/backlog signals the controller loop reads
DEFAULT_FAMILIES = (
    "es_search_retries_total",
    "es_shard_failovers_total",
    "es_slo_burn_rate",
    "es_query_latency_ms",
    "es_tasks_running",
    "es_tenant_requests_total",
    "es_tenant_device_millis_total",
    "es_plane_serving_queries_total",
    "es_batcher_queue_depth",
    "es_insight_observations_total",
)


def default_families() -> Tuple[str, ...]:
    """The recorded family selection: ``ES_TPU_HISTORY_FAMILIES`` (CSV)
    overrides the built-in list."""
    raw = os.environ.get("ES_TPU_HISTORY_FAMILIES")
    if raw:
        fams = tuple(f.strip() for f in raw.split(",") if f.strip())
        if fams:
            return fams
    return DEFAULT_FAMILIES


def _tier_caps() -> Dict[str, int]:
    caps = {}
    for (name, _bucket, dflt), env, setting in zip(
            TIERS,
            ("ES_TPU_HISTORY_RAW_POINTS", "ES_TPU_HISTORY_10S_POINTS",
             "ES_TPU_HISTORY_1M_POINTS"),
            (SETTING_RAW_POINTS, SETTING_10S_POINTS,
             SETTING_1M_POINTS)):
        raw = os.environ.get(env)
        cap = None
        if raw is not None:
            try:
                cap = max(16, int(raw))
            except ValueError:
                cap = None
        caps[name] = cap if cap is not None else int(setting.default)
    return caps


class _Series:
    """One (family, labels) time-series: a deque per tier of
    ``(ts, value)`` points. 10s/1m tiers keep the LAST value seen in
    each aligned bucket — right for gauges, and for monotonic counters
    rate computation between bucket-end points is exact."""

    __slots__ = ("labels", "tiers")

    def __init__(self, labels: dict, caps: Dict[str, int]):
        self.labels = labels
        self.tiers: Dict[str, deque] = {
            name: deque(maxlen=caps[name]) for name, _b, _c in TIERS}

    def append(self, ts: float, value: float) -> None:
        for name, bucket, _cap in TIERS:
            ring = self.tiers[name]
            if bucket <= 0:
                ring.append((ts, value))
                continue
            aligned = int(ts // bucket) * bucket
            if ring and ring[-1][0] == aligned:
                ring[-1] = (aligned, value)
            else:
                ring.append((aligned, value))


class MetricsHistory:
    """Bounded multi-tier history over selected registry families."""

    #: distinct (family, labels) series cap — overflow drops NEW series
    #: (the registry's own MAX_SERIES bounds labels per family already)
    MAX_SERIES = 1024

    def __init__(self,
                 registry: Optional[telemetry.TelemetryRegistry] = None,
                 families: Optional[Tuple[str, ...]] = None,
                 clock=time.time,
                 caps: Optional[Dict[str, int]] = None):
        self._registry = registry
        self.families = tuple(families) if families is not None \
            else default_families()
        self._clock = clock
        self._caps = dict(caps) if caps is not None else _tier_caps()
        self._lock = threading.Lock()
        # family -> labels_key -> _Series
        self._series: Dict[str, Dict[tuple, _Series]] = {}
        self._ticks = 0
        self._dropped_series = 0

    def _reg(self) -> telemetry.TelemetryRegistry:
        return self._registry or telemetry.DEFAULT

    # -- write path ---------------------------------------------------------

    def record(self, now: Optional[float] = None) -> int:
        """One sampling round over the selected families; returns the
        number of points appended. Rides the watchdog tick; never
        raises."""
        try:
            ts = float(now) if now is not None else self._clock()
            reg = self._reg()
            appended = 0
            n_series = 0
            for family in self.families:
                try:
                    values = reg.family_values(family)
                except Exception:   # noqa: BLE001 — one bad family
                    continue        # must not starve the rest
                if not values:
                    continue
                with self._lock:
                    fam_series = self._series.setdefault(family, {})
                    for labels, value in values:
                        key = tuple(sorted(labels.items()))
                        series = fam_series.get(key)
                        if series is None:
                            if self._n_series_locked() >= \
                                    self.MAX_SERIES:
                                self._dropped_series += 1
                                continue
                            series = fam_series[key] = _Series(
                                dict(labels), self._caps)
                        series.append(ts, float(value))
                        appended += 1
            with self._lock:
                self._ticks += 1
                n_series = self._n_series_locked()
            reg.counter("es_history_samples_total",
                        help="points appended to the metrics-history "
                             "ring").inc(appended)
            reg.gauge("es_history_series",
                      help="distinct (family, labels) series retained "
                           "in the metrics-history ring").set(n_series)
            return appended
        except Exception:   # noqa: BLE001 — history must not fail the tick
            return 0

    def _n_series_locked(self) -> int:
        return sum(len(s) for s in self._series.values())

    # -- read path ----------------------------------------------------------

    def doc(self, family: str, window: str = "raw",
            since: Optional[float] = None, rate: bool = False,
            labels: Optional[dict] = None) -> dict:
        """The ``GET /_telemetry/history`` payload for ONE family:
        every retained series (optionally filtered to label subsets
        containing ``labels``) in the requested tier, newest-last
        ``[ts, value]`` points; ``rate=True`` replaces points with
        per-second derivatives between consecutive retained points
        (clamped >= 0 so counter resets read as gaps, not negatives)."""
        if window not in {t[0] for t in TIERS}:
            window = "raw"
        with self._lock:
            fam_series = self._series.get(family, {})
            snap = [(s.labels, list(s.tiers[window]))
                    for s in fam_series.values()]
        out_series = []
        for lbls, points in snap:
            if labels and any(lbls.get(k) != v
                              for k, v in labels.items()):
                continue
            if since is not None:
                points = [p for p in points if p[0] >= since]
            if rate:
                points = _rate_points(points)
            out_series.append(
                {"labels": lbls,
                 "points": [[round(ts, 3), round(v, 6)]
                            for ts, v in points]})
        return {"family": family, "window": window, "rate": bool(rate),
                "series": out_series}

    def windowed_delta(self, family: str, span_s: float,
                       now: Optional[float] = None,
                       window: str = "raw",
                       label_filter: Optional[dict] = None) -> float:
        """Sum over matching series of (last value - value at/just
        before ``now - span_s``) — the windowed counter delta a burn-
        rate style consumer needs. Series with no point old enough use
        their oldest retained point (the delta is then a floor)."""
        t = float(now) if now is not None else self._clock()
        doc = self.doc(family, window=window, labels=label_filter)
        total = 0.0
        floor_ts = t - float(span_s)
        for series in doc["series"]:
            points = series["points"]
            if not points:
                continue
            base = points[0][1]
            for ts, v in points:
                if ts > floor_ts:
                    break
                base = v
            total += max(points[-1][1] - base, 0.0)
        return total

    def stats_doc(self) -> dict:
        with self._lock:
            return {"families": list(self.families),
                    "ticks": self._ticks,
                    "series": self._n_series_locked(),
                    "dropped_series": self._dropped_series,
                    "tiers": {name: {"bucket_seconds": bucket,
                                     "points": self._caps[name]}
                              for name, bucket, _cap in TIERS}}


def _rate_points(points: List[tuple]) -> List[tuple]:
    out = []
    for (t0, v0), (t1, v1) in zip(points, points[1:]):
        dt = t1 - t0
        if dt <= 0:
            continue
        out.append((t1, max(v1 - v0, 0.0) / dt))
    return out


#: PROCESS-scoped history (the flightrec.DEFAULT singleton pattern) —
#: fed by the watchdog tick; in-process multi-node clusters share it
DEFAULT = MetricsHistory()


def record_tick(now: Optional[float] = None) -> int:
    """Module entry the watchdog tick uses."""
    return DEFAULT.record(now)
