"""Multi-tenant QoS: token-bucket admission control, priority classes,
and edge load shedding.

The ``es_tenant_*`` metering, the task ledger, and the SLO burn engine
all *measure* per-tenant cost and overload; this module
*acts* on them, closing the measure→enforce gap in three layers:

- **Admission control** — per-tenant (``X-Opaque-Id``) token buckets,
  charged **post-paid** from the task ledger's *actual* cpu-ms /
  device-ms / transfer bytes when the task completes
  (``TaskManager._fold_resources`` → :meth:`QosController.charge`), not
  from request counts. A bucket may go negative (debt); the next
  admission check rejects (HTTP 429 + ``Retry-After``) until refill
  pays the debt back. Cost is normalized to "ms-equivalents":
  ``cpu_ms + device_weight x device_ms + bytes / bytes_per_unit``.

- **Priority classes** — every data-path request is classified
  ``interactive`` / ``bulk`` / ``analytics`` from the same normalized
  body sections the query-shape fingerprint keeps (aggs /
  ``size: 0`` → analytics; bulk-ish actions → bulk), overridable per
  request via the ``x-es-priority`` header. The class rides the request
  context (:func:`bind_priority` / :func:`current_priority`) so the
  micro-batcher's slots capture it at enqueue with no argument
  plumbing — and it is a *selection* key only, never a jit shape key.

- **Load shedding** — the watchdog tick pushes overload signals here
  (:meth:`QosController.note_signals`: total batcher queue depth, SLO
  burn status, parent-breaker fraction); the controller engages
  shedding when any signal trips its threshold and clears it with
  hysteresis (all signals below ``clear_fraction`` of their
  thresholds). While engaged, bulk/analytics requests shed at the REST
  edge; interactive requests shed only under *severe* pressure (queue
  depth ≥ 2x the trip threshold). Every shed/throttle decision
  journals a ``qos_shed`` / ``qos_throttle`` flight-recorder event
  carrying tenant, trigger evidence, and (ambient) trace id, so "why
  was I 429'd?" is answerable from ``/_flight_recorder?trace_id=``.

Settings resolve env var → live cluster-settings overlay → default
(the ``slo.*`` pattern from ``common/flightrec.py``); ``PUT
/_cluster/settings`` with ``qos.*`` keys reconfigures live.

Telemetry/journal writes here are O(1) under this module's own locks —
never under a serving lock (ESTP-L02).
"""

from __future__ import annotations

import contextvars
import math
import os
import threading
import time
from typing import Dict, NamedTuple, Optional

from . import telemetry
from .errors import ElasticsearchError
from .settings import CLUSTER_SETTINGS, Setting, Settings

__all__ = [
    "PRIORITIES", "DEFAULT_PRIORITY", "classify", "bind_priority",
    "unbind_priority", "current_priority", "priority_weight",
    "QosController", "QosRejectedError", "Decision", "controller",
    "reset_controller", "apply_cluster_settings", "qos_enabled",
]

# ---------------------------------------------------------------------------
# Priority classes
# ---------------------------------------------------------------------------

#: the three service classes, best-effort last
PRIORITIES = ("interactive", "bulk", "analytics")
DEFAULT_PRIORITY = "interactive"

#: weighted-deficit shares for the micro-batcher's class selection —
#: interactive accrues deficit 4x as fast, so under contention it wins
#: ~4 of every 6 dispatch rounds while bulk/analytics still drain
PRIORITY_WEIGHTS = {"interactive": 4.0, "bulk": 1.0, "analytics": 1.0}


def priority_weight(cls: str) -> float:
    return PRIORITY_WEIGHTS.get(cls, 1.0)


#: the request's priority class, bound by the REST edge for the
#: request's lifetime (mirrors task_manager._RES_CTX)
_PRIORITY_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "es_qos_priority", default=None)


def bind_priority(cls: str):
    """Bind the request's priority class; returns the reset token."""
    return _PRIORITY_CTX.set(cls if cls in PRIORITIES
                             else DEFAULT_PRIORITY)


def unbind_priority(token) -> None:
    _PRIORITY_CTX.reset(token)


def current_priority() -> str:
    return _PRIORITY_CTX.get() or DEFAULT_PRIORITY


#: the actions classified as bulk when no override says otherwise
_BULK_ACTION_MARKERS = ("write/bulk", "write/reindex", "byquery",
                       "scroll")


def classify(action: str = "", body: Optional[dict] = None,
             override: Optional[str] = None) -> str:
    """Infer a request's priority class. The explicit ``x-es-priority``
    override wins; bulk-ish actions (bulk, reindex, by-query, scroll)
    are ``bulk``; bodies whose fingerprint-retained sections say
    "aggregation scan" (``aggs``/``aggregations`` present, or
    ``size: 0``) are ``analytics``; everything else — point lookups,
    top-k text/knn/fused search — is ``interactive``. Never raises."""
    if override:
        o = str(override).strip().lower()
        if o in PRIORITIES:
            return o
    a = str(action or "")
    if any(m in a for m in _BULK_ACTION_MARKERS):
        return "bulk"
    if isinstance(body, dict):
        try:
            if body.get("aggs") or body.get("aggregations"):
                return "analytics"
            if body.get("size") == 0:
                return "analytics"
        except Exception:   # noqa: BLE001 — malformed body: default
            pass
    return DEFAULT_PRIORITY


# ---------------------------------------------------------------------------
# Settings (env var → live overlay → default — the slo.* pattern)
# ---------------------------------------------------------------------------

SETTING_REFILL = CLUSTER_SETTINGS.register(Setting.float_setting(
    "qos.tenant.refill_per_s", 500.0, scope="cluster", dynamic=True))
SETTING_BURST = CLUSTER_SETTINGS.register(Setting.float_setting(
    "qos.tenant.burst", 5000.0, scope="cluster", dynamic=True))
SETTING_DEVICE_WEIGHT = CLUSTER_SETTINGS.register(Setting.float_setting(
    "qos.tenant.device_weight", 4.0, scope="cluster", dynamic=True))
SETTING_BYTES_PER_UNIT = CLUSTER_SETTINGS.register(Setting.float_setting(
    "qos.tenant.bytes_per_unit", float(1 << 20), scope="cluster",
    dynamic=True))
SETTING_SHED_QUEUE = CLUSTER_SETTINGS.register(Setting.int_setting(
    "qos.shed.queue_depth", 256, scope="cluster", dynamic=True,
    min_value=1))
SETTING_SHED_BREAKER = CLUSTER_SETTINGS.register(Setting.float_setting(
    "qos.shed.breaker_fraction", 0.9, scope="cluster", dynamic=True))
SETTING_SHED_CLEAR = CLUSTER_SETTINGS.register(Setting.float_setting(
    "qos.shed.clear_fraction", 0.5, scope="cluster", dynamic=True))
SETTING_SHED_SUSTAINED_S = CLUSTER_SETTINGS.register(Setting.float_setting(
    "qos.shed.sustained_seconds", 30.0, scope="cluster", dynamic=True))
SETTING_RETRY_AFTER_S = CLUSTER_SETTINGS.register(Setting.float_setting(
    "qos.retry_after_seconds", 1.0, scope="cluster", dynamic=True))

_SETTINGS_LOCK = threading.Lock()
_SETTINGS: Optional[Settings] = None


def apply_cluster_settings(values: dict) -> None:
    """Install the live ``qos.*`` overlay (called by ``PUT
    /_cluster/settings`` alongside the ``slo.*`` apply)."""
    global _SETTINGS
    s = Settings(values)
    with _SETTINGS_LOCK:
        _SETTINGS = s


def _resolve(env_name: str, setting: Setting, cast=float):
    raw = os.environ.get(env_name)
    if raw is not None:
        try:
            return cast(raw)
        except (TypeError, ValueError):
            pass
    with _SETTINGS_LOCK:
        s = _SETTINGS
    if s is not None:
        try:
            return setting.get(s)
        except Exception:   # noqa: BLE001 — bad overlay value: default
            pass
    return setting.default


def qos_enabled() -> bool:
    """Master on/off gate (``ES_TPU_QOS`` env; default on). The bench's
    QoS-off arm uses this to measure the unprotected collapse."""
    return os.environ.get("ES_TPU_QOS", "1").lower() \
        not in ("0", "false")


def refill_per_s() -> float:
    return float(_resolve("ES_TPU_QOS_REFILL_PER_S", SETTING_REFILL))


def burst() -> float:
    return float(_resolve("ES_TPU_QOS_BURST", SETTING_BURST))


def device_weight() -> float:
    return float(_resolve("ES_TPU_QOS_DEVICE_WEIGHT",
                          SETTING_DEVICE_WEIGHT))


def bytes_per_unit() -> float:
    return max(1.0, float(_resolve("ES_TPU_QOS_BYTES_PER_UNIT",
                                   SETTING_BYTES_PER_UNIT)))


def shed_queue_depth() -> int:
    return max(1, int(_resolve("ES_TPU_QOS_SHED_QUEUE_DEPTH",
                               SETTING_SHED_QUEUE, cast=int)))


def shed_breaker_fraction() -> float:
    return float(_resolve("ES_TPU_QOS_SHED_BREAKER_FRACTION",
                          SETTING_SHED_BREAKER))


def shed_clear_fraction() -> float:
    return float(_resolve("ES_TPU_QOS_SHED_CLEAR_FRACTION",
                          SETTING_SHED_CLEAR))


def shed_sustained_seconds() -> float:
    return float(_resolve("ES_TPU_QOS_SHED_SUSTAINED_S",
                          SETTING_SHED_SUSTAINED_S))


def retry_after_seconds() -> float:
    return float(_resolve("ES_TPU_QOS_RETRY_AFTER_S",
                          SETTING_RETRY_AFTER_S))


def cost_units(cpu_ms: float = 0.0, device_ms: float = 0.0,
               bytes_: float = 0.0) -> float:
    """Ledger actuals → bucket cost in ms-equivalents. Device time is
    weighted up (it is the scarce resource); transfer bytes convert at
    ``bytes_per_unit`` per ms-equivalent."""
    return (float(cpu_ms) + device_weight() * float(device_ms)
            + float(bytes_) / bytes_per_unit())


# ---------------------------------------------------------------------------
# Decisions / errors
# ---------------------------------------------------------------------------

class Decision(NamedTuple):
    """One admission verdict. ``kind`` is ``"throttle"`` (per-tenant
    token debt) or ``"shed"`` (global overload) when rejected."""

    allowed: bool
    reason: str
    retry_after_s: float = 0.0
    kind: Optional[str] = None
    evidence: dict = {}


class QosRejectedError(ElasticsearchError):
    """HTTP 429 with ``Retry-After`` — raised by the REST edge when a
    request is throttled or shed. The ``header`` metadata rides the
    error body AND is promoted to real response headers (the
    WWW-Authenticate path)."""

    status = 429
    error_type = "qos_rejected_exception"

    def __init__(self, reason: str, decision: "Decision",
                 tenant: Optional[str] = None):
        retry = str(int(max(1, math.ceil(decision.retry_after_s or 1.0))))
        meta = {"header": {"Retry-After": [retry]},
                "qos": {"kind": decision.kind,
                        "reason": decision.reason,
                        "retry_after_seconds": float(retry)}}
        if tenant:
            meta["qos"]["tenant"] = str(tenant)
        super().__init__(reason, **meta)
        self.decision = decision


# ---------------------------------------------------------------------------
# Controller
# ---------------------------------------------------------------------------

class _Bucket:
    __slots__ = ("tokens", "last", "charged")

    def __init__(self, cap: float, now: float):
        self.tokens = cap
        self.last = now
        self.charged = 0.0


class QosController:
    """Per-process QoS state: tenant token buckets + the shed state
    machine. Thread-safe; all operations are O(1) dict work under this
    module's own locks."""

    #: tracked tenant buckets — past the cap the *fullest* bucket is
    #: evicted (it is the least at risk of losing throttle state)
    MAX_TENANTS = 256

    def __init__(self, registry: Optional[telemetry.TelemetryRegistry]
                 = None, clock=time.monotonic):
        self._clock = clock
        self._reg = registry or telemetry.DEFAULT
        self._lock = threading.Lock()           # buckets
        self._buckets: Dict[str, _Bucket] = {}
        self._shed_lock = threading.Lock()      # shed state machine
        self.engaged = False
        self.engaged_since: Optional[float] = None
        self.signals: Dict[str, object] = {}
        self.signals_ts: Optional[float] = None
        self.sheds_total = 0
        self.throttled_total = 0
        self.admitted_total = 0
        self.engagements = 0
        self.cleared_total = 0
        self._sheds_by_tenant: Dict[str, int] = {}
        # pre-create the families so the catalogue lint always sees
        # them with a stable label space (the watchdog pattern)
        self._reg.counter(
            "es_qos_admitted_total", {"tenant": "_any", "reason": "ok"},
            help="data-path requests admitted past QoS").inc(0)
        self._reg.counter(
            "es_qos_shed_total", {"tenant": "_any", "reason": "overload"},
            help="requests shed (429) at the edge under overload").inc(0)
        self._reg.counter(
            "es_qos_throttled_total", {"tenant": "_any",
                                       "reason": "tokens"},
            help="requests throttled (429) on tenant token debt").inc(0)
        self._reg.gauge(
            "es_qos_tokens", {"tenant": "_any"},
            help="tenant token-bucket level in ms-equivalents "
                 "(negative = debt)").set(0.0)

    # -- token buckets -------------------------------------------------------

    def _bucket_locked(self, tenant: str, now: float) -> _Bucket:
        b = self._buckets.get(tenant)
        if b is None:
            if len(self._buckets) >= self.MAX_TENANTS:
                evict = max(self._buckets,
                            key=lambda t: self._buckets[t].tokens)
                self._buckets.pop(evict, None)
            b = self._buckets[tenant] = _Bucket(burst(), now)
        return b

    @staticmethod
    def _refill_locked(b: _Bucket, now: float) -> None:
        b.tokens = min(burst(),
                       b.tokens + max(0.0, now - b.last) * refill_per_s())
        b.last = now

    def charge(self, tenant: Optional[str], *, cpu_ms: float = 0.0,
               device_ms: float = 0.0, bytes_: float = 0.0) -> None:
        """Post-paid charge: fold a completed task's ledger actuals into
        the tenant's bucket (may push it into debt). Never raises."""
        if not tenant or not qos_enabled():
            return
        try:
            cost = cost_units(cpu_ms, device_ms, bytes_)
            now = self._clock()
            with self._lock:
                b = self._bucket_locked(str(tenant), now)
                self._refill_locked(b, now)
                b.tokens -= cost
                b.charged += cost
                level = b.tokens
            self._reg.gauge("es_qos_tokens",
                            {"tenant": str(tenant)}).set(round(level, 3))
        except Exception:   # noqa: BLE001 — QoS must not fail teardown
            pass

    def tokens(self, tenant: str) -> float:
        """The tenant's current (refilled) bucket level."""
        now = self._clock()
        with self._lock:
            b = self._bucket_locked(str(tenant), now)
            self._refill_locked(b, now)
            return b.tokens

    # -- shed state machine --------------------------------------------------

    def note_signals(self, *, queue_depth: Optional[int] = None,
                     burn_status: Optional[str] = None,
                     breaker_fraction: Optional[float] = None) -> None:
        """Fold fresh overload signals (pushed from the watchdog tick)
        and run the engage/clear hysteresis. Transition events journal
        OUTSIDE the lock."""
        now = self._clock()
        transition = None
        with self._shed_lock:
            if queue_depth is not None:
                self.signals["queue_depth"] = int(queue_depth)
            if burn_status is not None:
                # watchdog statuses are lowercase ("green"/"red")
                self.signals["burn_status"] = str(burn_status).lower()
            if breaker_fraction is not None:
                self.signals["breaker_fraction"] = round(
                    float(breaker_fraction), 4)
            self.signals_ts = now
            qd = int(self.signals.get("queue_depth", 0))
            bf = float(self.signals.get("breaker_fraction", 0.0))
            burn = str(self.signals.get("burn_status", "green")).lower()
            qd_limit = shed_queue_depth()
            bf_limit = shed_breaker_fraction()
            clear_f = shed_clear_fraction()
            trip = (qd >= qd_limit or bf >= bf_limit or burn == "red")
            clear = (qd <= qd_limit * clear_f
                     and bf <= bf_limit * clear_f and burn != "red")
            if not self.engaged and trip:
                self.engaged = True
                self.engaged_since = now
                self.engagements += 1
                transition = "engage"
            elif self.engaged and clear:
                self.engaged = False
                self.engaged_since = None
                self.cleared_total += 1
                transition = "clear"
            evidence = dict(self.signals)
        if transition is not None:
            from . import flightrec as _fr
            _fr.record("qos_shed", transition=transition, **evidence)

    def _shed_verdict(self, priority: str) -> Optional[Decision]:
        with self._shed_lock:
            if not self.engaged:
                return None
            sig = dict(self.signals)
        qd_limit = shed_queue_depth()
        severe = int(sig.get("queue_depth", 0)) >= 2 * qd_limit
        if priority == DEFAULT_PRIORITY and not severe:
            # interactive traffic keeps flowing under ordinary
            # engagement — the whole point of the priority split
            return None
        return Decision(False, "overload", retry_after_seconds(),
                        "shed", sig)

    # -- admission -----------------------------------------------------------

    def admit(self, tenant: Optional[str] = None,
              priority: str = DEFAULT_PRIORITY,
              action: str = "") -> Decision:
        """The edge's one call per data-path request: shed check (global
        overload), then per-tenant token check. Counts + journals every
        rejection with its trigger evidence."""
        if not qos_enabled():
            return Decision(True, "disabled")
        t = str(tenant) if tenant else None
        tl = t or "_anonymous"
        shed = self._shed_verdict(priority)
        if shed is not None:
            with self._shed_lock:
                self.sheds_total += 1
                if t is not None:
                    key = t if (t in self._sheds_by_tenant
                                or len(self._sheds_by_tenant)
                                < self.MAX_TENANTS) else "overflow"
                    self._sheds_by_tenant[key] = \
                        self._sheds_by_tenant.get(key, 0) + 1
            self._reg.counter("es_qos_shed_total",
                              {"tenant": tl, "reason": "overload"}).inc()
            from . import flightrec as _fr
            _fr.record("qos_shed", tenant=tl, reason="overload",
                       priority=priority, action=action,
                       retry_after_s=shed.retry_after_s, **shed.evidence)
            return shed
        if t is not None:
            now = self._clock()
            with self._lock:
                b = self._bucket_locked(t, now)
                self._refill_locked(b, now)
                level = b.tokens
            if level < 0.0:
                rate = refill_per_s()
                retry = max(retry_after_seconds(),
                            (-level) / rate if rate > 0 else 0.0)
                with self._shed_lock:
                    self.throttled_total += 1
                self._reg.counter(
                    "es_qos_throttled_total",
                    {"tenant": t, "reason": "tokens"}).inc()
                from . import flightrec as _fr
                _fr.record("qos_throttle", tenant=t, reason="tokens",
                           priority=priority, action=action,
                           tokens=round(level, 3), retry_after_s=retry)
                return Decision(False, "tokens", retry, "throttle",
                                {"tokens": round(level, 3)})
        with self._shed_lock:
            self.admitted_total += 1
        self._reg.counter("es_qos_admitted_total",
                          {"tenant": tl, "reason": "ok"}).inc()
        return Decision(True, "ok")

    # -- introspection -------------------------------------------------------

    def status_doc(self) -> dict:
        """The health indicator's / ``_cluster`` surface's read."""
        now = self._clock()
        with self._shed_lock:
            engaged_for = (now - self.engaged_since) \
                if (self.engaged and self.engaged_since is not None) \
                else 0.0
            by_tenant = sorted(self._sheds_by_tenant.items(),
                               key=lambda kv: -kv[1])[:8]
            doc = {
                "enabled": qos_enabled(),
                "engaged": self.engaged,
                "engaged_for_s": round(engaged_for, 3),
                "sustained": bool(
                    self.engaged
                    and engaged_for >= shed_sustained_seconds()),
                "signals": dict(self.signals),
                "sheds_total": self.sheds_total,
                "throttled_total": self.throttled_total,
                "admitted_total": self.admitted_total,
                "engagements": self.engagements,
                "cleared_total": self.cleared_total,
                "sheds_by_tenant": dict(by_tenant),
            }
        with self._lock:
            doc["tenants_tracked"] = len(self._buckets)
            doc["tenants_in_debt"] = sorted(
                t for t, b in self._buckets.items() if b.tokens < 0.0)[:8]
        return doc


# -- process singleton ------------------------------------------------------

_CONTROLLER_LOCK = threading.Lock()
_CONTROLLER: Optional[QosController] = None


def controller() -> QosController:
    """The process QoS controller, created on first touch — every node
    in this process shares it, the way they share the breaker service
    and the telemetry registry."""
    global _CONTROLLER
    with _CONTROLLER_LOCK:
        if _CONTROLLER is None:
            _CONTROLLER = QosController()
        return _CONTROLLER


def reset_controller() -> None:
    """Drop the process controller (tests / bench arm isolation)."""
    global _CONTROLLER
    with _CONTROLLER_LOCK:
        _CONTROLLER = None
