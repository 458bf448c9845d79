"""Hierarchical circuit breakers: real memory accounting with trips.

Reference: ``common/breaker/CircuitBreaker.java`` +
``indices/breaker/HierarchyCircuitBreakerService.java:62`` — every
allocation-heavy operation (agg bucket growth, fielddata loads, serving
plane construction) estimates its bytes against a child breaker; the
parent breaker bounds the sum. A trip raises
``CircuitBreakingError`` (429) instead of letting the node OOM.

The byte budget is a configured ceiling, not a JVM heap: host memory
pressure comes from numpy columns and reduce-time bucket trees, and the
``accounting`` child holds the serving planes' device bytes. Default budget 1 GiB, overridable via the
``indices.breaker.total.limit`` dynamic cluster setting (as in the
reference); child limits accept the same ``indices.breaker.<name>.limit``
settings with percentage or byte values. A serving cache on a card adds
that card's memory to the accounting child's and the parent's default
limits (:meth:`BreakerService.fit_device`): the planes' bytes live there.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from .errors import CircuitBreakingError

#: synthetic "heap" the percentage limits resolve against
DEFAULT_BUDGET = 1 << 30


def _journal_trip(breaker: str, label: str, wanted: int,
                  limit: int) -> None:
    """Flight-recorder journal of one breaker trip (lazy import: the
    recorder depends on telemetry, which is built over this module)."""
    try:
        from . import flightrec
        flightrec.record("breaker_trip", breaker=breaker,
                         label=str(label)[:200], wanted_bytes=int(wanted),
                         limit_bytes=int(limit))
    except Exception:   # noqa: BLE001 — accounting only
        pass


def parse_bytes_or_pct(value, budget: int) -> int:
    s = str(value).strip()
    if s.endswith("%"):
        return int(budget * float(s[:-1]) / 100.0)
    mult = 1
    sl = s.lower()
    for suffix, m in (("kb", 1 << 10), ("mb", 1 << 20), ("gb", 1 << 30),
                      ("b", 1)):
        if sl.endswith(suffix):
            sl = sl[: -len(suffix)]
            mult = m
            break
    return int(float(sl) * mult)


class CircuitBreaker:
    def __init__(self, name: str, limit: int, overhead: float = 1.0,
                 parent: Optional["ParentBreaker"] = None):
        self.name = name
        self.limit = limit
        self.overhead = overhead
        self.parent = parent
        self.used = 0
        self.trip_count = 0
        self.lock = threading.Lock()

    def add_estimate(self, nbytes: int, label: str = "<op>") -> None:
        add = int(nbytes * self.overhead)
        with self.lock:
            new = self.used + add
            tripped = new > self.limit
            if tripped:
                self.trip_count += 1
            else:
                self.used = new
        if tripped:
            # journal + raise OUTSIDE the breaker lock: a flight-recorder
            # append must never run under a lock every allocating thread
            # contends on
            _journal_trip(self.name, label, new, self.limit)
            raise CircuitBreakingError(
                f"[{self.name}] Data too large, data for [{label}] "
                f"would be [{new}/{_h(new)}], which is larger than "
                f"the limit of [{self.limit}/{_h(self.limit)}]")
        if self.parent is not None:
            try:
                self.parent.check(label)
            except CircuitBreakingError:
                with self.lock:
                    self.used -= add
                raise

    def release(self, nbytes: int) -> None:
        with self.lock:
            self.used = max(0, self.used - int(nbytes * self.overhead))

    def reserve(self, nbytes: int, label: str = "<op>"):
        """Context manager: estimate on enter, release on exit."""
        breaker = self

        class _R:
            def __enter__(self):
                breaker.add_estimate(nbytes, label)
                return breaker

            def __exit__(self, *exc):
                breaker.release(nbytes)
                return False

        return _R()

    def stats(self) -> dict:
        with self.lock:
            # snapshot under the breaker's own lock: used/trip_count
            # are read-modify-written under it, and an off-lock stats
            # read is a torn view during a concurrent add/release
            # (ESTP-R01)
            used, tripped = self.used, self.trip_count
        return {"limit_size_in_bytes": self.limit,
                "limit_size": _h(self.limit),
                "estimated_size_in_bytes": used,
                "estimated_size": _h(used),
                "overhead": self.overhead,
                "tripped": tripped}


class ParentBreaker:
    """Bounds the SUM of the child breakers (the hierarchy part)."""

    def __init__(self, limit: int):
        self.limit = limit
        self.trip_count = 0
        #: guards trip_count — the children guard their own `used`;
        #: check() is called from every allocating thread concurrently
        #: and `trip_count += 1` is a lost-update race without it
        #: (ESTP-R01)
        self.lock = threading.Lock()
        self.children: Dict[str, CircuitBreaker] = {}

    def total_used(self) -> int:
        total = 0
        for c in list(self.children.values()):
            with c.lock:        # sequential per-child, never nested
                total += c.used
        return total

    def check(self, label: str) -> None:
        total = self.total_used()
        if total > self.limit:
            with self.lock:
                self.trip_count += 1
            _journal_trip("parent", label, total, self.limit)
            raise CircuitBreakingError(
                f"[parent] Data too large, data for [{label}] would be "
                f"[{total}/{_h(total)}], which is larger than the limit "
                f"of [{self.limit}/{_h(self.limit)}], real usage: "
                f"[{total}], new bytes reserved: [0]")

    def stats(self) -> dict:
        with self.lock:
            tripped = self.trip_count
        total = self.total_used()
        return {"limit_size_in_bytes": self.limit,
                "limit_size": _h(self.limit),
                "estimated_size_in_bytes": total,
                "estimated_size": _h(total),
                "overhead": 1.0,
                "tripped": tripped}


class BreakerService:
    """The node's breaker hierarchy (request / fielddata / in-flight /
    accounting under one parent), with dynamic limit updates."""

    #: (name, default limit fraction of budget, overhead) —
    #: ``accounting`` carries device-resident (hot-tier) plane bytes;
    #: ``host_tier`` carries warm-tier host-pinned plane bytes, so a
    #: demote-to-warm moves the estimate between ledgers instead of
    #: double-charging the device budget
    CHILDREN = (("request", 0.6, 1.0), ("fielddata", 0.4, 1.03),
                ("in_flight_requests", 1.0, 2.0), ("accounting", 1.0, 1.0),
                ("host_tier", 1.0, 1.0))

    def __init__(self, budget: int = DEFAULT_BUDGET):
        self.budget = budget
        #: device memory the accounting child (and so the parent) may
        #: hold on top of the host budget (:meth:`fit_device`)
        self.device_budget = 0
        #: limits a setting fixed ("total" or a child's name): fit_device
        #: leaves them as set
        self._set: set = set()
        self._lock = threading.Lock()
        self.parent = ParentBreaker(self._default_limit("total"))
        for name, _frac, overhead in self.CHILDREN:
            b = CircuitBreaker(name, self._default_limit(name), overhead,
                               parent=self.parent)
            self.parent.children[name] = b

    def _default_limit(self, target: str) -> int:
        if target == "total":
            return int(self.budget * 0.95) + self.device_budget
        frac = dict((n, f) for n, f, _ov in self.CHILDREN)[target]
        extra = self.device_budget if target == "accounting" else 0
        return int(self.budget * frac) + extra

    def fit_device(self, nbytes: int) -> None:
        """Let the accounting child and the parent also hold ``nbytes`` of
        device memory (a card's total: a serving cache on that card calls
        this, since its planes' bytes live in device memory, not in the
        host budget). Grows only; a limit a setting fixed stays as set."""
        with self._lock:
            if nbytes <= self.device_budget:
                return
            self.device_budget = int(nbytes)
            for target in ("total", "accounting"):
                if target in self._set:
                    continue
                limit = self._default_limit(target)
                if target == "total":
                    self.parent.limit = limit
                else:
                    self.parent.children[target].limit = limit

    def breaker(self, name: str) -> CircuitBreaker:
        return self.parent.children[name]

    def apply_setting(self, key: str, value) -> bool:
        """``indices.breaker.total.limit`` / ``indices.breaker.<child>.
        limit`` (% of budget or absolute bytes). Returns handled?"""
        parts = key.split(".")
        if len(parts) != 4 or parts[:2] != ["indices", "breaker"] or \
                parts[3] != "limit":
            return False
        target = parts[2]
        with self._lock:
            if value is None:
                self._set.discard(target)
                if target == "total":
                    self.parent.limit = self._default_limit(target)
                elif target in self.parent.children:
                    self.parent.children[target].limit = \
                        self._default_limit(target)
                return True
            nbytes = parse_bytes_or_pct(value, self.budget)
            if target == "total":
                self.parent.limit = nbytes
            elif target in self.parent.children:
                self.parent.children[target].limit = nbytes
            else:
                return False
            self._set.add(target)
        return True

    def stats(self) -> dict:
        out = {name: b.stats()
               for name, b in self.parent.children.items()}
        out["parent"] = self.parent.stats()
        return out


def _h(n: int) -> str:
    for unit, div in (("gb", 1 << 30), ("mb", 1 << 20), ("kb", 1 << 10)):
        if n >= div:
            return f"{n / div:.1f}{unit}"
    return f"{n}b"


def estimate_partial_bytes(obj, _depth: int = 0) -> int:
    """Rough recursive footprint of an aggregation partial tree — the
    request breaker's unit of account for reduce-time bucket growth
    (the reference accounts per-bucket via BigArrays)."""
    import numpy as np
    if _depth > 12:
        return 64
    if isinstance(obj, np.ndarray):
        return int(obj.nbytes)
    if isinstance(obj, dict):
        return 64 + sum(64 + estimate_partial_bytes(v, _depth + 1)
                        for v in obj.values())
    if isinstance(obj, (list, tuple, set)):
        return 64 + sum(estimate_partial_bytes(v, _depth + 1)
                        for v in obj)
    if isinstance(obj, str):
        return 48 + len(obj)
    return 32


#: PROCESS-scoped service: in-process multi-node test clusters share it,
#: which is the honest model — they share the host's actual memory, so
#: the budget bounds their combined footprint. Per-node *surfaces*
#: (stats rendering) compute node-local estimates without writing here.
DEFAULT = BreakerService()
