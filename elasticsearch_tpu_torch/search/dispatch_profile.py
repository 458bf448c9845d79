"""Dispatch timeline profiler: a bounded ring of per-dispatch records
with a Chrome trace-event renderer.

The batcher's stage timings say how long a dispatch's queue/prep/execute/fetch
took IN AGGREGATE; nothing shows how the PIPELINE_DEPTH=2 dispatcher
threads, co-batching decisions, and device execution actually overlap
in time. This module is that surface:

- :class:`DispatchProfileRing` — a lock-light bounded ring (the
  flight-recorder shape: ``dispatch_profile.ring.size`` /
  ``ES_TPU_DISPATCH_PROFILE_CAP``, default 2048). Each micro-batch
  dispatch appends ONE record from the dispatcher loop in
  ``search/microbatch.py`` — OUTSIDE ``_cond`` (ESTP-L02 treats this
  module like ``common/telemetry``): wall + monotonic start/end per
  stage (queue-drain, host prep, device execute, fetch), the
  dispatcher thread id, bucket key/params, batch composition (request
  count, dedup lane count, k bucket, view size, mesh axes), h2d/d2h
  bytes, compile-cache verdict, kernel family, and the roofline audit
  (``common/roofline.py``). Flightrec ``slow_dispatch`` events carry
  the record's ``seq`` so the two journals cross-link.

- :func:`chrome_trace` — renders records as Chrome trace-event JSON
  (the ``{"traceEvents": [...]}`` format perfetto/chrome://tracing
  load): one *process* per (node, batcher), one *thread track* per
  dispatcher thread carrying complete ``"X"`` events for prep/execute/
  fetch (sequential per thread by construction), plus a synthetic
  ``queue`` track per batcher — queue-drain windows of consecutive
  dispatches overlap each other and the previous dispatch's execute,
  so they cannot share the dispatcher's track without breaking the
  viewer's nesting invariant. ``GET /_profiler/timeline`` serves this;
  the cluster front fans it in over ``rest:exec`` with per-node dedup
  (``node/cluster_rest.py``).

Emission is a dict build + locked deque append (~µs, measured in
TELEMETRY.md's overhead budget); rendering is snapshot-time only.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import zlib
from collections import deque
from typing import Dict, List, Optional

from ..common.settings import CLUSTER_SETTINGS, Setting

__all__ = ["DispatchProfileRing", "RING", "record", "chrome_trace"]

SETTING_RING_SIZE = CLUSTER_SETTINGS.register(
    Setting.int_setting("dispatch_profile.ring.size", 2048,
                        scope="cluster", dynamic=False, min_value=64))

_SEQ = itertools.count(1)


class DispatchProfileRing:
    """Bounded per-process ring of per-dispatch timeline records."""

    def __init__(self, cap: Optional[int] = None, registry=None):
        if cap is None:
            raw = os.environ.get("ES_TPU_DISPATCH_PROFILE_CAP")
            try:
                cap = int(raw) if raw is not None \
                    else int(SETTING_RING_SIZE.default)
            except ValueError:
                cap = int(SETTING_RING_SIZE.default)
        self.cap = max(int(cap), 64)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.cap)
        self._dropped = 0
        self._emitted = 0
        self._registry = registry

    def record(self, **fields) -> dict:
        """Append one dispatch record. O(1); never raises (profiling
        must not fail the dispatch it profiles). Returns the record
        (empty dict on failure)."""
        try:
            rec = {"seq": next(_SEQ)}
            rec.update(fields)
            with self._lock:
                if len(self._ring) >= self.cap:
                    self._dropped += 1
                self._ring.append(rec)
                self._emitted += 1
            return rec
        except Exception:   # noqa: BLE001 — best-effort by contract
            return {}

    def records(self, since_ms: Optional[float] = None,
                limit: int = 256) -> List[dict]:
        """Chronological slice of the retained ring, capped to the
        NEWEST ``limit`` matches; ``since_ms`` is a wall epoch-ms floor
        on the dispatch's start."""
        with self._lock:
            snap = list(self._ring)
        if since_ms is not None:
            snap = [r for r in snap if r.get("ts_ms", 0) >= since_ms]
        if limit and limit > 0:
            snap = snap[-int(limit):]
        return snap

    def stats_doc(self) -> dict:
        with self._lock:
            return {"retained": len(self._ring), "cap": self.cap,
                    "emitted": self._emitted, "dropped": self._dropped}


#: PROCESS-scoped ring (the flightrec.DEFAULT singleton pattern —
#: in-process multi-node clusters share it; the cluster fan-in dedupes)
RING = DispatchProfileRing()


def record(**fields) -> dict:
    """Module entry the dispatcher loop uses."""
    return RING.record(**fields)


# ---------------------------------------------------------------------------
# Chrome trace-event rendering
# ---------------------------------------------------------------------------

def _track_pid(node: str, batcher: str) -> int:
    """Deterministic pid for one (node, batcher) process track — stable
    across nodes and processes so the cluster fan-in's merged events
    never conflate two nodes' tracks (and in-process duplicates from a
    shared ring collapse exactly)."""
    return (zlib.crc32(f"{node}\x00{batcher}".encode()) & 0x3FFFFFFF) | 1


def chrome_trace(records: List[dict], node: Optional[str] = None) -> dict:
    """Render dispatch records as Chrome trace-event JSON
    (perfetto-loadable): ``M`` metadata events name each (node,
    batcher) process and each dispatcher-thread track, ``X`` complete
    events carry one span per stage with the dispatch's args. Queue
    stages render on a per-batcher synthetic ``queue`` track (tid 0):
    they overlap the dispatcher threads' execute windows by design."""
    events: List[dict] = []
    named_pids: Dict[tuple, int] = {}
    named_tids = set()

    def ensure_process(rnode: str, batcher: str) -> int:
        key = (rnode, batcher)
        pid = named_pids.get(key)
        if pid is None:
            pid = named_pids[key] = _track_pid(rnode, batcher)
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "ts": 0, "args": {"name": f"{rnode} {batcher}"}})
        return pid

    def ensure_thread(pid: int, tid: int, name: str) -> None:
        if (pid, tid) not in named_tids:
            named_tids.add((pid, tid))
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "ts": 0, "args": {"name": name}})

    for r in records:
        rnode = str(r.get("node") or node or "local")
        batcher = str(r.get("batcher") or "?")
        pid = ensure_process(rnode, batcher)
        tid = int(r.get("thread") or 1)
        ensure_thread(pid, tid,
                      str(r.get("thread_name") or f"dispatcher-{tid}"))
        ensure_thread(pid, 0, "queue")
        args = {"rec": r.get("seq"), "kernel": r.get("kernel"),
                "compile_cache": r.get("compile_cache")}
        for k in ("batch", "bucket", "bytes", "audit", "docs_scanned"):
            if r.get(k) is not None:
                args[k] = r[k]
        for st in r.get("stages") or []:
            dur = max(float(st.get("end_ms", 0))
                      - float(st.get("start_ms", 0)), 0.0)
            events.append({
                "ph": "X", "name": str(st.get("name", "?")),
                "cat": str(r.get("kernel") or "dispatch"),
                "pid": pid,
                "tid": 0 if st.get("name") == "queue" else tid,
                # trace-event ts/dur are MICROSECONDS
                "ts": round(float(st.get("start_ms", 0)) * 1e3, 1),
                "dur": round(dur * 1e3, 1),
                "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
