"""End-to-end query tracing: trace/span propagation + a bounded store.

Reference: ES 8's APM tracing (``tracing.apm`` — every REST request gets
a ``trace.id`` that follows the task through the transport) and the
``X-Opaque-Id`` request header that is echoed back and stamped into slow
logs and task descriptions. Here:

- A ``trace.id``/``span.id`` pair is minted at the REST edge
  (``rest/api.py``) — or adopted from an incoming ``traceparent`` /
  ``x-trace-id`` header — and carried in a ``contextvars`` context so
  every layer on the request's call path (coordinator fan-out, shard
  search, slow log) sees it without plumbing arguments.
- Cross-node hops serialize the context into transport request payload
  headers (:func:`wire_headers`) and the receiving handler re-binds it
  (``span(..., headers=...)``) — coordinator → shard fan-out keeps one
  trace id cluster-wide.
- Completed spans land in a bounded in-memory :class:`TraceStore`
  (``GET /_trace/{trace_id}`` renders the span tree). The store is
  PROCESS-scoped like ``breakers.DEFAULT``: in-process multi-node test
  clusters share it, and each span records the ``node`` that emitted it,
  so propagation is still proven by the trace id crossing the wire (a
  data-node span only joins the trace if the RPC payload carried the
  context).

Overhead per request: 2-4 spans × (one 8-byte urandom id + one dict +
one deque append under lock) — well inside the ≤2% serving budget.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

__all__ = ["TraceStore", "DEFAULT_STORE", "span", "current_trace_id",
           "current_span_id", "wire_headers", "new_trace_id",
           "set_opaque_id", "current_opaque_id"]

#: (trace_id, span_id) of the active span on this context, or None
_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "es_trace_ctx", default=None)
#: the request's X-Opaque-Id (slow-log / task stamping), or None
_OPAQUE: contextvars.ContextVar = contextvars.ContextVar(
    "es_opaque_id", default=None)


def new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


def current() -> Optional[Tuple[str, str]]:
    return _CTX.get()


def current_trace_id() -> Optional[str]:
    ctx = _CTX.get()
    return ctx[0] if ctx else None


def current_span_id() -> Optional[str]:
    ctx = _CTX.get()
    return ctx[1] if ctx else None


def set_opaque_id(opaque: Optional[str]):
    return _OPAQUE.set(opaque)


def current_opaque_id() -> Optional[str]:
    return _OPAQUE.get()


def wire_headers() -> Optional[Dict[str, str]]:
    """The active context as transport request headers, or None when no
    trace is active (internal maintenance RPCs stay untraced)."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    out = {"trace.id": ctx[0], "parent.span.id": ctx[1]}
    opaque = _OPAQUE.get()
    if opaque:
        out["x-opaque-id"] = opaque
    return out


def parse_incoming(headers: Optional[dict]) \
        -> Tuple[Optional[str], Optional[str]]:
    """(trace_id, parent_span_id) from HTTP/transport headers: our own
    wire form first, then W3C ``traceparent``
    (``00-<trace32>-<span16>-<flags>``), then a bare ``x-trace-id``."""
    if not headers:
        return None, None
    hmap = {str(k).lower(): v for k, v in headers.items()}
    tid = hmap.get("trace.id")
    if tid:
        return str(tid), hmap.get("parent.span.id")
    tp = hmap.get("traceparent")
    if tp:
        parts = str(tp).split("-")
        if len(parts) >= 3 and len(parts[1]) == 32:
            return parts[1], parts[2] if len(parts[2]) == 16 else None
    tid = hmap.get("x-trace-id")
    if tid:
        return str(tid), None
    return None, None


class TraceStore:
    """Bounded in-memory span store: trace_id → span list, FIFO-evicted
    past MAX_TRACES; spans past MAX_SPANS_PER_TRACE are counted, not
    kept (a scroll hammering one trace id must not grow memory)."""

    MAX_TRACES = 512
    MAX_SPANS_PER_TRACE = 512

    def __init__(self):
        self._lock = threading.Lock()
        from collections import OrderedDict
        self._traces: "OrderedDict[str, dict]" = OrderedDict()

    def record(self, span_doc: dict) -> None:
        tid = span_doc.get("trace_id")
        if not tid:
            return
        with self._lock:
            ent = self._traces.get(tid)
            if ent is None:
                ent = self._traces[tid] = {"spans": [], "dropped": 0}
                while len(self._traces) > self.MAX_TRACES:
                    self._traces.popitem(last=False)
            if len(ent["spans"]) >= self.MAX_SPANS_PER_TRACE:
                ent["dropped"] += 1
                return
            ent["spans"].append(span_doc)

    def get(self, trace_id: str) -> Optional[dict]:
        """{"trace_id", "spans" (flat, start-ordered), "tree" (nested by
        parent span id — orphans surface at the root)} or None."""
        with self._lock:
            ent = self._traces.get(trace_id)
            if ent is None:
                return None
            spans = [dict(s) for s in ent["spans"]]
            dropped = ent["dropped"]
        spans.sort(key=lambda s: s.get("start_ms", 0))
        # the tree gets its OWN node copies: attaching children to the
        # flat list's dicts would nest every subtree into its ancestors
        # there too (O(n²) serialization, double-counted children)
        nodes = {s["span_id"]: dict(s) for s in spans}
        roots: List[dict] = []
        for s in spans:
            n = nodes[s["span_id"]]
            parent = nodes.get(s.get("parent_span_id"))
            if parent is not None and parent is not n:
                parent.setdefault("children", []).append(n)
            else:
                roots.append(n)
        doc = {"trace_id": trace_id, "span_count": len(spans),
               "spans": spans, "tree": roots}
        if dropped:
            doc["dropped_spans"] = dropped
        return doc

    def recent(self, n: int = 50, min_ms: Optional[float] = None,
               tenant: Optional[str] = None) -> List[dict]:
        """The newest-first trace index: one row per retained trace with
        its root span's name, start and duration (``GET /_trace`` — the
        listing that makes an evicted id's 404 explainable and lets
        ``trace_dump.py --last`` stop guessing). ``min_ms`` keeps only
        traces whose root took at least that long; ``tenant`` keeps
        only traces whose root carries that X-Opaque-Id — both filter
        BEFORE the ``n`` cap, so "the slowest tenant's last 50" works
        on a busy store."""
        n = int(n)
        if n <= 0:
            return []
        with self._lock:
            items = [(tid, list(ent["spans"]))
                     for tid, ent in self._traces.items()]
        out: List[dict] = []
        for tid, spans in reversed(items):
            row = {"trace_id": tid, "span_count": len(spans)}
            if spans:
                ids = {s.get("span_id") for s in spans}
                roots = [s for s in spans
                         if s.get("parent_span_id") not in ids]
                root = min(roots or spans,
                           key=lambda s: s.get("start_ms", 0))
                row.update(root=root.get("name"),
                           start_ms=root.get("start_ms"),
                           took_ms=root.get("took_ms"))
                node = root.get("node")
                if node:
                    row["node"] = node
                row_tenant = (root.get("attrs") or {}).get("tenant")
                if row_tenant:
                    row["tenant"] = row_tenant
            if min_ms is not None and \
                    float(row.get("took_ms") or 0.0) < float(min_ms):
                continue
            if tenant is not None and row.get("tenant") != tenant:
                continue
            out.append(row)
            if len(out) >= n:
                break
        return out

    def stats_doc(self) -> dict:
        with self._lock:
            return {"traces": len(self._traces),
                    "spans": sum(len(e["spans"])
                                 for e in self._traces.values())}


#: PROCESS-scoped store (documented singleton, like breakers.DEFAULT);
#: spans carry their emitting node's id
DEFAULT_STORE = TraceStore()


class SpanHandle:
    """Yielded by :func:`span` so the body can attach attributes and
    read the ids."""

    __slots__ = ("trace_id", "span_id", "attrs")

    def __init__(self, trace_id: str, span_id: str, attrs: dict):
        self.trace_id = trace_id
        self.span_id = span_id
        self.attrs = attrs


@contextmanager
def span(name: str, *, node: Optional[str] = None,
         attrs: Optional[dict] = None,
         headers: Optional[dict] = None,
         trace_id: Optional[str] = None,
         root: bool = False,
         store: Optional[TraceStore] = None):
    """One traced span around the body.

    Parent resolution order: explicit ``trace_id``, wire ``headers``
    (cross-node hop), then the ambient context. ``root=True`` mints a
    fresh trace when none of those yield one (the REST edge); without
    it, a body running outside any trace records nothing (maintenance
    paths stay free)."""
    parent_span: Optional[str] = None
    tid = trace_id
    if tid is None and headers is not None:
        tid, parent_span = parse_incoming(headers)
    if tid is None:
        ctx = _CTX.get()
        if ctx is not None:
            tid, parent_span = ctx
        elif root:
            tid = new_trace_id()
    if tid is None:
        yield None
        return
    sid = _new_span_id()
    sattrs = dict(attrs or {})
    handle = SpanHandle(tid, sid, sattrs)
    token = _CTX.set((tid, sid))
    t0 = time.perf_counter()
    start_ms = time.time() * 1e3
    try:
        yield handle
    finally:
        _CTX.reset(token)
        doc = {"trace_id": tid, "span_id": sid,
               "parent_span_id": parent_span, "name": name,
               "start_ms": round(start_ms, 3),
               "took_ms": round((time.perf_counter() - t0) * 1e3, 3)}
        if node:
            doc["node"] = node
        if sattrs:
            doc["attrs"] = sattrs
        (store or DEFAULT_STORE).record(doc)


def record_point(name: str, *, took_ms: float = 0.0,
                 node: Optional[str] = None,
                 attrs: Optional[dict] = None,
                 store: Optional[TraceStore] = None) -> None:
    """Record a leaf span under the AMBIENT context without entering a
    new one (used to stamp already-measured work, e.g. the micro-batch
    dispatch whose stage timings arrive after the fact)."""
    ctx = _CTX.get()
    if ctx is None:
        return
    tid, parent = ctx
    doc = {"trace_id": tid, "span_id": _new_span_id(),
           "parent_span_id": parent, "name": name,
           "start_ms": round(time.time() * 1e3 - took_ms, 3),
           "took_ms": round(took_ms, 3)}
    if node:
        doc["node"] = node
    if attrs:
        doc["attrs"] = attrs
    (store or DEFAULT_STORE).record(doc)
