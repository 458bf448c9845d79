"""Continuous profiling: an always-on, low-overhead flamegraph sampler.

The observability stack sees every *device* dispatch (timeline profiler,
roofline auditor) but host CPU — REST parse, micro-batch host prep, CSR
eager scoring, pack/repack, tier streaming — was only visible through
``_nodes/hot_threads``, an on-demand blocking snapshot. This module runs
ONE daemon sampler thread that walks :func:`sys._current_frames` on a
bounded cadence and folds every busy stack into a per-window bounded
flamegraph trie, attributed along the dimensions the stack already
carries:

- **thread pool** — every package-created thread is named with a stable
  ``es-<role>`` prefix at creation (dispatcher/repack/warmup/recovery/
  watchdog/monitoring/sampler/...); the sampler derives the pool from
  the name, with an explicit per-thread override registry on top
  (:func:`register_thread`, and the REST edge binding request threads
  to the ``rest`` pool for the request's lifetime).
- **tenant + query shape** — request threads bind their X-Opaque-Id at
  the REST edge (:func:`bind_request_thread`) and publish a reference
  to flightrec's MUTABLE shape holder (:func:`note_shape_holder`), so
  mid-request shape upgrades (``flightrec.set_shape``) are visible to
  the sampler live, with zero per-sample request-side work. Dispatcher
  threads carry no request context, so ``microbatch._dispatch_loop``
  stamps the active batch's dominant (tenant, shape) around each
  dispatch (:func:`bind_dispatch`) — the slots captured both on the
  request thread at enqueue.
- **idle/busy** — one classifier (:func:`classify_idle`) shared with
  ``utils/hot_threads`` (which re-exports it), so the two samplers can
  never disagree about what "parked" means.

Windows rotate current→previous on the insights cadence
(``contprof.window_seconds``); the trie is node-capped
(``contprof.max_nodes``) with truncation counted, never unbounded.
``GET /_profiler/flamegraph`` serves collapsed-stack text and
d3-flamegraph JSON with ``?window=&pool=&tenant=`` filters; the cluster
front fans it in over ``rest:exec`` and merges rows per full path, then
re-applies the limit AFTER the merge (the insights limit-after-merge
lesson). Every watchdog capture embeds a profile slice
(:func:`capture_doc`), so SLO-red post-mortems answer "where was the
CPU going".

The sampler self-meters: ``es_contprof_samples_total`` (thread-stack
samples observed), ``es_contprof_stacks_retained_total`` (busy stacks
folded fully into a window), ``es_contprof_dropped_total`` (stacks
truncated by the node cap) and an ``es_contprof_duty_cycle`` gauge
(EWMA fraction of wall time spent sampling); ``bench.py`` gates the
ABBA on-vs-off overhead at <=2% like the insights gate.

Attribution writes here are O(1) dict updates under this module's own
lock — never under a serving lock (ESTP-L02 lists this module with
``common/telemetry``). The sampler thread has a real ``close()`` that
signals and joins (ESTP-T01).
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

from .settings import CLUSTER_SETTINGS, Setting

__all__ = [
    "classify_idle", "sample_stacks", "register_thread",
    "bind_request_thread", "unbind_request_thread", "note_shape_holder",
    "bind_dispatch", "unbind_dispatch", "thread_role",
    "ContinuousProfiler", "ensure_profiler", "get_profiler",
    "close_profiler", "profile_doc", "capture_doc", "merge_docs",
    "collapsed_text", "flame_json", "contprof_enabled", "interval_ms",
    "window_seconds", "max_nodes", "IDLE_HINTS",
]

SETTING_INTERVAL_MS = CLUSTER_SETTINGS.register(
    Setting.float_setting("contprof.interval_ms", 50.0,
                          scope="cluster", dynamic=False))
SETTING_WINDOW_S = CLUSTER_SETTINGS.register(
    Setting.float_setting("contprof.window_seconds", 60.0,
                          scope="cluster", dynamic=False))
SETTING_MAX_NODES = CLUSTER_SETTINGS.register(
    Setting.int_setting("contprof.max_nodes", 8192,
                        scope="cluster", dynamic=False, min_value=64))

#: frames kept per sampled stack (innermost) — bounds both the
#: per-sample extract cost and the trie depth
STACK_DEPTH = 24

#: default row cap for the REST endpoint / capture slice
DEFAULT_LIMIT = 256


def contprof_enabled() -> bool:
    """Master on/off gate (``ES_TPU_CONTPROF`` env; default on). The
    bench's profiler-off arm uses this to measure the overhead."""
    return os.environ.get("ES_TPU_CONTPROF", "1").lower() \
        not in ("0", "false")


def interval_ms() -> float:
    raw = os.environ.get("ES_TPU_CONTPROF_INTERVAL_MS")
    if raw is not None:
        try:
            return max(1.0, float(raw))
        except ValueError:
            pass
    return float(SETTING_INTERVAL_MS.default)


def window_seconds() -> float:
    raw = os.environ.get("ES_TPU_CONTPROF_WINDOW_S")
    if raw is not None:
        try:
            return max(1.0, float(raw))
        except ValueError:
            pass
    return float(SETTING_WINDOW_S.default)


def max_nodes() -> int:
    raw = os.environ.get("ES_TPU_CONTPROF_MAX_NODES")
    if raw is not None:
        try:
            return max(64, int(raw))
        except ValueError:
            pass
    return int(SETTING_MAX_NODES.default)


# -- idle/busy classifier (shared with utils/hot_threads) -------------------

#: frames that mean "parked, not burning cpu" — probed against
#: ``filename:funcname`` of the innermost frame
IDLE_HINTS = ("threading.py", "queue.py", "selectors.py",
              "socket.py", "ssl.py", "concurrent/futures",
              "asyncio/base_events.py", "wait", "select", "epoll",
              "utils/hot_threads.py", "common/contprof.py")

#: runtime-infrastructure files a waiter frame can live in
_RUNTIME_FILES = ("threading.py", "queue.py", "selectors.py",
                  "socket.py", "ssl.py", "concurrent/futures",
                  "asyncio/")

#: function names that park a thread when executing in a runtime file —
#: STRICT (no ``run``/``_bootstrap``), so a busy application frame under
#: ``Thread.run`` never misreads as idle
_WAITER_NAMES = ("wait", "acquire", "select", "poll", "join", "sleep",
                 "get", "recv", "accept", "epoll")


def _is_waiter_frame(fs: traceback.FrameSummary) -> bool:
    return any(r in fs.filename for r in _RUNTIME_FILES) and \
        any(w in fs.name for w in _WAITER_NAMES)


def classify_idle(stack: List[traceback.FrameSummary]) -> bool:
    """True when the sampled thread is parked rather than burning CPU.

    The old ``hot_threads._is_idle`` probed ONLY the top frame, so a
    thread parked in ``cond.wait()`` could misread as busy whenever the
    extracted listing put a package frame innermost (wrapper/extract
    ordering quirks). Classification here is on the deepest frame that
    decides anything: an idle-hint innermost frame is parked; an
    application innermost frame is busy — UNLESS the frame immediately
    outward of it is a strict runtime waiter (``threading.py:wait`` and
    friends), which means the listing inverted the order around a park.
    """
    if not stack:
        return True
    top = stack[-1]
    probe = f"{top.filename}:{top.name}"
    if any(h in probe for h in IDLE_HINTS):
        return True
    if len(stack) >= 2 and _is_waiter_frame(stack[-2]):
        return True
    return False


def sample_stacks(limit: Optional[int] = None) \
        -> Dict[int, List[traceback.FrameSummary]]:
    """One pass over every live Python thread: ``{ident: stack}`` with
    frames outermost-first (innermost ``limit`` frames kept). The ONE
    sampling core shared by the continuous sampler and hot_threads."""
    out: Dict[int, List[traceback.FrameSummary]] = {}
    for tid, frame in sys._current_frames().items():
        try:
            out[tid] = traceback.extract_stack(frame, limit=limit)
        except Exception:   # noqa: BLE001 — a frame torn down mid-walk
            continue        # contributes nothing this pass
    return out


# -- thread -> attribution registries ---------------------------------------

#: guards the three maps below; every hold is O(1) (ESTP-L02: this
#: module is telemetry-side, never under a serving lock)
_ATTR_LOCK = threading.Lock()
#: ident -> explicit role override (register_thread)
_ROLES: Dict[int, str] = {}
#: ident -> [tenant, shape_holder] for request threads (REST edge);
#: shape_holder is flightrec's MUTABLE single-slot list, so mid-request
#: ``set_shape`` upgrades are visible to the sampler live
_REQUESTS: Dict[int, list] = {}
#: ident -> (tenant, shape) stamped by dispatcher threads around the
#: active batch (the batch's dominant pair, captured at enqueue)
_DISPATCH: Dict[int, Tuple[Optional[str], Optional[str]]] = {}


def register_thread(role: str, thread: Optional[threading.Thread] = None
                    ) -> None:
    """Explicitly stamp ``role`` for a thread (defaults to the caller)
    — for threads whose name a foreign layer controls."""
    t = thread if thread is not None else threading.current_thread()
    if t.ident is None:
        return
    with _ATTR_LOCK:
        _ROLES[t.ident] = str(role)


def thread_role(ident: int, name: str) -> str:
    """The pool a thread samples into: explicit override, else the
    ``es-<role>[-...]`` name prefix, else main/other."""
    with _ATTR_LOCK:
        role = _ROLES.get(ident)
    if role is not None:
        return role
    if name.startswith("es-"):
        rest = name[3:]
        return rest.split("-", 1)[0] or "other"
    if name == "MainThread":
        return "main"
    return "other"


def bind_request_thread(tenant: Optional[str]) -> tuple:
    """Bind the calling (request) thread's tenant for its lifetime;
    returns a token for :func:`unbind_request_thread`. Nest-safe:
    internal re-dispatches on the same thread restore the outer
    binding."""
    ident = threading.get_ident()
    with _ATTR_LOCK:
        prev = _REQUESTS.get(ident)
        _REQUESTS[ident] = [tenant or None, None]
    return ident, prev


def unbind_request_thread(token: tuple) -> None:
    ident, prev = token
    with _ATTR_LOCK:
        if prev is None:
            _REQUESTS.pop(ident, None)
        else:
            _REQUESTS[ident] = prev


def note_shape_holder(holder: list) -> None:
    """Publish flightrec's mutable shape holder for the calling request
    thread (called by ``flightrec.bind_shape``); no-op off-request."""
    ident = threading.get_ident()
    with _ATTR_LOCK:
        ent = _REQUESTS.get(ident)
        if ent is not None:
            ent[1] = holder


#: shape-id upgrades (structural fingerprint -> plan id) noted by
#: ``flightrec.set_shape``: samples folded BEFORE the planner lowered
#: the body carry the early id; render-time resolution converges every
#: window onto the final id query-insights reports
_SHAPE_ALIASES: Dict[str, str] = {}
_ALIAS_CAP = 4096


def note_shape_alias(old: Optional[str], new: Optional[str]) -> None:
    """Record that samples attributed to shape ``old`` belong to ``new``
    (a mid-request in-place upgrade). Bounded; self-maps are dropped."""
    if not old or not new or old == new:
        return
    with _ATTR_LOCK:
        if len(_SHAPE_ALIASES) < _ALIAS_CAP or old in _SHAPE_ALIASES:
            _SHAPE_ALIASES[old] = new


def resolve_shape(shape: str) -> str:
    """Chase the alias chain (bounded — upgrade chains are short and a
    stale cycle must not hang the renderer)."""
    with _ATTR_LOCK:
        for _hop in range(8):
            nxt = _SHAPE_ALIASES.get(shape)
            if nxt is None or nxt == shape:
                break
            shape = nxt
    return shape


def bind_dispatch(tenant: Optional[str], shape: Optional[str]) -> tuple:
    """Stamp the calling (dispatcher) thread with the active batch's
    dominant (tenant, shape); returns a token for
    :func:`unbind_dispatch`."""
    ident = threading.get_ident()
    with _ATTR_LOCK:
        prev = _DISPATCH.get(ident)
        _DISPATCH[ident] = (tenant, shape)
    return ident, prev


def unbind_dispatch(token: tuple) -> None:
    ident, prev = token
    with _ATTR_LOCK:
        if prev is None:
            _DISPATCH.pop(ident, None)
        else:
            _DISPATCH[ident] = prev


def _attribution_snapshot(live_idents) -> tuple:
    """Copy the three maps under the lock and prune dead idents (threads
    exit without unregistering; the sampler is the natural GC point)."""
    with _ATTR_LOCK:
        for m in (_ROLES, _REQUESTS, _DISPATCH):
            for ident in [i for i in m if i not in live_idents]:
                del m[ident]
        return (dict(_ROLES),
                {i: (v[0], v[1]) for i, v in _REQUESTS.items()},
                dict(_DISPATCH))


# -- bounded flamegraph trie windows ----------------------------------------

class _Window:
    """One rotation window: a node-capped trie of attributed stacks.

    Trie nodes are ``[count, children_dict]``; a node's count is the
    samples passing THROUGH it, so self-samples (the flamegraph leaf
    value) fall out as ``count - sum(children)`` at render time and the
    whole structure merges across nodes by summing per-path."""

    __slots__ = ("started", "root", "n_nodes", "busy", "idle",
                 "truncated")

    def __init__(self, started: float):
        self.started = started
        self.root: list = [0, {}]
        self.n_nodes = 0
        self.busy = 0
        self.idle = 0
        self.truncated = 0

    def fold(self, path: Tuple[str, ...], cap: int) -> bool:
        """Add one busy stack; returns False when the node cap truncated
        it (the sample still counts into every node it reached)."""
        cur = self.root
        cur[0] += 1
        full = True
        for part in path:
            nxt = cur[1].get(part)
            if nxt is None:
                if self.n_nodes >= cap:
                    full = False
                    break
                nxt = cur[1][part] = [0, {}]
                self.n_nodes += 1
            cur = nxt
            cur[0] += 1
        self.busy += 1
        if not full:
            self.truncated += 1
        return full

    def rows(self) -> List[Tuple[Tuple[str, ...], int]]:
        """``(path, self_samples)`` per terminating node — the collapsed
        form the endpoint, the merge and the renderers all share."""
        out: List[Tuple[Tuple[str, ...], int]] = []

        def walk(node, parts):
            cnt, children = node
            self_n = cnt - sum(c[0] for c in children.values())
            if self_n > 0 and parts:
                out.append((tuple(parts), self_n))
            for name, child in children.items():
                parts.append(name)
                walk(child, parts)
                parts.pop()

        walk(self.root, [])
        return out


def _row_doc(path: Tuple[str, ...], samples: int) -> dict:
    pad = tuple(path) + ("-",) * max(0, 3 - len(path))
    return {"pool": pad[0], "tenant": pad[1], "shape": pad[2],
            "stack": list(path[3:]), "samples": int(samples)}


def _doc_from_rows(rows: List[dict], limit: int) -> dict:
    """Rank, truncate, and attach the attribution rollup + dominant
    triple (computed BEFORE the row truncation, so a long tail cannot
    hide the dominant pool)."""
    rows = sorted(rows, key=lambda r: (-r["samples"], r["pool"],
                                       r["tenant"], r["shape"],
                                       tuple(r["stack"])))
    attrib: Dict[Tuple[str, str, str], int] = {}
    for r in rows:
        key = (r["pool"], r["tenant"], r["shape"])
        attrib[key] = attrib.get(key, 0) + r["samples"]
    attribution = [{"pool": p, "tenant": t, "shape": s,
                    "samples": n}
                   for (p, t, s), n in sorted(attrib.items(),
                                              key=lambda kv: -kv[1])]
    kept = rows[:max(limit, 0)]
    return {"rows": kept, "rows_dropped": len(rows) - len(kept),
            "attribution": attribution,
            "dominant": attribution[0] if attribution else None,
            "flamegraph": flame_json(kept)}


class ContinuousProfiler:
    """The always-on sampler: one daemon thread, bounded cadence,
    current/previous trie windows. Constructible thread-less for burst
    sampling (watchdog captures, the lint workload, tests) — only
    :meth:`start` spawns the thread; :meth:`close` signals and joins."""

    def __init__(self, registry=None, clock=time.time,
                 interval_ms_: Optional[float] = None,
                 window_s: Optional[float] = None,
                 cap: Optional[int] = None):
        self.clock = clock
        self.interval_s = (interval_ms_ if interval_ms_ is not None
                           else interval_ms()) / 1e3
        self.window_s = window_s if window_s is not None \
            else window_seconds()
        self.cap = cap if cap is not None else max_nodes()
        self._lock = threading.Lock()
        now = clock()
        self._current = _Window(now)
        self._previous: Optional[_Window] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._duty = 0.0
        if registry is None:
            from . import telemetry as _tm
            registry = _tm.DEFAULT
        # pre-create the families so the telemetry lint sees them
        # deterministically, like the watchdog's capture counters
        self._c_samples = registry.counter(
            "es_contprof_samples_total",
            help="thread-stack samples observed by the continuous "
                 "profiler (busy + idle)")
        self._c_retained = registry.counter(
            "es_contprof_stacks_retained_total",
            help="busy stacks folded fully into a profile window trie")
        self._c_dropped = registry.counter(
            "es_contprof_dropped_total",
            help="busy stacks truncated by the profile window's "
                 "contprof.max_nodes cap")
        self._g_duty = registry.gauge(
            "es_contprof_duty_cycle",
            help="EWMA fraction of wall time the sampler spends "
                 "walking stacks (self-metered overhead)")
        for c in (self._c_samples, self._c_retained, self._c_dropped):
            c.inc(0)
        self._g_duty.set(0.0)

    # -- lifecycle ----------------------------------------------------------

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "ContinuousProfiler":
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                t = threading.Thread(target=self._run,
                                     name="es-sampler-contprof",
                                     daemon=True)
                self._thread = t
                t.start()
        return self

    def close(self, timeout: float = 5.0) -> None:
        """Signal and JOIN the sampler thread (orderly teardown)."""
        self._stop.set()
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None and t.is_alive():
            t.join(timeout)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:   # noqa: BLE001 — the sampler must
                pass            # survive any torn frame it walks

    # -- sampling -----------------------------------------------------------

    def _rotate_locked(self, now: float) -> None:
        if now - self._current.started >= self.window_s:
            self._previous = self._current
            self._current = _Window(now)

    def sample_once(self, now: Optional[float] = None) -> int:
        """One pass: walk every thread, classify, attribute, fold.
        Returns the number of busy stacks folded (tests/burst mode)."""
        t = now if now is not None else self.clock()
        t0 = time.perf_counter()
        me = threading.get_ident()
        frames = sys._current_frames()
        names = {th.ident: th.name for th in threading.enumerate()}
        roles, reqs, disp = _attribution_snapshot(frames)
        n_seen = n_busy = n_dropped = 0
        with self._lock:
            self._rotate_locked(t)
            win = self._current
            for tid, frame in frames.items():
                if tid == me:
                    continue
                try:
                    stack = traceback.extract_stack(frame,
                                                    limit=STACK_DEPTH)
                except Exception:   # noqa: BLE001 — torn frame
                    continue
                n_seen += 1
                if classify_idle(stack):
                    win.idle += 1
                    continue
                tenant = shape = None
                d = disp.get(tid)
                if d is not None:
                    tenant, shape = d
                ent = reqs.get(tid)
                role = roles.get(tid)
                if ent is not None:
                    tenant = ent[0]
                    holder = ent[1]
                    if holder:
                        shape = holder[0]
                    if role is None:
                        role = "rest"
                if role is None:
                    role = thread_role(tid, names.get(tid, ""))
                path = (role, tenant or "-", shape or "-") + tuple(
                    f"{fs.filename.rsplit('/', 1)[-1]}:{fs.name}"
                    for fs in stack)
                if win.fold(path, self.cap):
                    n_busy += 1
                else:
                    n_dropped += 1
        self._c_samples.inc(n_seen)
        if n_busy:
            self._c_retained.inc(n_busy)
        if n_dropped:
            self._c_dropped.inc(n_dropped)
        dur = time.perf_counter() - t0
        with self._lock:
            self._duty += 0.2 * (min(dur / max(self.interval_s, 1e-3),
                                     1.0) - self._duty)
            duty = self._duty
        self._g_duty.set(round(duty, 6))
        return n_busy + n_dropped

    # -- reads --------------------------------------------------------------

    def _windows(self, which: str) -> List[_Window]:
        if which == "current":
            return [self._current]
        if which == "previous":
            return [self._previous] if self._previous else []
        return [w for w in (self._current, self._previous) if w]

    def top_doc(self, window: str = "current",
                pool: Optional[str] = None,
                tenant: Optional[str] = None,
                limit: int = DEFAULT_LIMIT) -> dict:
        """The node-local profile doc the endpoint, the cluster merge
        and the watchdog capture all share."""
        with self._lock:
            self._rotate_locked(self.clock())
            wins = self._windows(window)
            merged: Dict[Tuple[str, ...], int] = {}
            stats = {"samples": 0, "idle_samples": 0, "truncated": 0,
                     "trie_nodes": 0}
            for w in wins:
                stats["samples"] += w.busy + w.idle
                stats["idle_samples"] += w.idle
                stats["truncated"] += w.truncated
                stats["trie_nodes"] += w.n_nodes
                for path, n in w.rows():
                    if len(path) >= 3 and path[2] != "-":
                        rs = resolve_shape(path[2])
                        if rs != path[2]:
                            path = path[:2] + (rs,) + path[3:]
                    merged[path] = merged.get(path, 0) + n
            duty = self._duty
        rows = [_row_doc(p, n) for p, n in merged.items()]
        if pool is not None:
            rows = [r for r in rows if r["pool"] == pool]
        if tenant is not None:
            rows = [r for r in rows if r["tenant"] == tenant]
        doc = _doc_from_rows(rows, limit)
        doc.update(stats)
        doc["enabled"] = True
        doc["window"] = window
        doc["interval_ms"] = round(self.interval_s * 1e3, 3)
        doc["duty_cycle"] = round(duty, 6)
        return doc


# -- renderers / merge ------------------------------------------------------

def collapsed_text(rows: List[dict]) -> str:
    """Brendan-Gregg collapsed stacks, one attributed path per line,
    sorted by weight: ``pool;tenant;shape;frame;... N``."""
    lines = []
    for r in sorted(rows, key=lambda r: (-r["samples"], r["pool"],
                                         r["tenant"], r["shape"],
                                         tuple(r["stack"]))):
        parts = [r["pool"], r["tenant"], r["shape"]] + list(r["stack"])
        lines.append(";".join(parts) + f" {r['samples']}")
    return "\n".join(lines) + ("\n" if lines else "")


def flame_json(rows: List[dict]) -> dict:
    """Re-fold rows into the nested ``{name, value, children}`` tree
    d3-flamegraph loads directly."""
    root = {"name": "all", "value": 0, "children": {}}
    for r in rows:
        parts = [r["pool"], r["tenant"], r["shape"]] + list(r["stack"])
        node = root
        node["value"] += r["samples"]
        for part in parts:
            child = node["children"].get(part)
            if child is None:
                child = node["children"][part] = {
                    "name": part, "value": 0, "children": {}}
            node = child
            node["value"] += r["samples"]

    def finish(node):
        kids = [finish(c) for c in node["children"].values()]
        kids.sort(key=lambda c: -c["value"])
        out = {"name": node["name"], "value": node["value"]}
        if kids:
            out["children"] = kids
        return out

    return finish(root)


def merge_docs(docs: List[dict], limit: int = DEFAULT_LIMIT) -> dict:
    """Cluster fan-in merge: per-path SUM of self-samples across nodes,
    re-rank, then re-apply ``limit`` AFTER the merge — never concatenate
    per-node top-N lists."""
    merged: Dict[tuple, int] = {}
    stats = {"samples": 0, "idle_samples": 0, "truncated": 0,
             "trie_nodes": 0}
    for d in docs:
        if not isinstance(d, dict):
            continue
        for k in stats:
            stats[k] += int(d.get(k) or 0)
        for r in d.get("rows") or []:
            key = (r.get("pool", "-"), r.get("tenant", "-"),
                   r.get("shape", "-"), tuple(r.get("stack") or ()))
            merged[key] = merged.get(key, 0) + int(r.get("samples", 0))
    rows = [{"pool": p, "tenant": t, "shape": s, "stack": list(st),
             "samples": n} for (p, t, s, st), n in merged.items()]
    doc = _doc_from_rows(rows, limit)
    doc.update(stats)
    return doc


# -- process singleton ------------------------------------------------------

_SINGLETON_LOCK = threading.Lock()
_PROFILER: Optional[ContinuousProfiler] = None


def ensure_profiler() -> Optional[ContinuousProfiler]:
    """Start the process sampler when enabled; TEAR IT DOWN (close +
    join) when ``ES_TPU_CONTPROF=0`` — the bench's off arm flips the
    env and calls this to actually stop the sampling."""
    global _PROFILER
    with _SINGLETON_LOCK:
        if not contprof_enabled():
            p, _PROFILER = _PROFILER, None
        else:
            if _PROFILER is None:
                _PROFILER = ContinuousProfiler()
            _PROFILER.start()
            return _PROFILER
    if p is not None:
        p.close()
    return None


def get_profiler() -> Optional[ContinuousProfiler]:
    with _SINGLETON_LOCK:
        return _PROFILER


def close_profiler() -> None:
    """Tear down the process sampler (tests / orderly shutdown)."""
    global _PROFILER
    with _SINGLETON_LOCK:
        p, _PROFILER = _PROFILER, None
    if p is not None:
        p.close()


def profile_doc(window: str = "current", pool: Optional[str] = None,
                tenant: Optional[str] = None,
                limit: int = DEFAULT_LIMIT) -> dict:
    """The endpoint's doc: the live singleton's windows, or an explicit
    empty-but-shaped doc when the sampler is off."""
    p = get_profiler()
    if p is None:
        doc = _doc_from_rows([], limit)
        doc.update({"samples": 0, "idle_samples": 0, "truncated": 0,
                    "trie_nodes": 0, "enabled": False, "window": window,
                    "interval_ms": interval_ms(), "duty_cycle": 0.0})
        return doc
    return p.top_doc(window=window, pool=pool, tenant=tenant,
                     limit=limit)


def capture_doc(limit: int = 64, bursts: int = 20,
                burst_sleep_s: float = 0.003) -> dict:
    """The watchdog-capture profile slice: the live sampler's windows
    when it is running, else a short synchronous burst sample (the
    hot_threads-style blocking walk) so captures carry CPU evidence
    even with the always-on thread gated off."""
    p = get_profiler()
    if p is not None and p.running:
        return p.top_doc(window="both", limit=limit)
    burst = ContinuousProfiler(interval_ms_=max(burst_sleep_s * 1e3,
                                                1.0))
    for i in range(max(bursts, 1)):
        burst.sample_once()
        if i + 1 < bursts:
            time.sleep(burst_sleep_s)
    doc = burst.top_doc(window="both", limit=limit)
    doc["burst"] = True
    return doc
