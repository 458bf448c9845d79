"""Micro-batching queue for the serving plane (port of the text half of
``elasticsearch_tpu/search/microbatch.py``): concurrent plane-eligible
queries coalesce into ONE device dispatch, driven by a dedicated
dispatcher thread per plane.

The reference amortizes per-query overhead through its search thread pool
(``threadpool/ThreadPool.java`` SEARCH lane) and batched partial reduction
(``action/search/QueryPhaseResultConsumer.java``); on the card the
analogous lever is the batch dimension of the dispatch itself — one
``plane.serve`` over B queries costs barely more than B=1 (the kernels are
bandwidth-bound over the postings table, which every query in the batch
shares).

Design (dispatcher pipeline): client threads only enqueue a slot and
block on its result; a small pool of dispatcher threads (PIPELINE_DEPTH,
spawned on demand, exiting after IDLE_EXIT_S of quiet) drains the queue.
While one dispatcher waits on a device result, the other accumulates the
next batch and runs its host-side prep (term→id lookup, padding, block
schedules, uploads), so host prep pipelines with device execution. Both
dispatchers launch on the same CUDA stream (PyTorch's current stream,
which every thread shares by default), so their launches run in the order
they were queued and the plane's shared K4 workspace
(``parallel/dist_search.BlockMaxTier.scan_workspace``) stays valid.
No client thread ever "leads" a dispatch; under load the batch size
converges to arrival-rate × dispatch-time with no tuning knob and no
timed wait.

Batch selection: the dispatcher picks the k-bucket with the most ready
slots; when the queue runs deeper than one full batch it coalesces
across buckets at the max-k shape instead (one bigger dispatch beats two
half-empty ones); and any slot skipped STARVATION_ROUNDS times forces
its own bucket next, so no bucket waits unboundedly behind a popular one.
Under multi-tenant contention the pick is **priority-weighted**
(``common/qos.py`` classes: interactive / bulk / analytics): each
queued class accrues deficit by its weight every round and the
highest-deficit class seeds the bucket choice. The class is a SELECTION
key only, never part of the bucket key.

Observability: every request is stamped with per-stage timings — queue
wait, host prep, device dispatch, result fetch — aggregated per batcher
(totals for stats, bounded sample rings for percentiles), so a serving
regression is attributable to a stage instead of one opaque p99.
:meth:`PlaneMicroBatcher.warmup` builds the kernels the plane's routes
launch off the serving path at plane-build time (the port compiles no
per-shape programs: a kernel library serves every shape), so no ``nvcc``
run lands mid-traffic.

One batcher per serving GENERATION (``plane_route`` hands the batcher a
generation object — packed base plane + append-only delta tier — whose
``serve`` merges delta hits into the base dispatch; an append-only
refresh swaps the delta inside the same generation, so the batcher
survives, and only a repack retires it); distinct generations dispatch
concurrently.

The kNN, fused and hybrid batchers (``KnnPlaneMicroBatcher``,
``FusedPlaneMicroBatcher``, ``batched_knn_search``,
``batched_fused_search``) are ROADMAP A2b.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..common import qos as _qos
from ..common import racedep

#: upper bound on queries per dispatch — past this the dispatch itself is
#: long enough that splitting reduces tail latency
MAX_BATCH = 64

#: per-request stage names, in pipeline order
STAGES = ("queue", "prep", "dispatch", "fetch")

#: per-stage sample ring size (bench percentiles read these)
STAGE_SAMPLE_CAP = 4096


def empty_serving_stats() -> Dict[str, int]:
    """Zero-valued serving-stats doc — the shape :meth:`stats_doc`
    returns and nodes stats aggregate (``plane_serving`` section)."""
    return {
        "dispatches": 0, "queries": 0, "max_batch": 0,
        "starved_dispatches": 0, "coalesced_dispatches": 0,
        "deduped_queries": 0,
        "delta_queries": 0, "delta_time_in_millis": 0,
        "warmed_shapes": 0, "warmup_time_in_millis": 0,
        "queue_time_in_millis": 0, "prep_time_in_millis": 0,
        "dispatch_time_in_millis": 0, "fetch_time_in_millis": 0,
        # serving-mesh topology (max-merged across batchers — every
        # generation of one cache shares the cache's mesh)
        "mesh_shard_devices": 0, "mesh_replica_devices": 0,
    }


class _Slot:
    __slots__ = ("terms", "k", "done", "vals", "hits", "total", "aggs",
                 "error", "t_enq", "rounds_skipped", "stage_ms", "info",
                 "view_segments", "view_key", "params", "trace_id",
                 "node", "shape", "priority", "tenant")

    def __init__(self, terms, k: int, view=None, params=None):
        self.terms = terms
        self.k = k
        #: the enqueuing request's trace id + ambient node (captured
        #: HERE, on the request thread — dispatcher threads carry no
        #: request context): the dispatch profiler's record and the
        #: roofline efficiency exemplar both link back through them,
        #: and the node stamp keeps the cluster fan-in's per-node
        #: dedup exact (in-process nodes share the ring)
        from ..common import flightrec as _fr
        from ..common import tracing as _tracing
        self.trace_id = _tracing.current_trace_id()
        self.node = _fr.ambient_node()
        #: the request's query shape id (dispatch-profile records join
        #: /_insights/top_queries by it) — captured here for the same
        #: reason as trace_id
        self.shape = _fr.current_shape()
        #: the request's tenant (X-Opaque-Id) — captured on the request
        #: thread so the dispatcher can stamp the batch's dominant
        #: (tenant, shape) into the continuous profiler's attribution
        #: map around each dispatch (common/contprof.py)
        self.tenant = _tracing.current_opaque_id()
        #: the request's QoS priority class (interactive/bulk/analytics)
        #: — bound by the REST edge, captured on the request thread; a
        #: SELECTION key for the weighted-deficit pick, never part of
        #: the dispatch/jit shape
        self.priority = _qos.current_priority()
        #: extra dispatch parameters that shape the kernel (kNN IVF:
        #: bucketed (nprobe, rerank)) — co-batching only within one
        #: params tuple, so the compile-shape lattice stays warm
        self.params = params
        #: the caller's segment-list snapshot (NRT view). Hit coordinates
        #: must decode against THIS list, so slots only co-batch within
        #: one view and the dispatch resolves the delta tier for exactly
        #: this list (plane_route serve_view) — a refresh landing between
        #: enqueue and dispatch must not shift coordinates under the
        #: caller. None = viewless (legacy planes / tests).
        self.view_segments = view
        self.view_key = tuple(id(s) for s in view) \
            if view is not None else None
        self.done = False
        self.vals = None
        self.hits: Optional[List[Tuple[int, int]]] = None
        self.total: Optional[int] = None
        #: fused agg-stage result for THIS slot (dict), or None — set
        #: only by dispatches whose plane returned a 4th output list
        self.aggs = None
        self.error: Optional[BaseException] = None
        self.t_enq = time.perf_counter()
        #: dispatch rounds that passed this slot over (starvation bound)
        self.rounds_skipped = 0
        #: per-stage ms for THIS request, filled at fan-out
        self.stage_ms: Optional[Dict[str, float]] = None
        #: dispatch metadata for THIS request (compile-cache hit/miss,
        #: batch size) — the Profile API's ``serving`` section
        self.info: Optional[Dict[str, object]] = None


class PlaneMicroBatcher:
    """Batches ``plane.search`` dispatches for one plane behind a
    dedicated dispatcher thread."""

    #: batcher kind label (timeline tracks, es_batcher_queue_depth)
    kind = "text"

    #: concurrent dispatcher threads: 2 pipelines host prep of batch N+1
    #: with the device execution / result sync of batch N
    PIPELINE_DEPTH = 2
    #: dispatcher threads exit after this long with an empty queue (a
    #: rebuilt plane's orphaned batcher must not leak a thread forever)
    IDLE_EXIT_S = 5.0
    #: a queued slot skipped this many rounds forces its bucket next
    STARVATION_ROUNDS = 4

    def __init__(self, plane, max_batch: int = MAX_BATCH):
        self.plane = plane
        self.max_batch = max_batch
        # one lock, two wait-sets: clients wait on _cond for their slot,
        # dispatchers wait on _work for queue items — an enqueue then
        # wakes ONE dispatcher instead of every blocked client
        _lock = threading.Lock()
        self._cond = threading.Condition(_lock)
        self._work = threading.Condition(_lock)
        self._queue: List[_Slot] = []
        #: priority class -> accrued weighted deficit (mutated only
        #: under the lock inside _take_batch_locked)
        self._deficit: Dict[str, float] = {}
        self._dispatchers: List[threading.Thread] = []
        self._warmup_thread: Optional[threading.Thread] = None
        # observability (nodes stats / serving bench) — mutated ONLY under
        # self._cond
        self.n_dispatches = 0
        self.n_queries = 0
        self.max_seen_batch = 0
        self.n_starved_dispatches = 0
        self.n_coalesced_dispatches = 0
        self.n_deduped = 0
        # delta-tier observability: queries whose dispatch merged a
        # base+delta result (live indexing appended segments since the
        # base pack) and the eager delta-scan time they paid
        self.n_delta_queries = 0
        self.delta_ms = 0.0
        self.warmed_shapes = 0
        self.warmup_ms = 0.0
        self._retired = False
        self.stage_totals_ms: Dict[str, float] = {s: 0.0 for s in STAGES}
        self.stage_samples: Dict[str, deque] = {
            s: deque(maxlen=STAGE_SAMPLE_CAP) for s in STAGES}
        # serving-mesh fan-out: the port serves a plane on one card, so
        # both axes are 1 (the stats keep the reference's keys)
        self.mesh_shard_devices = 1
        self.mesh_replica_devices = 1

    # -- client entry -------------------------------------------------------

    def search(self, terms: Sequence[str], k: int,
               stages: Optional[dict] = None,
               info: Optional[dict] = None, view=None, params=None):
        """One query through the batched dispatch. Returns
        (scores[k], hits[(shard, doc)...], exact total). Blocks until the
        dispatch that carries this query completes. ``stages``, when a
        dict, receives this request's per-stage ms timings; ``info``
        receives dispatch metadata (compile-cache hit/miss, batch size)
        for the Profile API's serving section. ``view`` is the caller's
        segment-list snapshot (see ``_Slot.view_segments``); ``params``
        are kernel-shaping dispatch parameters (see ``_Slot.params``)."""
        slot = _Slot(terms, k, view=view, params=params)
        with self._cond:
            self._queue.append(slot)
            self._ensure_dispatcher_locked()
            self._work.notify()
            while not slot.done:
                self._cond.wait()
        if stages is not None and slot.stage_ms is not None:
            stages.update(slot.stage_ms)
        if info is not None and slot.info is not None:
            info.update(slot.info)
        return self._result(slot)

    @staticmethod
    def _result(slot: _Slot):
        if slot.error is not None:
            raise slot.error
        return slot.vals, slot.hits, slot.total

    @staticmethod
    def _k_bucket(k: int) -> int:
        """Dispatch k rounded up to a power of two: co-batched queries only
        share a dispatch within the same bucket, so one size=10000 request
        does not inflate every size=10 neighbor's kernels."""
        return 1 << max(0, (k - 1).bit_length())

    # -- dispatcher ---------------------------------------------------------

    def _ensure_dispatcher_locked(self) -> None:
        self._dispatchers = [t for t in self._dispatchers if t.is_alive()]
        if self._queue and len(self._dispatchers) < self.PIPELINE_DEPTH:
            t = threading.Thread(
                target=self._dispatch_loop,
                name=f"es-dispatcher-{id(self):x}", daemon=True)
            self._dispatchers.append(t)
            t.start()

    def _dispatch_loop(self) -> None:
        me = threading.current_thread()
        while True:
            with self._cond:
                deadline = time.monotonic() + self.IDLE_EXIT_S
                while not self._queue:
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        if me in self._dispatchers:
                            self._dispatchers.remove(me)
                        return
                    self._work.wait(rem)
                batch = self._take_batch_locked()
            # stamp this dispatcher with the batch's dominant
            # (tenant, shape) — captured per-slot on the request thread
            # at enqueue — so the continuous profiler attributes the
            # host-prep + dispatch CPU burned here. OUTSIDE the batcher
            # lock: contprof is telemetry-side (ESTP-L02)
            from ..common import contprof as _contprof
            counts: Dict = {}
            for s in batch:
                key = (s.tenant, s.shape)
                counts[key] = counts.get(key, 0) + 1
            dom = max(counts.items(), key=lambda kv: kv[1])[0]
            _cp_token = _contprof.bind_dispatch(dom[0], dom[1])
            try:
                self._run_batch(batch)
            except BaseException as e:   # noqa: BLE001 — the loop must
                # survive anything so queued slots never hang a client
                with self._cond:
                    for s in batch:
                        if not s.done:
                            s.error = e
                            s.done = True
                    self._cond.notify_all()
            finally:
                _contprof.unbind_dispatch(_cp_token)

    def _bucket_key(self, s: _Slot):
        """One dispatch = one (k shape, segment view, params): k and
        params decide the compile shape, the view decides the hit
        coordinate space."""
        return (self._k_bucket(s.k), s.view_key, s.params)

    def _pick_class_locked(self, q: List[_Slot]) -> List[_Slot]:
        """Weighted-deficit class selection (caller holds the lock):
        every class with queued slots accrues deficit by its QoS weight
        each round; the highest-deficit class's slots seed the bucket
        choice and its deficit resets. The batch itself still takes
        EVERY queued slot sharing the chosen dispatch shape — bulk /
        analytics co-batch behind interactive for free — and the class
        never enters the bucket key, so the compile lattice is
        untouched. Classes with nothing queued drop their banked
        deficit (no unbounded credit)."""
        by_class: Dict[str, List[_Slot]] = {}
        for s in q:
            by_class.setdefault(s.priority, []).append(s)
        if len(by_class) == 1:
            return q
        for c in by_class:
            self._deficit[c] = self._deficit.get(c, 0.0) \
                + _qos.priority_weight(c)
        for c in list(self._deficit):
            if c not in by_class:
                self._deficit.pop(c)
        win = max(by_class, key=lambda c: (self._deficit.get(c, 0.0), c))
        self._deficit[win] = 0.0
        return by_class[win]

    def _take_batch_locked(self) -> List[_Slot]:
        """Pick the next batch (caller holds the lock; queue non-empty).

        Priority: (1) any slot skipped STARVATION_ROUNDS times gets its
        bucket dispatched now — a queued slot whose bucket never matches
        the popular one is still served within a bounded number of
        rounds, whatever its class; otherwise the weighted-deficit
        class pick (:meth:`_pick_class_locked`) chooses whose slots
        seed the shape, then (2) a queue deeper than one full batch
        coalesces across k-buckets (within one view) at the max-k
        shape; (3) otherwise the largest ready bucket goes (ties
        resolve to the oldest slot's bucket). Steps 2–3 take matching
        slots from the WHOLE queue, not just the winning class."""
        q = self._queue
        starved = next((s for s in q
                        if s.rounds_skipped >= self.STARVATION_ROUNDS), None)
        if starved is not None:
            bk = self._bucket_key(starved)
            batch = [s for s in q
                     if self._bucket_key(s) == bk][: self.max_batch]
            self.n_starved_dispatches += 1
        else:
            pool = self._pick_class_locked(q)
            if len(q) > self.max_batch:
                # coalesce across k-buckets but never across views (a
                # view boundary is a refresh boundary — coordinates
                # differ) or params (different kernel knobs = different
                # compile shape)
                vcounts: Dict = {}
                for s in pool:
                    vp = (s.view_key, s.params)
                    vcounts[vp] = vcounts.get(vp, 0) + 1
                vbest = max(vcounts.values())
                vk = next((s.view_key, s.params) for s in pool
                          if vcounts[(s.view_key, s.params)] == vbest)
                batch = [s for s in q
                         if (s.view_key, s.params) == vk][: self.max_batch]
                if len({self._k_bucket(s.k) for s in batch}) > 1:
                    self.n_coalesced_dispatches += 1
            else:
                counts: Dict = {}
                for s in pool:
                    bk = self._bucket_key(s)
                    counts[bk] = counts.get(bk, 0) + 1
                best = max(counts.values())
                bk = next(self._bucket_key(s) for s in pool
                          if counts[self._bucket_key(s)] == best)
                batch = [s for s in q
                         if self._bucket_key(s) == bk][: self.max_batch]
        taken = set(map(id, batch))
        self._queue = [s for s in q if id(s) not in taken]
        for s in self._queue:
            s.rounds_skipped += 1
        return batch

    def _run_batch(self, batch: List[_Slot]) -> None:
        t_pick = time.perf_counter()
        # dispatch at the bucket's rounded-up k so the compile shape is
        # stable within a bucket (slots trim to their own k on fan-out);
        # a coalesced cross-bucket batch runs at the max-k shape
        k = self._k_bucket(max(s.k for s in batch))
        # in-flight dedup: identical queries that queued concurrently
        # (the same hot body from many clients) share ONE dispatch slot —
        # each client still gets its own result copy on fan-out
        slot_of: Dict = {}
        lane: List[int] = []
        for s in batch:
            qk = self._query_key(s.terms)
            idx = slot_of.setdefault(qk, len(slot_of))
            lane.append(idx)
        n_deduped = len(batch) - len(slot_of)
        uniq: List = [None] * len(slot_of)
        for s, idx in zip(batch, lane):
            if uniq[idx] is None:
                uniq[idx] = s.terms
        # pad the batch to a power of two (padding slots score as no-op
        # queries), as the reference pads it for its compile lattice: the
        # launch shapes stay on a small set, and a dispatch's results do
        # not depend on how many requests happened to arrive together
        b_pad = 1 << max(0, (len(uniq) - 1).bit_length())
        queries = uniq + [self._pad_slot()
                          for _ in range(b_pad - len(uniq))]
        plane_stages: Dict[str, float] = {}
        t_call = time.perf_counter()
        err: Optional[BaseException] = None
        try:
            out = self._dispatch(
                queries, k, plane_stages,
                view=batch[0].view_segments, params=batch[0].params)
            vals, hits, totals = out[:3]
            # fused agg stages: a plane that served analytics stages
            # returns a 4th per-slot list of aggregations dicts
            aggs_list = out[3] if len(out) > 3 else None
        except BaseException as e:          # noqa: BLE001 — fan the error
            err = e                         # out to every query in the batch
        t_done = time.perf_counter()
        if err is not None:
            for s in batch:
                s.error = err
        else:
            for s, idx in zip(batch, lane):
                s.vals = vals[idx][:s.k]
                s.hits = hits[idx][:s.k]
                s.total = totals[idx]
                if aggs_list is not None:
                    s.aggs = aggs_list[idx]
        # stage attribution: queue wait is per-slot; prep / dispatch /
        # fetch are shared by the whole batch (one dispatch). The plane
        # refines its own call into prep/dispatch/fetch when it can;
        # otherwise the whole call counts as dispatch.
        prep_ms = (t_call - t_pick) * 1e3 + plane_stages.get("prep_ms", 0.0)
        dispatch_ms = plane_stages.get(
            "dispatch_ms", (t_done - t_call) * 1e3)
        fetch_base_ms = plane_stages.get("fetch_ms", 0.0)
        batch_info = {"batch_size": len(batch), "k_bucket": k,
                      "compile_cache": plane_stages.get("compile_cache",
                                                        "hit"),
                      # the dispatch's mesh topology, so profile:true
                      # responses name the device fan-out next to the
                      # per-device docs share below
                      "mesh": {"shard_devices": self.mesh_shard_devices,
                               "replica_devices":
                                   self.mesh_replica_devices}}
        # task resource attribution (node/task_manager.TaskResources):
        # the dispatch's transfer bytes split across the batch's slots
        # (so per-task sums reconcile with es_device_transfer_bytes_total)
        # while docs scanned is per QUERY — every query's score covers
        # the full base corpus plus the delta tier
        share = 1.0 / max(len(batch), 1)
        h2d = plane_stages.get("h2d_bytes")
        d2h = plane_stages.get("d2h_bytes")
        if h2d or d2h:
            batch_info["h2d_bytes"] = int((h2d or 0) * share)
            batch_info["d2h_bytes"] = int((d2h or 0) * share)
        base_docs = getattr(self.plane, "base_docs", None)
        if base_docs is None:
            base_docs = getattr(self.plane, "n_docs_total", 0)
        # a cluster-pruned (IVF) dispatch scans only the probed rows —
        # the plane reports them; full scans cover the whole base corpus
        scanned = plane_stages.get("docs_scanned")
        batch_info["docs_scanned"] = int(
            (base_docs if scanned is None else scanned)
            + plane_stages.get("delta_docs", 0))
        # per-DEVICE share of the scan: the shard axis partitions the
        # corpus, so each chip streams ~1/s_dev of the scanned rows (the
        # delta tier is host-side and excluded) — task attribution and
        # plane_serving report both views
        sdev = max(self.mesh_shard_devices, 1)
        base_scan = int(base_docs if scanned is None else scanned)
        batch_info["docs_scanned_per_device"] = -(-base_scan // sdev)
        tier = plane_stages.get("tier")
        if tier is not None:
            # streamed-tier dispatch (warm plane): surface the storage
            # tier + per-dispatch host→device stream bytes next to the
            # transfer counters, so profile:true and the stats rollup
            # show WHY this dispatch's byte model moved to the host link
            batch_info["tier"] = tier
            batch_info["stream_bytes"] = int(
                plane_stages.get("stream_bytes", 0))
        delta_ms = plane_stages.get("delta_ms")
        if delta_ms is not None:
            # this dispatch merged the base plane with a live delta tier:
            # surface the scan cost + delta size in the Profile API's
            # serving section and the batcher's stats rollup
            batch_info["delta_ms"] = round(delta_ms, 3)
            batch_info["delta_docs"] = int(
                plane_stages.get("delta_docs", 0))
        with self._cond:
            racedep.note_write("microbatch.stats", self)
            fetch_ms = fetch_base_ms + \
                (time.perf_counter() - t_done) * 1e3
            for s in batch:
                s.info = batch_info
                s.stage_ms = {
                    "queue": (t_pick - s.t_enq) * 1e3, "prep": prep_ms,
                    "dispatch": dispatch_ms, "fetch": fetch_ms}
                if "agg_ms" in plane_stages:
                    # fused analytics stages ran inside this dispatch:
                    # break their share out next to the pipeline stages
                    # (profile:true serving section)
                    s.stage_ms["agg"] = plane_stages["agg_ms"]
                for name in STAGES:
                    self.stage_totals_ms[name] += s.stage_ms[name]
                    self.stage_samples[name].append(s.stage_ms[name])
                s.done = True
            self.n_dispatches += 1
            self.n_queries += len(batch)
            self.n_deduped += n_deduped
            if delta_ms is not None:
                self.n_delta_queries += len(batch)
                self.delta_ms += delta_ms
            self.max_seen_batch = max(self.max_seen_batch, len(batch))
            self._cond.notify_all()
        t_end = time.perf_counter()
        # dispatch-timeline record + roofline audit, then the
        # flight-recorder slow-dispatch journal — ALL outside the
        # batcher lock (ESTP-L02: no profiler/telemetry/recorder write
        # under a serving lock). The slow event carries the profile
        # record's seq so the two journals cross-link.
        rec = self._profile_dispatch(
            batch, n_uniq=len(slot_of), k=k, b_pad=b_pad,
            t_pick=t_pick, t_call=t_call, t_done=t_done, t_end=t_end,
            plane_stages=plane_stages, batch_info=batch_info, err=err)
        from ..common import flightrec as _fr
        slow_ms = prep_ms + dispatch_ms + fetch_base_ms
        if err is None and slow_ms > _fr.slow_dispatch_threshold_ms():
            _fr.record(
                "slow_dispatch", plane=type(self.plane).__name__,
                batch_size=len(batch), k_bucket=k,
                prep_ms=round(prep_ms, 3),
                dispatch_ms=round(dispatch_ms, 3),
                fetch_ms=round(fetch_base_ms, 3),
                compile_cache=batch_info.get("compile_cache"),
                profile_rec=rec.get("seq"))

    def _kernel_family(self, params, plane_stages: dict) -> str:
        """ROOFLINE.md kernel family of one dispatch (the serving path
        stamps ``stages['kernel']`` when it knows better — e.g. a prune
        request that routed eager past the θ-window cap)."""
        k = plane_stages.get("kernel") if plane_stages else None
        if k:
            return str(k)
        if params is not None and params[0] == "prune" and params[1] \
                and getattr(self.plane, "blockmax", None) is not None:
            return "bm25_pruned"
        return "bm25_eager"

    def _profile_dispatch(self, batch, *, n_uniq: int, k: int,
                          b_pad: int, t_pick: float, t_call: float,
                          t_done: float, t_end: float,
                          plane_stages: dict, batch_info: dict,
                          err) -> dict:
        """Append this dispatch's timeline record (bounded ring,
        ``search/dispatch_profile.py``) and audit it against the
        ROOFLINE bytes model. Runs on the dispatcher thread, never
        under a lock; O(1) and never raises."""
        try:
            from ..common import roofline as _rf
            from . import dispatch_profile as _dp
            mono_end = time.perf_counter()
            wall_end = time.time()

            def wall(t: float) -> float:
                return (wall_end - (mono_end - t)) * 1e3

            q_start = min(s.t_enq for s in batch)
            stages = [
                {"name": name,
                 "start_ms": round(wall(a), 3),
                 "end_ms": round(wall(b), 3),
                 "mono_start_ms": round(a * 1e3, 3),
                 "mono_end_ms": round(b * 1e3, 3)}
                for name, a, b in (
                    ("queue", q_start, t_pick), ("prep", t_pick, t_call),
                    ("execute", t_call, t_done), ("fetch", t_done, t_end))]
            kernel = self._kernel_family(batch[0].params, plane_stages)
            model_b = plane_stages.get("model_bytes")
            if model_b is None:
                model_b = _rf.fallback_model_bytes(
                    kernel, self.plane, n_uniq, k)
            audit = None
            if err is None:
                exemplar = next(
                    (s.trace_id for s in batch if s.trace_id), None)
                # the plane's own refined device-execute wall when it
                # reports one (the whole-call wall includes plane-side
                # host prep + fetch decode — charging those as
                # "bandwidth" would misattribute a host regression)
                exec_ms = plane_stages.get(
                    "dispatch_ms", (t_done - t_call) * 1e3)
                audit = _rf.audit(kernel, model_b, exec_ms,
                                  exemplar=exemplar)
            me = threading.current_thread()
            return _dp.record(
                ts_ms=round(wall(q_start), 3),
                mono_ms=round(q_start * 1e3, 3),
                end_ms=round(wall(t_end), 3),
                node=next((s.node for s in batch if s.node), None),
                shape=next((s.shape for s in batch if s.shape), None),
                batcher=f"{self.kind}:{id(self):x}", kind=self.kind,
                kernel=kernel, thread=me.ident, thread_name=me.name,
                bucket={"k": k,
                        "params": repr(batch[0].params)
                        if batch[0].params is not None else None,
                        "view": len(batch[0].view_segments)
                        if batch[0].view_segments is not None else None},
                batch={"requests": len(batch), "unique": n_uniq,
                       "b_pad": b_pad,
                       "mesh": batch_info.get("mesh")},
                # dispatch TOTALS (batch_info carries the per-slot
                # share for task attribution)
                bytes={"h2d": int(plane_stages.get("h2d_bytes") or 0),
                       "d2h": int(plane_stages.get("d2h_bytes") or 0),
                       "model": int(model_b or 0)},
                compile_cache=batch_info.get("compile_cache"),
                docs_scanned=batch_info.get("docs_scanned"),
                error=type(err).__name__ if err is not None else None,
                stages=stages, audit=audit)
        except Exception:   # noqa: BLE001 — the profiler must never
            return {}       # take down the dispatch it observes

    # -- warmup (kernel builds off the serving path) ------------------------

    def warmup(self, ks: Sequence[int] = (10,),
               max_b: Optional[int] = None, sync: bool = False):
        """Build the kernels the plane's routes launch, so no first-hit
        ``nvcc`` run lands mid-traffic. Runs in a background thread by
        default (plane build must not block on the build); ``sync=True``
        blocks. A plane on the CPU launches no kernel and returns at once.
        ``ks``/``max_b`` keep the reference's signature: one kernel
        library serves every shape, so there is no lattice to walk."""
        from ..common import telemetry as _tm
        # n=0 up front: the cumulative family's presence is
        # deterministic even when nothing builds (host planes below)
        _tm.record_warmed_shapes(0)
        if self._serves_host():
            return None
        shapes = list(self._warm_lattice(ks, max_b or self.max_batch))
        if not shapes:
            return None

        def _run():
            t0 = time.perf_counter()
            n = 0
            for fn in shapes:
                if self._retired:
                    # the plane was superseded (a repack rebuilt it)
                    break
                try:
                    fn()
                    n += 1
                except Exception:   # noqa: BLE001 — warmup must never
                    break           # take down serving
            with self._cond:
                racedep.note_write("microbatch.stats", self)
                self.warmed_shapes += n
                self.warmup_ms += (time.perf_counter() - t0) * 1e3
            # process-cumulative credit: survives this batcher's
            # retirement (see telemetry.record_warmed_shapes)
            _tm.record_warmed_shapes(n)

        if sync:
            _run()
            return None
        t = threading.Thread(target=_run,
                             name=f"es-warmup-{id(self):x}", daemon=True)
        with self._cond:
            # the handle is written by whichever thread triggers warmup
            # (request-thread cold build or the repack thread) and read
            # by stats/tests — same lock as the other batcher state
            self._warmup_thread = t
        t.start()
        return t

    def retire(self) -> None:
        """The owning plane was superseded or evicted: stop any in-flight
        warmup at the next kernel boundary (in-flight dispatches complete
        normally; late arrivals through a stale reference still serve)."""
        self._retired = True

    def _serves_host(self) -> bool:
        """The reference's host-serving (CPU backend) check: the port has
        no host scorer on this path, so never."""
        return False

    #: the kernels each text route launches (``DistributedSearchPlane``):
    #: the eager and tiered steps, then the pruned route's
    EAGER_KERNELS = ("sparse_candidates_topk", "dense_stream_topk",
                     "topk_merge")
    PRUNED_KERNELS = ("blockmax_scan", "bisect_exact_scores")

    def _warm_lattice(self, ks, max_b):
        """Thunks, one per kernel library the plane's routes launch; none
        for a plane on the CPU (its wrappers run the plain versions)."""
        plane = self.plane
        dev = getattr(plane, "device", None)
        if dev is None or getattr(dev, "type", "cpu") != "cuda":
            return []
        from ..kernels import build as _kb
        names = list(self.EAGER_KERNELS)
        if getattr(plane, "blockmax", None) is not None:
            names += list(self.PRUNED_KERNELS)
        return [lambda n=n: _kb.library(n) for n in names]

    # -- stats --------------------------------------------------------------

    def queue_depth(self) -> int:
        """Slots waiting for a dispatch right now (watchdog captures
        snapshot this per batcher — a deep queue at capture time names
        the convoy)."""
        with self._cond:
            return len(self._queue)

    def queue_depth_by_class(self) -> Dict[str, int]:
        """Queued slots per QoS priority class — the watchdog samples
        this into ``es_batcher_queue_depth{index,kind,class}`` so a
        convoy is attributable to the class causing it."""
        with self._cond:
            out: Dict[str, int] = {}
            for s in self._queue:
                out[s.priority] = out.get(s.priority, 0) + 1
            return out

    def stats_doc(self) -> Dict[str, int]:
        """Aggregate serving stats (nodes stats ``plane_serving``)."""
        with self._cond:
            racedep.note_read("microbatch.stats", self)
            out = empty_serving_stats()
            out.update(
                dispatches=self.n_dispatches, queries=self.n_queries,
                max_batch=self.max_seen_batch,
                starved_dispatches=self.n_starved_dispatches,
                coalesced_dispatches=self.n_coalesced_dispatches,
                deduped_queries=self.n_deduped,
                delta_queries=self.n_delta_queries,
                delta_time_in_millis=int(self.delta_ms),
                warmed_shapes=self.warmed_shapes,
                warmup_time_in_millis=int(self.warmup_ms),
                mesh_shard_devices=self.mesh_shard_devices,
                mesh_replica_devices=self.mesh_replica_devices)
            for name in STAGES:
                out[f"{name}_time_in_millis"] = int(
                    self.stage_totals_ms[name])
            return out

    def stage_percentiles(self, skip: int = 0) -> Dict[str, dict]:
        """Per-stage p50/p99 over the retained per-request samples,
        skipping the first ``skip`` samples of each ring (bench: exclude
        a warmup window). Empty stages are omitted."""
        with self._cond:
            snap = {s: list(d)[skip:] for s, d in
                    self.stage_samples.items()}
        out = {}
        for name, vals in snap.items():
            if vals:
                a = np.asarray(vals)
                out[name] = {"p50_ms": round(float(np.percentile(a, 50)), 3),
                             "p99_ms": round(float(np.percentile(a, 99)), 3),
                             "n": len(vals)}
        return out

    # -- dispatch hooks (the kNN batcher, A2b, overrides them) -------------

    def _pad_slot(self):
        """Inert query filling a pow2 padding slot."""
        return []

    @staticmethod
    def _query_key(terms):
        """Hashable identity of one query (in-flight dedup)."""
        return tuple(terms)

    def _dispatch(self, queries, k: int,
                  stages: Optional[dict] = None, view=None, params=None):
        """One device dispatch over the coalesced batch → (vals, hits,
        totals) aligned with ``queries``. Runs on a dispatcher thread,
        never under the queue lock. ``params`` on the text plane is the
        bucketed block-max ``("prune", bool)`` knob — co-batching
        already split on it, so the whole batch shares one value."""
        kw = {}
        if params is not None and params[0] == "prune":
            kw["prune"] = params[1]
        if view is not None:
            sv = getattr(self.plane, "serve_view", None)
            if sv is not None:
                # serving generation: resolve the delta tier for EXACTLY
                # the batch's segment view, so hit coordinates match the
                # callers' snapshot even if a refresh landed meanwhile
                return sv(queries, k=k, view=view, with_totals=True,
                          stages=stages, **kw)
        serve = getattr(self.plane, "serve", None)
        if serve is not None:
            # the plane's serving entry picks the route (pruned, tiered
            # or eager) and refines the stage timings
            return serve(queries, k=k, with_totals=True, stages=stages,
                         **kw)
        # legacy/raw planes: size L through the ladder here
        L = None
        if hasattr(self.plane, "max_run_len"):
            L = self.plane.ladder_L(self.plane.max_run_len(queries))
        tiered = getattr(self.plane, "T_pad", 0) > 0 or None
        return self.plane.search(queries, k=k, L=L, tiered=tiered,
                                 with_totals=True)


def batched_search(plane, terms: Sequence[str], k: int,
                   stages: Optional[dict] = None,
                   info: Optional[dict] = None, view=None,
                   prune: Optional[bool] = None):
    """Module entry: route one query through the plane's micro-batcher
    (created lazily on first use; plane rebuilds get a fresh one).
    ``view`` is the caller's segment-list snapshot — hit coordinates
    come back in that list's space.

    ``prune`` (block-max pruned scan, rank-safe): bucketed into the
    compile-shape lattice via the slot's ``params`` — co-batching splits
    on it, so a prune=off straggler never forces a whole batch eager.
    On a plane without a block-max tier the knob is inert and every
    request shares the knob-less dispatch; ``None`` resolves to the
    tier default (pruned when the tier exists)."""
    params = None
    if getattr(plane, "blockmax", None) is not None:
        params = ("prune", prune is not False)
    batcher = getattr(plane, "_microbatcher", None)
    if batcher is None:
        with _CREATE_LOCK:
            batcher = getattr(plane, "_microbatcher", None)
            if batcher is None:
                batcher = PlaneMicroBatcher(plane)
                plane._microbatcher = batcher
    return batcher.search(terms, k, stages=stages, info=info, view=view,
                          params=params)


_CREATE_LOCK = threading.Lock()
