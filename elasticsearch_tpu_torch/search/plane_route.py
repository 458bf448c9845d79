"""Serving route onto the text search plane (port of the text half of
``elasticsearch_tpu/search/plane_route.py``).

The plane (``parallel/dist_search.DistributedSearchPlane``: the pruned
route K4 → K5 → K3 with K1 as its fallback, the tiered route K1, K2, K3)
serves PRODUCT traffic through this module, the bridge from
``search/shard_search.ShardSearcher`` into the plane:

- :func:`extract_bag_of_terms` recognizes request bodies whose query
  reduces to a weighted bag of terms over ONE text field — ``match``
  (OR operator), ``term`` on a text field, and pure-``should``
  disjunctions of those — exactly the shapes whose scoring model (sum of
  per-term BM25 over shard-level stats) the plane computes.
- :class:`ServingPlaneCache` owns one serving GENERATION per field: a
  packed base plane over the segment list as of the last repack plus an
  append-only DELTA tier (segments created since), scored eagerly per
  query on the host and merged into the base dispatch's top-k. Segments
  with deletes or nested docs disable the route (plane postings would
  score hidden/dead docs).

Incremental maintenance (the NRT-refresh problem): under live indexing a
refresh appends a segment every second while a full plane repack — CSR
pack, dense tier, block-max tier, device upload — costs far more.
Generations handle this the way Lucene-tier systems do:

- an append-only refresh never invalidates the base: the new segments
  form the delta tier (``parallel/dist_search.EagerDeltaScorer``), and
  the request thread at most packs the delta's CSR — O(delta), no device
  work;
- a repack thread folds the delta into a new base generation once the
  delta exceeds :attr:`ServingPlaneCache.REPACK_DELTA_FRACTION` of the
  base doc count, builds the new plane OFF the request thread, then
  atomically swaps generations (the old generation serves until the new
  one is ready);
- a merge/delete restructures the base segment list, which the old base
  cannot serve (its hit coordinates decode against segments that no
  longer exist): the repack still happens in the background while the
  per-segment path serves the gap.

Score parity with ``query_dsl``'s per-segment scoring: idf uses the
identical ``idf_weight`` over summed dfs and total docs — the delta
tier's df/doc mass is folded into every base dispatch (``extra_df``/
``extra_docs``), so base and delta docs score under ONE stat set. The
generation's length norm (avgdl) is FROZEN at base-pack time (base
impacts bake it); the delta scores under the same frozen value, so
base+delta serving equals a full repack pinned to that avgdl.

One card, no mesh: the plane lives on the cache's ``device`` (None means
``cuda``; a process without CUDA raises unless the caller passes
``"cpu"``), so the reference's pad shards and replica fan-out fall away.
The kNN half (``KnnServingGeneration``, ``knn_plane_for``), the fused
runner, the storage tiers (``PlaneTierManager``, cold promotion) and the
warm-handoff bundles are ROADMAP A2b: each is refused by name.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..common import racedep
from ..common.errors import IllegalArgumentError
from ..device import resolve_device
from ..index.mapping import MapperService, TextFieldType
from ..index.segment import Segment


def _refuse(what: str, where: str) -> IllegalArgumentError:
    return IllegalArgumentError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP A2b; "
        f"reference search/{where})")


#: plane construction is O(postings); don't bother below this many docs
#: unless a test forces it (ENV knob in ServingPlaneCache)
_MIN_DOCS_DEFAULT = 0


def _match_terms(field: str, spec, mapper: MapperService) \
        -> Optional[Tuple[str, List[str]]]:
    """One match clause → (concrete text field, analyzed terms)."""
    if isinstance(spec, dict):
        if set(spec) - {"query", "operator", "boost",
                        "minimum_should_match"}:
            return None
        if str(spec.get("operator", "or")).lower() != "or":
            return None
        if spec.get("boost", 1.0) != 1.0:
            return None
        msm = spec.get("minimum_should_match")
        if msm is not None and msm != 1:
            return None
        text = spec.get("query")
    else:
        text = spec
    if text is None or isinstance(text, (dict, list)):
        return None
    ft = mapper.field_type(field)
    if not isinstance(ft, TextFieldType):
        return None
    terms = ft.search_analyzer.terms(str(text))
    return (ft.name, terms) if terms else None


def _term_terms(field: str, spec, mapper: MapperService) \
        -> Optional[Tuple[str, List[str]]]:
    """One term clause on a TEXT field → single unanalyzed term."""
    if isinstance(spec, dict):
        if set(spec) - {"value", "boost"}:
            return None
        if spec.get("boost", 1.0) != 1.0:
            return None
        value = spec.get("value")
    else:
        value = spec
    if value is None or isinstance(value, (dict, list)):
        return None
    ft = mapper.field_type(field)
    if not isinstance(ft, TextFieldType):
        return None
    return ft.name, [str(value)]


def extract_bag_of_terms(query_spec, mapper: MapperService) \
        -> Optional[Tuple[str, List[str]]]:
    """Request query → (field, bag of terms with duplicates) when the query
    is plane-eligible, else None. Duplicate terms encode weight (the plane
    counts repeats into idfw, matching the per-segment path's weights)."""
    if not isinstance(query_spec, dict) or len(query_spec) != 1:
        return None
    (kind, body), = query_spec.items()
    if kind == "match":
        if not isinstance(body, dict) or len(body) != 1:
            return None
        (field, spec), = body.items()
        return _match_terms(field, spec, mapper)
    if kind == "term":
        if not isinstance(body, dict) or len(body) != 1:
            return None
        (field, spec), = body.items()
        return _term_terms(field, spec, mapper)
    if kind == "bool":
        if not isinstance(body, dict):
            return None
        if set(body) - {"should", "minimum_should_match", "boost"}:
            return None           # must/filter/must_not change semantics
        if body.get("boost", 1.0) != 1.0:
            return None
        msm = body.get("minimum_should_match")
        if msm is not None and msm != 1:
            return None
        should = body.get("should")
        if isinstance(should, dict):
            should = [should]
        if not should:
            return None
        field = None
        terms: List[str] = []
        for clause in should:
            sub = extract_bag_of_terms(clause, mapper)
            if sub is None:
                return None
            f, ts = sub
            if field is None:
                field = f
            elif field != f:
                return None       # cross-field disjunction: scores differ
            terms.extend(ts)
        return (field, terms) if field is not None and terms else None
    return None


#: request-body features the plane cannot serve (need per-doc masks or
#: post-hoc reordering); shared by the single-shard and pooled dist
#: routes. ``profile`` is NOT here: profiled plane queries ride the real
#: serving path and report a ``serving`` profile section (stage timings,
#: compile-cache) — the Profile API must reflect production execution.
#: (Profiled bodies still never enter the request cache:
#: ``IndexService._plane_cache_key`` checks ``profile`` separately.)
_PLANE_INCOMPATIBLE = ("aggs", "aggregations", "sort", "knn", "rescore",
                       "collapse", "suggest", "search_after", "min_score",
                       "rank")


def body_eligible(body: dict) -> bool:
    """True when the request body's FEATURE set allows the plane route
    (the query shape itself is judged by :func:`extract_bag_of_terms`)."""
    if any(body.get(k) for k in _PLANE_INCOMPATIBLE):
        return False
    return int(body.get("size", 10)) + int(body.get("from", 0)) > 0


# ---------------------------------------------------------------------------
# Serving generations: packed base plane + append-only delta tier
# ---------------------------------------------------------------------------


class _ServingGeneration:
    """One serving generation: a packed base plane over an immutable
    snapshot of the segment list, plus a swappable delta tier covering
    segments appended since. Unknown attributes delegate to the base
    plane (``n_dispatches``, ``blockmax``, ``device``, ladder surface),
    so the micro-batcher and the stats layer treat a generation exactly
    like a bare plane."""

    kind = "plane"

    #: per-view delta-scorer memo entries kept besides the live one
    VIEW_MEMO_MAX = 4

    def __init__(self, base, base_segments: Sequence[Segment], cache):
        self.base = base
        #: strong refs — identity (``is``) anchors for delta matching;
        #: kept alive until the generation is released
        self.base_segments = list(base_segments)
        self.base_docs = sum(s.n_docs for s in base_segments)
        self._cache = cache
        self.delta = None
        self._base_positions: List[int] = list(range(len(base_segments)))
        self._delta_key: Optional[tuple] = None
        self._delta_ver = -1
        self._delta_lock = threading.Lock()
        #: view key → (scorer, base_positions) for views that are not
        #: the live delta (a dispatch racing a refresh serves its own
        #: older view; see :meth:`_delta_for_view`)
        self._view_memo: "OrderedDict[tuple, tuple]" = OrderedDict()

    def __getattr__(self, name):
        base = self.__dict__.get("base")
        if base is None:
            raise AttributeError(name)
        return getattr(base, name)

    # -- delta bookkeeping ---------------------------------------------------

    def match(self, segments: Sequence[Segment]):
        """Identity-subsequence match of this generation's base against
        the CURRENT segment list. Returns (delta_segments,
        delta_positions, base_positions) when every base segment appears
        unchanged and in order (append-only refreshes, including
        interleaved appends from other index shards), else None (a
        merge/delete restructured the base — repack required)."""
        base = self.base_segments
        bi = 0
        delta: List[Segment] = []
        dpos: List[int] = []
        bpos: List[int] = []
        for pos, seg in enumerate(segments):
            if bi < len(base) and seg is base[bi]:
                bpos.append(pos)
                bi += 1
            else:
                delta.append(seg)
                dpos.append(pos)
        if bi != len(base):
            return None
        return delta, dpos, bpos

    def clear_delta(self, base_positions: Optional[List[int]] = None,
                    ver: int = -1) -> None:
        with self._delta_lock:
            if ver >= 0 and ver < self._delta_ver:
                return
            self.delta = None
            self._delta_key = None
            self._delta_ver = max(self._delta_ver, ver)
            if base_positions is not None:
                self._base_positions = base_positions

    def _swap_delta(self, scorer, key: tuple, base_positions: List[int],
                    ver: int) -> None:
        with self._delta_lock:
            racedep.note_write("generation.delta", self)
            if ver < self._delta_ver:
                return          # a newer segment list already swapped in
            self.delta = scorer
            self._delta_key = key
            self._delta_ver = ver
            self._base_positions = base_positions

    def delta_docs(self) -> int:
        # under _delta_lock: the repack thread swaps (delta, positions)
        # as a pair, and a torn read here would size the repack
        # threshold off a half-swapped generation (ESTP-R01)
        with self._delta_lock:
            d = self.delta
        return d.n_docs if d is not None else 0

    def _snapshot(self):
        with self._delta_lock:
            racedep.note_read("generation.delta", self)
            return self.delta, self._base_positions

    def _build_delta(self, delta_segs: Sequence[Segment],
                     delta_pos: List[int]):
        raise NotImplementedError

    def _delta_for_view(self, view: Sequence[Segment]):
        """(delta scorer | None, base positions) for EXACTLY the given
        segment list — the dispatch-time resolution that keeps hit
        coordinates in the caller's NRT snapshot space. A refresh landing
        between the caller's ``plane_for`` and the micro-batch dispatch
        mutates the generation's live delta, so serving that newer delta
        would emit coordinates past (or shifted within) the caller's
        list; resolving per view instead makes the race harmless. The
        live delta is the common-case hit; other views pay one O(delta)
        pack memoized per view key."""
        key = tuple(id(s) for s in view)
        with self._delta_lock:
            if self._delta_key == key:
                return self.delta, self._base_positions
            memo = self._view_memo.get(key)
            if memo is not None:
                self._view_memo.move_to_end(key)
                return memo
        m = self.match(view)
        if m is None:
            # unreachable for views that obtained this generation from
            # plane_for (the base is immutable), but a stale caller must
            # fail loudly rather than decode foreign coordinates
            raise RuntimeError(
                "serving view no longer contains this generation's base")
        delta_segs, delta_pos, base_pos = m
        scorer = self._build_delta(delta_segs, delta_pos) \
            if delta_segs else None
        with self._delta_lock:
            self._view_memo[key] = (scorer, base_pos)
            while len(self._view_memo) > self.VIEW_MEMO_MAX:
                self._view_memo.popitem(last=False)
        return scorer, base_pos


class TextServingGeneration(_ServingGeneration):
    """Lexical generation: ``DistributedSearchPlane`` base + eager CSR
    delta (``parallel/dist_search.EagerDeltaScorer``)."""

    kind = "text"

    def __init__(self, base, base_segments, field: str, avgdl: float,
                 cache):
        super().__init__(base, base_segments, cache)
        self.field = field
        #: the generation's frozen length norm (baked into base impacts)
        self.avgdl = avgdl

    def _build_delta(self, delta_segs: Sequence[Segment],
                     delta_pos: List[int]):
        """Pack a delta scorer — O(delta postings), the only
        serving-path cost a refresh adds."""
        from ..parallel.dist_search import EagerDeltaScorer
        shards = []
        for seg in delta_segs:
            f = seg.text_fields.get(self.field)
            if f is None:
                shards.append(dict(
                    term_ids={}, df=np.zeros(0, np.int32),
                    offsets=np.zeros(1, np.int64),
                    docs=np.zeros(0, np.int32),
                    tf=np.zeros(0, np.float32),
                    doc_len=np.zeros(seg.n_docs, np.float32)))
            else:
                shards.append(dict(
                    term_ids=f.term_ids, df=f.df, offsets=f.offsets,
                    docs=f.docs_host, tf=f.tf_host,
                    doc_len=f.doc_len_host))
        return EagerDeltaScorer(shards, delta_pos, avgdl=self.avgdl)

    def update_delta(self, segments: Sequence[Segment],
                     delta_segs: Sequence[Segment], delta_pos: List[int],
                     base_pos: List[int], ver: int) -> None:
        """Pack (or reuse) the LIVE delta scorer for the current segment
        list (the common serving view; dispatches for other views resolve
        through :meth:`_delta_for_view`)."""
        key = tuple(id(s) for s in segments)
        with self._delta_lock:
            if self._delta_key == key:
                self._base_positions = base_pos
                return
        scorer = self._build_delta(delta_segs, delta_pos)
        self._swap_delta(scorer, key, base_pos, ver)

    def serve_view(self, queries, k: int = 10, *, view,
                   with_totals: bool = False,
                   stages: Optional[dict] = None,
                   prune: Optional[bool] = None):
        """Micro-batcher dispatch hook: base dispatch (idf widened by the
        delta's df/doc mass) + eager delta scan + host top-k merge, with
        the delta resolved for the batch's exact segment view. The BASE
        dispatch may be block-max pruned (``prune``); the delta tier
        always scores eagerly — appended segments are small and
        exactness there keeps the merge honest for fresh docs."""
        delta, base_pos = self._delta_for_view(view)
        return self._serve_merged(queries, k, delta, base_pos,
                                  with_totals=with_totals, stages=stages,
                                  prune=prune)

    def serve(self, queries, k: int = 10, *, with_totals: bool = False,
              stages: Optional[dict] = None,
              prune: Optional[bool] = None):
        """Viewless entry (tests / direct callers): serve against the
        generation's CURRENT delta snapshot."""
        delta, base_pos = self._snapshot()
        return self._serve_merged(queries, k, delta, base_pos,
                                  with_totals=with_totals, stages=stages,
                                  prune=prune)

    def _serve_merged(self, queries, k, delta, base_pos, *,
                      with_totals: bool = False,
                      stages: Optional[dict] = None,
                      prune: Optional[bool] = None):
        if delta is None:
            return self.base.serve(queries, k=k, with_totals=with_totals,
                                   stages=stages, prune=prune)
        # one shared stat set: the delta's term dfs fold into the base
        # dispatch's idf weights, and the delta scores under the same
        # combined idf — parity with a full repack at the frozen avgdl
        extra_df: Dict[str, int] = {}
        for q in queries:
            for t in set(q):
                if t not in extra_df:
                    extra_df[t] = delta.df(t)
        vals, hits, totals = self.base.serve(
            queries, k=k, with_totals=True, stages=stages,
            extra_docs=delta.n_docs, extra_df=extra_df, prune=prune)
        t1 = time.perf_counter()
        from ..ops.bm25 import idf_weight
        n_total = self.base.n_docs_total + delta.n_docs
        idf_cache: Dict[str, float] = {}

        def idf_of(t: str) -> float:
            v = idf_cache.get(t)
            if v is None:
                gdf = self.base.global_df(t) + extra_df.get(t, 0)
                v = float(idf_weight(n_total, np.int64(gdf))) if gdf \
                    else 0.0
                idf_cache[t] = v
            return v

        from ..parallel.dist_search import (merge_topk_rows,
                                            total_is_lower_bound,
                                            total_value)
        drows, dtotals = delta.score(queries, k, idf_of, with_totals=True)
        vals_out, hits_out, totals_out = [], [], []
        for bi in range(len(queries)):
            base_rows = [(float(v), base_pos[si], int(d))
                         for v, (si, d) in zip(vals[bi], hits[bi])]
            merged = merge_topk_rows(base_rows, drows[bi], k)
            vals_out.append(np.asarray([r[0] for r in merged], np.float32))
            hits_out.append([(r[1], r[2]) for r in merged])
            # a pruned base dispatch reports (value, "gte") lower-bound
            # totals — the delta's exact count adds on, relation sticks
            tv = total_value(totals[bi]) + int(dtotals[bi])
            totals_out.append((tv, "gte")
                              if total_is_lower_bound(totals[bi]) else tv)
        delta_ms = (time.perf_counter() - t1) * 1e3
        if stages is not None:
            stages["dispatch_ms"] = stages.get("dispatch_ms", 0.0) \
                + delta_ms
            stages["delta_ms"] = delta_ms
            stages["delta_docs"] = delta.n_docs
        self._cache._record_delta_serve("text", len(queries))
        if with_totals:
            return vals_out, hits_out, totals_out
        return vals_out, hits_out


# ---------------------------------------------------------------------------
# ServingPlaneCache: generation registry + background repack
# ---------------------------------------------------------------------------


class ServingPlaneCache:
    """Per-field serving-generation registry for the product search path.
    Request threads only ever (a) hit a generation, (b) pack an O(delta)
    delta scorer, or (c) pay the one cold build per field; full repacks
    run on a background thread and swap atomically (see the module
    docstring). ``device``: where the planes live (None means ``cuda``)."""

    #: delta-tier doc fraction (of the base generation's docs) above
    #: which a background repack folds the delta into a new base
    REPACK_DELTA_FRACTION = 0.125

    #: corpus size above which a text base pack also builds the
    #: block-max pruning tier (impact-ordered int8 blocks + bound
    #: table — rank-safe WAND-as-a-scan serving via the ``prune``
    #: knob). Below it eager scoring wins outright and the tier would
    #: only cost pack time and bytes.
    LEX_PRUNE_MIN_DOCS = 1 << 17

    def __init__(self, mesh_factory=None, min_docs: int = _MIN_DOCS_DEFAULT,
                 *, device=None):
        if mesh_factory is not None:
            raise IllegalArgumentError(
                "[mesh_factory]: the port serves a plane on one card; "
                "multi-card serving is not ported (ROADMAP A2b; reference "
                "search/plane_route.py:880)")
        # the reference's storage tiers: with no budget every plane stays
        # hot, its default; a budget needs PlaneTierManager
        for env in ("ES_TPU_PLANE_HBM_BUDGET_BYTES",
                    "ES_TPU_PLANE_HOST_BUDGET_BYTES"):
            if int(os.environ.get(env, "0") or 0):
                raise _refuse(f"[{env}] (PlaneTierManager's budgets)",
                              "plane_tiers.py:164")
        # the reference's delta-off mode (a rebuild on every refresh): the
        # port serves appends through the delta tier only
        if os.environ.get("ES_TPU_PLANE_DELTA", "1").lower() in (
                "0", "false"):
            raise _refuse("[ES_TPU_PLANE_DELTA=0] (a rebuild on every "
                          "refresh)", "plane_route.py:631")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the accounting breaker holds the planes' device bytes: let it
            # (and the parent) hold this card's memory, not only the
            # host's synthetic budget
            import torch
            from ..common.breakers import DEFAULT as _breakers
            _breakers.fit_device(torch.cuda.mem_get_info(self.device)[1])
        self._planes: Dict[str, TextServingGeneration] = {}
        self.min_docs = min_docs
        #: instance override of :attr:`LEX_PRUNE_MIN_DOCS` (tests force
        #: the block-max tier on tiny corpora by lowering it)
        self.lex_prune_min_docs = self.LEX_PRUNE_MIN_DOCS
        #: "background" (production) or "sync" (deterministic tests /
        #: callers that need the swap visible before the call returns)
        self.repack_mode = "background"
        self._gen_lock = threading.RLock()
        self._gen_ver = 0
        self._repacking: set = set()
        self._repack_threads: List[threading.Thread] = []
        self._closed = False
        # plane.rebuild / plane.delta_serve / plane.swap_ms metrics:
        # instance-owned (fresh per cache — exact per-index counts) and
        # exposed through the process telemetry registry via a weakref
        # collector, like every other node-scoped producer
        from ..common import telemetry as _tm
        self._metric_lock = threading.Lock()
        self._rebuild_counts: Dict[Tuple[str, str, str], _tm.Counter] = {}
        self._delta_serve_counts: Dict[str, _tm.Counter] = {}
        self._swap_ms: Dict[str, _tm.Histogram] = {"text": _tm.Histogram()}
        _tm.DEFAULT.register_object_collector(
            f"plane_cache_{id(self):x}", self,
            ServingPlaneCache._metrics_doc)

    # -- telemetry -----------------------------------------------------------

    def _metrics_doc(self):
        with self._metric_lock:
            rb = [({"kind": k, "trigger": t, "mode": m}, c.value)
                  for (k, t, m), c in self._rebuild_counts.items()]
            ds = [({"kind": k}, c.value)
                  for k, c in self._delta_serve_counts.items()]
        # resident plane bytes on the cache's one device (outside
        # _metric_lock: generations() takes _gen_lock)
        dev_bytes = 0
        for gen in self.generations():
            base = gen.__dict__.get("base", gen)
            try:
                dev_bytes += int(base.device_corpus_bytes())
            except Exception:   # noqa: BLE001 — foreign/legacy planes
                continue
        return {
            "es_plane_rebuild_total": {
                "type": "counter",
                "help": "serving plane (re)builds by kind/trigger/mode",
                "samples": rb},
            "es_plane_delta_serve_total": {
                "type": "counter",
                "help": "queries served through base+delta merge",
                "samples": ds},
            "es_plane_swap_ms": {
                "type": "histogram",
                "help": "background repack build+swap wall ms by kind",
                "samples": [({"kind": k}, h.snapshot())
                            for k, h in self._swap_ms.items()]},
            "es_plane_hbm_bytes": {
                "type": "gauge",
                "help": "packed serving-plane bytes resident on the "
                        "device",
                "samples": [({"device": str(self.device)}, dev_bytes)]},
        }

    def _record_rebuild(self, kind: str, trigger: str, mode: str) -> None:
        from ..common import telemetry as _tm
        with self._metric_lock:
            c = self._rebuild_counts.get((kind, trigger, mode))
            if c is None:
                c = self._rebuild_counts[(kind, trigger, mode)] = \
                    _tm.Counter()
        c.inc()
        # flight-recorder journal: every generation install (cold pack,
        # threshold/structural repack) is a durable event — emitted
        # outside every cache lock
        from ..common import flightrec as _fr
        _fr.record("plane_rebuild", kind=kind, trigger=trigger, mode=mode)

    def _record_delta_serve(self, kind: str, n: int) -> None:
        from ..common import telemetry as _tm
        with self._metric_lock:
            c = self._delta_serve_counts.get(kind)
            if c is None:
                c = self._delta_serve_counts[kind] = _tm.Counter()
        c.inc(n)

    def rebuild_stats(self) -> Dict[str, int]:
        """Rollup for benches/tests: rebuild counts by mode and trigger,
        plus delta-served query count."""
        with self._metric_lock:
            out: Dict[str, int] = {"sync": 0, "background": 0,
                                   "cold": 0, "threshold": 0,
                                   "structure": 0, "delta_serves": 0}
            for (kind, trigger, mode), c in self._rebuild_counts.items():
                out[mode] = out.get(mode, 0) + int(c.value)
                out[trigger] = out.get(trigger, 0) + int(c.value)
            for c in self._delta_serve_counts.values():
                out["delta_serves"] += int(c.value)
        return out

    # -- shared plumbing -----------------------------------------------------

    def generations(self) -> list:
        """Locked snapshot of every live serving generation. Stats
        surfaces iterate THIS, never the raw dict — a stats scrape racing
        the repack thread's swap would otherwise walk a dict
        mid-mutation."""
        with self._gen_lock:
            racedep.note_read("plane_cache.generations", self)
            return list(self._planes.values())

    def serving_batchers(self) -> list:
        """The micro-batchers of every live generation (stats rollup)."""
        out = []
        for gen in self.generations():
            b = getattr(gen, "_microbatcher", None)
            if b is not None:
                out.append(b)
        return out

    @staticmethod
    def _attach_batcher(plane):
        """Pre-create the plane's micro-batcher at plane-build time and
        start building the kernels its routes launch (background thread;
        see ``microbatch.PlaneMicroBatcher.warmup``), so no first-hit
        ``nvcc`` run lands mid-traffic. A plane on the CPU launches no
        kernel and warmup returns at once. ``ES_TPU_SERVING_WARMUP=0``
        disables."""
        from .microbatch import PlaneMicroBatcher
        batcher = PlaneMicroBatcher(plane)
        plane._microbatcher = batcher
        if os.environ.get("ES_TPU_SERVING_WARMUP", "1").lower() \
                not in ("0", "false"):
            batcher.warmup()
        return batcher

    @staticmethod
    def _retire(plane) -> None:
        """Stop a superseded plane's in-flight warmup."""
        b = plane.__dict__.get("_microbatcher") \
            if isinstance(plane, _ServingGeneration) \
            else getattr(plane, "_microbatcher", None)
        if b is not None:
            b.retire()

    def _release_gen(self, gen) -> None:
        """Release a generation's breaker reservation and retire its
        batcher."""
        from ..common.breakers import DEFAULT as _breakers
        _breakers.breaker("accounting").release(
            getattr(gen, "_acct_bytes", 0))
        self._retire(gen)

    def _next_ver(self) -> int:
        with self._gen_lock:
            self._gen_ver += 1
            return self._gen_ver

    # -- repack scheduling ---------------------------------------------------

    def _delta_over_threshold(self, gen) -> bool:
        d = gen.delta_docs()
        return d > max(1, int(gen.base_docs * self.REPACK_DELTA_FRACTION))

    def _schedule_repack(self, kind: str, field: str,
                         segments: Sequence[Segment],
                         mapper: MapperService, trigger: str) -> None:
        """Fold the current segment list into a new base generation off
        the request thread, then swap. One in-flight repack per (kind,
        field); ``repack_mode == "sync"`` runs inline (tests)."""
        with self._gen_lock:
            if self._closed or (kind, field) in self._repacking:
                return
            self._repacking.add((kind, field))
            self._repack_threads = [t for t in self._repack_threads
                                    if t.is_alive()]
        segments = list(segments)

        def _run():
            t0 = time.perf_counter()
            try:
                self._build_text_generation(segments, mapper, field,
                                            trigger=trigger,
                                            mode="background")
                swap_ms = (time.perf_counter() - t0) * 1e3
                self._swap_ms[kind].observe(swap_ms)
                from ..common import flightrec as _fr
                _fr.record("plane_swap", kind=kind, field=field,
                           trigger=trigger, ms=round(swap_ms, 3))
            except Exception:   # noqa: BLE001 — a failed repack must
                pass            # never take down serving; retried later
            finally:
                with self._gen_lock:
                    self._repacking.discard((kind, field))

        if self.repack_mode == "sync":
            _run()
            return
        t = threading.Thread(target=_run, daemon=True,
                             name=f"es-repack-{kind}-{field}")
        with self._gen_lock:
            self._repack_threads.append(t)
        t.start()

    def drain_repacks(self, timeout: float = 30.0) -> None:
        """Join in-flight background repacks (tests / orderly shutdown)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._gen_lock:
                threads = [t for t in self._repack_threads if t.is_alive()]
                busy = bool(self._repacking)
            if not threads and not busy:
                return
            for t in threads:
                t.join(max(0.01, deadline - time.monotonic()))

    def notify_refresh(self, segments: Sequence[Segment],
                       mapper: MapperService,
                       knn_lists: Optional[Sequence[Sequence[Segment]]]
                       = None) -> None:
        """Engine refresh/merge hook: reconcile every cached text
        generation against the new segment list NOW — delta packs and
        repack scheduling happen at refresh time on the indexing thread,
        not on the first search to notice the change. Never builds cold
        planes. ``knn_lists`` keeps the reference's signature: the port
        caches no kNN generation (A2b), so there is nothing to reconcile
        against them."""
        segments = [s for s in segments if s.n_docs > 0]
        if not segments:
            return
        with self._gen_lock:
            if self._closed:
                return
            text_fields = list(self._planes)
        for field in text_fields:
            if self._signature(segments, field) is None:
                continue
            self._text_generation(segments, mapper, field,
                                  allow_sync_build=False)

    # -- lexical plane -------------------------------------------------------

    @staticmethod
    def _signature(segments: Sequence[Segment], field: str) -> Optional[tuple]:
        """Route-eligibility key over the segment list; None → route
        ineligible (deletes, nested docs, absent field)."""
        sig = []
        any_field = False
        for s in segments:
            if s.has_nested or not bool(s.live.all()):
                return None
            if field in s.text_fields:
                any_field = True
            sig.append((s.seg_id, s.n_docs))
        return tuple(sig) if any_field else None

    def _pack_text_shards(self, segments: Sequence[Segment], field: str):
        """(plane shard dicts, cross-segment avgdl) for a base pack."""
        sum_dl = 0.0
        doc_count = 0
        for s in segments:
            sdl, dc = s.field_stats(field)
            sum_dl += sdl
            doc_count += dc
        avgdl = sum_dl / doc_count if doc_count else 1.0
        shards = []
        for seg in segments:
            f = seg.text_fields.get(field)
            if f is None:
                n = seg.n_docs
                shards.append(dict(
                    term_ids={}, df=np.zeros(0, np.int32),
                    offsets=np.zeros(1, np.int64),
                    docs=np.zeros(0, np.int32), tf=np.zeros(0, np.float32),
                    doc_len=np.zeros(n, np.float32), avgdl=avgdl))
            else:
                shards.append(dict(
                    term_ids=f.term_ids, df=f.df, offsets=f.offsets,
                    docs=f.docs_host, tf=f.tf_host,
                    doc_len=f.doc_len_host, avgdl=avgdl))
        return shards, avgdl

    def _build_text_generation(self, segments: Sequence[Segment],
                               mapper: MapperService, field: str, *,
                               trigger: str, mode: str
                               ) -> "TextServingGeneration":
        """Full base pack: breaker reservation, plane construction,
        batcher + warmup, atomic swap (releasing the old generation).
        One card: no pad shards, no replica fan-out."""
        from ..parallel.dist_search import DistributedSearchPlane as _P
        shards, avgdl = self._pack_text_shards(segments, field)
        # the dense tier is the big persistent allocation (T_pad × n_pad
        # bf16 per shard): reserve its estimate against the accounting
        # breaker BEFORE building, so an overfull node 429s instead of
        # running out of device memory inside the constructor
        from ..common.breakers import DEFAULT as _breakers
        from ..utils.shapes import round_up_multiple, round_up_pow2
        acct = _breakers.breaker("accounting")
        n_pad = round_up_pow2(max(
            max(s["doc_len"].shape[0] for s in shards), 1))
        threshold = max(n_pad // 256, 4096)
        t_est = max((min(int((np.asarray(s["df"]) > threshold).sum()),
                         _P.MAX_DENSE_TERMS) for s in shards),
                    default=0)
        nbytes = round_up_multiple(max(t_est, 1), 16) * n_pad * 2 * \
            len(shards) if t_est else 0
        # past the prune threshold the pack also builds the block-max
        # tier (impact-ordered int8 blocks ≈ docs i32 + codes i8 +
        # 12 B/block of bound metadata) and serves the rank-safe pruned
        # scan by default; the delta tier stays eager
        total_docs = sum(int(s["doc_len"].shape[0]) for s in shards)
        n_postings = sum(int(np.asarray(s["docs"]).shape[0])
                         for s in shards)
        bmx_kw = None
        if total_docs >= max(self.lex_prune_min_docs, 1):
            bmx_kw = {}
            nbytes += int(n_postings * 5.2) + 4096
        acct.add_estimate(
            nbytes, f"<serving plane [{field}] on {self.device}, "
                    f"~{nbytes} B>")
        try:
            plane = _P(shards, field, device=self.device, blockmax=bmx_kw)
        except Exception:
            acct.release(nbytes)
            raise
        plane._acct_bytes = nbytes
        gen = TextServingGeneration(plane, segments, field, avgdl, self)
        return self._install_text_generation(gen, field, trigger, mode)

    def _install_text_generation(self, gen: "TextServingGeneration",
                                 field: str, trigger: str,
                                 mode: str) -> "TextServingGeneration":
        """Batcher + atomic swap."""
        self._attach_batcher(gen)
        with self._gen_lock:
            racedep.note_write("plane_cache.generations", self)
            if self._closed:
                self._release_gen(gen)
                return gen
            old = self._planes.get(field)
            self._planes[field] = gen
        if old is not None:
            # double-buffering: the old generation served until this
            # swap; drop its reservation and stop its warmup now
            self._release_gen(old)
        self._record_rebuild("text", trigger, mode)
        return gen

    def plane_for(self, segments: Sequence[Segment], mapper: MapperService,
                  field: str):
        """The serving generation for this segment list, or None when the
        route is ineligible (deletes, nested docs, absent field) or the
        base is mid-repack after a structural change (the per-segment
        path serves the gap)."""
        segments = [s for s in segments if s.n_docs > 0]
        if not segments:
            return None
        if sum(s.n_docs for s in segments) < self.min_docs:
            return None
        if self._signature(segments, field) is None:
            return None
        return self._text_generation(segments, mapper, field,
                                     allow_sync_build=True)

    def _text_generation(self, segments, mapper, field: str,
                         allow_sync_build: bool):
        with self._gen_lock:
            gen = self._planes.get(field)
        if gen is not None:
            m = gen.match(segments)
            if m is not None:
                delta_segs, delta_pos, base_pos = m
                ver = self._next_ver()
                if not delta_segs:
                    gen.clear_delta(base_pos, ver)
                    return gen
                gen.update_delta(segments, delta_segs, delta_pos,
                                 base_pos, ver)
                if self._delta_over_threshold(gen):
                    self._schedule_repack("text", field, segments,
                                          mapper, "threshold")
                    if self.repack_mode == "sync":
                        with self._gen_lock:
                            return self._planes.get(field)
                return gen
            # merge/delete restructured the base: the old plane's hit
            # coordinates no longer decode against this list — repack
            # in the background, per-segment path serves meanwhile
            self._schedule_repack("text", field, segments, mapper,
                                  "structure")
            if self.repack_mode == "sync":
                with self._gen_lock:
                    return self._planes.get(field)
            return None
        if not allow_sync_build:
            return None
        # cold start (first build for this field). The reference first
        # tries its cold storage tier (_promote_from_cold, A2b); the port
        # has none, so it packs.
        return self._build_text_generation(segments, mapper, field,
                                           trigger="cold", mode="sync")

    # -- parts that wait for ROADMAP A2b --------------------------------------

    def knn_plane_for(self, segments, mapper, field: str):
        raise _refuse("[knn_plane_for] (the kNN serving generation)",
                      "plane_route.py:1272")

    def fused_runner_for(self, segments, mapper, text_field: str,
                         knn_field: Optional[str] = None):
        raise _refuse("[fused_runner_for] (the fused planner's runner)",
                      "plane_route.py:790")

    def export_bundles(self):
        raise _refuse("[export_bundles] (the warm-handoff bundles)",
                      "plane_route.py:1517")

    def export_bundle_blobs(self):
        raise _refuse("[export_bundle_blobs] (the warm-handoff bundles)",
                      "plane_route.py:1531")

    def import_bundle(self, bundle, segments, mapper):
        raise _refuse("[import_bundle] (the warm-handoff bundles)",
                      "plane_route.py:1622")

    @property
    def tiers(self):
        raise _refuse("[tiers] (PlaneTierManager, the storage tiers)",
                      "plane_route.py:671")

    def release(self) -> None:
        """Release every generation's breaker reservation (the owning
        index is closing or being deleted); in-flight repacks see
        ``_closed`` and drop their build instead of swapping it in, and
        are then JOINED so no repack thread outlives its cache."""
        with self._gen_lock:
            self._closed = True
            racedep.note_write("plane_cache.generations", self)
            gens = list(self._planes.values())
            self._planes.clear()
        for gen in gens:
            self._release_gen(gen)
        self.drain_repacks(timeout=5.0)
