"""Shard-level search over a shard's segments (port of the per-segment path
of ``elasticsearch_tpu/search/shard_search.py``).

:class:`ShardSearcher` runs one request against one shard's segment list:
the query phase executes the query tree per segment into dense (scores,
mask) tensors on the segments' device (``search/query_dsl.py``: K16–K18),
applies liveness and ``min_score``, counts the matches and takes each
segment's top window with K19 (``ops/topk.py``); the host merges the
segments' candidates (score desc, segment asc, doc asc), pages them and
fetches ``_source``.

With a ``plane_provider`` (``ServingPlaneCache.plane_for``), an eligible
bag-of-terms query (``search/plane_route.py``) takes the serving route
instead: the micro-batcher (``search/microbatch.py``) coalesces it with
concurrent requests into one ``DistributedSearchPlane.serve`` dispatch
over the serving generation (packed base + delta tier), pruned by
default and eager under ``track_total_hits: true`` or ``prune: false``.

With ``aggs`` (or ``aggregations``), the aggregation tree
(``search/aggregations.py``) runs after the query phase over each
segment's mask as the query left it, a tensor on the card: the device
routes (K12–K14) read it there, and a host copy is made only when an
aggregator's host branch asks for one. ``size: 0`` takes no top-k (K19
is not launched). A body with aggs never takes the serving route.

The bodies served: ``query``, ``size``, ``from``, ``min_score``,
``track_total_hits`` (bool or int), score-only ``search_after``,
``prune``, ``_source`` and ``aggs``/``aggregations``. Every other body
key, and the kNN and fused providers, raise an error that names the
feature and the ROADMAP item that ports it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common.errors import IllegalArgumentError
from ..device import resolve_device
from ..index.mapping import MapperService
from ..index.segment import Segment
from ..ops.topk import get_topk_kernel
from .aggregations import (AggregationContext, BucketAggregator, TopHitsAgg,
                           parse_aggs, run_aggregations)
from .fetch import filter_source
from .query_dsl import MatchAllQuery, ShardContext, parse_query

#: the body keys served
BODY_KEYS = frozenset({"query", "size", "from", "min_score",
                       "track_total_hits", "search_after", "prune",
                       "_source", "aggs", "aggregations"})

#: body keys of the reference's shard search not ported yet: key ->
#: (ROADMAP item, where the reference reads it)
NOT_PORTED = {
    "knn": ("A6b", "search/shard_search.py:388"),
    "sort": ("A6b", "search/shard_search.py:401"),
    "rank": ("A6b", "search/shard_search.py:403"),
    "rescore": ("A6b", "search/shard_search.py:404"),
    "collapse": ("A6b", "search/shard_search.py:405"),
    "profile": ("A6b", "search/shard_search.py:406"),
    "suggest": ("A6b", "search/shard_search.py:407"),
    "stored_fields": ("A6b", "search/shard_search.py:779"),
    "docvalue_fields": ("A6b", "search/shard_search.py:786"),
    "fields": ("A6b", "search/shard_search.py:787"),
    "highlight": ("A6b", "search/shard_search.py:788"),
}


def _refuse(what: str, item: str, where: str) -> IllegalArgumentError:
    return IllegalArgumentError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP {item}; "
        f"reference {where})")


def _tree_needs_scores(aggs: dict) -> bool:
    for a in aggs.values():
        if isinstance(a, TopHitsAgg):
            return True
        if isinstance(a, BucketAggregator) and _tree_needs_scores(a.subs):
            return True
    return False


@dataclass
class ShardHit:
    doc_id: str
    score: Optional[float]
    seg_idx: int
    local_doc: int
    source: Optional[dict]
    sort_values: Optional[List[Any]] = None
    seq_no: Optional[int] = None
    ignored: Optional[List[str]] = None


@dataclass
class ShardSearchResult:
    total: int
    total_relation: str
    hits: List[ShardHit]
    max_score: Optional[float]
    aggregations: Optional[Dict[str, Any]] = None


class ShardSearcher:
    """Executes one search request against one shard's segment list, on
    ``device`` (``None`` means ``cuda``), which must be the segments'.
    ``plane_provider(segments, field)`` returns the serving generation for
    a text field, or None (the per-segment path serves)."""

    def __init__(self, segments: List[Segment], mapper: MapperService,
                 plane_provider=None, knn_plane_provider=None,
                 fused_provider=None, *, device=None):
        for name, prov in (("knn_plane_provider", knn_plane_provider),
                           ("fused_provider", fused_provider)):
            if prov is not None:
                raise _refuse(f"[{name}]", "A2b",
                              "search/shard_search.py:171")
        self.plane_provider = plane_provider
        self.device = resolve_device(device)
        self.segments = [s for s in segments if s.n_docs > 0]
        for s in self.segments:
            if s.device != self.device:
                raise ValueError(f"segment [{s.seg_id}] lies on {s.device}, "
                                 f"the searcher runs on {self.device}")
        self.mapper = mapper
        self.ctx = ShardContext(self.segments, mapper)

    @staticmethod
    def _shard_doc(seg_idx: int, doc: int) -> int:
        """Stable tiebreak key over (segment, doc) — ES's ``_shard_doc``."""
        return (seg_idx << 32) | doc

    def _segment_mask(self, query, seg: Segment):
        scores, mask = query.execute(self.ctx, seg)
        mask = mask & seg.live_dev
        if seg.has_nested:
            # hidden block-join children never surface at top level
            mask = mask & seg.parent_mask_dev
        return scores, mask

    def search(self, body: Optional[dict] = None, *, size: int = 10,
               from_: int = 0, min_score: Optional[float] = None,
               track_total_hits=True) -> ShardSearchResult:
        body = body or {}
        for key in body:
            if key in BODY_KEYS:
                continue
            item, where = NOT_PORTED.get(
                key, ("A6b", "search/shard_search.py:376"))
            raise _refuse(f"the search body key [{key}]", item, where)
        size = int(body.get("size", size))
        from_ = int(body.get("from", from_))
        min_score = body.get("min_score", min_score)
        track_total_hits = body.get("track_total_hits", track_total_hits)
        query_spec = body.get("query")
        # block-max pruning knob (rank-safe WAND-as-a-scan on the plane
        # route): absent → pruned only when totals are already
        # approximate (Lucene disables WAND under exact total tracking);
        # true → force pruned (totals become "gte" lower bounds under an
        # early exit); false → force the eager scan
        prune_opt = body.get("prune")
        if prune_opt is not None and not isinstance(prune_opt, bool):
            raise IllegalArgumentError(
                f"[prune] must be a boolean, got [{prune_opt}]")
        query = parse_query(query_spec) if query_spec else MatchAllQuery()
        aggs_spec = body.get("aggs") or body.get("aggregations")
        aggs = parse_aggs(aggs_spec) if aggs_spec else None
        search_after = body.get("search_after")
        k = size + from_
        window = k

        # --- plane route ----------------------------------------------------
        # Eligible bag-of-terms queries run through the serving plane: one
        # dispatch returns top-k AND totals. The provider hands back a
        # serving GENERATION (packed base + append-only delta tier merged
        # per dispatch — plane_route.py), or None both when the route is
        # ineligible and while a structural change (merge/delete) has the
        # base mid-repack — the per-segment path below serves the gap.
        plane_route = None
        if (self.plane_provider is not None and query_spec and window > 0
                and min_score is None and search_after is None):
            from .plane_route import body_eligible, extract_bag_of_terms
            if body_eligible(body):
                ext = extract_bag_of_terms(query_spec, self.mapper)
                if ext is not None:
                    plane = self.plane_provider(self.segments, ext[0])
                    if plane is not None:
                        plane_route = (plane, ext[1])

        # --- query phase (device) -----------------------------------------
        pending = []
        agg_pending = []
        total = 0
        candidates: List[Tuple[float, int, int]] = []
        plane_total_gte = False
        if plane_route is not None:
            total, plane_total_gte, candidates = self._serve_plane(
                plane_route, window, prune_opt, track_total_hits)
        for seg_idx, seg in enumerate(
                self.segments if plane_route is None else ()):
            scores, mask = self._segment_mask(query, seg)
            dev = seg.device
            if min_score is not None:
                mask = mask & (scores >= torch.tensor(
                    np.float32(min_score), device=dev))
            count_dev = mask.sum() if track_total_hits is not False else None
            vals_dev = idx_dev = None
            if window > 0:
                # push the search_after cursor into the selection mask so
                # the per-segment top-k window starts AFTER the cursor —
                # otherwise docs tied on score beyond the global top-k are
                # unreachable on later pages (totals keep the full mask)
                sel_mask = mask
                if search_after is not None:
                    a_sc = torch.tensor(np.float32(float(search_after[0])),
                                        device=dev)
                    if len(search_after) > 1:
                        asd = int(search_after[1])
                        a_si, a_d = asd >> 32, asd & 0xFFFFFFFF
                        if seg_idx < a_si:
                            cond = scores < a_sc
                        elif seg_idx == a_si:
                            cond = (scores < a_sc) | (
                                (scores == a_sc) &
                                (torch.arange(seg.n_pad, device=dev) > a_d))
                        else:
                            cond = scores <= a_sc
                    else:
                        cond = scores < a_sc
                    sel_mask = mask & cond
                kk = min(max(window, 1), seg.n_pad)
                topk = get_topk_kernel(seg.n_pad, kk)
                vals_dev, idx_dev = topk(scores, sel_mask)
            pending.append((seg_idx, count_dev, vals_dev, idx_dev))
            if aggs is not None:
                agg_pending.append((seg, mask, scores))

        for seg_idx, count_dev, vals_dev, idx_dev in pending:
            if count_dev is not None:
                total += int(count_dev)
            if vals_dev is not None:
                vals = vals_dev.cpu().numpy()
                idx = idx_dev.cpu().numpy()
                ok = vals > float("-inf")
                for v, d in zip(vals[ok], idx[ok]):
                    candidates.append((float(v), seg_idx, int(d)))
        candidates.sort(key=lambda c: (-c[0], c[1], c[2]))

        # --- ranking → page ------------------------------------------------
        max_score: Optional[float] = None
        if candidates:
            max_score = candidates[0][0]
        if search_after is not None:
            # search_after on _score desc. Hits carry a [score, shard_doc]
            # composite cursor (ES's implicit _shard_doc tiebreak under
            # PIT); when the client passes it back, docs tied on score
            # paginate correctly instead of being skipped by a bare
            # strict-< filter.
            after = float(search_after[0])
            if len(search_after) > 1:
                after_sd = int(search_after[1])
                candidates = [
                    c for c in candidates
                    if c[0] < after or
                    (c[0] == after and self._shard_doc(c[1], c[2])
                     > after_sd)]
            else:
                candidates = [c for c in candidates if c[0] < after]
        page = [(float(sc), si, d, [float(sc), self._shard_doc(si, d)])
                for sc, si, d in candidates[from_: from_ + size]]
        total_relation = "eq"
        if track_total_hits is False:
            total = len(candidates)
            total_relation = "gte" if total >= k else "eq"
        elif isinstance(track_total_hits, int) and not isinstance(
                track_total_hits, bool) and total > track_total_hits:
            total = track_total_hits
            total_relation = "gte"
        elif plane_total_gte:
            # block-max pruned dispatch early-exited: the skipped
            # blocks' docs were never counted — the total is an honest
            # lower bound (Lucene's WAND total semantics)
            total_relation = "gte"

        # --- fetch phase ---------------------------------------------------
        source_spec = body.get("_source", True)
        if not self.mapper.source_enabled:
            source_spec = False
        hits = []
        for score, seg_idx, d, sort_values in page:
            seg = self.segments[seg_idx]
            src = seg.sources[d]
            hit = ShardHit(
                doc_id=seg.doc_uids[d], score=score, seg_idx=seg_idx,
                local_doc=d, source=filter_source(src, source_spec),
                sort_values=sort_values, seq_no=int(seg.seq_nos[d]))
            ign = seg.keyword_fields.get("_ignored")
            if ign is not None and ign.dv_docs_host.size:
                # dv pairs are doc-sorted: O(log M) slice per hit
                lo_i = int(np.searchsorted(ign.dv_docs_host, d, "left"))
                hi_i = int(np.searchsorted(ign.dv_docs_host, d, "right"))
                if hi_i > lo_i:
                    hit.ignored = [ign.ord_terms[o] for o in
                                   ign.dv_ords_host[lo_i:hi_i]]
            hits.append(hit)

        agg_results = None
        if aggs is not None:
            # each segment's mask goes as the query left it, on the card;
            # scores come to the host only for a tree with top_hits
            seg_scores = ({seg.seg_id: sc.cpu().numpy()
                           for seg, _, sc in agg_pending}
                          if _tree_needs_scores(aggs) else {})
            agg_ctx = AggregationContext(self.mapper, shard_ctx=self.ctx,
                                         seg_scores=seg_scores)
            agg_results = run_aggregations(
                aggs, agg_ctx, [(seg, m) for seg, m, _ in agg_pending])
        return ShardSearchResult(total=total, total_relation=total_relation,
                                 hits=hits, max_score=max_score,
                                 aggregations=agg_results)

    def _serve_plane(self, plane_route, window: int, prune_opt,
                     track_total_hits):
        """One request through the plane's micro-batcher: (total, whether
        it is a lower bound, candidates [(score, segment, doc)])."""
        from .microbatch import batched_search
        plane, bag_terms = plane_route
        serving_stages: dict = {}
        serving_info: dict = {}
        # prune resolution: an explicit body knob wins; the default
        # prunes only when the request does not demand exact totals
        # (track_total_hits true = Lucene's complete-collection mode,
        # which disables WAND there too). An explicit prune=false on a
        # tier-bearing plane is counted for the plane_serving health
        # indicator.
        if prune_opt is None:
            prune_eff = False if track_total_hits is True else None
        else:
            prune_eff = prune_opt
        if prune_opt is False and \
                getattr(plane, "blockmax", None) is not None:
            from ..common.telemetry import record_lex
            record_lex(prune_off=True)
        # view=self.segments: hit coordinates must decode against THIS
        # searcher's snapshot even if a refresh mutates the generation's
        # delta while the request sits in the queue
        pvals, phits, ptotal = batched_search(
            plane, bag_terms, k=max(window, 1), stages=serving_stages,
            info=serving_info, view=self.segments, prune=prune_eff)
        from ..parallel.dist_search import total_is_lower_bound, total_value
        candidates = [(float(v), si, d) for v, (si, d) in zip(pvals, phits)]
        # trace: the micro-batch dispatch as one leaf span under the
        # ambient shard span (stage timings arrive after the fact)
        from ..common import tracing as _tracing
        _tracing.record_point(
            "plane_dispatch", took_ms=sum(serving_stages.values()),
            attrs={**{s: round(ms, 3) for s, ms in serving_stages.items()},
                   **serving_info})
        return total_value(ptotal), total_is_lower_bound(ptotal), candidates

    def count(self, body: Optional[dict] = None) -> int:
        body = body or {}
        query = (parse_query(body["query"]) if body.get("query")
                 else MatchAllQuery())
        total = 0
        for seg in self.segments:
            _, mask = self._segment_mask(query, seg)
            total += int(mask.sum())
        return total
