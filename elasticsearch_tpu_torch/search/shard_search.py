"""Shard-level search over a shard's segments (port of the per-segment path
of ``elasticsearch_tpu/search/shard_search.py``).

:class:`ShardSearcher` runs one request against one shard's segment list:
the query phase executes the query tree per segment into dense (scores,
mask) tensors on the segments' device (``search/query_dsl.py``: K16–K18),
applies liveness and ``min_score``, counts the matches and takes each
segment's top window with K19 (``ops/topk.py``); the host merges the
segments' candidates (score desc, segment asc, doc asc), pages them and
fetches ``_source``.

The bodies served: ``query``, ``size``, ``from``, ``min_score``,
``track_total_hits`` (bool or int), score-only ``search_after`` and
``_source``. Every other body key, and the serving-plane providers, raise
an error that names the feature and the ROADMAP item that ports it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..common.errors import IllegalArgumentError
from ..device import resolve_device
from ..index.mapping import MapperService
from ..index.segment import Segment
from ..ops.topk import get_topk_kernel
from .fetch import filter_source
from .query_dsl import MatchAllQuery, ShardContext, parse_query

#: the body keys served
BODY_KEYS = frozenset({"query", "size", "from", "min_score",
                       "track_total_hits", "search_after", "_source"})

#: body keys of the reference's shard search not ported yet: key ->
#: (ROADMAP item, where the reference reads it)
NOT_PORTED = {
    "aggs": ("A6c", "search/shard_search.py:399"),
    "aggregations": ("A6c", "search/shard_search.py:399"),
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
    "prune": ("A2a", "search/shard_search.py:394"),
}


def _refuse(what: str, item: str, where: str) -> IllegalArgumentError:
    return IllegalArgumentError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP {item}; "
        f"reference {where})")


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


class ShardSearcher:
    """Executes one search request against one shard's segment list, on
    ``device`` (``None`` means ``cuda``), which must be the segments'."""

    def __init__(self, segments: List[Segment], mapper: MapperService,
                 plane_provider=None, knn_plane_provider=None,
                 fused_provider=None, *, device=None):
        for name, prov, item in (
                ("plane_provider", plane_provider, "A2a"),
                ("knn_plane_provider", knn_plane_provider, "A2b"),
                ("fused_provider", fused_provider, "A2b")):
            if prov is not None:
                raise _refuse(f"[{name}]", item,
                              "search/shard_search.py:171")
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
        query = parse_query(query_spec) if query_spec else MatchAllQuery()
        search_after = body.get("search_after")
        k = size + from_
        window = k

        # --- query phase (device) -----------------------------------------
        pending = []
        for seg_idx, seg in enumerate(self.segments):
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

        total = 0
        candidates: List[Tuple[float, int, int]] = []
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
        return ShardSearchResult(total=total, total_relation=total_relation,
                                 hits=hits, max_score=max_score)

    def count(self, body: Optional[dict] = None) -> int:
        body = body or {}
        query = (parse_query(body["query"]) if body.get("query")
                 else MatchAllQuery())
        total = 0
        for seg in self.segments:
            _, mask = self._segment_mask(query, seg)
            total += int(mask.sum())
        return total
