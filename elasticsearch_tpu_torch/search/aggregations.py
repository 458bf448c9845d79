"""Aggregations: bucket/metric/pipeline analytics over search results.

Re-design of the reference's aggregation framework
(``search/aggregations/`` — 498 files; two-pass model: per-segment
``Aggregator.collect(doc)`` into BigArrays buckets, then coordinator
``InternalAggregation.reduce`` — ``search/aggregations/AggregatorBase.java``,
``InternalAggregations.java``).

TPU-first execution model: there is no per-doc collect loop. The query tree
already produced a dense ``(scores, mask)`` pair per segment on device; each
aggregation is a *masked columnar reduction* over the segment's doc-values
pair columns ``(docs, values)``:

1. the per-pair mask is one device gather: ``pair_mask = mask[docs]``;
2. bucket assignment and reductions are vectorized array ops — ordinal
   ``segment_sum`` for terms, ``floor((v-offset)/interval)`` for histograms,
   masked sum/min/max for metrics (see ``ops/aggs.py`` for the device
   kernels used on the hot paths; exact float64 reductions run host-side
   where TPU f32 would lose precision, e.g. epoch-millis histograms);
3. per-segment partials are plain dicts merged by ``Aggregator.reduce`` —
   the same merge runs across shards on the coordinating side.

Sub-aggregations refine the parent's mask per bucket (array AND), which maps
the reference's bucket-ordinal machinery onto plain mask algebra.

Port of ``elasticsearch_tpu/search/aggregations.py``. The query phase
leaves each segment's mask as a ``bool[n_pad]`` tensor on the segment's
device, and the aggregators with device routes (terms: K12's counts;
HLL cardinality: K12's prefix and K13's registers; histogram and
fixed-interval date_histogram: K14's counts) take that tensor as it is
(:attr:`Aggregator.reads_device_mask`). Every other aggregator, and the
host branches of those four, read a host copy that
:meth:`AggregationContext.host_mask` makes at most once a segment a
request, and only when asked. Sub-bucket masks are built on the host and
go up through ``ops.aggs.device_mask``, as the reference's
``_device_mask`` does. :func:`mask_transfers` counts both moves.
``scripted_metric`` needs the script service and is refused (ROADMAP A8).
"""

from __future__ import annotations

import math
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common.errors import (ElasticsearchError,
                             IllegalArgumentError, ParsingError)
from ..index.mapping import (
    BooleanFieldType, DateFieldType, KeywordFieldType, MapperService,
    NumberFieldType, RangeFieldType, RuntimeFieldType, format_date_millis,
    parse_date_millis)
from ..index.segment import Segment
from ..ops import aggs as ops_aggs

INT_TYPES = {"long", "integer", "short", "byte"}


def _mix64(v: int) -> int:
    """hppc ``BitMixer.mix64`` (Stafford mix13 variant, NOT murmur
    fmix64) — the hash behind numeric terms partitioning
    (``IncludeExclude.PartitionedLongFilter``)."""
    m = (1 << 64) - 1
    v &= m
    v = ((v ^ (v >> 32)) * 0x4CD6944C5CC20B6D) & m
    v = ((v ^ (v >> 29)) * 0xFC12C5B19D3259E9) & m
    return v ^ (v >> 32)


_MASK_MOVES = {"d2h": 0, "d2h_bytes": 0, "h2d": 0, "h2d_bytes": 0}
_MASK_MOVES_LOCK = threading.Lock()


def _count_move(way: str, nbytes: int) -> None:
    with _MASK_MOVES_LOCK:
        _MASK_MOVES[way] += 1
        _MASK_MOVES[f"{way}_bytes"] += int(nbytes)


def mask_transfers(reset: bool = False) -> Dict[str, int]:
    """Masks moved between host and device since the last reset: host
    copies of a query's mask (``d2h``) and uploads of host masks
    (``h2d``), with their bytes. A segment on the CPU counts the same
    calls, though its host copy is a view."""
    with _MASK_MOVES_LOCK:
        out = dict(_MASK_MOVES)
        if reset:
            for k in _MASK_MOVES:
                _MASK_MOVES[k] = 0
    return out


def _query_mask_to_host(mask: torch.Tensor) -> np.ndarray:
    host = mask.cpu().numpy()
    _count_move("d2h", host.nbytes)
    return host


def _device_mask(seg, mask):
    """A segment's mask on its device: the query's tensor as it is, or a
    host mask (a sub-bucket's) uploaded padded to ``n_pad`` (pair-doc
    sentinels gather False)."""
    if isinstance(mask, torch.Tensor):
        return mask
    dev = ops_aggs.device_mask(seg, mask, device=seg.device)
    _count_move("h2d", dev.numel() * dev.element_size())
    return dev


# ---------------------------------------------------------------------------
# value sources
# ---------------------------------------------------------------------------


def _concrete(mapper, field: str) -> str:
    """Field alias → target path (FieldAliasMapper)."""
    if mapper is None:
        return field
    ft = mapper.field_type(field)
    return ft.name if ft is not None and ft.name != field else field


def _numeric_pairs(seg: Segment, field: str, mapper=None):
    """(docs int32[M], vals float64[M]) host-side exact values, or None.
    Runtime fields materialize their computed column as pairs."""
    field = _concrete(mapper, field)
    f = seg.numeric_fields.get(field)
    if f is not None and f.docs_host.shape[0] > 0:
        return f.docs_host, f.vals_host
    if mapper is not None:
        ft = mapper.field_type(field)
        if isinstance(ft, RuntimeFieldType):
            col = ft.column(seg)[: seg.n_docs]
            docs = np.flatnonzero(~np.isnan(col)).astype(np.int32)
            if docs.size:
                return docs, col[docs]
    return None


def _doc_weights(seg: Segment):
    """float64[n_docs] per-doc count weights from the _doc_count meta
    field (DocCountFieldMapper), or None when absent."""
    dc = seg.numeric_fields.get("_doc_count")
    if dc is None or dc.docs_host.size == 0:
        return None
    w = np.ones(seg.n_docs, np.float64)
    w[dc.docs_host] = dc.vals_host
    return w


def _keyword_pairs(seg: Segment, field: str, mapper=None):
    """(docs int32[M], ords int32[M], ord_terms list) or None."""
    field = _concrete(mapper, field)
    f = seg.keyword_fields.get(field)
    if f is None or f.dv_docs_host.shape[0] == 0:
        return None
    return f.dv_docs_host, f.dv_ords_host, f.ord_terms


def _field_type(mapper: MapperService, field: str):
    return mapper.field_type(field)


def _is_date(mapper, field) -> bool:
    return isinstance(_field_type(mapper, field), DateFieldType)


def _is_int(mapper, field) -> bool:
    ft = _field_type(mapper, field)
    return isinstance(ft, NumberFieldType) and ft.type_name in INT_TYPES


def _format_key(mapper, field, v: float):
    if _is_date(mapper, field):
        return v, format_date_millis(v)
    if _is_int(mapper, field):
        return int(v), None
    return v, None


# ---------------------------------------------------------------------------
# framework
# ---------------------------------------------------------------------------


class Aggregator:
    """One node of the aggregation tree. ``collect`` runs per segment with
    the query's host-side doc mask; ``reduce`` merges partials from all
    segments of a shard — and, unchanged, partials from all shards."""

    name: str

    #: ``collect`` at the top of the tree takes the query's device tensor
    #: (it has a device route and makes its own host copy only where a
    #: host branch reads the mask); every other aggregator gets the host
    #: copy
    reads_device_mask = False

    def collect(self, ctx, seg: Segment, mask: np.ndarray) -> Any:
        raise NotImplementedError

    def reduce(self, partials: List[Any]) -> dict:
        raise NotImplementedError


class AggregationContext:
    """Carries the mapper, the shard query context (for filter sub-queries)
    and per-segment scores (for top_hits) through the tree."""

    def __init__(self, mapper: MapperService, shard_ctx=None,
                 seg_scores: Optional[Dict[str, np.ndarray]] = None,
                 wire: bool = False):
        self.mapper = mapper
        self.shard_ctx = shard_ctx
        self.seg_scores = seg_scores or {}
        #: partials will cross the transport: aggregators that stage live
        #: segment refs must use their data-only collect_wire form
        self.wire = wire
        #: id(query mask tensor) -> (the tensor, its host copy)
        self._host_masks: Dict[int, Tuple[torch.Tensor, np.ndarray]] = {}

    def host_mask(self, mask) -> np.ndarray:
        """A segment's mask on the host: a host mask as it is; the query's
        tensor copied once, on the first call that asks for it."""
        if not isinstance(mask, torch.Tensor):
            return mask
        hit = self._host_masks.get(id(mask))
        if hit is None:
            hit = self._host_masks[id(mask)] = (mask,
                                                _query_mask_to_host(mask))
        return hit[1]


def parse_aggs(spec: dict) -> Dict[str, Aggregator]:
    if not isinstance(spec, dict):
        raise ParsingError("aggregations must be an object")
    out: Dict[str, Aggregator] = {}
    for name, body in spec.items():
        if not isinstance(body, dict):
            raise ParsingError(f"aggregation [{name}] must be an object")
        sub_spec = body.get("aggs") or body.get("aggregations") or {}
        kinds = [k for k in body if k not in ("aggs", "aggregations", "meta")]
        if len(kinds) != 1:
            raise ParsingError(
                f"aggregation [{name}] must define exactly one type, "
                f"got {kinds}")
        kind = kinds[0]
        factory = _AGG_PARSERS.get(kind)
        if factory is None:
            raise ParsingError(f"unknown aggregation type [{kind}]")
        agg = factory(body[kind])
        agg.name = name
        agg.kind = kind
        agg._raw = body[kind] if isinstance(body[kind], dict) else {}
        agg.meta = body.get("meta")
        subs = parse_aggs(sub_spec) if sub_spec else {}
        if subs and not isinstance(agg, BucketAggregator):
            raise ParsingError(
                f"aggregation [{name}] of type [{kind}] cannot have "
                f"sub-aggregations")
        if isinstance(agg, BucketAggregator):
            # rate descendants resolve their per-unit factor from the
            # CLOSEST enclosing date_histogram (RateAggregator's parent
            # Rounding); subtrees build before parents, so walking all
            # descendants here stamps any not yet claimed by a nearer one
            if isinstance(agg, DateHistogramAgg):
                if agg.fixed_ms is not None:
                    interval_ms = agg.fixed_ms
                else:
                    from .aggs_analytics import _UNIT_MS
                    unit_names = {
                        "s": "second", "m": "minute", "h": "hour",
                        "d": "day", "w": "week", "M": "month",
                        "q": "quarter", "y": "year"}
                    interval_ms = _UNIT_MS[unit_names[agg.calendar_unit]]

                def _stamp(tree):
                    for sa in tree.values():
                        if getattr(sa, "_needs_parent_interval", False) \
                                and sa._parent_interval_ms is None:
                            sa._parent_interval_ms = interval_ms
                        if getattr(sa, "subs", None):
                            _stamp(sa.subs)
                _stamp(subs)
            # composite may only nest under SINGLE-bucket parents
            single_bucket = {"FilterAgg", "NestedAgg", "ReverseNestedAgg",
                             "GlobalAgg", "MissingAgg", "SamplerAgg"}
            for sn, sa in subs.items():
                if type(sa).__name__ == "CompositeAgg" and \
                        type(agg).__name__ not in single_bucket:
                    raise IllegalArgumentError(
                        f"[composite] aggregation cannot be used with a "
                        f"parent aggregation of type: "
                        f"[{type(agg).__name__}]")
            agg.subs = subs
        if isinstance(agg, PipelineAggregator) and subs:
            raise ParsingError(
                f"pipeline aggregation [{name}] cannot have sub-aggregations")
        out[name] = agg
    return out


def run_aggregations(aggs: Dict[str, Aggregator], ctx: AggregationContext,
                     seg_masks: List[Tuple[Segment, np.ndarray]]) -> dict:
    """Collect every segment then reduce — shard-level entry point.
    Pipeline aggs run last, over their sibling's reduced output."""
    return run_aggregations_multi(
        aggs, [(ctx, seg, mask) for seg, mask in seg_masks])


#: search.max_buckets cluster setting (mutable; REST layer updates it)
MAX_BUCKETS = [65536]


def _count_buckets(node) -> int:
    total = 0
    if isinstance(node, dict):
        b = node.get("buckets")
        if isinstance(b, list):
            total += len(b)
            for item in b:
                total += _count_buckets(item)
        elif isinstance(b, dict):
            total += len(b)
            for item in b.values():
                total += _count_buckets(item)
        else:
            for v in node.values():
                if isinstance(v, dict):
                    total += _count_buckets(v)
    return total


def _check_max_buckets(result: dict) -> None:
    limit = MAX_BUCKETS[0]
    n = sum(_count_buckets(v) for v in result.values()
            if isinstance(v, dict))
    if n > limit:
        raise IllegalArgumentError(
            f"Trying to create too many buckets. Must be less than or "
            f"equal to: [{limit}] but was [{n}]. This limit can be set "
            f"by changing the [search.max_buckets] cluster level "
            f"setting.")


def run_aggregations_multi(
        aggs: Dict[str, Aggregator],
        ctx_seg_masks: List[Tuple[AggregationContext, Segment, np.ndarray]],
        extra_partials: Optional[Dict[str, list]] = None,
) -> dict:
    """Cross-index entry point: each segment collects under its *own*
    index's context (mapper + term stats), then one shared reduce — the
    reference reduces per-shard trees the same way
    (``SearchPhaseController.java:211-219``). ``extra_partials`` carries
    already-collected partials from REMOTE shards (the cluster tier) into
    the same reduce."""
    from ..common.breakers import DEFAULT as _breakers
    from ..common.breakers import estimate_partial_bytes
    request_breaker = _breakers.breaker("request")
    result: Dict[str, dict] = {}
    pipelines: Dict[str, PipelineAggregator] = {}
    for name, agg in aggs.items():
        if isinstance(agg, PipelineAggregator):
            pipelines[name] = agg
            continue
        # collection-time accounting (the reference's BigArrays accounts
        # DURING bucket growth, ``AggregatorBase.addRequestCircuitBreaker-
        # Bytes``): reserve each segment's partial AS it is produced, so
        # a pathological high-cardinality agg trips BEFORE the next
        # segment's partial is even materialized — not after everything
        # is already resident
        partials = []
        reserved = 0
        try:
            for ctx, seg, mask in ctx_seg_masks:
                p = agg.collect(ctx, seg, mask if agg.reads_device_mask
                                else ctx.host_mask(mask))
                step = estimate_partial_bytes(p)
                request_breaker.add_estimate(step, f"<agg [{name}]>")
                reserved += step
                partials.append(p)
            for p in (extra_partials or {}).get(name, ()):
                step = estimate_partial_bytes(p)
                request_breaker.add_estimate(step, f"<agg [{name}]>")
                reserved += step
                partials.append(p)
            result[name] = agg.reduce(partials)
        finally:
            request_breaker.release(reserved)
        _apply_parent_pipes(agg, result[name])
        if getattr(agg, "meta", None) is not None:
            result[name]["meta"] = agg.meta
    for name, p in pipelines.items():
        result[name] = p.apply(result)
        if getattr(p, "meta", None) is not None:
            result[name]["meta"] = p.meta
    _check_max_buckets(result)
    return result


def inject_mapper(aggs: Dict[str, "Aggregator"], mapper) -> None:
    """Give every aggregator (recursively) the mapper its reduce-side
    rendering needs (key_as_string, date formats). Locally this happens
    as a side effect of ``collect`` (``self._mapper = ctx.mapper``); a
    coordinator reducing REMOTE partials never ran collect, so the
    cluster tier injects the mapper explicitly before the shared reduce
    (the reference ships formatters inside serialized
    ``InternalAggregation`` trees instead)."""
    for agg in aggs.values():
        agg._mapper = mapper
        subs = getattr(agg, "subs", None)
        if subs:
            inject_mapper(subs, mapper)


def _collect_fn(agg, ctx):
    """collect, or collect_wire when the partial will cross the wire."""
    if getattr(ctx, "wire", False):
        return getattr(agg, "collect_wire", agg.collect)
    return agg.collect


def _sub_results(agg: "BucketAggregator", ctx, seg, bucket_mask) -> dict:
    return {n: _collect_fn(a, ctx)(ctx, seg, bucket_mask)
            for n, a in agg.subs.items()}


def _reduce_subs(agg: "BucketAggregator", partial_lists: List[dict]) -> dict:
    out = {}
    pipelines = {}
    for n, a in agg.subs.items():
        if isinstance(a, PipelineAggregator):
            if not a.parent_pipeline:
                pipelines[n] = a
            continue
        out[n] = a.reduce([x for x in (p.get(n) for p in partial_lists)
                           if x is not None])
        _apply_parent_pipes(a, out[n])
    for n, p in pipelines.items():
        out[n] = p.apply(out)
    return out


class BucketAggregator(Aggregator):
    subs: Dict[str, Aggregator] = {}


class PipelineAggregator(Aggregator):
    """Computed from sibling reduced output, no per-doc collection
    (reference: ``search/aggregations/pipeline/``)."""

    #: parent pipelines (derivative, cumulative_sum, moving_fn, …) run
    #: over their PARENT bucket agg's reduced bucket list, not a sibling
    parent_pipeline = False

    def collect(self, ctx, seg, mask):
        return None

    def reduce(self, partials):
        return {}

    def apply(self, sibling_results: dict) -> dict:
        raise NotImplementedError

    def apply_parent(self, name: str, parent_node: dict) -> None:
        raise NotImplementedError


def _bucket_series(blist: List[dict], path: str) -> List[Any]:
    """Per-bucket metric series for parent pipelines (BucketHelpers with
    gap policy skip on empty buckets)."""
    parts = path.replace(">", ".").split(".")
    out = []
    for b in blist:
        if parts[0] == "_count":
            out.append(b.get("doc_count"))
            continue
        v: Any = b
        for p in parts:
            v = v.get(p) if isinstance(v, dict) else None
        if isinstance(v, dict):
            v = v.get("value")
        out.append(v)
    return out


def _apply_parent_pipes(agg: "Aggregator", node: dict) -> None:
    subs = getattr(agg, "subs", None)
    if not subs or not isinstance(node, dict):
        return
    if "buckets" not in node:
        return
    for pname, p in subs.items():
        if isinstance(p, PipelineAggregator) and p.parent_pipeline:
            p.apply_parent(pname, node)


# ---------------------------------------------------------------------------
# metric aggregations
# ---------------------------------------------------------------------------


class _NumericMetricAgg(Aggregator):
    def __init__(self, body: dict):
        self.field = body.get("field")
        self.missing = body.get("missing")
        if self.field is None:
            raise ParsingError("metric aggregation requires [field]")

    def _with_value_string(self, out: dict) -> dict:
        """Metric values over date fields also serialize formatted
        (value_as_string, like the reference's DocValueFormat)."""
        mapper = getattr(self, "_mapper", None)
        ft = _field_type(mapper, self.field) if mapper else None
        if isinstance(ft, DateFieldType) and out.get("value") is not None:
            out["value_as_string"] = format_date_millis(out["value"])
        return out

    def _matched_values(self, ctx, seg, mask: np.ndarray) -> np.ndarray:
        self._mapper = ctx.mapper
        from ..index.mapping import KeywordFieldType, TextFieldType
        ft = ctx.mapper.field_type(self.field) if ctx.mapper else None
        if isinstance(ft, (TextFieldType, KeywordFieldType)):
            raise IllegalArgumentError(
                f"Field [{self.field}] of type "
                f"[{getattr(ft, 'type_name', 'text')}] is not supported "
                f"for aggregation [{getattr(self, 'name', '?')}]")
        pairs = _numeric_pairs(seg, self.field, ctx.mapper)
        vals_list = []
        if pairs is not None:
            docs, vals = pairs
            pm = mask[docs]
            vals_list.append(vals[pm])
        if self.missing is not None:
            # docs matched by the query but without the field
            has = np.zeros(mask.shape[0], bool)
            if pairs is not None:
                has[pairs[0]] = True
            n_missing = int((mask & ~has).sum())
            if n_missing:
                vals_list.append(np.full(n_missing, float(self.missing)))
        if not vals_list:
            return np.empty(0, np.float64)
        return np.concatenate(vals_list)


class AvgAgg(_NumericMetricAgg):
    def collect(self, ctx, seg, mask):
        v = self._matched_values(ctx, seg, mask)
        return {"sum": float(v.sum()), "count": int(v.size)}

    def reduce(self, partials):
        s = sum(p["sum"] for p in partials)
        c = sum(p["count"] for p in partials)
        return self._with_value_string({"value": (s / c) if c else None})


class SumAgg(_NumericMetricAgg):
    def collect(self, ctx, seg, mask):
        v = self._matched_values(ctx, seg, mask)
        return {"sum": float(v.sum())}

    def reduce(self, partials):
        return {"value": sum(p["sum"] for p in partials)}


class MinAgg(_NumericMetricAgg):
    def collect(self, ctx, seg, mask):
        v = self._matched_values(ctx, seg, mask)
        return {"min": float(v.min()) if v.size else None}

    def reduce(self, partials):
        vals = [p["min"] for p in partials if p["min"] is not None]
        return self._with_value_string(
            {"value": min(vals) if vals else None})


class MaxAgg(_NumericMetricAgg):
    def collect(self, ctx, seg, mask):
        v = self._matched_values(ctx, seg, mask)
        return {"max": float(v.max()) if v.size else None}

    def reduce(self, partials):
        vals = [p["max"] for p in partials if p["max"] is not None]
        return self._with_value_string(
            {"value": max(vals) if vals else None})


class ValueCountAgg(_NumericMetricAgg):
    def __init__(self, body):
        self.field = body.get("field")
        self.missing = body.get("missing")
        if self.field is None:
            raise ParsingError("metric aggregation requires [field]")

    def collect(self, ctx, seg, mask):
        # counts values of any doc-values type
        kw = _keyword_pairs(seg, self.field, ctx.mapper)
        if kw is not None:
            docs, _, _ = kw[0], kw[1], kw[2]
            return {"count": int(mask[kw[0]].sum())}
        v = self._matched_values(ctx, seg, mask)
        return {"count": int(v.size)}

    def reduce(self, partials):
        return {"value": sum(p["count"] for p in partials)}


class StatsAgg(_NumericMetricAgg):
    def collect(self, ctx, seg, mask):
        v = self._matched_values(ctx, seg, mask)
        return {"count": int(v.size), "sum": float(v.sum()),
                "min": float(v.min()) if v.size else None,
                "max": float(v.max()) if v.size else None}

    def reduce(self, partials):
        count = sum(p["count"] for p in partials)
        s = sum(p["sum"] for p in partials)
        mins = [p["min"] for p in partials if p["min"] is not None]
        maxs = [p["max"] for p in partials if p["max"] is not None]
        return {"count": count, "sum": s,
                "min": min(mins) if mins else None,
                "max": max(maxs) if maxs else None,
                "avg": (s / count) if count else None}


class ExtendedStatsAgg(_NumericMetricAgg):
    def __init__(self, body):
        super().__init__(body)
        try:
            self.sigma = float(body.get("sigma", 2.0))
        except (TypeError, ValueError):
            from ..common.errors import XContentParseError
            raise XContentParseError(
                f"[extended_stats] failed to parse field [sigma]: "
                f"[{body.get('sigma')}] is not a number")
        if self.sigma < 0:
            self._sigma_error = True

    def collect(self, ctx, seg, mask):
        if getattr(self, "_sigma_error", False):
            raise IllegalArgumentError(
                f"[sigma] must be greater than or equal to 0. "
                f"Found [{self.sigma}] in [{self.name}]")
        return self._collect_inner(ctx, seg, mask)

    def _collect_inner(self, ctx, seg, mask):
        v = self._matched_values(ctx, seg, mask)
        return {"count": int(v.size), "sum": float(v.sum()),
                "sum_sq": float((v * v).sum()),
                "min": float(v.min()) if v.size else None,
                "max": float(v.max()) if v.size else None}

    def reduce(self, partials):
        count = sum(p["count"] for p in partials)
        s = sum(p["sum"] for p in partials)
        ss = sum(p["sum_sq"] for p in partials)
        mins = [p["min"] for p in partials if p["min"] is not None]
        maxs = [p["max"] for p in partials if p["max"] is not None]
        out = {"count": count, "sum": s,
               "min": min(mins) if mins else None,
               "max": max(maxs) if maxs else None,
               "avg": (s / count) if count else None,
               "sum_of_squares": ss if count else None}
        if count:
            var = max(ss / count - (s / count) ** 2, 0.0)
            std = math.sqrt(var)
            out["variance"] = var
            out["std_deviation"] = std
            out["std_deviation_bounds"] = {
                "upper": s / count + self.sigma * std,
                "lower": s / count - self.sigma * std,
            }
        else:
            out["variance"] = out["std_deviation"] = None
            out["std_deviation_bounds"] = {"upper": None, "lower": None}
        return out


class CardinalityAgg(Aggregator):
    """Distinct-value count. Exact per-shard via value sets below
    ``precision_threshold``; above it the segment collects an HLL++
    register sketch instead (reference:
    ``metrics/CardinalityAggregator.java`` /
    ``HyperLogLogPlusPlus.java``). The regime trigger is the SEGMENT's
    cached distinct-value count (``ops/aggs.distinct_count``) — a
    route-independent property, so the fused planner stages and the
    legacy two-pass path always pick the same representation and
    return identical values. Sketch merge is one elementwise register
    ``maximum`` (ICI-friendly like the top-k payload reduce); mixed
    set/sketch partials fold the raw values into the registers with the
    same scalar hash."""

    PRECISION_DEFAULT = 3000
    reads_device_mask = True

    def __init__(self, body):
        pt = body.get("precision_threshold")
        if pt is not None and int(pt) < 0:
            self._pt_error = int(pt)
        self.missing = body.get("missing")
        self.field = body.get("field")
        if self.field is None:
            raise ParsingError("cardinality requires [field]")
        self.precision_threshold = int(
            body.get("precision_threshold", self.PRECISION_DEFAULT))

    def _use_hll(self, ctx, seg) -> bool:
        if self.missing is not None or self.precision_threshold <= 0:
            return False
        field = _concrete(ctx.mapper, self.field)
        if field not in getattr(seg, "keyword_fields", {}) and \
                field not in getattr(seg, "numeric_fields", {}):
            return False             # runtime/absent fields: exact sets
        return ops_aggs.distinct_count(seg, field) >= \
            self.precision_threshold

    def collect(self, ctx, seg, mask):
        if getattr(self, "_pt_error", None) is not None:
            raise IllegalArgumentError(
                f"[precisionThreshold] must be greater than or equal to "
                f"0. Found [{self._pt_error}] in [{self.name}]")
        if self._use_hll(ctx, seg):
            field = _concrete(ctx.mapper, self.field)
            pairs = ops_aggs.hll_sketch_pairs(seg, field,
                                              device=seg.device)
            if pairs["n_pairs"] >= ops_aggs.DEVICE_MIN_PAIRS:
                # device register-max kernel over the cached sorted
                # pairs; host twin below is bitwise-identical (integer
                # max is order-independent)
                from ..common.telemetry import record_agg_pairs
                record_agg_pairs(pairs["n_pairs"])
                regs = ops_aggs.masked_register_max(
                    pairs["off_dev"], pairs["docs_dev"],
                    pairs["rhos_dev"],
                    _device_mask(seg, mask)).cpu().numpy()[: pairs["m"]]
            else:
                regs = ops_aggs.host_register_max(pairs,
                                                  ctx.host_mask(mask))
            return {"hll": regs, "p": ops_aggs.HLL_P}
        mask = ctx.host_mask(mask)
        kw = _keyword_pairs(seg, self.field, ctx.mapper)
        num = _numeric_pairs(seg, self.field, ctx.mapper) \
            if kw is None else None
        out: set = set()
        has = np.zeros(mask.shape[0], bool)
        if kw is not None:
            docs, ords, terms = kw
            out = {terms[o] for o in np.unique(ords[mask[docs]])}
            has[docs] = True
        elif num is not None:
            docs, vals = num
            out = set(np.unique(vals[mask[docs]]).tolist())
            has[docs] = True
        if self.missing is not None and (mask & ~has).any():
            out.add(self.missing)
        return {"values": out}

    def reduce(self, partials):
        from ..common.telemetry import record_agg_sketch_merge
        regs = None
        sets: List[set] = []
        for p in partials:
            if "hll" in p:
                record_agg_sketch_merge("hll")
                regs = p["hll"].copy() if regs is None \
                    else ops_aggs.hll_merge(regs, p["hll"])
            else:
                record_agg_sketch_merge("exact")
                sets.append(p["values"])
        if regs is None:
            u: set = set()
            for s in sets:
                u |= s
            return {"value": len(u)}
        for s in sets:
            regs = ops_aggs.hll_add_values(regs, s, ops_aggs.HLL_P)
        return {"value": ops_aggs.hll_estimate(regs)}


def _hdr_quantize(chosen: np.ndarray, allv: np.ndarray,
                  digits: int) -> np.ndarray:
    """HdrHistogram DoubleHistogram value quantization. The double→long
    conversion ratio auto-ranges so the smallest nonzero magnitude lands
    in [subBucketHalfCount, subBucketCount); a stored long's reported
    value is the highest long mapping to the same bucket slot
    (``highestEquivalentValue``), scaled back to double space."""
    import math
    sub_bucket_count = 1 << math.ceil(math.log2(2 * 10 ** digits))
    half_bl = (sub_bucket_count // 2).bit_length()
    pos = allv[allv > 0]
    if pos.size == 0:
        return chosen
    vmin = float(pos.min())
    k = (half_bl - 1) - math.floor(math.log2(vmin))
    ratio = 2.0 ** k
    out = []
    for x in chosen.tolist():
        if x <= 0:
            out.append(x)
            continue
        sv = int(x * ratio)
        unit = 1 << max(0, sv.bit_length() - half_bl)
        out.append(((sv // unit) * unit + unit - 1) / ratio)
    return np.asarray(out)


class HdrNegativeValueError(ElasticsearchError):
    """HDR histograms cannot record negatives — the reference throws
    ArrayIndexOutOfBoundsException from DoubleHistogram, failing THAT
    SHARD (its conformance suite asserts exactly this failure type)."""

    status = 500
    error_type = "array_index_out_of_bounds_exception"


class PercentilesAgg(_NumericMetricAgg):
    """Exact percentiles via full value collection (the reference
    approximates with TDigest — ``metrics/TDigestState``; exact is
    stricter and deterministic, sketch planned for giant shards)."""

    DEFAULT_PERCENTS = (1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0)

    def __init__(self, body):
        super().__init__(body)
        percents = body.get("percents", self.DEFAULT_PERCENTS)
        if not isinstance(percents, (list, tuple)) or not percents or \
                any(not isinstance(x, (int, float)) or x < 0 or x > 100
                    for x in percents):
            raise IllegalArgumentError(
                f"[percents] must not be empty and all values must be "
                f"between 0 and 100, got {percents}")
        self.percents = tuple(percents)
        self.keyed = bool(body.get("keyed", True))
        td = body.get("tdigest") or {}
        compression = td.get("compression")
        if compression is not None and float(compression) < 0:
            raise IllegalArgumentError(
                f"[compression] must be greater than or equal to 0. "
                f"Found [{float(compression)}]")
        hdr = body.get("hdr")
        self.hdr = hdr is not None
        self.hdr_digits = 3
        if hdr:
            digits = hdr.get("number_of_significant_value_digits", 3)
            if digits is None or not (0 <= int(digits) <= 5):
                raise IllegalArgumentError(
                    "[numberOfSignificantValueDigits] must be between 0 "
                    "and 5")
            self.hdr_digits = int(digits)

    def collect(self, ctx, seg, mask):
        vals = self._matched_values(ctx, seg, mask)
        if self.hdr and vals.size and float(np.min(vals)) < 0:
            raise HdrNegativeValueError(
                "Histogram recorded value cannot be negative.")
        return {"values": vals}

    def _quantiles(self, allv: np.ndarray):
        if self.hdr:
            # HDR semantics: the recorded value at ceil(q·n) rank, then
            # quantized to the top of its histogram bucket
            # (``DoubleHistogram.getValueAtPercentile`` returns
            # highestEquivalentValue — conformance asserts the exact
            # quantized doubles, e.g. 51 → 51.0302734375)
            v = np.sort(allv)
            # countAtPercentile = max(round(p/100·n), 1) — the +0.5
            # floor rounding in Histogram.getValueAtPercentile
            idx = np.maximum(
                (np.asarray(self.percents) / 100.0 * v.size + 0.5)
                .astype(int), 1) - 1
            chosen = v[np.minimum(idx, v.size - 1)]
            return _hdr_quantize(chosen, allv, self.hdr_digits)
        # Hazen interpolation (q·n − ½): what the reference's TDigest
        # converges to on exactly-held data — its tiny-shard unit
        # expectations (values.1\.0 == min, midpoints between points)
        # only hold under this rule, not numpy's default linear one
        return np.percentile(allv, self.percents, method="hazen")

    def reduce(self, partials):
        allv = np.concatenate([p["values"] for p in partials]) \
            if partials else np.empty(0)
        if allv.size == 0:
            vals = {f"{p}": None for p in self.percents}
        else:
            qs = self._quantiles(allv)
            vals = {f"{p}": float(q) for p, q in zip(self.percents, qs)}
        if self.keyed:
            return {"values": vals}
        return {"values": [{"key": float(p), "value": v}
                           for p, v in vals.items()]}


class PercentileRanksAgg(_NumericMetricAgg):
    def __init__(self, body):
        super().__init__(body)
        self.values = tuple(body.get("values", ()))
        if not self.values:
            raise ParsingError("percentile_ranks requires [values]")
        self.keyed = bool(body.get("keyed", True))

    def collect(self, ctx, seg, mask):
        return {"values": self._matched_values(ctx, seg, mask)}

    def reduce(self, partials):
        allv = np.concatenate([p["values"] for p in partials]) \
            if partials else np.empty(0)
        out = {}
        for v in self.values:
            if allv.size == 0:
                out[f"{float(v)}"] = None
            else:
                out[f"{float(v)}"] = float(
                    (allv <= v).sum() / allv.size * 100.0)
        if self.keyed:
            return {"values": out}
        return {"values": [{"key": float(k), "value": val}
                           for k, val in out.items()]}


class WeightedAvgAgg(Aggregator):
    def __init__(self, body):
        try:
            self.value_field = body["value"]["field"]
            self.weight_field = body["weight"]["field"]
        except (KeyError, TypeError):
            raise ParsingError(
                "weighted_avg requires [value.field] and [weight.field]")

    def collect(self, ctx, seg, mask):
        vp = _numeric_pairs(seg, self.value_field)
        wp = _numeric_pairs(seg, self.weight_field)
        if vp is None or wp is None:
            return {"num": 0.0, "den": 0.0}
        # single-valued join on doc id
        vdocs, vvals = vp
        wdocs, wvals = wp
        wmap = np.zeros(mask.shape[0])
        wmap[wdocs] = wvals
        has_w = np.zeros(mask.shape[0], bool)
        has_w[wdocs] = True
        pm = mask[vdocs] & has_w[vdocs]
        w = wmap[vdocs][pm]
        v = vvals[pm]
        return {"num": float((v * w).sum()), "den": float(w.sum())}

    def reduce(self, partials):
        num = sum(p["num"] for p in partials)
        den = sum(p["den"] for p in partials)
        return {"value": (num / den) if den else None}


class MedianAbsoluteDeviationAgg(_NumericMetricAgg):
    def __init__(self, body):
        super().__init__(body)
        comp = body.get("compression")
        if comp is not None and float(comp) <= 0:
            self._comp_error = float(comp)

    def collect(self, ctx, seg, mask):
        if getattr(self, "_comp_error", None) is not None:
            raise IllegalArgumentError(
                f"[compression] must be greater than 0. "
                f"Found [{self._comp_error}] in [{self.name}]")
        return {"values": self._matched_values(ctx, seg, mask)}

    def reduce(self, partials):
        allv = np.concatenate([p["values"] for p in partials]) \
            if partials else np.empty(0)
        if allv.size == 0:
            return {"value": None}
        med = np.median(allv)
        return {"value": float(np.median(np.abs(allv - med)))}


class TopHitsAgg(Aggregator):
    """Per-bucket top hits (reference: ``metrics/TopHitsAggregator.java``).
    Scores travel in the context; ``sort`` overrides them. Inside a
    ``nested`` agg the mask selects CHILD rows, which render as root hits
    with ``_nested`` coordinates; a sort on a nested field from root
    space rolls child doc values up to the parent (mode min)."""

    def __init__(self, body):
        self.size = int(body.get("size", 3))
        self.from_ = int(body.get("from", 0))
        self.source = body.get("_source", True)
        self.seq_no_primary_term = bool(body.get("seq_no_primary_term",
                                                 False))
        self._sorts = []                 # (field, desc?, nested_path)
        sort = body.get("sort")
        if isinstance(sort, (str, dict)):
            sort = [sort]
        for item in sort or []:
            if isinstance(item, str):
                self._sorts.append((item, item == "_score", None))
            elif isinstance(item, dict):
                for f, spec in item.items():
                    if isinstance(spec, str):
                        self._sorts.append((f, spec == "desc", None))
                    else:
                        spec = spec or {}
                        self._sorts.append(
                            (f, spec.get("order") == "desc",
                             (spec.get("nested") or {}).get("path")))

    def _sort_vals(self, ctx, seg, field, desc):
        """row → value for one sort field, using the ES default sort
        mode (min for asc, max for desc); values on child rows also
        roll up to their parent for root-space sorting."""

        def better(a, b):
            return a > b if desc else a < b

        kw = _keyword_pairs(seg, field)
        direct: Dict[int, Any] = {}
        if kw is not None:
            pdocs, ords, terms = kw
            for d, o in zip(pdocs.tolist(), ords.tolist()):
                v = terms[o]
                if d not in direct or better(v, direct[d]):
                    direct[d] = v
        else:
            num = _numeric_pairs(seg, field, ctx.mapper)
            if num is not None:
                pdocs, nvals = num
                for d, v in zip(pdocs.tolist(), nvals.tolist()):
                    if d not in direct or better(v, direct[d]):
                        direct[d] = v
        rolled: Dict[int, Any] = {}
        for d, v in direct.items():
            r = int(seg.parent_of[d])
            if r != d and (r not in rolled or better(v, rolled[r])):
                rolled[r] = v
        return direct, rolled

    def _nested_coords(self, seg, d):
        """(path, offset, root) for a child row, or None for a root."""
        root = int(seg.parent_of[d])
        if root == d:
            return None
        for path, pm in seg.nested_paths.items():
            if pm[d]:
                siblings = np.flatnonzero(
                    pm & (seg.parent_of[: seg.n_docs] == root))
                return path, int(np.searchsorted(siblings, d)), root
        return None

    def collect(self, ctx, seg, mask):
        scores = getattr(ctx, "seg_scores", {}).get(seg.seg_id)
        docs = np.flatnonzero(mask[: seg.n_docs])
        if docs.size == 0:
            return {"hits": [], "total": 0}
        if scores is not None:
            sc = scores[docs]
        else:
            sc = np.ones(docs.size, np.float32)
        rows = list(range(docs.size))
        sort_keys: Dict[Tuple[int, int], Any] = {}
        if self._sorts:
            for li, (field, desc, _np_) in enumerate(self._sorts):
                if field == "_score":
                    for i in rows:
                        sort_keys[(li, i)] = float(sc[i])
                    continue
                direct, rolled = self._sort_vals(ctx, seg, field, desc)
                for i in rows:
                    d = int(docs[i])
                    sort_keys[(li, i)] = direct.get(d, rolled.get(d))
            # stable multi-key: sort by each level from last to first,
            # missing values always last regardless of direction
            for li in range(len(self._sorts) - 1, -1, -1):
                field, desc, _np_ = self._sorts[li]
                present = [i for i in rows
                           if sort_keys[(li, i)] is not None]
                absent = [i for i in rows if sort_keys[(li, i)] is None]
                present.sort(key=lambda i: sort_keys[(li, i)],
                             reverse=bool(desc))
                rows = present + absent
        else:
            rows = np.lexsort((docs, -sc)).tolist()
        keep = rows[: self.from_ + self.size]
        hits = []
        index_name = getattr(ctx.mapper, "index_name", None)
        for i in keep:
            d = int(docs[i])
            nc = self._nested_coords(seg, d)
            root = nc[2] if nc else d
            src = seg.sources[root]
            if nc and isinstance(src, dict):
                try:
                    obj = src
                    for part in nc[0].split("."):
                        obj = obj[part]
                    src = obj[nc[1]] if isinstance(obj, list) else obj
                except (KeyError, IndexError, TypeError):
                    src = None
            score_sorted = not self._sorts or \
                any(f == "_score" for f, _, _ in self._sorts)
            h = {"_index": index_name, "_id": seg.doc_uids[root],
                 "_score": float(sc[i]) if score_sorted else None,
                 "_source": src if self.source else None}
            if nc:
                h["_nested"] = {"field": nc[0], "offset": nc[1]}
            if self.seq_no_primary_term:
                h["_seq_no"] = int(seg.seq_nos[root])
                h["_primary_term"] = 1
            if self._sorts:
                h["sort"] = [sort_keys[(li, i)]
                             for li in range(len(self._sorts))]
            hits.append(h)
        return {"hits": hits, "total": int(docs.size)}

    def reduce(self, partials):
        total = sum(p["total"] for p in partials)
        allh = [h for p in partials for h in p["hits"]]
        if self._sorts:
            # cross-segment merge with per-level direction: flip the
            # comparison per level via the stable multi-pass again
            for li in range(len(self._sorts) - 1, -1, -1):
                desc = bool(self._sorts[li][1])
                present = [h for h in allh if h["sort"][li] is not None]
                absent = [h for h in allh if h["sort"][li] is None]
                present.sort(key=lambda h: h["sort"][li],
                             reverse=desc)
                allh = present + absent
            max_score = None
        else:
            allh.sort(key=lambda h: (-h["_score"], h["_id"]))
            max_score = allh[0]["_score"] if allh else None
        window = allh[self.from_: self.from_ + self.size]
        return {"hits": {
            "total": {"value": total, "relation": "eq"},
            "max_score": max_score,
            "hits": window}}


# ---------------------------------------------------------------------------
# bucket aggregations
# ---------------------------------------------------------------------------


def _mask_count(seg, bucket_docs_mask) -> int:
    """Doc count of a bucket mask, honoring _doc_count weights."""
    w = _doc_weights(seg)
    if w is None:
        return int(bucket_docs_mask.sum())
    return int(w[bucket_docs_mask[: seg.n_docs]].sum())


def _bucket_payload(agg: BucketAggregator, ctx, seg, bucket_docs_mask):
    """(count, sub_partials) for one bucket in one segment."""
    return (_mask_count(seg, bucket_docs_mask),
            _sub_results(agg, ctx, seg, bucket_docs_mask))


class TermsAgg(BucketAggregator):
    """Bucket per distinct value (reference:
    ``bucket/terms/GlobalOrdinalsStringTermsAggregator.java``). Ordinal
    counting is a segment_sum over the doc-values pair column."""

    reads_device_mask = True

    def __init__(self, body):
        self.field = body.get("field")
        if self.field is None:
            raise ParsingError(
                "Required one of fields [field, script], but none were "
                "specified. ")
        self.size = int(body.get("size", 10))
        self.shard_size = int(body.get("shard_size",
                                       self.size * 3 // 2 + 10))
        self.min_doc_count = int(body.get("min_doc_count", 1))
        self.order = body.get("order", {"_count": "desc"})
        self.missing = body.get("missing")
        self.value_type = body.get("value_type")
        self.include = body.get("include")
        self.exclude = body.get("exclude")

    #: IncludeExclude.HASH_PARTITIONING_SEED
    _PARTITION_SEED = 31

    def _check_regex_support(self, mapper) -> None:
        ft = _field_type(mapper, self.field) if mapper else None
        tn = getattr(ft, "type_name", None)
        for v in (self.include, self.exclude):
            if isinstance(v, str) and tn not in ("keyword", "text", None):
                raise IllegalArgumentError(
                    f"Aggregation [{self.name}] cannot support regular "
                    f"expression style include/exclude settings as they "
                    f"can only be applied to string fields. Use an array "
                    f"of values for include/exclude clauses")

    def _coerce_key(self, mapper, v):
        """An include/exclude/missing value in request space → key space
        (dates parse to epoch millis, booleans to 1/0)."""
        ft = _field_type(mapper, self.field) if mapper else None
        try:
            if isinstance(ft, DateFieldType) or self.value_type == "date":
                return float(parse_date_millis(v))
            if isinstance(ft, BooleanFieldType) or                     self.value_type == "boolean":
                if isinstance(v, bool):
                    return 1.0 if v else 0.0
                return 1.0 if str(v) == "true" else 0.0
            if isinstance(ft, NumberFieldType) or self.value_type in (
                    "long", "double"):
                return float(v)
        except Exception:   # noqa: BLE001 — keep raw on parse failure
            pass
        return v

    def _key_included(self, key) -> bool:
        mapper = getattr(self, "_mapper", None)
        inc, exc = self.include, self.exclude
        if isinstance(inc, dict):            # partition form
            from ..utils.murmur3 import murmur3_32
            n = int(inc.get("num_partitions", 1))
            p = int(inc.get("partition", 0))
            if isinstance(key, (int, float)) and not isinstance(key, bool):
                # LongFilter: floorMod of the SIGNED mixed hash
                h = _mix64(int(key))
                if h >= 1 << 63:
                    h -= 1 << 64
                if h % n != p:               # python % IS floorMod
                    return False
            else:
                h = murmur3_32(str(key).encode(), self._PARTITION_SEED)
                if h >= 1 << 31:
                    h -= 1 << 32
                if h % n != p:
                    return False
        elif isinstance(inc, list):
            if getattr(self, "_inc_coerced", None) is None:
                self._inc_coerced = {self._coerce_key(mapper, v)
                                     for v in inc}
            if key not in self._inc_coerced:
                return False
        elif isinstance(inc, str):
            if re.fullmatch(inc, str(key)) is None:
                return False
        if isinstance(exc, list):
            if getattr(self, "_exc_coerced", None) is None:
                self._exc_coerced = {self._coerce_key(mapper, v)
                                     for v in exc}
            if key in self._exc_coerced:
                return False
        elif isinstance(exc, str):
            if re.fullmatch(exc, str(key)) is not None:
                return False
        return True

    def collect(self, ctx, seg, mask):
        """Per-segment partial: ``(buckets, trunc_err)``. Without sub-aggs,
        counts are exact for every distinct term (vectorized unique/counts —
        no cap needed). With sub-aggs, each term costs a full bucket mask, so
        collection is capped at shard_size ranked by segment-local count and
        ``trunc_err`` carries the last kept count — the upper bound on what a
        dropped term could have had (reference:
        ``InternalTerms.java`` docCountError accounting)."""
        buckets: Dict[Any, Tuple[int, dict]] = {}
        trunc_err = 0
        self._mapper = ctx.mapper        # for key_as_string at reduce
        self._check_regex_support(ctx.mapper)
        qmask = mask
        if self.field == "_index":
            # metadata field: every doc of the segment carries the
            # owning index's name as its single value
            mask = ctx.host_mask(qmask)
            name = getattr(ctx.mapper, "index_name", "") or ""
            cnt = _mask_count(seg, mask)
            if cnt or self.min_doc_count == 0:
                buckets[name] = (_bucket_payload(self, ctx, seg, mask)
                                 if self.subs else (cnt, {}))
            return buckets, 0
        if ctx.mapper is not None and getattr(self, "_raw", {}).get(
                "execution_hint") != "map":
            # global-ordinals execution loads fielddata (stats accounting)
            getattr(ctx.mapper, "fielddata_loaded", set()).add(
                _concrete(ctx.mapper, self.field))
        kw = _keyword_pairs(seg, self.field, ctx.mapper)
        if kw is not None and self.min_doc_count == 0:
            for t in kw[2]:
                buckets.setdefault(t, (0, {}))
        if kw is not None:
            docs, ords, terms = kw
            if docs.shape[0] >= ops_aggs.DEVICE_MIN_PAIRS and \
                    _doc_weights(seg) is None:
                # device hot path: ordinal-CSR cumsum-diff counts (exact
                # int32 — bitwise-identical to the numpy unique path)
                from ..common.telemetry import record_agg_pairs
                record_agg_pairs(docs.shape[0])
                # the concrete field, as _keyword_pairs reads it (the
                # reference passes an alias's own name here and fails)
                off_dev, pdocs_dev, V = ops_aggs.ordinal_csr(
                    seg, _concrete(ctx.mapper, self.field),
                    device=seg.device)
                counts_all = ops_aggs.masked_ordinal_counts(
                    off_dev, pdocs_dev,
                    _device_mask(seg, qmask)).cpu().numpy()[:V]
                sel_ords = np.flatnonzero(counts_all)
                counts = counts_all[sel_ords]
                pm = None
            else:
                mask = ctx.host_mask(qmask)
                pm = mask[docs]
                w = _doc_weights(seg)
                if w is None:
                    sel_ords, counts = np.unique(ords[pm],
                                                 return_counts=True)
                else:
                    sel_ords, inv = np.unique(ords[pm],
                                              return_inverse=True)
                    counts = np.bincount(
                        inv, weights=w[docs[pm]]).astype(np.int64)
            if self.subs:
                if self.include is not None or self.exclude is not None:
                    # filter BEFORE the shard_size cap (the reference's
                    # IncludeExclude runs during collection)
                    keep = np.asarray([self._key_included(terms[int(o)])
                                       for o in sel_ords], bool)
                    sel_ords, counts = sel_ords[keep], counts[keep]
                order = np.argsort(-counts, kind="stable")
                if order.size > self.shard_size:
                    trunc_err = int(counts[order[self.shard_size - 1]])
                    order = order[: self.shard_size]
                if pm is None and order.size:
                    mask = ctx.host_mask(qmask)
                    pm = mask[docs]
                for i in order:
                    o = int(sel_ords[i])
                    bucket_docs = np.zeros(mask.shape[0], bool)
                    bucket_docs[docs[pm & (ords == o)]] = True
                    buckets[terms[o]] = _bucket_payload(self, ctx, seg,
                                                        mask & bucket_docs)
            else:
                for i, c in zip(sel_ords.tolist(), counts.tolist()):
                    buckets[terms[i]] = (int(c), {})
        else:
            num = _numeric_pairs(seg, self.field, ctx.mapper)
            if num is not None:
                docs, vals = num
                mask = ctx.host_mask(qmask)
                pm = mask[docs]
                w = _doc_weights(seg)
                if w is None:
                    sel_vals, counts = np.unique(vals[pm],
                                                 return_counts=True)
                else:
                    sel_vals, inv = np.unique(vals[pm],
                                              return_inverse=True)
                    counts = np.bincount(
                        inv, weights=w[docs[pm]]).astype(np.int64)
                if self.subs:
                    if self.include is not None or \
                            self.exclude is not None:
                        keep = np.asarray(
                            [self._key_included(
                                int(v) if float(v).is_integer() else v)
                             for v in sel_vals], bool)
                        sel_vals, counts = sel_vals[keep], counts[keep]
                    order = np.argsort(-counts, kind="stable")
                    if order.size > self.shard_size:
                        trunc_err = int(counts[order[self.shard_size - 1]])
                        order = order[: self.shard_size]
                    for i in order:
                        v = sel_vals[i]
                        bucket_docs = np.zeros(mask.shape[0], bool)
                        bucket_docs[docs[pm & (vals == v)]] = True
                        buckets[v] = _bucket_payload(self, ctx, seg,
                                                     mask & bucket_docs)
                else:
                    for v, c in zip(sel_vals.tolist(), counts.tolist()):
                        buckets[v] = (c, {})
        if self.missing is not None:
            mask = ctx.host_mask(qmask)
            has = np.zeros(mask.shape[0], bool)
            if kw is not None:
                has[kw[0]] = True
            elif _numeric_pairs(seg, self.field) is not None:
                has[_numeric_pairs(seg, self.field)[0]] = True
            miss_mask = mask & ~has
            if miss_mask.any():
                missing_key = self._coerce_key(ctx.mapper, self.missing)
                buckets[missing_key] = _bucket_payload(
                    self, ctx, seg, miss_mask) if self.subs else \
                    (int(miss_mask.sum()), {})
        return buckets, trunc_err

    def _bucket_key_as_string(self, mapper, key):
        ft = _field_type(mapper, self.field) if mapper else None
        if isinstance(ft, BooleanFieldType) or \
                getattr(self, "value_type", None) == "boolean":
            return "true" if key else "false"
        if isinstance(ft, DateFieldType) or \
                getattr(self, "value_type", None) == "date":
            return format_date_millis(float(key))
        return None

    def _sort_key(self, ctx=None):
        ((field, direction),) = list(self.order.items())[:1] or \
            [("_count", "desc")]
        sign = -1 if direction == "desc" else 1
        return field, sign

    def reduce(self, partials):
        merged: Dict[Any, List] = {}
        err_bound = 0
        for p in partials:
            bkts, trunc_err = p
            err_bound += trunc_err
            for key, (count, subs) in bkts.items():
                merged.setdefault(key, []).append((count, subs))
        rows = []
        for key, items in merged.items():
            count = sum(c for c, _ in items)
            if count < self.min_doc_count:
                continue
            if not self._key_included(key):
                continue
            subs = _reduce_subs(self, [s for _, s in items]) \
                if self.subs else {}
            rows.append((key, count, subs))
        field, sign = self._sort_key()

        def keyfn(row):
            key, count, subs = row
            if field == "_count":
                return (sign * count, key)
            if field == "_key" or field == "_term":
                return (sign * key if isinstance(key, (int, float))
                        else key, ) if sign == 1 else (_Rev(key),)
            # sub-agg metric order, e.g. "price_avg" or "stats.avg"
            path = field.split(".")
            v = subs.get(path[0], {})
            v = v.get(path[1] if len(path) > 1 else "value")
            return (sign * (v if v is not None else float("-inf")), key)

        rows.sort(key=keyfn)
        total_other = sum(c for _, c, _ in rows)
        rows = rows[: self.size]
        total_other -= sum(c for _, c, _ in rows)
        out_buckets = []
        mapper = getattr(self, "_mapper", None)
        for key, count, subs in rows:
            b = {"key": key, "doc_count": count}
            if isinstance(key, float) and key.is_integer():
                b["key"] = int(key)
            kas = self._bucket_key_as_string(mapper, b["key"])
            if kas is not None:
                b["key_as_string"] = kas
            b.update(subs)
            out_buckets.append(b)
        return {"doc_count_error_upper_bound": err_bound,
                "sum_other_doc_count": total_other,
                "buckets": out_buckets}


class _Rev:
    """Inverts comparison for desc string sort keys."""

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return self.v == other.v


class HistogramAgg(BucketAggregator):
    reads_device_mask = True

    def __init__(self, body):
        self.field = body.get("field")
        if self.field is None or "interval" not in body:
            raise ParsingError("histogram requires [field] and [interval]")
        self.interval = float(body["interval"])
        if self.interval <= 0:
            raise ParsingError("[interval] must be > 0")
        self.offset = float(body.get("offset", 0.0))
        self.min_doc_count = int(body.get("min_doc_count", 0))
        self.format = body.get("format")
        bounds = body.get("extended_bounds")
        self.extended_bounds = ((float(bounds["min"]), float(bounds["max"]))
                                if bounds else None)
        hb = body.get("hard_bounds")
        self.hard_bounds = ((float(hb["min"]), float(hb["max"]))
                            if hb else None)

    def _bucket_ids(self, vals):
        return np.floor((vals - self.offset) / self.interval)

    def _range_field_collect(self, ctx, seg, mask):
        """Histogram over a RANGE field: every doc interval contributes
        one count to each bucket it overlaps (RangeHistogramAggregator)."""
        g = seg.numeric_fields.get(f"{self.field}._gte")
        l = seg.numeric_fields.get(f"{self.field}._lte")
        if g is None or l is None:
            return {}
        out: Dict[float, list] = {}
        lo_clip = self.hard_bounds[0] if self.hard_bounds else None
        hi_clip = self.hard_bounds[1] if self.hard_bounds else None
        pm = mask[g.docs_host]
        for lo_v, hi_v, doc in zip(g.vals_host[pm], l.vals_host[pm],
                                   g.docs_host[pm]):
            if lo_clip is not None:
                lo_v = max(lo_v, lo_clip)
            if hi_clip is not None:
                hi_v = min(hi_v, hi_clip)
            if hi_v < lo_v:
                continue
            b0 = int(math.floor((lo_v - self.offset) / self.interval))
            b1 = int(math.floor((hi_v - self.offset) / self.interval))
            if b1 - b0 > 100000:
                raise IllegalArgumentError(
                    f"Trying to create too many buckets. Must be less "
                    f"than or equal to: [{MAX_BUCKETS[0]}]. This limit "
                    f"can be set by changing the [search.max_buckets] "
                    f"cluster level setting.")
            for bid in range(b0, b1 + 1):
                key = bid * self.interval + self.offset
                cur = out.setdefault(float(key), [0, {}])
                cur[0] += 1
        return {k: (c, s_) for k, (c, s_) in out.items()}

    def collect(self, ctx, seg, mask):
        ft = ctx.mapper.field_type(self.field) if ctx.mapper else None
        if isinstance(ft, RangeFieldType):
            return self._range_field_collect(ctx, seg, ctx.host_mask(mask))
        num = _numeric_pairs(seg, self.field, ctx.mapper)
        if num is None:
            return {}
        docs, vals = num
        if self.hard_bounds:
            sel = (vals >= self.hard_bounds[0]) & \
                  (vals <= self.hard_bounds[1])
            docs, vals = docs[sel], vals[sel]
        if (docs.shape[0] >= ops_aggs.DEVICE_MIN_PAIRS and
                not self.subs and not self.hard_bounds):
            # device hot path: cached exact bucket ids + one-hot counts
            ids_dev, pdocs_dev, n_buckets, base = \
                ops_aggs.histogram_bucket_ids(
                    seg, _concrete(ctx.mapper, self.field), self.interval,
                    self.offset, device=seg.device)
            if ids_dev is not None and n_buckets:
                # static kernel shape rounds up through the shape
                # lattice (ESTP-J04): n_buckets is data-dependent (value
                # span / interval), and an unbucketed value compiles a
                # fresh one-hot kernel per distinct histogram width; the
                # padding buckets count nothing and are sliced off
                from ..common.telemetry import record_agg_pairs
                from ..utils.shapes import round_up_pow2
                record_agg_pairs(docs.shape[0])
                nb_pad = round_up_pow2(n_buckets, 8)
                counts = ops_aggs.masked_bucket_counts(
                    ids_dev, pdocs_dev, _device_mask(seg, mask),
                    n_buckets=nb_pad).cpu().numpy()[:n_buckets]
                out = {}
                for bid in np.flatnonzero(counts):
                    key = (base + bid) * self.interval + self.offset
                    out[float(key)] = (int(counts[bid]), {})
                return out
        mask = ctx.host_mask(mask)
        pm = mask[docs]
        ids = self._bucket_ids(vals[pm])
        out = {}
        for bid in np.unique(ids):
            key = bid * self.interval + self.offset
            if self.subs:
                bucket_docs = np.zeros(mask.shape[0], bool)
                bucket_docs[docs[pm][ids == bid]] = True
                out[float(key)] = _bucket_payload(self, ctx, seg,
                                                  mask & bucket_docs)
            else:
                out[float(key)] = (int((ids == bid).sum()), {})
        return out

    def reduce(self, partials):
        merged: Dict[float, List] = {}
        for p in partials:
            for key, item in p.items():
                merged.setdefault(key, []).append(item)
        keys = sorted(merged)
        if self.extended_bounds and (keys or self.min_doc_count == 0):
            lo = math.floor((self.extended_bounds[0] - self.offset)
                            / self.interval) * self.interval + self.offset
            hi = self.extended_bounds[1]
            k = lo
            while k <= hi:
                merged.setdefault(float(k), [])
                k += self.interval
            keys = sorted(merged)
        # densify gaps when min_doc_count == 0
        if self.min_doc_count == 0 and keys:
            k = keys[0]
            while k <= keys[-1] + 1e-9:
                merged.setdefault(float(round(k, 9)), [])
                k += self.interval
            keys = sorted(merged)
        buckets = []
        for key in keys:
            items = merged[key]
            count = sum(c for c, _ in items)
            if count < self.min_doc_count:
                continue
            subs = _reduce_subs(self, [s for _, s in items]) \
                if self.subs else {}
            k_out = int(key) if float(key).is_integer() else key
            b = {"key": k_out, "doc_count": count}
            if self.format:
                from .fetch import decimal_format
                b["key_as_string"] = decimal_format(float(key), self.format)
            b.update(subs)
            buckets.append(b)
        return {"buckets": buckets}


_CALENDAR_INTERVALS = {
    "second": "s", "1s": "s", "minute": "m", "1m": "m", "hour": "h",
    "1h": "h", "day": "d", "1d": "d", "week": "w", "1w": "w",
    "month": "M", "1M": "M", "quarter": "q", "1q": "q", "year": "y",
    "1y": "y",
}

_FIXED_UNITS_MS = {"ms": 1.0, "s": 1000.0, "m": 60_000.0, "h": 3_600_000.0,
                   "d": 86_400_000.0}


def _parse_fixed_interval(s: str) -> float:
    import re as _re
    m = _re.fullmatch(r"(\d+)(ms|s|m|h|d)", s)
    if not m:
        raise ParsingError(f"invalid fixed_interval [{s}]")
    return float(m.group(1)) * _FIXED_UNITS_MS[m.group(2)]


def _calendar_floor(millis: np.ndarray, unit: str) -> np.ndarray:
    """Floor epoch-millis to calendar bucket starts (UTC)."""
    dt = millis.astype("int64").astype("datetime64[ms]")
    if unit == "s":
        out = dt.astype("datetime64[s]")
    elif unit == "m":
        out = dt.astype("datetime64[m]")
    elif unit == "h":
        out = dt.astype("datetime64[h]")
    elif unit == "d":
        out = dt.astype("datetime64[D]")
    elif unit == "w":
        # ISO weeks start Monday; epoch (1970-01-01) was a Thursday
        days = dt.astype("datetime64[D]").astype("int64")
        out = ((days - 4) // 7 * 7 + 4).astype("datetime64[D]")
    elif unit == "M":
        out = dt.astype("datetime64[M]")
    elif unit == "q":
        months = dt.astype("datetime64[M]").astype("int64")
        out = (months // 3 * 3).astype("datetime64[M]")
    elif unit == "y":
        out = dt.astype("datetime64[Y]")
    else:  # pragma: no cover
        raise ParsingError(f"unknown calendar unit [{unit}]")
    return out.astype("datetime64[ms]").astype("int64").astype(np.float64)


def _parse_offset_ms(s) -> float:
    if isinstance(s, (int, float)):
        return float(s)
    s = str(s)
    sign = -1.0 if s.startswith("-") else 1.0
    from ..common.settings import parse_time_millis
    return sign * parse_time_millis(s.lstrip("+-"))


def _tz_offset_ms(tz: str, at_ms: float) -> float:
    """UTC offset (ms) of a zone at an instant; fixed "+HH:MM" or IANA."""
    import datetime
    m = re.match(r"^([+-])(\d{2}):?(\d{2})$", tz)
    if m:
        sign = 1 if m.group(1) == "+" else -1
        return sign * (int(m.group(2)) * 3600 + int(m.group(3)) * 60) * 1000
    import zoneinfo
    z = zoneinfo.ZoneInfo(tz)
    dt = datetime.datetime.fromtimestamp(at_ms / 1000.0, tz=z)
    return dt.utcoffset().total_seconds() * 1000


class DateHistogramAgg(BucketAggregator):
    reads_device_mask = True

    def __init__(self, body):
        self.field = body.get("field")
        if self.field is None:
            raise ParsingError("date_histogram requires [field]")
        cal = body.get("calendar_interval")
        fixed = body.get("fixed_interval") or body.get("interval")
        self.min_doc_count = int(body.get("min_doc_count", 0))
        self.offset_ms = _parse_offset_ms(body.get("offset", 0))
        self.format = body.get("format")
        self.time_zone = body.get("time_zone")
        self.keyed = bool(body.get("keyed", False))
        hb = body.get("hard_bounds")
        self.hard_bounds = ((parse_date_millis(hb["min"]),
                             parse_date_millis(hb["max"]))
                            if hb else None)
        if cal:
            unit = _CALENDAR_INTERVALS.get(cal)
            if unit is None:
                raise ParsingError(f"invalid calendar_interval [{cal}]")
            self.calendar_unit: Optional[str] = unit
            self.fixed_ms = None
        elif fixed:
            self.calendar_unit = None
            self.fixed_ms = _parse_fixed_interval(str(fixed)) \
                if isinstance(fixed, str) else float(fixed)
        else:
            raise ParsingError(
                "date_histogram requires calendar_interval or fixed_interval")

    def _keys_for(self, vals: np.ndarray) -> np.ndarray:
        if not self.time_zone:
            shift = self.offset_ms
            v = vals - shift
            if self.calendar_unit is not None:
                return _calendar_floor(v, self.calendar_unit) + shift
            return np.floor(v / self.fixed_ms) * self.fixed_ms + shift
        # per-value utc offsets (hour-cached — DST transitions move the
        # offset mid-stream); falls back to one offset on huge spans
        hours = vals // 3_600_000.0
        uniq = np.unique(hours)
        if uniq.size > 10000:
            off = np.full(vals.shape,
                          _tz_offset_ms(self.time_zone,
                                        float(vals[0]) if vals.size
                                        else 0.0))
        else:
            of_hour = {h: _tz_offset_ms(self.time_zone, h * 3_600_000.0)
                       for h in uniq.tolist()}
            off = np.asarray([of_hour[h] for h in hours.tolist()])
        shift = self.offset_ms - off
        v = vals - shift
        if self.calendar_unit is not None:
            return _calendar_floor(v, self.calendar_unit) + shift
        return np.floor(v / self.fixed_ms) * self.fixed_ms + shift

    def _next_key(self, key: float) -> float:
        """Start of the bucket after ``key`` (for empty-bucket filling).
        Variable-length calendar units advance by overshooting past the
        next boundary and re-flooring — immune to day-of-month overflow."""
        if self.calendar_unit is None:
            return key + self.fixed_ms
        u = self.calendar_unit
        fixed = {"s": 1000, "m": 60000, "h": 3600000,
                 "d": 86400000, "w": 7 * 86400000}.get(u)
        if fixed is not None:
            return key + fixed
        overshoot = {"M": 32, "q": 93, "y": 367}[u] * 86400000.0
        return float(self._keys_for(np.asarray([key + overshoot]))[0])

    def _key_as_string(self, key: float) -> str:
        from .fetch import java_date_format
        if self.format:
            return java_date_format(key, self.format)
        if self.time_zone:
            off = _tz_offset_ms(self.time_zone, key)
            local = key + off
            base = format_date_millis(local)[:-1]       # strip Z
            sign = "+" if off >= 0 else "-"
            off = abs(int(off)) // 60000
            return f"{base}{sign}{off // 60:02d}:{off % 60:02d}"
        return format_date_millis(key)

    def collect(self, ctx, seg, mask):
        ft = ctx.mapper.field_type(self.field) if ctx.mapper else None
        if isinstance(ft, RangeFieldType):
            g = seg.numeric_fields.get(f"{self.field}._gte")
            l = seg.numeric_fields.get(f"{self.field}._lte")
            if g is None or l is None:
                return {}
            out: Dict[float, tuple] = {}
            pm = ctx.host_mask(mask)[g.docs_host]
            for lo_v, hi_v in zip(g.vals_host[pm], l.vals_host[pm]):
                if self.hard_bounds:
                    lo_v = max(lo_v, self.hard_bounds[0])
                    hi_v = min(hi_v, self.hard_bounds[1])
                if hi_v < lo_v:
                    continue
                k = float(self._keys_for(np.asarray([lo_v]))[0])
                guard = 0
                while k <= hi_v and guard < 100000:
                    c, s_ = out.get(k, (0, {}))
                    out[k] = (c + 1, s_)
                    k = self._next_key(k)
                    guard += 1
            return out
        num = _numeric_pairs(seg, self.field, ctx.mapper)
        if num is None:
            return {}
        docs, vals = num
        if self.hard_bounds:
            sel = (vals >= self.hard_bounds[0]) & \
                  (vals <= self.hard_bounds[1])
            docs, vals = docs[sel], vals[sel]
        if (self.fixed_ms is not None and not self.time_zone and
                not self.subs and not self.hard_bounds and
                docs.shape[0] >= ops_aggs.DEVICE_MIN_PAIRS and
                _doc_weights(seg) is None):
            # fixed-interval, no-tz date_histogram IS a histogram over
            # epoch-millis: reuse the cached bucket-id plane. The key
            # reconstruction (base + bid) * fixed_ms + offset_ms runs
            # the same f64 floor/multiply as _keys_for, so bucket keys
            # are bitwise-identical to the host path
            ids_dev, pdocs_dev, n_buckets, base = \
                ops_aggs.histogram_bucket_ids(
                    seg, _concrete(ctx.mapper, self.field), self.fixed_ms,
                    self.offset_ms, device=seg.device)
            if ids_dev is not None and n_buckets:
                from ..common.telemetry import record_agg_pairs
                from ..utils.shapes import round_up_pow2
                record_agg_pairs(docs.shape[0])
                nb_pad = round_up_pow2(n_buckets, 8)
                counts = ops_aggs.masked_bucket_counts(
                    ids_dev, pdocs_dev, _device_mask(seg, mask),
                    n_buckets=nb_pad).cpu().numpy()[:n_buckets]
                out = {}
                for bid in np.flatnonzero(counts):
                    key = (base + bid) * self.fixed_ms + self.offset_ms
                    out[float(key)] = (int(counts[bid]), {})
                return out
        mask = ctx.host_mask(mask)
        pm = mask[docs]
        keys = self._keys_for(vals[pm])
        w = _doc_weights(seg)
        out = {}
        for key in np.unique(keys):
            if self.subs:
                bucket_docs = np.zeros(mask.shape[0], bool)
                bucket_docs[docs[pm][keys == key]] = True
                out[float(key)] = _bucket_payload(self, ctx, seg,
                                                  mask & bucket_docs)
            elif w is None:
                out[float(key)] = (int((keys == key).sum()), {})
            else:
                out[float(key)] = (
                    int(w[docs[pm][keys == key]].sum()), {})
        return out

    def reduce(self, partials):
        merged: Dict[float, List] = {}
        for p in partials:
            for key, item in p.items():
                merged.setdefault(key, []).append(item)
        keys = sorted(merged)
        if keys and self.min_doc_count == 0:
            # fill the gaps: contiguous buckets from min to max key
            filled = []
            k = keys[0]
            while k <= keys[-1] + 0.5:
                filled.append(k)
                nk = self._next_key(k)
                if nk <= k:            # safety against zero progress
                    break
                k = nk
            keys = [k for k in filled if k <= keys[-1] + 0.5]
        buckets = []
        for key in keys:
            items = merged.get(key, [])
            count = sum(c for c, _ in items)
            if count < self.min_doc_count:
                continue
            subs = _reduce_subs(self, [s for _, s in items]) \
                if self.subs else {}
            b = {"key": int(key) if float(key).is_integer() else key,
                 "key_as_string": self._key_as_string(key),
                 "doc_count": count}
            b.update(subs)
            buckets.append(b)
        if self.keyed:
            return {"buckets": {b["key_as_string"]:
                                {k: v for k, v in b.items()}
                                for b in buckets}}
        return {"buckets": buckets}


def _dt_from_ms_agg(ms: float):
    import datetime
    return datetime.datetime.fromtimestamp(ms / 1000.0,
                                           tz=datetime.timezone.utc)


class RangeAgg(BucketAggregator):
    def __init__(self, body):
        self.field = body.get("field")
        self.ranges = body.get("ranges")
        if self.field is None or not self.ranges:
            raise ParsingError("range requires [field] and [ranges]")
        self.keyed = bool(body.get("keyed", False))
        self.missing = body.get("missing")

    def _resolve(self, ctx):
        """collect-time hook: date_range snapshots the field's format
        here (bound parsing and key rendering are format-dependent)."""

    # bound parsing/formatting hooks: date_range/ip_range override these
    # (aggs_extra.py)
    def _parse_bound(self, v, which: str) -> float:
        return float(v)

    def _format_bound(self, v: float):
        return float(v)

    def _bounds_salt(self):
        """Memoization salt: date_range parses bounds with the field's
        format, which differs per index in a cross-index search."""
        return None

    def _bounds(self, r):
        # bounds resolve ONCE per (request, format) and memoize:
        # date-math 'now' must not re-resolve between collect and reduce
        cache = getattr(self, "_bounds_cache", None)
        if cache is None:
            cache = self._bounds_cache = {}
        k = (id(r), self._bounds_salt())
        if k not in cache:
            frm = r.get("from")
            to = r.get("to")
            cache[k] = (
                self._parse_bound(frm, "from") if frm is not None else None,
                self._parse_bound(to, "to") if to is not None else None)
        return cache[k]

    def _range_key(self, r) -> str:
        if "key" in r:
            return r["key"]
        lo, hi = self._bounds(r)
        f = "*" if lo is None else f"{self._format_bound(lo)}"
        t = "*" if hi is None else f"{self._format_bound(hi)}"
        return f"{f}-{t}"

    def collect(self, ctx, seg, mask):
        self._resolve(ctx)
        num = _numeric_pairs(seg, self.field, ctx.mapper)
        miss_val = miss_docs = None
        if self.missing is not None:
            miss_val = self._parse_bound(self.missing, "from")
            has = np.zeros(mask.shape[0], bool)
            if num is not None:
                has[num[0]] = True
            miss_docs = mask & ~has
        out = {}
        for ri, r in enumerate(self.ranges):
            key = ri          # ordinal: display keys may be per-format
            lo, hi = self._bounds(r)
            if num is None and miss_docs is None:
                out[key] = (0, {n: a.collect(ctx, seg,
                                             np.zeros_like(mask))
                                for n, a in self.subs.items()} if self.subs
                            else {})
                continue
            bucket_docs = np.zeros(mask.shape[0], bool)
            if num is not None:
                docs, vals = num
                sel = np.ones(vals.shape[0], bool)
                if lo is not None:
                    sel &= vals >= lo
                if hi is not None:
                    sel &= vals < hi
                pm = mask[docs] & sel
                bucket_docs[docs[pm]] = True
            if miss_docs is not None and \
                    (lo is None or miss_val >= lo) and \
                    (hi is None or miss_val < hi):
                bucket_docs |= miss_docs
            bm = mask & bucket_docs
            if self.subs:
                out[key] = _bucket_payload(self, ctx, seg, bm)
            else:
                out[key] = (int(bm.sum()), {})
        return out

    def reduce(self, partials):
        # the reference sorts ranges by (from, to) before bucketing
        # (AbstractRangeBuilder.processRanges → sortRanges)
        inf = float("inf")

        def _order(r):
            lo, hi = self._bounds(r)
            return (-inf if lo is None else lo, inf if hi is None else hi)

        buckets = []
        order = sorted(range(len(self.ranges)),
                       key=lambda i: _order(self.ranges[i]))
        for ri in order:
            r = self.ranges[ri]
            key = self._range_key(r)
            items = [p[ri] for p in partials if ri in p]
            count = sum(c for c, _ in items)
            subs = _reduce_subs(self, [s for _, s in items]) \
                if self.subs else {}
            b = {"key": key, "doc_count": count}
            lo, hi = self._bounds(r)
            if lo is not None:
                b["from"] = self._format_bound(lo)
            if hi is not None:
                b["to"] = self._format_bound(hi)
            b.update(subs)
            buckets.append(b)
        if self.keyed:
            return {"buckets": {b.pop("key"): b for b in buckets}}
        return {"buckets": buckets}


class FilterAgg(BucketAggregator):
    def __init__(self, body):
        from .query_dsl import parse_query
        self.query = parse_query(body)

    def collect(self, ctx, seg, mask):
        _, qmask = self.query.execute(ctx.shard_ctx, seg)
        fm = mask & qmask.cpu().numpy()
        if self.subs:
            return _bucket_payload(self, ctx, seg, fm)
        return (int(fm.sum()), {})

    def reduce(self, partials):
        count = sum(c for c, _ in partials)
        out = {"doc_count": count}
        if self.subs:
            out.update(_reduce_subs(self, [s for _, s in partials]))
        return out


class FiltersAgg(BucketAggregator):
    def __init__(self, body):
        from .query_dsl import parse_query
        filters = body.get("filters")
        if not filters:
            raise IllegalArgumentError("[filters] cannot be empty")
        if isinstance(filters, dict):
            self.keyed = True
            self.filters = {k: parse_query(v) for k, v in filters.items()}
        else:
            self.keyed = False
            self.filters = {str(i): parse_query(v)
                            for i, v in enumerate(filters)}

    def collect(self, ctx, seg, mask):
        out = {}
        for key, q in self.filters.items():
            _, qmask = q.execute(ctx.shard_ctx, seg)
            fm = mask & qmask.cpu().numpy()
            if self.subs:
                out[key] = _bucket_payload(self, ctx, seg, fm)
            else:
                out[key] = (int(fm.sum()), {})
        return out

    def reduce(self, partials):
        buckets = {}
        for key in self.filters:
            items = [p[key] for p in partials]
            count = sum(c for c, _ in items)
            b = {"doc_count": count}
            if self.subs:
                b.update(_reduce_subs(self, [s for _, s in items]))
            buckets[key] = b
        if self.keyed:
            return {"buckets": buckets}
        return {"buckets": [buckets[str(i)] for i in range(len(buckets))]}


class MissingAgg(BucketAggregator):
    def __init__(self, body):
        self.field = body.get("field")
        if self.field is None:
            raise ParsingError("missing requires [field]")
        self.missing = body.get("missing")

    def collect(self, ctx, seg, mask):
        if self.missing is not None:
            # a missing-value substitute means no doc is ever "missing"
            mm0 = np.zeros(mask.shape[0], bool)
            if self.subs:
                return _bucket_payload(self, ctx, seg, mm0)
            return (0, {})
        has = np.zeros(mask.shape[0], bool)
        kw = _keyword_pairs(seg, self.field, ctx.mapper)
        if kw is not None:
            has[kw[0]] = True
        num = _numeric_pairs(seg, self.field, ctx.mapper)
        if num is not None:
            has[num[0]] = True
        tf = seg.text_fields.get(self.field)
        if tf is not None:
            has[: seg.n_docs] |= tf.doc_len_host > 0
        mm = mask & ~has
        if self.subs:
            return _bucket_payload(self, ctx, seg, mm)
        return (int(mm.sum()), {})

    def reduce(self, partials):
        count = sum(c for c, _ in partials)
        out = {"doc_count": count}
        if self.subs:
            out.update(_reduce_subs(self, [s for _, s in partials]))
        return out


class GlobalAgg(BucketAggregator):
    """Ignores the query: buckets over every live doc (reference:
    ``bucket/global/``)."""

    def __init__(self, body):
        pass

    def collect(self, ctx, seg, mask):
        gm = np.zeros(mask.shape[0], bool)
        gm[: seg.n_docs] = seg.live
        if seg.has_nested:
            gm[: seg.n_docs] &= seg.parent_mask    # children stay hidden
        if self.subs:
            return _bucket_payload(self, ctx, seg, gm)
        return (int(gm.sum()), {})

    def reduce(self, partials):
        count = sum(c for c, _ in partials)
        out = {"doc_count": count}
        if self.subs:
            out.update(_reduce_subs(self, [s for _, s in partials]))
        return out


# ---------------------------------------------------------------------------
# pipeline aggregations
# ---------------------------------------------------------------------------


def _resolve_buckets_path(sibling_results: dict, path: str):
    """Extract per-bucket metric series, e.g. "sales>stats.avg" or
    "sales._count" (reference: ``pipeline/BucketHelpers.java``)."""
    parts = path.replace(">", ".").split(".")
    agg_name = parts[0]
    sib = sibling_results.get(agg_name)
    if sib is None or "buckets" not in sib:
        raise IllegalArgumentError(
            f"buckets_path [{path}] must reference a multi-bucket sibling")
    buckets = sib["buckets"]
    if isinstance(buckets, dict):       # keyed response form
        buckets = list(buckets.values())
    series = []
    for b in buckets:
        v: Any = b
        if len(parts) == 1 or parts[1] == "_count":
            v = b["doc_count"]
        elif b.get("doc_count") == 0:
            # GapPolicy.SKIP: an empty bucket's metric is treated as
            # missing, not 0 (``BucketHelpers.resolveBucketValue``)
            v = None
        else:
            sp = parts[1:]
            for i, p in enumerate(sp):
                if isinstance(v, dict) and isinstance(v.get(p), dict) \
                        and "buckets" in v[p] and i + 1 < len(sp):
                    # traversing INTO a multi-bucket agg yields one value
                    # per inner bucket — an array, never a number
                    raise IllegalArgumentError(
                        "buckets_path must reference either a number "
                        "value or a single value numeric metric "
                        "aggregation, got: [Object[]] at aggregation "
                        f"[{p}]")
                if isinstance(v, dict):
                    v = v.get(p)
            if isinstance(v, dict) and "buckets" in v:
                raise IllegalArgumentError(
                    "buckets_path must reference either a number value "
                    "or a single value numeric metric aggregation, got: "
                    f"[{_internal_agg_class(v)}] at aggregation "
                    f"[{sp[-1]}]")
            if isinstance(v, dict) and "value" not in v and \
                    any(k in v for k in ("values", "min", "std_deviation")):
                raise IllegalArgumentError(
                    "buckets_path must reference either a number value "
                    "or a single value numeric metric aggregation, but "
                    f"[{sp[-1]}] contains multiple values. Please "
                    "specify which to use.")
            if isinstance(v, dict):
                v = v.get("value")
        series.append(v)
    return buckets, series


def _internal_agg_class(node: dict) -> str:
    """Best-effort reference class name for a multi-bucket result node,
    keyed off the bucket key type (LongTerms/DoubleTerms/StringTerms —
    ``BucketHelpers.formatResolutionError`` surfaces the class)."""
    blist = node.get("buckets")
    blist = list(blist.values()) if isinstance(blist, dict) else blist
    keys = [b.get("key") for b in (blist or []) if isinstance(b, dict)]
    if any(isinstance(k, str) for k in keys):
        return "StringTerms"
    if any(isinstance(k, float) and not float(k).is_integer()
           for k in keys):
        return "DoubleTerms"
    return "LongTerms"


class _SiblingPipelineAgg(PipelineAggregator):
    def __init__(self, body):
        self.buckets_path = body.get("buckets_path")
        if not self.buckets_path:
            raise ParsingError("pipeline aggregation requires [buckets_path]")

    def _values(self, sibling_results):
        _, series = _resolve_buckets_path(sibling_results, self.buckets_path)
        return [v for v in series if v is not None]


class AvgBucketAgg(_SiblingPipelineAgg):
    def apply(self, sibling_results):
        v = self._values(sibling_results)
        return {"value": (sum(v) / len(v)) if v else None}


class SumBucketAgg(_SiblingPipelineAgg):
    def apply(self, sibling_results):
        v = self._values(sibling_results)
        return {"value": sum(v) if v else 0.0}


class MinBucketAgg(_SiblingPipelineAgg):
    def apply(self, sibling_results):
        v = self._values(sibling_results)
        return {"value": min(v) if v else None}


class MaxBucketAgg(_SiblingPipelineAgg):
    def apply(self, sibling_results):
        v = self._values(sibling_results)
        return {"value": max(v) if v else None}


class StatsBucketAgg(_SiblingPipelineAgg):
    def apply(self, sibling_results):
        v = self._values(sibling_results)
        if not v:
            return {"count": 0, "min": None, "max": None, "avg": None,
                    "sum": 0.0}
        return {"count": len(v), "min": min(v), "max": max(v),
                "avg": sum(v) / len(v), "sum": sum(v)}


class CumulativeSumAgg(_SiblingPipelineAgg):
    parent_pipeline = True

    def apply(self, sibling_results):
        buckets, series = _resolve_buckets_path(
            sibling_results, self.buckets_path)
        total = 0.0
        for b, v in zip(buckets, series):
            total += v or 0.0
            b.setdefault("cumulative_sum", {"value": total})
            b["cumulative_sum"] = {"value": total}
        return {"_applied_to": self.buckets_path.split(">")[0].split(".")[0]}

    def apply_parent(self, name, parent_node):
        blist = parent_node.get("buckets")
        blist = list(blist.values()) if isinstance(blist, dict) else blist
        total = 0.0
        for b, v in zip(blist, _bucket_series(blist, self.buckets_path)):
            total += v or 0.0
            b[name] = {"value": total}


class DerivativeAgg(_SiblingPipelineAgg):
    parent_pipeline = True

    def apply(self, sibling_results):
        buckets, series = _resolve_buckets_path(
            sibling_results, self.buckets_path)
        prev = None
        for b, v in zip(buckets, series):
            if prev is not None and v is not None:
                b["derivative"] = {"value": v - prev}
            prev = v if v is not None else prev
        return {"_applied_to": self.buckets_path.split(">")[0].split(".")[0]}

    def apply_parent(self, name, parent_node):
        blist = parent_node.get("buckets")
        blist = list(blist.values()) if isinstance(blist, dict) else blist
        series = _bucket_series(blist, self.buckets_path)
        prev = None
        for b, v in zip(blist, series):
            if prev is not None and v is not None:
                b[name] = {"value": v - prev}
            prev = v if v is not None else prev


class MovingFnAgg(PipelineAggregator):
    """moving_fn (reference: ``pipeline/MovFnPipelineAggregator``): a
    sliding window over the parent's bucket metric series, evaluated by
    a MovingFunctions.<fn>(values) script subset."""

    parent_pipeline = True

    _FNS = {
        "max": lambda v: max(v) if v else None,
        "min": lambda v: min(v) if v else None,
        "sum": lambda v: sum(v) if v else 0.0,
        "unweightedAvg": lambda v: (sum(v) / len(v)) if v else None,
        "stdDev": None,      # handled specially (needs avg argument)
        "linearWeightedAvg": lambda v: (
            sum((i + 1) * x for i, x in enumerate(v)) /
            sum(range(1, len(v) + 1))) if v else None,
    }

    def __init__(self, body):
        self.buckets_path = body.get("buckets_path")
        self.window = body.get("window")
        self.shift = int(body.get("shift", 0))
        script = body.get("script")
        if isinstance(script, dict):
            script = script.get("source")
        self.script = script or ""
        if self.buckets_path is None or self.window is None:
            raise ParsingError("moving_fn requires [buckets_path] and "
                               "[window]")
        if int(self.window) <= 0:
            raise IllegalArgumentError(
                "[window] must be a positive, non-zero integer.")
        self.window = int(self.window)
        m = re.search(r"MovingFunctions\.(\w+)\s*\(", self.script)
        self.fn = m.group(1) if m else None

    def apply_parent(self, name, parent_node):
        blist = parent_node.get("buckets")
        blist = list(blist.values()) if isinstance(blist, dict) else blist
        series = _bucket_series(blist, self.buckets_path)
        for i, b in enumerate(blist):
            # window covers [i - window + shift, i + shift)
            lo = max(0, i - self.window + self.shift)
            hi = max(0, i + self.shift)
            vals = [v for v in series[lo:hi] if v is not None]
            if self.fn == "stdDev":
                if vals:
                    avg = sum(vals) / len(vals)
                    out = (sum((x - avg) ** 2 for x in vals)
                           / len(vals)) ** 0.5
                else:
                    out = None
            else:
                fn = self._FNS.get(self.fn)
                out = fn(vals) if fn else None
            if out is not None:
                b[name] = {"value": out}

    def apply(self, sibling_results):
        raise IllegalArgumentError(
            "moving_fn must be used inside a histogram parent")


class SerialDiffAgg(PipelineAggregator):
    parent_pipeline = True

    def __init__(self, body):
        self.buckets_path = body.get("buckets_path")
        if self.buckets_path is None:
            raise ParsingError("serial_diff requires [buckets_path]")
        self.lag = int(body.get("lag", 1))
        if self.lag <= 0:
            raise IllegalArgumentError(
                "lag must be a positive, non-zero integer")

    def apply_parent(self, name, parent_node):
        blist = parent_node.get("buckets")
        blist = list(blist.values()) if isinstance(blist, dict) else blist
        series = _bucket_series(blist, self.buckets_path)
        for i, b in enumerate(blist):
            if i >= self.lag and series[i] is not None and \
                    series[i - self.lag] is not None:
                b[name] = {"value": series[i] - series[i - self.lag]}


class BucketSelectorAgg(PipelineAggregator):
    parent_pipeline = True

    def __init__(self, body):
        self.buckets_paths = body.get("buckets_path")
        script = body.get("script")
        if isinstance(script, dict):
            script = script.get("source")
        self.script = script
        if not isinstance(self.buckets_paths, dict) or not self.script:
            raise ParsingError(
                "bucket_selector requires [buckets_path] map and [script]")

    def apply_parent(self, name, parent_node):
        from ..utils.expressions import evaluate_expression
        blist = parent_node.get("buckets")
        keyed = isinstance(blist, dict)
        items = list(blist.items()) if keyed else list(enumerate(blist))
        series = {var: _bucket_series(
            [b for _, b in items], path)
            for var, path in self.buckets_paths.items()}
        kept = []
        for i, (k, b) in enumerate(items):
            params = {v: series[v][i] for v in series}
            if any(p is None for p in params.values()):
                continue
            if evaluate_expression(self.script, params):
                kept.append((k, b))
        if keyed:
            parent_node["buckets"] = {k: b for k, b in kept}
        else:
            parent_node["buckets"] = [b for _, b in kept]

    def apply(self, sibling_results):
        raise IllegalArgumentError(
            "bucket_selector must be used inside a multi-bucket parent")


class BucketSortAgg(PipelineAggregator):
    parent_pipeline = True

    def __init__(self, body):
        self.sort = body.get("sort") or []
        self.from_ = int(body.get("from", 0))
        self.size = body.get("size")
        self.gap_policy = body.get("gap_policy", "skip")

    def apply_parent(self, name, parent_node):
        blist = parent_node.get("buckets")
        if isinstance(blist, dict):
            return                          # keyed responses keep order
        out = list(blist)
        for clause in reversed(self.sort if isinstance(self.sort, list)
                               else [self.sort]):
            if isinstance(clause, str):
                path, order = clause, "asc"
            else:
                (path, spec), = clause.items()
                order = spec.get("order", "asc") \
                    if isinstance(spec, dict) else spec
            series = dict(zip(map(id, out), _bucket_series(out, path)))
            present = [b for b in out if series[id(b)] is not None]
            absent = [b for b in out if series[id(b)] is None]
            present.sort(key=lambda b: series[id(b)],
                         reverse=(order == "desc"))
            out = present + absent         # gap buckets always last
        end = None if self.size is None else self.from_ + int(self.size)
        parent_node["buckets"] = out[self.from_: end]

    def apply(self, sibling_results):
        raise IllegalArgumentError(
            f"bucket_sort aggregation [{self.name}] must be declared "
            f"inside of another aggregation")


class BucketScriptAgg(PipelineAggregator):
    """Arithmetic over sibling bucket metrics using a safe expression
    evaluator (the reference runs Painless — ``pipeline/BucketScript``;
    here a restricted arithmetic grammar, see utils/expressions)."""

    def __init__(self, body):
        self.buckets_paths = body.get("buckets_path")
        self.script = body.get("script")
        if not isinstance(self.buckets_paths, dict) or not self.script:
            raise ParsingError(
                "bucket_script requires [buckets_path] map and [script]")
        if isinstance(self.script, dict):
            self.script = self.script.get("source")

    def apply(self, sibling_results):
        from ..utils.expressions import evaluate_expression
        series = {}
        buckets_ref = None
        for var, path in self.buckets_paths.items():
            buckets, vals = _resolve_buckets_path(sibling_results, path)
            series[var] = vals
            buckets_ref = buckets
        if buckets_ref is None:
            return {}
        for i, b in enumerate(buckets_ref):
            params = {v: series[v][i] for v in series}
            if any(p is None for p in params.values()):
                continue
            b[self.name] = {"value": evaluate_expression(self.script, params)}
        return {"_applied_to": next(iter(self.buckets_paths.values()))
                .split(">")[0].split(".")[0]}

    parent_pipeline = True

    def apply_parent(self, name, parent_node):
        from ..utils.expressions import evaluate_expression
        blist = parent_node.get("buckets")
        blist = list(blist.values()) if isinstance(blist, dict) else blist
        series = {var: _bucket_series(blist, path)
                  for var, path in self.buckets_paths.items()}
        for i, b in enumerate(blist):
            params = {v: series[v][i] for v in series}
            if any(p is None for p in params.values()):
                continue
            b[name] = {"value": evaluate_expression(self.script, params)}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class ScriptedMetricAgg(Aggregator):
    """scripted_metric. The reference runs its init/map/combine/reduce
    scripts through the sandboxed Painless-lite engine
    (``script/service.py``, ``script/painless_lite.py``), which this
    package does not have yet (ROADMAP A8): the aggregation is refused
    when it is parsed, naming what is missing, never skipped."""

    def __init__(self, body):
        src = body.get("map_script")
        if isinstance(src, dict):
            src = src.get("source")
        if not src:
            raise IllegalArgumentError(
                "[map_script] must be provided for metric aggregations.")
        raise ParsingError(
            "the [scripted_metric] aggregation is not ported to the "
            "PyTorch package yet (ROADMAP A8; reference "
            "search/aggregations.py:2423, script/service.py)")


_AGG_PARSERS = {
    "scripted_metric": ScriptedMetricAgg,
    "avg": AvgAgg,
    "sum": SumAgg,
    "min": MinAgg,
    "max": MaxAgg,
    "value_count": ValueCountAgg,
    "stats": StatsAgg,
    "extended_stats": ExtendedStatsAgg,
    "cardinality": CardinalityAgg,
    "percentiles": PercentilesAgg,
    "percentile_ranks": PercentileRanksAgg,
    "weighted_avg": WeightedAvgAgg,
    "median_absolute_deviation": MedianAbsoluteDeviationAgg,
    "top_hits": TopHitsAgg,
    "terms": TermsAgg,
    "histogram": HistogramAgg,
    "date_histogram": DateHistogramAgg,
    "range": RangeAgg,
    "filter": FilterAgg,
    "filters": FiltersAgg,
    "missing": MissingAgg,
    "global": GlobalAgg,
    "avg_bucket": AvgBucketAgg,
    "sum_bucket": SumBucketAgg,
    "min_bucket": MinBucketAgg,
    "max_bucket": MaxBucketAgg,
    "stats_bucket": StatsBucketAgg,
    "cumulative_sum": CumulativeSumAgg,
    "derivative": DerivativeAgg,
    "bucket_script": BucketScriptAgg,
    "bucket_selector": BucketSelectorAgg,
    "bucket_sort": BucketSortAgg,
    "moving_fn": MovingFnAgg,
    "serial_diff": SerialDiffAgg,
}

# composite / significant_terms / rare_terms / sampler / nested /
# reverse_nested live in aggs_extra.py; it registers itself into
# _AGG_PARSERS at its own module bottom, which keeps BOTH import orders
# safe (importing aggs_extra first re-enters here only to bind names)
from . import aggs_extra as _aggs_extra      # noqa: E402, F401
from . import aggs_geo as _aggs_geo          # noqa: E402, F401
from . import aggs_analytics as _aggs_analytics   # noqa: E402, F401
