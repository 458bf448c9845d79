"""Geo aggregations + adaptive histograms + adjacency matrix +
significant_text.

References: ``bucket/geogrid/GeoHashGridAggregator.java`` /
``GeoTileGridAggregator.java``, ``bucket/range/GeoDistanceAggregationBuilder
.java``, ``bucket/histogram/AutoDateHistogramAggregator.java``,
``bucket/histogram/VariableWidthHistogramAggregator.java``,
``bucket/adjacency/AdjacencyMatrixAggregator.java``,
``bucket/terms/SignificantTextAggregator.java``.

Geo points live as paired ``field._lat`` / ``field._lon`` doc-value
columns (lockstep order, see ``mapping.py``). The adaptive histograms
(auto_date / variable_width) must see ALL values before choosing their
buckets, so their ``collect`` stages the per-segment inputs (including
the (ctx, seg, mask) triple for sub-agg collection) and the global
bucketing happens in ``reduce`` — the same single-global-reduce shape the
coordinator already guarantees (``dist_query.py`` reduces once,
cross-shard, in process).

Port of ``elasticsearch_tpu/search/aggs_geo.py``: host numpy over the host
copy of the query's mask; ``adjacency_matrix``'s filter masks come back
from the device."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..common.errors import ParsingError
from ..index.mapping import GeoPointFieldType, format_date_millis
from .aggregations import (Aggregator, BucketAggregator, _bucket_payload,
                           _sub_results,
                           _numeric_pairs, _reduce_subs)
from .aggs_extra import SignificantTermsAgg, _live_parents
from .positional import haversine_meters, parse_distance_meters

# ---------------------------------------------------------------------------
# geo keys
# ---------------------------------------------------------------------------

from ..index.mapping import geohash_encode  # noqa: F401 (re-export)


#: web-mercator latitude bound (GeoTileUtils.LATITUDE_MASK)
_MERCATOR_LAT_MAX = 85.0511287798066


def geotile_key(lat: float, lon: float, zoom: int) -> str:
    """Web-mercator tile ``z/x/y`` (``GeoTileUtils.java``)."""
    tiles = 1 << zoom
    x = int(math.floor((lon + 180.0) / 360.0 * tiles))
    lat_rad = math.radians(
        min(max(lat, -_MERCATOR_LAT_MAX), _MERCATOR_LAT_MAX))
    y = int(math.floor(
        (1.0 - math.log(math.tan(lat_rad) + 1.0 / math.cos(lat_rad))
         / math.pi) / 2.0 * tiles))
    x = min(max(x, 0), tiles - 1)
    y = min(max(y, 0), tiles - 1)
    return f"{zoom}/{x}/{y}"


def _geo_pairs(seg, field: str, mapper=None):
    """(docs int32[M], lat f64[M], lon f64[M]) or None."""
    if mapper is not None:
        ft = mapper.field_type(field)
        if ft is not None and ft.name != field:
            field = ft.name
    la = seg.numeric_fields.get(f"{field}._lat")
    lo = seg.numeric_fields.get(f"{field}._lon")
    if la is None or lo is None or la.vals_host.size == 0:
        return None
    return la.docs_host, la.vals_host, lo.vals_host


# ---------------------------------------------------------------------------
# geo grid aggs
# ---------------------------------------------------------------------------


class _GeoGridAgg(BucketAggregator):
    default_precision = 5
    min_precision = 1
    max_precision = 12

    def __init__(self, body: dict):
        self.field = body.get("field")
        if self.field is None:
            raise ParsingError("geo grid aggregation requires [field]")
        self.precision = int(body.get("precision", self.default_precision))
        if not (self.min_precision <= self.precision
                <= self.max_precision):
            raise ParsingError(
                f"Invalid geo grid precision of {self.precision}. Must be "
                f"between {self.min_precision} and {self.max_precision}.")
        self.size = int(body.get("size", 10000))
        self.shard_size = int(body.get("shard_size", max(self.size, 10000)))

    def _cell(self, lat: float, lon: float) -> str:
        raise NotImplementedError

    def collect(self, ctx, seg, mask):
        geo = _geo_pairs(seg, self.field, ctx.mapper)
        if geo is None:
            return {}
        docs, lat, lon = geo
        pm = mask[docs]
        cell_docs: Dict[str, set] = {}
        for d, la, lo in zip(docs[pm], lat[pm], lon[pm]):
            cell_docs.setdefault(self._cell(la, lo), set()).add(int(d))
        out = {}
        for cell, ds in cell_docs.items():
            if self.subs:
                bm = np.zeros(mask.shape[0], bool)
                bm[list(ds)] = True
                out[cell] = _bucket_payload(self, ctx, seg, bm)
            else:
                out[cell] = (len(ds), {})
        return out

    def reduce(self, partials):
        merged: Dict[str, List] = {}
        for p in partials:
            for cell, item in p.items():
                merged.setdefault(cell, []).append(item)
        rows = []
        for cell, items in merged.items():
            count = sum(c for c, _ in items)
            subs = _reduce_subs(self, [s for _, s in items]) \
                if self.subs else {}
            rows.append((cell, count, subs))
        rows.sort(key=lambda r: (-r[1], r[0]))
        buckets = []
        for cell, count, subs in rows[: self.size]:
            b = {"key": cell, "doc_count": count}
            b.update(subs)
            buckets.append(b)
        return {"buckets": buckets}


class GeoHashGridAgg(_GeoGridAgg):
    default_precision = 5
    max_precision = 12

    def _cell(self, lat, lon):
        return geohash_encode(lat, lon, self.precision)


class GeoTileGridAgg(_GeoGridAgg):
    default_precision = 7
    min_precision = 0
    max_precision = 29

    def _cell(self, lat, lon):
        return geotile_key(lat, lon, self.precision)


# ---------------------------------------------------------------------------
# geo_distance range agg
# ---------------------------------------------------------------------------


class GeoDistanceAgg(BucketAggregator):
    def __init__(self, body: dict):
        self.field = body.get("field")
        self.origin = body.get("origin")
        self.ranges = body.get("ranges")
        if self.field is None or self.origin is None or not self.ranges:
            raise ParsingError(
                "geo_distance requires [field], [origin] and [ranges]")
        self.olat, self.olon = GeoPointFieldType("origin").parse_value(
            self.origin)
        self.unit = body.get("unit", "m")
        self.unit_m = parse_distance_meters(f"1{self.unit}")
        self.keyed = bool(body.get("keyed", False))

    def _range_key(self, r) -> str:
        if "key" in r:
            return r["key"]
        f = "*" if r.get("from") is None else f"{float(r['from'])}"
        t = "*" if r.get("to") is None else f"{float(r['to'])}"
        return f"{f}-{t}"

    def _doc_distances(self, ctx, seg, mask):
        """float64[n_pad] min distance per doc (inf where absent)."""
        geo = _geo_pairs(seg, self.field, ctx.mapper)
        dist = np.full(mask.shape[0], np.inf)
        if geo is None:
            return dist
        docs, lat, lon = geo
        d = haversine_meters(lat, lon, self.olat, self.olon) / self.unit_m
        np.minimum.at(dist, docs, d)
        return dist

    def collect(self, ctx, seg, mask):
        dist = self._doc_distances(ctx, seg, mask)
        out = {}
        for r in self.ranges:
            key = self._range_key(r)
            sel = mask.copy()
            if r.get("from") is not None:
                sel &= dist >= float(r["from"])
            if r.get("to") is not None:
                sel &= dist < float(r["to"])
            sel &= np.isfinite(dist)
            if self.subs:
                out[key] = _bucket_payload(self, ctx, seg, sel)
            else:
                out[key] = (int(sel.sum()), {})
        return out

    def reduce(self, partials):
        buckets = []
        for r in self.ranges:
            key = self._range_key(r)
            items = [p[key] for p in partials if key in p]
            count = sum(c for c, _ in items)
            subs = _reduce_subs(self, [s for _, s in items]) \
                if self.subs else {}
            b = {"key": key, "doc_count": count}
            if r.get("from") is not None:
                b["from"] = float(r["from"])
            if r.get("to") is not None:
                b["to"] = float(r["to"])
            b.update(subs)
            buckets.append(b)
        if self.keyed:
            return {"buckets": {b.pop("key"): b for b in buckets}}
        return {"buckets": buckets}


# ---------------------------------------------------------------------------
# geo metric aggs
# ---------------------------------------------------------------------------


class GeoBoundsAgg(Aggregator):
    def __init__(self, body: dict):
        self.field = body.get("field")
        if self.field is None:
            raise ParsingError("geo_bounds requires [field]")

    def collect(self, ctx, seg, mask):
        geo = _geo_pairs(seg, self.field, ctx.mapper)
        if geo is None:
            return None
        docs, lat, lon = geo
        pm = mask[docs]
        if not pm.any():
            return None
        return (float(lat[pm].max()), float(lat[pm].min()),
                float(lon[pm].min()), float(lon[pm].max()))

    def reduce(self, partials):
        parts = [p for p in partials if p is not None]
        if not parts:
            return {}
        top = max(p[0] for p in parts)
        bottom = min(p[1] for p in parts)
        left = min(p[2] for p in parts)
        right = max(p[3] for p in parts)
        return {"bounds": {"top_left": {"lat": top, "lon": left},
                           "bottom_right": {"lat": bottom, "lon": right}}}


class GeoCentroidAgg(Aggregator):
    def __init__(self, body: dict):
        self.field = body.get("field")
        if self.field is None:
            raise ParsingError("geo_centroid requires [field]")

    def collect(self, ctx, seg, mask):
        geo = _geo_pairs(seg, self.field, ctx.mapper)
        if geo is None:
            return (0.0, 0.0, 0)
        docs, lat, lon = geo
        pm = mask[docs]
        return (float(lat[pm].sum()), float(lon[pm].sum()), int(pm.sum()))

    def reduce(self, partials):
        slat = sum(p[0] for p in partials)
        slon = sum(p[1] for p in partials)
        n = sum(p[2] for p in partials)
        if n == 0:
            return {"count": 0}
        return {"location": {"lat": slat / n, "lon": slon / n}, "count": n}


# ---------------------------------------------------------------------------
# auto_date_histogram
# ---------------------------------------------------------------------------

_MS_S, _MS_M, _MS_H, _MS_D = 1000, 60_000, 3_600_000, 86_400_000

#: (unit suffix, to-unit-index fn, from-unit-index fn, inner multiples)
#: mirrors AutoDateHistogramAggregationBuilder.buildRoundings
def _dt_from_ms(ms: float):
    import datetime
    return datetime.datetime.fromtimestamp(ms / 1000.0,
                                           tz=datetime.timezone.utc)


def _month_idx(ms: float) -> int:
    dt = _dt_from_ms(ms)
    return dt.year * 12 + (dt.month - 1)


def _month_ms(idx: int) -> float:
    import datetime
    y, m = divmod(idx, 12)
    return datetime.datetime(y, m + 1, 1,
                             tzinfo=datetime.timezone.utc).timestamp() * 1000


def _year_idx(ms: float) -> int:
    return _dt_from_ms(ms).year


def _year_ms(idx: int) -> float:
    import datetime
    return datetime.datetime(idx, 1, 1,
                             tzinfo=datetime.timezone.utc).timestamp() * 1000


_ROUNDINGS = [
    ("s", lambda ms: int(ms // _MS_S), lambda i: i * _MS_S,
     (1, 5, 10, 30)),
    ("m", lambda ms: int(ms // _MS_M), lambda i: i * _MS_M,
     (1, 5, 10, 30)),
    ("h", lambda ms: int(ms // _MS_H), lambda i: i * _MS_H, (1, 3, 12)),
    ("d", lambda ms: int(ms // _MS_D), lambda i: i * _MS_D, (1, 7)),
    ("M", _month_idx, _month_ms, (1, 3)),
    ("y", _year_idx, _year_ms, (1, 5, 10, 20, 50, 100)),
]

#: fixed-width unit sizes in ms for the vectorized index computation
_UNIT_MS = [_MS_S, _MS_M, _MS_H, _MS_D]


def _unit_indices(vals: np.ndarray, ri: int) -> np.ndarray:
    """Vectorized ``_ROUNDINGS[ri]`` index computation: one numpy pass
    for the fixed-width units; months/years fall back to the scalar
    calendar functions (rare at realistic bucket caps)."""
    if ri < len(_UNIT_MS):
        return (vals // _UNIT_MS[ri]).astype(np.int64)
    to_idx = _ROUNDINGS[ri][1]
    return np.array([to_idx(x) for x in vals], np.int64)


class AutoDateHistogramAgg(BucketAggregator):
    """Picks the smallest rounding from the reference's ladder whose bucket
    count (anchored at the FIRST bucket, merged in groups of ``k`` inner
    units) fits the target. Global choice → collection is staged and the
    bucketing happens at reduce (see module docstring)."""

    def __init__(self, body: dict):
        self.field = body.get("field")
        if self.field is None:
            raise ParsingError("auto_date_histogram requires [field]")
        self.buckets = int(body.get("buckets", 10))
        if self.buckets <= 0:
            raise ParsingError("[buckets] must be a positive integer")

    def collect(self, ctx, seg, mask):
        pairs = _numeric_pairs(seg, self.field, ctx.mapper)
        vals = np.empty(0, np.float64)
        if pairs is not None:
            docs, v = pairs
            vals = v[mask[docs]]
        return {"vals": vals, "triple": (ctx, seg, mask)}

    def collect_wire(self, ctx, seg, mask):
        """Data-only partial for cross-node shipping (no live segment
        refs). Bucket counts come from value histograms — exact for
        single-valued date fields. Sub-aggregations are pre-collected at
        the finest k=1 rounding unit whose local bucket count stays
        bounded; the reduce re-bins those unit buckets into the globally
        chosen interval (units nest exactly in UTC: s→m→h→d→M→y)."""
        pairs = _numeric_pairs(seg, self.field, ctx.mapper)
        out = {"vals": np.empty(0, np.float64)}
        if pairs is None:
            return out
        docs, v = pairs
        sel = mask[docs]
        vals = v[sel]
        out["vals"] = vals
        if not self.subs or vals.size == 0:
            return out
        cap = max(self.buckets, 1) * 50
        ri = len(_ROUNDINGS) - 1
        idxs = None
        for r in range(len(_ROUNDINGS)):
            cand = _unit_indices(vals, r)
            if np.unique(cand).size <= cap:
                ri, idxs = r, cand
                break
        if idxs is None:
            idxs = _unit_indices(vals, ri)
        sub_by_idx = {}
        sel_docs = docs[sel]
        for idx in np.unique(idxs):
            bm = np.zeros(mask.shape[0], bool)
            bm[sel_docs[idxs == idx]] = True
            bm &= mask
            sub_by_idx[int(idx)] = _sub_results(self, ctx, seg, bm)
        out["subs_unit"] = ri
        out["b"] = sub_by_idx
        return out

    def reduce(self, partials):
        all_vals = np.concatenate([p["vals"] for p in partials]) \
            if partials else np.empty(0)
        if all_vals.size == 0:
            return {"buckets": [], "interval": "1s"}
        self._debug = {"surviving_buckets": int(
            np.unique(all_vals // 86_400_000).size)}
        vmin, vmax = float(all_vals.min()), float(all_vals.max())
        chosen = None
        for suffix, to_idx, from_idx, inners in _ROUNDINGS:
            lo, hi = to_idx(vmin), to_idx(vmax)
            for k in inners:
                if (hi - lo) // k + 1 <= self.buckets:
                    chosen = (suffix, to_idx, from_idx, k, lo, hi)
                    break
            if chosen:
                break
        if chosen is None:      # fall back to the coarsest rounding
            suffix, to_idx, from_idx, inners = _ROUNDINGS[-1]
            k = inners[-1]
            lo, hi = to_idx(vmin), to_idx(vmax)
            chosen = (suffix, to_idx, from_idx, k, lo, hi)
        suffix, to_idx, from_idx, k, lo, hi = chosen
        nbuckets = (hi - lo) // k + 1
        buckets = []
        for i in range(nbuckets):
            start_idx = lo + i * k
            key_ms = float(from_idx(start_idx))
            end_ms = float(from_idx(start_idx + k))
            count = 0
            sub_partials = []
            for p in partials:
                if "triple" not in p:
                    # wire partial: value-histogram count (exact for
                    # single-valued fields); subs re-bin by unit bucket
                    count += int(((p["vals"] >= key_ms)
                                  & (p["vals"] < end_ms)).sum())
                    if self.subs and p.get("b"):
                        from_local = _ROUNDINGS[p["subs_unit"]][2]
                        for uidx, sub in p["b"].items():
                            ms = float(from_local(uidx))
                            if key_ms <= ms < end_ms:
                                sub_partials.append(sub)
                    continue
                ctx, seg, mask = p["triple"]
                pairs = _numeric_pairs(seg, self.field, ctx.mapper)
                if pairs is None:
                    continue
                docs, v = pairs
                sel = mask[docs] & (v >= key_ms) & (v < end_ms)
                bm = np.zeros(mask.shape[0], bool)
                bm[docs[sel]] = True
                bm &= mask
                count += int(bm.sum())
                if self.subs:
                    sub_partials.append(
                        _bucket_payload(self, ctx, seg, bm)[1])
            b = {"key": key_ms, "key_as_string": format_date_millis(key_ms),
                 "doc_count": count}
            if isinstance(b["key"], float) and b["key"].is_integer():
                b["key"] = int(b["key"])
            if self.subs:
                b.update(_reduce_subs(self, sub_partials))
            buckets.append(b)
        return {"buckets": buckets, "interval": f"{k}{suffix}"}


# ---------------------------------------------------------------------------
# variable_width_histogram
# ---------------------------------------------------------------------------


class VariableWidthHistogramAgg(BucketAggregator):
    """1-D agglomerative clustering: start from distinct values, repeatedly
    merge the closest adjacent clusters until the target count is reached.
    Cluster key = mean of member values."""

    def __init__(self, body: dict):
        self.field = body.get("field")
        if self.field is None:
            raise ParsingError("variable_width_histogram requires [field]")
        self.buckets = int(body.get("buckets", 10))
        if self.buckets <= 0:
            raise ParsingError(
                "[buckets] must be a positive, non-zero integer")

    def collect(self, ctx, seg, mask):
        pairs = _numeric_pairs(seg, self.field, ctx.mapper)
        vals = np.empty(0, np.float64)
        if pairs is not None:
            docs, v = pairs
            vals = v[mask[docs]]
        return {"vals": vals, "triple": (ctx, seg, mask)}

    #: distinct-value bound for per-value sub-partials on the wire
    WIRE_SUB_VALUE_CAP = 2048

    def collect_wire(self, ctx, seg, mask):
        """Data-only partial for cross-node shipping. Sub-aggregations
        pre-collect per DISTINCT VALUE (clusters are decided globally at
        reduce, so the finest shippable granularity is the value itself);
        bounded by WIRE_SUB_VALUE_CAP distinct values."""
        pairs = _numeric_pairs(seg, self.field, ctx.mapper)
        out = {"vals": np.empty(0, np.float64)}
        if pairs is None:
            return out
        docs, v = pairs
        sel = mask[docs]
        vals = v[sel]
        out["vals"] = vals
        if not self.subs or vals.size == 0:
            return out
        uniq = np.unique(vals)
        if uniq.size > self.WIRE_SUB_VALUE_CAP:
            return out                   # counts stay exact; subs degrade
        sel_docs = docs[sel]
        vb = {}
        for uv in uniq:
            bm = np.zeros(mask.shape[0], bool)
            bm[sel_docs[vals == uv]] = True
            bm &= mask
            vb[float(uv)] = _sub_results(self, ctx, seg, bm)
        out["vb"] = vb
        return out

    def reduce(self, partials):
        all_vals = np.sort(np.concatenate([p["vals"] for p in partials])) \
            if partials else np.empty(0)
        if all_vals.size == 0:
            return {"buckets": []}
        uniq, counts = np.unique(all_vals, return_counts=True)
        # merging the smallest adjacent gap until k clusters remain is
        # equivalent to cutting at the k-1 LARGEST gaps (gaps never change
        # as clusters merge) — O(n log n), no iterative merge loop
        k = min(self.buckets, uniq.size)
        gaps = np.diff(uniq)
        cut_after = np.sort(np.argsort(gaps)[::-1][: k - 1]) \
            if k > 1 else np.empty(0, np.int64)
        starts = np.concatenate(([0], cut_after + 1))
        ends = np.concatenate((cut_after, [uniq.size - 1]))
        clusters = list(zip(starts.tolist(), ends.tolist()))
        buckets = []
        for c0, c1 in clusters:
            lo_v, hi_v = float(uniq[c0]), float(uniq[c1])
            n_vals = int(counts[c0:c1 + 1].sum())
            member_sum = float((uniq[c0:c1 + 1] * counts[c0:c1 + 1]).sum())
            key = member_sum / n_vals
            # doc_count is DOC-based (a multi-valued doc counts once per
            # cluster), so recount through per-segment doc masks
            n_docs = 0
            sub_partials = []
            for p in partials:
                if "triple" not in p:
                    n_docs += int(((p["vals"] >= lo_v)
                                   & (p["vals"] <= hi_v)).sum())
                    if self.subs and p.get("vb"):
                        sub_partials.extend(
                            sub for uv, sub in p["vb"].items()
                            if lo_v <= uv <= hi_v)
                    continue
                ctx, seg, mask = p["triple"]
                pairs = _numeric_pairs(seg, self.field, ctx.mapper)
                if pairs is None:
                    continue
                docs, v = pairs
                sel = mask[docs] & (v >= lo_v) & (v <= hi_v)
                bm = np.zeros(mask.shape[0], bool)
                bm[docs[sel]] = True
                bm &= mask
                n_docs += int(bm.sum())
                if self.subs:
                    sub_partials.append(
                        _bucket_payload(self, ctx, seg, bm)[1])
            b = {"min": lo_v, "key": key, "max": hi_v, "doc_count": n_docs}
            if self.subs:
                b.update(_reduce_subs(self, sub_partials))
            buckets.append(b)
        return {"buckets": buckets}


# ---------------------------------------------------------------------------
# adjacency_matrix
# ---------------------------------------------------------------------------


class AdjacencyMatrixAgg(BucketAggregator):
    def __init__(self, body: dict):
        filters = body.get("filters")
        if not isinstance(filters, dict) or not filters:
            raise ParsingError("adjacency_matrix requires [filters]")
        from .query_dsl import parse_query
        self.names = sorted(filters)
        self.queries = {n: parse_query(filters[n]) for n in self.names}
        self.separator = str(body.get("separator", "&"))

    def collect(self, ctx, seg, mask):
        fmasks = {}
        for n, q in self.queries.items():
            _, m = q.execute(ctx.shard_ctx, seg)
            fmasks[n] = mask & m.cpu().numpy()[: mask.shape[0]]
        out = {}
        keys = []
        for i, a in enumerate(self.names):
            keys.append((a, fmasks[a]))
            for b in self.names[i + 1:]:
                keys.append((f"{a}{self.separator}{b}",
                             fmasks[a] & fmasks[b]))
        for key, bm in keys:
            if self.subs:
                out[key] = _bucket_payload(self, ctx, seg, bm)
            else:
                out[key] = (int(bm.sum()), {})
        return out

    def reduce(self, partials):
        merged: Dict[str, List] = {}
        for p in partials:
            for key, item in p.items():
                merged.setdefault(key, []).append(item)
        buckets = []
        for key in sorted(merged):
            items = merged[key]
            count = sum(c for c, _ in items)
            if count == 0:
                continue
            b = {"key": key, "doc_count": count}
            if self.subs:
                b.update(_reduce_subs(self, [s for _, s in items]))
            buckets.append(b)
        return {"buckets": buckets}


# ---------------------------------------------------------------------------
# significant_text
# ---------------------------------------------------------------------------


class SignificantTextAgg(SignificantTermsAgg):
    """significant_terms over a TEXT field's postings: per-term foreground
    doc counts come from the postings CSR restricted to the bucket mask
    (vectorized bincount over posting term-ids). ``filter_duplicate_text``
    reconstructs matched docs' token streams from the position CSR and
    strips 6-gram runs already seen in earlier matched docs — the
    ``DeDuplicatingTokenFilter`` behavior."""

    DUP_SEQ = 6

    def __init__(self, body: dict):
        super().__init__(body)
        self.filter_duplicate_text = bool(
            body.get("filter_duplicate_text", False))

    def _dedup_fg_counts(self, f, fg_docs: np.ndarray) -> Dict[int, int]:
        """term-id → fg doc count, counting only tokens outside duplicated
        6-gram runs. Token streams are rebuilt per doc from positions."""
        terms_sorted = list(f.term_ids)
        seqs: Dict[int, Dict[int, int]] = {int(d): {} for d in fg_docs}
        fg_set = set(seqs)
        for tid in range(len(terms_sorted)):
            s, e = int(f.offsets[tid]), int(f.offsets[tid + 1])
            for p in range(s, e):
                d = int(f.docs_host[p])
                if d in fg_set:
                    for pos in f.pos_flat[
                            f.pos_offsets[p]:f.pos_offsets[p + 1]]:
                        seqs[d][int(pos)] = tid
        seen_grams = set()
        counts: Dict[int, int] = {}
        w = self.DUP_SEQ
        for d in sorted(fg_set):
            positions = sorted(seqs[d])
            seq = [seqs[d][p] for p in positions]
            dup = [False] * len(seq)
            new_grams = []
            for i in range(len(seq) - w + 1):
                gram = tuple(seq[i:i + w])
                if gram in seen_grams:
                    for j in range(i, i + w):
                        dup[j] = True
                else:
                    new_grams.append(gram)
            seen_grams.update(new_grams)
            for tid in {t for t, isdup in zip(seq, dup) if not isdup}:
                counts[tid] = counts.get(tid, 0) + 1
        return counts

    def collect(self, ctx, seg, mask):
        field = self.field
        ft = ctx.mapper.field_type(field) if ctx.mapper else None
        if ft is not None and ft.name != field:
            field = ft.name
        f = seg.text_fields.get(field)
        if f is None:
            tok = self._bg_token(seg)
            if tok not in self._seg_bg:
                self._seg_bg[tok] = (
                    int(_live_parents(
                        seg, mask.shape[0])[: seg.n_docs].sum()), {})
            return {"fg_total": int(mask[: seg.n_docs].sum()),
                    "terms": {}, "seg_bg": self._seg_bg}
        if not self.filter_duplicate_text:
            return self._collect_text(ctx, seg, mask, f)
        v = len(f.term_ids)
        tid = np.repeat(np.arange(v, dtype=np.int64),
                        np.diff(f.offsets).astype(np.int64))
        terms_sorted = list(f.term_ids)
        tok = self._bg_token(seg)
        if tok not in self._seg_bg:
            bg_mask = self._bg_mask(ctx, seg, mask)
            bg = np.bincount(tid[bg_mask[f.docs_host]], minlength=v)
            self._seg_bg[tok] = (
                int(bg_mask[: seg.n_docs].sum()),
                {terms_sorted[i]: int(bg[i]) for i in np.flatnonzero(bg)})
        fg_docs = np.unique(f.docs_host[mask[f.docs_host]])
        fg_of = self._dedup_fg_counts(f, fg_docs)
        t = {terms_sorted[t_id]: c for t_id, c in fg_of.items() if c}
        return {"fg_total": int(mask[: seg.n_docs].sum()), "terms": t,
                "seg_bg": self._seg_bg}


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

from .aggregations import _AGG_PARSERS      # noqa: E402

_AGG_PARSERS.update({
    "geohash_grid": GeoHashGridAgg,
    "geotile_grid": GeoTileGridAgg,
    "geo_distance": GeoDistanceAgg,
    "geo_bounds": GeoBoundsAgg,
    "geo_centroid": GeoCentroidAgg,
    "auto_date_histogram": AutoDateHistogramAgg,
    "variable_width_histogram": VariableWidthHistogramAgg,
    "adjacency_matrix": AdjacencyMatrixAgg,
    "significant_text": SignificantTextAgg,
})
