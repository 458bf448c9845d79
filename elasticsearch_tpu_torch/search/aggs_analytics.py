"""Analytics-plugin aggregations: boxplot, top_metrics, string_stats,
t_test, rate, multi_terms.

Reference: ``x-pack/plugin/analytics/src/main/java/.../analytics/`` —
``boxplot/BoxplotAggregator.java`` (TDigest-backed quartiles),
``topmetrics/TopMetricsAggregator.java`` (per-shard top-by-sort metric
rows), ``stringstats/StringStatsAggregator.java`` (length stats + Shannon
entropy over UTF-8 term bytes), ``ttest/TTestAggregator.java``
(paired / homoscedastic / heteroscedastic with two-tailed p-value),
``rate/RateAggregator.java`` (per-calendar-unit normalization inside a
date_histogram), ``multiterms/MultiTermsAggregator.java`` (terms over
composite tuple keys).

TPU-first shape: every collection is a vectorized columnar pass (numpy on
the host mirror of the doc-values columns — the same columns the device
agg kernels consume); partials are tiny data-only dicts that merge exactly
at the coordinator, so cluster reduces reuse the single-node path.
Exactness over sketches: quartiles/percentile math here is exact rather
than TDigest-approximate (documented divergence; conformance tolerances
accept exact answers).

Port of ``elasticsearch_tpu/search/aggs_analytics.py``: host numpy over
the host copy of the query's mask; a ``t_test`` filter's mask comes back
from the device.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..common.errors import IllegalArgumentError, ParsingError
from .aggregations import (Aggregator, BucketAggregator, _NumericMetricAgg,
                           _bucket_payload, _doc_weights, _format_key,
                           _keyword_pairs, _numeric_pairs, _reduce_subs,
                           _Rev)


# ---------------------------------------------------------------------------
# boxplot
# ---------------------------------------------------------------------------

class BoxplotAgg(_NumericMetricAgg):
    """Quartiles + 1.5·IQR whiskers (``BoxplotAggregator.java``). Exact
    values collection; linear interpolation between closest ranks matches
    the reference's TDigest behavior at conformance scale."""

    def __init__(self, body):
        super().__init__(body)
        # compression is accepted for API parity; the exact path ignores it
        self.compression = float(body.get("compression", 100.0))

    def collect(self, ctx, seg, mask):
        v = self._matched_values(ctx, seg, mask)
        return {"values": v.tolist()}

    def reduce(self, partials):
        vals = np.sort(np.concatenate(
            [np.asarray(p["values"], np.float64) for p in partials])
            if partials else np.empty(0))
        if vals.size == 0:
            inf = float("inf")
            return {"min": inf, "max": -inf, "q1": None, "q2": None,
                    "q3": None, "lower": inf, "upper": -inf}
        q1, q2, q3 = (float(np.percentile(vals, p, method="linear"))
                      for p in (25.0, 50.0, 75.0))
        iqr = q3 - q1
        in_fence = vals[(vals >= q1 - 1.5 * iqr) & (vals <= q3 + 1.5 * iqr)]
        return {"min": float(vals[0]), "max": float(vals[-1]),
                "q1": q1, "q2": q2, "q3": q3,
                "lower": float(in_fence[0]), "upper": float(in_fence[-1])}


# ---------------------------------------------------------------------------
# top_metrics
# ---------------------------------------------------------------------------

class TopMetricsAgg(Aggregator):
    """Metric values of the top-sorted docs (``TopMetricsAggregator``)."""

    def __init__(self, body):
        metrics = body.get("metrics")
        if metrics is None:
            raise ParsingError("[top_metrics] requires [metrics]")
        if isinstance(metrics, dict):
            metrics = [metrics]
        self.metric_fields = [m["field"] for m in metrics]
        sort = body.get("sort")
        if sort is None:
            raise ParsingError("[top_metrics] requires [sort]")
        if isinstance(sort, list):
            sort = sort[0]
        if isinstance(sort, str):
            sort = {sort: {"order": "asc"}}
        (self.sort_field, spec), = sort.items()
        if isinstance(spec, str):
            spec = {"order": spec}
        self.sort_asc = spec.get("order", "asc") == "asc"
        self.size = int(body.get("size", 1))

    def collect(self, ctx, seg, mask):
        self._mapper = ctx.mapper
        pairs = _numeric_pairs(seg, self.sort_field, ctx.mapper)
        if pairs is None:
            return {"rows": []}
        docs, svals = pairs
        pm = mask[docs]
        docs, svals = docs[pm], svals[pm]
        if docs.size == 0:
            return {"rows": []}
        k = min(self.size, docs.size)
        order = np.argsort(svals, kind="stable")
        sel = order[:k] if self.sort_asc else order[::-1][:k]
        rows = []
        metric_cols = {}
        for f in self.metric_fields:
            mp = _numeric_pairs(seg, f, ctx.mapper)
            col: Dict[int, float] = {}
            if mp is not None:
                for d, v in zip(mp[0], mp[1]):
                    col.setdefault(int(d), float(v))
            metric_cols[f] = col
        for i in sel:
            d = int(docs[i])
            rows.append({"sort": [float(svals[i])],
                         "metrics": {f: metric_cols[f].get(d)
                                     for f in self.metric_fields}})
        return {"rows": rows}

    def reduce(self, partials):
        rows = [r for p in partials for r in p["rows"]]
        rows.sort(key=lambda r: r["sort"][0], reverse=not self.sort_asc)
        rows = rows[: self.size]
        mapper = getattr(self, "_mapper", None)
        out_rows = []
        for r in rows:
            key, kas = _format_key(mapper, self.sort_field, r["sort"][0])
            out_rows.append({"sort": [kas if kas is not None else key],
                             "metrics": r["metrics"]})
        return {"top": out_rows}


# ---------------------------------------------------------------------------
# string_stats
# ---------------------------------------------------------------------------

class StringStatsAgg(Aggregator):
    """Length stats + Shannon entropy over term UTF-8 bytes
    (``StringStatsAggregator.java``)."""

    def __init__(self, body):
        self.field = body.get("field")
        if self.field is None:
            raise ParsingError("[string_stats] requires [field]")
        self.show_distribution = bool(body.get("show_distribution", False))

    def collect(self, ctx, seg, mask):
        kw = _keyword_pairs(seg, self.field, ctx.mapper)
        counts: Dict[str, int] = {}
        n = 0
        len_sum = 0
        len_min: Optional[int] = None
        len_max: Optional[int] = None
        if kw is not None:
            docs, ords, terms = kw
            pm = mask[docs]
            for o in ords[pm]:
                t = terms[int(o)]
                n += 1
                bs = t.encode("utf-8")
                len_sum += len(bs)
                ln = len(bs)
                len_min = ln if len_min is None else min(len_min, ln)
                len_max = ln if len_max is None else max(len_max, ln)
                for ch in t:
                    counts[ch] = counts.get(ch, 0) + 1
        return {"count": n, "len_sum": len_sum, "min": len_min,
                "max": len_max, "chars": counts}

    def reduce(self, partials):
        count = sum(p["count"] for p in partials)
        if count == 0:
            out = {"count": 0, "min_length": None, "max_length": None,
                   "avg_length": None, "entropy": 0.0}
            if self.show_distribution:
                out["distribution"] = {}
            return out
        len_sum = sum(p["len_sum"] for p in partials)
        mins = [p["min"] for p in partials if p["min"] is not None]
        maxs = [p["max"] for p in partials if p["max"] is not None]
        chars: Dict[str, int] = {}
        for p in partials:
            for ch, c in p["chars"].items():
                chars[ch] = chars.get(ch, 0) + c
        total_chars = sum(chars.values())
        entropy = 0.0
        dist = {}
        if total_chars:
            for ch, c in chars.items():
                pr = c / total_chars
                entropy -= pr * math.log2(pr)
                dist[ch] = pr
        out = {"count": count, "min_length": min(mins),
               "max_length": max(maxs),
               "avg_length": len_sum / count, "entropy": entropy}
        if self.show_distribution:
            out["distribution"] = dict(
                sorted(dist.items(), key=lambda kv: (-kv[1], kv[0])))
        return out


# ---------------------------------------------------------------------------
# t_test
# ---------------------------------------------------------------------------

def _t_sf(t: float, df: float) -> float:
    """Two-tailed p-value for the t-distribution via the regularized
    incomplete beta function (continued fraction — Numerical Recipes
    betacf form; the reference delegates to commons-math's TDistribution)."""
    if df <= 0 or math.isnan(t):
        return float("nan")
    if t == 0.0:
        return 1.0
    x = df / (df + t * t)
    if x >= 1.0:
        return 1.0
    if x <= 0.0:
        return 0.0
    a, b = df / 2.0, 0.5

    def betacf(a_, b_, x_):
        qab, qap, qam = a_ + b_, a_ + 1.0, a_ - 1.0
        c, d = 1.0, 1.0 - qab * x_ / qap
        if abs(d) < 1e-30:
            d = 1e-30
        d = 1.0 / d
        h = d
        for m in range(1, 200):
            m2 = 2 * m
            aa = m * (b_ - m) * x_ / ((qam + m2) * (a_ + m2))
            d = 1.0 + aa * d
            if abs(d) < 1e-30:
                d = 1e-30
            c = 1.0 + aa / c
            if abs(c) < 1e-30:
                c = 1e-30
            d = 1.0 / d
            h *= d * c
            aa = -(a_ + m) * (qab + m) * x_ / ((a_ + m2) * (qap + m2))
            d = 1.0 + aa * d
            if abs(d) < 1e-30:
                d = 1e-30
            c = 1.0 + aa / c
            if abs(c) < 1e-30:
                c = 1e-30
            d = 1.0 / d
            delta = d * c
            h *= delta
            if abs(delta - 1.0) < 1e-12:
                break
        return h

    lbeta = (math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
             + a * math.log(x) + b * math.log(1.0 - x))
    if x < (a + 1.0) / (a + b + 2.0):
        ib = math.exp(lbeta) * betacf(a, b, x) / a
    else:
        ib = 1.0 - math.exp(lbeta) * betacf(b, a, 1.0 - x) / b
    return min(max(ib, 0.0), 1.0)


class TTestAgg(Aggregator):
    """Student's / Welch's t-test (``ttest/TTestAggregator.java``)."""

    def __init__(self, body):
        a, b = body.get("a"), body.get("b")
        if not a or not b or "field" not in a or "field" not in b:
            raise ParsingError(
                "[t_test] requires [a.field] and [b.field]")
        self.a_field, self.b_field = a["field"], b["field"]
        self.a_filter, self.b_filter = a.get("filter"), b.get("filter")
        self.type = body.get("type", "heteroscedastic")
        if self.type not in ("paired", "homoscedastic", "heteroscedastic"):
            raise ParsingError(f"invalid t_test type [{self.type}]")
        if self.type == "paired" and (self.a_filter or self.b_filter):
            raise IllegalArgumentError(
                "Paired t-test doesn't support filters")

    def _filtered_mask(self, ctx, seg, mask, flt):
        if flt is None:
            return mask
        from .query_dsl import parse_query
        q = parse_query(flt)
        _, qmask = q.execute(ctx.shard_ctx, seg)
        return mask & qmask.cpu().numpy()

    def _moments(self, ctx, seg, mask, field) -> dict:
        pairs = _numeric_pairs(seg, field, ctx.mapper)
        if pairs is None:
            return {"n": 0, "sum": 0.0, "sumsq": 0.0}
        docs, vals = pairs
        pm = mask[docs]
        v = vals[pm]
        return {"n": int(v.size), "sum": float(v.sum()),
                "sumsq": float((v * v).sum())}

    def collect(self, ctx, seg, mask):
        if self.type == "paired":
            pa = _numeric_pairs(seg, self.a_field, ctx.mapper)
            pb = _numeric_pairs(seg, self.b_field, ctx.mapper)
            col_a: Dict[int, float] = {}
            col_b: Dict[int, float] = {}
            if pa is not None:
                for d, v in zip(pa[0], pa[1]):
                    col_a.setdefault(int(d), float(v))
            if pb is not None:
                for d, v in zip(pb[0], pb[1]):
                    col_b.setdefault(int(d), float(v))
            idx = np.flatnonzero(mask[: seg.n_docs])
            diffs = [col_a[d] - col_b[d] for d in idx
                     if d in col_a and d in col_b]
            arr = np.asarray(diffs, np.float64)
            return {"d": {"n": int(arr.size), "sum": float(arr.sum()),
                          "sumsq": float((arr * arr).sum())}}
        am = self._filtered_mask(ctx, seg, mask, self.a_filter)
        bm = self._filtered_mask(ctx, seg, mask, self.b_filter)
        return {"a": self._moments(ctx, seg, am, self.a_field),
                "b": self._moments(ctx, seg, bm, self.b_field)}

    @staticmethod
    def _merge(ms: List[dict]) -> Tuple[int, float, float]:
        n = sum(m["n"] for m in ms)
        s = sum(m["sum"] for m in ms)
        ss = sum(m["sumsq"] for m in ms)
        return n, s, ss

    def reduce(self, partials):
        if self.type == "paired":
            n, s, ss = self._merge([p["d"] for p in partials])
            if n < 2:
                return {"value": None}
            mean = s / n
            var = (ss - n * mean * mean) / (n - 1)
            if var <= 0:
                return {"value": 0.0 if mean else None}
            t = mean / math.sqrt(var / n)
            return {"value": _t_sf(t, n - 1)}
        na, sa, ssa = self._merge([p["a"] for p in partials])
        nb, sb, ssb = self._merge([p["b"] for p in partials])
        if na < 2 or nb < 2:
            return {"value": None}
        ma, mb = sa / na, sb / nb
        va = (ssa - na * ma * ma) / (na - 1)
        vb = (ssb - nb * mb * mb) / (nb - 1)
        if self.type == "homoscedastic":
            sp2 = ((na - 1) * va + (nb - 1) * vb) / (na + nb - 2)
            if sp2 <= 0:
                return {"value": None}
            t = (ma - mb) / math.sqrt(sp2 * (1.0 / na + 1.0 / nb))
            return {"value": _t_sf(t, na + nb - 2)}
        sea, seb = va / na, vb / nb
        se = sea + seb
        if se <= 0:
            return {"value": None}
        t = (ma - mb) / math.sqrt(se)
        df = se * se / (sea * sea / (na - 1) + seb * seb / (nb - 1))
        return {"value": _t_sf(t, df)}


# ---------------------------------------------------------------------------
# rate
# ---------------------------------------------------------------------------

#: calendar unit → fixed millis (Rounding unit lengths the reference's
#: RateAggregator uses for interval ratios)
_UNIT_MS = {"second": 1e3, "minute": 6e4, "hour": 3.6e6, "day": 8.64e7,
            "week": 6.048e8, "month": 2.592e9, "quarter": 7.776e9,
            "year": 3.1536e10}


class RateAgg(_NumericMetricAgg):
    """Per-unit rate inside a date_histogram (``RateAggregator.java``).
    parse_aggs stamps ``_parent_interval_ms`` from the enclosing
    date_histogram (the reference resolves the same way via the parent's
    Rounding)."""

    _needs_parent_interval = True

    def __init__(self, body):
        self.field = body.get("field")          # optional: doc-count rate
        self.missing = body.get("missing")
        unit = body.get("unit", "day")
        if unit not in _UNIT_MS:
            raise ParsingError(f"Unsupported unit [{unit}]")
        self.unit = unit
        self.mode = body.get("mode", "sum")
        if self.mode not in ("sum", "value_count"):
            raise ParsingError(f"Unsupported rate mode [{self.mode}]")
        self._parent_interval_ms: Optional[float] = None

    def collect(self, ctx, seg, mask):
        if self.field is None:
            w = _doc_weights(seg)
            n = (float(mask[: seg.n_docs].sum()) if w is None
                 else float(w[mask[: seg.n_docs]].sum()))
            return {"sum": n}
        v = self._matched_values(ctx, seg, mask)
        return {"sum": float(v.sum()) if self.mode == "sum"
                else float(v.size)}

    def reduce(self, partials):
        if self._parent_interval_ms is None:
            raise IllegalArgumentError(
                "The rate aggregation can only be used inside a "
                "date histogram")
        total = sum(p["sum"] for p in partials)
        factor = self._parent_interval_ms / _UNIT_MS[self.unit]
        return {"value": total / factor if factor else None}


# ---------------------------------------------------------------------------
# multi_terms
# ---------------------------------------------------------------------------

class MultiTermsAgg(BucketAggregator):
    """Terms over tuple keys (``MultiTermsAggregator.java``). Tuple key
    columns materialize per source the same way composite sources do; the
    bucket space is their per-doc cartesian product."""

    def __init__(self, body):
        terms = body.get("terms")
        if not terms or not isinstance(terms, list) or len(terms) < 2:
            raise IllegalArgumentError(
                "The [terms] parameter in the aggregation [multi_terms] "
                "must be present and have at least 2 fields")
        self.fields = []
        self.missings = []
        for t in terms:
            if "field" not in t:
                raise ParsingError(
                    "[multi_terms] each term needs a [field]")
            self.fields.append(t["field"])
            self.missings.append(t.get("missing"))
        self.size = int(body.get("size", 10))
        self.shard_size = int(body.get("shard_size",
                                       self.size * 3 // 2 + 10))
        self.min_doc_count = int(body.get("min_doc_count", 1))
        self.order = body.get("order", {"_count": "desc"})

    def _key_col(self, ctx, seg, field, missing) -> List[List[Any]]:
        col: List[List[Any]] = [[] for _ in range(seg.n_docs)]
        kw = _keyword_pairs(seg, field, ctx.mapper)
        if kw is not None:
            docs, ords, terms = kw
            for d, o in zip(docs, ords):
                col[int(d)].append(terms[int(o)])
        else:
            num = _numeric_pairs(seg, field, ctx.mapper)
            if num is not None:
                for d, v in zip(num[0], num[1]):
                    fv = float(v)
                    col[int(d)].append(int(fv) if fv.is_integer() else fv)
        if missing is not None:
            for c in col:
                if not c:
                    c.append(missing)
        return [list(dict.fromkeys(c)) for c in col]

    def collect(self, ctx, seg, mask):
        import itertools as _it
        self._mapper = ctx.mapper
        cols = [self._key_col(ctx, seg, f, m)
                for f, m in zip(self.fields, self.missings)]
        idx = np.flatnonzero(mask[: seg.n_docs])
        by_key_docs: Dict[tuple, List[int]] = {}
        for d in idx:
            per = [c[d] for c in cols]
            if any(not vs for vs in per):
                continue
            for key in _it.product(*per):
                by_key_docs.setdefault(key, []).append(int(d))
        w = _doc_weights(seg)
        counts = {key: (len(ds) if w is None else int(w[ds].sum()))
                  for key, ds in by_key_docs.items()}
        trunc_err = 0
        if self.subs and len(by_key_docs) > self.shard_size:
            # each kept key costs a full bucket collection: cap at
            # shard_size by segment-local count; the dropped tail bounds
            # the doc-count error (InternalTerms docCountError accounting)
            ranked = sorted(by_key_docs, key=lambda k: (-counts[k],))
            kept = set(ranked[: self.shard_size])
            trunc_err = counts[ranked[self.shard_size]] \
                if len(ranked) > self.shard_size else 0
            by_key_docs = {k: v for k, v in by_key_docs.items()
                           if k in kept}
        buckets: Dict[tuple, Tuple[int, dict]] = {}
        for key, ds in by_key_docs.items():
            if self.subs:
                bm = np.zeros(mask.shape[0], bool)
                bm[ds] = True
                buckets[key] = _bucket_payload(self, ctx, seg, bm)
            else:
                buckets[key] = (counts[key], {})
        return buckets, trunc_err

    def _sort_key(self):
        order = self.order
        if isinstance(order, list):
            order = order[0]
        (field, direction), = order.items()
        return field, (1 if direction == "asc" else -1)

    def reduce(self, partials):
        merged: Dict[tuple, List] = {}
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
            subs = _reduce_subs(self, [s for _, s in items]) \
                if self.subs else {}
            rows.append((key, count, subs))
        field, sign = self._sort_key()

        def keyfn(row):
            key, count, subs = row
            if field == "_count":
                return (sign * count,) + tuple(
                    k if isinstance(k, str) else str(k) for k in key)
            if field == "_key":
                return tuple((sign * k if isinstance(k, (int, float))
                              else (k if sign == 1 else _Rev(k)))
                             for k in key)
            path = field.split(".")
            v = subs.get(path[0], {})
            v = v.get(path[1] if len(path) > 1 else "value")
            return (sign * (v if v is not None else float("-inf")),)

        rows.sort(key=keyfn)
        total_other = sum(c for _, c, _ in rows)
        rows = rows[: self.size]
        total_other -= sum(c for _, c, _ in rows)
        out = []
        for key, count, subs in rows:
            b = {"key": list(key),
                 "key_as_string": "|".join(str(k) for k in key),
                 "doc_count": count}
            b.update(subs)
            out.append(b)
        return {"doc_count_error_upper_bound": err_bound,
                "sum_other_doc_count": total_other, "buckets": out}


# ---------------------------------------------------------------------------
# registration (same late-binding pattern as aggs_extra)
# ---------------------------------------------------------------------------

from .aggregations import _AGG_PARSERS      # noqa: E402

_AGG_PARSERS.update({
    "boxplot": BoxplotAgg,
    "top_metrics": TopMetricsAgg,
    "string_stats": StringStatsAgg,
    "t_test": TTestAgg,
    "rate": RateAgg,
    "multi_terms": MultiTermsAgg,
})
