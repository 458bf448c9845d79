"""Additional bucket aggregations: composite, significant/rare terms,
sampler, nested/reverse_nested.

Reference counterparts:

- ``bucket/composite/CompositeAggregator.java`` — paginable multi-source
  buckets ordered by the natural source tuple order with ``after`` keys;
  here each source materializes a per-doc key column, the tuple key set
  builds vectorized per segment, and the reduce slices the globally-sorted
  tuple space (exact pagination, no coordinator approximation needed
  because partials carry every tuple past the cursor up to ``size`` per
  segment... sized by the same bound the reference uses).
- ``bucket/terms/SignificantTermsAggregator`` — foreground vs background
  counts scored by JLH (default) / chi-square / GND-style mutual
  information. Background = the whole shard (or a ``background_filter``).
- ``bucket/terms/RareTermsAggregator`` — long-tail terms with doc count
  at/below ``max_doc_count`` (exact per shard, merged exactly because
  partials keep full counts).
- ``bucket/sampler/SamplerAggregator`` — restrict sub-aggregations to the
  top ``shard_size`` scoring docs per shard.
- ``bucket/nested/NestedAggregator`` + ``ReverseNestedAggregator`` — hop
  the mask between the parent doc space and a nested path's hidden child
  docs (block-join arrays from ``index/segment.py``).

Port of ``elasticsearch_tpu/search/aggs_extra.py``: host numpy over the
host copy of the query's mask; a ``background_filter``'s mask comes back
from the device once a segment.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..common.errors import IllegalArgumentError, ParsingError
from .aggregations import (Aggregator, BucketAggregator, RangeAgg,
                           _bucket_payload, _keyword_pairs, _numeric_pairs,
                           _reduce_subs, _sub_results)


# ---------------------------------------------------------------------------
# composite
# ---------------------------------------------------------------------------


def _composite_interval(kind: str, cfg: dict) -> float:
    """Resolve a histogram/date_histogram source's bucket width in value
    space (millis for dates), accepting the ES interval spellings."""
    from .aggregations import _CALENDAR_INTERVALS, _parse_fixed_interval
    try:
        if kind == "histogram":
            return float(cfg["interval"])
        for key in ("fixed_interval", "interval"):
            v = cfg.get(key)
            if v is None:
                continue
            if isinstance(v, (int, float)):
                return float(v)
            return _parse_fixed_interval(str(v))
        cal = cfg.get("calendar_interval")
        if cal is not None:
            # calendar units approximate to fixed widths in the composite
            # key space (the reference's composite rounds the same way for
            # fixed units; month/year calendar rounding is approximated)
            unit = _CALENDAR_INTERVALS.get(cal, cal)
            return {"s": 1e3, "m": 6e4, "h": 3.6e6, "d": 8.64e7,
                    "w": 6.048e8, "M": 2.592e9, "q": 7.776e9,
                    "y": 3.1536e10}[unit]
        raise KeyError("interval")
    except (KeyError, TypeError, ValueError) as e:
        raise ParsingError(
            f"[composite] invalid interval for a [{kind}] source: "
            f"{cfg}") from e


class CompositeAgg(BucketAggregator):
    """Paginable multi-source buckets."""

    MAX_BUCKETS_CEILING = 65536

    def __init__(self, body: dict):
        if "sources" not in body:
            raise ParsingError("Required [sources]")
        sources = body.get("sources")
        if not sources or not isinstance(sources, list):
            raise ParsingError(
                "Composite [sources] cannot be null or empty")
        self.sources = []
        seen_names = set()
        dups = []
        for s in sources:
            if not isinstance(s, dict) or len(s) != 1:
                raise ParsingError(
                    "[composite] each source must be {name: {type: ...}}")
            (name, spec), = s.items()
            if name in seen_names:
                dups.append(name)
            seen_names.add(name)
            kinds = [k for k in ("terms", "histogram", "date_histogram",
                                 "geotile_grid")
                     if k in spec]
            if len(kinds) != 1:
                raise ParsingError(
                    f"[composite] source [{name}] must define exactly one "
                    f"of terms/histogram/date_histogram/geotile_grid")
            kind = kinds[0]
            cfg = spec[kind]
            self.sources.append({
                "name": name, "kind": kind,
                "field": cfg.get("field"),
                "interval": (_composite_interval(kind, cfg)
                             if kind in ("histogram", "date_histogram")
                             else None),
                "order": cfg.get("order", "asc"),
                "format": cfg.get("format"),
                "time_zone": cfg.get("time_zone"),
                "offset": cfg.get("offset"),
                "precision": int(cfg.get("precision", 7)),
                "calendar": cfg.get("calendar_interval"),
            })
        if dups:
            raise IllegalArgumentError(
                f"Composite source names must be unique, found "
                f"duplicates: [{','.join(sorted(set(dups)))}]")
        from .aggregations import MAX_BUCKETS
        self.size = int(body.get("size", 10))
        if self.size > MAX_BUCKETS[0]:
            raise IllegalArgumentError(
                f"Trying to create too many buckets. Must be less than or "
                f"equal to: [{MAX_BUCKETS[0]}] but was [{self.size}]. "
                f"This limit can be set by changing the "
                f"[search.max_buckets] cluster level setting.")
        self.after = body.get("after")

    def _render_key_value(self, src, v):
        from ..index.mapping import format_date_millis
        if src["kind"] == "date_histogram" and isinstance(v, (int, float)):
            if src["format"] == "iso8601" or (
                    src["format"] is None and src.get("time_zone")):
                tz = src.get("time_zone")
                if tz:
                    from .aggregations import _tz_offset_ms
                    off = _tz_offset_ms(tz, float(v))
                    base = format_date_millis(float(v) + off)[:-1]
                    sign = "+" if off >= 0 else "-"
                    o = abs(int(off)) // 60000
                    return f"{base}{sign}{o // 60:02d}:{o % 60:02d}"
                return format_date_millis(float(v))
            if src["format"]:
                from .fetch import java_date_format
                return java_date_format(float(v), src["format"])
            mapper = getattr(self, "_mapper", None)
            ft = mapper.field_type(src["field"]) if mapper else None
            from ..index.mapping import DateFieldType
            if isinstance(ft, DateFieldType) and ft.nanos:
                return format_date_millis(float(v))
            return int(v)
        if isinstance(v, float) and v.is_integer():
            return int(v)
        return v

    def _parse_after_value(self, src, v):
        if src["kind"] == "date_histogram" and isinstance(v, str):
            import re as _re
            from ..index.mapping import parse_date_millis
            try:
                ms = float(parse_date_millis(v))
            except Exception:   # noqa: BLE001
                return v
            # a cursor without an explicit zone reads in the SOURCE's tz
            if src.get("time_zone") and not _re.search(
                    r"(Z|[+-]\d{2}:?\d{2})$", v):
                from .aggregations import _tz_offset_ms
                ms -= _tz_offset_ms(src["time_zone"], ms)
            return ms
        return v

    # -- per-source key values ----------------------------------------------

    def _key_values(self, seg, src) -> list:
        """per-doc LIST of keys (every value of a multi-valued field forms
        its own combination — CompositeValuesSourceBuilder semantics);
        empty list = missing, excluded like the reference default."""
        n = seg.n_docs
        col = [[] for _ in range(n)]
        if src["kind"] == "geotile_grid":
            la = seg.numeric_fields.get(f"{src['field']}._lat")
            lo = seg.numeric_fields.get(f"{src['field']}._lon")
            if la is not None and lo is not None:
                from .aggs_geo import geotile_key
                for d, lat, lon in zip(la.docs_host, la.vals_host,
                                       lo.vals_host):
                    col[int(d)].append(
                        geotile_key(lat, lon, src["precision"]))
            return col
        if src["kind"] == "terms":
            kw = _keyword_pairs(seg, src["field"])
            if kw is not None:
                docs, ords, terms = kw
                for d, o in zip(docs, ords):
                    col[int(d)].append(terms[int(o)])
                return col
        num = _numeric_pairs(seg, src["field"])
        if num is not None:
            docs, vals = num
            if src["kind"] == "terms":
                for d, v in zip(docs, vals):
                    col[int(d)].append(float(v))
            else:
                iv = src["interval"]
                shift = 0.0
                if src.get("offset"):
                    from .aggregations import _parse_offset_ms
                    shift += _parse_offset_ms(src["offset"])
                if src.get("time_zone") and vals.size:
                    from .aggregations import _tz_offset_ms
                    shift -= _tz_offset_ms(src["time_zone"],
                                           float(vals[0]))
                cal = src.get("calendar")
                if cal is not None and src["kind"] == "date_histogram":
                    # true calendar rounding (weeks start Monday, months/
                    # quarters/years at their calendar boundary) — same
                    # rule as the standalone date_histogram
                    from .aggregations import (_CALENDAR_INTERVALS,
                                               _calendar_floor)
                    unit = _CALENDAR_INTERVALS.get(cal, cal)
                    keys = _calendar_floor(
                        np.asarray(vals, np.float64) - shift, unit) + shift
                    for d, k in zip(docs, keys):
                        col[int(d)].append(float(k))
                else:
                    for d, v in zip(docs, vals):
                        col[int(d)].append(
                            float(np.floor((v - shift) / iv) * iv + shift))
        # dedupe per doc, preserving order
        return [list(dict.fromkeys(c)) for c in col]

    def collect(self, ctx, seg, mask):
        import itertools as _it
        self._mapper = ctx.mapper
        docs_mask = mask[: seg.n_docs]
        cols = [self._key_values(seg, s) for s in self.sources]
        idx = np.flatnonzero(docs_mask)
        buckets: Dict[tuple, Tuple[int, dict]] = {}
        by_key_docs: Dict[tuple, List[int]] = {}
        for d in idx:
            per_source = [c[d] for c in cols]
            if any(not vs for vs in per_source):
                continue
            for key in _it.product(*per_source):
                by_key_docs.setdefault(key, []).append(int(d))
        from .aggregations import _doc_weights
        w = _doc_weights(seg)
        for key, ds in by_key_docs.items():
            n = len(ds) if w is None else int(w[ds].sum())
            if self.subs:
                bm = np.zeros(mask.shape[0], bool)
                bm[ds] = True
                sub = _bucket_payload(self, ctx, seg, bm)[1]
                buckets[key] = (n, sub)
            else:
                buckets[key] = (n, {})
        return buckets

    def _tuple_sort_key(self, key: tuple):
        parts = []
        for v, src in zip(key, self.sources):
            desc = src["order"] == "desc"
            if src["kind"] == "geotile_grid" and isinstance(v, str):
                z, x, y = (int(t) for t in v.split("/"))
                t3 = (z, x, y)
                parts.append((0, tuple(-c for c in t3) if desc else t3))
            elif isinstance(v, str):
                parts.append((1, _RevStr(v) if desc else v))
            else:
                parts.append((0, -float(v) if desc else float(v)))
        return tuple(parts)

    def reduce(self, partials):
        merged: Dict[tuple, List] = {}
        for p in partials:
            for key, item in p.items():
                merged.setdefault(key, []).append(item)
        keys = sorted(merged, key=self._tuple_sort_key)
        if self.after is not None:
            missing = [s["name"] for s in self.sources
                       if s["name"] not in self.after]
            if missing:
                raise ParsingError(
                    f"[composite] after key is missing sources {missing}")
            after_key = tuple(
                self._parse_after_value(s, self.after[s["name"]])
                for s in self.sources)
            ak = self._tuple_sort_key(after_key)
            keys = [k for k in keys if self._tuple_sort_key(k) > ak]
        page = keys[: self.size]
        buckets = []
        for key in page:
            items = merged[key]
            count = sum(c for c, _ in items)
            b = {"key": {s["name"]: self._render_key_value(s, v)
                         for s, v in zip(self.sources, key)},
                 "doc_count": count}
            if self.subs:
                b.update(_reduce_subs(self, [s for _, s in items]))
            buckets.append(b)
        out = {"buckets": buckets}
        if page:
            out["after_key"] = {
                s["name"]: self._render_key_value(s, v)
                for s, v in zip(self.sources, page[-1])}
        return out


class _RevStr:
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return self.v == other.v

    def __gt__(self, other):
        return other.v > self.v


# ---------------------------------------------------------------------------
# significant_terms / rare_terms
# ---------------------------------------------------------------------------


def _jlh(fg, fg_total, bg, bg_total) -> float:
    if fg == 0 or fg_total == 0 or bg_total == 0:
        return 0.0
    fg_pct = fg / fg_total
    bg_pct = bg / bg_total if bg_total else 0.0
    if fg_pct <= bg_pct or bg_pct == 0:
        return 0.0
    return (fg_pct - bg_pct) * (fg_pct / bg_pct)


def _chi_square(fg, fg_total, bg, bg_total) -> float:
    # 2x2 contingency chi-square with the reference's
    # include_negatives=false default
    a, b = fg, bg - fg if bg >= fg else 0
    c, d = fg_total - fg, max(bg_total - bg - (fg_total - fg), 0)
    n = a + b + c + d
    if n == 0 or (a + b) == 0 or (c + d) == 0 or (a + c) == 0 or \
            (b + d) == 0:
        return 0.0
    num = n * (a * d - b * c) ** 2
    den = (a + b) * (c + d) * (a + c) * (b + d)
    score = num / den
    if (a / (a + c) if a + c else 0) < (b / (b + d) if b + d else 0):
        return 0.0
    return score


def _check_regex_include_exclude(agg, mapper) -> None:
    """Regex-form include/exclude is string-fields-only
    (``IncludeExclude`` builds a LongFilter for numerics and rejects
    regex): shared by rare_terms and significant_terms."""
    if isinstance(agg.include, str) or isinstance(agg.exclude, str):
        from .aggregations import _field_type
        from ..index.mapping import KeywordFieldType, TextFieldType
        ft = _field_type(mapper, agg.field)
        if ft is not None and not isinstance(
                ft, (KeywordFieldType, TextFieldType)):
            raise IllegalArgumentError(
                f"Aggregation [{getattr(agg, 'name', agg.field)}] "
                f"cannot support regular expression style "
                f"include/exclude settings as they can only be "
                f"applied to string fields. Use an array of values "
                f"for include/exclude clauses")


def _include_exclude_passes(agg, key, inc_set, exc_set) -> bool:
    """One term against the agg's include/exclude (list sets are
    pre-coerced by the caller; strings are anchored regexes)."""
    import re as _re
    inc, exc = agg.include, agg.exclude
    if inc_set is not None and key not in inc_set:
        return False
    if isinstance(inc, str) and _re.fullmatch(inc, str(key)) is None:
        return False
    if exc_set is not None and key in exc_set:
        return False
    if isinstance(exc, str) and \
            _re.fullmatch(exc, str(key)) is not None:
        return False
    return True


class SignificantTermsAgg(BucketAggregator):
    KNOWN_PARAMS = {"field", "size", "shard_size", "min_doc_count",
                    "shard_min_doc_count", "background_filter", "jlh",
                    "chi_square", "gnd", "mutual_information",
                    "percentage", "script_heuristic", "include", "exclude",
                    "execution_hint", "filter_duplicate_text",
                    "source_fields"}

    def __init__(self, body: dict):
        import difflib
        for k in body:
            if k not in self.KNOWN_PARAMS:
                hint = difflib.get_close_matches(
                    k, sorted(self.KNOWN_PARAMS), n=1)
                suffix = f" did you mean [{hint[0]}]?" if hint else ""
                raise IllegalArgumentError(
                    f"[significant_terms] unknown field [{k}]{suffix}")
        self.field = body.get("field")
        if self.field is None:
            raise ParsingError("significant_terms requires [field]")
        self.size = int(body.get("size", 10))
        self.min_doc_count = int(body.get("min_doc_count", 3))
        self.heuristic = "chi_square" if "chi_square" in body else "jlh"
        self.background_filter = body.get("background_filter")
        self.include = body.get("include")
        self.exclude = body.get("exclude")
        self._inc_set = self._exc_set = None    # built lazily, once
        #: per-segment background stats, accumulated OUTSIDE the bucket
        #: partials: under a bucketing parent, collect only runs for
        #: (segment, bucket) pairs where the bucket exists, but the
        #: background population must span every segment seen. Every
        #: partial carries a reference to this dict so the stats survive
        #: pickling to a coordinating node (the reducing instance over
        #: there is a FRESH parse with an empty dict of its own).
        self._seg_bg: Dict[str, tuple] = {}

    def _bg_token(self, seg) -> str:
        """Segment identity for background dedup. seg_id ('_0', '_1')
        recurs across shards and indices, so segments get stamped with
        a process-unique token that also disambiguates across nodes."""
        tok = getattr(seg, "_sig_bg_token", None)
        if tok is None:
            import uuid
            tok = uuid.uuid4().hex
            seg._sig_bg_token = tok
        return tok

    def _bg_mask(self, ctx, seg, mask):
        if self.background_filter is not None:
            from .query_dsl import parse_query
            _, bgm = parse_query(self.background_filter).execute(
                ctx.shard_ctx, seg)
            return bgm.cpu().numpy()[: mask.shape[0]] & \
                _live_parents(seg, mask.shape[0])
        return _live_parents(seg, mask.shape[0])

    def _collect_text(self, ctx, seg, mask, f):
        """Postings-CSR path: per-term fg doc counts by bincount over
        posting term-ids (text fields have no doc-values column)."""
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
        fg = np.bincount(tid[mask[f.docs_host]], minlength=v)
        t = {}
        for i in np.flatnonzero(fg):
            t[terms_sorted[i]] = int(fg[i])
        return {"fg_total": int(mask[: seg.n_docs].sum()), "terms": t,
                "seg_bg": self._seg_bg}

    def _key_passes(self, key) -> bool:
        # sig-terms keys are always strings (keyword/text sources),
        # so list include/exclude needs no field-type coercion
        if self._inc_set is None and isinstance(self.include, list):
            self._inc_set = set(self.include)
        if self._exc_set is None and isinstance(self.exclude, list):
            self._exc_set = set(self.exclude)
        return _include_exclude_passes(self, key, self._inc_set,
                                       self._exc_set)

    def collect(self, ctx, seg, mask):
        _check_regex_include_exclude(self, ctx.mapper)
        kw = _keyword_pairs(seg, self.field)
        if kw is None:
            field = self.field
            ft = ctx.mapper.field_type(field) if ctx.mapper else None
            if ft is not None and ft.name != field:
                field = ft.name
            f = seg.text_fields.get(field)
            if f is not None:
                return self._collect_text(ctx, seg, mask, f)
            # field-less segment: its docs still belong to both the
            # foreground and the background populations
            tok = self._bg_token(seg)
            if tok not in self._seg_bg:
                self._seg_bg[tok] = (
                    int(_live_parents(
                        seg, mask.shape[0])[: seg.n_docs].sum()), {})
            return {"fg_total": int(mask[: seg.n_docs].sum()),
                    "terms": {}, "seg_bg": self._seg_bg}
        docs, ords, terms = kw
        tok = self._bg_token(seg)
        if tok not in self._seg_bg:
            bg_mask = self._bg_mask(ctx, seg, mask)
            bg_ords, bg_counts = np.unique(ords[bg_mask[docs]],
                                           return_counts=True)
            self._seg_bg[tok] = (
                int(bg_mask[: seg.n_docs].sum()),
                {terms[o]: int(c) for o, c in
                 zip(bg_ords.tolist(), bg_counts.tolist())})
        pm_fg = mask[docs]
        fg_ords, fg_counts = np.unique(ords[pm_fg], return_counts=True)
        t = {}
        for o, c in zip(fg_ords.tolist(), fg_counts.tolist()):
            t[terms[o]] = c
        return {"fg_total": int(mask[: seg.n_docs].sum()), "terms": t,
                "seg_bg": self._seg_bg}

    def reduce(self, partials):
        fg_total = sum(p["fg_total"] for p in partials)
        # union background stats: the local instance dict plus whatever
        # rode in on (possibly remote) partials, deduped by seg token
        seen = dict(self._seg_bg)
        for p in partials:
            seen.update(p.get("seg_bg") or {})
        bg_total = sum(t for t, _ in seen.values())
        bg_of: Dict[str, int] = {}
        for _, bmap in seen.values():
            for term, c in bmap.items():
                bg_of[term] = bg_of.get(term, 0) + c
        merged: Dict[str, int] = {}
        for p in partials:
            for term, fg in p["terms"].items():
                merged[term] = merged.get(term, 0) + fg
        score_fn = _chi_square if self.heuristic == "chi_square" else _jlh
        rows = []
        for term, fg in merged.items():
            bg = bg_of.get(term, 0)
            if fg < self.min_doc_count or not self._key_passes(term):
                continue
            score = score_fn(fg, fg_total, bg, bg_total)
            if score > 0:
                rows.append((score, term, fg, bg))
        rows.sort(key=lambda r: (-r[0], r[1]))
        return {"doc_count": fg_total,
                "bg_count": bg_total,
                "buckets": [{"key": t, "doc_count": fg, "score": s,
                             "bg_count": bg}
                            for s, t, fg, bg in rows[: self.size]]}


class RareTermsAgg(BucketAggregator):
    def __init__(self, body: dict):
        self.field = body.get("field")
        if self.field is None:
            raise ParsingError("rare_terms requires [field]")
        self.max_doc_count = int(body.get("max_doc_count", 1))
        if not 1 <= self.max_doc_count <= 100:
            raise IllegalArgumentError(
                "[max_doc_count] must be in [1, 100]")
        self.include = body.get("include")
        self.exclude = body.get("exclude")
        self._inc_set = self._exc_set = None    # coerced lazily, once

    def _coerce(self, vals):
        """include/exclude values → key space via the field type (dates
        parse to epoch millis, ips canonicalize, numerics to float)."""
        from .aggregations import _field_type
        from ..index.mapping import (BooleanFieldType, DateFieldType,
                                     IpFieldType, NumberFieldType,
                                     parse_date_millis)
        ft = _field_type(getattr(self, "_mapper", None), self.field)
        out = set()
        for v in vals:
            try:
                if isinstance(ft, DateFieldType):
                    v = float(parse_date_millis(v, ft.format))
                elif isinstance(ft, BooleanFieldType):
                    v = 1.0 if v in (True, "true") else 0.0
                elif isinstance(ft, NumberFieldType):
                    v = float(v)
            except Exception:   # noqa: BLE001 — keep raw on failure
                pass
            out.add(v)
        return out

    def _included(self, key) -> bool:
        if self._inc_set is None and isinstance(self.include, list):
            self._inc_set = self._coerce(self.include)
        if self._exc_set is None and isinstance(self.exclude, list):
            self._exc_set = self._coerce(self.exclude)
        return _include_exclude_passes(self, key, self._inc_set,
                                       self._exc_set)

    def collect(self, ctx, seg, mask):
        self._mapper = ctx.mapper
        _check_regex_include_exclude(self, ctx.mapper)
        buckets: Dict[Any, tuple] = {}
        kw = _keyword_pairs(seg, self.field)
        if kw is not None:
            docs, ords, terms = kw
            pm = mask[docs]
            sel, counts = np.unique(ords[pm], return_counts=True)
            for o, c in zip(sel.tolist(), counts.tolist()):
                sub = {}
                if self.subs:
                    bm = np.zeros(mask.shape[0], bool)
                    bm[docs[pm][ords[pm] == o]] = True
                    sub = _bucket_payload(self, ctx, seg, bm)[1]
                buckets[terms[o]] = (c, sub)
        else:
            num = _numeric_pairs(seg, self.field, ctx.mapper)
            if num is not None:
                docs, vals = num
                pm = mask[docs]
                sel, counts = np.unique(vals[pm], return_counts=True)
                for v, c in zip(sel.tolist(), counts.tolist()):
                    sub = {}
                    if self.subs:
                        bm = np.zeros(mask.shape[0], bool)
                        bm[docs[pm][vals[pm] == v]] = True
                        sub = _bucket_payload(self, ctx, seg, bm)[1]
                    buckets[v] = (c, sub)
        return buckets

    def reduce(self, partials):
        from .aggregations import _reduce_subs, _field_type
        from ..index.mapping import BooleanFieldType, DateFieldType
        merged: Dict[Any, list] = {}
        for p in partials:
            for term, item in p.items():
                cur = merged.setdefault(term, [0, []])
                cur[0] += item[0]
                cur[1].append(item[1])
        rows = [(t, c, subs) for t, (c, subs) in merged.items()
                if c <= self.max_doc_count and self._included(t)]
        rows.sort(key=lambda r: (r[1], str(r[0])))
        mapper = getattr(self, "_mapper", None)
        ft = _field_type(mapper, self.field) if mapper else None
        out = []
        for t, c, subs in rows:
            key = int(t) if isinstance(t, float) and t.is_integer() else t
            b = {"key": key, "doc_count": c}
            if isinstance(ft, BooleanFieldType):
                b["key_as_string"] = "true" if key else "false"
            elif isinstance(ft, DateFieldType):
                from ..index.mapping import format_date_millis
                b["key_as_string"] = format_date_millis(float(t))
            if self.subs:
                b.update(_reduce_subs(self, subs))
            out.append(b)
        return {"buckets": out}


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------


class SamplerAgg(BucketAggregator):
    """Sub-aggregations over only the top ``shard_size`` scoring docs per
    shard (needs per-segment scores from the query phase)."""

    def __init__(self, body: dict):
        self.shard_size = int(body.get("shard_size", 100))

    def collect(self, ctx, seg, mask):
        scores = ctx.seg_scores.get(seg.seg_id)
        docs_mask = mask[: seg.n_docs]
        idx = np.flatnonzero(docs_mask)
        if scores is not None and idx.size > self.shard_size:
            sc = scores[: seg.n_docs][idx]
            keep = idx[np.argsort(-sc, kind="stable")[: self.shard_size]]
        else:
            keep = idx[: self.shard_size]
        sm = np.zeros(mask.shape[0], bool)
        sm[keep] = True
        return (int(sm.sum()), _sub_results(self, ctx, seg, sm))

    def reduce(self, partials):
        count = sum(c for c, _ in partials)
        out = {"doc_count": count}
        out.update(_reduce_subs(self, [s for _, s in partials]))
        return out


# ---------------------------------------------------------------------------
# nested / reverse_nested
# ---------------------------------------------------------------------------


def _live_parents(seg, n) -> np.ndarray:
    m = np.zeros(n, bool)
    m[: seg.n_docs] = seg.live
    if seg.has_nested:
        m[: seg.n_docs] &= seg.parent_mask
    return m


class NestedAgg(BucketAggregator):
    """Hop the mask from parent docs DOWN to their ``path`` children:
    sub-aggregations then run in the child doc space, where the
    ``path.field`` doc values live."""

    def __init__(self, body: dict):
        self.path = body.get("path")
        if self.path is None:
            raise ParsingError("nested aggregation requires [path]")

    def collect(self, ctx, seg, mask):
        n = mask.shape[0]
        child_mask = np.zeros(n, bool)
        pm = seg.nested_paths.get(self.path)
        if pm is not None:
            child_idx = np.flatnonzero(pm & seg.live[: seg.n_docs])
            parents = seg.parent_of[child_idx]
            keep = mask[parents]
            child_mask[child_idx[keep]] = True
        return (int(child_mask.sum()),
                _sub_results(self, ctx, seg, child_mask))

    def reduce(self, partials):
        count = sum(c for c, _ in partials)
        out = {"doc_count": count}
        out.update(_reduce_subs(self, [s for _, s in partials]))
        return out


class ReverseNestedAgg(BucketAggregator):
    """Inside a ``nested`` agg: hop the (child-space) mask back UP to the
    parent documents."""

    def __init__(self, body: dict):
        self.path = body.get("path")     # None → all the way to the root

    def collect(self, ctx, seg, mask):
        n = mask.shape[0]
        up = np.zeros(n, bool)
        idx = np.flatnonzero(mask[: seg.n_docs])
        if idx.size:
            parents = idx.copy()
            # climb until the target level: root (parent_mask) or the
            # docs belonging to self.path
            target = (seg.nested_paths.get(self.path)
                      if self.path is not None else None)
            for _ in range(8):           # nesting depth bound
                at_target = seg.parent_mask[parents] if target is None \
                    else target[parents]
                done = parents[at_target]
                up[done] = True
                rest = parents[~at_target]
                if rest.size == 0:
                    break
                parents = seg.parent_of[rest]
        return (int(up.sum()), _sub_results(self, ctx, seg, up))

    def reduce(self, partials):
        count = sum(c for c, _ in partials)
        out = {"doc_count": count}
        out.update(_reduce_subs(self, [s for _, s in partials]))
        return out


class DateRangeAgg(RangeAgg):
    """date_range (reference: ``bucket/range/DateRangeAggregationBuilder``):
    bounds parse through the FIELD's date format (epoch_second bounds are
    seconds, not millis) and keys render with it; date-math bounds
    supported via parse_date_millis."""

    def __init__(self, body):
        super().__init__(body)
        self.format = body.get("format")
        self._ffmt = None               # field format, stashed at collect

    def _resolve(self, ctx):
        from ..index.mapping import DateFieldType
        ft = ctx.mapper.field_type(self.field)
        if isinstance(ft, DateFieldType):
            self._ffmt = ft.format

    def _field_fmt(self):
        """Field date format: stashed at collect (_resolve), or derived
        from the injected mapper when reducing REMOTE partials (the
        coordinator never ran collect — see inject_mapper)."""
        if self._ffmt is None:
            mapper = getattr(self, "_mapper", None)
            if mapper is not None:
                from ..index.mapping import DateFieldType
                ft = mapper.field_type(self.field)
                if isinstance(ft, DateFieldType):
                    self._ffmt = ft.format
        return self._ffmt

    def _bounds_salt(self):
        return self.format or self._field_fmt()

    def _parse_bound(self, v, which: str) -> float:
        from ..index.mapping import parse_date_millis
        fmt = self.format or self._field_fmt() or \
            "strict_date_optional_time||epoch_millis"
        return float(parse_date_millis(v, fmt))

    def _format_bound(self, v: float):
        return v

    def _fmt_ms(self, ms: float) -> str:
        from ..index.mapping import format_date_millis
        fmt = (self.format or self._field_fmt() or "").split("||")[0]
        if fmt == "epoch_second":
            return str(int(ms // 1000))
        if fmt == "epoch_millis":
            return str(int(ms))
        if fmt and not fmt.startswith("strict_date_optional_time"):
            from .fetch import java_date_format
            return java_date_format(ms, fmt)
        return format_date_millis(ms)

    def _range_key(self, r) -> str:
        if "key" in r:
            return r["key"]
        lo, hi = self._bounds(r)
        f = "*" if lo is None else self._fmt_ms(lo)
        t = "*" if hi is None else self._fmt_ms(hi)
        return f"{f}-{t}"


class IpRangeAgg(RangeAgg):
    """ip_range (reference: ``bucket/range/IpRangeAggregationBuilder``):
    bounds are addresses or CIDR masks over the ip field's numeric
    column."""

    def __init__(self, body):
        ranges = []
        for r in body.get("ranges") or []:
            if "mask" in r:
                from ..index.mapping import IpFieldType
                bounds = IpFieldType.cidr_bounds(r["mask"])
                if bounds is None:
                    raise ParsingError(
                        f"[ip_range] invalid mask [{r['mask']}]")
                lo, hi = bounds
                r = dict(r, **{"from": lo, "to": hi + 1,
                               "key": r.get("key", r["mask"])})
                r.pop("mask")
            ranges.append(r)
        super().__init__(dict(body, ranges=ranges))

    def _parse_bound(self, v, which: str) -> float:
        if isinstance(v, (int, float)):
            return float(v)
        import ipaddress
        return float(int(ipaddress.ip_address(str(v))))

    def _format_bound(self, v: float):
        import ipaddress
        if 0 <= v < 2 ** 32:
            return str(ipaddress.IPv4Address(int(v)))
        if v < 2 ** 128:
            return str(ipaddress.IPv6Address(int(v)))
        return float(v)                  # past the address space (mask /0)


class _JoinBucketAgg(BucketAggregator):
    """Shared machinery of the parent-join ``children`` / ``parent``
    single-bucket aggregations (reference: ``modules/parent-join/...
    aggregations/ChildrenAggregator.java`` / ``ParentAggregator``)."""

    def __init__(self, body: dict):
        self.rel_type = body.get("type")
        if self.rel_type is None:
            raise ParsingError(
                f"Missing [type] for [{self.kind}] aggregation")

    def _transform(self, ctx, seg, mask) -> np.ndarray:
        from .query_dsl import _join_field, _kw_values_by_doc
        out = np.zeros(seg.n_pad, bool)
        jf = _join_field(ctx)
        if jf is None or jf.parent_rel_of(self.rel_type) is None:
            return out
        parent_rel = jf.parent_rel_of(self.rel_type)
        rels = _kw_values_by_doc(seg, jf.name)
        fam = _kw_values_by_doc(seg, jf.id_field_for(self.rel_type))
        if self.kind == "children":
            # parents in the bucket -> their child docs of rel_type
            bucket_ids = {seg.doc_uids[d]
                          for d in np.flatnonzero(mask[: seg.n_docs])
                          if rels.get(d) == parent_rel}
            for d, pid in fam.items():
                if rels.get(d) == self.rel_type and pid in bucket_ids \
                        and seg.live[d]:
                    out[d] = True
        else:
            # child docs in the bucket -> their parent docs
            pids = {pid for d, pid in fam.items()
                    if mask[d] and rels.get(d) == self.rel_type}
            for pid in pids:
                d = seg.find_doc(pid)
                if d is not None and rels.get(d) == parent_rel and \
                        seg.live[d]:
                    out[d] = True
        return out

    def collect(self, ctx, seg, mask):
        bm = self._transform(ctx, seg, mask)
        if self.subs:
            return _bucket_payload(self, ctx, seg, bm)
        return (int(bm.sum()), {})

    def reduce(self, partials):
        count = sum(c for c, _ in partials)
        out = {"doc_count": count}
        if self.subs:
            out.update(_reduce_subs(self, [s for _, s in partials]))
        return out


class ChildrenAgg(_JoinBucketAgg):
    kind = "children"


class ParentAgg(_JoinBucketAgg):
    #: "type" names the CHILD relation whose parents we bucket
    kind = "parent"


# self-registration: runs after this module's classes exist, against the
# fully-initialized (or at least _AGG_PARSERS-bearing) aggregations module
from .aggregations import _AGG_PARSERS      # noqa: E402

_AGG_PARSERS.update({
    "date_range": DateRangeAgg,
    "ip_range": IpRangeAgg,
    "composite": CompositeAgg,
    "significant_terms": SignificantTermsAgg,
    "rare_terms": RareTermsAgg,
    "sampler": SamplerAgg,
    "nested": NestedAgg,
    "reverse_nested": ReverseNestedAgg,
    "children": ChildrenAgg,
    "parent": ParentAgg,
})
