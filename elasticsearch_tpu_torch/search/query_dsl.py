"""Query DSL: parse JSON queries and execute them against segments (port of
``elasticsearch_tpu/search/query_dsl.py``, the leaf queries that reach the
segment kernels and the compound queries over them).

Every query evaluates, per segment, to a pair of dense tensors on the
segment's device ``(scores f32[n_pad], mask bool[n_pad])``: eager
whole-segment scoring instead of doc-at-a-time iterators. Compound queries
are array algebra (``bool``: AND/OR/NOT on masks, sums of the scoring
clauses; ``dis_max``: elementwise max + tie_breaker; ``constant_score``:
the mask with a constant). The eager operations run in the reference's
order, so the f32 sums are the same bits.

The kernels on this path: K16 (``ops/bm25.py``, text and keyword scoring),
K17 and K18 (``ops/masks.py``, keyword term sets, prefixes, numeric and
keyword ranges). ``parse_query`` refuses, naming it, every query type this
module does not port yet; it never falls back.
"""

from __future__ import annotations

import bisect
import difflib
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common.errors import (IllegalArgumentError, ParsingError,
                             QueryShardError)
from ..index.mapping import (
    AggregateMetricDoubleFieldType, BooleanFieldType,
    ConstantKeywordFieldType, DateFieldType, IpFieldType, KeywordFieldType,
    MapperService, NumberFieldType, ObjectFieldType, RangeFieldType,
    RankFeatureFieldType, RuntimeFieldType, TextFieldType,
    parse_date_millis)
from ..index.segment import Segment
from ..ops.bm25 import DEFAULT_B, DEFAULT_K1, get_bm25_kernel, idf_weight
from ..ops.masks import get_postings_match_kernel, get_range_mask_kernel
from ..utils.shapes import round_up_pow2


# ---------------------------------------------------------------------------
# Shard-level execution context
# ---------------------------------------------------------------------------


class ShardContext:
    """Shard-level stats + segment list for one search. idf/avgdl are
    cross-segment (Lucene computes them at the IndexSearcher level —
    ``search/similarity`` stats in ``TermStatistics``)."""

    def __init__(self, segments: List[Segment], mapper: MapperService):
        self.segments = [s for s in segments if s.n_docs > 0]
        self.mapper = mapper
        # Lucene idf uses docCount of the field (docs incl. deleted).
        self.total_docs = sum(s.n_docs for s in self.segments)
        self._df_cache: Dict[Tuple[str, str], int] = {}
        self._field_stats_cache: Dict[str, Tuple[float, int]] = {}

    def term_df(self, field: str, term: str) -> int:
        key = (field, term)
        df = self._df_cache.get(key)
        if df is None:
            df = sum(s.term_df(field, term) for s in self.segments)
            self._df_cache[key] = df
        return df

    def field_avgdl(self, field: str) -> float:
        stats = self._field_stats_cache.get(field)
        if stats is None:
            sum_dl = 0.0
            doc_count = 0
            for s in self.segments:
                sdl, dc = s.field_stats(field)
                sum_dl += sdl
                doc_count += dc
            stats = (sum_dl, doc_count)
            self._field_stats_cache[field] = stats
        sum_dl, doc_count = stats
        return sum_dl / doc_count if doc_count else 1.0

    def field_type(self, name: str):
        return self.mapper.field_type(name)

    def concrete_field(self, name: str) -> str:
        """Resolve a field ALIAS to its target path (segment tables key by
        concrete names; FieldAliasMapper semantics)."""
        ft = self.mapper.field_type(name)
        return ft.name if ft is not None and ft.name != name else name


def _f32(v) -> float:
    """A boost or weight as the f32 the reference multiplies by."""
    return float(np.float32(v))


def _where(mask: torch.Tensor, value, other: float = 0.0) -> torch.Tensor:
    """``jnp.where(mask, value, other)`` as f32: ``value`` is a tensor or
    a scalar (an f32 constant)."""
    if not isinstance(value, torch.Tensor):
        value = torch.tensor(_f32(value), device=mask.device)
    return torch.where(mask, value,
                       torch.tensor(_f32(other), device=mask.device))


def _host_mask_result(seg: Segment, host_mask: np.ndarray, boost: float):
    """A mask computed on the host, uploaded, with a constant score."""
    mask = torch.as_tensor(host_mask, device=seg.device)
    return _where(mask, boost), mask


def _const_result(seg: Segment, score: float, value: bool):
    n, dev = seg.n_pad, seg.device
    if value:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
        scores = torch.full((n,), _f32(score), dtype=torch.float32,
                            device=dev)
    else:
        mask = torch.zeros(n, dtype=torch.bool, device=dev)
        scores = torch.zeros(n, dtype=torch.float32, device=dev)
    return scores, mask


def _not_ported(what: str, where: str, item: str = "A6b"):
    return ParsingError(f"{what} is not ported to the PyTorch package yet "
                        f"(ROADMAP {item}; reference {where})")


# ---------------------------------------------------------------------------
# Scoring helpers
# ---------------------------------------------------------------------------


def _term_runs(ctx: ShardContext, f, field: str, terms: List[str]):
    q = len(terms)
    starts = np.zeros(q, np.int32)
    lengths = np.zeros(q, np.int32)
    dfs = np.zeros(q, np.int64)
    max_len = 1
    for i, t in enumerate(terms):
        s, l, _ = f.term_run(t)
        starts[i], lengths[i] = s, l
        dfs[i] = ctx.term_df(field, t)
        max_len = max(max_len, l)
    return starts, lengths, dfs, round_up_pow2(max_len)


def _score_text_terms(ctx: ShardContext, seg: Segment, field: str,
                      term_weights: Dict[str, float]):
    """BM25-score a bag of unique terms against one segment's text field
    (K16). Returns (scores f32[N_pad], matched int32[N_pad], n_unique)."""
    f = seg.text_fields.get(field)
    terms = list(term_weights)
    q = len(terms)
    if f is None or q == 0:
        z = torch.zeros(seg.n_pad, dtype=torch.float32, device=seg.device)
        return z, torch.zeros(seg.n_pad, dtype=torch.int32,
                              device=seg.device), q
    starts, lengths, dfs, L = _term_runs(ctx, f, field, terms)
    idf = idf_weight(ctx.total_docs, dfs)
    weights = np.asarray([term_weights[t] for t in terms], np.float32)
    avgdl = np.float32(max(ctx.field_avgdl(field), 1e-9))
    kernel = get_bm25_kernel(seg.n_pad, L)
    scores, matched = kernel(f.docs_dev, f.tf_dev, f.doc_len_dev, starts,
                             lengths, idf, weights, avgdl,
                             np.float32(DEFAULT_K1), np.float32(DEFAULT_B))
    return scores, matched, q


def _keyword_terms_result(ctx: ShardContext, seg: Segment, field: str,
                          term_weights: Dict[str, float], scored: bool):
    """Match keyword terms. When ``scored``, per-term score is idf × weight
    (norms disabled → LegacyBM25 collapses to idf for tf=1; reference:
    Lucene BM25 with omitNorms, selected by ``KeywordFieldMapper``): K16
    with tf 1, dl 0, b 0. Unscored: K17's counts."""
    f = seg.keyword_fields.get(field)
    terms = list(term_weights)
    q = len(terms)
    dev = seg.device
    if f is None or q == 0:
        return (torch.zeros(seg.n_pad, dtype=torch.float32, device=dev),
                torch.zeros(seg.n_pad, dtype=torch.int32, device=dev), q)
    starts, lengths, dfs, L = _term_runs(ctx, f, field, terms)
    if scored:
        idf = idf_weight(ctx.total_docs, dfs)
        weights = np.asarray([term_weights[t] for t in terms], np.float32)
        kernel = get_bm25_kernel(seg.n_pad, L)
        # norms disabled → b=0 and tf=1, so the BM25 kernel reduces to idf
        ones, zeros = f.bm25_constants()
        scores, matched = kernel(
            f.docs_dev, ones, zeros, starts, lengths, idf, weights,
            np.float32(1.0), np.float32(DEFAULT_K1), np.float32(0.0))
        return scores, matched, q
    kernel = get_postings_match_kernel(seg.n_pad, L)
    matched = kernel(f.docs_dev, starts, lengths)
    return (torch.zeros(seg.n_pad, dtype=torch.float32, device=dev),
            matched, q)


# ---------------------------------------------------------------------------
# minimum_should_match (reference: common/lucene/search/Queries.java)
# ---------------------------------------------------------------------------

_MSM_PART = re.compile(r"^\s*(-?\d+)(%?)\s*$")


def resolve_minimum_should_match(spec, clause_count: int) -> int:
    if spec is None:
        return 0
    if isinstance(spec, int):
        result = spec
    else:
        s = str(spec)
        if "<" in s:
            # "N<spec" conditional: if clause_count > N apply spec, else all
            # clauses are required (reference: Queries.calculateMinShouldMatch)
            chosen = None
            for part in s.split():
                if "<" not in part:
                    continue
                cond, _, val = part.partition("<")
                if clause_count > int(cond):
                    chosen = val
            if chosen is None:
                return clause_count
            s = chosen
        m = _MSM_PART.match(s)
        if not m:
            raise ParsingError(f"invalid minimum_should_match [{spec}]")
        if m.group(2):
            pct = int(m.group(1))
            calc = int(abs(pct) / 100.0 * clause_count)
            result = calc if pct >= 0 else clause_count - calc
        else:
            result = int(m.group(1))
    if result < 0:
        result = clause_count + result
    return max(0, min(result, clause_count))


# ---------------------------------------------------------------------------
# Query tree
# ---------------------------------------------------------------------------


class Query:
    boost: float = 1.0

    def execute(self, ctx: ShardContext, seg: Segment):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self.__dict__})"


class MatchAllQuery(Query):
    def __init__(self, boost: float = 1.0):
        self.boost = boost

    def execute(self, ctx, seg):
        return _const_result(seg, self.boost, True)


class MatchNoneQuery(Query):
    def execute(self, ctx, seg):
        return _const_result(seg, 0.0, False)


class MatchQuery(Query):
    """Full-text match (reference: ``index/query/MatchQueryBuilder.java``).
    Analyzes the text with the field's search analyzer; OR semantics by
    default, ``operator=and`` / ``minimum_should_match`` supported."""

    def __init__(self, field: str, text, operator: str = "or",
                 minimum_should_match=None, boost: float = 1.0,
                 analyzer: Optional[str] = None):
        self.field = field
        self.text = text
        self.operator = operator.lower()
        self.msm = minimum_should_match
        self.boost = boost
        self.analyzer = analyzer

    def _analyze(self, ctx: ShardContext) -> List[str]:
        ft = ctx.field_type(self.field)
        if isinstance(ft, TextFieldType):
            analyzer = (ctx.mapper.analysis.get(self.analyzer)
                        if self.analyzer else ft.search_analyzer)
            return analyzer.terms(str(self.text))
        if isinstance(ft, KeywordFieldType):
            v = ft.parse_value(self.text)  # applies normalizer/ignore_above
            return [v] if v is not None else []
        return [str(self.text)]

    def execute(self, ctx, seg):
        self.field = ctx.concrete_field(self.field)
        ft = ctx.field_type(self.field)
        if ft is None:
            return _const_result(seg, 0.0, False)
        if isinstance(ft, (NumberFieldType, DateFieldType, BooleanFieldType)):
            return TermQuery(self.field, self.text, self.boost).execute(ctx, seg)
        terms = self._analyze(ctx)
        if not terms:
            return _const_result(seg, 0.0, False)
        weights: Dict[str, float] = {}
        for t in terms:
            weights[t] = weights.get(t, 0.0) + 1.0
        if isinstance(ft, KeywordFieldType):
            scores, matched, q = _keyword_terms_result(ctx, seg, self.field,
                                                       weights, scored=True)
        else:
            scores, matched, q = _score_text_terms(ctx, seg, self.field, weights)
        n_required = q if self.operator == "and" else \
            max(1, resolve_minimum_should_match(self.msm, q))
        mask = matched >= n_required
        return scores * _f32(self.boost), mask


class TermQuery(Query):
    """Exact term (reference: ``TermQueryBuilder.java``). Text fields score
    BM25 on the unanalyzed term; keyword fields score idf; numeric/date/bool
    behave as an equality filter with constant score."""

    def __init__(self, field: str, value, boost: float = 1.0,
                 case_insensitive: bool = False):
        self.field = field
        self.value = value
        self.boost = boost
        self.case_insensitive = case_insensitive

    def execute(self, ctx, seg):
        if self.field == "_id":
            return IdsQuery([self.value], self.boost).execute(ctx, seg)
        if self.case_insensitive:
            # the reference rewrites it to a case-insensitive regexp scan
            raise _not_ported("[term] with [case_insensitive]",
                              "search/query_dsl.py:399 (WildcardQuery)")
        self.field = ctx.concrete_field(self.field)
        ft = ctx.field_type(self.field)
        if ft is None:
            # unmapped META keyword columns (_ignored, _routing) are
            # still term-addressable
            if self.field in seg.keyword_fields:
                scores, matched, _ = _keyword_terms_result(
                    ctx, seg, self.field, {str(self.value): 1.0},
                    scored=False)
                return scores * _f32(self.boost), matched > 0
            return _const_result(seg, 0.0, False)
        if isinstance(ft, TextFieldType):
            scores, matched, _ = _score_text_terms(
                ctx, seg, self.field, {str(self.value): 1.0})
            return scores * _f32(self.boost), matched > 0
        if isinstance(ft, ConstantKeywordFieldType):
            # query-time rewrite against the mapped constant: matches all
            # docs (including ones indexed before the value pinned) or
            # none (ConstantKeywordFieldMapper.termQuery)
            hit = ft.value is not None and str(self.value) == ft.value
            return _const_result(seg, self.boost if hit else 0.0, hit)
        if isinstance(ft, KeywordFieldType):
            v = ft.parse_value(self.value)
            scores, matched, _ = _keyword_terms_result(
                ctx, seg, self.field, {v: 1.0}, scored=True)
            return scores * _f32(self.boost), matched > 0
        if isinstance(ft, IpFieldType):
            cidr = IpFieldType.cidr_bounds(self.value)
            if cidr is not None:
                return _exact_numeric_mask(seg, self.field, cidr[0],
                                           cidr[1], self.boost)
            _, num = ft.parse_value(self.value)
            return _exact_numeric_mask(seg, self.field, num, num,
                                       self.boost)
        if isinstance(ft, RangeFieldType):
            if ft.range_kind == "ip_range" and "/" in str(self.value):
                lo, hi = IpFieldType.cidr_bounds(self.value)
                return _range_field_result(seg, self.field, lo, hi,
                                           "intersects", self.boost)
            p = ft._point(self.value)      # point containment
            return _range_field_result(seg, self.field, p, p,
                                       "intersects", self.boost)
        if isinstance(ft, DateFieldType):
            # query-side values may use date math (now/d etc.)
            val = parse_date_millis(self.value, ft.format)
            return _numeric_range_result(seg, self.field, val, val,
                                         self.boost)
        if isinstance(ft, (NumberFieldType, BooleanFieldType)):
            val = ft.parse_value(self.value)
            return _numeric_range_result(seg, self.field, val, val, self.boost)
        if isinstance(ft, AggregateMetricDoubleFieldType):
            # equality against the default_metric column
            val = float(self.value)
            return _numeric_range_result(seg, self.field, val, val,
                                         self.boost)
        return _const_result(seg, 0.0, False)


class TermsQuery(Query):
    """Terms disjunction, constant score (reference: ``TermsQueryBuilder``
    rewrites to a constant-score set query)."""

    def __init__(self, field: str, values: List, boost: float = 1.0):
        self.field = field
        self.values = values
        self.boost = boost

    def execute(self, ctx, seg):
        if self.field == "_id":
            return IdsQuery(list(self.values), self.boost).execute(ctx, seg)
        self.field = ctx.concrete_field(self.field)
        ft = ctx.field_type(self.field)
        if ft is None and self.field in seg.keyword_fields and self.values:
            scores, matched, _ = _keyword_terms_result(
                ctx, seg, self.field,
                {str(v): 1.0 for v in self.values}, scored=False)
            return scores * _f32(self.boost), matched > 0
        if ft is None or not self.values:
            return _const_result(seg, 0.0, False)
        if isinstance(ft, (NumberFieldType, DateFieldType, BooleanFieldType)):
            mask = torch.zeros(seg.n_pad, dtype=torch.bool, device=seg.device)
            for v in self.values:
                val = parse_date_millis(v, ft.format) \
                    if isinstance(ft, DateFieldType) else ft.parse_value(v)
                _, m = _numeric_range_result(seg, self.field, val, val, 1.0)
                mask = mask | m
            return _where(mask, self.boost), mask
        if isinstance(ft, ConstantKeywordFieldType):
            hit = ft.value is not None and \
                any(str(v) == ft.value for v in self.values)
            return _const_result(seg, self.boost if hit else 0.0, hit)
        if isinstance(ft, KeywordFieldType):
            weights = {}
            for v in self.values:
                pv = ft.parse_value(v)
                if pv is not None:
                    weights[pv] = 1.0
            _, matched, _ = _keyword_terms_result(ctx, seg, self.field,
                                                  weights, scored=False)
        else:
            weights = {str(v): 1.0 for v in self.values}
            _, matched, _ = _score_text_terms(ctx, seg, self.field, weights)
        mask = matched > 0
        return _where(mask, self.boost), mask


def _exact_numeric_mask(seg: Segment, field: str, lo, hi, boost):
    """Host-side EXACT f64 inclusive range mask over a numeric field's
    pairs — for ip fields, whose query bounds are pre-adjusted to inclusive
    exact integers (CIDR boundaries near 2^32); general numeric ranges run
    in device rank space (``_numeric_range_result``)."""
    nf = seg.numeric_fields.get(field)
    if nf is None:
        return _const_result(seg, 0.0, False)
    lo_v = -1.8e308 if lo is None else float(lo)
    hi_v = 1.8e308 if hi is None else float(hi)
    sel = (nf.vals_host >= lo_v) & (nf.vals_host <= hi_v)
    m = np.zeros(seg.n_pad, bool)
    m[nf.docs_host[sel]] = True
    return _host_mask_result(seg, m, boost)


def _range_field_result(seg: Segment, field: str, lo, hi, relation: str,
                        boost: float):
    """Relation mask for a RANGE field's stored intervals
    (``RangeFieldMapper`` queries): the query interval [lo, hi] vs EVERY
    stored [gte, lte] pair of a doc — a doc matches if ANY of its
    intervals satisfies the relation (the pairs append in lockstep at
    parse time, so the two columns align positionally)."""
    g = seg.numeric_fields.get(f"{field}._gte")
    l = seg.numeric_fields.get(f"{field}._lte")
    if g is None or l is None or g.vals_host.size == 0:
        return _const_result(seg, 0.0, False)
    glo, ghi = g.vals_host, l.vals_host
    lo_v = -1.8e308 if lo is None else float(lo)
    hi_v = 1.8e308 if hi is None else float(hi)
    if relation == "within":            # doc interval inside the query's
        sel = (glo >= lo_v) & (ghi <= hi_v)
    elif relation == "contains":        # doc interval covers the query's
        sel = (glo <= lo_v) & (ghi >= hi_v)
    else:                               # intersects
        sel = (glo <= hi_v) & (ghi >= lo_v)
    m = np.zeros(seg.n_pad, bool)
    m[g.docs_host[sel]] = True
    return _host_mask_result(seg, m, boost)


def _numeric_range_result(seg: Segment, field: str, lo, hi, boost,
                          include_lo=True, include_hi=True):
    """Range mask over a numeric field's (value, doc) pairs (K18). Bounds
    arrive in value space (float64) and are binary-searched into the
    segment's sorted-distinct-value RANK space on the host; the device
    compares int32 ranks — exact for gt/gte/lt/lte at any magnitude/span
    (see ``NumericFieldData``)."""
    nf = seg.numeric_fields.get(field)
    if nf is None or nf.uniq_vals is None or nf.uniq_vals.size == 0:
        return _const_result(seg, 0.0, False)
    uniq = nf.uniq_vals
    # NaN values sort to the tail of uniq and must never match a range
    n_comparable = int(uniq.shape[0] - np.isnan(uniq).sum())
    if n_comparable == 0:
        return _const_result(seg, 0.0, False)
    if lo is None:
        lo_rank = 0
    else:
        lo_rank = int(np.searchsorted(uniq, float(lo),
                                      "left" if include_lo else "right"))
    if hi is None:
        hi_rank = n_comparable - 1
    else:
        hi_rank = min(int(np.searchsorted(uniq, float(hi),
                                          "right" if include_hi else "left"))
                      - 1, n_comparable - 1)
    if lo_rank > hi_rank:
        return _const_result(seg, 0.0, False)
    kernel = get_range_mask_kernel(seg.n_pad)
    mask = kernel(nf.ranks_dev, nf.docs_dev, np.int32(lo_rank),
                  np.int32(hi_rank))
    return _where(mask, boost), mask


class RangeQuery(Query):
    """Range (reference: ``RangeQueryBuilder.java``). Constant-score."""

    def __init__(self, field: str, gte=None, gt=None, lte=None, lt=None,
                 boost: float = 1.0, date_format: Optional[str] = None,
                 relation: str = "intersects"):
        self.field = field
        self.gte, self.gt, self.lte, self.lt = gte, gt, lte, lt
        self.boost = boost
        self.date_format = date_format
        self.relation = relation
        if relation not in ("intersects", "contains", "within"):
            raise ParsingError(
                f"[range] unknown relation [{relation}]")

    def execute(self, ctx, seg):
        self.field = ctx.concrete_field(self.field)
        ft = ctx.field_type(self.field)
        if ft is None:
            return _const_result(seg, 0.0, False)
        if isinstance(ft, RuntimeFieldType):
            raise _not_ported(
                f"[range] on the runtime field [{self.field}]",
                "search/query_dsl.py:614 (utils/expressions.py)")
        if isinstance(ft, IpFieldType):
            lo = hi = None
            for v, inclusive in ((self.gte, True), (self.gt, False)):
                if v is not None:
                    cidr = IpFieldType.cidr_bounds(v)
                    if cidr is not None:
                        # gte block → from its start; gt block → past its
                        # END (the whole block is excluded)
                        lo = cidr[0] if inclusive else cidr[1] + 1
                    else:
                        lo = ft.parse_value(v)[1]
                        if not inclusive:
                            lo += 1
            for v, inclusive in ((self.lte, True), (self.lt, False)):
                if v is not None:
                    cidr = IpFieldType.cidr_bounds(v)
                    if cidr is not None:
                        # lte block → to its end; lt block → below its START
                        hi = cidr[1] if inclusive else cidr[0] - 1
                    else:
                        hi = ft.parse_value(v)[1]
                        if not inclusive:
                            hi -= 1
            return _exact_numeric_mask(seg, self.field, lo, hi, self.boost)
        if isinstance(ft, RangeFieldType):
            # gt/lte date bounds round UP through /unit date math
            lo = ft._point(self.gte if self.gte is not None else self.gt,
                           round_up=self.gte is None) \
                if (self.gte is not None or self.gt is not None) else None
            hi = ft._point(self.lte if self.lte is not None else self.lt,
                           round_up=self.lte is not None) \
                if (self.lte is not None or self.lt is not None) else None
            integral = ft.range_kind in ("integer_range", "long_range",
                                         "date_range", "ip_range")
            if self.gt is not None and lo is not None:
                lo = lo + 1 if integral else float(np.nextafter(lo, np.inf))
            if self.lt is not None and hi is not None:
                hi = hi - 1 if integral else float(np.nextafter(hi, -np.inf))
            return _range_field_result(seg, self.field, lo, hi,
                                       self.relation, self.boost)
        if isinstance(ft, (NumberFieldType, BooleanFieldType,
                           AggregateMetricDoubleFieldType,
                           RankFeatureFieldType)):
            # aggregate_metric_double's bare column carries its
            # default_metric; rank_feature is an ordinary positive float
            lo = self.gte if self.gte is not None else self.gt
            hi = self.lte if self.lte is not None else self.lt
            lo_v = float(lo) if lo is not None else None
            hi_v = float(hi) if hi is not None else None
            return _numeric_range_result(
                seg, self.field, lo_v, hi_v, self.boost,
                include_lo=self.gt is None, include_hi=self.lt is None)
        if isinstance(ft, DateFieldType):
            fmt = self.date_format or ft.format
            cached = getattr(self, "_date_bounds", {}).get(fmt) \
                if hasattr(self, "_date_bounds") else None
            if cached is not None:
                return _numeric_range_result(
                    seg, self.field, cached[0], cached[1], self.boost,
                    include_lo=self.gt is None, include_hi=self.lt is None)
            lo = self.gte if self.gte is not None else self.gt
            hi = self.lte if self.lte is not None else self.lt

            def _bound(v, round_up=False):
                # numeric bounds coerce through the format list (a bare
                # 4-digit number reads as a year, DateMathParser-style)
                if isinstance(v, (int, float)) and not isinstance(
                        v, bool) and 1000 <= v <= 9999 and \
                        float(v).is_integer():
                    v = str(int(v))
                return parse_date_millis(
                    v, fmt, round_up=round_up,
                    locale=getattr(ft, "locale", "en"))
            lo_v = _bound(lo, round_up=self.gte is None) \
                if lo is not None else None
            hi_v = _bound(hi, round_up=self.lte is not None) \
                if hi is not None else None
            # snapshot so 'now' resolves ONCE per request, not per
            # segment (keyed by format — indexes may map it differently)
            if not hasattr(self, "_date_bounds"):
                self._date_bounds = {}
            self._date_bounds[fmt] = (lo_v, hi_v)
            return _numeric_range_result(
                seg, self.field, lo_v, hi_v, self.boost,
                include_lo=self.gt is None, include_hi=self.lt is None)
        if isinstance(ft, KeywordFieldType):
            return self._keyword_range(seg)
        raise IllegalArgumentError(
            f"range query not supported on field [{self.field}] of type "
            f"[{ft.type_name}]")

    def _keyword_range(self, seg):
        """K18 over the keyword's ordinals converted to f32 with f32
        bounds, as the reference compares them."""
        f = seg.keyword_fields.get(self.field)
        if f is None:
            return _const_result(seg, 0.0, False)
        terms = f.ord_terms
        lo_ord = 0
        hi_ord = len(terms) - 1
        if self.gte is not None:
            lo_ord = bisect.bisect_left(terms, str(self.gte))
        elif self.gt is not None:
            lo_ord = bisect.bisect_right(terms, str(self.gt))
        if self.lte is not None:
            hi_ord = bisect.bisect_right(terms, str(self.lte)) - 1
        elif self.lt is not None:
            hi_ord = bisect.bisect_left(terms, str(self.lt)) - 1
        if lo_ord > hi_ord:
            return _const_result(seg, 0.0, False)
        kernel = get_range_mask_kernel(seg.n_pad)
        mask = kernel(f.dv_ords_dev.to(torch.float32), f.dv_docs_dev,
                      np.float32(lo_ord), np.float32(hi_ord))
        return _where(mask, self.boost), mask


class ExistsQuery(Query):
    def __init__(self, field: str, boost: float = 1.0):
        self.field = field
        self.boost = boost

    #: metadata fields every live doc carries (FieldNamesFieldMapper
    #: exempts them from _field_names; exists matches all docs)
    ALWAYS_PRESENT = {"_id", "_index", "_type", "_seq_no", "_version",
                      "_primary_term", "_doc_count"}

    def execute(self, ctx, seg):
        if self.field == "_source":
            raise QueryShardError(
                "the [_source] field may not be queried directly")
        if self.field in self.ALWAYS_PRESENT:
            return _const_result(seg, self.boost, True)
        field = ctx.concrete_field(self.field)
        if isinstance(ctx.field_type(field), ConstantKeywordFieldType):
            ck = ctx.field_type(field)
            return _const_result(seg, self.boost, ck.value is not None)
        # object field: exists iff any mapped subfield exists
        sub_fields = [n for n in getattr(ctx.mapper, "_fields", {})
                      if n.startswith(field + ".")]
        ft_self = ctx.field_type(field)
        if isinstance(ft_self, ObjectFieldType) and sub_fields:
            sub = [ExistsQuery(sf) for sf in sub_fields]
            return BoolQuery(should=sub, boost=self.boost).execute(ctx, seg)
        # geo_point: presence via the paired coordinate columns
        if seg.numeric_fields.get(f"{field}._lat") is not None:
            exists = np.zeros(seg.n_pad, bool)
            exists[seg.numeric_fields[f"{field}._lat"].docs_host] = True
            return _host_mask_result(seg, exists, self.boost)
        exists = np.zeros(seg.n_pad, bool)
        tf_ = seg.text_fields.get(field)
        if tf_ is not None:
            exists[: seg.n_docs] |= tf_.doc_len_host > 0
        kf = seg.keyword_fields.get(field)
        if kf is not None:
            exists[kf.dv_docs_host] = True
        nf = seg.numeric_fields.get(field)
        if nf is not None:
            exists[nf.docs_host] = True
        vf = seg.vector_fields.get(field)
        if vf is not None:
            exists[: seg.n_docs] |= vf.exists
        fn = seg.keyword_fields.get("_field_names")
        if fn is not None:               # source-only types (binary)
            st, ln, _ = fn.term_run(field)
            exists[fn.docs_host[st: st + ln]] = True
        return _host_mask_result(seg, exists, self.boost)


class IdsQuery(Query):
    def __init__(self, values: List[str], boost: float = 1.0):
        self.values = [str(v) for v in values]
        self.boost = boost

    def execute(self, ctx, seg):
        mask = np.zeros(seg.n_pad, bool)
        for uid in self.values:
            d = seg.find_doc(uid)
            if d is not None:
                mask[d] = True
        return _host_mask_result(seg, mask, self.boost)


class PrefixQuery(Query):
    """Prefix (reference: ``PrefixQueryBuilder.java``). Terms are sorted at
    segment build, so a prefix is a contiguous term-id range → its postings
    are one contiguous flat slice; one K17 run covers it."""

    def __init__(self, field: str, value: str, boost: float = 1.0):
        self.field = field
        self.value = str(value)
        self.boost = boost

    def execute(self, ctx, seg):
        self.field = ctx.concrete_field(self.field)
        ft = ctx.field_type(self.field)
        value = self.value
        f = seg.text_fields.get(self.field)
        if f is not None:
            # term_ids insertion order is sorted term order (segment build)
            terms_sorted = list(f.term_ids)
            offsets = f.offsets
            docs_dev = f.docs_dev
        else:
            kf = seg.keyword_fields.get(self.field)
            if kf is None:
                return _const_result(seg, 0.0, False)
            if isinstance(ft, KeywordFieldType):
                value = ft.parse_value(value) or value
            terms_sorted = kf.ord_terms
            offsets = kf.offsets
            docs_dev = kf.docs_dev
        lo = bisect.bisect_left(terms_sorted, value)
        hi = bisect.bisect_left(terms_sorted,
                                value[:-1] + chr(ord(value[-1]) + 1)
                                if value else chr(0x10FFFF))
        if lo >= hi:
            return _const_result(seg, 0.0, False)
        start = int(offsets[lo])
        length = int(offsets[hi] - offsets[lo])
        L = round_up_pow2(length)
        kernel = get_postings_match_kernel(seg.n_pad, L)
        matched = kernel(docs_dev, np.asarray([start], np.int32),
                         np.asarray([length], np.int32))
        mask = matched > 0
        return _where(mask, self.boost), mask


class BoolQuery(Query):
    """Boolean composition (reference: ``BoolQueryBuilder.java``): must and
    should contribute scores; filter and must_not only constrain the mask.
    The clauses run in the reference's order (must, filter, should,
    must_not), so the score sums are the same bits."""

    def __init__(self, must=None, filter=None, should=None, must_not=None,
                 minimum_should_match=None, boost: float = 1.0):
        self.must: List[Query] = must or []
        self.filter: List[Query] = filter or []
        self.should: List[Query] = should or []
        self.must_not: List[Query] = must_not or []
        self.msm = minimum_should_match
        self.boost = boost

    def execute(self, ctx, seg):
        n, dev = seg.n_pad, seg.device
        scores = torch.zeros(n, dtype=torch.float32, device=dev)
        mask = None
        for q in self.must:
            s, m = q.execute(ctx, seg)
            scores = scores + s
            mask = m if mask is None else (mask & m)
        for q in self.filter:
            _, m = q.execute(ctx, seg)
            mask = m if mask is None else (mask & m)
        should_count = None
        if self.should:
            should_count = torch.zeros(n, dtype=torch.int32, device=dev)
            for q in self.should:
                s, m = q.execute(ctx, seg)
                scores = scores + _where(m, s)
                should_count = should_count + m.to(torch.int32)
        if self.msm is not None:
            required = resolve_minimum_should_match(self.msm, len(self.should))
        else:
            required = 0
        if not self.must and not self.filter:
            # no required clauses → at least one should must match, even with
            # an explicit minimum_should_match of 0 (Lucene Boolean2Scorer)
            required = max(required, 1)
        if should_count is not None and required > 0:
            sm = should_count >= required
            mask = sm if mask is None else (mask & sm)
        elif mask is None:
            # only must_not (or empty): start from all docs
            mask = torch.ones(n, dtype=torch.bool, device=dev)
        for q in self.must_not:
            _, m = q.execute(ctx, seg)
            mask = mask & ~m
        scores = _where(mask, scores) * _f32(self.boost)
        return scores, mask


class ConstantScoreQuery(Query):
    def __init__(self, inner: Query, boost: float = 1.0):
        self.inner = inner
        self.boost = boost

    def execute(self, ctx, seg):
        _, mask = self.inner.execute(ctx, seg)
        return _where(mask, self.boost), mask


class DisMaxQuery(Query):
    def __init__(self, queries: List[Query], tie_breaker: float = 0.0,
                 boost: float = 1.0):
        self.queries = queries
        self.tie_breaker = float(tie_breaker)
        self.boost = boost

    def execute(self, ctx, seg):
        n, dev = seg.n_pad, seg.device
        best = torch.zeros(n, dtype=torch.float32, device=dev)
        total = torch.zeros(n, dtype=torch.float32, device=dev)
        mask = torch.zeros(n, dtype=torch.bool, device=dev)
        for q in self.queries:
            s, m = q.execute(ctx, seg)
            s = _where(m, s)
            best = torch.maximum(best, s)
            total = total + s
            mask = mask | m
        scores = best + _f32(self.tie_breaker) * (total - best)
        return scores * _f32(self.boost), mask


class BoostingQuery(Query):
    def __init__(self, positive: Query, negative: Query,
                 negative_boost: float, boost: float = 1.0):
        self.positive = positive
        self.negative = negative
        self.negative_boost = float(negative_boost)
        self.boost = boost

    def execute(self, ctx, seg):
        s, m = self.positive.execute(ctx, seg)
        _, nm = self.negative.execute(ctx, seg)
        scores = torch.where(nm, s * _f32(self.negative_boost), s)
        return scores * _f32(self.boost), m


# ---------------------------------------------------------------------------
# Parsing (reference: each QueryBuilder's fromXContent)
# ---------------------------------------------------------------------------


def parse_query(spec: dict) -> Query:
    if not isinstance(spec, dict) or len(spec) != 1:
        raise ParsingError(
            "query malformed, expected a single top-level query clause")
    (qtype, body), = spec.items()
    parser = _PARSERS.get(qtype)
    if parser is not None:
        return parser(body)
    where = _NOT_PORTED.get(qtype)
    if where is not None:
        raise _not_ported(f"query [{qtype}]", where)
    hint = difflib.get_close_matches(
        qtype, sorted({*_PARSERS, *_NOT_PORTED}), n=1)
    suffix = f" did you mean [{hint[0]}]?" if hint else ""
    raise ParsingError(f"unknown query [{qtype}]{suffix}")


def _field_body(body: dict, value_key: str):
    """Handle the `{field: {value_key: v, ...opts}}` and `{field: v}` forms."""
    if not isinstance(body, dict) or len(body) != 1:
        raise ParsingError("expected a single field name")
    (field, spec), = body.items()
    if isinstance(spec, dict):
        opts = dict(spec)
        value = opts.pop(value_key, None)
        if value is None and value_key == "value":
            value = opts.pop("query", None)
        return field, value, opts
    return field, spec, {}


def _parse_match(body):
    field, value, opts = _field_body(body, "query")
    return MatchQuery(field, value, opts.get("operator", "or"),
                      opts.get("minimum_should_match"),
                      float(opts.get("boost", 1.0)), opts.get("analyzer"))


def _parse_term(body):
    field, value, opts = _field_body(body, "value")
    return TermQuery(field, value, float(opts.get("boost", 1.0)),
                     case_insensitive=bool(opts.get("case_insensitive",
                                                    False)))


def _parse_terms(body):
    opts = dict(body)
    boost = float(opts.pop("boost", 1.0))
    if len(opts) != 1:
        raise ParsingError("[terms] query requires exactly one field")
    (field, values), = opts.items()
    if not isinstance(values, list):
        raise ParsingError("[terms] query requires an array of values")
    # count limits are enforced settings-aware at the request layer
    return TermsQuery(field, values, boost)


def _parse_range(body):
    if len(body) != 1:
        raise ParsingError("[range] query requires exactly one field")
    (field, spec), = body.items()
    opts = dict(spec)
    # legacy from/to support
    if "from" in opts:
        opts.setdefault("gte" if opts.pop("include_lower", True) else "gt",
                        opts.pop("from"))
    if "to" in opts:
        opts.setdefault("lte" if opts.pop("include_upper", True) else "lt",
                        opts.pop("to"))
    return RangeQuery(field, opts.get("gte"), opts.get("gt"), opts.get("lte"),
                      opts.get("lt"), float(opts.get("boost", 1.0)),
                      opts.get("format"),
                      relation=opts.get("relation", "intersects"))


def _parse_bool(body):
    def clause(name):
        c = body.get(name)
        if c is None:
            return []
        if isinstance(c, dict):
            c = [c]
        return [parse_query(q) for q in c]

    return BoolQuery(clause("must"), clause("filter"), clause("should"),
                     clause("must_not"), body.get("minimum_should_match"),
                     float(body.get("boost", 1.0)))


def _parse_dis_max(body):
    return DisMaxQuery([parse_query(q) for q in body.get("queries", [])],
                       float(body.get("tie_breaker", 0.0)),
                       float(body.get("boost", 1.0)))


def _parse_constant_score(body):
    return ConstantScoreQuery(parse_query(body["filter"]),
                              float(body.get("boost", 1.0)))


def _parse_exists(body):
    return ExistsQuery(body["field"], float(body.get("boost", 1.0)))


def _parse_ids(body):
    return IdsQuery(body.get("values", []), float(body.get("boost", 1.0)))


def _parse_prefix(body):
    field, value, opts = _field_body(body, "value")
    return PrefixQuery(field, value, float(opts.get("boost", 1.0)))


def _parse_boosting(body):
    return BoostingQuery(parse_query(body["positive"]),
                         parse_query(body["negative"]),
                         float(body.get("negative_boost", 0.5)),
                         float(body.get("boost", 1.0)))


def _parse_match_all(body):
    return MatchAllQuery(float((body or {}).get("boost", 1.0)))


def _parse_match_none(body):
    return MatchNoneQuery()


_PARSERS = {
    "match_all": _parse_match_all,
    "match_none": _parse_match_none,
    "match": _parse_match,
    "term": _parse_term,
    "terms": _parse_terms,
    "range": _parse_range,
    "bool": _parse_bool,
    "dis_max": _parse_dis_max,
    "constant_score": _parse_constant_score,
    "exists": _parse_exists,
    "ids": _parse_ids,
    "prefix": _parse_prefix,
    "boosting": _parse_boosting,
}

#: the reference's other query types, each with where it parses, until the
#: port has them (ROADMAP A6b)
_NOT_PORTED = {
    "match_phrase": "search/query_dsl.py:1405",
    "multi_match": "search/query_dsl.py:1870",
    "wildcard": "search/query_dsl.py:1486",
    "regexp": "search/query_dsl.py:1495",
    "fuzzy": "search/query_dsl.py:1505",
    "nested": "search/query_dsl.py:1829",
    "match_bool_prefix": "search/query_dsl.py:1799",
    "query_string": "search/query_dsl.py:1809",
    "simple_query_string": "search/query_dsl.py:1820",
    "script_score": "search/query_dsl.py:1925",
    "function_score": "search/query_dsl.py:1936",
    "has_child": "search/query_dsl.py:2259",
    "has_parent": "search/query_dsl.py:2271",
    "parent_id": "search/query_dsl.py:2281",
    "percolate": "search/query_dsl.py:2288",
    "intervals": "search/positional.py:208",
    "more_like_this": "search/positional.py:529",
    "distance_feature": "search/positional.py:636",
    **{kind: "search/positional.py:653"
       for kind in ("span_term", "span_near", "span_or", "span_not",
                    "span_first", "span_multi", "span_containing",
                    "span_within", "field_masking_span")},
    "geo_bounding_box": "search/geo_queries.py:324",
    "geo_distance": "search/geo_queries.py:367",
    "geo_shape": "search/geo_queries.py:384",
    "rank_feature": "search/geo_queries.py:411",
    "pinned": "search/geo_queries.py:437",
}
