"""The port's aggregations (``search/aggregations.py``, ``aggs_extra``,
``aggs_analytics``, ``aggs_geo``) through ``ShardSearcher.search`` against
the reference's, on the CPU.

The same documents go through each side's ``MapperService`` and
``SegmentBuilder``: the three segments of ``torch_cases.build_segments``
(deletes, nested children, dates, ranges, ips) and two small segments with
a geo_point, a join field and a text field. Each body runs through both
searchers, the reference with no providers and the port with
``device="cpu"``, on the host routes and again with ``DEVICE_MIN_PAIRS``
at 1 in both packages, which sends every terms, histogram, fixed-interval
date_histogram and HLL cardinality through the device routes (K12–K14's
plain versions here). The ``aggregations`` trees must be equal, floats
compared with ``==`` (NaN equal to NaN): all arithmetic on both sides is
host numpy, and the device results are integers.
"""

import math

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common import breakers as ref_breakers
from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.ops import aggs as ref_ops_aggs
from elasticsearch_tpu.search.shard_search import \
    ShardSearcher as RefSearcher
from elasticsearch_tpu_torch.common import breakers
from elasticsearch_tpu_torch.common.errors import (ElasticsearchError,
                                                   ParsingError)
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.ops import aggs as ops_aggs
from elasticsearch_tpu_torch.search import aggregations
from elasticsearch_tpu_torch.search.shard_search import ShardSearcher
from torch_cases import build_segments

M1 = {"match": {"body": "w1 w2 hello"}}
DH_WEEK = {"date_histogram": {"field": "ts", "fixed_interval": "7d"}}

#: name -> body over the main segments (torch_cases.SEGMENT_MAPPING)
BODIES = {
    # metrics
    "avg": {"a": {"avg": {"field": "price"}}},
    "avg_missing": {"a": {"avg": {"field": "price", "missing": 2.5}}},
    "sum": {"s": {"sum": {"field": "qty"}}},
    "min_date": {"m": {"min": {"field": "ts"}}},
    "max": {"m": {"max": {"field": "price"}}},
    "value_count": {"v": {"value_count": {"field": "tag"}}},
    "stats": {"s": {"stats": {"field": "price"}}},
    "extended_stats": {"s": {"extended_stats": {"field": "qty",
                                                "sigma": 3}}},
    "cardinality_exact": {"c": {"cardinality": {"field": "tag"}}},
    "cardinality_hll": {"c": {"cardinality": {
        "field": "price", "precision_threshold": 1}}},
    "cardinality_hll_keyword": {"c": {"cardinality": {
        "field": "tags", "precision_threshold": 2}}},
    "cardinality_missing": {"c": {"cardinality": {"field": "tag",
                                                  "missing": "none"}}},
    "percentiles": {"p": {"percentiles": {"field": "price",
                                          "percents": [50, 95, 99]}}},
    "percentiles_keyed_off": {"p": {"percentiles": {
        "field": "qty", "keyed": False}}},
    "percentile_ranks": {"p": {"percentile_ranks": {"field": "price",
                                                    "values": [2, 5.5]}}},
    "weighted_avg": {"w": {"weighted_avg": {"value": {"field": "price"},
                                            "weight": {"field": "qty"}}}},
    "mad": {"m": {"median_absolute_deviation": {"field": "price"}}},
    "top_hits": {"t": {"terms": {"field": "tag", "size": 3},
                       "aggs": {"h": {"top_hits": {"size": 2}}}}},
    # buckets
    "terms": {"t": {"terms": {"field": "tag"}}},
    "terms_sub": {"t": {"terms": {"field": "tag", "size": 3},
                        "aggs": {"p": {"avg": {"field": "price"}}}}},
    "terms_key_order": {"t": {"terms": {"field": "tag",
                                        "order": {"_key": "asc"}}}},
    "terms_min_doc_count_0": {"t": {"terms": {"field": "tag",
                                              "min_doc_count": 0}}},
    "terms_include_exclude": {"t": {"terms": {
        "field": "tag", "include": ["alpha", "beta", "gamma"],
        "exclude": ["beta"]}}},
    "terms_partition": {"t": {"terms": {
        "field": "tags", "include": {"partition": 1,
                                     "num_partitions": 3}}}},
    "terms_partition_sub": {"t": {"terms": {
        "field": "tag", "include": {"partition": 0, "num_partitions": 2}},
        "aggs": {"m": {"max": {"field": "qty"}}}}},
    "terms_numeric_partition": {"t": {"terms": {
        "field": "qty", "include": {"partition": 2, "num_partitions": 4}}}},
    "terms_regex": {"t": {"terms": {"field": "tag", "include": "a.*"}}},
    "terms_numeric_sub": {"t": {"terms": {"field": "qty", "size": 4},
                                "aggs": {"s": {"sum": {"field": "price"}}}}},
    "terms_multi_valued": {"t": {"terms": {"field": "tags"}}},
    "terms_missing": {"t": {"terms": {"field": "tag", "missing": "none"},
                            "aggs": {"c": {"value_count": {
                                "field": "qty"}}}}},
    "terms_bool": {"t": {"terms": {"field": "flag"}}},
    "terms_alias": {"t": {"terms": {"field": "alias_tag", "size": 2}}},
    "terms_percentiles": {"t": {"terms": {"field": "tag", "size": 3},
                                "aggs": {"p": {"percentiles": {
                                    "field": "price",
                                    "percents": [50, 95, 99]}}}}},
    "histogram": {"h": {"histogram": {"field": "price", "interval": 2.5}}},
    "histogram_bounds": {"h": {"histogram": {
        "field": "price", "interval": 3, "min_doc_count": 0,
        "extended_bounds": {"min": -6, "max": 15}}}},
    "histogram_sub": {"h": {"histogram": {"field": "qty", "interval": 10},
                            "aggs": {"m": {"max": {"field": "price"}}}}},
    "histogram_offset_hard": {"h": {"histogram": {
        "field": "price", "interval": 2, "offset": 0.5,
        "hard_bounds": {"min": 1, "max": 8}}}},
    "histogram_range_field": {"h": {"histogram": {"field": "span",
                                                  "interval": 5}}},
    "date_histogram_fixed": {"d": DH_WEEK},
    "date_histogram_calendar": {"d": {"date_histogram": {
        "field": "ts", "calendar_interval": "month",
        "min_doc_count": 0}}},
    "date_histogram_tz": {"d": {"date_histogram": {
        "field": "ts", "fixed_interval": "1d", "time_zone": "-05:00"}}},
    "date_histogram_sub": {"d": {**DH_WEEK, "aggs": {
        "s": {"sum": {"field": "price"}}}}},
    "range": {"r": {"range": {"field": "price", "ranges": [
        {"to": 2}, {"from": 2, "to": 6.5}, {"from": 6.5}]}}},
    "range_keyed_sub": {"r": {"range": {"field": "qty", "keyed": True,
                                        "ranges": [{"to": 10},
                                                   {"from": 10}]},
                              "aggs": {"a": {"avg": {"field": "price"}}}}},
    "filter": {"f": {"filter": {"term": {"tag": "alpha"}},
                     "aggs": {"h": {"histogram": {"field": "price",
                                                  "interval": 5}}}}},
    "filters_keyed": {"f": {"filters": {"filters": {
        "a": {"term": {"tag": "alpha"}},
        "r": {"range": {"price": {"gte": 3}}}}}}},
    "filters_list": {"f": {"filters": {"filters": [
        {"match": {"body": "hello"}}, {"terms": {"tag": ["beta", "eps"]}}]},
        "aggs": {"c": {"cardinality": {"field": "tags"}}}}},
    "missing": {"m": {"missing": {"field": "price"}}},
    "global": {"g": {"global": {}, "aggs": {"a": {"avg": {
        "field": "price"}}}}},
    # pipelines
    "avg_bucket": {"d": {**DH_WEEK, "aggs": {"s": {"sum": {
        "field": "price"}}}}, "ab": {"avg_bucket": {"buckets_path": "d>s"}}},
    "sum_bucket": {"t": {"terms": {"field": "tag"}},
                   "sb": {"sum_bucket": {"buckets_path": "t>_count"}}},
    "min_max_bucket": {"d": {**DH_WEEK, "aggs": {"m": {"max": {
        "field": "qty"}}}},
        "lo": {"min_bucket": {"buckets_path": "d>m"}},
        "hi": {"max_bucket": {"buckets_path": "d>m"}}},
    "stats_bucket": {"h": {"histogram": {"field": "qty", "interval": 10},
                           "aggs": {"a": {"avg": {"field": "price"}}}},
                     "st": {"stats_bucket": {"buckets_path": "h>a"}}},
    "cumulative_sum": {"d": {**DH_WEEK, "aggs": {
        "s": {"sum": {"field": "price"}},
        "c": {"cumulative_sum": {"buckets_path": "s"}}}}},
    "derivative": {"d": {**DH_WEEK, "aggs": {
        "s": {"sum": {"field": "qty"}},
        "dv": {"derivative": {"buckets_path": "s"}}}}},
    "bucket_script": {"h": {"histogram": {"field": "qty", "interval": 10},
                            "aggs": {
        "s": {"sum": {"field": "price"}},
        "r": {"bucket_script": {"buckets_path": {"x": "s", "n": "_count"},
                                "script": "params.x / params.n"}}}}},
    "bucket_selector": {"t": {"terms": {"field": "tag"}, "aggs": {
        "s": {"sum": {"field": "price"}},
        "keep": {"bucket_selector": {"buckets_path": {"x": "s"},
                                     "script": "params.x > 20"}}}}},
    "bucket_sort": {"t": {"terms": {"field": "tag"}, "aggs": {
        "s": {"sum": {"field": "price"}},
        "o": {"bucket_sort": {"sort": [{"s": {"order": "asc"}}],
                              "size": 3}}}}},
    "moving_fn": {"d": {**DH_WEEK, "aggs": {
        "s": {"sum": {"field": "price"}},
        "mv": {"moving_fn": {"buckets_path": "s", "window": 3,
                             "script": "MovingFunctions.unweightedAvg("
                                       "values)"}}}}},
    "serial_diff": {"d": {**DH_WEEK, "aggs": {
        "s": {"sum": {"field": "price"}},
        "sd": {"serial_diff": {"buckets_path": "s", "lag": 2}}}}},
    # aggs_extra
    "date_range": {"r": {"date_range": {"field": "ts", "ranges": [
        {"to": "2020-05-01"}, {"from": "2020-05-01"}]}}},
    "ip_range": {"r": {"ip_range": {"field": "addr", "ranges": [
        {"to": "10.0.1.0"}, {"from": "10.0.1.0"}]}}},
    "composite": {"c": {"composite": {"size": 5, "sources": [
        {"t": {"terms": {"field": "tag"}}},
        {"h": {"histogram": {"field": "price", "interval": 5}}}]}}},
    "composite_after": {"c": {"composite": {
        "size": 4, "after": {"t": "beta"},
        "sources": [{"t": {"terms": {"field": "tag"}}}]},
        "aggs": {"m": {"min": {"field": "qty"}}}}},
    "significant_terms": {"s": {"significant_terms": {"field": "tag",
                                                      "min_doc_count": 1}}},
    "rare_terms": {"r": {"rare_terms": {"field": "tag",
                                        "max_doc_count": 5}}},
    "sampler": {"s": {"sampler": {"shard_size": 20}, "aggs": {
        "t": {"terms": {"field": "tag"}}}}},
    "nested": {"n": {"nested": {"path": "comments"}, "aggs": {
        "w": {"terms": {"field": "comments.who"}, "aggs": {
            "r": {"reverse_nested": {}, "aggs": {
                "t": {"terms": {"field": "tag"}}}}}}}}},
    "auto_date_histogram": {"a": {"auto_date_histogram": {
        "field": "ts", "buckets": 5}}},
    "variable_width_histogram": {"v": {"variable_width_histogram": {
        "field": "price", "buckets": 4}}},
    "adjacency_matrix": {"m": {"adjacency_matrix": {"filters": {
        "a": {"term": {"tag": "alpha"}}, "b": {"term": {"flag": True}},
        "c": {"range": {"qty": {"lt": 10}}}}}}},
    "significant_text": {"s": {"significant_text": {"field": "body"}}},
    # aggs_analytics
    "boxplot": {"b": {"boxplot": {"field": "price"}}},
    "top_metrics": {"t": {"top_metrics": {"metrics": {"field": "price"},
                                          "sort": {"qty": "desc"}}}},
    "string_stats": {"s": {"string_stats": {"field": "tag"}}},
    "t_test": {"t": {"t_test": {"a": {"field": "price"},
                                "b": {"field": "qty"},
                                "type": "heteroscedastic"}}},
    "rate": {"d": {"date_histogram": {"field": "ts",
                                      "calendar_interval": "month"},
                   "aggs": {"r": {"rate": {"field": "price",
                                           "unit": "day"}}}}},
    "multi_terms": {"m": {"multi_terms": {"terms": [
        {"field": "tag"}, {"field": "flag"}]}}},
}

#: queries the bodies run under: the whole shard, and a scored match
QUERIES = {"all": None, "match": M1}

EXTRA_MAPPING = {"properties": {
    "loc": {"type": "geo_point"},
    "city": {"type": "keyword"},
    "pop": {"type": "long"},
    "date": {"type": "date"},
    "text": {"type": "text"},
    "rel": {"type": "join", "relations": {"question": "answer"}},
    "pop_alias": {"type": "alias", "path": "pop"},
}}

#: name -> body over the geo and join segments
EXTRA_BODIES = {
    "geohash_grid": {"g": {"geohash_grid": {"field": "loc",
                                            "precision": 2},
                           "aggs": {"p": {"sum": {"field": "pop"}}}}},
    "geotile_grid": {"g": {"geotile_grid": {"field": "loc",
                                            "precision": 4}}},
    "geo_distance": {"d": {"geo_distance": {
        "field": "loc", "origin": "35.7796, -78.6382", "unit": "km",
        "ranges": [{"to": 1000}, {"from": 1000, "to": 5000},
                   {"from": 5000}]}}},
    "geo_bounds": {"b": {"geo_bounds": {"field": "loc"}}},
    "geo_centroid": {"c": {"geo_centroid": {"field": "loc"}}},
    "children": {"q": {"terms": {"field": "city"}, "aggs": {
        "a": {"children": {"type": "answer"}, "aggs": {
            "p": {"avg": {"field": "pop"}}}}}}},
    "parent": {"p": {"parent": {"type": "answer"}, "aggs": {
        "c": {"terms": {"field": "city"}}}}},
    "cardinality_hll_geo_side": {"c": {"cardinality": {
        "field": "pop", "precision_threshold": 1}}},
    "histogram_alias": {"h": {"histogram": {"field": "pop_alias",
                                            "interval": 20000}}},
    "date_histogram_fixed_sub": {"d": {"date_histogram": {
        "field": "date", "fixed_interval": "30d"}, "aggs": {
            "g": {"geo_centroid": {"field": "loc"}}}}},
}


def _extra_docs(seed):
    rng = np.random.RandomState(seed)
    cities = ["nyc", "la", "chi", "ams", "sea"]
    docs = []
    for i in range(60):
        src = {"city": cities[int(rng.randint(5))],
               "pop": int(rng.randint(1000, 90000)),
               "date": f"2021-0{rng.randint(1, 7)}-1{rng.randint(0, 10)}",
               "text": " ".join(rng.choice(["good", "bad", "stuff",
                                            "things", "fine"], 3))}
        if rng.rand() < 0.85:
            src["loc"] = {"lat": float(rng.uniform(-60, 70)).__round__(4),
                          "lon": float(rng.uniform(-170, 170)).__round__(4)}
        if i % 4 == 0:
            src["rel"] = "question"
        else:
            src["rel"] = {"name": "answer", "parent": f"x{i - i % 4}"}
        docs.append((f"x{i}", src))
    return docs


def _extra_segments(mapping_cls, builder_cls, **build_kw):
    svc = mapping_cls(EXTRA_MAPPING)
    segs = []
    docs = _extra_docs(5)
    for si, part in enumerate((docs[:32], docs[32:])):
        b = builder_cls(f"_x{si}")
        for seq, (uid, src) in enumerate(part):
            b.add(svc.parse_document(uid, src), seq_no=si * 100 + seq)
        segs.append(b.build(**build_kw))
    return svc, segs


@pytest.fixture(scope="module")
def searchers():
    rsvc, rsegs = build_segments(RefMapper, RefBuilder, 31)
    psvc, psegs = build_segments(MapperService, SegmentBuilder, 31,
                                 device="cpu")
    return RefSearcher(rsegs, rsvc), ShardSearcher(psegs, psvc,
                                                   device="cpu")


@pytest.fixture(scope="module")
def extra_searchers():
    rsvc, rsegs = _extra_segments(RefMapper, RefBuilder)
    psvc, psegs = _extra_segments(MapperService, SegmentBuilder,
                                  device="cpu")
    return RefSearcher(rsegs, rsvc), ShardSearcher(psegs, psvc,
                                                   device="cpu")


def _same(a, b, path="aggregations"):
    """Equal trees: the same keys in the same order, lists item by item,
    floats by ``==`` with NaN equal to NaN."""
    if isinstance(a, dict):
        assert isinstance(b, dict), f"{path}: {type(b)} is not a dict"
        assert list(a) == list(b), f"{path}: keys {list(a)} != {list(b)}"
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), \
            f"{path}: {a!r} != {b!r}"
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), f"{path}: {b!r}"
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


@pytest.fixture(params=["host", "device"])
def route(request, monkeypatch):
    """``device``: every device route taken at these sizes, in both
    packages."""
    if request.param == "device":
        monkeypatch.setattr(ref_ops_aggs, "DEVICE_MIN_PAIRS", 1)
        monkeypatch.setattr(ops_aggs, "DEVICE_MIN_PAIRS", 1)
    return request.param


def _both(ref, port, body):
    return ref.search(body).aggregations, port.search(body).aggregations


#: bodies whose device route fails in the reference (it keys its device
#: caches by an alias's own name: KeyError); the port reads the concrete
#: field, so its device route is held to the reference's host route
REF_DEVICE_FAULTS = {"terms_alias", "histogram_alias"}


def _check(ref, port, body, name, route, monkeypatch):
    if route == "device" and name in REF_DEVICE_FAULTS:
        with pytest.raises(KeyError):
            ref.search(body)
        monkeypatch.setattr(ref_ops_aggs, "DEVICE_MIN_PAIRS", 1 << 16)
    _same(*_both(ref, port, body))


@pytest.mark.parametrize("query", sorted(QUERIES))
@pytest.mark.parametrize("name", sorted(BODIES))
def test_aggregations_match_the_reference(searchers, route, name, query,
                                          monkeypatch):
    body = {"size": 0, "aggs": BODIES[name]}
    if QUERIES[query] is not None:
        body["query"] = QUERIES[query]
    _check(*searchers, body, name, route, monkeypatch)


@pytest.mark.parametrize("name", sorted(EXTRA_BODIES))
def test_geo_and_join_aggregations_match_the_reference(extra_searchers,
                                                       route, name,
                                                       monkeypatch):
    body = {"size": 0, "aggs": EXTRA_BODIES[name],
            "query": {"range": {"pop": {"gte": 5000}}}}
    _check(*extra_searchers, body, name, route, monkeypatch)


def test_every_registered_type_has_a_body():
    kinds = set()

    def walk(tree):
        for spec in tree.values():
            kinds.update(k for k in spec if k not in ("aggs", "aggregations"))
            walk(spec.get("aggs", {}))
    for tree in list(BODIES.values()) + list(EXTRA_BODIES.values()):
        walk(tree)
    assert set(aggregations._AGG_PARSERS) - kinds == {"scripted_metric"}


@pytest.mark.parametrize("body", [
    {"size": 5, "query": M1, "aggs": {"t": {"terms": {"field": "tag"}}}},
    {"size": 3, "from": 2, "aggregations": {"h": {"histogram": {
        "field": "price", "interval": 4}}}},
    {"min_score": 1.0, "query": M1, "aggs": {"c": {"cardinality": {
        "field": "tag"}}}},
])
def test_hits_and_aggregations_together(searchers, route, body):
    ref, port = searchers
    want, got = ref.search(body), port.search(body)
    _same(want.aggregations, got.aggregations)
    assert [h.doc_id for h in want.hits] == [h.doc_id for h in got.hits]
    assert want.total == got.total


INVALID = {
    "unknown_type": {"x": {"no_such_agg": {}}},
    "two_types": {"x": {"avg": {"field": "price"},
                        "max": {"field": "price"}}},
    "metric_with_subs": {"x": {"avg": {"field": "price"}, "aggs": {
        "y": {"max": {"field": "price"}}}}},
    "terms_no_field": {"x": {"terms": {}}},
    "cardinality_negative": {"x": {"cardinality": {
        "field": "tag", "precision_threshold": -1}}},
    "filters_empty": {"x": {"filters": {"filters": {}}}},
    "composite_under_terms": {"x": {"terms": {"field": "tag"}, "aggs": {
        "c": {"composite": {"sources": [
            {"t": {"terms": {"field": "tag"}}}]}}}}},
    "not_an_object": {"x": 3},
    "regex_on_numbers": {"x": {"terms": {"field": "qty",
                                         "include": "1.*"}}},
    "pipeline_with_subs": {"x": {"avg_bucket": {"buckets_path": "t>_count"},
                                 "aggs": {"y": {"max": {
                                     "field": "price"}}}}},
}


@pytest.mark.parametrize("name", sorted(INVALID))
def test_invalid_bodies_raise_the_same_error(searchers, name):
    ref, port = searchers
    body = {"size": 0, "aggs": INVALID[name]}
    with pytest.raises(Exception) as want:
        ref.search(body)
    with pytest.raises(Exception) as got:
        port.search(body)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_request_breaker_trips_on_both_sides(searchers, monkeypatch):
    ref, port = searchers
    monkeypatch.setattr(ref_breakers.DEFAULT.breaker("request"), "limit",
                        600)
    monkeypatch.setattr(breakers.DEFAULT.breaker("request"), "limit", 600)
    body = {"size": 0, "aggs": {"t": {"terms": {"field": "tag"}, "aggs": {
        "p": {"percentiles": {"field": "price"}}}}}}
    with pytest.raises(Exception) as want:
        ref.search(body)
    with pytest.raises(Exception) as got:
        port.search(body)
    assert type(got.value).__name__ == type(want.value).__name__ == \
        "CircuitBreakingError"
    assert str(got.value) == str(want.value)
    assert breakers.DEFAULT.breaker("request").used == 0
    # a small tree still fits
    small = {"size": 0, "aggs": {"m": {"max": {"field": "price"}}}}
    _same(*_both(ref, port, small))


def test_scripted_metric_is_refused_and_names_a8(searchers):
    _, port = searchers
    body = {"size": 0, "aggs": {"s": {"scripted_metric": {
        "init_script": "state.x = []",
        "map_script": "state.x.add(1)",
        "combine_script": "return state.x.size()",
        "reduce_script": "return states"}}}}
    with pytest.raises(ParsingError, match=r"\[scripted_metric\].*ROADMAP "
                                           r"A8"):
        port.search(body)
    with pytest.raises(ElasticsearchError, match=r"map_script"):
        port.search({"size": 0, "aggs": {"s": {"scripted_metric": {}}}})


def test_size_zero_with_aggs_runs_no_top_k(searchers, monkeypatch):
    from elasticsearch_tpu_torch.search import shard_search
    _, port = searchers
    calls = []
    real = shard_search.get_topk_kernel
    monkeypatch.setattr(shard_search, "get_topk_kernel",
                        lambda *a: calls.append(a) or real(*a))
    res = port.search({"size": 0, "query": M1,
                       "aggs": {"t": {"terms": {"field": "tag"}}}})
    assert calls == [] and res.hits == [] and res.aggregations["t"]
    port.search({"size": 1, "query": M1,
                 "aggs": {"t": {"terms": {"field": "tag"}}}})
    assert len(calls) == len(port.segments)


class _Moves:
    """Records host copies of a query's mask and uploads of host masks."""

    def __init__(self, monkeypatch):
        self.d2h, self.h2d = [], []
        real_copy = aggregations._query_mask_to_host
        real_up = ops_aggs.device_mask

        def copy(mask):
            self.d2h.append(mask.shape[0])
            return real_copy(mask)

        def up(seg, mask, device=None):
            self.h2d.append(mask.shape[0])
            return real_up(seg, mask, device)
        monkeypatch.setattr(aggregations, "_query_mask_to_host", copy)
        monkeypatch.setattr(ops_aggs, "device_mask", up)


@pytest.mark.parametrize("aggs", [
    {"t": {"terms": {"field": "tag"}}},
    {"h": {"histogram": {"field": "price", "interval": 2}}},
    {"d": DH_WEEK},
    {"c": {"cardinality": {"field": "price", "precision_threshold": 1}}},
    {"t": {"terms": {"field": "tags"}},
     "h": {"histogram": {"field": "qty", "interval": 5}},
     "c": {"cardinality": {"field": "tag", "precision_threshold": 2}}},
], ids=["terms", "histogram", "date_histogram", "cardinality", "three"])
def test_device_routes_move_no_mask(searchers, monkeypatch, aggs):
    """A no-sub terms, histogram, fixed date_histogram and HLL cardinality
    read the query's tensor where it lies: no host copy, no upload (the
    two larger segments, where every field takes the device route)."""
    ref, port = searchers
    ref = RefSearcher(ref.segments[::2], ref.mapper)
    port = ShardSearcher(port.segments[::2], port.mapper, device="cpu")
    monkeypatch.setattr(ops_aggs, "DEVICE_MIN_PAIRS", 1)
    monkeypatch.setattr(ref_ops_aggs, "DEVICE_MIN_PAIRS", 1)
    moves = _Moves(monkeypatch)
    aggregations.mask_transfers(reset=True)
    body = {"size": 0, "query": M1, "aggs": aggs}
    got = port.search(body).aggregations
    assert moves.d2h == [] and moves.h2d == []
    assert aggregations.mask_transfers() == dict(d2h=0, d2h_bytes=0,
                                                 h2d=0, h2d_bytes=0)
    _same(ref.search(body).aggregations, got)


def test_subs_copy_the_query_mask_once_a_segment(searchers, monkeypatch):
    """terms with a percentiles sub (config #3's tree) and a histogram
    with a sub beside it: one host copy of each segment's mask for the
    whole request, no upload; a sub-bucket's terms goes up through
    ``ops.aggs.device_mask``."""
    ref, port = searchers
    monkeypatch.setattr(ops_aggs, "DEVICE_MIN_PAIRS", 1)
    monkeypatch.setattr(ref_ops_aggs, "DEVICE_MIN_PAIRS", 1)
    moves = _Moves(monkeypatch)
    aggregations.mask_transfers(reset=True)
    body = {"size": 0, "aggs": {
        "t": {"terms": {"field": "tag", "size": 3}, "aggs": {
            "p": {"percentiles": {"field": "price",
                                  "percents": [50, 95, 99]}}}},
        "h": {"histogram": {"field": "qty", "interval": 10},
              "aggs": {"m": {"max": {"field": "price"}}}}}}
    got = port.search(body).aggregations
    n_pads = [s.n_pad for s in port.segments]
    assert moves.d2h == n_pads and moves.h2d == []
    t = aggregations.mask_transfers(reset=True)
    assert (t["d2h"], t["d2h_bytes"], t["h2d"]) == (
        len(n_pads), sum(n_pads), 0)
    _same(ref.search(body).aggregations, got)
    sub = {"size": 0, "aggs": {"f": {"filter": {"term": {"tag": "alpha"}},
                                     "aggs": {"t": {"terms": {
                                         "field": "tags"}}}}}}
    got = port.search(sub).aggregations
    assert moves.h2d == [s.n_pad for s in port.segments
                         if "tags" in s.keyword_fields]
    _same(ref.search(sub).aggregations, got)


def test_device_routes_take_the_query_tensor_itself(searchers, monkeypatch):
    """K12's counts get the very tensor the query phase made."""
    _, port = searchers
    monkeypatch.setattr(ops_aggs, "DEVICE_MIN_PAIRS", 1)
    seen = []
    real = ops_aggs.masked_ordinal_counts
    monkeypatch.setattr(ops_aggs, "masked_ordinal_counts",
                        lambda o, d, m: seen.append(m) or real(o, d, m))
    real_mask = ShardSearcher._segment_mask
    made = []

    def segment_mask(self, query, seg):
        scores, mask = real_mask(self, query, seg)
        made.append(mask)
        return scores, mask
    monkeypatch.setattr(ShardSearcher, "_segment_mask", segment_mask)
    port.search({"size": 0, "aggs": {"t": {"terms": {"field": "tag"}}}})
    assert len(seen) == len(made) == len(port.segments)
    assert all(a is b for a, b in zip(seen, made))
    assert all(isinstance(m, torch.Tensor) for m in seen)
