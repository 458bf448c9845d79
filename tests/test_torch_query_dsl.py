"""The port's query DSL against the reference, per segment, on the CPU.

Every ported query type (match_all, match_none, match, term, terms, range,
exists, ids, prefix, bool, constant_score, dis_max, boosting) runs on the
same ``SegmentBuilder`` segments (built from the same documents by each
side's ``MapperService``) through each side's ``parse_query`` and
``execute``: the per-segment (scores, mask) must be equal, the scores
bitwise. Every query type the port does not have yet raises a parsing
error that names it.
"""

import pytest
import torch

from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.search import query_dsl as ref_dsl
from elasticsearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                   ParsingError,
                                                   QueryShardError)
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.search import query_dsl
from torch_cases import assert_same_bits, build_segments

M1 = {"match": {"body": "w1 w2 hello"}}
F_TAG = {"terms": {"tag": ["alpha", "gamma", "nope"]}}
F_PRICE = {"range": {"price": {"gte": 1.5, "lt": 7.25}}}
NOT_TAG = {"term": {"tag": "beta"}}

QUERIES = {
    "match_all": {"match_all": {}},
    "match_all_boost": {"match_all": {"boost": 2.5}},
    "match_none": {"match_none": {}},
    "match": M1,
    "match_and": {"match": {"body": {"query": "w1 w2", "operator": "and"}}},
    "match_msm": {"match": {"body": {"query": "w1 w2 w3 w4",
                                     "minimum_should_match": "75%"}}},
    "match_msm_neg": {"match": {"body": {"query": "w0 w1 w5",
                                         "minimum_should_match": -1}}},
    "match_dup_terms": {"match": {"body": {"query": "w1 w1 w3",
                                           "boost": 1.7}}},
    "match_analyzer": {"match": {"body": {"query": "Hello THE",
                                          "analyzer": "standard"}}},
    "match_keyword": {"match": {"tag": "alpha"}},
    "match_number": {"match": {"qty": 7}},
    "match_unmapped": {"match": {"nope": "w1"}},
    "match_empty": {"match": {"body": ""}},
    "term_text": {"term": {"body": "w2"}},
    "term_keyword": {"term": {"tag": {"value": "alpha", "boost": 3.0}}},
    "term_alias": {"term": {"alias_tag": "beta"}},
    "term_id": {"term": {"_id": "12"}},
    "term_long": {"term": {"qty": 10}},
    "term_double": {"term": {"price": 1.75}},
    "term_date": {"term": {"ts": "2020-03-15"}},
    "term_bool": {"term": {"flag": True}},
    "term_ip": {"term": {"addr": "10.0.1.0/24"}},
    "term_range_field": {"term": {"span": 12}},
    "term_const_kw": {"term": {"ck": "x"}},
    "term_nested_kw": {"term": {"comments.who": "alpha"}},
    "terms_keyword": F_TAG,
    "terms_multi": {"terms": {"tags": ["beta", "zeta"], "boost": 2.0}},
    "terms_long": {"terms": {"qty": [1, 5, 9, 49]}},
    "terms_date": {"terms": {"ts": ["2020-01-10", "2020-05-13"]}},
    "terms_bool": {"terms": {"flag": [False]}},
    "terms_text": {"terms": {"body": ["w3", "world"]}},
    "terms_id": {"terms": {"_id": ["1", "71", "999"]}},
    "terms_const_kw": {"terms": {"ck": ["y", "x"]}},
    "range_double": F_PRICE,
    "range_double_open": {"range": {"price": {"gt": 2.0, "lte": 6.5,
                                              "boost": 2.0}}},
    "range_long": {"range": {"qty": {"gte": -2}}},
    "range_long_lt": {"range": {"qty": {"lt": 10}}},
    "range_empty": {"range": {"qty": {"gt": 30, "lt": 31}}},
    "range_date": {"range": {"ts": {"gte": "2020-03-01",
                                    "lt": "2020-07-01"}}},
    "range_date_year": {"range": {"ts": {"gte": 2020}}},
    "range_keyword": {"range": {"tag": {"gte": "beta", "lt": "eps"}}},
    "range_keyword_gt": {"range": {"tag": {"gt": "alpha", "lte": "gamma"}}},
    "range_ip": {"range": {"addr": {"gte": "10.0.1.0", "lt": "10.0.2.7"}}},
    "range_field_within": {"range": {"span": {"gte": 2, "lte": 20,
                                              "relation": "within"}}},
    "range_field_contains": {"range": {"span": {"gte": 5, "lt": 8,
                                                "relation": "contains"}}},
    "range_field_intersects": {"range": {"span": {"gt": 10, "lt": 14}}},
    "range_legacy": {"range": {"qty": {"from": 3, "to": 9,
                                       "include_upper": False}}},
    "exists_text": {"exists": {"field": "body"}},
    "exists_keyword": {"exists": {"field": "tag"}},
    "exists_number": {"exists": {"field": "price"}},
    "exists_vector": {"exists": {"field": "vec"}},
    "exists_object": {"exists": {"field": "obj"}},
    "exists_id": {"exists": {"field": "_id"}},
    "exists_const_kw": {"exists": {"field": "ck"}},
    "exists_missing": {"exists": {"field": "nope"}},
    "ids": {"ids": {"values": ["0", "3", "44", "80", "nope"]}},
    "prefix_text": {"prefix": {"body": "w1"}},
    "prefix_keyword": {"prefix": {"tag": {"value": "ga", "boost": 2.0}}},
    "prefix_none": {"prefix": {"body": "zz"}},
    "bool": {"bool": {"must": M1, "filter": [F_TAG, F_PRICE],
                      "must_not": NOT_TAG}},
    "bool_should": {"bool": {"should": [M1, {"match": {"title": "w0"}},
                                        {"term": {"tag": "delta"}}],
                             "minimum_should_match": 2, "boost": 1.3}},
    "bool_must_should": {"bool": {"must": {"match": {"body": "w0"}},
                                  "should": [{"match": {"body": "w4 w5"}}]}},
    "bool_filter_msm0": {"bool": {"filter": F_PRICE, "should": [M1],
                                  "minimum_should_match": 0}},
    "bool_must_not_only": {"bool": {"must_not": [NOT_TAG, F_PRICE]}},
    "bool_empty": {"bool": {}},
    "bool_nested": {"bool": {"must": [{"bool": {"should": [
        M1, {"term": {"body": "world"}}]}}], "filter": {"exists": {
            "field": "qty"}}}},
    "constant_score": {"constant_score": {"filter": M1, "boost": 1.5}},
    "dis_max": {"dis_max": {"queries": [M1, {"match": {"title": "w1"}},
                                        {"term": {"tag": "alpha"}}],
                            "tie_breaker": 0.3}},
    "boosting": {"boosting": {"positive": M1, "negative": NOT_TAG,
                              "negative_boost": 0.2}},
}


@pytest.fixture(scope="module")
def shards():
    rsvc, rsegs = build_segments(RefMapper, RefBuilder, 17)
    psvc, psegs = build_segments(MapperService, SegmentBuilder, 17,
                                 device="cpu")
    return (ref_dsl.ShardContext(rsegs, rsvc),
            query_dsl.ShardContext(psegs, psvc))


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_matches_the_reference_per_segment(shards, name):
    rctx, pctx = shards
    spec = QUERIES[name]
    rq, pq = ref_dsl.parse_query(spec), query_dsl.parse_query(spec)
    assert type(rq).__name__ == type(pq).__name__
    assert len(rctx.segments) == len(pctx.segments) == 3
    matched = 0
    for rseg, pseg in zip(rctx.segments, pctx.segments):
        rs, rm = rq.execute(rctx, rseg)
        ps, pm = pq.execute(pctx, pseg)
        assert isinstance(ps, torch.Tensor) and ps.dtype == torch.float32
        assert pm.dtype == torch.bool and ps.shape == (pseg.n_pad,)
        assert_same_bits(rm, pm)
        assert_same_bits(rs, ps)
        matched += int(pm.sum())
    # the cases are meant to match something, except the empty ones
    assert (matched == 0) == (name in ("match_none", "match_unmapped",
                                       "match_empty", "range_empty",
                                       "exists_missing", "prefix_none"))


def test_minimum_should_match_matches_the_reference():
    for spec in (None, 2, "2", "-1", "75%", "-25%", "3<90%", "2<-1 5<50%",
                 0, 10, -10):
        for n in range(0, 8):
            assert query_dsl.resolve_minimum_should_match(spec, n) == \
                ref_dsl.resolve_minimum_should_match(spec, n)
    with pytest.raises(ParsingError):
        query_dsl.resolve_minimum_should_match("x%", 3)


@pytest.mark.parametrize("qtype", sorted(query_dsl._NOT_PORTED))
def test_unported_query_types_raise_and_name_themselves(qtype):
    assert qtype in ref_dsl._PARSERS
    with pytest.raises(ParsingError, match=rf"query \[{qtype}\] is not "
                                           r"ported.*ROADMAP A6b"):
        query_dsl.parse_query({qtype: {}})


def test_the_port_parses_every_reference_query_type_or_names_it():
    assert set(query_dsl._PARSERS) | set(query_dsl._NOT_PORTED) == \
        set(ref_dsl._PARSERS)
    assert not set(query_dsl._PARSERS) & set(query_dsl._NOT_PORTED)


def test_malformed_queries_raise_as_the_reference_does(shards):
    _, pctx = shards
    seg = pctx.segments[0]
    with pytest.raises(ParsingError, match="unknown query"):
        query_dsl.parse_query({"matchh": {}})
    with pytest.raises(ParsingError, match="single top-level"):
        query_dsl.parse_query({"match": {}, "term": {}})
    with pytest.raises(ParsingError):
        query_dsl.parse_query({"terms": {"tag": "alpha"}})
    with pytest.raises(ParsingError):
        query_dsl.parse_query({"range": {"span": {"gte": 1,
                                                  "relation": "bad"}}})
    with pytest.raises(QueryShardError):
        query_dsl.parse_query({"exists": {"field": "_source"}}).execute(
            pctx, seg)
    with pytest.raises(IllegalArgumentError):
        query_dsl.parse_query({"range": {"vec": {"gte": 1}}}).execute(
            pctx, seg)
    with pytest.raises(ParsingError, match="case_insensitive"):
        query_dsl.parse_query({"term": {"tag": {
            "value": "A", "case_insensitive": True}}}).execute(pctx, seg)


def test_queries_run_where_the_segment_lies(shards):
    _, pctx = shards
    for seg in pctx.segments:
        s, m = query_dsl.parse_query(QUERIES["bool"]).execute(pctx, seg)
        assert s.device == seg.device == m.device


def test_scored_keyword_clauses_share_the_fields_constants(shards):
    """A scored keyword clause feeds K16 tf ones and one doc length of zero
    (exact with b = 0) that its field makes once, at first use, and every
    later clause reuses; the scores are the reference's (``shards``
    compares every query with it) and the same bits on every call."""
    rctx, pctx = shards
    q = {"bool": {"should": [{"term": {"tag": "alpha"}},
                             {"terms": {"tag": ["beta", "gamma"]}}]}}
    for seg in pctx.segments:
        f = seg.keyword_fields["tag"]
        f.bm25_dev = None
        first = query_dsl.parse_query(q).execute(pctx, seg)
        ones, zeros = f.bm25_dev
        assert ones.shape == f.docs_dev.shape and zeros.shape == (1,)
        assert bool((ones == 1).all()) and not bool(zeros.any())
        again = query_dsl.parse_query(q).execute(pctx, seg)
        assert f.bm25_dev[0] is ones and f.bm25_dev[1] is zeros
        for a, b in zip(first, again):
            assert_same_bits(a, b)
