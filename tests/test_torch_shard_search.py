"""The port's ``ShardSearcher`` against the reference's per-segment path, on
the CPU.

The same documents go through each side's ``MapperService`` and
``SegmentBuilder`` (three segments with deletes and nested children);
each body runs through each side's ``ShardSearcher.search`` (the
reference without serving-plane providers, so its per-segment path) and
``count``. Hits (ids, segments, local docs, ``_source``, sort values,
seq_no), scores (bitwise), totals and their relation, and max_score must
be equal. Every body key and provider the port does not have yet raises;
a serving-plane provider that declines leaves the per-segment path
serving (``tests/test_torch_plane_route.py`` drives the plane route).
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.search.shard_search import \
    ShardSearcher as RefSearcher
from elasticsearch_tpu_torch.common.errors import (ElasticsearchError,
                                                   IllegalArgumentError)
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import (SegmentBuilder,
                                                   segment_from_host_state,
                                                   segment_host_state)
from elasticsearch_tpu_torch.kernels import build as kb
from elasticsearch_tpu_torch.search import shard_search
from elasticsearch_tpu_torch.search.shard_search import ShardSearcher
from torch_cases import build_segments

M1 = {"match": {"body": "w1 w2 hello"}}
BOOL = {"bool": {"must": M1,
                 "filter": [{"terms": {"tag": ["alpha", "gamma"]}},
                            {"range": {"price": {"gte": 1.5, "lt": 7.25}}}],
                 "must_not": {"term": {"tag": "beta"}}}}

BODIES = {
    "match": {"query": M1},
    "match_page": {"query": M1, "size": 5, "from": 3},
    "match_all": {},
    "match_all_deep": {"query": {"match_all": {}}, "from": 100,
                       "size": 40},
    "past_every_doc": {"query": M1, "size": 500},
    "bool": {"query": BOOL, "size": 50},
    "and": {"query": {"match": {"body": {"query": "w0 w1",
                                         "operator": "and"}}}},
    "keyword_range": {"query": {"range": {"tag": {"gte": "beta",
                                                  "lt": "eps"}}}},
    "prefix": {"query": {"prefix": {"body": "w1"}}, "size": 20},
    "dis_max": {"query": {"dis_max": {"queries": [
        M1, {"match": {"title": "w1"}}], "tie_breaker": 0.3}}},
    "size0": {"query": M1, "size": 0},
    "size0_untracked": {"query": M1, "size": 0, "track_total_hits": False},
    "untracked": {"query": M1, "size": 5, "track_total_hits": False},
    "untracked_few": {"query": {"term": {"body": "world"}},
                      "track_total_hits": False, "size": 50},
    "tracked_upto": {"query": M1, "track_total_hits": 7},
    "tracked_upto_many": {"query": M1, "track_total_hits": 10000},
    "min_score": {"query": M1, "min_score": 1.5, "size": 30},
    "min_score_all": {"query": BOOL, "min_score": 0.0},
    "source_off": {"query": M1, "_source": False},
    "source_field": {"query": M1, "_source": "tag"},
    "source_list": {"query": M1, "_source": ["tag", "pri*", "obj.*"]},
    "source_incl_excl": {"query": M1, "_source": {
        "includes": ["*"], "excludes": ["body", "comments"]}},
    "nested_term": {"query": {"term": {"comments.who": "alpha"}}},
    "after_score": {"query": M1, "search_after": [1.0], "size": 20},
}


@pytest.fixture(scope="module")
def searchers():
    rsvc, rsegs = build_segments(RefMapper, RefBuilder, 29)
    psvc, psegs = build_segments(MapperService, SegmentBuilder, 29,
                                 device="cpu")
    return RefSearcher(rsegs, rsvc), ShardSearcher(psegs, psvc,
                                                   device="cpu")


def _hits(res):
    return [(h.doc_id, np.float32(h.score).view(np.int32) if h.score
             is not None else None, h.seg_idx, h.local_doc, h.source,
             h.sort_values, h.seq_no, h.ignored) for h in res.hits]


def _assert_same(r, p):
    assert _hits(r) == _hits(p)
    assert (r.total, r.total_relation) == (p.total, p.total_relation)
    assert r.max_score == p.max_score


@pytest.mark.parametrize("name", sorted(BODIES))
def test_search_matches_the_reference(searchers, name):
    ref, port = searchers
    r, p = ref.search(BODIES[name]), port.search(BODIES[name])
    _assert_same(r, p)
    if name not in ("size0", "size0_untracked"):
        assert p.hits or p.total == 0


def test_search_on_carried_segments_matches_the_reference(searchers):
    """The reference's own segments, handed across as host states, serve
    every body as the reference serves it."""
    ref, port = searchers
    carried = ShardSearcher(
        [segment_from_host_state(segment_host_state(s), device="cpu")
         for s in ref.segments], port.mapper, device="cpu")
    for name, body in sorted(BODIES.items()):
        _assert_same(ref.search(body), carried.search(body))
        assert ref.count(body) == carried.count(body), name


def test_search_after_pages_match_the_reference(searchers):
    """Page through a query with many equal scores by the [score,
    shard_doc] cursor of each page's last hit: every page equal, and the
    pages together are the whole ranking."""
    ref, port = searchers
    body = {"query": {"constant_score": {"filter": {"exists": {
        "field": "tag"}}}}, "size": 7}
    seen, after = [], None
    whole = port.search(dict(body, size=1000))
    while True:
        b = dict(body) if after is None else dict(body, search_after=after)
        r, p = ref.search(b), port.search(b)
        _assert_same(r, p)
        if not p.hits:
            break
        seen += [(h.seg_idx, h.local_doc) for h in p.hits]
        after = p.hits[-1].sort_values
    assert seen == [(h.seg_idx, h.local_doc) for h in whole.hits]


def test_keyword_arguments_match_the_reference(searchers):
    ref, port = searchers
    for kw in (dict(size=3, from_=2), dict(min_score=0.5),
               dict(track_total_hits=False, size=4),
               dict(track_total_hits=3)):
        _assert_same(ref.search({"query": M1}, **kw),
                     port.search({"query": M1}, **kw))


@pytest.mark.parametrize("body", [None, {}, {"query": M1}, {"query": BOOL},
                                  {"query": {"match_none": {}}},
                                  {"query": {"term": {"comments.who":
                                                      "beta"}}}])
def test_count_matches_the_reference(searchers, body):
    ref, port = searchers
    assert ref.count(body) == port.count(body)


@pytest.mark.parametrize("key", sorted(shard_search.NOT_PORTED))
def test_unported_body_keys_raise_and_name_their_item(searchers, key):
    _, port = searchers
    item, where = shard_search.NOT_PORTED[key]
    with pytest.raises(IllegalArgumentError,
                       match=rf"\[{key}\].*ROADMAP {item}"):
        port.search({"query": M1, key: {}})


def test_other_body_keys_and_providers_raise(searchers):
    _, port = searchers
    with pytest.raises(IllegalArgumentError, match=r"\[post_filter\]"):
        port.search({"query": M1, "post_filter": {"match_all": {}}})
    with pytest.raises(ElasticsearchError, match=r"query \[match_phrase\]"):
        port.search({"query": {"match_phrase": {"body": "w1 w2"}}})
    segs = port.segments
    for kw, item in (("knn_plane_provider", "A2b"),
                     ("fused_provider", "A2b")):
        with pytest.raises(IllegalArgumentError, match=f"ROADMAP {item}"):
            ShardSearcher(segs, port.mapper, device="cpu",
                          **{kw: lambda *a: None})
    # the text serving route is ported: a provider that declines (None)
    # leaves the per-segment path serving
    asked = []
    served = ShardSearcher(segs, port.mapper, device="cpu",
                           plane_provider=lambda s, f: asked.append(f))
    _assert_same(port.search({"query": M1}), served.search({"query": M1}))
    assert asked == ["body"]


def test_searcher_defaults_to_cuda_and_runs_where_its_segments_lie(
        searchers, monkeypatch):
    _, port = searchers
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardSearcher(port.segments, port.mapper)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="lies on cpu"):
        ShardSearcher(port.segments, port.mapper, device="cuda")
    before = dict(kb.launches)
    port.search({"query": BOOL})
    assert kb.launches == before          # the CPU runs no kernel
