"""The port's text serving route against the reference's, on the CPU.

The same documents go through each side's ``MapperService`` and
``SegmentBuilder``; each side gets its own ``ServingPlaneCache`` (the
block-max tier built from one doc up, repacks inline) and a
``ShardSearcher`` whose ``plane_provider`` is the cache's ``plane_for``.
The reference serves through its jitted steps (``ES_TPU_PLANE_HOST_SERVE=0``,
so neither side has a host scorer), the port through the plain PyTorch
versions of its kernels (``device="cpu"``). Responses must agree in hit
order and ids, scores (bitwise where the sparse, pruned and delta routes
score; within rtol 1e-5, atol 1e-6 where the bf16 dense tier contributes,
whose f32 products sum in another order), totals and their relation —
through pruned, eager and delta-tier serving and across repacks.
"""

import threading
import time

import numpy as np
import pytest

from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.search import microbatch as ref_mb
from elasticsearch_tpu.search import plane_route as ref_pr
from elasticsearch_tpu.search.shard_search import \
    ShardSearcher as RefSearcher
from elasticsearch_tpu_torch.common.errors import IllegalArgumentError
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.kernels import build as kb
from elasticsearch_tpu_torch.search import microbatch as mb
from elasticsearch_tpu_torch.search import plane_route as pr
from elasticsearch_tpu_torch.search.shard_search import ShardSearcher

MAPPING = {"properties": {"body": {"type": "text"},
                          "title": {"type": "text"},
                          "tag": {"type": "keyword"}}}
WORDS = [f"w{i}" for i in range(40)] + ["hello", "world"]
RTOL, ATOL = 1e-5, 1e-6

M1 = {"match": {"body": "w1 w2 hello"}}
BODIES = {
    "default": {"query": M1},
    "bounded": {"query": M1, "track_total_hits": 10000},
    "prune_true": {"query": M1, "prune": True},
    "prune_false": {"query": M1, "prune": False},
    "tracked": {"query": M1, "track_total_hits": True},
    "tracked_prune": {"query": M1, "track_total_hits": True,
                      "prune": True},
    "page": {"query": M1, "size": 5, "from": 4},
    "wide": {"query": {"match": {"body": "w0 w3 w7 w9 world"}},
             "size": 40},
    "repeated_term": {"query": {"match": {"body": "w2 w2 w5"}}},
    "term": {"query": {"term": {"body": "w4"}}},
    "should": {"query": {"bool": {"should": [
        {"match": {"body": "w6"}}, {"term": {"body": "hello"}}]}}},
    "title": {"query": {"match": {"title": "w1 w3"}}},
    "absent_term": {"query": {"match": {"body": "nothere w8"}}},
    "untracked": {"query": M1, "track_total_hits": False, "size": 3},
    "tracked_upto": {"query": M1, "track_total_hits": 5},
    # the pruned scan stops early on these: ``gte`` totals
    "early_exit": {"query": {"match": {"body": "w15 w0"}}, "size": 3,
                   "prune": True},
    "early_exit_bounded": {"query": {"match": {"body": "w31 w1"}},
                           "size": 2, "track_total_hits": 10000},
}


def _docs(seed, n, start, *, head=None):
    """``n`` (id, source) docs: short Zipf bodies over :data:`WORDS` (scores
    tie often), a title on half, a tag; ``head`` in every body."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1)
    p /= p.sum()
    out = []
    for i in range(n):
        words = list(rng.choice(WORDS, int(rng.randint(1, 10)), p=p))
        if head:
            words.append(head)
        src = {"body": " ".join(words), "tag": f"t{rng.randint(0, 4)}"}
        if rng.rand() < 0.5:
            src["title"] = " ".join(rng.choice(WORDS[:8], 2))
        out.append((str(start + i), src))
    return out


def _segment(svc, builder_cls, name, seed, n, start, **kw):
    b = builder_cls(name)
    for seq, (uid, src) in enumerate(_docs(seed, n, start,
                                           head=kw.pop("head", None))):
        b.add(svc.parse_document(uid, src), seq_no=start + seq)
    return b.build(**kw)


class Side:
    """One package's mapper, segments, cache and searcher factory."""

    def __init__(self, port: bool):
        self.port = port
        self.svc = (MapperService if port else RefMapper)(MAPPING)
        self.builder = SegmentBuilder if port else RefBuilder
        self.kw = {"device": "cpu"} if port else {}
        self.cache = (pr.ServingPlaneCache(device="cpu") if port
                      else ref_pr.ServingPlaneCache())
        self.cache.lex_prune_min_docs = 1
        self.cache.repack_mode = "sync"
        self.segments = []

    def add(self, name, seed, n, start, **kw):
        seg = _segment(self.svc, self.builder, name, seed, n, start,
                       **self.kw, **kw)
        self.segments.append(seg)
        return seg

    def searcher(self, segments=None, provider=True):
        segs = self.segments if segments is None else segments
        prov = (lambda s, f: self.cache.plane_for(s, self.svc, f)) \
            if provider else None
        if self.port:
            return ShardSearcher(segs, self.svc, plane_provider=prov,
                                 device="cpu")
        return RefSearcher(segs, self.svc, plane_provider=prov)

    def dispatches(self):
        """Dispatches by batcher (a repack brings a new one)."""
        return {id(b): b.stats_doc()["dispatches"]
                for b in self.cache.serving_batchers()}

    def dispatched_since(self, before) -> bool:
        return any(n > before.get(i, 0)
                   for i, n in self.dispatches().items())


@pytest.fixture(scope="module")
def serving_env():
    """No host scorer on the reference, no warmup thread, dispatcher
    threads that exit as soon as their queue empties; afterwards no
    serving thread is left."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PLANE_HOST_SERVE", "0")
    mp.setenv("ES_TPU_SERVING_WARMUP", "0")
    mp.setattr(mb.PlaneMicroBatcher, "IDLE_EXIT_S", 0.05)
    mp.setattr(ref_mb.PlaneMicroBatcher, "IDLE_EXIT_S", 0.05)
    yield mp
    mp.undo()
    _wait_threads_gone()


def _serving_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("es-dispatcher", "es-repack",
                                  "es-warmup"))]


def _wait_threads_gone(timeout=10.0):
    deadline = time.monotonic() + timeout
    while _serving_threads() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not _serving_threads(), _serving_threads()


def _pair(seed, sizes, **kw):
    ref, port = Side(False), Side(True)
    start = 0
    for si, n in enumerate(sizes):
        for side in (ref, port):
            side.add(f"_{si}", seed + si, n, start, **kw)
        start += n
    return ref, port


@pytest.fixture(scope="module")
def pair(serving_env):
    ref, port = _pair(41, (700, 1, 420))
    yield ref, port
    ref.cache.release()
    port.cache.release()


def _hits(res, bitwise=True):
    return [(h.doc_id, np.float32(h.score).view(np.int32) if bitwise
             else None, h.seg_idx, h.local_doc) for h in res.hits]


def assert_same(r, p, bitwise=True):
    assert _hits(r, bitwise) == _hits(p, bitwise)
    if not bitwise:
        np.testing.assert_allclose([h.score for h in p.hits],
                                   [h.score for h in r.hits],
                                   rtol=RTOL, atol=ATOL)
    assert (r.total, r.total_relation) == (p.total, p.total_relation)
    if bitwise:
        assert r.max_score == p.max_score


def _both(ref, port, body, segments=None):
    """Each side's response; asserts that each took the plane route."""
    n_ref, n_port = ref.dispatches(), port.dispatches()
    r = ref.searcher(segments and segments[0]).search(body)
    p = port.searcher(segments and segments[1]).search(body)
    assert ref.dispatched_since(n_ref) and port.dispatched_since(n_port)
    return r, p


@pytest.mark.parametrize("name", sorted(BODIES))
def test_plane_route_matches_the_reference(pair, name):
    ref, port = pair
    r, p = _both(ref, port, BODIES[name])
    assert_same(r, p)
    assert p.hits or p.total == 0


@pytest.mark.parametrize("name,route", [
    ("default", "eager"), ("tracked", "eager"), ("prune_false", "eager"),
    ("bounded", "pruned"), ("prune_true", "pruned"),
    ("tracked_prune", "pruned"), ("untracked", "pruned")])
def test_prune_resolution_picks_the_route(pair, monkeypatch, name, route):
    """An explicit ``prune`` wins; otherwise exact total tracking (the
    searcher's default, ``track_total_hits: true``) serves eagerly and
    bounded or no tracking prunes."""
    _, port = pair
    port.searcher().search({"query": M1})
    plane = port.cache.generations()[0].base
    ran = []
    for step in ("run_pruned", "run"):
        orig = getattr(plane, step)
        monkeypatch.setattr(plane, step, lambda *a, _s=step, _o=orig, **kw:
                            ran.append(_s) or _o(*a, **kw))
    port.searcher().search(BODIES[name])
    assert ran and ran[0] == ("run_pruned" if route == "pruned" else "run")


@pytest.mark.parametrize("name", ["early_exit", "early_exit_bounded"])
def test_an_early_exit_gives_a_lower_bound_on_both_sides(pair, name):
    ref, port = pair
    r, p = _both(ref, port, BODIES[name])
    assert_same(r, p)
    exact = port.searcher(provider=False).search(
        dict(BODIES[name], track_total_hits=True, prune=False))
    assert p.total_relation == "gte" and p.total < exact.total
    assert _hits(p, False) == _hits(exact, False)


def test_pruned_totals_are_lower_bounds_and_eager_totals_exact(pair):
    """A bounded ``track_total_hits`` takes the pruned route (``gte``
    totals at most the exact count), ``track_total_hits: true`` the eager
    one (exact); the per-segment path gives the exact count."""
    ref, port = pair
    exact = port.searcher(provider=False).search({"query": M1})
    pruned = port.searcher().search(BODIES["bounded"])
    eager = port.searcher().search({"query": M1, "track_total_hits": True})
    assert (eager.total, eager.total_relation) == (exact.total, "eq")
    assert pruned.total <= exact.total
    if pruned.total < exact.total:
        assert pruned.total_relation == "gte"
    assert _hits(pruned) == _hits(eager)
    # the plane bakes BM25 into per-posting impacts: its scores differ
    # from the per-segment path's in the last bit at most
    assert _hits(eager, False) == _hits(exact, False)
    np.testing.assert_allclose([h.score for h in eager.hits],
                               [h.score for h in exact.hits], rtol=1e-6)
    assert port.cache.generations()[0].blockmax is not None


def test_non_boolean_prune_raises_the_reference_error(pair):
    ref, port = pair
    body = {"query": M1, "prune": "yes"}
    with pytest.raises(Exception) as want:
        ref.searcher().search(body)
    with pytest.raises(IllegalArgumentError) as got:
        port.searcher().search(body)
    assert str(got.value) == str(want.value)
    assert "[prune] must be a boolean, got [yes]" in str(got.value)


@pytest.mark.parametrize("body", [
    {"query": M1, "min_score": 2.0},
    {"query": M1, "search_after": [3.0]},
    {"query": {"match": {"body": {"query": "w1 w2",
                                  "operator": "and"}}}},
    {"query": {"match": {"tag": "t1"}}},
], ids=["min_score", "search_after", "and", "keyword"])
def test_ineligible_bodies_take_the_per_segment_path(pair, body):
    ref, port = pair
    n_ref, n_port = ref.dispatches(), port.dispatches()
    before = dict(kb.launches)
    r, p = ref.searcher().search(body), port.searcher().search(body)
    assert not ref.dispatched_since(n_ref)
    assert not port.dispatched_since(n_port)
    assert_same(r, p)
    assert kb.launches == before


def test_sort_is_ineligible_and_refused_by_name(pair):
    ref, port = pair
    body = {"query": M1, "sort": [{"tag": "asc"}]}
    assert not pr.body_eligible(body) and not ref_pr.body_eligible(body)
    n_port = port.dispatches()
    with pytest.raises(IllegalArgumentError, match="ROADMAP A6b"):
        port.searcher().search(body)
    assert not port.dispatched_since(n_port)


@pytest.mark.parametrize("body", [
    {"match": {"body": "w1 hello"}},
    {"match": {"body": {"query": "w1 hello", "operator": "or"}}},
    {"term": {"body": "w1"}},
    {"bool": {"should": [{"match": {"body": "w1"}},
                         {"term": {"body": "w2"}}]}},
    {"bool": {"should": {"match": {"body": "w1"}}}},
    {"bool": {"should": [{"match": {"body": "w1"}},
                         {"match": {"title": "w2"}}]}},
    {"bool": {"must": {"match": {"body": "w1"}}}},
    {"match": {"body": {"query": "w1", "boost": 2.0}}},
    {"match": {"body": {"query": "w1", "minimum_should_match": 2}}},
    {"match": {"tag": "t1"}},
    {"term": {"body": {"value": "w1", "boost": 1.0}}},
    {"match_all": {}},
], ids=lambda b: str(b)[:40])
def test_extract_bag_of_terms_matches_the_reference(pair, body):
    ref, port = pair
    assert pr.extract_bag_of_terms(body, port.svc) == \
        ref_pr.extract_bag_of_terms(body, ref.svc)


def test_dense_tier_serving_matches_the_reference(serving_env):
    """A term in every one of 4,300 docs lands in the bf16 dense tier:
    the pruned route hands such batches to the tiered step on both
    sides."""
    ref, port = _pair(5, (4300,), head="common")
    try:
        for body in ({"query": {"match": {"body": "common w3"}}},
                     {"query": {"match": {"body": "common w1 w9"}},
                      "track_total_hits": True},
                     {"query": {"match": {"body": "w5"}}}):
            r, p = _both(ref, port, body)
            assert_same(r, p, bitwise=False)
        assert port.cache.generations()[0].T_pad > 0
    finally:
        ref.cache.release()
        port.cache.release()


def test_append_serves_a_delta_without_rebuild(serving_env):
    """An appended segment under the repack threshold joins the delta
    tier (no rebuild): its dfs widen the base's idf, its docs merge into
    the base's top-k, pruned totals stay lower bounds."""
    ref, port = _pair(61, (800, 300))
    try:
        for side in (ref, port):
            side.searcher().search({"query": M1})
            side.add("_2", 70, 40, 1100)
        for name in ("default", "bounded", "prune_true", "prune_false",
                     "wide", "page", "early_exit", "early_exit_bounded"):
            r, p = _both(ref, port, BODIES[name])
            assert_same(r, p)
        for side in (ref, port):
            st = side.cache.rebuild_stats()
            assert (st["cold"], st["threshold"], st["structure"]) == \
                (1, 0, 0), st
            assert st["delta_serves"] > 0
        gen = port.cache.generations()[0]
        assert gen.delta_docs() == 40 and gen.base_docs == 1100
    finally:
        ref.cache.release()
        port.cache.release()


def test_threshold_repack_matches_the_reference(serving_env):
    """A delta past 12.5 % of the base repacks (inline here) into a new
    base generation: no delta left, one threshold rebuild a side."""
    ref, port = _pair(81, (600,))
    try:
        for side in (ref, port):
            side.searcher().search({"query": M1})
            side.add("_1", 90, 200, 600)
        for name in ("default", "bounded", "wide", "early_exit"):
            r, p = _both(ref, port, BODIES[name])
            assert_same(r, p)
        for side in (ref, port):
            st = side.cache.rebuild_stats()
            assert (st["cold"], st["threshold"]) == (1, 1), st
            gen = side.cache.generations()[0]
            assert gen.delta_docs() == 0 and gen.base_docs == 800
    finally:
        ref.cache.release()
        port.cache.release()


def test_merge_serves_per_segment_then_repacks(serving_env):
    """A merge restructures the base: ``plane_for`` gives None (the
    per-segment path serves) while a background repack builds the new
    base; once drained, the route serves again. A zero-doc refresh
    keeps the generation."""
    ref, port = _pair(101, (500, 300))
    try:
        for side in (ref, port):
            side.cache.repack_mode = "background"
            side.searcher().search({"query": M1})
            # the merge: one segment holding both segments' docs
            b = side.builder("_m")
            docs = _docs(101, 500, 0) + _docs(102, 300, 500)
            for seq, (uid, src) in enumerate(docs):
                b.add(side.svc.parse_document(uid, src), seq_no=seq)
            side.segments = [b.build(**side.kw)]
            assert side.cache.plane_for(side.segments, side.svc,
                                        "body") is None
        r = ref.searcher().search({"query": M1, "track_total_hits": True})
        p = port.searcher().search({"query": M1, "track_total_hits": True})
        assert_same(r, p)
        for side in (ref, port):
            side.cache.drain_repacks()
            st = side.cache.rebuild_stats()
            assert (st["cold"], st["structure"], st["background"]) == \
                (1, 1, 1), st
        for name in ("default", "bounded"):
            r, p = _both(ref, port, BODIES[name])
            assert_same(r, p)
        # a zero-doc segment in the list: filtered out, same generation
        for side in (ref, port):
            gen = side.cache.generations()[0]
            empty = side.builder("_e").build(**side.kw)
            assert empty.n_docs == 0
            side.segments = side.segments + [empty]
            assert side.cache.plane_for(side.segments, side.svc,
                                        "body") is gen
            assert side.cache.rebuild_stats()["structure"] == 1
        r, p = _both(ref, port, BODIES["default"])
        assert_same(r, p)
    finally:
        ref.cache.release()
        port.cache.release()


def test_deletes_and_nested_docs_disable_the_route(serving_env):
    port = Side(True)
    port.add("_0", 3, 50, 0)
    seg = port.add("_1", 4, 50, 50)
    assert port.cache.plane_for(port.segments, port.svc, "body") \
        is not None
    seg.delete_doc(3)
    assert port.cache.plane_for(port.segments, port.svc, "body") is None
    assert port.cache.plane_for(port.segments, port.svc, "nofield") is None
    port.cache.release()


#: the accounting breaker's estimate of config #1's base plane on one card
#: (2^23 docs: the dense tier and the block-max tier)
CONFIG_1_PLANE_BYTES = 5_213_961_058
CARD_BYTES = 80 << 30


def test_the_default_breakers_trip_on_config_1_and_a_card_fits_it():
    from elasticsearch_tpu_torch.common.breakers import BreakerService
    from elasticsearch_tpu_torch.common.errors import CircuitBreakingError
    svc = BreakerService()
    acct = svc.breaker("accounting")
    with pytest.raises(CircuitBreakingError, match="accounting"):
        acct.add_estimate(CONFIG_1_PLANE_BYTES, "<plane>")
    svc.fit_device(CARD_BYTES)
    assert acct.limit == (1 << 30) + CARD_BYTES
    assert svc.parent.limit == int((1 << 30) * 0.95) + CARD_BYTES
    assert svc.breaker("request").limit == int((1 << 30) * 0.6)
    acct.add_estimate(CONFIG_1_PLANE_BYTES, "<plane>")
    assert acct.stats()["estimated_size_in_bytes"] == CONFIG_1_PLANE_BYTES
    acct.release(CONFIG_1_PLANE_BYTES)


def test_fit_device_keeps_a_limit_a_setting_fixed():
    from elasticsearch_tpu_torch.common.breakers import BreakerService
    svc = BreakerService()
    assert svc.apply_setting("indices.breaker.accounting.limit", "512mb")
    svc.fit_device(CARD_BYTES)
    assert svc.breaker("accounting").limit == 512 << 20
    assert svc.parent.limit == int((1 << 30) * 0.95) + CARD_BYTES
    svc.fit_device(CARD_BYTES // 2)         # grows only
    assert svc.device_budget == CARD_BYTES
    assert svc.apply_setting("indices.breaker.accounting.limit", None)
    assert svc.breaker("accounting").limit == (1 << 30) + CARD_BYTES


def test_a_cache_on_a_card_fits_the_breakers_to_its_memory(monkeypatch):
    """``ServingPlaneCache(device="cuda")`` widens the process's breakers
    by the card's memory (read as ``torch.cuda.mem_get_info`` gives it);
    a cache on the CPU leaves them at the host budget."""
    import torch
    from elasticsearch_tpu_torch.common import breakers
    svc = breakers.BreakerService()
    monkeypatch.setattr(breakers, "DEFAULT", svc)
    pr.ServingPlaneCache(device="cpu").release()
    assert svc.breaker("accounting").limit == 1 << 30
    asked = []
    monkeypatch.setattr(pr, "resolve_device",
                        lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d=None: asked.append(d) or (1, CARD_BYTES))
    cache = pr.ServingPlaneCache(device="cuda")
    cache.release()
    assert asked == [torch.device("cuda", 0)]
    assert svc.breaker("accounting").limit == (1 << 30) + CARD_BYTES
    svc.breaker("accounting").add_estimate(CONFIG_1_PLANE_BYTES, "<plane>")


def _rest(port: bool, tmp_path):
    """A reference ``RestAPI`` whose index serves through the reference's
    cache, or through the port's installed as ``IndexService.plane_cache``
    (``device="cpu"``)."""
    import json

    from elasticsearch_tpu.node.indices_service import IndicesService
    from elasticsearch_tpu.rest.api import RestAPI
    api = RestAPI(IndicesService(str(tmp_path / ("port" if port
                                                 else "ref"))))
    st, _, _ = api.handle("PUT", "/lex", "", json.dumps(
        {"mappings": MAPPING}).encode())
    assert st == 200
    svc = api.indices.get("lex")
    if port:
        svc.plane_cache.release()
        svc.plane_cache = pr.ServingPlaneCache(device="cpu")
    svc.plane_cache.lex_prune_min_docs = 1
    svc.plane_cache.repack_mode = "sync"
    return api, svc


def _bulk(api, docs):
    import json
    lines = []
    for uid, src in docs:
        lines += [json.dumps({"index": {"_id": uid}}), json.dumps(src)]
    st, _, _ = api.handle("POST", "/lex/_bulk", "refresh=true",
                          ("\n".join(lines) + "\n").encode())
    assert st == 200


def _rest_search(api, body):
    import json
    st, _, payload = api.handle("POST", "/lex/_search",
                                "request_cache=false",
                                json.dumps(body).encode())
    d = json.loads(payload)
    assert st == 200, d
    return ([(h["_id"], h["_score"]) for h in d["hits"]["hits"]],
            d["hits"]["total"], d["hits"]["max_score"])


def test_rest_search_through_the_ports_cache_matches_the_reference(
        serving_env, tmp_path):
    """``_search`` on a reference node whose index serves through the
    port's cache answers as the reference's own cache does, before and
    after a refresh appends a delta segment."""
    sides = [_rest(False, tmp_path), _rest(True, tmp_path)]
    try:
        for api, _ in sides:
            _bulk(api, _docs(7, 900, 0))
        bodies = [BODIES[n] for n in ("default", "bounded", "prune_true",
                                      "prune_false", "page", "wide",
                                      "should", "early_exit")]
        for body in bodies:
            want, got = (_rest_search(api, body) for api, _ in sides)
            assert got == want
        for api, _ in sides:
            _bulk(api, _docs(8, 60, 900))
        for body in bodies:
            want, got = (_rest_search(api, body) for api, _ in sides)
            assert got == want
        port_cache = sides[1][1].plane_cache
        assert isinstance(port_cache, pr.ServingPlaneCache)
        st = port_cache.rebuild_stats()
        assert (st["cold"], st["threshold"]) == (1, 0) and \
            st["delta_serves"] > 0, st
        assert sum(b.stats_doc()["dispatches"]
                   for b in port_cache.serving_batchers()) >= 2 * len(bodies)
    finally:
        for _, svc in sides:
            svc.close()
