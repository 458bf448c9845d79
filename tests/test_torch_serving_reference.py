"""The numpy BM25 reference that ``chip_smoke.py``'s serving phase holds the
route to (``exact_bm25``, with ``extra`` for an appended segment, and
``check_response``), run here against the port's serving route on the CPU
at a small size: a base segment and an appended delta segment of the
smoke's synthetic corpus, served through ``ShardSearcher`` with a
``ServingPlaneCache``'s ``plane_for`` as its ``plane_provider``."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

N_BASE, N_DELTA = 3000, 300
N_REQUESTS = 6


def _smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.fixture(scope="module")
def served():
    """Dispatcher threads that exit as soon as their queue empties."""
    from elasticsearch_tpu_torch.index.mapping import MapperService
    from elasticsearch_tpu_torch.index.segment import segment_from_host_state
    from elasticsearch_tpu_torch.search import microbatch as mb
    from elasticsearch_tpu_torch.search.plane_route import ServingPlaneCache
    from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast
    mp = pytest.MonkeyPatch()
    mp.setattr(mb.PlaneMicroBatcher, "IDLE_EXIT_S", 0.05)
    cs = _smoke()
    corpora, segs, start = [], [], 0
    for i, (n, seed) in enumerate(((N_BASE, 1234), (N_DELTA, 1235))):
        c = synthetic_csr_corpus_fast(np.random.RandomState(seed), n,
                                      cs.VOCAB, cs.AVG_DL, zipf_s=1.2)
        segs.append(segment_from_host_state(dict(
            seg_id=f"_{i}", n_docs=n,
            doc_uids=[str(start + d) for d in range(n)],
            sources=[None] * n,
            seq_nos=np.arange(start, start + n, dtype=np.int64),
            text_fields={"body": cs.body_field_state(c)}), device="cpu"))
        corpora.append(c)
        start += n
    mapper = MapperService({"properties": {"body": {"type": "text"}}})
    cache = ServingPlaneCache(device="cpu")
    cache.lex_prune_min_docs = 1
    cache.repack_mode = "sync"
    rng = np.random.RandomState(4322)
    bags = [[f"w{t[1:]}" for t in q] for q in cs.sample_queries(
        rng, corpora[0], 1, batch=N_REQUESTS)[0]]
    yield cs, corpora, segs, mapper, cache, bags
    cache.release()
    mp.undo()


@pytest.mark.parametrize("tth", [10000, True])
@pytest.mark.parametrize("delta", [False, True])
def test_the_smokes_bm25_reference_holds_the_serving_route(served, tth,
                                                           delta):
    from elasticsearch_tpu_torch.search.shard_search import ShardSearcher
    cs, corpora, segs, mapper, cache, bags = served
    segs = segs if delta else segs[:1]
    searcher = ShardSearcher(segs, mapper, device="cpu",
                             plane_provider=lambda s, f: cache.plane_for(
                                 s, mapper, f))
    gen = cache.plane_for(segs, mapper, "body")
    assert gen is not None and gen.base.blockmax is not None
    assert gen.delta_docs() == (N_DELTA if delta else 0)
    assert cache.rebuild_stats()["cold"] == 1
    for i, terms in enumerate(bags):
        res = searcher.search({"query": {"match": {"body": " ".join(terms)}},
                               "size": cs.K, "track_total_hits": tth})
        ref = cs.exact_bm25(corpora[0], terms, cs.K, avgdl=gen.avgdl,
                            extra=corpora[1:] if delta else ())
        cs.check_response(res, ref, [0, N_BASE], tth is True,
                          f"request {i}")


def test_extra_corpora_score_as_one_index():
    """``extra`` numbers the appended docs after the corpus's and scores
    every doc under the summed dfs and doc count: the same as one corpus
    that holds both."""
    from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast
    cs = _smoke()
    vocab = 64
    a = synthetic_csr_corpus_fast(np.random.RandomState(1), 200, vocab, 8)
    b = synthetic_csr_corpus_fast(np.random.RandomState(2), 50, vocab, 8)
    offs, docs, tf = [0], [], []
    for t in range(vocab):
        for c, base in ((a, 0), (b, 200)):
            st, en = c["offsets"][t], c["offsets"][t + 1]
            docs.append(c["docs"][st:en] + base)
            tf.append(c["tf"][st:en])
        offs.append(offs[-1] + sum(len(x) for x in docs[-2:]))
    both = dict(offsets=np.asarray(offs), docs=np.concatenate(docs),
                tf=np.concatenate(tf), df=a["df"] + b["df"],
                doc_len=np.concatenate([a["doc_len"], b["doc_len"]]))
    terms = ["t1", "t3", "t3", "t9"]
    got = cs.exact_bm25(a, terms, 10, extra=[b])
    want = cs.exact_bm25(both, terms, 10)
    assert np.array_equal(got[0], want[0]) and got[2] == want[2]
    assert np.array_equal(got[1].view(np.int32), want[1].view(np.int32))
