"""The PyTorch port's serving plane against the JAX plane, on the CPU.

Both planes pack the same shard dicts: the packed tables must be bit
identical, and ``search`` / ``serve`` must return the same hits and totals,
with scores bitwise equal on all-sparse batches and within rtol 1e-5,
atol 1e-6 where the dense tier contributes (its f32 product sums in another
order). The JAX plane runs its jitted SPMD step (host serving off), the port
plane its plain PyTorch versions (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.parallel import DistributedSearchPlane as JaxPlane
from elasticsearch_tpu.parallel import make_search_mesh
from elasticsearch_tpu_torch.parallel.dist_search import (
    DistributedSearchPlane, plane_state_from_numpy, tiered_bm25_step)
from elasticsearch_tpu_torch.utils.synth import (split_csr_shards,
                                                 synthetic_csr_corpus_fast)

RTOL, ATOL = 1e-5, 1e-6
VOCAB = 512
DENSE_THRESHOLD = 200


@pytest.fixture(scope="module")
def corpus():
    c = synthetic_csr_corpus_fast(np.random.RandomState(7), 4096, VOCAB, 16)
    c["term_ids"] = {f"t{t}": t for t in range(VOCAB)}
    return c


@pytest.fixture(scope="module", params=[1, 4], ids=["S1", "S4"])
def planes(request, corpus):
    S = request.param
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PLANE_HOST_SERVE", "0")
    shards = split_csr_shards(corpus, S) if S > 1 else [corpus]
    for s in shards:
        s["term_ids"] = corpus["term_ids"]
    jp = JaxPlane(make_search_mesh(n_shards=S), shards, "body",
                  dense_threshold=DENSE_THRESHOLD)
    tp = DistributedSearchPlane(shards, "body", device="cpu",
                                dense_threshold=DENSE_THRESHOLD)
    mp.undo()
    assert jp._host_csr is None and tp.T_pad > 0
    return jp, tp


def _queries(corpus, seed, n_terms, dense=True):
    rng = np.random.RandomState(seed)
    df = corpus["df"].astype(np.float64)
    if dense:
        el = np.flatnonzero(df >= 2)
        p = df[el] / df[el].sum()
    else:
        el = np.flatnonzero((df >= 2) & (df <= DENSE_THRESHOLD // 4))
        p = None
    return [[f"t{t}" for t in rng.choice(el, size=n, p=p)]
            for n in n_terms]


def _same_results(a, b, *, bitwise):
    assert a[1] == b[1]                    # hits: (shard, local doc)
    if len(a) > 2:
        assert a[2] == b[2]                # totals
    va, vb = np.asarray(a[0]), np.asarray(b[0])
    fin = np.isfinite(va)
    assert np.array_equal(fin, np.isfinite(vb))
    if bitwise:
        assert np.array_equal(va[fin].view(np.int32), vb[fin].view(np.int32))
    else:
        np.testing.assert_allclose(va[fin], vb[fin], rtol=RTOL, atol=ATOL)


def test_pack_is_bit_identical(planes):
    jp, tp = planes
    pk = tp.packed_arrays()
    for key in ("n_pad", "T_pad", "L_cap", "p_pad"):
        assert getattr(jp, key) == pk[key], key
    assert tp.dense_block == jp.dense_block
    assert np.array_equal(np.asarray(jp.docs_dev), pk["docs"])
    assert np.array_equal(np.asarray(jp.impacts_dev).view(np.int32),
                          pk["impacts"].view(np.int32))
    assert np.array_equal(np.asarray(jp.dense_dev).view(np.int16),
                          pk["dense_bits"])
    # the reference's packed host arrays load into the port's tensors
    st = plane_state_from_numpy(dict(docs=np.asarray(jp.docs_dev),
                                     impacts=np.asarray(jp.impacts_dev),
                                     dense=np.asarray(jp.dense_dev)),
                                device="cpu")
    assert torch.equal(st["docs"], tp.docs_dev)
    assert torch.equal(st["impacts"].view(torch.int32),
                       tp.impacts_dev.view(torch.int32))
    assert torch.equal(st["dense"].view(torch.int16),
                       tp.dense_dev.view(torch.int16))


@pytest.mark.parametrize("tiered,k", [(None, 10), (True, 100), (True, 10)])
def test_search_matches_reference(planes, corpus, tiered, k):
    jp, tp = planes
    qs = _queries(corpus, 1, [1, 2, 3, 3, 4, 2, 8, 1])
    want = jp.search(qs, k=k, tiered=tiered, with_totals=True)
    got = tp.search(qs, k=k, tiered=tiered, with_totals=True)
    _same_results(want, got, bitwise=False)
    assert tp.n_dispatches >= 1


def test_all_sparse_batch_is_bitwise(planes, corpus):
    jp, tp = planes
    qs = _queries(corpus, 2, [1, 3, 2, 3, 1, 2, 3, 8], dense=False)
    for tiered in (False, None):
        want = jp.search(qs, k=10, tiered=tiered, with_totals=True)
        got = tp.search(qs, k=10, tiered=tiered, with_totals=True)
        _same_results(want, got, bitwise=True)
    with pytest.raises(ValueError):
        tp.search(_queries(corpus, 3, [3] * 4), k=10, tiered=False)


def test_extra_corpus_mass_shifts_idf_alike(planes, corpus):
    jp, tp = planes
    qs = _queries(corpus, 4, [2, 3, 1, 4, 2, 3, 3, 2])
    extra = dict(extra_docs=1500, extra_df={qs[0][0]: 40, qs[3][1]: 7})
    want = jp.search(qs, k=10, with_totals=True, **extra)
    got = tp.search(qs, k=10, with_totals=True, **extra)
    _same_results(want, got, bitwise=False)
    assert jp.global_df(qs[0][0]) == tp.global_df(qs[0][0])
    assert jp.max_run_len(qs) == tp.max_run_len(qs)
    assert jp.ladder_rungs() == tp.ladder_rungs()


def test_serve_matches_reference(planes, corpus):
    jp, tp = planes
    qs = _queries(corpus, 5, [4, 4, 2, 3, 1, 4, 3, 4])
    st = {}
    want = jp.serve(qs, k=10, with_totals=True)
    got = tp.serve(qs, k=10, with_totals=True, stages=st)
    _same_results(want, got, bitwise=False)
    assert set(st) == {"prep_ms", "dispatch_ms", "fetch_ms"}


def test_step_on_reference_pack(planes, corpus):
    """The tiered step body runs on tensors loaded from the reference's
    packed arrays and gives the plane's own answer."""
    jp, tp = planes
    qs = _queries(corpus, 6, [3, 2, 4, 1])
    prep = tp.prepare(qs, 10, tiered=True)
    st = plane_state_from_numpy(dict(docs=np.asarray(jp.docs_dev),
                                     impacts=np.asarray(jp.impacts_dev),
                                     dense=np.asarray(jp.dense_dev)),
                                device="cpu")
    args = dict(prep["args"], postings_docs=st["docs"],
                postings_impact=st["impacts"], dense=st["dense"])
    kw = dict(n_pad=tp.n_pad, L=prep["L"], k=10, with_count=True)
    a = tiered_bm25_step(**args, **kw)
    b = tiered_bm25_step(**prep["args"], **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_from_segments_packs_the_same_plane(corpus):
    """``from_segments`` reads each segment's host arrays of the field
    (duck-typed), as the reference's does."""
    from types import SimpleNamespace
    shards = split_csr_shards(corpus, 2)
    segs = [SimpleNamespace(
        doc_uids=[f"d{i}" for i in range(s["doc_len"].shape[0])],
        text_fields={"body": SimpleNamespace(
            term_ids=corpus["term_ids"], df=s["df"], offsets=s["offsets"],
            docs_host=s["docs"], tf_host=s["tf"],
            doc_len_host=s["doc_len"])}) for s in shards]
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PLANE_HOST_SERVE", "0")
    jp = JaxPlane.from_segments(make_search_mesh(n_shards=2), segs, "body",
                                dense_threshold=DENSE_THRESHOLD)
    mp.undo()
    tp = DistributedSearchPlane.from_segments(
        segs, "body", device="cpu", dense_threshold=DENSE_THRESHOLD)
    assert tp.shards[1]["doc_uids"] == segs[1].doc_uids
    assert np.array_equal(np.asarray(jp.docs_dev), tp.docs_dev.numpy())
    qs = _queries(corpus, 8, [2, 3, 4, 1])
    _same_results(jp.serve(qs, k=10, with_totals=True),
                  tp.serve(qs, k=10, with_totals=True), bitwise=False)
