"""Parity of the PyTorch port's ops with the JAX reference, on the CPU.

The same seeded numpy inputs go through the JAX function and through the
port's counterpart (which, on CPU tensors, is the plain version of its
CUDA kernel). Tolerances: the sorted-merge scores, the dense gather and
every top-k are exact (bitwise for scores); the dense-tier product is f32
sums of at most Q non-zero terms in another order, held to rtol 1e-5,
atol 1e-6, with docs equal except among scores tied within that.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import sorted_merge as jsm
from elasticsearch_tpu.ops import tiered_bm25 as jtb
from elasticsearch_tpu.ops import topk as jtk
from elasticsearch_tpu.ops.bm25 import idf_weight as j_idf
from elasticsearch_tpu.utils import shapes as jshapes
from elasticsearch_tpu.utils import synth as jsynth

from elasticsearch_tpu_torch.kernels import build as kb
from elasticsearch_tpu_torch.ops import sorted_merge as tsm
from elasticsearch_tpu_torch.ops import tiered_bm25 as ttb
from elasticsearch_tpu_torch.ops import topk as ttk
from elasticsearch_tpu_torch.ops.bm25 import idf_weight as t_idf
from elasticsearch_tpu_torch.utils import shapes as tshapes
from elasticsearch_tpu_torch.utils import synth as tsynth
from torch_cases import (assert_topk_close, dense_case, sparse_case,
                         topk_lists_case)

RTOL, ATOL = 1e-5, 1e-6


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _jbf16(bits):
    return jnp.asarray(np.asarray(bits).view(jnp.bfloat16))


def _tbf16(bits):
    return torch.from_numpy(np.ascontiguousarray(bits)).view(torch.bfloat16)


# ---------------------------------------------------------------------------
# host utilities
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_synth_corpora_byte_identical(seed):
    a = jsynth.synthetic_csr_corpus_fast(np.random.RandomState(seed), 3000,
                                         300, 12)
    b = tsynth.synthetic_csr_corpus_fast(np.random.RandomState(seed), 3000,
                                         300, 12)
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype
        assert np.array_equal(a[key], b[key])
    small_a = jsynth.synthetic_csr_corpus(np.random.RandomState(seed), 500,
                                          64, 8)
    small_b = tsynth.synthetic_csr_corpus(np.random.RandomState(seed), 500,
                                          64, 8)
    for key in small_a:
        assert np.array_equal(small_a[key], small_b[key])
    for sa, sb in zip(jsynth.split_csr_shards(a, 3),
                      tsynth.split_csr_shards(b, 3)):
        for key in sa:
            assert np.array_equal(sa[key], sb[key])


def test_shapes_and_bm25_weights_identical():
    for n in (0, 1, 7, 8, 9, 1000, 1 << 20):
        assert jshapes.round_up_pow2(n) == tshapes.round_up_pow2(n)
        assert jshapes.round_up_multiple(n, 16) == \
            tshapes.round_up_multiple(n, 16)
        assert jshapes.bucket_length(n, 8, 4096) == \
            tshapes.bucket_length(n, 8, 4096)
    df = np.array([0, 1, 5, 100, 4095, 4096])
    assert np.array_equal(_bits(j_idf(4096, df)), _bits(t_idf(4096, df)))
    rng = np.random.RandomState(3)
    docs = rng.randint(0, 50, 400)
    tf = rng.randint(1, 4, 400).astype(np.float32)
    dl = rng.randint(1, 60, 50).astype(np.float32)
    assert np.array_equal(
        _bits(jsm.make_impacts(tf, docs, dl, 31.5, 1.2, 0.75)),
        _bits(tsm.make_impacts(tf, docs, dl, 31.5, 1.2, 0.75)))


def test_split_tiers_and_dense_rows_identical():
    c = tsynth.synthetic_csr_corpus_fast(np.random.RandomState(5), 4096,
                                         256, 16)
    imp = tsm.make_impacts(c["tf"], c["docs"], c["doc_len"],
                           float(c["doc_len"].mean()), 1.2, 0.75)
    ja = jtb.split_tiers(c, dense_threshold=300, max_dense_terms=20)
    ta = ttb.split_tiers(c, dense_threshold=300, max_dense_terms=20)
    for key in ja:
        assert np.array_equal(np.asarray(ja[key]), np.asarray(ta[key]))
    assert ja["dense_tids"].size == 20          # overflow terms went sparse
    jr = jtb.build_dense_rows(c, ja["dense_tids"], imp, n_pad=4096,
                              block=1024, t_pad=32)
    tr = ttb.build_dense_rows(c, ta["dense_tids"], imp, n_pad=4096,
                              block=1024, t_pad=32)
    assert np.array_equal(np.asarray(jr).view(np.int16),
                          tr.view(torch.int16).numpy())


# ---------------------------------------------------------------------------
# K1: sorted-merge candidates
# ---------------------------------------------------------------------------


def _sparse_torch(c):
    return [torch.from_numpy(c[n]) for n in ("docs", "imps", "starts",
                                             "lengths", "idfw")]


@pytest.mark.parametrize("Q,L", [(1, 64), (3, 128), (8, 64)])
def test_merge_candidates_bitwise(Q, L):
    c = sparse_case(Q, S=1, B=8, Q=Q, L=L)
    fn = jax.jit(functools.partial(jsm.bm25_merge_candidates,
                                   n_pad=c["n_pad"], L=L))
    docs, imps, starts, lengths, idfw = _sparse_torch(c)
    for b in range(8):
        want = fn(c["docs"][0], c["imps"][0], c["starts"][b, 0],
                  c["lengths"][b, 0], c["idfw"][b])
        got = tsm.bm25_merge_candidates(docs[0], imps[0], starts[b, 0],
                                        lengths[b, 0], idfw[b],
                                        n_pad=c["n_pad"], L=L)
        for w, g in zip(want, got):
            assert np.array_equal(_bits(w), _bits(g.numpy()))


@pytest.mark.parametrize("Q,L,k,msm", [(1, 64, 100, 1), (3, 128, 10, 1),
                                       (3, 128, 10, 2), (8, 64, 100, 2),
                                       (8, 32, 10, 1)])
def test_topk_merge_body_bitwise(Q, L, k, msm):
    S, B = 4, 8
    c = sparse_case(10 + Q, S=S, B=B, Q=Q, L=L)
    fn = jax.jit(functools.partial(
        jsm.bm25_topk_merge_body, n_pad=c["n_pad"], L=L, k=k,
        min_should_match=msm, with_count=True))
    tin = _sparse_torch(c)
    got_v, got_d, got_c = tsm.sparse_candidates_topk(
        *tin, n_pad=c["n_pad"], L=L, k=k, min_should_match=msm)
    for b in range(B):
        for s in range(S):
            wv, wd, wc = fn(c["docs"][s], c["imps"][s], c["starts"][b, s],
                            c["lengths"][b, s], c["idfw"][b])
            assert np.array_equal(_bits(wv), _bits(got_v[b, s].numpy()))
            assert np.array_equal(np.asarray(wd), got_d[b, s].numpy())
            assert int(wc) == int(got_c[b, s])
            one = tsm.bm25_topk_merge_body(
                tin[0][s], tin[1][s], tin[2][b, s], tin[3][b, s],
                tin[4][b], n_pad=c["n_pad"], L=L, k=k,
                min_should_match=msm, with_count=True)
            assert np.array_equal(_bits(wv), _bits(one[0].numpy()))
            assert np.array_equal(np.asarray(wd), one[1].numpy())
            assert int(wc) == int(one[2])
    assert kb.launches["sparse_candidates_topk"] == 0   # CPU: plain only


def test_gather_dense_for_candidates_bitwise():
    d = dense_case(2, S=1, B=6, Q=5, T=24)
    c = sparse_case(2, S=1, B=6, Q=3, L=64)
    dense_j = _jbf16(d["bits"][0])
    dense_t = _tbf16(d["bits"][0])
    n_pad = c["n_pad"]
    fn = jax.jit(functools.partial(jtb.gather_dense_for_candidates,
                                   n_pad=n_pad))
    for b in range(6):
        sdocs = np.array(jsm.bm25_merge_candidates(
            c["docs"][0], c["imps"][0], c["starts"][b, 0],
            c["lengths"][b, 0], c["idfw"][b], n_pad=n_pad, L=64)[0])
        want = fn(dense_j, sdocs, d["rid"][b, 0], d["w"][b, 0])
        got = ttb.gather_dense_for_candidates(
            dense_t, torch.from_numpy(sdocs),
            torch.from_numpy(d["rid"][b, 0]), torch.from_numpy(d["w"][b, 0]),
            n_pad=n_pad)
        for w, g in zip(want, got):
            assert np.array_equal(_bits(w), _bits(g.numpy()))


# ---------------------------------------------------------------------------
# K2: dense streaming top-k
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,msm,U", [(10, 1, None), (100, 1, 16),
                                     (10, 2, None)])
def test_dense_stream_topk_close(k, msm, U):
    S, B = 2, 8
    d = dense_case(20 + k, S=S, B=B, Q=3, T=32, U=U)
    fn = jax.jit(functools.partial(jtb.dense_stream_topk, k=k + 1,
                                   min_should_match=msm))
    W = torch.from_numpy(d["W"])
    u = None if U is None else torch.from_numpy(d["u_ids"])
    got_v, got_d, got_n = ttb.dense_stream_topk(
        W, _tbf16(d["bits"]), k=k, u_ids=u, min_should_match=msm)
    for s in range(S):
        blocks = d["bits"][s] if U is None else \
            d["bits"][s][:, d["u_ids"][s]]
        wv, wd, wn = (np.asarray(x) for x in
                      fn(d["W"][:, s], _jbf16(blocks)))
        assert np.array_equal(wn, got_n[:, s].numpy())
        assert_topk_close(got_v[:, s].numpy(), got_d[:, s].numpy(),
                          wv[:, :k], wd[:, :k], rtol=RTOL, atol=ATOL,
                          v_next=wv[:, k])


# ---------------------------------------------------------------------------
# K3: top-k merges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k", [(10, 10), (100, 100), (16, 10)])
def test_merge_topk_lists_exact_on_finite_slots(m, k):
    c = topk_lists_case(m, R=10, m=m)
    want_v, want_d = (np.asarray(x) for x in jax.jit(functools.partial(
        jtb.merge_topk_lists, k=k, n_pad=4096))(
        c["a_vals"], c["a_docs"], c["b_vals"], c["b_docs"]))
    got_v, got_d = ttb.merge_topk_lists(
        *(torch.from_numpy(c[n]) for n in ("a_vals", "a_docs", "b_vals",
                                           "b_docs")), k=k, n_pad=4096)
    fin = np.isfinite(want_v)
    assert np.array_equal(_bits(want_v), _bits(got_v.numpy()))
    assert np.array_equal(want_d[fin], got_d.numpy()[fin])
    assert (got_d.numpy()[~fin] == 4096).all()


@pytest.mark.parametrize("n,k", [(1000, 10), (1 << 15, 100)])
def test_batched_blockwise_topk_exact(n, k):
    rng = np.random.RandomState(n)
    scores = rng.choice(np.array([0.0, 1.0, 2.0, 3.0, -np.inf], np.float32),
                        size=(4, n))
    wv, wi = (np.asarray(x) for x in jax.jit(functools.partial(
        jtk.batched_blockwise_topk, k=k))(scores))
    gv, gi = ttk.batched_blockwise_topk(torch.from_numpy(scores), k)
    fin = np.isfinite(wv)
    assert np.array_equal(_bits(wv), _bits(gv.numpy()))
    assert np.array_equal(wi[fin], gi.numpy()[fin])
    # the merge kernel's tie rule is the same selection
    ids = torch.arange(n, dtype=torch.int32).expand(4, n).contiguous()
    mv, mi = ttk.topk_merge(torch.from_numpy(scores), ids, k=k, fill_id=n)
    assert np.array_equal(_bits(wv), _bits(mv.numpy()))
    assert np.array_equal(wi[fin], mi.numpy()[fin])


def test_global_reduce_ties_go_to_lower_global_id():
    from elasticsearch_tpu_torch.parallel.dist_search import \
        _global_topk_reduce
    vals = torch.tensor([[[2.0, 1.0, -np.inf], [2.0, 2.0, 1.0]]])
    docs = torch.tensor([[[5, 1, 8], [0, 3, 2]]], dtype=torch.int32)
    gv, gd = _global_topk_reduce(vals, docs, kk=3, n_pad=8, out_k=4)
    assert gv.tolist() == [[2.0, 2.0, 2.0, 1.0]]
    assert gd.tolist() == [[5, 8, 11, 1]]


# ---------------------------------------------------------------------------
# the tiered per-shard stage as a whole
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Q,k,U", [(3, 10, None), (8, 100, 16)])
def test_tiered_bm25_topk_matches(Q, k, U):
    B, L = 8, 64
    c = sparse_case(30 + Q, S=1, B=B, Q=Q, L=L)
    d = dense_case(30 + Q, S=1, B=B, Q=Q, T=32, U=U)
    blocks = d["bits"][0] if U is None else d["bits"][0][:, d["u_ids"][0]]
    want = jax.jit(functools.partial(
        jtb.tiered_bm25_topk, n_pad=c["n_pad"], L=L, k=k + 1,
        with_count=True))(
        c["docs"][0], c["imps"][0], _jbf16(blocks), c["starts"][:, 0],
        c["lengths"][:, 0], c["idfw"], d["rid"][:, 0], d["w"][:, 0],
        d["W"][:, 0])
    wv, wd, wc = (np.asarray(x) for x in want)
    tin = _sparse_torch(c)
    got_v, got_d, got_c = ttb.tiered_bm25_topk(
        tin[0], tin[1], _tbf16(d["bits"]), tin[2], tin[3], tin[4],
        torch.from_numpy(d["rid"]), torch.from_numpy(d["w"]),
        torch.from_numpy(d["W"]), n_pad=c["n_pad"], L=L, k=k,
        with_count=True,
        u_ids=None if U is None else torch.from_numpy(d["u_ids"]))
    assert np.array_equal(wc, got_c[:, 0].numpy())
    assert_topk_close(got_v[:, 0].numpy(), got_d[:, 0].numpy(), wv[:, :k],
                      wd[:, :k], rtol=RTOL, atol=ATOL, v_next=wv[:, k])
