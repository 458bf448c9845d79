"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and the CUDA toolkit (the kernels build from
``elasticsearch_tpu_torch/csrc`` at first use); elsewhere they skip. They
import no JAX, so on the card's host they run without the repository's
conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import re

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.kernels import build as kb
from elasticsearch_tpu_torch.ops.blockmax import (blockmax_scan,
                                                  blockmax_scan_plain,
                                                  blockmax_scan_plan)
from elasticsearch_tpu_torch.ops.fused_query import (
    BOOL_SPARSE_TILE_SHIFT, BOOL_TILE_SHIFT, K10_COUNT_MAX, K11_COUNT_MAX,
    RESCORE_MODES,
    bisect_exact_scores, bisect_exact_scores_plain, bool_bm25_topk,
    bool_bm25_topk_plain,
    bool_bm25_topk_plan, fuse_rank, fuse_rank_plain, rescore_reorder,
    rescore_reorder_body)
from elasticsearch_tpu_torch.ops.knn import (
    K7_DEEP_MAX, K7_WINDOW_MAX, ivf_rerank, ivf_rerank_plain, ivf_scan,
    ivf_scan_plain, knn_shard_scan, knn_shard_scan_plain)
from elasticsearch_tpu_torch.ops.sorted_merge import (
    SPARSE_TILE_SHIFT, TILE_SHIFT, sparse_candidates_topk,
    sparse_candidates_topk_plain, sparse_candidates_topk_plan)
from elasticsearch_tpu_torch.ops.tiered_bm25 import (
    dense_stream_topk, dense_stream_topk_plain)
from elasticsearch_tpu_torch.ops.topk import topk_merge, topk_merge_plain
from elasticsearch_tpu_torch.parallel.dist_search import (
    DistributedKnnPlane, DistributedSearchPlane, prepare_knn_corpus,
    total_is_lower_bound, total_value)
from elasticsearch_tpu_torch.utils.synth import split_csr_shards
from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast
from elasticsearch_tpu_torch.ops import aggs
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.ops.bm25 import (BM25_TILE, bm25_score,
                                              bm25_score_plain)
from elasticsearch_tpu_torch.ops.masks import (
    postings_match, postings_match_plain, range_mask, range_mask_plain)
from elasticsearch_tpu_torch.ops.topk import masked_topk, masked_topk_plain
from elasticsearch_tpu_torch.search.shard_search import ShardSearcher
from elasticsearch_tpu_torch.xpack import ml as tml
from torch_cases import (agg_pairs_case, assert_topk_close, bool_case,
                         build_segments, csr_case, dense_case, fusion_case,
                         full_tree_arrays, hit_ids, knn_tol, logreg_case,
                         outlier_frame, pairs_case, query_mix,
                         rescore_case, runs_case, sparse_case,
                         topk_lists_case, topk_scores, tree_arrays_case)

pytestmark = pytest.mark.cuda

#: K2 sums the same f32 products as torch.matmul in another order
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("Q,k,msm,tiered,use_u", [
    (1, 10, 1, False, False), (3, 10, 2, False, False),
    (8, 100, 1, False, False), (3, 10, 1, True, False),
    (8, 100, 2, True, True), (3, 200, 1, True, True),
    # a running top-k too long for shared memory; more slots than a block
    # has threads' worth of one-per-thread tables
    (3, 30000, 1, True, True), (300, 10, 1, False, False)])
def test_k1_bitwise_equals_plain(cuda, Q, k, msm, tiered, use_u):
    S, B, L = 2, 8, 256
    c = sparse_case(11 + Q, S=S, B=B, Q=Q, L=L)
    args = [_t(c[n], cuda) for n in ("docs", "imps", "starts", "lengths",
                                     "idfw")]
    kw = dict(n_pad=c["n_pad"], L=L, k=k, min_should_match=msm)
    if tiered:
        d = dense_case(5, S=S, B=B, Q=Q, T=32, U=16 if use_u else None)
        kw.update(dense=_t(d["bits"], cuda).view(torch.bfloat16),
                  dense_rid=_t(d["rid"], cuda), dense_w=_t(d["w"], cuda),
                  u_ids=None if d["u_ids"] is None else
                  _t(d["u_ids"], cuda))
    n0 = kb.launches["sparse_candidates_topk"]
    got = sparse_candidates_topk(*args, **kw)
    assert kb.launches["sparse_candidates_topk"] == n0 + 1
    want = sparse_candidates_topk_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        assert np.array_equal(g, w)


#: K2 cases (k, msm, use_u, dense_case keywords): the four first cases;
#: every query on the same rows; every doc matched (a tile's candidates
#: overflow a query's buffer many times, then merge); 70 queries (a group
#: of 64 and one of 6) and 5 (idle warps); 512 used rows, more than the
#: ring's slot holds (row groups) and more non-zero weights a query than
#: shared memory keeps, with msm 1 and 3; blocks of 1,028 docs (8-byte
#: copies, a ragged last tile)
K2_CASES = [
    (10, 1, False, {}), (100, 1, True, {}), (10, 2, True, {}),
    (2000, 1, True, {}),
    (10, 1, False, dict(B=64, n_pad=1 << 16, C=4096, shared=True)),
    (100, 1, True, dict(density=1.0, n_pad=1 << 15, T=64)),
    (10, 2, False, dict(density=1.0, B=8, Q=3)),
    (10, 1, False, dict(B=70)), (10, 1, True, dict(B=5)),
    (10, 1, True, dict(S=1, Q=128, T=1024, U=512)),
    (10, 3, True, dict(S=1, Q=128, T=1024, U=512)),
    (10, 1, False, dict(n_pad=8224, C=1028))]


@pytest.mark.parametrize("k,msm,use_u,case", K2_CASES)
def test_k2_matches_plain(cuda, monkeypatch, k, msm, use_u, case):
    from elasticsearch_tpu_torch.ops import tiered_bm25 as tb
    kw = dict(S=2, B=20, Q=4, T=48, n_pad=8192, C=2048)
    kw.update(case)
    if use_u:
        kw.setdefault("U", 32)
    S, B = kw["S"], kw["B"]
    d = dense_case(3 + k, **kw)
    dense = _t(d["bits"], cuda).view(torch.bfloat16)
    W = _t(d["W"], cuda)
    u = None if d["u_ids"] is None else _t(d["u_ids"], cuda)
    n0 = kb.launches["dense_stream_topk"]
    got = dense_stream_topk(W, dense, k=k, u_ids=u, min_should_match=msm)
    assert kb.launches["dense_stream_topk"] == n0 + 1
    # the C entry lays out exactly the workspace the plan sizes: one byte
    # less is refused
    plan = tb._k2_launch_plan(B, S, W.shape[2], kw["n_pad"], k,
                              W.device.index)
    monkeypatch.setattr(tb, "_k2_launch_plan",
                        lambda *a: plan[:-1] + (plan[-1] - 1,))
    with pytest.raises(RuntimeError, match="outside the range"):
        dense_stream_topk(W, dense, k=k, u_ids=u, min_should_match=msm)
    monkeypatch.undo()
    assert kb.launches["dense_stream_topk"] == n0 + 1
    want = dense_stream_topk_plain(W, dense, k=k + 1, u_ids=u,
                                   min_should_match=msm)
    torch.cuda.synchronize()
    assert np.array_equal(got[2].cpu().numpy(), want[2].cpu().numpy())
    wv = want[0].cpu().numpy().reshape(B * S, k + 1)
    wd = want[1].cpu().numpy().reshape(B * S, k + 1)
    assert_topk_close(got[0].cpu().numpy().reshape(B * S, k),
                      got[1].cpu().numpy().reshape(B * S, k),
                      wv[:, :k], wd[:, :k], rtol=RTOL, atol=ATOL,
                      v_next=wv[:, k])


@pytest.mark.parametrize("m,k,dedup,seg", [(10, 10, True, False),
                                           (100, 100, True, False),
                                           (64, 10, False, True),
                                           (3000, 100, False, False)])
def test_k3_equals_plain(cuda, m, k, dedup, seg):
    c = topk_lists_case(m, R=12, m=m)
    a = (_t(c["a_vals"], cuda), _t(c["a_docs"], cuda))
    b = (_t(c["b_vals"], cuda), _t(c["b_docs"], cuda)) if dedup else \
        (None, None)
    kw = dict(k=k, dedup=dedup, fill_id=4096)
    if seg:
        kw.update(seg_len=16, seg_stride=4096, fill_id=4096 * (m // 16))
    got = topk_merge(*a, *b, **kw)
    want = topk_merge_plain(*a, *b, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert np.array_equal(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.parametrize("m,k,dedup", [
    (15000, 10000, True),       # a 30000-entry row: device-memory workspace
    (40000, 100, False),
    (10000, 10000, True)])      # a deep page whose row fits shared memory
def test_k3_long_rows_equal_plain(cuda, m, k, dedup):
    n_pad = 1 << 20
    c = topk_lists_case(m, R=4, m=m, n_pad=n_pad)
    a = (_t(c["a_vals"], cuda), _t(c["a_docs"], cuda))
    b = (_t(c["b_vals"], cuda), _t(c["b_docs"], cuda)) if dedup else \
        (None, None)
    kw = dict(k=k, dedup=dedup, fill_id=n_pad)
    got = topk_merge(*a, *b, **kw)
    want = topk_merge_plain(*a, *b, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert np.array_equal(g.cpu().numpy(), w.cpu().numpy())


def _chunk_lists(seed, R, C, k, n_pad=1 << 22):
    """K6-like partial lists [R, C·k]: C lists of k (score desc, row asc)
    with unique rows in a row, randn scores on a 2^-12 grid (ties), a
    -inf tail in a quarter of the lists."""
    rng = np.random.RandomState(seed)
    v = np.round(rng.randn(R, C, k) * 4096) / 4096
    v = v.astype(np.float32)
    ids = np.stack([rng.permutation(n_pad)[:C * k].reshape(C, k)
                    for _ in range(R)]).astype(np.int32)
    tail = rng.rand(R, C) < 0.25
    v[tail, k // 2:] = -np.inf
    order = np.lexsort((ids, -v), axis=-1)
    v = np.take_along_axis(v, order, -1)
    ids = np.where(np.isfinite(v), np.take_along_axis(ids, order, -1), n_pad)
    return v.reshape(R, C * k), ids.reshape(R, C * k).astype(np.int32)


@pytest.mark.parametrize("R,C,k,seg", [
    (64, 33, 128, False),       # the hybrid's old first stage, 64 x 4,224
    (16, 4, 128, False),        # its second, 16 x 512
    (16, 132, 128, False),      # the hybrid's one call now, 16 x 16,896
    (16, 264, 100, False),      # exact kNN's, 16 x 26,400
    (16, 1, 128, True),         # the shard reduce of one shard
    (16, 8, 100, True)])        # and of eight
def test_k3_at_the_hybrid_shapes(cuda, R, C, k, seg):
    """K3 at the kNN paths' shapes equals its plain version bit for bit:
    the chunk reduce over several blocks and a merge, and the shard
    reduces (ids globalised as s · n_pad + row)."""
    n_pad = 1 << 22
    v, ids = _chunk_lists(R + C + k, R, C, k, n_pad)
    kw = dict(k=k, fill_id=n_pad)
    if seg:
        kw.update(seg_len=k, seg_stride=n_pad, fill_id=C * n_pad,
                  with_sel=True)
    n0 = kb.launches["topk_merge"]
    got = topk_merge(_t(v, cuda), _t(ids, cuda), **kw)
    assert kb.launches["topk_merge"] == n0 + 1
    want = topk_merge_plain(_t(v, cuda), _t(ids, cuda), **kw)
    torch.cuda.synchronize()
    _same_bits(got, want)


@pytest.mark.parametrize("case", ["dup_ids", "dup_ids_dedup", "nan",
                                  "fill", "k_past_m", "signed_zero",
                                  "one_key"])
def test_k3_edge_entries(cuda, case):
    """K3 equals its plain version bit for bit where the order leans on
    its last tie-breakers: duplicate ids without dedup (equal values come
    out in column order, over the select's column bytes), with dedup,
    NaN and ids at or past ``fill_id`` (no part), k past the row, -0 and
    +0 (equal values), and one key repeated over a whole row."""
    rng = np.random.RandomState(len(case))
    R, m, k, fill = 6, 3000, 100, 1 << 20
    v = rng.choice(np.array([0.5, 1.0, 2.0, 3.0], np.float32), (R, m))
    ids = rng.randint(0, 40, (R, m)).astype(np.int32)
    kw = dict(k=k, fill_id=fill, with_sel=True)
    if case == "dup_ids_dedup":
        kw.update(dedup=True, with_sel=False)
    elif case == "nan":
        v[rng.rand(R, m) < 0.3] = np.nan
    elif case == "fill":
        ids = rng.randint(0, 200, (R, m)).astype(np.int32)
        kw["fill_id"] = 100
    elif case == "k_past_m":
        v, ids, kw["k"] = v[:, :70], ids[:, :70], 300
    elif case == "signed_zero":
        v = rng.choice(np.array([0.0, -0.0, 1.0, -1.0], np.float32),
                       (R, m))
        ids = rng.randint(0, 1000, (R, m)).astype(np.int32)
    elif case == "one_key":
        v[:], ids[:] = 1.0, 7
    got = topk_merge(_t(v, cuda), _t(ids, cuda), **kw)
    want = topk_merge_plain(_t(v, cuda), _t(ids, cuda), **kw)
    torch.cuda.synchronize()
    _same_bits(got, want)


@pytest.mark.parametrize("R,m,k,dedup", [
    (4, 30000, 128, False),     # a 30,000-entry row over many blocks
    (4, 20000, 100, True),      # 40,000 entries ([a | b]), dedup, merged
    (3, 40000, 2000, False),    # survivors of 4,096, a merge of 8,000
    (1, 1_000_000, 2000, False)])   # the merge past shared memory
def test_k3_long_rows_over_blocks(cuda, R, m, k, dedup):
    """Rows the old kernel held in a device-memory workspace: K3 splits
    them over blocks (and, past shared memory, into its workspace) and
    equals its plain version bit for bit."""
    c = topk_lists_case(m % 97, R=R, m=m, n_pad=1 << 22)
    a = (_t(c["a_vals"], cuda), _t(c["a_docs"], cuda))
    b = (_t(c["b_vals"], cuda), _t(c["b_docs"], cuda)) if dedup else \
        (None, None)
    kw = dict(k=k, dedup=dedup, fill_id=1 << 22, with_sel=not dedup)
    got = topk_merge(*a, *b, **kw)
    want = topk_merge_plain(*a, *b, **kw)
    torch.cuda.synchronize()
    _same_bits(got, want)


def test_kernels_refuse_sizes_beyond_shared_memory(cuda):
    """Sizes whose tables cannot fit one block's shared memory are refused
    with an error that says so, not launched."""
    Q, L = 10000, 16
    z = torch.zeros((1, 1, Q), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="shared memory"):
        sparse_candidates_topk(
            torch.full((1, L), 64, dtype=torch.int32, device=cuda),
            torch.ones((1, L), device=cuda), z, z.clone(),
            torch.ones((1, Q), device=cuda), n_pad=64, L=L, k=10)
    # K2 keeps the staged rows' ids, 4 bytes a column: 60,000 pass 227 KB
    U = 60000
    with pytest.raises(RuntimeError, match="shared memory"):
        dense_stream_topk(torch.ones((1, 1, U), device=cuda),
                          torch.ones((1, 1, U, 4), dtype=torch.bfloat16,
                                     device=cuda), k=10)


def _card_and_host_planes(cuda):
    corpus = synthetic_csr_corpus_fast(np.random.RandomState(9), 1 << 14,
                                       1 << 10, 24)
    corpus["term_ids"] = {f"t{t}": t for t in range(1 << 10)}
    gpu = DistributedSearchPlane([corpus], "body", device=cuda,
                                 dense_threshold=1500)
    cpu = DistributedSearchPlane([corpus], "body", device="cpu",
                                 dense_threshold=1500)
    assert gpu.T_pad > 0
    rng = np.random.RandomState(4)
    df = corpus["df"].astype(np.float64)
    el = np.flatnonzero(df >= 2)
    qs = [[f"t{t}" for t in row]
          for row in rng.choice(el, size=(16, 4), p=df[el] / df[el].sum())]
    return gpu, cpu, qs


def test_plane_serves_deep_pages_on_card(cuda):
    """k = 10000 (Elasticsearch's largest result window) through serve."""
    gpu, cpu, qs = _card_and_host_planes(cuda)
    gv, gh, gt = gpu.serve(qs, k=10000, with_totals=True)
    cv, ch, ct = cpu.serve(qs, k=10000, with_totals=True)
    assert gt == ct
    np.testing.assert_allclose(gv, cv, rtol=RTOL, atol=ATOL)
    assert [len(h) for h in gh] == [len(h) for h in ch]


def test_plane_on_card_matches_plane_on_host(cuda):
    gpu, cpu, qs = _card_and_host_planes(cuda)
    kb.reset_launches()
    for tiered in (None, True):
        gv, gh, gt = gpu.search(qs, k=10, tiered=tiered, with_totals=True)
        cv, ch, ct = cpu.search(qs, k=10, tiered=tiered, with_totals=True)
        assert gt == ct
        np.testing.assert_allclose(gv, cv, rtol=RTOL, atol=ATOL)
        assert [len(h) for h in gh] == [len(h) for h in ch]
    gv, gh = gpu.serve(qs, k=10)
    cv, ch = cpu.serve(qs, k=10)
    np.testing.assert_allclose(gv, cv, rtol=RTOL, atol=ATOL)
    eager = ("sparse_candidates_topk", "dense_stream_topk", "topk_merge")
    assert all(kb.launches[n] > 0 for n in eager), kb.launches


# ---------------------------------------------------------------------------
# K4 (blockmax_scan) and K5 (bisect_exact_scores): exact, on a 2^14-doc
# block-max plane
# ---------------------------------------------------------------------------


def _prune_planes(cuda, S=1, block=None):
    corpus = synthetic_csr_corpus_fast(np.random.RandomState(12), 1 << 14,
                                       1 << 10, 16)
    corpus["term_ids"] = {f"t{t}": t for t in range(1 << 10)}
    shards = split_csr_shards(corpus, S) if S > 1 else [corpus]
    for sh in shards:
        sh["term_ids"] = corpus["term_ids"]
    kw = dict(blockmax={} if block is None else dict(block=block),
              dense_threshold=1 << 30)
    gpu = DistributedSearchPlane(shards, "body", device=cuda, **kw)
    cpu = DistributedSearchPlane(shards, "body", device="cpu", **kw)
    return corpus, gpu, cpu


def _scan_args(plane, prep, k, edit=None):
    a = dict(prep["args"])
    if edit is not None:
        host = {n: a[n].cpu().numpy().copy() for n in ("sched", "rho")}
        edit(host, plane.blockmax.n_blocks)
        a.update({n: torch.from_numpy(v).to(a[n].device)
                  for n, v in host.items()})
    kq = k * prep["Q"]
    kw = dict(n_pad=plane.n_pad, NB=plane.blockmax.n_blocks, W=prep["W"],
              R=prep["R"], kq_idx=min(kq, prep["W"]) - 1,
              prune_active=kq <= prep["W"])
    ins = [a[n] for n in ("t_docs", "t_codes", "t_scale", "t_off", "sched",
                          "w", "rho", "slack")]
    return ins, kw, a


def _first_step_fails(a, NB):
    # every real step after each query's first fails the threshold
    a["rho"][:, :, 1:] = np.where(a["sched"][:, :, 1:] != NB, 0.0,
                                  a["rho"][:, :, 1:])


def _same_bits(got, want):
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        assert np.array_equal(g, w)


@pytest.mark.parametrize("S,k,weighted,edit,rerank", [
    (1, 10, True, None, 8),            # frequent terms: matched > R
    (1, 10, False, None, 8),           # tail terms: matched <= R
    (1, 128, True, None, 8),           # k·Q = 1024: W = 1024, prune active
    (1, 200, True, None, 8),           # k·Q > 1024: prune inert
    (1, 1, True, _first_step_fails, 8),
    (1, 10, True, None, 1),            # R = 64: the window overflows
    (4, 10, True, None, 8)])
def test_k4_equals_plain(cuda, S, k, weighted, edit, rerank):
    corpus, gpu, _ = _prune_planes(cuda, S)
    gpu.prune_rerank = rerank
    qs = query_mix(corpus, 20 + k, 6, weighted=weighted) + [[]]
    prep = gpu.prepare_pruned(qs, k)
    ins, kw, _ = _scan_args(gpu, prep, k, edit)
    acc = gpu.blockmax.scan_workspace(len(qs) * S, cuda)
    n0 = kb.launches["blockmax_scan"]
    got = blockmax_scan(*ins, **kw, acc=acc)
    assert kb.launches["blockmax_scan"] == n0 + 1
    want = blockmax_scan_plain(*ins, **kw)
    torch.cuda.synchronize()
    _same_bits(got, want)
    assert not acc.any(), "the workspace was not left zeroed"
    # a second launch on the same workspace gives the same answer
    _same_bits(blockmax_scan(*ins, **kw, acc=acc), want)
    matched = got[2].cpu().numpy()
    if rerank == 1:
        assert (matched > prep["R"]).any() and got[3].sum() > 0
    if edit is not None:
        assert got[4].sum() > 0


@pytest.mark.parametrize("case", ["slices", "stops_early", "runs_into_pad",
                                  "few_docs", "doc_order", "odd_block",
                                  "wide_block"])
def test_k4_scan_and_survivors_equal_plain(cuda, case):
    """K4 in every output against its plain version, the workspace zero
    after the call, on: G > 1 survivor slices a row (and the plan's G at
    this batch); a schedule that stops after its first step or two; pruning inert
    (k·Q > W), every schedule run into its pad; tail terms, R greater than
    the docs a row sees; each tier block's entries in doc order rather
    than the tier's impact order; a tier block of 30 postings (its codes
    not copied four bytes at a time) and of 1,000 (the scan's widest
    block). The schedules of the weighted mixes put a doc in consecutive
    steps (blocks of several terms over 2^14 docs), so a line prefetched
    ahead is often written again before its step reads it."""
    block = {"odd_block": 30, "wide_block": 1000}.get(case)
    corpus, gpu, _ = _prune_planes(cuda, 1, block)
    k = 200 if case == "runs_into_pad" else 10
    weighted = case != "few_docs"
    qs = query_mix(corpus, 40 + len(case), 20, weighted=weighted,
                   terms=8 if case == "runs_into_pad" else 4)
    prep = gpu.prepare_pruned(qs, k)
    edit = _first_step_fails if case == "stops_early" else None
    ins, kw, _ = _scan_args(gpu, prep, k, edit)
    if case == "doc_order":
        docs, order = torch.sort(ins[0], dim=-1, stable=True)
        ins[:2] = [docs.contiguous(),
                   torch.gather(ins[1], -1, order).contiguous()]
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    G = blockmax_scan_plan(len(qs), 1, prep["R"], n_sm)["G"]
    assert G > 1
    acc = gpu.blockmax.scan_workspace(len(qs), cuda)
    n0 = kb.launches["blockmax_scan"]
    got = blockmax_scan(*ins, **kw, acc=acc)
    assert kb.launches["blockmax_scan"] == n0 + 1
    want = blockmax_scan_plain(*ins, **kw)
    torch.cuda.synchronize()
    _same_bits(got, want)
    assert not acc.any(), "the workspace was not left zeroed"
    _same_bits(blockmax_scan(*ins, **kw, acc=acc), want)
    matched, _unsafe, pruned, n_sc = (x.cpu().numpy()[:, 0]
                                      for x in got[2:])
    lens = prep["sched_lens"][:, 0]
    if case == "stops_early":
        # the second step fails unless the slack keeps theta at or below 0
        # after the first, and then the third does
        assert pruned.all() and (n_sc <= 2).all() and (n_sc == 1).any()
    if case == "runs_into_pad":
        assert not kw["prune_active"] and (n_sc == lens).all()
    if case == "few_docs":
        assert (matched < prep["R"]).any()
    if case in ("slices", "doc_order", "odd_block"):
        assert n_sc.max() > 11           # past the ring's 11 slots


@pytest.mark.parametrize("S", [1, 4])
def test_k5_bitwise_equals_plain(cuda, S):
    corpus, gpu, _ = _prune_planes(cuda, S)
    qs = query_mix(corpus, 30, 8, weighted=True) + [["t3", "t3"], []]
    prep = gpu.prepare_pruned(qs, 10)
    ins, kw, a = _scan_args(gpu, prep, 10)
    ci = blockmax_scan(*ins, **kw)[0]
    ci[:, :, -3:] = gpu.n_pad - 1          # a doc in no run
    ci[:, :, 0] = gpu.n_pad                # an empty slot
    ci = torch.sort(ci, dim=-1).values
    x = (a["postings_docs"], a["postings_impact"], a["starts"],
         a["lengths"], a["idfw"], ci.contiguous())
    n0 = kb.launches["bisect_exact_scores"]
    got = bisect_exact_scores(*x, n_pad=gpu.n_pad)
    assert kb.launches["bisect_exact_scores"] == n0 + 1
    want = bisect_exact_scores_plain(*x, n_pad=gpu.n_pad)
    torch.cuda.synchronize()
    _same_bits(got, want)


def _k5_args(c, cuda):
    return [_t(c[n], cuda) for n in ("postings_docs", "postings_impact",
                                     "starts", "lengths", "idfw",
                                     "cand_docs")]


@pytest.mark.parametrize("S,B,R,R2", [(1, 16, 128, 128), (2, 3, 40, 7),
                                      (1, 64, 100, 100), (3, 2, 5, 300)])
def test_k5_two_lists_bitwise_equal_two_plain_calls(cuda, S, B, R, R2):
    """One launch scores both lists (the hybrid rescore's text and kNN
    candidates, a fifth of the kNN entries at -inf) bitwise as two plain
    calls do; without values every second-list entry below n_pad is live.
    Lists that straddle a block's candidates included."""
    c = runs_case(R + R2, S=S, B=B, Q=8, R=R, R2=R2,
                  lengths=(0, 1, 5, 127, 128, 129, 1025, 40000))
    x = _k5_args(c, cuda)
    d2, v2 = _t(c["cand_docs2"], cuda), _t(c["cand_vals2"], cuda)
    n0 = kb.launches["bisect_exact_scores"]
    got = bisect_exact_scores(*x, n_pad=c["n_pad"], cand_docs2=d2,
                              cand_vals2=v2)
    assert kb.launches["bisect_exact_scores"] == n0 + 1
    live2 = torch.where(v2 > -np.inf, d2, torch.full_like(d2, c["n_pad"]))
    want = bisect_exact_scores_plain(*x, n_pad=c["n_pad"]) + \
        bisect_exact_scores_plain(*x[:5], live2, n_pad=c["n_pad"])
    torch.cuda.synchronize()
    assert len(got) == 4
    _same_bits(got, want)
    assert got[1].any() and got[3].any()
    got = bisect_exact_scores(*x, n_pad=c["n_pad"], cand_docs2=d2)
    _same_bits(got[2:], bisect_exact_scores_plain(*x[:5], d2,
                                                  n_pad=c["n_pad"]))


#: K5's pivots a slot (T), read from its source
K5_PIVOTS = int(re.search(r"^#define K5_PIVOTS (\d+)$", (
    kb.CSRC_DIR / "bisect_exact_scores.cu").read_text(), re.M)[1])


@pytest.mark.parametrize("Q", [1, 2, 8, 256, 257, 1024, 1500, 4096])
def test_k5_slots_and_long_runs_equal_plain(cuda, Q):
    """Q of 1, 2 and 8, one chunk of slots (256), one past it, and up to
    16 chunks, over runs of 0, 1, T - 1, T, T + 1 docs and up to 2^20:
    open segments of every width, candidates at runs' ends and between
    their docs, n_pad and n_pad - 1; past a chunk the sum is carried from
    chunk to chunk in the plain version's order."""
    T = K5_PIVOTS
    lengths = (0, 1, 2, T - 1, T, T + 1, 32 * T - 1, 32 * T + 1, 70001,
               1 << 20)
    B, R = (4, 64) if Q <= 8 else (2, 3)
    c = runs_case(Q, S=2, B=B, Q=Q, R=R, lengths=lengths)
    x = _k5_args(c, cuda)
    n0 = kb.launches["bisect_exact_scores"]
    got = bisect_exact_scores(*x, n_pad=c["n_pad"])
    assert kb.launches["bisect_exact_scores"] == n0 + 1
    want = bisect_exact_scores_plain(*x, n_pad=c["n_pad"])
    torch.cuda.synchronize()
    _same_bits(got, want)
    assert got[1].any()


def test_k5_refuses_sizes_outside_its_range(cuda):
    """The C entry refuses a second list's length without its docs, a
    negative size, and more blocks of a pair's candidates than a grid's
    second axis holds; a launch inside them is served."""
    c = runs_case(4, S=1, B=1, Q=8, R=4, lengths=(3, 9))
    x = _k5_args(c, cuda)
    out = torch.empty((1, 1, 4), device=cuda)
    fnd = torch.empty((1, 1, 4), dtype=torch.bool, device=cuda)

    def call(R2, Q, R=4):
        kb.launch("bisect_exact_scores", cuda, x[0].data_ptr(),
                  x[1].data_ptr(), x[0].shape[1], x[2].data_ptr(),
                  x[3].data_ptr(), x[4].data_ptr(), x[5].data_ptr(), R,
                  None, None, R2, 1, 1, Q, c["n_pad"], out.data_ptr(),
                  fnd.data_ptr(), out.data_ptr(), fnd.data_ptr())
    # 65,536 blocks of one candidate: a full chunk caps RC at 8
    for R2, Q, R in ((4, 8, 4), (0, -1, 4), (0, 8, -1),
                     (0, 4096, 8 * 65535 + 1)):
        with pytest.raises(RuntimeError, match="bisect_exact_scores: launch "
                                               "refused: a size argument"):
            call(R2, Q, R)
    call(0, 8)
    torch.cuda.synchronize()
    _same_bits((out, fnd), bisect_exact_scores_plain(*x, n_pad=c["n_pad"]))


def test_k4_k5_refuse_wrong_dtypes(cuda):
    corpus, gpu, _ = _prune_planes(cuda)
    qs = query_mix(corpus, 31, 2, weighted=True)
    prep = gpu.prepare_pruned(qs, 10)
    ins, kw, a = _scan_args(gpu, prep, 10)
    bad = list(ins)
    bad[1] = bad[1].to(torch.int32)        # codes must be int8
    with pytest.raises(TypeError):
        blockmax_scan(*bad, **kw)
    bad = list(ins)
    bad[6] = bad[6].double()               # rho must be f32
    with pytest.raises(TypeError):
        blockmax_scan(*bad, **kw)
    ci = blockmax_scan(*ins, **kw)[0]
    with pytest.raises(TypeError):
        bisect_exact_scores(a["postings_docs"], a["postings_impact"],
                            a["starts"], a["lengths"], a["idfw"],
                            ci.long(), n_pad=gpu.n_pad)


@pytest.mark.parametrize("S", [1, 4])
def test_pruned_route_on_card_matches_host(cuda, S):
    """``serve`` on the pruned route: the card's kernels against the
    plain versions on the host (bitwise, hits and totals equal), and
    against the card's own eager step."""
    corpus, gpu, cpu = _prune_planes(cuda, S)
    qs = query_mix(corpus, 32, 12, weighted=True) + \
        query_mix(corpus, 33, 4, weighted=False)
    kb.reset_launches()
    gv, gh, gt = gpu.serve(qs, k=10, with_totals=True)
    assert all(kb.launches[n] > 0 for n in
               ("blockmax_scan", "bisect_exact_scores", "topk_merge"))
    cv, ch, ct = cpu.serve(qs, k=10, with_totals=True)
    assert np.array_equal(np.asarray(gv).view(np.int32),
                          np.asarray(cv).view(np.int32))
    assert gh == ch and gt == ct
    ev, eh, et = gpu.serve(qs, k=10, with_totals=True, prune=False)
    assert np.array_equal(np.asarray(gv).view(np.int32),
                          np.asarray(ev).view(np.int32))
    assert gh == eh
    assert all(total_value(p) == e or (total_is_lower_bound(p)
                                       and total_value(p) <= e)
               for p, e in zip(gt, et))


def test_scan_workspace_is_one_streams_and_dropped_on_failure(cuda,
                                                             monkeypatch):
    """K4's accumulator workspace is shared by the plane's dispatches on
    one stream: another stream is refused, and a dispatch that raises
    drops it, so the next one starts from a zeroed workspace."""
    from elasticsearch_tpu_torch.parallel import dist_search
    corpus, gpu, cpu = _prune_planes(cuda)
    qs = query_mix(corpus, 34, 4, weighted=True)
    want = cpu.serve(qs, k=10, with_totals=True)
    gpu.serve(qs, k=10)
    tier = gpu.blockmax
    assert tier._acc is not None
    with torch.cuda.stream(torch.cuda.Stream()):
        with pytest.raises(RuntimeError, match="another CUDA stream"):
            gpu.serve(qs, k=10)
    tier._acc.fill_(1.0)                   # as a dispatch cut part way would

    def cut(*a, **kw):
        raise RuntimeError("cut")

    monkeypatch.setattr(dist_search, "pruned_bm25_step", cut)
    with pytest.raises(RuntimeError, match="cut"):
        gpu.serve(qs, k=10)
    assert tier._acc is None
    monkeypatch.undo()
    got = gpu.serve(qs, k=10, with_totals=True)
    assert np.array_equal(np.asarray(got[0]).view(np.int32),
                          np.asarray(want[0]).view(np.int32))
    assert got[1:] == want[1:]
    with torch.cuda.stream(torch.cuda.Stream()):
        gpu.blockmax.drop_workspace()
        assert gpu.serve(qs, k=10, with_totals=True)[1:] == want[1:]


# ---------------------------------------------------------------------------
# K6 (knn_scan), K7 (ivf_scan), K8 (ivf_rerank): within the parity bar's
# tolerance of their plain versions (the plain products sum in cuBLAS's
# order, the kernels in ascending d)
# ---------------------------------------------------------------------------


def _knn_case(cuda, *, S, n, D, B, similarity, seed=0, every_third=False):
    """Packed shards with duplicates of row 3, ``exists`` holes (random, or
    every third row) and whole missing tiles, and queries whose first is
    row 3."""
    rng = np.random.RandomState(seed)
    raw = rng.randn(S, n, D).astype(np.float32)
    raw[0, 50:60] = raw[0, 3]
    raw[S - 1, n - 9] = raw[0, 3]
    exists = rng.rand(S, n) > 0.15
    if every_third:
        exists = np.arange(n)[None, :].repeat(S, 0) % 3 != 2
    exists[:, n // 2 + 128: n // 2 + 1024] = False
    exists[0, 3] = exists[0, 50:60] = exists[S - 1, n - 9] = True
    vecs, vn = prepare_knn_corpus(raw, similarity)
    vecs[~exists] = 0.0
    vn[~exists] = 0.0
    q = rng.randn(B, D).astype(np.float32)
    q[0] = raw[0, 3]
    qq = q / np.linalg.norm(q, axis=1, keepdims=True) \
        if similarity == "cosine" else q
    qn = np.sum(q * q, axis=1)
    args = [_t(x, cuda) for x in (vecs, vn, exists, qq.astype(np.float32),
                                  qn.astype(np.float32))]
    return args, knn_tol(q, raw, similarity)


def _topk_ties_ascend(v, i):
    v, i = np.asarray(v), np.asarray(i)
    tie = (v[..., 1:] == v[..., :-1]) & np.isfinite(v[..., 1:])
    assert (i[..., 1:][tie] > i[..., :-1][tie]).all()


@pytest.mark.parametrize("similarity,D,B,k,n,every_third", [
    ("cosine", 100, 16, 100, 1 << 14, False),
    ("dot_product", 12, 5, 10, 1 << 14, False),
    ("l2_norm", 7, 37, 32, 1 << 14, False),
    ("l2_norm", 100, 16, 100, 1 << 14, False),
    # BEIR/NQ width (the hybrid configuration's, and its 128-wide window)
    ("cosine", 768, 8, 10, 1 << 14, False),
    ("dot_product", 768, 16, 128, 1 << 14, False),
    # lists past shared memory, in device memory
    ("dot_product", 16, 3, 10000, 1 << 14, False),
    # the hybrid's shape; the exact route's with every third row missing;
    # rows not a multiple of the row tile; a ragged query tile
    ("dot_product", 768, 16, 100, 1 << 14, False),
    ("cosine", 100, 16, 100, 1 << 14, True),
    ("l2_norm", 100, 16, 100, 5000, False),
    ("dot_product", 100, 17, 100, 1 << 14, False)])
def test_k6_matches_plain(cuda, similarity, D, B, k, n, every_third):
    S = 2
    args, tol = _knn_case(cuda, S=S, n=n, D=D, B=B, similarity=similarity,
                          every_third=every_third)
    n0 = kb.launches["knn_scan"]
    gv, gi = knn_shard_scan(*args, similarity=similarity, kk=k)
    assert kb.launches["knn_scan"] == n0 + 1
    wv, wi = knn_shard_scan_plain(*args, similarity=similarity, kk=k + 1)
    torch.cuda.synchronize()
    gv, gi, wv, wi = (x.cpu().numpy() for x in (gv, gi, wv, wi))
    for s in range(S):
        assert_topk_close(gv[:, s], gi[:, s], wv[:, s, :k], wi[:, s, :k],
                          rtol=0.0, atol=tol, v_next=wv[:, s, k])
    _topk_ties_ascend(gv, gi)
    # the duplicates of row 3 score bitwise alike, rows ascending
    row = gi[0, 0]
    dup = np.isin(row, [3] + list(range(50, 60)))
    if dup.any():
        assert len(set(gv[0, 0][dup].view(np.int32).tolist())) == 1
        assert (np.diff(row[dup]) > 0).all()


def _ivf_planes(cuda, similarity, quant, n=1 << 14, D=32, seed=3, B=16,
                S=2, ties=10):
    """A clustered corpus packed on the host in S shards, and the same
    packed state on the card (one tier, whichever device assigned its
    clusters); B queries, the first on row 7, which rows 100 .. 100 + ties
    duplicate (past 10 ties, three times row 7: the first query's best
    rows)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(64, D).astype(np.float32)
    vecs = centers[rng.randint(0, 64, n)] + \
        0.35 * rng.randn(n, D).astype(np.float32)
    vecs[100:100 + ties] = vecs[7] * np.float32(1.0 if ties <= 10 else 3.0)
    cut = np.linspace(0, n, S + 1).astype(int)
    cpu = DistributedKnnPlane([dict(vectors=vecs[lo:hi])
                               for lo, hi in zip(cut[:-1], cut[1:])],
                              similarity=similarity,
                              ivf=dict(nlist=64, quant=quant, seed=1),
                              device="cpu")
    gpu = DistributedKnnPlane.from_packed(cpu.export_packed(), device=cuda)
    qs = vecs[rng.randint(0, n, B)] + \
        0.15 * rng.randn(B, D).astype(np.float32)
    qs[0] = vecs[7]
    return cpu, gpu, qs.astype(np.float32), knn_tol(qs, vecs, similarity)


@pytest.mark.parametrize("similarity,quant,nprobe,rerank,B,S,D", [
    ("dot_product", "int8", 8, 4, 16, 2, 32),
    ("cosine", "int8", 8, 4, 16, 2, 32),
    ("l2_norm", "int8", 8, 4, 16, 2, 32),
    ("cosine", "bf16", 8, 4, 16, 2, 32),
    # every cluster, a window past K7's window path (the deep path, 4,000)
    ("l2_norm", "int8", 64, 400, 16, 2, 32),
    ("cosine", "bf16", 32, 400, 16, 1, 32),
    # past 16,384 (every row of the shard: the window holds the union)
    ("dot_product", "int8", 64, 1700, 16, 1, 32),
    # fewer queries than a query tile; three shards; every cluster probed
    # into a small window; a window of 1,000 (a part's list past a few
    # hundred); d not a multiple of a 16-byte load
    ("dot_product", "int8", 8, 4, 5, 2, 32),
    ("l2_norm", "bf16", 8, 4, 16, 3, 32),
    ("cosine", "int8", 64, 4, 16, 2, 32),
    ("dot_product", "int8", 16, 100, 16, 2, 32),
    ("l2_norm", "int8", 8, 4, 16, 2, 36),
    ("cosine", "bf16", 8, 4, 40, 1, 20)])
def test_k7_k8_match_plain(cuda, similarity, quant, nprobe, rerank, B, S,
                           D):
    cpu, gpu, qs, tol = _ivf_planes(cuda, similarity, quant, B=B, S=S, D=D)
    prep = gpu.prepare_ivf(qs, 10, nprobe=nprobe, rerank=rerank)
    a, R = prep["args"], prep["r_cand"]
    q = a["q"]
    qq = q / q.norm(dim=1, keepdim=True) if similarity == "cosine" else q
    qsum, qn = qq.sum(1), (q * q).sum(1)
    l2 = similarity == "l2_norm"
    ins = (a["codes"], a["scale"], a["off"], a["rowid"], a["rcl"],
           a["vnorm2"], qq, qsum, qn, a["probed"], a["u_blocks"])
    kw = dict(l2=l2, n_pad=gpu.n_pad)
    n0 = dict(kb.launches)
    wv, wp = ivf_scan(*ins, **kw, nlist=gpu.ivf.nlist, r_cand=R)
    pv, pp = ivf_scan_plain(*ins, **kw, r_cand=R + 1)
    torch.cuda.synchronize()
    g = [x.cpu().numpy() for x in (wv, wp, pv, pp)]
    for s in range(gpu.n_shards):
        assert_topk_close(g[0][:, s], g[1][:, s], g[2][:, s, :R],
                          g[3][:, s, :R], rtol=0.0, atol=tol,
                          v_next=g[2][:, s, R])
    _topk_ties_ascend(g[0], g[1])
    ex, rows = ivf_rerank(wv, wp, a["u_blocks"], a["rowid"], a["vecs"],
                          a["vnorm2"], qq, qn, l2=l2, n_pad=gpu.n_pad)
    ex_p, rows_p = ivf_rerank_plain(wv, wp, a["u_blocks"], a["rowid"],
                                    a["vecs"], a["vnorm2"], qq, qn, l2=l2,
                                    n_pad=gpu.n_pad)
    torch.cuda.synchronize()
    assert kb.launches["ivf_scan"] == n0["ivf_scan"] + 1
    assert kb.launches["ivf_rerank"] == n0["ivf_rerank"] + 1
    # one call at any window (no K3); a window of either path is bitwise
    # the head of a deeper one (both are exact)
    assert kb.launches["topk_merge"] == n0["topk_merge"]
    R2 = max(2 * R, K7_WINDOW_MAX + 1)
    dv, dp = ivf_scan(*ins, **kw, nlist=gpu.ivf.nlist, r_cand=R2)
    _same_bits((wv, wp), (dv[:, :, :R].contiguous(),
                          dp[:, :, :R].contiguous()))
    assert torch.equal(rows, rows_p)
    e, ep = ex.cpu().numpy(), ex_p.cpu().numpy()
    assert np.array_equal(np.isfinite(e), np.isfinite(ep))
    f = np.isfinite(e)
    np.testing.assert_allclose(e[f], ep[f], rtol=0.0, atol=tol)


@pytest.mark.parametrize("similarity,nprobe,k,rerank,B", [
    ("dot_product", 32, 10, 400, 16),  # 4,000 of about 32k probed rows
    ("l2_norm", 32, 10, 2000, 16),     # 20,000: past 16,384, rows dropped
    ("cosine", 64, 1000, 40, 16),      # serve(k = 10,000)'s shape, 40,000
    ("dot_product", 8, 100, 11, 16),   # 1,100 of about 8k
    # more queries than the grid's blocks: one part a query, several
    # units a block
    ("dot_product", 16, 10, 300, 150)])
def test_k7_deep_path_matches_plain(cuda, similarity, nprobe, k, rerank, B):
    """The deep path on 2^16 rows in one shard: within the bar of the plain
    version, equal scores in ascending position order, one launch and no
    K3, and bitwise the head of a deeper window."""
    cpu, gpu, qs, tol = _ivf_planes(cuda, similarity, "int8", n=1 << 16,
                                    S=1, B=B)
    prep = gpu.prepare_ivf(qs, k, nprobe=nprobe, rerank=rerank)
    a, R = prep["args"], prep["r_cand"]
    assert R > K7_WINDOW_MAX
    q = a["q"]
    qq = q / q.norm(dim=1, keepdim=True) if similarity == "cosine" else q
    ins = (a["codes"], a["scale"], a["off"], a["rowid"], a["rcl"],
           a["vnorm2"], qq, qq.sum(1), (q * q).sum(1), a["probed"],
           a["u_blocks"])
    kw = dict(l2=similarity == "l2_norm", n_pad=gpu.n_pad,
              nlist=gpu.ivf.nlist)
    n0 = dict(kb.launches)
    wv, wp = ivf_scan(*ins, **kw, r_cand=R)
    torch.cuda.synchronize()
    assert kb.launches["ivf_scan"] == n0["ivf_scan"] + 1
    assert kb.launches["topk_merge"] == n0["topk_merge"]
    pv, pp = ivf_scan_plain(*ins, l2=kw["l2"], n_pad=gpu.n_pad,
                            r_cand=R + 1)
    g = [x.cpu().numpy() for x in (wv, wp, pv, pp)]
    assert_topk_close(g[0][:, 0], g[1][:, 0], g[2][:, 0, :R],
                      g[3][:, 0, :R], rtol=0.0, atol=tol,
                      v_next=g[2][:, 0, R])
    _topk_ties_ascend(g[0], g[1])
    fill = a["u_blocks"].shape[1] * a["rowid"].shape[-1]
    assert (g[1][~np.isfinite(g[0])] == fill).all()
    dv, dp = ivf_scan(*ins, **kw, r_cand=R + 777)
    _same_bits((wv, wp), (dv[:, :, :R].contiguous(),
                          dp[:, :, :R].contiguous()))


def test_k7_deep_path_refines_crowded_buckets(cuda):
    """6,000 equal rows, three times the first query: its best 6,000 keys
    share their score bits, so the window of 2,000 passes the survivor buffer at
    every score digit and is settled on the positions' digits (the deep
    path's later levels); ties in ascending position, bitwise the head of
    a window whose survivors fit at once."""
    cpu, gpu, qs, tol = _ivf_planes(cuda, "dot_product", "int8",
                                    n=1 << 15, S=1, ties=6000)
    prep = gpu.prepare_ivf(qs, 10, nprobe=16, rerank=200)
    a, R = prep["args"], prep["r_cand"]
    assert R == 2000
    q = a["q"]
    ins = (a["codes"], a["scale"], a["off"], a["rowid"], a["rcl"],
           a["vnorm2"], q, q.sum(1), (q * q).sum(1), a["probed"],
           a["u_blocks"])
    kw = dict(l2=False, n_pad=gpu.n_pad, nlist=gpu.ivf.nlist)
    wv, wp = ivf_scan(*ins, **kw, r_cand=R)
    pv, pp = ivf_scan_plain(*ins, l2=False, n_pad=gpu.n_pad, r_cand=R + 1)
    torch.cuda.synchronize()
    g = [x.cpu().numpy() for x in (wv, wp, pv, pp)]
    assert (g[0][0, 0] == g[0][0, 0, 0]).all()     # all ties
    assert (np.diff(g[1][0, 0]) > 0).all()
    assert_topk_close(g[0][:, 0], g[1][:, 0], g[2][:, 0, :R],
                      g[3][:, 0, :R], rtol=0.0, atol=tol,
                      v_next=g[2][:, 0, R])
    dv, dp = ivf_scan(*ins, **kw, r_cand=4 * R)
    _same_bits((wv, wp), (dv[:, :, :R].contiguous(),
                          dp[:, :, :R].contiguous()))


@pytest.mark.parametrize("B", [32, 40])
def test_k7_window_serves_nlist_2_16(cuda, B):
    """At nlist 2^16 a tile of 32 queries' probe bitmaps would pass the
    shared memory a block may have; the window path builds them 16 queries
    at a time, so it serves the shape, bitwise the window of nlist 64 (the
    probed ids are below 64) and within the bar of the plain version."""
    cpu, gpu, qs, tol = _ivf_planes(cuda, "dot_product", "int8", B=B)
    prep = gpu.prepare_ivf(qs, 10, nprobe=8, rerank=4)
    a, R = prep["args"], prep["r_cand"]
    q = a["q"]
    ins = [a["codes"], a["scale"], a["off"], a["rowid"], a["rcl"],
           a["vnorm2"], q, q.sum(1), (q * q).sum(1), a["probed"],
           a["u_blocks"]]
    kw = dict(l2=False, n_pad=gpu.n_pad, r_cand=R)
    n0 = dict(kb.launches)
    got = ivf_scan(*ins, **kw, nlist=1 << 16)
    torch.cuda.synchronize()
    assert kb.launches["ivf_scan"] == n0["ivf_scan"] + 1
    assert kb.launches["topk_merge"] == n0["topk_merge"]
    _same_bits(got, ivf_scan(*ins, **kw, nlist=gpu.ivf.nlist))
    pv, pp = ivf_scan_plain(*ins, l2=False, n_pad=gpu.n_pad, r_cand=R + 1)
    wv, wp = (t.cpu().numpy() for t in got)
    pv, pp = pv.cpu().numpy(), pp.cpu().numpy()
    for s in range(wv.shape[1]):
        assert_topk_close(wv[:, s], wp[:, s], pv[:, s, :R], pp[:, s, :R],
                          rtol=0.0, atol=tol, v_next=pv[:, s, R])


def test_knn_kernels_refuse_what_they_cannot_launch(cuda):
    """Probe bitmaps too large for shared memory are refused with the
    library's message; a window past K7_DEEP_MAX is refused by name;
    wrong types raise before a launch."""
    cpu, gpu, qs, _ = _ivf_planes(cuda, "dot_product", "int8")
    prep = gpu.prepare_ivf(qs, 10, nprobe=8, rerank=4)
    a = prep["args"]
    q = a["q"]
    ins = [a["codes"], a["scale"], a["off"], a["rowid"], a["rcl"],
           a["vnorm2"], q, q.sum(1), (q * q).sum(1), a["probed"],
           a["u_blocks"]]
    with pytest.raises(RuntimeError, match="shared memory"):
        ivf_scan(*ins, l2=False, n_pad=gpu.n_pad, nlist=1 << 17, r_cand=40)
    with pytest.raises(ValueError, match="K7_DEEP_MAX"):
        ivf_scan(*ins, l2=False, n_pad=gpu.n_pad, nlist=64,
                 r_cand=K7_DEEP_MAX + 1)
    bad = list(ins)
    bad[0] = bad[0].to(torch.int32)
    with pytest.raises(TypeError):
        ivf_scan(*bad, l2=False, n_pad=gpu.n_pad, nlist=64, r_cand=40)
    vecs, vn, exists = gpu._device_arrays()
    with pytest.raises(TypeError):
        knn_shard_scan(vecs.double(), vn, exists, q, q.sum(1),
                       similarity="dot_product", kk=10)


@pytest.mark.parametrize("similarity,quant", [
    ("dot_product", "int8"), ("cosine", "int8"), ("l2_norm", "bf16")])
def test_knn_plane_on_card_matches_plane_on_host(cuda, similarity, quant):
    """``serve`` on the card (exact and IVF, k = 10 and 10000) against the
    host plane with the same packed state; each path launches its
    kernels; with every cluster probed and a covering window the IVF route
    gives the exact route's values bitwise (K8 sums as K6 does)."""
    cpu, gpu, qs, tol = _ivf_planes(cuda, similarity, quant)
    for nprobe, kernels in ((0, ("knn_scan", "topk_merge")),
                            (None, ("ivf_scan", "ivf_rerank", "topk_merge"))):
        for k in (10, 10000):
            kb.reset_launches()
            st = {}
            gv, gh = gpu.serve(qs, k=k, nprobe=nprobe, stages=st)
            assert all(kb.launches[n] > 0 for n in kernels), kb.launches
            assert st["kernel"] == ("knn_exact" if nprobe == 0 else
                                    "knn_ivf")
            cv, ch = cpu.serve(qs, k=k + 1, nprobe=nprobe)
            ch = [h[:k] for h in ch]
            assert [len(h) for h in gh] == [len(h) for h in ch]
            assert_topk_close(gv, hit_ids(gh, gpu.n_pad, k), cv[:, :k],
                              hit_ids(ch, cpu.n_pad, k), rtol=0.0,
                              atol=tol, v_next=cv[:, k])
    full = gpu.serve(qs, k=50, nprobe=gpu.ivf.nlist, rerank=10000)
    exact = gpu.serve(qs, k=50, nprobe=0)
    assert np.array_equal(full[0].view(np.int32), exact[0].view(np.int32))
    assert full[1] == exact[1]


def test_k6_k8_tie_duplicate_rows_bitwise_at_768(cuda):
    """At the hybrid's width, duplicate rows score bitwise alike in the
    exact scan (K6) and the full-probe IVF re-rank (K8), and the two
    routes give every hit the same bits."""
    cpu, gpu, qs, _ = _ivf_planes(cuda, "dot_product", "int8", n=1 << 12,
                                  D=768)
    exact = gpu.serve(qs, k=50, nprobe=0)
    full = gpu.serve(qs, k=50, nprobe=gpu.ivf.nlist, rerank=10000)
    assert np.array_equal(full[0].view(np.int32), exact[0].view(np.int32))
    assert full[1] == exact[1]
    # query 0 is row 7, duplicated at rows 100..109 of shard 0
    dup = [i for i, h in enumerate(exact[1][0])
           if h[0] == 0 and h[1] in [7] + list(range(100, 110))]
    assert len(dup) == 11
    assert len(set(exact[0][0][dup].view(np.int32).tolist())) == 1


def test_card_pack_assigns_clusters_as_the_host_mostly(cuda):
    """The card's k-means (f32 products, TF32 off) packs a tier whose
    clusters differ from the host's numpy pack in few rows."""
    rng = np.random.RandomState(5)
    centers = rng.randn(32, 24).astype(np.float32)
    vecs = centers[rng.randint(0, 32, 4096)] + \
        0.35 * rng.randn(4096, 24).astype(np.float32)
    ivf = dict(nlist=32, seed=2)
    gpu = DistributedKnnPlane([dict(vectors=vecs)], similarity="l2_norm",
                              ivf=ivf, device=cuda)
    cpu = DistributedKnnPlane([dict(vectors=vecs)], similarity="l2_norm",
                              ivf=ivf, device="cpu")
    np.testing.assert_allclose(gpu.ivf.centroids, cpu.ivf.centroids,
                               rtol=1e-4, atol=1e-4)
    ga = np.empty(4096, np.int32)
    ca = np.empty(4096, np.int32)
    for tier, out in ((gpu.ivf, ga), (cpu.ivf, ca)):
        sh = tier.shards[0]
        out[sh["rows"]] = np.repeat(np.arange(tier.nlist),
                                    np.diff(sh["offsets"]))
    assert (ga != ca).mean() < 0.01


def test_card_pack_refuses_tf32_and_leaves_the_flag(cuda, monkeypatch):
    """A card pack runs its f32 products with TF32 as the caller left it:
    off, the flag is untouched; on, the pack raises and the flag stays on."""
    vecs = np.random.RandomState(6).randn(512, 16).astype(np.float32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    DistributedKnnPlane([dict(vectors=vecs)], ivf=dict(nlist=8, seed=1),
                        device=cuda)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        DistributedKnnPlane([dict(vectors=vecs)], ivf=dict(nlist=8, seed=1),
                            device=cuda)
    assert torch.backends.cuda.matmul.allow_tf32 is True


# ---------------------------------------------------------------------------
# the bool and hybrid slice: K9, K10, K11 and K3's sel
# ---------------------------------------------------------------------------


def _same(got, want):
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        assert np.array_equal(g, w)


@pytest.mark.parametrize("seed,S,L,n_pad,k", [
    (1, 1, 48, 4096, 10), (2, 3, 48, 4096, 200),
    # long runs: 24 runs of up to 30000 postings a shard
    (3, 2, 30000, 1 << 16, 100),
    # a running top-k past shared memory
    (4, 1, 4000, 1 << 15, 30000)])
def test_k9_bitwise_equals_plain(cuda, seed, S, L, n_pad, k):
    c, bq = bool_case(seed, S=S, L=L, n_pad=n_pad)
    args = [_t(c[n], cuda) for n in ("docs", "imps", "starts", "lengths")] \
        + [_t(bq[n], cuda) for n in ("idfw", "cbits", "req", "neg", "shd",
                                     "msm")]
    n0 = kb.launches["bool_bm25_topk"]
    got = bool_bm25_topk(*args, n_pad=n_pad, L=L, k=k)
    assert kb.launches["bool_bm25_topk"] == n0 + 1
    want = bool_bm25_topk_plain(*args, n_pad=n_pad, L=L, k=k)
    torch.cuda.synchronize()
    _same(got, want)
    v = got[0].cpu().numpy()
    fin = np.isfinite(v)
    assert fin[0].any() and (v[0][fin[0]] == 0.0).all()   # filter-only
    assert not fin[3].any()                                # a must, no slot
    assert fin[2].any()                                    # msm 2, shared


def _tile_runs(rng, S, n_pad, shift, B, Q):
    """Postings runs on the edges of tiles of 2^shift docs and B x Q slots
    over them: a run across many tile edges, starting and ending mid-tile;
    docs on both sides of every tile edge and at n_pad - 1; a dense run
    over the edge of four tiles; a run whose valid prefix ends in docs at
    and past n_pad; a random run; at the dense tile size (2^11) a run of
    every third doc; and, last in the table, the longest run (the runs sit
    in order of length), which a slot whose start lies past P - L reads
    whole (the start clamps). Slots pick runs at random; some are empty;
    query 2's slots 1 and 2 read one run; one slot starts below 0
    (clamped to the first run). Returns (docs, imps, starts, lengths,
    L)."""
    T = 1 << shift
    runs = [np.arange(T - 3, min(9 * T + 5, n_pad), 3),
            np.unique(np.r_[np.arange(0, n_pad, T),
                            np.arange(T - 1, n_pad, T), n_pad - 1]),
            np.arange(max(4 * T - 100, 0), min(4 * T + 100, n_pad)),
            np.r_[np.arange(5, min(3000, n_pad), 7), n_pad, n_pad + 5],
            np.sort(rng.choice(n_pad, size=min(5000, n_pad // 2),
                               replace=False)),
            np.arange(1, n_pad, 97)]
    if shift == BOOL_TILE_SHIFT:
        runs.append(np.arange(0, n_pad, 3))
    runs = sorted((np.asarray(r, np.int32) for r in runs), key=len)
    lens = np.asarray([r.size for r in runs], np.int32)
    st = np.r_[0, np.cumsum(lens)[:-1]].astype(np.int32)
    L = int(lens.max())
    flat = np.concatenate(runs)
    P = flat.size
    docs = np.tile(flat, (S, 1))
    imps = rng.choice(np.array([0.5, 0.75, 1.0, 1.25, 1.5], np.float32),
                      size=(S, P))
    pick = rng.randint(0, len(runs), size=(B, S, Q))
    starts, lengths = st[pick], lens[pick]
    lengths[rng.rand(B, S, Q) < 0.15] = 0
    starts[2, :, 2], lengths[2, :, 2] = starts[2, :, 1], lengths[2, :, 1]
    starts[5, :, 0], lengths[5, :, 0] = P + 5, L
    starts[6, :, 3], lengths[6, :, 3] = -7, lens[0]
    return docs, imps, starts, lengths, L


def _k9_tile_case(seed, S, n_pad, shift):
    """K9 inputs over :func:`_tile_runs`, for ``bool_case``'s eight trees
    of six slots. Returns (args, L)."""
    rng = np.random.RandomState(seed)
    _, bq = bool_case(seed, S=S)
    B, Q = bq["cbits"].shape
    docs, imps, starts, lengths, L = _tile_runs(rng, S, n_pad, shift, B, Q)
    args = [docs, imps, starts, lengths] + [
        bq[n] for n in ("idfw", "cbits", "req", "neg", "shd", "msm")]
    return args, L


@pytest.mark.parametrize("seed,S,n_pad,k,shift,tiles", [
    # sparse slots (tiles of 2^12 docs): 20 blocks of 13 tiles a query at
    # k = 200, 43 blocks of 6 at S = 3, merged
    (1, 1, 1 << 20, 200, BOOL_SPARSE_TILE_SHIFT, (20, 13)),
    (2, 3, 1 << 20, 10, BOOL_SPARSE_TILE_SHIFT, (43, 6)),
    # dense slots (tiles of 2^11 docs): 128 blocks of 4 tiles a query
    (5, 1, 1 << 20, 10, BOOL_TILE_SHIFT, (128, 4)),
    # k = 30,000: one block a (query, shard), its list in device memory
    (3, 1, 1 << 15, 30000, BOOL_TILE_SHIFT, (1, 16)),
    # n_pad not a multiple of the tile
    (4, 2, 3 * (1 << BOOL_TILE_SHIFT) + 1234, 10, BOOL_TILE_SHIFT,
     (4, 1))])
def test_k9_tile_and_range_edges_bitwise_equal_plain(cuda, seed, S, n_pad, k,
                                                     shift, tiles):
    """K9 over runs on its tiles' and ranges' edges (``_k9_tile_case``),
    with the plan's tile size, G and tiles a block as stated, against its
    plain version, bitwise, one launch a call."""
    args, L = _k9_tile_case(seed, S, n_pad, shift)
    args = [_t(a, cuda) for a in args]
    B, _, Q = args[2].shape
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = bool_bm25_topk_plan(n_pad, B, S, Q, L, k, n_sm)
    assert plan["tile_shift"] == shift
    if n_sm == 132:
        assert (plan["G"], plan["tiles_per_block"]) == tiles
    n0 = kb.launches["bool_bm25_topk"]
    got = bool_bm25_topk(*args, n_pad=n_pad, L=L, k=k)
    assert kb.launches["bool_bm25_topk"] == n0 + 1
    want = bool_bm25_topk_plain(*args, n_pad=n_pad, L=L, k=k)
    torch.cuda.synchronize()
    _same(got, want)
    assert (got[2].cpu().numpy() > 0).any()


@pytest.mark.parametrize("seed,S,L,n_pad,k", [
    # every tree of bool_case over 2^17 and 2^18 docs: 16 to 32 blocks a
    # (query, shard)
    (5, 3, 2000, 1 << 18, 200), (6, 1, 6000, 1 << 18, 10),
    (7, 2, 20000, 1 << 17, 100)])
def test_k9_bool_case_over_many_blocks_bitwise_equals_plain(cuda, seed, S, L,
                                                            n_pad, k):
    """Every query of ``bool_case`` (a filter-only tree, must + should +
    must_not, msm 2 over a shared term, a must with no slot, random
    trees) with more than one block a (query, shard), bitwise."""
    c, bq = bool_case(seed, S=S, L=L, n_pad=n_pad)
    args = [_t(c[n], cuda) for n in ("docs", "imps", "starts", "lengths")] \
        + [_t(bq[n], cuda) for n in ("idfw", "cbits", "req", "neg", "shd",
                                     "msm")]
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert bool_bm25_topk_plan(n_pad, 8, S, 6, L, k, n_sm)["G"] > 1
    n0 = kb.launches["bool_bm25_topk"]
    got = bool_bm25_topk(*args, n_pad=n_pad, L=L, k=k)
    assert kb.launches["bool_bm25_topk"] == n0 + 1
    want = bool_bm25_topk_plain(*args, n_pad=n_pad, L=L, k=k)
    torch.cuda.synchronize()
    _same(got, want)
    v = got[0].cpu().numpy()
    fin = np.isfinite(v)
    assert fin[0].any() and (v[0][fin[0]] == 0.0).all()   # filter-only
    assert not fin[3].any()                                # a must, no slot


#: K1's tile cases: eight queries of six slots
K1_B, K1_Q = 8, 6


def _k1_tile_case(cuda, seed, S, n_pad, shift, *, k, msm=1, dense=False,
                  use_u=False):
    """K1's arguments over :func:`_tile_runs` (idfw of 0.5, 1 or 2), with
    a dense tier of 8 rows (through ``u_ids`` with ``use_u``)."""
    rng = np.random.RandomState(seed)
    docs, imps, starts, lengths, L = _tile_runs(rng, S, n_pad, shift, K1_B,
                                                K1_Q)
    idfw = rng.choice(np.array([0.5, 1.0, 2.0], np.float32),
                      size=(K1_B, K1_Q))
    args = [_t(a, cuda) for a in (docs, imps, starts, lengths, idfw)]
    kw = dict(n_pad=n_pad, L=L, k=k, min_should_match=msm)
    if dense:
        C = 1024 if n_pad % 1024 == 0 else n_pad
        d = dense_case(seed + 7, S=S, B=K1_B, Q=K1_Q, T=8, n_pad=n_pad, C=C,
                       U=6 if use_u else None, density=0.5)
        kw.update(dense=_t(d["bits"], cuda).view(torch.bfloat16),
                  dense_rid=_t(d["rid"], cuda), dense_w=_t(d["w"], cuda),
                  u_ids=None if d["u_ids"] is None else
                  _t(d["u_ids"], cuda))
    return args, kw


def _k1_against_plain(args, kw):
    n0 = kb.launches["sparse_candidates_topk"]
    got = sparse_candidates_topk(*args, **kw)
    assert kb.launches["sparse_candidates_topk"] == n0 + 1
    want = sparse_candidates_topk_plain(*args, **kw)
    torch.cuda.synchronize()
    _same(got, want)
    return got


@pytest.mark.parametrize("seed,S,n_pad,k,shift,msm,dense,use_u,G", [
    # sparse slots (tiles of 2^12 docs), more than one block a query
    (1, 1, 1 << 20, 10, SPARSE_TILE_SHIFT, 1, False, False, 128),
    (2, 3, 1 << 20, 128, SPARSE_TILE_SHIFT, 2, True, True, 32),
    # dense slots (tiles of 2^11 docs): runs across many blocks' ranges
    (5, 1, 1 << 20, 10, TILE_SHIFT, 1, True, False, 128),
    (6, 2, 1 << 20, 128, TILE_SHIFT, 3, False, False, 32),
    # k = 30,000: one block a (query, shard), its list in device memory
    (3, 1, 1 << 15, 30000, TILE_SHIFT, 1, True, True, 1),
    # n_pad not a multiple of the tile, nor of the dense tier's 1,024
    (4, 2, 3 * (1 << TILE_SHIFT) + 1234, 10, TILE_SHIFT, 2, True, False,
     4)])
def test_k1_tile_and_range_edges_bitwise_equal_plain(cuda, seed, S, n_pad, k,
                                                     shift, msm, dense,
                                                     use_u, G):
    """K1 over runs on its tiles' and ranges' edges (``_tile_runs``: docs
    on both sides of tile edges, runs longer than a block's range, two
    slots on one run, starts and lengths that clamp, docs at and past
    n_pad), with and without the dense tier, against its plain version,
    bitwise, one launch a call; the plan's tile size and G as stated."""
    args, kw = _k1_tile_case(cuda, seed, S, n_pad, shift, k=k, msm=msm,
                             dense=dense, use_u=use_u)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = sparse_candidates_topk_plan(n_pad, K1_B, S, K1_Q, kw["L"], k,
                                       n_sm)
    assert plan["tile_shift"] == shift
    if n_sm == 132:
        assert plan["G"] == G
    got = _k1_against_plain(args, kw)
    assert (got[2].cpu().numpy() > 0).any()


@pytest.mark.parametrize("dense,use_u", [(False, False), (True, False),
                                         (True, True)])
def test_k1_every_msm_bitwise_equals_plain(cuda, dense, use_u):
    """min_should_match from 1 to Q (the dense tier's positive values
    count toward it, and a match the dense tier also holds is left out of
    the count), over many blocks a query, bitwise."""
    for msm in range(1, K1_Q + 1):
        args, kw = _k1_tile_case(cuda, 11, 2, 1 << 18, TILE_SHIFT, k=128,
                                 msm=msm, dense=dense, use_u=use_u)
        got = _k1_against_plain(args, kw)
        if msm == 1:
            assert (got[2].cpu().numpy() > 0).all()


def _k8_case(seed, *, S, n_pad, D, B, R):
    """K8 inputs built directly: a window of R entries a (query, shard),
    some at −inf (some of those past the union); union blocks, row ids
    (some the padding row ``n_pad``), rows (two of them equal)."""
    rng = np.random.RandomState(seed)
    blk, P, NB1 = 16, 12, 20
    wv = rng.randn(B, S, R).astype(np.float32)
    wv[rng.rand(B, S, R) < 0.2] = -np.inf
    wp = rng.randint(0, P * blk, size=(B, S, R)).astype(np.int32)
    wp[np.isneginf(wv) & (rng.rand(B, S, R) < 0.3)] = P * blk + 3
    ub = rng.randint(0, NB1, size=(S, P)).astype(np.int32)
    rowid = rng.randint(0, n_pad, size=(S, NB1, blk)).astype(np.int32)
    rowid[:, -1] = n_pad
    vecs = rng.randn(S, n_pad, D).astype(np.float32)
    vecs[:, 3] = vecs[:, 5]
    q = rng.randn(B, D).astype(np.float32)
    return wv, wp, ub, rowid, vecs, q


@pytest.mark.parametrize("R,D,misaligned", [
    (37, 64, False), (40, 30, False), (9, 33, False), (37, 64, True),
    (41, 768, False), (3, 768, True)])
@pytest.mark.parametrize("l2", [False, True])
def test_k8_matches_plain_at_odd_shapes(cuda, R, D, misaligned, l2):
    """K8 against its plain version with R not a multiple of a block's
    entries, D not a multiple of 4, rows not 16-byte aligned and D = 768:
    rows equal, scores within the parity bar (the plain einsum sums in
    another order), one launch a call."""
    S, n_pad, B = 2, 64, 5
    wv, wp, ub, rowid, vecs, q = _k8_case(R + D, S=S, n_pad=n_pad, D=D, B=B,
                                          R=R)
    v = _t(vecs, cuda)
    if misaligned:
        buf = torch.empty(v.numel() + 1, device=cuda)
        buf[1:] = v.reshape(-1)
        v = buf[1:].view(S, n_pad, D)
        assert v.data_ptr() % 16
    ins = (_t(wv, cuda), _t(wp, cuda), _t(ub, cuda), _t(rowid, cuda), v,
           (v * v).sum(-1), _t(q, cuda), _t((q * q).sum(1), cuda))
    n0 = kb.launches["ivf_rerank"]
    ex, rows = ivf_rerank(*ins, l2=l2, n_pad=n_pad)
    assert kb.launches["ivf_rerank"] == n0 + 1
    ex_p, rows_p = ivf_rerank_plain(*ins, l2=l2, n_pad=n_pad)
    torch.cuda.synchronize()
    assert torch.equal(rows, rows_p)
    e, ep = ex.cpu().numpy(), ex_p.cpu().numpy()
    assert np.array_equal(np.isfinite(e), np.isfinite(ep))
    f = np.isfinite(e)
    assert f.any() and not f.all()
    tol = knn_tol(q, vecs, "l2_norm" if l2 else "dot_product")
    np.testing.assert_allclose(e[f], ep[f], rtol=0.0, atol=tol)


@pytest.mark.parametrize("payload", [False, True])
@pytest.mark.parametrize("fusion", ["rrf", "sum"])
@pytest.mark.parametrize("W", [1, 128, 256, 257, 16384])
def test_k10_bitwise_equals_plain(cuda, fusion, W, payload):
    """Windows 1, 100 and 10,000 (lists of 1, 128 and 16384 entries; the
    widest sorts in device memory), and lists of 256 and 257 (n at
    K10_COUNT_MAX, ranked by counting, and one past it, sorted); with the
    rescore payload, (sec, fnd) too."""
    assert 2 * 256 == K10_COUNT_MAX
    c = fusion_case(W, B=6, W=W)
    args = [_t(c[n], cuda) for n in ("tv", "tg", "kv", "kg", "wt", "wk",
                                     "rc", "kboost")]
    kw = dict(n_pad_t=c["n_pad_t"], n_pad_k=c["n_pad_k"], UP=c["UP"],
              pad_id=c["pad_id"], fusion=fusion, similarity="dot_product")
    if payload:
        rng = np.random.RandomState(W)
        kw.update(tsec=_t(rng.rand(6, W).astype(np.float32), cuda),
                  tfnd=_t(rng.rand(6, W) < 0.5, cuda),
                  ksec=_t(rng.rand(6, W).astype(np.float32), cuda),
                  kfnd=_t(rng.rand(6, W) < 0.5, cuda))
    for k in (2 * W, min(10, 2 * W), 2 * W + 3):
        n0 = kb.launches["fuse_rank"]
        got = fuse_rank(*args, **kw, k=k)
        assert kb.launches["fuse_rank"] == n0 + 1
        want = fuse_rank_plain(*args, **kw, k=k)
        torch.cuda.synchronize()
        assert len(got) == len(want) == (5 if payload else 3)
        _same(got, want)
    assert np.isfinite(got[0].cpu().numpy()).any()


def test_k10_refuses_a_partial_payload(cuda):
    """The payload is all four inputs or none: the wrapper refuses a part
    by name, the C entry with its argument code."""
    c = fusion_case(3, B=2, W=8)
    args = [_t(c[n], cuda) for n in ("tv", "tg", "kv", "kg", "wt", "wk",
                                     "rc", "kboost")]
    kw = dict(n_pad_t=c["n_pad_t"], n_pad_k=c["n_pad_k"], UP=c["UP"],
              pad_id=c["pad_id"], fusion="rrf", similarity="cosine", k=16)
    sec = torch.zeros((2, 8), device=cuda)
    with pytest.raises(ValueError, match="all of tsec, tfnd, ksec, kfnd"):
        fuse_rank(*args, **kw, tsec=sec, ksec=sec)
    o = [torch.empty((2, 16), dtype=dt, device=cuda)
         for dt in (torch.float32, torch.int32, torch.int32)]
    with pytest.raises(RuntimeError, match="fuse_rank: launch refused"):
        kb.launch("fuse_rank", cuda, *[a.data_ptr() for a in args[:2]], 8,
                  *[a.data_ptr() for a in args[2:4]], 8,
                  *[a.data_ptr() for a in args[4:]], sec.data_ptr(), None,
                  None, None, 2, c["n_pad_t"], c["n_pad_k"], c["UP"],
                  c["pad_id"], 0, 0, 16, *[x.data_ptr() for x in o], None,
                  None, None)


@pytest.mark.parametrize("mode", ["total", "multiply", "avg", "max", "min"])
@pytest.mark.parametrize("n", [256, 32768])
def test_k11_bitwise_equals_plain(cuda, mode, n):
    rng = np.random.RandomState(n)
    B, pad = 6, 1 << 30
    vals = -np.sort(-rng.choice(np.arange(0, 64, dtype=np.float32) / 8,
                                (B, n)), axis=1)
    vals[1, n // 2:] = -np.inf
    vals[2, :] = -np.inf
    ids = np.stack([rng.choice(1 << 24, n, replace=False)
                    for _ in range(B)]).astype(np.int32)
    ids = np.where(vals > -np.inf, ids, pad).astype(np.int32)
    sec = rng.choice(np.array([0.0, 0.5, 1.0, 3.25], np.float32), (B, n))
    args = [_t(x, cuda) for x in (
        vals, ids, sec, rng.rand(B, n) < 0.6,
        np.array([0.7, 1.0, 2.0, 0.7, 0.7, 1.5], np.float32),
        np.array([1.3, 0.5, 1.0, 1.3, 1.3, 0.25], np.float32),
        # window 0, partial, at n, past n
        np.array([0, 50, n, n + 7, 1, n // 3], np.int32))]
    for k in (10, n):
        n0 = kb.launches["rescore_reorder"]
        got = rescore_reorder(*args, mode=mode, k=k, pad_id=pad)
        assert kb.launches["rescore_reorder"] == n0 + 1
        want = rescore_reorder_body(*args, mode=mode, k=k, pad_id=pad)
        torch.cuda.synchronize()
        _same(got, want)


@pytest.mark.parametrize("mode", RESCORE_MODES)
@pytest.mark.parametrize("n", [1, 100, 200, K11_COUNT_MAX, K11_COUNT_MAX + 1,
                               1024])
def test_k11_counting_and_sorting_paths_bitwise(cuda, mode, n):
    """K11 on both sides of its counting limit (n = 512 counts, 513 sorts)
    and at the serving shapes (bool n = 100, hybrid 200, windows of 300:
    1,024) equals its plain version bit for bit: ties, ±0 scores, −inf
    holes in mid-ranking, an all −inf row, windows of 0 to past n, k
    below the window, at n and past n; one launch a call."""
    args = [_t(x, cuda) for x in rescore_case(n + 7, 9, n, mode)]
    for k in sorted({1, 10, 100, n, n + 4}):
        n0 = kb.launches["rescore_reorder"]
        got = rescore_reorder(*args, mode=mode, k=k, pad_id=1 << 30)
        assert kb.launches["rescore_reorder"] == n0 + 1
        want = rescore_reorder_body(*args, mode=mode, k=k, pad_id=1 << 30)
        torch.cuda.synchronize()
        _same(got, want)


@pytest.mark.parametrize("m,k,seg", [(100, 100, False), (64, 10, True),
                                     (15000, 10000, False)])
def test_k3_sel_equals_plain_positions(cuda, m, k, seg):
    c = topk_lists_case(m + 1, R=6, m=m, n_pad=1 << 20)
    a = (_t(c["a_vals"], cuda), _t(c["a_docs"], cuda))
    kw = dict(k=k, fill_id=1 << 20, with_sel=True)
    if seg:
        kw.update(seg_len=16, seg_stride=1 << 20, fill_id=(1 << 20) * 4)
    got = topk_merge(*a, **kw)
    want = topk_merge_plain(*a, **kw)
    torch.cuda.synchronize()
    _same(got, want)
    sel = got[2].cpu().numpy()
    v = got[0].cpu().numpy()
    fin = np.isfinite(v)
    av = c["a_vals"]
    assert np.array_equal(np.take_along_axis(av, sel, 1)[fin], v[fin])


def test_new_kernels_refuse_what_they_cannot_launch(cuda):
    """K9 refuses a slot table past shared memory; K10 and K11 refuse a
    method or mode code they do not know, each with the library's
    message."""
    Q, L = 10000, 16
    z = torch.zeros((1, 1, Q), dtype=torch.int32, device=cuda)
    zb = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="shared memory"):
        bool_bm25_topk(
            torch.full((1, L), 64, dtype=torch.int32, device=cuda),
            torch.ones((1, L), device=cuda), z, z.clone(),
            torch.ones((1, Q), device=cuda),
            torch.ones((1, Q), dtype=torch.int32, device=cuda), zb, zb, zb,
            zb, n_pad=64, L=L, k=10)
    f = torch.zeros((1, 4), device=cuda)
    i = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    o = torch.ones(1, device=cuda)
    with pytest.raises(RuntimeError, match="fuse_rank: launch refused: "
                                           "unknown mode"):
        kb.launch("fuse_rank", cuda, f.data_ptr(), i.data_ptr(), 4,
                  f.data_ptr(), i.data_ptr(), 4, zb.data_ptr(),
                  zb.data_ptr(), o.data_ptr(), o.data_ptr(), None, None,
                  None, None, 1, 8, 8, 8, 16, 5, 0, 4, f.data_ptr(),
                  i.data_ptr(), i.data_ptr(), None, None, None)
    with pytest.raises(RuntimeError, match="rescore_reorder: launch "
                                           "refused: unknown mode"):
        kb.launch("rescore_reorder", cuda, f.data_ptr(), i.data_ptr(),
                  f.data_ptr(), i.data_ptr(), o.data_ptr(), o.data_ptr(),
                  zb.data_ptr(), 1, 4, 9, 4, 16, f.data_ptr(),
                  i.data_ptr(), None)
    with pytest.raises(ValueError, match="unknown fusion"):
        fuse_rank(f, i, f, i, zb, zb, o, o, n_pad_t=8, n_pad_k=8, UP=8,
                  pad_id=16, fusion="max", similarity="cosine", k=4)


def _hybrid_planes(cuda, S):
    """Text and kNN planes of one corpus on the host and, from the same
    packed state, on the card."""
    corpus = synthetic_csr_corpus_fast(np.random.RandomState(9), 1 << 13,
                                       1 << 10, 24)
    corpus["term_ids"] = {f"t{t}": t for t in range(1 << 10)}
    shards = split_csr_shards(corpus, S) if S > 1 else [corpus]
    for s in shards:
        s["term_ids"] = corpus["term_ids"]
    rng = np.random.RandomState(5)
    vecs = rng.randint(-3, 4, size=(1 << 13, 24)).astype(np.float32)
    per = -(-vecs.shape[0] // S)
    cpu_t = DistributedSearchPlane(shards, "body", device="cpu",
                                   dense_threshold=1 << 30)
    cpu_k = DistributedKnnPlane([dict(vectors=vecs[i * per:(i + 1) * per])
                                 for i in range(S)],
                                similarity="dot_product", device="cpu")
    gpu_t = DistributedSearchPlane.from_packed(cpu_t.export_packed(),
                                               device=cuda)
    gpu_k = DistributedKnnPlane.from_packed(cpu_k.export_packed(),
                                            device=cuda)
    df = corpus["df"].astype(np.float64)
    el = np.flatnonzero(df >= 2)
    fqs = []
    for i in range(16):
        terms = [f"t{t}" for t in rng.choice(el, 9, p=df[el] / df[el].sum())]
        clauses = [("should", terms)] if i % 2 else \
            [("must", terms[:1]), ("should", terms[1:4]),
             ("filter", terms[4:5]), ("must_not", terms[5:6])]
        fqs.append(dict(clauses=clauses, msm=i % 2,
                        qv=rng.randint(-3, 4, 24).astype(np.float32),
                        rc=60.0, wt=100, wk=100, k=10, kboost=1.0,
                        rescore={"terms": terms[:2], "qw": 0.7, "rw": 1.3,
                                 "window": 50}))
    return (cpu_t, cpu_k), (gpu_t, gpu_k), fqs


@pytest.mark.parametrize("S", [1, 2])
def test_hybrid_and_bool_on_card_match_host(cuda, S):
    """fused_search_device and search_bool on the card against the same
    planes on the host (integer vectors: exact kNN scores), with the
    kernels of each path launched and no other."""
    from elasticsearch_tpu_torch.parallel.dist_search import \
        fused_search_device
    from elasticsearch_tpu_torch.search.query_planner import \
        bool_rescore_device
    host, card, fqs = _hybrid_planes(cuda, S)
    for fusion in ("rrf", "sum"):
        for mode in (None, "total", "avg"):
            kb.reset_launches()
            got = fused_search_device(*card, fqs, fusion=fusion,
                                      rescore_mode=mode)
            for name in ("bool_bm25_topk", "knn_scan", "topk_merge",
                         "fuse_rank"):
                assert kb.launches[name] > 0, (name, kb.launches)
            assert (kb.launches["rescore_reorder"] > 0) == (mode is not None)
            assert kb.launches["sparse_candidates_topk"] == 0
            want = fused_search_device(*host, fqs, fusion=fusion,
                                       rescore_mode=mode)
            assert got == want
    bqs = [{"clauses": fq["clauses"], "msm": fq["msm"]} for fq in fqs]
    assert card[0].search_bool(bqs, k=100, with_totals=True)[1:] == \
        host[0].search_bool(bqs, k=100, with_totals=True)[1:]
    gv = card[0].serve_bool(bqs, k=10000, with_totals=True)
    hv = host[0].serve_bool(bqs, k=10000, with_totals=True)
    assert gv[1:] == hv[1:] and np.array_equal(gv[0], hv[0])
    for mode in ("multiply", "max", "min"):
        g = bool_rescore_device(card[0], bqs, fqs, 64, mode)
        h = bool_rescore_device(host[0], bqs, fqs, 64, mode)
        assert g[1:] == h[1:] and np.array_equal(g[0], h[0])


# ---------------------------------------------------------------------------
# the aggregation kernels (K12–K15)
# ---------------------------------------------------------------------------

#: (seed, pairs, runs, n_pad, mask density, doc draw): a few tiles, many
#: tiles with a ragged last word, many empty runs, wrapped docs, no pairs
AGG_CASES = [(0, 1 << 10, 5, 1 << 10, 0.5, "perm"),
             (1, (1 << 20) - 77, 300, 1 << 21, 0.25, "perm"),
             (2, 1 << 18, 4000, 1 << 16, 0.3, "wild"),
             (3, 1 << 16, 7, 1 << 16, 1.0, "wild"),
             (4, 1 << 16, 64, 1 << 16, 0.0, "perm")]
#: K12 also at n_pad and pair counts that are not multiples of 32 (no
#: padding), and a mask of 2^29 docs whose bits (64 MB) pass the L2
K12_CASES = AGG_CASES + [(5, 1000, 13, (1 << 12) + 5, 0.5, "wild", False),
                         (6, 77, 3, 37, 1.0, "wild", False),
                         (7, 1 << 20, 256, 1 << 29, 0.25, "wild")]


def _agg_inputs(cuda, case):
    c = agg_pairs_case(*case)
    return c, {n: _t(c[n], cuda) for n in ("off", "docs", "vals", "mask")}


def _sum_tol(abs_mass):
    """Kernel and plain version both round an f64 sum to f32 once."""
    return 2.0 ** -22 * abs_mass


@pytest.mark.parametrize("case", K12_CASES)
def test_k12_matches_plain(cuda, monkeypatch, case):
    c, t = _agg_inputs(cuda, case)
    # the C entry lays out exactly the workspace the wrapper sizes: one
    # byte less is refused in every mode
    size = aggs.masked_scan_workspace_bytes
    monkeypatch.setattr(aggs, "masked_scan_workspace_bytes",
                        lambda *a: size(*a) - 1)
    for mode in ("counts", "prefix", "sums"):
        with pytest.raises(RuntimeError, match="outside the range"):
            aggs.masked_scan(t["off"], t["docs"], t["mask"],
                             t["vals"] if mode == "sums" else None,
                             mode=mode)
    monkeypatch.undo()
    for mode in ("counts", "prefix"):
        n0 = kb.launches["agg_masked_scan"]
        got = aggs.masked_scan(t["off"], t["docs"], t["mask"], mode=mode)
        assert kb.launches["agg_masked_scan"] == n0 + 1
        want = aggs.masked_scan_plain(t["off"], t["docs"], t["mask"],
                                      mode=mode)
        torch.cuda.synchronize()
        _same_bits(*((got, want) if mode == "prefix" else
                     ((got,), (want,))))
    got = aggs.masked_ordinal_sums(t["off"], t["docs"], t["vals"], t["mask"])
    again = aggs.masked_ordinal_sums(t["off"], t["docs"], t["vals"],
                                     t["mask"])
    want = aggs.masked_scan_plain(t["off"], t["docs"], t["mask"], t["vals"],
                                  mode="sums")
    m = aggs.gather_mask(t["mask"], t["docs"]).cpu().numpy()
    absmv = np.where(m, np.abs(c["vals"]).astype(np.float64), 0.0)
    off = c["off"]
    mass = np.array([absmv[off[v]:off[v + 1]].sum()
                     for v in range(len(off) - 1)])
    err = np.abs(got.cpu().numpy().astype(np.float64) -
                 want.cpu().numpy())
    assert (err <= _sum_tol(mass)).all()
    _same_bits((got,), (again,))


@pytest.mark.parametrize("case", AGG_CASES[:4])
@pytest.mark.parametrize("B,R", [(10, 3), (64, 7), (300, 101)])
def test_k13_matches_plain(cuda, case, B, R):
    c, t = _agg_inputs(cuda, case)
    counts, pre = aggs.masked_rank_prefix(t["off"], t["docs"], t["mask"])
    rng = np.random.RandomState(B + R)
    V = c["off"].shape[0] - 1
    ords = rng.randint(0, V, B).astype(np.int32)
    n = counts.cpu().numpy()[ords]
    lo = np.stack([rng.randint(0, max(k, 1), R) for k in n]).astype(np.int32)
    hi = np.minimum(lo + 1, np.maximum(n[:, None] - 1, 0)).astype(np.int32)
    frac = rng.rand(B, R).astype(np.float32)
    frac[:, 0] = 0.0
    args = (pre, t["off"], t["vals"], _t(ords, cuda), _t(lo, cuda),
            _t(hi, cuda), _t(frac, cuda))
    n0 = kb.launches["agg_rank_pick"]
    got = aggs.rank_pick(*args)
    assert kb.launches["agg_rank_pick"] == n0 + 1
    _same_bits((got,), (aggs.rank_pick_plain(*args),))
    rhos = np.minimum(np.arange(c["M"]) % 53 + 1, 51).astype(np.int32)
    for v in range(V):
        rhos[c["off"][v]:c["off"][v + 1]].sort()
    rh = _t(rhos, cuda)
    got = aggs.masked_register_max(t["off"], t["docs"], rh, t["mask"])
    _same_bits((got,), (aggs.register_max_plain(pre, t["off"], rh),))


#: K13's edges: runs of 0, 1, 31, 32, 33 and 1,025 pairs beside long ones,
#: run 9 with every pair masked out, the offsets padded as the caches pad
#: them (empty runs up to 2^5), at masks of 0.1 %, 25 % and 100 %: at 0.1 %
#: hi's next masked pair and a register's last one mostly lie past the 32
#: entries the kernel reads first
K13_LENS = [0, 1, 31, 32, 33, 1025, 0, 70_000, 5, 40_000, 32, 1, 33]


@pytest.mark.parametrize("density", [0.001, 0.25, 1.0])
@pytest.mark.parametrize("wide", [False, True])
def test_k13_edges_match_plain(cuda, density, wide):
    rng = np.random.RandomState(int(density * 1000) + wide)
    lens = np.asarray(K13_LENS)
    off = np.full(32, lens.sum(), np.int32)
    off[:lens.size + 1] = np.concatenate([[0], np.cumsum(lens)])
    M, V, n_pad = int(lens.sum()), off.size - 1, 1 << 18
    docs = rng.permutation(n_pad)[:M].astype(np.int32)
    vals = rng.lognormal(3.0, 1.0, M).astype(np.float32)
    rhos = rng.randint(1, 52, M).astype(np.int32)
    for v in range(lens.size):
        vals[off[v]:off[v + 1]].sort()
        rhos[off[v]:off[v + 1]].sort()
    mask = rng.rand(n_pad) < density
    mask[docs[off[9]:off[10]]] = False
    mask[docs[off[12]:off[13]:3]] = True
    off_t, docs_t, mask_t = _t(off, cuda), _t(docs, cuda), _t(mask, cuda)
    counts, pre = aggs.masked_rank_prefix(off_t, docs_t, mask_t)
    cnt = counts.cpu().numpy()
    assert cnt[9] == 0 and cnt[lens.size - 1] > 1
    if wide:
        # B·R past one block: any ordinal (clamped to [0, V]), ranks
        # before, inside and past the run, hi at or after lo or before it
        B, R = 300, 101
        ords = rng.randint(-2, V + 3, B).astype(np.int32)
        k = cnt[np.clip(ords, 0, V - 1)]
        lo = np.stack([rng.randint(-1, max(x, 1) + 2, R) for x in k])
        hi = lo + rng.choice([0, 1, 1, 1, 2, 40, -1], (B, R))
    else:
        # every run's Hazen ranks, ordinals V and past it, and the last
        # run's ranks at count − 1
        n_last = cnt[lens.size - 1]
        ords = np.concatenate([np.arange(V), [V, V + 7, lens.size - 1]])
        lo, hi, _f = aggs.hazen_ranks(cnt, (0.0, 50.0, 99.0))
        lo = np.concatenate([lo, [[0, 1, 2], [0, 1, 2],
                                  [n_last - 1, n_last - 2, 0]]])
        hi = np.concatenate([hi, [[1, 2, 3], [1, 2, 3],
                                  [n_last - 1, n_last - 1, 1]]])
        B, R = lo.shape
    frac = rng.rand(B, R).astype(np.float32)
    args = (pre, off_t, _t(vals, cuda), _t(ords.astype(np.int32), cuda),
            _t(lo.astype(np.int32), cuda), _t(hi.astype(np.int32), cuda),
            _t(frac, cuda))
    n0 = kb.launches["agg_rank_pick"]
    got = aggs.rank_pick(*args)
    assert kb.launches["agg_rank_pick"] == n0 + 1
    _same_bits((got,), (aggs.rank_pick_plain(*args),))
    rh = _t(rhos, cuda)
    n0 = kb.launches["agg_rank_pick"]
    got = aggs.register_max(pre, off_t, rh)
    assert kb.launches["agg_rank_pick"] == n0 + 1
    _same_bits((got,), (aggs.register_max_plain(pre, off_t, rh),))


#: K14 also at pair counts that are not multiples of a 16-byte vector or
#: of a warp's step (no padding), below one step, with every pair masked
#: out, with docs past n_pad (the "wild" draws), and with more steps than
#: blocks, dealt unevenly, the last one ragged
K14_CASES = AGG_CASES + [(5, 1001, 13, (1 << 12) + 5, 0.5, "wild", False),
                         (6, 77, 3, 37, 1.0, "wild", False),
                         (8, (1 << 18) + 3, 9, 1 << 16, 0.0, "wild", False),
                         (9, 3 * 256 * 396 + 5, 40, 1 << 20, 0.25, "perm",
                          False)]


@pytest.mark.parametrize("case", K14_CASES)
@pytest.mark.parametrize("n_buckets", [8, 1024, 4096])
def test_k14_matches_plain(cuda, case, n_buckets):
    """Counts bitwise and sums within the f32 rounding of their |v| mass,
    both the same bits on a second call; a third of the pairs in one heavy
    bucket (at nb = 4,096 too)."""
    c, t = _agg_inputs(cuda, case)
    rng = np.random.RandomState(n_buckets)
    ids = rng.randint(-1, n_buckets - 2, c["M"]).astype(np.int32)
    ids[rng.rand(c["M"]) < 0.02] = n_buckets + 5
    ids[: c["M"] // 3] = 1                  # one heavy bucket
    ti = _t(ids, cuda)
    n0 = kb.launches["agg_bucket_reduce"]
    got = aggs.masked_bucket_counts(ti, t["docs"], t["mask"],
                                    n_buckets=n_buckets)
    assert kb.launches["agg_bucket_reduce"] == n0 + 1
    _same_bits((got,), (aggs.bucket_reduce_plain(
        ti, t["docs"], t["mask"], n_buckets=n_buckets),))
    _same_bits((got,), (aggs.masked_bucket_counts(
        ti, t["docs"], t["mask"], n_buckets=n_buckets),))
    n0 = kb.launches["agg_bucket_reduce"]
    got = aggs.masked_bucket_sums(ti, t["docs"], t["vals"], t["mask"],
                                  n_buckets=n_buckets)
    assert kb.launches["agg_bucket_reduce"] == n0 + 1
    again = aggs.masked_bucket_sums(ti, t["docs"], t["vals"], t["mask"],
                                    n_buckets=n_buckets)
    want = aggs.bucket_reduce_plain(ti, t["docs"], t["mask"], t["vals"],
                                    n_buckets=n_buckets)
    m = aggs.gather_mask(t["mask"], t["docs"]).cpu().numpy()
    ok = m & (ids >= 0) & (ids < n_buckets)
    mass = np.bincount(np.where(ok, ids, n_buckets),
                       weights=np.where(ok, np.abs(c["vals"]), 0.0),
                       minlength=n_buckets + 1)[:n_buckets]
    err = np.abs(got.cpu().numpy().astype(np.float64) -
                 want.cpu().numpy())
    assert (err <= _sum_tol(mass)).all()
    _same_bits((got,), (again,))


@pytest.mark.parametrize("n_buckets", [8, 1024, 4096])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_k14_sums_unaligned_columns_equal_aligned(cuda, n_buckets, offset):
    """Columns that start off a 16-byte boundary take one load a pair; the
    pairs a lane takes and the order of the sums stay the same, so the
    sums equal the aligned copies' bit for bit. Six pairs of seven in one
    bucket make most of a warp's slots one group."""
    c, t = _agg_inputs(cuda, (11, (1 << 17) + 9, 16, 1 << 17, 0.5, "wild",
                              False))
    ids = np.full(c["M"], 5, np.int32)
    ids[::7] = np.arange(0, c["M"], 7) % n_buckets
    cols = [_t(np.concatenate([np.zeros(offset, a.dtype), a]), cuda)[offset:]
            for a in (ids, c["docs"], c["vals"])]
    assert all(x.data_ptr() % 16 for x in cols)
    got = aggs.masked_bucket_sums(cols[0], cols[1], cols[2], t["mask"],
                                  n_buckets=n_buckets)
    want = aggs.masked_bucket_sums(_t(ids, cuda), t["docs"], t["vals"],
                                   t["mask"], n_buckets=n_buckets)
    _same_bits((got,), (want,))
    plain = aggs.bucket_reduce_plain(_t(ids, cuda), t["docs"], t["mask"],
                                     t["vals"], n_buckets=n_buckets)
    m = aggs.gather_mask(t["mask"], t["docs"]).cpu().numpy()
    mass = np.bincount(ids, weights=np.where(m, np.abs(c["vals"]), 0.0),
                       minlength=n_buckets)
    err = np.abs(got.cpu().numpy().astype(np.float64) - plain.cpu().numpy())
    assert (err <= _sum_tol(mass)).all()


@pytest.mark.parametrize("case", AGG_CASES)
def test_k15_matches_plain(cuda, case):
    c, t = _agg_inputs(cuda, case)
    n0 = kb.launches["agg_metrics"]
    got = torch.stack(aggs.masked_metrics(t["docs"], t["vals"], t["mask"]))
    assert kb.launches["agg_metrics"] == n0 + 1
    again = torch.stack(aggs.masked_metrics(t["docs"], t["vals"],
                                            t["mask"]))
    want = aggs.metrics_plain(t["docs"], t["vals"], t["mask"])
    g, w = got.cpu().numpy(), want.cpu().numpy()
    _same_bits((got[[0, 2, 3]],), (want[[0, 2, 3]],))
    m = aggs.gather_mask(t["mask"], t["docs"]).cpu().numpy()
    assert abs(float(g[1]) - float(w[1])) <= _sum_tol(
        np.abs(c["vals"][m]).astype(np.float64).sum())
    _same_bits((got,), (again,))


def test_agg_kernels_take_no_pairs_and_refuse_bad_sizes(cuda):
    off = torch.zeros(9, dtype=torch.int32, device=cuda)
    docs = torch.zeros(0, dtype=torch.int32, device=cuda)
    vals = torch.zeros(0, device=cuda)
    mask = torch.ones(8, dtype=torch.bool, device=cuda)
    counts, pre = aggs.masked_rank_prefix(off, docs, mask)
    assert not counts.any() and pre.cpu().tolist() == [0]
    assert not aggs.masked_ordinal_sums(off, docs, vals, mask).any()
    assert not aggs.masked_bucket_counts(docs, docs, mask,
                                         n_buckets=8).any()
    m = torch.stack(aggs.masked_metrics(docs, vals, mask)).cpu().tolist()
    assert m == [0.0, 0.0, float("inf"), float("-inf")]
    with pytest.raises(RuntimeError, match="agg_bucket_reduce: launch "
                                           "refused: unknown mode"):
        kb.launch("agg_bucket_reduce", cuda, docs.data_ptr(),
                  docs.data_ptr(), None, 0, mask.data_ptr(), 8, 8192, 0,
                  off.data_ptr(), None)
    with pytest.raises(TypeError):
        aggs.masked_ordinal_counts(off.long(), docs, mask)
    with pytest.raises(ValueError):
        aggs.masked_ordinal_counts(off, docs, mask.cpu())


# ---------------------------------------------------------------------------
# the per-segment path: K16–K19
# ---------------------------------------------------------------------------


def _pow2(n):
    return 1 << int(np.ceil(np.log2(max(n, 8))))


@pytest.mark.parametrize("seed,n_pad,Q,L,wild", [
    (1, 64, 3, 16, False), (2, 4096, 9, 1024, True),
    (3, 1 << 20, 5, 1 << 18, True), (4, 1 << 16, 300, 256, False)])
@pytest.mark.parametrize("keyword", [False, True])
def test_k16_bitwise_equals_plain(cuda, seed, n_pad, Q, L, wild, keyword):
    docs, tf, dl, starts, lengths, idf, w = csr_case(
        seed, n_pad=n_pad, Q=Q, L=L, P_pad=_pow2(2 * L * Q), wild=wild)
    if keyword:
        tf, dl = np.ones_like(tf), np.zeros_like(dl)
        sc = (np.float32(1.0), np.float32(1.2), np.float32(0.0))
    else:
        sc = (np.float32(31.7), np.float32(1.2), np.float32(0.75))
    args = (_t(docs, cuda), _t(tf, cuda), _t(dl, cuda), starts, lengths,
            idf, w, *sc)
    n0 = kb.launches["bm25_scatter"]
    got = bm25_score(*args, segment_pad=n_pad, L=L)
    assert kb.launches["bm25_scatter"] == n0 + 1
    want = bm25_score_plain(*args, segment_pad=n_pad, L=L)
    torch.cuda.synchronize()
    _same_bits(got, want)


def _k16_runs(case):
    """K16 inputs whose runs sit on tile edges (tiles of ``BM25_TILE``
    docs): (docs, tf, dl, starts, lengths, n_pad, L). ``spans``: a run
    over many tiles, starting and ending mid-tile; ``cut``: runs cut at L
    mid-tile; ``empty_tiles``: runs that leave whole tiles without a
    posting; ``ragged``: a segment that is not a multiple of the tile;
    ``mixed``: a clean slot, then one that is not (a doc wrapped from
    below 0 and one past the segment), then a clean one over its docs."""
    T = BM25_TILE
    rng = np.random.RandomState(len(case))
    if case == "spans":
        n_pad, runs = 12 * T, [np.arange(1000, 11 * T + 77, 3),
                               np.arange(5, 40), np.arange(T - 1, 3 * T + 1)]
    elif case == "cut":
        n_pad = 8 * T
        runs = [np.arange(17, 8 * T, 2), np.arange(3 * T + 5, 7 * T, 5)]
    elif case == "empty_tiles":
        n_pad = 16 * T
        runs = [np.r_[np.arange(0, 4 * T, 7), np.arange(10 * T, 16 * T, 9)],
                np.arange(12 * T + 1, 13 * T - 1)]
    elif case == "ragged":
        n_pad = 3 * T + 1234
        runs = [np.arange(2, n_pad, 4), np.arange(3 * T - 10, n_pad)]
    else:
        n_pad = 6 * T
        runs = [np.arange(0, 6 * T, 3), np.arange(1, 6 * T, 5),
                np.arange(1, 6 * T, 10)]
    runs = [np.asarray(r, np.int32) for r in runs]
    starts = np.cumsum([0] + [r.size for r in runs[:-1]]).astype(np.int32)
    lengths = np.asarray([r.size for r in runs], np.int32)
    flat = np.concatenate(runs)
    if case == "mixed":
        flat[starts[1] + 3] -= n_pad           # wraps back to its doc
        flat[starts[1] + 7] = n_pad + 2        # dropped
    docs = np.full(_pow2(flat.size + 16), n_pad, np.int32)
    docs[:flat.size] = flat
    L = {"cut": 2500}.get(case, int(lengths.max()))
    tf = rng.randint(1, 7, docs.size).astype(np.float32)
    dl = rng.randint(0, 120, n_pad).astype(np.float32)
    return docs, tf, dl, starts, lengths, n_pad, L


@pytest.mark.parametrize("case", ["spans", "cut", "empty_tiles", "ragged",
                                  "mixed"])
@pytest.mark.parametrize("keyword", [False, True])
def test_k16_tile_edges_bitwise_equal_plain(cuda, case, keyword):
    docs, tf, dl, starts, lengths, n_pad, L = _k16_runs(case)
    Q = starts.size
    idf = np.linspace(0.5, 4.0, Q).astype(np.float32)
    w = np.ones(Q, np.float32)
    if keyword:
        tf, dl = np.ones_like(tf), np.zeros_like(dl)
        sc = (np.float32(1.0), np.float32(1.2), np.float32(0.0))
    else:
        sc = (np.float32(31.7), np.float32(1.2), np.float32(0.75))
    args = (_t(docs, cuda), _t(tf, cuda), _t(dl, cuda), starts, lengths,
            idf, w, *sc)
    n0 = kb.launches["bm25_scatter"]
    got = bm25_score(*args, segment_pad=n_pad, L=L)
    assert kb.launches["bm25_scatter"] == n0 + 1
    want = bm25_score_plain(*args, segment_pad=n_pad, L=L)
    torch.cuda.synchronize()
    _same_bits(got, want)
    if case == "empty_tiles":
        m = got[1].cpu().numpy().reshape(-1, BM25_TILE)
        assert (m[4:10] == 0).all() and (m[:4] > 0).any()


@pytest.mark.parametrize("extra", [0, 1])
def test_k16_at_the_kernels_parameter_slots(cuda, extra):
    """The slots whose inputs ride in K16's launch parameters come from the
    kernel (``es_bm25_scatter_param_slots``); at that many slots and one
    more (the inputs then in device memory) the plan says which, and the
    scores are the plain version's bits."""
    from elasticsearch_tpu_torch.ops.bm25 import bm25_scatter_plan
    limit = kb.query("bm25_scatter", "es_bm25_scatter_param_slots")
    assert limit == 64
    Q, n_pad, L = limit + extra, 1 << 14, 64
    assert bm25_scatter_plan(n_pad, L, Q, limit)["device_slots"] == \
        bool(extra)
    docs, tf, dl, starts, lengths, idf, w = csr_case(
        21 + extra, n_pad=n_pad, Q=Q, L=L, P_pad=_pow2(2 * L * Q),
        wild=False)
    args = (_t(docs, cuda), _t(tf, cuda), _t(dl, cuda), starts, lengths,
            idf, w, np.float32(31.7), np.float32(1.2), np.float32(0.75))
    got = bm25_score(*args, segment_pad=n_pad, L=L)
    want = bm25_score_plain(*args, segment_pad=n_pad, L=L)
    torch.cuda.synchronize()
    _same_bits(got, want)


@pytest.mark.parametrize("wild", [False, True])
def test_k16_keyword_one_doc_length_equals_a_length_a_doc(cuda, wild):
    """A scored keyword clause passes one doc length of zero (b = 0): the
    same bits as zeros for every doc, wrapped and dropped docs included."""
    n_pad, Q, L = 1 << 16, 9, 4096
    docs, _, _, starts, lengths, idf, w = csr_case(
        31, n_pad=n_pad, Q=Q, L=L, P_pad=_pow2(2 * L * Q), wild=wild)
    ones = torch.ones(docs.size, device=cuda)
    sc = (np.float32(1.0), np.float32(1.2), np.float32(0.0))
    d = _t(docs, cuda)
    got = bm25_score(d, ones, torch.zeros(1, device=cuda), starts, lengths,
                     idf, w, *sc, segment_pad=n_pad, L=L)
    want = bm25_score(d, ones, torch.zeros(n_pad, device=cuda), starts,
                      lengths, idf, w, *sc, segment_pad=n_pad, L=L)
    torch.cuda.synchronize()
    _same_bits(got, want)


@pytest.mark.parametrize("seed,n_pad,Q,L,wild,prefix", [
    (11, 64, 3, 16, False, False), (12, 4096, 7, 1024, True, False),
    (13, 1 << 20, 6, 1 << 16, True, True), (14, 1 << 12, 70000, 8, False,
                                            False),
    # the by-value limit (64 runs in the launch's parameters) and one past
    # it (one upload); a prefix run over 40 runs of a small segment, where
    # every doc repeats; a segment not a multiple of 4 docs
    (15, 1 << 16, 64, 512, True, False), (16, 1 << 16, 65, 512, True,
                                          False),
    (17, 256, 40, 64, False, True), (18, 4093, 9, 300, True, False)])
def test_k17_equals_plain(cuda, seed, n_pad, Q, L, wild, prefix):
    """Exact counts in one launch; ``prefix`` passes one run over several
    runs (docs repeat in it); 70,000 runs come from one upload."""
    docs, _, _, starts, lengths, _, _ = csr_case(
        seed, n_pad=n_pad, Q=Q, L=L, P_pad=_pow2(2 * L * Q), wild=wild)
    if prefix:
        total = int(lengths.sum())
        starts = np.asarray([0], np.int32)
        lengths = np.asarray([total], np.int32)
        L = _pow2(total)
    d = _t(docs, cuda)
    n0 = kb.launches["postings_match"]
    got = postings_match(d, starts, lengths, segment_pad=n_pad, L=L)
    assert kb.launches["postings_match"] == n0 + 1
    want = postings_match_plain(d, starts, lengths, segment_pad=n_pad, L=L)
    torch.cuda.synchronize()
    _same_bits((got,), (want,))


@pytest.mark.parametrize("seed,n_pad,M,M_pad", [
    (21, 64, 40, 64), (22, 1 << 16, 50000, 1 << 16),
    (23, 1 << 20, 3000000, 1 << 22)])
@pytest.mark.parametrize("f32", [False, True])
def test_k18_equals_plain(cuda, seed, n_pad, M, M_pad, f32):
    rng, docs = pairs_case(seed, n_pad, M, M_pad)
    if f32:       # keyword ordinals past 2^24, compared after rounding
        vals = ((1 << 24) + rng.randint(0, 40, M_pad)).astype(np.float32)
        vals[::97] = np.nan
        bounds = [((1 << 24) + 3, (1 << 24) + 3),
                  ((1 << 24) + 1, (1 << 24) + 30), (0, 1 << 25)]
    else:
        vals = rng.randint(0, 50, M_pad).astype(np.int32)
        bounds = [(0, 49), (7, 7), (10, 30), (-5, 3), (9, 8)]
    v, d = _t(vals, cuda), _t(docs, cuda)
    for lo, hi in bounds:
        n0 = kb.launches["range_mask"]
        got = range_mask(v, d, lo, hi, segment_pad=n_pad)
        assert kb.launches["range_mask"] == n0 + 1
        want = range_mask_plain(v, d, *((float(np.float32(lo)),
                                         float(np.float32(hi))) if f32
                                        else (lo, hi)), segment_pad=n_pad)
        torch.cuda.synchronize()
        _same_bits((got,), (want,))


@pytest.mark.parametrize("n,k", [
    (64, 1), (64, 64), (3000, 10), (3000, 3000), (1 << 17, 16384),
    (1 << 17, 16385), (1 << 17, 1 << 17), (1 << 20, 10), (1 << 20, 10000),
    (1 << 20, 1 << 20),
    # the per-segment path's n at (e)'s and (i)'s k; n not a multiple of
    # 16 or of a block's step; n below one block's step
    (1 << 23, 10), (1 << 23, 1000), (1 << 23, 10000), (100_003, 10),
    (100_003, 2000), (5_000, 700)])
@pytest.mark.parametrize("kind", ["ties", "nan", "masked", "few",
                                  "distinct"])
def test_k19_bitwise_equals_plain(cuda, n, k, kind):
    """Values bitwise and indices exact, by the one-launch path (k <=
    16,384) and the multi-launch one (k > 16,384), twice in a row (a call
    leaves nothing the next one reads), one launch a call."""
    s, mask = topk_scores(n + k, n, kind)
    sc, m = _t(s, cuda), _t(mask, cuda)
    want = masked_topk_plain(sc, m, k)
    for _ in range(2):
        n0 = kb.launches["segment_topk"]
        got = masked_topk(sc, m, k)
        assert kb.launches["segment_topk"] == n0 + 1
        torch.cuda.synchronize()
        _same_bits(got, want)


@pytest.mark.parametrize("k", [10, 3000])
def test_k19_unaligned_columns_equal_plain(cuda, k):
    """Scores and mask 4 and 1 bytes past a 16-byte boundary take the
    one-doc loads; the result is the plain version's, bitwise."""
    s, mask = topk_scores(7, 200_001, "nan")
    sc, m = _t(s, cuda)[1:], _t(mask, cuda)[1:]
    assert sc.data_ptr() % 16 and m.data_ptr() % 16
    want = masked_topk_plain(sc, m, k)
    got = masked_topk(sc, m, k)
    torch.cuda.synchronize()
    _same_bits(got, want)


def test_segment_path_on_the_card_equals_the_cpu(cuda):
    """ShardSearcher over the same segments on the card and on the CPU:
    the same hits, scores (bitwise) and totals, each kernel launched."""
    _, segs_c = build_segments(MapperService, SegmentBuilder, 41,
                               device="cuda")
    svc, segs_h = build_segments(MapperService, SegmentBuilder, 41,
                                 device="cpu")
    card = ShardSearcher(segs_c, svc)
    host = ShardSearcher(segs_h, svc, device="cpu")
    match = {"match": {"body": "w1 w2 hello"}}
    bodies = [
        {"query": match}, {"query": match, "from": 4, "size": 9},
        {"query": {"bool": {
            "must": match, "filter": [
                {"terms": {"tag": ["alpha", "gamma"]}},
                {"range": {"price": {"gte": 1.5, "lt": 7.25}}}],
            "must_not": {"term": {"tag": "beta"}}}}},
        {"query": {"range": {"tag": {"gte": "beta", "lt": "eps"}}}},
        {"query": {"prefix": {"body": "w1"}}, "min_score": 0.5},
        {"query": match, "search_after": [1.0, 5], "size": 30}]
    kb.reset_launches()
    for body in bodies:
        a, b = card.search(body), host.search(body)
        assert [(h.doc_id, h.score, h.sort_values) for h in a.hits] == \
            [(h.doc_id, h.score, h.sort_values) for h in b.hits]
        assert (a.total, a.total_relation) == (b.total, b.total_relation)
        assert card.count(body) == host.count(body)
    for name in ("bm25_scatter", "postings_match", "range_mask",
                 "segment_topk"):
        assert kb.launches[name] > 0, name



TREE_KEYS = ("X", "feats", "thresh", "left", "right", "dleft")


@pytest.mark.parametrize("case", [
    dict(kind="edges", T=9, N=7, n=300, F=4, depth=6),
    dict(kind="edges", T=3, N=1, n=5, F=1, depth=3),
    dict(kind="full", T=500, depth=8, n=1024, F=32),       # shared memory
    dict(kind="full", T=7, depth=12, n=700, F=16)])        # N = 8191
def test_k20_equals_plain(cuda, case):
    """K20's leaf ids equal its plain version's exactly: every index rule
    (random and pinned edge trees), node arrays in shared memory and in
    device memory."""
    c = dict(case)
    kind, depth = c.pop("kind"), c.pop("depth")
    if kind == "edges":
        arrs = tree_arrays_case(20 + c["T"], **c)
    else:
        arrs = full_tree_arrays(21, T=c["T"], depth=depth, F=c["F"],
                                n=c["n"])
        depth += 1
    args = [_t(arrs[k], cuda) for k in TREE_KEYS]
    n0 = kb.launches["tree_eval"]
    got = tml._eval_trees(*args, depth)
    assert kb.launches["tree_eval"] == n0 + 1
    want = tml._eval_trees_plain(*args, depth)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", [
    dict(kind="full", T=500, depth=8, n=1, F=32),        # (k): one doc
    dict(kind="full", T=500, depth=8, n=8, F=32),        # few docs' last n
    dict(kind="full", T=500, depth=8, n=9, F=32),        # the batch's first
    dict(kind="full", T=500, depth=8, n=1024, F=32),     # (j)
    dict(kind="full", T=5, depth=12, n=40, F=16),        # N = 8191 > 2,457
    dict(kind="full", T=3, depth=12, n=1, F=16),
    dict(kind="edges", T=70, N=9, n=3, F=4),
    dict(kind="edges", T=70, N=9, n=100, F=4),
    dict(kind="edges", T=5, N=300, n=70, F=400),         # rows not staged
    dict(kind="edges", T=33, N=17, n=6, F=2100)])        # rows not staged
def test_k20_both_shapes_equal_plain(cuda, case):
    """K20's few-docs shape (n <= 8: a block a tree staged in shared
    memory, a thread a doc) and its batch shape (doc tiles, tree groups),
    which also takes a few docs over trees too large to stage;
    X rows staged and read from device memory, trees of up to 8,191
    nodes, dleft of -1 and 2: the leaf ids of a pack built once equal the
    plain version's, one launch a call."""
    c = dict(case)
    kind, depth = c.pop("kind"), c.pop("depth", 7)
    if kind == "edges":
        arrs = tree_arrays_case(40 + c["T"] + c["n"], **c)
        arrs["dleft"] = np.random.RandomState(c["n"]).choice(
            np.array([-1, 0, 1, 2], np.int32), arrs["dleft"].shape)
    else:
        arrs = full_tree_arrays(41, T=c["T"], depth=depth, F=c["F"],
                                n=c["n"])
        depth += 1
    args = [_t(arrs[k], cuda) for k in TREE_KEYS]
    pack = tml.TreePack(*args[1:], F=c["F"])
    want = tml._eval_trees_plain(*args, depth)
    for _ in range(2):
        n0 = kb.launches["tree_eval"]
        got = tml.eval_tree_pack(args[0], pack, depth)
        assert kb.launches["tree_eval"] == n0 + 1
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    for d in (0, 1):
        assert torch.equal(tml.eval_tree_pack(args[0], pack, d),
                           tml._eval_trees_plain(*args, d))


@pytest.mark.parametrize("n,f,kk,dups", [
    (2, 1, 1, 0), (3, 8, 2, 0), (200, 8, 5, 0), (200, 8, 199, 0),
    (1000, 8, 5, 30), (1000, 20, 16, 0), (3000, 3, 128, 0),
    (5000, 8, 5, 0), (700, 40, 300, 0)])
def test_k21_bitwise_equals_plain(cuda, n, f, kk, dups):
    """K21's kNN distances equal its plain version's bit for bit (the
    same ascending-d FMA chains): one and several feature chunks, kk from
    1 to n - 1 and past 128, duplicate rows (zero distances)."""
    X = _t(outlier_frame(n + f, n, f, duplicates=dups), cuda)
    n0 = kb.launches["knn_outlier"]
    got = tml.knn_kdist(X, kk)
    assert kb.launches["knn_outlier"] == n0 + 1
    want = tml.knn_kdist_plain(X, kk)
    torch.cuda.synchronize()
    _same_bits((got,), (want,))


@pytest.mark.parametrize("n,f,kk,sq_big", [
    (1000, 8, 5, 0.0),          # n not a multiple of the 64-row block
    (64 * 3 + 1, 8, 5, 0.0),    # one row in the last block
    (4096 + 17, 8, 5, 0.0),     # a last column tile of 17
    (2000, 8, 5, 1e36),         # |x|^2 up to 1e37: the FMA form
    (2000, 8, 5, 1e37),         # up to 5e37, past 2^124: two roundings
    (500, 3, 7, 0.0),           # f not a multiple of 4
    (700, 20, 16, 0.0)])        # three feature stages, the last partial
def test_k21_tiles_equal_plain(cuda, n, f, kk, sq_big):
    """K21's register tiles equal its plain version bit for bit: rows and
    columns past n (the peeled edge tile), the diagonal, duplicate rows
    (zero distances), rows of large magnitude (squared norms ``sq_big``
    times 1..10, or 1..5) on either side of the bound that picks
    fma(-2, acc, s) over two roundings."""
    X = outlier_frame(n + f, n, f, duplicates=n // 40)
    if sq_big:
        u = np.random.RandomState(n).randn(10, f)
        mult = np.arange(1, 11) if sq_big < 1e37 else \
            np.repeat(np.arange(1, 6), 2)
        X[:10] = u / np.linalg.norm(u, axis=1, keepdims=True) * \
            np.sqrt(sq_big * mult)[:, None]
    X = _t(X, cuda)
    got = tml.knn_kdist(X, kk)
    want = tml.knn_kdist_plain(X, kk)
    torch.cuda.synchronize()
    assert torch.isfinite(want).all()
    _same_bits((got,), (want,))


@pytest.mark.parametrize("n,f,C,labels,steps", [
    (1, 1, 1, "", 100), (300, 4, 2, "", 100), (1000, 8, 3, "bad", 100),
    (5000, 8, 2, "", 100), (2000, 30, 12, "", 100),
    # below, just below and just past a tile of 256 rows
    (100, 3, 2, "", 100), (255, 3, 2, "", 100), (257, 5, 3, "bad", 100),
    # blocks of several tiles kept in shared memory; blocks whose tiles
    # pass it, read again each step a group at a time, with partials of
    # more entries than a block has threads
    (101381, 8, 2, "", 100), (140000, 30, 12, "bad", 20),
    # no step, one step, a classification run's 500; a class with no rows
    (700, 6, 3, "", 0), (700, 6, 3, "", 1), (16384, 8, 2, "", 500),
    (900, 5, 4, "empty", 100)])
def test_k22_equals_plain(cuda, n, f, C, labels, steps):
    """K22's weights within 1e-5 (relative to the largest weight, at least
    1) of its plain version's (torch matrix products: the sums run in
    another order), the same bits on a second run, and the same argmax on
    every row whose top-two logits differ by more than 1e-3. One launch a
    run, none for no step."""
    X, y = logreg_case(n + C, n, f, C, bad_labels=labels == "bad")
    if labels == "empty":
        y = y % (C - 1)
    Xb = torch.cat([_t(X, cuda), torch.ones(n, 1, device=cuda)], 1)
    yd = _t(y.astype(np.int32), cuda)
    n0 = kb.launches["logreg_train"]
    got = tml.logreg_train(Xb, yd, C, steps=steps)
    assert kb.launches["logreg_train"] == n0 + (1 if steps else 0)
    _same_bits((got,), (tml.logreg_train(Xb, yd, C, steps=steps),))
    want = tml.logreg_train_plain(Xb, yd, C, steps=steps)
    torch.cuda.synchronize()
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-5 * scale
    lg, lw = Xb @ got, Xb @ want
    top2 = torch.topk(lw, min(2, C), dim=1).values
    sep = (top2[:, 0] - top2[:, -1]) > 1e-3 if C > 1 else \
        torch.ones(n, dtype=torch.bool, device=cuda)
    assert torch.equal(lg.argmax(1)[sep], lw.argmax(1)[sep])


def test_ml_kernels_refuse_what_they_cannot_launch(cuda):
    """K21 refuses a neighbour list past a block's shared memory, K22 a row
    tile past it, both with the library's message. The wrappers of K20–K22
    refuse sizes out of range with a ValueError naming the range, and the
    C entries given them anyway return the size code, whose message says
    so; nothing is counted."""
    before = dict(kb.launches)
    X = _t(outlier_frame(5, 1000, 4), cuda)
    with pytest.raises(RuntimeError, match="knn_outlier: launch refused: "
                       "the sizes need more shared memory"):
        tml.knn_kdist(X, 900)
    for kk in (0, 1000):                            # kk outside [1, n - 1]
        with pytest.raises(ValueError, match=r"kk in \[1, n - 1\]; got "
                           rf"n = 1000, f = 4, kk = {kk}"):
            tml.knn_kdist(X, kk)
    size_msg = "launch refused: a size argument is outside the range"
    ws = torch.empty(600, device=cuda)
    with pytest.raises(RuntimeError, match="knn_outlier: " + size_msg):
        kb.launch("knn_outlier", cuda, X.data_ptr(), 1000, 4, 1000,
                  ws.data_ptr(), ws.data_ptr())
    Xb = torch.ones(64, 5, device=cuda)
    y = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="logreg_train: launch refused: "
                       "the sizes need more shared memory"):
        tml.logreg_train(Xb, y, 300, steps=1)
    with pytest.raises(ValueError, match="n_classes >= 1; got n = 64, "
                       "F1 = 5, n_classes = 0"):
        tml.logreg_train(Xb, y, 0, steps=1)
    for C, steps in ((0, 1), (2, -1)):
        with pytest.raises(RuntimeError, match="logreg_train: " + size_msg):
            kb.launch("logreg_train", cuda, Xb.data_ptr(), y.data_ptr(), 64,
                      5, C, 0.5, steps, ws.data_ptr(), ws.data_ptr())
    feats = torch.zeros(2, 0, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="N >= 1 nodes and depth >= 0; "
                       "got F = 5, N = 0, depth = 3"):
        tml._eval_trees(Xb, feats, feats.float(), feats, feats, feats, 3)
    with pytest.raises(RuntimeError, match="tree_eval: " + size_msg):
        kb.launch("tree_eval", cuda, Xb.data_ptr(), 64, 5, ws.data_ptr(), 2,
                  0, 3, ws.data_ptr())
    assert kb.launches == before


def test_ml_kernels_limits_on_this_card(cuda):
    """The largest sizes each refusal leaves: K21's lists take kk * 64 * 4
    bytes beside its 36,864 static bytes, at least the 445 of the
    one-thread-a-row kernel; K22's tile (256 (F1 + C + 2) + F1 C) * 4; one
    past each is refused."""
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    kk_max = (optin - 36864) // 256
    assert kk_max >= 445
    X = _t(outlier_frame(6, kk_max + 2, 2), cuda)
    got = tml.knn_kdist(X, kk_max)
    torch.cuda.synchronize()
    _same_bits((got,), (tml.knn_kdist_plain(X, kk_max),))
    with pytest.raises(RuntimeError, match="shared memory"):
        tml.knn_kdist(X, kk_max + 1)
    F1 = 8
    c_max = max(c for c in range(1, 400)
                if (256 * (F1 + c + 2) + F1 * c) * 4 <= optin)
    Xb = torch.ones(300, F1, device=cuda)
    y = torch.arange(300, dtype=torch.int32, device=cuda) % c_max
    W = tml.logreg_train(Xb, y, c_max, steps=2)
    torch.cuda.synchronize()
    assert torch.isfinite(W).all()
    with pytest.raises(RuntimeError, match="shared memory"):
        tml.logreg_train(Xb, y, c_max + 1, steps=1)


def test_ml_service_on_the_card_equals_the_cpu(cuda):
    """MlService on the card and on the CPU over one frame: the same
    inference results (the tree walk is exact), outlier scores within
    1e-5, classification predictions equal where separated."""
    rng = np.random.RandomState(3)
    docs = [{"a": float(rng.randn()), "b": float(rng.randn() * 2),
             "lab": "x" if i % 3 else "y"} for i in range(400)]
    for d in docs[::7]:
        d["a"] = float(d["a"] + 4.0 * (1.0 if d["lab"] == "x" else -1.0))

    def search(index, body):
        start = (body.get("search_after") or [-1])[0] + 1
        page = docs[start:start + body["size"]]
        return {"hits": {"hits": [{"_id": str(start + i), "_source": d,
                                   "sort": [start + i]}
                                  for i, d in enumerate(page)]}}

    out = {}
    svcs = {dev: tml.MlService(search, lambda i, lines, dev=dev:
                               out.setdefault((dev, i), lines), device=dev)
            for dev in ("cuda", "cpu")}
    arrs = full_tree_arrays(4, T=20, depth=4, F=2, n=1)
    nodes = []
    for t in range(20):
        tree = []
        for j in range(arrs["feats"].shape[1]):
            if arrs["feats"][t, j] >= 0:
                tree.append({"node_index": j,
                             "split_feature": int(arrs["feats"][t, j]),
                             "threshold": float(arrs["thresh"][t, j]),
                             "left_child": int(arrs["left"][t, j]),
                             "right_child": int(arrs["right"][t, j])})
            else:
                tree.append({"node_index": j, "leaf_value": float(j)})
        nodes.append({"tree": {"feature_names": ["a", "b"],
                               "tree_structure": tree}})
    model = {"inference_config": {"regression": {}},
             "definition": {"trained_model": {"ensemble": {
                 "feature_names": ["a", "b"], "trained_models": nodes}}}}
    res = {}
    for dev, svc in svcs.items():
        svc.put_trained_model("m", model)
        res[dev] = svc.infer("m", {"docs": docs})
        for kind, spec in (("od", {"outlier_detection": {}}),
                           ("cl", {"classification": {
                               "dependent_variable": "lab"}})):
            svc.put_analytics(kind, {"source": {"index": "src"},
                                     "dest": {"index": kind},
                                     "analysis": spec})
            svc.start_analytics(kind)
    assert res["cuda"] == res["cpu"]
    od = [[ln["ml"]["outlier_score"] for ln in out[(dev, "od")][1::2]]
          for dev in ("cuda", "cpu")]
    assert np.abs(np.subtract(*od)).max() <= 1e-5
    cl = [[ln["ml"]["lab_prediction"] for ln in out[(dev, "cl")][1::2]]
          for dev in ("cuda", "cpu")]
    pr = np.asarray([ln["ml"]["prediction_probability"]
                     for ln in out[("cpu", "cl")][1::2]])
    sep = np.abs(pr - 0.5) > 1e-3
    assert [a for a, s in zip(cl[0], sep) if s] == \
        [b for b, s in zip(cl[1], sep) if s]


# ---------------------------------------------------------------------------
# the text serving route: ShardSearcher → ServingPlaneCache → micro-batcher
# ---------------------------------------------------------------------------


def _k1_call(cuda, B, k):
    c = sparse_case(40 + B, S=2, B=B, Q=8, L=256)
    args = [_t(c[n], cuda) for n in ("docs", "imps", "starts", "lengths",
                                     "idfw")]
    return lambda: sparse_candidates_topk(*args, n_pad=c["n_pad"], L=256,
                                          k=k)


def _k2_call(cuda, B, k):
    d = dense_case(50 + B, S=2, B=B, Q=4, T=48, n_pad=8192, C=2048)
    W, dense = _t(d["W"], cuda), _t(d["bits"], cuda).view(torch.bfloat16)
    return lambda: dense_stream_topk(W, dense, k=k)


@pytest.mark.parametrize("make", [_k1_call, _k2_call], ids=["k1", "k2"])
def test_two_threads_launch_one_kernel_at_two_shapes(cuda, make):
    """The serving route's two dispatcher threads launch one kernel at
    shapes that need different shared memory: every launch runs and
    gives the single-threaded bits (a kernel's shared-memory limit is
    its own, not a launch's)."""
    import threading
    calls = [make(cuda, 2, 10), make(cuda, 20, 200)]
    want = [[x.cpu() for x in f()] for f in calls]
    errors = []

    def worker(i):
        try:
            for _ in range(200):
                got = calls[i]()
            for g, w in zip(got, want[i]):
                assert torch.equal(g.cpu(), w)
        except BaseException as e:   # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors


def test_serving_route_on_card_matches_host(cuda, monkeypatch):
    """16 client threads through ``ShardSearcher`` with a ``plane_for``
    provider on the card: every response equals the host cache's answer
    to the same body (scores bitwise, ids, totals and their relation),
    the dispatches coalesce, and the pruned and tiered routes' kernels
    all launch, from the batcher's two dispatcher threads."""
    import threading

    from elasticsearch_tpu_torch.search import microbatch as mb
    from elasticsearch_tpu_torch.search.plane_route import \
        ServingPlaneCache
    monkeypatch.setenv("ES_TPU_SERVING_WARMUP", "0")
    monkeypatch.setattr(mb.PlaneMicroBatcher, "IDLE_EXIT_S", 0.05)
    words = [f"w{i}" for i in range(300)]
    rng = np.random.RandomState(3)
    p = 1.0 / np.arange(1, len(words) + 1) ** 1.1
    docs = [" ".join(rng.choice(words, rng.randint(1, 12), p=p / p.sum()))
            + (" head" if i % 3 else "") for i in range(9000)]
    sides = {}
    for key, dev in (("cuda", cuda), ("cpu", torch.device("cpu"))):
        svc = MapperService({"properties": {"body": {"type": "text"}}})
        b = SegmentBuilder("_0")
        for i, d in enumerate(docs):
            b.add(svc.parse_document(str(i), {"body": d}), seq_no=i)
        cache = ServingPlaneCache(device=dev)
        cache.lex_prune_min_docs = 1
        seg = b.build(device=dev)
        sides[key] = (cache, ShardSearcher(
            [seg], svc, device=dev,
            plane_provider=lambda s, f, c=cache, m=svc: c.plane_for(
                s, m, f)))
    # phase 1: sparse-tier terms only (pruned dispatches); phase 2: a
    # dense-tier term in every query (tiered dispatches), half of them
    # with exact totals
    bodies = []
    for i in range(96):
        terms = list(rng.choice(words[50:], 3)) + (["head"] if i >= 48
                                                   else [])
        bodies.append({"query": {"match": {"body": " ".join(terms)}},
                       "size": 10,
                       "track_total_hits": True if i % 2 else 10000})
    want = [sides["cpu"][1].search(b) for b in bodies]
    cache, searcher = sides["cuda"]
    searcher.search(bodies[0])
    assert cache.generations()[0].T_pad > 0
    kb.reset_launches()
    got = [None] * len(bodies)

    def client(c, lo, hi):
        for i in range(lo + c, hi, 16):
            got[i] = searcher.search(bodies[i])

    for lo, hi in ((0, 48), (48, 96)):
        threads = [threading.Thread(target=client, args=(c, lo, hi))
                   for c in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    for w, g in zip(want, got):
        assert [(h.doc_id, np.float32(h.score).view(np.int32))
                for h in w.hits] == \
            [(h.doc_id, np.float32(h.score).view(np.int32)) for h in g.hits]
        assert (w.total, w.total_relation) == (g.total, g.total_relation)
    st = cache.generations()[0]._microbatcher.stats_doc()
    assert st["dispatches"] < len(bodies) + 1
    if cuda.type == "cuda":
        assert all(kb.launches[n] > 0 for n in (
            "sparse_candidates_topk", "dense_stream_topk", "topk_merge",
            "blockmax_scan", "bisect_exact_scores"))
    for c, _ in sides.values():
        c.release()
