"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and the CUDA toolkit (the kernels build from
``elasticsearch_tpu_torch/csrc`` at first use); elsewhere they skip. They
import no JAX, so on the card's host they run without the repository's
conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.kernels import build as kb
from elasticsearch_tpu_torch.ops.blockmax import (blockmax_scan,
                                                  blockmax_scan_plain)
from elasticsearch_tpu_torch.ops.fused_query import (
    bisect_exact_scores, bisect_exact_scores_plain)
from elasticsearch_tpu_torch.ops.sorted_merge import (
    sparse_candidates_topk, sparse_candidates_topk_plain)
from elasticsearch_tpu_torch.ops.tiered_bm25 import (
    dense_stream_topk, dense_stream_topk_plain)
from elasticsearch_tpu_torch.ops.topk import topk_merge, topk_merge_plain
from elasticsearch_tpu_torch.parallel.dist_search import (
    DistributedSearchPlane, total_is_lower_bound, total_value)
from elasticsearch_tpu_torch.utils.synth import split_csr_shards
from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast
from torch_cases import (assert_topk_close, dense_case, query_mix,
                         sparse_case, topk_lists_case)

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


@pytest.mark.parametrize("k,msm,use_u", [(10, 1, False), (100, 1, True),
                                         (10, 2, True),
                                         # top-k lists in device memory
                                         (2000, 1, True)])
def test_k2_matches_plain(cuda, k, msm, use_u):
    S, B, Q = 2, 20, 4
    d = dense_case(3 + k, S=S, B=B, Q=Q, T=48, n_pad=8192, C=2048,
                   U=32 if use_u else None)
    dense = _t(d["bits"], cuda).view(torch.bfloat16)
    W = _t(d["W"], cuda)
    u = None if d["u_ids"] is None else _t(d["u_ids"], cuda)
    got = dense_stream_topk(W, dense, k=k, u_ids=u, min_should_match=msm)
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
    U = 40000
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


def _prune_planes(cuda, S=1):
    corpus = synthetic_csr_corpus_fast(np.random.RandomState(12), 1 << 14,
                                       1 << 10, 16)
    corpus["term_ids"] = {f"t{t}": t for t in range(1 << 10)}
    shards = split_csr_shards(corpus, S) if S > 1 else [corpus]
    for sh in shards:
        sh["term_ids"] = corpus["term_ids"]
    kw = dict(blockmax={}, dense_threshold=1 << 30)
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
