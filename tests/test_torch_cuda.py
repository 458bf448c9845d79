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
from elasticsearch_tpu_torch.ops.sorted_merge import (
    sparse_candidates_topk, sparse_candidates_topk_plain)
from elasticsearch_tpu_torch.ops.tiered_bm25 import (
    dense_stream_topk, dense_stream_topk_plain)
from elasticsearch_tpu_torch.ops.topk import topk_merge, topk_merge_plain
from elasticsearch_tpu_torch.parallel.dist_search import \
    DistributedSearchPlane
from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast
from torch_cases import (assert_topk_close, dense_case, sparse_case,
                         topk_lists_case)

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
    assert all(n > 0 for n in kb.launches.values()), kb.launches
