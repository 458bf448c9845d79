"""The port's segments and its four per-segment kernels' plain versions
against the reference, on the CPU.

- ``SegmentBuilder`` segments built from ``MapperService.parse_document``
  (several segments, deletes before and after ``build``, nested children):
  every host array and every device array equal, bitwise;
- K16 ``bm25_score``, K17 ``postings_match``, K18 ``range_mask`` and K19
  ``masked_topk`` (their plain versions: the tensors lie on the CPU)
  against the jitted functions they replace (``get_bm25_kernel``,
  ``get_postings_match_kernel``, ``get_range_mask_kernel``,
  ``get_topk_kernel``) on the same numpy inputs, bitwise (values compared
  as bit patterns, integers and masks exactly).
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.ops.bm25 import get_bm25_kernel as ref_bm25_kernel
from elasticsearch_tpu.ops.masks import (
    get_postings_match_kernel as ref_match_kernel,
    get_range_mask_kernel as ref_range_kernel)
from elasticsearch_tpu.ops.topk import get_topk_kernel as ref_topk_kernel
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import (Segment, SegmentBuilder,
                                                   segment_from_host_state,
                                                   segment_host_state)
from elasticsearch_tpu_torch.kernels import build as kb
from elasticsearch_tpu_torch.ops import bm25 as tbm25
from elasticsearch_tpu_torch.ops.bm25 import bm25_score, get_bm25_kernel
from elasticsearch_tpu_torch.ops.masks import (get_postings_match_kernel,
                                               get_range_mask_kernel,
                                               postings_match, range_mask)
from elasticsearch_tpu_torch.ops.topk import get_topk_kernel, masked_topk
from torch_cases import (assert_same_bits, build_segments, csr_case,
                         pairs_case, topk_scores)


@pytest.fixture(scope="module")
def segment_pairs():
    _, ref = build_segments(RefMapper, RefBuilder, 5)
    _, port = build_segments(MapperService, SegmentBuilder, 5,
                             device="cpu")
    return ref, port


@pytest.mark.parametrize("how", ["built", "carried"])
def test_segments_equal_the_reference(segment_pairs, how):
    """``built``: the port's ``SegmentBuilder`` on the same documents;
    ``carried``: the reference's segments handed across as host states
    (``segment_host_state`` -> ``segment_from_host_state``)."""
    ref, port = segment_pairs
    if how == "carried":
        port = [segment_from_host_state(segment_host_state(r), device="cpu")
                for r in ref]
    assert len(ref) == len(port) == 3
    for r, p in zip(ref, port):
        assert p.device.type == "cpu"
        for name in ("seg_id", "n_docs", "n_pad", "doc_uids", "sources",
                     "_uid_to_doc"):
            assert getattr(r, name) == getattr(p, name), name
        for name in ("seq_nos", "parent_of", "parent_mask", "live"):
            assert_same_bits(getattr(r, name), getattr(p, name))
        assert r.nested_paths.keys() == p.nested_paths.keys()
        for k in r.nested_paths:
            assert_same_bits(r.nested_paths[k], p.nested_paths[k])
        assert r.int64_fields.keys() == p.int64_fields.keys()
        assert_same_bits(r.live_dev, p.live_dev)
        assert_same_bits(r.parent_mask_dev, p.parent_mask_dev)
        assert r.has_nested == p.has_nested
        assert (r.live_count, r.live_parent_count) == \
            (p.live_count, p.live_parent_count)
        for kind in ("text_fields", "keyword_fields", "numeric_fields",
                     "vector_fields"):
            rf, pf = getattr(r, kind), getattr(p, kind)
            assert rf.keys() == pf.keys(), kind
            for field in rf:
                for attr, rv in vars(rf[field]).items():
                    if attr == "unit_dev":
                        continue        # a cache built at first use: below
                    pv = getattr(pf[field], attr)
                    if rv is None:
                        assert pv is None, (kind, field, attr)
                    elif isinstance(rv, (dict, list, float, int)):
                        assert rv == pv, (kind, field, attr)
                    else:
                        assert_same_bits(rv, pv)
        for field, vf in r.vector_fields.items():
            # the unit rows: the norm's f32 sum may round in another order
            np.testing.assert_allclose(
                p.vector_fields[field].unit_matrix_dev().numpy(),
                np.asarray(vf.unit_matrix_dev()), rtol=2e-7, atol=1e-7)
        for field in r.numeric_fields:
            assert_same_bits(r.numeric_first_value_column(field),
                  p.numeric_first_value_column(field))


def test_every_run_holds_a_doc_once_in_ascending_order(segment_pairs):
    """K16 adds a slot's postings without atomics: it relies on every
    text and keyword run of a built segment holding a doc at most once."""
    _, port = segment_pairs
    for seg in port:
        for f in (*seg.text_fields.values(), *seg.keyword_fields.values()):
            for a, b in zip(f.offsets[:-1], f.offsets[1:]):
                run = f.docs_host[a:b]
                assert np.all(np.diff(run) > 0)
                assert run.size == 0 or (run[0] >= 0
                                         and run[-1] < seg.n_docs)


def test_segments_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svc = MapperService({"properties": {"body": {"type": "text"}}})
    b = SegmentBuilder("_0")
    b.add(svc.parse_document("1", {"body": "hello world"}), seq_no=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        b.build()
    seg = b.build(device="cpu")
    assert seg.text_fields["body"].docs_dev.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Segment("_1", 0, [], [], np.zeros(0, np.int64), {}, {}, {}, {})


# ---------------------------------------------------------------------------
# the four kernels' plain versions against the jitted reference
# ---------------------------------------------------------------------------


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed,n_pad,Q,L,wild", [
    (1, 64, 3, 16, False), (2, 1024, 6, 256, True), (3, 4096, 9, 1024, True),
    (4, 1 << 15, 4, 1 << 13, False), (5, 256, 1, 8, True)])
@pytest.mark.parametrize("keyword", [False, True])
def test_bm25_score_plain_equals_the_jitted_reference(seed, n_pad, Q, L,
                                                      wild, keyword):
    """Bitwise scores (the sum in slot order, the FMA where XLA:CPU puts
    it: fma(k1, (1 - b) + (b * dl) / avgdl, tf)) and exact counts, with
    runs longer than L cut at L, empty and absent runs, and docs that
    wrap or drop."""
    P_pad = 1 << int(np.ceil(np.log2(max(2 * L * Q, 8))))
    docs, tf, dl, starts, lengths, idf, w = csr_case(
        seed, n_pad=n_pad, Q=Q, L=L, P_pad=P_pad, wild=wild)
    if keyword:
        tf, dl = np.ones_like(tf), np.zeros_like(dl)
        avgdl, k1, b = np.float32(1.0), np.float32(1.2), np.float32(0.0)
    else:
        avgdl, k1, b = np.float32(37.25 + seed), np.float32(1.2), \
            np.float32(0.75)
    ref_s, ref_m = ref_bm25_kernel(n_pad, L)(docs, tf, dl, starts, lengths,
                                              idf, w, avgdl, k1, b)
    got_s, got_m = get_bm25_kernel(n_pad, L)(_t(docs), _t(tf), _t(dl),
                                             starts, lengths, idf, w,
                                             avgdl, k1, b)
    assert_same_bits(ref_s, got_s)
    assert_same_bits(ref_m, got_m)


@pytest.mark.parametrize("seed,n_pad,Q,L,wild,prefix", [
    (11, 64, 3, 16, False, False), (12, 1024, 7, 256, True, False),
    (13, 4096, 5, 1024, True, True), (14, 1 << 14, 1, 1 << 15, False, True)])
def test_postings_match_plain_equals_the_jitted_reference(seed, n_pad, Q, L,
                                                          wild, prefix):
    """Exact counts; ``prefix`` passes one run over several terms' runs,
    so a doc may repeat inside it."""
    P_pad = 1 << int(np.ceil(np.log2(max(2 * L * Q, 8))))
    docs, _, _, starts, lengths, _, _ = csr_case(
        seed, n_pad=n_pad, Q=Q + 2 if prefix else Q, L=L // 4 if prefix
        else L, P_pad=P_pad, wild=wild)
    if prefix:
        total = int(lengths.sum())
        starts = np.asarray([0], np.int32)
        lengths = np.asarray([total], np.int32)
        L = 1 << int(np.ceil(np.log2(max(total, 8))))
        assert np.unique(docs[:total]).size < total     # docs repeat
    ref = ref_match_kernel(n_pad, L)(docs, starts, lengths)
    got = get_postings_match_kernel(n_pad, L)(_t(docs), starts, lengths)
    assert_same_bits(ref, got)


@pytest.mark.parametrize("seed,n_pad,M,M_pad", [
    (21, 64, 40, 64), (22, 4096, 3000, 4096), (23, 1 << 15, 40000, 1 << 16)])
def test_range_mask_plain_equals_the_jitted_reference_on_ranks(seed, n_pad,
                                                               M, M_pad):
    rng, docs = pairs_case(seed, n_pad, M, M_pad)
    ranks = np.zeros(M_pad, np.int32)
    ranks[:M] = rng.randint(0, 50, M)
    for lo, hi in ((0, 49), (7, 7), (10, 30), (-5, 3), (45, 80), (9, 8)):
        ref = ref_range_kernel(n_pad)(ranks, docs, np.int32(lo),
                                      np.int32(hi))
        got = get_range_mask_kernel(n_pad)(_t(ranks), _t(docs),
                                           np.int32(lo), np.int32(hi))
        assert_same_bits(ref, got)


def test_range_mask_plain_equals_the_reference_past_2_24_ordinals():
    """Keyword ranges compare ordinals converted to f32: past 2^24 the
    conversion rounds (to even), so neighbouring ordinals and bounds
    collapse; the port compares the same rounded values. NaN values are
    in no range."""
    n_pad, M = 2048, 1500
    rng, docs = pairs_case(31, n_pad, M, 2048)
    ords = np.zeros(2048, np.int32)
    ords[:M] = (1 << 24) + rng.randint(0, 40, M)
    vals = ords.astype(np.float32)
    vals[5] = np.nan
    for lo, hi in (((1 << 24) + 3, (1 << 24) + 3),
                   ((1 << 24) + 1, (1 << 24) + 7),
                   ((1 << 24) + 10, (1 << 24) + 39), (0, 1 << 25)):
        lo32, hi32 = np.float32(lo), np.float32(hi)
        ref = ref_range_kernel(n_pad)(vals, docs, lo32, hi32)
        got = range_mask(_t(vals), _t(docs), lo32, hi32, segment_pad=n_pad)
        assert_same_bits(ref, got)
        exact = (ords[:M] >= lo) & (ords[:M] <= hi)
        if lo == (1 << 24) + 3:
            # rounding admits ordinal 2^24 + 2 and 2^24 + 4 as well
            assert np.asarray(ref).sum() > 0 and exact.sum() < \
                ((vals[:M] >= lo32) & (vals[:M] <= hi32)).sum()


@pytest.mark.parametrize("n,k", [
    (64, 1), (64, 10), (64, 64), (3000, 10), (3000, 3000),
    (1 << 17, 1), (1 << 17, 10), (1 << 17, 16384), (1 << 17, 16385),
    (1 << 17, 1 << 17)])
@pytest.mark.parametrize("kind", ["ties", "nan", "masked", "distinct"])
def test_masked_topk_plain_equals_the_jitted_reference(n, k, kind):
    """Values bitwise (NaN payloads and signed zeros included) and indices
    exact: the reference orders by the values' bits (+NaN first, -NaN
    last), ties and masked slots by ascending index, in its one-stage and
    its two-stage (n >= 2^17, k <= 16384) forms."""
    s, mask = topk_scores(n + k, n, kind)
    rv, ri = ref_topk_kernel(n, k)(s, mask)
    gv, gi = get_topk_kernel(n, k)(_t(s), _t(mask))
    assert_same_bits(rv, gv)
    assert_same_bits(np.asarray(ri), gi)


def test_wrappers_count_no_launch_on_the_cpu_and_refuse_other_devices():
    before = dict(kb.launches)
    masked_topk(torch.zeros(8), torch.ones(8, dtype=torch.bool), 3)
    assert kb.launches == before
    meta = torch.device("meta")
    i = torch.empty(16, dtype=torch.int32, device=meta)
    f = torch.empty(16, device=meta)
    with pytest.raises(ValueError):
        bm25_score(i, f, f, [0], [4], [1.0], [1.0], 1.0, 1.2, 0.75,
                   segment_pad=16, L=8)
    with pytest.raises(ValueError):
        postings_match(i, [0], [4], segment_pad=16, L=8)
    with pytest.raises(ValueError):
        range_mask(i, i, 0, 3, segment_pad=16)
    with pytest.raises(ValueError):
        masked_topk(f, torch.empty(16, dtype=torch.bool, device=meta), 4)
    with pytest.raises(ValueError):
        masked_topk(torch.zeros(8), torch.ones(8, dtype=torch.bool), 9)
    with pytest.raises(TypeError):
        range_mask(torch.zeros(4, dtype=torch.float64),
                   torch.zeros(4, dtype=torch.int32), 0, 1, segment_pad=8)
    assert kb.launches == before


@pytest.mark.parametrize("segment_pad,run_len,Q", [
    (64, 16, 3), (1 << 23, 5303010, 4), (3 * 4096 + 1234, 5000, 2),
    (4096, 0, 1), (1 << 20, 8192, 300)])
def test_bm25_scatter_plan_covers_the_segment_and_the_runs(segment_pad,
                                                           run_len, Q):
    """K16's launch shape: tiles of ``BM25_TILE`` docs cover the segment
    (the last may be short), chunks of ``BM25_CHUNK`` positions cover the
    longest run (at least one chunk), the scratch holds each slot's
    ``n_tiles + 1`` tile offsets and its chunk flags, and the slots'
    inputs go to the card in device memory only past the slots the
    launch's parameters hold (the kernel reports 64; the card test
    ``test_k16_at_the_kernels_parameter_slots`` holds the plan to it)."""
    plan = tbm25.bm25_scatter_plan(segment_pad, run_len, Q, 64)
    T, n_tiles = plan["tile"], plan["n_tiles"]
    assert T == tbm25.BM25_TILE == 1 << plan["tile_shift"]
    assert plan["chunk"] == tbm25.BM25_CHUNK
    assert (n_tiles - 1) * T < segment_pad <= n_tiles * T
    assert plan["n_chunks"] == max(1, -(-run_len // plan["chunk"]))
    assert plan["scratch"] == Q * (n_tiles + 1 + plan["n_chunks"])
    assert plan["device_slots"] == (Q > 64)
    assert not tbm25.bm25_scatter_plan(segment_pad, run_len, Q,
                                       Q)["device_slots"]
