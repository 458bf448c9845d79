"""The port's kNN plane (exact scan and IVF tier) against the JAX plane, on
the CPU.

Both sides pack the same seeded numpy corpora: random rows with ``exists``
holes, exact duplicates and near-tie rows (the reference's
``_near_tie_corpus``). The JAX plane runs its jitted steps (host serving
off), the port its plain PyTorch versions (``device="cpu"``).

Tolerances. Pack-time arrays (the packed corpus, k-means centroids, the
int8 codes, the device tier) are byte-equal: both run the same numpy. Dot
products sum in another order than XLA's, so scores agree within
``1e-5·‖q‖·max‖v‖`` (dot, cosine) and ``1e-5·(‖q‖ + max‖v‖)²`` (l2,
whose expansion ``2q·v − ‖v‖² − ‖q‖²`` cancels), and hits agree except
where the reference's neighbouring scores lie within that tolerance of
each other. Only finite entries are compared: the port writes a fill id
beside −inf where the reference leaves an arbitrary index.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.parallel import make_search_mesh
from elasticsearch_tpu.parallel import dist_search as ref
from elasticsearch_tpu_torch.kernels import build as kb
from elasticsearch_tpu_torch.ops import knn as tk
from elasticsearch_tpu_torch.ops.topk import topk_merge_plain
from elasticsearch_tpu_torch.parallel import dist_search as port
from test_knn_ivf import _near_tie_corpus
from torch_cases import assert_topk_close, hit_ids, knn_tol

SIMS = ("dot_product", "cosine", "l2_norm")
DIM = 12
SHARD_ROWS = (300, 263, 220)


def _corpus(seed, similarity, S):
    """``S`` shards of near-tie corpus rows with ``exists`` holes, and a
    query batch that sits on the ties, off them, and on duplicates."""
    rng = np.random.RandomState(seed)
    delta = 1e-2 if similarity == "l2_norm" else 1e-4
    n = sum(SHARD_ROWS[:S]) if S > 1 else SHARD_ROWS[0]
    vecs, t = _near_tie_corpus(rng, n, DIM, delta)
    exists = rng.rand(n) > 0.1
    exists[50:70] = True                  # the near-tie lattice
    exists[200:210] = exists[10:20] = True  # the duplicates
    shards, lo = [], 0
    for s in range(S):
        m = SHARD_ROWS[s] if S > 1 else n
        shards.append(dict(vectors=vecs[lo:lo + m], exists=exists[lo:lo + m]))
        lo += m
    qs = np.stack([t, rng.randn(DIM).astype(np.float32),
                   t * np.float32(2.0 + delta * 5.3), vecs[203],
                   vecs[12] * np.float32(0.5)]
                  + [rng.randn(DIM).astype(np.float32) for _ in range(3)])
    return shards, qs.astype(np.float32), vecs


@pytest.fixture
def host_serve_off(monkeypatch):
    monkeypatch.setenv("ES_TPU_PLANE_HOST_SERVE", "0")


def _ref_plane(shards, similarity, mesh_shards=1, **kw):
    mesh = make_search_mesh(n_shards=mesh_shards, n_replicas=1,
                            devices=jax.devices()[:mesh_shards])
    plane = ref.DistributedKnnPlane(mesh, shards, similarity=similarity,
                                    **kw)
    assert plane._host_pack is None      # the jitted steps serve
    return plane


def _same_topk(got, want, n_pad, tol):
    """(vals, hits) of the port against the reference's: as many hits, the
    scores within ``tol``, the hits equal where separated, and equal port
    scores in ascending id order. ``want`` may hold one more column than
    ``got``: its value is the next rank's, which decides whether the last
    slot is separated."""
    gv, gh = got
    wv, wh = want
    k = max(gv.shape[1], 1)
    wv = np.asarray(wv, np.float64)
    v_next = wv[:, k] if wv.shape[1] > k else None
    wh = [h[:k] for h in wh]
    assert [len(h) for h in gh] == [len(h) for h in wh]
    gv = np.where(np.isfinite(gv), gv, -np.inf)
    wv = np.where(np.isfinite(wv[:, :k]), wv[:, :k], -np.inf)
    gi, wi = hit_ids(gh, n_pad, k), hit_ids(wh, n_pad, k)
    with np.errstate(invalid="ignore"):
        assert_topk_close(gv, gi, wv, wi, rtol=0.0, atol=tol, v_next=v_next)
    for b in range(gv.shape[0]):
        n = len(gh[b])
        tie = gv[b, 1:n] == gv[b, :n - 1]
        assert (gi[b, 1:n][tie] > gi[b, :n - 1][tie]).all()


# ---------------------------------------------------------------------------
# pack and the exact scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("similarity", SIMS)
def test_prepare_knn_corpus_is_byte_equal(similarity):
    x = np.random.RandomState(3).randn(2, 64, DIM).astype(np.float32)
    x[0, 5] = 0.0                          # a zero row (cosine's clamp)
    for a, b in zip(port.prepare_knn_corpus(x, similarity),
                    ref.prepare_knn_corpus(x, similarity)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        port.prepare_knn_corpus(x, "hamming")


@pytest.mark.parametrize("blocked", [True, False], ids=["blocked", "oneshot"])
@pytest.mark.parametrize("similarity", SIMS)
def test_shard_scan_plain_matches_reference(similarity, blocked):
    """K6's plain version against ``_knn_shard_scan`` for two shards of
    2^12 rows (blocks of 256, or one shot), with holes and duplicates."""
    rng = np.random.RandomState(5)
    S, n_pad, B, kk, blk = 2, 1 << 12, 6, 16, 256
    raw = rng.randn(S, n_pad, DIM).astype(np.float32)
    raw[1, 100:110] = raw[0, 7]            # duplicates across and in shards
    raw[0, 3000:3004] = raw[0, 7]
    exists = rng.rand(S, n_pad) > 0.2
    exists[0, 7] = exists[0, 3000:3004] = True
    vecs, vn = ref.prepare_knn_corpus(raw, similarity)
    vecs[~exists] = 0.0
    vn[~exists] = 0.0
    q = rng.randn(B, DIM).astype(np.float32)
    q[0] = raw[0, 7]
    qq = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12) \
        if similarity == "cosine" else q
    qn = np.sum(q * q, axis=1)
    fn = jax.jit(functools.partial(
        ref._knn_shard_scan, similarity=similarity, n_pad=n_pad, dim=DIM,
        kk=kk, blk=blk if blocked else n_pad, use_blocks=blocked))
    want = [fn(jnp.asarray(vecs[s]), jnp.asarray(vn[s]),
               jnp.asarray(exists[s]), jnp.asarray(qq), jnp.asarray(qn))
            for s in range(S)]
    t = torch.from_numpy
    gv, gi = tk.knn_shard_scan(t(vecs), t(vn), t(exists), t(qq), t(qn),
                               similarity=similarity, kk=kk,
                               blk=blk if blocked else None,
                               use_blocks=blocked)
    assert gv.shape == (B, S, kk) and gi.dtype == torch.int32
    tol = knn_tol(q, raw, similarity)
    for s in range(S):
        wv, wi = (np.asarray(x) for x in want[s])
        assert_topk_close(gv[:, s].numpy(), gi[:, s].numpy(), wv, wi,
                          rtol=0.0, atol=tol)
    # equal scores come out row-ascending; under cosine the duplicates of
    # row 7 are the first query's best hits
    v, i = gv.numpy(), gi.numpy()
    tie = v[..., 1:] == v[..., :-1]
    assert (i[..., 1:][tie] > i[..., :-1][tie]).all()
    if similarity == "cosine":
        assert gi[0, 0, :5].tolist() == [7, 3000, 3001, 3002, 3003]


def test_knn_blocking_matches_reference():
    for block, n_pad, kk in ((256, 4096, 10), (256, 4096, 300),
                             (None, 4096, 10), (1000, 4096, 10),
                             (4096, 4096, 10), (0, 64, 1)):
        assert port._knn_blocking(block, n_pad, kk) == \
            ref._knn_blocking(block, n_pad, kk)


@pytest.mark.parametrize("S", [1, 3], ids=["S1", "S3"])
@pytest.mark.parametrize("similarity", SIMS)
def test_plane_matches_reference(similarity, S, host_serve_off):
    """``search`` and ``serve`` at k = 10 and at k above the live rows; for
    S = 3 the reference pads its 2-device mesh with an empty shard, and
    the port is also given that pad shard."""
    shards, qs, vecs = _corpus(11 + S, similarity, S)
    jp = _ref_plane(shards, similarity, mesh_shards=2 if S == 3 else 1,
                    block=64)
    tp = port.DistributedKnnPlane(shards, similarity=similarity, block=64,
                                  device="cpu")
    assert tp.n_pad == jp.n_pad and tp.dim == jp.dim == DIM
    if S == 3:
        assert jp.n_shards == 4 and tp.n_shards == 3
    live = int(sum(s["exists"].sum() for s in shards))
    tol = knn_tol(qs, vecs, similarity)
    for k in (10, live + 5):
        st = {}
        got = tp.serve(qs, k=k, stages=st)
        _same_topk(got, jp.search(qs, k=k + 1), tp.n_pad, tol)
        assert st["kernel"] == "knn_exact" and st["dispatch_ms"] >= 0
    assert max(len(h) for h in got[1]) == live
    if S == 3:
        padded = port.DistributedKnnPlane(
            shards + [port.DistributedKnnPlane.empty_pad_shard(DIM)],
            similarity=similarity, block=64, device="cpu")
        pv, ph = padded.search(qs, k=10)
        gv, gh = tp.search(qs, k=10)
        assert ph == gh and np.array_equal(pv, gv)


def test_plane_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError, match="similarity"):
        port.DistributedKnnPlane([dict(vectors=np.ones((4, 3), np.float32))],
                                 similarity="hamming", device="cpu")
    with pytest.raises(ValueError, match="mixed vector dims"):
        port.DistributedKnnPlane([dict(vectors=np.ones((4, 3), np.float32)),
                                  dict(vectors=np.ones((4, 5), np.float32))],
                                 device="cpu")
    tp = port.DistributedKnnPlane([dict(vectors=np.ones((4, 3), np.float32))],
                                  device="cpu")
    with pytest.raises(ValueError, match="query_vectors"):
        tp.search(np.ones((2, 4), np.float32))
    with pytest.raises(RuntimeError, match="no IVF tier"):
        tp.search_ivf(np.ones((2, 3), np.float32), nprobe=1, rerank=1)
    assert tp.resolve_ann(None, None) is None


def test_plane_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shard = dict(vectors=np.ones((4, 3), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.DistributedKnnPlane([shard])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.kmeans_fit(np.ones((16, 3), np.float32), 2)


def test_wrappers_refuse_devices_they_have_no_kernel_for():
    meta = torch.device("meta")
    before = dict(kb.launches)

    def e(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device=meta)

    with pytest.raises(ValueError):
        tk.knn_shard_scan(e(1, 64, 4), e(1, 64), e(1, 64, dtype=torch.bool),
                          e(2, 4), e(2), similarity="dot_product", kk=4)
    i32 = torch.int32
    with pytest.raises(ValueError):
        tk.ivf_scan(e(1, 3, 8, 4, dtype=torch.int8), e(1, 3, 8), e(1, 3, 8),
                    e(1, 3, 8, dtype=i32), e(1, 3, 8, dtype=i32), e(1, 16),
                    e(2, 4), e(2), e(2), e(2, 1, dtype=i32),
                    e(1, 2, dtype=i32), l2=False, n_pad=16, nlist=2,
                    r_cand=4)
    with pytest.raises(ValueError):
        tk.ivf_rerank(e(2, 1, 4), e(2, 1, 4, dtype=i32), e(1, 2, dtype=i32),
                      e(1, 3, 8, dtype=i32), e(1, 16, 4), e(1, 16), e(2, 4),
                      e(2), l2=False, n_pad=16)
    assert kb.launches == before


# ---------------------------------------------------------------------------
# packed state, both ways
# ---------------------------------------------------------------------------


def _assert_packed_equal(a, b):
    for key in ("similarity", "block", "dim", "n_shards", "n_docs_total",
                "n_pad", "nbytes"):
        assert a[key] == b[key], key
    for key in ("vecs", "vnorm2", "exists"):
        assert np.array_equal(np.asarray(a[key]), np.asarray(b[key])), key
    assert (a["ivf"] is None) == (b["ivf"] is None)
    if a["ivf"] is not None:
        ta, tb = a["ivf"], b["ivf"]
        for key in ("similarity", "quant", "block", "nlist",
                    "default_nprobe", "n_blocks"):
            assert ta[key] == tb[key], key
        assert np.array_equal(ta["centroids"], tb["centroids"])
        assert np.array_equal(ta["cluster_sizes"], tb["cluster_sizes"])
        for sa, sb in zip(ta["shards"], tb["shards"]):
            for key in ("offsets", "rows", "codes", "scale", "off"):
                assert sa[key].dtype == sb[key].dtype, key
                assert np.array_equal(sa[key], sb[key]), key


@pytest.mark.parametrize("quant", ["int8", "bf16"])
def test_packed_state_both_ways(quant, host_serve_off):
    shards, qs, vecs = _corpus(21, "l2_norm", 1)
    ivf = dict(nlist=8, seed=3, quant=quant)
    jp = _ref_plane(shards, "l2_norm", ivf=ivf)
    tp = port.DistributedKnnPlane(shards, similarity="l2_norm", ivf=ivf,
                                  device="cpu")
    _assert_packed_equal(tp.export_packed(), jp.export_packed())
    tol = knn_tol(qs, vecs, "l2_norm")
    # reference → port
    tp2 = port.DistributedKnnPlane.from_packed(jp.export_packed(),
                                               device="cpu")
    for nprobe in (0, None):
        _same_topk(tp2.serve(qs, k=10, nprobe=nprobe),
                   jp.serve(qs, k=11, nprobe=nprobe), tp.n_pad, tol)
    # port → reference
    jp2 = ref.DistributedKnnPlane.from_packed(jp.mesh, tp.export_packed())
    assert jp2._host_pack is None
    for nprobe in (0, None):
        _same_topk(tp.serve(qs, k=10, nprobe=nprobe),
                   jp2.serve(qs, k=11, nprobe=nprobe), tp.n_pad, tol)
    _assert_packed_equal(tp2.export_packed(), jp.export_packed())


# ---------------------------------------------------------------------------
# the IVF tier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("l2,spherical", [(False, False), (True, False),
                                          (False, True)])
def test_kmeans_and_quantization_are_byte_equal(l2, spherical):
    x = np.random.RandomState(8).randn(1500, DIM).astype(np.float32)
    kw = dict(l2=l2, spherical=spherical, iters=4, sample=1024, seed=5)
    a = port.kmeans_fit(x, 16, device="cpu", **kw)
    assert np.array_equal(a, ref.kmeans_fit(x, 16, **kw))
    assert np.array_equal(port._assign_clusters(x, a, l2, device="cpu"),
                          ref._assign_clusters(x, a, l2))
    for u, v in zip(port.quantize_int8_rows(x), ref.quantize_int8_rows(x)):
        assert u.dtype == v.dtype and np.array_equal(u, v)


@pytest.mark.parametrize("similarity,quant", [
    ("dot_product", "int8"), ("cosine", "int8"), ("l2_norm", "int8"),
    ("cosine", "bf16")])
def test_tier_is_byte_equal(similarity, quant):
    """The whole tier (two shards, nlist 8), its probes, its unions and its
    device arrays (bf16 codes converted from the host's f16)."""
    shards, qs, _ = _corpus(31, similarity, 2)
    n_pad = 512
    S = len(shards)
    vecs = np.zeros((S, n_pad, DIM), np.float32)
    exists = np.zeros((S, n_pad), bool)
    for s, sh in enumerate(shards):
        m = sh["vectors"].shape[0]
        vecs[s, :m], exists[s, :m] = sh["vectors"], sh["exists"]
    vecs, _ = ref.prepare_knn_corpus(vecs, similarity)
    vecs[~exists] = 0.0
    kw = dict(nlist=8, quant=quant, seed=2, block=32)
    a = port.IvfKnnTier.build(vecs, exists, similarity, device="cpu", **kw)
    b = ref.IvfKnnTier.build(vecs, exists, similarity, **kw)
    _assert_packed_equal(
        dict(similarity=0, block=0, dim=0, n_shards=0, n_docs_total=0,
             n_pad=0, nbytes=0, vecs=0, vnorm2=0, exists=0,
             ivf=a.to_packed()),
        dict(similarity=0, block=0, dim=0, n_shards=0, n_docs_total=0,
             n_pad=0, nbytes=0, vecs=0, vnorm2=0, exists=0,
             ivf=dict(similarity=b.similarity, quant=b.quant,
                      block=b.block, nlist=b.nlist, centroids=b.centroids,
                      default_nprobe=b.default_nprobe, n_blocks=b.n_blocks,
                      cluster_sizes=b.cluster_sizes, shards=b.shards)))
    assert a.nbytes() == b.nbytes()
    qq = qs / np.linalg.norm(qs, axis=1, keepdims=True) \
        if similarity == "cosine" else qs
    for nprobe in (1, 3, 8, 100):
        pa, pb = a.probe(qq, nprobe), b.probe(qq, nprobe)
        assert np.array_equal(pa, pb)
        ua, ub = a.union_blocks(pa, S), b.union_blocks(pb, S)
        assert ua[1] == ub[1] and np.array_equal(ua[0], ub[0])
    da = a.device_arrays("cpu", n_pad)
    db = b.device_arrays(make_search_mesh(n_shards=1, n_replicas=1,
                                          devices=jax.devices()[:1]), n_pad)
    for key in ("scale", "off", "rowid", "rcl"):
        assert np.array_equal(da[key].numpy(), np.asarray(db[key])), key
    if quant == "bf16":
        assert da["codes"].dtype == torch.bfloat16
        got = da["codes"].view(torch.int16).numpy()
        want = np.asarray(db["codes"]).view(np.int16)
    else:
        got, want = da["codes"].numpy(), np.asarray(db["codes"])
    assert np.array_equal(got, want)
    assert a.device_bytes() == sum(int(np.asarray(db[x]).nbytes) for x in
                                   ("codes", "scale", "off", "rowid", "rcl"))


@pytest.mark.parametrize("similarity,quant,S", [
    ("dot_product", "int8", 1), ("cosine", "int8", 3), ("l2_norm", "int8", 1),
    ("cosine", "bf16", 1)])
def test_search_ivf_matches_reference(similarity, quant, S, host_serve_off):
    """``serve`` at the tier's defaults (nprobe 8 of nlist 16, rerank 4) and
    at nprobe 2, rerank 2, k = 10; the stages as the reference computes
    them."""
    shards, qs, vecs = _corpus(41, similarity, S)
    ivf = dict(nlist=16, seed=1, quant=quant)
    jp = _ref_plane(shards, similarity, mesh_shards=2 if S == 3 else 1,
                    ivf=ivf)
    tp = port.DistributedKnnPlane(shards, similarity=similarity, ivf=ivf,
                                  device="cpu")
    tol = knn_tol(qs, vecs, similarity)
    for nprobe, rerank in ((None, None), (2, 2)):
        st, wst = {}, {}
        got = tp.serve(qs, k=10, nprobe=nprobe, rerank=rerank)
        want = jp.serve(qs, k=11, nprobe=nprobe, rerank=rerank, stages=wst)
        _same_topk(got, want, tp.n_pad, tol)
        tp.serve(qs, k=11, nprobe=nprobe, rerank=rerank, stages=st)
        assert st["kernel"] == wst["kernel"] == "knn_ivf"
        assert st["docs_scanned"] == wst["docs_scanned"]
        if S == 1:      # the reference counts its mesh's pad shard too
            for key in ("ann_quantized_bytes", "ann_exact_bytes"):
                assert st[key] == wst[key], key


@pytest.mark.parametrize("similarity", SIMS)
def test_full_probe_with_a_covering_window_equals_exact(similarity,
                                                        host_serve_off):
    """nprobe = nlist and a window that covers the corpus: the IVF route
    returns the exact route's hits (the reference's property), near-tie
    and duplicate rows included; and it matches the reference's IVF
    route."""
    shards, qs, vecs = _corpus(51, similarity, 1)
    ivf = dict(nlist=8, seed=4)
    tp = port.DistributedKnnPlane(shards, similarity=similarity, ivf=ivf,
                                  device="cpu")
    jp = _ref_plane(shards, similarity, ivf=ivf)
    tol = knn_tol(qs, vecs, similarity)
    exact = tp.serve(qs, k=26, nprobe=0)
    got = tp.search_ivf(qs, k=25, nprobe=8, rerank=64)
    _same_topk(got, exact, tp.n_pad, tol)
    _same_topk(got, jp.search_ivf(qs, k=26, nprobe=8, rerank=64), tp.n_pad,
               tol)


def test_ivf_step_pieces_match_the_plain_reference_window():
    """The window (K7's plain version) is the exact top-r_cand over
    positions of the masked dequantized scores, and the re-rank (K8's)
    scores the window's rows exactly."""
    shards, qs, _ = _corpus(61, "dot_product", 1)
    tp = port.DistributedKnnPlane(shards, similarity="dot_product",
                                  ivf=dict(nlist=8, seed=0), device="cpu")
    prep = tp.prepare_ivf(qs, 10, nprobe=3, rerank=4)
    a = prep["args"]
    qq = a["q"]
    qsum, qn = qq.sum(-1), (qq * qq).sum(-1)
    R = prep["r_cand"]
    wv, wp = tk.ivf_scan(a["codes"], a["scale"], a["off"], a["rowid"],
                         a["rcl"], a["vnorm2"], qq, qsum, qn, a["probed"],
                         a["u_blocks"], l2=False, n_pad=tp.n_pad,
                         nlist=tp.ivf.nlist, r_cand=R)
    sc = tk.ivf_scores_plain(a["codes"][0], a["scale"][0], a["off"][0],
                             a["rowid"][0], a["rcl"][0], a["vnorm2"][0], qq,
                             qsum, qn, a["probed"], a["u_blocks"][0],
                             l2=False, n_pad=tp.n_pad).numpy()
    fill = prep["Pw"] * tp.ivf.block
    for b in range(qs.shape[0]):
        fin = np.flatnonzero(np.isfinite(sc[b]))
        order = fin[np.lexsort((fin, -sc[b, fin]))][:R]
        n = order.size
        assert np.array_equal(wp[b, 0, :n].numpy(), order)
        assert np.array_equal(wv[b, 0, :n].numpy(), sc[b, order])
        assert (wp[b, 0, n:] == fill).all()
        assert np.isneginf(wv[b, 0, n:].numpy()).all()
    ex, rows = tk.ivf_rerank(wv, wp, a["u_blocks"], a["rowid"], a["vecs"],
                             a["vnorm2"], qq, qn, l2=False, n_pad=tp.n_pad)
    live = np.isfinite(wv.numpy())
    r = rows.numpy()
    assert (r[~live] == tp.n_pad).all() and (r[live] < tp.n_pad).all()
    want = np.einsum("bd,brd->br", qs, a["vecs"][0].numpy()[r[:, 0].clip(
        0, tp.n_pad - 1)])
    np.testing.assert_allclose(ex.numpy()[:, 0][live[:, 0]],
                               want[live[:, 0]], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("C,k", [(264, 100), (33, 100), (528, 40), (4, 5)])
def test_chunk_reduce_equals_one_pass(C, k):
    """The K3 reduce of the scans' chunk lists (one call over the [R, C·k]
    rows) keeps exactly the one-pass top-k (ids unique in a row, −inf
    slots filled)."""
    rng = np.random.RandomState(C)
    R, fill = 3, 1 << 20
    v = rng.choice(np.linspace(0.0, 1.0, 50, dtype=np.float32),
                   size=(R, C, k))
    ids = np.stack([rng.permutation(fill)[:C * k].reshape(C, k)
                    for _ in range(R)]).astype(np.int32)
    v[rng.rand(R, C, k) < 0.3] = -np.inf
    order = np.lexsort((ids, -v), axis=-1)
    v = np.take_along_axis(v, order, -1)
    ids = np.where(np.isfinite(v), np.take_along_axis(ids, order, -1), fill)
    got = tk.reduce_chunks(torch.from_numpy(v), torch.from_numpy(ids), k=k,
                           fill=fill)
    want = topk_merge_plain(torch.from_numpy(v.reshape(R, C * k)),
                               torch.from_numpy(ids.reshape(R, C * k)),
                               k=k, fill_id=fill)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("rows,k,S,B,n_sm,per_sm,max_tiles,want", [
    # K6 at the hybrid's shape (n_pad 2^22) and the exact route's (2^21):
    # one and two blocks an SM on 132 SMs
    (1 << 22, 100, 1, 16, 132, 1, tk.K6_BITMAP_TILES, 132),
    (1 << 21, 100, 1, 16, 132, 2, tk.K6_BITMAP_TILES, 264),
    # K7's four an SM, over two query tiles
    (1 << 20, 40, 1, 32, 132, 4, None, 264),
    # the bitmap floor: 2^25 rows are 262,144 tiles, 64 blocks at least
    (1 << 25, 10, 1, 16, 8, 1, tk.K6_BITMAP_TILES, 64),
    # K3's cap on chunks · k wins (its 2^15-entry floor at k = 10,000)
    (1 << 21, 10000, 1, 16, 132, 2, tk.K6_BITMAP_TILES, 3),
    # fewer tiles than blocks
    (300, 10, 2, 3, 132, 2, tk.K6_BITMAP_TILES, 3)])
def test_scan_chunks_sizes_the_grid(rows, k, S, B, n_sm, per_sm, max_tiles,
                                    want):
    """K6/K7's blocks along the row axis: ``per_sm`` an SM over the
    (shard, query tile) grid, enough that a K6 block's tiles fit its
    live-tile bitmap, a multiple of the SM count past one wave, and at
    most K3's row cap over k (``topk_merge_row_max``: 2^15 entries where
    two lists of k pass a block's shared memory)."""
    got = tk.scan_chunks(rows, k, S, B, n_sm, per_sm, max_tiles)
    assert got == want
    tiles = -(-rows // tk.TILE_ROWS)
    assert 1 <= got <= tiles and got * k <= tk.topk_merge_row_max(k)
    if got > n_sm:
        assert got % n_sm == 0
