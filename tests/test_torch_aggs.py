"""The port's masked aggregation reductions (``elasticsearch_tpu_torch/ops/
aggs.py``, kernels K12–K15) against the reference's jitted functions
(``elasticsearch_tpu/ops/aggs.py``) on the CPU: the same numpy inputs, made
from seeds, go to both; the port runs its plain versions (CPU tensors).

Bars (the module docstring gives the reasons): counts, the count prefix,
bucket counts, HLL registers, min, max and the host caches bitwise; f32
sums within ``8 · log2(M) · 2^-24`` times the magnitude the reference's f32
order rounds at (the running prefix of |v| for ordinal sums, Σ|v| over the
bucket or the column otherwise); the percentile pick bitwise wherever the
reference compiled the lerp as the port does, ``fma(f, b, (1 - f)·a)``,
and elsewhere equal to the other single-rounding form
``fma(1 - f, a, f·b)`` that XLA:CPU took there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.index.mapping import MapperService
from elasticsearch_tpu.index.segment import SegmentBuilder
from elasticsearch_tpu.ops import aggs as ref
from elasticsearch_tpu.search import aggregations as ref_aggs
from elasticsearch_tpu_torch.kernels import build as kb
from elasticsearch_tpu_torch.ops import aggs as port
from elasticsearch_tpu_torch.ops.blockmax import fma_f32
from torch_cases import agg_pairs_case

U24 = 2.0 ** -24


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(np.ascontiguousarray(a))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# seeded pair layouts
# ---------------------------------------------------------------------------

#: (seed, pairs, runs, n_pad, mask density, doc draw)
CASES = {
    "2^10 pairs, 5 runs": (0, 1 << 10, 5, 1 << 10, 0.5, "perm"),
    "2^12 pairs, 300 runs (many empty)": (1, 1 << 12, 300, 1 << 12, 0.3,
                                          "perm"),
    "2^14 pairs, wrapped and out-of-range docs": (2, 1 << 14, 64, 1 << 12,
                                                  0.25, "wild"),
    "700 pairs in 600 runs (one-pair runs)": (3, 700, 600, 1 << 10, 0.6,
                                              "wild"),
    "2^14 pairs, mask all False": (4, 1 << 14, 40, 1 << 14, 0.0, "perm"),
    "2^14 pairs, mask all True": (5, 1 << 14, 40, 1 << 14, 1.0, "wild"),
}


@pytest.fixture(params=list(CASES), scope="module")
def case(request):
    return agg_pairs_case(*CASES[request.param])


def _abs_masked(c):
    m = port.gather_mask(_t(c["mask"]), _t(c["docs"])).numpy()
    return m, np.where(m, np.abs(c["vals"]).astype(np.float64), 0.0)


def test_gather_mask_follows_the_reference_fill_rule():
    mask = np.array([True, False, False, True, True])
    docs = np.array([-1, 4, 0, -5, 5, -6, 7, 2 ** 31 - 1, -2 ** 31, 2, 3],
                    np.int32)
    want = np.asarray(jnp.take(_j(mask), _j(docs), mode="fill",
                               fill_value=False))
    _bitwise(port.gather_mask(_t(mask), _t(docs)), want)
    assert want[:4].tolist() == [True, True, True, True]   # -1, -5 wrap


def test_ordinal_counts_and_prefix_bitwise(case):
    off, docs, mask = _j(case["off"]), _j(case["docs"]), _j(case["mask"])
    want = ref.masked_ordinal_counts(off, docs, mask)
    _bitwise(port.masked_ordinal_counts(_t(case["off"]), _t(case["docs"]),
                                        _t(case["mask"])), want)
    w_counts, w_c = ref.masked_rank_prefix(off, docs, mask)
    g_counts, g_c = port.masked_rank_prefix(_t(case["off"]),
                                            _t(case["docs"]),
                                            _t(case["mask"]))
    _bitwise(g_counts, w_counts)
    _bitwise(g_c, w_c)


def test_ordinal_sums_within_the_running_prefix(case):
    got = port.masked_ordinal_sums(_t(case["off"]), _t(case["docs"]),
                                   _t(case["vals"]), _t(case["mask"]))
    want = np.asarray(ref.masked_ordinal_sums(
        _j(case["off"]), _j(case["docs"]), _j(case["vals"]),
        _j(case["mask"])))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _m, absmv = _abs_masked(case)
    prefix = np.concatenate([[0.0], np.cumsum(absmv)])[case["off"][1:]]
    tol = 8 * np.log2(case["M"]) * U24 * prefix
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err <= tol).all(), err.max()
    # the plain version rounds the f64 run sums once
    off = case["off"]
    exact = np.array([absmv[off[v]:off[v + 1]].sum()
                      for v in range(len(off) - 1)])
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))


def _sorted_rhos(case, seed):
    rng = np.random.RandomState(seed)
    rhos = rng.randint(1, 52, case["M"]).astype(np.int32)
    off = case["off"]
    for v in range(len(off) - 1):
        rhos[off[v]:off[v + 1]].sort()
    return rhos


def test_register_max_bitwise(case):
    rhos = _sorted_rhos(case, 7)
    want = ref.masked_register_max(_j(case["off"]), _j(case["docs"]),
                                   _j(rhos), _j(case["mask"]))
    got = port.masked_register_max(_t(case["off"]), _t(case["docs"]),
                                   _t(rhos), _t(case["mask"]))
    _bitwise(got, want)
    m, _ = _abs_masked(case)
    off = case["off"]
    top = [rhos[off[v]:off[v + 1]][m[off[v]:off[v + 1]]].max(initial=0)
           for v in range(len(off) - 1)]
    np.testing.assert_array_equal(got.numpy(), top)


@pytest.mark.parametrize("n_buckets", [8, 64, 4096])
def test_bucket_counts_bitwise_and_sums_within_bucket_mass(case, n_buckets):
    rng = np.random.RandomState(n_buckets)
    used = max(n_buckets - 3, 1)        # nb_pad > n_buckets: ids past it
    ids = rng.randint(0, used, case["M"]).astype(np.int32)
    ids[rng.rand(case["M"]) < 0.05] = -1
    ids[rng.rand(case["M"]) < 0.02] = n_buckets + 2
    args = (case["docs"], case["mask"])
    want = ref.masked_bucket_counts(_j(ids), *map(_j, args),
                                    n_buckets=n_buckets)
    got = port.masked_bucket_counts(_t(ids), *map(_t, args),
                                    n_buckets=n_buckets)
    _bitwise(got, want)
    want_s = np.asarray(ref.masked_bucket_sums(
        _j(ids), _j(case["docs"]), _j(case["vals"]), _j(case["mask"]),
        n_buckets=n_buckets))
    got_s = port.masked_bucket_sums(_t(ids), _t(case["docs"]),
                                    _t(case["vals"]), _t(case["mask"]),
                                    n_buckets=n_buckets).numpy()
    m, absmv = _abs_masked(case)
    ok = m & (ids >= 0) & (ids < n_buckets)
    mass = np.bincount(np.where(ok, ids, n_buckets),
                       weights=np.where(ok, absmv, 0.0),
                       minlength=n_buckets + 1)[:n_buckets]
    tol = 8 * np.log2(case["M"]) * U24 * mass
    assert (np.abs(got_s.astype(np.float64) - want_s) <= tol).all()
    assert (got_s[used:] == 0).all() and (got.numpy()[used:] == 0).all()


def test_metrics(case):
    want = [np.asarray(x) for x in ref.masked_metrics(
        _j(case["docs"]), _j(case["vals"]), _j(case["mask"]))]
    got = port.masked_metrics(_t(case["docs"]), _t(case["vals"]),
                              _t(case["mask"]))
    assert all(g.dtype == torch.float32 and g.shape == () for g in got)
    got = [g.numpy() for g in got]
    for i in (0, 2, 3):                 # count (< 2^24), min, max
        _bitwise(got[i], want[i])
    m, absmv = _abs_masked(case)
    tol = 8 * np.log2(case["M"]) * U24 * absmv.sum()
    assert abs(float(got[1]) - float(want[1])) <= tol
    if not m.any():
        assert float(got[2]) == np.inf and float(got[3]) == -np.inf
        assert float(got[0]) == 0.0 and float(got[1]) == 0.0


# ---------------------------------------------------------------------------
# the percentile pick
# ---------------------------------------------------------------------------


def _lerp_forms(c, off, vals, ords, lo, hi, frac):
    """The two single-rounding forms XLA:CPU may compile the lerp into: the
    port's ``fma(f, b, (1-f)·a)`` and ``fma(1-f, a, f·b)``."""
    c, off = np.asarray(c), np.asarray(off)
    base = c[off[ords]]

    def pick(rank):
        idx = np.searchsorted(c, base[:, None] + rank + 1, side="left") - 1
        return vals[np.clip(idx, 0, vals.shape[0] - 1)]

    a, b, f = _t(pick(lo)), _t(pick(hi)), _t(frac)
    return (fma_f32(f, b, (1.0 - f) * a).numpy(),
            fma_f32(1.0 - f, a, f * b).numpy())


def _assert_pick(got, want, ours, other):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(ours))
    same = _bits(want) == _bits(ours)
    assert (same | (_bits(want) == _bits(other))).all()
    return same.mean()


@pytest.mark.parametrize("B,R", [(10, 3), (64, 7), (16, 3), (1, 1)])
def test_rank_pick_matches_the_reference_lerp(B, R):
    rng = np.random.RandomState(B * 100 + R)
    M, V = 1 << 14, max(B, 12)
    vals = np.sort(rng.lognormal(3, 1, M).astype(np.float32))
    c = np.concatenate([[0], np.cumsum(rng.rand(M) < 0.4)]).astype(np.int32)
    off = np.sort(rng.randint(0, M, V + 1)).astype(np.int32)
    off[0], off[-1] = 0, M
    ords = rng.randint(0, V, B).astype(np.int32)
    n = np.diff(c[off])[ords]
    lo = np.stack([rng.randint(0, max(k, 1), R) for k in n]).astype(np.int32)
    hi = np.minimum(lo + 1, np.maximum(n[:, None] - 1, 0)).astype(np.int32)
    frac = rng.rand(B, R).astype(np.float32)
    args = (c, off, vals, ords, lo, hi, frac)
    want = np.asarray(ref._rank_pick(*map(_j, args)))
    got = port.rank_pick(*map(_t, args)).numpy()
    share = _assert_pick(got, want, *_lerp_forms(*args))
    if (B, R) == (10, 3):               # config #3's shape
        assert share == 1.0


@pytest.mark.parametrize("what", ["q 0 and 100", "one-pair runs",
                                  "duplicates", "empty buckets"])
def test_percentiles_edge_cases(what):
    rng = np.random.RandomState(11)
    n_pad, V = 1 << 10, 12
    if what == "one-pair runs":
        lens = np.ones(V, np.int64)
    else:
        lens = rng.randint(0, 40, V)
        lens[[2, 7]] = 0 if what == "empty buckets" else lens[[2, 7]]
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    M = int(off[-1])
    docs = rng.permutation(n_pad)[:M].astype(np.int32)
    vals = rng.lognormal(3, 1, M).astype(np.float32)
    if what == "duplicates":
        vals = np.round(vals / 10).astype(np.float32)
    for v in range(V):
        vals[off[v]:off[v + 1]].sort()
    mask = rng.rand(n_pad) < 0.7
    mask[docs[off[1]:off[2]]] = False          # run 1 matches nothing
    ords = np.arange(V, dtype=np.int32)
    qs = [0.0, 100.0] if what == "q 0 and 100" else [0, 25, 50, 95, 99, 100]
    want = ref.masked_ordinal_percentiles(_j(off), _j(docs), _j(vals),
                                          _j(mask), ords, qs)
    got = port.masked_ordinal_percentiles(_t(off), _t(docs), _t(vals),
                                          _t(mask), ords, qs)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]).all()
    counts, c = port.masked_rank_prefix(_t(off), _t(docs), _t(mask))
    lo, hi, frac = port.hazen_ranks(counts.numpy()[ords], qs)
    ours, other = _lerp_forms(c.numpy(), off, vals, ords, lo, hi, frac)
    live = ~np.isnan(want)
    _assert_pick(got[live], want[live], ours[live], other[live])
    # exact: each is the numpy Hazen percentile of the run's masked values
    m = mask[docs]
    for o in ords:
        run = vals[off[o]:off[o + 1]][m[off[o]:off[o + 1]]]
        if run.size:
            np.testing.assert_allclose(
                got[o], np.percentile(run.astype(np.float64), qs,
                                      method="hazen"), rtol=1e-6)


def test_top_ordinals_ties_go_to_the_lower_ordinal():
    counts = np.array([3, 7, 7, 0, 7, 3, 1, 7, 2], np.int32)
    for k in (1, 3, 4, 9, 20):
        wv, wo = ref.top_ordinals(_j(counts), k)
        gv, go = port.top_ordinals(_t(counts), k)
        _bitwise(gv, wv)
        _bitwise(go, wo)


def config3_columns(rng, n, V=256):
    """The terms + percentiles bench's columns (``bench.py:482-539``): V
    Zipf(1.1) ordinals, lognormal(3, 1) values, pairs sorted by (ordinal,
    value), one pair a doc."""
    pmf = np.arange(1, V + 1, dtype=np.float64) ** -1.1
    pmf /= pmf.sum()
    ords = rng.choice(V, size=n, p=pmf).astype(np.int32)
    vals = rng.lognormal(3.0, 1.0, n).astype(np.float32)
    order = np.lexsort((vals, ords))
    offsets = np.cumsum(np.concatenate(
        [[0], np.bincount(ords[order], minlength=V)])).astype(np.int32)
    return ords, vals, offsets, np.arange(n, dtype=np.int32)[order], \
        vals[order]


def test_config3_route_end_to_end():
    """Mask → prefix → top 10 → percentiles [50, 95, 99], as the terms +
    percentiles bench runs it, against the reference and numpy."""
    rng = np.random.RandomState(3)
    n = 1 << 14
    ords, vals, off, docs_s, vals_s = config3_columns(rng, n)
    qs = [50.0, 95.0, 99.0]
    for _ in range(3):
        mask = rng.rand(n) < 0.25
        counts, c = port.masked_rank_prefix(_t(off), _t(docs_s), _t(mask))
        _vals, top = port.top_ordinals(counts, 10)
        got = port.prefix_percentiles(counts, c, _t(off), _t(vals_s), top,
                                      qs)
        np.testing.assert_array_equal(got, port.masked_ordinal_percentiles(
            _t(off), _t(docs_s), _t(vals_s), _t(mask), top, qs))
        w_counts, _ = ref.masked_rank_prefix(_j(off), _j(docs_s), _j(mask))
        _wv, w_top = ref.top_ordinals(w_counts, 10)
        want = ref.masked_ordinal_percentiles(
            _j(off), _j(docs_s), _j(vals_s), _j(mask),
            w_top.astype(np.int32), qs)
        np.testing.assert_array_equal(top, w_top)
        np.testing.assert_array_equal(got, want)
        cnt = np.bincount(ords[mask], minlength=256)
        np.testing.assert_array_equal(
            top, np.argsort(-cnt, kind="stable")[:10])
        np.testing.assert_allclose(got, np.stack([
            np.percentile(vals[mask & (ords == o)].astype(np.float64), qs,
                          method="hazen") for o in top]), rtol=1e-6)


# ---------------------------------------------------------------------------
# the per-segment caches and the host helpers
# ---------------------------------------------------------------------------

MAPPING = {"properties": {"tag": {"type": "keyword"},
                          "price": {"type": "double"},
                          "ts": {"type": "date"}}}


@pytest.fixture(scope="module")
def segment():
    rng = np.random.RandomState(3)
    mapper = MapperService(MAPPING)
    b = SegmentBuilder("_a0")
    for i in range(300):
        doc = {"tag": [f"k{rng.randint(40)}" for _ in range(
                   rng.randint(0, 3))],
               "price": float(rng.randint(100)) + 0.25,
               "ts": 1_700_000_000_000 + i * 600_000}
        if i % 17 == 5:
            del doc["price"]
        b.add(mapper.parse_document(str(i), doc), seq_no=i)
    return b.build()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_caches_are_byte_equal_and_apart_on_one_segment(segment):
    g_off, g_docs, g_v = port.ordinal_csr(segment, "tag", device="cpu")
    w_off, w_docs, w_v = ref.ordinal_csr(segment, "tag")
    assert g_v == w_v
    _bitwise(g_off, w_off)
    _bitwise(g_docs, w_docs)
    for field in ("tag", "price"):
        g = port.hll_sketch_pairs(segment, field, device="cpu")
        w = ref.hll_sketch_pairs(segment, field)
        assert g.keys() == w.keys()
        for key in ("off_dev", "docs_dev", "rhos_dev", "reg", "rho", "docs"):
            assert isinstance(g[key], (torch.Tensor, np.ndarray))
            _bitwise(_np(g[key]), w[key])
        assert (g["m"], g["n_pairs"]) == (w["m"], w["n_pairs"])
        mask = np.random.RandomState(5).rand(segment.n_pad) < 0.5
        host = port.host_register_max(g, mask)
        _bitwise(host, ref.host_register_max(w, mask))
        regs = port.masked_register_max(g["off_dev"], g["docs_dev"],
                                        g["rhos_dev"], _t(mask))
        _bitwise(regs, ref.masked_register_max(
            w["off_dev"], w["docs_dev"], w["rhos_dev"], _j(mask)))
        _bitwise(regs[:g["m"]], host)          # padded registers stay 0
        assert not regs[g["m"]:].any()
        assert port.distinct_count(segment, field) == \
            ref.distinct_count(segment, field)
    for field, interval, offset in (("price", 10.0, 0.0),
                                    ("ts", 3_600_000.0, 0.0),
                                    ("price", 0.01, 0.5)):
        g = port.histogram_bucket_ids(segment, field, interval, offset,
                                      device="cpu")
        w = ref.histogram_bucket_ids(segment, field, interval, offset)
        assert g[2:] == w[2:]
        for x, y in zip(g[:2], w[:2]):
            assert (x is None) == (y is None)
            if x is not None:
                _bitwise(x, y)
    # one segment object through both packages: each keeps its own cache
    assert segment._agg_torch_cache is not segment._agg_dev_cache
    again = port.ordinal_csr(segment, "tag", device="cpu")
    assert again[0] is g_off and isinstance(again[0], torch.Tensor)
    assert not isinstance(ref.ordinal_csr(segment, "tag")[0], torch.Tensor)


@pytest.mark.parametrize("seed", [0, 1])
def test_caches_match_on_shuffled_pairs_with_ties(seed):
    """Doc values in no doc order, with repeated (doc, ordinal) pairs and
    repeated values: the ordinal CSR and the HLL pairs (whose docs follow
    lexsort's stable order among (register, rho) ties) stay byte-equal."""
    import types
    rng = np.random.RandomState(seed)
    n_docs, M = 5000, 20000
    docs = rng.randint(0, n_docs, M).astype(np.int32)
    seg = types.SimpleNamespace(
        n_docs=n_docs, n_pad=port.round_up_pow2(n_docs),
        keyword_fields={"k": types.SimpleNamespace(
            dv_docs_host=docs, dv_ords_host=rng.randint(
                0, 300, M).astype(np.int32),
            ord_terms=[f"t{i}" for i in range(300)])},
        numeric_fields={"x": types.SimpleNamespace(
            docs_host=docs[::-1].copy(),
            vals_host=rng.randint(0, 50, M).astype(np.float64) / 4)})
    for x, y in zip(port.ordinal_csr(seg, "k", device="cpu")[:2],
                    ref.ordinal_csr(seg, "k")[:2]):
        _bitwise(x, y)
    for field in ("k", "x"):
        g = port.hll_sketch_pairs(seg, field, p=6, device="cpu")
        w = ref.hll_sketch_pairs(seg, field, p=6)
        for key in ("off_dev", "docs_dev", "rhos_dev", "reg", "rho", "docs"):
            _bitwise(_np(g[key]), w[key])


@pytest.mark.parametrize("p", [18, 22, 23])
def test_hll_pairs_at_the_precision_limits(segment, p):
    """Elasticsearch's largest precision (18) and the packed sort key's
    (22) stay byte-equal to the reference; above 22 the port refuses."""
    if p > 22:
        with pytest.raises(ValueError, match="above 22"):
            port.hll_sketch_pairs(segment, "price", p=p, device="cpu")
        return
    g = port.hll_sketch_pairs(segment, "price", p=p, device="cpu")
    w = ref.hll_sketch_pairs(segment, "price", p=p)
    for key in ("off_dev", "docs_dev", "rhos_dev", "reg", "rho", "docs"):
        _bitwise(_np(g[key]), w[key])


def test_bucket_counts_over_the_histogram_cache(segment):
    ids, docs, n_buckets, _base = port.histogram_bucket_ids(
        segment, "price", 10.0, 0.0, device="cpu")
    w_ids, w_docs, _, _ = ref.histogram_bucket_ids(segment, "price", 10.0,
                                                   0.0)
    nb = port.round_up_pow2(n_buckets)
    mask = np.random.RandomState(9).rand(segment.n_docs) < 0.6
    g_mask = port.device_mask(segment, mask, device="cpu")
    w_mask = ref_aggs._device_mask(segment, mask)
    _bitwise(g_mask, w_mask)
    _bitwise(port.masked_bucket_counts(ids, docs, g_mask, n_buckets=nb),
             ref.masked_bucket_counts(w_ids, w_docs, w_mask, n_buckets=nb))


def test_hll_host_helpers_match():
    values = ["a", "b", "ünï", "", 1.5, -0.0, 3, 1e300]
    for v in values:
        assert port.value_hash_u64(v) == ref.value_hash_u64(v)
    g = port.hll_add_values(np.zeros(1 << 6, np.int32), values, 6)
    w = ref.hll_add_values(np.zeros(1 << 6, np.int32), values, 6)
    _bitwise(g, w)
    other = np.random.RandomState(1).randint(0, 9, 1 << 6).astype(np.int32)
    _bitwise(port.hll_merge(g, other), ref.hll_merge(w, other))
    for regs in (g, other, np.zeros(1 << 14, np.int32),
                 np.random.RandomState(2).randint(0, 30, 1 << 14)):
        assert port.hll_estimate(regs) == ref.hll_estimate(regs)
    h = np.random.RandomState(4).randint(0, 2 ** 63, 4096, dtype=np.int64) \
        .astype(np.uint64)
    h[:3] = [0, 1, 2 ** 63]
    for p in (4, 14):
        for x, y in zip(port._hll_reg_rho(h, p), ref._hll_reg_rho(h, p)):
            _bitwise(x, y)


def test_caches_default_to_cuda_and_raise_without_it(segment, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: port.ordinal_csr(segment, "tag"),
                 lambda: port.hll_sketch_pairs(segment, "price"),
                 lambda: port.histogram_bucket_ids(segment, "price", 5.0,
                                                   0.0),
                 lambda: port.device_mask(segment, np.ones(3, bool))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_wrappers_refuse_devices_they_have_no_kernel_for():
    meta = torch.device("meta")
    i = torch.empty(16, dtype=torch.int32, device=meta)
    f = torch.empty(16, device=meta)
    m = torch.empty(32, dtype=torch.bool, device=meta)
    i2 = torch.empty(2, 3, dtype=torch.int32, device=meta)
    before = dict(kb.launches)
    calls = [
        lambda: port.masked_ordinal_counts(i[:5], i, m),
        lambda: port.masked_ordinal_sums(i[:5], i, f, m),
        lambda: port.masked_rank_prefix(i[:5], i, m),
        lambda: port.rank_pick(i, i[:5], f, i[:2], i2, i2,
                               torch.empty(2, 3, device=meta)),
        lambda: port.register_max(i, i[:5], i),
        lambda: port.masked_bucket_counts(i, i, m, n_buckets=8),
        lambda: port.masked_bucket_sums(i, i, f, m, n_buckets=8),
        lambda: port.masked_metrics(i, f, m)]
    for call in calls:
        with pytest.raises(ValueError):
            call()
    with pytest.raises(ValueError):
        port.masked_scan(_t(np.zeros(2, np.int32)), _t(np.zeros(1, np.int32)),
                         _t(np.ones(1, bool)), mode="max")
    with pytest.raises(ValueError):
        port.masked_bucket_counts(_t(np.zeros(1, np.int32)),
                                  _t(np.zeros(1, np.int32)),
                                  _t(np.ones(1, bool)), n_buckets=8192)
    assert kb.launches == before
