"""K11's count limit (``csrc/rescore_reorder.cu``), which its wrapper
shares, and K20's shapes (``csrc/tree_eval.cu``), read from the sources,
and models of the two kernels' algorithms held against the plain versions
and the JAX package, on the CPU, bit for bit.

K11 ranks a query of at most ``K11_COUNT_MAX`` entries by counting: a
window entry's output position is the count of window entries with a
smaller key (the ordered bits of −ns, ±0 one value, above the id) or an
equal key at an earlier position; a live tail entry's is the window's
count plus the live tail entries before it, a −inf entry's the live count
plus the −inf entries before it. K20 walks a packed 16-byte record a node
(``min(feat, F) << 1 | (dleft != 0)``, or −1 for a leaf; the threshold's
bits; left; right) over X rows staged with a NaN column at index F, several
walks a thread, for a batch in doc tiles and tree groups; for a few docs
a block stages a tree in shared memory and walks it a thread a doc. The
models below follow those steps in numpy; the card tests
(``tests/test_torch_cuda.py``) hold the kernels to the plain versions.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import fused_query as rfq
from elasticsearch_tpu.xpack import ml as R
from elasticsearch_tpu_torch.kernels.build import CSRC_DIR
from elasticsearch_tpu_torch.ops import fused_query as fq
from elasticsearch_tpu_torch.xpack import ml as P
from torch_cases import full_tree_arrays, rescore_case, tree_arrays_case

K11_SRC = (CSRC_DIR / "rescore_reorder.cu").read_text()
K20_SRC = (CSRC_DIR / "tree_eval.cu").read_text()


def _defines(src, prefix):
    return {m[1]: int(m[2], 0) for m in
            re.finditer(rf"^#define {prefix}_(\w+) (0x[0-9A-Fa-f]+|\d+)",
                        src, re.M)}


K11 = _defines(K11_SRC, "K11")
K20 = _defines(K20_SRC, "K20")
F32 = np.float32
MODES = fq.RESCORE_MODES
TREE_KEYS = ("X", "feats", "thresh", "left", "right", "dleft")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    return np.asarray(a, F32).view(np.int32)


# ---------------------------------------------------------------------------
# the sizes
# ---------------------------------------------------------------------------


def test_k11_count_limit_is_the_sources():
    """The wrapper's K11_COUNT_MAX is the source's (K10's 512), and the
    counting path's static arrays (a key of 8 bytes an entry, three counts
    a warp) fit the 48 KB a block has without opting in."""
    assert fq.K11_COUNT_MAX == K11["COUNT_MAX"] == fq.K10_COUNT_MAX == 512
    assert K11["COUNT_MAX"] * 8 + 3 * (K11["COUNT_MAX"] // 32) * 4 \
        <= 48 * 1024


def test_k20_shapes_are_the_sources():
    """A batch block's threads are whole warps along docs; a thread's
    walks are a few; a few-docs block has a thread for each of its docs;
    the pack refuses feature counts its shifted field cannot hold."""
    assert K20["THREADS"] % (32 * K20["DOC_WARPS"]) == 0
    assert 2 <= K20["WALKS"] <= 8 and 1 <= K20["FEW_DOCS"] < 32
    assert K20["FEW_DOCS"] <= K20["FEW_THREADS"]
    with pytest.raises(ValueError, match="F < 2"):
        P.pack_tree_nodes(*(torch.zeros((1, 1), dtype=dt) for dt in (
            torch.int32, torch.float32, torch.int32, torch.int32,
            torch.int32)), F=1 << 30)


# ---------------------------------------------------------------------------
# K11: the counting rank's model
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """Correctly rounded f32 a·b + c (the TwoSum round-to-odd of
    ``ops/blockmax.fma_f32``, in numpy)."""
    p = np.float64(a) * np.float64(b)
    c = np.float64(c)
    s = p + c
    bp = s - c
    err = (p - (s - bp)) + (c - bp)
    if err != 0 and (np.array(s).view(np.int64) & 1) == 0:
        s = np.nextafter(s, np.inf if err > 0 else -np.inf)
    return F32(s)


def _combine(mode, ps, rw, sec):
    rs = F32(rw * sec)
    if mode == "total":
        return _fma(rw, sec, ps)
    if mode == "multiply":
        return F32(ps * rs)
    if mode == "avg":
        return F32(_fma(rw, sec, ps) / F32(2))
    return F32(max(ps, rs)) if mode == "max" else F32(min(ps, rs))


def _key(ns, i):
    """The counting path's key of a window entry: −ns's ordered bits (±0
    one value, every NaN the canonical one) above the id's."""
    k2 = F32(-ns)
    u = 0x7FC00000 if np.isnan(k2) else \
        int(np.array(F32(0.0) if k2 == 0 else k2).view(np.uint32))
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (u << 32) | ((int(i) ^ 0x80000000) & 0xFFFFFFFF)


def count_rank_model(vals, ids, sec, matched, qw, rw, window, *, mode, k,
                     pad_id):
    """K11's counting path in numpy, query by query."""
    B, n = vals.shape
    out_v = np.full((B, k), -np.inf, F32)
    out_i = np.full((B, k), pad_id, np.int32)
    for b in range(B):
        m = min(n, max(int(window[b]), 0))
        region = np.full(n, 2)
        ns = np.full(n, -np.inf, F32)
        for j in range(n):
            if vals[b, j] > -np.inf:
                ps = F32(qw[b] * vals[b, j])
                region[j] = 0 if j < window[b] else 1
                ns[j] = _combine(mode, ps, rw[b], sec[b, j]) \
                    if region[j] == 0 and matched[b, j] else ps
        key = [_key(ns[j], ids[b, j]) if region[j] == 0 else (1 << 64) - 1
               for j in range(m)]
        n_win = int((region == 0).sum())
        n_live = n_win + int((region == 1).sum())
        before = np.zeros(3, np.int64)
        for j in range(n):
            if region[j] == 0:
                r = sum(key[i] < key[j] or (key[i] == key[j] and i < j)
                        for i in range(m))
            else:
                r = (n_win if region[j] == 1 else n_live) + before[region[j]]
                before[region[j]] += 1
            if r < k:
                out_v[b, r] = ns[j]
                out_i[b, r] = ids[b, j] if ns[j] > -np.inf else pad_id
    return out_v, out_i


def _plain(args, **kw):
    return [x.numpy() for x in fq.rescore_reorder_body(
        *(_t(a) for a in args), **kw)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [1, 24, 100])
def test_count_rank_model_equals_plain(mode, n):
    """The model's outputs are the plain version's bits at every k: below
    the window, between the window and n, at n, past n."""
    args = rescore_case(n, 9, n, mode)
    for k in sorted({1, 3, 10, n, n + 4}):
        want = _plain(args, mode=mode, k=k, pad_id=1 << 30)
        got = count_rank_model(*args, mode=mode, k=k, pad_id=1 << 30)
        assert np.array_equal(_bits(got[0]), _bits(want[0]))
        assert np.array_equal(got[1], want[1])


def test_count_rank_model_keeps_duplicate_ids_by_position():
    """Equal combined scores and equal ids in one window order by position
    (the key ties; the plain version's sorts are stable)."""
    for mode in MODES:
        args = list(rescore_case(5, 4, 40, mode))
        args[1] = (args[1] % 3).astype(np.int32)
        args[6] = np.array([40, 40, 20, 7], np.int32)
        want = _plain(args, mode=mode, k=40, pad_id=99)
        got = count_rank_model(*args, mode=mode, k=40, pad_id=99)
        assert np.array_equal(_bits(got[0]), _bits(want[0]))
        assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [24, fq.K11_COUNT_MAX, fq.K11_COUNT_MAX + 1])
def test_count_rank_model_matches_reference(mode, n):
    """The model and the plain version against the JAX package's
    ``rescore_reorder_body`` (vmapped over the queries): at n at the
    counting limit and one past it (the kernel's sorting path there),
    k below the window, at n and past n."""
    args = rescore_case(100 + n, 8, n, mode)
    for k in (10, n + 4):
        f = jax.jit(jax.vmap(functools.partial(
            rfq.rescore_reorder_body, mode=mode, k=k, pad_id=1 << 30)))
        wv, wi = (np.asarray(x) for x in f(*args))
        pv, pi = _plain(args, mode=mode, k=k, pad_id=1 << 30)
        assert np.array_equal(_bits(pv), _bits(wv))
        assert np.array_equal(pi, wi)
        if n <= 100 or k == 10:
            mv, mi = count_rank_model(*args, mode=mode, k=k, pad_id=1 << 30)
            assert np.array_equal(_bits(mv), _bits(wv))
            assert np.array_equal(mi, wi)


def test_count_rank_model_orders_nan_last():
    """A NaN combined score (only from infinite inputs) sorts after every
    number of the window, as torch.sort orders it, with the pad id."""
    vals = np.array([[np.inf, 2.0, 1.0, 0.5]], F32)
    ids = np.array([[7, 3, 5, 9]], np.int32)
    sec = np.array([[1.0, 1.0, 1.0, 1.0]], F32)
    matched = np.array([[True, True, False, True]])
    qw, rw = np.array([1.0], F32), np.array([0.0], F32)
    args = (vals, ids, sec, matched, qw, rw, np.array([4], np.int32))
    want = _plain(args, mode="multiply", k=4, pad_id=-1)
    with np.errstate(invalid="ignore"):
        got = count_rank_model(*args, mode="multiply", k=4, pad_id=-1)
    assert np.isnan(want[0][0, 3]) and want[1][0, 3] == -1
    assert np.array_equal(np.isnan(got[0]), np.isnan(want[0]))
    fin = ~np.isnan(want[0])
    assert np.array_equal(got[0][fin], want[0][fin])
    assert np.array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# K20: the node pack and the walk's model
# ---------------------------------------------------------------------------


def pack_model(feats, thresh, left, right, dleft, F):
    """``pack_tree_nodes`` in numpy."""
    x = np.where(feats < 0, -1,
                 (np.minimum(feats, F) << 1) | (dleft != 0)).astype(np.int32)
    return np.stack([x, np.asarray(thresh, F32).view(np.int32), left,
                     right], -1).astype(np.int32)


def walk_model(X, nodes, depth):
    """K20's walk over the pack in numpy, every (tree, doc) at once: a
    staged row holds NaN at column F; a leaf's walk stops (its index
    stays); a level reads the whole record at the wrapped, clamped
    index."""
    T, N, _ = nodes.shape
    n, F = X.shape
    Xs = np.concatenate([X, np.full((n, 1), np.nan, F32)], 1)
    idx = np.zeros((T, n), np.int64)
    live = np.ones((T, n), bool)
    t = np.arange(T)[:, None]
    for _ in range(depth):
        if not live.any():
            break
        j = np.clip(np.where(idx < 0, idx + N, idx), 0, N - 1)
        nd = nodes[t, j]                              # (T, n, 4)
        f = nd[..., 0]
        live &= f >= 0
        xv = Xs[np.arange(n)[None, :], np.maximum(f, 0) >> 1]
        go = np.where(np.isnan(xv), (f & 1) != 0,
                      xv < nd[..., 1].view(F32))
        idx = np.where(live, np.where(go, nd[..., 2], nd[..., 3]), idx)
    return idx.astype(np.int32)


def _dleft_wide(c, seed):
    """The case with dleft values of -1, 0, 1 and 2."""
    c = dict(c)
    c["dleft"] = np.random.RandomState(seed).choice(
        np.array([-1, 0, 1, 2], np.int32), c["dleft"].shape)
    return c


TREE_CASES = {
    "edges": lambda: (tree_arrays_case(31, T=9, N=7, n=60, F=4), 6),
    "one_node": lambda: (tree_arrays_case(32, T=3, N=1, n=5, F=1), 3),
    "dleft_wide": lambda: (_dleft_wide(
        tree_arrays_case(33, T=6, N=15, n=40, F=3), 3), 8),
    "one_doc": lambda: (tree_arrays_case(34, T=40, N=31, n=1, F=6), 7),
    "full": lambda: (full_tree_arrays(35, T=12, depth=5, F=8, n=50), 6),
    "deep": lambda: (full_tree_arrays(36, T=2, depth=12, F=16, n=9), 13),
    "wide_rows": lambda: (tree_arrays_case(37, T=5, N=300, n=12, F=400),
                          9),
}


def _case(name):
    return TREE_CASES[name]()


def _reference(c, depth):
    return np.asarray(R._eval_trees(*(jnp.asarray(c[k]) for k in TREE_KEYS),
                                    depth))


@pytest.mark.parametrize("name", sorted(TREE_CASES))
def test_pack_model_equals_pack_tree_nodes(name):
    """The torch pack is the numpy model's: feature indices past F become
    F, negative ones the leaf mark, every nonzero dleft bit 0, thresholds
    their bits."""
    c, _ = _case(name)
    F = c["X"].shape[1]
    got = P.pack_tree_nodes(*(_t(c[k]) for k in TREE_KEYS[1:]), F).numpy()
    want = pack_model(*(c[k] for k in TREE_KEYS[1:]), F)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(TREE_CASES))
@pytest.mark.parametrize("depth_cut", [None, 0, 1])
def test_walk_model_equals_plain_and_reference(name, depth_cut):
    """The walk over the pack, the plain version over the node arrays, and
    the JAX package's ``_eval_trees`` give the same leaf ids: features
    past F, leaves, negative and out-of-range children, dleft of -1 and
    2, depth 0 and 1, one doc."""
    c, depth = _case(name)
    if depth_cut is not None:
        depth = depth_cut
    F = c["X"].shape[1]
    want = _reference(c, depth)
    nodes = pack_model(*(c[k] for k in TREE_KEYS[1:]), F)
    assert np.array_equal(walk_model(c["X"], nodes, depth), want)
    plain = P._eval_trees_plain(*(_t(c[k]) for k in TREE_KEYS), depth)
    assert np.array_equal(plain.numpy(), want)
    pack = P.TreePack(*(_t(c[k]) for k in TREE_KEYS[1:]), F=F)
    got = P.eval_tree_pack(_t(c["X"]), pack, depth)
    assert np.array_equal(got.numpy(), want)


def test_trained_model_packs_once():
    """A model packs its trees once, over its own feature count, and its
    inference walks the pack (the plain version on the CPU)."""
    names = ["a", "b"]
    body = {"inference_config": {"regression": {}},
            "definition": {"trained_model": {"tree": {
                "feature_names": names, "tree_structure": [
                    {"node_index": 0, "split_feature": 5,
                     "threshold": 0.5, "left_child": 1,
                     "right_child": 2, "default_left": False},
                    {"node_index": 1, "split_feature": 1,
                     "threshold": 0.0, "left_child": 3, "right_child": 4},
                    {"node_index": 2, "leaf_value": 2.0},
                    {"node_index": 3, "leaf_value": 3.0},
                    {"node_index": 4, "leaf_value": 4.0}]}}}}
    m = P.TrainedModel("m", body, device="cpu")
    pack = m._pack
    assert (pack.T, pack.N, pack.F) == (1, 5, 2)
    want = pack_model(*(a.numpy() for a in m._dev_arrays), 2)
    assert np.array_equal(pack.nodes.numpy(), want)
    assert want[0, 0, 0] == 2 << 1      # feature 5 >= F reads NaN: F
    docs = [{"a": 1.0, "b": -1.0}, {"b": 1.0}, {}]
    ref = R.TrainedModel("m", body)
    assert m.infer(docs) == ref.infer(docs)
