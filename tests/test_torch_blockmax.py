"""The port's block-max pruned route against the JAX package, on the CPU.

The same seeded numpy corpus goes to both planes: the JAX plane runs its
jitted pruned step (host serving off, no host CSR), the port plane its plain
PyTorch versions of K4 (``blockmax_scan``) and K5 (``bisect_exact_scores``)
with ``device="cpu"``. Every comparison here is exact: the tier's arrays and
schedules are equal array for array, scores are bitwise equal, and hits,
totals (``gte`` tuples included) and the step's matched / unsafe / pruned /
blocks-scored counts are equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from elasticsearch_tpu.ops.fused_query import \
    bisect_exact_scores as jax_bisect
from elasticsearch_tpu.parallel import make_search_mesh
from elasticsearch_tpu.parallel.dist_search import \
    DistributedSearchPlane as JaxPlane
from elasticsearch_tpu_torch.ops.blockmax import (blockmax_scan,
                                                  blockmax_scan_plain,
                                                  fma_f32)
from elasticsearch_tpu_torch.ops.fused_query import (
    bisect_exact_scores, bisect_exact_scores_plain)
from elasticsearch_tpu_torch.parallel.dist_search import (
    LEX_THETA_WINDOW, DistributedSearchPlane, pruned_bm25_step,
    total_is_lower_bound, total_value)
from elasticsearch_tpu_torch.utils.synth import (split_csr_shards,
                                                 synthetic_csr_corpus_fast)
from torch_cases import query_mix

N_DOCS, VOCAB, AVG_DL = 4096, 256, 16


def _corpus(seed=8, n_docs=N_DOCS, vocab=VOCAB, avgdl=AVG_DL):
    c = synthetic_csr_corpus_fast(np.random.RandomState(seed), n_docs,
                                  vocab, avgdl, zipf_s=1.2)
    c["term_ids"] = {f"t{t}": t for t in range(vocab)}
    return c


def _shards(corpus, S):
    shards = split_csr_shards(corpus, S) if S > 1 else [corpus]
    for s in shards:
        s["term_ids"] = corpus["term_ids"]
    return shards


def _pair(corpus, S, dense_threshold=1 << 30):
    """(JAX plane, port plane) over the same shards; the JAX plane serves
    through its jitted steps."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PLANE_HOST_SERVE", "0")
    shards = _shards(corpus, S)
    jp = JaxPlane(make_search_mesh(n_shards=S), shards, "body",
                  blockmax={}, dense_threshold=dense_threshold)
    tp = DistributedSearchPlane(shards, "body", device="cpu", blockmax={},
                                dense_threshold=dense_threshold)
    mp.undo()
    jp._host_csr = None
    return jp, tp


@pytest.fixture(scope="module")
def corpus():
    return _corpus()


@pytest.fixture(scope="module", params=[1, 4], ids=["S1", "S4"])
def planes(request, corpus):
    return _pair(corpus, request.param)


def _mix(corpus, seed, n, *, weighted):
    """Mix (a): terms drawn ∝ df over df ≥ 2 (the benchmark's traffic);
    mix (b): terms uniform over df ≥ 2 (tail terms)."""
    return query_mix(corpus, seed, n, weighted=weighted)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _same(want, got):
    """Values bitwise, hits and totals equal."""
    assert np.array_equal(_bits(want[0]), _bits(got[0]))
    assert want[1] == got[1]
    if len(want) > 2:
        assert want[2] == got[2]


# ---------------------------------------------------------------------------
# the tier
# ---------------------------------------------------------------------------


def test_tier_pack_is_identical(planes):
    jp, tp = planes
    jt, tt = jp.blockmax, tp.blockmax
    assert (jt.block, jt.n_pad, jt.n_blocks) == (tt.block, tt.n_pad,
                                                 tt.n_blocks)
    assert len(jt.shards) == len(tt.shards)
    for js, ts in zip(jt.shards, tt.shards):
        assert set(js) == set(ts)
        for key, a in js.items():
            b = ts[key]
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(
                    a.view(np.uint8), b.view(np.uint8)), key
            else:
                assert a == b, key
    assert jt.impact_bytes_f32() == tt.impact_bytes_f32()
    assert jt.impact_bytes_int8() == tt.impact_bytes_int8()
    assert jt.nbytes() == tt.nbytes()
    jd = jt.device_arrays(jp.mesh)
    td = tt.device_arrays(tp.device)
    for key in ("docs", "codes", "scale", "off"):
        assert np.array_equal(np.asarray(jd[key]).view(np.uint8),
                              td[key].numpy().view(np.uint8)), key
    assert td["docs"].dtype == torch.int32
    assert td["codes"].dtype == torch.int8
    assert tt.device_arrays(tp.device) is td          # made once


def test_schedules_are_identical(planes, corpus):
    jp, tp = planes
    qs = _mix(corpus, 1, 6, weighted=True) + _mix(corpus, 2, 4,
                                                  weighted=False)
    qs += [["t0", "t0", "t7"], ["missing-term", "t3"]]
    for terms in qs:
        jw = jp._query_idfw(terms, 0, None)
        tw = tp._query_idfw(terms, 0, None)
        assert list(jw.items()) == list(tw.items())
        for si, sh in enumerate(tp.shards):
            rows = [(int(sh["term_ids"][t]), w) for t, w in tw.items()
                    if t in sh["term_ids"]]
            blk, w, rho, _tpos, slack = jp.blockmax.schedule(si, rows)
            b = tp.blockmax.schedule(si, rows)
            for x, y in zip((blk, w, rho), b[:3]):
                assert x.dtype == y.dtype and np.array_equal(x, y)
            assert slack == b[3]
            assert (np.diff(b[2]) <= 0).all()           # rho never rises


# ---------------------------------------------------------------------------
# packed state, both ways
# ---------------------------------------------------------------------------


def test_from_packed_of_reference_serves_identically(planes, corpus):
    jp, tp = planes
    packed = jp.export_packed()
    assert packed["host_csr"] is None and packed["blockmax"] is not None
    tp2 = DistributedSearchPlane.from_packed(packed, device="cpu")
    assert torch.equal(tp2.docs_dev, tp.docs_dev)
    assert torch.equal(tp2.impacts_dev.view(torch.int32),
                       tp.impacts_dev.view(torch.int32))
    assert tp2.blockmax.n_blocks == tp.blockmax.n_blocks
    qs = _mix(corpus, 3, 6, weighted=True) + _mix(corpus, 4, 2,
                                                  weighted=False)
    _same(tp.serve(qs, k=10, with_totals=True),
          tp2.serve(qs, k=10, with_totals=True))


def test_export_packed_loads_into_reference(planes, corpus):
    jp, tp = planes
    packed = tp.export_packed()
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PLANE_HOST_SERVE", "0")
    jp2 = JaxPlane.from_packed(jp.mesh, packed)
    mp.undo()
    assert jp2._host_csr is None
    qs = _mix(corpus, 5, 6, weighted=True)
    _same(tp.serve(qs, k=10, with_totals=True),
          jp2.serve(qs, k=10, with_totals=True))


def test_dense_rows_round_trip_through_export(corpus):
    """A plane with a dense tier ships its bf16 rows as exact f32 and
    loads them back bit for bit, in the port and in the reference."""
    jp, tp = _pair(corpus, 1, dense_threshold=64)
    assert tp.T_pad > 0
    tp2 = DistributedSearchPlane.from_packed(jp.export_packed(),
                                             device="cpu")
    assert torch.equal(tp2.dense_dev.view(torch.int16),
                       tp.dense_dev.view(torch.int16))
    assert tp2.dense_block == tp.dense_block
    packed = tp.export_packed()
    assert packed["dense"].dtype == np.float32
    assert np.array_equal(
        np.asarray(packed["dense"].astype(jnp.bfloat16)).view(np.int16),
        np.asarray(jp.dense_dev).view(np.int16))


# ---------------------------------------------------------------------------
# the step: plain K4 + K5 + K3 against build_pruned_bm25_step
# ---------------------------------------------------------------------------


def _run_both(jp, tp, prep, *, edit=None):
    """Run the JAX step and the port's step on one prepared batch (``edit``
    may rewrite the schedule arrays first); return both outputs."""
    a = dict(prep["args"])
    np_in = {n: a[n].numpy().copy() for n in
             ("sched", "w", "rho", "slack", "starts", "lengths", "idfw")}
    if edit is not None:
        edit(np_in, tp.blockmax.n_blocks)
    a.update({n: torch.from_numpy(v) for n, v in np_in.items()})
    got = pruned_bm25_step(**a, n_pad=tp.n_pad, NB=tp.blockmax.n_blocks,
                           Q=prep["Q"], k=prep["k"], W=prep["W"],
                           R=prep["R"])
    step = jp._get_pruned_step(prep["Q"], prep["k"], prep["P_sched"],
                               prep["W"], prep["R"])
    dev = jp.blockmax.device_arrays(jp.mesh)
    want = step(jp.docs_dev, jp.impacts_dev, dev["docs"], dev["codes"],
                dev["scale"], dev["off"], np_in["sched"], np_in["w"],
                np_in["rho"], np_in["slack"], np_in["starts"],
                np_in["lengths"], np_in["idfw"])
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


def _assert_step_equal(want, got):
    assert np.array_equal(_bits(want[0]), _bits(got[0]))      # values
    # docs of the filled slots (an empty slot's id is a filler that
    # follows the reference's mesh layout)
    fin = np.isfinite(want[0])
    assert np.array_equal(want[1][fin], got[1][fin])
    for x, y, name in zip(want[2:], got[2:],
                          ("matched", "unsafe", "pruned", "n_sc")):
        assert np.array_equal(x, y.astype(x.dtype)), name


def _stop_after_first_block(a, NB):
    # query 0: every step after its first block fails the threshold
    a["rho"][0, :, 1:] = np.where(a["sched"][0, :, 1:] != NB, 0.0,
                                  a["rho"][0, :, 1:])


def _pads_first(a, NB):
    # query 1: its schedule starts with pad steps
    a["sched"][1, :, 3:] = a["sched"][1, :, :-3].copy()
    a["rho"][1, :, 3:] = a["rho"][1, :, :-3].copy()
    a["w"][1, :, 3:] = a["w"][1, :, :-3].copy()
    a["sched"][1, :, :3] = NB


def _rho_rises(a, NB):
    # query 2: a failing step, then steps whose bound mass rises again
    a["rho"][2, :, 2] = 0.0
    a["rho"][2, :, 3:5] = 1e9


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("weighted", [True, False], ids=["mixA", "mixB"])
def test_step_matches_reference(planes, corpus, k, weighted):
    jp, tp = planes
    qs = _mix(corpus, 10 + k, 6, weighted=weighted) + [[], ["t3"]]
    prep = tp.prepare_pruned(qs, k)
    assert prep["step"] == "pruned"
    want, got = _run_both(jp, tp, prep)
    _assert_step_equal(want, got)


def test_step_matches_reference_on_edited_schedules(planes, corpus):
    jp, tp = planes
    qs = _mix(corpus, 20, 4, weighted=True)
    # k = 1: θ reads window slot 7, set by a query's first block
    prep = tp.prepare_pruned(qs, 1)
    want, got = _run_both(jp, tp, prep, edit=_stop_after_first_block)
    _assert_step_equal(want, got)
    assert got[4][0] > 0                       # query 0 was pruned


@pytest.mark.parametrize("edit", [_pads_first, _rho_rises],
                         ids=["pads-first", "rho-rises"])
def test_scan_refuses_schedules_the_tier_cannot_make(planes, corpus, edit):
    """The scan stops at its first step that is not live, which is exact
    only on a schedule whose real steps come first with ρ non-increasing
    (what :meth:`BlockMaxTier.schedule` builds); the plain version refuses
    any other."""
    _, tp = planes
    qs = _mix(corpus, 20, 4, weighted=True)
    prep = tp.prepare_pruned(qs, 1)
    assert (prep["sched_lens"][1:3] >= 6).all()     # the queries edited
    a = dict(prep["args"])
    np_in = {n: a[n].numpy().copy() for n in ("sched", "w", "rho")}
    edit(np_in, tp.blockmax.n_blocks)
    a.update({n: torch.from_numpy(v) for n, v in np_in.items()})
    with pytest.raises(ValueError, match="non-increasing"):
        pruned_bm25_step(**a, n_pad=tp.n_pad, NB=tp.blockmax.n_blocks,
                         Q=prep["Q"], k=1, W=prep["W"], R=prep["R"])


def test_step_small_window_forces_unsafe(planes, corpus, monkeypatch):
    """``prune_rerank = 1``: R floors at 64, the window overflows, and the
    verdict marks queries unsafe alike."""
    jp, tp = planes
    monkeypatch.setattr(tp, "prune_rerank", 1)
    top = int(np.argmax(corpus["df"]))
    qs = [[f"t{top}", f"t{(top + 1) % VOCAB}"]] * 2 + \
        _mix(corpus, 21, 2, weighted=True)
    prep = tp.prepare_pruned(qs, 10)
    assert prep["R"] == 64
    want, got = _run_both(jp, tp, prep)
    _assert_step_equal(want, got)
    assert got[3].sum() > 0


def test_step_inert_past_the_theta_window(planes, corpus):
    """k·Q > 1024: θ stays −inf, nothing is pruned, and overflowing
    queries are unsafe."""
    jp, tp = planes
    qs = _mix(corpus, 22, 4, weighted=True)
    prep = tp.prepare_pruned(qs, 200)
    assert 200 * prep["Q"] > LEX_THETA_WINDOW and prep["W"] == 1024
    want, got = _run_both(jp, tp, prep)
    _assert_step_equal(want, got)
    assert got[4].sum() == 0


def test_scan_outputs_are_consistent(planes, corpus):
    """K4's own outputs: survivors doc-ascending with ``n_pad`` (and −inf
    partials) after them, one per doc, at most ``matched`` of them; and
    the scan counts what its plain version counts."""
    _, tp = planes
    qs = _mix(corpus, 23, 4, weighted=True) + [[]]
    prep = tp.prepare_pruned(qs, 10)
    a = prep["args"]
    kq = 10 * prep["Q"]
    kw = dict(n_pad=tp.n_pad, NB=tp.blockmax.n_blocks, W=prep["W"],
              R=prep["R"], kq_idx=min(kq, prep["W"]) - 1,
              prune_active=kq <= prep["W"])
    ins = [a[n] for n in ("t_docs", "t_codes", "t_scale", "t_off", "sched",
                          "w", "rho", "slack")]
    ci, cv, matched, unsafe, pruned, n_sc = blockmax_scan(*ins, **kw)
    for x, y in zip((ci, cv, matched, unsafe, pruned, n_sc),
                    blockmax_scan_plain(*ins, **kw)):
        assert torch.equal(x, y)
    ci, cv = ci.numpy(), cv.numpy()
    for b in range(ci.shape[0]):
        for s in range(ci.shape[1]):
            real = ci[b, s] < tp.n_pad
            n = int(real.sum())
            assert real[:n].all() and not real[n:].any()
            assert (np.diff(ci[b, s, :n]) > 0).all()
            assert (cv[b, s, :n] > 0).all()
            assert np.isneginf(cv[b, s, n:]).all()
            assert n == min(int(matched[b, s]), prep["R"])
    assert n_sc[-1].sum() == 0 and matched[-1].sum() == 0


def test_dequantization_is_xla_fused_multiply_add():
    """The reference's ``scale·q + off`` compiles to one FMA on XLA:CPU;
    ``fma_f32`` rounds once the same way (and differs from two roundings
    on these inputs, so the test can tell them apart)."""
    rng = np.random.RandomState(0)
    n = 200000
    s = (rng.rand(n) * 0.01).astype(np.float32)
    q = rng.randint(-127, 128, n).astype(np.int8)
    o = rng.rand(n).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda s, q, o: s * q.astype(jnp.float32) + o)(s, q, o))
    got = fma_f32(torch.from_numpy(s), torch.from_numpy(q).float(),
                  torch.from_numpy(o)).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))
    two = s * q.astype(np.float32) + o
    assert not np.array_equal(two.view(np.int32), got.view(np.int32))


# ---------------------------------------------------------------------------
# K5 against the reference's bisect_exact_scores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 4])
def test_bisect_exact_scores_matches_reference(corpus, S):
    _, tp = _pair(corpus, S)
    qs = _mix(corpus, 30, 5, weighted=True) + [["t3", "t3", "t9"], []]
    Q = 8
    starts, lengths, idfw = tp._lookup(qs, Q)[:3]
    B, R = len(qs), 96
    rng = np.random.RandomState(31)
    docs_np = tp.docs_dev.numpy()
    cand = rng.randint(0, tp.n_pad, size=(B, S, R)).astype(np.int32)
    for b in range(B):
        for s in range(S):
            run = np.concatenate([
                docs_np[s, starts[b, s, q]: starts[b, s, q]
                        + lengths[b, s, q]] for q in range(Q)])
            if run.size:
                cand[b, s, :R // 2] = rng.choice(run, R // 2)
    cand[:, :, -5:] = tp.n_pad                 # empty slots
    cand[:, :, 0] = tp.n_pad - 1               # a doc past every run
    cand = np.sort(cand, axis=-1)
    fn = jax.jit(jax.vmap(jax.vmap(
        lambda pd, pi, st, ln, iw, cd: jax_bisect(
            pd, pi, st, ln, iw, cd, n_pad=tp.n_pad),
        in_axes=(0, 0, 0, 0, None, 0)),
        in_axes=(None, None, 0, 0, 0, 0)))
    want = fn(tp.docs_dev.numpy(), tp.impacts_dev.numpy(), starts, lengths,
              idfw, cand)
    args = [torch.from_numpy(x) for x in (starts, lengths, idfw, cand)]
    got = bisect_exact_scores(tp.docs_dev, tp.impacts_dev, *args,
                              n_pad=tp.n_pad)
    assert np.array_equal(np.asarray(want[0]).view(np.int32),
                          got[0].numpy().view(np.int32))
    assert np.array_equal(np.asarray(want[1]), got[1].numpy())
    assert not got[1].numpy()[:, :, -5:].any()
    plain = bisect_exact_scores_plain(tp.docs_dev, tp.impacts_dev, *args,
                                      n_pad=tp.n_pad)
    assert all(torch.equal(x, y) for x, y in zip(got, plain))


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [True, False], ids=["mixA", "mixB"])
def test_search_pruned_and_serve_match_reference(planes, corpus, weighted):
    jp, tp = planes
    qs = _mix(corpus, 40, 8, weighted=weighted) + [["t3"], [],
                                                    ["missing-term"]]
    st = {}
    got = tp.search_pruned(qs, k=10, with_totals=True, stages=st)
    _same(jp.search_pruned(qs, k=10, with_totals=True), got)
    _same(jp.serve(qs, k=10, with_totals=True),
          tp.serve(qs, k=10, with_totals=True))
    for key in ("prep_ms", "dispatch_ms", "fetch_ms", "docs_scanned",
                "lex_blocks_scored", "lex_blocks_total", "unsafe"):
        assert key in st
    assert 0 < st["lex_blocks_scored"] <= st["lex_blocks_total"]


def test_search_pruned_with_extra_corpus_mass(planes, corpus):
    jp, tp = planes
    qs = _mix(corpus, 41, 6, weighted=True)
    extra = dict(extra_docs=900, extra_df={qs[0][0]: 30, qs[2][1]: 5})
    _same(jp.search_pruned(qs, k=7, with_totals=True, **extra),
          tp.search_pruned(qs, k=7, with_totals=True, **extra))


def test_pruned_equals_port_eager(planes, corpus):
    """The port's pruned route against the port's own eager step: values
    bitwise, hits equal, totals exact or ``gte`` lower bounds."""
    _, tp = planes
    qs = _mix(corpus, 42, 10, weighted=True) + _mix(corpus, 43, 6,
                                                    weighted=False)
    ev, eh, et = tp.search(qs, k=10, with_totals=True)
    pv, ph, pt = tp.search_pruned(qs, k=10, with_totals=True)
    assert np.array_equal(_bits(ev), _bits(pv))
    assert eh == ph
    for e, p in zip(et, pt):
        assert total_value(p) == e or (total_is_lower_bound(p)
                                       and total_value(p) <= e)


def test_unsafe_queries_fall_back_to_eager(corpus, monkeypatch):
    jp, tp = _pair(corpus, 1)
    monkeypatch.setattr(tp, "prune_rerank", 1)
    monkeypatch.setattr(jp, "prune_rerank", 1)
    top = int(np.argmax(corpus["df"]))
    qs = [[f"t{top}", f"t{(top + 1) % VOCAB}"] for _ in range(3)]
    calls = []
    real = tp.search
    monkeypatch.setattr(tp, "search",
                        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    st = {}
    got = tp.search_pruned(qs, k=10, with_totals=True, stages=st)
    assert calls and st["unsafe"] == 3
    _same(jp.search_pruned(qs, k=10, with_totals=True), got)
    _same(real(qs, k=10, with_totals=True), got)


def test_dense_tier_batch_falls_back_to_tiered(corpus, monkeypatch):
    jp, tp = _pair(corpus, 1, dense_threshold=64)
    assert tp.T_pad > 0
    top = int(np.argmax(corpus["df"]))
    qs = [[f"t{top}", "t3"], ["t5"]]
    monkeypatch.setattr(tp, "run_pruned", None)      # must not be reached
    got = tp.search_pruned(qs, k=10, with_totals=True)
    _same(tp.search(qs, k=10, tiered=True, with_totals=True), got)
    _same(jp.search_pruned(qs, k=10, with_totals=True), got)


def test_serve_routes(corpus, monkeypatch):
    """The tier's default takes the pruned route; ``prune=False``, a
    window past ``LEX_THETA_WINDOW`` and a plane without a tier take the
    eager step at the serving shapes."""
    jp, tp = _pair(corpus, 1)
    qs = _mix(corpus, 44, 4, weighted=True)
    seen = []
    real = tp.search_pruned
    monkeypatch.setattr(tp, "search_pruned",
                        lambda *a, **kw: seen.append("pruned")
                        or real(*a, **kw))
    want = jp.serve(qs, k=10, with_totals=True)
    _same(want, tp.serve(qs, k=10, with_totals=True))
    assert seen == ["pruned"]
    _same(jp.serve(qs, k=10, with_totals=True, prune=False),
          tp.serve(qs, k=10, with_totals=True, prune=False))
    _same(jp.serve(qs, k=200, with_totals=True),
          tp.serve(qs, k=200, with_totals=True))
    assert seen == ["pruned"]
    plain = DistributedSearchPlane(_shards(corpus, 1), "body", device="cpu",
                                   dense_threshold=1 << 30)
    assert plain.blockmax is None
    _same(tp.search(qs, k=10, **tp.serving_shape(qs), with_totals=True),
          plain.serve(qs, k=10, with_totals=True))
