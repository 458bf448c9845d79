"""The port's serving micro-batcher, delta tier and serving telemetry, on
the CPU.

Many client threads through ``batched_search`` get what the plane gives
each query alone, in fewer dispatches than requests; kernel launch counts
stay exact under threads; the delta tier's host scorer and merge match the
reference's; the roofline peaks are the H100's; ``instrument_step`` times a
torch step; and the parts that wait for ROADMAP A2b are refused by name.
"""

import threading
import time

import numpy as np
import pytest
import torch

from elasticsearch_tpu.parallel import dist_search as ref_ds
from elasticsearch_tpu_torch.common import roofline, telemetry
from elasticsearch_tpu_torch.common.errors import IllegalArgumentError
from elasticsearch_tpu_torch.kernels import build as kb
from elasticsearch_tpu_torch.parallel import dist_search as ds
from elasticsearch_tpu_torch.parallel.dist_search import \
    DistributedSearchPlane
from elasticsearch_tpu_torch.search import microbatch as mb
from elasticsearch_tpu_torch.search import plane_route as pr
from elasticsearch_tpu_torch.search.shard_search import ShardSearcher
from elasticsearch_tpu_torch.utils.synth import (split_csr_shards,
                                                 synthetic_csr_corpus_fast)
from torch_cases import query_mix

N_CLIENTS = 16
PER_CLIENT = 6
VOCAB = 256


@pytest.fixture(scope="module")
def corpus():
    c = synthetic_csr_corpus_fast(np.random.RandomState(11), 4096, VOCAB,
                                  16, zipf_s=1.2)
    c["term_ids"] = {f"t{t}": t for t in range(VOCAB)}
    return c


def _shards(corpus, S=2):
    shards = split_csr_shards(corpus, S)
    for s in shards:
        s["term_ids"] = corpus["term_ids"]
    return shards


@pytest.fixture
def quick_exit(monkeypatch):
    """Dispatcher threads exit as soon as their queue empties; none is
    left after the test."""
    monkeypatch.setattr(mb.PlaneMicroBatcher, "IDLE_EXIT_S", 0.05)
    yield
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(
            t.name.startswith("es-dispatcher")
            for t in threading.enumerate()):
        time.sleep(0.02)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("es-dispatcher")]


def _bits(v):
    return np.asarray(v, np.float32).view(np.int32)


@pytest.mark.parametrize("prune", [None, False], ids=["pruned", "eager"])
def test_many_clients_get_the_serial_results(corpus, quick_exit,
                                             monkeypatch, prune):
    """16 client threads through ``batched_search``: every response equals
    the plane's answer to that query alone (values bitwise, hits; totals
    exact on the eager route, exact or a lower bound on the pruned one),
    the requests coalesce (some dispatch carries more than one), and the
    plane counts exactly one dispatch per batch on the eager route."""
    plane = DistributedSearchPlane(_shards(corpus), "body", device="cpu",
                                   blockmax={}, dense_threshold=1 << 30)
    queries = query_mix(corpus, 5, N_CLIENTS * PER_CLIENT, weighted=True)
    want = [plane.serve([q], k=10, with_totals=True, prune=prune)
            for q in queries]
    exact = [plane.serve([q], k=10, with_totals=True, prune=False)[2][0]
             for q in queries]
    n0 = plane.n_dispatches
    # the first dispatch waits a moment, so the other clients queue
    gate = threading.Event()
    orig = mb.PlaneMicroBatcher._dispatch

    def slow_first(self, *a, **kw):
        if not gate.is_set():
            gate.set()
            time.sleep(0.2)
        return orig(self, *a, **kw)

    monkeypatch.setattr(mb.PlaneMicroBatcher, "_dispatch", slow_first)
    got = [None] * len(queries)
    errors = []
    start = threading.Barrier(N_CLIENTS)

    def client(c):
        try:
            start.wait()
            for j in range(PER_CLIENT):
                i = c * PER_CLIENT + j
                got[i] = mb.batched_search(plane, queries[i], 10,
                                           prune=prune)
        except BaseException as e:   # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(N_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    for (wv, wh, wt), (gv, gh, gt), ex in zip(want, got, exact):
        assert np.array_equal(_bits(wv[0]), _bits(gv))
        assert wh[0] == gh
        if prune is False:
            assert wt[0] == gt
        else:
            # a pruned total depends on the batch (its θ window is sized
            # by the batch's widest query): a lower bound, or exact
            assert ds.total_value(gt) <= ex
            assert ds.total_is_lower_bound(gt) or gt == ex
    b = plane._microbatcher
    st = b.stats_doc()
    assert st["queries"] == len(queries)
    assert 1 < b.max_seen_batch <= mb.MAX_BATCH
    assert st["dispatches"] < len(queries)
    if prune is False:
        assert plane.n_dispatches - n0 == st["dispatches"]
    else:
        assert plane.n_dispatches - n0 >= st["dispatches"]
    pct = b.stage_percentiles()
    assert set(pct) == set(mb.STAGES)
    assert all(v["n"] == len(queries) for v in pct.values())


def test_launch_counts_stay_exact_under_threads(monkeypatch):
    """``kernels.build.launch`` counts each launch once, whichever thread
    makes it (a stand-in library answers every call)."""

    class FakeLib:
        def __getattr__(self, name):
            return lambda *a: 0

    monkeypatch.setattr(kb, "library", lambda name: FakeLib())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda i: 0, raising=False)
    monkeypatch.setitem(kb.launches, "topk_merge", 0)
    n_threads, per = 16, 2000
    start = threading.Barrier(n_threads)

    def worker():
        start.wait()
        for _ in range(per):
            kb.launch("topk_merge", torch.device("cuda", 0))

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert kb.launches["topk_merge"] == n_threads * per


def test_scan_workspace_is_shared_on_one_stream_and_cpu_has_none():
    tier = ds.BlockMaxTier()
    tier.n_pad = 64
    assert tier.scan_workspace(4, "cpu") is None
    tier.drop_workspace()
    assert tier._acc is None


# ---------------------------------------------------------------------------
# the delta tier's host half
# ---------------------------------------------------------------------------


def _delta_shards(seed, sizes, vocab=64):
    out = []
    for i, n in enumerate(sizes):
        c = synthetic_csr_corpus_fast(np.random.RandomState(seed + i), n,
                                      vocab, 12, zipf_s=1.1)
        c["term_ids"] = {f"t{t}": t for t in range(vocab)}
        out.append(c)
    # a field-less segment: no postings, its docs still count
    out.append(dict(term_ids={}, df=np.zeros(0, np.int32),
                    offsets=np.zeros(1, np.int64),
                    docs=np.zeros(0, np.int32), tf=np.zeros(0, np.float32),
                    doc_len=np.zeros(9, np.float32)))
    return out


def test_eager_delta_scorer_matches_the_reference():
    shards = _delta_shards(3, (300, 1, 150))
    positions = [4, 6, 7, 9]
    want = ref_ds.EagerDeltaScorer(shards, positions, avgdl=11.5)
    got = ds.EagerDeltaScorer(shards, positions, avgdl=11.5)
    assert got.n_docs == want.n_docs == 460
    rng = np.random.RandomState(1)
    queries = [[f"t{t}" for t in rng.randint(0, 80, size=rng.randint(1, 6))]
               for _ in range(12)] + [[], ["t0", "t0", "t3"]]
    for q in queries:
        for t in q:
            assert got.df(t) == want.df(t)

    def idf_of(t):
        d = want.df(t)
        return float(np.log1p((1000 - d + 0.5) / (d + 0.5))) if d else 0.0

    for k in (1, 10, 500):
        wr, wt = want.score(queries, k, idf_of, with_totals=True)
        gr, gt = got.score(queries, k, idf_of, with_totals=True)
        assert gt == wt
        for a, b in zip(wr, gr):
            assert [(np.float32(v).view(np.int32), s, d) for v, s, d in a] \
                == [(np.float32(v).view(np.int32), s, d) for v, s, d in b]


def test_tie_stable_topk_and_merge_match_the_reference():
    rng = np.random.RandomState(2)
    for n, kk in ((50, 10), (200, 7), (5, 10), (64, 64)):
        scores = rng.choice(np.array([0.0, 0.5, 1.0, 1.5], np.float32),
                            size=n)
        assert np.array_equal(ds.tie_stable_topk_docs(scores, kk),
                              ref_ds.tie_stable_topk_docs(scores, kk))
    for _ in range(20):
        rows = [(float(rng.choice([1.0, 2.0, 3.0])), int(rng.randint(0, 4)),
                 int(rng.randint(0, 50))) for _ in range(rng.randint(0, 12))]
        cut = rng.randint(0, len(rows) + 1)
        base, delta = sorted(rows[:cut], key=lambda r: (-r[0], r[1], r[2])), \
            sorted(rows[cut:], key=lambda r: (-r[0], r[1], r[2]))
        for k in (1, 5, 20):
            assert ds.merge_topk_rows(base, delta, k) == \
                ref_ds.merge_topk_rows(base, delta, k)


# ---------------------------------------------------------------------------
# serving telemetry
# ---------------------------------------------------------------------------


def test_roofline_peaks_are_the_h100s_for_cuda(monkeypatch):
    assert roofline.platform("cuda") == "cuda"
    assert roofline.platform("cpu") == "cpu"
    assert roofline._PLATFORM_BW["cuda"] == 3350.0       # 3.35 TB/s HBM3
    assert roofline.peak_flops_gflops("cuda") == 67000.0  # 67 TFLOP/s f32
    assert "H100" in roofline.PLATFORM_CARD["cuda"]
    assert "700.00 W" in roofline.PLATFORM_CARD["cuda"]
    assert "tpu" not in roofline._PLATFORM_BW
    roofline._reset_peak_for_tests()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert roofline.peak_bandwidth_gbps() == 3350.0
    roofline._reset_peak_for_tests()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert roofline.peak_bandwidth_gbps() == 10.0
    roofline._reset_peak_for_tests()


def test_instrument_step_times_a_torch_step(monkeypatch):
    reg = telemetry.TelemetryRegistry()
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: synced.append(d))
    calls = []

    def step(x, y):
        calls.append(1)
        return (x @ y, [x.sum()])

    fn = telemetry.instrument_step(step, "test_step", registry=reg)
    a, b = torch.ones(4, 8), torch.ones(8, 2)
    out = fn(a, b)
    assert torch.equal(out[0], torch.full((4, 2), 8.0))
    assert telemetry.last_call_compiled()
    fn(a, b)
    assert not telemetry.last_call_compiled()
    fn(torch.ones(2, 8), b)
    assert telemetry.compile_count(reg) == 2
    assert len(calls) == 3 and synced == []   # host tensors: no sync
    assert fn.__wrapped__ is step


def test_device_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    telemetry._PEAK_BYTES["t"] = float("-inf")
    doc = telemetry.device_stats_doc()
    assert doc["devices"] == [] and "error" not in doc
    assert doc["live_array_bytes"] == 0


def test_warmup_builds_the_routes_kernels_off_the_serving_path(
        corpus, monkeypatch):
    built = []
    monkeypatch.setattr(kb, "library", lambda name: built.append(name))
    cpu_plane = DistributedSearchPlane(_shards(corpus), "body",
                                       device="cpu", blockmax={})
    b = mb.PlaneMicroBatcher(cpu_plane)
    assert b.warmup(sync=True) is None and built == []

    class CudaPlane:                       # the attributes warmup reads
        device = torch.device("cuda")
        blockmax = object()

    b = mb.PlaneMicroBatcher(CudaPlane())
    b.warmup(sync=True)
    assert built == list(mb.PlaneMicroBatcher.EAGER_KERNELS) + \
        list(mb.PlaneMicroBatcher.PRUNED_KERNELS)
    assert b.stats_doc()["warmed_shapes"] == 5
    assert set(built) <= set(kb.KERNELS)


# ---------------------------------------------------------------------------
# what waits for ROADMAP A2b, and the device rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("call", [
    lambda c: c.knn_plane_for([], None, "vec"),
    lambda c: c.fused_runner_for([], None, "body", "vec"),
    lambda c: c.export_bundles(),
    lambda c: c.export_bundle_blobs(),
    lambda c: c.import_bundle({}, [], None),
    lambda c: c.tiers,
    lambda c: pr.ServingPlaneCache(mesh_factory=lambda: None,
                                   device="cpu"),
], ids=["knn_plane_for", "fused_runner_for", "export_bundles",
        "export_bundle_blobs", "import_bundle", "tiers", "mesh_factory"])
def test_parts_that_wait_are_refused_by_name(call):
    cache = pr.ServingPlaneCache(device="cpu")
    with pytest.raises(IllegalArgumentError, match=r"ROADMAP A2b; "
                                                   r"reference search/"):
        call(cache)
    cache.release()


@pytest.mark.parametrize("env,value,off,what", [
    ("ES_TPU_PLANE_HBM_BUDGET_BYTES", "1000000", "0", "PlaneTierManager"),
    ("ES_TPU_PLANE_HOST_BUDGET_BYTES", "1000000", "0", "PlaneTierManager"),
    ("ES_TPU_PLANE_DELTA", "0", "1", "a rebuild on every refresh")],
    ids=["ES_TPU_PLANE_HBM_BUDGET_BYTES", "ES_TPU_PLANE_HOST_BUDGET_BYTES",
         "ES_TPU_PLANE_DELTA"])
def test_a_tier_budget_is_refused(monkeypatch, env, value, off, what):
    monkeypatch.setenv(env, value)
    with pytest.raises(IllegalArgumentError, match=f"{what}.*ROADMAP A2b"):
        pr.ServingPlaneCache(device="cpu")
    monkeypatch.setenv(env, off)
    pr.ServingPlaneCache(device="cpu").release()


def test_cache_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pr.ServingPlaneCache()
    cache = pr.ServingPlaneCache(device="cpu")
    assert cache.device.type == "cpu"
    cache.release()


@pytest.mark.parametrize("kw", ["knn_plane_provider", "fused_provider"])
def test_searcher_refuses_the_knn_and_fused_providers(kw):
    with pytest.raises(IllegalArgumentError, match="ROADMAP A2b"):
        ShardSearcher([], None, device="cpu", **{kw: lambda *a: None})
