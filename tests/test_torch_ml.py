"""The port's ML path (``elasticsearch_tpu_torch/xpack/ml.py``, its ingest
pipeline and expression copies) against the JAX package, on the CPU.

Bars:
- K20 (the tree walk) and ``TrainedModel.infer``: exact (leaf ids bit for
  bit, inference results equal).
- K21 (kNN outlier distances): scores within ``KNN_ATOL`` = 1e-5 of the
  reference's. Its squared distances ``(|x_i|^2 + |x_j|^2) - 2 x_i.x_j``
  sum in another order than XLA's matrix product, so they differ by a
  few ulps of ``|x_i|^2 + |x_j|^2``; the score's slope is at most
  ``1 / (2 std(dk))``, so the test frames keep the spread of the
  distances far above rounding (two clusters and far rows): a near-
  constant spread would amplify ulps through ``1 / std``.
- K22 (logistic regression): weights within ``W_TOL`` = 1e-5 of the
  largest weight (at least 1), and the same argmax on every row whose
  top-two logits differ by more than ``MARGIN`` = 1e-3.
"""

import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu.ingest import pipeline as r_pipe
from elasticsearch_tpu.node.indices_service import IndicesService
from elasticsearch_tpu.rest.api import RestAPI
from elasticsearch_tpu.utils import expressions as r_expr
from elasticsearch_tpu.xpack import ml as R
from elasticsearch_tpu_torch.common.errors import ParsingError
from elasticsearch_tpu_torch.ingest import pipeline as t_pipe
from elasticsearch_tpu_torch.utils import expressions as t_expr
from elasticsearch_tpu_torch.xpack import ml as P
from torch_cases import (full_tree_arrays, logreg_case, outlier_frame,
                         tree_arrays_case)

KNN_ATOL = 1e-5
W_TOL = 1e-5
MARGIN = 1e-3
TREE_KEYS = ("X", "feats", "thresh", "left", "right", "dleft")


def _close(a, b, tol, path="$"):
    """Equal JSON-like values, floats within ``tol``."""
    if isinstance(a, float) or isinstance(b, float):
        assert abs(float(a) - float(b)) <= tol, (path, a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), (path, a.keys(), b.keys())
        for k in a:
            _close(a[k], b[k], tol, f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, tol, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


# -- K20: the tree walk ------------------------------------------------------

@pytest.mark.parametrize("seed,T,N,n,F,depth", [
    (1, 9, 7, 60, 4, 6), (2, 4, 1, 9, 1, 3), (3, 6, 15, 40, 3, 0),
    (4, 12, 31, 80, 6, 9)])
def test_k20_plain_equals_the_reference_on_every_index_rule(seed, T, N, n,
                                                            F, depth):
    """Children past N and below -N, a leaf at the root, a feature past F,
    NaN features with dleft 0 and 1: leaf ids bit for bit."""
    import jax.numpy as jnp
    c = tree_arrays_case(seed, T=T, N=N, n=n, F=F)
    ref = R._eval_trees(*(jnp.asarray(c[k]) for k in TREE_KEYS), depth)
    got = P._eval_trees(*(torch.from_numpy(c[k]) for k in TREE_KEYS),
                        depth)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    if T >= 4 and depth:
        assert (got.numpy()[0] == 0).all()             # a leaf at the root


def test_k20_plain_full_trees_equal_the_reference():
    import jax.numpy as jnp
    c = full_tree_arrays(5, T=20, depth=5, F=8, n=200)
    ref = R._eval_trees(*(jnp.asarray(c[k]) for k in TREE_KEYS), 6)
    got = P._eval_trees(*(torch.from_numpy(c[k]) for k in TREE_KEYS), 6)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    assert (got.numpy() >= 31).all()                   # every walk a leaf


def test_k20_raw_index_rules_by_hand():
    """The rules the kernel copies, on a three-node tree: a read at 7
    clamps to node 2 (a leaf, so the walk stays at 7), at -5 wraps to -2
    and clamps to node 0 (which sends x = 2 and NaN right, to -5 again);
    the returned index stays raw. The reference agrees."""
    import jax.numpy as jnp
    X = torch.tensor([[0.0], [2.0], [float("nan")]])
    feats = torch.tensor([[0, 0, -1]], dtype=torch.int32)
    thresh = torch.tensor([[1.0, 5.0, 0.0]])
    left = torch.tensor([[7, 0, 0]], dtype=torch.int32)
    right = torch.tensor([[-5, 0, 0]], dtype=torch.int32)
    dleft = torch.tensor([[0, 1, 0]], dtype=torch.int32)
    args = (X, feats, thresh, left, right, dleft)
    for depth in (1, 2, 3):
        got = P._eval_trees(*args, depth)
        assert got.tolist() == [[7, -5, -5]]
        ref = R._eval_trees(*(jnp.asarray(a.numpy()) for a in args), depth)
        assert np.asarray(ref).tolist() == got.tolist()
    assert P._eval_trees(*args, 0).tolist() == [[0, 0, 0]]


# -- TrainedModel.infer ------------------------------------------------------

def _tree(rng, n_feat, depth, leaf_width=None, default_right=0.3):
    nodes, todo = [], [(0, 0)]
    nxt = 1
    while todo:
        i, d = todo.pop(0)
        if d == depth:
            lv = ([float(v) for v in rng.randn(leaf_width)] if leaf_width
                  else float(np.round(rng.randn(), 1)))
            nodes.append({"node_index": i, "leaf_value": lv})
            continue
        node = {"node_index": i, "split_feature": int(rng.randint(n_feat)),
                "threshold": float(rng.randn()), "left_child": nxt,
                "right_child": nxt + 1}
        if rng.rand() < default_right:
            node["default_left"] = False
        nodes.append(node)
        todo += [(nxt, d + 1), (nxt + 1, d + 1)]
        nxt += 2
    return nodes


PREPROCESSORS = [
    {"one_hot_encoding": {"field": "color",
                          "hot_map": {"red": "c_red", "blue": "c_blue"}}},
    {"frequency_encoding": {"field": "city", "feature_name": "city_f",
                            "frequency_map": {"a": 0.5, "b": 0.25}}},
    {"target_mean_encoding": {"field": "city", "feature_name": "city_t",
                              "target_map": {"a": 3.0, "c": -1.0},
                              "default_value": 0.5}}]
FEATURES = ["x", "y", "c_red", "c_blue", "city_f", "city_t"]


def _docs(rng, n):
    docs = []
    for i in range(n):
        d = {"x": float(rng.randn()), "y": int(rng.randint(-3, 4)),
             "color": ["red", "blue", "green"][i % 3],
             "city": ["a", "b", "c", "d"][i % 4]}
        if i % 5 == 0:
            del d["x"]
        if i % 7 == 0:
            d["y"] = True
        docs.append(d)
    return docs


def _model(rng, task, aggregate, n_trees, leaf_width=None):
    trees = [{"tree": {"feature_names": FEATURES,
                       "tree_structure": _tree(rng, len(FEATURES), 3,
                                               leaf_width)}}
             for _ in range(n_trees)]
    ens = {"feature_names": FEATURES,
           "aggregate_output": {aggregate: {
               "weights": [float(w) for w in rng.rand(n_trees) + 0.5]}},
           "trained_models": trees}
    if task == "classification":
        ens["classification_labels"] = ["lo", "mid", "hi"][
            :(leaf_width or 2)]
    cfg = {task: {"num_top_classes": 2}} if task == "classification" \
        else {task: {}}
    return {"inference_config": cfg,
            "definition": {"preprocessors": PREPROCESSORS,
                           "trained_model": {"ensemble": ens}}}


@pytest.mark.parametrize("task,aggregate,leaf_width", [
    ("regression", "weighted_sum", None),
    ("regression", "logistic_regression", None),
    ("regression", "weighted_mode", None),
    ("classification", "weighted_sum", 3),        # leaf vectors
    ("classification", "weighted_sum", None)])    # a binary margin
def test_trained_model_infer_equals_the_reference(task, aggregate,
                                                  leaf_width):
    rng = np.random.RandomState(7)
    body = _model(rng, task, aggregate, 6, leaf_width)
    docs = _docs(rng, 40)
    ref = R.TrainedModel("m", body)
    got = P.TrainedModel("m", body, device="cpu")
    assert got.device.type == "cpu"
    assert got._dev_arrays[0].device.type == "cpu"
    for cfg in (None, {task: {"num_top_classes": 3,
                              "results_field": "out"}}):
        assert got.infer(docs, cfg) == ref.infer(docs, cfg)
    assert got.stats == ref.stats


def test_model_and_service_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.MlService(lambda i, b: {}, lambda i, lines: {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.TrainedModel("m", {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P._knn_outlier_scores(np.zeros((3, 2), np.float32), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P._train_logreg(np.zeros((3, 2), np.float32), np.zeros(3), 2)
    meta = torch.empty(4, 2, device="meta")
    with pytest.raises(ValueError):
        P.knn_kdist(meta, 2)
    with pytest.raises(ValueError):
        P.logreg_train(meta, torch.empty(4, dtype=torch.int32,
                                         device="meta"), 2)


# -- K21 and K22 -------------------------------------------------------------

@pytest.mark.parametrize("n,f,k", [
    (1, 3, 5), (2, 3, 5), (3, 2, 2), (60, 4, 5), (60, 4, 59), (60, 4, 100),
    (300, 8, 5), (300, 8, 1), (250, 20, 16)])
def test_k21_plain_scores_match_the_reference(n, f, k):
    """Scores within KNN_ATOL, including n < 2 (zeros) and k >= n - 1."""
    X = outlier_frame(n * 3 + f, n, f, duplicates=min(3, n // 10))
    ref = R._knn_outlier_scores(X, k)
    got = P._knn_outlier_scores(X, k, device="cpu")
    assert got.dtype == np.float32 and got.shape == (n,)
    assert np.abs(got - ref).max(initial=0.0) <= KNN_ATOL


def test_k21_plain_rows_split_equals_whole():
    X = torch.from_numpy(outlier_frame(9, 120, 5))
    whole = P.knn_kdist_plain(X, 7)
    parts = torch.cat([P.knn_kdist_plain(X, 7, rows=(lo, min(lo + 50, 120)))
                       for lo in range(0, 120, 50)])
    assert torch.equal(whole, parts)
    assert torch.equal(P.knn_kdist(X, 7), whole)


@pytest.mark.parametrize("n,f,C,bad", [
    (1, 2, 2, False), (200, 4, 2, False), (300, 6, 3, True),
    (150, 3, 4, False)])
def test_k22_plain_matches_the_reference(n, f, C, bad):
    """Weights within W_TOL; labels outside [0, C) give zero rows; a class
    with no training row (C = 4 with labels drawn below 3) trains too."""
    X, y = logreg_case(n + C, n, f, C, bad_labels=bad)
    if C == 4:
        y = y % 3
    ref = R._train_logreg(X, y, C)
    got = P._train_logreg(X, y, C, device="cpu")
    assert got.dtype == np.float32 and got.shape == (f + 1, C)
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() <= W_TOL * scale
    Xb = np.concatenate([X, np.ones((n, 1), np.float32)], 1)
    lr_, lg = Xb @ ref, Xb @ got
    top2 = -np.sort(-lr_, axis=1)[:, :2]
    sep = top2[:, 0] - top2[:, 1] > MARGIN
    np.testing.assert_array_equal(lr_.argmax(1)[sep], lg.argmax(1)[sep])


def test_k22_wrapper_runs_the_plain_version_on_cpu():
    X, y = logreg_case(3, 50, 3, 2)
    Xb = torch.cat([torch.from_numpy(X), torch.ones(50, 1)], 1)
    yt = torch.from_numpy(y.astype(np.int32))
    assert torch.equal(P.logreg_train(Xb, yt, 2, steps=20),
                       P.logreg_train_plain(Xb, yt, 2, steps=20))


# -- the service: analytics parity -----------------------------------------

def _frame(seed, n):
    rng = np.random.RandomState(seed)
    docs = []
    for i in range(n):
        km = float(rng.lognormal(7.0, 0.6))
        delay = int(rng.choice([0, 0, 0, 15, 45, 120]))
        d = {"AvgTicketPrice": float(rng.uniform(100, 1200)),
             "DistanceKilometers": km, "DistanceMiles": km * 0.621371,
             "FlightDelayMin": delay, "FlightDelay": delay > 0,
             "dayOfWeek": int(rng.randint(7)),
             "hour_of_day": int(rng.randint(24)), "Carrier": "x"}
        if i % 13 == 0:
            del d["FlightDelay"]
        docs.append(d)
    return docs


def _paged_search(docs):
    """search_fn: pages an in-memory list by the body _load_frame sends."""
    def search(index, body):
        assert body["sort"][-1] == {"_shard_doc": "asc"}
        start = (body.get("search_after") or [-1])[0] + 1
        page = docs[start:start + body["size"]]
        return {"hits": {"hits": [
            {"_id": f"d{start + i}", "_source": dict(d),
             "sort": [start + i]} for i, d in enumerate(page)]}}
    return search


ANALYSES = {
    "od": {"outlier_detection": {"n_neighbors": 4}},
    "rg": {"regression": {"dependent_variable": "FlightDelayMin",
                          "training_percent": 80}},
    "cl": {"classification": {"dependent_variable": "FlightDelay",
                              "num_top_classes": 2}},
}


@pytest.mark.parametrize("kind", sorted(ANALYSES))
def test_service_analytics_equal_the_reference(kind):
    docs = _frame(11, 1500)         # two pages of the frame's reader
    search = _paged_search(docs)
    written = {}
    ref = R.MlService(search, lambda i, lines: written.setdefault("r",
                                                                  lines))
    got = P.MlService(search, lambda i, lines: written.setdefault("p",
                                                                  lines),
                      device="cpu")
    cfg = {"source": {"index": "flights"}, "dest": {"index": "out"},
           "analysis": ANALYSES[kind]}
    if kind != "od":
        cfg["analyzed_fields"] = {"excludes": ["DistanceMiles"]}
    for svc in (ref, got):
        svc.put_analytics(kind, cfg)
        svc.start_analytics(kind)
    assert len(written["p"]) == 2 * len(docs)
    tol = {"od": KNN_ATOL, "rg": 0.0, "cl": 1e-5}[kind]
    _close(written["p"], written["r"], tol)
    ms = [s.analytics[kind].get("metrics") for s in (ref, got)]
    _close(ms[1], ms[0], 1e-9 if kind == "cl" else 0.0)
    assert ref.analytics_stats(kind)["data_frame_analytics"][0][
        "progress"] == got.analytics_stats(kind)["data_frame_analytics"][0][
        "progress"]


# -- REST parity: the port's service behind the reference's REST layer ------

def _req(api, method, path, body=None, query=""):
    b = json.dumps(body).encode() if body is not None else b""
    st, _ct, out = api.handle(method, path, query, b)
    return st, json.loads(out)


TREE_MODEL = {
    "inference_config": {"regression": {}},
    "definition": {"trained_model": {"tree": {
        "feature_names": ["x", "y"],
        "tree_structure": [
            {"node_index": 0, "split_feature": 0, "threshold": 5.0,
             "left_child": 1, "right_child": 2},
            {"node_index": 1, "leaf_value": 10.0},
            {"node_index": 2, "split_feature": 1, "threshold": 3.0,
             "left_child": 3, "right_child": 4},
            {"node_index": 3, "leaf_value": 20.0},
            {"node_index": 4, "leaf_value": 30.0}]}}}}
CLF_MODEL = {
    "inference_config": {"classification": {"num_top_classes": 2}},
    "definition": {"trained_model": {"tree": {
        "feature_names": ["x"], "classification_labels": ["no", "yes"],
        "tree_structure": [
            {"node_index": 0, "split_feature": 0, "threshold": 0.5,
             "left_child": 1, "right_child": 2},
            {"node_index": 1, "leaf_value": [4.0, 0.0]},
            {"node_index": 2, "leaf_value": [0.0, 4.0]}]}}}}


def _rest_scenario(api):
    """test_ml.py's scenarios: _infer, the inference ingest processor, the
    three analytics; returns every response."""
    out = []

    def call(*a, **kw):
        out.append(_req(api, *a, **kw))
        return out[-1]

    call("PUT", "/_ml/trained_models/m1", TREE_MODEL)
    call("POST", "/_ml/trained_models/m1/_infer",
         {"docs": [{"x": 1.0, "y": 0.0}, {"x": 9.0, "y": 1.0},
                   {"x": 9.0, "y": 9.0}, {"y": 9.0}]})
    call("PUT", "/_ml/trained_models/clf", CLF_MODEL)
    call("POST", "/_ml/trained_models/clf/_infer",
         {"docs": [{"x": 0.0}, {"x": 1.0}]})
    call("GET", "/_ml/trained_models/m1/_stats")
    call("PUT", "/_ingest/pipeline/scorer",
         {"processors": [{"inference": {"model_id": "m1",
                                        "target_field": "ml"}}]})
    call("PUT", "/docs/_doc/1", {"x": 9.0, "y": 9.0}, query="pipeline=scorer")
    call("GET", "/docs/_doc/1")
    pts = [{"a": 1.0 + (i % 5) * 0.01, "b": 2.0} for i in range(20)] + \
        [{"a": 8.0 + (i % 5) * 0.01, "b": 9.0} for i in range(20)] + \
        [{"a": 100.0, "b": -50.0}]
    for i, d in enumerate(pts):
        _req(api, "PUT", f"/points/_doc/{i}", d)
    for i in range(40):
        _req(api, "PUT", f"/reg/_doc/{i}", {"x": float(i),
                                             "noise": (i % 7) * 0.01,
                                             "target": 3.0 * i + 7.0})
    _req(api, "PUT", "/reg/_doc/100", {"x": 50.0, "noise": 0.0})
    for i in range(30):
        _req(api, "PUT", f"/clf/_doc/a{i}", {"f": -2.0 - (i % 5) * 0.1,
                                             "label": "neg"})
        _req(api, "PUT", f"/clf/_doc/b{i}", {"f": 2.0 + (i % 5) * 0.1,
                                             "label": "pos"})
    _req(api, "PUT", "/clf/_doc/q", {"f": 3.0})
    for idx in ("points", "reg", "clf"):
        _req(api, "POST", f"/{idx}/_refresh")
    for aid, src, analysis in (
            ("od", "points", {"outlier_detection": {}}),
            ("rg", "reg", {"regression": {"dependent_variable": "target"}}),
            ("cl", "clf", {"classification": {
                "dependent_variable": "label"}})):
        call("PUT", f"/_ml/data_frame/analytics/{aid}",
             {"source": {"index": src}, "dest": {"index": f"{src}_out"},
              "analysis": analysis})
        call("POST", f"/_ml/data_frame/analytics/{aid}/_start")
        call("GET", f"/_ml/data_frame/analytics/{aid}/_stats")
    for i in range(len(pts)):
        call("GET", f"/points_out/_doc/{i}")
    for i in (10, 100):
        call("GET", f"/reg_out/_doc/{i}")
    for i in ("a3", "b7", "q"):
        call("GET", f"/clf_out/_doc/{i}")
    return out


def _strip_volatile(resp):
    """Creation times and stats timestamps differ between two runs."""
    if isinstance(resp, dict):
        return {k: _strip_volatile(v) for k, v in resp.items()
                if k not in ("create_time", "timestamp")}
    if isinstance(resp, list):
        return [_strip_volatile(v) for v in resp]
    return resp


def test_rest_responses_equal_with_the_ported_service(tmp_path, monkeypatch):
    """The port's MlService (on the CPU) behind the reference's RestAPI
    answers test_ml.py's scenarios as the reference's own service does:
    equal responses, outlier scores within KNN_ATOL and class
    probabilities within 1e-5."""
    ref_api = RestAPI(IndicesService(str(tmp_path / "ref")))
    # the reference's service rebinds its module registry: restore it
    # after the test
    monkeypatch.setattr(R, "_MODEL_REGISTRY", R._MODEL_REGISTRY)
    ref = _rest_scenario(ref_api)
    api = RestAPI(IndicesService(str(tmp_path / "port")))
    svc = P.MlService(lambda i, b: api.internal_search(i, b),
                      lambda i, lines: api.internal_bulk(i, lines,
                                                         refresh=True),
                      device="cpu")
    api._ml_svc = svc
    # the reference's inference processor resolves models through its
    # module registry: point it at the port's models
    monkeypatch.setattr(R, "_MODEL_REGISTRY", svc.models)
    got = _rest_scenario(api)
    assert [st for st, _ in got] == [st for st, _ in ref]
    assert all(st in (200, 201) for st, _ in got), got
    _close(_strip_volatile([b for _, b in got]),
           _strip_volatile([b for _, b in ref]), KNN_ATOL)
    assert isinstance(svc.models["m1"], P.TrainedModel)


# -- the ingest pipeline copy --------------------------------------------------

def test_pipeline_inference_processor_equals_the_reference(monkeypatch):
    rng = np.random.RandomState(12)
    body = _model(rng, "regression", "weighted_sum", 4)
    cfg = {"processors": [
        {"set": {"field": "seen", "value": True}},
        {"inference": {"model_id": "m", "target_field": "pred",
                       "field_map": {"xx": "x"}}},
        {"lowercase": {"field": "color"}}]}
    monkeypatch.setattr(R, "_MODEL_REGISTRY",
                        {"m": R.TrainedModel("m", body)})
    monkeypatch.setattr(P, "_MODEL_REGISTRY",
                        {"m": P.TrainedModel("m", body, device="cpu")})
    ref_p = r_pipe.Pipeline("p", cfg)
    got_p = t_pipe.Pipeline("p", cfg)
    for d in _docs(rng, 12):
        d = dict(d, color=d["color"].upper())
        if "x" in d:
            d["xx"] = d.pop("x")
        a = ref_p.execute(r_pipe.IngestDocument("i", "1", dict(d)))
        b = got_p.execute(t_pipe.IngestDocument("i", "1", dict(d)))
        assert b.source == a.source
        assert b.source["pred"]["model_id"] == "m"
    with pytest.raises(t_pipe.ProcessorException, match="Could not find"):
        t_pipe.Pipeline("q", {"processors": [{"inference": {
            "model_id": "none"}}]}).execute(
                t_pipe.IngestDocument("i", "1", {}))


def test_pipeline_registry_is_the_ports_own():
    assert t_pipe._PROCESSOR_TYPES["inference"] is P.InferenceProcessor
    assert r_pipe._PROCESSOR_TYPES["inference"] is R.InferenceProcessor


def test_script_processor_is_refused_not_skipped():
    with pytest.raises(ParsingError, match="not ported.*ROADMAP A8.*"
                       "script/service.py"):
        t_pipe.Pipeline("p", {"processors": [
            {"script": {"source": "ctx.x = 1"}}]})
    with pytest.raises(ParsingError, match="required property"):
        t_pipe.build_processor({"script": {}})


# -- expressions -------------------------------------------------------------

EXPRESSIONS = ["a + b * 2 - c / 4", "a % 3 + b // 2", "-a ** 2",
               "1 if a > b else 0", "a > 0 and b < 1 or not c == 2",
               "a if a >= b else b - 1", "params.k * a + 3",
               "max(a, 1) + min(2, b) + abs(c)",
               "sqrt(abs(a)) + log(abs(b) + 1) + exp(c / 10)",
               "pow(abs(a), 1.5) + floor(b) + ceil(c) + round(a)",
               "sin(a) + cos(b) + tan(c / 10) + log10(abs(a) + 1)"]


@pytest.mark.parametrize("src", EXPRESSIONS)
def test_expression_vec_equals_the_reference_on_numpy(src):
    """Arithmetic on float64 columns is exact; the reference's functions
    and ``where`` (``a if c else b``) run through jnp, which computes in
    float32 here (x64 off), so those agree within float32 rounding."""
    rng = np.random.RandomState(len(src))
    env = {"a": rng.randn(64) * 3, "b": rng.randn(64),
           "c": rng.randint(-3, 4, 64).astype(np.float64), "k": 1.5}
    ref = np.asarray(r_expr.evaluate_expression_vec(src, env))
    got = t_expr.evaluate_expression_vec(src, env)
    assert isinstance(got, np.ndarray)
    if " if " in src or any(f + "(" in src for f in r_expr._ALLOWED_FUNCS):
        np.testing.assert_allclose(got, ref.astype(np.float64), rtol=1e-5,
                                   atol=1e-5)
    else:
        np.testing.assert_array_equal(got, ref)
    tenv = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in env.items()}
    tgot = t_expr.evaluate_expression_vec(src, tenv)
    assert isinstance(tgot, torch.Tensor)
    np.testing.assert_allclose(tgot.numpy().astype(np.float64), got,
                               rtol=1e-12, atol=1e-12)


def test_expression_vec_refuses_what_the_reference_refuses():
    for src in ("a.b", "a[0]", "open('x')", "1 < a < 2"):
        with pytest.raises(t_expr.ScriptException):
            t_expr.evaluate_expression_vec(src, {"a": np.ones(2)})
    with pytest.raises(t_expr.ScriptException, match="unknown variable"):
        t_expr.evaluate_expression_vec("z + 1", {"a": np.ones(2)})


def test_runtime_field_column_evaluates_through_the_ports_copy():
    """index/mapping.py's runtime column imports utils.expressions: the
    port now has it."""
    from elasticsearch_tpu_torch.index.mapping import MapperService
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder
    svc = MapperService({"runtime": {"double_p": {
        "type": "double", "script": {"source": "p * 2 + 1"}}},
        "properties": {"p": {"type": "double"}}})
    b = SegmentBuilder("_0")
    for i, v in enumerate((1.0, 2.5, None)):
        b.add(svc.parse_document(str(i), {} if v is None else {"p": v}),
              seq_no=i)
    seg = b.build(device="cpu")
    col = svc.field_type("double_p").column(seg)
    assert col[:2].tolist() == [3.0, 6.0] and np.isnan(col[2])
