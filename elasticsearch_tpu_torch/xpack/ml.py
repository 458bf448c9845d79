"""Machine learning: anomaly detection, datafeeds, trained-model
inference, and dataframe analytics.

Reference: ``x-pack/plugin/ml/`` (67k Java LoC + the native C++
``autodetect`` process managed through ``process/NativeController.java:35``).
The reference's split is: job/datafeed config management in Java, the
statistical modeling in a side-car C++ process fed over named pipes, and
tree-ensemble inference evaluated per-document in Java
(``inference/trainedmodel/ensemble/Ensemble.java``).

Design — the compute lives on the card, not in a side-car:

* **Anomaly detection** (``job/``, ``autodetect``): per-series online
  Gaussian baselines (exponentially decayed Welford moments) updated as
  buckets close; the anomaly score is the two-sided (or one-sided for
  ``high_``/``low_`` functions) normal tail probability mapped onto the
  reference's 0-100 score scale.  Results are indexed into
  ``.ml-anomalies-shared`` exactly like the reference's results index, so
  they are searchable with the ordinary query DSL.
* **Inference** (``inference/``): tree ensembles are flattened into
  padded ``(tree, node)`` arrays, packed on the card once a model into one
  16-byte record a node (:class:`TreePack`), and walked by one kernel
  launch a call (K20, ``csrc/tree_eval.cu``: for a batch, a doc tile's
  rows staged and several walks a thread; for a few docs, a block a tree
  staged in shared memory and a thread a doc), instead of the
  reference's per-document recursive Java walk. The leaf gather and the
  weighted sums stay host numpy.
* **Dataframe analytics** (``dataframe/``): outlier detection is a
  pairwise-distance kernel (K21, ``csrc/knn_outlier.cu``: the
  ``|x|^2 + |y|^2 - 2 x.y`` form streamed past each row with a running
  list of its k smallest, never the n x n matrix) and a torch tail;
  regression is a host least-squares solve; classification is full-batch
  multinomial logistic regression, one kernel launch a gradient step
  (K22, ``csrc/logreg_train.cu``).

Each kernel's wrapper (:func:`eval_tree_pack`, :func:`knn_kdist`,
:func:`logreg_train`) has its plain PyTorch version beside it, which
serves CPU tensors only; a CUDA tensor launches the kernel or raises. The
service and its models run on the card unless the caller passes
``device="cpu"``.

Kept host-side on purpose: config CRUD, datafeed paging (IO-bound), and
bucket bookkeeping — same boundary the reference draws between its Java
layer and the native process.
"""
from __future__ import annotations

import json
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common.errors import (ElasticsearchError, IllegalArgumentError,
                             ResourceAlreadyExistsError,
                             ResourceNotFoundError)
from ..device import resolve_device
from ..ingest.pipeline import (Processor, ProcessorException, _req,
                               register_processor)
from ..kernels import build as _kb
from ..ops.blockmax import fma_f32

RESULTS_INDEX = ".ml-anomalies-shared"


def _now_ms() -> int:
    return int(time.time() * 1000)


def _parse_time(v: Any) -> Optional[int]:
    """Epoch ms from epoch-seconds, epoch-ms, or ISO8601."""
    if v is None:
        return None
    if isinstance(v, (int, float)):
        # heuristic matching the reference's epoch/epoch_ms sniffing
        return int(v * 1000) if v < 10_000_000_000 else int(v)
    s = str(v)
    if s.isdigit():
        return _parse_time(int(s))
    import datetime as _dt
    try:
        dt = _dt.datetime.fromisoformat(s.replace("Z", "+00:00"))
    except ValueError:
        return None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return int(dt.timestamp() * 1000)


def _span_ms(span: Any) -> int:
    """Parse a bucket_span like ``15m``/``1h``/``300s`` to ms."""
    if isinstance(span, (int, float)):
        return int(span * 1000)
    s = str(span).strip().lower()
    units = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000,
             "d": 86_400_000}
    for suffix in ("ms", "s", "m", "h", "d"):
        if s.endswith(suffix) and s[: -len(suffix)].replace(".", "").isdigit():
            return int(float(s[: -len(suffix)]) * units[suffix])
    raise IllegalArgumentError(
        f"failed to parse setting [bucket_span] with value [{span}]")


# ---------------------------------------------------------------------------
# Anomaly detection: per-series decayed-Welford baseline + tail-prob score
# ---------------------------------------------------------------------------

#: functions → (needs_field, one_sided: None both / +1 high / -1 low)
_FUNCTIONS: Dict[str, Tuple[bool, Optional[int]]] = {
    "count": (False, None), "high_count": (False, 1),
    "low_count": (False, -1), "non_zero_count": (False, None),
    "mean": (True, None), "avg": (True, None), "high_mean": (True, 1),
    "low_mean": (True, -1), "min": (True, -1), "max": (True, 1),
    "sum": (True, None), "high_sum": (True, 1), "low_sum": (True, -1),
    "metric": (True, None), "distinct_count": (True, None),
    "median": (True, None),
}

_DECAY = 0.98          # per-bucket decay on the baseline moments
_MIN_BASELINE = 3      # buckets before a series can produce anomalies


class _SeriesModel:
    """Decayed Welford moments for one (detector, by, partition) series.

    Stands in for the C++ autodetect per-series model
    (`x-pack/plugin/ml` native process); the decay keeps the baseline
    adaptive the way the reference's time-based model pruning does.
    """

    __slots__ = ("n", "mean", "m2")

    def __init__(self):
        self.n = 0.0
        self.mean = 0.0
        self.m2 = 0.0

    def score(self, x: float, side: Optional[int]) -> Tuple[float, float]:
        """(probability, score 0-100) of observing x under the baseline."""
        if self.n < _MIN_BASELINE:
            return 1.0, 0.0
        var = self.m2 / max(self.n - 1.0, 1.0)
        sd = math.sqrt(var) if var > 1e-12 else max(abs(self.mean), 1.0) * 0.01
        z = (x - self.mean) / sd
        if side == 1 and z < 0:
            return 1.0, 0.0
        if side == -1 and z > 0:
            return 1.0, 0.0
        # two-sided tail probability; one-sided keeps its own tail only
        tail = math.erfc(abs(z) / math.sqrt(2.0))
        p = tail if side is None else tail / 2.0
        p = max(p, 1e-308)
        # probability → 0-100 score, the reference's log-scale shape
        # (ml/anomaly score normalization): p=0.05 → ~13, p=1e-10 → ~100
        score = min(100.0, max(0.0, -10.0 * math.log10(p) - 10.0))
        return p, score

    def update(self, x: float) -> None:
        self.n = self.n * _DECAY + 1.0
        delta = x - self.mean
        self.mean += delta / self.n
        self.m2 = self.m2 * _DECAY + delta * (x - self.mean)


class _BucketAcc:
    """Accumulates one in-flight bucket for one series."""

    __slots__ = ("count", "total", "mn", "mx", "distinct")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.mn = math.inf
        self.mx = -math.inf
        self.distinct: set = set()

    def add(self, value: Optional[float]) -> None:
        self.count += 1
        if value is not None:
            self.total += value
            self.mn = min(self.mn, value)
            self.mx = max(self.mx, value)
            self.distinct.add(value)

    def value(self, func: str) -> Optional[float]:
        base = func.replace("high_", "").replace("low_", "")
        if base in ("count", "non_zero_count"):
            return float(self.count)
        if self.count == 0 or self.mn is math.inf:
            return None
        if base in ("mean", "avg", "metric", "median"):
            return self.total / self.count
        if base == "sum":
            return self.total
        if base == "min":
            return self.mn
        if base == "max":
            return self.mx
        if base == "distinct_count":
            return float(len(self.distinct))
        return None


class AnomalyJob:
    def __init__(self, job_id: str, body: dict):
        ac = body.get("analysis_config") or {}
        detectors = ac.get("detectors")
        if not detectors:
            raise IllegalArgumentError(
                "An analysis_config with at least one detector is required")
        for d in detectors:
            fn = d.get("function")
            if fn not in _FUNCTIONS:
                raise IllegalArgumentError(
                    f"Unknown function '{fn}'")
            needs_field, _side = _FUNCTIONS[fn]
            if needs_field and not d.get("field_name"):
                raise IllegalArgumentError(
                    f"Unless the function is 'count' one of field_name, "
                    f"by_field_name or over_field_name must be set")
        self.job_id = job_id
        self.config = dict(body, job_id=job_id,
                           create_time=_now_ms(),
                           job_type="anomaly_detector")
        self.bucket_span = _span_ms(ac.get("bucket_span", "5m"))
        self.detectors = detectors
        dd = body.get("data_description") or {}
        self.time_field = dd.get("time_field", "time")
        self.time_format = dd.get("time_format", "epoch_ms")
        self.state = "closed"
        #: (det_idx, by, partition) → _SeriesModel
        self.models: Dict[tuple, _SeriesModel] = {}
        #: bucket_start → {(det_idx, by, partition): _BucketAcc}
        self.pending: Dict[int, Dict[tuple, _BucketAcc]] = {}
        self.results: List[dict] = []      # buckets + records, time order
        self.snapshots: List[dict] = []
        self.counts = {"processed_record_count": 0,
                       "processed_field_count": 0,
                       "invalid_date_count": 0,
                       "missing_field_count": 0,
                       "out_of_order_timestamp_count": 0,
                       "bucket_count": 0,
                       "earliest_record_timestamp": None,
                       "latest_record_timestamp": None}
        self._latest_finalized = -1

    def _record_time(self, v: Any) -> Optional[int]:
        """Record timestamps follow data_description.time_format —
        ``epoch_ms`` (the default) must NOT be sniffed as seconds."""
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            if self.time_format == "epoch":
                return int(v * 1000)
            return int(v)
        return _parse_time(v)

    # -- data ingestion --------------------------------------------------
    def post(self, records: List[dict]) -> None:
        for rec in records:
            ts = self._record_time(rec.get(self.time_field))
            if ts is None:
                self.counts["invalid_date_count"] += 1
                continue
            if (self._latest_finalized >= 0
                    and ts < self._latest_finalized):
                self.counts["out_of_order_timestamp_count"] += 1
                continue
            self.counts["processed_record_count"] += 1
            c = self.counts
            c["earliest_record_timestamp"] = ts if \
                c["earliest_record_timestamp"] is None else \
                min(c["earliest_record_timestamp"], ts)
            c["latest_record_timestamp"] = ts if \
                c["latest_record_timestamp"] is None else \
                max(c["latest_record_timestamp"], ts)
            bucket = ts - ts % self.bucket_span
            accs = self.pending.setdefault(bucket, {})
            for di, det in enumerate(self.detectors):
                needs_field, _ = _FUNCTIONS[det["function"]]
                val = None
                if needs_field:
                    raw = rec.get(det["field_name"])
                    if raw is None:
                        self.counts["missing_field_count"] += 1
                        continue
                    try:
                        val = float(raw)
                    except (TypeError, ValueError):
                        self.counts["missing_field_count"] += 1
                        continue
                    self.counts["processed_field_count"] += 1
                by = rec.get(det["by_field_name"]) \
                    if det.get("by_field_name") else None
                part = rec.get(det["partition_field_name"]) \
                    if det.get("partition_field_name") else None
                accs.setdefault((di, by, part), _BucketAcc()).add(val)
        # finalize every bucket strictly older than the newest seen:
        # the newest may still receive records (stream semantics)
        if self.pending:
            newest = max(self.pending)
            for b in sorted(self.pending):
                if b < newest:
                    self._finalize(b)

    def flush(self) -> None:
        for b in sorted(self.pending):
            self._finalize(b)

    def _finalize(self, bucket_ts: int) -> None:
        accs = self.pending.pop(bucket_ts, None)
        if accs is None:
            return
        self._latest_finalized = max(self._latest_finalized,
                                     bucket_ts + self.bucket_span)
        self.counts["bucket_count"] += 1
        records: List[dict] = []
        max_score = 0.0
        for (di, by, part), acc in sorted(
                accs.items(), key=lambda kv: (kv[0][0], str(kv[0][1]),
                                              str(kv[0][2]))):
            det = self.detectors[di]
            func = det["function"]
            _needs, side = _FUNCTIONS[func]
            val = acc.value(func)
            if val is None:
                continue
            model = self.models.setdefault((di, by, part), _SeriesModel())
            prob, score = model.score(val, side)
            typical = model.mean
            model.update(val)
            if score > 0.0:
                rec = {"job_id": self.job_id, "result_type": "record",
                       "timestamp": bucket_ts,
                       "bucket_span": self.bucket_span // 1000,
                       "detector_index": di, "function": func,
                       "probability": prob, "record_score": score,
                       "initial_record_score": score,
                       "actual": [val], "typical": [typical],
                       "is_interim": False}
                if det.get("field_name"):
                    rec["field_name"] = det["field_name"]
                if by is not None:
                    rec["by_field_name"] = det["by_field_name"]
                    rec["by_field_value"] = by
                if part is not None:
                    rec["partition_field_name"] = det["partition_field_name"]
                    rec["partition_field_value"] = part
                records.append(rec)
                max_score = max(max_score, score)
        self.results.append(
            {"job_id": self.job_id, "result_type": "bucket",
             "timestamp": bucket_ts,
             "bucket_span": self.bucket_span // 1000,
             "anomaly_score": max_score,
             "initial_anomaly_score": max_score,
             "event_count": sum(a.count for a in accs.values()),
             "is_interim": False})
        self.results.extend(records)

    # -- snapshots -------------------------------------------------------
    def snapshot(self) -> dict:
        snap = {"job_id": self.job_id,
                "snapshot_id": str(len(self.snapshots) + 1),
                "timestamp": _now_ms(),
                "snapshot_doc_count": len(self.models),
                "_models": [(k, m.n, m.mean, m.m2)
                            for k, m in self.models.items()]}
        self.snapshots.append(snap)
        return snap

    def revert(self, snapshot_id: str) -> dict:
        for snap in self.snapshots:
            if snap["snapshot_id"] == snapshot_id:
                self.models = {}
                for k, n, mean, m2 in snap["_models"]:
                    m = _SeriesModel()
                    m.n, m.mean, m.m2 = n, mean, m2
                    self.models[k] = m
                return snap
        raise ResourceNotFoundError(
            f"No model snapshot with id [{snapshot_id}] exists for job "
            f"[{self.job_id}]")


# ---------------------------------------------------------------------------
# Trained-model inference: padded tree arrays walked by one kernel launch
# ---------------------------------------------------------------------------

def _eval_trees_plain(X, feats, thresh, left, right, dleft, depth):
    """Plain version of K20 (see :func:`_eval_trees`): the reference's
    level loop over all trees at once."""
    T, N = feats.shape
    n, F = X.shape
    dev = X.device
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=dev)
    rows = torch.arange(n, device=dev).expand(T, n)
    idx = torch.zeros((T, n), dtype=torch.int32, device=dev)
    for _ in range(depth):
        j = torch.where(idx < 0, idx + N, idx).clamp(0, N - 1).long()
        f = torch.gather(feats, 1, j)
        fc = f.clamp_min(0)
        xv = torch.where(fc < F, X[rows, fc.clamp_max(F - 1).long()], nan)
        go_left = torch.where(torch.isnan(xv),
                              torch.gather(dleft, 1, j) != 0,
                              xv < torch.gather(thresh, 1, j))
        nxt = torch.where(go_left, torch.gather(left, 1, j),
                          torch.gather(right, 1, j))
        idx = torch.where(f < 0, idx, nxt)
    return idx


def pack_tree_nodes(feats, thresh, left, right, dleft, F: int):
    """The trees as K20 reads them: i32[T, N, 4], one 16-byte record a
    node of (``min(feat, F) << 1 | (dleft != 0)``, or −1 for a leaf;
    ``thresh``'s f32 bits; ``left``; ``right``). Exact: every feature
    index ≥ F reads NaN alike, so F stands for all of them, and the index
    rules act on the node index before the read. Plain torch on the
    arrays' device."""
    if not 1 <= F < 1 << 30:
        raise ValueError(f"pack_tree_nodes: needs 1 <= F < 2^30 features; "
                         f"got F = {F}")
    f = torch.where(feats < 0, -1, (feats.clamp_max(F) << 1)
                    | (dleft != 0).to(torch.int32))
    return torch.stack([f.to(torch.int32), thresh.view(torch.int32), left,
                        right], dim=-1).contiguous()


class TreePack:
    """A model's trees for K20: the node arrays ``(feats, thresh, left,
    right, dleft)`` (:func:`_eval_trees`' inputs, kept for the plain
    version) and their packed records (:func:`pack_tree_nodes`) over
    ``F`` features, built and checked once a model."""

    def __init__(self, feats, thresh, left, right, dleft, F: int):
        T, N = feats.shape
        if F < 1 or N < 1:
            raise ValueError(f"TreePack: needs F >= 1 features and N >= 1 "
                             f"nodes; got F = {F}, N = {N}")
        dev = _kb.wrapper_device("tree_eval", feats)
        for name, t, dt in (("feats", feats, torch.int32),
                            ("thresh", thresh, torch.float32),
                            ("left", left, torch.int32),
                            ("right", right, torch.int32),
                            ("dleft", dleft, torch.int32)):
            _kb.check(t, name, dt, (T, N), dev)
        self.arrays = (feats, thresh, left, right, dleft)
        self.nodes = pack_tree_nodes(feats, thresh, left, right, dleft, F)
        self.T, self.N, self.F = T, N, F
        self.device = dev


def eval_tree_pack(X, pack: TreePack, depth: int):
    """Walk every (tree, doc) pair of ``pack``'s trees over X down to its
    leaf node index.

    X: (n, F) float32, F the pack's. Returns leaf node indices (T, n)
    int32, after exactly ``depth`` levels, with the reference's index
    rules (a negative index wraps once, reads clamp to the tree, a feature
    index past ``F`` reads NaN, a NaN feature follows ``dleft``; the
    returned index is raw: see ``csrc/tree_eval.cu``). Only X is checked
    a call; the pack was when it was built.

    A CPU tensor runs the plain version; a CUDA tensor launches K20.
    """
    dev = _kb.wrapper_device("tree_eval", X)
    if dev.type == "cpu":
        return _eval_trees_plain(X, *pack.arrays, depth)
    if depth < 0:
        raise ValueError(f"eval_tree_pack: needs depth >= 0; got {depth}")
    n = X.shape[0]
    _kb.check(X, "X", torch.float32, (n, pack.F), dev)
    if pack.device != dev:
        raise ValueError(f"tree_eval: the pack is on {pack.device}, X on "
                         f"{dev}")
    out = torch.empty((pack.T, n), dtype=torch.int32, device=dev)
    _kb.launch("tree_eval", dev, X.data_ptr(), n, pack.F,
               pack.nodes.data_ptr(), pack.T, pack.N, int(depth),
               out.data_ptr())
    return out


def _eval_trees(X, feats, thresh, left, right, dleft, depth):
    """Walk every (tree, doc) pair down to its leaf node index.

    X: (n, f) float32; feats/left/right/dleft: (T, N) int32 (feat = -1
    marks a leaf); thresh: (T, N) float32.  Returns leaf node indices
    (T, n) int32, after exactly ``depth`` levels (see
    :func:`eval_tree_pack`, which a model calls with the pack it keeps).

    A CPU tensor runs the plain version; a CUDA tensor packs the trees and
    launches K20.
    """
    dev = _kb.wrapper_device("tree_eval", X)
    if dev.type == "cpu":
        return _eval_trees_plain(X, feats, thresh, left, right, dleft,
                                 depth)
    n, F = X.shape
    T, N = feats.shape
    if F < 1 or N < 1 or depth < 0:
        raise ValueError(f"_eval_trees: needs F >= 1 features, N >= 1 "
                         f"nodes and depth >= 0; got F = {F}, N = {N}, "
                         f"depth = {depth}")
    return eval_tree_pack(X, TreePack(feats, thresh, left, right, dleft, F),
                          depth)


class TrainedModel:
    """A parsed tree/ensemble definition flattened to device arrays.

    Reference format: ``inference/trainedmodel/ensemble/Ensemble.java``
    and ``tree/Tree.java`` — the JSON model definition is identical; the
    evaluation strategy is not (see module docstring).
    """

    def __init__(self, model_id: str, body: dict, *, device=None):
        self.device = resolve_device(device)
        self.model_id = model_id
        self.config = dict(body, model_id=model_id,
                           create_time=_now_ms())
        inf_cfg = body.get("inference_config") or {}
        self.task = next(iter(inf_cfg), "regression")
        definition = body.get("definition")
        self.preprocessors = (definition or {}).get("preprocessors") or []
        self.feature_names: List[str] = []
        self.trees: List[dict] = []
        self.weights: List[float] = []
        self.aggregate = "weighted_sum"
        self.classification_labels: List[str] = []
        self._arrays = None
        self._dev_arrays = None
        self._pack = None
        self._depth = 1
        if definition:
            self._parse(definition.get("trained_model") or {})
        self.stats = {"inference_count": 0, "failure_count": 0,
                      "cache_miss_count": 0}

    def _parse(self, tm: dict) -> None:
        if "tree" in tm:
            t = tm["tree"]
            self.feature_names = t.get("feature_names") or []
            self.trees = [t]
            self.weights = [1.0]
            self.classification_labels = \
                t.get("classification_labels") or []
        elif "ensemble" in tm:
            ens = tm["ensemble"]
            self.feature_names = ens.get("feature_names") or []
            agg = ens.get("aggregate_output") or {}
            self.aggregate = next(iter(agg), "weighted_sum")
            spec = agg.get(self.aggregate) or {}
            raw_w = spec.get("weights")
            self.classification_labels = \
                ens.get("classification_labels") or []
            for m in ens.get("trained_models") or []:
                if "tree" not in m:
                    raise IllegalArgumentError(
                        "ensemble members must be trees")
                self.trees.append(m["tree"])
                if not self.feature_names:
                    self.feature_names = m["tree"].get(
                        "feature_names") or []
            self.weights = list(raw_w) if raw_w else [1.0] * len(self.trees)
        else:
            raise IllegalArgumentError(
                "[definition.trained_model] must contain [tree] or "
                "[ensemble]")
        if self.trees:
            self._flatten()

    def _flatten(self) -> None:
        max_nodes = max(len(t["tree_structure"]) for t in self.trees)
        T = len(self.trees)
        feats = np.full((T, max_nodes), -1, dtype=np.int32)
        thresh = np.zeros((T, max_nodes), dtype=np.float32)
        left = np.zeros((T, max_nodes), dtype=np.int32)
        right = np.zeros((T, max_nodes), dtype=np.int32)
        dleft = np.zeros((T, max_nodes), dtype=np.int32)
        n_classes = max(1, len(self.classification_labels))
        leaves = np.zeros((T, max_nodes, n_classes), dtype=np.float32)
        depth = 1
        for ti, t in enumerate(self.trees):
            nodes = {n.get("node_index", i): n
                     for i, n in enumerate(t["tree_structure"])}
            for ni, node in nodes.items():
                if "left_child" in node:
                    feats[ti, ni] = node.get("split_feature", 0)
                    thresh[ti, ni] = node.get("threshold", 0.0)
                    left[ti, ni] = node["left_child"]
                    right[ti, ni] = node["right_child"]
                    # the reference defaults default_left to TRUE
                    # (inference/trainedmodel/tree/TreeNode.java)
                    dleft[ti, ni] = 0 if node.get(
                        "default_left") is False else 1
                else:
                    lv = node.get("leaf_value", 0.0)
                    if isinstance(lv, list):
                        leaves[ti, ni, :len(lv)] = lv
                    else:
                        leaves[ti, ni, 0] = lv

            def _d(ni, seen=()):
                node = nodes.get(ni)
                if node is None or "left_child" not in node or ni in seen:
                    return 1
                s = seen + (ni,)
                return 1 + max(_d(node["left_child"], s),
                               _d(node["right_child"], s))
            depth = max(depth, _d(0))
        self._arrays = (feats, thresh, left, right, dleft, leaves)
        # the walk's node arrays live on the device from here on; the
        # leaves and weights stay host numpy for the gather and the sums
        self._dev_arrays = tuple(
            torch.from_numpy(a).to(self.device)
            for a in (feats, thresh, left, right, dleft))
        self._pack = TreePack(*self._dev_arrays,
                              F=max(1, len(self.feature_names)))
        self._depth = depth

    # -- feature assembly ------------------------------------------------
    def _vectorize(self, docs: List[dict]) -> np.ndarray:
        X = np.full((len(docs), max(1, len(self.feature_names))),
                    np.nan, dtype=np.float32)
        for i, doc in enumerate(docs):
            d = dict(doc)
            for pp in self.preprocessors:
                self._preprocess(pp, d)
            for j, name in enumerate(self.feature_names):
                v = d.get(name)
                if isinstance(v, bool):
                    v = int(v)
                if isinstance(v, (int, float)):
                    X[i, j] = v
        return X

    @staticmethod
    def _preprocess(pp: dict, d: dict) -> None:
        kind = next(iter(pp), None)
        spec = pp.get(kind) or {}
        field = spec.get("field")
        if kind == "one_hot_encoding":
            for val, feat in (spec.get("hot_map") or {}).items():
                d[feat] = 1 if str(d.get(field)) == val else 0
        elif kind == "frequency_encoding":
            d[spec.get("feature_name")] = (
                spec.get("frequency_map") or {}).get(
                    str(d.get(field)), 0.0)
        elif kind == "target_mean_encoding":
            d[spec.get("feature_name")] = (
                spec.get("target_map") or {}).get(
                    str(d.get(field)), spec.get("default_value", 0.0))

    # -- inference -------------------------------------------------------
    def infer(self, docs: List[dict],
              inference_config: Optional[dict] = None) -> List[dict]:
        if self._arrays is None:
            raise IllegalArgumentError(
                f"[{self.model_id}] has no model definition")
        X = self._vectorize(docs)
        leaves = self._arrays[5]
        idx = eval_tree_pack(torch.from_numpy(X).to(self.device),
                             self._pack, self._depth).cpu().numpy()
        # (T, n)
        per_tree = leaves[np.arange(len(self.trees))[:, None], idx]
        # per_tree: (T, n, C)
        w = np.asarray(self.weights, dtype=np.float32)[:, None, None]
        self.stats["inference_count"] += len(docs)
        cfg = dict((inference_config or {}).get(self.task) or {})
        base_cfg = (self.config.get("inference_config") or {}).get(
            self.task) or {}
        num_top = cfg.get("num_top_classes",
                          base_cfg.get("num_top_classes", 0))
        results_field = cfg.get(
            "results_field", base_cfg.get("results_field", "predicted_value"))
        out: List[dict] = []
        if self.task == "classification":
            labels = self.classification_labels or ["0", "1"]
            if per_tree.shape[2] > 1:
                scores = (per_tree * w).sum(axis=0)   # (n, C)
                e = np.exp(scores - scores.max(axis=1, keepdims=True))
                probs = e / e.sum(axis=1, keepdims=True)
            else:
                margin = (per_tree[:, :, 0] * w[:, :, 0]).sum(axis=0)
                p1 = 1.0 / (1.0 + np.exp(-margin))
                probs = np.stack([1.0 - p1, p1], axis=1)
            for i in range(len(docs)):
                order = np.argsort(-probs[i])
                top = [{"class_name": labels[c] if c < len(labels)
                        else str(c),
                        "class_probability": float(probs[i, c]),
                        "class_score": float(probs[i, c])}
                       for c in order[:max(num_top, 1)]]
                r = {results_field: top[0]["class_name"],
                     "prediction_probability": top[0]["class_probability"]}
                if num_top:
                    r["top_classes"] = top
                out.append(r)
        else:
            if self.aggregate == "logistic_regression":
                margin = (per_tree[:, :, 0] * w[:, :, 0]).sum(axis=0)
                vals = 1.0 / (1.0 + np.exp(-margin))
            elif self.aggregate == "weighted_mode":
                vals = []
                for i in range(per_tree.shape[1]):
                    votes: Dict[float, float] = {}
                    for t in range(per_tree.shape[0]):
                        v = float(per_tree[t, i, 0])
                        votes[v] = votes.get(v, 0.0) + float(w[t, 0, 0])
                    vals.append(max(votes.items(), key=lambda kv: kv[1])[0])
                vals = np.asarray(vals)
            else:                                      # weighted_sum
                vals = (per_tree[:, :, 0] * w[:, :, 0]).sum(axis=0)
            out = [{results_field: float(v)} for v in vals]
        return out


# ---------------------------------------------------------------------------
# Dataframe analytics device kernels
# ---------------------------------------------------------------------------

def knn_sq_norms_plain(X):
    """``sum_d x[i, d]^2`` as K21 forms it: an f32 FMA chain in ascending
    d."""
    sq = torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)
    for d in range(X.shape[1]):
        sq = fma_f32(X[:, d], X[:, d], sq)
    return sq


def knn_kdist_plain(X, kk: int, rows=None):
    """Plain version of K21 (see :func:`knn_kdist`) for the rows
    ``rows = (lo, hi)`` (all by default): the same f32 FMA chains and
    roundings, so equal bit for bit. It forms a [rows, n] matrix: the
    card's check runs it over chunks of rows."""
    n, f = X.shape
    lo, hi = rows if rows is not None else (0, n)
    sq = knn_sq_norms_plain(X)
    dot = torch.zeros((hi - lo, n), dtype=torch.float32, device=X.device)
    for d in range(f):
        dot = fma_f32(X[lo:hi, d, None], X[None, :, d], dot)
    d2 = (sq[lo:hi, None] + sq[None, :]) - 2.0 * dot
    d2 = torch.where(d2 < 0, torch.zeros_like(d2), d2)
    own = torch.arange(lo, hi, device=X.device)
    d2[own - lo, own] = float("inf")
    nn = torch.topk(d2, kk, dim=1, largest=False, sorted=True).values
    s = torch.zeros(hi - lo, dtype=torch.float32, device=X.device)
    for c in range(kk):
        s = s + nn[:, c]
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which can differ by an ulp
    return torch.sqrt(s / torch.full_like(s, float(kk)))


def knn_kdist(X, kk: int):
    """Per row of X f32[n, f], the root of the mean of its ``kk`` smallest
    squared distances to the other rows, ``d2 = max((|x_i|^2 + |x_j|^2) -
    2 x_i.x_j, 0)``: f32[n]. Needs ``1 <= kk <= n - 1``.

    A CPU tensor runs the plain version; on a CUDA tensor a ``kk``, ``n``
    or ``f`` out of range raises ``ValueError`` naming the range, and K21
    refuses a ``kk`` whose list does not fit a block's shared memory.
    """
    dev = _kb.wrapper_device("knn_outlier", X)
    if dev.type == "cpu":
        return knn_kdist_plain(X, kk)
    n, f = X.shape
    if n < 2 or f < 1 or not 1 <= kk <= n - 1:
        raise ValueError(f"knn_kdist: needs n >= 2 rows, f >= 1 features "
                         f"and kk in [1, n - 1]; got n = {n}, f = {f}, "
                         f"kk = {kk}")
    _kb.check(X, "X", torch.float32, (n, f), dev)
    sq = torch.empty(n + 1, dtype=torch.float32, device=dev)
    dk = torch.empty(n, dtype=torch.float32, device=dev)
    _kb.launch("knn_outlier", dev, X.data_ptr(), n, f, int(kk),
               sq.data_ptr(), dk.data_ptr())
    return dk


def outlier_scores_from_kdist(dk):
    """The z-scored kNN distances squashed into [0, 1]: torch ops on dk's
    device (population std, as ``jnp.std``)."""
    mu = dk.mean()
    sd = dk.std(correction=0) + 1e-9
    return torch.sigmoid((dk - mu) / sd * 2.0 - 2.0)


def _knn_outlier_scores(X: np.ndarray, k: int, *,
                        device=None) -> np.ndarray:
    """kNN-distance outlier scores in [0, 1].

    The pairwise distances stream through K21 (:func:`knn_kdist`) on
    ``device`` (None: the card), which keeps each row's k nearest.
    Score = sigmoid of the z-scored mean-kNN distance (the reference
    ensembles distance_kth_nn / distance_knn / lof —
    ``dataframe/process/` via the native process; one robust member
    suffices here and keeps the kernel single-pass).
    """
    dev = resolve_device(device)
    if X.shape[0] < 2:
        # no neighbors to measure against — nothing is an outlier
        return np.zeros((X.shape[0],), dtype=np.float32)
    Xd = torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32)).to(dev)
    dk = knn_kdist(Xd, min(k, X.shape[0] - 1))
    return outlier_scores_from_kdist(dk).cpu().numpy()


def logreg_train_plain(Xb, y, n_classes: int, steps: int = 500,
                       lr: float = 0.5):
    """Plain version of K22 (see :func:`logreg_train`): the reference's
    step in torch ops (matrix products, softmax)."""
    n = Xb.shape[0]
    yl = y.long()
    ok = (yl >= 0) & (yl < n_classes)
    Y = torch.zeros((n, n_classes), dtype=torch.float32, device=Xb.device)
    Y[torch.arange(n, device=Xb.device)[ok], yl[ok]] = 1.0
    W = torch.zeros((Xb.shape[1], n_classes), dtype=torch.float32,
                    device=Xb.device)
    for _ in range(steps):
        p = torch.softmax(Xb @ W, dim=1)
        g = Xb.T @ (p - Y) / n + 1e-4 * W
        W = W - lr * g
    return W


def logreg_train(Xb, y, n_classes: int, steps: int = 500, lr: float = 0.5):
    """Full-batch multinomial logistic regression from W = 0: ``steps``
    iterations of ``W -= lr (Xbᵀ (softmax(Xb W) - Y) / n + 1e-4 W)``, Y the
    one-hot of the int labels ``y`` (a label outside ``[0, n_classes)``
    gives a zero row). Xb f32[n, F1] holds the features and a column of
    ones. Returns W f32[F1, n_classes].

    A CPU tensor runs the plain version; a CUDA tensor launches K22 once
    for all ``steps`` (none for ``steps = 0``), which refuses sizes whose
    row tile does not fit a block's shared memory.
    """
    dev = _kb.wrapper_device("logreg_train", Xb)
    if dev.type == "cpu":
        return logreg_train_plain(Xb, y, n_classes, steps, lr)
    n, F1 = Xb.shape
    if n < 1 or F1 < 1 or n_classes < 1:
        raise ValueError(f"logreg_train: needs n >= 1 rows, F1 >= 1 "
                         f"columns and n_classes >= 1; got n = {n}, "
                         f"F1 = {F1}, n_classes = {n_classes}")
    _kb.check(Xb, "Xb", torch.float32, (n, F1), dev)
    _kb.check(y, "y", torch.int32, (n,), dev)
    W = torch.zeros((F1, n_classes), dtype=torch.float32, device=dev)
    if steps <= 0:
        return W
    nbytes = _kb.query("logreg_train", "es_logreg_workspace_bytes", n, F1,
                       n_classes)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    _kb.launch("logreg_train", dev, Xb.data_ptr(), y.data_ptr(), n, F1,
               n_classes, float(lr), int(steps), W.data_ptr(), ws.data_ptr())
    return W


def _train_logreg(X: np.ndarray, y: np.ndarray, n_classes: int,
                  steps: int = 500, lr: float = 0.5, *,
                  device=None) -> np.ndarray:
    """Full-batch multinomial logistic regression on ``device`` (None: the
    card), through :func:`logreg_train`."""
    dev = resolve_device(device)
    n = X.shape[0]
    Xb = torch.cat([torch.from_numpy(np.ascontiguousarray(
        X, dtype=np.float32)).to(dev),
        torch.ones((n, 1), dtype=torch.float32, device=dev)], dim=1)
    yd = torch.from_numpy(np.asarray(y).astype(np.int32)).to(dev)
    return logreg_train(Xb, yd, n_classes, steps, lr).cpu().numpy()


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------

class MlService:
    """Config management + orchestration over the REST seams.

    ``search_fn(index, body) -> response`` and
    ``bulk_fn(index, action_lines)`` ride the cluster-aware internal
    dispatch exactly like transform/rollup (rest/api.py seam), so ML
    results indices behave like any other index. Models and analytics run
    on ``device`` (None: the card; raises without one).
    """

    DF_PAGE = 1000

    def __init__(self, search_fn: Callable[[str, dict], dict],
                 bulk_fn: Callable[[str, List[dict]], dict], *,
                 device=None):
        self.device = resolve_device(device)
        self.search_fn = search_fn
        self.bulk_fn = bulk_fn
        self.jobs: Dict[str, AnomalyJob] = {}
        self.datafeeds: Dict[str, dict] = {}
        self.models: Dict[str, TrainedModel] = {}
        self.analytics: Dict[str, dict] = {}
        self.calendars: Dict[str, dict] = {}
        self.filters: Dict[str, dict] = {}
        self.upgrade_mode = False

    # ==== anomaly detection jobs =======================================
    def put_job(self, job_id: str, body: dict) -> dict:
        if job_id in self.jobs:
            raise ResourceAlreadyExistsError(
                f"The job cannot be created with the Id '{job_id}'. "
                f"The Id is already used.")
        job = AnomalyJob(job_id, body)
        self.jobs[job_id] = job
        return job.config

    def _job(self, job_id: str) -> AnomalyJob:
        job = self.jobs.get(job_id)
        if job is None:
            raise ResourceNotFoundError(
                f"No known job with id '{job_id}'")
        return job

    def _select_jobs(self, job_id: Optional[str]) -> List[AnomalyJob]:
        if job_id in (None, "", "_all", "*"):
            return [self.jobs[k] for k in sorted(self.jobs)]
        return [self._job(job_id)]

    def get_jobs(self, job_id: Optional[str]) -> dict:
        jobs = self._select_jobs(job_id)
        return {"count": len(jobs), "jobs": [j.config for j in jobs]}

    def job_stats(self, job_id: Optional[str]) -> dict:
        jobs = self._select_jobs(job_id)
        return {"count": len(jobs), "jobs": [
            {"job_id": j.job_id, "state": j.state,
             "data_counts": dict(j.counts, job_id=j.job_id),
             "model_size_stats": {
                 "job_id": j.job_id, "result_type": "model_size_stats",
                 "model_bytes": 64 * len(j.models),
                 "total_by_field_count": len(
                     {k[1] for k in j.models if k[1] is not None}),
                 "total_partition_field_count": len(
                     {k[2] for k in j.models if k[2] is not None}),
                 "bucket_allocation_failures_count": 0,
                 "memory_status": "ok"},
             "timing_stats": {"job_id": j.job_id,
                              "bucket_count": j.counts["bucket_count"]}}
            for j in jobs]}

    def delete_job(self, job_id: str, force: bool = False) -> dict:
        job = self._job(job_id)
        if job.state == "opened" and not force:
            raise ElasticsearchError(
                f"Cannot delete job [{job_id}] because the job is opened")
        for feed_id, feed in list(self.datafeeds.items()):
            if feed["config"].get("job_id") == job_id:
                if force:
                    del self.datafeeds[feed_id]
                else:
                    raise ElasticsearchError(
                        f"Cannot delete job [{job_id}] because datafeed "
                        f"[{feed_id}] refers to it")
        del self.jobs[job_id]
        return {"acknowledged": True}

    def open_job(self, job_id: str) -> dict:
        self._job(job_id).state = "opened"
        return {"opened": True, "node": ""}

    def close_job(self, job_id: str, force: bool = False) -> dict:
        job = self._job(job_id)
        job.flush()
        self._index_results(job)
        job.snapshot()
        job.state = "closed"
        return {"closed": True}

    def post_data(self, job_id: str, payload: bytes) -> dict:
        job = self._job(job_id)
        if job.state != "opened":
            raise ElasticsearchError(
                f"Cannot process data because job [{job_id}] is not open",
                )
        records: List[dict] = []
        text = payload.decode() if isinstance(payload, (bytes, bytearray)) \
            else str(payload)
        try:
            # a single JSON document or array (possibly pretty-printed)
            doc = json.loads(text)
            records = doc if isinstance(doc, list) else [doc]
        except json.JSONDecodeError:
            # NDJSON: one record per line
            for line in text.splitlines():
                line = line.strip()
                if not line:
                    continue
                doc = json.loads(line)
                if isinstance(doc, list):
                    records.extend(doc)
                else:
                    records.append(doc)
        job.post(records)
        return dict(job.counts, job_id=job_id)

    def flush_job(self, job_id: str) -> dict:
        job = self._job(job_id)
        job.flush()
        self._index_results(job)
        return {"flushed": True,
                "last_finalized_bucket_end": job._latest_finalized}

    def _index_results(self, job: AnomalyJob) -> None:
        """Mirror finalized results into the shared results index."""
        fresh = [r for r in job.results if not r.get("_indexed")]
        if not fresh:
            return
        lines: List[dict] = []
        for r in fresh:
            r["_indexed"] = True
            doc = {k: v for k, v in r.items() if k != "_indexed"}
            lines.append({"index": {}})
            lines.append(doc)
        try:
            self.bulk_fn(RESULTS_INDEX, lines)
        except ElasticsearchError:
            pass  # results remain queryable through the in-memory APIs

    # -- results ---------------------------------------------------------
    def get_buckets(self, job_id: str, body: Optional[dict] = None,
                    params: Optional[dict] = None) -> dict:
        job = self._job(job_id)
        body = body or {}
        buckets = [dict((k, v) for k, v in r.items() if k != "_indexed")
                   for r in job.results
                   if r["result_type"] == "bucket"]
        start = _parse_time(body.get("start") or (params or {}).get("start"))
        end = _parse_time(body.get("end") or (params or {}).get("end"))
        if start is not None:
            buckets = [b for b in buckets if b["timestamp"] >= start]
        if end is not None:
            buckets = [b for b in buckets if b["timestamp"] < end]
        threshold = float(body.get("anomaly_score", 0.0) or 0.0)
        if threshold:
            buckets = [b for b in buckets
                       if b["anomaly_score"] >= threshold]
        buckets.sort(key=lambda b: b["timestamp"])
        return {"count": len(buckets), "buckets": buckets}

    def get_records(self, job_id: str,
                    body: Optional[dict] = None,
                    params: Optional[dict] = None) -> dict:
        job = self._job(job_id)
        body = body or {}
        params = params or {}
        records = [dict((k, v) for k, v in r.items() if k != "_indexed")
                   for r in job.results
                   if r["result_type"] == "record"]
        start = _parse_time(body.get("start") or params.get("start"))
        end = _parse_time(body.get("end") or params.get("end"))
        if start is not None:
            records = [r for r in records if r["timestamp"] >= start]
        if end is not None:
            records = [r for r in records if r["timestamp"] < end]
        threshold = float(body.get("record_score")
                          or params.get("record_score") or 0.0)
        if threshold:
            records = [r for r in records
                       if r["record_score"] >= threshold]
        records.sort(key=lambda r: (-r["record_score"], r["timestamp"]))
        return {"count": len(records), "records": records}

    def get_overall_buckets(self, job_id: str,
                            body: Optional[dict] = None) -> dict:
        jobs = self._select_jobs(job_id)
        by_ts: Dict[int, List[float]] = {}
        for j in jobs:
            for r in j.results:
                if r["result_type"] == "bucket":
                    by_ts.setdefault(r["timestamp"], []).append(
                        r["anomaly_score"])
        buckets = [{"timestamp": ts, "bucket_span":
                    max(j.bucket_span for j in jobs) // 1000,
                    "overall_score": max(scores),
                    "jobs": [{"job_id": j.job_id} for j in jobs],
                    "is_interim": False, "result_type": "overall_bucket"}
                   for ts, scores in sorted(by_ts.items())]
        return {"count": len(buckets), "overall_buckets": buckets}

    # -- model snapshots -------------------------------------------------
    def get_model_snapshots(self, job_id: str) -> dict:
        job = self._job(job_id)
        snaps = [{k: v for k, v in s.items() if k != "_models"}
                 for s in job.snapshots]
        return {"count": len(snaps), "model_snapshots": snaps}

    def revert_model_snapshot(self, job_id: str,
                              snapshot_id: str) -> dict:
        snap = self._job(job_id).revert(snapshot_id)
        return {"model": {k: v for k, v in snap.items()
                          if k != "_models"}}

    # ==== datafeeds =====================================================
    def put_datafeed(self, feed_id: str, body: dict) -> dict:
        if feed_id in self.datafeeds:
            raise ResourceAlreadyExistsError(
                f"A datafeed with id [{feed_id}] already exists")
        job_id = body.get("job_id")
        if not job_id or job_id not in self.jobs:
            raise ResourceNotFoundError(
                f"No known job with id '{job_id}'")
        if not body.get("indices") and not body.get("indexes"):
            raise IllegalArgumentError("[indices] is required")
        cfg = dict(body, datafeed_id=feed_id)
        self.datafeeds[feed_id] = {"config": cfg, "state": "stopped",
                                   "search_count": 0}
        return cfg

    def _feed(self, feed_id: str) -> dict:
        feed = self.datafeeds.get(feed_id)
        if feed is None:
            raise ResourceNotFoundError(
                f"No datafeed with id [{feed_id}] exists")
        return feed

    def get_datafeeds(self, feed_id: Optional[str]) -> dict:
        if feed_id in (None, "", "_all", "*"):
            items = [self.datafeeds[k] for k in sorted(self.datafeeds)]
        else:
            items = [self._feed(feed_id)]
        return {"count": len(items),
                "datafeeds": [f["config"] for f in items]}

    def datafeed_stats(self, feed_id: Optional[str]) -> dict:
        if feed_id in (None, "", "_all", "*"):
            items = sorted(self.datafeeds.items())
        else:
            items = [(feed_id, self._feed(feed_id))]
        return {"count": len(items), "datafeeds": [
            {"datafeed_id": k, "state": f["state"],
             "timing_stats": {"job_id": f["config"].get("job_id"),
                              "search_count": f["search_count"]}}
            for k, f in items]}

    def delete_datafeed(self, feed_id: str) -> dict:
        self._feed(feed_id)
        del self.datafeeds[feed_id]
        return {"acknowledged": True}

    def start_datafeed(self, feed_id: str, start: Any = None,
                       end: Any = None) -> dict:
        """Drain the source into the job synchronously.

        The reference's ``DatafeedJob`` polls on a timer; here one _start
        call pages [start, end) through the search seam, posts to the
        job, and flushes — same collapse as transform's indexer loop.
        """
        feed = self._feed(feed_id)
        cfg = feed["config"]
        job = self._job(cfg["job_id"])
        if job.state != "opened":
            raise ElasticsearchError(
                f"cannot start datafeed [{feed_id}] because job "
                f"[{job.job_id}] is not open")
        feed["state"] = "started"
        try:
            time_field = job.time_field
            indices = cfg.get("indices") or cfg.get("indexes")
            index = ",".join(indices) if isinstance(indices, list) \
                else indices
            must: List[dict] = [cfg.get("query") or {"match_all": {}}]
            rng: Dict[str, Any] = {}
            s_ms, e_ms = _parse_time(start), _parse_time(end)
            if s_ms is not None:
                rng["gte"] = s_ms
            if e_ms is not None:
                rng["lt"] = e_ms
            if rng:
                must.append({"range": {time_field: dict(
                    rng, format="epoch_millis")}})
            search_after = None
            while True:
                body = {"size": self.DF_PAGE,
                        "query": {"bool": {"filter": must}},
                        "sort": [{time_field: "asc"},
                                 {"_shard_doc": "asc"}]}
                if search_after is not None:
                    body["search_after"] = search_after
                resp = self.search_fn(index, body)
                feed["search_count"] += 1
                hits = resp["hits"]["hits"]
                if not hits:
                    break
                job.post([h["_source"] for h in hits])
                search_after = hits[-1]["sort"]
                if len(hits) < self.DF_PAGE:
                    break
            job.flush()
            self._index_results(job)
        finally:
            feed["state"] = "stopped"
        return {"started": True, "node": ""}

    def stop_datafeed(self, feed_id: str) -> dict:
        self._feed(feed_id)["state"] = "stopped"
        return {"stopped": True}

    def preview_datafeed(self, feed_id: str) -> List[dict]:
        feed = self._feed(feed_id)
        cfg = feed["config"]
        indices = cfg.get("indices") or cfg.get("indexes")
        index = ",".join(indices) if isinstance(indices, list) else indices
        resp = self.search_fn(index, {
            "size": 100, "query": cfg.get("query") or {"match_all": {}}})
        return [h["_source"] for h in resp["hits"]["hits"]]

    # ==== trained models + inference ===================================
    def put_trained_model(self, model_id: str, body: dict) -> dict:
        if model_id in self.models:
            raise ResourceAlreadyExistsError(
                f"Trained machine learning model [{model_id}] already "
                f"exists")
        model = TrainedModel(model_id, body, device=self.device)
        self.models[model_id] = model
        cfg = {k: v for k, v in model.config.items() if k != "definition"}
        return cfg

    def _model(self, model_id: str) -> TrainedModel:
        m = self.models.get(model_id)
        if m is None:
            raise ResourceNotFoundError(
                f"No known trained model with model_id [{model_id}]")
        return m

    def get_trained_models(self, model_id: Optional[str]) -> dict:
        if model_id in (None, "", "_all", "*"):
            models = [self.models[k] for k in sorted(self.models)]
        else:
            models = [self._model(model_id)]
        return {"count": len(models), "trained_model_configs": [
            {k: v for k, v in m.config.items() if k != "definition"}
            for m in models]}

    def trained_model_stats(self, model_id: Optional[str]) -> dict:
        if model_id in (None, "", "_all", "*"):
            models = [self.models[k] for k in sorted(self.models)]
        else:
            models = [self._model(model_id)]
        return {"count": len(models), "trained_model_stats": [
            {"model_id": m.model_id,
             "inference_stats": dict(m.stats,
                                     timestamp=_now_ms())}
            for m in models]}

    def delete_trained_model(self, model_id: str) -> dict:
        self._model(model_id)
        del self.models[model_id]
        return {"acknowledged": True}

    def infer(self, model_id: str, body: dict) -> dict:
        model = self._model(model_id)
        docs = body.get("docs")
        if not isinstance(docs, list) or not docs:
            raise IllegalArgumentError("[docs] must be a non-empty array")
        results = model.infer(docs, body.get("inference_config"))
        return {"inference_results": results}

    # ==== dataframe analytics ==========================================
    def put_analytics(self, aid: str, body: dict) -> dict:
        if aid in self.analytics:
            raise ResourceAlreadyExistsError(
                f"A data frame analytics with id [{aid}] already exists")
        src = body.get("source") or {}
        if not src.get("index"):
            raise IllegalArgumentError("[source.index] is required")
        if not (body.get("dest") or {}).get("index"):
            raise IllegalArgumentError("[dest.index] is required")
        analysis = body.get("analysis") or {}
        kind = next(iter(analysis), None)
        if kind not in ("outlier_detection", "regression",
                        "classification"):
            raise IllegalArgumentError(
                "[analysis] must be one of [outlier_detection, "
                "regression, classification]")
        if kind in ("regression", "classification") and \
                not analysis[kind].get("dependent_variable"):
            raise IllegalArgumentError(
                "[dependent_variable] is required")
        cfg = dict(body, id=aid, create_time=_now_ms(), version="8.0.0")
        self.analytics[aid] = {"config": cfg, "state": "stopped",
                               "progress": []}
        return cfg

    def _analytics(self, aid: str) -> dict:
        a = self.analytics.get(aid)
        if a is None:
            raise ResourceNotFoundError(
                f"No known data frame analytics with id [{aid}]")
        return a

    def get_analytics(self, aid: Optional[str]) -> dict:
        if aid in (None, "", "_all", "*"):
            items = [self.analytics[k] for k in sorted(self.analytics)]
        else:
            items = [self._analytics(aid)]
        return {"count": len(items),
                "data_frame_analytics": [a["config"] for a in items]}

    def analytics_stats(self, aid: Optional[str]) -> dict:
        if aid in (None, "", "_all", "*"):
            items = sorted(self.analytics.items())
        else:
            items = [(aid, self._analytics(aid))]
        return {"count": len(items), "data_frame_analytics": [
            {"id": k, "state": a["state"],
             "progress": a["progress"]} for k, a in items]}

    def delete_analytics(self, aid: str) -> dict:
        self._analytics(aid)
        del self.analytics[aid]
        return {"acknowledged": True}

    def start_analytics(self, aid: str) -> dict:
        a = self._analytics(aid)
        cfg = a["config"]
        a["state"] = "started"
        try:
            self._run_analytics(cfg, a)
        finally:
            a["state"] = "stopped"
        a["progress"] = [
            {"phase": "reindexing", "progress_percent": 100},
            {"phase": "loading_data", "progress_percent": 100},
            {"phase": "analyzing", "progress_percent": 100},
            {"phase": "writing_results", "progress_percent": 100}]
        return {"acknowledged": True}

    def stop_analytics(self, aid: str) -> dict:
        self._analytics(aid)["state"] = "stopped"
        return {"stopped": True}

    def explain_analytics(self, body: dict) -> dict:
        src = (body.get("source") or {}).get("index")
        if not src:
            raise IllegalArgumentError("[source.index] is required")
        docs, fields = self._load_frame(body)
        analysis = body.get("analysis") or {}
        kind = next(iter(analysis), "outlier_detection")
        dep = (analysis.get(kind) or {}).get("dependent_variable")
        included = [f for f in fields if f != dep]
        return {"field_selection": [
            {"name": f, "mapping_types": ["double"], "is_included": True,
             "is_required": False, "feature_type": "numerical"}
            for f in included],
            "memory_estimation": {
                "expected_memory_without_disk":
                    f"{max(1, len(docs) * len(fields) * 8 // 1024)}kb"}}

    # -- frame loading / writing ----------------------------------------
    def _load_frame(self, cfg: dict) -> Tuple[List[dict], List[str]]:
        src = cfg.get("source") or {}
        indices = src.get("index")
        index = ",".join(indices) if isinstance(indices, list) else indices
        analyzed = (cfg.get("analyzed_fields") or {})
        includes = analyzed.get("includes") or []
        excludes = set(analyzed.get("excludes") or [])
        docs: List[dict] = []
        search_after = None
        while True:
            body = {"size": self.DF_PAGE,
                    "query": src.get("query") or {"match_all": {}},
                    "sort": [{"_shard_doc": "asc"}]}
            if search_after is not None:
                body["search_after"] = search_after
            resp = self.search_fn(index, body)
            hits = resp["hits"]["hits"]
            if not hits:
                break
            for h in hits:
                docs.append({"_id": h["_id"], **h["_source"]})
            search_after = hits[-1]["sort"]
            if len(hits) < self.DF_PAGE:
                break
        field_set: set = set()
        for d in docs:
            for k, v in d.items():
                if k == "_id":
                    continue
                if includes and k not in includes:
                    continue
                if k in excludes:
                    continue
                field_set.add(k)
        return docs, sorted(field_set)

    def _numeric_matrix(self, docs: List[dict],
                        fields: List[str]) -> Tuple[np.ndarray, List[str]]:
        numeric = [f for f in fields if any(
            isinstance(d.get(f), (int, float))
            and not isinstance(d.get(f), bool) for d in docs)]
        X = np.zeros((len(docs), len(numeric)), dtype=np.float32)
        for i, d in enumerate(docs):
            for j, f in enumerate(numeric):
                v = d.get(f)
                X[i, j] = float(v) if isinstance(v, (int, float)) \
                    and not isinstance(v, bool) else 0.0
        return X, numeric

    def _run_analytics(self, cfg: dict, state: dict) -> None:
        analysis = cfg["analysis"]
        kind = next(iter(analysis))
        spec = analysis[kind] or {}
        docs, fields = self._load_frame(cfg)
        if not docs:
            raise ElasticsearchError(
                "Unable to start because no documents were found in the "
                "source index")
        dest = cfg["dest"]["index"]
        results_field = (cfg.get("dest") or {}).get(
            "results_field", "ml")
        out_lines: List[dict] = []
        if kind == "outlier_detection":
            X, numeric = self._numeric_matrix(docs, fields)
            if not numeric:
                raise ElasticsearchError(
                    "No numeric fields found for outlier detection")
            # standardize so no single wide-range feature dominates
            mu = X.mean(axis=0)
            sd = X.std(axis=0) + 1e-9
            scores = _knn_outlier_scores(
                (X - mu) / sd, int(spec.get("n_neighbors") or 5),
                device=self.device)
            for d, s in zip(docs, scores):
                src_doc = {k: v for k, v in d.items() if k != "_id"}
                src_doc[results_field] = {"outlier_score": float(s)}
                out_lines.append({"index": {"_id": d["_id"]}})
                out_lines.append(src_doc)
        elif kind == "regression":
            dep = spec["dependent_variable"]
            train_mask = np.array(
                [isinstance(d.get(dep), (int, float))
                 and not isinstance(d.get(dep), bool) for d in docs])
            feat_fields = [f for f in fields if f != dep]
            X, numeric = self._numeric_matrix(docs, feat_fields)
            if not numeric or not train_mask.any():
                raise ElasticsearchError(
                    "Unable to train: no numeric features or no labeled "
                    "rows")
            y = np.array([float(d.get(dep) or 0.0) for d in docs],
                         dtype=np.float32)
            pct = float(spec.get("training_percent", 100.0))
            rng = np.random.RandomState(
                int(spec.get("randomize_seed", 42)) & 0x7FFFFFFF)
            is_training = train_mask & (
                rng.uniform(size=len(docs)) * 100.0 < pct
                if pct < 100.0 else np.ones(len(docs), bool))
            if not is_training.any():
                is_training = train_mask
            Xb = np.concatenate(
                [X, np.ones((len(docs), 1), np.float32)], axis=1)
            # least-squares solve on the host (vs the reference's boosted
            # trees trained in the native process)
            w, *_ = np.linalg.lstsq(Xb[is_training], y[is_training],
                                    rcond=None)
            pred = Xb @ w
            pred_field = spec.get("prediction_field_name",
                                  f"{dep}_prediction")
            for i, d in enumerate(docs):
                src_doc = {k: v for k, v in d.items() if k != "_id"}
                src_doc[results_field] = {
                    pred_field: float(pred[i]),
                    "is_training": bool(is_training[i])}
                out_lines.append({"index": {"_id": d["_id"]}})
                out_lines.append(src_doc)
            resid = y[train_mask] - pred[train_mask]
            state["metrics"] = {
                "mse": float(np.mean(resid ** 2)),
                "r_squared": float(
                    1.0 - np.sum(resid ** 2)
                    / max(np.sum((y[train_mask]
                                  - y[train_mask].mean()) ** 2), 1e-9))}
        else:                                          # classification
            dep = spec["dependent_variable"]
            labeled = [d for d in docs if d.get(dep) is not None]
            classes = sorted({str(d[dep]) for d in labeled})
            if len(classes) < 2:
                raise ElasticsearchError(
                    "Classification requires at least 2 classes")
            cls_idx = {c: i for i, c in enumerate(classes)}
            feat_fields = [f for f in fields if f != dep]
            X, numeric = self._numeric_matrix(docs, feat_fields)
            if not numeric:
                raise ElasticsearchError(
                    "No numeric features found for classification")
            mu = X.mean(axis=0)
            sd = X.std(axis=0) + 1e-9
            Xn = (X - mu) / sd
            train_mask = np.array([d.get(dep) is not None for d in docs])
            y = np.array([cls_idx.get(str(d.get(dep)), 0) for d in docs])
            W = _train_logreg(Xn[train_mask], y[train_mask], len(classes),
                              device=self.device)
            Xb = np.concatenate(
                [Xn, np.ones((len(docs), 1), np.float32)], axis=1)
            logits = Xb @ W
            e = np.exp(logits - logits.max(axis=1, keepdims=True))
            probs = e / e.sum(axis=1, keepdims=True)
            pred_field = spec.get("prediction_field_name",
                                  f"{dep}_prediction")
            num_top = int(spec.get("num_top_classes", 2))
            for i, d in enumerate(docs):
                src_doc = {k: v for k, v in d.items() if k != "_id"}
                order = np.argsort(-probs[i])
                top = [{"class_name": classes[c],
                        "class_probability": float(probs[i, c])}
                       for c in order[:num_top]]
                src_doc[results_field] = {
                    pred_field: classes[int(order[0])],
                    "prediction_probability": float(probs[i, order[0]]),
                    "top_classes": top,
                    "is_training": bool(train_mask[i])}
                out_lines.append({"index": {"_id": d["_id"]}})
                out_lines.append(src_doc)
            correct = sum(
                1 for i in range(len(docs))
                if train_mask[i] and int(np.argmax(probs[i])) == y[i])
            state["metrics"] = {"accuracy":
                                correct / max(1, int(train_mask.sum()))}
        self.bulk_fn(dest, out_lines)

    # ==== calendars / filters / info ===================================
    def put_calendar(self, cal_id: str, body: Optional[dict]) -> dict:
        if cal_id in self.calendars:
            raise ResourceAlreadyExistsError(
                f"Cannot create calendar with id [{cal_id}] as it "
                f"already exists")
        cal = {"calendar_id": cal_id,
               "job_ids": (body or {}).get("job_ids") or [],
               "description": (body or {}).get("description"),
               "events": []}
        self.calendars[cal_id] = cal
        return {k: v for k, v in cal.items() if k != "events"}

    def get_calendars(self, cal_id: Optional[str]) -> dict:
        if cal_id in (None, "", "_all", "*"):
            items = [self.calendars[k] for k in sorted(self.calendars)]
        else:
            if cal_id not in self.calendars:
                raise ResourceNotFoundError(
                    f"No calendar with id [{cal_id}]")
            items = [self.calendars[cal_id]]
        return {"count": len(items), "calendars": [
            {k: v for k, v in c.items() if k != "events"}
            for c in items]}

    def delete_calendar(self, cal_id: str) -> dict:
        if cal_id not in self.calendars:
            raise ResourceNotFoundError(f"No calendar with id [{cal_id}]")
        del self.calendars[cal_id]
        return {"acknowledged": True}

    def post_calendar_events(self, cal_id: str, body: dict) -> dict:
        if cal_id not in self.calendars:
            raise ResourceNotFoundError(f"No calendar with id [{cal_id}]")
        events = body.get("events") or []
        for ev in events:
            ev.setdefault("calendar_id", cal_id)
        self.calendars[cal_id]["events"].extend(events)
        return {"events": events}

    def get_calendar_events(self, cal_id: str) -> dict:
        if cal_id not in self.calendars:
            raise ResourceNotFoundError(f"No calendar with id [{cal_id}]")
        events = self.calendars[cal_id]["events"]
        return {"count": len(events), "events": events}

    def put_filter(self, filter_id: str, body: dict) -> dict:
        if filter_id in self.filters:
            raise ResourceAlreadyExistsError(
                f"A filter with id [{filter_id}] already exists")
        f = {"filter_id": filter_id,
             "description": body.get("description", ""),
             "items": sorted(body.get("items") or [])}
        self.filters[filter_id] = f
        return f

    def get_filters(self, filter_id: Optional[str]) -> dict:
        if filter_id in (None, "", "_all", "*"):
            items = [self.filters[k] for k in sorted(self.filters)]
        else:
            if filter_id not in self.filters:
                raise ResourceNotFoundError(
                    f"No filter with id [{filter_id}]")
            items = [self.filters[filter_id]]
        return {"count": len(items), "filters": items}

    def delete_filter(self, filter_id: str) -> dict:
        if filter_id not in self.filters:
            raise ResourceNotFoundError(
                f"No filter with id [{filter_id}]")
        del self.filters[filter_id]
        return {"acknowledged": True}

    def info(self) -> dict:
        return {
            "defaults": {
                "anomaly_detectors": {
                    "model_memory_limit": "1gb",
                    "categorization_examples_limit": 4,
                    "model_snapshot_retention_days": 10,
                    "daily_model_snapshot_retention_after_days": 1},
                "datafeeds": {"scroll_size": 1000}},
            "upgrade_mode": self.upgrade_mode,
            "native_code": {"version": "8.0.0",
                            "build_hash": "tpu-native"},
            "limits": {"effective_max_model_memory_limit": "4gb",
                       "total_ml_memory": "4gb"}}

    def set_upgrade_mode(self, enabled: bool) -> dict:
        self.upgrade_mode = enabled
        return {"acknowledged": True}


# ---------------------------------------------------------------------------
# The `inference` ingest processor
# ---------------------------------------------------------------------------

#: process-global model registry the processor resolves through — mirrors
#: the ingest registry itself (see xpack/enrich.py for the same pattern)
_MODEL_REGISTRY: Dict[str, TrainedModel] = {}


def registry_bind(svc: MlService) -> None:
    """Point the ingest-visible registry at a service's models."""
    global _MODEL_REGISTRY
    _MODEL_REGISTRY = svc.models  # type: ignore[assignment]


class InferenceProcessor(Processor):
    """``inference`` ingest processor
    (``x-pack/plugin/ml/.../InferenceProcessor.java``)."""

    type_name = "inference"

    def __init__(self, body):
        super().__init__(body)
        self.model_id = _req(body, "model_id", "inference")
        self.target_field = body.get("target_field", "ml.inference")
        self.field_map = body.get("field_map") or {}
        self.inference_config = body.get("inference_config")

    def run(self, doc):
        model = _MODEL_REGISTRY.get(self.model_id)
        if model is None:
            raise ProcessorException(
                f"Could not find trained model [{self.model_id}]")
        src = doc.source
        feats = dict(src)
        for from_f, to_f in self.field_map.items():
            if from_f in src:
                feats[to_f] = src[from_f]
        result = model.infer([feats], self.inference_config)[0]
        result["model_id"] = self.model_id
        doc.set(self.target_field, result)


register_processor(InferenceProcessor)
