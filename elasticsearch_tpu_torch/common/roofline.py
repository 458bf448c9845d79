"""Roofline efficiency auditor: ROOFLINE.md's bytes-moved models as code.

ROOFLINE.md derives, per kernel family, how many bytes one serving
dispatch HAS to move (the corpus stream is the cost on a
bandwidth-bound engine — the BM25S bet, arxiv 2407.03618) and what the
machine's bandwidth ceiling makes of that. Until now the model lived
only in prose: no runtime surface ever compared a live dispatch against
it. This module closes that loop:

- :func:`model_bytes_*` — one function per kernel family (eager BM25,
  block-max pruned, exact kNN, IVF, fused hybrid), the exact formulas
  from ROOFLINE.md's bytes-moved tables. The serving paths in
  ``parallel/dist_search.py`` stamp their dispatch's concrete model
  bytes into the ``stages`` dict (they know the real run lengths /
  probed rows / surviving blocks); :func:`fallback_model_bytes` covers
  paths that don't stamp (fused runner, legacy planes) from plane
  attributes alone.

- :func:`audit` — called once per micro-batch dispatch (by
  ``search/microbatch.PlaneMicroBatcher._run_batch``, OUTSIDE the
  queue lock): achieved bandwidth = model bytes / measured device-
  execute wall, efficiency = achieved / the machine ceiling. Publishes
  ``es_dispatch_bandwidth_gbps{kernel}`` and
  ``es_dispatch_efficiency_pct{kernel}`` histograms (the efficiency
  samples carry the dispatch's trace id as an OpenMetrics exemplar, so
  a low-efficiency scrape links straight to ``GET /_trace/{id}``) and
  folds per-kernel (count, efficiency-sum) accumulators the
  ``dispatch_efficiency`` health indicator windows against
  (:func:`audit_totals` — the compile_churn windowed-watermark
  pattern).

The ceiling resolves once per process (:func:`peak_bandwidth_gbps`):
``ES_TPU_ROOFLINE_BW_GBPS`` env override, then the
``roofline.peak_bandwidth_gbps`` cluster setting, then a per-platform
default keyed by ``torch.device(...).type``: ``cuda`` is one NVIDIA H100
SXM (NVIDIA H100 80GB HBM3, 700.00 W power limit): HBM3 at 3.35 TB/s and
67 TFLOP/s f32 outside the tensor cores, NVIDIA's data sheet; ``cpu`` is a
nominal 10 GB/s DDR stream, so CPU efficiencies read low, which is fine:
the health indicator judges windowed DRIFT against the process's own
watermark, never the absolute level. A card set below its 700 W limit
runs slower under load than these peaks assume.

Everything here is O(1) per dispatch (a few float ops + two histogram
observes); estpulint treats this module like ``common/telemetry`` for
ESTP-L02 — no call into it may run while a serving lock is held.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

from .settings import CLUSTER_SETTINGS, Setting

__all__ = [
    "KERNEL_FAMILIES", "peak_bandwidth_gbps",
    "peak_stream_bandwidth_gbps", "peak_flops_gflops", "platform",
    "PLATFORM_CARD", "audit", "audit_totals",
    "model_bytes_bm25_eager", "model_bytes_bm25_dense",
    "model_bytes_bm25_pruned", "model_bytes_knn_exact",
    "model_bytes_knn_ivf", "model_bytes_agg", "model_bytes_streamed",
    "fallback_model_bytes",
    "efficiency_floor_pct", "efficiency_drift_fraction",
    "efficiency_min_dispatches",
]

#: the kernel families ROOFLINE.md carries a bytes model for — the
#: ``kernel`` label space of the dispatch bandwidth/efficiency families.
#: The ``*_streamed`` families are the warm-tier variants: the corpus
#: lives host-side and streams to device per dispatch, so their audit
#: compares against the host→device ceiling, not HBM.
KERNEL_FAMILIES = ("bm25_eager", "bm25_pruned", "knn_exact", "knn_ivf",
                   "fused", "bm25_streamed", "knn_streamed")

SETTING_PEAK_BW = CLUSTER_SETTINGS.register(
    Setting.float_setting("roofline.peak_bandwidth_gbps", 0.0,
                          scope="cluster", dynamic=True))
SETTING_STREAM_BW = CLUSTER_SETTINGS.register(
    Setting.float_setting("roofline.stream_bandwidth_gbps", 0.0,
                          scope="cluster", dynamic=True))
SETTING_EFF_FLOOR = CLUSTER_SETTINGS.register(
    Setting.float_setting("dispatch_efficiency.floor_pct", 0.0,
                          scope="cluster", dynamic=True))
SETTING_EFF_DRIFT = CLUSTER_SETTINGS.register(
    Setting.float_setting("dispatch_efficiency.drift_fraction", 0.5,
                          scope="cluster", dynamic=True))
SETTING_EFF_MIN = CLUSTER_SETTINGS.register(
    Setting.int_setting("dispatch_efficiency.min_dispatches", 8,
                        scope="cluster", dynamic=True, min_value=1))

#: the card the ``cuda`` figures below are for, as ``nvidia-smi
#: --query-gpu=name,power.limit --format=csv,noheader`` names it
PLATFORM_CARD = {"cuda": "NVIDIA H100 80GB HBM3, 700.00 W"}

#: per-platform bandwidth ceilings (GB/s) when nothing overrides:
#: cuda = the H100's HBM3 (NVIDIA's data sheet, SXM part, at 700 W);
#: cpu/other = nominal DDR
_PLATFORM_BW = {"cuda": 3350.0, "cpu": 10.0}

#: per-platform f32 peaks (GFLOP/s): cuda = the H100's 67 TFLOP/s f32
#: outside the tensor cores (data sheet, SXM part, 700 W); cpu a nominal
#: 100 GFLOP/s
_PLATFORM_FLOPS = {"cuda": 67000.0, "cpu": 100.0}

#: host→device stream ceilings (GB/s) for the warm-tier ``*_streamed``
#: kernels: a per-dispatch upload rides the host link, not HBM (cuda:
#: PCIe Gen5 x16, 64 GB/s nominal a direction; CPU "stream" is a memcpy
#: at DDR speed)
_PLATFORM_STREAM_BW = {"cuda": 64.0, "cpu": 10.0}


def _envf(name: str) -> Optional[float]:
    raw = os.environ.get(name)
    if raw is None:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


def efficiency_floor_pct() -> float:
    """Absolute efficiency floor (percent). 0 = auto: the health
    indicator drifts against its own windowed watermark instead."""
    v = _envf("ES_TPU_DISPATCH_EFF_FLOOR_PCT")
    return v if v is not None else float(SETTING_EFF_FLOOR.default)


def efficiency_drift_fraction() -> float:
    """Auto mode: a window whose mean efficiency falls below this
    fraction of the process's best windowed mean reads as drift."""
    v = _envf("ES_TPU_DISPATCH_EFF_DRIFT_FRACTION")
    return v if v is not None else float(SETTING_EFF_DRIFT.default)


def efficiency_min_dispatches() -> int:
    """Volume floor: windows with fewer audited dispatches carry no
    signal (the SLO engine's min_window_queries shape — one slow
    dispatch on an idle node is a blip, not drift)."""
    v = _envf("ES_TPU_DISPATCH_EFF_MIN")
    return int(v) if v is not None else int(SETTING_EFF_MIN.default)


_PEAK_LOCK = threading.Lock()
_PEAK: Dict[str, float] = {}


def _resolve_peak(key: str, env_name: str, table: Dict[str, float]) -> float:
    with _PEAK_LOCK:
        v = _PEAK.get(key)
    if v is not None:
        return v
    env = _envf(env_name)
    if env is not None and env > 0:
        v = env
    else:
        v = table.get(platform(), table["cpu"])
    with _PEAK_LOCK:
        _PEAK[key] = v
    return v


def platform(device=None) -> str:
    """``torch.device(device).type`` (``cuda`` or ``cpu``); with no
    device, ``cuda`` where the process has a card, else ``cpu``."""
    try:
        import torch
        if device is not None:
            return torch.device(device).type
        return torch.device(
            "cuda" if torch.cuda.is_available() else "cpu").type
    except Exception:   # noqa: BLE001 — no backend: CPU ceiling
        return "cpu"


def peak_bandwidth_gbps() -> float:
    """The machine's bandwidth ceiling, resolved once per process
    (env override > platform default; the first audit pays one
    platform probe, every later call is a dict read)."""
    return _resolve_peak("v", "ES_TPU_ROOFLINE_BW_GBPS", _PLATFORM_BW)


def peak_flops_gflops(device=None) -> float:
    """The platform's f32 peak (GFLOP/s) for ``device`` (default: the
    process's card, else the CPU)."""
    return _PLATFORM_FLOPS.get(platform(device), _PLATFORM_FLOPS["cpu"])


def peak_stream_bandwidth_gbps() -> float:
    """The host→device stream ceiling the ``*_streamed`` (warm-tier)
    kernels audit against: ``ES_TPU_ROOFLINE_STREAM_GBPS`` env override,
    then the ``roofline.stream_bandwidth_gbps`` cluster setting, then
    the platform's host-link default. Same once-per-process resolution
    as :func:`peak_bandwidth_gbps`."""
    with _PEAK_LOCK:
        v = _PEAK.get("stream")
    if v is not None:
        return v
    env = _envf("ES_TPU_ROOFLINE_STREAM_GBPS")
    if env is None or env <= 0:
        try:
            s = float(SETTING_STREAM_BW.default)
            env = s if s > 0 else None
        except Exception:   # noqa: BLE001 — settings service optional
            env = None
    if env is not None and env > 0:
        with _PEAK_LOCK:
            _PEAK["stream"] = env
        return env
    return _resolve_peak("stream", "ES_TPU_ROOFLINE_STREAM_GBPS",
                         _PLATFORM_STREAM_BW)


def _reset_peak_for_tests() -> None:
    with _PEAK_LOCK:
        _PEAK.clear()


# ---------------------------------------------------------------------------
# bytes-moved models (ROOFLINE.md formulas, per dispatch)
# ---------------------------------------------------------------------------

def model_bytes_bm25_eager(B: int, postings: int, n_docs: int) -> int:
    """Eager CSR scan (ROOFLINE block-max table, 'eager' column): every
    touched posting reads docs i32 + impacts f32 (8 B), and each query
    writes + top-k-reads an N-wide f32 score array (8 B/doc)."""
    return int(postings) * 8 + int(B) * int(n_docs) * 8


def model_bytes_bm25_dense(B_pad: int, Q: int, L: int,
                           dense_rows: int, n_pad: int) -> int:
    """Jitted tiered dispatch (ROOFLINE per-dispatch cost model): the
    dense-tier bf16 stream (``dense_rows`` = T_pad or the U-gather
    working set) plus the sparse sorted-merge tile ``B·Q·L·8 B``."""
    return int(dense_rows) * int(n_pad) * 2 + \
        int(B_pad) * int(Q) * int(L) * 8


def model_bytes_bm25_pruned(quantized_bytes: int,
                            exact_bytes: int) -> int:
    """Block-max pruned scan: int8 surviving-block stream + bound table
    (``quantized``) plus the survivor re-score from the f32 CSR
    (``exact``) — the two terms ``record_lex`` already accounts."""
    return int(quantized_bytes) + int(exact_bytes)


def model_bytes_knn_exact(n_rows: int, dim: int,
                          l2: bool = False) -> int:
    """Exact blocked kNN: the f32 corpus streams once per batch
    (+ the ``‖v‖²`` row under l2) — ROOFLINE kNN bytes-moved model."""
    return int(n_rows) * int(dim) * 4 + (int(n_rows) * 4 if l2 else 0)


def model_bytes_knn_ivf(quantized_bytes: int, exact_bytes: int) -> int:
    """IVF: probed-union quantized scan + exact re-rank gather — the
    two terms ``record_ann`` already accounts."""
    return int(quantized_bytes) + int(exact_bytes)


def model_bytes_agg(n_pairs: int, n_pad: int, out_vals: int) -> int:
    """One aggregation stage over one segment (ROOFLINE agg-stage table):
    every touched doc-values pair streams docs i32 + value/rho payload
    (12 B), the query's doc mask is re-read per stage (1 B/slot), and the
    bucket/register output array writes back f32/i32 rows (8 B covers the
    count+sum pair of the common kernels)."""
    return int(n_pairs) * 12 + int(n_pad) + int(out_vals) * 8


def model_bytes_streamed(stream_bytes: int, B: int, k: int) -> int:
    """Warm-tier streamed dispatch (ROOFLINE streamed-tier table): the
    host→device corpus stream dominates — every dispatch re-uploads the
    plane's host-resident tiers (``stream_bytes``), and the top-k
    result read-back is noise (``B·k·8 B``). Compute over the streamed
    bytes is hidden behind the transfer on every realistic link, so the
    model IS the transfer."""
    return int(stream_bytes) + int(B) * int(k) * 8


def fallback_model_bytes(kernel: str, plane, B: int, k: int) -> int:
    """Model bytes from plane attributes alone, for dispatch paths that
    do not stamp ``stages['model_bytes']`` (the fused runner, legacy/
    foreign planes). Deliberately coarse — the per-family stamps in
    ``dist_search`` are the precise ones."""
    try:
        if kernel == "fused":
            total = 0
            tbase = getattr(plane, "_text_base", None)
            kbase = getattr(plane, "_knn_base", None)
            if callable(tbase):
                t = tbase()
                if t is not None:
                    total += model_bytes_bm25_eager(
                        B, 0, int(getattr(t, "n_docs_total", 0)))
            if callable(kbase):
                kb = kbase()
                if kb is not None:
                    total += model_bytes_knn_exact(
                        int(getattr(kb, "n_docs_total", 0)),
                        int(getattr(kb, "dim", 0)))
            return total
        if kernel in ("knn_exact", "knn_ivf"):
            return model_bytes_knn_exact(
                int(getattr(plane, "n_docs_total", 0)),
                int(getattr(plane, "dim", 0)))
        n_docs = getattr(plane, "base_docs", None)
        if n_docs is None:
            n_docs = getattr(plane, "n_docs_total", 0)
        return model_bytes_bm25_eager(B, 0, int(n_docs))
    except Exception:   # noqa: BLE001 — an audit input must never fail
        return 0        # the dispatch it audits


# ---------------------------------------------------------------------------
# the audit
# ---------------------------------------------------------------------------

#: per-kernel (audited dispatches, efficiency-pct sum) — monotone
#: process-cumulative accumulators the ``dispatch_efficiency`` health
#: indicator windows against (watermarks live on the evaluating api,
#: the compile_churn pattern)
_TOTALS_LOCK = threading.Lock()
_TOTALS: Dict[str, list] = {}
#: registry -> {kernel: (bandwidth hist, efficiency hist)} memo — the
#: registry's get-or-create pays a name sanitize + label sort per
#: call; the audit runs per dispatch, so resolve each pair once.
#: Weak-keyed: a test registry's memo dies with it (an id()-keyed memo
#: could hand a NEW registry a dead registry's histograms)
import weakref
_HISTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def audit_totals() -> Dict[str, Tuple[int, float]]:
    """``{kernel: (n_dispatches, efficiency_pct_sum)}`` so far — both
    monotone, so windowed means are delta-sums over delta-counts."""
    with _TOTALS_LOCK:
        return {k: (int(v[0]), float(v[1])) for k, v in _TOTALS.items()}


def audit(kernel: str, model_bytes: int, device_ms: float,
          exemplar: Optional[str] = None, registry=None) -> dict:
    """Audit ONE dispatch against the roofline: achieved GB/s from the
    model's bytes over the measured device-execute wall, efficiency vs
    the machine ceiling. O(1); returns the audit doc the dispatch
    profiler embeds in its record. A dispatch with no model bytes or no
    measurable wall contributes nothing (returns None)."""
    if not model_bytes or device_ms <= 0:
        return None
    if registry is None:
        from . import telemetry as _tm
        registry = _tm.DEFAULT
    gbps = (float(model_bytes) / 1e9) / (float(device_ms) / 1e3)
    # warm-tier kernels stream the corpus host→device per dispatch:
    # their honest ceiling is the host link, not HBM bandwidth
    peak = (peak_stream_bandwidth_gbps()
            if str(kernel).endswith("_streamed")
            else peak_bandwidth_gbps())
    eff = 100.0 * gbps / max(peak, 1e-9)
    with _TOTALS_LOCK:
        per_reg = _HISTS.get(registry)
        hists = per_reg.get(str(kernel)) if per_reg is not None else None
    if hists is None:
        lbl = {"kernel": str(kernel)}
        hists = (
            registry.histogram(
                "es_dispatch_bandwidth_gbps", lbl,
                help="achieved bandwidth per dispatch: ROOFLINE model "
                     "bytes / measured device-execute wall, by kernel "
                     "family"),
            registry.histogram(
                "es_dispatch_efficiency_pct", lbl,
                help="per-dispatch roofline efficiency: achieved GB/s "
                     "vs the machine bandwidth ceiling (exemplars "
                     "carry the dispatch's trace id)"))
        with _TOTALS_LOCK:
            _HISTS.setdefault(registry, {})[str(kernel)] = hists
    hists[0].observe(gbps)
    hists[1].observe(eff, exemplar=exemplar)
    with _TOTALS_LOCK:
        tot = _TOTALS.setdefault(str(kernel), [0, 0.0])
        tot[0] += 1
        tot[1] += eff
    return {"gbps": round(gbps, 6), "efficiency_pct": round(eff, 5),
            "peak_gbps": peak, "model_bytes": int(model_bytes)}
