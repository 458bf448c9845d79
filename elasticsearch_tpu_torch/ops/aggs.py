"""Masked aggregation reductions (port of ``elasticsearch_tpu/ops/aggs.py``)
and the wrappers of kernels K12–K15.

The reference collects aggregations doc-at-a-time into buckets; the device
half of its aggregators runs instead over doc-values *pairs* (one entry per
(doc, value)) and the query's dense ``bool[n_pad]`` doc mask:

- **ordinal CSR** (terms, percentiles, HLL): pairs sorted by (ordinal, doc)
  or (ordinal, value) with run boundaries ``offsets[V+1]``; the masked
  count prefix ``c = cumsum(mask[pair_docs])`` gives per-run counts as
  differences at the boundaries, and the r-th masked value of a run by a
  lower-bound search on ``c``. K12 (``csrc/agg_masked_scan.cu``) gathers
  the mask and scans; K13 (``csrc/agg_rank_pick.cu``) searches, gathers
  and interpolates (percentiles) or takes each HLL register's last masked
  rho.
- **bucket ids** (histogram, date_histogram): per-pair bucket ids reduced
  into ``n_buckets`` counts or sums by K14 (``csrc/agg_bucket_reduce.cu``).
- **metrics**: masked (count, sum, min, max) by K15 (``csrc/agg_metrics.cu``).

Pair docs are padded with the ``n_pad`` sentinel. The reference gathers
with ``jnp.take(mask, docs, mode="fill", fill_value=False)``, which wraps
an index in ``[-n_pad, 0)`` to ``index + n_pad`` and gives False for any
other index outside ``[0, n_pad)``; the kernels and the plain versions do
the same (:func:`gather_mask`).

Each kernel's plain PyTorch version sits beside its wrapper; a wrapper
runs it only for tensors that lie on the CPU and launches the kernel for
CUDA tensors. Parity with the reference, and the tolerances:

- Counts, the prefix ``c``, bucket counts, HLL registers, min and max are
  integers or selections: **bitwise** equal to the reference.
- The percentile pick interpolates ``(1 - f)·a + f·b``. XLA:CPU contracts
  one of the two products into a fused multiply-add, and which one depends
  on the output's shape and the entry's place in it (at config #3's
  [10, 3] it is ``fma(f, b, (1 - f)·a)`` everywhere; at [64, 7] the last
  column takes that form and the others ``fma(1 - f, a, f·b)``). The port
  computes ``fma(f, b, (1 - f)·a)`` (:func:`lerp_f32`) on both routes, so
  kernel and plain version agree bitwise, and each entry equals the
  reference's wherever the reference took that form; elsewhere the two
  are single roundings of the same exact value, at most 1 ulp apart.
- Every f32 **sum** here (ordinal sums, bucket sums, the metrics sum)
  accumulates in f64 in a fixed order and rounds to f32 once, in the
  kernels and in the plain versions alike: kernel and plain version agree
  within ``2^-22 · Σ|v|`` over the summed values (two f32 roundings of
  f64 sums whose own error is below ``2^-25 · Σ|v|`` for fewer than 2^28
  terms). The reference sums in f32 in XLA's order: its ordinal sums are
  differences of an f32 prefix, off by a few ulps of the *running prefix*
  (``Σ|v|`` over every masked pair up to the run's end), its bucket sums
  come from an f32 matrix product and its metrics sum from an f32
  reduction, each off by a few ulps of ``Σ|v|`` over the summed values
  times the depth of XLA's reduction. The CPU tests hold the port to the
  reference within ``8 · log2(M) · 2^-24`` times those magnitudes.
- ``masked_metrics``' count: the reference sums ones in f32, exact below
  2^24 matched pairs; the port counts in integers and converts once, so
  the two agree exactly below 2^24 and the port stays exact above it,
  where the reference's f32 sum rounds (the full-size config #3 masks
  match more than 2^24 pairs).

The per-segment caches (:func:`ordinal_csr`, :func:`hll_sketch_pairs`,
:func:`histogram_bucket_ids`) read only a segment's host arrays and keep
their tensors on ``seg._agg_torch_cache`` under a key that includes the
device, apart from the reference's own cache attribute. Doc values are
finite (Elasticsearch refuses non-finite numeric values), which the sums'
and the min/max' arithmetic assume.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import build as _kb
from ..utils.shapes import round_up_pow2
from .blockmax import fma_f32
from .bm25 import take_fill

#: below this many doc-values pairs the host numpy path wins (dispatch
#: overhead dominates); aggregations consult this before shipping to device
DEVICE_MIN_PAIRS = 1 << 16

#: bucket-reduce cap: above this bucket count the host path serves
MAX_DEVICE_BUCKETS = 4096

HLL_P = 14  #: register precision: m = 2^p registers, ~1.04/sqrt(m) error

_KERNEL_MODES = {"counts": 0, "prefix": 1, "sums": 2}


def gather_mask(mask: torch.Tensor, pair_docs: torch.Tensor) -> torch.Tensor:
    """``mask[pair_docs]`` with the reference's fill rule: an index in
    ``[-n, 0)`` wraps, any other index outside ``[0, n)`` gives False."""
    return take_fill(mask, pair_docs.long(), False)


# ---------------------------------------------------------------------------
# K12: the masked scan (ordinal counts, the count prefix, ordinal sums)
# ---------------------------------------------------------------------------


#: K12's sizes, as ``csrc/agg_masked_scan.cu`` defines them: pair words
#: a tile of its bit passes, pairs a chunk of its sums mode
K12_TILE_WORDS = 256
K12_CHUNK = 65536


def _align16(b: int) -> int:
    return -(-b // 16) * 16


def masked_scan_workspace_bytes(Vp: int, Mp: int, n_pad: int,
                                mode: str) -> int:
    """K12's workspace, in the order ``es_agg_masked_scan`` lays it out
    (the entry refuses fewer bytes than its sections take): the mask
    packed one bit a doc, then the counts and prefix modes' pair bits, tile
    sums and word prefix, or the sums mode's run chunk table and f64 chunk
    partials."""
    mask = _align16(4 * -(-n_pad // 32))
    if mode == "sums":
        return mask + _align16(4 * (Vp + 1)) + 8 * (Mp // K12_CHUNK + Vp)
    n_words = -(-Mp // 32)
    n_tiles = -(-n_words // K12_TILE_WORDS)
    return mask + _align16(4 * n_words) + _align16(4 * (n_tiles + 1)) \
        + _align16(4 * (n_words + 1))


def masked_scan_plain(offsets, pair_docs, mask, pair_vals=None, *,
                      mode: str):
    """Plain version of K12 (see :func:`masked_scan`)."""
    m = gather_mask(mask, pair_docs)
    lo, hi = offsets[:-1].long(), offsets[1:].long()
    if mode == "sums":
        mv = torch.where(m, pair_vals.double(), 0.0)
        pos = torch.arange(m.shape[0], device=m.device, dtype=torch.int64)
        run = torch.searchsorted(offsets.long(), pos, right=True) - 1
        inside = (pos >= offsets[0]) & (pos < offsets[-1])
        run = torch.where(inside, run, lo.shape[0])
        sums = torch.zeros(lo.shape[0] + 1, dtype=torch.float64,
                           device=m.device).index_add_(0, run, mv)
        return sums[:-1].float()
    c = torch.zeros(m.shape[0] + 1, dtype=torch.int32, device=m.device)
    c[1:] = torch.cumsum(m, 0, dtype=torch.int32)
    counts = c[hi] - c[lo]
    return (counts, c) if mode == "prefix" else counts


def masked_scan(offsets, pair_docs, mask, pair_vals=None, *, mode: str):
    """Masked per-run reductions over an ordinal-CSR pair layout (K12).

    offsets i32[Vp+1]: run boundaries, non-decreasing, within [0, Mp]
    (padded runs repeat the last value); pair_docs i32[Mp]: each pair's
    doc; mask bool[n_pad]; pair_vals f32[Mp] (``mode="sums"`` only).

    ``mode``: ``"counts"`` → i32[Vp] masked pairs a run; ``"prefix"`` →
    (counts, c i32[Mp+1]) with ``c[i]`` the masked pairs before pair i;
    ``"sums"`` → f32[Vp] masked value sums a run (f64 in a fixed order,
    one rounding).

    A CPU tensor runs the plain version; a CUDA tensor launches K12.
    """
    if mode not in _KERNEL_MODES:
        raise ValueError(f"masked_scan: unknown mode [{mode}]")
    if (pair_vals is None) != (mode != "sums"):
        raise ValueError("masked_scan: pair_vals goes with mode='sums' only")
    dev = _kb.wrapper_device("masked_scan", offsets)
    if dev.type == "cpu":
        return masked_scan_plain(offsets, pair_docs, mask, pair_vals,
                                 mode=mode)
    Vp, Mp, n_pad = offsets.shape[0] - 1, pair_docs.shape[0], mask.shape[0]
    _kb.check(offsets, "offsets", torch.int32, (Vp + 1,), dev)
    _kb.check(pair_docs, "pair_docs", torch.int32, (Mp,), dev)
    _kb.check(mask, "mask", torch.bool, (n_pad,), dev)
    if pair_vals is not None:
        _kb.check(pair_vals, "pair_vals", torch.float32, (Mp,), dev)
    if Vp < 0:
        raise ValueError("masked_scan: offsets needs at least one entry")
    code = _KERNEL_MODES[mode]
    counts = sums = c = None
    if mode == "sums":
        sums = torch.empty(Vp, dtype=torch.float32, device=dev)
    else:
        counts = torch.empty(Vp, dtype=torch.int32, device=dev)
        if mode == "prefix":
            c = torch.empty(Mp + 1, dtype=torch.int32, device=dev)
    ws_bytes = masked_scan_workspace_bytes(Vp, Mp, n_pad, mode)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev) \
        if ws_bytes else None
    _kb.launch("agg_masked_scan", dev, offsets.data_ptr(), Vp,
               pair_docs.data_ptr(),
               None if pair_vals is None else pair_vals.data_ptr(), Mp,
               mask.data_ptr(), n_pad, code,
               None if counts is None else counts.data_ptr(),
               None if c is None else c.data_ptr(),
               None if sums is None else sums.data_ptr(),
               None if ws is None else ws.data_ptr(), ws_bytes)
    if mode == "sums":
        return sums
    return (counts, c) if mode == "prefix" else counts


def masked_ordinal_counts(offsets, pair_docs, mask):
    """Exact per-ordinal masked pair counts, i32[Vp] (pairs sorted by
    (ordinal, doc), ``n_pad``-padded; padded ordinals are empty runs)."""
    return masked_scan(offsets, pair_docs, mask, mode="counts")


def masked_ordinal_sums(offsets, pair_docs, pair_vals, mask):
    """Per-ordinal masked f32 value sums, f32[Vp] (same layout as
    :func:`masked_ordinal_counts`; see the module's tolerances)."""
    return masked_scan(offsets, pair_docs, mask, pair_vals, mode="sums")


def masked_rank_prefix(offsets, pair_docs, mask):
    """Masked-count prefix over a (ordinal, value)-sorted pair layout, the
    exact-percentile primitive: returns (counts i32[Vp], prefix
    i32[Mp+1]); the prefix stays on the device for :func:`_rank_pick`."""
    return masked_scan(offsets, pair_docs, mask, mode="prefix")


# ---------------------------------------------------------------------------
# K13: rank pick (percentiles) and the HLL register max
# ---------------------------------------------------------------------------


def lerp_f32(a, b, frac):
    """``(1 - frac)·a + frac·b`` as XLA:CPU compiles the reference's lerp
    at config #3's shape: ``fma(frac, b, (1 - frac)·a)``, one rounding of
    the product ``(1 - frac)·a`` and one of the fused multiply-add."""
    return fma_f32(frac, b, (1.0 - frac) * a)


def _lower_bound_minus_one(c, targets, size: int):
    idx = torch.searchsorted(c, targets, side="left") - 1
    return idx.clamp(0, size - 1)


def rank_pick_plain(c, offsets, pair_vals, ordinals, lo, hi, frac):
    """Plain version of K13's pick (see :func:`rank_pick`)."""
    M = pair_vals.shape[0]
    o = ordinals.long().clamp(0, offsets.shape[0] - 1)
    base = c[offsets[o].long()]

    def pick(rank):
        tgt = (base[:, None] + rank + 1).to(torch.int32).contiguous()
        return pair_vals[_lower_bound_minus_one(c, tgt, M)]

    return lerp_f32(pick(lo), pick(hi), frac)


def register_max_plain(c, offsets, pair_rhos):
    """Plain version of K13's register mode (see :func:`register_max`)."""
    st = c[offsets[:-1].long()]
    cnt = c[offsets[1:].long()] - st
    idx = _lower_bound_minus_one(c, (st + cnt).contiguous(),
                                 pair_rhos.shape[0])
    return torch.where(cnt > 0, pair_rhos[idx], 0).to(torch.int32)


def _k13_checks(c, offsets, vals, vals_dtype, dev):
    n_c, V1, M = c.shape[0], offsets.shape[0], vals.shape[0]
    _kb.check(c, "c", torch.int32, (n_c,), dev)
    _kb.check(offsets, "offsets", torch.int32, (V1,), dev)
    _kb.check(vals, "pair_vals", vals_dtype, (M,), dev)
    if n_c < 1 or V1 < 1:
        raise ValueError("rank_pick: c and offsets need an entry each")
    return n_c, V1, M


def rank_pick(c, offsets, pair_vals, ordinals, lo, hi, frac):
    """The r-th masked values of chosen runs, interpolated (K13; the
    reference's ``_rank_pick``).

    c i32[Mp+1]: the masked-count prefix of :func:`masked_rank_prefix`;
    offsets i32[Vp+1]; pair_vals f32[M] in (ordinal, value) order;
    ordinals i32[B]; lo, hi i32[B, R] masked ranks within each run; frac
    f32[B, R]. Each rank is found by a lower-bound search of
    ``c[offsets[ordinal]] + rank + 1`` in ``c`` (index − 1, clipped to
    [0, M)). Returns f32[B, R] ``lerp_f32(value(lo), value(hi), frac)``.

    A CPU tensor runs the plain version; a CUDA tensor launches K13.
    """
    dev = _kb.wrapper_device("rank_pick", c)
    if dev.type == "cpu":
        return rank_pick_plain(c, offsets, pair_vals, ordinals, lo, hi, frac)
    n_c, V1, M = _k13_checks(c, offsets, pair_vals, torch.float32, dev)
    B, R = lo.shape
    _kb.check(ordinals, "ordinals", torch.int32, (B,), dev)
    _kb.check(lo, "lo", torch.int32, (B, R), dev)
    _kb.check(hi, "hi", torch.int32, (B, R), dev)
    _kb.check(frac, "frac", torch.float32, (B, R), dev)
    if M < 1:
        raise ValueError("rank_pick: pair_vals is empty")
    out = torch.empty((B, R), dtype=torch.float32, device=dev)
    if B * R == 0:
        return out
    _kb.launch("agg_rank_pick", dev, c.data_ptr(), n_c, offsets.data_ptr(),
               V1 - 1, pair_vals.data_ptr(), M, ordinals.data_ptr(),
               lo.data_ptr(), hi.data_ptr(), frac.data_ptr(), B, R, 0,
               out.data_ptr())
    return out


def register_max(c, offsets, pair_rhos):
    """Each run's last masked rho, 0 for a run with no masked pair (K13's
    register mode). c i32[Mp+1]; offsets i32[V+1]; pair_rhos i32[M] sorted
    ascending within each run. Returns i32[V].

    A CPU tensor runs the plain version; a CUDA tensor launches K13.
    """
    dev = _kb.wrapper_device("register_max", c)
    if dev.type == "cpu":
        return register_max_plain(c, offsets, pair_rhos)
    n_c, V1, M = _k13_checks(c, offsets, pair_rhos, torch.int32, dev)
    if M < 1:
        raise ValueError("register_max: pair_rhos is empty")
    out = torch.empty(V1 - 1, dtype=torch.int32, device=dev)
    if V1 == 1:
        return out
    _kb.launch("agg_rank_pick", dev, c.data_ptr(), n_c, offsets.data_ptr(),
               V1 - 1, pair_rhos.data_ptr(), M, None, None, None, None, 0, 0,
               1, out.data_ptr())
    return out


def masked_register_max(offsets, pair_docs, pair_rhos, mask):
    """Masked per-register rho max over (register, rho)-sorted pairs:
    K12's prefix, then K13's register mode. Returns i32[len(offsets)-1]
    (0 where nothing matched); a merge of two is an elementwise max."""
    _counts, c = masked_rank_prefix(offsets, pair_docs, mask)
    return register_max(c, offsets, pair_rhos)


def hazen_ranks(n: np.ndarray, qs) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    """Hazen positions ``q·n − ½`` clamped to [0, n−1] (f64) as the
    adjacent ranks lo, hi (i32[B, R]) and frac (f32[B, R])."""
    qs = np.asarray(qs, np.float64)
    n = np.asarray(n, np.float64)
    pos = np.clip(qs[None, :] / 100.0 * n[:, None] - 0.5, 0.0,
                  np.maximum(n[:, None] - 1.0, 0.0))
    lo = np.floor(pos).astype(np.int32)
    hi = np.minimum(lo + 1, np.maximum(n[:, None].astype(np.int32) - 1, 0))
    return lo, hi, (pos - lo).astype(np.float32)


def masked_ordinal_percentiles(offsets, pair_docs, pair_vals_sorted, mask,
                               ordinals, qs):
    """Exact masked percentiles per ordinal (Hazen interpolation): f64[B, R],
    NaN for empty buckets. ``ordinals`` int[B] selects the runs; ``qs``
    float[R] in [0, 100]. Only the counts and the [B, R] result cross to
    the host."""
    counts, c = masked_rank_prefix(offsets, pair_docs, mask)
    return prefix_percentiles(counts, c, offsets, pair_vals_sorted,
                              ordinals, qs)


def prefix_percentiles(counts, c, offsets, pair_vals_sorted, ordinals, qs):
    """:func:`masked_ordinal_percentiles` from the (counts, c) that
    :func:`masked_rank_prefix` already gave for the mask: K13 only."""
    counts_h = counts.cpu().numpy()
    ordinals = np.asarray(ordinals, np.int64)
    n = counts_h[ordinals].astype(np.float64)
    lo, hi, frac = hazen_ranks(n, qs)
    dev = c.device
    picked = rank_pick(c, offsets, pair_vals_sorted,
                       torch.from_numpy(ordinals.astype(np.int32)).to(dev),
                       torch.from_numpy(lo).to(dev),
                       torch.from_numpy(hi).to(dev),
                       torch.from_numpy(frac).to(dev))
    out = picked.cpu().numpy().astype(np.float64)
    out[n == 0] = np.nan
    return out


def top_ordinals(counts, k: int):
    """(counts desc, ordinal asc) top-k of a counts vector, as numpy
    (values, ordinals); ties go to the lower ordinal (a stable sort, not
    ``torch.topk``, whose tie order is unspecified)."""
    kk = min(k, counts.shape[0])
    vals, ords = torch.sort(counts, descending=True, stable=True)
    return (vals[:kk].cpu().numpy(),
            ords[:kk].to(torch.int32).cpu().numpy())


# ---------------------------------------------------------------------------
# K14: bucket counts and sums
# ---------------------------------------------------------------------------


def bucket_reduce_plain(bucket_ids, pair_docs, mask, pair_vals=None, *,
                        n_buckets: int):
    """Plain version of K14 (see :func:`bucket_reduce`)."""
    m = gather_mask(mask, pair_docs)
    ok = m & (bucket_ids >= 0) & (bucket_ids < n_buckets)
    ids = torch.where(ok, bucket_ids.long(), n_buckets)
    if pair_vals is None:
        return torch.bincount(ids, minlength=n_buckets + 1)[:n_buckets] \
            .to(torch.int32)
    mv = torch.where(ok, pair_vals.double(), 0.0)
    return torch.zeros(n_buckets + 1, dtype=torch.float64,
                       device=m.device).index_add_(0, ids, mv)[:-1].float()


def bucket_reduce(bucket_ids, pair_docs, mask, pair_vals=None, *,
                  n_buckets: int):
    """Masked per-bucket pair counts (i32[n_buckets]) or, given
    ``pair_vals`` f32[Mp], value sums (f32[n_buckets], f64 in a fixed
    order, one rounding) (K14). bucket_ids i32[Mp]: ids outside
    [0, n_buckets) count nothing; ``n_buckets`` ≤ ``MAX_DEVICE_BUCKETS``.

    A CPU tensor runs the plain version; a CUDA tensor launches K14.
    """
    if not 0 < n_buckets <= MAX_DEVICE_BUCKETS:
        raise ValueError(f"bucket_reduce: n_buckets={n_buckets} outside "
                         f"(0, {MAX_DEVICE_BUCKETS}]")
    dev = _kb.wrapper_device("bucket_reduce", bucket_ids)
    if dev.type == "cpu":
        return bucket_reduce_plain(bucket_ids, pair_docs, mask, pair_vals,
                                   n_buckets=n_buckets)
    Mp, n_pad = bucket_ids.shape[0], mask.shape[0]
    _kb.check(bucket_ids, "bucket_ids", torch.int32, (Mp,), dev)
    _kb.check(pair_docs, "pair_docs", torch.int32, (Mp,), dev)
    _kb.check(mask, "mask", torch.bool, (n_pad,), dev)
    sums = pair_vals is not None
    if sums:
        _kb.check(pair_vals, "pair_vals", torch.float32, (Mp,), dev)
    out = torch.empty(n_buckets, dtype=torch.float32 if sums else torch.int32,
                      device=dev)
    ws_bytes = _kb.query("agg_bucket_reduce",
                         "es_agg_bucket_reduce_workspace_bytes", Mp,
                         n_buckets, int(sums))
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev) \
        if ws_bytes else None
    _kb.launch("agg_bucket_reduce", dev, bucket_ids.data_ptr(),
               pair_docs.data_ptr(), pair_vals.data_ptr() if sums else None,
               Mp, mask.data_ptr(), n_pad, n_buckets, int(sums),
               out.data_ptr(), None if ws is None else ws.data_ptr())
    return out


def masked_bucket_counts(bucket_ids, pair_docs, mask, *, n_buckets: int):
    """Low-cardinality masked bucket counts, i32[n_buckets] (bucket ids
    computed on the host in exact f64 and cached per (field, interval))."""
    return bucket_reduce(bucket_ids, pair_docs, mask, n_buckets=n_buckets)


def masked_bucket_sums(bucket_ids, pair_docs, pair_vals, mask, *,
                       n_buckets: int):
    """Masked f32 value sums per bucket, f32[n_buckets]."""
    return bucket_reduce(bucket_ids, pair_docs, mask, pair_vals,
                         n_buckets=n_buckets)


# ---------------------------------------------------------------------------
# K15: masked metrics
# ---------------------------------------------------------------------------


def metrics_plain(pair_docs, pair_vals, mask):
    """Plain version of K15 (see :func:`masked_metrics`), as f32[4]."""
    m = gather_mask(mask, pair_docs)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=m.device)
    out = torch.stack([
        m.sum().float(),
        torch.where(m, pair_vals.double(), 0.0).sum().float(),
        torch.where(m, pair_vals, inf).amin() if m.numel() else inf,
        torch.where(m, pair_vals, -inf).amax() if m.numel() else -inf])
    return out


def masked_metrics(pair_docs, pair_vals, mask):
    """One-pass masked (count, sum, min, max) over a pair column as four
    f32 scalars (K15): the count counted in integers and converted once,
    the sum in f64 in a fixed order and rounded once, min/max +inf/−inf
    when nothing matches.

    A CPU tensor runs the plain version; a CUDA tensor launches K15.
    """
    dev = _kb.wrapper_device("masked_metrics", pair_docs)
    if dev.type == "cpu":
        return tuple(metrics_plain(pair_docs, pair_vals, mask))
    Mp, n_pad = pair_docs.shape[0], mask.shape[0]
    _kb.check(pair_docs, "pair_docs", torch.int32, (Mp,), dev)
    _kb.check(pair_vals, "pair_vals", torch.float32, (Mp,), dev)
    _kb.check(mask, "mask", torch.bool, (n_pad,), dev)
    out = torch.empty(4, dtype=torch.float32, device=dev)
    ws_bytes = _kb.query("agg_metrics", "es_agg_metrics_workspace_bytes", Mp)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev)
    _kb.launch("agg_metrics", dev, pair_docs.data_ptr(), pair_vals.data_ptr(),
               Mp, mask.data_ptr(), n_pad, out.data_ptr(), ws.data_ptr())
    return tuple(out)


# ---------------------------------------------------------------------------
# host hashing and the HLL sketch (copies of the reference's numpy code)
# ---------------------------------------------------------------------------

_U64 = np.uint64
_MIX_1 = _U64(0xFF51AFD7ED558CCD)
_MIX_2 = _U64(0xC4CEB9FE1A85EC53)


def _pad_pow2(arr: np.ndarray, fill) -> np.ndarray:
    size = round_up_pow2(max(arr.shape[0], 1))
    if arr.shape[0] == size:
        return arr
    out = np.full(size, fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _mix64_u64(z: np.ndarray) -> np.ndarray:
    """Stafford mix13 finalizer over uint64 (vectorized, wrap-around)."""
    with np.errstate(over="ignore"):
        z = (z ^ (z >> _U64(33))) * _MIX_1
        z = (z ^ (z >> _U64(33))) * _MIX_2
        return z ^ (z >> _U64(33))


def _clz64(x: np.ndarray) -> np.ndarray:
    """Leading-zero count of uint64 (vectorized; returns 63 for 0 —
    callers special-case zero words)."""
    x = x.astype(np.uint64, copy=True)
    n = np.zeros(x.shape, np.int32)
    for s in (32, 16, 8, 4, 2, 1):
        small = x < (_U64(1) << _U64(64 - s))
        n[small] += s
        with np.errstate(over="ignore"):
            x[small] = x[small] << _U64(s)
    return n


def _fnv64_bytes(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def value_hash_u64(value):
    """Deterministic 64-bit hash of a doc value: str via mix13-finalized
    FNV-1a, numeric via mix13 of the f64 bit pattern (the scalar twin of
    the pair-cache hashing)."""
    if isinstance(value, str):
        bits = np.array(_fnv64_bytes(value.encode("utf-8")), np.uint64)
    else:
        bits = np.array(float(value), np.float64).view(np.uint64)
    return int(_mix64_u64(bits.reshape(1))[0])


def _hll_reg_rho(h: np.ndarray, p: int):
    """Split hashes into (register id, rho): the top ``p`` bits pick the
    register, rho = leading-zero count of the remaining bits + 1
    (``64 - p + 1`` when they are all zero)."""
    reg = (h >> _U64(64 - p)).astype(np.int32)
    with np.errstate(over="ignore"):
        w = h << _U64(p)
    rho = np.where(w == 0, np.int32(64 - p + 1),
                   _clz64(w) + 1).astype(np.int32)
    return reg, rho


def host_register_max(pairs: dict, mask: np.ndarray) -> np.ndarray:
    """Host numpy twin of :func:`masked_register_max` over the same cached
    pairs (integer max is order-independent: bitwise equal)."""
    regs = np.zeros(pairs["m"], np.int32)
    pm = mask[pairs["docs"]]
    np.maximum.at(regs, pairs["reg"][pm], pairs["rho"][pm])
    return regs


def hll_merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sketch merge = elementwise register maximum."""
    return np.maximum(a, b)


def hll_add_values(regs: np.ndarray, values, p: int) -> np.ndarray:
    """Fold raw values (an exact-set partial) into a register array."""
    for v in values:
        h = value_hash_u64(v)
        reg = h >> (64 - p)
        w = (h << p) & 0xFFFFFFFFFFFFFFFF
        rho = (64 - p + 1) if w == 0 else (64 - w.bit_length()) + 1
        if rho > regs[reg]:
            regs[reg] = rho
    return regs


def hll_estimate(regs: np.ndarray) -> int:
    """Deterministic HLL estimate with linear-counting small-range
    correction (the classic bias-corrected form)."""
    regs = np.asarray(regs, np.int64)
    m = regs.size
    alpha = 0.7213 / (1.0 + 1.079 / m)
    est = alpha * m * m / float(np.sum(np.exp2(-regs.astype(np.float64))))
    if est <= 2.5 * m:
        zeros = int(np.count_nonzero(regs == 0))
        if zeros:
            est = m * float(np.log(m / zeros))
    return int(est + 0.5)


# ---------------------------------------------------------------------------
# per-segment caches (ordinal CSR, HLL pairs, histogram bucket ids)
# ---------------------------------------------------------------------------


def _seg_cache(seg) -> dict:
    # the port's own attribute: a segment handed to the reference as well
    # keeps the reference's arrays on ``_agg_dev_cache``
    c = getattr(seg, "_agg_torch_cache", None)
    if c is None:
        c = seg._agg_torch_cache = {}
    return c


def _to(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def device_mask(seg, mask: np.ndarray, device=None) -> torch.Tensor:
    """Upload a host doc mask padded to the segment's ``n_pad`` (pair-doc
    sentinels gather False)."""
    dev = resolve_device(device)
    if mask.shape[0] == seg.n_pad:
        return _to(mask.astype(bool, copy=False), dev)
    padded = np.zeros(seg.n_pad, bool)
    padded[: mask.shape[0]] = mask
    return _to(padded, dev)


def ordinal_csr(seg, field: str, device=None):
    """Lazy per-(segment, field, device) ordinal CSR of keyword doc values:
    pairs sorted by (ordinal, doc), padded. Returns (offsets i32[Vp+1],
    pair_docs i32[Mp], V)."""
    dev = resolve_device(device)
    cache = _seg_cache(seg)
    key = ("ord_csr", field, str(dev))
    hit = cache.get(key)
    if hit is not None:
        return hit
    f = seg.keyword_fields[field]
    # the reference's np.lexsort((docs, ords)) as one sort of packed int64
    # keys (ordinal high, doc low): pairs that tie are equal, so the order
    # among them cannot show, and the arrays are the same bytes
    packed = (f.dv_ords_host.astype(np.int64) << 32) | \
        f.dv_docs_host.astype(np.int64)
    packed.sort()
    sdocs = (packed & 0xFFFFFFFF).astype(f.dv_docs_host.dtype)
    sords = (packed >> 32).astype(f.dv_ords_host.dtype)
    v = len(f.ord_terms)
    offsets = np.zeros(v + 1, np.int32)
    np.cumsum(np.bincount(sords, minlength=v).astype(np.int32),
              out=offsets[1:])
    off_pad = _pad_pow2(offsets, offsets[-1])
    docs_pad = _pad_pow2(sdocs, seg.n_pad)
    hit = (_to(off_pad, dev), _to(docs_pad, dev), v)
    cache[key] = hit
    return hit


def hll_sketch_pairs(seg, field: str, p: int = HLL_P, device=None):
    """Lazy per-(segment, field, p, device) hashed doc-values pairs for the
    HLL++ cardinality sketch, sorted by (register, rho). Returns a dict of
    tensors (``off_dev``, ``docs_dev``, ``rhos_dev``), their host twins
    (``reg``, ``rho``, ``docs``), ``m`` and ``n_pairs``."""
    if p > 22:     # the packed sort key below holds 22 register bits
        raise ValueError(f"HLL precision {p} above 22")
    dev = resolve_device(device)
    cache = _seg_cache(seg)
    key = ("hll", field, p, str(dev))
    hit = cache.get(key)
    if hit is not None:
        return hit
    if field in getattr(seg, "keyword_fields", {}):
        f = seg.keyword_fields[field]
        term_h = _mix64_u64(np.fromiter(
            (_fnv64_bytes(str(t).encode("utf-8")) for t in f.ord_terms),
            np.uint64, count=len(f.ord_terms)))
        h = term_h[f.dv_ords_host]
        docs = f.dv_docs_host
    else:
        f = seg.numeric_fields[field]
        h = _mix64_u64(f.vals_host.astype(np.float64).view(np.uint64))
        docs = f.docs_host
    reg, rho = _hll_reg_rho(h, p)
    # np.lexsort((rho, reg)) as one sort of keys packing (register, rho,
    # position): unique, so the order is lexsort's stable one
    packed = (reg.astype(np.int64) << 41) | \
        (rho.astype(np.int64) << 34) | np.arange(reg.shape[0], dtype=np.int64)
    packed.sort()
    order = packed & ((1 << 34) - 1)
    reg_s, rho_s, docs_s = reg[order], rho[order], docs[order]
    m = 1 << p
    offsets = np.zeros(m + 1, np.int32)
    np.cumsum(np.bincount(reg_s, minlength=m).astype(np.int32),
              out=offsets[1:])
    hit = {
        "off_dev": _to(_pad_pow2(offsets, offsets[-1]), dev),
        "docs_dev": _to(_pad_pow2(docs_s.astype(np.int32),
                                  np.int32(seg.n_pad)), dev),
        "rhos_dev": _to(_pad_pow2(rho_s, np.int32(0)), dev),
        "reg": reg_s, "rho": rho_s, "docs": docs_s.astype(np.int32),
        "m": m, "n_pairs": int(docs_s.shape[0]),
    }
    cache[key] = hit
    return hit


def distinct_count(seg, field: str) -> int:
    """Cached per-(segment, field) distinct value count (the regime trigger
    for exact-set vs HLL cardinality)."""
    cache = _seg_cache(seg)
    key = ("distinct", field)
    hit = cache.get(key)
    if hit is None:
        if field in getattr(seg, "keyword_fields", {}):
            hit = len(seg.keyword_fields[field].ord_terms)
        else:
            hit = int(np.unique(seg.numeric_fields[field].vals_host).size)
        cache[key] = hit
    return hit


def histogram_bucket_ids(seg, field: str, interval: float, offset: float,
                         device=None):
    """Lazy per-(segment, field, interval, offset, device) bucket ids of a
    numeric histogram, computed on the host in exact f64 once. Returns
    (ids i32[Mp], pair_docs i32[Mp], n_buckets, base); (None, None,
    n_buckets, base) past ``MAX_DEVICE_BUCKETS`` (the host path serves)."""
    dev = resolve_device(device)
    cache = _seg_cache(seg)
    key = ("hist", field, interval, offset, str(dev))
    hit = cache.get(key)
    if hit is not None:
        return hit
    f = seg.numeric_fields[field]
    keys = np.floor((f.vals_host - offset) / interval)
    base = float(keys.min()) if keys.size else 0.0
    # the span in exact f64 before any int32 cast, so a wide range reports
    # its true n_buckets instead of wrapping
    span = float(keys.max() - base) if keys.size else -1.0
    n_buckets = int(span) + 1 if keys.size else 0
    if n_buckets > MAX_DEVICE_BUCKETS:
        hit = (None, None, n_buckets, base)
        cache[key] = hit
        return hit
    ids = (keys - base).astype(np.int32)
    ids_pad = _pad_pow2(ids, np.int32(-1))
    docs_pad = _pad_pow2(f.docs_host, seg.n_pad)
    hit = (_to(ids_pad, dev), _to(docs_pad, dev), n_buckets, base)
    cache[key] = hit
    return hit
