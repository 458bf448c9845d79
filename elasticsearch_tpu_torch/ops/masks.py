"""Match-mask kernels: postings runs and (value, doc) pair columns → dense
per-doc arrays (port of ``elasticsearch_tpu/ops/masks.py``).

Used by filter-context queries (term/terms/prefix/range as filters) where
no BM25 score is needed, only set membership:

- :func:`postings_match` is kernel K17 (``csrc/postings_match.cu``): per
  doc, how many of the Q postings runs hold it (i32), in one launch;
- :func:`range_mask` is kernel K18 (``csrc/range_mask.cu``): per doc,
  whether any of its pairs' values lies in [lo, hi] (bool), over i32 ranks
  or f32 values.

Each has its plain PyTorch version beside it, which serves CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import build as _kb
from .bm25 import _host, scatter_index, small, take_fill


def postings_match_plain(postings_docs, starts, lengths, *, segment_pad: int,
                         L: int):
    """Plain version of K17 (see :func:`postings_match`)."""
    dev = postings_docs.device
    starts = small(starts, torch.int64, dev)
    lengths = small(lengths, torch.int64, dev)
    pos = torch.arange(L, device=dev)[None, :]
    valid = pos < lengths[:, None]
    idx = torch.where(valid, starts[:, None] + pos,
                      postings_docs.shape[0])
    docs = take_fill(postings_docs, idx, segment_pad)
    d, ok = scatter_index(docs[valid], segment_pad)
    matched = torch.zeros(segment_pad, dtype=torch.int32, device=dev)
    return matched.index_add_(0, d[ok], torch.ones_like(d[ok],
                                                         dtype=torch.int32))


def postings_runs(starts, lengths, *, L: int) -> np.ndarray:
    """K17's runs as 2 Q + 1 int64 words: each run's start, then the
    prefix of their valid lengths (each cut to [0, L]) from 0, so the
    kernel numbers all valid postings as one sequence."""
    st = _host(starts, np.int64)
    ln = np.clip(_host(lengths, np.int64), 0, max(L, 0))
    if ln.shape != st.shape:
        raise ValueError(f"postings_match: lengths must have shape "
                         f"{st.shape}")
    return np.concatenate([st, np.zeros(1, np.int64), np.cumsum(ln)])


@functools.lru_cache(maxsize=1)
def _k17_param_runs() -> int:
    """Runs a K17 launch takes in its parameters (``K17_QMAX``)."""
    return _kb.query("postings_match", "es_postings_match_param_runs")


def postings_match(postings_docs, starts, lengths, *, segment_pad: int,
                   L: int):
    """Count, per doc, how many of the Q postings runs (``starts``,
    ``lengths``, at most ``L`` postings a run) hold it: i32[segment_pad].
    A run may hold a doc more than once (a prefix query's run spans
    several terms); each occurrence counts. Index rules as
    :func:`~.bm25.bm25_score`.

    A CPU tensor runs the plain version; a CUDA tensor launches K17 (one
    cooperative launch: the zeroing, then the postings dealt evenly over
    the card). The runs ride in the launch's parameters up to
    ``es_postings_match_param_runs`` of them, else they take one upload.
    """
    dev = _kb.wrapper_device("postings_match", postings_docs)
    if dev.type == "cpu":
        return postings_match_plain(postings_docs, starts, lengths,
                                    segment_pad=segment_pad, L=L)
    P = postings_docs.shape[0]
    _kb.check(postings_docs, "postings_docs", torch.int32, (P,), dev)
    runs = postings_runs(starts, lengths, L=L)
    Q = (runs.shape[0] - 1) // 2
    dev_runs = torch.as_tensor(runs, device=dev) \
        if Q > _k17_param_runs() else None
    matched = torch.empty(segment_pad, dtype=torch.int32, device=dev)
    _kb.launch("postings_match", dev, postings_docs.data_ptr(), P,
               runs.ctypes.data,
               None if dev_runs is None else dev_runs.data_ptr(), Q,
               segment_pad, matched.data_ptr())
    return matched


def range_mask_plain(vals, docs, lo, hi, *, segment_pad: int):
    """Plain version of K18 (see :func:`range_mask`)."""
    dev = vals.device
    lo_t = torch.tensor(lo, dtype=vals.dtype, device=dev)
    hi_t = torch.tensor(hi, dtype=vals.dtype, device=dev)
    hit = (vals >= lo_t) & (vals <= hi_t)
    d, ok = scatter_index(docs, segment_pad)
    mask = torch.zeros(segment_pad, dtype=torch.bool, device=dev)
    mask[d[ok & hit]] = True
    return mask


def range_mask(vals, docs, lo, hi, *, segment_pad: int):
    """Mask of docs having any pair value within [lo, hi]: bool[segment_pad].

    ``vals`` is i32 (a numeric field's value ranks, integer bounds) or f32
    (a keyword field's ordinals converted to f32, f32 bounds: compared as
    the reference compares them, rounding included); ``docs`` i32 of the
    same length. Pad pairs carry doc ``segment_pad`` and are dropped; a doc
    in ``[-segment_pad, 0)`` wraps.

    A CPU tensor runs the plain version; a CUDA tensor launches K18.
    """
    dev = _kb.wrapper_device("range_mask", vals)
    if vals.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"range_mask: values must be int32 or float32, got "
                        f"{vals.dtype}")
    if vals.dtype == torch.int32:
        lo, hi = int(np.int32(lo)), int(np.int32(hi))
    else:
        lo, hi = float(np.float32(lo)), float(np.float32(hi))
    if dev.type == "cpu":
        return range_mask_plain(vals, docs, lo, hi, segment_pad=segment_pad)
    M = vals.shape[0]
    _kb.check(vals, "vals", vals.dtype, (M,), dev)
    _kb.check(docs, "docs", torch.int32, (M,), dev)
    is_f32 = vals.dtype == torch.float32
    mask = torch.empty(segment_pad, dtype=torch.bool, device=dev)
    _kb.launch("range_mask", dev, vals.data_ptr(), int(is_f32),
               0 if is_f32 else lo, 0 if is_f32 else hi,
               lo if is_f32 else 0.0, hi if is_f32 else 0.0,
               docs.data_ptr(), M, segment_pad, mask.data_ptr())
    return mask


def get_postings_match_kernel(segment_pad: int, L: int):
    """:func:`postings_match` at one shape, called as the reference calls
    ``get_postings_match_kernel(n_pad, L)(docs, starts, lengths)``."""
    return functools.partial(postings_match, segment_pad=segment_pad, L=L)


def get_range_mask_kernel(segment_pad: int):
    """:func:`range_mask` at one shape, called as the reference calls
    ``get_range_mask_kernel(n_pad)(vals, docs, lo, hi)``."""
    return functools.partial(range_mask, segment_pad=segment_pad)
