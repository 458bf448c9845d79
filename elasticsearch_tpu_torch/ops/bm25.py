"""BM25 constants, the idf weight and the whole-segment BM25 scatter scorer
(port of ``elasticsearch_tpu/ops/bm25.py``).

:func:`bm25_score` is kernel K16 (``csrc/bm25_scatter.cu``): the
per-segment query DSL's dense scorer. It gathers each query term's
postings run out of the segment's flat CSR arrays and adds every
posting's BM25 contribution

    (idf * w) * (k1 + 1) * tf / max(tf + k1 * (1 - b + b * dl / avgdl), 1e-9)

into a dense per-doc score array, with a per-doc count of the runs that
hold the doc (``operator=and`` / ``minimum_should_match``).
:func:`bm25_score_plain` is its plain PyTorch version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import build as _kb
from .blockmax import fma_f32

# Elasticsearch defaults (SimilarityService: BM25 with k1=1.2, b=0.75).
DEFAULT_K1 = 1.2
DEFAULT_B = 0.75

#: docs a block of K16 owns (2^12): its scores and counts sit in shared
#: memory
BM25_TILE_SHIFT = 12
BM25_TILE = 1 << BM25_TILE_SHIFT
#: run positions a block of K16's pre-pass checks
BM25_CHUNK = 8192


def idf_weight(n_docs: int, doc_freq) -> np.ndarray:
    """Lucene BM25 idf: ln(1 + (N - df + 0.5) / (df + 0.5))."""
    df = np.asarray(doc_freq, dtype=np.float64)
    return np.log(1.0 + (np.float64(n_docs) - df + 0.5)
                  / (df + 0.5)).astype(np.float32)


def small(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """A short per-query array (numpy, list or tensor) as a contiguous
    ``dtype`` tensor on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype).contiguous()
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    return torch.as_tensor(np.ascontiguousarray(x, np_dtype), device=dev)


def _host(x, dtype) -> np.ndarray:
    """A short per-query array (numpy, list or tensor) as contiguous host
    ``dtype`` values."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.ascontiguousarray(x, dtype)


def take_fill(arr: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``jnp.take(arr, idx, mode="fill", fill_value=fill)``: an index in
    ``[-n, 0)`` wraps, any other index outside ``[0, n)`` reads ``fill``."""
    n = arr.shape[0]
    i = torch.where(idx < 0, idx + n, idx)
    ok = (i >= 0) & (i < n)
    if n == 0:
        return torch.full(idx.shape, fill, dtype=arr.dtype, device=arr.device)
    return torch.where(ok, arr[torch.where(ok, i, 0)],
                       torch.full((), fill, dtype=arr.dtype,
                                  device=arr.device))


def scatter_index(docs: torch.Tensor, n: int):
    """The reference's ``.at[docs]`` scatter with ``mode="drop"``: (wrapped
    int64 indices, kept) — a doc in ``[-n, 0)`` wraps, any other doc
    outside ``[0, n)`` is dropped."""
    d = docs.long()
    d = torch.where(d < 0, d + n, d)
    return d, (d >= 0) & (d < n)


def bm25_scatter_plan(segment_pad: int, run_len: int, Q: int,
                      param_slots: int) -> dict:
    """K16's launch shape for Q runs, the longest ``run_len`` postings (after
    the cut at L): tiles of ``BM25_TILE`` docs (the main kernel's blocks),
    chunks of ``BM25_CHUNK`` run positions (the pre-pass's blocks a slot,
    at least one), the ints of its scratch (each slot's ``n_tiles + 1``
    tile offsets and its chunk flags), and whether the slots' inputs go
    to the card in device memory rather than in the launch's parameters,
    which hold ``param_slots`` (the kernel's
    ``es_bm25_scatter_param_slots``)."""
    n_tiles = -(-segment_pad // BM25_TILE)
    n_chunks = max(1, -(-run_len // BM25_CHUNK))
    return dict(tile=BM25_TILE, tile_shift=BM25_TILE_SHIFT, n_tiles=n_tiles,
                chunk=BM25_CHUNK, n_chunks=n_chunks,
                scratch=Q * (n_tiles + 1 + n_chunks),
                device_slots=Q > param_slots)


def bm25_score_plain(postings_docs, postings_tf, doc_len, starts, lengths,
                     idf, weights, avgdl, k1, b, *, segment_pad: int,
                     L: int):
    """Plain version of K16 (see :func:`bm25_score`): one slot at a time,
    in slot order, so each doc's sum is added in the reference's order."""
    dev = postings_docs.device
    f32 = torch.float32
    starts = small(starts, torch.int64, dev).cpu().tolist()
    lengths = small(lengths, torch.int64, dev).cpu().tolist()
    idf = small(idf, f32, dev)
    weights = small(weights, f32, dev)
    avgdl, k1, b = (torch.tensor(np.float32(v), device=dev)
                    for v in (avgdl, k1, b))
    floor = torch.tensor(np.float32(1e-9), device=dev)
    scores = torch.zeros(segment_pad, dtype=f32, device=dev)
    matched = torch.zeros(segment_pad, dtype=torch.int32, device=dev)
    c1 = k1 + 1.0
    omb = 1.0 - b
    for q, (st, ln) in enumerate(zip(starts, lengths)):
        n = min(max(ln, 0), L)
        if n == 0:
            continue
        idx = st + torch.arange(n, device=dev)
        docs = take_fill(postings_docs, idx, segment_pad)
        tf = take_fill(postings_tf, idx, 0.0)
        dl = take_fill(doc_len, docs.long(), 0.0)
        norm = fma_f32(k1.expand_as(tf), omb + (b * dl) / avgdl, tf)
        contrib = (idf[q] * weights[q] * c1) * tf / torch.maximum(norm, floor)
        d, ok = scatter_index(docs, segment_pad)
        scores.index_add_(0, d[ok], contrib[ok])
        matched.index_add_(0, d[ok], torch.ones_like(d[ok],
                                                      dtype=torch.int32))
    return scores, matched


def bm25_score(postings_docs, postings_tf, doc_len, starts, lengths, idf,
               weights, avgdl, k1, b, *, segment_pad: int, L: int):
    """Score one segment for a bag of query terms into dense per-doc arrays.

    postings_docs: i32[P] flat CSR doc ids (each run doc-ascending, a doc
                   at most once a run); postings_tf: f32[P];
    doc_len:       f32[N] tokens per doc in this field;
    starts, lengths: i32[Q] each term's run (absent terms: length 0); only
                   the first ``L`` postings of a run count;
    idf, weights:  f32[Q]; avgdl, k1, b: f32 scalars.

    Returns (scores f32[segment_pad], matched i32[segment_pad]), where
    ``matched`` counts the runs holding each doc. A postings index or doc
    in ``[-n, 0)`` wraps and any other outside ``[0, n)`` is dropped, as
    the reference's ``take``/``.at[]`` do.

    A CPU tensor runs the plain version; a CUDA tensor launches K16.
    """
    dev = _kb.wrapper_device("bm25_score", postings_docs)
    if dev.type == "cpu":
        return bm25_score_plain(postings_docs, postings_tf, doc_len, starts,
                                lengths, idf, weights, avgdl, k1, b,
                                segment_pad=segment_pad, L=L)
    P, N = postings_docs.shape[0], doc_len.shape[0]
    _kb.check(postings_docs, "postings_docs", torch.int32, (P,), dev)
    _kb.check(postings_tf, "postings_tf", torch.float32, (P,), dev)
    _kb.check(doc_len, "doc_len", torch.float32, (N,), dev)
    # the slots' inputs as 4 Q words: in the launch's parameters, or past
    # the slots they hold in one copy to the card
    slots = [_host(starts, np.int32), _host(lengths, np.int32),
             _host(idf, np.float32), _host(weights, np.float32)]
    Q = slots[0].shape[0]
    for name, a in zip(("lengths", "idf", "weights"), slots[1:]):
        if a.shape != (Q,):
            raise ValueError(f"bm25_score: {name} must have shape ({Q},)")
    words = np.concatenate([a.view(np.int32) for a in slots])
    run_len = int(np.clip(slots[1], 0, L).max()) if Q else 0
    plan = bm25_scatter_plan(
        segment_pad, run_len, Q,
        _kb.query("bm25_scatter", "es_bm25_scatter_param_slots"))
    dev_words = torch.as_tensor(words, device=dev) \
        if plan["device_slots"] else None
    # the outputs and the scratch: one allocation
    out = torch.empty(2 * segment_pad + plan["scratch"], dtype=torch.int32,
                      device=dev)
    scores = out[:segment_pad].view(torch.float32)
    matched = out[segment_pad:2 * segment_pad]
    _kb.launch("bm25_scatter", dev, postings_docs.data_ptr(),
               postings_tf.data_ptr(), P, doc_len.data_ptr(), N,
               words.ctypes.data,
               None if dev_words is None else dev_words.data_ptr(), Q, L,
               segment_pad, float(np.float32(avgdl)), float(np.float32(k1)),
               float(np.float32(b)), plan["tile_shift"], plan["chunk"],
               plan["n_chunks"], out[2 * segment_pad:].data_ptr(),
               scores.data_ptr(), matched.data_ptr())
    return scores, matched


def get_bm25_kernel(segment_pad: int, L: int):
    """:func:`bm25_score` at one (padded segment size, padded run length)
    shape: the reference's call shape (``get_bm25_kernel(n_pad, L)(...)``)."""
    return functools.partial(bm25_score, segment_pad=segment_pad, L=L)
