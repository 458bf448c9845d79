"""Batched BM25 and kNN serving planes on one device (port of the lexical
and kNN parts of ``elasticsearch_tpu/parallel/dist_search.py``).

The reference runs each step as one SPMD program over a (replica, shard)
mesh: every device scores its shards, takes a local top-k, and an
``all_gather`` + ``top_k`` over the shard axis merges them. On one card the
mesh collapses: the shard axis is a leading dimension S of every launch,
and the cross-shard merge is one tie-stable top-k over [B, S·kk] (K3), with
ties going to the lower global id ``s · n_pad + local`` as in the
reference.

The host side is the reference's: term-dictionary lookups per shard,
global document-frequency statistics, and batch assembly; everything per
document runs in the kernels of ``ops/``.

A plane built with ``blockmax=`` also packs the reference's block-max
tier and serves through its rank-safe pruned route: the quantized scan
(K4), the exact re-score of its survivors (K5) and K3's top-k, with the
eager step re-serving any query the scan cannot certify.

The kNN plane packs vectors with their invariants on the host and serves
the exact scan (K6, then K3 over its chunks and shards) or, with an IVF
tier, the quantized scan of the probed clusters' blocks into a window
(K7), the window's exact re-rank (K8) and K3's top-k; the probe and the
union of probed blocks are host numpy, as in the reference.

The text plane also serves lowered bool trees (K9, the clause-bit
variant of K1, and K3), with a rescore window riding along (K5 on each
shard's candidates, K3 carrying their scores through the reduce, K11
reordering the window), and :func:`fused_search_device` serves hybrid
requests over a text and a kNN plane in one step: K9 and the exact kNN
scan, each list's cross-shard reduce, and their fusion (K10).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.blockmax import blockmax_scan
from ..ops.bm25 import DEFAULT_B, DEFAULT_K1, idf_weight
from ..ops.fused_query import (MAX_BOOL_CLAUSES, bisect_exact_scores,
                               bool_bm25_topk, fuse_rank, rescore_reorder)
from ..ops.knn import ivf_rerank, ivf_scan, knn_shard_scan
from ..ops.sorted_merge import make_impacts, sparse_candidates_topk
from ..ops.tiered_bm25 import (build_dense_rows, split_tiers,
                               tiered_bm25_topk)
from ..ops.topk import topk_merge
from ..utils.shapes import round_up_multiple, round_up_pow2

NEG_INF = float("-inf")

#: postings per block-max block: per-block int8 scales stay tight on
#: impact-ordered runs, and the per-block metadata (12 B) costs under
#: 0.1 B a posting
LEX_BLOCK = 128

#: cap on the θ-window width; dispatches whose k·Q exceeds it run with
#: pruning inert (θ = −inf) and fall back to eager through the verdict
LEX_THETA_WINDOW = 1024

#: survivor (exact re-score) window factor: the pruned step keeps
#: ``LEX_RERANK × k`` accumulator survivors
LEX_RERANK = 8


#: guards the planes' dispatch counters: the serving micro-batcher runs
#: two dispatcher threads over one plane
_COUNT_LOCK = threading.Lock()


def total_value(t) -> int:
    """Value of a per-query totals entry: a plain int (exact count) or a
    ``(value, "gte")`` tuple from a pruned dispatch (a lower bound: the
    scan skipped blocks whose docs it never saw, Lucene's
    track_total_hits-under-WAND semantics)."""
    return int(t[0]) if isinstance(t, tuple) else int(t or 0)


def total_is_lower_bound(t) -> bool:
    return isinstance(t, tuple)


# ---------------------------------------------------------------------------
# block-max tier (pack time, host numpy; device copy made once)
# ---------------------------------------------------------------------------


class BlockMaxTier:
    """Impact-ordered block-max tier over a plane's full per-shard CSR
    (sparse and dense-tier terms alike), as the reference packs it."""

    def __init__(self, block: int = LEX_BLOCK):
        self.block = block
        self.n_pad = 0
        #: per shard: docs i32[NB, BS] (``n_pad`` pad), codes int8[NB, BS],
        #: scale/off/bound f32[NB], blk_offsets i64[V+1] (term → block
        #: range), qerr f32[V] (the term's largest quantization half-step),
        #: n_blocks, n_postings
        self.shards: List[dict] = []
        self.n_blocks = 1
        self._dev: Optional[dict] = None
        self._acc: Optional[torch.Tensor] = None
        self._acc_stream = None
        self._acc_lock = threading.Lock()

    @classmethod
    def build(cls, shards: Sequence[dict], impacts_full: Sequence[np.ndarray],
              *, n_pad: int, block: int = LEX_BLOCK) -> "BlockMaxTier":
        """``shards``: the plane constructor's shard dicts (CSR
        ``offsets``/``docs``); ``impacts_full``: per-shard f32 impacts."""
        tier = cls(block=block)
        tier.n_pad = n_pad
        BS = block
        for s, imp in zip(shards, impacts_full):
            offsets = np.asarray(s["offsets"], np.int64)
            docs = np.asarray(s["docs"], np.int32)
            imp = np.asarray(imp, np.float32)
            V = offsets.shape[0] - 1
            Pn = docs.shape[0]
            lens = np.diff(offsets)
            # one stable sort puts every term's postings impact-descending
            # (equal impacts keep the CSR's doc-ascending order)
            tids = np.repeat(np.arange(V, dtype=np.int64), lens)
            order = np.lexsort((-imp, tids))
            nblk = -(-lens // BS)
            blk_offsets = np.zeros(V + 1, np.int64)
            np.cumsum(nblk, out=blk_offsets[1:])
            NB = int(blk_offsets[-1])
            bdocs = np.full((NB, BS), n_pad, np.int32)
            bimp = np.zeros((NB, BS), np.float32)
            if Pn:
                rank = np.arange(Pn, dtype=np.int64) - \
                    np.repeat(offsets[:-1], lens)
                dst = np.repeat(blk_offsets[:-1], lens) * BS + rank
                bdocs.reshape(-1)[dst] = docs[order]
                bimp.reshape(-1)[dst] = imp[order]
            real = bdocs < n_pad
            # slot 0 holds the block's largest impact: its score bound per
            # unit of idf weight
            bound = bimp[:, 0].copy()
            lo_v = np.where(real, bimp, np.float32(np.inf)).min(axis=1) \
                if NB else np.zeros(0, np.float32)
            lo_v = np.minimum(lo_v, bound)
            scale = np.maximum((bound - lo_v) / 254.0,
                               1e-12).astype(np.float32)
            codes = np.clip(
                np.rint((bimp - lo_v[:, None]) / scale[:, None]) - 127.0,
                -127, 127).astype(np.int8)
            off = (lo_v + 127.0 * scale).astype(np.float32)
            qerr = np.zeros(max(V, 1), np.float32)
            if NB:
                blk_tid = np.repeat(np.arange(V), nblk)
                np.maximum.at(qerr, blk_tid,
                              (scale * 0.5).astype(np.float32))
            tier.shards.append(dict(
                docs=bdocs, codes=codes, scale=scale, off=off,
                bound=bound.astype(np.float32), blk_offsets=blk_offsets,
                qerr=qerr, n_blocks=NB, n_postings=int(Pn)))
        tier.n_blocks = max(max((sh["n_blocks"] for sh in tier.shards),
                                default=1), 1)
        return tier

    # -- byte accounting ------------------------------------------------------

    def impact_bytes_f32(self) -> int:
        """Bytes of f32 impacts the eager plane holds for these postings."""
        return sum(sh["n_postings"] * 4 for sh in self.shards)

    def impact_bytes_int8(self) -> int:
        """Bytes of the quantized payload: int8 codes (with block padding)
        and per-block scale/off/bound."""
        return sum(sh["codes"].nbytes + sh["scale"].nbytes
                   + sh["off"].nbytes + sh["bound"].nbytes
                   for sh in self.shards)

    def nbytes(self) -> int:
        return sum(sh["docs"].nbytes + sh["codes"].nbytes
                   + sh["scale"].nbytes + sh["off"].nbytes
                   + sh["bound"].nbytes + sh["blk_offsets"].nbytes
                   + sh["qerr"].nbytes for sh in self.shards)

    def device_bytes(self) -> int:
        """Bytes of :meth:`device_arrays`: docs i32 + codes int8 per slot,
        scale/off per block, pad block included."""
        return len(self.shards) * (self.n_blocks + 1) * (self.block * 5 + 8)

    # -- query-time schedule --------------------------------------------------

    def schedule(self, si: int, term_rows: Sequence[Tuple[int, float]]):
        """Descending-bound block schedule of one (query, shard):
        ``term_rows`` = [(tid, idf·weight)]. Returns (blk i32[n], w f32[n],
        rho f32[n], slack): ``rho[i]`` is the bound mass left before
        position i (the WAND bound on any unseen doc's score), never rising
        along the schedule; ``slack`` a bound on the quantization and
        rounding error of any partial."""
        tsh = self.shards[si]
        offs, bound, qerr = tsh["blk_offsets"], tsh["bound"], tsh["qerr"]
        bl: List[np.ndarray] = []
        sb: List[np.ndarray] = []
        wl: List[np.ndarray] = []
        nx: List[np.ndarray] = []
        slack = 0.0
        rho0 = 0.0
        for tid, w in term_rows:
            b0, b1 = int(offs[tid]), int(offs[tid + 1])
            if b1 <= b0:
                continue
            s = bound[b0:b1] * np.float32(w)
            bl.append(np.arange(b0, b1, dtype=np.int32))
            sb.append(s)
            wl.append(np.full(b1 - b0, w, np.float32))
            nx.append(np.concatenate([s[1:], np.zeros(1, np.float32)]))
            slack += float(qerr[tid]) * float(w)
            rho0 += float(s[0])
        if not bl:
            return (np.zeros(0, np.int32), np.zeros(0, np.float32),
                    np.zeros(0, np.float32), 0.0)
        blk = np.concatenate(bl)
        sball = np.concatenate(sb)
        wall = np.concatenate(wl)
        nxall = np.concatenate(nx)
        order = np.argsort(-sball, kind="stable")
        # consuming block j of a term shrinks its remaining bound from
        # bound[j] to bound[j+1]: rho is the exclusive cumsum of the drops
        # off the starting mass
        delta = (sball - nxall)[order]
        rho = np.float64(rho0) - (np.cumsum(delta, dtype=np.float64)
                                  - delta)
        # the drops are >= 0, so rho falls; the running minimum only undoes
        # a one-ulp rise the f64 rounding of (cumsum - delta) can make, and
        # lets the scan stop at its first step that is not live
        rho = np.minimum.accumulate(rho.astype(np.float32))
        # the partials sum in another order than the eager scorer: a tiny
        # relative pad keeps the margin sound
        slack += 1e-5 * rho0
        return blk[order], wall[order], rho, float(slack)

    # -- device tier ----------------------------------------------------------

    def device_arrays(self, device) -> dict:
        """Block-major device tier, made once: docs i32[S, NB+1, BS] (row
        NB an all-``n_pad`` pad block), codes int8[S, NB+1, BS], scale/off
        f32[S, NB+1]."""
        if self._dev is not None:
            return self._dev
        S = len(self.shards)
        BS = self.block
        nb = self.n_blocks
        docs = np.full((S, nb + 1, BS), self.n_pad, np.int32)
        codes = np.zeros((S, nb + 1, BS), np.int8)
        scale = np.zeros((S, nb + 1), np.float32)
        off = np.zeros((S, nb + 1), np.float32)
        for s, sh in enumerate(self.shards):
            n = sh["n_blocks"]
            if not n:
                continue
            docs[s, :n] = sh["docs"]
            codes[s, :n] = sh["codes"]
            scale[s, :n] = sh["scale"]
            off[s, :n] = sh["off"]
        self._dev = {name: torch.from_numpy(a).to(device) for name, a in
                     dict(docs=docs, codes=codes, scale=scale,
                          off=off).items()}
        return self._dev

    def scan_workspace(self, rows: int, device) -> Optional[torch.Tensor]:
        """K4's zeroed accumulator, f32[≥ rows, n_pad], kept across
        dispatches; None on the CPU. Each launch leaves it zeroed, and
        launches on one stream run in order, so they share it: a caller
        on another stream than the one it was made on gets a
        RuntimeError. :meth:`drop_workspace` discards it."""
        if torch.device(device).type != "cuda":
            return None
        stream = torch.cuda.current_stream(device)
        with self._acc_lock:
            if self._acc is not None and stream != self._acc_stream:
                raise RuntimeError(
                    "BlockMaxTier: the scan workspace belongs to another "
                    "CUDA stream; serve a plane from one stream")
            if self._acc is None or self._acc.shape[0] < rows:
                self._acc = None
                self._acc = torch.zeros((rows, self.n_pad),
                                        dtype=torch.float32, device=device)
                self._acc_stream = stream
            return self._acc

    def drop_workspace(self) -> None:
        """Discard the scan workspace (after a dispatch that failed part
        way may have left it dirty); the next dispatch makes a zeroed
        one."""
        with self._acc_lock:
            self._acc = None
            self._acc_stream = None

    def to_packed(self) -> dict:
        """The tier as :meth:`DistributedSearchPlane.export_packed` ships
        it."""
        return dict(block=int(self.block), n_pad=int(self.n_pad),
                    n_blocks=int(self.n_blocks), shards=self.shards)

    @classmethod
    def from_packed(cls, packed: dict) -> "BlockMaxTier":
        t = cls(block=int(packed["block"]))
        t.n_pad = int(packed["n_pad"])
        t.n_blocks = int(packed["n_blocks"])
        t.shards = [dict(sh) for sh in packed["shards"]]
        return t


# ---------------------------------------------------------------------------
# step bodies over [S, ...] tensors
# ---------------------------------------------------------------------------


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array, contiguous, on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device,
                                                       non_blocking=True)


def decode_hits(vals, gdocs, n_pad: int, cut=None):
    """(shard, local doc) of each query's entries before its first −inf
    (at most ``cut[b]`` of them), global ids ``shard · n_pad + doc``."""
    fin = vals != NEG_INF
    n = np.where(fin.all(1), vals.shape[1], np.argmin(fin, 1))
    if cut is not None:
        n = np.minimum(n, cut)
    shard, doc = np.divmod(gdocs.astype(np.int64), n_pad)
    return [list(zip(shard[b, :n[b]].tolist(), doc[b, :n[b]].tolist()))
            for b in range(vals.shape[0])]


def _global_topk_reduce(vals, idx, *, kk: int, n_pad: int,
                        out_k: Optional[int] = None, payload=()):
    """Cross-shard reduce: [B, S, kk] shard-local lists → ([B, w], [B, w])
    with w = min(out_k, S·kk), ids globalised as ``s · n_pad + local``.

    ``payload``: [B, S, kk] per-candidate channels (the rescore
    secondaries) gathered along the same selections (K3's ``sel``); when
    given, a third output holds them as a tuple of [B, w] tensors."""
    out_k = kk if out_k is None else out_k
    B, S, _ = vals.shape
    out = topk_merge(vals.reshape(B, S * kk), idx.reshape(B, S * kk),
                     k=min(out_k, S * kk), fill_id=S * n_pad, seg_len=kk,
                     seg_stride=n_pad, with_sel=bool(payload))
    if not payload:
        return out
    sel = out[2].long()
    return out[0], out[1], tuple(
        torch.gather(p.reshape(B, S * kk), 1, sel) for p in payload)


def bm25_topk_step(postings_docs, postings_impact, starts, lengths, idfw, *,
                   n_pad: int, L: int, k: int, min_should_match: int = 1,
                   with_count: bool = False):
    """Body of the reference's ``build_bm25_topk_step`` over S shards:
    sorted-merge scoring (K1) + cross-shard reduce (K3). Returns (values
    f32[B, k'], global_doc i32[B, k']) plus i32[B] counts with
    ``with_count``."""
    S = postings_docs.shape[0]
    kk = min(k, n_pad)
    vals, docs, count = sparse_candidates_topk(
        postings_docs, postings_impact, starts, lengths, idfw, n_pad=n_pad,
        L=L, k=kk, min_should_match=min_should_match)
    gvals, gdocs = _global_topk_reduce(vals, docs, kk=kk, n_pad=n_pad,
                                       out_k=min(k, S * n_pad))
    if with_count:
        return gvals, gdocs, count.sum(1)
    return gvals, gdocs


def tiered_bm25_step(postings_docs, postings_impact, dense, starts, lengths,
                     idfw, dense_rid, dense_w, W, u_ids=None, *, n_pad: int,
                     L: int, k: int, min_should_match: int = 1,
                     with_count: bool = False):
    """Body of the reference's ``build_tiered_bm25_step`` over S shards:
    K1 (with the dense gather fused) + K2 + K3 merges. ``u_ids`` i32[S, U]
    selects the used dense rows (None: W spans all T_pad rows)."""
    S = postings_docs.shape[0]
    kk = min(k, n_pad)
    out = tiered_bm25_topk(
        postings_docs, postings_impact, dense, starts, lengths, idfw,
        dense_rid, dense_w, W, n_pad=n_pad, L=L, k=kk,
        min_should_match=min_should_match, with_count=with_count,
        u_ids=u_ids)
    gvals, gdocs = _global_topk_reduce(out[0], out[1], kk=kk, n_pad=n_pad,
                                       out_k=min(k, S * n_pad))
    if with_count:
        return gvals, gdocs, out[2].sum(1)
    return gvals, gdocs


def pruned_bm25_step(postings_docs, postings_impact, t_docs, t_codes,
                     t_scale, t_off, sched, w, rho, slack, starts, lengths,
                     idfw, *, n_pad: int, NB: int, Q: int, k: int, W: int,
                     R: int, acc: Optional[torch.Tensor] = None):
    """Body of the reference's ``build_pruned_bm25_step`` over S shards:
    the block-max scan (K4), the exact re-score of its survivors (K5), the
    per-shard top-k (K3) and the cross-shard reduce (K3).

    ``starts``/``lengths`` i32[B, S, Q] are every slot's whole sparse run
    (the re-score bisects whole runs). Returns (vals f32[B, k'], gdocs
    i32[B, k'], matched, unsafe, pruned, n_sc summed over shards [B]).

    The survivors come doc-ascending, so K3's (value desc, id asc) order
    is ``lax.top_k``'s lowest-position tie rule; a survivor slot left
    empty holds ``n_pad``, which K3 drops as ``fill_id``, exactly where
    the reference masks the re-score to −inf.
    """
    B, S, _ = sched.shape
    kk = min(k, n_pad)
    kq = k * Q
    ci, _cv, matched, unsafe, pruned, n_sc = blockmax_scan(
        t_docs, t_codes, t_scale, t_off, sched, w, rho, slack, n_pad=n_pad,
        NB=NB, W=W, R=R, kq_idx=min(kq, W) - 1, prune_active=kq <= W,
        acc=acc)
    score, _found = bisect_exact_scores(postings_docs, postings_impact,
                                        starts, lengths, idfw, ci,
                                        n_pad=n_pad)
    vals, docs = topk_merge(score.reshape(B * S, R), ci.reshape(B * S, R),
                            k=kk, fill_id=n_pad)
    gvals, gdocs = _global_topk_reduce(
        vals.reshape(B, S, kk), docs.reshape(B, S, kk), kk=kk, n_pad=n_pad,
        out_k=min(k, S * n_pad))
    return (gvals, gdocs, matched.sum(1), unsafe.sum(1), pruned.sum(1),
            n_sc.sum(1))


def bool_bm25_step(postings_docs, postings_impact, starts, lengths, idfw,
                   cbits, req, neg, shd, msm, st2=None, ln2=None, iw2=None,
                   qw=None, rw=None, rwin=None, *, n_pad: int, L: int,
                   k: int, nc: int = MAX_BOOL_CLAUSES,
                   rescore_mode: str = "total"):
    """Body of the reference's ``build_bool_bm25_step`` over S shards:
    bool-tree scoring (K9) and the cross-shard reduce (K3). With the
    rescore query (``st2``/``ln2`` i32[B, S, Q2], ``iw2`` f32[B, Q2],
    ``qw``/``rw`` f32[B], ``rwin`` i32[B]), each shard's candidates carry
    their exact rescore scores and matches (K5) through the reduce (K3's
    ``sel``) and the window reorders (K11). Returns (vals f32[B, k'],
    global docs i32[B, k'], counts i32[B]) with k' = min(k, S·n_pad)."""
    S = postings_docs.shape[0]
    kk = min(k, n_pad)
    out_k = min(k, S * n_pad)
    vals, docs, cnt = bool_bm25_topk(
        postings_docs, postings_impact, starts, lengths, idfw, cbits, req,
        neg, shd, msm, n_pad=n_pad, L=L, k=kk, nc=nc)
    if st2 is None:
        gvals, gdocs = _global_topk_reduce(vals, docs, kk=kk, n_pad=n_pad,
                                           out_k=out_k)
        return gvals, gdocs, cnt.sum(1)
    sec, fnd = bisect_exact_scores(postings_docs, postings_impact, st2, ln2,
                                   iw2, docs, n_pad=n_pad)
    gvals, gdocs, (gsec, gfnd) = _global_topk_reduce(
        vals, docs, kk=kk, n_pad=n_pad, out_k=out_k, payload=(sec, fnd))
    gvals, gdocs = rescore_reorder(gvals, gdocs, gsec, gfnd, qw, rw, rwin,
                                   mode=rescore_mode, k=out_k,
                                   pad_id=S * n_pad)
    return gvals, gdocs, cnt.sum(1)


def bool_role_masks(clauses) -> Tuple[int, int, int]:
    """(required, prohibited, should) clause bitmasks of a lowered bool
    tree: clause ci owns bit ``1 << ci``; must and filter are required,
    must_not prohibited, should optional (counted against msm)."""
    req = neg = shd = 0
    for ci, (role, _terms) in enumerate(clauses):
        bit = 1 << ci
        if role in ("must", "filter"):
            req |= bit
        elif role == "must_not":
            neg |= bit
        else:
            shd |= bit
    return req, neg, shd


def bool_clause_rows(clauses, idf_of):
    """Per-clause ``[(term, idf·weight)]`` in first-appearance order under
    ``idf_of``. Scoring clauses (must, should) drop terms of zero idf;
    filter and must_not clauses keep every term at weight 0.0 (they need
    the postings run for membership, never the weight)."""
    out = []
    for role, terms in clauses:
        weights: Dict[str, float] = {}
        for t in terms:
            weights[t] = weights.get(t, 0.0) + 1.0
        if role in ("must", "should"):
            rows = [(t, idf_of(t) * w) for t, w in weights.items()
                    if idf_of(t) > 0.0]
        else:
            rows = [(t, 0.0) for t in weights]
        out.append((role, rows))
    return out


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------


class DistributedSearchPlane:
    """Packs per-shard postings into device tensors and runs batched
    searches, as the reference plane does over its mesh.

    ``shards``: one dict per shard with ``term_ids`` (term→tid), ``df``
    i32[V], ``offsets`` i64[V+1], ``docs`` i32[P], ``tf`` f32[P],
    ``doc_len`` f32[N], optional ``doc_uids`` and ``avgdl``.
    ``device``: where the packed plane lives and the kernels run; None
    means ``cuda``, and a process without CUDA raises unless the caller
    passes ``device="cpu"`` (the plain PyTorch versions then serve).
    ``blockmax``: keyword arguments of :meth:`BlockMaxTier.build` (may be
    empty) to pack the block-max tier that :meth:`serve`'s pruned route
    scans; None packs no tier (eager serving only).
    """

    #: dense-tier block width (docs per streamed block)
    DENSE_BLOCK = 1 << 19
    #: dense-tier row budget per shard (memory cap: T × n_pad × 2B each)
    MAX_DENSE_TERMS = 256
    #: serving Q floor (see :meth:`serve`)
    SERVING_Q_MIN = 8

    def __init__(self, shards: Sequence[dict], field: str, *,
                 device=None, k1: float = DEFAULT_K1, b: float = DEFAULT_B,
                 dense_threshold: Optional[int] = None,
                 blockmax: Optional[dict] = None):
        self.device = resolve_device(device)
        self.field = field
        self.k1, self.b = k1, b
        shards = list(shards)
        self.n_shards = len(shards)
        #: dispatches through a step (tests assert the plane ran)
        self.n_dispatches = 0

        self.n_pad = round_up_pow2(
            max(max(s["doc_len"].shape[0] for s in shards), 1))
        if dense_threshold is None:
            dense_threshold = max(self.n_pad // 256, 4096)
        self.dense_threshold = dense_threshold

        S = self.n_shards
        self.n_docs_total = 0
        impacts_full: List[np.ndarray] = []
        tiers: List[dict] = []
        for s in shards:
            if s.get("avgdl") is not None:
                avgdl = max(float(s["avgdl"]), 1e-9)
            else:
                fdc = max(int((s["doc_len"] > 0).sum()), 1)
                avgdl = max(float(s["doc_len"].sum()) / fdc, 1e-9)
            impacts_full.append(make_impacts(
                s["tf"], s["docs"], s["doc_len"], avgdl, k1, b))
            tiers.append(split_tiers(
                s, dense_threshold=dense_threshold,
                max_dense_terms=self.MAX_DENSE_TERMS))
            self.n_docs_total += int(s["doc_len"].shape[0])

        # block-max tier over the full CSR, at the impacts' frozen avgdl
        self.blockmax: Optional[BlockMaxTier] = None
        if blockmax is not None:
            self.blockmax = BlockMaxTier.build(
                shards, impacts_full, n_pad=self.n_pad, **blockmax)

        self.shards = []
        for s, t in zip(shards, tiers):
            dense_row_of = {int(tid): r
                            for r, tid in enumerate(t["dense_tids"])}
            self.shards.append(dict(
                term_ids=s["term_ids"], df=s["df"],
                sparse_offsets=t["offsets"], sparse_df=t["df"],
                dense_row_of=dense_row_of, doc_uids=s.get("doc_uids")))

        self.max_sparse_df = max(
            max((t["sparse_max_df"] for t in tiers), default=1), 1)
        self.L_cap = round_up_pow2(self.max_sparse_df)
        self.n_dense = max(t["dense_tids"].size for t in tiers)
        self.T_pad = round_up_multiple(max(self.n_dense, 1), 16) \
            if self.n_dense else 0

        # sparse table with L_cap sentinel slack after the last run
        p_need = max(t["docs"].shape[0] for t in tiers) + self.L_cap
        self.p_pad = -(-p_need // 1024) * 1024
        docs = np.full((S, self.p_pad), self.n_pad, np.int32)
        impacts = np.zeros((S, self.p_pad), np.float32)
        for i, (s, t, imp) in enumerate(zip(shards, tiers, impacts_full)):
            pn = t["docs"].shape[0]
            docs[i, :pn] = t["docs"]
            keep = np.ones(s["docs"].shape[0], bool)
            for tid in t["dense_tids"]:
                keep[s["offsets"][tid]: s["offsets"][tid + 1]] = False
            impacts[i, :pn] = imp[keep]
        self.docs_dev = torch.from_numpy(docs).to(self.device)
        self.impacts_dev = torch.from_numpy(impacts).to(self.device)
        del docs, impacts

        self.dense_dev = None
        self.dense_block = min(self.DENSE_BLOCK, self.n_pad)
        if self.T_pad:
            C = self.dense_block
            n_blk = -(-self.n_pad // C)
            self.dense_dev = torch.zeros((S, n_blk, self.T_pad, C),
                                         dtype=torch.bfloat16,
                                         device=self.device)
            for i, (s, t, imp) in enumerate(zip(shards, tiers,
                                                impacts_full)):
                build_dense_rows(s, t["dense_tids"], imp, n_pad=self.n_pad,
                                 block=C, t_pad=self.T_pad,
                                 out=self.dense_dev[i])

    @classmethod
    def from_segments(cls, segments: Sequence, field: str, **kw):
        """Build from one segment per shard: each ``seg.text_fields[field]``
        supplies host arrays ``term_ids``, ``df``, ``offsets``,
        ``docs_host``, ``tf_host``, ``doc_len_host``."""
        shards = []
        for seg in segments:
            f = seg.text_fields[field]
            shards.append(dict(
                term_ids=f.term_ids, df=f.df, offsets=f.offsets,
                docs=f.docs_host, tf=f.tf_host, doc_len=f.doc_len_host,
                doc_uids=seg.doc_uids))
        return cls(shards, field, **kw)

    def packed_arrays(self) -> dict:
        """The packed plane as host numpy arrays (dense rows as their bf16
        bit patterns, int16), for comparison with the reference's pack."""
        out = dict(docs=self.docs_dev.cpu().numpy(),
                   impacts=self.impacts_dev.cpu().numpy(),
                   n_pad=self.n_pad, T_pad=self.T_pad, L_cap=self.L_cap,
                   p_pad=self.p_pad)
        if self.dense_dev is not None:
            out["dense_bits"] = self.dense_dev.view(torch.int16).cpu().numpy()
        return out

    def device_corpus_bytes(self) -> int:
        total = self.docs_dev.nbytes + self.impacts_dev.nbytes
        if self.dense_dev is not None:
            total += self.dense_dev.nbytes
        if self.blockmax is not None:
            total += self.blockmax.device_bytes()
        return int(total)

    # -- packed state (wire-compatible with the reference) -------------------

    def export_packed(self) -> dict:
        """Every tensor and invariant of the packed plane as a host dict in
        the reference's ``export_packed`` layout (dense rows as exact f32),
        which the reference's ``from_packed`` loads. The port has no host
        CSR tier: ``host_csr`` is None."""
        dense = None
        if self.dense_dev is not None:
            dense = self.dense_dev.float().cpu().numpy()
        return dict(
            field=self.field, k1=float(self.k1), b=float(self.b),
            n_shards=int(self.n_shards), n_pad=int(self.n_pad),
            p_pad=int(self.p_pad),
            dense_threshold=int(self.dense_threshold),
            n_docs_total=int(self.n_docs_total),
            max_sparse_df=int(self.max_sparse_df),
            L_cap=int(self.L_cap), n_dense=int(self.n_dense),
            T_pad=int(self.T_pad), dense_block=int(self.dense_block),
            docs=self.docs_dev.cpu().numpy(),
            impacts=self.impacts_dev.cpu().numpy(), dense=dense,
            shards=[dict(term_ids=dict(sh["term_ids"]), df=sh["df"],
                         sparse_offsets=sh["sparse_offsets"],
                         sparse_df=sh["sparse_df"],
                         dense_row_of=dict(sh["dense_row_of"]),
                         doc_uids=(list(sh["doc_uids"])
                                   if sh.get("doc_uids") is not None
                                   else None))
                    for sh in self.shards],
            host_csr=None,
            blockmax=(self.blockmax.to_packed()
                      if self.blockmax is not None else None))

    @classmethod
    def from_packed(cls, packed: dict, device=None
                    ) -> "DistributedSearchPlane":
        """A plane from ``export_packed`` state (the reference's or the
        port's): only the uploads run, no pack work. ``host_csr`` is
        ignored (the port has no host tier)."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.field = str(packed["field"])
        self.k1, self.b = float(packed["k1"]), float(packed["b"])
        self.n_shards = int(packed["n_shards"])
        self.n_dispatches = 0
        self.n_pad = int(packed["n_pad"])
        self.p_pad = int(packed["p_pad"])
        self.dense_threshold = int(packed["dense_threshold"])
        self.n_docs_total = int(packed["n_docs_total"])
        self.max_sparse_df = int(packed["max_sparse_df"])
        self.L_cap = int(packed["L_cap"])
        self.n_dense = int(packed["n_dense"])
        self.T_pad = int(packed["T_pad"])
        self.dense_block = int(packed.get("dense_block") or 0) or \
            min(self.DENSE_BLOCK, self.n_pad)
        self.shards = [dict(term_ids=sh["term_ids"], df=sh["df"],
                            sparse_offsets=sh["sparse_offsets"],
                            sparse_df=sh["sparse_df"],
                            dense_row_of={int(k): int(v) for k, v in
                                          sh["dense_row_of"].items()},
                            doc_uids=sh.get("doc_uids"))
                       for sh in packed["shards"]]
        state = plane_state_from_numpy(
            dict(docs=packed["docs"], impacts=packed["impacts"],
                 dense=packed.get("dense") if self.T_pad else None),
            device=self.device)
        self.docs_dev = state["docs"]
        self.impacts_dev = state["impacts"]
        self.dense_dev = state.get("dense")
        self.blockmax = None
        if packed.get("blockmax") is not None:
            self.blockmax = BlockMaxTier.from_packed(packed["blockmax"])
        return self

    # -- query assembly ------------------------------------------------------

    def global_df(self, term: str) -> int:
        """Document frequency of ``term`` summed over every shard."""
        out = 0
        for sh in self.shards:
            tid = sh["term_ids"].get(term)
            if tid is not None:
                out += int(sh["df"][tid])
        return out

    def _lookup(self, queries: Sequence[Sequence[str]], Q: int,
                extra_docs: int = 0,
                extra_df: Optional[Dict[str, int]] = None):
        """Per-shard run/row lookup for a query batch (the reference's
        ``_lookup``): a term is scored by the sparse or the dense tier per
        shard; idf uses the original global df, shifted by ``extra_docs``
        / ``extra_df`` (corpus mass living outside this plane)."""
        B, S = len(queries), self.n_shards
        starts = np.zeros((B, S, Q), np.int32)
        lengths = np.zeros((B, S, Q), np.int32)
        dense_rid = np.zeros((B, S, Q), np.int32)
        dense_hit = np.zeros((B, S, Q), bool)
        weights = np.zeros((B, Q), np.float32)
        gdf = np.zeros((B, Q), np.int64)
        max_len = 1
        any_dense = False
        for bi, terms in enumerate(queries):
            uniq: Dict[str, int] = {}
            for t in terms:
                if t in uniq:
                    weights[bi, uniq[t]] += 1.0
                    continue
                qi = len(uniq)
                if qi >= Q:
                    continue
                uniq[t] = qi
                weights[bi, qi] = 1.0
                if extra_df:
                    gdf[bi, qi] += int(extra_df.get(t, 0))
                for si, sh in enumerate(self.shards):
                    tid = sh["term_ids"].get(t)
                    if tid is None:
                        continue
                    gdf[bi, qi] += int(sh["df"][tid])
                    row = sh["dense_row_of"].get(int(tid)) \
                        if sh["dense_row_of"] else None
                    if row is not None:
                        dense_rid[bi, si, qi] = row
                        dense_hit[bi, si, qi] = True
                        any_dense = True
                        continue
                    st = int(sh["sparse_offsets"][tid])
                    ln = int(sh["sparse_offsets"][tid + 1]) - st
                    starts[bi, si, qi] = st
                    lengths[bi, si, qi] = ln
                    max_len = max(max_len, ln)
        idf = idf_weight(self.n_docs_total + extra_docs,
                         gdf).astype(np.float32)
        idf[gdf == 0] = 0.0
        idfw = idf * weights
        return (starts, lengths, idfw, dense_rid, dense_hit, max_len,
                any_dense)

    def max_run_len(self, queries: Sequence[Sequence[str]]) -> int:
        """Longest sparse-tier run any of these queries touches."""
        out = 1
        for terms in queries:
            for t in set(terms):
                for sh in self.shards:
                    tid = sh["term_ids"].get(t)
                    if tid is None:
                        continue
                    if sh["dense_row_of"] and \
                            int(tid) in sh["dense_row_of"]:
                        continue
                    ln = int(sh["sparse_offsets"][tid + 1]) - \
                        int(sh["sparse_offsets"][tid])
                    out = max(out, ln)
        return out

    def ladder_rungs(self) -> List[int]:
        """The 4-step geometric L ladder (L_cap, L_cap/8, L_cap/64,
        L_cap/512, floored at 1024)."""
        return sorted({max(1024, self.L_cap >> s) for s in (9, 6, 3, 0)})

    def ladder_L(self, needed: int) -> int:
        """Smallest ladder rung ≥ needed."""
        for r in self.ladder_rungs():
            if needed <= r:
                return r
        return self.L_cap

    def _dense_inputs(self, idfw, dense_rid, dense_hit):
        """Slot-space dense-tier inputs (the reference's
        ``_dense_inputs``): the used-row width U, ``u_ids`` i32[S, U], the
        slot-indexed (rid, w) pairs and W f32[B, S, U]. When the batch
        uses most of the tier, U = T_pad and ``u_ids`` is a [S, 1]
        dummy."""
        B, S = dense_hit.shape[0], self.n_shards
        T = self.T_pad
        u_lists = [np.unique(dense_rid[:, si, :][dense_hit[:, si, :]])
                   for si in range(S)]
        max_used = max((r.size for r in u_lists), default=0)
        U = min(T, max(16, round_up_pow2(max(max_used, 1))))
        if 3 * U > T:
            U = T
        if U < T:
            u_ids = np.zeros((S, U), np.int32)
            rid_out = np.zeros_like(dense_rid)
            for si, rows in enumerate(u_lists):
                u_ids[si, :rows.size] = rows
                bi_ix, qi_ix = np.nonzero(dense_hit[:, si, :])
                if bi_ix.size:
                    rid_out[bi_ix, si, qi_ix] = np.searchsorted(
                        rows, dense_rid[bi_ix, si, qi_ix]).astype(np.int32)
        else:
            U = T
            u_ids = np.zeros((S, 1), np.int32)
            rid_out = dense_rid
        dense_w = np.where(dense_hit, idfw[:, None, :], 0.0) \
            .astype(np.float32)
        W = np.zeros((B, S, max(U, 1)), np.float32)
        bi_ix, si_ix, qi_ix = np.nonzero(dense_hit)
        if bi_ix.size:
            np.add.at(W, (bi_ix, si_ix, rid_out[bi_ix, si_ix, qi_ix]),
                      idfw[bi_ix, qi_ix])
        return U, u_ids, rid_out, dense_w, W

    def prepare(self, queries: Sequence[Sequence[str]], k: int = 10, *,
                Q: Optional[int] = None, L: Optional[int] = None,
                tiered: Optional[bool] = None, extra_docs: int = 0,
                extra_df: Optional[Dict[str, int]] = None) -> dict:
        """Host assembly + upload of one batch: the step (``"tiered"`` or
        ``"plain"``), its keyword arguments as device tensors, and the
        shapes. :meth:`search` runs it; a benchmark can run its kernels
        on exactly these inputs."""
        needed_q = max(max((len(set(q)) for q in queries), default=1), 1)
        if Q is None:
            Q = round_up_pow2(needed_q)
        elif Q < needed_q:
            raise ValueError(
                f"Q={Q} would drop terms from a {needed_q}-term query; "
                f"pass Q=None to size automatically")
        (starts, lengths, idfw, dense_rid, dense_hit, max_len,
         any_dense) = self._lookup(queries, Q, extra_docs=extra_docs,
                                   extra_df=extra_df)
        if L is None:
            L = round_up_pow2(max_len)
        elif L < max_len:
            raise ValueError(
                f"L={L} would truncate a postings run of length {max_len}; "
                f"pass L=None to size automatically")
        L = min(L, self.L_cap)
        np.minimum(lengths, L, out=lengths)
        use_tiered = any_dense if tiered is None else (
            tiered and self.T_pad > 0)
        if tiered is False and any_dense:
            raise ValueError(
                "tiered=False but the batch hits dense-tier terms")
        up = self._upload
        args = dict(postings_docs=self.docs_dev,
                    postings_impact=self.impacts_dev, starts=up(starts),
                    lengths=up(lengths), idfw=up(idfw))
        U = 0
        if use_tiered:
            U, u_ids, rid_slots, dense_w, W = self._dense_inputs(
                idfw, dense_rid, dense_hit)
            args.update(dense=self.dense_dev, dense_rid=up(rid_slots),
                        dense_w=up(dense_w), W=up(W),
                        u_ids=up(u_ids) if U < self.T_pad else None)
        return dict(step="tiered" if use_tiered else "plain", args=args,
                    Q=Q, L=L, k=k, U=U, B=len(queries))

    def run(self, prep: dict, *, with_totals: bool = False):
        """Run a prepared batch's step; returns the step's device
        outputs."""
        kw = dict(n_pad=self.n_pad, L=prep["L"], k=prep["k"],
                  with_count=with_totals)
        step = tiered_bm25_step if prep["step"] == "tiered" \
            else bm25_topk_step
        out = step(**prep["args"], **kw)
        with _COUNT_LOCK:
            self.n_dispatches += 1
        return out

    def search(self, queries: Sequence[Sequence[str]], k: int = 10,
               *, Q: Optional[int] = None, L: Optional[int] = None,
               tiered: Optional[bool] = None, with_totals: bool = False,
               stages: Optional[dict] = None, extra_docs: int = 0,
               extra_df: Optional[Dict[str, int]] = None):
        """Run a batch of bag-of-terms queries. Returns (scores f32[B, k],
        hits list[list[(shard, local_doc)]]) plus exact per-query match
        counts (list[int]) with ``with_totals``.

        ``tiered``: None picks the tiered step iff the batch touches a
        dense-tier term; True forces it whenever a dense tier exists.
        ``stages``: optional dict receiving ``prep_ms`` (host assembly +
        upload), ``dispatch_ms`` (the device step, synchronised) and
        ``fetch_ms`` (result copy + decode).
        """
        t0 = time.perf_counter()
        prep = self.prepare(queries, k, Q=Q, L=L, tiered=tiered,
                            extra_docs=extra_docs, extra_df=extra_df)
        t1 = time.perf_counter()
        out = self.run(prep, with_totals=with_totals)
        if stages is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        vals = out[0].cpu().numpy()
        hits = decode_hits(vals, out[1].cpu().numpy(), self.n_pad)
        if stages is not None:
            stages["prep_ms"] = (t1 - t0) * 1e3
            stages["dispatch_ms"] = (t2 - t1) * 1e3
            stages["fetch_ms"] = (time.perf_counter() - t2) * 1e3
        if with_totals:
            totals = [int(c) for c in out[2].cpu().numpy()]
            return vals, hits, totals
        return vals, hits

    # -- block-max pruned serving -------------------------------------------

    #: survivor window = ``prune_rerank × k`` (pow2-rounded); tests shrink
    #: it to force the unsafe → eager fallback
    prune_rerank = LEX_RERANK

    def _query_idfw(self, terms: Sequence[str], extra_docs: int,
                    extra_df: Optional[Dict[str, int]]):
        """(term → idf·weight) in first-appearance order, terms of no
        document left out; the schedule's term rows follow this order."""
        weights: Dict[str, float] = {}
        for t in terms:
            weights[t] = weights.get(t, 0.0) + 1.0
        idfw_of: Dict[str, float] = {}
        for t, w in weights.items():
            gdf = sum(int(s2["df"][s2["term_ids"][t]])
                      for s2 in self.shards if t in s2["term_ids"])
            if extra_df:
                gdf += int(extra_df.get(t, 0))
            if gdf:
                idfw_of[t] = float(idf_weight(
                    self.n_docs_total + extra_docs, np.int64(gdf))) * w
        return idfw_of

    def prepare_pruned(self, queries: Sequence[Sequence[str]], k: int = 10,
                       *, extra_docs: int = 0,
                       extra_df: Optional[Dict[str, int]] = None) -> dict:
        """Host assembly + upload of one pruned dispatch: each (query,
        shard)'s block schedule padded to ``P_sched`` (a power of two) with
        the pad block NB, and the step's keyword arguments as device
        tensors. A batch that touches a dense-tier term gets
        ``step="dense"`` and nothing else (:meth:`search_pruned` serves it
        through the tiered step)."""
        tier = self.blockmax
        if tier is None:
            raise RuntimeError("plane has no block-max tier")
        B = len(queries)
        needed_q = max(max((len(set(q)) for q in queries), default=1), 1)
        Q = max(self.SERVING_Q_MIN, round_up_pow2(needed_q))
        (starts, lengths, idfw, _rid, _hit, _ml,
         any_dense) = self._lookup(queries, Q, extra_docs=extra_docs,
                                   extra_df=extra_df)
        if any_dense:
            return dict(step="dense", Q=Q, B=B)
        S = self.n_shards
        NB = tier.n_blocks
        P_need = 1
        rows = []
        for terms in queries:
            idfw_of = self._query_idfw(terms, extra_docs, extra_df)
            for si, sh in enumerate(self.shards):
                term_rows = [(int(sh["term_ids"][t]), w)
                             for t, w in idfw_of.items()
                             if t in sh["term_ids"]]
                blk, wblk, rho, slack = tier.schedule(si, term_rows)
                rows.append((blk, wblk, rho, slack))
                P_need = max(P_need, blk.shape[0])
        P_sched = round_up_pow2(P_need)
        sched = np.full((B, S, P_sched), NB, np.int32)
        w_arr = np.zeros((B, S, P_sched), np.float32)
        rho_arr = np.zeros((B, S, P_sched), np.float32)
        slack_arr = np.zeros((B, S), np.float32)
        sched_lens = np.zeros((B, S), np.int64)
        for i, (blk, wblk, rho, slack) in enumerate(rows):
            bi, si = divmod(i, S)
            n = blk.shape[0]
            sched[bi, si, :n] = blk
            w_arr[bi, si, :n] = wblk
            rho_arr[bi, si, :n] = rho
            slack_arr[bi, si] = slack
            sched_lens[bi, si] = n
        kk = min(k, self.n_pad)
        W = min(round_up_pow2(max(k * Q, 1)), LEX_THETA_WINDOW)
        R = min(round_up_pow2(max(self.prune_rerank * kk, 64)), self.n_pad)
        tdev = tier.device_arrays(self.device)
        up = self._upload
        args = dict(postings_docs=self.docs_dev,
                    postings_impact=self.impacts_dev, t_docs=tdev["docs"],
                    t_codes=tdev["codes"], t_scale=tdev["scale"],
                    t_off=tdev["off"], sched=up(sched), w=up(w_arr),
                    rho=up(rho_arr), slack=up(slack_arr), starts=up(starts),
                    lengths=up(lengths), idfw=up(idfw))
        return dict(step="pruned", args=args, Q=Q, k=k, W=W, R=R,
                    P_sched=P_sched, B=B, sched_lens=sched_lens)

    def run_pruned(self, prep: dict):
        """Run a prepared pruned dispatch; returns the step's device
        outputs."""
        tier = self.blockmax
        acc = tier.scan_workspace(prep["B"] * self.n_shards, self.device)
        try:
            out = pruned_bm25_step(
                **prep["args"], n_pad=self.n_pad, NB=tier.n_blocks,
                Q=prep["Q"], k=prep["k"], W=prep["W"], R=prep["R"], acc=acc)
        except BaseException:
            tier.drop_workspace()
            raise
        with _COUNT_LOCK:
            self.n_dispatches += 1
        return out

    def search_pruned(self, queries: Sequence[Sequence[str]], k: int = 10,
                      *, with_totals: bool = False,
                      stages: Optional[dict] = None, extra_docs: int = 0,
                      extra_df: Optional[Dict[str, int]] = None):
        """Block-max pruned dispatch (:func:`pruned_bm25_step`): the scan
        skips the steps past each query's rank-safety threshold, the
        survivors re-score exactly, and every query whose safety verdict
        fails re-serves through the eager step, as does a batch touching
        dense-tier terms (the tiered step serves those). Exact on every
        input. Returns what :meth:`search` returns; a total is a
        ``(value, "gte")`` lower bound where the scan stopped early.

        ``stages`` also receives ``docs_scanned`` (docs in scored blocks
        per query), ``lex_blocks_scored``, ``lex_blocks_total`` and
        ``unsafe`` (queries re-served eagerly); that re-serve lands in
        ``fetch_ms``."""
        t0 = time.perf_counter()
        prep = self.prepare_pruned(queries, k, extra_docs=extra_docs,
                                   extra_df=extra_df)
        if prep["step"] == "dense":
            return self.search(queries, k=k, tiered=True, Q=prep["Q"],
                               L=self.ladder_L(self.max_run_len(queries)),
                               with_totals=with_totals, stages=stages,
                               extra_docs=extra_docs, extra_df=extra_df)
        B, Q = prep["B"], prep["Q"]
        t1 = time.perf_counter()
        out = self.run_pruned(prep)
        if stages is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        gvals, gdocs, matched, unsafe, pruned, n_sc = (
            o.cpu().numpy() for o in out)
        vals_out = np.full((B, k), NEG_INF, np.float32)
        wk = min(k, gvals.shape[1])
        vals_out[:, :wk] = gvals[:, :wk]
        hits_out = decode_hits(vals_out, gdocs[:, :wk], self.n_pad)
        totals: List = [(int(m), "gte") if p > 0 else int(m)
                        for m, p in zip(matched, pruned)]
        # rank-safety fallback: a query the survivor window could not
        # certify re-serves through the eager step
        bad = np.flatnonzero(unsafe > 0)
        if bad.size:
            bad_q = [queries[i] for i in bad]
            ev = self.search(bad_q, k=k, Q=Q,
                             L=self.ladder_L(self.max_run_len(bad_q)),
                             tiered=self.T_pad > 0 or None,
                             with_totals=True, extra_docs=extra_docs,
                             extra_df=extra_df)
            for j, i in enumerate(bad):
                src = np.asarray(ev[0][j], np.float32)[:k]
                vals_out[i] = NEG_INF
                vals_out[i, :src.shape[0]] = src
                hits_out[i] = list(ev[1][j])[:k]
                totals[i] = int(ev[2][j])
        if stages is not None:
            blocks_scored = int(n_sc.sum())
            stages["prep_ms"] = (t1 - t0) * 1e3
            stages["dispatch_ms"] = (t2 - t1) * 1e3
            stages["fetch_ms"] = (time.perf_counter() - t2) * 1e3
            stages["docs_scanned"] = blocks_scored * self.blockmax.block \
                // max(B, 1)
            stages["lex_blocks_scored"] = blocks_scored
            stages["lex_blocks_total"] = int(prep["sched_lens"].sum())
            stages["unsafe"] = int(bad.size)
        if with_totals:
            return vals_out, hits_out, totals
        return vals_out, hits_out

    def serve(self, queries: Sequence[Sequence[str]], k: int = 10,
              *, with_totals: bool = False, stages: Optional[dict] = None,
              extra_docs: int = 0,
              extra_df: Optional[Dict[str, int]] = None,
              prune: Optional[bool] = None):
        """Serving entry. On a plane with a block-max tier, a batch whose
        result window fits the θ window (k · Q ≤ ``LEX_THETA_WINDOW``, Q
        floored to ``SERVING_Q_MIN``) takes the rank-safe pruned route
        (:meth:`search_pruned`): results bitwise those of the eager scan,
        totals ``(value, "gte")`` lower bounds where the scan stopped
        early. ``prune``: None = the tier's default, False = eager.

        Every other batch runs :meth:`search` at the stable serving shapes
        (ladder-rung L, Q floored to ``SERVING_Q_MIN``). The reference
        first routes CPU-built planes to its host scorers and demoted
        planes to a streamed scan; the port has neither a host tier nor
        storage tiers, so the tier check decides alone."""
        if self.blockmax is not None and prune is not False:
            needed_q = max(self.SERVING_Q_MIN, round_up_pow2(max(
                max((len(set(q)) for q in queries), default=1), 1)))
            if k * needed_q <= LEX_THETA_WINDOW:
                return self.search_pruned(
                    queries, k=k, with_totals=with_totals, stages=stages,
                    extra_docs=extra_docs, extra_df=extra_df)
        return self.search(queries, k=k, **self.serving_shape(queries),
                           with_totals=with_totals, stages=stages,
                           extra_docs=extra_docs, extra_df=extra_df)

    def serving_shape(self, queries: Sequence[Sequence[str]]) -> dict:
        """The ``Q``, ``L`` and ``tiered`` that :meth:`serve` passes to
        :meth:`search` for this batch."""
        needed_q = max(max((len(set(q)) for q in queries), default=1), 1)
        return dict(Q=max(self.SERVING_Q_MIN, round_up_pow2(needed_q)),
                    L=self.ladder_L(self.max_run_len(queries)),
                    tiered=self.T_pad > 0 or None)

    # -- bool trees (the fused planner's lexical stage) ----------------------

    def _bool_clause_idfw(self, clauses, extra_docs: int,
                          extra_df: Optional[Dict[str, int]]):
        """Per-clause ``[(term, idf·weight)]`` under this plane's global
        stats (and any mass outside it): :func:`bool_clause_rows` with a
        cached idf."""
        idf_cache: Dict[str, float] = {}

        def idf_of(t: str) -> float:
            v = idf_cache.get(t)
            if v is None:
                gdf = sum(int(s2["df"][s2["term_ids"][t]])
                          for s2 in self.shards if t in s2["term_ids"])
                if extra_df:
                    gdf += int(extra_df.get(t, 0))
                v = float(idf_weight(self.n_docs_total + extra_docs,
                                     np.int64(gdf))) if gdf else 0.0
                idf_cache[t] = v
            return v

        return bool_clause_rows(clauses, idf_of)

    def has_dense_terms(self, terms) -> bool:
        """True when any term lives in some shard's dense tier: the bool
        and hybrid steps read only the sparse table, so such a batch
        cannot take them."""
        for t in set(terms):
            for sh in self.shards:
                tid = sh["term_ids"].get(t)
                if tid is not None and sh["dense_row_of"] and \
                        int(tid) in sh["dense_row_of"]:
                    return True
        return False

    def bool_inputs(self, bool_queries, Q: int, *, extra_docs: int = 0,
                    extra_df: Optional[Dict[str, int]] = None):
        """Host assembly of a bool-query batch: one slot per (clause,
        unique term) over the sparse table, and each query's clause-role
        masks. Returns (starts, lengths, idfw, cbits, req, neg, shd, msm,
        max_len, any_dense), numpy."""
        B, S = len(bool_queries), self.n_shards
        starts = np.zeros((B, S, Q), np.int32)
        lengths = np.zeros((B, S, Q), np.int32)
        idfw = np.zeros((B, Q), np.float32)
        cbits = np.zeros((B, Q), np.int32)
        req = np.zeros(B, np.int32)
        neg = np.zeros(B, np.int32)
        shd = np.zeros(B, np.int32)
        msm = np.zeros(B, np.int32)
        max_len = 1
        any_dense = False
        for bi, bq in enumerate(bool_queries):
            clauses = bq.get("clauses") or []
            msm[bi] = int(bq.get("msm", 0))
            req[bi], neg[bi], shd[bi] = bool_role_masks(clauses)
            per_clause = self._bool_clause_idfw(clauses, extra_docs,
                                                extra_df)
            qi = 0
            for ci, (_role, rows) in enumerate(per_clause):
                for t, w in rows:
                    if qi >= Q:
                        continue
                    idfw[bi, qi] = w
                    cbits[bi, qi] = 1 << ci
                    for si, sh in enumerate(self.shards):
                        tid = sh["term_ids"].get(t)
                        if tid is None:
                            continue
                        if sh["dense_row_of"] and \
                                int(tid) in sh["dense_row_of"]:
                            any_dense = True
                            continue
                        st = int(sh["sparse_offsets"][tid])
                        ln = int(sh["sparse_offsets"][tid + 1]) - st
                        starts[bi, si, qi] = st
                        lengths[bi, si, qi] = ln
                        max_len = max(max_len, ln)
                    qi += 1
        return (starts, lengths, idfw, cbits, req, neg, shd, msm, max_len,
                any_dense)

    @staticmethod
    def bool_slot_count(bool_queries) -> int:
        """Slots a bool-query batch needs (one per (clause, unique
        term)): the Q axis of the bool and hybrid steps."""
        out = 1
        for bq in bool_queries:
            n = 0
            for _role, terms in (bq.get("clauses") or []):
                n += len(set(terms))
            out = max(out, n)
        return out

    def prepare_bool(self, bool_queries, *, extra_docs: int = 0,
                     extra_df: Optional[Dict[str, int]] = None) -> dict:
        """Host assembly + upload of a bool dispatch at the serving shapes
        (Q floored to ``SERVING_Q_MIN``, a ladder-rung L): the step's
        tensors and ``h2d_bytes``. Raises ``ValueError`` for a batch that
        touches a dense-tier term."""
        Q = max(self.SERVING_Q_MIN,
                round_up_pow2(self.bool_slot_count(bool_queries)))
        (starts, lengths, idfw, cbits, req, neg, shd, msm, max_len,
         any_dense) = self.bool_inputs(bool_queries, Q,
                                       extra_docs=extra_docs,
                                       extra_df=extra_df)
        if any_dense:
            raise ValueError(
                "bool batch touches dense-tier terms; the sparse-slice "
                "bool step cannot serve it (fall back)")
        L = min(self.ladder_L(max_len), self.L_cap)
        np.minimum(lengths, L, out=lengths)
        up = self._upload
        args = dict(postings_docs=self.docs_dev,
                    postings_impact=self.impacts_dev, starts=up(starts),
                    lengths=up(lengths), idfw=up(idfw), cbits=up(cbits),
                    req=up(req), neg=up(neg), shd=up(shd), msm=up(msm))
        h2d = starts.nbytes + lengths.nbytes + idfw.nbytes + cbits.nbytes \
            + 16 * len(bool_queries)
        return dict(args=args, Q=Q, L=L, h2d=h2d)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return _upload(a, self.device)

    def search_bool(self, bool_queries, k: int = 10, *,
                    with_totals: bool = False,
                    stages: Optional[dict] = None, extra_docs: int = 0,
                    extra_df: Optional[Dict[str, int]] = None):
        """Bool-tree dispatch (:func:`bool_bm25_step`) at the serving
        shapes. ``bool_queries``: one dict per query, ``clauses`` a list of
        (role, terms) with role must / should / filter / must_not, ``msm``
        the minimum number of should clauses. Returns (scores f32[B, k'],
        hits list[list[(shard, doc)]]) plus exact totals (list[int]) with
        ``with_totals``. Dense-tier terms cannot ride the sparse slice:
        callers check :meth:`has_dense_terms` first (the batch raises
        ``ValueError``). ``stages`` receives ``prep_ms``, ``dispatch_ms``
        (synchronised), ``fetch_ms``, ``h2d_bytes`` and ``d2h_bytes``."""
        t0 = time.perf_counter()
        prep = self.prepare_bool(bool_queries, extra_docs=extra_docs,
                                 extra_df=extra_df)
        t1 = time.perf_counter()
        out = bool_bm25_step(**prep["args"], n_pad=self.n_pad, L=prep["L"],
                             k=k)
        if stages is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        with _COUNT_LOCK:
            self.n_dispatches += 1
        vals, gdocs, counts = (o.cpu().numpy() for o in out)
        hits = decode_hits(vals, gdocs, self.n_pad)
        if stages is not None:
            stages["prep_ms"] = (t1 - t0) * 1e3
            stages["dispatch_ms"] = (t2 - t1) * 1e3
            stages["fetch_ms"] = (time.perf_counter() - t2) * 1e3
            stages["h2d_bytes"] = prep["h2d"]
            stages["d2h_bytes"] = vals.nbytes + gdocs.nbytes + counts.nbytes
        if with_totals:
            return vals, hits, [int(c) for c in counts]
        return vals, hits

    def serve_bool(self, bool_queries, k: int = 10, *,
                   with_totals: bool = False,
                   stages: Optional[dict] = None, extra_docs: int = 0,
                   extra_df: Optional[Dict[str, int]] = None):
        """Serving entry for lowered bool trees: the bool step. The
        reference first routes CPU-built planes to its host scorer; the
        port has no host tier."""
        return self.search_bool(bool_queries, k=k, with_totals=with_totals,
                                stages=stages, extra_docs=extra_docs,
                                extra_df=extra_df)


def plane_state_from_numpy(packed: dict, *, device=None) -> dict:
    """The reference plane's packed host arrays (``docs`` i32[S, P],
    ``impacts`` f32[S, P], ``dense`` [S, n_blk, T, C] as bf16, or as f32
    (``export_packed``'s wire form, rounded to bf16 nearest-even as the
    reference's ``from_packed`` rounds it), or its int16 bit pattern
    ``dense_bits``) as the port's tensors on ``device`` (None: the card;
    raises without one)."""
    device = resolve_device(device)
    out = dict(docs=torch.from_numpy(np.array(
                   packed["docs"], np.int32)).to(device),
               impacts=torch.from_numpy(np.array(
                   packed["impacts"], np.float32)).to(device))
    bits = packed.get("dense_bits")
    dense = packed.get("dense")
    if bits is None and dense is not None:
        dense = np.asarray(dense)
        if dense.dtype == np.float32:
            bits = torch.from_numpy(np.ascontiguousarray(dense)).to(
                torch.bfloat16).view(torch.int16).numpy()
        else:
            bits = dense.view(np.int16)
    if bits is not None:
        out["dense"] = torch.from_numpy(np.array(
            bits, np.int16)).view(torch.bfloat16).to(device)
    return out


# ---------------------------------------------------------------------------
# kNN: the exact blocked scan and the IVF tier
# ---------------------------------------------------------------------------

#: rows per streamed block of the reference's exact scan (the port's plain
#: version follows it; K6's result does not depend on it)
KNN_BLOCK = 1 << 16

KNN_SIMILARITIES = ("dot_product", "cosine", "l2_norm")

#: rows per IVF device-tier block: the quantized tier is block-major
#: [NB, IVF_BLOCK, d], so the probed union is a list of whole blocks whose
#: rows are masked by cluster
IVF_BLOCK = 256

#: serving defaults (the reference's ``knn_ivf_recall`` bench measures
#: these)
IVF_DEFAULT_NPROBE = 8
IVF_DEFAULT_RERANK = 4

#: k-means training defaults: Lloyd on a bounded sample, then one
#: assignment of the full corpus
IVF_TRAIN_SAMPLE = 1 << 15
IVF_KMEANS_ITERS = 6


def prepare_knn_corpus(vecs: np.ndarray, similarity: str):
    """Pack-time corpus invariants (host numpy, once): unit rows for
    cosine, ``‖v‖²`` rows for l2 (zeros otherwise). ``vecs``: f32[...,
    dim]. Returns (vecs', vnorm2)."""
    if similarity not in KNN_SIMILARITIES:
        raise ValueError(f"unknown similarity [{similarity}]")
    vecs = np.asarray(vecs, np.float32)
    if similarity == "cosine":
        norms = np.linalg.norm(vecs, axis=-1, keepdims=True)
        vecs = vecs / np.maximum(norms, 1e-12)
    if similarity == "l2_norm":
        vnorm2 = np.sum(vecs.astype(np.float64) ** 2,
                        axis=-1).astype(np.float32)
    else:
        vnorm2 = np.zeros(vecs.shape[:-1], np.float32)
    return vecs, vnorm2


def _knn_blocking(block: Optional[int], n_pad: int, kk: int):
    """(blk, use_blocks): blocking only when it divides the corpus cleanly
    and a block's top-k can hold kk candidates."""
    use_blocks = (block is not None and block > 0 and n_pad % block == 0
                  and n_pad // block >= 2 and kk <= block)
    return (block if use_blocks else n_pad), use_blocks


def _packed_queries(q: torch.Tensor, similarity: str) -> torch.Tensor:
    """Queries in the packed convention: unit rows for cosine."""
    if similarity == "cosine":
        return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1,
                                                        keepdim=True),
                               min=1e-12)
    return q


def knn_step(vecs, vnorm2, exists, q, *, n_pad: int, k: int,
             similarity: str, block: Optional[int] = KNN_BLOCK):
    """Body of the reference's ``build_knn_step`` over S shards: the query
    in the packed convention, ``qn = Σq²`` of the raw query, the exact
    scan (K6 + K3) and the cross-shard reduce (K3). Returns (vals f32[B,
    k'], global rows i32[B, k'])."""
    if similarity not in KNN_SIMILARITIES:
        raise ValueError(f"unknown similarity [{similarity}]")
    S = vecs.shape[0]
    kk = min(k, n_pad)
    blk, use_blocks = _knn_blocking(block, n_pad, kk)
    qq = _packed_queries(q, similarity)
    qn = torch.sum(q * q, dim=-1)
    vals, idx = knn_shard_scan(vecs, vnorm2, exists, qq, qn,
                               similarity=similarity, kk=kk, blk=blk,
                               use_blocks=use_blocks)
    return _global_topk_reduce(vals, idx, kk=kk, n_pad=n_pad,
                               out_k=min(k, S * n_pad))


def ivf_knn_step(codes, scale, off, rowid, rcl, vecs, vnorm2, q, probed,
                 u_blocks, *, n_pad: int, k: int, similarity: str,
                 nlist: int, r_cand: int):
    """Body of the reference's ``build_ivf_knn_step`` over S shards: the
    quantized scan of the probed union into a top-``r_cand`` window (K7,
    one C call at any window), the exact re-score of the window's
    rows (K8), the top-kk by (score desc, row asc) (K3), and the
    cross-shard reduce (K3)."""
    S = vecs.shape[0]
    kk = min(k, n_pad)
    l2 = similarity == "l2_norm"
    qq = _packed_queries(q, similarity)
    qsum = torch.sum(qq, dim=-1)
    qn = torch.sum(q * q, dim=-1)
    win_v, win_p = ivf_scan(codes, scale, off, rowid, rcl, vnorm2, qq, qsum,
                            qn, probed, u_blocks, l2=l2, n_pad=n_pad,
                            nlist=nlist, r_cand=r_cand)
    ex, rows = ivf_rerank(win_v, win_p, u_blocks, rowid, vecs, vnorm2, qq,
                          qn, l2=l2, n_pad=n_pad)
    B, _, R = ex.shape
    vals, idx = topk_merge(ex.view(B * S, R), rows.view(B * S, R), k=kk,
                           fill_id=n_pad)
    return _global_topk_reduce(vals.view(B, S, kk), idx.view(B, S, kk),
                               kk=kk, n_pad=n_pad, out_k=min(k, S * n_pad))


def _assign_clusters(x: np.ndarray, centroids: np.ndarray, l2: bool,
                     chunk: Optional[int] = None, *, device=None
                     ) -> np.ndarray:
    """argmax_c metric(x, c) per row (dot; ``2x·c − ‖c‖²`` for l2),
    chunked so the [chunk, nlist] score matrix stays near 64 MB.

    On the CPU this is the reference's numpy branch (BLAS), so a host pack
    is byte-identical to the reference's; on the card its accelerator
    branch: an f32 product and ``argmax``, which takes the first of equal
    maxima. A card pack needs TF32 off (PyTorch's default): with
    ``torch.backends.cuda.matmul.allow_tf32`` on, the product would round
    its inputs to 10-bit mantissas, so this raises rather than change the
    process-wide flag."""
    dev = resolve_device(device)
    if dev.type != "cpu" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "_assign_clusters: a card pack needs f32 products; turn "
            "torch.backends.cuda.matmul.allow_tf32 off")
    if chunk is None:
        chunk = max(1024, (64 << 20) // (4 * max(centroids.shape[0], 1)))
    c2 = np.sum(centroids.astype(np.float64) ** 2,
                axis=1).astype(np.float32)
    out = np.empty(x.shape[0], np.int32)
    if dev.type == "cpu":
        for lo in range(0, x.shape[0], chunk):
            s = x[lo: lo + chunk] @ centroids.T
            if l2:
                s = 2.0 * s - c2[None, :]
            out[lo: lo + chunk] = np.argmax(s, axis=1).astype(np.int32)
        return out
    cent = torch.from_numpy(np.ascontiguousarray(centroids)).to(dev)
    c2_dev = torch.from_numpy(c2).to(dev)
    for lo in range(0, x.shape[0], chunk):
        xb = torch.from_numpy(np.ascontiguousarray(
            x[lo: lo + chunk], np.float32)).to(dev)
        s = xb @ cent.T
        if l2:
            s = 2.0 * s - c2_dev[None, :]
        out[lo: lo + chunk] = torch.argmax(s, dim=1).to(
            torch.int32).cpu().numpy()
    return out


def kmeans_fit(x: np.ndarray, nlist: int, *, l2: bool = False,
               spherical: bool = False, iters: int = IVF_KMEANS_ITERS,
               sample: int = IVF_TRAIN_SAMPLE, seed: int = 0,
               device=None) -> np.ndarray:
    """Lloyd's k-means on (a sample of) x: nlist centroids seeded from the
    sample, empty clusters re-seeded from random rows, renormalised each
    round when ``spherical``. The assignment runs on ``device`` (see
    :func:`_assign_clusters`); the update is host numpy."""
    rng = np.random.RandomState(seed)
    n = x.shape[0]
    if n == 0 or nlist <= 0:
        raise ValueError("kmeans_fit needs rows and nlist >= 1")
    train = x if n <= sample else x[rng.choice(n, sample, replace=False)]
    nlist = min(nlist, train.shape[0])
    cent = train[rng.choice(train.shape[0], nlist, replace=False)].copy()
    for _ in range(max(iters, 1)):
        assign = _assign_clusters(train, cent, l2, device=device)
        sums = np.zeros_like(cent, dtype=np.float64)
        np.add.at(sums, assign, train.astype(np.float64))
        counts = np.bincount(assign, minlength=nlist)
        empty = counts == 0
        nz = ~empty
        cent[nz] = (sums[nz] / counts[nz, None]).astype(np.float32)
        if empty.any():
            cent[empty] = train[rng.choice(train.shape[0],
                                           int(empty.sum()))]
        if spherical:
            cent /= np.maximum(
                np.linalg.norm(cent, axis=1, keepdims=True), 1e-12)
    return cent


def quantize_int8_rows(vecs: np.ndarray):
    """Per-row asymmetric int8 quantization: ``v ≈ scale·q + off`` with
    row i's [min, max] mapped onto [−127, 127]. Returns (codes int8[N, d],
    scale f32[N], off f32[N])."""
    vecs = np.asarray(vecs, np.float32)
    lo = vecs.min(axis=-1)
    hi = vecs.max(axis=-1)
    scale = np.maximum((hi - lo) / 254.0, 1e-12).astype(np.float32)
    codes = np.clip(np.rint((vecs - lo[:, None]) / scale[:, None]) - 127.0,
                    -127, 127).astype(np.int8)
    off = (lo + 127.0 * scale).astype(np.float32)
    return codes, scale, off


class IvfKnnTier:
    """IVF index over a kNN plane's packed corpus: shared centroids and,
    per shard, cluster-contiguous quantized rows (stable within a cluster,
    so equal scores keep doc order). The plane's f32 rows, in original
    order, serve the exact re-rank."""

    def __init__(self, similarity: str, quant: str = "int8",
                 block: int = IVF_BLOCK):
        if quant not in ("int8", "bf16"):
            raise ValueError(f"unknown ivf quant [{quant}]")
        self.similarity = similarity
        self.quant = quant
        self.block = block
        self.nlist = 0
        self.centroids: Optional[np.ndarray] = None
        #: per shard: offsets i64[nlist+1] (cluster → row range in the
        #: reordered space), rows i32[n_exist] (reordered → original local
        #: row), codes (int8, or f16 for the bf16 tier), scale f32, off f32
        self.shards: List[dict] = []
        self.default_nprobe = IVF_DEFAULT_NPROBE
        #: blocks per shard in the device tier; block NB is the sentinel
        self.n_blocks = 1
        #: rows per cluster summed over shards
        self.cluster_sizes: Optional[np.ndarray] = None
        self._dev: Optional[dict] = None

    @classmethod
    def build(cls, vecs: np.ndarray, exists: np.ndarray, similarity: str,
              *, nlist: Optional[int] = None, quant: str = "int8",
              iters: int = IVF_KMEANS_ITERS,
              train_sample: int = IVF_TRAIN_SAMPLE, seed: int = 0,
              block: int = IVF_BLOCK, device=None) -> "IvfKnnTier":
        """``vecs`` f32[S, n_pad, d] / ``exists`` bool[S, n_pad]: the
        plane's packed arrays. ``nlist`` defaults to about sqrt(N) rounded
        to a power of two, capped so a cluster averages 8 rows or more.
        The k-means assignments run on ``device``."""
        tier = cls(similarity, quant=quant, block=block)
        S = vecs.shape[0]
        d = vecs.shape[2]
        flat = np.concatenate([vecs[s][exists[s]] for s in range(S)]) \
            if S else np.zeros((0, d), np.float32)
        n_exist = flat.shape[0]
        if n_exist == 0:
            raise ValueError("IVF tier needs at least one vector")
        if nlist is None:
            nlist = round_up_pow2(max(int(np.sqrt(n_exist)), 1))
        nlist = max(1, min(int(nlist), max(n_exist // 8, 1)))
        l2 = similarity == "l2_norm"
        tier.centroids = kmeans_fit(
            flat, nlist, l2=l2, spherical=(similarity == "cosine"),
            iters=iters, sample=train_sample, seed=seed, device=device)
        tier.nlist = tier.centroids.shape[0]
        tier.default_nprobe = min(IVF_DEFAULT_NPROBE, tier.nlist)
        for s in range(S):
            rows0 = np.flatnonzero(exists[s]).astype(np.int32)
            v = vecs[s][rows0]
            assign = _assign_clusters(v, tier.centroids, l2, device=device) \
                if rows0.size else np.zeros(0, np.int32)
            order = np.argsort(assign, kind="stable")
            rows = rows0[order]
            offsets = np.zeros(tier.nlist + 1, np.int64)
            np.cumsum(np.bincount(assign, minlength=tier.nlist),
                      out=offsets[1:])
            if quant == "int8":
                codes, scale, off = quantize_int8_rows(v[order])
            else:
                # host codes are f16 (numpy has no bf16); the device tier
                # converts them to bf16 at upload
                codes = v[order].astype(np.float16)
                scale = np.ones(rows.size, np.float32)
                off = np.zeros(rows.size, np.float32)
            tier.shards.append(dict(offsets=offsets, rows=rows,
                                    codes=codes, scale=scale, off=off))
        tier.n_blocks = max(max((-(-sh["rows"].size // tier.block)
                                 for sh in tier.shards), default=1), 1)
        sizes = np.zeros(tier.nlist, np.int64)
        for sh in tier.shards:
            sizes += np.diff(sh["offsets"]).astype(np.int64)
        tier.cluster_sizes = sizes
        return tier

    def quant_bytes_per_dim(self) -> int:
        return 1 if self.quant == "int8" else 2

    def nbytes(self) -> int:
        return sum(sh["codes"].nbytes + sh["scale"].nbytes
                   + sh["off"].nbytes + sh["rows"].nbytes
                   for sh in self.shards) \
            + (self.centroids.nbytes if self.centroids is not None else 0)

    def probe(self, qq: np.ndarray, nprobe: int) -> np.ndarray:
        """Top-``nprobe`` cluster ids per query from one host [B, nlist]
        product (the probed set sizes the union, so it is host-visible
        anyway). ``qq``: queries in the packed convention."""
        s = qq @ self.centroids.T
        if self.similarity == "l2_norm":
            c2 = np.sum(self.centroids.astype(np.float64) ** 2,
                        axis=1).astype(np.float32)
            s = 2.0 * s - c2[None, :]
        nprobe = min(nprobe, self.nlist)
        if nprobe >= self.nlist:
            return np.broadcast_to(
                np.arange(self.nlist, dtype=np.int32),
                (qq.shape[0], self.nlist)).copy()
        part = np.argpartition(-s, nprobe - 1, axis=1)[:, :nprobe]
        return part.astype(np.int32)

    def device_arrays(self, device, n_pad: int) -> dict:
        """Block-major device tier (built once): codes [S, NB+1, blk, d]
        (int8, or bf16 converted from the host's f16 codes), scale/off f32,
        rowid i32 (original local row; ``n_pad`` = padding) and rcl i32
        (cluster; −1 = padding) [S, NB+1, blk]. Block NB is all padding,
        the union's filler."""
        if self._dev is not None:
            return self._dev
        S = len(self.shards)
        blk = self.block
        d = self.shards[0]["codes"].shape[1] if S else 1
        nb = self.n_blocks
        cdt = np.int8 if self.quant == "int8" else np.float16
        codes = np.zeros((S, nb + 1, blk, d), cdt)
        scale = np.zeros((S, nb + 1, blk), np.float32)
        off = np.zeros((S, nb + 1, blk), np.float32)
        rowid = np.full((S, nb + 1, blk), n_pad, np.int32)
        rcl = np.full((S, nb + 1, blk), -1, np.int32)
        for s, sh in enumerate(self.shards):
            n = sh["rows"].size
            if not n:
                continue
            flat_cl = np.repeat(
                np.arange(self.nlist, dtype=np.int32),
                np.diff(sh["offsets"]).astype(np.int64))
            codes[s].reshape(-1, d)[:n] = sh["codes"]
            scale[s].reshape(-1)[:n] = sh["scale"]
            off[s].reshape(-1)[:n] = sh["off"]
            rowid[s].reshape(-1)[:n] = sh["rows"]
            rcl[s].reshape(-1)[:n] = flat_cl
        dev_codes = torch.from_numpy(codes).to(device)
        if self.quant == "bf16":
            dev_codes = dev_codes.to(torch.bfloat16)
        self._dev = dict(
            nb=nb, codes=dev_codes,
            scale=torch.from_numpy(scale).to(device),
            off=torch.from_numpy(off).to(device),
            rowid=torch.from_numpy(rowid).to(device),
            rcl=torch.from_numpy(rcl).to(device))
        return self._dev

    def device_bytes(self) -> int:
        """Bytes of :meth:`device_arrays`: codes plus 16 bytes of
        scale/off/rowid/rcl a slot, sentinel block included."""
        d = self.shards[0]["codes"].shape[1] if self.shards else 1
        return len(self.shards) * (self.n_blocks + 1) * self.block * \
            (d * self.quant_bytes_per_dim() + 16)

    def union_blocks(self, probed: np.ndarray, n_shards: int):
        """Per-shard union of the blocks the batch's probed clusters touch,
        padded with the sentinel block NB to a shared power-of-two width
        P (capped at NB). Returns (i32[n_shards, P], P)."""
        blk = self.block
        nb = self.n_blocks
        uniq = np.unique(probed)
        per_shard: List[np.ndarray] = []
        for sh in self.shards[:n_shards]:
            offs = sh["offsets"]
            blocks: set = set()
            for c in uniq:
                lo, hi = int(offs[c]), int(offs[c + 1])
                if hi > lo:
                    blocks.update(range(lo // blk, (hi - 1) // blk + 1))
            per_shard.append(np.fromiter(sorted(blocks), np.int32,
                                         len(blocks)))
        width = max(max((b.size for b in per_shard), default=1), 1)
        Pw = max(min(round_up_pow2(width), nb), 1)
        out = np.full((n_shards, Pw), nb, np.int32)
        for s, b in enumerate(per_shard):
            out[s, :min(b.size, Pw)] = b[:Pw]
        return out, Pw

    def to_packed(self) -> dict:
        """The tier as the reference's ``export_packed`` writes it."""
        return dict(similarity=self.similarity, quant=self.quant,
                    block=int(self.block), nlist=int(self.nlist),
                    centroids=self.centroids,
                    default_nprobe=int(self.default_nprobe),
                    n_blocks=int(self.n_blocks),
                    cluster_sizes=self.cluster_sizes, shards=self.shards)

    @classmethod
    def from_packed(cls, packed: dict) -> "IvfKnnTier":
        t = cls(str(packed["similarity"]), quant=str(packed["quant"]),
                block=int(packed["block"]))
        t.nlist = int(packed["nlist"])
        t.centroids = np.asarray(packed["centroids"], np.float32)
        t.default_nprobe = int(packed["default_nprobe"])
        t.n_blocks = int(packed["n_blocks"])
        t.cluster_sizes = np.asarray(packed["cluster_sizes"])
        t.shards = [dict(sh) for sh in packed["shards"]]
        return t


class DistributedKnnPlane:
    """Brute-force kNN plane (port of the reference's): per-shard vector
    matrices packed once with their invariants (unit rows for cosine,
    ``‖v‖²`` for l2) and served by the exact scan, or, with an IVF tier,
    by its cluster-pruned scan and exact re-rank.

    ``shards``: one dict per shard with ``vectors`` f32[N, dim] and
    optional ``exists`` bool[N]. Hits are (shard, local row), tie order
    (shard, row) ascending. ``ivf``: keyword arguments of
    :meth:`IvfKnnTier.build` (nlist, quant, seed, iters, train_sample) to
    pack an IVF tier; None packs none (exact serving only). ``device``:
    where the plane lives and the kernels run; None means ``cuda``, and
    a process without CUDA raises unless the caller passes ``"cpu"``.
    The reference pads the shard count to its mesh with
    :meth:`empty_pad_shard`; one device needs no mesh, so the port keeps
    the shards it is given (a pad shard passed in scores −inf).
    """

    def __init__(self, shards: Sequence[dict], *,
                 similarity: str = "cosine",
                 block: Optional[int] = KNN_BLOCK,
                 ivf: Optional[dict] = None, device=None):
        if similarity not in KNN_SIMILARITIES:
            raise ValueError(f"unknown similarity [{similarity}]")
        self.device = resolve_device(device)
        self.similarity = similarity
        self.block = block
        shards = list(shards)
        self.n_shards = len(shards)
        self.n_dispatches = 0
        dims = {int(s["vectors"].shape[1]) for s in shards
                if s["vectors"].size}
        if len(dims) > 1:
            raise ValueError(f"mixed vector dims across shards: {dims}")
        self.dim = dims.pop() if dims else 0
        self.n_docs_total = sum(int(s["vectors"].shape[0]) for s in shards)
        self.n_pad = round_up_pow2(
            max(max((int(s["vectors"].shape[0]) for s in shards),
                    default=1), 1))
        S = self.n_shards
        vecs = np.zeros((S, self.n_pad, max(self.dim, 1)), np.float32)
        exists = np.zeros((S, self.n_pad), bool)
        for i, s in enumerate(shards):
            v = np.asarray(s["vectors"], np.float32)
            n = v.shape[0]
            if n:
                vecs[i, :n, :] = v
            ex = s.get("exists")
            exists[i, :n] = np.ones(n, bool) if ex is None else ex
        vecs, vnorm2 = prepare_knn_corpus(vecs, similarity)
        vecs[~exists] = 0.0
        vnorm2[~exists] = 0.0
        self.nbytes = vecs.nbytes + vnorm2.nbytes + exists.nbytes
        self._packed = (vecs, vnorm2, exists)
        self.ivf: Optional[IvfKnnTier] = None
        if ivf is not None and exists.any() and self.dim:
            self.ivf = IvfKnnTier.build(vecs, exists, similarity,
                                        device=self.device, **ivf)
            self.nbytes += self.ivf.nbytes()
        self._dev = None

    @staticmethod
    def empty_pad_shard(dim: int) -> dict:
        """Inert shard (zero rows, ``exists`` all false): its rows score
        −inf like padding rows."""
        return dict(vectors=np.zeros((0, max(int(dim), 1)), np.float32),
                    exists=np.zeros(0, bool))

    def _device_arrays(self):
        """(vecs, vnorm2, exists) on the plane's device, uploaded on first
        use; on the card the host copy is then released."""
        if self._dev is None:
            self._dev = tuple(torch.from_numpy(a).to(self.device)
                              for a in self._packed)
            if self.device.type != "cpu":
                self._packed = None
        return self._dev

    def device_corpus_bytes(self) -> int:
        """Bytes the plane holds on its device: vecs f32 + vnorm2 f32 +
        exists bool a padded row, plus the IVF tier."""
        total = self.n_shards * self.n_pad * (max(self.dim, 1) * 4 + 4 + 1)
        if self.ivf is not None:
            total += self.ivf.device_bytes()
        return total

    # -- packed state (wire-compatible with the reference) -------------------

    def export_packed(self) -> dict:
        """Packed invariants and the IVF tier as the reference's
        ``export_packed`` writes them (host numpy), which its
        ``from_packed`` loads."""
        packed = self._packed
        if packed is None:
            packed = tuple(a.cpu().numpy() for a in self._dev)
        vecs, vnorm2, exists = packed
        return dict(similarity=self.similarity, block=self.block,
                    dim=int(self.dim), n_shards=int(self.n_shards),
                    n_docs_total=int(self.n_docs_total),
                    n_pad=int(self.n_pad), nbytes=int(self.nbytes),
                    vecs=vecs, vnorm2=vnorm2, exists=exists,
                    ivf=self.ivf.to_packed() if self.ivf is not None
                    else None)

    @classmethod
    def from_packed(cls, packed: dict, device=None
                    ) -> "DistributedKnnPlane":
        """A plane from ``export_packed`` state (the reference's or the
        port's), with no pack work: no ``prepare_knn_corpus``, no
        k-means."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.similarity = str(packed["similarity"])
        self.block = packed["block"]
        self.n_shards = int(packed["n_shards"])
        self.n_dispatches = 0
        self.dim = int(packed["dim"])
        self.n_docs_total = int(packed["n_docs_total"])
        self.n_pad = int(packed["n_pad"])
        self.nbytes = int(packed["nbytes"])
        self._packed = (np.asarray(packed["vecs"], np.float32),
                        np.asarray(packed["vnorm2"], np.float32),
                        np.asarray(packed["exists"], bool))
        ivf = packed.get("ivf")
        self.ivf = IvfKnnTier.from_packed(ivf) if ivf is not None else None
        self._dev = None
        return self

    # -- serving --------------------------------------------------------------

    def resolve_ann(self, nprobe: Optional[int], rerank: Optional[int]):
        """Effective (nprobe, rerank) of a dispatch, or None for the exact
        scan: ``nprobe=0`` forces exact; None takes the tier's default;
        values clip into [1, nlist] and [1, …]."""
        if self.ivf is None or nprobe == 0:
            return None
        if nprobe is None:
            nprobe = self.ivf.default_nprobe
        nprobe = max(1, min(int(nprobe), self.ivf.nlist))
        rerank = max(1, int(rerank)) if rerank else IVF_DEFAULT_RERANK
        return nprobe, rerank

    def serve(self, query_vectors, k: int = 10,
              stages: Optional[dict] = None, nprobe: Optional[int] = None,
              rerank: Optional[int] = None):
        """Serving entry: the IVF route at the resolved ``nprobe`` /
        ``rerank`` when the plane has a tier, else (or with ``nprobe=0``)
        the exact scan. The reference first routes CPU-built planes to its
        host scorers and demoted planes to a streamed scan; the port has
        neither tier."""
        ann = self.resolve_ann(nprobe, rerank)
        if ann is not None:
            return self.search_ivf(query_vectors, k=k, nprobe=ann[0],
                                   rerank=ann[1], stages=stages)
        return self.search(query_vectors, k=k, stages=stages)

    def _queries(self, query_vectors) -> np.ndarray:
        q = np.asarray(query_vectors, np.float32)
        if q.ndim != 2 or (self.dim and q.shape[1] != self.dim):
            raise ValueError(
                f"query_vectors must be [B, {self.dim}], got {q.shape}")
        return q

    def _sync(self, stages: Optional[dict]) -> None:
        if stages is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def search(self, query_vectors, k: int = 10,
               stages: Optional[dict] = None):
        """Exact top-k over the packed corpus for a batch of query
        vectors: (raw scores f32[B, k'], hits list[list[(shard, local)]]).
        Raw scores are the similarity values (cosine/dot: the dot
        product; l2: ``−‖q−v‖²``). ``stages``: optional dict receiving
        ``prep_ms``, ``dispatch_ms`` (synchronised), ``fetch_ms`` and
        ``kernel``."""
        t0 = time.perf_counter()
        q = self._queries(query_vectors)
        vecs, vnorm2, exists = self._device_arrays()
        q_dev = torch.from_numpy(q).to(self.device)
        t1 = time.perf_counter()
        out = knn_step(vecs, vnorm2, exists, q_dev, n_pad=self.n_pad, k=k,
                       similarity=self.similarity, block=self.block)
        self._sync(stages)
        t2 = time.perf_counter()
        with _COUNT_LOCK:
            self.n_dispatches += 1
        vals = out[0].cpu().numpy()
        hits = decode_hits(vals, out[1].cpu().numpy(), self.n_pad)
        if stages is not None:
            stages["prep_ms"] = (t1 - t0) * 1e3
            stages["dispatch_ms"] = (t2 - t1) * 1e3
            stages["fetch_ms"] = (time.perf_counter() - t2) * 1e3
            stages["kernel"] = "knn_exact"
        return vals, hits

    def _probe_queries(self, q: np.ndarray):
        """Host queries in the packed convention (unit rows for cosine)
        and their Σq."""
        if self.similarity == "cosine":
            qq = q / np.maximum(
                np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        else:
            qq = q
        return qq, np.sum(qq, axis=1)

    def _ivf_probed_docs(self, probed: np.ndarray) -> int:
        """Mean rows per query the probed clusters cover (all shards)."""
        sizes = self.ivf.cluster_sizes
        return int(sizes[probed].sum(axis=1).mean()) if probed.size else 0

    def prepare_ivf(self, query_vectors, k: int, *, nprobe: int,
                    rerank: int) -> dict:
        """Host half of an IVF dispatch: probe the centroids, size the
        union and the window (``r_cand = max(kk, min(rerank·kk, P·blk))``,
        the reference's), upload. Returns the step's arguments and sizes."""
        tier = self.ivf
        q = self._queries(query_vectors)
        qq, _ = self._probe_queries(q)
        probed = tier.probe(qq, nprobe)
        u_blocks, Pw = tier.union_blocks(probed, self.n_shards)
        kk = min(k, self.n_pad)
        r_cand = max(kk, min(rerank * kk, Pw * tier.block))
        dev = tier.device_arrays(self.device, self.n_pad)
        vecs, vnorm2, _ = self._device_arrays()
        args = dict(codes=dev["codes"], scale=dev["scale"], off=dev["off"],
                    rowid=dev["rowid"], rcl=dev["rcl"], vecs=vecs,
                    vnorm2=vnorm2, q=torch.from_numpy(q).to(self.device),
                    probed=torch.from_numpy(probed).to(self.device),
                    u_blocks=torch.from_numpy(u_blocks).to(self.device))
        return dict(args=args, probed=probed, Pw=Pw, r_cand=r_cand, k=k,
                    B=q.shape[0], nprobe=nprobe)

    def search_ivf(self, query_vectors, k: int = 10, *, nprobe: int,
                   rerank: int, stages: Optional[dict] = None):
        """IVF dispatch: the host probe sizes the union, then the step
        scans only its blocks of the quantized tier and re-ranks exactly
        from the f32 tier. Same return convention as :meth:`search`;
        ``stages`` also receives ``kernel``, ``ann_quantized_bytes`` /
        ``ann_exact_bytes`` (what the scan and the re-rank read) and
        ``docs_scanned`` (mean rows a query's clusters cover)."""
        if self.ivf is None:
            raise RuntimeError("plane has no IVF tier")
        t0 = time.perf_counter()
        prep = self.prepare_ivf(query_vectors, k, nprobe=nprobe,
                                rerank=rerank)
        t1 = time.perf_counter()
        out = ivf_knn_step(**prep["args"], n_pad=self.n_pad, k=k,
                           similarity=self.similarity, nlist=self.ivf.nlist,
                           r_cand=prep["r_cand"])
        self._sync(stages)
        t2 = time.perf_counter()
        with _COUNT_LOCK:
            self.n_dispatches += 1
        vals = out[0].cpu().numpy()
        hits = decode_hits(vals, out[1].cpu().numpy(), self.n_pad)
        if stages is not None:
            tier, B, Pw = self.ivf, prep["B"], prep["Pw"]
            meta_b = 12 + (4 if self.similarity == "l2_norm" else 0)
            stages["prep_ms"] = (t1 - t0) * 1e3
            stages["dispatch_ms"] = (t2 - t1) * 1e3
            stages["fetch_ms"] = (time.perf_counter() - t2) * 1e3
            stages["kernel"] = "knn_ivf"
            stages["ann_quantized_bytes"] = self.n_shards * Pw * \
                tier.block * (self.dim * tier.quant_bytes_per_dim() + meta_b)
            stages["ann_exact_bytes"] = self.n_shards * B * \
                prep["r_cand"] * self.dim * 4
            stages["docs_scanned"] = self._ivf_probed_docs(prep["probed"])
        return vals, hits


# ---------------------------------------------------------------------------
# the one-dispatch hybrid: both planes, one step
# ---------------------------------------------------------------------------


def fused_hybrid_step(postings_docs, postings_impact, kvecs, kvn, kex, starts,
                      lengths, idfw, cbits, req, neg, shd, msm, qv, kboost, rc,
                      wt, wk, st2=None, ln2=None, iw2=None, qw=None, rw=None,
                      rwin=None, *, n_pad_t: int, n_pad_k: int, L: int,
                      W_text: int, W_knn: int, k: int, fusion: str,
                      similarity: str, block: Optional[int] = KNN_BLOCK,
                      rescore_mode: str = "total",
                      nc: int = MAX_BOOL_CLAUSES):
    """Body of the reference's ``build_fused_hybrid_step`` over S shards
    of both planes: the text side's bool-tree scoring (K9) and the kNN
    side's exact scan (K6 + K3) per shard, each list's cross-shard reduce
    (K3), then the fusion in the unified id space ``s · UP + doc`` with
    ``UP = max(n_pad_t, n_pad_k)`` (K10). With the rescore query
    (``st2``/``ln2``/``iw2``/``qw``/``rw``/``rwin`` as in
    :func:`bool_bm25_step`), both lists' candidates carry their exact
    rescore scores (K5; kNN rows past the text pad count as empty) through
    the reduces and the fusion, and the window reorders (K11).

    Returns (fused vals f32[B, k], fused ids i32[B, k], text counts i32[B],
    text vals f32[B, out_t], text ids i32[B, out_t], knn vals f32[B,
    out_kn], knn ids i32[B, out_kn]) as the reference does."""
    if fusion not in ("rrf", "sum"):
        raise ValueError(f"unknown fusion [{fusion}]")
    S = postings_docs.shape[0]
    kk_t = min(W_text, n_pad_t)
    out_t = min(W_text, S * n_pad_t)
    kk_k = min(W_knn, n_pad_k)
    out_kn = min(W_knn, S * n_pad_k)
    UP = max(n_pad_t, n_pad_k)
    pad_id = S * UP
    blk, use_blocks = _knn_blocking(block, n_pad_k, kk_k)
    rescore = st2 is not None
    qq = _packed_queries(qv, similarity)
    qn = torch.sum(qv * qv, dim=-1)
    tv, td, cnt = bool_bm25_topk(
        postings_docs, postings_impact, starts, lengths, idfw, cbits, req,
        neg, shd, msm, n_pad=n_pad_t, L=L, k=kk_t, nc=nc)
    kv, kd = knn_shard_scan(kvecs, kvn, kex, qq, qn, similarity=similarity,
                            kk=kk_k, blk=blk, use_blocks=use_blocks)
    if rescore:
        # kNN rows are text docs of the same segment; only the pad differs
        # (a row at or past the text pad, or at -inf, is empty)
        sec_t, fnd_t, sec_k, fnd_k = bisect_exact_scores(
            postings_docs, postings_impact, st2, ln2, iw2, td,
            n_pad=n_pad_t, cand_docs2=kd, cand_vals2=kv)
        tvals, tids, (tsec, tfnd) = _global_topk_reduce(
            tv, td, kk=kk_t, n_pad=n_pad_t, out_k=out_t,
            payload=(sec_t, fnd_t))
        kvals, kids, (ksec, kfnd) = _global_topk_reduce(
            kv, kd, kk=kk_k, n_pad=n_pad_k, out_k=out_kn,
            payload=(sec_k, fnd_k))
    else:
        tvals, tids = _global_topk_reduce(tv, td, kk=kk_t, n_pad=n_pad_t,
                                          out_k=out_t)
        kvals, kids = _global_topk_reduce(kv, kd, kk=kk_k, n_pad=n_pad_k,
                                          out_k=out_kn)
    kw = dict(n_pad_t=n_pad_t, n_pad_k=n_pad_k, UP=UP, pad_id=pad_id,
              fusion=fusion, similarity=similarity)
    if rescore:
        # the payload rides through the fusion in the same launch
        fv, fi, _sel, sec_f, fnd_f = fuse_rank(
            tvals, tids, kvals, kids, wt, wk, rc, kboost, **kw,
            k=tvals.shape[1] + kvals.shape[1], tsec=tsec, tfnd=tfnd,
            ksec=ksec, kfnd=kfnd)
        fv, fi = rescore_reorder(fv, fi, sec_f, fnd_f, qw, rw, rwin,
                                 mode=rescore_mode, k=k, pad_id=pad_id)
    else:
        fv, fi, _sel = fuse_rank(tvals, tids, kvals, kids, wt, wk, rc,
                                 kboost, **kw, k=k)
    return fv, fi, cnt.sum(1), tvals, tids, kvals, kids


def fused_search_device(text_plane: "DistributedSearchPlane",
                        knn_plane: "DistributedKnnPlane", fqs, *,
                        fusion: str, rescore_mode: Optional[str] = None,
                        stages: Optional[dict] = None, extra_docs: int = 0,
                        extra_df: Optional[Dict[str, int]] = None):
    """Serve a batch of planned hybrid queries through one step over both
    planes' tensors (:func:`fused_hybrid_step`).

    ``fqs``: one dict per query: ``clauses``/``msm`` (the lowered bool
    tree), ``qv`` (query vector), ``kboost``, ``rc`` (RRF constant),
    ``wt``/``wk`` (text and kNN rank windows), ``k`` (final size) and,
    with ``rescore_mode``, a ``rescore`` dict (``terms``/``qw``/``rw``/
    ``window``). Every query shares ``fusion`` and ``rescore_mode``.

    Returns (rows, totals, text_rows, knn_rows): ``rows[bi]`` is the fused
    [(score, shard, doc)] ranking cut to that query's ``k``; the text and
    kNN rankings (cut to their windows) ride along. The planes must live
    on one device with equal shard counts; a batch that touches a
    dense-tier term raises ``ValueError``. ``stages`` receives
    ``prep_ms``, ``dispatch_ms`` (synchronised), ``fetch_ms``,
    ``h2d_bytes``, ``d2h_bytes`` and ``docs_scanned``."""
    if text_plane.device != knn_plane.device:
        raise ValueError("fused dispatch needs both planes on one device")
    if text_plane.n_shards != knn_plane.n_shards:
        raise ValueError("fused dispatch needs aligned shard counts")
    t0 = time.perf_counter()
    B = len(fqs)
    dim = max(knn_plane.dim, 1)
    bool_queries = [{"clauses": fq["clauses"], "msm": fq["msm"]}
                    for fq in fqs]
    Q = max(text_plane.SERVING_Q_MIN, round_up_pow2(
        text_plane.bool_slot_count(bool_queries)))
    (starts, lengths, idfw, cbits, req, neg, shd, msm, max_len,
     any_dense) = text_plane.bool_inputs(bool_queries, Q,
                                         extra_docs=extra_docs,
                                         extra_df=extra_df)
    if any_dense:
        raise ValueError("fused batch touches dense-tier terms; the "
                         "sparse-slice fused step cannot serve it")
    L = min(text_plane.ladder_L(max_len), text_plane.L_cap)
    np.minimum(lengths, L, out=lengths)
    qv = np.stack([np.asarray(fq["qv"], np.float32) for fq in fqs]) \
        if B else np.zeros((0, dim), np.float32)
    kboost = np.asarray([fq.get("kboost", 1.0) for fq in fqs], np.float32)
    rc = np.asarray([fq.get("rc", 60.0) for fq in fqs], np.float32)
    wt = np.asarray([fq.get("wt", 0) for fq in fqs], np.int32)
    wk = np.asarray([fq.get("wk", 0) for fq in fqs], np.int32)
    W_text = round_up_pow2(max(int(wt.max(initial=0)), 1))
    W_knn = round_up_pow2(max(int(wk.max(initial=0)), 1))
    up = text_plane._upload
    kvecs, kvn, kex = knn_plane._device_arrays()
    args = dict(postings_docs=text_plane.docs_dev,
                postings_impact=text_plane.impacts_dev, kvecs=kvecs, kvn=kvn,
                kex=kex, starts=up(starts), lengths=up(lengths),
                idfw=up(idfw), cbits=up(cbits), req=up(req), neg=up(neg),
                shd=up(shd), msm=up(msm), qv=up(qv), kboost=up(kboost),
                rc=up(rc), wt=up(wt), wk=up(wk))
    h2d = starts.nbytes + lengths.nbytes + idfw.nbytes + cbits.nbytes \
        + qv.nbytes + 24 * B
    if rescore_mode is not None:
        bags2 = [list(fq["rescore"]["terms"]) for fq in fqs]
        Q2 = max(8, round_up_pow2(max(
            max((len(set(b)) for b in bags2), default=1), 1)))
        (st2, ln2, iw2, _dr, _dh, _ml2, dense2) = text_plane._lookup(
            bags2, Q2, extra_docs=extra_docs, extra_df=extra_df)
        if dense2:
            raise ValueError("fused rescore touches dense-tier terms")
        qw = np.asarray([fq["rescore"]["qw"] for fq in fqs], np.float32)
        rw = np.asarray([fq["rescore"]["rw"] for fq in fqs], np.float32)
        rwin = np.asarray([fq["rescore"]["window"] for fq in fqs], np.int32)
        args.update(st2=up(st2), ln2=up(ln2), iw2=up(iw2), qw=up(qw),
                    rw=up(rw), rwin=up(rwin))
        h2d += st2.nbytes + ln2.nbytes + iw2.nbytes + 12 * B
    t1 = time.perf_counter()
    out = fused_hybrid_step(
        **args, n_pad_t=text_plane.n_pad, n_pad_k=knn_plane.n_pad, L=L,
        W_text=W_text, W_knn=W_knn, k=W_text + W_knn, fusion=fusion,
        similarity=knn_plane.similarity, block=knn_plane.block,
        rescore_mode=rescore_mode or "total")
    if stages is not None and text_plane.device.type == "cuda":
        torch.cuda.synchronize(text_plane.device)
    t2 = time.perf_counter()
    text_plane.n_dispatches += 1
    knn_plane.n_dispatches += 1
    fvals, fids, counts, tvals, tids, kvals, kids = (o.cpu().numpy()
                                                     for o in out)
    UP = max(text_plane.n_pad, knn_plane.n_pad)

    def rows_of(vals, ids, n_pad, cut):
        """[(score, shard, doc)] rows before the first −inf, cut per
        query."""
        hits = decode_hits(vals, ids, n_pad, cut)
        return [[(v, s, d) for v, (s, d) in zip(vals[b].tolist(), h)]
                for b, h in enumerate(hits)]

    cut_f = np.asarray([fq.get("k") or (W_text + W_knn) for fq in fqs],
                       np.int64)
    rows = rows_of(fvals, fids, UP, cut_f)
    text_rows = rows_of(tvals, tids, text_plane.n_pad, wt)
    knn_rows = rows_of(kvals, kids, knn_plane.n_pad, wk)
    totals = [int(c) for c in counts]
    if stages is not None:
        stages["prep_ms"] = (t1 - t0) * 1e3
        stages["dispatch_ms"] = (t2 - t1) * 1e3
        stages["fetch_ms"] = (time.perf_counter() - t2) * 1e3
        stages["h2d_bytes"] = h2d
        stages["d2h_bytes"] = sum(o.nbytes for o in (
            fvals, fids, counts, tvals, tids, kvals, kids))
        stages["docs_scanned"] = text_plane.n_docs_total \
            + knn_plane.n_docs_total
    return rows, totals, text_rows, knn_rows


# ---------------------------------------------------------------------------
# text delta tier (host numpy, as the reference runs it on every backend)
# ---------------------------------------------------------------------------
#
# Under live indexing the serving route (``search/plane_route.py``) splits a
# field into the packed BASE generation plus an append-only DELTA tier:
# delta segments are scored eagerly per query by a CSR scatter-add and
# merged into the base dispatch's top-k. The scorer keeps the kernel
# path's exact tie order (score desc, global segment asc, doc asc), so
# the merged ranking equals a full repack's.


def tie_stable_topk_docs(scores: np.ndarray, kk: int) -> np.ndarray:
    """Doc ids of the top-``kk`` positive scores in (score desc, doc
    asc) order, with the k-th-boundary TIE resolved doc-ascending —
    introselect alone keeps an arbitrary tie member, which breaks the
    kernel paths' tie contract. Bounded: the boundary tie set is
    reduced with a linear partition before any sort, so a corpus where
    millions of docs share the k-th score costs O(N), not
    O(N log N)."""
    n = scores.shape[0]
    if n > kk:
        kth = -np.partition(-scores, kk - 1)[kk - 1]
        if kth <= 0:
            sel = np.flatnonzero(scores > 0)
        else:
            sel = np.flatnonzero(scores > kth)
            need = kk - sel.size
            if need > 0:
                ties = np.flatnonzero(scores == kth)
                if ties.size > need:
                    # smallest `need` doc ids among the boundary ties
                    ties = np.partition(ties, need - 1)[:need]
                sel = np.concatenate([sel, ties])
    else:
        sel = np.flatnonzero(scores > 0)
    order = np.lexsort((sel, -scores[sel]))[:kk]
    return sel[order]


def merge_topk_rows(base_rows, delta_rows, k: int):
    """Merge two per-query candidate lists of ``(value, seg, doc)`` rows
    into the global top-k with the plane's tie order (value desc, seg
    asc, doc asc). Each side covers its own partition's top-k, so the
    union's top-k is the exact global top-k."""
    if not delta_rows:
        return base_rows[:k]
    if not base_rows:
        return delta_rows[:k]
    cat = list(base_rows) + list(delta_rows)
    cat.sort(key=lambda r: (-r[0], r[1], r[2]))
    return cat[:k]


class EagerDeltaScorer:
    """Append-only lexical delta tier: term-at-a-time scatter-add over
    each delta segment's CSR with impacts precomputed ONCE at
    construction.

    ``shards``: one dict per delta segment with ``term_ids``, ``df``,
    ``offsets``, ``docs``, ``tf``, ``doc_len`` (a field-less segment
    passes empty postings but still contributes its doc count).
    ``seg_positions``: each delta segment's index in the CURRENT
    serving segment list — hits are emitted in that global space so the
    merge with base hits preserves (segment, doc) tie order.
    ``avgdl``: the owning generation's FROZEN length norm — the base
    plane's impacts baked it at pack time, so the delta must score under
    the same value or base and delta scores would live on different
    scales (it refreshes at the next repack).

    Host numpy: the arrays alias the segments' own host columns, and the
    only allocation is the impacts column, O(delta postings). The bool
    twin (``score_bool``) comes with the fused route's delta merge."""

    def __init__(self, shards: Sequence[dict], seg_positions: Sequence[int],
                 *, avgdl: float, k1: float = DEFAULT_K1,
                 b: float = DEFAULT_B):
        self.seg_positions = list(seg_positions)
        self.avgdl = max(float(avgdl), 1e-9)
        self.n_docs = 0
        self._csr: List[dict] = []
        for s in shards:
            n = int(s["doc_len"].shape[0])
            self.n_docs += n
            self._csr.append(dict(
                term_ids=s["term_ids"], df=s["df"], offsets=s["offsets"],
                docs=s["docs"],
                impacts=make_impacts(s["tf"], s["docs"], s["doc_len"],
                                     self.avgdl, k1, b),
                n_docs=n))

    def df(self, term: str) -> int:
        """Delta-tier document frequency of ``term`` — fed back into the
        base dispatch as ``extra_df`` so both tiers share one idf."""
        out = 0
        for csr in self._csr:
            tid = csr["term_ids"].get(term)
            if tid is not None:
                out += int(csr["df"][tid])
        return out

    def score(self, queries: Sequence[Sequence[str]], k: int, idf_of,
              with_totals: bool = False):
        """Score a query batch against the delta tier. ``idf_of(term)``
        returns the COMBINED-stats idf (base + delta df over base + delta
        docs) — the same value the base dispatch uses via ``extra_df``.
        Returns (rows per query [(val, global_seg, doc)] sorted by the
        merge order, totals per query)."""
        rows_out: List[List[Tuple[float, int, int]]] = []
        totals: List[int] = []
        for terms in queries:
            weights: Dict[str, float] = {}
            for t in terms:
                weights[t] = weights.get(t, 0.0) + 1.0
            idfw_of = {t: idf_of(t) * w for t, w in weights.items()
                       if idf_of(t) > 0.0}
            rows: List[Tuple[float, int, int]] = []
            total = 0
            for gseg, csr in zip(self.seg_positions, self._csr):
                scores = np.zeros(csr["n_docs"], np.float32)
                matched = False
                for t, idfw in idfw_of.items():
                    tid = csr["term_ids"].get(t)
                    if tid is None:
                        continue
                    st = int(csr["offsets"][tid])
                    en = int(csr["offsets"][tid + 1])
                    if en > st:
                        scores[csr["docs"][st:en]] += \
                            idfw * csr["impacts"][st:en]
                        matched = True
                if not matched:
                    continue
                if with_totals:
                    total += int(np.count_nonzero(scores > 0))
                kk = min(k, csr["n_docs"])
                # tie-stable bounded cut: the k-th-boundary tie must
                # resolve doc-ascending for delta-merge parity
                sel = tie_stable_topk_docs(scores, kk)
                rows.extend((float(scores[d]), gseg, int(d)) for d in sel)
            rows.sort(key=lambda r: (-r[0], r[1], r[2]))
            rows_out.append(rows[:k])
            totals.append(total)
        return rows_out, totals
