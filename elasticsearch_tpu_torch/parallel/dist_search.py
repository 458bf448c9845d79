"""Batched BM25 serving plane on one device (port of the lexical part of
``elasticsearch_tpu/parallel/dist_search.py``).

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
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.bm25 import DEFAULT_B, DEFAULT_K1, idf_weight
from ..ops.sorted_merge import make_impacts, sparse_candidates_topk
from ..ops.tiered_bm25 import (build_dense_rows, split_tiers,
                               tiered_bm25_topk)
from ..ops.topk import topk_merge
from ..utils.shapes import round_up_multiple, round_up_pow2

NEG_INF = float("-inf")


# ---------------------------------------------------------------------------
# step bodies over [S, ...] tensors
# ---------------------------------------------------------------------------


def _global_topk_reduce(vals, idx, *, kk: int, n_pad: int,
                        out_k: Optional[int] = None):
    """Cross-shard reduce: [B, S, kk] shard-local lists → ([B, w], [B, w])
    with w = min(out_k, S·kk), ids globalised as ``s · n_pad + local``."""
    out_k = kk if out_k is None else out_k
    B, S, _ = vals.shape
    return topk_merge(vals.reshape(B, S * kk), idx.reshape(B, S * kk),
                      k=min(out_k, S * kk), fill_id=S * n_pad, seg_len=kk,
                      seg_stride=n_pad)


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
    """

    #: dense-tier block width (docs per streamed block)
    DENSE_BLOCK = 1 << 19
    #: dense-tier row budget per shard (memory cap: T × n_pad × 2B each)
    MAX_DENSE_TERMS = 256
    #: serving Q floor (see :meth:`serve`)
    SERVING_Q_MIN = 8

    def __init__(self, shards: Sequence[dict], field: str, *,
                 device=None, k1: float = DEFAULT_K1, b: float = DEFAULT_B,
                 dense_threshold: Optional[int] = None):
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
        return int(total)

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
        dev = self.device

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                dev, non_blocking=True)

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
        gdocs = out[1].cpu().numpy()
        hits = []
        for bi in range(len(queries)):
            row = []
            for v, g in zip(vals[bi], gdocs[bi]):
                if v == NEG_INF:
                    break
                row.append((int(g) // self.n_pad, int(g) % self.n_pad))
            hits.append(row)
        if stages is not None:
            stages["prep_ms"] = (t1 - t0) * 1e3
            stages["dispatch_ms"] = (t2 - t1) * 1e3
            stages["fetch_ms"] = (time.perf_counter() - t2) * 1e3
        if with_totals:
            totals = [int(c) for c in out[2].cpu().numpy()]
            return vals, hits, totals
        return vals, hits

    def serve(self, queries: Sequence[Sequence[str]], k: int = 10,
              *, with_totals: bool = False, stages: Optional[dict] = None,
              extra_docs: int = 0,
              extra_df: Optional[Dict[str, int]] = None):
        """Serving entry: :meth:`search` at the stable serving shapes —
        ladder-rung L, Q floored to ``SERVING_Q_MIN`` — so live traffic
        meets a small fixed lattice of launch shapes. (The reference's
        block-max pruned and host-eager routes are not ported yet.)"""
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


def plane_state_from_numpy(packed: dict, *, device="cpu") -> dict:
    """The reference plane's packed host arrays (``docs`` i32[S, P],
    ``impacts`` f32[S, P], ``dense`` bf16-as-any[S, n_blk, T, C] or its
    int16 bit pattern ``dense_bits``) as the port's device tensors."""
    out = dict(docs=torch.from_numpy(np.array(
                   packed["docs"], np.int32)).to(device),
               impacts=torch.from_numpy(np.array(
                   packed["impacts"], np.float32)).to(device))
    bits = packed.get("dense_bits")
    if bits is None and packed.get("dense") is not None:
        bits = np.asarray(packed["dense"]).view(np.int16)
    if bits is not None:
        out["dense"] = torch.from_numpy(np.array(
            bits, np.int16)).view(torch.bfloat16).to(device)
    return out
