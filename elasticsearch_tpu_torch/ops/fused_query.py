"""Exact bisect re-score (port of ``bisect_exact_scores`` in
``elasticsearch_tpu/ops/fused_query.py``) and the wrapper of kernel K5
(``csrc/bisect_exact_scores.cu``).

The block-max pruned step keeps a window of survivors from its quantized
scan and scores each one exactly here: a binary search per (candidate,
term slot) over the doc-sorted sparse table, then an f32 sum in the
sorted-merge kernel's order (highest slot first), so a survivor's score is
bitwise the eager step's score of the same doc. The rest of the reference
module (bool trees, rank fusion) is still to be ported.
"""

from __future__ import annotations

import math

import torch

from ..kernels import build as _kb


def bisect_exact_scores_plain(postings_docs, postings_impact, starts,
                              lengths, idfw, cand_docs, *, n_pad: int):
    """Plain version of K5 (see :func:`bisect_exact_scores`): the
    reference's fixed-trip vectorised bisect."""
    B, S, Q = starts.shape
    R = cand_docs.shape[2]
    P = postings_docs.shape[1]
    dev = postings_docs.device
    flat_d = postings_docs.reshape(-1)
    flat_i = postings_impact.reshape(-1)
    base = (torch.arange(S, device=dev) * P)[None, :, None, None]
    lo = starts.long()[:, :, None, :].expand(B, S, R, Q)
    end = lo + lengths.long()[:, :, None, :]
    hi = end
    doc = cand_docs.long()[..., None]

    def at(table, pos):
        return table[base + pos.clamp(0, P - 1)]

    for _ in range(max(int(math.ceil(math.log2(P + 1))) + 1, 1)):
        cont = lo < hi
        mid = (lo + hi) // 2
        go = at(flat_d, mid).long() < doc
        lo = torch.where(cont & go, mid + 1, lo)
        hi = torch.where(cont & ~go, mid, hi)
    found = (lo < end) & (at(flat_d, lo).long() == doc)
    c = torch.where(found, idfw[:, None, None, :] * at(flat_i, lo),
                    torch.zeros((), dtype=torch.float32, device=dev))
    score = c[..., Q - 1]
    for q in range(Q - 2, -1, -1):
        score = score + c[..., q]
    live = cand_docs < n_pad
    return (torch.where(live, score, torch.zeros_like(score)),
            found.any(-1) & live)


def bisect_exact_scores(postings_docs, postings_impact, starts, lengths,
                        idfw, cand_docs, *, n_pad: int):
    """Exact f32 scores of candidates against each query's term runs (K5).

    postings_docs i32[S, P] / postings_impact f32[S, P]: the sparse table;
    starts / lengths i32[B, S, Q]: every slot's whole run; idfw f32[B, Q];
    cand_docs i32[B, S, R]: shard-local docs, ``n_pad`` on empty slots.

    Returns (scores f32[B, S, R], found_any bool[B, S, R]): a slot holding
    the candidate adds ``idfw · impact``, summed from the highest slot
    down; empty slots score 0 and are not found.

    A CPU tensor runs the plain version; a CUDA tensor launches K5.
    """
    dev = postings_docs.device
    if dev.type == "cpu":
        return bisect_exact_scores_plain(postings_docs, postings_impact,
                                         starts, lengths, idfw, cand_docs,
                                         n_pad=n_pad)
    if dev.type != "cuda":
        raise ValueError(f"bisect_exact_scores: unsupported device {dev}")
    S, P = postings_docs.shape
    B, _, Q = starts.shape
    R = cand_docs.shape[2]
    _kb.check(postings_docs, "postings_docs", torch.int32, (S, P), dev)
    _kb.check(postings_impact, "postings_impact", torch.float32, (S, P), dev)
    _kb.check(starts, "starts", torch.int32, (B, S, Q), dev)
    _kb.check(lengths, "lengths", torch.int32, (B, S, Q), dev)
    _kb.check(idfw, "idfw", torch.float32, (B, Q), dev)
    _kb.check(cand_docs, "cand_docs", torch.int32, (B, S, R), dev)
    score = torch.empty((B, S, R), dtype=torch.float32, device=dev)
    found = torch.empty((B, S, R), dtype=torch.bool, device=dev)
    if B * S * R == 0:
        return score, found
    _kb.launch("bisect_exact_scores", dev, postings_docs.data_ptr(),
               postings_impact.data_ptr(), P, starts.data_ptr(),
               lengths.data_ptr(), idfw.data_ptr(), cand_docs.data_ptr(),
               B, S, Q, R, n_pad, score.data_ptr(), found.data_ptr())
    return score, found
