"""Block-max pruned scan (the ``per_query`` scan of
``build_pruned_bm25_step`` in ``elasticsearch_tpu/parallel/dist_search.py``)
and the wrapper of kernel K4 (``csrc/blockmax_scan.cu``).

Each (query, shard) walks its descending-bound block schedule. Before each
step it reads the rank-safety threshold θ = window[kq_idx] − slack (−inf
when pruning is inert); a step is live iff its block is real and its
remaining bound mass ρ ≥ θ. A live step adds ``w · max(scale·q + off,
1e-9)`` for each of the block's docs into a dense f32 accumulator and
merges the docs' new partials into a top-W window of values. After the
scan come the matched count (docs with a positive partial), the top-R
survivors (ties to the lower doc), the safety verdict, and the survivors
in doc-ascending order (``n_pad`` on empty slots).

The reference runs a fixed-trip masked scan. A schedule's ρ never rises
and its pad steps come only at its end, and θ never falls, so no step
after the first non-live one is live: the scan stops there, and a real
step that stops it gives ``rho_stop``, the same outputs as the masked
scan. The plain version refuses a schedule that breaks either rule.

Arithmetic follows what XLA:CPU compiles for the reference: it contracts
``scale·q + off`` into one fused multiply-add, so the plain version forms
that FMA exactly (f64 with round-to-odd, then one rounding to f32) and the
kernel calls ``__fmaf_rn``; the product with ``w`` and the accumulator add
are separately rounded f32 operations.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..kernels import build as _kb
from .sorted_merge import sm_count
from .topk import topk_stable

NEG_INF = float("-inf")

#: survivor blocks a K4 launch aims at per SM over its (query, shard) rows
SURVIVOR_BLOCKS_PER_SM = 8
#: the most list entries (G·R) K4's finish merges for one row
SURVIVOR_MERGE_MAX = 4096


def blockmax_scan_plan(B: int, S: int, R: int, n_sm: int) -> dict:
    """K4's launch shape: one scan block a (query, shard) row, then G
    survivor blocks a row, each over its slice of the row's scored
    postings (block g takes postings [g·c, (g + 1)·c) of the n_sc·block,
    c = ceil(n_sc·block / G)). G is the power of two (the finish
    sorts the G·R entries of a row as one) nearest below what gives
    ``SURVIVOR_BLOCKS_PER_SM`` blocks an SM over the B·S rows, with G·R at
    most ``SURVIVOR_MERGE_MAX`` (so that sort stays in shared memory; G = 1
    when R alone passes it, or when B·S alone fills the card)."""
    want = -(-SURVIVOR_BLOCKS_PER_SM * n_sm // max(B * S, 1))
    G = max(1, min(want, SURVIVOR_MERGE_MAX // max(R, 1)))
    return dict(G=1 << (G.bit_length() - 1))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """Correctly rounded f32 ``a·b + c`` (one rounding, as ``fmaf``).

    The f64 product of two f32 values is exact; the f64 sum is made
    round-to-odd from its exact error (TwoSum), and a round-to-odd value
    with 29 spare bits rounds to f32 exactly as the exact sum would."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - c
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, NEG_INF))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def blockmax_scan_plain(t_docs, t_codes, t_scale, t_off, sched, w, rho,
                        slack, *, n_pad: int, NB: int, W: int, R: int,
                        kq_idx: int, prune_active: bool):
    """Plain version of K4 (see :func:`blockmax_scan`): a step loop per
    (query, shard), its control flow on the host."""
    B, S, P = sched.shape
    dev = t_docs.device
    sched_h = sched.cpu().numpy()
    rho_h = rho.cpu().numpy()
    slack_h = slack.cpu().numpy()
    floor = torch.tensor(1e-9, dtype=torch.float32, device=dev)
    ci = torch.full((B, S, R), n_pad, dtype=torch.int32, device=dev)
    cv = torch.full((B, S, R), NEG_INF, dtype=torch.float32, device=dev)
    counts = np.zeros((4, B, S), np.int32)    # matched, unsafe, pruned, n_sc
    n_real = (sched_h != NB).sum(-1)
    real_first = (sched_h != NB) == (np.arange(P) < n_real[..., None])
    rises = (np.diff(rho_h, axis=-1) > 0) & (sched_h[..., 1:] != NB)
    if not real_first.all() or rises.any():
        raise ValueError("blockmax_scan: a schedule must hold its real "
                         "steps first, with rho non-increasing over them")
    for b in range(B):
        for s in range(S):
            sch, rh = sched_h[b, s], rho_h[b, s]
            slk = np.float32(slack_h[b, s])
            acc_q = torch.zeros(n_pad, dtype=torch.float32, device=dev)
            win = torch.full((W,), NEG_INF, dtype=torch.float32, device=dev)
            pruned, rho_stop, n_sc = False, np.float32(NEG_INF), 0

            def theta():
                if not prune_active:
                    return np.float32(NEG_INF)
                return np.float32(win[kq_idx].item()) - slk

            for i in range(P):
                th = theta()
                if sch[i] == NB:
                    break
                if not rh[i] >= th:
                    pruned, rho_stop = True, np.float32(rh[i])
                    break
                blk = int(sch[i])
                d = t_docs[s, blk].long()
                vhat = torch.maximum(fma_f32(t_scale[s, blk],
                                             t_codes[s, blk].float(),
                                             t_off[s, blk]), floor)
                real_d = d < n_pad
                dd = d[real_d]
                acc_q[dd] = acc_q[dd] + w[b, s, i] * vhat[real_d]
                win = torch.sort(torch.cat([win, acc_q[dd]]),
                                 descending=True).values[:W]
                n_sc += 1
            theta_end = theta()
            seen = acc_q > 0
            matched = int(seen.sum())
            rr = min(R, n_pad)
            v, idx = topk_stable(torch.where(seen, acc_q, NEG_INF), rr)
            cv_last = np.float32(v[-1].item())
            rho_eff = max(rho_stop, np.float32(0.0))
            unsafe = (matched > rr and cv_last + slk >= theta_end) or \
                (pruned and (cv_last + slk) + rho_eff >= theta_end)
            idx = torch.where(v == NEG_INF, n_pad, idx)
            order = torch.sort(idx, stable=True).indices
            ci[b, s, :rr] = idx[order]
            cv[b, s, :rr] = v[order]
            counts[:, b, s] = (matched, int(unsafe), int(pruned), n_sc)
    out = torch.from_numpy(counts).to(dev)
    return ci, cv, out[0], out[1], out[2], out[3]


def blockmax_scan(t_docs, t_codes, t_scale, t_off, sched, w, rho, slack, *,
                  n_pad: int, NB: int, W: int, R: int, kq_idx: int,
                  prune_active: bool, acc: Optional[torch.Tensor] = None):
    """The block-max pruned scan of a batch over S shards (K4).

    t_docs i32[S, NB+1, BS] / t_codes int8[S, NB+1, BS] / t_scale, t_off
    f32[S, NB+1]: the quantized block tier (row NB an all-``n_pad`` pad
    block); sched i32[B, S, P] block ids (``NB`` past a schedule's end),
    w f32[B, S, P] the block's term weight, rho f32[B, S, P] the bound mass
    left before each step, slack f32[B, S]. A schedule holds its real steps
    first and its ρ never rises over them (:meth:`BlockMaxTier.schedule`
    builds it so); the scan stops at its first step that is not live.
    W (≤ 1024) is the window
    width, R the survivor count (a power of two), ``kq_idx`` the window
    slot θ reads, ``prune_active`` False makes θ −inf.

    ``acc``: a zeroed f32[≥ B·S, n_pad] workspace; the kernel adds into
    row b·S + s and leaves it zeroed again (None allocates one).

    Returns (ci i32[B, S, R] survivors doc-ascending, ``n_pad`` on empty
    slots; cv f32[B, S, R] their partials, −inf there; matched, unsafe,
    pruned, n_sc i32[B, S]).

    A CPU tensor runs the plain version; a CUDA tensor launches K4 (the
    scan a row, its survivors over the G blocks a row of
    :func:`blockmax_scan_plan` and their merge, in one launch call).
    """
    dev = t_docs.device
    kw = dict(n_pad=n_pad, NB=NB, W=W, R=R, kq_idx=kq_idx,
              prune_active=prune_active)
    if dev.type == "cpu":
        return blockmax_scan_plain(t_docs, t_codes, t_scale, t_off, sched,
                                   w, rho, slack, **kw)
    if dev.type != "cuda":
        raise ValueError(f"blockmax_scan: unsupported device {dev}")
    S, NB1, BS = t_docs.shape
    B, _, P = sched.shape
    _kb.check(t_docs, "t_docs", torch.int32, (S, NB1, BS), dev)
    _kb.check(t_codes, "t_codes", torch.int8, (S, NB1, BS), dev)
    _kb.check(t_scale, "t_scale", torch.float32, (S, NB1), dev)
    _kb.check(t_off, "t_off", torch.float32, (S, NB1), dev)
    _kb.check(sched, "sched", torch.int32, (B, S, P), dev)
    _kb.check(w, "w", torch.float32, (B, S, P), dev)
    _kb.check(rho, "rho", torch.float32, (B, S, P), dev)
    _kb.check(slack, "slack", torch.float32, (B, S), dev)
    if NB1 != NB + 1:
        raise ValueError(f"blockmax_scan: tier has {NB1} rows, NB={NB}")
    if R < 1 or R & (R - 1) or R > n_pad:
        raise ValueError(f"blockmax_scan: R={R} must be a power of two "
                         f"<= n_pad")
    if not 1 <= W <= 1024 or not 0 <= kq_idx < W:
        raise ValueError(f"blockmax_scan: W={W}, kq_idx={kq_idx}")
    rows = B * S
    if acc is None:
        acc = torch.zeros((rows, n_pad), dtype=torch.float32, device=dev)
    elif (acc.dtype != torch.float32 or acc.device != dev
          or acc.dim() != 2 or acc.shape[0] < rows
          or acc.shape[1] != n_pad or not acc.is_contiguous()):
        raise ValueError(f"blockmax_scan: acc must be a contiguous f32 "
                         f"[>= {rows}, {n_pad}] workspace on {dev}")
    ci = torch.empty((B, S, R), dtype=torch.int32, device=dev)
    cv = torch.empty((B, S, R), dtype=torch.float32, device=dev)
    counts = torch.empty((4, B, S), dtype=torch.int32, device=dev)
    if rows == 0:
        return ci, cv, counts[0], counts[1], counts[2], counts[3]
    G = blockmax_scan_plan(B, S, R, sm_count(dev))["G"]
    # the survivor blocks' lists and counts, and the rows' scan states
    part = torch.empty(rows * G * (2 * R + 1) + 4 * rows, dtype=torch.int32,
                       device=dev)
    _kb.launch("blockmax_scan", dev, t_docs.data_ptr(), t_codes.data_ptr(),
               t_scale.data_ptr(), t_off.data_ptr(), NB1, BS,
               sched.data_ptr(), w.data_ptr(), rho.data_ptr(),
               slack.data_ptr(), B, S, P, n_pad, NB, W, R, kq_idx,
               int(prune_active), G, acc.data_ptr(), part.data_ptr(),
               ci.data_ptr(), cv.data_ptr(), counts.data_ptr())
    return ci, cv, counts[0], counts[1], counts[2], counts[3]
