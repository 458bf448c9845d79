"""K3's launch plan (``topk_merge_plan``) and K21's layout: how K3
splits a row into segments over several blocks and bounds the merge of
their lists, and what K21's tile sizes in ``csrc/knn_outlier.cu`` give:
which tile holds a block's diagonal, and how long a list a block holds.

K3's plan is plain Python, so it is held here, on the CPU, at the shapes
of ``chip_smoke.py``'s main paths and of the card tests. K21 has no
Python plan: its sizes are read from its source. The card tests
(``tests/test_torch_cuda.py``) hold the kernels to their plain versions.
"""

import math
import re

import pytest

from elasticsearch_tpu_torch.kernels.build import CSRC_DIR
from elasticsearch_tpu_torch.ops.knn import K6_BITMAP_TILES, scan_chunks
from elasticsearch_tpu_torch.ops.topk import (
    H100_SHARED_OPTIN, K3_BLOCKS_PER_SM, K3_SEGMENT_MIN, K3_STATIC_SHARED,
    k3_block_bytes, k3_segment_max, k3_survivors, topk_merge_plan,
    topk_merge_row_max)

#: the H100's SMs
N_SM = 132
ROOM = H100_SHARED_OPTIN - K3_STATIC_SHARED

K3_SHAPES = [
    # chip_smoke.py's recorded calls (R, m, k, dedup). The headline: K2's
    # 256 tile lists, the dedup merge of two lists, the shard reduce
    (64, 2560, 10, False), (64, 20, 10, True), (64, 10, 10, False),
    # exact kNN: 264 chunk lists of 100 in one call, the shard reduce
    (16, 26400, 100, False), (16, 100, 100, False),
    # the hybrid: 132 chunk lists of 128 in one call, two shard reduces
    (16, 16896, 128, False), (16, 128, 128, False),
    # the parent's two-stage reduce of the hybrid's lists
    (64, 4224, 128, False), (16, 512, 128, False),
    # the card tests: long rows, dedup, large survivors, a merge past
    # shared memory, deep pages in device memory, k past the row
    (4, 30000, 128, False), (4, 40000, 100, True), (3, 40000, 2000, False),
    (1, 1_000_000, 2000, False), (4, 30000, 10000, True),
    (6, 15000, 10000, False), (6, 70, 300, False), (12, 3000, 100, False),
    (6, 3000, 100, True)]


@pytest.mark.parametrize("R,m,k,dedup", K3_SHAPES)
def test_k3_segments_cover_the_row(R, m, k, dedup):
    """G segments of L columns cover [0, m) once, none empty; a split row
    keeps at least 2k entries a segment and ``K3_SEGMENT_MIN`` unless a
    segment must be shorter to fit a block."""
    p = topk_merge_plan(R, m, k, dedup, N_SM)
    G, L = p["G"], p["L"]
    cols = [c for g in range(G) for c in range(g * L, min((g + 1) * L, m))]
    assert cols == list(range(m))
    assert all(g * L < m for g in range(G)) or m == 0
    assert p["blocks"] == R * G
    if G > 1:
        assert L >= 2 * k
        assert L >= K3_SEGMENT_MIN or L <= k3_segment_max(k, dedup)


@pytest.mark.parametrize("R,m,k,dedup", K3_SHAPES)
def test_k3_buffers_fit_or_go_to_the_workspace(R, m, k, dedup):
    """Each kernel's survivor buffer is a power of two holding the k best
    (the whole segment with dedup, which sorts it); a block's buffers go
    to the workspace exactly when they pass a block's shared memory, and
    the workspace holds them and the partial lists."""
    p = topk_merge_plan(R, m, k, dedup, N_SM)
    G, L, S0, S1 = p["G"], p["L"], p["S0"], p["S1"]
    for S in (S0, S1):
        assert S & (S - 1) == 0
    assert S0 >= min(k, L) and (not dedup or S0 >= L)
    assert p["glob0"] == (k3_block_bytes(L, S0) > ROOM)
    ws = 0
    if G > 1:
        assert S1 >= k and (not dedup or S1 >= G * k)
        assert p["merge_entries"] == G * k
        assert p["glob1"] == (k3_block_bytes(G * k, S1) > ROOM)
        ws = -(-R * G * k * 12 // 16) * 16
    else:
        assert not p["glob1"] and p["merge_entries"] == 0
    ws += R * G * k3_block_bytes(L, S0) if p["glob0"] else 0
    ws += R * k3_block_bytes(G * k, S1) if p["glob1"] else 0
    assert p["workspace_bytes"] == ws


@pytest.mark.parametrize("R,m,k,dedup", K3_SHAPES)
def test_k3_merge_bounds(R, m, k, dedup):
    """The merge's row (G lists of k) stays in a block's shared memory
    unless the segments need more blocks than that allows, and a launch
    stays within one wave of ``K3_BLOCKS_PER_SM`` blocks an SM unless the
    segments must be more to fit."""
    p = topk_merge_plan(R, m, k, dedup, N_SM)
    G, L = p["G"], p["L"]
    seg = k3_segment_max(k, dedup)
    forced = seg >= 2 * k and G == -(-m // seg) and G > 1
    if G > 1 and not forced:
        assert G * k <= seg and not p["glob1"]
        assert R * G <= K3_BLOCKS_PER_SM * N_SM
    if not p["glob0"]:
        assert L <= seg


@pytest.mark.parametrize("R,m,k,G,L,blocks", [
    # the hybrid's chunk reduce: 11 segments of 1,536, 176 blocks on 132
    # SMs, a merge of 11 lists (1,408 entries)
    (16, 16896, 128, 11, 1536, 176),
    # exact kNN's: 16 segments of 1,650, a merge of 1,600
    (16, 26400, 100, 16, 1650, 256),
    # the headline's tile reduce: two segments of 1,280
    (64, 2560, 10, 2, 1280, 128),
    # short rows take one block a row
    (16, 128, 128, 1, 128, 16), (64, 20, 10, 1, 20, 64),
    (16, 512, 128, 1, 512, 16)])
def test_k3_plan_at_the_main_paths(R, m, k, G, L, blocks):
    """The plan at ``chip_smoke.py``'s shapes: √(m / k) segments balance a
    segment against the merge (segments of at least ``K3_SEGMENT_MIN``),
    and a long row's segments fill the card."""
    p = topk_merge_plan(R, m, k, False, N_SM)
    assert (p["G"], p["L"], p["blocks"]) == (G, L, blocks)
    assert G == 1 or G == min(round(math.sqrt(m / k)), m // K3_SEGMENT_MIN)
    if m >= 16 * K3_SEGMENT_MIN:
        assert p["blocks"] >= N_SM
    assert not p["glob0"] and not p["glob1"]


@pytest.mark.parametrize("k", [1, 10, 100, 128, 1000, 2000, 10000])
def test_k3_row_max_keeps_both_kernels_in_shared_memory(k):
    """``topk_merge_row_max``, the cap K6 and K7 put on their chunk
    lists: at least 2^15 entries, and a row of lists of k that long plans
    with both kernels' buffers in shared memory wherever it passes 2^15."""
    row = topk_merge_row_max(k)
    assert row >= 1 << 15
    m = (row // k) * k
    if m > 1 << 15:
        p = topk_merge_plan(16, m, k, False, N_SM)
        assert not p["glob0"] and not p["glob1"]
    assert k3_survivors(k3_segment_max(k, False), k, False) >= min(
        k, k3_segment_max(k, False))


@pytest.mark.parametrize("rows,k,per_sm,want", [
    # K3 no longer caps K6's chunks at 2^15 // k: at k = 2,000 the row
    # may hold 52 lists (105,728 entries), at k = 1,000 291 (the grid's
    # 528 blocks are cut to 264, a multiple of the SMs)
    (1 << 21, 2000, 4, 52), (1 << 21, 1000, 4, 264),
    # past shared memory even for two lists: the 2^15-entry floor
    (1 << 21, 10000, 2, 3)])
def test_scan_chunks_cap_follows_k3(rows, k, per_sm, want):
    assert scan_chunks(rows, k, 1, 16, N_SM, per_sm,
                       K6_BITMAP_TILES) == want
    assert want * k <= topk_merge_row_max(k)


K21_SRC = (CSRC_DIR / "knn_outlier.cu").read_text()
#: the integer sizes ``csrc/knn_outlier.cu`` defines (K21_BM, K21_BN, ...)
K21 = {m[1]: int(m[2]) for m in
       re.finditer(r"^#define K21_(\w+) (\d+)$", K21_SRC, re.M)}


def test_k21_layout_from_the_source():
    """A block's rows lie in one column tile (the one it peels for the
    diagonal, ``r0 / K21_BN``), and its threads' register tiles (``tid &
    15`` the columns, ``tid >> 4`` the rows) cover its rows and a tile's
    columns once."""
    bm, bn, tm, tn = K21["BM"], K21["BN"], K21["TM"], K21["TN"]
    assert bn % bm == 0
    assert "const int diag = r0 / K21_BN;" in K21_SRC
    assert "const int tx = tid & 15, ty = tid >> 4;" in K21_SRC
    assert bn // tn == 16 and bm // tm == K21["THREADS"] // 16


@pytest.mark.parametrize("shared", [H100_SHARED_OPTIN, 166912, 101376])
def test_k21_kk_limit(shared):
    """A block holds K21_BM lists of kk floats beside its static bytes
    (two stages of K21_SUB tiles of K21_BN columns x K21_FC features, and
    their squared norms): on the H100 the longest is 764, above the 445
    of the one-thread-a-row kernel."""
    for decl in ("cols_s[2][K21_SUB * K21_BN * K21_FC]",
                 "sqc_s[2][K21_SUB * K21_BN]",
                 "(size_t)kk * K21_BM * sizeof(float)"):
        assert decl in K21_SRC
    static = 2 * K21["SUB"] * K21["BN"] * (K21["FC"] + 1) * 4
    assert static == 36864
    kk_max = (shared - static) // (4 * K21["BM"])
    assert static + 4 * K21["BM"] * kk_max <= shared
    assert static + 4 * K21["BM"] * (kk_max + 1) > shared
    if shared == H100_SHARED_OPTIN:
        assert kk_max == 764 and kk_max >= 445
