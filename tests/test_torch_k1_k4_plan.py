"""K1's and K4's launch plans (``sparse_candidates_topk_plan``,
``blockmax_scan_plan``): how K1 splits each (query, shard)'s docs into
ranges of tiles, one block a range, and how many survivor blocks K4 gives
a row's scored postings.

The plans are plain Python, so they are held here, on the CPU, at the
shapes of ``chip_smoke.py``'s main paths and of the card tests; the card
tests (``tests/test_torch_cuda.py``) hold the kernels that run them to
their plain versions.
"""

import pytest

from elasticsearch_tpu_torch.ops.blockmax import (SURVIVOR_BLOCKS_PER_SM,
                                                  SURVIVOR_MERGE_MAX,
                                                  blockmax_scan_plan)
from elasticsearch_tpu_torch.ops.sorted_merge import (
    SPARSE_TILE_SHIFT, TILE_BLOCKS_PER_SM, TILE_MERGE_MAX, TILE_SHIFT,
    sparse_candidates_topk_plan)

#: the H100's SMs
N_SM = 132

K1_SHAPES = [
    # chip_smoke.py: the pruned route's fallback at mix (a), the headline
    (1 << 22, 16, 1, 8, 1 << 22, 10), (1 << 23, 64, 1, 4, 1 << 17, 10),
    # the card tests: tile and range edges, every msm, k = 30,000
    (1 << 20, 8, 1, 6, 10926, 10), (1 << 20, 8, 3, 6, 10926, 128),
    (1 << 20, 8, 2, 6, 349526, 128), (1 << 15, 8, 1, 6, 10923, 30000),
    (1 << 18, 8, 2, 6, 87382, 128),
    # n_pad not a multiple of the tile; one tile; no docs; many slots
    (3 * (1 << TILE_SHIFT) + 1234, 8, 2, 6, 3689, 10),
    ((1 << TILE_SHIFT) - 7, 1, 1, 1, 16, 10), (0, 4, 1, 8, 16, 10),
    (64, 1, 1, 10000, 16, 10)]


@pytest.mark.parametrize("n_pad,B,S,Q,L,k", K1_SHAPES)
def test_k1_tiles_cover_the_docs_once(n_pad, B, S, Q, L, k):
    """The blocks' tile ranges, as the kernel walks them (block g: tiles
    [g·tpb, (g + 1)·tpb) less those past the last), cover [0, n_pad)
    exactly once, every block has a tile, and the tile size is 2^12 where
    the slots hold at most one posting a doc (Q·L <= n_pad), else 2^11."""
    plan = sparse_candidates_topk_plan(n_pad, B, S, Q, L, k, N_SM)
    T, G, tpb = plan["tile"], plan["G"], plan["tiles_per_block"]
    assert plan["tile_shift"] == (SPARSE_TILE_SHIFT if Q * L <= n_pad
                                  else TILE_SHIFT)
    assert T == 1 << plan["tile_shift"]
    n_tiles = plan["n_tiles"]
    docs = []
    for g in range(G):
        tiles = range(g * tpb, min((g + 1) * tpb, n_tiles))
        assert len(tiles) > 0 or n_tiles == 0
        for t in tiles:
            docs.extend(range(t * T, min((t + 1) * T, n_pad)))
    assert docs == list(range(n_pad))
    assert 1 <= plan["edge_tiles"] <= max(tpb, 1)


@pytest.mark.parametrize("n_pad,B,S,Q,L,k", K1_SHAPES)
def test_k1_plan_bounds_the_merge_and_fills_the_card(n_pad, B, S, Q, L, k):
    """G·k stays within ``TILE_MERGE_MAX`` (or G = 1), and where the
    merge allows it the grid fills the card: at least half of
    ``TILE_BLOCKS_PER_SM`` blocks an SM over the B·S (query, shard)
    pairs, unless there are fewer tiles than that."""
    plan = sparse_candidates_topk_plan(n_pad, B, S, Q, L, k, N_SM)
    G = plan["G"]
    assert G * k <= TILE_MERGE_MAX or G == 1
    want = TILE_BLOCKS_PER_SM * N_SM
    if 2 * G * k <= TILE_MERGE_MAX and 2 * G <= plan["n_tiles"]:
        assert B * S * G >= want // 2


@pytest.mark.parametrize("B,S,G", [
    # the fallback: 64 blocks a query over 2,048 tiles of 2^11 docs
    (16, 1, 64),
    # B·S alone fills the card: one block a (query, shard), no merge
    (TILE_BLOCKS_PER_SM * N_SM, 1, 1), (512, 4, 1)])
def test_k1_plan_one_block_where_the_batch_fills_the_card(B, S, G):
    plan = sparse_candidates_topk_plan(1 << 22, B, S, 8, 1 << 22, 10, N_SM)
    assert plan["G"] == G


def test_k1_plan_at_the_headline():
    """The headline's short sparse runs: tiles of 2^12 docs, 17 blocks a
    query (1,088 in all), each walking 121 tiles in one window."""
    plan = sparse_candidates_topk_plan(1 << 23, 64, 1, 4, 1 << 17, 10, N_SM)
    assert (plan["tile"], plan["G"], plan["tiles_per_block"],
            plan["edge_tiles"]) == (4096, 17, 121, 121)


@pytest.mark.parametrize("B,S,R,G", [
    # chip_smoke.py's pruned mixes: 16 rows at R = 128
    (16, 1, 128, 32),
    # 66 blocks a row would fill the card: the power of two below, 64
    (16, 1, 32, 64),
    # the card tests' 20 queries, R = 128 and the k = 200 case's 2,048
    (20, 1, 128, 32), (20, 1, 2048, 2),
    # R past the merge's cap: one survivor block a row
    (4, 1, 8192, 1),
    # B·S alone fills the card
    (SURVIVOR_BLOCKS_PER_SM * N_SM, 1, 128, 1), (300, 4, 64, 1)])
def test_k4_plan_bounds_the_merge_and_fills_the_card(B, S, R, G):
    """G survivor blocks a row, a power of two (the finish sorts a row's
    G·R entries as one): G·R within ``SURVIVOR_MERGE_MAX`` (or G = 1),
    aiming at ``SURVIVOR_BLOCKS_PER_SM`` blocks an SM over the rows; G = 1
    where B·S alone fills the card."""
    plan = blockmax_scan_plan(B, S, R, N_SM)
    assert plan["G"] == G and G & (G - 1) == 0
    assert G * R <= SURVIVOR_MERGE_MAX or G == 1
    if B * S >= SURVIVOR_BLOCKS_PER_SM * N_SM:
        assert G == 1
