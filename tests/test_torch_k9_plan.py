"""K9's launch plan (``bool_bm25_topk_plan``): how the bool kernel splits
each (query, shard)'s docs into ranges of tiles, one block a range.

The plan is plain Python, so it is held here, on the CPU, at the shapes of
``chip_smoke.py``'s bool mixes and hybrid and of the card tests; the card
tests (``tests/test_torch_cuda.py``) hold the kernel that runs it to its
plain version.
"""

import pytest

from elasticsearch_tpu_torch.ops.fused_query import (
    BOOL_BLOCKS_PER_SM, BOOL_EDGES_MAX, BOOL_MERGE_MAX,
    BOOL_SPARSE_TILE_SHIFT, BOOL_TILE_SHIFT, bool_bm25_topk_plan)

#: the H100's SMs
N_SM = 132


@pytest.mark.parametrize("n_pad,B,S,Q,L,k", [
    # chip_smoke.py: bool mixes (c) and (d), the hybrid's text side
    (1 << 22, 16, 1, 8, 1 << 22, 10), (1 << 22, 16, 1, 16, 1 << 16, 128),
    # the card tests: bool_case's shapes and the tile-edge cases
    (4096, 8, 1, 6, 48, 10), (4096, 8, 3, 6, 48, 200),
    (1 << 16, 8, 2, 6, 30000, 100), (1 << 15, 8, 1, 6, 4000, 30000),
    (1 << 20, 8, 1, 6, 10926, 200), (1 << 20, 8, 3, 6, 10926, 10),
    (1 << 20, 8, 1, 6, 349526, 10), (1 << 15, 8, 1, 6, 10923, 30000),
    (1 << 18, 8, 3, 6, 2000, 200), (1 << 17, 8, 2, 6, 20000, 100),
    # n_pad not a multiple of the tile; one tile; no docs
    (3 * (1 << BOOL_TILE_SHIFT) + 1234, 8, 2, 6, 3689, 10),
    ((1 << BOOL_TILE_SHIFT) - 7, 1, 1, 1, 16, 10), (0, 4, 1, 8, 16, 10),
    # many slots: a block's edge table holds fewer tiles at a time
    (1 << 22, 2, 1, 1024, 1 << 16, 10), (64, 1, 1, 10000, 16, 10)])
def test_plan_covers_the_docs_with_every_block(n_pad, B, S, Q, L, k):
    """Tiles of 2^tile_shift docs cover [0, n_pad) (the last may be short),
    2^12 where the slots hold at most one posting a doc (Q·L <= n_pad),
    else 2^11; G blocks of ``tiles_per_block`` tiles cover the tiles and
    each block has at least one; a block's edge table, ``edge_tiles`` + 1
    edges a slot, stays within ``BOOL_EDGES_MAX`` unless one tile needs
    more."""
    plan = bool_bm25_topk_plan(n_pad, B, S, Q, L, k, N_SM)
    T, n_tiles = plan["tile"], plan["n_tiles"]
    G, tpb, W = plan["G"], plan["tiles_per_block"], plan["edge_tiles"]
    sparse = Q * L <= n_pad
    assert plan["tile_shift"] == (BOOL_SPARSE_TILE_SHIFT if sparse
                                  else BOOL_TILE_SHIFT)
    assert T == 1 << plan["tile_shift"]
    assert n_tiles * T >= n_pad > (n_tiles - 1) * T or n_pad == n_tiles == 0
    assert G >= 1 and 1 <= W <= tpb
    if n_tiles:
        assert G * tpb >= n_tiles > (G - 1) * tpb
    else:
        assert G == 1
    assert Q * (W + 1) <= BOOL_EDGES_MAX or W == 1


@pytest.mark.parametrize("n_pad,B,S,Q,L,k,G", [
    # the smoke's shapes: 64 and 32 blocks a query, 1,024 and 512 in all
    (1 << 22, 16, 1, 8, 1 << 22, 10, 64),
    (1 << 22, 16, 1, 16, 1 << 16, 128, 32),
    # bool_case at k = 200: one tile of 2^12 docs, one block
    (4096, 8, 3, 6, 48, 200, 1),
    # k = 30,000: one block, so no merge
    (1 << 15, 8, 1, 6, 4000, 30000, 1), (1 << 22, 16, 1, 8, 1 << 22, 30000, 1),
    # the card's tile-edge cases
    (1 << 20, 8, 1, 6, 10926, 200, 20), (1 << 20, 8, 1, 6, 349526, 10, 128)])
def test_plan_fills_the_card_and_bounds_the_merge(n_pad, B, S, Q, L, k, G):
    """G aims at ``BOOL_BLOCKS_PER_SM`` blocks an SM over the (query,
    shard) pairs, at most one block a tile, and keeps G·k within
    ``BOOL_MERGE_MAX``; at k = 30,000 one block walks the whole range."""
    plan = bool_bm25_topk_plan(n_pad, B, S, Q, L, k, N_SM)
    assert plan["G"] == G
    assert G * k <= BOOL_MERGE_MAX or G == 1
    want = BOOL_BLOCKS_PER_SM * N_SM
    if G * k * 2 <= BOOL_MERGE_MAX and 2 * G <= plan["n_tiles"]:
        assert B * S * G >= want // 2


def test_plan_grows_with_the_card_and_shrinks_with_the_batch():
    """More SMs or fewer (query, shard) pairs give more blocks a query."""
    n, L = 1 << 22, 1 << 22
    few = bool_bm25_topk_plan(n, 64, 1, 8, L, 10, N_SM)["G"]
    many = bool_bm25_topk_plan(n, 4, 1, 8, L, 10, N_SM)["G"]
    bigger = bool_bm25_topk_plan(n, 64, 1, 8, L, 10, 2 * N_SM)["G"]
    assert few < many and few < bigger
