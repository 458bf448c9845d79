"""K2's launch plan (``dense_stream_topk_plan``) and K12's workspace
(``masked_scan_workspace_bytes``): how K2 cuts the docs into tiles and
sizes its shared-memory ring and workspace, and how K12 lays out its
workspace with the packed mask at its head.

The plan and the sizes are plain Python, held here on the CPU at the
shapes of ``chip_smoke.py``'s main paths and of the card tests; the sizes
they mirror are read from the sources. The card tests
(``tests/test_torch_cuda.py``) hold the kernels to their plain versions,
and hold the C entries to refusing a workspace a byte short of these
sizes.
"""

import re

import pytest

from elasticsearch_tpu_torch.kernels.build import CSRC_DIR
from elasticsearch_tpu_torch.ops import aggs
from elasticsearch_tpu_torch.ops import tiered_bm25 as tb
from elasticsearch_tpu_torch.ops.topk import H100_SHARED_OPTIN

#: the H100's SMs
N_SM = 132

K2_SRC = (CSRC_DIR / "dense_stream_topk.cu").read_text()
K12_SRC = (CSRC_DIR / "agg_masked_scan.cu").read_text()


def _defines(src, prefix):
    return {m[1]: m[2] for m in
            re.finditer(rf"^#define {prefix}_(\w+) (\S+)", src, re.M)}


K2 = _defines(K2_SRC, "K2")
K12 = _defines(K12_SRC, "K12")

#: (B, S, U, n_pad, k): the headline's search batch (U = T_pad, every used
#: row through W), a batch whose rows go through u_ids, a query group past
#: K2_QUERIES, several shards, the card tests' shapes (lists in device
#: memory at k = 2,000; U past one stage; a few queries), and K3's cap
K2_SHAPES = [
    (64, 1, 256, 1 << 23, 10), (64, 1, 64, 1 << 23, 10),
    (200, 1, 256, 1 << 23, 10), (16, 4, 128, 1 << 21, 10),
    (20, 2, 48, 8192, 10), (20, 2, 32, 8192, 100),
    (20, 2, 32, 8192, 2000), (20, 1, 2048, 8192, 10),
    (3, 1, 16, 1 << 16, 10), (5, 2, 48, 8192, 10),
    (64, 1, 256, 1 << 23, 1000), (1, 1, 16, 1 << 23, 20000)]


def test_k2_sizes_match_the_source():
    """The plan's sizes are the source's: queries a block (16 warps of 4),
    the candidate buffer, the weights kept in shared memory, the ring's
    slots, docs a pass and passes a chunk; the source lays its shared
    memory and workspace out as ``k2_shared_bytes`` and
    ``k2_workspace_bytes`` count them, and refuses a smaller workspace."""
    assert int(K2["THREADS"]) // 32 * int(K2["QW"]) == tb.K2_QUERIES
    assert int(K2["CAND"]) == tb.K2_CAND
    assert tb.K2_CAND >= 32 and tb.K2_CAND & (tb.K2_CAND - 1) == 0
    assert int(K2["NZ"]) == tb.K2_NZ
    assert int(K2["STAGES"]) == tb.K2_STAGES
    assert int(K2["PASS"]) == tb.K2_PASS == 32 * 4
    assert int(K2["MAX_PASSES"]) == tb.K2_MAX_PASSES
    assert "docs_per_tile % 1024" in K2_SRC
    assert tb.K2_TILE_ALIGN == 1024
    for part in ("k2_align((size_t)QB * K2_CAND * 8)",
                 "k2_align((size_t)QB * 16)",
                 "k2_align((size_t)QB * K2_NZ * 8)",
                 "k2_align((size_t)U * 4)",
                 "(top_shared ? k2_align((size_t)QB * k * 8) : 0)",
                 "k2_align((size_t)K2_STAGES * 16)",
                 "(size_t)K2_STAGES * rows_max * K2_PASS * 2"):
        assert part in K2_SRC
    for part in ("k2_align((size_t)B * S * U * 8)",
                 "k2_align((size_t)B * S * 4)",
                 "k2_align((size_t)S * U * 4)", "k2_align((size_t)S * 4)",
                 "U > rows_max ? (size_t)n_tiles * S * groups * QB * 1024 "
                 ": 0"):
        assert part in " ".join(K2_SRC.split())
    assert "if ((long long)need > workspace_bytes) return ES_ERR_SIZE;" \
        in K2_SRC
    base = 131072 + 256 + 1024 + 16
    assert tb.k2_workspace_bytes(64, 1, 256, 256, 64, 256) == base
    assert tb.k2_workspace_bytes(64, 1, 256, 256, 64, 87) == \
        base + 256 * 64 * 1024


@pytest.mark.parametrize("B,S,U,n_pad,k", K2_SHAPES)
def test_k2_tiles_cover_the_docs(B, S, U, n_pad, k):
    """Tiles of a multiple of K2_TILE_ALIGN docs cover [0, n_pad) once,
    none empty; K3's row of tile lists stays within K2_MAX_PARTIALS (one
    tile when k alone passes it); query groups of at most K2_QUERIES
    cover the batch."""
    p = tb.dense_stream_topk_plan(B, S, U, n_pad, k, N_SM, H100_SHARED_OPTIN)
    tile, n_tiles = p["tile"], p["n_tiles"]
    assert tile % tb.K2_TILE_ALIGN == 0
    assert n_tiles * tile >= n_pad > (n_tiles - 1) * tile
    assert n_tiles * k <= max(tb.K2_MAX_PARTIALS, k)
    assert 1 <= p["QB"] <= tb.K2_QUERIES
    assert p["groups"] * p["QB"] >= B > (p["groups"] - 1) * p["QB"]
    assert p["blocks"] == n_tiles * S * p["groups"]


@pytest.mark.parametrize("B,S,U,n_pad,k", K2_SHAPES)
def test_k2_ring_fits_shared_memory(B, S, U, n_pad, k):
    """What a block may have of shared memory fits when the ring holds a
    row (its rows, at most K2_MAX_PASSES·U); the lists sit in shared memory
    when they take at most a quarter of it; the workspace holds the
    compacted weights of every (query, shard)."""
    p = tb.dense_stream_topk_plan(B, S, U, n_pad, k, N_SM, H100_SHARED_OPTIN)
    share = H100_SHARED_OPTIN
    assert p["rows_max"] >= 1
    assert p["rows_max"] <= tb.K2_MAX_PASSES * U
    assert p["shared_bytes"] == tb.k2_shared_bytes(
        p["QB"], U, k, p["top_shared"], p["rows_max"])
    assert p["shared_bytes"] <= share
    lists = -(-p["QB"] * k * 8 // 16) * 16
    assert p["top_shared"] == (lists <= share // 4)
    assert p["workspace_bytes"] == tb.k2_workspace_bytes(
        B, S, U, p["n_tiles"], p["QB"], p["rows_max"])
    assert p["workspace_bytes"] >= 8 * B * S * U
    # the sums between row groups, 1 KB a query of every block, only when
    # U rows may need more than one group
    carry = p["blocks"] * p["QB"] * 1024 if U > p["rows_max"] else 0
    assert p["workspace_bytes"] - carry == tb.k2_workspace_bytes(
        B, S, U, p["n_tiles"], p["QB"], U)


def test_k2_headline_plan():
    """The headline (64 queries, 2^23 docs, U = T_pad = 256, k = 10): one
    block a tile holds all 64 queries, one block an SM, 131 tiles of
    64,512 docs (1,310 entries a row for K3's first call, 2,560 before);
    a slot of the ring stages 179 rows of a 128-doc pass (45,824 bytes), so
    the batch's 86 used rows fit one group; U = 256 could pass one group,
    so the workspace holds the sums between groups."""
    p = tb.dense_stream_topk_plan(64, 1, 256, 1 << 23, 10, N_SM)
    assert (p["QB"], p["groups"], p["tile"], p["n_tiles"]) == \
        (64, 1, 64512, 131)
    assert p["n_tiles"] <= N_SM and p["n_tiles"] * 10 == 1310
    assert p["top_shared"] and p["rows_max"] == 179
    assert p["rows_max"] * tb.K2_PASS * 2 == 45824
    assert p["shared_bytes"] <= H100_SHARED_OPTIN
    assert p["workspace_bytes"] == tb.k2_workspace_bytes(
        64, 1, 256, 131, 64, 256) + 131 * 64 * 1024


def test_k12_sizes_match_the_source():
    """K12's tile of pair words and its sums chunk are the source's; the
    source puts the packed mask at the workspace's head in every mode and
    refuses a smaller workspace."""
    assert K12["TILE_WORDS"] == "K12_THREADS"
    assert int(K12["THREADS"]) == aggs.K12_TILE_WORDS
    assert int(K12["CHUNK"]) == aggs.K12_CHUNK
    assert "return k12_align(4 * (((long long)n_pad + 31) / 32));" in K12_SRC
    assert K12_SRC.count("return k12_mask_bytes(n_pad) + ") == 2
    assert "(char*)workspace + k12_mask_bytes(n_pad)" in K12_SRC
    assert "if (k12_workspace_bytes(Vp, Mp, n_pad, mode) > workspace_bytes)" \
        in K12_SRC


#: (Vp, Mp, n_pad): config #3's route (256 ordinals, 165,346,692 pairs,
#: n_pad 2^28), its caches (2^28 padded pairs), the card tests' ragged
#: shapes (n_pad and Mp not multiples of 32, no pairs, a mask past L2)
K12_SHAPES = [(256, 165346692, 1 << 28), (256, 1 << 28, 1 << 28),
              (8, 1 << 10, 1 << 10), (512, (1 << 20) - 77, (1 << 21) - 5),
              (4096, 1 << 18, 1 << 16), (16, 0, 1000), (1, 33, 31),
              (64, 1 << 16, (1 << 29) + 3)]


@pytest.mark.parametrize("Vp,Mp,n_pad", K12_SHAPES)
@pytest.mark.parametrize("mode", ["counts", "prefix", "sums"])
def test_k12_workspace_sections(Vp, Mp, n_pad, mode):
    """The workspace is the bit mask (a word of 32 docs, ceil(n_pad / 32)
    words, 16-byte aligned), then the counts and prefix modes' pair words,
    tile sums and word prefix, or the sums mode's chunk table and one f64
    partial a chunk (at most Mp / K12_CHUNK + Vp chunks)."""
    ws = aggs.masked_scan_workspace_bytes(Vp, Mp, n_pad, mode)
    mask = -(-(4 * -(-n_pad // 32)) // 16) * 16
    assert mask >= n_pad / 8 and mask % 16 == 0
    if mode == "sums":
        rest = -(-4 * (Vp + 1) // 16) * 16 + 8 * (Mp // aggs.K12_CHUNK + Vp)
    else:
        words = -(-Mp // 32)
        tiles = -(-words // aggs.K12_TILE_WORDS)
        rest = sum(-(-4 * n // 16) * 16 for n in (words, tiles + 1,
                                                  words + 1))
    assert ws == mask + rest
    if n_pad == 1 << 28:
        assert mask == 33554432          # the bits of config #3's mask
