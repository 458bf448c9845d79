"""The sizes K19 (``csrc/segment_topk.cu``), K7 (``csrc/ivf_scan.cu``)
and K17 (``csrc/postings_match.cu``) share with their Python wrappers,
read from the sources on the CPU.

K19 serves k <= ``K19_FAST_K`` in one cooperative launch and deeper pages
by its multi-launch path; K7 forms windows of up to ``K7_WINDOW_MAX`` by
merging its parts' lists and larger ones (up to ``K7_DEEP_MAX``) by its
deep path's histograms, one C call either way; K17 takes up to
``K17_QMAX`` runs in its launch's parameters. The wrappers pick the path
by these constants, so each must equal the source's. The card tests
(``tests/test_torch_cuda.py``) hold every path to the plain versions.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

from elasticsearch_tpu_torch.kernels.build import CSRC_DIR
from elasticsearch_tpu_torch.ops import knn, masks, topk
from elasticsearch_tpu_torch.ops.topk import H100_SHARED_OPTIN

K19_SRC = (CSRC_DIR / "segment_topk.cu").read_text()
K7_SRC = (CSRC_DIR / "ivf_scan.cu").read_text()
K13_SRC = (CSRC_DIR / "agg_rank_pick.cu").read_text()
K17_SRC = (CSRC_DIR / "postings_match.cu").read_text()


def _defines(src, prefix):
    return {m[1]: int(m[2], 0) for m in
            re.finditer(rf"^#define {prefix}_(\w+) (0x[0-9A-Fa-f]+|\d+)",
                        src, re.M)}


K19 = _defines(K19_SRC, "K19")
K7 = _defines(K7_SRC, "K7")
K17 = _defines(K17_SRC, "K17")


def test_k19_one_launch_limit_is_the_sources():
    """The wrapper sends k <= K19_FAST_K to the one-launch path, which
    sorts at most K19_SORT_MAX survivors: every k it serves fits."""
    assert topk.K19_FAST_K == K19["FAST_K"] == 16384
    assert K19["SORT_MAX"] >= K19["FAST_K"]
    assert K19["SORT_MAX"] % K19["SCHUNK"] == 0


def test_k19_sort_and_histogram_shapes():
    """A chunk is a power of two of keys; a block's threads share the
    bins of a level evenly; the three levels' digits (11, 11, 10 bits)
    cover the 32-bit key, and the first level's histogram has a bin a
    digit value."""
    assert K19["SCHUNK"] & (K19["SCHUNK"] - 1) == 0
    assert K19["BINS"] % K19["FT"] == 0
    assert K19["BINS"] == 1 << 11
    assert "level == 0 ? 21 : (level == 1 ? 10 : 0)" in K19_SRC
    assert "const int bits = level == 2 ? 10 : 11;" in K19_SRC
    assert K19["NEG_INF_KEY"] == 0xFF800000
    assert K19["VEC"] == 16          # 16 mask bytes and four float4s


def test_k19_shared_memory_fits_a_block():
    """The merge holds every sorted chunk of survivors in one block's
    dynamic shared memory, beside the level histogram."""
    dyn = K19["SORT_MAX"] * 8
    hist = K19["BINS"] * 4
    assert dyn + hist + 4096 <= H100_SHARED_OPTIN
    assert "const size_t shm = (size_t)K19_SORT_MAX * sizeof(u64);" in \
        K19_SRC


def test_k7_window_limit_is_the_sources():
    """The wrapper names the window path's limit and the deep path's; the
    C entry picks the path by K7_WINDOW_MAX and refuses windows past
    K7_DEEP_MAX (whose 2 r_cand survivors stay below 2^31); a part's list
    and its candidate buffer, and the merge of a single part, fit the
    window-path block's key array."""
    assert knn.K7_WINDOW_MAX == K7["WINDOW_MAX"] == 1024
    assert "#define K7_DEEP_MAX (1 << 29)" in K7_SRC
    assert knn.K7_DEEP_MAX == 1 << 29 and 2 * knn.K7_DEEP_MAX < 2 ** 31
    assert K7["CB"] >= K7["THREADS"]
    assert K7["MERGE_MAX"] >= K7["WINDOW_MAX"]
    assert K7["QT"] == 32                     # a query mask is one u32
    entry = K7_SRC[K7_SRC.index('extern "C" int es_ivf_scan('):]
    assert "if (R < 1 || R > K7_DEEP_MAX ||" in entry
    assert "const bool deep = R > K7_WINDOW_MAX;" in entry
    # no chunk lists: the window is formed in the call, with no K3
    assert "n_chunks" not in K7_SRC and "ivf_scan_partials" not in \
        knn.__dict__


@pytest.mark.parametrize("nlist,fits", [
    (1024, True), (1 << 16, True), (88_000, True), (1 << 17, False)])
def test_k7_mask_bitmaps_fit_shared_memory(nlist, fits):
    """The mask kernel holds the probe bitmaps of K7_MQ queries at a time
    (16, the chunk path's query tile), so a batch of 32 or more serves an
    nlist of 2^16 and nlist 2^17 is still refused for shared memory."""
    assert K7["MQ"] == 16 and K7["QT"] % K7["MQ"] == 0
    assert "const int tile = B < K7_MQ ? B : K7_MQ;" in K7_SRC
    assert "const size_t shm_mask = (size_t)tile * nw * 4;" in K7_SRC
    nw = (nlist + 31) // 32
    assert (K7["MQ"] * nw * 4 <= H100_SHARED_OPTIN) == fits


def test_k19_entry_zeroes_the_call_workspace():
    """The one-launch path's barrier counters and histograms start at zero
    in every call: the entry zeroes the workspace's head, up to the
    blocks' partial counts, which every block writes before it reads."""
    entry = K19_SRC[K19_SRC.index("extern \"C\" int es_segment_topk("):]
    assert "cudaMemsetAsync(sb, 0, l.part, st)" in entry
    assert entry.index("cudaMemsetAsync") < \
        entry.index("cudaLaunchCooperativeKernel")
    layout = K19_SRC[K19_SRC.index("static K19FastLayout k19_fast_layout("):]
    layout = layout[:layout.index("\n}\n")]
    assert "l.hist = sizeof(K19Ctl);" in layout
    assert "l.part = l.hist + (size_t)3 * K19_BINS * 4;" in layout


@pytest.mark.parametrize("B,S,R,n_sm,G", [
    (16, 1, 40, 132, 8), (16, 2, 40, 132, 4), (1, 1, 40, 132, 16),
    (16, 1, 1024, 132, 8), (64, 4, 40, 132, 1), (5, 2, 1000, 132, 8)])
def test_k7_parts_fill_one_wave(B, S, R, n_sm, G):
    """k7_parts: a scan block an SM over the (query, shard)s (at least one
    a pair, at most K7_MAX_PARTS), few enough that the last part merges
    G x R keys (K7_MERGE_MAX)."""
    g = min(n_sm // (B * S), K7["MAX_PARTS"])
    while g > 1 and g * R > K7["MERGE_MAX"]:
        g -= 1
    assert max(g, 1) == G
    body = K7_SRC[K7_SRC.index("static int k7_parts("):]
    body = body[:body.index("\n}\n")]
    for part in ("int G = es_sm_count() / bs;",
                 "if (G > K7_MAX_PARTS) G = K7_MAX_PARTS;",
                 "while (G > 1 && (long long)G * R > K7_MERGE_MAX) --G;",
                 "return G < 1 ? 1 : G;"):
        assert part in body
    assert K7["SCAN_THREADS"] * 4 == K7["WORDS"]
    assert K7["CB"] >= K7["SCAN_THREADS"]


K7_MINE_BYTES = (2 * K7["WORDS"] + K7["SCAN_THREADS"] // 32 + 1) * 4


def k7_deep_shared(D, nlist):
    """The deep kernel's dynamic shared memory (``k7_deep_shared``): two
    chunks of survivors, the query, the probe bitmap."""
    return 2 * K7["SCH"] * 8 + (D + 3) // 4 * 16 + (nlist + 31) // 32 * 4


def k7_deep_parts(B, S, grid):
    g = grid // max(B * S, 1)
    return max(1, min(g, K7["MAX_PARTS"]))


def k7_workspace(B, S, P, R):
    """``k7_layout``'s bytes: the query masks, the zeroed words, the deep
    path's level counters and 2 R survivors a (query, shard), or the
    window path's part lists."""
    r16 = lambda x: (x + 15) // 16 * 16
    nqt = -(-B // K7["QT"])
    deep = R > K7["WINDOW_MAX"]
    zero = r16(nqt * S * P * 4)
    ctl = zero + r16(B * S * (K7["REC_WORDS"] if deep else 1) * 4)
    surv = ctl + (64 if deep else 0)
    if deep:
        return surv + B * S * 2 * R * 8
    g = min(132 // max(B * S, 1), K7["MAX_PARTS"])
    while g > 1 and g * R > K7["MERGE_MAX"]:
        g -= 1
    return surv + B * S * max(g, 1) * R * 8


@pytest.mark.parametrize("D,nlist", [(64, 1024), (768, 1024), (64, 88_000),
                                     (64, 1 << 16)])
def test_k7_deep_block_fits_one_an_sm(D, nlist):
    """A deep-path block (1,024 threads) holds its part list of gathered
    blocks, its histogram, the merge sort's keys and two chunks of
    survivors beside the query and its probe bitmap in the shared memory a
    block may have, at the widths and nlist the window path serves."""
    assert K7["SCAN_THREADS"] == 1024
    assert "k7_deep_kernel(K7Args a," in K7_SRC
    # the part list, the bins, the decision's words: within the 48 KB of
    # static shared memory; the merge sort's keys share the chunks' space
    static = K7_MINE_BYTES + K7["BINS"] * 4 + 16 + \
        K7["SCAN_THREADS"] // 32 * 4
    assert static <= 48 * 1024
    assert (K7["SCH"] + 1) * 8 <= 2 * K7["SCH"] * 8
    assert "reinterpret_cast<typename Sort::TempStorage*>(k7_dyn)" in K7_SRC
    assert static + k7_deep_shared(D, nlist) <= H100_SHARED_OPTIN
    body = K7_SRC[K7_SRC.index("static size_t k7_deep_shared("):]
    body = body[:body.index("\n}\n")]
    assert "(size_t)2 * K7_SCH * 8" in body
    assert "(size_t)((D + 3) & ~3) * 4" in body
    assert "(size_t)((nlist + 31) / 32) * 4" in body


def test_k7_deep_levels_and_chunks():
    """The levels' digits cover the 64-bit key (five of 11 bits, then 9),
    so the last level's bucket is one key and every (query, shard)
    settles; a level's bins are two a thread; a (query, shard)'s record is
    its 16-word state and its bins; a chunk is a power of two of keys,
    a whole number a thread."""
    assert 11 * (K7["LEVELS"] - 1) + 9 == 64
    assert K7["BINS"] == 1 << 11 == 2 * K7["SCAN_THREADS"]
    assert K7["REC_WORDS"] == 16 + K7["BINS"]
    assert "int pad[7];      // 16 words" in K7_SRC
    assert K7["SCH"] & (K7["SCH"] - 1) == 0
    assert K7["SCH"] % K7["SCAN_THREADS"] == 0
    assert "return L < K7_LEVELS - 1 ? 53 - 11 * L : 0;" in K7_SRC
    assert "return L < K7_LEVELS - 1 ? 11 : 9;" in K7_SRC
    # settled at the last level, or when the survivors fit 2 r_cand
    assert "L == K7_LEVELS - 1) {" in K7_SRC
    assert "int CAP = 2 * R;" in K7_SRC


@pytest.mark.parametrize("B,S,grid,G", [
    (16, 1, 132, 8), (16, 2, 132, 4), (1, 1, 132, 16), (64, 4, 132, 1),
    (5, 2, 132, 13), (200, 1, 132, 1)])
def test_k7_deep_parts_fill_the_grid(B, S, grid, G):
    """The deep path's parts a (query, shard): the grid's blocks (one an
    SM) over the (query, shard)s, at least one, at most K7_MAX_PARTS; the
    units beyond one a block are dealt round the grid."""
    assert k7_deep_parts(B, S, grid) == G
    body = K7_SRC[K7_SRC.index("static int k7_deep_parts("):]
    body = body[:body.index("\n}\n")]
    assert "const int G = grid / bs;" in body
    assert "return G < 1 ? 1 : (G > K7_MAX_PARTS ? K7_MAX_PARTS : G);" in body


@pytest.mark.parametrize("B,S,P,R,want", [
    # the IVF shape's window (40) and serve(k = 1,000)'s and
    # serve(k = 10,000)'s deep windows
    (16, 1, 1024, 40, 4096 + 64 + 16 * 8 * 40 * 8),
    (16, 1, 1024, 4000, 4096 + 16 * 2064 * 4 + 64 + 16 * 8000 * 8),
    (16, 1, 1024, 40000, 4096 + 16 * 2064 * 4 + 64 + 16 * 80000 * 8),
    (40, 3, 77, 1025, 1856 + 40 * 3 * 2064 * 4 + 64
     + 40 * 3 * 2050 * 8)])
def test_k7_workspace_bytes(B, S, P, R, want):
    """The workspace the wrapper allocates (``es_ivf_scan_workspace_bytes``
    mirrors ``k7_layout``): the deep path's survivors are 2 r_cand keys a
    (query, shard), 10.2 MB at serve(k = 10,000)'s window."""
    assert k7_workspace(B, S, P, R) == want
    body = K7_SRC[K7_SRC.index("static K7Layout k7_layout("):]
    body = body[:body.index("\n}\n")]
    for part in ("l.zero = (nqt * S * P * 4 + 15) & ~(size_t)15;",
                 "l.surv = l.ctl + (deep ? 64 : 0);",
                 "l.total = l.surv + (deep ? bs * 2 * (size_t)R * 8"):
        assert part in body


def test_k17_runs_ride_in_the_parameters():
    """K17 takes up to K17_QMAX runs (start and prefix, 2 Q + 1 words) in
    its launch's parameters, which stay within CUDA's 4 KB; the wrapper
    asks the library for the limit and passes the same words."""
    assert K17["QMAX"] == 64
    assert "extern \"C\" int es_postings_match_param_runs(void) { return " \
        "K17_QMAX; }" in K17_SRC
    assert "long long w[2 * K17_QMAX + 1];" in K17_SRC
    params = 8 * (2 * K17["QMAX"] + 1) + 8 + 8 + 8 + 4 + 4 + 8
    assert params <= 4096
    assert "cudaLaunchCooperativeKernel" in K17_SRC
    assert "cudaMemsetAsync" not in K17_SRC   # one device event a call


@pytest.mark.parametrize("starts,lengths,L,want", [
    ([5, 0, -3], [4, -1, 100], 8, [5, 0, -3, 0, 4, 4, 12]),
    ([], [], 16, [0]),
    ([7], [1 << 20], 1 << 21, [7, 0, 1 << 20])])
def test_k17_runs_number_the_valid_postings(starts, lengths, L, want):
    """The runs as K17 reads them: each start, then the prefix of the
    lengths cut to [0, L], so the kernel deals the valid postings of all
    runs as one sequence."""
    got = masks.postings_runs(np.asarray(starts, np.int32),
                              np.asarray(lengths, np.int32), L=L)
    assert got.dtype == np.int64 and got.tolist() == want
    with pytest.raises(ValueError):
        masks.postings_runs(np.zeros(2, np.int32), np.zeros(3, np.int32),
                            L=L)


def test_probe_edits_find_their_targets():
    """kernel_probe.py's K19 builds (the stamps, the variants), K7's
    stamps build and K13's variants edit the sources by text: each target
    occurs exactly once."""
    path = Path(__file__).resolve().parent.parent / "kernel_probe.py"
    spec = importlib.util.spec_from_file_location("kernel_probe", path)
    kp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kp)
    edits = list(kp.K19_STAMPS)
    for more in kp.K19_VARIANTS.values():
        edits += more
    for old, _new in edits:
        assert K19_SRC.count(old) == 1, old
    for old, _new in kp.K7_STAMPS:
        assert K7_SRC.count(old) == 1, old
    for edits in kp.K13_VARIANTS.values():
        for old, new in edits:
            assert K13_SRC.count(old) == 1, old
            assert K13_SRC.replace(old, new) != K13_SRC
