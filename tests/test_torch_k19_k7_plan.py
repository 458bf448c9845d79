"""The sizes K19 (``csrc/segment_topk.cu``) and K7 (``csrc/ivf_scan.cu``)
share with their Python wrappers, read from the sources on the CPU.

K19 serves k <= ``K19_FAST_K`` in one cooperative launch and deeper pages
by its multi-launch path; K7 forms windows of up to ``K7_WINDOW_MAX`` in
one call and larger ones through chunk lists and K3. The wrappers pick
the path by these constants, so each must equal the source's. The card
tests (``tests/test_torch_cuda.py``) hold both paths to the plain
versions.
"""

import importlib.util
import re
from pathlib import Path

import pytest

from elasticsearch_tpu_torch.kernels.build import CSRC_DIR
from elasticsearch_tpu_torch.ops import knn, topk
from elasticsearch_tpu_torch.ops.topk import H100_SHARED_OPTIN

K19_SRC = (CSRC_DIR / "segment_topk.cu").read_text()
K7_SRC = (CSRC_DIR / "ivf_scan.cu").read_text()


def _defines(src, prefix):
    return {m[1]: int(m[2], 0) for m in
            re.finditer(rf"^#define {prefix}_(\w+) (0x[0-9A-Fa-f]+|\d+)",
                        src, re.M)}


K19 = _defines(K19_SRC, "K19")
K7 = _defines(K7_SRC, "K7")


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
    """The wrapper forms windows of up to K7_WINDOW_MAX in one call; a
    part's list and its candidate buffer, and the merge of a single part,
    fit the scan block's key array."""
    assert knn.K7_WINDOW_MAX == K7["WINDOW_MAX"] == 1024
    assert K7["CB"] >= K7["THREADS"]
    assert K7["MERGE_MAX"] >= K7["WINDOW_MAX"]
    assert K7["QT"] == 32                     # a query mask is one u32
    assert "if (R < 1 || R > K7_WINDOW_MAX" in K7_SRC


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


def test_probe_edits_find_their_targets():
    """kernel_probe.py's K19 builds (the stamps, the variants) and K7's
    stamps build edit the sources by text: each target occurs exactly
    once."""
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
