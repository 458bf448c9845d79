"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded through ``ctypes`` (no PyTorch headers:
a build takes seconds, not minutes). All sources compile in parallel at
first use, into ``elasticsearch_tpu_torch/_build/`` (git-ignored), under a
name that carries a hash of the sources and flags, so an edited kernel is
never served from a stale library.

Every kernel wrapper counts its launches in :data:`launches`; a run that
wants to show the main path went through the kernels zeroes the counts
with :func:`reset_launches` and reads them afterwards. Each library also
exports ``es_error_string``, which names the code a refused launch returned
(for one, sizes that need more shared memory than the card gives a block),
so the kernels' limits live in their sources alone.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

#: one entry per kernel source (csrc/<name>.cu)
KERNELS = ("sparse_candidates_topk", "dense_stream_topk", "topk_merge",
           "blockmax_scan", "bisect_exact_scores", "knn_scan", "ivf_scan",
           "ivf_rerank", "fuse_rank", "rescore_reorder", "agg_masked_scan",
           "agg_rank_pick", "agg_bucket_reduce", "agg_metrics",
           "bm25_scatter", "postings_match", "range_mask", "segment_topk",
           "tree_eval", "knn_outlier", "logreg_train", "bool_bm25_topk")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: launches per kernel since the last reset (main-path accounting);
#: updated under ``_count_lock`` (the serving route launches from two
#: dispatcher threads)
launches: Dict[str, int] = {name: 0 for name in KERNELS}
_count_lock = threading.Lock()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: nvcc's ptxas report (registers, shared memory, spills) per kernel
ptxas_report: Dict[str, str] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: C signatures: pointers and the stream are void*, sizes int
_SIGNATURES = {
    # docs, imps, P, starts, lengths, idfw, dense, rid, dw, u_ids,
    # B, S, Q, L, n_pad, k, msm, n_blk, T, C, U, tshift, tpb, W, G,
    # part_vals, part_docs, part_count, out_vals, out_docs, out_count,
    # stream
    "sparse_candidates_topk": (
        "es_sparse_candidates_topk",
        [_P, _P, _I] + [_P] * 7 + [_I] * 15 + [_P] * 7),
    # W, dense, u_ids, B, S, U, n_blk, T, C, n_pad, k, msm, docs_per_tile,
    # n_tiles, QB, top_shared, rows_max, part_vals, part_docs, n_matched,
    # workspace, workspace_bytes, stream
    "dense_stream_topk": (
        "es_dense_stream_topk",
        [_P] * 3 + [_I] * 14 + [_P] * 4 + [_L, _P]),
    # docs, imps, P, starts, lengths, idfw, cbits, req, neg, shd, msm,
    # B, S, Q, L, n_pad, k, nc, tshift, tpb, W, G, part_vals, part_docs,
    # part_count, out_vals, out_docs, out_count, stream
    "bool_bm25_topk": (
        "es_bool_bm25_topk",
        [_P, _P, _I] + [_P] * 8 + [_I] * 11 + [_P] * 7),
    # a_vals, a_ids, ma, b_vals, b_ids, mb, R, k, dedup, seg_len,
    # seg_stride, fill_id, G, L, S0, S1, glob0, glob1, out_vals, out_ids,
    # out_sel, workspace, stream
    "topk_merge": (
        "es_topk_merge",
        [_P, _P, _I, _P, _P] + [_I] * 13 + [_P] * 5),
    # t_docs, t_codes, t_scale, t_off, NB1, BS, sched, w, rho, slack, B, S,
    # P, n_pad, NB, W, R, kq_idx, prune_active, G, acc, part, out_ci,
    # out_cv, out_counts, stream
    "blockmax_scan": (
        "es_blockmax_scan",
        [_P] * 4 + [_I] * 2 + [_P] * 4 + [_I] * 10 + [_P] * 6),
    # docs, imps, P, starts, lengths, idfw, cand, R, cand2, vals2, R2, B,
    # S, Q, n_pad, out_score, out_found, out_score2, out_found2, stream
    "bisect_exact_scores": (
        "es_bisect_exact_scores",
        [_P, _P, _I] + [_P] * 4 + [_I] + [_P] * 2 + [_I] * 5 + [_P] * 5),
    # vecs, vn, exists, qq, qn, B, S, n_pad, D, k, l2, n_chunks, part_vals,
    # part_rows, workspace, stream
    "knn_scan": (
        "es_knn_scan",
        [_P] * 5 + [_I] * 7 + [_P] * 4),
    # codes, is_bf16, scale, off, rowid, rcl, vn, qq, qsum, qn, probed,
    # u_blocks, B, S, NB1, BLK, D, n_pad, nlist, nprobe, P, R, l2,
    # out_vals, out_pos, workspace, stream
    "ivf_scan": (
        "es_ivf_scan",
        [_P, _I] + [_P] * 10 + [_I] * 11 + [_P] * 4),
    # win_vals, win_pos, u_blocks, rowid, vecs, vn, qq, qn, B, S, R, P, NB1,
    # BLK, n_pad, D, l2, out_score, out_rows, stream
    "ivf_rerank": (
        "es_ivf_rerank",
        [_P] * 8 + [_I] * 9 + [_P] * 3),
    # tv, tg, na, kv, kg, nb, wt, wk, rc, kboost, tsec, tfnd, ksec, kfnd,
    # B, n_pad_t, n_pad_k, UP, pad_id, fusion, sim, k, out_vals, out_ids,
    # out_sel, out_sec, out_fnd, workspace, stream
    "fuse_rank": (
        "es_fuse_rank",
        [_P, _P, _I, _P, _P, _I] + [_P] * 8 + [_I] * 8 + [_P] * 7),
    # vals, ids, secondary, matched, qw, rw, window, B, n, mode, k, pad_id,
    # out_vals, out_ids, workspace, stream
    "rescore_reorder": (
        "es_rescore_reorder",
        [_P] * 7 + [_I] * 5 + [_P] * 4),
    # offsets, Vp, pair_docs, pair_vals, Mp, mask, n_pad, mode, out_counts,
    # out_c, out_sums, workspace, workspace_bytes, stream
    "agg_masked_scan": (
        "es_agg_masked_scan",
        [_P, _I, _P, _P, _I, _P, _I, _I] + [_P] * 4 + [_L, _P]),
    # c, n_c, offsets, V, vals, M, ordinals, lo, hi, frac, B, R, mode, out,
    # stream
    "agg_rank_pick": (
        "es_agg_rank_pick",
        [_P, _I, _P, _I, _P, _I] + [_P] * 4 + [_I] * 3 + [_P] * 2),
    # ids, docs, vals, Mp, mask, n_pad, nb, sums, out, workspace, stream
    "agg_bucket_reduce": (
        "es_agg_bucket_reduce",
        [_P] * 3 + [_I, _P] + [_I] * 3 + [_P] * 3),
    # docs, vals, Mp, mask, n_pad, out, workspace, stream
    "agg_metrics": (
        "es_agg_metrics",
        [_P, _P, _I, _P, _I] + [_P] * 3),
    # docs, tf, P, doc_len, n_dl, host_slots, dev_slots, Q, L, seg_pad,
    # avgdl, k1, b, tshift, CH, n_ch, scratch, out_scores, out_matched,
    # stream
    "bm25_scatter": (
        "es_bm25_scatter",
        [_P, _P, _L, _P, _I, _P, _P] + [_I] * 3 + [_F] * 3 + [_I] * 3
        + [_P] * 4),
    # docs, P, host_runs, dev_runs, Q, seg_pad, out_matched, stream
    "postings_match": (
        "es_postings_match",
        [_P, _L, _P, _P] + [_I] * 2 + [_P] * 2),
    # vals, is_f32, lo_i, hi_i, lo_f, hi_f, docs, M, seg_pad, out_mask,
    # stream
    "range_mask": (
        "es_range_mask",
        [_P] + [_I] * 3 + [_F] * 2 + [_P, _L, _I] + [_P] * 2),
    # scores, mask, n, k, out_vals, out_idx, workspace, stream
    "segment_topk": (
        "es_segment_topk",
        [_P, _P, _L, _I] + [_P] * 4),
    # X, n, F, nodes, T, N, depth, out, stream
    "tree_eval": (
        "es_tree_eval",
        [_P, _I, _I, _P] + [_I] * 3 + [_P] * 2),
    # X, n, f, kk, sq (workspace of n + 1), dk, stream
    "knn_outlier": (
        "es_knn_outlier",
        [_P] + [_I] * 3 + [_P] * 3),
    # Xb, y, n, F1, C, lr, steps, W, workspace, stream
    "logreg_train": (
        "es_logreg_train",
        [_P] * 2 + [_I] * 3 + [_F, _I] + [_P] * 3),
}

#: other C functions of a library: name -> (argtypes, restype)
_QUERIES = {
    "bm25_scatter": {
        # () -> slots whose inputs ride in the launch's parameters
        "es_bm25_scatter_param_slots": ([], ctypes.c_int),
    },
    "knn_scan": {
        # (B, S, n_chunks, k, D) -> workspace bytes, 0 when the lists fit
        "es_knn_scan_workspace_bytes": ([_I] * 5, ctypes.c_longlong),
        # (B, D, k) -> blocks of a launch one SM holds, 0 when none fits
        "es_knn_scan_blocks_per_sm": ([_I] * 3, ctypes.c_int),
        # (B, D, k) -> the launch's row ring: stages x 100 + d values a
        # stage, 0 when none fits
        "es_knn_scan_ring": ([_I] * 3, ctypes.c_int),
    },
    "ivf_scan": {
        # (B, S, P, R) -> a call's workspace bytes
        "es_ivf_scan_workspace_bytes": ([_I] * 4, ctypes.c_longlong),
        # (B, S, R, D, nlist) -> scan blocks a (query, shard)
        "es_ivf_scan_parts": ([_I] * 5, ctypes.c_int),
        # (D, nlist) -> blocks of the deep path's cooperative launch
        "es_ivf_deep_grid": ([_I] * 2, ctypes.c_int),
    },
    "postings_match": {
        # () -> runs whose inputs ride in the launch's parameters
        "es_postings_match_param_runs": ([], ctypes.c_int),
    },
    "fuse_rank": {
        # (n, B) -> workspace bytes, 0 when a row's sort fits or n counts
        "es_fuse_rank_workspace_bytes": ([_I] * 2, ctypes.c_longlong),
    },
    "rescore_reorder": {
        # (n, B) -> workspace bytes, 0 when a row's sort fits
        "es_rescore_reorder_workspace_bytes": ([_I] * 2, ctypes.c_longlong),
    },
    "agg_bucket_reduce": {
        # (Mp, n_buckets, sums) -> workspace bytes, 0 for counts
        "es_agg_bucket_reduce_workspace_bytes": ([_I] * 3,
                                                 ctypes.c_longlong),
    },
    "agg_metrics": {
        # (Mp) -> workspace bytes
        "es_agg_metrics_workspace_bytes": ([_I], ctypes.c_longlong),
    },
    "segment_topk": {
        # (n, k) -> workspace bytes
        "es_segment_topk_workspace_bytes": ([_L, _I], ctypes.c_longlong),
    },
    "logreg_train": {
        # (n, F1, C) -> bytes of the barrier's counter and two buffers of
        # the per-tile partial gradients
        "es_logreg_workspace_bytes": ([_I] * 3, ctypes.c_longlong),
    },
    "bool_bm25_topk": {
        # (Q, k, tshift, W) -> blocks of the tile kernel one SM holds, 0
        # when none fits
        "es_bool_bm25_topk_blocks_per_sm": ([_I] * 4, ctypes.c_int),
    },
    "sparse_candidates_topk": {
        # (Q, k, tshift, W) -> blocks of the tile kernel one SM holds, 0
        # when none fits
        "es_sparse_candidates_topk_blocks_per_sm": ([_I] * 4, ctypes.c_int),
    },
}


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every kernel that has no current library, all ``nvcc``
    processes started together; returns the seconds spent."""
    with _lock:
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [n for n in KERNELS if not _lib_path(n).exists()]
        procs = []
        if todo:
            nvcc = _nvcc()
            for name in todo:
                out = _lib_path(name)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o",
                       str(tmp), str(CSRC_DIR / f"{name}.cu")]
                procs.append((name, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
        failed = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            ptxas_report[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (its source built on first
    use), its C functions typed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_all()
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(path))
            sym, argtypes = _SIGNATURES[name]
            funcs = {"es_error_string": ([_I], ctypes.c_char_p),
                     sym: (argtypes, ctypes.c_int),
                     **_QUERIES.get(name, {})}
            for fname, (argtypes, restype) in funcs.items():
                fn = getattr(lib, fname)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[name] = lib
    return _libs[name]


def query(name: str, fname: str, *args):
    """Call one of kernel ``name``'s other C functions (``_QUERIES``)."""
    return getattr(library(name), fname)(*args)


def wrapper_device(name: str, t: torch.Tensor) -> torch.device:
    """The device a kernel wrapper runs on: the CPU (its plain version) or
    CUDA (the kernel); any other device raises."""
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
          device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: the kernels take raw pointers and trust the layout."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel entry ``name``'s C function on the current stream; raise
    on a refused launch. Counts the launch.

    The libraries carry their own CUDA runtime, whose current device is
    the first card: tensors on another card are refused."""
    if device.index not in (None, 0):
        raise ValueError(f"{name}: the kernels run on cuda:0, got {device}")
    lib = library(name)
    # the current stream's raw handle (a torch.cuda.Stream object costs
    # about 4 µs a call)
    err = getattr(lib, _SIGNATURES[name][0])(
        *args, torch._C._cuda_getCurrentRawStream(0))
    if err != 0:
        raise RuntimeError(f"{name}: launch refused: "
                           f"{lib.es_error_string(err).decode()} ({err})")
    with _count_lock:
        launches[name] += 1
