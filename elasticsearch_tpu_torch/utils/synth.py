"""Synthetic Zipf CSR corpora (copy of ``elasticsearch_tpu/utils/synth.py``).

The same ``np.random.RandomState`` gives byte-identical arrays in both
packages, so the port and the reference build the same corpus."""

from __future__ import annotations

import numpy as np


def synthetic_csr_corpus(rng: np.random.RandomState, n_docs: int, vocab: int,
                         avg_dl: int, zipf_s: float = 1.2) -> dict:
    """Zipf-distributed postings for one shard: dict with ``docs`` i32[P]
    (CSR doc ids, doc-ascending per term run), ``tf`` f32[P], ``offsets``
    i64[V+1], ``df`` i32[V], ``doc_len`` f32[N]."""
    lens = np.maximum(1, rng.poisson(avg_dl, n_docs))
    ranks = rng.zipf(zipf_s, size=int(lens.sum()))
    terms = np.minimum(ranks - 1, vocab - 1).astype(np.int64)
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
    order = np.lexsort((doc_of, terms))
    terms, doc_of = terms[order], doc_of[order]
    key = terms * n_docs + doc_of
    uniq, counts = np.unique(key, return_counts=True)
    p_terms = (uniq // n_docs).astype(np.int64)
    p_docs = (uniq % n_docs).astype(np.int32)
    p_tf = counts.astype(np.float32)
    offsets = np.zeros(vocab + 1, np.int64)
    np.add.at(offsets, p_terms + 1, 1)
    offsets = np.cumsum(offsets)
    df = (offsets[1:] - offsets[:-1]).astype(np.int32)
    return dict(docs=p_docs, tf=p_tf, offsets=offsets, df=df,
                doc_len=lens.astype(np.float32))


def split_csr_shards(corpus: dict, n_shards: int) -> list:
    """Split one CSR corpus into ``n_shards`` contiguous doc-range shards
    (vectorized — no per-term Python loop; the bench's stand-in for the
    doc→shard routing an indexing pipeline would do with murmur3)."""
    n_docs = corpus["doc_len"].shape[0]
    vocab = corpus["df"].shape[0]
    per = -(-n_docs // n_shards)
    docs, tf, offsets = corpus["docs"], corpus["tf"], corpus["offsets"]
    term_of = np.repeat(np.arange(vocab, dtype=np.int32),
                        np.diff(offsets).astype(np.int64))
    shard_of = docs // per
    out = []
    for si in range(n_shards):
        keep = shard_of == si
        sterm = term_of[keep]
        ndf = np.bincount(sterm, minlength=vocab).astype(np.int32)
        noff = np.zeros(vocab + 1, np.int64)
        np.cumsum(ndf, out=noff[1:])
        out.append(dict(
            docs=(docs[keep] - si * per).astype(np.int32),
            tf=tf[keep], offsets=noff, df=ndf,
            doc_len=corpus["doc_len"][si * per: (si + 1) * per]))
    return out


def synthetic_csr_corpus_fast(rng: np.random.RandomState, n_docs: int,
                              vocab: int, avg_dl: int,
                              zipf_s: float = 1.2) -> dict:
    """O(P) sort-free Zipf CSR corpus for large benchmarks.

    ``synthetic_csr_corpus`` materializes every token and lexsorts (term,
    doc) — O(P log P) single-threaded, minutes at 2^23 docs. Here the CSR is
    constructed directly in term-major order: per-term document frequencies
    follow the Zipf pmf analytically, and each term's doc-ascending run is a
    sorted uniform sample drawn with the exponential-gap trick (normalized
    per-run cumulative sums of exponentials are order statistics of
    uniforms). Adjacent duplicate docs within a run are dropped and ``df``
    recomputed, so runs stay strictly doc-ascending like SegmentBuilder's.
    """
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    pmf = ranks ** (-zipf_s)
    pmf /= pmf.sum()
    df = np.minimum(n_docs, np.maximum(
        1, np.round(pmf * n_docs * avg_dl))).astype(np.int64)
    p_total = int(df.sum())

    # sorted uniform doc ids per run via normalized exponential-gap cumsums.
    # Memory discipline: everything length-(P+V) is computed IN PLACE on one
    # float64 buffer (peak ≈ 2 such arrays + the int64 docs, not 6 — at the
    # 268M-posting bench config that is the difference between ~7 GB and an
    # OOM-killed bench host)
    gaps = rng.exponential(1.0, p_total + vocab)
    run_ends = np.cumsum(df + 1)
    run_starts = run_ends - (df + 1)
    first_gap = gaps[run_starts].copy()          # small: [V]
    g = np.cumsum(gaps, out=gaps)                # g aliases gaps
    seg_base = g[run_starts] - first_gap         # small: [V]
    g -= np.repeat(seg_base, df + 1)             # per-run cumulative sums
    seg_total = g[run_ends - 1].copy()           # small: [V]
    g /= np.repeat(seg_total, df + 1)            # sorted uniforms per run
    # drop each run's last slot (u == 1, the normalizer)
    keep = np.ones(p_total + vocab, bool)
    keep[run_ends - 1] = False
    docs = np.minimum((g[keep] * n_docs).astype(np.int64), n_docs - 1)
    del gaps, g, keep

    # dedup *within runs*: doc-ascending, so dup iff same as predecessor
    # and not at a run start
    starts0 = np.cumsum(df) - df
    is_start = np.zeros(p_total, bool)
    is_start[starts0] = True
    dup = np.zeros(p_total, bool)
    dup[1:] = docs[1:] == docs[:-1]
    dup &= ~is_start
    docs = docs[~dup]
    term_of = np.repeat(np.arange(vocab, dtype=np.int32), df)[~dup]
    new_df = np.bincount(term_of, minlength=vocab).astype(np.int32)
    offsets = np.zeros(vocab + 1, np.int64)
    np.cumsum(new_df, out=offsets[1:])

    tf = (1.0 + rng.poisson(0.35, docs.shape[0])).astype(np.float32)
    doc_len = np.maximum(1, rng.poisson(avg_dl, n_docs)).astype(np.float32)
    return dict(docs=docs.astype(np.int32), tf=tf, offsets=offsets,
                df=new_df, doc_len=doc_len)
