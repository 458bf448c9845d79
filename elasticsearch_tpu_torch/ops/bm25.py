"""BM25 constants and the idf weight (from ``elasticsearch_tpu/ops/bm25.py``).

Only what the serving plane needs is here; the per-segment dense scatter
scorer (``bm25_score_body``) is still to be ported.
"""

from __future__ import annotations

import numpy as np

# Elasticsearch defaults (SimilarityService: BM25 with k1=1.2, b=0.75).
DEFAULT_K1 = 1.2
DEFAULT_B = 0.75


def idf_weight(n_docs: int, doc_freq) -> np.ndarray:
    """Lucene BM25 idf: ln(1 + (N - df + 0.5) / (df + 0.5))."""
    df = np.asarray(doc_freq, dtype=np.float64)
    return np.log(1.0 + (np.float64(n_docs) - df + 0.5)
                  / (df + 0.5)).astype(np.float32)
