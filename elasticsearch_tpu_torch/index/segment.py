"""Immutable index segments with device-resident postings and doc values
(port of ``elasticsearch_tpu/index/segment.py``).

The host arrays and the builder are a copy of the reference's; the device
arrays are torch tensors on the segment's device, ``cuda`` unless the
caller passes ``device="cpu"``:

- text fields: flat CSR postings ``docs_dev`` i32[P_pad] (padded with
  ``n_pad``, a doc no query reaches) and ``tf_dev`` f32[P_pad], and
  ``doc_len_dev`` f32[n_pad]. Each run holds a doc at most once, docs
  ascending. Scored by ``ops/bm25.py`` (K16), matched by ``ops/masks.py``.
- keyword fields: postings ``docs_dev`` and the (ordinal, doc) doc-values
  pairs ``dv_ords_dev``/``dv_docs_dev`` (pad ordinal 0, pad doc ``n_pad``).
- numeric/date/boolean fields: each pair's int32 rank among the segment's
  sorted distinct values (``ranks_dev``, pad 0) and its doc (``docs_dev``):
  range bounds are searched into rank space on the host in exact f64.
- dense_vector fields: ``matrix_dev`` f32[n_pad, D].

Deletes are a host liveness bitmask; ``live_dev`` and ``parent_mask_dev``
are built on the segment's device at first use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.shapes import round_up_pow2
from .mapping import ParsedDocument


# ---------------------------------------------------------------------------
# Per-field data
# ---------------------------------------------------------------------------


@dataclass
class TextFieldData:
    """CSR postings for one text field."""

    term_ids: Dict[str, int]                 # term -> tid
    df: np.ndarray                           # int32[V] doc freq per term
    offsets: np.ndarray                      # int64[V+1] into flat postings
    docs_host: np.ndarray                    # int32[P]
    tf_host: np.ndarray                      # float32[P]
    doc_len_host: np.ndarray                 # float32[N]
    sum_dl: float                            # total tokens in field
    field_doc_count: int                     # docs that have this field
    total_term_freq: np.ndarray              # int64[V] sum tf per term
    pos_offsets: np.ndarray                  # int64[P+1] into pos_flat
    pos_flat: np.ndarray                     # int32[total positions]
    docs_dev: torch.Tensor = None             # int32[P_pad]
    tf_dev: torch.Tensor = None               # float32[P_pad]
    doc_len_dev: torch.Tensor = None          # float32[N_pad]

    def term_run(self, term: str) -> Tuple[int, int, int]:
        """(start, length, df) of a term's postings run; absent → (P, 0, 0)."""
        tid = self.term_ids.get(term)
        if tid is None:
            return int(self.docs_host.shape[0]), 0, 0
        return (int(self.offsets[tid]), int(self.offsets[tid + 1] - self.offsets[tid]),
                int(self.df[tid]))

    def positions_for(self, term: str, doc: int) -> np.ndarray:
        """Host-side positions of ``term`` in local doc ``doc`` (for phrase)."""
        start, length, _ = self.term_run(term)
        if length == 0:
            return np.empty(0, np.int32)
        run = self.docs_host[start:start + length]
        i = np.searchsorted(run, doc)
        if i >= length or run[i] != doc:
            return np.empty(0, np.int32)
        p = start + i
        return self.pos_flat[self.pos_offsets[p]:self.pos_offsets[p + 1]]


@dataclass
class KeywordFieldData:
    """Postings + ordinal doc-values pairs for one keyword field."""

    ord_terms: List[str]                     # ord -> term (sorted)
    term_ords: Dict[str, int]                # term -> ord
    df: np.ndarray                           # int32[V]
    offsets: np.ndarray                      # int64[V+1]
    docs_host: np.ndarray                    # int32[P] postings doc ids
    dv_ords_host: np.ndarray                 # int32[M] value ordinal per pair
    dv_docs_host: np.ndarray                 # int32[M] owning doc per pair
    docs_dev: torch.Tensor = None
    dv_ords_dev: torch.Tensor = None
    dv_docs_dev: torch.Tensor = None
    #: a scored clause's K16 inputs, made at first use (bm25_constants)
    bm25_dev: Tuple[torch.Tensor, torch.Tensor] = None

    def bm25_constants(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(tf f32[P_pad] of ones, doc lengths f32[1] of zeros) on the
        postings' device: norms-disabled BM25's inputs to K16, made once a
        field and reused by every scored clause. One doc length is as
        exact as one a doc: with b = 0 the length enters as (0 * dl) /
        avgdl, and every dl read is 0 (doc 0 reads the zero, any other
        doc reads the fill 0)."""
        if self.bm25_dev is None:
            dev = self.docs_dev.device
            self.bm25_dev = (
                torch.ones(self.docs_dev.shape[0], dtype=torch.float32,
                           device=dev),
                torch.zeros(1, dtype=torch.float32, device=dev))
        return self.bm25_dev

    def term_run(self, term: str) -> Tuple[int, int, int]:
        o = self.term_ords.get(term)
        if o is None:
            return int(self.docs_host.shape[0]), 0, 0
        return (int(self.offsets[o]), int(self.offsets[o + 1] - self.offsets[o]),
                int(self.df[o]))


@dataclass
class NumericFieldData:
    """(value, doc) pair column.

    The device column stores each pair's int32 RANK among the segment's
    sorted distinct values, not the value itself: range bounds are
    binary-searched into rank space on the host (exact f64 compares) and
    the device compares integers — exact at ANY value span, where a
    float32 value/offset column would overflow or collapse neighboring
    values (the round-2 ±inf corruption on wide-span longs/doubles)."""

    base: float                              # float64 min value (store manifest)
    vals_host: np.ndarray                    # float64[M] exact values
    docs_host: np.ndarray                    # int32[M]
    uniq_vals: np.ndarray = None             # float64[U] sorted distinct values
    ranks_dev: torch.Tensor = None            # int32[M_pad] rank per pair
    docs_dev: torch.Tensor = None             # int32[M_pad]


@dataclass
class VectorFieldData:
    matrix_host: np.ndarray                  # float32[N, D]
    exists: np.ndarray                       # bool[N]
    matrix_dev: torch.Tensor = None           # float32[N_pad, D]
    # segment-lifetime corpus invariant, built once on first use and
    # reused by every cosine query against this column (segments are
    # immutable, so it can never go stale)
    unit_dev: torch.Tensor = None             # row-normalized matrix_dev

    def unit_matrix_dev(self) -> torch.Tensor:
        """Unit-normalized rows — computed ONCE per segment column, not
        per query (the old cosine path re-normalized the whole segment on
        every knn clause / script_score call)."""
        if self.unit_dev is None:
            m = self.matrix_dev
            self.unit_dev = m / torch.clamp_min(
                torch.linalg.vector_norm(m, dim=-1, keepdim=True), 1e-12)
        return self.unit_dev


# ---------------------------------------------------------------------------
# Segment
# ---------------------------------------------------------------------------


class Segment:
    """One immutable generation of indexed docs, device arrays attached."""

    def __init__(self, seg_id: str, n_docs: int, doc_uids: List[str],
                 sources: List[Optional[dict]], seq_nos: np.ndarray,
                 text_fields: Dict[str, TextFieldData],
                 keyword_fields: Dict[str, KeywordFieldData],
                 numeric_fields: Dict[str, NumericFieldData],
                 vector_fields: Dict[str, VectorFieldData],
                 parent_of: Optional[np.ndarray] = None,
                 nested_paths: Optional[Dict[str, np.ndarray]] = None,
                 device=None):
        self.seg_id = seg_id
        self.device = resolve_device(device)
        self.n_docs = n_docs
        self.n_pad = round_up_pow2(max(n_docs, 1))
        self.doc_uids = doc_uids
        self.sources = sources
        self.seq_nos = seq_nos                      # int64[N]
        self.text_fields = text_fields
        self.keyword_fields = keyword_fields
        self.numeric_fields = numeric_fields
        self.vector_fields = vector_fields
        # block join: child -> parent pointers (self for top-level docs)
        # and per-nested-path child marks; parent_mask excludes hidden
        # children from every top-level query/agg/fetch
        self.parent_of = (parent_of if parent_of is not None
                          else np.arange(n_docs, dtype=np.int32))
        self.nested_paths = nested_paths or {}
        self.parent_mask = self.parent_of == np.arange(n_docs,
                                                       dtype=np.int32)
        self._parent_mask_dev: Optional[torch.Tensor] = None
        self._children_of: Optional[Dict[int, List[int]]] = None
        self.live = np.ones(n_docs, dtype=bool)     # host liveness (deletes)
        self._live_dev: Optional[torch.Tensor] = None
        self._fv_columns: Dict[str, np.ndarray] = {}
        # hidden nested children never resolve by uid: a user doc whose id
        # happens to collide with a synthetic child uid must win
        self._uid_to_doc: Dict[str, int] = {
            u: i for i, u in enumerate(doc_uids) if self.parent_mask[i]}
        self._upload()

    # -- device upload -------------------------------------------------------

    def _upload(self) -> None:
        n_pad = self.n_pad
        dev = self.device

        def up(arr, dtype):
            return torch.as_tensor(np.ascontiguousarray(arr, dtype),
                                   device=dev)

        for f in self.text_fields.values():
            p_pad = round_up_pow2(max(f.docs_host.shape[0], 1))
            f.docs_dev = up(_pad_to(f.docs_host, p_pad, n_pad), np.int32)
            f.tf_dev = up(_pad_to(f.tf_host, p_pad, 0.0), np.float32)
            f.doc_len_dev = up(_pad_to(f.doc_len_host, n_pad, 0.0),
                               np.float32)
        for f in self.keyword_fields.values():
            p_pad = round_up_pow2(max(f.docs_host.shape[0], 1))
            m_pad = round_up_pow2(max(f.dv_docs_host.shape[0], 1))
            f.docs_dev = up(_pad_to(f.docs_host, p_pad, n_pad), np.int32)
            f.dv_ords_dev = up(_pad_to(f.dv_ords_host, m_pad, 0), np.int32)
            f.dv_docs_dev = up(_pad_to(f.dv_docs_host, m_pad, n_pad),
                               np.int32)
        for f in self.numeric_fields.values():
            m_pad = round_up_pow2(max(f.docs_host.shape[0], 1))
            f.uniq_vals, inv = np.unique(f.vals_host, return_inverse=True)
            f.ranks_dev = up(_pad_to(inv.astype(np.int32), m_pad, 0),
                             np.int32)
            f.docs_dev = up(_pad_to(f.docs_host, m_pad, n_pad), np.int32)
        for f in self.vector_fields.values():
            d = f.matrix_host.shape[1] if f.matrix_host.size else 0
            mat = np.zeros((n_pad, d), np.float32)
            mat[: f.matrix_host.shape[0]] = f.matrix_host
            f.matrix_dev = up(mat, np.float32)

    # -- liveness ------------------------------------------------------------

    def delete_doc(self, local_doc: int) -> None:
        self.live[local_doc] = False
        # cascade: a doc's hidden nested descendants die with it
        # (recursive — multi-level nesting chains parent pointers)
        if len(self.nested_paths):
            if self._children_of is None:
                cmap: Dict[int, List[int]] = {}
                for c in np.flatnonzero(~self.parent_mask):
                    cmap.setdefault(int(self.parent_of[c]), []).append(int(c))
                self._children_of = cmap
            stack = list(self._children_of.get(local_doc, ()))
            while stack:
                c = stack.pop()
                self.live[c] = False
                stack.extend(self._children_of.get(c, ()))
        self._live_dev = None

    @property
    def live_dev(self) -> torch.Tensor:
        if self._live_dev is None:
            padded = np.zeros(self.n_pad, dtype=bool)
            padded[: self.n_docs] = self.live
            self._live_dev = torch.as_tensor(padded, device=self.device)
        return self._live_dev

    @property
    def parent_mask_dev(self) -> torch.Tensor:
        if self._parent_mask_dev is None:
            padded = np.zeros(self.n_pad, dtype=bool)
            padded[: self.n_docs] = self.parent_mask
            self._parent_mask_dev = torch.as_tensor(padded,
                                                    device=self.device)
        return self._parent_mask_dev

    @property
    def has_nested(self) -> bool:
        return bool(self.nested_paths)

    @property
    def live_count(self) -> int:
        return int(self.live.sum())

    @property
    def live_parent_count(self) -> int:
        """User-visible doc count: hidden nested children excluded (the
        reference's _count likewise only sees top-level docs)."""
        if not self.nested_paths:
            return int(self.live.sum())
        return int((self.live & self.parent_mask).sum())

    def find_doc(self, uid: str) -> Optional[int]:
        d = self._uid_to_doc.get(uid)
        if d is not None and self.live[d]:
            return d
        return None

    # -- doc-values columns --------------------------------------------------

    def numeric_first_value_column(self, field: str) -> np.ndarray:
        """Dense float64[n_pad] column of the field's first value per doc
        (NaN where absent); cached. Sort keys, script doc access and
        function_score all read this."""
        col = self._fv_columns.get(field)
        if col is None:
            col = np.full(self.n_pad, np.nan)
            f = self.numeric_fields.get(field)
            if f is not None:
                # reverse fill keeps the first (lowest-index) pair per doc
                col[f.docs_host[::-1]] = f.vals_host[::-1]
            self._fv_columns[field] = col
        return col

    # -- stats for idf -------------------------------------------------------

    def field_stats(self, field: str) -> Tuple[float, int]:
        """(sum_dl, field_doc_count) for avgdl computation."""
        f = self.text_fields.get(field)
        if f is None:
            return 0.0, 0
        return f.sum_dl, f.field_doc_count

    def term_df(self, field: str, term: str) -> int:
        f = self.text_fields.get(field)
        if f is not None:
            return f.term_run(term)[2]
        kf = self.keyword_fields.get(field)
        if kf is not None:
            return kf.term_run(term)[2]
        return 0


def _pad_to(arr: np.ndarray, size: int, fill) -> np.ndarray:
    if arr.shape[0] == size:
        return arr
    out = np.full(size, fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


# ---------------------------------------------------------------------------
# Host state: a built segment as plain Python and numpy
# ---------------------------------------------------------------------------

#: per field kind: (its dataclass, the host attributes a state carries)
_FIELD_KINDS = {
    "text_fields": (TextFieldData, (
        "term_ids", "df", "offsets", "docs_host", "tf_host", "doc_len_host",
        "sum_dl", "field_doc_count", "total_term_freq", "pos_offsets",
        "pos_flat")),
    "keyword_fields": (KeywordFieldData, (
        "ord_terms", "term_ords", "df", "offsets", "docs_host",
        "dv_ords_host", "dv_docs_host")),
    "numeric_fields": (NumericFieldData, ("base", "vals_host", "docs_host")),
    "vector_fields": (VectorFieldData, ("matrix_host", "exists")),
}


def segment_host_state(seg) -> dict:
    """A built segment's host arrays as plain Python and numpy: what
    :func:`segment_from_host_state` takes. It reads attributes only, so a
    segment of another package with the same layout gives the same
    state (the tests hand the JAX reference's segments across this way)."""
    state = dict(
        seg_id=seg.seg_id, n_docs=int(seg.n_docs),
        doc_uids=list(seg.doc_uids), sources=list(seg.sources),
        seq_nos=np.asarray(seg.seq_nos, np.int64),
        parent_of=np.asarray(seg.parent_of, np.int32),
        nested_paths={p: np.asarray(m, bool)
                      for p, m in seg.nested_paths.items()},
        live=np.asarray(seg.live, bool),
        int64_fields={f: (np.asarray(d, np.int32), np.asarray(v, np.int64))
                      for f, (d, v) in getattr(seg, "int64_fields",
                                               {}).items()})
    for kind, (_, attrs) in _FIELD_KINDS.items():
        state[kind] = {
            name: {a: (np.asarray(getattr(f, a))
                       if hasattr(getattr(f, a), "__array__")
                       else getattr(f, a)) for a in attrs}
            for name, f in getattr(seg, kind).items()}
    return state


def segment_from_host_state(state: dict, device=None) -> Segment:
    """A :class:`Segment` on ``device`` (``None`` means ``cuda``) from a
    host state: the dict :func:`segment_host_state` returns, or one built
    directly with the same keys (``parent_of``, ``nested_paths``, ``live``
    and ``int64_fields`` may be left out: no nesting, no deletes)."""
    fields = {kind: {name: cls(**attrs)
                     for name, attrs in state.get(kind, {}).items()}
              for kind, (cls, _) in _FIELD_KINDS.items()}
    seg = Segment(state["seg_id"], state["n_docs"], list(state["doc_uids"]),
                  list(state["sources"]),
                  np.asarray(state["seq_nos"], np.int64),
                  fields["text_fields"], fields["keyword_fields"],
                  fields["numeric_fields"], fields["vector_fields"],
                  parent_of=state.get("parent_of"),
                  nested_paths=state.get("nested_paths"), device=device)
    seg.int64_fields = dict(state.get("int64_fields", {}))
    live = state.get("live")
    if live is not None:
        seg.live[:] = live
    return seg


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------


class SegmentBuilder:
    """Accumulates parsed documents (the in-memory indexing buffer —
    analogue of Lucene's IndexWriter RAM buffer inside
    ``index/engine/InternalEngine.java:123``) and freezes them into a
    :class:`Segment` on refresh."""

    def __init__(self, seg_id: str):
        self.seg_id = seg_id
        self.doc_uids: List[str] = []
        self.sources: List[Optional[dict]] = []
        self.seq_nos: List[int] = []
        # local ids deleted before the segment is frozen (doc updated or
        # removed while still in the buffer); applied to `live` at build()
        self.deleted: set = set()
        # block-join bookkeeping: child local id -> parent local id / path
        self.parent_of: Dict[int, int] = {}
        self.nested_path_of: Dict[int, str] = {}
        # field -> term -> list[(doc, tf)] built doc-ascending
        self._text_postings: Dict[str, Dict[str, List[Tuple[int, int]]]] = {}
        # field -> term -> doc -> positions
        self._text_positions: Dict[str, Dict[str, Dict[int, List[int]]]] = {}
        self._doc_len: Dict[str, Dict[int, int]] = {}
        self._keyword_postings: Dict[str, Dict[str, List[int]]] = {}
        self._keyword_values: Dict[str, List[Tuple[int, str]]] = {}  # (doc, term)
        self._numeric_values: Dict[str, List[Tuple[int, float]]] = {}
        # exact int64 doc values (date_nanos): host-side, never floats
        self._int64_values: Dict[str, List[Tuple[int, int]]] = {}
        self._vectors: Dict[str, Dict[int, np.ndarray]] = {}

    def __len__(self) -> int:
        return len(self.doc_uids)

    @property
    def n_docs(self) -> int:
        return len(self.doc_uids)

    def add(self, parsed: ParsedDocument, seq_no: int,
            store_source: bool = True) -> int:
        """Index one parsed document (plus its block-joined nested
        children, Lucene block order: children first, RECURSIVELY — a
        grandchild's parent pointer targets its immediate nested parent,
        so multi-level paths join level by level like the reference's
        stacked ToParentBlockJoin); returns the top local doc id."""
        return self._add_block(parsed, seq_no, store_source)

    def _add_block(self, parsed: ParsedDocument, seq_no: int,
                   store_source: bool) -> int:
        child_ids = []
        for path, child in parsed.nested_docs:
            cid = self._add_block(child, seq_no, store_source=False)
            self.nested_path_of[cid] = path
            child_ids.append(cid)
        doc = self._add_single(parsed, seq_no, store_source)
        for cid in child_ids:
            self.parent_of[cid] = doc
        return doc

    def _add_single(self, parsed: ParsedDocument, seq_no: int,
                    store_source: bool = True) -> int:
        doc = len(self.doc_uids)
        self.doc_uids.append(parsed.doc_id)
        self.sources.append(parsed.source if store_source else None)
        self.seq_nos.append(seq_no)

        for field, tokens in parsed.text_tokens.items():
            postings = self._text_postings.setdefault(field, {})
            positions = self._text_positions.setdefault(field, {})
            per_term_pos: Dict[str, List[int]] = {}
            for t in tokens:
                per_term_pos.setdefault(t.term, []).append(t.position)
            for term, plist in per_term_pos.items():
                postings.setdefault(term, []).append((doc, len(plist)))
                positions.setdefault(term, {})[doc] = plist
            if tokens:
                self._doc_len.setdefault(field, {})[doc] = len(tokens)

        for field, terms in parsed.keyword_terms.items():
            postings = self._keyword_postings.setdefault(field, {})
            values = self._keyword_values.setdefault(field, [])
            for term in set(terms):
                postings.setdefault(term, []).append(doc)
            for term in terms:
                values.append((doc, term))

        for field, vals in parsed.numeric_values.items():
            lst = self._numeric_values.setdefault(field, [])
            for v in vals:
                lst.append((doc, float(v)))

        for field, ivals in parsed.int64_values.items():
            ilst = self._int64_values.setdefault(field, [])
            for v in ivals:
                ilst.append((doc, int(v)))

        for field, vec in parsed.vectors.items():
            self._vectors.setdefault(field, {})[doc] = vec

        return doc

    def build(self, device=None) -> Segment:
        """Freeze the buffer into a :class:`Segment` whose device arrays
        lie on ``device`` (``None`` means ``cuda``)."""
        n = len(self.doc_uids)

        text_fields: Dict[str, TextFieldData] = {}
        for field, postings in self._text_postings.items():
            terms_sorted = sorted(postings)
            term_ids = {t: i for i, t in enumerate(terms_sorted)}
            v = len(terms_sorted)
            df = np.zeros(v, np.int32)
            ttf = np.zeros(v, np.int64)
            offsets = np.zeros(v + 1, np.int64)
            total = sum(len(postings[t]) for t in terms_sorted)
            docs = np.zeros(total, np.int32)
            tf = np.zeros(total, np.float32)
            pos_offsets = np.zeros(total + 1, np.int64)
            pos_chunks: List[List[int]] = []
            p = 0
            positions = self._text_positions[field]
            for i, term in enumerate(terms_sorted):
                run = postings[term]
                df[i] = len(run)
                offsets[i] = p
                for d, f_ in run:
                    docs[p] = d
                    tf[p] = f_
                    ttf[i] += f_
                    pos_chunks.append(positions[term][d])
                    pos_offsets[p + 1] = pos_offsets[p] + f_
                    p += 1
                offsets[i + 1] = p
            pos_flat = (np.concatenate([np.asarray(c, np.int32) for c in pos_chunks])
                        if pos_chunks else np.empty(0, np.int32))
            dl_map = self._doc_len.get(field, {})
            doc_len = np.zeros(n, np.float32)
            for d, l in dl_map.items():
                doc_len[d] = l
            text_fields[field] = TextFieldData(
                term_ids=term_ids, df=df, offsets=offsets, docs_host=docs,
                tf_host=tf, doc_len_host=doc_len, sum_dl=float(doc_len.sum()),
                field_doc_count=len(dl_map), total_term_freq=ttf,
                pos_offsets=pos_offsets, pos_flat=pos_flat)

        keyword_fields: Dict[str, KeywordFieldData] = {}
        for field, postings in self._keyword_postings.items():
            terms_sorted = sorted(postings)
            term_ords = {t: i for i, t in enumerate(terms_sorted)}
            v = len(terms_sorted)
            df = np.zeros(v, np.int32)
            offsets = np.zeros(v + 1, np.int64)
            total = sum(len(postings[t]) for t in terms_sorted)
            docs = np.zeros(total, np.int32)
            p = 0
            for i, term in enumerate(terms_sorted):
                run = postings[term]
                df[i] = len(run)
                offsets[i] = p
                docs[p: p + len(run)] = run
                p += len(run)
                offsets[i + 1] = p
            pairs = self._keyword_values.get(field, [])
            dv_docs = np.asarray([d for d, _ in pairs], np.int32)
            dv_ords = np.asarray([term_ords[t] for _, t in pairs], np.int32)
            keyword_fields[field] = KeywordFieldData(
                ord_terms=terms_sorted, term_ords=term_ords, df=df,
                offsets=offsets, docs_host=docs, dv_ords_host=dv_ords,
                dv_docs_host=dv_docs)

        numeric_fields: Dict[str, NumericFieldData] = {}
        for field, pairs in self._numeric_values.items():
            docs = np.asarray([d for d, _ in pairs], np.int32)
            vals = np.asarray([v for _, v in pairs], np.float64)
            base = float(vals.min()) if vals.size else 0.0
            numeric_fields[field] = NumericFieldData(
                base=base, vals_host=vals, docs_host=docs)

        vector_fields: Dict[str, VectorFieldData] = {}
        for field, rows in self._vectors.items():
            dim = next(iter(rows.values())).shape[0]
            mat = np.zeros((n, dim), np.float32)
            exists = np.zeros(n, bool)
            for d, vec in rows.items():
                mat[d] = vec
                exists[d] = True
            vector_fields[field] = VectorFieldData(matrix_host=mat, exists=exists)

        parent_of = np.arange(n, dtype=np.int32)
        for c, p in self.parent_of.items():
            parent_of[c] = p
        nested_paths: Dict[str, np.ndarray] = {}
        for c, path in self.nested_path_of.items():
            m = nested_paths.get(path)
            if m is None:
                m = nested_paths[path] = np.zeros(n, bool)
            m[c] = True
        seg = Segment(self.seg_id, n, list(self.doc_uids), list(self.sources),
                      np.asarray(self.seq_nos, np.int64), text_fields,
                      keyword_fields, numeric_fields, vector_fields,
                      parent_of=parent_of, nested_paths=nested_paths,
                      device=device)
        # exact int64 doc values (date_nanos) ride as a host-side extra:
        # {field: (docs int32[], vals int64[])}
        seg.int64_fields = {
            f: (np.asarray([d for d, _ in pairs], np.int32),
                np.asarray([v for _, v in pairs], np.int64))
            for f, pairs in self._int64_values.items()}
        for local in self.deleted:
            seg.delete_doc(local)
        return seg
