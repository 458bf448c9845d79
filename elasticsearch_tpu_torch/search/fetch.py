"""Fetch phase: turn matched (segment, doc) pairs into response hits.

Re-design of the reference fetch phase (``search/fetch/FetchPhase.java:73``
+ 15 sub-phases under ``search/fetch/subphase/``): _source loading and
filtering, docvalue_fields, stored fields and highlighting. Fetch is pure
host work over the tiny top-k result set — nothing here touches the device
(the reference similarly runs fetch on the much smaller hit list).
"""

from __future__ import annotations

import fnmatch
import re
from typing import Any, Dict, List, Optional, Sequence

from ..common.errors import IllegalArgumentError, ParsingError
from ..index.mapping import (DateFieldType, MapperService, format_date_millis)
from ..index.segment import Segment


# ---------------------------------------------------------------------------
# _source filtering (reference: search/fetch/subphase/FetchSourcePhase.java)
# ---------------------------------------------------------------------------


def _match_any(path: str, patterns: Sequence[str]) -> bool:
    return any(fnmatch.fnmatchcase(path, p) or path.startswith(p + ".")
               or fnmatch.fnmatchcase(path.split(".")[0], p)
               for p in patterns)


def _filter_tree(obj: Any, prefix: str, includes, excludes):
    if not isinstance(obj, dict):
        return obj
    out = {}
    for k, v in obj.items():
        path = f"{prefix}{k}"
        if excludes and _match_any(path, excludes):
            continue
        if includes:
            # keep if the path matches, or is an ancestor of a match
            direct = _match_any(path, includes)
            ancestor = any(p.startswith(path + ".") for p in includes)
            if not direct and not ancestor:
                continue
            if not direct and ancestor and isinstance(v, dict):
                v = _filter_tree(v, path + ".", includes, excludes)
                if not v:
                    continue
                out[k] = v
                continue
        if isinstance(v, dict):
            out[k] = _filter_tree(v, path + ".", None, excludes)
        else:
            out[k] = v
    return out


def filter_source(source: Optional[dict], spec) -> Optional[dict]:
    """Apply the request's ``_source`` spec: True/False, "field", ["f1",
    "f2*"], or {"includes": [...], "excludes": [...]}."""
    if source is None or spec is True or spec is None:
        return source
    if spec is False:
        return None
    if isinstance(spec, str):
        spec = [spec]
    if isinstance(spec, list):
        return _filter_tree(source, "", spec, None)
    if isinstance(spec, dict):
        inc = spec.get("includes") or spec.get("include")
        exc = spec.get("excludes") or spec.get("exclude")
        if isinstance(inc, str):
            inc = [inc]
        if isinstance(exc, str):
            exc = [exc]
        return _filter_tree(source, "", inc or None, exc or None)
    raise ParsingError(f"invalid _source spec [{spec}]")


# ---------------------------------------------------------------------------
# docvalue_fields (reference: subphase/FetchDocValuesPhase.java)
# ---------------------------------------------------------------------------


def format_date_ns(ns: int, pattern: str) -> str:
    """Java-pattern render at NANOS resolution, with quoted literals
    ('T'), u-years, long S runs and X zone (date_nanos docvalue
    formats)."""
    import datetime
    dt = datetime.datetime.fromtimestamp(
        (ns // 10 ** 9), tz=datetime.timezone.utc)
    frac9 = f"{ns % 10 ** 9:09d}"
    reps = {"y": "%Y", "u": "%Y", "M": "%m", "d": "%d", "H": "%H",
            "m": "%M", "s": "%S"}

    def _render(m):
        if m.group(1) is not None:          # 'quoted literal'
            return m.group(1)[1:-1] or "'"
        run = m.group(0)
        c = run[0]
        if c == "S":
            return frac9[: len(run)]
        if c in ("X", "Z"):
            return "Z" if c == "X" else "+0000"
        if set(run) == {"e"}:
            return str(dt.isoweekday()).rjust(len(run), "0")
        if c in reps:
            return dt.strftime(reps[c])
        return run
    import re as _re
    return _re.sub(r"('(?:[^']|'')*')|([a-zA-Z])\2*",
                   lambda m: _render(m), pattern)


def docvalue_fields(seg: Segment, mapper: MapperService, local_doc: int,
                    specs: Sequence) -> Dict[str, List[Any]]:
    out: Dict[str, List[Any]] = {}
    for spec in specs:
        if isinstance(spec, dict):
            field = spec.get("field")
            fmt = spec.get("format")
        else:
            field, fmt = spec, None
        if field is None:
            raise ParsingError("docvalue_fields entries require [field]")
        if field == "_seq_no":
            out["_seq_no"] = [int(seg.seq_nos[local_doc])]
            continue
        ft = mapper.field_type(field)
        vals: List[Any] = []
        is_ns = isinstance(ft, DateFieldType) and ft.nanos
        if is_ns:
            i64 = getattr(seg, "int64_fields", {}).get(ft.name or field)
            if i64 is not None:
                idocs, ivals = i64
                sel64 = idocs == local_doc
                ns_list = ivals[sel64].tolist()
            else:
                ns_list = []
        nf = seg.numeric_fields.get(field)
        if nf is not None:
            sel = nf.docs_host == local_doc
            is_date = isinstance(ft, DateFieldType)
            for vi, v in enumerate(nf.vals_host[sel]):
                ns = 0
                if is_ns and vi < len(ns_list):
                    ns = ns_list[vi]
                elif is_date:
                    # integral ms → exact int arithmetic (float64*1e6
                    # rounds off the low digits at epoch scale)
                    ns = int(v) * 10 ** 6 if float(v).is_integer() \
                        else int(round(float(v) * 1e6))
                if fmt is not None and "#" in fmt:
                    vals.append(decimal_format(float(v), fmt))
                elif isinstance(ft, DateFieldType) and fmt == \
                        "epoch_millis":
                    rem = ns % 10 ** 6
                    vals.append(f"{ns // 10 ** 6}.{rem:06d}" if rem
                                else str(ns // 10 ** 6))
                elif isinstance(ft, DateFieldType) and fmt not in (
                        None, "strict_date_optional_time", "date"):
                    vals.append(format_date_ns(ns, fmt)
                                if ("'" in fmt or "S" * 4 in fmt
                                    or "X" in fmt or "u" in fmt or is_ns)
                                else java_date_format(float(v), fmt))
                elif isinstance(ft, DateFieldType) or fmt in (
                        "date", "strict_date_optional_time"):
                    vals.append(format_date_millis(ns // 10 ** 6
                                                   if is_ns
                                                   else float(v)))
                elif float(v).is_integer() and ft is not None and \
                        getattr(ft, "type_name", "") in (
                            "long", "integer", "short", "byte"):
                    vals.append(int(v))
                else:
                    vals.append(float(v))
        kf = seg.keyword_fields.get(field)
        if kf is not None:
            sel = kf.dv_docs_host == local_doc
            vals.extend(kf.ord_terms[o] for o in kf.dv_ords_host[sel])
        if vals:
            # repeated specs for one field (different formats) append in
            # spec order, like FetchDocValuesPhase
            out.setdefault(field, []).extend(vals)
    return out


# ---------------------------------------------------------------------------
# highlight (reference: subphase/highlight/ — unified highlighter)
# ---------------------------------------------------------------------------


def _best_fragments(text: str, spans: List, fragment_size: int,
                    number_of_fragments: int,
                    pre: str, post: str) -> List[str]:
    """Split around matched spans into up-to-N fragments with tags."""
    if not spans:
        return []
    spans.sort()
    if number_of_fragments == 0:
        # whole field value as one fragment
        frags = [(0, len(text), spans)]
    else:
        frags = []
        used: set = set()
        for start, end in spans:
            fs = max(0, start - fragment_size // 2)
            fe = min(len(text), fs + fragment_size)
            key = fs // max(fragment_size, 1)
            if key in used:
                continue
            used.add(key)
            inside = [(s, e) for s, e in spans if s >= fs and e <= fe]
            frags.append((fs, fe, inside))
            if len(frags) >= number_of_fragments:
                break
    out = []
    for fs, fe, inside in frags:
        parts = []
        cur = fs
        for s, e in inside:
            parts.append(text[cur:s])
            parts.append(pre + text[s:e] + post)
            cur = e
        parts.append(text[cur:fe])
        out.append("".join(parts))
    return out


def highlight(mapper: MapperService, source: Optional[dict],
              highlight_spec: dict,
              query_terms: Dict[str, set]) -> Dict[str, List[str]]:
    """Highlight query terms in the hit's source values. The analyzer's
    token offsets locate match spans; tags wrap them."""
    if not source:
        return {}
    fields_spec = highlight_spec.get("fields", {})
    if isinstance(fields_spec, list):  # ES also allows a list of singletons
        merged = {}
        for f in fields_spec:
            merged.update(f)
        fields_spec = merged
    pre = (highlight_spec.get("pre_tags") or ["<em>"])[0]
    post = (highlight_spec.get("post_tags") or ["</em>"])[0]
    field_terms = highlight_spec.get("_field_terms") or {}
    max_ao = highlight_spec.get("_max_analyzed_offset")
    # wildcard field patterns expand over the mapping (ES matches every
    # mapped field; only those with terms produce output)
    expanded: Dict[str, dict] = {}
    for field, fspec in fields_spec.items():
        if "*" in field:
            from ..index.mapping import resolve_field_patterns
            for name in resolve_field_patterns(mapper, field):
                expanded.setdefault(name, fspec)
        else:
            expanded[field] = fspec
    out: Dict[str, List[str]] = {}
    for field, fspec in expanded.items():
        fspec = fspec or {}
        frag_size = int(fspec.get("fragment_size",
                                  highlight_spec.get("fragment_size", 100)))
        n_frags = int(fspec.get("number_of_fragments",
                                highlight_spec.get("number_of_fragments", 5)))
        ft = mapper.field_type(field)
        if ft is None:
            continue
        rfm = fspec.get("require_field_match",
                        highlight_spec.get("require_field_match", True))
        if field in field_terms:            # highlight_query override
            terms = field_terms[field]
        elif rfm in (False, "false"):
            # any query term from any field may highlight this one
            terms = set().union(*query_terms.values()) \
                if query_terms else set()
        else:
            terms = query_terms.get(field, set())
            if not terms and "." in field:
                # multi-field subfield: fall back to the parent's terms
                terms = query_terms.get(field.rsplit(".", 1)[0], set())
        if not terms:
            continue
        # walk the source path (multi-field subfields read the parent's
        # source value, like the reference's SourceFieldMapper lookup)
        def _walk(path):
            v = source
            for part in path.split("."):
                if not isinstance(v, dict) or part not in v:
                    return None
                v = v[part]
            return v
        value = _walk(field)
        if value is None and "." in field:
            value = _walk(field.rsplit(".", 1)[0])
        if value is None:
            continue
        values = value if isinstance(value, list) else [value]
        analyzer = getattr(ft, "search_analyzer", None) or \
            getattr(ft, "analyzer", None)
        frags: List[str] = []
        ign = getattr(ft, "ignore_above", None)
        if max_ao is not None:
            # re-analysis beyond the cap is rejected; offsets stored at
            # index time (index_options offsets / term vectors) let the
            # unified and fvh highlighters skip re-analysis
            has_offsets = ft.params.get("index_options") == "offsets" or \
                ft.params.get("term_vector") == "with_positions_offsets"
            hl_type = fspec.get("type", highlight_spec.get("type"))
            needs_analysis = hl_type == "plain" or not has_offsets
            if needs_analysis and any(len(str(v)) > max_ao
                                      for v in values):
                raise IllegalArgumentError(
                    f"The length of [{field}] field of a doc exceeds "
                    f"the [index.highlight.max_analyzed_offset] limit "
                    f"of [{max_ao}]. To avoid this error, set the query "
                    f"parameter [max_analyzed_offset] to a value less "
                    f"than index setting value and this will tolerate "
                    f"long field values by truncating them.")
        for v in values:
            text = str(v)
            if ign is not None and len(text) > ign:
                continue    # value was ignored at index time: no marks
            spans = []
            if analyzer is not None:
                for tok in analyzer.analyze(text):
                    if tok.term in terms:
                        spans.append((tok.start_offset, tok.end_offset))
            else:  # keyword: whole-value match
                if text in terms:
                    spans.append((0, len(text)))
            frags.extend(_best_fragments(text, spans, frag_size, n_frags,
                                         pre, post))
        if frags:
            out[field] = frags[: n_frags if n_frags > 0 else None]
    return out


# ---------------------------------------------------------------------------
# fields retrieval (reference: subphase/FetchFieldsPhase.java +
# fetch/subphase/FieldFetcher.java — source-driven, formatted values)
# ---------------------------------------------------------------------------

_JAVA_STRFTIME = [("yyyy", "%Y"), ("MM", "%m"), ("dd", "%d"), ("HH", "%H"),
                  ("mm", "%M"), ("ss", "%S")]


def java_date_format(millis: float, pattern: str) -> str:
    """Subset of Joda/Java date patterns → formatted UTC string."""
    import datetime
    if pattern in ("epoch_millis",):
        return str(int(millis))
    dt = datetime.datetime.fromtimestamp(millis / 1000.0,
                                         tz=datetime.timezone.utc)
    # tokenize runs of pattern letters so literal text survives intact
    reps = {"yyyy": "%Y", "MM": "%m", "dd": "%d", "HH": "%H",
            "mm": "%M", "ss": "%S"}

    def _render(m):
        run = m.group(0)
        if run == "SSS":
            return f"{dt.microsecond // 1000:03d}"
        if set(run) == {"e"}:            # ISO day-of-week number
            return str(dt.isoweekday()).rjust(len(run), "0")
        if run in reps:
            return dt.strftime(reps[run])
        return run
    import re as _re
    return _re.sub(r"([a-zA-Z])\1*", _render, pattern)


def decimal_format(value: float, pattern: str) -> str:
    """Minimal java DecimalFormat: '#.0' style numeric subpatterns with
    optional literal prefix/suffix text ("Value is #.0")."""
    import re as _re
    m = _re.search(r"[#0]+(?:\.[#0]+)?", pattern)
    if not m:
        return pattern
    num = m.group(0)
    if "." in num:
        decimals = len(num.split(".", 1)[1])
        formatted = f"{value:.{decimals}f}"
    else:
        formatted = str(int(round(value)))
    return pattern[: m.start()] + formatted + pattern[m.end():]


def _source_path_values(src, path: str) -> List[Any]:
    """All values at a dotted path, traversing dicts and flattening lists."""
    nodes = [src]
    for part in path.split("."):
        nxt: List[Any] = []
        for n in nodes:
            if isinstance(n, list):
                n_items = n
            else:
                n_items = [n]
            for item in n_items:
                if isinstance(item, dict) and part in item:
                    v = item[part]
                    nxt.extend(v if isinstance(v, list) else [v])
        nodes = nxt
    return [n for n in nodes if n is not None]


def fetch_fields(mapper: MapperService, src: Optional[dict],
                 specs: Sequence) -> Dict[str, List[Any]]:
    """The ``fields`` request option: formatted values extracted from
    _source for every mapped field matching each pattern."""
    import fnmatch
    from ..index.mapping import (AliasFieldType, NumberFieldType,
                                 ObjectFieldType, RangeFieldType,
                                 BooleanFieldType, TokenCountFieldType)
    from ..common.errors import IllegalArgumentError
    out: Dict[str, List[Any]] = {}
    if not isinstance(src, dict):
        return out
    mapped = mapper._fields
    for spec in specs:
        if isinstance(spec, dict):
            pattern = spec.get("field")
            fmt = spec.get("format")
        else:
            pattern, fmt = spec, None
        if pattern is None:
            raise ParsingError("[fields] entries require [field]")
        matches = [pattern] if pattern in mapped else [
            f for f in mapped
            if fnmatch.fnmatchcase(f, pattern)]
        for f in matches:
            ft = mapped.get(f)
            if isinstance(ft, ObjectFieldType):
                continue
            path = f
            if isinstance(ft, AliasFieldType):
                path = ft.path
                ft = mapper.field_type(f)
            if fmt is not None and not isinstance(
                    ft, (DateFieldType, RangeFieldType)):
                raise IllegalArgumentError(
                    f"Field [{f}] of type [{getattr(ft, 'type_name', '?')}]"
                    f" doesn't support formats.")
            raw = _source_path_values(src, path)
            if not raw and "." in path:
                # multi-field subfield: values live at the PARENT's path
                parent = path.rsplit(".", 1)[0]
                pft = mapped.get(parent)
                if pft is not None and not isinstance(pft, ObjectFieldType):
                    raw = _source_path_values(src, parent)
            vals: List[Any] = []
            for v in raw:
                try:
                    if isinstance(ft, DateFieldType):
                        ms = ft.parse_value(v)
                        vals.append(java_date_format(ms, fmt)
                                    if fmt else
                                    (v if isinstance(v, str) else ms))
                    elif isinstance(ft, TokenCountFieldType):
                        if not ft.doc_values:
                            continue     # no doc values → not retrievable
                        vals.append(int(ft.parse_value(v)))
                    elif isinstance(ft, RangeFieldType):
                        vals.append(v)
                    elif isinstance(ft, NumberFieldType):
                        n = float(ft.parse_value(v))
                        vals.append(int(n) if ft.type_name in (
                            "long", "integer", "short", "byte")
                            else n)
                    elif isinstance(ft, BooleanFieldType):
                        vals.append(v if isinstance(v, bool)
                                    else str(v).lower() == "true")
                    else:
                        vals.append(v if isinstance(v, (dict, bool))
                                    else str(v))
                except IllegalArgumentError:
                    raise
                except Exception:   # noqa: BLE001 — malformed value skip
                    continue
            if vals:
                out[f] = vals
    return out
