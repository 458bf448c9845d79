"""Mappings: field types, document parsing, dynamic mapping.

Re-design of the reference mapper layer (``server/.../index/mapper/``:
``MapperService.java``, ``DocumentParser.java:52``, ``FieldMapper.java``,
``MappedFieldType.java``). A mapping is a tree of typed fields; parsing a JSON
document produces a ``ParsedDocument`` whose per-field values feed the
TPU-friendly columnar/postings builders in ``segment.py``:

- ``text``      → analyzed terms with positions     (postings → BM25 kernel)
- ``keyword``   → exact terms + ordinal doc values  (terms agg / sort)
- numerics/date/boolean → float64 doc values        (range masks / aggs / sort)
- ``dense_vector`` → fixed-dim float32 rows         (einsum kNN)

Dynamic mapping infers types from JSON values like the reference
(``DynamicFieldsBuilder``): string → text + ``.keyword`` subfield, int → long,
float → double ("float" JSON numbers map to double), bool → boolean.
"""

from __future__ import annotations

import datetime as _dt
import numbers
import re
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..common.errors import IllegalArgumentError, MapperParsingError
from .analysis import AnalysisRegistry, Analyzer, Token


# ---------------------------------------------------------------------------
# Field types
# ---------------------------------------------------------------------------

NUMERIC_TYPES = {"long", "integer", "short", "byte", "double", "float",
                 "half_float", "unsigned_long"}

_INT_BOUNDS = {
    "byte": (-(1 << 7), (1 << 7) - 1),
    "short": (-(1 << 15), (1 << 15) - 1),
    "integer": (-(1 << 31), (1 << 31) - 1),
    "long": (-(1 << 63), (1 << 63) - 1),
    "unsigned_long": (0, (1 << 64) - 1),
}


class MappedFieldType:
    """Base resolved field type (reference: ``MappedFieldType.java``)."""

    type_name = "object"
    has_doc_values = False
    is_searchable = True

    def __init__(self, name: str, params: Optional[dict] = None):
        self.name = name
        self.params = params or {}

    def to_mapping(self) -> dict:
        out = {"type": self.type_name}
        out.update({k: v for k, v in self.params.items() if v is not None})
        return out

    # Parse one JSON leaf value into its indexable form; may raise.
    def parse_value(self, value: Any) -> Any:
        return value


class TextFieldType(MappedFieldType):
    type_name = "text"

    def __init__(self, name: str, analyzer: Analyzer,
                 search_analyzer: Optional[Analyzer] = None,
                 params: Optional[dict] = None):
        super().__init__(name, params)
        self.analyzer = analyzer
        self.search_analyzer = search_analyzer or analyzer

    def parse_value(self, value):
        return str(value)


class KeywordFieldType(MappedFieldType):
    type_name = "keyword"
    has_doc_values = True

    def __init__(self, name: str, ignore_above: int = 2 ** 31 - 1,
                 normalize_lowercase: bool = False, params: Optional[dict] = None):
        super().__init__(name, params)
        self.ignore_above = ignore_above
        self.normalize_lowercase = normalize_lowercase

    def parse_value(self, value):
        if isinstance(value, bool):
            value = "true" if value else "false"
        s = str(value)
        if len(s) > self.ignore_above:
            return None
        return s.lower() if self.normalize_lowercase else s


class ConstantKeywordFieldType(KeywordFieldType):
    """A single value shared by every document of the index (reference:
    ``x-pack/plugin/mapper-constant-keyword/.../ConstantKeywordFieldMapper
    .java``). The value pins on the mapping or on the first document that
    supplies one; later documents must agree. Each document indexes the
    constant term (including documents that omit the field — stamped in
    ``parse_document``) so term/terms/exists/aggs ride the normal keyword
    column."""

    type_name = "constant_keyword"

    def __init__(self, name: str, params: Optional[dict] = None):
        super().__init__(name, 2 ** 31 - 1, False, params)
        self.value: Optional[str] = (None if params is None
                                     else params.get("value"))

    def parse_value(self, value):
        # query-side parsing must NOT pin: only documents set the value
        # (ConstantKeywordFieldMapper pins on parse of an indexed doc)
        return super().parse_value(value)

    def index_value(self, value):
        s = super().parse_value(value)
        if self.value is None:
            self.value = s
            self.params["value"] = s      # round-trips in the mapping
            self._pinned_dirty = True     # owning mapper re-renders
        elif s != self.value:
            raise MapperParsingError(
                f"[constant_keyword] field [{self.name}] only accepts "
                f"values that are equal to the value defined in the "
                f"mappings [{self.value}], but got [{s}]")
        return self.value


class WildcardFieldType(KeywordFieldType):
    """Wildcard-optimized keyword (reference: ``x-pack/plugin/wildcard/``
    — n-gram-accelerated there; here wildcard/regexp queries scan the
    keyword ordinal table directly, which the TPU build's term
    dictionaries keep host-side anyway, so no acceleration structure is
    needed for correctness)."""

    type_name = "wildcard"

    def __init__(self, name: str, params: Optional[dict] = None):
        super().__init__(name, int((params or {}).get(
            "ignore_above", 2 ** 31 - 1)), False, params)


_VERSION_RX = re.compile(r"^(\d+)\.(\d+)\.(\d+)(?:[-+].*)?$")


class VersionFieldType(KeywordFieldType):
    """Semver-ordered keyword (reference: ``x-pack/plugin/mapper-version/
    .../VersionStringFieldMapper.java`` encodes versions into
    order-preserving sortable bytes). Here each value indexes its keyword
    term plus a numeric order key into the paired numeric column — the
    same dual-column trick the ip type uses — so sorting is semver-
    correct while term queries and aggs stay string-shaped. Non-semver
    strings carry no order key and sort as missing (documented
    approximation of the reference's 'sorts after valid versions')."""

    type_name = "version"

    def __init__(self, name: str, params: Optional[dict] = None):
        super().__init__(name, 2 ** 31 - 1, False, params)

    #: parts cap: each of major/minor/patch packs into a 100k radix
    _RADIX = 100_000

    def sort_key(self, s: str) -> Optional[float]:
        m = _VERSION_RX.match(s)
        if m is None:
            return None
        major, minor, patch = (min(int(g), self._RADIX - 1)
                               for g in m.groups())
        pre = 0 if "-" in s else 1        # prereleases order before GA
        return float(((major * self._RADIX + minor) * self._RADIX
                      + patch) * 2 + pre)


class FlattenedFieldType(KeywordFieldType):
    """Whole-object field (reference: ``x-pack/plugin/mapper-flattened/
    .../FlattenedFieldMapper.java``): one mapped field indexes every leaf
    of a JSON object. The root field column carries every leaf value (a
    query on ``field`` matches any leaf); each dotted key path gets its
    own keyword column (``field.key``), resolved to a synthetic keyword
    type by ``MapperService.field_type`` without appearing in the
    mapping. Subclassing the keyword type lets every keyword-capable
    query/agg work on the root column unchanged (the reference's root
    type is likewise a keyword-family type)."""

    type_name = "flattened"

    def __init__(self, name: str, params: Optional[dict] = None):
        super().__init__(name, 2 ** 31 - 1, False, params)
        self.depth_limit = int((self.params or {}).get("depth_limit", 20))

    def leaves(self, value: Any):
        """Yield (dotted_path, leaf_string) pairs; '' path for the root."""
        out: List[Tuple[str, str]] = []

        def walk(prefix: str, v: Any, depth: int) -> None:
            if depth > self.depth_limit:
                raise MapperParsingError(
                    f"The provided [flattened] field [{self.name}] "
                    f"exceeds the maximum depth limit of "
                    f"[{self.depth_limit}].")
            if isinstance(v, dict):
                for k, sub in v.items():
                    walk(f"{prefix}.{k}" if prefix else str(k), sub,
                         depth + 1)
            elif isinstance(v, list):
                for sub in v:
                    walk(prefix, sub, depth)
            elif v is not None:
                if isinstance(v, bool):
                    s = "true" if v else "false"
                else:
                    s = str(v)
                out.append((prefix, s))

        walk("", value, 0)
        return out


class NumberFieldType(MappedFieldType):
    has_doc_values = True

    def __init__(self, name: str, number_type: str, params: Optional[dict] = None):
        super().__init__(name, params)
        if number_type not in NUMERIC_TYPES:
            raise IllegalArgumentError(f"unknown numeric type [{number_type}]")
        self.type_name = number_type

    def parse_value(self, value):
        if isinstance(value, bool):
            raise MapperParsingError(
                f"failed to parse field [{self.name}] of type [{self.type_name}]: "
                f"boolean value")
        try:
            if self.type_name in _INT_BOUNDS:
                if isinstance(value, int):
                    v = value
                else:
                    try:
                        v = int(value)  # exact for integer strings (no f64 loss)
                    except ValueError:
                        v = int(float(value))
                lo, hi = _INT_BOUNDS[self.type_name]
                if not (lo <= v <= hi):
                    raise MapperParsingError(
                        f"value [{value}] out of range for type [{self.type_name}]")
                return float(v)
            return float(value)
        except (TypeError, ValueError) as e:
            raise MapperParsingError(
                f"failed to parse field [{self.name}] of type "
                f"[{self.type_name}]: [{value}]") from e


_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)

_DATE_YMD_RE = re.compile(r"^\d{4}-\d{2}-\d{2}$")


#: month-abbreviation tables for locale-dependent java patterns (MMM);
#: keys are the first three letters, lowercased, dots stripped
_MONTHS_BY_LOCALE = {
    "en": {"jan": 1, "feb": 2, "mar": 3, "apr": 4, "may": 5, "jun": 6,
           "jul": 7, "aug": 8, "sep": 9, "oct": 10, "nov": 11, "dec": 12},
    "de": {"jan": 1, "feb": 2, "mär": 3, "apr": 4, "mai": 5, "jun": 6,
           "jul": 7, "aug": 8, "sep": 9, "okt": 10, "nov": 11, "dez": 12},
}


def _parse_java_pattern(s: str, pattern: str, locale: str) -> Optional[float]:
    """Parse against ONE java date pattern ("E, d MMM yyyy HH:mm:ss Z")
    with locale-dependent month names (reference: DateFormatters with a
    Locale). Returns epoch ms or None when the text doesn't fit."""
    ns = _parse_java_pattern_ns(s, pattern, locale)
    return None if ns is None else ns / 1e6


def _parse_java_pattern_ns(s: str, pattern: str,
                           locale: str) -> Optional[int]:
    """Same as :func:`_parse_java_pattern` at exact NANOS resolution
    (sub-second digits beyond 3 survive — date_nanos formats)."""
    months = _MONTHS_BY_LOCALE.get(
        (locale or "en").split("-")[0].split("_")[0],
        _MONTHS_BY_LOCALE["en"])
    groups = []         # extractor names, one per capture group

    def _tok(m):
        run = m.group(0)
        c = run[0]
        if c == "E":
            return r"[^\W\d]+\.?"
        if c == "y":
            groups.append("y" if len(run) >= 4 else "yy")
            return r"(\d{4})" if len(run) >= 4 else r"(\d{2})"
        if run == "MMM" or run == "MMMM":
            groups.append("Mname")
            return r"([^\W\d]+\.?)"
        if c == "M":
            groups.append("M")
            return r"(\d{2})" if len(run) == 2 else r"(\d{1,2})"
        if c == "d":
            groups.append("d")
            return r"(\d{2})" if len(run) == 2 else r"(\d{1,2})"
        if c in "Hh":
            groups.append("H")
            return r"(\d{2})" if len(run) == 2 else r"(\d{1,2})"
        if c == "m":
            groups.append("mi")
            return r"(\d{2})"
        if c == "s":
            groups.append("se")
            return r"(\d{2})"
        if c == "S":
            groups.append("S")
            return r"(\d{1,%d})" % len(run)
        if c == "Z" or c == "X":
            groups.append("tz")
            return r"([+-]\d{2}:?\d{2}|Z)"
        return re.escape(run)

    pat = re.sub(r"([a-zA-Z])\1*|[^a-zA-Z]+",
                 lambda m: _tok(m) if m.group(0)[0].isalpha()
                 else re.escape(m.group(0)), pattern)
    m = re.fullmatch(pat, s.strip())
    if m is None:
        return None
    vals = {"y": 1970, "M": 1, "d": 1, "H": 0, "mi": 0, "se": 0,
            "S_ns": 0, "tz_s": 0}
    for name, g in zip(groups, m.groups()):
        if name == "Mname":
            key = g.rstrip(".").lower()[:3]
            mo = months.get(key) or _MONTHS_BY_LOCALE["en"].get(key)
            if mo is None:
                return None
            vals["M"] = mo
        elif name == "tz":
            if g != "Z":
                sign = 1 if g[0] == "+" else -1
                digits = g[1:].replace(":", "")
                vals["tz_s"] = sign * (int(digits[:2]) * 3600 +
                                       int(digits[2:4]) * 60)
        elif name == "S":
            vals["S_ns"] = int(g.ljust(9, "0")[:9])
        elif name == "yy":
            # java reduced year: two digits pivot on 2000 (00-99 →
            # 2000-2099, DateTimeFormatterBuilder.appendValueReduced)
            vals["y"] = 2000 + int(g)
        else:
            vals[name] = int(g)
    try:
        d = _dt.datetime(vals["y"], vals["M"], vals["d"], vals["H"],
                         vals["mi"], vals["se"],
                         tzinfo=_dt.timezone.utc)
    except ValueError:
        return None
    delta = d - _EPOCH
    return ((delta.days * 86400 + delta.seconds - vals["tz_s"]) * 10 ** 9
            + vals["S_ns"])


_ISO_NS_RE = re.compile(
    r"(\d{4})-(\d{2})-(\d{2})[T ](\d{2}):(\d{2}):(\d{2})"
    r"(?:\.(\d{1,9}))?(Z|[+-]\d{2}:?\d{2})?")


def parse_date_nanos(value: Any, fmt: str, locale: str = "en") -> int:
    """Exact epoch-NANOS parse for date_nanos fields. float64 millis tops
    out around 200ns granularity at 2018-era epochs, so ns-resolution
    values must never round-trip through the float path (reference:
    ``DateFieldMapper.Resolution.NANOSECONDS``)."""
    if isinstance(value, numbers.Number) and not isinstance(value, bool):
        if "epoch_second" in fmt and "epoch_millis" not in fmt:
            return int(value) * 10 ** 9
        return int(value) * 10 ** 6
    s = str(value).strip()
    m = _ISO_NS_RE.fullmatch(s)
    if m:
        y, mo, d, H, Mi, S, frac, tz = m.groups()
        base = _dt.datetime(int(y), int(mo), int(d), int(H), int(Mi),
                            int(S), tzinfo=_dt.timezone.utc)
        delta = base - _EPOCH
        ns = (delta.days * 86400 + delta.seconds) * 10 ** 9
        ns += int((frac or "").ljust(9, "0") or 0)
        if tz and tz != "Z":
            sign = 1 if tz[0] == "+" else -1
            digits = tz[1:].replace(":", "")
            ns -= sign * (int(digits[:2]) * 3600 +
                          int(digits[2:4] or 0) * 60) * 10 ** 9
        return ns
    if re.fullmatch(r"-?\d+", s):
        if "epoch_second" in fmt and "epoch_millis" not in fmt:
            return int(s) * 10 ** 9
        return int(s) * 10 ** 6
    for alt in fmt.split("||"):
        if alt in ("strict_date_optional_time", "epoch_millis",
                   "epoch_second"):
            continue
        ns = _parse_java_pattern_ns(s, alt, locale)
        if ns is not None:
            return ns
    # date-math and anything else: ms-resolution fallback
    return int(round(parse_date_millis(s, fmt, locale=locale) * 1e6))


def parse_date_millis(value: Any, fmt: str = "strict_date_optional_time||epoch_millis",
                      round_up: bool = False,
                      date_math: bool = True,
                      locale: str = "en") -> float:
    """Parse a date into epoch milliseconds (UTC). Supports the reference's
    default ``strict_date_optional_time||epoch_millis`` plus
    ``epoch_second``. ``round_up`` resolves /unit date-math rounding to
    the END of the unit (gt/lte range-bound semantics)."""
    if isinstance(value, bool):
        raise MapperParsingError(f"failed to parse date [{value}]")
    if isinstance(value, numbers.Number):
        if "epoch_second" in fmt and "epoch_millis" not in fmt:
            return float(value) * 1000.0
        return float(value)
    s = str(value).strip()
    if "||" in s or s.startswith("now"):
        if not date_math:
            # date math is a QUERY-side construct; document values must
            # be concrete (nondeterministic now() would poison reindex)
            raise MapperParsingError(f"failed to parse date field [{s}]")
        return _parse_date_math(s, fmt, round_up)
    if re.fullmatch(r"-?\d+", s):
        if "epoch_second" in fmt and "epoch_millis" not in fmt:
            return float(s) * 1000.0
        if len(s) == 4 and "strict_date_optional_time" in fmt and \
                1000 <= int(s) <= 9999:
            # strict_date_optional_time accepts a bare year and comes
            # before epoch_millis in the default format list
            d = _dt.datetime(int(s), 1, 1, tzinfo=_dt.timezone.utc)
            return (d - _EPOCH).total_seconds() * 1000.0
        return float(s)
    try:
        if _DATE_YMD_RE.match(s):
            d = _dt.datetime.strptime(s, "%Y-%m-%d").replace(tzinfo=_dt.timezone.utc)
        else:
            d = _dt.datetime.fromisoformat(s)
            if d.tzinfo is None:
                d = d.replace(tzinfo=_dt.timezone.utc)
        return (d - _EPOCH).total_seconds() * 1000.0
    except ValueError as e:
        # custom java patterns (letter runs + literals), locale-aware
        for alt in fmt.split("||"):
            if alt in ("strict_date_optional_time", "epoch_millis",
                       "epoch_second"):
                continue
            ms = _parse_java_pattern(s, alt, locale)
            if ms is not None:
                return ms
        raise MapperParsingError(f"failed to parse date field [{value}]") from e


_DM_OP_RE = re.compile(r"([+\-]\d+[yMwdhHms])|(/[yMwdhHms])")


def _add_months(base: "_dt.datetime", n: int) -> "_dt.datetime":
    """Calendar month addition with day-of-month clamping (the
    reference's DateMathParser clamps to the target month's last day)."""
    import calendar
    total = base.year * 12 + (base.month - 1) + n
    year, month = total // 12, total % 12 + 1
    day = min(base.day, calendar.monthrange(year, month)[1])
    return base.replace(year=year, month=month, day=day)


def _parse_date_math(s: str, fmt: str, round_up: bool = False) -> float:
    """Date-math expressions: ``<base>||<ops>`` or ``now<ops>`` where ops
    are ±N<unit> adjustments and /<unit> floor rounding
    (``common/time/DateMathParser`` semantics)."""
    if s.startswith("now"):
        base = _dt.datetime.now(_dt.timezone.utc)
        ops = s[3:]
    else:
        base_s, _, ops = s.partition("||")
        ms = parse_date_millis(base_s, fmt)
        base = _EPOCH + _dt.timedelta(milliseconds=ms)
    pos = 0
    for m in _DM_OP_RE.finditer(ops):
        if m.start() != pos:
            raise MapperParsingError(
                f"failed to parse date field [{s}]")
        pos = m.end()
        tok = m.group(0)
        if tok.startswith("/"):
            u = tok[1]
            if u == "y":
                base = base.replace(month=1, day=1, hour=0, minute=0,
                                    second=0, microsecond=0)
            elif u == "M":
                base = base.replace(day=1, hour=0, minute=0, second=0,
                                    microsecond=0)
            elif u == "w":
                base = (base - _dt.timedelta(days=base.weekday())).replace(
                    hour=0, minute=0, second=0, microsecond=0)
            elif u == "d":
                base = base.replace(hour=0, minute=0, second=0,
                                    microsecond=0)
            elif u in ("h", "H"):
                base = base.replace(minute=0, second=0, microsecond=0)
            elif u == "m":
                base = base.replace(second=0, microsecond=0)
            elif u == "s":
                base = base.replace(microsecond=0)
            if round_up:
                # RoundUp semantics apply AT the rounding step, so later
                # ± offsets compose on top of the end-of-unit instant
                if u == "y":
                    base = base.replace(year=base.year + 1)
                elif u == "M":
                    base = _add_months(base, 1)
                else:
                    base = base + {"w": _dt.timedelta(weeks=1),
                                   "d": _dt.timedelta(days=1),
                                   "h": _dt.timedelta(hours=1),
                                   "H": _dt.timedelta(hours=1),
                                   "m": _dt.timedelta(minutes=1),
                                   "s": _dt.timedelta(seconds=1)}[u]
                base = base - _dt.timedelta(milliseconds=1)
        else:
            n = int(tok[:-1])
            u = tok[-1]
            if u == "y":
                base = _add_months(base, 12 * n)
            elif u == "M":
                base = _add_months(base, n)
            else:
                delta = {"w": _dt.timedelta(weeks=n),
                         "d": _dt.timedelta(days=n),
                         "h": _dt.timedelta(hours=n),
                         "H": _dt.timedelta(hours=n),
                         "m": _dt.timedelta(minutes=n),
                         "s": _dt.timedelta(seconds=n)}[u]
                base = base + delta
    if pos != len(ops):
        raise MapperParsingError(f"failed to parse date field [{s}]")
    return (base - _EPOCH).total_seconds() * 1000.0


def _looks_date(s: str) -> bool:
    if not (_DATE_YMD_RE.match(s) or
            re.match(r"^\d{4}-\d{2}-\d{2}[T ]\d{2}:", s)):
        return False
    try:
        parse_date_millis(s)            # detection VALIDATES by parsing
        return True
    except MapperParsingError:
        return False


def _looks_iso_datetime(s: str) -> bool:
    if not re.match(r"^\d{4}-\d{2}-\d{2}[T ]\d{2}:", s):
        return False
    try:
        parse_date_millis(s)
        return True
    except MapperParsingError:
        return False


def format_date_millis(millis: float) -> str:
    d = _EPOCH + _dt.timedelta(milliseconds=millis)
    return d.strftime("%Y-%m-%dT%H:%M:%S.") + f"{d.microsecond // 1000:03d}Z"


class DateFieldType(MappedFieldType):
    type_name = "date"
    has_doc_values = True

    def __init__(self, name: str, date_format: str = "strict_date_optional_time||epoch_millis",
                 params: Optional[dict] = None, nanos: bool = False):
        super().__init__(name, params)
        self.format = date_format
        self.locale = (params or {}).get("locale") or "en"
        self.nanos = nanos          # date_nanos resolution (sort values
                                    # serialize as epoch nanos)
        if nanos:
            # instance override: rendered mappings must say date_nanos or
            # a replicated put_mapping round-trip silently demotes the
            # field to ms resolution (cluster tier replays the RENDERED
            # mapping on every node)
            self.type_name = "date_nanos"

    #: max epoch-millis storable in a signed-64 nanosecond long
    NANOS_MAX_MS = (1 << 63) / 1e6

    def parse_value(self, value):
        ms = parse_date_millis(value, self.format, date_math=False,
                               locale=self.locale)
        if self.nanos:
            if ms < 0:
                e = MapperParsingError(
                    f"failed to parse field [{self.name}] of type "
                    f"[date_nanos]")
                e.caused_by = {
                    "type": "illegal_argument_exception",
                    "reason": f"date[{value}] is before the epoch in 1970 "
                              f"and cannot be stored in nanosecond "
                              f"resolution"}
                raise e
            if ms > self.NANOS_MAX_MS:
                e = MapperParsingError(
                    f"failed to parse field [{self.name}] of type "
                    f"[date_nanos]")
                e.caused_by = {
                    "type": "illegal_argument_exception",
                    "reason": f"date[{value}] is after 2262-04-11T23:47:"
                              f"16.854775807 and cannot be stored in "
                              f"nanosecond resolution"}
                raise e
        return ms


class TokenCountFieldType(MappedFieldType):
    """token_count (reference: TokenCountFieldMapper): stores the analyzed
    token count of its input as an integer doc value."""

    type_name = "token_count"
    has_doc_values = True

    def __init__(self, name: str, analyzer: Analyzer,
                 params: Optional[dict] = None):
        super().__init__(name, params)
        self.analyzer = analyzer
        self.doc_values = (params or {}).get("doc_values", True)

    def parse_value(self, value):
        return float(len(self.analyzer.terms(str(value))))


class BooleanFieldType(MappedFieldType):
    type_name = "boolean"
    has_doc_values = True

    def parse_value(self, value):
        if isinstance(value, bool):
            return 1.0 if value else 0.0
        if value in ("true", "True"):
            return 1.0
        if value in ("false", "False", ""):
            return 0.0
        raise MapperParsingError(f"failed to parse boolean [{value}]")


class DenseVectorFieldType(MappedFieldType):
    """Reference: ``x-pack/plugin/vectors/.../DenseVectorFieldMapper.java:43``.
    Brute-force scored via a single einsum + top_k on TPU."""

    type_name = "dense_vector"
    has_doc_values = True

    def __init__(self, name: str, dims: int, similarity: str = "cosine",
                 params: Optional[dict] = None):
        super().__init__(name, params)
        self.dims = int(dims)
        self.similarity = similarity

    def parse_value(self, value):
        arr = np.asarray(value, dtype=np.float32)
        if arr.shape != (self.dims,):
            raise MapperParsingError(
                f"the [dims] of field [{self.name}] is [{self.dims}] but found "
                f"vector of dims [{arr.shape}]")
        return arr


_GEOHASH_B32 = "0123456789bcdefghjkmnpqrstuvwxyz"
_GEOHASH_ORD = {c: i for i, c in enumerate(_GEOHASH_B32)}


def geohash_decode(h: str):
    """Geohash → (lat, lon) cell center (``Geohash.java`` semantics)."""
    lat_lo, lat_hi, lon_lo, lon_hi = -90.0, 90.0, -180.0, 180.0
    even = True
    for c in h:
        bits = _GEOHASH_ORD[c]
        for shift in range(4, -1, -1):
            bit = (bits >> shift) & 1
            if even:
                mid = (lon_lo + lon_hi) / 2
                lon_lo, lon_hi = (mid, lon_hi) if bit else (lon_lo, mid)
            else:
                mid = (lat_lo + lat_hi) / 2
                lat_lo, lat_hi = (mid, lat_hi) if bit else (lat_lo, mid)
            even = not even
    return ((lat_lo + lat_hi) / 2, (lon_lo + lon_hi) / 2)


class GeoPointFieldType(MappedFieldType):
    type_name = "geo_point"
    has_doc_values = True

    def parse_value(self, value):
        # Accept {"lat":..,"lon":..}, [lon, lat], "lat,lon", and geohash.
        try:
            if isinstance(value, dict):
                if "geohash" in value:
                    lat, lon = geohash_decode(str(value["geohash"]))
                else:
                    lat, lon = float(value["lat"]), float(value["lon"])
            elif isinstance(value, (list, tuple)):
                lon, lat = float(value[0]), float(value[1])
            elif isinstance(value, str):
                if "," in value:
                    parts = value.split(",")
                    lat, lon = float(parts[0]), float(parts[1])
                elif all(c in _GEOHASH_ORD for c in value) and value:
                    lat, lon = geohash_decode(value)
                else:
                    raise MapperParsingError(
                        f"failed to parse geo_point [{value}]")
            else:
                raise MapperParsingError(
                    f"failed to parse geo_point [{value}]")
        except (ValueError, TypeError, KeyError, IndexError):
            raise MapperParsingError(f"failed to parse geo_point [{value}]")
        if not (-90 <= lat <= 90) or not (-180 <= lon <= 180):
            raise MapperParsingError(f"geo_point out of bounds [{value}]")
        return (lat, lon)


class RankFeatureFieldType(MappedFieldType):
    """Single positive feature value for ``rank_feature`` queries
    (reference: ``mapper-extras/.../RankFeatureFieldMapper.java``).
    Stored as an ordinary numeric doc-values column — the rank_feature
    query reads it straight off the device-resident column instead of
    the reference's frequency-encoded term."""

    type_name = "rank_feature"
    has_doc_values = True

    def __init__(self, name, params=None,
                 positive_score_impact: bool = True):
        super().__init__(name, params)
        self.positive_score_impact = positive_score_impact

    def parse_value(self, value):
        try:
            v = float(value)
        except (TypeError, ValueError):
            raise MapperParsingError(
                f"failed to parse field [{self.name}] of type "
                f"[rank_feature]")
        if v <= 0:
            raise MapperParsingError(
                f"[rank_feature] fields must have a positive value, "
                f"got [{v}] for field [{self.name}]")
        return v


class RankFeaturesFieldType(MappedFieldType):
    """Sparse feature map {name: positive value}
    (``RankFeaturesFieldMapper.java``); each feature lands in its own
    ``field.feature`` numeric column."""

    type_name = "rank_features"
    has_doc_values = True

    def __init__(self, name, params=None,
                 positive_score_impact: bool = True):
        super().__init__(name, params)
        self.positive_score_impact = positive_score_impact

    def parse_value(self, value):
        if not isinstance(value, dict):
            raise MapperParsingError(
                f"[rank_features] fields must be json objects, "
                f"expected a START_OBJECT for field [{self.name}]")
        out = {}
        for feat, v in value.items():
            try:
                fv = float(v)
            except (TypeError, ValueError):
                raise MapperParsingError(
                    f"failed to parse feature [{feat}] of field "
                    f"[{self.name}]")
            if fv <= 0:
                raise MapperParsingError(
                    f"[rank_features] fields must have positive "
                    f"values, got [{fv}] for feature [{feat}]")
            out[feat] = fv
        return out


class AggregateMetricDoubleFieldType(MappedFieldType):
    """Pre-aggregated metric document (``aggregate_metric_double``,
    ``x-pack mapper: AggregateDoubleMetricFieldMapper.java``): each doc
    carries min/max/sum/value_count sub-metrics, one numeric column per
    metric; queries and sorts on the bare name resolve to
    ``default_metric``'s column."""

    type_name = "aggregate_metric_double"
    has_doc_values = True

    VALID_METRICS = ("min", "max", "sum", "value_count")

    def __init__(self, name, metrics, default_metric, params=None):
        super().__init__(name, params)
        if not metrics:
            raise MapperParsingError(
                f"Property [metrics] is required for field [{name}]")
        for m in metrics:
            if m not in self.VALID_METRICS:
                raise MapperParsingError(
                    f"Metric [{m}] is not supported for field [{name}]; "
                    f"supported metrics are "
                    f"{list(self.VALID_METRICS)}")
        if default_metric is None:
            raise MapperParsingError(
                f"Property [default_metric] is required for field "
                f"[{name}]")
        if default_metric not in metrics:
            raise MapperParsingError(
                f"Default metric [{default_metric}] is not defined in "
                f"the metrics of field [{name}]")
        self.metrics = list(metrics)
        self.default_metric = default_metric

    def parse_value(self, value):
        if not isinstance(value, dict):
            raise MapperParsingError(
                f"Failed to parse object: expecting an object for "
                f"field [{self.name}]")
        out = {}
        for m in self.metrics:
            if m not in value:
                raise MapperParsingError(
                    f"Aggregate metric field [{self.name}] must "
                    f"contain all metrics {self.metrics}")
            try:
                out[m] = float(value[m])
            except (TypeError, ValueError):
                raise MapperParsingError(
                    f"failed to parse metric [{m}] of field "
                    f"[{self.name}]")
        if "value_count" in out and out["value_count"] < 0:
            raise MapperParsingError(
                f"Aggregate metric [value_count] of field "
                f"[{self.name}] cannot be a negative number")
        return out


class GeoShapeFieldType(MappedFieldType):
    """Arbitrary geometries (``geo_shape``; reference:
    ``x-pack/plugin/spatial/`` + ``GeoShapeFieldMapper.java``).
    The geometry is validated at parse time and kept in _source; the
    geo_shape query evaluates relations against parsed geometries with
    a per-segment cache (search/geometry.py), and the indexed bbox
    columns (``._minx`` …) give exists/pre-filter columns — vs the
    reference's triangulated BKD encoding."""

    type_name = "geo_shape"
    has_doc_values = True

    def parse_value(self, value):
        from ..search.geometry import parse_geometry
        try:
            geom = parse_geometry(value)
        except Exception as e:
            raise MapperParsingError(
                f"failed to parse field [{self.name}] of type "
                f"[geo_shape]: {e}")
        if geom.empty:
            raise MapperParsingError(
                f"failed to parse field [{self.name}] of type "
                f"[geo_shape]: empty geometry")
        return geom


class IpFieldType(MappedFieldType):
    """IP addresses (reference: ``index/mapper/IpFieldMapper.java``).
    Stored dual: the numeric value (for range/CIDR masks on device) and
    the normalized string as a keyword term (exact term matches). IPv4 is
    exact; IPv6 numeric comparisons carry f64 (2^53) precision — range
    endpoints beyond that resolve to the nearest representable value
    (documented deviation; the reference compares 128-bit points)."""

    type_name = "ip"
    has_doc_values = True

    def parse_value(self, value):
        import ipaddress
        try:
            ip = ipaddress.ip_address(str(value))
        except ValueError as e:
            raise MapperParsingError(f"'{value}' is not an IP string "
                                     f"literal.") from e
        return str(ip), float(int(ip))

    @staticmethod
    def cidr_bounds(value: str):
        """'a.b.c.d/n' → (lo_int, hi_int) or None when not a CIDR."""
        import ipaddress
        if "/" not in str(value):
            return None
        net = ipaddress.ip_network(str(value), strict=False)
        return float(int(net.network_address)), \
            float(int(net.broadcast_address))


RANGE_TYPES = {"integer_range", "long_range", "float_range",
               "double_range", "date_range", "ip_range"}


class RangeFieldType(MappedFieldType):
    """Range fields (reference: ``index/mapper/RangeFieldMapper.java``):
    each value is an interval stored as two numeric columns
    ``<field>._gte`` / ``<field>._lte`` (bounds normalized to closed);
    queries compare interval endpoints under a relation
    (intersects/contains/within)."""

    type_name = "range"

    def __init__(self, name: str, range_kind: str, params: dict):
        super().__init__(name, params)
        self.range_kind = range_kind
        self.type_name = range_kind

    def _point(self, v, round_up: bool = False):
        try:
            if self.range_kind == "date_range":
                return float(parse_date_millis(v, round_up=round_up))
            if self.range_kind == "ip_range":
                import ipaddress
                return float(int(ipaddress.ip_address(str(v))))
            return float(v)
        except (ValueError, TypeError) as e:
            raise MapperParsingError(
                f"failed to parse [{self.range_kind}] bound [{v}] for "
                f"field [{self.name}]") from e

    def parse_value(self, value):
        if not isinstance(value, dict):
            raise MapperParsingError(
                f"range field [{self.name}] expects an object with "
                f"gte/gt/lte/lt bounds")
        integral = self.range_kind in ("integer_range", "long_range",
                                       "date_range", "ip_range")
        lo = value.get("gte")
        if lo is None and value.get("gt") is not None:
            p = self._point(value["gt"])
            lo = p + 1 if integral else float(np.nextafter(p, np.inf))
        elif lo is not None:
            lo = self._point(lo)
        hi = value.get("lte")
        if hi is None and value.get("lt") is not None:
            p = self._point(value["lt"])
            hi = p - 1 if integral else float(np.nextafter(p, -np.inf))
        elif hi is not None:
            hi = self._point(hi)
        if lo is None:
            lo = -1.7e308
        if hi is None:
            hi = 1.7e308
        return float(lo), float(hi)


class SearchAsYouTypeFieldType(TextFieldType):
    """search_as_you_type: the base text field plus an ``._index_prefix``
    sibling holding edge n-grams (2..max_prefix_chars) of every analyzed
    term, so as-you-type prefixes match postings without wildcard scans
    (the reference adds shingle subfields too; prefix covers the hot
    match_bool_prefix path)."""

    type_name = "search_as_you_type"
    MAX_PREFIX = 10

    def __init__(self, name, analyzer, params):
        super().__init__(name, analyzer, None, params)


class PrefixSubFieldType(TextFieldType):
    """The ``._index_prefix`` sibling of a search_as_you_type field —
    queryable like text, but its postings are written by the parent's
    prefix-gram branch, never by the generic multi-field loop."""

    type_name = "text"


class RuntimeFieldType(MappedFieldType):
    """Runtime fields (reference: ``index/mapper/RuntimeField.java`` —
    script-computed at query time, no index structures). The script is a
    restricted expression (``utils/expressions.py``) over the document's
    numeric doc-value columns; the column materializes lazily per segment
    as one vectorized evaluation and caches — usable in sort, range
    queries, and numeric aggregations."""

    type_name = "runtime"
    has_doc_values = True

    def __init__(self, name: str, runtime_kind: str, script_source: str,
                 params: dict):
        super().__init__(name, params)
        self.runtime_kind = runtime_kind
        self.script_source = script_source

    def column(self, seg) -> np.ndarray:
        """float64[n_pad] computed column (NaN where any input is
        missing), cached on the segment."""
        key = f"__rt__{self.name}"
        col = seg._fv_columns.get(key)
        if col is None:
            import ast as _ast
            from ..utils.expressions import (compile_expression,
                                             evaluate_expression_vec)
            tree = compile_expression(self.script_source)
            names = {n.id for n in _ast.walk(tree)
                     if isinstance(n, _ast.Name)}
            env = {}
            for nm in names:
                try:
                    env[nm] = seg.numeric_first_value_column(nm)
                except Exception:       # noqa: BLE001 — math fn names etc.
                    continue
            col = np.asarray(
                evaluate_expression_vec(self.script_source, env),
                dtype=np.float64)
            if col.shape == ():          # constant expression
                col = np.full(seg.n_pad, float(col))
            seg._fv_columns[key] = col
        return col


class CompletionFieldType(MappedFieldType):
    """Auto-complete inputs (reference:
    ``search/suggest/completion/CompletionFieldMapper.java``). Inputs are
    stored as keyword terms on the field itself and the per-doc suggestion
    weight as a hidden ``<field>._weight`` numeric column — the FST the
    reference builds is replaced by prefix scans of the keyword ordinal
    table (``search/suggest.py``). Weight is per document (the reference
    allows per-input weights; documented simplification)."""

    type_name = "completion"

    def __init__(self, name: str, params: Optional[dict] = None):
        super().__init__(name, params)
        ctxs = (params or {}).get("contexts") or []
        if isinstance(ctxs, dict):
            ctxs = [ctxs]
        self.contexts = ctxs        # [{name, type, path?, precision?}]

    def parse_value(self, value):
        """→ (inputs, weight, contexts_dict)."""
        if isinstance(value, str):
            inputs, weight, ctxs = [value], 1, {}
        elif isinstance(value, list) and any(
                isinstance(v, dict) for v in value):
            # array of {input, weight} entries — inputs merge; the
            # per-doc weight column keeps the FIRST entry's weight
            # (per-input weights are a documented simplification)
            inputs, weight, ctxs = [], None, {}
            for v in value:
                i2, w2, c2 = self.parse_value(v)
                inputs.extend(i2)
                if weight is None:
                    weight = w2
                for ck, cv in c2.items():
                    ctxs.setdefault(ck, cv)
            weight = 1 if weight is None else weight
        elif isinstance(value, list):
            inputs, weight, ctxs = [str(v) for v in value], 1, {}
        elif isinstance(value, dict):
            inputs = value.get("input", [])
            if isinstance(inputs, str):
                inputs = [inputs]
            inputs = [str(v) for v in inputs]
            weight = int(value.get("weight", 1))
            ctxs = value.get("contexts") or {}
        else:
            raise MapperParsingError(
                f"failed to parse completion input [{value}]")
        if self.contexts and not ctxs and not any(
                c.get("path") for c in self.contexts):
            raise MapperParsingError(
                f"Contexts are mandatory in context enabled "
                f"completion field [{self.name}]")
        return inputs, weight, ctxs

    def context_tokens(self, ctxs: dict, source: dict) -> dict:
        """context name → list of stored tokens (geo → geohash12)."""
        out = {}
        for cdef in self.contexts:
            cname = cdef.get("name")
            ctype = cdef.get("type", "category")
            vals = ctxs.get(cname)
            if vals is None and cdef.get("path"):
                cur = source
                for part in str(cdef["path"]).split("."):
                    cur = cur.get(part) if isinstance(cur, dict) else None
                vals = cur
            if vals is None:
                continue
            if not isinstance(vals, list):
                vals = [vals]
            toks = []
            for v in vals:
                if ctype == "geo":
                    lat, lon = GeoPointFieldType(cname).parse_value(v)
                    toks.append(geohash_encode_12(lat, lon))
                else:
                    toks.append(str(v))
            out[cname] = toks
        return out


def geohash_encode(lat: float, lon: float, precision: int) -> str:
    """Geohash encoding (Geohash.java bit interleaving)."""
    lat_lo, lat_hi, lon_lo, lon_hi = -90.0, 90.0, -180.0, 180.0
    out, bits, n, even = [], 0, 0, True
    while len(out) < precision:
        if even:
            mid = (lon_lo + lon_hi) / 2
            if lon >= mid:
                bits = (bits << 1) | 1
                lon_lo = mid
            else:
                bits <<= 1
                lon_hi = mid
        else:
            mid = (lat_lo + lat_hi) / 2
            if lat >= mid:
                bits = (bits << 1) | 1
                lat_lo = mid
            else:
                bits <<= 1
                lat_hi = mid
        even = not even
        n += 1
        if n == 5:
            out.append(_GEOHASH_B32[bits])
            bits = n = 0
    return "".join(out)


def geohash_encode_12(lat: float, lon: float) -> str:
    """12-char geohash (max context precision; queries prefix-match)."""
    return geohash_encode(lat, lon, 12)


class JoinFieldType(MappedFieldType):
    """Parent/child relations inside one index (reference:
    ``modules/parent-join/.../ParentJoinFieldMapper.java``). A doc's
    value is ``"parent"`` or ``{"name": "child", "parent": "<id>"}``;
    storage is the reference's own trick: the relation NAME is a keyword
    at the field, and the parent id a keyword at ``<field>#<parent>`` —
    parents store their OWN id there, so has_parent/has_child/children
    all work off one column."""

    type_name = "join"

    def __init__(self, name: str, relations: dict, params: dict):
        super().__init__(name, params)
        self.relations_raw = dict(relations or {})
        self.relations: Dict[str, List[str]] = {}
        for parent, kids in self.relations_raw.items():
            self.relations[parent] = [kids] if isinstance(kids, str) \
                else list(kids)

    def parent_rel_of(self, name: str) -> Optional[str]:
        """The parent relation a NAME belongs under (None for roots)."""
        for parent, kids in self.relations.items():
            if name in kids:
                return parent
        return None

    def all_names(self) -> List[str]:
        out = list(self.relations)
        for kids in self.relations.values():
            out.extend(kids)
        return out

    def id_field_for(self, rel_name: str) -> str:
        """Column carrying the family id for docs of ``rel_name``."""
        parent = self.parent_rel_of(rel_name) or rel_name
        return f"{self.name}#{parent}"

    def to_mapping(self) -> dict:
        return {"type": "join", "eager_global_ordinals": True,
                "relations": self.relations_raw}


class PercolatorFieldType(MappedFieldType):
    """Stored-query field (reference:
    ``modules/percolator/PercolatorFieldMapper.java:93``). The query
    spec lives in _source; match-time the percolate query runs each
    stored query against an in-memory segment built from the candidate
    document. (The reference extracts candidate terms to prune which
    stored queries run; this build evaluates all of them — exact, and
    the per-query cost is one tiny-segment execution.)"""

    type_name = "percolator"

    def to_mapping(self) -> dict:
        return {"type": "percolator"}


class BinaryFieldType(MappedFieldType):
    """Base64 blobs (reference: ``BinaryFieldMapper``): stored in _source,
    neither indexed nor doc-valued — exists queries consult the source."""

    type_name = "binary"
    is_searchable = False

    def parse_value(self, value):
        import base64
        try:
            base64.b64decode(str(value), validate=True)
        except Exception as e:
            raise MapperParsingError(
                f"failed to parse field [{self.name}] of type [binary]"
            ) from e
        return str(value)


class AliasFieldType(MappedFieldType):
    """Field alias (reference: ``FieldAliasMapper``): queries and aggs on
    the alias resolve to the target path; documents never write to it."""

    type_name = "alias"

    def __init__(self, name: str, path: str, params: dict):
        super().__init__(name, params)
        self.path = path


class ObjectFieldType(MappedFieldType):
    type_name = "object"
    is_searchable = False


class NestedFieldType(ObjectFieldType):
    """Nested objects as block-joined hidden child documents (reference:
    ``index/mapper/NestedObjectMapper.java`` + Lucene block join): each
    nested value becomes its own document indexed immediately BEFORE its
    parent, carrying the ``path.field`` leaf values; the segment stores a
    parent bitmask and child→parent pointers, and ``nested`` queries join
    child matches back to parents (``search/query_dsl.py NestedQuery``).
    Cross-object match leakage — the flattened v1 gap — is gone: each
    child matches independently."""

    type_name = "nested"


# ---------------------------------------------------------------------------
# Parsed document
# ---------------------------------------------------------------------------


@dataclass
class ParsedDocument:
    """Output of document parsing, consumed by the segment writer
    (analogue of ``ParsedDocument.java`` wrapping LuceneDocument)."""

    doc_id: str
    source: dict
    routing: Optional[str] = None
    # field name -> list of analyzed tokens (text fields)
    text_tokens: Dict[str, List[Token]] = dc_field(default_factory=dict)
    # field name -> list of exact terms (keyword fields)
    keyword_terms: Dict[str, List[str]] = dc_field(default_factory=dict)
    # field name -> list of float64 values (numeric/date/boolean)
    numeric_values: Dict[str, List[float]] = dc_field(default_factory=dict)
    # field name -> exact epoch-nanos longs (date_nanos only: float64
    # cannot hold ns-resolution epochs)
    int64_values: Dict[str, List[int]] = dc_field(default_factory=dict)
    # field name -> float32 vector
    vectors: Dict[str, np.ndarray] = dc_field(default_factory=dict)
    # field name -> list of (lat, lon)
    geo_points: Dict[str, List[Tuple[float, float]]] = dc_field(default_factory=dict)
    # dynamic mapping updates discovered while parsing (to merge into mapping)
    dynamic_updates: Dict[str, dict] = dc_field(default_factory=dict)
    # (nested path, child ParsedDocument) — block-joined hidden children,
    # indexed immediately before this parent (NestedFieldType)
    nested_docs: List[Tuple[str, "ParsedDocument"]] = \
        dc_field(default_factory=list)

    def field_names(self) -> List[str]:
        names = set()
        for d in (self.text_tokens, self.keyword_terms, self.numeric_values,
                  self.vectors, self.geo_points):
            names.update(k for k, v in d.items() if len(v) > 0)
        return sorted(names)


# ---------------------------------------------------------------------------
# MapperService
# ---------------------------------------------------------------------------


def resolve_field_patterns(mapper, pattern: str,
                           types: Optional[tuple] = None) -> List[str]:
    """Expand a ``*``-pattern over a mapper's concrete fields (the
    reference's ``QueryParserHelper.resolveMappingFields``); ``types``
    optionally restricts to specific MappedFieldType classes."""
    import fnmatch
    out = []
    for name, ft in getattr(mapper, "_fields", {}).items():
        if not fnmatch.fnmatchcase(name, pattern):
            continue
        if types is not None and not isinstance(ft, types):
            continue
        out.append(name)
    return out


class MapperService:
    """Holds the resolved mapping for one index and parses documents
    (reference: ``MapperService.java`` + ``DocumentParser.java:52``).

    ``mappings`` is the ES JSON shape: ``{"properties": {...}}``, optional
    ``"dynamic"``: true (default) / false / "strict", optional ``"_source"``:
    ``{"enabled": bool}``.
    """

    def __init__(self, mappings: Optional[dict] = None,
                 analysis_registry: Optional[AnalysisRegistry] = None):
        self.analysis = analysis_registry or AnalysisRegistry()
        self._fields: Dict[str, MappedFieldType] = {}
        #: fields whose column data a sort/agg has materialized — the
        #: fielddata stats accounting (lazily loaded, like Lucene)
        self.fielddata_loaded: set = set()
        #: index.mapping.nested_objects.limit (set by the index service)
        self.nested_limit = 10000
        self._mapping_def: dict = {"properties": {}}
        self.dynamic: Any = True
        self.source_enabled = True
        self.runtime_defs: Dict[str, dict] = {}
        if mappings:
            self.merge(mappings)

    # -- mapping management --------------------------------------------------

    def merge(self, mappings: dict) -> None:
        if not isinstance(mappings, dict):
            raise MapperParsingError("mapping must be an object")
        if "_doc" in mappings:
            raise IllegalArgumentError(
                "Types cannot be provided in put mapping requests")
        if "dynamic" in mappings:
            self.dynamic = mappings["dynamic"]
        if "_source" in mappings:
            self.source_enabled = bool(mappings["_source"].get("enabled", True))
        for name, spec in (mappings.get("runtime") or {}).items():
            script = (spec.get("script") or {})
            src = script.get("source") if isinstance(script, dict) \
                else str(script)
            if not src:
                raise MapperParsingError(
                    f"runtime field [{name}] requires a script")
            self._fields[name] = RuntimeFieldType(
                name, spec.get("type", "double"), src, {})
            self.runtime_defs[name] = spec
        props = mappings.get("properties", {})
        self._merge_properties("", props)
        self._rebuild_mapping_def()

    def _merge_properties(self, prefix: str, props: dict) -> None:
        for name, spec in props.items():
            if name == "":
                # reference: ObjectMapper.TypeParser rejects empty names
                # with an IllegalArgumentException
                raise IllegalArgumentError(
                    "field name cannot be an empty string")
            if not isinstance(spec, dict):
                raise MapperParsingError(f"invalid mapping for field [{name}]")
            full = f"{prefix}{name}"
            ftype = spec.get("type")
            if ftype is None and "properties" in spec:
                ftype = "object"
            if ftype is None:
                raise MapperParsingError(f"no type specified for field [{full}]")
            existing = self._fields.get(full)
            if existing is not None and existing.type_name != ftype and not (
                    ftype == "object" and
                    existing.type_name in ("object", "nested")):
                raise IllegalArgumentError(
                    f"mapper [{full}] cannot be changed from type "
                    f"[{existing.type_name}] to [{ftype}]")
            if ftype == "object" or ftype == "nested":
                if ftype == "nested" or not isinstance(
                        existing, NestedFieldType):
                    # dynamic "object" updates never demote a nested
                    # field; nested params (include_in_parent/root)
                    # survive into the rendered mapping
                    extra = {k: v for k, v in spec.items()
                             if k not in ("type", "properties")}
                    self._fields[full] = (
                        NestedFieldType(full, extra)
                        if ftype == "nested"
                        else ObjectFieldType(full, {"type": ftype}))
                self._merge_properties(f"{full}.", spec.get("properties", {}))
                continue
            self._fields[full] = self._build_field(full, ftype, spec)
            # multi-fields: "fields": {"raw": {"type": "keyword"}}
            for sub, subspec in (spec.get("fields") or {}).items():
                subfull = f"{full}.{sub}"
                self._fields[subfull] = self._build_field(
                    subfull, subspec.get("type", "keyword"), subspec)

    def _build_field(self, name: str, ftype: str, spec: dict) -> MappedFieldType:
        params = {k: v for k, v in spec.items()
                  if k not in ("type", "properties", "fields")}
        if ftype == "text":
            analyzer = self.analysis.get(spec.get("analyzer", "standard"))
            search_analyzer = (self.analysis.get(spec["search_analyzer"])
                               if "search_analyzer" in spec else None)
            return TextFieldType(name, analyzer, search_analyzer, params)
        if ftype == "keyword":
            return KeywordFieldType(
                name, int(spec.get("ignore_above", 2 ** 31 - 1)),
                spec.get("normalizer") == "lowercase", params)
        if ftype == "constant_keyword":
            return ConstantKeywordFieldType(name, params)
        if ftype == "wildcard":
            return WildcardFieldType(name, params)
        if ftype == "version":
            return VersionFieldType(name, params)
        if ftype == "flattened":
            return FlattenedFieldType(name, params)
        if ftype in NUMERIC_TYPES:
            return NumberFieldType(name, ftype, params)
        if ftype in ("date", "date_nanos"):
            # date_nanos maps onto the millisecond date column with the
            # sub-ms remainder kept in the float fraction (the reference
            # stores nanos in a long)
            return DateFieldType(
                name, spec.get("format", "strict_date_optional_time||epoch_millis"),
                params, nanos=(ftype == "date_nanos"))
        if ftype == "token_count":
            an = self.analysis.get(spec.get("analyzer", "standard"))
            return TokenCountFieldType(name, an, params)
        if ftype == "boolean":
            return BooleanFieldType(name, params)
        if ftype == "dense_vector":
            if "dims" not in spec:
                raise MapperParsingError(
                    f"Missing required parameter [dims] for field [{name}]")
            return DenseVectorFieldType(name, spec["dims"],
                                        spec.get("similarity", "cosine"), params)
        if ftype == "geo_point":
            return GeoPointFieldType(name, params)
        if ftype == "geo_shape":
            return GeoShapeFieldType(name, params)
        if ftype == "rank_feature":
            return RankFeatureFieldType(
                name, params,
                positive_score_impact=spec.get(
                    "positive_score_impact", True))
        if ftype == "rank_features":
            return RankFeaturesFieldType(
                name, params,
                positive_score_impact=spec.get(
                    "positive_score_impact", True))
        if ftype == "aggregate_metric_double":
            return AggregateMetricDoubleFieldType(
                name, spec.get("metrics"), spec.get("default_metric"),
                params)
        if ftype == "completion":
            return CompletionFieldType(name, params)
        if ftype == "ip":
            return IpFieldType(name, params)
        if ftype == "binary":
            return BinaryFieldType(name, params)
        if ftype == "alias":
            if "path" not in spec:
                raise MapperParsingError(
                    f"Field [{name}] of type [alias] must have a [path]")
            return AliasFieldType(name, spec["path"], params)
        if ftype == "join":
            jf = JoinFieldType(name, spec.get("relations") or {}, params)
            # the family-id columns exist per parent relation
            for parent in jf.relations:
                self._fields[f"{name}#{parent}"] = KeywordFieldType(
                    f"{name}#{parent}", 2 ** 31 - 1, False, {})
            return jf
        if ftype == "percolator":
            return PercolatorFieldType(name, params)
        if ftype in RANGE_TYPES:
            return RangeFieldType(name, ftype, params)
        if ftype == "search_as_you_type":
            # reference: SearchAsYouTypeFieldMapper — a text field plus
            # prefix-acceleration subfields; here the main field is text
            # and ._index_prefix stores edge n-grams of every term so
            # prefix/bool-prefix matches hit the postings directly
            analyzer = self.analysis.get(spec.get("analyzer", "standard"))
            self._fields[f"{name}._index_prefix"] = PrefixSubFieldType(
                f"{name}._index_prefix", analyzer, None, {})
            return SearchAsYouTypeFieldType(name, analyzer, params)
        raise MapperParsingError(f"No handler for type [{ftype}] declared on field [{name}]")

    def _rebuild_mapping_def(self) -> None:
        root: dict = {}
        for name in sorted(self._fields):
            ft = self._fields[name]
            if isinstance(ft, RuntimeFieldType):
                continue                 # rendered under "runtime"
            if "#" in name:
                continue                 # join-family id columns: internal
            parts = name.split(".")
            # Place under parent's "fields" if parent exists and is a leaf
            # (multi-field), else nest via "properties".
            parent = ".".join(parts[:-1])
            if parent and parent in self._fields and \
                    not isinstance(self._fields[parent], ObjectFieldType):
                continue  # rendered inline below as multi-field
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {"type": "object", "properties": {}})
                node = node.setdefault("properties", {})
            entry = ft.to_mapping()
            subfields = {
                n.split(".")[-1]: self._fields[n].to_mapping()
                for n in self._fields
                if n.startswith(name + ".") and "." not in n[len(name) + 1:]
                and not isinstance(ft, ObjectFieldType)
                # synthetic siblings re-register from the parent's type on
                # merge; rendering them as multi-fields would round-trip
                # them into plain text fields (double indexing)
                and not isinstance(self._fields[n], PrefixSubFieldType)}
            if subfields:
                entry["fields"] = subfields
            node[parts[-1]] = entry
        mapping_def: dict = {"properties": root}
        if self.runtime_defs:
            mapping_def["runtime"] = dict(self.runtime_defs)
        if self.dynamic is not True:
            mapping_def["dynamic"] = self.dynamic
        if not self.source_enabled:
            mapping_def["_source"] = {"enabled": False}
        self._mapping_def = mapping_def

    def mapping_dict(self) -> dict:
        if not self._mapping_def.get("properties") and \
                len(self._mapping_def) == 1:
            return {}               # a bare empty mapping serializes as {}
        return self._mapping_def

    def field_type(self, name: str) -> Optional[MappedFieldType]:
        ft = self._field_type_raw(name)
        if isinstance(ft, AliasFieldType):
            return self._field_type_raw(ft.path)
        if ft is None and "." in name:
            # flattened sub-paths resolve to synthetic keyword types
            # (FlattenedFieldMapper.KeyedFlattenedFieldType)
            parts = name.split(".")
            for i in range(len(parts) - 1, 0, -1):
                anc = self._field_type_raw(".".join(parts[:i]))
                if isinstance(anc, FlattenedFieldType):
                    return KeywordFieldType(name, 2 ** 31 - 1, False, {})
                if anc is not None:
                    break
        return ft

    def _field_type_raw(self, name: str) -> Optional[MappedFieldType]:
        return self._fields.get(name)

    def field_names(self) -> List[str]:
        return sorted(self._fields)

    def fields_of_type(self, *type_names: str) -> List[MappedFieldType]:
        return [f for f in self._fields.values() if f.type_name in type_names]

    # -- document parsing ----------------------------------------------------

    def parse_document(self, doc_id: str, source: dict,
                       routing: Optional[str] = None) -> ParsedDocument:
        if not isinstance(source, dict):
            raise MapperParsingError("document source must be a JSON object")
        parsed = ParsedDocument(doc_id=doc_id, source=source, routing=routing)
        if routing is not None:
            # _routing indexes as a metadata keyword (RoutingFieldMapper)
            parsed.keyword_terms.setdefault("_routing", []).append(routing)
        dc = source.get("_doc_count")
        if dc is not None:
            if not isinstance(dc, int) or isinstance(dc, bool) or dc <= 0:
                raise MapperParsingError(
                    f"[_doc_count] field value must be a positive integer,"
                    f" got [{dc}]")
            parsed.numeric_values.setdefault("_doc_count",
                                             []).append(float(dc))
        self._parse_object("", source, parsed)
        # constant_keyword: every doc of the index carries the constant
        # (term queries must match docs that omitted the field)
        for fname, ft0 in self._fields.items():
            if isinstance(ft0, ConstantKeywordFieldType) and \
                    ft0.value is not None:
                if getattr(ft0, "_pinned_dirty", False):
                    # a first-doc pin changes the rendered mapping
                    ft0._pinned_dirty = False
                    self._rebuild_mapping_def()
                if fname not in parsed.keyword_terms:
                    parsed.keyword_terms[fname] = [ft0.value]
        if len(parsed.nested_docs) > self.nested_limit:
            raise IllegalArgumentError(
                f"The number of nested documents has exceeded the allowed "
                f"limit of [{self.nested_limit}]. This limit can be set "
                f"by changing the [index.mapping.nested_objects.limit] "
                f"index level setting.")
        if parsed.dynamic_updates:
            self.merge({"properties": parsed.dynamic_updates})
        return parsed

    def _parse_object(self, prefix: str, obj: dict, parsed: ParsedDocument) -> None:
        for key, value in obj.items():
            full = f"{prefix}{key}"
            if value is None:
                continue
            if full == "_doc_count":
                continue          # meta field, handled in parse_document
            ft = self._fields.get(full)
            if isinstance(ft, NestedFieldType):
                children = value if isinstance(value, list) else [value]
                for ci, child in enumerate(children):
                    if not isinstance(child, dict):
                        raise MapperParsingError(
                            f"object mapping for [{full}] tried to parse "
                            f"field as object, but got a non-object value")
                    child_parsed = ParsedDocument(
                        doc_id=f"{parsed.doc_id}#{full}#{ci}", source=child)
                    child_parsed.dynamic_updates = parsed.dynamic_updates
                    self._parse_object(f"{full}.", child, child_parsed)
                    parsed.nested_docs.append((full, child_parsed))
                continue
            if isinstance(value, dict) and (ft is None or isinstance(ft, ObjectFieldType)):
                if ft is None:
                    if self._check_dynamic(full):
                        self._parse_object(f"{full}.", value, parsed)
                else:
                    self._parse_object(f"{full}.", value, parsed)
                continue
            if ft is None:
                ft = self._dynamic_map(full, value, parsed)
                if ft is None:
                    continue
            if isinstance(value, list) and not isinstance(ft, DenseVectorFieldType) \
                    and not (isinstance(ft, GeoPointFieldType) and value
                             and isinstance(value[0], numbers.Number)):
                values = value
            else:
                values = [value]
            for v in values:
                if v is None:
                    continue
                if isinstance(ft, AliasFieldType):
                    raise MapperParsingError(
                        f"Cannot write to a field alias [{full}].")
                try:
                    self._index_leaf(ft, full, v, parsed)
                except MapperParsingError:
                    # ignore_malformed drops the bad VALUE, keeps the doc
                    # and records the field in the _ignored meta field
                    if not ft.params.get("ignore_malformed"):
                        raise
                    parsed.keyword_terms.setdefault("_ignored",
                                                    []).append(full)

    def _maybe_geo(self, full: str, value: dict, parsed: ParsedDocument) -> bool:
        return False  # dynamic geo detection is off, like the reference default

    def _check_dynamic(self, field: str) -> bool:
        if self.dynamic == "strict":
            raise MapperParsingError(
                f"mapping set to strict, dynamic introduction of [{field}] "
                f"within [_doc] is not allowed", )
        return self.dynamic is not False and self.dynamic != "false"

    def _dynamic_map(self, full: str, value: Any,
                     parsed: ParsedDocument) -> Optional[MappedFieldType]:
        if not self._check_dynamic(full):
            return None
        sample = value[0] if isinstance(value, list) and value else value
        if sample is None:
            return None
        if isinstance(sample, bool):
            spec = {"type": "boolean"}
        elif isinstance(sample, int):
            spec = {"type": "long"}
        elif isinstance(sample, float):
            spec = {"type": "double"}
        elif isinstance(sample, str):
            # date detection (DynamicFieldsBuilder: date_detection default
            # true for strict_date_optional_time-shaped strings)
            if _looks_date(sample.strip()):
                spec = {"type": "date"}
            else:
                spec = {"type": "text", "fields": {"keyword": {
                    "type": "keyword", "ignore_above": 256}}}
        elif isinstance(sample, list):
            return None  # empty/odd nested list
        else:
            return None
        # record for merge into the mapping (nested path → nested spec)
        parts = full.split(".")
        node = parsed.dynamic_updates
        for p in parts[:-1]:
            node = node.setdefault(p, {"type": "object", "properties": {}})
            node = node.setdefault("properties", {})
        node[parts[-1]] = spec
        ft = self._build_field(full, spec["type"], spec)
        self._fields[full] = ft
        if "fields" in spec:
            for sub, subspec in spec["fields"].items():
                self._fields[f"{full}.{sub}"] = self._build_field(
                    f"{full}.{sub}", subspec["type"], subspec)
        return ft

    def _index_leaf(self, ft: MappedFieldType, full: str, value: Any,
                    parsed: ParsedDocument) -> None:
        if isinstance(ft, ObjectFieldType):
            return
        if isinstance(ft, TextFieldType):
            text = ft.parse_value(value)
            toks = parsed.text_tokens.setdefault(full, [])
            # Lucene places the first token of value N+1 at
            # last_position + position_increment_gap(100) + 1
            base_pos = (toks[-1].position + 101) if toks else 0
            new = ft.analyzer.analyze(text)
            for t in new:
                toks.append(Token(t.term, t.position + base_pos,
                                  t.start_offset, t.end_offset))
            if isinstance(ft, SearchAsYouTypeFieldType):
                pref = parsed.text_tokens.setdefault(
                    f"{full}._index_prefix", [])
                for t in new:
                    for n in range(2, min(len(t.term),
                                          ft.MAX_PREFIX) + 1):
                        pref.append(Token(t.term[:n],
                                          t.position + base_pos,
                                          t.start_offset, t.end_offset))
        elif isinstance(ft, IpFieldType):
            s, num = ft.parse_value(value)
            parsed.keyword_terms.setdefault(full, []).append(s)
            parsed.numeric_values.setdefault(full, []).append(num)
        elif isinstance(ft, RangeFieldType):
            lo, hi = ft.parse_value(value)
            parsed.numeric_values.setdefault(f"{full}._gte", []).append(lo)
            parsed.numeric_values.setdefault(f"{full}._lte", []).append(hi)
        elif isinstance(ft, BinaryFieldType):
            ft.parse_value(value)            # validate; stored in _source
            # presence for exists queries via the _field_names meta field
            # (the reference's FieldNamesFieldMapper)
            parsed.keyword_terms.setdefault("_field_names",
                                            []).append(full)
        elif isinstance(ft, JoinFieldType):
            if isinstance(value, str):
                rel, parent_id = value, None
            elif isinstance(value, dict):
                rel = value.get("name")
                parent_id = value.get("parent")
            else:
                raise MapperParsingError(
                    f"failed to parse join field [{full}]")
            if rel not in ft.all_names():
                raise MapperParsingError(
                    f"unknown join name [{rel}] for field [{full}]")
            parsed.keyword_terms.setdefault(full, []).append(rel)
            if ft.parent_rel_of(rel) is not None:
                if parent_id is None:
                    raise MapperParsingError(
                        f"[parent] is missing for join field [{full}]")
                parsed.keyword_terms.setdefault(
                    ft.id_field_for(rel), []).append(str(parent_id))
            if rel in ft.relations:
                # a doc whose relation has children of its own stores
                # its OWN id in that relation's family column (multi-
                # level joins: parent -> child -> grand_child)
                parsed.keyword_terms.setdefault(
                    f"{full}#{rel}", []).append(parsed.doc_id)
        elif isinstance(ft, PercolatorFieldType):
            from ..search.query_dsl import parse_query
            try:
                parse_query(value)       # the stored query must parse
            except Exception as e:
                raise MapperParsingError(
                    f"failed to parse query for field [{full}]: {e}")
            parsed.keyword_terms.setdefault("_field_names",
                                            []).append(full)
        elif isinstance(ft, ConstantKeywordFieldType):
            v = ft.index_value(value)
            if v is not None:
                parsed.keyword_terms.setdefault(full, []).append(v)
        elif isinstance(ft, VersionFieldType):
            v = ft.parse_value(value)
            if v is not None:
                parsed.keyword_terms.setdefault(full, []).append(v)
                k = ft.sort_key(v)
                if k is not None:
                    # paired numeric order key → semver-correct sorting
                    parsed.numeric_values.setdefault(full, []).append(k)
        elif isinstance(ft, FlattenedFieldType):
            if not isinstance(value, (dict, list)):
                raise MapperParsingError(
                    f"Failed to parse object: expecting an object but "
                    f"got [{type(value).__name__}] for field [{full}]")
            for path, leaf in ft.leaves(value):
                parsed.keyword_terms.setdefault(full, []).append(leaf)
                if path:
                    parsed.keyword_terms.setdefault(
                        f"{full}.{path}", []).append(leaf)
        elif isinstance(ft, KeywordFieldType):
            v = ft.parse_value(value)
            if v is not None:
                parsed.keyword_terms.setdefault(full, []).append(v)
        elif isinstance(ft, CompletionFieldType):
            inputs, weight, cvals = ft.parse_value(value)
            parsed.keyword_terms.setdefault(full, []).extend(inputs)
            parsed.numeric_values.setdefault(f"{full}._weight",
                                             []).append(float(weight))
            for cname, toks in ft.context_tokens(cvals,
                                                 parsed.source).items():
                parsed.keyword_terms.setdefault(
                    f"{full}._ctx_{cname}", []).extend(toks)
        elif isinstance(ft, DenseVectorFieldType):
            parsed.vectors[full] = ft.parse_value(value)
        elif isinstance(ft, GeoPointFieldType):
            lat, lon = ft.parse_value(value)
            parsed.geo_points.setdefault(full, []).append((lat, lon))
            # paired positional columns (lockstep append, like range fields'
            # _gte/_lte) so distance/grid queries and aggs read doc values
            parsed.numeric_values.setdefault(f"{full}._lat", []).append(lat)
            parsed.numeric_values.setdefault(f"{full}._lon", []).append(lon)
        elif isinstance(ft, GeoShapeFieldType):
            geom = ft.parse_value(value)
            x1, y1, x2, y2 = geom.bbox()
            # bbox columns: presence (exists) + coarse pre-filter
            parsed.numeric_values.setdefault(full, []).append(0.0)
            for key, v in (("_minx", x1), ("_miny", y1),
                           ("_maxx", x2), ("_maxy", y2)):
                parsed.numeric_values.setdefault(
                    f"{full}.{key}", []).append(v)
        elif isinstance(ft, RankFeatureFieldType):
            parsed.numeric_values.setdefault(full, []).append(
                ft.parse_value(value))
        elif isinstance(ft, RankFeaturesFieldType):
            feats = ft.parse_value(value)
            parsed.numeric_values.setdefault(full, []).append(0.0)
            for feat, fv in feats.items():
                parsed.numeric_values.setdefault(
                    f"{full}.{feat}", []).append(fv)
        elif isinstance(ft, AggregateMetricDoubleFieldType):
            metrics = ft.parse_value(value)
            # the bare name carries default_metric so term/range/sort
            # resolve like the reference's default_metric delegation
            parsed.numeric_values.setdefault(full, []).append(
                metrics[ft.default_metric])
            for m, v in metrics.items():
                parsed.numeric_values.setdefault(
                    f"{full}.{m}", []).append(v)
        elif isinstance(ft, (NumberFieldType, DateFieldType, BooleanFieldType,
                             TokenCountFieldType)):
            parsed.numeric_values.setdefault(full, []).append(ft.parse_value(value))
            if isinstance(ft, DateFieldType) and ft.nanos:
                parsed.int64_values.setdefault(full, []).append(
                    parse_date_nanos(value, ft.format, ft.locale))
        # index multi-fields too
        for sub_name in list(self._fields):
            if sub_name.startswith(full + ".") and "." not in sub_name[len(full) + 1:]:
                sub = self._fields[sub_name]
                if isinstance(sub, (ObjectFieldType, PrefixSubFieldType)) \
                        or sub_name == full:
                    continue
                if not isinstance(ft, ObjectFieldType) and not isinstance(
                        sub, (ObjectFieldType,)):
                    # only leaf multi-fields of leaf parents
                    if isinstance(sub, CompletionFieldType):
                        inputs, weight, cvals = sub.parse_value(value)
                        parsed.keyword_terms.setdefault(
                            sub_name, []).extend(inputs)
                        parsed.numeric_values.setdefault(
                            f"{sub_name}._weight", []).append(float(weight))
                        for cname, toks in sub.context_tokens(
                                cvals, parsed.source).items():
                            parsed.keyword_terms.setdefault(
                                f"{sub_name}._ctx_{cname}",
                                []).extend(toks)
                    elif isinstance(sub, KeywordFieldType):
                        v = sub.parse_value(value)
                        if v is not None:
                            parsed.keyword_terms.setdefault(sub_name, []).append(v)
                    elif isinstance(sub, (NumberFieldType, DateFieldType,
                                          BooleanFieldType,
                                          TokenCountFieldType)):
                        try:
                            parsed.numeric_values.setdefault(
                                sub_name, []).append(sub.parse_value(value))
                        except MapperParsingError:
                            if not (sub.params or {}).get(
                                    "ignore_malformed"):
                                raise
                    elif isinstance(sub, TextFieldType):
                        toks = parsed.text_tokens.setdefault(sub_name, [])
                        base_pos = (toks[-1].position + 101) if toks else 0
                        for t in sub.analyzer.analyze(str(value)):
                            toks.append(Token(t.term, t.position + base_pos,
                                              t.start_offset, t.end_offset))
