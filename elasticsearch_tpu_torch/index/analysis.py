"""Text analysis: char filters → tokenizer → token filters → token stream.

Re-design of the reference analysis registry
(``server/.../index/analysis/AnalysisRegistry.java:57`` and the analyzer
implementations in ``modules/analysis-common/``). Analysis runs on the host at
index/query time; its output feeds the device-side postings builder
(`elasticsearch_tpu.index.segment`). Tokens carry positions (phrase queries)
and character offsets (highlighting), like Lucene token attributes.

Built-in analyzers (named like the reference's): ``standard``, ``simple``,
``whitespace``, ``keyword``, ``stop``, ``english``. Custom analyzers can be
declared per index via ``settings.analysis`` with the same JSON shape the
reference accepts.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from ..common.errors import IllegalArgumentError


@dataclass(slots=True)
class Token:
    """A single analyzed token (term text, position, char offsets)."""

    term: str
    position: int
    start_offset: int
    end_offset: int


# ---------------------------------------------------------------------------
# Tokenizers
# ---------------------------------------------------------------------------

# Unicode word tokenizer: runs of letters/digits (plus combining marks within).
# Approximates UAX#29 word segmentation used by Lucene's StandardTokenizer.
_WORD_RE = re.compile(r"[\w]+", re.UNICODE)
_LETTER_RE = re.compile(r"[^\W\d_]+", re.UNICODE)
_WHITESPACE_RE = re.compile(r"\S+")


def _regex_tokenize(text: str, pattern: re.Pattern) -> List[Token]:
    tokens = []
    for pos, m in enumerate(pattern.finditer(text)):
        tokens.append(Token(m.group(), pos, m.start(), m.end()))
    return tokens


def standard_tokenizer(text: str) -> List[Token]:
    return _regex_tokenize(text, _WORD_RE)


def letter_tokenizer(text: str) -> List[Token]:
    return _regex_tokenize(text, _LETTER_RE)


def whitespace_tokenizer(text: str) -> List[Token]:
    return _regex_tokenize(text, _WHITESPACE_RE)


def keyword_tokenizer(text: str) -> List[Token]:
    return [Token(text, 0, 0, len(text))] if text else []


def ngram_tokenizer(min_gram: int = 1, max_gram: int = 2):
    def tokenize(text: str) -> List[Token]:
        tokens = []
        pos = 0
        for start in range(len(text)):
            for n in range(min_gram, max_gram + 1):
                if start + n > len(text):
                    break
                tokens.append(Token(text[start:start + n], pos, start, start + n))
                pos += 1
        return tokens
    return tokenize


def edge_ngram_tokenizer(min_gram: int = 1, max_gram: int = 2):
    def tokenize(text: str) -> List[Token]:
        return [Token(text[:n], 0, 0, n)
                for n in range(min_gram, min(max_gram, len(text)) + 1)]
    return tokenize


TOKENIZERS: Dict[str, Callable[[str], List[Token]]] = {
    "standard": standard_tokenizer,
    "letter": letter_tokenizer,
    "whitespace": whitespace_tokenizer,
    "keyword": keyword_tokenizer,
}


# ---------------------------------------------------------------------------
# Token filters
# ---------------------------------------------------------------------------

ENGLISH_STOP_WORDS = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such "
    "that the their then there these they this to was will with".split())


def lowercase_filter(tokens: List[Token]) -> List[Token]:
    for t in tokens:
        t.term = t.term.lower()
    return tokens


def asciifolding_filter(tokens: List[Token]) -> List[Token]:
    for t in tokens:
        t.term = "".join(c for c in unicodedata.normalize("NFKD", t.term)
                         if not unicodedata.combining(c))
    return tokens


def make_stop_filter(stopwords: Iterable[str] = ENGLISH_STOP_WORDS):
    stopset = frozenset(stopwords)

    def stop_filter(tokens: List[Token]) -> List[Token]:
        # Positions are preserved across removed stopwords (position gaps),
        # matching Lucene's StopFilter position-increment behaviour.
        return [t for t in tokens if t.term not in stopset]

    return stop_filter


def make_length_filter(min_len: int = 0, max_len: int = 2 ** 31 - 1):
    def length_filter(tokens):
        return [t for t in tokens if min_len <= len(t.term) <= max_len]
    return length_filter


def unique_filter(tokens: List[Token]) -> List[Token]:
    seen = set()
    out = []
    for t in tokens:
        if t.term not in seen:
            seen.add(t.term)
            out.append(t)
    return out


def _porter_stem(word: str) -> str:
    """Porter stemming algorithm (Porter 1980), english analyzer's stemmer.

    Self-contained implementation of the classic algorithm; behaviourally
    equivalent to Lucene's PorterStemFilter for ASCII words.
    """
    if len(word) <= 2:
        return word

    vowels = "aeiou"

    def is_cons(w, i):
        c = w[i]
        if c in vowels:
            return False
        if c == "y":
            return i == 0 or not is_cons(w, i - 1)
        return True

    def measure(w):
        # number of VC sequences
        m = 0
        prev_vowel = False
        for i in range(len(w)):
            cons = is_cons(w, i)
            if prev_vowel and cons:
                m += 1
            prev_vowel = not cons
        return m

    def has_vowel(w):
        return any(not is_cons(w, i) for i in range(len(w)))

    def ends_double_cons(w):
        return len(w) >= 2 and w[-1] == w[-2] and is_cons(w, len(w) - 1)

    def cvc(w):
        if len(w) < 3:
            return False
        if not (is_cons(w, len(w) - 3) and not is_cons(w, len(w) - 2)
                and is_cons(w, len(w) - 1)):
            return False
        return w[-1] not in "wxy"

    w = word

    # Step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # Step 1b
    flag = False
    if w.endswith("eed"):
        if measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and has_vowel(w[:-2]):
        w = w[:-2]
        flag = True
    elif w.endswith("ing") and has_vowel(w[:-3]):
        w = w[:-3]
        flag = True
    if flag:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif ends_double_cons(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif measure(w) == 1 and cvc(w):
            w += "e"

    # Step 1c
    if w.endswith("y") and has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # Step 2
    step2 = [("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
             ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
             ("alli", "al"), ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
             ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
             ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
             ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"),
             ("biliti", "ble")]
    for suf, rep in step2:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if measure(stem) > 0:
                w = stem + rep
            break

    # Step 3
    step3 = [("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
             ("ical", "ic"), ("ful", ""), ("ness", "")]
    for suf, rep in step3:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if measure(stem) > 0:
                w = stem + rep
            break

    # Step 4
    step4 = ["al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
             "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize"]
    for suf in sorted(step4, key=len, reverse=True):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" and measure(w[:-3]) > 1:
            w = w[:-3]

    # Step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = measure(stem)
        if m > 1 or (m == 1 and not cvc(stem)):
            w = stem
    # Step 5b
    if measure(w) > 1 and ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]

    return w


def porter_stem_filter(tokens: List[Token]) -> List[Token]:
    for t in tokens:
        t.term = _porter_stem(t.term)
    return tokens


TOKEN_FILTERS: Dict[str, Callable[[List[Token]], List[Token]]] = {
    "lowercase": lowercase_filter,
    "asciifolding": asciifolding_filter,
    "stop": make_stop_filter(),
    "porter_stem": porter_stem_filter,
    "stemmer": porter_stem_filter,
    "unique": unique_filter,
}


# ---------------------------------------------------------------------------
# Char filters
# ---------------------------------------------------------------------------

_HTML_RE = re.compile(r"<[^>]*>")


def html_strip_char_filter(text: str) -> str:
    return _HTML_RE.sub(" ", text)


CHAR_FILTERS: Dict[str, Callable[[str], str]] = {
    "html_strip": html_strip_char_filter,
}


# ---------------------------------------------------------------------------
# Analyzer
# ---------------------------------------------------------------------------


class Analyzer:
    def __init__(self, name: str,
                 tokenizer: Callable[[str], List[Token]],
                 token_filters: Sequence[Callable[[List[Token]], List[Token]]] = (),
                 char_filters: Sequence[Callable[[str], str]] = ()):
        self.name = name
        self.tokenizer = tokenizer
        self.token_filters = list(token_filters)
        self.char_filters = list(char_filters)

    #: set on analyzers whose (tokenizer, first filter) pair is exactly
    #: (standard word segmentation, lowercase) — eligible for the native
    #: ASCII fast path, which fuses both steps in C++
    _native_fast = False

    def analyze(self, text: str) -> List[Token]:
        for cf in self.char_filters:
            text = cf(text)
        if self._native_fast:
            fast = _native_tokenize(text)
            if fast is not None:
                tokens = [Token(term, pos, s, e)
                          for pos, (term, s, e) in enumerate(fast)]
                for tf in self.token_filters[1:]:   # lowercase fused in
                    tokens = tf(tokens)
                return tokens
        tokens = self.tokenizer(text)
        for tf in self.token_filters:
            tokens = tf(tokens)
        return tokens

    def terms(self, text: str) -> List[str]:
        return [t.term for t in self.analyze(text)]


def _native_tokenize(text: str):
    """ASCII fast path via the C++ library; None → use the Python path."""
    try:
        from ..native import tokenize_ascii
    except Exception:   # noqa: BLE001 — no native package
        return None
    return tokenize_ascii(text)


def _mark_native(an: Analyzer) -> Analyzer:
    if an.tokenizer is standard_tokenizer and an.token_filters and \
            an.token_filters[0] is lowercase_filter:
        an._native_fast = True
    return an


BUILTIN_ANALYZERS: Dict[str, Analyzer] = {
    "standard": _mark_native(
        Analyzer("standard", standard_tokenizer, [lowercase_filter])),
    "simple": Analyzer("simple", letter_tokenizer, [lowercase_filter]),
    "whitespace": Analyzer("whitespace", whitespace_tokenizer),
    "keyword": Analyzer("keyword", keyword_tokenizer),
    "stop": Analyzer("stop", letter_tokenizer,
                     [lowercase_filter, make_stop_filter()]),
    "english": _mark_native(
        Analyzer("english", standard_tokenizer,
                 [lowercase_filter, make_stop_filter(),
                  porter_stem_filter])),
}


class AnalysisRegistry:
    """Per-index analyzer registry built from index settings
    (reference: ``index/analysis/AnalysisRegistry.java:57``).

    Accepts the reference's settings JSON shape::

        "analysis": {
          "char_filter":  {"my_cf": {"type": "html_strip"}},
          "filter":     {"my_stop": {"type": "stop", "stopwords": [...]}},
          "tokenizer":  {"my_ng": {"type": "ngram", "min_gram": 2, ...}},
          "analyzer":   {"my_an": {"type": "custom", "tokenizer": "standard",
                                   "filter": ["lowercase", "my_stop"]}}
        }
    """

    def __init__(self, analysis_config: Optional[dict] = None):
        self._analyzers: Dict[str, Analyzer] = dict(BUILTIN_ANALYZERS)
        config = analysis_config or {}

        custom_char_filters = dict(CHAR_FILTERS)
        for name, spec in (config.get("char_filter") or {}).items():
            custom_char_filters[name] = self._build_char_filter(name, spec)

        custom_tokenizers = dict(TOKENIZERS)
        for name, spec in (config.get("tokenizer") or {}).items():
            custom_tokenizers[name] = self._build_tokenizer(name, spec)

        custom_filters = dict(TOKEN_FILTERS)
        for name, spec in (config.get("filter") or {}).items():
            custom_filters[name] = self._build_token_filter(name, spec)

        for name, spec in (config.get("analyzer") or {}).items():
            atype = spec.get("type", "custom")
            if atype != "custom" and atype in BUILTIN_ANALYZERS:
                self._analyzers[name] = BUILTIN_ANALYZERS[atype]
                continue
            tok_name = spec.get("tokenizer", "standard")
            if tok_name not in custom_tokenizers:
                raise IllegalArgumentError(
                    f"failed to find tokenizer [{tok_name}] for analyzer [{name}]")
            filters = []
            for fname in spec.get("filter", []):
                if fname not in custom_filters:
                    raise IllegalArgumentError(
                        f"failed to find filter [{fname}] for analyzer [{name}]")
                filters.append(custom_filters[fname])
            char_filters = []
            for cfname in spec.get("char_filter", []):
                if cfname not in custom_char_filters:
                    raise IllegalArgumentError(
                        f"failed to find char_filter [{cfname}] for analyzer [{name}]")
                char_filters.append(custom_char_filters[cfname])
            self._analyzers[name] = _mark_native(
                Analyzer(name, custom_tokenizers[tok_name],
                         filters, char_filters))

    @staticmethod
    def _build_tokenizer(name: str, spec: dict):
        ttype = spec.get("type", name)
        if ttype == "ngram":
            return ngram_tokenizer(int(spec.get("min_gram", 1)),
                                   int(spec.get("max_gram", 2)))
        if ttype == "edge_ngram":
            return edge_ngram_tokenizer(int(spec.get("min_gram", 1)),
                                        int(spec.get("max_gram", 2)))
        if ttype == "pattern":
            return lambda text, _p=re.compile(spec.get("pattern", r"\W+")): [
                Token(part, i, 0, 0)
                for i, part in enumerate(p for p in _p.split(text) if p)]
        if ttype in TOKENIZERS:
            return TOKENIZERS[ttype]
        raise IllegalArgumentError(f"unknown tokenizer type [{ttype}] for [{name}]")

    @staticmethod
    def _build_token_filter(name: str, spec: dict):
        ftype = spec.get("type", name)
        if ftype == "stop":
            stopwords = spec.get("stopwords", ENGLISH_STOP_WORDS)
            if stopwords == "_english_":
                stopwords = ENGLISH_STOP_WORDS
            return make_stop_filter(stopwords)
        if ftype == "length":
            return make_length_filter(int(spec.get("min", 0)),
                                      int(spec.get("max", 2 ** 31 - 1)))
        if ftype in ("stemmer", "porter_stem"):
            return porter_stem_filter
        if ftype == "synonym":
            mapping: Dict[str, List[str]] = {}
            for rule in spec.get("synonyms", []):
                if "=>" in rule:
                    lhs, rhs = rule.split("=>")
                    targets = [s.strip() for s in rhs.split(",")]
                    for src in lhs.split(","):
                        mapping[src.strip()] = targets
                else:
                    group = [s.strip() for s in rule.split(",")]
                    for src in group:
                        mapping[src] = group

            def synonym_filter(tokens: List[Token]) -> List[Token]:
                out = []
                for t in tokens:
                    if t.term in mapping:
                        for syn in mapping[t.term]:
                            out.append(Token(syn, t.position, t.start_offset,
                                             t.end_offset))
                    else:
                        out.append(t)
                return out

            return synonym_filter
        if ftype in TOKEN_FILTERS:
            return TOKEN_FILTERS[ftype]
        raise IllegalArgumentError(f"unknown filter type [{ftype}] for [{name}]")

    @staticmethod
    def _build_char_filter(name: str, spec: dict):
        cftype = spec.get("type", name)
        if cftype == "html_strip":
            return html_strip_char_filter
        if cftype == "mapping":
            pairs = []
            for rule in spec.get("mappings", []):
                src, _, dst = rule.partition("=>")
                pairs.append((src.strip(), dst.strip()))

            def mapping_filter(text: str) -> str:
                for src, dst in pairs:
                    text = text.replace(src, dst)
                return text

            return mapping_filter
        if cftype == "pattern_replace":
            pat = re.compile(spec.get("pattern", ""))
            repl = spec.get("replacement", "")
            return lambda text: pat.sub(repl, text)
        raise IllegalArgumentError(f"unknown char_filter type [{cftype}] for [{name}]")

    def get(self, name: str) -> Analyzer:
        a = self._analyzers.get(name)
        if a is None and name == "default":
            # "analyzer": "default" aliases the index default analyzer
            # (settings `index.analysis.analyzer.default`), falling back
            # to standard (reference: AnalysisRegistry.getAnalyzer)
            a = self._analyzers.get("standard")
        if a is None:
            raise IllegalArgumentError(f"failed to find analyzer [{name}]")
        return a

    def has(self, name: str) -> bool:
        return name in self._analyzers
