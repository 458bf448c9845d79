"""Ingest pipelines: document pre-processing before indexing.

Re-design of the reference's node ingest service
(``ingest/IngestService.java:437`` executes pipelines inside the bulk path;
``ingest/CompoundProcessor.java`` implements the failure chain;
``modules/ingest-common/`` ships the processor library). Pipelines here are
pure host-side document transforms — they run before documents reach the
mapper/segment layer, so nothing in them touches the device.

Semantics kept from the reference:

- a pipeline is a list of processors, each with optional ``if`` condition,
  ``tag``, ``ignore_failure`` and ``on_failure`` chain;
- processor failure runs its ``on_failure`` chain if present, else the
  pipeline-level ``on_failure``, else propagates (failing the bulk item,
  not the whole bulk);
- ``drop`` terminates the pipeline and discards the document;
- the ``pipeline`` processor invokes another pipeline inline, with cycle
  detection (``IngestDocument.executedPipelines`` in the reference);
- failure metadata fields ``_ingest.on_failure_message`` /
  ``on_failure_processor_type`` / ``on_failure_processor_tag`` are visible
  to the on_failure chain.

Field paths are dot-separated and resolve through nested dicts and list
indices; ``_ingest.timestamp`` and templated ``{{field}}`` values are
supported where the reference supports mustache templating.
"""

from __future__ import annotations

import ast
import copy
import datetime
import json
import re
import time
from typing import Any, Callable, Dict, List, Optional

from ..common.errors import (ElasticsearchError, IllegalArgumentError,
                             ParsingError, ResourceNotFoundError)
from ..utils.expressions import ScriptException, compile_expression


# ---------------------------------------------------------------------------
# ingest document
# ---------------------------------------------------------------------------


_SENTINEL = object()


class DropDocument(Exception):
    """Raised by the drop processor: discard the document, no error."""


class ProcessorException(ElasticsearchError):
    status = 400
    error_type = "illegal_argument_exception"


class IngestDocument:
    """Mutable view of one document moving through a pipeline."""

    def __init__(self, index: str, doc_id: Optional[str], source: dict,
                 routing: Optional[str] = None):
        self.source = source
        self.meta = {"_index": index, "_id": doc_id, "_routing": routing}
        self.ingest_meta = {"timestamp": _now_iso()}
        self.executed_pipelines: List[str] = []

    # -- path resolution ----------------------------------------------------

    def _resolve_parent(self, path: str, create: bool = False):
        """(container, last_key) for a dot path; raises on missing parents
        unless ``create``."""
        parts = path.split(".")
        node: Any = self.source
        if parts[0] == "_ingest":
            node = self.ingest_meta
            parts = parts[1:]
            if not parts:
                raise ProcessorException("cannot address [_ingest] itself")
        elif parts[0] in self.meta and len(parts) == 1:
            return self.meta, parts[0]
        for p in parts[:-1]:
            if isinstance(node, list):
                try:
                    node = node[int(p)]
                    continue
                except (ValueError, IndexError):
                    raise ProcessorException(
                        f"[{p}] is not a valid array index in path [{path}]")
            if not isinstance(node, dict):
                raise ProcessorException(
                    f"cannot resolve [{p}] in path [{path}]: parent is not "
                    f"an object")
            if p not in node:
                if not create:
                    raise ProcessorException(
                        f"field [{p}] not present as part of path [{path}]")
                node[p] = {}
            node = node[p]
        return node, parts[-1]

    def has(self, path: str) -> bool:
        try:
            node, last = self._resolve_parent(path)
        except ProcessorException:
            return False
        if isinstance(node, list):
            try:
                node[int(last)]
                return True
            except (ValueError, IndexError):
                return False
        return isinstance(node, dict) and last in node

    def get(self, path: str, default=_SENTINEL):
        node, last = self._resolve_parent(path)
        if isinstance(node, list):
            try:
                return node[int(last)]
            except (ValueError, IndexError):
                raise ProcessorException(
                    f"[{last}] is not a valid array index in path [{path}]")
        if not isinstance(node, dict) or last not in node:
            if default is not _SENTINEL:
                return default
            raise ProcessorException(f"field [{path}] not present")
        return node[last]

    def set(self, path: str, value) -> None:
        node, last = self._resolve_parent(path, create=True)
        if isinstance(node, list):
            try:
                node[int(last)] = value
                return
            except (ValueError, IndexError):
                raise ProcessorException(
                    f"[{last}] is not a valid array index in path [{path}]")
        node[last] = value

    def remove(self, path: str) -> None:
        node, last = self._resolve_parent(path)
        if isinstance(node, list):
            try:
                node.pop(int(last))
                return
            except (ValueError, IndexError):
                raise ProcessorException(
                    f"[{last}] is not a valid array index in path [{path}]")
        if last not in node:
            raise ProcessorException(
                f"field [{path}] not present as part of path [{path}]")
        del node[last]

    # -- templating / script env --------------------------------------------

    def render(self, template: str) -> str:
        """Mustache-lite ``{{field}}`` / ``{{{field}}}`` substitution."""
        def sub(m):
            v = self.get(m.group(1).strip())
            return "" if v is None else str(v)
        return re.sub(r"\{\{\{?([^{}]+?)\}?\}\}", sub, template)

    def flat_env(self) -> Dict[str, Any]:
        """ctx.* variables for script/if evaluation: top-level fields plus
        flattened dotted leaves (dots become underscores — the expression
        grammar has no attribute access)."""
        env: Dict[str, Any] = {}

        def walk(prefix, node):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(f"{prefix}{k}_" if prefix else f"{k}_", v)
            else:
                env[prefix[:-1]] = node
        for k, v in self.source.items():
            env[k] = v if not isinstance(v, dict) else v
            if isinstance(v, dict):
                walk(f"{k}_", v)
        env["_index"] = self.meta["_index"]
        env["_id"] = self.meta["_id"]
        return env


def _now_iso() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


# ---------------------------------------------------------------------------
# restricted scalar expression evaluation (strings allowed)
# ---------------------------------------------------------------------------


def eval_ingest_expr(source: str, env: Dict[str, Any]):
    """Evaluate the restricted expression grammar with string constants
    allowed (conditions like ``ctx.status == 'error'``). ``ctx.a.b`` paths
    are rewritten to underscore variables before parsing."""
    # string literals must survive the ctx-path rewrite: do it token-wise
    cleaned = _rewrite_ctx(source)
    tree = compile_expression(cleaned)

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            if node.id in env:
                return env[node.id]
            raise ScriptException(f"unknown variable [{node.id}]")
        if isinstance(node, ast.BinOp):
            a, b = ev(node.left), ev(node.right)
            op = type(node.op)
            try:
                if op is ast.Add:
                    return a + b
                if op is ast.Sub:
                    return a - b
                if op is ast.Mult:
                    return a * b
                if op is ast.Div:
                    return a / b
                if op is ast.Mod:
                    return a % b
                if op is ast.Pow:
                    return a ** b
                if op is ast.FloorDiv:
                    return a // b
            except ZeroDivisionError:
                raise ScriptException("division by zero in script")
            except TypeError as e:
                raise ScriptException(f"type error in script: {e}")
        if isinstance(node, ast.UnaryOp):
            v = ev(node.operand)
            if isinstance(node.op, ast.USub):
                return -v
            if isinstance(node.op, ast.UAdd):
                return +v
            if isinstance(node.op, ast.Not):
                return not v
        if isinstance(node, ast.Compare):
            left = ev(node.left)
            for op, comp in zip(node.ops, node.comparators):
                right = ev(comp)
                try:
                    ok = {ast.Lt: lambda: left < right,
                          ast.LtE: lambda: left <= right,
                          ast.Gt: lambda: left > right,
                          ast.GtE: lambda: left >= right,
                          ast.Eq: lambda: left == right,
                          ast.NotEq: lambda: left != right}[type(op)]()
                except TypeError:
                    ok = False
                if not ok:
                    return False
                left = right
            return True
        if isinstance(node, ast.BoolOp):
            if isinstance(node.op, ast.And):
                out = True
                for v in node.values:
                    out = ev(v)
                    if not out:
                        return out
                return out
            for v in node.values:
                out = ev(v)
                if out:
                    return out
            return out
        if isinstance(node, ast.IfExp):
            return ev(node.body) if ev(node.test) else ev(node.orelse)
        if isinstance(node, ast.Call):
            import math
            fns = {"abs": abs, "min": min, "max": max, "round": round,
                   "floor": math.floor, "ceil": math.ceil,
                   "sqrt": math.sqrt, "log": math.log,
                   "log10": math.log10, "exp": math.exp, "pow": math.pow,
                   "sin": math.sin, "cos": math.cos, "tan": math.tan}
            return fns[node.func.id](*[ev(a) for a in node.args])
        raise ScriptException(f"unsupported node [{type(node).__name__}]")

    return ev(tree)


def _rewrite_ctx(source: str) -> str:
    """Rewrite ``ctx.a.b`` path references to ``a_b`` variables without
    touching string literals."""
    out = []
    i = 0
    n = len(source)
    while i < n:
        c = source[i]
        if c in "'\"":
            j = i + 1
            while j < n and source[j] != c:
                j += 1
            out.append(source[i:j + 1])
            i = j + 1
            continue
        m = re.match(r"ctx\.([A-Za-z_][A-Za-z0-9_.]*)", source[i:])
        if m:
            out.append(m.group(1).replace(".", "_"))
            i += m.end()
            continue
        out.append(c)
        i += 1
    return "".join(out)


# ---------------------------------------------------------------------------
# processors
# ---------------------------------------------------------------------------


class Processor:
    type_name = "?"

    def __init__(self, body: dict):
        self.tag = body.get("tag")
        self.description = body.get("description")
        self.condition = body.get("if")
        self.ignore_failure = bool(body.get("ignore_failure", False))
        self.on_failure = [build_processor(p) for p in
                           body.get("on_failure", [])]

    def should_run(self, doc: IngestDocument) -> bool:
        if self.condition is None:
            return True
        try:
            return bool(eval_ingest_expr(self.condition, doc.flat_env()))
        except ScriptException:
            return False

    def run(self, doc: IngestDocument) -> None:
        raise NotImplementedError


def _req(body: dict, key: str, type_name: str):
    if key not in body:
        raise ParsingError(f"[{key}] required property is missing "
                           f"(processor [{type_name}])")
    return body[key]


class SetProcessor(Processor):
    type_name = "set"

    def __init__(self, body):
        super().__init__(body)
        self.field = _req(body, "field", "set")
        if "value" not in body and "copy_from" not in body:
            raise ParsingError("[value] required property is missing "
                               "(processor [set])")
        self.value = body.get("value")
        self.copy_from = body.get("copy_from")
        self.override = bool(body.get("override", True))

    def run(self, doc):
        if not self.override and doc.has(self.field) and \
                doc.get(self.field) is not None:
            return
        if self.copy_from is not None:
            v = copy.deepcopy(doc.get(self.copy_from))
        elif isinstance(self.value, str) and "{{" in self.value:
            v = doc.render(self.value)
        else:
            v = copy.deepcopy(self.value)
        doc.set(doc.render(self.field) if "{{" in self.field else self.field,
                v)


class AppendProcessor(Processor):
    type_name = "append"

    def __init__(self, body):
        super().__init__(body)
        self.field = _req(body, "field", "append")
        self.value = _req(body, "value", "append")
        self.allow_duplicates = bool(body.get("allow_duplicates", True))

    def run(self, doc):
        vals = self.value if isinstance(self.value, list) else [self.value]
        vals = [doc.render(v) if isinstance(v, str) and "{{" in v else v
                for v in vals]
        if doc.has(self.field):
            cur = doc.get(self.field)
            if not isinstance(cur, list):
                cur = [cur]
        else:
            cur = []
        for v in vals:
            if self.allow_duplicates or v not in cur:
                cur.append(v)
        doc.set(self.field, cur)


class RemoveProcessor(Processor):
    type_name = "remove"

    def __init__(self, body):
        super().__init__(body)
        f = _req(body, "field", "remove")
        self.fields = f if isinstance(f, list) else [f]
        self.ignore_missing = bool(body.get("ignore_missing", False))

    def run(self, doc):
        for f in self.fields:
            if self.ignore_missing and not doc.has(f):
                continue
            doc.remove(f)


class RenameProcessor(Processor):
    type_name = "rename"

    def __init__(self, body):
        super().__init__(body)
        self.field = _req(body, "field", "rename")
        self.target = _req(body, "target_field", "rename")
        self.ignore_missing = bool(body.get("ignore_missing", False))

    def run(self, doc):
        if not doc.has(self.field):
            if self.ignore_missing:
                return
            raise ProcessorException(
                f"field [{self.field}] doesn't exist")
        if doc.has(self.target):
            raise ProcessorException(
                f"field [{self.target}] already exists")
        v = doc.get(self.field)
        doc.remove(self.field)
        doc.set(self.target, v)


_CONVERTERS: Dict[str, Callable] = {
    "integer": lambda v: int(float(v)) if isinstance(v, str) else int(v),
    "long": lambda v: int(float(v)) if isinstance(v, str) else int(v),
    "float": float,
    "double": float,
    "string": str,
    "boolean": lambda v: (v if isinstance(v, bool) else
                          {"true": True, "false": False}[str(v).lower()]),
    "auto": lambda v: _auto_convert(v),
}


def _auto_convert(v):
    if not isinstance(v, str):
        return v
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


class ConvertProcessor(Processor):
    type_name = "convert"

    def __init__(self, body):
        super().__init__(body)
        self.field = _req(body, "field", "convert")
        t = _req(body, "type", "convert")
        if t not in _CONVERTERS:
            raise ParsingError(f"type [{t}] not supported, cannot convert "
                               f"field")
        self.conv = _CONVERTERS[t]
        self.target = body.get("target_field", self.field)
        self.ignore_missing = bool(body.get("ignore_missing", False))

    def run(self, doc):
        if not doc.has(self.field):
            if self.ignore_missing:
                return
            raise ProcessorException(f"field [{self.field}] doesn't exist")
        v = doc.get(self.field)
        try:
            out = ([self.conv(x) for x in v] if isinstance(v, list)
                   else self.conv(v))
        except (ValueError, KeyError, TypeError):
            raise ProcessorException(
                f"unable to convert [{v}] to {self.conv}")
        doc.set(self.target, out)


_DATE_FORMATS = {
    "ISO8601": None,                       # datetime.fromisoformat
    "UNIX": "unix", "UNIX_MS": "unix_ms",
    "yyyy-MM-dd": "%Y-%m-%d",
    "yyyy/MM/dd": "%Y/%m/%d",
    "yyyy-MM-dd HH:mm:ss": "%Y-%m-%d %H:%M:%S",
    "dd/MMM/yyyy:HH:mm:ss Z": "%d/%b/%Y:%H:%M:%S %z",
}


class DateProcessor(Processor):
    type_name = "date"

    def __init__(self, body):
        super().__init__(body)
        self.field = _req(body, "field", "date")
        self.formats = _req(body, "formats", "date")
        self.target = body.get("target_field", "@timestamp")
        self.output_format = body.get("output_format")

    def run(self, doc):
        v = doc.get(self.field)
        dt = None
        err = None
        for fmt in self.formats:
            try:
                if fmt == "ISO8601":
                    dt = datetime.datetime.fromisoformat(
                        str(v).replace("Z", "+00:00"))
                elif fmt == "UNIX":
                    dt = datetime.datetime.fromtimestamp(
                        float(v), datetime.timezone.utc)
                elif fmt == "UNIX_MS":
                    dt = datetime.datetime.fromtimestamp(
                        float(v) / 1e3, datetime.timezone.utc)
                else:
                    strp = _DATE_FORMATS.get(fmt, fmt)
                    dt = datetime.datetime.strptime(str(v), strp)
                break
            except (ValueError, TypeError) as e:
                err = e
        if dt is None:
            raise ProcessorException(
                f"unable to parse date [{v}]: {err}")
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=datetime.timezone.utc)
        doc.set(self.target, dt.isoformat())


class ScriptProcessor(Processor):
    """Ingest scripts. The reference runs them through its sandboxed
    Painless-lite engine (``script/service.py``), which this package does
    not have yet (ROADMAP A8): a pipeline with a ``script`` processor is
    refused when it is built, naming what is missing, never skipped."""

    type_name = "script"

    def __init__(self, body):
        super().__init__(body)
        src = body.get("source") or body.get("inline")
        if src is None:
            raise ParsingError("[source] required property is missing "
                               "(processor [script])")
        raise ParsingError(
            "the [script] ingest processor is not ported to the PyTorch "
            "package yet (ROADMAP A8; reference script/service.py)")


class LowercaseProcessor(Processor):
    type_name = "lowercase"

    def __init__(self, body):
        super().__init__(body)
        self.field = _req(body, "field", self.type_name)
        self.target = body.get("target_field", self.field)
        self.ignore_missing = bool(body.get("ignore_missing", False))

    def _apply(self, v):
        return v.lower()

    def run(self, doc):
        if not doc.has(self.field):
            if self.ignore_missing:
                return
            raise ProcessorException(f"field [{self.field}] doesn't exist")
        v = doc.get(self.field)
        try:
            out = ([self._apply(x) for x in v] if isinstance(v, list)
                   else self._apply(v))
        except AttributeError:
            raise ProcessorException(
                f"field [{self.field}] of type [{type(v).__name__}] cannot "
                f"be cast to string")
        doc.set(self.target, out)


class UppercaseProcessor(LowercaseProcessor):
    type_name = "uppercase"

    def _apply(self, v):
        return v.upper()


class TrimProcessor(LowercaseProcessor):
    type_name = "trim"

    def _apply(self, v):
        return v.strip()


class SplitProcessor(Processor):
    type_name = "split"

    def __init__(self, body):
        super().__init__(body)
        self.field = _req(body, "field", "split")
        self.separator = _req(body, "separator", "split")
        self.target = body.get("target_field", self.field)
        self.preserve_trailing = bool(body.get("preserve_trailing", False))
        self.ignore_missing = bool(body.get("ignore_missing", False))

    def run(self, doc):
        if not doc.has(self.field):
            if self.ignore_missing:
                return
            raise ProcessorException(f"field [{self.field}] doesn't exist")
        v = doc.get(self.field)
        if not isinstance(v, str):
            raise ProcessorException(
                f"field [{self.field}] of type [{type(v).__name__}] cannot "
                f"be split")
        parts = re.split(self.separator, v)
        if not self.preserve_trailing:
            while parts and parts[-1] == "":
                parts.pop()
        doc.set(self.target, parts)


class JoinProcessor(Processor):
    type_name = "join"

    def __init__(self, body):
        super().__init__(body)
        self.field = _req(body, "field", "join")
        self.separator = _req(body, "separator", "join")
        self.target = body.get("target_field", self.field)

    def run(self, doc):
        v = doc.get(self.field)
        if not isinstance(v, list):
            raise ProcessorException(
                f"field [{self.field}] of type [{type(v).__name__}] cannot "
                f"be joined")
        doc.set(self.target, self.separator.join(str(x) for x in v))


class GsubProcessor(Processor):
    type_name = "gsub"

    def __init__(self, body):
        super().__init__(body)
        self.field = _req(body, "field", "gsub")
        self.pattern = re.compile(_req(body, "pattern", "gsub"))
        self.replacement = _req(body, "replacement", "gsub")
        self.target = body.get("target_field", self.field)
        self.ignore_missing = bool(body.get("ignore_missing", False))

    def run(self, doc):
        if not doc.has(self.field):
            if self.ignore_missing:
                return
            raise ProcessorException(f"field [{self.field}] doesn't exist")
        v = doc.get(self.field)
        if not isinstance(v, str):
            raise ProcessorException(
                f"field [{self.field}] of type [{type(v).__name__}] cannot "
                f"be gsub'd")
        doc.set(self.target, self.pattern.sub(self.replacement, v))


#: grok-lite pattern library — the common subset of
#: ``libs/grok/src/main/resources/patterns`` (the reference bundles ~90)
_GROK_PATTERNS = {
    "WORD": r"\w+",
    "NOTSPACE": r"\S+",
    "DATA": r".*?",
    "GREEDYDATA": r".*",
    "INT": r"[+-]?\d+",
    "NUMBER": r"[+-]?\d+(?:\.\d+)?",
    "BASE10NUM": r"[+-]?\d+(?:\.\d+)?",
    "IP": r"\d{1,3}\.\d{1,3}\.\d{1,3}\.\d{1,3}",
    "IPORHOST": r"[\w.:-]+",
    "HOSTNAME": r"[\w.-]+",
    "USER": r"[\w.-]+",
    "USERNAME": r"[\w.-]+",
    "TIMESTAMP_ISO8601":
        r"\d{4}-\d{2}-\d{2}[T ]\d{2}:\d{2}:\d{2}(?:\.\d+)?(?:Z|[+-]\d{2}:?\d{2})?",
    "HTTPDATE": r"\d{2}/\w{3}/\d{4}:\d{2}:\d{2}:\d{2} [+-]\d{4}",
    "LOGLEVEL":
        r"(?:TRACE|DEBUG|INFO|WARN|ERROR|FATAL|trace|debug|info|warn|error|fatal)",
    "UUID": r"[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-"
            r"[0-9a-fA-F]{4}-[0-9a-fA-F]{12}",
    "QS": r"\"[^\"]*\"",
}


def _grok_to_regex(pattern: str) -> re.Pattern:
    def sub(m):
        name, field, cast = m.group(1), m.group(3), m.group(5)
        base = _GROK_PATTERNS.get(name)
        if base is None:
            raise ParsingError(f"Unable to find pattern [{name}] in Grok's "
                               f"pattern dictionary")
        if field:
            safe = field.replace(".", "__DOT__").replace("@", "__AT__")
            return f"(?P<{safe}>{base})"
        return f"(?:{base})"
    rx = re.sub(r"%\{(\w+)(:([\w.@]+)(:(int|float))?)?\}", sub, pattern)
    return re.compile(rx)


class GrokProcessor(Processor):
    type_name = "grok"

    def __init__(self, body):
        super().__init__(body)
        self.field = _req(body, "field", "grok")
        pats = _req(body, "patterns", "grok")
        self.casts: Dict[str, str] = {}
        for p in pats:
            for m in re.finditer(r"%\{(\w+):([\w.@]+):(int|float)\}", p):
                self.casts[m.group(2)] = m.group(3)
        self.patterns = [_grok_to_regex(p) for p in pats]
        self.ignore_missing = bool(body.get("ignore_missing", False))

    def run(self, doc):
        if not doc.has(self.field):
            if self.ignore_missing:
                return
            raise ProcessorException(f"field [{self.field}] doesn't exist")
        v = str(doc.get(self.field))
        for rx in self.patterns:
            m = rx.search(v)
            if m is None:
                continue
            for k, val in m.groupdict().items():
                if val is None:
                    continue
                field = k.replace("__DOT__", ".").replace("__AT__", "@")
                cast = self.casts.get(field)
                if cast == "int":
                    val = int(val)
                elif cast == "float":
                    val = float(val)
                doc.set(field, val)
            return
        raise ProcessorException(
            f"Provided Grok expressions do not match field value: [{v}]")


class DissectProcessor(Processor):
    type_name = "dissect"

    def __init__(self, body):
        super().__init__(body)
        self.field = _req(body, "field", "dissect")
        self.pattern = _req(body, "pattern", "dissect")
        self.append_separator = body.get("append_separator", "")
        parts = re.split(r"%\{([^}]*)\}", self.pattern)
        # parts alternate literal, key, literal, key, ... starting literal
        self.literals = parts[::2]
        self.keys = parts[1::2]

    def run(self, doc):
        v = str(doc.get(self.field))
        pos = 0
        if not v.startswith(self.literals[0]):
            raise ProcessorException(
                f"Unable to find match for dissect pattern "
                f"[{self.pattern}] against source [{v}]")
        pos = len(self.literals[0])
        out: Dict[str, str] = {}
        for key, lit in zip(self.keys, self.literals[1:]):
            if lit == "":
                val = v[pos:]
                pos = len(v)
            else:
                end = v.find(lit, pos)
                if end < 0:
                    raise ProcessorException(
                        f"Unable to find match for dissect pattern "
                        f"[{self.pattern}] against source [{v}]")
                val = v[pos:end]
                pos = end + len(lit)
            if key.startswith("+"):
                k = key[1:]
                out[k] = out.get(k, "") + self.append_separator + val \
                    if k in out else val
            elif key and not key.startswith("?"):
                out[key] = val
        for k, val in out.items():
            doc.set(k, val)


class JsonProcessor(Processor):
    type_name = "json"

    def __init__(self, body):
        super().__init__(body)
        self.field = _req(body, "field", "json")
        self.target = body.get("target_field")
        self.add_to_root = bool(body.get("add_to_root", False))

    def run(self, doc):
        v = doc.get(self.field)
        try:
            parsed = json.loads(v)
        except (json.JSONDecodeError, TypeError) as e:
            raise ProcessorException(f"unable to parse JSON [{v}]: {e}")
        if self.add_to_root:
            if not isinstance(parsed, dict):
                raise ProcessorException(
                    "cannot add non-object JSON to document root")
            doc.source.update(parsed)
        else:
            doc.set(self.target or self.field, parsed)


class KvProcessor(Processor):
    type_name = "kv"

    def __init__(self, body):
        super().__init__(body)
        self.field = _req(body, "field", "kv")
        self.field_split = _req(body, "field_split", "kv")
        self.value_split = _req(body, "value_split", "kv")
        self.target = body.get("target_field")
        self.include_keys = body.get("include_keys")
        self.exclude_keys = set(body.get("exclude_keys", []))

    def run(self, doc):
        v = str(doc.get(self.field))
        for pair in re.split(self.field_split, v):
            if not pair:
                continue
            kv = re.split(self.value_split, pair, maxsplit=1)
            if len(kv) != 2:
                continue
            k, val = kv
            if self.include_keys is not None and k not in self.include_keys:
                continue
            if k in self.exclude_keys:
                continue
            doc.set(f"{self.target}.{k}" if self.target else k, val)


class FailProcessor(Processor):
    type_name = "fail"

    def __init__(self, body):
        super().__init__(body)
        self.message = _req(body, "message", "fail")

    def run(self, doc):
        raise ProcessorException(doc.render(self.message))


class DropProcessor(Processor):
    type_name = "drop"

    def run(self, doc):
        raise DropDocument()


class PipelineProcessor(Processor):
    type_name = "pipeline"

    def __init__(self, body):
        super().__init__(body)
        self.pipeline_name = _req(body, "name", "pipeline")
        self.ignore_missing_pipeline = bool(
            body.get("ignore_missing_pipeline", False))
        self._service: Optional["IngestService"] = None   # injected

    def run(self, doc):
        pipeline = self._service.pipelines.get(self.pipeline_name) \
            if self._service else None
        if pipeline is None:
            if self.ignore_missing_pipeline:
                return
            raise ProcessorException(
                f"Pipeline processor configured for non-existent pipeline "
                f"[{self.pipeline_name}]")
        if self.pipeline_name in doc.executed_pipelines:
            raise ProcessorException(
                f"Cycle detected for pipeline: {self.pipeline_name}")
        if pipeline.execute(doc) is None:
            # the inner pipeline dropped the document — propagate so the
            # outer pipeline discards it too, not just the inner scope
            raise DropDocument()


class UrlDecodeProcessor(LowercaseProcessor):
    type_name = "urldecode"

    def _apply(self, v):
        from urllib.parse import unquote
        return unquote(v)


class HtmlStripProcessor(LowercaseProcessor):
    type_name = "html_strip"

    def _apply(self, v):
        return re.sub(r"<[^>]*>", "", v)


class BytesProcessor(Processor):
    type_name = "bytes"

    _UNITS = {"b": 1, "kb": 1 << 10, "mb": 1 << 20, "gb": 1 << 30,
              "tb": 1 << 40, "pb": 1 << 50}

    def __init__(self, body):
        super().__init__(body)
        self.field = _req(body, "field", "bytes")
        self.target = body.get("target_field", self.field)

    def run(self, doc):
        v = str(doc.get(self.field)).strip().lower()
        m = re.fullmatch(r"([\d.]+)\s*(b|kb|mb|gb|tb|pb)?", v)
        if m is None:
            raise ProcessorException(
                f"failed to parse setting [{self.field}] with value [{v}] "
                f"as a size in bytes")
        doc.set(self.target,
                int(float(m.group(1)) * self._UNITS[m.group(2) or "b"]))


_PROCESSOR_TYPES: Dict[str, type] = {}


def register_processor(cls: type) -> None:
    """Plugin hook: the reference's ``IngestPlugin.getProcessors`` SPI."""
    _PROCESSOR_TYPES[cls.type_name] = cls


for _cls in (SetProcessor, AppendProcessor, RemoveProcessor, RenameProcessor,
             ConvertProcessor, DateProcessor, ScriptProcessor,
             LowercaseProcessor, UppercaseProcessor, TrimProcessor,
             SplitProcessor, JoinProcessor, GsubProcessor, GrokProcessor,
             DissectProcessor, JsonProcessor, KvProcessor, FailProcessor,
             DropProcessor, PipelineProcessor, UrlDecodeProcessor,
             HtmlStripProcessor, BytesProcessor):
    register_processor(_cls)


def build_processor(spec: dict) -> Processor:
    if not isinstance(spec, dict) or len(spec) != 1:
        raise ParsingError("processor must be an object with exactly one "
                           "type key")
    (type_name, body), = spec.items()
    cls = _PROCESSOR_TYPES.get(type_name)
    if cls is None:
        raise ParsingError(f"No processor type exists with name "
                           f"[{type_name}]")
    if not isinstance(body, dict):
        raise ParsingError(f"[{type_name}] processor config must be an "
                           f"object")
    return cls(body)


# ---------------------------------------------------------------------------
# pipeline + service
# ---------------------------------------------------------------------------


class Pipeline:
    def __init__(self, pipeline_id: str, config: dict):
        self.id = pipeline_id
        self.description = config.get("description")
        self.version = config.get("version")
        self.meta = config.get("_meta")
        if "processors" not in config:
            raise ParsingError("[processors] required property is missing")
        unknown = set(config) - {"description", "version", "_meta",
                                 "processors", "on_failure"}
        if unknown:
            # reference: Pipeline.create rejects leftover top-level keys
            # with an ElasticsearchParseException
            from ..common.errors import ElasticsearchParseError
            raise ElasticsearchParseError(
                f"pipeline [{pipeline_id}] doesn't support one or more "
                f"provided configuration parameters "
                f"{sorted(unknown)}")
        self.processors = [build_processor(p) for p in config["processors"]]
        self.on_failure = [build_processor(p) for p in
                           config.get("on_failure", [])]
        self.config = config

    #: _run_one outcomes
    CONTINUE, DROPPED, HANDLED_STOP = 0, 1, 2

    def execute(self, doc: IngestDocument) -> Optional[IngestDocument]:
        """Run the document through; returns None when dropped."""
        doc.executed_pipelines.append(self.id)
        try:
            for proc in self.processors:
                st = self._run_one(proc, doc)
                if st == self.DROPPED:
                    return None
                if st == self.HANDLED_STOP:
                    # the PIPELINE-level on_failure chain replaces the rest
                    # of the pipeline (CompoundProcessor.java: the failure
                    # handler is the tail continuation, not a detour)
                    break
        finally:
            doc.executed_pipelines.pop()
        return doc

    def _run_one(self, proc: Processor, doc: IngestDocument) -> int:
        if not proc.should_run(doc):
            return self.CONTINUE
        try:
            proc.run(doc)
        except DropDocument:
            return self.DROPPED
        except Exception as e:
            if proc.ignore_failure:
                return self.CONTINUE
            chain = proc.on_failure or self.on_failure
            if not chain:
                raise
            doc.ingest_meta["on_failure_message"] = str(e)
            doc.ingest_meta["on_failure_processor_type"] = proc.type_name
            doc.ingest_meta["on_failure_processor_tag"] = proc.tag
            for fp in chain:
                st = self._run_one(fp, doc)
                if st != self.CONTINUE:
                    return st
            if not proc.on_failure:      # pipeline-level chain consumed it
                return self.HANDLED_STOP
        return self.CONTINUE


class IngestService:
    """Pipeline registry + bulk execution hook
    (``ingest/IngestService.java:437``)."""

    def __init__(self):
        self.pipelines: Dict[str, Pipeline] = {}
        self.stats = {"count": 0, "failed": 0}

    def put_pipeline(self, pipeline_id: str, config: dict) -> None:
        p = Pipeline(pipeline_id, config)
        self._inject(p)
        self.pipelines[pipeline_id] = p

    def _inject(self, pipeline: Pipeline) -> None:
        def walk(procs):
            for pr in procs:
                if isinstance(pr, PipelineProcessor):
                    pr._service = self
                walk(pr.on_failure)
        walk(pipeline.processors)
        walk(pipeline.on_failure)

    def get_pipeline(self, pipeline_id: str) -> Pipeline:
        p = self.pipelines.get(pipeline_id)
        if p is None:
            raise ResourceNotFoundError(
                f"pipeline [{pipeline_id}] is missing")
        return p

    def delete_pipeline(self, pipeline_id: str) -> None:
        if pipeline_id not in self.pipelines:
            raise ResourceNotFoundError(
                f"pipeline [{pipeline_id}] is missing")
        del self.pipelines[pipeline_id]

    def run(self, pipeline_id: str, index: str, doc_id: Optional[str],
            source: dict,
            routing: Optional[str] = None) -> Optional[IngestDocument]:
        """Execute a pipeline over one document; returns the transformed
        :class:`IngestDocument` (callers must honor ``doc.meta`` —
        pipelines may rewrite ``_index``/``_id``/``_routing``, the
        reference's reroute-on-ingest), or None when dropped."""
        p0 = self.pipelines.get(pipeline_id)
        if p0 is None:
            # a missing pipeline on a WRITE is a request error, not a 404
            # (TransportBulkAction validates before indexing)
            raise IllegalArgumentError(
                f"pipeline with id [{pipeline_id}] does not exist")
        pipeline = p0
        doc = IngestDocument(index, doc_id, source, routing)
        self.stats["count"] += 1
        try:
            out = pipeline.execute(doc)
        except ElasticsearchError:
            self.stats["failed"] += 1
            raise
        except Exception as e:   # processor bug → ES-shaped 400, not a 500
            self.stats["failed"] += 1
            raise ProcessorException(
                f"pipeline [{pipeline_id}] failed: {e}") from e
        return None if out is None else doc

    def simulate(self, pipeline: Pipeline, docs: List[dict],
                 verbose: bool = False) -> dict:
        results = []
        for d in docs:
            src = copy.deepcopy(d.get("_source", {}))
            doc = IngestDocument(d.get("_index", "_index"),
                                 d.get("_id", "_id"), src)
            if verbose:
                steps = []
                for proc in pipeline.processors:
                    if not proc.should_run(doc):
                        continue
                    try:
                        proc.run(doc)
                        steps.append({"processor_type": proc.type_name,
                                      "status": "success",
                                      "doc": _sim_doc(doc)})
                    except DropDocument:
                        steps.append({"processor_type": proc.type_name,
                                      "status": "dropped"})
                        break
                    except Exception as e:
                        step = {"processor_type": proc.type_name,
                                "status": "error",
                                "error": {"reason": str(e)}}
                        if proc.ignore_failure:
                            step["status"] = "error_ignored"
                            steps.append(step)
                            continue
                        chain = proc.on_failure or pipeline.on_failure
                        if not chain:
                            steps.append(step)
                            break
                        # run the failure chain so verbose's final doc
                        # matches real execution (CompoundProcessor tail)
                        doc.ingest_meta["on_failure_message"] = str(e)
                        doc.ingest_meta["on_failure_processor_type"] = \
                            proc.type_name
                        doc.ingest_meta["on_failure_processor_tag"] = \
                            proc.tag
                        dropped = False
                        for fp in chain:
                            if pipeline._run_one(fp, doc) == \
                                    Pipeline.DROPPED:
                                dropped = True
                                break
                        step["status"] = "error_handled"
                        step["doc"] = _sim_doc(doc)
                        steps.append(step)
                        if dropped or not proc.on_failure:
                            break
                results.append({"processor_results": steps})
            else:
                try:
                    out = pipeline.execute(doc)
                    results.append({"doc": _sim_doc(doc)} if out is not None
                                   else {"doc": None})
                except Exception as e:
                    results.append({"error": {"reason": str(e),
                                              "type": "exception"}})
        return {"docs": results}


def _sim_doc(doc: IngestDocument) -> dict:
    return {"_index": doc.meta["_index"], "_id": doc.meta["_id"],
            "_source": doc.source,
            "_ingest": {"timestamp": doc.ingest_meta["timestamp"]}}
