"""Restricted arithmetic expression evaluation.

The reference embeds full scripting languages (Painless —
``modules/lang-painless``, 41k LoC compiling to JVM bytecode; and
``lang-expression`` for numeric-only scripts). The TPU-native equivalent
keeps scripts *compilable*: a small arithmetic grammar parsed with Python's
``ast`` in eval mode and walked against a whitelist — no attribute access,
no calls except a math whitelist, no subscripts beyond variables — so the
same expression tree evaluates over whole columns, on the host (numpy) or
on the card (torch tensors).
"""

from __future__ import annotations

import ast
import math
from typing import Any, Dict

import numpy as np
import torch

from ..common.errors import ElasticsearchError


class ScriptException(ElasticsearchError):
    status = 400
    error_type = "script_exception"


_ALLOWED_FUNCS = {
    "abs": abs, "min": min, "max": max, "round": round,
    "floor": math.floor, "ceil": math.ceil, "sqrt": math.sqrt,
    "log": math.log, "log10": math.log10, "exp": math.exp,
    "pow": math.pow, "sin": math.sin, "cos": math.cos, "tan": math.tan,
}

_ALLOWED_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant, ast.Name,
    ast.Call, ast.Load, ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Mod,
    ast.Pow, ast.FloorDiv, ast.USub, ast.UAdd, ast.Compare, ast.Lt,
    ast.LtE, ast.Gt, ast.GtE, ast.Eq, ast.NotEq, ast.IfExp, ast.BoolOp,
    ast.And, ast.Or, ast.Not,
)


def compile_expression(source: str):
    """Parse + validate; returns the ast, raising ScriptException on any
    disallowed construct."""
    # Painless-style param refs: params.x -> variable x
    cleaned = source.replace("params.", "")
    try:
        tree = ast.parse(cleaned, mode="eval")
    except SyntaxError as e:
        raise ScriptException(f"compile error in script [{source}]: {e}")
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ScriptException(
                f"disallowed construct [{type(node).__name__}] in script "
                f"[{source}]")
        if isinstance(node, ast.Call):
            if not isinstance(node.func, ast.Name) or \
                    node.func.id not in _ALLOWED_FUNCS:
                raise ScriptException(
                    f"disallowed function call in script [{source}]")
    return tree


_VEC_NAMES = {
    "abs": "abs", "min": "minimum", "max": "maximum", "round": "round",
    "floor": "floor", "ceil": "ceil", "sqrt": "sqrt", "log": "log",
    "log10": "log10", "exp": "exp", "pow": "pow", "sin": "sin",
    "cos": "cos", "tan": "tan",
}


def _vec_ops(params: Dict[str, Any]):
    """(functions, where, not, and, or) over the arrays in ``params``:
    torch on the device of the first tensor among them, else numpy."""
    like = next((v for v in params.values()
                 if isinstance(v, torch.Tensor)), None)
    if like is None:
        funcs = {k: getattr(np, "power" if v == "pow" else v)
                 for k, v in _VEC_NAMES.items()}
        return (funcs, np.where, np.logical_not, np.logical_and,
                np.logical_or)

    def lift(fn):
        def call(*args):
            return fn(*(a if isinstance(a, torch.Tensor) else
                        torch.as_tensor(a, device=like.device)
                        for a in args))
        return call

    funcs = {k: lift(getattr(torch, v)) for k, v in _VEC_NAMES.items()}
    return (funcs, lift(torch.where), lift(torch.logical_not),
            lift(torch.logical_and), lift(torch.logical_or))


def evaluate_expression_vec(source: str, params: Dict[str, Any]):
    """Evaluate the same restricted grammar over *arrays*: operators
    broadcast elementwise, ``a if c else b`` lowers to ``where``,
    comparisons return boolean arrays. Where any parameter is a torch
    tensor the whole expression runs in torch on that tensor's device
    (the reference compiles Painless to bytecode per doc; here one pass
    of elementwise kernels over the segment), else in numpy on the host.
    Functions keep their inputs' dtype (numpy's float64 columns stay
    float64)."""
    tree = compile_expression(source)
    vec_funcs, where, logical_not, logical_and, logical_or = \
        _vec_ops(params)

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant):
            if not isinstance(node.value, (int, float, bool)):
                raise ScriptException(f"non-numeric constant [{node.value}]")
            return node.value
        if isinstance(node, ast.Name):
            if node.id in params:
                return params[node.id]
            raise ScriptException(f"unknown variable [{node.id}]")
        if isinstance(node, ast.BinOp):
            a, b = ev(node.left), ev(node.right)
            op = type(node.op)
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
        if isinstance(node, ast.UnaryOp):
            v = ev(node.operand)
            if isinstance(node.op, ast.USub):
                return -v
            if isinstance(node.op, ast.UAdd):
                return +v
            if isinstance(node.op, ast.Not):
                return logical_not(v)
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1:
                raise ScriptException("chained comparisons not supported "
                                      "in vector scripts")
            left, right = ev(node.left), ev(node.comparators[0])
            op = type(node.ops[0])
            return {ast.Lt: left < right, ast.LtE: left <= right,
                    ast.Gt: left > right, ast.GtE: left >= right,
                    ast.Eq: left == right, ast.NotEq: left != right}[op]
        if isinstance(node, ast.BoolOp):
            vals = [ev(v) for v in node.values]
            out = vals[0]
            for v in vals[1:]:
                out = (logical_and(out, v)
                       if isinstance(node.op, ast.And)
                       else logical_or(out, v))
            return out
        if isinstance(node, ast.IfExp):
            return where(ev(node.test), ev(node.body), ev(node.orelse))
        if isinstance(node, ast.Call):
            fn = vec_funcs[node.func.id]
            return fn(*[ev(a) for a in node.args])
        raise ScriptException(
            f"unsupported node [{type(node).__name__}]")  # pragma: no cover

    return ev(tree)


def evaluate_expression(source: str, params: Dict[str, float],
                        allow_strings: bool = False) -> float:
    tree = compile_expression(source)

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant):
            ok_types = (int, float, bool, str) if allow_strings \
                else (int, float, bool)
            if not isinstance(node.value, ok_types):
                raise ScriptException(f"non-numeric constant [{node.value}]")
            return node.value
        if isinstance(node, ast.Name):
            if node.id in params:
                return params[node.id]
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
                ok = {ast.Lt: left < right, ast.LtE: left <= right,
                      ast.Gt: left > right, ast.GtE: left >= right,
                      ast.Eq: left == right, ast.NotEq: left != right}[type(op)]
                if not ok:
                    return False
                left = right
            return True
        if isinstance(node, ast.BoolOp):
            vals = [ev(v) for v in node.values]
            return all(vals) if isinstance(node.op, ast.And) else any(vals)
        if isinstance(node, ast.IfExp):
            return ev(node.body) if ev(node.test) else ev(node.orelse)
        if isinstance(node, ast.Call):
            fn = _ALLOWED_FUNCS[node.func.id]
            return fn(*[ev(a) for a in node.args])
        raise ScriptException(
            f"unsupported node [{type(node).__name__}]")  # pragma: no cover

    return ev(tree)


# ---------------------------------------------------------------------------
# per-doc scripts: doc['field'].value access (script_fields, script sort,
# scripted_metric map scripts — reference: Painless doc-values API)
# ---------------------------------------------------------------------------

import re as _re

_DOC_RE = _re.compile(r"doc\[['\"]([^'\"]+)['\"]\]\.(value|size\(\))")


def compile_doc_expression(source: str):
    """Rewrite ``doc['f'].value`` / ``doc['f'].size()`` into synthetic
    variables; returns (cleaned_source, ordered field list). The cleaned
    source must pass :func:`compile_expression`."""
    fields: list = []

    def sub(m):
        f, attr = m.group(1), m.group(2)
        if f not in fields:
            fields.append(f)
        i = fields.index(f)
        return f"__doc{i}" if attr == "value" else f"__size{i}"

    cleaned = _DOC_RE.sub(sub, source)
    compile_expression(cleaned)
    return cleaned, fields


def evaluate_doc_expression(cleaned: str, fields, params: Dict[str, Any],
                            field_values: Dict[str, Any]):
    """Evaluate a compiled doc expression for ONE document.

    ``field_values``: field -> first value (None when absent; strings
    allowed — equality/comparison work, arithmetic on strings raises a
    ScriptException like Painless's class-cast errors)."""
    env = dict(params)
    for i, f in enumerate(fields):
        v = field_values.get(f)
        env[f"__doc{i}"] = 0 if v is None else v
        env[f"__size{i}"] = 0 if v is None else 1
    try:
        return evaluate_expression(cleaned, env, allow_strings=True)
    except TypeError as e:
        raise ScriptException(f"runtime error in script: {e}")
