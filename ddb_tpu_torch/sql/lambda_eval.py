"""Host-side evaluator for lambda bodies in list functions.

List payloads live host-side by design (no var-len device
representation), so list_transform/list_filter/list_reduce evaluate
their lambdas per element on the host, inside the same pure_callback
seam the other runtime-list functions use (reference:
src/core_functions/lambda_functions.cpp executes lambdas through the
vectorized expression executor; ours interprets the AST over python
scalars — element counts are small by construction).
"""

from __future__ import annotations

import math

from . import ast as A


class LambdaError(Exception):
    pass


_BIN = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b if b != 0 else None,
    "%": lambda a, b: a - int(a / b) * b if b != 0 else None,
    "//": lambda a, b: int(a / b) if b != 0 else None,
    "==": lambda a, b: a == b,
    "=": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<>": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}

_FUNCS = {
    "abs": abs,
    "round": lambda x, d=0: round(x, int(d)),
    "floor": math.floor,
    "ceil": math.ceil,
    "ceiling": math.ceil,
    "sqrt": math.sqrt,
    "ln": math.log,
    "log": math.log10,
    "exp": math.exp,
    "power": lambda a, b: a ** b,
    "pow": lambda a, b: a ** b,
    "upper": lambda s: str(s).upper(),
    "ucase": lambda s: str(s).upper(),
    "lower": lambda s: str(s).lower(),
    "lcase": lambda s: str(s).lower(),
    "length": lambda s: len(s),
    "len": lambda s: len(s),
    "trim": lambda s: str(s).strip(),
    "ltrim": lambda s: str(s).lstrip(),
    "rtrim": lambda s: str(s).rstrip(),
    "reverse": lambda s: str(s)[::-1],
    "contains": lambda s, t: str(t) in str(s)
    if not isinstance(s, list) else t in s,
    "starts_with": lambda s, t: str(s).startswith(str(t)),
    "prefix": lambda s, t: str(s).startswith(str(t)),
    "ends_with": lambda s, t: str(s).endswith(str(t)),
    "suffix": lambda s, t: str(s).endswith(str(t)),
    "substring": lambda s, a, b=None: str(s)[int(a) - 1:]
    if b is None else str(s)[int(a) - 1:int(a) - 1 + int(b)],
    "substr": lambda s, a, b=None: str(s)[int(a) - 1:]
    if b is None else str(s)[int(a) - 1:int(a) - 1 + int(b)],
    "concat": lambda *xs: "".join(str(x) for x in xs
                                  if x is not None),
    "greatest": lambda *xs: max(xs),
    "least": lambda *xs: min(xs),
    "coalesce": lambda *xs: next((x for x in xs if x is not None),
                                 None),
    "nullif": lambda a, b: None if a == b else a,
    "list_contains": lambda l, v: v in l if l is not None else None,
    "even": lambda x: math.ceil(x / 2) * 2,
}


def evaluate(body, env: dict):
    """Evaluate a lambda body AST over `env` (param -> python value).
    NULL propagates like SQL through arithmetic/comparisons."""
    if isinstance(body, A.ELit):
        return body.value
    if isinstance(body, A.EIdent):
        key = body.parts[-1].lower()
        if key in env:
            return env[key]
        raise LambdaError(
            f"lambda body references unknown name {key!r} "
            "(outer-column captures are not supported)")
    if isinstance(body, A.EBinary):
        op = body.op
        if op in ("and", "or"):
            l = evaluate(body.left, env)
            r = evaluate(body.right, env)
            if op == "and":
                if l is False or r is False:
                    return False
                return None if (l is None or r is None) else (l and r)
            if l is True or r is True:
                return True
            return None if (l is None or r is None) else (l or r)
        if op == "||":
            l = evaluate(body.left, env)
            r = evaluate(body.right, env)
            if l is None or r is None:
                return None
            if isinstance(l, list) or isinstance(r, list):
                return list(l) + list(r)
            return str(l) + str(r)
        f = _BIN.get(op)
        if f is None:
            raise LambdaError(f"operator {op} unsupported in lambda")
        l = evaluate(body.left, env)
        r = evaluate(body.right, env)
        if l is None or r is None:
            return None
        return f(l, r)
    if isinstance(body, A.EUnary):
        v = evaluate(body.child, env)
        if v is None:
            return None
        return -v if body.op == "-" else (not v)
    if isinstance(body, A.EFunc):
        f = _FUNCS.get(body.name)
        if f is None:
            raise LambdaError(
                f"function {body.name} unsupported in lambda")
        args = [evaluate(a2, env) for a2 in body.args]
        if body.name not in ("coalesce", "concat") \
                and any(a2 is None for a2 in args):
            return None
        return f(*args)
    if isinstance(body, A.ECase):
        if body.operand is not None:
            ov = evaluate(body.operand, env)
            for w, v in body.whens:
                if evaluate(w, env) == ov:
                    return evaluate(v, env)
        else:
            for w, v in body.whens:
                if evaluate(w, env) is True:
                    return evaluate(v, env)
        return evaluate(body.else_, env) if body.else_ is not None \
            else None
    if isinstance(body, A.EIsNull):
        v = evaluate(body.child, env)
        return (v is not None) if body.negated else (v is None)
    if isinstance(body, A.EBetween):
        v = evaluate(body.child, env)
        lo = evaluate(body.lo, env)
        hi = evaluate(body.hi, env)
        if v is None or lo is None or hi is None:
            return None
        r = lo <= v <= hi
        return (not r) if body.negated else r
    if isinstance(body, A.EIn) and body.items is not None:
        v = evaluate(body.child, env)
        vals = [evaluate(x, env) for x in body.items]
        r = v in vals
        return (not r) if body.negated else r
    if isinstance(body, A.ECast):
        v = evaluate(body.child, env)
        if v is None:
            return None
        tn = body.typename.lower()
        if tn in ("int", "integer", "bigint", "smallint", "tinyint"):
            return int(v)
        if tn in ("double", "float", "real", "float8"):
            return float(v)
        if tn in ("varchar", "text", "string"):
            return str(v)
        if tn in ("bool", "boolean"):
            return bool(v)
        raise LambdaError(f"cast to {tn} unsupported in lambda")
    if isinstance(body, A.EList):
        return [evaluate(x, env) for x in body.items]
    if isinstance(body, A.ELambda):
        raise LambdaError("nested lambdas are not supported")
    raise LambdaError(
        f"{type(body).__name__} unsupported in lambda body")
