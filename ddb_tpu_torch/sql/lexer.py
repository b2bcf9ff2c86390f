"""SQL tokenizer.

Hand-rolled (the reference vendors a flex-generated Postgres scanner in
third_party/libpg_query; a regex scanner is the right weight here — parsing
is microseconds against seconds of kernel time).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List


@dataclass
class Token:
    kind: str       # KW | IDENT | NUM | STR | OP | EOF
    value: str
    pos: int
    orig: str = None   # original-case spelling (IDENT only; quoted
    #                    identifiers keep their case in value itself)


KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "and", "or", "not", "in", "is", "null", "like", "ilike",
    "between", "case", "when", "then", "else", "end", "cast", "distinct",
    "join", "inner", "left", "right", "full", "outer", "cross", "on",
    "using", "union", "all", "exists", "any", "asc", "desc", "nulls",
    "first", "last", "with", "create", "view", "table", "drop", "replace",
    "if", "interval", "date", "time", "timestamp", "true", "false",
    "except", "intersect", "substring", "for", "extract", "values",
    "insert", "into", "over", "partition", "rows", "range", "preceding",
    "following", "unbounded", "current", "row", "update", "delete",
    "set", "primary", "key", "default", "recursive", "asof",
    "grouping", "rollup", "cube", "sample", "tablesample", "repeatable",
    "percent", "semi", "anti", "positional", "lateral",
}

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|--[^\n]*|/\*.*?\*/)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<dstr>\$(?P<dtag>[A-Za-z_]*)\$.*?\$(?P=dtag)\$)
  | (?P<str>'(?:[^']|'')*')
  | (?P<qid>"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_\U00000080-\U0010ffff][\w$\U00000080-\U0010ffff]*)
  | (?P<param>\?|\$\d+)
  | (?P<op>->>|->|<<|>>|<=|>=|<>|!=|==|::|:=|=>|\|\||//|\*\*|[-+*/%(),.<>=;:!\[\]{}&|~^])
""", re.X | re.S)


class SQLSyntaxError(Exception):
    pass


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    pos = 0
    n = len(sql)
    while pos < n:
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SQLSyntaxError(
                f"unexpected character {sql[pos]!r} at position {pos}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        text = m.group()
        if m.lastgroup == "num":
            out.append(Token("NUM", text, m.start()))
        elif m.lastgroup == "str":
            out.append(Token("STR", text[1:-1].replace("''", "'"),
                             m.start()))
        elif m.lastgroup in ("dstr", "dtag"):
            # dollar-quoted string: $$text$$ / $tag$text$tag$
            tag = m.group("dtag")
            out.append(Token("STR", text[len(tag) + 2:
                                         -(len(tag) + 2)], m.start()))
        elif m.lastgroup == "qid":
            out.append(Token("IDENT", text[1:-1].replace('""', '"'),
                             m.start()))
        elif m.lastgroup == "param":
            out.append(Token("PARAM", text, m.start()))
        elif m.lastgroup == "ident":
            low = text.lower()
            if low in KEYWORDS:
                out.append(Token("KW", low, m.start()))
            else:
                out.append(Token("IDENT", low, m.start(), text))
        else:
            # => is the named-argument arrow, an alias of :=
            # (reference: named parameters accept both spellings)
            out.append(Token("OP", ":=" if text == "=>" else text,
                             m.start()))
    out.append(Token("EOF", "", n))
    return out
