"""SQL autocomplete: keyword/table/column/function suggestions.

Analog of the reference's autocomplete extension
(reference: extension/autocomplete/autocomplete_extension.cpp —
sql_auto_complete() table function + shell tab completion driven by the
tokenizer state).  Suggestion ranking mirrors the reference: exact-prefix
keywords first, then catalog objects, then functions.
"""

from __future__ import annotations

from typing import List, Tuple

_KEYWORDS = [
    "SELECT", "FROM", "WHERE", "GROUP BY", "ORDER BY", "HAVING", "LIMIT",
    "OFFSET", "JOIN", "LEFT JOIN", "RIGHT JOIN", "FULL JOIN", "CROSS JOIN",
    "INNER JOIN", "ASOF JOIN", "LATERAL", "ON", "USING", "AS", "AND",
    "OR", "NOT", "IN", "EXISTS", "BETWEEN", "LIKE", "ILIKE", "IS NULL",
    "IS NOT NULL", "CASE", "WHEN", "THEN", "ELSE", "END", "CAST",
    "DISTINCT", "UNION", "UNION ALL", "EXCEPT", "INTERSECT", "WITH",
    "RECURSIVE", "VALUES", "INSERT INTO", "UPDATE", "DELETE FROM", "SET",
    "CREATE TABLE", "CREATE VIEW", "CREATE OR REPLACE", "CREATE SECRET",
    "DROP TABLE", "DROP VIEW", "ALTER TABLE", "ATTACH", "DETACH",
    "EXPLAIN", "ANALYZE", "PRAGMA", "PREPARE", "EXECUTE", "DEALLOCATE",
    "BEGIN", "COMMIT", "ROLLBACK", "CHECKPOINT", "COPY", "PIVOT",
    "UNPIVOT", "SAMPLE", "TABLESAMPLE", "WINDOW", "PARTITION BY",
    "ROWS BETWEEN", "RANGE BETWEEN", "PRIMARY KEY", "UNIQUE", "NOT NULL",
    "DEFAULT", "GROUPING SETS", "ROLLUP", "CUBE", "DESCRIBE", "SUMMARIZE",
]


def suggestions(con, prefix: str) -> List[Tuple[str, int]]:
    """Ranked (suggestion, score) list for the word being typed.
    Lower score = better (reference sorts by score then text)."""
    from .sql.binder import Binder  # noqa: F401  (engine import path)
    word = prefix.split()[-1] if prefix.strip() else ""
    wl = word.lower()
    out: List[Tuple[str, int]] = []
    seen = set()

    def add(text: str, score: int):
        if text.lower().startswith(wl) and text not in seen:
            seen.add(text)
            out.append((text, score))

    for kw in _KEYWORDS:
        add(kw, 0)
    if con is not None:
        for t in sorted(con.catalog.tables):
            add(t, 1)
        for v in sorted(getattr(con.catalog, "views", {})):
            add(v, 1)
        for t in con.catalog.tables.values():
            for c in t.columns:
                add(c.name, 2)
        from .table_functions import TABLE_FUNCTIONS
        for fn in sorted(TABLE_FUNCTIONS):
            add(fn + "(", 3)
    for fn in ("count(", "sum(", "avg(", "min(", "max(", "coalesce(",
               "abs(", "round(", "floor(", "ceil(", "length(", "lower(",
               "upper(", "substring(", "concat(", "row_number() OVER (",
               "rank() OVER (", "struct_pack(", "map_keys(", "unnest("):
        add(fn, 3)
    out.sort(key=lambda x: (x[1], x[0]))
    return out


def make_readline_completer(get_con):
    """readline completer closure for the shell (`python -m ddb_tpu`)."""
    state_matches: List[str] = []

    def complete(text, state):
        nonlocal state_matches
        if state == 0:
            try:
                state_matches = [s for s, _ in
                                 suggestions(get_con(), text)][:40]
            except Exception:
                state_matches = []
        return state_matches[state] if state < len(state_matches) else None

    return complete
