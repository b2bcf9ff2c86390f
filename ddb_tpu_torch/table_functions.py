"""Built-in table functions: introspection + generators.

Analog of the reference's system table functions
(reference: src/function/table/system/* — duckdb_tables, duckdb_columns,
duckdb_settings, ... — and src/function/table/range.cpp).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from . import types as T
from .storage.strings import StringDictionary
from .storage.table import TableColumn, TableData


def _strcol(name, values) -> TableColumn:
    sd, codes, nulls = StringDictionary.encode([str(v) for v in values])
    return TableColumn(name, T.VARCHAR, codes, None, sd)


def _intcol(name, values) -> TableColumn:
    return TableColumn(name, T.BIGINT, np.asarray(values, dtype=np.int64))


def fn_duckdb_tables(ctx, args) -> TableData:
    names, ncols, nrows = [], [], []
    for name, td in sorted(ctx.catalog.tables.items()):
        names.append(name)
        ncols.append(len(td.columns))
        nrows.append(td.num_rows)
    return TableData("duckdb_tables", [
        _strcol("database_name", ["memory"] * len(names)),
        _strcol("schema_name", ["main"] * len(names)),
        _strcol("table_name", names),
        _strcol("comment", [""] * len(names)),
        _intcol("column_count", ncols),
        _intcol("estimated_size", nrows)])


def fn_duckdb_columns(ctx, args) -> TableData:
    t, c, i, ty = [], [], [], []
    for name, td in sorted(ctx.catalog.tables.items()):
        for idx, col in enumerate(td.columns):
            t.append(name)
            c.append(col.name)
            i.append(idx)
            ty.append(repr(col.dtype))
    return TableData("duckdb_columns", [
        _strcol("table_name", t), _strcol("column_name", c),
        _intcol("column_index", i), _strcol("data_type", ty)])


def fn_duckdb_settings(ctx, args) -> TableData:
    rows = ctx.config.rows()
    return TableData("duckdb_settings", [
        _strcol("name", [r[0] for r in rows]),
        _strcol("value", [r[1] for r in rows]),
        _strcol("description", [r[2] for r in rows]),
        _strcol("scope", [r[3] for r in rows])])


def fn_duckdb_secrets(ctx, args) -> TableData:
    """Redacted secret listing (reference: duckdb_secrets() in
    src/function/table/system/duckdb_secrets.cpp)."""
    secrets = ctx.secret_manager.list()
    return TableData("duckdb_secrets", [
        _strcol("name", [s.name for s in secrets]),
        _strcol("type", [s.type for s in secrets]),
        _strcol("provider", [s.provider for s in secrets]),
        _strcol("persistent", ["true" if s.persistent else "false"
                               for s in secrets]),
        _strcol("scope", [",".join(s.scope) for s in secrets]),
        _strcol("secret_string", [s.redacted() for s in secrets])])


def fn_duckdb_views(ctx, args) -> TableData:
    names = sorted(ctx.catalog.views)
    sqls = [ctx.catalog.views[n][0] for n in names]
    return TableData("duckdb_views", [
        _strcol("view_name", names), _strcol("sql", sqls)])


def fn_duckdb_dependencies(ctx, args) -> TableData:
    """Catalog dependency edges (reference:
    src/function/table/system/duckdb_dependencies.cpp; ours derives
    edges from catalog state, catalog.py Catalog.dependencies)."""
    edges = sorted(set(ctx.catalog.dependencies()))
    return TableData("duckdb_dependencies", [
        _strcol("objid_type", [d[0] for d, r in edges]),
        _strcol("objid_name", [d[1] for d, r in edges]),
        _strcol("refobjid_type", [r[0] for d, r in edges]),
        _strcol("refobjid_name", [r[1] for d, r in edges]),
        _strcol("deptype", ["n" for _ in edges])])


def fn_duckdb_snapshots(ctx, args) -> TableData:
    ids = ctx.snapshots.ids()
    return TableData("duckdb_snapshots", [_intcol("snapshot_id", ids)])


def fn_range(ctx, args) -> TableData:
    if len(args) == 1:
        start, stop, step = 0, int(args[0]), 1
    elif len(args) == 2:
        start, stop, step = int(args[0]), int(args[1]), 1
    else:
        start, stop, step = int(args[0]), int(args[1]), int(args[2])
    v = np.arange(start, stop, step, dtype=np.int64)
    return TableData("range", [_intcol("range", v)])


def fn_generate_series(ctx, args) -> TableData:
    if len(args) == 1:
        start, stop, step = 0, int(args[0]), 1
    elif len(args) == 2:
        start, stop, step = int(args[0]), int(args[1]), 1
    else:
        start, stop, step = int(args[0]), int(args[1]), int(args[2])
    v = np.arange(start, stop + (1 if step > 0 else -1), step,
                  dtype=np.int64)
    return TableData("generate_series", [_intcol("generate_series", v)])


def fn_pragma_table_info(ctx, args) -> TableData:
    td = ctx.catalog.get_table(str(args[0]))
    return TableData("pragma_table_info", [
        _intcol("cid", list(range(len(td.columns)))),
        _strcol("name", [c.name for c in td.columns]),
        _strcol("type", [repr(c.dtype) for c in td.columns]),
    ])


def fn_duckdb_logs(ctx, args) -> TableData:
    import datetime
    es = list(ctx.log.entries)
    return TableData("duckdb_logs", [
        _strcol("timestamp", [
            datetime.datetime.fromtimestamp(e.ts).isoformat()
            for e in es]),
        _strcol("level", [e.level for e in es]),
        _strcol("type", [e.type for e in es]),
        _strcol("message", [e.message for e in es])])


TABLE_FUNCTIONS: Dict[str, Callable] = {
    "duckdb_logs": fn_duckdb_logs,
    "duckdb_tables": fn_duckdb_tables,
    "duckdb_columns": fn_duckdb_columns,
    "duckdb_settings": fn_duckdb_settings,
    "duckdb_secrets": fn_duckdb_secrets,
    "duckdb_views": fn_duckdb_views,
    "duckdb_snapshots": fn_duckdb_snapshots,
    "duckdb_dependencies": fn_duckdb_dependencies,
    "range": fn_range,
    "generate_series": fn_generate_series,
    "pragma_table_info": fn_pragma_table_info,
}


def _emptycols(*names):
    return [_strcol(n, []) for n in names]


def fn_duckdb_databases(ctx, args) -> TableData:
    names = ["memory"] + sorted(ctx._attached)
    paths = [""] + [ctx._attached[n] for n in sorted(ctx._attached)]
    return TableData("duckdb_databases", [
        _strcol("database_name", names), _strcol("path", paths),
        _strcol("type", ["duckdb"] * len(names))])


def fn_duckdb_schemas(ctx, args) -> TableData:
    return TableData("duckdb_schemas", [
        _strcol("schema_name", ["main"]),
        _strcol("database_name", ["memory"])])


def fn_duckdb_keywords(ctx, args) -> TableData:
    from .sql.lexer import KEYWORDS
    kws = sorted(KEYWORDS)
    return TableData("duckdb_keywords", [
        _strcol("keyword_name", kws),
        _strcol("keyword_category", ["reserved"] * len(kws))])


def fn_duckdb_types(ctx, args) -> TableData:
    names = [t.name for t in T.TypeId if t.name not in ("INVALID", "NULL")]
    sizes = [T.DataType(T.TypeId[n]).np_dtype.itemsize for n in names]
    return TableData("duckdb_types", [
        _strcol("type_name", [n.lower() for n in names]),
        _intcol("type_size", sizes),
        _strcol("logical_type", names)])


def _harvest_dispatch_names(fn) -> set:
    """Function names a binder dispatch method accepts, harvested from
    its source: every string compared against the local `name` variable
    (`name == "x"` / `name in ("x", "y")`).  Keeps duckdb_functions()
    in sync with the real dispatch without a hand-maintained list
    (reference enumerates its registry the same way —
    src/function/function_list.cpp is the single source of truth)."""
    import ast as _ast
    import inspect
    import textwrap
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = _ast.parse(src)
    except (OSError, SyntaxError):
        return set()
    out = set()

    def str_consts(node):
        if isinstance(node, _ast.Constant) and isinstance(node.value,
                                                         str):
            yield node.value
        elif isinstance(node, (_ast.Tuple, _ast.List, _ast.Set)):
            for elt in node.elts:
                yield from str_consts(elt)

    for node in _ast.walk(tree):
        if not isinstance(node, _ast.Compare):
            continue
        left = node.left
        if not (isinstance(left, _ast.Name) and left.id == "name"):
            continue
        for op, cmp_ in zip(node.ops, node.comparators):
            if isinstance(op, (_ast.Eq, _ast.In)):
                for s2 in str_consts(cmp_):
                    if s2 and s2.replace("_", "").isalnum() \
                            and not s2.startswith("__"):
                        out.add(s2)
    return out


def _function_registry():
    """(name, kind) for every SQL-callable function the binder accepts."""
    from .sql import binder as B
    from .expr.functions import _MATH1
    scalars = set(_MATH1)
    scalars |= _harvest_dispatch_names(B.Binder._bind_func)
    for meth in ("_bind_string_func", "_bind_concat",
                 "_bind_list_func", "_bind_list_func_dynamic",
                 "_bind_json_func", "_bind_window"):
        m = getattr(B.Binder, meth, None)
        if m is not None:
            scalars |= _harvest_dispatch_names(m)
    scalars |= set(B.FUNC_ALIASES)
    scalars |= set(getattr(B, "_BUILTIN_MACROS", ()))
    scalars |= set(getattr(B, "AGG_MACROS", ()))
    scalars |= set(getattr(B, "_STR_FUNCS", ()))
    scalars -= set(B.AGG_FUNCS)
    aggs = sorted(set(B.AGG_FUNCS))
    tfs = sorted(TABLE_FUNCTIONS)
    return ([(s, "scalar") for s in sorted(scalars)]
            + [(a, "aggregate") for a in aggs]
            + [(t, "table") for t in tfs])


def fn_duckdb_functions(ctx, args) -> TableData:
    rows = _function_registry()
    rows = rows + [(n, "udf") for n in
                   sorted(getattr(ctx, "_udfs", {}))]
    rows = rows + [(n, "table_macro" if m.get("is_table") else "macro")
                   for n, m in sorted(
                       getattr(ctx.catalog, "macros", {}).items())]
    return TableData("duckdb_functions", [
        _strcol("function_name", [r[0] for r in rows]),
        _strcol("function_type", [r[1] for r in rows]),
        _strcol("schema_name", ["main"] * len(rows))])


def fn_duckdb_prepared_statements(ctx, args) -> TableData:
    names = sorted(ctx._prepared)
    return TableData("duckdb_prepared_statements", [
        _strcol("name", names),
        _strcol("statement", [ctx._prepared[n] for n in names])])


def fn_duckdb_constraints(ctx, args) -> TableData:
    tnames, ctypes_, ctexts = [], [], []
    for name, td in sorted(ctx.catalog.tables.items()):
        for kind, cols in getattr(td, "constraints", ()):
            tnames.append(name)
            ctypes_.append(kind.replace("_", " ").upper())
            ctexts.append(f"{kind.replace('_', ' ').upper()}"
                          f"({', '.join(cols)})")
        for cname in sorted(getattr(td, "not_null", ())):
            tnames.append(name)
            ctypes_.append("NOT NULL")
            ctexts.append(f"NOT NULL({cname})")
    if not tnames:
        return TableData("duckdb_constraints", _emptycols(
            "table_name", "constraint_type", "constraint_text"))
    return TableData("duckdb_constraints", [
        _strcol("table_name", tnames),
        _strcol("constraint_type", ctypes_),
        _strcol("constraint_text", ctexts)])


def fn_duckdb_indexes(ctx, args) -> TableData:
    """User + constraint-backing indexes (reference:
    src/function/table/system/duckdb_indexes.cpp)."""
    names, tables, uniqs, sqls = [], [], [], []
    for tname, td in sorted(ctx.catalog.tables.items()):
        for ix in getattr(td, "indexes", {}).values():
            names.append(ix.name)
            tables.append(tname)
            uniqs.append(ix.unique)
            cols = ", ".join(ix.columns)
            sqls.append(
                f"CREATE {'UNIQUE ' if ix.unique else ''}INDEX "
                f"{ix.name} ON {tname}({cols})")
    return TableData("duckdb_indexes", [
        _strcol("index_name", names), _strcol("table_name", tables),
        TableColumn("is_unique", T.BOOLEAN,
                    np.asarray(uniqs, dtype=bool)),
        _strcol("sql", sqls)])


def fn_duckdb_sequences(ctx, args) -> TableData:
    names = sorted(ctx.catalog.sequences)
    seqs = [ctx.catalog.sequences[n] for n in names]
    return TableData("duckdb_sequences", [
        _strcol("sequence_name", names),
        _strcol("schema_name", ["main" for _ in names]),
        _intcol("start_value", [s["start"] for s in seqs]),
        _intcol("increment_by", [s["increment"] for s in seqs]),
        _intcol("last_value", [s["value"] for s in seqs])])


def fn_duckdb_variables(ctx, args) -> TableData:
    return TableData("duckdb_variables", _emptycols("name", "value"))


def fn_duckdb_extensions(ctx, args) -> TableData:
    # built-in capability surface presented extension-style (reference:
    # duckdb_extensions lists parquet/json/tpch/...; ours are compiled in)
    exts = ["parquet", "tpch", "core_functions"]
    return TableData("duckdb_extensions", [
        _strcol("extension_name", exts),
        TableColumn("loaded", T.BOOLEAN,
                    np.ones(len(exts), dtype=np.bool_)),
        TableColumn("installed", T.BOOLEAN,
                    np.ones(len(exts), dtype=np.bool_))])


def fn_duckdb_optimizers(ctx, args) -> TableData:
    names = ["expression_rewriter", "filter_pushdown", "cross_elimination",
             "join_order", "column_pruning", "constant_folding",
             "statistics_propagation"]
    return TableData("duckdb_optimizers", [_strcol("name", names)])


def fn_duckdb_memory(ctx, args) -> TableData:
    import torch
    dev = ctx.device
    tags, used, limit = [str(dev)], [0], [0]
    if dev.type == "cuda":
        used[0] = int(torch.cuda.memory_allocated(dev))
        limit[0] = int(torch.cuda.get_device_properties(dev).total_memory)
    from .storage.buffer import MANAGER
    st = MANAGER.stats()
    tags.append("BUFFER_CACHE")
    used.append(int(st["cached_bytes"]))
    limit.append(int(st["limit_bytes"] or 0))
    return TableData("duckdb_memory", [
        _strcol("tag", tags),
        _intcol("memory_usage_bytes", used),
        _intcol("memory_limit_bytes", limit)])


def fn_duckdb_temporary_files(ctx, args) -> TableData:
    return TableData("duckdb_temporary_files", _emptycols("path"))


def _table_bytes(td: TableData) -> int:
    total = 0
    for c in td.columns:
        total += c.data.nbytes
        if c.nulls is not None:
            total += c.nulls.nbytes
        if c.strdict is not None:
            total += sum(len(str(v)) for v in c.strdict.values)
    return total


def fn_pragma_database_size(ctx, args) -> TableData:
    total = sum(_table_bytes(td) for td in ctx.catalog.tables.values())
    return TableData("pragma_database_size", [
        _strcol("database_name", ["memory"]),
        _intcol("database_size", [total]),
        _intcol("block_size", [1 << 18]),
        _intcol("total_blocks", [(total >> 18) + 1])])


def fn_pragma_storage_info(ctx, args) -> TableData:
    td = ctx.catalog.get_table(str(args[0]))
    names, types, counts, nbytes, comp = [], [], [], [], []
    for c in td.columns:
        names.append(c.name)
        types.append(repr(c.dtype))
        counts.append(len(c.data))
        nbytes.append(c.data.nbytes)
        comp.append("dictionary" if c.strdict is not None else "plain")
    return TableData("pragma_storage_info", [
        _strcol("column_name", names), _strcol("column_type", types),
        _intcol("count", counts), _intcol("bytes", nbytes),
        _strcol("compression", comp)])


def fn_pragma_metadata_info(ctx, args) -> TableData:
    names = sorted(ctx.catalog.tables)
    return TableData("pragma_metadata_info", [
        _strcol("table_name", names),
        _intcol("total_bytes", [
            _table_bytes(ctx.catalog.tables[n]) for n in names])])


def fn_pragma_collations(ctx, args) -> TableData:
    return TableData("pragma_collations", [
        _strcol("collname", ["default", "binary", "nocase"])])


def fn_pragma_version(ctx, args) -> TableData:
    return TableData("pragma_version", [
        _strcol("library_version", ["ddb_tpu 0.3"]),
        _strcol("source_id", ["tpu-native"])])


def fn_test_all_types(ctx, args) -> TableData:
    """Min/max/null row per supported type (reference:
    src/function/table/system/test_all_types.cpp — powers type-matrix
    tests)."""
    import decimal as _d
    cols = []
    cols.append(TableColumn("bool", T.BOOLEAN,
                            np.array([False, True, False]),
                            np.array([False, False, True])))
    for nm, t in (("int", T.INTEGER), ("bigint", T.BIGINT)):
        info = np.iinfo(np.dtype(t.np_dtype))
        cols.append(TableColumn(
            nm, t, np.array([info.min, info.max, 0], dtype=t.np_dtype),
            np.array([False, False, True])))
    cols.append(TableColumn(
        "double", T.DOUBLE,
        np.array([-1.7976931348623157e308, 1.7976931348623157e308, 0.0]),
        np.array([False, False, True])))
    cols.append(TableColumn(
        "dec_18_6", T.DECIMAL(18, 6),
        np.array([-(10**18 - 1), 10**18 - 1, 0], dtype=np.int64),
        np.array([False, False, True])))
    cols.append(TableColumn(
        "date", T.DATE, np.array([-100000, 100000, 0], dtype=np.int32),
        np.array([False, False, True])))
    sd, codes, _ = StringDictionary.encode(["", "longest_string", ""])
    cols.append(TableColumn("varchar", T.VARCHAR, codes,
                            np.array([False, False, True]), sd))
    return TableData("test_all_types", cols)


def fn_glob(ctx, args) -> TableData:
    import glob as _g
    return TableData("glob", [
        _strcol("file", sorted(_g.glob(str(args[0]))))])


def fn_repeat(ctx, args) -> TableData:
    value, count = args[0], int(args[1])
    if isinstance(value, str):
        return TableData("repeat", [_strcol("repeat", [value] * count)])
    return TableData("repeat", [
        TableColumn("repeat", T.literal_type(value),
                    np.full(count, value))])


def fn_read_csv(ctx, args, kwargs=None) -> TableData:
    """read_csv('f.csv'[, delim=..., header=..., columns={...}]):
    dialect+schema sniffing then pyarrow bulk parse (reference: CSV
    sniffer, src/execution/operator/csv_scanner/sniffer/)."""
    from .storage.csv_sniffer import read_csv_auto
    kw = kwargs or {}
    delim = kw.get("delim") or kw.get("sep") or kw.get("delimiter")
    header = kw.get("header")
    if isinstance(header, str):
        header = header.lower() in ("true", "1", "yes")
    names = kw.get("names")
    types = kw.get("columns") if isinstance(kw.get("columns"), dict) \
        else kw.get("types") if isinstance(kw.get("types"), dict) else None
    if types and names is None and kw.get("columns"):
        names = list(types.keys())
    from .storage.cachefs import resolve as _fs_resolve
    td = read_csv_auto(_fs_resolve(str(args[0])), delim=delim,
                       header=header,
                       names=names, types=types)
    td.name = "read_csv"
    return td


def fn_sql_auto_complete(ctx, args) -> TableData:
    """sql_auto_complete('SEL') -> (suggestion, suggestion_start)
    (reference: extension/autocomplete/autocomplete_extension.cpp)."""
    from .autocomplete import suggestions
    prefix = str(args[0]) if args else ""
    sugg = suggestions(ctx, prefix)[:20]
    start = len(prefix) - len(prefix.split()[-1] if prefix.strip() else "")
    return TableData("sql_auto_complete", [
        _strcol("suggestion", [s for s, _ in sugg]),
        _intcol("suggestion_start", [start] * len(sugg))])


def fn_sniff_csv(ctx, args) -> TableData:
    """sniff_csv('f.csv'): one row of detected dialect + schema
    (reference: sniff_csv table function)."""
    from .storage.csv_sniffer import sniff
    sn = sniff(str(args[0]))
    cols_sql = ", ".join(f"'{n}' '{t}'" for n, t in
                         zip(sn.column_names, sn.column_types))
    return TableData("sniff_csv", [
        _strcol("delimiter", [sn.delimiter]),
        _strcol("quote", [sn.quote]),
        _strcol("escape", [sn.escape]),
        TableColumn("has_header", T.BOOLEAN,
                    np.array([sn.has_header])),
        _strcol("columns", ["{" + cols_sql + "}"]),
    ])


def fn_read_parquet(ctx, args) -> TableData:
    from .storage.table import from_arrow
    import pyarrow.parquet as pq
    from .storage.cachefs import resolve as _fs_resolve
    return from_arrow("read_parquet",
                      pq.read_table(_fs_resolve(str(args[0]))))


TABLE_FUNCTIONS.update({
    "duckdb_databases": fn_duckdb_databases,
    "duckdb_schemas": fn_duckdb_schemas,
    "duckdb_keywords": fn_duckdb_keywords,
    "duckdb_types": fn_duckdb_types,
    "duckdb_functions": fn_duckdb_functions,
    "duckdb_prepared_statements": fn_duckdb_prepared_statements,
    "duckdb_constraints": fn_duckdb_constraints,
    "duckdb_indexes": fn_duckdb_indexes,
    "duckdb_sequences": fn_duckdb_sequences,
    "duckdb_variables": fn_duckdb_variables,
    "duckdb_extensions": fn_duckdb_extensions,
    "duckdb_optimizers": fn_duckdb_optimizers,
    "duckdb_memory": fn_duckdb_memory,
    "duckdb_temporary_files": fn_duckdb_temporary_files,
    "pragma_database_size": fn_pragma_database_size,
    "pragma_storage_info": fn_pragma_storage_info,
    "pragma_metadata_info": fn_pragma_metadata_info,
    "pragma_collations": fn_pragma_collations,
    "pragma_version": fn_pragma_version,
    "test_all_types": fn_test_all_types,
    "glob": fn_glob,
    "repeat": fn_repeat,
    "read_csv": fn_read_csv,
    "read_csv_auto": fn_read_csv,
    "sniff_csv": fn_sniff_csv,
    "sql_auto_complete": fn_sql_auto_complete,
    "read_parquet": fn_read_parquet,
})


def fn_unnest(ctx, args) -> TableData:
    """FROM unnest([v1, v2, ...]) — literal list to one-column table
    (reference: src/function/table/unnest.cpp)."""
    vals = args[0] if args and isinstance(args[0], list) else list(args)
    nulls = np.array([v is None for v in vals], dtype=bool)
    nn = nulls if nulls.any() else None
    if any(isinstance(v, str) for v in vals):
        sd, codes, snulls = StringDictionary.encode(vals)
        return TableData("unnest", [
            TableColumn("unnest", T.VARCHAR, codes,
                        snulls if snulls.any() else None, sd)])
    if any(isinstance(v, float) for v in vals):
        data = np.array([0.0 if v is None else float(v) for v in vals])
        return TableData("unnest", [
            TableColumn("unnest", T.DOUBLE, data, nn)])
    data = np.array([0 if v is None else int(v) for v in vals],
                    dtype=np.int64)
    return TableData("unnest", [TableColumn("unnest", T.BIGINT, data, nn)])


TABLE_FUNCTIONS["unnest"] = fn_unnest
