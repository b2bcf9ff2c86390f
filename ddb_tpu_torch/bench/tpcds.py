"""TPC-DS: data loading + query access.

Data comes from the reference's dsdgen via the oracle CLI
(`CALL dsdgen(sf=N); EXPORT DATABASE ... (FORMAT csv, DELIMITER '|',
HEADER false)`); queries are the official files
(reference: extension/tpcds/dsdgen/queries/NN.sql, answers under
extension/tpcds/dsdgen/answers/).
"""

from __future__ import annotations

import os
from typing import Optional

QUERY_DIR = os.path.join(
    os.environ.get("DDB_TPU_REFERENCE_ROOT", os.getcwd()),
    "extension/tpcds/dsdgen/queries")


def query_text(n: int, qdir: str = QUERY_DIR) -> str:
    with open(os.path.join(qdir, f"{n:02d}.sql")) as f:
        return f.read()


def load_tpcds(con, directory: str, tables=None):
    """Create tables from the exported schema.sql, then bulk-load the
    pipe-separated csv files with exact arrow types per column."""
    import pyarrow as pa
    import pyarrow.csv as pcsv

    from .. import types as T
    from ..storage import table as storage
    from ..types import TypeId

    with open(os.path.join(directory, "schema.sql")) as f:
        for stmt in f.read().split(";"):
            if stmt.strip():
                con.execute(stmt)

    def pa_type(dt):
        if dt.id == TypeId.DECIMAL:
            return pa.decimal128(max(dt.width, 1), dt.scale)
        return {TypeId.INTEGER: pa.int32(), TypeId.BIGINT: pa.int64(),
                TypeId.DATE: pa.date32(), TypeId.DOUBLE: pa.float64(),
                TypeId.VARCHAR: pa.string()}[dt.id]

    loaded = []
    for name in sorted(con.catalog.tables):
        if tables is not None and name not in tables:
            continue
        path = os.path.join(directory, f"{name}.csv")
        if not os.path.exists(path):
            path += ".gz"          # vendored data ships gzipped
            if not os.path.exists(path):
                continue
        td = con.catalog.tables[name]
        names = [c.name for c in td.columns]
        ct = {c.name: pa_type(c.dtype) for c in td.columns}
        if os.path.getsize(path) == 0:
            continue     # empty table: keep the created empty schema
        at = pcsv.read_csv(
            path,
            read_options=pcsv.ReadOptions(column_names=names),
            parse_options=pcsv.ParseOptions(delimiter="|"),
            convert_options=pcsv.ConvertOptions(
                column_types=ct,
                # the oracle's CSV export writes NULL as an unquoted
                # empty field and empty string as "" — distinguish them
                # (dsdgen data has real NULL ca_city etc.)
                strings_can_be_null=True,
                quoted_strings_can_be_null=False))
        con.catalog.add_table(storage.from_arrow(name, at),
                              or_replace=True)
        loaded.append(name)
    return loaded
