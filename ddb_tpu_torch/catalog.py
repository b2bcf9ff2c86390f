"""Catalog: schemas, tables, views.

Slimmed-down analog of the reference's Catalog/CatalogSet
(reference: src/catalog/catalog.cpp, catalog_set.cpp).  MVCC-versioned
entries arrive with the transaction layer in a later round; for now entries
are plain dicts guarded by the connection.
"""

from __future__ import annotations

from typing import Dict, Optional

from .storage.table import TableData


class CatalogException(Exception):
    pass


def _sequence_refs(expr_text: str):
    """Sequence names referenced by nextval/currval calls in a DEFAULT
    expression's source text (reference: bound defaults carry catalog
    dependencies, src/catalog/dependency_manager.cpp)."""
    import re
    return {m.group(1).lower() for m in
            re.finditer(r"(?:nextval|currval)\s*\(\s*'([^']+)'",
                        expr_text, re.IGNORECASE)}


_VERSION_COUNTER = [0]


class Catalog:
    def __init__(self):
        self.tables: Dict[str, TableData] = {}
        self.views: Dict[str, str] = {}       # name -> (sql, col aliases)
        self.enums: Dict[str, list] = {}      # ENUM type name -> values
        self.schemas = {"main"}               # CREATE SCHEMA namespaces
        self.sequences: Dict[str, dict] = {}  # name -> state dict
        # macros: name -> {params, defaults, body, is_table}
        # (reference: macro_catalog_entry.cpp)
        self.macros: Dict[str, dict] = {}
        self.version = 0    # bumped on any change; invalidates plan cache

    def dependencies(self):
        """Derived dependency edges ((dep_kind, dep_name), (req_kind,
        req_name)): the dependent requires the dependency to exist.
        Computed from catalog state rather than stored, so clones,
        WAL replay, and transaction snapshots stay consistent for free
        (reference stores them explicitly: dependency_manager.cpp;
        same enforcement semantics — RESTRICT errors, CASCADE drops)."""
        for key, td in self.tables.items():
            seen_types = set()
            for _col, dom in getattr(td, "enum_domains", {}).items():
                tname = dom[0].lower()
                if tname not in seen_types:
                    seen_types.add(tname)
                    yield (("table", key), ("type", tname))
            seen_seqs = set()
            for _col, dtext in getattr(td, "defaults", {}).items():
                for seq in _sequence_refs(dtext):
                    if seq in self.sequences and seq not in seen_seqs:
                        seen_seqs.add(seq)
                        yield (("table", key), ("sequence", seq))
            for ixname in getattr(td, "indexes", {}):
                if not ixname.startswith("__"):
                    yield (("index", ixname), ("table", key))
            seen_fk = set()
            for _cols, parent, _pcols in getattr(td, "foreign_keys",
                                                 ()):
                p = parent.lower()
                if p in self.tables and p not in seen_fk:
                    seen_fk.add(p)
                    # child requires parent: DROP parent RESTRICTs
                    # (reference: ForeignKey dependencies,
                    # src/catalog/dependency_manager.cpp)
                    yield (("table", key), ("table", p))

    def dependents_of(self, kind: str, name: str):
        """Entries that depend on (kind, name), sorted for stable
        error messages."""
        ent = (kind, name.lower())
        return sorted({dep for dep, req in self.dependencies()
                       if req == ent})

    def sequence_next(self, name: str) -> int:
        seq = self.sequences.get(name.lower())
        if seq is None:
            raise CatalogException(f"sequence {name} does not exist")
        seq["value"] += seq["increment"]
        return seq["value"]

    def sequence_current(self, name: str) -> int:
        seq = self.sequences.get(name.lower())
        if seq is None:
            raise CatalogException(f"sequence {name} does not exist")
        if seq["value"] < seq["start"]:
            raise CatalogException(
                f"sequence {name} has no current value (nextval not "
                "called yet)")
        return seq["value"]

    def bump(self):
        # globally unique versions: a transaction's private catalog and
        # the shared catalog must never collide on a plan-cache key
        # (plans embed TableData references)
        _VERSION_COUNTER[0] += 1
        self.version = _VERSION_COUNTER[0]

    def add_table(self, table: TableData, or_replace: bool = False):
        key = table.name.lower()
        if key in self.tables and not or_replace:
            raise CatalogException(f"table {table.name} already exists")
        self.tables[key] = table
        self.bump()

    def get_table(self, name: str) -> TableData:
        key = self._resolve(name)
        if key is None:
            raise CatalogException(f"table {name} does not exist")
        return self.tables[key]

    def _resolve(self, name: str) -> Optional[str]:
        """Resolve a possibly schema-qualified name: 'db.t' keys for
        ATTACHed databases, 'main.' / 'main.main.' prefixes for the default
        catalog (reference: catalog search path, src/catalog/catalog.cpp)."""
        key = name.lower()
        if key in self.tables:
            return key
        for pre in ("main.", "main.main."):
            if key.startswith(pre) and key[len(pre):] in self.tables:
                return key[len(pre):]
        return None

    def has_table(self, name: str) -> bool:
        return self._resolve(name) is not None

    def drop_table(self, name: str, if_exists: bool = False):
        key = name.lower()
        if key not in self.tables:
            if if_exists:
                return
            raise CatalogException(f"table {name} does not exist")
        del self.tables[key]
        self.bump()

    def add_view(self, name: str, sql: str, or_replace: bool = False,
                 column_aliases=None):
        key = name.lower()
        if key in self.views and not or_replace:
            raise CatalogException(f"view {name} already exists")
        self.views[key] = (sql, column_aliases)
        self.bump()

    def get_view(self, name: str):
        """Returns (sql, column_aliases) or None."""
        return self.views.get(name.lower())

    def drop_view(self, name: str, if_exists: bool = False):
        key = name.lower()
        if key not in self.views:
            if if_exists:
                return
            raise CatalogException(f"view {name} does not exist")
        del self.views[key]
        self.bump()
