"""Configuration / settings registry.

Declarative settings table in the spirit of the reference's
src/common/settings.json -> generated setting classes
(reference: src/main/settings/autogenerated_settings.cpp,
scripts/generate_settings.py).  Settings are visible via
`SELECT * FROM duckdb_settings()` and set via SET / PRAGMA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass
class Setting:
    name: str
    default: Any
    description: str
    scope: str = "global"          # global | session
    validator: Optional[Callable[[Any], Any]] = None


def _collation_value(v):
    """default_collation validator: unquoted PRAGMA values arrive as
    identifier ASTs; '' clears the default."""
    if hasattr(v, "parts"):
        v = ".".join(str(p) for p in v.parts)
    v = str(v)
    if v:
        from .sql.binder import validate_collation
        validate_collation(v)
    return v.lower()


SETTINGS = [
    Setting("threads", 1,
            "Host worker threads (device parallelism is mesh-driven)"),
    Setting("memory_limit", "80% of HBM",
            "Soft device-memory budget for capacity planning"),
    Setting("default_collation", "",
            "Collation applied to VARCHAR comparisons with no explicit "
            "COLLATE", scope="session", validator=_collation_value),
    Setting("default_null_order", "nulls_last",
            "Default NULL ordering (nulls_first|nulls_last)"),
    Setting("default_order", "asc",
            "Default sort direction when unspecified (asc|desc)"),
    Setting("enable_profiling", False,
            "Collect per-operator timings on every query"),
    Setting("enable_progress_bar", False,
            "Emit progress callbacks during execution"),
    Setting("max_expression_depth", 1000,
            "Parser recursion limit"),
    Setting("explain_output", "physical",
            "EXPLAIN output mode"),
    Setting("preserve_insertion_order", True,
            "Whether results preserve base-table order"),
    Setting("enable_verification", False,
            "Run statement verifiers (unoptimized-plan cross-check)"),
    Setting("verify_external", False,
            "Statement verifier also forces out-of-core execution"),
    Setting("verify_parallelism", False,
            "Statement verifier also runs the distributed executor"),
    Setting("perfect_ht_threshold", 16,
            "Max dense domain for the perfect-hash aggregate path"),
    Setting("compaction_threshold", 0.5,
            "Compact batches when live fraction falls below this"),
    Setting("external_threshold_rows", 33_554_432,
            "Tables larger than this stream through the out-of-core "
            "tiled executor (reference analog: TemporaryMemoryManager "
            "external-mode decisions)"),
    Setting("tile_rows", 8_388_608,
            "Row-tile size for out-of-core execution (host->HBM "
            "streaming granularity)"),
    Setting("wal_autocheckpoint", 16 * 1024 * 1024,
            "Auto-checkpoint when the WAL exceeds this many bytes "
            "(reference: duck_transaction.hpp:64 AutomaticCheckpoint)"),
    Setting("checkpoint_on_shutdown", True,
            "Checkpoint + truncate the WAL when the connection closes"),
    Setting("timezone", "UTC",
            "Session time zone for current_date / "
            "current_localtimestamp (reference: ICU TimeZone setting)"),
    Setting("redo_transport", "",
            "Stream logical WAL records to this append-only redo file "
            "(redo.py Follower replays them; kafkaredo analog)"),
    Setting("calendar", "gregorian",
            "Session calendar (reference: ICU Calendar setting; only "
            "the gregorian calendar is implemented)"),
    # fork-parity settings (reference: custom_settings.cpp:1479-1529)
    Setting("cdc_enabled", False, "Emit change-data-capture events"),
    Setting("redo_log_path", "",
            "External redo stream sink (fork: kafka_redo_log)"),
]

# The reference's remaining setting names (src/include/duckdb/main/
# settings.hpp `Name =` constants).  SETting one is accepted as an inert
# value — scripts tuned for the reference keep running — while names
# outside this list raise like the reference's "unrecognized
# configuration parameter" error.
INERT_SETTINGS = frozenset("""
access_mode allocator_background_threads
allocator_bulk_deallocation_flush_threshold allocator_flush_threshold
allow_community_extensions allow_extensions_metadata_mismatch
allow_persistent_secrets allow_unredacted_secrets
allow_unsigned_extensions allowed_directories allowed_paths
arrow_large_buffer_size arrow_lossless_conversion
arrow_output_list_view asof_loop_join_threshold
autoinstall_extension_repository autoinstall_known_extensions
autoload_known_extensions catalog_error_max_schemas
checkpoint_threshold custom_extension_repository
custom_profiling_settings custom_user_agent debug_asof_iejoin
debug_checkpoint_abort debug_force_external
debug_force_no_cross_product debug_skip_checkpoint_on_commit
debug_verify_vector debug_window_mode default_block_size
default_collation default_secret_storage disable_timestamptz_casts
disabled_compression_methods disabled_filesystems disabled_log_types
disabled_optimizers duckdb_api dynamic_or_filter_threshold
enable_external_access enable_external_file_cache enable_fsst_vectors
enable_http_logging enable_http_metadata_cache enable_logging
enable_macro_dependencies enable_object_cache
enable_progress_bar_print enable_view_dependencies errors_as_json
extension_directory external_threads file_search_path
force_bitpacking_mode force_compression home_directory
http_logging_output http_proxy http_proxy_password
http_proxy_username ieee_floating_point_ops
immediate_transaction_mode index_scan_max_count index_scan_percentage
integer_division kafka_bootstrap_server_and_port kafka_redo_log
kafka_topic_name kafka_writer lambda_syntax
late_materialization_max_rows lock_configuration log_extension
log_query_path logging_level logging_mode logging_storage max_memory
max_temp_directory_size max_vacuum_tasks merge_join_threshold
nested_loop_join_threshold old_implicit_casting
order_by_non_integer_literal ordered_aggregate_threshold
partitioned_write_flush_threshold partitioned_write_max_open_files
password pivot_filter_threshold pivot_limit prefer_range_joins
preserve_identifier_case produce_arrow_string_view profile_output
profiling_coverage profiling_mode progress_bar_time
scalar_subquery_error_on_multiple_rows scheduler_process_partial
schema search_path secret_directory storage_compatibility_version
streaming_buffer_size temp_directory username zstd_min_string_length
""".split())


class Config:
    def __init__(self):
        self._defs: Dict[str, Setting] = {s.name: s for s in SETTINGS}
        self.values: Dict[str, Any] = {s.name: s.default for s in SETTINGS}

    def set(self, name: str, value: Any):
        name = name.lower()
        if name not in self._defs:
            if name in INERT_SETTINGS:
                self.values[name] = value
                return
            raise KeyError(f"unrecognized configuration parameter "
                           f"\"{name}\"")
        s = self._defs[name]
        if s.validator:
            value = s.validator(value)
        elif isinstance(s.default, bool):
            if isinstance(value, str):
                value = value.lower() in ("1", "true", "on", "yes")
            else:
                value = bool(value)
        elif isinstance(s.default, int) and not isinstance(value, bool):
            try:
                value = int(value)
            except (TypeError, ValueError):
                # size strings ('1TB', '64MB') for byte-count settings
                # (reference: every memory setting accepts them)
                from .storage.buffer import parse_memory_limit
                value = parse_memory_limit(value)
        self.values[name] = value

    def get(self, name: str):
        return self.values[name.lower()]

    def rows(self):
        return [(s.name, str(self.values[s.name]), s.description,
                 s.scope) for s in SETTINGS]
