/* ddb_tpu C API — the stable C ABI of the TPU-native engine.
 *
 * Shape and naming follow the reference's C API so clients can switch
 * with minimal changes (reference: src/include/duckdb.h — duckdb_open /
 * duckdb_connect / duckdb_query / duckdb_value_* / appender /
 * prepared-statement surface; impl src/main/capi/).  This is an original
 * implementation: the engine behind it is the ddb_tpu jax/XLA query
 * engine hosted in an embedded CPython interpreter (native/capi.c).
 */
#ifndef DDB_TPU_C_H
#define DDB_TPU_C_H

#include <stdbool.h>
#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef enum {
    DDB_SUCCESS = 0,
    DDB_ERROR = 1,
} ddb_state;

typedef enum {
    DDB_TYPE_INVALID = 0,
    DDB_TYPE_BOOLEAN,
    DDB_TYPE_TINYINT,
    DDB_TYPE_SMALLINT,
    DDB_TYPE_INTEGER,
    DDB_TYPE_BIGINT,
    DDB_TYPE_HUGEINT,
    DDB_TYPE_FLOAT,
    DDB_TYPE_DOUBLE,
    DDB_TYPE_DECIMAL,
    DDB_TYPE_VARCHAR,
    DDB_TYPE_BLOB,
    DDB_TYPE_DATE,
    DDB_TYPE_TIME,
    DDB_TYPE_TIMESTAMP,
    DDB_TYPE_INTERVAL,
    DDB_TYPE_LIST,
    DDB_TYPE_STRUCT,
    DDB_TYPE_MAP,
    DDB_TYPE_UUID,
    DDB_TYPE_ENUM,
} ddb_type;

typedef struct ddb_database_t *ddb_database;
typedef struct ddb_connection_t *ddb_connection;
typedef struct ddb_result_t *ddb_result;
typedef struct ddb_prepared_t *ddb_prepared;
typedef struct ddb_appender_t *ddb_appender;
typedef struct ddb_config_t *ddb_config;
typedef struct ddb_logical_type_t *ddb_logical_type;

/* ------------------------------------------------------------------ *
 * configuration (reference: duckdb_create_config / duckdb_set_config /
 * duckdb_config_count / duckdb_get_config_flag :duckdb.h)             *
 * ------------------------------------------------------------------ */

ddb_state ddb_create_config(ddb_config *out_config);
ddb_state ddb_set_config(ddb_config config, const char *name,
                         const char *option);
void ddb_destroy_config(ddb_config *config);

/* number of settings the engine recognizes; get_config_flag yields the
 * name/description of setting `index` (strings owned by the library) */
size_t ddb_config_count(void);
ddb_state ddb_get_config_flag(size_t index, const char **out_name,
                              const char **out_description);

/* open with options applied to every connection of this database */
ddb_state ddb_open_ext(const char *path, ddb_database *out_db,
                       ddb_config config, char **out_error);

/* ------------------------------------------------------------------ *
 * logical types (reference: duckdb_create_logical_type /
 * duckdb_get_type_id / duckdb_decimal_width :duckdb.h)                *
 * ------------------------------------------------------------------ */

ddb_logical_type ddb_create_logical_type(ddb_type type);
ddb_logical_type ddb_create_decimal_type(uint8_t width, uint8_t scale);
ddb_logical_type ddb_create_list_type(ddb_logical_type child);
ddb_type ddb_get_type_id(ddb_logical_type type);
uint8_t ddb_decimal_width(ddb_logical_type type);
uint8_t ddb_decimal_scale(ddb_logical_type type);
/* LIST element type (borrowed; owned by the parent) */
ddb_logical_type ddb_list_type_child_type(ddb_logical_type type);
void ddb_destroy_logical_type(ddb_logical_type *type);

/* ------------------------------------------------------------------ *
 * database / connection lifecycle (reference: duckdb_open :duckdb.h)  *
 * ------------------------------------------------------------------ */

/* path == NULL or ":memory:" opens an in-memory database.  The first
 * open initializes the embedded interpreter + engine (slow: jax import);
 * subsequent opens are cheap. */
ddb_state ddb_open(const char *path, ddb_database *out_db);
void ddb_close(ddb_database *db);

ddb_state ddb_connect(ddb_database db, ddb_connection *out_con);
void ddb_disconnect(ddb_connection *con);

/* last error message for a connection (valid until next call) */
const char *ddb_error_message(ddb_connection con);

/* ------------------------------------------------------------------ *
 * querying (reference: duckdb_query / duckdb_value_*)                 *
 * ------------------------------------------------------------------ */

ddb_state ddb_query(ddb_connection con, const char *sql,
                    ddb_result *out_result);
void ddb_destroy_result(ddb_result *res);

size_t ddb_column_count(ddb_result res);
size_t ddb_row_count(ddb_result res);
const char *ddb_column_name(ddb_result res, size_t col);
ddb_type ddb_column_type(ddb_result res, size_t col);
/* full logical type incl. decimal width/scale; caller destroys */
ddb_logical_type ddb_column_logical_type(ddb_result res, size_t col);

bool ddb_value_is_null(ddb_result res, size_t col, size_t row);
bool ddb_value_boolean(ddb_result res, size_t col, size_t row);
int64_t ddb_value_int64(ddb_result res, size_t col, size_t row);
double ddb_value_double(ddb_result res, size_t col, size_t row);
/* returned string is owned by the result; valid until destroy */
const char *ddb_value_varchar(ddb_result res, size_t col, size_t row);

/* ------------------------------------------------------------------ *
 * prepared statements (reference: duckdb_prepare / duckdb_bind_*)     *
 * ------------------------------------------------------------------ */

ddb_state ddb_prepare(ddb_connection con, const char *sql,
                      ddb_prepared *out_prepared);
void ddb_destroy_prepare(ddb_prepared *stmt);

ddb_state ddb_bind_int64(ddb_prepared stmt, size_t param_idx, int64_t v);
ddb_state ddb_bind_double(ddb_prepared stmt, size_t param_idx, double v);
ddb_state ddb_bind_varchar(ddb_prepared stmt, size_t param_idx,
                           const char *v);
ddb_state ddb_bind_null(ddb_prepared stmt, size_t param_idx);
ddb_state ddb_execute_prepared(ddb_prepared stmt, ddb_result *out_result);

/* ------------------------------------------------------------------ *
 * appender: bulk row ingest (reference: duckdb_appender_create)       *
 * ------------------------------------------------------------------ */

ddb_state ddb_appender_create(ddb_connection con, const char *schema,
                              const char *table, ddb_appender *out);
ddb_state ddb_append_int64(ddb_appender app, int64_t v);
ddb_state ddb_append_double(ddb_appender app, double v);
ddb_state ddb_append_varchar(ddb_appender app, const char *v);
ddb_state ddb_append_null(ddb_appender app);
ddb_state ddb_appender_end_row(ddb_appender app);
/* push buffered rows into the table */
ddb_state ddb_appender_flush(ddb_appender app);
ddb_state ddb_appender_destroy(ddb_appender *app);

/* ---- scalar UDF registration (reference: duckdb_create_scalar_function
 * family, src/include/duckdb.h; ours is a row-wise callback ABI — the
 * engine vectorizes around it) ------------------------------------- */
typedef struct {
    int is_null;
    int64_t i;       /* integer/boolean/temporal-raw value */
    double d;        /* float/double value */
    const char *s;   /* VARCHAR input (borrowed; valid during the call) */
} ddb_value;

typedef void (*ddb_scalar_fn)(const ddb_value *args, size_t nargs,
                              ddb_value *out, void *extra);

/* Register `fn` as SQL function `name` taking nargs arguments.
 * `extra` is passed through to every invocation.  VARCHAR returns are
 * supported (out->s must stay valid until the next invocation; the
 * engine copies it immediately). */
ddb_state ddb_register_scalar_function(ddb_connection con,
                                       const char *name,
                                       ddb_scalar_fn fn,
                                       ddb_type return_type,
                                       size_t nargs, void *extra);

/* ---- aggregate-function registration (reference:
 * duckdb_create_aggregate_function family, src/include/duckdb.h;
 * ours is a row-wise state ABI — the engine's host holistic-aggregate
 * path folds decoded group values through the callbacks) ------------ */

/* allocate and return a fresh per-group state */
typedef void *(*ddb_agg_init_fn)(void *extra);
/* fold one non-NULL value into the state */
typedef void (*ddb_agg_update_fn)(void *state, const ddb_value *arg,
                                  void *extra);
/* produce the result and FREE the state */
typedef void (*ddb_agg_finalize_fn)(void *state, ddb_value *out,
                                    void *extra);

ddb_state ddb_register_aggregate_function(ddb_connection con,
                                          const char *name,
                                          ddb_agg_init_fn init,
                                          ddb_agg_update_fn update,
                                          ddb_agg_finalize_fn finalize,
                                          ddb_type return_type,
                                          void *extra);

/* ---- table-function registration (reference:
 * duckdb_create_table_function, src/include/duckdb.h) --------------- */

/* Row producer: called with the SQL call's arguments and a 0-based
 * row index; fill out_row[0..ncols) and return 1 to emit the row, or
 * 0 when exhausted.  Strings written to out_row[i].s are copied before
 * the next call. */
typedef int (*ddb_table_fn)(const ddb_value *args, size_t nargs,
                            uint64_t row_idx, ddb_value *out_row,
                            size_t ncols, void *extra);

/* Register `fn` as table function `name` with the given output
 * schema; callable as SELECT * FROM name(...). */
ddb_state ddb_register_table_function(ddb_connection con,
                                      const char *name,
                                      ddb_table_fn fn,
                                      const char **col_names,
                                      const ddb_type *col_types,
                                      size_t ncols, void *extra);

/* ---- columnar (Arrow-compatible) result export (reference:
 * duckdb_result_get_chunk / duckdb_data_chunk + Arrow export,
 * src/main/capi/arrow-c.cpp) --------------------------------------- */

typedef struct {
    /* value buffer: int64_t[] for integer/boolean/temporal columns,
     * double[] for FLOAT/DOUBLE, UTF-8 bytes for VARCHAR (use offsets) */
    const void *data;
    /* Arrow validity bitmap, LSB-first; NULL when all rows are valid */
    const uint8_t *validity;
    /* VARCHAR only: Arrow string offsets[length + 1] into data */
    const int32_t *offsets;
    size_t length;
} ddb_arrow_column;

/* Export one result column as contiguous Arrow-layout buffers; the
 * buffers are owned by the result and freed with it. */
ddb_state ddb_result_arrow_column(ddb_result res, size_t col,
                                  ddb_arrow_column *out);

#ifdef __cplusplus
}
#endif

#endif /* DDB_TPU_C_H */
