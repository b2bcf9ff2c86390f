/* Minimal ADBC (Arrow Database Connectivity) driver shim for ddb_tpu.
 *
 * Declares the subset of the standard ADBC ABI this driver implements
 * (reference: src/common/adbc/ driver + adbc.h spec; the struct layouts
 * below follow the published Arrow ADBC / C data interface ABI, which
 * is a fixed public contract — category (b) intended API-schema
 * similarity).  Results are delivered as an ArrowArrayStream built over
 * the engine's columnar export (ddb_result_arrow_column).
 */
#ifndef DDB_TPU_ADBC_H
#define DDB_TPU_ADBC_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- Arrow C data interface (stable public ABI) ------------------- */

#ifndef ARROW_C_DATA_INTERFACE
#define ARROW_C_DATA_INTERFACE

#define ARROW_FLAG_NULLABLE 2

struct ArrowSchema {
    const char *format;
    const char *name;
    const char *metadata;
    int64_t flags;
    int64_t n_children;
    struct ArrowSchema **children;
    struct ArrowSchema *dictionary;
    void (*release)(struct ArrowSchema *);
    void *private_data;
};

struct ArrowArray {
    int64_t length;
    int64_t null_count;
    int64_t offset;
    int64_t n_buffers;
    int64_t n_children;
    const void **buffers;
    struct ArrowArray **children;
    struct ArrowArray *dictionary;
    void (*release)(struct ArrowArray *);
    void *private_data;
};

#endif /* ARROW_C_DATA_INTERFACE */

#ifndef ARROW_C_STREAM_INTERFACE
#define ARROW_C_STREAM_INTERFACE

struct ArrowArrayStream {
    int (*get_schema)(struct ArrowArrayStream *, struct ArrowSchema *);
    int (*get_next)(struct ArrowArrayStream *, struct ArrowArray *);
    const char *(*get_last_error)(struct ArrowArrayStream *);
    void (*release)(struct ArrowArrayStream *);
    void *private_data;
};

#endif /* ARROW_C_STREAM_INTERFACE */

/* ---- ADBC core types (stable public ABI) -------------------------- */

typedef uint8_t AdbcStatusCode;
#define ADBC_STATUS_OK 0
#define ADBC_STATUS_UNKNOWN 1
#define ADBC_STATUS_NOT_IMPLEMENTED 2
#define ADBC_STATUS_INVALID_STATE 6
#define ADBC_STATUS_INVALID_ARGUMENT 7

struct AdbcError {
    char *message;
    int32_t vendor_code;
    char sqlstate[5];
    void (*release)(struct AdbcError *);
};

struct AdbcDatabase {
    void *private_data;
    void *private_driver;
};

struct AdbcConnection {
    void *private_data;
    void *private_driver;
};

struct AdbcStatement {
    void *private_data;
    void *private_driver;
};

/* ---- entry points implemented by this driver ---------------------- */

AdbcStatusCode AdbcDatabaseNew(struct AdbcDatabase *database,
                               struct AdbcError *error);
/* supported options: "path" (database file; default in-memory), plus
 * any engine setting name (applied per-connection) */
AdbcStatusCode AdbcDatabaseSetOption(struct AdbcDatabase *database,
                                     const char *key, const char *value,
                                     struct AdbcError *error);
AdbcStatusCode AdbcDatabaseInit(struct AdbcDatabase *database,
                                struct AdbcError *error);
AdbcStatusCode AdbcDatabaseRelease(struct AdbcDatabase *database,
                                   struct AdbcError *error);

AdbcStatusCode AdbcConnectionNew(struct AdbcConnection *connection,
                                 struct AdbcError *error);
AdbcStatusCode AdbcConnectionInit(struct AdbcConnection *connection,
                                  struct AdbcDatabase *database,
                                  struct AdbcError *error);
AdbcStatusCode AdbcConnectionRelease(struct AdbcConnection *connection,
                                     struct AdbcError *error);

AdbcStatusCode AdbcStatementNew(struct AdbcConnection *connection,
                                struct AdbcStatement *statement,
                                struct AdbcError *error);
AdbcStatusCode AdbcStatementSetSqlQuery(struct AdbcStatement *statement,
                                        const char *query,
                                        struct AdbcError *error);
/* executes the query; *out becomes a one-batch ArrowArrayStream */
AdbcStatusCode AdbcStatementExecuteQuery(struct AdbcStatement *statement,
                                         struct ArrowArrayStream *out,
                                         int64_t *rows_affected,
                                         struct AdbcError *error);
AdbcStatusCode AdbcStatementRelease(struct AdbcStatement *statement,
                                    struct AdbcError *error);

#ifdef __cplusplus
}
#endif

#endif /* DDB_TPU_ADBC_H */
