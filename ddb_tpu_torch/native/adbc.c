/* ADBC driver shim for ddb_tpu.
 *
 * Implements the ADBC entry points declared in include/ddb_tpu_adbc.h on
 * top of the engine's C API (include/ddb_tpu_c.h): a statement executes
 * through ddb_query and the result is exposed as a one-batch
 * ArrowArrayStream whose buffers come straight from
 * ddb_result_arrow_column (reference: src/common/adbc/adbc.cpp — the
 * reference's driver wraps its own QueryResult the same way).
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "include/ddb_tpu_adbc.h"
#include "include/ddb_tpu_c.h"

/* ------------------------------------------------------------------ */

static void adbc_error_release(struct AdbcError *error) {
    free(error->message);
    error->message = NULL;
    error->release = NULL;
}

static void set_adbc_error(struct AdbcError *error, const char *msg) {
    if (!error) return;
    if (error->release) error->release(error);
    error->message = strdup(msg ? msg : "unknown error");
    error->vendor_code = 0;
    memset(error->sqlstate, 0, sizeof(error->sqlstate));
    error->release = adbc_error_release;
}

struct adbc_db {
    ddb_database db;
    ddb_config cfg;
    char *path;
};

struct adbc_con {
    ddb_connection con;
};

struct adbc_stmt {
    struct adbc_con *con;
    char *sql;
};

/* ---- database ----------------------------------------------------- */

AdbcStatusCode AdbcDatabaseNew(struct AdbcDatabase *database,
                               struct AdbcError *error) {
    if (!database) {
        set_adbc_error(error, "database is NULL");
        return ADBC_STATUS_INVALID_ARGUMENT;
    }
    struct adbc_db *d = calloc(1, sizeof(*d));
    if (!d || ddb_create_config(&d->cfg) != DDB_SUCCESS) {
        free(d);
        set_adbc_error(error, "out of memory");
        return ADBC_STATUS_UNKNOWN;
    }
    database->private_data = d;
    return ADBC_STATUS_OK;
}

AdbcStatusCode AdbcDatabaseSetOption(struct AdbcDatabase *database,
                                     const char *key, const char *value,
                                     struct AdbcError *error) {
    struct adbc_db *d = database ? database->private_data : NULL;
    if (!d || !key) {
        set_adbc_error(error, "bad database/option");
        return ADBC_STATUS_INVALID_ARGUMENT;
    }
    if (strcmp(key, "path") == 0 || strcmp(key, "uri") == 0) {
        free(d->path);
        d->path = value ? strdup(value) : NULL;
        return ADBC_STATUS_OK;
    }
    if (ddb_set_config(d->cfg, key, value ? value : "") != DDB_SUCCESS) {
        set_adbc_error(error, "bad option");
        return ADBC_STATUS_INVALID_ARGUMENT;
    }
    return ADBC_STATUS_OK;
}

AdbcStatusCode AdbcDatabaseInit(struct AdbcDatabase *database,
                                struct AdbcError *error) {
    struct adbc_db *d = database ? database->private_data : NULL;
    if (!d) {
        set_adbc_error(error, "database not created");
        return ADBC_STATUS_INVALID_STATE;
    }
    char *err = NULL;
    if (ddb_open_ext(d->path, &d->db, d->cfg, &err) != DDB_SUCCESS) {
        set_adbc_error(error, err ? err : "open failed");
        free(err);
        return ADBC_STATUS_UNKNOWN;
    }
    return ADBC_STATUS_OK;
}

AdbcStatusCode AdbcDatabaseRelease(struct AdbcDatabase *database,
                                   struct AdbcError *error) {
    (void)error;
    struct adbc_db *d = database ? database->private_data : NULL;
    if (!d) return ADBC_STATUS_OK;
    if (d->db) ddb_close(&d->db);
    if (d->cfg) ddb_destroy_config(&d->cfg);
    free(d->path);
    free(d);
    database->private_data = NULL;
    return ADBC_STATUS_OK;
}

/* ---- connection --------------------------------------------------- */

AdbcStatusCode AdbcConnectionNew(struct AdbcConnection *connection,
                                 struct AdbcError *error) {
    if (!connection) {
        set_adbc_error(error, "connection is NULL");
        return ADBC_STATUS_INVALID_ARGUMENT;
    }
    connection->private_data = calloc(1, sizeof(struct adbc_con));
    return ADBC_STATUS_OK;
}

AdbcStatusCode AdbcConnectionInit(struct AdbcConnection *connection,
                                  struct AdbcDatabase *database,
                                  struct AdbcError *error) {
    struct adbc_con *c = connection ? connection->private_data : NULL;
    struct adbc_db *d = database ? database->private_data : NULL;
    if (!c || !d || !d->db) {
        set_adbc_error(error, "database not initialized");
        return ADBC_STATUS_INVALID_STATE;
    }
    if (ddb_connect(d->db, &c->con) != DDB_SUCCESS) {
        set_adbc_error(error, "connect failed");
        return ADBC_STATUS_UNKNOWN;
    }
    return ADBC_STATUS_OK;
}

AdbcStatusCode AdbcConnectionRelease(struct AdbcConnection *connection,
                                     struct AdbcError *error) {
    (void)error;
    struct adbc_con *c = connection ? connection->private_data : NULL;
    if (!c) return ADBC_STATUS_OK;
    if (c->con) ddb_disconnect(&c->con);
    free(c);
    connection->private_data = NULL;
    return ADBC_STATUS_OK;
}

/* ---- statement ---------------------------------------------------- */

AdbcStatusCode AdbcStatementNew(struct AdbcConnection *connection,
                                struct AdbcStatement *statement,
                                struct AdbcError *error) {
    struct adbc_con *c = connection ? connection->private_data : NULL;
    if (!c || !statement) {
        set_adbc_error(error, "bad connection/statement");
        return ADBC_STATUS_INVALID_ARGUMENT;
    }
    struct adbc_stmt *s = calloc(1, sizeof(*s));
    s->con = c;
    statement->private_data = s;
    return ADBC_STATUS_OK;
}

AdbcStatusCode AdbcStatementSetSqlQuery(struct AdbcStatement *statement,
                                        const char *query,
                                        struct AdbcError *error) {
    struct adbc_stmt *s = statement ? statement->private_data : NULL;
    if (!s || !query) {
        set_adbc_error(error, "bad statement/query");
        return ADBC_STATUS_INVALID_ARGUMENT;
    }
    free(s->sql);
    s->sql = strdup(query);
    return ADBC_STATUS_OK;
}

AdbcStatusCode AdbcStatementRelease(struct AdbcStatement *statement,
                                    struct AdbcError *error) {
    (void)error;
    struct adbc_stmt *s = statement ? statement->private_data : NULL;
    if (!s) return ADBC_STATUS_OK;
    free(s->sql);
    free(s);
    statement->private_data = NULL;
    return ADBC_STATUS_OK;
}

/* ---- result stream over the columnar export ----------------------- */

struct stream_state {
    ddb_result res;            /* owns every exported buffer */
    int batch_emitted;
    char **formats;            /* per-column Arrow format strings */
    struct ArrowSchema **children_schema;
    size_t ncols;
};

static const char *format_of(ddb_type t, uint8_t width, uint8_t scale,
                             char *buf, size_t cap) {
    switch (t) {
    case DDB_TYPE_BOOLEAN:
    case DDB_TYPE_TINYINT:
    case DDB_TYPE_SMALLINT:
    case DDB_TYPE_INTEGER:
    case DDB_TYPE_BIGINT:
    case DDB_TYPE_HUGEINT:
    case DDB_TYPE_DATE:      /* int64 days (engine cell layout) */
    case DDB_TYPE_TIME:
    case DDB_TYPE_INTERVAL:
        return "l";
    case DDB_TYPE_TIMESTAMP:
        return "tsu:";
    case DDB_TYPE_FLOAT:
    case DDB_TYPE_DOUBLE:
        return "g";
    case DDB_TYPE_DECIMAL:
        /* cells lower to double at the C boundary; the declared
         * width/scale survive in the schema metadata via name */
        (void)width; (void)scale; (void)buf; (void)cap;
        return "g";
    default:
        return "u";            /* utf8 (VARCHAR and stringified rest) */
    }
}

static void release_child_schema(struct ArrowSchema *sch) {
    sch->release = NULL;
}

static void release_schema(struct ArrowSchema *sch) {
    if (!sch->release) return;
    for (int64_t i = 0; i < sch->n_children; i++)
        if (sch->children[i] && sch->children[i]->release)
            sch->children[i]->release(sch->children[i]);
    sch->release = NULL;
}

static void release_child_array(struct ArrowArray *a) {
    free(a->buffers);
    a->release = NULL;
}

static void release_array(struct ArrowArray *a) {
    if (!a->release) return;
    for (int64_t i = 0; i < a->n_children; i++) {
        if (a->children[i] && a->children[i]->release)
            a->children[i]->release(a->children[i]);
        free(a->children[i]);
    }
    free(a->children);
    free(a->buffers);
    a->release = NULL;
}

static int stream_get_schema(struct ArrowArrayStream *stream,
                             struct ArrowSchema *out) {
    struct stream_state *st = stream->private_data;
    memset(out, 0, sizeof(*out));
    out->format = "+s";                    /* struct-of-columns batch */
    out->name = "";
    out->n_children = (int64_t)st->ncols;
    out->children = st->children_schema;
    out->release = release_schema;
    return 0;
}

static int stream_get_next(struct ArrowArrayStream *stream,
                           struct ArrowArray *out) {
    struct stream_state *st = stream->private_data;
    memset(out, 0, sizeof(*out));
    if (st->batch_emitted) {
        out->release = NULL;               /* end of stream */
        return 0;
    }
    st->batch_emitted = 1;
    size_t nrows = ddb_row_count(st->res);
    out->length = (int64_t)nrows;
    out->null_count = -1;
    out->n_buffers = 1;
    out->buffers = calloc(1, sizeof(void *));
    out->n_children = (int64_t)st->ncols;
    out->children = calloc(st->ncols ? st->ncols : 1,
                           sizeof(struct ArrowArray *));
    for (size_t j = 0; j < st->ncols; j++) {
        ddb_arrow_column col;
        if (ddb_result_arrow_column(st->res, j, &col) != DDB_SUCCESS)
            return 1;
        struct ArrowArray *ch = calloc(1, sizeof(*ch));
        ch->length = (int64_t)nrows;
        ch->null_count = -1;
        int is_str = st->formats[j][0] == 'u';
        ch->n_buffers = is_str ? 3 : 2;
        ch->buffers = calloc((size_t)ch->n_buffers, sizeof(void *));
        ch->buffers[0] = col.validity;
        if (is_str) {
            ch->buffers[1] = col.offsets;
            ch->buffers[2] = col.data;
        } else {
            ch->buffers[1] = col.data;
        }
        ch->release = release_child_array;
        out->children[j] = ch;
    }
    out->release = release_array;
    return 0;
}

static const char *stream_get_last_error(struct ArrowArrayStream *s) {
    (void)s;
    return NULL;
}

static void stream_release(struct ArrowArrayStream *stream) {
    struct stream_state *st = stream->private_data;
    if (!st) return;
    for (size_t j = 0; j < st->ncols; j++) {
        free(st->formats[j]);
        free(st->children_schema[j]);
    }
    free(st->formats);
    free(st->children_schema);
    ddb_destroy_result(&st->res);
    free(st);
    stream->private_data = NULL;
    stream->release = NULL;
}

AdbcStatusCode AdbcStatementExecuteQuery(struct AdbcStatement *statement,
                                         struct ArrowArrayStream *out,
                                         int64_t *rows_affected,
                                         struct AdbcError *error) {
    struct adbc_stmt *s = statement ? statement->private_data : NULL;
    if (!s || !s->sql) {
        set_adbc_error(error, "no query set");
        return ADBC_STATUS_INVALID_STATE;
    }
    ddb_result res = NULL;
    if (ddb_query(s->con->con, s->sql, &res) != DDB_SUCCESS) {
        set_adbc_error(error, ddb_error_message(s->con->con));
        return ADBC_STATUS_UNKNOWN;
    }
    if (rows_affected)
        *rows_affected = (int64_t)ddb_row_count(res);
    if (!out) {
        ddb_destroy_result(&res);
        return ADBC_STATUS_OK;
    }
    struct stream_state *st = calloc(1, sizeof(*st));
    st->res = res;
    st->ncols = ddb_column_count(res);
    st->formats = calloc(st->ncols ? st->ncols : 1, sizeof(char *));
    st->children_schema = calloc(st->ncols ? st->ncols : 1,
                                 sizeof(struct ArrowSchema *));
    for (size_t j = 0; j < st->ncols; j++) {
        ddb_logical_type lt = ddb_column_logical_type(res, j);
        char buf[32];
        const char *fmt = format_of(ddb_column_type(res, j),
                                    ddb_decimal_width(lt),
                                    ddb_decimal_scale(lt), buf,
                                    sizeof(buf));
        ddb_destroy_logical_type(&lt);
        st->formats[j] = strdup(fmt);
        struct ArrowSchema *cs = calloc(1, sizeof(*cs));
        cs->format = st->formats[j];
        cs->name = ddb_column_name(res, j);
        cs->flags = ARROW_FLAG_NULLABLE;
        cs->release = release_child_schema;
        st->children_schema[j] = cs;
    }
    memset(out, 0, sizeof(*out));
    out->get_schema = stream_get_schema;
    out->get_next = stream_get_next;
    out->get_last_error = stream_get_last_error;
    out->release = stream_release;
    out->private_data = st;
    return ADBC_STATUS_OK;
}
