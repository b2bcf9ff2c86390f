/* ddb_tpu C API implementation.
 *
 * Hosts the ddb_tpu_torch engine (PyTorch) in an embedded CPython
 * interpreter and exposes the duckdb.h-shaped stable ABI declared in
 * include/ddb_tpu_c.h (reference: src/main/capi/ *.cpp backing
 * src/include/duckdb.h).  All engine calls go through the narrow bridge
 * module ddb_tpu_torch.capi_bridge; results are materialized into C-side
 * column arrays at query time so value accessors are plain reads.
 *
 * Thread-safety: every entry point takes the GIL; the engine connection
 * itself follows the Python API's locking.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdlib.h>
#include <string.h>

#include "include/ddb_tpu_c.h"

/* ------------------------------------------------------------------ */

struct ddb_database_t {
    PyObject *handle;          /* bridge.open_database(...) result */
};

struct ddb_connection_t {
    PyObject *con;             /* ddb_tpu Connection */
    char *last_error;
};

typedef struct {
    int is_null;
    int64_t i;
    double d;
    char *s;                   /* owned UTF-8 copy (VARCHAR-likes) */
} ddb_cell;

struct ddb_result_t {
    size_t ncols, nrows;
    char **names;
    ddb_type *types;
    uint8_t *widths, *scales;  /* DECIMAL metadata per column */
    ddb_cell **cols;           /* [col][row] */
    /* lazily-built Arrow-layout export buffers (per column) */
    void **abuf;
    uint8_t **avalid;
    int32_t **aoffs;
};

struct ddb_config_t {
    char **names;
    char **values;
    size_t n, cap;
};

struct ddb_logical_type_t {
    ddb_type id;
    uint8_t width, scale;
    struct ddb_logical_type_t *child;   /* LIST element */
};

struct ddb_prepared_t {
    struct ddb_connection_t *con;
    char *sql;
    size_t nparams;
    PyObject *params;          /* list, pre-sized */
};

struct ddb_appender_t {
    struct ddb_connection_t *con;
    PyObject *app;             /* ddb_tpu Appender */
    PyObject *row;             /* list being built */
    PyObject *rows;            /* buffered rows */
};

static PyObject *g_bridge = NULL;

/* ------------------------------------------------------------------ */

static void set_error(struct ddb_connection_t *con, const char *msg) {
    if (!con) return;
    free(con->last_error);
    con->last_error = msg ? strdup(msg) : NULL;
}

static void set_py_error(struct ddb_connection_t *con) {
    PyObject *type, *value, *tb;
    PyErr_Fetch(&type, &value, &tb);
    PyErr_NormalizeException(&type, &value, &tb);
    if (value) {
        PyObject *s = PyObject_Str(value);
        if (s) {
            const char *msg = PyUnicode_AsUTF8(s);
            set_error(con, msg ? msg : "unknown python error");
            Py_DECREF(s);
        }
    } else {
        set_error(con, "unknown python error");
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
}

static int ensure_bridge(void) {
    if (g_bridge) return 0;
    if (!Py_IsInitialized()) {
        /* the bridge connects on the torch device that
         * DDB_CAPI_PLATFORM names, the card when it is unset */
        Py_InitializeEx(0);
        /* drop the GIL so other C threads can enter via PyGILState */
        PyEval_SaveThread();
    }
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *mod = PyImport_ImportModule("ddb_tpu_torch.capi_bridge");
    if (!mod) {
        PyErr_Print();
        PyGILState_Release(st);
        return -1;
    }
    g_bridge = mod;
    PyGILState_Release(st);
    return 0;
}

/* ------------------------------------------------------------------ */

ddb_state ddb_open(const char *path, ddb_database *out_db) {
    if (!out_db) return DDB_ERROR;
    *out_db = NULL;
    if (ensure_bridge() != 0) return DDB_ERROR;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *h = PyObject_CallMethod(g_bridge, "open_database", "z",
                                      path);
    if (!h) {
        PyErr_Print();
        PyGILState_Release(st);
        return DDB_ERROR;
    }
    struct ddb_database_t *db = calloc(1, sizeof(*db));
    db->handle = h;
    PyGILState_Release(st);
    *out_db = db;
    return DDB_SUCCESS;
}

void ddb_close(ddb_database *db) {
    if (!db || !*db) return;
    PyGILState_STATE st = PyGILState_Ensure();
    Py_XDECREF((*db)->handle);
    PyGILState_Release(st);
    free(*db);
    *db = NULL;
}

ddb_state ddb_connect(ddb_database db, ddb_connection *out_con) {
    if (!db || !out_con) return DDB_ERROR;
    *out_con = NULL;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *con = PyObject_CallMethod(g_bridge, "connect", "O",
                                        db->handle);
    if (!con) {
        PyErr_Print();
        PyGILState_Release(st);
        return DDB_ERROR;
    }
    struct ddb_connection_t *c = calloc(1, sizeof(*c));
    c->con = con;
    PyGILState_Release(st);
    *out_con = c;
    return DDB_SUCCESS;
}

void ddb_disconnect(ddb_connection *con) {
    if (!con || !*con) return;
    PyGILState_STATE st = PyGILState_Ensure();
    Py_XDECREF((*con)->con);
    PyGILState_Release(st);
    free((*con)->last_error);
    free(*con);
    *con = NULL;
}

const char *ddb_error_message(ddb_connection con) {
    return con && con->last_error ? con->last_error : "";
}

/* ------------------------------------------------------------------ */

static struct ddb_result_t *materialize(PyObject *triple,
                                        struct ddb_connection_t *con) {
    /* triple = (names, type_codes, columns) from the bridge */
    PyObject *names = PyTuple_GetItem(triple, 0);
    PyObject *codes = PyTuple_GetItem(triple, 1);
    PyObject *cols = PyTuple_GetItem(triple, 2);
    if (!names || !codes || !cols) {
        set_error(con, "malformed bridge result");
        return NULL;
    }
    size_t ncols = (size_t)PyList_Size(names);
    size_t nrows = ncols ? (size_t)PyList_Size(PyList_GetItem(cols, 0))
                         : 0;
    struct ddb_result_t *r = calloc(1, sizeof(*r));
    r->ncols = ncols;
    r->nrows = nrows;
    r->names = calloc(ncols ? ncols : 1, sizeof(char *));
    r->types = calloc(ncols ? ncols : 1, sizeof(ddb_type));
    r->widths = calloc(ncols ? ncols : 1, 1);
    r->scales = calloc(ncols ? ncols : 1, 1);
    r->cols = calloc(ncols ? ncols : 1, sizeof(ddb_cell *));
    /* optional 4th element: per-column (width, scale) DECIMAL meta */
    PyObject *meta = PyTuple_Size(triple) > 3
                         ? PyTuple_GetItem(triple, 3) : NULL;
    if (meta && PyList_Check(meta)) {
        for (size_t j = 0; j < ncols
                           && j < (size_t)PyList_Size(meta); j++) {
            PyObject *ws = PyList_GetItem(meta, j);
            if (ws && PyTuple_Check(ws) && PyTuple_Size(ws) == 2) {
                r->widths[j] =
                    (uint8_t)PyLong_AsLong(PyTuple_GetItem(ws, 0));
                r->scales[j] =
                    (uint8_t)PyLong_AsLong(PyTuple_GetItem(ws, 1));
            }
        }
        if (PyErr_Occurred()) PyErr_Clear();
    }
    for (size_t j = 0; j < ncols; j++) {
        const char *nm = PyUnicode_AsUTF8(PyList_GetItem(names, j));
        r->names[j] = strdup(nm ? nm : "");
        r->types[j] =
            (ddb_type)PyLong_AsLong(PyList_GetItem(codes, j));
        r->cols[j] = calloc(nrows ? nrows : 1, sizeof(ddb_cell));
        PyObject *col = PyList_GetItem(cols, j);
        for (size_t i = 0; i < nrows; i++) {
            PyObject *v = PyList_GetItem(col, i);
            ddb_cell *cell = &r->cols[j][i];
            if (v == Py_None) {
                cell->is_null = 1;
            } else if (PyBool_Check(v)) {
                cell->i = (v == Py_True);
                cell->d = (double)cell->i;
            } else if (PyLong_Check(v)) {
                cell->i = PyLong_AsLongLong(v);
                cell->d = (double)cell->i;
            } else if (PyFloat_Check(v)) {
                cell->d = PyFloat_AsDouble(v);
                cell->i = (int64_t)cell->d;
            } else if (PyBytes_Check(v)) {
                cell->s = strdup(PyBytes_AsString(v));
            } else {
                const char *s = PyUnicode_AsUTF8(v);
                cell->s = strdup(s ? s : "");
            }
            if (PyErr_Occurred()) PyErr_Clear();
        }
    }
    return r;
}

ddb_state ddb_query(ddb_connection con, const char *sql,
                    ddb_result *out_result) {
    if (!con || !sql) return DDB_ERROR;
    if (out_result) *out_result = NULL;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *triple = PyObject_CallMethod(g_bridge, "query", "Os",
                                           con->con, sql);
    if (!triple) {
        set_py_error(con);
        PyGILState_Release(st);
        return DDB_ERROR;
    }
    set_error(con, NULL);
    if (out_result) {
        *out_result = materialize(triple, con);
        if (!*out_result) {
            Py_DECREF(triple);
            PyGILState_Release(st);
            return DDB_ERROR;
        }
    }
    Py_DECREF(triple);
    PyGILState_Release(st);
    return DDB_SUCCESS;
}

void ddb_destroy_result(ddb_result *res) {
    if (!res || !*res) return;
    struct ddb_result_t *r = *res;
    for (size_t j = 0; j < r->ncols; j++) {
        for (size_t i = 0; i < r->nrows; i++) free(r->cols[j][i].s);
        free(r->cols[j]);
        free(r->names[j]);
    }
    free(r->cols);
    free(r->names);
    free(r->types);
    free(r->widths);
    free(r->scales);
    if (r->abuf) {
        for (size_t j = 0; j < r->ncols; j++) {
            free(r->abuf[j]);
            if (r->avalid) free(r->avalid[j]);
            if (r->aoffs) free(r->aoffs[j]);
        }
        free(r->abuf);
        free(r->avalid);
        free(r->aoffs);
    }
    free(r);
    *res = NULL;
}

size_t ddb_column_count(ddb_result res) { return res ? res->ncols : 0; }
size_t ddb_row_count(ddb_result res) { return res ? res->nrows : 0; }

const char *ddb_column_name(ddb_result res, size_t col) {
    return (res && col < res->ncols) ? res->names[col] : NULL;
}

ddb_type ddb_column_type(ddb_result res, size_t col) {
    return (res && col < res->ncols) ? res->types[col]
                                     : DDB_TYPE_INVALID;
}

static const ddb_cell *cell_at(ddb_result res, size_t col, size_t row) {
    if (!res || col >= res->ncols || row >= res->nrows) return NULL;
    return &res->cols[col][row];
}

bool ddb_value_is_null(ddb_result res, size_t col, size_t row) {
    const ddb_cell *c = cell_at(res, col, row);
    return c ? c->is_null != 0 : true;
}

bool ddb_value_boolean(ddb_result res, size_t col, size_t row) {
    const ddb_cell *c = cell_at(res, col, row);
    return c && !c->is_null && c->i != 0;
}

int64_t ddb_value_int64(ddb_result res, size_t col, size_t row) {
    const ddb_cell *c = cell_at(res, col, row);
    if (!c || c->is_null) return 0;
    if (c->s) return strtoll(c->s, NULL, 10);
    return c->i;
}

double ddb_value_double(ddb_result res, size_t col, size_t row) {
    const ddb_cell *c = cell_at(res, col, row);
    if (!c || c->is_null) return 0.0;
    if (c->s) return strtod(c->s, NULL);
    return c->d;
}

const char *ddb_value_varchar(ddb_result res, size_t col, size_t row) {
    const ddb_cell *c = cell_at(res, col, row);
    if (!c || c->is_null) return NULL;
    if (c->s) return c->s;
    /* lazily render numerics; cache on the cell so the pointer stays
     * valid until destroy */
    char buf[64];
    ddb_cell *w = (ddb_cell *)c;
    if (res->types[col] == DDB_TYPE_DOUBLE
        || res->types[col] == DDB_TYPE_FLOAT
        || res->types[col] == DDB_TYPE_DECIMAL) {
        snprintf(buf, sizeof buf, "%g", c->d);
    } else {
        snprintf(buf, sizeof buf, "%lld", (long long)c->i);
    }
    w->s = strdup(buf);
    return w->s;
}

/* ------------------------------------------------------------------ */

ddb_state ddb_prepare(ddb_connection con, const char *sql,
                      ddb_prepared *out_prepared) {
    if (!con || !sql || !out_prepared) return DDB_ERROR;
    size_t nparams = 0;
    for (const char *p = sql; *p; p++)
        if (*p == '?') nparams++;
    struct ddb_prepared_t *s = calloc(1, sizeof(*s));
    s->con = con;
    s->sql = strdup(sql);
    s->nparams = nparams;
    PyGILState_STATE st = PyGILState_Ensure();
    s->params = PyList_New((Py_ssize_t)nparams);
    for (size_t i = 0; i < nparams; i++) {
        Py_INCREF(Py_None);
        PyList_SET_ITEM(s->params, (Py_ssize_t)i, Py_None);
    }
    PyGILState_Release(st);
    *out_prepared = s;
    return DDB_SUCCESS;
}

void ddb_destroy_prepare(ddb_prepared *stmt) {
    if (!stmt || !*stmt) return;
    PyGILState_STATE st = PyGILState_Ensure();
    Py_XDECREF((*stmt)->params);
    PyGILState_Release(st);
    free((*stmt)->sql);
    free(*stmt);
    *stmt = NULL;
}

static ddb_state bind_obj(ddb_prepared stmt, size_t idx, PyObject *v) {
    /* takes ownership of v; param_idx is 1-based like the reference */
    if (!stmt || idx < 1 || idx > stmt->nparams) {
        Py_XDECREF(v);
        return DDB_ERROR;
    }
    PyList_SetItem(stmt->params, (Py_ssize_t)(idx - 1), v);
    return DDB_SUCCESS;
}

ddb_state ddb_bind_int64(ddb_prepared stmt, size_t i, int64_t v) {
    PyGILState_STATE st = PyGILState_Ensure();
    ddb_state r = bind_obj(stmt, i, PyLong_FromLongLong(v));
    PyGILState_Release(st);
    return r;
}

ddb_state ddb_bind_double(ddb_prepared stmt, size_t i, double v) {
    PyGILState_STATE st = PyGILState_Ensure();
    ddb_state r = bind_obj(stmt, i, PyFloat_FromDouble(v));
    PyGILState_Release(st);
    return r;
}

ddb_state ddb_bind_varchar(ddb_prepared stmt, size_t i, const char *v) {
    PyGILState_STATE st = PyGILState_Ensure();
    ddb_state r = bind_obj(stmt, i, PyUnicode_FromString(v ? v : ""));
    PyGILState_Release(st);
    return r;
}

ddb_state ddb_bind_null(ddb_prepared stmt, size_t i) {
    PyGILState_STATE st = PyGILState_Ensure();
    Py_INCREF(Py_None);
    ddb_state r = bind_obj(stmt, i, Py_None);
    PyGILState_Release(st);
    return r;
}

ddb_state ddb_execute_prepared(ddb_prepared stmt, ddb_result *out) {
    if (!stmt) return DDB_ERROR;
    if (out) *out = NULL;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *triple = PyObject_CallMethod(
        g_bridge, "query_with", "OsO", stmt->con->con, stmt->sql,
        stmt->params);
    if (!triple) {
        set_py_error(stmt->con);
        PyGILState_Release(st);
        return DDB_ERROR;
    }
    set_error(stmt->con, NULL);
    if (out) *out = materialize(triple, stmt->con);
    Py_DECREF(triple);
    PyGILState_Release(st);
    return (out && !*out) ? DDB_ERROR : DDB_SUCCESS;
}

/* ------------------------------------------------------------------ */

ddb_state ddb_appender_create(ddb_connection con, const char *schema,
                              const char *table, ddb_appender *out) {
    (void)schema;   /* single-schema engine: 'main' */
    if (!con || !table || !out) return DDB_ERROR;
    *out = NULL;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *app = PyObject_CallMethod(g_bridge, "appender_create",
                                        "Os", con->con, table);
    if (!app) {
        set_py_error(con);
        PyGILState_Release(st);
        return DDB_ERROR;
    }
    struct ddb_appender_t *a = calloc(1, sizeof(*a));
    a->con = con;
    a->app = app;
    a->row = PyList_New(0);
    a->rows = PyList_New(0);
    PyGILState_Release(st);
    *out = a;
    return DDB_SUCCESS;
}

static ddb_state append_obj(ddb_appender app, PyObject *v) {
    if (!app || !v) {
        Py_XDECREF(v);
        return DDB_ERROR;
    }
    PyList_Append(app->row, v);
    Py_DECREF(v);
    return DDB_SUCCESS;
}

ddb_state ddb_append_int64(ddb_appender app, int64_t v) {
    PyGILState_STATE st = PyGILState_Ensure();
    ddb_state r = append_obj(app, PyLong_FromLongLong(v));
    PyGILState_Release(st);
    return r;
}

ddb_state ddb_append_double(ddb_appender app, double v) {
    PyGILState_STATE st = PyGILState_Ensure();
    ddb_state r = append_obj(app, PyFloat_FromDouble(v));
    PyGILState_Release(st);
    return r;
}

ddb_state ddb_append_varchar(ddb_appender app, const char *v) {
    PyGILState_STATE st = PyGILState_Ensure();
    ddb_state r = append_obj(app, PyUnicode_FromString(v ? v : ""));
    PyGILState_Release(st);
    return r;
}

ddb_state ddb_append_null(ddb_appender app) {
    PyGILState_STATE st = PyGILState_Ensure();
    Py_INCREF(Py_None);
    ddb_state r = append_obj(app, Py_None);
    PyGILState_Release(st);
    return r;
}

ddb_state ddb_appender_end_row(ddb_appender app) {
    if (!app) return DDB_ERROR;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *tup = PyList_AsTuple(app->row);
    PyList_Append(app->rows, tup);
    Py_DECREF(tup);
    Py_DECREF(app->row);
    app->row = PyList_New(0);
    PyGILState_Release(st);
    return DDB_SUCCESS;
}

ddb_state ddb_appender_flush(ddb_appender app) {
    if (!app) return DDB_ERROR;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(g_bridge, "appender_rows", "OO",
                                      app->app, app->rows);
    if (!r) {
        set_py_error(app->con);
        PyGILState_Release(st);
        return DDB_ERROR;
    }
    Py_DECREF(r);
    Py_DECREF(app->rows);
    app->rows = PyList_New(0);
    r = PyObject_CallMethod(g_bridge, "appender_flush", "O", app->app);
    if (!r) {
        set_py_error(app->con);
        PyGILState_Release(st);
        return DDB_ERROR;
    }
    Py_DECREF(r);
    PyGILState_Release(st);
    return DDB_SUCCESS;
}

ddb_state ddb_appender_destroy(ddb_appender *app) {
    if (!app || !*app) return DDB_ERROR;
    ddb_state r = ddb_appender_flush(*app);
    PyGILState_STATE st = PyGILState_Ensure();
    Py_XDECREF((*app)->app);
    Py_XDECREF((*app)->row);
    Py_XDECREF((*app)->rows);
    PyGILState_Release(st);
    free(*app);
    *app = NULL;
    return r;
}

/* ------------------------------------------------------------------ */
/* scalar UDF registration: a C callback becomes a Python callable via
 * a PyCFunction trampoline closed over a capsule, then registers
 * through Connection.create_function — the engine's pure_callback UDF
 * machinery vectorizes around the row-wise C call (reference:
 * duckdb_create_scalar_function, src/main/capi/scalar_function-c.cpp). */

struct ddb_scalar_ctx {
    ddb_scalar_fn fn;
    size_t nargs;
    void *extra;
    ddb_type ret;
};

static void scalar_ctx_free(PyObject *capsule) {
    void *p = PyCapsule_GetPointer(capsule, "ddb_scalar_ctx");
    free(p);
}

static PyObject *scalar_trampoline(PyObject *self, PyObject *args) {
    struct ddb_scalar_ctx *ctx =
        PyCapsule_GetPointer(self, "ddb_scalar_ctx");
    if (!ctx) return NULL;
    size_t n = (size_t)PyTuple_Size(args);
    if (n != ctx->nargs) {
        PyErr_SetString(PyExc_TypeError, "udf argument count mismatch");
        return NULL;
    }
    ddb_value vals[16];
    PyObject *strrefs[16] = {0};
    if (n > 16) {
        PyErr_SetString(PyExc_TypeError, "udf supports up to 16 args");
        return NULL;
    }
    for (size_t k = 0; k < n; k++) {
        PyObject *a = PyTuple_GetItem(args, k);
        ddb_value *v = &vals[k];
        memset(v, 0, sizeof(*v));
        if (a == Py_None) {
            v->is_null = 1;
        } else if (PyBool_Check(a)) {
            v->i = (a == Py_True);
            v->d = (double)v->i;
        } else if (PyLong_Check(a)) {
            v->i = PyLong_AsLongLong(a);
            v->d = (double)v->i;
        } else if (PyFloat_Check(a)) {
            v->d = PyFloat_AsDouble(a);
            v->i = (int64_t)v->d;
        } else if (PyUnicode_Check(a)) {
            strrefs[k] = PyUnicode_AsUTF8String(a);
            if (!strrefs[k]) return NULL;
            v->s = PyBytes_AsString(strrefs[k]);
        } else if (PyIndex_Check(a)) {       /* numpy integer scalars */
            PyObject *li = PyNumber_Index(a);
            if (!li) return NULL;
            v->i = PyLong_AsLongLong(li);
            v->d = (double)v->i;
            Py_DECREF(li);
        } else {
            double dv = PyFloat_AsDouble(a); /* numpy float scalars */
            if (dv == -1.0 && PyErr_Occurred()) {
                PyErr_Clear();
                v->is_null = 1;
            } else {
                v->d = dv;
                v->i = (int64_t)dv;
            }
        }
    }
    ddb_value out;
    memset(&out, 0, sizeof(out));
    ctx->fn(vals, n, &out, ctx->extra);
    for (size_t k = 0; k < n; k++) Py_XDECREF(strrefs[k]);
    if (out.is_null) Py_RETURN_NONE;
    if (ctx->ret == DDB_TYPE_FLOAT || ctx->ret == DDB_TYPE_DOUBLE)
        return PyFloat_FromDouble(out.d);
    if (ctx->ret == DDB_TYPE_BOOLEAN)
        return PyBool_FromLong(out.i != 0);
    return PyLong_FromLongLong(out.i);
}

static PyMethodDef scalar_trampoline_def = {
    "__ddb_scalar__", scalar_trampoline, METH_VARARGS, NULL};

ddb_state ddb_register_scalar_function(ddb_connection con,
                                       const char *name,
                                       ddb_scalar_fn fn,
                                       ddb_type return_type,
                                       size_t nargs, void *extra) {
    if (!con || !name || !fn || nargs > 16) return DDB_ERROR;
    if (ensure_bridge() != 0) return DDB_ERROR;
    PyGILState_STATE st = PyGILState_Ensure();
    struct ddb_scalar_ctx *ctx = calloc(1, sizeof(*ctx));
    ctx->fn = fn;
    ctx->nargs = nargs;
    ctx->extra = extra;
    ctx->ret = return_type;
    PyObject *capsule = PyCapsule_New(ctx, "ddb_scalar_ctx",
                                      scalar_ctx_free);
    if (!capsule) {
        free(ctx);
        PyGILState_Release(st);
        return DDB_ERROR;
    }
    PyObject *callable = PyCFunction_New(&scalar_trampoline_def,
                                         capsule);
    Py_DECREF(capsule);          /* callable holds the reference */
    if (!callable) {
        PyGILState_Release(st);
        return DDB_ERROR;
    }
    PyObject *r = PyObject_CallMethod(g_bridge, "register_scalar",
                                      "OsOi", con->con, name, callable,
                                      (int)return_type);
    Py_DECREF(callable);
    if (!r) {
        set_py_error(con);
        PyGILState_Release(st);
        return DDB_ERROR;
    }
    Py_DECREF(r);
    PyGILState_Release(st);
    return DDB_SUCCESS;
}

/* ------------------------------------------------------------------ */
/* columnar (Arrow-compatible) export: lazily build contiguous typed
 * buffers + validity bitmaps from the materialized cells (reference:
 * duckdb_result_get_chunk / arrow export, src/main/capi/arrow-c.cpp). */

ddb_state ddb_result_arrow_column(ddb_result res, size_t col,
                                  ddb_arrow_column *out) {
    if (!res || !out || col >= res->ncols) return DDB_ERROR;
    if (!res->abuf) {
        res->abuf = calloc(res->ncols, sizeof(void *));
        res->avalid = calloc(res->ncols, sizeof(uint8_t *));
        res->aoffs = calloc(res->ncols, sizeof(int32_t *));
        if (!res->abuf || !res->avalid || !res->aoffs) return DDB_ERROR;
    }
    size_t n = res->nrows;
    if (!res->abuf[col]) {
        ddb_cell *cells = res->cols[col];
        ddb_type t = res->types[col];
        int has_null = 0;
        for (size_t i = 0; i < n; i++)
            if (cells[i].is_null) { has_null = 1; break; }
        if (has_null) {
            uint8_t *bm = calloc((n + 7) / 8, 1);
            if (!bm) return DDB_ERROR;
            for (size_t i = 0; i < n; i++)
                if (!cells[i].is_null) bm[i >> 3] |= (uint8_t)(1u << (i & 7));
            res->avalid[col] = bm;
        }
        if (t == DDB_TYPE_VARCHAR || t == DDB_TYPE_BLOB) {
            int32_t *offs = malloc((n + 1) * sizeof(int32_t));
            if (!offs) return DDB_ERROR;
            size_t total = 0;
            offs[0] = 0;
            for (size_t i = 0; i < n; i++) {
                size_t l = (!cells[i].is_null && cells[i].s)
                           ? strlen(cells[i].s) : 0;
                total += l;
                offs[i + 1] = (int32_t)total;
            }
            char *buf = malloc(total ? total : 1);
            if (!buf) { free(offs); return DDB_ERROR; }
            for (size_t i = 0; i < n; i++) {
                size_t l = (size_t)(offs[i + 1] - offs[i]);
                if (l) memcpy(buf + offs[i], cells[i].s, l);
            }
            res->abuf[col] = buf;
            res->aoffs[col] = offs;
        } else if (t == DDB_TYPE_FLOAT || t == DDB_TYPE_DOUBLE
                   || t == DDB_TYPE_DECIMAL) {
            /* DECIMAL cells are lowered to double at the bridge; the
             * declared width/scale stay readable via
             * ddb_column_logical_type */
            double *buf = malloc(n ? n * sizeof(double) : 1);
            if (!buf) return DDB_ERROR;
            for (size_t i = 0; i < n; i++)
                buf[i] = cells[i].is_null ? 0.0 : cells[i].d;
            res->abuf[col] = buf;
        } else {
            int64_t *buf = malloc(n ? n * sizeof(int64_t) : 1);
            if (!buf) return DDB_ERROR;
            for (size_t i = 0; i < n; i++)
                buf[i] = cells[i].is_null ? 0 : cells[i].i;
            res->abuf[col] = buf;
        }
    }
    out->data = res->abuf[col];
    out->validity = res->avalid[col];
    out->offsets = res->aoffs[col];
    out->length = n;
    return DDB_SUCCESS;
}

/* ------------------------------------------------------------------ */
/* table-function registration: a C row producer becomes a Python
 * callable that materializes the full row list per call; the engine
 * wraps it via Connection.create_table_function (reference:
 * duckdb_create_table_function, src/main/capi/table_function-c.cpp). */

struct ddb_table_ctx {
    ddb_table_fn fn;
    size_t ncols;
    void *extra;
    ddb_type types[32];
};

static void table_ctx_free(PyObject *capsule) {
    void *p = PyCapsule_GetPointer(capsule, "ddb_table_ctx");
    free(p);
}

static PyObject *table_trampoline(PyObject *self, PyObject *args) {
    struct ddb_table_ctx *ctx =
        PyCapsule_GetPointer(self, "ddb_table_ctx");
    if (!ctx) return NULL;
    size_t nargs = (size_t)PyTuple_Size(args);
    if (nargs > 16) {
        PyErr_SetString(PyExc_TypeError,
                        "table function supports up to 16 args");
        return NULL;
    }
    ddb_value vals[16];
    PyObject *strrefs[16] = {0};
    for (size_t k = 0; k < nargs; k++) {
        PyObject *a = PyTuple_GetItem(args, k);
        ddb_value *v = &vals[k];
        memset(v, 0, sizeof(*v));
        if (a == Py_None) {
            v->is_null = 1;
        } else if (PyBool_Check(a)) {
            v->i = (a == Py_True);
            v->d = (double)v->i;
        } else if (PyLong_Check(a)) {
            v->i = PyLong_AsLongLong(a);
            v->d = (double)v->i;
        } else if (PyFloat_Check(a)) {
            v->d = PyFloat_AsDouble(a);
            v->i = (int64_t)v->d;
        } else if (PyUnicode_Check(a)) {
            strrefs[k] = PyUnicode_AsUTF8String(a);
            if (!strrefs[k]) return NULL;
            v->s = PyBytes_AsString(strrefs[k]);
        }
    }
    PyObject *rows = PyList_New(0);
    if (!rows) goto fail;
    for (uint64_t idx = 0;; idx++) {
        ddb_value row[32];
        memset(row, 0, sizeof(row));
        if (!ctx->fn(vals, nargs, idx, row, ctx->ncols, ctx->extra))
            break;
        PyObject *tup = PyTuple_New((Py_ssize_t)ctx->ncols);
        if (!tup) goto fail;
        for (size_t j = 0; j < ctx->ncols; j++) {
            PyObject *cell;
            if (row[j].is_null) {
                cell = Py_None;
                Py_INCREF(cell);
            } else if (ctx->types[j] == DDB_TYPE_FLOAT
                       || ctx->types[j] == DDB_TYPE_DOUBLE) {
                cell = PyFloat_FromDouble(row[j].d);
            } else if (ctx->types[j] == DDB_TYPE_VARCHAR) {
                cell = PyUnicode_FromString(row[j].s ? row[j].s : "");
            } else if (ctx->types[j] == DDB_TYPE_BOOLEAN) {
                cell = PyBool_FromLong(row[j].i != 0);
            } else {
                cell = PyLong_FromLongLong(row[j].i);
            }
            if (!cell) { Py_DECREF(tup); goto fail; }
            PyTuple_SET_ITEM(tup, (Py_ssize_t)j, cell);
        }
        if (PyList_Append(rows, tup) != 0) { Py_DECREF(tup); goto fail; }
        Py_DECREF(tup);
    }
    for (size_t k = 0; k < nargs; k++) Py_XDECREF(strrefs[k]);
    return rows;
fail:
    for (size_t k = 0; k < nargs; k++) Py_XDECREF(strrefs[k]);
    Py_XDECREF(rows);
    return NULL;
}

static PyMethodDef table_trampoline_def = {
    "__ddb_table__", table_trampoline, METH_VARARGS, NULL};

ddb_state ddb_register_table_function(ddb_connection con,
                                      const char *name,
                                      ddb_table_fn fn,
                                      const char **col_names,
                                      const ddb_type *col_types,
                                      size_t ncols, void *extra) {
    if (!con || !name || !fn || !col_names || !col_types
        || ncols == 0 || ncols > 32)
        return DDB_ERROR;
    if (ensure_bridge() != 0) return DDB_ERROR;
    PyGILState_STATE st = PyGILState_Ensure();
    struct ddb_table_ctx *ctx = calloc(1, sizeof(*ctx));
    ctx->fn = fn;
    ctx->ncols = ncols;
    ctx->extra = extra;
    for (size_t j = 0; j < ncols; j++) ctx->types[j] = col_types[j];
    PyObject *capsule = PyCapsule_New(ctx, "ddb_table_ctx",
                                      table_ctx_free);
    if (!capsule) {
        free(ctx);
        PyGILState_Release(st);
        return DDB_ERROR;
    }
    PyObject *callable = PyCFunction_New(&table_trampoline_def, capsule);
    Py_DECREF(capsule);
    if (!callable) {
        PyGILState_Release(st);
        return DDB_ERROR;
    }
    PyObject *names = PyList_New((Py_ssize_t)ncols);
    PyObject *codes = PyList_New((Py_ssize_t)ncols);
    for (size_t j = 0; j < ncols; j++) {
        PyList_SET_ITEM(names, (Py_ssize_t)j,
                        PyUnicode_FromString(col_names[j]));
        PyList_SET_ITEM(codes, (Py_ssize_t)j,
                        PyLong_FromLong((long)col_types[j]));
    }
    PyObject *r = PyObject_CallMethod(g_bridge, "register_table",
                                      "OsOOO", con->con, name, callable,
                                      names, codes);
    Py_DECREF(callable);
    Py_DECREF(names);
    Py_DECREF(codes);
    if (!r) {
        set_py_error(con);
        PyGILState_Release(st);
        return DDB_ERROR;
    }
    Py_DECREF(r);
    PyGILState_Release(st);
    return DDB_SUCCESS;
}

/* ------------------------------------------------------------------ */
/* configuration (reference: duckdb_create_config / duckdb_set_config /
 * duckdb_open_ext, src/main/capi/config-c.cpp) */

ddb_state ddb_create_config(ddb_config *out_config) {
    if (!out_config) return DDB_ERROR;
    struct ddb_config_t *c = calloc(1, sizeof(*c));
    if (!c) return DDB_ERROR;
    *out_config = c;
    return DDB_SUCCESS;
}

ddb_state ddb_set_config(ddb_config config, const char *name,
                         const char *option) {
    if (!config || !name || !option) return DDB_ERROR;
    if (config->n == config->cap) {
        size_t nc = config->cap ? config->cap * 2 : 8;
        char **nn = realloc(config->names, nc * sizeof(char *));
        char **nv = realloc(config->values, nc * sizeof(char *));
        if (!nn || !nv) return DDB_ERROR;
        config->names = nn;
        config->values = nv;
        config->cap = nc;
    }
    config->names[config->n] = strdup(name);
    config->values[config->n] = strdup(option);
    config->n++;
    return DDB_SUCCESS;
}

void ddb_destroy_config(ddb_config *config) {
    if (!config || !*config) return;
    struct ddb_config_t *c = *config;
    for (size_t i = 0; i < c->n; i++) {
        free(c->names[i]);
        free(c->values[i]);
    }
    free(c->names);
    free(c->values);
    free(c);
    *config = NULL;
}

/* settings registry mirror, loaded once from the engine */
static char **g_setting_names = NULL;
static char **g_setting_descs = NULL;
static size_t g_setting_count = 0;

static void load_settings(void) {
    if (g_setting_names || ensure_bridge() != 0) return;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *lst = PyObject_CallMethod(g_bridge, "config_settings",
                                        NULL);
    if (lst && PyList_Check(lst)) {
        size_t n = (size_t)PyList_Size(lst);
        g_setting_names = calloc(n ? n : 1, sizeof(char *));
        g_setting_descs = calloc(n ? n : 1, sizeof(char *));
        for (size_t i = 0; i < n; i++) {
            PyObject *pair = PyList_GetItem(lst, i);
            const char *nm =
                PyUnicode_AsUTF8(PyTuple_GetItem(pair, 0));
            const char *de =
                PyUnicode_AsUTF8(PyTuple_GetItem(pair, 1));
            g_setting_names[i] = strdup(nm ? nm : "");
            g_setting_descs[i] = strdup(de ? de : "");
        }
        g_setting_count = n;
    }
    if (PyErr_Occurred()) PyErr_Clear();
    Py_XDECREF(lst);
    PyGILState_Release(st);
}

size_t ddb_config_count(void) {
    load_settings();
    return g_setting_count;
}

ddb_state ddb_get_config_flag(size_t index, const char **out_name,
                              const char **out_description) {
    load_settings();
    if (index >= g_setting_count) return DDB_ERROR;
    if (out_name) *out_name = g_setting_names[index];
    if (out_description) *out_description = g_setting_descs[index];
    return DDB_SUCCESS;
}

ddb_state ddb_open_ext(const char *path, ddb_database *out_db,
                       ddb_config config, char **out_error) {
    if (out_error) *out_error = NULL;
    if (!out_db) return DDB_ERROR;
    *out_db = NULL;
    if (ensure_bridge() != 0) {
        if (out_error) *out_error = strdup("engine init failed");
        return DDB_ERROR;
    }
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *pairs = PyList_New(0);
    for (size_t i = 0; config && i < config->n; i++) {
        PyObject *t = Py_BuildValue("(ss)", config->names[i],
                                    config->values[i]);
        PyList_Append(pairs, t);
        Py_DECREF(t);
    }
    PyObject *h = PyObject_CallMethod(g_bridge, "open_database", "zO",
                                      path, pairs);
    Py_DECREF(pairs);
    if (!h) {
        if (out_error) {
            PyObject *type, *value, *tb;
            PyErr_Fetch(&type, &value, &tb);
            PyObject *s = value ? PyObject_Str(value) : NULL;
            const char *msg = s ? PyUnicode_AsUTF8(s) : NULL;
            *out_error = strdup(msg ? msg : "open failed");
            Py_XDECREF(s);
            Py_XDECREF(type);
            Py_XDECREF(value);
            Py_XDECREF(tb);
        } else {
            PyErr_Clear();
        }
        PyGILState_Release(st);
        return DDB_ERROR;
    }
    struct ddb_database_t *db = calloc(1, sizeof(*db));
    db->handle = h;
    PyGILState_Release(st);
    *out_db = db;
    return DDB_SUCCESS;
}

/* ------------------------------------------------------------------ */
/* logical types (reference: duckdb_create_logical_type family,
 * src/main/capi/logical_types-c.cpp) */

ddb_logical_type ddb_create_logical_type(ddb_type type) {
    struct ddb_logical_type_t *t = calloc(1, sizeof(*t));
    if (t) t->id = type;
    return t;
}

ddb_logical_type ddb_create_decimal_type(uint8_t width, uint8_t scale) {
    struct ddb_logical_type_t *t = calloc(1, sizeof(*t));
    if (t) {
        t->id = DDB_TYPE_DECIMAL;
        t->width = width;
        t->scale = scale;
    }
    return t;
}

ddb_logical_type ddb_create_list_type(ddb_logical_type child) {
    struct ddb_logical_type_t *t = calloc(1, sizeof(*t));
    if (t) {
        t->id = DDB_TYPE_LIST;
        t->child = child;
    }
    return t;
}

ddb_type ddb_get_type_id(ddb_logical_type type) {
    return type ? type->id : DDB_TYPE_INVALID;
}

uint8_t ddb_decimal_width(ddb_logical_type type) {
    return type ? type->width : 0;
}

uint8_t ddb_decimal_scale(ddb_logical_type type) {
    return type ? type->scale : 0;
}

ddb_logical_type ddb_list_type_child_type(ddb_logical_type type) {
    return type ? type->child : NULL;
}

void ddb_destroy_logical_type(ddb_logical_type *type) {
    if (!type || !*type) return;
    if ((*type)->child) ddb_destroy_logical_type(&(*type)->child);
    free(*type);
    *type = NULL;
}

ddb_logical_type ddb_column_logical_type(ddb_result res, size_t col) {
    if (!res || col >= res->ncols) return NULL;
    struct ddb_logical_type_t *t = calloc(1, sizeof(*t));
    if (!t) return NULL;
    t->id = res->types[col];
    t->width = res->widths ? res->widths[col] : 0;
    t->scale = res->scales ? res->scales[col] : 0;
    return t;
}

/* ------------------------------------------------------------------ */
/* aggregate-function registration: three C callbacks wrapped as
 * PyCFunctions; group state travels as a PyLong-encoded pointer
 * (reference: duckdb_create_aggregate_function,
 * src/main/capi/aggregate_function-c.cpp) */

struct ddb_agg_ctx {
    ddb_agg_init_fn init;
    ddb_agg_update_fn update;
    ddb_agg_finalize_fn finalize;
    void *extra;
    ddb_type ret;
};

static void agg_ctx_free(PyObject *capsule) {
    free(PyCapsule_GetPointer(capsule, "ddb_agg_ctx"));
}

static PyObject *agg_init_trampoline(PyObject *self, PyObject *args) {
    struct ddb_agg_ctx *ctx = PyCapsule_GetPointer(self, "ddb_agg_ctx");
    if (!ctx) return NULL;
    void *state = ctx->init(ctx->extra);
    return PyLong_FromVoidPtr(state);
}

static int py_to_ddb_value(PyObject *a, ddb_value *v,
                           PyObject **strref) {
    memset(v, 0, sizeof(*v));
    *strref = NULL;
    if (a == Py_None) {
        v->is_null = 1;
    } else if (PyBool_Check(a)) {
        v->i = (a == Py_True);
        v->d = (double)v->i;
    } else if (PyLong_Check(a)) {
        v->i = PyLong_AsLongLong(a);
        v->d = (double)v->i;
    } else if (PyFloat_Check(a)) {
        v->d = PyFloat_AsDouble(a);
        v->i = (int64_t)v->d;
    } else if (PyUnicode_Check(a)) {
        *strref = PyUnicode_AsUTF8String(a);
        if (!*strref) return -1;
        v->s = PyBytes_AsString(*strref);
    } else if (PyIndex_Check(a)) {
        PyObject *li = PyNumber_Index(a);
        if (!li) return -1;
        v->i = PyLong_AsLongLong(li);
        v->d = (double)v->i;
        Py_DECREF(li);
    } else {
        double dv = PyFloat_AsDouble(a);
        if (dv == -1.0 && PyErr_Occurred()) {
            PyErr_Clear();
            v->is_null = 1;
        } else {
            v->d = dv;
            v->i = (int64_t)dv;
        }
    }
    return 0;
}

static PyObject *agg_update_trampoline(PyObject *self, PyObject *args) {
    struct ddb_agg_ctx *ctx = PyCapsule_GetPointer(self, "ddb_agg_ctx");
    if (!ctx) return NULL;
    PyObject *st_obj, *val;
    if (!PyArg_ParseTuple(args, "OO", &st_obj, &val)) return NULL;
    void *state = PyLong_AsVoidPtr(st_obj);
    ddb_value v;
    PyObject *strref = NULL;
    if (py_to_ddb_value(val, &v, &strref) != 0) return NULL;
    ctx->update(state, &v, ctx->extra);
    Py_XDECREF(strref);
    Py_RETURN_NONE;
}

static PyObject *agg_finalize_trampoline(PyObject *self,
                                         PyObject *args) {
    struct ddb_agg_ctx *ctx = PyCapsule_GetPointer(self, "ddb_agg_ctx");
    if (!ctx) return NULL;
    PyObject *st_obj;
    if (!PyArg_ParseTuple(args, "O", &st_obj)) return NULL;
    void *state = PyLong_AsVoidPtr(st_obj);
    ddb_value out;
    memset(&out, 0, sizeof(out));
    ctx->finalize(state, &out, ctx->extra);
    if (out.is_null) Py_RETURN_NONE;
    if (ctx->ret == DDB_TYPE_VARCHAR)
        return PyUnicode_FromString(out.s ? out.s : "");
    if (ctx->ret == DDB_TYPE_FLOAT || ctx->ret == DDB_TYPE_DOUBLE)
        return PyFloat_FromDouble(out.d);
    if (ctx->ret == DDB_TYPE_BOOLEAN)
        return PyBool_FromLong(out.i != 0);
    return PyLong_FromLongLong(out.i);
}

static PyMethodDef agg_init_def = {
    "__ddb_agg_init__", agg_init_trampoline, METH_NOARGS, NULL};
static PyMethodDef agg_update_def = {
    "__ddb_agg_update__", agg_update_trampoline, METH_VARARGS, NULL};
static PyMethodDef agg_finalize_def = {
    "__ddb_agg_finalize__", agg_finalize_trampoline, METH_VARARGS,
    NULL};

ddb_state ddb_register_aggregate_function(ddb_connection con,
                                          const char *name,
                                          ddb_agg_init_fn init,
                                          ddb_agg_update_fn update,
                                          ddb_agg_finalize_fn finalize,
                                          ddb_type return_type,
                                          void *extra) {
    if (!con || !name || !init || !update || !finalize)
        return DDB_ERROR;
    if (ensure_bridge() != 0) return DDB_ERROR;
    PyGILState_STATE st = PyGILState_Ensure();
    struct ddb_agg_ctx *ctx = calloc(1, sizeof(*ctx));
    ctx->init = init;
    ctx->update = update;
    ctx->finalize = finalize;
    ctx->extra = extra;
    ctx->ret = return_type;
    PyObject *capsule = PyCapsule_New(ctx, "ddb_agg_ctx",
                                      agg_ctx_free);
    if (!capsule) {
        free(ctx);
        PyGILState_Release(st);
        return DDB_ERROR;
    }
    PyObject *f_init = PyCFunction_New(&agg_init_def, capsule);
    PyObject *f_update = PyCFunction_New(&agg_update_def, capsule);
    PyObject *f_fin = PyCFunction_New(&agg_finalize_def, capsule);
    Py_DECREF(capsule);  /* the callables hold references */
    if (!f_init || !f_update || !f_fin) {
        Py_XDECREF(f_init);
        Py_XDECREF(f_update);
        Py_XDECREF(f_fin);
        PyGILState_Release(st);
        return DDB_ERROR;
    }
    PyObject *r = PyObject_CallMethod(
        g_bridge, "register_aggregate", "OsOOOi", con->con, name,
        f_init, f_update, f_fin, (int)return_type);
    Py_DECREF(f_init);
    Py_DECREF(f_update);
    Py_DECREF(f_fin);
    if (!r) {
        set_py_error(con);
        PyGILState_Release(st);
        return DDB_ERROR;
    }
    Py_DECREF(r);
    PyGILState_Release(st);
    return DDB_SUCCESS;
}
