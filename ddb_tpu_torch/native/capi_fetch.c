/* capi_fetch: run SQL statements over a database through the C API.
 *
 *     capi_fetch DATABASE [-n RUNS] SQL [[-n RUNS] SQL ...]
 *
 * Opens DATABASE (a file, or :memory:) with ddb_open and ddb_connect,
 * then runs each statement RUNS times (the last -n before it, else once)
 * with ddb_query and reads every cell of its result through
 * ddb_value_*.  For each statement k, counted from 0, it prints, from
 * the first run:
 *
 *     statement k rows N cols M
 *     column k j TYPE NAME             one line a column
 *     row k i CELL<TAB>CELL...         the first 10 rows
 *     checksum k j VALUE               one line a column
 *
 * A cell prints as NULL, as an integer (BOOLEAN to HUGEINT), as %.17g
 * (FLOAT, DOUBLE, DECIMAL) or as its text.  A column's checksum is the
 * sum of its non-NULL doubles in row order (%.17g) for the numeric
 * types, else the sum of its texts' byte lengths.  Every later run must
 * give the same rows and checksums.  Lines that start with "time " carry
 * wall milliseconds (CLOCK_MONOTONIC): of ddb_open, of ddb_connect, and
 * of each run's ddb_query and read.  Exits 1 on any error.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "include/ddb_tpu_c.h"

#define SHOWN_ROWS 10

static double now_ms(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec * 1e3 + ts.tv_nsec / 1e6;
}

static int is_int_type(ddb_type t) {
    return t >= DDB_TYPE_BOOLEAN && t <= DDB_TYPE_HUGEINT;
}

static int is_float_type(ddb_type t) {
    return t == DDB_TYPE_FLOAT || t == DDB_TYPE_DOUBLE
           || t == DDB_TYPE_DECIMAL;
}

typedef struct {
    double sum;                /* numeric columns */
    unsigned long long bytes;  /* the others */
} checksum;

/* reads every cell of `res`; fills one checksum a column */
static void read_all(ddb_result res, checksum *sums) {
    size_t ncols = ddb_column_count(res), nrows = ddb_row_count(res);
    for (size_t j = 0; j < ncols; j++) {
        ddb_type t = ddb_column_type(res, j);
        int numeric = is_int_type(t) || is_float_type(t);
        double sum = 0.0;
        unsigned long long bytes = 0;
        for (size_t i = 0; i < nrows; i++) {
            if (ddb_value_is_null(res, j, i)) continue;
            if (numeric)
                sum += ddb_value_double(res, j, i);
            else
                bytes += strlen(ddb_value_varchar(res, j, i));
        }
        sums[j].sum = sum;
        sums[j].bytes = bytes;
    }
}

static void print_cell(ddb_result res, size_t j, size_t i) {
    ddb_type t = ddb_column_type(res, j);
    if (ddb_value_is_null(res, j, i))
        fputs("NULL", stdout);
    else if (is_int_type(t))
        printf("%lld", (long long)ddb_value_int64(res, j, i));
    else if (is_float_type(t))
        printf("%.17g", ddb_value_double(res, j, i));
    else
        fputs(ddb_value_varchar(res, j, i), stdout);
}

static void print_result(int k, ddb_result res, const checksum *sums) {
    size_t ncols = ddb_column_count(res), nrows = ddb_row_count(res);
    printf("statement %d rows %zu cols %zu\n", k, nrows, ncols);
    for (size_t j = 0; j < ncols; j++)
        printf("column %d %zu %d %s\n", k, j,
               (int)ddb_column_type(res, j), ddb_column_name(res, j));
    for (size_t i = 0; i < nrows && i < SHOWN_ROWS; i++) {
        printf("row %d %zu ", k, i);
        for (size_t j = 0; j < ncols; j++) {
            if (j) putchar('\t');
            print_cell(res, j, i);
        }
        putchar('\n');
    }
    for (size_t j = 0; j < ncols; j++) {
        ddb_type t = ddb_column_type(res, j);
        if (is_int_type(t) || is_float_type(t))
            printf("checksum %d %zu %.17g\n", k, j, sums[j].sum);
        else
            printf("checksum %d %zu %llu\n", k, j, sums[j].bytes);
    }
}

int main(int argc, char **argv) {
    if (argc < 3) {
        fprintf(stderr, "usage: %s DATABASE [-n RUNS] SQL "
                "[[-n RUNS] SQL ...]\n", argv[0]);
        return 1;
    }
    const char *path = argv[1];

    ddb_database db;
    ddb_connection con;
    double t0 = now_ms();
    if (ddb_open(path, &db) != DDB_SUCCESS) {
        fprintf(stderr, "capi_fetch: ddb_open(%s) failed\n", path);
        return 1;
    }
    double t1 = now_ms();
    if (ddb_connect(db, &con) != DDB_SUCCESS) {
        fprintf(stderr, "capi_fetch: ddb_connect failed\n");
        return 1;
    }
    double t2 = now_ms();
    printf("time open %.3f\n", t1 - t0);
    printf("time connect %.3f\n", t2 - t1);
    fflush(stdout);

    int runs = 1, k = 0;
    for (int a = 2; a < argc; a++) {
        if (strcmp(argv[a], "-n") == 0) {
            runs = a + 1 < argc ? atoi(argv[++a]) : 0;
            if (runs < 1) {
                fprintf(stderr, "capi_fetch: -n takes a count of 1 or "
                        "more\n");
                return 1;
            }
            continue;
        }
        const char *sql = argv[a];
        checksum *first = NULL, *sums = NULL;
        size_t nrows = 0, ncols = 0;
        for (int r = 0; r < runs; r++) {
            ddb_result res;
            double q0 = now_ms();
            if (ddb_query(con, sql, &res) != DDB_SUCCESS) {
                fprintf(stderr, "capi_fetch: statement %d: %s\n", k,
                        ddb_error_message(con));
                return 1;
            }
            if (r == 0) {
                nrows = ddb_row_count(res);
                ncols = ddb_column_count(res);
                sums = calloc(ncols ? ncols : 1, sizeof(checksum));
                first = calloc(ncols ? ncols : 1, sizeof(checksum));
            } else if (ddb_row_count(res) != nrows
                       || ddb_column_count(res) != ncols) {
                fprintf(stderr, "capi_fetch: statement %d: run %d has "
                        "another shape than the first\n", k, r);
                return 1;
            }
            read_all(res, sums);
            double q1 = now_ms();
            if (r == 0) {
                memcpy(first, sums, ncols * sizeof(checksum));
                print_result(k, res, sums);
            } else if (memcmp(first, sums, ncols * sizeof(checksum))) {
                fprintf(stderr, "capi_fetch: statement %d: run %d differs "
                        "from the first\n", k, r);
                return 1;
            }
            printf("time query %d %d %.3f\n", k, r, q1 - q0);
            fflush(stdout);
            ddb_destroy_result(&res);
        }
        free(first);
        free(sums);
        k++;
    }
    ddb_disconnect(&con);
    ddb_close(&db);
    printf("capi_fetch: OK\n");
    return 0;
}
