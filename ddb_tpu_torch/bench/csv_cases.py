"""The CSV corpus that tests/test_torch_csv.py reads through both
packages and chip_smoke.py phase 20a through connect("cuda") and
connect("cpu"): files of pyarrow's reader rules (quoting, line ends, every
type the sniffer types, the NULL spellings, doubles on and off the fast
path, int64 bounds, UTF-8), each with the read_csv_auto keywords it is
read with; the files Connection.read_csv infers types from; a seeded
file of every type; and SQL statements over the files of a directory."""

from __future__ import annotations

import numpy as np

NULLS = ["", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN",
         "-nan", "1.#IND", "1.#QNAN", "N/A", "NA", "NULL", "NaN", "n/a",
         "nan", "null"]

# name -> (file text, read_csv_auto keywords)
CASES = {
    "quoted_delims_newlines": (
        'a,b\n"x,y",1\n"q""r",2\n"m\nn",3\n"""",4\n"a""""b",5\n', {}),
    "crlf": ("a,b\r\n1,x\r\n2,y\r\n", {}),
    "crlf_quoted": ('a,b\r\n1,"x\r\ny"\r\n2,z\r\n', {}),
    "bare_cr": ("a,b\r1,x\r2,y\r", {}),
    "no_final_newline": ("a,b\n1,x\n2,y", {}),
    "empty_lines": ("a,b\n\n1,x\n\n\n2,y\n\n", {}),
    "no_header_pipe": ("1|foo|2020-01-01|1.5\n2|bar|2021-06-30|2.5\n", {}),
    "header_semicolon": ("id;name;score\n1;alice;3.5\n2;bob;4.0\n", {}),
    "tab_header_forced": ("a\tb\n10\t20\n30\t40\n",
                          {"delim": "\t", "header": True}),
    "header_false": ("a,b\n1,2\n", {"header": False}),
    "sniffed_types": (
        "i,d,b,dt,ts,s\n"
        "1,1.5,true,2020-01-02,2020-01-02 03:04:05,x\n"
        "-7,2,false,1999-12-31,2021-06-30 23:59:59.123456,y\n"
        "0,-0.25,TRUE,2024-02-29,2024-02-29 00:00:00,z\n", {}),
    "sniffed_t_f_raises": ("a,b\nt,1\nf,2\n", {}),
    "decimal_declared": (
        "1|a|2020-01-01|1.50\n2|b|2020-01-02|-0.05\n3|c|2020-01-03|17\n"
        "4|d|2020-01-04|.5\n5|e|2020-01-05|+2.5\n6|f|2020-01-06|1e1\n",
        {"names": ["i", "s", "d", "v"],
         "types": {"i": "INTEGER", "s": "VARCHAR", "d": "DATE",
                   "v": "DECIMAL(12,2)"}}),
    "decimal_data_loss": ("1|1.234\n", {"names": ["i", "v"],
                                        "types": {"v": "DECIMAL(12,2)"}}),
    "decimal_trailing_zeros": ("1|1.2300\n2|7.10\n", {
        "names": ["i", "v"], "types": {"v": "DECIMAL(15,2)"}}),
    "nulls_varchar": ("k,s\n" + "".join(f"{i},{v}\n" if v else f"{i},\n"
                                        for i, v in enumerate(NULLS))
                      + "99,x\n", {}),
    "nulls_quoted": ("k,s\n" + "".join(f'{i},"{v}"\n'
                                       for i, v in enumerate(NULLS))
                     + "99,x\n", {}),
    "nulls_double": ("k,v\n" + "".join(f"{i},{v}\n"
                                       for i, v in enumerate(NULLS))
                     + "99,1.5\n", {"names": ["k", "v"],
                                    "types": {"v": "DOUBLE"},
                                    "header": True}),
    "nulls_bigint": ("k,v\n" + "".join(f"{i},{v}\n"
                                       for i, v in enumerate(NULLS))
                     + "99,7\n", {"names": ["k", "v"],
                                  "types": {"v": "BIGINT"}, "header": True}),
    "doubles": (
        "k,v\n" + "".join(f"{i},{v}\n" for i, v in enumerate([
            "2.5", "0.1", "-0", "-0.0", "1e300", "1E-300", "1.", ".5", "-.5",
            "+1.5", "123456789012345678", "0.30000000000000004",
            "4.9e-324", "2.4703282292062328e-324", "1.7976931348623157e308",
            "1e400", "inf", "-inf", "Infinity", "NAN", "+nan", " 1.5 ",
            "9007199254740993", "1e22", "1e23", "8.5e-23", "00.5",
            "43.118271", "99.999999", "1234567.125"])), {}),
    "double_bad_text": ("k,v\n1,1.5\n2,1_0\n", {
        "names": ["k", "v"], "types": {"v": "DOUBLE"}, "header": True}),
    "int64_bounds": ("a,b\n9223372036854775807,1\n-9223372036854775808,2\n"
                     "0,3\n-0,4\n007,5\n 12 ,6\n0x10,7\n0xffffffffffffffff,8"
                     "\n", {}),
    "int64_overflow": ("a,b\n9223372036854775808,1\n", {}),
    "int64_negative_overflow": ("a\n-9223372036854775809\n", {
        "names": ["a"], "types": {"a": "BIGINT"}, "header": True}),
    "int_plus_sign_raises": ("a\n+5\n", {"names": ["a"],
                                          "types": {"a": "BIGINT"},
                                          "header": True}),
    "utf8": ("a,b\nhéllo,1\nwörld,2\nhéllo,3\n日本語,4\n😀,5\n", {}),
    "long_strings": ("a,b\n" + "".join(
        f"{'x' * (30 + i)}{i},{i}\n" for i in range(12)) + '"' + "y" * 40
        + '""z",99\n', {}),
    "timestamps": (
        "t\n2020-01-02 03:04:05\n2020-01-02T03:04:05\n2020-01-02 03:04\n"
        "2020-01-02 03\n2020-01-02 03:04:05.1\n2020-01-02\n", {
            "names": ["t"], "types": {"t": "TIMESTAMP"}, "header": True}),
    "timestamp_zone_raises": ("t\n2020-01-02 03:04:05Z\n", {
        "names": ["t"], "types": {"t": "TIMESTAMP"}, "header": True}),
    "timestamp_bad_hour": ("t\n2020-01-02 24:00:00\n", {
        "names": ["t"], "types": {"t": "TIMESTAMP"}, "header": True}),
    "dates": ("d\n2020-02-29\n 2020-01-02\n0001-01-01\n9999-12-31\n", {
        "names": ["d"], "types": {"d": "DATE"}, "header": True}),
    "date_bad_day": ("d\n2019-02-29\n", {
        "names": ["d"], "types": {"d": "DATE"}, "header": True}),
    "time_column_raises": ("a,b\n03:04:05,1\n", {}),
    "booleans": ("b\ntrue\nFalse\nTRUE\n1\n0\nfalse\n", {
        "names": ["b"], "types": {"b": "BOOLEAN"}, "header": True}),
    "wrong_column_count": ("a,b\n1,2\n3\n4,5\n", {
        "names": ["a", "b"], "header": True}),
    "names_spell_header": ("A,B\n1,2\n", {"names": ["a", "b"],
                                          "types": {"a": "VARCHAR",
                                                    "b": "VARCHAR"}}),
    "all_varchar_headerless": ("x,y\nz,w\n", {}),
    "single_column": ("v\n1\n2\n\n3\n", {}),
    "all_null_column": ("a,b\n1,\n2,NA\n", {}),
}


INFER = {
    "ints": "a\n1\n2\n", "int_null": "a\n1\nNA\n", "to_double": "a\n1.5\n2\n",
    "bools": "a\ntrue\nFalse\n", "int_then_bool": "a\n1\ntrue\n",
    "dates": "a\n2020-01-02\n", "stamps": "a\n2020-01-02 03:04:05\n",
    "stamp_fraction": "a\n2020-01-02 03:04:05.5\n",
    "stamp_ns_zero": "a\n2020-01-02 03:04:05.123456000\n",
    "stamp_zoned": "a\n2020-01-02 03:04:05Z\n2020-01-02 03:04:05+01:00\n",
    "date_and_stamp": "a\n2020-01-02\n2020-01-02 03:04:05\n",
    "all_null": "a\nNA\nNA\n", "strings": "a\nx\n1\n",
    "inf": "a\ninf\n1\n", "hex": "a\n0x10\n", "overflow": "a\n9223372036854775808\n",
    "t_is_string": "a\nt\n", "mixed_string": "a\n1\n2020-01-02\n",
    "nan_null": "a\n1.5\nnan\n", "NAN": "a\nNAN\n", "space_date": "a\n 2020-01-02\n",
    "time": "a\n03:04:05\n", "empty": "a,b\n",
    "quoted_header": 'a,"b,c","x""y"\n1,2,3\n',
    "multi": "i,s,f\n1,x,1.5\n2,,2.5\n3,y,\n",
}


def random_file(rng, n, newlines=True):
    """A seeded file of every sniffed type, NULLs and quoting; strings
    holding a newline unless `newlines` is false."""
    words = ["alpha", "beta", 'q"uote', "com,ma", "é", "NA", "", "x" * 40]
    words = np.array(words + (["new\nline"] if newlines else []))
    lines = ["i,x,s,d,ts,b"]
    for k in range(n):
        i = int(rng.integers(-10**12, 10**12))
        f = float(np.round(rng.uniform(-1e4, 1e4), int(rng.integers(0, 9))))
        s = str(words[rng.integers(0, len(words))])
        d = f"{int(rng.integers(1900, 2100))}-{int(rng.integers(1, 13)):02d}" \
            f"-{int(rng.integers(1, 29)):02d}"
        ts = f"{d} {int(rng.integers(0, 24)):02d}:" \
             f"{int(rng.integers(0, 60)):02d}:{int(rng.integers(0, 60)):02d}"
        b = ["true", "false"][int(rng.integers(0, 2))]
        if rng.random() < 0.05:
            f = "NA"
        q = '"' + s.replace('"', '""') + '"' if (
            '"' in s or "," in s or "\n" in s or rng.random() < 0.3) else s
        lines.append(f"{i},{f},{q},{d},{ts},{b}")
    return "\n".join(lines) + "\n"


# SQL over a directory {d} holding f.csv (random_file) and p.csv
# (CASES["no_header_pipe"]): every file entry point and VALUES in FROM
STATEMENTS = {
    "read_csv_auto": "SELECT * FROM read_csv_auto('{d}/f.csv') "
                     "ORDER BY ALL",
    "sniff_csv": "SELECT * FROM sniff_csv('{d}/p.csv')",
    "read_csv_named": "SELECT * FROM read_csv('{d}/p.csv', delim='|', "
                      "header=false) ORDER BY 1",
    "read_csv_columns": "SELECT * FROM read_csv('{d}/p.csv', delim='|', "
                        "columns={{'a': 'BIGINT', 'b': 'VARCHAR', "
                        "'c': 'DATE', 'd': 'DOUBLE'}}) ORDER BY 1",
    "copy_from_declared": [
        "CREATE TABLE cf (i BIGINT, x DOUBLE, s VARCHAR, d DATE, "
        "ts TIMESTAMP, b BOOLEAN)",
        "COPY cf FROM '{d}/f.csv'",
        "SELECT * FROM cf ORDER BY ALL"],
    "copy_to_and_back": [
        "CREATE TABLE ct AS SELECT * FROM read_csv_auto('{d}/f.csv')",
        "COPY ct TO '{d}/out.csv' (DELIMITER '|')",
        "SELECT count(*), sum(i), min(s), max(d) FROM "
        "read_csv('{d}/out.csv', delim='|', header=true)"],
    "values_in_from": "SELECT * FROM (VALUES (1, 'a', DATE '2020-01-02', "
                      "1.5), (2, NULL, NULL, 2.25), (3, 'c', NULL, NULL)) "
                      "t(x, y, z, w) ORDER BY x",
}
