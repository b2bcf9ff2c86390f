"""Interactive SQL shell: `python -m ddb_tpu_torch [--device cpu]
[database.dtb]`.  Statements run on the card unless `--device` names
another torch device; without CUDA the default raises, as `connect`
does.

Analog of the reference's CLI shell (reference: tools/shell/shell.cpp —
REPL, dot commands, box renderer).  Minimal but real: readline editing,
.tables/.schema/.open/.save/.timer dot commands, box-drawn results.
"""

from __future__ import annotations

import sys
import time


def render_box(names, rows, max_rows=40):
    cols = [[str(n)] for n in names]
    for r in rows[:max_rows]:
        for i, v in enumerate(r):
            cols[i].append("NULL" if v is None else str(v))
    widths = [max(len(x) for x in c) for c in cols]
    top = "┌" + "┬".join("─" * (w + 2) for w in widths) + "┐"
    mid = "├" + "┼".join("─" * (w + 2) for w in widths) + "┤"
    bot = "└" + "┴".join("─" * (w + 2) for w in widths) + "┘"
    out = [top]
    for ri in range(len(cols[0])):
        line = "│" + "│".join(
            f" {cols[ci][ri]:<{widths[ci]}} " for ci in range(len(cols)))
        out.append(line + "│")
        if ri == 0:
            out.append(mid)
    out.append(bot)
    if len(rows) > max_rows:
        out.append(f"({len(rows)} rows, showing first {max_rows})")
    else:
        out.append(f"({len(rows)} row{'s' if len(rows) != 1 else ''})")
    return "\n".join(out)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    import argparse

    import ddb_tpu_torch

    ap = argparse.ArgumentParser(prog="python -m ddb_tpu_torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("database", nargs="?")
    opts = ap.parse_args(argv)
    device = opts.device
    argv = [opts.database] if opts.database else []

    con = ddb_tpu_torch.connect(device, argv[0]) if argv \
        else ddb_tpu_torch.connect(device)
    try:
        import readline
        from .autocomplete import make_readline_completer
        readline.set_completer(make_readline_completer(lambda: con))
        readline.set_completer_delims(" \t\n,();")
        readline.parse_and_bind("tab: complete")
    except ImportError:
        pass
    db_path = argv[0] if argv else None
    timer = False
    print(f"ddb_tpu_torch shell on {con.device}.  "
          "Type .help for commands.")
    buf = ""
    while True:
        try:
            prompt = "D " if not buf else "> "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            break
        if not buf and line.startswith("."):
            cmd, *args = line.split()
            if cmd in (".quit", ".exit"):
                break
            elif cmd == ".help":
                print(".tables  .schema [t]  .open FILE  .save [FILE]  "
                      ".timer on|off  .quit")
            elif cmd == ".tables":
                for n in sorted(con.catalog.tables):
                    print(n)
            elif cmd == ".schema":
                for n, td in sorted(con.catalog.tables.items()):
                    if args and n != args[0]:
                        continue
                    cols = ", ".join(f"{c.name} {c.dtype!r}"
                                     for c in td.columns)
                    print(f"CREATE TABLE {n} ({cols});")
            elif cmd == ".open" and args:
                con = ddb_tpu_torch.connect(device, args[0])
                db_path = args[0]
            elif cmd == ".save":
                path = args[0] if args else db_path
                if not path:
                    print("no database path")
                else:
                    con.save(path)
                    db_path = path
                    print(f"saved to {path}")
            elif cmd == ".timer":
                timer = bool(args) and args[0] == "on"
            else:
                print(f"unknown command {cmd}")
            continue
        buf += ("\n" if buf else "") + line
        if not buf.rstrip().endswith(";"):
            continue
        sql, buf = buf, ""
        try:
            t0 = time.perf_counter()
            res = con.execute(sql)
            dt = time.perf_counter() - t0
            if res is not None:
                rows = res.fetchall()
                print(render_box(res.column_names, rows))
            if timer:
                print(f"Run Time: {dt:.3f}s")
        except Exception as e:
            print(f"Error: {type(e).__name__}: {e}")


if __name__ == "__main__":
    main()
