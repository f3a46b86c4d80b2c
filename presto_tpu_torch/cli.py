"""Interactive CLI (reference: presto-cli — airline+jline console).

Port of presto_tpu/cli.py. ``--serve`` runs the coordinator on the card
unless ``--device cpu`` is given.

Usage:
    python -m presto_tpu_torch.cli --serve [--scale 0.01] [--port 8080]
        start an in-process coordinator with the tpch + memory +
        blackhole catalogs and drop into the shell against it
    python -m presto_tpu_torch.cli --server http://host:port
        connect to a running coordinator
    python -m presto_tpu_torch.cli --execute "select 1" [--server ...]
        run one statement and exit
"""

from __future__ import annotations

import argparse
import sys

from presto_tpu_torch.client import StatementClient


def _fmt_table(columns, rows) -> str:
    if not columns:
        return ""
    names = [c["name"] for c in columns]
    cells = [[("NULL" if v is None else str(v)) for v in r] for r in rows]
    widths = [
        max(len(n), *(len(r[i]) for r in cells)) if cells else len(n)
        for i, n in enumerate(names)
    ]
    def line(vals):
        return " | ".join(v.ljust(w) for v, w in zip(vals, widths))
    sep = "-+-".join("-" * w for w in widths)
    out = [line(names), sep]
    out.extend(line(r) for r in cells)
    return "\n".join(out)


def _run_one(client: StatementClient, sql: str) -> int:
    res = client.execute(sql)
    if res.error:
        print(f"Query {res.query_id} failed: "
              f"{res.error.get('errorName')}: {res.error.get('message')}",
              file=sys.stderr)
        return 1
    if res.update_type:
        print(res.update_type)
    if res.columns:
        print(_fmt_table(res.columns, res.rows))
        print(f"({len(res.rows)} row{'s' if len(res.rows) != 1 else ''})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="presto-tpu")
    ap.add_argument("--server", default="http://127.0.0.1:8080")
    ap.add_argument("--catalog", default="tpch")
    ap.add_argument("--schema", default="default")
    ap.add_argument("--user", default="presto")
    ap.add_argument("--execute", "-e", help="run one statement and exit")
    ap.add_argument("--serve", action="store_true",
                    help="start an in-process coordinator first")
    ap.add_argument("--port", type=int, default=None,
                    help="listen port for --serve (default: the etc "
                    "config's http-server.http.port when --etc-dir is "
                    "given, else 8080)")
    ap.add_argument("--scale", type=float, default=0.01,
                    help="tpch catalog scale factor for --serve")
    ap.add_argument("--device", default=None,
                    help="torch device for --serve (default: the card)")
    ap.add_argument("--etc-dir",
                    help="deployment config directory: "
                    "etc/config.properties + etc/catalog/*.properties "
                    "(reference etc/ layout; overrides --scale)")
    args = ap.parse_args(argv)

    server_url = args.server
    srv = None
    if args.serve:
        if args.etc_dir:
            from presto_tpu_torch.config import server_from_etc

            srv = server_from_etc(args.etc_dir, port=args.port,
                                  device=args.device)
        else:
            from presto_tpu_torch.connectors.blackhole import (
                BlackholeConnector,
            )
            from presto_tpu_torch.connectors.memory import MemoryConnector
            from presto_tpu_torch.connectors.tpch import TpchConnector
            from presto_tpu_torch.server import PrestoTpuServer

            srv = PrestoTpuServer(
                {
                    "tpch": TpchConnector(args.scale, device=args.device),
                    "memory": MemoryConnector(device=args.device),
                    "blackhole": BlackholeConnector(),
                },
                port=args.port if args.port is not None else 8080,
                device=args.device,
            )
        port = srv.start()
        server_url = f"http://127.0.0.1:{port}"
        print(f"coordinator listening on {server_url}")

    client = StatementClient(
        server=server_url, user=args.user,
        catalog=args.catalog, schema=args.schema,
    )
    try:
        if args.execute:
            return _run_one(client, args.execute)
        # REPL
        buf = ""
        while True:
            try:
                prompt = "presto-tpu> " if not buf else "        ...> "
                line = input(prompt)
            except EOFError:
                break
            if not buf and line.strip().lower() in ("quit", "exit"):
                break
            buf += (" " if buf else "") + line
            if buf.rstrip().endswith(";") or not buf.strip():
                sql = buf.rstrip().rstrip(";")
                buf = ""
                if sql.strip():
                    _run_one(client, sql)
        return 0
    finally:
        if srv:
            srv.stop()


if __name__ == "__main__":
    sys.exit(main())
