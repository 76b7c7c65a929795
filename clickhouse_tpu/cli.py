"""Multicall CLI — the `programs/main.cpp` analog.

  python -m clickhouse_tpu local  [-q SQL]...      # in-process engine + REPL
  python -m clickhouse_tpu server [--port 8123]    # HTTP server
  python -m clickhouse_tpu client [--url ...] [-q SQL]   # HTTP client REPL
  python -m clickhouse_tpu benchmark -q SQL [-i N] # latency percentiles
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def _make_session():
    from .exec.session import Session
    return Session()


def _repl(execute, prompt="clickhouse-tpu :) "):
    try:
        import readline  # noqa: F401 — line editing
    except ImportError:
        pass
    buf: List[str] = []
    while True:
        try:
            line = input(prompt if not buf else "          :-] ")
        except (EOFError, KeyboardInterrupt):
            print()
            return
        if not buf and line.strip().lower() in ("exit", "quit", "q", "\\q"):
            return
        buf.append(line)
        text = "\n".join(buf)
        if text.rstrip().endswith(";") or (line == "" and text.strip()):
            buf = []
            sql = text.rstrip().rstrip(";")
            if not sql.strip():
                continue
            t0 = time.monotonic()
            try:
                out = execute(sql)
                elapsed = time.monotonic() - t0
                if out is not None:
                    print(out)
                print(f"\nElapsed: {elapsed:.3f} sec.\n")
            except Exception as e:
                print(f"Error: {e}\n")


def cmd_local(args):
    s = _make_session()
    if args.query:
        for q in args.query:
            res = s.execute(q)
            if res.column_names:
                if args.format:
                    from .storage import formats
                    sys.stdout.write(
                        formats.format_rows_text(res.columns, args.format))
                else:
                    print(res)
        return 0
    print("clickhouse-tpu local — JAX/XLA query engine (';' to run, "
          "'exit' to quit)")
    _repl(lambda sql: s.execute(sql) if True else None)
    return 0


def cmd_server(args):
    from .exec.session import Session
    from .server.http_server import HttpServer
    from .server.tcp_server import TcpServer
    host, tcp_port, http_port = args.host, args.tcp_port, args.port
    if getattr(args, "config", None):
        from .core.config import listener_ports, load_config
        cfg = load_config(args.config)
        host, tcp_port, http_port = listener_ports(cfg)
        session = Session(config_path=args.config)
    else:
        session = Session()
    args.host, args.tcp_port, args.port = host, tcp_port, http_port
    tcp = TcpServer(session=session, host=args.host, port=args.tcp_port)
    tcp.start_background()
    print(f"native TCP protocol on {args.host}:{tcp.port}", flush=True)
    print(f"HTTP on {args.host}:{args.port}", flush=True)
    HttpServer(session=session, host=args.host,
               port=args.port).serve_forever()
    return 0


def cmd_client(args):
    import urllib.request

    def run(sql: str) -> str:
        data = sql.encode()
        req = urllib.request.Request(args.url, data=data)
        with urllib.request.urlopen(req) as resp:
            return resp.read().decode().rstrip("\n")

    if args.query:
        for q in args.query:
            print(run(q))
        return 0
    print(f"clickhouse-tpu client -> {args.url}")
    _repl(run)
    return 0


def cmd_benchmark(args):
    import numpy as np
    s = _make_session()
    for setup in args.setup or []:
        s.execute(setup)
    times = []
    s.execute(args.query)        # warm (compile)
    for _ in range(args.iterations):
        t0 = time.perf_counter()
        s.execute(args.query)
        times.append(time.perf_counter() - t0)
    arr = np.asarray(times) * 1e3
    print(f"queries: {len(arr)}, QPS: {1000.0 / arr.mean():.2f}")
    for p in (50, 90, 95, 99):
        print(f"p{p}: {np.percentile(arr, p):.2f} ms")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="clickhouse-tpu")
    parser.add_argument("--platform", default=None,
                        help="force a JAX platform (e.g. cpu for quick "
                             "local runs without a device)")
    sub = parser.add_subparsers(dest="mode")

    p_local = sub.add_parser("local", help="in-process engine (REPL or -q)")
    p_local.add_argument("-q", "--query", action="append")
    p_local.add_argument("--format", default=None)
    p_local.set_defaults(fn=cmd_local)

    p_server = sub.add_parser("server", help="HTTP + native TCP server")
    p_server.add_argument("--host", default="127.0.0.1")
    p_server.add_argument("--port", type=int, default=8123)
    p_server.add_argument("--tcp-port", type=int, default=9000)
    p_server.add_argument("--config", default=None,
                          help="server config file (YAML or XML)")
    p_server.set_defaults(fn=cmd_server)

    p_client = sub.add_parser("client", help="HTTP client")
    p_client.add_argument("--url", default="http://127.0.0.1:8123/")
    p_client.add_argument("-q", "--query", action="append")
    p_client.set_defaults(fn=cmd_client)

    p_bench = sub.add_parser("benchmark", help="query latency benchmark")
    p_bench.add_argument("-q", "--query", required=True)
    p_bench.add_argument("--setup", action="append")
    p_bench.add_argument("-i", "--iterations", type=int, default=10)
    p_bench.set_defaults(fn=cmd_benchmark)

    args = parser.parse_args(argv)
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    from .compile_cache import enable_compile_cache
    enable_compile_cache()
    if not getattr(args, "fn", None):
        parser.print_help()
        return 1
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
