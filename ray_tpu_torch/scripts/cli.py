"""Command-line interface: ``start``, ``stop`` and ``status``.

Port of the part of ray_tpu/scripts/cli.py the cluster needs.
``status`` prints the cluster's resources (available / total) and its
node table (``node_id``, ``alive``, ``resources``), as ray_tpu's does,
for the head at ``--address`` (default: the one ``start`` recorded).
Out: the state listings, timeline, traces, logs, memory, profiling,
chaos, incidents, goodput, watch and lint commands.
"""

from __future__ import annotations

import argparse
import sys


def _fmt_table(rows: list[dict], columns: list[str]) -> str:
    if not rows:
        return "(empty)"
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in columns}
    line = "  ".join(c.ljust(widths[c]) for c in columns)
    out = [line, "-" * len(line)]
    for r in rows:
        out.append("  ".join(str(r.get(c, "")).ljust(widths[c])
                             for c in columns))
    return "\n".join(out)


def cmd_status(args) -> int:
    from ray_tpu_torch.core.cluster.protocol import RpcClient
    from ray_tpu_torch.scripts.start import read_address

    address = args.address or read_address()
    host, port = address.rsplit(":", 1)
    head = RpcClient(host, int(port))
    try:
        total = head.call("cluster_resources")
        avail = head.call("available_resources")
        nodes = head.call("list_nodes")
    finally:
        head.close()
    print("Cluster resources:")
    for k in sorted(total):
        print(f"  {k}: {avail.get(k, 0.0):g} / {total[k]:g} available")
    rows = [{"node_id": n["node_id"], "alive": n["alive"],
             "resources": n["resources"]} for n in nodes.values()]
    print(f"\nNodes ({len(rows)}):")
    print(_fmt_table(rows, ["node_id", "alive", "resources"]))
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="ray_tpu_torch")
    p.add_argument("--address", default=None,
                   help="head address (host:port); default: the head "
                        "`start --head` recorded")
    sub = p.add_subparsers(dest="command", required=True)
    sub.add_parser("status")
    from ray_tpu_torch.scripts.start import add_parsers

    add_parsers(sub)
    args = p.parse_args(argv)
    if hasattr(args, "_fn"):
        return args._fn(args)
    return {"status": cmd_status}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
