"""`python -m ray_tpu_torch.scripts.cli`: introspection of a running cluster.

Counterpart of `ray_tpu/scripts/cli.py` for the subcommands that read a
single-node cluster: `status`, `list`, `config` and `logs`. Each attaches
via --address / RAY_TPU_ADDRESS. Node bring-up (`start`, `stop`, `up`,
`down`), jobs, timelines and `serve` wait for the multi-node runtime and
the libraries (ROADMAP items 15b, 18 and 22).
"""

from __future__ import annotations

import argparse
import json
import signal
import sys

from ray_tpu_torch.core import config as _cfg


def _resolve_address(args) -> str:
    addr = getattr(args, "address", None) or _cfg.get("address") or None
    if not addr:
        sys.exit("no cluster address: pass --address or set "
                 "RAY_TPU_ADDRESS")
    return addr


def _connect(args):
    import ray_tpu_torch

    ray_tpu_torch.init(address=_resolve_address(args))
    from ray_tpu_torch.core.api import _global_client

    return _global_client()


def cmd_status(args) -> None:
    client = _connect(args)
    info = client.head_request("cluster_info")
    print(f"session:  {info['session']}")
    print(f"uptime:   {info['uptime']:.0f}s")
    print(f"nodes:    {info['num_nodes']}  workers: {info['num_workers']}")
    if info.get("dashboard_port"):
        print(f"dashboard: http://127.0.0.1:{info['dashboard_port']}")
    print("resources:")
    for r, total in sorted(info["total_resources"].items()):
        avail = info["available_resources"].get(r, 0)
        print(f"  {r}: {avail:g}/{total:g} available")


def cmd_list(args) -> None:
    client = _connect(args)
    kind = {"pgs": "placement_groups"}.get(args.kind, args.kind)
    rows = client.head_request("list_state", kind=kind)
    print(json.dumps(rows[:args.limit] if args.limit else rows, indent=2,
                     default=str))


def cmd_config(args) -> None:
    """The running head's full flag table (reference `ray_config_def.h`
    introspection): value, default, and where each value came from."""
    if args.local:
        from ray_tpu_torch.core import config as cfg

        rows = cfg.dump()
    else:
        rows = _connect(args).head_request("get_config")
    if args.json:
        print(json.dumps(rows, indent=1, default=str))
        return
    w = max(len(r["name"]) for r in rows)
    for r in rows:
        mark = " [negotiated]" if r["negotiated"] else ""
        star = "" if r["source"] == "default" else f"  ({r['source']})"
        print(f"{r['name']:<{w}}  {r['value']!r:<14}{star}{mark}")
        if args.verbose:
            print(f"{'':<{w}}  env={r['env']} default={r['default']!r}")
            print(f"{'':<{w}}  {r['doc']}")


def cmd_logs(args) -> None:
    """Worker log access (reference `ray logs`): list the session's log
    files, or print one (`logs worker-<tag>.err --tail 50`).
    `--worker <worker_id>` resolves a live/recent worker's files."""
    client = _connect(args)
    target = args.filename
    if args.worker:
        rows = client.head_request("list_state", kind="workers")
        match = [w for w in rows
                 if w["worker_id"].startswith(args.worker) and w.get("log_tag")]
        if not match:
            sys.exit(f"no worker with id prefix {args.worker!r} "
                     f"(or it has no captured logs)")
        target = f"worker-{match[0]['log_tag']}.{args.stream}"
    if not target:
        for row in client.head_request("list_logs"):
            size = row["size"]
            print(f"{'?' if size is None else size:>10}  {row['file']}")
        return
    lines = client.head_request("get_log", filename=target, tail=args.tail)
    if lines is None:
        sys.exit(f"no such log file: {target}")
    for line in lines:
        print(line)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ray_tpu_torch.scripts.cli",
        description="introspection of a ray_tpu_torch cluster")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("status")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser("list", help="list cluster state")
    sp.add_argument("kind", choices=["tasks", "task_events", "actors",
                                     "workers", "objects", "nodes", "pgs"])
    sp.add_argument("--limit", type=int, default=None)
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("config", help="show the cluster's config flags")
    sp.add_argument("--address", default=None)
    sp.add_argument("--local", action="store_true",
                    help="this process's view instead of the head's")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--verbose", "-v", action="store_true")
    sp.set_defaults(fn=cmd_config)

    sp = sub.add_parser("logs", help="list or print worker log files")
    sp.add_argument("filename", nargs="?", default=None,
                    help="log file name (omit to list)")
    sp.add_argument("--worker", default=None,
                    help="worker id (hex prefix) instead of a filename")
    sp.add_argument("--stream", choices=["out", "err"], default="out",
                    help="which stream with --worker")
    sp.add_argument("--tail", type=int, default=None)
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_logs)

    return p


def main(argv=None) -> None:
    # die quietly when downstream of a closed pipe (`... list workers | head`)
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
