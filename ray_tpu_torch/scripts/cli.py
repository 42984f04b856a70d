"""`python -m ray_tpu_torch.scripts.cli`: node bring-up and introspection.

Counterpart of `ray_tpu/scripts/cli.py` for `start` (a head with
`--head`, a node daemon with `--address`; `--num-gpus` where the JAX
package has `--num-tpu-chips`), `stop`, `status`, `list`, `summary`,
`timeline`, `stack`, `config`, `logs` and `serve` (`deploy <config.yaml>`,
`status`, `shutdown`). Every subcommand but `start` and `stop` attaches via
--address / RAY_TPU_ADDRESS, or the address the last `start --head` on this
machine saved. `job` and `top` wait for the port's job submission and
dashboard (ROADMAP item 22); `up`, `down`, `exec`, `attach` and `rsync` for
its cluster launcher (item 21).

`stop` stops the processes that `start` on this machine recorded under
the state directory (heads and daemons, through SIGTERM, so each kills its
workers and unlinks its shared memory), then the session's leftovers. It
does not kill every port process on the host, as the reference's
`pkill` does: other clusters on the machine stay up.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

from ray_tpu_torch.core import config as _cfg
from ray_tpu_torch.utils.platform import STATE_DIR

ADDR_FILE = os.path.join(STATE_DIR, "last_address")
# one JSON line a process `start` launched: {"pid", "cmd", "session"}
PROCS_FILE = os.path.join(STATE_DIR, "cli_processes")


def _save_address(addr: str) -> None:
    os.makedirs(os.path.dirname(ADDR_FILE), exist_ok=True)
    with open(ADDR_FILE, "w") as f:
        f.write(addr)


def _record_process(proc: subprocess.Popen, cmd: list,
                    session: str = "") -> None:
    """Remember a started process by its pid and its command line (as
    /proc shows it once the child has exec'd), so `stop` never signals a
    pid the system has since given to another program."""
    os.makedirs(STATE_DIR, exist_ok=True)
    with open(PROCS_FILE, "a") as f:
        f.write(json.dumps({"pid": proc.pid, "session": session,
                            "cmd": "\0".join(cmd) + "\0"}) + "\n")


def _resolve_address(args) -> str:
    addr = getattr(args, "address", None) or _cfg.get("address") or None
    if not addr and os.path.exists(ADDR_FILE):
        addr = open(ADDR_FILE).read().strip()
    if not addr:
        sys.exit("no cluster address: pass --address, set RAY_TPU_ADDRESS, "
                 "or run `start --head` on this machine first")
    return addr


def _connect(args):
    import ray_tpu_torch

    ray_tpu_torch.init(address=_resolve_address(args))
    from ray_tpu_torch.core.api import _global_client

    return _global_client()


# ------------------------------------------------------------------- start
def cmd_start(args) -> None:
    from ray_tpu_torch.core.resources import strip_device_env

    env = strip_device_env(dict(os.environ))
    if args.head:
        session = f"cli{os.getpid()}{int(time.time()) % 100000}"
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.head_main",
               "--session", session, "--port", str(args.port)]
        if args.num_cpus is not None:
            cmd += ["--num-cpus", str(args.num_cpus)]
        if args.num_gpus is not None:
            cmd += ["--num-gpus", str(args.num_gpus)]
        if args.resources:
            cmd += ["--resources", args.resources]
        fd, port_file = tempfile.mkstemp(prefix="ray_tpu_torch_ports_")
        os.close(fd)
        os.unlink(port_file)   # head_main atomically re-creates it when ready
        cmd += ["--port-file", port_file]
        # fully detach stdio: a live head must not hold the CLI's pipes —
        # an inherited stdout OR stderr keeps `start --head | tee` (and
        # any capture_output caller) waiting for EOF forever. stderr goes
        # to a session log file so head errors stay diagnosable.
        from ray_tpu_torch.core.worker_logs import session_log_dir

        err_path = os.path.join(session_log_dir(session), "head.err")
        with open(err_path, "ab") as errf:
            proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                    stderr=errf, start_new_session=True,
                                    env=env)
        _record_process(proc, cmd, session)
        port = cproxy = None
        try:
            deadline = time.time() + 60
            while time.time() < deadline:
                if proc.poll() is not None:
                    sys.exit("head failed to start")
                if os.path.exists(port_file):
                    ports = json.load(open(port_file))
                    port = ports["port"]
                    cproxy = ports.get("client_proxy_port")
                    break
                time.sleep(0.05)
        finally:
            try:
                os.unlink(port_file)
            except OSError:
                pass
        if port is None:
            proc.terminate()
            sys.exit("head failed to start (timeout)")
        addr = f"127.0.0.1:{port}"
        _save_address(addr)
        print(f"started head at {addr} (pid {proc.pid})")
        print(f"join with: python -m ray_tpu_torch.scripts.cli start "
              f"--address={addr}")
        print(f"drivers:   RAY_TPU_ADDRESS={addr} python my_script.py")
        if cproxy:
            print(f"remote drivers: ray_tpu_torch.init("
                  f"address=\"ray-tpu://<this-host>:{cproxy}\")")
    else:
        if not args.address:
            sys.exit("worker nodes need --address=<head host:port>")
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.node_main",
               "--address", args.address]
        if args.num_cpus is not None:
            cmd += ["--num-cpus", str(args.num_cpus)]
        if args.num_gpus is not None:
            cmd += ["--num-gpus", str(args.num_gpus)]
        if args.resources:
            cmd += ["--resources", args.resources]
        if args.labels:
            cmd += ["--labels", args.labels]
        # same detachment as the head branch: the daemon must not hold the
        # CLI's pipes or die with the terminal; stderr to a state-dir file
        os.makedirs(STATE_DIR, exist_ok=True)
        with open(os.path.join(STATE_DIR, "node_daemon.err"), "ab") as errf:
            proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                    stderr=errf, start_new_session=True,
                                    env=env)
        _record_process(proc, cmd)
        print(f"node daemon started (pid {proc.pid}), joined {args.address}")
    if args.block:
        try:
            proc.wait()
        except KeyboardInterrupt:
            proc.terminate()


def cmd_stop(args) -> None:
    from ray_tpu_torch.cluster_utils import (STOP_TIMEOUT_S, _cmdline,
                                             _kill_if_same)
    from ray_tpu_torch.core.store import SHM_PREFIX

    try:
        with open(PROCS_FILE) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    except OSError:
        rows = []
    for r in rows:
        r["cmd"] = r["cmd"].encode()
    # only a pid that still runs the command `start` launched is ours
    live = [r for r in rows if _cmdline(r["pid"]) == r["cmd"]]
    # daemons first, then heads: a head stopping first would make its
    # daemons' workers reconnect-loop instead of being killed
    live.sort(key=lambda r: bool(r["session"]))
    for r in live:
        try:
            os.kill(r["pid"], signal.SIGTERM)
        except ProcessLookupError:
            pass
    deadline = time.monotonic() + STOP_TIMEOUT_S
    while time.monotonic() < deadline and any(
            _cmdline(r["pid"]) == r["cmd"] for r in live):
        time.sleep(0.05)
    for r in live:
        _kill_if_same(r["pid"], r["cmd"])
    for r in rows:
        if r["session"]:
            for seg in glob.glob(f"/dev/shm/{SHM_PREFIX}*{r['session'][:8]}*"):
                try:
                    os.unlink(seg)
                except OSError:
                    pass
    for path in (PROCS_FILE, ADDR_FILE):
        if os.path.exists(path):
            os.unlink(path)
    print(f"stopped {len(live)} process(es)" if live else "nothing to stop")


# ------------------------------------------------------------------ status
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


def cmd_summary(args) -> None:
    _connect(args)
    from ray_tpu_torch.util import state

    print(json.dumps({"tasks": state.summarize_tasks(),
                      "actors": state.summarize_actors(),
                      "objects": state.summarize_objects()}, indent=2))


def cmd_timeline(args) -> None:
    _connect(args)
    import ray_tpu_torch

    output = args.output or os.path.join(tempfile.gettempdir(),
                                         "ray_tpu_torch_timeline.json")
    events = ray_tpu_torch.timeline(output, format=args.format)
    print(f"wrote {len(events)} trace events to {output}")


def cmd_stack(args) -> None:
    """Live thread stacks of cluster processes (reference `ray stack`,
    done cooperatively instead of via py-spy/ptrace)."""
    client = _connect(args)
    rows = client.head_request("list_state", kind="workers")
    if args.worker:
        rows = [w for w in rows if w["worker_id"].startswith(args.worker)]
        if not rows:
            sys.exit(f"no worker with id prefix {args.worker!r}")
    for w in rows:
        print(f"===== worker {w['worker_id'][:12]} pid={w['pid']} "
              f"{'driver' if w['is_driver'] else 'worker'}"
              f"{' actor=' + w['actor'][:12] if w.get('actor') else ''}")
        text = client.head_request("worker_stacks",
                                   worker_id=bytes.fromhex(w["worker_id"]))
        print(text or "<unreachable>")


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


# ------------------------------------------------------------------- serve
def cmd_serve(args) -> None:
    _connect(args)
    from ray_tpu_torch import serve as serve_api

    if args.serve_cmd == "deploy":
        from ray_tpu_torch.serve.build_app import deploy_config_file

        names = deploy_config_file(args.config_file)
        port = serve_api.start()
        print(f"deployed {', '.join(names)}; http on 127.0.0.1:{port}")
    elif args.serve_cmd == "status":
        print(json.dumps(serve_api.status(), indent=2, default=str))
    elif args.serve_cmd == "shutdown":
        serve_api.shutdown()
        print("serve shut down")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ray_tpu_torch.scripts.cli",
        description="bring-up and introspection of a ray_tpu_torch cluster")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("start", help="start a head or worker node")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--address", default=None)
    sp.add_argument("--port", type=int, default=0)
    sp.add_argument("--num-cpus", type=float, default=None)
    sp.add_argument("--num-gpus", type=int, default=None)
    sp.add_argument("--resources", default=None, help="JSON dict")
    sp.add_argument("--labels", default=None, help="JSON dict (worker nodes)")
    sp.add_argument("--block", action="store_true")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("stop", help="stop the processes `start` launched "
                                     "on this machine")
    sp.set_defaults(fn=cmd_stop)

    for name, fn in (("status", cmd_status), ("summary", cmd_summary)):
        sp = sub.add_parser(name)
        sp.add_argument("--address", default=None)
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("timeline", help="dump a Chrome trace")
    sp.add_argument("--output", default=None,
                    help="default: ray_tpu_torch_timeline.json in the "
                         "temp directory")
    sp.add_argument("--format", default=None, choices=["chrome"],
                    help="'chrome' writes the Trace Event Object envelope "
                         "(Perfetto-loadable) incl. cross-process workload "
                         "spans; default is the legacy bare array")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_timeline)

    sp = sub.add_parser("stack", help="dump live thread stacks of workers")
    sp.add_argument("--worker", default=None, help="worker id hex prefix")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_stack)

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

    sp = sub.add_parser("serve", help="deploy, list or stop serve apps")
    ssub = sp.add_subparsers(dest="serve_cmd", required=True)
    sd = ssub.add_parser("deploy")
    sd.add_argument("config_file")
    sd.add_argument("--address", default=None)
    sd.set_defaults(fn=cmd_serve)
    for name in ("status", "shutdown"):
        sd = ssub.add_parser(name)
        sd.add_argument("--address", default=None)
        sd.set_defaults(fn=cmd_serve)

    return p


def main(argv=None) -> None:
    # die quietly when downstream of a closed pipe (`... list workers | head`)
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
