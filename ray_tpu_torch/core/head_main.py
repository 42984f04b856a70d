"""Head process entry (`python -m ray_tpu_torch.core.head_main`).

Prints `RAY_TPU_HEAD_PORT=<port>` on stdout once serving, then runs until
killed — the counterpart of `gcs_server` + head-node raylet bring-up
(`python/ray/_private/node.py:1340 start_head_processes`). On SIGTERM it
stops, killing the workers and client-proxy processes it started.

Counterpart of `ray_tpu/core/head_main.py` without its dashboard (ROADMAP
item 22): the head says once on stderr that it waits, and does not start
it. It starts the client proxy for `ray-tpu://` drivers unless
`--no-client-proxy`, and the opt-in usage-stats heartbeat. It imports no
torch and opens no CUDA context; `--num-gpus` overrides GPU detection.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys

from ray_tpu_torch.core import config as _config
from ray_tpu_torch.core.gcs import Head


async def amain(args) -> None:
    from ray_tpu_torch.core.protocol import enable_eager_tasks

    enable_eager_tasks(asyncio.get_running_loop())
    # flight recorder from process birth: node registrations and the
    # head's own outbound RPCs (spawn_worker, health probes) are counted
    # from the first connection (idempotent with Head.start's install).
    # The head's registry is scraped in-process by the dashboard — no
    # pusher thread needed (there is no CoreClient to push through).
    from ray_tpu_torch.core import flight_recorder
    from ray_tpu_torch.util import metrics as _metrics

    _metrics.disable_pusher()
    flight_recorder.install("head")
    if args.restore:
        # a SIGKILLed predecessor leaves its shm arena behind; object data
        # died with its owner processes, so clear it before re-creating
        import glob

        # two segment name schemes: {SHM_PREFIX}arena_{session[:16]} and
        # per-object {SHM_PREFIX}{session[:8]}_... — the 8-char prefix
        # matches both, and the port's own prefix never matches the JAX
        # package's segments (or theirs ours)
        from ray_tpu_torch.core.store import SHM_PREFIX

        for seg in glob.glob(f"/dev/shm/{SHM_PREFIX}*{args.session[:8]}*"):
            try:
                os.unlink(seg)
            except OSError:
                pass
    head = Head(session=args.session, num_cpus=args.num_cpus,
                resources=json.loads(args.resources) if args.resources else None,
                num_gpus=args.num_gpus,
                object_store_bytes=args.object_store_bytes,
                max_workers=args.max_workers,
                labels=json.loads(args.labels) if args.labels else None)
    port = await head.start(port=args.port)
    restored = head.restore_snapshot() if args.restore else False
    if args.enable_snapshots:
        asyncio.ensure_future(head._snapshot_loop())
    if _config.get("memory_monitor"):
        from ray_tpu_torch.core.memory_monitor import MemoryMonitor

        asyncio.ensure_future(MemoryMonitor(head).run())
    from ray_tpu_torch.util.usage_stats import start_usage_stats_heartbeat

    start_usage_stats_heartbeat(args.session)  # no-op unless opted in
    # the head-port line must come first: init() parses it from stdout
    print(f"RAY_TPU_HEAD_PORT={port}", flush=True)
    if args.restore:
        print(f"RAY_TPU_RESTORED={int(restored)}", flush=True)
    ports = {"port": port}
    if not args.no_dashboard:
        print("[ray_tpu_torch] head: the dashboard (ROADMAP item 22) is not "
              "ported yet; not started", file=sys.stderr, flush=True)
    cps = None
    if not args.no_client_proxy:
        try:
            from ray_tpu_torch.client_proxy.server import ClientProxyServer

            # same bind policy as the head/data servers: localhost unless
            # the operator opts into external exposure via RAY_TPU_BIND_HOST
            # (any connecting client gets a full driver — RCE surface)
            cps = ClientProxyServer("127.0.0.1", port)
            cp_port = await cps.start(
                host=_config.get("bind_host"),
                port=args.client_proxy_port)
            head.client_proxy_port = cp_port
            print(f"RAY_TPU_CLIENT_PROXY_PORT={cp_port}", flush=True)
            ports["client_proxy_port"] = cp_port
        except Exception as e:  # remote-driver ingress is best-effort
            cps = None
            print(f"RAY_TPU_CLIENT_PROXY_ERROR={e!r}", file=sys.stderr,
                  flush=True)
    if args.port_file:
        # atomic write so pollers never read a partial file; lets the CLI
        # spawn the head fully detached (stdout→devnull, no inherited pipe)
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(ports, f)
        os.replace(tmp, args.port_file)
    # SIGTERM (ray_tpu_torch.shutdown) stops the head through head.stop(),
    # which kills the workers it started: without it they outlive the
    # head until each notices the closed connection
    import signal

    stopping = asyncio.Event()
    asyncio.get_running_loop().add_signal_handler(signal.SIGTERM,
                                                  stopping.set)
    try:
        await stopping.wait()
    finally:
        if cps is not None:
            # the per-client driver processes go with the head
            await cps.stop()
        await head.stop()


def main() -> None:
    prof_path = _config.get("head_profile")
    if prof_path:
        import cProfile
        import signal as _signal

        prof = cProfile.Profile()
        prof.enable()

        def _dump(_sig, _frm):
            # disable→dump→enable: create_stats() alone permanently stops
            # collection, making repeated snapshots silently stale
            prof.disable()
            prof.dump_stats(prof_path)
            prof.enable()

        _signal.signal(_signal.SIGUSR1, _dump)
    p = argparse.ArgumentParser()
    p.add_argument("--session", required=True)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--num-gpus", type=int, default=None)
    p.add_argument("--resources", type=str, default=None)
    p.add_argument("--object-store-bytes", type=int, default=-1)
    p.add_argument("--max-workers", type=int, default=None)
    p.add_argument("--labels", type=str, default=None)
    p.add_argument("--no-dashboard", action="store_true")
    p.add_argument("--port-file", type=str, default=None)
    p.add_argument("--enable-snapshots", action="store_true",
                   help="persist control-plane state for head restart")
    p.add_argument("--restore", action="store_true",
                   help="restore session state from a prior head snapshot")
    p.add_argument("--dashboard-port", type=int, default=0)
    p.add_argument("--no-client-proxy", action="store_true")
    p.add_argument("--client-proxy-port", type=int, default=0)
    args = p.parse_args()
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
