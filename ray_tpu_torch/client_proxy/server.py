"""Head-side client proxy: one public port, one server process per client.

Reference parity: `python/ray/util/client/server/proxier.py` — the proxier
accepts every remote driver on ONE port and spawns a dedicated
"specific server" process per client, relaying bytes over localhost. The
per-client process (`ray_tpu_torch.client_proxy.worker`) hosts a full
server-side driver (`CoreClient`), which keeps the one-client-per-process
refcounting model intact; the relay is a raw byte pump, so the proxier
never parses frames and adds no per-message overhead beyond a localhost
hop.
"""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Tuple

PUMP_CHUNK = 1 << 16
# a client_hello frame is tiny; anything bigger before the handshake is
# not our client
HELLO_MAX_BYTES = 1 << 20
HELLO_TIMEOUT_S = 15.0


async def _read_raw_frame(reader: asyncio.StreamReader,
                          max_bytes: int) -> bytes:
    """Read one length-prefixed protocol frame as RAW bytes (header +
    payload + out-of-band buffers) without unpickling anything — the
    proxy must never deserialize pre-auth input."""
    header = await reader.readexactly(12)
    payload_len = int.from_bytes(header[:8], "little")
    n_bufs = int.from_bytes(header[8:12], "little")
    if payload_len > max_bytes or n_bufs > 16:
        raise ValueError("oversized pre-handshake frame")
    raw = header + await reader.readexactly(payload_len)
    for _ in range(n_bufs):
        ln_b = await reader.readexactly(8)
        ln = int.from_bytes(ln_b, "little")
        if len(raw) + ln > max_bytes:
            raise ValueError("oversized pre-handshake frame")
        raw += ln_b + await reader.readexactly(ln)
    return raw


async def _pump(reader: asyncio.StreamReader,
                writer: asyncio.StreamWriter) -> None:
    try:
        while True:
            data = await reader.read(PUMP_CHUNK)
            if not data:
                break
            writer.write(data)
            await writer.drain()
    except (ConnectionResetError, BrokenPipeError, OSError):
        pass
    finally:
        try:
            writer.close()
        except Exception:
            pass


class ClientProxyServer:
    def __init__(self, head_host: str, head_port: int,
                 max_clients: Optional[int] = None):
        from ray_tpu_torch.core import config as _config

        self.head_host, self.head_port = head_host, head_port
        self.port: Optional[int] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._procs: list = []
        # each accepted client costs a full driver process; cap them so a
        # port scan (or a misbehaving tenant) can't fork-bomb the head
        self.max_clients = (max_clients if max_clients is not None
                            else _config.get("client_proxy_max_clients"))
        self._active = 0

    async def start(self, host: str = "0.0.0.0", port: int = 0) -> int:
        self._server = await asyncio.start_server(self._on_client, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        for p in self._procs:
            try:
                p.terminate()
            except ProcessLookupError:
                pass
        self._procs.clear()

    async def _spawn_worker(self) -> Tuple[int, subprocess.Popen]:
        """Start a per-client server process; returns its localhost port."""
        fd, port_file = tempfile.mkstemp(prefix="rtpt_cproxy_")
        os.close(fd)
        os.unlink(port_file)
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.client_proxy.worker",
             "--address", f"{self.head_host}:{self.head_port}",
             "--port-file", port_file],
            stdout=subprocess.DEVNULL)
        self._procs.append(proc)
        deadline = time.monotonic() + 60
        while not os.path.exists(port_file):
            if proc.poll() is not None:
                self._procs.remove(proc)
                raise RuntimeError("client proxy worker failed to start")
            if time.monotonic() > deadline:
                proc.kill()
                raise TimeoutError("client proxy worker start timed out")
            await asyncio.sleep(0.05)
        with open(port_file) as f:
            port = int(f.read())
        os.unlink(port_file)
        return port, proc

    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        if self._active >= self.max_clients:
            print(f"[ray_tpu_torch] client proxy at capacity "
                  f"({self.max_clients} clients); rejecting",
                  file=sys.stderr, flush=True)
            writer.close()
            return
        # reserve the slot BEFORE the first await: the capacity check and
        # increment must be atomic w.r.t. other connections or N
        # simultaneous pre-hello connects all pass the check at _active=0
        self._active += 1
        try:
            # demand a plausible client_hello BEFORE paying for a worker
            # process: bare connects (port scans) and garbage senders are
            # dropped here. The frame is relayed verbatim, never unpickled.
            try:
                hello_raw = await asyncio.wait_for(
                    _read_raw_frame(reader, HELLO_MAX_BYTES), HELLO_TIMEOUT_S)
                if b"client_hello" not in hello_raw:
                    raise ValueError("first frame is not client_hello")
            except (Exception, asyncio.TimeoutError):
                writer.close()
                return
            await self._serve_client(hello_raw, reader, writer)
        finally:
            self._active -= 1

    async def _serve_client(self, hello_raw: bytes,
                            reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        proc = None
        try:
            port, proc = await self._spawn_worker()
            w_reader, w_writer = await asyncio.open_connection(
                "127.0.0.1", port)
        except Exception as e:
            print(f"[ray_tpu_torch] client proxy spawn failed: {e!r}",
                  file=sys.stderr, flush=True)
            writer.close()
            if proc is not None:  # connect failed: don't orphan the worker
                proc.kill()
                await asyncio.get_event_loop().run_in_executor(
                    None, proc.wait)
                if proc in self._procs:
                    self._procs.remove(proc)
            return
        import socket as _socket

        for s in (writer, w_writer):
            try:
                s.get_extra_info("socket").setsockopt(
                    _socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            except (OSError, AttributeError):
                pass
        try:
            # replay the buffered handshake frame to the worker first
            w_writer.write(hello_raw)
            await w_writer.drain()
            await asyncio.gather(_pump(reader, w_writer),
                                 _pump(w_reader, writer))
        finally:
            # reap: the worker exits when its client disconnects; an
            # unwaited child stays a zombie for the head's lifetime
            def _reap(p=proc):
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()

            await asyncio.get_event_loop().run_in_executor(None, _reap)
            if proc in self._procs:
                self._procs.remove(proc)


async def amain() -> None:
    import argparse

    from ray_tpu_torch.core import protocol

    p = argparse.ArgumentParser()
    p.add_argument("--address", required=True, help="head host:port")
    p.add_argument("--port", type=int, default=10001)
    p.add_argument("--host", default="0.0.0.0")
    args = p.parse_args()
    host, port_s = args.address.rsplit(":", 1)
    protocol.enable_eager_tasks(asyncio.get_running_loop())
    srv = ClientProxyServer(host, int(port_s))
    port = await srv.start(host=args.host, port=args.port)
    print(f"RAY_TPU_CLIENT_PROXY_PORT={port}", flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await srv.stop()


if __name__ == "__main__":
    try:
        asyncio.run(amain())
    except KeyboardInterrupt:
        sys.exit(0)
