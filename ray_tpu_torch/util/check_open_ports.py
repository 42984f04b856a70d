"""Security helper: check which cluster ports are exposed beyond localhost.

Parity: `ray.util.check_open_ports` — enumerate this framework's listening
ports and flag any bound to non-loopback interfaces (a cluster's control
plane should not be internet-reachable).
"""

from __future__ import annotations

import socket
from typing import Dict, List, Optional


def _listening_sockets() -> List[dict]:
    """Parse /proc/net/tcp{,6} for LISTEN sockets of this machine."""
    out = []
    for path, family in (("/proc/net/tcp", socket.AF_INET),
                         ("/proc/net/tcp6", socket.AF_INET6)):
        try:
            with open(path) as f:
                lines = f.readlines()[1:]
        except OSError:
            continue
        for line in lines:
            parts = line.split()
            if len(parts) < 4 or parts[3] != "0A":  # 0A = LISTEN
                continue
            addr_hex, port_hex = parts[1].rsplit(":", 1)
            port = int(port_hex, 16)
            if family == socket.AF_INET:
                raw = bytes.fromhex(addr_hex)[::-1]
                host = socket.inet_ntop(family, raw)
            else:
                raw = bytes.fromhex(addr_hex)
                # /proc stores IPv6 as 4 little-endian 32-bit words
                raw = b"".join(raw[i:i + 4][::-1] for i in range(0, 16, 4))
                host = socket.inet_ntop(family, raw)
            out.append({"host": host, "port": port})
    return out


def check_open_ports(ports: Optional[List[int]] = None) -> Dict[str, list]:
    """Report cluster ports listening on non-loopback addresses.

    With `ports=None`, checks the connected cluster's known ports (head RPC
    + dashboard). Returns {"open_to_network": [...], "loopback_only": [...]}.
    """
    if ports is None:
        ports = []
        try:
            from ray_tpu_torch.core.api import _global_client

            client = _global_client()
            ports.append(client.head_port)
            info = client.head_request("cluster_info")
            if info.get("dashboard_port"):
                ports.append(info["dashboard_port"])
        except Exception as e:
            # an empty report must not read as "all clear" when nothing
            # was actually checked
            raise RuntimeError(
                "could not determine cluster ports (is a cluster "
                f"connected?): {e!r}; pass ports=[...] explicitly") from e
    listening = _listening_sockets()
    loopback = {"127.0.0.1", "::1", "::ffff:127.0.0.1"}
    open_net, loop_only = [], []
    for port in ports:
        socks = [s for s in listening if s["port"] == port]
        exposed = [s for s in socks if s["host"] not in loopback]
        if exposed:
            open_net.append({"port": port, "interfaces": [s["host"] for s in exposed]})
        elif socks:
            loop_only.append(port)
    return {"open_to_network": open_net, "loopback_only": loop_only}
