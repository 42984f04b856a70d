"""Usage-stats telemetry (opt-in here; the reference is opt-out).

Parity: `python/ray/_common/usage/usage_lib.py` — a periodic ping with
cluster metadata and library-usage tags. This build runs in egress-less
environments, so the transport is pluggable: the default reporter writes
JSON lines under the session dir (operators ship them however they like);
a custom reporter callable can POST wherever. Controlled by the
`usage_stats` config flag (RAY_TPU_USAGE_STATS; default off).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Callable, Dict, Optional, Set

from ray_tpu_torch.utils.platform import STATE_DIR

_lock = threading.Lock()
_library_usages: Set[str] = set()
_extra_tags: Dict[str, str] = {}
_thread: Optional[threading.Thread] = None
_stop = threading.Event()


def record_library_usage(name: str) -> None:
    """Called by Train/Tune/Serve/Data/RLlib entry points (reference
    `record_library_usage`): which libraries a cluster actually used."""
    with _lock:
        _library_usages.add(name)


def record_extra_usage_tag(key: str, value: str) -> None:
    with _lock:
        _extra_tags[key] = str(value)


def usage_stats_enabled() -> bool:
    from ray_tpu_torch.core import config as _config

    return bool(_config.get("usage_stats"))


def _collect(session: str) -> dict:
    import ray_tpu_torch

    try:
        from ray_tpu_torch.core.api import _global_client

        client = _global_client()
        info = client.head_request("cluster_info") if client else {}
    except Exception:
        info = {}
    with _lock:
        libs = sorted(_library_usages)
        tags = dict(_extra_tags)
    return {
        "schema_version": "0.1",
        "source": "ray_tpu_torch",
        "session_id": session,
        "timestamp": int(time.time()),
        "python_version": sys.version.split()[0],
        "version": getattr(ray_tpu_torch, "__version__", "0.0.0"),
        "os": sys.platform,
        "total_num_nodes": info.get("num_nodes"),
        "total_resources": info.get("total_resources"),
        "library_usages": libs,
        "extra_usage_tags": tags,
    }


def default_reporter(payload: dict) -> None:
    """Egress-less default: append a JSON line under the session dir."""
    path = os.path.join(STATE_DIR, "usage_stats.jsonl")
    os.makedirs(STATE_DIR, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(payload) + "\n")


def start_usage_stats_heartbeat(
        session: str, interval_s: float = 300.0,
        reporter: Optional[Callable[[dict], None]] = None) -> bool:
    """Begin periodic reporting if enabled. Returns whether it started."""
    global _thread
    if not usage_stats_enabled() or _thread is not None:
        return False
    reporter = reporter or default_reporter
    _stop.clear()

    def loop():
        while not _stop.is_set():
            try:
                reporter(_collect(session))
            except Exception:
                pass  # telemetry must never break the cluster
            _stop.wait(interval_s)

    _thread = threading.Thread(target=loop, daemon=True,
                               name="usage-stats")
    _thread.start()
    return True


def stop_usage_stats_heartbeat() -> None:
    global _thread
    _stop.set()
    if _thread is not None:
        _thread.join(timeout=2)
        _thread = None
