"""Per-session worker log capture + streaming.

Reference parity: `python/ray/_private/log_monitor.py` (file tailing,
batched publish to drivers) and the per-worker stdout/stderr redirection
configured at `python/ray/_private/node.py:1426-1427`. Re-shaped for this
runtime:

- every spawner (head, node daemon) redirects a worker's stdout/stderr at
  the **fd level** into `<STATE_DIR>/<session>/logs/worker-<tag>.{out,err}`
  — captures C-level writes and the final lines of a crashing process;
- a `LogMonitor` thread on each spawning process tails its node's log dir
  and batches appended lines; node daemons push batches to the head;
- the head keeps a bounded per-file ring (CLI / dashboard / state API all
  read it, so logs from remote nodes work without a shared filesystem)
  and fans batches out to connected drivers, which print them — a remote
  task's `print()` appears on the submitting driver by default
  (disable with `RAY_TPU_LOG_TO_DRIVER=0`).
"""

from __future__ import annotations

import os
import threading
import uuid
from typing import Callable, Dict, List, Optional, TextIO, Tuple

from ray_tpu_torch.utils.platform import STATE_DIR

MAX_LINE_LEN = 8192          # one pathological line must not balloon a batch
MAX_BATCH_LINES = 512
RING_LINES = 2000            # head-side retained lines per file
POLL_S = 0.15


def session_log_dir(session: str, subdir: Optional[str] = None) -> str:
    """`<STATE_DIR>/<session>/logs[/<subdir>]`. Each spawner tails only
    its own directory (the head the root, each node daemon a `node-<id>`
    subdir) so co-located monitors never double-report a line."""
    d = os.path.join(STATE_DIR, session, "logs")
    if subdir:
        d = os.path.join(d, subdir)
    os.makedirs(d, exist_ok=True)
    return d


def open_worker_logs(session: str, tag: Optional[str] = None,
                     subdir: Optional[str] = None
                     ) -> Tuple[TextIO, TextIO, str]:
    """Create the stdout/stderr files for a worker about to be spawned.
    Returns (out_file, err_file, tag); the spawner passes the files to
    Popen and the tag to the worker env (`RAY_TPU_LOG_TAG`) so the worker
    can report which files are its own at registration."""
    tag = tag or uuid.uuid4().hex[:10]
    d = session_log_dir(session, subdir)
    out = open(os.path.join(d, f"worker-{tag}.out"), "ab", buffering=0)
    err = open(os.path.join(d, f"worker-{tag}.err"), "ab", buffering=0)
    return out, err, tag


def find_log_file(session: str, filename: str) -> Optional[str]:
    """Locate a log file on this machine: session log root or any
    node subdir."""
    root = os.path.join(STATE_DIR, session, "logs")
    cand = os.path.join(root, filename)
    if os.path.exists(cand):
        return cand
    try:
        for sub in os.listdir(root):
            cand = os.path.join(root, sub, filename)
            if os.path.isdir(os.path.join(root, sub)) and os.path.exists(cand):
                return cand
    except OSError:
        pass
    return None


def list_log_files(session: str) -> Dict[str, int]:
    """All log files visible on this machine's session log tree."""
    out: Dict[str, int] = {}
    root = os.path.join(STATE_DIR, session, "logs")
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        path = os.path.join(root, name)
        if os.path.isdir(path):
            try:
                for sub in os.listdir(path):
                    try:
                        out[sub] = os.path.getsize(os.path.join(path, sub))
                    except OSError:
                        pass
            except OSError:
                pass
        else:
            try:
                out[name] = os.path.getsize(path)
            except OSError:
                pass
    return out


class LogMonitor(threading.Thread):
    """Tails `worker-*.{out,err}` files in one directory; invokes
    `emit(entries)` with `entries = [{"file": name, "lines": [...]}]`
    for freshly appended complete lines. Thread-safe against concurrent
    file creation; a deleted/truncated file restarts from its new end."""

    def __init__(self, log_dir: str,
                 emit: Callable[[List[dict]], None]):
        super().__init__(daemon=True, name="log-monitor")
        self.log_dir = log_dir
        self.emit = emit
        self._offsets: Dict[str, int] = {}
        self._partial: Dict[str, bytes] = {}
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                batch = self._scan()
            except Exception:
                batch = []
            if batch:
                try:
                    self.emit(batch)
                except Exception:
                    pass
            self._stop.wait(POLL_S)

    def _scan(self) -> List[dict]:
        entries: List[dict] = []
        try:
            names = sorted(os.listdir(self.log_dir))
        except OSError:
            return entries
        for name in names:
            if not (name.startswith("worker-")
                    and (name.endswith(".out") or name.endswith(".err"))):
                continue
            path = os.path.join(self.log_dir, name)
            try:
                size = os.path.getsize(path)
            except OSError:
                self._offsets.pop(name, None)
                self._partial.pop(name, None)
                continue
            off = self._offsets.get(name, 0)
            if size < off:      # truncated/replaced: resync to the start
                off = 0
                self._partial.pop(name, None)
            if size == off:
                continue
            try:
                with open(path, "rb") as f:
                    f.seek(off)
                    data = f.read(min(size - off,
                                      MAX_BATCH_LINES * MAX_LINE_LEN))
            except OSError:
                continue
            self._offsets[name] = off + len(data)
            data = self._partial.pop(name, b"") + data
            *lines, tail = data.split(b"\n")
            if tail:
                if len(tail) > MAX_LINE_LEN:  # unterminated runaway line
                    lines.append(tail)
                else:
                    self._partial[name] = tail
            out = [ln[:MAX_LINE_LEN].decode("utf-8", "replace")
                   for ln in lines if ln]
            if out:
                entries.append({"file": name, "lines": out})
        return entries


MAX_LOG_FILES_RETAINED = 512   # head-side ring: bound files under churn


def read_log_lines(path: str, tail: Optional[int] = None) -> List[str]:
    """Read a log file's lines; `tail` reads only the end of the file
    (seek-from-end, bounded bytes) so a multi-GB log never loads whole."""
    with open(path, "rb") as f:
        if tail:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            budget = min(size, (tail + 1) * MAX_LINE_LEN)
            f.seek(size - budget)
            data = f.read(budget)
            if budget < size:  # first line is probably partial: drop it
                data = data.split(b"\n", 1)[-1]
        else:
            data = f.read()
    lines = [ln.decode("utf-8", "replace") for ln in data.split(b"\n") if ln]
    return lines[-tail:] if tail else lines


def format_driver_line(entry: dict, line: str) -> str:
    """Reference-style prefix: `(pid=123, worker-ab12cd) line`; stderr
    lines keep their stream visible."""
    pid = entry.get("pid")
    stem = entry["file"].rsplit(".", 1)[0]
    stream = entry["file"].rsplit(".", 1)[-1]
    who = f"pid={pid}, {stem}" if pid else stem
    mark = " [err]" if stream == "err" else ""
    return f"({who}){mark} {line}"


def print_driver_entries(entries: List[dict]) -> None:
    """Print streamed worker-log entries at a driver's terminal (local
    CoreClient and remote ProxyClient share this; format changes and the
    RAY_TPU_LOG_TO_DRIVER opt-out must never diverge between them)."""
    import sys

    from ray_tpu_torch.core import config as _config

    if not _config.get("log_to_driver"):
        return
    out = []
    for e in entries:
        for line in e.get("lines", []):
            out.append(format_driver_line(e, line))
    if out:
        print("\n".join(out), file=sys.stderr, flush=True)
