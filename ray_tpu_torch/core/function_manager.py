"""Ship function/class definitions once, load lazily on workers.

Parity with the reference's FunctionActorManager
(`python/ray/_private/function_manager.py:58`): definitions are exported to
the head KV keyed by content hash; executing workers fetch + cache. Uses
cloudpickle so closures/lambdas work.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict

import cloudpickle

FUNCTION_NS = "fn"


class FunctionManager:
    def __init__(self, client):
        self.client = client
        self._exported: Dict[bytes, bytes] = {}   # key -> blob (local cache)
        self._loaded: Dict[bytes, Any] = {}

    def export(self, obj: Any) -> bytes:
        blob = cloudpickle.dumps(obj, protocol=5)
        key = hashlib.sha256(blob).digest()[:16]
        if key not in self._exported:
            suspect = getattr(self.client, "_head_suspect", None)
            if suspect is not None and suspect():
                # head unreachable/paused: a blocking KV export would
                # stall the very submission the peer mesh exists to keep
                # alive. Cache locally (headless dispatch ships the blob
                # inside the spec) and fire the export as a push — it is
                # buffered/dropped now and `resync()` re-pushes every
                # cached def on reconnect anyway.
                self._exported[key] = blob
                try:
                    self.client.head_push("kv_put", ns=FUNCTION_NS,
                                          key=key, value=blob,
                                          overwrite=False)
                except Exception:
                    pass
            else:
                self.client.kv_put(FUNCTION_NS, key, blob, overwrite=False)
                self._exported[key] = blob
        return key

    def resync(self) -> None:
        """Re-export every cached definition (head-restart recovery: a
        def exported after the last snapshot died with the old head, and
        in-flight/replayed tasks still reference it by hash)."""
        for key, blob in list(self._exported.items()):
            try:
                self.client.head_push("kv_put", ns=FUNCTION_NS, key=key,
                                      value=blob, overwrite=False)
            except Exception:
                pass

    def blob(self, key: bytes):
        """Locally cached serialized definition, or None — the submitter
        attaches this to specs dispatched while the head is unreachable
        so ANY worker can execute them without a head KV fetch (headless
        cold-path dispatch must not stall on function delivery)."""
        return self._exported.get(key)

    def load(self, key: bytes, blob: bytes = None) -> Any:
        if key in self._loaded:
            return self._loaded[key]
        if blob is not None and key not in self._exported:
            # definition rode the spec (headless dispatch): adopt it —
            # the content hash is the key, so a forged/corrupt blob
            # cannot impersonate a different function silently
            if hashlib.sha256(blob).digest()[:16] == key:
                self._exported[key] = blob
        blob = self._exported.get(key)
        if blob is None:
            import time as _time

            blob = self.client.kv_get(FUNCTION_NS, key)
            recovering = getattr(self.client, "head_recovering", None)
            if blob is None and recovering is not None and recovering():
                # a miss inside the head-restart recovery window (we rode
                # a reconnect, or we are a fresh process on a young head)
                # is probably transient: the restored head predates this
                # def and its exporter re-pushes on reconnect — poll
                # briefly. A miss with no restart in sight fails fast
                # (no 5 s stall for genuinely missing defs).
                deadline = _time.monotonic() + 5.0
                while blob is None and _time.monotonic() < deadline:
                    _time.sleep(0.2)
                    blob = self.client.kv_get(FUNCTION_NS, key)
            if blob is None:
                raise RuntimeError(f"function def {key.hex()} not found in KV")
        obj = cloudpickle.loads(blob)
        self._loaded[key] = obj
        return obj
