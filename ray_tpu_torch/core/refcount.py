"""Client-side reference tracking for automatic object lifetime.

Capability parity with the reference's distributed ReferenceCounter
(`src/ray/core_worker/reference_count.h:73`), re-shaped for this runtime's
head-centric design: each process counts live `ObjectRef` instances per
object; the 0→1 / 1→0 transitions are batched and pushed to the head,
which keeps the global interest set (holders ∪ in-flight task deps ∪
containment edges ∪ borrow pins ∪ lineage pins) and evicts objects when
it empties — so `free()` becomes optional instead of mandatory.

Borrower protocol (reference `reference_count.h:73` borrowers): whenever
an ObjectRef is pickled, the sender queues a `borrow_begin(oid, token)`
on the SAME ordered stream as its inc/dec transitions and embeds the
token in the pickle payload; whoever deserializes the ref queues
`borrow_commit(token)` right AFTER its own inc. The head holds a borrow
pin from begin until commit, so a ref handed off through any channel
(direct actor call, task args, KV, raw bytes) survives the sender
dropping its own refs — no eviction grace window needed. Per-stream FIFO
gives the two orderings that matter: begin-before-sender-dec and
receiver-inc-before-commit. Uncommitted borrows are released when the
sending process dies.

Enablement is negotiated, not read from each process's env: the head
reports its `refcount_enabled` in the `register_worker` reply and every
client follows it, so a process whose environment differs can never
silently stop reporting holds to a head that evicts on their absence.
Until the reply arrives the tracker queues events without sending.
"""

from __future__ import annotations

import itertools
import os
import threading
from collections import deque
from typing import Dict, List, Optional

from ray_tpu_torch.core.ids import ObjectID

def _flush_s() -> float:
    from ray_tpu_torch.core import config

    return config.get("refcount_flush_s")

_active: Optional["RefTracker"] = None


def note_created(oid: ObjectID) -> None:
    t = _active
    if t is not None:
        t.inc(oid)


def note_deleted(oid: ObjectID) -> None:
    t = _active
    if t is not None:
        t.dec(oid)


def note_serialized(oid: ObjectID) -> Optional[bytes]:
    """An ObjectRef is being pickled: open a borrow pin at the head.
    Returns the token to embed in the payload (None when untracked)."""
    t = _active
    if t is not None:
        return t.borrow_begin(oid)
    return None


def note_deserialized(oid: ObjectID, token: Optional[bytes]) -> None:
    """An ObjectRef was just reconstructed from a pickle payload carrying
    `token`; queued after the reconstruction's inc, so the head sees our
    hold before the borrow pin drops."""
    t = _active
    if t is not None and token is not None:
        t.borrow_commit(oid, token)


def activate(tracker: Optional["RefTracker"]) -> None:
    global _active
    _active = tracker


class RefTracker:
    """Per-process live-ObjectRef counts; flushes transitions to the head.

    Lock-free event intake: `inc`/`dec`/borrow events only append to a
    deque — `ObjectRef.__del__` can fire from a GC triggered at ANY
    allocation point (including inside this module), so taking a lock
    there would self-deadlock the thread that owns it. Counting and
    transition detection happen in `_flush`, which drains the deque in
    append order under a lock no __del__ path ever touches."""

    def __init__(self, client):
        self.client = client
        self.counts: Dict[ObjectID, int] = {}
        self._events: "deque" = deque()  # (kind, ObjectID[, token]), append-only
        self._flush_lock = threading.Lock()
        self._ops: List[tuple] = []      # unsent ordered transitions
        self._flush_scheduled = False
        # None = not yet negotiated with the head: queue but don't send.
        # Set from the head's register_worker reply (single source of truth).
        self.enabled: Optional[bool] = None
        self._token_seq = itertools.count()
        self._token_prefix = os.urandom(8)

    def set_enabled(self, value: bool) -> None:
        with self._flush_lock:
            self.enabled = bool(value)
            if not value:
                self._events.clear()
                self._ops = []
                self.counts = {}
        if value:
            self._schedule()

    def inc(self, oid: ObjectID) -> None:
        if self.enabled is False:
            return
        self._events.append(("i", oid))
        self._schedule()

    def dec(self, oid: ObjectID) -> None:
        if self.enabled is False:
            return
        self._events.append(("d", oid))
        self._schedule()

    def borrow_begin(self, oid: ObjectID) -> Optional[bytes]:
        if self.enabled is False:
            return None
        token = self._token_prefix + next(self._token_seq).to_bytes(8, "little")
        self._events.append(("b", oid, token))
        self._schedule()
        return token

    def borrow_commit(self, oid: ObjectID, token: bytes) -> None:
        if self.enabled is False:
            return
        self._events.append(("c", oid, token))
        self._schedule()

    def _schedule(self) -> None:
        # benign race on the flag: worst case an extra no-op flush.
        # Batch for FLUSH_S so ref churn costs one push, not one RPC per
        # ref (reference: batched WaitForRefRemoved).
        if self._flush_scheduled:
            return
        self._flush_scheduled = True
        try:
            self.client.loop.call_soon_threadsafe(
                lambda: self.client.loop.call_later(_flush_s(), self._flush))
        except RuntimeError:
            self._flush_scheduled = False  # loop closed (shutdown)

    def _drain(self) -> None:
        """Fold queued events into counts; emit 0<->1 transitions and
        borrow events in event order. _flush_lock held."""
        while True:
            try:
                ev = self._events.popleft()
            except IndexError:
                return
            kind, oid = ev[0], ev[1]
            if kind == "i":
                c = self.counts.get(oid, 0) + 1
                self.counts[oid] = c
                if c == 1:
                    self._ops.append(("i", oid.binary()))
            elif kind == "d":
                c = self.counts.get(oid, 0) - 1
                if c > 0:
                    self.counts[oid] = c
                else:
                    self.counts.pop(oid, None)
                    self._ops.append(("d", oid.binary()))
            else:  # borrow begin/commit ride the same ordered stream
                self._ops.append((kind, oid.binary(), ev[2]))

    def _flush(self) -> None:
        # drain + send under one lock: a concurrent flush slipping a newer
        # batch onto the wire while a failed older batch awaits requeue
        # would reorder inc/dec at the head
        with self._flush_lock:
            self._flush_scheduled = False
            self._drain()
            if not self._ops or self.enabled is not True:
                return  # enabled None: hold ops until negotiation lands
            conn = self.client.conn
            if conn is None or conn.closed:
                return  # ops kept; retried on the next transition's flush
            try:
                conn.push("ref_update", ops=self._ops)
                self._ops = []
            except Exception:
                pass  # kept for retry, order preserved

    def flush_now(self) -> None:
        """Synchronous flush (tests / shutdown)."""
        self._flush()

    def resync(self) -> None:
        """A restarted head wiped its holder state: re-announce every oid
        this process still holds, ordered BEFORE any queued transitions so
        a pending dec can never race ahead of its re-announced inc."""
        with self._flush_lock:
            self._drain()
            self._ops = [("i", oid.binary()) for oid in self.counts] \
                + self._ops
        self._flush()
