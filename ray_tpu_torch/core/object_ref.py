"""ObjectRef: a future-like handle to a (possibly not yet created) object."""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.core import refcount
from ray_tpu_torch.core.ids import ObjectID


def _reconstruct_ref(object_id: ObjectID, token=None) -> "ObjectRef":
    """Unpickle path: the inc queued by ObjectRef() precedes the borrow
    commit on this process's ordered update stream, so the head records
    our hold before releasing the sender's borrow pin."""
    ref = ObjectRef(object_id)
    refcount.note_deserialized(object_id, token)
    return ref


class ObjectRef:
    __slots__ = ("id",)

    def __init__(self, object_id: ObjectID):
        assert isinstance(object_id, ObjectID)
        self.id = object_id
        # every live instance counts toward this process's interest in the
        # object (reference ReferenceCounter local refs); deserializing a
        # nested ref runs through here too
        refcount.note_created(object_id)

    def __del__(self):
        try:
            refcount.note_deleted(self.id)
        except Exception:
            pass  # interpreter teardown

    def binary(self) -> bytes:
        return self.id.binary()

    def hex(self) -> str:
        return self.id.hex()

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __hash__(self):
        return hash(self.id)

    def __repr__(self):
        return f"ObjectRef({self.id.hex()[:12]})"

    def __reduce__(self):
        # borrower protocol: pickling a ref opens a borrow pin at the head
        # (ordered before any later dec from this process); the token rides
        # the payload and whoever deserializes it commits the borrow
        return (_reconstruct_ref, (self.id, refcount.note_serialized(self.id)))

    # `await ref` inside async actors / drivers with a running loop
    def __await__(self):
        from ray_tpu_torch.core.api import _global_client

        client = _global_client()
        return client.get_async([self]).__await__()


class ObjectRefGenerator:
    """Iterator over the refs a streaming task yields
    (`num_returns="streaming"`; reference ObjectRefGenerator,
    `_raylet.pyx` + SURVEY §2.12b). Each `next()` blocks until the producer
    has yielded the next value, then returns its ObjectRef."""

    def __init__(self, gen_id: ObjectID):
        self._gen_id = gen_id
        self._index = 0
        self._exhausted = False
        self._released = False

    def _release(self) -> None:
        """Tell the head we are done with this stream: undelivered items
        are unpinned head-side (abandoning a generator must not pin its
        queue forever)."""
        if self._released:
            return
        self._released = True
        try:
            from ray_tpu_torch.core.api import _global_client

            import functools

            client = _global_client()
            client.loop.call_soon_threadsafe(functools.partial(
                client.conn.push, "generator_release",
                gen_id=self._gen_id.binary()))
        except Exception:
            pass  # no client / shutdown: head cleans up with the session

    def __del__(self):
        try:
            self._release()
        except Exception:
            pass

    def __iter__(self):
        return self

    def _advance(self, rep) -> ObjectRef:
        if rep.get("done") or self._exhausted:
            self._exhausted = True
            self._release()
            raise StopIteration
        if rep.get("error"):
            # the producer failed: yield its error ref once, then stop
            self._exhausted = True
        self._index += 1
        return ObjectRef(ObjectID(rep["ref"]))

    def __next__(self) -> ObjectRef:
        if self._exhausted:
            raise StopIteration
        from ray_tpu_torch.core.api import _global_client

        rep = _global_client().head_request(
            "generator_next", gen_id=self._gen_id.binary(), index=self._index)
        return self._advance(rep)

    def __aiter__(self):
        return self

    async def __anext__(self) -> ObjectRef:
        if self._exhausted:
            raise StopAsyncIteration
        from ray_tpu_torch.core.api import _global_client

        client = _global_client()
        rep = await client.conn.request(
            "generator_next", gen_id=self._gen_id.binary(), index=self._index)
        try:
            return self._advance(rep)
        except StopIteration:
            raise StopAsyncIteration from None

    def __reduce__(self):
        return (ObjectRefGenerator, (self._gen_id,))
