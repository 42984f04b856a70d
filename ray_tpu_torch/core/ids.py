"""Opaque identifiers for tasks/actors/objects/nodes.

The reference uses structured binary IDs with embedded job/actor indices
(`src/ray/common/id.h`, `id_specification.md`). We keep flat 16-byte random
ids — the ownership metadata lives in the tables instead — plus a readable
hex repr for logs.
"""

from __future__ import annotations

import os


class BaseID:
    __slots__ = ("_bin",)
    _size = 16

    def __init__(self, binary: bytes):
        assert isinstance(binary, bytes) and len(binary) == self._size, binary
        self._bin = binary

    @classmethod
    def generate(cls):
        return cls(os.urandom(cls._size))

    @classmethod
    def from_hex(cls, h: str):
        return cls(bytes.fromhex(h))

    def binary(self) -> bytes:
        return self._bin

    def hex(self) -> str:
        return self._bin.hex()

    def __eq__(self, other):
        return type(other) is type(self) and other._bin == self._bin

    def __hash__(self):
        return hash((type(self).__name__, self._bin))

    def __repr__(self):
        return f"{type(self).__name__}({self._bin.hex()[:12]})"

    def __reduce__(self):
        return (type(self), (self._bin,))


class ObjectID(BaseID):
    pass


class TaskID(BaseID):
    pass


class ActorID(BaseID):
    pass


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class JobID(BaseID):
    _size = 4


class PlacementGroupID(BaseID):
    pass
