"""ctypes bindings for the native arena object store (csrc/arena_store.cc).

Builds the native library on demand with ``g++`` into
``ray_tpu_torch/_build/`` (ignored by git), named by a hash of its sources
and the flags, and exposes `Arena`: one shm segment per node holding every
object, with the C++ side owning the allocator/table/LRU and Python mapping
the same segment via `mmap` for zero-copy payload views. The same library
holds the compiled DAGs' ring channels (csrc/channel.cc, bound by
`ray_tpu_torch.dag.channel`). Without a compiler `native_available()` is
False: the object store then uses per-object segments, and a `Channel`
raises.

Counterpart of `ray_tpu/core/native_store.py`, which runs ``make`` inside
``ray_tpu/_native/`` and loads the library from there. The port keeps its
own copies of ``arena_store.cc`` and ``channel.cc``.

Reference counterpart: the plasma client (`src/ray/object_manager/plasma/
client.h`) — except create/seal/get here are in-process calls on shared
state, not socket round-trips.
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCES = [os.path.join(_PKG, "csrc", name)
            for name in ("arena_store.cc", "channel.cc")]
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-shared"]
LD_FLAGS = ["-lpthread", "-lrt"]
_lib = None
_lib_lock = threading.Lock()
ID_LEN = 16


def lib_path() -> str:
    """The library's path, named by a hash of its sources and flags, so an
    edited source is rebuilt and never confused with an old library."""
    h = hashlib.sha256()
    for src in _SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"native_store-{h.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    """g++ into a private temp name, then an atomic rename: the head and
    its workers may race to build the same library."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *CXX_FLAGS, *_SOURCES, "-o", tmp, *LD_FLAGS],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _build_and_load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.rtpu_store_create.restype = ctypes.c_void_p
        lib.rtpu_store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.rtpu_store_attach.restype = ctypes.c_void_p
        lib.rtpu_store_attach.argtypes = [ctypes.c_char_p]
        lib.rtpu_store_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rtpu_store_alloc.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64)]
        lib.rtpu_store_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_store_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int]
        lib.rtpu_store_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_store_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_int]
        lib.rtpu_store_evict_candidates.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int]
        lib.rtpu_store_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
        lib.rtpu_store_data_offset.restype = ctypes.c_uint64
        lib.rtpu_store_data_offset.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _build_and_load() is not None


class ArenaError(Exception):
    pass


class ObjectExistsError(ArenaError):
    pass


class ArenaFullError(ArenaError):
    pass


class Arena:
    """A created-or-attached node arena. Thread-safe (C side locks)."""

    def __init__(self, name: str, handle, lib):
        self.name = name
        self._h = handle
        self._lib = lib
        # map the same segment for python-side payload access
        fd = os.open(f"/dev/shm/{name}", os.O_RDWR)
        try:
            self._mm = mmap.mmap(fd, 0)
        finally:
            os.close(fd)
        self._view = memoryview(self._mm)
        self._pins: Dict[bytes, int] = {}
        self._pin_lock = threading.Lock()
        self._closed = False

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def create(cls, name: str, capacity: int) -> "Arena":
        lib = _build_and_load()
        if lib is None:
            raise ArenaError("native store unavailable")
        h = lib.rtpu_store_create(name.encode(), capacity)
        if not h:
            raise ArenaError(f"failed to create arena {name}")
        return cls(name, h, lib)

    @classmethod
    def attach(cls, name: str) -> "Arena":
        lib = _build_and_load()
        if lib is None:
            raise ArenaError("native store unavailable")
        h = lib.rtpu_store_attach(name.encode())
        if not h:
            raise ArenaError(f"failed to attach arena {name}")
        return cls(name, h, lib)

    def close(self, unlink: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        with self._pin_lock:
            for oid, n in list(self._pins.items()):
                for _ in range(n):
                    self._lib.rtpu_store_release(self._h, oid)
            self._pins.clear()
        try:
            self._view.release()
            self._mm.close()
        except BufferError:
            pass  # live views alias the mapping; keep it until GC
        self._lib.rtpu_store_close(self._h, 1 if unlink else 0)
        self._h = None

    # -- object ops --------------------------------------------------------
    def create_buffer(self, oid: bytes, size: int) -> memoryview:
        """Allocate an unsealed object; returns a writable view of its bytes."""
        off = ctypes.c_uint64()
        rc = self._lib.rtpu_store_alloc(self._h, oid, size, ctypes.byref(off))
        if rc == -2:
            raise ObjectExistsError(oid.hex())
        if rc in (-1, -3):
            raise ArenaFullError(f"arena {self.name} cannot fit {size} bytes")
        if rc != 0:
            raise ArenaError(f"alloc failed rc={rc}")
        return self._view[off.value:off.value + size]

    def seal(self, oid: bytes) -> None:
        if self._lib.rtpu_store_seal(self._h, oid) != 0:
            raise ArenaError(f"seal: unknown object {oid.hex()}")

    def get(self, oid: bytes, pin: bool = True) -> memoryview:
        """Zero-copy read view; pins the object until release()/close()."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.rtpu_store_get(self._h, oid, ctypes.byref(off),
                                      ctypes.byref(size), 1 if pin else 0)
        if rc == -1:
            raise KeyError(oid.hex())
        if rc == -3:
            raise ArenaError(f"object {oid.hex()} not sealed")
        if rc != 0:
            raise ArenaError(f"get failed rc={rc}")
        if pin:
            with self._pin_lock:
                self._pins[oid] = self._pins.get(oid, 0) + 1
        return self._view[off.value:off.value + size.value]

    def release(self, oid: bytes) -> None:
        with self._pin_lock:
            if self._pins.get(oid, 0) <= 0:
                return
            self._pins[oid] -= 1
            if self._pins[oid] == 0:
                del self._pins[oid]
        self._lib.rtpu_store_release(self._h, oid)

    def delete(self, oid: bytes, force: bool = False) -> bool:
        return self._lib.rtpu_store_delete(self._h, oid, 1 if force else 0) == 0

    def contains(self, oid: bytes) -> bool:
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        return self._lib.rtpu_store_get(self._h, oid, ctypes.byref(off),
                                        ctypes.byref(size), 0) == 0

    def evict_candidates(self, needed: int, max_out: int = 256) -> List[bytes]:
        buf = ctypes.create_string_buffer(max_out * ID_LEN)
        n = self._lib.rtpu_store_evict_candidates(self._h, needed, buf, max_out)
        if n < 0:
            return []
        raw = buf.raw
        return [raw[i * ID_LEN:(i + 1) * ID_LEN] for i in range(n)]

    def stats(self) -> Tuple[int, int, int]:
        used = ctypes.c_uint64()
        cap = ctypes.c_uint64()
        cnt = ctypes.c_uint64()
        self._lib.rtpu_store_stats(self._h, ctypes.byref(used),
                                   ctypes.byref(cap), ctypes.byref(cnt))
        return used.value, cap.value, cnt.value
