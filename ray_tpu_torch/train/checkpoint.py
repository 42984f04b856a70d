"""Checkpoint handle, top-K retention manager and world-size-agnostic
sharded checkpoints (counterpart of `ray_tpu/train/checkpoint.py`).

`Checkpoint` is a handle to a directory of checkpoint files, local or any
fsspec URI (`utils.fs`); `CheckpointManager` copies reported checkpoints
into durable storage and keeps the top K by a metric (`CheckpointConfig`).

Sharded checkpoints keep the JAX package's on-disk format, so either
package restores what the other saved:

    manifest_p<process>.json   one per saving process
    shards_p<process>.npz      that process's chunks, keyed "<leaf>::<i>"

The manifest (``"format": "ray_tpu.sharded_ckpt.v1"``) records each leaf's
GLOBAL shape and dtype and, per chunk, the global index window it covers,
so a checkpoint saved at world size W restores at any other: the reader
gathers chunks into full arrays (`load_sharded`) or streams windows of
them (`open_sharded`), and the caller reshards onto whatever mesh it runs
(`train.spmd.restore_state_sharded`).

Leaves are tensors (a `DTensor` writes this rank's shard with its global
window), numpy arrays or Python scalars. bf16 leaves are stored as the JAX
package stores them: two-byte ``'<V2'`` members with the manifest dtype
``"bfloat16"``. numpy has no bf16, so on the host the port carries their
bits as int16 (`BF16_BITS`), which a reader turns into `torch.bfloat16`
with a view, never a cast.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import tempfile
import time
import zipfile
from itertools import product
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.train.config import CheckpointConfig
from ray_tpu_torch.utils import fs as _fs


class Checkpoint:
    """A handle to a directory of checkpoint files, local or remote."""

    def __init__(self, path: str):
        self.path = _fs.abspath(path)
        self._local_cache: Optional[str] = None

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def as_directory(self) -> str:
        """A local directory with the checkpoint contents; remote
        checkpoints download once per handle."""
        if not _fs.is_uri(self.path):
            return self.path
        if self._local_cache is None or not os.path.isdir(self._local_cache):
            self._local_cache = _fs.get_dir(
                self.path, tempfile.mkdtemp(prefix="ckpt_dl_"))
        return self._local_cache

    def to_directory(self, path: Optional[str] = None) -> str:
        dest = path or tempfile.mkdtemp(prefix="ckpt_")
        return _fs.get_dir(self.path, dest)

    def __repr__(self):
        return f"Checkpoint({self.path})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))


# ---------------------------------------------------------------------------
# World-size-agnostic sharded checkpoints
# ---------------------------------------------------------------------------

SHARDED_FORMAT = "ray_tpu.sharded_ckpt.v1"
# the host carrier of a bf16 leaf's bits (numpy has no bf16)
BF16_BITS = np.dtype(np.int16)
# the npy descr the JAX package writes for bf16 (ml_dtypes' dtype.str)
_BF16_DESCR = "<V2"


def _leaf_key(key_path) -> str:
    return "/".join(str(k) for k in key_path)


def _flatten_with_path(tree, prefix=()) -> List[tuple]:
    """[(key path, leaf)] of nested dicts in JAX's flatten order (keys
    sorted); anything else is a leaf."""
    if isinstance(tree, dict):
        return [kl for k in sorted(tree)
                for kl in _flatten_with_path(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host; bf16 as its bits (`BF16_BITS`)."""
    import torch

    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def _dtype_name(leaf) -> str:
    import torch

    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(leaf.dtype).removeprefix("torch.")
    return np.asarray(leaf).dtype.name


def _chunk_windows(leaf) -> List[tuple]:
    """[(index_window, numpy_chunk)] covering the data this process holds.

    `index_window` is [[start, stop], ...] per dim in GLOBAL coordinates.
    A DTensor gives this rank's local shard, its window taken from the
    shard's global offset and local shape (DTensor's layout,
    `parallel.mesh.local_window`); a rank holds one shard, so replicated
    copies of a window are one chunk here, as the JAX package dedups
    `addressable_shards`. Anything else is one full-cover chunk."""
    import torch
    from torch.distributed.tensor import DTensor, Partial

    if isinstance(leaf, DTensor):
        from ray_tpu_torch.parallel.mesh import local_window

        if any(isinstance(p, Partial) for p in leaf.placements):
            raise ValueError(f"cannot save a Partial DTensor "
                             f"({leaf.placements}): reduce it first")
        win = local_window(leaf.shape, leaf.device_mesh, leaf.placements)
        return [([[s.start, s.stop] for s in win], _host(leaf.to_local()))]
    data = _host(leaf) if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    return [([[0, int(s)] for s in data.shape], data)]


def _savez(f, blobs: Dict[str, tuple]) -> None:
    """np.savez's layout (an uncompressed zip of ``<name>.npy`` members),
    with bf16 members' headers naming ``'<V2'`` as the JAX package's do.
    `blobs` maps a member name to (array, is_bf16)."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, (arr, bf16) in blobs.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as member:
                if not bf16:
                    np.lib.format.write_array(member, arr,
                                              allow_pickle=False)
                    continue
                arr = np.ascontiguousarray(arr)
                np.lib.format.write_array_header_1_0(member, {
                    "descr": _BF16_DESCR, "fortran_order": False,
                    "shape": arr.shape})
                member.write(arr.tobytes())


def save_sharded(tree: Any, path: str, *, step: int = 0,
                 world_size: int = 1, process_index: int = 0,
                 extra: Optional[Dict[str, Any]] = None) -> str:
    """Per-leaf save of a (possibly mesh-sharded) tree of nested dicts.

    Every process of a multi-process job calls this with its own
    `process_index`; each writes only the chunks it holds, so no process
    ever materializes another's shards. A single process writes the full
    set."""
    import torch

    _fs.makedirs(path)
    params: Dict[str, Any] = {}
    chunks: List[dict] = []
    blobs: Dict[str, tuple] = {}
    for kp, leaf in _flatten_with_path(tree):
        key = _leaf_key(kp)
        dtype = _dtype_name(leaf)
        params[key] = {"shape": list(np.shape(leaf) if not isinstance(
            leaf, torch.Tensor) else leaf.shape), "dtype": dtype}
        for i, (window, data) in enumerate(_chunk_windows(leaf)):
            blob_key = f"{key}::{i}"
            blobs[blob_key] = (data, dtype == "bfloat16")
            chunks.append({"leaf": key, "blob": blob_key, "index": window})
    manifest = {"format": SHARDED_FORMAT, "step": int(step),
                "world_size": int(world_size),
                "process_index": int(process_index),
                "params": params, "chunks": chunks, **(extra or {})}
    buf = io.BytesIO()
    _savez(buf, blobs)
    with _fs.open(_fs.join(path, f"shards_p{process_index:05d}.npz"),
                  "wb") as f:
        f.write(buf.getvalue())
    with _fs.open(_fs.join(path, f"manifest_p{process_index:05d}.json"),
                  "w") as f:
        json.dump(manifest, f)
    return path


def is_sharded_checkpoint(path: str) -> bool:
    return _fs.exists(_fs.join(path, "manifest_p00000.json"))


def _read_process_manifests(path: str) -> List[Dict[str, Any]]:
    manifests = []
    i = 0
    while True:
        mp = _fs.join(path, f"manifest_p{i:05d}.json")
        if not _fs.exists(mp):
            break
        with _fs.open(mp, "r") as f:
            manifests.append(json.load(f))
        i += 1
    if not manifests:
        raise FileNotFoundError(f"no sharded-checkpoint manifest in {path}")
    return manifests


def _merged(manifests: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The merged view across all saving processes (their global sections
    are identical; chunk lists concatenate)."""
    merged = dict(manifests[0])
    merged["chunks"] = [c for m in manifests for c in m["chunks"]]
    merged["num_save_processes"] = len(manifests)
    return merged


def read_sharded_manifest(path: str) -> Dict[str, Any]:
    return _merged(_read_process_manifests(path))


def _bits(data: np.ndarray) -> np.ndarray:
    """A member read back: two-byte void (a bf16 member) as `BF16_BITS`."""
    if data.dtype.kind == "V" and data.dtype.itemsize == 2:
        return data.view(BF16_BITS)
    return data


def load_sharded(path: str) -> tuple:
    """Gather-on-restore: returns ({leaf_key: np.ndarray}, manifest) with
    every leaf assembled to its GLOBAL shape, regardless of the world size
    or mesh it was saved under (bf16 leaves as `BF16_BITS`)."""
    manifests = _read_process_manifests(path)
    manifest = _merged(manifests)
    out: Dict[str, Any] = {}
    windows: Dict[str, set] = {}   # leaf -> distinct index windows written
    for p, proc_manifest in enumerate(manifests):
        with _fs.open(_fs.join(path, f"shards_p{p:05d}.npz"), "rb") as f:
            blob = io.BytesIO(f.read())
        with np.load(blob) as z:
            # ONLY this process's chunk list: blob keys ("<leaf>::<i>")
            # repeat across processes, so matching the merged list against
            # z.files would write one process's data into every process's
            # windows
            for chunk in proc_manifest["chunks"]:
                if chunk["blob"] not in z.files:
                    raise ValueError(
                        f"shards_p{p:05d}.npz is missing {chunk['blob']} "
                        f"declared by its manifest")
                key = chunk["leaf"]
                spec = manifest["params"][key]
                if key not in out:
                    out[key] = np.empty(tuple(spec["shape"]),
                                        dtype=_np_dtype(spec["dtype"]))
                    windows[key] = set()
                window = tuple(slice(a, b) for a, b in chunk["index"])
                data = _bits(z[chunk["blob"]])
                if out[key][window].shape != data.shape:
                    raise ValueError(
                        f"chunk {chunk['blob']}: window {chunk['index']} "
                        f"does not match data shape {data.shape}")
                # replicated windows may arrive from several processes;
                # last write wins (bitwise-identical by contract)
                out[key][window] = data
                windows[key].add(tuple((a, b) for a, b in chunk["index"]))
    for key, spec in manifest["params"].items():
        if key not in out or not _windows_cover(windows[key],
                                                tuple(spec["shape"])):
            raise ValueError(
                f"sharded checkpoint {path} is missing data for {key!r} "
                f"(windows {sorted(windows.get(key, ()))} do not cover "
                f"shape {spec['shape']})")
    return out, manifest


class _LazyNpz:
    """Row-range reads from an UNCOMPRESSED npz (what `save_sharded`
    writes): the npy header of a member is parsed once, after which any
    leading-dim row range seek-reads straight out of the zip, and no blob
    ever materializes whole. (A compressed member still reads correctly:
    `ZipExtFile.seek` decompresses forward, trading speed, not memory.)

    Every read opens the file anew: `reshard_streaming` reads from several
    threads, and one `ZipFile` shared by them is not safe (CPython 3.12's
    fast seek moves the shared file relative to wherever another thread
    left it)."""

    def __init__(self, path: str):
        self._path = path
        self._meta: Dict[str, tuple] = {}  # member -> (shape, dtype, off)

    @contextlib.contextmanager
    def _member(self, name: str):
        with _fs.open(self._path, "rb") as raw, zipfile.ZipFile(raw) as zf, \
                zf.open(name + ".npy") as f:
            yield f

    def _header(self, name: str) -> tuple:
        if name not in self._meta:
            with self._member(name) as f:
                version = np.lib.format.read_magic(f)
                if version == (1, 0):
                    shape, fortran, dtype = (
                        np.lib.format.read_array_header_1_0(f))
                else:
                    shape, fortran, dtype = (
                        np.lib.format.read_array_header_2_0(f))
                if fortran:
                    raise ValueError(
                        f"{name}: fortran-order member has no row-major "
                        f"row ranges; save_sharded never writes these")
                self._meta[name] = (tuple(shape), dtype, f.tell())
        return self._meta[name]

    def read_rows(self, name: str, r0: int, r1: int) -> np.ndarray:
        """Rows [r0, r1) of member `name`'s leading dim (the full scalar
        for 0-d members)."""
        shape, dtype, off = self._header(name)
        row = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize
        with self._member(name) as f:
            f.seek(off + r0 * row if shape else off)
            buf = f.read((r1 - r0) * row if shape else dtype.itemsize)
        return _bits(np.frombuffer(buf, dtype).reshape(
            (r1 - r0,) + shape[1:] if shape else ()))


def open_sharded(path: str) -> tuple:
    """Lazy view of a sharded checkpoint: ({leaf_key: WindowedReader},
    merged manifest) with NO array data loaded. Each reader's
    `.read(window)` seek-reads only the intersecting rows of the
    intersecting chunk blobs, so the streaming restore
    (`reshard_streaming`, `restore_state_sharded(stream_chunk_bytes=)`)
    holds chunk-scale host memory where `load_sharded` gathers the model.
    Coverage is validated up front, exactly like `load_sharded`."""
    from ray_tpu_torch.util.collective.reshard import WindowedReader

    manifests = _read_process_manifests(path)
    manifest = _merged(manifests)
    npzs = [_LazyNpz(_fs.join(path, f"shards_p{p:05d}.npz"))
            for p in range(len(manifests))]

    def _loader(key, r0, r1):
        proc, blob = key
        return npzs[proc].read_rows(blob, r0, r1)

    per_leaf: Dict[str, list] = {}
    windows: Dict[str, set] = {}
    for p, pm in enumerate(manifests):
        for chunk in pm["chunks"]:
            win = tuple((int(a), int(b)) for a, b in chunk["index"])
            per_leaf.setdefault(chunk["leaf"], []).append(
                (win, (p, chunk["blob"])))
            windows.setdefault(chunk["leaf"], set()).add(win)
    readers: Dict[str, Any] = {}
    for key, spec in manifest["params"].items():
        shape = tuple(spec["shape"])
        if key not in per_leaf or not _windows_cover(windows[key], shape):
            raise ValueError(
                f"sharded checkpoint {path} is missing data for {key!r} "
                f"(windows {sorted(windows.get(key, ()))} do not cover "
                f"shape {shape})")
        readers[key] = WindowedReader(shape, _np_dtype(spec["dtype"]),
                                      per_leaf[key], _loader)
    return readers, manifest


def _windows_cover(windows: set, shape: tuple) -> bool:
    """Whether axis-aligned index windows jointly cover `shape`, without
    materializing a per-element mask. Full-cover and disjoint-tile layouts,
    everything real shardings produce, resolve by volume bookkeeping;
    overlapping partial windows fall back to a coordinate-grid check over
    the distinct boundaries."""
    total = math.prod(shape) if shape else 1
    if not shape:
        return bool(windows)
    full = tuple((0, s) for s in shape)
    if full in windows:
        return True

    def volume(w):
        return math.prod(b - a for a, b in w)

    def overlaps(w1, w2):
        return all(a1 < b2 and a2 < b1
                   for (a1, b1), (a2, b2) in zip(w1, w2))

    wins = sorted(windows)
    disjoint = all(not overlaps(wins[i], wins[j])
                   for i in range(len(wins)) for j in range(i + 1, len(wins)))
    if disjoint:
        return sum(volume(w) for w in wins) >= total
    # overlapping partial windows: every cell of the grid of distinct
    # per-axis boundaries must fall inside some window
    axes_cuts = []
    for dim, size in enumerate(shape):
        cuts = {0, size}
        for w in wins:
            cuts.update(w[dim])
        axes_cuts.append(sorted(cuts))
    for cell in product(*([(lo, hi) for lo, hi in zip(cs, cs[1:])]
                          for cs in axes_cuts)):
        if not any(all(a <= lo and hi <= b
                       for (lo, hi), (a, b) in zip(cell, w))
                   for w in wins):
            return False
    return True


def _np_dtype(name: str) -> np.dtype:
    """The host dtype of a manifest dtype: bf16 as `BF16_BITS`."""
    return BF16_BITS if name == "bfloat16" else np.dtype(name)


class CheckpointManager:
    """Persists reported checkpoints under storage_path, keeps top-K."""

    def __init__(self, storage_path: str,
                 config: Optional[CheckpointConfig] = None):
        self.storage_path = storage_path
        self.config = config or CheckpointConfig()
        self.tracked: List[Dict[str, Any]] = []  # {path, metrics, index}
        self._index = 0
        _fs.makedirs(storage_path)

    def register(self, checkpoint: Checkpoint,
                 metrics: Optional[Dict[str, Any]] = None) -> Checkpoint:
        """Copy/upload a worker-local checkpoint into durable storage;
        evict per top-K policy. Returns the durable handle."""
        self._index += 1
        dest = _fs.join(self.storage_path, f"checkpoint_{self._index:06d}")
        if _fs.abspath(checkpoint.path) != dest:
            _fs.put_dir(checkpoint.as_directory(), dest)
        entry = {"path": dest, "metrics": metrics or {}, "index": self._index,
                 "time": time.time()}
        self.tracked.append(entry)
        self._write_manifest()
        self._evict()
        return Checkpoint(dest)

    def _score(self, entry) -> float:
        attr = self.config.checkpoint_score_attribute
        if attr is None:
            return entry["index"]  # recency
        v = entry["metrics"].get(attr)
        if v is None:
            return float("-inf")
        return (float(v) if self.config.checkpoint_score_order == "max"
                else -float(v))

    def _evict(self) -> None:
        k = self.config.num_to_keep
        if k is None or len(self.tracked) <= k:
            return
        self.tracked.sort(key=self._score, reverse=True)
        for entry in self.tracked[k:]:
            _fs.rmtree(entry["path"], ignore_errors=True)
        self.tracked = self.tracked[:k]
        self._write_manifest()

    def best_checkpoint(self) -> Optional[Checkpoint]:
        if not self.tracked:
            return None
        return Checkpoint(max(self.tracked, key=self._score)["path"])

    def latest_checkpoint(self) -> Optional[Checkpoint]:
        if not self.tracked:
            return None
        return Checkpoint(max(self.tracked, key=lambda e: e["index"])["path"])

    def _write_manifest(self) -> None:
        manifest = _fs.join(self.storage_path, "checkpoints.json")
        with _fs.open(manifest, "w") as f:
            json.dump([dict(e) for e in self.tracked], f)

    @classmethod
    def restore(cls, storage_path: str,
                config: Optional[CheckpointConfig] = None
                ) -> "CheckpointManager":
        mgr = cls(storage_path, config)
        manifest = _fs.join(storage_path, "checkpoints.json")
        if _fs.exists(manifest):
            with _fs.open(manifest, "r") as f:
                mgr.tracked = [e for e in json.load(f)
                               if _fs.isdir(e["path"])]
            mgr._index = max((e["index"] for e in mgr.tracked), default=0)
        return mgr
