"""Dataset creation: range/from_items/from_numpy + file IO connectors
(counterpart of `ray_tpu/data/read_api.py`; pyarrow, pandas and PIL are
imported only by the readers that need them).

Parity (core subset) with `python/ray/data/read_api.py`: parquet/csv/json/
text/binary/numpy readers produce one read thunk per file (or per range
shard), executed lazily by the streaming executor. Paths resolve through
`ray_tpu_torch.utils.fs`, so every reader/writer accepts fsspec URIs
(`gs://`, `s3://`, `memory://`) as well as local paths/globs.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.utils import fs as _fs

_expand_paths = _fs.expand_paths


def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    parallelism = max(1, min(parallelism, n or 1))
    bounds = np.linspace(0, n, parallelism + 1, dtype=np.int64)

    def make(lo: int, hi: int):
        return lambda: {"id": np.arange(lo, hi, dtype=np.int64)}

    return Dataset([make(int(lo), int(hi))
                    for lo, hi in zip(bounds[:-1], bounds[1:])])


def from_items(items: List[Any], *, parallelism: int = 8) -> Dataset:
    parallelism = max(1, min(parallelism, len(items) or 1))
    shards = np.array_split(np.arange(len(items)), parallelism)

    def make(idx):
        chunk = [items[i] for i in idx]
        return lambda: chunk

    return Dataset([make(idx) for idx in shards if len(idx)])


def from_numpy(arrays: Dict[str, np.ndarray], *,
               parallelism: int = 8) -> Dataset:
    n = len(next(iter(arrays.values())))
    bounds = np.linspace(0, n, max(1, parallelism) + 1, dtype=np.int64)

    def make(lo, hi):
        chunk = {k: v[lo:hi] for k, v in arrays.items()}
        return lambda: chunk

    return Dataset([make(int(lo), int(hi))
                    for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo])


def from_pandas(df) -> Dataset:
    return from_numpy({c: df[c].to_numpy() for c in df.columns})


def read_parquet(paths, *, columns: Optional[List[str]] = None) -> Dataset:
    files = _expand_paths(paths)

    def read_one(path):
        import pyarrow.parquet as pq

        # arrow IS a block format: no eager numpy conversion — slices
        # stay zero-copy views, consumers convert per-batch. Local paths
        # go straight to pyarrow (memory-mapped); URIs via fsspec.
        if _fs.is_uri(path):
            with _fs.open(path, "rb") as f:
                return pq.read_table(f, columns=columns)
        return pq.read_table(path, columns=columns)

    return Dataset([functools.partial(read_one, f) for f in files])


def read_csv(paths, **csv_kwargs) -> Dataset:
    files = _expand_paths(paths)

    def read_one(path):
        import pandas as pd

        with _fs.open(path, "r") as f:
            df = pd.read_csv(f, **csv_kwargs)
        return {c: df[c].to_numpy() for c in df.columns}

    return Dataset([functools.partial(read_one, f) for f in files])


def read_json(paths, *, lines: bool = True) -> Dataset:
    files = _expand_paths(paths)

    def read_one(path):
        import json

        rows = []
        with _fs.open(path, "r") as f:
            if lines:
                for line in f:
                    line = line.strip()
                    if line:
                        rows.append(json.loads(line))
            else:
                data = json.load(f)
                rows = data if isinstance(data, list) else [data]
        return rows

    return Dataset([functools.partial(read_one, f) for f in files])


def read_text(paths) -> Dataset:
    files = _expand_paths(paths)

    def read_one(path):
        with _fs.open(path, "r") as f:
            return {"text": np.asarray([ln.rstrip("\n") for ln in f],
                                       dtype=object)}

    return Dataset([functools.partial(read_one, f) for f in files])


def read_binary_files(paths) -> Dataset:
    files = _expand_paths(paths)

    def read_one(path):
        with _fs.open(path, "rb") as f:
            return [{"path": path, "bytes": f.read()}]

    return Dataset([functools.partial(read_one, f) for f in files])


def read_numpy(paths) -> Dataset:
    files = _expand_paths(paths)

    def read_one(path):
        with _fs.open(path, "rb") as f:
            arr = np.load(f)
        return {"data": arr}

    return Dataset([functools.partial(read_one, f) for f in files])


IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".gif", ".bmp", ".webp",
                    ".tif", ".tiff")


def read_images(paths, *, size=None, mode: str = "RGB") -> Dataset:
    """Image files → {"image": HWC uint8 array, "path": str} rows
    (reference `ray.data.read_images`). `size=(h, w)` resizes. Directory
    reads skip non-image files (READMEs, labels.csv, ...)."""
    files = [f for f in _expand_paths(paths)
             if f.lower().endswith(IMAGE_EXTENSIONS)]
    if not files:
        raise FileNotFoundError(f"no image files matched {paths}")

    def read_one(path):
        from PIL import Image

        with _fs.open(path, "rb") as f:
            img = Image.open(f).convert(mode)
        if size is not None:
            img = img.resize((size[1], size[0]))
        return [{"image": np.asarray(img), "path": path}]

    return Dataset([functools.partial(read_one, f) for f in files])


def from_arrow(tables) -> Dataset:
    """pyarrow Table(s) → Dataset, one block per table, zero-copy
    (reference `ray.data.from_arrow`)."""
    if not isinstance(tables, (list, tuple)):
        tables = [tables]
    return Dataset([t for t in tables])


def from_torch(torch_dataset, *, parallelism: int = 8) -> Dataset:
    """A map-style torch Dataset → row Dataset (reference
    `ray.data.from_torch`): items materialize lazily per partition."""
    n = len(torch_dataset)
    parallelism = max(1, min(parallelism, n or 1))
    bounds = np.linspace(0, n, parallelism + 1, dtype=np.int64)

    def read_slice(lo, hi):
        import builtins

        # NB: this module defines ray-style `range(n)`, shadowing the builtin
        return [{"item": torch_dataset[i]} for i in builtins.range(lo, hi)]

    return Dataset([functools.partial(read_slice, int(lo), int(hi))
                    for lo, hi in zip(bounds[:-1], bounds[1:])])


def from_huggingface(hf_dataset, *, parallelism: int = 8) -> Dataset:
    """A `datasets.Dataset` → Dataset via its arrow table (reference
    `ray.data.from_huggingface`). The datasets library is optional."""
    if getattr(hf_dataset, "_indices", None) is not None:
        # select()/shuffle()/filter() leave an indices mapping over the
        # ORIGINAL table — materialize rows, or we'd return unselected data
        rows = [dict(r) for r in hf_dataset]
        return from_items(rows, parallelism=parallelism)
    try:
        table = hf_dataset.data.table      # arrow-backed: zero-copy
    except AttributeError:
        rows = [dict(r) for r in hf_dataset]
        return from_items(rows, parallelism=parallelism)
    import builtins

    n = max(1, table.num_rows // max(parallelism, 1))
    return Dataset([table.slice(i, n)
                    for i in builtins.range(0, table.num_rows, n)])


def read_sql(sql: str, connection_factory) -> Dataset:
    """A SQL query → one read task over any DBAPI connection factory
    (reference `ray.data.read_sql`). The factory runs INSIDE the read
    task so connections are per-worker, never pickled."""

    def read_all():
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(sql)
            cols = [d[0] for d in cur.description]
            rows = cur.fetchall()
        finally:
            conn.close()
        if not rows:
            return []
        return {c: np.asarray([r[i] for r in rows])
                for i, c in enumerate(cols)}

    return Dataset([read_all])


# ------------------------------------------------------------- tfrecords
def _read_varint(buf: memoryview, pos: int):
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _signed_int64(v: int) -> int:
    """protobuf int64: negatives ride as 10-byte two's-complement varints."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_tf_example(data: bytes) -> dict:
    """Minimal pure-python tf.train.Example parser (wire format only —
    no tensorflow/protobuf dependency; reference read_tfrecords has the
    same no-TF fallback). Returns {feature: list|ndarray}."""
    import struct

    view = memoryview(data)

    def parse_fields(buf, pos, end):
        while pos < end:
            tag, pos = _read_varint(buf, pos)
            field, wire = tag >> 3, tag & 7
            if wire == 2:
                ln, pos = _read_varint(buf, pos)
                yield field, buf[pos:pos + ln], pos
                pos += ln
            elif wire == 0:
                v, pos = _read_varint(buf, pos)
                yield field, v, pos
            elif wire == 5:
                yield field, buf[pos:pos + 4], pos
                pos += 4
            elif wire == 1:
                yield field, buf[pos:pos + 8], pos
                pos += 8
            else:
                raise ValueError(f"unsupported wire type {wire}")

    out: dict = {}
    # Example{1: Features{1: map<string, Feature>}}
    for f, features_buf, _ in parse_fields(view, 0, len(view)):
        if f != 1:
            continue
        for f2, entry, _ in parse_fields(features_buf, 0, len(features_buf)):
            if f2 != 1:
                continue
            name, value = None, None
            for f3, v, _ in parse_fields(entry, 0, len(entry)):
                if f3 == 1:
                    name = bytes(v).decode()
                elif f3 == 2:
                    # Feature{1: BytesList, 2: FloatList, 3: Int64List}
                    for f4, lst, _ in parse_fields(v, 0, len(v)):
                        if f4 == 1:      # bytes_list{1: repeated bytes}
                            value = [bytes(b) for f5, b, _ in
                                     parse_fields(lst, 0, len(lst))
                                     if f5 == 1]
                        elif f4 == 2:    # float_list{1: packed floats}
                            packed = b"".join(
                                bytes(b) for f5, b, _ in
                                parse_fields(lst, 0, len(lst)) if f5 == 1)
                            value = np.frombuffer(packed, dtype="<f4")
                        elif f4 == 3:    # int64_list{1: varints (packed)}
                            vals = []
                            for f5, b, _ in parse_fields(lst, 0, len(lst)):
                                if f5 != 1:
                                    continue
                                if isinstance(b, int):
                                    vals.append(_signed_int64(b))
                                else:
                                    p = 0
                                    while p < len(b):
                                        x, p = _read_varint(b, p)
                                        vals.append(_signed_int64(x))
                            value = np.asarray(vals, dtype=np.int64)
            if name is not None:
                out[name] = value
    return out


def read_tfrecords(paths) -> Dataset:
    """TFRecord files of tf.train.Example → feature-dict rows
    (reference `ray.data.read_tfrecords`), parsed with a built-in wire
    parser — no tensorflow required."""
    import struct

    files = _expand_paths(paths)

    def read_one(path):
        rows = []
        with _fs.open(path, "rb") as f:
            while True:
                header = f.read(12)
                if len(header) < 12:
                    break
                (length,) = struct.unpack("<Q", header[:8])
                data = f.read(length)
                f.read(4)  # data crc
                rows.append(_parse_tf_example(data))
        return rows

    return Dataset([functools.partial(read_one, f) for f in files])


def read_webdataset(paths) -> Dataset:
    """WebDataset tar shards → one row per sample (reference
    `ray.data.read_webdataset`): files sharing a basename group into a
    dict keyed by extension, e.g. {"__key__", "jpg", "cls", "json"}.
    Pure tarfile — no webdataset dependency; image/json/cls payloads
    decode to arrays/objects, the rest stay bytes."""
    import io as _io
    import json as _json
    import tarfile

    files = _expand_paths(paths)

    def _decode(ext: str, data: bytes):
        if ext in ("json",):
            return _json.loads(data)
        if ext in ("cls", "id", "index"):
            try:
                return int(data.decode().strip())
            except ValueError:
                return data.decode().strip()
        if ext in ("txt", "text"):
            return data.decode()
        if ext in ("jpg", "jpeg", "png", "bmp", "webp"):
            try:
                from PIL import Image

                return np.asarray(Image.open(_io.BytesIO(data)))
            except Exception:
                return data
        if ext == "npy":
            return np.load(_io.BytesIO(data))
        return data

    def read_one(path):
        rows = []
        current_key, sample = None, {}
        with _fs.open(path, "rb") as f:
            with tarfile.open(fileobj=f, mode="r|*") as tar:
                for member in tar:
                    if not member.isfile():
                        continue
                    base, _, ext = member.name.partition(".")
                    if base != current_key:
                        if sample:
                            rows.append(sample)
                        current_key = base
                        sample = {"__key__": base}
                    payload = tar.extractfile(member).read()
                    sample[ext] = _decode(ext.lower(), payload)
        if sample:
            rows.append(sample)
        return rows

    return Dataset([functools.partial(read_one, f) for f in files])


def _tf_feature_bytes(value) -> bytes:
    """Encode one feature as a tf.train.Feature message (wire format)."""
    import struct

    def varint(n: int) -> bytes:
        out = b""
        while True:
            b = n & 0x7F
            n >>= 7
            out += bytes([b | (0x80 if n else 0)])
            if not n:
                return out

    def field(num: int, wire: int, payload: bytes) -> bytes:
        return varint((num << 3) | wire) + payload

    def length_delim(num: int, payload: bytes) -> bytes:
        return field(num, 2, varint(len(payload)) + payload)

    if isinstance(value, bytes):
        inner = length_delim(1, value)          # bytes_list.value
        return length_delim(1, inner)           # Feature.bytes_list
    if isinstance(value, str):
        return _tf_feature_bytes(value.encode())
    arr = np.asarray(value)
    if arr.dtype.kind == "f":
        packed = arr.astype("<f4").tobytes()
        inner = length_delim(1, packed)         # float_list.value packed
        return length_delim(2, inner)           # Feature.float_list
    vals = b"".join(varint(int(v) & ((1 << 64) - 1))
                    for v in arr.reshape(-1))
    inner = length_delim(1, vals)               # int64_list.value packed
    return length_delim(3, inner)               # Feature.int64_list


def _row_to_tf_example(row: dict) -> bytes:
    def varint(n: int) -> bytes:
        out = b""
        while True:
            b = n & 0x7F
            n >>= 7
            out += bytes([b | (0x80 if n else 0)])
            if not n:
                return out

    entries = b""
    for name, value in row.items():
        key = name.encode()
        kv = (bytes([0x0A, len(key)]) + key           # map key (field 1)
              + bytes([0x12]) + varint(len(_tf_feature_bytes(value)))
              + _tf_feature_bytes(value))             # map value (field 2)
        entries += bytes([0x0A]) + varint(len(kv)) + kv
    features = bytes([0x0A]) + varint(len(entries)) + entries
    return features
