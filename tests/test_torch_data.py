"""The port's data library (`ray_tpu_torch.data`): plans, streaming
execution, IO, groupby, train ingest.

The mirror of `tests/test_data.py`, case for case, on one module-scoped
port runtime (`num_gpus=0`). Functions and classes shipped to tasks are
defined inside the tests or at the top of this module, which imports
neither JAX nor the JAX package, so a worker that imports it by reference
stays on the port. The comparisons with the JAX package are in
`tests/test_torch_data_pipeline.py`.
"""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rdata


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=8, num_gpus=0, max_workers=8)
    yield info
    ray_tpu_torch.shutdown()


def test_range_count_take(cluster):
    ds = rdata.range(100, parallelism=4)
    assert ds.count() == 100
    assert [r["id"] for r in ds.take(3)] == [0, 1, 2]
    assert ds.num_blocks() == 4


def test_map_batches_filter_fusion(cluster):
    ds = (rdata.range(100, parallelism=4)
          .map_batches(lambda b: {"id": b["id"], "sq": b["id"] ** 2})
          .filter(lambda r: r["sq"] % 2 == 0))
    out = ds.take_all()
    assert len(out) == 50
    assert all(r["sq"] == r["id"] ** 2 for r in out)


def test_map_and_flat_map(cluster):
    ds = rdata.from_items([1, 2, 3]).flat_map(lambda x: [x, 10 * x])
    assert ds.take_all() == [1, 10, 2, 20, 3, 30]
    ds2 = rdata.from_items([1, 2]).map(lambda x: {"v": x + 1})
    assert [r["v"] for r in ds2.take_all()] == [2, 3]


def test_iter_batches_fixed_shapes(cluster):
    ds = rdata.range(103, parallelism=5)
    batches = list(ds.iter_batches(batch_size=25))
    sizes = [len(b["id"]) for b in batches]
    assert sizes == [25, 25, 25, 25, 3]
    batches = list(ds.iter_batches(batch_size=25, drop_last=True))
    assert all(len(b["id"]) == 25 for b in batches)
    # rebatch preserves order across block boundaries
    all_ids = np.concatenate([b["id"] for b in batches])
    assert (all_ids == np.arange(100)).all()


def test_repartition_shuffle_sort(cluster):
    ds = rdata.range(50, parallelism=3).repartition(5)
    assert ds.num_blocks() == 5
    assert ds.count() == 50
    sh = rdata.range(50, parallelism=3).random_shuffle(seed=0)
    ids = [r["id"] for r in sh.take_all()]
    assert sorted(ids) == list(range(50)) and ids != list(range(50))
    st = sh.sort("id")
    assert [r["id"] for r in st.take(5)] == [0, 1, 2, 3, 4]


def test_groupby_aggregate(cluster):
    ds = rdata.from_numpy({"k": np.array([0, 1, 0, 1, 2]),
                           "v": np.array([1.0, 2.0, 3.0, 4.0, 5.0])})
    counts = {r["k"]: r["count"] for r in ds.groupby("k").count().take_all()}
    assert counts == {0: 2, 1: 2, 2: 1}
    means = {r["k"]: r["mean(v)"] for r in ds.groupby("k").mean("v").take_all()}
    assert means[0] == 2.0 and means[1] == 3.0 and means[2] == 5.0


def test_parquet_roundtrip(cluster, tmp_path):
    ds = rdata.range(40, parallelism=2).map_batches(
        lambda b: {"id": b["id"], "x": b["id"] * 0.5})
    ds.write_parquet(str(tmp_path / "out"))
    back = rdata.read_parquet(str(tmp_path / "out"))
    assert back.count() == 40
    assert back.schema() == ["id", "x"]


def test_csv_json_text(cluster, tmp_path):
    import json

    p = tmp_path / "t.csv"
    p.write_text("a,b\n1,x\n2,y\n")
    ds = rdata.read_csv(str(p))
    assert ds.count() == 2
    j = tmp_path / "t.jsonl"
    j.write_text("\n".join(json.dumps({"v": i}) for i in range(3)))
    assert rdata.read_json(str(j)).count() == 3
    t = tmp_path / "t.txt"
    t.write_text("hello\nworld\n")
    assert [r["text"] for r in rdata.read_text(str(t)).take_all()] == [
        "hello", "world"]


def test_split_for_train_ingest(cluster):
    ds = rdata.range(100, parallelism=4)
    shards = ds.split(2)
    assert len(shards) == 2
    total = sum(s.count() for s in shards)
    assert total == 100


def test_union_limit(cluster):
    a = rdata.range(10, parallelism=2)
    b = rdata.range(5, parallelism=1)
    assert a.union(b).count() == 15
    assert a.limit(3).count() == 3


def test_distributed_join(cluster):
    left = rdata.from_items([{"k": i, "a": i * 10} for i in range(8)],
                            parallelism=3)
    right = rdata.from_items([{"k": i, "b": i * 100} for i in range(4, 12)],
                             parallelism=2)
    inner = left.join(right, on="k").take_all()
    assert sorted(r["k"] for r in inner) == [4, 5, 6, 7]
    assert all(r["b"] == r["k"] * 100 and r["a"] == r["k"] * 10 for r in inner)

    lj = left.join(right, on="k", how="left").take_all()
    assert sorted(r["k"] for r in lj) == list(range(8))
    assert [r for r in lj if r["k"] == 0][0]["b"] is None

    oj = left.join(right, on="k", how="outer").take_all()
    assert sorted(r["k"] for r in oj) == list(range(12))


def test_zip(cluster):
    a = rdata.from_numpy({"x": np.arange(10)}, parallelism=3)
    b = rdata.from_numpy({"y": np.arange(10) * 2}, parallelism=2)
    rows = a.zip(b).take_all()
    assert len(rows) == 10
    assert all(r["y"] == r["x"] * 2 for r in rows)

    import pytest as _pytest

    with _pytest.raises(ValueError):
        a.zip(rdata.from_numpy({"y": np.arange(5)})).take_all()


def test_actor_pool_map_batches(cluster):
    class AddState:
        def __init__(self):
            self.offset = 1000  # per-actor init runs once

        def __call__(self, batch):
            return {"id": batch["id"] + self.offset}

    ds = rdata.range(40, parallelism=4).map_batches(AddState, concurrency=2)
    vals = sorted(r["id"] for r in ds.take_all())
    assert vals == list(range(1000, 1040))


def test_sort_distributed_global_order(cluster):
    rng = np.random.default_rng(3)
    ds = rdata.from_numpy({"v": rng.permutation(200)}, parallelism=5)
    got = [r["v"] for r in ds.sort("v").take_all()]
    assert got == list(range(200))
    desc = [r["v"] for r in ds.sort("v", descending=True).take_all()]
    assert desc == list(range(199, -1, -1))


def test_random_shuffle_distributed(cluster):
    ds = rdata.range(100, parallelism=4)
    rows = [r["id"] for r in ds.random_shuffle(seed=1).take_all()]
    assert sorted(rows) == list(range(100))
    assert rows != list(range(100))


def test_groupby_std_and_aggregate(cluster):
    ds = rdata.from_items(
        [{"g": i % 3, "v": float(i)} for i in range(30)], parallelism=4)
    out = {r["g"]: r for r in ds.groupby("g").aggregate(
        ("v", "sum"), ("v", "max")).take_all()}
    assert out[0]["sum(v)"] == sum(range(0, 30, 3))
    assert out[2]["max(v)"] == 29.0
    counts = {r["g"]: r["count"] for r in ds.groupby("g").count().take_all()}
    assert counts == {0: 10, 1: 10, 2: 10}


def test_map_groups_distributed(cluster):
    ds = rdata.from_items(
        [{"g": i % 2, "v": float(i)} for i in range(10)], parallelism=3)

    def top1(batch):
        i = int(np.argmax(batch["v"]))
        return {"g": batch["g"][i:i+1], "v": batch["v"][i:i+1]}

    rows = sorted(ds.groupby("g").map_groups(top1).take_all(),
                  key=lambda r: r["g"])
    assert [r["v"] for r in rows] == [8.0, 9.0]


def test_stats(cluster):
    ds = rdata.range(50, parallelism=2)
    ds.count()
    assert "rows" in ds.stats()


def test_random_shuffle_actually_shuffles_within_partitions(cluster):
    """Regression: rows must not stay relatively ordered inside output
    partitions, and different blocks must get different assignments."""
    ds = rdata.range(400, parallelism=4).random_shuffle(seed=5)
    blocks = list(ds._stream_blocks())
    for b in blocks:
        ids = list(b["id"])
        assert ids != sorted(ids), "partition is still sorted"
    # determinism with a fixed seed
    again = [r["id"] for r in
             rdata.range(400, parallelism=4).random_shuffle(seed=5).take_all()]
    assert again == [r["id"] for r in ds.take_all()]


def test_repartition_preserves_order(cluster):
    ds = rdata.range(50, parallelism=1).repartition(5)
    assert ds.num_blocks() == 5
    assert [r["id"] for r in ds.take_all()] == list(range(50))
    sizes = [len(b["id"]) for b in ds._stream_blocks()]
    assert sizes == [10] * 5


def test_actor_pool_no_leak_on_early_stop(cluster):
    from ray_tpu_torch.util import state

    class Ident:
        def __call__(self, batch):
            return batch

    before = len(state.list_actors(filters=[("state", "=", "ALIVE")]))
    ds = rdata.range(40, parallelism=4).map_batches(Ident, concurrency=2)
    assert ds.limit(3).count() == 3
    import time as _t

    deadline = _t.time() + 10
    while _t.time() < deadline:
        after = len(state.list_actors(filters=[("state", "=", "ALIVE")]))
        if after <= before:
            break
        _t.sleep(0.2)
    assert after <= before, "pool actors leaked after limit()"


def test_zip_non_tabular_raises(cluster):
    import pytest as _pytest

    with _pytest.raises(Exception, match="tabular"):
        rdata.from_items([1, 2, 3]).zip(rdata.from_items([4, 5, 6])).take_all()


def test_read_images(cluster, tmp_path):
    from PIL import Image

    for i in range(3):
        Image.new("RGB", (8 + i, 6), color=(i * 10, 0, 0)).save(
            tmp_path / f"img{i}.png")
    ds = rdata.read_images(str(tmp_path), size=(16, 16))
    rows = ds.take_all()
    assert len(rows) == 3
    assert all(r["image"].shape == (16, 16, 3) for r in rows)
    reds = sorted(int(r["image"][0, 0, 0]) for r in rows)
    assert reds == [0, 10, 20]


def test_arrow_blocks_zero_copy_parquet(cluster, tmp_path):
    """read_parquet keeps pyarrow.Table as the block format end-to-end:
    slices are zero-copy views, pyarrow map_batches sees the table,
    iter_batches still yields numpy for the step."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.data.block import is_arrow_block

    t = pa.table({"a": np.arange(100, dtype=np.int64),
                  "b": np.arange(100, dtype=np.float64) * 0.5})
    path = tmp_path / "t.parquet"
    pq.write_table(t, str(path))

    ds = rdata.read_parquet(str(path))
    # the raw block is an arrow table, not an eager numpy copy
    raw = ds._partitions[0]()
    assert is_arrow_block(raw)

    # pyarrow batch_format passes the table through untouched (probe runs
    # in a worker: it raises there if the batch isn't an arrow Table)
    def probe(batch):
        import pyarrow as _pa

        if not isinstance(batch, _pa.Table):
            raise TypeError(f"expected pa.Table, got {type(batch)}")
        return batch.append_column(
            "c", _pa.array(np.ones(batch.num_rows)))

    out = ds.map_batches(probe, batch_format="pyarrow").take_all()
    assert len(out) == 100
    assert out[0]["c"] == 1.0  # arrow result survived as the block

    # numpy consumption for XLA: batches are column dicts of ndarrays
    batches = list(ds.iter_batches(batch_size=32))
    assert all(isinstance(b["a"], np.ndarray) for b in batches)
    assert sum(len(b["a"]) for b in batches) == 100

    # arrow blocks survive sort/groupby barriers (normalized internally)
    s = ds.sort("a", descending=True).take(3)
    assert [r["a"] for r in s] == [99, 98, 97]


def test_adaptive_streaming_window(cluster, monkeypatch):
    """Backpressure adapts the in-flight window to a byte budget instead
    of the old fixed 8: tiny blocks widen it, big blocks shrink it."""
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.data import dataset as ds_mod

    tiny = rdata.from_items(list(range(64))).repartition(32)
    list(tiny._stream_blocks())
    assert tiny._last_window > ds_mod.DEFAULT_WINDOW  # tiny blocks: widen

    monkeypatch.setenv("RAY_TPU_DATA_MEMORY_BUDGET_BYTES", str(1 << 20))
    big = rdata.range(16).map_batches(
        lambda b: {"x": np.zeros((len(b["id"]), 1 << 17), np.float64)})
    list(big._stream_blocks())
    assert big._last_window == ds_mod.MIN_WINDOW  # budget-bound: shrink


def _encode_tf_example(features: dict) -> bytes:
    """Independent tf.train.Example ENCODER (test-side, so the reader is
    not checked against itself): standard protobuf wire format."""
    def varint(n):
        out = b""
        while True:
            b7 = n & 0x7F
            n >>= 7
            out += bytes([b7 | (0x80 if n else 0)])
            if not n:
                return out

    def ld(field, payload):  # length-delimited
        return varint((field << 3) | 2) + varint(len(payload)) + payload

    feats = b""
    for name, value in features.items():
        if isinstance(value, bytes):
            flist = ld(1, ld(1, value))                      # BytesList
        elif isinstance(value, list) and value and isinstance(value[0], float):
            import struct

            packed = b"".join(struct.pack("<f", v) for v in value)
            flist = ld(2, ld(1, packed))                     # FloatList
        else:
            packed = b"".join(varint(v & ((1 << 64) - 1)) for v in value)
            flist = ld(3, ld(1, packed))                     # Int64List
        entry = ld(1, name.encode()) + ld(2, flist)
        feats += ld(1, entry)
    return ld(1, feats)  # Example{1: Features}


def test_read_tfrecords(cluster, tmp_path):
    import struct

    path = tmp_path / "data.tfrecord"
    with open(path, "wb") as f:
        for i in range(3):
            ex = _encode_tf_example({
                "label": [i - 1],  # includes -1: negative int64 wire case
                "weights": [0.5 * i, 1.5],
                "name": f"row{i}".encode(),
            })
            f.write(struct.pack("<Q", len(ex)) + b"\x00" * 4
                    + ex + b"\x00" * 4)
    rows = rdata.read_tfrecords(str(path)).take_all()
    assert len(rows) == 3
    assert list(rows[1]["label"]) == [0]
    assert list(rows[0]["label"]) == [-1]  # two's-complement decode
    np.testing.assert_allclose(rows[2]["weights"], [1.0, 1.5])
    assert rows[0]["name"] == [b"row0"]


def test_read_sql(cluster, tmp_path):
    import sqlite3

    db = str(tmp_path / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE users (id INTEGER, score REAL)")
    conn.executemany("INSERT INTO users VALUES (?, ?)",
                     [(i, i * 0.5) for i in range(10)])
    conn.commit()
    conn.close()
    ds = rdata.read_sql("SELECT id, score FROM users WHERE id >= 4",
                        lambda: sqlite3.connect(db))
    rows = ds.take_all()
    assert len(rows) == 6
    assert sorted(r["id"] for r in rows) == list(range(4, 10))


def test_from_arrow_and_torch(cluster):
    import pyarrow as pa
    import torch
    from torch.utils.data import TensorDataset

    t = pa.table({"a": [1, 2, 3]})
    assert rdata.from_arrow(t).count() == 3
    td = TensorDataset(torch.arange(6))
    rows = rdata.from_torch(td, parallelism=2).take_all()
    assert len(rows) == 6
    assert int(rows[5]["item"][0]) == 5


def test_write_csv_json_roundtrip(cluster, tmp_path):
    ds = rdata.range(10, parallelism=2).map_batches(
        lambda b: {"id": b["id"], "x": b["id"] * 2.0})
    ds.write_csv(str(tmp_path / "csv"))
    back = rdata.read_csv(str(tmp_path / "csv"))
    assert back.count() == 10
    ds.write_json(str(tmp_path / "json"))
    back = rdata.read_json(str(tmp_path / "json"))
    rows = back.take_all()
    assert len(rows) == 10 and rows[0]["x"] == rows[0]["id"] * 2.0


# ---------------------------------------------------- operator-graph executor
def test_executor_stages_overlap_in_time(cluster):
    """The operator-graph property (reference streaming_executor.py:61):
    a downstream stage starts while the upstream stage still has blocks
    in flight — NOT a fused chain drained stage-by-stage."""
    import time as _time

    import ray_tpu_torch.data as rd

    class SlowUDF:
        def __call__(self, batch):
            _time.sleep(0.05)
            return {"id": batch["id"] * 2}

    ds = rd.range(400, parallelism=8).map_batches(
        lambda b: (_time.sleep(0.05), {"id": b["id"]})[1]
    ).map_batches(SlowUDF, concurrency=2)
    rows = ds.take_all()
    assert sorted(r["id"] for r in rows) == sorted(2 * i for i in range(400))

    ex = ds._last_executor
    stats = ex.per_op_stats()
    assert len(stats) == 2, [s.name for s in stats]
    s_map, s_actor = stats
    assert s_map.completed == 8 and s_actor.completed == 8
    # overlap: the actor stage began BEFORE the map stage finished its
    # last block
    assert s_actor.first_submit_ts < s_map.last_complete_ts, (
        f"stages serialized: actor started {s_actor.first_submit_ts}, "
        f"map finished {s_map.last_complete_ts}")
    # and at least one pair of per-block intervals genuinely overlaps
    assert any(a0 < m1 and m0 < a1
               for (m0, m1) in s_map.intervals
               for (a0, a1) in s_actor.intervals), "no interval overlap"


def test_executor_per_op_stats_and_explain(cluster):
    import ray_tpu_torch.data as rd

    class Id:
        def __call__(self, batch):
            return batch

    ds = rd.range(100, parallelism=4).map(lambda r: r).map_batches(
        Id, concurrency=1).filter(lambda r: True)
    plan = ds.explain()
    assert "logical: Read -> map -> map_batches -> filter" in plan
    assert "TaskStage[map]" in plan and "ActorStage" in plan \
        and "TaskStage[filter]" in plan
    ds.take_all()
    st = ds.stats()
    assert "Map(" in st and "ActorMap" in st, st


def test_executor_respects_per_stage_caps(cluster):
    """ActorStage in-flight never exceeds its pool size (per-op
    concurrency cap, reference ConcurrencyCapBackpressurePolicy)."""
    import ray_tpu_torch.data as rd

    class Track:
        def __call__(self, batch):
            return batch

    ds = rd.range(200, parallelism=10).map_batches(Track, concurrency=2)
    ds.take_all()
    s = ds._last_executor.per_op_stats()[-1]
    assert s.completed == 10
    # cap == pool size: with cap 2, at most 2 intervals overlap any instant
    events = []
    for (a, b) in s.intervals:
        events.append((a, 1))
        events.append((b, -1))
    events.sort()
    cur = peak = 0
    for _, d in events:
        cur += d
        peak = max(peak, cur)
    assert peak <= 2, f"in-flight peaked at {peak} with cap 2"


# --------------------------------------------------------- new datasources
def test_webdataset_roundtrip(cluster, tmp_path):
    """Tar-sharded samples group by basename into rows (reference
    read_webdataset), decoded per extension — stdlib tarfile only."""
    import io
    import json as _json
    import tarfile

    import ray_tpu_torch.data as rd

    shard = tmp_path / "shard-000000.tar"
    with tarfile.open(shard, "w") as tar:
        for i in range(5):
            for ext, payload in (
                    ("cls", str(i % 2).encode()),
                    ("json", _json.dumps({"idx": i}).encode()),
                    ("txt", f"sample {i}".encode())):
                data = payload
                info = tarfile.TarInfo(f"sample{i:04d}.{ext}")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
    ds = rd.read_webdataset(str(shard))
    rows = sorted(ds.take_all(), key=lambda r: r["__key__"])
    assert len(rows) == 5
    assert rows[0]["cls"] == 0 and rows[1]["cls"] == 1
    assert rows[2]["json"]["idx"] == 2
    assert rows[3]["txt"] == "sample 3"


def test_write_read_tfrecords_roundtrip(cluster, tmp_path):
    """write_tfrecords -> read_tfrecords roundtrip through the built-in
    protobuf wire writer/parser (no tensorflow)."""
    import ray_tpu_torch.data as rd

    src = rd.from_items([
        {"id": i, "score": float(i) / 2, "name": f"row{i}".encode()}
        for i in range(10)])
    out = tmp_path / "tfr"
    src.write_tfrecords(str(out))
    back = rd.read_tfrecords(str(out))
    rows = sorted(back.take_all(), key=lambda r: int(r["id"][0]))
    assert len(rows) == 10
    assert int(rows[3]["id"][0]) == 3
    assert abs(float(rows[4]["score"][0]) - 2.0) < 1e-6
    assert rows[5]["name"][0] == b"row5"


def test_tfrecords_crc_is_valid(cluster, tmp_path):
    """The framing CRCs are real masked CRC-32C (TF readers validate
    them), not zero padding."""
    import struct

    import ray_tpu_torch.data as rd
    from ray_tpu_torch.data.dataset import _masked_crc

    rd.from_items([{"a": 1}]).write_tfrecords(str(tmp_path / "t"))
    files = list((tmp_path / "t").glob("*.tfrecords"))
    assert files
    raw = files[0].read_bytes()
    (length,) = struct.unpack("<Q", raw[:8])
    (hdr_crc,) = struct.unpack("<I", raw[8:12])
    assert hdr_crc == _masked_crc(raw[:8])
    data = raw[12:12 + length]
    (data_crc,) = struct.unpack("<I", raw[12 + length:16 + length])
    assert data_crc == _masked_crc(data)


def test_iter_torch_batches(cluster):
    import torch

    import ray_tpu_torch.data as rd

    ds = rd.range(100, parallelism=4).map_batches(
        lambda b: {"id": b["id"], "f": b["id"].astype("float64") / 2})
    seen = 0
    for batch in ds.iter_torch_batches(batch_size=32):
        assert isinstance(batch["id"], torch.Tensor)
        assert batch["f"].dtype == torch.float64
        seen += len(batch["id"])
    assert seen == 100
    # dtype cast + drop_last
    batches = list(ds.iter_torch_batches(batch_size=32, drop_last=True,
                                         dtypes=torch.float32))
    assert all(b["id"].dtype == torch.float32 for b in batches)
    assert sum(len(b["id"]) for b in batches) == 96


def test_preprocessors_family(cluster):
    """StandardScaler / MinMaxScaler / LabelEncoder / OneHotEncoder /
    Concatenator / Chain (reference ray.data.preprocessors): streamed
    fit on the cluster, lazy transform, batch-level serving path."""
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.data.preprocessors import (Chain, Concatenator,
                                            LabelEncoder, MinMaxScaler,
                                            OneHotEncoder, StandardScaler)

    rng = np.random.default_rng(0)
    n = 500
    ds = rd.from_numpy({
        "x": rng.normal(10.0, 4.0, n),
        "y": rng.uniform(-3, 7, n),
        "label": rng.choice(["cat", "dog", "bird"], n),
    }, parallelism=4)

    sc = StandardScaler(columns=["x"]).fit(ds)
    out = np.concatenate([b["x"] for b in
                          sc.transform(ds).iter_batches(batch_size=128)])
    assert abs(out.mean()) < 0.05 and abs(out.std() - 1) < 0.05

    mm = MinMaxScaler(columns=["y"]).fit(ds)
    out = np.concatenate([b["y"] for b in
                          mm.transform(ds).iter_batches(batch_size=128)])
    assert out.min() >= 0.0 and out.max() <= 1.0

    le = LabelEncoder(label_column="label").fit(ds)
    assert list(le.classes_) == ["bird", "cat", "dog"]
    rows = le.transform(ds).take(5)
    assert all(isinstance(int(r["label"]), int) for r in rows)

    oh = OneHotEncoder(columns=["label"]).fit(ds)
    b = next(oh.transform(ds).iter_batches(batch_size=64))
    assert {"label_bird", "label_cat", "label_dog"} <= set(b)
    assert (b["label_bird"] + b["label_cat"] + b["label_dog"] == 1).all()

    chain = Chain(StandardScaler(columns=["x", "y"]),
                  Concatenator(columns=["x", "y"],
                               output_column_name="features"))
    chain.fit(ds)
    b = next(chain.transform(ds).iter_batches(batch_size=64))
    assert b["features"].shape == (64, 2)
    # serving path: single-batch transform matches dataset transform
    raw = next(ds.iter_batches(batch_size=64))
    np.testing.assert_allclose(chain.transform_batch(raw)["features"],
                               b["features"], rtol=1e-5)
