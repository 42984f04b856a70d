"""Compiled DAGs and their shm ring channels in the port.

The port's mirror of `tests/test_dag.py` (19 cases) against
`ray_tpu_torch.dag`: the 12 channel cases (values holding torch tensors,
bf16 among them, where the reference's hold numpy: the meta and the
out-of-band tensor bytes come back bit for bit from one slot, and from the
`read_raw` bytes a remote reader deserializes), the eager function DAG,
the linear, fan-out/fan-in and multi-output compiled DAGs, `max_inflight`
and the device channel. Two reference cases bound wall time, which a
loaded host breaks; their mirrors assert the mechanism instead:
- compiled iterations make no actor call and no task submission at the
  driver's client (the reference times them against actor calls);
- with `max_inflight=4`, three submits all return before the slow stage
  ends its first call, which waits on a gate the driver opens only after
  the third submit (the reference bounds the submits by 0.25 s).
Beside the mirror: a method that keeps and modifies a tensor it got from a
local edge owns a copy (the ring slot its value was parsed from is
reused), while the slot view itself aliases the shm bytes; a stage that
raises fails the driver's `get` with its own error; and the DAG's rings
are all gone from /dev/shm after `teardown`.
"""

import glob
import os
import pickle
import signal
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.core.native_store import native_available
from ray_tpu_torch.dag import (Channel, ChannelClosedError, InputNode,
                               MultiOutputNode)
from ray_tpu_torch.dag.channel import ChannelError

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="native toolchain unavailable")


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=8, num_gpus=0, max_workers=10)
    yield
    ray_tpu_torch.shutdown()


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()


def _rings(cdag) -> list:
    """The DAG's ring segments still in /dev/shm."""
    return [n for n in cdag.chan_names.values()
            if os.path.exists(f"/dev/shm/{n}")]


# ----------------------------------------------------------------- channels
def test_channel_roundtrip():
    ch = Channel(capacity=1 << 20)
    try:
        t = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
        ch.write({"x": 1, "arr": list(range(100)), "t": t,
                  "bf": t.to(torch.bfloat16)})
        reader = Channel.attach(ch.name)
        got = reader.read(timeout=5)
        assert got["x"] == 1 and got["arr"] == list(range(100))
        assert _bits(got["t"]) == _bits(t)
        assert got["bf"].dtype == torch.bfloat16
        assert _bits(got["bf"]) == _bits(t.to(torch.bfloat16))
    finally:
        ch.close(unlink=True)
    assert ch.name.startswith("rtpt_chan_")
    assert not os.path.exists(f"/dev/shm/{ch.name}")


def test_channel_blocking_handoff():
    ch = Channel(capacity=1 << 16, num_readers=1)
    got = []

    def consume():
        r = Channel.attach(ch.name)
        for _ in range(5):
            got.append(r.read(timeout=5))

    t = threading.Thread(target=consume)
    t.start()
    for i in range(5):
        ch.write(torch.full((4,), i), timeout=5)
    t.join(timeout=10)
    assert [int(g[0]) for g in got] == [0, 1, 2, 3, 4]
    ch.close(unlink=True)


def test_channel_stall_attribution_distinguishes_slow_sides():
    """The shm header's stall counters attribute the bottleneck to the
    correct SIDE: a slow reader leaves the writer blocked on a full ring,
    a slow writer leaves the reader blocked on an empty one; both read
    lock-free via Channel.snapshot()."""
    ch = Channel(capacity=1 << 16, num_readers=1, num_slots=2)
    try:
        r = Channel.attach(ch.name)

        def slow_reader():
            for _ in range(6):
                time.sleep(0.05)
                r.read(timeout=10)

        t = threading.Thread(target=slow_reader)
        t.start()
        for i in range(6):
            ch.write(i, timeout=10)
        t.join(timeout=30)
        s = ch.snapshot()
        assert s["writes"] == 6 and s["reads"] == 6
        assert s["num_slots"] == 2 and s["occupancy"] == 0
        assert s["writer_stall_s"] > 0.05, s
        assert s["reader_stall_s"] == 0.0, s
    finally:
        ch.close(unlink=True)

    ch2 = Channel(capacity=1 << 16, num_readers=1, num_slots=2)
    try:
        r2 = Channel.attach(ch2.name)
        got = []

        def fast_reader():
            for _ in range(6):
                got.append(r2.read(timeout=10))

        t2 = threading.Thread(target=fast_reader)
        t2.start()
        for i in range(6):
            time.sleep(0.05)
            ch2.write(i, timeout=10)
        t2.join(timeout=30)
        assert got == list(range(6))
        s2 = ch2.snapshot()
        assert s2["reader_stall_s"] > 0.05, s2
        assert s2["writer_stall_s"] == 0.0, s2
    finally:
        ch2.close(unlink=True)


def test_channel_close_unblocks_reader():
    ch = Channel(capacity=1 << 16)
    errs = []

    def consume():
        r = Channel.attach(ch.name)
        try:
            r.read(timeout=10)
        except ChannelClosedError as e:
            errs.append(e)

    t = threading.Thread(target=consume)
    t.start()
    time.sleep(0.2)
    ch.close(unlink=True)
    t.join(timeout=5)
    assert errs


# ------------------------------------------------------------ ring channels
def test_ring_channel_wrap_around():
    ch = Channel(capacity=1 << 16, num_readers=1, num_slots=3)
    try:
        r = Channel.attach(ch.name)
        assert (r.capacity, r.num_readers, r.num_slots) == (1 << 16, 1, 3)
        for i in range(3):
            ch.write(i, timeout=5)
        for i in range(3):
            assert r.read(timeout=5) == i
        for i in range(50):
            ch.write(("v", torch.tensor([i])), timeout=5)
            tag, v = r.read(timeout=5)
            assert tag == "v" and int(v) == i
    finally:
        ch.close(unlink=True)


def test_ring_slow_reader_backpressure():
    ch = Channel(capacity=1 << 16, num_readers=1, num_slots=2)
    try:
        r = Channel.attach(ch.name)
        ch.write("a", timeout=5)
        ch.write("b", timeout=5)
        with pytest.raises(TimeoutError):
            ch.write("c", timeout=0.2)
        assert r.read(timeout=5) == "a"
        ch.write("c", timeout=5)
        assert r.read(timeout=5) == "b"
        assert r.read(timeout=5) == "c"
    finally:
        ch.close(unlink=True)


def test_ring_reader_cursor_isolation():
    ch = Channel(capacity=1 << 16, num_readers=2, num_slots=2)
    try:
        fast, slow = Channel.attach(ch.name), Channel.attach(ch.name)
        ch.write("x", timeout=5)
        ch.write("y", timeout=5)
        assert fast.read(timeout=5) == "x"
        assert fast.read(timeout=5) == "y"
        with pytest.raises(TimeoutError):
            ch.write("z", timeout=0.2)
        assert slow.read(timeout=5) == "x"
        ch.write("z", timeout=5)
        assert slow.read(timeout=5) == "y"
        assert slow.read(timeout=5) == "z"
        assert fast.read(timeout=5) == "z"
    finally:
        ch.close(unlink=True)


def test_ring_drains_after_close():
    ch = Channel(capacity=1 << 16, num_readers=1, num_slots=4)
    r = Channel.attach(ch.name)
    for i in range(3):
        ch.write(i, timeout=5)
    ch.close()
    assert [r.read(timeout=5) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ChannelClosedError):
        r.read(timeout=5)
    r.close(unlink=True)


def test_attached_channel_reserializes_with_true_counts():
    ch = Channel(capacity=1 << 12, num_readers=3, num_slots=2)
    try:
        hop1 = pickle.loads(pickle.dumps(ch))
        hop2 = pickle.loads(pickle.dumps(hop1))
        for h in (hop1, hop2):
            assert (h.capacity, h.num_readers, h.num_slots) == (1 << 12, 3, 2)
        with pytest.raises(ChannelError):
            hop2.write(b"x" * (1 << 13))   # over capacity: still rejected
        with pytest.raises(ChannelError):
            hop2.write(torch.zeros(1 << 11))   # 8 KiB of tensor bytes
    finally:
        ch.close(unlink=True)


# ------------------------------------------------------- zero-copy slots
def test_write_serializes_directly_into_slot():
    """write() reserves the slot and serializes INTO it (no staging
    through SerializedObject.to_bytes, which is poisoned here); the meta
    and the tensor's out-of-band bytes come back bit for bit."""
    from ray_tpu_torch.core import serialization

    ch = Channel(capacity=1 << 16, num_readers=1)
    orig = serialization.SerializedObject.to_bytes
    t = torch.randn(16, 8, generator=torch.Generator().manual_seed(1))
    try:
        def boom(self):
            raise AssertionError("write() staged through to_bytes()")

        serialization.SerializedObject.to_bytes = boom
        ch.write({"x": 1, "blob": b"z" * 1024, "t": t.to(torch.bfloat16)})
        r = Channel.attach(ch.name)
        got = r.read(timeout=5)
        assert got["x"] == 1 and got["blob"] == b"z" * 1024
        assert _bits(got["t"]) == _bits(t.to(torch.bfloat16))
    finally:
        serialization.SerializedObject.to_bytes = orig
        ch.close(unlink=True)


def test_read_zc_view_aliases_slot_until_release():
    """read_zc() hands out a SlotView whose tensor ALIASES the shm slot
    (no copy-out) and pins the slot until release(): a second write to a
    1-slot ring blocks while the view is pinned."""
    ch = Channel(capacity=1 << 20, num_readers=1, num_slots=1)
    try:
        r = Channel.attach(ch.name)
        arr = torch.arange(512, dtype=torch.int64)
        ch.write({"arr": arr}, timeout=5)
        sv = r.read_zc(timeout=5)
        out = sv.value()["arr"]
        assert torch.equal(out, arr)
        frame = np.frombuffer(sv.view(), dtype=np.uint8)
        assert np.shares_memory(out.numpy(), frame), \
            "read_zc value does not alias the slot"

        wrote = threading.Event()

        def writer():
            ch.write({"arr": arr * 2}, timeout=30)
            wrote.set()

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        assert not wrote.wait(0.5), "writer reclaimed a pinned slot"
        sv.release()
        assert wrote.wait(10), "release() did not unpin the slot"
        t.join(10)
        assert torch.equal(r.read(timeout=5)["arr"], arr * 2)
        with pytest.raises(ChannelError):
            sv.view()
    finally:
        ch.close(unlink=True)


def test_read_raw_and_zc_context_manager():
    """read_raw keeps the (seq, bytes) contract for remote forwarding:
    the bytes deserialize to the tensor bit for bit; SlotView releases on
    exit."""
    from ray_tpu_torch.core import serialization

    ch = Channel(capacity=1 << 16, num_readers=1, num_slots=2)
    t = torch.randn(33, generator=torch.Generator().manual_seed(2)).to(
        torch.bfloat16)
    try:
        r = Channel.attach(ch.name)
        ch.write("hello", timeout=5)
        ch.write(("world", t), timeout=5)
        with r.read_zc(timeout=5) as sv:
            assert sv.value() == "hello"
        seq, data = r.read_raw(r._last_seq, timeout=5)
        assert seq == 2
        word, back = serialization.loads(data)
        assert word == "world" and _bits(back) == _bits(t)
    finally:
        ch.close(unlink=True)


# -------------------------------------------------------------- eager DAGs
def test_eager_function_dag(cluster):
    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    @ray_tpu_torch.remote
    def mul(a, b):
        return a * b

    with InputNode() as inp:
        dag = mul.bind(add.bind(inp, 2), 10)
    ref = dag.execute(3)
    assert ray_tpu_torch.get(ref) == 50


# ------------------------------------------------------------ compiled DAGs
def test_compiled_linear_pipeline(cluster):
    @ray_tpu_torch.remote
    class Stage:
        def __init__(self, k):
            self.k = k

        def fwd(self, x):
            return x + self.k

    a = Stage.remote(1)
    b = Stage.remote(10)
    with InputNode() as inp:
        dag = b.fwd.bind(a.fwd.bind(inp))
    cdag = dag.experimental_compile()
    try:
        for i in range(5):
            ref = cdag.execute(i)
            assert ref.get() == i + 11
    finally:
        cdag.teardown(kill_actors=True)
    assert _rings(cdag) == []


def test_compiled_fan_out_fan_in(cluster):
    @ray_tpu_torch.remote
    class Worker:
        def double(self, x):
            return 2 * x

        def square(self, x):
            return x * x

        def merge(self, a, b):
            return a + b

    w1, w2, w3 = Worker.remote(), Worker.remote(), Worker.remote()
    with InputNode() as inp:
        d = w1.double.bind(inp)
        s = w2.square.bind(inp)
        dag = w3.merge.bind(d, s)
    cdag = dag.experimental_compile()
    try:
        assert cdag.execute(3).get() == 6 + 9
        assert cdag.execute(5).get() == 10 + 25
        x = torch.arange(4.0)
        assert torch.equal(cdag.execute(x).get(), 2 * x + x * x)
    finally:
        cdag.teardown(kill_actors=True)
    assert _rings(cdag) == []


def test_compiled_multi_output(cluster):
    @ray_tpu_torch.remote
    class Worker:
        def inc(self, x):
            return x + 1

        def dec(self, x):
            return x - 1

    w1, w2 = Worker.remote(), Worker.remote()
    with InputNode() as inp:
        dag = MultiOutputNode([w1.inc.bind(inp), w2.dec.bind(inp)])
    cdag = dag.experimental_compile()
    try:
        r1, r2 = cdag.execute(10)
        assert r1.get() == 11
        assert r2.get() == 9
    finally:
        cdag.teardown(kill_actors=True)
    assert _rings(cdag) == []


def test_compiled_iterations_skip_the_actor_call_path(cluster):
    """Mirror of test_compiled_throughput_beats_actor_calls: warm compiled
    iterations make no actor call, no task submission and no direct
    request at the driver's client (every hop is a ring handoff), where
    the same work by actor calls makes one call an iteration."""
    from ray_tpu_torch.core.api import _global_client

    @ray_tpu_torch.remote
    class Echo:
        def fwd(self, x):
            return x

    client = _global_client()
    calls = {"call_actor": 0, "submit_task": 0, "direct_request": 0}
    originals = {name: getattr(client, name) for name in calls}

    def counting(name):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return originals[name](*args, **kwargs)
        return wrapper

    e = Echo.remote()
    ray_tpu_torch.get(e.fwd.remote(0))
    with InputNode() as inp:
        dag = Echo.remote().fwd.bind(inp)
    cdag = dag.experimental_compile()
    try:
        assert cdag.execute(0).get(timeout=60) == 0   # warm the loop
        for name in calls:
            setattr(client, name, counting(name))
        try:
            n = 50
            for i in range(n):
                assert cdag.execute(i).get(timeout=60) == i
            compiled = dict(calls)
            for i in range(n):
                assert ray_tpu_torch.get(e.fwd.remote(i)) == i
        finally:
            for name in calls:
                setattr(client, name, originals[name])
    finally:
        cdag.teardown(kill_actors=True)
        ray_tpu_torch.kill(e)
    assert compiled == {"call_actor": 0, "submit_task": 0,
                        "direct_request": 0}, compiled
    assert calls["call_actor"] == n, calls


def test_compiled_max_inflight_pipelines(cluster, tmp_path):
    """Mirror of the reference's max_inflight case: with a ring depth of
    4 the driver submits three iterations WITHOUT blocking on the slow
    stage. The stage's first call after the warm-up waits on a gate the
    driver opens only after the third submit, so a submit that waited for
    the stage could never return (execute's write timeout would raise);
    the stage's recorded end time is after every submit's return."""
    gate = str(tmp_path / "gate")

    @ray_tpu_torch.remote
    class Slow:
        def __init__(self):
            self.ends = []

        def fwd(self, x):
            if x == 1:
                deadline = time.time() + 60
                while not os.path.exists(gate) and time.time() < deadline:
                    time.sleep(0.01)
            time.sleep(0.05)
            self.ends.append(time.time())
            return x + 1

        def stamps(self):
            return self.ends

    s = Slow.remote()
    with InputNode() as inp:
        dag = s.fwd.bind(inp)
    cdag = dag.experimental_compile(max_inflight=4)
    try:
        cdag.execute(0).get(timeout=60)   # warm the loop
        refs, returned = [], []
        for i in range(1, 4):
            refs.append(cdag.execute(i, timeout=10))
            returned.append(time.time())
        open(gate, "w").close()
        assert [r.get(timeout=60) for r in refs] == [2, 3, 4]
    finally:
        cdag.teardown()
    ends = ray_tpu_torch.get(s.stamps.remote(), timeout=60)
    ray_tpu_torch.kill(s)
    assert len(ends) == 4
    assert max(returned) < ends[1], (returned, ends)


def test_compiled_dag_device_channel(cluster):
    """Device edges: a @method(tensor_transport='device') output stays in
    the producer's device store — the ring carries only a descriptor —
    and the consumer receives a tensor. The producer's store holds at
    most 2 entries once the loops have ended."""
    @ray_tpu_torch.remote
    class Producer:
        @ray_tpu_torch.method(tensor_transport="device")
        def fwd(self, x):
            return torch.full((64, 64), float(x))

        def store_len(self):
            from ray_tpu_torch.core.api import _global_client

            return len(_global_client().device_store)

    @ray_tpu_torch.remote
    class Consumer:
        def reduce(self, arr):
            assert isinstance(arr, torch.Tensor), type(arr)
            return float(arr.sum())

    p, c = Producer.remote(), Consumer.remote()
    with InputNode() as inp:
        dag = c.reduce.bind(p.fwd.bind(inp))
    cdag = dag.experimental_compile()
    try:
        for i in range(6):
            assert cdag.execute(i).get(timeout=60) == 64 * 64 * i
    finally:
        cdag.teardown()
    deadline = time.time() + 20
    n = 99
    while time.time() < deadline:
        n = ray_tpu_torch.get(p.store_len.remote(), timeout=30)
        if n <= 2:
            break
        time.sleep(0.3)
    assert n <= 2, f"device outputs leaking: {n} live"
    ray_tpu_torch.kill(p)
    ray_tpu_torch.kill(c)
    assert _rings(cdag) == []


# ------------------------------------------------------------ beyond mirror
def test_kept_and_modified_argument_is_a_copy(cluster):
    """A local edge is parsed from its pinned ring slot, whose tensors
    alias the shm bytes and are writable (test_read_zc_view_aliases_slot_
    until_release). The loop hands the method a copy: a method that keeps
    every argument and adds to it in place sees each iteration's own
    value, and its writes never reach the ring (the next stage reads what
    the driver wrote)."""
    @ray_tpu_torch.remote
    class Keeper:
        def __init__(self):
            self.kept = []

        def keep(self, x):
            self.kept.append(x)
            x.add_(1000)
            return float(x[0])

        def peek(self, x):
            return float(x[0])

        def everything(self):
            return [float(t[0]) for t in self.kept]

    k, p = Keeper.remote(), Keeper.remote()
    with InputNode() as inp:
        dag = MultiOutputNode([k.keep.bind(inp), p.peek.bind(inp)])
    cdag = dag.experimental_compile(max_inflight=1)
    try:
        for i in range(6):
            kept, peeked = cdag.execute(torch.full((8,), float(i)))
            assert kept.get(timeout=60) == i + 1000
            assert peeked.get(timeout=60) == i
    finally:
        cdag.teardown()
    assert ray_tpu_torch.get(k.everything.remote(), timeout=60) == \
        [i + 1000.0 for i in range(6)]
    ray_tpu_torch.kill(k)
    ray_tpu_torch.kill(p)
    assert _rings(cdag) == []


def test_failing_stage_raises_its_error(cluster):
    """A stage that raises ends its loop and fences its output ring: the
    driver's get raises the stage's own error instead of waiting out its
    timeout, and nothing is retried or answered in its place."""
    @ray_tpu_torch.remote
    class Fragile:
        def fwd(self, x):
            if x == 3:
                raise ValueError("stage refused 3")
            return x

    @ray_tpu_torch.remote
    class Echo:
        def fwd(self, x):
            return x

    f, e = Fragile.remote(), Echo.remote()
    with InputNode() as inp:
        dag = e.fwd.bind(f.fwd.bind(inp))
    cdag = dag.experimental_compile()
    try:
        assert cdag.execute(2).get(timeout=60) == 2
        t0 = time.time()
        with pytest.raises(Exception, match="stage refused 3"):
            cdag.execute(3).get(timeout=60)
        assert time.time() - t0 < 30
    finally:
        cdag.teardown(kill_actors=True)
    assert _rings(cdag) == []
    assert glob.glob(f"/dev/shm/{next(iter(cdag.chan_names.values()))}") == []


def test_rings_of_a_sigkilled_stage_are_unlinked(cluster):
    """A stage's output ring lives in its actor's process. When that
    process dies by SIGKILL nobody can answer `dag_chan_close`, so the
    DAG's teardown unlinks the segment by name: no ring of the DAG is left
    in /dev/shm (the JAX package leaves the dead writer's)."""
    @ray_tpu_torch.remote
    class Stage:
        def pid(self):
            return os.getpid()

        def fwd(self, x):
            return x + 1

    a, b = Stage.remote(), Stage.remote()
    victim = ray_tpu_torch.get(a.pid.remote(), timeout=60)
    with InputNode() as inp:
        dag = b.fwd.bind(a.fwd.bind(inp))
    cdag = dag.experimental_compile()
    try:
        assert cdag.execute(1).get(timeout=60) == 3
        assert len(_rings(cdag)) == 3
        os.kill(victim, signal.SIGKILL)
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                os.kill(victim, 0)
            except ProcessLookupError:
                break
            time.sleep(0.05)
    finally:
        cdag.teardown(kill_actors=True)
    assert _rings(cdag) == []
