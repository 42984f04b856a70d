"""The port's core runtime held against the JAX package's on the same inputs.

- `resource_view`: a seeded sequence of node views and requests, label
  selectors included, gives the same fits and picks in both packages;
- `config`: the flag tables are equal in names, env vars, types, defaults
  and negotiation, but for the chip count that counts GPUs in the port;
- `serialization`: numpy and bytes payloads give identical meta and
  buffers; a `jax.Array` and a torch tensor of the same values give the
  same out-of-band bytes; bf16 comes back bit-equal;
- one seeded workload (chained tasks, `wait`, an actor's counter, a raised
  error, a named actor, a retried task) gives equal results on both
  runtimes, both `init`ed in this process one after the other;
- the port's compute through its runtime: a port actor serving gpt2-tiny
  (`device="cpu"`) gives the JAX package's greedy tokens, and a task's
  gpt2-tiny training step equals the in-process port step bit for bit.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.core import config as JC
from ray_tpu.core import resource_view as JV
from ray_tpu.core import serialization as JSer
from ray_tpu_torch.core import config as PC
from ray_tpu_torch.core import resource_view as PV
from ray_tpu_torch.core import serialization as PSer

# ------------------------------------------------------------ resource_view
KEYS = ("CPU", "GPU", "TPU", "mem")
LABELS = {"zone": ("a", "b", "c"), "ray.io/tpu-slice-name": ("s0", "s1"),
          "tier": ("gold", "std")}


def _resources(rng, scale):
    return {k: float(rng.integers(0, scale)) for k in KEYS
            if rng.random() < 0.7}


def _selector(rng):
    if rng.random() < 0.3:
        return None
    sel = {}
    for k, vals in LABELS.items():
        r = rng.random()
        if r < 0.3:
            sel[k] = vals[int(rng.integers(len(vals)))]
        elif r < 0.45:
            sel[k] = list(vals[:int(rng.integers(1, len(vals) + 1))])
    return sel


def _entry(V, rng, i):
    total = _resources(rng, 9)
    free = {k: float(rng.integers(0, int(v) + 1)) for k, v in total.items()}
    labels = {k: vals[int(rng.integers(len(vals)))]
              for k, vals in LABELS.items() if rng.random() < 0.8}
    shapes = None
    if rng.random() < 0.6:
        shapes = [[sorted(_resources(rng, 3).items()),
                   int(rng.integers(0, 3))] for _ in range(2)]
    return V.make_entry(
        f"{i:02x}" + rng.bytes(15).hex(), version=int(rng.integers(1, 5)),
        free=free, total=total, labels=labels,
        idle_workers=int(rng.integers(0, 3)),
        sched_addr=("127.0.0.1", 7000 + i) if rng.random() < 0.8 else None,
        is_head=i == 0, store_frac=float(rng.random()), pool_shapes=shapes)


def _decisions(V, seed):
    rng = np.random.default_rng(seed)
    view = V.ClusterView()
    out = []
    for i in range(12):
        out.append(view.update(_entry(V, rng, i)))
    for _ in range(200):
        res = _resources(rng, 5)
        sel = _selector(rng)
        ids = sorted(view.entries)
        exclude = ids[int(rng.integers(len(ids)))] if rng.random() < 0.2 \
            else None
        pick = view.select_node(res, sel, exclude=exclude)
        out.append((
            pick and pick["node_id"],
            [r["node_id"] for r in view.spill_candidates(
                res, sel, exclude=exclude, limit=int(rng.integers(0, 4)))],
            [V.fits(view.entries[n]["free"], res) for n in ids],
            [V.matches_labels(view.entries[n]["labels"], sel) for n in ids],
            [V.has_matching_shape(view.entries[n]["pool_shapes"], res)
             for n in ids],
            [V.shard_of(n, 4) for n in ids]))
        if rng.random() < 0.1:   # a node leaves, a newer one takes its place
            gone = ids[int(rng.integers(len(ids)))]
            out.append((view.remove(gone), view.version))
            out.append(view.update(_entry(V, rng, len(ids) + 1)))
    out.append(view.max_store_frac())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resource_view_decisions_match(seed):
    got, want = _decisions(PV, seed), _decisions(JV, seed)
    assert got == want
    # the sequence exercises every kind of answer
    picks = [d[0] for d in want if isinstance(d, tuple) and len(d) == 6]
    assert any(p is None for p in picks) and any(picks)


# ------------------------------------------------------------------- config
# the one flag that differs: the JAX package overrides the TPU chip count,
# the port the GPU count
CONFIG_EXCEPTIONS = {"num_chips": "num_gpus"}


def test_config_flag_tables_match():
    def table(flags, rename=None):
        return {(rename or {}).get(f.name, f.name):
                (f.env.replace("CHIPS", "GPUS"), f.type, f.default,
                 f.negotiated) for f in flags}

    want = table(JC.FLAGS, CONFIG_EXCEPTIONS)
    got = table(PC.FLAGS)
    assert got == want
    by_name = {f.name: f for f in PC.FLAGS}
    assert by_name["num_gpus"].env == "RAY_TPU_NUM_GPUS"
    assert [f.name for f in PC.FLAGS] == [
        CONFIG_EXCEPTIONS.get(f.name, f.name) for f in JC.FLAGS]
    # state and shm segments of their own: neither package's cleanup can
    # match the other's, and no state dir is named like a package
    from ray_tpu.utils.platform import STATE_DIR as JSTATE
    from ray_tpu_torch.core.store import SHM_PREFIX
    from ray_tpu_torch.utils.platform import STATE_DIR

    assert STATE_DIR != JSTATE
    assert os.path.basename(STATE_DIR) not in ("ray_tpu", "ray_tpu_torch")
    assert not SHM_PREFIX.startswith("rtpu_") and not "rtpu_".startswith(
        SHM_PREFIX)


_STATE_PROBE = """
import json, os
import ray_tpu_torch as rt
from ray_tpu_torch.utils.platform import STATE_DIR

info = rt.init(num_cpus=1, num_gpus=0, max_workers=2)
try:
    @rt.remote
    def worker_state_dir():
        from ray_tpu_torch.utils import platform
        return platform.STATE_DIR

    seen = rt.get(worker_state_dir.remote(), timeout=120)
    print(json.dumps({"driver": STATE_DIR, "worker": seen,
                      "session": info["session"]}))
finally:
    rt.shutdown()
"""


def test_state_dir_follows_tmpdir(tmp_path):
    # the runtime's on-disk state lives in the temp dir its processes
    # inherit: driver, head and workers all write under $TMPDIR
    import json
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, TMPDIR=str(tmp_path), PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", _STATE_PROBE], env=env,
                         capture_output=True, text=True, timeout=180,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    want = str(tmp_path / "ray_tpu_torch_state")
    assert got["driver"] == got["worker"] == want
    assert (tmp_path / "ray_tpu_torch_state" / got["session"]).is_dir()


# ------------------------------------------------------------ serialization
def _payloads():
    rng = np.random.default_rng(3)
    return [
        rng.standard_normal((64, 33)).astype(np.float32),
        np.arange(1000, dtype=np.int64).reshape(10, 100)[:, ::3],  # strided
        rng.integers(0, 255, 4096, dtype=np.uint8),
        {"a": rng.standard_normal(7), "b": [np.zeros((0, 3)), "text", 5]},
        b"raw bytes " * 1000,
        bytearray(b"\x00\x01" * 700),
        ("tuple", 1.5, None, {"nested": np.ones((2, 2), np.float16)}),
    ]


def _frame(ser):
    return ser.meta, [bytes(b) for b in ser.buffers]


def test_serialization_numpy_and_bytes_identical():
    for value in _payloads():
        got, want = PSer.serialize(value), JSer.serialize(value)
        assert _frame(got) == _frame(want)
        assert got.to_bytes() == want.to_bytes()
        back = PSer.loads(want.to_bytes())
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(back, value)
        elif isinstance(value, (bytes, bytearray)):
            assert back == value and type(back) is type(value)


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_serialization_tensor_bytes_match_jax_array(dtype):
    rng = np.random.default_rng(4)
    vals = rng.standard_normal((5, 17)).astype(np.float32) * 100
    j = jnp.asarray(vals, getattr(jnp, dtype))
    t = torch.from_numpy(vals).to(getattr(torch, dtype))
    want, got = JSer.serialize(j), PSer.serialize(t)
    assert [bytes(b) for b in got.buffers] == [np.asarray(j).tobytes()]
    if dtype != "bfloat16":
        assert [bytes(b) for b in want.buffers] == [np.asarray(j).tobytes()]
    else:
        # the JAX package's bf16 leaf is an ml_dtypes array, which numpy
        # pickles in band: the same bytes, inside its meta
        assert not want.buffers and np.asarray(j).tobytes() in want.meta
    assert len(got.buffers) == 1 and len(got.meta) < 1024
    back = PSer.deserialize(type(got).from_view(memoryview(got.to_bytes())))
    assert back.dtype == t.dtype and back.shape == t.shape
    assert back.device.type == "cpu"
    assert torch.equal(back.view(torch.uint8), t.view(torch.uint8))


def test_serialization_bf16_round_trip_bit_equal():
    g = torch.Generator().manual_seed(5)
    t = torch.randn((3, 4, 129), generator=g).to(torch.bfloat16)
    t[0, 0, :4] = torch.tensor([float("nan"), float("inf"), -0.0, 1e-40])
    value = {"w": t, "p": torch.nn.Parameter(t[1].float()),
             "slice": t[:, 1:3].transpose(0, 1), "scalar": t[0, 0, 5]}
    ser = PSer.serialize(value)
    assert len(ser.meta) < 1024 and len(ser.buffers) == 4
    back = PSer.deserialize(type(ser).from_view(memoryview(ser.to_bytes())))
    for k, v in value.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        assert torch.equal(back[k].detach().contiguous().view(-1).view(
            torch.uint8), v.detach().contiguous().view(-1).view(torch.uint8))
    assert type(back["p"]) is torch.nn.Parameter and back["p"].requires_grad


def test_device_snapshot_carries_tensor_bytes_out_of_band():
    """A device snapshot (the device object's shm copy) of f32, int32 and
    bf16 leaves keeps its meta under 4096 bytes, carries every byte out of
    band, and rematerializes bit-equal (on the CPU here: no card)."""
    from ray_tpu_torch.core import device_transport as dt

    g = torch.Generator().manual_seed(3)
    value = {"f32": torch.randn((1 << 20,), generator=g),
             "i32": torch.arange(4099, dtype=torch.int32),
             "bf16": torch.randn((3, 129), generator=g).to(torch.bfloat16),
             "host": np.arange(5)}
    ser = PSer.serialize(value, device_snapshot=True)
    assert len(ser.meta) < 4096
    want = sum(t.numel() * t.element_size() for k, t in value.items()
               if k != "host")
    assert sum(b.nbytes for b in ser.buffers) >= want
    with dt.rematerialize_context():
        back = PSer.deserialize(type(ser).from_view(
            memoryview(ser.to_bytes())))
    for k in ("f32", "i32", "bf16"):
        assert back[k].dtype == value[k].dtype
        assert back[k].device.type == "cpu"
        assert torch.equal(back[k].view(torch.uint8) if k != "bf16" else
                           back[k].view(torch.int16),
                           value[k].view(torch.uint8) if k != "bf16" else
                           value[k].view(torch.int16))
    np.testing.assert_array_equal(back["host"], value["host"])


# ------------------------------------------------ one workload, two runtimes
def _workload(pkg, marker_dir):
    """Chained tasks, wait, an actor's counter, a raised error, a named
    actor and a retried task through `pkg`'s API: a dict of results."""
    @pkg.remote
    def add(a, b):
        return a + b

    @pkg.remote
    def boom(msg):
        raise ValueError(msg)

    @pkg.remote(max_retries=2)
    def die_once(marker):
        import os as _os

        if not _os.path.exists(marker):
            open(marker, "w").close()
            _os.kill(_os.getpid(), 9)
        return "survived"

    @pkg.remote
    class Counter:
        def __init__(self, start):
            self.v = start

        def incr(self, k):
            self.v += k
            return self.v

    rng = np.random.default_rng(11)
    xs = rng.integers(0, 100, 8).tolist()
    out = {}
    ref = add.remote(xs[0], xs[1])
    for x in xs[2:]:
        ref = add.remote(ref, x)
    out["chain"] = pkg.get(ref, timeout=60)
    refs = [add.remote(x, x) for x in xs]
    ready, pending = pkg.wait(refs, num_returns=5, timeout=60)
    out["wait"] = (len(ready), len(pending),
                   sorted(pkg.get(refs, timeout=60)))
    c = Counter.remote(int(xs[0]))
    out["counter"] = [pkg.get(c.incr.remote(int(x)), timeout=60)
                      for x in xs]
    try:
        pkg.get(boom.remote(f"bang {xs[3]}"), timeout=60)
        out["error"] = None
    except Exception as e:   # TaskError of each package
        out["error"] = (type(e).__name__, "ValueError" in str(e),
                        f"bang {xs[3]}" in str(e))
    Counter.options(name="parity-counter").remote(1000)
    named = pkg.get_actor("parity-counter")
    out["named"] = pkg.get(named.incr.remote(xs[5]), timeout=60)
    out["retried"] = pkg.get(die_once.remote(
        os.path.join(marker_dir, "died")), timeout=60)
    return out


def test_seeded_workload_matches_on_both_runtimes(tmp_path):
    results = {}
    for name, pkg, kw in (("jax", ray_tpu, {"num_tpu_chips": 0}),
                          ("port", ray_tpu_torch, {"num_gpus": 0})):
        d = tmp_path / name
        d.mkdir()
        try:
            pkg.init(num_cpus=4, max_workers=6, **kw)
            results[name] = _workload(pkg, str(d))
        finally:
            pkg.shutdown()
    assert results["port"] == results["jax"]
    assert results["jax"]["error"] == ("TaskError", True, True)
    assert results["jax"]["retried"] == "survived"


# ------------------------------------------- the port's compute, as actors
def _checkpoint(root):
    """gpt2-tiny with the seeded weights of tests/test_torch_serve_llm.py
    (larger than GPT-2's init, so greedy streams do not just repeat)."""
    from ray_tpu_torch.models import gpt2 as PG

    cfg = PG.GPT2Config.preset("gpt2-tiny")
    rng = np.random.default_rng(7)
    flat = {}
    for key, shape in PG.param_shapes(cfg).items():
        matrix = len(shape) - key.startswith("blocks/") == 2
        if key.endswith("scale"):
            a = 1 + 0.1 * rng.standard_normal(shape)
        else:
            a = (0.2 if matrix else 0.05) * rng.standard_normal(shape)
        flat[key] = a.astype(np.float32)
    params = PG.params_from_numpy(flat, cfg, device="cpu")
    return PG.save_params(str(root), params, cfg)


PROMPTS = ["the quick brown fox jumps over the lazy dog " * 2, "hello",
           "a shorter prompt with its own tail"]
ENGINE = dict(preset="gpt2-tiny", max_batch=2, max_seq_len=128, kv_blocks=32,
              kv_block_size=8)


def test_port_compute_through_the_runtime(tmp_path):
    from ray_tpu.serve import llm as JS

    # defined here so that they pickle by value: a worker never imports
    # this module (and with it jax and ray_tpu)
    class TinyServer:
        def __init__(self, checkpoint):
            import torch as _torch

            from ray_tpu_torch.serve import llm

            self.engine = llm.LLMEngine(
                model_overrides={"dtype": _torch.float32}, device="cpu",
                checkpoint=checkpoint, **ENGINE)

        def generate(self, prompt, max_tokens):
            return self.engine.generate(prompt, max_tokens=max_tokens)

    def train_step(seed):
        """One gpt2-tiny step on one torch thread: (loss, grad_norm,
        params); one thread in both processes, so the sums run in one
        order."""
        import torch as _torch

        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.train import spmd

        threads = _torch.get_num_threads()
        _torch.set_num_threads(1)
        try:
            cfg = gpt2.GPT2Config.preset(
                "gpt2-tiny", dtype=_torch.float32, attn_impl="flash",
                remat=True, remat_policy="dots")
            opt = spmd.default_optimizer(lr=1e-2, warmup=0, total_steps=10)
            train = spmd.compile_gpt2_train(cfg, optimizer=opt, device="cpu")
            state = train.init_fn(_torch.Generator().manual_seed(seed))
            toks = np.random.default_rng(seed).integers(0, 512, (2, 33))
            state, m = train.step_fn(state,
                                     {"tokens": _torch.from_numpy(toks)})
            return (float(m["loss"]), float(m["grad_norm"]),
                    gpt2.params_to_numpy(state.params))
        finally:
            _torch.set_num_threads(threads)

    ckpt = _checkpoint(tmp_path / "ckpt")
    jeng = JS.LLMEngine(model_overrides={"dtype": jnp.float32},
                        weight_store=False, checkpoint=ckpt, **ENGINE)
    try:
        want = [jeng.generate(p, max_tokens=10) for p in PROMPTS]
    finally:
        jeng.shutdown()
    want_step = train_step(3)
    try:
        ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_workers=4)
        server = ray_tpu_torch.remote(TinyServer).remote(ckpt)
        got = [ray_tpu_torch.get(server.generate.remote(p, 10), timeout=120)
               for p in PROMPTS]
        step = ray_tpu_torch.get(ray_tpu_torch.remote(train_step).remote(3),
                                 timeout=120)
    finally:
        ray_tpu_torch.shutdown()
    assert got == want
    assert all(len(set(g["token_ids"])) > 1 for g in got)
    assert step[:2] == want_step[:2]
    assert step[2].keys() == want_step[2].keys()
    for k, v in want_step[2].items():
        np.testing.assert_array_equal(step[2][k], v, err_msg=k)
