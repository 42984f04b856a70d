"""Sharded checkpoints in the port (`ray_tpu_torch/train/checkpoint.py`,
`train/spmd.save_state_sharded`/`restore_state_sharded`) against the JAX
package's format and its reader and writer.

One module-scoped job of two spawned gloo ranks
(`_torch_dist_workers.checkpoint_ranks`) does the port's multi-process
part; the JAX side runs in this process on virtual CPU devices. The state
is gpt2-tiny's whole `TrainState` (step, params, both Adam moments, the two
optimizer counts) after real steps, so the moments are not zero:

- JAX saves on dp=2,fsdp=2 (4 devices, one process); the port restores it
  bit-equal at world 1 and on a 2-rank fsdp=2 mesh, gathering and
  streaming;
- the port saves from 2 ranks (fsdp=2, and sp=2 with ring attention); JAX's
  `restore_state_sharded` restores both bit-equal at world 1, 2 and 4;
- the port's own checkpoint 2 -> 1 -> 2 ranks (fsdp=2, one device, tp=2)
  bit-equal; a step after the restore bit-equal (loss and every param) to
  the unbroken run's; streaming equal to gathering;
- the multi-process chunk scoping (`tests/test_train_e2e.py:160`), the
  top-K manager (`tests/test_train.py:27`) and bf16 leaves both ways.
"""

import json
import os
import threading
import zipfile

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from ray_tpu.models import gpt2 as JG
from ray_tpu.parallel.mesh import MeshConfig, build_mesh
from ray_tpu.train import checkpoint as JC
from ray_tpu.train import spmd as JS
from ray_tpu_torch.train import checkpoint as PC
from ray_tpu_torch.train import spmd as PS
from ray_tpu_torch.train.config import CheckpointConfig

OPT = dict(lr=1e-3, warmup=2, total_steps=20)


def _tokens():
    return np.random.default_rng(4).integers(0, 512, (4, 33))


def _jax_prog(config):
    cfg = JG.GPT2Config.preset("gpt2-tiny", dtype=jax.numpy.float32,
                               attn_impl="dense")
    n = int(np.prod(list(config.values())))
    mesh = build_mesh(MeshConfig(**config), devices=jax.devices()[:n])
    return JS.compile_gpt2_train(cfg, mesh,
                                 optimizer=JS.default_optimizer(**OPT))


def _jax_numpy(state) -> dict:
    return {JC._leaf_key(kp): np.asarray(leaf) for kp, leaf in
            jax.tree_util.tree_flatten_with_path(JS._state_as_tree(state))[0]}


def _bit_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, arr in want.items():
        g = np.asarray(got[key])
        assert g.shape == arr.shape and g.dtype == arr.dtype, key
        assert g.tobytes() == arr.tobytes(), key


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """JAX's 1-step state saved on dp=2,fsdp=2, then the ranks' job."""
    tmp = tmp_path_factory.mktemp("ckpt")
    prog = _jax_prog({"dp": 2, "fsdp": 2})
    state = prog.init_fn(jax.random.key(0))
    batch = {"tokens": jax.device_put(_tokens()[:, :17].astype(np.int32),
                                      prog.batch_sharding)}
    state, _ = prog.step_fn(state, batch)
    JS.save_state_sharded(state, str(tmp / "jax"), world_size=4)
    np.savez(tmp / "inputs.npz", tokens=_tokens())
    outs = W.run_ranks(W.checkpoint_ranks, 2, str(tmp), timeout=240)
    return tmp, _jax_numpy(state), outs


def _port_train():
    return W._ckpt_train(None)


def test_jax_checkpoint_restores_in_the_port(saved):
    tmp, want, outs = saved
    assert PC.is_sharded_checkpoint(str(tmp / "jax"))
    assert PC.read_sharded_manifest(str(tmp / "jax"))["world_size"] == 4
    train = _port_train()
    for kw in ({}, {"stream_chunk_bytes": 2048}):
        got = PS.restore_state_sharded(str(tmp / "jax"), train, **kw)
        assert got.step == 1 and got.opt_state.count == 1
        _bit_equal(W.state_numpy(got), want)
    for o in outs:                      # on a 2-rank fsdp=2 mesh
        for got in o["jax"]:
            _bit_equal(got, want)


@pytest.mark.parametrize("which", ["fsdp", "sp"])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_port_checkpoint_restores_in_jax(saved, which, world):
    tmp, _, outs = saved
    want = outs[0][f"{which}_saved"]
    assert all(o[f"{which}_saved"].keys() == want.keys() for o in outs)
    config = {1: {"dp": 1}, 2: {"dp": 2}, 4: {"fsdp": 2, "tp": 2}}[world]
    manifest = JC.read_sharded_manifest(str(tmp / f"port-{which}"))
    assert (manifest["world_size"], manifest["num_save_processes"]) == (2, 2)
    got = JS.restore_state_sharded(str(tmp / f"port-{which}"),
                                   _jax_prog(config))
    assert int(got.step) == 2
    _bit_equal(_jax_numpy(got), want)


def test_port_restores_its_own_checkpoint_two_one_two(saved):
    _, _, outs = saved
    for o in outs:
        _bit_equal(o["two_one_two"], outs[0]["fsdp_saved"])


def test_step_after_restore_equals_the_unbroken_run(saved):
    _, _, outs = saved
    for o in outs:
        losses, end = o["fsdp_unbroken"]
        gathered, streamed = o["fsdp_resumed"]
        for restored, loss, after in (gathered, streamed):
            _bit_equal(restored, o["fsdp_saved"])
            assert loss == losses[2:]
            _bit_equal(after, end)
        assert losses[2] < losses[0]


def test_sp_state_saved_from_two_ranks(saved):
    _, _, outs = saved
    assert outs[0]["sp_losses"] == outs[1]["sp_losses"]
    assert outs[0]["sp_saved"]["step"] == 2


def test_restore_checks_shapes_and_counts(tmp_path):
    train = _port_train()
    state = train.init_fn(torch.Generator().manual_seed(0))
    PS.save_state_sharded(state, str(tmp_path / "a"))
    path = tmp_path / "a" / "manifest_p00000.json"
    manifest = json.loads(path.read_text())
    # a state whose two optimizer counts differ is not one the port keeps
    with np.load(tmp_path / "a" / "shards_p00000.npz") as z:
        blobs = {k: z[k] for k in z.files}
    blobs["opt_state/1/2/.count::0"] = np.int32(5)
    np.savez(tmp_path / "a" / "shards_p00000.npz", **blobs)
    with pytest.raises(ValueError, match="counts"):
        PS.restore_state_sharded(str(tmp_path / "a"), train)
    manifest["params"]["params/wte"]["shape"] = [8, 128]
    path.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="does not match|program shape"):
        PS.restore_state_sharded(str(tmp_path / "a"), train)


def test_bf16_state_round_trips_bit_for_bit(tmp_path):
    mod, cfg = W.family("gpt2", attn_impl="dense",
                        param_dtype=torch.bfloat16)
    train = PS.compile_model_train(mod, cfg, optimizer=PS.default_optimizer(
        **OPT), device="cpu")
    state = train.init_fn(torch.Generator().manual_seed(0))
    state, _ = train.step_fn(state, {"tokens": _tokens()})
    PS.save_state_sharded(state, str(tmp_path / "b"))
    manifest = PC.read_sharded_manifest(str(tmp_path / "b"))
    assert manifest["params"]["params/wte"]["dtype"] == "bfloat16"
    want = W.state_numpy(state)
    for kw in ({}, {"stream_chunk_bytes": 1000}):
        got = PS.restore_state_sharded(str(tmp_path / "b"), train, **kw)
        assert got.params["wte"].dtype == torch.bfloat16
        _bit_equal(W.state_numpy(got), want)


def test_bf16_leaf_between_the_packages(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 5)).astype(ml_dtypes.bfloat16)
    JC.save_sharded({"w": jax.numpy.asarray(x)}, str(tmp_path / "jax"))
    bits = x.view(np.int16)
    # JAX -> port: both readers give the same two bytes a value
    flat, manifest = PC.load_sharded(str(tmp_path / "jax"))
    assert manifest["params"]["w"]["dtype"] == "bfloat16"
    assert flat["w"].tobytes() == bits.tobytes()
    readers, _ = PC.open_sharded(str(tmp_path / "jax"))
    assert readers["w"].read(((1, 4), (0, 5))).tobytes() == \
        bits[1:4].tobytes()
    # port -> JAX: the member the port writes is the JAX package's, header
    # ('<V2') and payload, and JAX's lazy reader gives its bits back
    t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    PC.save_sharded({"w": t}, str(tmp_path / "port"))
    members = []
    for d in ("jax", "port"):
        with zipfile.ZipFile(tmp_path / d / "shards_p00000.npz") as zf:
            members.append(zf.read("w::0.npy"))
    assert members[0] == members[1]
    assert json.loads((tmp_path / "port" / "manifest_p00000.json")
                      .read_text())["params"] == manifest["params"]
    rows = JC._LazyNpz(str(tmp_path / "port" / "shards_p00000.npz")
                       ).read_rows("w::0", 0, 6)
    assert rows.view(ml_dtypes.bfloat16).tobytes() == x.tobytes()
    # the JAX package's gathering reader cannot assign a '<V2' member to
    # its bfloat16 array (numpy has no such cast): it fails on its own
    # checkpoint and on the port's alike (ROADMAP queue 3)
    for d in ("jax", "port"):
        with pytest.raises(ValueError, match="cast"):
            JC.load_sharded(str(tmp_path / d))


def test_multiprocess_chunks_scoped_to_their_npz(tmp_path):
    # as tests/test_train_e2e.py:160: blob names repeat across processes,
    # so each process's chunk list is read against its own npz only
    d = tmp_path / "ckpt"
    d.mkdir()
    top = np.arange(8, dtype=np.float32).reshape(2, 4)
    bottom = np.arange(8, 16, dtype=np.float32).reshape(2, 4)
    for pidx, (win, data) in enumerate((([[0, 2], [0, 4]], top),
                                        ([[2, 4], [0, 4]], bottom))):
        np.savez(str(d / f"shards_p{pidx:05d}.npz"), **{"w::0": data})
        with open(d / f"manifest_p{pidx:05d}.json", "w") as f:
            json.dump({"format": PC.SHARDED_FORMAT, "step": 3,
                       "world_size": 2, "process_index": pidx,
                       "params": {"w": {"shape": [4, 4],
                                        "dtype": "float32"}},
                       "chunks": [{"leaf": "w", "blob": "w::0",
                                   "index": win}]}, f)
    flat, manifest = PC.load_sharded(str(d))
    assert manifest["num_save_processes"] == 2
    want = np.concatenate([top, bottom])
    assert (flat["w"] == want).all()
    readers, _ = PC.open_sharded(str(d))
    assert (readers["w"].read(((1, 3), (1, 4))) == want[1:3, 1:]).all()
    (d / "shards_p00001.npz").unlink()
    np.savez(str(d / "shards_p00001.npz"), other=bottom)
    with pytest.raises(ValueError, match="missing"):
        PC.load_sharded(str(d))


def test_checkpoint_manager_topk(tmp_path):
    # as tests/test_train.py:27
    mgr = PC.CheckpointManager(
        str(tmp_path / "store"),
        CheckpointConfig(num_to_keep=2, checkpoint_score_attribute="acc"))
    for i, acc in enumerate([0.1, 0.9, 0.5]):
        src = tmp_path / f"ckpt{i}"
        src.mkdir()
        (src / "model.txt").write_text(str(acc))
        mgr.register(PC.Checkpoint(str(src)), {"acc": acc})
    assert len(mgr.tracked) == 2
    best = mgr.best_checkpoint()
    assert open(os.path.join(best.path, "model.txt")).read() == "0.9"
    assert mgr.latest_checkpoint().path.endswith("checkpoint_000003")
    mgr2 = PC.CheckpointManager.restore(str(tmp_path / "store"))
    assert len(mgr2.tracked) == 2


def test_lazy_reads_from_many_threads(tmp_path):
    # reshard_streaming reads a leaf's rows from several threads at once
    big = np.arange(64 * 300, dtype=np.float32).reshape(64, 300)
    PC.save_sharded({"a": big, "b": big[:7] * 2}, str(tmp_path / "c"))
    readers, _ = PC.open_sharded(str(tmp_path / "c"))
    bad = []

    def work(seed):
        rng = np.random.default_rng(seed)
        for _ in range(40):
            r0 = int(rng.integers(0, 60))
            r1 = r0 + int(rng.integers(1, 5))
            if not (readers["a"].read(((r0, r1), (0, 300)))
                    == big[r0:r1]).all():
                bad.append((r0, r1))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads) and not bad
