"""The port's trainer (`ray_tpu_torch.train`): controller, worker group,
report/checkpoint, failure policy, the SPMD and torch DDP trainers, and the
whole slice against the JAX package.

The mirror of `tests/test_train.py` (controller with dummy workers, top-K
checkpoints, failure policy, resume, elastic sizing), of
`tests/test_train_e2e.py`'s trainer and restart cases (`SpmdTrainer`, the
counterpart of `JaxTrainer`) and of the reference file
`tests/test_torch_trainer.py` (gloo DDP over two workers), on one
module-scoped port runtime (four GPUs in its ledger and no card touched;
the mirror's cases ask for the CPU with `use_gpu=False`). Beside the
mirror:

- the whole slice against the JAX package: the port's `SpmdTrainer` (one
  CPU worker) trains gpt2-tiny (f32) for 4 steps from `params_from_numpy`
  of the JAX package's `gpt2.init_params`, fed by the port's Dataset
  (`from_numpy` -> `map_batches` -> `random_shuffle`) through
  `get_dataset_shard`; the reference is the JAX package's own
  `DatasetShard` over its Dataset feeding `ray_tpu.train.spmd.
  compile_gpt2_train` in this process. Losses and grad norms agree within
  the repo's trajectory tolerance, atol 1e-5 / rtol 1e-4;
- two gloo workers on a dp=2 mesh (`maybe_init_distributed`,
  `build_mesh`) match that one worker within the same tolerance on the
  same global batches, each rank's rows its window of the batch;
- local ranks: the two workers of one node get 0 and 1 (`LOCAL_RANK`, the
  context and the device the group names), where the JAX package gives
  every worker 0;
- the device env the group writes (a card a worker by default, the first
  of its own cards with `gpus_per_worker`, the CPU only with
  `use_gpu=False`), and `prepare_model` outside a worker on the card;
- the report barrier: a checkpoint commits once every rank reported its
  step; the loop reaches the controller as bytes (`ShippedLoop`);
- the GPU asks of `ScalingConfig` and the refusal of a TPU `topology`.

Train loops run in the workers from `tests/_torch_train_loops.py`, which
imports no JAX.
"""

import os

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rdata
from ray_tpu_torch import train
from ray_tpu_torch.train import (Checkpoint, CheckpointConfig, FailureConfig,
                                 RunConfig, ScalingConfig, SpmdTrainer,
                                 TorchTrainer)
from ray_tpu_torch.train.checkpoint import CheckpointManager
from ray_tpu_torch.train.controller import TrainControllerLogic
from ray_tpu_torch.train.trainer import (DataParallelTrainer,
                                         TrainingFailedError)
from ray_tpu_torch.train.worker_group import local_ranks

import _torch_train_loops as loops

TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def cluster():
    # four GPUs in the resource ledger (no card is touched): the workers'
    # device env is checked for GPU configs; every other case asks for the
    # CPU with use_gpu=False
    info = ray_tpu_torch.init(num_cpus=8, num_gpus=4, max_workers=16)
    yield info
    ray_tpu_torch.shutdown()


# ------------------------------------------------ the mirror of test_train
def test_checkpoint_manager_topk(tmp_path):
    mgr = CheckpointManager(
        str(tmp_path / "store"),
        CheckpointConfig(num_to_keep=2, checkpoint_score_attribute="acc"))
    for i, acc in enumerate([0.1, 0.9, 0.5]):
        src = tmp_path / f"ckpt{i}"
        src.mkdir()
        (src / "model.txt").write_text(str(acc))
        mgr.register(Checkpoint(str(src)), {"acc": acc})
    assert len(mgr.tracked) == 2
    best = mgr.best_checkpoint()
    assert (open(os.path.join(best.path, "model.txt")).read()) == "0.9"
    # restore from manifest
    mgr2 = CheckpointManager.restore(str(tmp_path / "store"))
    assert len(mgr2.tracked) == 2


def _train_fn(config):
    import tempfile

    ctx = train.get_context()
    for step in range(config["steps"]):
        metrics = {"step": step, "loss": 1.0 / (step + 1),
                   "rank": ctx.get_world_rank(),
                   "world": ctx.get_world_size()}
        if ctx.get_world_rank() == 0 and step == config["steps"] - 1:
            d = tempfile.mkdtemp(dir=config["ckpt_root"])
            with open(os.path.join(d, "weights.txt"), "w") as f:
                f.write(f"step={step}")
            train.report(metrics, checkpoint=Checkpoint(d))
        else:
            train.report(metrics)


def test_data_parallel_trainer(cluster, tmp_path):
    trainer = DataParallelTrainer(
        _train_fn,
        train_loop_config={"steps": 3, "ckpt_root": str(tmp_path)},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False,
                                     resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name="t1", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["step"] == 2
    assert result.metrics["world"] == 2
    assert result.checkpoint is not None
    assert open(os.path.join(result.checkpoint.path,
                             "weights.txt")).read() == "step=2"


def _failing_fn(config):
    ctx = train.get_context()
    marker = config["marker"]
    if ctx.get_world_rank() == 0 and not os.path.exists(marker):
        open(marker, "w").close()
        raise RuntimeError("injected failure")
    train.report({"ok": True, "attempt": 2})


def test_failure_policy_restart(cluster, tmp_path):
    trainer = DataParallelTrainer(
        _failing_fn,
        train_loop_config={"marker": str(tmp_path / "failed_once")},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False,
                                     resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name="t2", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1)),
    )
    result = trainer.fit()
    assert result.restarts == 1
    assert result.metrics["ok"] is True


def test_failure_policy_exhausted(cluster, tmp_path):
    def always_fail(config):
        raise RuntimeError("always broken")

    trainer = DataParallelTrainer(
        always_fail,
        train_loop_config={},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False,
                                     resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name="t3", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=0)),
    )
    with pytest.raises(TrainingFailedError, match="always broken"):
        trainer.fit()


def _resume_fn(config):
    ctx = train.get_context()
    start = 0
    ck = ctx.get_checkpoint()
    if ck is not None:
        start = int(open(os.path.join(ck.path, "step.txt")).read()) + 1
    import tempfile

    for step in range(start, config["until"]):
        d = tempfile.mkdtemp(dir=config["ckpt_root"])
        with open(os.path.join(d, "step.txt"), "w") as f:
            f.write(str(step))
        train.report({"step": step, "resumed_from": start},
                     checkpoint=Checkpoint(d))


def test_resume_from_checkpoint(cluster, tmp_path):
    cfg = dict(
        train_loop_config={"until": 2, "ckpt_root": str(tmp_path)},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False,
                                     resources_per_worker={"CPU": 1}),
    )
    t1 = DataParallelTrainer(
        _resume_fn,
        run_config=RunConfig(name="t4", storage_path=str(tmp_path)), **cfg)
    r1 = t1.fit()
    t2 = DataParallelTrainer(
        _resume_fn,
        run_config=RunConfig(name="t4b", storage_path=str(tmp_path)),
        resume_from_checkpoint=r1.checkpoint,
        train_loop_config={"until": 4, "ckpt_root": str(tmp_path)},
        scaling_config=cfg["scaling_config"])
    r2 = t2.fit()
    assert r2.metrics["resumed_from"] == 2
    assert r2.metrics["step"] == 3


def test_elastic_scaling_fits_available_resources(cluster, tmp_path):
    """min_workers elastic range (reference elastic ScalingPolicy): an
    oversized ask starts at cluster capacity instead of hanging;
    world_size reflects the resize."""

    def train_fn(config):
        from ray_tpu_torch.train import session

        ctx = session.get_context()
        session.report({"world": ctx.world_size, "rank": ctx.rank})

    logic = TrainControllerLogic(
        train_fn, {},
        ScalingConfig(num_workers=32, min_workers=1, use_gpu=False,
                      resources_per_worker={"CPU": 1}),
        RunConfig(name="elastic", storage_path=str(tmp_path)))
    result = logic.run()
    assert result["state"] == "FINISHED", result["error"]
    world = result["metrics"]["world"]
    # an 8-CPU cluster cannot hold 32 single-CPU workers: elastic fits
    # the group to capacity instead of hanging on an impossible ask
    assert 1 <= world <= 8, world
    assert logic.current_world_size == world


class _Head:
    """A client whose head reports `free` CPUs available."""

    def __init__(self, free):
        self.free = free

    def head_request(self, method, **kw):
        assert method == "cluster_info"
        return {"available_resources": {"CPU": float(self.free)}}


class _Rows:
    """A callable-class UDF: an actor-pool stage."""

    def __call__(self, batch):
        return batch


@pytest.mark.parametrize("actors", [0, 2])
@pytest.mark.parametrize("free", [2, 4, 9])
def test_elastic_sizing_keeps_a_cpu_for_the_datasets(tmp_path, free, actors):
    """A run fed by datasets sizes its gang one CPU short of the free
    CPUs: each worker's pipeline runs its stages as tasks, and a gang
    holding every CPU would starve them (the run would hang). A 2 -> 1
    shrink onto a surviving node of 2 free CPUs restarts at 1. The count
    comes from the plan: an actor-pool stage (`concurrency` actors a
    worker) adds nothing, since an actor asks 0 CPUs."""
    scaling = ScalingConfig(num_workers=8, min_workers=1, use_gpu=False,
                            resources_per_worker={"CPU": 1})
    run = RunConfig(name="fit", storage_path=str(tmp_path))
    ds = rdata.range(8)
    if actors:
        ds = ds.map_batches(_Rows, concurrency=actors)
    plain = TrainControllerLogic(lambda: None, None, scaling, run)
    fed = TrainControllerLogic(lambda: None, None, scaling, run,
                               datasets={"train": ds})
    for logic in (plain, fed):
        logic._client = lambda: _Head(free)
    assert plain._capacity_fit() == min(free, 8)
    assert fed._capacity_fit() == min(free - 1, 8)
    assert fed._elastic_size() == min(free - 1, 8)


# ---------------------------------- the mirror of test_train_e2e's trainer
def test_spmd_trainer_e2e(cluster, tmp_path):
    trainer = SpmdTrainer(
        loops.gpt2_e2e_loop,
        train_loop_config={"steps": 4, "ckpt_root": str(tmp_path)},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False,
                                     resources_per_worker={"CPU": 4}),
        run_config=RunConfig(name="gpt2-e2e", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.error is None
    # training makes progress: final loss below the first
    assert result.metrics["loss"] < result.metrics["first_loss"]
    assert result.checkpoint is not None
    wte = np.load(os.path.join(result.checkpoint.path, "wte.npy"))
    assert wte.ndim == 2 and np.isfinite(wte).all()


def test_spmd_trainer_restart_after_worker_kill(cluster, tmp_path):
    marker = str(tmp_path / "killed_once")

    def loop(config):
        if not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            os.kill(os.getpid(), 9)  # induced host failure
        train.report({"recovered": True})

    trainer = SpmdTrainer(
        loop,
        train_loop_config={"marker": marker},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False,
                                     resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name="gpt2-ft", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=2)),
    )
    result = trainer.fit()
    assert result.metrics["recovered"] is True
    assert result.restarts >= 1


# ------------------------- the mirror of the reference test_torch_trainer
def _ddp_loop(config):
    import torch
    import torch.distributed as dist
    import torch.nn as nn

    from ray_tpu_torch.train import session as sess
    from ray_tpu_torch.train.torch_trainer import (
        maybe_init_torch_distributed, prepare_model)

    maybe_init_torch_distributed()
    torch.manual_seed(0)
    model = prepare_model(nn.Linear(4, 1))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    gen = torch.Generator().manual_seed(dist.get_rank())
    losses = []
    for step in range(config["steps"]):
        x = torch.randn(16, 4, generator=gen)
        y = x.sum(dim=1, keepdim=True)
        loss = ((model(x) - y) ** 2).mean()
        opt.zero_grad()
        loss.backward()   # DDP allreduces grads here
        opt.step()
        losses.append(float(loss))
    w = [p.detach().clone() for p in model.parameters()]
    sess.report({"first_loss": losses[0], "last_loss": losses[-1],
                 "w0": float(w[0].sum()), "rank": dist.get_rank(),
                 "world": dist.get_world_size(),
                 "device": str(w[0].device)})


def test_torch_trainer_ddp(cluster):
    trainer = TorchTrainer(
        _ddp_loop, train_loop_config={"steps": 30},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="torch-ddp"))
    result = trainer.fit()
    m = result.metrics
    assert m["world"] == 2
    assert m["device"] == "cpu"   # a worker without a GPU trains on the CPU
    assert m["last_loss"] < m["first_loss"] * 0.5, m


def test_torch_trainer_weights_synced(cluster):
    """Both ranks see different data but identical weights after DDP —
    the gradient allreduce is real."""
    def loop(config=None):
        import torch
        import torch.distributed as dist
        import torch.nn as nn

        from ray_tpu_torch.train import session as sess
        from ray_tpu_torch.train.torch_trainer import (
            maybe_init_torch_distributed, prepare_model)

        maybe_init_torch_distributed()
        torch.manual_seed(0)
        model = prepare_model(nn.Linear(3, 1))
        opt = torch.optim.SGD(model.parameters(), lr=0.05)
        gen = torch.Generator().manual_seed(100 + dist.get_rank())
        for _ in range(10):
            x = torch.randn(8, 3, generator=gen)
            loss = (model(x) ** 2).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
        flat = torch.cat([p.detach().flatten()
                          for p in model.parameters()])
        gathered = [torch.zeros_like(flat)
                    for _ in range(dist.get_world_size())]
        dist.all_gather(gathered, flat)
        synced = all(torch.allclose(gathered[0], g) for g in gathered)
        sess.report({"wsum": float(flat.sum()), "synced": bool(synced),
                     "rank": dist.get_rank()})

    trainer = TorchTrainer(loop, scaling_config=ScalingConfig(
        num_workers=2, use_gpu=False), run_config=RunConfig(name="torch-sync"))
    result = trainer.fit()
    # each rank saw DIFFERENT data; identical weights on all ranks proves
    # DDP's gradient allreduce actually ran
    assert result.metrics["synced"] is True, result.metrics


# ---------------------------------------------- the whole slice against JAX
B, T, STEPS = 8, 32, 4
CFG = dict(attn_impl="flash", remat=True, remat_policy="dots")
OPT = dict(lr=1e-3, warmup=2, total_steps=20)


def _corpus():
    toks = np.random.default_rng(5).integers(0, 512, (B * 6, T + 1))
    return {"tokens": toks.astype(np.int64)}


def _pipeline(rd):
    """The corpus through one package's data library: a cast in a task
    stage, then a seeded shuffle. The UDF is defined here so it ships by
    value."""
    return (rd.from_numpy(_corpus(), parallelism=4)
            .map_batches(lambda b: {"tokens": b["tokens"].astype(np.int32)})
            .random_shuffle(seed=3))


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX package's trajectory: its own DatasetShard over its Dataset
    feeding its compile_gpt2_train on a one-device mesh, in this process
    (no JAX runtime). Returns (initial numpy params, [(loss, grad_norm)],
    [batch rows])."""
    import jax
    import jax.numpy as jnp

    from ray_tpu import data as jdata
    from ray_tpu.models import gpt2 as J
    from ray_tpu.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu.train import spmd as JS
    from ray_tpu.train.ingest import DatasetShard

    cfg = J.GPT2Config.preset("gpt2-tiny", dtype=jnp.float32, **CFG)
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    prog = JS.compile_gpt2_train(cfg, mesh,
                                 optimizer=JS.default_optimizer(**OPT))
    state = prog.init_fn(jax.random.key(0))
    params0 = {"/".join(str(getattr(k, "key", k)) for k in kp): np.array(v)
               for kp, v in jax.tree_util.tree_flatten_with_path(
                   state.params)[0]}
    hist, rows = [], []
    for gi, batch in DatasetShard(_pipeline(jdata), 0, 1).iter_global_batches(
            batch_size=B):
        if gi >= STEPS:
            break
        state, m = prog.step_fn(state, {"tokens": jnp.asarray(
            batch["tokens"])})
        hist.append((float(m["loss"]), float(m["grad_norm"])))
        rows.append(batch["tokens"].tolist())
    return params0, hist, rows


class _Keeping(TrainControllerLogic):
    """The controller, keeping every rank's reports as it drains them."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.reports = {}

    def _drain(self, statuses, group):
        for rank, st in enumerate(statuses):
            self.reports.setdefault(rank, []).extend(
                r["metrics"] for r in st["reports"])
        return super()._drain(statuses, group)


@pytest.fixture(scope="module")
def port_runs(cluster, jax_reference, tmp_path_factory):
    """The port's SPMD trainer at world 1 and world 2 from the JAX
    package's initial params: {world: {rank: [reports]}}."""
    runs = {}
    for world in (1, 2):
        logic = _Keeping(
            loops.gpt2_dataset_loop,
            {"cfg": CFG, "opt": OPT, "params": jax_reference[0],
             "batch": B, "steps": STEPS},
            ScalingConfig(num_workers=world, use_gpu=False,
                          resources_per_worker={"CPU": 1}),
            RunConfig(name=f"slice-w{world}", storage_path=str(
                tmp_path_factory.mktemp(f"w{world}"))),
            backend=train.SpmdBackend(),
            datasets={"train": _pipeline(rdata)})
        out = logic.run()
        assert out["state"] == "FINISHED", out["error"]
        assert out["final_world_size"] == world
        runs[world] = logic.reports
    return runs


def test_spmd_trainer_world1_matches_jax_package(jax_reference, port_runs):
    _, want, want_rows = jax_reference
    got = port_runs[1][0]
    assert [r["step"] for r in got] == list(range(STEPS))
    assert [r["rows"] for r in got] == want_rows     # the same batches
    for r, (loss, norm) in zip(got, want):
        np.testing.assert_allclose(r["loss"], loss, **TOL)
        np.testing.assert_allclose(r["grad_norm"], norm, **TOL)


def test_spmd_trainer_world2_matches_world1(port_runs):
    one = port_runs[1][0]
    per = B // 2
    for rank in (0, 1):
        got = port_runs[2][rank]
        assert [r["world"] for r in got] == [2] * STEPS
        for r, ref in zip(got, one):
            # each rank's rows are its window of the same global batch
            assert r["rows"] == ref["rows"][rank * per:(rank + 1) * per]
            np.testing.assert_allclose(r["loss"], ref["loss"], **TOL)
            np.testing.assert_allclose(r["grad_norm"], ref["grad_norm"],
                                       **TOL)


def test_two_workers_of_a_node_get_local_ranks_0_and_1(port_runs):
    first = {rank: reps[0] for rank, reps in port_runs[2].items()}
    assert first[0]["pid"] != first[1]["pid"]
    assert [first[r]["local_rank"] for r in (0, 1)] == [0, 1]
    assert [first[r]["env_local_rank"] for r in (0, 1)] == ["0", "1"]
    # no GPU asked for: each worker's device is the CPU
    assert [first[r]["device"] for r in (0, 1)] == ["cpu", "cpu"]
    # the JAX package's worker group gives every rank local rank 0


@pytest.mark.parametrize("nodes,want", [
    (["a"], [0]), (["a", "a"], [0, 1]), (["a", "b"], [0, 0]),
    (["a", "b", "a", "a", "b"], [0, 0, 1, 2, 1])])
def test_local_ranks_count_each_node_separately(nodes, want):
    assert local_ranks(nodes) == want


@pytest.mark.parametrize("kw,devices,backend", [
    (dict(), ["cuda:0", "cuda:1"], "nccl"),
    (dict(gpus_per_worker=2), ["cuda:0", "cuda:2"], "nccl"),
    (dict(use_gpu=False), ["cpu", "cpu"], "gloo")])
def test_worker_env_names_each_workers_card(cluster, tmp_path, kw, devices,
                                            backend):
    """The env the group writes for two workers of one node: by default a
    card each, a worker of two cards on the first of its own, and the CPU
    only where the config asks for it. The loop reads the env and touches
    no card."""
    out = TrainControllerLogic(
        loops.env_loop, None, ScalingConfig(num_workers=2, **kw),
        RunConfig(name="env", storage_path=str(tmp_path)),
        backend=train.SpmdBackend()).run()
    assert out["state"] == "FINISHED", out["error"]
    got = [out["all_rank_metrics"][r] for r in (0, 1)]
    assert [g["device"] for g in got] == devices
    assert [g["local_rank"] for g in got] == ["0", "1"]
    assert [g["backend"] for g in got] == [backend, backend]


def test_prepare_model_without_a_worker_runs_on_the_card(monkeypatch):
    """Outside a worker `prepare_model` takes the port's default device,
    the card, and raises where there is none; a worker's env names its
    device."""
    import torch

    from ray_tpu_torch.train.torch_trainer import prepare_model
    from ray_tpu_torch.train.worker_group import WORKER_DEVICE_ENV

    monkeypatch.delenv(WORKER_DEVICE_ENV, raising=False)
    monkeypatch.delenv("RAY_TPU_TORCH_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_model(torch.nn.Linear(2, 1))
    monkeypatch.setenv(WORKER_DEVICE_ENV, "cpu")
    model = prepare_model(torch.nn.Linear(2, 1))
    assert next(model.parameters()).device == torch.device("cpu")


def test_shipped_loop_is_loaded_only_where_it_runs(tmp_path):
    """`fit()` hands the controller the loop as a `ShippedLoop`: a process
    that deserializes it imports nothing of the loop's (here torch) until
    `load()`, which the workers call."""
    import subprocess
    import sys

    import torch

    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.train.worker_group import ShippedLoop

    blob = tmp_path / "loop"
    blob.write_bytes(serialization.dumps(ShippedLoop(
        lambda: torch.zeros(3))))
    code = ("import sys\n"
            "from ray_tpu_torch.core import serialization as s\n"
            "shipped = s.loads(open(sys.argv[1], 'rb').read())\n"
            "print('torch' in sys.modules)\n"
            "shape = tuple(shipped.load()().shape)\n"
            "print('torch' in sys.modules, shape)\n")
    out = subprocess.run(
        [sys.executable, "-c", code, str(blob)], capture_output=True,
        text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["False", "True (3,)"], out.stdout


def _status(reports, error=None):
    return {"reports": reports, "done": False, "error": error,
            "generation": 0}


def _rep(step, path=None):
    return {"metrics": {"step": step}, "checkpoint_path": path}


def test_checkpoint_commits_once_every_rank_reported(tmp_path):
    """Rank 0's checkpoint of step k enters the run's storage only when
    every rank has reported step k: a peer that dies before its report
    leaves the run to resume from the step before, not past its half of
    the batch. A clean finish commits what is left."""
    logic = TrainControllerLogic(
        lambda: None, None, ScalingConfig(num_workers=2, use_gpu=False),
        RunConfig(name="barrier", storage_path=str(tmp_path / "run")))
    group = type("G", (), {"generation": 0})()
    paths = []
    for step in range(3):
        d = tmp_path / f"ck{step}"
        d.mkdir()
        (d / "step").write_text(str(step))
        paths.append(str(d))

    def latest():
        ck = logic.ckpt_manager.latest_checkpoint()
        return None if ck is None else int(open(
            os.path.join(ck.path, "step")).read())

    logic._new_group_reports(2)
    logic._drain([_status([_rep(0, paths[0]), _rep(1, paths[1])]),
                  _status([])], group)
    assert latest() is None          # rank 1 has reported nothing
    logic._drain([_status([]), _status([_rep(0)])], group)
    assert latest() == 0
    err = logic._drain([_status([]), _status([], error="rank 1 died")],
                       group)
    assert err == "rank 1 died" and latest() == 0   # step 1 never commits
    logic._new_group_reports(2)      # the next group resumes from step 0
    logic._drain([_status([_rep(1), _rep(2, paths[2])]),
                  _status([_rep(1)])], group)
    assert latest() == 0
    logic._commit(None)              # every rank finished cleanly
    assert latest() == 2


# ------------------------------------- the kv grad sync against the JAX one
class _PairKV:
    """A two-member kv group in one process: each member's allreduce adds
    the other's posted buffer, as the head-KV group sums the members'."""

    posted = {}

    def __init__(self, rank):
        self.rank = rank

    def allreduce(self, arr, timeout=None):
        _PairKV.posted[self.rank] = np.array(arr)
        if len(_PairKV.posted) == 2:
            arr[...] = _PairKV.posted[0] + _PairKV.posted[1]
        return arr


def test_kv_grad_sync_equals_jax_package(monkeypatch):
    """`cross_worker_grad_sync` over a `kv` group (no device path) averages
    as the JAX package's does: one fused f32 host buffer, bit for bit,
    each leaf back in its own dtype."""
    import jax.numpy as jnp
    import torch

    from ray_tpu.train import spmd as JS
    from ray_tpu.util import collective as JC
    from ray_tpu_torch.train import spmd as PS
    from ray_tpu_torch.util import collective as PC

    rng = np.random.default_rng(4)
    trees = [{"b": rng.normal(size=(3,)).astype(np.float32),
              "w": {"k": rng.normal(size=(4, 5)).astype(np.float32)}}
             for _ in range(2)]
    # each package's get_group hands back the member that is calling;
    # rank 1 posts first, so rank 0's call sees the sum
    for mod in (JC, PC):
        monkeypatch.setattr(mod, "get_group", lambda name: group)
    got = {}
    for pkg, sync, wrap in (("jax", JS.cross_worker_grad_sync, jnp.asarray),
                            ("port", PS.cross_worker_grad_sync,
                             torch.from_numpy)):
        _PairKV.posted = {}
        out = None
        for rank in (1, 0):
            group = _PairKV(rank)
            tree = {"b": wrap(trees[rank]["b"]),
                    "w": {"k": wrap(trees[rank]["w"]["k"])}}
            out = sync(tree, "ddp:g0", 2)
        got[pkg] = {"b": np.asarray(out["b"]), "k": np.asarray(out["w"]["k"])}
    assert got["port"]["k"].dtype == np.float32
    for k in ("b", "k"):
        assert got["port"][k].tobytes() == got["jax"][k].tobytes(), k


# ------------------------------------------------------- GPU asks, topology
@pytest.mark.parametrize("kw,want", [
    (dict(), {"GPU": 1.0}),
    (dict(use_gpu=False), {"CPU": 1.0}),
    (dict(gpus_per_worker=2), {"GPU": 2.0}),
    (dict(resources_per_worker={"CPU": 4}), {"CPU": 4, "GPU": 1.0}),
    (dict(use_gpu=False, resources_per_worker={"CPU": 2}), {"CPU": 2})])
def test_scaling_config_asks_gpus(kw, want):
    assert ScalingConfig(**kw).worker_resources() == want


def test_tpu_topology_is_refused(tmp_path):
    logic = TrainControllerLogic(
        lambda: None, None, ScalingConfig(num_workers=4, topology="v5e-16"),
        RunConfig(name="slice", storage_path=str(tmp_path)))
    with pytest.raises(NotImplementedError, match="ROADMAP item 21"):
        logic.run()
