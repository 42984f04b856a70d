"""Train loops the port's trainer tests run in their workers.

They live here, away from the test modules, because a test module that
imports JAX would be imported by every worker that unpickles one of its
functions by reference. This module imports neither JAX nor the JAX
package, and torch only inside the loops.
"""

import json
import os
import tempfile
import time


def _as_global(rows, prog):
    """This rank's rows of a global batch as the step takes them: the
    rows themselves on one device; on a `build_mesh` mesh a DTensor whose
    local shard they are, placed by the program's `batch_sharding`."""
    import torch

    t = torch.from_numpy(rows)
    if prog.batch_sharding is None:
        return t
    from torch.distributed.tensor import DTensor

    mesh, placements = prog.batch_sharding
    return DTensor.from_local(t, mesh, placements)


def gpt2_dataset_loop(config):
    """gpt2-tiny (f32, CPU) trained from numpy weights on the global batches
    of the "train" dataset shard: one process a device, a dp mesh over the
    gang when it has two or more workers. Reports each step's loss and
    grad norm, the batch's rows and this worker's placement."""
    import numpy as np
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.train import spmd

    torch.set_num_threads(1)
    joined = train.maybe_init_distributed()
    ctx = train.get_context()
    world = ctx.get_world_size()
    cfg = gpt2.GPT2Config.preset("gpt2-tiny", dtype=torch.float32,
                                 **config["cfg"])
    mesh = (build_mesh(MeshConfig(dp=world), device_type="cpu") if joined
            else None)
    opt = spmd.default_optimizer(**config["opt"])
    prog = spmd.compile_gpt2_train(cfg, mesh=mesh, optimizer=opt,
                                   device="cpu")
    params = gpt2.params_from_numpy(config["params"], cfg, device="cpu")
    if mesh is not None:
        from ray_tpu_torch.parallel.mesh import use_mesh

        with use_mesh(mesh):
            specs = gpt2.param_specs(cfg)
        params = spmd.shard_params(params, mesh, specs)
    state = spmd.TrainState(0, params, opt.init(params))
    shard = train.get_dataset_shard("train")
    for gi, batch in shard.iter_global_batches(
            batch_size=config["batch"]):
        if gi >= config["steps"]:
            break
        rows = np.array(batch["tokens"])     # a writable copy
        state, m = prog.step_fn(state, {"tokens": _as_global(rows, prog)})
        train.report({
            "step": gi, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]), "rows": rows.tolist(),
            "rank": ctx.get_world_rank(), "world": world,
            "local_rank": ctx.get_local_rank(),
            "env_local_rank": os.environ.get("LOCAL_RANK"),
            "device": os.environ.get("RAY_TPU_TRAIN_DEVICE"),
            "pid": os.getpid()})


def env_loop(config=None):
    """Reports the env the worker group wrote: the worker's device, its
    LOCAL_RANK and the process group's backend."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train.worker_group import WORKER_DEVICE_ENV

    train.report({"device": os.environ.get(WORKER_DEVICE_ENV),
                  "local_rank": os.environ.get("LOCAL_RANK"),
                  "backend": os.environ.get("RAY_TPU_TORCH_BACKEND")})


def gpt2_e2e_loop(config):
    """The JAX package's e2e loop on the port: gpt2-tiny (vocab 256, T 32)
    on one device, a fixed batch, rank 0 checkpoints wte at the last
    step under `config["ckpt_root"]`."""
    import numpy as np
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import Checkpoint
    from ray_tpu_torch.train.spmd import (compile_gpt2_train,
                                          default_optimizer)

    ctx = train.get_context()
    cfg = gpt2.GPT2Config.preset("gpt2-tiny", vocab_size=256, max_seq_len=32)
    prog = compile_gpt2_train(cfg, optimizer=default_optimizer(
        total_steps=10), device="cpu")
    state = prog.init_fn(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (8, 17), dtype=np.int32)
    losses = []
    for step in range(config["steps"]):
        state, metrics = prog.step_fn(state, {"tokens": tokens})
        losses.append(float(metrics["loss"]))
        ckpt = None
        if step == config["steps"] - 1 and ctx.get_world_rank() == 0:
            d = tempfile.mkdtemp(dir=config["ckpt_root"])
            np.save(os.path.join(d, "wte.npy"),
                    state.params["wte"].detach().float().numpy())
            ckpt = Checkpoint(d)
        train.report({"loss": losses[-1], "step": step,
                      "first_loss": losses[0]}, checkpoint=ckpt)


def elastic_ddp_loop(config):
    """GPT-2 DDP across the worker gang (the JAX package's elastic loop):
    one device a worker, gradients averaged across workers through the kv
    collective (a generation-scoped group), a sharded checkpoint every
    step under `config["ckpt_root"]`, the restore resharded to whatever
    world size the controller scheduled."""
    import numpy as np
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import Checkpoint
    from ray_tpu_torch.train.spmd import (compile_gpt2_train,
                                          cross_worker_grad_sync,
                                          default_optimizer,
                                          restore_state_sharded,
                                          save_state_sharded)
    from ray_tpu_torch.util import collective

    torch.set_num_threads(1)
    ctx = train.get_context()
    world, rank = ctx.get_world_size(), ctx.get_world_rank()
    gen = ctx.get_generation()
    cfg = gpt2.GPT2Config.preset(
        "gpt2-tiny", vocab_size=128, max_seq_len=16,
        n_layer=1, n_head=2, d_model=32, d_ff=64)
    prog = compile_gpt2_train(
        cfg, optimizer=default_optimizer(lr=1e-2, warmup=1,
                                         total_steps=config["steps"]),
        device="cpu")
    ck = ctx.get_checkpoint()
    if ck is not None:
        state = restore_state_sharded(ck.as_directory(), prog)
        start = int(state.step)
    else:
        state = prog.init_fn(torch.Generator().manual_seed(0))
        start = 0
    group = None
    if world > 1:
        # membership-scoped rendezvous: a fenced gang's stale keys can
        # never collide with this generation's
        group = f"ddp:{config['run']}:g{gen}"
        collective.rebuild_collective_group(world, rank, backend="kv",
                                            group_name=group)
    # a fixed batch a rank (memorization): the loss descends steadily, so
    # "the curve continues after the restore" is a real assertion
    rng = np.random.default_rng(rank)
    tokens = rng.integers(0, cfg.vocab_size, (4, 17), dtype=np.int32)
    for step in range(start, config["steps"]):
        loss, grads = prog.grad_fn(state, {"tokens": tokens})
        if world > 1:
            grads = cross_worker_grad_sync(grads, group, world)
        state = prog.apply_fn(state, grads)
        ckpt = None
        if rank == 0:
            d = tempfile.mkdtemp(prefix="elastic_ckpt_",
                                 dir=config["ckpt_root"])
            save_state_sharded(state, d, world_size=world)
            ckpt = Checkpoint(d)
            with open(config["history"], "a") as f:
                f.write(json.dumps({
                    "gen": gen, "step": step, "world": world,
                    "loss": float(loss), "ts": time.time()}) + "\n")
        train.report({"loss": float(loss), "step": step, "world": world,
                      "gen": gen}, checkpoint=ckpt)
        # pacing: give the capacity watcher a realistic window between
        # checkpoint boundaries (real steps aren't sub-millisecond)
        time.sleep(config.get("step_s", 0.0))
