"""Elastic fault tolerance of the port's trainer: a node daemon killed
mid-run, the gang shrunk to the surviving capacity and resumed from a
world-size-agnostic checkpoint, then grown back when a node rejoins.

The mirror of `tests/test_train_e2e.py`'s elastic drills on the port
(`ray_tpu_torch.train.controller`, `cluster_utils.Cluster`): GPT-2 (one
layer, d_model 32) trained by DDP over the worker gang, gradients averaged
through a generation-scoped kv collective group, a sharded checkpoint
(`spmd.save_state_sharded`) every step, the restore resharded by
`restore_state_sharded`. Each cluster is checked at teardown for leftover
processes and `rtpt_*` segments. The loop runs from
`tests/_torch_train_loops.py`.
"""

import json
import os
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.train import (ElasticConfig, FailureConfig, RunConfig,
                                 ScalingConfig)
from ray_tpu_torch.train.controller import TrainControllerLogic

import _torch_train_loops as loops


def _read_history(path):
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except ValueError:
                pass   # torn trailing line mid-append from the worker
    return out


def _start_elastic_cluster():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    cluster = Cluster(num_cpus=0)   # head schedules no train workers
    nids = [cluster.add_node(num_cpus=1), cluster.add_node(num_cpus=1)]
    cluster.connect()
    cluster.wait_for_nodes(3)
    return cluster, nids


def _stop(cluster):
    try:
        ray_tpu_torch.shutdown()
    finally:
        cluster.shutdown()
    assert cluster.processes() == [] and cluster.segments() == [], (
        cluster.processes(), cluster.segments())


def _run_controller_bg(tmp_path, run_name, steps, history, regrow,
                       step_s=0.0):
    logic = TrainControllerLogic(
        loops.elastic_ddp_loop,
        {"steps": steps, "run": run_name, "history": history,
         "step_s": step_s, "ckpt_root": str(tmp_path)},
        ScalingConfig(
            num_workers=2, min_workers=1, use_gpu=False,
            resources_per_worker={"CPU": 1},
            elastic=ElasticConfig(scale_up_check_interval_s=0.4,
                                  schedule_wait_s=30.0,
                                  regrow=regrow)),
        RunConfig(name=run_name, storage_path=str(tmp_path),
                  failure_config=FailureConfig(max_failures=3)))
    box = {}

    def _run():
        try:
            box["result"] = logic.run()
        except BaseException as e:   # surfaced by the test's join
            box["error"] = e

    t = threading.Thread(target=_run, daemon=True, name="train-controller")
    t.start()
    return logic, t, box


def _wait_history(history, pred, timeout, what):
    deadline = time.time() + timeout
    while time.time() < deadline:
        entries = _read_history(history)
        if pred(entries):
            return entries
        time.sleep(0.2)
    raise AssertionError(f"timed out waiting for {what}: "
                         f"{_read_history(history)[-5:]}")


@pytest.mark.chaos
def test_elastic_shrink_on_daemon_kill(tmp_path):
    """SIGKILL a node daemon mid-GPT-2-DDP run. The controller hears the
    death event, fences the gang, reshapes to the surviving capacity
    (2 -> 1), restores the latest checkpoint resharded to world size 1,
    and the run FINISHES at reduced size with the loss curve continuing
    within tolerance."""
    history = str(tmp_path / "history.jsonl")
    cluster, nids = _start_elastic_cluster()
    try:
        logic, t, box = _run_controller_bg(tmp_path, "shrink", 12, history,
                                           regrow=False, step_s=0.1)
        _wait_history(history, lambda es: any(
            e["world"] == 2 and e["step"] >= 3 for e in es),
            timeout=180, what="2-worker progress")
        pre = _read_history(history)
        cluster.kill_node(nids[1])
        t.join(timeout=240)
        assert not t.is_alive(), "controller never finished after kill"
        assert "error" not in box, box.get("error")
        result = box["result"]
        assert result["state"] == "FINISHED", result["error"]
        assert result["restarts"] >= 1
        assert result["final_world_size"] == 1
        entries = _read_history(history)
        post = [e for e in entries if e["gen"] >= 1]
        assert post, "no post-restore steps recorded"
        assert all(e["world"] == 1 for e in post)
        # resumed from a checkpoint, not from scratch, and the restored
        # stream advances monotonically
        post_steps = [e["step"] for e in post]
        assert post_steps == sorted(post_steps), post_steps
        assert post[0]["step"] >= 1, "restore rewound to step 0"
        # every step of the run is covered
        assert {e["step"] for e in entries} == set(range(12))
        # the loss curve continues within tolerance: the first
        # post-restore loss stays in family with the last pre-kill loss
        # and below the run's initial loss (no re-warmup from scratch)
        pre_last = [e for e in pre if e["gen"] == 0][-1]["loss"]
        first0 = entries[0]["loss"]
        assert post[0]["loss"] < first0, (post[0]["loss"], first0)
        assert post[0]["loss"] <= pre_last * 1.15 + 0.05, \
            (post[0]["loss"], pre_last)
    finally:
        _stop(cluster)


@pytest.mark.chaos
def test_elastic_regrow_on_rejoin(tmp_path):
    """After the shrink-on-kill recovery, a fresh node joins; the capacity
    watcher stops the 1-worker gang at the next checkpoint boundary and
    restarts it at the full 2-worker size."""
    history = str(tmp_path / "history.jsonl")
    cluster, nids = _start_elastic_cluster()
    try:
        logic, t, box = _run_controller_bg(tmp_path, "regrow", 24, history,
                                           regrow=True, step_s=0.3)
        _wait_history(history, lambda es: any(
            e["world"] == 2 and e["step"] >= 2 for e in es),
            timeout=180, what="2-worker progress")
        cluster.kill_node(nids[1])
        # the shrunken generation makes progress at world size 1
        _wait_history(history, lambda es: any(
            e["world"] == 1 for e in es), timeout=240,
            what="post-kill 1-worker progress")
        cluster.add_node(num_cpus=1)   # capacity returns
        t.join(timeout=420)
        assert not t.is_alive(), "controller never finished after rejoin"
        assert "error" not in box, box.get("error")
        result = box["result"]
        assert result["state"] == "FINISHED", result["error"]
        assert result["restarts"] >= 1, "kill never registered as failure"
        assert result["resizes"] >= 1, "capacity watcher never regrew"
        assert result["final_world_size"] == 2
        entries = _read_history(history)
        worlds = [e["world"] for e in entries]
        assert 1 in worlds and worlds[-1] == 2, worlds
        assert {e["step"] for e in entries} == set(range(24))
    finally:
        _stop(cluster)
