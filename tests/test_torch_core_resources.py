"""GPUs as a resource in the port's runtime.

Detection (`core.resources.detect_num_gpus`): the config override, then
CUDA_VISIBLE_DEVICES, then NVML (no NVML, no GPU), all without torch. A task
asking for more GPUs than the cluster has behaves as the JAX package's does
for TPU chips beyond its cluster's: it stays queued, never runs on the CPU
instead, and can be cancelled there.
"""

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.core.exceptions import GetTimeoutError as JTimeout
from ray_tpu.core.exceptions import TaskCancelledError as JCancelled
from ray_tpu_torch.core import resources as R
from ray_tpu_torch.core.exceptions import GetTimeoutError, TaskCancelledError


@pytest.mark.parametrize("visible,count", [
    ("0", 1), ("0,1,2,3", 4), ("", 0), ("2,-1,3", 1), ("GPU-abc,GPU-def", 2),
    (" 1 , 0 ", 2)])
def test_cuda_visible_devices_counts(monkeypatch, visible, count):
    monkeypatch.delenv("RAY_TPU_NUM_GPUS", raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    monkeypatch.setattr(R, "_nvml_count", lambda: 8)   # never consulted
    assert R.detect_num_gpus() == count


def test_detection_order(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(R, "_nvml_count", lambda: None)
    assert R.detect_num_gpus() == 0          # no NVML: no GPU
    monkeypatch.setattr(R, "_nvml_count", lambda: 1)
    assert R.detect_num_gpus() == 1          # NVML's count
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2")
    assert R.detect_num_gpus() == 3          # the env before NVML
    monkeypatch.setenv("RAY_TPU_NUM_GPUS", "5")
    assert R.detect_num_gpus() == 5          # the override first
    assert R.node_resources(2, None) == {"CPU": 2.0, "GPU": 5.0}
    assert R.node_resources(2, 0) == {"CPU": 2.0}


def test_set_visible_devices(monkeypatch):
    import os

    monkeypatch.delenv("RAY_TPU_NUM_GPUS", raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")   # restored afterwards
    R.set_visible_devices([3, 1])
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "3,1"
    assert R.detect_num_gpus() == 2


def test_node_labels_from_config(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SLICE_NAME", "s0")
    monkeypatch.setenv("RAY_TPU_POD_TYPE", "h100-8")
    monkeypatch.setenv("RAY_TPU_WORKER_ID", "3")
    assert R.node_labels() == {"ray.io/tpu-slice-name": "s0",
                               "ray.io/tpu-pod-type": "h100-8",
                               "ray.io/tpu-worker-id": "3"}
    monkeypatch.delenv("RAY_TPU_WORKER_ID")
    assert R.node_labels()["ray.io/tpu-worker-id"] == "0"


def _beyond(pkg, key, have, timeout_cls, cancelled_cls):
    """A task asking for have+1 devices on a cluster of `have`: it times
    out queued, cancels as queued, and a task asking for `have` runs."""
    out = {}
    try:
        pkg.init(num_cpus=2, max_workers=2, **{key: have})
        out["resources"] = {k: v for k, v in pkg.cluster_resources().items()
                            if k != "CPU"}

        @pkg.remote(**{key: have + 1})
        def greedy():
            return "ran"

        ref = greedy.remote()
        try:
            pkg.get(ref, timeout=0.5)
            out["queued"] = False
        except timeout_cls:
            out["queued"] = True
        out["cancel"] = pkg.cancel(ref)
        try:
            pkg.get(ref, timeout=10)
        except cancelled_cls:
            out["cancelled"] = True
        if have:
            @pkg.remote(**{key: have})
            def fits():
                return "ran"

            out["fits"] = pkg.get(fits.remote(), timeout=60)
    finally:
        pkg.shutdown()
    return out


@pytest.mark.parametrize("have", [0, 1])
def test_gpus_beyond_the_cluster_stay_queued_as_tpu_chips_do(have):
    got = _beyond(ray_tpu_torch, "num_gpus", have, GetTimeoutError,
                  TaskCancelledError)
    want = _beyond(ray_tpu, "num_tpu_chips", have, JTimeout, JCancelled)
    assert got["resources"] == ({"GPU": float(have)} if have else {})
    assert want["resources"] == ({"TPU": float(have)} if have else {})
    got.pop("resources"), want.pop("resources")
    assert got == want
    assert got["queued"] and got["cancel"] == "cancelled_queued"
