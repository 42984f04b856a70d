"""Memory monitor / OOM killing policy tests.

The port's mirror of `tests/test_memory_monitor.py`, case for case, against
`ray_tpu_torch` (GPUs counted by `num_gpus` where the JAX package counts
`num_tpu_chips`).

Mirrors the reference's memory_monitor + retriable-FIFO worker-killing
policy tests: policy unit tests plus an end-to-end breach (synthetic
meminfo) where the killed retriable task re-queues and completes.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.core.memory_monitor import pick_victim, system_memory_fraction


def test_system_memory_fraction_reads_meminfo(tmp_path):
    p = tmp_path / "meminfo"
    p.write_text("MemTotal:       100 kB\nMemFree:        10 kB\n"
                 "MemAvailable:   25 kB\n")
    os.environ["RAY_TPU_MEMINFO_PATH"] = str(p)
    try:
        assert abs(system_memory_fraction() - 0.75) < 1e-9
    finally:
        del os.environ["RAY_TPU_MEMINFO_PATH"]
    assert 0.0 < system_memory_fraction() < 1.0  # real /proc/meminfo


def test_pick_victim_policy():
    mk = lambda i, ts, retriable, driver=False, actor=False: {
        "worker_id": i, "task_start_ts": ts, "retriable": retriable,
        "is_driver": driver, "has_actor": actor}
    # youngest retriable wins over older retriable and any non-retriable
    v = pick_victim([mk(1, 10, True), mk(2, 20, True), mk(3, 30, False)])
    assert v["worker_id"] == 2
    # no retriables: youngest non-retriable
    v = pick_victim([mk(1, 10, False), mk(2, 20, False)])
    assert v["worker_id"] == 2
    # drivers/actors/idle are never victims
    assert pick_victim([mk(1, 10, True, driver=True),
                        mk(2, 20, True, actor=True),
                        {"worker_id": 3, "task_start_ts": None,
                         "retriable": False, "is_driver": False,
                         "has_actor": False}]) is None


def test_oom_kill_end_to_end(tmp_path):
    """Synthetic meminfo flips to 99% usage while a retriable task runs:
    the monitor kills the worker, the task retries and completes."""
    meminfo = tmp_path / "meminfo"
    meminfo.write_text("MemTotal: 100 kB\nMemAvailable: 90 kB\n")
    os.environ["RAY_TPU_MEMINFO_PATH"] = str(meminfo)
    os.environ["RAY_TPU_MEMORY_USAGE_THRESHOLD"] = "0.95"
    os.environ["RAY_TPU_MEMORY_MONITOR_INTERVAL_S"] = "0.2"
    try:
        ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_workers=4)

        @ray_tpu_torch.remote(max_retries=3)
        def slow(marker_dir):
            # count executions via marker files
            import os as _os
            import time as _time

            n = len(_os.listdir(marker_dir))
            open(f"{marker_dir}/run{n}-{_os.getpid()}", "w").close()
            _time.sleep(2.0 if n == 0 else 0.1)  # first run lingers
            return n

        marker = tmp_path / "runs"
        marker.mkdir()
        ref = slow.remote(str(marker))
        deadline = time.monotonic() + 30
        while not os.listdir(marker):  # first execution underway
            assert time.monotonic() < deadline, "task never started"
            time.sleep(0.05)
        meminfo.write_text("MemTotal: 100 kB\nMemAvailable: 1 kB\n")  # 99%
        while len(os.listdir(marker)) < 2:  # killed, and retried
            assert time.monotonic() < deadline, "task never re-executed"
            time.sleep(0.05)
        meminfo.write_text("MemTotal: 100 kB\nMemAvailable: 90 kB\n")
        out = ray_tpu_torch.get(ref, timeout=60)
        assert out >= 1, "task was not re-executed after the OOM kill"
        assert len(os.listdir(marker)) >= 2
    finally:
        ray_tpu_torch.shutdown()
        for k in ("RAY_TPU_MEMINFO_PATH", "RAY_TPU_MEMORY_USAGE_THRESHOLD",
                  "RAY_TPU_MEMORY_MONITOR_INTERVAL_S"):
            os.environ.pop(k, None)
