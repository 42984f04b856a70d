"""The port's CLI against a cluster it starts itself.

`python -m ray_tpu_torch.scripts.cli start --head`, then `start
--address` for a node daemon (both with `--num-gpus 0`), `status` (both
nodes listed), `summary`, `timeline`, `stack`, and `stop`, which must
leave no process of the cluster and no `rtpt_*` segment of its session.
Every command runs with its own TMPDIR, so the state directory (the saved
address, the record `stop` reads) is this test's alone.
"""

import glob
import json
import os
import subprocess
import sys
import time

from ray_tpu_torch.cluster_utils import _descendants, _session_pids
from ray_tpu_torch.core.store import SHM_PREFIX

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(tmp_path, *args, timeout=90):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAY_TPU_")}
    env["TMPDIR"] = str(tmp_path)
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", *args],
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=str(tmp_path))
    assert out.returncode == 0, (args, out.stdout, out.stderr[-2000:])
    return out.stdout


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_cli_start_status_summary_timeline_stack_stop(tmp_path):
    out = _cli(tmp_path, "start", "--head", "--num-cpus", "1",
               "--num-gpus", "0")
    addr = out.split("started head at ", 1)[1].split()[0]
    assert "ray-tpu://" in out  # the client proxy's address for remotes
    pids = []
    session = None
    try:
        out = _cli(tmp_path, "start", f"--address={addr}", "--num-cpus",
                   "1", "--num-gpus", "0", "--labels", '{"zone": "cli"}')
        assert "node daemon started" in out
        state = os.path.join(str(tmp_path), "ray_tpu_torch_state")
        rows = [json.loads(ln) for ln in
                open(os.path.join(state, "cli_processes"))]
        pids = [r["pid"] for r in rows]
        session = next(r["session"] for r in rows if r["session"])
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            status = _cli(tmp_path, "status")  # the saved address
            if "nodes:    2" in status:
                break
            time.sleep(0.3)
        assert "nodes:    2" in status, status
        assert "CPU: 2/2 available" in status, status
        assert "GPU" not in status

        summary = json.loads(_cli(tmp_path, "summary"))
        assert set(summary) == {"tasks", "actors", "objects"}
        trace = tmp_path / "trace.json"
        out = _cli(tmp_path, "timeline", "--output", str(trace),
                   "--format", "chrome")
        assert "trace events" in out
        assert "traceEvents" in json.loads(trace.read_text())
        # a worker to dump: a task run by a driver of this cluster
        drv = subprocess.run(
            [sys.executable, "-c",
             "import ray_tpu_torch as rt; rt.init(address=%r); "
             "print(rt.get(rt.remote(lambda: 7).remote(), timeout=60))"
             % addr],
            capture_output=True, text=True, timeout=90,
            env={**os.environ, "PYTHONPATH": REPO}, cwd=str(tmp_path))
        assert drv.stdout.strip() == "7", drv.stderr[-2000:]
        stacks = _cli(tmp_path, "stack")
        assert "===== worker" in stacks
        assert "Thread" in stacks or "File" in stacks, stacks[:2000]
        for pid in list(pids):
            pids += _descendants(pid)
        assert len(pids) >= 3  # the head, the daemon, at least a worker
    finally:
        out = _cli(tmp_path, "stop")
    assert "stopped 2 process(es)" in out, out
    deadline = time.monotonic() + 15
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert [p for p in pids if _alive(p)] == []
    assert _session_pids(session) == []
    assert glob.glob(f"/dev/shm/{SHM_PREFIX}*{session[:8]}*") == []
    assert "nothing to stop" in _cli(tmp_path, "stop")
