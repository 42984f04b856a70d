"""Central config registry (reference `ray_config_def.h` table).

The port's mirror of `tests/test_config.py`, case for case, against
`ray_tpu_torch` (GPUs counted by `num_gpus` where the JAX package counts
`num_tpu_chips`).

Every tunable lives in ONE table with typed env parsing, introspection,
and head-negotiated distribution: a client whose env diverges from the
head on a negotiated flag adopts the HEAD's value at registration.
"""

import os
import subprocess
import sys

import pytest

import ray_tpu_torch
from ray_tpu_torch.core import config as cfg


def test_table_covers_the_scattered_env_vars():
    envs = {f.env for f in cfg.FLAGS}
    # flags once read ad hoc across the code must be in the table
    for must in ("RAY_TPU_REFCOUNT", "RAY_TPU_EVICT_GRACE_S",
                 "RAY_TPU_LEASE_IDLE_S", "RAY_TPU_TRANSFER_CHUNK_BYTES",
                 "RAY_TPU_OBJECT_STORE_BYTES", "RAY_TPU_MEMORY_MONITOR",
                 "RAY_TPU_LOG_TO_DRIVER", "RAY_TPU_DATA_MEMORY_BUDGET_BYTES"):
        assert must in envs, must
    assert len(cfg.FLAGS) >= 30
    # every flag documented and typed
    for f in cfg.FLAGS:
        assert f.doc and f.type in (bool, int, float, str), f


def test_typed_env_parsing(monkeypatch):
    c = cfg.Config()
    assert c.get("lease_idle_s") == 1.0
    assert c.source("lease_idle_s") == "default"
    monkeypatch.setenv("RAY_TPU_LEASE_IDLE_S", "2.5")
    assert c.get("lease_idle_s") == 2.5
    assert c.source("lease_idle_s") == "env"
    monkeypatch.setenv("RAY_TPU_REFCOUNT", "0")
    assert c.get("refcount") is False
    monkeypatch.setenv("RAY_TPU_LEASE_IDLE_S", "garbage")
    assert c.get("lease_idle_s") == 1.0  # unparseable -> default, not crash
    c.set("lease_idle_s", 9.0)
    assert c.get("lease_idle_s") == 9.0
    assert c.source("lease_idle_s") == "override"
    with pytest.raises(KeyError):
        c.set("not_a_flag", 1)


def test_negotiated_adoption(monkeypatch):
    c = cfg.Config()
    c.adopt_head({"refcount": False, "evict_grace_s": 3.5})
    assert c.get("refcount") is False
    assert c.get("evict_grace_s") == 3.5
    assert c.source("refcount") == "head"  # honest provenance
    # negotiated: head beats LOCAL ENV (divergence is never silent)...
    monkeypatch.setenv("RAY_TPU_REFCOUNT", "1")
    assert c.get("refcount") is False
    # ...but an explicit in-process set() beats the head
    c.set("refcount", True)
    assert c.get("refcount") is True
    assert c.source("refcount") == "override"
    rows = {r["name"]: r for r in c.dump()}
    assert rows["refcount"]["negotiated"] is True
    assert rows["lease_idle_s"]["negotiated"] is False


def test_head_distributes_negotiated_flags_to_divergent_client(tmp_path):
    """A client process whose env says refcount=1 adopts the external
    head's refcount=0: the refcount negotiation, now via the
    registry (and evict_grace_s rides the same mechanism)."""
    from ray_tpu_torch.core.resources import strip_device_env

    head_env = strip_device_env(dict(os.environ))
    head_env["RAY_TPU_REFCOUNT"] = "0"
    head_env["RAY_TPU_EVICT_GRACE_S"] = "4.5"
    head = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.core.head_main",
         "--session", f"cfg{os.getpid()}", "--num-cpus", "2",
         "--no-dashboard", "--no-client-proxy"],
        stdout=subprocess.PIPE, text=True, env=head_env)
    try:
        line = head.stdout.readline()
        assert line.startswith("RAY_TPU_HEAD_PORT="), line
        port = int(line.strip().split("=")[1])
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        script = tmp_path / "drv.py"
        script.write_text(f"""
import sys
sys.path.insert(0, {repo!r})
import os
os.environ["RAY_TPU_REFCOUNT"] = "1"   # divergent local env
import ray_tpu_torch
ray_tpu_torch.init(address="127.0.0.1:{port}")
from ray_tpu_torch.core import config
from ray_tpu_torch.core.api import _global_client
assert config.get("refcount") is False, config.get("refcount")
assert config.get("evict_grace_s") == 4.5
assert _global_client().ref_tracker.enabled is False
print("NEGOTIATED-OK")
ray_tpu_torch.shutdown()
""")
        out = subprocess.run([sys.executable, str(script)],
                             env=dict(os.environ), capture_output=True,
                             text=True, timeout=180)
        assert "NEGOTIATED-OK" in out.stdout, out.stderr
    finally:
        head.terminate()   # the port's head then unlinks its arena
        head.wait()


def test_cli_and_head_rpc_expose_config(tmp_path):
    try:
        ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_workers=2)
        from ray_tpu_torch.core.api import _global_client

        rows = _global_client().head_request("get_config")
        names = {r["name"] for r in rows}
        assert "evict_grace_s" in names and "refcount" in names
        c = _global_client()
        env = dict(os.environ)
        env["RAY_TPU_ADDRESS"] = f"{c.head_host}:{c.head_port}"
        out = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "config"],
            capture_output=True, text=True, timeout=120, env=env)
        assert out.returncode == 0, out.stderr
        assert "evict_grace_s" in out.stdout
    finally:
        ray_tpu_torch.shutdown()
