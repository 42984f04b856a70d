"""Declarative serve deploy in the port (`ray_tpu_torch.serve.build_app`, the
CLI's `serve deploy`/`status`/`shutdown`).

The mirror of `tests/test_serve_declarative.py`: a dict config and a YAML
file resolve import paths (a Deployment or a builder), apply per-deployment
overrides and run them behind the HTTP proxy. Beside it, the CLI against a
cluster it starts itself: `serve deploy <config.yaml>` from one process,
`serve status` from another (the controller outlives the deploying
driver), `serve shutdown`, then `stop` leaves no process and no `rtpt_*`
segment of the session.
"""

import glob
import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.cluster_utils import _session_pids
from ray_tpu_torch.core.store import SHM_PREFIX

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

APP = (
    "from ray_tpu_torch import serve\n"
    "@serve.deployment\n"
    "class Echo:\n"
    "    def __init__(self, prefix='e'):\n"
    "        self.prefix = prefix\n"
    "    def __call__(self, request):\n"
    "        return {'echo': self.prefix + str(request.get('v', ''))}\n"
    "app = Echo.bind()\n"
    "def builder(prefix='b'):\n"
    "    return Echo.bind(prefix=prefix)\n")


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_declarative_config_deploy(tmp_path):
    (tmp_path / "my_torch_serve_app.py").write_text(APP)
    sys.path.insert(0, str(tmp_path))
    try:
        ray_tpu_torch.init(num_cpus=8, num_gpus=0, max_workers=8)
        from ray_tpu_torch.serve.build_app import (deploy_config,
                                                   deploy_config_file)

        names = deploy_config({"applications": [
            {"name": "echo-app", "route_prefix": "/echo",
             "import_path": "my_torch_serve_app:app",
             "deployments": [{"name": "Echo", "num_replicas": 2}]},
            {"name": "built-app", "route_prefix": "/built",
             "import_path": "my_torch_serve_app:builder",
             "args": {"prefix": "custom-"}},
        ]})
        assert names == ["echo-app", "built-app"]
        assert serve.status()["echo-app"]["target"] == 2
        port = serve.start()
        assert _post(f"http://127.0.0.1:{port}/echo", {"v": "x"}) == \
            {"echo": "ex"}
        assert _post(f"http://127.0.0.1:{port}/built", {"v": "y"}) == \
            {"echo": "custom-y"}

        yml = tmp_path / "serve.yaml"
        yml.write_text(
            "applications:\n"
            "  - name: yaml-app\n"
            "    route_prefix: /yml\n"
            "    import_path: my_torch_serve_app:builder\n"
            "    args: {prefix: 'yml-'}\n")
        assert deploy_config_file(str(yml)) == ["yaml-app"]
        assert _post(f"http://127.0.0.1:{port}/yml", {"v": "z"}) == \
            {"echo": "yml-z"}

        with pytest.raises(ValueError, match="applications"):
            deploy_config({})
        with pytest.raises(ValueError, match="override names"):
            deploy_config({"applications": [
                {"import_path": "my_torch_serve_app:app",
                 "deployments": [{"name": "Other"}]}]})
        with pytest.raises(ValueError, match="module:attr"):
            deploy_config({"applications": [
                {"import_path": "my_torch_serve_app"}]})
    finally:
        sys.path.remove(str(tmp_path))
        # the JAX package's mirror imports a module of its own by path in
        # the same test process: leave no module of this name behind
        sys.modules.pop("my_torch_serve_app", None)
        serve.shutdown()
        ray_tpu_torch.shutdown()


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


def test_cli_serve_deploy_status_shutdown(tmp_path):
    (tmp_path / "my_torch_serve_app.py").write_text(APP)
    (tmp_path / "serve.yaml").write_text(
        "applications:\n"
        "  - name: cli-app\n"
        "    route_prefix: /cli\n"
        "    import_path: my_torch_serve_app:builder\n"
        "    args: {prefix: 'cli-'}\n")
    out = _cli(tmp_path, "start", "--head", "--num-cpus", "4",
               "--num-gpus", "0")
    state = os.path.join(str(tmp_path), "ray_tpu_torch_state")
    rows = [json.loads(ln) for ln in
            open(os.path.join(state, "cli_processes"))]
    session = next(r["session"] for r in rows if r["session"])
    try:
        out = _cli(tmp_path, "serve", "deploy", str(tmp_path / "serve.yaml"))
        assert out.startswith("deployed cli-app; http on 127.0.0.1:"), out
        port = int(out.rsplit(":", 1)[1])
        assert _post(f"http://127.0.0.1:{port}/cli", {"v": "q"}) == \
            {"echo": "cli-q"}
        status = json.loads(_cli(tmp_path, "serve", "status"))
        assert status["cli-app"]["running"] >= 1, status
        assert "serve shut down" in _cli(tmp_path, "serve", "shutdown")
        assert json.loads(_cli(tmp_path, "serve", "status")) == {}
    finally:
        _cli(tmp_path, "stop")
    deadline = time.monotonic() + 30
    while _session_pids(session) and time.monotonic() < deadline:
        time.sleep(0.2)
    assert _session_pids(session) == []
    assert glob.glob(f"/dev/shm/{SHM_PREFIX}*{session[:8]}*") == []
