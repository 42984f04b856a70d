"""The port imports neither JAX nor anything of the JAX package.

In a fresh interpreter, import every module of ray_tpu_torch and chip_smoke
(as a module: its main() does not run), then look at sys.modules.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
import ray_tpu_torch
names = ["ray_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    ray_tpu_torch.__path__, "ray_tpu_torch.")] + ["chip_smoke"]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "ray_tpu" or m.startswith("ray_tpu."))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_ray_tpu():
    import json

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [], res["bad"]
    for want in ("ray_tpu_torch.ops.flash_attention",
                 "ray_tpu_torch.ops._kernels", "ray_tpu_torch.models.gpt2",
                 "ray_tpu_torch.serve.llm", "ray_tpu_torch.serve.kv_cache",
                 "ray_tpu_torch.utils.platform", "ray_tpu_torch.train",
                 "ray_tpu_torch.train.spmd", "chip_smoke"):
        assert want in res["imported"]
