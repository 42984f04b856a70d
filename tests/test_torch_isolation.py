"""The port imports neither JAX nor anything of the JAX package.

In a fresh interpreter, import every module of ray_tpu_torch and chip_smoke
(as a module: its main() does not run), then look at sys.modules. The
runtime's control plane (head, worker, client, API), the compiled DAGs
(`ray_tpu_torch.dag`), the serve control plane (`ray_tpu_torch.serve`:
controller, proxy, router, handle, api, autoscaling, batching, multiplex,
live signals, the compiled ingress chain and the gRPC proxy), the data
plane (`ray_tpu_torch.data`) and the trainer's control plane
(`ray_tpu_torch.train`: config, checkpoint, ingest, session, worker group,
controller, trainer, torch_trainer) and Tune (`ray_tpu_torch.tune`: search,
searcher, schedulers, the BayesOpt, BOHB, Optuna and HyperOpt searchers,
tuner; a trial's trainable imports torch in the trial) import no torch
either, nor grpc (the gRPC proxy imports it when it starts), and the
processes the runtime starts run the port's own modules.
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
             or m == "ray_tpu" or m.startswith("ray_tpu.")
             or m == "ml_dtypes" or m.startswith("ml_dtypes."))
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
                 "ray_tpu_torch.models.llama", "ray_tpu_torch.models.moe",
                 "ray_tpu_torch.serve.llm", "ray_tpu_torch.serve.kv_cache",
                 "ray_tpu_torch.serve.prefix_store",
                 "ray_tpu_torch.serve.compiled_chain",
                 "ray_tpu_torch.utils.platform", "ray_tpu_torch.utils.fs",
                 "ray_tpu_torch.utils.tree", "ray_tpu_torch.train",
                 "ray_tpu_torch.train.spmd", "ray_tpu_torch.parallel.mesh",
                 "ray_tpu_torch.util.collective",
                 "ray_tpu_torch.util.collective.types",
                 "ray_tpu_torch.util.collective._comm",
                 "ray_tpu_torch.util.collective.hierarchy",
                 "ray_tpu_torch.util.collective.quantize",
                 "ray_tpu_torch.util.collective.reshard",
                 "ray_tpu_torch.util.collective.local_group",
                 "ray_tpu_torch.util.collective.dist_group",
                 "ray_tpu_torch.util.collective.collective",
                 "ray_tpu_torch.ops.ring_attention",
                 "ray_tpu_torch.parallel.pipeline",
                 "ray_tpu_torch.train.checkpoint",
                 "ray_tpu_torch.train.config", "chip_smoke",
                 *CORE, *DAG, *SERVE_PLANE, *DATA, *TRAIN_PLANE, *TUNE,
                 *RLLIB,
                 "ray_tpu_torch.util",
                 "ray_tpu_torch.util.metrics",
                 "ray_tpu_torch.util.tracing", "ray_tpu_torch.scripts.cli"):
        assert want in res["imported"]


# every module of the runtime (its `__main__` guards keep the imports free
# of side effects)
CORE = tuple(f"ray_tpu_torch.core.{m}" for m in (
    "api", "client", "config", "device_store", "device_transport",
    "exceptions", "flight_recorder",
    "function_manager", "gcs", "head_main", "ids", "job_manager",
    "memory_monitor", "native_store", "object_directory", "object_ref",
    "object_transfer", "placement_group", "protocol", "refcount",
    "resource_view", "resources", "runtime_env", "serialization", "store",
    "worker_logs", "worker_main", "workload_watchdog"))

# the compiled DAGs (its modules import no torch either)
DAG = ("ray_tpu_torch.dag", *(f"ray_tpu_torch.dag.{m}" for m in (
    "channel", "nodes", "runtime", "compiled")))

# the serve control plane (none of it imports torch; only the user's
# callable inside a replica does)
SERVE_PLANE = ("ray_tpu_torch.serve", *(f"ray_tpu_torch.serve.{m}" for m in (
    "api", "autoscaling", "batching", "build_app", "compiled_chain",
    "controller", "grpc_proxy", "handle", "live_signals", "multiplex",
    "proxy", "replica")))

# the streaming data plane (host-side numpy; `iter_torch_batches` imports
# torch when it is called)
DATA = ("ray_tpu_torch.data", *(f"ray_tpu_torch.data.{m}" for m in (
    "block", "preprocessors", "shuffle", "executor", "dataset",
    "read_api")))

# the trainer's control plane (the loop, the backends' joins and `spmd`
# import torch; these modules do not)
TRAIN_PLANE = ("ray_tpu_torch.train", *(f"ray_tpu_torch.train.{m}" for m in (
    "config", "checkpoint", "ingest", "session", "worker_group",
    "controller", "trainer", "torch_trainer")))

# Tune (framework-neutral, as the JAX package's imports no JAX)
TUNE = ("ray_tpu_torch.tune", *(f"ray_tpu_torch.tune.{m}" for m in (
    "search", "searcher", "schedulers", "bayesopt_search", "bohb_search",
    "optuna_search", "hyperopt_search", "tuner")))

# RLlib's core and PPO (they import torch)
RLLIB = ("ray_tpu_torch.rllib", *(f"ray_tpu_torch.rllib.{m}" for m in (
    "connectors", "core.rl_module", "core.learner", "core.replay",
    "env.envs", "env.env_runner", "env.env_runner_group",
    "algorithms.algorithm_config", "algorithms.algorithm",
    "algorithms.ppo")))

CONTROL_PLANE_PROBE = r"""
import json, sys
for name in ("ray_tpu_torch.core.gcs", "ray_tpu_torch.core.head_main",
             "ray_tpu_torch.core.worker_main", "ray_tpu_torch.core.client",
             "ray_tpu_torch.core.api", "ray_tpu_torch.util.metrics",
             "ray_tpu_torch.util.tracing", "ray_tpu_torch.utils.platform",
             "ray_tpu_torch.dag", "ray_tpu_torch.dag.channel",
             "ray_tpu_torch.dag.nodes", "ray_tpu_torch.dag.runtime",
             "ray_tpu_torch.dag.compiled", *SERVE_PLANE, *DATA,
             *TRAIN_PLANE, *TUNE):
    __import__(name)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("torch", "jax", "ray_tpu",
                                               "grpc"))))
"""


def test_control_plane_imports_no_torch():
    import json

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c",
                          f"SERVE_PLANE = {SERVE_PLANE!r}\n"
                          f"DATA = {DATA!r}\nTRAIN_PLANE = {TRAIN_PLANE!r}\n"
                          f"TUNE = {TUNE!r}\n"
                          + CONTROL_PLANE_PROBE],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_runtime_processes_run_the_port():
    """A task's worker has neither ray_tpu nor jax loaded and runs
    ray_tpu_torch.core.worker_main; the head's command line names
    ray_tpu_torch.core.head_main."""
    import ray_tpu_torch
    from ray_tpu_torch.core import api

    def probe():
        import sys as _sys

        main = _sys.modules["__main__"]
        return (sorted(m for m in _sys.modules
                       if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu")),
                getattr(main.__spec__, "name", None),
                [m for m in _sys.modules if m.split(".")[0] == "torch"][:1])

    try:
        ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_workers=2)
        with open(f"/proc/{api._head_proc.pid}/cmdline", "rb") as f:
            head_argv = f.read().split(b"\0")
        bad, main, torch_mods = ray_tpu_torch.get(
            ray_tpu_torch.remote(probe).remote(), timeout=120)
    finally:
        ray_tpu_torch.shutdown()
    assert b"ray_tpu_torch.core.head_main" in head_argv, head_argv
    assert bad == []
    assert main == "ray_tpu_torch.core.worker_main"
    # a task that never touched torch runs in a worker that never imported it
    assert torch_mods == []
