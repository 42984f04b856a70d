"""Node resource detection, GPUs as first-class resources.

Counterpart of `ray_tpu/core/resources.py`, which counts TPU chips. Here the
"GPU" resource is counted where the JAX package counts "TPU": a config
override first, then `CUDA_VISIBLE_DEVICES`, then the driver's own count
through NVML (what nvidia-smi and torch read; asked in a child interpreter,
so the head maps no driver library). A host without NVML has no usable
driver, so it counts no GPU: a scan of `/dev/nvidia[0-9]*` is no substitute,
since a container's /dev may hold the node of a card it cannot use.
Detection runs in the head (and later in node daemons), so it never imports
torch and never opens a CUDA context: NVML is not CUDA.

The core assigns no device ids to tasks or actors, as the JAX package's
assigns no chips: a `num_gpus=1` actor sees every card of its node and
picks one itself. Only Serve replicas pin devices, through
`set_visible_devices`. The TPU pod metadata (GCE metadata server, `TPU_*`
env) has no counterpart on a GPU host; the node labels come from the config
alone, so label selectors work the same.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from ray_tpu_torch.core import config as _config


def _count_visible(value: str) -> int:
    """Devices named by a CUDA_VISIBLE_DEVICES value. CUDA stops at the
    first entry it cannot use (an empty string hides every device; "-1"
    hides everything after it), so count up to the first invalid one."""
    n = 0
    for part in value.split(","):
        part = part.strip()
        if not part or part.startswith("-"):
            break
        n += 1
    return n


_NVML_PROBE = """
import ctypes
lib = ctypes.CDLL("libnvidia-ml.so.1")
n = ctypes.c_uint(0)
ok = lib.nvmlInit_v2() == 0 and lib.nvmlDeviceGetCount_v2(ctypes.byref(n)) == 0
print(n.value if ok else -1)
"""


def _nvml_count() -> Optional[int]:
    """The cards NVML lists, or None without NVML. Counted in a child
    interpreter (started without site packages), so the head never maps
    the driver's libraries itself."""
    import subprocess
    import sys

    try:
        out = subprocess.run([sys.executable, "-S", "-c", _NVML_PROBE],
                             capture_output=True, text=True, timeout=30)
        n = int(out.stdout.strip()) if out.returncode == 0 else -1
    except (OSError, ValueError, subprocess.SubprocessError):
        return None
    return n if n >= 0 else None


def detect_num_gpus() -> int:
    """Count locally attached GPUs without initializing CUDA: explicit
    config override first, CUDA_VISIBLE_DEVICES next, NVML's count last
    (0 without NVML)."""
    override = _config.get("num_gpus")
    if override >= 0:
        return override
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return _count_visible(visible)
    return _nvml_count() or 0


def node_resources(num_cpus: Optional[float] = None,
                   num_gpus: Optional[int] = None,
                   custom: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    res: Dict[str, float] = {}
    res["CPU"] = float(num_cpus if num_cpus is not None else (os.cpu_count() or 1))
    gpus = num_gpus if num_gpus is not None else detect_num_gpus()
    if gpus:
        res["GPU"] = float(gpus)
    if custom:
        res.update(custom)
    return res


def node_labels() -> Dict[str, str]:
    """The JAX package's slice labels, from the config alone (a GPU host
    has no pod metadata to read them from)."""
    labels: Dict[str, str] = {}
    if (name := _config.get("slice_name")):
        labels["ray.io/tpu-slice-name"] = name
    if (pod := _config.get("pod_type")):
        labels["ray.io/tpu-pod-type"] = pod
    labels["ray.io/tpu-worker-id"] = str(int(_config.get("worker_id") or 0))
    return labels


def strip_device_env(env: Dict[str, str]) -> Dict[str, str]:
    """Env for control-plane child processes. torch opens no device at
    import, so unlike the JAX package's copy (which forces JAX_PLATFORMS=cpu)
    nothing device-related needs scrubbing: only the package path."""
    return with_package_path(env)


def with_package_path(env: Dict[str, str]) -> Dict[str, str]:
    """Child processes must be able to `import ray_tpu_torch` regardless of
    cwd."""
    import ray_tpu_torch

    pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(
        ray_tpu_torch.__file__)))
    parts = env.get("PYTHONPATH", "").split(os.pathsep) if env.get("PYTHONPATH") else []
    if pkg_parent not in parts:
        env = dict(env)
        env["PYTHONPATH"] = os.pathsep.join([pkg_parent] + parts)
    return env


def set_visible_devices(device_ids) -> None:
    """Restrict this process to a subset of local GPUs (Serve replica
    pinning, the counterpart of `set_visible_chips`). Takes effect only
    before this process first initializes CUDA."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(str(d) for d in device_ids)
