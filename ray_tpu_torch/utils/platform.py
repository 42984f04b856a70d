"""Device selection and on-disk state for the port.

Counterpart of `ray_tpu/utils/platform.py`, which forces a virtual CPU mesh
for JAX. Here the rule is the other way round: the port's entry points run on
the GPU, and take the CPU only when the caller asks for it by name.

The runtime's control plane (the head, a worker before its first task)
imports this module for `STATE_DIR`, so torch is imported only inside
`default_device`.
"""

from __future__ import annotations

import os
import tempfile
from typing import TYPE_CHECKING, Optional, Union

if TYPE_CHECKING:
    import torch

# Root for all on-disk runtime state (job logs, runtime_env extractions,
# spill files, venvs), in the temp dir (TMPDIR) the processes inherit, so
# runs given temp dirs of their own never meet here. Its own directory,
# apart from the JAX package's ray_tpu_state, and deliberately NOT
# "ray_tpu_torch": a dir named like the package becomes an importable
# namespace package that shadows the real library for any script run from
# the temp dir.
STATE_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_state")


def default_device(device: Optional[Union[str, "torch.device"]] = None
                   ) -> "torch.device":
    """Resolve an entry point's ``device`` argument.

    ``None`` means CUDA, and raises when CUDA is not available: the port never
    carries on quietly on the CPU. ``"cpu"`` (or any explicit device) is taken
    as given.
    """
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: ray_tpu_torch runs on the GPU; pass device='cpu' "
            "to run on the CPU deliberately")
    return torch.device("cuda", torch.cuda.current_device())
