"""Device selection for the port.

Counterpart of `ray_tpu/utils/platform.py`, which forces a virtual CPU mesh
for JAX. Here the rule is the other way round: the port's entry points run on
the GPU, and take the CPU only when the caller asks for it by name.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def default_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """Resolve an entry point's ``device`` argument.

    ``None`` means CUDA, and raises when CUDA is not available: the port never
    carries on quietly on the CPU. ``"cpu"`` (or any explicit device) is taken
    as given.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: ray_tpu_torch runs on the GPU; pass device='cpu' "
            "to run on the CPU deliberately")
    return torch.device("cuda", torch.cuda.current_device())
