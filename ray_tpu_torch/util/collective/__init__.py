"""The port's collective layer (counterpart of `ray_tpu.util.collective`).

| JAX package module | here |
|---|---|
| `types.py` | `types.py` (`nccl`, `gloo` and `kv`) |
| `hierarchy.py` | `hierarchy.py` (functions over process subgroups) |
| `quantize.py` | `quantize.py` |
| `reshard.py` | `reshard.py` (onto `DTensor`s; import its functions from the module, whose name the package does not shadow) |
| `xla_group.py` (`XlaCollectiveGroup`) | `local_group.py` (`LocalCollectiveGroup`) |
| `xla_multihost.py` (`XlaMultihostGroup`) | `dist_group.py` (`DistCollectiveGroup`) |
| `collective.py` | `collective.py` |
| `kv_group.py` (`KVCollectiveGroup`) | `kv_group.py` (`backend="kv"`, over the runtime's head KV) |
"""

from ray_tpu_torch.util.collective.collective import (  # noqa: F401
    allgather, allreduce, barrier, broadcast, create_collective_group,
    destroy_collective_group, get_collective_group_size, get_group, get_rank,
    init_collective_group, is_group_initialized, rebuild_collective_group,
    recv, reduce, reducescatter, send, synchronize)
from ray_tpu_torch.util.collective.dist_group import (  # noqa: F401
    DistCollectiveGroup)
from ray_tpu_torch.util.collective.hierarchy import Topology  # noqa: F401
from ray_tpu_torch.util.collective.kv_group import (  # noqa: F401
    KVCollectiveGroup)
from ray_tpu_torch.util.collective.local_group import (  # noqa: F401
    LocalCollectiveGroup)
from ray_tpu_torch.util.collective.quantize import (  # noqa: F401
    QuantizedAllreduce)
from ray_tpu_torch.util.collective.reshard import (  # noqa: F401
    WindowedReader)
from ray_tpu_torch.util.collective.types import Backend, ReduceOp  # noqa: F401
