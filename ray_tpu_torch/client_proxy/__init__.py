"""Remote driver proxy ("Ray Client" equivalent).

A laptop/CI process connects to one multiplexed TCP port on the head node
(`ray_tpu_torch.init(address="ray-tpu://host:port")`) and drives the cluster —
tasks, actors, get/put/wait, KV, state API — without reachability to any
other port (workers, data servers, shm). Reference:
`python/ray/util/client/` (proxy + server-side driver model).
"""

from ray_tpu_torch.client_proxy.client import ProxyClient  # noqa: F401
from ray_tpu_torch.client_proxy.server import ClientProxyServer  # noqa: F401
