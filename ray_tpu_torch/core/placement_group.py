"""Placement groups: reserve resource bundles, run work inside the reservation.

Capability parity with `python/ray/util/placement_group.py` +
`gcs_placement_group_mgr`/2-phase bundle commit (single-node round: the
reservation is atomic against one node's ledger; multi-node prepare/commit
lands with the multi-node scheduler). Tasks/actors submitted with
`placement_group=pg` draw from the reservation instead of the free pool —
the TPU use case is gang-reserving a slice's chips ahead of SPMD training.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch.core.ids import PlacementGroupID


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]],
                 strategy: str, name: str = ""):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        # creation-time state from the head's create_pg reply: when the
        # reservation committed synchronously (the common case), the first
        # ready() needs no second round trip. One-shot — a later ready()
        # re-verifies with the head (bundles can unplace on node death).
        self._created_state: Optional[str] = None

    def ready(self, timeout: Optional[float] = None) -> bool:
        from ray_tpu_torch.core.api import _global_client

        if self._created_state == "CREATED":
            self._created_state = None
            return True
        try:
            reply = _global_client().head_request(
                "wait_pg", pg_id=self.id.binary(), timeout=timeout)
        except TimeoutError:
            return False  # the head did not answer in time
        return reply["state"] == "CREATED"

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundles, self.strategy, self.name))

    def __repr__(self):
        return f"PlacementGroup({self.id.hex()[:12]}, {self.strategy}, {self.bundles})"


VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "") -> PlacementGroup:
    from ray_tpu_torch.core.api import _auto_init, _global_client

    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"invalid strategy {strategy!r}; one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    _auto_init()
    pg_id = PlacementGroupID.generate()
    reply = _global_client().head_request(
        "create_pg", pg_id=pg_id.binary(),
        bundles=[{k: float(v) for k, v in b.items()} for b in bundles],
        strategy=strategy, name=name)
    pg = PlacementGroup(pg_id, bundles, strategy, name)
    if isinstance(reply, dict):
        pg._created_state = reply.get("state")
    return pg


def remove_placement_group(pg: PlacementGroup) -> None:
    """Fire-and-forget removal: the head needs no reply, and same-client
    ordering (a subsequent create_pg reusing the freed resources) is
    guaranteed by per-connection FIFO."""
    from ray_tpu_torch.core.api import _global_client

    _global_client().head_push("remove_pg", pg_id=pg.id.binary())
