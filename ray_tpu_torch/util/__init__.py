"""Parity namespace for the reference's `ray.util` surface (counterpart of
`ray_tpu/util/__init__.py`). The placement-group API loads on first use, so
`import ray_tpu_torch.util.collective` does not pull in the core runtime."""

__all__ = ["PlacementGroup", "placement_group", "remove_placement_group"]


def __getattr__(name):
    if name in __all__:
        from ray_tpu_torch.core import placement_group as _pg

        return getattr(_pg, name)
    raise AttributeError(
        f"module 'ray_tpu_torch.util' has no attribute {name!r}")
