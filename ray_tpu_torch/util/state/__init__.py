"""State API: programmatic cluster introspection.

Parity: `python/ray/util/state/api.py` (`ray list tasks/actors/objects/...`,
summary APIs) backed by the head's live tables instead of a separate
dashboard StateHead process. Counterpart of `ray_tpu/util/state/`.
"""

from ray_tpu_torch.util.state.api import (
    get_actor, get_placement_group, list_actors, list_lease_events,
    list_nodes, list_objects, list_placement_groups, list_scheduler_stats,
    list_serve_stats, list_task_events, list_tasks, list_trace_spans,
    list_workers, list_workload_stats, subscribe, summarize_actors,
    summarize_objects, summarize_tasks)

__all__ = [
    "subscribe",
    "get_actor", "get_placement_group", "list_actors", "list_lease_events",
    "list_nodes",
    "list_objects", "list_placement_groups", "list_scheduler_stats",
    "list_serve_stats",
    "list_task_events", "list_tasks", "list_trace_spans",
    "list_workers", "list_workload_stats",
    "summarize_actors", "summarize_objects", "summarize_tasks",
]
