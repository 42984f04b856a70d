"""User-visible error types (capability parity with ray.exceptions)."""

from __future__ import annotations


class RayTpuError(Exception):
    """Base for all framework errors."""


class TaskError(RayTpuError):
    """A task/actor method raised. Carries the remote traceback; re-raised at
    every `get` on the result (and propagated through dependent tasks)."""

    def __init__(self, cause_repr: str, traceback_str: str = ""):
        super().__init__(f"task raised {cause_repr}\n{traceback_str}")
        self.cause_repr = cause_repr
        self.traceback_str = traceback_str


class WorkerCrashedError(RayTpuError):
    """The worker executing the task died (OOM-killed, segfault, kill -9)."""


class ActorDiedError(RayTpuError):
    """The actor is dead (crashed with no restarts left, or killed)."""


class ActorUnavailableError(RayTpuError):
    """The actor is temporarily unreachable (restarting)."""


class ObjectLostError(RayTpuError):
    """Object data is gone and cannot be recovered (owner died)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """`get(timeout=...)` expired."""


class RuntimeEnvSetupError(RayTpuError):
    """Preparing a worker's runtime environment failed."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled via ray_tpu.cancel (reference TaskCancelledError)."""
