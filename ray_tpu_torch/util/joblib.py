"""joblib backend running jobs as cluster tasks.

Capability-equivalent of the reference's `ray.util.joblib`
(`python/ray/util/joblib/__init__.py` + `ray_backend.py`): register a
parallel backend named "ray_tpu_torch" so `joblib.Parallel` (and scikit-learn's
`with parallel_backend(...)`) fans out across the cluster.
"""

from __future__ import annotations

import ray_tpu_torch

_registered = False


def register_ray() -> None:
    """Register the "ray_tpu_torch" joblib backend (idempotent)."""
    global _registered
    if _registered:
        return
    from joblib.parallel import register_parallel_backend
    register_parallel_backend("ray_tpu_torch", _RayTpuBackend)
    _registered = True


def _make_backend():
    from joblib._parallel_backends import MultiprocessingBackend

    class _RayTpuBackend(MultiprocessingBackend):
        """joblib backend whose pool is ray_tpu_torch.util.multiprocessing.Pool."""

        supports_timeout = True

        def effective_n_jobs(self, n_jobs):
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init()
            eff = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
            if n_jobs and n_jobs > 0:
                eff = min(eff, n_jobs)
            return max(1, eff)

        def configure(self, n_jobs=1, parallel=None, prefer=None,
                      require=None, **kwargs):
            n_jobs = self.effective_n_jobs(n_jobs)
            from ray_tpu_torch.util.multiprocessing import Pool
            self._pool = Pool(processes=n_jobs)
            self.parallel = parallel
            return n_jobs

        def terminate(self):
            if getattr(self, "_pool", None) is not None:
                self._pool.terminate()
                self._pool = None

    return _RayTpuBackend


class _LazyBackend:
    """Defer the joblib import until the backend is actually constructed."""

    _cls = None

    def __new__(cls, *args, **kwargs):
        if cls._cls is None:
            cls._cls = _make_backend()
        return cls._cls(*args, **kwargs)


_RayTpuBackend = _LazyBackend
