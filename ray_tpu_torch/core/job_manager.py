"""Job manager: runs submitted entrypoints as drivers on the cluster.

Parity: `python/ray/dashboard/modules/job/job_manager.py` — each submitted
job is a supervisor-managed driver subprocess with RAY_TPU_ADDRESS set so
`init()` joins this cluster; status transitions PENDING→RUNNING→
SUCCEEDED/FAILED/STOPPED; logs captured per job.
"""

from __future__ import annotations

import asyncio
import os
import signal
import time
import uuid
from typing import Dict, Optional

from ray_tpu_torch.utils.platform import STATE_DIR


class JobInfo:
    def __init__(self, job_id: str, entrypoint: str, metadata: Optional[dict]):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.metadata = metadata or {}
        self.status = "PENDING"
        self.message = ""
        self.start_time = time.time()
        self.end_time: Optional[float] = None
        self.proc: Optional[asyncio.subprocess.Process] = None
        self.log_path: Optional[str] = None

    def view(self) -> dict:
        return {"job_id": self.job_id, "entrypoint": self.entrypoint,
                "status": self.status, "message": self.message,
                "metadata": self.metadata, "start_time": self.start_time,
                "end_time": self.end_time, "log_path": self.log_path}


class JobManager:
    def __init__(self, session: str, head_port: int):
        self.session = session
        self.head_port = head_port
        self.jobs: Dict[str, JobInfo] = {}
        self.log_dir = os.path.join(STATE_DIR, session, "logs")
        os.makedirs(self.log_dir, exist_ok=True)

    async def submit(self, entrypoint: str, *, metadata: Optional[dict] = None,
                     env: Optional[dict] = None,
                     working_dir: Optional[str] = None,
                     job_id: Optional[str] = None) -> str:
        job_id = job_id or f"rtpu-{uuid.uuid4().hex[:10]}"
        if job_id in self.jobs:
            raise ValueError(f"job {job_id!r} already exists")
        info = JobInfo(job_id, entrypoint, metadata)
        info.log_path = os.path.join(self.log_dir, f"job-{job_id}.log")
        self.jobs[job_id] = info
        child_env = dict(os.environ)
        from ray_tpu_torch.core.resources import strip_device_env

        child_env = strip_device_env(child_env)
        child_env["RAY_TPU_ADDRESS"] = f"127.0.0.1:{self.head_port}"
        child_env["RAY_TPU_JOB_ID"] = job_id
        child_env.update(env or {})
        logf = open(info.log_path, "wb")
        try:
            info.proc = await asyncio.create_subprocess_shell(
                entrypoint, stdout=logf, stderr=asyncio.subprocess.STDOUT,
                cwd=working_dir or None, env=child_env,
                start_new_session=True)
        except Exception as e:
            info.status = "FAILED"
            info.message = f"failed to start: {e!r}"
            info.end_time = time.time()
            logf.close()
            return job_id
        info.status = "RUNNING"
        asyncio.ensure_future(self._watch(info, logf))
        return job_id

    async def _watch(self, info: JobInfo, logf) -> None:
        rc = await info.proc.wait()
        logf.close()
        info.end_time = time.time()
        if info.status == "STOPPED":
            return
        info.status = "SUCCEEDED" if rc == 0 else "FAILED"
        info.message = f"exit code {rc}"

    def stop(self, job_id: str) -> bool:
        info = self.jobs.get(job_id)
        if info is None or info.proc is None or info.status != "RUNNING":
            return False
        info.status = "STOPPED"
        info.message = "stopped by user"
        try:
            os.killpg(os.getpgid(info.proc.pid), signal.SIGTERM)
        except Exception:
            try:
                info.proc.terminate()
            except Exception:
                pass
        return True

    def get(self, job_id: str) -> Optional[dict]:
        info = self.jobs.get(job_id)
        return info.view() if info else None

    def list(self) -> list:
        return [i.view() for i in self.jobs.values()]

    def logs(self, job_id: str) -> str:
        info = self.jobs.get(job_id)
        if info is None or not info.log_path or not os.path.exists(info.log_path):
            return ""
        with open(info.log_path, "rb") as f:
            return f.read().decode(errors="replace")
