"""runtime_env: per-task/actor env vars, working_dir, py_modules.

Parity (core subset) with `python/ray/_private/runtime_env/` + the per-node
agent (`runtime_env_agent.py:165 GetOrCreateRuntimeEnv`): the driver
packages local directories into the cluster KV (content-addressed zips);
executing workers download + extract once per process and apply env vars /
sys.path / cwd around the user code. Supported keys: `env_vars` (dict),
`working_dir` (local dir path or previously-packaged URI), `py_modules`
(list of dir paths). conda/pip/container isolation is not reproducible
without network access and is intentionally out of scope (gated with a
clear error).
"""

from __future__ import annotations

import hashlib
import io
import os
import sys
import zipfile
from typing import Any, Dict, List, Optional

from ray_tpu_torch.utils.platform import STATE_DIR

_EXTRACT_CACHE: Dict[str, str] = {}   # uri -> extracted dir (per process)
_UNSUPPORTED = ("conda", "uv", "container", "image_uri", "java_jars")
_SUPPORTED = ("env_vars", "working_dir", "py_modules", "pip", "pip_key")


def _zip_dir(path: str, prefix: str = "") -> bytes:
    """prefix: entry-name prefix inside the zip — py_modules zips keep the
    module dir name so `import <basename>` works after extraction (Ray's
    documented py_modules semantics)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(path):
            dirs[:] = [d for d in dirs if d not in
                       ("__pycache__", ".git", ".venv", "node_modules")]
            for f in files:
                full = os.path.join(root, f)
                rel = os.path.relpath(full, path)
                zf.write(full, os.path.join(prefix, rel) if prefix else rel)
    return buf.getvalue()


def package_runtime_env(client, renv: Optional[dict]) -> Optional[dict]:
    """Driver side: normalize + upload dirs → content-addressed URIs."""
    if not renv:
        return None
    for key in _UNSUPPORTED:
        if renv.get(key):
            raise ValueError(
                f"runtime_env[{key!r}] is not supported in this offline "
                "build; ship dependencies via py_modules/working_dir")
    unknown = set(renv) - set(_SUPPORTED) - set(_UNSUPPORTED)
    if unknown:
        # a typo'd key silently vanishing means the task runs without the
        # intended environment — fail loudly instead
        raise ValueError(f"unknown runtime_env key(s): {sorted(unknown)}; "
                         f"supported: {list(_SUPPORTED)}")
    out: Dict[str, Any] = {}
    if renv.get("env_vars"):
        out["env_vars"] = {str(k): str(v) for k, v in renv["env_vars"].items()}

    def upload(path: str, prefix: str = "") -> str:
        if path.startswith("rtenv://"):
            return path
        if not os.path.isdir(path):
            raise ValueError(f"runtime_env dir {path!r} does not exist")
        data = _zip_dir(path, prefix)
        digest = hashlib.sha256(data).hexdigest()[:24]
        uri = f"rtenv://{digest}"
        # probe before shipping: re-uploading a multi-MB zip per call when
        # the head already has the digest is pure waste
        if not client.head_request("kv_keys", ns="_runtime_env",
                                   prefix=uri.encode()):
            client.head_request("kv_put", ns="_runtime_env",
                                key=uri.encode(), value=data, overwrite=False)
        return uri

    if renv.get("pip"):
        pip = renv["pip"]
        if isinstance(pip, dict):
            pip = pip.get("packages", [])
        pip = sorted(str(p) for p in pip)
        out["pip"] = pip
        out["pip_key"] = pip_env_key(pip)
    if renv.get("working_dir"):
        out["working_dir"] = upload(renv["working_dir"])
    if renv.get("py_modules"):
        # each entry is a MODULE directory; keep its name inside the zip so
        # `import <basename>` works on the worker
        out["py_modules"] = [
            upload(p, prefix=os.path.basename(os.path.normpath(p)))
            for p in renv["py_modules"]]
    return out or None


def pip_env_key(pip: List[str]) -> str:
    """Content address of a pip requirement set — the worker-pool routing
    key (reference: runtime env hash keying per-env worker pools,
    `worker_pool.h` per-runtime-env pools)."""
    import json

    return hashlib.sha256(
        json.dumps(sorted(pip)).encode()).hexdigest()[:16]


def materialize_venv(pip: List[str], key: Optional[str] = None) -> str:
    """Node side: build (or reuse) a content-addressed virtualenv with
    `pip` installed; returns its python executable. Parity with the
    reference's pip plugin (`python/ray/_private/runtime_env/pip.py` +
    `agent/runtime_env_agent.py:298 GetOrCreateRuntimeEnv`).

    The venv is created with --system-site-packages so the base image's
    torch/numpy stay visible; installed requirements shadow them. Offline
    clusters point pip at local wheels the standard way (PIP_NO_INDEX /
    PIP_FIND_LINKS env vars, which pip reads natively).

    Concurrency: first creator wins via atomic rename; losers reuse."""
    import shutil
    import subprocess

    key = key or pip_env_key(pip)
    root = os.path.join(STATE_DIR, "venvs")
    dest = os.path.join(root, key)
    python = os.path.join(dest, "bin", "python")
    marker = os.path.join(dest, ".rtpu_ready")
    if os.path.exists(marker):
        return python
    os.makedirs(root, exist_ok=True)
    tmp = dest + f".tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    subprocess.run([sys.executable, "-m", "venv", "--system-site-packages",
                    tmp], check=True, capture_output=True)
    # When THIS interpreter is itself a venv (common in container images),
    # --system-site-packages resolves to the BASE python's site dir, not
    # ours — torch/numpy/cloudpickle would vanish. Graft our site-packages
    # in via a .pth (processed after the venv's own dir, so installed
    # requirements still shadow the parent's versions).
    parent_sites = [p for p in sys.path
                    if p.endswith(("site-packages", "dist-packages"))
                    and os.path.isdir(p)]
    if parent_sites:
        vsite = os.path.join(
            tmp, "lib", f"python{sys.version_info[0]}.{sys.version_info[1]}",
            "site-packages")
        with open(os.path.join(vsite, "_rtpu_parent_env.pth"), "w") as f:
            f.write("\n".join(parent_sites) + "\n")
    if pip:
        proc = subprocess.run(
            [os.path.join(tmp, "bin", "python"), "-m", "pip", "install",
             "--no-input", "--disable-pip-version-check", *pip],
            capture_output=True, text=True)
        if proc.returncode != 0:
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError(
                f"pip install {pip} failed:\n{proc.stdout}{proc.stderr}")
    with open(os.path.join(tmp, ".rtpu_ready"), "w") as f:
        f.write(" ".join(pip))
    try:
        os.replace(tmp, dest)   # atomic publish; POSIX replaces empty only
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
        if not os.path.exists(marker):
            raise
    return python


def _fetch_extract(client, uri: str) -> str:
    """Worker side: download a packaged URI and extract (cached per proc)."""
    if uri in _EXTRACT_CACHE:
        return _EXTRACT_CACHE[uri]
    dest = os.path.join(STATE_DIR, client.session, "runtime_env",
                        uri.replace("rtenv://", ""))
    if not os.path.isdir(dest) or not os.listdir(dest):
        data = client.head_request("kv_get", ns="_runtime_env",
                                   key=uri.encode())
        if data is None:
            raise RuntimeError(f"runtime_env package {uri} missing from KV")
        tmp = dest + f".tmp{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        with zipfile.ZipFile(io.BytesIO(data)) as zf:
            zf.extractall(tmp)
        try:
            os.replace(tmp, dest)
        except OSError:
            # another worker won the race; use theirs
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
    _EXTRACT_CACHE[uri] = dest
    return dest


class AppliedEnv:
    """Worker side: apply a normalized runtime_env; .restore() undoes the
    env-var/cwd changes (sys.path additions persist for the process, as in
    the reference's dedicated-worker model)."""

    def __init__(self, client, renv: Optional[dict]):
        self._saved_env: Dict[str, Optional[str]] = {}
        self._saved_cwd: Optional[str] = None
        if not renv:
            return
        try:
            for uri in renv.get("py_modules") or []:
                path = _fetch_extract(client, uri)
                if path not in sys.path:
                    sys.path.insert(0, path)
            if renv.get("working_dir"):
                path = _fetch_extract(client, renv["working_dir"])
                if path not in sys.path:
                    sys.path.insert(0, path)
                self._saved_cwd = os.getcwd()
                os.chdir(path)
            for k, v in (renv.get("env_vars") or {}).items():
                self._saved_env[k] = os.environ.get(k)
                os.environ[k] = v
        except BaseException:
            # partial construction must not leak cwd/env onto the pooled
            # worker (e.g. a cancel async-exc landing mid-apply)
            self.restore()
            raise

    def restore(self) -> None:
        for k, old in self._saved_env.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        if self._saved_cwd is not None:
            try:
                os.chdir(self._saved_cwd)
            except OSError:
                pass
