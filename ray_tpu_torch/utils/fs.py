"""Pluggable filesystem layer: local paths plus any fsspec URI (counterpart
of `ray_tpu/utils/fs.py`, kept as the port's own copy).

Local paths bypass fsspec and use plain `open()`. Anything with a `://` goes
to `fsspec.core.url_to_fs`, imported only then: a host without fsspec serves
local paths all the same. `memory://` is per-process, so it suits
single-process tests only.
"""

from __future__ import annotations

import builtins
import os
import posixpath
from typing import List, Tuple

__all__ = [
    "is_uri", "resolve", "open", "exists", "isdir", "isfile", "makedirs",
    "listdir", "glob", "expand_paths", "join", "basename", "rm", "rmtree",
    "put_dir", "get_dir", "abspath",
]


def is_uri(path: str) -> bool:
    return "://" in str(path)


def resolve(path: str) -> Tuple[object, str]:
    """URI → (fsspec filesystem, path-inside-fs). Only call on URIs."""
    import fsspec

    return fsspec.core.url_to_fs(str(path))


def _unstrip(fs, inner: str) -> str:
    """fs-internal path → full URI (fsspec strips the scheme)."""
    return fs.unstrip_protocol(inner)


def abspath(path: str) -> str:
    """os.path.abspath for local paths; URIs pass through untouched."""
    return path if is_uri(path) else os.path.abspath(path)


def join(path: str, *parts: str) -> str:
    if is_uri(path):
        return posixpath.join(path, *parts)
    return os.path.join(path, *parts)


def basename(path: str) -> str:
    return posixpath.basename(str(path).rstrip("/"))


def open(path: str, mode: str = "rb", **kw):  # noqa: A001
    if not is_uri(path):
        return builtins.open(path, mode, **kw)
    fs, inner = resolve(path)
    return fs.open(inner, mode, **kw)


def exists(path: str) -> bool:
    if not is_uri(path):
        return os.path.exists(path)
    fs, inner = resolve(path)
    return fs.exists(inner)


def isdir(path: str) -> bool:
    if not is_uri(path):
        return os.path.isdir(path)
    fs, inner = resolve(path)
    return fs.isdir(inner)


def isfile(path: str) -> bool:
    if not is_uri(path):
        return os.path.isfile(path)
    fs, inner = resolve(path)
    return fs.isfile(inner)


def makedirs(path: str) -> None:
    if not is_uri(path):
        os.makedirs(path, exist_ok=True)
        return
    fs, inner = resolve(path)
    fs.makedirs(inner, exist_ok=True)


def listdir(path: str) -> List[str]:
    """Immediate children as full URIs/paths."""
    if not is_uri(path):
        return [os.path.join(path, n) for n in sorted(os.listdir(path))]
    fs, inner = resolve(path)
    return sorted(_unstrip(fs, p) for p in fs.ls(inner, detail=False))


def glob(pattern: str) -> List[str]:
    if not is_uri(pattern):
        import glob as glob_mod

        return sorted(glob_mod.glob(pattern))
    fs, inner = resolve(pattern)
    return sorted(_unstrip(fs, p) for p in fs.glob(inner))


def _list_files_recursive(path: str) -> List[str]:
    if not is_uri(path):
        import glob as glob_mod

        return sorted(
            f for f in glob_mod.glob(os.path.join(path, "**"), recursive=True)
            if os.path.isfile(f))
    fs, inner = resolve(path)
    return sorted(_unstrip(fs, p)
                  for p in fs.find(inner))


def expand_paths(paths) -> List[str]:
    """str|list of (file | dir | glob pattern) → concrete file list, local
    or remote, hidden files skipped for directory expansion (Data readers'
    shared path resolution)."""
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if isdir(p):
            out.extend(f for f in _list_files_recursive(p)
                       if not basename(f).startswith("."))
        elif any(c in p for c in "*?["):
            out.extend(glob(p))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths}")
    return out


def rm(path: str) -> None:
    if not is_uri(path):
        os.remove(path)
        return
    fs, inner = resolve(path)
    fs.rm(inner)


def rmtree(path: str, ignore_errors: bool = True) -> None:
    try:
        if not is_uri(path):
            import shutil

            shutil.rmtree(path, ignore_errors=ignore_errors)
            return
        fs, inner = resolve(path)
        fs.rm(inner, recursive=True)
    except Exception:
        if not ignore_errors:
            raise


def put_dir(local_dir: str, target: str) -> None:
    """Upload a local directory tree to `target` (URI or local path),
    preserving relative layout — the checkpoint upload primitive."""
    if not is_uri(target):
        import shutil

        if os.path.abspath(local_dir) != os.path.abspath(target):
            shutil.copytree(local_dir, target, dirs_exist_ok=True)
        return
    fs, inner = resolve(target)
    fs.makedirs(inner, exist_ok=True)
    base = os.path.abspath(local_dir)
    for root, _dirs, files in os.walk(base):
        for name in files:
            src = os.path.join(root, name)
            rel = os.path.relpath(src, base)
            fs.put_file(src, posixpath.join(inner, *rel.split(os.sep)))


def get_dir(source: str, local_dir: str) -> str:
    """Download `source` (URI or local path) into `local_dir`."""
    if not is_uri(source):
        import shutil

        if os.path.abspath(source) != os.path.abspath(local_dir):
            shutil.copytree(source, local_dir, dirs_exist_ok=True)
        return local_dir
    fs, inner = resolve(source)
    os.makedirs(local_dir, exist_ok=True)
    for remote in fs.find(inner):
        rel = posixpath.relpath(remote, inner)
        dst = os.path.join(local_dir, *rel.split("/"))
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        fs.get_file(remote, dst)
    return local_dir
