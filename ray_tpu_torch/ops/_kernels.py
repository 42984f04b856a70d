"""Build and load the port's CUDA kernels.

Each source in ``ray_tpu_torch/csrc`` is compiled by ``nvcc`` for sm_90a into
a shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Libraries go to
``ray_tpu_torch/_build/`` (ignored by git), named by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or header
is rebuilt and never confused with an old library. Nothing is built at
import: the first launch builds, or a caller builds every kernel at once with
`build_all` (one ``nvcc`` per source, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel name -> (source file, [(C function, argtypes)])
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
KERNELS = {
    "flash_fwd": ("flash_fwd.cu", [
        ("rt_flash_fwd", [_P, _P, _P, _P, _P] + [_I] * 5 + [_I] * 9
         + [_I, _F, _I, _P]),
    ]),
    "flash_bwd": ("flash_bwd.cu", [
        ("rt_flash_bwd_dq", [_P] * 8 + [_I] * 5 + [_IP, _I, _F, _I, _P]),
        ("rt_flash_bwd_dkv", [_P] * 8 + [_I] * 5 + [_IP, _I, _F, _I, _P]),
    ]),
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# kernel name -> {"seconds": build time, "log": nvcc/ptxas output}
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of its source, every shared
    header in csrc (a source may include any of them) and the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [KERNELS[name][0]] + headers:
        h.update(fname.encode())
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all(names: Optional[list] = None) -> Dict[str, dict]:
    """Build the named kernels (all by default) that are not built yet, one
    ``nvcc`` process per source, started together. Returns `build_info`; a
    library built earlier reports the log of its build, kept beside it."""
    names = list(KERNELS) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            if name not in build_info:
                with open(f"{out}.log") as f:
                    build_info[name] = {"seconds": 0.0, "log": f.read()}
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, KERNELS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        with open(f"{out}.log", "w") as f:
            f.write(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return build_info


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(_lib_path(name))
            for fn, argtypes in KERNELS[name][1]:
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib
