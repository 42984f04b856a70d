"""runtime_env tests: env_vars, working_dir, py_modules.

The port's mirror of `tests/test_runtime_env.py`, case for case, against
`ray_tpu_torch` (GPUs counted by `num_gpus` where the JAX package counts
`num_tpu_chips`).

Mirrors `python/ray/tests/test_runtime_env*.py` basics on the new runtime.
"""

import os
import sys

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def cluster():
    try:
        yield ray_tpu_torch.init(num_cpus=4, num_gpus=0, max_workers=8)
    finally:
        ray_tpu_torch.shutdown()


def test_env_vars_applied_and_restored(cluster):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"MY_FLAG": "on"}})
    def read_flag():
        return os.environ.get("MY_FLAG")

    @ray_tpu_torch.remote
    def read_plain():
        return os.environ.get("MY_FLAG")

    assert ray_tpu_torch.get(read_flag.remote()) == "on"
    # env var must not leak into later tasks on the same (pooled) worker
    assert ray_tpu_torch.get(read_plain.remote()) is None


def test_py_modules_ship_code(cluster, tmp_path):
    pkg = tmp_path / "mylib"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("VALUE = 123\n")
    (pkg / "helper.py").write_text("def f(x):\n    return x * 2\n")

    # pass the MODULE directory (reference semantics: `import mylib` works)
    @ray_tpu_torch.remote(runtime_env={"py_modules": [str(pkg)]})
    def use_lib():
        import mylib
        from mylib.helper import f

        return mylib.VALUE, f(21)

    assert ray_tpu_torch.get(use_lib.remote()) == (123, 42)


def test_working_dir(cluster, tmp_path):
    (tmp_path / "data.txt").write_text("payload42")

    @ray_tpu_torch.remote(runtime_env={"working_dir": str(tmp_path)})
    def read_rel():
        with open("data.txt") as f:
            return f.read()

    assert ray_tpu_torch.get(read_rel.remote()) == "payload42"


def test_actor_runtime_env_for_life(cluster, tmp_path):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"ACTOR_CFG": "deep"}})
    class Holder:
        def get(self):
            return os.environ.get("ACTOR_CFG")

    h = Holder.remote()
    assert ray_tpu_torch.get(h.get.remote()) == "deep"
    assert ray_tpu_torch.get(h.get.remote()) == "deep"
    ray_tpu_torch.kill(h)


def test_unsupported_keys_rejected(cluster):
    with pytest.raises(ValueError, match="not supported"):
        @ray_tpu_torch.remote(runtime_env={"conda": {"dependencies": ["x"]}})
        def f():
            return 1

        f.remote()


def test_options_override(cluster, tmp_path):
    @ray_tpu_torch.remote
    def read_env():
        return os.environ.get("VIA_OPTIONS")

    ref = read_env.options(
        runtime_env={"env_vars": {"VIA_OPTIONS": "yes"}}).remote()
    assert ray_tpu_torch.get(ref) == "yes"


# ----------------------------------------------------- pip/venv isolation
def _make_wheel(dirpath, name="mypkg_rtpu_test", version="1.0",
                body='MAGIC = "isolated-42"\n'):
    """Hand-rolled minimal wheel (zip + dist-info) so the pip test stays
    fully offline — mirrors the reference's use of local test wheels."""
    import base64
    import hashlib
    import os
    import zipfile

    os.makedirs(dirpath, exist_ok=True)
    whl = os.path.join(dirpath, f"{name}-{version}-py3-none-any.whl")
    dist = f"{name}-{version}.dist-info"
    files = {
        f"{name}/__init__.py": body,
        f"{dist}/METADATA": (f"Metadata-Version: 2.1\nName: {name}\n"
                             f"Version: {version}\n"),
        f"{dist}/WHEEL": ("Wheel-Version: 1.0\nGenerator: test\n"
                          "Root-Is-Purelib: true\nTag: py3-none-any\n"),
    }
    record_rows = []
    for path, content in files.items():
        digest = base64.urlsafe_b64encode(
            hashlib.sha256(content.encode()).digest()).rstrip(b"=").decode()
        record_rows.append(f"{path},sha256={digest},{len(content)}")
    record_rows.append(f"{dist}/RECORD,,")
    files[f"{dist}/RECORD"] = "\n".join(record_rows) + "\n"
    with zipfile.ZipFile(whl, "w") as zf:
        for path, content in files.items():
            zf.writestr(path, content)
    return whl


def test_materialize_venv_offline(tmp_path, monkeypatch):
    from ray_tpu_torch.core.runtime_env import materialize_venv, pip_env_key

    _make_wheel(str(tmp_path / "wheels"))
    monkeypatch.setenv("PIP_NO_INDEX", "1")
    monkeypatch.setenv("PIP_FIND_LINKS", str(tmp_path / "wheels"))
    import subprocess
    import time as _time

    pip = ["mypkg_rtpu_test"]
    py = materialize_venv(pip)
    out = subprocess.run(
        [py, "-c", "import mypkg_rtpu_test; print(mypkg_rtpu_test.MAGIC)"],
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "isolated-42"
    # the parent interpreter must NOT see the package (isolation)
    import importlib.util

    assert importlib.util.find_spec("mypkg_rtpu_test") is None
    # content-addressed cache: second call is instant reuse
    t0 = _time.monotonic()
    py2 = materialize_venv(pip, pip_env_key(pip))
    assert py2 == py and _time.monotonic() - t0 < 0.5


def test_pip_runtime_env_isolated_worker(tmp_path, monkeypatch):
    """End-to-end: a task with {"pip": [...]} runs on a venv worker that
    can import the package; plain tasks run on workers that cannot
    (reference runtime_env pip plugin + per-env worker pools)."""
    import ray_tpu_torch

    _make_wheel(str(tmp_path / "wheels"))
    monkeypatch.setenv("PIP_NO_INDEX", "1")
    monkeypatch.setenv("PIP_FIND_LINKS", str(tmp_path / "wheels"))
    ray_tpu_torch.shutdown()
    try:
        ray_tpu_torch.init(num_cpus=4, num_gpus=0, max_workers=6)
        @ray_tpu_torch.remote(runtime_env={"pip": ["mypkg_rtpu_test"]})
        def isolated():
            import sys

            import mypkg_rtpu_test

            return mypkg_rtpu_test.MAGIC, sys.prefix

        @ray_tpu_torch.remote
        def plain():
            try:
                import mypkg_rtpu_test  # noqa: F401

                return "leaked"
            except ImportError:
                return "clean"

        magic, prefix = ray_tpu_torch.get(isolated.remote(), timeout=240)
        assert magic == "isolated-42"
        assert "venvs" in prefix, f"worker not in a venv: {prefix}"
        assert ray_tpu_torch.get(plain.remote(), timeout=60) == "clean"

        # actors route to venv workers too
        @ray_tpu_torch.remote(runtime_env={"pip": ["mypkg_rtpu_test"]})
        class Iso:
            def magic(self):
                import mypkg_rtpu_test

                return mypkg_rtpu_test.MAGIC

        a = Iso.remote()
        assert ray_tpu_torch.get(a.magic.remote(), timeout=120) == "isolated-42"
    finally:
        ray_tpu_torch.shutdown()


def test_driver_level_runtime_env(tmp_path):
    """ray_tpu_torch.init(runtime_env=...) applies to EVERY task this driver
    submits; per-task keys override key-by-key (reference
    ray.init(runtime_env=...) job-level semantics)."""
    import ray_tpu_torch

    ray_tpu_torch.shutdown()
    try:
        ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_workers=4,
                           runtime_env={"env_vars": {"JOB_FLAVOR": "driverwide"}})
        @ray_tpu_torch.remote
        def read_env():
            import os

            return os.environ.get("JOB_FLAVOR")

        assert ray_tpu_torch.get(read_env.remote(), timeout=60) == "driverwide"

        @ray_tpu_torch.remote(runtime_env={"env_vars": {"JOB_FLAVOR": "local"}})
        def read_env2():
            import os

            return os.environ.get("JOB_FLAVOR")

        assert ray_tpu_torch.get(read_env2.remote(), timeout=60) == "local"

        # actors inherit the driver default too
        @ray_tpu_torch.remote
        class E:
            def get(self):
                import os

                return os.environ.get("JOB_FLAVOR")

        e = E.remote()
        assert ray_tpu_torch.get(e.get.remote(), timeout=60) == "driverwide"
    finally:
        ray_tpu_torch.shutdown()
