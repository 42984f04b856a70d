"""Scale-to-zero and the live-load autoscaler in the port
(`ray_tpu_torch.serve.autoscaling`, the controller's parking, the proxy's
cold queue).

The mirror of `tests/test_scale_to_zero.py`: the policy units (side by side
with the JAX package's on the same inputs), the park/wake drill and the
cold queue-depth drill, both marked slow as there. Not mirrored: the
N-model multiplex cold-burst drill, which drives the JAX package's
`benchmarks/soak.py`. Beside the mirror, one unmarked park/wake case of a
few seconds (short staleness), so that tier 1 covers scale-to-zero, and
the live-signal cache's refusal to start a runtime.
"""

import threading
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu.serve import autoscaling as JA
from ray_tpu_torch import serve
from ray_tpu_torch.serve import autoscaling as PA


def test_live_cache_refresh_never_autoinits_runtime():
    """A live-load refresh consulted outside an initialized runtime stays a
    no-op: it must not leave a default runtime behind."""
    from ray_tpu_torch.core import api as core_api
    from ray_tpu_torch.serve.live_signals import LiveLoadCache

    if core_api.is_initialized():
        pytest.skip("runtime already initialized in this process")
    LiveLoadCache().refresh(force=True)
    assert not core_api.is_initialized()


def test_policy_parks_only_explicit_zero_floor():
    """min_replicas=0 holds a demandless deployment at zero; any demand
    wakes exactly one replica; the default config keeps the always-on
    floor even from zero. Each case agrees with the JAX package's."""
    cases = [((0, 4), 0.0, 0, 0), ((0, 4), 1.0, 0, 1), ((0, 4), 50.0, 0, 1),
             ((1, 4), 0.0, 0, 1), ((1, 4), 1.0, 0, 1), ((0, 4), 0.0, 2, 0),
             ((1, 4), 0.0, 2, 1)]
    for (lo, hi), ongoing, current, want in cases:
        p = PA.AutoscalingConfig(min_replicas=lo, max_replicas=hi)
        j = JA.AutoscalingConfig(min_replicas=lo, max_replicas=hi)
        got = PA.calculate_desired_num_replicas(p, ongoing, current)
        assert got == want
        assert got == JA.calculate_desired_num_replicas(j, ongoing, current)


def test_live_load_rows_wake_parked_deployment():
    """Fresh queue depth wakes a parked deployment, an idle fresh row parks
    it, stale rows defer to the polled fallback."""
    now = time.time()
    fresh = [{"queue_depth": 3, "ewma_latency_s": 0.1, "ts": now}]
    idle = [{"queue_depth": 0, "ewma_latency_s": 0.1, "ts": now}]
    stale = [{"queue_depth": 9, "ewma_latency_s": 0.1, "ts": now - 300}]
    kw = dict(min_replicas=0, max_replicas=4, target_ongoing_requests=2.0)
    p, j = PA.AutoscalingConfig(**kw), JA.AutoscalingConfig(**kw)
    for rows, current, want in ((fresh, 0, 1), (idle, 1, 0), (stale, 0, None)):
        assert PA.desired_from_live_load(p, rows, current, now=now) == want
        assert JA.desired_from_live_load(j, rows, current, now=now) == want


def _post(url, timeout=120):
    req = urllib.request.Request(url, data=b'{"x": 1}',
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _running(name):
    return serve.status().get(name, {}).get("running")


def _wait_running(name, want, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if _running(name) == want:
            return True
        time.sleep(0.25)
    return False


def test_park_wake_repark_short():
    """A min_replicas=0 deployment starts parked, the first HTTP request
    queues at the proxy and wakes one replica (200 with the right answer,
    not 500), and it parks again once its live rows go stale (1 s)."""
    ray_tpu_torch.init(num_cpus=4, num_gpus=0, max_workers=8)

    @serve.deployment
    class Cold:
        def __call__(self, request):
            return {"double": 2 * request.get("x")}

    try:
        serve.run(Cold.options(autoscaling_config=serve.AutoscalingConfig(
            min_replicas=0, max_replicas=1, target_ongoing_requests=4,
            signal_staleness_s=1.0)).bind(), name="s2z-short",
            route_prefix="/s2z-short")
        port = serve.start()
        time.sleep(1.0)
        assert _running("s2z-short") == 0
        status, body = _post(f"http://127.0.0.1:{port}/s2z-short")
        assert status == 200 and body == b'{"double": 2}'
        assert _running("s2z-short") == 1
        assert _wait_running("s2z-short", 0, 30), serve.status()
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


def test_wake_survives_a_slow_replica_init():
    """A woken replica whose __init__ outlasts every demand signal (the
    proxy's pushed queue depth counts for 5 s; a replica still in __init__
    publishes no load row and answers no health check) is kept, not parked
    mid-init and woken again in a loop: the first request answers 200. A
    GPU replica's init (torch import, CUDA context, model build) takes tens
    of seconds."""
    ray_tpu_torch.init(num_cpus=4, num_gpus=0, max_workers=8)

    @serve.deployment
    class SlowInit:
        def __init__(self):
            time.sleep(12.0)

        def __call__(self, request):
            return {"double": 2 * request.get("x")}

    try:
        serve.run(SlowInit.options(autoscaling_config=serve.AutoscalingConfig(
            min_replicas=0, max_replicas=1, signal_staleness_s=1.0)).bind(),
            name="s2z-slow", route_prefix="/s2z-slow")
        port = serve.start()
        time.sleep(1.0)
        assert _running("s2z-slow") == 0
        status, body = _post(f"http://127.0.0.1:{port}/s2z-slow")
        assert (status, body) == (200, b'{"double": 2}'), body
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


@pytest.mark.slow
def test_park_wake_on_request_and_repark():
    """The slow drill of the JAX package: a replica whose __init__ takes
    0.5 s, the wake within 30 s, a warm request at least twice as fast,
    and the default staleness before it re-parks."""
    ray_tpu_torch.init(num_cpus=8, num_gpus=0, max_workers=16)

    @serve.deployment
    class ColdModel:
        def __init__(self):
            time.sleep(0.5)

        def __call__(self, request):
            return {"ok": True}

    try:
        serve.run(ColdModel.options(
            max_ongoing_requests=8,
            autoscaling_config=serve.AutoscalingConfig(
                min_replicas=0, max_replicas=2,
                target_ongoing_requests=4)).bind(),
            name="s2z", route_prefix="/s2z")
        port = serve.start()
        url = f"http://127.0.0.1:{port}/s2z"
        time.sleep(2.0)
        assert _running("s2z") == 0
        t0 = time.perf_counter()
        assert _post(url)[0] == 200
        wake_s = time.perf_counter() - t0
        assert wake_s < 30, f"cold wake took {wake_s:.1f}s"
        assert (_running("s2z") or 0) >= 1
        t0 = time.perf_counter()
        assert _post(url, timeout=30)[0] == 200
        assert time.perf_counter() - t0 < max(1.0, wake_s / 2)
        assert _wait_running("s2z", 0, 90), "never re-parked"
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


@pytest.mark.slow
def test_cold_queue_depth_reaches_controller():
    """Concurrent cold requests all queue (no shed, no 500) and the
    deployment wakes with demand recorded."""
    ray_tpu_torch.init(num_cpus=8, num_gpus=0, max_workers=16)

    @serve.deployment
    class ColdModel:
        def __init__(self):
            time.sleep(1.0)

        def __call__(self, request):
            time.sleep(0.01)
            return {"ok": True}

    try:
        serve.run(ColdModel.options(
            max_ongoing_requests=8,
            autoscaling_config=serve.AutoscalingConfig(
                min_replicas=0, max_replicas=2,
                target_ongoing_requests=4)).bind(),
            name="s2z-q", route_prefix="/s2zq")
        port = serve.start()
        url = f"http://127.0.0.1:{port}/s2zq"
        codes = []
        lock = threading.Lock()

        def one():
            code = _post(url)[0]
            with lock:
                codes.append(code)

        threads = [threading.Thread(target=one, daemon=True)
                   for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(150)
        assert codes and all(c == 200 for c in codes), codes
        assert (_running("s2z-q") or 0) >= 1
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
