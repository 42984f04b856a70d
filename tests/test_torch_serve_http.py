"""The port's HTTP proxy and LLM apps (`ray_tpu_torch.serve.proxy`,
`serve.llm.build_llm_deployment` / `build_openai_app`) against the JAX
package.

The mirror of `tests/test_serve_http.py` (routing, 404, the LLM
deployment, the OpenAI-compatible app, SSE streaming; not gRPC, which is
ROADMAP item 18b) and of `tests/test_serve_plane.py`'s 429 shed. The LLM
apps serve one seeded float32 checkpoint (as `tests/test_torch_serve_openai.py`
builds it) on the CPU in replica processes; their answers over HTTP and
through a handle equal the JAX package's `LLMServer` and `OpenAIServer`
called in-process on the same checkpoint: equal tokens and text. Status
codes, `Retry-After`, content types, bodies and the SSE framing are the
ones the JAX proxy writes (both run the same aiohttp handlers).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.serve import llm as JS
from ray_tpu_torch import serve
from ray_tpu_torch.models import gpt2 as PG
from ray_tpu_torch.serve.llm import build_llm_deployment, build_openai_app

TIMEOUT = 120
ENGINE = dict(preset="gpt2-tiny", max_batch=2, max_seq_len=96,
              kv_blocks=32, kv_block_size=8)


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=8, num_gpus=0, max_workers=16)
    yield info
    serve.shutdown()
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def port(cluster):
    return serve.start()


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """gpt2-tiny weights larger than its init, so greedy streams vary."""
    cfg = PG.GPT2Config.preset("gpt2-tiny")
    rng = np.random.default_rng(7)
    flat = {}
    for key, shape in PG.param_shapes(cfg).items():
        matrix = len(shape) - key.startswith("blocks/") == 2
        if key.endswith("scale"):
            a = 1 + 0.1 * rng.standard_normal(shape)
        else:
            a = (0.2 if matrix else 0.05) * rng.standard_normal(shape)
        flat[key] = a.astype(np.float32)
    params = PG.params_from_numpy(flat, cfg, device="cpu")
    return PG.save_params(str(tmp_path_factory.mktemp("ckpt")), params, cfg)


def _http(url, body=None, method=None, headers=None):
    """(status, headers, body bytes) of one request; errors included."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _answer(out):
    """A response without its id (a clock reading)."""
    return {k: v for k, v in out.items() if k != "id"}


def _jax_server(cls, checkpoint, **kw):
    return cls(model_overrides={"dtype": jnp.float32}, weight_store=False,
               checkpoint=checkpoint, **ENGINE, **kw)


def _port_kwargs(checkpoint):
    return dict(model_overrides={"dtype": torch.float32}, weight_store=False,
                checkpoint=checkpoint, device="cpu", **ENGINE)


def test_http_proxy_routes_requests(cluster, port):
    @serve.deployment
    class Greeter:
        def __call__(self, request):
            name = request.get("name", "world")
            if name == "text":
                return "plain text"
            if name == "bytes":
                return b"\x00\x01raw"
            return {"hello": name, "path": request.path,
                    "method": request.method,
                    "query": request.query}

    serve.run(Greeter.bind(), route_prefix="/greet")
    base = f"http://127.0.0.1:{port}"
    status, headers, body = _http(f"{base}/greet", {"name": "gpu"})
    assert status == 200
    assert headers["Content-Type"] == "application/json; charset=utf-8"
    assert json.loads(body) == {"hello": "gpu", "path": "/greet",
                                "method": "POST", "query": {}}
    status, _, body = _http(f"{base}/greet/sub/path?k=v", {})
    assert json.loads(body) == {"hello": "world", "path": "/greet/sub/path",
                                "method": "POST", "query": {"k": "v"}}
    status, headers, body = _http(f"{base}/greet", {"name": "text"})
    assert (status, body) == (200, b"plain text")
    assert headers["Content-Type"] == "text/plain; charset=utf-8"
    status, headers, body = _http(f"{base}/greet", {"name": "bytes"})
    assert (status, body) == (200, b"\x00\x01raw")
    assert headers["Content-Type"] == "application/octet-stream"


def test_http_proxy_404(cluster, port):
    status, headers, body = _http(
        f"http://127.0.0.1:{port}/definitely-not-a-route")
    assert status == 404
    assert headers["Content-Type"] == "application/json; charset=utf-8"
    assert json.loads(body) == {"error": "no route for /definitely-not-a-route"}


def test_compiled_deployment_answers_500_naming_item_18b(cluster, port):
    @serve.deployment(compiled=True)
    class Fast:
        def __call__(self, request):
            return {"ok": True}

    h = serve.run(Fast.bind(), name="fast", route_prefix="/fast")
    assert h.remote({}).result(timeout=TIMEOUT) == {"ok": True}
    status, _, body = _http(f"http://127.0.0.1:{port}/fast", {})
    assert status == 500
    assert "NotImplementedError" in json.loads(body)["error"]
    assert "18b" in json.loads(body)["error"]
    serve.delete("fast")


def test_llm_builders_run_on_cuda_unless_told():
    """The builders ask for GPUs where the JAX package asks for chips, and
    a replica built without `device` runs on CUDA: here, with none, its
    construction raises."""
    app = build_openai_app(num_gpus=1, model_id="m")
    assert app.ray_actor_options == {"num_cpus": 1, "num_gpus": 1}
    assert app.name == "openai-m"
    dep = build_llm_deployment(name="x", max_batch=3)
    assert dep.ray_actor_options == {"num_cpus": 1}
    assert dep.max_ongoing_requests == 6
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default would succeed")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run(dep, _local_testing_mode=True)


def test_llm_app_over_http_matches_jax(cluster, port, checkpoint):
    """build_llm_deployment on two replicas: the greedy answers through
    HTTP and through a handle equal the JAX LLMServer's in-process, and
    concurrent requests answer too."""
    app = build_llm_deployment(name="llm", num_replicas=2,
                               **_port_kwargs(checkpoint))
    h = serve.run(app, route_prefix="/llm")
    jsrv = _jax_server(JS.LLMServer, checkpoint)
    try:
        bodies = [{"prompt": "hello world", "max_tokens": 8},
                  {"prompt_ids": list(range(5, 40)), "max_tokens": 6},
                  {"prompt": "the quick brown fox", "max_tokens": 5}]
        for body in bodies:
            want = _answer(jsrv(body))
            status, headers, raw = _http(f"http://127.0.0.1:{port}/llm", body)
            assert status == 200, raw
            assert _answer(json.loads(raw)) == want
            assert _answer(h.remote(body).result(timeout=TIMEOUT)) == want
        resps = [h.remote({"prompt": f"p{i}", "max_tokens": 4})
                 for i in range(4)]
        outs = [r.result(timeout=TIMEOUT) for r in resps]
        assert all(len(o["choices"][0]["token_ids"]) == 4 for o in outs)
        assert [o["choices"][0]["token_ids"] for o in outs] == [
            jsrv({"prompt": f"p{i}", "max_tokens": 4})["choices"][0]
            ["token_ids"] for i in range(4)]
    finally:
        jsrv.engine.shutdown()
        serve.delete("llm")


def test_openai_app_over_http_matches_jax(cluster, port, checkpoint):
    app = build_openai_app(model_id="tiny", **_port_kwargs(checkpoint))
    serve.run(app, route_prefix="/v1")
    jsrv = _jax_server(JS.OpenAIServer, checkpoint, model_id="tiny")

    class _Path:
        def __init__(self, path, body=None):
            self.path, self.json = path, body

    base = f"http://127.0.0.1:{port}/v1"
    try:
        status, _, raw = _http(f"{base}/models")
        assert status == 200
        assert json.loads(raw) == jsrv(_Path("/v1/models"))
        completion = {"model": "tiny", "prompt": "the quick brown fox",
                      "max_tokens": 8, "temperature": 0.0}
        chat = {"model": "tiny", "max_tokens": 6, "temperature": 0.0,
                "messages": [{"role": "system", "content": "be brief"},
                             {"role": "user", "content": "hello there"}]}
        for path, body in (("/completions", completion),
                           ("/chat/completions", chat)):
            status, _, raw = _http(base + path, body)
            assert status == 200, raw
            got = json.loads(raw)
            assert _answer(got) == _answer(jsrv(_Path("/v1" + path, body)))
            assert got["usage"]["completion_tokens"] == body["max_tokens"]
        # sampling knobs ride through (the answer's shape, not its text)
        status, _, raw = _http(f"{base}/completions",
                               {**completion, "temperature": 0.8,
                                "top_k": 20, "top_p": 0.9})
        assert status == 200 and json.loads(raw)["object"] == \
            "text_completion"
    finally:
        jsrv.engine.shutdown()


def _sse_events(raw: str) -> list:
    return [ln[len("data: "):] for ln in raw.split("\n")
            if ln.startswith("data: ")]


@pytest.mark.parametrize("mode", ["completion", "chat"])
def test_openai_sse_stream_matches_jax(cluster, port, checkpoint, mode):
    """`stream: true` over the proxy: text/event-stream, `data: ` events
    separated by blank lines, one id, `[DONE]` last, `finish_reason`
    "length" on the last chunk; the deltas concatenate to the JAX
    server's non-streamed text."""
    if "openai-tiny" not in serve.status():
        serve.run(build_openai_app(model_id="tiny",
                                   **_port_kwargs(checkpoint)),
                  route_prefix="/v1")
    jsrv = _jax_server(JS.OpenAIServer, checkpoint, model_id="tiny")

    class _Path:
        def __init__(self, path, body=None):
            self.path, self.json = path, body

    if mode == "chat":
        path = "/v1/chat/completions"
        body = {"messages": [{"role": "user", "content": "stream me"}],
                "max_tokens": 9, "temperature": 0.0}
    else:
        path = "/v1/completions"
        body = {"prompt": "stream me", "max_tokens": 9, "temperature": 0.0}
    try:
        want = jsrv(_Path(path, body))
        want_text = (want["choices"][0]["message"]["content"]
                     if mode == "chat" else want["choices"][0]["text"])
        status, headers, raw = _http(f"http://127.0.0.1:{port}{path}",
                                     {**body, "stream": True})
    finally:
        jsrv.engine.shutdown()
    assert status == 200
    assert headers["Content-Type"] == "text/event-stream"
    assert headers["Cache-Control"] == "no-cache"
    text = raw.decode()
    assert text.endswith("data: [DONE]\n\n")
    assert all(block.startswith("data: ")
               for block in text.split("\n\n") if block)
    events = _sse_events(text)
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert len(chunks) >= 2 and len({c["id"] for c in chunks}) == 1
    obj = "chat.completion.chunk" if mode == "chat" else "text_completion"
    assert all(c["object"] == obj and c["model"] == "tiny" for c in chunks)
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    if mode == "chat":
        got = "".join(c["choices"][0]["delta"].get("content", "")
                      for c in chunks)
    else:
        got = "".join(c["choices"][0]["text"] for c in chunks)
    assert got == want_text


def _metric_families(client) -> str:
    """Every process's pushed metric snapshots, as the head holds them."""
    text = []
    for key in client.head_request("kv_keys", ns="_metrics", prefix=b""):
        value = client.head_request("kv_get", ns="_metrics", key=key)
        if value:
            text.append(value.decode())
    return "\n".join(text)


def test_proxy_sheds_with_429_and_retry_after(cluster, port):
    """Bounded-queue admission at the proxy: with one slow replica and
    max_queue=3, a second wave launched while the first occupies the queue
    is shed as 429 + Retry-After; admitted requests succeed; the shed and
    admit counters reach the head."""

    @serve.deployment
    class Slow:
        def __call__(self, request):
            time.sleep(0.8)
            return {"ok": True}

    serve.run(Slow.options(
        max_ongoing_requests=16,
        slo_config={"max_queue": 3, "retry_after_s": 2.0}).bind(),
        name="shed-me", route_prefix="/shed-me")
    url = f"http://127.0.0.1:{port}/shed-me"
    results = []
    lock = threading.Lock()

    def post():
        status, headers, body = _http(url, {"x": 1})
        with lock:
            results.append((status, headers.get("Retry-After"), body))

    wave1 = [threading.Thread(target=post) for _ in range(5)]
    for t in wave1:
        t.start()
    time.sleep(0.4)
    wave2 = [threading.Thread(target=post) for _ in range(5)]
    for t in wave2:
        t.start()
    for t in wave1 + wave2:
        t.join(90)
    codes = [c for c, _, _ in results]
    assert codes.count(200) >= 1, results
    assert codes.count(429) >= 1, results
    assert set(codes) <= {200, 429}, results
    for code, retry, body in results:
        if code == 429:
            assert retry is not None and int(retry) >= 2
            assert json.loads(body) == {"error": "deployment over capacity",
                                        "reason": "queue_full",
                                        "projected_wait_s": None}
    from ray_tpu_torch.core.api import _global_client

    client = _global_client()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        text = _metric_families(client)
        if "serve_shed_total" in text and "serve_admitted_total" in text:
            break
        time.sleep(0.5)
    else:
        pytest.fail("shed/admit counters never reached the head")
    serve.delete("shed-me")


def test_check_open_ports(cluster, port):
    from ray_tpu_torch.util.check_open_ports import check_open_ports

    report = check_open_ports()
    assert report["open_to_network"] == [], report
    assert report["loopback_only"], report
