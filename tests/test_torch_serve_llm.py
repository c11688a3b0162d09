"""The port's OpenAI-compatible LLM app against the JAX package's, on the CPU.

One JAX tiny model's params are saved twice: with orbax for the JAX
engine's ``checkpoint_path`` and as a save_pytree (DCP) directory of
``params_from_jax`` for the port's. The same greedy requests go to JAX's
app (``ray_tpu.serve.run(build_openai_app(...), http=True)``), whose
runtime is then shut down, and to the port's, over HTTP:
``/v1/completions``, ``/v1/chat/completions`` with and without
``stream``, ``/v1/models``, and the handle API's ``completions`` and
``chat``. Both give the same texts, token counts, finish reasons and JSON
keys; only ids and timestamps may differ. f32 engines, where the greedy
tokens of both are identical.
"""

import json
import time
import urllib.request

import jax
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jax_serve
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import build_openai_app as jax_build_openai_app
from ray_tpu.models.llama import init_params as jax_init_params
from ray_tpu_torch import serve
from ray_tpu_torch.llm import LLMConfig, build_llm_deployment, build_openai_app
from ray_tpu_torch.models.llama import params_from_jax
from ray_tpu_torch.train.checkpoint import save_pytree

ENGINE = dict(model="tiny", dtype="float32", max_num_seqs=2,
              max_seq_len=128, seed=0)
GREEDY = {"max_tokens": 6, "temperature": 0.0}
MESSAGES = [{"role": "user", "content": "hello there"}]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    import orbax.checkpoint as ocp

    jcfg = JaxLLMConfig(**ENGINE).model_config()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(3))
    root = tmp_path_factory.mktemp("llm_ckpt")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(root / "orbax"), jp)
    ckptr.wait_until_finished()
    save_pytree(params_from_jax(jp, device="cpu"), str(root / "dcp"))
    return str(root / "orbax"), str(root / "dcp")


def _post(port: int, path: str, body: dict):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        ctype = r.headers["Content-Type"]
        text = r.read().decode()
    if ctype.startswith("text/event-stream"):
        assert text.endswith("data: [DONE]\n\n")
        return [json.loads(line[6:]) for line in text.splitlines()
                if line.startswith("data: ") and line != "data: [DONE]"]
    return json.loads(text)


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as r:
        return json.loads(r.read())


def _drive(serve_mod, app, handle_timeout=120):
    """Every request of the comparison against one running app."""
    handle = serve_mod.run(app, route_prefix="/", http=True,
                           _blocking_timeout=300)
    port = serve_mod.http_port()
    path_c, path_chat = "/v1/completions", "/v1/chat/completions"
    return {
        "completion": [_post(port, path_c, {"prompt": p, **GREEDY})
                       for p in ("hi", "the quick brown fox", [5, 6, 7])],
        "chat": _post(port, path_chat, {"messages": MESSAGES, **GREEDY}),
        "chat_stream": _post(port, path_chat, {"messages": MESSAGES,
                                               "stream": True, **GREEDY}),
        "completion_stream": _post(port, path_c, {"prompt": "hi",
                                                  "stream": True, **GREEDY}),
        "models": _get(port, "/v1/models"),
        "unknown": _post(port, "/v1/other", {}),
        "handle_completion": handle.completions.remote(
            "abc", **GREEDY).result(timeout=handle_timeout),
        "handle_chat": handle.chat.remote(
            MESSAGES, **GREEDY).result(timeout=handle_timeout),
    }


def _strip(obj):
    """Drop what may differ: ids and timestamps."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def test_openai_app_matches_ray_tpu_over_http(checkpoints):
    orbax_dir, dcp_dir = checkpoints
    ray_tpu.init()
    try:
        want = _drive(jax_serve, jax_build_openai_app(
            JaxLLMConfig(**ENGINE, checkpoint_path=orbax_dir)))
    finally:
        jax_serve.shutdown()
        ray_tpu.shutdown()
    ray_tpu_torch.init()
    try:
        got = _drive(serve, build_openai_app(
            LLMConfig(**ENGINE, checkpoint_path=dcp_dir), device="cpu"))
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    assert _strip(got) == _strip(want)
    # The comparison is not vacuous: tokens came back, streams framed.
    assert all(c["usage"]["completion_tokens"] == GREEDY["max_tokens"]
               for c in got["completion"])
    assert got["chat_stream"][-1]["choices"][0]["finish_reason"] == "length"
    assert len(got["chat_stream"]) == GREEDY["max_tokens"] + 1


def test_build_functions_refuse_what_no_replica_could_serve():
    for kw, match in ((dict(placement_group_config={"bundles": [{"GPU": 1}]}),
                       "7\\(b\\)"),
                      (dict(engine_kwargs={"block_size": 16}), "engine_kwargs")):
        with pytest.raises(NotImplementedError, match=match):
            build_openai_app(LLMConfig(**ENGINE, **kw), device="cpu")
        with pytest.raises(NotImplementedError, match=match):
            build_llm_deployment(LLMConfig(**ENGINE, **kw))


def test_replica_stop_shuts_the_engine_down():
    """The controller stopping a replica calls LLMServer.shutdown (the
    process exit of JAX's replicas): the engine's scheduler thread ends."""
    from ray_tpu_torch.serve.handle import CONTROLLER_NAME, SERVE_NAMESPACE

    ray_tpu_torch.init()
    try:
        handle = serve.run(build_openai_app(LLMConfig(**ENGINE),
                                            device="cpu"), route_prefix=None)
        assert handle.completions.remote("x", **GREEDY).result(
            timeout=120)["usage"]["completion_tokens"] == 6
        ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME,
                                       namespace=SERVE_NAMESPACE)
        info = ray_tpu_torch.get(ctrl.get_replicas.remote("LLMServer"))[0]
        rt = ray_tpu_torch.core.worker.global_worker.runtime
        state = rt._actors[ray_tpu_torch.get_actor(
            info.actor_name, namespace="serve").actor_id]
        engine = state.instance._callable.engine
        assert engine._thread.is_alive()
        serve.shutdown()
        assert not engine._thread.is_alive()
        deadline = time.monotonic() + 10  # the killed actor's thread ends
        while state.instance is not None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert state.instance is None  # the replica's actor let it go
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


def test_killed_replica_engine_stops_when_collected():
    """A replica killed with kill() never gets stop(); dropping its
    LLMServer still stops the engine's scheduler thread."""
    import gc

    from ray_tpu_torch.serve.handle import CONTROLLER_NAME, SERVE_NAMESPACE

    ray_tpu_torch.init()
    try:
        handle = serve.run(build_openai_app(LLMConfig(**ENGINE),
                                            device="cpu"), route_prefix=None)
        assert handle.completions.remote("x", **GREEDY).result(
            timeout=120)["usage"]["completion_tokens"] == 6
        ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME,
                                       namespace=SERVE_NAMESPACE)
        info = ray_tpu_torch.get(ctrl.get_replicas.remote("LLMServer"))[0]
        actor = ray_tpu_torch.get_actor(info.actor_name, namespace="serve")
        rt = ray_tpu_torch.core.worker.global_worker.runtime
        state = rt._actors[actor.actor_id]
        thread = state.instance._callable.engine._thread
        assert thread.is_alive()
        ray_tpu_torch.kill(actor)
        del actor, state
        deadline = time.monotonic() + 20
        while thread.is_alive() and time.monotonic() < deadline:
            gc.collect()
            time.sleep(0.05)
        assert not thread.is_alive()
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
