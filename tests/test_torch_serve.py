"""ray_tpu_torch.serve against ray_tpu.serve, on the CPU.

Decisions step by step: one table of inputs goes through the JAX
package's class and the port's, and the outputs must be equal: the
router's replica choice (pow-2 with both ``_rng``s seeded alike, hint
ranking, prefix scoring, draining, excluded and blacklisted replicas), the
circuit breaker's transitions on a fake clock, the retry loop's decisions
and backoff pauses, the error classification and the controller's
autoscale target over one sequence of ongoing-request counts and times.

Deployments end to end, on the port alone (the behaviour of
tests/test_serve.py): each test starts the port's runtime and ends with
``serve.shutdown()`` and ``ray_tpu_torch.shutdown()``; HTTP binds port 0.
"""

import json
import random
import threading
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import ray_tpu.core.exceptions as jax_exc
import ray_tpu.serve.config as jax_cfg
import ray_tpu.serve.controller as jax_ctrl
import ray_tpu.serve.handle as jax_handle
import ray_tpu.serve.resilience as jax_res
import ray_tpu.serve.router as jax_router
import ray_tpu_torch
import ray_tpu_torch.core.exceptions as port_exc
import ray_tpu_torch.serve.config as port_cfg
import ray_tpu_torch.serve.controller as port_ctrl
import ray_tpu_torch.serve.handle as port_handle
import ray_tpu_torch.serve.resilience as port_res
import ray_tpu_torch.serve.router as port_router
from ray_tpu_torch import serve
from ray_tpu_torch.core.worker import global_worker

SIDES = {
    "jax": SimpleNamespace(exc=jax_exc, cfg=jax_cfg, ctrl=jax_ctrl,
                           handle=jax_handle, res=jax_res,
                           router=jax_router),
    "torch": SimpleNamespace(exc=port_exc, cfg=port_cfg, ctrl=port_ctrl,
                             handle=port_handle, res=port_res,
                             router=port_router),
}


class FakeClock:
    """Stands in for a module's ``time``: monotonic() and time() read one
    settable clock; sleep() advances it and records the pause."""

    def __init__(self, t: float = 1000.0):
        self.t = t
        self.slept: list[float] = []

    def monotonic(self) -> float:
        return self.t

    def time(self) -> float:
        return self.t

    def perf_counter(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.slept.append(round(s, 12))
        self.t += s


def both(program):
    """program(side) for each package; returns (jax's, the port's)."""
    return program(SIDES["jax"]), program(SIDES["torch"])


# ------------------------------------------------------------- decisions


def _replicas(side, n, cap=4, draining=(), blocks=None):
    return [side.cfg.ReplicaInfo(
        replica_id=f"r{i}", deployment_name="d", actor_name=f"a{i}",
        max_ongoing_requests=cap, draining=i in draining,
        prefix_blocks=(blocks or {}).get(i)) for i in range(n)]


def test_router_choices_match_ray_tpu():
    """A seeded table of scenarios (replica counts, loads, hints, prefix
    hashes, draining, excluded and breaker-blacklisted replicas) through
    both routers' _choose_locked, each _rng seeded alike."""
    def program(side):
        rng = np.random.default_rng(7)
        router = side.router.Router("d", lambda: [])
        router._rng = random.Random(11)
        out = []
        for step in range(120):
            n = int(rng.integers(1, 6))
            drain = {int(i) for i in rng.choice(n, int(rng.integers(0, 2)),
                                                replace=False)}
            blocks = {i: tuple(int(h) for h in rng.integers(0, 6, 3))
                      for i in range(n) if rng.random() < 0.5}
            reps = _replicas(side, n, cap=int(rng.integers(2, 6)),
                             draining=drain, blocks=blocks)
            router.notify_replicas_changed(reps)
            router._inflight = {r.replica_id: int(rng.integers(0, 6))
                                for r in reps}
            if step % 17 == 5:  # blacklist one replica: consecutive failures
                for _ in range(3):
                    router.breaker.record_failure(f"r{int(rng.integers(n))}")
            exclude = frozenset(f"r{int(i)}" for i in range(n)
                                if rng.random() < 0.15)
            hint = f"hint{int(rng.integers(3))}" if rng.random() < 0.4 \
                else None
            hashes = tuple(int(h) for h in rng.integers(0, 6, 3)) \
                if rng.random() < 0.4 else None
            got = router._choose_locked(reps, hint, exclude, hashes)
            out.append((got.replica_id if got else None,
                        router._choice_was_probe))
        return out

    want, got = both(program)
    assert got == want
    assert len({c for c, _ in got}) > 3  # the table reaches many outcomes


def test_hint_yields_to_balance_when_overloaded():
    """tests/test_serve.py's TestRouterUnit case, on both routers."""
    def program(side):
        router = side.router.Router("d", lambda: [])
        reps = _replicas(side, 3, cap=100)
        hinted = router._choose_locked(reps, route_hint="shared-prefix")
        delta = side.router.Router.HINT_BALANCE_DELTA
        router._inflight[hinted.replica_id] = delta + 1
        away = router._choose_locked(reps, route_hint="shared-prefix")
        router._inflight[hinted.replica_id] = delta
        back = router._choose_locked(reps, route_hint="shared-prefix")
        return (hinted.replica_id, away.replica_id != hinted.replica_id,
                back.replica_id)

    want, got = both(program)
    assert got == want
    assert got[1] and got[2] == got[0]


def test_circuit_breaker_transitions_match_ray_tpu(monkeypatch):
    events = [("fail", "a")] * 2 + [("allow", "a"), ("fail", "a"),
                                    ("allow", "a"), ("advance", 1.0),
                                    ("allow", "a"), ("advance", 1.5),
                                    ("allow", "a"), ("allow", "a"),
                                    ("cancel", "a"), ("allow", "a"),
                                    ("fail", "a"), ("allow", "a"),
                                    ("advance", 2.5), ("allow", "a"),
                                    ("ok", "a", 0.01), ("allow", "a")]
    # A latency outlier: "b" slow against a fast fleet.
    events += [("ok", "c", 0.01)] * 40 + [("ok", "b", 0.2)] * 16
    events += [("allow", "b"), ("advance", 3.0), ("allow", "b"),
               ("fail", "b"), ("allow", "b")]

    def program(side):
        clock = FakeClock()
        monkeypatch.setattr(side.res, "time", clock)
        opened = []
        br = side.res.CircuitBreaker(
            side.res.CircuitBreakerConfig(failure_threshold=3, open_s=2.0,
                                          half_open_probes=1,
                                          latency_factor=5.0,
                                          latency_min_samples=16),
            on_open=lambda rid, why: opened.append((rid, why)))
        out = []
        for ev in events:
            kind, rid = ev[0], ev[1]
            if kind == "fail":
                br.record_failure(rid)
            elif kind == "ok":
                br.record_success(rid, ev[2])
            elif kind == "allow":
                out.append(br.allow_ex(rid))
            elif kind == "cancel":
                br.cancel_probe(rid)
            else:
                clock.t += rid
                continue
            out.append((br.state(rid), br.is_open(rid), br.open_count()))
        br.forget(["c"])
        out.append((br.state("a"), br.state("b")))
        return out, opened

    want, got = both(program)
    assert got == want
    assert [r for r, _ in got[1]] == ["a", "a", "b", "b"]


def _errors(side):
    """One error of each kind, raw and as a TaskError's cause."""
    e, r = side.exc, side.res
    raw = [e.ActorDiedError("ab" * 8, "gone", never_sent=True),
           e.ActorDiedError("cd" * 8, "died mid-call"),
           e.ActorUnavailableError("restarting"),
           r.Overloaded("full", where="replica"),
           r.Overloaded("queue full", where="router"),
           r.DeadlineExceeded(), TimeoutError("stalled"),
           ValueError("the app's answer")]
    return raw + [e.TaskError(x, task_desc="t") for x in raw]


@pytest.mark.parametrize("policy", [
    dict(), dict(max_retries=0), dict(max_retries=3, backoff_s=0.1),
    dict(retry_overloaded=False), dict(retry_never_sent=False)])
def test_classification_and_retry_decisions_match_ray_tpu(policy,
                                                          monkeypatch):
    """classify / is_retryable over every kind, then the handle's retry
    loop (DeploymentResponse._maybe_retry) over a sequence of failures:
    whether it retries, its backoff pauses (random() fixed at 0.5), the
    replicas it excludes."""
    monkeypatch.setattr(random, "random", lambda: 0.5)

    def program(side):
        clock = FakeClock()
        monkeypatch.setattr(side.handle, "time", clock)
        pol = side.res.RetryPolicy(**policy)
        kinds = [(side.res.classify(x),
                  side.res.is_retryable(side.res.classify(x), pol))
                 for x in _errors(side)]
        submitted = []

        class Router:
            settings = SimpleNamespace(retry=pol)

            def assign_request(self, method, args, kwargs, **kw):
                submitted.append(sorted(kw["exclude"]))
                return object(), f"r{len(submitted)}"

            def count_retry(self):
                pass

        resp = side.handle.DeploymentResponse(Router(), "m", (), {},
                                              deadline=clock.t + 30)
        decisions = [(resp._maybe_retry(x, pol, resp._deadline),
                      resp._retries_used, resp._never_sent_used)
                     for x in _errors(side)]
        return kinds, decisions, clock.slept, submitted

    want, got = both(program)
    assert got == want


def test_autoscale_target_matches_ray_tpu(monkeypatch):
    """ServeController._autoscale over one sequence of (time step,
    ongoing requests): the target replica count after each tick."""
    seq = [(0.0, 0), (0.1, 9), (0.2, 9), (0.7, 9), (0.8, 20), (1.0, 20),
           (1.6, 20), (1.7, 3), (2.0, 3), (3.0, 3), (4.0, 3), (4.5, 0),
           (5.0, 0), (7.5, 0), (9.6, 0), (9.7, 14), (9.8, 5), (10.4, 14)]

    def program(side):
        clock = FakeClock()
        monkeypatch.setattr(side.ctrl, "time", clock)
        asc = side.cfg.AutoscalingConfig(
            min_replicas=1, max_replicas=4, target_ongoing_requests=4.0,
            upscale_delay_s=0.5, downscale_delay_s=2.0,
            metrics_interval_s=1e9)  # no metric pull: ongoing set below
        ds = side.ctrl._DeploymentState(
            name="d", app_name="a", cls_blob=b"", init_args_blob=b"",
            config=side.cfg.DeploymentConfig(autoscaling_config=asc),
            version="v", last_metric_pull=clock.t)
        out = []
        start = clock.t
        for t, ongoing in seq:
            clock.t = start + t
            ds.total_ongoing = float(ongoing)
            side.ctrl.ServeController._autoscale(None, ds)
            out.append((ds.autoscale_target, ds.desired_since and
                        ds.desired_since[0]))
        return out

    want, got = both(program)
    assert got == want
    assert {t for t, _ in got} >= {1, 3, 4}


# --------------------------------------------------- deployments, port only


@pytest.fixture()
def rt():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8)
    yield global_worker.runtime
    serve.shutdown()
    left = global_worker.runtime.shutdown()
    ray_tpu_torch.shutdown()
    assert left == []  # no serve thread outlives the runtime


def test_deploy_call_function_deployment_and_composition(rt):
    @serve.deployment
    class Echo:
        def __call__(self, x):
            return f"echo:{x}"

        def shout(self, x):
            return f"ECHO:{x}"

    @serve.deployment
    class Adder:
        def __init__(self, base):
            self.base = base

        def __call__(self, x):
            return self.base + x

    @serve.deployment
    def double(x):
        return 2 * x

    @serve.deployment
    class Tokenizer:
        def __call__(self, text):
            return text.split()

    @serve.deployment
    class Pipeline:
        def __init__(self, tok):
            self.tok = tok

        def __call__(self, text):
            return len(self.tok.remote(text).result())

    h = serve.run(Echo.bind(), name="echo", route_prefix=None)
    assert h.remote("hi").result() == "echo:hi"
    assert h.shout.remote("hi").result() == "ECHO:hi"
    assert serve.run(Adder.bind(10), name="add",
                     route_prefix=None).remote(5).result() == 15
    assert serve.run(double.bind(), name="fn",
                     route_prefix=None).remote(21).result() == 42
    h = serve.run(Pipeline.bind(Tokenizer.bind()), name="pipe",
                  route_prefix=None)
    assert h.remote("a b c d").result() == 4


def test_replicas_share_load_status_and_delete(rt):
    @serve.deployment(num_replicas=3)
    class WhoAmI:
        def __init__(self):
            import uuid

            self.id = uuid.uuid4().hex

        def __call__(self):
            return self.id

    handle = serve.run(WhoAmI.bind(), route_prefix=None)
    st = serve.status()
    assert st["WhoAmI"].status == "HEALTHY"
    assert st["WhoAmI"].replica_states.get("RUNNING") == 3
    assert len({handle.remote().result() for _ in range(40)}) >= 2
    serve.delete()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and serve.status():
        time.sleep(0.05)
    assert serve.status() == {}


def test_rolling_update_version_change(rt):
    def make(tag):
        @serve.deployment(name="V", version=tag)
        class V:
            def __call__(self):
                return tag

        return V

    h = serve.run(make("v1").bind(), route_prefix=None)
    assert h.remote().result() == "v1"
    h = serve.run(make("v2").bind(), route_prefix=None)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and h.remote().result() != "v2":
        time.sleep(0.05)
    assert h.remote().result() == "v2"


def test_batching(rt):
    @serve.deployment(max_ongoing_requests=16)
    class Batched:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.1)
        def __call__(self, xs):
            self.batch_sizes.append(len(xs))
            return [x * 2 for x in xs]

        def sizes(self):
            return self.batch_sizes

    handle = serve.run(Batched.bind(), route_prefix=None)
    results = [None] * 8

    def call(i):
        results[i] = handle.remote(i).result()

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == [i * 2 for i in range(8)]
    assert max(handle.sizes.remote().result()) > 1


def test_autoscaling_up_and_down(rt):
    @serve.deployment(
        max_ongoing_requests=4,
        autoscaling_config=dict(min_replicas=1, max_replicas=3,
                                target_ongoing_requests=1.0,
                                upscale_delay_s=0.1, downscale_delay_s=0.3,
                                metrics_interval_s=0.05),
        health_check_period_s=10.0)
    class Slow:
        def __call__(self):
            time.sleep(0.2)
            return "done"

    handle = serve.run(Slow.bind(), route_prefix=None)
    assert serve.status()["Slow"].replica_states.get("RUNNING") == 1
    stop = time.monotonic() + 2.0

    def load():
        while time.monotonic() < stop:
            handle.remote().result()

    threads = [threading.Thread(target=load) for _ in range(6)]
    for t in threads:
        t.start()
    peak = 1
    while time.monotonic() < stop:
        peak = max(peak, serve.status()["Slow"].replica_states.get(
            "RUNNING", 0))
        time.sleep(0.05)
    for t in threads:
        t.join()
    assert peak >= 2
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        st = serve.status()["Slow"]
        if st.replica_states == {"RUNNING": 1} and st.status == "HEALTHY":
            break
        time.sleep(0.05)
    assert serve.status()["Slow"].replica_states == {"RUNNING": 1}


@pytest.mark.parametrize("how", ["health_check", "killed"])
def test_failed_replica_is_replaced(rt, how):
    """A replica failing its health checks, or killed outright, is
    replaced; calls keep being answered."""
    from ray_tpu_torch.serve.handle import CONTROLLER_NAME, SERVE_NAMESPACE

    @serve.deployment(num_replicas=1, health_check_period_s=0.1,
                      max_ongoing_requests=4)
    class Flaky:
        def __init__(self):
            self.healthy = True

        def poison(self):
            self.healthy = False

        def check_health(self):
            if not self.healthy:
                raise RuntimeError("poisoned")

        def __call__(self):
            return "alive"

    handle = serve.run(Flaky.bind(), route_prefix=None)
    assert handle.remote().result() == "alive"
    ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
    first = ray_tpu_torch.get(ctrl.get_replicas.remote("Flaky"))[0]
    if how == "killed":
        ray_tpu_torch.kill(ray_tpu_torch.get_actor(first.actor_name,
                                                   namespace="serve"))
    else:
        handle.poison.remote().result()
    deadline = time.monotonic() + 15
    replaced = False
    while time.monotonic() < deadline and not replaced:
        try:
            ok = handle.remote().result(timeout=5) == "alive"
        except Exception:  # noqa: BLE001 - the replica is being replaced
            ok = False
        now = ray_tpu_torch.get(ctrl.get_replicas.remote("Flaky"))
        replaced = ok and [r.replica_id for r in now] != [first.replica_id] \
            and serve.status()["Flaky"].status == "HEALTHY" and len(now) == 1
        time.sleep(0.05)
    assert replaced


def test_http_ingress_handle_and_sse_streaming(rt):
    @serve.deployment
    class App:
        def __call__(self, request: serve.Request):
            if request.path == "/events":
                def gen():
                    for i in range(4):
                        yield f"data: tick{i}\n\n"
                        time.sleep(0.05)
                return gen()
            if request.method == "POST":
                data = request.json()
                return {"sum": data["a"] + data["b"]}
            return {"path": request.path,
                    "q": request.query_params.get("q")}

        def chunks(self, n):
            for i in range(n):
                yield f"c{i}"

        def whole(self):
            return "complete"

    h = serve.run(App.bind(), route_prefix="/", http=True)
    port = serve.http_port()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/x/y?q=hello",
                                timeout=30) as r:
        assert json.loads(r.read()) == {"path": "/x/y", "q": "hello"}
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/", method="POST",
        data=json.dumps({"a": 2, "b": 3}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert json.loads(r.read()) == {"sum": 5}

    gen = h.options(method_name="chunks", stream=True).remote(3)
    assert gen.streaming and list(gen) == ["c0", "c1", "c2"]
    gen2 = h.options(method_name="whole", stream=True).remote()
    assert not gen2.streaming and next(gen2) == "complete"

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/events",
                                timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        t0, first_at, body = time.monotonic(), None, b""
        while True:
            chunk = r.read1(256)
            if not chunk:
                break
            if first_at is None:
                first_at = time.monotonic() - t0
            body += chunk
    assert all(f"tick{i}" in body.decode() for i in range(4))
    assert first_at is not None and first_at < 0.15  # incremental


def test_client_closing_a_stream_after_two_frames(rt):
    """The client reads two SSE frames and closes: the router's slot comes
    back, the replica's generator is closed (its finally runs) instead of
    producing the other frames, and the next request is served."""
    @serve.deployment(max_ongoing_requests=2)
    class Ticker:
        def __init__(self):
            self.produced = 0
            self.closed = threading.Event()

        def __call__(self, request: serve.Request):
            def gen():
                try:
                    for i in range(200):
                        self.produced += 1
                        yield f"data: {i}\n\n"
                        time.sleep(0.01)
                finally:
                    self.closed.set()
            return gen()

        def report(self):
            return self.produced, self.closed.is_set()

    h = serve.run(Ticker.bind(), route_prefix="/", http=True)
    port = serve.http_port()
    r = urllib.request.urlopen(f"http://127.0.0.1:{port}/t", timeout=30)
    frames = [r.readline(), r.readline(), r.readline(), r.readline()]
    assert frames[0] == b"data: 0\n" and frames[2] == b"data: 1\n"
    r.close()
    deadline = time.monotonic() + 10
    produced, closed = h.report.remote().result()
    while not closed and time.monotonic() < deadline:
        time.sleep(0.05)
        produced, closed = h.report.remote().result()
    assert closed and produced < 200
    router = h._ensure_router()
    deadline = time.monotonic() + 10
    while any(router.metrics().values()) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not any(router.metrics().values())
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/t",
                                timeout=30) as r:
        assert r.read().count(b"data:") == 200


def test_model_multiplexing_and_lru_eviction(rt):
    @serve.deployment(num_replicas=2, max_ongoing_requests=8)
    class MuxServer:
        def __init__(self):
            self.load_counts = {}

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            self.load_counts[model_id] = self.load_counts.get(model_id, 0) + 1
            return {"id": model_id, "weights": model_id.upper()}

        def predict(self, x):
            return f"{self.get_model()['weights']}:{x}"

        def which(self):
            self.get_model()
            return serve.get_multiplexed_model_id()

        def loads(self):
            return dict(self.load_counts)

    h = serve.run(MuxServer.bind())
    _wait_running("MuxServer", 2)
    h1 = h.options(method_name="predict", multiplexed_model_id="m1")
    assert h1.remote("a").result() == "M1:a"
    assert h.options(method_name="predict",
                     multiplexed_model_id="m2").remote("b").result() == "M2:b"
    for _ in range(4):
        assert h1.remote("c").result() == "M1:c"
    counts = h.options(method_name="loads",
                       multiplexed_model_id="m1").remote().result()
    assert counts.get("m1") == 1  # loaded once on its home replica
    for mid in ("x", "y", "z", "x"):  # LRU of 2: z evicts x, x evicts y
        assert h.options(method_name="which",
                         multiplexed_model_id=mid).remote().result() == mid


def _wait_running(name: str, n: int) -> None:
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        st = serve.status().get(name)
        if st is not None and st.replica_states == {"RUNNING": n}:
            return
        time.sleep(0.02)
    raise AssertionError(f"{name}: {serve.status()}")


def test_route_hint_affinity(rt):
    """The same route hint lands on one replica while it has capacity.
    Every replica is RUNNING before the calls (a replica turning RUNNING
    mid-loop changes the hint's ranking), and each call waits until the
    router has released the last one (an answered call's slot is released
    by the router's reaper a moment later; slots piling up past
    HINT_BALANCE_DELTA rightly send the hint elsewhere)."""
    @serve.deployment(num_replicas=3, max_ongoing_requests=8)
    class Who:
        def __call__(self, _req=None):
            return id(self)

    h = serve.run(Who.bind())
    _wait_running("Who", 3)
    router = h._ensure_router()
    deadline = time.monotonic() + 10
    while len(router._get_replicas()) < 3 and time.monotonic() < deadline:
        time.sleep(0.02)
    tags = set()
    for _ in range(6):
        while any(router.metrics().values()) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        tags.add(h.options(route_hint="prefix-xyz").remote().result())
    assert len(tags) == 1


def test_refusals_raise_at_once(rt):
    """Each refusal raises before anything is deployed; the tracing rate,
    once refused, is now accepted and rides the resilience settings."""
    class X:
        def __call__(self):
            return 1

    t0 = time.monotonic()
    with pytest.raises(NotImplementedError, match="7\\(b\\)"):
        serve.deployment(placement_group_bundles=[{"GPU": 1}])(X)
    with pytest.raises(NotImplementedError, match="7\\(b\\)"):
        serve.deployment(X).options(placement_group_bundles=[{"CPU": 1}])
    traced = serve.deployment(trace_sample_rate=1.0)(X)
    assert traced.config.resilience_settings().to_dict()[
        "trace_sample_rate"] == 1.0
    for call in (lambda: serve.start(grpc_options={"port": 0}),
                 lambda: serve.run(serve.deployment(X).bind(), grpc=True),
                 serve.grpc_port):
        with pytest.raises(NotImplementedError, match="grpcio"):
            call()
    with pytest.raises(ValueError, match="GPU"):
        serve.run(serve.deployment(ray_actor_options={"num_gpus": 1})(
            X).bind(), _blocking_timeout=60)
    assert time.monotonic() - t0 < 2
    assert not _controller_exists()  # nothing was started


def _controller_exists() -> bool:
    from ray_tpu_torch.serve.handle import CONTROLLER_NAME, SERVE_NAMESPACE

    try:
        ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
        return True
    except ValueError:
        return False


def test_num_gpus_replicas_take_the_gpu_resource():
    """ray_actor_options num_gpus (the counterpart of num_tpus) demands the
    runtime's "GPU" resource: two replicas of 0.5 fit on one."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, resources={"GPU": 1})
    try:
        @serve.deployment(num_replicas=2,
                          ray_actor_options={"num_gpus": 0.5})
        class OnCard:
            def __call__(self):
                return ray_tpu_torch.get_runtime_context() \
                    .get_assigned_resources()

        h = serve.run(OnCard.bind(), route_prefix=None)
        assert ray_tpu_torch.available_resources()["GPU"] == 0.0
        assert h.remote().result() == {"GPU": 0.5}
        serve.shutdown()
        assert ray_tpu_torch.available_resources()["GPU"] == 1.0
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


def test_shutdown_gives_the_replicas_gpu_back_20_times():
    """serve.shutdown() returns only once its replicas' resources are back
    (the controller drops a killed replica when its thread has released
    them): right after each of 20 shutdowns the GPU is whole."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, resources={"GPU": 1})
    try:
        for i in range(20):
            @serve.deployment(num_replicas=2,
                              ray_actor_options={"num_gpus": 0.5})
            class OnCard:
                def __call__(self):
                    return 1

            h = serve.run(OnCard.bind(), route_prefix=None)
            assert h.remote().result() == 1
            serve.shutdown()
            assert ray_tpu_torch.available_resources()["GPU"] == 1.0, i
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
