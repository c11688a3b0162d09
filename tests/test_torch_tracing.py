"""ray_tpu_torch.util.tracing and the spans of the port's runtime, Serve and
LLM engine against ray_tpu's, on the CPU.

Pure parts agree exactly: ``LatencyWindow`` over latencies drawn from a
numpy seed, ``sample_request`` on one seeded draw, the tail ring's bounds,
TTL and keeps under an injected clock, ``inject``/``adopt``/
``propagate_only``, ``flush_new`` and the OTLP export (service and scope
names aside). Span trees are equal once ids and timestamps are stripped
(names, kinds, statuses, parent links, which buffer holds them — the main
buffer or the tail ring — and attributes, with the per-run values of
replica ids, task and request ids and latencies masked): a task calling an
actor under a root span, one Serve request at rate 1.0, a request ended by
its deadline at rate 0.0 (kept by the tail), a batched deployment, and the
tiny Llama engine's submit at rates 0 and 1, each driven through both
runtimes. With tracing off, a Serve request and an engine request make no
span at all; concurrent requests never share a trace id.
"""

import random
import threading
import time
from collections import defaultdict
from dataclasses import asdict

import jax
import numpy as np
import pytest

import ray_tpu
import ray_tpu.util.tracing as jt
import ray_tpu_torch
import ray_tpu_torch.util.tracing as pt
from ray_tpu import serve as jserve
from ray_tpu_torch import serve as pserve

SIDES = {"jax": (ray_tpu, jt, jserve), "torch": (ray_tpu_torch, pt, pserve)}
# Attribute values that differ run to run (ids, clocks); their keys stay.
VOLATILE = ("latency_s", "queue_wait_s", "replica", "task_id",
            "request_id")


def _fresh(t):
    """Both modules as on import: ``clear()`` keeps the flush cursor's
    base and the metered drops, which earlier tests of this process
    may have moved."""
    t.clear()
    t.disable_tracing()
    t.configure_tail(max_traces=512, max_spans_per_trace=64, ttl_s=30.0)
    with t._lock:
        t._spans_total = 0
        t._dropped_metered = 0


@pytest.fixture(autouse=True)
def _clean_tracing():
    for t in (jt, pt):
        _fresh(t)
    yield
    for t in (jt, pt):
        _fresh(t)


def _all_spans(t) -> list[dict]:
    """Every finished span with where it sits: the main buffer or the
    tail ring (unsampled, not kept)."""
    out = [dict(asdict(s), where="main") for s in t.spans()]
    with t._lock:
        ring = [s for _, r in t._tail.values() for s in r]
    return out + [dict(asdict(s), where="tail") for s in ring]


def _tree(spans: list[dict]) -> tuple:
    """The trace with ids and timestamps stripped: nested by parent link,
    children in a canonical order."""
    ids = {s["span_id"] for s in spans}
    kids = defaultdict(list)
    for s in spans:
        kids[s["parent_id"] if s["parent_id"] in ids else None].append(s)

    def node(s):
        attrs = tuple(sorted((k, "*" if k in VOLATILE else str(v))
                             for k, v in s["attributes"].items()))
        return (s["name"], s["kind"], s["status"], s["where"], attrs,
                tuple(sorted(e["name"] for e in s["events"])),
                s["parent_id"] is not None,
                tuple(sorted(node(c) for c in kids[s["span_id"]])))

    return tuple(sorted(node(s) for s in kids[None]))


def _trace_of(spans: list[dict], root_name: str) -> list[dict]:
    roots = [s for s in spans if s["name"] == root_name]
    assert len(roots) == 1, [s["name"] for s in spans]
    return [s for s in spans if s["trace_id"] == roots[0]["trace_id"]]


# ------------------------------------------------------------ pure parts

@pytest.mark.parametrize("seed", [0, 1])
def test_latency_window_matches_jax(seed):
    lat = np.random.default_rng(seed).lognormal(-3.0, 0.7, 700)
    out = []
    for t in (jt, pt):
        w = t.LatencyWindow(size=128, min_samples=32, refresh=16)
        out.append(([w.observe(float(v)) for v in lat], w.p99()))
    assert out[1] == out[0]
    assert any(out[1][0])


def test_sample_request_matches_jax_on_one_seeded_draw(monkeypatch):
    out = []
    for t in (jt, pt):
        monkeypatch.setattr(t, "_rand", random.Random(7).random)
        out.append([t.sample_request(r) for r in
                    np.linspace(-0.5, 1.5, 200)])
    assert out[1] == out[0]
    assert True in out[1] and False in out[1]


class _Clock:
    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t

    def time(self):
        return self.t


def _ring_program(t, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(t, "time", clock)
    t._tail_scan_ts = 0.0
    t.configure_tail(max_traces=3, max_spans_per_trace=2, ttl_s=4.0)
    log = []

    def put(tid, name):
        t.record_span(name, clock.t, clock.t,
                      ctx={"trace_id": tid, "parent_span_id": None,
                           "sampled": False})

    for i in range(5):  # 5 traces into a 3-trace ring: 2 evicted
        put(f"tr{i}", "a")
        put(f"tr{i}", "b")
        put(f"tr{i}", "c")  # over the per-trace bound: dropped
        clock.t += 1.0
        log.append(t.tail_stats())
    clock.t += 3.5  # tr2 ages past the TTL at the next put
    put("tr9", "late")
    log.append(t.tail_stats())
    t.mark_keep("tr4", "slow")
    t.mark_keep("tr0", "evicted")  # nothing ringed: keep recorded only
    t.apply_keeps(["tr3"])
    put("tr4", "after_keep")  # a kept trace's late span goes straight in
    log.append(t.tail_stats())
    log.append(sorted((s.trace_id, s.name) for s in t.spans()))
    log.append(t.drain_keeps())
    t.requeue_keeps([{"trace_id": "x", "reason": "r"}])
    log.append(t.drain_keeps())
    log.append(t.dropped_spans())
    return log


def test_tail_ring_bounds_ttl_and_keeps_match_jax(monkeypatch):
    want = _ring_program(jt, monkeypatch)
    got = _ring_program(pt, monkeypatch)
    assert got == want
    assert got[5]["dropped"] > 0  # evictions and TTL expiry both count


def test_inject_adopt_and_propagate_only_match_jax():
    def program(t):
        out = [t.inject()]  # gate off: None
        t.enable_tracing()
        root = t.inject()
        out.append((sorted(root), root["parent_span_id"]))
        t.adopt({"trace_id": "abc", "parent_span_id": "p1",
                 "sampled": "false"})
        out.append((t.current_context(), t.current_sampled(), t.inject()))
        with t.propagate_only({"trace_id": "def", "parent_span_id": "p2",
                               "sampled": True}):
            out.append(t.inject())
        out.append(t.inject())
        t.adopt(None)
        out.append(t.current_context())
        with t.span("s", ctx={"trace_id": "ghi", "parent_span_id": None,
                              "sampled": False}) as s:
            inner = t.inject()
            out.append((inner["trace_id"], inner["sampled"],
                        inner["parent_span_id"] == s.span_id))
        out.append(t.task_span("x", None) is t._NULL_SPAN)
        t.disable_tracing()
        out.append((t.task_span("x", None) is t._NULL_SPAN,
                    t.span("x") is t._NULL_SPAN,
                    t.record_span("x", 0.0, 1.0) is None))
        return out

    assert program(pt) == program(jt)


def test_flush_new_and_otlp_export_match_jax():
    def program(t):
        t.enable_tracing()
        ctx = {"trace_id": "t" * 32, "parent_span_id": None,
               "sampled": True}
        for i in range(5):
            s = t.start_span(f"op{i}", kind=("client", "worker",
                                             "internal")[i % 3],
                             attributes={"i": i, "obj": [i]}, ctx=ctx)
            s.start_ts, s.end_ts = 10.0 + i, 10.5 + i
            s.add_event("ev", {"k": i})
            s.events[-1]["ts"] = 11.0 + i
            t.finish_span(s, status="OK" if i % 2 else "ERROR: X")
        batch, cursor = t.flush_new(0, limit=3)
        rest, cursor2 = t.flush_new(cursor)
        strip = lambda rows: [{k: v for k, v in r.items()  # noqa: E731
                               if k != "span_id"} for r in rows]
        otlp = t.export_otlp()
        spans = otlp["resourceSpans"][0]["scopeSpans"][0]["spans"]
        for s in spans:
            s.pop("spanId")
        return (strip(batch), cursor, strip(rest), cursor2, spans,
                [{k: v for k, v in d.items() if k != "span_id"}
                 for d in t.export()])

    assert program(pt) == program(jt)
    names = pt.export_otlp()["resourceSpans"][0]
    assert names["scopeSpans"][0]["scope"]["name"] == "ray_tpu_torch.tracing"


# ------------------------------------------------------- span trees

def _runtime_tree(side):
    rt, t, _ = SIDES[side]
    rt.shutdown()
    rt.init(num_cpus=4)
    try:
        @rt.remote
        class Adder:
            def add(self, x):
                return x + 1

        a = Adder.remote()
        assert rt.get(a.add.remote(0)) == 1  # created before tracing

        @rt.remote
        def call_actor(actor):
            return rt.get(actor.add.remote(1))

        t.enable_tracing()
        with t.span("root", attributes={"side": "both"}):
            assert rt.get(call_actor.remote(a)) == 2
        t.disable_tracing()
        return _tree(_trace_of(_all_spans(t), "root"))
    finally:
        rt.shutdown()


def test_task_calling_an_actor_under_a_root_span_matches_jax():
    got, want = _runtime_tree("torch"), _runtime_tree("jax")
    assert got == want
    (root,) = got
    assert root[0] == "root" and root[-1][0][0] == "call_actor"
    assert root[-1][0][-1][0][0] == "add"  # the actor call, one level down


def _serve_traces(side, make_app, drive):
    rt, t, serve = SIDES[side]
    rt.shutdown()
    rt.init(num_cpus=8)
    try:
        h = serve.run(make_app(serve), name="app")
        drive(h, t, warm=True)  # replicas up, untraced
        t.clear()
        t.enable_tracing()
        out = drive(h, t, warm=False)
        t.disable_tracing()
        return out, _all_spans(t)
    finally:
        serve.shutdown()
        rt.shutdown()


def _doubler(rate):
    def make(serve):
        @serve.deployment(trace_sample_rate=rate, max_ongoing_requests=8)
        class Doubler:
            def __call__(self, x):
                if x < 0:
                    time.sleep(0.4)  # outlives its deadline
                return 2 * x
        return Doubler.bind()
    return make


def test_serve_request_at_rate_one_matches_jax():
    def drive(h, t, warm):
        return h.remote(3).result(timeout=30)

    trees = {}
    for side in ("jax", "torch"):
        out, spans = _serve_traces(side, _doubler(1.0), drive)
        assert out == 6
        trees[side] = _tree(_trace_of(spans, "serve.request.Doubler"))
    assert trees["torch"] == trees["jax"]
    (root,) = trees["torch"]
    assert (root[0], root[3]) == ("serve.request.Doubler", "main")
    (attempt,) = root[-1]
    assert attempt[0] == "serve.attempt.Doubler"
    assert attempt[-1][0][0] == "handle_request"  # the replica's span


def test_unsampled_request_ended_by_its_deadline_is_tail_kept_as_in_jax():
    def drive(h, t, warm):
        if warm:
            return h.remote(1).result(timeout=30)
        assert h.remote(5).result(timeout=30) == 10  # unsampled: ringed
        with pytest.raises(Exception) as err:
            h.options(timeout_s=0.1).remote(-1).result(timeout=30)
        time.sleep(0.6)  # the replica's span ends after the keep
        return (type(err.value).__name__, len(t.spans()),
                t.tail_stats()["kept"], t.drain_keeps())

    trees = {}
    for side in ("jax", "torch"):
        (err, main, kept, keeps), spans = _serve_traces(side, _doubler(0.0),
                                                        drive)
        assert err == "DeadlineExceeded" and kept == 1
        assert [k["reason"] for k in keeps] == ["expired"]
        kept_ids = {k["trace_id"] for k in keeps}
        trees[side] = (
            _tree([s for s in spans if s["trace_id"] in kept_ids]),
            sorted(s["name"] for s in spans if s["where"] == "main"
                   and s["trace_id"] not in kept_ids
                   and s["name"].startswith("serve.")))
    assert trees["torch"] == trees["jax"]
    (root,) = trees["torch"][0]
    assert root[3] == "main" and "tail_keep" in root[5]
    assert trees["torch"][1] == []  # the sampled-out request stays ringed


def test_batched_deployment_trace_matches_jax():
    def make(serve):
        @serve.deployment(trace_sample_rate=1.0, max_ongoing_requests=8)
        class Batched:
            @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.01)
            def __call__(self, xs):
                return [x + 100 for x in xs]
        return Batched.bind()

    def drive(h, t, warm):
        out = h.remote(1).result(timeout=30)
        # The batch loop records each item's span after it has handed the
        # results out (in both packages): wait for it.
        deadline = time.monotonic() + 10
        while not warm and time.monotonic() < deadline and not any(
                s.name == "serve.batch_item" for s in t.spans()):
            time.sleep(0.01)
        return out

    trees = {}
    for side in ("jax", "torch"):
        out, spans = _serve_traces(side, make, drive)
        assert out == 101
        trees[side] = _tree(_trace_of(spans, "serve.request.Batched"))
    assert trees["torch"] == trees["jax"]
    leaf = trees["torch"][0][-1][0][-1][0][-1][0]
    assert leaf[0] == "serve.batch_item"
    assert ("batch_size", "1") in leaf[4]


def test_concurrent_serve_requests_never_share_a_trace():
    def make(serve):
        @serve.deployment(trace_sample_rate=1.0, max_ongoing_requests=8)
        class Echo:
            def __call__(self, i):
                from ray_tpu_torch.util import tracing
                time.sleep(0.05)  # overlap the requests on the replica
                return i, tracing.current_trace_id()
        return Echo.bind()

    def drive(h, t, warm):
        responses = [h.remote(i) for i in range(8)]
        return [r.result(timeout=30) for r in responses]

    out, spans = _serve_traces("torch", make, drive)
    roots = {s["span_id"]: s["trace_id"] for s in spans
             if s["name"] == "serve.request.Echo"}
    tids = [tid for _, tid in out]
    assert len(set(tids)) == 8 and set(tids) == set(roots.values())


# ------------------------------------------------------------ the engine

@pytest.fixture(scope="module")
def engines():
    from ray_tpu.llm import LLMConfig as JaxLLMConfig
    from ray_tpu.llm import LLMEngine as JaxLLMEngine
    from ray_tpu.models.llama import init_params as jax_init_params
    from ray_tpu_torch.llm import LLMConfig, LLMEngine
    from ray_tpu_torch.models.llama import params_from_jax

    jcfg = JaxLLMConfig(model="tiny", max_num_seqs=2, max_seq_len=64)
    jp = jax_init_params(jcfg.model_config(), jax.random.PRNGKey(0))
    jeng = JaxLLMEngine(jcfg, params=jp)
    teng = LLMEngine(LLMConfig(model="tiny", max_num_seqs=2, max_seq_len=64),
                     params=params_from_jax(jp, device="cpu"), device="cpu")
    yield {"jax": jeng, "torch": teng}
    jeng.shutdown()
    teng.shutdown()


def _engine_tree(side, eng, sampled):
    from ray_tpu.llm import SamplingParams as JaxSP
    from ray_tpu_torch.llm import SamplingParams

    t = SIDES[side][1]
    sp = (JaxSP if side == "jax" else SamplingParams)(max_tokens=4,
                                                      temperature=0.0)
    eng.generate([5, 7, 11, 13], sp)  # warm: compiled, untraced
    t.clear()
    t.enable_tracing()
    ctx = {"trace_id": "e" * 32, "parent_span_id": None, "sampled": sampled}
    with t.span("client.submit", ctx=ctx):
        req = eng.submit([5, 7, 11, 13], sp)
    assert req.done.wait(60) and req.error is None
    t.disable_tracing()
    before = _tree(_all_spans(t))
    t.mark_keep("e" * 32, "test")
    return before, _tree(_all_spans(t)), req.out_tokens


@pytest.mark.parametrize("sampled", [True, False])
def test_engine_submit_trace_matches_jax(engines, sampled):
    want = _engine_tree("jax", engines["jax"], sampled)
    got = _engine_tree("torch", engines["torch"], sampled)
    assert got[2] == want[2]  # the same greedy tokens
    assert got[:2] == want[:2]
    (root,) = got[0]
    assert root[3] == ("main" if sampled else "tail")
    assert [k[0] for k in root[-1]] == ["engine.decode", "engine.prefill",
                                        "engine.queue"]
    assert {k[3] for k in got[1][0][-1]} == {"main"}  # kept: promoted


def test_concurrent_engine_requests_never_share_a_trace(engines):
    from ray_tpu_torch.llm import SamplingParams

    eng = engines["torch"]
    pt.enable_tracing()
    barrier = threading.Barrier(2)
    got = {}

    def client(i):
        with pt.span(f"client{i}") as s:
            barrier.wait()
            req = eng.submit([3 + i, 9, 4], SamplingParams(max_tokens=3))
            got[i] = (s.trace_id, req)

    ts = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for th in ts:
        th.start()
    for th in ts:
        th.join()
    for _, req in got.values():
        assert req.done.wait(60)
    pt.disable_tracing()
    assert got[0][0] != got[1][0]
    for tid, req in got.values():
        assert req.trace_ctx["trace_id"] == tid
        names = {s.name for s in pt.spans() if s.trace_id == tid}
        assert {"engine.queue", "engine.prefill", "engine.decode"} <= names


def test_tracing_off_takes_the_null_path(engines, monkeypatch):
    """Gate off: a Serve request and an engine request build no Span, the
    engine request carries no context, and both buffers stay empty."""
    from ray_tpu_torch.llm import SamplingParams

    made = []
    real = pt.Span

    def counting_span(*a, **k):
        made.append(k.get("name"))
        return real(*a, **k)

    monkeypatch.setattr(pt, "Span", counting_span)
    req = engines["torch"].submit([1, 2, 3], SamplingParams(max_tokens=2))
    assert req.done.wait(60) and req.trace_ctx is None
    out, spans = _serve_traces(
        "torch", _doubler(1.0),
        lambda h, t, warm: (t.disable_tracing(),
                            h.remote(2).result(timeout=30))[1])
    assert out == 4
    assert made == [] and spans == []
    assert pt.tail_stats()["spans"] == 0
