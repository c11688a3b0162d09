"""ray_tpu_torch.profiling and util.state's in-process verbs against
ray_tpu's, on the CPU.

Pure functions agree exactly on inputs drawn from a numpy seed:
``merge_chrome_trace``, ``merge_flamegraph``, ``build_report`` and
``format_report``, and the stack sampler's collapsed stacks of one parked
thread. ``capture_profile``'s bundle and ``memory_snapshot`` have ray_tpu's
keys and skip markers (here the device trace is skipped: this torch has no
CUDA, as ray_tpu's is on a cpu backend); the ``busy`` refusal, the
duration ceiling and a replica's capture behave the same. A capture's
device trace joins the merged chrome trace as kernel rows (a synthetic
torch.profiler trace file here; the card's own in
tests/test_torch_profiling_cuda.py, which skips here). ``stragglers()``, ``get_goodput``, ``get_stack``,
``stack_cluster``, ``device_memory`` and ``profile_cluster`` answer as
ray_tpu's in-process runtime does.
"""

import json
import os
import tempfile
import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu.profiling as jax_prof
import ray_tpu.profiling.capture as jax_capture
import ray_tpu.profiling.memory as jax_memory
import ray_tpu.profiling.sampler as jax_sampler
import ray_tpu.profiling.straggler as jax_straggler
import ray_tpu.train.session as jax_session
import ray_tpu.util.state as jax_state
import ray_tpu.utils.config as jax_config
import ray_tpu_torch
import ray_tpu_torch.profiling as port_prof
import ray_tpu_torch.profiling.capture as port_capture
import ray_tpu_torch.profiling.memory as port_memory
import ray_tpu_torch.profiling.sampler as port_sampler
import ray_tpu_torch.profiling.straggler as port_straggler
import ray_tpu_torch.train.session as port_session
import ray_tpu_torch.util.state as port_state
import ray_tpu_torch.utils.config as port_config
from ray_tpu_torch.profiling.merge import device_events


def _captures(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    caps = []
    for i in range(3):
        frames = [f"f{int(j)} (m.py:{int(j)})"
                  for j in rng.integers(0, 6, 4)]
        collapsed = "\n".join(
            f"MainThread;{';'.join(frames[:k + 1])} {int(rng.integers(1, 50))}"
            for k in range(4))
        caps.append({
            "meta": {"kind": ("worker", "driver")[i % 2],
                     "worker_id": f"w{i:08d}", "node_id": f"node{i}xyz"},
            "pid": 100 + i, "sample_hz": float(rng.choice([50, 100])),
            "collapsed": collapsed,
            "sample_events": [{"ts": 1000.0 + float(rng.uniform(0, 1)),
                               "thread": "MainThread", "leaf": frames[-1]}
                              for _ in range(5)],
            "memory_before": {"ts": 1000.0, "rss_bytes": int(
                rng.integers(1, 1 << 30))},
            "memory": {"ts": 1001.0, "rss_bytes": int(
                rng.integers(1, 1 << 30))},
            "xla_trace": {"status": "skipped", "reason": "cpu-only"},
        })
    caps.append({"error": "busy", "reason": "x"})  # refused: skipped
    return caps


def _spans(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed + 7)
    out = []
    for i in range(8):
        t0 = 1000.0 + float(rng.uniform(0, 1))
        name = ("goodput.step_compute", "serve.request.d", "task")[i % 3]
        out.append({"trace_id": f"t{i % 3:015d}", "span_id": f"s{i}",
                    "parent_id": None, "name": name, "kind": "internal",
                    "start_ts": t0, "end_ts": t0 + float(rng.uniform(0, 1)),
                    "status": "OK",
                    "attributes": {"run": "r", "rank": i % 2}})
    out.append(dict(out[0]))  # a duplicate span: deduplicated
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_mergers_match_jax_exactly(seed):
    caps, spans = _captures(seed), _spans(seed)
    assert port_prof.merge_flamegraph(caps) == \
        jax_prof.merge_flamegraph(caps)
    assert port_prof.merge_chrome_trace(caps, spans) == \
        jax_prof.merge_chrome_trace(caps, spans)
    assert port_prof.merge_chrome_trace(caps) == \
        jax_prof.merge_chrome_trace(caps)


def test_write_artifacts_match_jax(tmp_path):
    caps, spans = _captures(3), _spans(3)
    res = {"captures": caps, "spans": spans, "errors": {"x": "busy"}}
    paths = {side: mod.write_artifacts(res, str(tmp_path / side))
             for side, mod in (("jax", jax_prof), ("torch", port_prof))}
    for key in ("trace", "flamegraph", "memory", "captures"):
        with open(paths["jax"][key]) as a, open(paths["torch"][key]) as b:
            assert b.read() == a.read(), key


def _sources(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    now = time.time()
    out = {}
    for src in range(2):
        stats = {}
        for rank in range(src * 3, src * 3 + 3):
            base = float(rng.uniform(0.1, 0.2)) * (4.0 if rank == 4 else 1)
            deciles = sorted(float(base * rng.uniform(0.9, 1.1))
                             for _ in range(11))
            stats[str(rank)] = {
                "steps": int(rng.integers(10, 100)), "deciles": deciles,
                "median_step_s": deciles[5],
                "sync_share": float(rng.uniform(0, 0.5)),
                "compute_share": float(rng.uniform(0.5, 1)),
                "world_size": 6}
        out[f"src{src}"] = {"node_id": f"host{src}", "ts": now,
                            "stats": stats}
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_report_matches_jax_exactly(seed):
    sources = _sources(seed)
    want = jax_straggler.build_report(sources)
    got = port_straggler.build_report(sources)
    assert got == want
    assert port_straggler.format_report(got) == \
        jax_straggler.format_report(want)
    assert got["workers"][0]["rank"] == 4  # the slowest step time


def test_sampler_collapsed_stacks_match_jax():
    parked = threading.Event()
    release = threading.Event()

    def park_here():
        parked.set()
        release.wait(10)

    t = threading.Thread(target=park_here, name="parked-worker")
    t.start()
    parked.wait(5)
    try:
        me = threading.get_ident()
        out = []
        for mod in (jax_sampler, port_sampler):
            s = mod.StackSampler(hz=100)
            s._sample_once(me)
            out.append([line for line in s.collapsed().splitlines()
                        if line.startswith("parked-worker;")])
    finally:
        release.set()
        t.join()
    assert out[0] and out[1] == out[0]
    assert "park_here (test_torch_profiling.py:" in out[1][0]
    assert "parked-worker" in port_sampler.dump_stacks()


def _bundle_shape(cap: dict) -> tuple:
    return (sorted(cap), sorted(cap["xla_trace"]), cap["xla_trace"]["status"],
            sorted(cap["memory"]), sorted(cap["memory_before"]))


def test_capture_bundle_has_jax_s_keys_and_skip_marker():
    want = jax_capture.capture_profile(0.1, meta={"kind": "driver"})
    got = port_capture.capture_profile(0.1, meta={"kind": "driver"})
    assert _bundle_shape(got) == _bundle_shape(want)
    assert got["xla_trace"] == {
        "status": "skipped",
        "reason": "cpu-only backend (no CUDA device trace)"}
    assert "cpu-only" in want["xla_trace"]["reason"]
    assert got["samples"] >= 3 and got["sample_hz"] == want["sample_hz"]
    # No CUDA here: the device leg is the skip marker JAX gives a process
    # without a backend, with the same keys.
    assert got["memory"]["device"] == {
        "status": "skipped", "reason": "cuda not initialized in this process"}


def test_memory_snapshot_has_jax_s_keys(monkeypatch):
    want = jax_memory.memory_snapshot()
    got = port_memory.memory_snapshot()
    assert sorted(got) == sorted(want)
    assert got["rss_bytes"] > 0
    monkeypatch.setattr(jax_memory, "jax_backend_ready", lambda: False)
    skipped = jax_memory.memory_snapshot()["device"]
    assert sorted(got["device"]) == sorted(skipped)
    assert got["device"]["status"] == skipped["status"] == "skipped"
    assert not port_memory.cuda_ready() and port_memory.used_devices() == []


def _refusals(prof, capture):
    results = {}

    def long_capture():
        results["first"] = capture.capture_profile(0.4)

    t = threading.Thread(target=long_capture)
    t.start()
    time.sleep(0.1)
    second = capture.capture_profile(0.1)
    t.join()
    metric = prof.profiler_metrics()["dropped"]
    return (sorted(second), second["error"], bool(results["first"].get(
        "error")), metric._points()[metric._series_key({"reason": "busy"})]
        >= 1)


def test_busy_refusal_and_duration_ceiling_match_jax(monkeypatch):
    assert _refusals(port_prof, port_capture) == \
        _refusals(jax_prof, jax_capture)
    out = []
    for cfg_mod, capture in ((jax_config, jax_capture),
                             (port_config, port_capture)):
        monkeypatch.setattr(cfg_mod.get_config(), "profiler_max_capture_s",
                            0.2)
        t0 = time.monotonic()
        cap = capture.capture_profile(30.0)
        out.append((time.monotonic() - t0 < 2.0, cap["duration_s"] < 1.0))
    assert out[1] == out[0] == (True, True)


def test_a_second_torch_profiler_session_is_refused_busy():
    """Kineto takes one session a process: a capture while another
    torch.profiler session runs comes back busy, without touching it."""
    import torch

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        cap = port_capture.capture_profile(0.05)
    assert cap["error"] == "busy" and "torch.profiler" in cap["reason"]
    assert not port_capture.capture_profile(0.05).get("error")


def test_replica_profile_matches_jax():
    from ray_tpu.serve.replica import ServeReplica as JaxReplica
    from ray_tpu.utils import serialization as jax_ser
    from ray_tpu_torch.serve.replica import ServeReplica as PortReplica
    from ray_tpu_torch.utils import serialization as port_ser

    caps = []
    for cls, ser in ((JaxReplica, jax_ser), (PortReplica, port_ser)):
        rep = cls("profdep", "r1", ser.serialize(lambda x: x * 2),
                  ser.serialize(((), {})))
        caps.append(rep.profile(0.1))
    assert caps[1]["meta"] == caps[0]["meta"]
    assert _bundle_shape(caps[1]) == _bundle_shape(caps[0])
    assert caps[1]["samples"] > 0


def test_device_trace_rows_join_the_merged_trace(tmp_path):
    """A capture's device trace (a torch.profiler chrome trace with kernel,
    memcpy and CPU-op rows) adds its device rows, one row per stream, on
    the span timeline's epoch microseconds."""
    base_ns = 1_700_000_000 * 10 ** 9
    doc = {"baseTimeNanoseconds": base_ns, "traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "rms_norm_kernel",
         "ts": 10.0, "dur": 3.5, "pid": 0, "tid": 7,
         "args": {"device": 0, "stream": 7, "grid": [1, 1, 1]}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 20.0, "dur": 1.0, "pid": 0, "tid": 7,
         "args": {"device": 0, "stream": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 5.0,
         "dur": 9.0, "pid": 1, "tid": 1},
    ]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(doc))
    cap = _captures(0)[0]
    cap["started_at"] = base_ns / 1e9
    cap["xla_trace"] = {"status": "captured", "backend": "cuda",
                        **port_capture.read_device_trace(str(path))}
    trace = port_prof.merge_chrome_trace([cap], [])
    rows = [e for e in trace["traceEvents"]
            if str(e.get("pid", "")).startswith("device ")]
    kernels = [e for e in rows if e.get("ph") == "X"]
    assert [e["name"] for e in kernels] == ["rms_norm_kernel",
                                            "Memcpy HtoD"]
    assert kernels[0]["ts"] == base_ns / 1e3 + 10.0
    assert kernels[0]["tid"] == "stream 7"
    assert kernels[0]["args"] == {"device": 0, "stream": 7,
                                  "grid": [1, 1, 1]}
    # Without an epoch base the rows are laid from the capture's start.
    doc.pop("baseTimeNanoseconds")
    path.write_text(json.dumps(doc))
    cap["xla_trace"].update(port_capture.read_device_trace(str(path)))
    ev = [e for e in device_events(cap, "d") if e.get("ph") == "X"]
    assert ev[0]["ts"] == cap["started_at"] * 1e6


class _FakeSession:
    """Stands for a torch.profiler session: its export writes ``doc``."""

    def __init__(self, doc):
        self.doc = doc

    def __exit__(self, *exc):
        return False

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump(self.doc, f)


@pytest.mark.parametrize("kernels", [2, 0])
@pytest.mark.parametrize("keep", [True, False])
def test_device_trace_end_reads_counts_and_removes_its_scratch(
        tmp_path, monkeypatch, kernels, keep):
    """The exported trace is read into the bundle: its device rows and
    the kernel and launch counts. Launches without a kernel record make
    the trace ``partial``. A trace without a logdir leaves no file."""
    import torch

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    launch = {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
              "ts": 1.0, "dur": 2.0, "pid": 1, "tid": 1}
    kernel = {"ph": "X", "cat": "kernel", "name": "rms_norm_kernel",
              "ts": 4.0, "dur": 3.0, "pid": 0, "tid": 7,
              "args": {"device": 0, "stream": 7}}
    doc = {"baseTimeNanoseconds": 1_700_000_000 * 10 ** 9,
           "traceEvents": [launch, launch] + [kernel] * kernels}
    logdir = str(tmp_path / "keep") if keep else None
    state = {"status": "capturing", "backend": "cuda"}
    if keep:
        state["logdir"] = logdir
        os.makedirs(logdir)
    else:
        state["scratch"] = tempfile.mkdtemp(prefix="rtpu-device-trace-")
    out = port_capture._device_trace_end(state, _FakeSession(doc))
    assert (out["launches"], out["kernels"]) == (2, kernels)
    assert out["status"] == ("captured" if kernels else "partial")
    assert len(out["events"]) == kernels
    assert os.listdir(tmp_path / "tmp") == []
    assert ("trace_file" in out) == keep
    if keep:
        assert os.path.exists(os.path.join(logdir, "trace.json"))
    cap = _captures(0)[0]
    cap["started_at"] = doc["baseTimeNanoseconds"] / 1e9
    cap["xla_trace"] = out
    rows = [e for e in device_events(cap, "d") if e.get("ph") == "X"]
    assert [e["name"] for e in rows] == ["rms_norm_kernel"] * kernels


@pytest.mark.parametrize("lost, status", [((), "captured"),
                                          ((105, 107), "captured"),
                                          ((103, 105, 107), "partial"),
                                          ((299,), "captured")])
def test_launches_whose_kernel_records_are_lost_make_a_partial_trace(
        tmp_path, monkeypatch, lost, status):
    """200 launches by correlation id (100..299), each with its kernel
    record except those in ``lost``. A launch whose record is gone while
    a later launch's was kept is ``missing``; the last launch without a
    record is not (it may have run after the stop). More than
    PARTIAL_SHARE of the launches missing reads ``partial``."""
    import torch

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    events = []
    for corr in range(100, 300):
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": float(corr),
                       "dur": 1.0, "pid": 1, "tid": 1,
                       "args": {"correlation": corr}})
        if corr not in lost:
            events.append({"ph": "X", "cat": "kernel", "name": "k",
                           "ts": corr + 0.5, "dur": 1.0, "pid": 0,
                           "tid": 7, "args": {"correlation": corr,
                                              "stream": 7}})
    doc = {"baseTimeNanoseconds": 0, "traceEvents": events}
    state = {"status": "capturing", "backend": "cuda",
             "logdir": str(tmp_path)}
    out = port_capture._device_trace_end(state, _FakeSession(doc))
    assert out["launches"] == 200
    assert out["kernels"] == 200 - len(lost)
    assert out["missing"] == len([c for c in lost if c < 299])
    assert port_capture.PARTIAL_SHARE * 200 == 2.0
    assert out["status"] == status, out.get("reason")


def _report_ranks(session, steps):
    """Two train ranks of one process report the same step pattern, rank
    1 twice as slow (the real clock: ~0.1 s)."""
    done = []

    def rank_main(rank):
        ctx = session.TrainContext(world_rank=rank, world_size=2,
                                   experiment_name="strag")
        session.set_context(ctx)
        try:
            for _ in range(steps):
                time.sleep(0.004 * (rank + 1))
                session.report({"sync_time_s": 0.0005 * (2 - rank),
                                "compute_time_s": 0.003 * (rank + 1)})
            done.append(rank)
        finally:
            session.set_context(None)

    ts = [threading.Thread(target=rank_main, args=(r,)) for r in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


def test_in_process_state_verbs_answer_as_jax_s(monkeypatch, tmp_path):
    for session in (jax_session, port_session):
        monkeypatch.setattr(session, "_stats_registry", {})
        monkeypatch.setattr(session, "_stats_final", {})
    out = {}
    for side, rt, state, session in (
            ("jax", ray_tpu, jax_state, jax_session),
            ("torch", ray_tpu_torch, port_state, port_session)):
        rt.shutdown()
        rt.init(num_cpus=2)
        try:
            _report_ranks(session, 12)
            rep = state.stragglers()
            stack = state.get_stack()
            fleet = state.stack_cluster()
            mem = state.device_memory()
            prof = state.profile_cluster(0.1, out_dir=str(tmp_path / side))
            out[side] = {
                "ranks": [w["rank"] for w in rep["workers"]],
                "causes": [w["cause"] for w in rep["workers"]],
                "lagging": rep["lagging_rank"],
                "stack_keys": sorted(stack),
                "fleet": sorted(fleet["nodes"]["local"]),
                "mem": (sorted(mem["nodes"]["local"]),
                        sorted(mem["nodes"]["local"]["daemon"])),
                "prof": (sorted(prof), sorted(prof["paths"]),
                         len(prof["captures"])),
                "goodput": state.get_goodput(),
            }
            with pytest.raises(ValueError, match="cluster mode"):
                state.get_stack("abc")
        finally:
            rt.shutdown()
    assert out["torch"] == out["jax"]
    assert out["torch"]["ranks"] == [1, 0]
    assert out["torch"]["lagging"] == 1
