"""ray_tpu_torch's goodput ledger and train-session stats against ray_tpu's,
on the CPU.

The pure parts agree exactly on inputs drawn from a numpy seed:
``classify_interval``, ``GoodputStore``'s rollup, and a ``RankLedger``
and ``session.collect_train_stats`` driven through one report sequence
on one injected clock (``time.monotonic`` patched for both packages).
On the real clock the two ledgers' phases agree exactly and their open
tails within 1e-5 s; the port reads the clock once in ``snapshot``, so an
open ledger's ``unattributed_s`` is exactly 0 (ray_tpu's reads it twice).
The controller's ``restart_downtime`` event, the checkpoint writer's
pending seconds and the kernel build's ``compile`` seconds close the file.
"""

import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu.observability.goodput as jax_gp
import ray_tpu.train as jtrain
import ray_tpu.train.session as jax_session
import ray_tpu_torch
import ray_tpu_torch.observability.goodput as port_gp
import ray_tpu_torch.train as ttrain
import ray_tpu_torch.train.session as port_session

OPEN_TAIL_TOL = 1e-5  # seconds: two ledgers read the clock a moment apart
MEASURED = ("compile", "input_wait", "collective_wait", "checkpoint",
            "replication_push", "step_compute")


@pytest.fixture(autouse=True)
def _reset():
    jax_gp._reset_for_tests()
    port_gp._reset_for_tests()
    yield
    jax_gp._reset_for_tests()
    port_gp._reset_for_tests()


class FakeClock:
    def __init__(self, t: float = 5000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _draws(seed: int, n: int):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        dur = float(rng.uniform(0.0, 20.0))
        parts = {p: float(rng.uniform(0.0, 2.0 * dur)) for p in MEASURED
                 if rng.random() < 0.5}
        yield (dur, parts, bool(rng.random() < 0.3),
               ("init", "restart_downtime")[int(rng.integers(2))],
               (None, None, "idle", "restart_downtime")[
                   int(rng.integers(4))])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_classify_interval_matches_jax_exactly(seed):
    for dur, parts, first, first_phase, rem in _draws(seed, 300):
        want = jax_gp.classify_interval(dur, parts, first=first,
                                        first_phase=first_phase,
                                        remainder=rem)
        got = port_gp.classify_interval(dur, parts, first=first,
                                        first_phase=first_phase,
                                        remainder=rem)
        assert got == want
        assert abs(sum(got.values()) - dur) <= 1e-9 * max(1.0, dur)


def test_phase_taxonomy_is_jax_s():
    assert port_gp.PHASES == jax_gp.PHASES
    assert port_gp.GOOD_PHASE == jax_gp.GOOD_PHASE


def _train_stats(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for src in range(3):
        stats = {}
        for rank in range(int(rng.integers(1, 4))):
            phases = {p: float(rng.uniform(0, 50)) for p in jax_gp.PHASES
                      if rng.random() < 0.6}
            stats[str(rank)] = {"goodput": {
                "run": ("a", "b")[int(rng.integers(2))], "rank": rank,
                "chips": float(rng.integers(1, 5)), "phase_s": phases,
                "open_s": float(rng.uniform(0, 1)),
                "unattributed_s": 0.0,
                "spent_s": float(rng.uniform(0, 0.01))}}
        out[f"src{src}"] = {"node_id": f"n{src}", "stats": stats}
    return out


def _events(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed + 100)
    return [{"id": f"e{i}", "kind": ("restart_downtime", "head_outage")[
                 int(rng.integers(2))],
             "run": (None, "a", "b")[int(rng.integers(3))],
             "seconds": float(rng.uniform(0, 30)),
             "chips": float(rng.integers(0, 4)), "ts": 1000.0 + i,
             "start_ts": None, "detail": {"i": i}} for i in range(6)]


@pytest.mark.parametrize("seed", [0, 1])
def test_goodput_store_rollup_matches_jax_exactly(seed):
    stats, events = _train_stats(seed), _events(seed)
    out = []
    for mod in (jax_gp, port_gp):
        store = mod.GoodputStore()
        store.ingest("src0", "n0", {"events": events})
        store.ingest("src0", "n0", {"events": events[:2]})  # a retry: dedup
        out.append(store.rollup(stats))
        out.append(store.rollup(stats, run="a"))
    assert out[2] == out[0]
    assert out[3] == out[1]


def _drive_ledger(mod, clock):
    led = mod.RankLedger("run", 1, chips=1.0)
    snaps = []
    for step in range(6):
        clock.t += 0.5 + 0.1 * step
        led.add_pending("compile" if step == 0 else "input_wait",
                        0.05 * (step + 1))
        led.add_pending("not_a_phase", 1.0)  # dropped, as in ray_tpu
        led.close_interval(parts={"collective_wait": 0.1,
                                  "step_compute": 0.2 if step % 2 else None})
        clock.t += 0.25
        snaps.append(led.snapshot())
    clock.t += 1.0
    led.finish()
    snaps.append(led.snapshot())
    for s in snaps:
        s.pop("ts"), s.pop("t0"), s.pop("spent_s")
    return snaps


def test_rank_ledger_matches_jax_on_one_clock(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(time, "monotonic", clock)
    want = _drive_ledger(jax_gp, clock)
    got = _drive_ledger(port_gp, clock)
    assert got == want
    assert got[-1]["finished"] and got[-1]["open_s"] == 0.0
    # every open snapshot: classified + open tail == elapsed, to the bit
    assert all(s["unattributed_s"] == 0.0 for s in got)


def test_open_ledger_residual_is_exactly_zero_on_the_real_clock():
    """One clock read per snapshot: the open tail and the elapsed time
    come from the same instant, so nothing is left unattributed."""
    led = port_gp.RankLedger("run", 0)
    for i in range(200):
        if i % 20 == 0:
            led.close_interval(parts={"collective_wait": 1e-4})
        snap = led.snapshot()
        assert snap["unattributed_s"] == 0.0
        total = sum(snap["phase_s"].values()) + snap["open_s"]
        assert total >= 0.0


def test_phases_match_jax_and_open_tails_within_tolerance(monkeypatch):
    """Both ledgers close the same intervals (one injected clock, one
    anchor) and must agree on every phase; their snapshots are then taken
    on the real clock a moment apart, so the open tails agree within
    OPEN_TAIL_TOL."""
    clock = FakeClock(time.monotonic())
    monkeypatch.setattr(time, "monotonic", clock)
    jl = jax_gp.RankLedger("run", 0)
    pl = port_gp.RankLedger("run", 0)
    for step in range(4):
        clock.t += 0.01
        for led in (jl, pl):
            led.add_pending("input_wait", 0.002)
            led.close_interval(parts={"step_compute": 0.004})
    assert pl.phase_s == jl.phase_s
    monkeypatch.undo()
    want, got = jl.snapshot(), pl.snapshot()
    assert got["phase_s"] == want["phase_s"]
    assert abs(got["open_s"] - want["open_s"]) <= OPEN_TAIL_TOL
    assert got["unattributed_s"] == 0.0


def _report_sequence(session, ctx_cls, clock, sink):
    ctx = ctx_cls(world_rank=0, world_size=2, experiment_name="exp")
    session.set_context(ctx)
    try:
        for step in range(8):
            clock.t += 0.2 + 0.05 * (step % 3)
            session.report({"step": step, "tokens": 4096,
                            "sync_time_s": 0.02 * step,
                            "compute_time_s": 0.1,
                            "input_wait_s": 0.01})
        stats = session.collect_train_stats()
        sink.append(stats)
    finally:
        session.set_context(None)


def _strip(stats):
    """Drop the clock stamps and the chip count (ray_tpu counts the JAX
    devices of this test process, a virtual CPU mesh; the port one device
    a rank). The residual is checked apart: ray_tpu's keeps the float
    rounding of its sums (~1e-16 s), the port's reads 0 below 1 ns."""
    for row in stats.values():
        row.pop("ts")
        gp = row.get("goodput") or {}
        for k in ("ts", "t0", "spent_s", "chips"):
            gp.pop(k, None)
        row["residual"] = gp.pop("unattributed_s")
    return stats


def test_collect_train_stats_matches_jax_after_one_report_sequence(
        monkeypatch):
    for session in (jax_session, port_session):  # rows other tests left
        monkeypatch.setattr(session, "_stats_registry", {})
        monkeypatch.setattr(session, "_stats_final", {})
    clock = FakeClock()
    monkeypatch.setattr(time, "monotonic", clock)
    got = {}
    for name, session in (("jax", jax_session), ("torch", port_session)):
        sink = []
        t = threading.Thread(target=_report_sequence,
                             args=(session, session.TrainContext, clock,
                                   sink))
        t.start()
        t.join()
        got[name] = _strip(sink[0])
    want_res = got["jax"]["0"].pop("residual")
    assert got["torch"]["0"].pop("residual") == 0.0
    assert want_res <= 1e-9
    assert got["torch"] == got["jax"]
    assert port_gp._local_chips(None) == 1.0
    row = got["torch"]["0"]
    assert row["steps"] == 7 and len(row["deciles"]) == 11


def test_train_gauges_match_jax(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(time, "monotonic", clock)
    monkeypatch.setenv("RTPU_PEAK_FLOPS", "1e12")
    out = {}
    for name, session in (("jax", jax_session), ("torch", port_session)):
        ctx = session.TrainContext(world_rank=3)
        session._instrument_report(ctx, {"tokens": 100, "flops": 1e11})
        clock.t += 0.5
        session._instrument_report(ctx, {"tokens": 100, "flops": 1e11})
        m = session._get_train_metrics()
        out[name] = tuple(
            m[k]._points()[m[k]._series_key({"rank": "3"})]
            for k in ("step_time", "tokens_per_s", "mfu"))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == 0.5


def _restart_fn(train):
    def fn(config):
        ctx = train.get_context()
        train.report({"step": 0})
        if ctx.restart_count == 0:
            raise RuntimeError("injected")
        train.report({"step": 1})
    return fn


def test_restart_downtime_event_matches_jax(tmp_path, monkeypatch):
    for session in (jax_session, port_session):  # the fits' final rows
        monkeypatch.setattr(session, "_stats_registry", {})
        monkeypatch.setattr(session, "_stats_final", {})
    kinds = {}
    for side, rt, train, gp in (("jax", ray_tpu, jtrain, jax_gp),
                                ("torch", ray_tpu_torch, ttrain, port_gp)):
        rt.shutdown()
        if side == "jax":
            rt.init(num_cpus=4, resources={"TPU": 4.0})
        else:
            rt.init(num_cpus=4)
        try:
            extra = {} if side == "jax" else {
                "backend_config": ttrain.TorchBackendConfig(device="cpu")}
            cls = jtrain.JaxTrainer if side == "jax" else ttrain.TorchTrainer
            res = cls(_restart_fn(train),
                      scaling_config=train.ScalingConfig(num_workers=1),
                      run_config=train.RunConfig(
                          name="gp", storage_path=str(tmp_path / side),
                          failure_config=train.FailureConfig(
                              max_failures=1)), **extra).fit()
            assert res.ok
        finally:
            rt.shutdown()
        leg = gp.collect_for_flush() or {"events": []}
        kinds[side] = [(e["kind"], e["run"], e["chips"],
                        sorted(e["detail"]), e["detail"]["tier"],
                        e["seconds"] > 0) for e in leg["events"]]
    assert kinds["torch"] == kinds["jax"]
    assert kinds["torch"][0][:3] == ("restart_downtime", "gp", 1.0)


def test_checkpoint_writer_and_kernel_build_stamp_the_ledger(
        tmp_path, monkeypatch):
    import torch

    import ray_tpu_torch._native.build as build
    from ray_tpu_torch.train.checkpoint import AsyncCheckpointWriter

    led = port_gp.RankLedger("run", 0)
    port_gp.set_active(led)
    w = AsyncCheckpointWriter()
    w.save({"w": torch.ones(4)}, str(tmp_path / "ck"), step=1)
    w.wait()
    assert led._pending.get("checkpoint", 0.0) > 0.0

    # A kernel build: its seconds land as the compile phase.
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build, "_start",
                        lambda n, nvcc, p: (time.sleep(0.02), p + ".tmp"))
    monkeypatch.setattr(build, "_finish", lambda n, proc, tmp, p: None)
    build.build_all(["rms_norm"])
    assert led._pending.get("compile", 0.0) >= 0.02
    with port_gp.input_wait():
        time.sleep(0.01)
    assert led._pending["input_wait"] >= 0.01
    closed = led.close_interval()
    assert set(closed) >= {"checkpoint", "compile", "input_wait"}
