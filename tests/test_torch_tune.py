"""ray_tpu_torch.tune against ray_tpu.tune, on the CPU.

Searchers and schedulers are held decision by decision: the domains, grid
expansion and ``BasicVariantGenerator`` per seed, ``TPESearcher`` fed the
same observations, and the four schedulers fed the same result sequences
(PBT's exploit requests and perturbed configs included). End to end, the
same experiment runs under JAX's ``Tuner`` on ``ray_tpu.init()`` first
and under the port's on ``ray_tpu_torch.init()`` second, each runtime
shut down before the next starts: function and class trainables, stop
criteria, errors in results, a trainer under tune (``TorchTrainer`` on
the CPU against tests/test_tune.py's ``DataParallelTrainer``), and PBT run
one trial at a time, which makes it deterministic.
"""

import random
import threading

import pytest

import ray_tpu
import ray_tpu.tune as jtune
import ray_tpu_torch
import ray_tpu_torch.tune as ttune
from ray_tpu_torch.tune import trainable as ttrainable

SIDES = {"jax": (ray_tpu, jtune), "port": (ray_tpu_torch, ttune)}


def _space(tune):
    return {
        "a": tune.grid_search([1, 2]),
        "lr": tune.loguniform(1e-5, 1e-1),
        "u": tune.uniform(-1.0, 1.0),
        "q": tune.quniform(0.0, 10.0, 0.5),
        "bs": tune.choice([16, 32, 64]),
        "n": tune.randint(0, 10),
        "nested": {"double_n": tune.sample_from(lambda cfg: cfg["n"] * 2),
                   "const": 7},
    }


def test_all_is_jaxs():
    assert ttune.__all__ == jtune.__all__


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("num_samples", [1, 3])
def test_basic_variant_generator_suggests_as_jax(seed, num_samples):
    out = {}
    for side, (_, tune) in SIDES.items():
        gen = tune.BasicVariantGenerator(seed=seed)
        gen.set_search_properties("m", "max", _space(tune))
        n = gen.total_variants(num_samples)
        out[side] = [gen.suggest(f"t{i}") for i in range(n + 1)]
    assert out["port"] == out["jax"]
    assert out["port"][-1] is None
    assert len(out["port"]) == 2 * num_samples + 1


def _objective(cfg):
    return -(cfg["u"] - 0.3) ** 2 - abs(cfg["bs"] - 32) / 100 + cfg["a"]


@pytest.mark.parametrize("seed", [0, 3])
def test_tpe_suggests_as_jax_on_the_same_observations(seed):
    out = {}
    for side, (_, tune) in SIDES.items():
        tpe = tune.TPESearcher(n_startup=4, n_candidates=8, seed=seed)
        tpe.set_search_properties("score", "max", _space(tune))
        seen = []
        for i in range(12):
            cfg = tpe.suggest(f"t{i}")
            seen.append(cfg)
            tpe.on_trial_result(f"t{i}", {"score": _objective(cfg)})
            tpe.on_trial_complete(f"t{i}", {"score": _objective(cfg)},
                                  error=(i == 5))
        out[side] = seen
    assert out["port"] == out["jax"]


def _results(n_trials=4, steps=9, seed=0):
    """A seeded interleaving of per-trial results: (trial index, result)."""
    rng = random.Random(seed)
    seqs = []
    for t in range(n_trials):
        slope = rng.uniform(0.1, 2.0)
        seqs.append([{"training_iteration": i, "score": slope * i
                      + rng.uniform(-0.2, 0.2)} for i in range(1, steps + 1)])
    order = [t for t in range(n_trials) for _ in range(steps)]
    rng.shuffle(order)
    pos = [0] * n_trials
    out = []
    for t in order:
        out.append((t, seqs[t][pos[t]]))
        pos[t] += 1
    return out


def _scheduler(tune, name):
    if name == "fifo":
        return tune.FIFOScheduler()
    if name == "asha":
        return tune.AsyncHyperBandScheduler(grace_period=1,
                                            reduction_factor=2, max_t=8)
    if name == "median":
        return tune.MedianStoppingRule(grace_period=2,
                                       min_samples_required=2)
    rng = random.Random(5)
    return tune.PopulationBasedTraining(
        perturbation_interval=2,
        hyperparam_mutations={"rate": lambda: rng.uniform(0.5, 1.0),
                              "opt": ["sgd", "adam"]},
        quantile_fraction=0.5, resample_probability=0.3, seed=11)


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("name", ["fifo", "asha", "median", "pbt"])
def test_scheduler_decides_as_jax(name, mode):
    out = {}
    for side, (_, tune) in SIDES.items():
        sched = _scheduler(tune, name)
        sched.set_search_properties("score", mode)
        trials = [tune.Trial({"rate": 0.1 * (t + 1), "opt": "sgd"},
                             trial_id=f"t{t}") for t in range(4)]
        log = []
        for t, result in _results(seed=2):
            trial = trials[t]
            if trial.status == tune.Trial.TERMINATED:
                continue
            decision = sched.on_trial_result(trial, dict(result))
            req = trial.pbt_request
            if req is not None:
                trial.pbt_request = None
                log.append((t, decision, req["donor"].trial_id,
                            sorted(req["config"].items())))
                trial.config = req["config"]
            else:
                log.append((t, decision))
            if decision == tune.TrialScheduler.STOP:
                trial.status = tune.Trial.TERMINATED
                sched.on_trial_complete(trial, result)
        out[side] = log
    assert out["port"] == out["jax"]
    if name in ("asha", "median"):
        assert any(entry[1] == "STOP" for entry in out["port"])
    if name == "pbt":
        assert any(len(entry) == 4 for entry in out["port"])


def _run(side, make_tuner):
    """``make_tuner(tune)``'s ``fit()`` under that side's runtime, started
    and shut down around it."""
    rt, tune = SIDES[side]
    rt.init()
    try:
        return make_tuner(tune).fit()
    finally:
        rt.shutdown()


def _summary(grid):
    return sorted((repr(r.config), repr(sorted(r.metrics.items())),
                   r.error is None, repr(r.checkpoint)) for r in grid.results)


def _objective_fn(tune):
    def objective(config):
        acc = 0.0
        for _ in range(5):
            acc += config["lr"]
            tune.report({"acc": acc})
    return objective


class _Counter:
    """A class trainable, built for either package."""

    @staticmethod
    def make(tune):
        class Counter(tune.Trainable):
            def setup(self, config):
                self.x = config["start"]

            def step(self):
                self.x += 1
                return {"x": self.x}

            def save_checkpoint(self):
                return {"x": self.x}

            def load_checkpoint(self, ckpt):
                self.x = ckpt["x"]

        return Counter


def _broken_fn(tune):
    def broken(config):
        if config["i"] == 1:
            raise ValueError("boom")
        tune.report({"ok": 1})
    return broken


EXPERIMENTS = {
    "function": lambda tune: tune.Tuner(
        _objective_fn(tune),
        param_space={"lr": tune.grid_search([0.1, 0.2, 0.3])},
        tune_config=tune.TuneConfig(metric="acc", mode="max")),
    "class_stop": lambda tune: tune.Tuner(
        _Counter.make(tune),
        param_space={"start": tune.grid_search([0, 100])},
        tune_config=tune.TuneConfig(metric="x", mode="max"),
        stop={"training_iteration": 3}),
    "errors": lambda tune: tune.Tuner(
        _broken_fn(tune),
        param_space={"i": tune.grid_search([0, 1])},
        tune_config=tune.TuneConfig(metric="ok", mode="max")),
    "asha": lambda tune: tune.Tuner(
        _objective_fn(tune),
        param_space={"lr": tune.grid_search([0.1, 0.2, 0.3, 0.4])},
        tune_config=tune.TuneConfig(
            metric="acc", mode="max", max_concurrent_trials=1,
            scheduler=tune.AsyncHyperBandScheduler(
                grace_period=1, reduction_factor=2, max_t=4))),
}


@pytest.mark.parametrize("name", sorted(EXPERIMENTS))
def test_tuner_end_to_end_as_jax(name):
    want = _run("jax", EXPERIMENTS[name])
    got = _run("port", EXPERIMENTS[name])
    assert _summary(got) == _summary(want)
    assert len(got) == len(want)
    assert [e.split("(")[0] for e in got.errors] == \
        [e.split("(")[0] for e in want.errors]
    best, jbest = got.get_best_result(), want.get_best_result()
    assert best.config == jbest.config
    assert best.metrics == jbest.metrics
    if name == "errors":
        assert "boom" in got.errors[0]
    # every function trainable's thread ended with its trial
    assert not [t for t in threading.enumerate()
                if t.name.startswith("rtpu-tune-")]


def test_trainer_under_tune_as_jax():
    """tests/test_tune.py's ``test_trainer_under_tune`` with the port's
    TorchTrainer on the CPU beside JAX's DataParallelTrainer."""
    def train_fn(config):
        from ray_tpu.train.session import report
        report({"loss": 1.0 / config["lr"]})

    def port_train_fn(config):
        from ray_tpu_torch.train import report
        report({"loss": 1.0 / config["lr"]})

    def jax_tuner(tune):
        from ray_tpu.train import DataParallelTrainer, ScalingConfig

        trainer = DataParallelTrainer(
            train_fn, train_loop_config={"lr": 1.0},
            scaling_config=ScalingConfig(num_workers=1))
        return tune.Tuner(
            trainer, param_space={"train_loop_config": {
                "lr": tune.grid_search([1.0, 2.0])}},
            tune_config=tune.TuneConfig(metric="loss", mode="min"))

    def port_tuner(tune):
        from ray_tpu_torch.train import (
            ScalingConfig,
            TorchBackendConfig,
            TorchTrainer,
        )

        trainer = TorchTrainer(
            port_train_fn, train_loop_config={"lr": 1.0},
            scaling_config=ScalingConfig(num_workers=1),
            backend_config=TorchBackendConfig(device="cpu"))
        return tune.Tuner(
            trainer, param_space={"train_loop_config": {
                "lr": tune.grid_search([1.0, 2.0])}},
            tune_config=tune.TuneConfig(metric="loss", mode="min"))

    want = _run("jax", jax_tuner)
    got = _run("port", port_tuner)
    assert len(got) == len(want) == 2
    assert [r.metrics["loss"] for r in got.results] == \
        [r.metrics["loss"] for r in want.results]
    assert got.get_best_result().config["train_loop_config"]["lr"] == 2.0


def _pbt_tuner(tune):
    class Rate(tune.Trainable):
        def setup(self, config):
            self.w = 0.0

        def step(self):
            self.w += self.config["rate"]
            return {"score": self.w}

        def save_checkpoint(self):
            return {"w": self.w}

        def load_checkpoint(self, ckpt):
            self.w = ckpt["w"]

    rng = random.Random(0)
    sched = tune.PopulationBasedTraining(
        perturbation_interval=2,
        hyperparam_mutations={"rate": lambda: rng.uniform(0.5, 1.0)},
        quantile_fraction=0.5, seed=0)
    return tune.Tuner(
        Rate, param_space={"rate": tune.grid_search([0.01, 1.0, 0.3])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=sched,
                                    max_concurrent_trials=1),
        stop={"training_iteration": 8})


def test_pbt_one_trial_at_a_time_as_jax():
    want = _run("jax", _pbt_tuner)
    got = _run("port", _pbt_tuner)
    assert _summary(got) == _summary(want)
    assert sorted(r.metrics["score"] for r in got.results) == \
        pytest.approx([0.08, 2.4, 8.0])


def test_trial_resources_pass_the_gpu_on():
    """A trial asks for ``{"CPU": 1, "GPU": 0.25}``: four run at once on a
    runtime started with one GPU, and each actor holds its quarter."""
    seen = []
    lock = threading.Lock()
    gate = threading.Barrier(4, timeout=30)

    def fn(config):
        with lock:
            seen.append(ray_tpu_torch.available_resources().get("GPU"))
        gate.wait()  # all four at once
        ttune.report({"v": config["v"]})

    ray_tpu_torch.init(num_cpus=8, resources={"GPU": 1})
    try:
        grid = ttune.Tuner(
            fn, param_space={"v": ttune.grid_search([1, 2, 3, 4])},
            tune_config=ttune.TuneConfig(metric="v", mode="max",
                                         max_concurrent_trials=4),
            trial_resources={"CPU": 1, "GPU": 0.25}).fit()
        assert ray_tpu_torch.cluster_resources()["GPU"] == 1
    finally:
        ray_tpu_torch.shutdown()
    assert not grid.errors
    assert grid.get_best_result().config["v"] == 4
    assert min(seen) == pytest.approx(0.0)


def test_stop_ends_a_function_trainables_thread():
    """``cleanup`` unblocks a thread parked in ``report`` and waits for
    it."""
    def fn(config):
        for i in range(1000):
            ttune.report({"i": i})

    cls = ttrainable.wrap_function(fn)
    tr = cls({})
    assert tr.train_step()["i"] == 0
    thread = tr._thread
    assert thread.is_alive()
    tr.cleanup()
    assert not thread.is_alive()
