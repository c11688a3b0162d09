"""ray_tpu_torch.rl's offline learners (BC, MARWIL, CQL) and their
Trainables against ray_tpu.rl's on the same inputs.

Params come from the JAX package's initializers through
``params_from_jax``; batches from numpy, or from one
``ray_tpu_torch.data`` dataset that both packages' Trainables read (JAX's
take any object with ``iter_batches``), so both see the same batches.
Tolerance (f32): params, losses and MARWIL's EMA within 1e-5 after each
of three updates and after a Trainable's step. JAX is imported inside the
tests.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch._device import tree_leaves, tree_map
from ray_tpu_torch.data import from_blocks
from ray_tpu_torch.rl import BCConfig, CQLConfig, MARWILConfig
from ray_tpu_torch.rl import bc as tbc
from ray_tpu_torch.rl import cql as tcql
from ray_tpu_torch.rl import marwil as tmarwil
from ray_tpu_torch.rl.env import CartPoleEnv
from ray_tpu_torch.rl.ppo import params_from_jax, params_to_numpy
from ray_tpu_torch.train import optim

UPDATE_TOL = 1e-5
LR = 1e-3


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=UPDATE_TOL, label=""):
    pairs = []
    tree_map(lambda a, b: pairs.append((a, b)), got, _np(want))
    for i, (a, b) in enumerate(pairs):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol,
                                   err_msg=f"{label} leaf {i}")


def _scalar_close(got, want, tol=UPDATE_TOL):
    np.testing.assert_allclose(float(got), float(want), rtol=tol, atol=tol)


def _expert_blocks(episodes=10, max_steps=100, seed=0):
    """CartPole transitions of the angle+velocity controller
    (tests/test_rl.py's expert), with 20% random actions, in two blocks:
    obs, actions, rewards, next_obs, dones and returns-to-go."""
    env = CartPoleEnv(seed=seed)
    rng = np.random.default_rng(seed)
    cols = {k: [] for k in ("obs", "actions", "rewards", "next_obs",
                            "dones", "returns")}
    for _ in range(episodes):
        obs, done, steps, rews = env.reset(), False, 0, []
        while not done and steps < max_steps:
            a = 1 if obs[2] + 0.5 * obs[3] > 0 else 0
            if rng.random() < 0.2:
                a = int(rng.integers(2))
            nobs, r, term, trunc = env.step(a)
            cols["obs"].append(np.asarray(obs, np.float32))
            cols["actions"].append(a)
            cols["rewards"].append(r)
            cols["next_obs"].append(np.asarray(nobs, np.float32))
            cols["dones"].append(float(term))
            rews.append(r)
            obs, done, steps = nobs, term or trunc, steps + 1
        g, rets = 0.0, []
        for r in reversed(rews):
            g = r + 0.99 * g
            rets.append(g)
        cols["returns"].extend(reversed(rets))
    data = {"obs": np.stack(cols["obs"]),
            "actions": np.asarray(cols["actions"], np.int32),
            "rewards": np.asarray(cols["rewards"], np.float32),
            "next_obs": np.stack(cols["next_obs"]),
            "dones": np.asarray(cols["dones"], np.float32),
            "returns": np.asarray(cols["returns"], np.float32)}
    half = len(data["actions"]) // 2
    return [{k: v[:half] for k, v in data.items()},
            {k: v[half:] for k, v in data.items()}]


@pytest.fixture(scope="module")
def blocks():
    return _expert_blocks()


def _batches(rng, K=3, B=64):
    return [{"obs": rng.normal(size=(B, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, B).astype(np.int32),
             "rewards": rng.normal(size=B).astype(np.float32),
             "next_obs": rng.normal(size=(B, 4)).astype(np.float32),
             "dones": (rng.random(B) < 0.1).astype(np.float32),
             "returns": (rng.normal(size=B) * 5 + 10).astype(np.float32)}
            for _ in range(K)]


def _mlp(seed, last, scale_last=0.01):
    import jax
    from ray_tpu.rl.ppo import init_mlp

    return init_mlp(jax.random.PRNGKey(seed), [4, 32, 32, last],
                    scale_last=scale_last)


# ---------------------------------------------------------------- updates --

def test_bc_update_matches_jax():
    import jax.numpy as jnp
    import optax
    from ray_tpu.rl.bc import bc_update

    params = _mlp(0, 2)
    jopt, topt = optax.adam(LR), optim.adam(LR)
    jp, js = params, jopt.init(params)
    ours = params_from_jax(params, "cpu")
    ts = topt.init(ours)
    for b in _batches(np.random.default_rng(0)):
        jp, js, jloss, jacc = bc_update(jopt, jp, js, jnp.asarray(b["obs"]),
                                        jnp.asarray(b["actions"]))
        tb = tbc.device_batch(b, "cpu")
        ours, ts, tloss, tacc = tbc.bc_update(topt, ours, ts, tb["obs"],
                                              tb["actions"])
        _close(ours, jp, label="bc")
        _scalar_close(tloss, jloss)
        _scalar_close(tacc, jacc)


@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_marwil_update_matches_jax_with_its_ema(beta):
    import jax.numpy as jnp
    import optax
    from ray_tpu.rl.marwil import marwil_update

    params = {"pi": _mlp(1, 2), "vf": _mlp(2, 1, scale_last=1.0)}
    jopt, topt = optax.adam(LR), optim.adam(LR)
    jp, js, jma = params, jopt.init(params), jnp.asarray(1.0)
    ours = params_from_jax(params, "cpu")
    ts, tma = topt.init(ours), torch.ones(())
    for b in _batches(np.random.default_rng(1)):
        jp, js, jma, jloss, jcl = marwil_update(
            jopt, beta, jp, js, jma, jnp.asarray(b["obs"]),
            jnp.asarray(b["actions"]), jnp.asarray(b["returns"]))
        tb = tbc.device_batch(b, "cpu")
        ours, ts, tma, tloss, tcl = tmarwil.marwil_update(
            topt, beta, ours, ts, tma, tb["obs"], tb["actions"],
            tb["returns"])
        _close(ours, jp, label=f"marwil beta {beta}")
        for got, want in ((tloss, jloss), (tcl, jcl), (tma, jma)):
            _scalar_close(got, want)
    assert float(tma) != 1.0


def test_cql_update_matches_jax():
    import jax.numpy as jnp
    import optax
    from ray_tpu.rl.cql import cql_update

    params, target = _mlp(3, 2), _mlp(4, 2)
    jopt, topt = optax.adam(LR), optim.adam(LR)
    jp, js = params, jopt.init(params)
    ours = params_from_jax(params, "cpu")
    tt = params_from_jax(target, "cpu")
    ts = topt.init(ours)
    for b in _batches(np.random.default_rng(3)):
        jb = {k: jnp.asarray(b[k]) for k in tcql._COLUMNS}
        jp, js, jtd, jgap = cql_update(jopt, jp, target, js, jb, 0.99, 1.0)
        tb = tbc.device_batch({k: b[k] for k in tcql._COLUMNS}, "cpu")
        ours, ts, ttd, tgap = tcql.cql_update(topt, ours, tt, ts, tb, 0.99,
                                              1.0)
        _close(ours, jp, label="cql")
        _scalar_close(ttd, jtd)
        _scalar_close(tgap, jgap)


# ------------------------------------------------------------- trainables --

_ALGOS = {
    "bc": (BCConfig, "ray_tpu.rl.bc", "BCConfig"),
    "marwil": (MARWILConfig, "ray_tpu.rl.marwil", "MARWILConfig"),
    "cql": (CQLConfig, "ray_tpu.rl.cql", "CQLConfig"),
}


def _jax_cfg(name):
    import importlib

    _, mod, cls = _ALGOS[name]
    return getattr(importlib.import_module(mod), cls)


@pytest.mark.parametrize("name", list(_ALGOS))
def test_trainable_step_matches_jax_on_the_same_batches(name, blocks):
    """One step (one epoch) of the port's Trainable against JAX's, both
    reading the port's dataset (so the same shuffled batches) from JAX's
    initial params."""
    ds = from_blocks(blocks)
    kw = dict(dataset=ds, batch_size=128, hidden=32, seed=4)
    if name == "cql":
        kw["target_update_every"] = 2
    jalgo = _jax_cfg(name)(**kw).build()
    ours = _ALGOS[name][0](**kw, device="cpu").build()
    ours.params = params_from_jax(jalgo.params, "cpu")
    ours.opt_state = ours.optimizer.init(ours.params)
    if name == "cql":
        ours.target_params = params_from_jax(jalgo.target_params, "cpu")
    for _ in range(2):
        jm, tm = jalgo.train_step(), ours.train_step()
        _close(ours.params, jalgo.params, label=name)
        for k, v in jm.items():
            if isinstance(v, float):
                _scalar_close(tm[k], v)
            else:
                assert tm[k] == v, k
    if name == "cql":
        _close(ours.target_params, jalgo.target_params, label="target")
        assert ours._updates == jalgo._updates
    if name == "marwil":
        _scalar_close(ours.ma_adv_norm, jalgo.ma_adv_norm)


def _roundtrip(algo, build):
    ckpt = algo.save_checkpoint()
    assert all(isinstance(x, np.ndarray) for x in tree_leaves(ckpt["params"]))
    other = build()
    other.load_checkpoint(ckpt)
    for a, b in zip(tree_leaves(params_to_numpy(other.params)),
                    tree_leaves(params_to_numpy(algo.params))):
        np.testing.assert_array_equal(a, b)
    assert other.iteration == algo.iteration
    return other


@pytest.mark.parametrize("name", list(_ALGOS))
def test_trainables_step_evaluate_and_checkpoint(name, blocks):
    ds = from_blocks(blocks)
    build = lambda: _ALGOS[name][0](  # noqa: E731
        dataset=ds, batch_size=128, hidden=32, evaluation_episodes=1,
        device="cpu").build()
    algo = build()
    ms = [algo.train_step() for _ in range(2)]
    assert all(np.isfinite(v) for m in ms for v in m.values()
               if isinstance(v, float))
    assert ms[-1]["episode_return_mean"] > 0
    other = _roundtrip(algo, build)
    if name == "marwil":
        assert float(other.ma_adv_norm) == float(algo.ma_adv_norm)
        assert int(other.opt_state[0].count) == int(algo.opt_state[0].count)
        other.step()  # the restored optimizer state steps on
    if name == "cql":
        assert other._updates == algo._updates


def test_bc_accuracy_rises_on_the_expert_data(blocks):
    algo = BCConfig(dataset=from_blocks(blocks), batch_size=64,
                    epochs_per_step=3, device="cpu").build()
    first = algo.train_step()["action_accuracy"]
    last = algo.train_step()["action_accuracy"]
    assert last > first and last > 0.7, (first, last)


@pytest.mark.parametrize("name", list(_ALGOS))
def test_configs_default_to_the_card_and_refuse_without_one(name, blocks):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    cfg = _ALGOS[name][0](dataset=from_blocks(blocks))
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cfg.build()
    with pytest.raises(ValueError, match="dataset"):
        _ALGOS[name][0](device="cpu").build()
