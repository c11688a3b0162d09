"""ray_tpu_torch.rl's off-policy and V-trace learners (DQN, SAC, IMPALA,
APPO), their Trainables, and the two extensions the RL port needs
(``train.optim.adam`` and ``_device.tree_map`` over lists and tuples),
against ray_tpu.rl and optax on the same inputs.

Params come from the JAX package's own initializers through
``params_from_jax``; batches from numpy. SAC's reparameterization noise is
the draws JAX's ``sac_update`` makes from its keys, reproduced here and
handed to the port. Tolerances (f32): ``vtrace`` 1e-6; the updates'
params and losses 1e-5; ``adam`` against ``optax.adam`` 1e-6 over 5 steps.
JAX is imported inside the tests.
"""

from collections import namedtuple

import numpy as np
import pytest
import torch

from ray_tpu_torch._device import tree_leaves, tree_map
from ray_tpu_torch.rl import (
    APPOConfig,
    DQNConfig,
    ImpalaConfig,
    PPOConfig,
    SACConfig,
)
from ray_tpu_torch.rl import appo as tappo
from ray_tpu_torch.rl import dqn as tdqn
from ray_tpu_torch.rl import impala as timpala
from ray_tpu_torch.rl import sac as tsac
from ray_tpu_torch.rl.ppo import params_from_jax, params_to_numpy
from ray_tpu_torch.train import optim

VTRACE_TOL = 1e-6
UPDATE_TOL = 1e-5
ADAM_TOL = 1e-6


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _pairs(got, want) -> list:
    """Leaf pairs matched by dict key and position (JAX sorts dict keys)."""
    out = []
    tree_map(lambda a, b: out.append((a, b)), got, _np(want))
    return out


def _close(got, want, tol, label=""):
    for i, (a, b) in enumerate(_pairs(got, want)):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol,
                                   err_msg=f"{label} leaf {i}")


def _t(x, long=False):
    t = torch.from_numpy(np.array(x))
    return t.long() if long else t


# ------------------------------------------------------------ extensions --

def test_adam_matches_optax_over_five_steps():
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(0)
    tree = {"layers": [{"w": rng.normal(size=(3, 4)).astype(np.float32),
                        "b": np.zeros(4, np.float32)}],
            "pair": (rng.normal(size=5).astype(np.float32),
                     rng.normal(size=(2, 2)).astype(np.float32)),
            "scalar": np.float32(0.3)}
    jp = tree_map(jnp.asarray, tree)
    ours = tree_map(lambda a: torch.tensor(np.array(a)), tree)
    jopt, topt = optax.adam(1e-2), optim.adam(1e-2)
    js, ts = jopt.init(jp), topt.init(ours)
    for _ in range(5):
        grads = tree_map(lambda a: rng.normal(size=np.shape(a)).astype(
            np.float32), tree)
        ju, js = jopt.update(tree_map(jnp.asarray, grads), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update(tree_map(torch.from_numpy, grads), ts, ours)
        ours = optim.apply_updates(ours, tu)
        _close(ours, jp, ADAM_TOL)
    assert int(ts[0].count) == 5 and isinstance(ours["pair"], tuple)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "under"])
@pytest.mark.parametrize("with_adam", [False, True],
                         ids=["alone", "chained_adam"])
def test_clip_by_global_norm_matches_optax_over_five_steps(max_norm,
                                                          with_adam):
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(1)
    tree = {"layers": [{"w": rng.normal(size=(3, 4)).astype(np.float32),
                        "b": np.zeros(4, np.float32)}],
            "pair": (rng.normal(size=5).astype(np.float32),
                     rng.normal(size=(2, 2)).astype(np.float32))}
    jp = tree_map(jnp.asarray, tree)
    ours = tree_map(lambda a: torch.tensor(np.array(a)), tree)
    if with_adam:
        jopt = optax.chain(optax.clip_by_global_norm(max_norm),
                           optax.adam(1e-2))
        topt = optim.chain(optim.clip_by_global_norm(max_norm),
                           optim.adam(1e-2))
    else:
        jopt = optax.clip_by_global_norm(max_norm)
        topt = optim.clip_by_global_norm(max_norm)
    js, ts = jopt.init(jp), topt.init(ours)
    for _ in range(5):
        grads = tree_map(lambda a: rng.normal(size=np.shape(a)).astype(
            np.float32), tree)
        ju, js = jopt.update(tree_map(jnp.asarray, grads), js, jp)
        tu, ts = topt.update(tree_map(torch.from_numpy, grads), ts, ours)
        _close(tu, ju, ADAM_TOL, "updates")
        if max_norm < 1.0 and not with_adam:
            norm = np.sqrt(sum(float((t.numpy() ** 2).sum())
                               for t in tree_leaves(tu)))
            assert norm == pytest.approx(max_norm, rel=1e-5)
        elif not with_adam:  # under the limit: passed through unchanged
            for a, b in zip(tree_leaves(tu), tree_leaves(grads)):
                np.testing.assert_array_equal(a.numpy(), b)
        jp = optax.apply_updates(jp, ju)
        ours = optim.apply_updates(ours, tu)
        _close(ours, jp, ADAM_TOL, "params")


def test_tree_map_walks_lists_and_tuples_keeping_their_type():
    Pair = namedtuple("Pair", "a b")
    tree = {"x": [1, 2, (3, Pair(4, [5]))], "y": 6}
    out = tree_map(lambda v: v * 10, tree)
    assert out == {"x": [10, 20, (30, Pair(40, [50]))], "y": 60}
    assert isinstance(out["x"], list) and isinstance(out["x"][2], tuple)
    assert isinstance(out["x"][2][1], Pair)
    summed = tree_map(lambda a, b: a + b, tree, out)
    assert summed["x"][2][1].b == [55]
    assert tree_leaves(out) == [10, 20, 30, 40, 50, 60]
    assert tree_map(lambda v: v + 1, 1) == 2


# ---------------------------------------------------------------- V-trace --

def _rollout_batch(rng, T=6, N=5, obs=4):
    return {"obs": rng.normal(size=(T, N, obs)).astype(np.float32),
            "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
            "logp": np.log(rng.uniform(0.2, 0.8, (T, N))).astype(np.float32),
            "rewards": rng.normal(size=(T, N)).astype(np.float32),
            "dones": rng.random((T, N)) < 0.15,
            "last_obs": rng.normal(size=(N, obs)).astype(np.float32)}


def _torch_rollout(b):
    return {k: _t(v, long=(k == "actions")) for k, v in b.items()}


@pytest.mark.parametrize("clips", [(1.0, 1.0), (0.8, 0.5)])
def test_vtrace_matches_jax(clips):
    import jax.numpy as jnp
    from ray_tpu.rl.impala import vtrace

    rng = np.random.default_rng(1)
    T, N = 17, 7
    args = [rng.normal(size=(T, N)).astype(np.float32) * 0.5,   # behaviour
            rng.normal(size=(T, N)).astype(np.float32) * 0.5,   # target
            rng.normal(size=(T, N)).astype(np.float32),         # rewards
            rng.normal(size=(T, N)).astype(np.float32),         # values
            rng.random((T, N)) < 0.2,                           # dones
            rng.normal(size=N).astype(np.float32)]              # last value
    jvs, jadv = vtrace(*map(jnp.asarray, args), 0.97, *clips)
    pvs, padv = timpala.vtrace(*map(_t, args), 0.97, *clips)
    np.testing.assert_allclose(pvs.numpy(), np.asarray(jvs),
                               rtol=VTRACE_TOL, atol=VTRACE_TOL)
    np.testing.assert_allclose(padv.numpy(), np.asarray(jadv),
                               rtol=VTRACE_TOL, atol=VTRACE_TOL)


def test_vtrace_reduces_to_n_step_returns_on_policy():
    """behaviour == target: vs are the discounted n-step returns
    bootstrapped from V (rho = c = 1), as tests/test_rl.py holds JAX's."""
    T, N = 5, 3
    rng = np.random.default_rng(0)
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    values = rng.normal(size=(T, N)).astype(np.float32)
    last = rng.normal(size=N).astype(np.float32)
    logp = _t(rng.normal(size=(T, N)).astype(np.float32))
    vs, _ = timpala.vtrace(logp, logp, _t(rewards), _t(values),
                           torch.zeros(T, N, dtype=torch.bool), _t(last),
                           gamma=0.9)
    expect = np.zeros((T, N), np.float32)
    nxt, corr = last, np.zeros(N, np.float32)
    for t in reversed(range(T)):
        corr = rewards[t] + 0.9 * nxt - values[t] + 0.9 * corr
        expect[t] = values[t] + corr
        nxt = values[t]
    np.testing.assert_allclose(vs.numpy(), expect, rtol=1e-5, atol=1e-5)


def _jax_policy(seed=0, hidden=32):
    import jax
    from ray_tpu.rl.ppo import init_policy

    return init_policy(jax.random.PRNGKey(seed), 4, 2, hidden)


IMPALA_STATIC = (0.99, 1.0, 1.0, 0.5, 0.01)


@pytest.mark.parametrize("algo", ["impala", "appo"])
def test_impala_and_appo_updates_match_jax(algo):
    import jax
    import optax
    from ray_tpu.rl.appo import appo_update
    from ray_tpu.rl.impala import impala_update

    params = _jax_policy()
    batch = _rollout_batch(np.random.default_rng(2))
    jfn, tfn, static = ((impala_update, timpala.impala_update,
                         IMPALA_STATIC) if algo == "impala" else
                        (appo_update, tappo.appo_update,
                         IMPALA_STATIC + (0.3,)))
    jopt, topt = optax.adam(5e-3), optim.adam(5e-3)
    jp, js = params, jopt.init(params)
    ours = params_from_jax(params, "cpu")
    ts = topt.init(ours)
    for _ in range(3):
        jp, js, jstats = jfn(jopt, static, jp, js,
                             jax.tree.map(jax.numpy.asarray, batch))
        ours, ts, tstats = tfn(topt, static, ours, ts,
                               _torch_rollout(batch))
        _close(ours, jp, UPDATE_TOL, algo)
        for k in ("policy_loss", "vf_loss", "entropy"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       rtol=UPDATE_TOL, atol=UPDATE_TOL)


# -------------------------------------------------------------------- DQN --

def _dqn_batches(rng, K=4, B=32, weights=False):
    b = {"obs": rng.normal(size=(K, B, 4)).astype(np.float32),
         "actions": rng.integers(0, 2, (K, B)).astype(np.int32),
         "rewards": rng.normal(size=(K, B)).astype(np.float32),
         "next_obs": rng.normal(size=(K, B, 4)).astype(np.float32),
         "dones": (rng.random((K, B)) < 0.1).astype(np.float32)}
    if weights:
        b["weights"] = rng.uniform(0.2, 1.0, (K, B)).astype(np.float32)
    return b


@pytest.mark.parametrize("double,weights", [(True, False), (False, False),
                                            (True, True)])
def test_dqn_update_matches_jax(double, weights):
    import jax
    import optax
    from ray_tpu.rl.dqn import dqn_update
    from ray_tpu.rl.ppo import init_mlp

    params = init_mlp(jax.random.PRNGKey(3), [4, 32, 32, 2], scale_last=1.0)
    target = init_mlp(jax.random.PRNGKey(4), [4, 32, 32, 2], scale_last=1.0)
    batches = _dqn_batches(np.random.default_rng(5), weights=weights)
    jopt = optax.adam(2.5e-3)
    jp, _, jloss, jtd = dqn_update(jopt, double, params, target,
                                   jopt.init(params),
                                   jax.tree.map(jax.numpy.asarray, batches),
                                   0.99)
    topt = optim.adam(2.5e-3)
    ours = params_from_jax(params, "cpu")
    tb = {k: _t(v, long=(k == "actions")) for k, v in batches.items()}
    tp, _, tloss, ttd = tdqn.dqn_update(topt, double, ours,
                                        params_from_jax(target, "cpu"),
                                        topt.init(ours), tb, 0.99)
    _close(tp, jp, UPDATE_TOL, "dqn")
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=UPDATE_TOL,
                               atol=UPDATE_TOL)
    np.testing.assert_allclose(ttd.numpy(), np.asarray(jtd),
                               rtol=UPDATE_TOL, atol=UPDATE_TOL)


# -------------------------------------------------------------------- SAC --

def test_sac_update_matches_jax_with_its_noise():
    import jax
    import jax.numpy as jnp
    import optax
    from ray_tpu.rl.ppo import init_mlp
    from ray_tpu.rl.sac import sac_update

    obs, act, hidden, K, B = 3, 1, 32, 3, 16
    ka, k1, k2 = jax.random.split(jax.random.PRNGKey(0), 3)
    q = [obs + act, hidden, hidden, 1]
    params = {"actor": init_mlp(ka, [obs, hidden, hidden, 2 * act]),
              "q": (init_mlp(k1, q, scale_last=1.0),
                    init_mlp(k2, q, scale_last=1.0)),
              "log_alpha": jnp.asarray(np.log(0.2), jnp.float32)}
    target_q = jax.tree.map(jnp.copy, params["q"])
    jopts = (optax.adam(3e-3), optax.adam(3e-3), optax.adam(3e-3))
    jstates = {"actor": jopts[0].init(params["actor"]),
               "q": jopts[1].init(params["q"]),
               "alpha": jopts[2].init(params["log_alpha"])}
    rng = np.random.default_rng(6)
    batches = {"obs": rng.normal(size=(K, B, obs)).astype(np.float32),
               "actions": rng.uniform(-2, 2, (K, B, act)).astype(np.float32),
               "rewards": rng.normal(size=(K, B)).astype(np.float32),
               "next_obs": rng.normal(size=(K, B, obs)).astype(np.float32),
               "dones": (rng.random((K, B)) < 0.1).astype(np.float32)}
    keys = jax.random.split(jax.random.PRNGKey(7), K)
    jp, jtq, _, jql, jal, jalpha = sac_update(
        jopts, 0.99, -1.0, params, target_q, jstates,
        jax.tree.map(jnp.asarray, batches), keys, 2.0, 0.01)
    noise = np.stack([
        np.stack([np.asarray(jax.random.normal(k_, (B, act)))
                  for k_ in jax.random.split(k)]) for k in keys])
    tp = params_from_jax(params, "cpu")
    ttq = tree_map(lambda t: t.detach().clone(), tp["q"])
    topts = (optim.adam(3e-3), optim.adam(3e-3), optim.adam(3e-3))
    tstates = {"actor": topts[0].init(tp["actor"]),
               "q": topts[1].init(tp["q"]),
               "alpha": topts[2].init(tp["log_alpha"])}
    tp, ttq, _, tql, tal, talpha = tsac.sac_update(
        topts, 0.99, -1.0, tp, ttq, tstates,
        {k: _t(v) for k, v in batches.items()}, _t(noise), 2.0, 0.01)
    assert isinstance(tp["q"], tuple)
    _close(tp, jp, UPDATE_TOL, "params")
    _close(ttq, jtq, UPDATE_TOL, "target q")
    for got, want in ((tql, jql), (tal, jal), (talpha, jalpha)):
        np.testing.assert_allclose(float(got), float(want), rtol=UPDATE_TOL,
                                   atol=UPDATE_TOL)


# ------------------------------------------------------------- trainables --

def _roundtrip(algo, build):
    ckpt = algo.save_checkpoint()
    assert all(isinstance(x, np.ndarray)
               for x in tree_leaves(ckpt["params"]))
    other = build()
    other.load_checkpoint(ckpt)
    for a, b in zip(tree_leaves(params_to_numpy(other.params)),
                    tree_leaves(params_to_numpy(algo.params))):
        np.testing.assert_array_equal(a, b)
    assert other.iteration == algo.iteration
    other.cleanup()


@pytest.mark.parametrize("prioritized", [False, True])
def test_dqn_steps_and_checkpoints(prioritized):
    build = lambda: DQNConfig(learning_starts=64, rollout_len=8,
                              num_envs_per_runner=4, batch_size=32,
                              train_batches_per_step=4,
                              prioritized_replay=prioritized,
                              device="cpu").build()
    algo = build()
    losses = [algo.train_step()["td_loss"] for _ in range(4)]
    assert losses[0] == 0.0 and all(np.isfinite(losses)) and losses[-1] > 0
    assert algo.env_steps == 4 * 8 * 4
    _roundtrip(algo, build)


def test_sac_steps_checkpoints_and_rejects_discrete_envs():
    build = lambda: SACConfig(learning_starts=64, rollout_len=8,
                              num_envs_per_runner=4, batch_size=32,
                              train_batches_per_step=4, hidden=32,
                              device="cpu").build()
    algo = build()
    ms = [algo.train_step() for _ in range(3)]
    assert all(np.isfinite([m["q_loss"], m["actor_loss"], m["alpha"]]).all()
               for m in ms)
    assert ms[-1]["q_loss"] > 0 and 0 < ms[-1]["alpha"] < 0.2
    _roundtrip(algo, build)
    with pytest.raises(ValueError, match="continuous"):
        SACConfig(env="CartPole-v1", device="cpu").build()


@pytest.mark.parametrize("cfg_cls", [ImpalaConfig, APPOConfig])
def test_impala_and_appo_step_and_checkpoint(cfg_cls):
    build = lambda: cfg_cls(num_envs_per_runner=4, rollout_len=16,
                            device="cpu").build()
    algo = build()
    ms = [algo.train_step() for _ in range(3)]
    assert all(np.isfinite([m["policy_loss"], m["vf_loss"],
                            m["entropy"]]).all() for m in ms)
    assert ms[-1]["weight_version"] == 3
    assert ms[-1]["num_env_steps_sampled"] == 4 * 16
    _roundtrip(algo, build)
    with pytest.raises(NotImplementedError, match="actor runtime"):
        cfg_cls(num_env_runners=2, device="cpu").build()


def test_impala_learns_cartpole_inline():
    """The V-trace learner's return rises well above a random policy's
    (~22) within a few dozen inline steps."""
    algo = ImpalaConfig(num_envs_per_runner=8, rollout_len=64, lr=5e-4,
                        seed=0, device="cpu").build()
    best = 0.0
    for _ in range(60):
        best = max(best, algo.train_step()["episode_return_mean"])
        if best >= 60.0:
            break
    assert best >= 60.0, best


@pytest.mark.parametrize("cfg", [
    PPOConfig(), PPOConfig(vectorized=True, num_envs=4, unroll_len=4),
    DQNConfig(), SACConfig(), ImpalaConfig(), APPOConfig()],
    ids=["ppo", "anakin", "dqn", "sac", "impala", "appo"])
def test_configs_default_to_the_card_and_refuse_without_one(cfg):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cfg.build()
