"""ray_tpu_torch.rl's multi-agent stack (the envs, the runner's routing,
MultiAgentPPO with shared and independent policies) against
ray_tpu.rl.multi_agent on the same inputs.

The envs are numpy copies: the same seeds and actions give the same
observations, rewards and dones, bit for bit. JAX's randomness is handed
over: the port's runner replays the actions JAX's runner drew, and its
updates take the minibatch permutations JAX's ``ppo_update`` draws from
``seed + iteration``. Tolerances (f32): the runner's log-probs and
values 1e-6 of max(1, the largest |value|); params and PPO stats after
each of two steps 1e-5. JAX is imported inside the tests.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch._device import tree_leaves, tree_map
from ray_tpu_torch.rl import MultiAgentEnvRunner, MultiAgentPPOConfig
from ray_tpu_torch.rl import ppo as tppo
from ray_tpu_torch.rl.ppo import params_from_jax, params_to_numpy

F32_TOL = 1e-6
UPDATE_TOL = 1e-5
INDEPENDENT = dict(env="ChaseGame", policies=("pred", "prey"),
                   policy_mapping={"pred0": "pred", "pred1": "pred",
                                   "prey": "prey"})


def _close(got, want, tol, label=""):
    import jax

    pairs = []
    tree_map(lambda a, b: pairs.append((a, b)), got,
             jax.tree.map(np.asarray, want))
    for i, (a, b) in enumerate(pairs):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol,
                                   err_msg=f"{label} leaf {i}")


@pytest.mark.parametrize("name,kw", [
    ("CoordinationGame", {}), ("CoordinationGame", {"horizon": 5}),
    ("ChaseGame", {}), ("ChaseGame", {"size": 6, "horizon": 20})])
def test_envs_match_jax_over_random_actions(name, kw):
    from ray_tpu.rl import multi_agent as jma
    from ray_tpu_torch.rl import multi_agent as tma

    ours = tma.make_multi_agent_env(name, seed=3, **kw)
    want = jma.make_multi_agent_env(name, seed=3, **kw)
    assert ours.agent_ids == want.agent_ids
    assert (ours.observation_size, ours.num_actions) == (
        want.observation_size, want.num_actions)
    rng = np.random.default_rng(0)
    o, w = ours.reset(), want.reset()
    ends = 0
    for _ in range(300):
        for a in want.agent_ids:
            np.testing.assert_array_equal(o[a], w[a])
            assert o[a].dtype == w[a].dtype
        acts = {a: int(rng.integers(want.num_actions))
                for a in want.agent_ids}
        o, r, d = ours.step(acts)
        w, rw, dw = want.step(acts)
        assert r == rw and d == dw
        if dw["__all__"]:
            ends += 1
            o, w = ours.reset(), want.reset()
    assert ends > 0
    if name == "ChaseGame":
        assert (ours.captures, ours.episodes) == (want.captures,
                                                  want.episodes)


def _recording(fn, log):
    def act(p, obs, seed):
        out = fn(p, obs, seed)
        log.append(np.asarray(out[0]))
        return out
    return act


def _replaying(log):
    """An act_fn that takes the recorded actions, in order."""
    it = iter(log)

    def act(p, obs, seed):
        a = torch.from_numpy(np.array(next(it))).long()
        return tuple(t.numpy() for t in tppo._act(
            p, torch.from_numpy(obs), actions=a))
    return act


def _jax_policies(n, hidden=32, obs=5, actions=3):
    import jax
    from ray_tpu.rl.ppo import init_policy

    return [init_policy(jax.random.PRNGKey(i), obs, actions, hidden)
            for i in range(n)]


@pytest.mark.parametrize("independent", [False, True],
                         ids=["shared", "independent"])
def test_runner_routes_agents_like_jax_given_its_actions(independent):
    import jax.numpy as jnp
    from ray_tpu.rl import multi_agent as jma
    from ray_tpu.rl.ppo import _act

    if independent:
        env, pids = "ChaseGame", ("pred", "prey")
        mapping = INDEPENDENT["policy_mapping"].get
        obs_size, n_act = 5, 3
    else:
        env, pids = "CoordinationGame", ("shared",)
        mapping = lambda agent: "shared"  # noqa: E731
        obs_size, n_act = 5, 2
    params = dict(zip(pids, _jax_policies(len(pids), obs=obs_size,
                                          actions=n_act)))

    def jact(p, obs, seed):
        a, lp, v = _act(p, jnp.asarray(obs), seed)
        return np.asarray(a), np.asarray(lp), np.asarray(v)

    logs = {pid: [] for pid in pids}
    jr = jma.MultiAgentEnvRunner(env, 40, mapping,
                                 {pid: _recording(jact, logs[pid])
                                  for pid in pids}, seed=2)
    tr = MultiAgentEnvRunner(env, 40, mapping,
                             {pid: _replaying(logs[pid]) for pid in pids},
                             seed=2)
    assert tr._slots == jr._slots
    jr.set_weights(params)
    tr.set_weights(params_from_jax(params, "cpu"))
    ends = 0
    for _ in range(2):
        want, got = jr.sample(), tr.sample()
        ends += len(want["__episode_returns__"])
        assert set(got) == set(want)
        for key in ("__episode_returns__", "__agent_episode_returns__"):
            assert got[key] == want[key]
        for pid in pids:
            K = len(jr._slots[pid])
            for k in ("obs", "actions", "rewards", "dones"):
                assert got[pid][k].shape[:2] == (40, K)
                assert got[pid][k].dtype == want[pid][k].dtype
                np.testing.assert_array_equal(got[pid][k], want[pid][k])
            for k in ("logp", "values", "last_values"):
                w = np.asarray(want[pid][k])
                tol = F32_TOL * max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(got[pid][k], w, rtol=0, atol=tol)
    assert ends > 0


def _jax_idxs(seed, B, num_mb, epochs):
    import jax

    mb = B // num_mb
    return np.stack([
        np.asarray(jax.random.permutation(k, B))[: num_mb * mb].reshape(
            num_mb, mb)
        for k in jax.random.split(jax.random.PRNGKey(seed), epochs)])


@pytest.mark.parametrize("independent", [False, True],
                         ids=["shared", "independent"])
def test_multi_agent_ppo_step_matches_jax(independent):
    """Two steps of the port's MultiAgentPPO against JAX's from JAX's
    initial params, with JAX's actions and permutations."""
    from ray_tpu.rl.multi_agent import MultiAgentPPOConfig as JConfig

    kw = dict(rollout_len=32, num_minibatches=2, num_epochs=2, lr=1e-3,
              seed=1, **(INDEPENDENT if independent else {}))
    jalgo = JConfig(**kw).build()
    ours = MultiAgentPPOConfig(**kw, device="cpu").build()
    ours.policies = params_from_jax(jalgo.policies, "cpu")
    ours.opt_states = {pid: ours.optimizer.init(p)
                       for pid, p in ours.policies.items()}
    logs = {pid: [] for pid in jalgo.policies}
    jalgo._runner.act_fns = {pid: _recording(f, logs[pid]) for pid, f in
                             jalgo._runner.act_fns.items()}
    ours._runner.act_fns = {pid: _replaying(logs[pid])
                            for pid in ours.policies}
    ours.minibatch_idxs = lambda rows: torch.from_numpy(_jax_idxs(
        kw["seed"] + ours.iteration, rows, kw["num_minibatches"],
        kw["num_epochs"])).long()
    for step in range(2):
        jm = jalgo.train_step()
        tm = ours.train_step()
        _close(ours.policies, jalgo.policies, UPDATE_TOL, f"step {step}")
        assert set(tm) == set(jm) and tm["policies"] == jm["policies"]
        for k, v in jm.items():
            if isinstance(v, float):
                np.testing.assert_allclose(tm[k], v, rtol=UPDATE_TOL,
                                           atol=UPDATE_TOL, err_msg=k)
    assert len(ours.policies) == (2 if independent else 1)


def test_multi_agent_ppo_checkpoints_and_refuses_runner_actors():
    build = lambda: MultiAgentPPOConfig(  # noqa: E731
        rollout_len=16, device="cpu", **INDEPENDENT).build()
    algo = build()
    algo.train_step()
    ckpt = algo.save_checkpoint()
    assert all(isinstance(x, np.ndarray)
               for x in tree_leaves(ckpt["policies"]))
    other = build()
    other.load_checkpoint(ckpt)
    for a, b in zip(tree_leaves(params_to_numpy(other.policies)),
                    tree_leaves(params_to_numpy(algo.policies))):
        np.testing.assert_array_equal(a, b)
    assert other.iteration == 1
    other.train_step()
    with pytest.raises(NotImplementedError, match="actor runtime"):
        MultiAgentPPOConfig(num_env_runners=2, device="cpu").build()


def test_config_defaults_to_the_card_and_refuses_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    cfg = MultiAgentPPOConfig()
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cfg.build()
