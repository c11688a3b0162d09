"""Multi-agent RL: the MultiAgentEnv protocol, its runner, multi-policy PPO.

Port of ray_tpu/rl/multi_agent.py (reference: rllib/env/
multi_agent_env.py: dict-keyed obs/reward/done per agent with the
"__all__" episode terminator; multi_agent_env_runner.py routes each
agent to the policy ``policy_mapping_fn`` assigns it, and every policy
updates on its own batch). The envs and the runner are the JAX package's
numpy code, copied; the policies act and learn on ``cfg.device`` through
PPO's ``_act``, ``compute_gae`` and ``ppo_update``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.env_runner import RUNTIME_MISSING
from ray_tpu_torch.rl.ppo import (
    _act,
    compute_gae,
    host_act_fn,
    init_policy,
    params_from_jax,
    params_to_numpy,
    permutation_idxs,
    ppo_update,
)
from ray_tpu_torch.train.optim import adam
from ray_tpu_torch.tune.trainable import Trainable


class MultiAgentEnv:
    """Dict-keyed multi-agent episode protocol (reference:
    multi_agent_env.py): reset() -> {agent: obs}; step({agent: action}) ->
    (obs, rewards, dones) dicts, with dones["__all__"] ending the episode."""

    agent_ids: tuple[str, ...] = ()
    observation_size: int = 0
    num_actions: int = 0

    def reset(self) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: dict[str, int]):
        raise NotImplementedError


class CoordinationGame(MultiAgentEnv):
    """Two agents earn +1 each step their actions MATCH; episodes last
    ``horizon`` steps. Observations: one-hot of the previous joint action
    plus the step fraction — enough signal for independent policies to
    lock onto one equilibrium. Optimal per-agent episode return ==
    horizon."""

    agent_ids = ("a0", "a1")
    observation_size = 5
    num_actions = 2

    def __init__(self, horizon: int = 16, seed: int = 0):
        self.horizon = horizon
        self._rng = np.random.default_rng(seed)
        self._t = 0
        self._last = (0, 0)

    def _obs(self) -> dict[str, np.ndarray]:
        joint = np.zeros(4, np.float32)
        joint[self._last[0] * 2 + self._last[1]] = 1.0
        frac = np.array([self._t / self.horizon], np.float32)
        o = np.concatenate([joint, frac])
        return {a: o.copy() for a in self.agent_ids}

    def reset(self) -> dict[str, np.ndarray]:
        self._t = 0
        self._last = (int(self._rng.integers(2)), int(self._rng.integers(2)))
        return self._obs()

    def step(self, actions: dict[str, int]):
        self._t += 1
        a0, a1 = int(actions["a0"]), int(actions["a1"])
        self._last = (a0, a1)
        r = 1.0 if a0 == a1 else 0.0
        rewards = {a: r for a in self.agent_ids}
        done = self._t >= self.horizon
        dones = {a: done for a in self.agent_ids}
        dones["__all__"] = done
        return self._obs(), rewards, dones


class ChaseGame(MultiAgentEnv):
    """Mixed cooperative-competitive pursuit on a ring (the predator-prey
    shape of rllib's multi-agent examples): two predators share a team
    objective — corner the prey — while the prey's reward is zero-sum
    against them. Exercises heterogeneous policies (predator vs prey
    objectives), one policy serving MULTIPLE agent slots, and true
    terminations (capture) alongside time-limit truncation.

    Ring of ``size`` cells; actions {left, stay, right}. Capture (any
    predator on the prey's cell): predators +5, prey -5, episode ends.
    Per step: predators -0.05 (time pressure), prey +0.05 (survival).

    The ring must be large enough that random predators DON'T stumble
    into captures within a few steps — on size 12 a random-policy
    predator already returned ~4.6 of the ~4.95 ceiling, leaving no
    learnable headroom (the root cause of the long-skipped predator-gain
    test); at 20 cells random play mostly times out (~1.7 return) and
    directed pursuit is something the policy has to learn."""

    agent_ids = ("pred0", "pred1", "prey")
    observation_size = 5
    num_actions = 3

    def __init__(self, size: int = 20, horizon: int = 64, seed: int = 0):
        self.size = size
        self.horizon = horizon
        self._rng = np.random.default_rng(seed)
        self._pos = {a: 0 for a in self.agent_ids}
        self._t = 0
        self.captures = 0
        self.episodes = 0

    def _rel(self, a: str, b: str) -> tuple[float, float]:
        ang = 2 * np.pi * (self._pos[b] - self._pos[a]) / self.size
        return np.sin(ang), np.cos(ang)

    def _obs(self) -> dict[str, np.ndarray]:
        frac = self._t / self.horizon
        out = {}
        for a in self.agent_ids:
            others = [x for x in self.agent_ids if x != a]
            feats = []
            for o in others:
                feats.extend(self._rel(a, o))
            feats.append(frac)
            out[a] = np.asarray(feats, np.float32)
        return out

    def reset(self) -> dict[str, np.ndarray]:
        self._t = 0
        cells = self._rng.choice(self.size, size=3, replace=False)
        for a, c in zip(self.agent_ids, cells):
            self._pos[a] = int(c)
        return self._obs()

    def step(self, actions: dict[str, int]):
        self._t += 1
        for a in self.agent_ids:
            self._pos[a] = (self._pos[a] + int(actions[a]) - 1) % self.size
        caught = (self._pos["prey"] == self._pos["pred0"]
                  or self._pos["prey"] == self._pos["pred1"])
        if caught:
            rewards = {"pred0": 5.0, "pred1": 5.0, "prey": -5.0}
        else:
            rewards = {"pred0": -0.05, "pred1": -0.05, "prey": 0.05}
        done = caught or self._t >= self.horizon
        if done:
            self.episodes += 1
            if caught:
                self.captures += 1
        dones = {a: done for a in self.agent_ids}
        dones["__all__"] = done
        return self._obs(), rewards, dones


def make_multi_agent_env(name: str, seed: int = 0,
                         **kwargs) -> MultiAgentEnv:
    if name == "CoordinationGame":
        return CoordinationGame(seed=seed, **kwargs)
    if name == "ChaseGame":
        return ChaseGame(seed=seed, **kwargs)
    raise ValueError(f"unknown multi-agent env {name!r}")


class MultiAgentEnvRunner:
    """Per-agent trajectory collection with policy routing (reference:
    multi_agent_env_runner.py): each step, every live agent's observation
    goes to the policy policy_mapping_fn assigns it; experience lands in
    that POLICY's batch. sample() returns {policy_id: [T, K, ...]} where K
    is the number of agent slots mapped to the policy."""

    def __init__(self, env_name: str, rollout_len: int,
                 policy_mapping_fn: Callable[[str], str],
                 act_fns: dict[str, Callable], seed: int = 0,
                 env_kwargs: dict | None = None):
        self.env = make_multi_agent_env(env_name, seed=seed,
                                        **(env_kwargs or {}))
        self.rollout_len = rollout_len
        self.policy_mapping_fn = policy_mapping_fn
        self.act_fns = act_fns
        self.params: dict[str, Any] = {}
        self._seed = seed
        self._step = 0
        self._obs = self.env.reset()
        self._episode_return = 0.0
        self._episode_returns: list[float] = []
        self._agent_return = {a: 0.0 for a in self.env.agent_ids}
        self._agent_returns: list[dict[str, float]] = []
        # Fixed slot order per policy: [T, K] batches need stable columns.
        self._slots: dict[str, list[str]] = {}
        for agent in self.env.agent_ids:
            pid = self.policy_mapping_fn(agent)
            self._slots.setdefault(pid, []).append(agent)

    def set_weights(self, params: dict[str, Any]) -> None:
        self.params = params

    def sample(self) -> dict[str, dict]:
        T = self.rollout_len
        env = self.env
        out: dict[str, dict] = {}
        for pid, agents in self._slots.items():
            K = len(agents)
            out[pid] = {
                "obs": np.zeros((T, K, env.observation_size), np.float32),
                "actions": np.zeros((T, K), np.int32),
                "logp": np.zeros((T, K), np.float32),
                "values": np.zeros((T, K), np.float32),
                "rewards": np.zeros((T, K), np.float32),
                "dones": np.zeros((T, K), np.bool_),
            }
        for t in range(T):
            self._step += 1
            actions: dict[str, int] = {}
            for pid, agents in self._slots.items():
                obs = np.stack([self._obs[a] for a in agents])
                a, lp, v = self.act_fns[pid](
                    self.params[pid], obs,
                    self._seed * 100_003 + self._step)
                b = out[pid]
                b["obs"][t] = obs
                b["actions"][t], b["logp"][t], b["values"][t] = a, lp, v
                for k, agent in enumerate(agents):
                    actions[agent] = int(a[k])
            self._obs, rewards, dones = env.step(actions)
            self._episode_return += float(np.mean(list(rewards.values())))
            for a, r in rewards.items():
                self._agent_return[a] += float(r)
            for pid, agents in self._slots.items():
                b = out[pid]
                b["rewards"][t] = [rewards[a] for a in agents]
                b["dones"][t] = [dones[a] for a in agents]
            if dones.get("__all__"):
                self._episode_returns.append(self._episode_return)
                self._episode_return = 0.0
                self._agent_returns.append(dict(self._agent_return))
                self._agent_return = {a: 0.0 for a in env.agent_ids}
                self._obs = env.reset()
        # Bootstrap values from the current obs under each policy.
        for pid, agents in self._slots.items():
            obs = np.stack([self._obs[a] for a in agents])
            _, _, last_v = self.act_fns[pid](
                self.params[pid], obs, self._seed * 100_003 + self._step + 1)
            out[pid]["last_values"] = np.asarray(last_v, np.float32)
        out["__episode_returns__"] = self._episode_returns
        self._episode_returns = []
        out["__agent_episode_returns__"] = self._agent_returns
        self._agent_returns = []
        return out


@dataclass
class MultiAgentPPOConfig:
    env: str = "CoordinationGame"
    env_kwargs: dict = field(default_factory=dict)
    # policy_ids + mapping: default = one shared policy for every agent
    # (reference: the shared-policy default of multi-agent configs).
    policies: tuple[str, ...] = ("shared",)
    policy_mapping: dict = field(default_factory=dict)  # agent -> policy
    num_env_runners: int = 0          # 0 = inline rollouts (the only one)
    rollout_len: int = 128
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    num_minibatches: int = 4
    num_epochs: int = 4
    hidden: int = 32
    seed: int = 0
    device: str = "cuda"

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO({"ma_config": self})


class MultiAgentPPO(Trainable):
    """Independent/shared-policy PPO over a MultiAgentEnv (reference:
    rllib multi-agent training: each policy updates on the batch its
    agents produced). Actions are drawn per call from a generator seeded
    ``seed * 100_003 + step``, the minibatch permutations from the
    trainable's generator (``minibatch_idxs``)."""

    def setup(self, config: dict) -> None:
        cfg = config.get("ma_config") or MultiAgentPPOConfig(
            **{k: v for k, v in config.items()
               if k in MultiAgentPPOConfig.__dataclass_fields__})
        if cfg.num_env_runners > 0:
            raise NotImplementedError(
                "MultiAgentPPO with num_env_runners > 0 " + RUNTIME_MISSING)
        self.cfg = cfg
        self.device = dev = resolve_device(cfg.device)
        probe = make_multi_agent_env(cfg.env, seed=cfg.seed,
                                     **cfg.env_kwargs)

        def mapping(agent: str) -> str:
            return cfg.policy_mapping.get(agent, cfg.policies[0])

        self.mapping = mapping
        self.policies: dict[str, Any] = {}
        self.opt_states: dict[str, Any] = {}
        self.optimizer = adam(cfg.lr)
        for i, pid in enumerate(cfg.policies):
            self.policies[pid] = init_policy(
                torch.Generator().manual_seed(cfg.seed + i),
                probe.observation_size, probe.num_actions, cfg.hidden,
                device=dev)
            self.opt_states[pid] = self.optimizer.init(self.policies[pid])
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(cfg.seed)
        act = host_act_fn(dev, _act)
        self._runner = MultiAgentEnvRunner(
            cfg.env, cfg.rollout_len, mapping,
            {pid: act for pid in cfg.policies}, seed=cfg.seed,
            env_kwargs=cfg.env_kwargs)
        self._return_window: list[float] = []
        self._policy_returns: dict[str, list[float]] = {}

    def minibatch_idxs(self, rows: int) -> torch.Tensor:
        """[epochs, num_mb, rows // num_mb] indices of one policy's
        update (JAX draws them from ``seed + iteration``)."""
        cfg = self.cfg
        return permutation_idxs(rows, cfg.num_minibatches, cfg.num_epochs,
                                self._gen)

    def _update_policy(self, pid: str, s: dict, idxs: torch.Tensor) -> dict:
        """compute_gae + ppo_update of policy ``pid`` on its ``[T, K]``
        sample ``s`` with minibatch indices ``idxs``; returns the
        update's stats (0-d tensors)."""
        cfg, dev = self.cfg, self.device
        t = {k: torch.as_tensor(s[k], device=dev) for k in
             ("obs", "actions", "logp", "values", "rewards", "dones",
              "last_values")}
        adv, ret = compute_gae(t["rewards"], t["values"], t["dones"],
                               t["last_values"], cfg.gamma, cfg.gae_lambda)
        batch = {"obs": t["obs"].reshape(-1, t["obs"].shape[-1]),
                 "actions": t["actions"].reshape(-1).long(),
                 "logp": t["logp"].reshape(-1),
                 "advantages": adv.reshape(-1),
                 "returns": ret.reshape(-1)}
        static = (cfg.clip, cfg.vf_coef, cfg.ent_coef, cfg.num_minibatches,
                  cfg.num_epochs)
        self.policies[pid], self.opt_states[pid], pstats = ppo_update(
            self.optimizer, static, self.policies[pid],
            self.opt_states[pid], batch, idxs.to(dev))
        return pstats

    def step(self) -> dict:
        self._runner.set_weights(self.policies)
        sample = self._runner.sample()
        self._return_window.extend(sample.pop("__episode_returns__"))
        stats: dict = {}
        # Per-POLICY mean episode return: in mixed-sum envs the all-agent
        # mean washes out (predator gains cancel prey losses).
        for ep in sample.pop("__agent_episode_returns__", []):
            by_pid: dict[str, list[float]] = {}
            for agent, ret in ep.items():
                by_pid.setdefault(self.mapping(agent), []).append(ret)
            for pid, rets in by_pid.items():
                self._policy_returns.setdefault(pid, []).append(
                    float(np.mean(rets)))
        for pid, window in self._policy_returns.items():
            self._policy_returns[pid] = window[-100:]
            stats[f"{pid}/episode_return_mean"] = float(np.mean(window))
        for pid, s in sample.items():
            rows = s["obs"].shape[0] * s["obs"].shape[1]
            pstats = self._update_policy(pid, s, self.minibatch_idxs(rows))
            stats.update({f"{pid}/{k}": float(v) for k, v in pstats.items()})
        self._return_window = self._return_window[-100:]
        mean_ret = (float(np.mean(self._return_window))
                    if self._return_window else 0.0)
        return {"episode_return_mean": mean_ret,
                "policies": list(self.policies), **stats}

    def save_checkpoint(self) -> Any:
        return {"policies": params_to_numpy(self.policies),
                "iteration": self.iteration}

    def load_checkpoint(self, checkpoint: Any) -> None:
        self.policies = params_from_jax(checkpoint["policies"], self.device)
        self.iteration = checkpoint["iteration"]
