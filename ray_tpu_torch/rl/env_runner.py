"""EnvRunner: rollout collection from numpy envs on the host.

Port of ray_tpu/rl/env_runner.py (reference: rllib/env/env_runner.py:36,
single_agent_env_runner.py:67 sample()): a runner holds vectorized numpy
envs and the current policy params and returns fixed-length trajectory
batches. The policy's ``act_fn`` may run on a card; the envs stay on the
host. ``EnvRunnerGroup`` runs its runner inline: runner actors
(``num_runners > 0``) need the actor runtime, which the port does not
have yet.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from ray_tpu_torch.rl.env import VectorEnv

RUNTIME_MISSING = ("needs the actor runtime (ray_tpu.remote/get/put), "
                   "which the PyTorch port does not have yet (ROADMAP "
                   "Queue A item 7)")


def _frozen_apply(pipeline, x):
    """Apply a pipeline without updating stateful connectors."""
    if hasattr(pipeline, "frozen_apply"):
        return pipeline.frozen_apply(x)
    prior = getattr(pipeline, "frozen", False)
    pipeline.frozen = True
    try:
        return pipeline(x)
    finally:
        pipeline.frozen = prior


class EnvRunner:
    """One runner = N vectorized envs + a policy-apply function."""

    def __init__(self, env_name: str, num_envs: int, rollout_len: int,
                 policy_factory: Callable, seed: int = 0,
                 env_to_module=None, module_to_env=None):
        self.vec = VectorEnv(env_name, num_envs, seed=seed)
        self.rollout_len = rollout_len
        # policy_factory() -> (act_fn, initial_params); act_fn(params, obs,
        # rng_seed) -> (actions, logp, value) as numpy.
        self.act_fn, self.params = policy_factory()
        # Observations flow through env_to_module before the policy,
        # actions through module_to_env before the env. Batches store the
        # TRANSFORMED obs and the MODEL-space actions.
        self.env_to_module = env_to_module
        self.module_to_env = module_to_env
        raw = self.vec.reset()
        self.obs = (self.env_to_module(raw) if self.env_to_module
                    else raw)
        self._seed = seed
        self._step = 0

    def set_weights(self, params: Any) -> None:
        self.params = params

    def sample(self) -> dict:
        """Collect rollout_len steps per env: a [T, N, ...] batch plus the
        bootstrap values the learner's GAE needs."""
        T, N = self.rollout_len, self.vec.num_envs
        obs_b = np.zeros((T, N, self.obs.shape[-1]), np.float32)
        act_b = None  # allocated from the first action batch: discrete
        # policies emit [N] ints, continuous ones [N, act_dim] floats
        logp_b = np.zeros((T, N), np.float32)
        val_b = np.zeros((T, N), np.float32)
        rew_b = np.zeros((T, N), np.float32)
        done_b = np.zeros((T, N), np.bool_)
        term_b = np.zeros((T, N), np.bool_)
        next_obs_b = np.zeros((T, N, self.obs.shape[-1]), np.float32)

        for t in range(T):
            self._step += 1
            actions, logp, value = self.act_fn(self.params, self.obs,
                                               self._seed * 100_003 + self._step)
            if act_b is None:
                act_b = np.zeros((T,) + np.shape(actions),
                                 np.asarray(actions).dtype)
            obs_b[t] = self.obs
            act_b[t], logp_b[t], val_b[t] = actions, logp, value
            env_actions = (self.module_to_env(actions)
                           if self.module_to_env else actions)
            raw_obs, rew_b[t], done_b[t] = self.vec.step(env_actions)
            term_b[t] = self.vec.last_terminals
            raw_next = self.vec.last_final_obs  # pre-reset successors
            if self.env_to_module is not None:
                # next_obs passes through the pipeline WITHOUT mutating
                # stateful connectors (a bootstrap input, not a policy
                # step); episode boundaries reset per-env state.
                next_obs_b[t] = _frozen_apply(self.env_to_module, raw_next)
                for i in np.nonzero(done_b[t])[0]:
                    self.env_to_module.reset(int(i))
                self.obs = self.env_to_module(raw_obs)
            else:
                next_obs_b[t] = raw_next
                self.obs = raw_obs
        _, _, last_value = self.act_fn(self.params, self.obs,
                                       self._seed * 100_003 + self._step + 1)
        return {
            "obs": obs_b, "actions": act_b, "logp": logp_b, "values": val_b,
            "rewards": rew_b, "dones": done_b, "terminals": term_b,
            "next_obs": next_obs_b, "last_values": last_value,
            "last_obs": np.asarray(self.obs, np.float32),  # 1-step targets
            "episode_returns": self.vec.drain_episode_returns(),
        }

    def connector_state(self) -> dict:
        out = {}
        if self.env_to_module is not None:
            out["env_to_module"] = self.env_to_module.state_dict()
        if self.module_to_env is not None:
            out["module_to_env"] = self.module_to_env.state_dict()
        return out

    def set_connector_state(self, state: dict) -> None:
        if self.env_to_module is not None and "env_to_module" in state:
            self.env_to_module.set_state(state["env_to_module"])
        if self.module_to_env is not None and "module_to_env" in state:
            self.module_to_env.set_state(state["module_to_env"])


class EnvRunnerGroup:
    """One inline runner (reference: num_env_runners=0 -> local
    EnvRunner). Runner actors raise ``NotImplementedError``."""

    def __init__(self, env_name: str, *, num_runners: int = 0,
                 num_envs_per_runner: int = 8, rollout_len: int = 64,
                 policy_factory: Callable, seed: int = 0,
                 connector_factory: Callable | None = None):
        """connector_factory() -> (env_to_module, module_to_env)
        pipelines."""
        if num_runners > 0:
            raise NotImplementedError(
                f"EnvRunnerGroup(num_runners={num_runners}) "
                + RUNTIME_MISSING + "; use num_runners=0")
        e2m, m2e = (connector_factory() if connector_factory
                    else (None, None))
        self._local = EnvRunner(env_name, num_envs_per_runner, rollout_len,
                                policy_factory, seed=seed,
                                env_to_module=e2m, module_to_env=m2e)

    def sample(self, params) -> list[dict]:
        self._local.set_weights(params)
        return [self._local.sample()]

    def connector_state(self) -> dict:
        return self._local.connector_state()

    def set_connector_state(self, state: dict) -> None:
        if state:
            self._local.set_connector_state(state)

    def shutdown(self) -> None:
        pass
