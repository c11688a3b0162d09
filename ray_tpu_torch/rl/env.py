"""Environments: a dependency-free CartPole + vectorization.

The reference's env runners wrap gymnasium (reference:
rllib/env/single_agent_env_runner.py builds gym vector envs); this image has
no gym, so the classic control task is implemented directly (same physics
and termination constants as CartPole-v1) behind the same reset/step
surface. ``make_env`` is the registry hook custom envs plug into.

The port's own copy of ray_tpu/rl/env.py (numpy, f64 physics): the same
seed gives the same episodes. The batched torch envs of the fused path
are in rl/vec_env.py.
"""

from __future__ import annotations

import numpy as np


class CartPoleEnv:
    """CartPole-v1 physics: push a cart ±10N to balance a pole.

    obs = [x, x_dot, theta, theta_dot]; reward 1 per step; terminates at
    |x| > 2.4 or |theta| > 12deg; truncates at 500 steps.
    """

    GRAVITY = 9.8
    CART_M = 1.0
    POLE_M = 0.1
    POLE_L = 0.5  # half-length
    FORCE = 10.0
    DT = 0.02
    THETA_LIMIT = 12 * 2 * np.pi / 360
    X_LIMIT = 2.4
    MAX_STEPS = 500

    observation_size = 4
    num_actions = 2

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros(4, np.float64)
        self._steps = 0

    def reset(self) -> np.ndarray:
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._steps = 0
        return self._state.astype(np.float32)

    def step(self, action: int):
        x, x_dot, th, th_dot = self._state
        force = self.FORCE if action == 1 else -self.FORCE
        total_m = self.CART_M + self.POLE_M
        pm_l = self.POLE_M * self.POLE_L
        cos, sin = np.cos(th), np.sin(th)
        temp = (force + pm_l * th_dot**2 * sin) / total_m
        th_acc = (self.GRAVITY * sin - cos * temp) / (
            self.POLE_L * (4.0 / 3.0 - self.POLE_M * cos**2 / total_m))
        x_acc = temp - pm_l * th_acc * cos / total_m
        x += self.DT * x_dot
        x_dot += self.DT * x_acc
        th += self.DT * th_dot
        th_dot += self.DT * th_acc
        self._state = np.array([x, x_dot, th, th_dot])
        self._steps += 1
        terminated = bool(abs(x) > self.X_LIMIT or abs(th) > self.THETA_LIMIT)
        truncated = self._steps >= self.MAX_STEPS
        return (self._state.astype(np.float32), 1.0, terminated, truncated)


class PendulumEnv:
    """Pendulum-v1 physics: swing up and balance with bounded torque.

    Continuous control: obs = [cos th, sin th, th_dot], action = torque in
    [-2, 2]; reward = -(th^2 + 0.1 th_dot^2 + 0.001 a^2); 200-step
    episodes (no termination). Same constants as the gym classic."""

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0
    MAX_STEPS = 200

    observation_size = 3
    action_size = 1
    continuous = True
    action_limit = MAX_TORQUE  # |action| bound, part of the env protocol

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._th = 0.0
        self._th_dot = 0.0
        self._steps = 0

    def _obs(self) -> np.ndarray:
        return np.array([np.cos(self._th), np.sin(self._th), self._th_dot],
                        np.float32)

    def reset(self) -> np.ndarray:
        self._th = self._rng.uniform(-np.pi, np.pi)
        self._th_dot = self._rng.uniform(-1.0, 1.0)
        self._steps = 0
        return self._obs()

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          -self.MAX_TORQUE, self.MAX_TORQUE))
        th = ((self._th + np.pi) % (2 * np.pi)) - np.pi  # angle-normalize
        cost = th**2 + 0.1 * self._th_dot**2 + 0.001 * u**2
        self._th_dot += (3 * self.G / (2 * self.L) * np.sin(self._th)
                         + 3.0 / (self.M * self.L**2) * u) * self.DT
        self._th_dot = float(np.clip(self._th_dot, -self.MAX_SPEED,
                                     self.MAX_SPEED))
        self._th += self._th_dot * self.DT
        self._steps += 1
        return self._obs(), -float(cost), False, self._steps >= self.MAX_STEPS


_ENV_REGISTRY = {"CartPole-v1": CartPoleEnv, "Pendulum-v1": PendulumEnv}


def register_env(name: str, ctor) -> None:
    _ENV_REGISTRY[name] = ctor


def make_env(name: str, seed: int = 0):
    try:
        return _ENV_REGISTRY[name](seed=seed)
    except KeyError:
        raise ValueError(f"unknown env {name!r}; register_env() it first")


class VectorEnv:
    """N independent env copies with auto-reset on episode end (reference:
    gym vector env semantics the runner expects)."""

    def __init__(self, name: str, num_envs: int, seed: int = 0):
        self.envs = [make_env(name, seed=seed + i) for i in range(num_envs)]
        self.num_envs = num_envs
        self.episode_returns = np.zeros(num_envs)
        self.completed_returns: list[float] = []
        self.last_terminals = np.zeros(num_envs, np.bool_)

    def reset(self) -> np.ndarray:
        self.episode_returns[:] = 0.0
        return np.stack([e.reset() for e in self.envs])

    def step(self, actions: np.ndarray):
        obs, rewards, dones = [], [], []
        terms, finals = [], []
        for i, (env, a) in enumerate(zip(self.envs, actions)):
            o, r, term, trunc = env.step(
                a if getattr(env, "continuous", False) else int(a))
            self.episode_returns[i] += r
            done = term or trunc
            final = o  # the TRUE successor obs, before any auto-reset
            if done:
                self.completed_returns.append(self.episode_returns[i])
                self.episode_returns[i] = 0.0
                o = env.reset()
            obs.append(o)
            rewards.append(r)
            dones.append(done)
            terms.append(term)
            finals.append(final)
        # TD targets must bootstrap THROUGH time-limit truncations (only
        # true terminations have zero future value) — gym's term/trunc
        # split. last_final_obs carries the pre-reset successor obs so the
        # truncation bootstrap targets V(final state), not V(reset state).
        self.last_terminals = np.asarray(terms, np.bool_)
        self.last_final_obs = np.stack(finals).astype(np.float32)
        return (np.stack(obs), np.asarray(rewards, np.float32),
                np.asarray(dones, np.bool_))

    def drain_episode_returns(self) -> list[float]:
        out, self.completed_returns = self.completed_returns, []
        return out
