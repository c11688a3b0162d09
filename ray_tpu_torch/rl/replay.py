"""Replay buffers for off-policy RL.

Capability parity with the reference's replay stack (reference:
rllib/utils/replay_buffers/replay_buffer.py ReplayBuffer +
prioritized_episode_buffer / PrioritizedReplayBuffer — uniform and
proportional-prioritized sampling with importance weights). Storage is
preallocated numpy rings; sampling returns contiguous minibatches ready for
a learner update. The port's own copy of ray_tpu/rl/replay.py (numpy
only): the same seed samples the same indices.
"""

from __future__ import annotations

import numpy as np


class ReplayBuffer:
    """Uniform ring buffer over (obs, action, reward, next_obs, done)."""

    def __init__(self, capacity: int, obs_size: int, seed: int = 0,
                 action_size: int | None = None):
        """``action_size=None`` stores scalar discrete actions (int32);
        an int stores continuous action vectors (float32, [capacity, A])."""
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_size), np.float32)
        self.next_obs = np.zeros((capacity, obs_size), np.float32)
        if action_size is None:
            self.actions = np.zeros((capacity,), np.int32)
        else:
            self.actions = np.zeros((capacity, action_size), np.float32)
        self.rewards = np.zeros((capacity,), np.float32)
        self.dones = np.zeros((capacity,), np.float32)
        self._rng = np.random.default_rng(seed)
        self._write = 0
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def add_batch(self, obs, actions, rewards, next_obs, dones) -> None:
        n = len(actions)
        idx = (self._write + np.arange(n)) % self.capacity
        self.obs[idx] = obs
        self.actions[idx] = actions
        self.rewards[idx] = rewards
        self.next_obs[idx] = next_obs
        self.dones[idx] = dones
        self._write = (self._write + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def _gather(self, idx: np.ndarray) -> dict:
        return {
            "obs": self.obs[idx], "actions": self.actions[idx],
            "rewards": self.rewards[idx], "next_obs": self.next_obs[idx],
            "dones": self.dones[idx],
        }

    def sample(self, batch_size: int) -> dict:
        idx = self._rng.integers(0, self._size, batch_size)
        return self._gather(idx)


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (reference: PrioritizedReplayBuffer;
    PER, Schaul et al.): P(i) ∝ p_i^alpha, importance weights
    w_i = (N·P(i))^-beta / max w. Priorities start at the running max so new
    transitions are sampled at least once."""

    def __init__(self, capacity: int, obs_size: int, *, alpha: float = 0.6,
                 beta: float = 0.4, seed: int = 0,
                 action_size: int | None = None):
        super().__init__(capacity, obs_size, seed=seed,
                         action_size=action_size)
        self.alpha, self.beta = alpha, beta
        self._prio = np.zeros((capacity,), np.float64)
        self._max_prio = 1.0

    def add_batch(self, obs, actions, rewards, next_obs, dones) -> None:
        n = len(actions)
        idx = (self._write + np.arange(n)) % self.capacity
        super().add_batch(obs, actions, rewards, next_obs, dones)
        self._prio[idx] = self._max_prio

    def sample(self, batch_size: int) -> dict:
        p = self._prio[: self._size] ** self.alpha
        probs = p / p.sum()
        idx = self._rng.choice(self._size, batch_size, p=probs)
        batch = self._gather(idx)
        w = (self._size * probs[idx]) ** (-self.beta)
        batch["weights"] = (w / w.max()).astype(np.float32)
        batch["idx"] = idx
        return batch

    def update_priorities(self, idx: np.ndarray, td_errors: np.ndarray) -> None:
        prio = np.abs(td_errors) + 1e-6
        self._prio[idx] = prio
        self._max_prio = max(self._max_prio, float(prio.max()))
