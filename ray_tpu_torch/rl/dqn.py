"""DQN: off-policy Q-learning with replay and a target network, in PyTorch.

Port of ray_tpu/rl/dqn.py (reference: rllib/algorithms/dqn/dqn.py: replay
buffer, optionally prioritized; epsilon-greedy exploration; target network
sync; double-DQN targets; the Algorithm is a Tune Trainable). Rollouts
come from the inline EnvRunner on the host, the Q network runs and learns
on ``cfg.device``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.env_runner import EnvRunnerGroup
from ray_tpu_torch.rl.ppo import (
    clone_params,
    init_mlp,
    mlp_apply,
    params_from_jax,
    params_to_numpy,
    sgd_step,
)
from ray_tpu_torch.rl.replay import PrioritizedReplayBuffer, ReplayBuffer
from ray_tpu_torch.train.optim import adam
from ray_tpu_torch.tune.trainable import Trainable


@torch.no_grad()
def _greedy_q(params, obs):
    return mlp_apply(params, obs)


def _take(q: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    return q.gather(1, actions.long()[:, None])[:, 0]


def dqn_loss(params, target_params, batch: dict, gamma: float,
             double_dqn: bool):
    """Importance-weighted Huber (delta 1, ``optax.huber_loss``) TD loss
    of one minibatch, and its TD errors."""
    q_sa = _take(mlp_apply(params, batch["obs"]), batch["actions"])
    with torch.no_grad():
        q_next_t = mlp_apply(target_params, batch["next_obs"])
        if double_dqn:
            # The online net picks the argmax, the target net values it.
            a_star = mlp_apply(params, batch["next_obs"]).argmax(-1)
            q_next = _take(q_next_t, a_star)
        else:
            q_next = q_next_t.max(-1).values
        target = batch["rewards"] + gamma * (1.0 - batch["dones"]) * q_next
    td = q_sa.detach() - target
    huber = F.huber_loss(q_sa, target, reduction="none", delta=1.0)
    w = batch.get("weights")
    return (huber if w is None else w * huber).mean(), td


def dqn_update(optimizer, double_dqn: bool, params, target_params,
               opt_state, batches: dict, gamma: float):
    """K SGD steps over stacked [K, B, ...] minibatches; returns the last
    loss and the per-sample |TD| [K, B] for prioritized replay. Params and
    opt_state are updated in place."""
    tds = []
    for k in range(batches["obs"].shape[0]):
        batch = {key: v[k] for key, v in batches.items()}
        loss, td = dqn_loss(params, target_params, batch, gamma, double_dqn)
        params, opt_state = sgd_step(optimizer, params, opt_state, loss)
        tds.append(td.abs())
    return params, opt_state, loss.detach(), torch.stack(tds)


@dataclass
class DQNConfig:
    env: str = "CartPole-v1"
    num_env_runners: int = 0
    num_envs_per_runner: int = 8
    rollout_len: int = 16
    lr: float = 2.5e-3
    gamma: float = 0.99
    buffer_size: int = 50_000
    batch_size: int = 128
    learning_starts: int = 500        # env steps before SGD begins
    train_batches_per_step: int = 32  # SGD minibatches per step()
    target_update_freq: int = 2       # in step() iterations
    double_dqn: bool = True
    prioritized_replay: bool = False
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 2_000  # env steps to anneal over
    hidden: int = 64
    seed: int = 0
    device: str = "cuda"

    def build(self) -> "DQN":
        return DQN({"dqn_config": self})


class DQN(Trainable):
    """EnvRunner sampling with epsilon-greedy exploration + replay + TD
    updates on the device (reference: dqn.py training_step shape)."""

    def setup(self, config: dict) -> None:
        cfg = config.get("dqn_config") or DQNConfig(
            **{k: v for k, v in config.items()
               if k in DQNConfig.__dataclass_fields__})
        self.cfg = cfg
        self.device = dev = resolve_device(cfg.device)
        probe = make_env(cfg.env, seed=cfg.seed)
        obs_size, num_actions = probe.observation_size, probe.num_actions
        self.num_actions = num_actions
        self.params = init_mlp(torch.Generator().manual_seed(cfg.seed),
                               [obs_size, cfg.hidden, cfg.hidden,
                                num_actions], scale_last=1.0, device=dev)
        self.target_params = clone_params(self.params)
        self.optimizer = adam(cfg.lr)
        self.opt_state = self.optimizer.init(self.params)
        buf_cls = (PrioritizedReplayBuffer if cfg.prioritized_replay
                   else ReplayBuffer)
        self.buffer = buf_cls(cfg.buffer_size, obs_size, seed=cfg.seed)
        self.env_steps = 0

        def act(p, obs, seed):
            # p is (q_params, epsilon): the annealed epsilon rides along
            # with each weight push.
            q_params, eps = p
            q = _greedy_q(q_params, torch.as_tensor(obs, device=dev))
            greedy = q.argmax(-1).cpu().numpy()
            rng = np.random.default_rng(seed)
            explore = rng.random(len(greedy)) < eps
            rand = rng.integers(0, num_actions, len(greedy))
            a = np.where(explore, rand, greedy)
            zeros = np.zeros(len(greedy), np.float32)
            return a.astype(np.int32), zeros, zeros

        self.runners = EnvRunnerGroup(
            cfg.env, num_runners=cfg.num_env_runners,
            num_envs_per_runner=cfg.num_envs_per_runner,
            rollout_len=cfg.rollout_len, policy_factory=lambda: (act, None),
            seed=cfg.seed)
        self._return_window: list[float] = []

    def _epsilon(self) -> float:
        cfg = self.cfg
        frac = min(1.0, self.env_steps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_start + frac * (cfg.epsilon_end - cfg.epsilon_start)

    def step(self) -> dict:
        cfg = self.cfg
        samples = self.runners.sample((self.params, self._epsilon()))
        for s in samples:
            T, N = s["rewards"].shape
            # next_obs holds the TRUE pre-reset successors; dones are true
            # terminations only (TD targets bootstrap through truncation).
            self.buffer.add_batch(
                s["obs"].reshape(T * N, -1), s["actions"].reshape(-1),
                s["rewards"].reshape(-1),
                s["next_obs"].reshape(T * N, -1),
                s["terminals"].reshape(-1).astype(np.float32))
            self.env_steps += T * N
            self._return_window.extend(s["episode_returns"])

        loss = 0.0
        if self.env_steps >= cfg.learning_starts:
            raw = [self.buffer.sample(cfg.batch_size)
                   for _ in range(cfg.train_batches_per_step)]
            idxs = [b.pop("idx", None) for b in raw]
            batches = {k: torch.as_tensor(np.stack([b[k] for b in raw]),
                                          device=self.device)
                       for k in raw[0]}
            self.params, self.opt_state, loss_t, tds = dqn_update(
                self.optimizer, cfg.double_dqn, self.params,
                self.target_params, self.opt_state, batches, cfg.gamma)
            loss = float(loss_t)
            if idxs[0] is not None:
                for idx, td in zip(idxs, tds.cpu().numpy()):
                    self.buffer.update_priorities(idx, td)
            if self.iteration % cfg.target_update_freq == 0:
                self.target_params = clone_params(self.params)

        self._return_window = self._return_window[-100:]
        mean_ret = (float(np.mean(self._return_window))
                    if self._return_window else 0.0)
        return {
            "episode_return_mean": mean_ret,
            "num_env_steps_sampled": self.env_steps,
            "epsilon": self._epsilon(),
            "td_loss": loss,
            "buffer_size": len(self.buffer),
        }

    def save_checkpoint(self) -> Any:
        return {"params": params_to_numpy(self.params),
                "target": params_to_numpy(self.target_params),
                "env_steps": self.env_steps, "iteration": self.iteration}

    def load_checkpoint(self, checkpoint: Any) -> None:
        self.params = params_from_jax(checkpoint["params"], self.device)
        self.target_params = clone_params(
            params_from_jax(checkpoint["target"], self.device))
        self.env_steps = checkpoint["env_steps"]
        self.iteration = checkpoint["iteration"]

    def cleanup(self) -> None:
        self.runners.shutdown()
