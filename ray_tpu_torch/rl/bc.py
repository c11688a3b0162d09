"""Behavior cloning: offline RL from a dataset of (obs, action) pairs.

Port of ray_tpu/rl/bc.py (reference: rllib/algorithms/bc/bc.py: the
policy head trained by action log-likelihood over an offline dataset).
The dataset is any object with ray_tpu.data's ``iter_batches`` signature
(``ray_tpu_torch.data.from_blocks``, or a ray_tpu.data Dataset) holding
"obs" and "actions" columns; the update is a cross-entropy step on the
same MLP policy PPO uses, on ``cfg.device``, so a BC-pretrained policy
drops into PPO fine-tuning.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.ppo import (
    _logp_of,
    init_mlp,
    mlp_apply,
    params_from_jax,
    params_to_numpy,
    sgd_step,
)
from ray_tpu_torch.train.optim import adam
from ray_tpu_torch.tune.trainable import Trainable


def bc_loss(params, obs, actions):
    """Mean NLL of the data actions, and the greedy action accuracy."""
    logits = mlp_apply(params, obs)
    nll = -_logp_of(F.log_softmax(logits, -1), actions)
    acc = (logits.argmax(-1) == actions).float().mean()
    return nll.mean(), acc


def bc_update(optimizer, params, opt_state, obs, actions):
    """One optimizer step on one batch; params and opt_state in place."""
    loss, acc = bc_loss(params, obs, actions)
    params, opt_state = sgd_step(optimizer, params, opt_state, loss)
    return params, opt_state, loss.detach(), acc


def device_batch(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``: f32, int64 for actions."""
    return {k: torch.as_tensor(np.asarray(
        v, np.int64 if k == "actions" else np.float32), device=device)
        for k, v in batch.items()}


@torch.no_grad()
def greedy_return(q_or_pi, env, episodes: int, device,
                  max_steps: int | None = None) -> float:
    """Mean return of ``episodes`` greedy rollouts of the MLP ``q_or_pi``
    (argmax of its outputs) in the numpy ``env``."""
    returns = []
    for _ in range(episodes):
        obs = env.reset()
        total, done, steps = 0.0, False, 0
        while not done and (max_steps is None or steps < max_steps):
            x = torch.as_tensor(np.asarray(obs, np.float32)[None],
                                device=device)
            a = int(mlp_apply(q_or_pi, x).argmax(-1)[0])
            obs, r, term, trunc = env.step(a)
            done = term or trunc
            total += r
            steps += 1
        returns.append(total)
    return float(np.mean(returns))


@dataclass
class BCConfig:
    env: str = "CartPole-v1"           # for obs/action spaces + evaluation
    dataset: Any = None                # "obs", "actions" columns
    lr: float = 1e-3
    batch_size: int = 256
    epochs_per_step: int = 1
    hidden: int = 64
    evaluation_episodes: int = 0       # >0: greedy rollouts each step()
    seed: int = 0
    device: str = "cuda"

    def build(self) -> "BC":
        return BC({"bc_config": self})


class BC(Trainable):
    """Supervised policy training over an offline dataset (reference:
    bc.py training_step: offline batch -> log-likelihood update)."""

    def setup(self, config: dict) -> None:
        cfg = config.get("bc_config") or BCConfig(
            **{k: v for k, v in config.items()
               if k in BCConfig.__dataclass_fields__})
        if cfg.dataset is None:
            raise ValueError("BCConfig.dataset is required (offline data)")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        probe = make_env(cfg.env, seed=cfg.seed)
        self.params = init_mlp(
            torch.Generator().manual_seed(cfg.seed),
            [probe.observation_size, cfg.hidden, cfg.hidden,
             probe.num_actions], device=self.device)
        self.optimizer = adam(cfg.lr)
        self.opt_state = self.optimizer.init(self.params)

    def step(self) -> dict:
        cfg = self.cfg
        loss_sum = acc_sum = torch.zeros((), device=self.device)
        seen = 0
        for _ in range(cfg.epochs_per_step):
            for batch in cfg.dataset.iter_batches(
                    batch_size=cfg.batch_size,
                    local_shuffle_buffer_size=4 * cfg.batch_size,
                    local_shuffle_seed=cfg.seed + self.iteration):
                b = device_batch({"obs": batch["obs"],
                                  "actions": batch["actions"]}, self.device)
                self.params, self.opt_state, loss, acc = bc_update(
                    self.optimizer, self.params, self.opt_state, b["obs"],
                    b["actions"])
                n = len(b["actions"])
                loss_sum = loss_sum + loss * n
                acc_sum = acc_sum + acc * n
                seen += n
        loss_sum, acc_sum = torch.stack([loss_sum, acc_sum]).tolist()
        denom = max(seen, 1)
        out = {"bc_loss": loss_sum / denom,
               "action_accuracy": acc_sum / denom,
               "num_samples_trained": seen}
        if cfg.evaluation_episodes > 0:
            out["episode_return_mean"] = greedy_return(
                self.params, make_env(cfg.env, seed=cfg.seed + 10_000),
                cfg.evaluation_episodes, self.device, max_steps=1000)
        return out

    def save_checkpoint(self) -> Any:
        return {"params": params_to_numpy(self.params),
                "iteration": self.iteration}

    def load_checkpoint(self, checkpoint: Any) -> None:
        self.params = params_from_jax(checkpoint["params"], self.device)
        self.iteration = checkpoint["iteration"]
