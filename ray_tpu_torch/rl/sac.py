"""SAC: maximum-entropy off-policy RL for continuous control, in PyTorch.

Port of ray_tpu/rl/sac.py (reference: rllib/algorithms/sac/sac.py: a
tanh-squashed Gaussian actor, twin Q critics with polyak-averaged
targets, a learned entropy temperature; the Algorithm is a Tune
Trainable). Rollouts come from the inline EnvRunner on the host; the
update runs on ``cfg.device`` and takes its reparameterization noise as
an input (JAX draws it from threefry keys), so both packages can be fed
the same draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device, tree_leaves
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.env_runner import EnvRunnerGroup
from ray_tpu_torch.rl.ppo import (
    clone_params,
    host_act_fn,
    init_mlp,
    mlp_apply,
    params_from_jax,
    params_to_numpy,
    sgd_step,
)
from ray_tpu_torch.rl.replay import ReplayBuffer
from ray_tpu_torch.train.optim import adam
from ray_tpu_torch.tune.trainable import Trainable

LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0


def _actor_dist(params, obs):
    mean, log_std = mlp_apply(params, obs).chunk(2, -1)
    return mean, log_std.clamp(LOG_STD_MIN, LOG_STD_MAX)


def _sample_action(params, obs, eps, max_action: float):
    """Squashed-Gaussian action for standard-normal ``eps`` [B, A], and
    its log-prob (tanh change of variables)."""
    mean, log_std = _actor_dist(params, obs)
    pre = mean + torch.exp(log_std) * eps
    a = torch.tanh(pre)
    # log N(pre; mean, std) - sum log |d tanh/d pre| - log max_action
    logp = (-0.5 * (eps**2 + 2 * log_std + math.log(2 * math.pi))).sum(-1)
    logp = logp - (2 * (math.log(2.0) - pre - F.softplus(-2 * pre))).sum(-1)
    logp = logp - a.shape[-1] * math.log(max_action)
    return a * max_action, logp


def _q_apply(q_params, obs, act):
    return mlp_apply(q_params, torch.cat([obs, act], -1))[..., 0]


def sac_update(optimizers, gamma: float, target_entropy: float, params,
               target_q, opt_states, batches: dict, noise: torch.Tensor,
               max_action: float, tau: float):
    """K SGD steps over stacked [K, B, ...] minibatches: critics on the
    entropy-regularized TD target, the actor on min-Q + entropy, log-alpha
    toward the entropy target, polyak targets. ``noise`` [K, 2, B, A] is
    the standard-normal draws of each step: [k, 0] for the next action,
    [k, 1] for the actor's (JAX's split of each step's key). Params,
    targets and opt_states are updated in place; returns the last step's
    (q_loss, actor_loss, alpha)."""
    actor_opt, q_opt, alpha_opt = optimizers
    for k in range(batches["obs"].shape[0]):
        batch = {key: v[k] for key, v in batches.items()}
        alpha = torch.exp(params["log_alpha"]).detach()

        # --- critics ----------------------------------------------------
        with torch.no_grad():
            a_next, logp_next = _sample_action(
                params["actor"], batch["next_obs"], noise[k, 0], max_action)
            soft_v = torch.minimum(
                _q_apply(target_q[0], batch["next_obs"], a_next),
                _q_apply(target_q[1], batch["next_obs"], a_next)) \
                - alpha * logp_next
            target = batch["rewards"] + gamma * (1.0 - batch["dones"]) * soft_v
        q1 = _q_apply(params["q"][0], batch["obs"], batch["actions"])
        q2 = _q_apply(params["q"][1], batch["obs"], batch["actions"])
        q_loss = ((q1 - target) ** 2 + (q2 - target) ** 2).mean()
        sgd_step(q_opt, params["q"], opt_states["q"], q_loss)

        # --- actor ------------------------------------------------------
        a, logp = _sample_action(params["actor"], batch["obs"], noise[k, 1],
                                 max_action)
        q_min = torch.minimum(_q_apply(params["q"][0], batch["obs"], a),
                              _q_apply(params["q"][1], batch["obs"], a))
        a_loss = (alpha * logp - q_min).mean()
        sgd_step(actor_opt, params["actor"], opt_states["actor"], a_loss)

        # --- temperature ------------------------------------------------
        al_loss = -(params["log_alpha"]
                    * (logp.detach() + target_entropy)).mean()
        sgd_step(alpha_opt, params["log_alpha"], opt_states["alpha"],
                 al_loss)

        with torch.no_grad():
            for t, q in zip(tree_leaves(target_q), tree_leaves(params["q"])):
                t.copy_((1 - tau) * t + tau * q)
    return params, target_q, opt_states, q_loss.detach(), a_loss.detach(), \
        alpha


@dataclass
class SACConfig:
    env: str = "Pendulum-v1"
    num_env_runners: int = 0
    num_envs_per_runner: int = 8
    rollout_len: int = 16
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.01
    buffer_size: int = 100_000
    batch_size: int = 256
    learning_starts: int = 1_000
    train_batches_per_step: int = 16
    hidden: int = 128
    init_alpha: float = 0.2
    seed: int = 0
    device: str = "cuda"

    def build(self) -> "SAC":
        return SAC({"sac_config": self})


class SAC(Trainable):
    """EnvRunner sampling (stochastic squashed-Gaussian exploration) +
    replay + the twin-critic/actor/temperature update per step()
    (reference: sac.py training_step shape)."""

    def setup(self, config: dict) -> None:
        cfg = config.get("sac_config") or SACConfig(
            **{k: v for k, v in config.items()
               if k in SACConfig.__dataclass_fields__})
        self.cfg = cfg
        self.device = dev = resolve_device(cfg.device)
        probe = make_env(cfg.env, seed=cfg.seed)
        if not getattr(probe, "continuous", False):
            raise ValueError(f"SAC needs a continuous-action env, "
                             f"got {cfg.env!r}")
        obs_size = probe.observation_size
        act_size = probe.action_size
        # The env protocol's action bound: continuous envs declare
        # action_limit beside action_size.
        self.max_action = float(getattr(probe, "action_limit", 1.0))
        self.act_size = act_size
        gen = torch.Generator().manual_seed(cfg.seed)
        q_sizes = [obs_size + act_size, cfg.hidden, cfg.hidden, 1]
        self.params = {
            "actor": init_mlp(gen, [obs_size, cfg.hidden, cfg.hidden,
                                    2 * act_size], device=dev),
            "q": (init_mlp(gen, q_sizes, scale_last=1.0, device=dev),
                  init_mlp(gen, q_sizes, scale_last=1.0, device=dev)),
            "log_alpha": torch.tensor(np.log(cfg.init_alpha),
                                      dtype=torch.float32,
                                      device=dev).requires_grad_(True),
        }
        self.target_q = clone_params(self.params["q"])
        self.optimizers = (adam(cfg.actor_lr), adam(cfg.critic_lr),
                           adam(cfg.alpha_lr))
        self.opt_states = {
            "actor": self.optimizers[0].init(self.params["actor"]),
            "q": self.optimizers[1].init(self.params["q"]),
            "alpha": self.optimizers[2].init(self.params["log_alpha"]),
        }
        self.buffer = ReplayBuffer(cfg.buffer_size, obs_size, seed=cfg.seed,
                                   action_size=act_size)
        self.target_entropy = -float(act_size)
        self.env_steps = 0
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(cfg.seed)
        max_action = self.max_action

        @torch.no_grad()
        def act(actor_params, obs, gen):
            eps = torch.randn((obs.shape[0], act_size), generator=gen,
                              device=obs.device)
            a, logp = _sample_action(actor_params, obs, eps, max_action)
            return a, logp, torch.zeros_like(logp)

        act_fn = host_act_fn(dev, act)
        self.runners = EnvRunnerGroup(
            cfg.env, num_runners=cfg.num_env_runners,
            num_envs_per_runner=cfg.num_envs_per_runner,
            rollout_len=cfg.rollout_len,
            policy_factory=lambda: (act_fn, None), seed=cfg.seed)
        self._return_window: list[float] = []

    def step(self) -> dict:
        cfg = self.cfg
        samples = self.runners.sample(self.params["actor"])
        for s in samples:
            T, N = s["rewards"].shape
            # Bootstrap through time-limit truncation: only TRUE
            # terminations zero the future value (Pendulum never
            # terminates).
            self.buffer.add_batch(
                s["obs"].reshape(T * N, -1),
                s["actions"].reshape(T * N, -1),
                s["rewards"].reshape(-1),
                s["next_obs"].reshape(T * N, -1),
                s["terminals"].reshape(-1).astype(np.float32))
            self.env_steps += T * N
            self._return_window.extend(s["episode_returns"])

        q_loss = a_loss = alpha = 0.0
        if self.env_steps >= cfg.learning_starts:
            raw = [self.buffer.sample(cfg.batch_size)
                   for _ in range(cfg.train_batches_per_step)]
            batches = {k: torch.as_tensor(np.stack([b[k] for b in raw]),
                                          device=self.device)
                       for k in raw[0]}
            noise = torch.randn(
                (cfg.train_batches_per_step, 2, cfg.batch_size,
                 self.act_size), generator=self._gen, device=self.device)
            (self.params, self.target_q, self.opt_states, q_l, a_l,
             al) = sac_update(
                self.optimizers, cfg.gamma, self.target_entropy,
                self.params, self.target_q, self.opt_states, batches, noise,
                self.max_action, cfg.tau)
            q_loss, a_loss, alpha = float(q_l), float(a_l), float(al)

        self._return_window = self._return_window[-100:]
        mean_ret = (float(np.mean(self._return_window))
                    if self._return_window else 0.0)
        return {
            "episode_return_mean": mean_ret,
            "num_env_steps_sampled": self.env_steps,
            "q_loss": q_loss, "actor_loss": a_loss, "alpha": alpha,
            "buffer_size": len(self.buffer),
        }

    def save_checkpoint(self) -> Any:
        return {"params": params_to_numpy(self.params),
                "target_q": params_to_numpy(self.target_q),
                "env_steps": self.env_steps, "iteration": self.iteration}

    def load_checkpoint(self, checkpoint: Any) -> None:
        self.params = params_from_jax(checkpoint["params"], self.device)
        self.target_q = clone_params(
            params_from_jax(checkpoint["target_q"], self.device))
        self.env_steps = checkpoint["env_steps"]
        self.iteration = checkpoint["iteration"]

    def cleanup(self) -> None:
        self.runners.shutdown()
