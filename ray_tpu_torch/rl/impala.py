"""IMPALA: actor-learner RL with V-trace off-policy correction, in PyTorch.

Port of ray_tpu/rl/impala.py (reference: rllib/algorithms/impala/
impala.py; V-trace, Espeholt et al. 2018): the learner update is one
V-trace backward loop plus the policy and value losses, on
``cfg.device``. The asynchronous runner actors (``num_env_runners > 0``)
need the actor runtime, which the port does not have yet; the inline
loop (``num_env_runners=0``) samples, then updates, each step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.env_runner import RUNTIME_MISSING, EnvRunner
from ray_tpu_torch.rl.ppo import (
    _act,
    _logp_of,
    host_act_fn,
    init_policy,
    mlp_apply,
    params_from_jax,
    params_to_numpy,
    sgd_step,
)
from ray_tpu_torch.train.optim import adam
from ray_tpu_torch.tune.trainable import Trainable


@torch.no_grad()
def vtrace(behavior_logp, target_logp, rewards, values, dones, last_value,
           gamma: float, rho_clip: float = 1.0, c_clip: float = 1.0):
    """V-trace targets (Espeholt et al. 2018, eq. 1) over [T, N] tensors.

    Returns (vs, pg_advantages), detached: vs are the corrected value
    targets; the policy gradient uses rho_t * (r_t + gamma * vs_{t+1} -
    V(x_t)). A reverse loop over T.
    """
    not_done = 1.0 - dones.float()
    ratio = torch.exp(target_logp - behavior_logp)
    rho = torch.clamp(ratio, max=rho_clip)
    c = torch.clamp(ratio, max=c_clip)
    next_values = torch.cat([values[1:], last_value[None]], 0)
    deltas = rho * (rewards + gamma * next_values * not_done - values)
    decay = gamma * not_done * c
    T = rewards.shape[0]
    acc = torch.zeros_like(last_value)
    corr = [None] * T
    for t in range(T - 1, -1, -1):
        # acc = vs_{t+1} - V(x_{t+1}), the correction term
        acc = torch.addcmul(deltas[t], decay[t], acc)
        corr[t] = acc
    vs = values + torch.stack(corr)
    next_vs = torch.cat([vs[1:], last_value[None]], 0)
    pg_adv = rho * (rewards + gamma * next_vs * not_done - values)
    return vs, pg_adv


def _vtrace_terms(params, batch: dict, gamma, rho_clip, c_clip):
    """The policy's log-probs at [T, N], values and entropy, and V-trace
    (vs, pg_adv) of the batch under the current params."""
    logits = mlp_apply(params["pi"], batch["obs"])           # [T, N, A]
    values = mlp_apply(params["vf"], batch["obs"])[..., 0]   # [T, N]
    last_value = mlp_apply(params["vf"], batch["last_obs"])[..., 0]
    logp_all = F.log_softmax(logits, -1)
    logp = _logp_of(logp_all, batch["actions"])
    vs, pg_adv = vtrace(batch["logp"], logp.detach(), batch["rewards"],
                        values.detach(), batch["dones"], last_value.detach(),
                        gamma, rho_clip, c_clip)
    ent = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    return logp, values, ent, vs, pg_adv


def impala_update(optimizer, cfg_static, params, opt_state, batch: dict):
    """One V-trace actor-critic update over a [T, N] rollout batch.
    cfg_static: (gamma, rho_clip, c_clip, vf_coef, ent_coef)."""
    gamma, rho_clip, c_clip, vf_coef, ent_coef = cfg_static
    logp, values, ent, vs, pg_adv = _vtrace_terms(params, batch, gamma,
                                                  rho_clip, c_clip)
    pg = -(pg_adv * logp).mean()
    vf = 0.5 * ((values - vs) ** 2).mean()
    loss = pg + vf_coef * vf - ent_coef * ent
    params, opt_state = sgd_step(optimizer, params, opt_state, loss)
    return params, opt_state, {"policy_loss": pg.detach(),
                               "vf_loss": vf.detach(),
                               "entropy": ent.detach()}


@dataclass
class ImpalaConfig:
    env: str = "CartPole-v1"
    num_env_runners: int = 0          # 0 = inline (the only one ported)
    num_envs_per_runner: int = 8
    rollout_len: int = 64
    lr: float = 5e-4
    gamma: float = 0.99
    rho_clip: float = 1.0
    c_clip: float = 1.0
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    hidden: int = 64
    seed: int = 0
    device: str = "cuda"

    def build(self) -> "IMPALA":
        return IMPALA({"impala_config": self})


class IMPALA(Trainable):
    """Actor-learner (reference: impala.py), inline: each step samples
    one rollout with the current weights and applies the V-trace update
    (``weight_version`` counts updates)."""

    def setup(self, config: dict) -> None:
        cfg = config.get("impala_config") or ImpalaConfig(
            **{k: v for k, v in config.items()
               if k in ImpalaConfig.__dataclass_fields__})
        if cfg.num_env_runners > 0:
            raise NotImplementedError(
                f"{type(self).__name__} with num_env_runners="
                f"{cfg.num_env_runners} (asynchronous runner actors) "
                + RUNTIME_MISSING + "; use num_env_runners=0")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        probe = make_env(cfg.env, seed=cfg.seed)
        self.params = init_policy(torch.Generator().manual_seed(cfg.seed),
                                  probe.observation_size, probe.num_actions,
                                  cfg.hidden, device=self.device)
        self.optimizer = adam(cfg.lr)
        self.opt_state = self.optimizer.init(self.params)
        self.weight_version = 0
        self._return_window: list[float] = []
        act_fn = host_act_fn(self.device, _act)
        self._local = EnvRunner(cfg.env, cfg.num_envs_per_runner,
                                cfg.rollout_len, lambda: (act_fn, None),
                                seed=cfg.seed)

    def _batch_from(self, sample: dict) -> dict:
        """Device tensors for the update, shared by every actor-learner
        algorithm on this runner protocol (APPO)."""
        return {k: torch.as_tensor(sample[k], device=self.device)
                for k in ("obs", "actions", "logp", "rewards", "dones",
                          "last_obs")}

    def _update(self, batch: dict) -> dict:
        static = (self.cfg.gamma, self.cfg.rho_clip, self.cfg.c_clip,
                  self.cfg.vf_coef, self.cfg.ent_coef)
        self.params, self.opt_state, stats = impala_update(
            self.optimizer, static, self.params, self.opt_state, batch)
        return stats

    def step(self) -> dict:
        self._local.set_weights(self.params)
        sample = self._local.sample()
        stats = self._update(self._batch_from(sample))
        self.weight_version += 1
        self._return_window.extend(sample["episode_returns"])
        self._return_window = self._return_window[-100:]
        mean_ret = (float(np.mean(self._return_window))
                    if self._return_window else 0.0)
        return {
            "episode_return_mean": mean_ret,
            "num_env_steps_sampled": int(sample["obs"].shape[0]
                                         * sample["obs"].shape[1]),
            "weight_version": self.weight_version,
            **{k: float(v) for k, v in stats.items()},
        }

    def save_checkpoint(self) -> Any:
        return {"params": params_to_numpy(self.params),
                "iteration": self.iteration,
                "weight_version": self.weight_version}

    def load_checkpoint(self, checkpoint: Any) -> None:
        self.params = params_from_jax(checkpoint["params"], self.device)
        self.iteration = checkpoint["iteration"]
        self.weight_version = checkpoint.get("weight_version", 0)
