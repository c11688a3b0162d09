"""MARWIL: monotonic advantage re-weighted imitation learning.

Port of ray_tpu/rl/marwil.py (reference: rllib/algorithms/marwil/
marwil.py: behavior cloning weighted by exponentiated advantages; a
critic regresses the observed returns and the policy's log-likelihood is
scaled by exp(beta * advantage), so better-than-average dataset actions
are imitated harder; beta=0 is plain BC). The dataset holds "obs",
"actions" and "returns" columns, read as BC and CQL read theirs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.bc import device_batch, greedy_return
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.ppo import (
    _logp_of,
    init_mlp,
    mlp_apply,
    params_from_jax,
    params_to_numpy,
    sgd_step,
    state_from_numpy,
)
from ray_tpu_torch.train.optim import adam
from ray_tpu_torch.tune.trainable import Trainable


def marwil_loss(params, beta: float, ma_adv_norm, obs, actions, returns):
    """Weighted policy NLL + 0.5 x the critic's squared error; the
    weights exp(beta * adv / max(sqrt(ma_adv_norm), 1e-3)), clipped to
    [0, 20], hold the advantage fixed (marwil_torch_policy's loss).
    Returns (loss, critic_loss, the detached advantages)."""
    v = mlp_apply(params["vf"], obs)[..., 0]
    adv = returns - v
    critic_loss = (adv ** 2).mean()
    lp_a = _logp_of(F.log_softmax(mlp_apply(params["pi"], obs), -1), actions)
    if beta == 0.0:
        w = torch.ones_like(lp_a)  # plain behavior cloning
    else:
        w = torch.exp(beta * adv.detach()
                      / torch.sqrt(ma_adv_norm).clamp(min=1e-3))
        w = w.clamp(0.0, 20.0)  # bound exploding weights
    policy_loss = -(w * lp_a).mean()
    return policy_loss + 0.5 * critic_loss, critic_loss, adv.detach()


def marwil_update(optimizer, beta: float, params, opt_state, ma_adv_norm,
                  obs, actions, returns):
    """One step; then the EMA of squared advantages (this step's) that
    normalizes the exponent (reference: moving_average_sqd_adv_norm).
    Params and opt_state in place; returns the new EMA and the losses."""
    loss, critic_loss, adv = marwil_loss(params, beta, ma_adv_norm, obs,
                                         actions, returns)
    params, opt_state = sgd_step(optimizer, params, opt_state, loss)
    ma_adv_norm = 0.99 * ma_adv_norm + 0.01 * (adv ** 2).mean()
    return params, opt_state, ma_adv_norm, loss.detach(), \
        critic_loss.detach()


@dataclass
class MARWILConfig:
    env: str = "CartPole-v1"            # spaces + evaluation
    dataset: Any = None                 # "obs", "actions", "returns"
    beta: float = 1.0                   # 0 => plain BC
    lr: float = 1e-3
    batch_size: int = 256
    epochs_per_step: int = 1
    hidden: int = 64
    evaluation_episodes: int = 0
    seed: int = 0
    device: str = "cuda"

    def build(self) -> "MARWIL":
        return MARWIL({"marwil_config": self})


class MARWIL(Trainable):
    """Like ray_tpu's, ``step()`` advances ``iteration`` itself."""

    def setup(self, config: dict) -> None:
        cfg = config.get("marwil_config") or MARWILConfig(
            **{k: v for k, v in config.items()
               if k in MARWILConfig.__dataclass_fields__})
        if cfg.dataset is None:
            raise ValueError("MARWIL requires an offline dataset with "
                             "'obs', 'actions' and 'returns' columns")
        self.cfg = cfg
        self.device = dev = resolve_device(cfg.device)
        probe = make_env(cfg.env, seed=cfg.seed)
        gen = torch.Generator().manual_seed(cfg.seed)
        self.params = {
            "pi": init_mlp(gen, [probe.observation_size, cfg.hidden,
                                 cfg.hidden, probe.num_actions], device=dev),
            "vf": init_mlp(gen, [probe.observation_size, cfg.hidden,
                                 cfg.hidden, 1], scale_last=1.0, device=dev),
        }
        self.optimizer = adam(cfg.lr)
        self.opt_state = self.optimizer.init(self.params)
        self.ma_adv_norm = torch.ones((), device=dev)
        self._eval_env = make_env(cfg.env, seed=cfg.seed + 1)

    def step(self) -> dict:
        cfg = self.cfg
        loss = critic_loss = torch.zeros((), device=self.device)
        n_batches = 0
        for _ in range(cfg.epochs_per_step):
            for batch in cfg.dataset.iter_batches(
                    batch_size=cfg.batch_size):
                b = device_batch({k: batch[k] for k in
                                  ("obs", "actions", "returns")},
                                 self.device)
                (self.params, self.opt_state, self.ma_adv_norm, loss,
                 critic_loss) = marwil_update(
                    self.optimizer, cfg.beta, self.params, self.opt_state,
                    self.ma_adv_norm, b["obs"], b["actions"], b["returns"])
                n_batches += 1
        loss, critic_loss = torch.stack([loss, critic_loss]).tolist()
        out = {"training_iteration": self.iteration + 1,
               "num_batches": n_batches,
               "policy_loss": loss,
               "critic_loss": critic_loss}
        if cfg.evaluation_episodes:
            out["episode_return_mean"] = greedy_return(
                self.params["pi"], self._eval_env, cfg.evaluation_episodes,
                self.device)
        self.iteration += 1
        return out

    def save_checkpoint(self) -> Any:
        return {"params": params_to_numpy(self.params),
                "opt_state": params_to_numpy(self.opt_state),
                "ma_adv_norm": params_to_numpy(self.ma_adv_norm),
                "iteration": self.iteration}

    def load_checkpoint(self, ckpt) -> None:
        self.params = params_from_jax(ckpt["params"], self.device)
        self.opt_state = state_from_numpy(ckpt["opt_state"], self.device)
        self.ma_adv_norm = state_from_numpy(ckpt["ma_adv_norm"], self.device)
        self.iteration = ckpt["iteration"]
