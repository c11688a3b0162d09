"""APPO: IMPALA's actor-learner protocol with PPO's clipped surrogate on
V-trace advantages, in PyTorch.

Port of ray_tpu/rl/appo.py (reference: rllib/algorithms/appo/appo.py:
APPO subclasses IMPALA and swaps the loss for the clipped surrogate over
V-trace advantages, so the learner tolerates behaviour-policy lag and
bounds each update's policy step). Everything but the update is
rl/impala.py's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ray_tpu_torch.rl.impala import IMPALA, ImpalaConfig, _vtrace_terms
from ray_tpu_torch.rl.ppo import sgd_step


def appo_update(optimizer, cfg_static, params, opt_state, batch: dict):
    """One clipped-surrogate update over a [T, N] rollout batch with
    V-trace advantages, normalized with the population std (``jnp.std``).
    cfg_static: (gamma, rho_clip, c_clip, vf_coef, ent_coef, clip_eps)."""
    gamma, rho_clip, c_clip, vf_coef, ent_coef, clip_eps = cfg_static
    logp, values, ent, vs, pg_adv = _vtrace_terms(params, batch, gamma,
                                                  rho_clip, c_clip)
    adv = (pg_adv - pg_adv.mean()) / (pg_adv.std(correction=0) + 1e-8)
    ratio = torch.exp(logp - batch["logp"])
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
    pg = -torch.minimum(ratio * adv, clipped * adv).mean()
    vf = 0.5 * ((values - vs) ** 2).mean()
    loss = pg + vf_coef * vf - ent_coef * ent
    params, opt_state = sgd_step(optimizer, params, opt_state, loss)
    return params, opt_state, {"policy_loss": pg.detach(),
                               "vf_loss": vf.detach(),
                               "entropy": ent.detach()}


@dataclass
class APPOConfig(ImpalaConfig):
    clip_eps: float = 0.3

    def build(self) -> "APPO":
        return APPO({"appo_config": self})


class APPO(IMPALA):
    """Async PPO (reference: appo.py) on the IMPALA machinery."""

    def setup(self, config: dict) -> None:
        cfg = config.get("appo_config")
        if cfg is None:
            cfg = APPOConfig(**{k: v for k, v in config.items()
                                if k in APPOConfig.__dataclass_fields__})
        super().setup({"impala_config": cfg})

    def _update(self, batch: dict) -> dict:
        static = (self.cfg.gamma, self.cfg.rho_clip, self.cfg.c_clip,
                  self.cfg.vf_coef, self.cfg.ent_coef, self.cfg.clip_eps)
        self.params, self.opt_state, stats = appo_update(
            self.optimizer, static, self.params, self.opt_state, batch)
        return stats
