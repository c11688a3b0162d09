"""Dreamer: model-based RL, a world model and an actor-critic trained in it.

Port of ray_tpu/rl/dreamer.py (reference: rllib/algorithms/dreamerv3/:
an RSSM world model trained on replayed sequences, the actor and critic
trained on imagined latent rollouts, a Tune Trainable):

- RSSM-lite: a deterministic GRU core h, a Gaussian latent z with prior
  p(z|h) and posterior q(z|h, enc(o)); decoder, reward and continue heads
  on [h, z]; KL(q||p) balanced with free bits; ``is_first`` resets the
  filter inside the [B, T] window.
- Imagination: from the detached posterior states the actor rolls the
  frozen model H steps through the prior (straight-through one-hot
  actions); the critic regresses lambda-returns over the imagined
  rewards and continues, the actor maximizes them plus an entropy bonus.

Param trees keep JAX's layout (MLPs as PPO's; the GRU's one
``[in, 3*det]`` matrix split into the r, u, c gates in that order, r
applied to the candidate's recurrent part only: not ``torch.nn.GRUCell``'s
layout or arithmetic). Randomness is an input: the update takes the
posterior noise ``eps`` [T, B, latent] and the imagined actions' Gumbel
noise ``gumbel`` [H, B*T, A]; ``act_step`` takes ``eps`` [N, latent] and
``gumbel`` [N, A]. The Trainable draws them from its generator. The two
scans are Python loops over T and H; the heads that feed nothing back
into a scan run once over the stacked steps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device, tree_map
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.ppo import (
    _leaf,
    gumbel,
    init_mlp,
    mlp_apply,
    params_from_jax,
    params_to_numpy,
    sgd_step,
    state_from_numpy,
)
from ray_tpu_torch.train.optim import adam, chain, clip_by_global_norm
from ray_tpu_torch.tune.trainable import Trainable

# ---------------------------------------------------------------- model ----


def _init_gru(generator: torch.Generator, in_size: int, det: int,
              device="cpu") -> dict:
    s = math.sqrt(1.0 / max(in_size, 1))
    wx = torch.randn((in_size, 3 * det), generator=generator) * s
    wh = torch.randn((det, 3 * det), generator=generator) * math.sqrt(
        1.0 / det)
    return {"wx": _leaf(wx, device), "wh": _leaf(wh, device),
            "b": _leaf(torch.zeros(3 * det), device)}


def _gru(p, h, x):
    xr, xu, xc = (x @ p["wx"] + p["b"]).chunk(3, -1)
    hr, hu, hc = (h @ p["wh"]).chunk(3, -1)
    r = torch.sigmoid(xr + hr)
    u = torch.sigmoid(xu + hu)
    cand = torch.tanh(xc + r * hc)
    return u * h + (1 - u) * cand


def _dist(params, x):
    mean, log_std = mlp_apply(params, x).chunk(2, -1)
    return mean, log_std.clamp(-5.0, 2.0)


def _kl(mq, lq, mp, lp):
    """KL(N(mq, lq) || N(mp, lp)) per dimension, summed."""
    vq, vp = torch.exp(2 * lq), torch.exp(2 * lp)
    return 0.5 * ((vq + (mq - mp) ** 2) / vp - 1.0
                  + 2 * (lp - lq)).sum(-1)


def init_world_model(generator: torch.Generator, obs: int, acts: int,
                     det: int, latent: int, hidden: int,
                     device="cpu") -> dict:
    feat = det + latent
    g, d = generator, device
    return {
        "enc": init_mlp(g, [obs, hidden, hidden], scale_last=0.3, device=d),
        "gru": _init_gru(g, latent + acts, det, device=d),
        "prior": init_mlp(g, [det, hidden, 2 * latent], scale_last=0.1,
                          device=d),
        "post": init_mlp(g, [det + hidden, hidden, 2 * latent],
                         scale_last=0.1, device=d),
        "dec": init_mlp(g, [feat, hidden, obs], scale_last=0.3, device=d),
        "rew": init_mlp(g, [feat, hidden, 1], scale_last=0.3, device=d),
        "cont": init_mlp(g, [feat, hidden, 1], scale_last=0.3, device=d),
        "actor": init_mlp(g, [feat, hidden, acts], device=d),
        "critic": init_mlp(g, [feat, hidden, 1], scale_last=0.3, device=d),
    }


def _filter_step(p, h, z, action_1h, embed, is_first, eps):
    """``_obs_step`` on the observation's embedding ``enc(obs)``."""
    mask = (1.0 - is_first)[..., None]
    h, z = h * mask, z * mask
    h = _gru(p["gru"], h, torch.cat([z, action_1h * mask], -1))
    mq, lq = _dist(p["post"], torch.cat([h, embed], -1))
    return h, mq + torch.exp(lq) * eps, (mq, lq)


def _obs_step(p, h, z, action_1h, obs, is_first, eps):
    """One posterior step: resets at is_first, GRU advance, posterior z
    from the standard-normal ``eps``."""
    return _filter_step(p, h, z, action_1h, mlp_apply(p["enc"], obs),
                        is_first, eps)


def _img_step(p, h, z, action_1h, eps=None, mean_latent: bool = True):
    """One prior (imagination) step. mean_latent=True rolls the MODE of
    the prior (on near-deterministic control, sampled latent noise swamps
    the action's effect on the trajectory)."""
    h = _gru(p["gru"], h, torch.cat([z, action_1h], -1))
    mp, lp = _dist(p["prior"], h)
    return h, (mp if mean_latent else mp + torch.exp(lp) * eps)


# ---------------------------------------------------------------- loss -----


def dreamer_loss(cfg_static, num_actions: int, params, batch: dict,
                 rew_bounds, noise: dict):
    """The world-model losses over the [B, T] sequences, then the critic
    and actor losses on imagined rollouts from the posterior states.
    Returns (total, metrics as detached 0-d tensors)."""
    horizon, gamma, lam, free_bits, ent_coef = cfg_static
    obs = batch["obs"]                                         # [B, T, O]
    B, T = obs.shape[:2]
    acts = F.one_hot(batch["actions"].long(), num_actions).to(obs.dtype)
    det = params["gru"]["wh"].shape[0]
    latent = params["prior"][-1]["b"].shape[0] // 2

    a_prev = torch.cat([torch.zeros_like(acts[:, :1]), acts[:, :-1]], 1)
    embed = mlp_apply(params["enc"], obs)
    h, z = obs.new_zeros(B, det), obs.new_zeros(B, latent)
    hs, zs, mqs, lqs = [], [], [], []
    for t in range(T):
        h, z, (mq, lq) = _filter_step(params, h, z, a_prev[:, t],
                                      embed[:, t], batch["is_first"][:, t],
                                      noise["eps"][t])
        hs.append(h)
        zs.append(z)
        mqs.append(mq)
        lqs.append(lq)
    hs = torch.stack(hs, 1)                                    # [B, T, det]
    feats = torch.cat([hs, torch.stack(zs, 1)], -1)            # [B, T, F]
    mq, lq = torch.stack(mqs, 1), torch.stack(lqs, 1)
    mp, lp = _dist(params["prior"], hs)

    obs_loss = ((mlp_apply(params["dec"], feats) - obs) ** 2).mean()
    rew_pred = mlp_apply(params["rew"], feats)[..., 0]
    rew_loss = ((rew_pred - batch["rewards"]) ** 2).mean()
    cont_logit = mlp_apply(params["cont"], feats)[..., 0]
    cont_loss = F.binary_cross_entropy_with_logits(
        cont_logit, 1.0 - batch["dones"])
    # KL balancing (DreamerV3): the prior moves toward the posterior
    # harder than the posterior toward the prior, with free bits.
    kl_pq = _kl(mq, lq, mp.detach(), lp.detach()).mean()
    kl_prior = _kl(mq.detach(), lq.detach(), mp, lp).mean()
    kl_loss = (0.1 * kl_pq.clamp(min=free_bits)
               + 0.5 * kl_prior.clamp(min=free_bits))
    wm_loss = obs_loss + rew_loss + cont_loss + kl_loss

    # ---- imagination: the world model is FROZEN (p_sg) for the behaviour
    # losses; gradients reach the actor through its straight-through
    # actions and the frozen dynamics.
    p_sg = tree_map(torch.Tensor.detach, params)
    start = feats.reshape(B * T, -1).detach()
    h, z = start[:, :det], start[:, det:]
    ifeats, ents, feats2 = [], [], []
    for k in range(horizon):
        feat = torch.cat([h, z], -1)
        logits = mlp_apply(params["actor"], feat)
        logp = F.log_softmax(logits, -1)
        probs = torch.exp(logp)
        a = (logits + noise["gumbel"][k]).argmax(-1)
        a1h = F.one_hot(a, num_actions).to(probs.dtype)
        a1h = a1h + probs - probs.detach()
        ents.append(-(probs * logp).sum(-1))
        h, z = _img_step(p_sg, h, z, a1h)
        ifeats.append(feat)
        feats2.append(torch.cat([h, z], -1))
    ifeat, ent = torch.stack(ifeats), torch.stack(ents)       # [H, N, ...]
    feat2 = torch.stack(feats2)
    # Imagined rewards clipped to the observed range, so the actor cannot
    # farm the reward head's extrapolation.
    rews = mlp_apply(p_sg["rew"], feat2)[..., 0].clamp(rew_bounds[0],
                                                       rew_bounds[1])
    conts = torch.sigmoid(mlp_apply(p_sg["cont"], feat2)[..., 0])
    vals = mlp_apply(p_sg["critic"], feat2)[..., 0]

    # lambda-returns, a reverse loop over H, differentiable through the
    # imagined actions: the actor's objective.
    disc = gamma * conts
    nxt = vals[-1]
    rets = [None] * horizon
    for t in range(horizon - 1, -1, -1):
        nxt = rews[t] + disc[t] * ((1 - lam) * vals[t] + lam * nxt)
        rets[t] = nxt
    rets = torch.stack(rets)                                   # [H, N]
    v_pred = mlp_apply(params["critic"], ifeat.detach())[..., 0]
    critic_loss = ((v_pred - rets.detach()) ** 2).mean()
    actor_loss = -(rets + ent_coef * ent).mean()

    total = wm_loss + critic_loss + actor_loss
    metrics = {"wm_loss": wm_loss, "obs_loss": obs_loss,
               "rew_loss": rew_loss, "kl": kl_pq,
               "critic_loss": critic_loss, "actor_loss": actor_loss,
               "imag_return": rets[0].mean()}
    return total, {k: v.detach() for k, v in metrics.items()}


def dreamer_update(optimizer, cfg_static, num_actions: int, params,
                   opt_state, batch: dict, rew_bounds, noise: dict):
    """One gradient step on ``dreamer_loss``; params and opt_state are
    updated in place and returned with the metrics."""
    total, metrics = dreamer_loss(cfg_static, num_actions, params, batch,
                                  rew_bounds, noise)
    params, opt_state = sgd_step(optimizer, params, opt_state, total)
    return params, opt_state, metrics


def update_noise(generator: torch.Generator, B: int, T: int, horizon: int,
                 latent: int, num_actions: int, device) -> dict:
    """The draws of one update: posterior ``eps`` and imagination's
    Gumbel noise."""
    return {"eps": torch.randn((T, B, latent), generator=generator,
                               device=device),
            "gumbel": gumbel((horizon, B * T, num_actions), generator,
                             device)}


@torch.no_grad()
def act_step(num_actions: int, params, h, z, a_prev, obs, is_first,
             noise: dict, greedy: bool = False):
    """Policy step in the real env: the training scan's ``_obs_step``
    (mask, GRU advance with the previous action, posterior) and then an
    actor sample (Gumbel-max with ``noise["gumbel"]``) or its argmax."""
    a1h = F.one_hot(a_prev.long(), num_actions).to(obs.dtype)
    h, z, _ = _obs_step(params, h, z, a1h, obs, is_first, noise["eps"])
    logits = mlp_apply(params["actor"], torch.cat([h, z], -1))
    a = (logits if greedy else logits + noise["gumbel"]).argmax(-1)
    return a, h, z


# ------------------------------------------------------------ trainable ----


@dataclass
class DreamerConfig:
    env: str = "CartPole-v1"
    num_envs: int = 8
    seq_len: int = 16
    batch_seqs: int = 16
    horizon: int = 10
    det: int = 64
    # Latent kept SMALL and free bits tight: on low-dim control the
    # stochastic latent is mostly noise the actor's signal has to fight
    # through (ray_tpu's defaults).
    latent: int = 8
    hidden: int = 64
    lr: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    free_bits: float = 0.3
    ent_coef: float = 1e-2
    buffer_size: int = 50_000
    env_steps_per_iter: int = 500
    train_steps_per_iter: int = 40
    learning_starts: int = 1000
    seed: int = 0
    device: str = "cuda"

    def build(self) -> "Dreamer":
        return Dreamer({"dreamer_config": self})


class Dreamer(Trainable):
    """World-model RL driven inline: the numpy envs and the replay ring
    on the host, the recurrent filter state ``(h, z)`` and every update on
    ``cfg.device`` (reference: dreamerv3.py training_step: sample, train
    the world model, imagine, train the actor and critic). Its draws come
    from ``_act_noise`` and ``_update_noise``. Like ray_tpu's, ``step()``
    advances ``iteration`` itself."""

    def setup(self, config: dict) -> None:
        cfg = config.get("dreamer_config") or DreamerConfig(
            **{k: v for k, v in config.items()
               if k in DreamerConfig.__dataclass_fields__})
        self.cfg = cfg
        self.device = dev = resolve_device(cfg.device)
        self.envs = [make_env(cfg.env, seed=cfg.seed + i)
                     for i in range(cfg.num_envs)]
        probe = self.envs[0]
        self.obs_size = probe.observation_size
        self.num_actions = probe.num_actions
        self.params = init_world_model(
            torch.Generator().manual_seed(cfg.seed), self.obs_size,
            self.num_actions, cfg.det, cfg.latent, cfg.hidden, device=dev)
        self.optimizer = chain(clip_by_global_norm(100.0), adam(cfg.lr))
        self.opt_state = self.optimizer.init(self.params)
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(cfg.seed)
        # Transition ring buffer (windows may cross episode boundaries;
        # is_first resets the filter inside the scan).
        n = cfg.buffer_size
        self._obs = np.zeros((n, self.obs_size), np.float32)
        self._act = np.zeros((n,), np.int32)
        self._rew = np.zeros((n,), np.float32)
        self._done = np.zeros((n,), np.float32)
        self._first = np.zeros((n,), np.float32)
        self._idx = 0
        self._full = False
        self._np_rng = np.random.default_rng(cfg.seed + 97)
        # Running observation normalization: an unnormalized MSE decoder
        # underweights the small-scale dimensions that decide termination
        # (pole angle +-0.2 against cart position +-2.4).
        self._obs_count = 1e-4
        self._obs_mean = np.zeros((self.obs_size,), np.float64)
        self._obs_m2 = np.ones((self.obs_size,), np.float64)
        # The live filter state: (h, z, a_prev) on the device, is_first
        # on the host (the envs' resets set it; a copy goes to the device
        # each step with the observations).
        self._o = np.stack([e.reset() for e in self.envs])
        self._h = torch.zeros((cfg.num_envs, cfg.det), device=dev)
        self._z = torch.zeros((cfg.num_envs, cfg.latent), device=dev)
        self._a_prev = torch.zeros((cfg.num_envs,), dtype=torch.int64,
                                   device=dev)
        self._is_first = np.ones((cfg.num_envs,), np.float32)
        self._rew_lo, self._rew_hi = 0.0, 0.0
        self._ep_ret = np.zeros((cfg.num_envs,))
        self._ep_returns: list[float] = []
        self.total_env_steps = 0

    def _norm(self, o):
        std = np.sqrt(self._obs_m2 / self._obs_count) + 1e-3
        return ((o - self._obs_mean) / std).astype(np.float32)

    def _track_obs(self, o):
        self._obs_count += 1
        d = o - self._obs_mean
        self._obs_mean += d / self._obs_count
        self._obs_m2 += d * (o - self._obs_mean)

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    # -- experience --------------------------------------------------------
    def _push(self, o, a, r, d, first):
        i = self._idx
        self._track_obs(o)
        self._obs[i], self._act[i] = o, a
        self._rew[i], self._done[i], self._first[i] = r, d, first
        self._idx = (i + 1) % self.cfg.buffer_size
        self._full = self._full or self._idx == 0

    def _act_noise(self) -> dict:
        """The draws of one act_step, from the trainable's generator."""
        cfg = self.cfg
        return {"eps": torch.randn((cfg.num_envs, cfg.latent),
                                   generator=self._gen, device=self.device),
                "gumbel": gumbel((cfg.num_envs, self.num_actions),
                                 self._gen, self.device)}

    def _update_noise(self) -> dict:
        cfg = self.cfg
        return update_noise(self._gen, cfg.batch_seqs, cfg.seq_len,
                            cfg.horizon, cfg.latent, self.num_actions,
                            self.device)

    def _collect(self, n_steps: int) -> None:
        cfg = self.cfg
        for _ in range(n_steps // cfg.num_envs):
            a, self._h, self._z = act_step(
                self.num_actions, self.params, self._h, self._z,
                self._a_prev, self._t(self._norm(self._o)),
                self._t(self._is_first), self._act_noise())
            a_np = a.cpu().numpy().astype(np.int32)
            firsts = self._is_first.copy()
            obs_before = self._o.copy()
            for i, env in enumerate(self.envs):
                o2, r, term, trunc = env.step(int(a_np[i]))
                # The continue head models TERMINATION only: truncation is
                # a horizon artifact, not the end of the environment.
                self._push(obs_before[i], int(a_np[i]), r, float(term),
                           firsts[i])
                self._rew_lo = min(self._rew_lo, float(r))
                self._rew_hi = max(self._rew_hi, float(r))
                self._ep_ret[i] += r
                if term or trunc:
                    o2 = env.reset()
                    self._ep_returns.append(float(self._ep_ret[i]))
                    self._ep_ret[i] = 0.0
                    self._is_first[i] = 1.0
                else:
                    self._is_first[i] = 0.0
                self._o[i] = o2
            self._a_prev = a
            self.total_env_steps += cfg.num_envs

    def _sample_batch(self) -> dict:
        cfg = self.cfg
        B = cfg.buffer_size
        if self._full:
            # Windows must not straddle the ring's write seam at _idx:
            # that would splice the newest transitions onto ~buffer-old
            # ones with no is_first reset at the junction.
            r = self._np_rng.integers(0, B - cfg.seq_len,
                                      size=(cfg.batch_seqs,))
            starts = (self._idx + r) % B
        else:
            hi = self._idx - cfg.seq_len
            starts = self._np_rng.integers(0, max(1, hi),
                                           size=(cfg.batch_seqs,))
        idx = (starts[:, None] + np.arange(cfg.seq_len)[None, :]) % B
        return {"obs": self._t(self._norm(self._obs[idx])),
                "actions": self._t(self._act[idx].astype(np.int64)),
                "rewards": self._t(self._rew[idx]),
                "dones": self._t(self._done[idx]),
                "is_first": self._t(self._first[idx])}

    # -- Trainable ---------------------------------------------------------
    def step(self) -> dict:
        cfg = self.cfg
        self._collect(cfg.env_steps_per_iter)
        metrics = {}
        if self.total_env_steps >= cfg.learning_starts:
            static = (cfg.horizon, cfg.gamma, cfg.lam, cfg.free_bits,
                      cfg.ent_coef)
            bounds = self._t(np.asarray([self._rew_lo, self._rew_hi],
                                        np.float32))
            for _ in range(cfg.train_steps_per_iter):
                self.params, self.opt_state, metrics = dreamer_update(
                    self.optimizer, static, self.num_actions, self.params,
                    self.opt_state, self._sample_batch(), bounds,
                    self._update_noise())
            metrics = dict(zip(metrics, torch.stack(
                list(metrics.values())).tolist()))
        recent = self._ep_returns[-20:]
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "env_steps": self.total_env_steps,
            "episode_return_mean": (float(np.mean(recent))
                                    if recent else 0.0),
            **metrics,
        }

    def save_checkpoint(self):
        return {"params": params_to_numpy(self.params),
                "opt_state": params_to_numpy(self.opt_state),
                "iteration": self.iteration}

    def load_checkpoint(self, ckpt) -> None:
        self.params = params_from_jax(ckpt["params"], self.device)
        self.opt_state = state_from_numpy(ckpt["opt_state"], self.device)
        self.iteration = ckpt["iteration"]
