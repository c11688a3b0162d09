"""Anakin: the whole PPO actor-learner loop on the card, no host round trip.

Port of ray_tpu/rl/anakin.py, the first Podracer shape (PAPERS.md
"Podracer architectures for scalable Reinforcement Learning"): the envs
live on the device beside the learner, so a training iteration (act,
step thousands of envs, GAE, the minibatched multi-epoch PPO update)
never waits for the host. JAX fuses it into one XLA program:

    pmap over devices
      └─ scan over train iterations (iters_per_step a call)
           └─ scan over unroll steps
                └─ vmap over envs
           └─ scan over epochs x minibatches (grads pmean'd)

Here the same loops run eagerly in PyTorch, one card per process: the
envs are batched torch envs (rl/vec_env.py), and over several processes
each rank steps ``num_envs / world`` envs and all-reduces the mean of each
minibatch's gradient on the default process group (gloo on the CPU, NCCL
on cards; ``train.backend.init_distributed`` joins it), so the ranks'
params stay bit-equal. Inside ``step()`` nothing waits for the host:
episode returns and counts accumulate on the device, minibatch indices
and actions are drawn on the device from a per-rank ``torch.Generator``
seeded from ``cfg.seed``, and the stats of all iterations come back in
one device-to-host copy (JAX's one ``np.asarray``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.ppo import (
    _logp_of,
    compute_gae,
    init_policy,
    mlp_apply,
    params_from_jax,
    params_to_numpy,
    ppo_update,
    sample_categorical,
)
from ray_tpu_torch.rl.vec_env import make_vec_env
from ray_tpu_torch.train.optim import adam


def pick_num_devices(num_envs: int) -> int:
    """The ranks that share the envs: the default process group's world
    size (1 without one), one card a rank. It must divide ``num_envs``
    (JAX picks the largest local device count that does; a process group
    cannot shrink)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_envs % world:
        raise ValueError(f"num_envs={num_envs} must divide evenly over "
                         f"the {world} ranks")
    return world


def rolled_idxs(shifts: torch.Tensor, B: int, num_mb: int) -> torch.Tensor:
    """[epochs, num_mb, B // num_mb] strided minibatches, JAX's
    ``roll(arange(B), shift).reshape(mb, num_mb).T`` for each epoch's
    shift, computed on the shifts' device (a roll by a device tensor)."""
    mb = B // num_mb
    base = torch.arange(num_mb * mb, device=shifts.device)
    rolled = (base[None, :] - shifts[:, None]) % (num_mb * mb)
    return rolled.reshape(-1, mb, num_mb).transpose(1, 2)


def _update(optimizer, cfg_static, params, opt_state, batch: dict,
            shifts: torch.Tensor, group=None):
    """Minibatched multi-epoch clipped-PPO update: rl/ppo.py's update on
    JAX's strided minibatches (one rotation ``shifts[e]`` an epoch, drawn
    in [0, B)), each minibatch's gradient averaged over ``group``'s ranks
    when one is given (``lax.pmean``)."""
    num_mb = cfg_static[3]
    idxs = rolled_idxs(shifts, batch["obs"].shape[0], num_mb)
    return ppo_update(optimizer, cfg_static, params, opt_state, batch, idxs,
                      group)


def make_rollout_fn(env, params_apply_pi, params_apply_vf, unroll_len: int):
    """Trajectory collection over ``unroll_len`` steps of batched envs.

    rollout(params, env_states, obs, ep_ret, generator, actions=None) ->
    ((env_states, obs, ep_ret), traj, ep_stats): traj holds [T, N, ...]
    tensors; ep_stats the sum of completed-episode returns and their
    count, on the device. Actions are sampled from ``generator`` unless
    given as [T, N]; auto-resets draw from ``generator``.
    """

    @torch.no_grad()
    def rollout(params, env_states, obs, ep_ret, generator, actions=None):
        keys = ("obs", "actions", "logp", "values", "rewards", "dones")
        traj = {k: [] for k in keys}
        ret_sum = torch.zeros_like(ep_ret)
        count = torch.zeros_like(ep_ret)
        for t in range(unroll_len):
            logits = params_apply_pi(params, obs)
            value = params_apply_vf(params, obs)
            action = (sample_categorical(logits, generator) if actions is None
                      else actions[t])
            logp = _logp_of(F.log_softmax(logits, -1), action)
            env_states, next_obs, reward, done = env.step(
                env_states, action, generator)
            ep_ret = ep_ret + reward
            done_f = done.float()
            ret_sum.addcmul_(ep_ret, done_f)
            count.add_(done_f)
            for k, v in zip(keys, (obs, action, logp, value, reward, done)):
                traj[k].append(v)
            ep_ret = torch.where(done, 0.0, ep_ret)
            obs = next_obs
        traj = {k: torch.stack(v) for k, v in traj.items()}
        ep_stats = {"ret_sum": ret_sum.sum(), "count": count.sum()}
        return (env_states, obs, ep_ret), traj, ep_stats

    return rollout


def _apply_pi(p, o):
    return mlp_apply(p["pi"], o)


def _apply_vf(p, o):
    return mlp_apply(p["vf"], o)[..., 0]


class AnakinPPO:
    """Drives the loop; rl/ppo.py's PPO delegates here when
    ``vectorized=True`` and the env has a batched torch implementation."""

    def __init__(self, cfg):
        import torch.distributed as dist

        self.cfg = cfg
        self.device = dev = resolve_device(cfg.device)
        self.env = env = make_vec_env(cfg.env)
        self.unroll_len = cfg.unroll_len or cfg.rollout_len
        self.num_envs = cfg.num_envs or (
            max(1, cfg.num_env_runners) * cfg.num_envs_per_runner)
        self.num_devices = pick_num_devices(self.num_envs)
        self.group = dist.group.WORLD if self.num_devices > 1 else None
        rank = dist.get_rank() if self.group is not None else 0
        self.n_local = self.num_envs // self.num_devices
        local_batch = self.n_local * self.unroll_len
        if local_batch % cfg.num_minibatches:
            raise ValueError(
                f"per-rank batch {local_batch} (= {self.n_local} envs x "
                f"{self.unroll_len} unroll) must divide num_minibatches="
                f"{cfg.num_minibatches}")
        self.iters_per_step = int(cfg.extra.get("iters_per_step", 1))
        self.optimizer = adam(cfg.lr)
        # The same host draw on every rank and device.
        self.params = init_policy(torch.Generator().manual_seed(cfg.seed),
                                  env.observation_size, env.num_actions,
                                  cfg.hidden, device=dev)
        self.opt_state = self.optimizer.init(self.params)
        self.static = (cfg.clip, cfg.vf_coef, cfg.ent_coef,
                       cfg.num_minibatches, cfg.num_epochs)
        self.rollout = make_rollout_fn(env, _apply_pi, _apply_vf,
                                       self.unroll_len)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(cfg.seed * 1_000_003 + rank)
        self.env_states, self.obs = env.reset(self.n_local, self.gen)
        self.ep_ret = torch.zeros(self.n_local, device=dev)
        self._return_window: list[float] = []

    def one_iter(self) -> torch.Tensor:
        """Rollout, GAE and update: [policy_loss, vf_loss, entropy,
        ret_sum, count] of this rank, on the device."""
        cfg = self.cfg
        (self.env_states, self.obs, self.ep_ret), traj, ep_stats = \
            self.rollout(self.params, self.env_states, self.obs, self.ep_ret,
                         self.gen)
        with torch.no_grad():
            last_values = _apply_vf(self.params, self.obs)
        adv, ret = compute_gae(traj["rewards"], traj["values"],
                               traj["dones"], last_values, cfg.gamma,
                               cfg.gae_lambda)
        flat = lambda x: x.reshape((-1,) + x.shape[2:])
        batch = {"obs": flat(traj["obs"]), "actions": flat(traj["actions"]),
                 "logp": flat(traj["logp"]), "advantages": flat(adv),
                 "returns": flat(ret)}
        B = batch["obs"].shape[0]
        shifts = torch.randint(0, B, (cfg.num_epochs,), generator=self.gen,
                               device=self.device)
        self.params, self.opt_state, stats = _update(
            self.optimizer, self.static, self.params, self.opt_state, batch,
            shifts, self.group)
        return torch.stack([stats["policy_loss"], stats["vf_loss"],
                            stats["entropy"], ep_stats["ret_sum"],
                            ep_stats["count"]])

    def step(self) -> dict:
        import torch.distributed as dist

        stats = torch.stack([self.one_iter()
                             for _ in range(self.iters_per_step)])
        if self.group is not None:
            dist.all_reduce(stats, group=self.group)  # sums over ranks
        host = stats.cpu().numpy()  # the one device-to-host copy
        losses = host[:, :3].mean(0) / self.num_devices
        ret_sum, count = float(host[:, 3].sum()), float(host[:, 4].sum())
        if count:
            # One aggregate per call keeps the EnvRunner path's
            # smoothed-window metric shape.
            self._return_window.append(ret_sum / count)
            self._return_window = self._return_window[-100:]
        mean_ret = (float(np.mean(self._return_window))
                    if self._return_window else 0.0)
        steps = self.iters_per_step * self.num_envs * self.unroll_len
        return {
            "episode_return_mean": mean_ret,
            "episodes_completed": int(count),
            "num_env_steps_sampled": steps,
            "policy_loss": float(losses[0]),
            "vf_loss": float(losses[1]),
            "entropy": float(losses[2]),
        }

    # -- checkpoint plumbing (PPO.save/load_checkpoint delegate) ----------
    def host_params(self):
        return params_to_numpy(self.params)

    def set_params(self, params) -> None:
        self.params = params_from_jax(params, self.device)
