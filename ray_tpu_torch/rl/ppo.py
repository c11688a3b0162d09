"""PPO: clipped-surrogate policy optimization in PyTorch.

Port of ray_tpu/rl/ppo.py (reference: rllib/algorithms/ppo/ppo.py +
ppo_learner.py: GAE advantages, clipped policy loss, value loss, entropy
bonus, minibatched multi-epoch SGD; the Algorithm is a Tune Trainable).

The param layout is JAX's, so one initialization drives both packages:
an MLP is a list of ``{"w": [in, out], "b": [out]}`` layers applied as
``x @ w + b`` with tanh between, and a policy is ``{"pi": mlp, "vf":
mlp}``. ``params_from_jax`` and ``params_to_numpy`` convert such trees
with no transposes, so checkpoints are numpy trees either package loads.

Randomness is an input wherever JAX draws it from threefry keys:
``ppo_update`` takes the minibatch indices ``[epochs, num_mb, mb]`` that
JAX draws with ``jax.random.permutation``, and ``_act`` takes a
``torch.Generator`` (Gumbel-max sampling, as ``jax.random.categorical``)
or the actions themselves. The optimizer is ``train.optim.adam``, optax's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device, tree_leaves, tree_map
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.env_runner import RUNTIME_MISSING, EnvRunnerGroup
from ray_tpu_torch.train.optim import adam, apply_updates
from ray_tpu_torch.tune.trainable import Trainable

# ---------------------------------------------------------------------------
# policy / value networks (MLPs)
# ---------------------------------------------------------------------------


def init_mlp(generator: torch.Generator, sizes, scale_last: float = 0.01,
             device="cpu") -> list:
    """Layers of normal weights scaled sqrt(2 / fan_in) (the last by
    ``scale_last``) and zero biases, drawn from ``generator`` on the host
    so that every device and rank gets the same tree."""
    params = []
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        scale = scale_last if i == len(sizes) - 2 else math.sqrt(2.0 / fan_in)
        w = torch.randn((fan_in, fan_out), generator=generator) * scale
        params.append({"w": _leaf(w, device),
                       "b": _leaf(torch.zeros(fan_out), device)})
    return params


def mlp_apply(params: list, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = F.linear(x, layer["w"].t(), layer["b"])  # x @ w + b
        if i < len(params) - 1:
            x = torch.tanh(x)
    return x


def init_policy(generator: torch.Generator, obs_size: int, num_actions: int,
                hidden: int = 64, device="cpu") -> dict:
    return {
        "pi": init_mlp(generator, [obs_size, hidden, hidden, num_actions],
                       device=device),
        "vf": init_mlp(generator, [obs_size, hidden, hidden, 1],
                       scale_last=1.0, device=device),
    }


def _leaf(t: torch.Tensor, device) -> torch.Tensor:
    """A param leaf: f32 on ``device``, a leaf autograd differentiates."""
    return t.to(device=device, dtype=torch.float32).requires_grad_(True)


def params_from_jax(tree, device="cuda"):
    """A param tree of numpy (or JAX) arrays in JAX's layout -> the same
    tree of f32 leaf tensors on ``device``; lists and tuples keep their
    type. Needs no JAX import: ``np.asarray`` reads a jax array."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: _leaf(torch.from_numpy(np.array(a, np.float32)), dev),
        tree)


def params_to_numpy(tree):
    """The tree as numpy copies (a checkpoint, or JAX's input); a copy,
    since the update writes the params in place."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True).numpy(), tree)


def clone_params(tree):
    """A copy of a param tree that shares no storage (target networks)."""
    return tree_map(lambda t: t.detach().clone(), tree)


def state_from_numpy(tree, device):
    """A numpy tree (an optimizer state's checkpoint) -> tensors on
    ``device``, each keeping its dtype; named tuples keep their type."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def gumbel(shape, generator: torch.Generator, device,
           dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel draws -log(-log(u)), u uniform in [tiny, 1), as
    jax.random.gumbel."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(dtype).tiny)))


def sample_categorical(logits: torch.Tensor,
                       generator: torch.Generator) -> torch.Tensor:
    """Gumbel-max, as jax.random.categorical: argmax(logits + g)."""
    return (logits + gumbel(logits.shape, generator, logits.device,
                            logits.dtype)).argmax(-1)


def _logp_of(logp_all: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    return logp_all.gather(-1, actions.long()[..., None])[..., 0]


@torch.no_grad()
def _act(params, obs, generator=None, actions=None):
    """(actions, logp, value) of the policy at ``obs``; actions sampled
    from ``generator`` unless given."""
    logits = mlp_apply(params["pi"], obs)
    value = mlp_apply(params["vf"], obs)[..., 0]
    if actions is None:
        actions = sample_categorical(logits, generator)
    return actions, _logp_of(F.log_softmax(logits, -1), actions), value


# ---------------------------------------------------------------------------
# GAE + update
# ---------------------------------------------------------------------------

@torch.no_grad()
def compute_gae(rewards, values, dones, last_values, gamma: float,
                lam: float):
    """[T, N] tensors -> (advantages, returns): a reverse loop over T."""
    T = rewards.shape[0]
    next_values = torch.cat([values[1:], last_values[None]], 0)
    not_done = 1.0 - dones.float()
    deltas = rewards + gamma * next_values * not_done - values
    decay = gamma * lam * not_done
    adv = torch.zeros_like(last_values)
    advs = [None] * T
    for t in range(T - 1, -1, -1):
        adv = torch.addcmul(deltas[t], decay[t], adv)
        advs[t] = adv
    advantages = torch.stack(advs)
    return advantages, advantages + values


def ppo_loss(params, mb: dict, clip: float, vf_coef: float,
             ent_coef: float):
    """Clipped surrogate + value + entropy on one minibatch; advantages
    normalized with the population std (``jnp.std``, ddof 0)."""
    logits = mlp_apply(params["pi"], mb["obs"])
    values = mlp_apply(params["vf"], mb["obs"])[..., 0]
    logp_all = F.log_softmax(logits, -1)
    ratio = torch.exp(_logp_of(logp_all, mb["actions"]) - mb["logp"])
    adv = mb["advantages"]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = -torch.minimum(ratio * adv,
                        torch.clamp(ratio, 1 - clip, 1 + clip) * adv).mean()
    vf = 0.5 * ((values - mb["returns"]) ** 2).mean()
    ent = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    return pg + vf_coef * vf - ent_coef * ent, (pg, vf, ent)


def sgd_step(optimizer, params, opt_state, loss, group=None):
    """One optimizer step on ``loss``'s gradient w.r.t. every leaf of
    ``params`` (updated in place); with ``group``, the gradient is first
    averaged over its ranks in one all-reduce (``lax.pmean``)."""
    import torch.distributed as dist

    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    if group is not None:
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat = flat / dist.get_world_size(group)
        grads = [f.view_as(g) for f, g in
                 zip(flat.split([g.numel() for g in grads]), grads)]
    it = iter(grads)
    with torch.no_grad():
        updates, opt_state = optimizer.update(
            tree_map(lambda _: next(it), params), opt_state, params)
        apply_updates(params, updates)
    return params, opt_state


def ppo_update(optimizer, cfg_static, params, opt_state, batch: dict,
               idxs: torch.Tensor, group=None):
    """One epoch set of minibatched clipped-PPO updates.

    batch: flat [B, ...] tensors (obs, actions, logp, advantages,
    returns). cfg_static: (clip, vf_coef, ent_coef, num_minibatches,
    epochs). idxs: [epochs, num_mb, mb] row indices (JAX draws each
    epoch's as ``permutation(B)[:num_mb * mb].reshape(num_mb, mb)``).
    With ``group``, each minibatch's gradient is averaged over its ranks.
    Params and opt_state are updated in place and returned, with the
    last minibatch's stats as 0-d tensors.
    """
    clip, vf_coef, ent_coef = cfg_static[:3]
    aux = None
    for epoch in idxs:
        for idx in epoch:
            mb = {k: v[idx] for k, v in batch.items()}
            loss, aux = ppo_loss(params, mb, clip, vf_coef, ent_coef)
            params, opt_state = sgd_step(optimizer, params, opt_state, loss,
                                         group)
    pg, vf, ent = (a.detach() for a in aux)
    return params, opt_state, {"policy_loss": pg, "vf_loss": vf,
                               "entropy": ent}


def permutation_idxs(B: int, num_mb: int, epochs: int,
                     generator: torch.Generator) -> torch.Tensor:
    """[epochs, num_mb, B // num_mb] indices, a permutation an epoch."""
    mb = B // num_mb
    return torch.stack([
        torch.randperm(B, generator=generator, device=generator.device)[
            : num_mb * mb].reshape(num_mb, mb) for _ in range(epochs)])


# ---------------------------------------------------------------------------
# Algorithm (a Tune Trainable: reference algorithm.py's Algorithm(Trainable))
# ---------------------------------------------------------------------------

@dataclass
class PPOConfig:
    env: str = "CartPole-v1"
    num_env_runners: int = 0          # 0 = inline rollouts (the only one)
    num_envs_per_runner: int = 8
    rollout_len: int = 128
    # vectorized=True routes envs with a batched torch implementation
    # (rl/vec_env) to the fused Anakin loop (rl/anakin.py); numpy-only
    # envs fall back to the EnvRunner path below.
    vectorized: bool = False
    num_envs: int = 0                 # total vectorized envs (0 = derive
    #                                   from num_envs_per_runner)
    unroll_len: int = 0               # rollout length (0 = rollout_len)
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    num_minibatches: int = 4
    num_epochs: int = 4
    hidden: int = 64
    seed: int = 0
    # () -> (env_to_module, module_to_env) connector pipelines.
    connector_factory: Any = None
    device: str = "cuda"
    extra: dict = field(default_factory=dict)

    def build(self) -> "PPO":
        return PPO({"ppo_config": self})


def host_act_fn(device: torch.device, act):
    """An EnvRunner ``act_fn`` around a device policy: numpy obs in,
    numpy (actions, logp, value) out, one generator seeded per call."""

    def act_fn(params, obs, seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        out = act(params, torch.as_tensor(obs, device=device), gen)
        return tuple(t.cpu().numpy() for t in out)

    return act_fn


class PPO(Trainable):
    """EnvRunnerGroup sampling + the learner update per step(), or the
    fused Anakin loop under ``vectorized=True`` (reference:
    algorithm.py:212)."""

    def setup(self, config: dict) -> None:
        cfg = config.get("ppo_config") or PPOConfig(
            **{k: v for k, v in config.items()
               if k in PPOConfig.__dataclass_fields__})
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self._engine = None
        if cfg.vectorized:
            from ray_tpu_torch.rl.vec_env import is_vec_env

            if is_vec_env(cfg.env):
                if cfg.num_env_runners > 0:
                    raise NotImplementedError(
                        "vectorized=True with num_env_runners > 0 is "
                        "Sebulba, which " + RUNTIME_MISSING)
                from ray_tpu_torch.rl.anakin import AnakinPPO

                self._engine = AnakinPPO(cfg)
                return
        probe = make_env(cfg.env, seed=cfg.seed)
        obs_size, num_actions = probe.observation_size, probe.num_actions
        if cfg.connector_factory is not None:
            # Frame stacking etc. widen the policy's observation input.
            e2m_probe, _ = cfg.connector_factory()
            obs_size *= getattr(e2m_probe, "output_multiplier", 1)
        self.params = init_policy(torch.Generator().manual_seed(cfg.seed),
                                  obs_size, num_actions, cfg.hidden,
                                  device=self.device)
        self.optimizer = adam(cfg.lr)
        self.opt_state = self.optimizer.init(self.params)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.seed)
        act_fn = host_act_fn(self.device, _act)
        self.runners = EnvRunnerGroup(
            cfg.env, num_runners=cfg.num_env_runners,
            num_envs_per_runner=cfg.num_envs_per_runner,
            rollout_len=cfg.rollout_len,
            policy_factory=lambda: (act_fn, None),
            seed=cfg.seed, connector_factory=cfg.connector_factory)
        self._return_window: list[float] = []

    def step(self) -> dict:
        if self._engine is not None:
            return self._engine.step()
        cfg, dev = self.cfg, self.device
        samples = self.runners.sample(self.params)
        flats = []
        for s in samples:
            t = {k: torch.as_tensor(s[k], device=dev) for k in
                 ("obs", "actions", "logp", "values", "rewards", "dones",
                  "last_values")}
            adv, ret = compute_gae(t["rewards"], t["values"], t["dones"],
                                   t["last_values"], cfg.gamma,
                                   cfg.gae_lambda)
            flats.append({
                "obs": t["obs"].reshape(-1, t["obs"].shape[-1]),
                "actions": t["actions"].reshape(-1),
                "logp": t["logp"].reshape(-1),
                "advantages": adv.reshape(-1),
                "returns": ret.reshape(-1),
            })
            self._return_window.extend(s["episode_returns"])
        batch = {k: torch.cat([f[k] for f in flats]) for k in flats[0]}
        static = (cfg.clip, cfg.vf_coef, cfg.ent_coef, cfg.num_minibatches,
                  cfg.num_epochs)
        idxs = permutation_idxs(batch["obs"].shape[0], cfg.num_minibatches,
                                cfg.num_epochs, self._gen)
        self.params, self.opt_state, stats = ppo_update(
            self.optimizer, static, self.params, self.opt_state, batch,
            idxs)
        self._return_window = self._return_window[-100:]
        mean_ret = (float(np.mean(self._return_window))
                    if self._return_window else 0.0)
        return {
            "episode_return_mean": mean_ret,
            "num_env_steps_sampled": int(batch["obs"].shape[0]),
            **{k: float(v) for k, v in stats.items()},
        }

    def save_checkpoint(self) -> Any:
        if self._engine is not None:
            return {"params": self._engine.host_params(),
                    "iteration": self.iteration, "connector_state": {}}
        return {"params": params_to_numpy(self.params),
                "iteration": self.iteration,
                # A policy trained behind a running normalizer is only
                # meaningful WITH that normalizer's statistics.
                "connector_state": self.runners.connector_state()}

    def load_checkpoint(self, checkpoint: Any) -> None:
        self.iteration = checkpoint["iteration"]
        if self._engine is not None:
            self._engine.set_params(checkpoint["params"])
            return
        self.params = params_from_jax(checkpoint["params"], self.device)
        self.runners.set_connector_state(
            checkpoint.get("connector_state", {}))

    def cleanup(self) -> None:
        if self._engine is None:
            self.runners.shutdown()
