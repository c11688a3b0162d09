"""Batched torch environments: the Podracer env substrate on a card.

Port of ray_tpu/rl/vec_env.py. There each env is a pure function over the
state of ONE env, and ``jax.vmap`` adds the batch. Here every env is
written batched over a leading ``[N]`` dim, so one call steps all N envs
on the device their tensors live on:

    reset(n, generator)        -> (state, obs)
    step(state, action)        -> (state, obs, reward, done)

``state`` is a dict of ``[N]``-leading tensors with no ``"key"`` leaf:
randomness comes from a ``torch.Generator`` on the env's device, which
also names that device (``torch.func.vmap`` takes no generator, hence the
hand-batched bodies). Actions are integer tensors of shape ``[N]`` of
any integer dtype; integer state leaves stay int32, as JAX's.

``AutoResetWrapper`` folds episode boundaries into ``step`` so the rollout
never leaves the device: it draws a fresh reset for every env each step
and selects it per leaf with ``torch.where`` where ``done`` (the terminal
reward and ``done=True`` still describe the finished transition). As in
JAX, time-limit truncation is folded into ``done``.

``make_vec_env("CartPole-v1")`` and rl/env.py's ``make_env("CartPole-v1")``
are the same task, so ``PPO(vectorized=True)`` falls back to the
EnvRunner path for names only the numpy registry knows.
"""

from __future__ import annotations

import math

import torch


def _ints(n: int, value: int, device) -> torch.Tensor:
    return torch.full((n,), value, dtype=torch.int32, device=device)


class VecCartPole:
    """CartPole-v1 in f32 torch: the constants of env.CartPoleEnv (gym's
    CartPole-v1), so trajectories match the numpy env step for step up
    to f32-vs-f64 drift."""

    GRAVITY = 9.8
    CART_M = 1.0
    POLE_M = 0.1
    POLE_L = 0.5  # half-length
    FORCE = 10.0
    DT = 0.02
    THETA_LIMIT = 12 * 2 * math.pi / 360
    X_LIMIT = 2.4

    observation_size = 4
    num_actions = 2

    def __init__(self, max_steps: int = 500):
        self.max_steps = max_steps

    def reset(self, n: int, generator: torch.Generator):
        dev = generator.device
        phys = torch.rand((n, 4), generator=generator, device=dev) * 0.1 \
            - 0.05  # uniform in [-0.05, 0.05)
        return {"phys": phys, "steps": _ints(n, 0, dev)}, phys

    def step(self, state, action):
        x, x_dot, th, th_dot = state["phys"].unbind(-1)
        force = torch.where(action == 1, self.FORCE, -self.FORCE)
        total_m = self.CART_M + self.POLE_M
        pm_l = self.POLE_M * self.POLE_L
        cos, sin = torch.cos(th), torch.sin(th)
        temp = (force + pm_l * th_dot**2 * sin) / total_m
        th_acc = (self.GRAVITY * sin - cos * temp) / (
            self.POLE_L * (4.0 / 3.0 - self.POLE_M * cos**2 / total_m))
        x_acc = temp - pm_l * th_acc * cos / total_m
        x = x + self.DT * x_dot
        x_dot = x_dot + self.DT * x_acc
        th = th + self.DT * th_dot
        th_dot = th_dot + self.DT * th_acc
        phys = torch.stack([x, x_dot, th, th_dot], -1)
        steps = state["steps"] + 1
        terminated = (x.abs() > self.X_LIMIT) | (th.abs() > self.THETA_LIMIT)
        done = terminated | (steps >= self.max_steps)
        return ({"phys": phys, "steps": steps}, phys, torch.ones_like(x),
                done)


class VecCatch:
    """bsuite-style Catch: a ball falls one row per step down a
    rows x cols board; move the paddle on the bottom row to catch it.
    Reward +1/-1 on the final row, 0 otherwise; episode length rows-1."""

    ROWS = 10
    COLS = 5

    observation_size = ROWS * COLS
    num_actions = 3  # left / stay / right

    def _obs(self, state):
        cells = torch.arange(self.ROWS * self.COLS,
                             device=state["ball_x"].device)
        ball = state["ball_y"] * self.COLS + state["ball_x"]
        paddle = (self.ROWS - 1) * self.COLS + state["paddle_x"]
        return ((cells == ball[:, None])
                | (cells == paddle[:, None])).float()

    def reset(self, n: int, generator: torch.Generator):
        dev = generator.device
        state = {
            "ball_x": torch.randint(0, self.COLS, (n,), generator=generator,
                                    device=dev, dtype=torch.int32),
            "ball_y": _ints(n, 0, dev),
            "paddle_x": _ints(n, self.COLS // 2, dev),
        }
        return state, self._obs(state)

    def step(self, state, action):
        paddle = (state["paddle_x"] + action - 1).clamp(
            0, self.COLS - 1).int()
        ball_y = state["ball_y"] + 1
        done = ball_y >= self.ROWS - 1
        reward = torch.where(
            done, torch.where(state["ball_x"] == paddle, 1.0, -1.0), 0.0)
        state = {"ball_x": state["ball_x"], "ball_y": ball_y,
                 "paddle_x": paddle}
        return state, self._obs(state), reward, done


class VecGridWorld:
    """Empty-room navigation: start top-left, goal bottom-right; 4 moves,
    -0.01 per step, +1 at the goal, truncates at max_steps. Obs is the
    one-hot agent position."""

    SIZE = 5

    observation_size = SIZE * SIZE
    num_actions = 4  # up / down / left / right

    def __init__(self, max_steps: int = 40):
        self.max_steps = max_steps

    def _obs(self, state):
        flat = state["row"] * self.SIZE + state["col"]
        cells = torch.arange(self.SIZE * self.SIZE, device=flat.device)
        return (cells == flat[:, None]).float()

    def reset(self, n: int, generator: torch.Generator):
        dev = generator.device  # no randomness: the generator names it
        state = {"row": _ints(n, 0, dev), "col": _ints(n, 0, dev),
                 "steps": _ints(n, 0, dev)}
        return state, self._obs(state)

    def step(self, state, action):
        drow = torch.where(action == 0, -1, torch.where(action == 1, 1, 0))
        dcol = torch.where(action == 2, -1, torch.where(action == 3, 1, 0))
        row = (state["row"] + drow).clamp(0, self.SIZE - 1).int()
        col = (state["col"] + dcol).clamp(0, self.SIZE - 1).int()
        steps = state["steps"] + 1
        at_goal = (row == self.SIZE - 1) & (col == self.SIZE - 1)
        reward = torch.where(at_goal, 1.0, -0.01)
        done = at_goal | (steps >= self.max_steps)
        state = {"row": row, "col": col, "steps": steps}
        return state, self._obs(state), reward, done


class AutoResetWrapper:
    """Folds episode boundaries into ``step``: where ``done`` the NEXT
    state/obs are a fresh episode's, while the terminal reward and
    ``done=True`` still describe the finished transition (the learner
    masks its bootstrap on ``done``). ``step`` draws the fresh episodes
    from ``generator``, or takes them as ``fresh=(state, obs)``."""

    def __init__(self, env):
        self.env = env
        self.observation_size = env.observation_size
        self.num_actions = env.num_actions

    def reset(self, n: int, generator: torch.Generator):
        return self.env.reset(n, generator)

    def step(self, state, action, generator: torch.Generator | None = None,
             fresh=None):
        state, obs, reward, done = self.env.step(state, action)
        if fresh is None:
            fresh = self.env.reset(done.shape[0], generator)
        reset_state, reset_obs = fresh

        def pick(r, s):
            return torch.where(done.view((-1,) + (1,) * (s.dim() - 1)), r, s)

        state = {k: pick(reset_state[k], v) for k, v in state.items()}
        return state, pick(reset_obs, obs), reward, done


_VEC_ENV_REGISTRY = {
    "CartPole-v1": VecCartPole,
    "Catch-v0": VecCatch,
    "GridWorld-v0": VecGridWorld,
}


def register_vec_env(name: str, ctor) -> None:
    """Add a batched torch env (ray_tpu.rl.vec_env.register_jax_env)."""
    _VEC_ENV_REGISTRY[name] = ctor


def is_vec_env(name: str) -> bool:
    """Whether ``name`` has a batched torch env
    (ray_tpu.rl.vec_env.is_jax_env)."""
    return name in _VEC_ENV_REGISTRY


def make_vec_env(name: str, *, auto_reset: bool = True, **kwargs):
    """The batched torch env ``name``, auto-resetting by default
    (ray_tpu.rl.vec_env.make_jax_env)."""
    try:
        env = _VEC_ENV_REGISTRY[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown vec env {name!r}; register_vec_env() it first "
            "(numpy-only envs run through the EnvRunner path)") from None
    return AutoResetWrapper(env) if auto_reset else env
