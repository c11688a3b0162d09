"""Connector pipelines: composable observation/action transforms.

Capability parity with the reference's connector framework (reference:
rllib/connectors/ — ConnectorV2 pieces composed into env-to-module and
module-to-env pipelines that every EnvRunner applies; previously these
transforms were ad hoc per algorithm). A pipeline is an ordered list of
connectors; env-to-module runs on observations before the policy, and
module-to-env runs on the policy's actions before the environment.

Stateful connectors (running normalizers, frame stacks) expose
state_dict/set_state so checkpoints capture them; runner-local state is
the compact substitution for the reference's cross-runner state merge.
The port's own copy of ray_tpu/rl/connectors.py (numpy only).
"""

from __future__ import annotations


import numpy as np


class Connector:
    """One transform stage. ``__call__(batch)`` maps a [N, ...] numpy
    batch to its transformed batch. ``frozen`` applies the transform
    without advancing internal state (bootstrap observations); every
    stateful connector must honor it — the base default makes the
    contract uniform."""

    frozen = False

    def __call__(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def reset(self, env_index: int) -> None:
        """Episode boundary for one vectorized env (frame stacks etc.)."""

    def state_dict(self) -> dict:
        return {}

    def set_state(self, state: dict) -> None:
        pass


class ConnectorPipeline(Connector):
    def __init__(self, connectors: list[Connector] | None = None):
        self.connectors = list(connectors or [])

    def __call__(self, x: np.ndarray) -> np.ndarray:
        for c in self.connectors:
            x = c(x)
        return x

    def reset(self, env_index: int) -> None:
        for c in self.connectors:
            c.reset(env_index)

    def state_dict(self) -> dict:
        return {i: c.state_dict() for i, c in enumerate(self.connectors)}

    def set_state(self, state: dict) -> None:
        for i, c in enumerate(self.connectors):
            if i in state:
                c.set_state(state[i])

    def frozen_apply(self, x: np.ndarray) -> np.ndarray:
        """Apply without advancing any connector's state (bootstrap
        observations ride through; the pipeline owns the contract)."""
        prior = [(c, c.frozen) for c in self.connectors]
        for c in self.connectors:
            c.frozen = True
        try:
            return self(x)
        finally:
            for c, old in prior:
                c.frozen = old

    @property
    def output_multiplier(self) -> int:
        """Observation-width growth factor (frame stacking)."""
        m = 1
        for c in self.connectors:
            m *= getattr(c, "output_multiplier", 1)
        return m


# ---------------------------------------------------------- env-to-module --

class NormalizeObservations(Connector):
    """Running mean/std observation normalization (reference:
    connectors/env_to_module/mean_std_filter.py)."""

    def __init__(self, clip: float = 10.0):
        self.clip = clip
        self._count = 1e-4
        self._mean: np.ndarray | None = None
        self._m2: np.ndarray | None = None
        self.frozen = False  # evaluation mode: apply without updating

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if self._mean is None:
            self._mean = np.zeros(x.shape[-1], np.float64)
            self._m2 = np.ones(x.shape[-1], np.float64)
        if not self.frozen:
            # Batched Welford merge (Chan et al.): one vectorized pass per
            # batch instead of a per-row Python loop on the rollout path.
            rows = x.reshape(-1, x.shape[-1]).astype(np.float64)
            n = rows.shape[0]
            b_mean = rows.mean(0)
            b_m2 = ((rows - b_mean) ** 2).sum(0)
            delta = b_mean - self._mean
            tot = self._count + n
            self._mean = self._mean + delta * (n / tot)
            self._m2 = (self._m2 + b_m2
                        + delta**2 * (self._count * n / tot))
            self._count = tot
        std = np.sqrt(self._m2 / self._count) + 1e-6
        out = (x - self._mean) / std
        return np.clip(out, -self.clip, self.clip).astype(np.float32)

    def state_dict(self) -> dict:
        # Copies: the live arrays keep mutating, and a restored connector
        # must never alias the donor's state.
        return {"count": self._count,
                "mean": None if self._mean is None else self._mean.copy(),
                "m2": None if self._m2 is None else self._m2.copy()}

    def set_state(self, state: dict) -> None:
        self._count = state["count"]
        self._mean = (None if state["mean"] is None
                      else np.array(state["mean"], np.float64))
        self._m2 = (None if state["m2"] is None
                    else np.array(state["m2"], np.float64))


class FrameStack(Connector):
    """Stack the last k observations per env (reference:
    connectors/env_to_module/frame_stacking.py). Output width = k × obs."""

    def __init__(self, k: int = 4):
        self.k = k
        self._buf: np.ndarray | None = None
        self._refill: set[int] = set()  # envs awaiting post-reset refill

    @property
    def output_multiplier(self) -> int:
        return self.k

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        n, d = x.shape
        if self._buf is None or self._buf.shape[0] != n:
            self._buf = np.tile(x[:, None, :], (1, self.k, 1))
            self._refill.clear()
        elif self.frozen:
            # Peek: stack as if pushed, without mutating (bootstrap obs).
            return np.concatenate(
                [self._buf[:, 1:], x[:, None, :]], axis=1).reshape(
                    n, self.k * d)
        else:
            self._buf = np.concatenate(
                [self._buf[:, 1:], x[:, None, :]], axis=1)
            # Post-reset envs refill ALL frames with the reset observation
            # (reference behavior) — zero frames would be inputs the
            # policy never sees at init.
            for i in self._refill:
                self._buf[i] = x[i]
            self._refill.clear()
        return self._buf.reshape(n, self.k * d)

    def reset(self, env_index: int) -> None:
        self._refill.add(int(env_index))

    def state_dict(self) -> dict:
        return {"buf": None if self._buf is None else self._buf.copy(),
                "refill": set(self._refill)}

    def set_state(self, state: dict) -> None:
        self._buf = (None if state["buf"] is None
                     else np.array(state["buf"], np.float32))
        self._refill = set(state.get("refill", ()))


class ClipObservations(Connector):
    def __init__(self, lo: float = -10.0, hi: float = 10.0):
        self.lo, self.hi = lo, hi

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return np.clip(np.asarray(x, np.float32), self.lo, self.hi)


# ---------------------------------------------------------- module-to-env --

class ClipActions(Connector):
    """Clip continuous actions to the env's bounds (reference:
    connectors/module_to_env/... action clipping)."""

    def __init__(self, limit: float = 1.0):
        self.limit = limit

    def __call__(self, a: np.ndarray) -> np.ndarray:
        return np.clip(a, -self.limit, self.limit)


class UnsquashActions(Connector):
    """Map tanh-squashed [-1, 1] model actions onto [-limit, limit]."""

    def __init__(self, limit: float = 1.0):
        self.limit = limit

    def __call__(self, a: np.ndarray) -> np.ndarray:
        return np.clip(a, -1.0, 1.0) * self.limit
