"""Search spaces and search algorithms.

Port of ray_tpu/tune/search.py, a copy: the domains, ``grid_search``,
``sample_from``, ``BasicVariantGenerator`` (grid and random) and
``TPESearcher`` (reference: python/ray/tune/search/). Deterministic given
a seed: both packages draw from the stdlib ``random`` in the same order,
so one seed suggests the same configurations in the same order in both.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from itertools import product
from typing import Any, Callable


class Domain:
    """A sampleable hyperparameter domain."""

    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


@dataclass
class Uniform(Domain):
    low: float
    high: float

    def sample(self, rng: random.Random) -> float:
        return rng.uniform(self.low, self.high)


@dataclass
class LogUniform(Domain):
    low: float
    high: float

    def sample(self, rng: random.Random) -> float:
        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


@dataclass
class QUniform(Domain):
    low: float
    high: float
    q: float

    def sample(self, rng: random.Random) -> float:
        v = rng.uniform(self.low, self.high)
        return round(v / self.q) * self.q


@dataclass
class RandInt(Domain):
    low: int
    high: int  # exclusive, matching the reference

    def sample(self, rng: random.Random) -> int:
        return rng.randrange(self.low, self.high)


@dataclass
class Choice(Domain):
    values: list

    def sample(self, rng: random.Random) -> Any:
        return rng.choice(self.values)


@dataclass
class SampleFrom(Domain):
    fn: Callable[[dict], Any]

    def sample(self, rng: random.Random) -> Any:
        # Config-dependent sampling is resolved by the variant generator,
        # which passes the partially-resolved spec.
        raise RuntimeError("SampleFrom must be resolved against a spec")


@dataclass
class GridSearch:
    values: list


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def quniform(low: float, high: float, q: float) -> QUniform:
    return QUniform(low, high, q)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def choice(values: list) -> Choice:
    return Choice(list(values))


def sample_from(fn: Callable[[dict], Any]) -> SampleFrom:
    return SampleFrom(fn)


def grid_search(values: list) -> GridSearch:
    return GridSearch(list(values))


def _walk(space: dict, path: tuple = ()):
    """Yield (path, leaf) for every leaf of a nested dict search space."""
    for k, v in space.items():
        p = path + (k,)
        if isinstance(v, dict):
            yield from _walk(v, p)
        else:
            yield p, v


def _set_path(cfg: dict, path: tuple, value: Any) -> None:
    d = cfg
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


def _deepcopy_plain(space: dict) -> dict:
    out = {}
    for k, v in space.items():
        out[k] = _deepcopy_plain(v) if isinstance(v, dict) else v
    return out


class Searcher:
    """Search-algorithm ABC (reference: tune/search/searcher.py Searcher).

    ``suggest`` returns a config for a new trial id (or None when exhausted);
    results flow back via ``on_trial_result``/``on_trial_complete``.
    """

    def set_search_properties(self, metric: str | None, mode: str | None,
                              space: dict | None) -> None:
        self.metric, self.mode, self.space = metric, mode, space

    def suggest(self, trial_id: str) -> dict | None:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        pass

    def on_trial_complete(self, trial_id: str, result: dict | None = None,
                          error: bool = False) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid cross-product × num_samples random draws (reference:
    tune/search/basic_variant.py). With no grid axes, emits num_samples
    sampled configs; with grid axes, each grid variant is repeated
    num_samples times (random leaves resampled per repeat)."""

    def __init__(self, seed: int | None = None):
        self._rng = random.Random(seed)
        self._variants: list[dict] | None = None
        self._next = 0

    def set_search_properties(self, metric, mode, space) -> None:
        super().set_search_properties(metric, mode, space)

    def _materialize(self, num_samples: int) -> None:
        space = self.space or {}
        grid_axes = [(p, v.values) for p, v in _walk(space)
                     if isinstance(v, GridSearch)]
        grids = list(product(*[vals for _, vals in grid_axes])) or [()]
        self._variants = []
        for _ in range(num_samples):
            for combo in grids:
                cfg = _deepcopy_plain(space)
                for (p, _), val in zip(grid_axes, combo):
                    _set_path(cfg, p, val)
                # Two passes so sample_from can see sampled siblings.
                deferred = []
                for p, v in list(_walk(cfg)):
                    if isinstance(v, Domain):
                        if isinstance(v, SampleFrom):
                            deferred.append((p, v))
                        else:
                            _set_path(cfg, p, v.sample(self._rng))
                for p, v in deferred:
                    _set_path(cfg, p, v.fn(cfg))
                self._variants.append(cfg)

    def total_variants(self, num_samples: int) -> int:
        if self._variants is None:
            self._materialize(num_samples)
        return len(self._variants)

    def suggest(self, trial_id: str) -> dict | None:
        if self._variants is None or self._next >= len(self._variants):
            return None
        cfg = self._variants[self._next]
        self._next += 1
        return cfg


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator search — own-built model-based
    searcher (capability match for the reference's vendored adapters,
    reference: tune/search/optuna/optuna_search.py; algorithm: Bergstra
    et al. 2011, the same family Optuna's default sampler uses).

    After ``n_startup`` random trials, completed trials are split at the
    ``gamma`` quantile of the objective into good/bad sets. Each dimension
    fits two Parzen mixtures, l(x) over good values and g(x) over bad
    (truncated Gaussians + a uniform prior component for numeric domains;
    smoothed categoricals for Choice), draws ``n_candidates`` from l and
    proposes the candidate maximizing l(x)/g(x) — the expected-improvement
    ratio. Dimensions are modeled independently (the classic TPE factoring).
    """

    def __init__(self, n_startup: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24, seed: int | None = None):
        self._n_startup = n_startup
        self._gamma = gamma
        self._n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._suggested: dict[str, dict] = {}
        self._observed: list[tuple[dict, float]] = []

    # -- observation flow --

    def on_trial_complete(self, trial_id: str, result: dict | None = None,
                          error: bool = False) -> None:
        cfg = self._suggested.pop(trial_id, None)
        if cfg is None or error or not result:
            return
        score = result.get(self.metric)
        if score is None:
            return
        self._observed.append((cfg, float(score)))

    # -- proposal --

    def suggest(self, trial_id: str) -> dict | None:
        space = self.space or {}
        dims = [(p, v) for p, v in _walk(space) if isinstance(v, Domain)]
        cfg = _deepcopy_plain(space)
        use_model = len(self._observed) >= self._n_startup
        if use_model:
            good, bad = self._split()
        deferred = []
        for p, dom in dims:
            if isinstance(dom, SampleFrom):
                deferred.append((p, dom))
                continue
            if use_model:
                val = self._propose(p, dom, good, bad)
            else:
                val = dom.sample(self._rng)
            _set_path(cfg, p, val)
        # Grid axes have no density model; treat them as categorical choices.
        for p, v in _walk(space):
            if isinstance(v, GridSearch):
                _set_path(cfg, p, self._rng.choice(v.values))
        for p, dom in deferred:
            _set_path(cfg, p, dom.fn(cfg))
        self._suggested[trial_id] = cfg
        return cfg

    def _split(self) -> tuple[list[dict], list[dict]]:
        sign = -1.0 if (self.mode or "min") == "max" else 1.0
        ranked = sorted(self._observed, key=lambda cv: sign * cv[1])
        n_good = max(1, int(math.ceil(self._gamma * len(ranked))))
        return ([c for c, _ in ranked[:n_good]],
                [c for c, _ in ranked[n_good:]] or [ranked[-1][0]])

    @staticmethod
    def _get_path(cfg: dict, path: tuple):
        d = cfg
        for k in path:
            d = d[k]
        return d

    def _propose(self, path, dom, good: list[dict], bad: list[dict]):
        gv = [self._get_path(c, path) for c in good]
        bv = [self._get_path(c, path) for c in bad]
        if isinstance(dom, Choice):
            return self._propose_categorical(dom.values, gv, bv)
        if isinstance(dom, LogUniform):
            lo, hi = math.log(dom.low), math.log(dom.high)
            x = self._propose_numeric(lo, hi, [math.log(v) for v in gv],
                                      [math.log(v) for v in bv])
            return math.exp(x)
        if isinstance(dom, (Uniform, QUniform)):
            x = self._propose_numeric(dom.low, dom.high, gv, bv)
            if isinstance(dom, QUniform):
                x = round(x / dom.q) * dom.q
            return x
        if isinstance(dom, RandInt):
            x = self._propose_numeric(dom.low, dom.high - 1,
                                      [float(v) for v in gv],
                                      [float(v) for v in bv])
            return max(dom.low, min(dom.high - 1, int(round(x))))
        return dom.sample(self._rng)  # unknown domain: random fallback

    def _propose_categorical(self, values: list, gv: list, bv: list):
        def weights(obs):
            # Add-one smoothing keeps unseen categories samplable.
            w = {id_v: 1.0 for id_v in range(len(values))}
            for o in obs:
                for i, v in enumerate(values):
                    if v == o:
                        w[i] += 1.0
                        break
            total = sum(w.values())
            return [w[i] / total for i in range(len(values))]

        lw, gw = weights(gv), weights(bv)
        # Sample candidates from l, score by l/g.
        best_i, best_ratio = None, -1.0
        for _ in range(self._n_candidates):
            i = self._rng.choices(range(len(values)), weights=lw)[0]
            ratio = lw[i] / gw[i]
            if ratio > best_ratio:
                best_i, best_ratio = i, ratio
        return values[best_i]

    def _propose_numeric(self, low: float, high: float,
                         gv: list[float], bv: list[float]) -> float:
        span = max(high - low, 1e-12)

        def bandwidth(obs):
            # Shrinks as evidence accumulates; floored so the mixture
            # never collapses to spikes.
            return max(span / max(2.0, len(obs) ** 0.7), span * 0.01)

        def pdf(x, obs, sigma):
            # Truncated-Gaussian Parzen mixture + uniform prior component.
            total = 1.0 / span  # prior
            inv = 1.0 / (sigma * math.sqrt(2.0 * math.pi))
            for mu in obs:
                z = (x - mu) / sigma
                total += inv * math.exp(-0.5 * z * z)
            return total / (len(obs) + 1)

        sg, sb = bandwidth(gv), bandwidth(bv)
        best_x, best_ratio = None, -1.0
        for _ in range(self._n_candidates):
            if gv and self._rng.random() > 1.0 / (len(gv) + 1):
                mu = self._rng.choice(gv)
                x = self._rng.gauss(mu, sg)
                x = min(max(x, low), high)
            else:
                x = self._rng.uniform(low, high)  # prior component
            ratio = pdf(x, gv, sg) / pdf(x, bv, sb)
            if ratio > best_ratio:
                best_x, best_ratio = x, ratio
        return best_x
