"""Model multiplexing: many models share one replica pool.

Port of ray_tpu/serve/multiplex.py: ``@serve.multiplexed`` wraps a model
loader with a per-replica LRU; ``handle.options(multiplexed_model_id=...)``
routes the request to a replica likely to hold the model (the router's
rendezvous-hash route hint), and ``serve.get_multiplexed_model_id()`` reads
the id inside the replica.
"""

from __future__ import annotations

import asyncio
import contextvars
import functools
import threading
from collections import OrderedDict
from typing import Any, Callable

_current_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "rtpu_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """The model id of the request being handled (empty when the request
    carried none) — call inside replica code."""
    return _current_model_id.get()


def _set_multiplexed_model_id(model_id: str):
    return _current_model_id.set(model_id)


class _ModelCache:
    """Per-replica LRU of loaded models with optional per-model teardown.
    Loads are single-flight: concurrent first requests for one model id
    wait on the leader's load instead of loading twice (two simultaneous
    copies of an LLM-sized model would blow memory, and the displaced
    duplicate's teardown would never run)."""

    def __init__(self, loader: Callable, max_models: int):
        self.loader = loader
        self.max_models = max_models
        self._models: OrderedDict[str, Any] = OrderedDict()
        self._loading: dict[str, threading.Event] = {}
        self._lock = threading.Lock()

    def get(self, owner, model_id: str):
        while True:
            with self._lock:
                if model_id in self._models:
                    self._models.move_to_end(model_id)
                    return self._models[model_id]
                ev = self._loading.get(model_id)
                if ev is None:
                    ev = threading.Event()
                    self._loading[model_id] = ev
                    break  # we are the loader
            ev.wait(timeout=600)  # follower: retry once the leader finishes
        try:
            model = self.loader(owner, model_id)
            if asyncio.iscoroutine(model):
                model = asyncio.run(model)
        except BaseException:
            with self._lock:
                self._loading.pop(model_id, None)
            ev.set()  # unblock followers; they retry and re-lead
            raise
        with self._lock:
            self._models[model_id] = model
            self._models.move_to_end(model_id)
            self._loading.pop(model_id, None)
            while len(self._models) > self.max_models:
                _mid, evicted = self._models.popitem(last=False)
                del_fn = getattr(evicted, "__del_multiplexed_model__", None)
                if callable(del_fn):
                    try:
                        del_fn()
                    except Exception:
                        pass
        ev.set()
        return model

    def loaded_ids(self) -> list[str]:
        with self._lock:
            return list(self._models)


def multiplexed(func: Callable | None = None, *,
                max_num_models_per_replica: int = 3):
    """Decorator for a replica method that loads a model by id; calls hit a
    per-replica LRU (evicting least-recently-used beyond the cap)."""

    def deco(loader: Callable):
        attr = f"_rtpu_mux_cache_{loader.__name__}"

        @functools.wraps(loader)
        def wrapper(self, model_id: str | None = None):
            # Cache created lazily PER replica instance: a decoration-time
            # cache would embed an unpicklable lock in the class.
            cache = getattr(self, attr, None)
            if cache is None:
                cache = _ModelCache(loader, max_num_models_per_replica)
                setattr(self, attr, cache)
            mid = model_id if model_id is not None \
                else get_multiplexed_model_id()
            if not mid:
                raise ValueError(
                    "no model id: pass one or call through "
                    "handle.options(multiplexed_model_id=...)")
            return cache.get(self, mid)

        return wrapper

    if func is not None:
        return deco(func)
    return deco
