"""Application metrics API: Counter / Gauge / Histogram with tags.

Port of ray_tpu/util/metrics.py, unchanged in behaviour: the same
registry, snapshots, merge and Prometheus exposition. The data executor's
backpressure counter and the streaming split's stall and empty-poll
counters are its metrics; so are the P/D hand-off counters of
``llm/pd.py``.

Capability parity with the reference's metrics API (reference:
python/ray/util/metrics.py Counter/Gauge/Histogram over the C++ OpenCensus
recorder, src/ray/stats/metric.h): processes record metrics locally; the
dashboard scrapes/aggregates them in Prometheus text exposition format.

TPU-native note: no OpenCensus/OTel dependency — a lock-protected in-process
registry with Prometheus text export keeps the hot path to a dict update, and
the export shape identical to what the reference's metrics agent serves.

Cluster federation (reference: the metrics agent pushing to the dashboard's
aggregator): every process can ``snapshot()`` its registry into a
wire-serializable dict; the head collects snapshots per node and the
dashboard renders them with ``export_prometheus_federated`` — one endpoint,
every series labeled with its ``node_id``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Sequence



def guarded_by(lock: str, *attrs: str):
    """Declare ``attrs`` as guarded by ``self.<lock>`` (the port's copy of
    ray_tpu/devtools/annotations.py's decorator: inert at runtime, it only
    records the declaration on the class)."""

    def deco(obj):
        existing = dict(getattr(obj, "__rtlint_guarded_by__", {}) or {})
        for a in attrs or ("<body>",):
            existing[a] = lock
        obj.__rtlint_guarded_by__ = existing
        return obj

    return deco


_DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0,
)

_exemplar_n: int | None = None


def _exemplar_count() -> int:
    """Exemplars kept per histogram series (Config metrics_exemplar_count),
    cached once — read lazily so the module imports without a runtime."""
    global _exemplar_n
    if _exemplar_n is None:
        try:
            from ray_tpu_torch.utils.config import get_config

            _exemplar_n = max(0, int(get_config().metrics_exemplar_count))
        except Exception:  # noqa: BLE001 - config not importable yet
            _exemplar_n = 4
    return _exemplar_n


@guarded_by("_lock", "_series")
class Metric:
    """Base: a named measurement with fixed tag keys and per-tagset series."""

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] | None = None):
        if not name or not name.replace("_", "a").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self._default_tags: dict[str, str] = {}
        self._lock = threading.Lock()
        self._series: dict[tuple, float] = {}
        _registry.register(self)

    def set_default_tags(self, tags: dict[str, str]):
        unknown = set(tags) - set(self.tag_keys)
        if unknown:
            raise ValueError(f"tags {unknown} not in declared tag_keys {self.tag_keys}")
        self._default_tags = dict(tags)
        return self

    def _series_key(self, tags: dict[str, str] | None) -> tuple:
        merged = dict(self._default_tags)
        if tags:
            unknown = set(tags) - set(self.tag_keys)
            if unknown:
                raise ValueError(
                    f"tags {unknown} not in declared tag_keys {self.tag_keys}")
            merged.update(tags)
        return tuple(merged.get(k, "") for k in self.tag_keys)

    def _points(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._series)


class _BoundSeries:
    """One pre-resolved series of a metric: the tag dict was merged and
    validated ONCE at bind time, so hot-path updates skip the per-call
    merge/validate/tuple-build of ``_series_key`` (measured as the
    dominant cost of a Counter.inc at router request rates). Exported
    state is identical — a bound update writes the same series the tagged
    call would."""

    __slots__ = ("_m", "_key")

    def __init__(self, metric: "Metric", key: tuple):
        self._m = metric
        self._key = key


class _BoundCounter(_BoundSeries):
    def inc(self, value: float = 1.0):
        self._m._inc_key(self._key, value)


class _BoundGauge(_BoundSeries):
    def set(self, value: float):
        self._m._set_key(self._key, value)


class _BoundHistogram(_BoundSeries):
    def observe(self, value: float, exemplar: str | None = None):
        self._m._observe_key(self._key, value, exemplar)


class Counter(Metric):
    """Monotonically increasing count."""

    def inc(self, value: float = 1.0, tags: dict[str, str] | None = None):
        self._inc_key(self._series_key(tags), value)

    def _inc_key(self, key: tuple, value: float):
        # Validated here so the bound fast path keeps the monotonicity
        # guarantee too — bound and tagged updates must behave alike.
        if value < 0:
            raise ValueError("Counter.inc() value must be >= 0")
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def bound(self, tags: dict[str, str] | None = None) -> _BoundCounter:
        return _BoundCounter(self, self._series_key(tags))

    prom_type = "counter"


class Gauge(Metric):
    """Last-set value."""

    def set(self, value: float, tags: dict[str, str] | None = None):
        self._set_key(self._series_key(tags), value)

    def _set_key(self, key: tuple, value: float):
        with self._lock:
            self._series[key] = float(value)

    def bound(self, tags: dict[str, str] | None = None) -> _BoundGauge:
        return _BoundGauge(self, self._series_key(tags))

    prom_type = "gauge"


@guarded_by("_lock", "_buckets", "_sums", "_series")
class Histogram(Metric):
    """Bucketed distribution (cumulative buckets, Prometheus-style)."""

    prom_type = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] | None = None,
                 tag_keys: Sequence[str] | None = None):
        super().__init__(name, description, tag_keys)
        bounds = tuple(boundaries) if boundaries else _DEFAULT_BUCKETS
        if list(bounds) != sorted(bounds):
            raise ValueError("histogram boundaries must be sorted ascending")
        self.boundaries = bounds
        self._buckets: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        # Recent (trace_id, value, ts) per series — the metrics→traces
        # link: a TTFT bucket names the traces that landed in it.
        self._exemplars: dict[tuple, deque] = {}

    def observe(self, value: float, tags: dict[str, str] | None = None,
                exemplar: str | None = None):
        self._observe_key(self._series_key(tags), value, exemplar)

    def _observe_key(self, key: tuple, value: float,
                     exemplar: str | None = None):
        with self._lock:
            buckets = self._buckets.setdefault(key, [0] * (len(self.boundaries) + 1))
            idx = len(self.boundaries)
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    idx = i
                    break
            buckets[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._series[key] = self._series.get(key, 0.0) + 1  # observation count
            if exemplar:
                n = _exemplar_count()
                if n:
                    ring = self._exemplars.get(key)
                    if ring is None:
                        ring = self._exemplars[key] = deque(maxlen=n)
                    ring.append((exemplar, float(value), time.time()))

    def bound(self, tags: dict[str, str] | None = None) -> _BoundHistogram:
        return _BoundHistogram(self, self._series_key(tags))

    def _hist_points(self):
        with self._lock:
            return (
                {k: list(v) for k, v in self._buckets.items()},
                dict(self._sums),
                dict(self._series),
                {k: [list(e) for e in v]
                 for k, v in self._exemplars.items() if v},
            )


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}

    def register(self, metric: Metric):
        with self._lock:
            self._metrics[metric.name] = metric

    def metrics(self) -> list[Metric]:
        with self._lock:
            return list(self._metrics.values())

    def clear(self):
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> dict:
        """Wire-serializable copy of every registered metric's state, the
        unit the telemetry pipeline ships to the head (reference: the
        OpenCensus snapshots the metrics agent exports). Series keys become
        lists so the dict survives msgpack/JSON round-trips."""
        entries = []
        for m in self.metrics():
            entry = {
                "name": m.name, "type": m.prom_type,
                "desc": m.description, "tag_keys": list(m.tag_keys),
            }
            if isinstance(m, Histogram):
                buckets, sums, counts, exemplars = m._hist_points()
                entry["boundaries"] = [float(b) for b in m.boundaries]
                entry["buckets"] = [[list(k), list(v)]
                                    for k, v in buckets.items()]
                entry["sums"] = [[list(k), v] for k, v in sums.items()]
                entry["counts"] = [[list(k), v] for k, v in counts.items()]
                if exemplars:
                    # JSON surfaces only (/api/metrics, /api/traces, the
                    # watchdog) — the Prometheus text exposition is
                    # deliberately untouched.
                    entry["exemplars"] = [[list(k), v]
                                          for k, v in exemplars.items()]
            else:
                entry["points"] = [[list(k), v]
                                   for k, v in m._points().items()]
            entries.append(entry)
        return {"metrics": entries}

    def export_prometheus(self) -> str:
        """Prometheus text exposition of every registered metric."""
        lines: list[str] = []
        for entry in self.snapshot()["metrics"]:
            lines.append(f"# HELP {entry['name']} {entry['desc']}")
            lines.append(f"# TYPE {entry['name']} {entry['type']}")
            lines.extend(_render_entry(entry))
        return "\n".join(lines) + "\n"


def merge_snapshots(snapshots: list[dict]) -> dict:
    """Merge per-process snapshots into one (several workers on one node
    report under the same node_id): counters and histograms sum, gauges
    keep the last reporter's value. Histogram merges require identical
    boundaries; a mismatched reporter's entry is kept as-is from the first."""
    merged: dict[str, dict] = {}
    for snap in snapshots:
        for entry in snap.get("metrics", []):
            have = merged.get(entry["name"])
            if have is None:
                import copy

                merged[entry["name"]] = copy.deepcopy(entry)
                continue
            if entry["type"] == "histogram":
                if have.get("boundaries") != entry.get("boundaries"):
                    continue
                for field, combine in (("buckets", "vec"), ("sums", "num"),
                                       ("counts", "num")):
                    idx = {tuple(k): v for k, v in have.get(field, [])}
                    for k, v in entry.get(field, []):
                        k = tuple(k)
                        if k not in idx:
                            idx[k] = v
                        elif combine == "vec":
                            idx[k] = [a + b for a, b in zip(idx[k], v)]
                        else:
                            idx[k] = idx[k] + v
                    have[field] = [[list(k), v] for k, v in idx.items()]
                if entry.get("exemplars"):
                    # Concat per series, keep the newest N by timestamp —
                    # same bound as one process's ring.
                    n = _exemplar_count() or 4
                    idx = {tuple(k): list(v)
                           for k, v in have.get("exemplars", [])}
                    for k, v in entry["exemplars"]:
                        k = tuple(k)
                        rows = idx.get(k, []) + list(v)
                        rows.sort(key=lambda e: e[2] if len(e) > 2 else 0.0)
                        idx[k] = rows[-n:]
                    have["exemplars"] = [[list(k), v]
                                         for k, v in idx.items()]
            else:
                idx = {tuple(k): v for k, v in have.get("points", [])}
                for k, v in entry.get("points", []):
                    k = tuple(k)
                    if entry["type"] == "counter":
                        idx[k] = idx.get(k, 0.0) + v
                    else:  # gauge: last reporter wins
                        idx[k] = v
                have["points"] = [[list(k), v] for k, v in idx.items()]
    return {"metrics": list(merged.values())}


def export_prometheus_federated(per_node: dict[str, dict]) -> str:
    """Cluster-wide Prometheus text exposition: every node's snapshot with a
    ``node_id`` label on each series, HELP/TYPE emitted once per metric name
    (reference: the dashboard's federated /metrics over per-node agents)."""
    by_name: dict[str, list[tuple[str, dict]]] = {}
    for node_id, snap in per_node.items():
        for entry in snap.get("metrics", []):
            by_name.setdefault(entry["name"], []).append((node_id, entry))
    lines: list[str] = []
    for name, rows in by_name.items():
        lines.append(f"# HELP {name} {rows[0][1]['desc']}")
        lines.append(f"# TYPE {name} {rows[0][1]['type']}")
        for node_id, entry in rows:
            lines.extend(_render_entry(entry, extra=[("node_id", node_id)]))
    return "\n".join(lines) + "\n"


def _render_entry(entry: dict, extra: list[tuple] | None = None) -> list[str]:
    """Exposition lines for one snapshot entry (shared by the local and
    federated exporters so the two can never drift)."""
    name, keys = entry["name"], tuple(entry["tag_keys"])
    lines: list[str] = []
    if entry["type"] == "histogram":
        bounds = entry["boundaries"]
        sums = {tuple(k): v for k, v in entry.get("sums", [])}
        counts = {tuple(k): v for k, v in entry.get("counts", [])}
        for key, bk in entry.get("buckets", []):
            key = tuple(key)
            base = _labels(keys, key, extra)
            cum = 0
            for bound, n in zip(bounds, bk):
                cum += n
                le = (extra or []) + [("le", _fmt_float(bound))]
                lines.append(f"{name}_bucket{_labels(keys, key, le)} {cum}")
            cum += bk[-1]
            inf = (extra or []) + [("le", "+Inf")]
            lines.append(f"{name}_bucket{_labels(keys, key, inf)} {cum}")
            lines.append(f"{name}_sum{base} {sums.get(key, 0.0)}")
            lines.append(f"{name}_count{base} {int(counts.get(key, 0))}")
    else:
        for key, v in entry.get("points", []):
            lines.append(f"{name}{_labels(keys, tuple(key), extra)} {v}")
    return lines


def _fmt_float(v: float) -> str:
    """Canonical float formatting for exposition values (`le` bounds):
    always the shortest repr of the *float*, so integer boundaries render
    identically to their float equivalents (5 -> "5.0", matching 5.0)."""
    return repr(float(v))


def _escape_label(value: str) -> str:
    """The one escaping/validation point for every label value — tag values
    and synthetic pairs (le, node_id) all pass through here."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(keys: tuple, values: tuple,
            extra: list[tuple] | None = None) -> str:
    pairs = [(k, v) for k, v in zip(keys, values) if v != ""]
    pairs.extend(extra or ())
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
    return "{" + inner + "}"


_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _registry
