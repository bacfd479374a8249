"""Telemetry: counters, gauges and histogram timers (port of the JAX
package's telemetry.py, as far as the port's transfers, integrity audit,
repair entries and EDS caches call it).

Reference semantics: Cosmos SDK telemetry timers and counters on the
proposal paths (app/prepare_proposal.go:23, app/process_proposal.go:25,31).
Timings are fixed-bucket histograms: a key stores len(BUCKETS) + 1 integers
whatever the traffic, and quantiles are read by linear interpolation inside
the bucket the rank falls in (PromQL's histogram_quantile).

The port's counters are its own process-global registry (``metrics``); the
Prometheus text export of the JAX package has no caller in the port yet.
"""

from __future__ import annotations

import bisect
import collections
import threading
import time

# bucket bounds in seconds, 1-2.5-5 per decade from 100 µs to 60 s
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Histogram:
    """Fixed-bucket histogram: len(bounds) + 1 integer cells, sum and count."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds=DEFAULT_BUCKETS):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # last cell = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        # le is an inclusive upper bound: the first bound >= value
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.count += 1

    def quantile(self, q: float) -> float:
        """Quantile estimate by linear interpolation within its bucket."""
        if self.count == 0:
            return float("nan")
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
                return lo + (hi - lo) * ((rank - cum) / c)
            cum += c
        return self.bounds[-1]


class Registry:
    def __init__(self, buckets=DEFAULT_BUCKETS):
        self._lock = threading.Lock()
        self._buckets = tuple(buckets)
        self.counters: dict[str, float] = collections.defaultdict(float)
        self.gauges: dict[str, float] = {}
        self.timings: dict[str, Histogram] = {}
        # the last (trace id, value) exemplar of a histogram key
        self._exemplars: dict[str, tuple[str, float]] = {}

    def incr_counter(self, name: str, value: float = 1.0, **labels) -> None:
        key = _key(name, labels)
        with self._lock:
            self.counters[key] += value

    def get_counter(self, name: str, **labels) -> float:
        """A counter's value (0.0 if never incremented)."""
        with self._lock:
            return self.counters.get(_key(name, labels), 0.0)

    def set_gauge(self, name: str, value: float, **labels) -> None:
        key = _key(name, labels)
        with self._lock:
            self.gauges[key] = value

    def get_gauge(self, name: str, **labels) -> float | None:
        """A gauge's value (None if never set)."""
        with self._lock:
            return self.gauges.get(_key(name, labels))

    def observe(self, name: str, value: float, exemplar: str | None = None,
                **labels) -> None:
        """One histogram observation (seconds). ``exemplar`` attaches a
        trace id to the observation (the last one per key is kept), linking
        the metric to a concrete span."""
        key = _key(name, labels)
        with self._lock:
            hist = self.timings.get(key)
            if hist is None:
                hist = self.timings[key] = Histogram(self._buckets)
            hist.observe(value)
            if exemplar is not None:
                self._exemplars[key] = (exemplar, value)

    def get_exemplar(self, name: str, **labels) -> tuple[str, float] | None:
        """The last (trace_id, value) exemplar of a histogram key."""
        with self._lock:
            return self._exemplars.get(_key(name, labels))

    def measure_since(self, name: str, start: float, **labels) -> None:
        self.observe(name, time.perf_counter() - start, **labels)

    def measure(self, name: str, **labels) -> "_Timer":
        """Context manager: one observation of the block's wall time."""
        return _Timer(self, name, labels)

    def get_timing(self, name: str, **labels) -> Histogram | None:
        """The histogram behind a timing key."""
        with self._lock:
            return self.timings.get(_key(name, labels))

    def timing_quantile(self, name: str, q: float, **labels) -> float:
        hist = self.get_timing(name, **labels)
        return float("nan") if hist is None else hist.quantile(q)

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.timings.clear()
            self._exemplars.clear()


class _Timer:
    def __init__(self, registry: Registry, name: str, labels: dict):
        self.registry = registry
        self.name = name
        self.labels = labels

    def __enter__(self) -> "_Timer":
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.registry.measure_since(self.name, self.start, **self.labels)
        return False


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


# the process-global registry (the SDK telemetry singleton's counterpart)
metrics = Registry()
