"""Telemetry: counters, gauges and histogram timers with a Prometheus text
export (port of the JAX package's telemetry.py).

Reference semantics: Cosmos SDK telemetry timers and counters on the
proposal paths (app/prepare_proposal.go:23, app/process_proposal.go:25,31).
Timings are fixed-bucket histograms: a key stores len(BUCKETS) + 1 integers
whatever the traffic, and quantiles are read by linear interpolation inside
the bucket the rank falls in (PromQL's histogram_quantile).

The port's counters are its own process-global registry (``metrics``). The
exposition follows the Prometheus text format v0.0.4: ``# HELP``/``# TYPE``
lines, counters with the ``_total`` suffix, escaped label values, and
histograms as ``_bucket``/``_sum``/``_count`` series; the RPC server's
``/metrics`` serves it.
"""

from __future__ import annotations

import bisect
import collections
import os
import threading
import time

# bucket bounds in seconds, 1-2.5-5 per decade from 100 µs to 60 s
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

try:
    _PAGE_SIZE = os.sysconf("SC_PAGE_SIZE")
except (ValueError, OSError, AttributeError):
    _PAGE_SIZE = 4096


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
        # rendered key -> (metric name, sorted (label, value) pairs): the
        # exposition splits name and labels apart again
        self._families: dict[str, tuple[str, tuple[tuple[str, str], ...]]] = {}
        # the last (trace id, value) exemplar of a histogram key
        self._exemplars: dict[str, tuple[str, float]] = {}

    def _register(self, key: str, name: str, labels: dict) -> None:
        if key not in self._families:
            self._families[key] = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))

    def incr_counter(self, name: str, value: float = 1.0, **labels) -> None:
        key = _key(name, labels)
        with self._lock:
            self._register(key, name, labels)
            self.counters[key] += value

    def get_counter(self, name: str, **labels) -> float:
        """A counter's value (0.0 if never incremented)."""
        with self._lock:
            return self.counters.get(_key(name, labels), 0.0)

    def set_gauge(self, name: str, value: float, **labels) -> None:
        key = _key(name, labels)
        with self._lock:
            self._register(key, name, labels)
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
            self._register(key, name, labels)
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

    def histogram_family(self, name: str) -> list[tuple[dict, Histogram]]:
        """Every (labels, histogram) of one timing family: the SLO engine
        merges them bucketwise (the bounds are registry-wide)."""
        with self._lock:
            out = []
            for key, hist in self.timings.items():
                fam, labels = self._family(key)
                if fam == name:
                    out.append((dict(labels), hist))
            return out

    def prometheus_text(self) -> str:
        """The registry in the Prometheus exposition format v0.0.4."""
        lines: list[str] = []
        with self._lock:
            self._render_simple(lines, self.counters, "counter")
            self._render_simple(lines, self.gauges, "gauge")
            self._render_histograms(lines)
        return "\n".join(lines) + "\n"

    def _family(self, key: str) -> tuple[str, tuple[tuple[str, str], ...]]:
        fam = self._families.get(key)
        if fam is None:  # a direct dict write: the bare name, no labels
            fam = (key.split("{", 1)[0], ())
        return fam

    def _render_simple(self, lines: list[str], table: dict, mtype: str) -> None:
        by_name: dict[str, list[tuple[tuple[tuple[str, str], ...], float]]] = {}
        for key, value in table.items():
            name, labels = self._family(key)
            if mtype == "counter" and not name.endswith("_total"):
                name += "_total"
            by_name.setdefault(name, []).append((labels, value))
        for name in sorted(by_name):
            lines.append(f"# HELP {name} {mtype} {name}")
            lines.append(f"# TYPE {name} {mtype}")
            for labels, value in sorted(by_name[name]):
                lines.append(f"{name}{_label_str(labels)} {value}")

    def _render_histograms(self, lines: list[str]) -> None:
        by_name: dict[str, list[tuple[tuple[tuple[str, str], ...], Histogram]]] = {}
        for key, hist in self.timings.items():
            name, labels = self._family(key)
            by_name.setdefault(f"{name}_seconds", []).append((labels, hist))
        for name in sorted(by_name):
            lines.append(f"# HELP {name} histogram {name}")
            lines.append(f"# TYPE {name} histogram")
            for labels, hist in sorted(by_name[name], key=lambda e: e[0]):
                cum = 0
                for bound, count in zip(hist.bounds, hist.counts):
                    cum += count
                    le = (("le", _fmt_bound(bound)),)
                    lines.append(f"{name}_bucket{_label_str(labels + le)} {cum}")
                lines.append(f"{name}_bucket{_label_str(labels + (('le', '+Inf'),))} "
                             f"{hist.count}")
                lines.append(f"{name}_sum{_label_str(labels)} {hist.sum}")
                lines.append(f"{name}_count{_label_str(labels)} {hist.count}")
                ex = self._exemplars.get(_key(name[: -len("_seconds")], dict(labels)))
                if ex is not None:
                    # an exemplar rides as its own comment line, which the
                    # v0.0.4 format allows and scrapers ignore
                    lines.append(f"# EXEMPLAR {name}{_label_str(labels)} "
                                 f"trace_id={ex[0]} value={ex[1]}")

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.timings.clear()
            self._families.clear()
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


def _escape(value: str) -> str:
    """Prometheus label-value escaping: backslash, quote, newline."""
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
    return f"{{{inner}}}"


def _fmt_bound(bound: float) -> str:
    """A bucket bound as a plain decimal, without float noise."""
    text = f"{bound:.10f}".rstrip("0").rstrip(".")
    return text if text else "0"


# the process-global registry (the SDK telemetry singleton's counterpart)
metrics = Registry()


def refresh_process_gauges(registry: Registry | None = None) -> None:
    """Refresh the host-resource gauges from /proc/self
    (``process_rss_bytes``, ``process_open_fds``, ``process_threads``),
    right before a render: nobody scraping costs nothing. A host without
    procfs reads all three as 0."""
    reg = registry if registry is not None else metrics
    rss = threads = fds = 0.0
    try:
        with open("/proc/self/statm") as f:
            rss = float(f.read().split()[1]) * _PAGE_SIZE  # resident pages
        with open("/proc/self/stat") as f:
            # field 20 (1-based), counted after the parenthesized comm,
            # which may itself hold spaces
            threads = float(f.read().rsplit(")", 1)[1].split()[17])
        fds = float(len(os.listdir("/proc/self/fd")))
    except OSError:
        pass
    reg.set_gauge("process_rss_bytes", rss)
    reg.set_gauge("process_threads", threads)
    reg.set_gauge("process_open_fds", fds)
