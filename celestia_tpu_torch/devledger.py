"""Device runtime ledger (port of the JAX package's devledger.py): who
built what for the card, who owns every device byte, and how busy the
device lane is. Three planes in one leaf-locked object:

1. **Build watchdog.** The port has no jitted entries; its compile surface
   is its cached builders: the nvcc build of the kernel library
   (``ops/_cuda``), the native runtime's g++ build (``native``), the per-k
   programs and matrices of ``ops/rs`` and the XOR schedule's per-k compile
   (``ops/xor_schedule``). Each is wrapped with ``instrument_builder(entry)``
   placed BETWEEN its cache and its body (a ``functools.lru_cache``; for
   the two libraries, the module's library global under its lock), so the
   watchdog sees exactly the cache misses: one call per distinct key. The body is
   the build, timed into ``device_build_total{entry}`` and the
   ``device_build_ms`` histogram (observed in seconds, with a trace-id
   exemplar) under a ``device.build`` span; a builder that finds its
   product already built on disk counts ``device_build_cache_hit_total``
   (``note_cache_hit``). After ``end_warmup()``, a new key on a known entry
   is a **retrace**: ``device_retrace_total{entry}``, a zero-duration
   ``device.retrace`` span, and ``RetraceError`` under strict mode
   (``strict_retraces()``, ``CELESTIA_STRICT_RETRACE=1``), raised before the
   build so the cache never adopts the key. A key the lru evicted and that
   is built again is a build, not a retrace.

2. **Device-byte ledger.** Every holder of device memory (the paged and
   resident EDS caches, the blob arena, the block pipeline's in-flight
   blocks) registers an owner with a callback giving its current bytes.
   Bound methods are held weakly (a collected owner drops out), plain
   callables strongly until ``unregister_owner``. ``publish()`` exports
   ``device_ledger_bytes{owner}`` and reconciles the attributed total
   against the bytes the CUDA caching allocator holds for live tensors
   (``torch.cuda.memory_allocated`` summed over the initialised cards):
   the remainder is ``device_ledger_unattributed_bytes``, which must stay
   flat in steady state.

3. **Busy timeline.** The dispatcher owns the device lane, so its per-job
   exec durations fold into a windowed ``device_busy_ratio``.

Where the port differs from the JAX package: the watchdog's series are
named ``device_*`` (the JAX package's ``xla_*``), the build is the
builder's body (the JAX package times its compiled callable's first call),
and the live bytes come from the CUDA allocator, so they read 0 on the CPU
(the JAX package counts every live array, CPU arrays included). As in the
JAX package, ``instrument_builder``'s ``key_extra`` appends ambient state
the arguments do not carry: the row-sharded builders of ``ops/extend``
pass the active mesh's shape, so a flip of the mesh is a new key at the
same k. Reading the live bytes never initialises CUDA.

Lock discipline: ``_lock`` is a leaf. It is never held across an owner
callback, a metric write, a span or device work; ``snapshot()`` copies the
owner list under the lock and calls every callback unlocked, since owner
callbacks take their subsystem's own locks.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import platform
import threading
import time
import weakref

import torch

from celestia_tpu_torch import telemetry, tracing


class RetraceError(RuntimeError):
    """A build of a known entry under a new key after warm-up, in strict
    mode: geometry churn that must never reach steady state."""


def _shape_key(args: tuple, kwargs: dict) -> str:
    """A builder's arguments are its key: every instrumented builder is
    keyed on hashable static configuration by its lru_cache."""
    parts = [repr(a) for a in args]
    parts += [f"{k}={v!r}" for k, v in sorted(kwargs.items())]
    return f"({', '.join(parts)})"


def _live_device_bytes() -> int:
    """Bytes the CUDA caching allocator holds for live tensors, summed over
    the cards; 0 while CUDA is not initialised (on the CPU, or before the
    first launch), so reading it never initialises CUDA."""
    if not torch.cuda.is_initialized():
        return 0
    return sum(int(torch.cuda.memory_allocated(d))
               for d in range(torch.cuda.device_count()))


class DeviceLedger:
    """Process-wide device runtime ledger; see the module docstring. The
    three planes share one leaf lock, held only around plain-data
    mutation."""

    DEFAULT_BUSY_WINDOW_S = 5.0

    def __init__(self, busy_window_s: float = DEFAULT_BUSY_WINDOW_S):
        self._lock = threading.Lock()
        # -- watchdog state --
        self._seen: dict[str, set] = {}
        self._builds: collections.Counter = collections.Counter()
        self._retraces: list[dict] = []
        self._warm = False
        self._strict = os.environ.get("CELESTIA_STRICT_RETRACE", "") not in ("", "0")
        self._tls = threading.local()
        # -- byte-ledger state --
        self._owners: list[tuple[str, object]] = []  # (name, weak ref)
        # -- busy-timeline state --
        self.busy_window_s = float(busy_window_s)
        self._busy: collections.deque = collections.deque()  # (t_end, dur)

    # -- build watchdog -------------------------------------------------- #

    def instrument_builder(self, entry: str, key_extra=None):
        """Decorator for a cached builder, placed BETWEEN its cache and its
        body, so it fires once per distinct key. The key is the builder's
        arguments, and ``key_extra()``'s value when given: ambient state the
        arguments do not carry (the active mesh's shape), so a flip of it
        reads as a new key, and as a retrace after warm-up."""

        def deco(builder):
            @functools.wraps(builder)
            def wrapped(*args, **kwargs):
                key = _shape_key(args, kwargs)
                if key_extra is not None:
                    key = f"{key}|{key_extra()!r}"
                self.note_build(entry, key)  # strict mode raises before the build
                return self._timed_build(entry, key, builder, args, kwargs)

            return wrapped

        return deco

    def note_build(self, entry: str, key: str) -> bool:
        """Record one builder call for (entry, key); returns (and in strict
        mode raises on) whether it was a retrace: the entry was known, the
        key is new and warm-up is over."""
        with self._lock:
            seen = self._seen.setdefault(entry, set())
            known = len(seen) > 0
            fresh = key not in seen
            seen.add(key)
            retrace = self._warm and known and fresh
            strict = self._strict
            if retrace:
                self._retraces.append({"entry": entry, "key": key, "t": time.time()})
        if retrace:
            telemetry.metrics.incr_counter("device_retrace_total", entry=entry)
            now = time.perf_counter()
            # a zero-duration span: the flight recorder shows when the
            # geometry churned, among the requests around it
            tracing.emit("device.retrace", now, now, entry=entry, key=key)
            if strict:
                raise RetraceError(
                    f"steady-state retrace on entry {entry!r}: new key {key} after "
                    f"warm-up (geometry must be stable in steady state)")
        return retrace

    def _timed_build(self, entry: str, key: str, builder, args, kwargs):
        self._tls.entry = entry
        t0 = time.perf_counter()
        sp = tracing.span("device.build", entry=entry, key=key)
        try:
            with sp:
                out = builder(*args, **kwargs)
        finally:
            self._tls.entry = None
        wall = time.perf_counter() - t0
        with self._lock:
            self._builds[entry] += 1
        telemetry.metrics.incr_counter("device_build_total", entry=entry)
        # an ms-named family observed in seconds, as every stage histogram
        telemetry.metrics.observe("device_build_ms", wall,
                                  exemplar=getattr(sp, "trace_id", None), entry=entry)
        return out

    def note_cache_hit(self) -> None:
        """Count a build-cache hit for the entry building on this thread: a
        builder calls it when its product was already on disk."""
        entry = getattr(self._tls, "entry", None)
        if entry:
            telemetry.metrics.incr_counter("device_build_cache_hit_total", entry=entry)

    def begin_warmup(self) -> None:
        """Re-enter warm-up: retraces stop being judged and the
        steady-state event list resets. Seen keys are kept, as the builders'
        caches keep their products."""
        with self._lock:
            self._warm = False
            self._retraces.clear()

    def end_warmup(self) -> None:
        """From now on a new key on a known entry is a retrace."""
        with self._lock:
            self._warm = True

    @property
    def warm(self) -> bool:
        with self._lock:
            return self._warm

    @property
    def strict(self) -> bool:
        with self._lock:
            return self._strict

    @contextlib.contextmanager
    def strict_retraces(self, value: bool = True):
        """Scoped strict mode: retraces raise RetraceError."""
        with self._lock:
            old, self._strict = self._strict, bool(value)
        try:
            yield self
        finally:
            with self._lock:
                self._strict = old

    def retraces(self) -> list[dict]:
        """Steady-state retrace events since the last begin_warmup()."""
        with self._lock:
            return list(self._retraces)

    def retrace_count(self) -> int:
        with self._lock:
            return len(self._retraces)

    def reset_watchdog(self) -> None:
        """Forget every entry and key and leave warm-up (tests)."""
        with self._lock:
            self._seen.clear()
            self._builds.clear()
            self._retraces.clear()
            self._warm = False

    # -- device-byte ledger ---------------------------------------------- #

    def register_owner(self, name: str, fn) -> str:
        """Register a holder of device memory: ``fn() -> int`` gives its
        current device bytes. Bound methods are held weakly, plain callables
        strongly until ``unregister_owner(name)``. Registrations under one
        name sum into one series."""
        try:
            ref = weakref.WeakMethod(fn)
        except TypeError:
            ref = (lambda f=fn: f)  # a strong holder shaped like a weak ref
        with self._lock:
            self._owners.append((name, ref))
        return name

    def unregister_owner(self, name: str) -> int:
        """Drop every owner registered under ``name``; returns how many."""
        with self._lock:
            before = len(self._owners)
            self._owners = [o for o in self._owners if o[0] != name]
            return before - len(self._owners)

    def owner_names(self) -> list[str]:
        with self._lock:
            return sorted({name for name, _ in self._owners})

    def snapshot(self) -> dict:
        """One reconciliation pass: per-owner bytes (callbacks run
        unlocked), the live device bytes, and the unattributed remainder."""
        with self._lock:
            owners = list(self._owners)
        per: dict[str, int] = {}
        dead: list[tuple] = []
        for name, ref in owners:
            fn = ref()
            if fn is None:
                dead.append((name, ref))
                continue
            try:
                nbytes = max(0, int(fn()))
            except Exception:  # noqa: BLE001 — one broken owner must not take the audit down
                nbytes = 0
            per[name] = per.get(name, 0) + nbytes
        if dead:
            with self._lock:
                self._owners = [o for o in self._owners if o not in dead]
        live = _live_device_bytes()
        attributed = sum(per.values())
        return {
            "owners": per,
            "live_bytes": live,
            "attributed_bytes": attributed,
            # cached constants and workspaces keep this above 0: the
            # contract is that it stays flat in steady state
            "unattributed_bytes": max(0, live - attributed),
        }

    # -- busy timeline ---------------------------------------------------- #

    def note_busy(self, seconds: float, now: float | None = None) -> None:
        """Fold one device-lane exec duration into the busy window."""
        end = time.monotonic() if now is None else now
        with self._lock:
            self._busy.append((end, max(0.0, float(seconds))))
            self._trim_busy_locked(end)

    def busy_ratio(self, now: float | None = None) -> float:
        """Fraction of the trailing window the device lane spent executing,
        clamped to 1.0 (several dispatchers can oversubscribe the clock)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._trim_busy_locked(now)
            total = sum(d for _t, d in self._busy)
        if self.busy_window_s <= 0:
            return 0.0
        return min(1.0, total / self.busy_window_s)

    def _trim_busy_locked(self, now: float) -> None:
        horizon = now - self.busy_window_s
        busy = self._busy
        while busy and busy[0][0] < horizon:
            busy.popleft()

    # -- export ----------------------------------------------------------- #

    def publish(self, registry=None) -> dict:
        """Export the gauges into ``registry`` (the process registry by
        default): ``device_ledger_bytes{owner}``,
        ``device_ledger_unattributed_bytes``, ``device_ledger_live_bytes``,
        ``device_busy_ratio``. Returns the snapshot it published."""
        reg = registry if registry is not None else telemetry.metrics
        snap = self.snapshot()
        for name, nbytes in snap["owners"].items():
            reg.set_gauge("device_ledger_bytes", float(nbytes), owner=name)
        reg.set_gauge("device_ledger_unattributed_bytes", float(snap["unattributed_bytes"]))
        reg.set_gauge("device_ledger_live_bytes", float(snap["live_bytes"]))
        reg.set_gauge("device_busy_ratio", self.busy_ratio())
        return snap

    def debug_doc(self) -> dict:
        """The watchdog's state, the byte ledger, the busy ratio and the
        runtime's provenance, as one document."""
        with self._lock:
            entries = {
                entry: {"keys": len(keys), "builds": int(self._builds.get(entry, 0))}
                for entry, keys in sorted(self._seen.items())
            }
            retraces = list(self._retraces[-32:])
            warm = self._warm
            strict = self._strict
        return {
            "compile": {
                "warm": warm,
                "strict": strict,
                "entries": entries,
                "retrace_count": len(retraces),
                "retraces": retraces,
            },
            "ledger": self.snapshot(),
            "busy_ratio": self.busy_ratio(),
            "provenance": runtime_provenance(),
        }


@functools.lru_cache(maxsize=1)
def _provenance() -> tuple:
    prov: dict = {
        "python": platform.python_version(),
        "machine": platform.machine(),
        "cpus": os.cpu_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    if torch.cuda.is_available():
        prov["backend"] = "gpu"
        prov["device_kind"] = torch.cuda.get_device_name(0)
        prov["n_devices"] = torch.cuda.device_count()
    else:
        prov["backend"] = "cpu"
        prov["n_devices"] = 0
    return tuple(sorted(prov.items()))


def runtime_provenance() -> dict:
    """The host's and runtime's identity (torch, CUDA, the card), computed
    once per process, for records that must be comparable across hosts."""
    return dict(_provenance())


# the process-wide ledger (the telemetry.metrics counterpart) and the
# module-level conveniences the wiring sites use
ledger = DeviceLedger()

instrument_builder = ledger.instrument_builder
note_cache_hit = ledger.note_cache_hit
note_busy = ledger.note_busy
register_owner = ledger.register_owner
unregister_owner = ledger.unregister_owner
begin_warmup = ledger.begin_warmup
end_warmup = ledger.end_warmup


def publish(registry=None) -> dict:
    return ledger.publish(registry)


def debug_doc() -> dict:
    return ledger.debug_doc()
