"""Deterministic, seeded fault injection at the port's device boundaries
(port of the JAX package's faults.py).

Named sites a test or a drill can arm without touching the code path:

    device.extend          extend host entries            (ops/extend.py)
    device.extend.output   an extend's result square      (ops/extend.py)
    device.repair          repair device entries          (ops/repair.py)
    device.repair.output   a repair's result square       (ops/repair.py)
    transfer.chunk         one chunk of a chunked H2D/D2H (ops/transfers.py)
    cache.demote           a page's host copy on demotion (node/eds_cache.py)
    cache.faultin          a page's host copy before its upload (node/eds_cache.py)
    store.write            a put, before its file lands        (store/__init__.py)
    store.read             a page record's bytes, before its CRC check
    store.fsync            the data fsync of a put or probe
    store.rename           the rename of a put's temp file
    store.dirsync          the store directory's fsync
    store.unlink           a temp file's or an evicted height's unlink

Fault kinds, as in the JAX package:

    delay        sleep ``delay_s`` then continue
    error        raise TransportFault
    reset        raise ConnectionResetFault (also a ConnectionResetError)
    corrupt      the site applies the returned corruptor to its bytes
    bitflip      the site applies the returned flipper: ONE bit at a seeded
                 byte position (the silent-data-corruption model)
    unavailable  raise DeviceUnavailable
    enospc       raise DiskFault with errno ENOSPC
    short_write  the site applies the returned truncator and treats the
                 write as failed
    fsync_fail   raise DiskFault with errno EIO

``with faults.inject(rule(...), seed=N):`` pushes a FaultInjector onto a
process-global stack and pops it on exit. Every decision draws from the
injector's own seeded ``random.Random`` under a lock, in the same order and
with the same ranges as the JAX package's, so one rule and one seed strike
the same byte in both packages. With no injector armed, ``fire`` is one
empty-list check.

The flipper works on bytes, numpy arrays and torch tensors. A tensor is
cloned and flipped on its own device: a CUDA tensor never travels to the
host for it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import errno
import fnmatch
import random
import threading
import time


class FaultError(Exception):
    """Base class for every injected fault."""


class TransportFault(FaultError):
    """Injected transport-layer error."""


class ConnectionResetFault(TransportFault, ConnectionResetError):
    """Injected mid-request connection reset (also an OSError)."""


class DeviceUnavailable(FaultError):
    """Injected device or backend unavailability."""


class DiskFault(FaultError, OSError):
    """Injected OS or disk failure, carrying a real errno."""


KINDS = ("delay", "error", "reset", "corrupt", "bitflip", "unavailable",
         "enospc", "short_write", "fsync_fail")


@dataclasses.dataclass
class FaultRule:
    """One armed fault: where it strikes, what it does, how often.

    ``site`` is glob-matched. ``where`` also requires the substring in one
    of the site's context values. ``after`` skips the first N matching
    hits; ``times`` stops after N strikes; ``probability`` gates each
    strike on a draw from the injector's seeded rng. ``phase`` (glob on the
    injector's phase label) and ``window`` ((start_s, end_s) after arming)
    make the rule dormant outside them: it neither fires nor counts hits."""

    site: str
    kind: str
    probability: float = 1.0
    times: int | None = None
    after: int = 0
    delay_s: float = 0.01
    where: str | None = None
    phase: str | None = None
    window: tuple[float, float] | None = None
    # bookkeeping (mutated by the injector)
    seen: int = 0
    fired: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")


def rule(site: str, kind: str, **kw) -> FaultRule:
    """``rule("transfer.chunk", "bitflip", times=1)``."""
    return FaultRule(site=site, kind=kind, **kw)


def _corruptor(pos_draw: int):
    def corrupt(payload: bytes) -> bytes:
        if not payload:
            return payload
        out = bytearray(payload)
        out[pos_draw % len(out)] ^= 0xFF
        return bytes(out)

    return corrupt


def _bitflipper(pos_draw: int, bit_draw: int):
    """One-bit flipper over bytes, numpy arrays and torch tensors.

    Byte ``pos_draw % size`` of the flat byte view gets bit
    ``bit_draw % 8`` flipped, in a copy. A torch tensor is cloned and
    flipped on its own device (one indexed XOR, no host copy); anything
    else goes through ``np.asarray``, as in the JAX package."""
    mask = 1 << (bit_draw % 8)

    def flip(payload):
        if payload is None:
            return payload
        if isinstance(payload, (bytes, bytearray)):
            if not payload:
                return bytes(payload)
            out = bytearray(payload)
            out[pos_draw % len(out)] ^= mask
            return bytes(out)
        import torch  # lazy: keep the module stdlib-importable

        if isinstance(payload, torch.Tensor):
            out = payload.clone(memory_format=torch.contiguous_format)
            flat = out.view(-1).view(torch.uint8)
            if flat.numel():
                i = pos_draw % flat.numel()
                flat[i:i + 1].bitwise_xor_(mask)
            return out
        import numpy as np

        arr = np.array(np.asarray(payload), copy=True)
        flat = arr.reshape(-1).view(np.uint8)
        if flat.size:
            flat[pos_draw % flat.size] ^= np.uint8(mask)
        return arr

    return flip


def _truncator(cut_draw: int):
    """Seeded short-write model: only a prefix of the bytes survives, and
    the site must treat the write as failed (``short_write`` attribute)."""

    def truncate(payload: bytes) -> bytes:
        if not payload:
            return payload
        return bytes(payload[: cut_draw % len(payload)])

    truncate.short_write = True
    return truncate


class FaultInjector:
    """Seeded decision engine over a set of FaultRules.

    ``schedule`` records every strike as ``(seq, site, kind)``, ``seq``
    the global fire() ordinal; ``site_timeline`` as (phase, site, kind,
    the rule's own hit ordinal)."""

    def __init__(self, rules, seed: int = 0):
        self.rules = list(rules)
        self.seed = seed
        self.rng = random.Random(seed)
        self.schedule: list[tuple[int, str, str]] = []
        self.site_timeline: list[tuple[str | None, str, str, int]] = []
        self._phase: str | None = None
        self._armed_at = time.monotonic()
        self._seq = 0
        self._lock = threading.RLock()

    def set_phase(self, phase: str | None) -> None:
        with self._lock:
            self._phase = phase

    @property
    def phase(self) -> str | None:
        with self._lock:
            return self._phase

    def on_fire(self, site: str, **ctx):
        """Consult the rules for one boundary crossing. Returns a payload
        corruptor (or None); raises or sleeps per the struck rules.
        Decisions happen under the lock, sleeps outside it."""
        corrupt = None
        actions: list[FaultRule] = []
        with self._lock:
            self._seq += 1
            seq = self._seq
            elapsed = time.monotonic() - self._armed_at
            for r in self.rules:
                if not fnmatch.fnmatch(site, r.site):
                    continue
                if r.phase is not None and (
                    self._phase is None or not fnmatch.fnmatch(self._phase, r.phase)
                ):
                    continue
                if r.window is not None and not (r.window[0] <= elapsed < r.window[1]):
                    continue
                if r.where is not None and not any(r.where in str(v) for v in ctx.values()):
                    continue
                r.seen += 1
                if r.seen <= r.after:
                    continue
                if r.times is not None and r.fired >= r.times:
                    continue
                if r.probability < 1.0 and self.rng.random() >= r.probability:
                    continue
                r.fired += 1
                self.schedule.append((seq, site, r.kind))
                self.site_timeline.append((self._phase, site, r.kind, r.seen))
                if r.kind == "corrupt":
                    corrupt = _corruptor(self.rng.randrange(1 << 16))
                elif r.kind == "bitflip":
                    corrupt = _bitflipper(self.rng.randrange(1 << 24), self.rng.randrange(8))
                elif r.kind == "short_write":
                    corrupt = _truncator(self.rng.randrange(1 << 16))
                else:
                    actions.append(r)
        for r in actions:
            if r.kind == "delay":
                time.sleep(r.delay_s)
            elif r.kind == "error":
                raise TransportFault(f"injected transport error at {site}")
            elif r.kind == "reset":
                raise ConnectionResetFault(f"injected connection reset at {site}")
            elif r.kind == "unavailable":
                raise DeviceUnavailable(f"injected unavailability at {site}")
            elif r.kind == "enospc":
                raise DiskFault(errno.ENOSPC, f"injected ENOSPC at {site}")
            elif r.kind == "fsync_fail":
                raise DiskFault(errno.EIO, f"injected fsync failure at {site}")
        return corrupt


# process-global injector stack: the innermost ``with`` wins; global so that
# every thread sees the injector a test armed
_stack: list[FaultInjector] = []
_stack_lock = threading.Lock()


def active() -> FaultInjector | None:
    return _stack[-1] if _stack else None


@contextlib.contextmanager
def inject(*rules: FaultRule, seed: int = 0, injector: FaultInjector | None = None):
    """Arm an injector for the dynamic extent of the ``with`` block."""
    inj = injector if injector is not None else FaultInjector(rules, seed=seed)
    with _stack_lock:
        _stack.append(inj)
    try:
        yield inj
    finally:
        with _stack_lock:
            _stack.remove(inj)


def fire(site: str, **ctx):
    """Site hook: None unless an injector is armed. Returns a corruptor,
    flipper or truncator when such a rule strikes; raises, or sleeps, for
    the other kinds."""
    inj = active()
    if inj is None:
        return None
    return inj.on_fire(site, **ctx)
