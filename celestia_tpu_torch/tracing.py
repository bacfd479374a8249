"""Span-based tracing for the port's block path (port of the JAX package's
tracing.py, the parts the extend entries, transfers and integrity audit
use).

A span covers each stage of an extend (``extend.device`` with its
``extend.stage`` and ``extend.rs_nmt`` children), every host<->device
transfer (``transfer.<site>``) and every integrity audit. Spans carry the
card that served them and the fault-site strikes that hit during them.

1. **Off means off.** Tracing is disabled by default, and the disabled
   path is one attribute check returning a shared no-op object.
2. **Explicit parenting.** A per-thread span stack, and ``parent=`` for a
   handoff between threads.
3. **Bounded memory.** Finished spans land in a fixed-capacity ring (the
   flight recorder); unbounded collection happens only inside
   ``record()``.

The cross-process trace context (``X-Trace-Context``: ``TraceContext``,
``extract``, ``mint``) binds an RPC request's span into its caller's trace,
and ``start_recording`` with ``chrome_trace`` exports every span as Chrome
trace-event JSON (``cli start --trace-out``).

Also here: stage sinks (per-request accumulators of stage durations that
the transfers feed with ``add_stage``, and ``merge_stages`` folds in from
the dispatcher's thread) and fenced device-time profiling
(``enable_profiling``: a 1-in-N sample of entry calls waits for the card
and emits a ``profile.fence`` span).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

from celestia_tpu_torch import faults

FLIGHT_CAPACITY = 256

# one anchor so span timestamps are monotonic yet near wall-clock time
_EPOCH_OFFSET = time.time() - time.perf_counter()

# ---------------------------------------------------------------------- #
# cross-process trace context
#
# W3C-traceparent-style header: ``00-<trace_id>-<span_id>-<flags>`` where
# trace_id is 32 lowercase hex (128-bit, minted once per request by the
# client, prober or gateway), span_id is a 16-hex WIRE span id, and flags
# is 2 hex. Local span ids are a per-process counter; the wire form
# prefixes the low 32 bits of the pid so ids from different processes never
# collide in a merged trace: ``pid8hex + local_id8hex``.

TRACE_HEADER = "X-Trace-Context"
TRACE_ID_HEADER = "X-Trace-Id"


class TraceContext:
    """Parsed ``X-Trace-Context``: the caller's trace id and wire span id."""

    __slots__ = ("trace_id", "span_id", "flags")

    def __init__(self, trace_id: str, span_id: str, flags: int = 1):
        self.trace_id = trace_id
        self.span_id = span_id
        self.flags = flags

    def header_value(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags:02x}"

    def __repr__(self) -> str:
        return f"TraceContext({self.header_value()!r})"


def mint_trace_id() -> str:
    """A fresh 128-bit trace id (lowercase hex)."""
    return os.urandom(16).hex()


def wire_span_id(span_or_id) -> str:
    """16-hex process-unique span id: the pid's low bits and the local id."""
    local = span_or_id.span_id if isinstance(span_or_id, Span) else span_or_id
    return f"{os.getpid() & 0xFFFFFFFF:08x}{(local or 0) & 0xFFFFFFFF:08x}"


def mint(trace_id: str | None = None) -> TraceContext:
    """An outbound context (client or prober side). The span id is a fresh
    wire id, so server spans have a well-formed remote parent even when
    the caller opens no local span."""
    return TraceContext(trace_id or mint_trace_id(), wire_span_id(_tracer.new_id()))


def header_value(trace_id: str, span_id: str, flags: int = 1) -> str:
    return f"00-{trace_id}-{span_id}-{flags:02x}"


def extract(raw: str | None) -> TraceContext | None:
    """Parse an inbound ``X-Trace-Context`` header. A malformed value is
    counted (``trace_context_invalid_total``) and ignored: a bad header
    never fails the request."""
    if raw is None:
        return None
    try:
        version, trace_id, span_id, flags = raw.strip().split("-")
        if (len(version) == 2 and len(trace_id) == 32 and len(span_id) == 16
                and len(flags) == 2 and int(trace_id, 16) != 0):
            int(version, 16)
            int(span_id, 16)
            return TraceContext(trace_id.lower(), span_id.lower(), int(flags, 16))
    except ValueError:
        pass
    from celestia_tpu_torch.telemetry import metrics

    metrics.incr_counter("trace_context_invalid_total")
    return None


class Span:
    """One timed operation. Context manager; ``set()`` attaches
    attributes; finished spans are records in the sinks."""

    __slots__ = ("name", "span_id", "parent_id", "tid", "start", "duration",
                 "attrs", "status", "trace_id", "_fault_mark")

    def __init__(self, name: str, span_id: int, parent_id: int | None,
                 attrs: dict, trace_id: str | None = None):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.tid = threading.get_ident()
        self.start = time.perf_counter()
        self.duration = 0.0
        self.attrs = attrs
        self.status = "ok"
        self.trace_id = trace_id
        self._fault_mark = _fault_mark()

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        _push(self)
        return self

    def __exit__(self, exc_type, exc, _tb) -> bool:
        self.duration = time.perf_counter() - self.start
        if exc_type is not None:
            self.status = "error"
            self.attrs.setdefault("error", exc_type.__name__)
        _capture_faults(self)
        _pop(self)
        _tracer.finish(self)
        return False

    def to_dict(self) -> dict:
        """The flight recorder's JSON shape."""
        d = {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "tid": self.tid,
            "ts_us": round((self.start + _EPOCH_OFFSET) * 1e6, 1),
            "dur_us": round(self.duration * 1e6, 1),
            "status": self.status,
        }
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
        if self.attrs:
            d["attrs"] = {k: _coerce(v) for k, v in self.attrs.items()}
        return d

    def to_event(self) -> dict:
        """One complete-duration Chrome trace event (``"ph": "X"``)."""
        args = {k: _coerce(v) for k, v in self.attrs.items()}
        args["span_id"] = self.span_id
        if self.parent_id is not None:
            args["parent_id"] = self.parent_id
        if self.status != "ok":
            args["status"] = self.status
        if self.trace_id is not None:
            # cross-process fields ride in args: the top-level event keys
            # are the Chrome format's
            args["trace_id"] = self.trace_id
            args["wire_span_id"] = wire_span_id(self)
        return {
            "name": self.name,
            "cat": self.name.split(".", 1)[0],
            "ph": "X",
            "ts": round((self.start + _EPOCH_OFFSET) * 1e6, 1),
            "dur": round(self.duration * 1e6, 1),
            "pid": os.getpid(),
            "tid": self.tid,
            "args": args,
        }


def _coerce(value):
    if isinstance(value, (int, float, str, bool)) or value is None:
        return value
    if isinstance(value, bytes):
        return value.hex()
    return str(value)


class _NoopSpan:
    """The shared disabled-path object: stateless, so one instance serves
    every call site and nesting depth."""

    __slots__ = ()
    span_id = None
    parent_id = None
    trace_id = None
    name = ""
    attrs: dict = {}

    def set(self, **_attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *_exc) -> bool:
        return False


_NOOP = _NoopSpan()


# fault-site correlation: a span records the injector strikes that fired
# during it (site and kind)


def _fault_mark() -> int:
    inj = faults.active()
    return len(inj.schedule) if inj is not None else 0


def _capture_faults(span: Span) -> None:
    inj = faults.active()
    if inj is None:
        return
    struck = inj.schedule[span._fault_mark:]
    if struck:
        span.attrs["fault_hits"] = len(struck)
        span.attrs["fault_sites"] = ",".join(f"{site}:{kind}" for _seq, site, kind in struck)


class Tracer:
    """Per-thread span stacks and the sinks: the flight ring and the
    active recordings."""

    def __init__(self, flight_capacity: int = FLIGHT_CAPACITY):
        self.enabled = False
        self._lock = threading.Lock()
        self._flight: collections.deque[Span] = collections.deque(maxlen=flight_capacity)
        self._recordings: list[Recording] = []
        self._next_id = 1
        self._local = threading.local()

    def new_id(self) -> int:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            return sid

    def finish(self, span: Span) -> None:
        with self._lock:
            self._flight.append(span)
            for rec in self._recordings:
                rec.spans.append(span)

    def flight(self) -> list[dict]:
        """The last finished spans, oldest first."""
        with self._lock:
            return [s.to_dict() for s in self._flight]

    def attach(self, rec: "Recording") -> None:
        with self._lock:
            self._recordings.append(rec)

    def detach(self, rec: "Recording") -> None:
        with self._lock:
            if rec in self._recordings:
                self._recordings.remove(rec)

    def reset(self) -> None:
        with self._lock:
            self._flight.clear()
            self._recordings.clear()
        self.enabled = False


_tracer = Tracer()


def _stack(create: bool = True):
    stack = getattr(_tracer._local, "stack", None)
    if stack is None and create:
        stack = _tracer._local.stack = []
    return stack


def _push(span: Span) -> None:
    _stack().append(span)


def _pop(span: Span) -> None:
    stack = _stack(create=False)
    if stack and stack[-1] is span:
        stack.pop()
    elif stack and span in stack:  # exited out of order
        stack.remove(span)


def enable(flight_capacity: int | None = None) -> None:
    """Turn span recording on (the flight recorder is live at once)."""
    if flight_capacity is not None and _tracer._flight.maxlen != flight_capacity:
        with _tracer._lock:
            _tracer._flight = collections.deque(_tracer._flight, maxlen=flight_capacity)
    _tracer.enabled = True


def disable() -> None:
    _tracer.enabled = False


def enabled() -> bool:
    return _tracer.enabled


def reset() -> None:
    """Drop all sinks and disable tracing and profiling."""
    _tracer.reset()
    disable_profiling()
    sinks = getattr(_stage_local, "sinks", None)
    if sinks:
        sinks.clear()


def span(name: str, parent: Span | None | object = ..., **attrs):
    """Open a span; a shared inert object when tracing is off. The parent
    is the calling thread's innermost open span unless ``parent=`` is
    given (None makes a root span)."""
    if not _tracer.enabled:
        return _NOOP
    if parent is ...:
        stack = _stack(create=False)
        parent = stack[-1] if stack else None
    if isinstance(parent, Span):
        parent_id, trace_id = parent.span_id, parent.trace_id
    else:
        parent_id = trace_id = None
    return Span(name, _tracer.new_id(), parent_id, attrs, trace_id=trace_id)


def current() -> Span | None:
    """The calling thread's innermost open span, or None."""
    stack = _stack(create=False)
    return stack[-1] if stack else None


def emit(name: str, start: float, end: float | None = None,
         trace_id: str | None = None, **attrs) -> None:
    """Record an already-timed operation (``start``/``end`` perf_counter
    readings) as a finished span, a child of the innermost open span. The
    transfers reuse their counter timing this way, so the span and the
    ``transfer_ms`` counter cannot disagree."""
    if not _tracer.enabled:
        return
    stack = _stack(create=False)
    parent = stack[-1] if stack else None
    if trace_id is None and parent is not None:
        trace_id = parent.trace_id
    sp = Span(name, _tracer.new_id(), parent.span_id if parent is not None else None,
              attrs, trace_id=trace_id)
    sp.start = start
    sp.duration = (end if end is not None else time.perf_counter()) - start
    _capture_faults(sp)
    _tracer.finish(sp)


def flight() -> list[dict]:
    """The flight recorder's contents, oldest first."""
    return _tracer.flight()


def flight_capacity() -> int:
    return _tracer._flight.maxlen or 0


# ---------------------------------------------------------------------- #
# stage sinks: a per-thread accumulator of named stage durations for one
# request; ``stage()`` records self time (nested stages subtracted). Inert
# unless a sink was installed.

_stage_local = threading.local()


class StageSink:
    """Per-request stage accumulator; ``marked`` totals every second added."""

    __slots__ = ("data", "marked")

    def __init__(self):
        self.data: dict[str, float] = {}
        self.marked = 0.0

    def add(self, name: str, seconds: float) -> None:
        self.data[name] = self.data.get(name, 0.0) + seconds
        self.marked += seconds


class _StageTimer:
    __slots__ = ("sink", "name", "start", "mark")

    def __init__(self, sink: StageSink, name: str):
        self.sink = sink
        self.name = name

    def __enter__(self) -> "_StageTimer":
        self.mark = self.sink.marked
        self.start = time.perf_counter()
        return self

    def __exit__(self, *_exc) -> bool:
        elapsed = time.perf_counter() - self.start
        nested = self.sink.marked - self.mark
        self.sink.add(self.name, max(0.0, elapsed - nested))
        return False


def push_stage_sink() -> StageSink:
    """Install a fresh sink on the calling thread (stacked)."""
    stack = getattr(_stage_local, "sinks", None)
    if stack is None:
        stack = _stage_local.sinks = []
    sink = StageSink()
    stack.append(sink)
    return sink


def pop_stage_sink() -> StageSink | None:
    stack = getattr(_stage_local, "sinks", None)
    return stack.pop() if stack else None


def active_stage_sink() -> StageSink | None:
    stack = getattr(_stage_local, "sinks", None)
    return stack[-1] if stack else None


def stage(name: str):
    """Time a stage into the active sink; the shared no-op without one."""
    sink = active_stage_sink()
    return _NOOP if sink is None else _StageTimer(sink, name)


def add_stage(name: str, seconds: float) -> None:
    """Add pre-measured stage time to the active sink, if any."""
    sink = active_stage_sink()
    if sink is not None:
        sink.add(name, seconds)


def merge_stages(stages: dict | None) -> None:
    """Fold stages measured on another thread (the dispatcher) into the
    calling thread's sink: the request thread calls this after its job
    completes."""
    if not stages:
        return
    sink = active_stage_sink()
    if sink is not None:
        for name, seconds in stages.items():
            sink.add(name, seconds)


# ---------------------------------------------------------------------- #
# fenced device-time profiling: the entries return before the card is done,
# so a 1-in-N sample of them waits for their result and emits a
# ``profile.fence`` span. Off by default: a fence serialises the stream.

_prof_lock = threading.Lock()
_prof_every = 0  # 0 = profiling disabled
_prof_counter = 0


def enable_profiling(sample_every: int = 16) -> None:
    """Fence 1 in ``sample_every`` entry calls."""
    global _prof_every, _prof_counter
    with _prof_lock:
        _prof_every = max(1, int(sample_every))
        _prof_counter = 0


def disable_profiling() -> None:
    global _prof_every
    with _prof_lock:
        _prof_every = 0


def profiling_enabled() -> bool:
    return _prof_every > 0


def profile_sample() -> bool:
    """True when this call should be fenced (counter-sampled)."""
    if _prof_every == 0:
        return False
    global _prof_counter
    with _prof_lock:
        _prof_counter += 1
        return _prof_counter % _prof_every == 0


# ---------------------------------------------------------------------- #
# recordings and the Chrome trace-event export


class Recording:
    """Unbounded span collection for the extent of a ``with record()``, or
    from ``start_recording()`` to ``stop()`` (``cli start --trace-out``)."""

    def __init__(self):
        self.spans: list[Span] = []
        self._was_enabled = False
        self._active = False

    def start(self) -> "Recording":
        self._was_enabled = _tracer.enabled
        _tracer.attach(self)
        _tracer.enabled = True
        self._active = True
        return self

    def stop(self) -> "Recording":
        if self._active:
            _tracer.detach(self)
            _tracer.enabled = self._was_enabled
            self._active = False
        return self

    def __enter__(self) -> "Recording":
        return self.start()

    def __exit__(self, *_exc) -> bool:
        self.stop()
        return False

    def chrome(self) -> dict:
        return chrome_trace(self.spans)

    def write(self, path) -> str:
        """Write the Chrome trace-event JSON; returns the path."""
        with open(path, "w") as f:
            json.dump(self.chrome(), f)
        return str(path)


def record() -> Recording:
    """``with tracing.record() as rec:`` collects every span finished in
    the extent (all threads), restoring the prior enabled state on exit."""
    return Recording()


def start_recording() -> Recording:
    """The unscoped form, for a process-lifetime collection: the caller
    stops and writes it at shutdown."""
    return Recording().start()


def chrome_trace(spans) -> dict:
    """Spans -> a Chrome trace-event JSON object (Perfetto loads it)."""
    events: list[dict] = [{"name": "process_name", "ph": "M", "pid": os.getpid(), "tid": 0,
                           "args": {"name": "celestia_tpu_torch"}}]
    events.extend(s.to_event() for s in spans)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_chrome_trace(doc: dict) -> list[str]:
    """Schema check of an exported trace: the problems found (empty when
    valid)."""
    problems: list[str] = []
    if not isinstance(doc, dict):
        return ["top level is not an object"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M"):
            problems.append(f"event {i}: unexpected ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"event {i}: missing name")
        if not isinstance(ev.get("pid"), int):
            problems.append(f"event {i}: missing pid")
        if ph == "X":
            for field in ("ts", "dur"):
                if not isinstance(ev.get(field), (int, float)):
                    problems.append(f"event {i}: missing {field}")
            if isinstance(ev.get("dur"), (int, float)) and ev["dur"] < 0:
                problems.append(f"event {i}: negative dur")
            if not isinstance(ev.get("args"), dict):
                problems.append(f"event {i}: missing args")
    return problems
