"""The device dispatcher: one thread owns the device lane, fed by a bounded
admission queue (port of the JAX package's node/dispatch.py).

Request threads only parse and validate; every device job funnels through
the one dispatcher thread, which pulls from a bounded queue:

    shed        when the queue is full, ``submit`` fails at once with
                ``Shed(reason="queue_full")`` and a retry hint (a server maps
                it to 503 + Retry-After). The node never queues unboundedly.
    deadline    every admitted job carries an absolute deadline; the waiter
                gives up at it (``DeadlineExceeded``, 504) and the dispatcher
                skips jobs that expired while queued.
    drain       ``begin_drain()`` stops admission (``Shed("draining")``);
                ``drain()`` finishes queued and in-flight work, then stops the
                thread.

Two lanes feed the loop: the bounded external queue (admitted requests) and
an unbounded internal lane (``run_device``) for device sub-operations of
work the node already accepted (blob staging at CheckTx, sliced reads
through ``ops/transfers.register_device_executor``, the block pipeline's
legs). Internal jobs go first.

Continuous batching: external jobs submitted with a ``batch_key`` and a
``batch_exec`` are micro-batched. When the loop pops a batchable job it
gathers every queued job with the same key (lingering up to
``batch_window_s`` while the group is below ``max_batch``), runs ONE
``batch_exec([payload, ...])`` for the group and completes each waiter with
its own result. Admission, deadlines and abandoned waiters stay per job;
expired jobs leave the group before it runs and are counted once. A crowd
of DAS samples under the ``("sample",)`` key reaches the card as one
``Node.sample_batch_ragged`` call, one ragged gather per page geometry.

On the card: the dispatcher sets no stream of its own. Its jobs launch on
the dispatcher thread's current stream, the device's default stream, which
is the stream the request threads use too, so a job's work is ordered
after the work its submitter queued before it. Each exec's wall time feeds
the device ledger's busy timeline (``devledger.note_busy``).

Fault sites: ``dispatch.enqueue`` fires in the submitting thread before
admission; ``dispatch.run`` fires on the dispatcher thread once per device
dispatch (before each job body, or once for a whole micro-batch): a
``delay`` rule there stalls the single consumer, which is how a test drives
queue saturation and deadline expiry deterministically; ``dispatch.batch``
fires once per micro-batch after ``dispatch.run``, before ``batch_exec`` (an
``error`` rule fails every waiter of the group).
"""

from __future__ import annotations

import collections
import threading
import time

from celestia_tpu_torch import devledger, faults, tracing
from celestia_tpu_torch.log import logger
from celestia_tpu_torch.telemetry import metrics

log = logger("dispatch")


class Shed(Exception):
    """Admission refused — the caller should back off and retry.

    `reason` is one of "queue_full" | "draining" (the
    `rpc_shed_total{reason=...}` label set, plus "deadline" counted by
    DeadlineExceeded paths). The RPC layer maps Shed to
    `503 + Retry-After: ceil(retry_after_s)`."""

    def __init__(self, reason: str, retry_after_s: float = 1.0):
        super().__init__(f"overloaded: {reason}")
        self.reason = reason
        self.retry_after_s = retry_after_s


class DeadlineExceeded(Exception):
    """The job's deadline expired before dispatch completed (mapped to
    504). The result, if the job does finish later, is discarded."""


class _Job:
    __slots__ = ("fn", "label", "deadline", "enqueued_at", "done",
                 "result", "error", "lock", "abandoned", "internal",
                 "batch_key", "batch_exec", "payload", "origin_span",
                 "taken_at", "stages")

    def __init__(self, fn, label: str, deadline: float | None,
                 internal: bool = False, batch_key=None, batch_exec=None,
                 payload=None):
        self.fn = fn
        self.label = label
        self.deadline = deadline  # absolute monotonic, None = no deadline
        self.enqueued_at = time.monotonic()
        self.done = threading.Event()
        self.result = None
        self.error: BaseException | None = None
        self.lock = threading.Lock()
        self.abandoned = False  # waiter gave up; skip if not yet started
        self.internal = internal
        self.batch_key = batch_key    # hashable group key, None = unbatched
        self.batch_exec = batch_exec  # list[payload] -> list[result]
        self.payload = payload
        # batch span links: the submitting thread's open span,
        # so the dispatcher can cross-link request <-> micro-batch spans.
        # None when tracing is off (one thread-local read).
        self.origin_span = tracing.current()
        self.taken_at: float | None = None  # when the loop took the job
        self.stages: dict | None = None     # per-job stage breakdown


class DeviceDispatcher:
    """One thread owning the device stream, fed by a bounded queue."""

    DEFAULT_CAPACITY = 64
    DEFAULT_DEADLINE_S = 30.0
    DEFAULT_RETRY_AFTER_S = 1.0
    # continuous batching: how long the loop lingers for same-key
    # companions once it holds a batchable job (latency it is willing to
    # spend buying occupancy), and the group-size ceiling. max_batch=1
    # disables gathering entirely.
    DEFAULT_BATCH_WINDOW_S = 0.002
    DEFAULT_MAX_BATCH = 32

    def __init__(self, capacity: int | None = None,
                 default_deadline_s: float | None = None,
                 registry=None, batch_window_s: float | None = None,
                 max_batch: int | None = None):
        self.capacity = int(capacity) if capacity else self.DEFAULT_CAPACITY
        self.default_deadline_s = (default_deadline_s
                                   if default_deadline_s
                                   else self.DEFAULT_DEADLINE_S)
        self.batch_window_s = (float(batch_window_s)
                               if batch_window_s is not None
                               else self.DEFAULT_BATCH_WINDOW_S)
        self.max_batch = (max(1, int(max_batch)) if max_batch is not None
                          else self.DEFAULT_MAX_BATCH)
        self.metrics = registry if registry is not None else metrics
        self._cv = threading.Condition()
        self._queue: collections.deque[_Job] = collections.deque()
        self._internal: collections.deque[_Job] = collections.deque()
        self._draining = False
        self._running = False   # loop accepting work
        self._busy = False      # a job body is executing right now
        self._thread: threading.Thread | None = None

    # -- introspection (readiness + tests) ----------------------------- #

    @property
    def depth(self) -> int:
        """Admitted-but-not-yet-run external jobs. Read under `_cv`
        (it wraps an RLock, so locked internal paths may re-enter):
        `_take_mates_locked` REBINDS `_queue` to a fresh deque
        mid-gather, so an unlocked `len` could count a stale snapshot."""
        with self._cv:
            return len(self._queue)

    @property
    def draining(self) -> bool:
        with self._cv:
            return self._draining

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def saturated(self) -> bool:
        """Queue full RIGHT NOW — the /readyz overload signal (a load
        balancer should route around a node that would shed)."""
        return self.depth >= self.capacity

    # -- lifecycle ----------------------------------------------------- #

    def start(self) -> "DeviceDispatcher":
        with self._cv:
            if self._running:
                return self
            self._running = True
            self._draining = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="device-dispatcher")
        self._thread.start()
        return self

    def begin_drain(self) -> None:
        """Stop admitting external work; queued + in-flight jobs still
        complete. Sheds from here on carry reason="draining"."""
        with self._cv:
            if not self._draining:
                self._draining = True
                log.info("dispatcher draining", queued=len(self._queue))
            self._cv.notify_all()

    def drain(self, timeout: float = 5.0) -> bool:
        """Graceful stop: stop admitting, finish queued + in-flight
        work, then stop the thread. Returns True when the drain was
        clean (everything completed and the thread exited in time);
        leftover jobs are flushed with Shed("draining") so no waiter
        hangs."""
        self.begin_drain()
        end = time.monotonic() + timeout
        with self._cv:
            while ((self._queue or self._internal or self._busy)
                   and time.monotonic() < end):
                self._cv.wait(0.05)
            clean = not (self._queue or self._internal or self._busy)
            self._running = False
            leftovers = list(self._queue) + list(self._internal)
            self._queue.clear()
            self._internal.clear()
            self._cv.notify_all()
        for job in leftovers:  # unblock any waiter the timeout stranded
            with job.lock:
                if not job.done.is_set():
                    job.error = Shed("draining")
                    job.done.set()
        thread = self._thread
        if thread is not None:
            thread.join(max(0.0, end - time.monotonic()) + 1.0)
            clean = clean and not thread.is_alive()
            if not thread.is_alive():
                self._thread = None
        self._set_depth_gauge()
        return clean

    # -- admission ----------------------------------------------------- #

    def submit(self, fn=None, *, deadline_s: float | None = None,
               label: str = "", batch_key=None, batch_exec=None,
               payload=None):
        """Run `fn` on the dispatcher thread and return its result.

        Raises `Shed` when the bounded queue refuses admission (full or
        draining), `DeadlineExceeded` when the deadline expires before
        the job completes, and re-raises whatever `fn` itself raised.
        With no dispatcher thread running (embedding, tests of the raw
        handler) the call degrades to inline execution.

        Batched form: pass `batch_key` (hashable group key — same key =
        safe to coalesce), `batch_exec` (callable taking the group's
        payload list, returning one result per payload, in order) and
        this job's `payload` instead of `fn`. The loop coalesces
        same-key neighbors into one `batch_exec` call; this waiter gets
        its own result/error with identical admission semantics."""
        if batch_key is not None:
            if batch_exec is None:
                raise TypeError("batch_key requires batch_exec")
        elif fn is None:
            raise TypeError("submit needs fn or batch_key+batch_exec")
        self.metrics.incr_counter("rpc_dispatch_total")
        faults.fire("dispatch.enqueue", label=label)
        if not self.alive:
            if self.draining:
                self._shed("draining")
            self.metrics.incr_counter("rpc_dispatch_admitted_total")
            if batch_key is not None:
                return batch_exec([payload])[0]
            return fn()
        limit = deadline_s if deadline_s is not None else \
            self.default_deadline_s
        job = _Job(fn, label, time.monotonic() + limit,
                   batch_key=batch_key, batch_exec=batch_exec,
                   payload=payload)
        with self._cv:
            if self._draining or not self._running:
                self._shed("draining")
            if len(self._queue) >= self.capacity:
                self._shed("queue_full")
            self._queue.append(job)
            self.metrics.incr_counter("rpc_dispatch_admitted_total")
            self._set_depth_gauge_locked()
            self._cv.notify_all()
        try:
            return self._await(job)
        finally:
            # fold dispatcher-side stage timings (queue_wait /
            # batch_assembly / exec breakdown) into the request thread's
            # sink — no-op unless the RPC layer installed one. The
            # residual between enqueue→return and the attributed stages
            # (waiter wakeup after done.set(), scheduler overhead) is
            # kept EXPLICIT as "wake" so the stage sum explains the
            # handler span instead of silently under-counting
            if job.stages:
                wake = (time.monotonic() - job.enqueued_at
                        - sum(job.stages.values()))
                if wake > 0.0:
                    job.stages["wake"] = wake
                tracing.merge_stages(job.stages)

    def _shed(self, reason: str):
        self.metrics.incr_counter("rpc_shed_total", reason=reason)
        raise Shed(reason, self.DEFAULT_RETRY_AFTER_S)

    def _await(self, job: _Job):
        remaining = job.deadline - time.monotonic()
        finished = job.done.wait(max(0.0, remaining))
        if not finished:
            with job.lock:
                if not job.done.is_set():
                    # the dispatcher will skip this job if it has not
                    # started; if it IS mid-run the result is discarded
                    job.abandoned = True
                    self.metrics.incr_counter("rpc_shed_total",
                                              reason="deadline")
                    raise DeadlineExceeded(
                        f"deadline expired before dispatch completed "
                        f"({job.label or 'job'})"
                    )
            # completed in the race window between wait() and lock
        if job.error is not None:
            raise job.error
        return job.result

    # -- the internal lane (device sub-operations) --------------------- #

    def run_device(self, fn, label: str = "run_device"):
        """Execute `fn` on the dispatcher thread WITHOUT admission
        control — the funnel for device sub-operations of work the node
        already accepted (sliced serving reads via
        `transfers.register_device_executor`, blob staging at CheckTx,
        the block pipeline's staged H2D/compute/D2H legs, node/
        pipeline.py). `label` names the sub-operation in the
        dispatch.run span and error attribution. Runs inline when
        called from the dispatcher thread itself (no self-deadlock) or
        when no dispatcher thread is running; falls back to inline if
        the dispatcher cannot serve it within the default deadline (the
        read must complete either way)."""
        thread = self._thread
        if thread is None or not thread.is_alive() or \
                threading.current_thread() is thread:
            return fn()
        job = _Job(fn, label, None, internal=True)
        with self._cv:
            if not self._running:
                return fn()
            self._internal.append(job)
            self._cv.notify_all()
        if not job.done.wait(self.default_deadline_s):
            with job.lock:
                if not job.done.is_set():
                    job.abandoned = True
                    return fn()  # dispatcher wedged: serve inline
        if job.error is not None:
            raise job.error
        return job.result

    # -- the loop ------------------------------------------------------ #

    def _loop(self) -> None:
        while True:
            with self._cv:
                while (self._running
                       and not self._internal and not self._queue):
                    self._cv.wait()
                if not self._running and not self._internal \
                        and not self._queue:
                    self._cv.notify_all()
                    return
                group = None
                if self._internal:
                    job = self._internal.popleft()
                else:
                    job = self._queue.popleft()
                    job.taken_at = time.monotonic()
                    if job.batch_key is not None and self.max_batch > 1:
                        # _busy covers the gather: drain() keeps waiting
                        # for the group even though the queue looks empty
                        self._busy = True
                        group = self._gather_batch_locked(job)
                    self._set_depth_gauge_locked()
                self._busy = True
            try:
                if group is not None:
                    self._run_batch(group)
                else:
                    self._run_job(job)
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _gather_batch_locked(self, first: _Job) -> list[_Job]:
        """Collect queued same-key jobs behind `first`, lingering up to
        `batch_window_s` while the group is under `max_batch`. Called
        (and returns) with `_cv` held; the waits release it, so new
        submits land during the window. Internal-lane arrivals cut the
        window short — the priority lane must not sit behind a linger —
        and so does drain()."""
        group = [first]
        self._take_mates_locked(group)
        if self.batch_window_s > 0:
            end = time.monotonic() + self.batch_window_s
            while (len(group) < self.max_batch
                   and self._running and not self._internal):
                remaining = end - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
                self._take_mates_locked(group)
        return group

    def _take_mates_locked(self, group: list[_Job]) -> None:
        key = group[0].batch_key
        room = self.max_batch - len(group)
        if room <= 0 or not self._queue:
            return
        keep: collections.deque[_Job] = collections.deque()
        taken = time.monotonic()
        for job in self._queue:
            if room > 0 and job.batch_key == key:
                job.taken_at = taken
                group.append(job)
                room -= 1
            else:
                keep.append(job)
        self._queue = keep
        self._set_depth_gauge_locked()

    def _run_batch(self, jobs: list[_Job]) -> None:
        """Execute one gathered micro-batch: drop expired/abandoned
        members (per-job, counted exactly once, same as _run_job), run
        ONE batch_exec over the survivors' payloads, and complete each
        waiter with its own result — or the shared error."""
        now = time.monotonic()
        live: list[_Job] = []
        for job in jobs:
            self.metrics.observe("rpc_queue_wait", now - job.enqueued_at)
            with job.lock:
                if job.abandoned:
                    continue
                if job.deadline is not None and now >= job.deadline:
                    self.metrics.incr_counter("rpc_shed_total",
                                              reason="deadline")
                    job.error = DeadlineExceeded(
                        f"deadline expired in queue ({job.label or 'job'})"
                    )
                    job.done.set()
                    continue
            live.append(job)
        if not live:
            return
        lead = live[0]
        self.metrics.incr_counter("dispatch_batch_total")
        self.metrics.incr_counter("dispatch_batched_jobs_total",
                                  float(len(live)))
        self.metrics.observe("dispatch_batch_occupancy", float(len(live)))
        # batch span links: the batch span parents under the
        # LEAD member's request span and records every member's span id;
        # each member's request span records the batch span id + the
        # occupancy it rode at. Mutating open member spans cross-thread
        # is safe: attrs are only serialized after the waiter's span
        # closes, which cannot happen before done.set() below.
        origin = lead.origin_span if isinstance(lead.origin_span,
                                                tracing.Span) else None
        sink = tracing.push_stage_sink() if tracing.enabled() else None
        try:
            with tracing.span("dispatch.batch", parent=origin,
                              label=lead.label, key=str(lead.batch_key),
                              jobs=len(live)) as bsp:
                if isinstance(bsp, tracing.Span):
                    members = [j.origin_span.span_id for j in live
                               if isinstance(j.origin_span, tracing.Span)]
                    if members:
                        bsp.set(member_span_ids=",".join(
                            str(m) for m in members))
                    for job in live:
                        if isinstance(job.origin_span, tracing.Span):
                            job.origin_span.set(
                                batch_span_id=bsp.span_id,
                                batch_occupancy=len(live))
                try:
                    # dispatch.run fires once per DEVICE DISPATCH — job or
                    # micro-batch — so the documented drills (delay there
                    # stalls the single consumer; storm-lite, the deadline
                    # tests) keep working unchanged under batching.
                    # dispatch.batch is the group-specific site on top.
                    faults.fire("dispatch.run", label=lead.label)
                    faults.fire("dispatch.batch", label=lead.label,
                                jobs=len(live))
                    _exec_t0 = time.perf_counter()
                    try:
                        with tracing.stage("exec"):
                            results = lead.batch_exec(
                                [j.payload for j in live])
                    finally:
                        # device-lane occupancy: errors burn
                        # the lane too, so count them
                        devledger.note_busy(time.perf_counter() - _exec_t0)
                    if results is None or len(results) != len(live):
                        raise RuntimeError(
                            f"batch_exec returned "
                            f"{0 if results is None else len(results)} "
                            f"results for {len(live)} payloads"
                        )
                except BaseException as e:  # noqa: BLE001 — waiters re-raise
                    self._attribute_error(e, lead.label, "dispatch.batch")
                    for job in live:
                        job.error = e
                else:
                    for job, result in zip(live, results):
                        job.result = result
        finally:
            if sink is not None:
                tracing.pop_stage_sink()
                shared = sink.data
                for job in live:
                    taken = job.taken_at if job.taken_at is not None else now
                    st = {"queue_wait": max(0.0, taken - job.enqueued_at),
                          "batch_assembly": max(0.0, now - taken)}
                    st.update(shared)
                    job.stages = st
        for job in live:
            with job.lock:
                job.done.set()

    def _attribute_error(self, e: BaseException, label: str,
                         site: str) -> None:
        """Stamp a device-lane failure with its originating label: bump
        `dispatch_device_error_total{label}` and suffix the message so a
        bare `RuntimeError: boom` from a thunk says which route raised
        it. The exception TYPE is untouched — the RPC layer's typed
        mapping (Shed→503, DeadlineExceeded→504, ValueError→400) and
        control-flow sheds are exempt entirely."""
        if isinstance(e, (Shed, DeadlineExceeded)):
            return
        self.metrics.incr_counter("dispatch_device_error_total",
                                  label=label or "unlabeled")
        tag = f"[{site} label={label or 'unlabeled'}]"
        try:
            if e.args and isinstance(e.args[0], str) \
                    and tag not in e.args[0]:
                e.args = (f"{e.args[0]} {tag}",) + e.args[1:]
        except Exception:  # noqa: BLE001 — attribution must not mask e
            pass

    def _run_job(self, job: _Job) -> None:
        now = time.monotonic()
        if not job.internal:
            self.metrics.observe("rpc_queue_wait", now - job.enqueued_at)
        with job.lock:
            if job.abandoned:
                return  # the waiter already counted and answered
            if job.deadline is not None and now >= job.deadline:
                # expired while queued: skip the dead work; the waiter
                # (who has not timed out yet, or is about to) sees the
                # typed error. Counted HERE, under the job lock, so the
                # deadline is recorded exactly once.
                self.metrics.incr_counter("rpc_shed_total",
                                          reason="deadline")
                job.error = DeadlineExceeded(
                    f"deadline expired in queue ({job.label or 'job'})"
                )
                job.done.set()
                return
        origin = job.origin_span if isinstance(job.origin_span,
                                               tracing.Span) else None
        sink = (tracing.push_stage_sink()
                if not job.internal and tracing.enabled() else None)
        try:
            with tracing.span("dispatch.run", parent=origin,
                              label=job.label, internal=job.internal):
                try:
                    faults.fire("dispatch.run", label=job.label)
                    _exec_t0 = time.perf_counter()
                    try:
                        with tracing.stage("exec"):
                            if job.fn is not None:
                                job.result = job.fn()
                            else:
                                # batchable job running unbatched
                                # (max_batch=1): a singleton group
                                # through the same exec callable
                                job.result = job.batch_exec(
                                    [job.payload])[0]
                    finally:
                        # device-lane occupancy
                        devledger.note_busy(time.perf_counter() - _exec_t0)
                except BaseException as e:  # noqa: BLE001 — waiter re-raises
                    self._attribute_error(e, job.label, "dispatch.run")
                    job.error = e
        finally:
            if sink is not None:
                tracing.pop_stage_sink()
                taken = job.taken_at if job.taken_at is not None else now
                st = {"queue_wait": max(0.0, taken - job.enqueued_at)}
                st.update(sink.data)
                job.stages = st
        with job.lock:
            job.done.set()

    # -- gauges -------------------------------------------------------- #

    def _set_depth_gauge(self) -> None:
        with self._cv:
            self._set_depth_gauge_locked()

    def _set_depth_gauge_locked(self) -> None:
        self.metrics.set_gauge("rpc_queue_depth", float(len(self._queue)))
