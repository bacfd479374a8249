"""The port's device dispatcher (celestia_tpu_torch/node/dispatch.py)
against the JAX package's node/dispatch.py.

The same job scripts run through both dispatchers, each with a registry of
its own package: the same results and re-raised errors (with the same
attribution suffix), the same shed reasons and admission counters, the same
coalesced groups under a ``dispatch.run`` delay rule, the same deadline
skips counted once, the same ``dispatch.batch`` failure of a whole group,
and the same drain. The port's jobs also fold their exec time into the
device ledger's busy timeline.
"""

import threading
import time

import pytest

from celestia_tpu import faults as jax_faults
from celestia_tpu.node import dispatch as jax_dispatch
from celestia_tpu.telemetry import Registry as JaxRegistry
from celestia_tpu_torch import devledger, faults
from celestia_tpu_torch.node import dispatch
from celestia_tpu_torch.telemetry import Registry

PACKAGES = {"jax": (jax_dispatch, jax_faults, JaxRegistry),
            "port": (dispatch, faults, Registry)}
COUNTERS = [("rpc_dispatch_total", {}), ("rpc_dispatch_admitted_total", {}),
            ("rpc_shed_total", {"reason": "queue_full"}), ("rpc_shed_total", {"reason": "draining"}),
            ("rpc_shed_total", {"reason": "deadline"}), ("dispatch_batch_total", {}),
            ("dispatch_batched_jobs_total", {}),
            ("dispatch_device_error_total", {"label": "boom"})]
STALL_S = 0.6  # the dispatch.run delay that holds the single consumer


def counters(reg) -> dict:
    return {f"{name}{sorted(labels.items())}": reg.get_counter(name, **labels)
            for name, labels in COUNTERS}


def wait_for(cond, what: str, timeout: float = 10.0) -> None:
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, f"timed out waiting for {what}"
        time.sleep(0.002)


def outcome(call):
    """('ok', result) or (exception type name, reason or message)."""
    try:
        return ("ok", call())
    except Exception as e:  # noqa: BLE001 — the script compares what was raised
        return (type(e).__name__, getattr(e, "reason", None) or str(e))


def both(script):
    """script(dispatch module, faults module, registry) for each package."""
    out = {}
    for name, (mod, flt, reg_cls) in PACKAGES.items():
        reg = reg_cls()
        out[name] = (script(mod, flt, reg), counters(reg))
    return out


def test_results_errors_and_inline_runs_match():
    def script(mod, _flt, reg):
        d = mod.DeviceDispatcher(registry=reg)
        inline = [outcome(lambda: d.submit(lambda: 5, label="pre")),
                  outcome(lambda: d.run_device(lambda: 6))]
        d.start()

        def boom():
            raise RuntimeError("boom")

        def nested():
            # the internal lane from the dispatcher thread itself runs inline
            return d.run_device(lambda: threading.current_thread().name)

        out = inline + [
            outcome(lambda: d.submit(lambda: 7, label="seven")),
            outcome(lambda: d.submit(boom, label="boom")),
            outcome(lambda: d.submit(lambda: (_ for _ in ()).throw(ValueError("bad")),
                                     label="value")),
            outcome(lambda: d.run_device(lambda: 8, label="internal")),
            outcome(lambda: d.submit(nested, label="nested")),
            outcome(lambda: d.submit(batch_key=("k",), batch_exec=lambda ps: [p * 2 for p in ps],
                                     payload=21)),
            outcome(lambda: d.submit(batch_key=("k",))),
            outcome(lambda: d.submit()),
        ]
        out.append(d.drain())
        out.append(outcome(lambda: d.submit(lambda: 9)))
        return out

    res = both(script)
    assert res["jax"] == res["port"]
    results, counts = res["port"]
    assert results[:4] == [("ok", 5), ("ok", 6), ("ok", 7),
                           ("RuntimeError", "boom [dispatch.run label=boom]")]
    assert results[6] == ("ok", "device-dispatcher") and results[7] == ("ok", 42)
    assert results[8][0] == results[9][0] == "TypeError"
    assert results[10] is True and results[11] == ("Shed", "draining")


def _stalled(mod, flt, reg, capacity, **kw):
    """A started dispatcher whose consumer is held STALL_S on its first
    job (a dispatch.run delay), with that job taken; (dispatcher, the
    injector context, the blocker's thread and its outcome list)."""
    d = mod.DeviceDispatcher(capacity=capacity, registry=reg, **kw).start()
    ctx = flt.inject(flt.rule("dispatch.run", "delay", delay_s=STALL_S, times=1), seed=3)
    ctx.__enter__()
    first: list = []
    blocker = threading.Thread(target=lambda: first.append(outcome(
        lambda: d.submit(lambda: "first", label="blocker"))))
    blocker.start()
    wait_for(lambda: d._busy and d.depth == 0, "the blocker taken")
    return d, ctx, blocker, first


def test_shed_reasons_and_admission_counters_match():
    def script(mod, flt, reg):
        d, ctx, blocker, first = _stalled(mod, flt, reg, capacity=2)
        queued: list = []
        threads = []
        for i in range(2):
            t = threading.Thread(target=lambda i=i: queued.append(outcome(
                lambda: d.submit(lambda: f"queued{i}", label="q"))))
            t.start()
            threads.append(t)
            wait_for(lambda i=i: d.depth == i + 1, f"job {i} queued")
        full = outcome(lambda: d.submit(lambda: "late"))
        saturated = d.saturated()
        d.begin_drain()
        draining = outcome(lambda: d.submit(lambda: "drained"))
        blocker.join(10)
        for t in threads:
            t.join(10)
        ctx.__exit__(None, None, None)
        clean = d.drain()
        return first, sorted(queued), full, saturated, draining, clean

    res = both(script)
    assert res["jax"] == res["port"]
    out, counts = res["port"]
    assert out == ([("ok", "first")], [("ok", "queued0"), ("ok", "queued1")],
                   ("Shed", "queue_full"), True, ("Shed", "draining"), True)
    assert counts["rpc_shed_total[('reason', 'queue_full')]"] == 1
    assert counts["rpc_shed_total[('reason', 'draining')]"] == 1
    assert counts["rpc_dispatch_admitted_total[]"] == 3


def test_coalesced_groups_under_a_delay_rule_match():
    """While the consumer is stalled, jobs of two keys queue in a known
    order; each key's jobs then run as ONE batch_exec, in queue order."""
    order = [("a", 1), ("b", 2), ("a", 3), ("a", 4), ("b", 5), ("c", 6)]

    def script(mod, flt, reg):
        d, ctx, blocker, first = _stalled(mod, flt, reg, capacity=16, batch_window_s=0.0)
        groups = []
        lock = threading.Lock()

        def exec_of(ps):
            with lock:
                groups.append(list(ps))
            return [p * 10 for p in ps]

        results = {}
        threads = []
        for i, (key, payload) in enumerate(order):
            t = threading.Thread(target=lambda key=key, payload=payload: results.__setitem__(
                payload, outcome(lambda: d.submit(batch_key=(key,), batch_exec=exec_of,
                                                  payload=payload, label=key))))
            t.start()
            threads.append(t)
            wait_for(lambda i=i: d.depth == i + 1, f"job {i} queued")
        blocker.join(10)
        for t in threads:
            t.join(10)
        ctx.__exit__(None, None, None)
        d.drain()
        return first, groups, sorted(results.items())

    res = both(script)
    assert res["jax"] == res["port"]
    out, counts = res["port"]
    assert out[1] == [[1, 3, 4], [2, 5], [6]]
    assert out[2] == [(p, ("ok", p * 10)) for _k, p in sorted(order, key=lambda kp: kp[1])]
    assert counts["dispatch_batch_total[]"] == 3 and counts["dispatch_batched_jobs_total[]"] == 6


def test_deadline_skips_are_counted_once():
    """A queued job and a queued batch member whose waiters gave up are
    skipped by the consumer (their bodies never run) and counted once."""
    def script(mod, flt, reg):
        d, ctx, blocker, first = _stalled(mod, flt, reg, capacity=8)
        ran = []
        late = outcome(lambda: d.submit(lambda: ran.append("job"), deadline_s=0.05))
        batched = outcome(lambda: d.submit(
            batch_key=("x",), batch_exec=lambda ps: [ran.append(p) for p in ps],
            payload="member", deadline_s=0.05))
        blocker.join(10)
        ctx.__exit__(None, None, None)
        after = outcome(lambda: d.submit(lambda: "after"))
        d.drain()
        return first, late[0], batched[0], ran, after

    res = both(script)
    assert res["jax"] == res["port"]
    out, counts = res["port"]
    assert out == ([("ok", "first")], "DeadlineExceeded", "DeadlineExceeded", [], ("ok", "after"))
    assert counts["rpc_shed_total[('reason', 'deadline')]"] == 2


def test_a_batch_error_rule_fails_the_whole_group():
    def script(mod, flt, reg):
        d, ctx, blocker, first = _stalled(mod, flt, reg, capacity=8, batch_window_s=0.0)
        results = []
        threads = []
        for i in range(3):
            t = threading.Thread(target=lambda i=i: results.append(outcome(lambda: d.submit(
                batch_key=("g",), batch_exec=lambda ps: ps, payload=i, label="boom"))))
            t.start()
            threads.append(t)
            wait_for(lambda i=i: d.depth == i + 1, f"member {i} queued")
        with flt.inject(flt.rule("dispatch.batch", "error", times=1), seed=1):
            blocker.join(10)
            for t in threads:
                t.join(10)
        ctx.__exit__(None, None, None)
        d.drain()
        return first, sorted(r[0] for r in results)

    res = both(script)
    assert res["jax"] == res["port"]
    out, counts = res["port"]
    assert out[1] == ["TransportFault"] * 3
    assert counts["dispatch_device_error_total[('label', 'boom')]"] == 1


def test_drain_completes_queued_work_and_flushes_stragglers():
    def script(mod, flt, reg):
        d, ctx, blocker, first = _stalled(mod, flt, reg, capacity=8)
        done = []
        t = threading.Thread(target=lambda: done.append(outcome(lambda: d.submit(lambda: "q"))))
        t.start()
        wait_for(lambda: d.depth == 1, "a job queued")
        ctx.__exit__(None, None, None)
        clean = d.drain(timeout=10.0)
        blocker.join(10)
        t.join(10)
        return first, done, clean, d.alive, d.draining

    res = both(script)
    assert res["jax"] == res["port"]
    assert res["port"][0] == ([("ok", "first")], [("ok", "q")], True, False, True)


def test_exec_time_feeds_the_busy_timeline():
    led = devledger.ledger
    before = sum(d for _t, d in led._busy)
    d = dispatch.DeviceDispatcher(registry=Registry()).start()
    try:
        d.submit(lambda: time.sleep(0.05))
        d.submit(batch_key=("b",), batch_exec=lambda ps: [time.sleep(0.02) for _ in ps], payload=1)
    finally:
        d.drain()
    assert sum(dd for _t, dd in led._busy) - before >= 0.06
    assert led.busy_ratio() > 0


def test_a_crowd_from_many_threads_is_answered_in_full():
    """A short stress run: 16 threads, 40 batchable jobs each, a switch
    interval of 10 µs; every waiter gets its own answer and the admitted
    jobs equal the batched ones."""
    import sys

    reg = Registry()
    d = dispatch.DeviceDispatcher(registry=reg, capacity=1024).start()
    answers: dict = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker(t):
            for i in range(40):
                p = (t, i)
                answers[p] = d.submit(batch_key=("s",), batch_exec=lambda ps: [q[0] * 100 + q[1]
                                                                                for q in ps],
                                      payload=p)

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
        d.drain()
    assert answers == {(t, i): t * 100 + i for t in range(16) for i in range(40)}
    assert reg.get_counter("dispatch_batched_jobs_total") == 640
    assert reg.get_counter("rpc_dispatch_admitted_total") == 640


@pytest.mark.parametrize("site", ["dispatch.enqueue", "dispatch.run", "dispatch.batch"])
def test_the_fault_sites_are_documented(site):
    assert site in faults.__doc__ and site in dispatch.__doc__
