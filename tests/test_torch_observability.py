"""The port's spans, stage sinks, profiling fence and fault capture, against
the JAX package's tracing of the same entries.

One call of each entry, traced in both packages on the CPU, gives the same
tree of span names and attributes, ``backend`` aside (the JAX package names
"tpu", the port the card or "cpu"). The port stages the square through
``transfers.device_put_chunked``, which adds a ``transfer.extend.stage``
span under ``extend.stage`` (the JAX package's sharded staging does the
same; its unsharded staging is a bare ``jnp.asarray``): those spans are
checked on their own and left out of the comparison.
"""

import collections
import functools
import time

import numpy as np
import pytest
import torch

from celestia_tpu import faults as jax_faults
from celestia_tpu import integrity as jax_integrity
from celestia_tpu import tracing as jax_tracing
from celestia_tpu.ops import extend_tpu
from celestia_tpu_torch import faults, integrity, tracing
from celestia_tpu_torch.appconsts import SHARE_SIZE
from celestia_tpu_torch.ops import extend, transfers
from celestia_tpu_torch.telemetry import Histogram, metrics
from tests.test_torch_extend import square

K = 2
SQ = square(K, seed=5)
SQ2 = square(K, seed=6)


@functools.lru_cache(maxsize=1)
def eds() -> np.ndarray:
    return extend.extend_roots_device(SQ, device="cpu")[0]


# entry name: (call in the JAX package, call in the port)
ENTRIES = {
    "roots_device": (lambda: extend_tpu.roots_device(SQ),
                     lambda: extend.roots_device(SQ, device="cpu")),
    "extend_roots_device": (lambda: extend_tpu.extend_roots_device(SQ),
                            lambda: extend.extend_roots_device(SQ, device="cpu")),
    "extend_roots_device_resident": (
        lambda: extend_tpu.extend_roots_device_resident(SQ),
        lambda: extend.extend_roots_device_resident(SQ, device="cpu")),
    "extend_and_root_device": (lambda: extend_tpu.extend_and_root_device(SQ),
                               lambda: extend.extend_and_root_device(SQ, device="cpu")),
    "eds_roots_device": (lambda: extend_tpu.eds_roots_device(eds()),
                         lambda: extend.eds_roots_device(eds(), device="cpu")),
    "eds_row_levels_device": (lambda: extend_tpu.eds_row_levels_device(eds()),
                              lambda: extend.eds_row_levels_device(eds(), device="cpu")),
    "batched_roots_device": (lambda: extend_tpu.batched_roots_device([SQ, SQ2]),
                             lambda: extend.batched_roots_device([SQ, SQ2], device="cpu")),
}


@pytest.fixture(autouse=True)
def _clean():
    tracing.reset()
    jax_tracing.reset()
    yield
    tracing.reset()
    jax_tracing.reset()
    integrity.configure("off")
    jax_integrity.configure("off")


def span_tree(spans, drop=lambda s: False):
    """Nested (name, attributes without backend, children) in start order;
    a dropped span's children are dropped with it."""
    kids = collections.defaultdict(list)
    ids = {s.span_id for s in spans}
    for s in sorted(spans, key=lambda s: s.start):
        kids[s.parent_id if s.parent_id in ids else None].append(s)

    def node(s):
        attrs = {k: v for k, v in s.attrs.items() if k != "backend"}
        return (s.name, attrs, [node(c) for c in kids[s.span_id] if not drop(c)])

    return [node(s) for s in kids[None] if not drop(s)]


def recorded(tracing_mod, fn):
    with tracing_mod.record() as rec:
        fn()
    return rec.spans


def is_transfer(s) -> bool:
    return s.name.startswith("transfer.")


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_span_tree_equals_jax_entry(entry):
    jax_call, port_call = ENTRIES[entry]
    eds()  # built outside the recordings
    jax_call()  # the JAX package's first call also records its compile
    port_call()  # and the port's its builds (the device ledger's device.build spans)
    # the resident entries audit their output: the same seeded engine in both
    jax_integrity.configure("sampled", seed=3)
    integrity.configure("sampled", seed=3)
    theirs = recorded(jax_tracing, jax_call)
    ours = recorded(tracing, port_call)
    assert span_tree(ours, drop=is_transfer) == span_tree(theirs)
    names = {s.name for s in ours}
    assert any(n.startswith("extend.") for n in names)
    for s in ours:
        assert s.attrs.get("backend", "cpu") == "cpu"
    if entry in ("extend_roots_device", "extend_roots_device_resident"):
        assert "integrity.audit" in names


@pytest.mark.parametrize("entry", ["roots_device", "extend_roots_device_resident",
                                   "extend_and_root_device"])
def test_staging_span_under_extend_stage(entry):
    spans = recorded(tracing, ENTRIES[entry][1])
    by_id = {s.span_id: s for s in spans}
    staged = [s for s in spans if s.name == "transfer.extend.stage"]
    assert len(staged) == 1
    t = staged[0]
    assert by_id[t.parent_id].name == "extend.stage"
    assert by_id[by_id[t.parent_id].parent_id].name == "extend.device"
    assert t.attrs["bytes"] == K * K * SHARE_SIZE and t.attrs["direction"] == "h2d"
    assert t.attrs["site"] == "extend.stage" and t.attrs["total_bytes"] >= K * K * SHARE_SIZE
    rs_nmt = [s for s in spans if s.name == "extend.rs_nmt"]
    assert len(rs_nmt) == 1 and by_id[rs_nmt[0].parent_id].name == "extend.device"


def test_fault_strikes_ride_their_span_like_jax():
    rule = ("device.extend", "delay")
    trees = []
    for flt, trc, call in ((jax_faults, jax_tracing, ENTRIES["roots_device"][0]),
                           (faults, tracing, ENTRIES["roots_device"][1])):
        with flt.inject(flt.rule(*rule, delay_s=0.0), seed=1):
            spans = recorded(trc, call)
        top = [s for s in spans if s.name == "extend.device"][0]
        trees.append((top.attrs["fault_hits"], top.attrs["fault_sites"]))
    assert trees[0] == trees[1] == (1, "device.extend:delay")


def test_off_means_no_span():
    assert not tracing.enabled()
    assert tracing.span("x") is tracing._NOOP
    extend.roots_device(SQ, device="cpu")
    assert tracing.flight() == []


def test_flight_recorder_is_bounded_and_ordered():
    tracing.enable(flight_capacity=3)
    try:
        for i in range(5):
            with tracing.span("s", i=i):
                pass
        flight = tracing.flight()
        assert [d["attrs"]["i"] for d in flight] == [2, 3, 4]
        assert tracing.flight_capacity() == 3
        with tracing.span("parent") as p:
            tracing.emit("child", time.perf_counter())
            assert tracing.current() is p
        child = tracing.flight()[-2]
        assert child["name"] == "child" and child["parent_id"] == p.span_id
    finally:
        tracing.enable(flight_capacity=tracing.FLIGHT_CAPACITY)


def test_transfers_feed_the_stage_sink():
    sink = tracing.push_stage_sink()
    try:
        transfers.device_put_chunked(np.zeros((4, 512), np.uint8), "cpu", site="t.sink")
        transfers.eds_row(torch.zeros((2, 2, 512), dtype=torch.uint8), 0, site="t.sink")
        with tracing.stage("outer"):
            transfers.eds_share(torch.zeros((2, 2, 512), dtype=torch.uint8), 0, 1)
    finally:
        assert tracing.pop_stage_sink() is sink
    assert set(sink.data) == {"h2d", "d2h", "outer"}
    assert sink.marked == pytest.approx(sum(sink.data.values()))


def test_profiling_fences_a_sample_of_calls():
    tracing.enable()
    tracing.enable_profiling(sample_every=2)
    for _ in range(4):
        extend.roots_device(SQ, device="cpu")
    fences = [d for d in tracing.flight() if d["name"] == "profile.fence"]
    assert len(fences) == 2
    assert fences[0]["attrs"] == {"entry": "roots_device", "fenced": True, "k": K}
    tracing.disable_profiling()
    assert not tracing.profile_sample()


def test_transfer_histogram_and_quantiles():
    before = metrics.get_timing("transfer", site="t.hist", direction="h2d")
    n0 = before.count if before is not None else 0
    for _ in range(3):
        transfers.device_put_chunked(np.zeros((2, 512), np.uint8), "cpu", site="t.hist")
    hist = metrics.get_timing("transfer", site="t.hist", direction="h2d")
    assert hist.count == n0 + 3 and hist.sum > 0
    h = Histogram((1.0, 2.0, 4.0))
    for v in (0.5, 1.5, 1.5, 3.0):
        h.observe(v)
    assert h.counts == [1, 2, 1, 0]
    assert h.quantile(0.5) == pytest.approx(1.5)
    assert metrics.timing_quantile("no.such", 0.5) != metrics.timing_quantile("no.such", 0.5)


# ---------------------------------------------------------------------- #
# the repair entries (ops/repair.py, da/repair.py) against the JAX package's
# (ops/repair_tpu.py, da/repair.py). Differences of record: the port's
# device entry is repair_device where the JAX package's is repair_tpu (the
# ``entry`` attribute names the function), its ``repair`` timing says
# backend "gpu" where the JAX package says "tpu", and the host repair's
# root check computes the roots through extend.eds_roots_device (an
# ``extend.nmt`` span) where the JAX package's host square hashes them on
# the host (``extend.nmt.rows`` and ``extend.nmt.cols``).


@functools.lru_cache(maxsize=1)
def repair_case():
    """A k = 2 square, its resident EDS in both packages, a mask that
    needs a row and a column sweep, the erased host square and the roots."""
    from celestia_tpu.ops import extend_tpu as jax_extend

    eds_t, rows, cols = extend.extend_roots_device_resident(SQ, device="cpu")
    jax_eds, _rows, _cols = jax_extend.extend_roots_device_resident(SQ)
    present = np.ones((2 * K, 2 * K), dtype=bool)
    present[1, :] = False
    present[:, 2] = False
    present[0, 0] = False
    src = np.where(present[..., None], eds_t.numpy(), 0).astype(np.uint8)
    roots = ([r.tobytes() for r in rows], [c.tobytes() for c in cols])
    return eds_t, jax_eds, present, src, roots


def _repair_entries():
    from celestia_tpu.da import repair as jax_da_repair
    from celestia_tpu.ops import repair_tpu
    from celestia_tpu_torch.da import repair as da_repair
    from celestia_tpu_torch.ops import repair

    eds_t, jax_eds, present, src, (rr, cc) = repair_case()
    return {
        "repair_device": (lambda: repair_tpu.repair_tpu(src, present),
                          lambda: repair.repair_device(src, present, device="cpu")),
        "repair_resident_verified": (
            lambda: repair_tpu.repair_resident_verified(jax_eds, present, rr, cc),
            lambda: repair.repair_resident_verified(eds_t, present, rr, cc, device="cpu")),
        "repair": (lambda: jax_da_repair.repair(src, present.copy(), rr, cc),
                   lambda: da_repair.repair(src, present.copy(), rr, cc, device="cpu")),
    }


def _renamed(tree):
    """The JAX tree with its device entry named as the port's, and the host
    verify's root spans as one ``extend.nmt`` node."""
    out = []
    for name, attrs, kids in tree:
        if attrs.get("entry") == "repair_tpu":
            attrs = {**attrs, "entry": "repair_device"}
        if name == "repair.verify" and [n for n, _a, _k in kids] == [
                "extend.nmt.rows", "extend.nmt.cols"]:
            kids = [("extend.nmt", {"entry": "eds_roots_device", "k": attrs["k"]}, [])]
        out.append((name, attrs, _renamed(kids)))
    return out


@pytest.mark.parametrize("entry", ["repair_device", "repair_resident_verified", "repair"])
def test_repair_span_tree_equals_jax_entry(entry):
    jax_call, port_call = _repair_entries()[entry]
    jax_call()  # the JAX package's first call also records its compile
    port_call()  # and the port's its builds (the device ledger's device.build spans)
    jax_integrity.configure("sampled", seed=3)
    integrity.configure("sampled", seed=3)
    theirs = recorded(jax_tracing, jax_call)
    ours = recorded(tracing, port_call)
    assert span_tree(ours, drop=is_transfer) == _renamed(span_tree(theirs, drop=is_transfer))
    names = [s.name for s in ours]
    if entry == "repair":
        assert names.count("repair.sweep") == 2 and "repair.host" in names
    else:
        assert "integrity.audit" in names and "repair.plan" in names
        top = [s for s in ours if s.name == "repair.device"][0]
        assert top.attrs["backend"] == "cpu" and top.attrs["entry"] == entry


def test_repair_device_transfer_spans_like_jax():
    """Both packages stage the square (``transfer.repair.stage`` under
    ``repair.upload``) and fetch the result (``transfer.repair.fetch``)."""
    jax_call, port_call = _repair_entries()["repair_device"]
    jax_call()
    shapes = []
    for trc, call in ((jax_tracing, jax_call), (tracing, port_call)):
        spans = recorded(trc, call)
        by_id = {s.span_id: s for s in spans}
        shapes.append(sorted((s.name, by_id[s.parent_id].name, s.attrs["direction"],
                              s.attrs["bytes"]) for s in spans if is_transfer(s)))
    nbytes = (2 * K) ** 2 * SHARE_SIZE
    assert shapes[0] == shapes[1] == [("transfer.repair.fetch", "repair.device", "d2h", nbytes),
                                      ("transfer.repair.stage", "repair.upload", "h2d", nbytes)]


def test_repair_entries_time_themselves_under_their_labels():
    from celestia_tpu_torch.da import repair as da_repair
    from celestia_tpu_torch.ops import repair

    _eds_t, _jax_eds, present, src, _roots = repair_case()

    def count(backend):
        hist = metrics.get_timing("repair", backend=backend)
        return 0 if hist is None else hist.count

    gpu, host = count("gpu"), count("host")
    repair.repair_device(src, present, device="cpu")
    da_repair.repair(src, present.copy(), device="cpu")
    assert count("gpu") == gpu + 1 and count("host") == host + 1


def test_measure_records_one_timing_under_its_labels():
    before = metrics.get_timing("t.measure", stage="a", backend="gpu")
    assert before is None
    with metrics.measure("t.measure", stage="a", backend="gpu") as timer:
        time.sleep(0.002)
    hist = metrics.get_timing("t.measure", stage="a", backend="gpu")
    assert hist.count == 1 and hist.sum >= 0.002 and timer.start > 0
    with pytest.raises(KeyError), metrics.measure("t.measure", stage="a", backend="gpu"):
        raise KeyError("the block's error passes through")
    assert hist.count == 2 and metrics.get_timing("t.measure", stage="b") is None
