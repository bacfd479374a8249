"""The port's device ledger (celestia_tpu_torch/devledger.py) against the
JAX package's devledger.py.

The JAX package's own cases (tests/test_devledger.py) run on both packages'
``DeviceLedger`` with the same toy builders and scripts: equal build and
retrace counts, the same ``RetraceError`` behaviour, owner sums, weak
drops, broken owners and the unlocked callbacks, and the same
``busy_ratio`` on injected clocks. Every test builds its own ledger, or
unregisters what it registers in the process ledger, and collects the
caches it makes. The port's watchdog series are renamed (``device_*`` for
the JAX package's ``xla_*``); the rename is pinned here. Each instrumented
port builder counts one build per key, and the four holders of device
memory register under the JAX package's owner names.
"""

import functools
import gc

import numpy as np
import pytest
import torch

from celestia_tpu import devledger as jax_devledger
from celestia_tpu import da as jax_da
from celestia_tpu.node import eds_cache as jax_eds_cache
from celestia_tpu.telemetry import Registry as JaxRegistry
from celestia_tpu.telemetry import metrics as jax_metrics
from celestia_tpu.testutil.chaosnet import chain_shares
from celestia_tpu_torch import da, devledger, native
from celestia_tpu_torch.node import eds_cache
from celestia_tpu_torch.node.pipeline import BlockPipeline
from celestia_tpu_torch.ops import _cuda, blob_pool, rs, xor_schedule
from celestia_tpu_torch.telemetry import Registry, metrics

MODULES = {"jax": jax_devledger, "port": devledger}
REGISTRY = {"jax": jax_metrics, "port": metrics}
# the watchdog's series: the JAX package's name -> the port's
RENAMED = {
    "xla_compile_total": "device_build_total",
    "xla_compile_ms": "device_build_ms",
    "xla_compile_cache_hit_total": "device_build_cache_hit_total",
    "xla_retrace_total": "device_retrace_total",
    "xla.compile": "device.build",
    "xla.retrace": "device.retrace",
}


@pytest.fixture(autouse=True)
def _collect_caches():
    """Caches enrol in their package's process ledger until collected."""
    yield
    gc.collect()


def run_both(script):
    """script(module, ledger) on a fresh ledger of each package; the two
    results."""
    return [script(MODULES[p], MODULES[p].DeviceLedger()) for p in ("jax", "port")]


# ---------------------------------------------------------------------- #
# build watchdog


def _warmup_script(mod, led):
    built = []

    @functools.lru_cache(maxsize=None)
    @led.instrument_builder("t.entry")
    def build(k):
        built.append(k)
        return lambda: k

    values = [build(2)(), build(4)(), build(2)()]
    return values, built, led.retrace_count(), led.warm, led.debug_doc()["compile"]["entries"]


def test_warmup_builds_are_builds_not_retraces():
    jax_out, port_out = run_both(_warmup_script)
    assert jax_out[:4] == port_out[:4] == ([2, 4, 2], [2, 4], 0, False)
    assert jax_out[4]["t.entry"]["compiles"] == port_out[4]["t.entry"]["builds"] == 2
    assert jax_out[4]["t.entry"]["keys"] == port_out[4]["t.entry"]["keys"] == 2


def _note_script(mod, led):
    out = [led.note_build("t.entry", "(2,)")]
    led.end_warmup()
    out += [led.note_build("t.entry", "(2,)"), led.note_build("t.entry", "(8,)"),
            led.note_build("t.late", "(2,)"), led.note_build("t.late", "(4,)")]
    events = [(e["entry"], e["key"]) for e in led.retraces()]
    led.begin_warmup()
    cleared = (led.retrace_count(), led.warm)
    led.end_warmup()
    # (8,) was adopted during the previous phase: still known
    out += [led.note_build("t.entry", "(8,)"), led.note_build("t.entry", "(16,)")]
    led.reset_watchdog()
    led.end_warmup()
    out.append(led.note_build("t.entry", "(32,)"))  # forgotten: a first
    return out, events, cleared, led.retrace_count()


def test_retrace_events_match():
    """Known keys, fresh keys after warm-up, a first key on a new entry,
    begin_warmup and reset_watchdog: the same verdicts in both."""
    jax_out, port_out = run_both(_note_script)
    assert jax_out == port_out
    assert port_out[0] == [False, False, True, False, True, False, True, False]
    assert port_out[1] == [("t.entry", "(8,)"), ("t.late", "(4,)")]


def _strict_script(mod, led):
    built = []

    @functools.lru_cache(maxsize=None)
    @led.instrument_builder("t.entry")
    def build(k):
        built.append(k)
        return lambda: k

    build(2)
    led.end_warmup()
    with led.strict_retraces():
        assert led.strict
        with pytest.raises(mod.RetraceError, match="t.entry"):
            build(16)
    return built, led.strict, led.retrace_count()


def test_strict_raises_before_the_builder_body_runs():
    """The raise precedes the build, so the lru never adopts the key."""
    jax_out, port_out = run_both(_strict_script)
    assert jax_out == port_out == ([2], False, 1)


def test_strict_mode_reads_the_environment(monkeypatch):
    monkeypatch.setenv("CELESTIA_STRICT_RETRACE", "1")
    assert jax_devledger.DeviceLedger().strict and devledger.DeviceLedger().strict
    monkeypatch.setenv("CELESTIA_STRICT_RETRACE", "0")
    assert not jax_devledger.DeviceLedger().strict and not devledger.DeviceLedger().strict


def _evict_script(mod, led):
    built = []

    @functools.lru_cache(maxsize=1)
    @led.instrument_builder("t.evict")
    def build(k):
        built.append(k)
        return lambda: k

    build(1)()
    build(2)()  # evicts key 1 from the lru
    led.end_warmup()
    build(1)()  # an lru miss: build runs again, but the key is known
    return built, led.retrace_count(), led.debug_doc()["compile"]["entries"]["t.evict"]["keys"]


def test_lru_evicted_key_rebuilt_is_a_build_not_a_retrace():
    jax_out, port_out = run_both(_evict_script)
    assert jax_out == port_out == ([1, 2, 1], 0, 2)


def _tuple_script(mod, led):
    @led.instrument_builder("t.tuple")
    def build(k):
        return (lambda: k, {"meta": k}, [lambda: -k])

    fn, meta, inner = build(3)
    return fn(), meta, inner[0](), build(5)[2][0]()


def test_builder_returning_a_tuple():
    jax_out, port_out = run_both(_tuple_script)
    assert jax_out == port_out == (3, {"meta": 3}, -3, -5)


@pytest.mark.parametrize("jax_name", ["xla_compile_total", "xla_retrace_total"])
def test_the_renamed_counters_count_alike(jax_name):
    """The port counts under its ``device_*`` name what the JAX package
    counts under ``xla_*``, and nothing under the old name."""
    entry = f"t.renamed.{jax_name}"
    port_name = RENAMED[jax_name]
    before = {p: REGISTRY[p].get_counter(n, entry=entry)
              for p, n in (("jax", jax_name), ("port", port_name))}
    for p in ("jax", "port"):
        led = MODULES[p].DeviceLedger()

        @led.instrument_builder(entry)
        def build(k):
            return lambda: k

        build(2)()
        led.end_warmup()
        build(4)()
    assert jax_metrics.get_counter(jax_name, entry=entry) == before["jax"] + (
        2 if jax_name == "xla_compile_total" else 1)
    assert metrics.get_counter(port_name, entry=entry) == before["port"] + (
        2 if port_name == "device_build_total" else 1)
    assert metrics.get_counter(jax_name, entry=entry) == 0


def test_key_extra_makes_ambient_state_part_of_the_key():
    """The JAX package's case on both ledgers: a flip of the mesh that the
    arguments do not carry is a new key, and so a retrace after warm-up."""
    for p in ("jax", "port"):
        led = MODULES[p].DeviceLedger()
        mesh = {"shape": (8,)}

        @led.instrument_builder("t.mesh", key_extra=lambda: mesh["shape"])
        def build(k):
            return lambda: k

        build(2)()
        led.end_warmup()
        build(2)()  # same args, same mesh: a known key
        assert led.retrace_count() == 0, p
        mesh["shape"] = (4, 2)
        build(2)()  # same args, another mesh: a new key
        assert led.retrace_count() == 1, p
        assert [r["key"] for r in led.retraces()] == ["(2)|(4, 2)"], p


def test_the_build_histogram_and_span_are_renamed():
    from celestia_tpu_torch import tracing

    led = devledger.DeviceLedger()
    entry = "t.renamed.histogram"

    @led.instrument_builder(entry)
    def build(k):
        return k

    tracing.enable()
    try:
        with tracing.record() as rec:
            build(7)
    finally:
        tracing.disable()
    hist = metrics.get_timing(RENAMED["xla_compile_ms"], entry=entry)
    assert hist is not None and hist.count == 1
    spans = [sp for sp in rec.spans if sp.name == RENAMED["xla.compile"]]
    assert len(spans) == 1 and spans[0].attrs["entry"] == entry
    assert metrics.get_timing("xla_compile_ms", entry=entry) is None


def test_exemplars_are_kept_as_the_jax_registry_keeps_them():
    got = []
    for reg in (JaxRegistry(), Registry()):
        reg.observe("t_ms", 0.25, exemplar="trace-1", entry="e")
        reg.observe("t_ms", 0.5, entry="e")  # no exemplar: the last one stays
        reg.observe("t_ms", 0.75, exemplar="trace-2", entry="f")
        got.append((reg.get_exemplar("t_ms", entry="e"), reg.get_exemplar("t_ms", entry="f"),
                    reg.get_exemplar("t_ms", entry="g"), reg.get_timing("t_ms", entry="e").count))
    assert got[0] == got[1] == (("trace-1", 0.25), ("trace-2", 0.75), None, 2)


def test_the_retrace_span_is_renamed():
    from celestia_tpu_torch import tracing

    led = devledger.DeviceLedger()
    led.note_build("t.span", "(2,)")
    led.end_warmup()
    tracing.enable()
    try:
        with tracing.record() as rec:
            led.note_build("t.span", "(4,)")
    finally:
        tracing.disable()
    assert [sp.name for sp in rec.spans] == [RENAMED["xla.retrace"]]
    assert rec.spans[0].attrs["key"] == "(4,)"


def test_a_cache_hit_counts_for_the_building_entry():
    led = devledger.DeviceLedger()
    entry = "t.cache_hit"
    before = metrics.get_counter(RENAMED["xla_compile_cache_hit_total"], entry=entry)

    @led.instrument_builder(entry)
    def build(k):
        led.note_cache_hit()
        return k

    build(1)
    led.note_cache_hit()  # outside a build: attributed to nothing
    assert metrics.get_counter(RENAMED["xla_compile_cache_hit_total"], entry=entry) == before + 1


# ---------------------------------------------------------------------- #
# the port's instrumented builders: one build per key


RS_BUILDERS = [
    ("rs.encode_bit_matrix", rs.encode_bit_matrix, 4),
    ("rs.fft_program", rs.fft_program, 8),
    ("rs.decode_program", rs.decode_program, 8),
    ("rs.decode_twiddles", rs.decode_twiddles, 8),
    ("rs.decode_bit_matrix", rs.decode_bit_matrix, 4),
    ("xor.compile_schedule", xor_schedule.compile_schedule, 2),
]


@pytest.mark.parametrize("entry,builder,key", RS_BUILDERS, ids=[b[0] for b in RS_BUILDERS])
def test_each_per_k_builder_builds_once_per_key(entry, builder, key):
    led = devledger.ledger
    builder.cache_clear()
    before = metrics.get_counter("device_build_total", entry=entry)
    first = builder(key)
    second = builder(key)
    assert second is first
    assert metrics.get_counter("device_build_total", entry=entry) == before + 1
    entries = led.debug_doc()["compile"]["entries"]
    assert entries[entry]["keys"] >= 1 and entries[entry]["builds"] >= 1


def test_the_kernel_library_build_counts_builds_and_disk_hits(monkeypatch, tmp_path):
    """``_cuda.library()`` runs the nvcc build (``_library_for``) once per
    process, cached in ``_lib``: one build per source hash, and a hit when
    the library of that hash is already on disk."""
    built = []

    def fake_build(out_dir):
        built.append(out_dir.name)
        out_dir.mkdir(parents=True)
        (out_dir / _cuda.LIB_NAME).write_bytes(b"")

    monkeypatch.setattr(_cuda, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_cuda, "_build", fake_build)
    monkeypatch.setattr(_cuda, "_open", lambda path: ("lib", path.parent.name))
    monkeypatch.setattr(_cuda, "_lib", None)
    hits0 = metrics.get_counter("device_build_cache_hit_total", entry="cuda.library")
    builds0 = metrics.get_counter("device_build_total", entry="cuda.library")
    monkeypatch.setattr(_cuda, "_source_hash", lambda: "h1")
    assert _cuda.library() == ("lib", "h1")
    assert _cuda.library() == ("lib", "h1")  # the process's library: no second build
    (tmp_path / "h2").mkdir()
    (tmp_path / "h2" / _cuda.LIB_NAME).write_bytes(b"")
    monkeypatch.setattr(_cuda, "_lib", None)  # a fresh process, the sources changed
    monkeypatch.setattr(_cuda, "_source_hash", lambda: "h2")
    assert _cuda.library() == ("lib", "h2")
    assert built == ["h1"]
    assert metrics.get_counter("device_build_total", entry="cuda.library") == builds0 + 2
    assert metrics.get_counter("device_build_cache_hit_total",
                               entry="cuda.library") == hits0 + 1


def test_the_native_build_counts_once_per_source_hash(monkeypatch):
    if not native.available():
        pytest.skip("no g++ here: the native runtime cannot build")
    monkeypatch.setattr(native, "_lib", None)
    before = metrics.get_counter("device_build_total", entry="native.library")
    hits = metrics.get_counter("device_build_cache_hit_total", entry="native.library")
    assert native._load() is not None
    assert native._load() is native._lib  # the process's library: no second build
    assert metrics.get_counter("device_build_total", entry="native.library") == before + 1
    # the library was on disk already (available() built it)
    assert metrics.get_counter("device_build_cache_hit_total", entry="native.library") == hits + 1


# ---------------------------------------------------------------------- #
# device-byte ledger


class _Owner:
    def __init__(self, n):
        self.n = n

    def device_bytes(self):
        return self.n


def _owner_script(mod, led):
    owner = _Owner(4096)
    led.register_owner("t.cache", owner.device_bytes)
    seen = [led.snapshot()["owners"]["t.cache"]]
    del owner
    gc.collect()
    snap = led.snapshot()
    seen += ["t.cache" in snap["owners"], "t.cache" in led.owner_names()]
    led.register_owner("t.flat", lambda: 128)
    gc.collect()
    seen.append(led.snapshot()["owners"]["t.flat"])
    seen.append(led.unregister_owner("t.flat"))
    seen.append("t.flat" in led.snapshot()["owners"])
    led.register_owner("t.pool", lambda: 100)
    led.register_owner("t.pool", lambda: 28)
    led.register_owner("t.broken", lambda: 1 / 0)
    snap = led.snapshot()
    seen += [snap["owners"]["t.pool"], snap["owners"]["t.broken"], snap["attributed_bytes"],
             led.unregister_owner("t.pool"), led.owner_names()]
    return seen


def test_owner_sums_weak_drops_and_broken_owners():
    jax_out, port_out = run_both(_owner_script)
    assert jax_out == port_out == [4096, False, False, 128, 1, False, 128, 0, 128, 2,
                                   ["t.broken"]]


@pytest.mark.parametrize("pkg_name", sorted(MODULES))
def test_snapshot_runs_callbacks_with_the_ledger_lock_dropped(pkg_name):
    led = MODULES[pkg_name].DeviceLedger()
    observed = []

    def cb():
        got = led._lock.acquire(blocking=False)
        if got:
            led._lock.release()
        observed.append(got)
        return 32

    led.register_owner("t.probe", cb)
    led.snapshot()
    assert observed == [True]


def test_live_bytes_come_from_the_cuda_allocator(monkeypatch):
    """On the CPU (CUDA never initialised) the port's live bytes read 0 and
    reading them initialises nothing; on a card they are the allocator's,
    and the unattributed bytes are the clamped remainder."""
    led = devledger.DeviceLedger()
    led.register_owner("t.hoard", lambda: 1000)
    if not torch.cuda.is_available():
        snap = led.snapshot()
        assert snap["live_bytes"] == 0 and snap["unattributed_bytes"] == 0
        assert not torch.cuda.is_initialized()
    monkeypatch.setattr(devledger, "_live_device_bytes", lambda: 4096)
    snap = led.snapshot()
    assert (snap["live_bytes"], snap["attributed_bytes"], snap["unattributed_bytes"]) == (
        4096, 1000, 3096)
    led.register_owner("t.liar", lambda: 1 << 60)
    assert led.snapshot()["unattributed_bytes"] == 0


def _paged(mod_cache, k: int):
    """A paged cache of each package holding one square, one page read."""
    eds = np.asarray(jax_da.extend_shares(chain_shares(k, 1)).data)
    if mod_cache is jax_eds_cache:
        import jax
        import jax.numpy as jnp

        cache = jax_eds_cache.PagedEdsCache(rows_per_page=2)
        cache.put(1, jax_da.ExtendedDataSquare.from_device(
            jax.device_put(jnp.asarray(eds)), k))
    else:
        cache = eds_cache.PagedEdsCache(rows_per_page=2, device="cpu")
        cache.put(1, da.ExtendedDataSquare.from_device(torch.from_numpy(eds.copy()), k))
    cache.get(1).row(0)
    return cache


def test_the_paged_cache_owner_reconciles_as_the_jax_packages():
    """The same square in both paged caches: the same owner bytes in a
    ledger of each package, equal to the cache's device bytes."""
    sums = []
    for mod_cache, mod in ((jax_eds_cache, jax_devledger), (eds_cache, devledger)):
        cache = _paged(mod_cache, 4)
        led = mod.DeviceLedger()
        led.register_owner("eds_cache_paged", cache.device_bytes)
        snap = led.snapshot()
        assert snap["owners"]["eds_cache_paged"] == cache.device_bytes() > 0
        sums.append((snap["owners"], snap["attributed_bytes"]))
    assert sums[0] == sums[1]


def _count(name: str) -> int:
    return sum(1 for n, _ref in devledger.ledger._owners if n == name)


@pytest.mark.parametrize("name,make", [
    ("eds_cache_paged", lambda: eds_cache.PagedEdsCache(device="cpu")),
    ("eds_cache_resident", lambda: eds_cache.ResidentEdsCache()),
    ("blob_arena", lambda: blob_pool.DeviceBlobArena(8192, device="cpu")),
    ("pipeline_inflight", lambda: BlockPipeline(4, device="cpu")),
], ids=["paged", "resident", "arena", "pipeline"])
def test_the_holders_of_device_memory_register_weakly(name, make):
    """The four holders enrol in the process ledger under the JAX names at
    construction, and drop out once collected."""
    gc.collect()
    devledger.ledger.snapshot()  # prune the dead
    before = _count(name)
    holder = make()
    assert _count(name) == before + 1
    assert devledger.ledger.snapshot()["owners"][name] >= holder.device_bytes()
    del holder
    gc.collect()
    devledger.ledger.snapshot()
    assert _count(name) == before


# ---------------------------------------------------------------------- #
# busy timeline


BUSY_SCRIPTS = {
    "idle": (10.0, [], 100.0),
    "integrates": (10.0, [(2.5, 101.0), (2.5, 104.0)], 104.0),
    "clamps": (5.0, [(50.0, 10.0)], 10.0),
    "ages_out": (5.0, [(2.0, 10.0)], 16.0),
    "in_window": (5.0, [(2.0, 10.0)], 10.0),
    "negative": (5.0, [(-3.0, 10.0)], 10.0),
}


@pytest.mark.parametrize("script", sorted(BUSY_SCRIPTS))
def test_busy_ratio_matches_on_injected_clocks(script):
    window, notes, now = BUSY_SCRIPTS[script]
    ratios = []
    for p in ("jax", "port"):
        led = MODULES[p].DeviceLedger(busy_window_s=window)
        for seconds, at in notes:
            led.note_busy(seconds, now=at)
        ratios.append(led.busy_ratio(now=now))
    assert ratios[0] == ratios[1]
    assert ratios[1] == {"idle": 0.0, "integrates": 0.5, "clamps": 1.0, "ages_out": 0.0,
                         "in_window": 0.4, "negative": 0.0}[script]


# ---------------------------------------------------------------------- #
# export surfaces


def test_publish_exports_every_gauge_family_as_the_jax_package():
    gauges = []
    for p, reg in (("jax", JaxRegistry()), ("port", Registry())):
        led = MODULES[p].DeviceLedger(busy_window_s=10.0)
        led.register_owner("t.owner", lambda: 2048)
        snap = led.publish(reg)
        assert reg.get_gauge("device_ledger_unattributed_bytes") == float(
            snap["unattributed_bytes"])
        assert reg.get_gauge("device_ledger_live_bytes") == float(snap["live_bytes"])
        gauges.append((reg.get_gauge("device_ledger_bytes", owner="t.owner"),
                       reg.get_gauge("device_busy_ratio")))
    assert gauges[0] == gauges[1] == (2048.0, 0.0)


def test_debug_doc_shape_and_retrace_ring():
    docs = []
    for p in ("jax", "port"):
        led = MODULES[p].DeviceLedger()
        led.note_build("t.doc", "(2,)")
        led.end_warmup()
        for n in range(40):
            led.note_build("t.doc", f"({n + 10},)")
        doc = led.debug_doc()
        assert set(doc) == {"compile", "ledger", "busy_ratio", "provenance"}
        assert led.retrace_count() == 40
        docs.append(doc)
    for key in ("warm", "strict", "retrace_count"):
        assert docs[0]["compile"][key] == docs[1]["compile"][key]
    assert [(r["entry"], r["key"]) for r in docs[0]["compile"]["retraces"]] == \
        [(r["entry"], r["key"]) for r in docs[1]["compile"]["retraces"]]
    assert len(docs[1]["compile"]["retraces"]) == 32
    assert docs[1]["compile"]["entries"]["t.doc"] == {"keys": 41, "builds": 0}
    assert isinstance(docs[1]["ledger"]["unattributed_bytes"], int)


def test_runtime_provenance_names_torch_cuda_and_the_card():
    prov = devledger.runtime_provenance()
    for key in ("python", "machine", "cpus", "torch", "backend", "n_devices"):
        assert prov.get(key) not in (None, ""), key
    assert "jax" not in prov and "jaxlib" not in prov
    if torch.cuda.is_available():
        assert prov["backend"] == "gpu" and prov["device_kind"]
    else:
        assert prov["backend"] == "cpu" and prov["n_devices"] == 0
    assert devledger.runtime_provenance() == prov
