"""The port's EDS caches (celestia_tpu_torch/node/eds_cache.py) against the
JAX package's node/eds_cache.py.

The JAX package's own cases (tests/test_batching.py, TestPagedEdsCache and
TestRaggedCrossHeight) run on the port, and each one's results are held
against the JAX ``PagedEdsCache`` fed the same squares (chain_shares,
extended by the JAX package) in the same order: rows, columns, cells and
whole squares under a one-page budget, ``pages_batch`` over mixed k, the
IndexError, an armed ``cache.faultin`` bitflip (IntegrityError with the
site and the height), ``stats()``, the gauges and the bytes each transfer
site counts. The port's cache runs on the CPU (``device="cpu"``); its pages
are copies of the square, not views of it. Concurrent churn under a
one-page budget never tears a page, and ``ResidentEdsCache`` keeps its pin
and evict contract.
"""

import gc
import random
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from celestia_tpu import da as jax_da
from celestia_tpu import faults as jax_faults
from celestia_tpu.integrity import IntegrityError as JaxIntegrityError
from celestia_tpu.node import eds_cache as jax_eds_cache
from celestia_tpu.telemetry import metrics as jax_metrics
from celestia_tpu.testutil.chaosnet import chain_shares
from celestia_tpu_torch import da, faults
from celestia_tpu_torch.integrity import IntegrityError
from celestia_tpu_torch.node import eds_cache
from celestia_tpu_torch.telemetry import metrics

GAUGES = ("eds_cache_pages_resident", "eds_cache_pin_count", "eds_cache_device_bytes")
SITES = [("eds.row", "d2h"), ("eds.rows_batch", "d2h"), ("eds.col", "d2h"),
         ("eds.share", "d2h"), ("eds.ragged", "d2h"), ("cache.demote", "d2h"),
         ("cache.faultin", "h2d")]


@pytest.fixture(autouse=True, scope="module")
def _collect_jax_caches():
    """The JAX package's caches enrol in its device ledger until they are
    collected (they hold reference cycles): collect them before the next
    module, so none of this module's outlives it."""
    yield
    gc.collect()


def host_eds(k: int, height: int) -> np.ndarray:
    return np.asarray(jax_da.extend_shares(chain_shares(k, height)).data)


class Pair:
    """The JAX cache and the port's, fed the same squares."""

    def __init__(self, **kw):
        self.jax = jax_eds_cache.PagedEdsCache(**kw)
        self.port = eds_cache.PagedEdsCache(device="cpu", **kw)
        self.hosts: dict[int, np.ndarray] = {}

    def put(self, height: int, k: int) -> None:
        host = self.hosts[height] = host_eds(k, height)
        self.jax.put(height, jax_da.ExtendedDataSquare.from_device(
            jax.device_put(host), k))
        self.port.put(height, da.ExtendedDataSquare.from_device(
            torch.from_numpy(host.copy()), k))

    def both(self, fn):
        """fn(cache) on the JAX cache, then on the port's: (theirs, ours),
        and the bytes each transfer site counted meanwhile (equal)."""
        before = [(jax_metrics.get_counter("transfer_bytes", site=s, direction=d),
                   metrics.get_counter("transfer_bytes", site=s, direction=d))
                  for s, d in SITES]
        theirs = fn(self.jax)
        ours = fn(self.port)
        for (s, d), (j0, p0) in zip(SITES, before):
            moved_j = jax_metrics.get_counter("transfer_bytes", site=s, direction=d) - j0
            moved_p = metrics.get_counter("transfer_bytes", site=s, direction=d) - p0
            assert moved_p == moved_j, f"{s} {d}: the port moved {moved_p}, JAX {moved_j}"
        return theirs, ours

    def assert_same_state(self) -> None:
        assert self.port.stats() == self.jax.stats()
        assert self.port.device_bytes() == self.jax.device_bytes()
        for g in GAUGES:
            assert metrics.get_gauge(g) == jax_metrics.get_gauge(g), g


def one_page_pair(k: int = 4, rows_per_page: int = 2, heights=(1,)) -> Pair:
    page_bytes = rows_per_page * 2 * k * 512
    pair = Pair(rows_per_page=rows_per_page, device_byte_budget=page_bytes,
                max_heights=len(heights))
    for h in heights:
        pair.put(h, k)
    return pair


def test_reads_byte_identical_under_one_page_budget():
    pair = one_page_pair()
    pair.assert_same_state()
    host = pair.hosts[1]
    w = host.shape[0]
    oracle = jax_da.ExtendedDataSquare(host, w // 2)
    for i in range(w):
        theirs, ours = pair.both(lambda c: c.get(1).row(i))
        assert ours == theirs == oracle.row(i)
        pair.assert_same_state()
    for j in range(0, w, 3):
        theirs, ours = pair.both(lambda c: c.get(1).col(j))
        assert ours == theirs == oracle.col(j)
    theirs, ours = pair.both(lambda c: c.get(1).share(3, 5))
    assert ours == theirs == oracle.share(3, 5)
    theirs, ours = pair.both(lambda c: c.get(1).rows_batch([5, 0, 5, 7]))
    assert ours == theirs == [oracle.row(5), oracle.row(0), oracle.row(5), oracle.row(7)]
    pair.assert_same_state()
    theirs, ours = pair.both(lambda c: c.get(1).data)
    assert ours.tobytes() == np.asarray(theirs).tobytes() == host.tobytes()
    st = pair.port.stats()
    # a one-page budget over a 4-page square churned, and every fault-in
    # passed its checksum
    assert st["page_demotes"] > 0 and st["page_faultins"] > 0 and st["page_corrupt"] == 0
    assert st["device_bytes"] <= st["device_byte_budget"]
    assert st["page_store_loads"] == st["page_spills"] == st["heights_from_store"] == 0
    pair.assert_same_state()


def test_roots_match_jax():
    pair = one_page_pair()
    theirs, ours = pair.both(lambda c: c.get(1).row_roots())
    assert ours == theirs
    theirs, ours = pair.both(lambda c: c.get(1).col_roots())
    assert ours == theirs


def test_pages_are_copies_not_views():
    host = host_eds(4, 1)
    square = torch.from_numpy(host.copy())
    cache = eds_cache.PagedEdsCache(rows_per_page=2, device="cpu")
    cache.put(1, da.ExtendedDataSquare.from_device(square, 4))
    paged = cache.get(1)
    ptr = square.untyped_storage().data_ptr()
    assert len(paged.pages) == 4
    for page in paged.pages:
        assert page.dev.untyped_storage().data_ptr() != ptr
        assert page.dev.is_contiguous()
        assert page.dev.untyped_storage().nbytes() == page.nbytes
    square.zero_()  # the caller's square is not the cache's
    assert paged.row(3) == [host[3, j].tobytes() for j in range(8)]


def test_invalidate_drops_height():
    pair = one_page_pair()
    assert 1 in pair.port
    pair.both(lambda c: c.invalidate(1))
    assert 1 not in pair.port and pair.port.stats()["pages"] == 0
    pair.assert_same_state()


def test_armed_faultin_bitflip_is_detected_like_jax():
    pair = one_page_pair()
    w = pair.hosts[1].shape[0]
    errors = []
    for flt, err_type, cache in ((jax_faults, JaxIntegrityError, pair.jax),
                                 (faults, IntegrityError, pair.port)):
        with flt.inject(flt.rule("cache.faultin", "bitflip"), seed=5):
            with pytest.raises(err_type) as exc:
                for i in range(w):  # some read faults a page in
                    cache.get(1).row(i)
        errors.append(exc.value)
    theirs, ours = errors
    assert ours.site == theirs.site == "cache.faultin"
    assert ours.height == theirs.height == 1
    assert str(ours) == str(theirs)
    assert pair.port.stats()["page_corrupt"] >= 1
    pair.assert_same_state()


def test_concurrent_churn_never_tears_a_page():
    heights = (1, 2, 3)
    pair = one_page_pair(k=4, heights=heights)
    cache = pair.port
    oracles = {h: jax_da.ExtendedDataSquare(pair.hosts[h], 4) for h in heights}
    failures: list = []

    def sampler(seed):
        rng = random.Random(seed)
        for n in range(40):
            h = rng.choice(heights)
            w = oracles[h].width
            i, j = rng.randrange(w), rng.randrange(w)
            if n % 4 == 0:  # a ragged group across heights now and then
                hs = [rng.choice(heights) for _ in range(3)]
                got = cache.pages_batch([(cache.get(g), i) for g in hs])
                want = [oracles[g].row(i) for g in hs]
            else:
                got, want = cache.get(h).share(i, j), oracles[h].share(i, j)
            if got != want:
                failures.append((h, i, j))

    threads = [threading.Thread(target=sampler, args=(s,)) for s in range(12)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    st = cache.stats()
    assert not failures
    assert st["page_corrupt"] == 0 and st["pin_count"] == 0
    assert st["page_demotes"] > 0  # the budget forced churn
    page_bytes = 2 * 8 * 512
    assert st["device_bytes"] <= st["device_byte_budget"] + page_bytes


HEIGHT_KS = ((1, 2), (2, 8), (3, 32))


def mixed_pair(rows_per_page: int = 4, budget: int = 1 << 30) -> Pair:
    pair = Pair(rows_per_page=rows_per_page, device_byte_budget=budget)
    for h, k in HEIGHT_KS:
        pair.put(h, k)
    return pair


def wants_for(cache, hosts) -> list:
    """Mixed-height, mixed-k rows interleaved in one group, with a
    duplicate (the same height and row twice)."""
    wants = []
    for h, host in hosts.items():
        w = host.shape[0]
        for i in (0, w - 1, 1, 0):
            wants.append((cache.get(h), i))
    return wants


def test_pages_batch_mixed_k_parity_with_jax_and_rows_batch():
    pair = mixed_pair()
    legacy = mixed_pair()  # a second pair in the same fresh state
    theirs, ours = pair.both(lambda c: c.pages_batch(wants_for(c, pair.hosts)))
    ragged_bytes = metrics.get_counter("transfer_bytes", site="eds.ragged", direction="d2h")
    rows0 = sum(metrics.get_counter("transfer_bytes", site=s, direction="d2h")
                for s in ("eds.rows_batch", "eds.row"))
    per_height = {h: legacy.port.get(h).rows_batch([0, host.shape[0] - 1, 1, 0])
                  for h, host in legacy.hosts.items()}
    rows_moved = sum(metrics.get_counter("transfer_bytes", site=s, direction="d2h")
                     for s in ("eds.rows_batch", "eds.row")) - rows0
    assert ours == theirs
    flat = [cells for h in legacy.hosts for cells in per_height[h]]
    assert ours == flat
    unique_rows = sum(3 * host.shape[0] * 512 for host in pair.hosts.values())
    assert rows_moved == unique_rows and ragged_bytes > 0
    pair.assert_same_state()
    # the row memo answers the same group again without a gather
    theirs, ours = pair.both(lambda c: c.pages_batch(wants_for(c, pair.hosts)))
    assert ours == theirs == flat


def test_pages_batch_rejects_out_of_range_row():
    pair = mixed_pair()
    for cache in (pair.jax, pair.port):
        paged = cache.get(1)
        with pytest.raises(IndexError):
            cache.pages_batch([(paged, paged.width)])


def test_armed_faultin_bitflip_in_ragged_gather_heals():
    heights = (1, 2, 3)
    pair = one_page_pair(k=4, heights=heights)

    def wants(cache):
        return [(cache.get(h), i) for h in heights for i in range(8)]

    errors = []
    for flt, err_type, cache in ((jax_faults, JaxIntegrityError, pair.jax),
                                 (faults, IntegrityError, pair.port)):
        with flt.inject(flt.rule("cache.faultin", "bitflip", times=1), seed=5):
            with pytest.raises(err_type) as exc:
                cache.pages_batch(wants(cache))
        errors.append(exc.value)
    theirs, ours = errors
    assert ours.site == "cache.faultin" and ours.height == theirs.height in heights
    pair.assert_same_state()
    # the heal: drop the named height, put it again, answer the same group
    pair.both(lambda c: c.invalidate(ours.height))
    assert ours.height not in pair.port
    pair.put(ours.height, 4)
    theirs_rows, ours_rows = pair.both(lambda c: c.pages_batch(wants(c)))
    assert ours_rows == theirs_rows == [
        [pair.hosts[h][i, j].tobytes() for j in range(8)] for h in heights for i in range(8)]
    pair.assert_same_state()


def test_resident_cache_pin_and_evict_contract():
    caches = (jax_eds_cache.ResidentEdsCache(capacity=2), eds_cache.ResidentEdsCache(capacity=2))
    for cache in caches:
        cache.put(1, "a")
        cache.put(2, "b")
        with cache.pinned(1) as v:
            assert v == "a" and cache.pin_count(1) == 1
            cache.put(3, "c")  # over capacity: 2, not the pinned 1, goes
            assert 1 in cache and 2 not in cache and 3 in cache
            cache.put(4, "d")  # 3 goes; 1 stays pinned, one over capacity
            assert len(cache) == 2 and 1 in cache and 4 in cache
            with cache.pinned(4):
                cache.put(5, "e")  # 1 and 4 pinned: the new entry is the victim
                assert 5 not in cache and len(cache) == 2
        assert len(cache) == 2 and cache.pin_count(1) == 0
        cache.put(6, "f")  # 1, the oldest, unpinned now, goes
        assert 1 not in cache and 4 in cache and cache.get(6) == "f"
        with cache.pinned(9) as missing:
            assert missing is None
    theirs, ours = caches
    assert ours.stats() == theirs.stats()
    for g in GAUGES[:2]:
        assert metrics.get_gauge(g) == jax_metrics.get_gauge(g)


def test_pin_count_equal_jax():
    """PagedEdsCache.pin_count: a height's pins and its pages' pins, on the
    same puts, pins and reads as the JAX cache."""
    pair = Pair(rows_per_page=2, max_heights=2)
    pair.put(1, 4)
    pair.put(2, 4)
    for cache in (pair.jax, pair.port):
        assert cache.pin_count(1) == cache.pin_count(2) == cache.pin_count(9) == 0
    for cache in (pair.jax, pair.port):
        with cache.pinned(1):
            with cache.pinned(1):
                assert cache.pin_count(1) == 2 and cache.pin_count(2) == 0
            page = cache.get(2).pages[1]
            cache._pin_resident(page)
            assert cache.pin_count(2) == 1 and cache.pin_count(1) == 1
            cache._unpin(page)
        cache.get(2).row(3)  # a read pins and unpins its page
        assert cache.pin_count(1) == cache.pin_count(2) == 0
    pair.assert_same_state()


def test_flattened_shares_equal_jax():
    """PagedEds.flattened_shares: every cell row-major, as the JAX handle's,
    under a one-page budget (the square is assembled from every page)."""
    pair = one_page_pair(heights=(1,))
    theirs, ours = pair.both(lambda c: c.get(1).flattened_shares())
    host = pair.hosts[1]
    w = host.shape[0]
    assert ours == theirs == [host[i, j].tobytes() for i in range(w) for j in range(w)]
    pair.assert_same_state()


def test_resident_device_bytes_equal_jax():
    """ResidentEdsCache.device_bytes: the device bytes of every retained
    square; entries without a device buffer count zero."""
    caches = (jax_eds_cache.ResidentEdsCache(capacity=3), eds_cache.ResidentEdsCache(capacity=3))
    host = host_eds(2, 1)
    jax_cache, port_cache = caches
    assert jax_cache.device_bytes() == port_cache.device_bytes() == 0
    jax_cache.put(1, jax_da.ExtendedDataSquare.from_device(jax.device_put(host), 2))
    port_cache.put(1, da.ExtendedDataSquare.from_device(torch.from_numpy(host.copy()), 2))
    for cache in caches:
        cache.put(2, "opaque")
        cache.put(3, da.ExtendedDataSquare(host, 2, "cpu"))  # host bytes only
    assert jax_cache.device_bytes() == port_cache.device_bytes() == host.nbytes
    for cache in caches:
        cache.put(4, "evicts 1")
    assert jax_cache.device_bytes() == port_cache.device_bytes() == 0


# ---------------------------------------------------------------------- #
# the third tier: a BlockStore below the host copies


class StorePair(Pair):
    """The JAX cache over a JAX BlockStore and the port's over the port's,
    in two directories holding byte-identical files."""

    def __init__(self, tmp_path, **kw):
        from celestia_tpu.store import BlockStore as JaxBlockStore
        from celestia_tpu_torch.store import BlockStore

        self.jax_store = JaxBlockStore(tmp_path / "jax")
        self.port_store = BlockStore(tmp_path / "port")
        self.jax = jax_eds_cache.PagedEdsCache(store=self.jax_store, **kw)
        self.port = eds_cache.PagedEdsCache(store=self.port_store, device="cpu", **kw)
        self.hosts: dict[int, np.ndarray] = {}

    def persist(self, height: int, k: int, rows_per_page: int, host=None) -> None:
        """The same square into both stores (a chain_shares square unless
        ``host`` is given)."""
        host = self.hosts.setdefault(height, host_eds(k, height)) if host is None else host
        dah = jax_da.new_data_availability_header(jax_da.ExtendedDataSquare(host, k)).to_json()
        for s in (self.jax_store, self.port_store):
            s.put_eds(height, host, k, dah_doc=dah, rows_per_page=rows_per_page)
        assert ((self.jax_store.root / f"{height}.ctps").read_bytes()
                == (self.port_store.root / f"{height}.ctps").read_bytes())

    def assert_same_state(self) -> None:
        super().assert_same_state()
        ours, theirs = self.port_store.stats(), self.jax_store.stats()
        ours.pop("root"), theirs.pop("root")
        assert ours == theirs


STORE_COUNTERS = ("eds_cache_height_store_load_total", "eds_cache_page_store_load_total",
                  "eds_cache_page_spill_total")


def store_counter_moves(fn) -> None:
    """fn() moves each store counter of the cache as much in the port's
    registry as in the JAX package's."""
    before = [(jax_metrics.get_counter(n), metrics.get_counter(n)) for n in STORE_COUNTERS]
    fn()
    for n, (j0, p0) in zip(STORE_COUNTERS, before):
        assert metrics.get_counter(n) - p0 == jax_metrics.get_counter(n) - j0, n


def test_load_from_store_faults_pages_in_like_jax(tmp_path):
    pair = StorePair(tmp_path, rows_per_page=2)

    def run():
        pair.persist(1, 4, 2)
        theirs, ours = pair.both(lambda c: c.load_from_store(1))
        assert ours.rows_per_page == 2 and ours.original_width == 4
        st = pair.port.stats()
        assert st["pages_on_disk"] == st["pages"] == 4 and st["heights_from_store"] == 1
        oracle = jax_da.ExtendedDataSquare(pair.hosts[1], 4)
        for i in range(8):
            theirs, ours = pair.both(lambda c: c.get(1).row(i))
            assert ours == theirs == oracle.row(i)
        pair.assert_same_state()
        assert pair.port.stats()["page_store_loads"] == 4
        assert pair.port_store.stats()["page_reads"] == 4

    store_counter_moves(run)


def test_host_budget_spills_then_refaults_like_jax(tmp_path):
    page = 2 * 8 * 512
    pair = StorePair(tmp_path, rows_per_page=2, device_byte_budget=page, host_byte_budget=page)

    def run():
        pair.persist(1, 4, 2)
        pair.put(1, 4)  # the device square: pages demote, then spill to disk
        oracle = jax_da.ExtendedDataSquare(pair.hosts[1], 4)
        for _ in range(2):  # the second pass faults the spilled pages back in
            for i in range(8):
                theirs, ours = pair.both(lambda c: c.get(1).row(i))
                assert ours == theirs == oracle.row(i)
        st = pair.port.stats()
        assert st["page_spills"] > 0 and st["page_store_loads"] > 0 and st["page_corrupt"] == 0
        assert st["host_bytes"] <= st["host_byte_budget"]
        pair.assert_same_state()

    store_counter_moves(run)


def test_unpersisted_pages_never_spill(tmp_path):
    page = 2 * 8 * 512
    pair = StorePair(tmp_path, rows_per_page=2, device_byte_budget=page, host_byte_budget=0)
    pair.put(1, 4)  # not in either store: its host copies are the only copies
    for i in range(8):
        pair.both(lambda c: c.get(1).row(i))
    st = pair.port.stats()
    assert st["page_spills"] == 0 and st["host_bytes"] > st["host_byte_budget"]
    pair.assert_same_state()


def test_disk_rot_refused_through_cache_like_jax(tmp_path):
    pair = StorePair(tmp_path, rows_per_page=2)
    pair.persist(1, 4, 2)
    for s in (pair.jax_store, pair.port_store):
        e = s.entry(1)
        with open(e.path, "r+b") as f:
            f.seek(e.page_offset(0) + 16)
            f.write(b"\x00\xff")
    pair.both(lambda c: c.load_from_store(1))
    with pytest.raises(JaxIntegrityError) as theirs:
        pair.jax.get(1).row(0)
    with pytest.raises(IntegrityError) as ours:
        pair.port.get(1).row(0)
    assert ours.value.site == theirs.value.site == "store.read"
    assert ours.value.height == 1  # the port names the height (a ragged group heals only it)
    pair.assert_same_state()


def test_stamped_crc_checked_after_the_record_crc(tmp_path):
    """A spilled page read back from a store whose record is sound but is
    not the page that was stamped (the height re-put with other bytes) is
    refused at cache.faultin, as the JAX cache refuses it."""
    page = 2 * 8 * 512
    pair = StorePair(tmp_path, rows_per_page=2, device_byte_budget=page, host_byte_budget=0)
    pair.persist(1, 4, 2)
    pair.put(1, 4)
    pair.both(lambda c: c.get(1).row(7))  # the other pages demote and spill
    assert pair.port.stats()["page_spills"] > 0
    other = host_eds(4, 9)
    pair.persist(1, 4, 2, host=other)
    errors = []
    for err_type, cache in ((JaxIntegrityError, pair.jax), (IntegrityError, pair.port)):
        with pytest.raises(err_type) as exc:
            cache.get(1).row(0)
        errors.append(exc.value)
    theirs, ours = errors
    assert ours.site == theirs.site == "cache.faultin"
    assert ours.height == theirs.height == 1 and str(ours) == str(theirs)


def test_load_from_store_keeps_the_stores_geometry(tmp_path):
    """A height stored with 2-row pages in a cache of 4-row pages keeps its
    geometry; a group over it and a height put in the cache spans both
    geometries and equals the JAX cache's answer."""
    pair = StorePair(tmp_path, rows_per_page=4)
    pair.persist(1, 4, 2)
    pair.put(2, 8)
    pair.both(lambda c: c.load_from_store(1))
    assert pair.port.get(1).rows_per_page == 2 and pair.port.get(2).rows_per_page == 4

    def wants(cache):
        return [(cache.get(1), i) for i in (0, 7, 3)] + [(cache.get(2), i) for i in (15, 0, 9)]

    theirs, ours = pair.both(lambda c: c.pages_batch(wants(c)))
    assert ours == theirs == (
        [[pair.hosts[1][i, j].tobytes() for j in range(8)] for i in (0, 7, 3)]
        + [[pair.hosts[2][i, j].tobytes() for j in range(16)] for i in (15, 0, 9)])
    pair.assert_same_state()


def test_load_from_store_refusals_equal_jax(tmp_path):
    bare_jax = jax_eds_cache.PagedEdsCache()
    bare = eds_cache.PagedEdsCache(device="cpu")
    for cache in (bare_jax, bare):
        with pytest.raises(RuntimeError, match="no BlockStore attached"):
            cache.load_from_store(1)
    pair = StorePair(tmp_path)
    for cache in (pair.jax, pair.port):
        with pytest.raises(KeyError):
            cache.load_from_store(5)
    assert pair.port.stats()["heights_from_store"] == 0
    bare.put(1, da.ExtendedDataSquare.from_device(torch.from_numpy(host_eds(2, 1).copy()), 2))
    bare._pages[0].dev = None  # no host copy either, and no store to read
    with pytest.raises(RuntimeError, match="no BlockStore is attached"):
        bare.get(1).row(0)
