"""Pin-guarded EDS caches: the whole-square LRU and the paged device cache
(port of the JAX package's node/eds_cache.py, its device, host and disk
tiers).

``ResidentEdsCache`` is the pin-guarded whole-square LRU: readers borrow
entries through ``pinned(height)``, and eviction skips pinned entries
until their pin count drops to zero, so an eviction never interleaves with
a read. It stays for embedders that want whole squares resident.

``PagedEdsCache`` is the cache a node serves from: an extended square is
stored as row-group pages (8 rows each by default, the paged KV cache's
shape) under a device-byte budget. Hot pages stay on the card; cold pages
demote to host copies (CRC32C stamped at the device source) and fault back
in on access (the checksum checked again before the upload) instead of the
whole square being evicted. A reader pins exactly the page it reads,
demotion skips pinned or in-transition pages, and a page's device buffer
is never replaced in place, so eviction never tears a page under a reader.
The fault sites ``cache.demote`` and ``cache.faultin`` model damage on
each leg; the stored checksum must catch it.

Each page is a buffer of its own, copied out of the square when it is put
(a torch slice would share the whole square's storage: demoting it would
free nothing). A fault-in returns only after its chunked upload has landed.

The third tier is a ``BlockStore`` (``celestia_tpu_torch.store``) under the
host copies. Past ``host_byte_budget`` the coldest host copies of pages
whose height the store holds are dropped (spilled); a later fault-in reads
that one page record back from disk (the record's CRC checked by the
store), then checks it against the page's stamped CRC as every fault-in
does. ``load_from_store(height)`` adopts a persisted height with every page
on disk and the store's own ``rows_per_page``: the restart path. A page
record that fails its CRC raises ``IntegrityError`` at ``store.read``, with
the page's height, so a cross-height group heals only that height. The
fault-in records ``crc`` and ``h2d`` stages (and the store ``disk`` and
``crc``), the ragged gather a ``gather`` stage, in the active stage sink.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading

import numpy as np
import torch

from celestia_tpu_torch import da, faults, integrity, tracing
from celestia_tpu_torch import device as device_mod
from celestia_tpu_torch.ops import ragged, transfers
from celestia_tpu_torch.telemetry import metrics


class ResidentEdsCache:
    """Pin-guarded LRU of retained EDS handles (the 2-deep serving cache
    for device-resident squares)."""

    def __init__(self, capacity: int = 2):
        self.capacity = capacity
        self._entries: collections.OrderedDict[int, object] = collections.OrderedDict()
        self._pins: collections.Counter[int] = collections.Counter()
        self._lock = threading.Lock()

    def get(self, height: int):
        """Unpinned lookup, for callers that only hand the value on.
        Sliced readers use ``pinned``."""
        with self._lock:
            value = self._entries.get(height)
            if value is not None:
                self._entries.move_to_end(height)
            return value

    @contextlib.contextmanager
    def pinned(self, height: int):
        """Borrow the entry for ``height`` (or None on a miss): while the
        context is open the entry cannot be evicted."""
        with self._lock:
            value = self._entries.get(height)
            if value is not None:
                self._entries.move_to_end(height)
                self._pins[height] += 1
        if value is not None:
            self._publish()
        try:
            yield value
        finally:
            if value is not None:
                with self._lock:
                    self._pins[height] -= 1
                    if self._pins[height] <= 0:
                        del self._pins[height]
                    self._evict_locked()  # a deferred eviction lands now
                self._publish()

    def put(self, height: int, value) -> None:
        with self._lock:
            self._entries[height] = value
            self._entries.move_to_end(height)
            self._evict_locked()
        self._publish()

    def _publish(self) -> None:
        """Occupancy and pins, under the gauge names the paged cache
        publishes (one serving cache exists per process)."""
        with self._lock:
            metrics.set_gauge("eds_cache_pages_resident", float(len(self._entries)))
            metrics.set_gauge("eds_cache_pin_count", float(sum(self._pins.values())))

    def _evict_locked(self) -> None:
        while len(self._entries) > self.capacity:
            victim = next((h for h in self._entries if self._pins[h] == 0), None)
            if victim is None:
                return  # everything pinned: defer until a pin drops
            del self._entries[victim]

    def pin_count(self, height: int) -> int:
        with self._lock:
            return self._pins[height]

    def device_bytes(self) -> int:
        """Device bytes of every retained square. Entries without a device
        buffer (host squares, opaque values) count zero."""
        with self._lock:
            total = 0
            for value in self._entries.values():
                dev = getattr(value, "device_data", None)
                total += int(getattr(dev, "nbytes", 0) or 0)
            return total

    def stats(self) -> dict:
        """The ``/status`` "eds_cache" payload (whole-square flavour)."""
        with self._lock:
            return {
                "kind": "resident",
                "heights": len(self._entries),
                "capacity": self.capacity,
                "pin_count": sum(self._pins.values()),
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, height: int) -> bool:
        with self._lock:
            return height in self._entries


# ---------------------------------------------------------------------- #
# the paged device cache


class _Page:
    """One row group of a cached square. Fault-in and demotion change it
    only under the owning cache's condition, with ``busy`` fencing the
    transfer made outside it, so a reader sees the old complete buffer or
    the new complete buffer, never a tear."""

    __slots__ = ("height", "index", "row_lo", "row_hi", "dev", "host",
                 "crc", "pins", "busy", "nbytes", "last_touch")

    def __init__(self, height: int, index: int, row_lo: int, row_hi: int, nbytes: int):
        self.height = height
        self.index = index
        self.row_lo = row_lo
        self.row_hi = row_hi
        self.dev = None    # device buffer when resident
        self.host = None   # host copy when demoted
        self.crc = None    # CRC32C of the host copy, stamped at demotion
        self.pins = 0      # readers currently on this page
        self.busy = False  # a demotion or fault-in transfer in flight
        self.nbytes = int(nbytes)
        self.last_touch = 0


class PagedEds:
    """A cached square exposed page by page, with the read surface of
    ``da.ExtendedDataSquare`` (``original_width``, ``width``, ``row``,
    ``col``, ``share``, ``data``, ``row_roots``, ``col_roots``) and the
    batched ``rows_batch``. Every access pins exactly the pages it reads
    through the owning PagedEdsCache, which handles residency."""

    _ROW_MEMO_CAP = 8  # the burst memo the EDS slice cache provides

    def __init__(self, cache: "PagedEdsCache", height: int, pages: list[_Page],
                 original_width: int, rows_per_page: int | None = None):
        self._cache = cache
        self.height = height
        self.pages = pages
        self.original_width = original_width
        self.rows_per_page = int(rows_per_page or cache.rows_per_page)
        self._row_memo: dict[int, list[bytes]] = {}
        self._memo_lock = threading.Lock()
        self._host_full = None  # the whole square on the host, once read

    @property
    def width(self) -> int:
        return 2 * self.original_width

    @property
    def device_data(self):
        """No whole-square device buffer exists: device readers go through
        the paged accessors."""
        return None

    # -- cell and axis reads -------------------------------------------- #

    def _page_for(self, i: int) -> _Page:
        return self.pages[i // self.rows_per_page]

    def _memo_get(self, i: int):
        with self._memo_lock:
            return self._row_memo.get(i)

    def _memo_put(self, i: int, cells: list[bytes]) -> None:
        with self._memo_lock:
            if len(self._row_memo) >= self._ROW_MEMO_CAP:
                self._row_memo.pop(next(iter(self._row_memo)))
            self._row_memo[i] = cells

    def _host_row(self, i: int) -> list[bytes]:
        return [self._host_full[i, j].tobytes() for j in range(self.width)]

    def row(self, i: int) -> list[bytes]:
        if not (0 <= i < self.width):
            raise IndexError(f"row {i} out of range for width {self.width}")
        hit = self._memo_get(i)
        if hit is not None:
            return hit
        if self._host_full is not None:
            return self._host_row(i)
        page = self._page_for(i)
        dev = self._cache._pin_resident(page)
        try:
            arr = transfers.eds_row(dev, i - page.row_lo)
        finally:
            self._cache._unpin(page)
        cells = [arr[t].tobytes() for t in range(self.width)]
        self._memo_put(i, cells)
        return cells

    def rows_batch(self, indices: list[int]) -> list[list[bytes]]:
        """Several rows, one gather per page (``transfers.eds_rows_batch``),
        byte-identical to per-row ``row()`` calls, in ``indices`` order."""
        out: dict[int, list[bytes]] = {}
        misses: list[int] = []
        for i in sorted(set(indices)):
            if not (0 <= i < self.width):
                raise IndexError(f"row {i} out of range for width {self.width}")
            hit = self._memo_get(i)
            if hit is not None:
                out[i] = hit
            else:
                misses.append(i)
        if misses and self._host_full is not None:
            for i in misses:
                out[i] = self._host_row(i)
            misses = []
        by_page: dict[int, list[int]] = {}
        for i in misses:
            by_page.setdefault(i // self.rows_per_page, []).append(i)
        for page_idx, rows in by_page.items():
            page = self.pages[page_idx]
            dev = self._cache._pin_resident(page)
            try:
                if len(rows) == 1:
                    arrs = [transfers.eds_row(dev, rows[0] - page.row_lo)]
                else:
                    batch = transfers.eds_rows_batch(dev, [i - page.row_lo for i in rows])
                    arrs = [batch[t] for t in range(len(rows))]
            finally:
                self._cache._unpin(page)
            for i, arr in zip(rows, arrs):
                cells = [arr[t].tobytes() for t in range(self.width)]
                out[i] = cells
                self._memo_put(i, cells)
        return [out[i] for i in indices]

    def share(self, r: int, c: int) -> bytes:
        if not (0 <= r < self.width and 0 <= c < self.width):
            raise IndexError(f"share ({r}, {c}) out of range")
        hit = self._memo_get(r)
        if hit is not None:
            return hit[c]
        if self._host_full is not None:
            return self._host_full[r, c].tobytes()
        page = self._page_for(r)
        dev = self._cache._pin_resident(page)
        try:
            return transfers.eds_share(dev, r - page.row_lo, c).tobytes()
        finally:
            self._cache._unpin(page)

    def col(self, j: int) -> list[bytes]:
        """A column crosses every page: one cell gather a page
        (page_rows·B bytes), as many bytes as the whole square's sliced
        column."""
        if not (0 <= j < self.width):
            raise IndexError(f"col {j} out of range for width {self.width}")
        if self._host_full is not None:
            return [self._host_full[i, j].tobytes() for i in range(self.width)]
        cells: list[bytes] = []
        for page in self.pages:
            dev = self._cache._pin_resident(page)
            try:
                arr = transfers.eds_cells_batch(
                    dev, [(lr, j) for lr in range(page.row_hi - page.row_lo)], site="eds.col")
            finally:
                self._cache._unpin(page)
            cells.extend(arr[t].tobytes() for t in range(arr.shape[0]))
        return cells

    # -- whole-square consumers ----------------------------------------- #

    @property
    def data(self) -> np.ndarray:
        """The full host square, assembled once (the consumers that read
        every byte: /eds, the DAH roots); later reads come from the host."""
        if self._host_full is None:
            parts = []
            for page in self.pages:
                dev = self._cache._pin_resident(page)
                try:
                    parts.append(dev.cpu().numpy())
                finally:
                    self._cache._unpin(page)
            self._host_full = np.concatenate(parts, axis=0)
        return self._host_full

    def _materialized(self):
        return da.ExtendedDataSquare(self.data, self.original_width, self._cache.device)

    def row_roots(self) -> list[bytes]:
        return self._materialized().row_roots()

    def col_roots(self) -> list[bytes]:
        return self._materialized().col_roots()

    def flattened_shares(self) -> list[bytes]:
        return self._materialized().flattened_shares()


class PagedEdsCache:
    """Paged device cache for retained extended squares.

    Entries map height -> PagedEds (device squares, paged) or an opaque
    value (host squares and arrays, stored whole). Heights are LRU-bounded
    by ``max_heights`` with ResidentEdsCache's pin-guarded borrow contract;
    device residency is page-granular under ``device_byte_budget``: past
    the budget the globally coldest unpinned page demotes to a host copy,
    and demoted pages fault back in on access. The budget is soft by one
    in-flight page: a fault-in uploads before it demotes, and a pinned
    page is never demoted, so a burst that pins everything overshoots
    instead of deadlocking.

    ``store``: a ``BlockStore`` below the host tier (None: two tiers). Host
    copies of store-persisted pages spill to disk past ``host_byte_budget``.
    ``device``: where pages live and fault in (None means CUDA, as for
    every entry of the port)."""

    DEFAULT_ROWS_PER_PAGE = 8
    DEFAULT_DEVICE_BYTE_BUDGET = 128 << 20
    DEFAULT_MAX_HEIGHTS = 4
    DEFAULT_HOST_BYTE_BUDGET = 512 << 20

    def __init__(self, rows_per_page: int | None = None,
                 device_byte_budget: int | None = None,
                 max_heights: int | None = None, store=None,
                 host_byte_budget: int | None = None, device=None):
        self.device = device_mod.resolve(device)
        self.rows_per_page = int(rows_per_page or self.DEFAULT_ROWS_PER_PAGE)
        self.device_byte_budget = int(
            device_byte_budget if device_byte_budget is not None
            else self.DEFAULT_DEVICE_BYTE_BUDGET)
        self.max_heights = int(max_heights or self.DEFAULT_MAX_HEIGHTS)
        self.store = store
        self.host_byte_budget = int(
            host_byte_budget if host_byte_budget is not None
            else self.DEFAULT_HOST_BYTE_BUDGET)
        self._entries: collections.OrderedDict[int, object] = collections.OrderedDict()
        self._height_pins: collections.Counter[int] = collections.Counter()
        self._pages: list[_Page] = []  # every tracked page, all heights
        self._cond = threading.Condition()
        self._tick = itertools.count(1)
        self.stats_counters = collections.Counter()  # hits, misses, ...

    # -- the ResidentEdsCache-compatible height surface ----------------- #

    def get(self, height: int):
        with self._cond:
            value = self._entries.get(height)
            if value is not None:
                self._entries.move_to_end(height)
            return value

    @contextlib.contextmanager
    def pinned(self, height: int):
        """Borrow the entry for ``height`` (or None on a miss): while the
        context is open the height cannot be evicted (its pages may still
        demote and fault in underneath; per-page pins keep each read
        safe)."""
        with self._cond:
            value = self._entries.get(height)
            if value is not None:
                self._entries.move_to_end(height)
                self._height_pins[height] += 1
        try:
            yield value
        finally:
            if value is not None:
                with self._cond:
                    self._height_pins[height] -= 1
                    if self._height_pins[height] <= 0:
                        del self._height_pins[height]
                    self._evict_heights_locked()

    def put(self, height: int, value) -> None:
        """Insert a retained square. A device-resident ``ExtendedDataSquare``
        is split into row-group pages, each copied into a buffer of its own
        on the cache's device (the whole square is not kept: once the
        caller drops it, only the pages stay resident); anything else is
        stored opaque."""
        paged = self._page_value(height, value)
        with self._cond:
            if height in self._entries:
                self._drop_pages_locked(height)
            self._entries[height] = paged
            self._entries.move_to_end(height)
            if isinstance(paged, PagedEds):
                self._pages.extend(paged.pages)
            self._evict_heights_locked()
            self._publish_locked()
        self._demote_to_budget()

    def _page_value(self, height: int, value):
        dev = getattr(value, "device_data", None)
        if dev is None:
            return value
        width = int(dev.shape[0])
        cell_nbytes = int(np.prod(dev.shape[1:])) * dev.element_size()
        rpp = self.rows_per_page
        pages: list[_Page] = []
        for index, lo in enumerate(range(0, width, rpp)):
            hi = min(lo + rpp, width)
            page = _Page(height, index, lo, hi, (hi - lo) * cell_nbytes)
            page.dev = dev[lo:hi].to(self.device, copy=True).contiguous()
            page.last_touch = next(self._tick)
            pages.append(page)
        return PagedEds(self, height, pages, getattr(value, "original_width", width // 2))

    def load_from_store(self, height: int) -> PagedEds:
        """Adopt a persisted height from the attached BlockStore without
        touching the device: every page starts on disk (no device buffer,
        no host copy, the CRC of its store record) and faults in on first
        read, and the PagedEds keeps the store's ``rows_per_page``. The
        restart path: a re-indexed node serves its history page by page
        instead of extending the square again. KeyError when the store
        does not hold the height."""
        if self.store is None:
            raise RuntimeError("no BlockStore attached")
        entry = self.store.entry(height)
        if entry is None:
            raise KeyError(f"height {height} not in store")
        crcs = self.store.page_crcs(height)
        width = 2 * entry.k
        pages: list[_Page] = []
        for index in range(entry.page_count):
            lo = index * entry.rows_per_page
            hi = min(lo + entry.rows_per_page, width)
            page = _Page(height, index, lo, hi, (hi - lo) * width * entry.share_size)
            page.crc = crcs[index]
            page.last_touch = next(self._tick)
            pages.append(page)
        paged = PagedEds(self, height, pages, entry.k, rows_per_page=entry.rows_per_page)
        with self._cond:
            if height in self._entries:
                self._drop_pages_locked(height)
            self._entries[height] = paged
            self._entries.move_to_end(height)
            self._pages.extend(pages)
            self.stats_counters["heights_from_store"] += 1
            self._evict_heights_locked()
            self._publish_locked()
        metrics.incr_counter("eds_cache_height_store_load_total")
        return paged

    def _drop_pages_locked(self, height: int) -> None:
        self._pages = [p for p in self._pages if p.height != height]

    def _evict_heights_locked(self) -> None:
        while len(self._entries) > self.max_heights:
            victim = next((h for h in self._entries if self._height_pins[h] == 0), None)
            if victim is None:
                # everything borrowed: defer until a pin drops (break, so the
                # evictions already made still reach the gauges)
                break
            del self._entries[victim]
            self._drop_pages_locked(victim)
        self._publish_locked()

    def invalidate(self, height: int) -> None:
        """Drop a height outright (a reader found a corrupt page: the cache
        is a cache)."""
        with self._cond:
            if height in self._entries:
                del self._entries[height]
                self._drop_pages_locked(height)
                self._publish_locked()

    def pages_batch(self, wants: list) -> list:
        """Cross-height ragged row fetch: resolve each ``(PagedEds, row)``
        want against its instance's page table, pin every referenced page
        across heights in one pass, and answer the group with one ragged
        gather (``ops.ragged.gather_rows``): one kernel launch per page
        geometry instead of a read per height.

        Byte-identical to per-instance ``PagedEds.rows_batch`` calls, the
        row memo and the transfer accounting included; returns the rows
        (as cell lists) aligned with ``wants``."""
        out: list = [None] * len(wants)
        misses: list[int] = []
        for t, (paged, i) in enumerate(wants):
            i = int(i)
            if not (0 <= i < paged.width):
                raise IndexError(f"row {i} out of range for width {paged.width}")
            hit = paged._memo_get(i)
            if hit is not None:
                out[t] = hit
            elif paged._host_full is not None:
                out[t] = paged._host_row(i)
            else:
                misses.append(t)
        if not misses:
            return out
        # identical (instance, row) wants share one descriptor
        uniq: dict[tuple[int, int], list[int]] = {}
        for t in misses:
            paged, i = wants[t]
            uniq.setdefault((id(paged), int(i)), []).append(t)
        keys = list(uniq)
        pinned: list[_Page] = []
        dev_of: dict[int, torch.Tensor] = {}
        try:
            descs = []
            for key in keys:
                paged, i = wants[uniq[key][0]]
                i = int(i)
                page = paged._page_for(i)
                dev = dev_of.get(id(page))
                if dev is None:
                    dev = self._pin_resident(page)
                    pinned.append(page)
                    dev_of[id(page)] = dev
                descs.append((dev, i - page.row_lo, paged.width))
            with tracing.stage("gather"):
                arrs = ragged.gather_rows(descs)
        finally:
            for page in pinned:
                self._unpin(page)
        for key, arr in zip(keys, arrs):
            members = uniq[key]
            paged, i = wants[members[0]]
            cells = [arr[t].tobytes() for t in range(paged.width)]
            paged._memo_put(int(i), cells)
            for t in members:
                out[t] = cells
        return out

    def pin_count(self, height: int) -> int:
        """Readers holding ``height``: its height pins and its pages' pins."""
        with self._cond:
            pages = sum(p.pins for p in self._pages if p.height == height)
            return self._height_pins[height] + pages

    def __len__(self) -> int:
        with self._cond:
            return len(self._entries)

    def __contains__(self, height: int) -> bool:
        with self._cond:
            return height in self._entries

    # -- page residency ------------------------------------------------- #

    def _pin_resident(self, page: _Page) -> torch.Tensor:
        """Pin ``page`` and return its device buffer, faulting the page in
        from its host copy first when demoted. The buffer is never written
        and the pin blocks demotion, so the caller may read it outside the
        lock until ``_unpin``."""
        with self._cond:
            while page.busy:
                self._cond.wait()
            page.last_touch = next(self._tick)
            if page.dev is not None:
                page.pins += 1
                self.stats_counters["page_hits"] += 1
                self._publish_locked()
                metrics.incr_counter("eds_cache_page_hits_total")
                return page.dev
            # demoted: this reader faults it in; ``busy`` makes every other
            # reader of the page wait for it
            page.busy = True
            self.stats_counters["page_misses"] += 1
            metrics.incr_counter("eds_cache_page_miss_total")
        try:
            dev = self._fault_in(page)
        except BaseException:
            with self._cond:
                page.busy = False
                self._cond.notify_all()
            raise
        with self._cond:
            page.dev = dev
            page.busy = False
            page.pins += 1
            page.last_touch = next(self._tick)
            self.stats_counters["page_faultins"] += 1
            metrics.incr_counter("eds_cache_page_faultin_total")
            self._publish_locked()
            self._cond.notify_all()
        self._demote_to_budget()
        return dev

    def _unpin(self, page: _Page) -> None:
        with self._cond:
            page.pins -= 1
            self._publish_locked()
            self._cond.notify_all()
        self._demote_to_budget()

    def _fault_in(self, page: _Page) -> torch.Tensor:
        """Upload a demoted page, integrity-checked: the host copy must
        still match the CRC32C stamped at demotion (bit rot or an armed
        ``cache.faultin`` bitflip both raise IntegrityError, counted and
        recorded as an SDC event, with the site and the height). A page
        with no host copy (spilled, or adopted by ``load_from_store``) is
        read back from the store first: ``read_page`` checks the record's
        CRC, and the check below holds it to the page's stamped CRC, so a
        rotted record never reaches the device."""
        host = page.host
        if host is None:
            if self.store is None:
                raise RuntimeError(
                    f"page (height={page.height} page={page.index}) has no host copy "
                    f"and no BlockStore is attached")
            try:
                host, crc = self.store.read_page(page.height, page.index)
            except integrity.IntegrityError as err:
                # the height lets a cross-height group heal only this member
                err.height = page.height
                raise
            if page.crc is None:
                page.crc = crc  # busy-fenced: only this reader writes it
            with self._cond:
                self.stats_counters["page_store_loads"] += 1
            metrics.incr_counter("eds_cache_page_store_load_total")
        flip = faults.fire("cache.faultin", height=page.height, page=page.index)
        if flip is not None:
            host = flip(host)
        with tracing.stage("crc"):
            bad = integrity.crc32c(host) != page.crc
        if bad:
            integrity.record_sdc("cache.faultin")
            # the fault-in runs outside the condition (the transfer must not
            # serialize readers); the shared counter goes back under it
            with self._cond:
                self.stats_counters["page_corrupt"] += 1
            metrics.incr_counter("eds_cache_page_corrupt_total")
            err = integrity.IntegrityError(
                f"page checksum mismatch on fault-in "
                f"(height={page.height} page={page.index})")
            err.site = "cache.faultin"
            # the height lets a cross-height group heal only this member
            err.height = page.height
            raise err
        dev = transfers.device_put_chunked(host, self.device, site="cache.faultin")
        if dev.device.type == "cuda":
            # the chunks ride the copy stream: wait until they have landed,
            # so ``busy`` fences the whole transition and no reader on
            # another stream or thread reads a page still arriving
            transfers._copy_stream(dev.device).synchronize()
        return dev

    def _demote_to_budget(self) -> None:
        """Demote the globally coldest unpinned pages until the device bytes
        fit the budget. Each demotion fetches outside the lock with
        ``busy`` fencing the page, stamps the host copy's CRC32C at the
        device source, then swaps device for host under the lock; a reader
        mid-read holds a pin, so its buffer is never the victim. Then host
        copies spill to the store past their own budget."""
        while True:
            with self._cond:
                if self._device_bytes_locked() <= self.device_byte_budget:
                    break
                victim = None
                for p in self._pages:
                    if p.dev is None or p.pins > 0 or p.busy:
                        continue
                    if victim is None or p.last_touch < victim.last_touch:
                        victim = p
                if victim is None:
                    break  # everything pinned or busy: soft overshoot
                victim.busy = True
                dev = victim.dev
            try:
                host, crc = self._demote(victim, dev)
            except BaseException:
                with self._cond:
                    victim.busy = False
                    self._cond.notify_all()
                raise
            with self._cond:
                victim.host = host
                victim.crc = crc
                victim.dev = None
                victim.busy = False
                self.stats_counters["page_demotes"] += 1
                metrics.incr_counter("eds_cache_page_demote_total")
                self._publish_locked()
                self._cond.notify_all()
        self._spill_to_budget()

    def _spill_to_budget(self) -> None:
        """The third tier's spill: drop host copies of STORE-PERSISTED pages
        until the host bytes fit ``host_byte_budget``. The page keeps its
        CRC: a later fault-in reads the record back from the store and
        checks it against that CRC. Pages of a height the store does not
        hold never spill (their host copy is the only copy)."""
        if self.store is None:
            return
        while True:
            with self._cond:
                host_bytes = sum(p.nbytes for p in self._pages
                                 if p.host is not None and p.dev is None)
                if host_bytes <= self.host_byte_budget:
                    return
                victim = None
                for p in self._pages:
                    if p.host is None or p.dev is not None or p.pins > 0 or p.busy:
                        continue
                    if p.height not in self.store:
                        continue
                    if victim is None or p.last_touch < victim.last_touch:
                        victim = p
                if victim is None:
                    return
                victim.host = None
                self.stats_counters["page_spills"] += 1
            metrics.incr_counter("eds_cache_page_spill_total")

    def _demote(self, page: _Page, dev: torch.Tensor):
        host = transfers.device_get_chunked(dev, site="cache.demote")
        # checksum the pristine device source: the fault site models damage
        # on the way down, which the fault-in check must catch
        with tracing.stage("crc"):
            crc = integrity.crc32c(host)
        flip = faults.fire("cache.demote", height=page.height, page=page.index)
        if flip is not None:
            host = flip(host)
        return host, crc

    # -- accounting and observability ----------------------------------- #

    def _device_bytes_locked(self) -> int:
        return sum(p.nbytes for p in self._pages if p.dev is not None)

    def device_bytes(self) -> int:
        """The device footprint (resident pages only), the value of the
        ``eds_cache_device_bytes`` gauge."""
        with self._cond:
            return self._device_bytes_locked()

    def _publish_locked(self) -> None:
        resident = sum(1 for p in self._pages if p.dev is not None)
        pins = sum(p.pins for p in self._pages) + sum(self._height_pins.values())
        metrics.set_gauge("eds_cache_pages_resident", float(resident))
        metrics.set_gauge("eds_cache_pin_count", float(pins))
        metrics.set_gauge("eds_cache_device_bytes", float(self._device_bytes_locked()))

    def stats(self) -> dict:
        """The /status surface: residency, budget and flow counters."""
        with self._cond:
            resident = sum(1 for p in self._pages if p.dev is not None)
            on_host = sum(1 for p in self._pages if p.host is not None and p.dev is None)
            return {
                "kind": "paged",
                "heights": len(self._entries),
                "pages": len(self._pages),
                "pages_resident": resident,
                "pages_demoted": len(self._pages) - resident,
                "pages_on_disk": len(self._pages) - resident - on_host,
                "device_bytes": self._device_bytes_locked(),
                "device_byte_budget": self.device_byte_budget,
                "host_bytes": sum(p.nbytes for p in self._pages
                                  if p.host is not None and p.dev is None),
                "host_byte_budget": self.host_byte_budget,
                "rows_per_page": self.rows_per_page,
                "pin_count": sum(p.pins for p in self._pages)
                + sum(self._height_pins.values()),
                "page_hits": self.stats_counters["page_hits"],
                "page_misses": self.stats_counters["page_misses"],
                "page_demotes": self.stats_counters["page_demotes"],
                "page_faultins": self.stats_counters["page_faultins"],
                "page_corrupt": self.stats_counters["page_corrupt"],
                "page_spills": self.stats_counters["page_spills"],
                "page_store_loads": self.stats_counters["page_store_loads"],
                "heights_from_store": self.stats_counters["heights_from_store"],
            }
