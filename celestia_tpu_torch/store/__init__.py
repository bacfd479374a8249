"""Durable EDS block store, the third tier behind ``PagedEdsCache`` (port of
the JAX package's store/__init__.py; ``specs/store.md`` is the normative
description of the format, and a file either package writes is one the
other reads, byte for byte).

One file per height (``<height>.ctps``) holds the three artifacts a
restarted node needs to serve ``/sample`` and ``/proof/share`` without
extending anything again:

    EDS row-group pages   the paged cache's row-group granularity, at
                          FIXED offsets, so a fault-in reads one page
                          record, never the square
    row-tree levels       the NMT node levels of every row
                          (``extend.eds_row_levels_device``) that seed
                          byte-identical ``NmtRowProver``s after a restart
                          (optional: a height may be persisted without them)
    DAH                   the served DataAvailabilityHeader JSON, so the
                          DAH bytes after a restart equal those before

Every record payload carries its own CRC32C (``integrity.crc32c``, the
cache tiers' engine): a read whose checksum mismatches raises
``IntegrityError`` after ``record_sdc("store.read")``, so torn or rotted
data is never returned. Writes are atomic (temp file, then rename): a crash
mid-put leaves at worst a ``.tmp`` orphan, never a half-indexed height.

Durability contract: in durable mode a put is acknowledged durable only
after the data fsync, the rename and the parent directory's fsync (the
dirsync makes the rename itself survive power loss). Every persisted byte
crosses the ``FsShim`` syscall boundary (write, fsync, rename, dirsync,
unlink), which fires the ``store.*`` fault sites and is the powercut
explorer's interposition point (``store/powercut.py``).

Disk faults: an ``OSError`` with ``errno.ENOSPC`` (real or injected
``enospc``) flips the store to STICKY READ-ONLY (``store_read_only`` gauge
1, one warn log, best-effort ``.tmp`` cleanup, optional emergency compact);
later puts are skipped (``store_put_aborted_total{reason=read_only}``), so
the node keeps serving from the cache tiers. Recovery: one put per
``reprobe_interval_s`` runs as the probe, or ``try_recover()`` probes
explicitly.

Re-index (``reindex()``) is how a restarted node adopts the directory:
damaged files (truncated tails, bad headers, CRC-mismatched pages,
duplicate heights) are SKIPPED with a ``store_reindex_skipped_total
{reason=...}`` bump, never a startup crash.

Compaction (``compact()``) evicts whole cold heights to a byte budget,
lowest first, never the newest ``keep_recent``: the index entry goes first
(under ``_index_lock``), the file after. Retained files are never
rewritten. A reader racing an eviction sees the ordinary KeyError miss.

Layout:

    header (64 bytes, fixed):
      magic=CTPS u32-version height k share_size rows_per_page
      page_count dah_len levels_len dah_crc levels_crc page_slot
      header_crc (CRC32C over the preceding 52 bytes)
    DAH JSON bytes        (dah_len,   crc = dah_crc)
    levels blob           (levels_len, crc = levels_crc; 0 = absent)
    page records, fixed offsets:
      record i at  64 + dah_len + levels_len + i * (16 + page_slot)
      record header: nbytes u32, crc u32, reserved u64
      payload: nbytes bytes of row-major uint8 shares, zero-padded to
      page_slot (slot = rows_per_page * 2k * share_size)

Fault sites: ``store.write`` fires once per put before the file lands (a
corrupt or bitflip rule mangles the first page payload AFTER its CRC was
computed, the rot-on-disk drill; a ``short_write`` rule lands a seeded
prefix of the file and fails the put); ``store.read`` fires on every page
read with the bytes in hand (a bitflip mangles them BEFORE the CRC check).
``store.fsync``, ``store.rename``, ``store.dirsync`` and ``store.unlink``
fire inside the ``FsShim`` at the matching syscall.

The levels may be numpy arrays or torch tensors (the port's
``eds_row_levels_device`` returns numpy); their bytes are the same. Page
and levels reads record ``disk`` and ``crc`` stages, and a put its
``crc`` and ``write`` stages, in the active stage sink (``tracing.stage``,
inert without one).
"""

from __future__ import annotations

import contextlib
import dataclasses
import errno
import json
import os
import pathlib
import struct
import threading
import time

from celestia_tpu_torch import faults, tracing
from celestia_tpu_torch.integrity import IntegrityError, crc32c, record_sdc
from celestia_tpu_torch.log import logger
from celestia_tpu_torch.telemetry import metrics

log = logger("store")

MAGIC = b"CTPS"
VERSION = 1
SUFFIX = ".ctps"

_HEADER = struct.Struct("<4sIQIIIIIIIII")  # 52 bytes of fields
_HEADER_CRC = struct.Struct("<I")
HEADER_SIZE = 64  # fields + crc, zero-padded
_RECORD = struct.Struct("<IIQ")  # nbytes, crc, reserved
RECORD_HEADER_SIZE = _RECORD.size

DEFAULT_ROWS_PER_PAGE = 8


@dataclasses.dataclass(frozen=True)
class StoreEntry:
    """One indexed height: everything a fault-in needs to seek straight to
    a page record without reading the header again."""

    path: pathlib.Path
    height: int
    k: int
    share_size: int
    rows_per_page: int
    page_count: int
    page_slot: int
    dah_len: int
    levels_len: int
    dah_crc: int
    levels_crc: int

    @property
    def page_base(self) -> int:
        return HEADER_SIZE + self.dah_len + self.levels_len

    def page_offset(self, index: int) -> int:
        return self.page_base + index * (RECORD_HEADER_SIZE + self.page_slot)

    def page_rows(self, index: int) -> int:
        width = 2 * self.k
        lo = index * self.rows_per_page
        return min(self.rows_per_page, width - lo)


def _pack_header(entry_fields: dict) -> bytes:
    raw = _HEADER.pack(
        MAGIC, VERSION, entry_fields["height"], entry_fields["k"],
        entry_fields["share_size"], entry_fields["rows_per_page"],
        entry_fields["page_count"], entry_fields["dah_len"],
        entry_fields["levels_len"], entry_fields["dah_crc"],
        entry_fields["levels_crc"], entry_fields["page_slot"],
    )
    raw += _HEADER_CRC.pack(crc32c(raw))
    return raw.ljust(HEADER_SIZE, b"\x00")


def _host_uint8(arr):
    """A contiguous uint8 numpy view of a numpy array or a CPU tensor; a
    tensor on a card is refused (the caller fetches at its own site)."""
    import numpy as np

    if hasattr(arr, "detach") and hasattr(arr, "device"):  # a torch tensor
        if arr.device.type != "cpu":
            raise ValueError(f"store bytes must be on the host, got a tensor on {arr.device}")
        arr = arr.detach().contiguous().numpy()
    return np.ascontiguousarray(np.asarray(arr, dtype=np.uint8))


def pack_levels(levels) -> bytes:
    """Serialize the per-height row-tree node levels (one uint8 array of
    90-byte NMT nodes per tree level, leaves first, each (rows, nodes,
    90)): a little-endian u32 count, then per level its u32 (rows, nodes,
    width) and its bytes."""
    out = [struct.pack("<I", len(levels))]
    for lvl in levels:
        arr = _host_uint8(lvl)
        rows, nodes, width = arr.shape
        out.append(struct.pack("<III", rows, nodes, width))
        out.append(arr.tobytes())
    return b"".join(out)


def unpack_levels(blob: bytes):
    import numpy as np

    (count,) = struct.unpack_from("<I", blob, 0)
    off = 4
    levels = []
    for _ in range(count):
        rows, nodes, width = struct.unpack_from("<III", blob, off)
        off += 12
        size = rows * nodes * width
        arr = np.frombuffer(blob, dtype=np.uint8, count=size, offset=off)
        levels.append(arr.reshape(rows, nodes, width).copy())
        off += size
    return levels


class FsShim:
    """Syscall-boundary shim: every byte the store persists crosses one of
    these methods. Each fires its ``store.*`` fault site before touching
    the kernel, so ``enospc``, ``fsync_fail`` and ``short_write`` rules
    strike exactly where a real failure would. It is also the powercut
    explorer's interposition point: ``store/powercut.py`` swaps a
    recording shim onto a store to capture the ordered effect trace."""

    def open_w(self, path, **ctx):
        return open(path, "wb")

    def fsync(self, f, *, path, **ctx) -> None:
        faults.fire("store.fsync", path=str(path), **ctx)
        os.fsync(f.fileno())

    def replace(self, src, dst, **ctx) -> None:
        faults.fire("store.rename", src=str(src), dst=str(dst), **ctx)
        os.replace(src, dst)

    def dirsync(self, dirpath, **ctx) -> None:
        faults.fire("store.dirsync", path=str(dirpath), **ctx)
        fd = os.open(dirpath, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def unlink(self, path, *, missing_ok: bool = True, **ctx) -> None:
        faults.fire("store.unlink", path=str(path), **ctx)
        pathlib.Path(path).unlink(missing_ok=missing_ok)


_FS = FsShim()


class BlockStore:
    """CRC32C-guarded on-disk block store under one directory.

    The index (``_index``, height -> StoreEntry, and the skip counters) is
    guarded by ``_index_lock``, which ranks between the cache locks and
    the leaf locks (``specs/serving.md``). File I/O and CRC math run
    unlocked: records are immutable once renamed into place, so readers
    need only the entry snapshot."""

    def __init__(self, root: str | os.PathLike, *, durable: bool = True,
                 reprobe_interval_s: float = 5.0,
                 emergency_compact_bytes: int | None = None):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        # durable=False skips the per-put fsync AND dirsync (the atomic
        # rename stays, so a torn write still cannot surface): for harnesses
        # writing thousands of heights. A serving node never passes it.
        self.durable = bool(durable)
        self._fs = _FS  # the syscall boundary; powercut.py swaps in a recorder
        # the read-only state machine: _read_only is a GIL-atomic bool read
        # unlocked on hot paths; transitions and the reprobe clock are under
        # _index_lock
        self.reprobe_interval_s = float(reprobe_interval_s)
        self.emergency_compact_bytes = emergency_compact_bytes
        self._read_only = False
        self._read_only_reason: str | None = None
        self._reprobe_after = 0.0
        self._index_lock = threading.Lock()
        self._index: dict[int, StoreEntry] = {}
        self._skipped: dict[str, int] = {}
        self._page_reads = 0
        self._puts = 0
        self._write_errors = 0
        self._put_aborts = 0
        self._compactions = 0
        self._evicted = 0

    # -- write ---------------------------------------------------------- #

    def put_eds(self, height: int, eds_np, original_width: int, *,
                dah_doc: dict, levels=None,
                rows_per_page: int = DEFAULT_ROWS_PER_PAGE) -> StoreEntry | None:
        """Persist one height: the host EDS array (numpy or a CPU tensor)
        split into row-group pages, the served DAH JSON, and optionally the
        row-tree levels. Atomic: the height is visible only after the
        rename, and a re-put replaces the old file in one step.

        In durable mode the height is acknowledged durable only when this
        returns: data fsync, rename and parent-directory fsync have all
        happened. Read-only mode skips the put and returns None, except one
        put per ``reprobe_interval_s``, which runs as the recovery probe and
        clears the degradation if it lands."""
        # a GIL-atomic bool read; transitions serialize under _index_lock, and a
        # stale read only delays (never corrupts) one put
        if self._read_only:
            now = time.monotonic()
            with self._index_lock:
                reprobe = now >= self._reprobe_after
                if reprobe:  # this put becomes the probe; its peers skip
                    self._reprobe_after = now + self.reprobe_interval_s
            if not reprobe:
                metrics.incr_counter("store_put_aborted_total", reason="read_only")
                return None

        arr = _host_uint8(eds_np)
        width, _w2, share_size = arr.shape
        if width != 2 * original_width:
            raise ValueError(f"EDS width {width} != 2*k for k={original_width}")
        rows_per_page = max(1, min(int(rows_per_page), width))
        page_count = -(-width // rows_per_page)
        page_slot = rows_per_page * width * share_size

        dah_bytes = json.dumps(dah_doc, sort_keys=True).encode()
        levels_bytes = pack_levels(levels) if levels else b""
        pages = []
        with tracing.stage("crc"):
            for i in range(page_count):
                lo = i * rows_per_page
                hi = min(lo + rows_per_page, width)
                payload = arr[lo:hi].tobytes()
                pages.append((payload, crc32c(payload)))
            fields = {
                "height": height, "k": original_width,
                "share_size": share_size, "rows_per_page": rows_per_page,
                "page_count": page_count, "dah_len": len(dah_bytes),
                "levels_len": len(levels_bytes), "dah_crc": crc32c(dah_bytes),
                "levels_crc": crc32c(levels_bytes), "page_slot": page_slot,
            }
        path = self.root / f"{height}{SUFFIX}"
        tmp = self.root / f"{height}{SUFFIX}.tmp"
        try:
            # the write drill: a corrupt or bitflip rule mangles the first
            # page payload AFTER its CRC was computed (rot on disk that the
            # next read must catch). Fired before any byte lands, inside the
            # abort scope, so enospc and error strikes count as aborted puts
            # and clean up like the real thing. A short_write rule returns a
            # truncator: only a seeded prefix of the file lands, then the
            # put fails like a real torn write.
            truncate = None
            flip = faults.fire("store.write", height=height, pages=page_count)
            if flip is not None and getattr(flip, "short_write", False):
                truncate = flip
            elif flip is not None and pages:
                pages[0] = (flip(pages[0][0]), pages[0][1])
            parts = [_pack_header(fields), dah_bytes, levels_bytes]
            for payload, crc in pages:
                parts.append(_RECORD.pack(len(payload), crc, 0))
                parts.append(payload.ljust(page_slot, b"\x00"))
            with tracing.stage("write"):
                with self._fs.open_w(tmp, height=height) as f:
                    if truncate is not None:
                        f.write(truncate(b"".join(parts)))
                        f.flush()
                        err = faults.DiskFault(
                            errno.EIO, f"short write persisting height {height}")
                        err.short_write = True
                        raise err
                    for part in parts:
                        f.write(part)
                    f.flush()
                    if self.durable:
                        self._fs.fsync(f, path=tmp, height=height)
                self._fs.replace(tmp, path, height=height)
                if self.durable:
                    # the rename is not crash-durable until the parent
                    # directory's entry is: without this dirsync an
                    # acknowledged height can vanish after power loss (the
                    # fault the powercut explorer finds)
                    self._fs.dirsync(self.root, height=height)
        except Exception as exc:
            self._abort_put(tmp, exc, height)
            raise
        if self._read_only:  # this put was the recovery probe, and it landed
            self._exit_read_only()
        entry = StoreEntry(path=path, **fields)
        with self._index_lock:
            self._index[height] = entry
            self._puts += 1
        metrics.incr_counter("store_put_total")
        self._publish()
        return entry

    def _abort_put(self, tmp: pathlib.Path, exc: BaseException, height: int) -> None:
        """A failure mid-put: classify and count the abort, unlink the
        ``.tmp`` orphan (best effort), and flip read-only on ENOSPC."""
        if getattr(exc, "short_write", False):
            reason = "short_write"
        elif isinstance(exc, OSError) and exc.errno == errno.ENOSPC:
            reason = "enospc"
        else:
            reason = "error"
        with self._index_lock:
            self._write_errors += 1
            self._put_aborts += 1
        metrics.incr_counter("store_write_error_total")
        metrics.incr_counter("store_put_aborted_total", reason=reason)
        try:
            self._fs.unlink(tmp, missing_ok=True, height=height)
        except (OSError, faults.FaultError):
            pass  # the disk is too sick to unlink; reindex ignores .tmp
        if reason == "enospc":
            self._enter_read_only("enospc")

    # -- read-only degradation (the ENOSPC state machine) --------------- #

    @property
    def read_only(self) -> bool:
        return self._read_only

    @property
    def read_only_reason(self) -> str | None:
        return self._read_only_reason

    def force_read_only(self, reason: str = "operator") -> None:
        """Operations hook: degrade to read-only WITHOUT the put-side reprobe
        (recovery needs an explicit ``try_recover``), as when a disk is
        pulled out from under a worker."""
        self._enter_read_only(reason)
        with self._index_lock:
            self._reprobe_after = float("inf")

    def try_recover(self) -> bool:
        """Explicit writability probe, the recovery edge of the read-only
        state machine: writes, fsyncs and unlinks a tiny probe file through
        the same FsShim as the put path, so injected faults at those sites
        keep the store read-only as a still-full disk would. True means
        writable now."""
        if not self._read_only:
            return True
        probe = self.root / ".writable.probe"
        try:
            with self._fs.open_w(probe) as f:
                f.write(b"ok")
                f.flush()
                if self.durable:
                    self._fs.fsync(f, path=probe)
            self._fs.unlink(probe, missing_ok=True)
        except (OSError, faults.FaultError):
            with self._index_lock:
                self._reprobe_after = time.monotonic() + self.reprobe_interval_s
            return False
        self._exit_read_only()
        return True

    def _enter_read_only(self, reason: str) -> None:
        with self._index_lock:
            first = not self._read_only
            self._read_only = True
            self._read_only_reason = reason
            self._reprobe_after = time.monotonic() + self.reprobe_interval_s
        metrics.set_gauge("store_read_only", 1.0)
        if not first:
            return  # sticky: a repeated strike only pushes the reprobe clock
        metrics.incr_counter("store_read_only_total")
        log.warn("store degraded to read-only", reason=reason, root=str(self.root))
        self._cleanup_tmp()
        if self.emergency_compact_bytes:
            try:  # free what can be freed, so reads keep their hot window
                self.compact(int(self.emergency_compact_bytes))
            except (OSError, faults.FaultError):
                pass

    def _exit_read_only(self) -> None:
        with self._index_lock:
            if not self._read_only:
                return
            self._read_only = False
            self._read_only_reason = None
            self._reprobe_after = 0.0
        metrics.set_gauge("store_read_only", 0.0)
        metrics.incr_counter("store_read_only_recovered_total")
        log.info("store writable again", root=str(self.root))

    def _cleanup_tmp(self) -> None:
        """Free what a full disk can still give back: abandoned ``.tmp``
        orphans (an unlink needs no free space on common filesystems)."""
        for tmp in self.root.glob(f"*{SUFFIX}.tmp"):
            try:
                self._fs.unlink(tmp, missing_ok=True)
            except (OSError, faults.FaultError):
                pass

    # -- re-index ------------------------------------------------------- #

    def reindex(self, deep: bool = True) -> dict:
        """Scan the directory and rebuild the height index, the restart
        path. Damaged files are skipped with a ``store_reindex_skipped_total
        {reason=...}`` bump (bad_header, truncated, page_crc, duplicate),
        never a crash. ``deep`` also verifies every page record's CRC (the
        default; False adopts a large archive lazily and lets the per-read
        checks catch rot)."""
        found: dict[int, StoreEntry] = {}
        skipped: dict[str, int] = {}

        def skip(path: pathlib.Path, reason: str) -> None:
            skipped[reason] = skipped.get(reason, 0) + 1
            metrics.incr_counter("store_reindex_skipped_total", reason=reason)
            log.warn("store re-index skipped file", file=path.name, reason=reason)

        for path in sorted(self.root.glob(f"*{SUFFIX}")):
            entry = self._read_header(path)
            if entry is None:
                skip(path, "bad_header")
                continue
            expected = entry.page_offset(entry.page_count)
            try:
                size = path.stat().st_size
            except OSError:
                skip(path, "bad_header")
                continue
            if size < expected:
                skip(path, "truncated")
                continue
            if entry.height in found:
                skip(path, "duplicate")
                continue
            if deep and not self._verify_pages(entry):
                skip(path, "page_crc")
                continue
            found[entry.height] = entry
        with self._index_lock:
            self._index = found
            for reason, n in skipped.items():
                self._skipped[reason] = self._skipped.get(reason, 0) + n
        self._publish()
        report = {"heights": len(found), "skipped": skipped}
        log.info("store re-indexed", root=str(self.root), **report)
        return report

    # -- compaction ----------------------------------------------------- #

    def compact(self, byte_budget: int, *, keep_recent: int = 16) -> dict:
        """Evict whole cold heights until the store fits ``byte_budget``:
        lowest heights first, never the newest ``keep_recent`` (so the hot
        serving window survives a budget too small). The index entry goes
        under ``_index_lock``, then the file is unlinked unlocked; a racing
        reader holding the stale entry sees the KeyError miss. Retained
        files are untouched: their DAH and page bytes are the same before
        and after."""
        byte_budget = int(byte_budget)
        with self._index_lock:
            heights = sorted(self._index)
            sizes = {h: self._index[h].page_offset(self._index[h].page_count)
                     for h in heights}
        total = sum(sizes.values())
        bytes_before = total
        protected = set(heights[-keep_recent:]) if keep_recent > 0 else set()
        victims: list[int] = []
        for h in heights:
            if total <= byte_budget:
                break
            if h in protected:
                continue
            victims.append(h)
            total -= sizes[h]
        evicted: list[int] = []
        freed = 0
        for h in victims:
            with self._index_lock:
                entry = self._index.pop(h, None)
            if entry is None:
                continue  # lost a race with a concurrent compaction
            try:
                self._fs.unlink(entry.path, missing_ok=True, height=h)
            except OSError:
                pass  # the index drop already hid the height
            evicted.append(h)
            freed += sizes[h]
            metrics.incr_counter("store_compact_evicted_total")
        if evicted and self.durable:
            # one directory sync makes the unlinks crash-durable; a lost
            # unlink only brings back an evicted height after a crash
            # (adopted by reindex, evicted by the next compaction), so a
            # failure here is a warning
            try:
                self._fs.dirsync(self.root)
            except (OSError, faults.FaultError):
                log.warn("compact dirsync failed", root=str(self.root))
        with self._index_lock:
            self._compactions += 1
            self._evicted += len(evicted)
        metrics.incr_counter("store_compact_total")
        self._publish()
        report = {
            "budget": byte_budget, "evicted": len(evicted),
            "evicted_heights": evicted, "bytes_before": bytes_before,
            "bytes_after": bytes_before - freed, "bytes_freed": freed,
            "over_budget": bytes_before - freed > byte_budget,
        }
        if evicted:
            log.info("store compacted",
                     **{k: v for k, v in report.items() if k != "evicted_heights"})
        return report

    def _read_header(self, path: pathlib.Path) -> StoreEntry | None:
        try:
            with open(path, "rb") as f:
                raw = f.read(HEADER_SIZE)
        except OSError:
            return None
        if len(raw) < _HEADER.size + _HEADER_CRC.size:
            return None
        fields = raw[: _HEADER.size]
        (stored_crc,) = _HEADER_CRC.unpack_from(raw, _HEADER.size)
        if crc32c(fields) != stored_crc:
            return None
        (magic, version, height, k, share_size, rows_per_page,
         page_count, dah_len, levels_len, dah_crc, levels_crc,
         page_slot) = _HEADER.unpack(fields)
        if magic != MAGIC or version != VERSION:
            return None
        if k <= 0 or rows_per_page <= 0 or page_count <= 0:
            return None
        return StoreEntry(
            path=path, height=height, k=k, share_size=share_size,
            rows_per_page=rows_per_page, page_count=page_count,
            page_slot=page_slot, dah_len=dah_len, levels_len=levels_len,
            dah_crc=dah_crc, levels_crc=levels_crc,
        )

    def _verify_pages(self, entry: StoreEntry) -> bool:
        try:
            with open(entry.path, "rb") as f:
                for i in range(entry.page_count):
                    f.seek(entry.page_offset(i))
                    rec = f.read(RECORD_HEADER_SIZE)
                    nbytes, crc, _r = _RECORD.unpack(rec)
                    payload = f.read(nbytes)
                    if len(payload) != nbytes or crc32c(payload) != crc:
                        return False
        except (OSError, struct.error):
            return False
        return True

    # -- read ----------------------------------------------------------- #

    def entry(self, height: int) -> StoreEntry | None:
        with self._index_lock:
            return self._index.get(height)

    def heights(self) -> list[int]:
        with self._index_lock:
            return sorted(self._index)

    def __contains__(self, height: int) -> bool:
        with self._index_lock:
            return height in self._index

    def __len__(self) -> int:
        with self._index_lock:
            return len(self._index)

    def _require(self, height: int) -> StoreEntry:
        entry = self.entry(height)
        if entry is None:
            raise KeyError(f"height {height} not in store")
        return entry

    @staticmethod
    @contextlib.contextmanager
    def _evictable(height: int):
        """A file that vanished under a racing ``compact()`` is the ordinary
        height-miss KeyError, never a FileNotFoundError."""
        try:
            yield
        except FileNotFoundError:
            raise KeyError(f"height {height} not in store (evicted)") from None

    def read_page(self, height: int, index: int):
        """One page record -> (uint8 array (rows, 2k, share_size), payload
        CRC32C): one seek and one bounded read, never the square. A CRC
        mismatch (rot, torn write, injected flip) raises ``IntegrityError``
        after ``record_sdc("store.read")``; the caller never sees mangled
        shares."""
        import numpy as np

        entry = self._require(height)
        if not (0 <= index < entry.page_count):
            raise IndexError(f"page {index} out of range ({entry.page_count} pages)")
        with tracing.stage("disk"), self._evictable(height), open(entry.path, "rb") as f:
            f.seek(entry.page_offset(index))
            nbytes, crc, _r = _RECORD.unpack(f.read(RECORD_HEADER_SIZE))
            payload = f.read(nbytes)
        # the read drill: a bitflip rule mangles the bytes BEFORE the CRC
        # check, so a detection proves the guard, not luck
        flip = faults.fire("store.read", height=height, page=index)
        if flip is not None:
            payload = bytes(flip(payload))
        with tracing.stage("crc"):
            bad = len(payload) != nbytes or crc32c(payload) != crc
        if bad:
            record_sdc("store.read")
            metrics.incr_counter("store_read_corrupt_total")
            err = IntegrityError(
                f"store page CRC mismatch at height {height} page "
                f"{index}: refusing to serve torn data")
            err.site = "store.read"
            raise err
        with self._index_lock:
            self._page_reads += 1
        metrics.incr_counter("store_page_read_total")
        rows = entry.page_rows(index)
        arr = np.frombuffer(payload, dtype=np.uint8).reshape(rows, 2 * entry.k, entry.share_size)
        return arr, crc

    def page_crcs(self, height: int) -> list[int]:
        """Every page record's stored CRC (record headers only): what a
        store-seeded cache page adopts before its first fault-in."""
        entry = self._require(height)
        crcs = []
        with self._evictable(height), open(entry.path, "rb") as f:
            for i in range(entry.page_count):
                f.seek(entry.page_offset(i))
                _n, crc, _r = _RECORD.unpack(f.read(RECORD_HEADER_SIZE))
                crcs.append(crc)
        return crcs

    def read_dah(self, height: int) -> dict:
        """The stored DataAvailabilityHeader JSON document, byte-identical
        to what the node served before the restart."""
        entry = self._require(height)
        with self._evictable(height), open(entry.path, "rb") as f:
            f.seek(HEADER_SIZE)
            raw = f.read(entry.dah_len)
        if len(raw) != entry.dah_len or crc32c(raw) != entry.dah_crc:
            record_sdc("store.read")
            metrics.incr_counter("store_read_corrupt_total")
            err = IntegrityError(f"store DAH CRC mismatch at height {height}")
            err.site = "store.read"
            raise err
        return json.loads(raw)

    def read_levels(self, height: int):
        """The stored row-tree node levels (numpy), or None when the height
        was persisted without them."""
        entry = self._require(height)
        if entry.levels_len == 0:
            return None
        with tracing.stage("disk"), self._evictable(height), open(entry.path, "rb") as f:
            f.seek(HEADER_SIZE + entry.dah_len)
            raw = f.read(entry.levels_len)
        with tracing.stage("crc"):
            bad = len(raw) != entry.levels_len or crc32c(raw) != entry.levels_crc
        if bad:
            record_sdc("store.read")
            metrics.incr_counter("store_read_corrupt_total")
            err = IntegrityError(f"store levels CRC mismatch at height {height}")
            err.site = "store.read"
            raise err
        return unpack_levels(raw)

    # -- introspection -------------------------------------------------- #

    def stats(self) -> dict:
        with self._index_lock:
            heights = sorted(self._index)
            skipped = dict(self._skipped)
            page_reads = self._page_reads
            puts = self._puts
            write_errors = self._write_errors
            put_aborts = self._put_aborts
            compactions = self._compactions
            evicted = self._evicted
            nbytes = sum(e.page_offset(e.page_count) for e in self._index.values())
        return {
            "kind": "blockstore",
            "root": str(self.root),
            "heights": len(heights),
            "height_lo": heights[0] if heights else None,
            "height_hi": heights[-1] if heights else None,
            "bytes": nbytes,
            "puts": puts,
            "page_reads": page_reads,
            "write_errors": write_errors,
            "put_aborts": put_aborts,
            "read_only": self._read_only,
            "read_only_reason": self._read_only_reason,
            "compactions": compactions,
            "evicted": evicted,
            "reindex_skipped": skipped,
        }

    def _publish(self) -> None:
        with self._index_lock:
            n = len(self._index)
            nbytes = sum(e.page_offset(e.page_count) for e in self._index.values())
        metrics.set_gauge("store_heights", float(n))
        metrics.set_gauge("store_bytes", float(nbytes))
        metrics.set_gauge("store_read_only", 1.0 if self._read_only else 0.0)
