"""Device-resident blob arena: the mempool's blob bytes live on the card
(port of the JAX package's ops/blob_pool.py).

A proposal's square is mostly BLOB bytes, and those bytes are known long
before the proposal: they arrive with the BlobTx at CheckTx. This module
stages them: on mempool admission each blob's data is uploaded
(``transfers.device_put_chunked``, site ``arena.stage``) and copied into a
fixed device arena. At proposal time the card assembles the square itself
(``ops/extend.assembled_roots``, the assembly kernel of
``ops/assemble_cuda``): only the compact tx/PFB/padding shares, the blobs'
namespaces and int32 offset vectors cross the interconnect, tens of KB
instead of the 8 MiB square.

Where the JAX package inserts with a donated ``dynamic_update_slice`` (a
new buffer a jit), the port writes the arena in place: a slice ``copy_`` of
the staged chunk, on the copy stream of ``ops/transfers`` that uploaded it,
then one CUDA event recorded after it. A reader makes its stream wait on
the events of the inserts so far (``ready``) before it launches on the
arena. An in-place write would tear a queued read, so the arena lock is
held from a proposal's offset lookups until its roots reach the host
(``app/proposal.assembled_proposal_dah``), as in the JAX App.

ref: the reference keeps mempool blobs host-side and re-marshals them
into the square per proposal (pkg/square/builder.go).
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np
import torch

from celestia_tpu_torch import device as device_mod
from celestia_tpu_torch import devledger
from celestia_tpu_torch.ops import transfers
from celestia_tpu_torch.telemetry import metrics


def blob_key(data: bytes) -> bytes:
    """Identity of pooled blob BYTES (content-addressed, like the CAT
    pool's tx keys): sha256 of the raw blob data."""
    return hashlib.sha256(data).digest()


def _pad_len(n: int) -> int:
    """Arena slots are rounded to 4 KB (the JAX package's slots, which keep
    its insert's compile cache to a handful of sizes; the port keeps them
    so the allocator, flips and evictions are the same)."""
    return max(4096, (n + 4095) // 4096 * 4096)


class DeviceBlobArena:
    """Fixed-size device byte arena with a host-side bump allocator.

    Thread-safe for the node's use (CheckTx threads insert, the proposal
    path reads). Eviction is SEMISPACE: the arena is two halves, the bump
    allocator fills the active one, and overflow flips to the other half,
    evicting only ITS entries; blobs staged in the previous half stay
    resident one more cycle. Correctness never depends on residency (the
    proposal path keeps any blob it cannot find as host cells), so the
    arena is purely a transfer cache.

    ``device``: where the arena lives (None means CUDA; the CPU only when
    asked for)."""

    def __init__(self, capacity_bytes: int = 64 * 1024 * 1024, device=None):
        self.capacity = int(capacity_bytes)
        # Each half is floor(capacity/2) rounded DOWN to 4 KB; a sub-8 KB
        # arena degenerates to one wholesale-reset region. The remainder
        # past the usable region is stranded by design (equal aligned
        # halves keep entries from straddling the flip boundary);
        # `tail_bytes` makes it visible.
        self._half = max(4096, self.capacity // 2 // 4096 * 4096)
        if self._half > self.capacity:
            self._half = self.capacity
        usable = (
            self._half * 2 if self._half * 2 <= self.capacity else self._half
        )
        self.tail_bytes = self.capacity - usable
        self._device = device_mod.resolve(device)
        self._arena = torch.zeros((self.capacity,), dtype=torch.uint8, device=self._device)
        # the event after the last write to the arena, the zero fill first;
        # the inserts run on the copy stream, behind it
        self._inserted = None
        if self._device.type == "cuda":
            self._inserted = torch.cuda.Event()
            self._inserted.record(torch.cuda.current_stream(self._device))
            transfers._copy_stream(self._device).wait_event(self._inserted)
        self._offsets: dict[bytes, tuple[int, int]] = {}  # key -> (off, len)
        self._base = 0  # active half's base offset
        self._next = 0
        # REENTRANT: the proposal path holds this lock across its whole read
        # (offset lookups -> launch -> root fetch) while the nested
        # offset_of calls re-acquire it. Serializing against put() is what
        # makes the in-place insert safe: an insert or a half flip would
        # otherwise rewrite bytes at offsets a queued proposal reads.
        self._lock = threading.RLock()
        # the arena's fixed device allocation in the device ledger, held
        # weakly: a dropped arena leaves the ledger on its next snapshot
        devledger.register_owner("blob_arena", self.device_bytes)

    def device_bytes(self) -> int:
        """The arena's device footprint (fixed at construction), the device
        ledger's owner callback. It runs with no ledger lock held, so taking
        the arena lock here makes no edge between the two locks."""
        with self._lock:
            arena = self._arena
            return int(arena.nbytes) if arena is not None else 0

    @property
    def lock(self):
        """Hold across a multi-step read (snapshot offsets + launch +
        fetch) to exclude concurrent staging; see __init__."""
        return self._lock

    @property
    def device(self) -> torch.device:
        return self._device

    # ---- writes (CheckTx admission path) ----

    def _alloc_locked(self, pad: int) -> int:
        """Bump-allocate `pad` bytes in the active half (caller checked
        pad <= half), flipping when full: activate the other half and
        evict only ITS entries; the half we just filled stays resident
        for one more cycle. Entries never straddle the boundary (pad <=
        half and allocation flips before overflowing)."""
        if self._next + pad > self._base + self._half:
            if self._half * 2 <= self.capacity:
                self._base = self._half - self._base  # 0 <-> half
            else:  # degenerate single-region arena
                self._base = 0
            self._next = self._base
            lo, hi = self._base, self._base + self._half
            self._offsets = {
                k: (o, ln)
                for k, (o, ln) in self._offsets.items()
                if not (lo <= o < hi)
            }
        offset = self._next
        self._next += pad
        return offset

    def _stage_chunk(self, data: bytes) -> torch.Tensor:
        """Upload the padded blob bytes (pinned, on the copy stream) with
        transfer telemetry at site=arena.stage."""
        pad = _pad_len(len(data))
        chunk = np.zeros((pad,), np.uint8)
        chunk[: len(data)] = np.frombuffer(data, np.uint8)
        return transfers.device_put_chunked(chunk, self._device, site="arena.stage")

    def _insert_locked(self, chunk: torch.Tensor, offset: int) -> None:
        """Copy a staged chunk into the arena in place. On a card the copy
        runs on the copy stream, behind the chunk's own upload, and an
        event after it tells readers when the arena holds it."""
        dst = self._arena[offset: offset + chunk.numel()]
        if self._device.type != "cuda":
            dst.copy_(chunk)
            return
        # the chunk was allocated and uploaded on this stream
        stream = transfers._copy_stream(self._device)
        with torch.cuda.stream(stream):
            dst.copy_(chunk, non_blocking=True)
        self._inserted = torch.cuda.Event()
        self._inserted.record(stream)

    def ready(self, stream: torch.cuda.Stream | None = None) -> None:
        """Make ``stream`` (default: the current one) wait until every insert
        so far has landed in the arena. A CPU arena has nothing to wait for."""
        if self._device.type != "cuda":
            return
        with self._lock:
            ev = self._inserted
        (stream or torch.cuda.current_stream(self._device)).wait_event(ev)

    def put(self, data: bytes) -> bytes:
        """Stage blob bytes on device; returns the content key.
        Idempotent; flips to the other half when the active one is full
        (transfer cache semantics — see class docstring)."""
        key = blob_key(data)
        pad = _pad_len(len(data))
        with self._lock:
            if key in self._offsets:
                return key
            if pad > self._half:
                return key  # oversized: never resident, always host cells
        # stage with the lock RELEASED (the upload would stall every
        # proposal-path offset_of() behind it); staging is idempotent, so
        # the re-check below drops a duplicate upload if a racer landed
        # the same key
        dev = self._stage_chunk(data)
        with self._lock:
            if key in self._offsets:
                return key
            offset = self._alloc_locked(pad)
            self._insert_locked(dev, offset)
            self._offsets[key] = (offset, len(data))
            self._publish_metrics()
            return key

    def put_many(self, datas: list[bytes]) -> list[bytes]:
        """Stage several blobs: every blob's upload is issued first (each
        chunk on the copy stream behind the last), then the inserts copy
        them in order. Allocator/flip/dedup semantics are identical to
        put(); returns the content keys in input order."""
        with self._lock:
            plan: list[tuple[bytes, bytes, bool]] = []
            seen: set[bytes] = set()
            for data in datas:
                key = blob_key(data)
                stage = not (
                    key in self._offsets
                    or key in seen
                    or _pad_len(len(data)) > self._half
                )  # False: resident/oversized/dup-in-batch
                if stage:
                    seen.add(key)
                plan.append((key, data, stage))
        # every upload issued with the lock released (as in put(); staging
        # is idempotent and re-checked before insert)
        staged = [
            (key, data, self._stage_chunk(data) if stage else None)
            for key, data, stage in plan
        ]
        with self._lock:
            keys = []
            for key, data, dev in staged:
                if dev is not None and key not in self._offsets:
                    pad = _pad_len(len(data))
                    offset = self._alloc_locked(pad)
                    self._insert_locked(dev, offset)
                    self._offsets[key] = (offset, len(data))
                keys.append(key)
            self._publish_metrics()
            return keys

    def _publish_metrics(self) -> None:
        """Operator visibility on /metrics: how much of the mempool's
        blob data is resident and how full the arena is."""
        metrics.set_gauge(
            "blob_arena_resident_bytes",
            float(sum(ln for _o, ln in self._offsets.values())),
        )
        # active-half fill, not the absolute bump pointer (which includes
        # the half's base offset under semispace)
        metrics.set_gauge("blob_arena_used_bytes", float(self._next - self._base))
        metrics.set_gauge("blob_arena_capacity_bytes", float(self.capacity))
        # used_bytes tops out at the ACTIVE HALF, not capacity
        metrics.set_gauge("blob_arena_active_half_bytes", float(self._half))

    def drop(self, key: bytes) -> None:
        """Forget a blob (committed/evicted tx). Space is reclaimed when
        its half next flips."""
        with self._lock:
            self._offsets.pop(key, None)

    # ---- reads (proposal path) ----

    def offset_of(self, key: bytes) -> tuple[int, int] | None:
        with self._lock:
            return self._offsets.get(key)

    @property
    def arena(self) -> torch.Tensor:
        """The device buffer (pass to the assembly kernel after ``ready``)."""
        return self._arena

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(ln for _off, ln in self._offsets.values())
