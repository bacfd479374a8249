"""Host<->device data movement for the port (port of the JAX package's
ops/transfers.py). The one place the port moves EDS bytes across the
interconnect, with four disciplines:

1. **Sliced reads.** ``eds_row`` / ``eds_col`` / ``eds_share`` and the
   batched ``eds_rows_batch`` / ``eds_cells_batch`` cut the requested row,
   column or cells of a device-resident (w, w, B) square on the device, and
   only the slice crosses to the host: a sample moves O(w·B) bytes, not
   O(w²·B). A batch is one gather of exactly the requested indices (the
   JAX package pads the index list to a power of two for its compile cache
   and cuts the pad on the device; eager PyTorch needs no pad).

2. **Chunked bulk transfers.** ``device_put_chunked`` splits an upload
   into row blocks. On a CUDA device each block is copied into a reused
   pinned host buffer (by torch's multi-threaded CPU copy) and its H2D copy
   issued without blocking on a copy stream, one CUDA event per block, and
   the caller's stream waits on those events, so block i + 1's host copy
   overlaps block i's DMA and the caller's work queues behind the upload. Pinning memory or creating the
   stream raises on failure: there is no quiet pageable path. On the CPU
   the blocks are plain copies. ``device_get_chunked`` downloads row blocks.
   ``device_put_sharded_rows`` lands each row block of a square on its
   mesh shard's device (``RowShards``), through the same uploader.

3. **Telemetry.** Every movement adds to the ``transfer_bytes`` and
   ``transfer_ms`` counters by site and direction, observes the
   ``transfer`` histogram, feeds the active stage sink, and (tracing on)
   emits a ``transfer.<site>`` span from the same measurement.

4. **Integrity.** With audits enabled (``integrity.configure``), the
   chunked paths take a CRC-32C of each sampled chunk at the source and
   verify it at the sink, retry a damaged chunk once, and then raise
   IntegrityError. Every chunk passes the ``transfer.chunk`` fault site.

Staging traps the CUDA path handles: a pinned buffer is reused only after
the event of its last copy from each byte range has completed; and the
destination is allocated on the copy stream (so its block was never handed
to work the caller's stream may still run) and marked with
``record_stream`` for the caller's stream, which reads it, so the caching
allocator does not hand the block out again before that stream is done.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from celestia_tpu_torch import device as device_mod
from celestia_tpu_torch import faults, integrity, tracing
from celestia_tpu_torch.telemetry import metrics

# bulk transfers split into row-block chunks of at least this many bytes
MIN_CHUNK_BYTES = 1 << 20
MAX_CHUNKS = 8


def _record(site: str, direction: str, nbytes: int, start: float) -> None:
    """Count one transfer (bytes and wall ms) per site and direction; the
    same measurement is the ``transfer`` histogram sample, the stage sink's
    share and (tracing on) a finished ``transfer.<site>`` span carrying the
    site's running totals."""
    metrics.incr_counter("transfer_bytes", float(nbytes), site=site, direction=direction)
    elapsed = time.perf_counter() - start
    metrics.incr_counter("transfer_ms", elapsed * 1e3, site=site, direction=direction)
    metrics.observe("transfer", elapsed, site=site, direction=direction)
    tracing.add_stage(direction, elapsed)
    if tracing.enabled():
        tracing.emit(
            f"transfer.{site}", start, site=site, direction=direction, bytes=nbytes,
            total_bytes=metrics.get_counter("transfer_bytes", site=site, direction=direction),
            total_ms=round(metrics.get_counter("transfer_ms", site=site, direction=direction), 3),
        )


def _nbytes(arr) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return int(np.prod(arr.shape)) * np.dtype(arr.dtype).itemsize


def _auto_chunks(nbytes: int, rows: int) -> int:
    return max(1, min(MAX_CHUNKS, rows, nbytes // MIN_CHUNK_BYTES))


def _bounds(n: int, chunks: int) -> list[tuple[int, int]]:
    """Split [0, n) into ``chunks`` near-equal contiguous row blocks (the
    first n % chunks blocks take the extra row)."""
    base, extra = divmod(n, chunks)
    bounds = []
    lo = 0
    for i in range(chunks):
        hi = lo + base + (1 if i < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _chunk_count(chunks: int | None, nbytes: int, n: int) -> int:
    c = chunks if chunks is not None else _auto_chunks(nbytes, n)
    return max(1, min(int(c), n)) if n else 1


# ------------------------------------------------------------------ #
# the device executor: a serving node registers the one callable that owns
# the device stream, and sliced reads issued elsewhere run through it. It
# engages only when exactly one executor is registered.

_device_executors: list = []
_executor_lock = threading.Lock()


def register_device_executor(executor) -> None:
    with _executor_lock:
        if executor not in _device_executors:
            _device_executors.append(executor)


def unregister_device_executor(executor) -> None:
    with _executor_lock:
        if executor in _device_executors:
            _device_executors.remove(executor)


def _device_executor():
    with _executor_lock:
        return _device_executors[0] if len(_device_executors) == 1 else None


def _run(fn):
    executor = _device_executor()
    return fn() if executor is None else executor(fn)


# ------------------------------------------------------------------ #
# sliced device->host reads


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of a CPU tensor's memory)."""
    return t.to("cpu", copy=True).numpy()


def _fetch(dev_slice: torch.Tensor, site: str, start: float) -> np.ndarray:
    out = _host(dev_slice)  # only the slice crosses
    _record(site, "d2h", out.nbytes, start)
    return out


def eds_row(dev: torch.Tensor, i: int, *, site: str = "eds.row") -> np.ndarray:
    """Row i of a device-resident (w, w, B) square: (w, B) host bytes."""
    return _run(lambda: _eds_row_direct(dev, i, site))


def _eds_row_direct(dev: torch.Tensor, i: int, site: str) -> np.ndarray:
    start = time.perf_counter()
    return _fetch(dev[int(i)], site, start)


def eds_col(dev: torch.Tensor, j: int, *, site: str = "eds.col") -> np.ndarray:
    """Column j of a device-resident (w, w, B) square: (w, B) host bytes,
    gathered on the device."""
    return _run(lambda: _eds_col_direct(dev, j, site))


def _eds_col_direct(dev: torch.Tensor, j: int, site: str) -> np.ndarray:
    start = time.perf_counter()
    return _fetch(dev[:, int(j)].contiguous(), site, start)


def eds_share(dev: torch.Tensor, r: int, c: int, *, site: str = "eds.share") -> np.ndarray:
    """One (B,) cell of a device-resident square."""
    return _run(lambda: _eds_share_direct(dev, r, c, site))


def _eds_share_direct(dev: torch.Tensor, r: int, c: int, site: str) -> np.ndarray:
    start = time.perf_counter()
    return _fetch(dev[int(r), int(c)], site, start)


def _index(values: list[int], device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, dtype=np.int64), device=device)


def eds_rows_batch(dev: torch.Tensor, indices, *, site: str = "eds.rows_batch") -> np.ndarray:
    """Rows ``indices`` of a device-resident (w, w, B) square as one
    gather: (n, w, B) host bytes in request order, byte-identical to
    ``[eds_row(dev, i) for i in indices]``, its byte count included."""
    return _run(lambda: _eds_rows_batch_direct(dev, indices, site))


def _eds_rows_batch_direct(dev: torch.Tensor, indices, site: str) -> np.ndarray:
    idx = [int(i) for i in indices]
    if not idx:
        return np.empty((0, *dev.shape[1:]), dtype=np.uint8)
    start = time.perf_counter()
    out_dev = dev.index_select(0, _index(idx, dev.device))
    profile_fence(out_dev, site, start, n=len(idx))
    return _fetch(out_dev, site, start)


def eds_cells_batch(dev: torch.Tensor, coords, *, site: str = "eds.cells_batch") -> np.ndarray:
    """Cells ``coords`` ((row, col) pairs) of a device-resident square as
    one gather: (n, B) host bytes in request order, byte-identical to
    per-call ``eds_share``, its byte count included."""
    return _run(lambda: _eds_cells_batch_direct(dev, coords, site))


def _eds_cells_batch_direct(dev: torch.Tensor, coords, site: str) -> np.ndarray:
    pts = [(int(r), int(c)) for r, c in coords]
    if not pts:
        return np.empty((0, dev.shape[2]), dtype=np.uint8)
    start = time.perf_counter()
    rr = _index([p[0] for p in pts], dev.device)
    cc = _index([p[1] for p in pts], dev.device)
    out_dev = dev[rr, cc]
    profile_fence(out_dev, site, start, n=len(pts))
    return _fetch(out_dev, site, start)


def profile_fence(out: torch.Tensor, entry: str, dispatch_start: float, **attrs) -> None:
    """When this call is profile-sampled (``tracing.enable_profiling``),
    wait for the result's stream and emit a ``profile.fence`` span from
    the dispatch to the result: the device time the async launches hide.
    The extend entries fence their results with it too."""
    if not tracing.profile_sample():
        return
    if out.device.type == "cuda":
        torch.cuda.current_stream(out.device).synchronize()
    tracing.emit("profile.fence", dispatch_start, entry=entry, fenced=True, **attrs)


# ------------------------------------------------------------------ #
# staging: pinned host buffers and the copy stream


class _Pinned:
    """A pinned host buffer and, per byte range, the event of its last H2D
    copy: a range is written again only after that event completed."""

    def __init__(self, nbytes: int):
        self.host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        self.array = self.host.numpy()
        self.pending: list[tuple[int, int, torch.cuda.Event]] = []

    def claim(self, lo: int, hi: int) -> None:
        """Wait for every earlier copy from a range that overlaps [lo, hi)."""
        keep = []
        for a, b, ev in self.pending:
            if a < hi and lo < b:
                ev.synchronize()
            else:
                keep.append((a, b, ev))
        self.pending = keep


_pinned_pool: dict[int, list[_Pinned]] = {}
_copy_streams: dict[int, torch.cuda.Stream] = {}
_staging_lock = threading.Lock()


def _take_pinned(nbytes: int) -> _Pinned:
    """A pinned buffer of ``nbytes`` for this call alone: a free one of that
    size, or a new one (pinning raises if the host cannot pin)."""
    with _staging_lock:
        free = _pinned_pool.get(nbytes)
        if free:
            return free.pop()
    return _Pinned(nbytes)


def _give_pinned(buf: _Pinned) -> None:
    with _staging_lock:
        _pinned_pool.setdefault(buf.host.numel(), []).append(buf)


def _copy_stream(device: torch.device) -> torch.cuda.Stream:
    """The copy stream of a CUDA device, created once (raises on failure)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _staging_lock:
        stream = _copy_streams.get(index)
        if stream is None:
            stream = _copy_streams[index] = torch.cuda.Stream(device=index)
        return stream


class _Uploader:
    """One chunked upload into a new contiguous tensor ``out`` on ``dev``:
    ``put(lo, hi, block)`` lands rows [lo, hi) of the host array."""

    def __init__(self, shape, dtype: torch.dtype, dev: torch.device, row_bytes: int):
        self.row_bytes = row_bytes
        self.cuda = dev.type == "cuda"
        if not self.cuda:
            self.out = torch.empty(shape, dtype=dtype, device=dev)
            self.host = self.out.numpy()  # shares out's memory
            return
        self.stream = _copy_stream(dev)
        self.compute = torch.cuda.current_stream(dev)
        # allocated on the copy stream, so the caching allocator never hands
        # the copies a block the caller's queued work may still read; the
        # caller's stream uses it too, so the block is not reused before
        # that stream's work at its release is done
        with torch.cuda.stream(self.stream):
            self.out = torch.empty(shape, dtype=dtype, device=dev)
        self.out.record_stream(self.compute)
        self.flat = self.out.view(-1).view(torch.uint8)
        self.pinned = _take_pinned(self.out.numel() * self.out.element_size())

    def put(self, lo: int, hi: int, block: np.ndarray) -> None:
        if not self.cuda:
            self.host[lo:hi] = block
            return
        a, b = lo * self.row_bytes, hi * self.row_bytes
        pinned = self.pinned
        pinned.claim(a, b)
        flat = np.ascontiguousarray(block).reshape(-1).view(np.uint8)
        if flat.flags.writeable:
            # torch's CPU copy runs on all its threads (numpy's on one)
            pinned.host[a:b].copy_(torch.from_numpy(flat))
        else:  # torch.from_numpy will not view read-only memory
            np.copyto(pinned.array[a:b], flat)
        # the copy stream is current inside the upload (__enter__)
        self.flat[a:b].copy_(pinned.host[a:b], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(self.stream)
        pinned.pending.append((a, b, ev))
        self.compute.wait_event(ev)

    def __enter__(self) -> "_Uploader":
        if self.cuda:
            self._ctx = torch.cuda.stream(self.stream)
            self._ctx.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self.cuda:
            self._ctx.__exit__(*exc)
            _give_pinned(self.pinned)
        return False


def device_put_chunked(arr, device=None, *, site: str, chunks: int | None = None) -> torch.Tensor:
    """Upload a host array (numpy, or a CPU tensor) as row blocks; returns
    the contiguous tensor on ``device``, byte-identical to a monolithic
    copy. ``device=None`` means CUDA."""
    dev = device_mod.resolve(device)
    host = arr.numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    start = time.perf_counter()
    n = int(host.shape[0]) if host.ndim else 1
    nbytes = host.nbytes
    c = _chunk_count(chunks, nbytes, n)
    bounds = [(0, n)] if c <= 1 else _bounds(n, c)
    eng = integrity.get()
    verify = eng.sample_chunks(len(bounds)) if eng.enabled else ()
    with _Uploader(host.shape, torch.from_numpy(np.empty(0, host.dtype)).dtype, dev,
                   nbytes // n if n else 0) as up:
        for idx, (lo, hi) in enumerate(bounds):
            block = host[lo:hi]
            # checksum the pristine source before the wire; the fault site
            # models in-flight damage, which the sink check must catch
            want = integrity.crc32c(block) if idx in verify else None
            flip = faults.fire("transfer.chunk", transfer=site, direction="h2d", index=idx)
            up.put(lo, hi, block if flip is None else flip(block))
            if want is not None:
                _verify_put_chunk(up, lo, hi, block, want, site, idx)
    _record(site, "h2d", nbytes, start)
    return up.out


class RowShards:
    """A (n, ...) array split by rows over the sp devices of one mesh row:
    ``shards[i]`` holds rows [i·n/sp, (i + 1)·n/sp) on the i-th device. What
    ``device_put_sharded_rows`` returns and the row-sharded entries take."""

    __slots__ = ("shards",)

    def __init__(self, shards):
        self.shards = list(shards)

    @property
    def shape(self) -> tuple[int, ...]:
        first = self.shards[0]
        return (sum(int(t.shape[0]) for t in self.shards), *first.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def nbytes(self) -> int:
        return sum(_nbytes(t) for t in self.shards)

    @property
    def devices(self) -> list[torch.device]:
        return [t.device for t in self.shards]


def _put_rows(host: np.ndarray, devices) -> list[torch.Tensor]:
    """Each device's row block of ``host``, uploaded to it: one pinned
    staging copy and one H2D copy a block, each on its device's copy stream."""
    sp = len(devices)
    rows = host.shape[0] // sp
    dtype = torch.from_numpy(np.empty(0, host.dtype)).dtype
    row_bytes = host.nbytes // host.shape[0]
    out = []
    for i, dev in enumerate(devices):
        with _Uploader((rows, *host.shape[1:]), dtype, dev, row_bytes) as up:
            up.put(0, rows, host[i * rows:(i + 1) * rows])
        out.append(up.out)
    return out


def device_put_sharded_rows(arr, mesh, *, site: str) -> RowShards:
    """Upload a host array row-sharded over the mesh's 'sp' axis: each row
    block lands directly on its shard's device (the devices of the mesh's
    first dp row), so a mesh-routed extend never funnels the whole square
    through one device. Its telemetry is one transfer of the array's bytes
    at ``site``; it passes the ``transfer.chunk`` fault site once (index 0)
    and, with audits on, checks the CRC-32C of every byte at the sinks and
    uploads once more from the pristine source before raising, as the JAX
    package's does."""
    host = arr.numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    devices = list(mesh.devices[0])
    if host.shape[0] % len(devices):
        raise ValueError(f"{host.shape[0]} rows do not divide over sp={len(devices)}")
    start = time.perf_counter()
    eng = integrity.get()
    verify = eng.sample_chunks(1) if eng.enabled else ()
    want = integrity.crc32c(host) if 0 in verify else None
    flip = faults.fire("transfer.chunk", transfer=site, direction="h2d", index=0)
    shards = _put_rows(host if flip is None else flip(host), devices)
    if want is not None:
        got = _shards_crc(shards)
        if got != want:
            integrity.record_sdc("transfer.chunk")
            metrics.incr_counter("transfer_retry_total", site=site, direction="h2d")
            flip = faults.fire("transfer.chunk", transfer=site, direction="h2d", index=0,
                               retry=1)
            shards = _put_rows(host if flip is None else flip(host), devices)
            if _shards_crc(shards) != want:
                raise integrity.IntegrityError(
                    f"h2d chunk 0 corrupt after retry at {site} "
                    f"(crc {got:#010x} != {want:#010x})")
    _record(site, "h2d", host.nbytes, start)
    return RowShards(shards)


def _shards_crc(shards: list[torch.Tensor]) -> int:
    """The CRC-32C of the shards' bytes in row order, read back."""
    return integrity.crc32c(np.concatenate([t.cpu().numpy() for t in shards]))


def _verify_put_chunk(up: _Uploader, lo: int, hi: int, pristine: np.ndarray, want: int,
                      site: str, idx: int) -> None:
    """Verify one uploaded chunk at the sink (a readback's CRC against the
    source's); upload it once more from the pristine source before
    raising. Only reached with audits enabled."""
    got = integrity.crc32c(up.out[lo:hi].cpu().numpy())
    if got == want:
        return
    integrity.record_sdc("transfer.chunk")
    metrics.incr_counter("transfer_retry_total", site=site, direction="h2d")
    # the retry re-drives the wire and passes the fault site again: a
    # persistent fault strikes again and the retry fails too
    flip = faults.fire("transfer.chunk", transfer=site, direction="h2d", index=idx, retry=1)
    up.put(lo, hi, pristine if flip is None else flip(pristine))
    if integrity.crc32c(up.out[lo:hi].cpu().numpy()) != want:
        raise integrity.IntegrityError(
            f"h2d chunk {idx} corrupt after retry at {site} (crc {got:#010x} != {want:#010x})")


def device_get_chunked(dev: torch.Tensor, *, site: str, chunks: int | None = None) -> np.ndarray:
    """Download a device tensor as row blocks; returns host bytes
    byte-identical to ``dev.cpu().numpy()``."""
    start = time.perf_counter()
    n = int(dev.shape[0])
    nbytes = _nbytes(dev)
    c = _chunk_count(chunks, nbytes, n)
    parts = [dev] if c <= 1 else [dev[lo:hi] for lo, hi in _bounds(n, c)]
    eng = integrity.get()
    verify = eng.sample_chunks(len(parts)) if eng.enabled else ()
    host_parts = []
    for idx, p in enumerate(parts):
        block = _host(p)
        flip = faults.fire("transfer.chunk", transfer=site, direction="d2h", index=idx)
        if flip is not None:
            block = flip(block)
        if idx in verify:
            block = _verify_get_chunk(block, p, site, idx)
        host_parts.append(block)
    out = host_parts[0] if len(host_parts) == 1 else np.concatenate(host_parts, axis=0)
    _record(site, "d2h", nbytes, start)
    return out


def _verify_get_chunk(block: np.ndarray, dev_part: torch.Tensor, site: str,
                      idx: int) -> np.ndarray:
    """Verify one downloaded chunk at the sink against an independent read
    of the same device rows; on disagreement read a third time and take
    the two that agree. Only reached with audits enabled."""
    check = _host(dev_part)
    if integrity.crc32c(block) == integrity.crc32c(check):
        return block
    integrity.record_sdc("transfer.chunk")
    metrics.incr_counter("transfer_retry_total", site=site, direction="d2h")
    third = _host(dev_part)
    flip = faults.fire("transfer.chunk", transfer=site, direction="d2h", index=idx, retry=1)
    if flip is not None:
        third = flip(third)
    c_third = integrity.crc32c(third)
    if c_third == integrity.crc32c(check):
        return check
    if c_third == integrity.crc32c(block):
        return block
    raise integrity.IntegrityError(f"d2h chunk {idx} corrupt after retry at {site}")
