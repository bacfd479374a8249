"""The 3-deep block pipeline: H2D, compute and D2H of consecutive blocks
overlapped on CUDA streams (port of the JAX package's node/pipeline.py).

A proposer or a catching-up replayer streaming consecutive blocks spends
its wall time in three legs on disjoint hardware: staging the square to the
card (copy engine), the extend with its roots, DAH and row levels
(compute), and fetching the results back (copy engine). Run serially, each
block pays all three; this pipeline keeps every leg busy: while block N-1's
results stream back, block N computes and block N+1's shares stage.

Mechanics, on a CUDA device:

- ``feed(height, shares)`` admits one block. The h2d leg stages the square
  through ``transfers.device_put_chunked`` (site ``pipeline.h2d``): pinned
  chunks on the copy stream, the compute stream waiting on their events.
  While a mesh whose 'sp' divides k is configured
  (``parallel.configure_mesh``), it stages through
  ``transfers.device_put_sharded_rows`` instead, each row block onto its
  shard, and the compute leg runs the mesh's fused pass (Row C,
  ``parallel.extend_root_levels_rowsharded``), whose results gather onto
  the mesh's first device: the pipeline's own device, or ``feed`` raises.
  The compute leg queues ``extend.extend_root_levels_staged`` on the
  pipeline's compute stream, records an event after it, and queues the
  fetch: a D2H stream of the pipeline's own waits on that event alone and
  copies every result into the block's set of pinned host buffers, then
  records the fetch's event. Nothing waits for
  the card, so ``feed`` returns at once until the pipeline is ``depth``
  blocks deep; then it retires the OLDEST block, whose d2h leg waits on that
  block's fetch event only: the younger blocks' compute and staging go on
  meanwhile. A fetch on the compute stream, or a synchronous ``.cpu()``,
  would wait for all of them and run the pipeline serially.
- The compute stream is the stream current on the constructing thread, and
  every leg runs under it, whichever thread runs the leg: with a
  dispatcher attached the legs run on its thread
  (``DeviceDispatcher.run_device``, labelled per leg), and PyTorch's
  current stream is per thread.
- Buffers: each result is allocated on the compute stream and read by the
  D2H stream, so it is marked with ``record_stream`` for the D2H stream
  before its copy. The pinned host buffers are a ring of ``depth`` result
  sets, made at their first fetch and reused in turn: block n fetches into
  block n - depth's set, which retired before block n was fed, and a set
  is written again only after its last fetch's event has completed. A
  retirement copies its set into pageable numpy arrays, so the caller may
  keep a block (the node caches its EDS and levels) without holding page-
  locked memory, and a stream allocates no pinned memory after its first
  ``depth`` blocks. The pageable arrays come from ``HOST_POOL``, which
  hands a buffer out again once every array on it has been dropped: fresh
  memory's first touch costs more than the copy. Each in-flight record keeps its staged input alive
  until retirement, as in the JAX package.
- ``begin_drain()`` closes admission (``Shed("draining")``); ``drain()``
  retires everything in flight, oldest first, and returns it.

On the CPU (``device="cpu"``) the legs run the plain versions in order and
the results are the tensors' own memory.

Fault site: ``pipeline.block`` fires in ``feed`` before staging: an
``error`` rule sheds the block at the door, a ``bitflip`` rule damages the
staged shares.

Telemetry: ``pipeline_fed_total`` counts admitted blocks,
``pipeline_blocks_total`` retired ones, ``pipeline_inflight`` gauges the
depth, and each leg's wall time lands in the ``pipeline_stage`` histogram
and a ``pipeline.stage`` span (stage=h2d|compute|d2h). The walls are time
spent in the call, the quantity overlap shrinks. The in-flight records'
device bytes are the device ledger's ``pipeline_inflight`` owner.
"""

from __future__ import annotations

import collections
import threading
import time
import weakref

import numpy as np
import torch

from celestia_tpu_torch import device as device_mod
from celestia_tpu_torch import devledger, faults, tracing
from celestia_tpu_torch.node.dispatch import Shed
from celestia_tpu_torch.ops import extend, transfers
from celestia_tpu_torch.telemetry import metrics


class PipelinedBlock:
    """One retired block: numpy EDS, roots and DAH, and the row-tree level
    stack that seeds ``proof.NmtRowProver.from_node_levels`` with no host
    hashing."""

    __slots__ = ("height", "eds", "row_roots", "col_roots", "dah", "levels")

    def __init__(self, height, eds, row_roots, col_roots, dah, levels):
        self.height = height
        self.eds = eds
        self.row_roots = row_roots
        self.col_roots = col_roots
        self.dah = dah
        self.levels = levels


def _results(outs) -> list[torch.Tensor]:
    """The staged extend's results as a retirement fetches them: the EDS,
    the row and column roots, the DAH, then each row level."""
    eds, rows, cols, dah, levels = outs
    return [eds, rows, cols, dah, *levels]


class _Lease:
    """Owns one pooled host buffer for as long as any array on it lives:
    every numpy view, and any tensor made from one, reaches its memory
    through this object (the buffer protocol), so its finalizer runs only
    once the last of them is gone."""

    __slots__ = ("_buf", "__weakref__")

    def __init__(self, buf: np.ndarray):
        self._buf = buf

    def __buffer__(self, flags: int) -> memoryview:
        return memoryview(self._buf)


class HostPool:
    """Pageable host buffers for retired blocks, recycled by size. The first
    touch of fresh memory costs more than the copy into it (a k = 128
    block's 44 MB), so a buffer whose arrays the consumer has dropped (a
    node evicting a height) is handed out again. At most ``KEEP`` free
    buffers of each size are held (a depth-3 pipeline and one block its
    consumer drops); the rest go back to the system."""

    KEEP = 4

    def __init__(self):
        self._free: dict[int, list[np.ndarray]] = collections.defaultdict(list)
        self._lock = threading.Lock()
        self.fresh = 0
        self.reused = 0

    def array(self, shape, dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        with self._lock:
            free = self._free[nbytes]
            buf = free.pop() if free else None
            if buf is None:
                self.fresh += 1
            else:
                self.reused += 1
        if buf is None:
            buf = np.empty(nbytes, np.uint8)
        lease = _Lease(buf)
        weakref.finalize(lease, self._give_back, buf)
        return np.frombuffer(lease, dtype=dtype).reshape(shape)

    def _give_back(self, buf: np.ndarray) -> None:
        with self._lock:
            free = self._free[buf.nbytes]
            if len(free) < self.KEEP:
                free.append(buf)


HOST_POOL = HostPool()


def _pageable(h: torch.Tensor) -> np.ndarray:
    """A pageable numpy copy of a pinned buffer, in a buffer of the host
    pool; torch copies on its intra-op threads."""
    out = HOST_POOL.array(h.shape, h.numpy().dtype)
    torch.from_numpy(out).copy_(h)
    return out


def _nbytes(x) -> int:
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(v) for v in x)
    return int(getattr(x, "nbytes", 0) or 0)


class BlockPipeline:
    DEFAULT_DEPTH = 3

    def __init__(self, k: int, *, dispatcher=None, depth: int = DEFAULT_DEPTH,
                 on_block=None, device=None):
        self.k = int(k)
        self.device = device_mod.resolve(device)
        self.dispatcher = dispatcher
        self.depth = max(1, int(depth))
        self.on_block = on_block  # callable(PipelinedBlock)
        self._inflight: collections.deque = collections.deque()
        self._draining = False
        self._fed = 0
        self._retired = 0
        self._stage_wall = {"h2d": 0.0, "compute": 0.0, "d2h": 0.0}
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._compute = torch.cuda.current_stream(self.device)
            self._d2h = torch.cuda.Stream(device=self.device)
        # per slot: the pinned result set and its last fetch's event
        self._ring: list[tuple[list[torch.Tensor], torch.cuda.Event] | None] = [None] * self.depth
        devledger.register_owner("pipeline_inflight", self.device_bytes)

    # -- introspection -------------------------------------------------- #

    def device_bytes(self) -> int:
        """Device bytes of the in-flight records' staged inputs and results,
        the device ledger's owner callback. The audit runs from other
        threads, so it walks a snapshot of the deque (``list()`` is
        atomic)."""
        return sum(_nbytes((dev, outs)) for _h, dev, outs, _f in list(self._inflight))

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    @property
    def draining(self) -> bool:
        return self._draining

    def stats(self) -> dict:
        """Counters and each leg's wall seconds (time in the call: the legs
        that overlap shrink)."""
        return {
            "fed": self._fed,
            "retired": self._retired,
            "inflight": len(self._inflight),
            "stage_wall_s": dict(self._stage_wall),
        }

    # -- device legs ---------------------------------------------------- #

    def _run(self, fn, label: str):
        def leg():
            if not self._cuda:
                return fn()
            with torch.cuda.stream(self._compute):
                return fn()

        d = self.dispatcher
        if d is not None:
            return d.run_device(leg, label=label)
        return leg()

    def _leg(self, stage: str, height, fn):
        with tracing.span("pipeline.stage", stage=stage, height=height, k=self.k):
            t0 = time.perf_counter()
            out = self._run(fn, f"pipeline.{stage}")
            elapsed = time.perf_counter() - t0
        self._stage_wall[stage] += elapsed
        metrics.observe("pipeline_stage", elapsed, stage=stage)
        return out

    def _stage_h2d(self, shares: np.ndarray):
        mesh = extend._mesh_if_divisible(self.k)
        if mesh is None:
            return transfers.device_put_chunked(shares, self.device, site="pipeline.h2d")
        if not device_mod.same(mesh.first, self.device):
            raise ValueError(f"the mesh gathers onto {mesh.first}, the pipeline runs on "
                             f"{self.device}")
        return transfers.device_put_sharded_rows(shares, mesh, site="pipeline.h2d")

    def _compute_and_fetch(self, dev: torch.Tensor, slot: int):
        """Queue the extend on the compute stream and the fetch of its
        results into the ring's ``slot`` on the D2H stream behind the
        compute's event. Returns the device results and (pinned buffers,
        the fetch's event), None on the CPU."""
        outs = extend.extend_root_levels_staged(dev)
        if not self._cuda:
            return outs, None
        results = _results(outs)
        if self._ring[slot] is None:
            hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in results]
        else:
            hosts, last = self._ring[slot]
            last.synchronize()  # retired already: a no-op, unless a retirement failed
        done = torch.cuda.Event()
        done.record(self._compute)
        with torch.cuda.stream(self._d2h):
            self._d2h.wait_event(done)
            for t, h in zip(results, hosts):
                t.record_stream(self._d2h)  # allocated on compute, read here
                h.copy_(t, non_blocking=True)
            fetched = torch.cuda.Event()
            fetched.record(self._d2h)
        self._ring[slot] = (hosts, fetched)
        return outs, (hosts, fetched)

    # -- admission / retirement ----------------------------------------- #

    def feed(self, height, shares) -> PipelinedBlock | None:
        """Admit one block; returns the block retired to make room once the
        pipeline is ``depth`` deep, else None while it fills."""
        if self._draining:
            raise Shed("draining")
        flip = faults.fire("pipeline.block", height=height)
        shares = np.asarray(shares)
        if flip is not None:
            shares = flip(shares)
        if shares.shape[0] != self.k:
            raise ValueError(f"pipeline built for k={self.k}, got k={shares.shape[0]}")
        dev = self._leg("h2d", height, lambda: self._stage_h2d(shares))
        slot = self._fed % self.depth
        outs, fetch = self._leg("compute", height, lambda: self._compute_and_fetch(dev, slot))
        # dev rides in the record: the staged input stays alive until this
        # block retires
        self._inflight.append((height, dev, outs, fetch))
        self._fed += 1
        metrics.incr_counter("pipeline_fed_total")
        metrics.set_gauge("pipeline_inflight", float(len(self._inflight)))
        if len(self._inflight) >= self.depth:
            return self._retire()
        return None

    def _retire(self) -> PipelinedBlock:
        height, _dev, outs, fetch = self._inflight.popleft()

        def fetch_wait() -> list[np.ndarray]:
            if fetch is None:
                return [t.numpy() for t in _results(outs)]
            hosts, fetched = fetch
            fetched.synchronize()  # this block's copies only
            return [_pageable(h) for h in hosts]  # the pinned set goes back to the ring

        eds, rows, cols, dah, *levels = self._leg("d2h", height, fetch_wait)
        block = PipelinedBlock(height, eds, rows, cols, dah, levels)
        self._retired += 1
        metrics.incr_counter("pipeline_blocks_total")
        metrics.set_gauge("pipeline_inflight", float(len(self._inflight)))
        if self.on_block is not None:
            self.on_block(block)
        return block

    def begin_drain(self) -> None:
        """Close admission: later ``feed`` calls raise Shed("draining");
        in-flight blocks still retire through ``drain``."""
        self._draining = True

    def drain(self) -> list[PipelinedBlock]:
        """Retire every in-flight block, oldest first, and return them.
        Admission stays closed; safe to call again."""
        self.begin_drain()
        out = []
        while self._inflight:
            out.append(self._retire())
        return out
