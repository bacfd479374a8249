"""Node: the serving reads of a full node (port of the serving half of the
JAX package's node/node.py).

Light clients sample a block's extended square: each ``/sample`` names a
(height, row, column) and gets the share with its NMT range proof against
the row root of the block's DAH. This module answers such samples from the
node's serving cache: ``sample_batch`` for one height, and
``sample_batch_ragged`` for a crowd across heights, which gathers every
row the crowd needs from the paged cache in one ragged gather per page
geometry (``PagedEdsCache.pages_batch``).

Squares enter through ``node._eds_cache.put(height, eds)``, the call the
JAX node's ExtendBlock retention makes; an embedder that wants whole
squares resident assigns a ``ResidentEdsCache`` to ``node._eds_cache``.
The App, mempool, block production and the durable store come with later
slices of the port.
"""

from __future__ import annotations

import contextlib
import logging

from celestia_tpu_torch import da, integrity, tracing
from celestia_tpu_torch import device as device_mod
from celestia_tpu_torch.node import eds_cache
from celestia_tpu_torch.ops import extend, ragged
from celestia_tpu_torch.proof import NmtRowProver, das_sample_docs

log = logging.getLogger(__name__)


class Node:
    """The serving surface of a node over its EDS cache.

    ``app``: an object whose ``published_eds`` (height -> square) takes
    precedence over the cache, as a MaliciousApp's published squares do in
    the JAX package; None for none. ``device``: where the cache's pages and
    the provers' row levels live (None means CUDA)."""

    _PROVER_CACHE_HEIGHTS = 4

    def __init__(self, app=None, device=None):
        self.app = app
        self.device = device_mod.resolve(device)
        # blocks are immutable: /dah answers come from a per-height memo
        self._dah_cache: dict[int, object] = {}
        self.store = None  # the durable tier is not ported yet
        self._eds_cache = eds_cache.PagedEdsCache(device=self.device)
        # per-height NMT row-prover memo for the batched sample path: a
        # square with a device buffer seeds every row's subtree memo from
        # one device call (``extend.eds_row_levels_device``); other squares
        # get hash-once host provers that persist across batches.
        # Entry: (levels | None, {row: prover}).
        self._prover_cache: dict[int, tuple] = {}

    def block_eds(self, height: int):
        """The (2k, 2k, 512) extended square of a block: a published
        square first, then the serving cache (an ``ExtendedDataSquare``,
        a ``PagedEds`` or a host array); None when neither holds it."""
        published = getattr(self.app, "published_eds", None)
        if published and height in published:
            return published[height]
        return self._eds_cache.get(height)

    @contextlib.contextmanager
    def _borrow_eds(self, height: int):
        """Pin-guarded access to a block's square for serving reads: while
        the context is open the cache cannot evict it. Published squares
        keep their precedence and are never evicted."""
        published = getattr(self.app, "published_eds", None)
        if published and height in published:
            yield published[height]
            return
        with self._eds_cache.pinned(height) as pinned:
            if pinned is not None:
                yield pinned
                return
        yield self.block_eds(height)

    def block_width(self, height: int) -> int | None:
        """Extended-square width of a block, whatever holds it."""
        with self._borrow_eds(height) as eds:
            if eds is None:
                return None
            if hasattr(eds, "original_width"):
                return eds.width
            return int(eds.shape[0])

    def block_row(self, height: int, i: int) -> list[bytes] | None:
        """Row i of a block's square as share bytes, the DAS serving read:
        a device-resident square moves only this row's w·512 bytes."""
        with self._borrow_eds(height) as eds:
            if eds is None:
                return None
            if hasattr(eds, "original_width"):
                return eds.row(i)
            return [bytes(eds[i, c]) for c in range(eds.shape[0])]

    def block_share(self, height: int, r: int, c: int) -> bytes | None:
        """One cell of a block's square (512 bytes moved for a
        device-resident square)."""
        with self._borrow_eds(height) as eds:
            if eds is None:
                return None
            if hasattr(eds, "original_width"):
                return eds.share(r, c)
            return bytes(eds[r, c])

    def sample_batch(self, height: int, coords) -> list:
        """Answer a micro-batch of DAS samples of ONE height. Distinct rows
        are fetched as one batched read and each row's leaves are hashed
        once (or seeded from the device's row levels). Returns one entry a
        coordinate: a response document, the "range" sentinel, or None when
        the block is unknown.

        A page whose fault-in checksum fails (IntegrityError) heals once:
        the height is invalidated and the batch answered again."""
        try:
            return self._sample_batch(height, coords)
        except integrity.IntegrityError:
            if not hasattr(self._eds_cache, "invalidate"):
                raise
            log.info("eds page corrupt; invalidating height %d", height)
            self._eds_cache.invalidate(height)
            # provers seeded from the same square go with it
            self._prover_cache.pop(height, None)
            return self._sample_batch(height, coords)

    def sample_batch_ragged(self, payloads) -> list:
        """Answer a micro-batch of DAS samples ACROSS heights, each payload
        (height, row, col). Heights in the paged cache contribute their
        distinct rows to one ragged page-table gather, so the group costs
        one kernel launch per page geometry instead of a read per height.
        Every document is byte-identical to the per-height
        ``sample_batch`` path, sentinels included.

        The heal is per height: a poisoned fault-in invalidates only the
        height it names (``err.height``) and the group is answered again; a
        second corruption of a healed height raises."""
        healed: set[int] = set()
        while True:
            try:
                return self._sample_batch_ragged(payloads)
            except integrity.IntegrityError as err:
                if not hasattr(self._eds_cache, "invalidate"):
                    raise
                height = getattr(err, "height", None)
                targets = ([int(height)] if height is not None
                           else sorted({int(h) for h, _i, _j in payloads}))
                if any(h in healed for h in targets):
                    raise
                for h in targets:
                    log.info("eds page corrupt; invalidating height %d", h)
                    self._eds_cache.invalidate(h)
                    self._prover_cache.pop(h, None)
                    healed.add(h)

    def _sample_batch_ragged(self, payloads) -> list:
        jobs = [(int(h), int(i), int(j)) for h, i, j in payloads]
        by_height: dict[int, list[int]] = {}
        for t, (h, _i, _j) in enumerate(jobs):
            by_height.setdefault(h, []).append(t)
        out: list = [None] * len(jobs)
        with ragged.ragged_span(len(by_height), len(jobs)), \
                contextlib.ExitStack() as borrows:
            # borrow every height up front: the pins outlive the gather and
            # the proving, like the per-height path's one borrow
            plan: list = []       # (h, eds, w, valid, rows_needed)
            wants: list = []      # (PagedEds, row): the ragged gather's feed
            want_slot: dict = {}  # (h, row) -> index into wants
            for h, ts in by_height.items():
                eds = borrows.enter_context(self._borrow_eds(h))
                if eds is None:
                    continue  # out[t] stays None: unknown block
                w = eds.width if hasattr(eds, "original_width") else int(eds.shape[0])
                for t in ts:
                    out[t] = "range"
                valid = [t for t in ts if 0 <= jobs[t][1] < w and 0 <= jobs[t][2] < w]
                if not valid:
                    continue
                rows_needed = sorted({jobs[t][1] for t in valid})
                plan.append((h, eds, w, valid, rows_needed))
                if isinstance(eds, eds_cache.PagedEds) and eds._cache is self._eds_cache:
                    for i in rows_needed:
                        want_slot[(h, i)] = len(wants)
                        wants.append((eds, i))
            with tracing.stage("device"):
                gathered = self._eds_cache.pages_batch(wants) if wants else []
                rows_of: dict[int, dict] = {}
                for h, eds, w, _valid, rows_needed in plan:
                    if (h, rows_needed[0]) in want_slot:
                        rows = {i: gathered[want_slot[(h, i)]] for i in rows_needed}
                    else:
                        rows = self._rows(eds, rows_needed, w)
                    rows_of[h] = rows
            with tracing.stage("prove"):
                for h, eds, w, valid, rows_needed in plan:
                    docs = das_sample_docs(
                        rows_of[h], [(jobs[t][1], jobs[t][2]) for t in valid], w // 2,
                        provers=self._row_provers(h, eds, rows_needed))
                    for t, doc in zip(valid, docs):
                        out[t] = doc
        return out

    @staticmethod
    def _rows(eds, rows_needed: list[int], w: int) -> dict[int, list[bytes]]:
        """The rows of a square not served by the ragged gather."""
        if hasattr(eds, "rows_batch"):
            return dict(zip(rows_needed, eds.rows_batch(rows_needed)))
        if hasattr(eds, "original_width"):
            return {i: eds.row(i) for i in rows_needed}
        return {i: [bytes(eds[i, c]) for c in range(w)] for i in rows_needed}

    def _row_provers(self, height: int, eds, rows_needed) -> dict:
        """Per-height prover memo for ``das_sample_docs``.

        The first touch of a height whose square has a device buffer (or is
        a raw host array while the node's device is a card) runs ONE
        ``eds_row_levels_device`` call over all rows (K2 on the EDS, then
        the tree kernel with the row levels) and keeps the levels; each
        referenced row then gets its prover through
        ``NmtRowProver.from_node_levels``, with no host hashing. Other
        squares (a PagedEds has no single device buffer) get a dict that
        ``das_sample_docs`` fills with host-built provers, which persist
        across batches of the height. A failure of the device call raises."""
        entry = self._prover_cache.get(height)
        if entry is None:
            arr = getattr(eds, "device_data", None)
            if (arr is None and not hasattr(eds, "original_width")
                    and self.device.type != "cpu"):
                arr = eds  # a raw host array, worth the card's round trip
            levels = None
            if arr is not None:
                levels = extend.eds_row_levels_device(arr, self.device)
            while len(self._prover_cache) >= self._PROVER_CACHE_HEIGHTS:
                self._prover_cache.pop(next(iter(self._prover_cache)))
            entry = (levels, {})
            self._prover_cache[height] = entry
        levels, provers = entry
        if levels is not None:
            for i in rows_needed:
                if i not in provers:
                    provers[i] = NmtRowProver.from_node_levels(
                        [levels[lv][i] for lv in range(len(levels))])
        return provers

    def _sample_batch(self, height: int, coords) -> list:
        coords = [(int(i), int(j)) for i, j in coords]
        with self._borrow_eds(height) as eds:
            if eds is None:
                return [None] * len(coords)
            w = eds.width if hasattr(eds, "original_width") else int(eds.shape[0])
            out: list = ["range"] * len(coords)
            valid = [t for t, (i, j) in enumerate(coords) if 0 <= i < w and 0 <= j < w]
            if not valid:
                return out
            rows_needed = sorted({coords[t][0] for t in valid})
            # stage attribution: "device" covers the row fetch, "prove" the
            # prover seeding and the proofs (no-ops unless a stage sink is
            # installed)
            with tracing.stage("device"):
                rows = self._rows(eds, rows_needed, w)
            with tracing.stage("prove"):
                docs = das_sample_docs(rows, [coords[t] for t in valid], w // 2,
                                       provers=self._row_provers(height, eds, rows_needed))
        for t, doc in zip(valid, docs):
            out[t] = doc
        return out

    def block_dah(self, height: int):
        """The DataAvailabilityHeader a block's data hash commits to (the
        row and column NMT roots), memoized per height. A paged square is
        materialized on the host once and its roots computed on the node's
        device (``extend.eds_roots_device``)."""
        dah = self._dah_cache.get(height)
        if dah is not None:
            return dah
        # the roots read the whole square: the borrow keeps it pinned
        with self._borrow_eds(height) as eds:
            if eds is None:
                return None
            if not hasattr(eds, "original_width"):
                eds = da.ExtendedDataSquare(eds, eds.shape[0] // 2, self.device)
            dah = da.new_data_availability_header(eds)
        self._dah_cache[height] = dah
        return dah
