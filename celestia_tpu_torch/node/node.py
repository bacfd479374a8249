"""Node: mempool, block production, block store and the serving reads of a
full node (port of the JAX package's node/node.py).

A node over an App runs the chain's block path: ``broadcast_tx`` admits a
tx through CheckTx into the priority mempool (and stages a PFB's blobs in
the App's blob arena, when it has one); ``produce_block`` reaps the
mempool into PrepareProposal and applies the proposal; a replica applies a
block decided elsewhere through ``apply_external_block``. Application is
ProcessProposal, BeginBlock, DeliverTx, EndBlock and Commit under the
node's lock, then the block's bookkeeping (the block store, ``blocks/<h>.json``
under a home, the tx index, the mempool), then, with ``extend_blocks``,
ExtendBlock retention: the committed square's EDS goes into the serving
cache and is persisted to the BlockStore. Snapshots, state sync and a
restart that replays the blocks newer than its snapshot (checking their
data roots in one batched device call) are here too.

The node runs on its App's device. Without an App the node serves reads
only, as a light serving node: its block methods raise, and ``device``
(None means CUDA) is where its cache's pages and provers' row levels live.

Light clients sample a block's extended square: each ``/sample`` names a
(height, row, column) and gets the share with its NMT range proof against
the row root of the block's DAH. ``sample_batch`` answers samples of one
height, and ``sample_batch_ragged`` a crowd across heights, gathering every
row the crowd needs from the paged cache in one ragged gather per page
geometry (``PagedEdsCache.pages_batch``).

A node with a ``home`` keeps the durable tier: a ``BlockStore`` under
``home/store``, re-indexed when the node starts and put below the paged
cache. ``_persist_block_eds(height, eds)`` writes a square's pages, its
served DAH and (for a square with a device buffer) its row levels from
``extend.eds_row_levels_device``, fetching the square once. A restarted
node serves a persisted height from disk: ``block_eds`` adopts it page by
page (``PagedEdsCache.load_from_store``), its provers come from the stored
levels with no hashing, and ``block_dah`` answers the stored DAH byte for
byte. A height that neither the cache nor the store can serve is rebuilt
on the host from the node's blocks.

``extend_pipeline(k)`` streams consecutive squares through a 3-deep block
pipeline (``node/pipeline.py``) and adopts each retired block into the
DAH memo, the cache, the provers' levels and the store. A dispatcher
attached as ``node.dispatcher`` (``node/dispatch.py``; a server attaches its
own, and registers its ``run_device`` with ``transfers``) runs blob staging
and the pipeline's legs on its thread.

Where the port differs from the JAX node: retention degrades only where
the device is unavailable (``faults.DeviceUnavailable``), a result or a
page failed its check (``integrity.IntegrityError``) or the disk failed
(``OSError``), and each such failure is counted in
``node_retention_failures_total{reason}``; any other exception propagates
out of block application, which does the block's bookkeeping before the
retention so that the block store, tx index and mempool stay consistent
with the committed App. The persist has a span of its own,
``node.persist``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import pathlib
import threading
import time

import numpy as np
import torch

from celestia_tpu_torch import da, faults, integrity, tracing
from celestia_tpu_torch import device as device_mod
from celestia_tpu_torch.log import logger
from celestia_tpu_torch.node import eds_cache
from celestia_tpu_torch.ops import extend, ragged, transfers
from celestia_tpu_torch.proof import NmtRowProver, das_sample_docs
from celestia_tpu_torch.store import BlockStore
from celestia_tpu_torch.telemetry import metrics

log = logger("node")

MEMPOOL_TTL_BLOCKS = 5  # ref: app/default_overrides.go:237-245 (v1 mempool TTL)
DEFAULT_MAX_TX_BYTES = 7_897_088  # max-square bytes, DefaultConsensusConfig
# what block application catches around ExtendBlock retention and the
# persist: the device is unavailable, a result or page failed its check, or
# the disk failed. The height is then served by the host rebuild.
RETENTION_FAULTS = (faults.DeviceUnavailable, integrity.IntegrityError, OSError)


def tx_hash(raw: bytes) -> bytes:
    return hashlib.sha256(raw).digest()


@dataclasses.dataclass
class MempoolTx:
    raw: bytes
    priority: int
    height_added: int


class Mempool:
    """Priority-ordered mempool with block-TTL eviction (the capability
    surface of celestia-core's v1 prioritized mempool / CAT pool specs,
    specs/src/specs/cat_pool.md)."""

    def __init__(self, ttl_blocks: int = MEMPOOL_TTL_BLOCKS,
                 max_tx_bytes: int = DEFAULT_MAX_TX_BYTES):
        self.txs: dict[bytes, MempoolTx] = {}
        self.ttl_blocks = ttl_blocks
        self.max_tx_bytes = max_tx_bytes
        # every key this pool has ever admitted (height-bounded): the CAT
        # want/have answer, so a peer offering a tx we hold OR already
        # processed gets "don't send" instead of the raw bytes
        self._seen: dict[bytes, int] = {}

    def add(self, raw: bytes, priority: int, height: int) -> bytes:
        if len(raw) > self.max_tx_bytes:
            raise ValueError(f"tx exceeds max size {self.max_tx_bytes}")
        key = tx_hash(raw)
        if key not in self.txs:
            self.txs[key] = MempoolTx(raw=raw, priority=priority, height_added=height)
        self._seen[key] = height
        return key

    def remove(self, key: bytes) -> None:
        self.txs.pop(key, None)

    def has_seen(self, key: bytes) -> bool:
        """True when this pool holds or recently processed the tx, the
        want/have reply (want = NOT seen)."""
        return key in self.txs or key in self._seen

    def reap(self, max_bytes: int | None = None) -> list[bytes]:
        """Highest-priority txs first (stable within equal priority)."""
        ordered = sorted(self.txs.values(), key=lambda t: (-t.priority, t.height_added))
        out: list[bytes] = []
        total = 0
        for t in ordered:
            if max_bytes is not None and total + len(t.raw) > max_bytes:
                continue
            out.append(t.raw)
            total += len(t.raw)
        return out

    def evict_expired(self, height: int) -> int:
        expired = [k for k, t in self.txs.items() if height - t.height_added >= self.ttl_blocks]
        for k in expired:
            del self.txs[k]
            # a TTL-expired tx was never committed: forgetting it lets a
            # legitimate resubmission propagate again
            self._seen.pop(k, None)
        # seen records outlive the pool entry by one more TTL window, so late
        # duplicate offers are still deduplicated, then age out
        stale = [k for k, h in self._seen.items() if height - h >= 2 * self.ttl_blocks]
        for k in stale:
            del self._seen[k]
        return len(expired)

    def __len__(self) -> int:
        return len(self.txs)


@dataclasses.dataclass
class Block:
    height: int
    time: float
    txs: list[bytes]
    square_size: int
    data_hash: bytes
    app_hash: bytes
    tx_results: list = dataclasses.field(default_factory=list)
    # slashing.Equivocation entries delivered with this block. Evidence is
    # state-affecting (BeginBlock slashes from it), so the block store
    # carries it, or a crash replay would recompute another app hash
    evidence: list = dataclasses.field(default_factory=list)
    # the app version the square was BUILT at: a historical square is
    # rebuilt with the block's own rules. None: rebuild at current rules.
    version: int | None = None

    def to_json(self) -> dict:
        return {
            "height": self.height,
            "time": self.time,
            "txs": [t.hex() for t in self.txs],
            "square_size": self.square_size,
            "data_hash": self.data_hash.hex(),
            "app_hash": self.app_hash.hex(),
            "version": self.version,
            "tx_results": [
                {"code": r.code, "log": r.log, "gas_used": r.gas_used}
                for r in self.tx_results
            ],
            "evidence": [
                {"validator": e.validator, "height": e.height, "power": e.power}
                for e in self.evidence
            ],
        }

    @classmethod
    def from_json(cls, d: dict) -> "Block":
        from celestia_tpu_torch.app.app import TxResult
        from celestia_tpu_torch.x.slashing import Equivocation

        return cls(
            height=d["height"],
            time=d["time"],
            txs=[bytes.fromhex(t) for t in d["txs"]],
            square_size=d["square_size"],
            data_hash=bytes.fromhex(d["data_hash"]),
            app_hash=bytes.fromhex(d["app_hash"]),
            tx_results=[
                TxResult(code=r["code"], log=r["log"], gas_used=r["gas_used"])
                for r in d.get("tx_results", [])
            ],
            version=d.get("version"),
            evidence=[
                Equivocation(validator=e["validator"], height=e["height"],
                             power=e.get("power", 0))
                for e in d.get("evidence", [])
            ],
        )


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == \
        (b.index if b.index is not None else current)


class Node:
    """One-validator chain driver over an App, and the serving surface of a
    node over its EDS cache.

    ``app``: the port's App (the node then runs on ``app.device``; a
    ``device`` that names another raises), or None for a node that serves
    reads only, or an object whose ``published_eds`` (height -> square)
    takes precedence over the cache, as a MaliciousApp's published squares
    do. ``home``: the node's directory: ``blocks/`` for the block store
    (a node with an App), ``state.json`` and ``meta.json`` for its
    snapshot, and the BlockStore under ``store/``, opened and re-indexed
    here. ``extend_blocks``: ExtendBlock retention after every commit.
    ``device``: where a node without an App keeps its pages and provers'
    levels (None means CUDA)."""

    _PROVER_CACHE_HEIGHTS = 4
    MAX_FRAUD_PROOFS_PER_HEIGHT = 4

    def __init__(self, app=None, home=None, extend_blocks: bool = False, device=None):
        self.app = app
        app_device = getattr(app, "device", None)
        if app_device is not None:
            if device is not None and not _same_device(torch.device(device), app_device):
                raise ValueError(f"the node's device {device} is not its App's {app_device}")
            self.device = app_device
        else:
            self.device = device_mod.resolve(device)
        self.extend_blocks = extend_blocks
        self.mempool = Mempool()
        self.blocks: dict[int, Block] = {}
        self.tx_index: dict[bytes, tuple[int, int]] = {}  # hash -> (height, idx)
        # verified Bad Encoding Fraud Proofs: height -> dah_hash_hex -> wire
        # JSON, keyed by the DAH hash (a height alone could be squatted by a
        # proof of an unrelated bad square) and capped per height
        self.fraud_proofs: dict[int, dict[str, dict]] = {}
        # O(1) "is this data hash proven fraudulent" for the consensus path
        self.fraudulent_data_hashes: set[bytes] = set()
        # blocks are immutable: /dah answers come from a per-height memo
        self._dah_cache: dict[int, object] = {}
        self.home = pathlib.Path(home) if home else None
        if self.home and self._has_block_path():
            (self.home / "blocks").mkdir(parents=True, exist_ok=True)
        # the durable third tier: persisted squares (pages, DAH, row levels)
        # in a CRC-guarded BlockStore, re-indexed at start, so a restarted
        # node serves its history from disk. A disk that cannot hold the
        # store leaves the node without one, as in the JAX package.
        self.store = None
        if self.home:
            try:
                self.store = BlockStore(self.home / "store")
                self.store.reindex()
            except OSError as e:
                log.info("block store unavailable", error=str(e))
                self.store = None
        # heights whose store copy failed its CRC on a read: refused until
        # they are persisted again
        self._store_refused: set[int] = set()
        self._eds_cache = eds_cache.PagedEdsCache(store=self.store, device=self.device)
        # per-height NMT row-prover memo for the batched sample path: a
        # square with a device buffer seeds every row's subtree memo from
        # one device call (``extend.eds_row_levels_device``); other squares
        # get hash-once host provers that persist across batches.
        # Entry: (levels | None, {row: prover}).
        self._prover_cache: dict[int, tuple] = {}
        # State-mutating entries (CheckTx, block application, the fraud
        # ledger) serialize on this lock; read-only queries go lock-free
        # (dict reads are atomic, committed-store writes happen only under
        # the lock at Commit)
        self._lock = threading.RLock()
        # observability attachments: the /status uptime anchor, the SLO
        # engine and the synthetic DAS prober, attached by their owners
        self.started_at = time.monotonic()
        self.slo = None
        self.prober = None
        # the device dispatcher, attached by the RPC server that serves
        # this node; None when embedded
        self.dispatcher = None

    def _has_block_path(self) -> bool:
        return hasattr(self.app, "check_tx")

    def _need_app(self):
        if not self._has_block_path():
            raise RuntimeError("this node has no App: it serves reads only")
        return self.app

    # --- the fraud-proof ledger ---

    def add_fraud_proof(self, height: int, dah_hash: bytes, wire: dict,
                        force: bool = False) -> bool:
        """Store a VERIFIED fraud proof. Returns False when already known or
        the per-height cap is hit (the spam bound).

        force: the caller has bound dah_hash to a commit certificate or a
        committed block, the proof of record for the height. It bypasses
        (and if needed evicts a decoy from) the cap, so valid proofs of
        unrelated junk squares cannot suppress it."""
        with self._lock:
            at_height = self.fraud_proofs.setdefault(height, {})
            key = dah_hash.hex()
            if key in at_height:
                return False
            if len(at_height) >= self.MAX_FRAUD_PROOFS_PER_HEIGHT:
                if not force:
                    return False
                for k in list(at_height):  # evict an unforced decoy
                    if not at_height[k].get("_certified"):
                        del at_height[k]
                        break
            # _certified is LOCAL provenance: never trusted from a wire,
            # always restamped from the caller's own verification
            wire = {k: v for k, v in wire.items() if k != "_certified"}
            if force:
                wire["_certified"] = True
            at_height[key] = wire
            self.fraudulent_data_hashes.add(dah_hash)
            return True

    def fraud_proofs_at(self, height: int) -> list[dict]:
        """The height's stored proofs, copied under the lock, without the
        local ``_certified`` marker."""
        with self._lock:
            return [
                {k: v for k, v in wire.items() if k != "_certified"}
                for wire in self.fraud_proofs.get(height, {}).values()
            ]

    # --- mempool admission ---

    def broadcast_tx(self, raw: bytes):
        """CheckTx, then the mempool. An admitted PFB's blobs are staged in
        the App's blob arena, when it has one, so the proposal assembles the
        square on the card without uploading them again (on the attached
        dispatcher's thread, when there is one); a device that is
        unavailable leaves them to the upload path."""
        app = self._need_app()
        with self._lock:
            res = app.check_tx(raw)
            if res.code == 0:
                self.mempool.add(raw, res.priority, app.height)
        if res.code == 0 and app.blob_pool is not None:
            from celestia_tpu_torch import blob as blob_pkg

            btx, is_blob = blob_pkg.unmarshal_blob_tx(raw)
            if is_blob:
                blob_bytes = [b.data for b in btx.blobs]
                try:
                    # the uploads are device work: with a dispatcher attached
                    # they run on its thread, CheckTx stays on this one
                    if self.dispatcher is not None:
                        self.dispatcher.run_device(lambda: app.blob_pool.put_many(blob_bytes))
                    else:
                        app.blob_pool.put_many(blob_bytes)
                except faults.DeviceUnavailable as e:
                    log.info("blob staging failed", error=str(e))
        return res

    # --- block production (the proposer+validator round) ---

    def produce_block(self, block_time: float | None = None) -> Block:
        app = self._need_app()
        with self._lock:
            block_time = block_time if block_time is not None else time.time()
            proposal = app.prepare_proposal(self.mempool.reap())
            return self._apply_block_locked(proposal, block_time, own=True)

    def apply_external_block(self, txs: list[bytes], square_size: int,
                             data_hash: bytes, block_time: float,
                             expected_height: int | None = None,
                             evidence: list | None = None) -> Block:
        """Apply a block decided elsewhere: full ProcessProposal validation,
        then the normal deliver/commit pipeline. ``expected_height`` binds
        the block to the height its commit certificate covers, under the
        node lock, so two concurrent deliveries can never stack."""
        from celestia_tpu_torch.app.app import ProposalBlockData

        app = self._need_app()
        with self._lock:
            if expected_height is not None and app.height + 1 != expected_height:
                raise ValueError(
                    f"block certified for height {expected_height}, node "
                    f"is at {app.height}"
                )
            proposal = ProposalBlockData(txs=list(txs), square_size=square_size,
                                         hash=data_hash)
            return self._apply_block_locked(proposal, block_time, own=False,
                                            evidence=evidence)

    def _apply_block_locked(self, proposal, block_time: float,
                            own: bool, evidence: list | None = None) -> Block:
        with tracing.span("node.apply_block", height=self.app.height + 1,
                          txs=len(proposal.txs), square_size=proposal.square_size):
            return self._apply_block_traced(proposal, block_time, own, evidence)

    def _apply_block_traced(self, proposal, block_time: float,
                            own: bool, evidence: list | None = None) -> Block:
        app = self.app
        t0 = time.perf_counter()
        if not app.process_proposal(proposal):
            if own:
                log.error("own proposal rejected", height=app.height + 1)
                raise RuntimeError("node produced a proposal it cannot accept")
            raise ValueError(
                f"proposal for height {app.height + 1} fails ProcessProposal")

        # the square was built and validated under the PRE-commit version
        # (commit may adopt a pending upgrade): record that one
        build_version = app.app_version
        app.begin_block(block_time, evidence=evidence)
        results = [app.deliver_tx(t) for t in proposal.txs]
        app.end_block()
        app_hash = app.commit()
        log.info(
            "committed block",
            height=app.height,
            txs=len(proposal.txs),
            failed_txs=sum(1 for r in results if r.code != 0),
            square_size=proposal.square_size,
            data_hash=proposal.hash,
            app_hash=app_hash,
            elapsed_ms=round((time.perf_counter() - t0) * 1e3, 3),
        )
        block = Block(
            height=app.height,
            time=block_time,
            txs=proposal.txs,
            square_size=proposal.square_size,
            data_hash=proposal.hash,
            app_hash=app_hash,
            tx_results=results,
            evidence=list(evidence or []),
            version=build_version,
        )
        # the bookkeeping comes before the retention: an error that
        # propagates from the retention leaves the block store, the tx index
        # and the mempool consistent with the committed App
        self._store_block(block)
        for i, raw in enumerate(proposal.txs):
            key = tx_hash(raw)
            self.mempool.remove(key)
            self.tx_index[key] = (block.height, i)
        self.mempool.evict_expired(app.height)
        # (no retention across an upgrade boundary: extend_block runs at the
        # POST-commit version, the square was built at the pre-commit one;
        # block_eds's versioned rebuild serves the height)
        if self.extend_blocks and build_version == app.app_version:
            self._retain(block.height, proposal.txs)
        return block

    def _retain(self, height: int, txs: list[bytes]) -> None:
        """ExtendBlock retention: the committed square's EDS (device-resident
        on the gpu backend) into the serving cache, then to the store. A
        RETENTION_FAULTS failure is logged and counted, and the height is
        left to the host rebuild; any other exception propagates."""
        try:
            with tracing.span("node.extend_retention", height=height):
                eds = self.app.extend_block(txs)
                self._eds_cache.put(height, eds)
            with tracing.span("node.persist", height=height):
                self._persist_block_eds(height, eds)
        except RETENTION_FAULTS as e:
            log.info("eds retention failed", height=height, error=str(e))
            metrics.incr_counter("node_retention_failures_total", reason=type(e).__name__)

    def _store_block(self, block: Block) -> None:
        self.blocks[block.height] = block
        if self.home:
            path = self.home / "blocks" / f"{block.height}.json"
            path.write_text(json.dumps(block.to_json()))

    # --- queries ---

    def status(self) -> dict:
        """Same shape as the RPC /status route (the Signer's transport)."""
        app = self._need_app()
        return {
            "chain_id": app.chain_id,
            "height": self.latest_height(),
            "app_version": app.app_version,
            "mempool_size": len(self.mempool),
        }

    def account(self, address: str) -> dict | None:
        """Same shape as the RPC /account route."""
        app = self._need_app()
        acc = app.accounts.get_account(address)
        if acc is None:
            return None
        return {
            "address": acc.address,
            "account_number": acc.account_number,
            "sequence": acc.sequence,
            "balance": app.bank.get_balance(acc.address),
        }

    def get_block(self, height: int) -> Block | None:
        return self.blocks.get(height)

    def get_tx(self, key: bytes):
        """Returns (block, tx_index) or None."""
        loc = self.tx_index.get(key)
        if loc is None:
            return None
        return self.blocks[loc[0]], loc[1]

    def latest_height(self) -> int:
        return self._need_app().height

    def block_eds(self, height: int):
        """The (2k, 2k, 512) extended square of a block: a published
        square first, then the serving cache (an ``ExtendedDataSquare``,
        a ``PagedEds`` or a host array), then the store, whose height is
        adopted page by page with every page on disk (the restart path),
        then a host rebuild from the node's block. None for a height the
        node has no block of, when no tier holds it."""
        published = getattr(self.app, "published_eds", None)
        if published and height in published:
            return published[height]
        cached = self._eds_cache.get(height)
        if cached is not None:
            return cached
        if (self.store is not None and height in self.store
                and height not in self._store_refused
                and hasattr(self._eds_cache, "load_from_store")):
            try:
                return self._eds_cache.load_from_store(height)
            except (KeyError, OSError) as e:
                log.info("store load failed; reconstructing", height=height,
                         error=str(e))
        block = self.blocks.get(height)
        if block is None:
            return None
        # a pure host rebuild (NOT app.extend_block, and nothing on the
        # device): it runs on serving threads, so it must not touch the
        # App's backend. The block's own build version governs the layout.
        from celestia_tpu_torch import appconsts
        from celestia_tpu_torch import square as square_pkg
        from celestia_tpu_torch.shares import to_bytes

        v = block.version if block.version is not None else self.app.app_version
        sq = square_pkg.construct(block.txs, v, appconsts.square_size_upper_bound(v))
        k = square_pkg.square_size(len(sq))
        eds = da.extend_host(np.frombuffer(b"".join(to_bytes(sq)), np.uint8).reshape(
            k, k, appconsts.SHARE_SIZE))
        self._eds_cache.put(height, eds)
        return eds

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
        the height is invalidated and the batch answered again. A page
        record whose store CRC fails also refuses the height's store copy,
        so the height then answers None."""
        try:
            return self._sample_batch(height, coords)
        except integrity.IntegrityError as err:
            if not hasattr(self._eds_cache, "invalidate"):
                raise
            self._heal(height, err)
            return self._sample_batch(height, coords)

    def _heal(self, height: int, err: integrity.IntegrityError) -> None:
        """Drop a height whose page failed its checksum: the cache entry and
        the provers seeded from the same square. A ``store.read`` failure
        means the store's copy is damaged: it is refused until the height
        is persisted again."""
        log.info("eds page corrupt; invalidating height", height=height,
                 site=getattr(err, "site", None))
        if getattr(err, "site", None) == "store.read":
            self._store_refused.add(height)
        self._eds_cache.invalidate(height)
        self._prover_cache.pop(height, None)

    def sample_batch_ragged(self, payloads) -> list:
        """Answer a micro-batch of DAS samples ACROSS heights, each payload
        (height, row, col). Heights in the paged cache contribute their
        distinct rows to one ragged page-table gather, so the group costs
        one kernel launch per page geometry instead of a read per height.
        Every document is byte-identical to the per-height
        ``sample_batch`` path, sentinels included.

        The heal is per height: a poisoned fault-in invalidates only the
        height it names (``err.height``) and the group is answered again; a
        second corruption of a healed height raises. A height whose store
        record failed its CRC answers None."""
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
                    self._heal(h, err)
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
        the tree kernel with the row levels) and keeps the levels; a height
        the store holds (a PagedEds has no single device buffer) reads its
        persisted levels instead, with no kernel and no hashing. Each
        referenced row then gets its prover through
        ``NmtRowProver.from_node_levels``. Other squares, and a height whose
        stored levels are absent or unreadable, get a dict that
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
            elif self.store is not None and height in self.store:
                try:
                    levels = self.store.read_levels(height)
                except (integrity.IntegrityError, KeyError, OSError) as e:
                    log.info("stored row levels unreadable; host provers",
                             height=height, error=str(e))
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
        row and column NMT roots), memoized per height. A height the store
        holds answers its stored DAH, byte for byte what the node served
        before a restart, with no square read. Otherwise a paged square is
        materialized on the host once and its roots computed on the node's
        device (``extend.eds_roots_device``)."""
        dah = self._dah_cache.get(height)
        if dah is not None:
            return dah
        if self.store is not None and height in self.store:
            try:
                dah = da.DataAvailabilityHeader.from_json(self.store.read_dah(height))
                self._dah_cache[height] = dah
                return dah
            except (integrity.IntegrityError, KeyError, OSError, ValueError) as e:
                log.info("stored DAH unreadable; recomputing", height=height, error=str(e))
        # the roots read the whole square: the borrow keeps it pinned
        with self._borrow_eds(height) as eds:
            if eds is None:
                return None
            if not hasattr(eds, "original_width"):
                eds = da.ExtendedDataSquare(eds, eds.shape[0] // 2, self.device)
            dah = da.new_data_availability_header(eds)
        self._dah_cache[height] = dah
        return dah

    def _persist_block_eds(self, height: int, eds) -> None:
        """Durable retention of a block's square: its pages, its served DAH
        and, for a square with a device buffer, its row levels from one
        ``extend.eds_row_levels_device`` call, written to the BlockStore in
        the cache's page geometry, so a restart serves the height from disk
        with the same DAH bytes and provers. The device square is fetched
        once, at transfer site ``store.persist``. A failure of the device
        levels raises; a disk failure (or the read-only skip) is logged and
        leaves the height to the cache tiers. The persist records
        ``levels``, ``d2h``, ``crc`` and ``write`` stages in the active
        stage sink."""
        if self.store is None:
            return
        dah = self._dah_cache.get(height)
        if dah is None:
            # the roots a device square carries: no square read, no kernel
            square = (eds if hasattr(eds, "original_width")
                      else da.ExtendedDataSquare(eds, eds.shape[0] // 2, self.device))
            dah = self._dah_cache[height] = da.new_data_availability_header(square)
        levels = None
        arr = getattr(eds, "device_data", None)
        if arr is not None:
            with tracing.stage("levels"):
                levels = extend.eds_row_levels_device(arr, self.device)
            data = transfers.device_get_chunked(arr, site="store.persist")
        else:
            data = getattr(eds, "data", eds)
        width = int(getattr(eds, "original_width", data.shape[0] // 2))
        self._store_put(height, data, width, dah, levels)

    def _store_put(self, height: int, data, width: int, dah, levels) -> None:
        """Write one height's host square, DAH and levels to the store in
        the cache's page geometry; a disk failure (or the read-only skip)
        is logged and leaves the height to the cache tiers."""
        rpp = getattr(self._eds_cache, "rows_per_page", None) or 8
        try:
            entry = self.store.put_eds(height, data, width, dah_doc=dah.to_json(),
                                       levels=levels, rows_per_page=rpp)
        except (OSError, faults.FaultError) as e:
            log.info("eds persistence failed", height=height, error=str(e))
            return
        if entry is not None:
            self._store_refused.discard(height)

    # --- the block pipeline (node/pipeline.py) ---

    def extend_pipeline(self, k: int, depth: int = 3):
        """A 3-deep H2D/compute/D2H block pipeline bound to this node, on its
        device: feed consecutive (height, shares) squares (block replay,
        proposal bursts, a catching-up stream), and each retired block lands
        where retention puts it (the serving cache, the prover memo seeded
        from the device's level stack, the DAH memo, the store), with the
        three legs of consecutive blocks overlapped. Its legs run on the
        attached dispatcher's thread, when there is one."""
        from celestia_tpu_torch.node.pipeline import BlockPipeline

        def adopt(block):
            with self._lock:
                self._adopt_pipelined_block(block)

        return BlockPipeline(k, dispatcher=self.dispatcher, depth=depth, on_block=adopt,
                             device=self.device)

    def _adopt_pipelined_block(self, block) -> None:
        """Install one retired ``PipelinedBlock`` into the serving state from
        its fetched outputs, with no second device pass: the DAH memo, the
        host square in the cache, the provers' levels and the store record.
        A RETENTION_FAULTS failure of the cache is logged and counted, as
        ``_retain`` counts it. Called under ``_lock``."""
        dah = da.DataAvailabilityHeader([r.tobytes() for r in block.row_roots],
                                        [c.tobytes() for c in block.col_roots])
        self._dah_cache[block.height] = dah
        try:
            self._eds_cache.put(block.height, block.eds)
        except RETENTION_FAULTS as e:
            log.info("pipelined eds retention failed", height=block.height, error=str(e))
            metrics.incr_counter("node_retention_failures_total", reason=type(e).__name__)
        while len(self._prover_cache) >= self._PROVER_CACHE_HEIGHTS:
            self._prover_cache.pop(next(iter(self._prover_cache)))
        self._prover_cache[block.height] = (block.levels, {})
        if self.store is not None:
            self._store_put(block.height, block.eds, block.eds.shape[0] // 2, dah, block.levels)

    def ibc_light_client_header(self):
        """Unsigned light-client header material for this chain's latest
        committed state, read as ONE snapshot under the node lock (a racing
        commit must never pair height H with H+1's app hash)."""
        from celestia_tpu_torch.node.consensus import consensus_valset
        from celestia_tpu_torch.x.lightclient import Header, ValidatorInfo

        app = self._need_app()
        with self._lock:
            height = app.height
            block = self.get_block(height)
            return Header(
                chain_id=app.chain_id,
                height=height,
                time=block.time if block else 0.0,
                app_hash=app.store.app_hashes[app.store.version],
                validators=[ValidatorInfo(v.pubkey, v.power)
                            for v in consensus_valset(app.staking)],
            )

    # --- state sync (serve + bootstrap) ---

    def snapshot_payload(self) -> dict:
        """The state-sync snapshot a peer can bootstrap from: committed
        state and the metadata needed to verify and resume."""
        app = self._need_app()
        with self._lock:
            # under the node lock no block commits mid-assembly, so the
            # advertised app_hash and the state dump are one snapshot
            return {
                **self._meta(),
                "app_hash": app.store.app_hashes.get(app.store.version, b"").hex(),
                "state": app.store.snapshot().hex(),
            }

    def _meta(self) -> dict:
        return {
            "height": self.app.height,
            "chain_id": self.app.chain_id,
            "app_version": self.app.app_version,
            "block_time": self.app.block_time,
        }

    @staticmethod
    def _restore_app(meta: dict, state_bytes: bytes, **app_kwargs):
        """Shared restore path for disk resume and state sync: an App (its
        ``device`` among ``app_kwargs``, None meaning CUDA), its restored
        store with every keeper rebound, and the resume position."""
        from celestia_tpu_torch.app.app import App
        from celestia_tpu_torch.state import StateStore

        app = App(chain_id=meta["chain_id"], app_version=meta["app_version"], **app_kwargs)
        app.rebind_store(StateStore.restore(state_bytes))
        app.height = meta["height"]
        app.block_time = meta["block_time"]
        return app

    @classmethod
    def _verified_restore(cls, payload: dict, trusted_app_hash: bytes | str | None,
                          **app_kwargs):
        """Restore an App from a snapshot payload and verify its recomputed
        app hash, the one verification point of both state-sync spellings.
        ``trusted_app_hash`` (from a source already trusted) authenticates;
        without it the payload's own app_hash is checked, which only detects
        transport corruption."""
        app = cls._restore_app(payload, bytes.fromhex(payload["state"]), **app_kwargs)
        computed = app.store.app_hashes[app.store.version]
        expected = trusted_app_hash if trusted_app_hash is not None else payload["app_hash"]
        if isinstance(expected, bytes):
            expected = expected.hex()
        if computed.hex() != expected:
            raise ValueError(
                "snapshot app hash mismatch: expected "
                f"{expected}, state restores to {computed.hex()}"
            )
        return app

    def restore_from_snapshot(self, payload: dict,
                              trusted_app_hash: bytes | str | None = None,
                              **app_kwargs) -> None:
        """In-place state sync: swap this node's App for one restored from a
        peer snapshot (same verification as state_sync_from). The new App
        runs on this node's device unless ``app_kwargs`` names it."""
        app_kwargs.setdefault("device", self.device)
        app = self._verified_restore(payload, trusted_app_hash, **app_kwargs)
        if not _same_device(app.device, self.device):
            raise ValueError(f"the restored App's device {app.device} is not the node's "
                             f"{self.device}")
        with self._lock:
            self.app = app
            if self.home:
                self.save_snapshot()
        log.info("state synced in place", height=app.height,
                 app_hash=app.store.app_hashes[app.store.version],
                 authenticated=trusted_app_hash is not None)

    @classmethod
    def state_sync_from(cls, payload: dict, home: str | None = None,
                        trusted_app_hash: bytes | str | None = None,
                        **app_kwargs) -> "Node":
        """Bootstrap a fresh node from a peer's snapshot payload (its App's
        ``device`` among ``app_kwargs``). Verification is
        ``_verified_restore``'s."""
        app = cls._verified_restore(payload, trusted_app_hash, **app_kwargs)
        log.info("state synced", height=app.height,
                 app_hash=app.store.app_hashes[app.store.version],
                 authenticated=trusted_app_hash is not None)
        return cls(app, home=home)

    # --- checkpoint / resume ---

    def save_snapshot(self) -> None:
        if not self.home:
            raise ValueError("node has no home directory")
        app = self._need_app()
        with self._lock:
            (self.home / "state.json").write_bytes(app.store.snapshot())
            (self.home / "meta.json").write_text(json.dumps(self._meta()))

    @classmethod
    def load(cls, home: str, **app_kwargs) -> "Node":
        """Resume a node from its home: the App restored from the snapshot
        (``app_kwargs``, ``device`` among them, reach it BEFORE the replay),
        then every stored block; the blocks newer than the snapshot are
        replayed, each checked against its stored app hash, and their data
        hashes are checked first, in one batched device call per square
        size on the gpu backend."""
        device_mod.resolve(app_kwargs.get("device"))  # refuse before reading the home
        home_path = pathlib.Path(home)
        meta = json.loads((home_path / "meta.json").read_text())
        app = cls._restore_app(meta, (home_path / "state.json").read_bytes(), **app_kwargs)
        node = cls(app, home=home)
        for path in sorted((home_path / "blocks").glob("*.json"), key=lambda p: int(p.stem)):
            block = Block.from_json(json.loads(path.read_text()))
            node.blocks[block.height] = block
            for i, raw in enumerate(block.txs):
                node.tx_index[tx_hash(raw)] = (block.height, i)
        # crash recovery: the block store can be AHEAD of the state snapshot,
        # so the newer blocks are replayed through the App, each commit
        # checked against the stored app hash
        pending = [node.blocks[h] for h in sorted(h for h in node.blocks if h > app.height)]
        da_verified = node._batch_verify_data_availability(app, pending)
        for block in pending:
            height = block.height
            app.begin_block(block.time, evidence=block.evidence)
            for raw in block.txs:
                app.deliver_tx(raw)
            app.end_block()
            app_hash = app.commit()
            if app_hash != block.app_hash:
                raise ValueError(
                    f"replayed block {height} commits app hash "
                    f"{app_hash.hex()}, stored block has "
                    f"{block.app_hash.hex()} — state corruption"
                )
            if height not in da_verified:
                # the fallback (e.g. an app-version change inside the replay
                # window): verify alone at the now-current version
                node._verify_block_data_hash(app, block)
            log.info("replayed block", height=height, app_hash=app_hash, da_verified=True)
        return node

    @staticmethod
    def _rebuild_square(app, block: Block):
        from celestia_tpu_torch import square as square_pkg
        from celestia_tpu_torch.appconsts import square_size_upper_bound

        return square_pkg.construct(
            block.txs, app.app_version, square_size_upper_bound(app.app_version))

    @staticmethod
    def _verify_block_data_hash(app, block: Block) -> None:
        square = Node._rebuild_square(app, block)
        dah = app._proposal_dah(square)
        if dah.hash() != block.data_hash:
            raise ValueError(
                f"replayed block {block.height} data hash mismatch — "
                "block store corruption"
            )

    @staticmethod
    def _batch_verify_data_availability(app, pending: list[Block]) -> set[int]:
        """Check the data roots of queued replay blocks, batched.

        Squares of one size on the gpu backend ride ONE
        ``extend.batched_roots_device`` call on the App's device. Returns
        the heights verified. The pre-pass rebuilds squares at the
        snapshot's app version, which can legitimately mismatch after an
        upgrade inside the window, so it never raises: a block it cannot
        verify is checked again by the replay's solo fallback at the
        then-current version, which decides."""
        from celestia_tpu_torch import square as square_pkg
        from celestia_tpu_torch.appconsts import SHARE_SIZE

        verified: set[int] = set()
        if not pending:
            return verified
        groups: dict[int, list] = {}  # k -> [(block, data_square), ...]
        for block in pending:
            try:
                sq = Node._rebuild_square(app, block)
            except Exception:  # noqa: BLE001 — the solo fallback rebuilds it and raises
                continue
            k = square_pkg.square_size(len(sq))
            if k != block.square_size:
                continue  # version drift: left for the solo fallback
            groups.setdefault(k, []).append((block, sq))

        for k, items in groups.items():
            backend = app.resolve_extend_backend(k)
            if backend == "gpu" and len(items) > 1:
                squares = [
                    np.frombuffer(b"".join(s.data for s in sq), dtype=np.uint8).reshape(
                        k, k, SHARE_SIZE)
                    for _b, sq in items
                ]
                # roots only: the verifier never needs the EDS bytes
                rows, cols = extend.batched_roots_device(squares, app.device)
                for i, (block, _sq) in enumerate(items):
                    dah = da.DataAvailabilityHeader([r.tobytes() for r in rows[i]],
                                                    [c.tobytes() for c in cols[i]])
                    if dah.hash() == block.data_hash:
                        verified.add(block.height)
                log.info("batched DA verification", k=k, blocks=len(items), backend=backend)
            else:
                for block, sq in items:
                    if app._proposal_dah(sq).hash() == block.data_hash:
                        verified.add(block.height)
        return verified
