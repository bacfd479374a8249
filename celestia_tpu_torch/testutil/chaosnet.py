"""Crypto-free in-process DA node for chaos/resilience tests (port of the
JAX package's testutil/chaosnet.py).

The full devnet (testutil.network) exercises consensus + the app state
machine, which drags in the signing stack. Chaos tests target the layer
BELOW that: the transport (RpcClient retry/breaker), the light-client
failover, and the DA query surface. ChaosNode serves real DA artifacts
— a deterministic chain of extended squares with genuine NMT roots and
inclusion proofs, byte-compatible with node/rpc.py's route shapes — from
nothing but the da/proof modules, so the whole harness runs in a
stripped environment with no crypto dependency.

Extra chaos controls a real node doesn't have:

    node.fail_next(n)       next n requests answer HTTP 500 (exercises
                            the client's real 5xx retry path, not just
                            injected faults)
    node.fraud_wires[h]     raw wires served from /fraud/befp/<h>
                            (junk by default tests watchtower hygiene)
    node.balances[(a, d)]   balances served from /balance/<a>/<d>

Where the port differs: the chain's squares are extended on the host (the
native runtime when it builds, else the plain path on the CPU), so a
non-paged node touches no device. Paged mode
(``RpcChaosNode(paged_budget_bytes=...)``) builds its ``PagedEdsCache`` on
``device`` (None means CUDA) and raises on a host without a GPU unless the
caller passes ``device="cpu"``; there is no stripped fallback to host
squares. The stub app speaks the port's ``gpu`` names (``GPU_STRIKE_LIMIT``,
``_gpu_strikes``, ``_gpu_disabled``, backend ``"gpu"``).
"""

from __future__ import annotations

import http.server
import json
import threading
import time

import numpy as np
import torch

from celestia_tpu_torch import da, faults, native
from celestia_tpu_torch import device as device_mod


def chain_array(k: int, height: int, seed: int = 7) -> np.ndarray:
    """One height's k*k shares as a (k, k, 512) uint8 array: the namespace
    of 7s, then byte j of share i is (seed*131 + height*17 + i*7 + j) mod 256."""
    i = np.arange(k * k, dtype=np.int64)[:, None]
    j = np.arange(da.SHARE_SIZE - da.NAMESPACE_SIZE, dtype=np.int64)[None, :]
    body = (seed * 131 + height * 17 + i * 7 + j) % 256
    out = np.empty((k * k, da.SHARE_SIZE), dtype=np.uint8)
    out[:, :da.NAMESPACE_SIZE] = 7
    out[:, da.NAMESPACE_SIZE:] = body
    return out.reshape(k, k, da.SHARE_SIZE)


def chain_shares(k: int, height: int, seed: int = 7) -> list[bytes]:
    """k*k deterministic 512-byte shares for one height (seed-stable)."""
    return [row.tobytes() for row in chain_array(k, height, seed).reshape(k * k, -1)]


def extend_chain(k: int, height: int, seed: int = 7):
    """(eds, dah) of one height, extended on the host: the native runtime
    when it builds, else the plain path on the CPU. Both are byte-identical
    to the device entries."""
    q0 = chain_array(k, height, seed)
    if native.available():
        eds_arr, rows, cols, dah_hash = native.extend_and_root_native(q0)
        roots = tuple(np.frombuffer(b"".join(r), np.uint8).reshape(len(r), -1)
                      for r in (rows, cols))
        eds = da.ExtendedDataSquare(eds_arr, k, "cpu", roots=roots)
        return eds, da.DataAvailabilityHeader(rows, cols, _hash=dah_hash)
    eds = da.extend_shares(q0, device="cpu")
    return eds, da.new_data_availability_header(eds)


class ChaosNode:
    """A block store + query surface; no mempool, no consensus."""

    def __init__(self, heights: int = 2, k: int = 2, seed: int = 7,
                 chain_id: str = "chaos-net"):
        self.chain_id = chain_id
        self.blocks: dict[int, tuple] = {}  # height -> (eds, dah)
        for h in range(1, heights + 1):
            self.blocks[h] = extend_chain(k, h, seed)
        self.balances: dict[tuple[str, str], int] = {}
        self.fraud_wires: dict[int, list] = {}
        self.broadcasts: list[str] = []
        self._fail_next = 0
        self._lock = threading.Lock()

    def latest_height(self) -> int:
        return max(self.blocks, default=0)

    def dah(self, height: int):
        entry = self.blocks.get(height)
        return entry[1] if entry else None

    def fail_next(self, n: int) -> None:
        """Make the server answer HTTP 500 for the next n requests."""
        with self._lock:
            self._fail_next = n

    def _consume_failure(self) -> bool:
        with self._lock:
            if self._fail_next > 0:
                self._fail_next -= 1
                return True
            return False


class _StubApp:
    """Just enough App surface for node/rpc.py's status/readiness
    routes: the degradation-state fields specs/slo.md reads, with no
    crypto or state-machine dependency."""

    GPU_STRIKE_LIMIT = 3

    def __init__(self, chain_id: str):
        self.chain_id = chain_id
        self.app_version = 3
        self.extend_backend = "numpy"
        self._active_backend: str | None = None
        self._gpu_strikes = 0
        self._gpu_disabled = False
        self.crossover = None
        self.blob_pool = None
        self.arena_stats = {"assembled": 0, "fallback": 0}
        # SDC defense surface (ADR-015): /status + /readyz quarantine
        # fields; sdc_smoke flips these to drill the serving-fit checks
        self.audit_level = "off"
        self.sdc_quarantined = False
        self.sdc_events = 0
        self.last_sdc: dict | None = None

    def resolve_extend_backend(self, k: int) -> str:
        if self._gpu_disabled and self.extend_backend == "gpu":
            return "numpy"
        self._active_backend = self.extend_backend
        return self.extend_backend

    def gov_square_size_upper_bound(self) -> int:
        return 128


class RpcChaosNode(ChaosNode):
    """ChaosNode dressed as a node/rpc.py Node: the REAL RPC handler
    (node/rpc.py, not this module's stripped one) serves it, so the
    observability routes — /status, /healthz, /readyz, /debug/slo,
    /dah, /sample — are exercised end-to-end without the signing stack.
    This is the in-process probing harness the synthetic DAS prober
    tests and `make obs-smoke` boot in crypto-free environments."""

    def __init__(self, heights: int = 2, k: int = 2, seed: int = 7,
                 chain_id: str = "chaos-net",
                 paged_budget_bytes: int | None = None,
                 rows_per_page: int = 8,
                 store_dir=None,
                 store_durable: bool = True,
                 device=None):
        # durable store first (ADR-021): a restart is modelled as a
        # NEW instance with heights=0 over the same store_dir — the
        # re-index adopts every persisted height, and the serve path
        # answers from disk pages + the stored DAH bytes
        self.store = None
        self._rows_per_page = rows_per_page
        if store_dir is not None:
            from celestia_tpu_torch.store import BlockStore

            self.store = BlockStore(store_dir, durable=store_durable)
            self.store.reindex()
        # paged mode next: grow() in super().__init__ feeds the cache. Its
        # pages live on ``device`` (None means CUDA: raises without a GPU);
        # a non-paged node serves host squares and touches no device
        self._eds_cache = None
        self.device = torch.device("cpu")
        if paged_budget_bytes is not None:
            from celestia_tpu_torch.node.eds_cache import PagedEdsCache

            self.device = device_mod.resolve(device)
            self._eds_cache = PagedEdsCache(
                rows_per_page=rows_per_page,
                device_byte_budget=paged_budget_bytes,
                max_heights=1 << 30,  # heights bound by the harness
                store=self.store,
                device=self.device,
            )
        super().__init__(heights=heights, k=k, seed=seed,
                         chain_id=chain_id)
        if self._eds_cache is not None:
            for h, (eds, _dah) in self.blocks.items():
                self._put_paged(h, eds)
        self.k = k
        self.seed = seed
        self.app = _StubApp(chain_id)
        self.mempool: list = []
        self.started_at = time.monotonic()
        self.slo = None
        self.prober = None
        # persist the initial blocks (idempotent: a re-put over the
        # same deterministic chain rewrites identical records)
        for h in sorted(self.blocks):
            eds, dah = self.blocks[h]
            self._persist(h, eds, dah)

    def _put_paged(self, height: int, eds) -> None:
        """Copy a host square onto the cache's device and page it."""
        self._eds_cache.put(height, da.ExtendedDataSquare.from_device(
            torch.from_numpy(eds.data).to(self.device), eds.original_width))

    def _persist(self, height: int, eds, dah) -> None:
        """Best-effort durable write — mirrors Node._persist_block_eds
        (crypto-free: no row-tree levels; provers rebuild host-side)."""
        if self.store is None:
            return
        try:
            self.store.put_eds(height, eds.data, eds.original_width,
                               dah_doc=dah.to_json(),
                               rows_per_page=self._rows_per_page)
        except (OSError, faults.FaultError):
            pass  # a disk fault leaves the height to memory, as a node's

    def grow(self) -> int:
        """Append the next height (the produce_block analogue): what
        flips /readyz's has_blocks check across 'startup'. In paged mode
        the square is device-put and inserted into the PagedEdsCache, so
        serving reads exercise real page residency/demote/fault-in."""
        h = self.latest_height() + 1
        self.blocks[h] = extend_chain(self.k, h, self.seed)
        if getattr(self, "_eds_cache", None) is not None:
            self._put_paged(h, self.blocks[h][0])
        if getattr(self, "store", None) is not None:
            self._persist(h, *self.blocks[h])
        return h

    # -- the Node query surface node/rpc.py's served routes touch ------ #

    def _eds_for(self, height: int):
        """The serving read source: the paged-cache entry when paged
        mode is on (falling back to the host square on a miss), else
        the host ExtendedDataSquare; store-persisted heights a fresh
        instance never built (the restart path) are adopted from DISK
        — page-granular through the cache when paged, else assembled
        from CRC-verified page reads."""
        if self._eds_cache is not None:
            paged = self._eds_cache.get(height)
            if paged is not None:
                return paged
            if (self.store is not None and height in self.store
                    and hasattr(self._eds_cache, "load_from_store")):
                return self._eds_cache.load_from_store(height)
        entry = self.blocks.get(height)
        if entry is not None:
            return entry[0]
        if self.store is not None and height in self.store:
            e = self.store.entry(height)
            parts = [self.store.read_page(height, i)[0]
                     for i in range(e.page_count)]
            return da.ExtendedDataSquare(
                np.concatenate(parts, axis=0), e.k)
        return None

    def latest_height(self) -> int:
        top = max(self.blocks, default=0)
        if self.store is not None:
            stored = self.store.heights()
            if stored:
                top = max(top, stored[-1])
        return top

    def block_dah(self, height: int):
        dah = self.dah(height)
        if dah is not None:
            return dah
        if self.store is not None and height in self.store:
            # stored DAH: post-restart /dah bytes == pre-restart bytes
            return da.DataAvailabilityHeader.from_json(
                self.store.read_dah(height))
        return None

    def block_eds(self, height: int):
        return self._eds_for(height)

    def block_width(self, height: int) -> int | None:
        eds = self._eds_for(height)
        return eds.width if eds is not None else None

    def block_row(self, height: int, i: int):
        eds = self._eds_for(height)
        return eds.row(i) if eds is not None else None

    def sample_batch(self, height: int, coords) -> list:
        """The continuous-batching sample body (mirrors
        Node.sample_batch: one row fetch + one leaf-hash pass per
        distinct row, documents byte-identical to the unbatched
        route)."""
        from celestia_tpu_torch.proof import das_sample_docs

        coords = [(int(i), int(j)) for i, j in coords]
        eds = self._eds_for(height)
        if eds is None:
            return [None] * len(coords)
        w = eds.width
        out: list = ["range"] * len(coords)
        valid = [t for t, (i, j) in enumerate(coords)
                 if 0 <= i < w and 0 <= j < w]
        if not valid:
            return out
        rows_needed = sorted({coords[t][0] for t in valid})
        # rows go through self.block_row, NOT the eds directly: chaos
        # subclasses override block_row to serve tampered rows, and the
        # batched path must lie exactly like the unbatched one did
        rows = {i: self.block_row(height, i) for i in rows_needed}
        docs = das_sample_docs(rows, [coords[t] for t in valid], w // 2)
        for t, doc in zip(valid, docs):
            out[t] = doc
        return out

    def sample_batch_ragged(self, payloads) -> list:
        """The ragged cross-height sample body (mirrors
        Node.sample_batch_ragged for the widened ``("sample",)``
        dispatcher key): one exec answers the whole mixed-height group.
        Paged heights resolve every row the group needs through ONE
        `PagedEdsCache.pages_batch` gather — each page pinned and
        faulted at most once per group, one device dispatch per page
        geometry — instead of per-row reads that thrash a tight budget
        when the group spans heights. Chaos subclasses that tamper via
        `block_row` (and non-paged heights) keep the per-height
        `sample_batch` delegation so the lie stays identical. Documents
        are byte-identical to per-height calls either way."""
        from celestia_tpu_torch.ops import ragged
        from celestia_tpu_torch.proof import das_sample_docs

        jobs = [(int(h), int(i), int(j)) for h, i, j in payloads]
        by_height: dict[int, list[int]] = {}
        for t, (h, _i, _j) in enumerate(jobs):
            by_height.setdefault(h, []).append(t)
        out: list = [None] * len(jobs)
        cache = getattr(self, "_eds_cache", None)
        gather_ok = (
            cache is not None and hasattr(cache, "pages_batch")
            and type(self).block_row is RpcChaosNode.block_row
        )
        with ragged.ragged_span(len(by_height), len(jobs)):
            plan = []  # (h, w, valid ts, rows_needed)
            wants: list = []
            want_slot: dict[tuple[int, int], int] = {}
            for h, ts in by_height.items():
                eds = self._eds_for(h) if gather_ok else None
                paged = (eds if getattr(eds, "_cache", None) is cache
                         else None)
                if paged is None:
                    docs = self.sample_batch(
                        h, [(jobs[t][1], jobs[t][2]) for t in ts])
                    for t, doc in zip(ts, docs):
                        out[t] = doc
                    continue
                w = paged.width
                for t in ts:
                    out[t] = "range"
                valid = [t for t in ts
                         if 0 <= jobs[t][1] < w and 0 <= jobs[t][2] < w]
                rows_needed = sorted({jobs[t][1] for t in valid})
                for i in rows_needed:
                    want_slot[(h, i)] = len(wants)
                    wants.append((paged, i))
                if valid:
                    plan.append((h, w, valid, rows_needed))
            gathered = cache.pages_batch(wants) if wants else []
            for h, w, valid, rows_needed in plan:
                rows = {i: gathered[want_slot[(h, i)]]
                        for i in rows_needed}
                docs = das_sample_docs(
                    rows, [(jobs[t][1], jobs[t][2]) for t in valid],
                    w // 2)
                for t, doc in zip(valid, docs):
                    out[t] = doc
        return out

    def get_block(self, height: int):
        return None  # no block bodies: body routes answer 404

    def get_tx(self, key: bytes):
        return None

    def fraud_proofs_at(self, height: int) -> list:
        return list(self.fraud_wires.get(height, []))

    home = None


def _handler_for(node: ChaosNode):
    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # quiet
            pass

        def _reply(self, payload: dict, status: int = 200) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if node._consume_failure():
                self._reply({"error": "injected server failure"}, 500)
                return
            parts = [p for p in self.path.split("/") if p]
            try:
                if parts == ["status"]:
                    self._reply(
                        {
                            "chain_id": node.chain_id,
                            "height": node.latest_height(),
                        }
                    )
                elif len(parts) == 2 and parts[0] == "header":
                    entry = node.blocks.get(int(parts[1]))
                    if entry is None:
                        self._reply({"error": "block not found"}, 404)
                    else:
                        eds, dah = entry
                        self._reply(
                            {
                                "height": int(parts[1]),
                                "time": float(parts[1]),
                                "square_size": eds.original_width,
                                "data_hash": dah.hash().hex(),
                                "app_hash": bytes(32).hex(),
                            }
                        )
                elif len(parts) == 2 and parts[0] == "dah":
                    entry = node.blocks.get(int(parts[1]))
                    if entry is None:
                        self._reply({"error": "block not found"}, 404)
                    else:
                        self._reply(entry[1].to_json())
                elif len(parts) == 4 and parts[0] == "sample":
                    h, i, j = int(parts[1]), int(parts[2]), int(parts[3])
                    entry = node.blocks.get(h)
                    if entry is None:
                        self._reply({"error": "block not found"}, 404)
                        return
                    eds = entry[0]
                    w = eds.width
                    if not (0 <= i < w and 0 <= j < w):
                        self._reply({"error": "coordinate out of range"}, 400)
                        return
                    from celestia_tpu_torch.proof import nmt_prove_range

                    row_cells = eds.row(i)
                    leaves = da.erasured_axis_leaves(
                        row_cells, i, eds.original_width
                    )
                    proof = nmt_prove_range(leaves, j, j + 1)
                    self._reply(
                        {
                            "share": row_cells[j].hex(),
                            "proof": {
                                "start": proof.start,
                                "end": proof.end,
                                "nodes": [n.hex() for n in proof.nodes],
                                "tree_size": proof.tree_size,
                            },
                        }
                    )
                elif len(parts) == 3 and parts[0] == "fraud" \
                        and parts[1] == "befp":
                    h = int(parts[2])
                    wires = node.fraud_wires.get(h)
                    if not wires:
                        self._reply({"error": "no fraud proof at height"}, 404)
                    else:
                        self._reply({"height": h, "proofs": wires})
                elif len(parts) == 3 and parts[0] == "balance":
                    bal = node.balances.get((parts[1], parts[2]))
                    if bal is None:
                        self._reply({"error": "unknown account"}, 404)
                    else:
                        self._reply({"balance": bal})
                elif len(parts) == 2 and parts[0] == "account":
                    self._reply({"error": "account not found"}, 404)
                else:
                    self._reply({"error": "unknown route"}, 404)
            except Exception as e:  # noqa: BLE001
                self._reply({"error": str(e)}, 500)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if node._consume_failure():
                self._reply({"error": "injected server failure"}, 500)
                return
            parts = [p for p in self.path.split("/") if p]
            if parts == ["broadcast_tx"]:
                node.broadcasts.append(body.get("tx", ""))
                self._reply({"code": 0, "log": "", "priority": 0})
            else:
                self._reply({"error": "unknown route"}, 404)

    return Handler


class ChaosServer:
    """ThreadingHTTPServer over a ChaosNode; port 0 = ephemeral."""

    def __init__(self, node: ChaosNode, host: str = "127.0.0.1",
                 port: int = 0):
        self.node = node
        self.server = http.server.ThreadingHTTPServer(
            (host, port), _handler_for(node)
        )
        self.port = self.server.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread: threading.Thread | None = None

    def start(self) -> "ChaosServer":
        self._thread = threading.Thread(
            target=self.server.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
