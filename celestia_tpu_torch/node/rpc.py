"""HTTP JSON API for the node — the query/broadcast surface (port of the
JAX package's node/rpc.py).

The reference exposes gRPC + grpc-gateway REST + CometBFT RPC
(app/app.go:693-719). This serves the same capability set over a
dependency-free JSON/HTTP server (stdlib): tx broadcast, tx/block/status
queries, account + balance queries, and share/tx inclusion proofs.

Overload resilience (ADR-016, specs/serving.md): request threads only
parse/validate; the device-touching routes (/dah, /eds, /sample,
/proof/share, /proof/tx, /namespace_data, /produce_block) funnel their
work through ONE device-dispatcher thread behind a bounded admission
queue. Queue full → immediate `503 + Retry-After` (never unbounded
queueing); every
dispatched request carries a deadline (server default, capped by the
client's `X-Deadline-Ms` header) → `504` when it expires before
dispatch completes; `RpcServer.stop()` drains gracefully (stop
admitting, finish in-flight, then close). Health/readiness/metrics
routes stay on the request thread — they must keep answering while the
device queue is saturated, that is their whole job.

Every route answers the JAX server's document for the same node state. The
port's differences: ``/status`` says ``gpu_strikes`` and ``gpu_disabled``
(the port's App says ``gpu`` where JAX says ``tpu``), ``/debug/device`` is
the port's ledger document, and the proofs' squares are extended on the
node's device, on the dispatcher's thread: ``/proof/tx`` and
``/namespace_data``, which the JAX server answers on the request thread,
are shed and held to deadlines like ``/proof/share``. No route answers
device work from a host recompute: an error of the device path (a failed
prover included) reaches the client as the JAX server's error status, and
``start`` lets a failure to register the dispatcher as the device executor
propagate.
"""

from __future__ import annotations

import http.server
import json
import math
import threading
import time
from typing import TYPE_CHECKING

from celestia_tpu_torch import tracing
from celestia_tpu_torch.log import logger
from celestia_tpu_torch.node.dispatch import DeadlineExceeded, DeviceDispatcher, Shed
from celestia_tpu_torch.ops import transfers
from celestia_tpu_torch.telemetry import metrics

if TYPE_CHECKING:  # annotation-only
    from celestia_tpu_torch.node.node import Node

log = logger("rpc")


def _share_proof_json(proof) -> dict:
    return {
        "namespace": proof.namespace.bytes.hex(),
        "data": [s.hex() for s in proof.data],
        "share_proofs": [
            {
                "start": p.start,
                "end": p.end,
                "nodes": [n.hex() for n in p.nodes],
            }
            for p in proof.share_proofs
        ],
        "row_proof": {
            "start_row": proof.row_proof.start_row,
            "end_row": proof.row_proof.end_row,
            "row_roots": [r.hex() for r in proof.row_proof.row_roots],
            "proofs": [
                {
                    "total": m.total,
                    "index": m.index,
                    "leaf_hash": m.leaf_hash.hex(),
                    "aunts": [a.hex() for a in m.aunts],
                }
                for m in proof.row_proof.proofs
            ],
        },
    }


class _InflightTracker:
    """Counts handler threads currently inside a request (the
    `rpc_inflight_requests` gauge) and lets a graceful stop wait for
    them to finish before the dispatcher drains."""

    def __init__(self):
        self._cv = threading.Condition()
        self._count = 0

    def __enter__(self):
        with self._cv:
            self._count += 1
            metrics.set_gauge("rpc_inflight_requests", float(self._count))
        return self

    def __exit__(self, *exc):
        with self._cv:
            self._count -= 1
            metrics.set_gauge("rpc_inflight_requests", float(self._count))
            self._cv.notify_all()
        return False

    @property
    def count(self) -> int:
        with self._cv:
            return self._count

    def wait_idle(self, timeout: float) -> bool:
        end = time.monotonic() + timeout
        with self._cv:
            while self._count > 0 and time.monotonic() < end:
                self._cv.wait(0.05)
            return self._count == 0


def _server_timing(stages: dict) -> str:
    """Server-Timing-style header value: ``stage;dur=ms`` entries."""
    return ", ".join(
        f"{name};dur={seconds * 1000.0:.3f}"
        for name, seconds in stages.items()
    )


def tx_proof_doc(node: Node, block, idx: int) -> dict:
    """The ``/proof/tx`` document of tx ``idx`` of ``block``: its square
    extended on the node's device (the route runs it on the dispatcher's
    thread)."""
    from celestia_tpu_torch.proof import new_tx_inclusion_proof

    proof = new_tx_inclusion_proof(block.txs, idx, node.app.app_version, device=node.device)
    proof.validate(block.data_hash)
    return _share_proof_json(proof)


def namespace_data_doc(node: Node, block, target) -> tuple[dict, int]:
    """The ``/namespace_data`` document and status of namespace ``target``
    in ``block``: the blobs of each share range with its inclusion proof,
    or, where the namespace is absent, an NMT absence proof for every row
    whose root range covers it. The squares are extended on the node's
    device (the route runs it on the dispatcher's thread)."""
    from celestia_tpu_torch import appconsts, da as da_mod, square as square_pkg
    from celestia_tpu_torch.proof import (
        merkle_proofs,
        new_share_inclusion_proof,
        nmt_prove_absence,
    )
    from celestia_tpu_torch.shares import to_bytes as to_raw
    from celestia_tpu_torch.shares.parse import parse_blobs
    from celestia_tpu_torch.shares.splitters import Range

    sq = square_pkg.construct(
        block.txs, node.app.app_version,
        appconsts.square_size_upper_bound(node.app.app_version),
    )
    ranges = []
    start = None
    for i, share in enumerate(sq):
        if share.namespace() == target and not share.is_padding():
            if start is None:
                start = i
        elif start is not None:
            ranges.append(Range(start, i))
            start = None
    if start is not None:
        ranges.append(Range(start, len(sq)))
    out = []
    for rng in ranges:
        proof = new_share_inclusion_proof(sq, target, rng, device=node.device)
        proof.validate(block.data_hash)
        blobs = parse_blobs(sq[rng.start : rng.end])
        out.append(
            {
                "start": rng.start,
                "end": rng.end,
                "blobs": [b.data.hex() for b in blobs],
                "proof": _share_proof_json(proof),
            }
        )
    reply = {"namespace": target.bytes.hex(), "ranges": out}
    if out:
        return reply, 200
    if (
        target.is_parity_shares()
        or target.is_tail_padding()
        or target.is_primary_reserved_padding()
    ):
        # padding/parity namespaces carry no user data by construction and
        # their leaves DO appear in rows, so "absence" is not a meaningful
        # query
        return {"error": "reserved padding/parity namespace holds no user data"}, 400
    # nmt absence proofs for every DAH row whose root range covers the
    # namespace; each row root is authenticated to the block's data root
    # with a merkle proof (same trust chain as inclusion). Rows not covering
    # prove absence by the ordered root ranges alone. Parity rows (i >= k)
    # have min == max == the parity namespace and never cover a user
    # namespace.
    eds = da_mod.extend_shares(to_raw(sq), node.device)
    k = eds.original_width
    nsb = target.bytes
    all_roots = eds.row_roots() + eds.col_roots()
    data_root, root_proofs = merkle_proofs(all_roots)
    assert data_root == block.data_hash
    absence = []
    for i in range(k):
        leaves = da_mod.erasured_axis_leaves(eds.row(i), i, k)
        root = all_roots[i]
        if nsb < root[: appconsts.NAMESPACE_SIZE] or \
                nsb > root[appconsts.NAMESPACE_SIZE: 2 * appconsts.NAMESPACE_SIZE]:
            continue
        proof = nmt_prove_absence(leaves, nsb)
        rp = root_proofs[i]
        absence.append(
            {
                "row": i,
                "row_root": root.hex(),
                "proof": proof.to_json(),
                "root_proof": {
                    "total": rp.total,
                    "index": rp.index,
                    "leaf_hash": rp.leaf_hash.hex(),
                    "aunts": [a.hex() for a in rp.aunts],
                },
            }
        )
    reply["absence"] = absence
    return reply, 200


def _handler_for(node: Node, dispatcher: DeviceDispatcher,
                 tracker: _InflightTracker):
    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # quiet
            pass

        def _reply(self, payload: dict, status: int = 200,
                   headers: dict | None = None) -> None:
            sp = tracing.current()  # the rpc.request span, when tracing
            if sp is not None:
                sp.set(status=status)
            sink = tracing.active_stage_sink()
            if sink is not None:
                t0 = time.perf_counter()
                body = json.dumps(payload).encode()
                sink.add("serialize", time.perf_counter() - t0)
            else:
                body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            # X-Trace-Id rides EVERY response — 503 sheds, 504
            # deadlines, and JSON 400/404/500 error bodies included —
            # so shed storms are correlatable from the client side
            trace_id = getattr(self, "_trace_id", None)
            if trace_id is not None:
                self.send_header(tracing.TRACE_ID_HEADER, trace_id)
            if sink is not None and sink.data:
                self.send_header("Server-Timing",
                                 _server_timing(sink.data))
                for stage, seconds in sink.data.items():
                    metrics.observe("rpc_stage_ms", seconds,
                                    exemplar=trace_id, stage=stage)
                if sp is not None:
                    sp.set(**{f"stage_{stage}_ms":
                              round(seconds * 1000.0, 3)
                              for stage, seconds in sink.data.items()})
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def _begin_trace(self, sp):
            """Bind the request span into the caller's trace (ADR-022):
            a valid inbound `X-Trace-Context` roots this span under the
            caller's wire span; otherwise a fresh trace id is minted
            when tracing is on. Malformed headers are counted
            (`trace_context_invalid_total`) and ignored — never a 500.
            Returns the per-request stage sink (None when tracing is
            off, keeping the disabled path allocation-free)."""
            raw = self.headers.get(tracing.TRACE_HEADER)
            ctx = tracing.extract(raw) if raw is not None else None
            if isinstance(sp, tracing.Span):
                if ctx is not None:
                    sp.trace_id = ctx.trace_id
                    sp.set(wire_parent=ctx.span_id)
                else:
                    sp.trace_id = tracing.mint_trace_id()
                self._trace_id = sp.trace_id
                return tracing.push_stage_sink()
            self._trace_id = ctx.trace_id if ctx is not None else None
            return None

        def _deadline_s(self) -> float:
            """Server default deadline, CAPPED by the client's
            `X-Deadline-Ms` (a client can only tighten, never extend —
            the server default is the overload backstop)."""
            limit = dispatcher.default_deadline_s
            raw = self.headers.get("X-Deadline-Ms")
            if raw:
                try:
                    limit = min(limit, max(int(raw), 1) / 1000.0)
                except ValueError:
                    pass  # unparseable header: keep the server default
            return limit

        def _dispatch(self, fn, label: str):
            """Run device-touching work on the dispatcher thread; the
            reply itself always happens back on THIS request thread
            (it owns the socket)."""
            return dispatcher.submit(fn, deadline_s=self._deadline_s(),
                                     label=label)

        def _dispatch_sample(self, h: int, i: int, j: int):
            """The /sample body, continuous-batched (ADR-017) and
            ragged across heights: EVERY concurrent /sample coalesces
            under the single ``("sample",)`` key — the dispatcher hands
            the whole mixed-height group to `node.sample_batch_ragged`,
            which answers it with one page-table gather per page
            geometry. Each waiter still carries its own deadline/abandon
            contract and gets its own document, byte-identical to the
            per-height path."""
            return dispatcher.submit(
                deadline_s=self._deadline_s(),
                label="sample",
                batch_key=("sample",),
                batch_exec=node.sample_batch_ragged,
                payload=(h, i, j),
            )

        def _shed_reply(self, e: Shed) -> None:
            self._reply(
                {"error": "overloaded", "reason": e.reason,
                 "retry_after_s": e.retry_after_s, "status": 503},
                503,
                headers={"Retry-After":
                         str(max(1, math.ceil(e.retry_after_s)))},
            )

        def _deadline_reply(self, e: DeadlineExceeded) -> None:
            self._reply({"error": "deadline exceeded", "detail": str(e),
                         "status": 504}, 504)

        def _not_found(self) -> None:
            """The one unknown-route body every miss returns (GET,
            gateway, and POST fallthroughs share it): consistent JSON,
            the path echoed so a client log line is self-explanatory."""
            self._reply(
                {"error": "unknown route",
                 "path": self.path.split("?", 1)[0], "status": 404},
                404,
            )

        def do_GET(self):
            with tracker, \
                    tracing.span("rpc.request", method="GET",
                                 path=self.path.split("?", 1)[0]) as sp:
                sink = self._begin_trace(sp)
                try:
                    self._route_get()
                finally:
                    if sink is not None:
                        tracing.pop_stage_sink()

        def _route_get(self):
            parts = [p for p in self.path.split("/") if p]
            try:
                if parts == ["metrics"]:
                    from celestia_tpu_torch.telemetry import (
                        metrics, refresh_process_gauges)

                    # host-resource gauges are pull-refreshed: nobody
                    # scraping = zero cycles spent reading procfs
                    refresh_process_gauges(metrics)
                    # same pull discipline for the device runtime
                    # ledger: owner audit + busy ratio on scrape
                    from celestia_tpu_torch import devledger

                    devledger.publish(metrics)
                    body = metrics.prometheus_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    trace_id = getattr(self, "_trace_id", None)
                    if trace_id is not None:
                        self.send_header(tracing.TRACE_ID_HEADER, trace_id)
                    self.end_headers()
                    self.wfile.write(body)
                elif parts == ["debug", "flight"]:
                    # the flight recorder: the last N finished spans
                    # (tracing ring buffer), the post-incident "what was
                    # the node doing just now" view next to /metrics
                    self._reply(
                        {
                            "enabled": tracing.enabled(),
                            "capacity": tracing.flight_capacity(),
                            "spans": tracing.flight(),
                        }
                    )
                elif parts == ["status"]:
                    eds_cache = getattr(node, "_eds_cache", None)
                    store = getattr(node, "store", None)
                    self._reply(
                        {
                            # paged EDS cache residency/flow (ADR-017):
                            # mirrors the eds_cache_* gauges/counters
                            "eds_cache": (
                                eds_cache.stats()
                                if hasattr(eds_cache, "stats") else None
                            ),
                            # durable block store (ADR-021): persisted
                            # height range + flow, mirrors store_*
                            "store": (
                                store.stats()
                                if hasattr(store, "stats") else None
                            ),
                            "chain_id": node.app.chain_id,
                            "height": node.latest_height(),
                            "app_version": node.app.app_version,
                            "mempool_size": len(node.mempool),
                            "extend_backend": node.app.extend_backend,
                            "extend_backend_live": node.app._active_backend,
                            "uptime_s": round(
                                time.monotonic() - node.started_at, 3
                            ),
                            "gpu_strikes": node.app._gpu_strikes,
                            "gpu_disabled": node.app._gpu_disabled,
                            # SDC defense (ADR-015): quarantine state +
                            # the live audit policy, operator-visible
                            "audit_level": getattr(
                                node.app, "audit_level", "off"
                            ),
                            "sdc_quarantined": bool(getattr(
                                node.app, "sdc_quarantined", False
                            )),
                            "sdc_events": int(getattr(
                                node.app, "sdc_events", 0
                            )),
                            "last_sdc": getattr(node.app, "last_sdc", None),
                        }
                    )
                elif parts == ["healthz"]:
                    # liveness: the process answers — nothing more. A
                    # degraded node is still ALIVE (restarting it would
                    # lose the flight recorder); fitness is /readyz.
                    self._reply({
                        "ok": True,
                        "uptime_s": round(
                            time.monotonic() - node.started_at, 3
                        ),
                    })
                elif parts == ["readyz"]:
                    # serving-fit (specs/slo.md): 503 tells the load
                    # balancer to route around this node; the body
                    # names exactly which check is unfit
                    from celestia_tpu_torch.slo import readiness

                    ready, checks = readiness(node)
                    self._reply({"ready": ready, "checks": checks},
                                200 if ready else 503)
                elif parts == ["debug", "slo"]:
                    # full judgment view: every objective's evaluation
                    # (multi-window burn rates included), the serving-
                    # fit checks, and the newest prober cycle
                    from celestia_tpu_torch.slo import engine_for, readiness

                    ready, checks = readiness(node)
                    prober = getattr(node, "prober", None)
                    self._reply({
                        "slo": engine_for(node).evaluate(),
                        "ready": ready,
                        "checks": checks,
                        "probe_last": prober.last if prober else None,
                    })
                elif parts == ["debug", "device"]:
                    # device runtime ledger (ADR-025): compile/retrace
                    # watchdog state, the per-owner HBM audit, busy
                    # ratio, and runtime provenance
                    from celestia_tpu_torch import devledger

                    self._reply(devledger.debug_doc())
                elif parts == ["genesis"]:
                    # the download-genesis source (ref: cmd/celestia-appd/
                    # cmd/download-genesis.go fetches a chain's genesis;
                    # here any node serves the one it started from)
                    if node.home and (node.home / "genesis.json").exists():
                        self._reply(
                            json.loads((node.home / "genesis.json").read_text())
                        )
                    else:
                        self._reply({"error": "node has no genesis file"}, 404)
                elif len(parts) == 2 and parts[0] == "block":
                    block = node.get_block(int(parts[1]))
                    if block is None:
                        self._reply({"error": "block not found"}, 404)
                    else:
                        self._reply(block.to_json())
                elif len(parts) == 2 and parts[0] == "header":
                    # header-only view: what a LIGHT client downloads —
                    # no txs, no shares (O(1) vs the O(w^2) block body)
                    block = node.get_block(int(parts[1]))
                    if block is None:
                        self._reply({"error": "block not found"}, 404)
                    else:
                        self._reply(
                            {
                                "height": block.height,
                                "time": block.time,
                                "square_size": block.square_size,
                                "data_hash": block.data_hash.hex(),
                                "app_hash": block.app_hash.hex(),
                            }
                        )
                elif len(parts) == 2 and parts[0] == "dah":
                    # the full DataAvailabilityHeader (row+column NMT
                    # roots, O(w)): hash() reproduces the header's
                    # data_hash — the artifact BEFPs verify against.
                    # Root computation may bulk-fetch a device-resident
                    # square, so it rides the dispatcher.
                    h = int(parts[1])

                    def dah_work():
                        dah = node.block_dah(h)
                        return None if dah is None else dah.to_json()

                    doc = self._dispatch(dah_work, "dah")
                    if doc is None:
                        self._reply({"error": "block not found"}, 404)
                    else:
                        self._reply(doc)
                elif len(parts) == 2 and parts[0] == "eds":
                    # full extended square by row (share-serving for
                    # peers / fraud investigation; light clients never
                    # touch this route)
                    h = int(parts[1])

                    def eds_work():
                        eds = node.block_eds(h)
                        if eds is None:
                            return None
                        # whole-square route: a device-resident handle
                        # does its one bulk fetch here (this is the one
                        # consumer that genuinely reads every byte)
                        if hasattr(eds, "original_width"):
                            eds = eds.data
                        return {
                            "width": int(eds.shape[0]),
                            "rows": [
                                bytes(eds[i].reshape(-1)).hex()
                                for i in range(eds.shape[0])
                            ],
                        }

                    doc = self._dispatch(eds_work, "eds")
                    if doc is None:
                        self._reply({"error": "block not found"}, 404)
                    else:
                        self._reply(doc)
                elif len(parts) == 4 and parts[0] == "sample":
                    # /sample/<h>/<row>/<col> — ONE extended-square cell
                    # with its NMT inclusion proof against the row tree:
                    # the data-availability-sampling unit (a light
                    # client verifies it against the DAH row root it
                    # already authenticated). O(w) server work, O(log w)
                    # reply.
                    h, i, j = int(parts[1]), int(parts[2]), int(parts[3])
                    doc = self._dispatch_sample(h, i, j)
                    if doc is None:
                        self._reply({"error": "block not found"}, 404)
                    elif doc == "range":
                        self._reply({"error": "coordinate out of range"}, 400)
                    else:
                        self._reply(doc)
                elif len(parts) == 3 and parts[0] == "fraud" and parts[1] == "befp":
                    h = int(parts[2])
                    proofs = node.fraud_proofs_at(h)
                    if not proofs:
                        self._reply({"error": "no fraud proof at height"}, 404)
                    else:
                        # every stored proof for the height — the client
                        # picks the one matching ITS header's data hash
                        self._reply({"height": h, "proofs": proofs})
                elif len(parts) == 2 and parts[0] == "tx":
                    found = node.get_tx(bytes.fromhex(parts[1]))
                    if found is None:
                        self._reply({"error": "tx not found"}, 404)
                    else:
                        block, idx = found
                        self._reply(
                            {
                                "height": block.height,
                                "index": idx,
                                "result": block.to_json()["tx_results"][idx],
                            }
                        )
                elif len(parts) == 2 and parts[0] == "account":
                    acc = node.app.accounts.get_account(parts[1])
                    if acc is None:
                        self._reply({"error": "account not found"}, 404)
                    else:
                        self._reply(
                            {
                                "address": acc.address,
                                "account_number": acc.account_number,
                                "sequence": acc.sequence,
                                "balance": node.app.bank.get_balance(acc.address),
                            }
                        )
                elif len(parts) == 3 and parts[0] == "balance":
                    self._reply(
                        {"balance": node.app.bank.get_balance(parts[1], parts[2])}
                    )
                elif parts == ["ibc", "header"]:
                    # unsigned light-client header material for the
                    # latest committed state — what a relayer has the
                    # chain's validators sign for MsgUpdateClient.
                    # Assembly + lock-snapshot semantics live in
                    # Node.ibc_light_client_header (shared with the
                    # gRPC route); serialized THROUGH Header.to_json so
                    # the wire can never drift from the sign-bytes
                    # schema.
                    self._reply(node.ibc_light_client_header().to_json())
                elif len(parts) == 4 and parts[:2] == ["ibc", "packets"]:
                    # /ibc/packets/<port>/<channel> — the relayer work
                    # queue (commitments not yet acknowledged)
                    packets = node.app.ibc.pending_packets(parts[2], parts[3])
                    self._reply({"packets": [p.to_json() for p in packets]})
                elif len(parts) == 5 and parts[:2] == ["ibc", "ack"]:
                    ack = node.app.ibc.get_acknowledgement(
                        parts[2], parts[3], int(parts[4])
                    )
                    if ack is None:
                        self._reply({"error": "no acknowledgement"}, 404)
                    else:
                        self._reply({"ack": json.loads(ack.marshal())})
                elif len(parts) == 3 and parts[0] == "proof" and parts[1] == "state":
                    # /proof/state/<hex-key> — SMT inclusion/absence proof
                    # against the committed app hash (IAVL store-proof
                    # analogue; ref: baseapp "store" query with prove=true)
                    key = bytes.fromhex(parts[2])
                    # atomic triple: the value is the one this proof
                    # proves against this root, even under racing
                    # commits. The node lock extends that atomicity to
                    # the HEIGHT: a commit landing between the proof and
                    # the height read would pair H's root with H+1 —
                    # breaking remote relayers' (proof, height) race
                    # detection. Commits hold the same lock for their
                    # whole pipeline, so the pair is one snapshot.
                    with node._lock:
                        value, root, proof = node.app.store.query_with_proof(key)
                        height = node.app.height
                    self._reply(
                        {
                            "key": key.hex(),
                            "value": value.hex() if value is not None else None,
                            "app_hash": root.hex(),
                            "height": height,
                            "proof": proof.marshal(),
                        }
                    )
                elif len(parts) == 3 and parts[0] == "proof" and parts[1] == "tx":
                    # /proof/tx/<height>:<tx_index> — tx inclusion proof
                    # (ref: pkg/proof/querier.go txInclusionProof route)
                    height, idx = parts[2].split(":")
                    block = node.get_block(int(height))
                    if block is None:
                        self._reply({"error": "block not found"}, 404)
                        return
                    self._reply(self._dispatch(
                        lambda: tx_proof_doc(node, block, int(idx)), "proof.tx"))
                elif len(parts) == 3 and parts[0] == "proof" and parts[1] == "share":
                    # /proof/share/<height>:<start>:<end> — share inclusion
                    # (ref: pkg/proof/querier.go shareInclusionProof route)
                    height, start, end = parts[2].split(":")
                    block = node.get_block(int(height))
                    if block is None:
                        self._reply({"error": "block not found"}, 404)
                        return
                    from celestia_tpu_torch import appconsts, square as square_pkg
                    from celestia_tpu_torch.proof import new_share_inclusion_proof
                    from celestia_tpu_torch.shares.splitters import Range

                    import celestia_tpu_torch.namespace as ns_mod

                    def share_proof_work():
                        sq = square_pkg.construct(
                            block.txs, node.app.app_version,
                            appconsts.square_size_upper_bound(
                                node.app.app_version),
                        )
                        ns_bytes = sq[int(start)].data[:29]
                        # reuse the node's EDS/DAH when they verifiably
                        # match this block: no re-extension or root
                        # recompute, and a device-resident handle serves
                        # the proof's rows via SLICED reads (the proof
                        # re-checks each row against the DAH before
                        # proving); a square extended here runs on the
                        # node's device
                        proof_src: dict = {"device": node.device}
                        dah = node.block_dah(int(height))
                        if dah is not None and dah.hash() == block.data_hash:
                            proof_src["dah"] = dah
                            eds_handle = node.block_eds(int(height))
                            if hasattr(eds_handle, "original_width"):
                                proof_src["eds"] = eds_handle
                        proof = new_share_inclusion_proof(
                            sq, ns_mod.from_bytes(ns_bytes),
                            Range(int(start), int(end)), **proof_src
                        )
                        proof.validate(block.data_hash)
                        return _share_proof_json(proof)

                    self._reply(self._dispatch(share_proof_work,
                                               "proof.share"))
                elif len(parts) == 2 and parts[0] == "params":
                    # module param queries (grpc-gateway Params analogue)
                    module = parts[1]
                    if module == "blob":
                        p = node.app.blob.get_params()
                        self._reply(
                            {
                                "gas_per_blob_byte": p.gas_per_blob_byte,
                                "gov_max_square_size": p.gov_max_square_size,
                            }
                        )
                    elif module == "blobstream":
                        self._reply(
                            {
                                "data_commitment_window":
                                    node.app.blobstream.data_commitment_window,
                            }
                        )
                    elif module == "staking":
                        from celestia_tpu_torch.appconsts import BOND_DENOM

                        self._reply(
                            {
                                "bond_denom": BOND_DENOM,
                                "unbonding_time_seconds":
                                    node.app.staking.unbonding_time,
                            }
                        )
                    elif module == "gov":
                        from celestia_tpu_torch.x import gov as gov_mod

                        self._reply(
                            {
                                "min_deposit": gov_mod.MIN_DEPOSIT,
                                "voting_period_seconds": gov_mod.VOTING_PERIOD,
                                "quorum": gov_mod.QUORUM / gov_mod.ONE,
                                "threshold": gov_mod.THRESHOLD / gov_mod.ONE,
                                "veto_threshold":
                                    gov_mod.VETO_THRESHOLD / gov_mod.ONE,
                            }
                        )
                    else:
                        self._reply({"error": f"unknown module {module}"}, 404)
                elif parts == ["snapshot"]:
                    # state-sync snapshot serving (SDK snapshot store /
                    # StateSync config — app/default_overrides.go:265)
                    self._reply(node.snapshot_payload())
                elif len(parts) == 3 and parts[0] == "namespace_data":
                    # /namespace_data/<height>/<ns-hex> — the blobs of one
                    # namespace in a block, each with its share range and
                    # an inclusion proof (celestia's namespaced-shares
                    # query surface over pkg/proof)
                    block = node.get_block(int(parts[1]))
                    if block is None:
                        self._reply({"error": "block not found"}, 404)
                        return
                    import celestia_tpu_torch.namespace as ns_mod

                    target = ns_mod.from_bytes(bytes.fromhex(parts[2]))
                    doc, status = self._dispatch(
                        lambda: namespace_data_doc(node, block, target), "namespace_data")
                    self._reply(doc, status)
                elif parts == ["blobstream", "nonces"]:
                    # ref: LatestAttestationNonce + EarliestAttestationNonce
                    self._reply(
                        {
                            "latest": node.app.blobstream.latest_nonce(),
                            "earliest": node.app.blobstream.earliest_nonce(),
                        }
                    )
                elif len(parts) == 3 and parts[0] == "blobstream" \
                        and parts[1] == "attestation":
                    # ref: x/blobstream query server AttestationRequestByNonce
                    att = node.app.blobstream.get_attestation(int(parts[2]))
                    if att is None:
                        self._reply({"error": "attestation not found"}, 404)
                    else:
                        self._reply(att)
                elif parts == ["blobstream", "valset", "latest"]:
                    from celestia_tpu_torch.x import blobstream_abi as bsabi

                    vs = node.app.blobstream.latest_valset()
                    if vs is None:
                        self._reply({"error": "no valset yet"}, 404)
                    else:
                        vs = dict(vs)
                        vs["hash"] = bsabi.validator_set_hash(vs["members"]).hex()
                        vs["sign_bytes"] = bsabi.valset_sign_bytes(
                            vs["nonce"], vs["members"]
                        ).hex()
                        self._reply(vs)
                elif len(parts) == 3 and parts[0] == "blobstream" \
                        and parts[1] == "data_commitment":
                    # ref: QueryDataCommitmentRangeForHeight + the ABI
                    # artifacts an orchestrator signs over
                    from celestia_tpu_torch.x import blobstream_abi as bsabi
                    from celestia_tpu_torch.x.blobstream_client import (
                        data_root_tuple_root_for_attestation,
                    )

                    att = node.app.blobstream.data_commitment_range_for_height(
                        int(parts[2])
                    )
                    if att is None:
                        self._reply({"error": "no commitment covers height"}, 404)
                    else:
                        att = dict(att)
                        root = data_root_tuple_root_for_attestation(node, att)
                        att["tuple_root"] = root.hex()
                        att["sign_bytes"] = bsabi.data_commitment_sign_bytes(
                            att["nonce"], root
                        ).hex()
                        self._reply(att)
                elif len(parts) == 3 and parts[0] == "blobstream" \
                        and parts[1] == "data_root_inclusion":
                    # trpc.DataRootInclusionProof analogue
                    from celestia_tpu_torch.x import blobstream_abi as bsabi
                    from celestia_tpu_torch.x.blobstream_client import _tuple_range

                    height = int(parts[2])
                    att = node.app.blobstream.data_commitment_range_for_height(
                        height
                    )
                    if att is None:
                        self._reply({"error": "no commitment covers height"}, 404)
                    else:
                        heights, roots = _tuple_range(
                            node, att["begin_block"], att["end_block"]
                        )
                        proof = bsabi.prove_data_root_inclusion(
                            heights, roots, height
                        )
                        self._reply(
                            {"nonce": att["nonce"], "proof": proof.to_json()}
                        )
                elif parts and parts[0] == "cosmos":
                    self._gateway_get(parts)
                else:
                    # includes GET / (empty parts), which used to fall
                    # into the cosmos check and 500 on the index access
                    self._not_found()
            except Shed as e:
                self._shed_reply(e)
            except DeadlineExceeded as e:
                self._deadline_reply(e)
            except Exception as e:  # noqa: BLE001
                log.error("query failed", path=self.path, error=str(e))
                self._reply({"error": str(e)}, 500)

        def _gateway_get(self, parts):
            """grpc-gateway REST shim (the SDK's `/cosmos/...` JSON
            routes, api.enable in the reference's app.toml): the same
            services the gRPC API exposes (node/grpc_api.py), spelled as
            the REST paths Cosmos tooling (cosmjs/cosmpy, explorers)
            dials. Thin aliases over the node functions the native
            routes above already serve."""
            from celestia_tpu_torch.x.bank import BALANCE_PREFIX, split_balance_key

            if parts[:4] == ["cosmos", "auth", "v1beta1", "accounts"] and len(parts) == 5:
                acc = node.app.accounts.get_account(parts[4])
                if acc is None:
                    self._reply({"error": "account not found"}, 404)
                    return
                self._reply({
                    "account": {
                        "@type": "/cosmos.auth.v1beta1.BaseAccount",
                        "address": acc.address,
                        "account_number": str(acc.account_number),
                        "sequence": str(acc.sequence),
                    }
                })
            elif parts[:4] == ["cosmos", "bank", "v1beta1", "balances"] and len(parts) == 5:
                address = parts[4]
                prefix = BALANCE_PREFIX + address.encode() + b"\x00"
                balances = []
                for key, raw in node.app.store.iter_prefix(prefix):
                    _addr, denom = split_balance_key(key)
                    amount = int.from_bytes(raw, "big")
                    if amount:
                        balances.append(
                            {"denom": denom, "amount": str(amount)}
                        )
                self._reply({"balances": balances, "pagination": None})
            elif parts[:5] == ["cosmos", "base", "tendermint", "v1beta1", "blocks"] and len(parts) == 6:
                if parts[5] == "latest":
                    height = node.app.height
                else:
                    try:
                        height = int(parts[5])
                    except ValueError:
                        self._reply({"error": "invalid block height"}, 400)
                        return
                block = node.get_block(height)
                if block is None:
                    self._reply({"error": "block not found"}, 404)
                    return
                j = block.to_json()
                self._reply({
                    "block_id": {"hash": j["app_hash"]},
                    "block": {
                        "header": {
                            "chain_id": node.app.chain_id,
                            "height": str(block.height),
                            "time": block.time,
                            "data_hash": j["data_hash"],
                            "app_hash": j["app_hash"],
                        },
                        "data": {"txs": j["txs"]},
                    },
                })
            elif parts[:5] == ["cosmos", "base", "tendermint", "v1beta1", "node_info"]:
                s = node.status()
                self._reply({
                    "default_node_info": {"network": s["chain_id"]},
                    "application_version": {
                        "app_name": "celestia-tpu",
                        "version": s.get("app_version", 0),
                    },
                })
            elif parts[:4] == ["cosmos", "tx", "v1beta1", "txs"] and len(parts) == 5:
                try:
                    txhash = bytes.fromhex(parts[4])
                except ValueError:
                    self._reply({"error": "invalid tx hash"}, 400)
                    return
                found = node.get_tx(txhash)
                if found is None:
                    self._reply({"error": "tx not found"}, 404)
                    return
                block, idx = found
                result = block.to_json()["tx_results"][idx]
                self._reply({
                    "tx_response": {
                        "height": str(block.height),
                        "txhash": parts[4].upper(),
                        "code": result["code"],
                        "raw_log": result["log"],
                    }
                })
            else:
                self._not_found()

        def do_POST(self):
            with tracker, \
                    tracing.span("rpc.request", method="POST",
                                 path=self.path) as sp:
                sink = self._begin_trace(sp)
                try:
                    self._route_post()
                finally:
                    if sink is not None:
                        tracing.pop_stage_sink()

        def _route_post(self):
            from celestia_tpu_torch import faults

            parts = [p for p in self.path.split("/") if p]
            try:
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                # request-side fault application (specs/faults.md): a
                # corrupt/bitflip rule armed at ``rpc.post`` mangles the
                # body AS RECEIVED — the server-side twin of the
                # client-side fire in node/client.py, so body-corruption
                # drills hold for any client speaking to the node
                flip = faults.fire("rpc.post", path=self.path, side="server")
                if flip is not None:
                    raw = flip(raw)
                # a mangled body is a CLIENT-VISIBLE 400, never a 500
                # traceback: the bytes were wrong, not the server
                try:
                    body = json.loads(raw or b"{}")
                except ValueError as e:
                    self._reply({"error": f"malformed JSON body: {e}",
                                 "status": 400}, 400)
                    return
                if not isinstance(body, dict):
                    self._reply({"error": "request body must be a JSON "
                                          "object", "status": 400}, 400)
                    return
                if parts == ["broadcast_tx"]:
                    raw = bytes.fromhex(body["tx"])
                    res = node.broadcast_tx(raw)
                    # devnet gossip: forward a freshly-admitted tx to
                    # peers exactly once (forward=False marks relayed
                    # copies, so gossip never loops). Off-thread: a hung
                    # peer must not stall the submitter's reply into its
                    # client timeout (and a retry double-submit).
                    validator = getattr(node, "validator", None)
                    if (
                        res.code == 0
                        and validator is not None
                        and body.get("forward", True)
                    ):
                        threading.Thread(
                            target=validator.gossip_tx, args=(raw,),
                            daemon=True,
                        ).start()
                    self._reply(
                        {"code": res.code, "log": res.log, "priority": res.priority}
                    )
                elif parts == ["cosmos", "tx", "v1beta1", "txs"]:
                    # grpc-gateway BroadcastTx: base64 tx_bytes, JSON
                    # tx_response reply (the shape cosmjs/cosmpy expect)
                    import base64
                    import hashlib as _hashlib

                    raw = base64.b64decode(body["tx_bytes"])
                    res = node.broadcast_tx(raw)
                    validator = getattr(node, "validator", None)
                    if res.code == 0 and validator is not None:
                        threading.Thread(
                            target=validator.gossip_tx, args=(raw,),
                            daemon=True,
                        ).start()
                    self._reply({
                        "tx_response": {
                            "code": res.code,
                            "txhash": _hashlib.sha256(raw).hexdigest().upper(),
                            "raw_log": res.log,
                        }
                    })
                elif parts == ["produce_block"]:
                    # extend/commit is the heaviest device pipeline the
                    # node runs — it must not race serving reads on the
                    # stream, so it rides the dispatcher too
                    block = self._dispatch(node.produce_block,
                                           "produce_block")
                    self._reply(block.to_json())
                elif parts == ["consensus", "proposal"]:
                    validator = getattr(node, "validator", None)
                    if validator is None:
                        self._reply({"error": "not a devnet validator"}, 404)
                    else:
                        self._reply(validator.handle_proposal(body))
                elif parts == ["consensus", "commit"]:
                    validator = getattr(node, "validator", None)
                    if validator is None:
                        self._reply({"error": "not a devnet validator"}, 404)
                    else:
                        self._reply(validator.handle_commit(body))
                elif parts == ["gossip", "have"]:
                    # CAT want/have (specs/src/specs/cat_pool.md): a
                    # gossiping peer offers tx KEYS; we answer with the
                    # subset we actually want the bytes for
                    keys = [bytes.fromhex(k) for k in body.get("keys", [])]
                    want = [
                        k.hex() for k in keys
                        if not node.mempool.has_seen(k)
                    ]
                    self._reply({"want": want})
                elif parts == ["consensus", "evidence"]:
                    validator = getattr(node, "validator", None)
                    if validator is None:
                        self._reply({"error": "not a devnet validator"}, 404)
                    else:
                        self._reply(validator.handle_evidence(body))
                elif parts == ["fraud", "befp"]:
                    # gossiped Bad Encoding Fraud Proof: verify
                    # independently, store, re-gossip once
                    validator = getattr(node, "validator", None)
                    if validator is None:
                        self._reply({"error": "not a devnet validator"}, 404)
                    else:
                        self._reply(validator.handle_fraud(body))
                else:
                    self._not_found()
            except Shed as e:
                self._shed_reply(e)
            except DeadlineExceeded as e:
                self._deadline_reply(e)
            except (KeyError, TypeError, ValueError) as e:
                # wrong-shaped but parseable bodies (missing keys, bad
                # hex/base64) are the client's fault: consistent 400
                log.warn("bad request", path=self.path, error=str(e))
                self._reply({"error": f"bad request: {e}", "status": 400},
                            400)
            except Exception as e:  # noqa: BLE001
                log.error("broadcast failed", path=self.path, error=str(e))
                self._reply({"error": str(e)}, 500)

    return Handler


class RpcServer:
    """The node's HTTP front door + its device dispatcher.

    The server OWNS a `DeviceDispatcher`: request threads
    parse/validate, the dispatcher thread executes every device-
    touching route body. It also registers the dispatcher as the
    process-wide device executor (`transfers.register_device_executor`)
    so node-internal sliced reads from non-RPC threads funnel through
    the same single stream owner; a failure to register propagates."""

    def __init__(self, node: Node, host: str = "127.0.0.1",
                 port: int = 26657, *,
                 queue_capacity: int | None = None,
                 default_deadline_s: float | None = None):
        self.node = node
        self.dispatcher = DeviceDispatcher(capacity=queue_capacity,
                                           default_deadline_s=default_deadline_s)
        # readiness (slo.readiness not_overloaded) and node-internal
        # device funneling discover the dispatcher through the node
        node.dispatcher = self.dispatcher
        self._tracker = _InflightTracker()

        class _Server(http.server.ThreadingHTTPServer):
            # Admission control is the dispatcher's bounded queue
            # (ADR-016) — the kernel listen backlog must not be an
            # accidental second limiter. socketserver's default of 5
            # overflows under a storm of no-keep-alive light clients
            # and surfaces as ~1 s SYN-retransmit latency tails that
            # have nothing to do with serving capacity.
            request_queue_size = 128

        self.server = _Server(
            (host, port),
            _handler_for(node, self.dispatcher, self._tracker),
        )
        self.port = self.server.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self.dispatcher.start()
        transfers.register_device_executor(self.dispatcher.run_device)
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self, drain_timeout: float = 5.0) -> None:
        """Graceful drain (specs/serving.md): stop accepting new
        connections, let in-flight requests finish, drain the
        dispatcher (queued device work completes; stragglers past the
        timeout shed with reason="draining"), then close the socket."""
        self.server.shutdown()
        self.dispatcher.begin_drain()
        self._tracker.wait_idle(drain_timeout)
        self.dispatcher.drain(timeout=drain_timeout)
        transfers.unregister_device_executor(self.dispatcher.run_device)
        self.server.server_close()
