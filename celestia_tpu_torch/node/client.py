"""RPC client — the remote transport for Signer and tools (port of the
JAX package's node/client.py).

The reference's clients speak gRPC to a node (pkg/user dials a grpc
conn, signer.go:83); this is the same role over the node's JSON/HTTP
RPC: an object with the transport surface Signer expects
(broadcast_tx / get_tx / account), plus the common queries. With it the
full client stack — tx options, nonce-race recovery, min-gas-price
bumping — works against a node on the other end of a socket exactly as
it does in-process. The light client checks every sample's NMT proof and
every fraud proof with the port's own ``proof`` and ``da``, on the host.
"""

from __future__ import annotations

import dataclasses
import json
import random
import threading
import time
import urllib.error
import urllib.request

from celestia_tpu_torch import faults, tracing


class TransportError(Exception):
    """A request failed at the transport layer after exhausting retries.

    The ONLY transport exception RpcClient lets escape — raw
    urllib.error.URLError / socket errors never leak to callers."""


class CircuitOpenError(TransportError):
    """Fast-fail: the client's circuit breaker is open after a streak of
    consecutive transport failures; no network attempt was made."""


@dataclasses.dataclass
class BroadcastResult:
    code: int
    log: str = ""
    priority: int = 0


# 404 must survive the retry wrapper as a distinct value ("not found",
# not "transport failed"): callers get None, never a retry storm
_NOT_FOUND = object()

# transport-layer failures worth retrying: connect errors, timeouts,
# mid-stream resets, injected faults, and corrupted (unparseable)
# payloads — ValueError, not JSONDecodeError: a flipped byte can also
# surface as UnicodeDecodeError from json.loads, and both mean "the
# bytes on the wire were damaged". urllib.error.HTTPError is
# deliberately handled BEFORE this tuple can see it (it subclasses
# URLError but means "the server answered").
_RETRYABLE = (
    urllib.error.URLError,
    ConnectionError,
    TimeoutError,
    OSError,
    ValueError,
    faults.TransportFault,
)


class RpcClient:
    def __init__(self, base_url: str, timeout: float = 10.0,
                 retries: int = 3, backoff_base: float = 0.05,
                 backoff_max: float = 1.0, breaker_threshold: int = 8,
                 breaker_cooldown: float = 5.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.retries = retries
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self._fail_streak = 0
        self._open_until = 0.0
        self._breaker_lock = threading.Lock()

    # --- plumbing: retry with exponential backoff + full jitter, and a
    # circuit breaker that fast-fails after a streak of consecutive
    # transport failures (half-open after the cooldown: one probe either
    # closes it or re-opens it immediately) ---

    def _note_failure(self) -> bool:
        """Record one transport failure; returns True when it opened
        (or re-opened) the breaker."""
        from celestia_tpu_torch.telemetry import metrics

        with self._breaker_lock:
            self._fail_streak += 1
            if self._fail_streak < self.breaker_threshold:
                return False
            # streak is NOT reset: after the cooldown the next single
            # probe failure lands here again and re-opens immediately
            self._open_until = time.monotonic() + self.breaker_cooldown
            metrics.incr_counter("rpc_breaker_open_total")
            return True

    def _note_success(self) -> None:
        with self._breaker_lock:
            self._fail_streak = 0
            self._open_until = 0.0

    def _with_retry(self, site: str, path: str, attempt_fn):
        from celestia_tpu_torch.telemetry import metrics

        with self._breaker_lock:
            remaining = self._open_until - time.monotonic()
            if remaining > 0:
                raise CircuitOpenError(
                    f"{self.base_url}: circuit open for another "
                    f"{remaining:.2f}s ({site} {path})"
                )
        last = None
        attempt = 0
        for attempt in range(self.retries + 1):
            try:
                out = attempt_fn()
            except TransportError:
                raise  # already typed (4xx, nested breaker) — no retry
            except _RETRYABLE as e:
                last = e
                opened = self._note_failure()
                if attempt >= self.retries or opened:
                    break
                metrics.incr_counter("rpc_retry_total", site=site)
                delay = min(self.backoff_max,
                            self.backoff_base * (2 ** attempt))
                time.sleep(random.uniform(0.0, delay))  # full jitter
                continue
            self._note_success()
            return out
        raise TransportError(
            f"{site} {self.base_url}{path} failed after {attempt + 1} "
            f"attempts: {last!r}"
        ) from last

    def _get(self, path: str):
        out = self._with_retry("rpc.get", path, lambda: self._once_get(path))
        return None if out is _NOT_FOUND else out

    def _trace_header(self) -> str | None:
        """Outbound ``X-Trace-Context`` when tracing is on: continue
        the calling thread's open span (the server's handler span then
        parents under it) or mint a fresh context, so a client-driven
        request chain is one fleet trace. None (no header) when
        tracing is off — the disabled path allocates nothing."""
        if not tracing.enabled():
            return None
        sp = tracing.current()
        if isinstance(sp, tracing.Span) and sp.trace_id:
            return tracing.header_value(sp.trace_id,
                                        tracing.wire_span_id(sp))
        return tracing.mint().header_value()

    def _once_get(self, path: str):
        corrupt = faults.fire("rpc.get", url=self.base_url + path)
        req = urllib.request.Request(self.base_url + path)
        header = self._trace_header()
        if header:
            req.add_header(tracing.TRACE_HEADER, header)
        try:
            with urllib.request.urlopen(
                req, timeout=self.timeout
            ) as resp:
                raw = resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return _NOT_FOUND
            if e.code >= 500:
                # a 5xx is a server hiccup — retryable like a dropped
                # connection
                raise faults.TransportFault(f"HTTP {e.code}") from e
            raise TransportError(
                f"GET {self.base_url}{path}: HTTP {e.code}"
            ) from e
        if corrupt is not None:
            raw = corrupt(raw)
        return json.loads(raw)

    def _post(self, path: str, body: dict):
        return self._with_retry(
            "rpc.post", path, lambda: self._once_post(path, body)
        )

    def _once_post(self, path: str, body: dict):
        corrupt = faults.fire("rpc.post", url=self.base_url + path)
        req = urllib.request.Request(
            self.base_url + path,
            data=json.dumps(body).encode(),
            method="POST",
        )
        header = self._trace_header()
        if header:
            req.add_header(tracing.TRACE_HEADER, header)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                raw = resp.read()
        except urllib.error.HTTPError as e:
            # the server wraps handler exceptions as {"error": ...} with a
            # 5xx status; surface that as a result the caller can inspect,
            # like the in-process transport's caught ValueError. A reply
            # (any status) means the server PROCESSED the request — never
            # retried, so a non-idempotent POST cannot double-apply here.
            try:
                return json.loads(e.read())
            except ValueError:
                return {"error": f"HTTP {e.code}"}
        if corrupt is not None:
            raw = corrupt(raw)
        return json.loads(raw)

    # --- the Signer transport surface ---

    def broadcast_tx(self, raw: bytes) -> BroadcastResult:
        res = self._post("/broadcast_tx", {"tx": raw.hex()})
        if "error" in res:
            return BroadcastResult(code=1, log=res["error"])
        return BroadcastResult(
            code=res.get("code", 1),
            log=res.get("log", ""),
            priority=res.get("priority", 0),
        )

    def get_tx(self, key: bytes):
        """Committed-tx lookup by hash; None until included in a block."""
        return self._get(f"/tx/{key.hex()}")

    def account(self, address: str):
        """Account state for Signer.setup_single: dict with
        account_number/sequence/balance, or None."""
        return self._get(f"/account/{address}")

    # --- common queries ---

    def status(self) -> dict:
        return self._get("/status")

    def block(self, height: int):
        return self._get(f"/block/{height}")

    def balance(self, address: str, denom: str = "utia") -> int:
        # an unknown account is a 404 (None), not an error: balance 0
        res = self._get(f"/balance/{address}/{denom}")
        return 0 if res is None else int(res.get("balance", 0))

    def params(self, module: str):
        return self._get(f"/params/{module}")

    def namespace_data(self, height: int, namespace: bytes):
        return self._get(f"/namespace_data/{height}/{namespace.hex()}")

    def header(self, height: int):
        """Header-only fetch (no txs/shares) — the light-client view."""
        return self._get(f"/header/{height}")

    def dah(self, height: int):
        """Full DataAvailabilityHeader: row+column NMT roots, O(w)."""
        return self._get(f"/dah/{height}")

    def eds(self, height: int):
        """Full extended square by row — O(w^2); full nodes only."""
        return self._get(f"/eds/{height}")

    def sample(self, height: int, row: int, col: int):
        """One EDS cell + NMT inclusion proof (the DAS unit), or None."""
        return self._get(f"/sample/{height}/{row}/{col}")

    def befp(self, height: int):
        """Stored Bad Encoding Fraud Proofs at a height:
        {"height", "proofs": [wire, ...]} or None."""
        return self._get(f"/fraud/befp/{height}")

    def snapshot(self) -> dict:
        return self._get("/snapshot")

    # --- IBC relayer surface (light-client mode, specs/ibc.md) ---

    def state_proof(self, key: bytes) -> dict:
        """(value|None, app_hash, smt.Proof, height) verifiable with
        StateStore.verify_proof — the commitment-proof source for a
        remote relayer."""
        from celestia_tpu_torch import smt as smt_mod

        res = self._get(f"/proof/state/{key.hex()}")
        # `is not None`, not truthiness: an EMPTY committed value
        # (value="") is an inclusion, not an absence
        return {
            "value": (
                bytes.fromhex(res["value"])
                if res["value"] is not None else None
            ),
            "app_hash": bytes.fromhex(res["app_hash"]),
            "height": res["height"],
            "proof": smt_mod.Proof.unmarshal(res["proof"]),
        }

    def ibc_header(self):
        """Unsigned light-client header for the chain's latest state
        (decoded through Header.from_json — one schema, no drift)."""
        from celestia_tpu_torch.x.lightclient import Header

        return Header.from_json(self._get("/ibc/header"))

    def ibc_pending_packets(self, port_id: str, channel_id: str) -> list:
        from celestia_tpu_torch.x.ibc import Packet

        res = self._get(f"/ibc/packets/{port_id}/{channel_id}")
        return [Packet.from_json(p) for p in res["packets"]]

    def ibc_ack(self, port_id: str, channel_id: str, seq: int):
        from celestia_tpu_torch.x.ibc import Acknowledgement

        res = self._get(f"/ibc/ack/{port_id}/{channel_id}/{seq}")
        if res is None:
            return None
        return Acknowledgement.unmarshal(json.dumps(res["ack"]).encode())


def _wire_key(wire) -> str:
    """32-byte digest of a fraud-proof wire for the screened-memo — the
    raw JSON dump would keep hundreds of KB alive per screened proof."""
    import hashlib

    return hashlib.sha256(
        json.dumps(wire, sort_keys=True).encode()
    ).hexdigest()


class FraudDetected(Exception):
    """A verified BEFP proves the header's DAH commits a bad encoding."""


class Unavailable(Exception):
    """A sampled block's data cannot be fetched and proof-verified."""


class FraudAwareLightClient:
    """Header-tracking light client with fraud-proof protection — the
    consumer role of specs/fraud_proofs.md (reference: a celestia light
    node rejects a header when a DASer relays a verified BEFP).

    Downloads are O(w) per header: the header itself and, when a
    watchtower volunteers a fraud proof, the proof (2w shares + 2w NMT
    paths). The O(w^2) square is NEVER fetched — the whole point is
    that a light client can reject a fraudulent block it cannot afford
    to download. Every volunteered proof is verified INDEPENDENTLY
    against the header's own data_hash before it is believed, so a
    malicious watchtower cannot frame an honest chain."""

    def __init__(self, primary, watchtowers: list[RpcClient]):
        # `primary` is one RpcClient or an ordered failover list: the
        # client sticks with the current primary until its transport
        # fails (breaker open / retries exhausted), then advances to the
        # next and stays there — every primary serves the same chain, so
        # verification is unaffected by which one answered.
        prims = list(primary) if isinstance(primary, (list, tuple)) \
            else [primary]
        if not prims:
            raise ValueError("need at least one primary")
        self.primaries: list[RpcClient] = prims
        self._primary_idx = 0
        self.watchtowers = list(watchtowers)
        self.headers: dict[int, dict] = {}
        # wires already screened as harmless for a given header
        # (wrong-DAH / malformed): keyed by (height, header data_hash,
        # wire identity) so periodic rescreen() re-verifies only NEW
        # proofs. The data_hash MUST be part of the key — a proof
        # dismissed as "wrong DAH" under header X may be exactly the
        # proof that condemns a DIFFERENT header Y the primary serves
        # at that height after a reorg/equivocation. Insertion-ordered
        # (dict) so the eviction policy can drop the OLDEST entries.
        self._screened: dict[tuple[int, str, str], None] = {}

    @property
    def primary(self) -> RpcClient:
        return self.primaries[self._primary_idx]

    def _with_primary(self, fn):
        """Run `fn(client)` against the current primary; on a transport
        failure (typed — breaker open or retries exhausted) advance to
        the next primary and retry, once around the ring."""
        last = None
        n = len(self.primaries)
        for i in range(n):
            idx = (self._primary_idx + i) % n
            try:
                out = fn(self.primaries[idx])
            except TransportError as e:
                last = e
                continue
            self._primary_idx = idx  # sticky: keep the one that answered
            return out
        raise last

    def accept_header(self, height: int) -> dict | None:
        """Fetch + screen one header. Returns the header dict, None when
        the primary does not have the height yet, or raises
        FraudDetected with the verified proof attached.

        Acceptance is PROVISIONAL: a full node needs time to fetch the
        square and prove a bad encoding, so a proof can surface after
        the header was already screened clean. Call rescreen()
        periodically — it re-checks every accepted header and evicts
        (raising) on late-arriving proofs."""
        hdr = self._with_primary(lambda c: c.header(height))
        if hdr is None:
            return None
        self._screen(height, hdr)
        self.headers[height] = hdr
        return hdr

    # bound on the screened-harmless memo: a malicious watchtower
    # serving fresh malformed wires every round must not grow client
    # memory with its effort. Exceeding the cap clears the memo — the
    # worst case is re-verification work, never a wrong verdict.
    MAX_SCREENED_MEMO = 8192

    def rescreen(self, window: int | None = None) -> None:
        """Re-screen accepted headers against the watchtowers; a
        late-arriving verified proof evicts the header AND everything
        above it (descendants build on the fraudulent state) before
        raising FraudDetected.

        By default EVERY accepted header is re-screened — the guarantee
        is that no accepted header survives a later proof. Passing
        `window` bounds the check to the HIGHEST `window` headers for
        callers that rescreen on a tight cadence and cannot afford
        O(chain length) HTTP traffic per tick; such callers should
        still run an unbounded pass periodically."""
        heights = sorted(self.headers)
        if window is not None:
            heights = heights[-window:]
        for height in heights:
            try:
                self._screen(height, self.headers[height])
            except FraudDetected:
                for h in [h for h in self.headers if h >= height]:
                    del self.headers[h]
                raise

    def _memo(self, key) -> None:
        if len(self._screened) >= self.MAX_SCREENED_MEMO:
            # evict the oldest half, not everything: a full clear forced
            # re-verification of EVERY known-harmless proof at once —
            # exactly the amplification a junk-flooding watchtower wants.
            # Old entries are the ones most likely to belong to long-
            # pruned headers anyway.
            drop = max(1, len(self._screened) // 2)
            for k in list(self._screened)[:drop]:
                del self._screened[k]
        self._screened[key] = None

    def sample_availability(self, height: int, n: int = 16,
                            rng=None) -> dict:
        """Data-availability sampling (the celestia-node DAS role): pick
        n uniformly random extended-square cells, fetch each with its
        NMT proof from the primary, and verify against the header's own
        DAH. The header must already be accepted (screened).

        Every fetched byte is UNTRUSTED: a share must carry a valid
        inclusion proof against the authenticated row root or the
        sample counts as unavailable. Returns
        {"sampled", "confidence"} where confidence = 1 - 2^-n is the
        probability bound that at least half
        the square is retrievable (each hidden-majority square fails an
        independent sample with p >= 1/2, and a return means ALL n
        verified — one failure raises); raises Unavailable when any
        sample cannot be served or verified — the light client should
        treat the block as unavailable and alert.

        Note sampling checks AVAILABILITY, not encoding validity: a
        well-served but mis-encoded square passes sampling by design —
        that is exactly the gap fraud proofs close (§specs/
        fraud_proofs.md)."""
        import random

        from celestia_tpu_torch.da import (
            DataAvailabilityHeader,
            erasured_leaf_namespace,
        )
        from celestia_tpu_torch.proof import NmtRangeProof

        hdr = self.headers.get(height)
        if hdr is None:
            raise ValueError(f"header {height} not accepted yet")
        try:
            dah_json = self._with_primary(lambda c: c.dah(height))
        except Exception as e:  # noqa: BLE001 — stonewalling = unavailable
            raise Unavailable(
                f"height {height}: DAH fetch failed: {e}"
            ) from e
        if dah_json is None:
            raise Unavailable(f"height {height}: primary serves no DAH")
        try:
            dah = DataAvailabilityHeader.from_json(dah_json)
        except Exception as e:  # noqa: BLE001 — malformed reply = unavailable
            raise Unavailable(
                f"height {height}: malformed DAH reply: {e}"
            ) from e
        if dah.hash().hex() != hdr["data_hash"]:
            raise Unavailable(
                f"height {height}: served DAH does not match the header"
            )
        w = len(dah.row_roots)
        if w < 2:
            raise Unavailable(f"height {height}: DAH has no rows")
        k = w // 2
        rng = rng or random.SystemRandom()
        for _ in range(n):
            i, j = rng.randrange(w), rng.randrange(w)
            try:
                res = self._with_primary(
                    lambda c, i=i, j=j: c.sample(height, i, j)
                )
                share = bytes.fromhex(res["share"])
                p = res["proof"]
                proof = NmtRangeProof(
                    start=int(p["start"]), end=int(p["end"]),
                    nodes=[bytes.fromhex(x) for x in p["nodes"]],
                    tree_size=int(p["tree_size"]),
                )
                if (proof.start, proof.end) != (j, j + 1) or \
                        proof.tree_size != w:
                    raise ValueError("proof shape mismatch")
                ns = erasured_leaf_namespace(i, j, share, k)
                proof.verify_inclusion(dah.row_roots[i], [ns], [share])
            except Exception as e:  # noqa: BLE001 — any failure = unavailable
                raise Unavailable(
                    f"height {height}: sample ({i},{j}) failed: {e}"
                ) from e
        # all-or-nothing by design: ONE unservable/unverifiable sample
        # makes the block unavailable (raises above), so a return means
        # every sample verified
        return {"sampled": n, "confidence": 1.0 - 0.5 ** n}

    def _screen(self, height: int, hdr: dict) -> None:
        from celestia_tpu_torch.da import DataAvailabilityHeader
        from celestia_tpu_torch.da import fraud as fraud_mod

        for tower in self.watchtowers:
            # EVERYTHING a watchtower sends is untrusted: any shape
            # error anywhere (non-dict reply, null proof entries, bad
            # hex) means "this tower has no usable proof", never a
            # crash — only a VERIFIED proof may affect the client
            try:
                faults.fire("watchtower.befp", url=tower.base_url)
                res = tower.befp(height)
                wires = list((res or {}).get("proofs", []))
            except Exception:  # noqa: BLE001 — a broken watchtower is no proof
                continue
            for wire in wires:
                try:
                    key = (height, hdr["data_hash"], _wire_key(wire))
                    if key in self._screened:
                        continue
                    dah = DataAvailabilityHeader.from_json(wire["dah"])
                    if dah.hash().hex() != hdr["data_hash"]:
                        # proof is for some other block — not THIS
                        # header's problem (re-checked per data_hash)
                        self._memo(key)
                        continue
                    proof = fraud_mod.BadEncodingFraudProof.from_json(
                        wire["proof"]
                    )
                    is_fraud = fraud_mod.verify_befp(proof, dah)
                except Exception:  # noqa: BLE001 — malformed/forged: rejected
                    try:
                        self._memo((height, hdr["data_hash"], _wire_key(wire)))
                    except Exception:  # noqa: BLE001 — unserializable junk
                        pass
                    continue
                if is_fraud:
                    err = FraudDetected(
                        f"height {height}: committed DAH fails the erasure "
                        f"code ({proof.axis} {proof.index}) — proven by "
                        f"{tower.base_url}"
                    )
                    err.height = height  # structured access for callers
                    raise err
                self._memo(key)
