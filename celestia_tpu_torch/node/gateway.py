"""Consistent-hash DAS gateway over N backend nodes (ADR-021; port of the
JAX package's node/gateway.py, host HTTP only).

The first request path that crosses a node boundary: a thin HTTP
front door that routes `/sample/<h>/<i>/<j>` by **(height, row)** onto
a consistent-hash ring of backend base URLs. Keying by (height, row)
— not the full coordinate — means every sample of the same row lands
on the same backend, so that backend's dispatcher coalesces them into
ONE batched sliced read (ADR-017) and its prover memo hashes the row
once (ADR-019); a per-(h,i,j) key would shred the batch.

The gateway adds NO admission or deadline logic of its own: each
backend's `rpc.py` dispatcher keeps its bounded queue, X-Deadline-Ms
budget (forwarded verbatim), and drain semantics. What the gateway
adds is placement and failover:

  * hedged retry — a backend 503 (shed) or connection failure moves
    the request to the NEXT distinct ring position (`gateway.hedge`
    fault site + `gateway_hedge_total`); non-503 HTTP statuses (404,
    400) are backend answers and pass through untouched;
  * shed cooldown — a backend that sheds is DEMOTED to the back of
    the candidate order for its `Retry-After` window (default
    `cooldown_s`, capped), so the very next request does not re-hedge
    straight into the replica that just said "not now"
    (`gateway_backend_cooldown_total` counts demotion windows opened);
  * ring rebalance — `add_backend`/`remove_backend` re-point only the
    vnode arcs that move (consistent hashing), so a join/leave does
    not reshuffle the whole keyspace;
  * `/status` aggregation — one document with every backend's own
    `/status` plus the ring view; a member that cannot answer within
    the short per-backend `status_timeout_s` is reported as
    `{"state": "down"}` instead of stalling the aggregation for the
    full routing timeout; `/readyz` is ready iff ≥1 backend is ready.

Locking: `HashRing._ring_lock` guards the vnode table and backend
set; it is in the FIRST rank of the specs/serving.md declared order
(after the fleet supervisor's `fleet._lock`) and is NEVER held across
a backend fetch (`urlopen` is a blocking call — celestia-lint C002):
routing snapshots the candidate list under the lock, then fetches
unlocked. `gateway._cooldown_lock` is its rank peer guarding only the
cooldown table — dict ops only, never nested with the ring lock and
never held across a fetch.

Fault sites (specs/faults.md): `gateway.route` fires once per routing
decision (delay/error rules model a slow or failing router);
`gateway.hedge` fires before each failover hop (delay rules model
hedge latency; error rules a failover path that itself fails).
"""

from __future__ import annotations

import bisect
import collections
import http.server
import json
import threading
import time
import urllib.error
import urllib.request
from hashlib import sha256

from celestia_tpu_torch import faults, tracing
from celestia_tpu_torch.log import logger
from celestia_tpu_torch.telemetry import metrics

log = logger("gateway")

DEFAULT_VNODES = 64


class HashRing:
    """Consistent-hash ring of backend base URLs.

    Each backend owns `vnodes` pseudo-random points on a 64-bit ring
    (SHA-256 of "url#i" — deterministic across processes, no seed);
    a key's owner is the first point clockwise from the key's hash,
    and failover candidates are the next DISTINCT backends in ring
    order, so hedging never retries the same failed backend."""

    def __init__(self, backends=(), vnodes: int = DEFAULT_VNODES):
        self.vnodes = int(vnodes)
        self._ring_lock = threading.Lock()
        self._points: list[tuple[int, str]] = []  # sorted (hash, url)
        self._backend_set: set[str] = set()
        for b in backends:
            self.add(b)

    @staticmethod
    def _hash(s: str) -> int:
        return int.from_bytes(sha256(s.encode()).digest()[:8], "big")

    def add(self, backend: str) -> None:
        with self._ring_lock:
            if backend in self._backend_set:
                return
            self._backend_set.add(backend)
            for v in range(self.vnodes):
                self._points.append(
                    (self._hash(f"{backend}#{v}"), backend))
            self._points.sort()
        self._publish()

    def remove(self, backend: str) -> None:
        with self._ring_lock:
            if backend not in self._backend_set:
                return
            self._backend_set.discard(backend)
            self._points = [p for p in self._points if p[1] != backend]
        self._publish()

    def backends(self) -> list[str]:
        with self._ring_lock:
            return sorted(self._backend_set)

    def owners(self, key: str, n: int | None = None) -> list[str]:
        """The key's owner followed by the next distinct backends in
        ring order — the hedge candidate sequence. Snapshot-read under
        the ring lock; the fetches happen after it is released."""
        h = self._hash(key)
        out: list[str] = []
        with self._ring_lock:
            if not self._points:
                return out
            limit = len(self._backend_set) if n is None else \
                min(n, len(self._backend_set))
            start = bisect.bisect_left(self._points, (h, ""))
            for step in range(len(self._points)):
                backend = self._points[(start + step) %
                                       len(self._points)][1]
                if backend not in out:
                    out.append(backend)
                    if len(out) >= limit:
                        break
        return out

    def __len__(self) -> int:
        with self._ring_lock:
            return len(self._backend_set)

    def _publish(self) -> None:
        with self._ring_lock:
            n = len(self._backend_set)
        metrics.set_gauge("gateway_ring_backends", float(n))


class Gateway:
    """Thin HTTP gateway over N in-process backend nodes.

    GETs proxy to the route key's ring owner with hedged failover;
    `/status` and `/readyz` aggregate across every backend. The
    gateway holds no block state and accepts no writes (POST → 405 —
    tx submission goes to a backend directly)."""

    DAH_CACHE_CAP = 128  # heights; a DAH doc is ~a few KB

    def __init__(self, backends=(), host: str = "127.0.0.1",
                 port: int = 0, *, vnodes: int = DEFAULT_VNODES,
                 timeout_s: float = 10.0, cooldown_s: float = 1.0,
                 cooldown_max_s: float = 5.0,
                 status_timeout_s: float = 2.0):
        self.ring = HashRing(backends, vnodes=vnodes)
        self.timeout_s = float(timeout_s)
        # aggregation endpoints probe every backend serially; a dead
        # member must cost at most this short connect timeout, not the
        # full routing timeout
        self.status_timeout_s = min(float(status_timeout_s),
                                    float(timeout_s))
        # shed cooldown table: backend url -> monotonic deadline until
        # which the backend is demoted in the hedge candidate order.
        # `_cooldown_lock` is a rank peer of the ring lock (specs/
        # serving.md lock ordering): dict ops only, never nested.
        self.cooldown_s = float(cooldown_s)
        self.cooldown_max_s = float(cooldown_max_s)
        self._cooldown: dict[str, float] = {}
        self._cooldown_lock = threading.Lock()
        # read-through LRU for /dah/<h> bodies: a committed height's
        # DAH is immutable, so entries are NEVER invalidated — only
        # LRU-evicted. `_dah_lock` is a leaf lock (specs/serving.md
        # lock ordering): held for dict ops only, never across a fetch.
        self._dah_cache: "collections.OrderedDict[int, bytes]" = \
            collections.OrderedDict()
        self._dah_lock = threading.Lock()
        gw = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _reply(self, status: int, body: bytes,
                       content_type: str = "application/json",
                       backend: str | None = None) -> None:
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                if backend:
                    self.send_header("X-Gateway-Backend", backend)
                trace_id = getattr(self, "_trace_id", None)
                if trace_id is not None:
                    self.send_header(tracing.TRACE_ID_HEADER, trace_id)
                self.end_headers()
                try:
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client went away; nothing to salvage

            def _begin_trace(self):
                """Inbound trace context, or a gateway-minted one when
                tracing is on — the gateway is the fleet's front door,
                so every request that crosses it gets a trace id."""
                raw = self.headers.get(tracing.TRACE_HEADER)
                ctx = tracing.extract(raw) if raw else None
                if ctx is None and tracing.enabled():
                    ctx = tracing.mint()
                self._trace_id = ctx.trace_id if ctx else None
                return ctx

            def do_POST(self):
                self._begin_trace()
                doc = json.dumps({"error": "gateway is read-only",
                                  "status": 405}).encode()
                self._reply(405, doc)

            def do_GET(self):
                metrics.incr_counter("gateway_requests_total")
                ctx = self._begin_trace()
                try:
                    if self.path == "/status":
                        self._reply(200, gw._status_doc())
                        return
                    if self.path == "/healthz":
                        self._reply(200, b'{"ok": true}')
                        return
                    if self.path == "/readyz":
                        status, doc = gw._readyz_doc()
                        self._reply(status, doc)
                        return
                    if self.path.split("?")[0] == "/debug/flight":
                        self._reply(200, gw._flight_doc())
                        return
                    status, body, backend = gw.route(
                        self.path,
                        deadline_ms=self.headers.get("X-Deadline-Ms"),
                        ctx=ctx)
                    self._reply(status, body, backend=backend)
                except Exception as e:  # noqa: BLE001 — a routing
                    # failure (no backends, armed error rule, every
                    # candidate down) is an unavailability answer,
                    # never a stack trace on the wire
                    doc = json.dumps({"error": "gateway_unavailable",
                                      "reason": str(e),
                                      "status": 503}).encode()
                    self._reply(503, doc)

        class _Server(http.server.ThreadingHTTPServer):
            # match rpc.py: admission control belongs to each
            # backend's dispatcher queue, not the kernel backlog
            request_queue_size = 128

        self.server = _Server((host, port), Handler)
        self.host = host
        self.port = self.server.server_address[1]
        self._thread: threading.Thread | None = None

    # -- lifecycle ------------------------------------------------------ #

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def add_backend(self, backend: str) -> None:
        self.ring.add(backend)

    def remove_backend(self, backend: str) -> None:
        self.ring.remove(backend)

    # -- routing -------------------------------------------------------- #

    @staticmethod
    def _dah_height(path: str) -> int | None:
        """The height of a cacheable ``/dah/<h>`` path, else None —
        only the exact two-segment form is immutable-cacheable."""
        parts = [p for p in path.split("?")[0].split("/") if p]
        if len(parts) == 2 and parts[0] == "dah":
            try:
                return int(parts[1])
            except ValueError:
                return None
        return None

    @staticmethod
    def _route_key(path: str) -> str:
        """(height, row) routing key as "h:i". `/sample/<h>/<i>/<j>`
        keys on its own row; other height-addressed routes (`/dah/<h>`,
        `/eds/<h>`, `/proof/share/<h>:<s>:<e>`, ...) key on (height, 0)
        so a height's metadata colocates with its row-0 samples; paths
        with no height hash on themselves (stable, arbitrary owner)."""
        parts = [p for p in path.split("?")[0].split("/") if p]
        if len(parts) >= 3 and parts[0] == "sample":
            try:
                return f"{int(parts[1])}:{int(parts[2])}"
            except ValueError:
                return path
        for part in parts[1:2] + parts[2:3]:
            token = part.split(":")[0]
            try:
                return f"{int(token)}:0"
            except ValueError:
                continue
        return path

    def route(self, path: str, deadline_ms: str | None = None,
              ctx=None):
        """Route one GET: pick the key's ring owner, fetch, hedge to
        the next distinct ring position on 503/connection failure.
        Returns (status, body, backend). ``ctx`` is the inbound (or
        gateway-minted) TraceContext; the ``gateway.route`` span roots
        the routing decision under it and every hedge attempt becomes
        a ``gateway.hedge`` child carrying backend/attempt/outcome."""
        dah_height = self._dah_height(path)
        if dah_height is not None:
            with self._dah_lock:
                body = self._dah_cache.get(dah_height)
                if body is not None:
                    self._dah_cache.move_to_end(dah_height)
            if body is not None:
                metrics.incr_counter("gateway_dah_cache_hits_total")
                return 200, body, "cache"
            metrics.incr_counter("gateway_dah_cache_miss_total")
        key = self._route_key(path)
        candidates = self._demote_cooling(self.ring.owners(key))
        with tracing.span("gateway.route", key=key,
                          candidates=len(candidates)) as sp:
            if isinstance(sp, tracing.Span) and ctx is not None:
                sp.trace_id = ctx.trace_id
                sp.set(wire_parent=ctx.span_id)
            faults.fire("gateway.route", key=key,
                        candidates=len(candidates))
            if not candidates:
                raise RuntimeError("no backends on the ring")
            status, body, backend = self.fetch_hedged(
                path, candidates, deadline_ms=deadline_ms, ctx=ctx)
            if dah_height is not None and status == 200:
                with self._dah_lock:
                    self._dah_cache[dah_height] = body
                    self._dah_cache.move_to_end(dah_height)
                    while len(self._dah_cache) > self.DAH_CACHE_CAP:
                        self._dah_cache.popitem(last=False)
            return status, body, backend

    def _demote_cooling(self, candidates: list[str]) -> list[str]:
        """Stable-partition the hedge candidates: backends inside a
        shed-cooldown window go to the BACK of the order (still
        reachable as a last resort — a fleet that is all-cooling must
        still answer), everyone else keeps ring order."""
        now = time.monotonic()
        with self._cooldown_lock:
            if not self._cooldown:
                return candidates
            for b in [b for b, t in self._cooldown.items() if t <= now]:
                del self._cooldown[b]
            cooling = {b for b in candidates
                       if self._cooldown.get(b, 0.0) > now}
        if not cooling:
            return candidates
        return ([b for b in candidates if b not in cooling]
                + [b for b in candidates if b in cooling])

    def _note_cooldown(self, backend: str, retry_after) -> None:
        """Open (or extend) a backend's demotion window from its 503
        `Retry-After` answer; absent/garbled headers get the default
        `cooldown_s`, and every window is capped at `cooldown_max_s`."""
        try:
            window = float(retry_after)
        except (TypeError, ValueError):
            window = self.cooldown_s
        window = max(0.0, min(window, self.cooldown_max_s))
        if window <= 0.0:
            return
        until = time.monotonic() + window
        opened = False
        with self._cooldown_lock:
            if self._cooldown.get(backend, 0.0) < until:
                opened = backend not in self._cooldown or \
                    self._cooldown[backend] <= time.monotonic()
                self._cooldown[backend] = until
        if opened:
            metrics.incr_counter("gateway_backend_cooldown_total")

    def fetch_hedged(self, path: str, candidates: list[str],
                     deadline_ms: str | None = None, ctx=None):
        """Try candidates in order; hop on 503 (shed) or connection
        failure, pass every other status through as the backend's
        answer. The ring lock is NOT held here — candidates are a
        snapshot. Each attempt (including the first) opens a
        ``gateway.hedge`` span whose WIRE id is injected as the
        backend's ``X-Trace-Context`` parent, so the backend's
        handler span parents under exactly the attempt that reached
        it; with tracing off the inbound context passes through
        untouched."""
        last_shed = None
        last_err: Exception | None = None
        for attempt, backend in enumerate(candidates):
            if attempt:
                faults.fire("gateway.hedge", backend=backend,
                            attempt=attempt)
                metrics.incr_counter("gateway_hedge_total")
            with tracing.span("gateway.hedge", backend=backend,
                              attempt=attempt) as hsp:
                header = None
                if isinstance(hsp, tracing.Span):
                    if ctx is not None:
                        hsp.trace_id = ctx.trace_id
                    if hsp.trace_id:
                        header = tracing.header_value(
                            hsp.trace_id, tracing.wire_span_id(hsp))
                if header is None and ctx is not None:
                    header = ctx.header_value()
                req = urllib.request.Request(backend + path)
                if deadline_ms:
                    req.add_header("X-Deadline-Ms", str(deadline_ms))
                if header:
                    req.add_header(tracing.TRACE_HEADER, header)
                try:
                    with urllib.request.urlopen(
                            req, timeout=self.timeout_s) as resp:
                        hsp.set(outcome="served", status=resp.status)
                        return resp.status, resp.read(), backend
                except urllib.error.HTTPError as e:
                    body = e.read()
                    if e.code == 503:
                        # a shed is load placement gone wrong — exactly
                        # what the hedge exists for. Honor the shed's
                        # Retry-After: demote this backend in the
                        # candidate order until the window passes.
                        metrics.incr_counter(
                            "gateway_backend_error_total",
                            backend=backend)
                        self._note_cooldown(
                            backend,
                            e.headers.get("Retry-After")
                            if e.headers else None)
                        hsp.set(outcome="shed", status=e.code)
                        last_shed = (e.code, body, backend)
                        continue
                    hsp.set(outcome="served", status=e.code)
                    return e.code, body, backend  # backend's real answer
                except (urllib.error.URLError, OSError,
                        TimeoutError) as e:
                    metrics.incr_counter("gateway_backend_error_total",
                                         backend=backend)
                    hsp.set(outcome="connect_fail", error=str(e))
                    last_err = e
                    continue
        if last_shed is not None:
            return last_shed  # every candidate shed: surface the 503
        raise ConnectionError(
            f"every backend failed for {path}: {last_err}")

    # -- aggregation ---------------------------------------------------- #

    def _backend_doc(self, backend: str, path: str,
                     timeout: float | None = None):
        """One backend's own document. Aggregation callers pass the
        short `status_timeout_s` so one dead process costs a quick
        connect failure, not the full routing timeout per member."""
        try:
            with urllib.request.urlopen(
                    backend + path,
                    timeout=self.timeout_s if timeout is None
                    else timeout) as resp:
                return resp.status, json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read() or b"{}")
            except (ValueError, OSError):
                return e.code, {"error": f"http {e.code}"}
        except Exception as e:  # noqa: BLE001 — a dead backend is data
            return None, {"error": str(e)}

    def _status_doc(self) -> bytes:
        backends = self.ring.backends()
        per = {}
        for backend in backends:
            status, doc = self._backend_doc(
                backend, "/status", timeout=self.status_timeout_s)
            if status is None:
                # unreachable member: report it, don't stall on it
                per[backend] = {"state": "down",
                                "error": doc.get("error")}
            else:
                per[backend] = doc
        heights = [d.get("height") for d in per.values()
                   if isinstance(d.get("height"), int)]
        down = [b for b, d in per.items() if d.get("state") == "down"]
        return json.dumps({
            # the MIN backend height: the head every ring member can
            # serve — what a prober/light client should sample so a
            # just-produced height doesn't race the slower replicas
            "height": min(heights) if heights else 0,
            "gateway": {
                "url": self.url,
                "backends": backends,
                "ring_backends": len(self.ring),
                "down_backends": down,
            },
            "backends": per,
        }).encode()

    def _flight_doc(self) -> bytes:
        """Fleet flight view (ADR-022): the gateway's own flight ring
        plus every backend's `/debug/flight`, merged and grouped by
        trace id — the post-incident "which backends did this request
        touch" answer without shipping trace files anywhere. Spans
        with no trace id (tracing off, or internal work) are counted
        but not shipped."""
        per_source: dict[str, list[dict]] = {"gateway": tracing.flight()}
        for backend in self.ring.backends():
            _status, doc = self._backend_doc(
                backend, "/debug/flight", timeout=self.status_timeout_s)
            spans = doc.get("spans") if isinstance(doc, dict) else None
            per_source[backend] = spans if isinstance(spans, list) else []
        by_trace: dict[str, list[dict]] = {}
        untraced = 0
        for source, spans in per_source.items():
            for span in spans:
                if not isinstance(span, dict):
                    continue
                tid = span.get("trace_id")
                if not tid:
                    untraced += 1
                    continue
                rec = dict(span)
                rec["source"] = source
                by_trace.setdefault(tid, []).append(rec)
        return json.dumps({
            "enabled": tracing.enabled(),
            "sources": {s: len(v) for s, v in per_source.items()},
            "traces": by_trace,
            "untraced_spans": untraced,
        }).encode()

    def _readyz_doc(self):
        backends = self.ring.backends()
        ready = []
        for backend in backends:
            status, _doc = self._backend_doc(
                backend, "/readyz", timeout=self.status_timeout_s)
            if status == 200:
                ready.append(backend)
        doc = json.dumps({
            "ready": bool(ready),
            "ready_backends": len(ready),
            "backends": len(backends),
        }).encode()
        return (200 if ready else 503), doc
