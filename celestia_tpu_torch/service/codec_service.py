"""The codec sidecar on the card (port of the JAX package's
service/codec_service.py): Encode, ExtendAndRoot, Roots and Repair over
whole squares, so a Go node can plug the card's codec behind rsmt2d's
pluggable ``Codec`` interface (reference:
pkg/da/data_availability_header.go:65-75, pkg/appconsts/global_consts.go
DefaultCodec) by generating a client from ``tpu_codec.proto`` and dialing
this server. The package and service names are the JAX package's, so a
client of either speaks to both servers.

``CodecBackend(device=None)`` serves from the card (None means CUDA):

- ``encode``: ``extend.extend_roots_device``, the EDS fetched;
- ``extend_and_root``: the roots-only core (``extend.roots_device``: no EDS
  is assembled or fetched), the DAH hashed on the host
  (``nmt_host.merkle_root``);
- ``roots``: on the host, as in the JAX package;
- ``repair``: ``repair.repair_device``.

``device="cpu"`` is the host backend: the native runtime (``native.py``)
where it builds, else the plain host paths (``da.extend_host``, the plain
roots on the CPU, ``da.repair.repair``). All give the same bytes.

Where the port differs from the JAX package: the device path degrades to
the host only on ``faults.DeviceUnavailable`` and
``integrity.IntegrityError`` (a strike, ``codec_gpu_fallback_total{op}``;
``gpu_strike_limit`` consecutive strikes disable the card stickily,
``codec_gpu_disabled_total``). ``ValueError`` and ``UnrepairableError``
propagate, as in the JAX package; any other exception propagates too (the
server answers INTERNAL), where the JAX package serves it from the host.
``grpc`` is imported only by ``CodecServer``, ``CodecClient`` and
``_handler``: the backend and the wire codecs need no grpc.

Fault sites: ``codec.backend`` fires in the server's handler before the
backend runs; ``codec.call`` in the client before each call goes out.

Run standalone:  python -m celestia_tpu_torch.service.codec_service [--port N] [--cpu]
"""

from __future__ import annotations

import concurrent.futures
import random
import time

import numpy as np

from celestia_tpu_torch import device as device_mod
from celestia_tpu_torch import faults, integrity, tracing
from celestia_tpu_torch.appconsts import SHARE_SIZE
from celestia_tpu_torch.log import logger
from celestia_tpu_torch.service import wire
from celestia_tpu_torch.telemetry import metrics

SERVICE_NAME = "celestia_tpu.codec.v1.TpuCodec"
# squares are large: a k = 128 EDS is 32 MiB, over grpc's 4 MiB default
_MESSAGE_OPTIONS = (
    ("grpc.max_receive_message_length", 64 * 1024 * 1024),
    ("grpc.max_send_message_length", 64 * 1024 * 1024),
)

log = logger("codec_service")


def _host_extend(arr: np.ndarray) -> np.ndarray:
    from celestia_tpu_torch import da, native

    return native.eds_extend(arr) if native.available() else da.extend_host(arr)


def _host_roots(eds: np.ndarray) -> tuple[list[bytes], list[bytes]]:
    from celestia_tpu_torch import native
    from celestia_tpu_torch.ops import extend

    if native.available():
        return native.eds_nmt_roots(eds)
    rows, cols = extend.eds_roots_device(eds, "cpu")
    return [r.tobytes() for r in rows], [c.tobytes() for c in cols]


def _host_repair(eds: np.ndarray, mask: np.ndarray) -> np.ndarray:
    from celestia_tpu_torch import native
    from celestia_tpu_torch.da.repair import repair

    return native.eds_repair(eds, mask) if native.available() else repair(eds, mask, device="cpu")


class CodecBackend:
    """The four codec calls on ``device`` (None means CUDA; "cpu" is the
    host backend). On the card a call that fails with
    ``faults.DeviceUnavailable`` or ``integrity.IntegrityError`` counts a
    strike and is served from the host; ``gpu_strike_limit`` CONSECUTIVE
    strikes turn ``use_gpu`` off for good."""

    def __init__(self, device=None, gpu_strike_limit: int = 3):
        self.device = device_mod.resolve(device)
        self.use_gpu = self.device.type == "cuda"
        self.gpu_strike_limit = gpu_strike_limit
        self._gpu_strikes = 0

    def _gpu(self, op: str, fn, fallback):
        """Run the device path; on a device fault count a strike and serve
        the request from the host, and past the strike limit stay on the
        host."""
        with tracing.span("codec.backend", op=op, backend="gpu") as bspan:
            try:
                out = fn()
            except (faults.DeviceUnavailable, integrity.IntegrityError) as e:
                self._gpu_strikes += 1
                metrics.incr_counter("codec_gpu_fallback_total", op=op)
                log.info("gpu codec call failed; host fallback", op=op, error=str(e),
                         strikes=self._gpu_strikes, limit=self.gpu_strike_limit)
                if self._gpu_strikes >= self.gpu_strike_limit and self.use_gpu:
                    self.use_gpu = False
                    metrics.incr_counter("codec_gpu_disabled_total")
                    log.info("gpu codec disabled; serving from the host",
                             strikes=self._gpu_strikes)
                bspan.set(backend="host", degraded=True, strikes=self._gpu_strikes,
                          disabled=not self.use_gpu, cause=type(e).__name__)
                return fallback()
            self._gpu_strikes = 0  # only CONSECUTIVE failures degrade
            return out

    @staticmethod
    def _to_array(shares: bytes, width: int, share_size: int) -> np.ndarray:
        expect = width * width * share_size
        if len(shares) != expect:
            raise ValueError(f"share buffer is {len(shares)} bytes, expected {expect} "
                             f"({width}x{width}x{share_size})")
        return np.frombuffer(shares, dtype=np.uint8).reshape(width, width, share_size)

    @staticmethod
    def _square_of(shares: bytes, k: int, share_size: int) -> np.ndarray:
        if share_size != SHARE_SIZE:
            raise ValueError(f"shares must be {SHARE_SIZE} bytes, got {share_size}")
        return CodecBackend._to_array(shares, k, share_size)

    def encode(self, k: int, share_size: int, shares: bytes) -> bytes:
        arr = self._square_of(shares, k, share_size)

        def host() -> bytes:
            return _host_extend(arr).tobytes()

        if self.use_gpu:
            def device() -> bytes:
                from celestia_tpu_torch.ops import extend

                eds, _rows, _cols = extend.extend_roots_device(arr, self.device)
                return eds.tobytes()

            return self._gpu("encode", device, host)
        return host()

    def extend_and_root(self, k: int, share_size: int, shares: bytes):
        from celestia_tpu_torch.ops.nmt_host import merkle_root

        arr = self._square_of(shares, k, share_size)

        def host():
            return _host_roots(_host_extend(arr))

        if self.use_gpu:
            def device():
                from celestia_tpu_torch.ops import extend

                rows, cols = extend.roots_device(arr, self.device)
                return [r.tobytes() for r in rows], [c.tobytes() for c in cols]

            row_roots, col_roots = self._gpu("extend_and_root", device, host)
        else:
            row_roots, col_roots = host()
        return row_roots, col_roots, merkle_root(row_roots + col_roots)

    def roots(self, k: int, share_size: int, eds_bytes: bytes):
        from celestia_tpu_torch.ops.nmt_host import merkle_root

        row_roots, col_roots = _host_roots(self._to_array(eds_bytes, 2 * k, share_size))
        return row_roots, col_roots, merkle_root(row_roots + col_roots)

    def repair(self, k: int, share_size: int, eds_bytes: bytes, present: bytes) -> bytes:
        arr = self._to_array(eds_bytes, 2 * k, share_size)
        if len(present) != 4 * k * k:
            raise ValueError(f"presence mask is {len(present)} bytes, expected {4 * k * k}")
        mask = np.frombuffer(present, dtype=np.uint8).reshape(2 * k, 2 * k) != 0

        def host() -> bytes:
            return _host_repair(arr, mask).tobytes()

        if self.use_gpu and share_size == SHARE_SIZE:
            def device() -> bytes:
                from celestia_tpu_torch.ops import repair

                return repair.repair_device(arr, mask, self.device).tobytes()

            return self._gpu("repair", device, host)
        return host()


def _handler(fn, req_cls, method: str = ""):
    """One unary method: raw request bytes in, marshalled response bytes
    out, with the status mapping: ValueError -> INVALID_ARGUMENT, a lost
    backend or transport -> UNAVAILABLE (the status a client retries),
    anything else -> INTERNAL."""
    import grpc

    def handle(request_bytes, context):
        try:
            with tracing.span("codec.rpc", method=method, request_bytes=len(request_bytes)):
                faults.fire("codec.backend")
                return fn(req_cls.unmarshal(request_bytes))
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        except (faults.DeviceUnavailable, faults.TransportFault) as e:
            context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
        except Exception as e:  # noqa: BLE001 — the RPC boundary answers INTERNAL
            log.info("codec RPC failed", method=method, error=f"{type(e).__name__}: {e}")
            context.abort(grpc.StatusCode.INTERNAL, str(e))

    return grpc.unary_unary_rpc_method_handler(
        handle,
        request_deserializer=lambda b: b,  # raw; decoded inside for abort()
        response_serializer=lambda b: b,
    )


def service_methods(backend: CodecBackend) -> dict:
    """The four methods as bytes -> bytes functions over ``backend``:
    unmarshal the request, run the call, marshal the response. The server
    serves them; a caller without grpc drives the same bytes in process."""

    def encode(req: wire.EncodeRequest) -> bytes:
        return wire.EdsResponse(backend.encode(req.k, req.share_size, req.shares)).marshal()

    def extend_and_root(req: wire.EncodeRequest) -> bytes:
        rows, cols, dah = backend.extend_and_root(req.k, req.share_size, req.shares)
        return wire.RootsResponse(rows, cols, dah).marshal()

    def roots(req: wire.EdsRequest) -> bytes:
        rows, cols, dah = backend.roots(req.k, req.share_size, req.eds)
        return wire.RootsResponse(rows, cols, dah).marshal()

    def repair(req: wire.RepairRequest) -> bytes:
        return wire.EdsResponse(
            backend.repair(req.k, req.share_size, req.eds, req.present)).marshal()

    return {
        "Encode": (encode, wire.EncodeRequest),
        "ExtendAndRoot": (extend_and_root, wire.EncodeRequest),
        "Roots": (roots, wire.EdsRequest),
        "Repair": (repair, wire.RepairRequest),
    }


def call_in_process(backend: CodecBackend, method: str, request_bytes: bytes) -> bytes:
    """One method's marshalled request through the server's method body,
    without grpc: the bytes a client would get back."""
    fn, req_cls = service_methods(backend)[method]
    return fn(req_cls.unmarshal(request_bytes))


class CodecServer:
    def __init__(self, port: int = 0, device=None, max_workers: int = 4):
        import grpc

        self.backend = CodecBackend(device)
        self.server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(max_workers=max_workers),
            options=list(_MESSAGE_OPTIONS),
        )
        handlers = {name: _handler(fn, req_cls, method=name)
                    for name, (fn, req_cls) in service_methods(self.backend).items()}
        self.server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),))
        self.port = self.server.add_insecure_port(f"127.0.0.1:{port}")

    def start(self) -> None:
        self.server.start()

    def stop(self, grace: float = 0.5) -> None:
        self.server.stop(grace)


class CodecClient:
    """Python client over the same wire codecs (a Go client uses stubs
    generated from tpu_codec.proto instead).

    Every call carries a deadline (``timeout``, seconds), and UNAVAILABLE or
    DEADLINE_EXCEEDED is retried ``retries`` times with exponential backoff
    and full jitter before the RpcError propagates."""

    def __init__(self, target: str, timeout: float = 5.0, retries: int = 2,
                 backoff_base: float = 0.05):
        import grpc

        self.channel = grpc.insecure_channel(target, options=list(_MESSAGE_OPTIONS))
        self.timeout = timeout
        self.retries = retries
        self.backoff_base = backoff_base

    def _call(self, method: str, request_bytes: bytes) -> bytes:
        import grpc

        retry_codes = (grpc.StatusCode.UNAVAILABLE, grpc.StatusCode.DEADLINE_EXCEEDED)
        fn = self.channel.unary_unary(
            f"/{SERVICE_NAME}/{method}",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        for attempt in range(self.retries + 1):
            with tracing.span("codec.call", method=method, attempt=attempt) as cspan:
                try:
                    corrupt = faults.fire("codec.call", method=method)
                    out = fn(request_bytes, timeout=self.timeout)
                    return corrupt(out) if corrupt is not None else out
                except faults.TransportFault as e:
                    last, code = e, grpc.StatusCode.UNAVAILABLE
                except grpc.RpcError as e:
                    last, code = e, e.code()
                cspan.set(error=code.name)
            if code not in retry_codes or attempt >= self.retries:
                raise last
            metrics.incr_counter("codec_call_retry_total", method=method)
            time.sleep(random.uniform(0.0, self.backoff_base * (2 ** attempt)))
        raise AssertionError("unreachable: the loop returns or raises")

    def encode(self, shares: np.ndarray) -> np.ndarray:
        k, _, share_size = shares.shape
        req = wire.EncodeRequest(k, share_size, np.ascontiguousarray(shares).tobytes())
        resp = wire.EdsResponse.unmarshal(self._call("Encode", req.marshal()))
        return np.frombuffer(resp.eds, dtype=np.uint8).reshape(2 * k, 2 * k, share_size)

    def extend_and_root(self, shares: np.ndarray):
        k, _, share_size = shares.shape
        req = wire.EncodeRequest(k, share_size, np.ascontiguousarray(shares).tobytes())
        resp = wire.RootsResponse.unmarshal(self._call("ExtendAndRoot", req.marshal()))
        return resp.row_roots, resp.col_roots, resp.dah_hash

    def roots(self, eds: np.ndarray):
        width, _, share_size = eds.shape
        req = wire.EdsRequest(width // 2, share_size, np.ascontiguousarray(eds).tobytes())
        resp = wire.RootsResponse.unmarshal(self._call("Roots", req.marshal()))
        return resp.row_roots, resp.col_roots, resp.dah_hash

    def repair(self, eds: np.ndarray, present: np.ndarray) -> np.ndarray:
        width, _, share_size = eds.shape
        req = wire.RepairRequest(
            width // 2, share_size,
            np.ascontiguousarray(eds).tobytes(),
            np.ascontiguousarray(present.astype(np.uint8)).tobytes(),
        )
        resp = wire.EdsResponse.unmarshal(self._call("Repair", req.marshal()))
        return np.frombuffer(resp.eds, dtype=np.uint8).reshape(width, width, share_size)

    def close(self) -> None:
        self.channel.close()


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(prog="gpu-codec-service")
    parser.add_argument("--port", type=int, default=9090)
    parser.add_argument("--cpu", action="store_true", help="serve from the host backend")
    args = parser.parse_args(argv)
    server = CodecServer(port=args.port, device="cpu" if args.cpu else None)
    server.start()
    log.info("codec service listening", port=server.port, gpu=server.backend.use_gpu)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
