"""Node gRPC API — the reference-shaped service boundary (port of the JAX
package's node/grpc_api.py).

The reference serves gRPC + grpc-gateway from the node
(app/app.go:693-719), and its pkg/user Signer dials gRPC with Cosmos
TxRaw bytes (pkg/user/signer.go:287). This module gives the framework's
Node the same face:

- `cosmos.tx.v1beta1.Service/BroadcastTx` + `GetTx` (subset with the
  SDK's field numbers) — external Cosmos tooling can point a generated
  client at this port and submit the byte-compatible TxRaw encodings
  (specs/wire.md).
- `celestia_tpu.node.v1.Node` — account/status/balance/params/state
  proof queries mirroring node/rpc.py's HTTP routes.

`GrpcClient` implements the same transport surface as
node/client.RpcClient (account/status/broadcast_tx/get_tx/balance/
params), so `user.Signer` and `RemoteLightClientRelayer` run over gRPC
unchanged (tests/test_torch_client.py).

Wire codecs are hand-rolled against node_service.proto (the port's own
copy beside this module; the repo's standing pattern, service/wire.py): no
generated code at runtime, full interop for protoc-generated clients.
``grpc`` is imported only by the server and the client classes, so this
module, ``node`` and ``node.rpc`` import on a host without it.
"""

from __future__ import annotations

import concurrent.futures
import json
from typing import TYPE_CHECKING

from celestia_tpu_torch.blob import (
    _field_bytes,
    _field_uint,
    _parse_fields,
)
from celestia_tpu_torch.log import logger
from celestia_tpu_torch.node.node import tx_hash

if TYPE_CHECKING:  # annotation-only
    from celestia_tpu_torch.node.node import Node

log = logger("grpc_api")

NODE_SERVICE = "celestia_tpu.node.v1.Node"
TX_SERVICE = "cosmos.tx.v1beta1.Service"
BROADCAST_MODE_SYNC = 2


def _get_str(raw: bytes, tag: int) -> str:
    for t, wt, val in _parse_fields(raw):
        if t == tag and wt == 2:
            return bytes(val).decode()
    return ""


def _get_bytes(raw: bytes, tag: int) -> bytes:
    for t, wt, val in _parse_fields(raw):
        if t == tag and wt == 2:
            return bytes(val)
    return b""


def _get_uint(raw: bytes, tag: int) -> int:
    for t, wt, val in _parse_fields(raw):
        if t == tag and wt == 0:
            return int(val)
    return 0


# ------------------------------------------------------------------ #
# server


class NodeGrpcServer:
    """Both services on one insecure port (reference: the node's single
    gRPC listener serving every registered SDK service)."""

    def __init__(self, node: Node, port: int = 0, max_workers: int = 4):
        import grpc

        self.node = node
        self.server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(max_workers=max_workers)
        )
        self.server.add_generic_rpc_handlers(
            (self._node_service(), self._tx_service())
        )
        self.port = self.server.add_insecure_port(f"127.0.0.1:{port}")

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self.server.stop(grace=0.5)

    # --- handlers ---

    def _wrap(self, fn):
        import grpc

        def handle(request_bytes, context):
            try:
                return fn(request_bytes)
            except ValueError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            except Exception as e:  # noqa: BLE001 — surfaced as INTERNAL
                log.error("grpc handler failed", error=str(e))
                context.abort(grpc.StatusCode.INTERNAL, str(e))

        return grpc.unary_unary_rpc_method_handler(
            handle,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,
        )

    def _node_service(self):
        import grpc

        node = self.node

        def status(_req: bytes) -> bytes:
            s = node.status()
            return (
                _field_bytes(1, s["chain_id"].encode())
                + _field_uint(2, s["height"])
                + _field_uint(3, s["app_version"])
                + _field_uint(4, s.get("mempool_size", 0))
                # Node.status() doesn't carry the backend (the HTTP route
                # injects it separately) — read it from the app directly
                + _field_bytes(5, str(node.app.extend_backend).encode())
            )

        def account(req: bytes) -> bytes:
            address = _get_str(req, 1)
            acc = node.account(address)
            if acc is None:
                return b""  # found=false (proto3 default)
            return (
                _field_bytes(1, address.encode())
                + _field_uint(2, acc["account_number"])
                + _field_uint(3, acc["sequence"])
                + _field_uint(4, 1)
            )

        def balance(req: bytes) -> bytes:
            address = _get_str(req, 1)
            denom = _get_str(req, 2) or "utia"
            amount = node.app.bank.get_balance(address, denom)
            return _field_uint(1, amount)

        def params(req: bytes) -> bytes:
            module = _get_str(req, 1)
            if module == "blob":
                p = node.app.blob.get_params()
                payload = {
                    "gas_per_blob_byte": p.gas_per_blob_byte,
                    "gov_max_square_size": p.gov_max_square_size,
                }
            else:
                raise ValueError(f"unknown params module {module!r}")
            return _field_bytes(1, json.dumps(payload, sort_keys=True).encode())

        def get_tx(req: bytes) -> bytes:
            found = node.get_tx(_get_bytes(req, 1))
            if found is None:
                return b""
            block, idx = found
            result = block.tx_results[idx]
            return (
                _field_uint(1, 1)
                + _field_uint(2, block.height)
                + (_field_uint(3, idx))
                + _field_uint(4, result.code)
                + _field_bytes(5, result.log.encode())
            )

        def state_proof(req: bytes) -> bytes:
            key = _get_bytes(req, 1)
            # height under the node lock, same atomicity as the HTTP
            # route: a racing commit must not pair H's root with H+1
            with node._lock:
                value, root, proof = node.app.store.query_with_proof(key)
                height = node.app.height
            out = b""
            if value is not None:
                out += _field_bytes(1, value)
            out += _field_bytes(2, root)
            out += _field_bytes(
                3, json.dumps(proof.marshal(), sort_keys=True).encode()
            )
            if value is not None:
                out += _field_uint(4, 1)
            out += _field_uint(5, height)
            return out

        def ibc_header(_req: bytes) -> bytes:
            # assembly + lock-snapshot semantics shared with the HTTP
            # route via Node.ibc_light_client_header (one sign-bytes
            # schema, one source)
            header = node.ibc_light_client_header()
            return _field_bytes(
                1, json.dumps(header.to_json(), sort_keys=True).encode()
            )

        def ibc_packets(req: bytes) -> bytes:
            packets = node.app.ibc.pending_packets(
                _get_str(req, 1), _get_str(req, 2)
            )
            return _field_bytes(
                1,
                json.dumps(
                    [p.to_json() for p in packets], sort_keys=True
                ).encode(),
            )

        def ibc_ack(req: bytes) -> bytes:
            ack = node.app.ibc.get_acknowledgement(
                _get_str(req, 1), _get_str(req, 2), _get_uint(req, 3)
            )
            if ack is None:
                return b""
            return _field_bytes(1, ack.marshal())

        methods = {
            "Status": status,
            "Account": account,
            "Balance": balance,
            "Params": params,
            "GetTx": get_tx,
            "StateProof": state_proof,
            "IbcHeader": ibc_header,
            "IbcPackets": ibc_packets,
            "IbcAck": ibc_ack,
        }
        handlers = {
            name: self._wrap(fn) for name, fn in methods.items()
        }
        return grpc.method_handlers_generic_handler(NODE_SERVICE, handlers)

    def _tx_service(self):
        import grpc

        node = self.node

        def broadcast_tx(req: bytes) -> bytes:
            raw = _get_bytes(req, 1)
            mode = _get_uint(req, 2)
            if mode and mode != BROADCAST_MODE_SYNC:
                raise ValueError(
                    f"unsupported broadcast mode {mode} (only SYNC)"
                )
            res = node.broadcast_tx(raw)
            tx_response = (
                _field_bytes(2, tx_hash(raw).hex().upper().encode())
                + _field_uint(4, res.code)
                + _field_bytes(6, res.log.encode())
            )
            return _field_bytes(1, tx_response)

        def get_tx(req: bytes) -> bytes:
            # cosmos GetTxRequest{string hash = 1} (hex string)
            found = node.get_tx(bytes.fromhex(_get_str(req, 1)))
            if found is None:
                raise ValueError("tx not found")
            block, idx = found
            result = block.tx_results[idx]
            tx_response = (
                _field_uint(1, block.height)
                + _field_uint(4, result.code)
                + _field_bytes(6, result.log.encode())
            )
            # cosmos GetTxResponse{Tx tx = 1, TxResponse tx_response = 2}
            return _field_bytes(1, block.txs[idx]) + _field_bytes(2, tx_response)

        handlers = {
            "BroadcastTx": self._wrap(broadcast_tx),
            "GetTx": self._wrap(get_tx),
        }
        return grpc.method_handlers_generic_handler(TX_SERVICE, handlers)


# ------------------------------------------------------------------ #
# client (the Signer's transport surface, over gRPC)


class GrpcClient:
    """node.client.RpcClient equivalent over the gRPC API. Implements
    the Signer transport surface: account/status/broadcast_tx/get_tx,
    plus balance/params/state_proof."""

    def __init__(self, target: str, timeout: float = 10.0):
        import grpc

        self.target = target
        self.timeout = timeout
        self.channel = grpc.insecure_channel(target)

    def close(self) -> None:
        self.channel.close()

    def _call(self, service: str, method: str, request: bytes) -> bytes:
        fn = self.channel.unary_unary(
            f"/{service}/{method}",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        return fn(request, timeout=self.timeout)

    # --- Signer transport surface ---

    def status(self) -> dict:
        raw = self._call(NODE_SERVICE, "Status", b"")
        return {
            "chain_id": _get_str(raw, 1),
            "height": _get_uint(raw, 2),
            "app_version": _get_uint(raw, 3),
            "mempool_size": _get_uint(raw, 4),
            "extend_backend": _get_str(raw, 5),
        }

    def account(self, address: str):
        raw = self._call(
            NODE_SERVICE, "Account", _field_bytes(1, address.encode())
        )
        if not _get_uint(raw, 4):
            return None
        return {
            "address": _get_str(raw, 1),
            "account_number": _get_uint(raw, 2),
            "sequence": _get_uint(raw, 3),
        }

    def broadcast_tx(self, raw: bytes):
        import grpc

        from celestia_tpu_torch.node.client import BroadcastResult

        req = _field_bytes(1, raw) + _field_uint(2, BROADCAST_MODE_SYNC)
        try:
            resp = self._call(TX_SERVICE, "BroadcastTx", req)
        except grpc.RpcError as e:
            return BroadcastResult(code=1, log=e.details() or str(e))
        tx_response = _get_bytes(resp, 1)
        return BroadcastResult(
            code=_get_uint(tx_response, 4),
            log=_get_str(tx_response, 6),
        )

    def get_tx(self, key: bytes):
        raw = self._call(NODE_SERVICE, "GetTx", _field_bytes(1, key))
        if not _get_uint(raw, 1):
            return None
        return {
            "height": _get_uint(raw, 2),
            "index": _get_uint(raw, 3),
            "result": {
                "code": _get_uint(raw, 4),
                "log": _get_str(raw, 5),
            },
        }

    def balance(self, address: str, denom: str = "utia") -> int:
        req = _field_bytes(1, address.encode()) + _field_bytes(2, denom.encode())
        return _get_uint(self._call(NODE_SERVICE, "Balance", req), 1)

    def params(self, module: str) -> dict:
        raw = self._call(
            NODE_SERVICE, "Params", _field_bytes(1, module.encode())
        )
        return json.loads(_get_str(raw, 1))

    def state_proof(self, key: bytes) -> dict:
        """(value|None, app_hash, smt.Proof, height) — verifiable
        against the returned root with StateStore.verify_proof; the
        (proof, height) pair is one node-lock snapshot."""
        from celestia_tpu_torch import smt as smt_mod

        raw = self._call(NODE_SERVICE, "StateProof", _field_bytes(1, key))
        value = _get_bytes(raw, 1) if _get_uint(raw, 4) else None
        return {
            "value": value,
            "app_hash": _get_bytes(raw, 2),
            "height": _get_uint(raw, 5),
            "proof": smt_mod.Proof.unmarshal(json.loads(_get_str(raw, 3))),
        }

    # --- IBC relayer surface (mirrors RpcClient's, so the SAME
    # RemoteLightClientRelayer runs over either transport) ---

    def ibc_header(self):
        from celestia_tpu_torch.x.lightclient import Header

        raw = self._call(NODE_SERVICE, "IbcHeader", b"")
        return Header.from_json(json.loads(_get_str(raw, 1)))

    def ibc_pending_packets(self, port_id: str, channel_id: str) -> list:
        from celestia_tpu_torch.x.ibc import Packet

        req = _field_bytes(1, port_id.encode()) + _field_bytes(
            2, channel_id.encode()
        )
        raw = self._call(NODE_SERVICE, "IbcPackets", req)
        return [Packet.from_json(p) for p in json.loads(_get_str(raw, 1))]

    def ibc_ack(self, port_id: str, channel_id: str, seq: int):
        from celestia_tpu_torch.x.ibc import Acknowledgement

        req = (
            _field_bytes(1, port_id.encode())
            + _field_bytes(2, channel_id.encode())
            + _field_uint(3, seq)
        )
        raw = self._call(NODE_SERVICE, "IbcAck", req)
        if not raw:
            return None
        return Acknowledgement.unmarshal(_get_bytes(raw, 1))

    def cosmos_get_tx(self, key: bytes) -> dict:
        """The cosmos.tx.v1beta1.Service/GetTx spelling (hex-string
        hash), returning the raw tx bytes + response subset."""
        raw = self._call(
            TX_SERVICE, "GetTx", _field_bytes(1, key.hex().encode())
        )
        tx_response = _get_bytes(raw, 2)
        return {
            "tx_bytes": _get_bytes(raw, 1),
            "height": _get_uint(tx_response, 1),
            "code": _get_uint(tx_response, 4),
            "log": _get_str(tx_response, 6),
        }
