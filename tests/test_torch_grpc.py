"""The port's gRPC API (``celestia_tpu_torch/node/grpc_api.py``, its own
``node_service.proto``) against the JAX package's, on the CPU.

A JAX ``NodeGrpcServer`` and a port one serve twin nodes
(``test_torch_node_blocks.Twins``); the port's ``GrpcClient`` against both
servers and the JAX client against the JAX server give the same replies,
method by method, and the same status codes for a refused request. The
proto file is the JAX package's contract, package and service names
included.
"""

import pathlib

import pytest

grpc = pytest.importorskip("grpc")

from celestia_tpu.node import grpc_api as jgrpc  # noqa: E402
from celestia_tpu.node.node import tx_hash  # noqa: E402
from celestia_tpu_torch.node import grpc_api as pgrpc  # noqa: E402

from test_torch_client import _plain  # noqa: E402
from test_torch_node_blocks import ADDR, Twins, pfb, send  # noqa: E402


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tw = Twins(tmp_path_factory.mktemp("grpc"), backend="native")
    for node in (tw.jax, tw.port, tw.src):
        node.app.ibc.open_channel("transfer", "channel-0", "transfer", "channel-0")
        node.app.store.commit_hash_refresh()
    tw.produce(15.0)
    for raw in (send("alice", 0, 1_000), pfb("bob", 0, [700, 1500], 5)):
        assert tw.broadcast(raw).code == 0
    tw.produce(30.0)
    servers = {"jax": jgrpc.NodeGrpcServer(tw.jax), "port": pgrpc.NodeGrpcServer(tw.port)}
    for srv in servers.values():
        srv.start()
    clients = {"jax": [jgrpc.GrpcClient(f"127.0.0.1:{servers['jax'].port}")],
               "port": [pgrpc.GrpcClient(f"127.0.0.1:{srv.port}") for srv in servers.values()]}
    try:
        yield tw, clients
    finally:
        for cs in clients.values():
            for c in cs:
                c.close()
        for srv in servers.values():
            srv.stop()


def _sent(tw) -> bytes:
    return tx_hash(tw.seen_txs[0])  # the signatures are not reproducible


# every GrpcClient method, as (twin nodes, client) -> reply
CALLS = {
    "status": lambda tw, c: {k: v for k, v in c.status().items() if k != "extend_backend"},
    "account": lambda tw, c: c.account(ADDR["alice"]),
    "account_missing": lambda tw, c: c.account("cosmos1nobody"),
    "balance": lambda tw, c: c.balance(ADDR["bob"]),
    "balance_denom": lambda tw, c: c.balance(ADDR["bob"], "nope"),
    "params": lambda tw, c: c.params("blob"),
    "get_tx": lambda tw, c: c.get_tx(_sent(tw)),
    "get_tx_missing": lambda tw, c: c.get_tx(b"\x00" * 32),
    "cosmos_get_tx": lambda tw, c: c.cosmos_get_tx(_sent(tw)),
    "state_proof": lambda tw, c: c.state_proof(sorted(tw.port.app.store._data)[2]),
    "state_proof_absent": lambda tw, c: c.state_proof(b"no-such-key"),
    "ibc_header": lambda tw, c: c.ibc_header(),
    "ibc_pending_packets": lambda tw, c: c.ibc_pending_packets("transfer", "channel-0"),
    "ibc_ack_missing": lambda tw, c: c.ibc_ack("transfer", "channel-0", 1),
    "broadcast_tx_refused": lambda tw, c: c.broadcast_tx(b"\x01\x02\x03"),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_every_method_replies_like_jax(served, call):
    tw, clients = served
    want = _plain(CALLS[call](tw, clients["jax"][0]))
    for client in clients["port"]:
        assert _plain(CALLS[call](tw, client)) == want, call


def test_the_backend_field_is_the_apps(served):
    _tw, clients = served
    assert clients["port"][1].status()["extend_backend"] == "native"
    assert clients["port"][0].status()["extend_backend"] == "native"


@pytest.mark.parametrize("call,code", [
    (lambda c: c.params("nope"), "INVALID_ARGUMENT"),
    (lambda c: c.cosmos_get_tx(b"\x00" * 32), "INVALID_ARGUMENT"),
    (lambda c: c._call(pgrpc.TX_SERVICE, "BroadcastTx",
                       pgrpc._field_bytes(1, b"\x01") + pgrpc._field_uint(2, 1)), "INVALID_ARGUMENT"),
    (lambda c: c._call(pgrpc.NODE_SERVICE, "NoSuchMethod", b""), "UNIMPLEMENTED"),
], ids=["unknown_params", "unknown_tx", "async_broadcast", "unknown_method"])
def test_a_refused_request_has_the_jax_status_code(served, call, code):
    _tw, clients = served
    got = []
    for client in (clients["jax"][0], *clients["port"]):
        with pytest.raises(grpc.RpcError) as err:
            call(client)
        got.append((err.value.code().name, err.value.details()))
    assert got[0][0] == code and got[1:] == [got[0]] * 2


def test_a_broadcast_commits_through_either_server(served):
    """A fresh tx over gRPC is admitted by both nodes alike."""
    tw, clients = served
    raw = send("alice", 1, 500)
    ours, theirs = clients["port"][1].broadcast_tx(raw), clients["jax"][0].broadcast_tx(raw)
    assert (ours.code, ours.log) == (theirs.code, theirs.log) == (0, "")
    assert len(tw.port.mempool) == len(tw.jax.mempool) == 1


def test_the_proto_is_the_jax_contract():
    ours = pathlib.Path(pgrpc.__file__).with_name("node_service.proto").read_text()
    theirs = pathlib.Path(jgrpc.__file__).with_name("node_service.proto").read_text()
    body = ours[ours.index("syntax = "):]
    assert body == theirs[theirs.index("syntax = "):]
    assert "package celestia_tpu.node.v1;" in body
    assert pgrpc.NODE_SERVICE == jgrpc.NODE_SERVICE and pgrpc.TX_SERVICE == jgrpc.TX_SERVICE
