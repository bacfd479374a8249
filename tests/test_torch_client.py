"""The port's RPC clients (``celestia_tpu_torch/node/client.py``) and
``RemoteLightClientRelayer`` (``testutil/ibc.py``) against the JAX
package's, on the CPU.

- Every ``RpcClient`` method, through the port's client and the JAX client,
  against a JAX server and a port server over twin nodes: equal answers.
- ``FraudAwareLightClient`` accepts, rescreens and samples (every proof
  verified against the DAH) like the JAX client; a withheld sample is
  ``Unavailable``.
- A port ``MaliciousApp`` node commits a bad encoding; an honest port node
  proves it from the served square and serves the proof: both packages'
  light clients raise ``FraudDetected`` at that height.
- The circuit breaker fast-fails with ``CircuitOpenError``.
- ``RemoteLightClientRelayer`` relays a voucher home over the public API of
  port nodes (HTTP and gRPC) as the JAX relayer does over JAX nodes.
"""

import json
import random
import socket

import numpy as np
import pytest

from celestia_tpu.node import client as jclient
from celestia_tpu.node.node import tx_hash
from celestia_tpu.node.rpc import RpcServer as JServer
from celestia_tpu.x.transfer import MsgTransfer
from celestia_tpu_torch.node import client as pclient
from celestia_tpu_torch.node.rpc import RpcServer as PServer

from test_torch_node_blocks import ADDR, Twins, pfb, send
from test_torch_rpc import NS, signed
from test_torch_network import ALICE, ALICE_SECRET, CHAIN as BEFP_CHAIN, mod
from test_torch_network import pfb as net_pfb


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tw = Twins(tmp_path_factory.mktemp("client"), backend="gpu")
    for node in (tw.jax, tw.port, tw.src):
        node.app.ibc.open_channel("transfer", "channel-0", "transfer", "channel-0")
        node.app.store.commit_hash_refresh()
    tw.produce(15.0)
    transfer = signed("carol", 0, [MsgTransfer("transfer", "channel-0", "utia", 2_500,
                                               ADDR["carol"], "cosmos1receiver")])
    for raw in (send("alice", 0, 1_000), pfb("bob", 0, [700, 1500], 5), transfer):
        assert tw.broadcast(raw).code == 0
    tw.produce(30.0)
    servers = {"jax": JServer(tw.jax, port=0), "port": PServer(tw.port, port=0)}
    for srv in servers.values():
        srv.start()
    try:
        yield tw, {name: f"http://127.0.0.1:{srv.port}" for name, srv in servers.items()}
    finally:
        for srv in servers.values():
            srv.stop()


def _plain(value):
    """A client answer as comparable JSON (dataclasses and proofs by their
    wire forms)."""
    if isinstance(value, (pclient.BroadcastResult, jclient.BroadcastResult)):
        return {"code": value.code, "log": value.log, "priority": value.priority}
    if isinstance(value, list):
        return [_plain(v) for v in value]
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if hasattr(value, "to_json"):
        return value.to_json()
    if hasattr(value, "marshal"):
        out = value.marshal()
        return out.hex() if isinstance(out, bytes) else out
    if isinstance(value, bytes):
        return value.hex()
    return value


def _store_key(tw) -> bytes:
    return sorted(tw.port.app.store._data)[3]


# every RpcClient method, as (twin nodes, client) -> answer
CALLS = {
    # the signatures are not reproducible: the hash of the bytes broadcast
    "get_tx": lambda tw, c: c.get_tx(tx_hash(tw.seen_txs[0])),
    "get_tx_missing": lambda tw, c: c.get_tx(b"\x00" * 32),
    "account": lambda tw, c: c.account(ADDR["alice"]),
    "account_missing": lambda tw, c: c.account("cosmos1nobody"),
    # the clock, the homes and the backends' names (gpu here, native in JAX)
    # differ by record; test_torch_rpc.py holds the rest
    "status": lambda tw, c: {k: v for k, v in c.status().items()
                             if k not in ("uptime_s", "store", "eds_cache")
                             and "pu_" not in k and not k.startswith("extend_backend")},
    "block": lambda tw, c: c.block(2),
    "block_missing": lambda tw, c: c.block(99),
    "balance": lambda tw, c: c.balance(ADDR["bob"]),
    "balance_missing": lambda tw, c: c.balance("cosmos1nobody"),
    "params": lambda tw, c: c.params("blob"),
    "namespace_data": lambda tw, c: c.namespace_data(2, bytes.fromhex(NS)),
    "header": lambda tw, c: c.header(2),
    "dah": lambda tw, c: c.dah(2),
    "eds": lambda tw, c: c.eds(2),
    "sample": lambda tw, c: c.sample(2, 3, 2),
    "befp_missing": lambda tw, c: c.befp(2),
    "snapshot": lambda tw, c: c.snapshot(),
    "state_proof": lambda tw, c: c.state_proof(_store_key(tw)),
    "ibc_header": lambda tw, c: c.ibc_header(),
    "ibc_pending_packets": lambda tw, c: c.ibc_pending_packets("transfer", "channel-0"),
    "ibc_ack_missing": lambda tw, c: c.ibc_ack("transfer", "channel-0", 1),
    "broadcast_tx_refused": lambda tw, c: c.broadcast_tx(b"\x01\x02\x03"),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_every_client_method_answers_like_jax(served, call):
    """The port's client against both servers, and the JAX client against
    the JAX server: one answer."""
    tw, bases = served
    want = _plain(CALLS[call](tw, jclient.RpcClient(bases["jax"])))
    for base in bases.values():
        assert _plain(CALLS[call](tw, pclient.RpcClient(base))) == want, (call, base)
    if call.endswith("_missing"):
        assert want in (None, 0)
    elif call != "broadcast_tx_refused":
        assert want not in (None, 0, [], {}), call


def test_the_light_client_accepts_rescreens_and_samples_like_jax(served):
    tw, bases = served
    out = {}
    for name, cmod in (("port", pclient), ("jax", jclient)):
        prim = cmod.RpcClient(bases[name])
        tower = cmod.RpcClient(bases["jax" if name == "port" else "port"])
        lc = cmod.FraudAwareLightClient([cmod.RpcClient("http://127.0.0.1:9", retries=0), prim],
                                        [tower])
        headers = [lc.accept_header(h) for h in (1, 2, 99)]
        lc.rescreen()
        lc.rescreen(window=1)
        das = lc.sample_availability(2, n=12, rng=random.Random(4))
        with pytest.raises(ValueError):
            lc.sample_availability(99)
        out[name] = (headers, sorted(lc.headers), das, lc.primary.base_url == bases[name])
    assert out["port"] == out["jax"]
    assert out["port"][2] == {"sampled": 12, "confidence": 1.0 - 0.5 ** 12}
    assert out["port"][1] == [1, 2] and out["port"][3]


def test_a_withheld_or_forged_sample_is_unavailable(served):
    tw, bases = served

    class Withholding(pclient.RpcClient):
        def sample(self, height, row, col):
            return None

    class Forging(pclient.RpcClient):
        def sample(self, height, row, col):
            doc = super().sample(height, row, col)
            share = bytearray.fromhex(doc["share"])
            share[-1] ^= 1
            return {**doc, "share": share.hex()}

    for cls in (Withholding, Forging):
        lc = pclient.FraudAwareLightClient(cls(bases["port"]), [])
        lc.accept_header(2)
        with pytest.raises(pclient.Unavailable, match="sample"):
            lc.sample_availability(2, n=4, rng=random.Random(1))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_circuit_breaker_opens_after_a_failure_streak():
    from celestia_tpu_torch.telemetry import metrics

    client = pclient.RpcClient(f"http://127.0.0.1:{_free_port()}", timeout=1.0, retries=1,
                               backoff_base=0.0, breaker_threshold=3, breaker_cooldown=60.0)
    opened = metrics.get_counter("rpc_breaker_open_total")
    with pytest.raises(pclient.TransportError) as first:
        client.status()
    assert not isinstance(first.value, pclient.CircuitOpenError)
    with pytest.raises(pclient.TransportError):
        client.status()  # the third failure opens the breaker
    with pytest.raises(pclient.CircuitOpenError, match="circuit open"):
        client.status()
    assert metrics.get_counter("rpc_breaker_open_total") == opened + 1


# ---- a bad encoding, proven and served


def _attacker_and_tower(tmp_path):
    """A port MaliciousApp node that committed a bad encoding at height 2,
    and a read-only port node that proved it from the served square."""
    from celestia_tpu_torch.da import DataAvailabilityHeader
    from celestia_tpu_torch.da import fraud
    from celestia_tpu_torch.node import Node
    from celestia_tpu_torch.testutil.malicious import BehaviorConfig, MaliciousApp

    app = MaliciousApp(chain_id=BEFP_CHAIN, behavior=BehaviorConfig(corrupt_extension=True),
                       device="cpu", extend_backend="gpu")
    app.init_chain({ALICE.bech32_address(): 10**10}, genesis_time=0.0)
    attacker = Node(app, home=str(tmp_path / "attacker"))
    attacker.produce_block(15.0)
    assert attacker.broadcast_tx(net_pfb(BEFP_CHAIN, ALICE_SECRET, 0, 0, 5_000, b"befp", 3)).code == 0
    attacker.produce_block(30.0)
    tower = Node(device="cpu")
    return attacker, tower, DataAvailabilityHeader, fraud


def test_a_proven_bad_encoding_raises_fraud_detected_in_both_light_clients(tmp_path):
    attacker, tower, Dah, fraud = _attacker_and_tower(tmp_path)
    servers = [PServer(attacker, port=0), PServer(tower, port=0)]
    for srv in servers:
        srv.start()
    try:
        a_url, t_url = (f"http://127.0.0.1:{srv.port}" for srv in servers)
        # the watchtower: the served square and DAH, proven on the host
        served = pclient.RpcClient(a_url)
        doc = served.eds(2)
        w = doc["width"]
        eds = np.stack([np.frombuffer(bytes.fromhex(r), np.uint8).reshape(w, -1)
                        for r in doc["rows"]])
        dah = Dah.from_json(served.dah(2))
        proof = fraud.find_befp(eds)
        assert proof is not None and fraud.verify_befp(proof, dah)
        wire = {"height": 2, "dah": dah.to_json(), "proof": proof.to_json()}
        assert tower.add_fraud_proof(2, dah.hash(), wire)
        for cmod in (pclient, jclient):
            lc = cmod.FraudAwareLightClient(cmod.RpcClient(a_url), [cmod.RpcClient(t_url)])
            assert lc.accept_header(1)["height"] == 1
            with pytest.raises(cmod.FraudDetected, match="erasure code") as err:
                lc.accept_header(2)
            assert err.value.height == 2 and sorted(lc.headers) == [1]
            # sampling checks availability, not the encoding: it passes
            lc2 = cmod.FraudAwareLightClient(cmod.RpcClient(a_url), [])
            lc2.accept_header(2)
            assert lc2.sample_availability(2, n=6, rng=random.Random(2))["sampled"] == 6
            # a late proof evicts the header on rescreen
            lc2.watchtowers.append(cmod.RpcClient(t_url))
            with pytest.raises(cmod.FraudDetected):
                lc2.rescreen()
            assert 2 not in lc2.headers
    finally:
        for srv in servers:
            srv.stop()


# ---- the relayer over the public API


def _remote_relay(pkg: str, transport: str) -> dict:
    """tests/test_lightclient.py's remote voucher round trip, in ``pkg``."""
    crypto, ibc = mod(pkg, "crypto"), mod(pkg, "testutil.ibc")
    app_mod, node_mod, user = mod(pkg, "app.app"), mod(pkg, "node.node"), mod(pkg, "user")
    transfer, cmod = mod(pkg, "x.transfer"), mod(pkg, "node.client")
    rpc, grpc_api = mod(pkg, "node.rpc"), mod(pkg, "node.grpc_api")
    keys = {n: crypto.PrivateKey.from_secret(n.encode()) for n in (
        "alice", "bob", "relayer-a", "relayer-b", "val-a1", "val-a2", "val-b1", "val-b2")}
    kwargs = {"device": "cpu", "extend_backend": "native"} if pkg.endswith("torch") else {}

    def chain(chain_id, vals):
        app = app_mod.App(chain_id=chain_id, **kwargs)
        app.init_chain({keys[n].bech32_address(): 10**9 for n in (
            "alice", "bob", "relayer-a", "relayer-b")}, genesis_time=0.0)
        for v in vals:
            ibc.add_consensus_validator(app, keys[v], 10_000_000)
        node = node_mod.Node(app)
        node.produce_block(15.0)
        return node

    node_a, node_b = chain("chain-a", ("val-a1", "val-a2")), chain("chain-b", ("val-b1", "val-b2"))
    ibc.open_client_channel(node_a, node_b)
    alice, bob = keys["alice"].bech32_address(), keys["bob"].bech32_address()
    esc = transfer.escrow_address("transfer", "channel-0")
    voucher = "transfer/channel-0/utia"
    node_a.app.bank.mint(esc, 7_000, "utia")
    node_b.app.bank.mint(bob, 7_000, voucher)
    node_a.app.store.commit_hash_refresh()
    node_b.app.store.commit_hash_refresh()
    if transport == "http":
        servers = [rpc.RpcServer(n, port=0) for n in (node_a, node_b)]
        clients = lambda: [cmod.RpcClient(f"http://127.0.0.1:{s.port}") for s in servers]  # noqa: E731
    else:
        servers = [grpc_api.NodeGrpcServer(n, port=0) for n in (node_a, node_b)]
        clients = lambda: [grpc_api.GrpcClient(f"127.0.0.1:{s.port}") for s in servers]  # noqa: E731
    for s in servers:
        s.start()
    try:
        client_a, client_b = clients()
        res = user.Signer.setup_single(keys["bob"], client_b).submit_tx(
            [transfer.MsgTransfer("transfer", "channel-0", voucher, 7_000, bob, alice)])
        node_b.produce_block(30.0)
        times = {"a": 40.0, "b": 40.0}

        def produce(name, node):
            def go():
                times[name] += 5.0
                node.produce_block(times[name])
            return go

        relayer = ibc.RemoteLightClientRelayer(
            client_a, client_b, keys["relayer-a"], keys["relayer-b"],
            [keys["val-a1"], keys["val-a2"]], [keys["val-b1"], keys["val-b2"]])
        before = client_a.balance(alice)
        delivered = relayer.relay(produce("a", node_a), produce("b", node_b))
        out = {"transfer": (res.code, res.log), "delivered": delivered,
               "gained": client_a.balance(alice) - before, "escrow": node_a.app.bank.get_balance(esc),
               "pending": client_b.ibc_pending_packets("transfer", "channel-0"),
               "heights": (node_a.app.height, node_b.app.height),
               "ack": _plain(client_a.ibc_ack("transfer", "channel-0", 1))}
        if transport == "grpc":
            client_a.close()
            client_b.close()
        return out
    finally:
        for s in servers:
            s.stop()


@pytest.mark.parametrize("transport", ["http", "grpc"])
def test_the_remote_relayer_relays_like_jax(transport):
    if transport == "grpc":
        pytest.importorskip("grpc")
    ours, theirs = (_remote_relay(pkg, transport) for pkg in ("celestia_tpu_torch",
                                                              "celestia_tpu"))
    assert ours == theirs
    assert ours["delivered"] == 1 and ours["gained"] == 7_000 and ours["escrow"] == 0
    assert ours["pending"] == [] and ours["transfer"] == (0, "")
    assert json.dumps(ours["ack"])
