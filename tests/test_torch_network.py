"""The port's test harnesses (``testutil/network.py``, ``testutil/malicious.py``,
``testutil/ibc.py``) against the JAX package's, on the CPU.

Each scenario runs once over each package (chosen by its module prefix),
fed the same raw tx bytes where it signs them itself: ``Network``'s
replicas agree and rotate proposers and refuse an out-of-order square, with
the JAX network's blocks and app hashes; a ``MaliciousApp`` that corrupts
its extension commits the JAX attacker's block, its port Node serves the
published square, and ``da.fraud.find_befp`` proves the JAX package's
BEFP; ``LightClientRelayer``'s handshake, relays and timeout over port
nodes leave the channel, connection, packet and balance state of the JAX
run. The relayers and signers sign with each package's own keys, so state
written from signatures (the light clients') is left out of the comparison.
"""

import functools
import importlib
import json

import numpy as np
import pytest

from celestia_tpu import blob as jblob
from celestia_tpu import namespace as jns
from celestia_tpu.crypto import PrivateKey as JKey
from celestia_tpu.tx import Fee, sign_tx
from celestia_tpu.x.blob.types import estimate_gas, new_msg_pay_for_blobs

PACKAGES = ("celestia_tpu", "celestia_tpu_torch")
APP_KWARGS = {"celestia_tpu": {"extend_backend": "native"},
              "celestia_tpu_torch": {"device": "cpu", "extend_backend": "native"}}
NET_SECRETS = [f"net-{i}".encode() for i in range(3)]
NET_KEYS = [JKey.from_secret(secret) for secret in NET_SECRETS]
NET_GENESIS = {k.bech32_address(): 10**10 for k in NET_KEYS}


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@functools.lru_cache(maxsize=None)
def pfb(chain: str, secret: bytes, account: int, seq: int, size: int, sub_id: bytes,
        seed: int) -> bytes:
    """A PFB signed by the key of ``secret``, signed once: the JAX package's
    signatures take a random nonce, so both packages must get the bytes of
    one signing."""
    key = JKey.from_secret(secret)
    blob = jblob.new_blob(jns.new_v0(sub_id),
                          np.random.default_rng(seed).integers(0, 256, size, np.uint8).tobytes(),
                          0)
    gas = estimate_gas([size])
    tx = sign_tx(key, [new_msg_pay_for_blobs(key.bech32_address(), blob)], chain, account, seq,
                 Fee(amount=gas, gas_limit=gas))
    return jblob.marshal_blob_tx(tx.marshal(), [blob])


def _committed(net) -> list:
    return [(b.height, b.proposer, b.accept_votes, b.app_hash.hex(), b.block.hash.hex(),
             b.block.square_size, len(b.block.txs)) for b in net.committed]


# ---- Network

def _replicas(pkg: str) -> list:
    network, app_mod = mod(pkg, "testutil.network"), mod(pkg, "app.app")
    chain = app_mod.GENESIS_CHAIN_ID
    net = network.Network(4, NET_GENESIS,
                          make_app=lambda i: app_mod.App(**APP_KWARGS[pkg]))
    net.produce_block()  # the empty first block
    for i in range(3):
        block = net.produce_block([pfb(chain, NET_SECRETS[0], 0, i, 1000 + 500 * i, b"net-test", i)])
        assert block.accept_votes == 4
    assert net.height == 4
    assert len({app.store.app_hashes[app.store.version] for app in net.apps}) == 1
    return _committed(net)


def test_network_replicas_agree_like_jax():
    ours, theirs = (_replicas(pkg) for pkg in reversed(PACKAGES))
    assert ours == theirs
    assert [b[1] for b in ours] == [0, 1, 2, 3]  # round-robin proposers


def test_network_proposers_rotate_like_jax():
    out = []
    for pkg in PACKAGES:
        network, app_mod = mod(pkg, "testutil.network"), mod(pkg, "app.app")
        net = network.Network(3, NET_GENESIS, make_app=lambda i: app_mod.App(**APP_KWARGS[pkg]))
        for _ in range(4):
            net.produce_block()
        out.append(_committed(net))
    assert out[0] == out[1] and [b[1] for b in out[1]] == [0, 1, 2, 0]


def test_an_out_of_order_square_is_rejected_like_jax():
    messages = []
    for pkg in PACKAGES:
        network, app_mod = mod(pkg, "testutil.network"), mod(pkg, "app.app")
        malicious = mod(pkg, "testutil.malicious")

        def make_app(i):
            if i == 0:
                return malicious.MaliciousApp(
                    behavior=malicious.BehaviorConfig(out_of_order_blobs=True),
                    **APP_KWARGS[pkg])
            return app_mod.App(**APP_KWARGS[pkg])

        net = network.Network(4, NET_GENESIS, make_app=make_app)
        net.produce_block(proposer=1)  # an empty first block from an honest node
        chain = app_mod.GENESIS_CHAIN_ID
        tx1 = pfb(chain, NET_SECRETS[0], 0, 0, 600, b"zzzz", 1)
        tx2 = pfb(chain, NET_SECRETS[1], 1, 0, 600, b"aaaa", 2)
        with pytest.raises(network.ConsensusFailure, match="votes") as err:
            net.produce_block([tx1, tx2], proposer=0)
        messages.append(str(err.value))
        # honest proposers still commit the same txs
        block = net.produce_block([tx1, tx2], proposer=1)
        assert block.accept_votes == 4
        messages.append(_committed(net))
    assert messages[:2] == messages[2:]


# ---- MaliciousApp: a corrupted extension

CHAIN = "befp-test"
ALICE_SECRET = b"befp-alice"
ALICE = JKey.from_secret(ALICE_SECRET)


def _attacker(pkg: str, tmp_path):
    malicious, node_mod = mod(pkg, "testutil.malicious"), mod(pkg, "node.node")
    kwargs = dict(APP_KWARGS[pkg])
    if pkg == "celestia_tpu_torch":
        kwargs["extend_backend"] = "gpu"  # the device entries' plain versions
    app = malicious.MaliciousApp(chain_id=CHAIN,
                                 behavior=malicious.BehaviorConfig(corrupt_extension=True),
                                 **kwargs)
    app.init_chain({ALICE.bech32_address(): 10**10}, genesis_time=0.0)
    node = node_mod.Node(app, home=str(tmp_path / pkg))
    node.produce_block(15.0)
    assert node.broadcast_tx(pfb(CHAIN, ALICE_SECRET, 0, 0, 5_000, b"befp", 3)).code == 0
    block = node.produce_block(30.0)
    return node, block


def test_a_corrupted_extension_is_served_and_proven_like_jax(tmp_path):
    (jnode, jblock), (pnode, pblock) = (_attacker(pkg, tmp_path) for pkg in PACKAGES)
    # the attacker's own vote carries the block; the same bytes committed
    assert (tmp_path / "celestia_tpu" / "blocks" / "2.json").read_bytes() == \
        (tmp_path / "celestia_tpu_torch" / "blocks" / "2.json").read_bytes()
    assert pblock.data_hash == jblock.data_hash and pblock.app_hash == jblock.app_hash
    published = pnode.app.published_eds[2]
    assert pnode.block_eds(2) is published
    assert np.array_equal(published, np.asarray(jnode.block_eds(2)))
    w = published.shape[0]
    assert pnode.block_width(2) == jnode.block_width(2) == w
    assert pnode.block_row(2, 0) == jnode.block_row(2, 0)
    assert pnode.block_share(2, 0, w // 2) == jnode.block_share(2, 0, w // 2)
    coords = [(0, 0), (0, w // 2), (w - 1, 1)]
    assert pnode.sample_batch(2, coords) == jnode.sample_batch(2, coords)
    assert pnode.block_dah(2).hash() == pblock.data_hash
    # an honest replica refuses it, in both packages
    from celestia_tpu_torch.app.app import App, ProposalBlockData

    honest = App(chain_id=CHAIN, **APP_KWARGS["celestia_tpu_torch"])
    honest.init_chain({ALICE.bech32_address(): 10**10}, genesis_time=0.0)
    honest.begin_block(15.0)
    honest.end_block()
    honest.commit()
    assert not honest.process_proposal(ProposalBlockData(pblock.txs, pblock.square_size,
                                                         pblock.data_hash))
    # the fraud proof: the port's find_befp on the served square is the JAX one
    pfraud, jfraud = mod("celestia_tpu_torch", "da.fraud"), mod("celestia_tpu", "da.fraud")
    mine, theirs = pfraud.find_befp(published), jfraud.find_befp(np.asarray(jnode.block_eds(2)))
    assert mine is not None and theirs is not None
    assert json.dumps(mine.to_json(), sort_keys=True) == json.dumps(theirs.to_json(),
                                                                    sort_keys=True)
    assert pfraud.verify_befp(mine, pnode.block_dah(2)) is True


# ---- the IBC light-client relayer

RELAY_KEYS = {name: JKey.from_secret(b"hs-" + name.encode())
              for name in ("alice", "bob", "relayer-a", "relayer-b", "val-a", "val-b")}


def _ibc_setup(pkg: str):
    app_mod, node_mod = mod(pkg, "app.app"), mod(pkg, "node.node")
    ibc, crypto = mod(pkg, "testutil.ibc"), mod(pkg, "crypto")
    lightclient = mod(pkg, "x.lightclient")
    keys = {name: crypto.PrivateKey.from_secret(b"hs-" + name.encode()) for name in RELAY_KEYS}

    def chain(chain_id: str, val):
        app = app_mod.App(chain_id=chain_id, **APP_KWARGS[pkg])
        app.init_chain({keys[n].bech32_address(): 10**9
                        for n in ("alice", "bob", "relayer-a", "relayer-b")}, genesis_time=0.0)
        ibc.add_consensus_validator(app, keys[val], 1_000_000)
        node = node_mod.Node(app)
        node.produce_block(15.0)
        return node

    node_a, node_b = chain("hs-chain-a", "val-a"), chain("hs-chain-b", "val-b")
    cs_a = lightclient.ClientKeeper(node_a.app.store).create_client(ibc.make_header(node_b))
    cs_b = lightclient.ClientKeeper(node_b.app.store).create_client(ibc.make_header(node_a))
    node_a.app.store.commit_hash_refresh()
    node_b.app.store.commit_hash_refresh()
    relayer = ibc.LightClientRelayer(node_a, node_b, keys["relayer-a"], keys["relayer-b"],
                                     [keys["val-a"]], [keys["val-b"]],
                                     client_a=cs_a.client_id, client_b=cs_b.client_id)
    return node_a, node_b, relayer, keys


def _ibc_state(node) -> dict:
    """The store's entries outside the light clients (whose consensus states
    are written from each package's own signatures)."""
    skip = (b"ibc/client/",)
    return {k.hex(): v.hex() for k, v in node.app.store._data.items()
            if not k.startswith(skip)}


def _relay_run(pkg: str) -> dict:
    user, transfer = mod(pkg, "user"), mod(pkg, "x.transfer")
    node_a, node_b, relayer, keys = _ibc_setup(pkg)
    chan_a, chan_b = relayer.handshake(100.0, 100.0)
    alice, bob = keys["alice"].bech32_address(), keys["bob"].bech32_address()
    out = {"channels": (chan_a, chan_b)}
    # a voucher of A's token comes home from B, relayed with its ack
    esc = transfer.escrow_address("transfer", chan_a)
    voucher = f"transfer/{chan_b}/utia"
    node_a.app.bank.mint(esc, 5_000, "utia")
    node_b.app.bank.mint(bob, 5_000, voucher)
    node_a.app.store.commit_hash_refresh()
    node_b.app.store.commit_hash_refresh()
    res = user.Signer.setup_single(keys["bob"], node_b).submit_tx(
        [transfer.MsgTransfer("transfer", chan_b, voucher, 5_000, bob, alice)])
    out["transfer"] = (res.code, res.log)
    node_b.produce_block(700.0)
    out["relayed"] = relayer.relay(800.0, 800.0, channel_a=chan_a, channel_b=chan_b)
    ack = node_a.app.ibc.get_acknowledgement("transfer", chan_a, 1)
    out["ack"] = None if ack is None else (ack.success, ack.result, ack.error)
    # an outbound transfer that B never receives: timed out and refunded
    res = user.Signer.setup_single(keys["alice"], node_a).submit_tx(
        [transfer.MsgTransfer("transfer", chan_a, "utia", 3_000, alice, bob,
                              timeout_timestamp=950.0)])
    out["outbound"] = (res.code, res.log)
    node_a.produce_block(900.0)
    node_b.produce_block(1000.0)
    packet = node_a.app.ibc.get_packet("transfer", chan_a, 1)  # A's first send
    relayer.timeout(packet, node_a, node_b, relayer.signer_a, 1020.0)
    out["pending"] = (node_a.app.ibc.pending_packets("transfer", chan_a),
                      node_b.app.ibc.pending_packets("transfer", chan_b))
    out["balances"] = {name: (node_a.app.bank.get_balance(keys[name].bech32_address()),
                              node_b.app.bank.get_balance(keys[name].bech32_address(), voucher))
                       for name in ("alice", "bob")}
    out["escrow"] = node_a.app.bank.get_balance(esc)
    out["state"] = (_ibc_state(node_a), _ibc_state(node_b))
    out["heights"] = (node_a.app.height, node_b.app.height)
    return out


def test_the_light_client_relayer_over_port_nodes_matches_jax():
    theirs, ours = (_relay_run(pkg) for pkg in PACKAGES)
    assert ours["transfer"] == ours["outbound"] == (0, "")
    assert ours["relayed"] == 1 and ours["ack"][0] is True
    assert ours["escrow"] == 0 and ours["pending"] == ([], [])
    for key in ("channels", "transfer", "relayed", "ack", "outbound", "pending", "balances",
                "escrow", "heights"):
        assert repr(ours[key]) == repr(theirs[key]), key
    assert ours["state"] == theirs["state"]
