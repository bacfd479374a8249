"""Snapshots, state sync and resume of the port's Node against the JAX
package's, on the CPU.

Both packages' nodes run one chain from one genesis, fed the same raw tx
bytes (signed by the JAX package's keys). Their ``snapshot_payload`` is
equal; each restores the other's payload through ``state_sync_from`` (and
in place) to the same app hash, and refuses a tampered payload or a wrong
trusted hash alike. A node restarted from a stale snapshot replays the
newer blocks to the same app hash, and a stored block whose app hash or
data hash was corrupted is refused on replay. On the ``gpu`` backend the
replay checks equal-size squares with ONE ``batched_roots_device`` call.
A home written by the JAX node loads into the port's ``Node.load`` and
replays to the same app hash, and the reverse.
"""

import json

import numpy as np
import pytest

import celestia_tpu.app.app as japp_mod
import celestia_tpu.node.node as jnode_mod
from celestia_tpu import blob as jblob
from celestia_tpu import namespace as jns
from celestia_tpu.crypto import PrivateKey
from celestia_tpu.tx import Fee, sign_tx
from celestia_tpu.x.bank import MsgSend
from celestia_tpu.x.blob.types import estimate_gas, new_msg_pay_for_blobs
import celestia_tpu_torch.app.app as papp_mod
import celestia_tpu_torch.node.node as pnode_mod

CHAIN = "snap-test"
NAMES = ("alice", "bob", "val")
KEYS = {name: PrivateKey.from_secret(b"snap-" + name.encode()) for name in NAMES}
ADDR = {name: key.bech32_address() for name, key in KEYS.items()}
ACCOUNT = {name: i for i, name in enumerate(NAMES)}
PORT_APP = {"device": "cpu", "extend_backend": "native"}
JAX_APP = {"extend_backend": "native"}


def _genesis(app) -> None:
    app.init_chain({ADDR["alice"]: 10**12, ADDR["bob"]: 10**12, ADDR["val"]: 10**9},
                   genesis_time=0.0, genesis_validators={ADDR["val"]: 10**8})


def send(name: str, seq: int, amount: int) -> bytes:
    return sign_tx(KEYS[name], [MsgSend(ADDR[name], ADDR["val"], amount)], CHAIN,
                   ACCOUNT[name], seq, Fee(amount=4_000, gas_limit=400_000)).marshal()


def pfb(name: str, seq: int, size: int, seed: int) -> bytes:
    blob = jblob.new_blob(jns.new_v0(b"snap" + bytes([seed])),
                          np.random.default_rng(seed).integers(0, 256, size, np.uint8).tobytes(),
                          0)
    gas = estimate_gas([size])
    tx = sign_tx(KEYS[name], [new_msg_pay_for_blobs(ADDR[name], blob)], CHAIN, ACCOUNT[name],
                 seq, Fee(amount=gas, gas_limit=gas))
    return jblob.marshal_blob_tx(tx.marshal(), [blob])


# heights 2-4: equal k = 4 squares (one PFB of 1,500 bytes each) after an
# empty height 1, with sends on the way (in a block's order: normal txs
# before blob txs)
BLOCKS = [[], [send("bob", 0, 11), pfb("alice", 0, 1_500, 1)], [pfb("alice", 1, 1_500, 2)],
          [send("bob", 1, 12), pfb("alice", 2, 1_500, 3)]]


def port_node(home=None, backend: str = "native", **kw):
    app = papp_mod.App(chain_id=CHAIN, device="cpu", extend_backend=backend)
    _genesis(app)
    return pnode_mod.Node(app, home=home, **kw)


def jax_node(home=None, **kw):
    app = japp_mod.App(chain_id=CHAIN, extend_backend="native")
    _genesis(app)
    return jnode_mod.Node(app, home=None if home is None else str(home), **kw)


def run(node, blocks=BLOCKS, snapshot_at: int | None = None, t0: float = 15.0):
    """Each block's txs through broadcast_tx and produce_block; the snapshot
    saved after height ``snapshot_at``."""
    for i, txs in enumerate(blocks):
        for raw in txs:
            assert node.broadcast_tx(raw).code == 0
        block = node.produce_block(t0 + 15.0 * i)
        assert block.txs == txs and all(r.code == 0 for r in block.tx_results)
        if snapshot_at == block.height:
            node.save_snapshot()
    return node


def app_hash(node) -> bytes:
    return node.app.store.app_hashes[node.app.store.version]


def test_snapshot_payloads_are_equal():
    ours, theirs = run(port_node()), run(jax_node())
    assert ours.snapshot_payload() == theirs.snapshot_payload()
    assert ours._meta() == theirs._meta()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_each_package_state_syncs_from_the_others_payload(direction):
    ours, theirs = run(port_node()), run(jax_node())
    want = app_hash(theirs)
    if direction == "jax_to_port":
        synced = pnode_mod.Node.state_sync_from(theirs.snapshot_payload(),
                                                trusted_app_hash=want, **PORT_APP)
        assert synced.device.type == "cpu"
    else:
        synced = jnode_mod.Node.state_sync_from(ours.snapshot_payload(),
                                                trusted_app_hash=want.hex(), **JAX_APP)
    assert app_hash(synced) == want and synced.app.height == 4
    assert synced.app.block_time == theirs.app.block_time
    # the synced node and the source commit the same next block
    for node in (synced, theirs):
        assert node.broadcast_tx(send("bob", 2, 13)).code == 0
    assert synced.produce_block(90.0).app_hash == theirs.produce_block(90.0).app_hash


def test_a_node_state_syncs_in_place_from_a_jax_payload(tmp_path):
    theirs = run(jax_node())
    ours = port_node(home=tmp_path)
    ours.restore_from_snapshot(theirs.snapshot_payload(), trusted_app_hash=app_hash(theirs))
    assert app_hash(ours) == app_hash(theirs) and ours.app.device == ours.device
    assert json.loads((tmp_path / "meta.json").read_text()) == theirs._meta()


def _tampered(payload: dict) -> dict:
    state = bytearray(bytes.fromhex(payload["state"]))
    i = bytes(state).rindex(b'"version"') - 5
    while not 0x30 <= state[i] <= 0x39:
        i -= 1
    state[i] ^= 1
    return {**payload, "state": bytes(state).hex()}


@pytest.mark.parametrize("case", ["tampered", "wrong_trust", "forged_self_hash"])
def test_bad_payloads_are_refused_alike(case):
    ours, theirs = run(port_node()), run(jax_node())
    payload, trusted = ours.snapshot_payload(), app_hash(ours)
    if case == "tampered":
        payload = _tampered(payload)
    elif case == "wrong_trust":
        trusted = b"\x42" * 32
    else:  # a payload claiming the hash its own state restores to: only the
        # trusted hash refuses it
        payload = _tampered(payload)
        forged = pnode_mod.Node._restore_app(payload, bytes.fromhex(payload["state"]),
                                             **PORT_APP)
        payload["app_hash"] = forged.store.app_hashes[forged.store.version].hex()
        assert pnode_mod.Node.state_sync_from(payload, **PORT_APP) is not None
        assert jnode_mod.Node.state_sync_from(payload, **JAX_APP) is not None
    errors = []
    for cls, kw in ((pnode_mod.Node, PORT_APP), (jnode_mod.Node, JAX_APP)):
        with pytest.raises(ValueError, match="snapshot app hash mismatch") as err:
            cls.state_sync_from(payload, trusted_app_hash=trusted, **kw)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_crash_replay_from_a_stale_snapshot(tmp_path):
    node = run(port_node(home=tmp_path), snapshot_at=1)
    theirs = run(jax_node())
    recovered = pnode_mod.Node.load(tmp_path, **PORT_APP)
    assert recovered.app.height == 4 and app_hash(recovered) == app_hash(node)
    assert recovered.tx_index == node.tx_index == theirs.tx_index
    assert recovered.app.bank.get_balance(ADDR["alice"]) == \
        node.app.bank.get_balance(ADDR["alice"])
    for n in (recovered, theirs):
        assert n.broadcast_tx(send("bob", 2, 13)).code == 0
    assert recovered.produce_block(90.0).app_hash == theirs.produce_block(90.0).app_hash


@pytest.mark.parametrize("field,match", [("app_hash", "state corruption"),
                                         ("data_hash", "data hash mismatch")])
def test_a_corrupted_block_is_refused_on_replay_alike(tmp_path, field, match):
    errors = []
    for which, make, load, kw in (
            ("port", port_node, pnode_mod.Node.load, PORT_APP),
            ("jax", jax_node, lambda h, **k: jnode_mod.Node.load(str(h), **k), JAX_APP)):
        home = tmp_path / which
        run(make(home=home), snapshot_at=1)
        path = home / "blocks" / "3.json"
        doc = json.loads(path.read_text())
        doc[field] = ("00" if field == "app_hash" else "11") * 32
        path.write_text(json.dumps(doc))
        with pytest.raises(ValueError, match=match) as err:
            load(home, **kw)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_the_replay_checks_equal_squares_in_one_batched_call(tmp_path, monkeypatch):
    """On the gpu backend (device="cpu": the plain versions) heights 2-4, all
    k = 4, are checked by one batched_roots_device call of three squares,
    and the replay then needs no solo check."""
    node = run(port_node(home=tmp_path, backend="gpu"), snapshot_at=1)
    calls, solo = [], []
    real = pnode_mod.extend.batched_roots_device

    def counted(squares, device=None):
        calls.append([sq.shape for sq in squares])
        return real(squares, device)

    monkeypatch.setattr(pnode_mod.extend, "batched_roots_device", counted)
    monkeypatch.setattr(pnode_mod.Node, "_verify_block_data_hash",
                        staticmethod(lambda app, block: solo.append(block.height)))
    recovered = pnode_mod.Node.load(tmp_path, device="cpu", extend_backend="gpu")
    assert calls == [[(4, 4, 512)] * 3] and solo == []
    assert app_hash(recovered) == app_hash(node) and recovered.app.height == 4
    # the same pre-pass on the native backend verifies the same heights
    # without the batched call
    app = pnode_mod.Node._restore_app(json.loads((tmp_path / "meta.json").read_text()),
                                      (tmp_path / "state.json").read_bytes(), **PORT_APP)
    assert pnode_mod.Node._batch_verify_data_availability(
        app, [node.blocks[h] for h in (2, 3, 4)]) == {2, 3, 4}
    assert len(calls) == 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_home_written_by_one_package_loads_into_the_other(tmp_path, writer):
    """The blocks, the snapshot and the block store that one package's node
    wrote (with retention) load into the other's ``Node.load``: it replays
    to the same app hash and serves the same DAH and samples."""
    home = tmp_path / writer
    make = jax_node if writer == "jax" else port_node
    src = run(make(home=home, extend_blocks=True), snapshot_at=2)
    if writer == "jax":
        loaded = pnode_mod.Node.load(home, **PORT_APP)
    else:
        loaded = jnode_mod.Node.load(str(home), **JAX_APP)
    assert loaded.app.height == 4 and app_hash(loaded) == app_hash(src)
    assert loaded.tx_index == src.tx_index
    for h in (2, 3, 4):
        assert h in loaded.store
        assert loaded.block_dah(h).to_json() == src.block_dah(h).to_json()
        coords = [(0, 0), (5, 3), (7, 7)]
        assert loaded.sample_batch(h, coords) == src.sample_batch(h, coords)
    for node in (loaded, src):
        assert node.broadcast_tx(send("bob", 2, 13)).code == 0
    assert loaded.produce_block(90.0).app_hash == src.produce_block(90.0).app_hash
