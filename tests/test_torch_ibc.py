"""IBC in the port, by record and replay.

The JAX package's coordinator (celestia_tpu/testutil/ibc.py) runs its
light-client scenarios on two JAX chains: the ICS-3/ICS-4 handshake by
``LightClientRelayer.handshake``, relays both ways (a voucher coming home,
accepted; a foreign denom, refused by the tokenfilter with an error ack and
refunded), a client update, an honest timeout with an absence proof, and a
misbehaviour freeze. A recorder wraps each JAX App instance and writes down
every call that reaches it (init_chain, CheckTx, Prepare/ProcessProposal,
BeginBlock, DeliverTx, EndBlock, Commit, ExtendBlock) with its arguments
and result, and every write the coordinator makes to the committed store
directly (channel and client setup, minted balances) with the app-hash
refreshes after them.

Each chain's record is then replayed, the same bytes in the same order,
into a port App on ``device="cpu"`` (chain A on the ``gpu`` backend, which
runs the device entries' plain versions, chain B on ``native``), and every
tx's code, log, gas and events, every proposal and verdict, every block's
app hash and every ExtendBlock's roots must be the JAX App's."""

import dataclasses

import pytest

from celestia_tpu.app.app import App as JApp
from celestia_tpu.crypto import PrivateKey
from celestia_tpu.node import Node
from celestia_tpu.testutil.ibc import (
    LightClientRelayer,
    add_consensus_validator,
    make_header,
    open_client_channel,
    sign_header,
)
from celestia_tpu.user import Signer
from celestia_tpu.x.lightclient import ClientKeeper, MsgSubmitMisbehaviour
from celestia_tpu.x.transfer import MsgTransfer, escrow_address
import celestia_tpu_torch.app.app as papp_mod

ALICE = PrivateKey.from_secret(b"ibc-replay-alice")
BOB = PrivateKey.from_secret(b"ibc-replay-bob")
RELAYER_A = PrivateKey.from_secret(b"ibc-replay-relayer-a")
RELAYER_B = PrivateKey.from_secret(b"ibc-replay-relayer-b")
WATCHER = PrivateKey.from_secret(b"ibc-replay-watcher")
VALS_A = [PrivateKey.from_secret(b"ibc-replay-val-a")]
VALS_B = [PrivateKey.from_secret(b"ibc-replay-val-b1"),
          PrivateKey.from_secret(b"ibc-replay-val-b2")]
BOND = 1_000_000
RECORDED = ("init_chain", "check_tx", "prepare_proposal", "process_proposal", "begin_block",
            "deliver_tx", "end_block", "commit", "extend_block")


def _value(name: str, out):
    """A recorded result as plain data."""
    if name in ("check_tx", "deliver_tx", "prepare_proposal"):
        return dict(vars(out))
    if name == "extend_block":
        return out.row_roots(), out.col_roots()
    return out


class Recorder:
    """Wraps one JAX App instance: ``events`` lists (name, args, kwargs,
    result) for each outermost call of RECORDED, ("direct", writes,
    deletes) for changes to the committed store made outside them, and
    ("refresh",) for each app-hash refresh outside them."""

    def __init__(self, app):
        self.app = app
        self.events: list = []
        self.depth = 0
        self.shadow = dict(app.store._data)
        for name in RECORDED:
            setattr(app, name, self._wrap(name, getattr(app, name)))
        refresh = app.store.commit_hash_refresh

        def recorded_refresh():
            if self.depth:
                return refresh()
            self._flush()
            refresh()
            self.events.append(("refresh",))
            return None

        app.store.commit_hash_refresh = recorded_refresh

    def _flush(self) -> None:
        data = self.app.store._data
        writes = {k: v for k, v in data.items() if self.shadow.get(k) != v}
        deletes = [k for k in self.shadow if k not in data]
        if writes or deletes:
            self.events.append(("direct", writes, deletes))
        self.shadow = dict(data)

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            if self.depth:
                return fn(*args, **kwargs)
            self._flush()
            self.depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self.depth -= 1
            self.events.append((name, args, kwargs, _value(name, out)))
            self.shadow = dict(self.app.store._data)
            return out

        return call


def replay(events: list, chain_id: str, backend: str) -> dict:
    """Drive a port App through a record; every result must be the JAX
    App's. Returns counts of what was replayed."""
    app = papp_mod.App(chain_id=chain_id, extend_backend=backend, device="cpu")
    counts: dict[str, int] = {}
    for i, ev in enumerate(events):
        name = ev[0]
        counts[name] = counts.get(name, 0) + 1
        where = f"{chain_id} event {i} ({name})"
        if name == "direct":
            for k, v in ev[1].items():
                app.store.set(k, v)
            for k in ev[2]:
                app.store.delete(k)
            continue
        if name == "refresh":
            app.store.commit_hash_refresh()
            continue
        _name, args, kwargs, want = ev
        if name == "process_proposal":
            args = (papp_mod.ProposalBlockData(**vars(args[0])),)
        if name == "begin_block":
            assert not kwargs.get("evidence") and (len(args) < 3 or not args[2])
        got = _value(name, getattr(app, name)(*args, **kwargs))
        assert got == want, where
    assert app._gpu_strikes == 0 and not app._gpu_disabled
    return counts


def _new_chain(chain_id: str, val_keys) -> tuple[Node, Recorder]:
    app = JApp(chain_id=chain_id, extend_backend="native")
    rec = Recorder(app)
    app.init_chain({k.bech32_address(): 1_000_000_000
                    for k in (ALICE, BOB, RELAYER_A, RELAYER_B, WATCHER)}, genesis_time=0.0)
    for k in val_keys:
        add_consensus_validator(app, k, BOND)
    node = Node(app, extend_blocks=True)  # ExtendBlock after every commit
    node.produce_block(15.0)
    return node, rec


def _replay_both(rec_a: Recorder, rec_b: Recorder) -> tuple[dict, dict]:
    """Chain A's record into a port App on the gpu backend, B's on native:
    the replayed counts of each."""
    out = []
    for rec, backend in ((rec_a, "gpu"), (rec_b, "native")):
        counts = replay(rec.events, rec.app.chain_id, backend)
        assert counts["commit"] == counts["extend_block"] == rec.app.height
        assert counts["direct"] >= 1
        out.append(counts)
    return out[0], out[1]


def test_handshake_relays_both_ways_and_a_client_update_replay_alike():
    node_a, rec_a = _new_chain("ibc-replay-a", VALS_A)
    node_b, rec_b = _new_chain("ibc-replay-b", VALS_B)
    cs_a = ClientKeeper(node_a.app.store).create_client(make_header(node_b))
    cs_b = ClientKeeper(node_b.app.store).create_client(make_header(node_a))
    node_a.app.store.commit_hash_refresh()
    node_b.app.store.commit_hash_refresh()
    relayer = LightClientRelayer(node_a, node_b, RELAYER_A, RELAYER_B, VALS_A, VALS_B,
                                 client_a=cs_a.client_id, client_b=cs_b.client_id)
    chan_a, chan_b = relayer.handshake(100.0, 100.0)
    alice, bob = ALICE.bech32_address(), BOB.bech32_address()
    # A -> B: A's native token arrives on B as a foreign denom, which B's
    # tokenfilter refuses; the error ack goes back and A refunds
    sa = Signer.setup_single(ALICE, node_a)
    assert sa.submit_tx([MsgTransfer("transfer", chan_a, "utia", 3_000, alice, bob)]).code == 0
    node_a.produce_block(700.0)
    before = node_a.app.bank.get_balance(alice)
    assert relayer.relay(800.0, 800.0, channel_a=chan_a, channel_b=chan_b) == 1
    ack = node_a.app.ibc.get_acknowledgement("transfer", chan_a, 1)
    assert node_b.app.ibc.get_acknowledgement("transfer", chan_b, 1).success is False
    assert node_a.app.bank.get_balance(alice) == before + 3_000 and ack is None
    # B -> A: a voucher of A's token comes home (the escrow funded as the
    # JAX test funds it) and A releases it
    esc, voucher = escrow_address("transfer", chan_a), f"transfer/{chan_b}/utia"
    node_a.app.bank.mint(esc, 5_000, "utia")
    node_b.app.bank.mint(bob, 5_000, voucher)
    node_a.app.store.commit_hash_refresh()
    node_b.app.store.commit_hash_refresh()
    sb = Signer.setup_single(BOB, node_b)
    assert sb.submit_tx([MsgTransfer("transfer", chan_b, voucher, 5_000, bob, alice)]).code == 0
    node_b.produce_block(900.0)
    before = node_a.app.bank.get_balance(alice)
    assert relayer.relay(1000.0, 1000.0, channel_a=chan_a, channel_b=chan_b) == 1
    assert node_a.app.bank.get_balance(alice) == before + 5_000
    # a client update on its own
    height = relayer.update_client(node_a, node_b, relayer.signer_b, 1100.0)
    assert ClientKeeper(node_b.app.store).get_client(cs_b.client_id).latest_height == height
    counts_a, counts_b = _replay_both(rec_a, rec_b)
    assert counts_a["deliver_tx"] >= 10 and counts_b["deliver_tx"] >= 10


def test_a_timeout_and_a_misbehaviour_freeze_replay_alike():
    node_a, rec_a = _new_chain("ibc-replay-c", VALS_A)
    node_b, rec_b = _new_chain("ibc-replay-d", VALS_B)
    open_client_channel(node_a, node_b)
    relayer = LightClientRelayer(node_a, node_b, RELAYER_A, RELAYER_B, VALS_A, VALS_B)
    alice = ALICE.bech32_address()
    sa = Signer.setup_single(ALICE, node_a)
    assert sa.submit_tx([MsgTransfer("transfer", "channel-0", "utia", 4_000, alice,
                                     BOB.bech32_address(), timeout_timestamp=40.0)]).code == 0
    node_a.produce_block(30.0)
    packet = node_a.app.ibc.pending_packets("transfer", "channel-0")[0]
    node_b.produce_block(50.0)
    before = node_a.app.bank.get_balance(alice)
    relayer.timeout(packet, node_a, node_b, relayer.signer_a, 55.0)
    assert node_a.app.bank.get_balance(alice) == before + 4_000
    # B's validators sign two conflicting headers at one height; a watcher
    # on A submits them and A's client of B freezes
    header = make_header(node_b)
    header.height += 1
    header.time += 1.0
    other = dataclasses.replace(header, app_hash=b"\xee" * 32)
    watcher = Signer.setup_single(WATCHER, node_a)
    res = watcher.submit_tx([MsgSubmitMisbehaviour(
        "07-tendermint-0", sign_header(header, VALS_B), sign_header(other, VALS_B),
        watcher.address())])
    assert res.code == 0, res.log
    node_a.produce_block(70.0)
    assert ClientKeeper(node_a.app.store).get_client("07-tendermint-0").frozen
    counts_a, _counts_b = _replay_both(rec_a, rec_b)
    assert counts_a["deliver_tx"] >= 4


def test_the_recorder_sees_direct_writes_and_refreshes():
    """The record of a chain set up by hand: genesis, the coordinator's
    validator (direct writes and a refresh), one block."""
    node, rec = _new_chain("ibc-replay-e", VALS_A)
    names = [ev[0] for ev in rec.events]
    assert names[:3] == ["init_chain", "direct", "refresh"]
    assert {"prepare_proposal", "process_proposal", "begin_block", "end_block", "commit",
            "extend_block"} <= set(names)
    assert replay(rec.events, "ibc-replay-e", "numpy")["commit"] == node.app.height == 1


@pytest.mark.parametrize("backend", ["gpu", "native"])
def test_a_tampered_record_is_caught(backend):
    """The replay compares: one flipped byte in a recorded app hash fails."""
    _node, rec = _new_chain("ibc-replay-f", VALS_A)
    events = list(rec.events)
    i = next(j for j, ev in enumerate(events) if ev[0] == "commit")
    name, args, kwargs, want = events[i]
    events[i] = (name, args, kwargs, bytes([want[0] ^ 1]) + want[1:])
    with pytest.raises(AssertionError, match="commit"):
        replay(events, "ibc-replay-f", backend)
