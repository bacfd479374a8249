"""The port's Node block path (``celestia_tpu_torch/node/node.py``) against
the JAX package's Node, on the CPU.

A block script runs through a port Node and a JAX Node fed the same raw tx
bytes (signed by the JAX package's keys): sends and PFBs through
``broadcast_tx``, the mempool's priority order, its TTL eviction and
``has_seen``, own proposals (``produce_block``), external blocks
(``apply_external_block``) from a third node, a wrong ``expected_height``,
a block that fails ProcessProposal, and evidence. The JAX App runs on the
native backend; the port App on ``gpu`` with ``device="cpu"`` (the device
entries' plain versions) at k <= 8 and on native above. After every height
both nodes' ``blocks/<h>.json`` bytes, app hash, data hash, tx index,
mempool keys, ``status``, ``account`` and ``get_tx`` are equal.

Then the fraud-proof ledger, the host rebuild of a height that neither the
cache nor the store serves (equal to the JAX node's bytes, also after a
refused store copy), and the retention policy: an unavailable device, an
integrity failure or a disk error is counted and the block commits; any
other exception propagates after the block's bookkeeping.
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
from celestia_tpu.x.slashing import Equivocation as JEquivocation
import celestia_tpu_torch.app.app as papp_mod
import celestia_tpu_torch.node.node as pnode_mod
from celestia_tpu_torch import faults, integrity, tracing
from celestia_tpu_torch.telemetry import metrics
from celestia_tpu_torch.x.slashing import Equivocation as PEquivocation

CHAIN = "node-test"
NAMES = ("alice", "bob", "carol", "val")
KEYS = {name: PrivateKey.from_secret(b"node-" + name.encode()) for name in NAMES}
ADDR = {name: key.bech32_address() for name, key in KEYS.items()}
ACCOUNT = {name: i for i, name in enumerate(NAMES)}  # genesis order
BOND = 10**8


def _genesis(app) -> None:
    app.init_chain({ADDR[n]: 10**12 if n != "val" else 10**9 for n in NAMES},
                   genesis_time=0.0, genesis_validators={ADDR["val"]: BOND})


def send(name: str, seq: int, amount: int, fee: int = 4_000) -> bytes:
    """A MsgSend to the validator, at ``fee`` over 400,000 gas."""
    return sign_tx(KEYS[name], [MsgSend(ADDR[name], ADDR["val"], amount)], CHAIN,
                   ACCOUNT[name], seq, Fee(amount=fee, gas_limit=400_000)).marshal()


def pfb(name: str, seq: int, sizes, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    blobs = [jblob.new_blob(jns.new_v0(b"node" + bytes([seed, i])),
                            rng.integers(0, 256, n, dtype=np.uint8).tobytes(), 0)
             for i, n in enumerate(sizes)]
    gas = estimate_gas(sizes)
    tx = sign_tx(KEYS[name], [new_msg_pay_for_blobs(ADDR[name], *blobs)], CHAIN, ACCOUNT[name],
                 seq, Fee(amount=gas, gas_limit=gas))
    return jblob.marshal_blob_tx(tx.marshal(), blobs)


def port_app(backend: str = "gpu"):
    app = papp_mod.App(chain_id=CHAIN, extend_backend=backend, device="cpu")
    _genesis(app)
    return app


def jax_app():
    app = japp_mod.App(chain_id=CHAIN, extend_backend="native")
    _genesis(app)
    return app


def _tx_view(node, key: bytes):
    got = node.get_tx(key)
    return None if got is None else (json.dumps(got[0].to_json()), got[1])


class Twins:
    """A port Node and a JAX Node from one genesis, each with its own home,
    fed the same bytes; ``src`` is a third (JAX) node whose blocks both
    apply as external blocks."""

    def __init__(self, tmp_path, extend_blocks: bool = True, backend: str = "gpu"):
        self.port = pnode_mod.Node(port_app(backend), home=tmp_path / "port",
                                   extend_blocks=extend_blocks)
        self.jax = jnode_mod.Node(jax_app(), home=str(tmp_path / "jax"),
                                  extend_blocks=extend_blocks)
        self.src = jnode_mod.Node(jax_app())
        self.tmp = tmp_path
        self.seen_txs: list[bytes] = []

    def broadcast(self, raw: bytes, to_src: bool = True):
        res = [self.jax.broadcast_tx(raw), self.port.broadcast_tx(raw)]
        if to_src:
            self.src.broadcast_tx(raw)
        assert [(r.code, r.log, r.gas_wanted, r.priority) for r in res[:1]] == \
            [(r.code, r.log, r.gas_wanted, r.priority) for r in res[1:]]
        self.seen_txs.append(raw)
        return res[1]

    def produce(self, t: float):
        """An own proposal on both nodes; ``src`` applies the JAX block."""
        jb = self.jax.produce_block(t)
        pb = self.port.produce_block(t)
        self.src.apply_external_block(jb.txs, jb.square_size, jb.data_hash, t)
        self.check(pb.height)
        return pb

    def external(self, t: float, evidence=()):
        """``src`` proposes; both nodes apply its block, with ``evidence``."""
        sb = self.src.produce_block(t) if not evidence else None
        if sb is None:
            proposal = self.src.app.prepare_proposal(self.src.mempool.reap())
            sb = self.src._apply_block_locked(proposal, t, own=True,
                                              evidence=[JEquivocation(*e) for e in evidence])
        h = sb.height
        self.jax.apply_external_block(sb.txs, sb.square_size, sb.data_hash, t,
                                      expected_height=h,
                                      evidence=[JEquivocation(*e) for e in evidence])
        pb = self.port.apply_external_block(sb.txs, sb.square_size, sb.data_hash, t,
                                            expected_height=h,
                                            evidence=[PEquivocation(*e) for e in evidence])
        self.check(h)
        assert pb.app_hash == sb.app_hash
        return pb

    def check(self, h: int) -> None:
        port, jax = self.port, self.jax
        files = [(self.tmp / n / "blocks" / f"{h}.json").read_bytes() for n in ("port", "jax")]
        assert files[0] == files[1], h
        pb, jb = port.get_block(h), jax.get_block(h)
        assert (pb.app_hash, pb.data_hash) == (jb.app_hash, jb.data_hash)
        assert port.app.store.app_hashes[port.app.store.version] == \
            jax.app.store.app_hashes[jax.app.store.version]
        assert port.tx_index == jax.tx_index
        assert list(port.mempool.txs) == list(jax.mempool.txs)
        assert port.mempool._seen == jax.mempool._seen
        assert port.status() == jax.status()
        assert port.latest_height() == jax.latest_height() == h
        for name in NAMES:
            assert port.account(ADDR[name]) == jax.account(ADDR[name])
        assert port.account("celestia1nobody") is None
        for raw in self.seen_txs:
            key = pnode_mod.tx_hash(raw)
            assert _tx_view(port, key) == _tx_view(jax, key)


def test_the_block_script_matches_the_jax_node(tmp_path):
    tw = Twins(tmp_path)
    tw.produce(15.0)  # height 1, empty: an own proposal

    # height 2 from the mempool: a low-fee send before a high-fee one from
    # another account reaps after it; a PFB; all in priority order
    tw.broadcast(send("bob", 0, 1_000, fee=4_000))
    tw.broadcast(send("carol", 0, 2_000, fee=40_000))
    tw.broadcast(pfb("alice", 0, [3_000, 700], 1))
    reaped = tw.port.mempool.reap()
    assert reaped == tw.jax.mempool.reap()
    prios = [tw.port.mempool.txs[pnode_mod.tx_hash(r)].priority for r in reaped]
    assert prios == sorted(prios, reverse=True) and prios[0] > prios[-1]
    assert tw.port.mempool.reap(max_bytes=600) == tw.jax.mempool.reap(max_bytes=600)
    b2 = tw.produce(30.0)
    assert len(b2.txs) == 3 and b2.square_size <= 8
    assert all(r.code == 0 for r in b2.tx_results)
    assert len(tw.port.mempool) == 0
    key = pnode_mod.tx_hash(reaped[0])
    assert tw.port.mempool.has_seen(key) and tw.jax.mempool.has_seen(key)

    # a tx only the twins hold (src never sees it): external blocks leave it
    # pooled until its TTL runs out, then it is forgotten
    lonely = send("carol", 1, 7, fee=4_000)
    tw.broadcast(lonely, to_src=False)
    tw.seen_txs.pop()  # never committed
    lonely_key = pnode_mod.tx_hash(lonely)
    h_added = tw.port.latest_height()
    t = 30.0
    for i in range(pnode_mod.MEMPOOL_TTL_BLOCKS):
        t += 15.0
        tw.src.broadcast_tx(send("bob", 1 + i, 10 + i))
        tw.seen_txs.append(send("bob", 1 + i, 10 + i))
        tw.external(t)
        pooled = tw.port.latest_height() - h_added < pnode_mod.MEMPOOL_TTL_BLOCKS
        assert (lonely_key in tw.port.mempool.txs) == pooled
        assert tw.port.mempool.has_seen(lonely_key) == pooled
    assert len(tw.port.mempool) == 0

    # a wrong expected height and a block that fails ProcessProposal are
    # refused alike, and change nothing
    sb = tw.src.app.prepare_proposal([])
    for node in (tw.port, tw.jax):
        h = node.latest_height()
        with pytest.raises(ValueError) as wrong:
            node.apply_external_block(sb.txs, sb.square_size, sb.hash, t + 15.0,
                                      expected_height=h + 2)
        assert str(wrong.value) == f"block certified for height {h + 2}, node is at {h}"
        with pytest.raises(ValueError, match="fails ProcessProposal"):
            node.apply_external_block(sb.txs, sb.square_size, b"\x11" * 32, t + 15.0)
        assert node.latest_height() == h
    tw.check(tw.port.latest_height())

    # evidence: the validator equivocated at height 2 and is slashed
    before = tw.port.app.staking.get_validator(ADDR["val"])
    tw.external(t + 15.0, evidence=[(ADDR["val"], 2, BOND // 10**6)])
    after = tw.port.app.staking.get_validator(ADDR["val"])
    assert (after.tokens, after.jailed) != (before.tokens, before.jailed)
    assert json.loads((tmp_path / "port" / "blocks" / f"{tw.port.latest_height()}.json")
                      .read_text())["evidence"] == [
        {"validator": ADDR["val"], "height": 2, "power": BOND // 10**6}]

    # a k = 16 block: the port App on native above k = 8
    tw.port.app.extend_backend = "native"
    tw.broadcast(pfb("alice", 1, [100_000], 4))
    b = tw.produce(t + 30.0)
    assert b.square_size == 16 and all(r.code == 0 for r in b.tx_results)
    # the restored Block round-trips the JSON bytes, evidence included
    for h in range(1, tw.port.latest_height() + 1):
        raw = (tmp_path / "port" / "blocks" / f"{h}.json").read_text()
        again = pnode_mod.Block.from_json(json.loads(raw))
        assert json.dumps(again.to_json()) == raw
    assert tw.port.ibc_light_client_header() == \
        _port_header(tw.jax.ibc_light_client_header())


def _port_header(jheader):
    from celestia_tpu_torch.x.lightclient import Header, ValidatorInfo

    return Header(chain_id=jheader.chain_id, height=jheader.height, time=jheader.time,
                  app_hash=jheader.app_hash,
                  validators=[ValidatorInfo(v.pubkey, v.power) for v in jheader.validators])


def test_a_read_only_node_has_no_block_path():
    node = pnode_mod.Node(device="cpu")
    for call in (lambda: node.broadcast_tx(b"x"), lambda: node.produce_block(1.0),
                 lambda: node.apply_external_block([], 1, b"", 1.0), node.status,
                 node.snapshot_payload, node.latest_height):
        with pytest.raises(RuntimeError, match="serves reads only"):
            call()
    assert node.get_block(1) is None and node.get_tx(b"k") is None
    assert node.block_eds(1) is None


def test_the_node_runs_on_its_apps_device():
    app = port_app()
    assert pnode_mod.Node(app).device == app.device
    assert pnode_mod.Node(app, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="is not its App's"):
        pnode_mod.Node(app, device="cuda")


# ---- the fraud-proof ledger

def _ledger_script(node) -> list:
    """The same calls on either package's node: the cap, a duplicate, a
    forced proof evicting a decoy, a forged ``_certified`` that is never
    trusted, and the listing without the marker."""
    out = []
    for i in range(node.MAX_FRAUD_PROOFS_PER_HEIGHT):
        out.append(node.add_fraud_proof(5, bytes([i]) * 32,
                                        {"height": 5, "proof": i, "_certified": True}))
    out.append(node.add_fraud_proof(5, b"\x00" * 32, {"height": 5, "proof": 0}))
    out.append(node.add_fraud_proof(5, b"\x09" * 32, {"height": 5, "proof": 9}))
    out.append(node.add_fraud_proof(5, b"\x0a" * 32, {"height": 5, "proof": 10}, force=True))
    out.append(node.add_fraud_proof(5, b"\x0b" * 32, {"height": 5, "proof": 11}, force=True))
    out.append(node.add_fraud_proof(6, b"\x0c" * 32, {"height": 6}, force=True))
    out.append(node.fraud_proofs_at(5))
    out.append(node.fraud_proofs_at(7))
    out.append(json.dumps(node.fraud_proofs, sort_keys=True))
    out.append(sorted(node.fraudulent_data_hashes))
    return out


def test_the_fraud_proof_ledger_matches_the_jax_node():
    ours = _ledger_script(pnode_mod.Node(device="cpu"))
    theirs = _ledger_script(jnode_mod.Node(jax_app()))
    assert ours == theirs
    ledger = json.loads(ours[-2])["5"]
    # the forged markers were dropped; the forced proofs are certified and
    # evicted the unforced decoys
    assert sorted(k for k, v in ledger.items() if v.get("_certified")) == \
        [(b"\x0a" * 32).hex(), (b"\x0b" * 32).hex()]
    assert ours[:9] == [True] * 4 + [False, False, True, True, True]
    assert all("_certified" not in w for w in ours[9])


# ---- the host rebuild of a missed height

def _block_chain(tmp_path, extend_blocks: bool, backend: str = "gpu"):
    tw = Twins(tmp_path, extend_blocks=extend_blocks, backend=backend)
    tw.produce(15.0)
    tw.broadcast(pfb("alice", 0, [20_000], 7))
    tw.broadcast(send("bob", 0, 5))
    tw.produce(30.0)
    return tw


def test_a_missed_height_is_rebuilt_from_the_blocks_like_jax(tmp_path, monkeypatch):
    """Without retention neither cache nor store holds height 2: both nodes
    rebuild it on the host from their blocks, byte for byte, without the
    App's backend or a device extend."""
    tw = _block_chain(tmp_path, extend_blocks=False)
    assert 2 not in tw.port.store and tw.port._eds_cache.get(2) is None

    def no_device(*_a, **_k):
        raise AssertionError("the rebuild ran on a device")

    monkeypatch.setattr(papp_mod.App, "extend_block", no_device)
    monkeypatch.setattr(papp_mod.da, "extend_shares", no_device)
    ours, theirs = tw.port.block_eds(2), tw.jax.block_eds(2)
    assert isinstance(ours, np.ndarray) and np.array_equal(ours, np.asarray(theirs))
    assert tw.port._eds_cache.get(2) is ours
    assert tw.port.block_dah(2).hash() == tw.port.get_block(2).data_hash
    coords = [(0, 0), (3, 5), (7, 1)]
    assert tw.port.sample_batch(2, coords) == tw.jax.sample_batch(2, coords)
    assert tw.port.block_eds(9) is None and tw.jax.block_eds(9) is None


@pytest.mark.parametrize("times", [1, None])
def test_a_refused_store_copy_is_rebuilt_from_the_blocks(tmp_path, times):
    """Retention persisted height 2 on both nodes. A restarted node's store
    read strikes a bitflip: the port refuses the height's store copy and
    answers from the host rebuild; the JAX node re-reads its store. Both
    answer the clean documents: with blocks, a refused height is served
    again, as in the JAX node."""
    tw = _block_chain(tmp_path, extend_blocks=True)
    coords = [(i, (5 * i + 1) % 8) for i in range(8)]
    want = tw.jax.sample_batch(2, coords)
    assert tw.port.sample_batch(2, coords) == want
    # a fresh node over the same App and home: the store serves height 2
    port = pnode_mod.Node(tw.port.app, home=tmp_path / "port")
    port.blocks = dict(tw.port.blocks)
    assert 2 in port.store and port._eds_cache.get(2) is None
    with faults.inject(faults.rule("store.read", "bitflip", times=times), seed=5):
        got = port.sample_batch(2, coords)
    assert got == want
    assert 2 in port._store_refused
    assert isinstance(port._eds_cache.get(2), np.ndarray)  # the rebuilt square


def test_a_failed_store_load_is_rebuilt_from_the_blocks_like_jax(tmp_path):
    """The store file of a persisted height vanishes after the re-index: with
    the node's blocks, both packages rebuild the height on the host (without
    blocks both answer None: tests/test_torch_node.py)."""
    tw = _block_chain(tmp_path, extend_blocks=True, backend="native")
    coords = [(0, 0), (4, 2), (7, 7)]
    want = tw.jax.sample_batch(2, coords)
    ours = pnode_mod.Node(tw.port.app, home=tmp_path / "port")
    theirs = jnode_mod.Node(tw.jax.app, home=str(tmp_path / "jax"))
    for node, src in ((ours, tw.port), (theirs, tw.jax)):
        node.blocks = dict(src.blocks)
    for which in ("port", "jax"):
        (tmp_path / which / "store" / "2.ctps").unlink()
    assert np.array_equal(ours.block_eds(2), np.asarray(theirs.block_eds(2)))
    assert ours.sample_batch(2, coords) == theirs.sample_batch(2, coords) == want


# ---- the retention policy

def _retention_node(tmp_path):
    node = pnode_mod.Node(port_app("native"), home=tmp_path, extend_blocks=True)
    node.produce_block(15.0)
    node.broadcast_tx(send("bob", 0, 5))
    return node


@pytest.mark.parametrize("exc", [faults.DeviceUnavailable("device.extend"),
                                 integrity.IntegrityError("device.extend.output"),
                                 OSError(28, "No space left on device")])
def test_a_retention_fault_is_counted_and_the_block_commits(tmp_path, monkeypatch, exc):
    node = _retention_node(tmp_path)
    reason = type(exc).__name__
    before = metrics.get_counter("node_retention_failures_total", reason=reason)

    def fail(*_a, **_k):
        raise exc

    target = "_persist_block_eds" if isinstance(exc, OSError) else "extend_block"
    monkeypatch.setattr(node if target == "_persist_block_eds" else node.app, target, fail)
    with tracing.record() as rec:
        block = node.produce_block(30.0)
    assert metrics.get_counter("node_retention_failures_total", reason=reason) - before == 1
    assert block.height == 2 and node.app.height == 2 and len(node.mempool) == 0
    assert 2 not in node.store
    names = [sp.name for sp in rec.spans]
    assert "node.apply_block" in names and "node.extend_retention" in names
    # the height is served by the host rebuild, equal to the block's DAH
    monkeypatch.undo()
    assert node.block_dah(2).hash() == block.data_hash


def test_another_retention_error_propagates_after_the_bookkeeping(tmp_path, monkeypatch):
    node = _retention_node(tmp_path)
    raw = node.mempool.reap()[0]
    failures = sum(v for k, v in metrics.counters.items()
                   if k.startswith("node_retention_failures_total"))

    def broken(*_a, **_k):
        raise RuntimeError("kernel failed to launch")

    monkeypatch.setattr(node.app, "extend_block", broken)
    with pytest.raises(RuntimeError, match="kernel failed to launch"):
        node.produce_block(30.0)
    # committed, and the node's books agree with the App
    assert node.app.height == 2 and node.get_block(2).txs == [raw]
    assert (tmp_path / "blocks" / "2.json").exists()
    assert node.get_tx(pnode_mod.tx_hash(raw)) == (node.get_block(2), 0)
    assert len(node.mempool) == 0 and node.mempool.has_seen(pnode_mod.tx_hash(raw))
    assert sum(v for k, v in metrics.counters.items()
               if k.startswith("node_retention_failures_total")) == failures
    monkeypatch.undo()
    assert node.produce_block(45.0).height == 3


def test_retention_persists_what_the_jax_node_persists(tmp_path):
    """Both nodes' retention writes the same store files for each height
    (host squares on both, so neither stores device row levels)."""
    tw = _block_chain(tmp_path, extend_blocks=True, backend="native")
    for h in (1, 2):
        names = sorted(p.name for p in (tmp_path / "port" / "store").iterdir()
                       if p.name.startswith(f"{h}."))
        assert names
        for name in names:
            assert (tmp_path / "port" / "store" / name).read_bytes() == \
                (tmp_path / "jax" / "store" / name).read_bytes(), name
    assert tw.port.block_dah(2).to_json() == tw.jax.block_dah(2).to_json()
