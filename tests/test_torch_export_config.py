"""Genesis export and import, the layered config and the Signer of the port
(``app/export.py``, ``config.py``, ``user.py``) against the JAX package's,
on the CPU.

A port node and a JAX node run one chain, fed the same raw tx bytes: their
exported genesis documents are equal (at the current height and for a zero
height), each package imports either document to an App that continues to
the same app hash, and the config's defaults, TOML text, environment and
flag layers are equal, with the ``extend_backend`` values the port's
(``gpu`` where JAX says ``tpu``). The Signer runs over a port Node and over
a JAX Node: each package signs with its own keys (RFC 6979 nonces against
OpenSSL's random ones), so the tx bytes differ and the outcomes are
compared instead: codes, logs, gas, sequences and module state.
"""

import dataclasses
import json

import pytest

import celestia_tpu.app.app as japp_mod
import celestia_tpu.config as jconfig
import celestia_tpu.node.node as jnode_mod
import celestia_tpu.user as juser
from celestia_tpu import blob as jblob
from celestia_tpu import namespace as jns
from celestia_tpu.app import export as jexport
from celestia_tpu.crypto import PrivateKey as JKey
from celestia_tpu.tx import Fee as JFee
from celestia_tpu.tx import sign_tx
from celestia_tpu.x.bank import MsgSend as JMsgSend
from celestia_tpu.x.blob.types import estimate_gas, new_msg_pay_for_blobs
from celestia_tpu.x.staking import MsgDelegate
import celestia_tpu_torch.app.app as papp_mod
import celestia_tpu_torch.config as pconfig
import celestia_tpu_torch.node.node as pnode_mod
import celestia_tpu_torch.user as puser
from celestia_tpu_torch import blob as pblob
from celestia_tpu_torch import namespace as pns
from celestia_tpu_torch.app import export as pexport
from celestia_tpu_torch.crypto import PrivateKey as PKey
from celestia_tpu_torch.tx import Fee as PFee
from celestia_tpu_torch.x.bank import MsgSend as PMsgSend

CHAIN = "export-test"
NAMES = ("validator", "alice", "bob")
SECRET = {name: b"export-" + name.encode() for name in NAMES}
JKEYS = {name: JKey.from_secret(s) for name, s in SECRET.items()}
ADDR = {name: k.bech32_address() for name, k in JKEYS.items()}
ACCOUNT = {name: i for i, name in enumerate(NAMES)}
PORT_APP = {"device": "cpu", "extend_backend": "native"}


def _genesis(app) -> None:
    app.init_chain({ADDR["validator"]: 10**12, ADDR["alice"]: 5 * 10**10,
                    ADDR["bob"]: 5 * 10**10}, genesis_time=0.0,
                   genesis_validators={ADDR["validator"]: 10**9})


def nodes():
    papp = papp_mod.App(chain_id=CHAIN, **PORT_APP)
    japp = japp_mod.App(chain_id=CHAIN, extend_backend="native")
    for app in (papp, japp):
        _genesis(app)
    ours, theirs = pnode_mod.Node(papp), jnode_mod.Node(japp)
    for node in (ours, theirs):
        node.produce_block(15.0)
    return ours, theirs


def _tx(name: str, seq: int, msg, fee: int = 4_000) -> bytes:
    return sign_tx(JKEYS[name], [msg], CHAIN, ACCOUNT[name], seq,
                   JFee(amount=fee, gas_limit=400_000)).marshal()


def populated():
    """Both nodes after a send, a PFB and a delegation (the same bytes),
    committed over two blocks."""
    ours, theirs = nodes()
    blob = jblob.new_blob(jns.new_v0(b"exporttest"), b"\x07" * 600, 0)
    gas = estimate_gas([600])
    pfb = jblob.marshal_blob_tx(sign_tx(
        JKEYS["alice"], [new_msg_pay_for_blobs(ADDR["alice"], blob)], CHAIN, ACCOUNT["alice"],
        1, JFee(amount=gas, gas_limit=gas)).marshal(), [blob])
    txs = [_tx("alice", 0, JMsgSend(ADDR["alice"], ADDR["bob"], 777)), pfb,
           _tx("validator", 0, MsgDelegate(ADDR["validator"], ADDR["validator"], 5_000_000))]
    for node in (ours, theirs):
        for raw in txs:
            assert node.broadcast_tx(raw).code == 0
        node.produce_block(30.0)
        node.produce_block(31.0)
        assert len(node.mempool) == 0
    return ours, theirs


def app_hash(app) -> bytes:
    return app.store.app_hashes[app.store.version]


@pytest.mark.parametrize("zero_height", [False, True])
def test_export_equals_the_jax_packages_document(zero_height):
    ours, theirs = populated()
    g_port = pexport.export_app_state_and_validators(ours.app, for_zero_height=zero_height)
    g_jax = jexport.export_app_state_and_validators(theirs.app, for_zero_height=zero_height)
    assert json.dumps(g_port, sort_keys=True) == json.dumps(g_jax, sort_keys=True)
    assert g_port["height"] == (0 if zero_height else ours.app.height + 1)
    if zero_height:  # the prep touched the exporting Apps alike
        assert app_hash(ours.app) == app_hash(theirs.app)


@pytest.mark.parametrize("zero_height", [False, True])
def test_each_package_imports_either_document_and_continues_alike(zero_height):
    ours, theirs = populated()
    g = jexport.export_app_state_and_validators(theirs.app, for_zero_height=zero_height)
    port_app = pexport.import_genesis(json.loads(json.dumps(g)), **PORT_APP)
    jax_app = jexport.import_genesis(json.loads(json.dumps(g)), extend_backend="native")
    assert port_app.device.type == "cpu"
    assert (port_app.height, port_app.chain_id, port_app.app_version) == \
        (jax_app.height, jax_app.chain_id, jax_app.app_version)
    assert port_app.store.snapshot() == jax_app.store.snapshot()
    assert app_hash(port_app) == app_hash(jax_app)
    nodes_ = [pnode_mod.Node(port_app), jnode_mod.Node(jax_app)]
    send = _tx("bob", 0, JMsgSend(ADDR["bob"], ADDR["alice"], 5))
    for node in nodes_:
        assert node.broadcast_tx(send).code == 0
    # (a zero-height chain's first block is empty by the App's rule: the
    # send lands in the second)
    for t in ((99.0,) if not zero_height else (99.0, 114.0)):
        blocks = [node.produce_block(t) for node in nodes_]
        assert blocks[0].app_hash == blocks[1].app_hash
        assert blocks[0].to_json() == blocks[1].to_json()
    assert [r.code for r in blocks[0].tx_results] == [0]
    if not zero_height:  # the restored chain commits what the original would
        for node in (ours, theirs):
            assert node.broadcast_tx(send).code == 0
            assert node.produce_block(99.0).app_hash == blocks[0].app_hash


# ---- the layered config

def test_config_defaults_and_toml_equal_the_jax_packages():
    assert dataclasses.asdict(pconfig.NodeConfig()) == dataclasses.asdict(jconfig.NodeConfig())
    for cls, root in (("ConsensusConfig", "consensus"), ("AppConfig", "app")):
        assert pconfig.dumps_toml(getattr(pconfig, cls)(), root) == \
            jconfig.dumps_toml(getattr(jconfig, cls)(), root)
    cfg = pconfig.NodeConfig()
    assert cfg.app.min_gas_price == pytest.approx(0.1)
    assert cfg.consensus.mempool.ttl_num_blocks == pnode_mod.MEMPOOL_TTL_BLOCKS
    assert cfg.consensus.mempool.max_txs_bytes == cfg.consensus.mempool.max_tx_bytes * 5


def test_config_layers_equal_the_jax_packages(tmp_path, monkeypatch):
    """Defaults < TOML files < CELESTIA_* env < flags, in both packages on
    the same files, environment and flags."""
    for pkg, home in ((pconfig, tmp_path / "port"), (jconfig, tmp_path / "jax")):
        pkg.write_default_configs(home)
    texts = [(home / "config" / name).read_text()
             for home in (tmp_path / "port", tmp_path / "jax")
             for name in ("config.toml", "app.toml")]
    assert texts[:2] == texts[2:]
    for home in (tmp_path / "port", tmp_path / "jax"):
        app_toml = home / "config" / "app.toml"
        app_toml.write_text(app_toml.read_text().replace(
            "min_gas_price = 0.1", "min_gas_price = 0.75").replace(
            'calibrate_crossover = false', 'calibrate_crossover = true'))
        cfg_toml = home / "config" / "config.toml"
        cfg_toml.write_text(cfg_toml.read_text().replace(
            "skip_timeout_commit = false", "skip_timeout_commit = true"))
    layers = []
    for env, flags in (({}, {}),
                       ({"CELESTIA_APP_MIN_GAS_PRICE": "1.5",
                         "CELESTIA_CONSENSUS_MEMPOOL_TTL_NUM_BLOCKS": "9",
                         "CELESTIA_APP_API_ENABLE": "yes"}, {}),
                       ({"CELESTIA_APP_MIN_GAS_PRICE": "1.5"},
                        {"app.min_gas_price": 2.0, "consensus.rpc.laddr": "0.0.0.0:1",
                         "app.grpc_enable": 1})):
        for name in ("CELESTIA_APP_MIN_GAS_PRICE", "CELESTIA_CONSENSUS_MEMPOOL_TTL_NUM_BLOCKS",
                     "CELESTIA_APP_API_ENABLE"):
            monkeypatch.delenv(name, raising=False)
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        ours = pconfig.load_config(tmp_path / "port", flags)
        theirs = jconfig.load_config(tmp_path / "jax", flags)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        layers.append(ours)
    assert [c.app.min_gas_price for c in layers] == [0.75, 1.5, 2.0]
    assert layers[1].consensus.mempool.ttl_num_blocks == 9 and layers[1].app.api_enable
    assert layers[0].consensus.skip_timeout_commit and layers[0].app.calibrate_crossover
    assert layers[2].consensus.rpc.laddr == "0.0.0.0:1" and layers[2].app.grpc_enable is True


def test_the_config_names_the_ports_backends(tmp_path, monkeypatch):
    """``extend_backend`` is one of the port App's backends: ``gpu`` for the
    device path where the JAX package says ``tpu``."""
    pconfig.write_default_configs(tmp_path)
    assert pconfig.load_config(tmp_path).app.extend_backend == "auto"
    monkeypatch.setenv("CELESTIA_APP_EXTEND_BACKEND", "gpu")
    cfg = pconfig.load_config(tmp_path)
    assert cfg.app.extend_backend == "gpu"
    assert papp_mod.App(extend_backend=cfg.app.extend_backend, device="cpu") is not None
    assert pconfig.load_config(tmp_path, {"app.extend_backend": "numpy"}).app.extend_backend \
        == "numpy"
    with pytest.raises(ValueError, match="unknown extend backend"):
        papp_mod.App(extend_backend="tpu", device="cpu")


# ---- the Signer

def _outcome(res) -> tuple:
    return res.code, res.log, res.gas_wanted, res.gas_used


def _state(node) -> dict:
    return {name: node.account(ADDR[name]) for name in NAMES}


def test_the_signer_over_a_port_node_matches_the_jax_signer():
    """A send, a PFB with options, a stale second Signer recovering from the
    sequence race, and a fee bumped to the node's min gas price: the same
    outcomes, sequences, blocks' codes and accounts over both nodes."""
    ours, theirs = nodes()
    sides = [(puser, PKey, PMsgSend, PFee, pblob, pns, ours),
             (juser, JKey, JMsgSend, JFee, jblob, jns, theirs)]
    record = []
    for user, key_cls, msg_send, fee_cls, blob_mod, ns_mod, node in sides:
        alice = key_cls.from_secret(SECRET["alice"])
        out = []
        s1 = user.Signer.setup_single(alice, node)
        s2 = user.Signer.setup_single(alice, node)
        out.append(_outcome(s1.submit_tx([msg_send(ADDR["alice"], ADDR["bob"], 10)])))
        res = s2.submit_tx([msg_send(ADDR["alice"], ADDR["bob"], 20)])  # stale: recovers
        out.append((_outcome(res), s1.sequence, s2.sequence))
        blob = blob_mod.new_blob(ns_mod.new_v0(b"opts-test"), b"\x42" * 1000, 0)
        res = s2.submit_pay_for_blob([blob], opts=user.TxOptions(gas_limit=120_000,
                                                                 gas_price=0.5))
        out.append((_outcome(res), s2.sequence))
        assert s2.confirm_tx(res.raw) is None  # not committed yet
        # the PFB pays a higher gas price: it reaps ahead of the sends, fails
        # FilterTxs on its sequence and lands a block later
        for t in (30.0, 31.0):
            out.append([_outcome(r) for r in node.produce_block(t).tx_results])
        got = s2.confirm_tx(res.raw)
        out.append((got[0].height, got[1]))
        node.app.min_gas_price = 0.25
        bob = user.Signer.setup_single(key_cls.from_secret(SECRET["bob"]), node)
        res = bob.submit_tx([msg_send(ADDR["bob"], ADDR["alice"], 10)],
                            fee=fee_cls(amount=1, gas_limit=200_000))
        out.append((_outcome(res), bob.sequence))
        with pytest.raises(ValueError, match="fee payer"):
            bob.submit_tx([msg_send(ADDR["bob"], ADDR["alice"], 1)],
                          opts=user.TxOptions(fee_payer=ADDR["alice"]))
        out.append([_outcome(r) for r in node.produce_block(45.0).tx_results])
        out.append(bob.resync_sequence())
        out.append(_state(node))
        record.append(out)
    assert record[0] == record[1]
    assert [code for code, *_ in record[0][3] + record[0][4]] == [0, 0, 0]
    assert record[0][5] == (3, 0)  # confirmed at height 3
    assert record[0][6][0][0] == 0  # the bumped fee was admitted
    assert [code for code, *_ in record[0][7]] == [0]
