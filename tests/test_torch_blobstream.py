"""Blobstream in the port against the JAX package: Keccak-256 and the
bridge's ABI encodings (``crypto/keccak.py``, ``x/blobstream_abi.py``), and
the keeper (``x/blobstream.py``) behind both Apps over a script of staking
changes, held block by block: every tx's result, the app hash, every
attestation (valsets and data commitments, nonce by nonce), the EVM
addresses, and each attestation's ABI sign bytes.

The Apps run on the CPU with the native backend (the port's App with
``device="cpu"``); the txs are signed by the JAX package's keys."""

import json

import numpy as np
import pytest

from celestia_tpu.app.app import App as JApp
from celestia_tpu.crypto import PrivateKey
from celestia_tpu.crypto import keccak as jkeccak
from celestia_tpu.tx import Fee, sign_tx
from celestia_tpu.x import blobstream_abi as jabi
from celestia_tpu.x.blobstream import MsgRegisterEVMAddress
from celestia_tpu.x.staking import MsgDelegate, MsgUndelegate
from celestia_tpu_torch.app.app import App as PApp
from celestia_tpu_torch.crypto import keccak as pkeccak
from celestia_tpu_torch.x import blobstream_abi as pabi

CHAIN = "blobstream-test"
KEYS = {name: PrivateKey.from_secret(b"bs-" + name.encode())
        for name in ("alice", "val1", "val2", "val3")}
ADDR = {name: key.bech32_address() for name, key in KEYS.items()}
ACCOUNT = {"alice": 0, "val1": 1, "val2": 2, "val3": 3}  # genesis order
BOND = 50_000_000
WINDOW = 4  # the data commitment window, so a dozen blocks see three


def test_keccak256_vectors_and_every_length_are_the_jax_packages():
    assert pkeccak.keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    assert pkeccak.keccak256(b"abc").hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")
    rng = np.random.default_rng(7)
    for n in list(range(0, 300)) + [1000, 4096]:  # every rate boundary to 2 blocks
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert pkeccak.keccak256(data) == jkeccak.keccak256(data), n


def test_the_abi_encodings_are_the_jax_packages():
    rng = np.random.default_rng(3)
    members = [{"evm_address": "0x" + rng.integers(0, 256, 20, dtype=np.uint8).tobytes().hex(),
                "power": int(p)} for p in rng.integers(1, 2**31, 5)]
    for f in ("encode_validator_set", "validator_set_hash", "two_thirds_threshold"):
        assert getattr(pabi, f)(members) == getattr(jabi, f)(members), f
    assert pabi.valset_sign_bytes(9, members) == jabi.valset_sign_bytes(9, members)
    for m in members:
        assert pabi.eip55_checksum_address(m["evm_address"]) == \
            jabi.eip55_checksum_address(m["evm_address"])
    heights = list(range(1, 14))
    roots = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in heights]
    tuples = [pabi.encode_data_root_tuple(h, r) for h, r in zip(heights, roots)]
    assert tuples == [jabi.encode_data_root_tuple(h, r) for h, r in zip(heights, roots)]
    root = pabi.data_root_tuple_root(tuples)
    assert root == jabi.data_root_tuple_root(tuples)
    assert pabi.data_commitment_sign_bytes(4, root) == jabi.data_commitment_sign_bytes(4, root)
    for target in (1, 7, 13):
        mine = pabi.prove_data_root_inclusion_with_root(heights, roots, target)
        theirs = jabi.prove_data_root_inclusion_with_root(heights, roots, target)
        assert mine[0] == theirs[0] == root
        assert mine[1].to_json() == theirs[1].to_json()
        assert mine[1].verify(root)
        assert jabi.DataRootInclusionProof.from_json(mine[1].to_json()).verify(root)
    with pytest.raises(ValueError, match="not in commitment range"):
        pabi.prove_data_root_inclusion(heights, roots, 99)


def _tx(name: str, seq: int, msg) -> bytes:
    return sign_tx(KEYS[name], [msg], CHAIN, ACCOUNT[name], seq,
                   Fee(amount=4_000, gas_limit=400_000)).marshal()


def _evm(i: int) -> str:
    return "0x" + bytes([0x10 * i + j for j in range(20)]).hex()


# the script: per block, (signer, Msg) in order; sequences are counted
SCRIPT = [
    [],
    [("val1", MsgRegisterEVMAddress(ADDR["val1"], _evm(1)))],
    [("alice", MsgDelegate(ADDR["alice"], ADDR["val1"], BOND // 100))],  # 0.5%: no valset
    [("alice", MsgDelegate(ADDR["alice"], ADDR["val2"], BOND))],  # a new valset
    [("val2", MsgRegisterEVMAddress(ADDR["val2"], _evm(2))),
     ("val3", MsgRegisterEVMAddress(ADDR["val2"], _evm(3)))],  # not val3's to register
    [("alice", MsgUndelegate(ADDR["alice"], ADDR["val2"], BOND // 2))],  # unbonding height
    [],
    [("val3", MsgRegisterEVMAddress(ADDR["val3"], "0x1234")),  # invalid address
     ("alice", MsgRegisterEVMAddress(ADDR["alice"], _evm(4)))],  # not a validator
    [("alice", MsgDelegate(ADDR["alice"], ADDR["val3"], 4 * BOND))],
    [("val3", MsgRegisterEVMAddress(ADDR["val3"], _evm(3)))],
    [], [], [],
]


def _attestations(app) -> list:
    bs = app.blobstream
    return [bs.get_attestation(n) for n in range(1, bs.latest_nonce() + 1)]


def test_valsets_data_commitments_and_evm_addresses_block_by_block():
    japp = JApp(chain_id=CHAIN, extend_backend="native")
    papp = PApp(chain_id=CHAIN, extend_backend="native", device="cpu")
    for app in (japp, papp):
        app.init_chain({ADDR["alice"]: 10**12, ADDR["val1"]: 10**9, ADDR["val2"]: 10**9,
                        ADDR["val3"]: 10**9}, genesis_time=0.0,
                       genesis_validators={ADDR["val1"]: BOND, ADDR["val2"]: BOND,
                                           ADDR["val3"]: BOND})
        app.blobstream.data_commitment_window = WINDOW
        app.store.commit_hash_refresh()
    assert japp.store.app_hashes == papp.store.app_hashes
    seqs = dict.fromkeys(KEYS, 0)
    valsets = refused = 0
    for height, block in enumerate(SCRIPT, start=1):
        signed = [(name, _tx(name, seqs[name], msg)) for name, msg in block]
        txs = [raw for _name, raw in signed]
        checked = [[vars(app.check_tx(raw)) for raw in txs] for app in (japp, papp)]
        assert checked[0] == checked[1], height
        # the proposer drops what its ante refuses; a kept tx uses its sequence
        proposal = japp.prepare_proposal(txs)
        assert vars(papp.prepare_proposal(txs)) == vars(proposal)
        assert japp.process_proposal(proposal) and papp.process_proposal(proposal)
        for name, raw in signed:
            seqs[name] += raw in proposal.txs
        results, hashes = [], []
        for app in (japp, papp):
            app.begin_block(15.0 * height)
            results.append([(r.code, r.log, r.gas_wanted, r.gas_used)
                            for r in map(app.deliver_tx, proposal.txs)])
            app.end_block()
            hashes.append(app.commit())
        assert results[0] == results[1], height
        refused += sum(r[0] != 0 for r in results[1])
        assert hashes[0] == hashes[1], height
        mine, theirs = _attestations(papp), _attestations(japp)
        assert json.dumps(mine, sort_keys=True) == json.dumps(theirs, sort_keys=True), height
        for name in ("val1", "val2", "val3"):
            assert papp.blobstream.evm_address(ADDR[name]) == \
                japp.blobstream.evm_address(ADDR[name])
        for att in mine:
            if att["type"] == "valset":
                assert pabi.valset_sign_bytes(att["nonce"], att["members"]) == \
                    jabi.valset_sign_bytes(att["nonce"], att["members"])
        valsets = sum(a["type"] == "valset" for a in mine)
    # what the script meant to reach
    kinds = [a["type"] for a in _attestations(papp)]
    assert valsets >= 3 and kinds.count("data_commitment") == len(SCRIPT) // WINDOW
    assert refused >= 1 and seqs["val3"] == 1
    assert papp.blobstream.evm_address(ADDR["val3"]) == _evm(3)
    assert "0x1234" not in json.dumps(_attestations(papp))
