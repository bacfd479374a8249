"""The port's tx wire format against the JAX package's: every Msg type the
port registers, built and marshalled by the JAX package, decodes in the
port and marshals back to the same bytes, alone and inside a signed tx;
fees with a granter; IndexWrapper-wrapped txs; and the registry's type
URLs, which are the JAX registry's, the IBC and Blobstream messages
included."""

import importlib

import pytest

import celestia_tpu.app.app  # noqa: F401  (fills the JAX registry)
from celestia_tpu import blob as jblob
from celestia_tpu import namespace as jns
from celestia_tpu import tx as jtx
from celestia_tpu.crypto import PrivateKey as JKey
from celestia_tpu.x import authz as jauthz
from celestia_tpu.x import bank as jbank
from celestia_tpu.x import blobstream as jblobstream
from celestia_tpu.x import connection as jconn
from celestia_tpu.x import ibc as jibc
from celestia_tpu.x import lightclient as jlc
from celestia_tpu.x import transfer as jtransfer
from celestia_tpu.x import distribution as jdist
from celestia_tpu.x import feegrant as jfeegrant
from celestia_tpu.x import gov as jgov
from celestia_tpu.x import slashing as jslashing
from celestia_tpu.x import staking as jstaking
from celestia_tpu.x import upgrade as jupgrade
from celestia_tpu.x import vesting as jvesting
from celestia_tpu.x.blob import types as jblobtypes
from celestia_tpu.x.paramfilter import ParamChange
from celestia_tpu_torch import blob as pblob
from celestia_tpu_torch import tx as ptx
from celestia_tpu_torch.crypto import PrivateKey as PKey

# the modules that register the port's Msg types
PORT_MSG_MODULES = ("x.bank", "x.blob", "x.feegrant", "x.vesting", "x.authz", "x.staking",
                    "x.distribution", "x.slashing", "x.gov", "x.upgrade", "x.blobstream",
                    "x.lightclient", "x.connection", "x.ibc", "x.transfer")
for _name in PORT_MSG_MODULES:
    importlib.import_module(f"celestia_tpu_torch.{_name}")

ALICE = JKey.from_secret(b"tx-alice").bech32_address()
BOB = JKey.from_secret(b"tx-bob").bech32_address()
BLOB = jblob.new_blob(jns.new_v0(b"tx-test"), bytes(range(256)) * 7, 0)


def _ibc_fixtures():
    """A JAX SMT proof, a packet, an ack and two signed light-client
    headers for the IBC samples."""
    from celestia_tpu.state import StateStore

    store = StateStore()
    store.set(b"ibc/commitment/x", b"\x42" * 32)
    store.commit()
    _value, _root, proof = store.query_with_proof(b"ibc/commitment/x")
    packet = jibc.Packet(3, "transfer", "channel-0", "transfer", "channel-1",
                         jtransfer.FungibleTokenPacketData("utia", 77, ALICE, BOB).marshal(),
                         timeout_timestamp=90.5)
    val = JKey.from_secret(b"tx-validator")
    headers = [jlc.Header("chain-b", h, 15.0 * h, bytes([h]) * 32,
                          [jlc.ValidatorInfo(val.public_key().hex(), 10)]) for h in (4, 5)]
    signed = [jlc.SignedHeader(h, [(val.public_key().hex(), val.sign(h.sign_bytes()).hex())])
              for h in headers]
    return proof, packet, jibc.Acknowledgement(False, error="denied"), headers, signed


PROOF, PACKET, ACK, HEADERS, SIGNED = _ibc_fixtures()

# one JAX-built instance of every Msg type the port registers
SAMPLES = {
    jblobtypes.URL_MSG_PAY_FOR_BLOBS: jblobtypes.new_msg_pay_for_blobs(ALICE, BLOB),
    jupgrade.URL_MSG_VERSION_CHANGE: jupgrade.MsgVersionChange(2),
    jauthz.URL_MSG_EXEC: jauthz.MsgExec(BOB, [jbank.MsgSend(ALICE, BOB, 17),
                                              jbank.MsgSend(ALICE, BOB, 3, "ibc/ab")]),
    jauthz.URL_MSG_GRANT: jauthz.MsgGrant(ALICE, BOB, jbank.URL_MSG_SEND, 3600.0, 500),
    jauthz.URL_MSG_REVOKE: jauthz.MsgRevoke(ALICE, BOB, jbank.URL_MSG_SEND),
    jbank.URL_MSG_SEND: jbank.MsgSend(ALICE, BOB, 123_456_789),
    jdist.URL_MSG_WITHDRAW_REWARDS: jdist.MsgWithdrawValidatorRewards(ALICE),
    jfeegrant.URL_MSG_GRANT_ALLOWANCE: jfeegrant.MsgGrantAllowance(
        ALICE, BOB, 1_000_000, 7200.0, [jbank.URL_MSG_SEND, jblobtypes.URL_MSG_PAY_FOR_BLOBS]),
    jfeegrant.URL_MSG_REVOKE_ALLOWANCE: jfeegrant.MsgRevokeAllowance(ALICE, BOB),
    jgov.URL_MSG_DEPOSIT: jgov.MsgDeposit(4, BOB, 77),
    jgov.URL_MSG_SUBMIT_PROPOSAL: jgov.MsgSubmitProposal(
        ALICE, [ParamChange("blob", "GasPerBlobByte", "16"),
                ParamChange("staking", "BondDenom", "x")], 10_000),
    jgov.URL_MSG_VOTE: jgov.MsgVote(4, BOB, "no_with_veto"),
    jslashing.URL_MSG_UNJAIL: jslashing.MsgUnjail(ALICE),
    jstaking.URL_MSG_DELEGATE: jstaking.MsgDelegate(ALICE, BOB, 10_000),
    jstaking.URL_MSG_UNDELEGATE: jstaking.MsgUndelegate(ALICE, BOB, 9_999),
    jvesting.URL_MSG_CREATE_PERIODIC_VESTING_ACCOUNT: jvesting.MsgCreatePeriodicVestingAccount(
        ALICE, BOB, [(60.0, 10), (120.5, 20)]),
    jvesting.URL_MSG_CREATE_VESTING_ACCOUNT: jvesting.MsgCreateVestingAccount(
        ALICE, BOB, 5_000, 86_400.0, True),
    jblobstream.URL_MSG_REGISTER_EVM_ADDRESS: jblobstream.MsgRegisterEVMAddress(
        ALICE, "0x" + "ab" * 20),
    jtransfer.URL_MSG_TRANSFER: jtransfer.MsgTransfer(
        "transfer", "channel-0", "utia", 1_000, ALICE, BOB, 120.25, "a memo"),
    jibc.URL_MSG_RECV_PACKET: jibc.MsgRecvPacket(PACKET, BOB, PROOF, 7),
    jibc.URL_MSG_ACKNOWLEDGEMENT: jibc.MsgAcknowledgement(PACKET, ACK, ALICE, PROOF, 8),
    jibc.URL_MSG_TIMEOUT: jibc.MsgTimeout(PACKET, ALICE, PROOF, 9),
    jibc.URL_MSG_CHANNEL_OPEN_INIT: jibc.MsgChannelOpenInit(
        "transfer", "connection-0", "transfer", ALICE),
    jibc.URL_MSG_CHANNEL_OPEN_TRY: jibc.MsgChannelOpenTry(
        "transfer", "connection-1", "transfer", "channel-0", PROOF, 4, BOB),
    jibc.URL_MSG_CHANNEL_OPEN_ACK: jibc.MsgChannelOpenAck(
        "transfer", "channel-0", "channel-1", PROOF, 5, ALICE),
    jibc.URL_MSG_CHANNEL_OPEN_CONFIRM: jibc.MsgChannelOpenConfirm(
        "transfer", "channel-1", PROOF, 6, BOB),
    jconn.URL_MSG_CONNECTION_OPEN_INIT: jconn.MsgConnectionOpenInit(
        "07-tendermint-0", "07-tendermint-1", ALICE),
    jconn.URL_MSG_CONNECTION_OPEN_TRY: jconn.MsgConnectionOpenTry(
        "07-tendermint-1", "07-tendermint-0", "connection-0", PROOF, 4, BOB),
    jconn.URL_MSG_CONNECTION_OPEN_ACK: jconn.MsgConnectionOpenAck(
        "connection-0", "connection-1", PROOF, 5, ALICE),
    jconn.URL_MSG_CONNECTION_OPEN_CONFIRM: jconn.MsgConnectionOpenConfirm(
        "connection-1", PROOF, 6, BOB),
    jlc.URL_MSG_CREATE_CLIENT: jlc.MsgCreateClient(HEADERS[0], ALICE),
    jlc.URL_MSG_UPDATE_CLIENT: jlc.MsgUpdateClient("07-tendermint-0", SIGNED[1], BOB),
    jlc.URL_MSG_SUBMIT_MISBEHAVIOUR: jlc.MsgSubmitMisbehaviour(
        "07-tendermint-0", SIGNED[0], SIGNED[1], ALICE),
}


def test_the_registry_is_the_jax_registry_less_ibc_and_blobstream():
    """The port's registry is the JAX registry, URL for URL: the IBC and
    Blobstream messages it once lacked are ported, and every URL has a
    sample."""
    port, jax = set(ptx._MSG_REGISTRY), set(jtx._MSG_REGISTRY)
    assert port == jax
    assert set(SAMPLES) == port
    assert len([u for u in port if u.startswith(("/ibc.", "/celestia.qgb."))]) == 16


@pytest.mark.parametrize("url", sorted(SAMPLES))
def test_each_msg_decodes_and_marshals_back_to_the_jax_bytes(url):
    jmsg = SAMPLES[url]
    assert type(jmsg).TYPE_URL == url
    raw = jmsg.marshal()
    pmsg = ptx.decode_any(url, raw)
    assert type(pmsg).__module__.startswith("celestia_tpu_torch.")
    assert type(pmsg).TYPE_URL == url
    assert pmsg.marshal() == raw
    assert pmsg.get_signers() == jmsg.get_signers()


def test_an_unknown_type_is_refused_on_both_sides():
    """Unregistered on both sides, alone and inside a tx."""
    for mod in (ptx, jtx):
        with pytest.raises(ValueError, match="unknown message type"):
            mod.decode_any("/no.such.Msg", b"")
    raw = jtx.Tx(msgs=[], signer_infos=[], fee=jtx.Fee(), signatures=[]).marshal()
    any_bytes = ptx._field_bytes(1, b"/no.such.Msg") + ptx._field_bytes_present(2, b"")
    body = ptx._field_bytes(1, any_bytes)
    bad = ptx._field_bytes(1, body) + raw
    for mod in (ptx, jtx):
        with pytest.raises(ValueError, match="unknown message type"):
            mod.Tx.unmarshal(bad)


def _signed_jax_tx(fee) -> bytes:
    key = JKey.from_secret(b"tx-alice")
    msgs = [SAMPLES[jbank.URL_MSG_SEND], SAMPLES[jgov.URL_MSG_VOTE],
            SAMPLES[jauthz.URL_MSG_EXEC]]
    return jtx.sign_tx(key, msgs, "tx-chain", 3, 11, fee, memo="a memo").marshal()


@pytest.mark.parametrize("fee", [
    jtx.Fee(amount=2_000, gas_limit=200_000),
    jtx.Fee(amount=2_000, gas_limit=200_000, payer=ALICE, granter=BOB),
    jtx.Fee(),
], ids=["fee", "fee_with_payer_and_granter", "empty_fee"])
def test_a_jax_signed_tx_decodes_in_the_port_to_the_same_bytes(fee):
    raw = _signed_jax_tx(fee)
    mine, theirs = ptx.decode_tx(raw), jtx.decode_tx(raw)
    assert mine.marshal() == raw
    assert mine.fee == ptx.Fee(**vars(fee)) and mine.fee.marshal() == fee.marshal()
    assert mine.fee.granter == theirs.fee.granter
    assert mine.memo == theirs.memo == "a memo"
    assert [m.marshal() for m in mine.msgs] == [m.marshal() for m in theirs.msgs]
    assert [s.public_key for s in mine.signer_infos] == [s.public_key for s in theirs.signer_infos]
    assert mine.signer_infos[0].sequence == 11
    assert ptx.sign_doc_bytes(mine.body_bytes(), mine.auth_info_bytes(), "tx-chain", 3) == \
        jtx.sign_doc_bytes(theirs.body_bytes(), theirs.auth_info_bytes(), "tx-chain", 3)


def test_a_port_signed_tx_equals_the_jax_packages_but_for_the_signature():
    """Same body and auth info, bytes for bytes; each side verifies the
    other's signature over the same sign doc."""
    from celestia_tpu.crypto import verify_signature as jverify
    from celestia_tpu_torch.crypto import verify_signature as pverify

    fee_args = dict(amount=5, gas_limit=90_000, granter=BOB)
    p = ptx.sign_tx(PKey.from_secret(b"tx-alice"), [ptx.decode_any(
        jbank.URL_MSG_SEND, SAMPLES[jbank.URL_MSG_SEND].marshal())], "c", 1, 2, ptx.Fee(**fee_args))
    j = jtx.sign_tx(JKey.from_secret(b"tx-alice"), [SAMPLES[jbank.URL_MSG_SEND]], "c", 1, 2,
                    jtx.Fee(**fee_args))
    assert p.body_bytes() == j.body_bytes() and p.auth_info_bytes() == j.auth_info_bytes()
    doc = ptx.sign_doc_bytes(p.body_bytes(), p.auth_info_bytes(), "c", 1)
    pub = p.signer_infos[0].public_key
    assert jverify(pub, doc, p.signatures[0]) and pverify(pub, doc, j.signatures[0])
    assert jtx.Tx.unmarshal(p.marshal()).marshal() == p.marshal()


def test_an_index_wrapped_tx_decodes_to_its_inner_tx():
    raw = _signed_jax_tx(jtx.Fee(amount=1, gas_limit=1))
    wrapped = jblob.marshal_index_wrapper(raw, [5, 300, 70_000])
    assert wrapped == pblob.marshal_index_wrapper(raw, [5, 300, 70_000])
    mine, theirs = ptx.decode_tx(wrapped), jtx.decode_tx(wrapped)
    assert mine.marshal() == theirs.marshal() == raw
    with pytest.raises(ValueError):
        ptx.Tx.unmarshal(wrapped)  # the strict decode refuses the wrapper


def test_a_blob_tx_validates_on_both_sides_and_a_flipped_blob_is_refused():
    from celestia_tpu_torch.x.blob import types as pblobtypes

    key = PKey.from_secret(b"tx-alice")
    pb = pblob.new_blob(pblob.ns_pkg.new_v0(b"tx-test"), bytes(range(256)) * 7, 0)
    tx = ptx.sign_tx(key, [pblobtypes.new_msg_pay_for_blobs(key.bech32_address(), pb)],
                     "c", 0, 0, ptx.Fee(amount=1, gas_limit=100_000))
    raw = pblob.marshal_blob_tx(tx.marshal(), [pb])
    assert pblobtypes.validate_blob_tx(pblob.unmarshal_blob_tx(raw)[0]).marshal() == tx.marshal()
    assert jblobtypes.validate_blob_tx(jblob.unmarshal_blob_tx(raw)[0]).marshal() == tx.marshal()
    flipped = pblob.marshal_blob_tx(tx.marshal(), [pblob.new_blob(
        pb.namespace(), bytes([pb.data[0] ^ 1]) + pb.data[1:], 0)])
    for blob_mod, types in ((pblob, pblobtypes), (jblob, jblobtypes)):
        with pytest.raises(ValueError, match="invalid share commitment"):
            types.validate_blob_tx(blob_mod.unmarshal_blob_tx(flipped)[0])
    assert pblobtypes.pfb_blob_sizes(tx.marshal()) == jblobtypes.pfb_blob_sizes(tx.marshal()) \
        == [len(pb.data)]
