"""IBC core subset — channels, packets, commitments, acknowledgements.

The reference wires ibc-go v6 core (app/app.go:137-157 ModuleBasics,
transfer stack app/app.go:370-385). This module provides the channel/
packet substrate that the ICS-20 transfer app (x/transfer.py) and the
tokenfilter middleware (x/tokenfilter.py) run on:

- channel registry (04-channel subset: OPEN channels with counterparties;
  the handshake itself is out of scope — test networks open channel pairs
  directly, the way ibctesting's coordinator does)
- send path: monotonic per-channel send sequences + packet commitments
  (sha256 of the packet's deterministic encoding)
- receive path: packet receipts for replay protection + written
  acknowledgements
- ack path: sender-side commitment verification + deletion on
  acknowledgement, with the ack routed back to the sending application

Packet verification comes in two trust models, selected per channel:

- **light-client mode** (the reference's model, `Channel.client_id`
  set): packet messages carry SMT commitment proofs + a proof height;
  the handler verifies them against the counterparty app hash tracked
  by the 02-client analogue (x/lightclient.py). No relayer
  registration — any account that can produce a valid proof may relay,
  exactly like ibc-go. MsgTimeout requires a receipt *absence* proof,
  so a relayer cannot deliver on the destination and still claim a
  timeout refund on the source (the double-credit a pure clock check
  would allow).
- **trusted-relayer mode** (`client_id` empty — legacy/test substrate):
  packet-bearing messages are only accepted from relayer accounts
  registered in the channel keeper (register_relayer). That trust is
  ENFORCED, not assumed — but it is a materially weaker model: a
  registered relayer can forge packets and double-credit via
  recv+timeout. Production channels should bind a client.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

CHANNEL_PREFIX = b"ibc/channel/"
NEXT_SEQUENCE_SEND_PREFIX = b"ibc/nextSequenceSend/"
COMMITMENT_PREFIX = b"ibc/commitment/"
RECEIPT_PREFIX = b"ibc/receipt/"
ACK_PREFIX = b"ibc/ack/"
PACKET_PREFIX = b"ibc/packet/"  # full packet JSON, for relayers/queries
RELAYER_PREFIX = b"ibc/relayer/"  # authorized relayer accounts

CHANNEL_COUNTER_KEY = b"ibc/channel/nextSequence"

CHANNEL_STATE_INIT = "INIT"
CHANNEL_STATE_TRYOPEN = "TRYOPEN"
CHANNEL_STATE_OPEN = "OPEN"
CHANNEL_STATE_CLOSED = "CLOSED"


@dataclasses.dataclass
class Channel:
    port_id: str
    channel_id: str
    counterparty_port_id: str
    counterparty_channel_id: str
    state: str = CHANNEL_STATE_OPEN
    # Trust binding, one of:
    # - connection_id set (ibc-go's model): the channel was established
    #   by the ICS-4 handshake over an ICS-3 connection; packet proofs
    #   verify against the connection's client.
    # - client_id set: direct client binding (shortcut for tests that
    #   skip the handshake, kept for compatibility).
    # - neither: legacy trusted-relayer substrate (documented weaker
    #   trust; packet messages require relayer registration).
    client_id: str = ""
    connection_id: str = ""

    def marshal(self) -> bytes:
        return json.dumps(dataclasses.asdict(self), sort_keys=True).encode()

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Channel":
        return cls(**json.loads(raw))


@dataclasses.dataclass
class Packet:
    """04-channel Packet. data is the app-level payload (ICS-20 uses the
    JSON FungibleTokenPacketData encoding)."""

    sequence: int
    source_port: str
    source_channel: str
    destination_port: str
    destination_channel: str
    data: bytes
    timeout_timestamp: float = 0.0  # 0 = no timeout

    def commitment(self) -> bytes:
        """sha256 over the deterministic encoding (04-channel commits to
        sha256(timeout ‖ data hash) — same fixpoint: commitment binds the
        packet content and timeout)."""
        payload = json.dumps(
            {
                "sequence": self.sequence,
                "source_port": self.source_port,
                "source_channel": self.source_channel,
                "destination_port": self.destination_port,
                "destination_channel": self.destination_channel,
                "data": self.data.hex(),
                "timeout_timestamp": self.timeout_timestamp,
            },
            sort_keys=True,
        ).encode()
        return hashlib.sha256(payload).digest()

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["data"] = self.data.hex()
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Packet":
        d = dict(d)
        d["data"] = bytes.fromhex(d["data"])
        return cls(**d)


@dataclasses.dataclass
class Acknowledgement:
    """ICS-20 style result/error ack (channeltypes.Acknowledgement)."""

    success: bool
    result: bytes = b"\x01"
    error: str = ""

    def marshal(self) -> bytes:
        if self.success:
            return json.dumps({"result": self.result.hex()}).encode()
        return json.dumps({"error": self.error}).encode()

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Acknowledgement":
        d = json.loads(raw)
        if "error" in d:
            return cls(success=False, error=d["error"])
        return cls(success=True, result=bytes.fromhex(d.get("result", "01")))


URL_MSG_RECV_PACKET = "/ibc.core.channel.v1.MsgRecvPacket"
URL_MSG_ACKNOWLEDGEMENT = "/ibc.core.channel.v1.MsgAcknowledgement"
URL_MSG_TIMEOUT = "/ibc.core.channel.v1.MsgTimeout"


def _marshal_proof(proof) -> bytes:
    """smt.Proof → deterministic JSON bytes for the wire."""
    return json.dumps(proof.marshal(), sort_keys=True).encode()


def _unmarshal_proof(raw: bytes):
    from celestia_tpu_torch import smt as smt_mod

    return smt_mod.Proof.unmarshal(json.loads(raw))


def parse_handshake_fields(raw: bytes, str_tags, proof_tag: int,
                           height_tag: int):
    """Shared wire parser for the ICS-3/ICS-4 handshake messages: a set
    of string fields plus an optional (proof, height) pair. Returns
    ({tag: str}, proof | None, height)."""
    from celestia_tpu_torch.blob import _parse_fields, _require_wt

    s = {t: "" for t in str_tags}
    proof, height = None, 0
    for tag, wt, val in _parse_fields(raw):
        if tag in s:
            _require_wt(wt, 2, tag)
            s[tag] = bytes(val).decode()
        elif tag == proof_tag:
            _require_wt(wt, 2, tag)
            proof = _unmarshal_proof(bytes(val))
        elif tag == height_tag:
            _require_wt(wt, 0, tag)
            height = val
    return s, proof, height


def _register_packet_msgs():
    from celestia_tpu_torch.blob import (
        _field_bytes,
        _field_uint,
        _parse_fields,
        _require_wt,
    )
    from celestia_tpu_torch.tx import register_msg

    @register_msg(URL_MSG_RECV_PACKET)
    @dataclasses.dataclass
    class MsgRecvPacket:
        """Relayer-submitted packet delivery (04-channel MsgRecvPacket).

        On a client-bound channel, `proof`/`proof_height` must prove the
        packet commitment under the counterparty app hash at that
        verified height (ibc-go's proofCommitment)."""

        packet: Packet
        signer: str  # the relayer
        proof: object | None = None  # smt.Proof of the packet commitment
        proof_height: int = 0

        def get_signers(self) -> list[str]:
            return [self.signer]

        def marshal(self) -> bytes:
            out = _field_bytes(
                1, json.dumps(self.packet.to_json(), sort_keys=True).encode()
            ) + _field_bytes(2, self.signer.encode())
            if self.proof is not None:
                out += _field_bytes(3, _marshal_proof(self.proof))
                out += _field_uint(4, self.proof_height)
            return out

        @classmethod
        def unmarshal(cls, raw: bytes) -> "MsgRecvPacket":
            packet, signer, proof, height = None, "", None, 0
            for tag, wt, val in _parse_fields(raw):
                if tag == 1:
                    _require_wt(wt, 2, tag)
                    packet = Packet.from_json(json.loads(bytes(val)))
                elif tag == 2:
                    _require_wt(wt, 2, tag)
                    signer = bytes(val).decode()
                elif tag == 3:
                    _require_wt(wt, 2, tag)
                    proof = _unmarshal_proof(bytes(val))
                elif tag == 4:
                    _require_wt(wt, 0, tag)
                    height = val
            if packet is None:
                raise ValueError("MsgRecvPacket without packet")
            return cls(packet, signer, proof, height)

        def validate_basic(self) -> None:
            if not self.signer:
                raise ValueError("missing relayer signer")
            if self.proof is not None and self.proof_height <= 0:
                raise ValueError("proof without proof height")

    @register_msg(URL_MSG_ACKNOWLEDGEMENT)
    @dataclasses.dataclass
    class MsgAcknowledgement:
        """Relayer-submitted ack delivery (04-channel MsgAcknowledgement).

        On a client-bound channel, `proof`/`proof_height` must prove the
        written ack bytes under the counterparty app hash (proofAcked)."""

        packet: Packet
        acknowledgement: Acknowledgement
        signer: str
        proof: object | None = None  # smt.Proof of the written ack
        proof_height: int = 0

        def get_signers(self) -> list[str]:
            return [self.signer]

        def marshal(self) -> bytes:
            out = (
                _field_bytes(
                    1, json.dumps(self.packet.to_json(), sort_keys=True).encode()
                )
                + _field_bytes(2, self.acknowledgement.marshal())
                + _field_bytes(3, self.signer.encode())
            )
            if self.proof is not None:
                out += _field_bytes(4, _marshal_proof(self.proof))
                out += _field_uint(5, self.proof_height)
            return out

        @classmethod
        def unmarshal(cls, raw: bytes) -> "MsgAcknowledgement":
            packet, ack, signer, proof, height = None, None, "", None, 0
            for tag, wt, val in _parse_fields(raw):
                if tag == 1:
                    _require_wt(wt, 2, tag)
                    packet = Packet.from_json(json.loads(bytes(val)))
                elif tag == 2:
                    _require_wt(wt, 2, tag)
                    ack = Acknowledgement.unmarshal(bytes(val))
                elif tag == 3:
                    _require_wt(wt, 2, tag)
                    signer = bytes(val).decode()
                elif tag == 4:
                    _require_wt(wt, 2, tag)
                    proof = _unmarshal_proof(bytes(val))
                elif tag == 5:
                    _require_wt(wt, 0, tag)
                    height = val
            if packet is None or ack is None:
                raise ValueError("MsgAcknowledgement missing packet/ack")
            return cls(packet, ack, signer, proof, height)

        def validate_basic(self) -> None:
            if not self.signer:
                raise ValueError("missing relayer signer")
            if self.proof is not None and self.proof_height <= 0:
                raise ValueError("proof without proof height")

    @register_msg(URL_MSG_TIMEOUT)
    @dataclasses.dataclass
    class MsgTimeout:
        """Relayer-submitted timeout (04-channel MsgTimeout).

        On a client-bound channel the relayer must prove NON-receipt on
        the counterparty (an SMT absence proof of the receipt key) at a
        verified height whose header time is past the packet timeout —
        ibc-go's proofUnreceived. That closes the recv+timeout
        double-credit a bare clock check allows. On a legacy channel the
        sending chain checks only that the timeout has objectively
        elapsed on its own clock (documented weaker trust: a registered
        relayer could deliver on the destination and still refund)."""

        packet: Packet
        signer: str
        proof: object | None = None  # smt.Proof of receipt ABSENCE
        proof_height: int = 0

        def get_signers(self) -> list[str]:
            return [self.signer]

        def marshal(self) -> bytes:
            out = _field_bytes(
                1, json.dumps(self.packet.to_json(), sort_keys=True).encode()
            ) + _field_bytes(2, self.signer.encode())
            if self.proof is not None:
                out += _field_bytes(3, _marshal_proof(self.proof))
                out += _field_uint(4, self.proof_height)
            return out

        @classmethod
        def unmarshal(cls, raw: bytes) -> "MsgTimeout":
            packet, signer, proof, height = None, "", None, 0
            for tag, wt, val in _parse_fields(raw):
                if tag == 1:
                    _require_wt(wt, 2, tag)
                    packet = Packet.from_json(json.loads(bytes(val)))
                elif tag == 2:
                    _require_wt(wt, 2, tag)
                    signer = bytes(val).decode()
                elif tag == 3:
                    _require_wt(wt, 2, tag)
                    proof = _unmarshal_proof(bytes(val))
                elif tag == 4:
                    _require_wt(wt, 0, tag)
                    height = val
            if packet is None:
                raise ValueError("MsgTimeout without packet")
            return cls(packet, signer, proof, height)

        def validate_basic(self) -> None:
            if not self.signer:
                raise ValueError("missing relayer signer")
            if not self.packet.timeout_timestamp:
                raise ValueError("packet has no timeout to elapse")
            if self.proof is not None and self.proof_height <= 0:
                raise ValueError("proof without proof height")

    return MsgRecvPacket, MsgAcknowledgement, MsgTimeout


MsgRecvPacket, MsgAcknowledgement, MsgTimeout = _register_packet_msgs()


URL_MSG_CHANNEL_OPEN_INIT = "/ibc.core.channel.v1.MsgChannelOpenInit"
URL_MSG_CHANNEL_OPEN_TRY = "/ibc.core.channel.v1.MsgChannelOpenTry"
URL_MSG_CHANNEL_OPEN_ACK = "/ibc.core.channel.v1.MsgChannelOpenAck"
URL_MSG_CHANNEL_OPEN_CONFIRM = "/ibc.core.channel.v1.MsgChannelOpenConfirm"


def _register_channel_msgs():
    from celestia_tpu_torch.blob import _field_bytes, _field_uint
    from celestia_tpu_torch.tx import register_msg

    _strings = parse_handshake_fields

    @register_msg(URL_MSG_CHANNEL_OPEN_INIT)
    @dataclasses.dataclass
    class MsgChannelOpenInit:
        """Open a channel INIT end over a connection (ibc-go
        MsgChannelOpenInit; channel id assigned server-side)."""

        port_id: str
        connection_id: str
        counterparty_port_id: str
        signer: str

        def get_signers(self) -> list[str]:
            return [self.signer]

        def marshal(self) -> bytes:
            return (
                _field_bytes(1, self.port_id.encode())
                + _field_bytes(2, self.connection_id.encode())
                + _field_bytes(3, self.counterparty_port_id.encode())
                + _field_bytes(4, self.signer.encode())
            )

        @classmethod
        def unmarshal(cls, raw: bytes) -> "MsgChannelOpenInit":
            s, _p, _h = _strings(raw, (1, 2, 3, 4), 0, 0)
            return cls(s[1], s[2], s[3], s[4])

        def validate_basic(self) -> None:
            if not self.port_id or not self.connection_id:
                raise ValueError("missing port/connection id")
            if not self.counterparty_port_id:
                raise ValueError("missing counterparty port id")
            if not self.signer:
                raise ValueError("missing signer")

    @register_msg(URL_MSG_CHANNEL_OPEN_TRY)
    @dataclasses.dataclass
    class MsgChannelOpenTry:
        """TRYOPEN with proof of the counterparty's INIT channel end."""

        port_id: str
        connection_id: str
        counterparty_port_id: str
        counterparty_channel_id: str
        proof_init: object
        proof_height: int
        signer: str

        def get_signers(self) -> list[str]:
            return [self.signer]

        def marshal(self) -> bytes:
            return (
                _field_bytes(1, self.port_id.encode())
                + _field_bytes(2, self.connection_id.encode())
                + _field_bytes(3, self.counterparty_port_id.encode())
                + _field_bytes(4, self.counterparty_channel_id.encode())
                + _field_bytes(5, _marshal_proof(self.proof_init))
                + _field_uint(6, self.proof_height)
                + _field_bytes(7, self.signer.encode())
            )

        @classmethod
        def unmarshal(cls, raw: bytes) -> "MsgChannelOpenTry":
            s, proof, height = _strings(raw, (1, 2, 3, 4, 7), 5, 6)
            if proof is None:
                raise ValueError("MsgChannelOpenTry without proof")
            return cls(s[1], s[2], s[3], s[4], proof, height, s[7])

        def validate_basic(self) -> None:
            if not self.port_id or not self.connection_id:
                raise ValueError("missing port/connection id")
            if not self.counterparty_port_id or not self.counterparty_channel_id:
                raise ValueError("missing counterparty ids")
            if self.proof_height <= 0:
                raise ValueError("proof without proof height")
            if not self.signer:
                raise ValueError("missing signer")

    @register_msg(URL_MSG_CHANNEL_OPEN_ACK)
    @dataclasses.dataclass
    class MsgChannelOpenAck:
        """INIT → OPEN with proof of the counterparty's TRYOPEN end."""

        port_id: str
        channel_id: str
        counterparty_channel_id: str
        proof_try: object
        proof_height: int
        signer: str

        def get_signers(self) -> list[str]:
            return [self.signer]

        def marshal(self) -> bytes:
            return (
                _field_bytes(1, self.port_id.encode())
                + _field_bytes(2, self.channel_id.encode())
                + _field_bytes(3, self.counterparty_channel_id.encode())
                + _field_bytes(4, _marshal_proof(self.proof_try))
                + _field_uint(5, self.proof_height)
                + _field_bytes(6, self.signer.encode())
            )

        @classmethod
        def unmarshal(cls, raw: bytes) -> "MsgChannelOpenAck":
            s, proof, height = _strings(raw, (1, 2, 3, 6), 4, 5)
            if proof is None:
                raise ValueError("MsgChannelOpenAck without proof")
            return cls(s[1], s[2], s[3], proof, height, s[6])

        def validate_basic(self) -> None:
            if not self.port_id or not self.channel_id:
                raise ValueError("missing port/channel id")
            if not self.counterparty_channel_id:
                raise ValueError("missing counterparty channel id")
            if self.proof_height <= 0:
                raise ValueError("proof without proof height")
            if not self.signer:
                raise ValueError("missing signer")

    @register_msg(URL_MSG_CHANNEL_OPEN_CONFIRM)
    @dataclasses.dataclass
    class MsgChannelOpenConfirm:
        """TRYOPEN → OPEN with proof of the counterparty's OPEN end."""

        port_id: str
        channel_id: str
        proof_ack: object
        proof_height: int
        signer: str

        def get_signers(self) -> list[str]:
            return [self.signer]

        def marshal(self) -> bytes:
            return (
                _field_bytes(1, self.port_id.encode())
                + _field_bytes(2, self.channel_id.encode())
                + _field_bytes(3, _marshal_proof(self.proof_ack))
                + _field_uint(4, self.proof_height)
                + _field_bytes(5, self.signer.encode())
            )

        @classmethod
        def unmarshal(cls, raw: bytes) -> "MsgChannelOpenConfirm":
            s, proof, height = _strings(raw, (1, 2, 5), 3, 4)
            if proof is None:
                raise ValueError("MsgChannelOpenConfirm without proof")
            return cls(s[1], s[2], proof, height, s[5])

        def validate_basic(self) -> None:
            if not self.port_id or not self.channel_id:
                raise ValueError("missing port/channel id")
            if self.proof_height <= 0:
                raise ValueError("proof without proof height")
            if not self.signer:
                raise ValueError("missing signer")

    return (
        MsgChannelOpenInit,
        MsgChannelOpenTry,
        MsgChannelOpenAck,
        MsgChannelOpenConfirm,
    )


(
    MsgChannelOpenInit,
    MsgChannelOpenTry,
    MsgChannelOpenAck,
    MsgChannelOpenConfirm,
) = _register_channel_msgs()


def _chan_key(prefix: bytes, port_id: str, channel_id: str) -> bytes:
    return prefix + port_id.encode() + b"/" + channel_id.encode()


def _seq_key(prefix: bytes, port_id: str, channel_id: str, seq: int) -> bytes:
    return _chan_key(prefix, port_id, channel_id) + b"/" + seq.to_bytes(8, "big")


# Public proof paths (23-commitment key scheme): both chains run this
# framework, so a verifier can reconstruct the exact store key the
# counterparty used and check the SMT proof against its app hash.

def channel_key(port_id: str, channel_id: str) -> bytes:
    """Proof path of a stored Channel — the ICS-4 handshake proves the
    counterparty's channel end under this key."""
    return _chan_key(CHANNEL_PREFIX, port_id, channel_id)


def packet_commitment_key(port_id: str, channel_id: str, seq: int) -> bytes:
    return _seq_key(COMMITMENT_PREFIX, port_id, channel_id, seq)


def packet_receipt_key(port_id: str, channel_id: str, seq: int) -> bytes:
    return _seq_key(RECEIPT_PREFIX, port_id, channel_id, seq)


def packet_ack_key(port_id: str, channel_id: str, seq: int) -> bytes:
    return _seq_key(ACK_PREFIX, port_id, channel_id, seq)


class ChannelKeeper:
    """04-channel keeper subset over the framework store."""

    def __init__(self, store):
        self.store = store

    # --- channel registry ---

    def set_channel(self, channel: Channel) -> None:
        self.store.set(
            _chan_key(CHANNEL_PREFIX, channel.port_id, channel.channel_id),
            channel.marshal(),
        )

    def get_channel(self, port_id: str, channel_id: str) -> Channel | None:
        raw = self.store.get(_chan_key(CHANNEL_PREFIX, port_id, channel_id))
        return Channel.unmarshal(raw) if raw else None

    def open_channel(
        self,
        port_id: str,
        channel_id: str,
        counterparty_port_id: str,
        counterparty_channel_id: str,
        client_id: str = "",
    ) -> Channel:
        """Direct OPEN (the post-handshake state ibctesting coordinators
        drive the four-step handshake to). Pass `client_id` to bind the
        channel to a light client — packet messages then require proofs
        instead of relayer registration."""
        ch = Channel(
            port_id, channel_id, counterparty_port_id,
            counterparty_channel_id, client_id=client_id,
        )
        self.set_channel(ch)
        return ch

    # --- ICS-4 channel handshake (over an ICS-3 connection) ---

    def _next_channel_id(self) -> str:
        raw = self.store.get(CHANNEL_COUNTER_KEY)
        seq = int.from_bytes(raw, "big") if raw else 0
        self.store.set(CHANNEL_COUNTER_KEY, (seq + 1).to_bytes(8, "big"))
        return f"channel-{seq}"

    def next_channel_id(self) -> str:
        raw = self.store.get(CHANNEL_COUNTER_KEY)
        return f"channel-{int.from_bytes(raw, 'big') if raw else 0}"

    def _connections(self):
        from celestia_tpu_torch.x.connection import ConnectionKeeper

        return ConnectionKeeper(self.store)

    def chan_open_init(
        self, port_id: str, connection_id: str, counterparty_port_id: str
    ) -> Channel:
        """ChanOpenInit: record our INIT end over an OPEN connection
        (ibc-go 04-channel ChanOpenInit; channel id assigned
        server-side)."""
        self._connections().require_open(connection_id)
        ch = Channel(
            port_id=port_id,
            channel_id=self._next_channel_id(),
            counterparty_port_id=counterparty_port_id,
            counterparty_channel_id="",
            state=CHANNEL_STATE_INIT,
            connection_id=connection_id,
        )
        self.set_channel(ch)
        return ch

    def chan_open_try(
        self,
        port_id: str,
        connection_id: str,
        counterparty_port_id: str,
        counterparty_channel_id: str,
        proof_init,
        proof_height: int,
    ) -> Channel:
        """ChanOpenTry: verify the counterparty recorded the matching
        INIT channel end (under ITS connection — the other end of ours),
        then record our TRYOPEN end."""
        conn = self._connections().require_open(connection_id)
        expected = Channel(
            port_id=counterparty_port_id,
            channel_id=counterparty_channel_id,
            counterparty_port_id=port_id,
            counterparty_channel_id="",
            state=CHANNEL_STATE_INIT,
            connection_id=conn.counterparty_connection_id,
        )
        self._clients().verify_membership(
            conn.client_id,
            proof_height,
            channel_key(counterparty_port_id, counterparty_channel_id),
            expected.marshal(),
            proof_init,
        )
        ch = Channel(
            port_id=port_id,
            channel_id=self._next_channel_id(),
            counterparty_port_id=counterparty_port_id,
            counterparty_channel_id=counterparty_channel_id,
            state=CHANNEL_STATE_TRYOPEN,
            connection_id=connection_id,
        )
        self.set_channel(ch)
        return ch

    def chan_open_ack(
        self,
        port_id: str,
        channel_id: str,
        counterparty_channel_id: str,
        proof_try,
        proof_height: int,
    ) -> Channel:
        """ChanOpenAck: our INIT end opens after verifying the
        counterparty's TRYOPEN end references this very channel."""
        ch = self.get_channel(port_id, channel_id)
        if ch is None:
            raise ValueError(f"unknown channel {port_id}/{channel_id}")
        if ch.state != CHANNEL_STATE_INIT:
            raise ValueError(
                f"channel {port_id}/{channel_id} is {ch.state}, expected INIT"
            )
        conn = self._connections().require_open(ch.connection_id)
        expected = Channel(
            port_id=ch.counterparty_port_id,
            channel_id=counterparty_channel_id,
            counterparty_port_id=port_id,
            counterparty_channel_id=channel_id,
            state=CHANNEL_STATE_TRYOPEN,
            connection_id=conn.counterparty_connection_id,
        )
        self._clients().verify_membership(
            conn.client_id,
            proof_height,
            channel_key(ch.counterparty_port_id, counterparty_channel_id),
            expected.marshal(),
            proof_try,
        )
        ch.counterparty_channel_id = counterparty_channel_id
        ch.state = CHANNEL_STATE_OPEN
        self.set_channel(ch)
        return ch

    def chan_open_confirm(
        self, port_id: str, channel_id: str, proof_ack, proof_height: int
    ) -> Channel:
        """ChanOpenConfirm: our TRYOPEN end opens after verifying the
        counterparty's end is OPEN and bound to us."""
        ch = self.get_channel(port_id, channel_id)
        if ch is None:
            raise ValueError(f"unknown channel {port_id}/{channel_id}")
        if ch.state != CHANNEL_STATE_TRYOPEN:
            raise ValueError(
                f"channel {port_id}/{channel_id} is {ch.state}, "
                "expected TRYOPEN"
            )
        conn = self._connections().require_open(ch.connection_id)
        expected = Channel(
            port_id=ch.counterparty_port_id,
            channel_id=ch.counterparty_channel_id,
            counterparty_port_id=port_id,
            counterparty_channel_id=channel_id,
            state=CHANNEL_STATE_OPEN,
            connection_id=conn.counterparty_connection_id,
        )
        self._clients().verify_membership(
            conn.client_id,
            proof_height,
            channel_key(ch.counterparty_port_id, ch.counterparty_channel_id),
            expected.marshal(),
            proof_ack,
        )
        ch.state = CHANNEL_STATE_OPEN
        self.set_channel(ch)
        return ch

    def _clients(self):
        from celestia_tpu_torch.x.lightclient import ClientKeeper

        return ClientKeeper(self.store)

    def client_for_channel(self, ch: Channel) -> str:
        """The light client packet proofs verify against: the channel's
        direct client binding, else its connection's client, else ""
        (legacy trusted-relayer substrate)."""
        if ch.client_id:
            return ch.client_id
        if ch.connection_id:
            return self._connections().require_open(ch.connection_id).client_id
        return ""

    # --- relayer authorization (stand-in for commitment proofs) ---

    def register_relayer(self, address: str) -> None:
        self.store.set(RELAYER_PREFIX + address.encode(), b"\x01")

    def is_relayer(self, address: str) -> bool:
        return self.store.get(RELAYER_PREFIX + address.encode()) is not None

    def require_relayer(self, address: str) -> None:
        if not self.is_relayer(address):
            raise ValueError(
                f"{address} is not a registered relayer: packet messages "
                "carry no commitment proof in this substrate, so only "
                "registered relayer accounts may deliver them"
            )

    # --- send path ---

    def next_sequence_send(self, port_id: str, channel_id: str) -> int:
        raw = self.store.get(_chan_key(NEXT_SEQUENCE_SEND_PREFIX, port_id, channel_id))
        return int.from_bytes(raw, "big") if raw else 1

    def send_packet(
        self,
        port_id: str,
        channel_id: str,
        data: bytes,
        timeout_timestamp: float = 0.0,
    ) -> Packet:
        ch = self.get_channel(port_id, channel_id)
        if ch is None or ch.state != CHANNEL_STATE_OPEN:
            raise ValueError(f"channel {port_id}/{channel_id} is not open")
        seq = self.next_sequence_send(port_id, channel_id)
        packet = Packet(
            sequence=seq,
            source_port=port_id,
            source_channel=channel_id,
            destination_port=ch.counterparty_port_id,
            destination_channel=ch.counterparty_channel_id,
            data=data,
            timeout_timestamp=timeout_timestamp,
        )
        self.store.set(
            _chan_key(NEXT_SEQUENCE_SEND_PREFIX, port_id, channel_id),
            (seq + 1).to_bytes(8, "big"),
        )
        self.store.set(
            _seq_key(COMMITMENT_PREFIX, port_id, channel_id, seq),
            packet.commitment(),
        )
        self.store.set(
            _seq_key(PACKET_PREFIX, port_id, channel_id, seq),
            json.dumps(packet.to_json(), sort_keys=True).encode(),
        )
        return packet

    def get_packet(self, port_id: str, channel_id: str, seq: int) -> Packet | None:
        raw = self.store.get(_seq_key(PACKET_PREFIX, port_id, channel_id, seq))
        return Packet.from_json(json.loads(raw)) if raw else None

    def pending_packets(self, port_id: str, channel_id: str) -> list[Packet]:
        """Packets sent on this channel whose commitments still stand
        (i.e. not yet acknowledged) — the relayer work queue."""
        out = []
        prefix = _chan_key(COMMITMENT_PREFIX, port_id, channel_id) + b"/"
        for key, _v in self.store.iter_prefix(prefix):
            seq = int.from_bytes(key[len(prefix):], "big")
            packet = self.get_packet(port_id, channel_id, seq)
            if packet is not None:
                out.append(packet)
        return out

    # --- receive path (destination chain) ---

    def recv_packet(self, packet: Packet, block_time: float = 0.0) -> None:
        """Replay protection + receipt + timeout enforcement (04-channel
        RecvPacket checks)."""
        if packet.timeout_timestamp and block_time >= packet.timeout_timestamp:
            raise ValueError(
                f"packet timeout elapsed: timeout {packet.timeout_timestamp}, "
                f"block time {block_time}"
            )
        ch = self.get_channel(packet.destination_port, packet.destination_channel)
        if ch is None or ch.state != CHANNEL_STATE_OPEN:
            raise ValueError(
                f"channel {packet.destination_port}/{packet.destination_channel} "
                "is not open"
            )
        if (
            ch.counterparty_port_id != packet.source_port
            or ch.counterparty_channel_id != packet.source_channel
        ):
            raise ValueError("packet source does not match channel counterparty")
        receipt_key = _seq_key(
            RECEIPT_PREFIX,
            packet.destination_port,
            packet.destination_channel,
            packet.sequence,
        )
        if self.store.get(receipt_key) is not None:
            raise ValueError(f"packet sequence {packet.sequence} already received")
        self.store.set(receipt_key, b"\x01")

    def write_acknowledgement(self, packet: Packet, ack: Acknowledgement) -> None:
        self.store.set(
            _seq_key(
                ACK_PREFIX,
                packet.destination_port,
                packet.destination_channel,
                packet.sequence,
            ),
            ack.marshal(),
        )

    def get_acknowledgement(
        self, port_id: str, channel_id: str, seq: int
    ) -> Acknowledgement | None:
        raw = self.store.get(_seq_key(ACK_PREFIX, port_id, channel_id, seq))
        return Acknowledgement.unmarshal(raw) if raw else None

    # --- acknowledgement / timeout path (source chain) ---

    def acknowledge_packet(self, packet: Packet) -> None:
        """Verify the commitment still stands and clear it."""
        key = _seq_key(
            COMMITMENT_PREFIX, packet.source_port, packet.source_channel,
            packet.sequence,
        )
        stored = self.store.get(key)
        if stored is None:
            raise ValueError(
                f"packet {packet.sequence} has no commitment (already acked?)"
            )
        if stored != packet.commitment():
            raise ValueError("packet commitment mismatch")
        self.store.delete(key)
        self.store.delete(
            _seq_key(PACKET_PREFIX, packet.source_port, packet.source_channel,
                     packet.sequence)
        )

    def timeout_packet(self, packet: Packet, block_time: float) -> None:
        """04-channel TimeoutPacket: the timeout must have objectively
        elapsed (the sending chain's clock) before the commitment is
        cleared for refund. Lives here — not in the msg router — so no
        keeper-level caller can refund early."""
        if not packet.timeout_timestamp:
            raise ValueError("packet has no timeout to elapse")
        if block_time < packet.timeout_timestamp:
            raise ValueError(
                f"packet timeout has not elapsed: timeout "
                f"{packet.timeout_timestamp}, block time {block_time}"
            )
        self.acknowledge_packet(packet)
