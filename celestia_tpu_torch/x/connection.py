"""ICS-3 connection handshake over the 07-tendermint light clients.

The reference wires ibc-go's full core: clients → ICS-3 connections →
ICS-4 channels (app/app.go:359-385). Round 3 of this framework bound
channels to clients directly (the former ADR-004 divergence); this module
closes it: a connection is established purely by relayed handshake
messages, with EVERY step proving the counterparty's recorded connection
state via SMT membership proofs against the already-verified counterparty
app hash (x/lightclient.py verify_membership — the 23-commitment role).

State machine (ibc-go 03-connection):

    chain A                            chain B
    ConnOpenInit    (INIT)      →
                                ←      ConnOpenTry   (TRYOPEN, proves A's INIT)
    ConnOpenAck     (OPEN,      →
      proves B's TRYOPEN)
                                ←      ConnOpenConfirm (OPEN, proves A's OPEN)

Both chains run this framework, so the verifier reconstructs the exact
bytes the counterparty stored (deterministic JSON marshal under the
public `connection_key` proof path) and checks the SMT proof — no trusted
relayer anywhere in the handshake.
"""

from __future__ import annotations

import dataclasses
import json

CONNECTION_PREFIX = b"ibc/connection/"
CONNECTION_COUNTER_KEY = b"ibc/connection/nextSequence"

STATE_INIT = "INIT"
STATE_TRYOPEN = "TRYOPEN"
STATE_OPEN = "OPEN"


def connection_key(connection_id: str) -> bytes:
    """Public proof path of a stored ConnectionEnd (23-commitment key
    scheme — the counterparty proves this key's value under its app
    hash)."""
    return CONNECTION_PREFIX + connection_id.encode()


@dataclasses.dataclass
class ConnectionEnd:
    """One chain's end of a connection (ibc-go ConnectionEnd).

    client_id: OUR client tracking the counterparty chain.
    counterparty_client_id: THEIR client tracking us (agreed in the
    handshake so each side knows which client the other verifies with).
    """

    connection_id: str
    client_id: str
    counterparty_client_id: str
    counterparty_connection_id: str = ""
    state: str = STATE_INIT

    def marshal(self) -> bytes:
        return json.dumps(dataclasses.asdict(self), sort_keys=True).encode()

    @classmethod
    def unmarshal(cls, raw: bytes) -> "ConnectionEnd":
        return cls(**json.loads(raw))


URL_MSG_CONNECTION_OPEN_INIT = "/ibc.core.connection.v1.MsgConnectionOpenInit"
URL_MSG_CONNECTION_OPEN_TRY = "/ibc.core.connection.v1.MsgConnectionOpenTry"
URL_MSG_CONNECTION_OPEN_ACK = "/ibc.core.connection.v1.MsgConnectionOpenAck"
URL_MSG_CONNECTION_OPEN_CONFIRM = (
    "/ibc.core.connection.v1.MsgConnectionOpenConfirm"
)


def _register_connection_msgs():
    from celestia_tpu_torch.blob import _field_bytes, _field_uint
    from celestia_tpu_torch.tx import register_msg
    from celestia_tpu_torch.x.ibc import _marshal_proof, parse_handshake_fields

    @register_msg(URL_MSG_CONNECTION_OPEN_INIT)
    @dataclasses.dataclass
    class MsgConnectionOpenInit:
        """Open a connection INIT end (ibc-go MsgConnectionOpenInit).
        The connection id is assigned server-side (`connection-<n>`)."""

        client_id: str
        counterparty_client_id: str
        signer: str

        def get_signers(self) -> list[str]:
            return [self.signer]

        def marshal(self) -> bytes:
            return (
                _field_bytes(1, self.client_id.encode())
                + _field_bytes(2, self.counterparty_client_id.encode())
                + _field_bytes(3, self.signer.encode())
            )

        @classmethod
        def unmarshal(cls, raw: bytes) -> "MsgConnectionOpenInit":
            s, _p, _h = parse_handshake_fields(raw, (1, 2, 3), 0, 0)
            return cls(s[1], s[2], s[3])

        def validate_basic(self) -> None:
            if not self.client_id or not self.counterparty_client_id:
                raise ValueError("missing client ids")
            if not self.signer:
                raise ValueError("missing signer")

    @register_msg(URL_MSG_CONNECTION_OPEN_TRY)
    @dataclasses.dataclass
    class MsgConnectionOpenTry:
        """TRYOPEN with proof of the counterparty's INIT end (ibc-go
        MsgConnectionOpenTry / proofInit)."""

        client_id: str
        counterparty_client_id: str
        counterparty_connection_id: str
        proof_init: object  # smt.Proof of the counterparty ConnectionEnd
        proof_height: int
        signer: str

        def get_signers(self) -> list[str]:
            return [self.signer]

        def marshal(self) -> bytes:
            return (
                _field_bytes(1, self.client_id.encode())
                + _field_bytes(2, self.counterparty_client_id.encode())
                + _field_bytes(3, self.counterparty_connection_id.encode())
                + _field_bytes(4, _marshal_proof(self.proof_init))
                + _field_uint(5, self.proof_height)
                + _field_bytes(6, self.signer.encode())
            )

        @classmethod
        def unmarshal(cls, raw: bytes) -> "MsgConnectionOpenTry":
            s, proof, height = parse_handshake_fields(raw, (1, 2, 3, 6), 4, 5)
            if proof is None:
                raise ValueError("MsgConnectionOpenTry without proof")
            return cls(s[1], s[2], s[3], proof, height, s[6])

        def validate_basic(self) -> None:
            if not self.client_id or not self.counterparty_client_id:
                raise ValueError("missing client ids")
            if not self.counterparty_connection_id:
                raise ValueError("missing counterparty connection id")
            if self.proof_height <= 0:
                raise ValueError("proof without proof height")
            if not self.signer:
                raise ValueError("missing signer")

    @register_msg(URL_MSG_CONNECTION_OPEN_ACK)
    @dataclasses.dataclass
    class MsgConnectionOpenAck:
        """INIT → OPEN with proof of the counterparty's TRYOPEN end
        (ibc-go MsgConnectionOpenAck / proofTry)."""

        connection_id: str
        counterparty_connection_id: str
        proof_try: object
        proof_height: int
        signer: str

        def get_signers(self) -> list[str]:
            return [self.signer]

        def marshal(self) -> bytes:
            return (
                _field_bytes(1, self.connection_id.encode())
                + _field_bytes(2, self.counterparty_connection_id.encode())
                + _field_bytes(3, _marshal_proof(self.proof_try))
                + _field_uint(4, self.proof_height)
                + _field_bytes(5, self.signer.encode())
            )

        @classmethod
        def unmarshal(cls, raw: bytes) -> "MsgConnectionOpenAck":
            s, proof, height = parse_handshake_fields(raw, (1, 2, 5), 3, 4)
            if proof is None:
                raise ValueError("MsgConnectionOpenAck without proof")
            return cls(s[1], s[2], proof, height, s[5])

        def validate_basic(self) -> None:
            if not self.connection_id or not self.counterparty_connection_id:
                raise ValueError("missing connection ids")
            if self.proof_height <= 0:
                raise ValueError("proof without proof height")
            if not self.signer:
                raise ValueError("missing signer")

    @register_msg(URL_MSG_CONNECTION_OPEN_CONFIRM)
    @dataclasses.dataclass
    class MsgConnectionOpenConfirm:
        """TRYOPEN → OPEN with proof of the counterparty's OPEN end
        (ibc-go MsgConnectionOpenConfirm / proofAck)."""

        connection_id: str
        proof_ack: object
        proof_height: int
        signer: str

        def get_signers(self) -> list[str]:
            return [self.signer]

        def marshal(self) -> bytes:
            return (
                _field_bytes(1, self.connection_id.encode())
                + _field_bytes(2, _marshal_proof(self.proof_ack))
                + _field_uint(3, self.proof_height)
                + _field_bytes(4, self.signer.encode())
            )

        @classmethod
        def unmarshal(cls, raw: bytes) -> "MsgConnectionOpenConfirm":
            s, proof, height = parse_handshake_fields(raw, (1, 4), 2, 3)
            if proof is None:
                raise ValueError("MsgConnectionOpenConfirm without proof")
            return cls(s[1], proof, height, s[4])

        def validate_basic(self) -> None:
            if not self.connection_id:
                raise ValueError("missing connection id")
            if self.proof_height <= 0:
                raise ValueError("proof without proof height")
            if not self.signer:
                raise ValueError("missing signer")

    return (
        MsgConnectionOpenInit,
        MsgConnectionOpenTry,
        MsgConnectionOpenAck,
        MsgConnectionOpenConfirm,
    )


(
    MsgConnectionOpenInit,
    MsgConnectionOpenTry,
    MsgConnectionOpenAck,
    MsgConnectionOpenConfirm,
) = _register_connection_msgs()


class ConnectionKeeper:
    """03-connection keeper over the framework store."""

    def __init__(self, store):
        self.store = store

    def _next_id(self) -> str:
        raw = self.store.get(CONNECTION_COUNTER_KEY)
        seq = int.from_bytes(raw, "big") if raw else 0
        self.store.set(CONNECTION_COUNTER_KEY, (seq + 1).to_bytes(8, "big"))
        return f"connection-{seq}"

    def next_connection_id(self) -> str:
        raw = self.store.get(CONNECTION_COUNTER_KEY)
        return f"connection-{int.from_bytes(raw, 'big') if raw else 0}"

    def get_connection(self, connection_id: str) -> ConnectionEnd | None:
        raw = self.store.get(connection_key(connection_id))
        return ConnectionEnd.unmarshal(raw) if raw else None

    def _set(self, conn: ConnectionEnd) -> None:
        self.store.set(connection_key(conn.connection_id), conn.marshal())

    def _clients(self):
        from celestia_tpu_torch.x.lightclient import ClientKeeper

        return ClientKeeper(self.store)

    def _require_client(self, client_id: str) -> None:
        if self._clients().get_client(client_id) is None:
            raise ValueError(f"unknown client {client_id}")

    # --- handshake steps ---

    def open_init(
        self, client_id: str, counterparty_client_id: str
    ) -> ConnectionEnd:
        """ConnOpenInit: record our INIT end (no proof — this is the
        first message of the handshake)."""
        self._require_client(client_id)
        conn = ConnectionEnd(
            connection_id=self._next_id(),
            client_id=client_id,
            counterparty_client_id=counterparty_client_id,
            state=STATE_INIT,
        )
        self._set(conn)
        return conn

    def open_try(
        self,
        client_id: str,
        counterparty_client_id: str,
        counterparty_connection_id: str,
        proof_init,
        proof_height: int,
    ) -> ConnectionEnd:
        """ConnOpenTry: verify the counterparty recorded the matching
        INIT end, then record our TRYOPEN end.

        The expected counterparty bytes are reconstructed exactly
        (deterministic marshal; both chains run this framework):
        its client_id is `counterparty_client_id` (their client tracking
        us... from OUR naming: the client THEY verify us with), and its
        counterparty_client_id must be OUR client_id — a cross-binding
        that prevents a handshake spliced across client pairs."""
        self._require_client(client_id)
        expected = ConnectionEnd(
            connection_id=counterparty_connection_id,
            client_id=counterparty_client_id,
            counterparty_client_id=client_id,
            counterparty_connection_id="",
            state=STATE_INIT,
        )
        self._clients().verify_membership(
            client_id,
            proof_height,
            connection_key(counterparty_connection_id),
            expected.marshal(),
            proof_init,
        )
        conn = ConnectionEnd(
            connection_id=self._next_id(),
            client_id=client_id,
            counterparty_client_id=counterparty_client_id,
            counterparty_connection_id=counterparty_connection_id,
            state=STATE_TRYOPEN,
        )
        self._set(conn)
        return conn

    def open_ack(
        self,
        connection_id: str,
        counterparty_connection_id: str,
        proof_try,
        proof_height: int,
    ) -> ConnectionEnd:
        """ConnOpenAck: our INIT end opens after verifying the
        counterparty's TRYOPEN end references this very connection."""
        conn = self.get_connection(connection_id)
        if conn is None:
            raise ValueError(f"unknown connection {connection_id}")
        if conn.state != STATE_INIT:
            raise ValueError(
                f"connection {connection_id} is {conn.state}, expected INIT"
            )
        expected = ConnectionEnd(
            connection_id=counterparty_connection_id,
            client_id=conn.counterparty_client_id,
            counterparty_client_id=conn.client_id,
            counterparty_connection_id=connection_id,
            state=STATE_TRYOPEN,
        )
        self._clients().verify_membership(
            conn.client_id,
            proof_height,
            connection_key(counterparty_connection_id),
            expected.marshal(),
            proof_try,
        )
        conn.counterparty_connection_id = counterparty_connection_id
        conn.state = STATE_OPEN
        self._set(conn)
        return conn

    def open_confirm(
        self, connection_id: str, proof_ack, proof_height: int
    ) -> ConnectionEnd:
        """ConnOpenConfirm: our TRYOPEN end opens after verifying the
        counterparty's end is OPEN and bound to us."""
        conn = self.get_connection(connection_id)
        if conn is None:
            raise ValueError(f"unknown connection {connection_id}")
        if conn.state != STATE_TRYOPEN:
            raise ValueError(
                f"connection {connection_id} is {conn.state}, expected TRYOPEN"
            )
        expected = ConnectionEnd(
            connection_id=conn.counterparty_connection_id,
            client_id=conn.counterparty_client_id,
            counterparty_client_id=conn.client_id,
            counterparty_connection_id=connection_id,
            state=STATE_OPEN,
        )
        self._clients().verify_membership(
            conn.client_id,
            proof_height,
            connection_key(conn.counterparty_connection_id),
            expected.marshal(),
            proof_ack,
        )
        conn.state = STATE_OPEN
        self._set(conn)
        return conn

    def require_open(self, connection_id: str) -> ConnectionEnd:
        conn = self.get_connection(connection_id)
        if conn is None:
            raise ValueError(f"unknown connection {connection_id}")
        if conn.state != STATE_OPEN:
            raise ValueError(
                f"connection {connection_id} is {conn.state}, not OPEN"
            )
        return conn
