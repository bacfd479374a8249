"""IBC test coordinator (port of the JAX package's testutil/ibc.py) — two
in-process chains + a relayer, and a relayer over the public RPC.

The reference exercises its IBC stack through ibctesting's coordinator
(two chains, direct channel opens, manual packet relay). Same shape here:
`open_transfer_channel` puts matching OPEN channels into both chains'
committed stores (the post-handshake state), and `Relayer` carries
pending packets and acknowledgements between the chains as signed
MsgRecvPacket / MsgAcknowledgement txs through the full block pipeline.
"""

from __future__ import annotations

from celestia_tpu_torch.user import Signer
from celestia_tpu_torch.x.ibc import MsgAcknowledgement, MsgRecvPacket, Packet
from celestia_tpu_torch.x.transfer import PORT_ID_TRANSFER


def open_transfer_channel(
    app_a, app_b, channel_a: str = "channel-0", channel_b: str = "channel-0"
) -> None:
    """Direct OPEN on both ends (ibctesting coordinator endpoint state)."""
    app_a.ibc.open_channel(PORT_ID_TRANSFER, channel_a, PORT_ID_TRANSFER, channel_b)
    app_b.ibc.open_channel(PORT_ID_TRANSFER, channel_b, PORT_ID_TRANSFER, channel_a)
    app_a.store.commit_hash_refresh()
    app_b.store.commit_hash_refresh()


class Relayer:
    """Carries packets/acks between two Nodes via signed relay txs."""

    def __init__(self, node_a, node_b, relayer_key_a, relayer_key_b):
        self.node_a = node_a
        self.node_b = node_b
        self.signer_a = Signer.setup_single(relayer_key_a, node_a)
        self.signer_b = Signer.setup_single(relayer_key_b, node_b)
        # packet messages are only accepted from registered relayers (the
        # substrate's stand-in for commitment proofs)
        node_a.app.ibc.register_relayer(self.signer_a.address())
        node_b.app.ibc.register_relayer(self.signer_b.address())
        node_a.app.store.commit_hash_refresh()
        node_b.app.store.commit_hash_refresh()

    def _pending(self, node, channel_id: str) -> list[Packet]:
        return node.app.ibc.pending_packets(PORT_ID_TRANSFER, channel_id)

    def relay(self, block_time_a: float, block_time_b: float,
              channel_a: str = "channel-0", channel_b: str = "channel-0") -> int:
        """One relay round: deliver A→B packets (and acks back to A), then
        B→A packets (and acks back to B). Returns packets delivered."""
        n = self._relay_direction(
            self.node_a, self.node_b, self.signer_b, self.signer_a,
            channel_a, block_time_a, block_time_b,
        )
        n += self._relay_direction(
            self.node_b, self.node_a, self.signer_a, self.signer_b,
            channel_b, block_time_b, block_time_a,
        )
        return n

    def _relay_direction(
        self, src_node, dst_node, dst_signer, src_signer,
        src_channel: str, src_time: float, dst_time: float,
    ) -> int:
        packets = self._pending(src_node, src_channel)
        if not packets:
            return 0
        for packet in packets:
            res = dst_signer.submit_tx(
                [MsgRecvPacket(packet, dst_signer.address())]
            )
            if res.code != 0:
                raise RuntimeError(f"recv relay failed: {res.log}")
        dst_node.produce_block(dst_time)
        for packet in packets:
            ack = dst_node.app.ibc.get_acknowledgement(
                packet.destination_port, packet.destination_channel,
                packet.sequence,
            )
            if ack is None:
                raise RuntimeError(f"no ack written for packet {packet.sequence}")
            res = src_signer.submit_tx(
                [MsgAcknowledgement(packet, ack, src_signer.address())]
            )
            if res.code != 0:
                raise RuntimeError(f"ack relay failed: {res.log}")
        src_node.produce_block(src_time)
        return len(packets)


# --------------------------------------------------------------------- #
# Light-client mode (the reference's trust model — x/lightclient.py)

def add_consensus_validator(app, key, tokens: int) -> None:
    """Bond a validator whose consensus pubkey signs headers (the gentx
    flow plus the SDK's ConsensusPubkey registration)."""
    operator = key.bech32_address()
    app.accounts.get_or_create(operator)
    app.bank.mint(operator, tokens)
    app.staking.delegate(None, operator, operator, tokens)
    v = app.staking.get_validator(operator)
    v.pubkey = key.public_key().hex()
    app.staking.set_validator(v)
    app.store.commit_hash_refresh()


def validator_set(app):
    """The chain's current (pubkey, power) set as the light client sees
    it — only validators that registered a consensus key can sign."""
    from celestia_tpu_torch.x.lightclient import ValidatorInfo

    return [
        ValidatorInfo(pubkey=v.pubkey, power=v.power)
        for v in app.staking.bonded_validators()
        if v.pubkey
    ]


def make_header(node):
    """Unsigned light-client header for the node's latest committed
    state (chain id, height, block time, app hash, next valset)."""
    from celestia_tpu_torch.x.lightclient import Header

    app = node.app
    block = node.get_block(app.height)
    return Header(
        chain_id=app.chain_id,
        height=app.height,
        time=block.time if block else 0.0,
        app_hash=app.store.app_hashes[app.store.version],
        validators=validator_set(app),
    )


def sign_header(header, keys):
    """Produce the commit: each validator key signs the canonical sign
    bytes (tendermint precommit analogue)."""
    from celestia_tpu_torch.x.lightclient import SignedHeader

    sign_bytes = header.sign_bytes()
    return SignedHeader(
        header=header,
        signatures=[
            (k.public_key().hex(), k.sign(sign_bytes).hex()) for k in keys
        ],
    )


def open_client_channel(
    node_a, node_b,
    channel_a: str = "channel-0", channel_b: str = "channel-0",
    client_a: str = "07-tendermint-0", client_b: str = "07-tendermint-0",
) -> None:
    """Create light clients on both chains from each other's current
    headers (the MsgCreateClient genesis trust), then open a channel
    pair bound to them — packet messages on these channels require
    proofs, not relayer registration. Client ids are assigned
    server-side; `client_a`/`client_b` assert the expected assignment
    (the first client on a fresh chain is 07-tendermint-0)."""
    from celestia_tpu_torch.x.lightclient import ClientKeeper

    app_a, app_b = node_a.app, node_b.app
    cs_a = ClientKeeper(app_a.store).create_client(make_header(node_b))
    cs_b = ClientKeeper(app_b.store).create_client(make_header(node_a))
    assert cs_a.client_id == client_a, cs_a.client_id
    assert cs_b.client_id == client_b, cs_b.client_id
    app_a.ibc.open_channel(
        PORT_ID_TRANSFER, channel_a, PORT_ID_TRANSFER, channel_b,
        client_id=cs_a.client_id,
    )
    app_b.ibc.open_channel(
        PORT_ID_TRANSFER, channel_b, PORT_ID_TRANSFER, channel_a,
        client_id=cs_b.client_id,
    )
    app_a.store.commit_hash_refresh()
    app_b.store.commit_hash_refresh()


class LightClientRelayer:
    """Relays packets with light-client updates + SMT proofs — the
    reference's permissionless relayer model: NO registration, any
    funded account relays; the chains verify everything."""

    def __init__(self, node_a, node_b, relayer_key_a, relayer_key_b,
                 val_keys_a, val_keys_b,
                 client_a: str = "07-tendermint-0",
                 client_b: str = "07-tendermint-0"):
        from celestia_tpu_torch.user import Signer as _Signer

        self.node_a, self.node_b = node_a, node_b
        self.signer_a = _Signer.setup_single(relayer_key_a, node_a)
        self.signer_b = _Signer.setup_single(relayer_key_b, node_b)
        self.val_keys = {id(node_a): val_keys_a, id(node_b): val_keys_b}
        # client on each node tracking the OTHER chain
        self.client_on = {id(node_a): client_a, id(node_b): client_b}

    def update_client(self, src_node, dst_node, dst_signer,
                      dst_time: float) -> int:
        """Sync the client on dst with src's latest signed header;
        returns the verified height."""
        from celestia_tpu_torch.x.lightclient import ClientKeeper, MsgUpdateClient

        signed = sign_header(
            make_header(src_node), self.val_keys[id(src_node)]
        )
        client = ClientKeeper(dst_node.app.store).get_client(
            self.client_on[id(dst_node)]
        )
        if client is not None and client.latest_height >= signed.header.height:
            return client.latest_height  # already synced to this height
        res = dst_signer.submit_tx([
            MsgUpdateClient(
                self.client_on[id(dst_node)], signed, dst_signer.address()
            )
        ])
        if res.code != 0:
            raise RuntimeError(f"client update failed: {res.log}")
        dst_node.produce_block(dst_time)
        return signed.header.height

    def relay(self, block_time_a: float, block_time_b: float,
              channel_a: str = "channel-0", channel_b: str = "channel-0") -> int:
        n = self._relay_direction(
            self.node_a, self.node_b, self.signer_b, self.signer_a,
            channel_a, block_time_a, block_time_b,
        )
        n += self._relay_direction(
            self.node_b, self.node_a, self.signer_a, self.signer_b,
            channel_b, block_time_b, block_time_a,
        )
        return n

    def _relay_direction(
        self, src_node, dst_node, dst_signer, src_signer,
        src_channel: str, src_time: float, dst_time: float,
    ) -> int:
        from celestia_tpu_torch.x.ibc import (
            packet_ack_key,
            packet_commitment_key,
        )

        packets = src_node.app.ibc.pending_packets(PORT_ID_TRANSFER, src_channel)
        if not packets:
            return 0
        # 1. prove src's commitments to dst under a fresh verified header
        height = self.update_client(src_node, dst_node, dst_signer, dst_time)
        for packet in packets:
            _v, _root, proof = src_node.app.store.query_with_proof(
                packet_commitment_key(
                    packet.source_port, packet.source_channel, packet.sequence
                )
            )
            res = dst_signer.submit_tx([
                MsgRecvPacket(packet, dst_signer.address(), proof, height)
            ])
            if res.code != 0:
                raise RuntimeError(f"recv relay failed: {res.log}")
        dst_node.produce_block(dst_time)
        # 2. prove dst's written acks back to src
        ack_height = self.update_client(dst_node, src_node, src_signer, src_time)
        for packet in packets:
            ack = dst_node.app.ibc.get_acknowledgement(
                packet.destination_port, packet.destination_channel,
                packet.sequence,
            )
            if ack is None:
                raise RuntimeError(f"no ack written for packet {packet.sequence}")
            _v, _root, proof = dst_node.app.store.query_with_proof(
                packet_ack_key(
                    packet.destination_port, packet.destination_channel,
                    packet.sequence,
                )
            )
            res = src_signer.submit_tx([
                MsgAcknowledgement(
                    packet, ack, src_signer.address(), proof, ack_height
                )
            ])
            if res.code != 0:
                raise RuntimeError(f"ack relay failed: {res.log}")
        src_node.produce_block(src_time)
        return len(packets)

    def handshake(self, t_a: float, t_b: float, step: float = 15.0,
                  port: str = PORT_ID_TRANSFER) -> tuple[str, str]:
        """Establish a connection AND a channel purely via relayed
        handshake messages, every step proving the counterparty's
        recorded state with an SMT membership proof against a verified
        header (ibc-go's ICS-3 ConnOpen* + ICS-4 ChanOpen* flow,
        app/app.go:359-385 wiring). No direct store writes, no trusted
        relayer. Returns (channel_id_a, channel_id_b) — packet relay
        then runs over the connection-bound channels."""
        from celestia_tpu_torch.x.connection import (
            ConnectionKeeper,
            MsgConnectionOpenAck,
            MsgConnectionOpenConfirm,
            MsgConnectionOpenInit,
            MsgConnectionOpenTry,
            connection_key,
        )
        from celestia_tpu_torch.x.ibc import (
            MsgChannelOpenAck,
            MsgChannelOpenConfirm,
            MsgChannelOpenInit,
            MsgChannelOpenTry,
            channel_key,
        )

        a, b = self.node_a, self.node_b
        sa, sb = self.signer_a, self.signer_b
        client_a = self.client_on[id(a)]  # on A, tracking B
        client_b = self.client_on[id(b)]  # on B, tracking A
        times = {id(a): t_a, id(b): t_b}

        def tick(node) -> float:
            times[id(node)] += step
            return times[id(node)]

        def submit(node, signer, msg) -> None:
            res = signer.submit_tx([msg])
            if res.code != 0:
                raise RuntimeError(
                    f"handshake step {type(msg).__name__} failed: {res.log}"
                )
            node.produce_block(tick(node))

        def prove(node, key: bytes):
            _v, _root, proof = node.app.store.query_with_proof(key)
            return proof

        # ---- ICS-3 connection handshake ----
        conn_a = ConnectionKeeper(a.app.store).next_connection_id()
        submit(a, sa, MsgConnectionOpenInit(client_a, client_b, sa.address()))

        h = self.update_client(a, b, sb, tick(b))
        conn_b = ConnectionKeeper(b.app.store).next_connection_id()
        submit(b, sb, MsgConnectionOpenTry(
            client_b, client_a, conn_a,
            prove(a, connection_key(conn_a)), h, sb.address(),
        ))

        h = self.update_client(b, a, sa, tick(a))
        submit(a, sa, MsgConnectionOpenAck(
            conn_a, conn_b, prove(b, connection_key(conn_b)), h, sa.address(),
        ))

        h = self.update_client(a, b, sb, tick(b))
        submit(b, sb, MsgConnectionOpenConfirm(
            conn_b, prove(a, connection_key(conn_a)), h, sb.address(),
        ))

        # ---- ICS-4 channel handshake over the connection ----
        chan_a = a.app.ibc.next_channel_id()
        submit(a, sa, MsgChannelOpenInit(port, conn_a, port, sa.address()))

        h = self.update_client(a, b, sb, tick(b))
        chan_b = b.app.ibc.next_channel_id()
        submit(b, sb, MsgChannelOpenTry(
            port, conn_b, port, chan_a,
            prove(a, channel_key(port, chan_a)), h, sb.address(),
        ))

        h = self.update_client(b, a, sa, tick(a))
        submit(a, sa, MsgChannelOpenAck(
            port, chan_a, chan_b,
            prove(b, channel_key(port, chan_b)), h, sa.address(),
        ))

        h = self.update_client(a, b, sb, tick(b))
        submit(b, sb, MsgChannelOpenConfirm(
            port, chan_b, prove(a, channel_key(port, chan_a)), h, sb.address(),
        ))
        return chan_a, chan_b

    def timeout(self, packet, src_node, dst_node, src_signer,
                src_time: float) -> None:
        """Refund a timed-out packet the honest way: verified header past
        the timeout + receipt absence proof on the destination."""
        from celestia_tpu_torch.x.ibc import MsgTimeout, packet_receipt_key

        height = self.update_client(dst_node, src_node, src_signer, src_time)
        _v, _root, proof = dst_node.app.store.query_with_proof(
            packet_receipt_key(
                packet.destination_port, packet.destination_channel,
                packet.sequence,
            )
        )
        res = src_signer.submit_tx([
            MsgTimeout(packet, src_signer.address(), proof, height)
        ])
        if res.code != 0:
            raise RuntimeError(f"timeout relay failed: {res.log}")
        src_node.produce_block(src_time)


class RemoteLightClientRelayer:
    """The LightClientRelayer speaking ONLY the public node APIs — no
    in-process store access. Everything a real out-of-process relayer
    needs is served remotely: pending packets / acks / unsigned header
    material over the IBC query routes, commitment proofs over
    /proof/state, txs over broadcast_tx. Validator keys are held by the
    harness (they sign header commits, as the chain's validators
    would). The clients are the port's ``RpcClient`` (or its
    ``GrpcClient``, which has the same relayer surface)."""

    def __init__(self, client_a, client_b, relayer_key_a, relayer_key_b,
                 val_keys_a, val_keys_b,
                 client_id_a: str = "07-tendermint-0",
                 client_id_b: str = "07-tendermint-0"):
        from celestia_tpu_torch.user import Signer as _Signer

        self.client_a, self.client_b = client_a, client_b
        self.signer_a = _Signer.setup_single(relayer_key_a, client_a)
        self.signer_b = _Signer.setup_single(relayer_key_b, client_b)
        self.val_keys = {id(client_a): val_keys_a, id(client_b): val_keys_b}
        self.client_on = {id(client_a): client_id_a, id(client_b): client_id_b}

    def update_client(self, src, dst, dst_signer) -> int:
        """Sync dst's light client with src's latest signed header,
        entirely over the wire."""
        from celestia_tpu_torch.x.lightclient import MsgUpdateClient

        signed = sign_header(src.ibc_header(), self.val_keys[id(src)])
        res = dst_signer.submit_tx([
            MsgUpdateClient(
                self.client_on[id(dst)], signed, dst_signer.address()
            )
        ])
        if res.code != 0 and "not newer" not in res.log:
            raise RuntimeError(f"client update failed: {res.log}")
        return signed.header.height

    def relay(self, produce_block_a, produce_block_b,
              channel_a: str = "channel-0", channel_b: str = "channel-0") -> int:
        """One relay round over the public APIs. Block production stays
        with the chains' own drivers (`produce_block_*` callables) —
        the relayer never reaches into a node."""
        n = self._relay_direction(
            self.client_a, self.client_b, self.signer_b, self.signer_a,
            channel_a, produce_block_a, produce_block_b,
        )
        n += self._relay_direction(
            self.client_b, self.client_a, self.signer_a, self.signer_b,
            channel_b, produce_block_b, produce_block_a,
        )
        return n

    def _update_and_prove(self, src, dst, dst_signer, produce_dst,
                          keys: list, retries: int = 3):
        """Verify src's latest header on dst, then fetch proofs for
        `keys` — retrying when src commits a block BETWEEN the header
        fetch and a proof fetch (the proof would then be against a
        newer root than the verified consensus state). /proof/state
        returns the atomic (proof, height) pair, which is what makes
        the race detectable."""
        for _ in range(retries):
            height = self.update_client(src, dst, dst_signer)
            produce_dst()
            proofs = [src.state_proof(key) for key in keys]
            if all(p["height"] == height for p in proofs):
                return height, [p["proof"] for p in proofs]
        raise RuntimeError(
            "source chain kept advancing between header and proof fetches"
        )

    def _relay_direction(self, src, dst, dst_signer, src_signer,
                         src_channel: str, produce_src, produce_dst) -> int:
        from celestia_tpu_torch.x.ibc import (
            packet_ack_key,
            packet_commitment_key,
        )

        packets = src.ibc_pending_packets(PORT_ID_TRANSFER, src_channel)
        if not packets:
            return 0
        height, proofs = self._update_and_prove(
            src, dst, dst_signer, produce_dst,
            [
                packet_commitment_key(
                    p.source_port, p.source_channel, p.sequence
                )
                for p in packets
            ],
        )
        for packet, proof in zip(packets, proofs):
            res = dst_signer.submit_tx([
                MsgRecvPacket(packet, dst_signer.address(), proof, height)
            ])
            if res.code != 0:
                raise RuntimeError(f"recv relay failed: {res.log}")
        produce_dst()
        acks = []
        for packet in packets:
            ack = dst.ibc_ack(
                packet.destination_port, packet.destination_channel,
                packet.sequence,
            )
            if ack is None:
                raise RuntimeError(f"no ack written for packet {packet.sequence}")
            acks.append(ack)
        ack_height, ack_proofs = self._update_and_prove(
            dst, src, src_signer, produce_src,
            [
                packet_ack_key(
                    p.destination_port, p.destination_channel, p.sequence
                )
                for p in packets
            ],
        )
        for packet, ack, proof in zip(packets, acks, ack_proofs):
            res = src_signer.submit_tx([
                MsgAcknowledgement(
                    packet, ack, src_signer.address(), proof, ack_height
                )
            ])
            if res.code != 0:
                raise RuntimeError(f"ack relay failed: {res.log}")
        produce_src()
        return len(packets)
