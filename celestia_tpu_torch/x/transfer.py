"""ICS-20 fungible token transfer — the IBC transfer app.

Reference semantics: ibc-go v6 transfer keeper as wired at
app/app.go:370-385 (with tokenfilter middleware on top — x/tokenfilter).
Implements the four ICS-20 flows over the framework's bank keeper:

- send (source chain, native denom): escrow to the channel's escrow
  account, emit a FungibleTokenPacketData packet
- send (voucher returning): burn the voucher, emit the packet with the
  full trace
- receive (returning native token): ReceiverChainIsSource — strip the
  trace prefix, unescrow to the receiver
- receive (foreign token): prefix the trace with (dest_port/dest_channel)
  and mint a voucher (the flow tokenfilter rejects on this chain)
- ack-error / timeout: refund the escrowed or burned tokens to the sender

Denoms carry their trace inline ("transfer/channel-0/utia"), the ICS-20
path convention.
"""

from __future__ import annotations

import dataclasses
import json

from celestia_tpu_torch.tx import register_msg
from celestia_tpu_torch.x.ibc import Acknowledgement, ChannelKeeper, Packet


PORT_ID_TRANSFER = "transfer"


def escrow_address(port_id: str, channel_id: str) -> str:
    """Deterministic per-channel escrow account (ics20 GetEscrowAddress)."""
    return f"escrow/{port_id}/{channel_id}"


def receiver_chain_is_source(source_port: str, source_channel: str, denom: str) -> bool:
    """The denom's trace begins with the packet's source (port, channel):
    the token originated on the RECEIVING chain and is coming home.
    ref: transfertypes.ReceiverChainIsSource"""
    return denom.startswith(f"{source_port}/{source_channel}/")


def sender_chain_is_source(source_port: str, source_channel: str, denom: str) -> bool:
    """ref: transfertypes.SenderChainIsSource — the mirror predicate."""
    return not receiver_chain_is_source(source_port, source_channel, denom)


@dataclasses.dataclass
class FungibleTokenPacketData:
    """ICS-20 packet payload (JSON encoding, like ibc-go ModuleCdc)."""

    denom: str
    amount: int
    sender: str
    receiver: str
    memo: str = ""

    def marshal(self) -> bytes:
        return json.dumps(
            {
                "denom": self.denom,
                "amount": str(self.amount),  # ICS-20 encodes amount as string
                "sender": self.sender,
                "receiver": self.receiver,
                "memo": self.memo,
            },
            sort_keys=True,
        ).encode()

    @classmethod
    def unmarshal(cls, raw: bytes) -> "FungibleTokenPacketData":
        d = json.loads(raw)
        return cls(
            denom=d["denom"],
            amount=int(d["amount"]),
            sender=d["sender"],
            receiver=d["receiver"],
            memo=d.get("memo", ""),
        )


class TransferKeeper:
    def __init__(self, store, bank):
        self.store = store
        self.bank = bank
        self.channels = ChannelKeeper(store)

    # --- send side ---

    def send_transfer(
        self,
        ctx,
        source_port: str,
        source_channel: str,
        denom: str,
        amount: int,
        sender: str,
        receiver: str,
        timeout_timestamp: float = 0.0,
        memo: str = "",
    ) -> Packet:
        """ref: transfer keeper SendTransfer."""
        if amount <= 0:
            raise ValueError("transfer amount must be positive")
        if sender_chain_is_source(source_port, source_channel, denom):
            # native token leaving home: lock it in the channel escrow
            self.bank.send(
                sender, escrow_address(source_port, source_channel), amount, denom
            )
        else:
            # voucher heading back to its origin: burn it here
            self.bank.burn(sender, amount, denom)
        data = FungibleTokenPacketData(denom, amount, sender, receiver, memo)
        return self.channels.send_packet(
            source_port, source_channel, data.marshal(), timeout_timestamp
        )

    # --- receive side (wrapped by tokenfilter on this chain) ---

    def on_recv_packet(self, ctx, packet: Packet) -> Acknowledgement:
        """ref: transfer keeper OnRecvPacket."""
        try:
            data = FungibleTokenPacketData.unmarshal(packet.data)
        except (ValueError, KeyError, TypeError) as e:
            return Acknowledgement(success=False, error=f"cannot unmarshal packet: {e}")
        # ics20 data.ValidateBasic before the app callback
        if data.amount <= 0:
            return Acknowledgement(success=False, error="amount must be positive")
        if not data.sender or not data.receiver:
            return Acknowledgement(success=False, error="missing sender/receiver")
        # The receiver string is counterparty-controlled. Reject module and
        # escrow accounts (ibc-go's BlockedAddr check: crediting e.g. the
        # bonded pool would silently break the staking invariants) and
        # anything that isn't a well-formed local bech32 account, with an
        # error ack so the source chain refunds the sender.
        from celestia_tpu_torch.x.bank import is_blocked_addr

        if is_blocked_addr(data.receiver):
            return Acknowledgement(
                success=False,
                error=f"{data.receiver} is not allowed to receive funds",
            )
        try:
            from celestia_tpu_torch.crypto import BECH32_HRP, bech32_decode

            hrp, _ = bech32_decode(data.receiver)
            if hrp != BECH32_HRP:
                raise ValueError(
                    f"wrong HRP {hrp!r}, want {BECH32_HRP!r}"
                )
        except ValueError as e:
            return Acknowledgement(
                success=False, error=f"invalid receiver address: {e}"
            )
        try:
            if receiver_chain_is_source(
                packet.source_port, packet.source_channel, data.denom
            ):
                # strip one (source port/channel) hop: the local denom
                prefix = f"{packet.source_port}/{packet.source_channel}/"
                local_denom = data.denom[len(prefix):]
                self.bank.send(
                    escrow_address(packet.destination_port, packet.destination_channel),
                    data.receiver,
                    data.amount,
                    local_denom,
                )
            else:
                # foreign token: extend the trace and mint a voucher
                voucher = (
                    f"{packet.destination_port}/{packet.destination_channel}/"
                    f"{data.denom}"
                )
                self.bank.mint(data.receiver, data.amount, voucher)
            from celestia_tpu_torch.x.auth import AccountKeeper

            AccountKeeper(self.store).get_or_create(data.receiver)
        except ValueError as e:
            return Acknowledgement(success=False, error=str(e))
        return Acknowledgement(success=True)

    # --- ack / timeout (source chain) ---

    def on_acknowledgement_packet(
        self, ctx, packet: Packet, ack: Acknowledgement
    ) -> None:
        """ref: transfer OnAcknowledgementPacket — refund on error ack."""
        self.channels.acknowledge_packet(packet)
        if not ack.success:
            self._refund(packet)

    def on_timeout_packet(self, ctx, packet: Packet) -> None:
        """ref: transfer OnTimeoutPacket — refund once the channel layer
        confirms the timeout elapsed and clears the commitment."""
        self.channels.timeout_packet(packet, ctx.block_time)
        self._refund(packet)

    def _refund(self, packet: Packet) -> None:
        data = FungibleTokenPacketData.unmarshal(packet.data)
        if sender_chain_is_source(
            packet.source_port, packet.source_channel, data.denom
        ):
            self.bank.send(
                escrow_address(packet.source_port, packet.source_channel),
                data.sender,
                data.amount,
                data.denom,
            )
        else:
            self.bank.mint(data.sender, data.amount, data.denom)


class TransferIBCModule:
    """The transfer app's IBCModule face — what middleware wraps
    (ref: transfer.NewIBCModule at app/app.go:383)."""

    def __init__(self, keeper: TransferKeeper):
        self.keeper = keeper

    def on_recv_packet(self, ctx, packet: Packet) -> Acknowledgement:
        return self.keeper.on_recv_packet(ctx, packet)

    def on_acknowledgement_packet(self, ctx, packet: Packet, ack) -> None:
        self.keeper.on_acknowledgement_packet(ctx, packet, ack)

    def on_timeout_packet(self, ctx, packet: Packet) -> None:
        self.keeper.on_timeout_packet(ctx, packet)


URL_MSG_TRANSFER = "/ibc.applications.transfer.v1.MsgTransfer"


@register_msg(URL_MSG_TRANSFER)
@dataclasses.dataclass
class MsgTransfer:
    source_port: str
    source_channel: str
    denom: str
    amount: int
    sender: str
    receiver: str
    timeout_timestamp: float = 0.0
    memo: str = ""

    def get_signers(self) -> list[str]:
        return [self.sender]

    def marshal(self) -> bytes:
        from celestia_tpu_torch.blob import _field_bytes

        coin = _field_bytes(1, self.denom.encode()) + _field_bytes(
            2, str(self.amount).encode()
        )
        out = (
            _field_bytes(1, self.source_port.encode())
            + _field_bytes(2, self.source_channel.encode())
            + _field_bytes(3, coin)
            + _field_bytes(4, self.sender.encode())
            + _field_bytes(5, self.receiver.encode())
        )
        if self.timeout_timestamp:
            out += _field_bytes(7, str(self.timeout_timestamp).encode())
        if self.memo:
            out += _field_bytes(8, self.memo.encode())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgTransfer":
        from celestia_tpu_torch.blob import _parse_fields, _require_wt

        m = cls("", "", "", 0, "", "")
        for tag, wt, val in _parse_fields(raw):
            if tag == 1:
                _require_wt(wt, 2, tag)
                m.source_port = bytes(val).decode()
            elif tag == 2:
                _require_wt(wt, 2, tag)
                m.source_channel = bytes(val).decode()
            elif tag == 3:
                _require_wt(wt, 2, tag)
                for t2, w2, v2 in _parse_fields(bytes(val)):
                    if t2 == 1:
                        m.denom = bytes(v2).decode()
                    elif t2 == 2:
                        m.amount = int(bytes(v2).decode())
            elif tag == 4:
                _require_wt(wt, 2, tag)
                m.sender = bytes(val).decode()
            elif tag == 5:
                _require_wt(wt, 2, tag)
                m.receiver = bytes(val).decode()
            elif tag == 7:
                _require_wt(wt, 2, tag)
                m.timeout_timestamp = float(bytes(val).decode())
            elif tag == 8:
                _require_wt(wt, 2, tag)
                m.memo = bytes(val).decode()
        return m

    def validate_basic(self) -> None:
        if self.amount <= 0:
            raise ValueError("transfer amount must be positive")
        if not self.source_port or not self.source_channel:
            raise ValueError("source port/channel required")
        if not self.receiver:
            raise ValueError("receiver required")
