"""x/tokenfilter — IBC middleware rejecting inbound non-native tokens.

Reference semantics: x/tokenfilter/ibc_middleware.go:22-50, stacked over
the transfer module at app/app.go:380-385 ("transfer stack contains (from
top to bottom): Token Filter, Transfer"). On a received ICS-20 packet,
only the native token returning home is accepted: a denom is "returning"
when its trace starts with the packet's source (port, channel), meaning
the token originated on this chain. Anything else gets an error
acknowledgement — not a panic — so the relayer delivers a refund on the
counterparty. Undecodable packet data passes down the stack (the
reference's defensive stance for non-transfer stacks).

The middleware is unilateral and stateless; acknowledgement and timeout
callbacks pass straight through.
"""

from __future__ import annotations

from celestia_tpu_torch.x.ibc import Acknowledgement, Packet
from celestia_tpu_torch.x.transfer import (
    FungibleTokenPacketData,
    receiver_chain_is_source,
)

MODULE_NAME = "tokenfilter"


class TokenFilterMiddleware:
    """Wraps an IBCModule (normally TransferIBCModule).
    ref: ibc_middleware.go:28 NewIBCMiddleware"""

    def __init__(self, ibc_module):
        self.ibc_module = ibc_module

    def on_recv_packet(self, ctx, packet: Packet) -> Acknowledgement:
        try:
            data = FungibleTokenPacketData.unmarshal(packet.data)
        except (ValueError, KeyError, TypeError):
            # not transfer data — pass it down the stack unjudged
            # (ibc_middleware.go:43-50)
            return self.ibc_module.on_recv_packet(ctx, packet)
        if receiver_chain_is_source(
            packet.source_port, packet.source_channel, data.denom
        ):
            return self.ibc_module.on_recv_packet(ctx, packet)
        if ctx is not None:
            ctx.events.append(
                {
                    "type": "fungible_token_packet",
                    "module": MODULE_NAME,
                    "sender": data.sender,
                    "receiver": data.receiver,
                    "denom": data.denom,
                    "amount": str(data.amount),
                    "ack_success": "false",
                }
            )
        return Acknowledgement(
            success=False,
            error=f"only native denom transfers accepted, got {data.denom}: "
            "invalid type",
        )

    def on_acknowledgement_packet(self, ctx, packet: Packet, ack) -> None:
        self.ibc_module.on_acknowledgement_packet(ctx, packet, ack)

    def on_timeout_packet(self, ctx, packet: Packet) -> None:
        self.ibc_module.on_timeout_packet(ctx, packet)
