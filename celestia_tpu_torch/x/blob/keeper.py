"""x/blob keeper: params + PayForBlobs handler (gas consumption + event).

Reference semantics: x/blob/keeper/keeper.go:49-70 (consume gas, emit
event, no state writes), x/blob/types/params.go.
"""

from __future__ import annotations

import dataclasses

from celestia_tpu_torch import appconsts

from .types import MsgPayForBlobs, gas_to_consume

KEY_GAS_PER_BLOB_BYTE = b"blob/GasPerBlobByte"
KEY_GOV_MAX_SQUARE_SIZE = b"blob/GovMaxSquareSize"


@dataclasses.dataclass
class Params:
    gas_per_blob_byte: int = appconsts.DEFAULT_GAS_PER_BLOB_BYTE
    gov_max_square_size: int = appconsts.DEFAULT_GOV_MAX_SQUARE_SIZE


class BlobKeeper:
    def __init__(self, store):
        self.store = store

    def get_params(self) -> Params:
        p = Params()
        raw = self.store.get(KEY_GAS_PER_BLOB_BYTE)
        if raw is not None:
            p.gas_per_blob_byte = int.from_bytes(raw, "big")
        raw = self.store.get(KEY_GOV_MAX_SQUARE_SIZE)
        if raw is not None:
            p.gov_max_square_size = int.from_bytes(raw, "big")
        return p

    def set_params(self, p: Params) -> None:
        self.store.set(KEY_GAS_PER_BLOB_BYTE, p.gas_per_blob_byte.to_bytes(8, "big"))
        self.store.set(KEY_GOV_MAX_SQUARE_SIZE, p.gov_max_square_size.to_bytes(8, "big"))

    def pay_for_blobs(self, ctx, msg: MsgPayForBlobs) -> dict:
        """Handle MsgPayForBlobs: charge per-byte gas, emit event.
        ref: x/blob/keeper/keeper.go:49-70"""
        gas = gas_to_consume(msg.blob_sizes, self.get_params().gas_per_blob_byte)
        ctx.gas_meter.consume(gas, "pay for blobs")
        event = {
            "type": "celestia.blob.v1.EventPayForBlobs",
            "signer": msg.signer,
            "blob_sizes": list(msg.blob_sizes),
            "namespaces": [ns.hex() for ns in msg.namespaces],
        }
        ctx.events.append(event)
        return {}
