"""x/slashing + x/evidence — liveness and equivocation security for the
bonded validator set.

Reference semantics: stock SDK slashing/evidence modules with Celestia's
parameters (app/default_overrides.go:100-104 — SignedBlocksWindow 5000,
MinSignedPerWindow 75%, DowntimeJailDuration 1 min, SlashFractionDoubleSign
2%, SlashFractionDowntime 0%), wired at app/app.go:388-392. Evidence
arrives ABCI-style as byzantine-validator records in BeginBlock; downtime
is tracked from the last commit's signatures.
"""

from __future__ import annotations

import dataclasses
import json

ONE = 10**18

# ref: app/default_overrides.go:100-104
SIGNED_BLOCKS_WINDOW = 5000
MIN_SIGNED_PER_WINDOW = 750 * 10**15  # 0.75
DOWNTIME_JAIL_DURATION = 60.0  # seconds
SLASH_FRACTION_DOUBLE_SIGN = 20 * 10**15  # 0.02
SLASH_FRACTION_DOWNTIME = 0

SIGNING_INFO_PREFIX = b"slashing/signingInfo/"
MISSED_BITMAP_PREFIX = b"slashing/missed/"


@dataclasses.dataclass
class Equivocation:
    """Double-sign evidence (ABCI ByzantineValidator analogue)."""

    validator: str  # operator address
    height: int
    power: int = 0


@dataclasses.dataclass
class ValidatorSigningInfo:
    operator: str
    start_height: int = 0
    index_offset: int = 0
    missed_blocks_counter: int = 0
    jailed_until: float = 0.0
    tombstoned: bool = False

    def marshal(self) -> bytes:
        return json.dumps(dataclasses.asdict(self), sort_keys=True).encode()

    @classmethod
    def unmarshal(cls, raw: bytes) -> "ValidatorSigningInfo":
        return cls(**json.loads(raw))


class SlashingKeeper:
    def __init__(self, store, staking):
        self.store = store
        self.staking = staking

    # --- state ---

    def signing_info(self, operator: str) -> ValidatorSigningInfo:
        raw = self.store.get(SIGNING_INFO_PREFIX + operator.encode())
        if raw:
            return ValidatorSigningInfo.unmarshal(raw)
        return ValidatorSigningInfo(operator=operator)

    def set_signing_info(self, info: ValidatorSigningInfo) -> None:
        self.store.set(SIGNING_INFO_PREFIX + info.operator.encode(), info.marshal())

    def _bitmap(self, operator: str) -> bytearray:
        raw = self.store.get(MISSED_BITMAP_PREFIX + operator.encode())
        if raw:
            return bytearray(raw)
        return bytearray((SIGNED_BLOCKS_WINDOW + 7) // 8)

    def _set_bitmap(self, operator: str, bm: bytearray) -> None:
        self.store.set(MISSED_BITMAP_PREFIX + operator.encode(), bytes(bm))

    # --- liveness (ref: x/slashing HandleValidatorSignature) ---

    def handle_validator_signature(self, ctx, operator: str, signed: bool) -> None:
        info = self.signing_info(operator)
        if info.tombstoned:
            return
        bm = self._bitmap(operator)
        idx = info.index_offset % SIGNED_BLOCKS_WINDOW
        info.index_offset += 1
        byte_i, bit = divmod(idx, 8)
        was_missed = bool(bm[byte_i] & (1 << bit))
        if not signed and not was_missed:
            bm[byte_i] |= 1 << bit
            info.missed_blocks_counter += 1
        elif signed and was_missed:
            bm[byte_i] &= ~(1 << bit) & 0xFF
            info.missed_blocks_counter -= 1
        self._set_bitmap(operator, bm)

        window = min(info.index_offset, SIGNED_BLOCKS_WINDOW)
        max_missed = window - window * MIN_SIGNED_PER_WINDOW // ONE
        if (
            info.index_offset >= SIGNED_BLOCKS_WINDOW
            and info.missed_blocks_counter > max_missed
        ):
            self.staking.slash(ctx, operator, SLASH_FRACTION_DOWNTIME)
            self.staking.jail(ctx, operator)
            info.jailed_until = ctx.block_time + DOWNTIME_JAIL_DURATION
            # reset the window (SDK behavior on downtime jail)
            info.missed_blocks_counter = 0
            info.index_offset = 0
            self._set_bitmap(operator, bytearray(len(bm)))
        self.set_signing_info(info)

    # --- equivocation (ref: x/evidence HandleEquivocationEvidence) ---

    def handle_double_sign(self, ctx, evidence: Equivocation) -> int:
        info = self.signing_info(evidence.validator)
        if info.tombstoned:
            return 0  # already tombstoned: evidence is redundant
        burned = self.staking.slash(
            ctx, evidence.validator, SLASH_FRACTION_DOUBLE_SIGN
        )
        self.staking.jail(ctx, evidence.validator)
        info.tombstoned = True
        info.jailed_until = float("inf")
        self.set_signing_info(info)
        return burned

    # --- unjail (ref: x/slashing MsgUnjail) ---

    def unjail(self, ctx, operator: str) -> None:
        info = self.signing_info(operator)
        if info.tombstoned:
            raise ValueError(f"validator {operator} is tombstoned")
        if ctx.block_time < info.jailed_until:
            raise ValueError(
                f"validator {operator} jailed until {info.jailed_until}"
            )
        v = self.staking.get_validator(operator)
        if v is None or not v.jailed:
            raise ValueError(f"validator {operator} is not jailed")
        self.staking.unjail(ctx, operator)


# --------------------------------------------------------------------- #
# MsgUnjail

URL_MSG_UNJAIL = "/cosmos.slashing.v1beta1.MsgUnjail"


def _register():
    from celestia_tpu_torch.blob import _field_bytes, _parse_fields, _require_wt
    from celestia_tpu_torch.tx import register_msg

    @register_msg(URL_MSG_UNJAIL)
    @dataclasses.dataclass
    class MsgUnjail:
        validator_address: str

        def get_signers(self) -> list[str]:
            return [self.validator_address]

        def marshal(self) -> bytes:
            return _field_bytes(1, self.validator_address.encode())

        @classmethod
        def unmarshal(cls, raw: bytes) -> "MsgUnjail":
            m = cls("")
            for tag, wt, val in _parse_fields(raw):
                if tag == 1:
                    _require_wt(wt, 2, tag)
                    m.validator_address = bytes(val).decode()
            return m

    return MsgUnjail


MsgUnjail = _register()
