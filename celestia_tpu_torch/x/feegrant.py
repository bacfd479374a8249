"""x/feegrant — fee allowances (cosmos-sdk feegrant module).

Reference wiring: app/app.go:137-157 ModuleBasics + feegrant keeper at
app/app.go:241, consumed by the ante DeductFeeDecorator: when a tx names
a fee granter, the fee is charged to the granter's account against a
previously granted allowance instead of the fee payer's balance.

Implemented allowance semantics (feegrant BasicAllowance +
AllowedMsgAllowance):
- spend_limit: total utia the grantee may spend (None = unlimited);
  decremented on use, the grant auto-revokes at zero
- expiration: block time after which the allowance is void
- allowed_msgs: optional allowlist of msg type URLs
"""

from __future__ import annotations

import dataclasses
import json

from celestia_tpu_torch.blob import _field_bytes, _parse_fields, _require_wt
from celestia_tpu_torch.tx import register_msg

GRANT_PREFIX = b"feegrant/grant/"


def _grant_key(granter: str, grantee: str) -> bytes:
    return GRANT_PREFIX + granter.encode() + b"/" + grantee.encode()


@dataclasses.dataclass
class Allowance:
    granter: str
    grantee: str
    spend_limit: int | None = None  # None = unlimited
    expiration: float | None = None  # block time; None = never
    allowed_msgs: list[str] | None = None  # type URLs; None = all

    def marshal(self) -> bytes:
        return json.dumps(dataclasses.asdict(self), sort_keys=True).encode()

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Allowance":
        return cls(**json.loads(raw))


class FeegrantKeeper:
    def __init__(self, store, bank):
        self.store = store
        self.bank = bank

    def grant_allowance(self, allowance: Allowance) -> None:
        if allowance.granter == allowance.grantee:
            raise ValueError("cannot self-grant a fee allowance")
        if self.get_allowance(allowance.granter, allowance.grantee) is not None:
            raise ValueError(
                f"fee allowance from {allowance.granter} to "
                f"{allowance.grantee} already exists"
            )
        self.store.set(
            _grant_key(allowance.granter, allowance.grantee), allowance.marshal()
        )

    def get_allowance(self, granter: str, grantee: str) -> Allowance | None:
        raw = self.store.get(_grant_key(granter, grantee))
        return Allowance.unmarshal(raw) if raw else None

    def revoke_allowance(self, granter: str, grantee: str) -> None:
        if self.get_allowance(granter, grantee) is None:
            raise ValueError("fee allowance does not exist")
        self.store.delete(_grant_key(granter, grantee))

    def use_granted_fees(
        self, ctx, granter: str, grantee: str, fee_amount: int,
        fee_denom: str, msgs: list
    ) -> None:
        """ante DeductFee path: validate + decrement the allowance (the
        caller then charges the granter's balance).
        ref: feegrant Keeper.UseGrantedFees."""
        from celestia_tpu_torch.appconsts import BOND_DENOM

        if fee_denom != BOND_DENOM:
            # allowances (and their spend limits) are utia-denominated;
            # accepting another denom would let the grantee spend granter
            # assets the allowance never covered
            raise ValueError(
                f"fee allowances only cover {BOND_DENOM}, got {fee_denom}"
            )
        allowance = self.get_allowance(granter, grantee)
        if allowance is None:
            raise ValueError(
                f"no fee allowance from {granter} to {grantee}"
            )
        if allowance.expiration is not None and ctx.block_time > allowance.expiration:
            self.store.delete(_grant_key(granter, grantee))
            raise ValueError("fee allowance expired")
        if allowance.allowed_msgs is not None:
            allowed = set(allowance.allowed_msgs)
            for msg in msgs:
                url = _msg_url(msg)
                if url not in allowed:
                    raise ValueError(
                        f"message {url} is not allowed by the fee allowance"
                    )
        if allowance.spend_limit is not None:
            if fee_amount > allowance.spend_limit:
                raise ValueError(
                    f"fee {fee_amount} exceeds the allowance spend limit "
                    f"{allowance.spend_limit}"
                )
            allowance.spend_limit -= fee_amount
            if allowance.spend_limit == 0:
                self.store.delete(_grant_key(granter, grantee))
            else:
                self.store.set(
                    _grant_key(granter, grantee), allowance.marshal()
                )


def _msg_url(msg) -> str:
    return getattr(type(msg), "TYPE_URL", f"/{type(msg).__name__}")


URL_MSG_GRANT_ALLOWANCE = "/cosmos.feegrant.v1beta1.MsgGrantAllowance"
URL_MSG_REVOKE_ALLOWANCE = "/cosmos.feegrant.v1beta1.MsgRevokeAllowance"


@register_msg(URL_MSG_GRANT_ALLOWANCE)
@dataclasses.dataclass
class MsgGrantAllowance:
    granter: str
    grantee: str
    spend_limit: int = 0  # 0 = unlimited on the wire
    expiration: float = 0.0  # 0 = never
    allowed_msgs: list[str] = dataclasses.field(default_factory=list)

    def get_signers(self) -> list[str]:
        return [self.granter]

    def to_allowance(self) -> Allowance:
        return Allowance(
            granter=self.granter,
            grantee=self.grantee,
            spend_limit=self.spend_limit or None,
            expiration=self.expiration or None,
            allowed_msgs=self.allowed_msgs or None,
        )

    def marshal(self) -> bytes:
        out = _field_bytes(1, self.granter.encode()) + _field_bytes(
            2, self.grantee.encode()
        )
        if self.spend_limit:
            out += _field_bytes(3, str(self.spend_limit).encode())
        if self.expiration:
            out += _field_bytes(4, str(self.expiration).encode())
        for url in self.allowed_msgs:
            out += _field_bytes(5, url.encode())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgGrantAllowance":
        m = cls("", "")
        for tag, wt, val in _parse_fields(raw):
            _require_wt(wt, 2, tag)
            if tag == 1:
                m.granter = bytes(val).decode()
            elif tag == 2:
                m.grantee = bytes(val).decode()
            elif tag == 3:
                m.spend_limit = int(bytes(val).decode())
            elif tag == 4:
                m.expiration = float(bytes(val).decode())
            elif tag == 5:
                m.allowed_msgs.append(bytes(val).decode())
        return m

    def validate_basic(self) -> None:
        if not self.granter or not self.grantee:
            raise ValueError("granter and grantee required")
        if self.granter == self.grantee:
            raise ValueError("cannot self-grant a fee allowance")
        if self.spend_limit < 0:
            raise ValueError("spend limit cannot be negative")


@register_msg(URL_MSG_REVOKE_ALLOWANCE)
@dataclasses.dataclass
class MsgRevokeAllowance:
    granter: str
    grantee: str

    def get_signers(self) -> list[str]:
        return [self.granter]

    def marshal(self) -> bytes:
        return _field_bytes(1, self.granter.encode()) + _field_bytes(
            2, self.grantee.encode()
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgRevokeAllowance":
        m = cls("", "")
        for tag, wt, val in _parse_fields(raw):
            _require_wt(wt, 2, tag)
            if tag == 1:
                m.granter = bytes(val).decode()
            elif tag == 2:
                m.grantee = bytes(val).decode()
        return m

    def validate_basic(self) -> None:
        if not self.granter or not self.grantee:
            raise ValueError("granter and grantee required")
