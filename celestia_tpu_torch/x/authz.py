"""x/authz — message authorization grants (cosmos-sdk authz module).

Reference wiring: app/app.go:137-157 ModuleBasics (authz.ModuleName),
EndBlocker order app/app.go:493. A granter authorizes a grantee to
execute specific message types on its behalf; the grantee submits
MsgExec wrapping the inner messages, and execution checks a live grant
for every required signer of every inner message instead of a signature.

Authorization kinds:
- GenericAuthorization: any message of one type URL
- SendAuthorization (for MsgSend): with a decrementing spend_limit
Expirations are checked (and expired grants pruned) at use time.
"""

from __future__ import annotations

import dataclasses
import json

from celestia_tpu_torch.appconsts import BOND_DENOM
from celestia_tpu_torch.blob import _field_bytes, _parse_fields, _require_wt
from celestia_tpu_torch.tx import decode_any, register_msg
from celestia_tpu_torch.x.bank import MsgSend

GRANT_PREFIX = b"authz/grant/"

URL_MSG_SEND = MsgSend.TYPE_URL


def _grant_key(granter: str, grantee: str, msg_type_url: str) -> bytes:
    return (
        GRANT_PREFIX
        + granter.encode()
        + b"/"
        + grantee.encode()
        + b"/"
        + msg_type_url.encode()
    )


@dataclasses.dataclass
class Grant:
    granter: str
    grantee: str
    msg_type_url: str
    expiration: float | None = None  # block time; None = never
    spend_limit: int | None = None  # SendAuthorization only

    def marshal(self) -> bytes:
        return json.dumps(dataclasses.asdict(self), sort_keys=True).encode()

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Grant":
        return cls(**json.loads(raw))


class AuthzKeeper:
    def __init__(self, store):
        self.store = store

    def grant(self, g: Grant) -> None:
        if g.granter == g.grantee:
            raise ValueError("cannot self-grant an authorization")
        if g.spend_limit is not None and g.msg_type_url != URL_MSG_SEND:
            raise ValueError("spend_limit only applies to MsgSend grants")
        self.store.set(
            _grant_key(g.granter, g.grantee, g.msg_type_url), g.marshal()
        )

    def get_grant(
        self, granter: str, grantee: str, msg_type_url: str
    ) -> Grant | None:
        raw = self.store.get(_grant_key(granter, grantee, msg_type_url))
        return Grant.unmarshal(raw) if raw else None

    def revoke(self, granter: str, grantee: str, msg_type_url: str) -> None:
        if self.get_grant(granter, grantee, msg_type_url) is None:
            raise ValueError("authorization does not exist")
        self.store.delete(_grant_key(granter, grantee, msg_type_url))

    def _accept(self, ctx, granter: str, grantee: str, msg) -> None:
        """Authorization.Accept: validate + update/consume the grant."""
        url = getattr(type(msg), "TYPE_URL", None)
        g = self.get_grant(granter, grantee, url) if url else None
        if g is None:
            raise ValueError(
                f"{grantee} has no authorization from {granter} for {url}"
            )
        if g.expiration is not None and ctx.block_time > g.expiration:
            self.store.delete(_grant_key(granter, grantee, url))
            raise ValueError("authorization expired")
        if g.spend_limit is not None:
            # The limit is a bare utia amount (the SDK's SendAuthorization
            # carries typed Coins); comparing it against a send in another
            # denom — e.g. an IBC voucher — would spend the granter's
            # other balances against a utia budget and decrement the limit
            # in the wrong unit. Restrict the spend-limit path to the bond
            # denom. (spend_limit grants are only issued for MsgSend, which
            # always carries a denom.)
            if msg.denom != BOND_DENOM:
                raise ValueError(
                    f"authorization spend limit is {BOND_DENOM}-denominated; "
                    f"cannot authorize a {msg.denom} send"
                )
            amount = msg.amount
            if amount > g.spend_limit:
                raise ValueError(
                    f"send amount {amount} exceeds the authorization "
                    f"spend limit {g.spend_limit}"
                )
            g.spend_limit -= amount
            if g.spend_limit == 0:
                self.store.delete(_grant_key(granter, grantee, url))
            else:
                self.store.set(_grant_key(granter, grantee, url), g.marshal())

    def dispatch_exec(self, ctx, grantee: str, msgs: list, route_fn) -> None:
        """MsgExec execution (authz Keeper.DispatchActions): every
        required signer of every inner message must have granted the
        grantee authorization for that message type; then the messages
        run through the normal router."""
        from celestia_tpu_torch.x.blob.types import MsgPayForBlobs

        for msg in msgs:
            # defense in depth vs the validate_basic check: a nested PFB
            # would bypass the top-level-only square placement rule
            if isinstance(msg, (MsgExec, MsgPayForBlobs)):
                raise ValueError(
                    f"{type(msg).__name__} cannot be executed through MsgExec"
                )
            getter = getattr(msg, "get_signers", None)
            if getter is None:
                raise ValueError(
                    f"message {type(msg).__name__} declares no signers"
                )
            for signer in getter():
                if signer == grantee:
                    continue  # own message needs no grant
                self._accept(ctx, signer, grantee, msg)
            if hasattr(msg, "validate_basic"):
                msg.validate_basic()
            route_fn(ctx, msg)


URL_MSG_GRANT = "/cosmos.authz.v1beta1.MsgGrant"
URL_MSG_REVOKE = "/cosmos.authz.v1beta1.MsgRevoke"
URL_MSG_EXEC = "/cosmos.authz.v1beta1.MsgExec"


@register_msg(URL_MSG_GRANT)
@dataclasses.dataclass
class MsgGrant:
    granter: str
    grantee: str
    msg_type_url: str
    expiration: float = 0.0  # 0 = never
    spend_limit: int = 0  # 0 = no limit (generic authorization)

    def get_signers(self) -> list[str]:
        return [self.granter]

    def to_grant(self) -> Grant:
        return Grant(
            granter=self.granter,
            grantee=self.grantee,
            msg_type_url=self.msg_type_url,
            expiration=self.expiration or None,
            spend_limit=self.spend_limit or None,
        )

    def marshal(self) -> bytes:
        out = (
            _field_bytes(1, self.granter.encode())
            + _field_bytes(2, self.grantee.encode())
            + _field_bytes(3, self.msg_type_url.encode())
        )
        if self.expiration:
            out += _field_bytes(4, str(self.expiration).encode())
        if self.spend_limit:
            out += _field_bytes(5, str(self.spend_limit).encode())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgGrant":
        m = cls("", "", "")
        for tag, wt, val in _parse_fields(raw):
            _require_wt(wt, 2, tag)
            if tag == 1:
                m.granter = bytes(val).decode()
            elif tag == 2:
                m.grantee = bytes(val).decode()
            elif tag == 3:
                m.msg_type_url = bytes(val).decode()
            elif tag == 4:
                m.expiration = float(bytes(val).decode())
            elif tag == 5:
                m.spend_limit = int(bytes(val).decode())
        return m

    def validate_basic(self) -> None:
        if not self.granter or not self.grantee or not self.msg_type_url:
            raise ValueError("granter, grantee and msg_type_url required")
        if self.granter == self.grantee:
            raise ValueError("cannot self-grant an authorization")


@register_msg(URL_MSG_REVOKE)
@dataclasses.dataclass
class MsgRevoke:
    granter: str
    grantee: str
    msg_type_url: str

    def get_signers(self) -> list[str]:
        return [self.granter]

    def marshal(self) -> bytes:
        return (
            _field_bytes(1, self.granter.encode())
            + _field_bytes(2, self.grantee.encode())
            + _field_bytes(3, self.msg_type_url.encode())
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgRevoke":
        m = cls("", "", "")
        for tag, wt, val in _parse_fields(raw):
            _require_wt(wt, 2, tag)
            if tag == 1:
                m.granter = bytes(val).decode()
            elif tag == 2:
                m.grantee = bytes(val).decode()
            elif tag == 3:
                m.msg_type_url = bytes(val).decode()
        return m

    def validate_basic(self) -> None:
        if not self.granter or not self.grantee or not self.msg_type_url:
            raise ValueError("granter, grantee and msg_type_url required")


@register_msg(URL_MSG_EXEC)
@dataclasses.dataclass
class MsgExec:
    grantee: str
    msgs: list = dataclasses.field(default_factory=list)

    def get_signers(self) -> list[str]:
        """Only the grantee signs; inner-msg signers are replaced by the
        authz grants at execution time."""
        return [self.grantee]

    def marshal(self) -> bytes:
        out = _field_bytes(1, self.grantee.encode())
        for msg in self.msgs:
            any_bytes = _field_bytes(
                1, type(msg).TYPE_URL.encode()
            ) + _field_bytes(2, msg.marshal())
            out += _field_bytes(2, any_bytes)
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgExec":
        m = cls("")
        for tag, wt, val in _parse_fields(raw):
            _require_wt(wt, 2, tag)
            if tag == 1:
                m.grantee = bytes(val).decode()
            elif tag == 2:
                url, value = "", b""
                for t2, w2, v2 in _parse_fields(bytes(val)):
                    _require_wt(w2, 2, t2)
                    if t2 == 1:
                        url = bytes(v2).decode()
                    elif t2 == 2:
                        value = bytes(v2)
                m.msgs.append(decode_any(url, value))
        return m

    def validate_basic(self) -> None:
        from celestia_tpu_torch.x.blob.types import MsgPayForBlobs

        if not self.grantee:
            raise ValueError("grantee required")
        if not self.msgs:
            raise ValueError("MsgExec carries no messages")
        if any(isinstance(msg, MsgExec) for msg in self.msgs):
            raise ValueError("nested MsgExec is not allowed")
        # A PFB's blobs ride the BlobTx envelope and are placed by the
        # square builder against the TOP-LEVEL tx; nesting one in authz
        # would emit a commitment with no blob in the square
        # (celestia-app rejects authz-nested MsgPayForBlobs).
        if any(isinstance(msg, MsgPayForBlobs) for msg in self.msgs):
            raise ValueError("MsgPayForBlobs cannot be nested in MsgExec")
