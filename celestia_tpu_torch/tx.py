"""Transaction wire format + signing.

The reference uses Cosmos SDK protobuf txs (TxRaw{body, auth_info,
signatures}) signed in SIGN_MODE_DIRECT over SignDoc{body_bytes,
auth_info_bytes, chain_id, account_number} (pkg/user/signer.go:287,
app/encoding/encoding.go). This module implements those proto shapes
byte-for-byte on the in-repo wire codec — `tests/test_wire_parity.py`
pins every layer (TxRaw, SignDoc, TxBody, AuthInfo, SignerInfo, Fee,
MsgPayForBlobs, Blob, BlobTx) against golden bytes produced by an
independent protobuf implementation of the reference .proto files.

Known wire divergences (deliberate, see specs/wire.md):
- TxBody.timeout_height / extension options are not modeled (encoded
  as their proto3 defaults, i.e. absent — byte-compatible until used).
- Fee is restricted to a single Coin; multi-coin fees are rejected at
  decode (the chain's fee market is utia-only).
- Signatures are 64-byte low-S (r ‖ s) secp256k1 — same as Cosmos.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from celestia_tpu_torch.blob import (
    _field_bytes,
    _field_uint,
    _parse_fields,
    _require_wt,
)

# --- message registry ---

_MSG_REGISTRY: dict[str, Callable[[bytes], "object"]] = {}


def register_msg(type_url: str):
    """Class decorator: register an unmarshaller under a type URL."""

    def wrap(cls):
        cls.TYPE_URL = type_url
        _MSG_REGISTRY[type_url] = cls.unmarshal
        return cls

    return wrap


def decode_any(type_url: str, value: bytes):
    if type_url not in _MSG_REGISTRY:
        raise ValueError(f"unknown message type {type_url}")
    return _MSG_REGISTRY[type_url](value)


@dataclasses.dataclass
class Fee:
    """cosmos.tx.v1beta1.Fee: `repeated Coin amount = 1` (Coin is
    {string denom = 1, string amount = 2} — the amount is a decimal
    STRING on the wire), `uint64 gas_limit = 2`, `string payer = 3`,
    `string granter = 4`. The dataclass keeps the single-coin view the
    ante chain consumes; multi-coin fees are rejected at decode."""

    amount: int = 0
    gas_limit: int = 0
    denom: str = "utia"
    payer: str = ""
    granter: str = ""

    def marshal(self) -> bytes:
        out = b""
        if self.amount:
            coin = _field_bytes(1, self.denom.encode()) + _field_bytes(
                2, str(self.amount).encode()
            )
            out += _field_bytes(1, coin)
        return (
            out
            + _field_uint(2, self.gas_limit)
            + _field_bytes(3, self.payer.encode())
            + _field_bytes(4, self.granter.encode())
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Fee":
        f = cls(amount=0, denom="")
        seen_coin = False
        for tag, wt, val in _parse_fields(raw):
            if tag == 1:
                _require_wt(wt, 2, tag)
                if seen_coin:
                    raise ValueError(
                        "multi-coin fees are not supported (utia-only fee market)"
                    )
                seen_coin = True
                for t2, w2, v2 in _parse_fields(bytes(val)):
                    if t2 == 1:
                        _require_wt(w2, 2, t2)
                        f.denom = bytes(v2).decode()
                    elif t2 == 2:
                        _require_wt(w2, 2, t2)
                        amount_str = bytes(v2).decode()
                        if not amount_str.isdigit():
                            raise ValueError(
                                f"invalid coin amount {amount_str!r}"
                            )
                        f.amount = int(amount_str)
            elif tag == 2:
                _require_wt(wt, 0, tag)
                f.gas_limit = int(val)
            elif tag == 3:
                _require_wt(wt, 2, tag)
                f.payer = bytes(val).decode()
            elif tag == 4:
                _require_wt(wt, 2, tag)
                f.granter = bytes(val).decode()
        return f


SECP256K1_PUBKEY_TYPE_URL = "/cosmos.crypto.secp256k1.PubKey"
SIGN_MODE_DIRECT = 1  # cosmos.tx.signing.v1beta1.SignMode


@dataclasses.dataclass
class SignerInfo:
    """cosmos.tx.v1beta1.SignerInfo: `Any public_key = 1` (wrapping
    cosmos.crypto.secp256k1.PubKey{bytes key = 1}), `ModeInfo
    mode_info = 2` (single/DIRECT), `uint64 sequence = 3`."""

    public_key: bytes  # 33-byte compressed secp256k1
    sequence: int

    def marshal(self) -> bytes:
        pubkey_any = _field_bytes(
            1, SECP256K1_PUBKEY_TYPE_URL.encode()
        ) + _field_bytes(2, _field_bytes(1, self.public_key))
        # ModeInfo{ single: Single{ mode: SIGN_MODE_DIRECT } }
        mode_info = _field_bytes(1, _field_uint(1, SIGN_MODE_DIRECT))
        return (
            _field_bytes(1, pubkey_any)
            + _field_bytes(2, mode_info)
            + _field_uint(3, self.sequence)
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "SignerInfo":
        s = cls(b"", 0)
        mode = None
        for tag, wt, val in _parse_fields(raw):
            if tag == 1:
                _require_wt(wt, 2, tag)
                type_url, value = "", b""
                for t2, w2, v2 in _parse_fields(bytes(val)):
                    if t2 == 1:
                        _require_wt(w2, 2, t2)
                        type_url = bytes(v2).decode()
                    elif t2 == 2:
                        _require_wt(w2, 2, t2)
                        value = bytes(v2)
                if type_url != SECP256K1_PUBKEY_TYPE_URL:
                    raise ValueError(
                        f"unsupported signer pubkey type {type_url!r}"
                    )
                for t2, w2, v2 in _parse_fields(value):
                    if t2 == 1:
                        _require_wt(w2, 2, t2)
                        s.public_key = bytes(v2)
            elif tag == 2:
                _require_wt(wt, 2, tag)
                for t2, w2, v2 in _parse_fields(bytes(val)):
                    if t2 == 1:
                        _require_wt(w2, 2, t2)
                        for t3, w3, v3 in _parse_fields(bytes(v2)):
                            if t3 == 1:
                                _require_wt(w3, 0, t3)
                                mode = int(v3)
            elif tag == 3:
                _require_wt(wt, 0, tag)
                s.sequence = int(val)
        # the check runs whether or not mode_info was present: an
        # OMITTED mode_info must not bypass the DIRECT requirement (the
        # SDK rejects unset sign modes)
        if mode != SIGN_MODE_DIRECT:
            raise ValueError(f"unsupported sign mode {mode} (only DIRECT)")
        return s


def _field_bytes_present(tag: int, payload: bytes) -> bytes:
    """Length-delimited field emitted even when empty (presence encoding)."""
    from celestia_tpu_torch.blob import uvarint

    return uvarint(tag << 3 | 2) + uvarint(len(payload)) + payload


@dataclasses.dataclass
class Tx:
    """A decoded transaction.

    SIGN_MODE_DIRECT signs the body/auth bytes exactly as transmitted, so
    unmarshalled txs retain their raw encodings (`_raw_body`/`_raw_auth`)
    and signature verification uses those — a re-serialization would make
    signed txs byte-malleable through unknown-field stripping.
    """

    msgs: list  # registered msg objects
    signer_infos: list[SignerInfo]
    fee: Fee
    signatures: list[bytes]
    memo: str = ""
    _raw_body: bytes | None = dataclasses.field(default=None, repr=False)
    _raw_auth: bytes | None = dataclasses.field(default=None, repr=False)

    # --- encoding ---

    def body_bytes(self) -> bytes:
        if self._raw_body is not None:
            return self._raw_body
        out = b""
        for m in self.msgs:
            any_bytes = _field_bytes(1, m.TYPE_URL.encode()) + _field_bytes_present(
                2, m.marshal()
            )
            out += _field_bytes(1, any_bytes)
        out += _field_bytes(2, self.memo.encode())
        return out

    def auth_info_bytes(self) -> bytes:
        if self._raw_auth is not None:
            return self._raw_auth
        out = b""
        for si in self.signer_infos:
            out += _field_bytes(1, si.marshal())
        out += _field_bytes(2, self.fee.marshal())
        return out

    def marshal(self) -> bytes:
        out = _field_bytes(1, self.body_bytes()) + _field_bytes(
            2, self.auth_info_bytes()
        )
        for sig in self.signatures:
            out += _field_bytes(3, sig)
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Tx":
        body = b""
        auth = b""
        sigs: list[bytes] = []
        for tag, wt, val in _parse_fields(raw):
            if tag == 1:
                _require_wt(wt, 2, tag)
                body = bytes(val)
            elif tag == 2:
                _require_wt(wt, 2, tag)
                auth = bytes(val)
            elif tag == 3:
                _require_wt(wt, 2, tag)
                sigs.append(bytes(val))

        msgs = []
        memo = ""
        for tag, wt, val in _parse_fields(body):
            if tag == 1:
                _require_wt(wt, 2, tag)
                type_url = ""
                value = b""
                for t2, w2, v2 in _parse_fields(bytes(val)):
                    if t2 == 1:
                        _require_wt(w2, 2, t2)
                        type_url = bytes(v2).decode()
                    elif t2 == 2:
                        _require_wt(w2, 2, t2)
                        value = bytes(v2)
                msgs.append(decode_any(type_url, value))
            elif tag == 2:
                _require_wt(wt, 2, tag)
                memo = bytes(val).decode()

        signer_infos: list[SignerInfo] = []
        fee = Fee()
        for tag, wt, val in _parse_fields(auth):
            if tag == 1:
                _require_wt(wt, 2, tag)
                signer_infos.append(SignerInfo.unmarshal(bytes(val)))
            elif tag == 2:
                _require_wt(wt, 2, tag)
                fee = Fee.unmarshal(bytes(val))
        return cls(msgs=msgs, signer_infos=signer_infos, fee=fee,
                   signatures=sigs, memo=memo, _raw_body=body, _raw_auth=auth)


def sign_doc_bytes(
    body_bytes: bytes, auth_info_bytes: bytes, chain_id: str, account_number: int
) -> bytes:
    """SIGN_MODE_DIRECT sign document."""
    return (
        _field_bytes(1, body_bytes)
        + _field_bytes(2, auth_info_bytes)
        + _field_bytes(3, chain_id.encode())
        + _field_uint(4, account_number)
    )


def sign_tx(
    priv_key,
    msgs: list,
    chain_id: str,
    account_number: int,
    sequence: int,
    fee: Fee | None = None,
    memo: str = "",
) -> Tx:
    """Build and sign a single-signer tx in direct mode."""
    fee = fee or Fee()
    tx = Tx(
        msgs=msgs,
        signer_infos=[SignerInfo(priv_key.public_key(), sequence)],
        fee=fee,
        signatures=[],
        memo=memo,
    )
    doc = sign_doc_bytes(tx.body_bytes(), tx.auth_info_bytes(), chain_id, account_number)
    tx.signatures = [priv_key.sign(doc)]
    return tx


def decode_tx(raw: bytes) -> Tx:
    """TxDecoder analogue, IndexWrapper-aware
    (ref: app/encoding/index_wrapper_decoder.go: wrapped txs decode to their
    inner tx)."""
    from celestia_tpu_torch import blob as blob_pkg

    wrapper, is_wrapped = blob_pkg.unmarshal_index_wrapper(raw)
    if is_wrapped:
        raw = wrapper.tx
    return Tx.unmarshal(raw)
