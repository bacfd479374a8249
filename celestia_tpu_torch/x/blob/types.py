"""MsgPayForBlobs + BlobTx validation.

Reference semantics: x/blob/types/payforblob.go, x/blob/types/blob_tx.go,
proto/celestia/blob/v1/tx.proto.
"""

from __future__ import annotations

import dataclasses

from celestia_tpu_torch import appconsts
from celestia_tpu_torch import blob as blob_pkg
from celestia_tpu_torch import inclusion
from celestia_tpu_torch import namespace as ns_pkg
from celestia_tpu_torch.blob import _field_bytes, _field_uint, _parse_fields, _require_wt
from celestia_tpu_torch.bech32 import bech32_decode
from celestia_tpu_torch.shares.splitters import sparse_shares_needed
from celestia_tpu_torch.tx import register_msg

# ref: x/blob/types/payforblob.go:36-41
PFB_GAS_FIXED_COST = 75_000
BYTES_PER_BLOB_INFO = 70

URL_MSG_PAY_FOR_BLOBS = "/celestia.blob.v1.MsgPayForBlobs"


@register_msg(URL_MSG_PAY_FOR_BLOBS)
@dataclasses.dataclass
class MsgPayForBlobs:
    signer: str
    namespaces: list[bytes]  # 29-byte version‖id each
    blob_sizes: list[int]
    share_commitments: list[bytes]
    share_versions: list[int]

    def get_signers(self) -> list[str]:
        """ref: x/blob/types/payforblob.go GetSigners."""
        return [self.signer]

    def marshal(self) -> bytes:
        # proto3 packs `repeated uint32` by default (one length-delimited
        # field holding concatenated varints) — the reference's generated
        # Go code does exactly this, so byte parity requires it here
        # (proto/celestia/blob/v1/tx.proto fields 3 and 8)
        from celestia_tpu_torch.blob import uvarint

        out = _field_bytes(1, self.signer.encode())
        for ns in self.namespaces:
            out += _field_bytes(2, ns)
        if self.blob_sizes:
            out += _field_bytes(
                3, b"".join(uvarint(s) for s in self.blob_sizes)
            )
        for c in self.share_commitments:
            out += _field_bytes(4, c)
        if self.share_versions:
            out += _field_bytes(
                8, b"".join(uvarint(v) for v in self.share_versions)
            )
        return out

    @staticmethod
    def _repeated_uint(wt: int, val, into: list[int]) -> None:
        """Packed (wt 2) or unpacked (wt 0) repeated scalar — a
        conforming proto parser accepts both encodings."""
        from celestia_tpu_torch.blob import read_uvarint

        if wt == 0:
            into.append(int(val))
            return
        if wt != 2:
            raise ValueError(f"repeated uint field has wire type {wt}")
        buf, pos = bytes(val), 0
        while pos < len(buf):
            n, pos = read_uvarint(buf, pos)
            into.append(n)

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgPayForBlobs":
        msg = cls("", [], [], [], [])
        for tag, wt, val in _parse_fields(raw):
            if tag == 1:
                _require_wt(wt, 2, tag)
                msg.signer = bytes(val).decode()
            elif tag == 2:
                _require_wt(wt, 2, tag)
                msg.namespaces.append(bytes(val))
            elif tag == 3:
                cls._repeated_uint(wt, val, msg.blob_sizes)
            elif tag == 4:
                _require_wt(wt, 2, tag)
                msg.share_commitments.append(bytes(val))
            elif tag == 8:
                cls._repeated_uint(wt, val, msg.share_versions)
        return msg

    def validate_basic(self) -> None:
        """Stateless checks. ref: x/blob/types/payforblob.go:95-148"""
        if not self.namespaces:
            raise ValueError("no namespaces")
        if not self.share_versions:
            raise ValueError("no share versions")
        if not self.blob_sizes:
            raise ValueError("no blob sizes")
        if not self.share_commitments:
            raise ValueError("no share commitments")
        if not (
            len(self.namespaces)
            == len(self.share_versions)
            == len(self.blob_sizes)
            == len(self.share_commitments)
        ):
            raise ValueError(
                f"mismatched number of PFB components: namespaces "
                f"{len(self.namespaces)} blob sizes {len(self.blob_sizes)} "
                f"share versions {len(self.share_versions)} share commitments "
                f"{len(self.share_commitments)}"
            )
        for raw_ns in self.namespaces:
            ns = ns_pkg.from_bytes(raw_ns)
            validate_blob_namespace(ns)
        for v in self.share_versions:
            if v != appconsts.SHARE_VERSION_ZERO:
                raise ValueError("unsupported share version")
        hrp, _ = bech32_decode(self.signer)  # raises on invalid address
        for c in self.share_commitments:
            if len(c) != appconsts.HASH_LENGTH:
                raise ValueError("invalid share commitment length")

    def gas(self, gas_per_byte: int) -> int:
        return gas_to_consume(self.blob_sizes, gas_per_byte)


def validate_blob_namespace(ns: ns_pkg.Namespace) -> None:
    """ref: x/blob/types/payforblob.go:182-194"""
    if ns.is_reserved():
        raise ValueError("namespace is reserved")
    if ns.version not in ns_pkg.SUPPORTED_BLOB_NAMESPACE_VERSIONS:
        raise ValueError("invalid namespace version")


def validate_blobs(*blobs: blob_pkg.Blob) -> None:
    """ref: x/blob/types/payforblob.go ValidateBlobs"""
    if not blobs:
        raise ValueError("no blobs")
    for b in blobs:
        b.validate()
        validate_blob_namespace(b.namespace())
        if b.share_version != appconsts.SHARE_VERSION_ZERO:
            raise ValueError("unsupported share version")


def gas_to_consume(blob_sizes: list[int], gas_per_byte: int) -> int:
    """ref: x/blob/types/payforblob.go:157-164"""
    total_shares = sum(sparse_shares_needed(size) for size in blob_sizes)
    return total_shares * appconsts.SHARE_SIZE * gas_per_byte


def estimate_gas(
    blob_sizes: list[int],
    gas_per_byte: int = appconsts.DEFAULT_GAS_PER_BLOB_BYTE,
    tx_size_cost: int = 10,
) -> int:
    """ref: x/blob/types/payforblob.go:170-178"""
    return (
        gas_to_consume(blob_sizes, gas_per_byte)
        + tx_size_cost * BYTES_PER_BLOB_INFO * len(blob_sizes)
        + PFB_GAS_FIXED_COST
    )


def new_msg_pay_for_blobs(signer: str, *blobs: blob_pkg.Blob) -> MsgPayForBlobs:
    """ref: x/blob/types/payforblob.go:47-76"""
    validate_blobs(*blobs)
    commitments = inclusion.create_commitments(list(blobs))
    msg = MsgPayForBlobs(
        signer=signer,
        namespaces=[b.namespace().bytes for b in blobs],
        blob_sizes=[len(b.data) for b in blobs],
        share_commitments=commitments,
        share_versions=[b.share_version for b in blobs],
    )
    msg.validate_basic()
    return msg


def validate_blob_tx(btx: blob_pkg.BlobTx, sdk_tx=None):
    """Stateless BlobTx<->PFB consistency + commitment recompute.

    Accepts (and returns) the decoded inner Tx so hot-path callers that
    already decoded it don't pay a second protobuf parse.
    ref: x/blob/types/blob_tx.go:36-103"""
    from celestia_tpu_torch.tx import Tx

    if sdk_tx is None:
        sdk_tx = Tx.unmarshal(btx.tx)
    msgs = sdk_tx.msgs
    if len(msgs) != 1:
        raise ValueError("multiple msgs in blob tx not supported")
    msg = msgs[0]
    if not isinstance(msg, MsgPayForBlobs):
        raise ValueError("no PFB in blob tx")
    msg.validate_basic()

    sizes = [len(b.data) for b in btx.blobs]
    validate_blobs(*btx.blobs)
    if sizes != msg.blob_sizes:
        raise ValueError(f"blob size mismatch: actual {sizes} declared {msg.blob_sizes}")

    for i, raw_ns in enumerate(msg.namespaces):
        pfb_ns = ns_pkg.from_bytes(raw_ns)
        blob_ns = ns_pkg.new_namespace(
            btx.blobs[i].namespace_version, btx.blobs[i].namespace_id
        )
        if blob_ns.bytes != pfb_ns.bytes:
            raise ValueError("namespace mismatch between blob and PFB")

    for i, commitment in enumerate(msg.share_commitments):
        calculated = inclusion.create_commitment(btx.blobs[i])
        if calculated != commitment:
            raise ValueError("invalid share commitment")
    return sdk_tx


def pfb_blob_sizes(inner_tx: bytes) -> list[int]:
    """Blob sizes declared by the (single) PFB in a decoded tx — the hook
    square.deconstruct needs. ref: pkg/square/square.go:120-131"""
    from celestia_tpu_torch.tx import Tx

    sdk_tx = Tx.unmarshal(inner_tx)
    for msg in sdk_tx.msgs:
        if isinstance(msg, MsgPayForBlobs):
            return msg.blob_sizes
    raise ValueError("tx contains no MsgPayForBlobs")
