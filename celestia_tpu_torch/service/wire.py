"""proto3 wire codecs for tpu_codec.proto, byte-compatible with protoc
(port of the JAX package's service/wire.py).

The protobuf wire format is written by hand, as ``blob.py`` writes BlobTx:
no protoc-generated Python is needed at run time, and a Go (or other)
client generated from ``tpu_codec.proto`` interoperates bit for bit. As
proto3 requires, a scalar or bytes field at its zero value is omitted.
"""

from __future__ import annotations

import dataclasses

from celestia_tpu_torch.blob import (
    _field_bytes,
    _field_uint as _uint_field,
    _parse_fields,
    _require_wt,
)


@dataclasses.dataclass
class EncodeRequest:
    k: int = 0
    share_size: int = 0
    shares: bytes = b""

    def marshal(self) -> bytes:
        return (
            _uint_field(1, self.k)
            + _uint_field(2, self.share_size)
            + (_field_bytes(3, self.shares) if self.shares else b"")
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "EncodeRequest":
        m = cls()
        for tag, wt, val in _parse_fields(raw):
            if tag == 1:
                _require_wt(wt, 0, tag)
                m.k = val
            elif tag == 2:
                _require_wt(wt, 0, tag)
                m.share_size = val
            elif tag == 3:
                _require_wt(wt, 2, tag)
                m.shares = bytes(val)
        return m


@dataclasses.dataclass
class EdsRequest:
    k: int = 0
    share_size: int = 0
    eds: bytes = b""

    def marshal(self) -> bytes:
        return (
            _uint_field(1, self.k)
            + _uint_field(2, self.share_size)
            + (_field_bytes(3, self.eds) if self.eds else b"")
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "EdsRequest":
        m = cls()
        for tag, wt, val in _parse_fields(raw):
            if tag == 1:
                _require_wt(wt, 0, tag)
                m.k = val
            elif tag == 2:
                _require_wt(wt, 0, tag)
                m.share_size = val
            elif tag == 3:
                _require_wt(wt, 2, tag)
                m.eds = bytes(val)
        return m


@dataclasses.dataclass
class RepairRequest:
    k: int = 0
    share_size: int = 0
    eds: bytes = b""
    present: bytes = b""

    def marshal(self) -> bytes:
        return (
            _uint_field(1, self.k)
            + _uint_field(2, self.share_size)
            + (_field_bytes(3, self.eds) if self.eds else b"")
            + (_field_bytes(4, self.present) if self.present else b"")
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "RepairRequest":
        m = cls()
        for tag, wt, val in _parse_fields(raw):
            if tag == 1:
                _require_wt(wt, 0, tag)
                m.k = val
            elif tag == 2:
                _require_wt(wt, 0, tag)
                m.share_size = val
            elif tag == 3:
                _require_wt(wt, 2, tag)
                m.eds = bytes(val)
            elif tag == 4:
                _require_wt(wt, 2, tag)
                m.present = bytes(val)
        return m


@dataclasses.dataclass
class EdsResponse:
    eds: bytes = b""

    def marshal(self) -> bytes:
        return _field_bytes(1, self.eds) if self.eds else b""

    @classmethod
    def unmarshal(cls, raw: bytes) -> "EdsResponse":
        m = cls()
        for tag, wt, val in _parse_fields(raw):
            if tag == 1:
                _require_wt(wt, 2, tag)
                m.eds = bytes(val)
        return m


@dataclasses.dataclass
class RootsResponse:
    row_roots: list[bytes] = dataclasses.field(default_factory=list)
    col_roots: list[bytes] = dataclasses.field(default_factory=list)
    dah_hash: bytes = b""

    def marshal(self) -> bytes:
        out = b"".join(_field_bytes(1, r) for r in self.row_roots)
        out += b"".join(_field_bytes(2, c) for c in self.col_roots)
        if self.dah_hash:
            out += _field_bytes(3, self.dah_hash)
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "RootsResponse":
        m = cls()
        for tag, wt, val in _parse_fields(raw):
            if tag == 1:
                _require_wt(wt, 2, tag)
                m.row_roots.append(bytes(val))
            elif tag == 2:
                _require_wt(wt, 2, tag)
                m.col_roots.append(bytes(val))
            elif tag == 3:
                _require_wt(wt, 2, tag)
                m.dah_hash = bytes(val)
        return m
