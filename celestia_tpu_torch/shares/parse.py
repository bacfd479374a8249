"""Share parsers — the inverse of the splitters.

Reference semantics: pkg/shares/parse.go, parse_compact_shares.go,
parse_sparse_shares.go, share_sequence.go.
"""

from __future__ import annotations

import dataclasses

from celestia_tpu_torch import blob as blob_pkg
from celestia_tpu_torch.namespace import Namespace

from . import Share
from .splitters import (
    compact_shares_needed,
    parse_delimiter,
    sparse_shares_needed,
)

SUPPORTED_SHARE_VERSIONS = blob_pkg.SUPPORTED_SHARE_VERSIONS


def parse_compact_shares(
    shares: list[Share], supported_versions=SUPPORTED_SHARE_VERSIONS
) -> list[bytes]:
    """Extract length-delimited units (txs) from compact shares."""
    if not shares:
        return []
    _validate_versions(shares, supported_versions)
    raw = _extract_raw_data(shares)
    return _parse_raw_data(raw)


def _validate_versions(shares: list[Share], supported) -> None:
    for s in shares:
        if s.version() not in supported:
            raise ValueError(f"unsupported share version {s.version()}")


def _extract_raw_data(shares: list[Share]) -> bytes:
    """First share read from its reserved-bytes pointer, rest fully."""
    out = bytearray()
    for i, s in enumerate(shares):
        out += s.raw_data_using_reserved() if i == 0 else s.raw_data()
    return bytes(out)


def _parse_raw_data(raw: bytes) -> list[bytes]:
    units: list[bytes] = []
    while True:
        rest, unit_len = parse_delimiter(raw)
        if unit_len == 0:
            return units
        if unit_len > len(rest):
            return units
        units.append(rest[:unit_len])
        raw = rest[unit_len:]


def parse_txs(shares: list[Share]) -> list[bytes]:
    return parse_compact_shares(shares)


def parse_sparse_shares(
    shares: list[Share], supported_versions=SUPPORTED_SHARE_VERSIONS
) -> list[blob_pkg.Blob]:
    """Reassemble blobs from sparse shares, skipping padding sequences."""
    if not shares:
        return []
    sequences: list[tuple[blob_pkg.Blob, int]] = []
    for share in shares:
        if share.version() not in supported_versions:
            raise ValueError(f"unsupported share version {share.version()}")
        if share.is_padding():
            continue
        if share.is_sequence_start():
            b = blob_pkg.Blob(
                namespace_id=share.namespace().id,
                data=share.raw_data(),
                share_version=share.version(),
                namespace_version=share.namespace().version,
            )
            sequences.append((b, share.sequence_len()))
        else:
            if not sequences:
                raise ValueError("continuation share without a sequence start")
            b, _ = sequences[-1]
            b.data = b.data + share.raw_data()
    out = []
    for b, seq_len in sequences:
        if len(b.data) < seq_len:
            raise ValueError(
                f"blob declares sequence length {seq_len} but only "
                f"{len(b.data)} bytes are present in its shares"
            )
        b.data = b.data[:seq_len]
        out.append(b)
    return out


def parse_blobs(shares: list[Share]) -> list[blob_pkg.Blob]:
    return parse_sparse_shares(shares)


@dataclasses.dataclass
class ShareSequence:
    namespace: Namespace
    shares: list[Share]

    def raw_data(self) -> bytes:
        return b"".join(s.raw_data() for s in self.shares)

    def sequence_len(self) -> int:
        return self.shares[0].sequence_len() if self.shares else 0

    def valid_sequence_len(self) -> None:
        """ref: pkg/shares/share_sequence.go:43-70 (padding sequences skip
        the length check)."""
        if not self.shares:
            raise ValueError("invalid sequence length because share sequence is empty")
        if self.is_padding():
            return
        first = self.shares[0]
        if first.is_compact_share():
            expected = compact_shares_needed(first.sequence_len())
        else:
            expected = sparse_shares_needed(first.sequence_len())
        if len(self.shares) != expected:
            raise ValueError(
                f"share sequence has {len(self.shares)} shares but "
                f"needed {expected} shares"
            )

    def is_padding(self) -> bool:
        return len(self.shares) == 1 and self.shares[0].is_padding()


def parse_share_sequences(
    shares: list[Share], ignore_padding: bool = False
) -> list[ShareSequence]:
    """Group shares into sequences. ref: pkg/shares/parse.go ParseShares"""
    sequences: list[ShareSequence] = []
    current: ShareSequence | None = None
    for share in shares:
        if share.is_sequence_start():
            if current is not None:
                sequences.append(current)
            current = ShareSequence(namespace=share.namespace(), shares=[share])
        else:
            if current is None or current.namespace.bytes != share.namespace().bytes:
                raise ValueError(
                    "share sequence has inconsistent namespaces with share"
                )
            current.shares.append(share)
    if current is not None:
        sequences.append(current)

    for seq in sequences:
        seq.valid_sequence_len()

    if ignore_padding:
        sequences = [s for s in sequences if not s.is_padding()]
    return sequences
