"""The 512-byte share wire format.

Reference semantics: pkg/shares/shares.go, share_builder.go, info_byte.go,
padding.go. Share layout:

  namespace(29) ‖ info byte(1) ‖ [sequence len(4) if sequence start]
  ‖ [reserved bytes(4) if compact] ‖ data, zero-padded to 512.

The info byte packs version (high 7 bits) and a sequence-start flag (low
bit). Compact shares (tx/PFB namespaces) carry 4 reserved bytes pointing at
the first unit that starts in the share.
"""

from __future__ import annotations


from celestia_tpu_torch import appconsts
from celestia_tpu_torch import namespace as ns_pkg
from celestia_tpu_torch.namespace import Namespace

from .info_byte import InfoByte, new_info_byte, parse_info_byte  # noqa: F401


class Share:
    """One 512-byte share. Semantically immutable (`data` is bytes and
    is never reassigned in-tree); a hand-rolled __slots__ class instead
    of a frozen dataclass because block building constructs thousands
    per square and frozen-dataclass __init__ costs ~2x (it routes every
    field through object.__setattr__)."""

    __slots__ = ("data",)

    def __init__(self, data: bytes):
        if len(data) != appconsts.SHARE_SIZE:
            raise ValueError(
                f"share data must be {appconsts.SHARE_SIZE} bytes, got {len(data)}"
            )
        object.__setattr__(self, "data", data)

    def __setattr__(self, name, value):
        # immutability is load-bearing: padding shares are lru-cached
        # singletons shared across every square, and Share hashes by
        # its bytes — a silent mutation would corrupt both
        raise AttributeError("Share is immutable")

    def __eq__(self, other) -> bool:
        return isinstance(other, Share) and self.data == other.data

    def __hash__(self) -> int:
        return hash(self.data)

    def __repr__(self) -> str:
        return f"Share({self.data[:8].hex()}…)"

    def namespace(self) -> Namespace:
        return ns_pkg.from_bytes(self.data[: appconsts.NAMESPACE_SIZE])

    def info_byte(self) -> InfoByte:
        return parse_info_byte(self.data[appconsts.NAMESPACE_SIZE])

    def version(self) -> int:
        return self.info_byte().version

    def is_sequence_start(self) -> bool:
        return self.info_byte().is_sequence_start

    def is_compact_share(self) -> bool:
        n = self.namespace()
        return n.is_tx() or n.is_pay_for_blob()

    def sequence_len(self) -> int:
        """0 for continuation shares (no sequence length present)."""
        if not self.is_sequence_start():
            return 0
        start = appconsts.NAMESPACE_SIZE + appconsts.SHARE_INFO_BYTES
        return int.from_bytes(
            self.data[start : start + appconsts.SEQUENCE_LEN_BYTES], "big"
        )

    def is_padding(self) -> bool:
        n = self.namespace()
        is_ns_padding = self.is_sequence_start() and self.sequence_len() == 0
        return is_ns_padding or n.is_tail_padding() or n.is_primary_reserved_padding()

    def _raw_data_start_index(self) -> int:
        index = appconsts.NAMESPACE_SIZE + appconsts.SHARE_INFO_BYTES
        if self.is_sequence_start():
            index += appconsts.SEQUENCE_LEN_BYTES
        if self.is_compact_share():
            index += appconsts.COMPACT_SHARE_RESERVED_BYTES
        return index

    def raw_data(self) -> bytes:
        return self.data[self._raw_data_start_index() :]

    def reserved_bytes(self) -> int:
        """The reserved-bytes pointer of a compact share."""
        if not self.is_compact_share():
            raise ValueError("not a compact share")
        index = appconsts.NAMESPACE_SIZE + appconsts.SHARE_INFO_BYTES
        if self.is_sequence_start():
            index += appconsts.SEQUENCE_LEN_BYTES
        return int.from_bytes(
            self.data[index : index + appconsts.COMPACT_SHARE_RESERVED_BYTES], "big"
        )

    def raw_data_using_reserved(self) -> bytes:
        """Raw data starting at the reserved-bytes pointer (compact shares)."""
        start = self.reserved_bytes()
        if start == 0:
            return b""
        return self.data[start:]

    def to_bytes(self) -> bytes:
        return self.data


def to_bytes(shares: list[Share]) -> list[bytes]:
    return [s.data for s in shares]


def from_bytes(raw: list[bytes]) -> list[Share]:
    return [Share(bytes(b)) for b in raw]


MAX_RESERVED_BYTES = appconsts.SHARE_SIZE - 1


def new_reserved_bytes(byte_index: int) -> bytes:
    """4-byte big-endian pointer to the first unit starting in this share.
    ref: pkg/shares/reserved_bytes.go"""
    if byte_index >= appconsts.SHARE_SIZE:
        raise ValueError(f"reserved bytes {byte_index} must be < {appconsts.SHARE_SIZE}")
    return byte_index.to_bytes(appconsts.COMPACT_SHARE_RESERVED_BYTES, "big")


class Builder:
    """Low-level share writer. ref: pkg/shares/share_builder.go:11-225"""

    def __init__(self, namespace: Namespace, share_version: int, is_first_share: bool):
        self.namespace = namespace
        self.share_version = share_version
        self.is_first_share = is_first_share
        self.is_compact_share = namespace.is_tx() or namespace.is_pay_for_blob()
        self.raw_share_data = bytearray()
        self._init()

    def _init(self) -> None:
        info = new_info_byte(self.share_version, self.is_first_share)
        data = bytearray(self.namespace.bytes)
        data.append(int(info))
        if self.is_first_share:
            data += bytes(appconsts.SEQUENCE_LEN_BYTES)
        if self.is_compact_share:
            data += bytes(appconsts.COMPACT_SHARE_RESERVED_BYTES)
        self.raw_share_data = data

    def import_raw_share(self, raw: bytes) -> "Builder":
        self.raw_share_data = bytearray(raw)
        return self

    def available_bytes(self) -> int:
        return appconsts.SHARE_SIZE - len(self.raw_share_data)

    def add_data(self, raw: bytes) -> bytes | None:
        """Append data; returns the leftover that didn't fit, or None."""
        pending_left = appconsts.SHARE_SIZE - len(self.raw_share_data)
        if len(raw) <= pending_left:
            self.raw_share_data += raw
            return None
        self.raw_share_data += raw[:pending_left]
        return raw[pending_left:]

    def write_sequence_len(self, sequence_len: int) -> None:
        if not self.is_first_share:
            raise ValueError("not the first share")
        off = appconsts.NAMESPACE_SIZE + appconsts.SHARE_INFO_BYTES
        self.raw_share_data[off : off + appconsts.SEQUENCE_LEN_BYTES] = (
            sequence_len.to_bytes(appconsts.SEQUENCE_LEN_BYTES, "big")
        )

    def flip_sequence_start(self) -> None:
        idx = appconsts.NAMESPACE_SIZE
        self.raw_share_data[idx] ^= 0x01

    def _index_of_reserved_bytes(self) -> int:
        idx = appconsts.NAMESPACE_SIZE + appconsts.SHARE_INFO_BYTES
        if self.is_first_share:
            idx += appconsts.SEQUENCE_LEN_BYTES
        return idx

    def is_empty_share(self) -> bool:
        expected = appconsts.NAMESPACE_SIZE + appconsts.SHARE_INFO_BYTES
        if self.is_compact_share:
            expected += appconsts.COMPACT_SHARE_RESERVED_BYTES
        if self.is_first_share:
            expected += appconsts.SEQUENCE_LEN_BYTES
        return len(self.raw_share_data) == expected

    def maybe_write_reserved_bytes(self) -> None:
        """Write the next-unit pointer if the reserved bytes are still empty."""
        if not self.is_compact_share:
            raise ValueError("this is not a compact share")
        idx = self._index_of_reserved_bytes()
        current = self.raw_share_data[idx : idx + appconsts.COMPACT_SHARE_RESERVED_BYTES]
        if int.from_bytes(current, "big") != 0:
            return
        self.raw_share_data[idx : idx + appconsts.COMPACT_SHARE_RESERVED_BYTES] = (
            new_reserved_bytes(len(self.raw_share_data))
        )

    def zero_pad_if_necessary(self) -> int:
        padding = appconsts.SHARE_SIZE - len(self.raw_share_data)
        if padding > 0:
            self.raw_share_data += bytes(padding)
        return max(padding, 0)

    def build(self) -> Share:
        return Share(bytes(self.raw_share_data))


# --- Padding shares (ref: pkg/shares/padding.go) ---


import functools


@functools.lru_cache(maxsize=64)
def _cached_padding_share(ns_bytes: bytes, share_version: int) -> Share:
    b = Builder(ns_pkg.from_bytes(ns_bytes), share_version, True)
    b.write_sequence_len(0)
    b.add_data(bytes(appconsts.FIRST_SPARSE_SHARE_CONTENT_SIZE))
    return b.build()


def namespace_padding_share(namespace: Namespace, share_version: int) -> Share:
    # Padding shares are constant per (namespace, version); Share is
    # immutable (__setattr__ guard) so one cached instance serves every
    # occurrence — a square can contain thousands of identical
    # tail-padding shares.
    return _cached_padding_share(namespace.bytes, share_version)


def namespace_padding_shares(namespace: Namespace, share_version: int, n: int) -> list[Share]:
    return [namespace_padding_share(namespace, share_version)] * n


def reserved_padding_share() -> Share:
    return namespace_padding_share(
        ns_pkg.PRIMARY_RESERVED_PADDING_NAMESPACE, appconsts.SHARE_VERSION_ZERO
    )


def reserved_padding_shares(n: int) -> list[Share]:
    return [reserved_padding_share()] * n


def tail_padding_share() -> Share:
    return namespace_padding_share(
        ns_pkg.TAIL_PADDING_NAMESPACE, appconsts.SHARE_VERSION_ZERO
    )


def tail_padding_shares(n: int) -> list[Share]:
    return [tail_padding_share()] * n


def is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def round_up_power_of_two(n: int) -> int:
    """Smallest power of two >= n. ref: pkg/shares/powers_of_two.go"""
    k = 1
    while k < n:
        k <<= 1
    return k


def round_down_power_of_two(n: int) -> int:
    if n <= 0:
        raise ValueError("n must be positive")
    k = round_up_power_of_two(n)
    return k if k == n else k // 2
