"""29-byte versioned namespaces.

Reference semantics: pkg/namespace/namespace.go, pkg/namespace/consts.go.
A namespace is 1 version byte + 28 ID bytes. Version-0 namespaces must have
an 18-zero-byte ID prefix, leaving 10 user bytes.
"""

from __future__ import annotations

import dataclasses
import functools

NAMESPACE_VERSION_SIZE = 1
NAMESPACE_ID_SIZE = 28
NAMESPACE_SIZE = NAMESPACE_VERSION_SIZE + NAMESPACE_ID_SIZE
NAMESPACE_VERSION_ZERO = 0
NAMESPACE_VERSION_MAX = 255
NAMESPACE_VERSION_ZERO_PREFIX_SIZE = 18
NAMESPACE_VERSION_ZERO_ID_SIZE = NAMESPACE_ID_SIZE - NAMESPACE_VERSION_ZERO_PREFIX_SIZE
NAMESPACE_VERSION_ZERO_PREFIX = bytes(NAMESPACE_VERSION_ZERO_PREFIX_SIZE)

SUPPORTED_BLOB_NAMESPACE_VERSIONS = (NAMESPACE_VERSION_ZERO,)


@dataclasses.dataclass(frozen=True, order=False)
class Namespace:
    version: int
    id: bytes

    def __post_init__(self):
        if len(self.id) != NAMESPACE_ID_SIZE:
            raise ValueError(
                f"namespace id must be {NAMESPACE_ID_SIZE} bytes, got {len(self.id)}"
            )

    @property
    def bytes(self) -> bytes:
        return bytes([self.version]) + self.id

    # Ordering is over the full (version ‖ id) byte string.
    def __lt__(self, other: "Namespace") -> bool:
        return self.bytes < other.bytes

    def __le__(self, other: "Namespace") -> bool:
        return self.bytes <= other.bytes

    def __gt__(self, other: "Namespace") -> bool:
        return self.bytes > other.bytes

    def __ge__(self, other: "Namespace") -> bool:
        return self.bytes >= other.bytes

    def is_reserved(self) -> bool:
        return self.is_primary_reserved() or self.is_secondary_reserved()

    def is_primary_reserved(self) -> bool:
        return self <= MAX_PRIMARY_RESERVED_NAMESPACE

    def is_secondary_reserved(self) -> bool:
        return self >= MIN_SECONDARY_RESERVED_NAMESPACE

    def is_parity_shares(self) -> bool:
        return self == PARITY_SHARES_NAMESPACE

    def is_tail_padding(self) -> bool:
        return self == TAIL_PADDING_NAMESPACE

    def is_primary_reserved_padding(self) -> bool:
        return self == PRIMARY_RESERVED_PADDING_NAMESPACE

    def is_tx(self) -> bool:
        return self == TX_NAMESPACE

    def is_pay_for_blob(self) -> bool:
        return self == PAY_FOR_BLOB_NAMESPACE

    def repeat(self, n: int) -> list["Namespace"]:
        return [self] * n


def new_namespace(version: int, id: bytes) -> Namespace:
    # Namespace is frozen, so one cached instance serves every
    # occurrence — construction+validation sits on the block-building
    # hot path (once per blob share write)
    return _new_namespace_cached(version, bytes(id))


@functools.lru_cache(maxsize=8192)
def _new_namespace_cached(version: int, id: bytes) -> Namespace:
    _validate_version_supported(version)
    _validate_id(version, id)
    return Namespace(version, id)


def new_v0(sub_id: bytes) -> Namespace:
    """Version-0 namespace from <=10 user bytes (left-padded with zeros)."""
    if len(sub_id) > NAMESPACE_VERSION_ZERO_ID_SIZE:
        raise ValueError(
            f"subID must be <= {NAMESPACE_VERSION_ZERO_ID_SIZE} bytes, got {len(sub_id)}"
        )
    sub_id = sub_id.rjust(NAMESPACE_VERSION_ZERO_ID_SIZE, b"\x00")
    id_ = NAMESPACE_VERSION_ZERO_PREFIX + sub_id
    return new_namespace(NAMESPACE_VERSION_ZERO, id_)


def from_bytes(b: bytes) -> Namespace:
    if len(b) != NAMESPACE_SIZE:
        raise ValueError(f"invalid namespace length {len(b)}, must be {NAMESPACE_SIZE}")
    return new_namespace(b[0], b[1:])


def _validate_version_supported(version: int) -> None:
    if version not in (NAMESPACE_VERSION_ZERO, NAMESPACE_VERSION_MAX):
        raise ValueError(f"unsupported namespace version {version}")


def _validate_id(version: int, id: bytes) -> None:
    if len(id) != NAMESPACE_ID_SIZE:
        raise ValueError(f"namespace id must be {NAMESPACE_ID_SIZE} bytes")
    if version == NAMESPACE_VERSION_ZERO and not id.startswith(
        NAMESPACE_VERSION_ZERO_PREFIX
    ):
        raise ValueError(
            f"version-0 namespace id must start with {NAMESPACE_VERSION_ZERO_PREFIX_SIZE} zeros"
        )


def _primary_reserved(last_byte: int) -> Namespace:
    return Namespace(
        NAMESPACE_VERSION_ZERO, bytes(NAMESPACE_ID_SIZE - 1) + bytes([last_byte])
    )


def _secondary_reserved(last_byte: int) -> Namespace:
    return Namespace(
        NAMESPACE_VERSION_MAX, b"\xff" * (NAMESPACE_ID_SIZE - 1) + bytes([last_byte])
    )


TX_NAMESPACE = _primary_reserved(0x01)
INTERMEDIATE_STATE_ROOTS_NAMESPACE = _primary_reserved(0x02)
PAY_FOR_BLOB_NAMESPACE = _primary_reserved(0x04)
PRIMARY_RESERVED_PADDING_NAMESPACE = _primary_reserved(0xFF)
MAX_PRIMARY_RESERVED_NAMESPACE = _primary_reserved(0xFF)
MIN_SECONDARY_RESERVED_NAMESPACE = _secondary_reserved(0x00)
TAIL_PADDING_NAMESPACE = _secondary_reserved(0xFE)
PARITY_SHARES_NAMESPACE = _secondary_reserved(0xFF)
