"""Share info byte: 7-bit version + sequence-start flag.
ref: pkg/shares/info_byte.go"""

from __future__ import annotations

import dataclasses

from celestia_tpu_torch import appconsts


@dataclasses.dataclass(frozen=True)
class InfoByte:
    version: int
    is_sequence_start: bool

    def __int__(self) -> int:
        return (self.version << 1) | (1 if self.is_sequence_start else 0)


def new_info_byte(version: int, is_sequence_start: bool) -> InfoByte:
    if version > appconsts.MAX_SHARE_VERSION:
        raise ValueError(
            f"version {version} must be <= {appconsts.MAX_SHARE_VERSION}"
        )
    return InfoByte(version, is_sequence_start)


def parse_info_byte(b: int) -> InfoByte:
    return new_info_byte(b >> 1, b % 2 == 1)
