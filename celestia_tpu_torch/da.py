"""Extended data square + DataAvailabilityHeader (port of celestia_tpu/da).

Reference semantics: pkg/da/data_availability_header.go and the rsmt2d
extension layout (Q1 = row-extend Q0, Q2 = col-extend Q0, Q3 = row-extend
Q2), with NMT row/column roots per pkg/wrapper/nmt_wrapper.go: Q0 cells keep
their own namespace, all parity cells use the parity namespace.

The square lives on the device: ``extend_shares`` runs the main path
(ops/extend.py) and wraps the resulting EDS tensor; its bytes reach the host
only on the first ``.data`` read. The DAH hash over the 4k axis roots is
computed on the host (ops/nmt_host.merkle_root).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from celestia_tpu_torch import namespace as ns
from celestia_tpu_torch.appconsts import (
    DEFAULT_SQUARE_SIZE_UPPER_BOUND,
    MIN_SQUARE_SIZE,
    NAMESPACE_SIZE,
    SHARE_SIZE,
)
from celestia_tpu_torch.ops import extend
from celestia_tpu_torch.ops.nmt_host import merkle_root

MAX_EXTENDED_SQUARE_WIDTH = DEFAULT_SQUARE_SIZE_UPPER_BOUND * 2
MIN_EXTENDED_SQUARE_WIDTH = MIN_SQUARE_SIZE * 2


class ExtendedDataSquare:
    """2k×2k erasure-extended share matrix, uint8 (2k, 2k, 512).

    Backed by a torch tensor (``device_data``) or by host bytes; the host
    copy of a device square is fetched on the first ``.data`` read. The axis
    roots are those the extension computed with the square, or, for a square
    given as bytes, ``extend.eds_roots_device`` over it."""

    def __init__(self, squares: np.ndarray | None, original_width: int,
                 device=None):
        """``device``: where the roots of host bytes are computed (None
        means CUDA, as for every entry of the port)."""
        self._data = squares
        self._device: torch.Tensor | None = None
        self._roots: tuple[np.ndarray, np.ndarray] | None = None
        self._compute_device = device
        self.original_width = original_width

    @classmethod
    def from_device(cls, device_buffer: torch.Tensor, original_width: int,
                    roots: tuple[np.ndarray, np.ndarray] | None = None,
                    ) -> "ExtendedDataSquare":
        """Wrap a (2k, 2k, 512) tensor without fetching it; ``roots`` are
        its (row_roots, col_roots) when the caller already has them."""
        eds = cls(None, original_width, device_buffer.device)
        eds._device = device_buffer
        eds._roots = roots
        return eds

    @property
    def data(self) -> np.ndarray:
        if self._data is None:
            self._data = self._device.cpu().numpy()  # one lazy fetch
        return self._data

    @data.setter
    def data(self, value: np.ndarray) -> None:
        self._data = value
        # the device copy and the roots no longer match the bytes
        self._device = None
        self._roots = None

    @property
    def device_data(self) -> torch.Tensor | None:
        """The device tensor when this EDS is device-resident (else None)."""
        return self._device

    @property
    def width(self) -> int:
        return 2 * self.original_width

    def _axis_roots(self) -> tuple[np.ndarray, np.ndarray]:
        if self._roots is None:
            source = self._device if self._device is not None else self._data
            self._roots = extend.eds_roots_device(source, self._compute_device)
        return self._roots

    def row_roots(self) -> list[bytes]:
        return [r.tobytes() for r in self._axis_roots()[0]]

    def col_roots(self) -> list[bytes]:
        return [c.tobytes() for c in self._axis_roots()[1]]


def extend_shares(shares: list[bytes] | np.ndarray,
                  device=None) -> ExtendedDataSquare:
    """shares: k*k row-major 512-byte shares -> the EDS, extended on
    ``device`` (None means CUDA). ref: pkg/da/data_availability_header.go:65"""
    if isinstance(shares, np.ndarray):
        if shares.dtype != np.uint8:
            raise ValueError(f"shares array must be uint8, got {shares.dtype}")
        flat = shares.reshape(-1, SHARE_SIZE)
        count = flat.shape[0]
    else:
        count = len(shares)
        if count == 0 or any(len(s) != SHARE_SIZE for s in shares):
            raise ValueError(f"shares must be {SHARE_SIZE} bytes")
        flat = np.frombuffer(b"".join(shares), dtype=np.uint8).reshape(count, -1)
    k = int(round(count**0.5))
    if count == 0 or k * k != count or (k & (k - 1)) != 0:
        raise ValueError(f"number of shares must be a square power of two, got {count}")
    if k > DEFAULT_SQUARE_SIZE_UPPER_BOUND:
        raise ValueError(f"square size {k} exceeds max {DEFAULT_SQUARE_SIZE_UPPER_BOUND}")
    eds, rows, cols = extend.extend_roots_device_resident(
        flat.reshape(k, k, SHARE_SIZE), device)
    return ExtendedDataSquare.from_device(eds, k, (rows, cols))


@dataclasses.dataclass
class DataAvailabilityHeader:
    row_roots: list[bytes]
    column_roots: list[bytes]
    _hash: bytes | None = dataclasses.field(default=None, compare=False, repr=False)

    def hash(self) -> bytes:
        """Merkle root over (row_roots ‖ column_roots).
        ref: pkg/da/data_availability_header.go:92-108"""
        if self._hash is None:
            self._hash = merkle_root(list(self.row_roots) + list(self.column_roots))
        return self._hash

    def to_json(self) -> dict:
        return {
            "row_roots": [r.hex() for r in self.row_roots],
            "column_roots": [c.hex() for c in self.column_roots],
        }

    @classmethod
    def from_json(cls, d: dict) -> "DataAvailabilityHeader":
        return cls(
            [bytes.fromhex(r) for r in d["row_roots"]],
            [bytes.fromhex(c) for c in d["column_roots"]],
        )

    def validate_basic(self) -> None:
        if len(self.column_roots) != len(self.row_roots):
            raise ValueError(
                "unequal number of row and column roots: "
                f"row {len(self.row_roots)} col {len(self.column_roots)}"
            )
        if len(self.row_roots) < MIN_EXTENDED_SQUARE_WIDTH:
            raise ValueError(
                f"minimum valid DataAvailabilityHeader has at least "
                f"{MIN_EXTENDED_SQUARE_WIDTH} row roots"
            )
        if len(self.row_roots) > MAX_EXTENDED_SQUARE_WIDTH:
            raise ValueError(
                f"maximum valid DataAvailabilityHeader has at most "
                f"{MAX_EXTENDED_SQUARE_WIDTH} row roots"
            )
        if len(self.hash()) != 32:
            raise ValueError(f"wrong hash: expected 32 bytes, got {len(self.hash())}")

    def square_size(self) -> int:
        return len(self.row_roots) // 2


def new_data_availability_header(eds: ExtendedDataSquare) -> DataAvailabilityHeader:
    dah = DataAvailabilityHeader(eds.row_roots(), eds.col_roots())
    dah.hash()
    return dah


def tail_padding_share() -> bytes:
    """The tail-padding share: TAIL_PADDING namespace ‖ info byte (share
    version 0, sequence start) ‖ sequence length 0 ‖ zeros.
    ref: pkg/shares/padding.go"""
    info = bytes([0 << 1 | 1])
    return (ns.TAIL_PADDING_NAMESPACE.bytes + info
            + bytes(SHARE_SIZE - NAMESPACE_SIZE - 1))


def min_data_availability_header(device=None) -> DataAvailabilityHeader:
    """DAH of a block with one tail-padding share.
    ref: pkg/da/data_availability_header.go:179"""
    return new_data_availability_header(
        extend_shares([tail_padding_share()], device))


def nil_dah_hash() -> bytes:
    return hashlib.sha256(b"").digest()
