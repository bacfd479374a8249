"""Extended data square + DataAvailabilityHeader (port of celestia_tpu/da).

Reference semantics: pkg/da/data_availability_header.go and the rsmt2d
extension layout (Q1 = row-extend Q0, Q2 = col-extend Q0, Q3 = row-extend
Q2), with NMT row/column roots per pkg/wrapper/nmt_wrapper.go: Q0 cells keep
their own namespace, all parity cells use the parity namespace.

The square lives on the device: ``extend_shares`` runs the main path
(ops/extend.py) and wraps the resulting EDS tensor; its bytes reach the host
only on the first ``.data`` read, and a row, column or cell read before that
moves only the slice (ops/transfers). The DAH hash over the 4k axis roots is
computed on the host (ops/nmt_host.merkle_root). ``extend_host`` is the
host oracle of the extension (numpy, Leopard's encode).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading

import numpy as np
import torch

from celestia_tpu_torch import namespace as ns
from celestia_tpu_torch.appconsts import (
    DEFAULT_SQUARE_SIZE_UPPER_BOUND,
    MIN_SQUARE_SIZE,
    NAMESPACE_SIZE,
    SHARE_SIZE,
)
from celestia_tpu_torch.ops import extend, gf256, transfers
from celestia_tpu_torch.ops.nmt_host import merkle_root

PARITY_NS = ns.PARITY_SHARES_NAMESPACE.bytes
MAX_EXTENDED_SQUARE_WIDTH = DEFAULT_SQUARE_SIZE_UPPER_BOUND * 2
MIN_EXTENDED_SQUARE_WIDTH = MIN_SQUARE_SIZE * 2


class ExtendedDataSquare:
    """2k×2k erasure-extended share matrix, uint8 (2k, 2k, 512).

    Backed by a torch tensor (``device_data``) or by host bytes; the host
    copy of a device square is fetched on the first ``.data`` read. The axis
    roots are those the extension computed with the square, or, for a square
    given as bytes, ``extend.eds_roots_device`` over it.

    While device-resident, ``row(i)``, ``col(j)``, ``rows_batch`` and
    ``share(r, c)`` are sliced reads (ops/transfers): the device cuts the
    row, column or cell and only that crosses to the host, so a sample
    costs one row, not the square. Whole-square reads (``.data``,
    ``flattened_shares``) do the one bulk fetch, after which every accessor
    serves from host memory."""

    # sliced rows and columns kept per instance (FIFO), so a burst of samples
    # on one axis is served from host memory
    _SLICE_CACHE_AXES = 8

    def __init__(self, squares: np.ndarray | None, original_width: int,
                 device=None, roots: tuple[np.ndarray, np.ndarray] | None = None):
        """``device``: where the roots of host bytes are computed (None
        means CUDA, as for every entry of the port); ``roots``: the
        (row_roots, col_roots) when the caller already has them."""
        self._data = squares
        self._device: torch.Tensor | None = None
        self._roots = roots
        self._compute_device = device
        self._slice_cache: dict[tuple[str, int], list[bytes]] = {}
        # concurrent readers share an instance: insert and evict under a lock
        self._slice_lock = threading.Lock()
        self.original_width = original_width

    @classmethod
    def from_device(cls, device_buffer: torch.Tensor, original_width: int,
                    roots: tuple[np.ndarray, np.ndarray] | None = None,
                    ) -> "ExtendedDataSquare":
        """Wrap a (2k, 2k, 512) tensor without fetching it; ``roots`` are
        its (row_roots, col_roots) when the caller already has them."""
        eds = cls(None, original_width, device_buffer.device, roots)
        eds._device = device_buffer
        return eds

    @property
    def data(self) -> np.ndarray:
        if self._data is None:
            self._data = self._device.cpu().numpy()  # one lazy fetch
        return self._data

    @data.setter
    def data(self, value: np.ndarray) -> None:
        self._data = value
        # the device copy, the roots and the slices no longer match the bytes
        self._device = None
        self._roots = None
        with self._slice_lock:
            self._slice_cache.clear()

    @property
    def device_data(self) -> torch.Tensor | None:
        """The device tensor when this EDS is device-resident (else None)."""
        return self._device

    @property
    def width(self) -> int:
        return 2 * self.original_width

    def _resident(self) -> bool:
        return self._data is None and self._device is not None

    def _cache_put(self, key: tuple[str, int], cells: list[bytes]) -> None:
        """Insert under the lock, evicting the oldest entry when full."""
        with self._slice_lock:
            if len(self._slice_cache) >= self._SLICE_CACHE_AXES:
                self._slice_cache.pop(next(iter(self._slice_cache)))
            self._slice_cache[key] = cells

    def _sliced_axis(self, kind: str, idx: int) -> list[bytes]:
        """One row or column of a device-resident square without fetching
        the square: w·512 bytes cross. The transfer runs unlocked; two
        racers may fetch the same slice once each."""
        key = (kind, idx)
        with self._slice_lock:
            cached = self._slice_cache.get(key)
        if cached is not None:
            return cached
        fetch = transfers.eds_row if kind == "row" else transfers.eds_col
        arr = fetch(self._device, idx)
        cells = [arr[t].tobytes() for t in range(self.width)]
        self._cache_put(key, cells)
        return cells

    def row(self, i: int) -> list[bytes]:
        if self._resident():
            return self._sliced_axis("row", i)
        return [self.data[i, j].tobytes() for j in range(self.width)]

    def col(self, j: int) -> list[bytes]:
        if self._resident():
            return self._sliced_axis("col", j)
        return [self.data[i, j].tobytes() for i in range(self.width)]

    def rows_batch(self, indices: list[int]) -> list[list[bytes]]:
        """Several rows, in ``indices`` order. A device-resident square
        fetches the distinct rows not cached as one gather
        (``transfers.eds_rows_batch``); byte-identical to ``row()``."""
        if not self._resident():
            return [self.row(i) for i in indices]
        out: dict[int, list[bytes]] = {}
        misses: list[int] = []
        with self._slice_lock:
            for i in sorted(set(indices)):
                hit = self._slice_cache.get(("row", i))
                if hit is not None:
                    out[i] = hit
                else:
                    misses.append(i)
        if misses:
            batch = transfers.eds_rows_batch(self._device, misses)
            for t, i in enumerate(misses):
                out[i] = [batch[t, c].tobytes() for c in range(self.width)]
                self._cache_put(("row", i), out[i])
        return [out[i] for i in indices]

    def share(self, r: int, c: int) -> bytes:
        """One cell: a device-resident square moves 512 bytes (or serves it
        from a cached row or column), never the whole square."""
        if self._resident():
            with self._slice_lock:
                row_hit = self._slice_cache.get(("row", r))
                col_hit = self._slice_cache.get(("col", c))
            if row_hit is not None:
                return row_hit[c]
            if col_hit is not None:
                return col_hit[r]
            return transfers.eds_share(self._device, r, c).tobytes()
        return self.data[r, c].tobytes()

    def flattened_shares(self) -> list[bytes]:
        """Every cell, row-major: one bulk fetch of the square."""
        data = self.data
        return [data[i, j].tobytes() for i in range(self.width) for j in range(self.width)]

    def _axis_roots(self) -> tuple[np.ndarray, np.ndarray]:
        if self._roots is None:
            source = self._device if self._device is not None else self._data
            self._roots = extend.eds_roots_device(source, self._compute_device)
        return self._roots

    def row_roots(self) -> list[bytes]:
        return [r.tobytes() for r in self._axis_roots()[0]]

    def col_roots(self) -> list[bytes]:
        return [c.tobytes() for c in self._axis_roots()[1]]


def erasured_leaf_namespace(
    axis_index: int, share_index: int, cell: bytes, k: int
) -> bytes:
    """The wrapper's quadrant rule for ONE leaf
    (pkg/wrapper/nmt_wrapper.go:93-114): the share's own namespace in
    Q0, the parity namespace otherwise."""
    if axis_index < k and share_index < k:
        return cell[:NAMESPACE_SIZE]
    return PARITY_NS


def erasured_axis_leaves(
    cells: list[bytes], axis_index: int, k: int
) -> list[bytes]:
    """Namespaced NMT leaves of one row/column: leaf = ns ‖ share with ns
    per erasured_leaf_namespace."""
    return [
        erasured_leaf_namespace(axis_index, share_index, cell, k) + cell
        for share_index, cell in enumerate(cells)
    ]


def extend_host(q0: np.ndarray) -> np.ndarray:
    """(k, k, 512) uint8 -> the (2k, 2k, 512) EDS on the host, through
    ``gf256.leopard_encode`` (the CPU oracle of the extension): Q2 extends
    Q0's columns, Q1 its rows, Q3 Q2's rows."""
    q0 = np.asarray(q0, dtype=np.uint8)
    k, _, s = q0.shape

    def col_extend(q):
        return gf256.leopard_encode(q.reshape(k, k * s)).reshape(k, k, s)

    def row_extend(q):
        return col_extend(np.ascontiguousarray(q.transpose(1, 0, 2))).transpose(1, 0, 2)

    q2 = col_extend(q0)
    return np.concatenate([np.concatenate([q0, row_extend(q0)], axis=1),
                           np.concatenate([q2, row_extend(q2)], axis=1)], axis=0)


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
