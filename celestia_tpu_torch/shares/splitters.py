"""Compact & sparse share splitters, worst-case counter, and top-level
splitting helpers.

Reference semantics: pkg/shares/split_compact_shares.go (length-delimited
units, reserved-byte pointers, retroactive sequence length),
split_sparse_shares.go (blob sequences), counter.go (worst-case counting
with revert), share_splitting.go (SplitTxs / SplitBlobs).
"""

from __future__ import annotations

import dataclasses
import functools

from celestia_tpu_torch import appconsts
from celestia_tpu_torch import blob as blob_pkg
from celestia_tpu_torch import namespace as ns_pkg
from celestia_tpu_torch.namespace import Namespace

from . import (
    Builder,
    Share,
    namespace_padding_shares,
)


from celestia_tpu_torch.blob import read_uvarint, uvarint  # noqa: E402


def delim_len(n: int) -> int:
    """Length of the uvarint encoding of n. ref: pkg/shares/delimiter.go"""
    return len(uvarint(n))


def marshal_delimited_tx(tx: bytes) -> bytes:
    """uvarint(len) ‖ tx. ref: split_compact_shares.go MarshalDelimitedTx"""
    return uvarint(len(tx)) + tx


def parse_delimiter(data: bytes) -> tuple[bytes, int]:
    """Strip the unit-length delimiter: returns (rest, unit_len)."""
    if len(data) == 0:
        return data, 0
    length, pos = read_uvarint(data, 0)
    return data[pos:], length


@dataclasses.dataclass(frozen=True)
class Range:
    start: int
    end: int


class CompactShareSplitter:
    """Writes length-delimited units compactly across shares.
    ref: pkg/shares/split_compact_shares.go:31-226"""

    def __init__(self, namespace: Namespace, share_version: int):
        self.shares: list[Share] = []
        self.namespace = namespace
        self.share_version = share_version
        self.builder = Builder(namespace, share_version, True)
        self.done = False
        self.share_ranges: dict[bytes, Range] = {}

    def write_tx(self, tx: bytes) -> None:
        raw = marshal_delimited_tx(tx)
        start = len(self.shares)
        self._write(raw)
        self.share_ranges[tx_key(tx)] = Range(start, self.count())

    def write_txs_bulk(self, txs: list[bytes], track_ranges: bool = True) -> None:
        """Write ALL txs and finalize in one vectorized pass.

        Byte-identical to sequential write_tx() calls followed by
        export() (pinned by tests): the whole delimited unit stream is
        laid into a (n_shares, 512) numpy buffer with strided writes —
        namespace/info columns broadcast, content region reshaped from
        the stream, reserved-byte pointers computed for every share at
        once from the unit-start offsets. Requires a fresh splitter;
        leaves it in exported state. This is the builder's hot path
        (ref: pkg/square/builder.go:146-199 lays out the square per
        block; the per-share Python loop was the round-3 bottleneck,
        bench config 9)."""
        if self.shares or not self.builder.is_empty_share() or self.done:
            raise ValueError("write_txs_bulk requires a fresh splitter")
        if not txs:
            return
        import numpy as np

        first = appconsts.FIRST_COMPACT_SHARE_CONTENT_SIZE
        cont = appconsts.CONTINUATION_COMPACT_SHARE_CONTENT_SIZE
        share_size = appconsts.SHARE_SIZE
        # interleave delimiter/payload and join once: one big concat
        # instead of a fresh bytes object per tx
        parts = [b""] * (2 * len(txs))
        unit_lens = np.empty(len(txs), np.int64)
        for i, t in enumerate(txs):
            u = uvarint(len(t))
            parts[2 * i] = u
            parts[2 * i + 1] = t
            unit_lens[i] = len(u) + len(t)
        stream = b"".join(parts)
        total = len(stream)
        n = 1 if total <= first else 1 + (total - first + cont - 1) // cont

        buf = np.zeros((n, share_size), np.uint8)
        buf[:, : appconsts.NAMESPACE_SIZE] = np.frombuffer(
            self.namespace.bytes, np.uint8
        )
        info_col = appconsts.NAMESPACE_SIZE  # 29
        buf[0, info_col] = (self.share_version << 1) | 1
        if n > 1:
            buf[1:, info_col] = self.share_version << 1
        # sequence length (== total stream bytes) at 30..34 of share 0
        buf[0, 30:34] = np.frombuffer(total.to_bytes(4, "big"), np.uint8)

        # content regions: share 0 at byte 38 (ns+info+seqlen+reserved),
        # continuations at byte 34 (ns+info+reserved)
        sarr = np.frombuffer(stream, np.uint8)
        head = sarr[:first]
        buf[0, 38 : 38 + len(head)] = head
        if n > 1:
            rest = sarr[first:]
            padded = np.zeros((n - 1) * cont, np.uint8)
            padded[: len(rest)] = rest
            buf[1:, 34:] = padded.reshape(n - 1, cont)

        # reserved-byte pointers: in-share offset of the first unit that
        # STARTS in each share (0 when none does)
        starts = np.concatenate([[0], np.cumsum(unit_lens)[:-1]])
        share_of = np.where(starts < first, 0, 1 + (starts - first) // cont)
        in_share = np.where(starts < first, 38 + starts, 34 + (starts - first) % cont)
        ptr = np.zeros(n, np.int64)
        # share_of is non-decreasing (starts ascend), so first
        # occurrences are where the value changes — no sort via unique
        first_idx = np.concatenate([[0], np.nonzero(np.diff(share_of))[0] + 1])
        ptr[share_of[first_idx]] = in_share[first_idx]
        buf[0, 34:38] = np.frombuffer(int(ptr[0]).to_bytes(4, "big"), np.uint8)
        if n > 1:
            buf[1:, 32] = ptr[1:] >> 8
            buf[1:, 33] = ptr[1:] & 0xFF

        if track_ranges:
            # per-tx share ranges (same Range semantics as write_tx);
            # the square builder passes False — nothing on that path
            # reads them, and tx_key is a sha256 per tx
            last_byte = starts + unit_lens - 1
            end_share = np.where(
                last_byte < first, 0, 1 + (last_byte - first) // cont
            )
            for i, tx in enumerate(txs):
                self.share_ranges[tx_key(tx)] = Range(
                    int(share_of[i]), int(end_share[i]) + 1
                )

        raw = buf.tobytes()
        self.shares = [
            Share(raw[i * share_size : (i + 1) * share_size]) for i in range(n)
        ]
        self.done = True

    def _write(self, raw: bytes) -> None:
        if self.done:
            # writing after Export: re-open the last (padded) share
            if not self.builder.is_empty_share():
                self.shares.pop()
            self.done = False

        self.builder.maybe_write_reserved_bytes()
        while True:
            leftover = self.builder.add_data(raw)
            if leftover is None:
                break
            self._stack_pending()
            raw = leftover
        if self.builder.available_bytes() == 0:
            self._stack_pending()

    def _stack_pending(self) -> None:
        self.shares.append(self.builder.build())
        self.builder = Builder(self.namespace, self.share_version, False)

    def export(self) -> list[Share]:
        if self._is_empty():
            return []
        if self.done:
            return self.shares

        bytes_of_padding = 0
        if not self.builder.is_empty_share():
            bytes_of_padding = self.builder.zero_pad_if_necessary()
            self._stack_pending()

        self._write_sequence_len(self._sequence_len(bytes_of_padding))
        self.done = True
        return self.shares

    def share_ranges_with_offset(self, offset: int) -> dict[bytes, Range]:
        return {
            k: Range(v.start + offset, v.end + offset)
            for k, v in self.share_ranges.items()
        }

    def _write_sequence_len(self, sequence_len: int) -> None:
        if self._is_empty():
            return
        b = Builder(self.namespace, self.share_version, True)
        b.import_raw_share(self.shares[0].to_bytes())
        b.write_sequence_len(sequence_len)
        self.shares[0] = b.build()

    def _sequence_len(self, bytes_of_padding: int) -> int:
        if not self.shares:
            return 0
        if len(self.shares) == 1:
            return appconsts.FIRST_COMPACT_SHARE_CONTENT_SIZE - bytes_of_padding
        continuation = (len(self.shares) - 1) * (
            appconsts.CONTINUATION_COMPACT_SHARE_CONTENT_SIZE
        )
        return (
            appconsts.FIRST_COMPACT_SHARE_CONTENT_SIZE
            + continuation
            - bytes_of_padding
        )

    def _is_empty(self) -> bool:
        return not self.shares and self.builder.is_empty_share()

    def count(self) -> int:
        if not self.builder.is_empty_share() and not self.done:
            return len(self.shares) + 1
        return len(self.shares)


class SparseShareSplitter:
    """Splits blobs into sparse share sequences.
    ref: pkg/shares/split_sparse_shares.go:19-110"""

    def __init__(self):
        self.shares: list[Share] = []

    def write(self, blob: blob_pkg.Blob) -> None:
        # A blob's own sparse shares are position-independent bytes, and
        # parsed Blob objects are shared across the Prepare/Process/
        # Deliver re-builds of one block (blob.py's unmarshal LRU) — so
        # the split is computed once per blob and replayed from the
        # object. The cache holds Share objects whose bytes are frozen;
        # list.extend of the cached list is the whole warm path.
        cached = getattr(blob, "_sparse_shares", None)
        if cached is not None:
            self.shares.extend(cached)
            return
        mark = len(self.shares)
        self._write_uncached(blob)
        try:
            blob._sparse_shares = tuple(self.shares[mark:])
        except AttributeError:  # slotted/frozen Blob variants: skip memo
            pass

    def _write_uncached(self, blob: blob_pkg.Blob) -> None:
        # inlined Blob.validate() with the namespace constructed ONCE
        # (new_namespace validates version/id; validate() would build it
        # a second time just to throw it away)
        if len(blob.namespace_id) != ns_pkg.NAMESPACE_ID_SIZE:
            raise ValueError(f"namespace id must be {ns_pkg.NAMESPACE_ID_SIZE} bytes")
        if not blob.data:
            raise ValueError("blob data can not be empty")
        if blob.share_version not in blob_pkg.SUPPORTED_SHARE_VERSIONS:
            raise ValueError(f"unsupported share version: {blob.share_version}")
        namespace = ns_pkg.new_namespace(blob.namespace_version, blob.namespace_id)
        if namespace.is_tx() or namespace.is_pay_for_blob():
            # compact-namespace blobs (never valid in a real square, but
            # the splitter must stay byte-compatible with the share
            # Builder, which inserts reserved bytes for these namespaces)
            raw: bytes | None = blob.data
            b = Builder(namespace, blob.share_version, True)
            b.write_sequence_len(len(blob.data))
            while raw is not None:
                leftover = b.add_data(raw)
                if leftover is None:
                    b.zero_pad_if_necessary()
                self.shares.append(b.build())
                b = Builder(namespace, blob.share_version, False)
                raw = leftover
            return

        # Direct assembly (byte-identical to the share Builder, pinned by
        # tests/test_shares fuzz round-trips): sparse layout is
        #   ns ‖ info(start=1) ‖ seq_len(4) ‖ data[:F]   (first share)
        #   ns ‖ info(start=0) ‖ data chunk of C         (continuations)
        # with only the final share zero-padded.
        data = blob.data
        ns_bytes = namespace.bytes
        first = appconsts.FIRST_SPARSE_SHARE_CONTENT_SIZE
        cont = appconsts.CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
        prefix = (
            ns_bytes
            + bytes([(blob.share_version << 1) | 1])
            + len(data).to_bytes(appconsts.SEQUENCE_LEN_BYTES, "big")
        )
        chunk = data[:first]
        self.shares.append(
            Share(prefix + chunk + bytes(first - len(chunk)))
        )
        cont_prefix = ns_bytes + bytes([blob.share_version << 1])
        for pos in range(first, len(data), cont):
            chunk = data[pos : pos + cont]
            self.shares.append(
                Share(cont_prefix + chunk + bytes(cont - len(chunk)))
            )

    def write_namespace_padding_shares(self, count: int) -> None:
        if count < 0:
            raise ValueError("cannot write negative namespaced shares")
        if count == 0:
            return
        if not self.shares:
            raise ValueError(
                "cannot write namespace padding shares on an empty splitter"
            )
        last = self.shares[-1]
        self.shares.extend(
            namespace_padding_shares(last.namespace(), last.version(), count)
        )

    def export(self) -> list[Share]:
        return self.shares

    def count(self) -> int:
        return len(self.shares)


@functools.lru_cache(maxsize=1 << 15)
def _counter_step(
    shares: int, remainder: int, data_len: int
) -> tuple[int, int, int]:
    """(new_shares, new_remainder, diff) — the pure transition behind
    CompactShareCounter.add, memoized because block building repeats the
    same (state, unit length) pairs across Prepare/Process/Deliver."""
    last_remainder = remainder
    last_shares = shares
    data_len += delim_len(data_len)

    if shares == 0:
        first_left = appconsts.FIRST_COMPACT_SHARE_CONTENT_SIZE - remainder
        if data_len >= first_left:
            data_len -= first_left
            shares += 1
            remainder = 0
        else:
            remainder += data_len
            data_len = 0

    cont = appconsts.CONTINUATION_COMPACT_SHARE_CONTENT_SIZE
    if data_len >= cont - remainder:
        data_len -= cont - remainder
        shares += 1
        remainder = 0
    else:
        remainder += data_len
        data_len = 0

    if data_len > 0:
        shares += data_len // cont
        remainder = data_len % cont

    diff = shares - last_shares
    if last_remainder == 0 and remainder > 0:
        diff += 1
    elif last_remainder > 0 and remainder == 0:
        diff -= 1
    return shares, remainder, diff


class CompactShareCounter:
    """Worst-case compact share counter with single-step revert.
    ref: pkg/shares/counter.go:17-87"""

    def __init__(self):
        self.last_shares = 0
        self.last_remainder = 0
        self.shares = 0
        self.remainder = 0

    def add(self, data_len: int) -> int:
        self.last_remainder = self.remainder
        self.last_shares = self.shares
        self.shares, self.remainder, diff = _counter_step(
            self.shares, self.remainder, data_len
        )
        return diff

    def revert(self) -> None:
        self.shares = self.last_shares
        self.remainder = self.last_remainder

    def size(self) -> int:
        return self.shares if self.remainder == 0 else self.shares + 1


def tx_key(tx: bytes) -> bytes:
    """Tx identity = sha256 of the raw bytes (tendermint TxKey)."""
    import hashlib

    return hashlib.sha256(tx).digest()


def extract_share_indexes(txs: list[bytes]) -> list[int] | None:
    """Collect the share indexes of wrapped PFB txs.
    ref: pkg/shares/share_splitting.go ExtractShareIndexes"""
    indexes: list[int] = []
    for raw in txs:
        wrapper, is_wrapped = blob_pkg.unmarshal_index_wrapper(raw)
        if is_wrapped:
            if not wrapper.share_indexes:
                return None
            indexes.extend(wrapper.share_indexes)
    return indexes


def split_txs(
    txs: list[bytes],
) -> tuple[list[Share], list[Share], dict[bytes, Range]]:
    """Split txs into (tx shares, pfb shares, share ranges).
    ref: pkg/shares/share_splitting.go:46"""
    tx_writer = CompactShareSplitter(
        ns_pkg.TX_NAMESPACE, appconsts.SHARE_VERSION_ZERO
    )
    pfb_writer = CompactShareSplitter(
        ns_pkg.PAY_FOR_BLOB_NAMESPACE, appconsts.SHARE_VERSION_ZERO
    )
    for tx in txs:
        _, is_wrapper = blob_pkg.unmarshal_index_wrapper(tx)
        (pfb_writer if is_wrapper else tx_writer).write_tx(tx)

    tx_shares = tx_writer.export()
    pfb_shares = pfb_writer.export()
    ranges = tx_writer.share_ranges_with_offset(0)
    ranges.update(pfb_writer.share_ranges_with_offset(len(tx_shares)))
    return tx_shares, pfb_shares, ranges


def split_blobs(blobs: list[blob_pkg.Blob]) -> list[Share]:
    """ref: pkg/shares/share_splitting.go:77"""
    writer = SparseShareSplitter()
    for b in blobs:
        writer.write(b)
    return writer.export()


def compact_shares_needed(sequence_len: int) -> int:
    """ref: pkg/shares/share_sequence.go:103-121"""
    if sequence_len == 0:
        return 0
    if sequence_len < appconsts.FIRST_COMPACT_SHARE_CONTENT_SIZE:
        return 1
    needed = 1
    seq = sequence_len - appconsts.FIRST_COMPACT_SHARE_CONTENT_SIZE
    while seq > 0:
        seq -= appconsts.CONTINUATION_COMPACT_SHARE_CONTENT_SIZE
        needed += 1
    return needed


def sparse_shares_needed(sequence_len: int) -> int:
    """ref: pkg/shares/share_sequence.go:124-141 (closed form of the
    reference's subtraction loop)"""
    if sequence_len == 0:
        return 0
    first = appconsts.FIRST_SPARSE_SHARE_CONTENT_SIZE
    if sequence_len < first:
        return 1
    cont = appconsts.CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
    return 1 + (sequence_len - first + cont - 1) // cont
