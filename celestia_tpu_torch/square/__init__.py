"""Deterministic square construction (ADR-020).

Reference semantics: pkg/square/square.go + builder.go. `build` is the
proposer path (best-effort greedy packing of prioritized txs); `construct`
is the validator path (exact rebuild that must fit); `deconstruct` inverts
a square back into block txs.
"""

from __future__ import annotations

import dataclasses

from celestia_tpu_torch import appconsts, inclusion
from celestia_tpu_torch import blob as blob_pkg
from celestia_tpu_torch import namespace as ns_pkg
from celestia_tpu_torch.shares import (
    Share,
    reserved_padding_shares,
    tail_padding_shares,
)
from celestia_tpu_torch.shares.parse import parse_blobs, parse_txs
from celestia_tpu_torch.shares.splitters import (
    CompactShareCounter,
    CompactShareSplitter,
    Range,
    SparseShareSplitter,
    sparse_shares_needed,
)

Square = list[Share]


def square_size(share_count: int) -> int:
    """Side length of a square with share_count shares (rounded up to the
    next power-of-two side). ref: pkg/da/data_availability_header.go:205"""
    return inclusion.blob_min_square_size(share_count)


def empty_square() -> Square:
    """1x1 square holding one tail-padding share.
    ref: pkg/square/square.go EmptySquare"""
    return tail_padding_shares(1)


@dataclasses.dataclass(slots=True)
class Element:
    """One blob queued for layout. ref: pkg/square/builder.go:366-406"""

    blob: blob_pkg.Blob
    pfb_index: int
    blob_index: int
    num_shares: int
    max_padding: int

    @classmethod
    def new(cls, blob: blob_pkg.Blob, pfb_index: int, blob_index: int,
            subtree_root_threshold: int) -> "Element":
        num_shares = sparse_shares_needed(len(blob.data))
        return cls(
            blob=blob,
            pfb_index=pfb_index,
            blob_index=blob_index,
            num_shares=num_shares,
            # worst case: the previous blob ends one share into this blob's
            # subtree-width alignment window
            max_padding=inclusion.sub_tree_width(num_shares, subtree_root_threshold) - 1,
        )

    def max_share_offset(self) -> int:
        return self.num_shares + self.max_padding


def _worst_case_share_indexes(n_blobs: int, app_version: int) -> list[int]:
    max_square = appconsts.square_size_upper_bound(app_version)
    return [max_square * max_square] * n_blobs


class Builder:
    """Tracks worst-case share usage while appending txs/blob-txs, then
    lays out the square deterministically. ref: pkg/square/builder.go:18-423"""

    def __init__(self, max_square_size: int, app_version: int):
        if max_square_size <= 0:
            raise ValueError("max square size must be strictly positive")
        if max_square_size & (max_square_size - 1):
            raise ValueError("max square size must be a power of two")
        self.max_capacity = max_square_size * max_square_size
        self.subtree_root_threshold = appconsts.subtree_root_threshold(app_version)
        self.app_version = app_version
        self.txs: list[bytes] = []
        self.pfbs: list[blob_pkg.IndexWrapper] = []
        # layout rows, one per blob: (ns_key, pfb_index, blob_index,
        # num_shares, max_padding, blob). Plain tuples rather than
        # Element objects so export() can sort them with the default
        # tuple comparison — ns_key is the 29-byte namespace (version
        # byte ‖ 28-byte id), whose lexicographic order IS namespace
        # order, and the (pfb_index, blob_index) tie-break reproduces
        # the stable sort's insertion order (appends are sequential)
        self.blobs: list[tuple] = []
        self.tx_counter = CompactShareCounter()
        self.pfb_counter = CompactShareCounter()
        self.current_size = 0
        self.done = False
        self._square: Square | None = None

    @classmethod
    def from_txs(cls, max_square_size: int, app_version: int, txs: list[bytes]) -> "Builder":
        b = cls(max_square_size, app_version)
        seen_blob_tx = False
        for idx, tx in enumerate(txs):
            blob_tx, is_blob_tx = blob_pkg.unmarshal_blob_tx(tx)
            if is_blob_tx:
                seen_blob_tx = True
                if not b.append_blob_tx(blob_tx):
                    raise ValueError(f"not enough space to append blob tx at index {idx}")
            else:
                if seen_blob_tx:
                    raise ValueError(
                        f"normal tx at index {idx} can not be appended after blob tx"
                    )
                if not b.append_tx(tx):
                    raise ValueError(f"not enough space to append tx at index {idx}")
        return b

    def append_tx(self, tx: bytes) -> bool:
        diff = self.tx_counter.add(len(tx))
        if self._can_fit(diff):
            self.txs.append(tx)
            self.current_size += diff
            self.done = False
            return True
        self.tx_counter.revert()
        return False

    def append_blob_tx(self, blob_tx: blob_pkg.BlobTx) -> bool:
        # The inner tx must not already be index-wrapped: the builder adds
        # the (single) IndexWrapper layer itself, and a double-wrapped tx
        # would crash deconstruction and diverge from what any honest
        # proposer can produce. Treated as invalid input (build drops it,
        # construct rejects the whole square). The verdict is memoized on
        # the (LRU-shared) BlobTx — the same tx is appended again at
        # Process/Deliver re-builds of the block.
        # per-BlobTx append template, computed once and memoized on the
        # (LRU-shared) BlobTx object: worst-case IndexWrapper size, the
        # per-blob (num_shares, max_padding) pairs, and their total.
        # Everything in it is a pure function of (blob tx, app_version) —
        # the same tx is appended again at Process/Deliver re-builds.
        tpl_map = getattr(blob_tx, "_append_tpl", None)
        if tpl_map is None:
            tpl_map = blob_tx._append_tpl = {}
        tpl = tpl_map.get(self.app_version)
        if tpl is None:
            _iw, already_wrapped = blob_pkg.unmarshal_index_wrapper(blob_tx.tx)
            if already_wrapped:
                raise ValueError("blob tx inner is already index-wrapped")
            n_blobs = len(blob_tx.blobs)
            worst_indexes = _worst_case_share_indexes(
                n_blobs, self.app_version
            )
            size = blob_pkg.marshal_index_wrapper_size_from_len(
                len(blob_tx.tx), tuple(worst_indexes)
            )
            # Element.new is the single source of the sizing rules —
            # the template caches its (num_shares, max_padding) along
            # with the blob and its precomputed namespace sort key
            metas = tuple(
                (bytes((b.namespace_version,)) + b.namespace_id,
                 b, e.num_shares, e.max_padding)
                for b, e in (
                    (b, Element.new(b, 0, 0, self.subtree_root_threshold))
                    for b in blob_tx.blobs
                )
            )
            tpl = tpl_map[self.app_version] = (
                size, metas,
                sum(num + pad for _, _, num, pad in metas),
                blob_pkg._iw_tx_field(blob_tx.tx),
                worst_indexes,
            )
        size, metas, max_blob_share_count, txf, worst = tpl
        # _txf rides the constructor: pre-encoded field 1 for export's
        # re-marshal
        iw = blob_pkg.IndexWrapper(blob_tx.tx, list(worst), txf)
        pfb_share_diff = self.pfb_counter.add(size)

        pfb_index = len(self.pfbs)
        if len(metas) == 1:  # the common single-blob PFB
            nskey, b, num, pad = metas[0]
            elements = [(nskey, pfb_index, 0, num, pad, b)]
        else:
            elements = [
                (nskey, pfb_index, idx, num, pad, b)
                for idx, (nskey, b, num, pad) in enumerate(metas)
            ]

        if self._can_fit(pfb_share_diff + max_blob_share_count):
            self.blobs.extend(elements)
            self.pfbs.append(iw)
            self.current_size += pfb_share_diff + max_blob_share_count
            self.done = False
            return True
        self.pfb_counter.revert()
        return False

    def export(self) -> Square:
        if self.done and self._square is not None:
            return self._square
        if self.is_empty():
            self._square = empty_square()
            self.done = True
            return self._square

        ss = inclusion.blob_min_square_size(self.current_size)

        # tuple sort: ns_key leads, and the (pfb_index, blob_index)
        # tie-break equals insertion order — same result as a stable
        # sort by namespace, without a per-element key callback
        self.blobs.sort()

        tx_writer = CompactShareSplitter(ns_pkg.TX_NAMESPACE, appconsts.SHARE_VERSION_ZERO)
        tx_writer.write_txs_bulk(self.txs, track_ranges=False)

        non_reserved_start = self.tx_counter.size() + self.pfb_counter.size()
        cursor = non_reserved_start
        end_of_last_blob = non_reserved_start
        blob_writer = SparseShareSplitter()
        # local aliases + inlined next_share_index (sub_tree_width is
        # lru-cached; the rounding is two int ops): this loop runs once
        # per blob on the proposal hot path
        stw = inclusion.sub_tree_width
        threshold = self.subtree_root_threshold
        pfbs = self.pfbs
        for i, (_, pfb_index, blob_index, num_shares, max_padding, blob) in enumerate(
            self.blobs
        ):
            tree_width = stw(num_shares, threshold)
            rem = cursor % tree_width
            if rem:
                cursor += tree_width - rem
            if i == 0:
                non_reserved_start = cursor
            padding = cursor - end_of_last_blob
            if padding > max_padding:
                raise ValueError(
                    f"blob has {padding} padding shares, but {max_padding} was the max"
                )
            pfbs[pfb_index].share_indexes[blob_index] = cursor
            if padding and i > 0:
                blob_writer.write_namespace_padding_shares(padding)
            blob_writer.write(blob)
            cursor += num_shares
            end_of_last_blob = cursor

        pfb_writer = CompactShareSplitter(
            ns_pkg.PAY_FOR_BLOB_NAMESPACE, appconsts.SHARE_VERSION_ZERO
        )
        pfb_writer.write_txs_bulk(
            [
                (
                    blob_pkg.marshal_index_wrapper_with_head(
                        iw._txf, iw.share_indexes
                    )
                    if iw._txf is not None
                    else blob_pkg.marshal_index_wrapper(
                        iw.tx, iw.share_indexes
                    )
                )
                for iw in self.pfbs
            ],
            track_ranges=False,
        )

        if self.pfb_counter.size() < pfb_writer.count():
            raise ValueError(
                f"pfb counter {self.pfb_counter.size()} < writer {pfb_writer.count()}"
            )

        self._square = write_square(
            tx_writer, pfb_writer, blob_writer, non_reserved_start, ss
        )
        self.done = True
        return self._square

    def blob_layout(self) -> list[tuple[int, "blob_pkg.Blob"]]:
        """Per-blob placement after export: [(first_share_index, blob)].

        The provenance the device-side square assembly consumes
        (ops/extend.assembled_roots): every share in
        [start, start + sparse_shares_needed(len(blob.data))) is that
        blob's sparse share; everything else is host bytes."""
        if not self.done:
            self.export()
        return [
            (self.pfbs[pfb_index].share_indexes[blob_index], blob)
            for _, pfb_index, blob_index, _, _, blob in self.blobs
        ]

    def find_blob_starting_index(self, pfb_index: int, blob_index: int) -> int:
        """pfb_index counts from the start of the tx set. ref: builder.go:212"""
        if pfb_index < len(self.txs):
            raise ValueError(f"pfbIndex {pfb_index} does not match a pfb")
        pfb_index -= len(self.txs)
        if pfb_index >= len(self.pfbs):
            raise ValueError(f"pfbIndex {pfb_index} out of range")
        if not self.done:
            self.export()
        return self.pfbs[pfb_index].share_indexes[blob_index]

    def blob_share_length(self, pfb_index: int, blob_index: int) -> int:
        if pfb_index < len(self.txs):
            raise ValueError(f"pfbIndex {pfb_index} does not match a pfb")
        pfb_index -= len(self.txs)
        for _, p_idx, b_idx, num_shares, _, _ in self.blobs:
            if p_idx == pfb_index and b_idx == blob_index:
                return num_shares
        raise ValueError("blob not found")

    def find_tx_share_range(self, tx_index: int) -> Range:
        """Inclusive-start, exclusive-end share range of tx tx_index.
        ref: builder.go:267-316"""
        if not self.done:
            self.export()
        if tx_index < 0 or tx_index >= len(self.txs) + len(self.pfbs):
            raise ValueError(f"txIndex {tx_index} out of range")

        tx_counter = CompactShareCounter()
        pfb_counter = CompactShareCounter()
        for i in range(tx_index):
            if i < len(self.txs):
                tx_counter.add(len(self.txs[i]))
            else:
                iw = self.pfbs[i - len(self.txs)]
                pfb_counter.add(len(blob_pkg.marshal_index_wrapper(iw.tx, iw.share_indexes)))

        start = tx_counter.size() + pfb_counter.size() - 1
        if tx_index < len(self.txs):
            if tx_counter.remainder == 0:
                start += 1
            tx_counter.add(len(self.txs[tx_index]))
        else:
            if pfb_counter.remainder == 0:
                start += 1
            iw = self.pfbs[tx_index - len(self.txs)]
            pfb_counter.add(len(blob_pkg.marshal_index_wrapper(iw.tx, iw.share_indexes)))
        end = tx_counter.size() + pfb_counter.size()
        return Range(start, end)

    def num_txs(self) -> int:
        return len(self.txs) + len(self.pfbs)

    def _can_fit(self, n: int) -> bool:
        return self.current_size + n <= self.max_capacity

    def is_empty(self) -> bool:
        return self.tx_counter.size() == 0 and self.pfb_counter.size() == 0


def write_square(
    tx_writer: CompactShareSplitter,
    pfb_writer: CompactShareSplitter,
    blob_writer: SparseShareSplitter,
    non_reserved_start: int,
    square_size_: int,
) -> Square:
    """Assemble tx ‖ pfb ‖ reserved-padding ‖ blobs ‖ tail-padding.
    ref: pkg/square/square.go:237-276"""
    total = square_size_ * square_size_
    pfb_start = tx_writer.count()
    padding_start = pfb_start + pfb_writer.count()
    if non_reserved_start < padding_start:
        raise ValueError(
            f"nonReservedStart {non_reserved_start} is too small to fit all PFBs and txs"
        )
    padding = reserved_padding_shares(non_reserved_start - padding_start)
    end_of_last_blob = non_reserved_start + blob_writer.count()
    if total < end_of_last_blob:
        raise ValueError(f"square size {total} is too small to fit all blobs")

    square: Square = tx_writer.export() + pfb_writer.export()
    if blob_writer.count() > 0:
        square += padding + blob_writer.export()
    square += tail_padding_shares(total - len(square))
    return square


def build_ex(
    txs: list[bytes], app_version: int, max_square_size: int
) -> tuple[Square, list[bytes], Builder]:
    """build() that also returns the Builder (blob-placement provenance
    for the device-side square assembly)."""
    builder = Builder(max_square_size, app_version)
    normal_txs: list[bytes] = []
    blob_txs: list[bytes] = []
    for tx in txs:
        blob_tx, is_blob_tx = blob_pkg.unmarshal_blob_tx(tx)
        if is_blob_tx:
            try:
                appended = builder.append_blob_tx(blob_tx)
            except ValueError:
                continue  # invalid blob tx (e.g. double-wrapped inner): drop
            if appended:
                blob_txs.append(tx)
        else:
            if builder.append_tx(tx):
                normal_txs.append(tx)
    return builder.export(), normal_txs + blob_txs, builder


def build(txs: list[bytes], app_version: int, max_square_size: int) -> tuple[Square, list[bytes]]:
    """Proposer: greedy best-effort packing. ref: pkg/square/square.go:22"""
    square, kept, _builder = build_ex(txs, app_version, max_square_size)
    return square, kept


def construct_ex(
    txs: list[bytes], app_version: int, max_square_size: int
) -> tuple[Square, Builder]:
    """construct() that also returns the Builder (provenance)."""
    b = Builder.from_txs(max_square_size, app_version, txs)
    return b.export(), b


def construct(txs: list[bytes], app_version: int, max_square_size: int) -> Square:
    """Validator: exact rebuild, must fit. ref: pkg/square/square.go:51"""
    return Builder.from_txs(max_square_size, app_version, txs).export()


def get_share_range_for_namespace(square: list[Share], ns: ns_pkg.Namespace) -> Range:
    """ref: pkg/shares/namespace.go:13"""
    if not square:
        return Range(0, 0)
    if ns < square[0].namespace() or ns > square[-1].namespace():
        return Range(0, 0)
    start = -1
    for i, share in enumerate(square):
        share_ns = share.namespace()
        if share_ns > ns and start != -1:
            return Range(start, i)
        if share_ns == ns and start == -1:
            start = i
    if start == -1:
        return Range(0, 0)
    return Range(start, len(square))


def deconstruct(square: Square, pfb_blob_sizes) -> list[bytes]:
    """Invert a square into the ordered block txs.

    pfb_blob_sizes: callable(tx_bytes) -> list[int] extracting the
    MsgPayForBlobs blob sizes from a decoded sdk tx (supplied by the state
    machine layer to keep this package self-contained).
    ref: pkg/square/square.go:65
    """
    if square == empty_square():
        return []

    tx_range = get_share_range_for_namespace(square, ns_pkg.TX_NAMESPACE)
    if tx_range.start != 0:
        raise ValueError(f"expected txs to start at index 0, got {tx_range.start}")

    rest = square[tx_range.end :]
    wpfb_range = get_share_range_for_namespace(rest, ns_pkg.PAY_FOR_BLOB_NAMESPACE)
    txs = parse_txs(square[tx_range.start : tx_range.end])
    if wpfb_range.start == wpfb_range.end:
        return txs
    if wpfb_range.start != 0:
        raise ValueError("expected PFBs to start directly after non-PFB txs")

    wpfbs = parse_txs(rest[wpfb_range.start : wpfb_range.end])
    for i, wpfb_bytes in enumerate(wpfbs):
        wpfb, is_wpfb = blob_pkg.unmarshal_index_wrapper(wpfb_bytes)
        if not is_wpfb:
            raise ValueError(f"expected wrapped PFB at index {i}")
        if not wpfb.share_indexes:
            raise ValueError(f"wrapped PFB {i} has no blobs attached")
        blob_sizes = pfb_blob_sizes(wpfb.tx)
        if len(blob_sizes) != len(wpfb.share_indexes):
            raise ValueError(
                f"expected PFB to have {len(wpfb.share_indexes)} blob sizes, "
                f"got {len(blob_sizes)}"
            )
        blobs = []
        for j, share_index in enumerate(wpfb.share_indexes):
            end = share_index + sparse_shares_needed(blob_sizes[j])
            parsed = parse_blobs(square[share_index:end])
            if len(parsed) != 1:
                raise ValueError(f"expected to parse a single blob, got {len(parsed)}")
            blobs.append(parsed[0])
        txs.append(blob_pkg.marshal_blob_tx(wpfb.tx, blobs))
    return txs


def tx_share_range(txs: list[bytes], tx_index: int, app_version: int) -> Range:
    """ref: pkg/square/square.go:159"""
    builder = Builder.from_txs(
        appconsts.square_size_upper_bound(app_version), app_version, txs
    )
    return builder.find_tx_share_range(tx_index)


def blob_share_range(
    txs: list[bytes], tx_index: int, blob_index: int, app_version: int
) -> Range:
    """ref: pkg/square/square.go:171"""
    builder = Builder.from_txs(
        appconsts.square_size_upper_bound(app_version), app_version, txs
    )
    start = builder.find_blob_starting_index(tx_index, blob_index)
    length = builder.blob_share_length(tx_index, blob_index)
    return Range(start, start + length)
