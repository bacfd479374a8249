"""Blob share commitments + non-interactive default layout rules (ADR-013).

Reference semantics: pkg/inclusion/blob_share_commitment_rules.go,
pkg/inclusion/commitment.go. The commitment is the merkle root of a
mountain range of NMT subtree roots over the blob's shares; the layout
rules (SubTreeWidth / NextShareIndex) guarantee those subtree roots are
also inner nodes of the data square's row NMTs, so commitments can be
verified against the DAH.
"""

from __future__ import annotations

import functools
import math

from celestia_tpu_torch import appconsts
from celestia_tpu_torch import blob as blob_pkg
from celestia_tpu_torch.ops.nmt_host import merkle_root, nmt_root
from celestia_tpu_torch.shares import round_down_power_of_two, round_up_power_of_two
from celestia_tpu_torch.shares.splitters import split_blobs


def blob_min_square_size(share_count: int) -> int:
    """Minimum square size that fits share_count shares.
    ref: blob_share_commitment_rules.go:76"""
    return round_up_power_of_two(math.isqrt(max(share_count - 1, 0)) + 1 if share_count > 0 else 1)


@functools.lru_cache(maxsize=4096)
def sub_tree_width(share_count: int, subtree_root_threshold: int) -> int:
    """Max leaves per commitment subtree. ref: blob_share_commitment_rules.go:84
    Pure in both arguments; cached — the builder calls it per blob."""
    s = share_count // subtree_root_threshold
    if share_count % subtree_root_threshold != 0:
        s += 1
    s = round_up_power_of_two(s)
    return min(s, blob_min_square_size(share_count))


def next_share_index(cursor: int, blob_share_len: int, subtree_root_threshold: int) -> int:
    """Round cursor up to the blob's subtree-width alignment.
    ref: blob_share_commitment_rules.go:57"""
    tree_width = sub_tree_width(blob_share_len, subtree_root_threshold)
    return _round_up_multiple(cursor, tree_width)


def _round_up_multiple(cursor: int, v: int) -> int:
    if cursor % v == 0:
        return cursor
    return (cursor // v + 1) * v


def blob_shares_used_non_interactive_defaults(
    cursor: int, subtree_root_threshold: int, *blob_share_lens: int
) -> tuple[int, list[int]]:
    """(shares used incl. padding, start indexes per blob).
    ref: blob_share_commitment_rules.go:36"""
    start = cursor
    indexes = []
    for blob_len in blob_share_lens:
        cursor = next_share_index(cursor, blob_len, subtree_root_threshold)
        indexes.append(cursor)
        cursor += blob_len
    return cursor - start, indexes


def fits_in_square(
    cursor: int, square_size: int, subtree_root_threshold: int, *blob_share_lens: int
) -> tuple[bool, int]:
    """ref: blob_share_commitment_rules.go:16"""
    if not blob_share_lens:
        return cursor <= square_size * square_size, 0
    first_blob_len = blob_share_lens[0] if blob_share_lens else 1
    cursor = next_share_index(cursor, first_blob_len, subtree_root_threshold)
    shares_used, _ = blob_shares_used_non_interactive_defaults(
        cursor, subtree_root_threshold, *blob_share_lens
    )
    return cursor + shares_used <= square_size * square_size, shares_used


def merkle_mountain_range_sizes(total_size: int, max_tree_size: int) -> list[int]:
    """Leaf counts of the MMR trees. ref: commitment.go:95"""
    tree_sizes: list[int] = []
    while total_size != 0:
        if total_size >= max_tree_size:
            tree_sizes.append(max_tree_size)
            total_size -= max_tree_size
        else:
            size = round_down_power_of_two(total_size)
            tree_sizes.append(size)
            total_size -= size
    return tree_sizes


def create_commitment(
    blob: blob_pkg.Blob,
    subtree_root_threshold: int = appconsts.DEFAULT_SUBTREE_ROOT_THRESHOLD,
) -> bytes:
    """Share commitment of one blob. ref: commitment.go:19-75"""
    blob.validate()
    namespace = blob.namespace()
    shares = split_blobs([blob])

    width = sub_tree_width(len(shares), subtree_root_threshold)
    tree_sizes = merkle_mountain_range_sizes(len(shares), width)

    subtree_roots: list[bytes] = []
    cursor = 0
    ns_bytes = namespace.bytes
    for size in tree_sizes:
        leaves = [ns_bytes + s.to_bytes() for s in shares[cursor : cursor + size]]
        subtree_roots.append(nmt_root(leaves))
        cursor += size
    return merkle_root(subtree_roots)


def create_commitments(
    blobs: list[blob_pkg.Blob],
    subtree_root_threshold: int = appconsts.DEFAULT_SUBTREE_ROOT_THRESHOLD,
) -> list[bytes]:
    return [create_commitment(b, subtree_root_threshold) for b in blobs]
