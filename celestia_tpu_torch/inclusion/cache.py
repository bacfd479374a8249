"""EDS subtree-root cache + commitment retrieval from a built square.

Reference semantics: pkg/inclusion/nmt_caching.go (EDSSubTreeRootCacher —
retain row-tree inner nodes so blob share commitments can be read back out
of the EDS without recomputation) and pkg/inclusion/get_commit.go
(GetCommitment — the MMR subtree roots of a laid-out blob are, by the
ADR-013 alignment rules, inner nodes of the row NMTs; the commitment is
the binary merkle root over them).
"""

from __future__ import annotations

import functools

from celestia_tpu_torch import namespace as ns_pkg
from celestia_tpu_torch.appconsts import NAMESPACE_SIZE
from celestia_tpu_torch.ops.nmt_host import hash_leaf, hash_node, merkle_root

from . import merkle_mountain_range_sizes, sub_tree_width


class EDSSubtreeRootCacher:
    """Caches NMT subtree roots of the EDS row trees, keyed by
    (row, leaf_lo, leaf_hi)."""

    def __init__(self, eds):
        self.eds = eds
        self.square_size = eds.original_width
        self._parity_ns = ns_pkg.PARITY_SHARES_NAMESPACE.bytes
        self._row_leaves: dict[int, list[bytes]] = {}

    def _leaves(self, row: int) -> list[bytes]:
        if row not in self._row_leaves:
            cells = self.eds.row(row)
            k = self.square_size
            self._row_leaves[row] = [
                ((cell[:NAMESPACE_SIZE] if (row < k and pos < k) else self._parity_ns)
                 + cell)
                for pos, cell in enumerate(cells)
            ]
        return self._row_leaves[row]

    @functools.lru_cache(maxsize=4096)  # noqa: B019 — cache is the point
    def subtree_root(self, row: int, lo: int, hi: int) -> bytes:
        leaves = self._leaves(row)
        if not (0 <= lo < hi <= len(leaves)):
            raise ValueError(f"invalid leaf range [{lo}, {hi})")
        return self._compute(row, lo, hi)

    def _compute(self, row: int, lo: int, hi: int) -> bytes:
        leaves = self._leaves(row)
        if hi - lo == 1:
            return hash_leaf(leaves[lo])
        split = 1
        while split * 2 < hi - lo:
            split *= 2
        return hash_node(
            self.subtree_root(row, lo, lo + split),
            self.subtree_root(row, lo + split, hi),
        )


def get_commitment(
    cacher: EDSSubtreeRootCacher,
    start: int,
    blob_share_len: int,
    subtree_root_threshold: int,
) -> bytes:
    """Commitment of the blob at share index `start` spanning
    blob_share_len shares, read from the EDS row trees.
    ref: pkg/inclusion/get_commit.go:12"""
    k = cacher.square_size
    width = sub_tree_width(blob_share_len, subtree_root_threshold)
    if start % width != 0:
        raise ValueError(
            f"blob start {start} not aligned to subtree width {width} (ADR-013)"
        )
    tree_sizes = merkle_mountain_range_sizes(blob_share_len, width)

    subtree_roots: list[bytes] = []
    cursor = start
    for size in tree_sizes:
        row, lo = divmod(cursor, k)
        if lo + size > k:
            raise ValueError("MMR subtree crosses a row boundary")
        subtree_roots.append(cacher.subtree_root(row, lo, lo + size))
        cursor += size
    return merkle_root(subtree_roots)
