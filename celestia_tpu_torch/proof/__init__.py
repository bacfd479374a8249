"""NMT range proofs for DAS samples (port of the DAS half of the JAX
package's proof/__init__.py).

A `/sample` answer carries one share and the nmt v0.20 range proof of its
leaf against its row root: the maximal subtrees outside the range, in
traversal order, over the RFC 6962 split. ``NmtRowProver`` hashes a row's
leaves and every subtree root once (or takes them from the device's row
levels, ``extend.eds_row_levels_device``), so a batch of samples of one row
costs one pass of hashing; ``das_sample_docs`` builds the response
documents of a batch.

The absence, share, row, tx and Merkle proofs of the JAX module come with
the port's square construction and App.
"""

from __future__ import annotations

import dataclasses

from celestia_tpu_torch import da
from celestia_tpu_torch.ops.nmt_host import hash_leaf, hash_node


def _split_point(n: int) -> int:
    k = 1
    while k * 2 < n:
        k *= 2
    return k


@dataclasses.dataclass
class NmtRangeProof:
    start: int
    end: int
    nodes: list[bytes]  # 90-byte subtree roots, traversal order
    tree_size: int | None = None

    def verify_inclusion(
        self, root: bytes, leaf_namespaces: list[bytes], leaf_data: list[bytes]
    ) -> None:
        """Recompute the root from the in-range leaves and the sibling
        nodes; leaf_namespaces[i] ‖ leaf_data[i] is the raw leaf at
        position start + i."""
        if self.end <= self.start or len(leaf_data) != self.end - self.start:
            raise ValueError("leaf count does not match proof range")
        computed = self._compute_root(leaf_namespaces, leaf_data)
        if computed != root:
            raise ValueError("nmt range proof verification failed")

    def _compute_root(self, leaf_namespaces, leaf_data) -> bytes:
        nodes_iter = iter(self.nodes)
        total = self.tree_size
        if total is None:
            raise ValueError("tree_size must be set before verification")
        # a range outside [0, total) would make rec() take the whole tree as
        # out of range and return the first supplied node: a "proof" of any
        # root that binds no leaf
        if not (0 <= self.start < self.end <= total):
            raise ValueError(
                f"proof range [{self.start}, {self.end}) invalid for "
                f"tree size {total}"
            )

        def rec(lo: int, hi: int) -> bytes:
            if hi <= self.start or lo >= self.end:
                return next(nodes_iter)
            if hi - lo == 1:
                i = lo - self.start
                return hash_leaf(leaf_namespaces[i] + leaf_data[i])
            split = _split_point(hi - lo)
            return hash_node(rec(lo, lo + split), rec(lo + split, hi))

        root = rec(0, total)
        leftover = next(nodes_iter, None)
        if leftover is not None:
            raise ValueError("unconsumed proof nodes")
        return root


def nmt_prove_range(
    leaves: list[bytes], start: int, end: int
) -> NmtRangeProof:
    """Range proof over namespaced leaves (each = 29-byte ns ‖ data)."""
    n = len(leaves)
    if not (0 <= start < end <= n):
        raise ValueError(f"invalid range [{start}, {end}) of {n}")
    nodes: list[bytes] = []

    # the maximal fully-outside subtree roots, in traversal order
    def collect(lo: int, hi: int) -> None:
        if hi <= start or lo >= end:
            nodes.append(_subtree_root(leaves, lo, hi))
            return
        if hi - lo == 1:
            return
        split = _split_point(hi - lo)
        collect(lo, lo + split)
        collect(lo + split, hi)

    collect(0, n)
    return NmtRangeProof(start=start, end=end, nodes=nodes, tree_size=n)


def _subtree_root(leaves: list[bytes], lo: int, hi: int) -> bytes:
    if hi - lo == 1:
        return hash_leaf(leaves[lo])
    split = _split_point(hi - lo)
    return hash_node(
        _subtree_root(leaves, lo, lo + split), _subtree_root(leaves, lo + split, hi)
    )


class NmtRowProver:
    """Hash-once range prover over one namespaced leaf set.

    The constructor hashes the leaf layer and every subtree root once;
    each ``prove_range`` is then memo lookups over the same RFC 6962
    split structure, so its nodes are byte-identical to
    ``nmt_prove_range``'s."""

    def __init__(self, leaves: list[bytes]):
        self.tree_size = len(leaves)
        self._roots: dict[tuple[int, int], bytes] = {}

        def build(lo: int, hi: int) -> bytes:
            if hi - lo == 1:
                node = hash_leaf(leaves[lo])
            else:
                split = _split_point(hi - lo)
                node = hash_node(build(lo, lo + split), build(lo + split, hi))
            self._roots[(lo, hi)] = node
            return node

        if self.tree_size:
            build(0, self.tree_size)

    @classmethod
    def from_node_levels(cls, levels: list) -> "NmtRowProver":
        """Seed the memo from device-computed subtree nodes.

        ``levels[L]`` holds the 90-byte NMT nodes of every aligned span of
        width 2**L, leaves first, root level last: one row of
        ``extend.eds_row_levels_device``'s levels. For a power-of-two tree
        the RFC 6962 split is always the half, so the aligned spans are the
        memo keys ``__init__`` would build, and no host hashing is done."""
        n = len(levels[0])
        if n & (n - 1):
            raise ValueError(f"levels seeding requires pow2 leaves, got {n}")
        if len(levels[-1]) != 1 or len(levels) != n.bit_length():
            raise ValueError("levels do not form a complete binary tree")
        prover = cls([])
        prover.tree_size = n
        for level, nodes in enumerate(levels):
            span = 1 << level
            for j, node in enumerate(nodes):
                prover._roots[(j * span, (j + 1) * span)] = bytes(node)
        return prover

    def root(self) -> bytes:
        if not self.tree_size:
            raise ValueError("empty tree has no root here")
        return self._roots[(0, self.tree_size)]

    def prove_range(self, start: int, end: int) -> NmtRangeProof:
        n = self.tree_size
        if not (0 <= start < end <= n):
            raise ValueError(f"invalid range [{start}, {end}) of {n}")
        nodes: list[bytes] = []

        # nmt_prove_range's traversal: every maximal fully-outside subtree
        # is a (lo, hi) split the constructor memoized
        def collect(lo: int, hi: int) -> None:
            if hi <= start or lo >= end:
                nodes.append(self._roots[(lo, hi)])
                return
            if hi - lo == 1:
                return
            split = _split_point(hi - lo)
            collect(lo, lo + split)
            collect(lo + split, hi)

        collect(0, n)
        return NmtRangeProof(start=start, end=end, nodes=nodes, tree_size=n)


def das_sample_docs(
    rows_cells: dict[int, list[bytes]],
    coords: list[tuple[int, int]],
    k_orig: int,
    provers: dict[int, NmtRowProver] | None = None,
) -> list[dict]:
    """The `/sample` response documents for a batch of (row, col)
    coordinates of one height: one NmtRowProver per distinct row, one
    memo-lookup proof per sample.

    ``rows_cells`` maps each referenced row to its full extended row (2k
    cells of raw bytes); coords are in range. ``provers`` optionally
    supplies seeded per-row provers; rows missing from it are built on the
    host and added to it."""
    if provers is None:
        provers = {}
    docs: list[dict] = []
    for i, j in coords:
        prover = provers.get(i)
        if prover is None:
            leaves = da.erasured_axis_leaves(rows_cells[i], i, k_orig)
            prover = provers[i] = NmtRowProver(leaves)
        proof = prover.prove_range(j, j + 1)
        docs.append({
            "share": rows_cells[i][j].hex(),
            "proof": {
                "start": proof.start,
                "end": proof.end,
                "nodes": [n.hex() for n in proof.nodes],
                "tree_size": proof.tree_size,
            },
        })
    return docs
