"""Share, tx and DAS proofs against the data root (port of the JAX
package's proof/__init__.py).

Reference semantics: pkg/proof/proof.go (NewTxInclusionProof:23,
NewShareInclusionProof:58), tendermint crypto/merkle proofs (RFC 6962),
and nmt v0.20 range and absence proofs. A ShareProof carries the raw
shares, one NMT range proof per touched row, the touched row roots, and
binary merkle proofs of those row roots to the data root (merkle over
rowRoots‖colRoots, pkg/da/data_availability_header.go:92-108).

A `/sample` answer carries one share and the nmt v0.20 range proof of its
leaf against its row root: the maximal subtrees outside the range, in
traversal order, over the RFC 6962 split. ``NmtRowProver`` hashes a row's
leaves and every subtree root once (or takes them from the device's row
levels, ``extend.eds_row_levels_device``), so a batch of samples of one row
costs one pass of hashing; ``das_sample_docs`` builds the response
documents of a batch.

``new_share_inclusion_proof`` and ``new_tx_inclusion_proof`` extend the
square with ``da.extend_shares`` when no EDS is given; they take
``device=None`` (CUDA) and hand it on.
"""

from __future__ import annotations

import dataclasses

from celestia_tpu_torch import da
from celestia_tpu_torch import namespace as ns_pkg
from celestia_tpu_torch.appconsts import NAMESPACE_SIZE
from celestia_tpu_torch.namespace import Namespace
from celestia_tpu_torch.ops.nmt_host import (
    hash_leaf,
    hash_node,
    merkle_inner_hash,
    merkle_leaf_hash,
    nmt_root,
)
from celestia_tpu_torch.shares import Share, to_bytes
from celestia_tpu_torch.shares.splitters import Range


def _split_point(n: int) -> int:
    k = 1
    while k * 2 < n:
        k *= 2
    return k


# ---------------------------------------------------------------------- #
# Binary merkle proofs (tendermint crypto/merkle, RFC 6962)


@dataclasses.dataclass
class MerkleProof:
    total: int
    index: int
    leaf_hash: bytes
    aunts: list[bytes]

    def verify(self, root: bytes, leaf: bytes) -> None:
        if merkle_leaf_hash(leaf) != self.leaf_hash:
            raise ValueError("leaf hash mismatch")
        computed = _hash_from_aunts(self.index, self.total, self.leaf_hash, self.aunts)
        if computed != root:
            raise ValueError("merkle proof verification failed")


def _hash_from_aunts(index: int, total: int, leaf_hash: bytes, aunts: list[bytes]) -> bytes:
    if index >= total or index < 0 or total <= 0:
        raise ValueError("invalid index/total")
    if total == 1:
        if aunts:
            raise ValueError("unexpected aunts")
        return leaf_hash
    if not aunts:
        raise ValueError("missing aunts")
    split = _split_point(total)
    if index < split:
        left = _hash_from_aunts(index, split, leaf_hash, aunts[:-1])
        return merkle_inner_hash(left, aunts[-1])
    right = _hash_from_aunts(index - split, total - split, leaf_hash, aunts[:-1])
    return merkle_inner_hash(aunts[-1], right)


def merkle_proofs(items: list[bytes]) -> tuple[bytes, list[MerkleProof]]:
    """Root + a proof per item (merkle.ProofsFromByteSlices)."""
    n = len(items)
    leaf_hashes = [merkle_leaf_hash(i) for i in items]

    proofs = [MerkleProof(total=n, index=i, leaf_hash=leaf_hashes[i], aunts=[])
              for i in range(n)]

    def rec(lo: int, hi: int) -> bytes:
        if hi - lo == 1:
            return leaf_hashes[lo]
        split = _split_point(hi - lo)
        left = rec(lo, lo + split)
        right = rec(lo + split, hi)
        for i in range(lo, lo + split):
            proofs[i].aunts.append(right)
        for i in range(lo + split, hi):
            proofs[i].aunts.append(left)
        return merkle_inner_hash(left, right)

    if n == 0:
        import hashlib

        return hashlib.sha256(b"").digest(), []
    root = rec(0, n)
    # recursion descends before appending, so aunts are already ordered
    # deepest-first — the order _hash_from_aunts consumes (top aunt last)
    return root, proofs


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


# ---------------------------------------------------------------------- #
# NMT namespace ABSENCE proofs (nmt v0.20 ProveNamespace / VerifyNamespace
# for a namespace inside the root's [min, max] range with no leaves)


@dataclasses.dataclass
class NmtAbsenceProof:
    """Proof that a namespace has NO leaves in a tree whose root range
    covers it: the witness is the first leaf whose namespace is GREATER
    than the target, plus its merkle path. Verification checks the
    witness's namespace bound and completeness (every left sibling's max
    namespace is below the target, every right sibling's min above), so
    no position where the target could hide survives.
    ref: nmt proof.go VerifyNamespace absence branch."""

    position: int  # index of the witness leaf
    leaf_node: bytes  # its full 90-byte NMT node
    nodes: list[bytes]  # sibling subtree roots, traversal order
    tree_size: int

    def verify(self, root: bytes, namespace: bytes) -> None:
        ns_len = NAMESPACE_SIZE
        if len(self.leaf_node) != 2 * ns_len + 32:
            raise ValueError("malformed witness leaf node")
        witness_min = self.leaf_node[:ns_len]
        if witness_min <= namespace:
            raise ValueError(
                "witness leaf namespace does not exceed the target"
            )
        if not (0 <= self.position < self.tree_size):
            raise ValueError("witness position out of range")
        nodes_iter = iter(self.nodes)

        def rec(lo: int, hi: int) -> bytes:
            if hi <= self.position or lo > self.position:
                node = next(nodes_iter)
                if len(node) != 2 * ns_len + 32:
                    raise ValueError("malformed sibling node")
                if hi <= self.position:  # left sibling: strictly before
                    if node[ns_len : 2 * ns_len] >= namespace:
                        raise ValueError(
                            "left sibling max namespace reaches the target "
                            "(incomplete absence proof)"
                        )
                else:  # right sibling: strictly after the witness
                    if node[:ns_len] <= namespace:
                        raise ValueError(
                            "right sibling min namespace reaches the target"
                        )
                return node
            if hi - lo == 1:
                return self.leaf_node
            split = _split_point(hi - lo)
            return hash_node(rec(lo, lo + split), rec(lo + split, hi))

        computed = rec(0, self.tree_size)
        if next(nodes_iter, None) is not None:
            raise ValueError("unconsumed proof nodes")
        if computed != root:
            raise ValueError("absence proof root mismatch")

    def to_json(self) -> dict:
        return {
            "position": self.position,
            "leaf_node": self.leaf_node.hex(),
            "nodes": [n.hex() for n in self.nodes],
            "tree_size": self.tree_size,
        }

    @classmethod
    def from_json(cls, d: dict) -> "NmtAbsenceProof":
        return cls(
            position=d["position"],
            leaf_node=bytes.fromhex(d["leaf_node"]),
            nodes=[bytes.fromhex(n) for n in d["nodes"]],
            tree_size=d["tree_size"],
        )


def nmt_prove_absence(leaves: list[bytes], namespace: bytes) -> NmtAbsenceProof:
    """Absence proof for a namespace within the tree's range.
    leaves: full namespaced leaves (29-byte ns ‖ data), non-decreasing."""
    ns_len = NAMESPACE_SIZE
    leaf_ns = [leaf[:ns_len] for leaf in leaves]
    if any(n == namespace for n in leaf_ns):
        raise ValueError("namespace is present; absence cannot be proven")
    if not leaves or namespace < leaf_ns[0] or namespace > leaf_ns[-1]:
        raise ValueError(
            "namespace is outside the root's range: absence follows from "
            "the root's min/max, no proof needed"
        )
    position = next(i for i, n in enumerate(leaf_ns) if n > namespace)
    range_proof = nmt_prove_range(leaves, position, position + 1)
    return NmtAbsenceProof(
        position=position,
        leaf_node=hash_leaf(leaves[position]),
        nodes=range_proof.nodes,
        tree_size=len(leaves),
    )


def verify_namespace_absent(
    root: bytes, namespace: bytes, proof: NmtAbsenceProof | None
) -> None:
    """Full absence check against a 90-byte NMT root: outside the root's
    [min, max] no proof is needed; inside it the witness proof must
    verify. Raises on failure."""
    ns_len = NAMESPACE_SIZE
    root_min, root_max = root[:ns_len], root[ns_len : 2 * ns_len]
    if namespace < root_min or namespace > root_max:
        return  # absent by root range
    if proof is None:
        raise ValueError(
            "namespace is inside the root's range: an absence proof is required"
        )
    proof.verify(root, namespace)


# ---------------------------------------------------------------------- #
# Share / tx inclusion proofs


@dataclasses.dataclass
class RowProof:
    row_roots: list[bytes]  # 90-byte NMT roots of the touched rows
    proofs: list[MerkleProof]  # each row root -> data root
    start_row: int
    end_row: int

    def verify(self, data_root: bytes) -> None:
        if len(self.row_roots) != len(self.proofs):
            raise ValueError("row root / proof count mismatch")
        for root, proof in zip(self.row_roots, self.proofs):
            proof.verify(data_root, root)


@dataclasses.dataclass
class ShareProof:
    data: list[bytes]  # the raw shares being proven
    share_proofs: list[NmtRangeProof]  # one per touched row
    namespace: Namespace
    row_proof: RowProof

    def validate(self, data_root: bytes) -> None:
        """Full verification against the data root.
        ref: celestia-core types.ShareProof.Validate semantics"""
        if len(self.share_proofs) != len(self.row_proof.row_roots):
            raise ValueError("share proof / row root count mismatch")
        self.row_proof.verify(data_root)

        cursor = 0
        for proof, row_root in zip(self.share_proofs, self.row_proof.row_roots):
            count = proof.end - proof.start
            row_shares = self.data[cursor : cursor + count]
            if len(row_shares) != count:
                raise ValueError("share count does not match proof range")
            # Q0 leaves carry their own namespace (shares proven here are
            # always in the original square; parity cells use the parity
            # namespace and are never individually proven by the app).
            leaf_ns = [s[:NAMESPACE_SIZE] for s in row_shares]
            proof.verify_inclusion(row_root, leaf_ns, row_shares)
            cursor += count
        if cursor != len(self.data):
            raise ValueError("extra shares beyond proof ranges")


def new_share_inclusion_proof(
    data_square: list[Share], namespace: Namespace, share_range: Range,
    eds: "da.ExtendedDataSquare | None" = None,
    dah: "da.DataAvailabilityHeader | None" = None,
    device=None,
) -> ShareProof:
    """ref: pkg/proof/proof.go:58-165

    A serving node that already holds the block's extended square and
    DAH passes them in: no re-extension, no root recompute — and when
    the EDS handle is device-resident, the row reads below go through
    the SLICED path (ExtendedDataSquare.row), so only the proof's rows
    cross the interconnect. The per-row root check against the DAH
    keeps a stale/mismatched handle from ever producing a bad proof.
    Without ``eds`` the square is extended on ``device`` (None: CUDA)."""
    from celestia_tpu_torch import square as square_pkg

    square_size = square_pkg.square_size(len(data_square))
    start_row = share_range.start // square_size
    end_row = (share_range.end - 1) // square_size
    start_leaf = share_range.start % square_size
    end_leaf = (share_range.end - 1) % square_size

    if eds is None:
        eds = da.extend_shares(to_bytes(data_square), device)
    if dah is not None:
        row_roots_all = list(dah.row_roots)
        col_roots_all = list(dah.column_roots)
    else:
        row_roots_all = eds.row_roots()
        col_roots_all = eds.col_roots()

    _data_root, all_proofs = merkle_proofs(row_roots_all + col_roots_all)

    parity_ns = ns_pkg.PARITY_SHARES_NAMESPACE.bytes
    share_proofs: list[NmtRangeProof] = []
    raw_shares: list[bytes] = []
    row_roots: list[bytes] = []
    row_merkle_proofs: list[MerkleProof] = []
    for i, row_idx in enumerate(range(start_row, end_row + 1)):
        row_cells = eds.row(row_idx)
        leaves = [
            (cell[:NAMESPACE_SIZE] if pos < square_size else parity_ns) + cell
            for pos, cell in enumerate(row_cells)
        ]
        if nmt_root(leaves) != row_roots_all[row_idx]:
            raise ValueError("eds row root is different than tree root")

        s = start_leaf if i == 0 else 0
        e = end_leaf if row_idx == end_row else square_size - 1
        raw_shares.extend(row_cells[s : e + 1])
        share_proofs.append(nmt_prove_range(leaves, s, e + 1))
        row_roots.append(row_roots_all[row_idx])
        row_merkle_proofs.append(all_proofs[row_idx])

    return ShareProof(
        data=raw_shares,
        share_proofs=share_proofs,
        namespace=namespace,
        row_proof=RowProof(
            row_roots=row_roots,
            proofs=row_merkle_proofs,
            start_row=start_row,
            end_row=end_row,
        ),
    )


def new_tx_inclusion_proof(txs: list[bytes], tx_index: int, app_version: int,
                           device=None) -> ShareProof:
    """ref: pkg/proof/proof.go:23-45; the square is extended on ``device``
    (None: CUDA)."""
    from celestia_tpu_torch import appconsts, blob as blob_pkg
    from celestia_tpu_torch import square as square_pkg

    if tx_index >= len(txs):
        raise ValueError(f"txIndex {tx_index} out of bounds")
    builder = square_pkg.Builder.from_txs(
        appconsts.square_size_upper_bound(app_version), app_version, txs
    )
    data_square = builder.export()
    share_range = builder.find_tx_share_range(tx_index)

    _, is_blob_tx = blob_pkg.unmarshal_blob_tx(txs[tx_index])
    namespace = ns_pkg.PAY_FOR_BLOB_NAMESPACE if is_blob_tx else ns_pkg.TX_NAMESPACE
    return new_share_inclusion_proof(data_square, namespace, share_range,
                                     device=device)
