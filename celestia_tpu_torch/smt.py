"""Sparse Merkle tree state commitment (IAVL-multistore analogue).

The reference commits an IAVL multistore per block: O(log n) updates, app
hash = root, and state inclusion proofs for queries (app/app.go:263-279,
baseapp query routes). This module provides the same commitments over the
framework's flat KV store as a 256-level sparse Merkle tree over
sha256(key), with the standard empty-subtree default-hash table so the
tree stays proportional to the live key set.

Domain separation:
    leaf   = H(0x00 ‖ keyhash ‖ H(value))
    inner  = H(0x01 ‖ left ‖ right)
    empty  = per-depth default: D[256] = H(0x02), D[d] = inner(D[d+1], D[d+1])

Updates walk one root-to-leaf path (256 inner hashes); commit cost is
O(dirty keys · log), independent of total state size. Proofs carry one
sibling per level, compressed by omitting default siblings via a bitmap.
"""

from __future__ import annotations

import dataclasses
import hashlib

DEPTH = 256


def _h(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def _defaults() -> list[bytes]:
    d = [b""] * (DEPTH + 1)
    d[DEPTH] = _h(b"\x02")
    for i in range(DEPTH - 1, -1, -1):
        d[i] = _h(b"\x01" + d[i + 1] + d[i + 1])
    return d


DEFAULT = _defaults()


def leaf_hash(keyhash: bytes, value: bytes) -> bytes:
    return _h(b"\x00" + keyhash + _h(value))


def _inner(left: bytes, right: bytes) -> bytes:
    return _h(b"\x01" + left + right)


@dataclasses.dataclass
class Proof:
    """Inclusion (value is not None) or absence proof for one key."""

    keyhash: bytes
    siblings: list[bytes | None]  # index 0 = deepest level; None = default

    def marshal(self) -> dict:
        return {
            "keyhash": self.keyhash.hex(),
            "siblings": [s.hex() if s else "" for s in self.siblings],
        }

    @classmethod
    def unmarshal(cls, obj: dict) -> "Proof":
        return cls(
            keyhash=bytes.fromhex(obj["keyhash"]),
            siblings=[bytes.fromhex(s) if s else None for s in obj["siblings"]],
        )


class SparseMerkleTree:
    def __init__(self):
        # (depth, prefix) -> node hash; only non-default nodes stored
        self._nodes: dict[tuple[int, int], bytes] = {}
        self.hash_count = 0  # instrumentation: commit-cost assertions

    @property
    def root(self) -> bytes:
        return self._nodes.get((0, 0), DEFAULT[0])

    def _get(self, depth: int, prefix: int) -> bytes:
        return self._nodes.get((depth, prefix), DEFAULT[depth])

    def update(self, keyhash: bytes, value: bytes | None) -> None:
        """Set (value bytes) or clear (None) the leaf for keyhash."""
        path = int.from_bytes(keyhash, "big")
        if value is None:
            node: bytes | None = None
        else:
            node = leaf_hash(keyhash, value)
            self.hash_count += 2
        prefix = path
        if node is None:
            self._nodes.pop((DEPTH, prefix), None)
        else:
            self._nodes[(DEPTH, prefix)] = node
        cur = node if node is not None else DEFAULT[DEPTH]
        for depth in range(DEPTH, 0, -1):
            sibling = self._get(depth, prefix ^ 1)
            if prefix & 1 == 0:
                cur = _inner(cur, sibling)
            else:
                cur = _inner(sibling, cur)
            self.hash_count += 1
            prefix >>= 1
            if cur == DEFAULT[depth - 1]:
                self._nodes.pop((depth - 1, prefix), None)
            else:
                self._nodes[(depth - 1, prefix)] = cur

    def prove(self, keyhash: bytes) -> Proof:
        path = int.from_bytes(keyhash, "big")
        siblings: list[bytes | None] = []
        prefix = path
        for depth in range(DEPTH, 0, -1):
            sib = self._nodes.get((depth, prefix ^ 1))
            siblings.append(sib)
            prefix >>= 1
        return Proof(keyhash=keyhash, siblings=siblings)


def verify_proof(root: bytes, key: bytes, value: bytes | None, proof: Proof) -> bool:
    """Verify inclusion (value bytes) or absence (value None) against root."""
    keyhash = _h(key)
    if keyhash != proof.keyhash or len(proof.siblings) != DEPTH:
        return False
    cur = leaf_hash(keyhash, value) if value is not None else DEFAULT[DEPTH]
    path = int.from_bytes(keyhash, "big")
    prefix = path
    for i, depth in enumerate(range(DEPTH, 0, -1)):
        sibling = proof.siblings[i] if proof.siblings[i] is not None else DEFAULT[depth]
        if prefix & 1 == 0:
            cur = _inner(cur, sibling)
        else:
            cur = _inner(sibling, cur)
        prefix >>= 1
    return cur == root


def key_hash(key: bytes) -> bytes:
    return _h(key)
