"""Host (CPU, hashlib) Namespaced Merkle Tree — the correctness reference.

Reimplements the nmt v0.20.0 hasher semantics used by the reference
(pkg/wrapper/nmt_wrapper.go:55-62 configures NamespaceIDSize=29,
IgnoreMaxNamespace=true, SHA-256):

- node digest format: minNs(29) ‖ maxNs(29) ‖ sha256-digest(32)  (90 bytes)
- leaf: min=max=leaf namespace; digest = sha256(0x00 ‖ ns ‖ data)
- inner (nmt hasher.go HashNode, full IgnoreMaxNamespace semantics):
    minNs = min(left.minNs, right.minNs)
    maxNs = MAX_NS                if left.minNs == MAX_NS
          = left.maxNs            elif right.minNs == MAX_NS
          = max(left.maxNs, right.maxNs)  otherwise
  where MAX_NS is the maximal namespace (0xFF*29 == the parity namespace).
- sibling order is VALIDATED: hashing children with
  right.minNs < left.maxNs raises UnorderedSiblingsError, mirroring nmt's
  ErrUnorderedSiblings; pushing leaves with decreasing namespaces raises
  InvalidPushOrderError (nmt ErrInvalidPushOrder). For trees that pass
  this validation the three-branch max rule degenerates to the simpler
  "left.maxNs if right.minNs == parity else right.maxNs" used by the
  vectorized device tree code (ops/extend.py) — see
  tests/test_nmt_semantics.py for the adversarial vectors pinning both
  facts.
- tree shape: RFC-6962 split (largest power of two strictly less than n).
"""

from __future__ import annotations

import hashlib

from celestia_tpu_torch import namespace as ns
from celestia_tpu_torch.appconsts import NAMESPACE_SIZE

LEAF_PREFIX = b"\x00"
NODE_PREFIX = b"\x01"
PARITY_NS_BYTES = ns.PARITY_SHARES_NAMESPACE.bytes
NMT_ROOT_SIZE = 2 * NAMESPACE_SIZE + 32


def hash_leaf(ndata: bytes) -> bytes:
    """ndata = namespace(29) ‖ data. Returns 90-byte namespaced digest."""
    nid = ndata[:NAMESPACE_SIZE]
    digest = hashlib.sha256(LEAF_PREFIX + ndata).digest()
    return nid + nid + digest

class UnorderedSiblingsError(ValueError):
    """nmt hasher.go ErrUnorderedSiblings: left.maxNs > right.minNs."""


class InvalidPushOrderError(ValueError):
    """nmt nmt.go ErrInvalidPushOrder: leaf namespaces must be non-decreasing."""


def hash_node(left: bytes, right: bytes, ignore_max_ns: bool = True) -> bytes:
    """nmt hasher.go HashNode with full IgnoreMaxNamespace semantics.

    Validates sibling namespace order like the nmt hasher does (it returns
    ErrUnorderedSiblings rather than producing a digest for out-of-order
    children). Note that with IgnoreMaxNamespace a parity leaf hidden in
    the middle of a subtree is not visible in that subtree's (min, max)
    summary, so per-node sibling checks alone do not catch every
    out-of-order LEAF sequence — tree-building entry points additionally
    run _validate_push_order over the raw leaves (nmt ErrInvalidPushOrder),
    exactly as nmt's Push does."""
    left_min, left_max = left[:NAMESPACE_SIZE], left[NAMESPACE_SIZE : 2 * NAMESPACE_SIZE]
    right_min, right_max = (
        right[:NAMESPACE_SIZE],
        right[NAMESPACE_SIZE : 2 * NAMESPACE_SIZE],
    )
    if right_min < left_max:
        raise UnorderedSiblingsError(
            "the max namespace of the left child is greater than the min "
            "namespace of the right child"
        )
    min_ns = min(left_min, right_min)
    if ignore_max_ns and left_min == PARITY_NS_BYTES:
        max_ns = PARITY_NS_BYTES
    elif ignore_max_ns and right_min == PARITY_NS_BYTES:
        max_ns = left_max
    else:
        max_ns = max(left_max, right_max)
    digest = hashlib.sha256(NODE_PREFIX + left + right).digest()
    return min_ns + max_ns + digest


def _split_point(n: int) -> int:
    """Largest power of two strictly less than n (RFC 6962)."""
    k = 1
    while k * 2 < n:
        k *= 2
    return k


def _validate_push_order(leaves: list[bytes]) -> None:
    """nmt Push rejects a leaf whose namespace is below the previous one."""
    prev = None
    for leaf in leaves:
        nid = leaf[:NAMESPACE_SIZE]
        if prev is not None and nid < prev:
            raise InvalidPushOrderError(
                "pushed namespace is lower than the last pushed namespace"
            )
        prev = nid


def nmt_root(leaves: list[bytes]) -> bytes:
    """Root over namespaced leaves (each = 29-byte ns ‖ data)."""
    _validate_push_order(leaves)
    return _nmt_root_unchecked(leaves)


def _nmt_root_unchecked(leaves: list[bytes]) -> bytes:
    n = len(leaves)
    if n == 0:
        return bytes(2 * NAMESPACE_SIZE) + hashlib.sha256(b"").digest()
    if n == 1:
        return hash_leaf(leaves[0])
    k = _split_point(n)
    return hash_node(_nmt_root_unchecked(leaves[:k]), _nmt_root_unchecked(leaves[k:]))


def nmt_inner_nodes(leaves: list[bytes]) -> list[bytes]:
    """All node digests of the tree in a list; [0] is the root. Used by the
    subtree-root cache (pkg/inclusion/nmt_caching.go analogue)."""
    _validate_push_order(leaves)
    nodes: list[bytes] = []

    def rec(lo: int, hi: int) -> bytes:
        if hi - lo == 1:
            h = hash_leaf(leaves[lo])
        else:
            k = _split_point(hi - lo)
            left = rec(lo, lo + k)
            right = rec(lo + k, hi)
            h = hash_node(left, right)
        nodes.append(h)
        return h

    root = rec(0, len(leaves))
    nodes.reverse()
    assert nodes[0] == root
    return nodes


# --- RFC-6962 plain merkle (tendermint crypto/merkle) for the DAH hash ---


def merkle_leaf_hash(leaf: bytes) -> bytes:
    return hashlib.sha256(LEAF_PREFIX + leaf).digest()


def merkle_inner_hash(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(NODE_PREFIX + left + right).digest()


def merkle_root(items: list[bytes]) -> bytes:
    """tendermint merkle.HashFromByteSlices (RFC 6962, no leaf duplication)."""
    n = len(items)
    if n == 0:
        return hashlib.sha256(b"").digest()
    if n == 1:
        return merkle_leaf_hash(items[0])
    k = _split_point(n)
    return merkle_inner_hash(merkle_root(items[:k]), merkle_root(items[k:]))
