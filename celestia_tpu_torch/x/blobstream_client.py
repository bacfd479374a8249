"""Blobstream verify flow (port of the JAX package's
x/blobstream_client.py): prove shares/txs/blobs were committed to by a
data commitment attestation.

Reference semantics: x/blobstream/client/verify.go — `verify tx|blob|
shares` resolves a share range, checks the share inclusion proof against
the block's data root (self-verifying), queries the data commitment
attestation covering the height (DataCommitmentRangeForHeight), fetches
the data-root-tuple inclusion proof for the height, and finally checks
the tuple against the attestation the bridge validators signed
(VerifyDataRootInclusion against the contract state).

Without an EVM chain in the loop, the "contract side" here is the
attestation itself: the proof is verified against the tuple root over the
attested range, and the returned record carries the exact
`data_commitment_sign_bytes` the orchestrators sign / the contract
checks — so an external consumer can take the result straight to a real
Blobstream contract. The share proof's square is extended on the node's
device.
"""

from __future__ import annotations

import dataclasses

from celestia_tpu_torch.x import blobstream_abi as abi


@dataclasses.dataclass
class VerifyResult:
    committed: bool
    height: int
    nonce: int = 0
    begin_block: int = 0
    end_block: int = 0
    tuple_root: bytes = b""
    sign_bytes: bytes = b""
    reason: str = ""


def _tuple_range(node, begin: int, end: int):
    heights = list(range(begin, end + 1))
    roots = []
    for h in heights:
        block = node.get_block(h)
        if block is None:
            raise ValueError(f"block {h} not in store (commitment range {begin}-{end})")
        roots.append(block.data_hash)
    return heights, roots


def data_root_tuple_root_for_attestation(node, att: dict) -> bytes:
    """Tuple root over the attestation's [begin, end] block range."""
    heights, roots = _tuple_range(node, att["begin_block"], att["end_block"])
    return abi.data_root_tuple_root(
        [abi.encode_data_root_tuple(h, r) for h, r in zip(heights, roots)]
    )


def verify_shares(node, height: int, start: int, end: int) -> VerifyResult:
    """ref: client/verify.go:189 VerifyShares."""
    block = node.get_block(height)
    if block is None:
        return VerifyResult(False, height, reason=f"block {height} not found")

    # 1. shares -> data root (self-verifying share proof)
    from celestia_tpu_torch import appconsts
    from celestia_tpu_torch import namespace as ns_mod
    from celestia_tpu_torch import square as square_pkg
    from celestia_tpu_torch.proof import new_share_inclusion_proof
    from celestia_tpu_torch.shares.splitters import Range

    sq = square_pkg.construct(
        block.txs, node.app.app_version,
        appconsts.square_size_upper_bound(node.app.app_version),
    )
    if not (0 <= start < end <= len(sq)):
        return VerifyResult(False, height, reason="share range out of bounds")
    namespace = ns_mod.from_bytes(sq[start].data[: appconsts.NAMESPACE_SIZE])
    try:
        proof = new_share_inclusion_proof(sq, namespace, Range(start, end),
                                          device=node.device)
        proof.validate(block.data_hash)
    except ValueError as e:
        return VerifyResult(False, height, reason=f"share proof invalid: {e}")

    # 2. the data commitment attestation covering this height
    att = node.app.blobstream.data_commitment_range_for_height(height)
    if att is None:
        return VerifyResult(
            False, height,
            reason="no data commitment attestation covers this height yet",
        )

    # 3. data root tuple inclusion in the attested range (root + proof in
    # one tree pass)
    heights, roots = _tuple_range(node, att["begin_block"], att["end_block"])
    tuple_root, inclusion = abi.prove_data_root_inclusion_with_root(
        heights, roots, height
    )
    if inclusion.data_root != block.data_hash or not inclusion.verify(tuple_root):
        return VerifyResult(False, height, reason="data root inclusion proof invalid")

    return VerifyResult(
        committed=True,
        height=height,
        nonce=att["nonce"],
        begin_block=att["begin_block"],
        end_block=att["end_block"],
        tuple_root=tuple_root,
        sign_bytes=abi.data_commitment_sign_bytes(att["nonce"], tuple_root),
    )


def verify_tx(node, tx_hash: bytes) -> VerifyResult:
    """ref: client/verify.go:37 txCmd — resolve the tx's share range then
    verify it."""
    found = node.get_tx(tx_hash)
    if found is None:
        return VerifyResult(False, 0, reason="tx not found")
    block, tx_index = found
    from celestia_tpu_torch import square as square_pkg

    rng = square_pkg.tx_share_range(block.txs, tx_index, node.app.app_version)
    return verify_shares(node, block.height, rng.start, rng.end)


def verify_blob(node, tx_hash: bytes, blob_index: int) -> VerifyResult:
    """ref: client/verify.go:94 blobCmd."""
    found = node.get_tx(tx_hash)
    if found is None:
        return VerifyResult(False, 0, reason="tx not found")
    block, tx_index = found
    from celestia_tpu_torch import square as square_pkg

    rng = square_pkg.blob_share_range(
        block.txs, tx_index, blob_index, node.app.app_version
    )
    return verify_shares(node, block.height, rng.start, rng.end)
