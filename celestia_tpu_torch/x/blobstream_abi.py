"""Blobstream EVM ABI surface: valset hashes, domain-separated sign bytes,
data-root tuple roots, and EIP-55 addresses.

Reference semantics: x/blobstream/types/abi_consts.go (the internal
Blobstream contract ABI + domain separators), valset.go:30-90 (SignBytes /
Hash / TwoThirdsThreshold over abi.Pack with the 4-byte selector
stripped), and the data-root tuple encoding the celestia-core
DataCommitment RPC uses (RFC-6962 merkle over abi.encode(height, dataRoot)
leaves — x/blobstream/README.md:110-125).

The reference links go-ethereum for ABI encoding; here the three fixed
shapes are encoded directly (Solidity ABI v2 is deterministic):

- computeValidatorSetHash((address,uint256)[]): one dynamic arg — head is
  the 32-byte offset (0x20), tail is array length + static tuples.
- domainSeparateValidatorSetHash(bytes32,uint256,uint256,bytes32) and
  domainSeparateDataRootTupleRoot(bytes32,uint256,bytes32): static words.

Since SignBytes keccaks `Pack(...)[4:]`, the selector never matters and is
not computed.
"""

from __future__ import annotations

import dataclasses

from celestia_tpu_torch.crypto.keccak import keccak256

# Domain separator constants copied from the Blobstream contracts
# (abi_consts.go:113-115): bytes32("checkpoint") / bytes32("transactionBatch")
VS_DOMAIN_SEPARATOR = b"checkpoint".ljust(32, b"\x00")
DC_DOMAIN_SEPARATOR = b"transactionBatch".ljust(32, b"\x00")


def _word_uint(n: int) -> bytes:
    if n < 0:
        raise ValueError("uint256 cannot be negative")
    return int(n).to_bytes(32, "big")


def _word_address(addr_hex: str) -> bytes:
    raw = bytes.fromhex(addr_hex.removeprefix("0x"))
    if len(raw) != 20:
        raise ValueError(f"invalid EVM address {addr_hex}")
    return raw.rjust(32, b"\x00")


def _word_bytes32(b: bytes) -> bytes:
    if len(b) != 32:
        raise ValueError("bytes32 must be exactly 32 bytes")
    return b


def eip55_checksum_address(addr_hex: str) -> str:
    """EIP-55 mixed-case checksum (go-ethereum common.Address.Hex), used
    for the valset tie-break sort (validator.go:97-99 EVMAddrLessThan)."""
    stripped = addr_hex.removeprefix("0x").lower()
    digest = keccak256(stripped.encode()).hex()
    out = []
    for ch, d in zip(stripped, digest):
        out.append(ch.upper() if ch.isalpha() and int(d, 16) >= 8 else ch)
    return "0x" + "".join(out)


# --------------------------------------------------------------------- #
# valset hashing (valset.go)


def encode_validator_set(members) -> bytes:
    """Argument encoding of computeValidatorSetHash's (address,uint256)[]:
    offset word, length word, then one static (addr, power) tuple per
    member, in the stored (sorted) order."""
    tail = _word_uint(len(members))
    for m in members:
        tail += _word_address(_member_addr(m)) + _word_uint(_member_power(m))
    return _word_uint(0x20) + tail


def _member_addr(m) -> str:
    return m["evm_address"] if isinstance(m, dict) else m.evm_address


def _member_power(m) -> int:
    return m["power"] if isinstance(m, dict) else m.power


def validator_set_hash(members) -> bytes:
    """ref: valset.go:61 Valset.Hash — keccak of the abi-encoded set."""
    return keccak256(encode_validator_set(members))


def two_thirds_threshold(members) -> int:
    """ref: valset.go:79 — 2 * (total/3 + 1), the contract's vote floor."""
    total = sum(_member_power(m) for m in members)
    one_third = total // 3 + 1
    return 2 * one_third


def valset_sign_bytes(nonce: int, members) -> bytes:
    """ref: valset.go:32 Valset.SignBytes — what orchestrators sign when
    the validator set changes."""
    encoded = (
        _word_bytes32(VS_DOMAIN_SEPARATOR)
        + _word_uint(nonce)
        + _word_uint(two_thirds_threshold(members))
        + _word_bytes32(validator_set_hash(members))
    )
    return keccak256(encoded)


# --------------------------------------------------------------------- #
# data-root tuple roots (celestia-core DataCommitment analogue)


def encode_data_root_tuple(height: int, data_root: bytes) -> bytes:
    """abi.encode(uint256 height, bytes32 dataRoot) — 64 bytes
    (DataRootTuple.sol; verify.go:318)."""
    return _word_uint(height) + _word_bytes32(data_root)


def data_root_tuple_root(tuples: list[bytes]) -> bytes:
    """RFC-6962 merkle root over encoded tuples (celestia-core
    rpc/core/blocks.go DataCommitment; x/blobstream/README.md:110)."""
    from celestia_tpu_torch.ops.nmt_host import merkle_root

    return merkle_root(tuples)


def data_commitment_sign_bytes(nonce: int, tuple_root: bytes) -> bytes:
    """ref: abi_consts.go domainSeparateDataRootTupleRoot — what
    orchestrators sign over a data commitment attestation."""
    encoded = (
        _word_bytes32(DC_DOMAIN_SEPARATOR)
        + _word_uint(nonce)
        + _word_bytes32(tuple_root)
    )
    return keccak256(encoded)


# --------------------------------------------------------------------- #
# data-root inclusion proofs (tendermint merkle, proven client-side)


@dataclasses.dataclass
class DataRootInclusionProof:
    """Merkle proof that block `height`'s (height, dataRoot) tuple is a
    leaf of a data commitment's tuple root (trpc.DataRootInclusionProof
    analogue; verified by the Blobstream contract's verifyAttestation).

    Aunts are ordered deepest-first (leaf sibling first) — the standard
    tendermint merkle.Proof wire order, so the list can be fed directly as
    the contract's BinaryMerkleProof sideNodes."""

    height: int
    data_root: bytes
    index: int
    total: int
    aunts: list[bytes]

    def verify(self, tuple_root: bytes) -> bool:
        from celestia_tpu_torch.proof import MerkleProof

        mp = MerkleProof(
            total=self.total,
            index=self.index,
            leaf_hash=_leaf_hash(
                encode_data_root_tuple(self.height, self.data_root)
            ),
            aunts=self.aunts,
        )
        try:
            mp.verify(tuple_root, encode_data_root_tuple(self.height, self.data_root))
        except ValueError:
            return False
        return True

    def to_json(self) -> dict:
        return {
            "height": self.height,
            "data_root": self.data_root.hex(),
            "index": self.index,
            "total": self.total,
            "aunts": [a.hex() for a in self.aunts],
        }

    @classmethod
    def from_json(cls, d: dict) -> "DataRootInclusionProof":
        return cls(
            height=d["height"],
            data_root=bytes.fromhex(d["data_root"]),
            index=d["index"],
            total=d["total"],
            aunts=[bytes.fromhex(a) for a in d["aunts"]],
        )


def _leaf_hash(leaf: bytes) -> bytes:
    from celestia_tpu_torch.ops.nmt_host import merkle_leaf_hash

    return merkle_leaf_hash(leaf)


def prove_data_root_inclusion_with_root(
    heights: list[int], data_roots: list[bytes], target_height: int
) -> tuple[bytes, DataRootInclusionProof]:
    """(tuple_root, inclusion proof) for target_height over the aligned
    heights/data_roots range — one tree pass via proof.merkle_proofs."""
    if target_height not in heights:
        raise ValueError(f"height {target_height} not in commitment range")
    index = heights.index(target_height)
    tuples = [
        encode_data_root_tuple(h, r) for h, r in zip(heights, data_roots)
    ]
    from celestia_tpu_torch.proof import merkle_proofs

    root, proofs = merkle_proofs(tuples)
    proof = DataRootInclusionProof(
        height=target_height,
        data_root=data_roots[index],
        index=index,
        total=len(tuples),
        aunts=proofs[index].aunts,
    )
    return root, proof


def prove_data_root_inclusion(
    heights: list[int], data_roots: list[bytes], target_height: int
) -> DataRootInclusionProof:
    return prove_data_root_inclusion_with_root(heights, data_roots, target_height)[1]
