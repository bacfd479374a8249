"""Bad Encoding Fraud Proofs (BEFP) — provable invalid erasure coding.

The DA security model's last line of defence (reference:
specs/src/specs/fraud_proofs.md): if a malicious proposer commits a
DataAvailabilityHeader whose extended square does NOT satisfy the
Reed-Solomon code, any full node that reconstructs the bad axis can
produce a compact proof that convinces a light node to reject the block
— without the light node downloading the square.

Shape (celestia's BEFP): the bad axis's 2k shares, each with an NMT
inclusion proof against the ORTHOGONAL axis roots of the committed DAH
(a bad row is proven with the column trees and vice versa, so the proof
never depends on the corrupted axis's own commitment). The verifier
checks every inclusion proof, re-encodes the first k shares with the
Leopard codec (ops/gf256.leopard_encode — byte-identical to the
reference's rsmt2d codec) and compares against the committed parity:
any mismatch proves the DAH commits to an invalid encoding.

Generation refuses to produce a proof for a well-encoded axis, and
verification is deterministic from (proof, DAH) alone — no trust in the
prover.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from celestia_tpu_torch.appconsts import SHARE_SIZE
from celestia_tpu_torch.da import erasured_axis_leaves, erasured_leaf_namespace
from celestia_tpu_torch.ops import gf256
from celestia_tpu_torch.proof import NmtRangeProof, nmt_prove_range

AXIS_ROW = "row"
AXIS_COL = "col"


class NotFraudulentError(ValueError):
    """The axis satisfies the erasure code — no fraud to prove."""


@dataclasses.dataclass
class BadEncodingFraudProof:
    axis: str  # AXIS_ROW | AXIS_COL
    index: int  # which row/column is mis-encoded
    square_size: int  # k (original width)
    shares: list[bytes]  # the 2k shares of the bad axis
    proofs: list[NmtRangeProof]  # share j proven in orthogonal tree j

    def to_json(self) -> dict:
        return {
            "axis": self.axis,
            "index": self.index,
            "square_size": self.square_size,
            "shares": [s.hex() for s in self.shares],
            "proofs": [
                {
                    "start": p.start,
                    "end": p.end,
                    "nodes": [n.hex() for n in p.nodes],
                    "tree_size": p.tree_size,
                }
                for p in self.proofs
            ],
        }

    @classmethod
    def from_json(cls, d: dict) -> "BadEncodingFraudProof":
        return cls(
            axis=d["axis"],
            index=int(d["index"]),
            square_size=int(d["square_size"]),
            shares=[bytes.fromhex(s) for s in d["shares"]],
            proofs=[
                NmtRangeProof(
                    start=int(p["start"]),
                    end=int(p["end"]),
                    nodes=[bytes.fromhex(n) for n in p["nodes"]],
                    tree_size=int(p["tree_size"]),
                )
                for p in d["proofs"]
            ],
        )

    def marshal(self) -> bytes:
        return json.dumps(self.to_json(), sort_keys=True).encode()

    @classmethod
    def unmarshal(cls, raw: bytes) -> "BadEncodingFraudProof":
        return cls.from_json(json.loads(raw))


def _axis_is_bad(shares: np.ndarray, k: int) -> bool:
    """True when parity != Leopard-encode(data) for this axis."""
    parity = gf256.leopard_encode(shares[:k])
    return not np.array_equal(parity, shares[k:])


def generate_befp(
    eds: np.ndarray, axis: str, index: int
) -> BadEncodingFraudProof:
    """Build a BEFP for axis `index` of a (2k, 2k, 512) EDS.

    The EDS here is the MALICIOUS square (as reconstructed by the full
    node from the committed shares); raises NotFraudulentError when the
    axis actually satisfies the code — an honest node can never produce
    a proof against a valid block."""
    if axis not in (AXIS_ROW, AXIS_COL):
        raise ValueError(f"unknown axis {axis!r}")
    w = eds.shape[0]
    k = w // 2
    line = eds[index, :] if axis == AXIS_ROW else eds[:, index]
    if not _axis_is_bad(line, k):
        raise NotFraudulentError(
            f"{axis} {index} satisfies the erasure code — nothing to prove"
        )

    shares = [line[j].tobytes() for j in range(w)]
    proofs = []
    for j in range(w):
        # share j of the bad axis sits at position `index` of ORTHOGONAL
        # axis j: column j's tree for a bad row, row j's tree for a bad
        # column — the proof must not rest on the corrupted axis itself
        ortho = eds[:, j] if axis == AXIS_ROW else eds[j, :]
        leaves = erasured_axis_leaves(
            [ortho[i].tobytes() for i in range(w)], j, k
        )
        proofs.append(nmt_prove_range(leaves, index, index + 1))
    return BadEncodingFraudProof(
        axis=axis, index=index, square_size=k, shares=shares, proofs=proofs
    )


def verify_befp(proof: BadEncodingFraudProof, dah) -> bool:
    """Check a BEFP against a committed DataAvailabilityHeader.

    Returns True when the proof DEMONSTRATES fraud: every share is
    proven committed (NMT inclusion against the orthogonal axis roots)
    AND the k data shares do not re-encode to the committed parity.
    Raises ValueError on malformed/forged proofs (bad inclusion proof,
    wrong shapes) — a light client treats that as "proof rejected", not
    as evidence either way."""
    k = proof.square_size
    w = 2 * k
    if proof.axis not in (AXIS_ROW, AXIS_COL):
        raise ValueError(f"unknown axis {proof.axis!r}")
    if not (0 <= proof.index < w):
        raise ValueError(f"axis index {proof.index} out of range")
    if len(proof.shares) != w or len(proof.proofs) != w:
        raise ValueError("proof must carry all 2k shares with proofs")
    if len(dah.row_roots) != w or len(dah.column_roots) != w:
        raise ValueError("square size does not match the DAH")
    for s in proof.shares:
        if len(s) != SHARE_SIZE:
            raise ValueError("malformed share in proof")

    ortho_roots = (
        dah.column_roots if proof.axis == AXIS_ROW else dah.row_roots
    )
    for j in range(w):
        p = proof.proofs[j]
        if (p.start, p.end) != (proof.index, proof.index + 1):
            raise ValueError(f"proof {j} covers the wrong leaf range")
        if p.tree_size != w:
            # a forged tree_size (e.g. 0) would otherwise let the range
            # fall outside the tree and the proof return the committed
            # root verbatim, framing an honest block as fraudulent
            raise ValueError(f"proof {j} tree size {p.tree_size} != {w}")
        # leaf namespace per the quadrant rule seen from axis j's tree
        # (the da module's single source of the rule)
        ns = erasured_leaf_namespace(j, proof.index, proof.shares[j], k)
        p.verify_inclusion(ortho_roots[j], [ns], [proof.shares[j]])

    line = np.frombuffer(b"".join(proof.shares), dtype=np.uint8).reshape(
        w, SHARE_SIZE
    )
    return _axis_is_bad(line, k)


def find_befp(eds: np.ndarray) -> BadEncodingFraudProof | None:
    """Scan a reconstructed (2k, 2k, 512) square for a mis-encoded axis
    and prove the first one found (rows first, then columns) — the full
    node's detection entry point after it rebuilds a committed square
    that fails ProcessProposal. Returns None when every axis satisfies
    the code (the divergence was something other than bad encoding)."""
    w = eds.shape[0]
    k = w // 2
    for axis, get in ((AXIS_ROW, lambda i: eds[i, :]),
                      (AXIS_COL, lambda i: eds[:, i])):
        for i in range(w):
            if _axis_is_bad(get(i), k):
                return generate_befp(eds, axis, i)
    return None
