"""Stake-weighted BFT commit layer for the devnet (port of the JAX package's
node/consensus.py: pure host code over ``crypto.verify_signature``).

The reference delegates consensus to celestia-core (CometBFT); the app
ships semantics through ABCI (SURVEY §1 L0). This module is the
framework's L0 substitute for multi-process operation
(test/util/testnode/full_node.go:70's role): a deterministic,
single-round, leader-driven commit protocol with tendermint's economic
structure —

- **proposer rotation by voting power** (`proposer_rotation`): the
  tendermint proposer-priority algorithm (priority += power each round,
  proposer = max priority, proposer -= total) run as a pure function of
  (valset, height), so every replica picks the same leader with a
  long-run frequency proportional to stake and no consensus state to
  merkleize.
- **signed votes** (`Vote`): each validator's consensus key signs the
  canonical (chain_id, height, proposal hash, accept) bytes.
- **commit certificates** (`CommitCert`): a proposal commits only with
  valid signatures carrying > 2/3 of the bonded voting power —
  stake-weighted, so a jailed or slashed >1/3 validator halts the
  chain until power recovers (the economic property the lockstep
  unanimity harness could not express).

One round, no locking/evidence rounds: on a devnet every replica is
honest-but-crashable; safety comes from the 2/3 power gate and the
app-hash cross-check at commit, liveness from the proposer retrying.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading

from celestia_tpu_torch.crypto import verify_signature

TRUST_NUMERATOR = 2
TRUST_DENOMINATOR = 3


@dataclasses.dataclass
class ConsensusValidator:
    """A bonded validator as the vote tally sees it."""

    operator: str
    pubkey: str  # hex compressed secp256k1 (consensus key)
    power: int

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "ConsensusValidator":
        return cls(d["operator"], d["pubkey"], int(d["power"]))


def consensus_valset(staking) -> list["ConsensusValidator"]:
    """The signing valset: bonded validators that registered a consensus
    pubkey, in the staking keeper's deterministic order."""
    return [
        ConsensusValidator(v.operator, v.pubkey, v.power)
        for v in staking.bonded_validators()
        if v.pubkey
    ]


def total_power(valset: list[ConsensusValidator]) -> int:
    return sum(v.power for v in valset)


# rotation memo: valset signature -> [advanced_height, prio dict, proposer]
# (leader loops call proposer_rotation every tick; without the memo the
# zero-state replay is O(height · n) per call and grows forever). The
# lock serializes advancement: RPC handler threads and the leader loop
# share the cached priority dict.
_ROTATION_CACHE: dict[tuple, list] = {}
_ROTATION_CACHE_MAX = 8
_ROTATION_LOCK = threading.Lock()


def proposer_rotation(valset: list[ConsensusValidator], height: int) -> str:
    """Tendermint's proposer-priority rotation as a pure function.

    Replays the priority algorithm from a zeroed state for `height`
    rounds over the CURRENT valset. Deterministic across replicas (same
    committed valset → same leader) and stake-proportional in the long
    run. Incremental per valset (the replay position is memoized, so a
    leader tick at height H costs O(n), not O(H · n)). Divergence from
    tendermint: priorities reset when the valset changes (pure function
    of the present set) instead of carrying over — acceptable because
    fairness here is per-valset-epoch, not across epochs."""
    if not valset:
        raise ValueError("empty validator set")
    total = total_power(valset)
    if total <= 0:
        raise ValueError("validator set has no power")
    key = tuple((v.operator, v.power) for v in valset)
    with _ROTATION_LOCK:
        state = _ROTATION_CACHE.get(key)
        if state is None or state[0] > height:
            state = [-1, {v.operator: 0 for v in valset}, valset[0].operator]
        at, prio, proposer = state[0], state[1], state[2]
        while at < height:
            for v in valset:
                prio[v.operator] += v.power
            # max priority; ties break on operator address for determinism
            proposer = max(
                valset, key=lambda v: (prio[v.operator], v.operator)
            ).operator
            prio[proposer] -= total
            at += 1
        if len(_ROTATION_CACHE) >= _ROTATION_CACHE_MAX and key not in _ROTATION_CACHE:
            _ROTATION_CACHE.pop(next(iter(_ROTATION_CACHE)))
        _ROTATION_CACHE[key] = [at, prio, proposer]
        return proposer


def proposal_hash(
    chain_id: str,
    height: int,
    block_time: float,
    proposer: str,
    data_hash: bytes,
    square_size: int,
    txs: list[bytes],
) -> bytes:
    """Canonical digest of everything a vote endorses. Votes sign this,
    so two proposals differing in any field produce disjoint votes."""
    txs_digest = hashlib.sha256(
        b"".join(hashlib.sha256(t).digest() for t in txs)
    ).digest()
    payload = json.dumps(
        {
            "chain_id": chain_id,
            "height": height,
            "time": block_time,
            "proposer": proposer,
            "data_hash": data_hash.hex(),
            "square_size": square_size,
            "txs": txs_digest.hex(),
        },
        sort_keys=True,
        separators=(",", ":"),
    ).encode()
    return hashlib.sha256(payload).digest()


def vote_sign_bytes(chain_id: str, height: int, prop_hash: bytes,
                    accept: bool, round_: int = 0) -> bytes:
    """Canonical vote payload. The ROUND is part of what a validator
    signs (tendermint's Vote{Height, Round, BlockID}): an honest
    validator signs at most one proposal per (height, round) — re-voting
    after a leader crash happens in a HIGHER round — so two signed
    accepts for different proposals at one (height, round) are
    unambiguous equivocation, never the crash-fault re-vote path."""
    return json.dumps(
        {
            "chain_id": chain_id,
            "height": height,
            "round": round_,
            "proposal": prop_hash.hex(),
            "accept": accept,
        },
        sort_keys=True,
        separators=(",", ":"),
    ).encode()


@dataclasses.dataclass
class Vote:
    operator: str
    accept: bool
    signature: str  # hex, over vote_sign_bytes
    round: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "Vote":
        return cls(
            d["operator"], bool(d["accept"]), d["signature"],
            int(d.get("round", 0)),
        )


def make_vote(key, operator: str, chain_id: str, height: int,
              prop_hash: bytes, accept: bool, round_: int = 0) -> Vote:
    sig = key.sign(vote_sign_bytes(chain_id, height, prop_hash, accept, round_))
    return Vote(operator, accept, sig.hex(), round_)


@dataclasses.dataclass
class CommitCert:
    """Proof that > 2/3 of bonded power accepted a proposal."""

    height: int
    prop_hash: bytes
    votes: list[Vote]
    round: int = 0

    def to_json(self) -> dict:
        return {
            "height": self.height,
            "prop_hash": self.prop_hash.hex(),
            "round": self.round,
            "votes": [v.to_json() for v in self.votes],
        }

    @classmethod
    def from_json(cls, d: dict) -> "CommitCert":
        return cls(
            height=int(d["height"]),
            prop_hash=bytes.fromhex(d["prop_hash"]),
            votes=[Vote.from_json(v) for v in d["votes"]],
            round=int(d.get("round", 0)),
        )


@dataclasses.dataclass
class VoteEvidence:
    """Raw, independently-verifiable equivocation: two validly-signed
    ACCEPT votes by one validator for two DIFFERENT proposals at one
    (height, ROUND) — CometBFT's DuplicateVoteEvidence shape; the
    reference routes it into its evidence keeper (app/app.go:387-392).

    The round is what separates equivocation from the honest crash-fault
    re-vote: a validator that re-votes after a leader stall does so in a
    HIGHER round, so only same-round conflicts are slashable.

    Anyone holding both votes can construct this; verification needs
    only the bonded valset (the pubkeys) — no trust in the reporter."""

    operator: str
    height: int
    round: int
    prop_hash_a: bytes
    sig_a: str  # over vote_sign_bytes(chain, height, prop_hash_a, True, round)
    prop_hash_b: bytes
    sig_b: str

    def key(self) -> tuple[str, int, int]:
        return (self.operator, self.height, self.round)

    def to_json(self) -> dict:
        return {
            "operator": self.operator,
            "height": self.height,
            "round": self.round,
            "prop_hash_a": self.prop_hash_a.hex(),
            "sig_a": self.sig_a,
            "prop_hash_b": self.prop_hash_b.hex(),
            "sig_b": self.sig_b,
        }

    @classmethod
    def from_json(cls, d: dict) -> "VoteEvidence":
        return cls(
            operator=d["operator"],
            height=int(d["height"]),
            round=int(d.get("round", 0)),
            prop_hash_a=bytes.fromhex(d["prop_hash_a"]),
            sig_a=d["sig_a"],
            prop_hash_b=bytes.fromhex(d["prop_hash_b"]),
            sig_b=d["sig_b"],
        )


def verify_vote_evidence(
    valset: list[ConsensusValidator], chain_id: str, ev: VoteEvidence
) -> int:
    """Raise unless the evidence proves equivocation by a CURRENT bonded
    validator; returns the validator's power (for the Equivocation
    record). Deterministic given (valset, evidence) — every replica
    reaches the same verdict, so evidence handling cannot fork state."""
    if ev.prop_hash_a == ev.prop_hash_b:
        raise ValueError("votes endorse the same proposal — no conflict")
    v = next((v for v in valset if v.operator == ev.operator), None)
    if v is None:
        raise ValueError(f"{ev.operator} is not a bonded validator")
    pubkey = bytes.fromhex(v.pubkey)
    for ph, sig in ((ev.prop_hash_a, ev.sig_a), (ev.prop_hash_b, ev.sig_b)):
        if not verify_signature(
            pubkey,
            vote_sign_bytes(chain_id, ev.height, ph, True, ev.round),
            bytes.fromhex(sig),
        ):
            raise ValueError("evidence signature does not verify")
    return v.power


def tally(valset: list[ConsensusValidator], chain_id: str, height: int,
          prop_hash: bytes, votes: list[Vote], round_: int = 0) -> int:
    """Accepting power carried by valid, de-duplicated votes from the
    valset for (height, round_, prop_hash). Invalid/unknown/duplicate
    entries — including votes signed for a different round — contribute
    nothing (the sign bytes bind the round)."""
    power_of = {v.operator: v.power for v in valset}
    pubkey_of = {v.operator: v.pubkey for v in valset}
    seen: set[str] = set()
    accepted = 0
    for vote in votes:
        if vote.operator in seen or vote.operator not in power_of:
            continue
        if not vote.accept:
            continue
        if not verify_signature(
            bytes.fromhex(pubkey_of[vote.operator]),
            vote_sign_bytes(chain_id, height, prop_hash, vote.accept, round_),
            bytes.fromhex(vote.signature),
        ):
            continue
        seen.add(vote.operator)
        accepted += power_of[vote.operator]
    return accepted


def meets_quorum(accepted: int, total: int) -> bool:
    """STRICTLY more than 2/3 of total power — the single place the
    trust fraction lives (leaders, verifiers, and harnesses must agree
    on the threshold or leaders mint certificates peers reject)."""
    return accepted * TRUST_DENOMINATOR > total * TRUST_NUMERATOR


def verify_commit_cert(
    valset: list[ConsensusValidator], chain_id: str, cert: CommitCert
) -> None:
    """Raise unless the certificate carries > 2/3 of the valset power."""
    total = total_power(valset)
    if total <= 0:
        raise ValueError("validator set has no power")
    accepted = tally(
        valset, chain_id, cert.height, cert.prop_hash, cert.votes, cert.round
    )
    if not meets_quorum(accepted, total):
        raise ValueError(
            f"commit certificate carries {accepted}/{total} power "
            f"(need > {TRUST_NUMERATOR}/{TRUST_DENOMINATOR})"
        )
