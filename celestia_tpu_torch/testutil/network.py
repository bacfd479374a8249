"""Multi-validator network simulation (port of the JAX package's
testutil/network.py) — the in-process e2e harness.

Reference semantics: test/e2e (knuu testnet: N validators, genesis
ceremony, txsim, per-block app-version assertions). Real networking is
celestia-core's job (SURVEY §1 L0); what the app layer must guarantee —
and what this harness exercises — is N replicas staying in perfect
agreement: proposers rotating by voting power, every validator voting
via ProcessProposal, 2/3+ acceptance to commit, and identical app/data
hashes afterward.

Two modes:
- **headcount** (default, no validator keys): one vote per replica,
  round-robin proposers — the lightweight substrate most tests use.
- **stake-weighted** (`validator_keys` given): replica i is operator i;
  votes carry the staking keeper's live power and the proposer follows
  `proposer_rotation`. The economic feedback runs exactly as in the
  reference: a > 1/3-power validator going OFFLINE (vote withheld, see
  `self.offline`) halts `produce_block` with ConsensusFailure because
  no proposal reaches > 2/3 of bonded power; jailing/slashing the
  offline validator is the RECOVERY — it shrinks the bonded set so the
  remaining power clears quorum again. The multi-process equivalent
  lives in node/devnet.py over real HTTP.
"""

from __future__ import annotations

import dataclasses

from celestia_tpu_torch.app import App
from celestia_tpu_torch.app.app import ProposalBlockData
from celestia_tpu_torch.node.consensus import (
    consensus_valset,
    meets_quorum,
    proposer_rotation,
    total_power,
)


class ConsensusFailure(Exception):
    pass


@dataclasses.dataclass
class CommittedBlock:
    height: int
    proposer: int
    block: ProposalBlockData
    app_hash: bytes
    accept_votes: int  # headcount mode: replicas; stake mode: power


class Network:
    """N validator replicas of the state machine."""

    def __init__(self, n_validators: int, genesis_accounts: dict[str, int],
                 make_app=None, genesis_time: float = 0.0,
                 validator_keys=None,
                 validator_tokens: int | list[int] = 10_000_000):
        make_app = make_app or (lambda i: App())
        self.keys = list(validator_keys) if validator_keys else []
        if self.keys and len(self.keys) != n_validators:
            raise ValueError("need one key per validator")
        tokens = (
            validator_tokens
            if isinstance(validator_tokens, list)
            else [validator_tokens] * len(self.keys)
        )
        if len(tokens) != len(self.keys):
            raise ValueError("need one token amount per validator key")
        self.operators = [k.bech32_address() for k in self.keys]
        # replicas whose votes are withheld (crashed/partitioned
        # validator: the state machine stays lockstep, the vote is lost)
        self.offline: set[int] = set()
        self.apps: list[App] = []
        for i in range(n_validators):
            app = make_app(i)
            app.init_chain(dict(genesis_accounts), genesis_time=genesis_time)
            # stake-weighted mode: bond the SAME validator set into every
            # replica (identical state → identical app hashes)
            for key, amount in zip(self.keys, tokens):
                operator = key.bech32_address()
                app.accounts.get_or_create(operator)
                app.bank.mint(operator, amount)
                app.staking.delegate(None, operator, operator, amount)
                v = app.staking.get_validator(operator)
                v.pubkey = key.public_key().hex()
                app.staking.set_validator(v)
            app.store.commit_hash_refresh()
            self.apps.append(app)
        self.committed: list[CommittedBlock] = []

    @property
    def height(self) -> int:
        return self.apps[0].height

    def produce_block(self, mempool_txs: list[bytes] | None = None,
                      proposer: int | None = None) -> CommittedBlock:
        """One consensus round: propose -> vote -> (2/3+) -> commit."""
        n = len(self.apps)
        if self.keys:
            return self._produce_stake_weighted(mempool_txs, proposer)
        proposer = proposer if proposer is not None else self.height % n
        proposal = self.apps[proposer].prepare_proposal(mempool_txs or [])

        votes = sum(
            1 for i, app in enumerate(self.apps) if app.process_proposal(proposal)
        )
        if votes * 3 < n * 2:
            raise ConsensusFailure(
                f"proposal at height {self.height + 1} got {votes}/{n} votes"
            )

        return self._apply_everywhere(proposal, proposer, votes)

    def _produce_stake_weighted(self, mempool_txs, proposer_idx=None):
        """Stake-weighted round: votes carry live staking power, the
        leader follows the power rotation, jailed power cannot vote."""
        height = self.height + 1
        valset = consensus_valset(self.apps[0].staking)
        total = total_power(valset)
        if total <= 0:
            raise ConsensusFailure("no bonded voting power")
        if proposer_idx is None:
            leader = proposer_rotation(valset, height)
            proposer_idx = self.operators.index(leader)
        elif self.operators[proposer_idx] not in {v.operator for v in valset}:
            raise ConsensusFailure(
                f"proposer {proposer_idx} is not in the bonded valset"
            )
        proposal = self.apps[proposer_idx].prepare_proposal(mempool_txs or [])

        power_of = {v.operator: v.power for v in valset}
        accepted = sum(
            power_of.get(self.operators[i], 0)
            for i, app in enumerate(self.apps)
            if i not in self.offline and app.process_proposal(proposal)
        )
        if not meets_quorum(accepted, total):
            raise ConsensusFailure(
                f"proposal at height {height} carries {accepted}/{total} "
                "power (need > 2/3)"
            )
        return self._apply_everywhere(proposal, proposer_idx, accepted)

    def _apply_everywhere(self, proposal, proposer: int,
                          votes: int) -> CommittedBlock:
        app_hashes = set()
        data_time = self.apps[0].block_time + 15.0
        for app in self.apps:
            app.begin_block(data_time)
            for tx in proposal.txs:
                app.deliver_tx(tx)
            app.end_block()
            app_hashes.add(app.commit())
        if len(app_hashes) != 1:
            raise ConsensusFailure(f"state divergence: {len(app_hashes)} app hashes")

        block = CommittedBlock(
            height=self.height,
            proposer=proposer,
            block=proposal,
            app_hash=app_hashes.pop(),
            accept_votes=votes,
        )
        self.committed.append(block)
        return block

    # --- stake-weighted-mode state drivers (applied identically on
    # every replica so hashes stay equal) ---

    def jail(self, index: int) -> None:
        for app in self.apps:
            app.staking.jail(None, self.operators[index])
            app.store.commit_hash_refresh()

    def unjail(self, index: int) -> None:
        for app in self.apps:
            app.staking.unjail(None, self.operators[index])
            app.store.commit_hash_refresh()

    def slash(self, index: int, fraction_dec: int) -> None:
        """Burn a fraction (Dec-scaled 1e18) of a validator's stake on
        every replica — the downtime/equivocation slashing response."""
        for app in self.apps:
            app.staking.slash(None, self.operators[index], fraction_dec)
            app.store.commit_hash_refresh()
