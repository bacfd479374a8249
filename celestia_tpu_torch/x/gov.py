"""x/gov — parameter-change governance with the paramfilter handler.

Reference semantics: the stock SDK gov module wired at app/app.go:363-369
with Celestia's custom genesis (app/default_overrides.go:174-185 —
MinDeposit 10,000 TIA = 10_000_000_000 utia, one-week deposit and voting
periods) and ParameterChangeProposals routed through the paramfilter
wrapper (x/paramfilter/gov_handler.go:16-40): a proposal touching a
hard-fork-only parameter FAILS at execution.

Deviations from the SDK, kept deliberate and documented:
- Voting weight is the voter's own bonded delegations (sum over
  validators). The SDK's validator-inherited voting (validators vote
  with undirected delegations) is not modelled.
- Proposal content is restricted to ParameterChangeProposal — the only
  gov content type the reference chain's own modules act on.
"""

from __future__ import annotations

import dataclasses
import json

from celestia_tpu_torch.blob import _field_bytes, _field_uint, _parse_fields, _require_wt
from celestia_tpu_torch.tx import register_msg
from celestia_tpu_torch.x.paramfilter import ParamChange

GOV_MODULE_ACCOUNT = "gov"

# ref: app/default_overrides.go:180-182
MIN_DEPOSIT = 10_000_000_000  # 10,000 TIA in utia
MAX_DEPOSIT_PERIOD = 7 * 24 * 3600  # one week, seconds
VOTING_PERIOD = 7 * 24 * 3600

# SDK default tally params (x/gov/types/v1 params)
ONE = 10**18
QUORUM = 334 * 10**15  # 0.334
THRESHOLD = 500 * 10**15  # 0.5
VETO_THRESHOLD = 334 * 10**15  # 0.334

PROPOSAL_PREFIX = b"gov/proposal/"
NEXT_ID_KEY = b"gov/nextProposalId"

STATUS_DEPOSIT = "deposit_period"
STATUS_VOTING = "voting_period"
STATUS_PASSED = "passed"
STATUS_REJECTED = "rejected"
STATUS_FAILED = "failed"  # passed the vote but the handler errored

OPTION_YES = "yes"
OPTION_NO = "no"
OPTION_ABSTAIN = "abstain"
OPTION_VETO = "no_with_veto"
_OPTIONS = {OPTION_YES, OPTION_NO, OPTION_ABSTAIN, OPTION_VETO}


@dataclasses.dataclass
class Proposal:
    id: int
    proposer: str
    changes: list[dict]  # [{subspace, key, value}]
    deposit: int
    status: str
    submit_time: float
    deposit_end_time: float
    voting_end_time: float = 0.0
    votes: dict = dataclasses.field(default_factory=dict)  # voter -> option
    depositors: dict = dataclasses.field(default_factory=dict)  # addr -> amount
    tally: dict = dataclasses.field(default_factory=dict)
    fail_log: str = ""

    def marshal(self) -> bytes:
        return json.dumps(dataclasses.asdict(self), sort_keys=True).encode()

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Proposal":
        return cls(**json.loads(raw))

    def param_changes(self) -> list[ParamChange]:
        return [ParamChange(**c) for c in self.changes]


class GovKeeper:
    def __init__(self, store, bank, staking):
        self.store = store
        self.bank = bank
        self.staking = staking

    # --- state ---

    def get_proposal(self, proposal_id: int) -> Proposal | None:
        raw = self.store.get(PROPOSAL_PREFIX + b"%016d" % proposal_id)
        return Proposal.unmarshal(raw) if raw else None

    def set_proposal(self, p: Proposal) -> None:
        self.store.set(PROPOSAL_PREFIX + b"%016d" % p.id, p.marshal())

    def proposals(self) -> list[Proposal]:
        return [
            Proposal.unmarshal(raw)
            for _k, raw in self.store.iter_prefix(PROPOSAL_PREFIX)
        ]

    def _next_id(self) -> int:
        raw = self.store.get(NEXT_ID_KEY)
        nid = int.from_bytes(raw, "big") if raw else 1
        self.store.set(NEXT_ID_KEY, (nid + 1).to_bytes(8, "big"))
        return nid

    # --- msg handlers ---

    def submit_proposal(self, ctx, proposer: str, changes: list[ParamChange],
                        initial_deposit: int) -> int:
        if not changes:
            # ref: app/ante/gov.go GovProposalDecorator — proposals must
            # carry at least one message/change
            raise ValueError("proposal has no parameter changes")
        if initial_deposit > 0:
            self.bank.send(proposer, GOV_MODULE_ACCOUNT, initial_deposit)
        p = Proposal(
            id=self._next_id(),
            proposer=proposer,
            changes=[dataclasses.asdict(c) for c in changes],
            deposit=initial_deposit,
            status=STATUS_DEPOSIT,
            submit_time=ctx.block_time,
            deposit_end_time=ctx.block_time + MAX_DEPOSIT_PERIOD,
            depositors={proposer: initial_deposit} if initial_deposit else {},
        )
        self._maybe_activate(ctx, p)
        self.set_proposal(p)
        return p.id

    def deposit(self, ctx, proposal_id: int, depositor: str, amount: int) -> None:
        p = self.get_proposal(proposal_id)
        if p is None:
            raise ValueError(f"unknown proposal {proposal_id}")
        if p.status not in (STATUS_DEPOSIT, STATUS_VOTING):
            raise ValueError(f"proposal {proposal_id} not accepting deposits")
        self.bank.send(depositor, GOV_MODULE_ACCOUNT, amount)
        p.deposit += amount
        p.depositors[depositor] = p.depositors.get(depositor, 0) + amount
        self._maybe_activate(ctx, p)
        self.set_proposal(p)

    def vote(self, ctx, proposal_id: int, voter: str, option: str) -> None:
        p = self.get_proposal(proposal_id)
        if p is None:
            raise ValueError(f"unknown proposal {proposal_id}")
        if p.status != STATUS_VOTING:
            raise ValueError(f"proposal {proposal_id} not in voting period")
        if option not in _OPTIONS:
            raise ValueError(f"invalid vote option {option!r}")
        if not self.staking.delegations_of(voter):
            raise ValueError(f"{voter} has no bonded stake to vote with")
        p.votes[voter] = option
        self.set_proposal(p)

    def _maybe_activate(self, ctx, p: Proposal) -> None:
        if p.status == STATUS_DEPOSIT and p.deposit >= MIN_DEPOSIT:
            p.status = STATUS_VOTING
            p.voting_end_time = ctx.block_time + VOTING_PERIOD

    # --- end blocker ---

    def end_blocker(self, ctx, apply_changes) -> list[Proposal]:
        """Close expired deposit periods and tally finished votes.

        apply_changes(changes) is the gov route's handler — the
        paramfilter-wrapped params keeper (x/paramfilter/gov_handler.go).
        Returns proposals whose state changed this block."""
        changed = []
        for p in self.proposals():
            if p.status == STATUS_DEPOSIT and ctx.block_time >= p.deposit_end_time:
                # deposit period expired: burn the deposit (SDK behavior)
                self.bank.burn(GOV_MODULE_ACCOUNT, p.deposit)
                p.status = STATUS_REJECTED
                p.fail_log = "deposit period expired"
                self.set_proposal(p)
                changed.append(p)
            elif p.status == STATUS_VOTING and ctx.block_time >= p.voting_end_time:
                self._finish_voting(ctx, p, apply_changes)
                self.set_proposal(p)
                changed.append(p)
        return changed

    def _voting_power(self, voter: str) -> int:
        """Stake delegated to ACTIVE (bonded, non-jailed) validators only —
        the same set total_bonded is computed over, so quorum can never
        exceed 100%."""
        bonded = {v.operator for v in self.staking.bonded_validators()}
        return sum(
            tokens
            for val, tokens in self.staking.delegations_of(voter).items()
            if val in bonded
        )

    def _finish_voting(self, ctx, p: Proposal, apply_changes) -> None:
        total_bonded = sum(
            v.tokens for v in self.staking.bonded_validators()
        )
        counts = {o: 0 for o in _OPTIONS}
        for voter, option in p.votes.items():
            counts[option] += self._voting_power(voter)
        voted = sum(counts.values())
        p.tally = dict(counts, voted=voted, total_bonded=total_bonded)

        def refund():
            # per-depositor refunds (SDK RefundDeposits)
            for addr, amount in sorted(p.depositors.items()):
                self.bank.send(GOV_MODULE_ACCOUNT, addr, amount)

        if total_bonded == 0 or voted * ONE < total_bonded * QUORUM:
            p.status = STATUS_REJECTED
            p.fail_log = "quorum not reached"
            refund()
            return
        if voted > 0 and counts[OPTION_VETO] * ONE >= voted * VETO_THRESHOLD:
            p.status = STATUS_REJECTED
            p.fail_log = "vetoed"
            self.bank.burn(GOV_MODULE_ACCOUNT, p.deposit)
            return
        non_abstain = voted - counts[OPTION_ABSTAIN]
        if non_abstain == 0 or counts[OPTION_YES] * ONE <= non_abstain * THRESHOLD:
            p.status = STATUS_REJECTED
            p.fail_log = "threshold not reached"
            refund()
            return
        try:
            apply_changes(p.param_changes())
            p.status = STATUS_PASSED
        except Exception as e:  # noqa: BLE001 — handler rejection fails the proposal
            p.status = STATUS_FAILED
            p.fail_log = str(e)
        refund()


# --------------------------------------------------------------------- #
# messages

URL_MSG_SUBMIT_PROPOSAL = "/cosmos.gov.v1beta1.MsgSubmitProposal"
URL_MSG_DEPOSIT = "/cosmos.gov.v1beta1.MsgDeposit"
URL_MSG_VOTE = "/cosmos.gov.v1beta1.MsgVote"


def _change_bytes(c: ParamChange) -> bytes:
    return (
        _field_bytes(1, c.subspace.encode())
        + _field_bytes(2, c.key.encode())
        + _field_bytes(3, c.value.encode())
    )


def _parse_change(raw: bytes) -> ParamChange:
    c = ParamChange("", "", "")
    for tag, wt, val in _parse_fields(raw):
        _require_wt(wt, 2, tag)
        if tag == 1:
            c.subspace = bytes(val).decode()
        elif tag == 2:
            c.key = bytes(val).decode()
        elif tag == 3:
            c.value = bytes(val).decode()
    return c


@register_msg(URL_MSG_SUBMIT_PROPOSAL)
@dataclasses.dataclass
class MsgSubmitProposal:
    proposer: str
    changes: list[ParamChange]
    initial_deposit: int = 0

    def get_signers(self) -> list[str]:
        return [self.proposer]

    def validate_basic(self) -> None:
        if not self.changes:
            raise ValueError("proposal has no parameter changes")
        if self.initial_deposit < 0:
            raise ValueError("negative deposit")

    def marshal(self) -> bytes:
        out = _field_bytes(1, self.proposer.encode())
        for c in self.changes:
            out += _field_bytes(2, _change_bytes(c))
        if self.initial_deposit:
            out += _field_uint(3, self.initial_deposit)
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgSubmitProposal":
        m = cls("", [], 0)
        for tag, wt, val in _parse_fields(raw):
            if tag == 1:
                _require_wt(wt, 2, tag)
                m.proposer = bytes(val).decode()
            elif tag == 2:
                _require_wt(wt, 2, tag)
                m.changes.append(_parse_change(bytes(val)))
            elif tag == 3:
                _require_wt(wt, 0, tag)
                m.initial_deposit = int(val)
        return m


@register_msg(URL_MSG_DEPOSIT)
@dataclasses.dataclass
class MsgDeposit:
    proposal_id: int
    depositor: str
    amount: int

    def get_signers(self) -> list[str]:
        return [self.depositor]

    def validate_basic(self) -> None:
        if self.amount <= 0:
            raise ValueError("deposit must be positive")

    def marshal(self) -> bytes:
        return (
            _field_uint(1, self.proposal_id)
            + _field_bytes(2, self.depositor.encode())
            + _field_uint(3, self.amount)
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgDeposit":
        m = cls(0, "", 0)
        for tag, wt, val in _parse_fields(raw):
            if tag == 1:
                _require_wt(wt, 0, tag)
                m.proposal_id = int(val)
            elif tag == 2:
                _require_wt(wt, 2, tag)
                m.depositor = bytes(val).decode()
            elif tag == 3:
                _require_wt(wt, 0, tag)
                m.amount = int(val)
        return m


@register_msg(URL_MSG_VOTE)
@dataclasses.dataclass
class MsgVote:
    proposal_id: int
    voter: str
    option: str

    def get_signers(self) -> list[str]:
        return [self.voter]

    def validate_basic(self) -> None:
        if self.option not in _OPTIONS:
            raise ValueError(f"invalid vote option {self.option!r}")

    def marshal(self) -> bytes:
        return (
            _field_uint(1, self.proposal_id)
            + _field_bytes(2, self.voter.encode())
            + _field_bytes(3, self.option.encode())
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgVote":
        m = cls(0, "", "")
        for tag, wt, val in _parse_fields(raw):
            if tag == 1:
                _require_wt(wt, 0, tag)
                m.proposal_id = int(val)
            elif tag == 2:
                _require_wt(wt, 2, tag)
                m.voter = bytes(val).decode()
            elif tag == 3:
                _require_wt(wt, 2, tag)
                m.option = bytes(val).decode()
        return m
