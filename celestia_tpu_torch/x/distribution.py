"""x/distribution — fee and mint-provision distribution to validators.

Reference semantics: the stock SDK distribution module (wired at
app/app.go:209-239): each BeginBlock the previous block's fee-collector
balance (tx fees + the mint module's block provision, x/mint/abci.go mints
to the fee collector) is allocated — community tax first, the rest to
bonded validators proportional to voting power.

Documented simplification vs the SDK: rewards accrue per validator
operator (no per-delegator reward periods / F1 distribution); delegators'
shares accrue to the validator account and withdrawal is by the operator
(MsgWithdrawValidatorRewards). The community pool accumulates the tax and
all rounding dust.
"""

from __future__ import annotations

import dataclasses

from celestia_tpu_torch.x.bank import FEE_COLLECTOR

DISTRIBUTION_MODULE_ACCOUNT = "distribution"
COMMUNITY_POOL_KEY = b"distribution/communityPool"
REWARDS_PREFIX = b"distribution/rewards/"

ONE = 10**18
COMMUNITY_TAX = 20 * 10**15  # 0.02 (SDK default)


class DistributionKeeper:
    def __init__(self, store, bank, staking):
        self.store = store
        self.bank = bank
        self.staking = staking

    # --- state ---

    def outstanding_rewards(self, operator: str) -> int:
        raw = self.store.get(REWARDS_PREFIX + operator.encode())
        return int.from_bytes(raw, "big") if raw else 0

    def _set_rewards(self, operator: str, amount: int) -> None:
        key = REWARDS_PREFIX + operator.encode()
        if amount > 0:
            self.store.set(key, amount.to_bytes(16, "big"))
        else:
            self.store.delete(key)

    def community_pool(self) -> int:
        raw = self.store.get(COMMUNITY_POOL_KEY)
        return int.from_bytes(raw, "big") if raw else 0

    def _add_community_pool(self, amount: int) -> None:
        self.store.set(
            COMMUNITY_POOL_KEY,
            (self.community_pool() + amount).to_bytes(16, "big"),
        )

    # --- begin blocker (ref: x/distribution/abci.go AllocateTokens) ---

    def begin_blocker(self, ctx) -> None:
        fees = self.bank.get_balance(FEE_COLLECTOR)
        if fees <= 0:
            return
        self.bank.send(FEE_COLLECTOR, DISTRIBUTION_MODULE_ACCOUNT, fees)
        tax = fees * COMMUNITY_TAX // ONE
        distributable = fees - tax
        validators = self.staking.bonded_validators()
        total_power = sum(v.power for v in validators)
        allocated = 0
        if total_power > 0:
            for v in validators:
                share = distributable * v.power // total_power
                if share > 0:
                    self._set_rewards(
                        v.operator, self.outstanding_rewards(v.operator) + share
                    )
                    allocated += share
        # community pool gets the tax plus all rounding dust (and the whole
        # amount when there are no bonded validators)
        self._add_community_pool(fees - allocated)

    # --- withdraw (ref: x/distribution MsgWithdraw*) ---

    def withdraw_rewards(self, ctx, operator: str) -> int:
        amount = self.outstanding_rewards(operator)
        if amount <= 0:
            raise ValueError(f"no rewards outstanding for {operator}")
        self._set_rewards(operator, 0)
        self.bank.send(DISTRIBUTION_MODULE_ACCOUNT, operator, amount)
        return amount


URL_MSG_WITHDRAW_REWARDS = "/cosmos.distribution.v1beta1.MsgWithdrawValidatorRewards"


def _register():
    from celestia_tpu_torch.blob import _field_bytes, _parse_fields, _require_wt
    from celestia_tpu_torch.tx import register_msg

    @register_msg(URL_MSG_WITHDRAW_REWARDS)
    @dataclasses.dataclass
    class MsgWithdrawValidatorRewards:
        validator_address: str

        def get_signers(self) -> list[str]:
            return [self.validator_address]

        def marshal(self) -> bytes:
            return _field_bytes(1, self.validator_address.encode())

        @classmethod
        def unmarshal(cls, raw: bytes) -> "MsgWithdrawValidatorRewards":
            m = cls("")
            for tag, wt, val in _parse_fields(raw):
                if tag == 1:
                    _require_wt(wt, 2, tag)
                    m.validator_address = bytes(val).decode()
            return m

    return MsgWithdrawValidatorRewards


MsgWithdrawValidatorRewards = _register()
