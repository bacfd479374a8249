"""x/bank analogue: balances + MsgSend + module accounts.

Reference: stock SDK bank module wired with BondDenom=utia
(app/default_overrides.go). Supports the send path used by txsim and fee
deduction from the ante chain.
"""

from __future__ import annotations

import dataclasses

from celestia_tpu_torch.appconsts import BOND_DENOM
from celestia_tpu_torch.blob import _field_bytes, _parse_fields, _require_wt, read_uvarint, uvarint
from celestia_tpu_torch.tx import register_msg

BALANCE_PREFIX = b"bank/balance/"
SUPPLY_KEY = b"bank/supply/"
# consensus block time, written by InitChain/BeginBlock — lets the bank
# evaluate vesting locks without threading a ctx through every call
BLOCK_TIME_KEY = b"ctx/blockTime"

FEE_COLLECTOR = "fee_collector"
MINT_MODULE = "mint"
BONDED_POOL = "bonded_tokens_pool"
NOT_BONDED_POOL = "not_bonded_tokens_pool"


def blocked_addrs() -> frozenset[str]:
    """Module accounts that must not receive external funds — the analogue
    of app.ModuleAccountAddrs() handed to the bank keeper (reference
    app/app.go:309,606-611 blocks every maccPerms account). Computed
    lazily to avoid import cycles with gov/distribution."""
    from celestia_tpu_torch.x.distribution import DISTRIBUTION_MODULE_ACCOUNT
    from celestia_tpu_torch.x.gov import GOV_MODULE_ACCOUNT

    return frozenset(
        {
            FEE_COLLECTOR,
            MINT_MODULE,
            BONDED_POOL,
            NOT_BONDED_POOL,
            GOV_MODULE_ACCOUNT,
            DISTRIBUTION_MODULE_ACCOUNT,
        }
    )


def is_blocked_addr(address: str) -> bool:
    """True for module accounts and per-channel escrow accounts — any
    address a counterparty-controlled packet must not credit directly
    (ibc-go transfer's BlockedAddr check in OnRecvPacket)."""
    return address in blocked_addrs() or address.startswith("escrow/")


def _balance_key(address: str, denom: str) -> bytes:
    # NUL separator, not '/': both addresses (channel escrow accounts are
    # "escrow/<port>/<channel>") and denoms (IBC voucher traces are
    # "transfer/channel-0/utia") legitimately contain '/', so a '/' join
    # cannot be parsed back unambiguously. NUL appears in neither.
    return BALANCE_PREFIX + address.encode() + b"\x00" + denom.encode()


def split_balance_key(key: bytes) -> tuple[str, str]:
    """Inverse of _balance_key for store iteration (export, invariants)."""
    addr, denom = key[len(BALANCE_PREFIX):].split(b"\x00", 1)
    return addr.decode(), denom.decode()


class BankKeeper:
    def __init__(self, store):
        self.store = store

    def get_balance(self, address: str, denom: str = BOND_DENOM) -> int:
        raw = self.store.get(_balance_key(address, denom))
        return int.from_bytes(raw, "big") if raw else 0

    def set_balance(self, address: str, amount: int, denom: str = BOND_DENOM) -> None:
        if amount < 0:
            raise ValueError("negative balance")
        self.store.set(_balance_key(address, denom), amount.to_bytes(16, "big"))

    def send(self, from_addr: str, to_addr: str, amount: int, denom: str = BOND_DENOM) -> None:
        if amount < 0:
            raise ValueError("negative send amount")
        bal = self.get_balance(from_addr, denom)
        if bal < amount:
            raise ValueError(
                f"insufficient funds: {from_addr} has {bal}{denom}, needs {amount}"
            )
        # Vesting gate AT the bank boundary (sdk SubUnlockedCoins): every
        # outbound path — transfers, fees, deposits, IBC escrow — may only
        # touch the vested portion. The one sdk exemption is delegation
        # (sends to the bonded pool): staking locked coins is allowed.
        if denom == BOND_DENOM and to_addr != BONDED_POOL:
            self._assert_spendable(from_addr, amount)
        self.set_balance(from_addr, bal - amount, denom)
        self.set_balance(to_addr, self.get_balance(to_addr, denom) + amount, denom)

    def _assert_spendable(self, from_addr: str, amount: int) -> None:
        from celestia_tpu_torch.x.vesting import VestingKeeper

        vk = VestingKeeper(self.store, self)
        if vk.get_schedule(from_addr) is None:
            return  # fast path: not a vesting account
        raw = self.store.get(BLOCK_TIME_KEY)
        # no recorded consensus time (shouldn't happen post-genesis):
        # treat everything as still locked — fail closed
        now = float(raw.decode()) if raw else 0.0
        vk.assert_spendable(from_addr, amount, now)

    def mint(self, to_addr: str, amount: int, denom: str = BOND_DENOM) -> None:
        self.set_balance(to_addr, self.get_balance(to_addr, denom) + amount, denom)
        supply_key = SUPPLY_KEY + denom.encode()
        raw = self.store.get(supply_key)
        supply = int.from_bytes(raw, "big") if raw else 0
        self.store.set(supply_key, (supply + amount).to_bytes(16, "big"))

    def burn(self, from_addr: str, amount: int, denom: str = BOND_DENOM) -> None:
        """Destroy coins held by a (module) account, shrinking supply
        (ref: bank Keeper.BurnCoins — slashing burns from the bonded pool)."""
        bal = self.get_balance(from_addr, denom)
        if bal < amount:
            raise ValueError(f"burn exceeds balance of {from_addr}")
        self.set_balance(from_addr, bal - amount, denom)
        supply_key = SUPPLY_KEY + denom.encode()
        raw = self.store.get(supply_key)
        supply = int.from_bytes(raw, "big") if raw else 0
        if supply < amount:
            raise ValueError("burn exceeds total supply")
        self.store.set(supply_key, (supply - amount).to_bytes(16, "big"))

    def total_supply(self, denom: str = BOND_DENOM) -> int:
        raw = self.store.get(SUPPLY_KEY + denom.encode())
        return int.from_bytes(raw, "big") if raw else 0


URL_MSG_SEND = "/cosmos.bank.v1beta1.MsgSend"


@register_msg(URL_MSG_SEND)
@dataclasses.dataclass
class MsgSend:
    from_address: str
    to_address: str
    amount: int
    denom: str = BOND_DENOM

    def get_signers(self) -> list[str]:
        """ref: bank MsgSend.GetSigners — the sender must sign."""
        return [self.from_address]

    def marshal(self) -> bytes:
        coin = _field_bytes(1, self.denom.encode()) + _field_bytes(
            2, str(self.amount).encode()
        )
        return (
            _field_bytes(1, self.from_address.encode())
            + _field_bytes(2, self.to_address.encode())
            + _field_bytes(3, coin)
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgSend":
        m = cls("", "", 0)
        for tag, wt, val in _parse_fields(raw):
            if tag == 1:
                _require_wt(wt, 2, tag)
                m.from_address = bytes(val).decode()
            elif tag == 2:
                _require_wt(wt, 2, tag)
                m.to_address = bytes(val).decode()
            elif tag == 3:
                _require_wt(wt, 2, tag)
                for t2, w2, v2 in _parse_fields(bytes(val)):
                    if t2 == 1:
                        _require_wt(w2, 2, t2)
                        m.denom = bytes(v2).decode()
                    elif t2 == 2:
                        _require_wt(w2, 2, t2)
                        m.amount = int(bytes(v2).decode())
        return m

    def validate_basic(self) -> None:
        from celestia_tpu_torch.crypto import bech32_decode

        bech32_decode(self.from_address)
        bech32_decode(self.to_address)
        if self.amount <= 0:
            raise ValueError("send amount must be positive")
