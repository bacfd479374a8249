"""x/auth analogue: accounts with pubkey / account number / sequence.

The reference wires the stock SDK auth module (app/app.go:209-239); the
capabilities that matter to the DA chain are account-number assignment,
sequence (nonce) tracking, and pubkey storage for signature verification.
"""

from __future__ import annotations

import dataclasses
import json

ACCOUNT_PREFIX = b"auth/account/"
GLOBAL_ACCOUNT_NUMBER_KEY = b"auth/globalAccountNumber"


@dataclasses.dataclass
class Account:
    address: str  # bech32
    pub_key: bytes  # compressed secp256k1, may be empty until first tx
    account_number: int
    sequence: int

    def marshal(self) -> bytes:
        return json.dumps(
            {
                "address": self.address,
                "pub_key": self.pub_key.hex(),
                "account_number": self.account_number,
                "sequence": self.sequence,
            },
            sort_keys=True,
        ).encode()

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Account":
        d = json.loads(raw)
        return cls(
            address=d["address"],
            pub_key=bytes.fromhex(d["pub_key"]),
            account_number=d["account_number"],
            sequence=d["sequence"],
        )


class AccountKeeper:
    def __init__(self, store):
        self.store = store

    def get_account(self, address: str) -> Account | None:
        raw = self.store.get(ACCOUNT_PREFIX + address.encode())
        return Account.unmarshal(raw) if raw is not None else None

    def set_account(self, acc: Account) -> None:
        self.store.set(ACCOUNT_PREFIX + acc.address.encode(), acc.marshal())

    def new_account(self, address: str, pub_key: bytes = b"") -> Account:
        number = self._next_account_number()
        acc = Account(address=address, pub_key=pub_key, account_number=number, sequence=0)
        self.set_account(acc)
        return acc

    def get_or_create(self, address: str) -> Account:
        acc = self.get_account(address)
        if acc is None:
            acc = self.new_account(address)
        return acc

    def _next_account_number(self) -> int:
        raw = self.store.get(GLOBAL_ACCOUNT_NUMBER_KEY)
        n = int.from_bytes(raw, "big") if raw else 0
        self.store.set(GLOBAL_ACCOUNT_NUMBER_KEY, (n + 1).to_bytes(8, "big"))
        return n
