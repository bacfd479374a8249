"""Client-facing error parsing — sequence races and gas-price floors.

Reference semantics: app/errors/nonce_mismatch.go:12-30 and
app/errors/insufficient_gas_price.go:23-80. These helpers let a client
(user.Signer, txsim) recover from the two retryable CheckTx failures:

- a sequence (nonce) race: another tx from the same account landed first,
  so the node expects a different sequence. The expected value is parsed
  out of the error text and the client re-signs with it.
- a fee below the node's min gas price: the required fee is parsed out and
  the client resubmits with the implied gas price.

Like the reference, parsing is text-based (the error string is the only
thing that crosses the ABCI/RPC boundary) and intentionally brittle-aware:
the regexes pin the exact message formats produced by app/ante.py.
"""

from __future__ import annotations

import math
import re

from celestia_tpu_torch.appconsts import BOND_DENOM

# ante._verify_signatures: "account sequence mismatch: expected {e}, got {g}"
_NONCE_RE = re.compile(r"account sequence mismatch")
# ante._deduct_fee: "insufficient fees; got: {got}utia required: {req}utia"
_MIN_GAS_PRICE_RE = re.compile(
    rf"insufficient fees; got: \d+{BOND_DENOM} required: \d+{BOND_DENOM}"
)
_INT_RE = re.compile(r"[0-9]+")


def is_nonce_mismatch(log: str) -> bool:
    """ref: app/errors/nonce_mismatch.go:12 IsNonceMismatch"""
    return bool(log) and _NONCE_RE.search(log) is not None


def parse_nonce_mismatch(log: str) -> int:
    """Extract the expected sequence number from the mismatch error.
    ref: app/errors/nonce_mismatch.go:18 ParseNonceMismatch"""
    if not is_nonce_mismatch(log):
        raise ValueError("error is not a sequence mismatch")
    numbers = _INT_RE.findall(log)
    if len(numbers) != 2:
        raise ValueError(f"unexpected wrong sequence error: {log}")
    # the first number is the expected sequence number
    return int(numbers[0])


def is_insufficient_min_gas_price(log: str) -> bool:
    """ref: app/errors/insufficient_gas_price.go:71"""
    return bool(log) and _MIN_GAS_PRICE_RE.search(log) is not None


def parse_insufficient_min_gas_price(
    log: str, gas_price: float, gas_limit: int
) -> float:
    """Given the failed tx's gas price and limit, return the minimum gas
    price the node would accept. Returns 0.0 when the error is unrelated.
    ref: app/errors/insufficient_gas_price.go:23 ParseInsufficientMinGasPrice
    """
    match = _MIN_GAS_PRICE_RE.findall(log or "")
    if len(match) != 1:
        return 0.0
    numbers = _INT_RE.findall(match[0])
    if len(numbers) != 2:
        raise ValueError(f"expected two numbers in error message, got {len(numbers)}")
    got, required = float(numbers[0]), float(numbers[1])
    if required == 0:
        raise ValueError(
            "unexpected case: required gas price is zero (why was an error returned)"
        )
    if gas_price == 0 or got == 0:
        if gas_limit == 0:
            raise ValueError("gas limit and gas price cannot be zero")
        return required / gas_limit
    return required / got * gas_price


def fee_for_gas_price(gas_price: float, gas_limit: int) -> int:
    """The integer fee that satisfies a (possibly fractional) gas price."""
    return math.ceil(gas_price * gas_limit)
