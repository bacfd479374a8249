"""Client-side Signer (port of the JAX package's user.py) — build/sign/submit
txs and PFBs, then confirm.

Reference semantics: pkg/user/signer.go — SIGN_MODE_DIRECT signing,
sequence tracking with local increment, SubmitPayForBlob wrapping the
signed tx + blobs into a BlobTx envelope, poll-confirm, and tx options
(gas limit, fee / gas price, fee payer — pkg/user/tx_options.go). The
transport is pluggable: a local Node object or any client exposing
broadcast_tx, status, account and get_tx.

Submission is resilient the way the reference's clients are via
app/errors: a sequence race (another tx from this account landed first)
is detected from the CheckTx log, the expected sequence parsed out, and
the tx re-signed and resubmitted; a fee under the node's min gas price is
bumped to the parsed required price and resubmitted.
"""

from __future__ import annotations

import dataclasses

from celestia_tpu_torch import appconsts
from celestia_tpu_torch import blob as blob_pkg
from celestia_tpu_torch.app import errors as apperrors
from celestia_tpu_torch.crypto import PrivateKey
from celestia_tpu_torch.tx import Fee, sign_tx
from celestia_tpu_torch.x.blob.types import estimate_gas, new_msg_pay_for_blobs

DEFAULT_GAS_LIMIT = 200_000


@dataclasses.dataclass
class TxOptions:
    """ref: pkg/user/tx_options.go — per-submission knobs."""

    gas_limit: int = 0  # 0 = estimate from the messages
    fee: int = 0  # utia; 0 = derive from gas_price * gas_limit
    gas_price: float = appconsts.DEFAULT_MIN_GAS_PRICE
    fee_payer: str = ""  # optional explicit payer (must co-sign)
    fee_granter: str = ""  # x/feegrant: this account's allowance pays

    def resolve_fee(self, gas_limit: int) -> int:
        if self.fee:
            return self.fee
        return apperrors.fee_for_gas_price(self.gas_price, gas_limit)


class Signer:
    def __init__(self, key: PrivateKey, transport, chain_id: str,
                 account_number: int, sequence: int = 0):
        self.key = key
        self.transport = transport  # needs .broadcast_tx(raw) and .get_tx(hash)
        self.chain_id = chain_id
        self.account_number = account_number
        self.sequence = sequence

    @classmethod
    def setup_single(cls, key: PrivateKey, transport) -> "Signer":
        """ref: pkg/user/signer.go SetupSingleSigner — query account state.

        transport: anything exposing the transport surface — account(),
        status(), broadcast_tx(), get_tx(). The in-process Node implements
        it."""
        acc = transport.account(key.bech32_address())
        if acc is None:
            raise ValueError("account does not exist on chain")
        return cls(key, transport, transport.status()["chain_id"],
                   acc["account_number"], acc["sequence"])

    def address(self) -> str:
        return self.key.bech32_address()

    def _sign(self, msgs: list, fee: Fee):
        tx = sign_tx(
            self.key, msgs, self.chain_id, self.account_number, self.sequence, fee
        )
        return tx

    # ------------------------------------------------------------------ #
    # submission with retryable-error recovery

    def _broadcast_with_recovery(self, msgs: list, fee: Fee, wrap_blobs=None,
                                 retries: int = 3):
        """Sign/broadcast; on a sequence race re-sign at the node's expected
        sequence (app/errors ParseNonceMismatch), on an insufficient-fee
        rejection bump to the implied min gas price
        (ParseInsufficientMinGasPrice). At most `retries` resubmissions."""
        last = None
        for _attempt in range(retries + 1):
            tx = self._sign(msgs, fee)
            raw = tx.marshal()
            if wrap_blobs is not None:
                raw = blob_pkg.marshal_blob_tx(raw, wrap_blobs)
            last = self.transport.broadcast_tx(raw)
            last.raw = raw  # so callers can confirm_tx without re-signing
            if last.code == 0:
                self.sequence += 1
                return last
            if apperrors.is_nonce_mismatch(last.log):
                self.sequence = apperrors.parse_nonce_mismatch(last.log)
                continue
            if apperrors.is_insufficient_min_gas_price(last.log):
                old_price = fee.amount / fee.gas_limit if fee.gas_limit else 0.0
                new_price = apperrors.parse_insufficient_min_gas_price(
                    last.log, old_price, fee.gas_limit
                )
                fee = dataclasses.replace(
                    fee,
                    amount=apperrors.fee_for_gas_price(new_price, fee.gas_limit),
                )
                continue
            return last  # not a retryable failure
        return last

    def submit_tx(self, msgs: list, fee: Fee | None = None,
                  opts: TxOptions | None = None):
        """Sign, broadcast (with recovery), and bump the local sequence."""
        if fee is None:
            opts = opts or TxOptions()
            self._check_fee_payer(opts)
            gas = opts.gas_limit or DEFAULT_GAS_LIMIT
            fee = Fee(amount=opts.resolve_fee(gas), gas_limit=gas,
                      payer=opts.fee_payer, granter=opts.fee_granter)
        return self._broadcast_with_recovery(msgs, fee)

    def submit_pay_for_blob(self, blobs: list[blob_pkg.Blob],
                            fee: Fee | None = None,
                            opts: TxOptions | None = None):
        """ref: pkg/user/signer.go:145 SubmitPayForBlob"""
        msg = new_msg_pay_for_blobs(self.address(), *blobs)
        if fee is None:
            opts = opts or TxOptions()
            self._check_fee_payer(opts)
            gas = opts.gas_limit or estimate_gas([len(b.data) for b in blobs])
            fee = Fee(amount=opts.resolve_fee(gas), gas_limit=gas,
                      payer=opts.fee_payer, granter=opts.fee_granter)
        return self._broadcast_with_recovery([msg], fee, wrap_blobs=blobs)

    def _check_fee_payer(self, opts: TxOptions) -> None:
        """The ante requires the fee payer among the tx signers, and this
        Signer only ever signs with its own key — reject other payers
        client-side instead of burning a guaranteed-failing broadcast."""
        if opts.fee_payer and opts.fee_payer != self.address():
            raise ValueError(
                f"fee payer {opts.fee_payer} is not this signer "
                f"({self.address()}); co-signed fee granting is not supported"
            )

    def resync_sequence(self, transport=None) -> int:
        """Re-query the on-chain sequence (after a confirmed failure)."""
        transport = transport if transport is not None else self.transport
        acc = transport.account(self.address())
        if acc is not None:
            self.sequence = acc["sequence"]
        return self.sequence

    def confirm_tx(self, raw: bytes):
        """Poll the transport until the tx is committed.
        ref: pkg/user/signer.go:212 ConfirmTx"""
        from celestia_tpu_torch.node.node import tx_hash

        return self.transport.get_tx(tx_hash(raw))
