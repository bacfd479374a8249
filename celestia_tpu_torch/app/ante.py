"""The ante handler chain.

Reference semantics: app/ante/ante.go:14-70 — a fixed-order decorator
pipeline run over every tx in CheckTx, PrepareProposal (FilterTxs),
ProcessProposal and DeliverTx. Decorators not meaningful in this build
(extension options, IBC redundant relay) are represented by no-ops so the
order and coverage stay auditable against the reference list.
"""

from __future__ import annotations

import math

from celestia_tpu_torch import appconsts
from celestia_tpu_torch.appconsts import BOND_DENOM
from celestia_tpu_torch.shares.splitters import sparse_shares_needed
from celestia_tpu_torch.tx import Tx, sign_doc_bytes
from celestia_tpu_torch.x.bank import FEE_COLLECTOR
from celestia_tpu_torch.x.blob.types import MsgPayForBlobs

from .context import Context, GasMeter

MAX_MEMO_CHARACTERS = 256
TX_SIZE_COST_PER_BYTE = 10
SIG_VERIFY_COST_SECP256K1 = 1000
MAX_SIGNATURES = 7

# Available bytes for blob data in a square with the max-1 shares
# (ref: x/blob/ante/max_total_blob_size_ante.go maxTotalBlobSize)


def available_bytes_from_sparse_shares(n_shares: int) -> int:
    """ref: pkg/shares/non_interactive_defaults.go AvailableBytesFromSparseShares"""
    if n_shares <= 0:
        return 0
    return (
        appconsts.FIRST_SPARSE_SHARE_CONTENT_SIZE
        + (n_shares - 1) * appconsts.CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
    )


class AnteHandler:
    """ref: app/ante/ante.go NewAnteHandler (decorator order preserved).

    Keepers are constructed over ctx.store per call so all state effects
    (fee deduction, sequence increments) land in the caller's branch —
    CheckTx / FilterTxs speculation must never leak into committed state.
    """

    def __call__(self, ctx: Context, tx: Tx, raw_len: int, simulate: bool = False) -> Context:
        from celestia_tpu_torch.x.auth import AccountKeeper
        from celestia_tpu_torch.x.bank import BankKeeper
        from celestia_tpu_torch.x.blob.keeper import BlobKeeper

        self.accounts = AccountKeeper(ctx.store)
        self.bank = BankKeeper(ctx.store)
        self.blob = BlobKeeper(ctx.store)
        # 1. HandlePanicDecorator: python exceptions propagate; callers wrap.
        # 2. SetUpContextDecorator: per-tx gas meter from the fee gas limit.
        #    Attached in place so the caller's ctx reports real gas_used even
        #    when a later decorator raises (baseapp reports consumed gas for
        #    failed txs too).
        ctx.gas_meter = GasMeter(tx.fee.gas_limit)
        # 3. ExtensionOptionsDecorator: format has no extension options (no-op).
        # 4. ValidateBasicDecorator
        self._validate_basic(tx)
        # 5. TxTimeoutHeightDecorator: format carries no timeout height (no-op).
        # 6. ValidateMemoDecorator
        if len(tx.memo) > MAX_MEMO_CHARACTERS:
            raise ValueError(f"memo too long: {len(tx.memo)} > {MAX_MEMO_CHARACTERS}")
        # 7. ConsumeGasForTxSizeDecorator
        ctx.gas_meter.consume(raw_len * TX_SIZE_COST_PER_BYTE, "txSize")
        # 8. DeductFeeDecorator (incl. validator-min-gas-price fee check)
        self._deduct_fee(ctx, tx, simulate)
        # 9-12. SetPubKey / ValidateSigCount / SigGasConsume / SigVerification
        self._verify_signatures(ctx, tx, simulate)
        # 13. MinGasPFBDecorator
        self._min_gas_pfb(ctx, tx)
        # 14. MaxTotalBlobSizeDecorator
        self._max_total_blob_size(ctx, tx)
        # 15. GovProposalDecorator: proposals must carry >=1 message — enforced
        #     in the gov msg handler in this build.
        # 16. IncrementSequenceDecorator
        self._increment_sequences(ctx, tx)
        # 17. IBC RedundantRelayDecorator: see x/tokenfilter for the IBC stack.
        return ctx

    def _validate_basic(self, tx: Tx) -> None:
        if not tx.msgs:
            raise ValueError("tx has no messages")
        if not tx.signatures:
            raise ValueError("tx has no signatures")
        if len(tx.signatures) != len(tx.signer_infos):
            raise ValueError("signature / signer-info count mismatch")
        for msg in tx.msgs:
            if hasattr(msg, "validate_basic"):
                msg.validate_basic()

    def _fee_payer(self, tx: Tx) -> str:
        if tx.fee.payer:
            return tx.fee.payer
        from celestia_tpu_torch.crypto import bech32_address

        return bech32_address(tx.signer_infos[0].public_key)

    def _deduct_fee(self, ctx: Context, tx: Tx, simulate: bool) -> None:
        """ref: app/ante/fee_checker.go — global min gas price applies in
        CheckTx; priority = fee / gas."""
        if ctx.is_check_tx() and not simulate and ctx.min_gas_price > 0:
            required = math.ceil(ctx.min_gas_price * tx.fee.gas_limit)
            if tx.fee.amount < required:
                raise ValueError(
                    f"insufficient fees; got: {tx.fee.amount}{BOND_DENOM} "
                    f"required: {required}{BOND_DENOM}"
                )
        if tx.fee.amount > 0:
            payer = self._fee_payer(tx)
            # The fee payer must be one of the tx signers in BOTH branches
            # (the SDK derives signers from GetSigners ∪ FeePayer) —
            # without it anyone could drain a third party's balance, or
            # burn a third party's fee allowance, fee-free.
            from celestia_tpu_torch.crypto import bech32_address

            signers = {bech32_address(si.public_key) for si in tx.signer_infos}
            if payer not in signers:
                raise ValueError(f"fee payer {payer} is not a tx signer")
            if tx.fee.granter:
                # feegrant path: the granter pays, against an allowance
                # granted to the (signing) fee payer — sdk
                # DeductFeeDecorator with the feegrant keeper. The granter
                # does NOT sign this tx.
                from celestia_tpu_torch.x.feegrant import FeegrantKeeper

                FeegrantKeeper(ctx.store, self.bank).use_granted_fees(
                    ctx, tx.fee.granter, payer, tx.fee.amount, tx.fee.denom,
                    tx.msgs,
                )
                self.bank.send(
                    tx.fee.granter, FEE_COLLECTOR, tx.fee.amount, tx.fee.denom
                )
            else:
                self.bank.send(payer, FEE_COLLECTOR, tx.fee.amount, tx.fee.denom)
        if tx.fee.gas_limit > 0:
            ctx.priority = tx.fee.amount * 1_000_000 // tx.fee.gas_limit

    def _verify_signatures(self, ctx: Context, tx: Tx, simulate: bool) -> None:
        if len(tx.signer_infos) > MAX_SIGNATURES:
            raise ValueError("too many signatures")
        from celestia_tpu_torch.crypto import bech32_address

        # SigVerificationDecorator semantics: every address a message names
        # as a required signer (sdk GetSigners) must be among the tx's
        # verified signers — otherwise any account could act on behalf of
        # another (MsgSend{from: victim} etc).
        required: set[str] = set()
        for msg in tx.msgs:
            getter = getattr(msg, "get_signers", None)
            if getter is None:
                raise ValueError(
                    f"message {type(msg).__name__} declares no signers"
                )
            required.update(getter())
        provided = {bech32_address(si.public_key) for si in tx.signer_infos}
        missing = required - provided
        if missing:
            raise ValueError(
                f"missing required signatures from: {sorted(missing)}"
            )
        for si, sig in zip(tx.signer_infos, tx.signatures):
            ctx.gas_meter.consume(SIG_VERIFY_COST_SECP256K1, "ante verify: secp256k1")
            if simulate:
                continue
            addr = bech32_address(si.public_key)
            acc = self.accounts.get_account(addr)
            if acc is None:
                raise ValueError(f"account {addr} not found")
            if not acc.pub_key:
                acc.pub_key = si.public_key
                self.accounts.set_account(acc)
            if si.sequence != acc.sequence:
                raise ValueError(
                    f"account sequence mismatch: expected {acc.sequence}, got {si.sequence}"
                )
            doc = sign_doc_bytes(
                tx.body_bytes(), tx.auth_info_bytes(), ctx.chain_id, acc.account_number
            )
            from celestia_tpu_torch.crypto import verify_signature

            if not verify_signature(si.public_key, doc, sig):
                raise ValueError("signature verification failed")

    def _min_gas_pfb(self, ctx: Context, tx: Tx) -> None:
        """ref: x/blob/ante/ante.go MinGasPFBDecorator"""
        if ctx.is_recheck_tx():
            return
        gas_per_byte = None
        remaining = ctx.gas_meter.remaining()
        for msg in tx.msgs:
            if isinstance(msg, MsgPayForBlobs):
                if gas_per_byte is None:
                    gas_per_byte = self.blob.get_params().gas_per_blob_byte
                needed = msg.gas(gas_per_byte)
                if needed > remaining:
                    raise ValueError(
                        f"not enough gas to pay for blobs (minimum: {needed}, "
                        f"got: {remaining})"
                    )

    def _max_total_blob_size(self, ctx: Context, tx: Tx) -> None:
        """ref: x/blob/ante/max_total_blob_size_ante.go"""
        if not ctx.is_check_tx():
            return
        if ctx.block_height <= 1:
            square_size = appconsts.DEFAULT_GOV_MAX_SQUARE_SIZE
        else:
            square_size = min(
                appconsts.square_size_upper_bound(ctx.app_version),
                self.blob.get_params().gov_max_square_size,
            )
        max_bytes = available_bytes_from_sparse_shares(square_size * square_size - 1)
        for msg in tx.msgs:
            if isinstance(msg, MsgPayForBlobs):
                total = sum(msg.blob_sizes)
                if total > max_bytes:
                    raise ValueError(
                        f"total blob size {total} exceeds max {max_bytes}"
                    )

    def _increment_sequences(self, ctx: Context, tx: Tx) -> None:
        from celestia_tpu_torch.crypto import bech32_address

        for si in tx.signer_infos:
            addr = bech32_address(si.public_key)
            acc = self.accounts.get_account(addr)
            if acc is not None:
                acc.sequence += 1
                self.accounts.set_account(acc)


def blob_tx_shares_used(blob_sizes: list[int]) -> int:
    return sum(sparse_shares_needed(s) for s in blob_sizes)
