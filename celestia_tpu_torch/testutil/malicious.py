"""Malicious-proposer fixtures (port of the JAX package's
testutil/malicious.py) — fault injection for consensus tests. The squares
are extended on the App's device.

Reference semantics: test/util/malicious (app.go:15-60 BehaviorConfig,
out_of_order_builder.go, tree.go BlindTree): a proposer that builds
squares violating the deterministic layout rules but computes a
*consistent* DAH over its malformed square, so the only line of defense is
the honest validators' exact square reconstruction in ProcessProposal.
"""

from __future__ import annotations

import dataclasses

from celestia_tpu_torch import appconsts, blob as blob_pkg, da
from celestia_tpu_torch import square as square_pkg
from celestia_tpu_torch.app import App
from celestia_tpu_torch.app.app import ProposalBlockData
from celestia_tpu_torch.shares import to_bytes
from celestia_tpu_torch.shares.splitters import SparseShareSplitter, split_txs


@dataclasses.dataclass
class BehaviorConfig:
    """Which layout rule to break. ref: malicious/app.go BehaviorConfig"""

    out_of_order_blobs: bool = False  # don't sort blobs by namespace
    ignore_padding: bool = False  # drop the commitment-rule padding
    # commit a DAH over an EDS whose parity does NOT satisfy the
    # Reed-Solomon code — the attack Bad Encoding Fraud Proofs exist
    # for (reference specs/src/specs/fraud_proofs.md). The square
    # layout itself is honest; only the extension is corrupted.
    corrupt_extension: bool = False


class MaliciousApp(App):
    """An App whose PrepareProposal builds rule-breaking squares."""

    def __init__(self, *args, behavior: BehaviorConfig | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.behavior = behavior or BehaviorConfig()
        # height -> the corrupted EDS this app committed there; served to
        # peers on request — the DA assumption is that the data IS
        # available, it is the ENCODING that is fraudulent
        self.published_eds: dict[int, object] = {}
        self._published_hashes: set[bytes] = set()

    def process_proposal(self, block_data) -> bool:
        if block_data.hash in self._published_hashes:
            # blind self-acceptance: the attacker must vote its own
            # fraudulent block through (it controls >2/3 in the scenario)
            return True
        return super().process_proposal(block_data)

    def prepare_proposal(self, mempool_txs, block_data_size=None):
        if self.height >= 1 and self.behavior.corrupt_extension:
            return self._prepare_corrupt_extension(mempool_txs)
        if self.height == 0 or not (
            self.behavior.out_of_order_blobs or self.behavior.ignore_padding
        ):
            return super().prepare_proposal(mempool_txs, block_data_size)

        store = self.store.branch()
        from celestia_tpu_torch.app.context import ExecMode

        ctx = self._new_ctx(store, ExecMode.PREPARE)
        txs = self.filter_txs(ctx, mempool_txs)
        square = self._build_malicious_square(txs)
        eds = da.extend_shares(to_bytes(square), device=self.device)
        dah = da.new_data_availability_header(eds)
        return ProposalBlockData(
            txs=txs,
            square_size=square_pkg.square_size(len(square)),
            hash=dah.hash(),
        )

    def _prepare_corrupt_extension(self, mempool_txs):
        """An honestly laid-out square whose COMMITTED extension breaks
        the RS code: extend correctly, flip bits in one parity cell, and
        commit the DAH of the corrupted EDS. Honest validators reject it
        in ProcessProposal; with >2/3 attacker power it commits anyway,
        and only a Bad Encoding Fraud Proof can warn light clients."""
        from celestia_tpu_torch.app.context import ExecMode

        store = self.store.branch()
        ctx = self._new_ctx(store, ExecMode.PREPARE)
        txs = self.filter_txs(ctx, mempool_txs)
        square, txs = square_pkg.build(
            txs, self.app_version, self.gov_square_size_upper_bound()
        )
        k = square_pkg.square_size(len(square))
        # the device EDS fetched to the host, then corrupted there
        eds = da.extend_shares(to_bytes(square), device=self.device).data.copy()
        eds[0, k] ^= 0x5A  # corrupt one Q2 parity cell: row 0 breaks
        bad = da.ExtendedDataSquare(eds, k, self.device)
        dah = da.new_data_availability_header(bad)
        self.published_eds[self.height + 1] = eds
        self._published_hashes.add(dah.hash())
        return ProposalBlockData(txs=txs, square_size=k, hash=dah.hash())

    def _build_malicious_square(self, txs):
        """Lay blobs in arrival order and/or without alignment padding
        (ref: malicious/out_of_order_builder.go)."""
        normal, blobs = [], []
        for tx in txs:
            btx, is_blob = blob_pkg.unmarshal_blob_tx(tx)
            if is_blob:
                blobs.extend(btx.blobs)
                normal.append(
                    blob_pkg.marshal_index_wrapper(btx.tx, [0] * len(btx.blobs))
                )
            else:
                normal.append(tx)

        tx_shares, pfb_shares, _ = split_txs(normal)
        writer = SparseShareSplitter()
        for b in blobs:  # arrival order — NOT namespace-sorted
            writer.write(b)
        shares = tx_shares + pfb_shares + writer.export()
        total = square_pkg.square_size(len(shares)) ** 2
        from celestia_tpu_torch.shares import tail_padding_shares

        return shares + tail_padding_shares(total - len(shares))
