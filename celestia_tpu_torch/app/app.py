"""The App: the state machine behind the ABCI boundary (port of the JAX
package's app/app.py).

Reference semantics: app/app.go (keeper wiring, Begin/End block),
app/prepare_proposal.go, app/process_proposal.go, app/check_tx.go,
app/deliver_tx.go, app/extend_block.go, app/validate_txs.go,
app/square_size.go.

Block processing is a set of methods over an explicit StateStore, so all of
it runs without consensus. The EDS/DAH hot path runs on one of four
backends, all byte-identical: ``gpu`` (the port's device entries on the
App's device: ``extend.roots_device`` for proposals, the blob arena's
``proposal.assembled_proposal_dah`` on a proposer, and
``extend.extend_roots_device_resident`` for ExtendBlock and audited
proposals), ``native`` (the C++ runtime, ``native.py``), ``numpy`` (the
plain host path, ``da.extend_shares(..., device="cpu")``) and ``auto``.

``App(device=None)`` means CUDA, and the constructor raises on a host
without a GPU unless given ``device="cpu"``; on the CPU the ``gpu`` backend
runs the device entries' plain versions. Where the JAX App says ``tpu`` (the
backend, the strike, disable and quarantine fields, methods and counters)
the port says ``gpu``; the JAX App's ``use_tpu=True`` is
``extend_backend="gpu"`` here.

The device path degrades to the host only where the device is unavailable
(``faults.DeviceUnavailable``) or its result failed an integrity audit
(``integrity.IntegrityError``, the quarantine). The JAX App degrades on any
exception; here every other exception from the device path propagates, so
a kernel that fails to build or launch fails loudly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from celestia_tpu_torch import appconsts, da, faults, tracing
from celestia_tpu_torch import blob as blob_pkg
from celestia_tpu_torch import device as device_mod
from celestia_tpu_torch import square as square_pkg
from celestia_tpu_torch.shares import to_bytes
from celestia_tpu_torch.state import StateStore
from celestia_tpu_torch.tx import Tx, decode_tx
from celestia_tpu_torch.x.auth import AccountKeeper
from celestia_tpu_torch.x.authz import AuthzKeeper, MsgExec, MsgGrant, MsgRevoke
from celestia_tpu_torch.x.bank import BankKeeper, MsgSend
from celestia_tpu_torch.x.crisis import CrisisKeeper
from celestia_tpu_torch.x.feegrant import (
    FeegrantKeeper,
    MsgGrantAllowance,
    MsgRevokeAllowance,
)
from celestia_tpu_torch.x.blob import BlobKeeper, MsgPayForBlobs, validate_blob_tx
from celestia_tpu_torch.x.blob.types import pfb_blob_sizes
from celestia_tpu_torch.x.blobstream import BlobstreamKeeper, MsgRegisterEVMAddress
from celestia_tpu_torch.x.distribution import (
    DistributionKeeper,
    MsgWithdrawValidatorRewards,
)
from celestia_tpu_torch.x.gov import GovKeeper, MsgDeposit, MsgSubmitProposal, MsgVote
from celestia_tpu_torch.x.mint import MintKeeper
from celestia_tpu_torch.x.paramfilter import apply_param_changes
from celestia_tpu_torch.x.connection import (
    ConnectionKeeper,
    MsgConnectionOpenAck,
    MsgConnectionOpenConfirm,
    MsgConnectionOpenInit,
    MsgConnectionOpenTry,
)
from celestia_tpu_torch.x.ibc import (
    ChannelKeeper,
    MsgAcknowledgement,
    MsgChannelOpenAck,
    MsgChannelOpenConfirm,
    MsgChannelOpenInit,
    MsgChannelOpenTry,
    MsgRecvPacket,
    MsgTimeout,
    packet_ack_key,
    packet_commitment_key,
    packet_receipt_key,
)
from celestia_tpu_torch.x.lightclient import (
    ClientKeeper,
    MsgCreateClient,
    MsgSubmitMisbehaviour,
    MsgUpdateClient,
)
from celestia_tpu_torch.x.slashing import MsgUnjail, SlashingKeeper
from celestia_tpu_torch.x.staking import MsgDelegate, MsgUndelegate, StakingKeeper
from celestia_tpu_torch.x.tokenfilter import TokenFilterMiddleware
from celestia_tpu_torch.x.transfer import (
    PORT_ID_TRANSFER,
    MsgTransfer,
    TransferIBCModule,
    TransferKeeper,
)
from celestia_tpu_torch.x.upgrade import MsgVersionChange, UpgradeKeeper
from celestia_tpu_torch.x.vesting import (
    MsgCreatePeriodicVestingAccount,
    MsgCreateVestingAccount,
    VestingKeeper,
)

from celestia_tpu_torch.log import logger

from .ante import AnteHandler
from .context import Context, ExecMode, GasMeter

log = logger("app")

GENESIS_CHAIN_ID = "celestia-tpu-1"
BACKENDS = ("auto", "gpu", "native", "numpy")


@dataclasses.dataclass
class TxResult:
    code: int  # 0 = OK
    log: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list = dataclasses.field(default_factory=list)
    priority: int = 0


@dataclasses.dataclass
class ProposalBlockData:
    txs: list[bytes]
    square_size: int
    hash: bytes


# The static gate of the auto backend when no crossover table is attached:
# below this square size auto stays on the native runtime. The value is the
# JAX package's (celestia_tpu/app/app.py:119), taken over unmeasured; the
# port's own measurement is its crossover table (app/calibration.py).
GPU_MIN_SQUARE = 16


def _native_eds(eds_arr: np.ndarray, k: int, rows: list[bytes], cols: list[bytes],
                device) -> da.ExtendedDataSquare:
    """A host EDS from the native runtime, with the roots it computed."""
    return da.ExtendedDataSquare(eds_arr, k, device, roots=(
        np.frombuffer(b"".join(rows), np.uint8).reshape(len(rows), -1),
        np.frombuffer(b"".join(cols), np.uint8).reshape(len(cols), -1)))


class App:
    SUPPORTED_VERSIONS = (1, 2)
    GPU_STRIKE_LIMIT = 3  # consecutive device failures before sticky disable

    def __init__(self, chain_id: str = GENESIS_CHAIN_ID, app_version: int = 1,
                 upgrade_schedule: dict | None = None,
                 extend_backend: str | None = None,
                 audit_level: str | None = None, audit_q: int = 4,
                 device=None):
        # None means CUDA: raises here on a host without a GPU unless the
        # caller asks for the CPU
        self.device = device_mod.resolve(device)
        self.chain_id = chain_id
        self.app_version = app_version
        # "gpu" forces the device path (the JAX App's use_tpu=True)
        self.extend_backend = extend_backend or "auto"
        if self.extend_backend not in BACKENDS:
            raise ValueError(
                f"unknown extend backend {self.extend_backend!r} "
                f"(want {'|'.join(BACKENDS)})"
            )
        self._active_backend: str | None = None  # last backend logged
        # device -> host degradation: a device that is unavailable
        # (faults.DeviceUnavailable) strikes; GPU_STRIKE_LIMIT CONSECUTIVE
        # strikes sticky-disable the device path for this App (a success
        # resets the count). Every fallback is byte-identical, so
        # degradation costs latency, never correctness. Any other exception
        # from the device path (a kernel that fails to build or launch, a
        # shape bug) propagates: a broken kernel fails loudly.
        self._gpu_strikes = 0
        self._gpu_disabled = False
        # SDC defense: an explicit audit_level installs the process-global
        # integrity engine; either way the App mirrors the live level.
        # Quarantine latches on the first detected corruption (sticky like
        # _gpu_disabled, but skipping the strike grace).
        from celestia_tpu_torch import integrity

        if audit_level is not None:
            integrity.configure(audit_level, q=audit_q)
        self.audit_level = integrity.get().level
        self.sdc_quarantined = False
        self.sdc_events = 0
        self.last_sdc: dict | None = None
        # measured per-k backend crossover (app/calibration.py): the port's
        # committed table, overridden by calibrate_crossover(); None (no
        # committed file) falls back to the static GPU_MIN_SQUARE gate
        from celestia_tpu_torch.app import calibration

        self.crossover = calibration.load_default_table()
        self.blob_pool = None  # device blob arena (enable_blob_pool)
        # assembled-vs-fallback proposal counts when the arena is on
        self.arena_stats = {"assembled": 0, "fallback": 0}
        self.store = StateStore()
        self.accounts = AccountKeeper(self.store)
        self.bank = BankKeeper(self.store)
        self.blob = BlobKeeper(self.store)
        self.mint = MintKeeper(self.store, self.bank)
        self.staking = StakingKeeper(self.store, self.bank)
        self.blobstream = BlobstreamKeeper(self.store, self.staking)
        self.staking.hooks.append(self.blobstream)  # ref: app/app.go:349-354
        self.gov = GovKeeper(self.store, self.bank, self.staking)
        self.distribution = DistributionKeeper(self.store, self.bank, self.staking)
        self.slashing = SlashingKeeper(self.store, self.staking)
        # transfer stack, top to bottom: tokenfilter -> transfer
        # (ref: app/app.go:380-385)
        self.transfer = TransferKeeper(self.store, self.bank)
        self.ibc = self.transfer.channels
        self.upgrade = UpgradeKeeper(upgrade_schedule or {})
        self.height = 0
        self.block_time = 0.0
        self.min_gas_price = 0.0
        self._deliver_store = None
        self._deliver_ctx = None
        # Persistent CheckTx state branch (baseapp checkState): successive
        # mempool checks see each other's sequence increments; reset at
        # Commit so it re-branches from the new committed state.
        self._check_store = None

    def rebind_store(self, store: StateStore) -> None:
        """Point the app and ALL its keepers at a replacement committed
        store (restore/import paths). Keepers are reconstructed exactly as
        in __init__ so none is left reading the discarded store."""
        self.store = store
        self.accounts = AccountKeeper(store)
        self.bank = BankKeeper(store)
        self.blob = BlobKeeper(store)
        self.mint = MintKeeper(store, self.bank)
        self.staking = StakingKeeper(store, self.bank)
        self.blobstream = BlobstreamKeeper(store, self.staking)
        self.staking.hooks.append(self.blobstream)
        self.gov = GovKeeper(store, self.bank, self.staking)
        self.distribution = DistributionKeeper(store, self.bank, self.staking)
        self.slashing = SlashingKeeper(store, self.staking)
        self.transfer = TransferKeeper(store, self.bank)
        self.ibc = self.transfer.channels
        self._deliver_store = None
        self._deliver_ctx = None
        self._check_store = None

    # ------------------------------------------------------------------ #
    # genesis

    def init_chain(self, genesis_accounts: dict[str, int] | None = None,
                   genesis_time: float = 0.0,
                   genesis_validators: dict[str, int] | None = None) -> None:
        """ref: app/app.go InitChainer + default_overrides genesis.

        genesis_validators maps operator address -> self-bonded tokens
        (the genutil gentx flow: DeliverGenTxs creates the validators
        before the first block — app/app.go:498-499 notes genutil must
        run after staking so pools fund from genesis accounts)."""
        from celestia_tpu_torch.x.bank import BLOCK_TIME_KEY
        from celestia_tpu_torch.x.blob.keeper import Params

        self.blob.set_params(Params())
        self.store.set(BLOCK_TIME_KEY, repr(float(genesis_time)).encode())
        self.mint.init_genesis(genesis_time)
        for address, amount in (genesis_accounts or {}).items():
            self.accounts.get_or_create(address)
            self.bank.mint(address, amount)
        for operator, tokens in (genesis_validators or {}).items():
            if self.bank.get_balance(operator) < tokens:
                raise ValueError(
                    f"genesis validator {operator} self-bond {tokens} exceeds "
                    "its genesis balance"
                )
            self.accounts.get_or_create(operator)
            # the normal delegation path, so genesis bonding can never
            # diverge from tx-time bonding bookkeeping
            self.staking.delegate(None, operator, operator, tokens)
        self.store.commit()
        self.height = 0

    def assert_invariants(self) -> None:
        """ref: crisis AssertInvariants (app/export.go:69)."""
        CrisisKeeper(self.store).assert_invariants()

    # ------------------------------------------------------------------ #
    # helpers

    def _ante(self) -> AnteHandler:
        return AnteHandler()

    def _new_ctx(self, store, mode: ExecMode) -> Context:
        return Context(
            store=store,
            chain_id=self.chain_id,
            block_height=self.height + 1,
            block_time=self.block_time,
            app_version=self.app_version,
            mode=mode,
            min_gas_price=self.min_gas_price,
        )

    def gov_square_size_upper_bound(self) -> int:
        """ref: app/square_size.go:10"""
        return min(
            self.blob.get_params().gov_max_square_size,
            appconsts.square_size_upper_bound(self.app_version),
        )

    def accelerator_available(self) -> bool:
        """True when the App's device is a CUDA card (the JAX App asks
        jax.devices() instead)."""
        return self.device.type == "cuda"

    def resolve_extend_backend(self, k: int) -> str:
        """Pick the live ExtendBlock backend for a k×k square.

        auto: the MEASURED winner for this k when a CrossoverTable is
        attached (self.crossover, app/calibration.py — winners are
        re-checked against live backend availability, so a table
        measured elsewhere degrades safely); otherwise the static gate —
        device when the App's device is a card and k >= GPU_MIN_SQUARE,
        else the native C++ runtime, else numpy. Explicit backends are
        honored ("gpu" means the device entries on the App's device; on
        device="cpu" their plain versions, which is how the tests exercise
        the device branch). All backends are byte-identical, so the choice
        is purely a latency call."""
        from celestia_tpu_torch import native

        backend = self.extend_backend
        if backend == "auto":
            winner = self.crossover.winner(k) if self.crossover else None
            if winner == "gpu" and not self.accelerator_available():
                winner = None
            if winner == "native" and not native.available():
                winner = None
            if winner not in (None, "gpu", "native"):
                winner = None  # a backend this port does not have
            if winner is not None:
                backend = winner
            elif self.accelerator_available() and k >= GPU_MIN_SQUARE:
                backend = "gpu"
            elif native.available():
                backend = "native"
            else:
                backend = "numpy"
        elif backend == "native" and not native.available():
            backend = "numpy"
        if backend == "gpu" and self._gpu_disabled:
            # sticky degradation: the device struck out (_degrade_gpu)
            backend = "native" if native.available() else "numpy"
        if backend != self._active_backend:
            log.info("extend backend", backend=backend, k=k,
                     configured=self.extend_backend)
            self._active_backend = backend
        return backend

    def calibrate_crossover(self, ks: tuple[int, ...] | None = None,
                            repeats: int = 2, persist_path=None):
        """Measure the per-k gpu/native latency table on the App's device
        and attach it, so `auto` resolves to the measured winner
        (app/calibration.py). Refreshable at any time; persists to JSON
        when a path is given."""
        from celestia_tpu_torch.app import calibration

        table = calibration.measure_crossover(
            ks or calibration.DEFAULT_KS, repeats, device=self.device
        )
        self.crossover = table
        self._active_backend = None  # re-log the (possibly new) winner
        if persist_path is not None:
            table.save(persist_path)
        return table

    def _square_array(self, data_square, k: int):
        return np.frombuffer(
            b"".join(s.data for s in data_square), dtype=np.uint8
        ).reshape(k, k, appconsts.SHARE_SIZE)

    def _degrade_gpu(self, op: str, exc: Exception,
                     cause: str = "exception") -> str:
        """One device ExtendBlock failure (the device was unavailable, or
        its result corrupt): strike, warn with the block height + cause,
        and return the host-side fallback backend.
        GPU_STRIKE_LIMIT consecutive strikes sticky-disable the device
        path (resolve_extend_backend consults _gpu_disabled); every
        fallback recomputes byte-identically on the host.

        cause="corruption" (a failed integrity audit) skips the strike
        grace entirely: a device that produced one wrong answer is
        quarantined immediately — transient crashes earn retries, silent
        wrongness does not."""
        from celestia_tpu_torch import native

        if cause == "corruption":
            self._gpu_strikes = self.GPU_STRIKE_LIMIT
            self._gpu_disabled = True
            self._active_backend = None
            self.sdc_quarantined = True
            self.sdc_events += 1
        else:
            self._gpu_strikes += 1
            if self._gpu_strikes >= self.GPU_STRIKE_LIMIT:
                self._gpu_disabled = True
                self._active_backend = None  # re-log the degraded winner
        fallback = "native" if native.available() else "numpy"
        log.warn(
            "extend degraded gpu->host",
            height=self.height + 1,
            cause=f"{type(exc).__name__}: {exc}",
            reason=cause,
            op=op,
            strike=self._gpu_strikes,
            fallback=fallback,
            disabled=self._gpu_disabled,
        )
        try:
            from celestia_tpu_torch.telemetry import metrics

            metrics.incr_counter("extend_gpu_fallback_total", op=op)
            if self._gpu_disabled:
                metrics.incr_counter("extend_gpu_disabled_total")
        except Exception:  # noqa: BLE001 — metrics never break proposals
            pass
        sp = tracing.current()
        if sp is not None:
            sp.set(degraded=True, strikes=self._gpu_strikes,
                   cause=type(exc).__name__)
        return fallback

    def _quarantine_gpu(self, op: str, exc: Exception) -> str:
        """Detected silent data corruption (IntegrityError from the ops
        layer's audit): discard the device result, run the corrupted
        square through the fraud oracle to assert the BEFP machinery would
        have caught the block had it been committed, and sticky-disable
        the device immediately. The caller falls through to the host
        recompute, restoring the byte-identical guarantee before any DAH
        is committed."""
        befp_provable = False
        eds_bad = getattr(exc, "eds", None)
        if eds_bad is not None:
            try:
                from celestia_tpu_torch.da import fraud

                befp_provable = (
                    fraud.find_befp(np.ascontiguousarray(eds_bad)) is not None
                )
            except Exception:  # noqa: BLE001 — the oracle is evidence, not a gate
                befp_provable = False
        self.last_sdc = {
            "op": op,
            "site": getattr(exc, "site", "unknown"),
            "where": getattr(exc, "where", "unknown"),
            "mismatches": getattr(exc, "mismatches", None),
            "height": self.height + 1,
            "befp_provable": befp_provable,
        }
        log.warn(
            "sdc quarantine: device result discarded",
            op=op,
            site=self.last_sdc["site"],
            mismatches=self.last_sdc["mismatches"],
            height=self.height + 1,
            befp_provable=befp_provable,
        )
        try:
            from celestia_tpu_torch.telemetry import metrics

            metrics.incr_counter("sdc_quarantine_total", op=op)
        except Exception:  # noqa: BLE001 — metrics never break proposals
            pass
        sp = tracing.current()
        if sp is not None:
            sp.set(sdc=True, sdc_site=self.last_sdc["site"],
                   befp_provable=befp_provable)
        return self._degrade_gpu(op, exc, cause="corruption")

    def _proposal_dah(
        self, data_square, builder=None
    ) -> "da.DataAvailabilityHeader":
        """Roots-only hot path for Prepare/ProcessProposal: square -> DAH,
        the EDS never leaves the device.

        ref: app/prepare_proposal.go:95-115 / process_proposal.go — the
        proposal flow only needs the DataAvailabilityHeader hash. On the
        gpu backend the EDS is never assembled (extend.roots_device): only
        2·2k·90 bytes of axis roots cross back to the host. With a blob
        arena attached (enable_blob_pool) and the square's blob bytes
        already resident, the square upload disappears too: the card
        assembles it from the arena (`builder` supplies the blob placement)
        and only share metadata crosses."""
        from celestia_tpu_torch import native
        from celestia_tpu_torch.telemetry import metrics

        k = square_pkg.square_size(len(data_square))
        backend = self.resolve_extend_backend(k)
        with tracing.span("extend.block", backend=backend, k=k,
                          height=self.height + 1, path="proposal") as bspan, \
                metrics.measure("extend_block", path="proposal"):
            if backend == "gpu":
                from celestia_tpu_torch import integrity
                from celestia_tpu_torch.app import proposal
                from celestia_tpu_torch.ops import extend

                eng = integrity.get()
                try:
                    if (builder is not None and self.blob_pool is not None
                            and not eng.enabled):
                        # the arena and roots-only paths never materialize
                        # the EDS, so there is nothing to audit; under an
                        # active audit policy the proposal routes through
                        # the EDS-producing entry instead
                        dah = proposal.assembled_proposal_dah(
                            self.blob_pool, data_square, builder, k, self.device
                        )
                        # hit-rate accounting: under arena churn (working
                        # set > capacity) proposals oscillate between the
                        # assembled and upload paths
                        stat = "assembled" if dah is not None else "fallback"
                        self.arena_stats[stat] += 1
                        try:
                            metrics.incr_counter(f"blob_arena_proposal_{stat}")
                        except Exception:  # noqa: BLE001 — metrics never break proposals
                            pass
                        if dah is not None:
                            self._gpu_strikes = 0
                            return dah
                    if eng.enabled:
                        _eds_dev, rows, cols = extend.extend_roots_device_resident(
                            self._square_array(data_square, k), self.device
                        )
                    else:
                        rows, cols = extend.roots_device(
                            self._square_array(data_square, k), self.device
                        )
                    self._gpu_strikes = 0
                    return da.DataAvailabilityHeader(
                        [r.tobytes() for r in rows],
                        [c.tobytes() for c in cols],
                    )
                except integrity.IntegrityError as exc:
                    backend = self._quarantine_gpu("proposal_dah", exc)
                    bspan.set(backend=backend)
                except faults.DeviceUnavailable as exc:  # degrade to host
                    backend = self._degrade_gpu("proposal_dah", exc)
                    bspan.set(backend=backend)
            if backend == "native":
                _eds, rows, cols, native_dah = native.extend_and_root_native(
                    self._square_array(data_square, k)
                )
                return da.DataAvailabilityHeader(rows, cols, _hash=native_dah)
            eds = da.extend_shares(to_bytes(data_square), device="cpu")
            return da.new_data_availability_header(eds)

    def enable_blob_pool(self, capacity_bytes: int = 64 * 1024 * 1024):
        """Attach a blob arena on the App's device (ops/blob_pool.py): the
        node stages mempool blob bytes on the card at admission time, and
        the gpu proposal path assembles squares there from them instead of
        uploading 8 MB per proposal. Purely a transfer cache — every miss
        falls back to the plain upload path, byte-identically."""
        from celestia_tpu_torch.ops.blob_pool import DeviceBlobArena

        if self.blob_pool is None:
            self.blob_pool = DeviceBlobArena(capacity_bytes, device=self.device)
        return self.blob_pool

    def _extend_and_hash(self, data_square) -> tuple:
        """The EDS-producing path: square -> EDS + DAH (ExtendBlock / block
        storage; proposal flows use _proposal_dah and skip the EDS).

        On the gpu backend the EDS stays DEVICE-RESIDENT: the returned
        ExtendedDataSquare holds the device tensor and fetches host bytes
        lazily only if shares are actually served (32 MB at k=128)."""
        from celestia_tpu_torch import native
        from celestia_tpu_torch.telemetry import metrics

        k = square_pkg.square_size(len(data_square))
        backend = self.resolve_extend_backend(k)
        with tracing.span("extend.block", backend=backend, k=k,
                          height=self.height + 1, path="eds") as bspan, \
                metrics.measure("extend_block", path="eds"):
            if backend in ("gpu", "native"):
                arr = self._square_array(data_square, k)
                if backend == "gpu":
                    from celestia_tpu_torch import integrity
                    from celestia_tpu_torch.ops import extend

                    try:
                        # the card computes the EDS and the axis roots; the
                        # small DAH merkle tree over the roots is host-side
                        eds_dev, rows, cols = extend.extend_roots_device_resident(
                            arr, self.device
                        )
                        dah = da.DataAvailabilityHeader(
                            [r.tobytes() for r in rows],
                            [c.tobytes() for c in cols],
                        )
                        self._gpu_strikes = 0
                        eds = da.ExtendedDataSquare.from_device(eds_dev, k, (rows, cols))
                        return eds, dah
                    except integrity.IntegrityError as exc:
                        backend = self._quarantine_gpu("extend_and_hash", exc)
                        bspan.set(backend=backend)
                    except faults.DeviceUnavailable as exc:  # degrade to host
                        backend = self._degrade_gpu("extend_and_hash", exc)
                        bspan.set(backend=backend)
                if backend == "native":
                    eds_arr, rows, cols, native_dah = (
                        native.extend_and_root_native(arr)
                    )
                    dah = da.DataAvailabilityHeader(rows, cols, _hash=native_dah)
                    return _native_eds(eds_arr, k, rows, cols, self.device), dah
            eds = da.extend_shares(to_bytes(data_square), device="cpu")
            return eds, da.new_data_availability_header(eds)


    # ------------------------------------------------------------------ #
    # CheckTx (mempool admission). ref: app/check_tx.go:15-51

    def check_tx(self, raw_tx: bytes, recheck: bool = False) -> TxResult:
        btx, is_blob = blob_pkg.unmarshal_blob_tx(raw_tx)
        mode = ExecMode.RECHECK if recheck else ExecMode.CHECK
        try:
            if not is_blob:
                tx = decode_tx(raw_tx)
                for msg in tx.msgs:
                    if isinstance(msg, MsgPayForBlobs):
                        return TxResult(code=2, log="PFB without blobs (ErrNoBlobs)")
                inner_raw = raw_tx
            else:
                if not recheck:
                    tx = validate_blob_tx(btx)  # returns the decoded tx
                else:
                    tx = Tx.unmarshal(btx.tx)
                inner_raw = btx.tx

            if self._check_store is None:
                self._check_store = self.store.branch()
            tx_branch = self._check_store.branch()
            ctx = self._new_ctx(tx_branch, mode)
            try:
                ctx = self._ante()(ctx, tx, len(inner_raw))
            except Exception as e:  # noqa: BLE001
                # the ante attaches the per-tx gas meter to ctx in place, so
                # real consumption is reportable even on failure
                return TxResult(
                    code=1, log=str(e),
                    gas_wanted=tx.fee.gas_limit,
                    gas_used=ctx.gas_meter.consumed,
                )
            tx_branch.write()  # persist into check state (not committed state)
            return TxResult(
                code=0,
                gas_wanted=tx.fee.gas_limit,
                gas_used=ctx.gas_meter.consumed,
                priority=ctx.priority,
            )
        except Exception as e:  # noqa: BLE001 — tx failures become result codes
            return TxResult(code=1, log=str(e))

    # ------------------------------------------------------------------ #
    # PrepareProposal. ref: app/prepare_proposal.go:22-134

    def prepare_proposal(self, mempool_txs: list[bytes],
                         block_data_size: int | None = None) -> ProposalBlockData:
        import time as _time

        from celestia_tpu_torch.telemetry import metrics

        _start = _time.perf_counter()
        try:
            with tracing.span("app.prepare_proposal",
                              height=self.height + 1,
                              txs=len(mempool_txs)):
                return self._prepare_proposal_inner(mempool_txs, block_data_size)
        finally:
            # ref: app/prepare_proposal.go:23 telemetry.MeasureSince
            metrics.measure_since("prepare_proposal", _start)

    def _prepare_proposal_inner(self, mempool_txs: list[bytes],
                                block_data_size: int | None = None) -> ProposalBlockData:
        if self.height == 0:
            txs: list[bytes] = []  # first block is empty by design
        else:
            store = self.store.branch()
            ctx = self._new_ctx(store, ExecMode.PREPARE)
            with tracing.span("app.filter_txs", txs=len(mempool_txs)):
                txs = self.filter_txs(ctx, mempool_txs)

            new_version = self.upgrade.should_propose_upgrade(self.chain_id, self.height + 1)
            if new_version is not None and new_version > self.app_version:
                txs = [MsgVersionChange.as_tx_bytes(new_version)] + txs
            if block_data_size is not None:
                # prune lowest-priority (trailing) txs over the size budget
                size = sum(len(t) for t in txs)
                while size > block_data_size and txs:
                    size -= len(txs[-1])
                    txs = txs[:-1]

        with tracing.span("app.build_square", txs=len(txs)):
            data_square, txs, builder = square_pkg.build_ex(
                txs, self.app_version, self.gov_square_size_upper_bound()
            )
        dah = self._proposal_dah(data_square, builder)
        return ProposalBlockData(
            txs=txs,
            square_size=square_pkg.square_size(len(data_square)),
            hash=dah.hash(),
        )

    def filter_txs(self, ctx: Context, txs: list[bytes]) -> list[bytes]:
        """Drop ante-failing txs. ref: app/validate_txs.go:30-35.

        Unlike the reference (which trusts that CheckTx already ran
        ValidateBlobTx on everything in the mempool), blob txs are
        re-validated here too: a proposer handed an unchecked tx with a
        tampered blob would otherwise build a proposal its own
        ProcessProposal rejects — a liveness footgun for zero safety
        benefit. The recompute is cheap next to the square extend."""
        ante = self._ante()
        kept_normal: list[bytes] = []
        kept_blob: list[bytes] = []
        for raw in txs:
            btx, is_blob = blob_pkg.unmarshal_blob_tx(raw)
            inner = btx.tx if is_blob else raw
            try:
                tx = validate_blob_tx(btx) if is_blob else decode_tx(inner)
                if not is_blob and any(
                    isinstance(m, MsgPayForBlobs) for m in tx.msgs
                ):
                    continue  # bare PFB: ProcessProposal would reject it
                ante(ctx, tx, len(inner))
            except Exception:  # noqa: BLE001
                continue
            (kept_blob if is_blob else kept_normal).append(raw)
        return kept_normal + kept_blob

    # ------------------------------------------------------------------ #
    # ProcessProposal. ref: app/process_proposal.go:24-166

    def process_proposal(self, block_data: ProposalBlockData) -> bool:
        import time as _time

        from celestia_tpu_torch.telemetry import metrics

        _start = _time.perf_counter()
        try:
            with tracing.span("app.process_proposal",
                              height=self.height + 1,
                              txs=len(block_data.txs)):
                return self._process_proposal_inner(block_data)
        except Exception:  # noqa: BLE001 — panics vote REJECT, not crash
            metrics.incr_counter("process_proposal_panics")
            return False
        finally:
            # ref: app/process_proposal.go:25 telemetry.MeasureSince
            metrics.measure_since("process_proposal", _start)

    def _process_proposal_inner(self, block_data: ProposalBlockData) -> bool:
        store = self.store.branch()
        ctx = self._new_ctx(store, ExecMode.PROCESS)
        ante = self._ante()

        for idx, raw_tx in enumerate(block_data.txs):
            btx, is_blob = blob_pkg.unmarshal_blob_tx(raw_tx)
            if is_blob:
                # STRICT decode of the inner tx (Tx.unmarshal, never the
                # IndexWrapper-tolerant decode_tx): a BlobTx whose inner
                # tx is index-wrapped is invalid here, and accepting it
                # would widen the consensus validity rule and break block
                # deconstruction downstream.
                try:
                    tx = Tx.unmarshal(btx.tx)
                except Exception:  # noqa: BLE001 — undecodable txs are
                    continue  # not a block validity rule
                validate_blob_tx(btx, sdk_tx=tx)
                ante(ctx, tx, len(btx.tx))
                continue

            try:
                tx = decode_tx(raw_tx)
            except Exception:  # noqa: BLE001
                continue
            if any(isinstance(m, MsgPayForBlobs) for m in tx.msgs):
                return False  # non-blob tx carrying a PFB
            version = MsgVersionChange.from_msgs(tx.msgs)
            if version is not None:
                if idx != 0:
                    return False  # upgrade msg must be the first tx
                if version not in self.SUPPORTED_VERSIONS:
                    return False
                if version <= self.app_version:
                    return False
                continue
            ante(ctx, tx, len(raw_tx))

        data_square, builder = square_pkg.construct_ex(
            block_data.txs, self.app_version, self.gov_square_size_upper_bound()
        )
        if square_pkg.square_size(len(data_square)) != block_data.square_size:
            return False
        dah = self._proposal_dah(data_square, builder)
        return dah.hash() == block_data.hash

    # ------------------------------------------------------------------ #
    # Block execution: BeginBlock -> DeliverTx* -> EndBlock -> Commit

    def begin_block(
        self,
        block_time: float | None = None,
        last_commit_signers: list[str] | None = None,
        evidence: list | None = None,
    ) -> None:
        """ref: module BeginBlocker order app/app.go:452-473 — mint,
        distribution, slashing (last-commit liveness), evidence.

        last_commit_signers: operator addresses that signed the previous
        block (ABCI LastCommitInfo analogue; None = skip liveness).
        evidence: list of slashing.Equivocation (ABCI ByzantineValidators).
        """
        self.block_time = block_time if block_time is not None else self.block_time + 15.0
        self._deliver_store = self.store.branch()
        self._deliver_ctx = self._new_ctx(self._deliver_store, ExecMode.DELIVER)
        # record consensus time for time-dependent bank checks (vesting)
        from celestia_tpu_torch.x.bank import BLOCK_TIME_KEY

        self._deliver_store.set(BLOCK_TIME_KEY, repr(float(self.block_time)).encode())
        # BeginBlock state effects go through the deliver branch — they must
        # only reach committed state at Commit (crash-replay determinism).
        store = self._deliver_store
        bank = BankKeeper(store)
        MintKeeper(store, bank).begin_blocker(self._deliver_ctx)
        staking = StakingKeeper(store, bank)
        staking.hooks.append(BlobstreamKeeper(store, staking))
        DistributionKeeper(store, bank, staking).begin_blocker(self._deliver_ctx)
        slashing = SlashingKeeper(store, staking)
        if last_commit_signers is not None:
            signers = set(last_commit_signers)
            for v in staking.bonded_validators():
                slashing.handle_validator_signature(
                    self._deliver_ctx, v.operator, v.operator in signers
                )
        for ev in evidence or []:
            slashing.handle_double_sign(self._deliver_ctx, ev)

    def deliver_tx(self, raw_tx: bytes) -> TxResult:
        """ref: app/deliver_tx.go:10-23"""
        btx, is_blob = blob_pkg.unmarshal_blob_tx(raw_tx)
        inner = btx.tx if is_blob else raw_tx
        try:
            tx = decode_tx(inner)
        except Exception as e:  # noqa: BLE001
            return TxResult(code=1, log=f"undecodable tx: {e}")

        version = MsgVersionChange.from_msgs(tx.msgs)
        if version is not None:
            if version not in self.SUPPORTED_VERSIONS:
                raise RuntimeError(
                    f"network is at version {version} which this node does not support"
                )
            self.upgrade.prepare_upgrade_at_end_block(version)
            return TxResult(code=0, log="version change armed")

        # Ante effects (fee deduction, sequence increment) persist even when
        # message execution fails — baseapp writes the ante cache before
        # running msgs; otherwise failed txs are free and replayable.
        ante_store = self._deliver_store.branch()
        ctx = dataclasses.replace(self._deliver_ctx, store=ante_store, events=[])
        try:
            ctx = self._ante()(ctx, tx, len(inner))
        except Exception as e:  # noqa: BLE001
            return TxResult(
                code=1, log=str(e),
                gas_wanted=tx.fee.gas_limit, gas_used=ctx.gas_meter.consumed,
            )
        ante_store.write()

        msg_store = self._deliver_store.branch()
        msg_ctx = dataclasses.replace(ctx, store=msg_store)
        try:
            for msg in tx.msgs:
                self._route_msg(msg_ctx, msg)
            msg_store.write()
            return TxResult(
                code=0,
                gas_wanted=tx.fee.gas_limit,
                gas_used=msg_ctx.gas_meter.consumed,
                events=msg_ctx.events,
            )
        except Exception as e:  # noqa: BLE001 — msg effects roll back,
            return TxResult(  # ante effects (fees, gas) stay
                code=1, log=str(e),
                gas_wanted=tx.fee.gas_limit, gas_used=msg_ctx.gas_meter.consumed,
            )

    def _route_msg(self, ctx: Context, msg) -> None:
        if isinstance(msg, MsgPayForBlobs):
            blob_keeper = BlobKeeper(ctx.store)
            blob_keeper.pay_for_blobs(ctx, msg)
        elif isinstance(msg, MsgSend):
            # the vesting gate lives inside BankKeeper.send (every
            # outbound path is covered, not just this route)
            BankKeeper(ctx.store).send(
                msg.from_address, msg.to_address, msg.amount, msg.denom
            )
            # receiving funds creates the account (SDK bank/auth behavior)
            AccountKeeper(ctx.store).get_or_create(msg.to_address)
        elif isinstance(msg, MsgDelegate):
            StakingKeeper(ctx.store, BankKeeper(ctx.store)).delegate(
                ctx, msg.delegator, msg.validator, msg.amount
            )
        elif isinstance(msg, MsgUndelegate):
            keeper = StakingKeeper(ctx.store, BankKeeper(ctx.store))
            keeper.hooks.append(BlobstreamKeeper(ctx.store, keeper))
            keeper.undelegate(ctx, msg.delegator, msg.validator, msg.amount)
        elif isinstance(msg, MsgRegisterEVMAddress):
            staking = StakingKeeper(ctx.store, BankKeeper(ctx.store))
            BlobstreamKeeper(ctx.store, staking).register_evm_address(
                msg.validator_address, msg.evm_address
            )
        elif isinstance(msg, MsgSubmitProposal):
            self._gov_keeper(ctx).submit_proposal(
                ctx, msg.proposer, msg.changes, msg.initial_deposit
            )
        elif isinstance(msg, MsgDeposit):
            self._gov_keeper(ctx).deposit(
                ctx, msg.proposal_id, msg.depositor, msg.amount
            )
        elif isinstance(msg, MsgVote):
            self._gov_keeper(ctx).vote(ctx, msg.proposal_id, msg.voter, msg.option)
        elif isinstance(msg, MsgWithdrawValidatorRewards):
            bank = BankKeeper(ctx.store)
            DistributionKeeper(
                ctx.store, bank, StakingKeeper(ctx.store, bank)
            ).withdraw_rewards(ctx, msg.validator_address)
        elif isinstance(msg, MsgUnjail):
            bank = BankKeeper(ctx.store)
            staking = StakingKeeper(ctx.store, bank)
            staking.hooks.append(BlobstreamKeeper(ctx.store, staking))
            SlashingKeeper(ctx.store, staking).unjail(ctx, msg.validator_address)
        elif isinstance(msg, MsgCreateVestingAccount):
            VestingKeeper(ctx.store, BankKeeper(ctx.store)).create_vesting_account(
                ctx, msg.from_address, msg.to_address, msg.amount,
                msg.end_time, msg.delayed,
            )
        elif isinstance(msg, MsgCreatePeriodicVestingAccount):
            VestingKeeper(
                ctx.store, BankKeeper(ctx.store)
            ).create_periodic_vesting_account(
                ctx, msg.from_address, msg.to_address, msg.periods
            )
        elif isinstance(msg, MsgGrantAllowance):
            FeegrantKeeper(ctx.store, BankKeeper(ctx.store)).grant_allowance(
                msg.to_allowance()
            )
        elif isinstance(msg, MsgRevokeAllowance):
            FeegrantKeeper(ctx.store, BankKeeper(ctx.store)).revoke_allowance(
                msg.granter, msg.grantee
            )
        elif isinstance(msg, MsgGrant):
            AuthzKeeper(ctx.store).grant(msg.to_grant())
        elif isinstance(msg, MsgRevoke):
            AuthzKeeper(ctx.store).revoke(
                msg.granter, msg.grantee, msg.msg_type_url
            )
        elif isinstance(msg, MsgExec):
            AuthzKeeper(ctx.store).dispatch_exec(
                ctx, msg.grantee, msg.msgs, self._route_msg
            )
        elif isinstance(msg, MsgTransfer):
            TransferKeeper(ctx.store, BankKeeper(ctx.store)).send_transfer(
                ctx, msg.source_port, msg.source_channel, msg.denom,
                msg.amount, msg.sender, msg.receiver,
                msg.timeout_timestamp, msg.memo,
            )
        elif isinstance(msg, MsgRecvPacket):
            self._handle_recv_packet(ctx, msg)
        elif isinstance(msg, MsgAcknowledgement):
            self._handle_acknowledgement(ctx, msg)
        elif isinstance(msg, MsgTimeout):
            self._handle_timeout(ctx, msg)
        elif isinstance(msg, MsgCreateClient):
            ClientKeeper(ctx.store).create_client(msg.initial_header)
        elif isinstance(msg, MsgUpdateClient):
            ClientKeeper(ctx.store).update_client(
                msg.client_id, msg.signed_header, now=ctx.block_time
            )
        elif isinstance(msg, MsgSubmitMisbehaviour):
            ClientKeeper(ctx.store).submit_misbehaviour(
                msg.client_id, msg.header_a, msg.header_b
            )
        elif isinstance(msg, MsgConnectionOpenInit):
            ConnectionKeeper(ctx.store).open_init(
                msg.client_id, msg.counterparty_client_id
            )
        elif isinstance(msg, MsgConnectionOpenTry):
            ConnectionKeeper(ctx.store).open_try(
                msg.client_id, msg.counterparty_client_id,
                msg.counterparty_connection_id, msg.proof_init,
                msg.proof_height,
            )
        elif isinstance(msg, MsgConnectionOpenAck):
            ConnectionKeeper(ctx.store).open_ack(
                msg.connection_id, msg.counterparty_connection_id,
                msg.proof_try, msg.proof_height,
            )
        elif isinstance(msg, MsgConnectionOpenConfirm):
            ConnectionKeeper(ctx.store).open_confirm(
                msg.connection_id, msg.proof_ack, msg.proof_height
            )
        elif isinstance(msg, MsgChannelOpenInit):
            ChannelKeeper(ctx.store).chan_open_init(
                msg.port_id, msg.connection_id, msg.counterparty_port_id
            )
        elif isinstance(msg, MsgChannelOpenTry):
            ChannelKeeper(ctx.store).chan_open_try(
                msg.port_id, msg.connection_id, msg.counterparty_port_id,
                msg.counterparty_channel_id, msg.proof_init,
                msg.proof_height,
            )
        elif isinstance(msg, MsgChannelOpenAck):
            ChannelKeeper(ctx.store).chan_open_ack(
                msg.port_id, msg.channel_id, msg.counterparty_channel_id,
                msg.proof_try, msg.proof_height,
            )
        elif isinstance(msg, MsgChannelOpenConfirm):
            ChannelKeeper(ctx.store).chan_open_confirm(
                msg.port_id, msg.channel_id, msg.proof_ack, msg.proof_height
            )
        else:
            raise ValueError(f"unroutable message type {type(msg).__name__}")

    @staticmethod
    def _transfer_stack(transfer: TransferKeeper) -> TokenFilterMiddleware:
        """tokenfilter over transfer (ref: app/app.go:380-385)."""
        return TokenFilterMiddleware(TransferIBCModule(transfer))

    def _authorize_packet_msg(
        self, ctx: Context, channels, port_id: str, channel_id: str, msg
    ) -> str:
        """Per-channel trust model dispatch: a client-bound channel
        requires a proof on the message (returns the client id to verify
        it against); a legacy channel requires a registered relayer
        (returns "")."""
        ch = channels.get_channel(port_id, channel_id)
        if ch is None:
            raise ValueError(f"channel {port_id}/{channel_id} is not open")
        client_id = channels.client_for_channel(ch)
        if client_id:
            if msg.proof is None:
                raise ValueError(
                    f"channel {port_id}/{channel_id} is bound to client "
                    f"{client_id}: packet messages must carry a proof"
                )
            return client_id
        channels.require_relayer(msg.signer)
        return ""

    def _handle_recv_packet(self, ctx: Context, msg: MsgRecvPacket) -> None:
        """04-channel RecvPacket: receipt + app callback + written ack.
        An error ack is NOT a tx failure — state effects of the receipt
        and ack persist, only the app-level transfer is refused.

        On a client-bound channel the packet commitment is proven under
        the counterparty app hash (ibc-go proofCommitment,
        04-channel RecvPacket verification)."""
        packet = msg.packet
        if packet.destination_port != PORT_ID_TRANSFER:
            raise ValueError(f"no app bound to port {packet.destination_port}")
        transfer = TransferKeeper(ctx.store, BankKeeper(ctx.store))
        client_id = self._authorize_packet_msg(
            ctx, transfer.channels,
            packet.destination_port, packet.destination_channel, msg,
        )
        if client_id:
            ClientKeeper(ctx.store).verify_membership(
                client_id,
                msg.proof_height,
                packet_commitment_key(
                    packet.source_port, packet.source_channel, packet.sequence
                ),
                packet.commitment(),
                msg.proof,
            )
        transfer.channels.recv_packet(packet, ctx.block_time)
        ack = self._transfer_stack(transfer).on_recv_packet(ctx, packet)
        transfer.channels.write_acknowledgement(packet, ack)

    def _handle_acknowledgement(self, ctx: Context, msg: MsgAcknowledgement) -> None:
        """04-channel AcknowledgePacket: on a client-bound channel the
        written ack bytes are proven under the counterparty app hash
        (proofAcked) before the commitment is cleared and the app
        callback runs."""
        packet = msg.packet
        transfer = TransferKeeper(ctx.store, BankKeeper(ctx.store))
        client_id = self._authorize_packet_msg(
            ctx, transfer.channels,
            packet.source_port, packet.source_channel, msg,
        )
        if client_id:
            ClientKeeper(ctx.store).verify_membership(
                client_id,
                msg.proof_height,
                packet_ack_key(
                    packet.destination_port, packet.destination_channel,
                    packet.sequence,
                ),
                msg.acknowledgement.marshal(),
                msg.proof,
            )
        self._transfer_stack(transfer).on_acknowledgement_packet(
            ctx, packet, msg.acknowledgement
        )

    def _handle_timeout(self, ctx: Context, msg: MsgTimeout) -> None:
        """04-channel TimeoutPacket: on a client-bound channel the
        refund requires (a) a receipt ABSENCE proof on the counterparty
        (proofUnreceived) and (b) a verified counterparty header whose
        time is past the packet timeout — so a delivered packet can
        never also be refunded (the recv+timeout double-credit)."""
        packet = msg.packet
        transfer = TransferKeeper(ctx.store, BankKeeper(ctx.store))
        client_id = self._authorize_packet_msg(
            ctx, transfer.channels,
            packet.source_port, packet.source_channel, msg,
        )
        if client_id:
            clients = ClientKeeper(ctx.store)
            cons = clients.get_consensus_state(client_id, msg.proof_height)
            if cons is None:
                raise ValueError(
                    f"no consensus state at height {msg.proof_height}"
                )
            if cons.timestamp < packet.timeout_timestamp:
                raise ValueError(
                    "timeout not yet elapsed on the counterparty: header "
                    f"time {cons.timestamp} < timeout "
                    f"{packet.timeout_timestamp}"
                )
            clients.verify_non_membership(
                client_id,
                msg.proof_height,
                packet_receipt_key(
                    packet.destination_port, packet.destination_channel,
                    packet.sequence,
                ),
                msg.proof,
            )
        self._transfer_stack(transfer).on_timeout_packet(ctx, packet)

    def _gov_keeper(self, ctx) -> GovKeeper:
        bank = BankKeeper(ctx.store)
        return GovKeeper(ctx.store, bank, StakingKeeper(ctx.store, bank))

    def end_block(self) -> dict:
        """ref: EndBlocker order app/app.go:475-496 — gov tally first, then
        staking/blobstream valset effects, then the upgrade bump
        (app/app.go:575-587)."""
        result = {}
        if self._deliver_store is not None and self._deliver_ctx is not None:
            store, ctx = self._deliver_store, self._deliver_ctx
            bank = BankKeeper(store)
            staking = StakingKeeper(store, bank)
            gov = GovKeeper(store, bank, staking)
            finished = gov.end_blocker(
                ctx, lambda changes: apply_param_changes(self._gov_target(store), changes)
            )
            if finished:
                result["gov_finished"] = [
                    {"id": p.id, "status": p.status, "log": p.fail_log}
                    for p in finished
                ]
            # staking EndBlocker after gov (reference order app/app.go:475-496:
            # crisis, gov, staking, ...): matured unbonding payouts
            staking.complete_unbondings(ctx)
            BlobstreamKeeper(store, staking).end_blocker(ctx)
        if self.upgrade.should_upgrade():
            result["app_version"] = self.upgrade.pending_app_version
        return result

    def _gov_target(self, store):
        """A keeper view over the deliver branch for gov param application
        (apply_param_changes expects .blob / .blobstream attributes)."""

        class _Target:
            pass

        t = _Target()
        t.blob = BlobKeeper(store)
        t.blobstream = BlobstreamKeeper(
            store, StakingKeeper(store, BankKeeper(store))
        )
        # gov client recovery reaches the 02-client keeper through the
        # same deliver branch (paramfilter apply path)
        t.store = store
        return t

    def commit(self) -> bytes:
        if self._deliver_store is not None:
            self._deliver_store.write()
            self._deliver_store = None
            self._deliver_ctx = None
        if self.upgrade.should_upgrade():
            self.app_version = self.upgrade.pending_app_version
            self.upgrade.mark_upgrade_complete()
        self.height += 1
        self._check_store = None  # re-branch check state from committed state
        return self.store.commit()

    # ------------------------------------------------------------------ #
    # ExtendBlock (post-consensus EDS recompute). ref: app/extend_block.go:14

    def extend_block(self, txs: list[bytes]):
        data_square = square_pkg.construct(
            txs, self.app_version, appconsts.square_size_upper_bound(self.app_version)
        )
        eds, _dah = self._extend_and_hash(data_square)
        return eds

    # ------------------------------------------------------------------ #

    def deconstruct_square(self, data_square) -> list[bytes]:
        return square_pkg.deconstruct(data_square, pfb_blob_sizes)
