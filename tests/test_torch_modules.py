"""The port's state machine against the JAX package's, block by block.

One class, ``Chain``, runs over either package's modules, passed in as a
namespace. It mirrors the JAX App's init_chain, check_tx, begin_block,
deliver_tx, _route_msg (for the Msgs the port has), end_block without
Blobstream, and commit (celestia_tpu/app/app.py:238-267, :704-746,
:890-1115, :1237-1293), keeper by keeper, so a difference shows at the
keeper that made it. The Apps themselves, Blobstream and IBC included, are
held against each other in test_torch_app.py and test_torch_ibc.py.

A script of blocks goes through a JAX chain and a port chain side by side,
its txs signed in turns by either package. After every tx the results
(code, log, gas, events) and every key and value of the branch it ran on
agree; after every block the end-block result and the app hash agree."""

import dataclasses
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

MODULES = {
    "appconsts": "appconsts", "blob": "blob", "ns": "namespace", "crypto": "crypto",
    "state": "state", "tx": "tx", "context": "app.context", "ante": "app.ante",
    "auth": "x.auth", "bank": "x.bank", "blobtypes": "x.blob.types",
    "blobkeeper": "x.blob.keeper", "feegrant": "x.feegrant", "authz": "x.authz",
    "vesting": "x.vesting", "staking": "x.staking", "distribution": "x.distribution",
    "slashing": "x.slashing", "mint": "x.mint", "crisis": "x.crisis",
    "paramfilter": "x.paramfilter", "gov": "x.gov", "upgrade": "x.upgrade",
}


def package(root: str) -> SimpleNamespace:
    return SimpleNamespace(**{name: importlib.import_module(f"{root}.{path}")
                              for name, path in MODULES.items()})


JAX = package("celestia_tpu")
PORT = package("celestia_tpu_torch")
CHAIN_ID = "modules-test"
MIN_GAS_PRICE = 0.002  # utia a gas unit, for CheckTx's fee check


@dataclasses.dataclass
class Result:
    """The App's TxResult."""

    code: int
    log: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list = dataclasses.field(default_factory=list)
    priority: int = 0


class Chain:
    """The JAX App's state machine over one package's modules ``m``,
    without Blobstream (no staking hooks) and without IBC."""

    SUPPORTED_VERSIONS = (1, 2)

    def __init__(self, m: SimpleNamespace):
        self.m = m
        self.store = m.state.StateStore()
        self.app_version = 1
        self.height = 0
        self.block_time = 0.0
        self.min_gas_price = MIN_GAS_PRICE
        self.upgrade = m.upgrade.UpgradeKeeper({})
        self._deliver_store = None
        self._deliver_ctx = None
        self._check_store = None

    # app.py:238-267
    def init_chain(self, accounts: dict[str, int], validators: dict[str, int],
                   genesis_time: float = 0.0) -> bytes:
        m, store = self.m, self.store
        bank = m.bank.BankKeeper(store)
        auth = m.auth.AccountKeeper(store)
        m.blobkeeper.BlobKeeper(store).set_params(m.blobkeeper.Params())
        store.set(m.bank.BLOCK_TIME_KEY, repr(float(genesis_time)).encode())
        m.mint.MintKeeper(store, bank).init_genesis(genesis_time)
        for address, amount in accounts.items():
            auth.get_or_create(address)
            bank.mint(address, amount)
        staking = m.staking.StakingKeeper(store, bank)
        for operator, tokens in validators.items():
            auth.get_or_create(operator)
            staking.delegate(None, operator, operator, tokens)
        return store.commit()

    def _new_ctx(self, store, mode):
        return self.m.context.Context(
            store=store, chain_id=CHAIN_ID, block_height=self.height + 1,
            block_time=self.block_time, app_version=self.app_version, mode=mode,
            min_gas_price=self.min_gas_price)

    # app.py:704-746
    def check_tx(self, raw_tx: bytes) -> Result:
        m = self.m
        btx, is_blob = m.blob.unmarshal_blob_tx(raw_tx)
        try:
            if not is_blob:
                tx = m.tx.decode_tx(raw_tx)
                for msg in tx.msgs:
                    if isinstance(msg, m.blobtypes.MsgPayForBlobs):
                        return Result(code=2, log="PFB without blobs (ErrNoBlobs)")
                inner_raw = raw_tx
            else:
                tx = m.blobtypes.validate_blob_tx(btx)
                inner_raw = btx.tx
            if self._check_store is None:
                self._check_store = self.store.branch()
            tx_branch = self._check_store.branch()
            ctx = self._new_ctx(tx_branch, m.context.ExecMode.CHECK)
            try:
                ctx = m.ante.AnteHandler()(ctx, tx, len(inner_raw))
            except Exception as e:  # noqa: BLE001
                return Result(code=1, log=str(e), gas_wanted=tx.fee.gas_limit,
                              gas_used=ctx.gas_meter.consumed)
            tx_branch.write()
            return Result(code=0, gas_wanted=tx.fee.gas_limit,
                          gas_used=ctx.gas_meter.consumed, priority=ctx.priority)
        except Exception as e:  # noqa: BLE001
            return Result(code=1, log=str(e))

    # app.py:890-930
    def begin_block(self, block_time: float, signers: list[str] | None = None,
                    evidence: tuple = ()) -> list:
        m = self.m
        self.block_time = block_time
        self._deliver_store = self.store.branch()
        self._deliver_ctx = self._new_ctx(self._deliver_store, m.context.ExecMode.DELIVER)
        store = self._deliver_store
        store.set(m.bank.BLOCK_TIME_KEY, repr(float(self.block_time)).encode())
        bank = m.bank.BankKeeper(store)
        m.mint.MintKeeper(store, bank).begin_blocker(self._deliver_ctx)
        staking = m.staking.StakingKeeper(store, bank)
        m.distribution.DistributionKeeper(store, bank, staking).begin_blocker(self._deliver_ctx)
        slashing = m.slashing.SlashingKeeper(store, staking)
        if signers is not None:
            signed = set(signers)
            for v in staking.bonded_validators():
                slashing.handle_validator_signature(
                    self._deliver_ctx, v.operator, v.operator in signed)
        for validator, height in evidence:
            slashing.handle_double_sign(
                self._deliver_ctx, m.slashing.Equivocation(validator=validator, height=height))
        return self._deliver_ctx.events

    # app.py:932-976
    def deliver_tx(self, raw_tx: bytes) -> Result:
        m = self.m
        btx, is_blob = m.blob.unmarshal_blob_tx(raw_tx)
        inner = btx.tx if is_blob else raw_tx
        try:
            tx = m.tx.decode_tx(inner)
        except Exception as e:  # noqa: BLE001
            return Result(code=1, log=f"undecodable tx: {e}")
        version = m.upgrade.MsgVersionChange.from_msgs(tx.msgs)
        if version is not None:
            if version not in self.SUPPORTED_VERSIONS:
                raise RuntimeError(
                    f"network is at version {version} which this node does not support")
            self.upgrade.prepare_upgrade_at_end_block(version)
            return Result(code=0, log="version change armed")
        ante_store = self._deliver_store.branch()
        ctx = dataclasses.replace(self._deliver_ctx, store=ante_store, events=[])
        try:
            ctx = m.ante.AnteHandler()(ctx, tx, len(inner))
        except Exception as e:  # noqa: BLE001
            return Result(code=1, log=str(e), gas_wanted=tx.fee.gas_limit,
                          gas_used=ctx.gas_meter.consumed)
        ante_store.write()
        msg_store = self._deliver_store.branch()
        msg_ctx = dataclasses.replace(ctx, store=msg_store)
        try:
            for msg in tx.msgs:
                self._route_msg(msg_ctx, msg)
            msg_store.write()
            return Result(code=0, gas_wanted=tx.fee.gas_limit,
                          gas_used=msg_ctx.gas_meter.consumed, events=msg_ctx.events)
        except Exception as e:  # noqa: BLE001
            return Result(code=1, log=str(e), gas_wanted=tx.fee.gas_limit,
                          gas_used=msg_ctx.gas_meter.consumed)

    # app.py:978-1048, the branches of the Msgs the port has
    def _route_msg(self, ctx, msg) -> None:
        m, store = self.m, ctx.store
        bank = m.bank.BankKeeper(store)
        if isinstance(msg, m.blobtypes.MsgPayForBlobs):
            m.blobkeeper.BlobKeeper(store).pay_for_blobs(ctx, msg)
        elif isinstance(msg, m.bank.MsgSend):
            bank.send(msg.from_address, msg.to_address, msg.amount, msg.denom)
            m.auth.AccountKeeper(store).get_or_create(msg.to_address)
        elif isinstance(msg, m.staking.MsgDelegate):
            m.staking.StakingKeeper(store, bank).delegate(
                ctx, msg.delegator, msg.validator, msg.amount)
        elif isinstance(msg, m.staking.MsgUndelegate):
            m.staking.StakingKeeper(store, bank).undelegate(
                ctx, msg.delegator, msg.validator, msg.amount)
        elif isinstance(msg, m.gov.MsgSubmitProposal):
            self._gov(store).submit_proposal(ctx, msg.proposer, msg.changes, msg.initial_deposit)
        elif isinstance(msg, m.gov.MsgDeposit):
            self._gov(store).deposit(ctx, msg.proposal_id, msg.depositor, msg.amount)
        elif isinstance(msg, m.gov.MsgVote):
            self._gov(store).vote(ctx, msg.proposal_id, msg.voter, msg.option)
        elif isinstance(msg, m.distribution.MsgWithdrawValidatorRewards):
            m.distribution.DistributionKeeper(
                store, bank, m.staking.StakingKeeper(store, bank)
            ).withdraw_rewards(ctx, msg.validator_address)
        elif isinstance(msg, m.slashing.MsgUnjail):
            m.slashing.SlashingKeeper(
                store, m.staking.StakingKeeper(store, bank)).unjail(ctx, msg.validator_address)
        elif isinstance(msg, m.vesting.MsgCreateVestingAccount):
            m.vesting.VestingKeeper(store, bank).create_vesting_account(
                ctx, msg.from_address, msg.to_address, msg.amount, msg.end_time, msg.delayed)
        elif isinstance(msg, m.vesting.MsgCreatePeriodicVestingAccount):
            m.vesting.VestingKeeper(store, bank).create_periodic_vesting_account(
                ctx, msg.from_address, msg.to_address, msg.periods)
        elif isinstance(msg, m.feegrant.MsgGrantAllowance):
            m.feegrant.FeegrantKeeper(store, bank).grant_allowance(msg.to_allowance())
        elif isinstance(msg, m.feegrant.MsgRevokeAllowance):
            m.feegrant.FeegrantKeeper(store, bank).revoke_allowance(msg.granter, msg.grantee)
        elif isinstance(msg, m.authz.MsgGrant):
            m.authz.AuthzKeeper(store).grant(msg.to_grant())
        elif isinstance(msg, m.authz.MsgRevoke):
            m.authz.AuthzKeeper(store).revoke(msg.granter, msg.grantee, msg.msg_type_url)
        elif isinstance(msg, m.authz.MsgExec):
            m.authz.AuthzKeeper(store).dispatch_exec(ctx, msg.grantee, msg.msgs, self._route_msg)
        else:
            raise ValueError(f"unroutable message type {type(msg).__name__}")

    def _gov(self, store):
        bank = self.m.bank.BankKeeper(store)
        return self.m.gov.GovKeeper(store, bank, self.m.staking.StakingKeeper(store, bank))

    # app.py:1237-1293, without the Blobstream end blocker
    def end_block(self) -> dict:
        m, result = self.m, {}
        store, ctx = self._deliver_store, self._deliver_ctx
        bank = m.bank.BankKeeper(store)
        staking = m.staking.StakingKeeper(store, bank)
        target = SimpleNamespace(blob=m.blobkeeper.BlobKeeper(store), store=store)
        finished = m.gov.GovKeeper(store, bank, staking).end_blocker(
            ctx, lambda changes: m.paramfilter.apply_param_changes(target, changes))
        if finished:
            result["gov_finished"] = [
                {"id": p.id, "status": p.status, "log": p.fail_log} for p in finished]
        result["unbondings_completed"] = staking.complete_unbondings(ctx)
        if self.upgrade.should_upgrade():
            result["app_version"] = self.upgrade.pending_app_version
        return result

    def commit(self) -> bytes:
        self._deliver_store.write()
        self._deliver_store = None
        self._deliver_ctx = None
        if self.upgrade.should_upgrade():
            self.app_version = self.upgrade.pending_app_version
            self.upgrade.mark_upgrade_complete()
        self.height += 1
        self._check_store = None
        return self.store.commit()


# --- the script ---

SECRETS = {name: b"modules-" + name.encode()
           for name in ("alice", "bob", "carol", "dave", "erin", "frank", "val", "val2")}
ADDR = {name: PORT.crypto.PrivateKey.from_secret(s).bech32_address() for name, s in SECRETS.items()}
GENESIS_ACCOUNTS = {"alice": 200_000_000_000, "bob": 50_000_000_000, "dave": 2_000_000,
                    "val": 20_000_000_000, "val2": 20_000_000_000}
GENESIS_VALIDATORS = {"val": 10_000_000_000, "val2": 10_000_000_000}
GAS = 300_000
DAY = 86_400.0


@dataclasses.dataclass
class Tx:
    """A scripted tx. ``msgs(m, now)`` builds its Msgs in package ``m`` at
    the time of the last committed block;
    ``blobs`` (namespace id, size) make it a PFB blob tx. ``seq`` replaces
    the signer's next sequence; ``bumps`` says whether the ante passes in
    DeliverTx (and so the signer's sequence moves on); ``deliver=False``
    leaves it at CheckTx, as a tx refused there. ``check`` and ``deliver_``
    are a substring of the expected log, "" for acceptance."""

    signer: str
    msgs: object = None
    blobs: tuple = ()
    fee: dict | None = None
    seq: int | None = None
    bumps: bool = True
    deliver: bool = True
    tamper: str = ""  # "blob" flips a blob byte, "sig" a signature bit
    check: str = ""
    deliver_: str = ""
    raw: bytes | None = None  # a tx given as bytes (the version change)


@dataclasses.dataclass
class Block:
    txs: list
    dt: float = 15.0
    signers: list | None = None
    evidence: tuple = ()
    end: dict | None = None  # expected end-block keys


def _blob_data(nsid: bytes, size: int) -> bytes:
    seed = int.from_bytes(nsid[-4:], "big") + size
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


def sign(m, spec: Tx, account_number: int, sequence: int, now: float) -> bytes:
    """The scripted tx built, signed and marshalled by package m, at the
    time of the last committed block."""
    if spec.raw is not None:
        return spec.raw
    key = m.crypto.PrivateKey.from_secret(SECRETS[spec.signer])
    blobs = [m.blob.new_blob(m.ns.new_v0(nsid), _blob_data(nsid, size), 0)
             for nsid, size in spec.blobs]
    if blobs:
        msgs = [m.blobtypes.new_msg_pay_for_blobs(key.bech32_address(), *blobs)]
        gas = m.blobtypes.estimate_gas([len(b.data) for b in blobs])
        fee = dict(amount=gas, gas_limit=gas)
    else:
        msgs = spec.msgs(m, now)
        fee = dict(amount=GAS, gas_limit=GAS)
    fee.update(spec.fee or {})
    tx = m.tx.sign_tx(key, msgs, CHAIN_ID, account_number, sequence, m.tx.Fee(**fee))
    if spec.tamper == "sig":
        sig = bytearray(tx.signatures[0])
        sig[40] ^= 0x10
        tx.signatures = [bytes(sig)]
    if not blobs:
        return tx.marshal()
    if spec.tamper == "blob":
        b = blobs[0]
        blobs[0] = m.blob.new_blob(b.namespace(), bytes([b.data[0] ^ 1]) + b.data[1:], 0)
    return m.blob.marshal_blob_tx(tx.marshal(), blobs)


def send(frm, to, amount):
    return lambda m, now: [m.bank.MsgSend(ADDR[frm], ADDR[to], amount)]


def proposal(*changes):
    return lambda m, now: [m.gov.MsgSubmitProposal(
        ADDR["alice"], [m.paramfilter.ParamChange(*c) for c in changes], m.gov.MIN_DEPOSIT)]


def vote(pid):
    return lambda m, now: [m.gov.MsgVote(pid, ADDR["alice"], "yes")]


def script() -> list[Block]:
    """Sends, PFBs and their refusals, a fee grant, authz, vesting,
    staking, liveness jailing and unjail, a double sign, a rewards
    withdrawal, mint over jumps in block time, gov with an allowed and a
    forbidden change, and a version change."""
    pfb_ns = [b"pfb" + i.to_bytes(3, "big") for i in range(8)]
    return [
        # 1: sends, one to a fresh account
        Block([Tx("alice", send("alice", "bob", 1_000)),
               Tx("bob", send("bob", "alice", 5)),
               Tx("alice", send("alice", "erin", 777)),
               Tx("bob", send("bob", "alice", 10**15), deliver_="insufficient")]),
        # 2: PFBs, and the refusals: a tampered blob, a reused sequence, too
        # small a fee, a bad signature, a PFB without its blobs
        Block([Tx("alice", blobs=((pfb_ns[0], 2_000),)),
               Tx("bob", blobs=((pfb_ns[1], 700), (pfb_ns[2], 1_500))),
               Tx("alice", blobs=((pfb_ns[3], 900),), tamper="blob", bumps=False, deliver=False,
                  check="invalid share commitment"),
               Tx("alice", blobs=((pfb_ns[4], 600),), seq=-1, bumps=False,
                  check="account sequence mismatch", deliver_="account sequence mismatch"),
               Tx("bob", msgs=send("bob", "alice", 1), fee=dict(amount=1), bumps=False,
                  deliver=False, check="insufficient fees"),
               Tx("bob", msgs=send("bob", "alice", 2), tamper="sig", bumps=False,
                  check="signature verification failed",
                  deliver_="signature verification failed")]),
        # 3: stake for gov, a delegation and an undelegation
        Block([Tx("alice", lambda m, now: [m.staking.MsgDelegate(ADDR["alice"], ADDR["val"],
                                                            40_000_000_000)]),
               Tx("bob", lambda m, now: [m.staking.MsgDelegate(ADDR["bob"], ADDR["val2"],
                                                          5_000_000_000)]),
               Tx("bob", lambda m, now: [m.staking.MsgUndelegate(ADDR["bob"], ADDR["val2"],
                                                            1_000_000_000)]),
               Tx("bob", lambda m, now: [m.staking.MsgUndelegate(ADDR["bob"], ADDR["val"], 1)],
                  deliver_="insufficient delegation")]),
        # 4: two proposals, an allowed change and a forbidden one; votes
        Block([Tx("alice", proposal(("blob", "GovMaxSquareSize", "4"))),
               Tx("alice", proposal(("staking", "BondDenom", "fake")))]),
        Block([Tx("alice", vote(1)), Tx("alice", vote(2))]),
        # 6: past the voting period: one passes, one fails on the filter
        Block([], dt=7 * DAY + 1, end={"gov_finished": [
            {"id": 1, "status": "passed", "log": ""},
            {"id": 2, "status": "failed",
             "log": "parameter staking/BondDenom can only be changed through a hardfork"}]}),
        # 7: the square is now 4 x 4: a blob over its bytes is refused
        Block([Tx("bob", blobs=((pfb_ns[5], 8_000),), bumps=False, deliver=False,
                  check="exceeds max"),
               Tx("bob", blobs=((pfb_ns[6], 3_000),))]),
        # 8: a fee grant, used by a grantee who could not pay alone
        Block([Tx("alice", lambda m, now: [m.feegrant.MsgGrantAllowance(
            ADDR["alice"], ADDR["dave"], 3_000_000, 0.0, [])])]),
        Block([Tx("dave", send("dave", "bob", 1), fee=dict(amount=2_500_000, granter=ADDR["alice"]))]),
        Block([Tx("alice", lambda m, now: [m.feegrant.MsgRevokeAllowance(ADDR["alice"], ADDR["dave"])])]),
        Block([Tx("dave", send("dave", "bob", 1), fee=dict(amount=2_500_000, granter=ADDR["alice"]),
                  bumps=False, check="no fee allowance", deliver_="no fee allowance")]),
        # 12: authz: grant, exec, revoke, exec refused
        Block([Tx("alice", lambda m, now: [m.authz.MsgGrant(
            ADDR["alice"], ADDR["bob"], m.bank.URL_MSG_SEND, 0.0, 10_000)])]),
        Block([Tx("bob", lambda m, now: [m.authz.MsgExec(
            ADDR["bob"], [m.bank.MsgSend(ADDR["alice"], ADDR["bob"], 4_000)])])]),
        Block([Tx("alice", lambda m, now: [m.authz.MsgRevoke(
            ADDR["alice"], ADDR["bob"], m.bank.URL_MSG_SEND)])]),
        Block([Tx("bob", lambda m, now: [m.authz.MsgExec(
            ADDR["bob"], [m.bank.MsgSend(ADDR["alice"], ADDR["bob"], 4_000)])],
                  deliver_="has no authorization")]),
        # 16: vesting: a delayed account, a periodic one, then spendable funds
        Block([Tx("alice", lambda m, now: [m.vesting.MsgCreateVestingAccount(
            ADDR["alice"], ADDR["carol"], 1_000_000, now + 500.0, True)]),
               Tx("alice", lambda m, now: [m.vesting.MsgCreatePeriodicVestingAccount(
                   ADDR["alice"], ADDR["frank"], [(30.0, 1_000), (60.0, 2_000)])])]),
        Block([Tx("alice", send("alice", "carol", 600_000))]),
        # 18: the locked send is refused; after the end time it goes through
        Block([Tx("carol", send("carol", "bob", 500_000), deliver_="still vesting")]),
        Block([Tx("carol", send("carol", "bob", 500_000))], dt=8 * DAY),
        # 20: liveness: val2 misses every block of the (shortened) window
        *[Block([], signers=[ADDR["val"]]) for _ in range(8)],
        Block([Tx("val2", lambda m, now: [m.slashing.MsgUnjail(ADDR["val2"])],
                  deliver_="jailed until")], signers=[ADDR["val"]]),
        Block([Tx("val2", lambda m, now: [m.slashing.MsgUnjail(ADDR["val2"])])], dt=61.0),
        # 30: rewards, matured unbonding, mint over a year
        Block([Tx("val2", lambda m, now: [m.distribution.MsgWithdrawValidatorRewards(ADDR["val2"])])]),
        Block([], dt=21 * DAY, end={"unbondings_completed": 1}),
        Block([Tx("alice", send("alice", "bob", 3))], dt=370 * DAY),
        # 33: a double sign: val is slashed and tombstoned, and cannot unjail
        Block([], evidence=((ADDR["val"], 32),)),
        Block([Tx("val", lambda m, now: [m.slashing.MsgUnjail(ADDR["val"])], deliver_="tombstoned")],
              dt=120.0),
        # 35: a version change, proposer-injected and unsigned
        Block([Tx("alice", raw=JAX.upgrade.MsgVersionChange.as_tx_bytes(2), bumps=False,
                  check="tx has no signatures", deliver_="")], end={"app_version": 2}),
        Block([Tx("alice", blobs=((pfb_ns[7], 1_000),)), Tx("bob", send("bob", "erin", 9))]),
    ]


def _dump(store) -> list:
    return store.iter_prefix(b"")


def _expect(result: Result, want: str, what: str) -> None:
    if want:
        assert result.code != 0 and want in result.log, (what, result)
    else:
        assert result.code == 0, (what, result)


def _seq(chain: Chain, name: str) -> tuple[int, int]:
    acc = chain.m.auth.AccountKeeper(chain.store).get_account(ADDR[name])
    return (acc.account_number, acc.sequence) if acc else (0, 0)


@pytest.fixture
def short_window(monkeypatch):
    """The liveness window cut to 8 blocks on both sides, as the JAX
    package's own slashing test cuts it."""
    for m in (JAX, PORT):
        monkeypatch.setattr(m.slashing, "SIGNED_BLOCKS_WINDOW", 8)


def test_the_script_gives_equal_results_stores_and_app_hashes(short_window):
    chains = (Chain(JAX), Chain(PORT))
    accounts = {ADDR[n]: a for n, a in GENESIS_ACCOUNTS.items()}
    validators = {ADDR[n]: t for n, t in GENESIS_VALIDATORS.items()}
    hashes = [c.init_chain(accounts, validators) for c in chains]
    assert hashes[0] == hashes[1]
    signed_by = {"jax": 0, "port": 0}
    n_tx = 0
    for b, block in enumerate(script(), start=1):
        # build and sign every tx against the committed state, in turns
        pending: dict[str, int] = {}
        raws = []
        for spec in block.txs:
            number, committed = _seq(chains[0], spec.signer)
            assert (number, committed) == _seq(chains[1], spec.signer)
            nxt = committed + pending.get(spec.signer, 0)
            seq = nxt + spec.seq if spec.seq is not None else nxt
            m, side = (PORT, "port") if n_tx % 2 == 0 else (JAX, "jax")
            raws.append(sign(m, spec, number, seq, chains[0].block_time))
            signed_by[side] += spec.raw is None
            n_tx += 1
            if spec.bumps:
                pending[spec.signer] = pending.get(spec.signer, 0) + 1
        # CheckTx on the persistent check branch
        for spec, raw in zip(block.txs, raws):
            got = [c.check_tx(raw) for c in chains]
            assert got[0] == got[1], (b, "check", got)
            _expect(got[0], spec.check, (b, "check"))
            assert _dump(chains[0]._check_store) == _dump(chains[1]._check_store)
        # BeginBlock, DeliverTx, EndBlock, Commit
        t = chains[0].block_time + block.dt
        events = [c.begin_block(t, block.signers, block.evidence) for c in chains]
        assert events[0] == events[1]
        assert _dump(chains[0]._deliver_store) == _dump(chains[1]._deliver_store)
        for spec, raw in zip(block.txs, raws):
            if not spec.deliver:
                continue
            got = [c.deliver_tx(raw) for c in chains]
            assert got[0] == got[1], (b, "deliver", got)
            _expect(got[0], spec.deliver_, (b, "deliver"))
            assert _dump(chains[0]._deliver_store) == _dump(chains[1]._deliver_store)
        ends = [c.end_block() for c in chains]
        assert ends[0] == ends[1]
        for key, want in (block.end or {}).items():
            assert ends[0].get(key) == want, (b, ends[0])
        hashes = [c.commit() for c in chains]
        assert hashes[0] == hashes[1], b
        for c in chains:  # the crisis invariants hold after every block
            c.m.crisis.CrisisKeeper(c.store).assert_invariants()
        assert _dump(chains[0].store) == _dump(chains[1].store)
    assert chains[0].app_version == chains[1].app_version == 2
    assert min(signed_by.values()) >= 15, signed_by
    # what the script meant to reach, read from the port's store
    port = chains[1]
    staking = PORT.staking.StakingKeeper(port.store, PORT.bank.BankKeeper(port.store))
    assert staking.get_validator(ADDR["val"]).jailed
    assert not staking.get_validator(ADDR["val2"]).jailed
    assert PORT.slashing.SlashingKeeper(port.store, staking).signing_info(ADDR["val"]).tombstoned
    assert PORT.blobkeeper.BlobKeeper(port.store).get_params().gov_max_square_size == 4
    assert PORT.mint.MintKeeper(port.store, None).inflation_rate() < 0.08


def test_a_broken_invariant_is_reported_alike():
    """A balance minted behind the supply's back breaks the bank total
    supply invariant with the same message on both sides."""
    errors = []
    for m in (JAX, PORT):
        store = m.state.StateStore()
        bank = m.bank.BankKeeper(store)
        bank.mint(ADDR["alice"], 100)
        bank.set_balance(ADDR["bob"], 7)
        with pytest.raises(AssertionError) as exc:
            m.crisis.CrisisKeeper(store).assert_invariants()
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_the_ibc_param_change_raises_in_the_port_until_its_client_keeper_is_ported():
    """The paramfilter's ibc branch (RecoverClient) reaches each package's
    02-client keeper: a change naming an unknown client is refused with the
    same message, and the recovery of a frozen subject client from an
    active substitute leaves the same store on both sides."""
    import json

    from celestia_tpu.x import lightclient as jlc
    from celestia_tpu_torch.x import lightclient as plc

    val = PORT.crypto.PrivateKey.from_secret(b"modules-recovery-validator")
    pub = val.public_key().hex()

    def recover(subject: str, substitute: str):
        return [("ibc", "RecoverClient", json.dumps(
            {"subject_client_id": subject, "substitute_client_id": substitute}))]

    dumps, refusals = [], []
    for m, lc in ((JAX, jlc), (PORT, plc)):
        store = m.state.StateStore()
        target = SimpleNamespace(blob=m.blobkeeper.BlobKeeper(store), store=store)
        with pytest.raises(ValueError) as exc:
            m.paramfilter.apply_param_changes(target, [
                m.paramfilter.ParamChange(*c)
                for c in recover("07-tendermint-0", "07-tendermint-1")])
        refusals.append(str(exc.value))

        def header(height: int, app_hash: bytes):
            return lc.Header("chain-b", height, 10.0 * height, app_hash,
                             [lc.ValidatorInfo(pub, 10)])

        def signed(h):
            return lc.SignedHeader(h, [(pub, val.sign(h.sign_bytes()).hex())])

        keeper = lc.ClientKeeper(store)
        subject = keeper.create_client(header(1, b"\x01" * 32)).client_id
        keeper.submit_misbehaviour(subject, signed(header(2, b"\x02" * 32)),
                                   signed(header(2, b"\x03" * 32)))
        substitute = keeper.create_client(header(3, b"\x04" * 32)).client_id
        assert keeper.get_client(subject).frozen
        m.paramfilter.apply_param_changes(target, [
            m.paramfilter.ParamChange(*c) for c in recover(subject, substitute)])
        client = keeper.get_client(subject)
        assert not client.frozen and client.latest_height == 3
        dumps.append(_dump(store))
    assert refusals[0] == refusals[1] and "07-tendermint-0" in refusals[0]
    assert dumps[0] == dumps[1]


@pytest.mark.parametrize("change, message", [
    (("bank", "SendEnabled", "false"), "hardfork"),
    (("staking", "UnbondingTime", "1"), "hardfork"),
    (("blob", "NoSuchKey", "1"), "unknown blob param"),
    (("nosuch", "Key", "1"), "unknown subspace"),
])
def test_param_changes_are_refused_alike(change, message):
    logs = []
    for m in (JAX, PORT):
        store = m.state.StateStore()
        target = SimpleNamespace(blob=m.blobkeeper.BlobKeeper(store), store=store)
        with pytest.raises(Exception) as exc:
            m.paramfilter.apply_param_changes(target, [m.paramfilter.ParamChange(*change)])
        logs.append((type(exc.value).__name__, str(exc.value)))
    assert logs[0] == logs[1] and message in logs[0][1]
