"""Genesis export (port of the JAX package's app/export.py) —
ExportAppStateAndValidators analogue.

Reference semantics: app/export.go:16-45 — dump the full application state
as a genesis document (module-structured JSON), plus the validator set,
the height InitChain should resume at (last height + 1), and consensus
parameters. With for_zero_height=True the state is prepped for a fresh
chain start (app/export.go:50-195): validator rewards are withdrawn to
balances, slashing signing-info start heights reset, and the height set
to zero.

Export shape:

- `auth` / `bank` / `staking` are exported fully decoded (accounts,
  balances/supply, validators/delegations) — the sections the reference's
  export path manipulates explicitly.
- Every other module's state is exported under `modules` as
  {key: utf-8 store key, value: hex} with a best-effort `display` field
  (JSON or int) for human audit; import round-trips the hex exactly.

`import_genesis` rebuilds a StateStore byte-for-byte, so an app restarted
from an export commits the SAME app hash it would have produced by
continuing — the strongest possible restart-compatibility check, pinned
by tests/test_torch_export_config.py.
"""

from __future__ import annotations

import json

from celestia_tpu_torch import appconsts
from celestia_tpu_torch.state import StateStore
from celestia_tpu_torch.x.auth import ACCOUNT_PREFIX, GLOBAL_ACCOUNT_NUMBER_KEY
from celestia_tpu_torch.x.bank import (
    BALANCE_PREFIX,
    SUPPLY_KEY,
    _balance_key,
    split_balance_key,
)
from celestia_tpu_torch.x.staking import (
    DELEGATION_PREFIX,
    LAST_UNBONDING_HEIGHT_KEY,
    VALIDATOR_PREFIX,
)

_STRUCTURED_PREFIXES = (
    ACCOUNT_PREFIX,
    GLOBAL_ACCOUNT_NUMBER_KEY,
    BALANCE_PREFIX,
    SUPPLY_KEY,
    VALIDATOR_PREFIX,
    DELEGATION_PREFIX,
    LAST_UNBONDING_HEIGHT_KEY,
)


def _display(value: bytes):
    """Best-effort human-readable annotation (never used by import)."""
    try:
        return {"json": json.loads(value)}
    except (ValueError, UnicodeDecodeError):
        pass
    if len(value) in (8, 16):
        return {"int": int.from_bytes(value, "big")}
    return None


def export_app_state_and_validators(app, for_zero_height: bool = False) -> dict:
    """ref: app/export.go:16 ExportAppStateAndValidators."""
    if for_zero_height:
        _prep_for_zero_height_genesis(app)

    store = app.store
    accounts = []
    for key, raw in store.iter_prefix(ACCOUNT_PREFIX):
        accounts.append(json.loads(raw))
    balances: dict[str, dict[str, int]] = {}
    for key, raw in store.iter_prefix(BALANCE_PREFIX):
        addr, denom = split_balance_key(key)
        balances.setdefault(addr, {})[denom] = int.from_bytes(raw, "big")
    supply = {
        key[len(SUPPLY_KEY):].decode(): int.from_bytes(raw, "big")
        for key, raw in store.iter_prefix(SUPPLY_KEY)
    }
    validators = [json.loads(raw) for _k, raw in store.iter_prefix(VALIDATOR_PREFIX)]
    delegations = []
    for key, raw in store.iter_prefix(DELEGATION_PREFIX):
        delegator, validator = key[len(DELEGATION_PREFIX):].decode().split("/", 1)
        delegations.append(
            {
                "delegator": delegator,
                "validator": validator,
                "tokens": int.from_bytes(raw, "big"),
            }
        )
    gan = store.get(GLOBAL_ACCOUNT_NUMBER_KEY)
    luh = store.get(LAST_UNBONDING_HEIGHT_KEY)

    modules: list[dict] = []
    for key in sorted(store._data):
        if any(key.startswith(p) for p in _STRUCTURED_PREFIXES):
            continue
        value = store._data[key]
        entry = {"key": key.decode(), "value": value.hex()}
        display = _display(value)
        if display is not None:
            entry["display"] = display
        modules.append(entry)

    from celestia_tpu_torch.x.staking import StakingKeeper

    bonded = StakingKeeper(store, app.bank).bonded_validators()
    return {
        "chain_id": app.chain_id,
        # InitChain resumes at last height + 1 (app/export.go:24-26)
        "height": 0 if for_zero_height else app.height + 1,
        "app_version": app.app_version,
        "consensus_params": {
            "block": {"max_bytes": appconsts.DEFAULT_MAX_BYTES, "max_gas": -1},
            "evidence": {
                "max_age_duration_seconds": appconsts.DEFAULT_UNBONDING_TIME_SECONDS,
                "max_age_num_blocks": appconsts.DEFAULT_UNBONDING_TIME_SECONDS
                // appconsts.GOAL_BLOCK_TIME_SECONDS
                + 1,
            },
            "version": {"app_version": app.app_version},
        },
        "validators": [
            {"operator": v.operator, "power": v.power, "jailed": v.jailed}
            for v in bonded
        ],
        "app_state": {
            "auth": {
                "accounts": accounts,
                "global_account_number": int.from_bytes(gan, "big") if gan else 0,
            },
            "bank": {"balances": balances, "supply": supply},
            "staking": {
                "validators": validators,
                "delegations": delegations,
                "last_unbonding_height": int.from_bytes(luh, "big") if luh else 0,
            },
            "modules": modules,
        },
    }


def _prep_for_zero_height_genesis(app) -> None:
    """Light version of app/export.go:50 prepForZeroHeightGenesis: withdraw
    accumulated validator rewards into spendable balances and reset
    slashing signing-info start heights, so the zero-height chain starts
    with clean distribution/slashing state."""
    from celestia_tpu_torch.app.context import Context, ExecMode
    from celestia_tpu_torch.x.distribution import DistributionKeeper
    from celestia_tpu_torch.x.slashing import SIGNING_INFO_PREFIX
    from celestia_tpu_torch.x.staking import StakingKeeper

    store = app.store
    # "Just to be safe, assert the invariants on current state"
    # (app/export.go:68-69)
    app.assert_invariants()
    ctx = Context(
        store=store,
        chain_id=app.chain_id,
        block_height=app.height,
        block_time=app.block_time,
        app_version=app.app_version,
        mode=ExecMode.DELIVER,
    )
    staking = StakingKeeper(store, app.bank)
    distr = DistributionKeeper(store, app.bank, staking)
    for v in staking.bonded_validators():
        try:
            distr.withdraw_rewards(ctx, v.operator)
        except ValueError:
            pass  # nothing to withdraw
    for key, raw in list(store.iter_prefix(SIGNING_INFO_PREFIX)):
        info = json.loads(raw)
        info["start_height"] = 0
        store.set(key, json.dumps(info, sort_keys=True).encode())
    store.commit_hash_refresh()


def import_genesis(genesis: dict, **app_kwargs):
    """Rebuild an App from an exported genesis document.

    The store is reconstructed byte-for-byte, so the first commit after
    import produces the same app hash the exporting node would have."""
    from celestia_tpu_torch.app import App

    app = App(
        chain_id=genesis["chain_id"],
        app_version=genesis["app_version"],
        **app_kwargs,
    )
    store = StateStore()
    state = genesis["app_state"]

    for entry in state.get("modules", []):
        store.set(entry["key"].encode(), bytes.fromhex(entry["value"]))

    auth = state.get("auth", {})
    for acc in auth.get("accounts", []):
        store.set(
            ACCOUNT_PREFIX + acc["address"].encode(),
            json.dumps(acc, sort_keys=True).encode(),
        )
    store.set(
        GLOBAL_ACCOUNT_NUMBER_KEY,
        int(auth.get("global_account_number", 0)).to_bytes(8, "big"),
    )

    bank = state.get("bank", {})
    for addr, denoms in bank.get("balances", {}).items():
        for denom, amount in denoms.items():
            store.set(
                _balance_key(addr, denom),
                int(amount).to_bytes(16, "big"),
            )
    for denom, amount in bank.get("supply", {}).items():
        store.set(SUPPLY_KEY + denom.encode(), int(amount).to_bytes(16, "big"))

    staking = state.get("staking", {})
    for val in staking.get("validators", []):
        store.set(
            VALIDATOR_PREFIX + val["operator"].encode(),
            json.dumps(val, sort_keys=True).encode(),
        )
    for d in staking.get("delegations", []):
        store.set(
            DELEGATION_PREFIX + d["delegator"].encode() + b"/" + d["validator"].encode(),
            int(d["tokens"]).to_bytes(16, "big"),
        )
    if staking.get("last_unbonding_height"):
        store.set(
            LAST_UNBONDING_HEIGHT_KEY,
            int(staking["last_unbonding_height"]).to_bytes(8, "big"),
        )

    store.commit_hash_refresh()
    app.rebind_store(store)
    # exported height is where InitChain resumes; the app's last committed
    # height is one below it
    app.height = max(genesis["height"] - 1, 0)
    return app
